"""The port's streaming sessions against the JAX package, on the CPU in
fp32, at the tiny causal widths of tests/test_torch_streaming.py: pooled
CTC sessions (Type A N=2, ragged and interleaved, more sessions than rows)
against each alone and against JAX's offline greedy ids; transducer
sessions, greedy and beam, against JAX's offline ids; the ValueError of an
unknown or closed session; a deterministic check that concurrent feeds
share ticks; the HTTP routes; the constructors' refusals; the causal config
literals' parameter counts against JAX's."""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity import seeded_tree

from hnet_mamba_asr_torch.serving.runtime import StreamingServingModel, StreamingSessionPool
from hnet_mamba_asr_torch.serving.server import make_streaming_server
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_torch.tools import gate
from hnet_mamba_asr_tpu.models.ctc_head import greedy_decode as jctc_greedy
from hnet_mamba_asr_tpu.tasks import asr_task as jtask

V = 12
ENC = {"d_outer": 16, "d_main": 24, "n_enc": 1, "n_main": 1, "n_dec": 1, "arch_type": "A",
       "d_state": 8, "headdim": 8, "ssd_chunk_size": 16, "bidirectional": False}
CTC_CONFIG = {"frontend_conf": {"n_mels": 20},
              "encoder_conf": {**ENC, "hnet": {"compression_N": 2}},
              "model_conf": {"ctc_weight": 1.0, "aed_weight": 0.0}}
RNNT_CONFIG = {"frontend_conf": {"n_mels": 20},
               "encoder_conf": {**ENC, "hnet": {"compression_N": 1}},
               "rnnt_conf": {"d_pred": 8, "d_joint": 16, "context": 2, "max_symbols": 3},
               "model_conf": {"ctc_weight": 0.0, "aed_weight": 0.0, "rnnt_weight": 1.0}}
LENGTHS = (9000, 10700, 12400, 14100)


def _waves(seed=10):
    return [(np.random.default_rng(seed + k).normal(size=n) * 0.1).astype(np.float32)
            for k, n in enumerate(LENGTHS)]


def _jax(cfg, seed):
    jm = jtask.build_model(cfg, V)
    return jm, seeded_tree(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=seed)


def _encode_padded(jm, params, waves):
    """JAX's offline encoder over every wave at once (one padded batch, one
    compile)."""
    total = max(len(w) for w in waves)
    wave = np.zeros((len(waves), total), np.float32)
    for i, w in enumerate(waves):
        wave[i, :len(w)] = w
    lens = np.asarray([len(w) for w in waves], np.int32)
    return jax.jit(lambda p, w, n: jm.encode(p, {"wave": w, "wave_lens": n}))(
        params, jnp.asarray(wave), jnp.asarray(lens))


@pytest.fixture(scope="module")
def ctc_case():
    """The causal N=2 CTC model (routers seeded at random: a mix of kept
    frames) and JAX's offline greedy ids of the waves."""
    jm, params = _jax(CTC_CONFIG, seed=3)
    waves = _waves()
    enc = _encode_padded(jm, params, waves)
    ids = jm.ctc.apply({"params": params["ctc"]}, enc.features, method="frame_argmax")
    assert 0.05 < float(enc.kept_fractions[0]) < 0.95
    return params, waves, jctc_greedy(ids, np.asarray(enc.lengths), jm.ctc.blank_id)


def _interleave(pool, sids, waves, sizes):
    """Ragged interleaved feeds (session k in chunks of sizes[k]), then
    finish: -> {sid: ids}."""
    got = {s: [] for s in sids}
    pos = [0] * len(waves)
    while any(pos[k] < len(w) for k, w in enumerate(waves)):
        for k, sid in enumerate(sids):
            if pos[k] < len(waves[k]):
                got[sid] += pool.feed(sid, waves[k][pos[k]:pos[k] + sizes[k]])
                pos[k] += sizes[k]
    for sid in sids:
        got[sid] += pool.finish(sid)
    return got


def test_pooled_sessions_equal_alone_and_jax(ctc_case):
    """Four sessions through a pool of 3 rows, interleaved, and through
    feed_many rounds: each equals the session alone and JAX's offline ids;
    the rounds share ticks."""
    params, waves, want = ctc_case
    pool = StreamingSessionPool(CTC_CONFIG, params, "cpu", block_enc=8, batch=3)
    sids = [pool.open() for _ in waves]
    got = _interleave(pool, sids, waves, (900, 1400, 2100, 650))
    assert [got[s] for s in sids] == want
    assert pool.active == 0
    alone = StreamingServingModel(CTC_CONFIG, params, "cpu", block_enc=8)
    for w, ids in zip(waves, want):
        out = []
        for i in range(0, len(w), 1700):
            out += alone.feed(w[i:i + 1700])
        assert out + alone.finish() == ids
    sids = [pool.open() for _ in waves[:3]]
    got = {s: [] for s in sids}
    for pos in range(0, max(LENGTHS[:3]), 2000):
        for sid, toks in pool.feed_many([(s, w[pos:pos + 2000])
                                         for s, w in zip(sids, waves)]).items():
            got[sid] += toks
    rounds = pool.n_ticks
    assert [got[s] + pool.finish(s) for s in sids] == want[:3]
    assert rounds <= 18 + 2            # one tick a full round (3 sessions), not three


def test_unknown_or_closed_session_raises_value_error(ctc_case):
    pool = StreamingSessionPool(CTC_CONFIG, ctc_case[0], "cpu", block_enc=8, batch=2)
    sid = pool.open()
    pool.feed(sid, np.zeros(100, np.float32))
    assert pool.finish(sid) == []
    for call in (lambda: pool.feed(sid, np.zeros(10, np.float32)), lambda: pool.finish(sid),
                 lambda: pool.partial(sid), lambda: pool.feed(99, np.zeros(10, np.float32))):
        with pytest.raises(ValueError, match="unknown or closed session"):
            call()
    pool.close(sid)                     # closing twice is a no-op


def test_concurrent_feeds_coalesce(ctc_case):
    """Deterministic: the first session's tick holds the step until the other
    two sessions have deposited a block each (their threads then wait on the
    drain); the drainer's next scan ticks them together, so 3 sessions take
    2 ticks, and each gets its own ids."""
    params, waves, _ = ctc_case
    pool = StreamingSessionPool(CTC_CONFIG, params, "cpu", block_enc=8, batch=3)
    alone = StreamingSessionPool(CTC_CONFIG, params, "cpu", block_enc=8, batch=3)
    block = 4 * (8 + 1) * 160 + 400               # the samples of one block
    sids = [pool.open() for _ in range(3)]
    deposited = threading.Event()
    step, calls = pool.step, []

    def held_step(*a):
        if not calls:
            assert deposited.wait(timeout=60)
        calls.append(1)
        return step(*a)
    pool.step = held_step
    got, errs = {}, []

    def client(k):
        try:
            got[k] = pool.feed(sids[k], waves[k][:block])
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    def wait_for(cond):
        deadline = time.monotonic() + 60
        while not cond():
            assert time.monotonic() < deadline and not errs, errs
            time.sleep(1e-3)

    first = threading.Thread(target=client, args=(0,))
    first.start()
    wait_for(lambda: pool._draining)            # the first tick holds the step
    others = [threading.Thread(target=client, args=(k,)) for k in (1, 2)]
    for t in others:
        t.start()
    wait_for(lambda: all(pool._sessions[s].buf.total for s in sids[1:]))
    deposited.set()
    for t in [first, *others]:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in [first, *others])
    assert not errs and len(calls) == 2 and pool.n_ticks == 2
    for k in range(3):
        sid = alone.open()
        assert got[k] == alone.feed(sid, waves[k][:block])


def test_threaded_feeds_stress(ctc_case):
    """More client threads than cores, each feeding its own session in
    ragged chunks into a pool of 3 rows, the interpreter switching threads
    every microsecond: every session's ids equal the same audio alone, and
    every session is closed at the end."""
    import os
    import sys
    params = ctc_case[0]
    n = (os.cpu_count() or 1) + 1
    rng = np.random.default_rng(50)
    waves = [(rng.normal(size=int(s)) * 0.1).astype(np.float32)
             for s in rng.integers(6500, 9000, size=n)]
    pool = StreamingSessionPool(CTC_CONFIG, params, "cpu", block_enc=8, batch=3)
    alone = StreamingServingModel(CTC_CONFIG, params, "cpu", block_enc=8)
    want = [alone.feed(w) + alone.finish() for w in waves]
    got, errs = {}, []

    def client(k):
        try:
            sid, out = pool.open(), []
            for i in range(0, len(waves[k]), 700 + 300 * k):
                out += pool.feed(sid, waves[k][i:i + 700 + 300 * k])
            got[k] = out + pool.finish(sid)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errs, errs
    assert [got[k] for k in range(n)] == want and pool.active == 0


def test_streaming_http_routes(ctc_case):
    params, waves, want = ctc_case
    pool = StreamingSessionPool(CTC_CONFIG, params, "cpu", block_enc=8, batch=2,
                                tokenizer={"pieces": [f"▁w{i}" for i in range(V)]})
    httpd, _ = make_streaming_server(pool)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, data=None):
        req = urllib.request.Request(url + path, data=data, method="POST" if data is not None
                                     else "GET",
                                     headers={"Content-Type": "application/octet-stream"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
    try:
        sid = call("/v1/stream/open", b"")[1]["sid"]
        ids = []
        for i in range(0, len(waves[0]), 3000):
            code, res = call(f"/v1/stream/{sid}", waves[0][i:i + 3000].tobytes())
            assert code == 200
            ids += res["ids"]
        assert call(f"/v1/stream/{sid}/partial") == (200, {"ids": [], "text": ""})
        health = call("/v1/health")[1]
        code, res = call(f"/v1/stream/{sid}/finish", b"")
        ids += res["ids"]
        bad = call(f"/v1/stream/{sid}", np.zeros(8, np.float32).tobytes())
        missing = call("/v1/nothing")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)
    assert ids == want[0] and res["text"] == " ".join(f"w{i}" for i in res["ids"])
    assert health == {"status": "ok", "kind": "streaming", "batch": 2, "active": 1}
    assert bad[0] == 400 and "unknown or closed session" in bad[1]["error"]
    assert missing[0] == 404


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_rnnt_sessions_match_jax(decode):
    """A transducer-only causal model: streamed greedy and beam ids equal
    JAX's offline greedy_decode and beam_decode_nbest (the same token buffer
    length); a beam's feeds return [] while its partial grows; two pooled
    beam sessions give the same."""
    jm, params = _jax(RNNT_CONFIG, seed=9)        # a beam whose best is not empty
    waves = _waves(30)[:2]
    enc = _encode_padded(jm, params, waves)
    rnnt = {"params": params["rnnt"]}
    if decode == "greedy":
        toks, lens = jm.rnnt.apply(rnnt, enc.features, enc.lengths, method="greedy_decode")
    else:
        ftoks, fplen, fscore = jm.rnnt.apply(rnnt, enc.features, enc.lengths, 4,
                                             method="beam_decode_nbest", token_buf_len=48)
        best = np.argmax(np.asarray(fscore), axis=1)
        toks = np.asarray(ftoks)[np.arange(2), best]
        lens = np.asarray(fplen)[np.arange(2), best]
    want = [np.asarray(toks)[b, :int(np.asarray(lens)[b])].tolist() for b in range(2)]
    kw = dict(block_enc=8, decode=decode, beam_size=4, token_buf_len=48)
    alone = StreamingServingModel(RNNT_CONFIG, params, "cpu", **kw)
    for w, ids in zip(waves, want):
        fed = []
        for i in range(0, len(w), 1300):
            fed += alone.feed(w[i:i + 1300])
        if decode == "beam":
            assert fed == [] and alone.partial
            fed = []
        assert fed + alone.finish() == ids
    pool = StreamingSessionPool(RNNT_CONFIG, params, "cpu", batch=2, **kw)
    sids = [pool.open() for _ in waves]
    got = _interleave(pool, sids, waves, (1300, 2200))
    assert [got[s] for s in sids] == want


def test_streaming_constructors_validate():
    cfg = RNNT_CONFIG
    for kw, match in (({"block_enc": 0}, "block_enc must be >= 1"),
                      ({"batch": 0}, "batch must be >= 1"),
                      ({"decode": "sample"}, "greedy|beam")):
        with pytest.raises(ValueError, match=match):
            StreamingSessionPool(cfg, None, "cpu", vocab_size=V, **kw)
    with pytest.raises(ValueError, match="requires an RNNT-only model"):
        StreamingSessionPool(CTC_CONFIG, None, "cpu", vocab_size=V, decode="beam")
    with pytest.raises(ValueError, match="use StreamingSessionPool"):
        StreamingServingModel(cfg, None, "cpu", vocab_size=V, batch=2)
    aed_only = {**cfg, "model_conf": {"ctc_weight": 0.0, "aed_weight": 1.0},
                "aed_conf": {"n_layers": 1, "n_heads": 2, "d_ff": 32}}
    with pytest.raises(ValueError, match="requires a CTC or RNNT head"):
        StreamingSessionPool(aed_only, None, "cpu", vocab_size=V)
    bidi = {**cfg, "encoder_conf": {**cfg["encoder_conf"], "bidirectional": True}}
    with pytest.raises(ValueError, match="bidirectional"):
        StreamingSessionPool(bidi, None, "cpu", vocab_size=V)


def test_streaming_entry_points_run_on_the_card_by_default():
    import inspect
    for cls in (StreamingSessionPool, StreamingServingModel):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                cls(RNNT_CONFIG, None, vocab_size=V)


@pytest.mark.parametrize("name", ["GATE_CAUSAL_CONFIG", "N2_CAUSAL_CONFIG",
                                  "RNNT_CAUSAL_CONFIG"])
def test_causal_config_literals(name):
    """Each causal literal is its bidirectional sibling with
    ``bidirectional: false`` and nothing else of the encoder changed (the
    transducer one: the heads' weights and JAX's rnnt_conf); its parameter
    count is the JAX build's of the same dict (jax.eval_shape)."""
    cfg = getattr(gate, name)
    sibling = {"GATE_CAUSAL_CONFIG": gate.GATE_CONFIG, "N2_CAUSAL_CONFIG": gate.N2_CONFIG,
               "RNNT_CAUSAL_CONFIG": gate.GATE_CONFIG}[name]
    assert cfg["encoder_conf"] == {**sibling["encoder_conf"], "bidirectional": False}
    if name == "RNNT_CAUSAL_CONFIG":
        mc = cfg["model_conf"]
        assert (mc["ctc_weight"], mc["aed_weight"], mc["rnnt_weight"]) == (0.0, 0.0, 1.0)
        assert cfg["rnnt_conf"] == {"d_pred": 256, "d_joint": 512, "context": 2,
                                    "max_symbols": 4, "max_decode_len": 512}
    shapes = jax.eval_shape(jtask.build_model(cfg, gate.VOCAB).init_params,
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):                   # shapes only
        model = build_model(cfg, gate.VOCAB, device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
