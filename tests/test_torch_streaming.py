"""Streaming in the port against the JAX package, on the CPU in fp32, at the
tiny widths of tests/test_streaming.py (d_outer 16, d_main 24, d_state 8,
headdim 8, 1-2 layers a stack): the carried EMA (``ema_stream`` against
``_ema_stream``), one Mamba-2 layer streamed (``Mamba2.step`` against
``_mamba2_stream``), the exact-causal encoder at N=1, Type A N=2 and Type B
N=4 against JAX's and against the port's offline encoder, the windowed
encoder, incremental CTC greedy, the transducer beam's carried state, and
the constructors' refusals. JAX params reach the port through convert.py (a
causal tree has no ``bwd`` mixers)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity import module_tree, seeded_tree

from hnet_mamba_asr_torch import convert
from hnet_mamba_asr_torch.decoders import device_rnnt_beam
from hnet_mamba_asr_torch.models import streaming
from hnet_mamba_asr_torch.models.mamba2 import Mamba2
from hnet_mamba_asr_torch.models.rnnt import RNNTHead
from hnet_mamba_asr_torch.ops.ema import ema_stream
from hnet_mamba_asr_torch.ops.ema_cuda import ema_stream_cuda
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_torch.tools import measure
from hnet_mamba_asr_tpu.models import mamba2 as jmamba2
from hnet_mamba_asr_tpu.models import rnnt as jrnnt
from hnet_mamba_asr_tpu.models import streaming as jstreaming
from hnet_mamba_asr_tpu.tasks import asr_task as jtask

# JAX's own bar for streaming against offline (tests/test_streaming.py)
STREAM_TOL = 2e-4
# the port's streaming against JAX's streaming: fp32 through 3-6 layers,
# summation order only
JAX_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _config(arch="A", N=1.0, bidirectional=False, chunker="dynamic", n_main=2):
    return {"encoder": "dcasr", "head": "ctc", "frontend_conf": {"n_mels": 20},
            "encoder_conf": {"d_outer": 16, "d_main": 24, "n_enc": 1, "n_main": n_main,
                             "n_dec": 1, "n_mid": 1, "arch_type": arch, "d_state": 8,
                             "headdim": 8, "ssd_chunk_size": 16,
                             "bidirectional": bidirectional,
                             "hnet": {"compression_N": N, "chunker": chunker}},
            "model_conf": {"ctc_weight": 1.0, "aed_weight": 0.0}}


def _models(cfg, seed=1):
    """The JAX model, seeded params (the routers' W_q and W_k drawn at random,
    away from their identity init, so that they keep a mix of frames, as
    tests/test_streaming.py::_causal_chunked_model draws them) and the
    port's model with the same weights."""
    jm = jtask.build_model(cfg, 12)
    params = seeded_tree(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=seed)
    model = build_model(cfg, 12, device="cpu")
    convert.load_jax_params(model, params)
    return jm, params, model


def _feed(enc, wave, seed):
    """Ragged pushes of 700-3500 samples, then finish; the segments joined."""
    r, segs, i = np.random.default_rng(seed), [], 0
    while i < len(wave):
        n = int(r.integers(700, 3500))
        segs += enc.accept(wave[i:i + n])
        i += n
    tail = enc.finish()
    if tail is not None:
        segs.append(tail)
    return np.concatenate([np.asarray(s) for s in segs], axis=0)


def _port_offline(model, wave):
    with torch.inference_mode():
        enc = model.encode({"wave": _t(wave[None]), "wave_lens": torch.tensor([len(wave)])})
    return enc.features[0, :int(enc.lengths[0])].numpy()


# ---- the carried EMA -------------------------------------------------------------
def test_ema_stream_matches_jax():
    """Mixed ``has``, ``n_real`` 0 (the carry untouched, has included), full
    and partial blocks, saturated P, over two blocks with the carry threaded
    through; the wrapper's CPU route is the plain version."""
    rng = np.random.default_rng(0)
    B, E, D = 5, 7, 6
    carry = {"ema": rng.normal(size=(B, D)).astype(np.float32),
             "has": np.array([True, False, True, False, True])}
    for block in range(2):
        z = rng.normal(size=(B, E, D)).astype(np.float32)
        P = rng.uniform(size=(B, E)).astype(np.float32)
        P[:, ::3] = 1.0
        P[1, 1] = 0.0
        n_real = np.array([E, 3, 0, 0 if block == 0 else 5, 1], np.int32)
        want, wst = jstreaming._ema_stream(jnp.asarray(z), jnp.asarray(P), jnp.asarray(n_real),
                                           {k: jnp.asarray(v) for k, v in carry.items()})
        tc = {k: _t(v) for k, v in carry.items()}
        got, gst = ema_stream(_t(z), _t(P), _t(n_real), tc)
        got2, _ = ema_stream_cuda(_t(z), _t(P), _t(n_real), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
        np.testing.assert_allclose(gst["ema"].numpy(), np.asarray(wst["ema"]), rtol=0, atol=1e-6)
        assert gst["has"].numpy().tolist() == np.asarray(wst["has"]).tolist()
        assert torch.equal(got, got2)
        # n_real 0: the row emits its carry and keeps it, has included
        if block == 0:
            assert torch.equal(gst["ema"][2], tc["ema"][2]) and not gst["has"][3]
            assert torch.equal(got[2], tc["ema"][2].expand(E, D))
        carry = {"ema": gst["ema"].numpy(), "has": gst["has"].numpy()}


def test_ema_stream_cost_counts_real_rows():
    """The carried EMA's bound counts z and P on the real rows only (a
    padding row emits the carry and reads neither), zbar on every row, the
    counts, the carry and ``has``; FLOPs on the real rows."""
    M, D, es = 16, 384, 4
    fixed = 3 * M * D * es + 3 * 4 + 2 * 3 * (4 * D + 1)     # zbar, counts, carry
    for n_real in ([0, 0, 0], [16, 5, 0], [16, 16, 16]):
        real = sum(n_real)
        cost = measure.ema_stream_cost(torch.tensor(n_real), M, D, "float32")
        assert cost["bytes"] == fixed + real * (D * es + 4)
        assert cost["flops"] == 3 * real * D
        assert measure.ema_stream_cost(n_real, M, D, "float32") == cost


# ---- one Mamba-2 layer -------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_mamba2_step_matches_jax(masked):
    """Three blocks with the state carried, the conv tail and the SSD state
    compared after each; with ``n_real`` (padding rows past it), only the
    real rows' outputs are defined."""
    rng = np.random.default_rng(1)
    B, E, d = 3, 8, 16
    jm = jmamba2.Mamba2(d_model=d, d_state=8, headdim=8, chunk_size=16)
    tree = module_tree(jm, jnp.zeros((B, E, d)), seed=2)
    layer = Mamba2(d, d_state=8, headdim=8, chunk_size=16)
    convert.load_jax_params(layer, tree)
    jst = {"conv": jnp.zeros((B, 3, 2 * d + 16)), "ssd": jnp.zeros((B, 4, 8, 8))}
    st = layer.fresh_state(B, "cpu")
    for block in range(3):
        u = rng.normal(size=(B, E, d)).astype(np.float32)
        n_real = np.array([E, 5, block], np.int32) if masked else None
        want, jst = jstreaming._mamba2_stream(tree, jnp.asarray(u), jst, headdim=8, d_state=8,
                                              chunk_size=8, n_real=n_real)
        with torch.inference_mode():
            got, st = layer.step(_t(u), st, None if n_real is None else _t(n_real))
        real = np.arange(E)[None, :] < (np.full((B, 1), E) if n_real is None
                                        else n_real[:, None])
        np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], rtol=0,
                                   atol=1e-5)
        for k in ("conv", "ssd"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), rtol=0, atol=1e-5)


# ---- the exact-causal encoder ---------------------------------------------------------
@pytest.fixture(scope="module")
def causal_models():
    # seeds whose routers keep between 5 and 95 % of the frames at every level
    return {key: _models(_config(*key), seed=seed)
            for key, seed in ((("A", 1.0), 1), (("A", 2.0), 1), (("B", 4.0), 2))}


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("arch,N", [("A", 1.0), ("A", 2.0), ("B", 4.0)])
def test_causal_streaming_matches_jax_and_offline(causal_models, arch, N, block):
    """Ragged pushes: the port's streamed frames against JAX's streamed ones
    and against the port's offline encoder. At N > 1 the routers keep a mix
    of frames, so both carry branches run."""
    jm, params, model = causal_models[(arch, N)]
    wave = (np.random.default_rng(3).normal(size=19000) * 0.1).astype(np.float32)
    if N > 1:
        with torch.inference_mode():
            enc = model.encode({"wave": _t(wave[None]), "wave_lens": torch.tensor([len(wave)])})
        assert all(0.05 < float(k) < 0.95 for k in enc.kept_fractions)
    got = _feed(streaming.CausalStreamingEncoder(model, block_enc=block), wave, seed=2)
    want = _feed(jstreaming.CausalStreamingEncoder(jm, params, block_enc=block), wave, seed=2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(got, _port_offline(model, wave), rtol=STREAM_TOL,
                               atol=STREAM_TOL)


def test_causal_streaming_refusals(causal_models):
    bidi = build_model(_config(bidirectional=True), 12, device="cpu")
    with pytest.raises(ValueError, match="bidirectional"):
        streaming.CausalStreamingEncoder(bidi)
    fixed = build_model(_config(N=4.0, chunker="fixed", n_main=1), 12, device="cpu")
    with pytest.raises(ValueError, match="dynamic"):
        streaming.CausalStreamingEncoder(fixed)
    with pytest.raises(ValueError, match="block_enc must be >= 1"):
        streaming.CausalStreamingEncoder(causal_models[("A", 1.0)][2], block_enc=0)
    for kw in ({"seg_frames": 10}, {"lookahead": 2}, {"left_ctx": 0}):
        with pytest.raises(ValueError, match="multiple of 4"):
            streaming.StreamingEncoder(bidi, **kw)


# ---- the windowed encoder -----------------------------------------------------------------
@pytest.fixture(scope="module")
def windowed():
    """The bidirectional tiny model of tests/test_streaming.py in both packages."""
    return _models(_config(bidirectional=True, n_main=1), seed=0)


def test_windowed_stream_frames_and_exactness(windowed):
    """Frame counts equal offline's; a window covering the utterance gives
    the offline frames; the error shrinks with context."""
    model = windowed[2]
    rng = np.random.default_rng(4)
    for n in (6400, 9973, 16000):
        wave = (rng.normal(size=n) * 0.1).astype(np.float32)
        se = streaming.StreamingEncoder(model, seg_frames=16, left_ctx=64, lookahead=16)
        assert _feed(se, wave, 0).shape == _port_offline(model, wave).shape, n
    wave = (rng.normal(size=9600) * 0.1).astype(np.float32)
    off = _port_offline(model, wave)
    st = _feed(streaming.StreamingEncoder(model, seg_frames=16, left_ctx=1024, lookahead=64),
               wave, 0)
    np.testing.assert_allclose(st, off, rtol=1e-4, atol=1e-4)
    wave = (rng.normal(size=24000) * 0.1).astype(np.float32)
    off = _port_offline(model, wave)
    err = lambda left, la: float(np.abs(_feed(streaming.StreamingEncoder(  # noqa: E731
        model, seg_frames=16, left_ctx=left, lookahead=la), wave, 0) - off).max())
    small, big = err(16, 8), err(512, 128)
    assert big <= small + 1e-6 and (big < 0.15 * max(small, 1e-9) or big < 1e-3)


# ---- incremental CTC greedy --------------------------------------------------------------
def test_streaming_ctc_greedy_ids_exact(windowed, causal_models):
    """The collapse carried across segments; the windowed stream's ids equal
    JAX's StreamingCTCGreedy's, the causal stream's the offline greedy's."""
    prev = 9
    out = []
    for seg in ([9, 4, 4], [4, 9, 4], [5, 5, 9]):
        toks, prev = streaming.collapse(np.array(seg), prev, 9)
        out += toks
    assert out == [4, 4, 5]
    wave = (np.random.default_rng(5).normal(size=16000) * 0.3).astype(np.float32)
    jm, params, model = windowed
    kw = dict(seg_frames=16, left_ctx=1024, lookahead=128)
    jsc = jstreaming.StreamingCTCGreedy(jm, params, jstreaming.StreamingEncoder(jm, params, **kw))
    sc = streaming.StreamingCTCGreedy(model, streaming.StreamingEncoder(model, **kw))
    got, want = [], []
    for i in range(0, len(wave), 3200):
        got += sc.accept(wave[i:i + 3200])
        want += jsc.accept(wave[i:i + 3200])
    assert got + sc.finish() == want + jsc.finish()
    _, _, causal = causal_models[("A", 2.0)]
    sc = streaming.StreamingCTCGreedy(causal, streaming.CausalStreamingEncoder(causal,
                                                                               block_enc=8))
    got = []
    for i in range(0, len(wave), 2100):
        got += sc.accept(wave[i:i + 2100])
    with torch.inference_mode():
        offline = causal.greedy_decode({"wave": _t(wave[None]),
                                        "wave_lens": torch.tensor([len(wave)])})[0]
    assert got + sc.finish() == offline


# ---- the transducer beam's carried state ---------------------------------------------------
def test_rnnt_beam_streaming_state_matches_jax():
    """tests/test_rnnt.py::test_rnnt_beam_streaming_state through the device
    beam: block by block with the beam passed back as ``state`` (a ragged
    last block masked by the lengths) equals JAX's one pass exactly, at
    blocks of 1, 4 and 5 frames."""
    V, D, T, B, L = 6, 10, 12, 2, 24
    jhead = jrnnt.RNNTHead(vocab_size=V, d_memory=D, d_pred=8, d_joint=16, context=2,
                           max_symbols=3, max_decode_len=24)
    r = np.random.default_rng(90)
    mem = (r.normal(size=(B, T, D)) * 1.5).astype(np.float32)
    lens = np.asarray([T, 9])
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(mem), jnp.asarray(lens),
                        jnp.zeros((B, 3), jnp.int32), jnp.full((B,), 3), method="loss")["params"]
    ref = [np.asarray(x) for x in jhead.apply({"params": params}, jnp.asarray(mem),
                                              jnp.asarray(lens), 4, method="beam_decode_nbest",
                                              token_buf_len=L)]
    head = RNNTHead(V, D, d_pred=8, d_joint=16, context=2, max_symbols=3, max_decode_len=24)
    convert.load_jax_params(head, params)
    for block in (1, 4, 5):
        state, done = None, np.zeros(B, np.int64)
        for t0 in range(0, T, block):
            n = min(block, T - t0)
            nv = np.clip(lens - done, 0, n)
            state = device_rnnt_beam.beam_decode_nbest(head, _t(mem[:, t0:t0 + n]), _t(nv), 4,
                                                       state=state, token_buf_len=L)
            done += n
        np.testing.assert_array_equal(state[0].numpy(), ref[0], err_msg=str(block))
        np.testing.assert_array_equal(state[1].numpy(), ref[1])
        np.testing.assert_allclose(state[2].numpy(), ref[2], rtol=0, atol=1e-5)
