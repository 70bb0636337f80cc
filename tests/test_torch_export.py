"""The port's serving artifacts (hnet_mamba_asr_torch/serving/{quant,export,
runtime}.py) against the JAX package's, on the CPU in fp32 at narrow widths.

- quantize_tree / quantization_error equal JAX's bitwise (a zero channel
  included);
- for a Type A N=1 model with CTC and AED heads and a Type A N=2 model, the
  port's params.npz equals JAX's exporter's from the same params, key for
  key, in dtype and bitwise, fp32 and int8;
- the N=1 model's artifact, fp32 and int8, served by load_serving_artifact
  on the CPU against JAX's runtime on JAX's artifact: enc_lengths and
  frame_ids, aed_ids and beam_ids equal, log_probs within LOGP_ATOL; a
  JAX-exported directory serves in the port given its config;
- the N=2 model's artifact, fp32 and int8, against JAX's model run on the
  same (dequantized) weights: JAX traces four programs in this file (the
  N=1 fp32 and int8 exports, and the two streaming exports below), and its
  runtime is held to its live model by tests/test_serving_export.py;
- the manifest's keys are a superset of JAX's; a format_version mismatch,
  the emit checks and a bucket overflow raise with JAX's words;
- streaming: an N=2 CTC pool at batch 2 and a transducer with
  stream_decode="beam" give the ids of JAX's load_streaming_pool /
  load_streaming_artifact on the same audio.
"""
import copy
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from torch_parity import seeded_tree

from hnet_mamba_asr_torch.data.features import GlobalCMVN
from hnet_mamba_asr_torch.serving import export as texport
from hnet_mamba_asr_torch.serving import quant as tquant
from hnet_mamba_asr_torch.serving import runtime as truntime
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_tpu.data import features as jfeatures
from hnet_mamba_asr_tpu.serving import export as jexport
from hnet_mamba_asr_tpu.serving import quant as jquant
from hnet_mamba_asr_tpu.serving import runtime as jruntime
from hnet_mamba_asr_tpu.tasks import asr_task as jtask

LOGP_ATOL = 2e-4       # tests/test_torch_slice.py's: fp32 through the blocks
V = 12
ENC = {"d_outer": 16, "d_main": 24, "n_enc": 1, "n_main": 1, "n_dec": 1, "arch_type": "A",
       "d_state": 8, "headdim": 8, "ssd_chunk_size": 16}
FRONT = {"n_mels": 20}
N1_CONFIG = {"frontend_conf": FRONT, "encoder_conf": {**ENC, "hnet": {"compression_N": 1}},
             "aed_conf": {"n_layers": 1, "n_heads": 2, "d_ff": 32, "max_decode_len": 6},
             "model_conf": {"ctc_weight": 0.3, "aed_weight": 0.7},
             "train": {"precision": "fp32"}}
N2_CONFIG = {"frontend_conf": FRONT, "encoder_conf": {**ENC, "hnet": {"compression_N": 2}},
             "model_conf": {"ctc_weight": 1.0, "aed_weight": 0.0},
             "train": {"precision": "fp32"}}
STREAM_CONFIG = copy.deepcopy(N2_CONFIG)
STREAM_CONFIG["encoder_conf"]["bidirectional"] = False
RNNT_CONFIG = {"frontend_conf": FRONT,
               "encoder_conf": {**ENC, "bidirectional": False, "hnet": {"compression_N": 1}},
               "rnnt_conf": {"d_pred": 8, "d_joint": 16, "context": 2, "max_symbols": 3},
               "model_conf": {"ctc_weight": 0.0, "aed_weight": 0.0, "rnnt_weight": 1.0},
               "train": {"precision": "fp32"}}
EMIT = ("frame_ids", "log_probs", "aed_ids", "beam_ids")
BUCKET = (2, 16000)
BEAM = dict(beam_size=4, pre_beam=6)
MIN_SIZE = 256         # quantize the narrow model's projections too


class _Tok:
    """The tokenizer attributes an export embeds."""
    pieces = ["<unk>", "<s>", "</s>", "<pad>"] + [f"▁p{i}" for i in range(V - 4)]
    unk_id, bos_id, eos_id, pad_id = 0, 1, 2, 3


def _jax_model(cfg, seed, cmvn=None):
    jm = jtask.build_model(cfg, V, cmvn=cmvn)
    return jm, seeded_tree(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=seed)


def _port_model(cfg, params, cmvn=None):
    from hnet_mamba_asr_torch.convert import load_jax_params
    return load_jax_params(build_model(cfg, V, cmvn=cmvn, device="cpu"), params)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_npz_equal(got_path, want_path):
    got, want = _npz(got_path), _npz(want_path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k


def _waves():
    rng = np.random.default_rng(7)
    wave = (rng.normal(size=(2, 12000)) * 0.1).astype(np.float32)
    lens = np.array([12000, 7100], np.int32)
    wave[1, lens[1]:] = 0.0
    return wave, lens


def _assert_outputs_match(got, want):
    np.testing.assert_array_equal(got["enc_lengths"], want["enc_lengths"])
    for b, n in enumerate(want["enc_lengths"]):
        np.testing.assert_array_equal(got["frame_ids"][b, :n], want["frame_ids"][b, :n])
        np.testing.assert_allclose(got["log_probs"][b, :n], want["log_probs"][b, :n],
                                   rtol=0, atol=LOGP_ATOL)
        assert (got["beam_ids"][b, :got["beam_lens"][b]].tolist()
                == want["beam_ids"][b, :want["beam_lens"][b]].tolist())
    np.testing.assert_array_equal(got["aed_ids"], want["aed_ids"])


@pytest.fixture(scope="module")
def n1(tmp_path_factory):
    """The N=1 hybrid model: JAX's artifacts (fp32, int8) and the port's
    from the same weights; ``jax_out(q)`` runs JAX's runtime once a mode."""
    root = tmp_path_factory.mktemp("n1")
    rng = np.random.default_rng(0)
    jcmvn = jfeatures.GlobalCMVN(rng.normal(size=20) - 5.0, rng.uniform(0.5, 2.0, size=20))
    jm, params = _jax_model(N1_CONFIG, seed=1, cmvn=jcmvn)
    cmvn = GlobalCMVN(jcmvn.mean, np.ones(20, np.float32))
    cmvn.istd = np.asarray(jcmvn.istd, np.float32)
    model = _port_model(N1_CONFIG, params, cmvn)
    wave, lens = _waves()
    out = {"params": params, "model": model, "cmvn": cmvn, "wave": wave, "lens": lens}
    for q in (None, "int8"):
        jdir, tdir = root / f"jax_{q}", root / f"port_{q}"
        jexport.save_serving_artifact(jdir, jm, params, buckets=[BUCKET], emit=EMIT,
                                      quantize=q, quantize_min_size=MIN_SIZE,
                                      tokenizer=_Tok(), **BEAM)
        texport.save_serving_artifact(tdir, model, buckets=[BUCKET], emit=EMIT, quantize=q,
                                      quantize_min_size=MIN_SIZE, tokenizer=_Tok(),
                                      config=N1_CONFIG, **BEAM)
        out[q] = {"jax_dir": jdir, "port_dir": tdir}
    runs = {}

    def jax_out(q):
        if q not in runs:
            runs[q] = jruntime.load_serving_artifact(out[q]["jax_dir"])(wave, lens)
        return runs[q]

    out["jax_out"] = jax_out
    return out


def test_quantize_tree_and_error_equal_jax():
    rng = np.random.default_rng(3)
    tree = {"a": {"kernel": rng.normal(size=(64, 80)).astype(np.float32),
                  "bias": rng.normal(size=80).astype(np.float32)},
            "conv": {"kernel": rng.normal(size=(3, 3, 8, 32)).astype(np.float32)},
            "small": {"kernel": rng.normal(size=(4, 4)).astype(np.float32)},
            "zero": {"kernel": rng.normal(size=(96, 48)).astype(np.float32)},
            "ids": np.arange(5000, dtype=np.int32).reshape(50, 100)}
    tree["zero"]["kernel"][:, 7] = 0.0                   # a zero channel: scale 1
    got = tquant.quantize_tree(tree, min_size=1000)
    want = jax.tree_util.tree_map(np.asarray, jquant.quantize_tree(tree, min_size=1000))
    flat_got = texport.path_dict(got)
    flat_want = {jax.tree_util.keystr(k): np.asarray(v)
                 for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(flat_got) == sorted(flat_want)
    for k in flat_want:
        assert flat_got[k].dtype == flat_want[k].dtype and np.array_equal(
            flat_got[k], flat_want[k]), k
    assert got["zero"]["kernel"]["~scale"][7] == 1.0 and not got["zero"]["kernel"]["~q8"][:, 7].any()
    assert "~q8" not in got["small"]["kernel"] and got["ids"].dtype == np.int32
    err = tquant.quantization_error(tree, got)
    assert err == jquant.quantization_error(tree, want) and 0 < err <= 1 / 254 + 1e-7
    deq = tquant.dequantize_tree(got)
    jdeq = jax.tree_util.tree_map(np.asarray, jquant.dequantize_tree(want))
    for k, v in texport.path_dict(jdeq).items():
        assert np.array_equal(texport.path_dict(deq)[k], v), k


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_n1_params_npz_equals_jax(n1, quantize):
    _assert_npz_equal(n1[quantize]["port_dir"] / "params.npz",
                      n1[quantize]["jax_dir"] / "params.npz")


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_n1_served_outputs_match_jax_runtime(n1, quantize):
    sm = truntime.load_serving_artifact(n1[quantize]["port_dir"], "cpu")
    assert sm.buckets == [BUCKET] and sm.emit == EMIT
    assert (sm.beam_size, sm.pre_beam) == (BEAM["beam_size"], BEAM["pre_beam"])
    got = sm(n1["wave"], n1["lens"])
    _assert_outputs_match(got, n1["jax_out"](quantize))
    jsm = jruntime.load_serving_artifact(n1[quantize]["jax_dir"])
    assert sm.transcribe_text(n1["wave"], n1["lens"]) == jsm.transcribe_text(
        n1["wave"], n1["lens"])
    if quantize is None:                 # the artifact's weights are the model's
        direct = truntime.ServingModel(N1_CONFIG, n1["params"], "cpu", vocab_size=V,
                                       cmvn=n1["cmvn"], emit=EMIT, **BEAM)
        for k, v in direct(n1["wave"], n1["lens"]).items():
            assert np.array_equal(got[k], v), k


def test_port_serves_a_jax_artifact_given_its_config(n1, tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="carries no config"):
        truntime.load_serving_artifact(n1["int8"]["jax_dir"], "cpu")
    sm = truntime.load_serving_artifact(n1["int8"]["jax_dir"], "cpu", config=N1_CONFIG,
                                        cmvn=n1["cmvn"])
    _assert_outputs_match(sm(n1["wave"], n1["lens"]), n1["jax_out"]("int8"))
    assert sm.manifest["quantize"] == "int8"
    # without cmvn=, the config's relative CMVN path resolves against the
    # repository root, as the command-line tools resolve it, not the cwd
    root, elsewhere = tmp_path / "root", tmp_path / "elsewhere"
    (root / "stats").mkdir(parents=True)
    elsewhere.mkdir()
    n1["cmvn"].save(root / "stats" / "cmvn.npz")
    monkeypatch.setattr(truntime, "REPO_ROOT", root)
    monkeypatch.chdir(elsewhere)
    cfg = copy.deepcopy(N1_CONFIG)
    cfg["frontend_conf"]["cmvn"] = "stats/cmvn.npz"
    manifest, _, _, cmvn = truntime.read_artifact(n1["int8"]["jax_dir"], cfg)
    np.testing.assert_array_equal(cmvn.mean, n1["cmvn"].mean)
    np.testing.assert_allclose(cmvn.istd, n1["cmvn"].istd, rtol=1e-6)


def test_manifest_keys_and_errors(n1, tmp_path):
    jman = json.loads((n1[None]["jax_dir"] / "manifest.json").read_text())
    tman = json.loads((n1[None]["port_dir"] / "manifest.json").read_text())
    assert set(jman) <= set(tman)
    for k in ("format_version", "vocab_size", "blank_id", "emit", "quantize", "beam",
              "tokenizer"):
        assert tman[k] == jman[k], k
    assert tman["buckets"] == [{"batch": 2, "samples": 16000}]
    assert tman["runtime"] == "torch" and tman["config"] == N1_CONFIG and tman["platforms"] == []
    assert tman["tokenizer"]["drop_ids"] == [1, 2, 3]     # unk kept, as JAX's table
    # format_version
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "manifest.json").write_text(json.dumps(dict(tman, format_version=99)))
    with pytest.raises(ValueError, match="artifact format 99 != supported 1"):
        truntime.load_serving_artifact(bad, "cpu")
    # emit and bucket checks, with JAX's words
    model = n1["model"]
    jm, jparams = _jax_model(N1_CONFIG, 1)
    for kw, match in (({"emit": ("nope",)}, "unknown emit mode"),
                      ({"emit": ()}, "at least one output"),
                      ({"emit": ("rnnt_ids",)}, "require an RNNT head"),
                      ({"buckets": [(2, 4000), (2, 4000)]}, "duplicate buckets"),
                      ({"buckets": [(1, 399)]}, "one STFT window"),
                      ({"quantize": "int4"}, "quantize must be None or 'int8'")):
        args = {"buckets": [BUCKET], "config": N1_CONFIG, **kw}
        with pytest.raises(ValueError, match=match):
            texport.save_serving_artifact(tmp_path / "x", model, **args)
        with pytest.raises(ValueError, match=match):
            jexport.save_serving_artifact(tmp_path / "y", jm, jparams, **{"buckets": [BUCKET],
                                                                           **kw})
    ctc_only = build_model(N2_CONFIG, V, device="cpu")
    with pytest.raises(ValueError, match="aed_ids requires an AED head"):
        texport.save_serving_artifact(tmp_path / "z", ctc_only, buckets=[BUCKET],
                                      emit=("aed_ids",), config=N2_CONFIG)
    sm = truntime.load_serving_artifact(n1[None]["port_dir"], "cpu")
    for shape in ((3, 800), (1, 16001)):
        msg = f"no bucket fits batch={shape[0]} samples={shape[1]}"
        with pytest.raises(ValueError, match=msg):
            sm(np.zeros(shape, np.float32), [shape[1]] * shape[0])
        with pytest.raises(ValueError, match=msg):
            jruntime.load_serving_artifact(n1[None]["jax_dir"])(
                np.zeros(shape, np.float32), [shape[1]] * shape[0])


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_n2_params_npz_and_outputs_match_jax(tmp_path, quantize):
    jm, params = _jax_model(N2_CONFIG, seed=5)
    model = _port_model(N2_CONFIG, params)
    jexport.save_serving_artifact(tmp_path / "j", jm, params, buckets=[], quantize=quantize,
                                  quantize_min_size=MIN_SIZE)
    texport.save_serving_artifact(tmp_path / "t", model, buckets=[BUCKET],
                                  emit=("frame_ids", "log_probs"), quantize=quantize,
                                  quantize_min_size=MIN_SIZE, config=N2_CONFIG)
    _assert_npz_equal(tmp_path / "t" / "params.npz", tmp_path / "j" / "params.npz")
    wave, lens = _waves()
    served = jax.tree_util.tree_map(np.asarray, jquant.dequantize_tree(
        jruntime.params_to_tree(_npz(tmp_path / "j" / "params.npz"))))
    enc = jax.jit(lambda p, w, n: jm.encode(p, {"wave": w, "wave_lens": n}))(
        served, jnp.asarray(wave), jnp.asarray(lens))
    assert 0.05 < float(enc.kept_fractions[0]) < 0.95
    logp = np.asarray(jm.ctc.apply({"params": served["ctc"]}, enc.features, method="log_probs"))
    got = truntime.load_serving_artifact(tmp_path / "t", "cpu")(wave, lens)
    np.testing.assert_array_equal(got["enc_lengths"], np.asarray(enc.lengths))
    for b, n in enumerate(np.asarray(enc.lengths)):
        np.testing.assert_array_equal(got["frame_ids"][b, :n], logp[b, :n].argmax(-1))
        np.testing.assert_allclose(got["log_probs"][b, :n], logp[b, :n], rtol=0, atol=LOGP_ATOL)


def _interleave(pool, waves, sizes):
    sids = [pool.open() for _ in waves]
    got = {s: [] for s in sids}
    pos = [0] * len(waves)
    while any(p < len(w) for p, w in zip(pos, waves)):
        for k, sid in enumerate(sids):
            if pos[k] < len(waves[k]):
                got[sid] += pool.feed(sid, waves[k][pos[k]:pos[k] + sizes[k]])
                pos[k] += sizes[k]
    return [got[s] + pool.finish(s) for s in sids]


def test_streaming_n2_pool_matches_jax(tmp_path):
    jm, params = _jax_model(STREAM_CONFIG, seed=3)
    model = _port_model(STREAM_CONFIG, params)
    jexport.save_streaming_artifact(tmp_path / "j", jm, params, block_enc=8, batch=2)
    texport.save_streaming_artifact(tmp_path / "t", model, block_enc=8, batch=2,
                                    config=STREAM_CONFIG)
    _assert_npz_equal(tmp_path / "t" / "params.npz", tmp_path / "j" / "params.npz")
    jman = json.loads((tmp_path / "j" / "manifest.json").read_text())
    tman = json.loads((tmp_path / "t" / "manifest.json").read_text())
    assert set(jman) <= set(tman) and tman["kind"] == "streaming"
    assert {k: v for k, v in jman["streaming"].items() if k != "file"} == tman["streaming"]
    rng = np.random.default_rng(11)
    waves = [(rng.normal(size=n) * 0.1).astype(np.float32) for n in (9000, 12400)]
    want = _interleave(jruntime.load_streaming_pool(tmp_path / "j"), waves, (1300, 2200))
    pool = truntime.load_streaming_pool(tmp_path / "t", "cpu")
    assert pool.B == 2 and pool.E == 8
    assert _interleave(pool, waves, (1300, 2200)) == want
    assert sum(map(len, want)) > 0
    with pytest.raises(ValueError, match="exported at batch 2"):
        truntime.load_streaming_artifact(tmp_path / "t", "cpu")
    with pytest.raises(ValueError, match="a streaming artifact"):
        truntime.load_serving_artifact(tmp_path / "t", "cpu")


def test_streaming_rnnt_beam_matches_jax(tmp_path):
    jm, params = _jax_model(RNNT_CONFIG, seed=9)
    model = _port_model(RNNT_CONFIG, params)
    kw = dict(block_enc=8, stream_decode="beam", beam_size=4, token_buf_len=24)
    jexport.save_streaming_artifact(tmp_path / "j", jm, params, quantize="int8",
                                    quantize_min_size=MIN_SIZE, **kw)
    texport.save_streaming_artifact(tmp_path / "t", model, quantize="int8",
                                    quantize_min_size=MIN_SIZE, config=RNNT_CONFIG, **kw)
    _assert_npz_equal(tmp_path / "t" / "params.npz", tmp_path / "j" / "params.npz")
    with pytest.raises(ValueError, match="requires an RNNT-only model"):
        texport.save_streaming_artifact(tmp_path / "x", _port_model(STREAM_CONFIG, _jax_model(
            STREAM_CONFIG, 3)[1]), stream_decode="beam", config=STREAM_CONFIG)
    wave = (np.random.default_rng(30).normal(size=9000) * 0.1).astype(np.float32)
    outs = []
    for sm in (jruntime.load_streaming_artifact(tmp_path / "j"),
               truntime.load_streaming_artifact(tmp_path / "t", "cpu")):
        fed = []
        for i in range(0, len(wave), 1300):
            fed += sm.feed(wave[i:i + 1300])
        assert fed == [] and sm.partial
        outs.append(sm.finish())
    assert outs[0] == outs[1] and outs[0]


def test_micro_batcher_keeps_each_batch_inside_a_bucket(n1):
    """A fault of JAX's MicroBatcher, repaired in the port's: with buckets
    (2, 16000) and (1, 32000), a 20000-sample request and an 8000-sample one
    that arrive together are padded into one call of (2, 20000), which fits
    no bucket, and both fail; the port's batcher runs them apart."""
    from hnet_mamba_asr_torch.serving.server import MicroBatcher
    from hnet_mamba_asr_tpu.serving.server import MicroBatcher as JMicroBatcher
    rng = np.random.default_rng(8)
    waves = [(rng.normal(size=n) * 0.1).astype(np.float32) for n in (20000, 8000)]
    buckets = [(2, 16000), (1, 32000)]

    class _JaxRuntime(jruntime.ServingModel):          # JAX's bucket choice, no program
        def __init__(self):
            self._fns = dict.fromkeys(buckets)
            self.manifest, self.blank_id, self.emit = {}, V, ("frame_ids",)

        def __call__(self, wave, lens):
            self._pick(*np.asarray(wave).shape)
            return {"enc_lengths": np.ones(len(lens), np.int32),
                    "frame_ids": np.zeros((len(lens), 1), np.int32)}

    for batcher_cls, model in ((JMicroBatcher, _JaxRuntime()),
                               (MicroBatcher, truntime.ServingModel(
                                   N1_CONFIG, n1["params"], "cpu", vocab_size=V,
                                   cmvn=n1["cmvn"], buckets=buckets))):
        batcher = batcher_cls(model, max_wait_ms=500.0)
        try:
            futures = [batcher.submit(w) for w in waves]
            errors = [f.exception(timeout=60) for f in futures]
            stats = batcher.stats()
        finally:
            batcher.close()
        if batcher_cls is JMicroBatcher:
            assert all(isinstance(e, ValueError) and "no bucket fits batch=2 samples=20000"
                       in str(e) for e in errors)
            continue
        assert errors == [None, None] and stats["batches"] == 2
        for w, f in zip(waves, futures):
            assert f.result()["ids"] == model.transcribe_ids(w[None], [len(w)])[0]


def test_artifact_without_buckets_raises(tmp_path):
    model = build_model(N2_CONFIG, V, device="cpu")
    with pytest.raises(ValueError, match="at least one \\(batch, samples\\) shape"):
        texport.save_serving_artifact(tmp_path / "none", model, buckets=[], config=N2_CONFIG)
    # a manifest with no bucket (a JAX export may write one) is refused at load
    texport.save_serving_artifact(tmp_path, model, buckets=[BUCKET], config=N2_CONFIG)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    (tmp_path / "manifest.json").write_text(json.dumps(dict(manifest, buckets=[])))
    with pytest.raises(ValueError, match="artifact has no shape buckets"):
        truntime.load_serving_artifact(tmp_path, "cpu")
