"""The port's whole serving slice against the JAX package at a narrow Type A
N=1 config: raw waveform -> log-mel -> CMVN -> encoder -> CTC, on a ragged
2-row batch, with weights carried over by hnet_mamba_asr_torch/convert.py.
Also the params.npz route, the micro-batching server, the converter's
refusals, and the copy of the gate config that chip_smoke.py runs."""
import copy
import json
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from torch_parity import NARROW_CONFIG, NARROW_VOCAB, ragged_waves, seeded_tree

import chip_smoke
from hnet_mamba_asr_torch.convert import jax_to_state_dict, load_jax_params
from hnet_mamba_asr_torch.data.features import GlobalCMVN
from hnet_mamba_asr_torch.serving.runtime import ServingModel, collapse_ctc
from hnet_mamba_asr_torch.serving.server import MicroBatcher, make_server
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_torch.tools import gate
from hnet_mamba_asr_tpu.data import features as jfeatures
from hnet_mamba_asr_tpu.models import ctc_head as jctc
from hnet_mamba_asr_tpu.tasks import asr_task as jtask
from hnet_mamba_asr_tpu.training.checkpoint import tree_to_path_dict

REPO = Path(__file__).resolve().parents[1]
FEAT_ATOL = 1e-3       # log-mel atol 1e-4 (test_torch_modules), x CMVN istd <= 2
LOGP_ATOL = 2e-4       # fp32 through 4 blocks: summation order only


@pytest.fixture(scope="module")
def jax_slice():
    """JAX model, one seeded param tree, a ragged batch and its outputs."""
    rng = np.random.default_rng(0)
    cmvn = jfeatures.GlobalCMVN(rng.normal(size=80) - 5.0, rng.uniform(0.5, 2.0, size=80))
    model = jtask.build_model(NARROW_CONFIG, NARROW_VOCAB, cmvn=cmvn)
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    params = seeded_tree(shapes, seed=1)
    wave, lens = ragged_waves(rng, [16000, 9100])

    @jax.jit
    def forward(p, w, n):
        batch = {"wave": w, "wave_lens": n}
        feats, _ = model.features(batch, train=False)
        enc = model.encode(p, batch)
        logp = model.ctc.apply({"params": p["ctc"]}, enc.features, method="log_probs")
        ids = model.ctc.apply({"params": p["ctc"]}, enc.features, method="frame_argmax")
        return feats, enc.lengths, logp, ids

    out = [np.asarray(a) for a in forward(params, jnp.asarray(wave), jnp.asarray(lens))]
    return dict(params=params, cmvn=GlobalCMVN(cmvn.mean, 1.0 / cmvn.istd), wave=wave,
                lens=lens, feats=out[0], enc_lengths=out[1], log_probs=out[2],
                frame_ids=out[3], model=model)


def test_serving_forward_matches_jax(jax_slice):
    j = jax_slice
    sm = ServingModel(NARROW_CONFIG, j["params"], "cpu", cmvn=j["cmvn"],
                      emit=("frame_ids", "log_probs"))
    with torch.no_grad():
        feats, _ = sm.model.features({"wave": torch.from_numpy(j["wave"]),
                                      "wave_lens": torch.from_numpy(j["lens"])})
    out = sm(j["wave"], j["lens"])
    np.testing.assert_array_equal(out["enc_lengths"], j["enc_lengths"])
    for i, n in enumerate(j["enc_lengths"]):
        nf = 4 * n
        np.testing.assert_allclose(feats[i, :nf].numpy(), j["feats"][i, :nf],
                                   rtol=0, atol=FEAT_ATOL)
        np.testing.assert_allclose(out["log_probs"][i, :n], j["log_probs"][i, :n],
                                   rtol=0, atol=LOGP_ATOL)
        np.testing.assert_array_equal(out["frame_ids"][i, :n], j["frame_ids"][i, :n])
    assert sm.transcribe_ids(j["wave"], j["lens"]) == jctc.greedy_decode(
        j["frame_ids"], j["enc_lengths"], NARROW_VOCAB)


def test_params_npz_round_trip(jax_slice, tmp_path):
    j = jax_slice
    np.savez(tmp_path / "params.npz", **tree_to_path_dict(j["params"]))
    from_npz = ServingModel(NARROW_CONFIG, tmp_path / "params.npz", "cpu", cmvn=j["cmvn"])
    from_tree = ServingModel(NARROW_CONFIG, j["params"], "cpu", cmvn=j["cmvn"])
    assert from_npz.vocab_size == NARROW_VOCAB
    for k, v in from_tree.model.state_dict().items():
        assert torch.equal(v, from_npz.model.state_dict()[k]), k
    a, b = from_npz(j["wave"], j["lens"]), from_tree(j["wave"], j["lens"])
    np.testing.assert_array_equal(a["frame_ids"], b["frame_ids"])


def test_converter_refuses_mismatches(jax_slice):
    j = jax_slice
    model = build_model(NARROW_CONFIG, NARROW_VOCAB, device="cpu")
    extra = copy.deepcopy(j["params"])
    extra["aed"] = {"decoder": {"kernel": np.zeros((2, 2), np.float32)}}   # skipped
    load_jax_params(model, extra)
    missing = copy.deepcopy(j["params"])
    del missing["encoder"]["dec"]["block_0"]["bwd"]["a_log"]
    with pytest.raises(KeyError, match="a_log"):
        load_jax_params(model, missing)
    unknown = copy.deepcopy(j["params"])
    unknown["encoder"]["dec"]["block_0"]["bwd"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(model, unknown)
    quant = copy.deepcopy(j["params"])
    quant["ctc"]["proj"]["kernel"] = {"~q8": np.zeros((32, 31), np.int8),
                                      "~scale": np.ones(31, np.float32)}
    with pytest.raises(ValueError, match="int8"):
        jax_to_state_dict(quant)


def test_serving_limits_and_modes():
    sm = ServingModel(NARROW_CONFIG, None, "cpu", vocab_size=NARROW_VOCAB,
                      buckets=[(2, 8000)])
    with pytest.raises(ValueError, match="no bucket fits batch=3 samples=800"):
        sm(np.zeros((3, 800), np.float32), [800] * 3)
    with pytest.raises(ValueError, match="no bucket fits batch=1 samples=8001"):
        sm(np.zeros((1, 8001), np.float32), [8001])
    # the RNN-T modes need the RNN-T head and aed_ids the AED head, which this
    # CTC-only model lacks (JAX's export refuses them alike); with the head
    # rnnt_ids serves the transducer's greedy search; beam_ids serves the CTC
    # prefix beam
    for mode in ("rnnt_ids", "rnnt_beam_ids"):
        with pytest.raises(ValueError, match="RNNT head"):
            ServingModel(NARROW_CONFIG, None, "cpu", vocab_size=NARROW_VOCAB, emit=(mode,))
    rnnt_cfg = dict(NARROW_CONFIG, model_conf={"ctc_weight": 1.0, "rnnt_weight": 1.0},
                    rnnt_conf={"d_pred": 8, "d_joint": 16, "max_decode_len": 12})
    rnnt = ServingModel(rnnt_cfg, None, "cpu", vocab_size=NARROW_VOCAB, emit=("rnnt_ids",))
    wave = np.random.default_rng(1).normal(size=(2, 4000)).astype(np.float32)
    out = rnnt(wave, [4000, 2600])
    assert out["rnnt_ids"].shape == (2, 12) and (out["rnnt_lens"] <= 12).all()
    assert rnnt.transcribe_ids(wave, [4000, 2600]) == [
        out["rnnt_ids"][b, :out["rnnt_lens"][b]].tolist() for b in range(2)]
    with pytest.raises(ValueError, match="AED head"):
        ServingModel(NARROW_CONFIG, None, "cpu", vocab_size=NARROW_VOCAB, emit=("aed_ids",))
    beam = ServingModel(NARROW_CONFIG, None, "cpu", vocab_size=NARROW_VOCAB, emit=("beam_ids",))
    wave = np.random.default_rng(0).normal(size=(2, 4000)).astype(np.float32)
    out = beam(wave, [4000, 2600])
    assert out["beam_ids"].shape[0] == 2 and (out["beam_lens"] <= out["beam_ids"].shape[1]).all()
    # Type B and N > 1 build (tests/test_torch_hnet_train.py holds them to
    # JAX); a fixed-pool chunker needs an integer stride
    for cfg_change in ({"arch_type": "B"}, {"hnet": {"compression_N": 2}}):
        cfg = copy.deepcopy(NARROW_CONFIG)
        cfg["encoder_conf"].update(cfg_change)
        build_model(cfg, NARROW_VOCAB, device="cpu")
    cfg = copy.deepcopy(NARROW_CONFIG)
    cfg["encoder_conf"].update(arch_type="B", hnet={"compression_N": 2, "chunker": "fixed"})
    with pytest.raises(ValueError, match="integer stride"):
        build_model(cfg, NARROW_VOCAB, device="cpu")


def test_serving_model_runs_on_the_card_by_default():
    import inspect
    assert inspect.signature(ServingModel).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ServingModel(NARROW_CONFIG, None, vocab_size=NARROW_VOCAB)


def test_config_intra_dtype_reaches_the_scan():
    model = build_model(gate.GATE_CONFIG, gate.VOCAB, device="cpu")
    layers = [m for m in model.modules() if hasattr(m, "ssd_intra_dtype")]
    assert len(layers) == 40
    assert {m.ssd_intra_dtype for m in layers} == {"bf16"}
    narrow = build_model(NARROW_CONFIG, NARROW_VOCAB, device="cpu")
    assert {m.ssd_intra_dtype for m in narrow.modules()
            if hasattr(m, "ssd_intra_dtype")} == {None}


def test_micro_batcher_batched_equals_solo():
    sm = ServingModel(NARROW_CONFIG, None, "cpu", vocab_size=NARROW_VOCAB, seed=3)
    rng = np.random.default_rng(5)
    waves = [0.1 * rng.normal(size=n).astype(np.float32) for n in (7000, 12000, 3300)]
    batcher = MicroBatcher(sm, max_batch=3, max_wait_ms=2000)
    try:
        results = [f.result(timeout=60) for f in [batcher.submit(w) for w in waves]]
    finally:
        batcher.close()
    assert batcher.stats()["batches"] == 1
    for w, r in zip(waves, results):
        solo = sm(w[None], [len(w)])
        assert r["ids"] == collapse_ctc(solo["frame_ids"], solo["enc_lengths"], sm.blank_id)[0]
        assert r["enc_frames"] == int(solo["enc_lengths"][0])
    batcher = MicroBatcher(sm)
    try:
        with pytest.raises(ValueError, match="exceeds the largest"):
            batcher.submit(np.zeros(sm.max_samples + 1, np.float32))
    finally:
        batcher.close()


def test_http_round_trip():
    sm = ServingModel(NARROW_CONFIG, None, "cpu", vocab_size=NARROW_VOCAB,
                      tokenizer={"pieces": [f"▁w{i}" for i in range(NARROW_VOCAB)]})
    httpd, batcher = make_server(sm, max_wait_ms=1.0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    wave = 0.1 * np.random.default_rng(2).normal(size=4000).astype(np.float32)
    try:
        req = urllib.request.Request(f"{url}/v1/transcribe", data=wave.tobytes(),
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as r:
            res = json.loads(r.read())
        with urllib.request.urlopen(f"{url}/v1/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        server.join(timeout=10)
    assert not server.is_alive()
    assert res["ids"] == sm.transcribe_ids(wave[None], [len(wave)])[0]
    assert res["text"] == " ".join(f"w{i}" for i in res["ids"])
    assert res["enc_frames"] == 5 and stats["requests"] == 1      # 4000 samples: 23 mel frames


def test_chip_smoke_config_is_the_gate_yaml():
    """tools/gate.py's copy of the YAML, which chip_smoke.py and
    tools/measure.py run: the model's keys and the trainer's."""
    with open(REPO / "configs" / "typeA_small_N1.yaml") as f:
        cfg = yaml.safe_load(f)
    lit = gate.GATE_CONFIG
    assert chip_smoke.GATE_CONFIG is lit and chip_smoke.GATE_TRAIN is gate.GATE_TRAIN
    for key in ("frontend_conf", "specaug_conf", "encoder", "encoder_conf", "head",
                "aed_conf", "model_conf"):
        assert lit[key] == cfg[key], key
    assert lit["train"]["precision"] == cfg["train"]["precision"]
    want = {k: cfg[k] for k in ("optim", "optim_conf", "scheduler", "scheduler_conf",
                                "accum_grad")}
    want.update({k: cfg["train"][k] for k in ("max_epoch", "grad_clip", "grad_clip_type",
                                              "log_interval")})
    want["valid_interval_epoch"] = cfg["eval"]["valid_interval_epoch"]
    assert gate.GATE_TRAIN == want
    assert gate.BATCH_BINS == cfg["batch_bins"] and gate.SEED == cfg["experiment"]["seed"]


def test_gate_config_parameter_count():
    """Type A Small N=1, hybrid: the JAX count, 78,858,409 (encoder and CTC
    head 61,908,917, AED head 16,949,492)."""
    model = build_model(gate.GATE_CONFIG, gate.VOCAB, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 78_858_409
    assert sum(p.numel() for p in model.aed.parameters()) == 16_949_492
