"""The port's sequence-parallel encoder (``parallel/seq_parallel.py``, sp = 2
over two gloo ranks) on the CPU, in fp32 with the SSD's intra_dtype off:
``sp_encode`` against the JAX package's offline ``DCASREncoder`` (the
function JAX's own tests/test_seq_parallel.py holds its ``sp_encode`` to)
at Type A N = 1 bidirectional and causal, Type A N = 2 and Type B N = 4
(boundaries first and exactly, then the features on valid frames, the ratio
loss and the kept fractions), the sp loss and every gradient against the
port's offline loss, and fsdp composed with sp training. The two ranks run
as one gloo group (``tests/torch_dist.py``)."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from torch_dist import run_pair
from torch_parity import (HYBRID_CONFIG, NARROW_CONFIG, NARROW_VOCAB, assert_boundaries_equal,
                          seeded_tree)

from hnet_mamba_asr_torch.data import dataset
from hnet_mamba_asr_tpu.tasks import asr_task as jtask

V = NARROW_VOCAB
# JAX's bounds (tests/test_seq_parallel.py): features 2e-4 on valid frames,
# ratio loss and kept fraction 1e-6, loss 2e-4 relative, gradients 5e-3 of
# each leaf's largest
FEATURE_TOL, SCALAR_TOL, LOSS_RTOL, GRAD_RTOL = 2e-4, 1e-6, 2e-4, 5e-3
VARIANTS = {"A_N1": {}, "A_N1_causal": {"bidirectional": False},
            "A_N2": {"hnet": {"compression_N": 2}},
            "B_N4": {"arch_type": "B", "n_mid": 1, "hnet": {"compression_N": 4}}}


def _config(variant, base=NARROW_CONFIG):
    cfg = copy.deepcopy(base)
    cfg["encoder_conf"].update(copy.deepcopy(VARIANTS[variant]))
    return cfg


def _tree(cfg, seed=1):
    jm = jtask.build_model(cfg, V)
    return jm, seeded_tree(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=seed)


def _feats():
    """Three rows of 80-dim features at 300 frames, two of them padded."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(3, 300, 80)).astype(np.float32)
    flens = np.array([300, 229, 141], np.int32)
    for i, n in enumerate(flens):
        feats[i, n:] = 0.0
    return feats, flens


def _batch(n_items=3):
    rng = np.random.default_rng(2)
    items = [{"wave": (0.1 * rng.normal(size=n)).astype(np.float32), "n_samples": n,
              "tokens": rng.integers(4, V, size=u).astype(np.int32), "id": f"u{i}",
              "index": i} for i, (n, u) in enumerate(zip([16000, 9100, 12000], [6, 3, 4]))]
    return dataset.collate_batch(items, pad_id=3, seed=7, epoch=0, batch_multiple=4)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    feats, flens = _feats()
    job = {"encode": {}, "loss": {}}
    want = {}
    for name in VARIANTS:
        cfg = _config(name)
        jm, tree = _tree(cfg)
        enc = jax.jit(lambda p, f, n, jm=jm: jm.encoder.apply({"params": p["encoder"]}, f, n))(
            tree, jnp.asarray(feats), jnp.asarray(flens))
        want[name] = jax.tree_util.tree_map(np.asarray, enc)
        job["encode"][name] = {"config": cfg, "vocab": V, "feats": feats, "flens": flens,
                               "tree": jax.tree_util.tree_map(np.asarray, tree)}
    for name in ("A_N2", "B_N4"):
        cfg = _config(name, HYBRID_CONFIG)
        cfg["aed_conf"]["dropout"] = 0.0
        cfg["model_conf"]["hnet_ratio_beta"] = 0.03
        _, tree = _tree(cfg)
        job["loss"][name] = {"config": cfg, "vocab": V, "batch": _batch(),
                             "tree": jax.tree_util.tree_map(np.asarray, tree)}
    cfg = _config("A_N2", HYBRID_CONFIG)
    _, tree = _tree(cfg)
    job["fsdp_sp"] = {"config": cfg, "vocab": V, "batches": [_batch(), _batch()],
                      "tree": jax.tree_util.tree_map(np.asarray, tree),
                      "train_cfg": {"max_epoch": 1, "grad_clip": 5.0, "log_interval": 1,
                                    "valid_interval_epoch": 1, "optim": "adamw",
                                    "optim_conf": {"lr": 1e-3}, "scheduler": None,
                                    "fsdp": True, "fsdp_min_elems": 64, "sp": 2,
                                    "async_ckpt": False}}
    return want, run_pair("sp", job, tmp)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_sp_encode_matches_jax_offline(pair, name):
    want, results = pair
    w = want[name]
    for r in range(2):
        got = results[r]["encode"][name]
        jp, jb = w.boundaries[0]
        L = jp.shape[1]
        assert_boundaries_equal(got["b"][:, :L], jb, jp, name)
        np.testing.assert_allclose(got["p"][:, :L], jp, rtol=0, atol=FEATURE_TOL)
        n = np.asarray(w.lengths)
        for i in range(len(n)):
            np.testing.assert_allclose(got["features"][i, :n[i]], w.features[i, :n[i]],
                                       rtol=0, atol=FEATURE_TOL, err_msg=f"{name} row {i}")
        assert abs(got["ratio"] - float(w.ratio_loss)) <= SCALAR_TOL
        for k, jk in zip(got["kept"], w.kept_fractions):
            assert abs(k - float(jk)) <= SCALAR_TOL
    if name != "A_N1" and name != "A_N1_causal":
        assert 0.2 < results[0]["encode"][name]["kept"][0] < 0.8   # a real chunking


@pytest.mark.parametrize("name", ["A_N2", "B_N4"])
def test_sp_loss_and_gradients_match_offline(pair, name):
    """The hybrid loss (CTC + AED + ratio) through the sp encoder on the
    gathered features, and the rank-averaged gradient of every parameter
    (the routers' included), against the port's offline loss_fn."""
    _, results = pair
    got = results[0]["loss"][name]
    assert got["loss"] == pytest.approx(got["ref"], rel=LOSS_RTOL)
    assert abs(got["ratio"] - got["ref_ratio"]) <= SCALAR_TOL
    assert abs(got["kept"] - got["ref_kept"]) <= SCALAR_TOL
    assert got["grads"].keys() >= got["ref_grads"].keys()
    for k, ref in got["ref_grads"].items():
        scale = max(float(np.abs(ref).max()), 1e-12)
        assert float(np.abs(got["grads"][k] - ref).max()) <= GRAD_RTOL * scale, k


def test_fsdp_composes_with_sp_training(pair):
    _, results = pair
    for r in range(2):
        out = results[r]["fsdp_sp"]
        assert out["fsdp"] and len(out["loss"]) == 2 and np.isfinite(out["loss"]).all()
    a, b = (results[r]["fsdp_sp"]["tree"] for r in range(2))
    for (pa, la), (_, lb) in zip(jax.tree_util.tree_leaves_with_path(a),
                                 jax.tree_util.tree_leaves_with_path(b)):
        np.testing.assert_array_equal(la, lb, err_msg=jax.tree_util.keystr(pa))
