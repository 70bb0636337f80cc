"""The port's FSDP plane (``parallel/mesh.py::shard_model``, FSDP2 over two
gloo ranks) on the CPU: FSDP trains to DDP's parameters, the leaves it
shards are the leaves JAX's ``fsdp_specs`` shards and their Adam moments
are sharded with them, the checkpoint gathered to rank 0 is the JAX
package's tree and a resume re-shards it bit for bit; and
``validate_planes`` gives JAX's results and errors for every pair of
planes. The two ranks run as one gloo group (``tests/torch_dist.py``)."""
import copy
import itertools

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P
from torch_dist import run_pair
from torch_parity import HYBRID_CONFIG, NARROW_VOCAB, seeded_tree

from hnet_mamba_asr_torch.convert import state_dict_to_jax_tree
from hnet_mamba_asr_torch.data import dataset
from hnet_mamba_asr_torch.parallel import mesh as pmesh
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_tpu.parallel import mesh as jmesh
from hnet_mamba_asr_tpu.tasks import asr_task as jtask
from hnet_mamba_asr_tpu.training import checkpoint as jckpt

V = NARROW_VOCAB
MIN_ELEMS = 64                  # tests/test_fsdp.py's floor at these widths
RTOL, ATOL = 2e-4, 2e-5         # tests/test_fsdp.py:92
# Adam's eps as in tests/test_torch_dist.py: updates near-linear in the gradient
TRAIN_CFG = {"max_epoch": 1, "grad_clip": 5.0, "accum_grad": 1, "log_interval": 1,
             "valid_interval_epoch": 1, "keep_nbest_models": 1, "optim": "adamw",
             "optim_conf": {"lr": 1e-2, "weight_decay": 1e-2, "eps": 1e-1}, "scheduler": None,
             "scheduler_conf": {}, "best_model_criterion": [["valid", "loss", "min"]],
             "early_stopping": {}, "async_ckpt": False}


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for k, (lens, toks) in enumerate((([16000, 9100, 12000], [6, 3, 2]),
                                      ([12000, 16000, 7000], [2, 7, 3]))):
        items = [{"wave": (0.1 * rng.normal(size=n)).astype(np.float32), "n_samples": n,
                  "tokens": rng.integers(4, V, size=u).astype(np.int32), "id": f"b{k}u{i}",
                  "index": 4 * k + i} for i, (n, u) in enumerate(zip(lens, toks))]
        out.append(dataset.collate_batch(items, pad_id=3, seed=7, epoch=0, batch_multiple=4))
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    cfg = copy.deepcopy(HYBRID_CONFIG)
    cfg["aed_conf"]["dropout"] = 0.0
    jm = jtask.build_model(cfg, V)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, seeded_tree(shapes, seed=1))
    job = {"case": {"config": cfg, "vocab": V, "tree": tree, "batches": _batches(),
                    "train_cfg": TRAIN_CFG}, "min_elems": MIN_ELEMS}
    return shapes, tmp, run_pair("fsdp", job, tmp), cfg


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_fsdp_matches_ddp(pair):
    _, _, results, _ = pair
    got, want = _leaves(results[0]["fsdp"]), _leaves(results[0]["ddp"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    a, b = _leaves(results[1]["fsdp"]), got
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_leaves_are_jax_fsdp_specs(pair):
    """The leaves the port shards (as DTensors) are the leaves JAX's
    ``fsdp_specs`` shards over 2 devices at the same floor; the rest stay
    whole."""
    shapes, _, results, cfg = pair
    plan = results[0]["plan"]
    assert sorted(n for n, d in plan.items() if d is not None) == results[0]["sharded"]
    model = build_model(cfg, V, device="cpu")
    marks = state_dict_to_jax_tree({n: torch.full(p.shape, float(plan[n] is not None))
                                    for n, p in model.named_parameters()})
    specs = jmesh.fsdp_specs(shapes, 2, min_elems=MIN_ELEMS)
    want = {k: v != P() for k, v in _leaves_any(specs).items()}
    got = {k: bool(v.max()) for k, v in _leaves(marks).items()}
    assert got == want and any(got.values()) and not all(got.values())


def _leaves_any(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, P))}


def test_moments_are_sharded_and_memory_drops(pair):
    _, _, results, _ = pair
    r = results[0]
    assert r["moments_sharded"] == 2 * len(r["sharded"]) > 0
    assert r["bytes"]["fsdp"] < 0.75 * r["bytes"]["ddp"]


def test_gathered_checkpoint_is_jax_tree_and_resumes_bitwise(pair):
    """Rank 0 alone writes; JAX's checkpoint loader reads the file as the
    JAX model's tree, equal to the gathered parameters; a new FSDP trainer
    resumed from it holds the same weights, bit for bit, at step 2."""
    shapes, tmp, results, _ = pair
    assert results[0]["files"] == ["epoch0000.ckpt", "latest.ckpt"]
    assert results[1]["files"] is None
    state = jckpt.load_checkpoint(tmp / "fsdp_ckpt" / "latest.ckpt")
    got = _leaves(state["params"])
    assert {k: v.shape for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in _leaves_any(shapes).items()}
    want = _leaves(results[0]["fsdp"])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for r in results:
        assert r["resumed_step"] == 2
        for k, v in _leaves(r["before"]).items():
            np.testing.assert_array_equal(_leaves(r["resumed"])[k], v, err_msg=k)


PLANES = ("tp", "sp", "pp", "ep", "fsdp")


@pytest.mark.parametrize("pair_", list(itertools.combinations(PLANES, 2))
                         + [("sp", "scan_steps"), ("pp", "scan_steps"), ("tp",), ("sp",)])
def test_validate_planes_matches_jax(pair_):
    flat = {k: (True if k == "fsdp" else 2) for k in pair_}
    try:
        want = jmesh.validate_planes(flat)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmesh.validate_planes(flat)
        assert str(got.value) == str(e)
        return
    later = flat.get("fsdp") and any(flat.get(k, 1) > 1 for k in ("tp", "ep", "pp"))
    if later:
        with pytest.raises(NotImplementedError, match="is not ported"):
            pmesh.validate_planes(flat)
    else:
        assert pmesh.validate_planes(flat) == want
