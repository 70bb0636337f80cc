"""The port's tensor-parallel plane on the CPU against the JAX package: a
tp = 2 update of two gloo ranks from JAX's params at PRNGKey(0) against
JAX's one-device update (``tests/test_trainer.py:306``'s bounds) and the
port's one process; with AED dropout and SpecAugment on, against one
process and the one-process witness (a virtual plane: every shard in turn
in one process); the gathered checkpoint and its re-sharded resume; the
N=2 encoder's boundaries and features; decode.tp = 2 against JAX's
transcripts in the cells of ``tests/test_decode_mesh.py`` on the device
searches and the host engines; the plans, the mesh, the shard / gather round trip and the plane
composition matrix of ``tests/test_plane_composition.py``. The two ranks
run as one gloo group (``tests/torch_dist.py``), spawned once for the
file."""
import copy
import threading

import numpy as np
import pytest
import torch

import jax
from torch_dist import run_pair
from torch_parity import HYBRID_CONFIG, NARROW_VOCAB, assert_boundaries_equal, seeded_tree

from hnet_mamba_asr_torch import convert
from hnet_mamba_asr_torch.data import dataset
from hnet_mamba_asr_torch.parallel import mesh as pmesh
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_torch.tasks.decode_task import expand_cells
from hnet_mamba_asr_tpu.parallel import mesh as jmesh
from hnet_mamba_asr_tpu.parallel.mesh import make_mesh as jmake_mesh, place_params
from hnet_mamba_asr_tpu.tasks import asr_task as jtask
from hnet_mamba_asr_tpu.tasks import decode_task as jdecode
from hnet_mamba_asr_tpu.training.trainer import Trainer as JTrainer

V = NARROW_VOCAB
RTOL, ATOL = 2e-4, 2e-5             # tests/test_trainer.py:306, tp against dp in JAX
# the port's tp against its own one process: only the ranks' partial sums
# (out_proj, the RMSNorm's squares, the in_proj split) part them
TIGHT_RTOL, TIGHT_ATOL = 1e-5, 1e-6
# Adam's eps 0.1: an update near-linear in its gradient (tests/test_torch_dist.py)
TRAIN_CFG = {"max_epoch": 1, "grad_clip": 5.0, "accum_grad": 1, "log_interval": 1,
             "valid_interval_epoch": 1, "keep_nbest_models": 1, "optim": "adamw",
             "optim_conf": {"lr": 1e-2, "weight_decay": 1e-2, "eps": 1e-1}, "scheduler": None,
             "scheduler_conf": {}, "best_model_criterion": [["valid", "loss", "min"]],
             "early_stopping": {}, "async_ckpt": False}
SPECAUG = {"freq_mask_width_range": [0, 5], "num_freq_mask": 2,
           "time_mask_width_ratio_range": [0.0, 0.2], "num_time_mask": 3}
CELLS = ("ctc_greedy", "ctc_beam", "joint_beam", "rnnt_greedy", "rnnt_beam")
DC = {"beam_size": 3, "pre_beam": 4, "ctc_weight": 0.3}
ENGINES = {"device": DC, "host": dict(DC, device_beam=False)}


def _config(dropout=0.0, specaug=None, n=1):
    cfg = copy.deepcopy(HYBRID_CONFIG)
    cfg["aed_conf"]["dropout"] = dropout
    if specaug:
        cfg["specaug_conf"] = specaug
    if n > 1:
        cfg["encoder_conf"]["hnet"] = {"compression_N": n}
        cfg["model_conf"]["hnet_ratio_beta"] = 0.03
    return cfg


def _batches(seed: int = 0):
    """Two global batches of 3 real rows and a padding row."""
    rng = np.random.default_rng(seed)
    out = []
    for k, (lens, toks) in enumerate((([16000, 9100, 12000], [6, 3, 2]),
                                      ([12000, 16000, 7000], [2, 7, 3]))):
        items = [{"wave": (0.1 * rng.normal(size=n)).astype(np.float32), "n_samples": n,
                  "tokens": rng.integers(4, V, size=u).astype(np.int32),
                  "id": f"b{k}u{i}", "index": 4 * k + i}
                 for i, (n, u) in enumerate(zip(lens, toks))]
        out.append(dataset.collate_batch(items, pad_id=3, seed=7, epoch=0, batch_multiple=4))
    return out


def _decode_config():
    cfg = _config()
    cfg["rnnt_conf"] = {"d_pred": 8, "d_joint": 16, "max_decode_len": 12}
    cfg["model_conf"]["rnnt_weight"] = 0.5
    cfg["aed_conf"]["max_decode_len"] = 6
    return cfg


class _Tok:
    bos_id, eos_id, pad_id = 1, 2, 3

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


def _port_tree(cfg, seed: int) -> dict:
    """A JAX param tree of the port's seeded draw (no JAX trace to shape it)."""
    return convert.state_dict_to_jax_tree(build_model(cfg, V, seed=seed, device="cpu")
                                          .state_dict())


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The job, the two ranks' results and JAX's references, which the test
    process computes while the ranks run."""
    tmp = tmp_path_factory.mktemp("tp")
    cases = {"N1": _config(), "drop": _config(0.1, SPECAUG)}
    trees = {"N1": jax.tree_util.tree_map(np.asarray, jtask.build_model(cases["N1"], V)
                                          .init_params(jax.random.PRNGKey(0))),
             "drop": _port_tree(cases["drop"], 1)}
    job = {"update": {name: {"config": cfg, "vocab": V, "tree": trees[name],
                             "batches": _batches(), "train_cfg": TRAIN_CFG}
                      for name, cfg in cases.items()}}
    n2 = _config(n=2)
    rng = np.random.default_rng(5)
    job["encode"] = {"config": n2, "vocab": V, "tree": _port_tree(n2, 2),
        "feats": rng.normal(size=(3, 160, 80)).astype(np.float32),
        "flens": np.array([160, 121, 97], np.int32)}
    dcfg = _decode_config()
    jdm, dtree = jtask.build_model(dcfg, V), _port_tree(dcfg, 3)
    items = [{"wave": (0.1 * rng.normal(size=n)).astype(np.float32), "n_samples": n,
              "tokens": rng.integers(4, V, size=3).astype(np.int32), "id": f"d{i}", "index": i}
             for i, n in enumerate([8000, 12000, 5000, 9000])]
    cells = [c for c in expand_cells({"read_outs": ["ctc", "joint", "rnnt"],
                                      "search": ["greedy", "beam"], "lm": "none"})
             if c["name"] in CELLS]
    job["decode"] = {"config": dcfg, "vocab": V, "tree": dtree, "cells": cells,
                     "engines": ENGINES,
                     "batch": dataset.collate_batch(items, pad_id=3, seed=0, epoch=0)}
    # the ranks, JAX's update and JAX's decodes at once (XLA compiles
    # without the GIL)
    out, refs = {}, {}
    work = [lambda: out.update(ranks=run_pair("tp", job, tmp)),
            lambda: refs.update(update=_jax_update(cases["N1"], trees["N1"], tmp)),
            lambda: refs.update(decode={
                (c["name"], engine): [r["hyp"] for r in jdecode.decode_batch(
                    jdm, dtree, _Tok(), dict(job["decode"]["batch"]), c, dc)]
                for c in cells for engine, dc in ENGINES.items()})]
    threads = [threading.Thread(target=fn) for fn in work]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert set(out) == {"ranks"} and set(refs) == {"update", "decode"}, "a worker failed"
    return job, refs, out["ranks"]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_close(got, want, rtol, atol):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _jax_update(cfg, tree, tmp):
    jm = jtask.build_model(cfg, V)
    batches = _batches()
    loader = type("L", (), {"set_epoch": lambda self, e: None, "__len__": lambda self: 2,
                            "__iter__": lambda self: iter([dict(b) for b in batches])})()
    jt = JTrainer(jm, loader, TRAIN_CFG, ckpt_dir=tmp / "jax", mesh=jmake_mesh(1))
    jt.params = place_params(tree, jt.mesh)
    jt.opt_state = jt._normalize_placement(jt.tx.init(jt.params))
    jt.train()
    return jax.device_get(jt.params)


def test_tp_update_matches_jax_one_device(pair):
    """Two updates under tp = 2 (dp = 1: both ranks hold every row) from
    JAX's PRNGKey(0) params: JAX's one-device parameters within JAX's own
    tp-vs-dp bounds, the port's one process within tighter ones."""
    _, refs, results = pair
    _assert_close(results[0]["tp"]["N1"], refs["update"], RTOL, ATOL)
    _assert_close(results[0]["tp"]["N1"], results[0]["solo"]["N1"], TIGHT_RTOL, TIGHT_ATOL)
    assert results[0]["mesh"] == {"dp": 1, "tp": 2}


def test_tp_trains_what_one_process_and_the_witness_train(pair):
    """AED dropout (attention weights and the FFN's hidden columns drawn
    whole, the rank's heads / columns kept) and SpecAugment on: the tp
    ranks train to the one-process parameters, and to the witness's (one
    process computing both shards in turn)."""
    _, _, results = pair
    got = results[0]["tp"]["drop"]
    _assert_close(got, results[0]["solo"]["drop"], TIGHT_RTOL, TIGHT_ATOL)
    _assert_close(got, results[0]["witness"]["drop"], TIGHT_RTOL, TIGHT_ATOL)


@pytest.mark.parametrize("name", ["N1", "drop"])
def test_tp_ranks_shards_checkpoint_and_resume(pair, name):
    """Rank 0 alone writes; its checkpoint is the gather of the two ranks'
    shards (the JAX layout, whole); every leaf the plan does not split is
    bitwise equal on the ranks; a resume re-shards the checkpoint into the
    ranks' shards, bit for bit."""
    job, _, results = pair
    case = job["update"][name]
    plan = pmesh.tp_plan(build_model(case["config"], V, device="cpu"), 2)
    local = [{k: torch.from_numpy(v) for k, v in r["local"][name].items()} for r in results]
    for k in local[0]:
        if k not in plan:
            assert torch.equal(local[0][k], local[1][k]), k
    whole = convert.state_dict_to_jax_tree(convert.gather_state(local, plan))
    _assert_close(whole, results[0]["tp"][name], 0, 0)
    for r in results:
        for k, v in r["local"][name].items():
            np.testing.assert_array_equal(r["resumed"][name][k], v, err_msg=k)
    assert results[0]["files"] == ["epoch0000.ckpt", "latest.ckpt"]
    assert results[1]["files"] is None


def test_tp_n2_encoder_matches_one_process(pair):
    """configs' N=2 sibling at d 32 with seeded routers: boundaries equal
    (first, exactly), then the features of the valid frames."""
    job, _, results = pair
    want, n = results[0]["encode_solo"], job["encode"]["flens"]
    for r in results:
        got = r["encode"]
        assert_boundaries_equal(got["b"], want["b"], want["p"], "tp vs one process")
        for i, frames in enumerate(((n - 1) // 2 - 1) // 2):
            np.testing.assert_allclose(got["features"][i, :frames], want["features"][i, :frames],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("cell", CELLS)
def test_decode_tp_matches_jax(pair, cell, engine):
    """decode.tp = 2: both ranks decode every row and give JAX's transcripts
    (tests/test_decode_mesh.py's cells)."""
    _, refs, results = pair
    for r in results:
        assert [h for h, _ in r["decode"][(cell, engine)]] == refs["decode"][(cell, engine)]


# ---- the plans, the mesh and the validation layer --------------------------------
def test_tp_plan_splits_heads_and_keeps_b_c_whole():
    model = build_model(_config(), V, device="cpu")
    plan = pmesh.tp_plan(model, 2)
    m = model.encoder.enc.blocks[0].fwd                  # d_inner 64: 4 heads of 16
    dim, rows = plan["encoder.enc.blocks.0.fwd.in_proj.weight"]
    di, dbc, H = m.d_inner, m.d_state, m.n_heads
    assert dim == 0 and [len(r) for r in rows] == [2 * di // 2 + H // 2 + 2 * dbc] * 2
    assert rows[1][:4].tolist() == [32, 33, 34, 35]                      # z_1
    assert rows[1][-2 * dbc:].tolist() == list(range(2 * di, 2 * di + 2 * dbc))     # B | C
    assert plan["encoder.enc.blocks.0.fwd.out_proj.weight"][0] == 1
    assert plan["encoder.proj_in.weight"][0] == 0 and "encoder.proj_out.bias" not in plan
    assert plan["aed.layers.0.self_attn.q_proj.bias"][1][1].tolist() == list(range(16, 32))
    assert not any("router" in k or "ctc" in k or "norm." in k for k in plan)
    assert pmesh.ep_plan(model, 2) == {}


def test_indivisible_dims_raise_with_jax_text():
    """JAX's device_put text for a dimension the plane does not divide."""
    model = build_model(_config(), V, device="cpu")
    with pytest.raises(ValueError, match="should be divisible by 3, but it is equal to 4"):
        pmesh.tp_plan(model, 3)
    moe = build_model(dict(_config(), aed_conf=dict(_config()["aed_conf"], moe={
        "n_experts": 4, "top_k": 2})), V, device="cpu")
    with pytest.raises(ValueError, match=r"w1: .*should be divisible by 3, but it is equal to 4"):
        pmesh.ep_plan(moe, 3)
    with pytest.raises(ValueError, match=r"tp\*ep=2\*1 needs 2 ranks"):
        pmesh.make_mesh(device="cpu", tp=2)


@pytest.mark.parametrize("planes", [{"tp": 2}, {"ep": 2}, {"tp": 2, "ep": 2}])
def test_shard_gather_round_trip_a_jax_tree(planes):
    """A JAX tree through shard_state for each rank and back through
    gather_state: bit for bit, leaf for leaf."""
    cfg = _config()
    cfg["aed_conf"]["moe"] = {"n_experts": 4, "top_k": 2}
    cfg["aed_conf"]["n_heads"] = 2
    tree = jax.tree_util.tree_map(np.asarray, seeded_tree(
        jax.eval_shape(jtask.build_model(cfg, V).init_params, jax.random.PRNGKey(0)), seed=9))
    model = build_model(cfg, V, device="cpu")
    plans = {**(pmesh.tp_plan(model, 2) if "tp" in planes else {})}
    ep = pmesh.ep_plan(model, 2) if "ep" in planes else {}
    assert not set(plans) & set(ep)
    state = convert.jax_to_state_dict(tree)
    for plan in (plans, ep):
        if plan:
            shards = [convert.shard_state(tree, plan, r) for r in range(2)]
            assert any(shards[0][k].shape != state[k].shape for k in plan)
            state = convert.gather_state(shards, plan)
    _assert_close(convert.state_dict_to_jax_tree(state), tree, 0, 0)


# tests/test_plane_composition.py's matrix on the port's validate_planes:
# JAX's return values and error texts; fsdp with tp / ep / pp raises
_OK = [({}, (1, 1, 1, 1, False)), ({"tp": 2}, (2, 1, 1, 1, False)),
       ({"sp": 2}, (1, 2, 1, 1, False)), ({"pp": 2}, (1, 1, 2, 1, False)),
       ({"ep": 2}, (1, 1, 1, 2, False)), ({"fsdp": True}, (1, 1, 1, 1, True)),
       ({"tp": 2, "ep": 2}, (2, 1, 1, 2, False)), ({"tp": 2, "fsdp": True}, (2, 1, 1, 1, True)),
       ({"ep": 2, "fsdp": True}, (1, 1, 1, 2, True)),
       ({"tp": 2, "ep": 2, "fsdp": True}, (2, 1, 1, 2, True)),
       ({"sp": 2, "fsdp": True}, (1, 2, 1, 1, True)), ({"pp": 2, "fsdp": True}, (1, 1, 2, 1, True)),
       ({"tp": 2, "scan_steps": 4}, (2, 1, 1, 1, False)),
       ({"sp": 2, "accum_grad": 2}, (1, 2, 1, 1, False))]
_EXCLUDED = [({"tp": 2, "sp": 2}, "mutually exclusive"), ({"tp": 2, "pp": 2}, "mutually exclusive"),
             ({"sp": 2, "pp": 2}, "mutually exclusive"), ({"sp": 2, "ep": 2}, "mutually exclusive"),
             ({"pp": 2, "ep": 2}, "mutually exclusive"),
             ({"tp": 2, "sp": 2, "fsdp": True}, "mutually exclusive"),
             ({"sp": 2, "scan_steps": 2}, "scan_steps"), ({"pp": 2, "scan_steps": 2}, "scan_steps")]


@pytest.mark.parametrize("flat,expect", _OK, ids=["+".join(sorted(f)) or "dp" for f, _ in _OK])
def test_composable_planes_validate(flat, expect):
    assert jmesh.validate_planes(flat) == expect
    later = flat.get("fsdp") and any(flat.get(k, 1) > 1 for k in ("tp", "ep", "pp"))
    if later:
        with pytest.raises(NotImplementedError, match="is not ported"):
            pmesh.validate_planes(flat)
    else:
        assert pmesh.validate_planes(flat) == expect


@pytest.mark.parametrize("flat,msg", _EXCLUDED, ids=["+".join(sorted(f)) for f, _ in _EXCLUDED])
def test_excluded_planes_raise(flat, msg):
    with pytest.raises(ValueError, match=msg) as want:
        jmesh.validate_planes(flat)
    with pytest.raises(ValueError, match=msg) as got:
        pmesh.validate_planes(flat)
    assert str(got.value) == str(want.value)
