"""The port's expert-parallel plane on the CPU against the JAX package, in
one gloo group of 4 ranks (``tests/torch_dist.py``): the MoE FFN over
ep = 2 (every rank all rows) and over (dp, ep) = (2, 2) (rows split over
dp) against JAX's replicated module (``tests/test_moe.py:181``: the loss,
the router's and experts' gradients); (dp, tp, ep) = (1, 2, 2) and
(2, 1, 2) updates of an MoE AED model against JAX's one-device update
(``tests/test_moe.py:216``'s bounds); train.ep = 2 through
``scripts/train_lm.py`` on an MoE LM against one process; the errors of
ep without an MoE head."""
import copy
import json
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from torch_dist import run_pair
from torch_parity import HYBRID_CONFIG, NARROW_VOCAB

from hnet_mamba_asr_torch.data import dataset
from hnet_mamba_asr_torch.scripts import train, train_lm
from hnet_mamba_asr_tpu.models.moe import MoEFFN, moe_aux_from_vars
from hnet_mamba_asr_tpu.parallel.mesh import make_mesh as jmake_mesh, place_params
from hnet_mamba_asr_tpu.tasks import asr_task as jtask
from hnet_mamba_asr_tpu.training.trainer import Trainer as JTrainer

V = NARROW_VOCAB
S, D, F, E = 32, 16, 32, 4                      # tests/test_moe.py:181's module
RTOL, ATOL = 2e-4, 2e-5                         # tests/test_moe.py:216, the 3-axis update
TRAIN_CFG = {"max_epoch": 1, "grad_clip": 5.0, "accum_grad": 1, "log_interval": 1,
             "valid_interval_epoch": 1, "keep_nbest_models": 1, "optim": "adamw",
             "optim_conf": {"lr": 1e-2, "weight_decay": 1e-2, "eps": 1e-1}, "scheduler": None,
             "scheduler_conf": {}, "best_model_criterion": [["valid", "loss", "min"]],
             "early_stopping": {}, "async_ckpt": False}
MOE = {"n_experts": 4, "top_k": 2, "capacity_factor": 2.0, "aux_weight": 0.01}
LM_YAML = """
experiment: {{name: lm_ep, seed: 1}}
bpemodel: {root}/bpe.model
data: {{lm_corpus: {root}/corpus.txt, manifests_dir: {root}/manifests, dev_splits: [dev-clean]}}
lm_conf: {{d_model: 32, n_layers: 1, n_heads: 2, d_ff: 64, dropout: 0.0, lsm_weight: 0.0,
          max_line_tokens: 32, moe: {{n_experts: 4, top_k: 2, capacity_factor: 1.0}}}}
batch_tokens: 400
optim: adamw
optim_conf: {{lr: 1.0e-3, weight_decay: 1.0e-6, eps: 0.1}}
scheduler: warmuplr
scheduler_conf: {{warmup_steps: 20}}
train: {{max_epoch: 1, grad_clip: 5.0, precision: fp32, log_interval: 2}}
eval: {{valid_interval_epoch: 1}}
best_model_criterion: [[valid, loss, min]]
keep_nbest_models: 1
early_stopping: {{enable: false}}
"""


def _config():
    cfg = copy.deepcopy(HYBRID_CONFIG)
    cfg["aed_conf"] = {"n_layers": 1, "n_heads": 2, "d_ff": 32, "dropout": 0.0, "moe": MOE}
    cfg["model_conf"] = {"ctc_weight": 0.5, "aed_weight": 0.5, "lsm_weight": 0.1}
    return cfg


def _batch():
    """One global batch of 8 rows (test_moe.py:216's shape); at dp = 2 each
    dp rank holds 4 of them."""
    rng = np.random.default_rng(0)
    items = [{"wave": (0.1 * rng.normal(size=4000)).astype(np.float32), "n_samples": 4000,
              "tokens": rng.integers(4, V, size=8).astype(np.int32), "id": f"u{i}",
              "index": i} for i in range(8)]
    return dataset.collate_batch(items, pad_id=3, seed=0, epoch=0)


def _lm_workspace(root):
    from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
    rng = np.random.default_rng(2)
    lines = [" ".join(rng.choice(["ab", "cd", "ef", "gh", "ij"], size=int(rng.integers(2, 9))))
             for _ in range(96)]
    Tokenizer.train(lines, root / "bpe", vocab_size=16, hard_vocab_limit=False)
    (root / "corpus.txt").write_text("\n".join(lines) + "\n")
    (root / "manifests").mkdir()
    (root / "manifests" / "dev-clean.jsonl").write_text(
        "".join(json.dumps({"id": str(i), "text": ln}) + "\n" for i, ln in enumerate(lines[:16])))
    (root / "lm.yaml").write_text(LM_YAML.format(root=root))
    return root / "lm.yaml"


def _jax_moe(tree, x):
    m = MoEFFN(D, F, E, top_k=2, capacity_factor=2.0)

    def loss(p, xx):
        y, mvars = m.apply({"params": p}, xx, mutable=["moe"])
        aux, _ = moe_aux_from_vars(mvars, 0.01)
        return jnp.sum(y ** 2) + aux

    lval, grads = jax.value_and_grad(loss)(tree, jnp.asarray(x))
    return float(lval), jax.tree_util.tree_map(np.asarray, grads)


def _jax_update(cfg, tree, tmp):
    jm = jtask.build_model(cfg, V)
    batch = _batch()
    loader = type("L", (), {"set_epoch": lambda self, e: None, "__len__": lambda self: 1,
                            "__iter__": lambda self: iter([dict(batch)])})()
    jt = JTrainer(jm, loader, TRAIN_CFG, ckpt_dir=tmp / "jax", mesh=jmake_mesh(1))
    jt.params = place_params(tree, jt.mesh)
    jt.opt_state = jt._normalize_placement(jt.tx.init(jt.params))
    jt.train()
    return jax.device_get(jt.params)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(S, D)).astype(np.float32)
    m = MoEFFN(D, F, E, top_k=2, capacity_factor=2.0)
    moe_tree = jax.tree_util.tree_map(np.asarray, m.init(jax.random.PRNGKey(1), x)["params"])
    cfg = _config()
    tree = jax.tree_util.tree_map(np.asarray, jtask.build_model(cfg, V).init_params(
        jax.random.PRNGKey(0)))
    job = {"moe": {"tree": moe_tree, "x": x, "D": D, "F": F, "E": E},
           "update": {"config": cfg, "vocab": V, "tree": tree, "batches": [_batch()],
                      "train_cfg": TRAIN_CFG},
           "lm_yaml": _lm_workspace(tmp)}
    out, refs = {}, {}
    work = [lambda: out.update(ranks=run_pair("ep", job, tmp, world=4)),
            lambda: refs.update(update=_jax_update(cfg, tree, tmp)),
            lambda: refs.update(moe=_jax_moe(moe_tree, x))]
    threads = [threading.Thread(target=fn) for fn in work]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert set(out) == {"ranks"} and set(refs) == {"update", "moe"}, "a worker failed"
    return job, refs, out["ranks"]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", ["ep2", "dp2ep2"])
def test_ep_moe_matches_replicated_jax(world4, name):
    """Experts [r E / 2, (r + 1) E / 2) on each ep rank, the router whole:
    JAX's replicated loss (1e-5) and gradients (1e-4 / 1e-5), on every rank;
    with the rows split over dp, the capacity and slot order of the whole
    batch."""
    _, refs, results = world4
    want_loss, want = refs["moe"]
    for r in results:
        got = r["moe"][name]
        assert got["loss"] == pytest.approx(want_loss, rel=1e-5)
        for leaf in ("router", "w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(got["grads"][leaf], want[leaf], rtol=1e-4, atol=1e-5,
                                       err_msg=leaf)


@pytest.mark.parametrize("name", ["tp2ep2", "dp2ep2"])
def test_ep_update_matches_jax_one_device(world4, name):
    """One update of the MoE AED model on the (dp, tp, ep) = (1, 2, 2) and
    (2, 1, 2) meshes: JAX's one-device parameters within test_moe.py:216's
    bounds; every leaf a rank does not hold a shard of is bitwise equal on
    the 4 ranks."""
    _, refs, results = world4
    _assert_close(results[0]["update"][name], refs["update"])
    assert results[0]["mesh"][name] == ({"dp": 1, "tp": 2, "ep": 2} if name == "tp2ep2"
                                        else {"dp": 2, "ep": 2})
    split = [k for k in results[0]["local"][name] if "moe.w" in k or "moe.b" in k
             or "fwd." in k or "bwd." in k or "attn." in k or "proj_" in k]
    assert split
    for k, v in results[0]["local"][name].items():
        if k not in split:
            for r in results[1:]:
                np.testing.assert_array_equal(r["local"][name][k], v, err_msg=k)


def test_train_lm_ep_matches_one_process(world4):
    """train.ep=2 through scripts/train_lm.py over 4 ranks ((dp, ep) = (2,
    2), rows split over dp): the one-process LM's parameters."""
    _, _, results = world4
    assert results[0]["lm_mesh"] == {"dp": 2, "ep": 2}
    _assert_close(results[0]["lm_ep"], results[0]["lm_solo"])


def test_ep_without_moe_raises_jax_text(tmp_path):
    """JAX's texts (scripts/train.py:82-84, scripts/train_lm.py:61)."""
    from hnet_mamba_asr_torch.tools.smoke_2proc import prep
    prep(tmp_path)
    with pytest.raises(ValueError, match=r"train\.ep > 1 needs an MoE AED decoder "
                                         r"\(set aed_conf\.moe\.n_experts\)"):
        train.run(train.parse_args(["--config", str(tmp_path / "cfg.json"), "--exp-dir",
                                    str(tmp_path / "exp"), "--device", "cpu", "train.ep=2"]))
    (tmp_path / "lm").mkdir()
    lm = _lm_workspace(tmp_path / "lm")
    text = lm.read_text().replace(", moe: {n_experts: 4, top_k: 2, capacity_factor: 1.0}", "")
    lm.write_text(text)
    with pytest.raises(ValueError, match=r"train\.ep > 1 needs an MoE LM \(lm_conf\.moe\)"):
        train_lm.run(train_lm.parse_args(["--config", str(lm), "--exp-dir",
                                          str(tmp_path / "lm_exp"), "--device", "cpu",
                                          "train.ep=2"]))
