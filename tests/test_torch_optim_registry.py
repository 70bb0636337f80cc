"""The port's optimizer and schedule registries (training/optim.py) against
the JAX package's ``build_optimizer`` / ``build_schedule`` (optax) on the
CPU: every schedule at counts around its turning points (1e-6 relative);
every optimizer over 8 updates of a small tree with ``default``,
``no_decay`` and ``router`` leaves (router_lr_mult 0.5, router_eps 1e-5),
the global-norm clip active and a warmup schedule (1e-6 absolute in fp32);
and a state saved and loaded mid-run continuing bitwise."""
import numpy as np
import pytest
import torch

import jax
import optax

from hnet_mamba_asr_torch.training import checkpoint as ckpt
from hnet_mamba_asr_torch.training import optim
from hnet_mamba_asr_tpu.training import optim as joptim

SHAPES = {"w": (3, 5), "b": (5,), "router": {"W_q": (5, 4), "W_k": (5, 4)}}
UPDATES = 8                         # radam's rho_t passes its threshold 5 at the 6th
ATOL = 1e-6
SCHEDULES = [
    ("warmuplr", {"warmup_steps": 4}, (0, 1, 3, 4, 5, 100)),
    ("noamlr", {"model_size": 256, "warmup_steps": 4}, (0, 1, 3, 4, 5, 100)),
    ("cosineannealinglr", {"T_max": 10, "eta_min": 1e-5}, (0, 1, 5, 9, 10, 11, 40)),
    ("steplr", {"step_size": 4, "gamma": 0.5}, (0, 1, 3, 4, 5, 8, 13)),
    ("exponentiallr", {"gamma": 0.9}, (0, 1, 2, 7, 30)),
    (None, {}, (0, 5))]
OPTIMIZERS = [
    ("adamw", {"weight_decay": 0.1, "betas": [0.9, 0.98]}),
    ("adam", {"weight_decay": 0.0}),
    ("adam", {"weight_decay": 0.1}),
    ("sgd", {"weight_decay": 0.1}),
    ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("adadelta", {"rho": 0.95}),
    ("adagrad", {}),
    ("rmsprop", {"alpha": 0.95}),
    ("rmsprop", {"momentum": 0.9}),
    ("radam", {"betas": [0.9, 0.999]})]


class Tiny(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(tree["w"]))
        self.b = torch.nn.Parameter(torch.tensor(tree["b"]))
        self.router = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.tensor(v)) for k, v in tree["router"].items()})

    def tree(self):
        return {"w": self.w.detach().numpy(), "b": self.b.detach().numpy(),
                "router": {k: v.detach().numpy() for k, v in self.router.items()}}


def _tree(rng, scale=1.0):
    return jax.tree_util.tree_map(lambda s: (scale * rng.normal(size=s)).astype(np.float32),
                                  SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _conf(extra):
    return dict({"lr": 1e-2, "eps": 1e-8, "router_lr_mult": 0.5, "router_eps": 1e-5}, **extra)


def _port_steps(model, opt, schedule, grads, start=0):
    named = dict(model.named_parameters())
    for count, g in enumerate(grads, start):
        for name, p in named.items():
            leaf = g["router"][name.split(".")[1]] if name.startswith("router.") else g[name]
            p.grad = torch.tensor(leaf)
        optim.clip_by_global_norm(list(named.values()), 1.0)
        optim.set_lr(opt, schedule(count))
        opt.step()


@pytest.mark.parametrize("name,conf,counts", SCHEDULES)
def test_schedule_matches_jax(name, conf, counts):
    mine, theirs = optim.build_schedule(name, 2e-3, conf), joptim.build_schedule(name, 2e-3, conf)
    for c in counts:
        np.testing.assert_allclose(mine(c), float(theirs(c)), rtol=1e-6, err_msg=f"{name} {c}")
    with pytest.raises(ValueError, match="model_size"):
        optim.build_schedule("noamlr", 1.0, {})
    with pytest.raises(ValueError, match="unknown scheduler"):
        optim.build_schedule("cyclic", 1.0, {})


@pytest.mark.parametrize("name,extra", OPTIMIZERS)
def test_optimizer_matches_optax(name, extra):
    rng = np.random.default_rng(len(name) + len(extra))
    params = _tree(rng, 0.5)
    grads = [_tree(rng, 3.0 if k % 2 else 0.05) for k in range(UPDATES)]  # half over the clip
    sched = ("warmuplr", {"warmup_steps": 3})
    tx, _, labels = joptim.build_optimizer(name, _conf(extra), *sched, params, grad_clip=1.0)
    assert set(jax.tree_util.tree_leaves(labels)) == {"default", "no_decay", "router"}
    state, p = tx.init(params), params
    for g in grads:
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
    model = Tiny(params)
    opt, schedule = optim.build_optimizer(name, _conf(extra), *sched, model)
    assert [g["label"] for g in opt.param_groups] == ["default", "no_decay", "router"]
    _port_steps(model, opt, schedule, grads)
    got = model.tree()
    for path, want in jax.tree_util.tree_leaves_with_path(p):
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, np.asarray(want), rtol=0, atol=ATOL,
                                   err_msg=f"{name} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name,extra", OPTIMIZERS[::2] + [OPTIMIZERS[9]])
def test_state_save_load_continues_bitwise(name, extra):
    rng = np.random.default_rng(7)
    params = _tree(rng, 0.5)
    grads = [_tree(rng, 3.0 if k % 2 else 0.05) for k in range(UPDATES)]
    sched = ("warmuplr", {"warmup_steps": 3})
    straight = Tiny(params)
    opt, schedule = optim.build_optimizer(name, _conf(extra), *sched, straight)
    _port_steps(straight, opt, schedule, grads)
    first = Tiny(params)
    opt1, _ = optim.build_optimizer(name, _conf(extra), *sched, first)
    _port_steps(first, opt1, schedule, grads[:4])
    saved = ckpt.optimizer_state(opt1)
    second = Tiny(jax.tree_util.tree_map(np.copy, first.tree()))
    opt2, _ = optim.build_optimizer(name, _conf(extra), *sched, second)
    ckpt.load_optimizer_state(opt2, saved)
    _port_steps(second, opt2, schedule, grads[4:], start=4)
    for (k, a), b in zip(straight.state_dict().items(), second.state_dict().values()):
        assert torch.equal(a, b), (name, k)
