"""Optimizer and learning-rate schedule registries, counterpart of
``hnet_mamba_asr_tpu/training/optim.py`` (optax 0.2.6 there):

- schedules are plain functions of the update count with optax's
  convention: the k-th update (k = 0, 1, ...) uses ``schedule(k)``
  (``warmuplr`` and ``noamlr`` have s = k + 1; ``cosineannealinglr`` is
  ``optax.cosine_decay_schedule``, held at ``eta_min`` after ``T_max``, not
  periodic; ``steplr`` / ``exponentiallr`` step on the update count, not the
  epoch). The trainer sets the rate of every group before each update from
  the number of updates done, so there is no scheduler object to step;
- optimizers give optax's update, each in the JAX groups (``param_labels``):
  ``default`` (>= 2-D), ``no_decay`` (< 2-D: weight decay 0) and, at N > 1,
  ``router`` (the routers' W_q / W_k: the rate times ``router_lr_mult``,
  eps ``router_eps`` where given). ``adamw`` and ``adam`` are
  ``torch.optim.AdamW`` (fused on the card): JAX's ``adam`` with weight
  decay chains scale_by_adam, add_decayed_weights, scale_by_learning_rate,
  which is AdamW's decoupled decay, not ``torch.optim.Adam``'s L2; ``sgd``
  is ``torch.optim.SGD`` (momentum 0 means none, no weight decay) and
  ``adadelta`` ``torch.optim.Adadelta`` (the config's eps, default 1e-8, in
  both square roots as optax has it). ``adagrad``, ``rmsprop`` and
  ``radam`` differ from torch's classes and are written here
  (``OptaxAdagrad``: accumulator from 0.1, eps inside the root;
  ``OptaxRMSprop``: eps inside the root, momentum traced after the rate;
  ``OptaxRAdam``: threshold 5.0, rho_t in float32 as JAX computes it). Only
  ``adam`` / ``adamw`` use the config's weight decay, as in JAX;
- the global-norm clip of ``optax.clip_by_global_norm`` before the update:
  (g / ||g||) * max_norm where ||g|| >= max_norm.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping

import numpy as np
import torch

OPTIMIZERS = ("adam", "adamw", "sgd", "adadelta", "adagrad", "rmsprop", "radam")
SCHEDULERS = ("warmuplr", "noamlr", "cosineannealinglr", "steplr", "exponentiallr")


# ── schedules ─────────────────────────────────────────────────────────────────
def warmup_lr(base_lr: float, warmup_steps: float = 25000) -> Callable[[int], float]:
    """lr(count) = base_lr * w^0.5 * min(s^-0.5, s * w^-1.5), s = count + 1."""
    def schedule(count: int) -> float:
        s = count + 1.0
        return base_lr * warmup_steps ** 0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)
    return schedule


def noam_lr(model_size: int, warmup_steps: float = 25000) -> Callable[[int], float]:
    """lr(count) = model_size^-0.5 * min(s^-0.5, s * w^-1.5), s = count + 1."""
    def schedule(count: int) -> float:
        s = count + 1.0
        return model_size ** -0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)
    return schedule


def cosine_decay(base_lr: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: base_lr ((1 - alpha) c + alpha) with
    c = (1 + cos(pi min(count, T) / T)) / 2."""
    if not decay_steps > 0:
        raise ValueError(f"cosineannealinglr needs T_max > 0, got {decay_steps}")

    def schedule(count: int) -> float:
        c = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return base_lr * ((1.0 - alpha) * c + alpha)
    return schedule


def build_schedule(name: str | None, base_lr: float,
                   conf: Mapping | None = None) -> Callable[[int], float]:
    """Schedule by name; None / 'none' -> constant base_lr."""
    conf = dict(conf or {})
    if name in (None, "none", "None"):
        return lambda count: base_lr
    key = str(name).lower()
    if key == "warmuplr":
        return warmup_lr(base_lr, float(conf.get("warmup_steps", 25000)))
    if key == "noamlr":
        if "model_size" not in conf:
            raise ValueError("scheduler noamlr needs scheduler_conf.model_size")
        return noam_lr(int(conf["model_size"]), float(conf.get("warmup_steps", 25000)))
    if key == "cosineannealinglr":
        return cosine_decay(base_lr, int(conf["T_max"]),
                            float(conf.get("eta_min", 0.0)) / max(base_lr, 1e-12))
    if key == "steplr":
        step_size, gamma = int(conf["step_size"]), float(conf.get("gamma", 0.1))
        return lambda count: base_lr * gamma ** (count // step_size)
    if key == "exponentiallr":
        gamma = float(conf.get("gamma", 0.99))
        return lambda count: base_lr * gamma ** count
    raise ValueError(f"unknown scheduler {name!r}; choices: {', '.join(SCHEDULERS)}, none")


# ── optimizers torch has no match for ─────────────────────────────────────────
class _Rule(torch.optim.Optimizer):
    """A per-parameter update rule; each group's ``lr`` is set by the caller."""

    def _update(self, p, g, state, group) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, p.grad.float(), self.state[p], group)
        return None


class OptaxAdagrad(_Rule):
    """``optax.adagrad``: acc += g^2 (acc starts at 0.1); p -= lr g / sqrt(acc + eps)
    (0 where acc is 0)."""

    def __init__(self, params, lr=1e-3, eps=1e-7, initial_accumulator_value=0.1):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      initial_accumulator_value=initial_accumulator_value))

    def _update(self, p, g, state, group):
        if not state:
            state["sum"] = torch.full_like(p, group["initial_accumulator_value"],
                                           dtype=torch.float32)
        acc = state["sum"].add_(g * g)
        u = torch.where(acc > 0, g * torch.rsqrt(acc + group["eps"]), torch.zeros_like(g))
        p.add_(u.to(p.dtype), alpha=-group["lr"])


class OptaxRMSprop(_Rule):
    """``optax.rmsprop`` (not centered): nu = a nu + (1 - a) g^2 from 0;
    u = -lr g / sqrt(nu + eps); with momentum m the trace t = u + m t after
    the rate (nesterov: u + m t); p += u."""

    def __init__(self, params, lr=1e-3, alpha=0.9, eps=1e-8, momentum=0.0, nesterov=False):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum,
                                      nesterov=nesterov))

    def _update(self, p, g, state, group):
        if not state:
            state["square_avg"] = torch.zeros_like(p, dtype=torch.float32)
            if group["momentum"]:
                state["momentum_buffer"] = torch.zeros_like(p, dtype=torch.float32)
        a = group["alpha"]
        nu = state["square_avg"].mul_(a).add_(g * g, alpha=1.0 - a)
        u = g * torch.rsqrt(nu + group["eps"]) * -group["lr"]
        if group["momentum"]:
            t = state["momentum_buffer"].mul_(group["momentum"]).add_(u)
            u = u + group["momentum"] * t if group["nesterov"] else t
        p.add_(u.to(p.dtype))


class OptaxRAdam(_Rule):
    """``optax.radam``: Adam's moments; with t the update's count,
    rho_t = rho_inf - 2 t b2^t / (1 - b2^t) in float32, b2^t by squaring (as
    XLA computes it: one float32 ulp of b2^t moves rho_t by ~0.02 and r by
    ~0.5 %);
    rho_t >= 5: p -= lr r m^ / (sqrt(v^) + eps), else p -= lr m^."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, threshold=5.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, threshold=threshold))

    @staticmethod
    def _pow32(base: float, t: int) -> np.float32:
        """float32 ``base ** t`` by squaring, as XLA raises to an integer power."""
        f32 = np.float32
        out, sq = f32(1.0), f32(base)
        while t:
            if t & 1:
                out = f32(out * sq)
            sq, t = f32(sq * sq), t >> 1
        return out

    @classmethod
    def _scalars(cls, b1: float, b2: float, t: int):
        """-> (rho_t, r, 1 - b1^t, 1 - b2^t), each rounded as JAX's float32."""
        f32 = np.float32
        b2t = cls._pow32(b2, t)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = f32(ro_inf) - f32(2 * t) * b2t / (f32(1.0) - b2t)
        with np.errstate(invalid="ignore"):                 # rho_t < 4: r unused
            r = np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(ro_inf)
                        / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        return float(ro), float(r), float(f32(1.0) - cls._pow32(b1, t)), float(f32(1.0) - b2t)

    def _update(self, p, g, state, group):
        if not state:
            state["step"] = 0
            state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
        b1, b2 = group["betas"]
        state["step"] += 1
        m = state["exp_avg"].mul_(b1).add_((1.0 - b1) * g)      # optax's order of roundings
        v = state["exp_avg_sq"].mul_(b2).add_((1.0 - b2) * (g * g))
        ro, r, bc1, bc2 = self._scalars(b1, b2, state["step"])
        m_hat = m / bc1
        if ro >= group["threshold"]:
            u = r * m_hat / (torch.sqrt(v / bc2) + group["eps"])
        else:
            u = m_hat
        p.add_(u.to(p.dtype), alpha=-group["lr"])


# ── the groups and the optimizer ─────────────────────────────────────────────
def _is_router(name: str) -> bool:
    parts = name.split(".")
    return "router" in parts and any(p in ("W_q", "W_k") for p in parts)


def param_labels(named_params) -> dict[str, str]:
    """name -> 'router' (a router's W_q / W_k), 'no_decay' (fewer than 2
    dimensions: biases, norm gains, the SSM a_log / d_skip / dt_bias) or
    'default'."""
    return {n: "router" if _is_router(n) else "no_decay" if p.ndim < 2 else "default"
            for n, p in named_params}


def label_names(named_params) -> dict[str, list[str]]:
    """{group label: its parameters' names in the given order}:
    ``build_optimizer``'s groups, whose concatenation in label order is its
    parameters' index order (its state_dict's keys)."""
    labels = param_labels(named_params)
    return {label: [n for n, _ in named_params if labels[n] == label]
            for label in ("default", "no_decay", "router")}


def _make_opt(key: str, groups: list[dict], conf: dict, on_card: bool,
              per_tensor: bool = False) -> torch.optim.Optimizer:
    b1, b2 = (float(b) for b in conf.get("betas", (0.9, 0.999)))
    if key in ("adam", "adamw"):
        if per_tensor:
            return torch.optim.AdamW(groups, betas=(b1, b2), foreach=False, fused=False)
        return torch.optim.AdamW(groups, betas=(b1, b2), fused=on_card or None)
    if key == "sgd":
        momentum = float(conf.get("momentum", 0.0))
        return torch.optim.SGD(groups, lr=0.0, momentum=momentum,
                               nesterov=bool(conf.get("nesterov", False)) and momentum > 0)
    if key == "adadelta":
        return torch.optim.Adadelta(groups, rho=float(conf.get("rho", 0.9)))
    if key == "adagrad":
        return OptaxAdagrad(groups)
    if key == "rmsprop":
        return OptaxRMSprop(groups, alpha=float(conf.get("alpha", 0.99)),
                            momentum=float(conf.get("momentum", 0.0)))
    if key == "radam":
        return OptaxRAdam(groups, betas=(b1, b2))
    raise ValueError(f"unknown optimizer {key!r}; choices: {', '.join(OPTIMIZERS)}")


def build_optimizer(name: str, conf: Mapping | None, schedule_name: str | None,
                    schedule_conf: Mapping | None,
                    model: torch.nn.Module) -> tuple[torch.optim.Optimizer, Callable]:
    """(optimizer, schedule). The optimizer's groups are [default,
    no_decay] and, when the model has router parameters, router; each
    carries its label's eps and ``lr_mult`` and, for adam / adamw, its weight
    decay. Their ``lr`` is set by the caller (``set_lr``) from ``schedule``
    before each update."""
    conf = dict(conf or {})
    key = str(name).lower()
    if key not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; choices: {', '.join(OPTIMIZERS)}")
    router_mult = float(conf.pop("router_lr_mult", 1.0))
    router_eps = conf.pop("router_eps", None)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    base_lr = float(conf.get("lr", 1e-3))
    eps = float(conf.get("eps", 1e-8))
    wd = float(conf.get("weight_decay", 0.0)) if key in ("adam", "adamw") else 0.0
    by_label, params = label_names(named), dict(named)
    groups = [{"label": "default", "weight_decay": wd, "eps": eps, "lr_mult": 1.0},
              {"label": "no_decay", "weight_decay": 0.0, "eps": eps, "lr_mult": 1.0},
              {"label": "router", "weight_decay": wd,
               "eps": eps if router_eps is None else float(router_eps),
               "lr_mult": router_mult}]
    for g in groups:
        g["params"] = [params[n] for n in by_label[g["label"]]]
        g["lr"] = base_lr * g["lr_mult"]
        if key == "sgd":
            del g["eps"]
    groups = [g for g in groups if g["params"] or g["label"] != "router"]
    # FSDP's shards (DTensors) beside whole tensors: a foreach or fused step
    # cannot mix the two, so the step goes tensor by tensor
    sharded = [type(p).__name__ == "DTensor" for _, p in named]
    opt = _make_opt(key, groups, conf, all(p.is_cuda for _, p in named),
                    per_tensor=any(sharded))
    return opt, build_schedule(schedule_name, base_lr, schedule_conf)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """Each group's rate: ``lr`` times the group's ``lr_mult``."""
    for group in opt.param_groups:
        group["lr"] = lr * group.get("lr_mult", 1.0)


def clip_by_global_norm(params, max_norm: float, split=(), leaf_norms=None) -> torch.Tensor:
    """Scale the gradients in place as ``optax.clip_by_global_norm`` does and
    return their global L2 norm before the clip (fp32, on the device). FSDP's
    sharded gradients (DTensors) count each shard once: their local squares
    are summed over the ranks of their mesh. ``split``: the (parameter,
    plane, dim, share) of each leaf a tp / ep rank holds a shard of
    (``parallel/model_parallel.py::split_leaves``): its squares, each row
    weighted by the share of the plane's ranks that hold it, are summed over
    the plane's group, so that every element counts once and every rank
    takes the same clip scale. ``leaf_norms``: every leaf's norm of the
    whole model in one process's order (a pp rank's,
    ``parallel/pipeline.py::PPModel.leaf_norms``), whose norm is the
    global one."""
    grads = [p.grad for p in params if p.grad is not None]
    shards = [g for g in grads if type(g).__name__ == "DTensor"]
    if leaf_norms is not None:
        norm = torch.linalg.vector_norm(leaf_norms)
    elif split:
        owned, planes = set(), {}
        for p, plane, dim, share in split:
            if p.grad is None:
                continue
            owned.add(id(p.grad))
            shape = [1] * p.grad.dim()
            shape[dim] = -1
            sq = (p.grad.float().square() * share.to(p.grad.device).view(shape)).sum()
            planes.setdefault(plane.name, (plane.group, []))[1].append(sq)
        sq = torch.zeros((), device=grads[0].device)
        whole = [g for g in grads if id(g) not in owned]
        if whole:
            sq = torch.stack([torch.linalg.vector_norm(g.float()) ** 2 for g in whole]).sum()
        for group, parts in planes.values():
            part = torch.stack(parts).sum()
            torch.distributed.all_reduce(part, group=group)
            sq = sq + part
        norm = torch.sqrt(sq)
    elif shards:
        whole = [g for g in grads if type(g).__name__ != "DTensor"]
        locals_ = [g.to_local() for g in shards]
        sq = torch.stack([torch.linalg.vector_norm(t.float()) ** 2 for t in locals_]).sum()
        torch.distributed.all_reduce(sq, group=shards[0].device_mesh.get_group())
        if whole:
            sq = sq + torch.stack([torch.linalg.vector_norm(g.float()) ** 2
                                   for g in whole]).sum()
        norm = torch.sqrt(sq)
        grads = locals_ + whole
    else:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    if max_norm and max_norm > 0:
        # optax's (g / ||g||) * max_norm where ||g|| >= max_norm, without a host read
        clip = norm >= max_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(clip, norm, one))
        torch._foreach_mul_(grads, torch.where(clip, one * max_norm, one))
    return norm
