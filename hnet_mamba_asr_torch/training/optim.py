"""Optimizer and learning-rate schedule, counterpart of
``hnet_mamba_asr_tpu/training/optim.py`` for what the gate config uses:

- schedules with optax's count convention: the k-th update (k = 0, 1, ...)
  uses ``schedule(k)``; ``warmuplr`` has s = count + 1. The trainer sets the
  rate of every group before each update from the number of updates done,
  so there is no scheduler object to step (``LambdaLR``'s first factor is
  taken at construction, one step apart from a step-after-update loop);
- AdamW (``torch.optim.AdamW``; fused on the card) in the JAX groups
  (``param_labels``): ``default`` (>= 2-D, with weight decay), ``no_decay``
  (< 2-D) and, at N > 1, ``router`` (the routers' W_q / W_k: the default
  weight decay, the rate times ``router_lr_mult`` and eps ``router_eps``
  where given, the damped group that keeps the N = 2 router from
  diverging); its decoupled decay p (1 - lr wd) - lr m^/(sqrt(v^) + eps)
  is optax.adamw's update;
- the global-norm clip of ``optax.clip_by_global_norm`` before the update:
  g * max_norm / ||g|| where ||g|| >= max_norm.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch


def warmup_lr(base_lr: float, warmup_steps: float = 25000) -> Callable[[int], float]:
    """lr(count) = base_lr * w^0.5 * min(s^-0.5, s * w^-1.5), s = count + 1."""
    def schedule(count: int) -> float:
        s = count + 1.0
        return base_lr * warmup_steps ** 0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)
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
    raise NotImplementedError(f"scheduler {name!r} is not ported; choices: warmuplr, none")


def _is_router(name: str) -> bool:
    parts = name.split(".")
    return "router" in parts and any(p in ("W_q", "W_k") for p in parts)


def param_labels(named_params) -> dict[str, str]:
    """name -> 'router' (a router's W_q / W_k), 'no_decay' (fewer than 2
    dimensions: biases, norm gains, the SSM a_log / d_skip / dt_bias) or
    'default'."""
    return {n: "router" if _is_router(n) else "no_decay" if p.ndim < 2 else "default"
            for n, p in named_params}


def build_optimizer(name: str, conf: Mapping | None, schedule_name: str | None,
                    schedule_conf: Mapping | None,
                    model: torch.nn.Module) -> tuple[torch.optim.Optimizer, Callable]:
    """(optimizer, schedule). The optimizer's groups are [default,
    no_decay] and, when the model has router parameters, router; each
    carries its label's weight decay, eps and ``lr_mult``. Their ``lr`` is
    set by the caller (``set_lr``) from ``schedule`` before each update."""
    conf = dict(conf or {})
    if str(name).lower() != "adamw":
        raise NotImplementedError(f"optimizer {name!r} is not ported; choices: adamw")
    router_mult = float(conf.pop("router_lr_mult", 1.0))
    router_eps = conf.pop("router_eps", None)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    base_lr = float(conf.get("lr", 1e-3))
    b1, b2 = conf.get("betas", (0.9, 0.999))
    eps, wd = float(conf.get("eps", 1e-8)), float(conf.get("weight_decay", 0.0))
    labels = param_labels(named)
    groups = [{"label": "default", "weight_decay": wd, "eps": eps, "lr_mult": 1.0},
              {"label": "no_decay", "weight_decay": 0.0, "eps": eps, "lr_mult": 1.0},
              {"label": "router", "weight_decay": wd,
               "eps": eps if router_eps is None else float(router_eps),
               "lr_mult": router_mult}]
    for g in groups:
        g["params"] = [p for n, p in named if labels[n] == g["label"]]
    groups = [g for g in groups if g["params"] or g["label"] != "router"]
    on_card = all(p.is_cuda for _, p in named)
    opt = torch.optim.AdamW(groups, lr=base_lr, betas=(float(b1), float(b2)),
                            fused=on_card or None)
    return opt, build_schedule(schedule_name, base_lr, schedule_conf)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """Each group's rate: ``lr`` times the group's ``lr_mult``."""
    for group in opt.param_groups:
        group["lr"] = lr * group.get("lr_mult", 1.0)


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place as ``optax.clip_by_global_norm`` does and
    return their global L2 norm before the clip (fp32, on the device)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    if max_norm and max_norm > 0:
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, scale)
    return norm
