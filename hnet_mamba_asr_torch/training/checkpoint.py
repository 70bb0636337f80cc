"""Checkpoints, counterpart of ``hnet_mamba_asr_tpu/training/checkpoint.py``
(its pickle backend): one atomic pickle per file (tmp, fsync,
``os.replace``), ``epoch%04d.ckpt`` and ``latest.ckpt``.

The file holds the JAX package's layout, so that its ``load_checkpoint``
reads what the port writes: ``params`` is the flax param tree as numpy
arrays (``convert.state_dict_to_jax_tree``), with ``epoch``,
``global_step``, ``metric_history``, ``config`` and ``seed``. The optimizer
state keeps torch's own form (``Optimizer.state_dict()``, tensors as numpy
arrays, so that no torch is needed to unpickle it) under ``torch_opt_state``,
with ``opt_state_format`` "torch". There is no RNG state to save: every
random draw is a function of (seed, epoch, index | step).
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np
import torch


def _to_numpy(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def optimizer_state(opt: torch.optim.Optimizer) -> dict:
    """``opt.state_dict()`` with its tensors as numpy arrays."""
    return _to_numpy(opt.state_dict())


def load_optimizer_state(opt: torch.optim.Optimizer, saved: dict) -> None:
    """Load what ``optimizer_state`` gave into ``opt`` (whose parameters set
    the device): each array back to a tensor, moments beside their
    parameters."""
    def to_tensor(obj):
        if isinstance(obj, np.ndarray):
            return torch.from_numpy(np.array(obj))
        if isinstance(obj, dict):
            return {k: to_tensor(v) for k, v in obj.items()}
        return obj
    opt.load_state_dict({"state": {k: to_tensor(v) for k, v in saved["state"].items()},
                         "param_groups": saved["param_groups"]})


def save_checkpoint(path: str | Path, state: dict) -> None:
    """Atomic write: serialize to tmp, fsync, rename."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_checkpoint(path: str | Path) -> dict:
    """Unpickle a checkpoint (only files this program wrote)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def resolve_resume(ckpt_dir: Path, resume) -> Path | None:
    """'auto' -> latest (or the newest epoch file); an explicit path that does
    not exist raises, so that a typo never starts a long run afresh."""
    if resume in (None, "", False):
        return None
    if resume == "auto":
        latest = Path(ckpt_dir) / "latest.ckpt"
        if latest.exists():
            return latest
        epochs = sorted(Path(ckpt_dir).glob("epoch*.ckpt"))
        return epochs[-1] if epochs else None
    p = Path(resume)
    if not p.exists():
        raise FileNotFoundError(f"resume checkpoint not found: {p}")
    return p
