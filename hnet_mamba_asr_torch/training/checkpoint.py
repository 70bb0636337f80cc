"""Checkpoints, counterpart of ``hnet_mamba_asr_tpu/training/checkpoint.py``
(its pickle backend): one atomic pickle per file (tmp, fsync,
``os.replace``), ``epoch%04d.ckpt`` and ``latest.ckpt``; the N-best tools
``remove_checkpoint``, ``average_checkpoints`` (the fp32 mean of
``params``, saved as ``{"params", "averaged"}``, which JAX's
``load_checkpoint`` and the port's ``tasks/decode_task.py::load_model_params``
read) and ``update_best_symlink`` (``<phase>.<metric>.best.ckpt`` ->
``epoch%04d.ckpt``).

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
import shutil
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


def optimizer_state(opt) -> dict:
    """``opt.state_dict()`` (or a state dict given as such) with its tensors
    as numpy arrays."""
    return _to_numpy(opt.state_dict() if isinstance(opt, torch.optim.Optimizer) else opt)


def load_optimizer_state(opt: torch.optim.Optimizer, saved: dict, place=None) -> None:
    """Load what ``optimizer_state`` gave into ``opt`` (whose parameters set
    the device): each array back to a tensor, moments beside their
    parameters; ``place(index, tensor)`` places a tensor of the parameter
    of that index (a shard of it, under FSDP)."""
    def to_tensor(obj):
        if isinstance(obj, np.ndarray):
            return torch.from_numpy(np.array(obj))
        if isinstance(obj, dict):
            return {k: to_tensor(v) for k, v in obj.items()}
        return obj
    state = {k: to_tensor(v) for k, v in saved["state"].items()}
    if place is not None:
        state = {k: {n: place(int(k), t) if torch.is_tensor(t) else t for n, t in v.items()}
                 for k, v in state.items()}
    opt.load_state_dict({"state": state, "param_groups": saved["param_groups"]})


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


def remove_checkpoint(path: str | Path) -> None:
    """Delete a checkpoint file (a directory only if it is no symlink)."""
    path = Path(path)
    if path.is_dir() and not path.is_symlink():
        shutil.rmtree(path, ignore_errors=True)
    else:
        path.unlink(missing_ok=True)


def average_checkpoints(paths) -> dict:
    """fp32 mean of several checkpoints' ``params`` -> {"params", "averaged"}."""
    if not paths:
        raise ValueError("no checkpoints to average")
    acc = None
    for p in paths:
        params = load_checkpoint(p)["params"]
        as32 = _tree_map(lambda x: np.asarray(x, np.float32), params)
        acc = as32 if acc is None else _tree_map(np.add, acc, as32)
    return {"params": _tree_map(lambda x: x / len(paths), acc),
            "averaged": [str(p) for p in paths]}


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def update_best_symlink(ckpt_dir: Path, phase: str, metric: str, epoch: int) -> None:
    link = Path(ckpt_dir) / f"{phase}.{metric}.best.ckpt"
    if link.exists() or link.is_symlink():
        link.unlink()
    link.symlink_to(f"epoch{epoch:04d}.ckpt")


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
