"""Run provenance: one JSON record capturing what is needed to reproduce a run.

Counterpart of ``hnet_mamba_asr_tpu/utils/provenance.py``: the resolved
config and its fingerprint, git state (commit/dirty/diff digest), the
environment, the seed, the effective global-batch arithmetic, and sha256
fingerprints of data artifacts. In place of JAX's versions and devices the
environment records torch's version, CUDA's, and the card's name and power
limit (``nvidia-smi``). Every collector is defensive: a provenance failure
never crashes a run.
"""
from __future__ import annotations

import hashlib
import json
import platform
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Mapping

from hnet_mamba_asr_torch.utils.config import config_fingerprint


def _safe(fn, default=None):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - by design: never crash the run
        return {"error": f"{type(e).__name__}: {e}"} if default is None else default


def git_info(repo_root: str | Path = ".") -> dict:
    def run(*args):
        return subprocess.run(["git", "-C", str(repo_root), *args],
                              capture_output=True, text=True, timeout=10).stdout.strip()

    def collect():
        commit = run("rev-parse", "HEAD")
        status = run("status", "--porcelain")
        info: dict[str, Any] = {"commit": commit, "dirty": bool(status)}
        if status:
            diff = run("diff")
            info["diff_sha256"] = hashlib.sha256(diff.encode()).hexdigest()[:16]
            info["n_dirty_files"] = len(status.splitlines())
        return info

    return _safe(collect)


def card_info() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi`` prints it."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=30).stdout.strip().splitlines()[0]


def env_info() -> dict:
    def collect():
        import numpy as np
        import torch
        info: dict[str, Any] = {
            "python": sys.version.split()[0],
            "platform": platform.platform(),
            "hostname": platform.node(),
            "argv": sys.argv,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "numpy": np.__version__,
        }
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        info["devices"] = {"count": n,
                           "kind": torch.cuda.get_device_name(0) if n else None,
                           "platform": "gpu" if n else "cpu"}
        info["card"] = _safe(card_info) if n else None
        dist = torch.distributed
        info["process_count"] = (dist.get_world_size() if dist.is_available()
                                 and dist.is_initialized() else 1)
        return info

    return _safe(collect)


def batch_info(cfg: Mapping, n_devices: int = 1) -> dict:
    """Effective global-batch arithmetic: budget x accum x devices."""
    def collect():
        bins = int(cfg.get("batch_bins", 0))
        accum = int(cfg.get("accum_grad", 1))
        return {"batch_bins_per_device": bins, "accum_grad": accum,
                "n_devices": n_devices,
                "effective_global_frames": bins * accum * n_devices}

    return _safe(collect)


def fingerprint_file(path: str | Path) -> dict:
    def collect():
        p = Path(path)
        h = hashlib.sha256()
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return {"path": str(p), "sha256": h.hexdigest(), "bytes": p.stat().st_size}

    return _safe(collect)


def collect_provenance(cfg: Mapping, *, repo_root: str | Path = ".",
                       n_devices: int = 1, seed: int | None = None,
                       artifacts: Mapping[str, str | Path] | None = None) -> dict:
    """The full provenance record (JSON-serializable)."""
    record = {
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "config": _safe(lambda: json.loads(json.dumps(dict(cfg), default=str)), {}),
        "config_fingerprint": _safe(lambda: config_fingerprint(cfg)),
        "git": git_info(repo_root),
        "env": env_info(),
        "batch": batch_info(cfg, n_devices),
        "seed": seed,
    }
    if artifacts:
        record["artifacts"] = {name: fingerprint_file(p)
                               for name, p in artifacts.items() if p}
    return record
