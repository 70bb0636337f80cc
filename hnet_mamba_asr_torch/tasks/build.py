"""Run assembly: resolved config -> tokenizer, CMVN and manifest paths.

Counterpart of ``hnet_mamba_asr_tpu/tasks/build.py`` (``_resolve``,
``build_tokenizer``, ``build_cmvn``, ``resolve_manifests``) over the port's
``data/tokenizer.py`` and ``data/features.py``. Relative paths resolve
against ``repo_root``, for the command-line tools and the artifact loaders
``REPO_ROOT``, as the JAX scripts resolve them. The training dataloaders are
not ported here.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

from hnet_mamba_asr_torch.data.features import GlobalCMVN
from hnet_mamba_asr_torch.data.tokenizer import Tokenizer

REPO_ROOT = Path(__file__).resolve().parents[2]


def _resolve(path: str | Path, repo_root: Path) -> Path:
    p = Path(path)
    return p if p.is_absolute() else Path(repo_root) / p


def build_tokenizer(cfg: Mapping[str, Any], repo_root: str | Path) -> Tokenizer:
    bpemodel = cfg.get("bpemodel")
    if not bpemodel:
        raise ValueError("config needs a 'bpemodel' path")
    return Tokenizer(_resolve(bpemodel, Path(repo_root)))


def build_cmvn(cfg: Mapping[str, Any], repo_root: str | Path) -> GlobalCMVN | None:
    fc = cfg.get("frontend_conf", {}) or {}
    path = fc.get("cmvn")
    if not path:
        return None
    return GlobalCMVN.load(_resolve(path, Path(repo_root)))


def resolve_manifests(cfg: Mapping[str, Any], repo_root: str | Path):
    data = cfg.get("data", {}) or {}
    mdir = _resolve(data.get("manifests_dir", "manifests"), Path(repo_root))
    train = mdir / f"{data.get('train_manifest', 'train-960')}.jsonl"
    dev = {name: mdir / f"{name}.jsonl" for name in data.get("dev_splits", [])}
    return train, dev
