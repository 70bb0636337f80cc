"""Run assembly: resolved config -> tokenizer, CMVN, manifest paths and the
training dataloaders.

Counterpart of ``hnet_mamba_asr_tpu/tasks/build.py`` over the port's
``data/`` modules. Over several ranks the train loader splits each global
batch into equal row slices (``row_shard``, rows padded to a multiple of
the rank count); dev loaders are never split, every rank scores each split
whole. Relative
paths resolve against ``repo_root``, for the command-line tools and the
artifact loaders ``REPO_ROOT``, as the JAX scripts resolve them.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Mapping

from hnet_mamba_asr_torch.data.dataset import ASRDataset, make_dataloader
from hnet_mamba_asr_torch.data.features import GlobalCMVN
from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
from hnet_mamba_asr_torch.parallel.mesh import world

REPO_ROOT = Path(__file__).resolve().parents[2]
logger = logging.getLogger(__name__)


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


def build_dataloaders(cfg, repo_root, tokenizer, *, seed: int = 0,
                      row_split: tuple[int, int] | None = None, rows_multiple: int = 1):
    """-> (train loader, its sampler, {dev split: loader}). The train loader
    speed-perturbs (``train.speed_perturb``) through ``data.perturb_cache_dir``,
    prefetches ``train.prefetch`` batches (default 2) and ships waves as
    ``data.wire_dtype``; every dev split is scored whole, unperturbed and
    unshuffled. ``row_split`` = (rank, count) of the ranks that split the
    train rows (the process group's by default; the dp axis under sp, pp,
    tp and ep); each rank's train rows and every dev batch are padded to a
    multiple of ``rows_multiple`` (the pipeline's microbatches under pp, as
    JAX pads a batch to its device count)."""
    rank, count = row_split if row_split is not None else world()
    batch_bins = int(cfg["batch_bins"])
    train_cfg = cfg.get("train", {}) or {}
    data = cfg.get("data", {}) or {}
    prefetch = int(train_cfg.get("prefetch", 2))
    wire = str(data.get("wire_dtype", "float32"))
    train_manifest, dev_manifests = resolve_manifests(cfg, repo_root)
    pcache = data.get("perturb_cache_dir")
    train_ds = ASRDataset(train_manifest, tokenizer, augment=True, seed=seed,
                          speed_perturb=train_cfg.get("speed_perturb"),
                          perturb_cache_dir=_resolve(pcache, Path(repo_root)) if pcache else None)
    train_loader, train_sampler = make_dataloader(
        train_ds, batch_bins, shuffle=True, seed=seed, num_replicas=count, rank=rank,
        batch_multiple=count * rows_multiple, row_shard=count > 1, prefetch=prefetch,
        wire_dtype=wire)
    dev_loaders = {}
    for name, mpath in dev_manifests.items():
        ds = ASRDataset(mpath, tokenizer, augment=False, seed=seed)
        dev_loaders[name], _ = make_dataloader(ds, batch_bins, shuffle=False, seed=seed,
                                               batch_multiple=rows_multiple, wire_dtype=wire)
    logger.info("dataloaders: train=%d batches (%s), dev=%s", len(train_sampler),
                train_manifest.name, {k: len(v) for k, v in dev_loaders.items()})
    return train_loader, train_sampler, dev_loaders
