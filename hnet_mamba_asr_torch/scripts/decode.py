"""Decode eval splits through the decode matrix (the 7 cells, 10 with a
transducer head).

    python -m hnet_mamba_asr_torch.scripts.decode --config <yaml> \
        --checkpoint <ckpt> [--splits test-clean test-other] [--out-dir ...] \
        [--device cuda] [key=value ...]

Writes per-utterance {id, ref, hyp, decode_s, audio_s, ...} JSONL per cell x
split (``<out-dir>/<cell>/<split>.jsonl``) plus an atomic per-run
summary.json with provenance (safe for concurrent per-split decodes), as the
JAX package's ``scripts/decode.py``. Manifests may mix WAV and FLAC.
``decode.share_encoder`` encodes each batch once for every cell; the LM
cells read ``decode.lm_config`` (YAML) and ``decode.lm_checkpoint``.

Over ranks (``torchrun --nproc_per_node N ... decode.n_devices=N``, or
``decode.mesh: true`` for every launched rank): each batch's rows are
padded to a multiple of N and split, each rank encodes and searches its
slice (a partial last batch too), and rank 0 gathers the records in row
order and writes what one process writes. ``decode.tp`` = T > 1 splits the
ASR model over a (dp, tp) mesh of the ranks (``parallel/model_parallel.py``:
Mamba-2 heads, the H-Net projections, the AED's heads and FFN; the LM stays
whole, as JAX's ``place_params`` of the model's params leaves it): the rows
split over the dp groups, the T ranks of a tp group decode the same rows,
and only rank 0 writes.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

from hnet_mamba_asr_torch.scripts import REPO_ROOT


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--splits", nargs="*", default=None,
                    help="default: config data.eval_splits or dev_splits")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("overrides", nargs="*")
    return ap.parse_args(argv)


def decode_ranks(dc: dict, device="cuda"):
    """((this rank's dp index, the dp count, tp), the mesh): the rows of each
    batch split over the dp axis of the launched process group when
    ``decode.n_devices`` > 1 (which must equal its size), ``decode.mesh``
    or ``decode.tp`` > 1 asks for it; the mesh (dp, tp) under tp, else
    None."""
    from hnet_mamba_asr_torch.parallel.mesh import make_mesh, mesh_axis, world
    tp = int(dc.get("tp") or 1)
    rank, n = world()
    want = int(dc.get("n_devices") or 0)
    if want > 1 and want != n:
        raise ValueError(f"decode.n_devices={want} needs {want} ranks (got {n}): launch "
                         f"them with torchrun --nproc_per_node {want}")
    if tp > 1:
        if n % tp:
            raise ValueError(f"decode.tp={tp} needs {tp} ranks (got {n}): launch them with "
                             f"torchrun --nproc_per_node {tp}")
        mesh = make_mesh(device=device, tp=tp)
        _, dp_rank, dp_size = mesh_axis(mesh, "dp")
        return (dp_rank, dp_size, tp), mesh
    return ((rank, n) if (want > 1 or dc.get("mesh")) else (0, 1)), None


def run(args) -> dict:
    from hnet_mamba_asr_torch.convert import load_jax_params
    from hnet_mamba_asr_torch.data.dataset import ItemLoader, manifest_items
    from hnet_mamba_asr_torch.serving.runtime import require_device
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tasks.build import _resolve, build_cmvn, build_tokenizer
    from hnet_mamba_asr_torch.tasks.decode_task import (
        audio_seconds_from_manifest, check_heads, decode_split, decode_split_shared,
        expand_cells, load_lm_scorer, load_model_params)
    from hnet_mamba_asr_torch.utils.config import load_config, load_yaml
    from hnet_mamba_asr_torch.utils.logging_utils import get_logger, setup_logging
    from hnet_mamba_asr_torch.utils.provenance import collect_provenance

    from hnet_mamba_asr_torch.parallel import mesh as pmesh

    device = require_device(args.device)
    pmesh.init_distributed(device, args.dist_backend)
    device = pmesh.rank_device(device)
    cfg = load_config(args.config, args.overrides)
    dc = cfg.get("decode", {}) or {}
    ranks, mesh = decode_ranks(dc, device)
    name = (cfg.get("experiment", {}) or {}).get("name", Path(args.config).stem)
    out_dir = Path(args.out_dir) if args.out_dir \
        else REPO_ROOT / "experiments" / name / "decode"
    setup_logging("decode", out_dir / "logs")
    logger = get_logger("decode")

    tokenizer = build_tokenizer(cfg, REPO_ROOT)
    cmvn = build_cmvn(cfg, REPO_ROOT)
    model = build_model(cfg, tokenizer.vocab_size, cmvn=cmvn, device=device)
    params, meta = load_model_params(args.checkpoint)
    load_jax_params(model, params)
    if mesh is not None:                                 # decode.tp: the ASR model only
        from hnet_mamba_asr_torch.parallel.model_parallel import place_model, plane_of
        place_model(model, plane_of(mesh, "tp", ranks[2]))
    cells = expand_cells(dc)
    check_heads(model, cells)

    lm = None
    if any(c["lm"] for c in cells):
        if not dc.get("lm_config") or not dc.get("lm_checkpoint"):
            raise ValueError("decode.lm requires decode.lm_config and decode.lm_checkpoint")
        lm_cfg = load_yaml(_resolve(dc["lm_config"], REPO_ROOT))
        lm = load_lm_scorer(
            dict(dc, lm_checkpoint=str(_resolve(dc["lm_checkpoint"], REPO_ROOT))),
            lm_cfg, tokenizer, device=device)

    data = cfg.get("data", {}) or {}
    splits = args.splits or data.get("eval_splits") or data.get("dev_splits") or []
    if not splits:
        raise ValueError("no splits: pass --splits or set data.eval_splits")
    mdir = _resolve(data.get("manifests_dir", "manifests"), REPO_ROOT)
    batch_bins = int(dc.get("batch_bins", cfg.get("batch_bins", 32000)))
    sample_rate = int((cfg.get("frontend_conf", {}) or {}).get("sample_rate", 16000))

    summaries = []
    for split in splits:
        manifest = mdir / f"{split}.jsonl"
        audio_s = audio_seconds_from_manifest(manifest)
        loader = ItemLoader(manifest_items(manifest, tokenizer, sample_rate=sample_rate),
                            batch_bins, pad_id=tokenizer.pad_id, shuffle=False,
                            wire_dtype=str(data.get("wire_dtype", "float32")),
                            batch_multiple=ranks[1])
        if bool(dc.get("share_encoder", False)):
            # one encoder pass per batch fanned out to every cell
            for s in decode_split_shared(model, tokenizer, loader, cells, dc,
                                         audio_seconds=audio_s, out_dir=out_dir,
                                         split=split, lm=lm, ranks=ranks):
                summaries.append({"split": split, **s})
        else:
            for cell in cells:
                out_path = out_dir / cell["name"] / f"{split}.jsonl"
                summaries.append({"split": split, **decode_split(
                    model, tokenizer, loader, cell, dc, audio_seconds=audio_s,
                    out_path=out_path, lm=lm, ranks=ranks)})

    summary = {"checkpoint": str(args.checkpoint), "weights_meta": meta,
               "cells": summaries,
               "provenance": collect_provenance(cfg, repo_root=REPO_ROOT,
                                                 n_devices=pmesh.world()[1])}
    if pmesh.world()[0] != 0:
        return summary                                   # rank 0 writes
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"summary.{os.getpid()}.tmp"
    tmp.write_text(json.dumps(summary, indent=2, default=str))
    os.replace(tmp, out_dir / "summary.json")           # atomic: concurrent decodes
    logger.info("decode complete: %d cell-splits -> %s", len(summaries), out_dir)
    return summary


if __name__ == "__main__":
    run(parse_args())
