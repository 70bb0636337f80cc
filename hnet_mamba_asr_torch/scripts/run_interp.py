"""Interpretability over a trained checkpoint: boundaries / probes /
robustness / emergence.

    python -m hnet_mamba_asr_torch.scripts.run_interp --config <yaml> \
        --checkpoint <ckpt> --mode boundaries|probes|robustness|emergence \
        [--out-dir DIR] [--device cuda] [key=value ...]

The JAX package's ``scripts/run_interp.py`` on one card: writes
``<mode>.json`` and ``summary.json`` under
``experiments/<run>/interp/<ckpt-stem>/<split>/`` (or ``--out-dir``). The
encoder runs on ``--device`` (the card by default; without one it raises;
``--device cpu`` for the plain path), and so do the probe fits of the
'torch' backend, the port's default (the configs' ``probe.backend: jax``
names it); ``lbfgs`` fits with scipy on the host, ``sklearn`` only where
scikit-learn is installed. Each mode's JSON also records its seconds and its
encoder passes (``seconds``: the whole mode, and the passes' synchronized
seconds; ``encoder_passes``). Emergence reads every
``epoch*.ckpt`` beside ``--checkpoint`` and logs its curves to
``metrics.jsonl`` in the output directory.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from hnet_mamba_asr_torch.scripts import REPO_ROOT


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--mode", default="boundaries",
                    choices=["boundaries", "probes", "robustness", "emergence"])
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    return ap.parse_args(argv)


class EncoderPass:
    """The encoder forward a report calls on each host batch; ``passes``
    counts them and ``seconds`` sums them (host clock, each fenced by a
    device synchronize)."""

    def __init__(self, model):
        self.model = model
        self.passes = 0
        self.seconds = 0.0

    def __call__(self, batch):
        from hnet_mamba_asr_torch.tasks.decode_task import encode_batch
        enc, seconds = encode_batch(self.model, batch)
        self.passes += 1
        self.seconds += seconds
        return enc


def run(args) -> dict:
    from hnet_mamba_asr_torch.convert import load_jax_params
    from hnet_mamba_asr_torch.data.audio import load_manifest
    from hnet_mamba_asr_torch.data.dataset import ASRDataset, make_dataloader
    from hnet_mamba_asr_torch.interp import driver as drv
    from hnet_mamba_asr_torch.interp.alignments import load_alignments
    from hnet_mamba_asr_torch.interp.boundary_align import collect_boundaries
    from hnet_mamba_asr_torch.serving.runtime import require_device
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tasks.build import _resolve, build_cmvn, build_tokenizer
    from hnet_mamba_asr_torch.tasks.decode_task import load_model_params
    from hnet_mamba_asr_torch.utils.config import load_config
    from hnet_mamba_asr_torch.utils.logging_utils import get_logger, setup_logging
    from hnet_mamba_asr_torch.utils.metrics_logger import MetricsLogger

    device = require_device(args.device)
    t_start = time.perf_counter()
    cfg = load_config(args.config, args.overrides)
    ic = cfg.get("interp", {}) or {}
    name = (cfg.get("experiment", {}) or {}).get("name", Path(args.config).stem)
    ckpt = Path(args.checkpoint)
    split = ic.get("eval_split", "dev-clean")
    out_dir = (Path(args.out_dir) if args.out_dir else
               REPO_ROOT / "experiments" / name / "interp" / ckpt.stem / split)
    out_dir.mkdir(parents=True, exist_ok=True)
    setup_logging("run_interp", out_dir / "logs")
    logger = get_logger("run_interp")

    tokenizer = build_tokenizer(cfg, REPO_ROOT)
    cmvn = build_cmvn(cfg, REPO_ROOT)
    model = build_model(cfg, tokenizer.vocab_size, cmvn=cmvn, device=device)
    load_jax_params(model, load_model_params(ckpt)[0])
    encode_fn = EncoderPass(model)
    n_stages = 2 if str(cfg["encoder_conf"].get("arch_type", "A")) == "B" else 1

    mdir = _resolve((cfg.get("data", {}) or {}).get("manifests_dir", "manifests"), REPO_ROOT)
    adir = _resolve(ic.get("alignments_dir", "alignments"), REPO_ROOT)
    alignments = {r["id"]: r for r in load_alignments(adir / f"{split}.jsonl")}
    entries = [e for e in load_manifest(mdir / f"{split}.jsonl") if e["id"] in alignments]
    durations = drv.durations_from_entries(entries)
    batch_bins = int(ic.get("batch_bins", 24000))
    tol = float(ic.get("tol_s", 0.02))

    def loader_for(ds_entries, perturbation=None, seed=1):
        if perturbation is None:
            ds = ASRDataset(ds_entries, tokenizer, augment=False)
        else:
            ds = drv.PerturbedDataset(ds_entries, tokenizer, perturbation, seed=seed)
        return make_dataloader(ds, batch_bins, batch_multiple=1)[0]

    result: dict = {"mode": args.mode, "checkpoint": str(ckpt), "split": split}
    if args.mode == "boundaries":
        rep, _ = drv.boundary_report(
            encode_fn, loader_for(entries), alignments, durations, tol=tol,
            baseline_trials=int(ic.get("baseline_trials", 20)))
        result["boundaries"] = rep
    elif args.mode == "probes":
        pc = ic.get("probe", {}) or {}
        train_aligns = {r["id"]: r for r in load_alignments(
            _resolve(ic["probe_train_alignments"], REPO_ROOT))}
        train_entries = [e for e in load_manifest(_resolve(ic["probe_train_manifest"],
                                                           REPO_ROOT))
                         if e["id"] in train_aligns]
        result["probes"] = drv.probe_report(
            encode_fn, loader_for(train_entries), loader_for(entries),
            train_aligns, alignments, n_stages=n_stages,
            levels=tuple(pc.get("levels", ("frames", "chunks"))),
            top_k_words=int(pc.get("top_k_words", 500)),
            train_cap=int(pc.get("train_cap", 50000)),
            test_cap=int(pc.get("test_cap", 20000)),
            max_iter=int(pc.get("max_iter", 1000)), C=float(pc.get("C", 1.0)),
            seed=int(pc.get("seed", 1)), backend=str(pc.get("backend", "torch")),
            device=device)
    elif args.mode == "robustness":
        rc = ic.get("robustness", {}) or {}
        perts = drv.perturbations_from_config(rc)
        _, clean = drv.boundary_report(
            encode_fn, loader_for(entries), alignments, durations, tol=tol,
            baseline_trials=int(rc.get("baseline_trials", 10)))
        seed = int(rc.get("seed", 1))
        result["robustness"] = drv.robustness_report(
            perts, lambda pert: collect_boundaries(encode_fn, loader_for(entries, pert, seed)),
            clean, alignments, durations, tol=tol,
            baseline_trials=int(rc.get("baseline_trials", 10)))
    else:                                                  # emergence
        ec = ic.get("emergence", {}) or {}
        ckpts = drv.list_epoch_checkpoints(ckpt.parent)
        mlogger = MetricsLogger(out_dir, resume=True)

        def make_encode(path):
            load_jax_params(model, load_model_params(path)[0])
            return encode_fn

        try:
            result["emergence"] = drv.emergence_report(
                make_encode, ckpts, loader_for(entries), alignments, durations,
                tol=tol, baseline_trials=int(ec.get("baseline_trials", 10)),
                mlogger=mlogger)
        finally:
            mlogger.close()

    result["seconds"] = {"total": time.perf_counter() - t_start,
                         "encoder": encode_fn.seconds}
    result["encoder_passes"] = encode_fn.passes
    out_path = out_dir / f"{args.mode}.json"
    out_path.write_text(json.dumps(result, indent=2, default=str))
    summary = out_dir / "summary.json"
    existing = json.loads(summary.read_text()) if summary.exists() else {}
    existing[args.mode] = str(out_path)
    summary.write_text(json.dumps(existing, indent=2))
    logger.info("interp %s -> %s", args.mode, out_path)
    return result


if __name__ == "__main__":
    run(parse_args())
