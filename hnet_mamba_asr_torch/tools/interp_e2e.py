"""End-to-end interpretability gate on the synthetic tone corpus, the port's
counterpart of the JAX package's ``scripts/analysis/interp_e2e.py``.

    python -m hnet_mamba_asr_torch.tools.interp_e2e --root DIR [--device cuda] \
        [--compression-N 2] [--epochs 30] [--probe-backend torch] [--out result.json]

Builds the tone-word corpus with its exact analytic forced alignments
(``data/synthetic.py::tone_alignment_records``, each checked by
``check_alignment``), trains an N >= 2 dynamic-chunking model through the
port's train CLI (``keep_all_checkpoints``; validation every epoch when
emergence is asked for), drives the run_interp CLI's modes against the final
checkpoint and gates on the results as the JAX script does:

  - probes: the word-identity probe on encoder frames reaches
    ``--word-probe-bar`` and the phone-class probe beats its majority
    baseline (tones are linearly separable, so a wired collect / fit path
    scores high and a label / feature misalignment scores at chance);
  - boundaries: the report covers every aligned utterance with finite P/R/F1
    and its random floor;
  - robustness: every configured perturbation is scored, with its
    clean-vs-perturbed consistency block;
  - emergence: one row per retained epoch checkpoint.

Every step runs on ``--device`` (the card by default; without one it raises).
Exit code 0 when the gate passes.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True, help="workspace directory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compression-N", type=int, default=2, dest="n",
                    help="boundary reports need real dynamic chunking (N>=2)")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-bins", type=int, default=1500)
    ap.add_argument("--probe-backend", default="torch", help="torch|lbfgs|sklearn")
    ap.add_argument("--modes", default="boundaries,probes,robustness,emergence")
    ap.add_argument("--word-probe-bar", type=float, default=0.9,
                    help="frames-level word_id probe accuracy gate")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    return ap.parse_args(argv)


def interp_block(root: Path, backend: str) -> dict:
    """The interp section run_interp reads (absolute paths)."""
    return {"eval_split": "dev-clean", "alignments_dir": f"{root}/alignments",
            "tol_s": 0.06,          # truth is off the 40 ms encoder grid by up to 20 ms
            "batch_bins": 8000, "baseline_trials": 20,
            "probe_train_manifest": f"{root}/manifests/probe-train.jsonl",
            "probe_train_alignments": f"{root}/alignments/probe-train.jsonl",
            "probe": {"levels": ["frames", "chunks"], "top_k_words": 4,
                      "train_cap": 5000, "test_cap": 2000, "max_iter": 300,
                      "backend": backend},
            "robustness": {"noise_snr_db": [10], "speed_factors": [1.1],
                           "silence": {"duration_s": 0.3}, "baseline_trials": 10},
            "emergence": {"baseline_trials": 10}}


def prepare(root: Path, args, valid_interval: int) -> Path:
    """The corpus, its analytic alignments (integrity-checked), tokenizer,
    CMVN and the config file (JSON, which the port's YAML reader reads) ->
    the config's path."""
    from hnet_mamba_asr_torch.data.audio import write_manifest
    from hnet_mamba_asr_torch.data.synthetic import (
        build_tone_corpus, overfit_config, tone_alignment_records)
    from hnet_mamba_asr_torch.interp.alignments import check_alignment, write_alignments
    from hnet_mamba_asr_torch.scripts import build_tokenizer, compute_cmvn

    entries = build_tone_corpus(root)
    dev, probe_train = entries[:8], entries[8:]
    write_manifest(probe_train, root / "manifests" / "probe-train.jsonl")
    records = {r["id"]: r for r in tone_alignment_records(entries)}
    for e in entries:                  # the truth must pass the aligner's checks
        issues = check_alignment(records[e["id"]], e["text"], e["frames"] / 16000.0)
        if issues:
            raise AssertionError(f"analytic alignment broken for {e['id']}: {issues}")
    write_alignments([records[e["id"]] for e in dev], root / "alignments" / "dev-clean.jsonl")
    write_alignments([records[e["id"]] for e in probe_train],
                     root / "alignments" / "probe-train.jsonl")
    cfg = overfit_config(root, compression_n=args.n, max_epoch=args.epochs,
                         valid_interval=valid_interval, batch_bins=args.batch_bins)
    cfg["interp"] = interp_block(root, args.probe_backend)
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(json.dumps(cfg, indent=1))
    build_tokenizer.run(["--manifests", str(root / "manifests" / "train-960.jsonl"),
                         "--out", str(root / "tok" / "bpe"), "--vocab-size", "12",
                         "--no-hard-limit"])
    compute_cmvn.run(["--manifest", str(root / "manifests" / "train-960.jsonl"),
                      "--out", str(root / "cmvn.npz"), "--n-mels", "20",
                      "--device", args.device])
    return cfg_path


def run(args) -> dict:
    import torch

    from hnet_mamba_asr_torch.scripts import run_interp, train
    from hnet_mamba_asr_torch.serving.runtime import require_device

    device = require_device(args.device)
    root = Path(args.root)
    root.mkdir(parents=True, exist_ok=True)
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    # epoch checkpoints exist only on validation epochs, and emergence wants
    # one row per retained checkpoint: validate every epoch for it
    valid_interval = 1 if "emergence" in modes else max(5, args.epochs // 6)
    cfg_path = prepare(root, args, valid_interval)

    t0 = time.perf_counter()
    train.run(train.parse_args(["--config", str(cfg_path), "--exp-dir", str(root / "exp"),
                                "--device", args.device, "keep_all_checkpoints=true"]))
    train_s = time.perf_counter() - t0

    ckpt = root / "exp" / "checkpoints" / "latest.ckpt"
    out_dir = root / "interp_out"
    mode_s = {}
    for mode in modes:
        t1 = time.perf_counter()
        run_interp.run(run_interp.parse_args(
            ["--config", str(cfg_path), "--checkpoint", str(ckpt), "--mode", mode,
             "--out-dir", str(out_dir), "--device", args.device]))
        mode_s[mode] = time.perf_counter() - t1

    result: dict = {"device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                               else "cpu"),
                    "compression_N": args.n, "epochs": args.epochs,
                    "probe_backend": args.probe_backend, "train_s": train_s,
                    "mode_s": mode_s, "modes": modes, "checkpoint": str(ckpt),
                    "config": str(cfg_path)}
    checks: dict[str, bool] = {}

    def finite(x) -> bool:
        return isinstance(x, (int, float)) and math.isfinite(x)

    if "boundaries" in modes:
        rep = json.loads((out_dir / "boundaries.json").read_text())
        words = rep["boundaries"]["stage0"]["words"]
        result["boundary_words"] = {k: words[k] for k in ("precision", "recall", "f1",
                                                          "r_value")}
        result["boundary_random_f1"] = words["random_baseline"]["f1"]
        checks["boundaries_finite"] = all(finite(words[k])
                                          for k in ("precision", "recall", "f1"))
        checks["boundaries_cover_all"] = not words.get("missing_alignments")
        result["boundary_f1_vs_random"] = words["f1"] - words["random_baseline"]["f1"]

    if "probes" in modes:
        rep = json.loads((out_dir / "probes.json").read_text())
        frames = rep["probes"]["frames"]
        result["probe_frames"] = {
            "word_id_accuracy": frames["word_id"]["accuracy"],
            "word_id_majority": frames["word_id"]["majority_baseline"],
            "phone_class_accuracy": frames["phone_class"]["accuracy"],
            "phone_class_majority": frames["phone_class"]["majority_baseline"],
        }
        result["probe_n_iter"] = {f"{lvl}/{task}": r["n_iter"]
                                  for lvl, block in rep["probes"].items()
                                  for task, r in block.items()}
        checks["probe_word_id"] = frames["word_id"]["accuracy"] >= args.word_probe_bar
        checks["probe_phone_class"] = (frames["phone_class"]["accuracy"]
                                       > frames["phone_class"]["majority_baseline"])
        checks["probe_chunks_present"] = any(k.startswith("chunks_s") for k in rep["probes"])

    if "robustness" in modes:
        rep = json.loads((out_dir / "robustness.json").read_text())
        blocks = rep["robustness"]
        result["robustness_perturbations"] = sorted(blocks)
        checks["robustness_all_scored"] = bool(blocks) and all(
            finite(b["stage0"]["words"]["f1"]) and finite(b["stage0"]["consistency"]["f1"])
            for b in blocks.values())
        sil = next((b for n, b in blocks.items() if "silence" in n), None)
        if sil is not None:
            win = sil["stage0"]["inserted_window"]
            result["silence_window_rate_per_s"] = win["window_rate_per_s"]
            result["silence_overall_rate_per_s"] = win["overall_rate_per_s"]

    if "emergence" in modes:
        rep = json.loads((out_dir / "emergence.json").read_text())
        rows = rep["emergence"]
        f1s = [r["boundaries"]["stage0"]["words"]["f1"] for r in rows]
        result["emergence_epochs"] = [r["epoch"] for r in rows]
        result["emergence_words_f1"] = f1s
        # one row per save epoch: epoch checkpoints exist on validation epochs
        checks["emergence_all_epochs"] = len(rows) >= max(2, args.epochs // valid_interval)
        checks["emergence_finite"] = all(finite(v) for v in f1s)

    result["checks"] = checks
    result["gate"] = all(checks.values())
    print(json.dumps(result, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    sys.exit(0 if run(parse_args())["gate"] else 1)
