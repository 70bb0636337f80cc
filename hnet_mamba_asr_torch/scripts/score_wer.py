"""Score a decode directory: WER/CER + bootstrap significance + go/no-go gate.

    python -m hnet_mamba_asr_torch.scripts.score_wer --decode-dir <dir> \
        [--config <yaml>] [--n-bootstrap 10000] [--seed 0] [key=value ...]

Writes score/{scores.json, report.txt} and per-utterance S/D/I counts under
score/<cell>/<split>.jsonl; exits with 2 when the gate is evaluated and
fails. Host code only, as the JAX package's ``scripts/score_wer.py``: it
takes no ``--device`` and runs anywhere.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--decode-dir", required=True)
    ap.add_argument("--config", default=None, help="for goal.* gate settings")
    ap.add_argument("--n-bootstrap", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gate-split", default="test-clean")
    ap.add_argument("overrides", nargs="*")
    return ap.parse_args(argv)


def run(args) -> dict:
    from hnet_mamba_asr_torch.eval.score import format_report, score_decode_dir
    from hnet_mamba_asr_torch.utils.config import load_config
    from hnet_mamba_asr_torch.utils.logging_utils import get_logger, setup_logging

    decode_dir = Path(args.decode_dir)
    setup_logging("score_wer", decode_dir / "logs")
    logger = get_logger("score_wer")
    goal_cfg, gate_cell = None, None
    if args.config:
        cfg = load_config(args.config, args.overrides)
        goal_cfg = cfg.get("goal")
        gate_cell = (cfg.get("score", {}) or {}).get("gate_cell")

    out = score_decode_dir(decode_dir, n_bootstrap=args.n_bootstrap,
                           seed=args.seed, goal_cfg=goal_cfg,
                           gate_split=args.gate_split, gate_cell=gate_cell)
    score_dir = decode_dir / "score"
    score_dir.mkdir(parents=True, exist_ok=True)
    serializable = json.loads(json.dumps(out, default=str))
    (score_dir / "scores.json").write_text(json.dumps(serializable, indent=2))
    report = format_report(out["splits"], out["gate"])
    (score_dir / "report.txt").write_text(report + "\n")
    print(report)
    gate = out["gate"]
    if gate.get("evaluated") and not gate["passed"]:
        logger.warning("GATE FAILED")
        sys.exit(2)
    return out


if __name__ == "__main__":
    run(parse_args())
