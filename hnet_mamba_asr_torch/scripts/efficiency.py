"""Analytic params + GFLOPs report for a config (host only).

    python -m hnet_mamba_asr_torch.scripts.efficiency --config <yaml> \
        [--audio-seconds 10] [--kept-fractions 0.5 ...] [--vocab-size V] \
        [--out <json>] [key=value ...]

The JAX package's ``scripts/efficiency.py``: ``eval/efficiency.py``'s report,
printed as a table and optionally written as JSON. The vocabulary size is
``--vocab-size``, else the config's tokenizer's; where the tokenizer file is
not there, the size in its name (``bpe_<V>.model``, the configs' vocabulary
knob), said so on stderr.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

from hnet_mamba_asr_torch.scripts import REPO_ROOT


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--audio-seconds", type=float, default=10.0)
    ap.add_argument("--kept-fractions", type=float, nargs="*", default=None)
    ap.add_argument("--vocab-size", type=int, default=None,
                    help="default: the config's tokenizer vocab")
    ap.add_argument("--out", default=None)
    ap.add_argument("overrides", nargs="*")
    return ap.parse_args(argv)


def config_vocab_size(cfg) -> int:
    """The vocabulary of the config's tokenizer, or the size its file name
    carries where the file is not there."""
    from hnet_mamba_asr_torch.tasks.build import _resolve, build_tokenizer
    path = _resolve(cfg.get("bpemodel", ""), REPO_ROOT)
    if path.is_file():
        return build_tokenizer(cfg, REPO_ROOT).vocab_size
    found = re.search(r"bpe_(\d+)", path.name)
    if found is None:
        raise FileNotFoundError(f"tokenizer {path} not found and its name carries no "
                                "vocabulary size: pass --vocab-size")
    print(f"efficiency: {path} not found; vocabulary size {found.group(1)} from its "
          "name (--vocab-size sets it)", file=sys.stderr)
    return int(found.group(1))


def run(args) -> dict:
    from hnet_mamba_asr_torch.eval.efficiency import efficiency_report, format_efficiency
    from hnet_mamba_asr_torch.utils.config import load_config

    cfg = load_config(args.config, args.overrides)
    vocab = args.vocab_size if args.vocab_size is not None else config_vocab_size(cfg)
    report = efficiency_report(cfg, vocab, audio_seconds=args.audio_seconds,
                               kept_fractions=args.kept_fractions)
    print(format_efficiency(report))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=2, default=str))
    return report


if __name__ == "__main__":
    run(parse_args())
