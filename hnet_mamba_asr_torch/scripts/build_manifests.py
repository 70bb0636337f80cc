"""Build JSONL manifests from a LibriSpeech-layout corpus (WAV or FLAC).

    python -m hnet_mamba_asr_torch.scripts.build_manifests --root /data/LibriSpeech \
        --out-dir manifests [--splits dev-clean dev-other ...] [--train-960]

Host code: the JAX package's ``scripts/build_manifests.py`` over
``data/manifests.py::build_manifest``.
"""
from __future__ import annotations

import argparse
from pathlib import Path


def run(argv=None) -> None:
    from hnet_mamba_asr_torch.data.manifests import TRAIN_960, build_manifest

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--out-dir", default="manifests")
    ap.add_argument("--splits", nargs="*",
                    default=["dev-clean", "dev-other", "test-clean", "test-other"])
    ap.add_argument("--train-960", action="store_true",
                    help="also build the combined train-960 manifest")
    args = ap.parse_args(argv)
    out_dir = Path(args.out_dir)
    for split in args.splits:
        build_manifest(args.root, [split], out_dir / f"{split}.jsonl")
    if args.train_960:
        build_manifest(args.root, TRAIN_960, out_dir / "train-960.jsonl")


if __name__ == "__main__":
    run()
