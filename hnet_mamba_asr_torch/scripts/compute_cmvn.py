"""Global fp64 CMVN statistics over a manifest, the log-mel on the card.

    python -m hnet_mamba_asr_torch.scripts.compute_cmvn \
        --manifest manifests/train-960.jsonl --out data/cmvn.npz [--n-mels 80] [--device cuda]

The JAX package's ``scripts/compute_cmvn.py`` over
``data/features.py::compute_cmvn``: each utterance (WAV or FLAC) through the
log-mel frontend on ``--device``, its valid frames into fp64 sums; writes
``{mean, std, count}``.
"""
from __future__ import annotations

import argparse


def run(argv=None):
    from hnet_mamba_asr_torch.data.features import compute_cmvn
    from hnet_mamba_asr_torch.serving.runtime import require_device
    from hnet_mamba_asr_torch.utils.logging_utils import get_logger, setup_logging

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-mels", type=int, default=80)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    setup_logging("compute_cmvn")
    logger = get_logger("compute_cmvn")
    cmvn = compute_cmvn(args.manifest, n_mels=args.n_mels, device=device, out=args.out)
    logger.info("mean[0:4]=%s std[0:4]=%s -> %s", cmvn.mean[:4], (1.0 / cmvn.istd)[:4],
                args.out)
    return cmvn


if __name__ == "__main__":
    run()
