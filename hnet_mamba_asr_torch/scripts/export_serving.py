"""Export a trained checkpoint as a serving artifact.

    python -m hnet_mamba_asr_torch.scripts.export_serving --config <yaml> \
        --checkpoint <ckpt> --out <dir> [--buckets 8x160000 1x160000] \
        [--emit frame_ids log_probs aed_ids beam_ids] [--quantize int8] \
        [--streaming BLOCK_ENC [--stream-batch B] [--stream-decode beam]] \
        [--device cuda] [key=value ...]

The artifact directory (manifest.json with the resolved config, params.npz
in the JAX layout, cmvn.npz) is served by
``hnet_mamba_asr_torch/serving/runtime.py::load_serving_artifact`` (or the
streaming loaders). Buckets are (batch)x(samples), the limits a call must
fit. The flags of the JAX package's ``scripts/export_serving.py`` but
``--platforms`` (the port traces no program), and ``--device``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from hnet_mamba_asr_torch.scripts import REPO_ROOT


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--buckets", nargs="+", default=["8x160000"],
                    help="(batch)x(samples) shape buckets, e.g. 8x160000")
    ap.add_argument("--emit", nargs="+", default=["frame_ids"],
                    choices=["frame_ids", "log_probs", "aed_ids", "beam_ids",
                             "rnnt_ids", "rnnt_beam_ids"])
    ap.add_argument("--beam-size", type=int, default=10,
                    help="with --emit beam_ids / rnnt_beam_ids: the beam width")
    ap.add_argument("--pre-beam", type=int, default=30,
                    help="with --emit beam_ids: per-frame candidate labels")
    ap.add_argument("--streaming", type=int, default=None, metavar="BLOCK_ENC",
                    help="export an exact-causal STREAMING artifact instead "
                         "(requires bidirectional: false); value = encoder frames per "
                         "block (16 -> 640 ms blocks)")
    ap.add_argument("--stream-batch", type=int, default=1,
                    help="with --streaming: the pool's batch (concurrent sessions a step)")
    ap.add_argument("--stream-decode", default="greedy", choices=["greedy", "beam"],
                    help="with --streaming on an RNNT model: 'beam' carries the "
                         "transducer beam (== the offline beam exactly)")
    ap.add_argument("--stream-token-buf", type=int, default=256,
                    help="with --stream-decode beam: token buffer length")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="int8 weight-only quantization (~4x smaller quantized "
                         "leaves; dequantized once at load)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    return ap.parse_args(argv)


def run(args) -> Path:
    from hnet_mamba_asr_torch.convert import load_jax_params
    from hnet_mamba_asr_torch.serving.export import (save_serving_artifact,
                                                     save_streaming_artifact)
    from hnet_mamba_asr_torch.serving.runtime import require_device
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tasks.build import build_cmvn, build_tokenizer
    from hnet_mamba_asr_torch.tasks.decode_task import load_model_params
    from hnet_mamba_asr_torch.utils.config import load_config
    from hnet_mamba_asr_torch.utils.logging_utils import get_logger, setup_logging

    buckets = []
    for spec in args.buckets if args.streaming is None else []:
        try:
            b, n = spec.lower().split("x")
            buckets.append((int(b), int(n)))
        except ValueError:
            raise SystemExit(f"bad bucket {spec!r}: expected <batch>x<samples>")

    device = require_device(args.device)
    cfg = load_config(args.config, args.overrides)
    out = Path(args.out)
    setup_logging("export_serving", out / "logs")
    logger = get_logger("export_serving")

    tokenizer = build_tokenizer(cfg, REPO_ROOT)
    cmvn = build_cmvn(cfg, REPO_ROOT)
    model = build_model(cfg, tokenizer.vocab_size, cmvn=cmvn, device=device)
    params, meta = load_model_params(args.checkpoint)
    load_jax_params(model, params)
    extra = {"config_path": str(args.config), "checkpoint": str(args.checkpoint), **meta}

    if args.streaming is not None:
        d = save_streaming_artifact(
            out, model, block_enc=args.streaming, batch=args.stream_batch,
            quantize=args.quantize, extra_meta=extra, tokenizer=tokenizer,
            stream_decode=args.stream_decode, beam_size=args.beam_size,
            token_buf_len=args.stream_token_buf, config=cfg)
        logger.info("exported STREAMING %s block_enc=%d batch=%d decode=%s "
                    "quantize=%s -> %s", Path(args.checkpoint).name,
                    args.streaming, args.stream_batch, args.stream_decode,
                    args.quantize, d)
    else:
        d = save_serving_artifact(
            out, model, buckets=buckets, emit=tuple(args.emit),
            beam_size=args.beam_size, pre_beam=args.pre_beam,
            quantize=args.quantize, extra_meta=extra, tokenizer=tokenizer, config=cfg)
        logger.info("exported %s buckets=%s emit=%s quantize=%s -> %s",
                    Path(args.checkpoint).name, buckets, args.emit,
                    args.quantize, d)
    print(d)
    return d


if __name__ == "__main__":
    run(parse_args())
