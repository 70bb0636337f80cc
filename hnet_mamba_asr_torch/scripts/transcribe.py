"""Ad-hoc transcription: audio files -> transcripts, no manifest required.

    python -m hnet_mamba_asr_torch.scripts.transcribe --config <yaml> \
        --checkpoint <ckpt> [--cell ctc_greedy] [--batch-size 8] \
        [--out hyps.jsonl] [--device cuda] a.wav b.flac ... [key=value overrides]

Loads a trained checkpoint, batches the given files longest first (lengths
rounded up to a 1 s grid), runs one decode cell through
``tasks/decode_task.py::decode_batch`` and prints ``<file>\\t<hyp>`` in the
order given (optionally writing a JSONL), as the JAX package's
``scripts/transcribe.py`` does. WAV and FLAC are read.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from hnet_mamba_asr_torch.scripts import REPO_ROOT

CELLS = {"ctc_greedy": ("ctc", "greedy"), "ctc_beam": ("ctc", "beam"),
         "aed_beam": ("aed", "beam"), "joint_beam": ("joint", "beam")}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--cell", default="ctc_greedy", choices=sorted(CELLS))
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--out", default=None, help="write {id, hyp} JSONL here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("paths_and_overrides", nargs="+",
                    help="audio paths; trailing key=value tokens are config overrides")
    return ap.parse_args(argv)


def run(args) -> list[dict]:
    wavs = [p for p in args.paths_and_overrides if "=" not in p]
    overrides = [p for p in args.paths_and_overrides if "=" in p]
    if not wavs:
        raise SystemExit("no WAV paths given")

    from hnet_mamba_asr_torch.convert import load_jax_params
    from hnet_mamba_asr_torch.data.audio import read_audio
    from hnet_mamba_asr_torch.serving.runtime import require_device
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tasks.build import build_cmvn, build_tokenizer
    from hnet_mamba_asr_torch.tasks.decode_task import decode_batch, load_model_params
    from hnet_mamba_asr_torch.utils.config import load_config

    device = require_device(args.device)
    cfg = load_config(args.config, overrides)
    tokenizer = build_tokenizer(cfg, REPO_ROOT)
    cmvn = build_cmvn(cfg, REPO_ROOT)
    model = build_model(cfg, tokenizer.vocab_size, cmvn=cmvn, device=device)
    params, _ = load_model_params(args.checkpoint)
    load_jax_params(model, params)

    ro, search = CELLS[args.cell]
    if ro in ("ctc", "joint") and model.ctc is None:
        raise SystemExit(f"cell {args.cell} needs a CTC head (model_conf."
                         "ctc_weight > 0)")
    if ro in ("aed", "joint") and model.aed is None:
        raise SystemExit(f"cell {args.cell} needs an AED head (model_conf."
                         "aed_weight > 0)")
    cell = {"read_out": ro, "search": search, "lm": False, "name": args.cell}
    dc = dict(cfg.get("decode", {}) or {})

    sr_expect = int((cfg.get("frontend_conf") or {}).get("sample_rate", 16000))
    utts = []
    for p in wavs:
        wave, sr = read_audio(p)
        if sr != sr_expect:
            raise SystemExit(f"{p}: sample rate {sr} != model rate "
                             f"{sr_expect}; resample first")
        utts.append((p, wave.astype(np.float32)))

    # longest-first batching + 1 s length grid -> few distinct shapes
    utts.sort(key=lambda t: -t[1].shape[0])
    records = []
    for i in range(0, len(utts), args.batch_size):
        chunk = utts[i:i + args.batch_size]
        S = max(w.shape[0] for _, w in chunk)
        S = ((S + sr_expect - 1) // sr_expect) * sr_expect     # 1 s grid
        wave = np.zeros((len(chunk), S), np.float32)
        lens = np.zeros(len(chunk), np.int32)
        for j, (_, w) in enumerate(chunk):
            wave[j, :w.shape[0]] = w
            lens[j] = w.shape[0]
        batch = {"ids": [p for p, _ in chunk], "wave": wave,
                 "wave_lens": lens, "row_mask": np.ones(len(chunk), bool),
                 # no references in ad-hoc mode: decode_batch's records
                 # read tokens/token_lens, so give empty rows
                 "tokens": np.zeros((len(chunk), 1), np.int32),
                 "token_lens": np.zeros(len(chunk), np.int32)}
        records.extend(decode_batch(model, tokenizer, batch, cell, dc))
    by_id = {r["id"]: r for r in records}
    return [by_id[p] for p in wavs]                   # original order


def main(argv=None):
    args = parse_args(argv)
    records = run(args)
    for r in records:
        print(f"{r['id']}\t{r['hyp']}")
    if args.out:
        with open(args.out, "w") as f:
            for r in records:
                f.write(json.dumps({"id": r["id"], "hyp": r["hyp"]}) + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    return records


if __name__ == "__main__":
    main()
