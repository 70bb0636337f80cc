"""Train the BPE tokenizer on manifest transcripts, with a round-trip check.

    python -m hnet_mamba_asr_torch.scripts.build_tokenizer \
        --manifests manifests/train-960.jsonl --out data/bpe500 [--vocab-size 500]

Host code: the JAX package's ``scripts/build_tokenizer.py`` over the port's
``data/tokenizer.py`` (writes ``<out>.model`` and ``<out>.vocab``). Exits
non-zero when decode(encode(text)) differs from the text's words on any of
the first 2000 transcripts.
"""
from __future__ import annotations

import argparse
import json


def run(argv=None):
    from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
    from hnet_mamba_asr_torch.utils.logging_utils import get_logger, setup_logging

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--manifests", nargs="+", required=True)
    ap.add_argument("--out", required=True, help="model prefix (writes .model / .vocab)")
    ap.add_argument("--vocab-size", type=int, default=500)
    ap.add_argument("--no-hard-limit", action="store_true")
    args = ap.parse_args(argv)
    setup_logging("build_tokenizer")
    logger = get_logger("build_tokenizer")

    lines = []
    for m in args.manifests:
        with open(m) as f:
            lines.extend(json.loads(ln)["text"] for ln in f if ln.strip())
    tok = Tokenizer.train(lines, args.out, vocab_size=args.vocab_size,
                          hard_vocab_limit=not args.no_hard_limit)
    bad = sum(tok.decode(tok.encode(text)) != " ".join(text.split()) for text in lines[:2000])
    if bad:
        raise SystemExit(f"round-trip failed on {bad}/{min(2000, len(lines))} transcripts")
    logger.info("tokenizer OK: vocab=%d, round-trip clean on %d samples",
                tok.vocab_size, min(2000, len(lines)))
    return tok


if __name__ == "__main__":
    run()
