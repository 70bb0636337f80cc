"""RNN-T beam search, the host engine (exact merge by label sequence),
counterpart of ``hnet_mamba_asr_tpu/decoders/rnnt_decode.py``.

A Graves-style time-synchronous beam over the transducer lattice: a
hypothesis is a label sequence whose score is the log-sum over every
alignment of it to the frames consumed so far (alignments that emit the same
labels at different frames merge by logaddexp). Per frame, hypotheses grow
by up to ``max_symbols`` labels before the blank that consumes the frame;
the beam keeps the top ``beam_size`` sequences. Scores accumulate in
float64 on the host; each expansion round is one batched joint evaluation
on the model's device (``RNNTHead.step_logprobs`` under inference mode, in
place of JAX's jitted apply).

First-pass LM shallow fusion (``lm`` / ``lm_weight``): each label emission
adds ``lm_weight * logP_LM(label | labels so far)`` to the selection score.
The LM term depends only on the label sequence, so alignment merges are
exact: the acoustic log-sum and the raw LM log-prob are carried apart and
combined only for pruning and ranking; blank adds no LM term.
"""
from __future__ import annotations

import numpy as np
import torch

from hnet_mamba_asr_torch.decoders.joint import Hypothesis


def rnnt_beam_search(head, memory, memory_lengths, *, beam_size: int = 8,
                     max_symbols: int | None = None, nbest: int | None = None, lm=None,
                     lm_weight: float = 0.0):
    """memory [B, T, d_memory] (on the head's device), memory_lengths [B] ->
    one id list per row.

    ``max_symbols`` caps label emissions per frame (default: the head's).
    ``nbest``: return the top-n surviving beam per utterance as Hypothesis
    lists instead (aed = acoustic transducer log-prob, ctc = 0, score = the
    fused selection score), the pool ``lm_rescore_batch`` re-ranks for the
    rnnt_beam_lm cell. ``lm``: a ``CausalLMScorer`` for first-pass fusion;
    each expansion round scores the frontier sequences in one batched
    ``next_logprobs`` call. A prefix's log-probs do not depend on the rest
    of the call (``decoders/lm_scorer.py``), so each prefix is scored once
    per utterance and kept (the frontier of one frame is mostly the last
    frame's)."""
    max_symbols = int(max_symbols if max_symbols is not None else head.max_symbols)
    with torch.inference_mode():
        enc_f = head.encode_features(memory)                         # [B, T, J]
    dev = enc_f.device
    lens = np.asarray(torch.as_tensor(memory_lengths).cpu())
    C, bos, blank = head.context, int(head.bos_id), int(head.blank_id)
    fuse = lm is not None and lm_weight != 0.0
    w = float(lm_weight)
    out = []

    def rank(kv):
        return -(kv[1][0] + w * kv[1][1]) if fuse else -kv[1][0]

    for b in range(memory.shape[0]):
        # hyp: tuple(labels) -> (acoustic log-sum over alignments waiting at
        # frame t, raw LM log-prob of the labels)
        hyps: dict[tuple, tuple[float, float]] = {(): (0.0, 0.0)}
        lm_memo: dict[tuple, np.ndarray] = {}          # prefix -> next-token log-probs
        for t in range(int(lens[b])):
            enc_t = enc_f[b, t]
            # round 0 scores every surviving hyp once; each round may extend
            # by one label; blanks bank into nxt
            nxt: dict[tuple, tuple[float, float]] = {}
            cur = hyps
            for round_ in range(max_symbols + 1):
                seqs = list(cur.keys())
                R = max(beam_size, len(seqs))            # fixed rows
                hist = np.full((R, C), bos, np.int64)
                for i, y in enumerate(seqs):
                    for j in range(min(C, len(y))):
                        hist[i, j] = y[-1 - j]
                with torch.inference_mode():
                    lp = head.step_logprobs(enc_t[None].expand(R, -1),
                                            torch.from_numpy(hist).to(dev))
                lp = lp.cpu().numpy().astype(np.float64)             # [R, V+1]
                # blank: the alignment consumes frame t -> merge into nxt
                for i, y in enumerate(seqs):
                    ac, lms = cur[y]
                    s = ac + lp[i, blank]
                    if y in nxt:
                        s = np.logaddexp(nxt[y][0], s)
                    nxt[y] = (s, lms)
                if round_ == max_symbols:
                    break
                # label expansions: two parents never give the same child in
                # one round, so the frontier is every (parent, label) pair;
                # keep the beam_size best by the rank key, ties in (parent,
                # label) order, as a stable sort of JAX's dict would
                V = head.vocab_size
                ac = np.array([cur[y][0] for y in seqs])[:, None]
                lms = np.array([cur[y][1] for y in seqs])[:, None]
                cand = ac + lp[:len(seqs), :V]
                if fuse:
                    new = [y for y in seqs if y not in lm_memo]
                    if new:
                        for y, row in zip(new, lm.next_logprobs([list(y) for y in new])):
                            lm_memo[y] = np.asarray(row, np.float64)[:V]
                    clm = lms + np.stack([lm_memo[y] for y in seqs])
                    key = -(cand + w * clm)
                else:
                    clm = np.zeros_like(cand)
                    key = -cand
                top = np.argsort(key.ravel(), kind="stable")[:beam_size]
                cur = {seqs[i // V] + (i % V,): (float(cand.flat[i]), float(clm.flat[i]))
                       for i in top.tolist()}
            hyps = dict(sorted(nxt.items(), key=rank)[:beam_size])
        if nbest is not None:
            # .lm stays None: lm_rescore_batch fills it with the whole
            # sequence_logprob (eos included)
            ranked = sorted(hyps.items(), key=rank)[:nbest]
            out.append([Hypothesis(tokens=list(y), aed=float(ac), ctc=0.0,
                                   score=float(ac + w * lms)) for y, (ac, lms) in ranked])
        else:
            best = min(hyps.items(), key=rank)[0] if hyps else ()
            out.append(list(best))
    return out
