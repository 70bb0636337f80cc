"""CTC prefix beam search (Hannun et al.) with optional first-pass LM
fusion, counterpart of ``hnet_mamba_asr_tpu/decoders/ctc_decode.py`` (the
port keeps its own copy; host numpy in float64).

Utterances advance in lockstep over frames, so at each frame every live
prefix of the batch fuses in ONE ``next_logprobs`` call. Per prefix the
state is (log p ending in blank, log p ending in non-blank, accumulated LM
score); extending by a new label adds ``lm_weight * logP_LM(token |
prefix)``. Summing over alignments finds the most probable label sequence
rather than the best path. LM fusion requires the blank at the last class
(the port's ``CTCHead.blank_id == vocab_size``).
"""
from __future__ import annotations

import numpy as np


def _advance_beam(beam: dict, frame: np.ndarray, blank_id: int, pre_beam: int,
                  beam_size: int, lm_weight: float, lm_rows, row_of) -> dict:
    """One frame of the prefix-beam recursion for one utterance."""
    order = np.argsort(frame)[::-1]
    cands = [int(c) for c in order if int(c) != blank_id][:pre_beam]
    nxt: dict[tuple, tuple] = {}
    for prefix, (pb, pnb, lms) in beam.items():
        p_tot = np.logaddexp(pb, pnb)
        # stay on this prefix via blank
        e = nxt.get(prefix, (-np.inf, -np.inf, lms))
        nxt[prefix] = (np.logaddexp(e[0], p_tot + frame[blank_id]), e[1], lms)
        # stay via repeating the last label (ends non-blank)
        if prefix:
            e = nxt[prefix]
            nxt[prefix] = (e[0], np.logaddexp(e[1], pnb + frame[prefix[-1]]), lms)
        # grow by a candidate label
        for c in cands:
            grown = prefix + (c,)
            # repeated label must cross a blank: only blank-ending mass extends
            base = pb if (prefix and c == prefix[-1]) else p_tot
            lm_grown = lms + (lm_weight * float(lm_rows[row_of[prefix], c])
                              if lm_rows is not None else 0.0)
            e = nxt.get(grown, (-np.inf, -np.inf, lm_grown))
            nxt[grown] = (e[0], np.logaddexp(e[1], base + frame[c]), lm_grown)
    ranked = sorted(nxt.items(),
                    key=lambda kv: np.logaddexp(kv[1][0], kv[1][1]) + kv[1][2],
                    reverse=True)
    return dict(ranked[:beam_size])


def ctc_prefix_beam_search(log_probs, lengths, *, blank_id: int, beam_size: int = 10,
                           pre_beam: int = 30, lm=None, lm_weight: float = 0.0
                           ) -> list[list[int]]:
    """log_probs [B, T, V+1] (device array or numpy), lengths [B] ->
    one bare-id list per utterance.

    ``lm`` is any object with ``next_logprobs(prefixes) -> [n, V]`` (e.g.
    decoders.lm_scorer.CausalLMScorer).
    """
    lp_all = np.asarray(log_probs, dtype=np.float64)
    lens = np.asarray(lengths)
    B = lp_all.shape[0]
    use_lm = lm is not None and lm_weight != 0.0
    if use_lm and blank_id != lp_all.shape[-1] - 1:
        raise ValueError("LM fusion requires blank at the last class "
                         "(LM scores cover labels 0..V-1 only)")
    # prefix -> (log p ending blank, log p ending non-blank, lm score)
    beams: list[dict] = [{(): (0.0, -np.inf, 0.0)} for _ in range(B)]
    t_max = int(lens.max()) if B else 0
    for t in range(t_max):
        live = [b for b in range(B) if t < int(lens[b])]
        lm_rows_of: dict[int, tuple] = {}
        if use_lm and live:
            # ONE batched LM call covering every live prefix in the batch
            all_prefixes: list[list[int]] = []
            spans: dict[int, tuple[int, dict]] = {}
            for b in live:
                row_of = {p: len(all_prefixes) + i
                          for i, p in enumerate(beams[b].keys())}
                spans[b] = row_of
                all_prefixes.extend(list(p) for p in beams[b].keys())
            lm_all = np.asarray(lm.next_logprobs(all_prefixes))
            lm_rows_of = {b: (lm_all, spans[b]) for b in live}
        for b in live:
            lm_rows, row_of = lm_rows_of.get(b, (None, None))
            beams[b] = _advance_beam(beams[b], lp_all[b, t], blank_id, pre_beam,
                                     beam_size, lm_weight, lm_rows, row_of)
    out: list[list[int]] = []
    for b in range(B):
        best = max(beams[b].items(),
                   key=lambda kv: np.logaddexp(kv[1][0], kv[1][1]) + kv[1][2])[0]
        out.append(list(best))
    return out
