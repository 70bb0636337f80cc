"""Frame-synchronous CTC prefix beam on the device, with in-search LM fusion,
counterpart of ``hnet_mamba_asr_tpu/decoders/device_ctc_beam.py``.

The host prefix beam (``decoders/ctc_decode.py``) keeps a dict of prefixes
per utterance and runs numpy per frame. Here the beam is a set of tensors on
the model's device: per utterance K rows of (log p ending in blank, log p
ending in non-blank, accumulated LM score, token buffer, length, last
label), advanced by one batch of tensor operations per frame. The host only
counts frames: no step copies between host and device, and the best
hypothesis is read back once at the end.

Merging needs an exact rule. Per frame the search produces "stay" entries
(one per live prefix: blank extension + last-label repeat) and "grow"
entries (prefix + candidate label). With a duplicate-free beam two grow
entries never coincide and two stay entries never do, and grow(k, c) ==
stay(j) iff prefix_j = prefix_k + [c]: ``len_j == len_k + 1``, the first
``len_k`` tokens agree and ``last_j == c``, found by comparing token
buffers (no hashing). A matched grow entry's non-blank mass folds into its
stay row (log-add) and the grow row is deleted; one ``top_k`` over the K
stay + K * P grow scores selects the next beam.

LM fusion runs inside the frame loop: each row carries the LM's next-token
log-probs for its prefix and per-layer K/V rings (``_lm_step``); per frame
one LM step of all rows at their own positions writes only the rows that
grew (masked writes), and rings follow their parents after selection.

Scores accumulate in float32 (the host engine keeps float64), as in the JAX
device search: transcripts may part only on ties inside float32's noise.
A row's result does not depend on the rest of the batch: the LM step's
GEMMs run in blocks of ``DECODE_ROWS`` rows, its attention is an elementwise
product and a sum over ``KEY_BLOCK`` multiples of keys chosen from the frame
count alone, and ``top_k`` breaks ties to the lower index, as ``lax.top_k``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from hnet_mamba_asr_torch.models.aed import DECODE_ROWS, key_slots
from hnet_mamba_asr_torch.models.mamba2 import dense
from hnet_mamba_asr_torch.models.mamba_block import layer_norm
from hnet_mamba_asr_torch.models.moe import dense_mix

NEG_INF = -1.0e9
LM_CACHE_CAP = 512              # LM ring slots at most (the JAX search's lm_cache_cap)


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, largest first,
    ties to the lower index (``lax.top_k``'s order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def ring_slots(cap: int) -> int:
    """A K/V ring's allocated slots: ``cap`` rounded up to ``KEY_BLOCK`` so
    that ``key_slots`` reads the same keys whatever the ring's size."""
    return key_slots(cap, 1 << 30)


# ═══ the cached LM stepper (per-row positions, masked cache writes) ═══════════
def _lm_init_caches(lm, rows: int, cap: int, device) -> list:
    """Empty per-block K/V rings [rows, ring_slots(cap), H, dh] in fp32."""
    H = lm.blocks[0].self_attn.n_heads
    shape = (rows, ring_slots(cap), H, lm.d_model // H)
    return [(torch.zeros(shape, device=device), torch.zeros(shape, device=device))
            for _ in lm.blocks]


def _lm_step(lm, caches, tokens, pos, write_mask, keys: int | None = None):
    """One cached ``TransformerLM`` step for R rows at per-row positions, in
    fp32 on the LM's own weights: tokens [R] enter at ring slot ``pos`` [R]
    (bos holds slot 0); rows where ``write_mask`` [R] is False leave their
    rings untouched and their returned log-probs are for the caller to
    discard. ``keys``: the ring slots read, at least max(pos) + 1 (all by
    default). -> (log-probs [R, V], caches, written in place). Numerics are
    ``TransformerLM.forward``'s: sqrt(d) embedding scale, pad embedding
    zeroed, sinusoidal positions, pre-LN blocks (eps 1e-6), q scaled by
    1/sqrt(dh), tanh GELU; an MoE block's FFN in its dense-mix form
    (``models/moe.py::dense_mix``), exact at the dropless capacity
    ``tasks/decode_task.py::load_lm_scorer`` gives a fusion LM."""
    f32 = torch.float32
    R, d = tokens.shape[0], lm.d_model
    H = lm.blocks[0].self_attn.n_heads
    dh = d // H
    n = caches[0][0].shape[1] if keys is None else keys
    ar = torch.arange(R, device=tokens.device)
    emb = lm.embed.weight[tokens] * math.sqrt(d)
    emb = torch.where((tokens == lm.pad_id)[:, None], 0.0, emb)
    x = emb + lm.pe[pos]
    live = (torch.arange(n, device=tokens.device)[None, :] <= pos[:, None])[:, None, :]
    wm = write_mask[:, None, None]
    for block, (ck, cv) in zip(lm.blocks, caches):
        at = block.self_attn
        h = layer_norm(x, block.norm1, f32)
        q, k, v = (m(h, f32, rows=DECODE_ROWS).reshape(R, H, dh)
                   for m in (at.query, at.key, at.value))
        ck[ar, pos] = torch.where(wm, k, ck[ar, pos])
        cv[ar, pos] = torch.where(wm, v, cv[ar, pos])
        # per-row products and sums (not batched GEMMs, whose kernels vary
        # with the row count): [R, n, H, dh] -> [R, H, n]
        logits = ((q / math.sqrt(dh))[:, None] * ck[:, :n]).sum(-1).transpose(1, 2)
        w = torch.softmax(torch.where(live, logits, NEG_INF), dim=-1)
        o = (w.transpose(1, 2)[..., None] * cv[:, :n]).sum(1).reshape(R, d)
        x = x + at.out(o, f32, rows=DECODE_ROWS)
        h = layer_norm(x, block.norm2, f32)
        if block.moe is not None:                        # dropless scoring: exact
            x = x + dense_mix(block.moe, h, f32, rows=DECODE_ROWS)
            continue
        ff = F.gelu(dense(h, block.linear1, f32, row_block=DECODE_ROWS), approximate="tanh")
        x = x + dense(ff, block.linear2, f32, row_block=DECODE_ROWS)
    logits = dense(x, lm.out, f32, row_block=DECODE_ROWS)
    return torch.log_softmax(logits, dim=-1), caches


# ═══ the frame-synchronous beam ═══════════════════════════════════════════════
def _beam_scan(lp, lens, *, K: int, P: int, blank: int, lm_weight: float = 0.0, lm=None,
               lm_cap: int = 0):
    """lp [B, T, V1] log-probs, lens [B] (on lp's device) -> (tokens [B,
    T], lengths [B], scores [B]) of each utterance's best prefix.
    ``lm``: a ``TransformerLM`` fused at ``lm_weight``, its rings ``lm_cap``
    slots."""
    B, T, V1 = lp.shape
    dev = lp.device
    use_lm = lm is not None
    rows = B * K
    # the scores accumulate in lp's dtype (float32 from the public entry points)
    pb = torch.full((B, K), NEG_INF, dtype=lp.dtype, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((B, K), NEG_INF, dtype=lp.dtype, device=dev)
    lms = torch.zeros((B, K), dtype=lp.dtype, device=dev)
    toks = torch.zeros((B, K, T), dtype=torch.long, device=dev)
    plen = torch.zeros((B, K), dtype=torch.long, device=dev)
    last = torch.full((B, K), -1, dtype=torch.long, device=dev)
    pos = torch.arange(T, device=dev)
    bidx = torch.arange(B, device=dev)[:, None] * K
    blank_col = torch.full((1,), blank, device=dev)
    if use_lm:
        caches = _lm_init_caches(lm, rows, lm_cap, dev)
        ring = caches[0][0].shape[1]
        lm_next, caches = _lm_step(lm, caches, torch.full((rows,), lm.bos_id, device=dev),
                                   torch.zeros(rows, dtype=torch.long, device=dev),
                                   torch.ones(rows, dtype=torch.bool, device=dev),
                                   keys=key_slots(1, ring))
        lm_next = lm_next.reshape(B, K, -1)

    for t in range(T):
        frame = lp[:, t]                                               # [B, V1]
        ptot = torch.logaddexp(pb, pnb)
        alive = ptot > NEG_INF / 2                                     # [B, K]

        # candidates: the top-P non-blank labels of this frame, per utterance
        cand_lp, cand = top_k(frame.index_fill(1, blank_col, NEG_INF), P)   # [B, P]

        # stay entries
        stay_pb = ptot + frame[:, blank, None]
        rep_lp = frame.gather(1, last.clamp(min=0))
        stay_pnb = torch.where(plen > 0, pnb + rep_lp, NEG_INF)

        # grow entries
        same = (cand[:, None, :] == last[:, :, None]) & (plen > 0)[:, :, None]
        base = torch.where(same, pb[:, :, None], ptot[:, :, None])     # [B, K, P]
        grow_pnb = torch.where(alive[:, :, None], base + cand_lp[:, None, :], NEG_INF)
        if use_lm:
            lm_c = lm_next.gather(2, cand[:, None, :].expand(B, K, P))
            grow_lms = lms[:, :, None] + lm_weight * lm_c
        else:
            grow_lms = lms[:, :, None].expand(B, K, P)

        # exact merges: grow(k, c) == stay(j); prefixes hold at most t labels
        tk = toks[:, :, :t]
        mism = ((tk[:, :, None, :] != tk[:, None, :, :])
                & (pos[:t] < plen[:, None, :, None])).any(-1)
        ext = ((plen[:, :, None] == plen[:, None, :] + 1) & ~mism
               & alive[:, :, None] & alive[:, None, :])                # [B, j, k]
        merge = ext[..., None] & (cand[:, None, None, :] == last[:, :, None, None])
        m_add = torch.where(merge, grow_pnb[:, None], NEG_INF).amax(dim=(2, 3))
        stay_pnb = torch.logaddexp(stay_pnb, m_add)
        grow_pnb = torch.where(merge.any(1), NEG_INF, grow_pnb)

        # select the top K of the K stay + K * P grow entries
        stay_score = torch.logaddexp(stay_pb, stay_pnb) + lms
        grow_score = torch.where(grow_pnb > NEG_INF / 2, grow_pnb + grow_lms, NEG_INF)
        _, top_idx = top_k(torch.cat([grow_score.reshape(B, K * P), stay_score], 1), K)
        is_stay = top_idx >= K * P
        j = torch.where(is_stay, top_idx - K * P, 0)
        k = torch.where(is_stay, 0, top_idx // P)
        c_idx = torch.where(is_stay, 0, top_idx % P)
        parent = torch.where(is_stay, j, k)                            # [B, K]
        g2 = lambda a: a.reshape(B, K * P).gather(1, k * P + c_idx)   # noqa: E731

        new_tok = cand.gather(1, c_idx)
        new_pb = torch.where(is_stay, stay_pb.gather(1, j), NEG_INF)
        new_pnb = torch.where(is_stay, stay_pnb.gather(1, j), g2(grow_pnb))
        new_lms = torch.where(is_stay, lms.gather(1, j), g2(grow_lms))
        par_len = plen.gather(1, parent)
        par_toks = toks.gather(1, parent[..., None].expand(B, K, T))
        grown_toks = torch.where((pos == par_len[..., None]) & ~is_stay[..., None],
                                 new_tok[..., None], par_toks)
        new_len = par_len + (~is_stay).long()
        new_last = torch.where(is_stay, last.gather(1, parent), new_tok)

        # utterances whose frames are exhausted keep their beam
        run = (t < lens)[:, None]
        if use_lm:
            # rings follow their parents, then ONE step advances the rows
            # that grew; every row reads at most slot t + 1
            keys = key_slots(t + 2, ring)
            gpar = (parent + bidx).reshape(rows)
            for ck, cv in caches:
                ck[:, :keys] = ck[gpar, :keys]
                cv[:, :keys] = cv[gpar, :keys]
            grew = (~is_stay & run).reshape(rows)
            pos_r = (par_len + 1).clamp(max=lm_cap - 1).reshape(rows)
            write = grew & (par_len.reshape(rows) + 1 < lm_cap)
            step_lp, caches = _lm_step(lm, caches, torch.where(grew, new_tok.reshape(rows),
                                                               lm.pad_id),
                                       pos_r, write, keys=keys)
            par_next = lm_next.gather(1, parent[..., None].expand_as(lm_next))
            stepped = torch.where(write.reshape(B, K, 1), step_lp.reshape(B, K, -1), par_next)
            lm_next = torch.where(run[..., None], stepped, lm_next)
        pb = torch.where(run, new_pb, pb)
        pnb = torch.where(run, new_pnb, pnb)
        lms = torch.where(run, new_lms, lms)
        toks = torch.where(run[..., None], grown_toks, toks)
        plen = torch.where(run, new_len, plen)
        last = torch.where(run, new_last, last)

    score = torch.logaddexp(pb, pnb) + lms
    best = torch.argmax(score, dim=1)[:, None]
    return (toks.gather(1, best[..., None].expand(B, 1, T))[:, 0],
            plen.gather(1, best)[:, 0], score.gather(1, best)[:, 0])


def ctc_beam_search_device(log_probs, lengths, *, blank_id: int, beam_size: int = 10,
                           pre_beam: int = 30, lm=None, lm_weight: float = 0.0,
                           n_utts: int | None = None, scores: list | None = None) -> list[list[int]]:
    """Drop-in device engine for ``ctc_prefix_beam_search``: log_probs [B, T,
    V+1] (a tensor, on the device the search runs on, or an array, which
    runs on the CPU), lengths [B] -> one id list per utterance for the first
    ``n_utts`` rows.

    ``lm`` is a ``CausalLMScorer``, whose ``TransformerLM`` the search steps
    itself; fusion adds ``lm_weight * logP_LM(c | prefix)`` as the host
    engine does. The LM rings hold min(T + 1, ``LM_CACHE_CAP``) slots: LM
    additions freeze for longer prefixes, as in the JAX search. ``scores``
    (a list) receives each utterance's best score."""
    lp = torch.as_tensor(log_probs).float()
    B, T, V1 = lp.shape
    n = int(n_utts) if n_utts is not None else B
    P = min(int(pre_beam), V1 - 1)
    use_lm = lm is not None and lm_weight != 0.0
    if use_lm and blank_id != V1 - 1:
        raise ValueError("LM fusion requires blank at the last class")
    lens = torch.as_tensor(np.asarray(lengths), device=lp.device)
    with torch.inference_mode():
        toks, blen, best = _beam_scan(lp, lens, K=int(beam_size), P=P, blank=int(blank_id),
                                      lm_weight=float(lm_weight) if use_lm else 0.0,
                                      lm=lm.lm if use_lm else None,
                                      lm_cap=min(T + 1, LM_CACHE_CAP))
    toks, blen = toks.cpu().numpy(), blen.cpu().numpy()
    if scores is not None:
        scores.extend(best[:n].tolist())
    return [toks[b, :int(blen[b])].tolist() for b in range(n)]


def beam_scan(log_probs: torch.Tensor, lengths: torch.Tensor, *, beam_size: int,
              pre_beam: int, blank_id: int):
    """The no-LM prefix beam for a serving call: log_probs [B, T, V+1] and
    lengths [B] on one device -> (tokens [B, T], lengths [B]) of each
    utterance's best hypothesis, on that device."""
    V1 = log_probs.shape[-1]
    return _beam_scan(log_probs.float(), lengths, K=int(beam_size),
                      P=min(int(pre_beam), V1 - 1), blank=int(blank_id))[:2]
