"""Time-synchronous RNN-T beam on the device, with in-search LM fusion,
counterpart of ``beam_decode`` / ``beam_decode_nbest`` in
``hnet_mamba_asr_tpu/models/rnnt.py``.

The host engine (``decoders/rnnt_decode.py``) keeps a dict of label
sequences per utterance. Here the beam is a set of tensors on the model's
device: per utterance K frontier rows (token buffer [L], length, acoustic
log-sum, and with an LM its label-only LM log-prob, next-token log-probs and
K/V rings), advanced by batches of tensor operations; the host only counts
frames and rounds, and reads the result once at the end.

Per frame, up to ``max_symbols`` expansion rounds: each round scores the
frontier with one joint step (``RNNTHead.step_logprobs``), banks every
row's blank-consumed mass into a per-frame bank of K (R + 2) rows, where
alignments of the same label sequence merge exactly (token-buffer compare,
no hashing: two frontier rows are distinct, so at most one matches a bank
row), and grows the frontier to the top K of its K V children (distinct
parents give distinct children). The last round only banks. The next
frame's frontier is the top K of the bank.

LM fusion (``lm``, a ``TransformerLM``) adds ``lm_weight * logP_LM(label |
labels)`` to the selection score of every label emission while the
acoustic log-sum and the raw LM log-prob ride apart, so alignment merges
are untouched. Each round one cached LM step (``device_ctc_beam._lm_step``)
advances the new frontier; the frame's winners come out of the bank, whose
rows snapshot frontiers of different rounds, so each bank row remembers its
frame-start ancestor (``root``) and the winners replay their new labels
from that ancestor's frame-start rings, which gives their rings and
next-token log-probs exactly.

Scores accumulate in float32, as in the JAX search. A row's result does not
depend on the rest of the batch: the joint and LM GEMMs run in
``DECODE_ROWS`` blocks, the LM's attention reads a key count fixed by the
frame index alone, and ``top_k`` breaks ties to the lower index.

Streaming: the returned beam (tokens, lengths, scores) is the whole state of
the search (it is frame-synchronous with no lookahead), so feeding the frames
block by block with the last call's beam passed back as ``state`` equals one
pass (frames past ``memory_lengths`` leave the beam as it is). Pass
``token_buf_len`` on the first call so that the token buffer's length does
not depend on the block. As in JAX it does not combine with LM fusion.
"""
from __future__ import annotations

import torch

from hnet_mamba_asr_torch.decoders.device_ctc_beam import (
    _lm_init_caches, _lm_step, ring_slots, top_k)
from hnet_mamba_asr_torch.models.aed import key_slots

NEG_INF = -1.0e30               # a dead row's score, as in the JAX search
LM_CACHE_CAP = 512              # LM ring slots at most (the JAX search's lm_cache_cap)


def _hist(toks: torch.Tensor, plen: torch.Tensor, context: int, bos: int) -> torch.Tensor:
    """[B, K, L], [B, K] -> [B, K, context] (most recent first, bos-filled)."""
    cols = plen[..., None] - 1 - torch.arange(context, device=toks.device)
    h = toks.gather(2, cols.clamp(min=0))
    return torch.where(cols >= 0, h, bos)


@torch.inference_mode()
def beam_decode_nbest(head, memory: torch.Tensor, memory_lengths: torch.Tensor,
                      beam_size: int = 8, max_symbols: int | None = None, *, lm=None,
                      lm_weight: float = 0.0, lm_cache_cap: int = LM_CACHE_CAP,
                      state=None, token_buf_len: int | None = None):
    """-> the final merged beam: tokens [B, K, L], lengths [B, K], acoustic
    scores [B, K] (dead rows at NEG_INF), L = min(max_decode_len, T R) unless
    ``token_buf_len`` or ``state`` sets it; with ``lm`` a 4th entry, each
    row's LM log-prob including the eos closure term (comparable to
    ``CausalLMScorer.sequence_logprob``). ``state``: the beam a previous call
    returned, to go on from (streaming; module docstring)."""
    K = int(beam_size)
    R = int(max_symbols if max_symbols is not None else head.max_symbols)
    B, T, _ = memory.shape
    dev = memory.device
    if state is not None and lm is not None:
        raise ValueError("streaming state does not compose with LM fusion (the fused "
                         "carry also holds KV caches)")
    if state is not None:
        L = int(state[0].shape[-1])
    elif token_buf_len is not None:
        L = int(token_buf_len)
    else:
        L = min(head.max_decode_len, T * R if T * R > 0 else 1)
    V, blank, C, bos = head.vocab_size, head.blank_id, head.context, head.bos_id
    Nb = K * (R + 2)                                   # bank capacity (loose bound)
    w = float(lm_weight)
    use_lm = lm is not None
    enc_f = head.encode_features(memory)                                # [B, T, J]
    J = enc_f.shape[-1]
    lens = torch.as_tensor(memory_lengths, device=dev)
    ar_b = torch.arange(B, device=dev)[:, None]
    pos_l = torch.arange(L, device=dev)
    if state is not None:
        ftoks, fplen, fscore = (state[0].to(dev, torch.long), state[1].to(dev, torch.long),
                                state[2].to(dev, torch.float32))
    else:
        ftoks = torch.zeros((B, K, L), dtype=torch.long, device=dev)
        fplen = torch.zeros((B, K), dtype=torch.long, device=dev)
        fscore = torch.full((B, K), NEG_INF, device=dev)
        fscore[:, 0] = 0.0
    if use_lm:
        rows = B * K
        cap = int(min(L + 1, lm_cache_cap))
        caches = _lm_init_caches(lm, rows, cap, dev)
        ring = ring_slots(cap)
        lm_next, caches = _lm_step(lm, caches, torch.full((rows,), lm.bos_id, device=dev),
                                   torch.zeros(rows, dtype=torch.long, device=dev),
                                   torch.ones(rows, dtype=torch.bool, device=dev),
                                   keys=key_slots(1, ring))
        lm_next = lm_next.reshape(B, K, -1)
        flms = torch.zeros((B, K), device=dev)

    for t in range(T):
        run = (t < lens)[:, None]                                        # [B, 1]
        enc_t = enc_f[:, t, None, :].expand(B, K, J).reshape(B * K, J)
        toks, plen, score = ftoks, fplen, fscore
        if use_lm:
            # every row holds at most (t + 1) R labels after this frame
            keys = key_slots(min((t + 1) * R + 1, cap), ring)
            start_caches = [(ck[:, :keys], cv[:, :keys]) for ck, cv in caches]
            caches_r = start_caches
            lms, nxt_lp = flms, lm_next
            root = torch.arange(K, device=dev).expand(B, K)
            broot = torch.zeros((B, Nb), dtype=torch.long, device=dev)
            blms = torch.zeros((B, Nb), device=dev)
        btoks = torch.zeros((B, Nb, L), dtype=torch.long, device=dev)
        bplen = torch.zeros((B, Nb), dtype=torch.long, device=dev)
        bscore = torch.full((B, Nb), NEG_INF, device=dev)
        bvalid = torch.zeros((B, Nb), dtype=torch.bool, device=dev)
        count = torch.zeros((B, 1), dtype=torch.long, device=dev)

        for round_ in range(R + 1):
            lp = head.step_logprobs(enc_t, _hist(toks, plen, C, bos).reshape(B * K, C))
            lp = lp.reshape(B, K, V + 1)
            live = score > NEG_INF / 2

            # ---- bank the blank-consumed mass (exact merges) ----------------
            cand = score + lp[..., blank]                                # [B, K]
            same_tok = torch.where(pos_l < plen[:, :, None, None],
                                   toks[:, :, None, :] == btoks[:, None, :, :], True)
            eq = (same_tok.all(-1) & (plen[:, :, None] == bplen[:, None, :])
                  & bvalid[:, None, :] & live[:, :, None])               # [B, K, Nb]
            bscore = torch.logaddexp(bscore, torch.where(eq, cand[..., None], NEG_INF).amax(1))
            unmatched = live & ~eq.any(-1)
            slot = count + torch.cumsum(unmatched.long(), dim=1) - 1
            slot = torch.where(unmatched, slot.clamp(max=Nb - 1), Nb)    # Nb: nowhere
            oh = slot[..., None] == torch.arange(Nb, device=dev)         # [B, K, Nb]
            appended = oh.any(1)                                         # [B, Nb]
            src = oh.long().argmax(1)                                    # the row appended
            bscore = torch.logaddexp(bscore, torch.where(appended, cand.gather(1, src),
                                                         NEG_INF))
            btoks = torch.where(appended[..., None], toks.gather(1, src[..., None].expand(
                B, Nb, L)), btoks)
            bplen = torch.where(appended, plen.gather(1, src), bplen)
            bvalid = bvalid | appended
            count = count + unmatched.sum(-1, keepdim=True)
            if use_lm:
                # a merged row's LM score is the bank row's (same labels)
                blms = torch.where(appended, lms.gather(1, src), blms)
                broot = torch.where(appended, root.gather(1, src), broot)
            if round_ == R:
                break                    # the last round only banks

            # ---- children: the top K of the K V (parent, label) pairs --------
            child_ac = torch.where((live & (plen < L))[..., None],
                                   score[..., None] + lp[..., :V], NEG_INF)
            if use_lm:
                child_lms = lms[..., None] + nxt_lp[..., :V]
                child_sel = torch.where(child_ac > NEG_INF / 2, child_ac + w * child_lms,
                                        NEG_INF)
            else:
                child_sel = child_ac
            _, idx = top_k(child_sel.reshape(B, K * V), K)
            parent, label = idx // V, idx % V
            top = child_ac.reshape(B, K * V).gather(1, idx)
            pplen = plen.gather(1, parent)
            toks = torch.where(pos_l == pplen.clamp(max=L - 1)[..., None], label[..., None],
                               toks.gather(1, parent[..., None].expand(B, K, L)))
            plen, score = pplen + 1, top
            if use_lm:
                lms = child_lms.reshape(B, K * V).gather(1, idx)
                root = root.gather(1, parent)
                # one cached LM step advances the new frontier (dead and
                # finished rows masked)
                gpar = (parent + ar_b * K).reshape(rows)
                caches_r = [(ck[gpar], cv[gpar]) for ck, cv in caches_r]
                write = ((top > NEG_INF / 2) & run & (pplen + 1 < cap)).reshape(rows)
                step_lp, caches_r = _lm_step(
                    lm, caches_r, torch.where(write, label.reshape(rows), lm.pad_id),
                    (pplen + 1).clamp(max=cap - 1).reshape(rows), write)
                par_next = nxt_lp.gather(1, parent[..., None].expand_as(nxt_lp))
                nxt_lp = torch.where(write.reshape(B, K, 1), step_lp.reshape(B, K, -1),
                                     par_next)

        # ---- frame end: next frontier = top K of the bank ---------------------
        bs = torch.where(bvalid, bscore, NEG_INF)
        if use_lm:
            _, idx = top_k(torch.where(bvalid, bscore + w * blms, NEG_INF), K)
            top = bs.gather(1, idx)
        else:
            top, idx = top_k(bs, K)
        ntoks = btoks.gather(1, idx[..., None].expand(B, K, L))
        nplen = bplen.gather(1, idx)
        if use_lm:
            # the winners replay their new labels from the frame-start rings
            # of their root ancestor
            nroot = broot.gather(1, idx)
            p0 = fplen.gather(1, nroot)
            groot = (nroot + ar_b * K).reshape(rows)
            ncaches = [(ck[groot], cv[groot]) for ck, cv in start_caches]
            nlm_next = lm_next.gather(1, nroot[..., None].expand_as(lm_next))
            delta = torch.where(run, nplen - p0, 0)
            for j in range(int(delta.max())):
                tok_j = ntoks.gather(2, (p0 + j).clamp(max=L - 1)[..., None])[..., 0]
                write = ((j < delta) & (p0 + 1 + j < cap)).reshape(rows)
                step_lp, ncaches = _lm_step(
                    lm, ncaches, torch.where(write, tok_j.reshape(rows), lm.pad_id),
                    (p0 + 1 + j).clamp(max=cap - 1).reshape(rows), write)
                nlm_next = torch.where(write.reshape(B, K, 1), step_lp.reshape(B, K, -1),
                                       nlm_next)
            keep_r = run.expand(B, K).reshape(rows)[:, None, None, None]
            for (ck, cv), (nk, nv) in zip(caches, ncaches):
                ck[:, :keys] = torch.where(keep_r, nk, ck[:, :keys])
                cv[:, :keys] = torch.where(keep_r, nv, cv[:, :keys])
            flms = torch.where(run, blms.gather(1, idx), flms)
            lm_next = torch.where(run[..., None], nlm_next, lm_next)
        ftoks = torch.where(run[..., None], ntoks, ftoks)
        fplen = torch.where(run, nplen, fplen)
        fscore = torch.where(run, top, fscore)

    if use_lm:
        return ftoks, fplen, fscore, flms + lm_next[..., lm.eos_id]
    return ftoks, fplen, fscore


def beam_decode(head, memory: torch.Tensor, memory_lengths: torch.Tensor,
                beam_size: int = 8, max_symbols: int | None = None):
    """-> (tokens [B, L], lengths [B]) of each utterance's best merged
    hypothesis."""
    ftoks, fplen, fscore = beam_decode_nbest(head, memory, memory_lengths, beam_size,
                                             max_symbols)
    best = torch.argmax(fscore, dim=1)
    ar = torch.arange(ftoks.shape[0], device=ftoks.device)
    return ftoks[ar, best], fplen[ar, best]
