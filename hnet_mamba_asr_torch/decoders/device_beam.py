"""Label-synchronous AED and joint CTC + AED beam on the device, counterpart
of ``hnet_mamba_asr_tpu/decoders/device_beam.py``.

The host beams (``decoders/joint.py``) score on the host in float64 and
call the device once per step. Here the whole search state lives on the
model's device, and each step is one batch of tensor operations around the
AED head's KV-cached ``decode_step``:

  - alive beam: R rows per utterance, scores -1e9-padded, so the beam can
    shrink (eos retirements) as the host search's list does;
  - ended pool: the running top-``nbest`` completions per utterance,
    updated by concat + ``top_k`` whenever eos expansions win beam slots;
  - joint scoring: candidates are the top-``pre`` AED tokens plus an eos
    slot (masked when eos already won a slot, so candidate sets match the
    host's ``unique(top-pre + eos)``); each candidate's CTC prefix score is a
    log-sum over frames of the parent's carried forward state
    (``_ctc_prefix_psi``), and the R winners' states advance by a log-depth
    scan over frames (``_ctc_advance_r``);
  - per-utterance step caps ``min(max(1, ratio * Tf), Tf - 1,
    max_decode_len)`` and the sound early stop (length_bonus <= 0: best
    alive <= nbest-th completion) as a per-utterance ``active`` mask;
  - cap survivors are finalized with their own eos score (AED from the next
    decode step, CTC from their carried forward state) in the step their cap
    is hit, the host search's need_final pass.

The host reads the ``active`` mask once every ``ACTIVE_EVERY`` steps and
stops when no utterance is active; steps past an utterance's end change
none of its state, so the stop is exact. No other step copies between host
and device. Scores accumulate in float32, as in the JAX device search: the
hypotheses may part from the float64 host search only on ties inside
float32's noise.

A beam's result does not depend on the rest of the batch: ``decode_step``
attends one utterance's rows at a time over ``KEY_BLOCK`` multiples of
keys and runs its GEMMs in fixed row blocks (``models/aed.py``); the
self-attention ring is allocated in ``KEY_BLOCK`` multiples; the log-sum
over frames is a tree of adjacent pairs over a power-of-two length, so that
frames past an utterance's end (log 0) leave it bit-exact; the forward
state is read at the utterance's own last frame; and the pool's LM scores
come from ``CausalLMScorer.sequence_logprob``'s fixed-shape calls.
"""
from __future__ import annotations

import numpy as np
import torch

from hnet_mamba_asr_torch.decoders.device_ctc_beam import NEG_INF, ring_slots, top_k
from hnet_mamba_asr_torch.decoders.joint import Hypothesis
from hnet_mamba_asr_torch.models.aed import decode_groups

CTC_LOG0 = -1.0e10               # CTC lattice log-zero (the host's LOG_ZERO)
ACTIVE_EVERY = 8                 # steps between host reads of the active mask


def _pow2_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


def _log_sum(x: torch.Tensor) -> torch.Tensor:
    """log(sum(exp(x))) over the last axis as a tree of adjacent pairs over
    the next power-of-two length (padded with log 0), so that trailing log-0
    entries leave the result bit-exact."""
    n = x.shape[-1]
    if n == 0:
        return torch.full(x.shape[:-1], CTC_LOG0, device=x.device)
    x = torch.nn.functional.pad(x, (0, _pow2_bucket(n, 1) - n), value=CTC_LOG0)
    while x.shape[-1] > 1:
        x = torch.logaddexp(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def _frame_at(r: torch.Tensor, last_frame: torch.Tensor) -> torch.Tensor:
    """r [B, R, T] -> [B, R]: each utterance's value at its frame
    ``last_frame`` [B]."""
    B, R, _ = r.shape
    return r.gather(2, last_frame[:, None, None].expand(B, R, 1))[..., 0]


def _ctc_prefix_psi(ctc_logp, r_prev, cand, last_tok, t: int, last_frame):
    """CTC prefix selection scores for every (row, candidate) at beam step t.

    The selection score psi does not depend on the grown prefix's own
    forward state, only on the parent's carried ``r_prev``, so it is a
    log-sum over frames, not a recursion:

        psi = psi_0  (+)  logsum_{tt >= max(t, 1)} ( phi[tt-1] + x[tt] )

    ctc_logp [B, T, W] (frames past an utterance's length padded to blank 0,
    labels log 0, which freezes the recursion); r_prev [B, R, T, 2]; cand
    [B, R, C]; last_frame [B]. -> (psi [B, R, C], eos_psi [B, R]): the
    host ``CTCPrefixScorer.score`` with out_len = t."""
    B, T, W = ctc_logp.shape
    R, C = cand.shape[1], cand.shape[2]
    idx = cand.clamp(max=W - 1).reshape(B, 1, R * C).expand(B, T, R * C)
    xs = ctc_logp.gather(2, idx).reshape(B, T, R, C).permute(0, 2, 3, 1)   # [B, R, C, T]
    r_sum = torch.logaddexp(r_prev[..., 0], r_prev[..., 1])               # [B, R, T]
    same = ((cand == last_tok[..., None]) & (t > 0))[..., None]
    start = max(t, 1)
    phi = torch.where(same, r_prev[:, :, None, start - 1:T - 1, 1],
                      r_sum[:, :, None, start - 1:T - 1])                 # [B, R, C, T-start]
    psi = _log_sum(phi + xs[..., start:])
    if t == 0:
        psi = torch.logaddexp(xs[..., 0], psi)
    return psi, _frame_at(r_sum, last_frame)


def _combine(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Compose two stacked transfer elements [5, ...] (left first): the
    lower-triangular 2x2 log-semiring matrix (a00, a10, a11; a01 is log 0
    and stays so) and the affine term (u0, u1)."""
    la00, la10, la11, lu0, lu1 = left
    ra00, ra10, ra11, ru0, ru1 = right
    lae = torch.logaddexp
    return torch.stack([ra00 + la00, lae(ra10 + la00, ra11 + la10), ra11 + la11,
                        lae(ra00 + lu0, ru0), lae(lae(ra10 + lu0, ra11 + lu1), ru1)])


def _ctc_advance_r(ctc_logp, r_par, tok, last_par, t: int, blank: int):
    """Advance the carried CTC forward state of the R selected winners.

    The Graves recursion over frames

        r0[tt] = x[tt] + logaddexp(r0[tt-1], phi[tt-1])
        r1[tt] = b[tt] + logaddexp(r0[tt-1], r1[tt-1])

    is an affine recurrence in the log semiring, evaluated as a log-depth
    inclusive scan (Hillis-Steele: log2 T rounds of ``_combine``) of 2x2
    transfer elements. A frame's result depends only on the frames before
    it, whatever T is. r_par / last_par are the parent rows' state (gathered
    by the caller); tok [B, R]. -> r_new [B, R, T, 2]."""
    B, T, W = ctc_logp.shape
    R = tok.shape[1]
    xs = ctc_logp.gather(2, tok.clamp(max=W - 1)[:, None, :].expand(B, T, R))
    xs = xs.permute(1, 0, 2)                                           # [T, B, R]
    r_sum = torch.logaddexp(r_par[..., 0], r_par[..., 1])              # [B, R, T]
    same = ((tok == last_par) & (t > 0))[..., None]
    phi = torch.where(same, r_par[..., 1], r_sum).permute(2, 0, 1)     # [T, B, R]
    b_t = ctc_logp[:, :, blank].T[:, :, None].expand(T, B, R)
    act = (torch.arange(T, device=xs.device) >= max(t, 1))[:, None, None]
    log0 = torch.full_like(xs, CTC_LOG0)
    a00 = torch.where(act, xs, CTC_LOG0)
    a1 = torch.where(act, b_t, CTC_LOG0)
    u0 = torch.where(act, torch.roll(phi, 1, 0) + xs, CTC_LOG0)
    # frame 0: r0 = x[0] iff this is the first label, no matrix part
    u0[0] = xs[0] if t == 0 else CTC_LOG0
    e = torch.stack([a00, a1, a1, u0, log0])                           # [5, T, B, R]
    d = 1
    while d < T:
        e = torch.cat([e[:, :d], _combine(e[:, :-d], e[:, d:])], 1)
        d *= 2
    return torch.stack([e[3], e[4]], -1).permute(1, 2, 0, 3)           # [B, R, T, 2]


def _beam_scan(aed, memory, lengths, max_steps, ctc_logp, *, beam_size: int, nbest: int,
               length_bonus: float, pre: int, n_iters: int, ctc_weight: float, blank: int,
               stats: dict) -> dict:
    """The search. memory [B, S, d]; lengths (host ints) and max_steps [B]
    (the per-utterance caps, on the device); ctc_logp [B, T, W] or None
    (pure AED). Runs at most ``n_iters`` steps; returns the pool and alive
    state on the device."""
    dev = memory.device
    B = memory.shape[0]
    R, P, V = beam_size, nbest, aed.vocab_size
    # positions never exceed n_iters: the ring (and the token buffers) hold
    # n_iters + 1 slots, rounded up to KEY_BLOCK so that every step reads the
    # same keys whatever n_iters is
    cap = ring_slots(min(aed.max_decode_len, n_iters) + 1)
    rows = B * R
    use_ctc = ctc_logp is not None
    w = float(ctc_weight) if use_ctc else 0.0
    eos = aed.eos_id
    lens = torch.as_tensor(lengths, device=dev)
    groups = decode_groups(lengths, R)

    caches, kpm = aed.decode_start(memory, lens, cap)
    caches = [{k: (torch.zeros((rows,) + v.shape[1:], dtype=v.dtype, device=dev)
                   if k in ("self_k", "self_v") else v.repeat_interleave(R, dim=0))
               for k, v in c.items()} for c in caches]
    kpm = kpm.repeat_interleave(R, dim=0)
    # bos on every row (position 0); only row 0 expands: the others start at
    # -1e9
    logp, caches = aed.decode_step(caches, kpm, torch.arange(rows, device=dev),
                                   torch.full((rows,), aed.bos_id, device=dev), 0, groups)
    s = dict(
        logp=logp.reshape(B, R, V),
        alive_score=torch.full((B, R), NEG_INF, device=dev).index_fill(
            1, torch.tensor([0], device=dev), 0.0),
        alive_aed=torch.zeros((B, R), device=dev),
        alive_tok=torch.zeros((B, R, cap), dtype=torch.long, device=dev),
        pool_score=torch.full((B, P), NEG_INF, device=dev),
        pool_aed=torch.zeros((B, P), device=dev),
        pool_ctc=torch.zeros((B, P), device=dev),
        pool_len=torch.zeros((B, P), dtype=torch.long, device=dev),
        pool_tok=torch.zeros((B, P, cap), dtype=torch.long, device=dev),
        pool_n=torch.zeros(B, dtype=torch.long, device=dev),
        active=torch.ones(B, dtype=torch.bool, device=dev),
    )
    if use_ctc:
        T = ctc_logp.shape[1]
        last_frame = (lens - 1).clamp(min=0)
        r_init = torch.stack([torch.full((B, T), CTC_LOG0, device=dev),
                              torch.cumsum(ctc_logp[:, :, blank], 1)], -1)   # [B, T, 2]
        s["r_state"] = r_init[:, None].expand(B, R, T, 2).contiguous()
        s["alive_ctc"] = torch.zeros((B, R), device=dev)
        s["last_tok"] = torch.full((B, R), -1, dtype=torch.long, device=dev)
    ar_b = torch.arange(B, device=dev)[:, None]

    def step(t: int) -> None:
        lp = s["logp"]                                                 # [B, R, V]
        dead = s["alive_score"] <= NEG_INF / 2                         # [B, R]
        if use_ctc:
            # candidates: top-pre AED tokens + an eos slot (masked when dup)
            lp_top, cand = top_k(lp, pre)                              # [B, R, pre]
            has_eos = (cand == eos).any(-1)
            cand = torch.cat([cand, torch.full((B, R, 1), eos, device=dev)], -1)
            lp_c = torch.cat([lp_top, lp[:, :, eos, None]], -1)
            dup = has_eos[..., None] & (torch.arange(pre + 1, device=dev) == pre)
            psi, eos_psi = _ctc_prefix_psi(ctc_logp, s["r_state"], cand, s["last_tok"], t,
                                           last_frame)
            psi = torch.where(cand == eos, eos_psi[..., None], psi)
            new_aed = s["alive_aed"][..., None] + lp_c
            new_len = t + (cand != eos).long()
            total = (1.0 - w) * new_aed + w * psi + length_bonus * new_len
            total = torch.where(dup | dead[..., None], NEG_INF, total)
        else:
            # the candidates are the whole vocabulary; the pre-beam prunes
            if pre < V:
                thresh = top_k(lp, pre)[0][..., -1:]
                keep = (lp >= thresh) | (torch.arange(V, device=dev) == eos)
                lp = torch.where(keep, lp, NEG_INF)
            new_aed = s["alive_aed"][..., None] + lp
            new_len = t + (torch.arange(V, device=dev) != eos).long()
            total = torch.where(dead[..., None], NEG_INF, new_aed + length_bonus * new_len)
        space = total.shape[-1]
        top_val, top_idx = top_k(total.reshape(B, R * space), R)       # [B, R]
        parent = top_idx // space
        if use_ctc:
            tok = cand.reshape(B, R * space).gather(1, top_idx)
            sel_ctc = psi.reshape(B, R * space).gather(1, top_idx)
        else:
            tok = top_idx % space
            sel_ctc = torch.zeros((B, R), device=dev)
        sel_aed = new_aed.reshape(B, R * space).gather(1, top_idx)
        is_end = (tok == eos) | (top_val <= NEG_INF / 2)

        # retire eos winners into the pool (concat + top_k keeps the top P)
        end_score = torch.where(tok == eos, top_val, NEG_INF)
        gat = s["alive_tok"].gather(1, parent[..., None].expand(B, R, cap))
        pool = _pool_top(P, (s["pool_score"], end_score), (s["pool_aed"], sel_aed),
                         (s["pool_ctc"], sel_ctc),
                         (s["pool_len"], torch.full((B, R), t, device=dev)),
                         (s["pool_tok"], gat))
        pool_n = s["pool_n"] + (end_score > NEG_INF / 2).sum(1)

        # surviving rows: the non-eos winners; the others become dead slots
        alive_score = torch.where(is_end, NEG_INF, top_val)
        alive_aed = torch.where(is_end, 0.0, sel_aed)
        alive_ctc = torch.where(is_end, 0.0, sel_ctc)
        alive_tok = gat                                # the pool holds its own copy
        alive_tok[:, :, t] = torch.where(is_end, 0, tok)

        # termination per utterance (the host's order)
        beam_empty = (alive_score <= NEG_INF / 2).all(1)
        kth = pool[0][:, nbest - 1]
        early = ((length_bonus <= 0.0) & (pool_n >= nbest)
                 & (alive_score.amax(1) <= kth) & ~beam_empty)
        hit_cap = (t + 1 >= max_steps) & ~beam_empty & ~early

        # one decode step serves both the next expansion and the cap
        # finalization: commit the selected rows and read it now
        gpar = parent + ar_b * R
        logp2, s["caches"] = aed.decode_step(s["caches"], kpm, gpar.reshape(-1),
                                             torch.where(is_end, eos, tok).reshape(-1), t + 1,
                                             groups)
        logp2 = logp2.reshape(B, R, V)

        if use_ctc:
            # advance the forward state of the R winners only
            r_par = s["r_state"].gather(1, parent[..., None, None].expand(B, R, T, 2))
            last_par = s["last_tok"].gather(1, parent)
            r_sel = _ctc_advance_r(ctc_logp, r_par, tok, last_par, t, blank)
            fin_ctc = _frame_at(torch.logaddexp(r_sel[..., 0], r_sel[..., 1]), last_frame)
        else:
            fin_ctc = torch.zeros((B, R), device=dev)

        # cap finalization: survivors score their own eos from logp2 (and
        # the CTC probability of the whole sequence from their forward state)
        fin_aed = alive_aed + logp2[:, :, eos]
        fin_total = (1.0 - w) * fin_aed + w * fin_ctc + length_bonus * (t + 1)
        fin_score = torch.where((alive_score > NEG_INF / 2) & hit_cap[:, None], fin_total,
                                NEG_INF)
        pool2 = _pool_top(P, (pool[0], fin_score), (pool[1], fin_aed), (pool[2], fin_ctc),
                          (pool[3], torch.full((B, R), t + 1, device=dev)),
                          (pool[4], alive_tok))
        pool_n2 = pool_n + torch.where(hit_cap, (fin_score > NEG_INF / 2).sum(1), 0)

        act = s["active"]

        def upd(name, new):
            s[name] = torch.where(act.reshape((B,) + (1,) * (new.ndim - 1)), new, s[name])

        upd("logp", logp2)
        upd("alive_score", alive_score)
        upd("alive_aed", alive_aed)
        upd("alive_tok", alive_tok)
        for i, name in enumerate(("pool_score", "pool_aed", "pool_ctc", "pool_len",
                                  "pool_tok")):
            fin = hit_cap.reshape((B,) + (1,) * (pool[i].ndim - 1))
            upd(name, torch.where(fin, pool2[i], pool[i]))
        upd("pool_n", torch.where(hit_cap, pool_n2, pool_n))
        if use_ctc:
            upd("r_state", r_sel)
            upd("alive_ctc", alive_ctc)
            upd("last_tok", torch.where(is_end, -1, tok))
        s["active"] = act & ~(beam_empty | early | hit_cap)

    s["caches"] = caches
    n_steps = reads = 0
    for t in range(n_iters):
        if t and t % ACTIVE_EVERY == 0:
            reads += 1
            if not bool(s["active"].any()):
                break
        step(t)
        n_steps += 1
    stats.update(steps=n_steps, iters=n_iters, host_reads=reads)
    return s


def _pool_top(P: int, score, *fields):
    """Concatenate the pool and the new entries ((old, new) pairs, scores
    first) and keep the top P by score -> (scores, *fields)."""
    ps = torch.cat(score, 1)
    val, idx = top_k(ps, P)
    out = [val]
    for old, new in fields:
        cat = torch.cat([old, new], 1)
        ix = idx if cat.ndim == 2 else idx[..., None].expand(-1, -1, cat.shape[2])
        out.append(cat.gather(1, ix))
    return out


def beam_search_device(aed, features, lengths, *, beam_size: int = 10, nbest: int = 1,
                       length_bonus: float = 0.0, pre_beam: int | None = None,
                       n_utts: int | None = None,
                       ctc_log_probs=None, blank_id: int | None = None,
                       ctc_weight: float = 0.0, lm=None, stats: dict | None = None
                       ) -> list[list[Hypothesis]]:
    """AED or joint CTC + AED n-best beam on the device of ``features`` [B,
    S, d] (the encoder's output); lengths [B] on the host. ``ctc_log_probs``
    [B, T, V+1] (on the same device) with ``ctc_weight`` > 0 turns on joint
    scoring. -> per-utterance ``Hypothesis`` lists for the first ``n_utts``
    rows, as ``lm_rescore`` takes them.

    ``lm`` (a ``CausalLMScorer``) scores the final pool in the same call:
    each pool hypothesis carries its sequence log-prob with eos in ``.lm``,
    and ``lm_rescore_batch`` uses it as is. ``stats`` (a dict) receives the
    steps run, the step bound and the host reads of the active mask."""
    lens = np.asarray(lengths).astype(np.int64)
    dev = features.device
    B = features.shape[0]
    n = int(n_utts) if n_utts is not None else B
    # the host search's caps min(max(1, ratio * T), T - 1, max_decode_len) at
    # its default ratio 1
    max_steps = np.minimum(np.maximum(lens - 1, 1), aed.max_decode_len)
    pre = min(aed.vocab_size, pre_beam if pre_beam else max(2 * beam_size, 15))
    use_ctc = ctc_weight > 0.0 and ctc_log_probs is not None
    # the step bound, bucketed as JAX buckets its trip count
    worst = int(max_steps[:n].max()) if n else 1
    n_iters = min(_pow2_bucket(worst), int(aed.max_decode_len))
    ctc_arg = None
    if use_ctc:
        lp = torch.as_tensor(ctc_log_probs).to(dev, torch.float32)
        T = lp.shape[1]
        # freeze the recursion past each utterance's frames: blank prob 1
        pad = torch.full((lp.shape[2],), CTC_LOG0, device=dev)
        pad[blank_id] = 0.0
        tmask = torch.arange(T, device=dev)[None, :, None] < torch.as_tensor(
            lens, device=dev)[:, None, None]
        ctc_arg = torch.where(tmask, lp, pad)
    run_stats: dict = {}
    with torch.inference_mode():
        out = _beam_scan(aed, features, lens.tolist(),
                         torch.as_tensor(max_steps, device=dev), ctc_arg,
                         beam_size=beam_size, nbest=nbest, length_bonus=float(length_bonus),
                         pre=pre, n_iters=n_iters, ctc_weight=ctc_weight if use_ctc else 0.0,
                         blank=int(blank_id) if use_ctc else 0, stats=run_stats)
        keep = ["alive_score", "alive_aed", "alive_tok", "pool_score", "pool_aed",
                "pool_ctc", "pool_len", "pool_tok"] + (["alive_ctc"] if use_ctc else [])
        out = {k: out[k].cpu().numpy() for k in keep}
    if stats is not None:
        stats.update(run_stats)

    results: list[list[Hypothesis]] = []
    for b in range(n):
        hyps: list[Hypothesis] = []
        for p in range(out["pool_score"].shape[1]):
            if out["pool_score"][b, p] > NEG_INF / 2:
                L = int(out["pool_len"][b, p])
                hyps.append(Hypothesis(tokens=out["pool_tok"][b, p, :L].tolist(),
                                       aed=float(out["pool_aed"][b, p]),
                                       ctc=float(out["pool_ctc"][b, p]),
                                       score=float(out["pool_score"][b, p])))
        if not hyps:                                     # the pool is empty: best alive
            for r in np.argsort(-out["alive_score"][b])[:nbest]:
                if out["alive_score"][b, r] > NEG_INF / 2:
                    hyps.append(Hypothesis(
                        tokens=out["alive_tok"][b, r, :int(max_steps[b])].tolist(),
                        aed=float(out["alive_aed"][b, r]),
                        ctc=float(out["alive_ctc"][b, r]) if use_ctc else 0.0,
                        score=float(out["alive_score"][b, r])))
        hyps.sort(key=lambda h: h.score, reverse=True)
        results.append(hyps[:nbest])
    if lm is not None:
        flat = [h for nb in results for h in nb]
        for h, s in zip(flat, lm.sequence_logprob([h.tokens for h in flat])):
            h.lm = float(s)
    return results


def aed_beam_search_device(aed, features, lengths, **kw) -> list[list[Hypothesis]]:
    """The pure-AED device beam: ``beam_search_device`` without CTC."""
    return beam_search_device(aed, features, lengths, **kw)
