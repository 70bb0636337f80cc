"""Joint CTC + AED one-pass label-synchronous beam (Watanabe et al.) and
second-pass LM rescoring, counterpart of ``hnet_mamba_asr_tpu/decoders/joint.py``
(the port keeps its own copy; host numpy in float64, without the JAX
package's C++ prefix scorer, whose results are bit-equal to the numpy one).

Every partial hypothesis carries its CTC prefix score (the Graves forward
recursion over the blank / label lattice), combined as

    score(h) = (1 - ctc_weight) * logP_AED(h) + ctc_weight * logP_CTC-prefix(h)
               + length_bonus * len(h)

``ctc_weight = 0`` is the pure AED beam. The external LM enters as a second
pass (``lm_rescore``) that re-ranks the completed n-best. Early stop is sound
only with ``length_bonus <= 0``; with a positive bonus the search runs to the
cap and survivors are finalized with their own eos score. Two drivers share
one per-utterance engine (``_UttBeam``): ``joint_beam_search_nbest`` walks
utterances in turn, and ``joint_beam_search_nbest_lockstep`` advances every
utterance's beam together, so that each global step is ONE batched device
call over B x beam rows; per-utterance results are the same by construction.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

LOG_ZERO = -1e10


class CTCPrefixScorer:
    """Incremental CTC prefix log-prob for growing label prefixes (one utt).

    Host-side in fp64. Per prefix the carried state is two per-frame
    masses, ``rl[t]`` = log p(lattice paths through frame t that spell the
    prefix and end on its LAST LABEL) and ``rb[t]`` = the same but ending on
    blank (packed [T, 2] label-major). ``score`` grows one prefix by C
    candidate labels at once and returns

      - the SELECTION mass  psi(c) = sum over frames of
        (parent mass available at t-1 for entering c) + emit(t, c)
        — a pure reduction, no dependence on the child's own state — and
      - the C advanced [T, 2] states for whichever candidates survive.

    The JAX package validates it against a brute-force alignment
    enumerator (tests/test_decoders.py); tests/test_torch_score.py holds
    this copy to it.
    """

    def __init__(self, logp, blank_id: int, eos_id: int):
        self.logp = np.ascontiguousarray(logp, dtype=np.float64)   # [T, V+1]
        self.T = self.logp.shape[0]
        self.blank = blank_id
        self.eos = eos_id

    def initial_state(self) -> np.ndarray:
        """Empty prefix: all mass rides the all-blank path (rl ≡ log 0)."""
        state = np.full((self.T, 2), LOG_ZERO)
        state[:, 1] = np.cumsum(self.logp[:, self.blank])
        return state

    def score(self, prefix: list[int], cand_ids, r_prev: np.ndarray):
        """-> (scores [C], states [C, T, 2]) for each candidate extension."""
        cand = np.asarray(cand_ids, dtype=np.int64)
        T, C = self.T, cand.shape[0]
        plen = len(prefix)

        # per-candidate emission ladder; an eos candidate has no CTC class —
        # clamp its gather, psi for eos is overridden at the end
        emit = self.logp[:, np.minimum(cand, self.logp.shape[1] - 1)]  # [T,C]

        # parent mass reachable at each frame, and the "growth source" the
        # device engine calls phi: entering candidate c at frame t consumes
        # the parent's TOTAL mass at t-1 — unless c repeats the prefix's last
        # label, where CTC demands an intervening blank, so only the
        # blank-ending component may feed it
        pmass = np.logaddexp(r_prev[:, 0], r_prev[:, 1])               # [T]
        rep = (cand == prefix[-1]) if plen > 0 else np.zeros(C, bool)
        phi = np.where(rep[None, :], r_prev[:, 1:2], pmass[:, None])   # [T,C]

        # a grown prefix needs >= plen frames before its new label can land;
        # frame 0 itself is reachable only from the empty prefix
        t0 = max(plen, 1)
        rl = np.full((T, C), LOG_ZERO)                 # child ends-on-label
        rb = np.full((T, C), LOG_ZERO)                 # child ends-on-blank
        if plen == 0:
            rl[0] = emit[0]
        stay_blank = self.logp[:, self.blank]
        for t in range(t0, T):
            # child advance: its label column re-emits (rl) or fresh mass
            # enters from the parent (phi); blanks extend either ending
            rl[t] = np.logaddexp(rl[t - 1], phi[t - 1]) + emit[t]
            rb[t] = np.logaddexp(rl[t - 1], rb[t - 1]) + stay_blank[t]

        # selection mass psi: the frame-entry contributions form a ladder
        # folded in frame order (a left fold); seed with the frame-(t0-1)
        # label mass, i.e. emit[0] when the prefix was empty
        ladder = np.concatenate([rl[t0 - 1][None],
                                 phi[t0 - 1:T - 1] + emit[t0:T]], axis=0)
        psi = np.logaddexp.reduce(ladder, axis=0)                      # [C]

        # growing by eos closes the sequence: its mass is the parent's own
        # full-utterance mass, not an emission sum
        ends = cand == self.eos
        if ends.any():
            psi = np.where(ends, pmass[-1], psi)
        states = np.stack([rl, rb], axis=-1)           # [T, C, 2]
        return psi, np.ascontiguousarray(states.transpose(1, 0, 2))


@dataclass
class Hypothesis:
    tokens: list[int]
    aed: float                                  # cumulative AED log-prob (incl. eos)
    ctc: float                                  # absolute CTC prefix log-prob
    ctc_state: np.ndarray | None = None
    score: float = field(default=0.0)           # acoustic combination + bonus
    lm: float | None = None                     # fused full-sequence LM log-prob
                                                # (device beam scores the pool
                                                # in-program; None = not scored)


def joint_beam_search_nbest(memory, memory_lengths, *, aed_next_logprobs,
                            ctc_log_probs=None, vocab_size: int,
                            beam_size: int = 10, ctc_weight: float = 0.3,
                            bos_id: int = 1, eos_id: int = 2, pad_id: int = 3,
                            blank_id: int | None = None, max_len_ratio: float = 1.0,
                            length_bonus: float = 0.0, pre_beam: int | None = None,
                            nbest: int = 1, max_decode_len: int = 512
                            ) -> list[list[Hypothesis]]:
    """Acoustic-only joint beam; returns the top-nbest COMPLETE hypotheses per
    utterance (best first), each keeping its AED/CTC components for rescoring.

    - ``aed_next_logprobs``: either a function ``(b, token_lists) -> [n, V]``
      (next-token log-softmax for each hypothesis' bare tokens; full
      recompute), or a STATEFUL stepper exposing ``start(b) -> [1, V]`` and
      ``advance(parents, tokens) -> [n, V]`` — the KV-cached incremental
      protocol (tasks/decode_task.CachedAEDStepper): the beam is label-
      synchronous, so each step commits one (parent row, token) per surviving
      hypothesis and costs one incremental attention instead of a full
      decoder re-run.
    - ``ctc_log_probs``: [B, T, V+1] device/numpy array, or None when
      ctc_weight == 0 (pure AED beam).
    """
    lens = np.asarray(memory_lengths)
    B = lens.shape[0]
    use_ctc = ctc_weight > 0.0 and ctc_log_probs is not None
    if use_ctc and blank_id is None:
        blank_id = vocab_size
    lp_all = np.asarray(ctc_log_probs, dtype=np.float64) if use_ctc else None
    stateful = hasattr(aed_next_logprobs, "start") \
        and hasattr(aed_next_logprobs, "advance")
    engine_kw = dict(vocab_size=vocab_size, beam_size=beam_size,
                     ctc_weight=ctc_weight, bos_id=bos_id, eos_id=eos_id,
                     pad_id=pad_id, max_len_ratio=max_len_ratio,
                     length_bonus=length_bonus, pre_beam=pre_beam, nbest=nbest,
                     max_decode_len=max_decode_len)
    results: list[list[Hypothesis]] = []
    for b in range(B):
        Tf = int(lens[b])
        scorer = CTCPrefixScorer(lp_all[b, :Tf], blank_id, eos_id) if use_ctc else None
        engine = _UttBeam(Tf, scorer, **engine_kw)
        first = True
        while engine.state != "done":
            if stateful:
                raw = (aed_next_logprobs.start(b) if first
                       else aed_next_logprobs.advance(*engine.request()))
            else:
                raw = aed_next_logprobs(b, [h.tokens for h in engine.beam])
            first = False
            engine.consume(np.asarray(raw, dtype=np.float64))
        results.append(engine.result())
    return results


class _UttBeam:
    """One utterance's label-synchronous beam as an explicit state machine.

    ``state`` walks running -> [need_final] -> done; ``consume(aed_lp)`` takes
    next-token log-probs for the CURRENT beam rows (expansion step, or the
    final eos-scoring pass when state == need_final) and ``request()`` yields
    the (parents, tokens) pairs a KV-cached stepper must commit before the
    next consume. Both the serial and the lockstep drivers run this engine,
    so batching across utterances cannot change per-utterance results.
    """

    def __init__(self, Tf: int, scorer, *, vocab_size: int, beam_size: int,
                 ctc_weight: float, bos_id: int, eos_id: int, pad_id: int,
                 max_len_ratio: float, length_bonus: float,
                 pre_beam: int | None, nbest: int, max_decode_len: int):
        self.scorer = scorer
        self.use_ctc = scorer is not None
        self.beam_size = beam_size
        self.ctc_weight = ctc_weight
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.length_bonus = length_bonus
        self.nbest = nbest
        self.pre = min(vocab_size,
                       pre_beam if pre_beam is not None else max(2 * beam_size, 15))
        self.max_steps = min(max(1, int(max_len_ratio * Tf)), Tf - 1,
                             max_decode_len)
        self.beam = [Hypothesis(tokens=[], aed=0.0, ctc=0.0,
                                ctc_state=(scorer.initial_state()
                                           if self.use_ctc else None))]
        self.ended: list[Hypothesis] = []
        self.steps_done = 0
        self.state = "running"
        self._parents: list[int] = []
        self._tokens: list[int] = []

    def request(self) -> tuple[list[int], list[int]]:
        """(parent rows, committed tokens) the stepper must apply before the
        next consume — identity for the very first step (handled by start)."""
        return self._parents, self._tokens

    def consume(self, aed_lp: np.ndarray) -> None:
        if self.state == "need_final":
            self._finalize(aed_lp)
            return
        aed_lp = aed_lp.copy()
        aed_lp[:, self.bos_id] = LOG_ZERO          # finite: no 0*inf NaN
        aed_lp[:, self.pad_id] = LOG_ZERO
        expansions: list[tuple[float, bool, Hypothesis, int, int]] = []
        for i, h in enumerate(self.beam):
            top = np.argpartition(aed_lp[i], -self.pre)[-self.pre:]
            ids = np.unique(np.concatenate([top, [self.eos_id]]))
            ids = ids[(ids != self.bos_id) & (ids != self.pad_id)]
            if self.use_ctc:
                ctc_scores, ctc_states = self.scorer.score(h.tokens, ids,
                                                           h.ctc_state)
            for j, c in enumerate(ids.tolist()):
                ends = c == self.eos_id
                toks = h.tokens if ends else h.tokens + [c]
                aed_c = h.aed + float(aed_lp[i, c])
                ctc_c = float(ctc_scores[j]) if self.use_ctc else 0.0
                total = ((1.0 - self.ctc_weight) * aed_c
                         + self.ctc_weight * ctc_c
                         + self.length_bonus * len(toks))
                expansions.append((total, ends, Hypothesis(
                    tokens=toks, aed=aed_c, ctc=ctc_c,
                    ctc_state=(ctc_states[j] if (self.use_ctc and not ends)
                               else None),
                    score=total), i, c))
        expansions.sort(key=lambda e: e[0], reverse=True)
        self.beam = []
        self._parents, self._tokens = [], []
        for _total, ends, hyp, parent, tok in expansions[:self.beam_size]:
            if ends:
                self.ended.append(hyp)
            else:
                self.beam.append(hyp)
                self._parents.append(parent)
                self._tokens.append(tok)
        self.steps_done += 1
        if not self.beam:
            self.state = "done"
            return
        # sound early stop (length_bonus <= 0): partial scores only fall as
        # they grow, so once the best partial can't beat the nbest-th
        # completion no future completion can enter the top-nbest.
        if (self.length_bonus <= 0.0 and len(self.ended) >= self.nbest):
            nth_best = sorted((e.score for e in self.ended),
                              reverse=True)[self.nbest - 1]
            if max(x.score for x in self.beam) <= nth_best:
                self.state = "done"
                return
        if self.steps_done >= self.max_steps:
            # cap reached with survivors (possible when length_bonus > 0 keeps
            # partials rising): they still need their own eos score so they
            # compete — otherwise a survivor is silently discarded.
            self.state = "need_final"

    def _finalize(self, aed_lp: np.ndarray) -> None:
        eos_arr = np.asarray([self.eos_id])
        for i, h in enumerate(self.beam):
            aed_c = h.aed + float(aed_lp[i, self.eos_id])
            ctc_c = (float(self.scorer.score(h.tokens, eos_arr,
                                             h.ctc_state)[0][0])
                     if self.use_ctc else 0.0)
            self.ended.append(Hypothesis(
                tokens=h.tokens, aed=aed_c, ctc=ctc_c,
                score=((1.0 - self.ctc_weight) * aed_c
                       + self.ctc_weight * ctc_c
                       + self.length_bonus * len(h.tokens))))
        self.state = "done"

    def result(self) -> list[Hypothesis]:
        pool = self.ended if self.ended else self.beam
        return sorted(pool, key=lambda x: x.score, reverse=True)[:self.nbest]


def joint_beam_search_nbest_lockstep(memory_lengths, *, batch_stepper,
                                     ctc_log_probs=None, vocab_size: int,
                                     beam_size: int = 10, ctc_weight: float = 0.3,
                                     bos_id: int = 1, eos_id: int = 2,
                                     pad_id: int = 3, blank_id: int | None = None,
                                     max_len_ratio: float = 1.0,
                                     length_bonus: float = 0.0,
                                     pre_beam: int | None = None, nbest: int = 1,
                                     max_decode_len: int = 512
                                     ) -> list[list[Hypothesis]]:
    """All utterances' beams advance in LOCKSTEP: every global step makes ONE
    batched device call covering B x beam rows (``batch_stepper`` protocol:
    ``start() -> [B, 1, V]``, ``advance(parents [B, R], tokens [B, R]) ->
    [B, R, V]``). Per-utterance results are IDENTICAL to the serial search —
    both drivers run the same _UttBeam engine (equivalence-tested)."""
    lens = np.asarray(memory_lengths)
    B = lens.shape[0]
    use_ctc = ctc_weight > 0.0 and ctc_log_probs is not None
    if use_ctc and blank_id is None:
        blank_id = vocab_size
    lp_all = np.asarray(ctc_log_probs, dtype=np.float64) if use_ctc else None
    engines = []
    for b in range(B):
        Tf = int(lens[b])
        scorer = CTCPrefixScorer(lp_all[b, :Tf], blank_id, eos_id) if use_ctc else None
        engines.append(_UttBeam(
            Tf, scorer, vocab_size=vocab_size, beam_size=beam_size,
            ctc_weight=ctc_weight, bos_id=bos_id, eos_id=eos_id, pad_id=pad_id,
            max_len_ratio=max_len_ratio, length_bonus=length_bonus,
            pre_beam=pre_beam, nbest=nbest, max_decode_len=max_decode_len))

    R = beam_size
    lp = np.asarray(batch_stepper.start())           # [B, 1, V]
    for b, eng in enumerate(engines):
        eng.consume(lp[b, :1].astype(np.float64))
    while any(eng.state != "done" for eng in engines):
        parents = np.zeros((B, R), np.int32)
        tokens = np.full((B, R), eos_id, np.int32)
        rows_used = []
        for b, eng in enumerate(engines):
            if eng.state == "done":
                rows_used.append(0)
                continue
            p, t = eng.request()
            parents[b, :len(p)] = p
            tokens[b, :len(t)] = t
            rows_used.append(len(p))
        lp = np.asarray(batch_stepper.advance(parents, tokens))   # [B, R, V]
        for b, eng in enumerate(engines):
            if eng.state != "done":
                eng.consume(lp[b, :rows_used[b]].astype(np.float64))
    return [eng.result() for eng in engines]


def lm_rescore_batch(nbests: list[list[Hypothesis]], lm, lm_weight: float, *,
                     ctc_weight: float, length_bonus: float = 0.0
                     ) -> list[list[int]]:
    """lm_rescore over a whole batch with ONE LM call: every utterance's
    n-best flattens into a single sequence_logprob, then the per-utterance
    re-rank is identical to lm_rescore (same formula, same tie behavior).
    Hypotheses already carrying a fused ``.lm`` score (device beam with
    lm=...) are used as-is — only unscored ones pay the LM call."""
    flat = [h for nb in nbests for h in nb]
    if not flat:
        return [[] for _ in nbests]
    lm_scores = np.asarray([h.lm if h.lm is not None else 0.0 for h in flat])
    need = [i for i, h in enumerate(flat) if h.lm is None]
    if need:
        lm_scores[need] = np.asarray(
            lm.sequence_logprob([flat[i].tokens for i in need]))
    out: list[list[int]] = []
    k = 0
    for nb in nbests:
        if not nb:
            out.append([])
            continue
        best, best_score = nb[0], float("-inf")
        for h, lms in zip(nb, lm_scores[k:k + len(nb)].tolist()):
            s = ((1.0 - ctc_weight) * h.aed + ctc_weight * h.ctc
                 + lm_weight * lms + length_bonus * len(h.tokens))
            if s > best_score:
                best_score, best = s, h
        k += len(nb)
        out.append(best.tokens)
    return out


def lm_rescore(nbest: list[Hypothesis], lm, lm_weight: float, *, ctc_weight: float,
               length_bonus: float = 0.0) -> list[int]:
    """Second-pass re-rank of a COMPLETE n-best by

        S(h) = (1-ctc_weight)*AED + ctc_weight*CTC + lm_weight*logP_LM(h) +
               length_bonus*len

    where logP_LM includes the terminal eos (``lm.sequence_logprob``). The
    acoustic term reproduces the beam's own score, so lm_weight=0 returns the
    acoustic best. Returns bare ids."""
    if not nbest:
        return []
    lm_scores = np.asarray([h.lm if h.lm is not None else 0.0 for h in nbest])
    need = [i for i, h in enumerate(nbest) if h.lm is None]
    if need:
        lm_scores[need] = np.asarray(
            lm.sequence_logprob([nbest[i].tokens for i in need]))
    best, best_score = nbest[0], float("-inf")
    for h, lms in zip(nbest, lm_scores.tolist()):
        s = ((1.0 - ctc_weight) * h.aed + ctc_weight * h.ctc
             + lm_weight * lms + length_bonus * len(h.tokens))
        if s > best_score:
            best_score, best = s, h
    return best.tokens
