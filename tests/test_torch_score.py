"""The port's copies of the JAX package's host code against the originals,
on the same numpy inputs: metrics and scoring (``score_records``,
``bootstrap_split``, ``gate_check``), the BPE tokenizer, the synthetic tone
corpora (bitwise-equal waveforms) and the CMVN statistics, the CTC prefix
beam (+/- LM fusion), the joint CTC / AED beam (serial and lockstep) and the
LM rescoring. Hypotheses are equal and float64 scores within 1e-9."""
import json

import jax.numpy as jnp
import numpy as np
import pytest

from hnet_mamba_asr_torch.data import synthetic
from hnet_mamba_asr_torch.data.features import compute_cmvn
from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
from hnet_mamba_asr_torch.decoders import ctc_decode, joint
from hnet_mamba_asr_torch.eval import metrics, score
from hnet_mamba_asr_tpu.data import synthetic as jsynthetic
from hnet_mamba_asr_tpu.data.audio import read_audio
from hnet_mamba_asr_tpu.data.features import CMVNAccumulator
from hnet_mamba_asr_tpu.data.tokenizer import Tokenizer as JTokenizer
from hnet_mamba_asr_tpu.decoders import ctc_decode as jctc_decode
from hnet_mamba_asr_tpu.decoders import joint as jjoint
from hnet_mamba_asr_tpu.eval import metrics as jmetrics
from hnet_mamba_asr_tpu.eval import score as jscore
from hnet_mamba_asr_tpu.ops.melspec import log_mel_spectrogram as jlog_mel

SCORE_TOL = 1e-9
WORDS = ["the", "cat", "sat", "on", "a", "mat", "hat", "that's", "fat", "cats"]


def _texts(rng, n):
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 9)))) for _ in range(n)]


def _records(rng, n, wrong):
    refs = _texts(rng, n)
    out = []
    for i, r in enumerate(refs):
        words = r.split()
        if rng.random() < wrong:
            words = words[:-1] + ([] if rng.random() < 0.5 else ["Hat!", "x"])
        out.append({"id": f"u{i}", "ref": r, "hyp": " ".join(words),
                    "decode_s": 0.01 * (i + 1), "audio_s": 1.5})
    return out


def test_metrics_and_scoring_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a, b = (list(rng.integers(0, 4, size=int(rng.integers(0, 9)))) for _ in range(2))
        assert metrics.levenshtein_counts(a, b) == jmetrics.levenshtein_counts(a, b)
        assert metrics.edit_distance(a, b) == jmetrics.edit_distance(a, b)
    assert metrics.normalize_text(" The  CAT's, hat!") == jmetrics.normalize_text(
        " The  CAT's, hat!") == "the cat's hat"
    recs = {"ctc_greedy": _records(np.random.default_rng(1), 30, 0.3),
            "joint_beam": _records(np.random.default_rng(1), 30, 0.1)}
    refs, hyps = [r["ref"] for r in recs["ctc_greedy"]], [r["hyp"] for r in recs["ctc_greedy"]]
    for ours, theirs in ((metrics.word_error_rate, jmetrics.word_error_rate),
                         (metrics.char_error_rate, jmetrics.char_error_rate)):
        assert ours(refs, hyps).as_dict() == theirs(refs, hyps).as_dict()
    got = {c: score.score_records(r) for c, r in recs.items()}
    want = {c: jscore.score_records(r) for c, r in recs.items()}
    for c in recs:
        assert score.cell_summary(got[c]) == jscore.cell_summary(want[c])
        assert got[c]["utts"] == want[c]["utts"]
    utts = {c: got[c]["utts"] for c in recs}
    boot = score.bootstrap_split(utts, n_resamples=300, seed=4)
    assert boot == jscore.bootstrap_split(utts, n_resamples=300, seed=4)
    cells = {"test-clean": {c: score.cell_summary(got[c]) for c in recs}}
    for goal, cell in (({"sane_test_clean_wer_below": 12.0}, None),
                       ({"sane_test_clean_wer_below": 1.0}, "ctc_greedy"), (None, None),
                       ({"sane_test_clean_wer_below": 12.0}, "aed_beam")):
        gate = score.gate_check(cells, goal, gate_cell=cell)
        assert gate == jscore.gate_check(cells, goal, gate_cell=cell)
    splits = {"test-clean": {"cells": cells["test-clean"], "significance": boot}}
    assert score.format_report(splits, gate) == jscore.format_report(splits, gate)
    with pytest.raises(ValueError, match="different utterance sets"):
        score.check_same_utterances({"a": utts["ctc_greedy"], "b": utts["joint_beam"][1:]})


def test_tokenizer_matches_jax(tmp_path):
    """Same pieces, merges and ids on the tone text and on a richer text,
    and each package loads the other's model file."""
    tone = [" ".join(np.random.default_rng(i).choice(list("abcd"), size=4)) for i in range(20)]
    for lines, vocab, hard in ((tone, 12, False), (_texts(np.random.default_rng(2), 60), 30,
                                                   True)):
        tok = Tokenizer.train(lines, tmp_path / "port", vocab_size=vocab, hard_vocab_limit=hard)
        jtok = JTokenizer.train(lines, tmp_path / "jax", vocab_size=vocab,
                                hard_vocab_limit=hard)
        assert tok.pieces == jtok.pieces and tok.merges == jtok.merges
        for text in lines + ["cats that's mat zz"]:
            assert tok.encode(text, bos=True, eos=True) == jtok.encode(text, bos=True, eos=True)
            assert tok.decode(tok.encode(text)) == jtok.decode(jtok.encode(text))
        assert JTokenizer(tok.model_path).encode(lines[0]) == tok.encode(lines[0])
        assert (tok.bos_id, tok.eos_id, tok.pad_id, tok.blank_id) == (1, 2, 3, tok.vocab_size)


def test_synthetic_corpora_and_cmvn_match_jax(tmp_path):
    """Bitwise-equal WAV files and equal manifests from both builders, and the
    CMVN statistics of the port's frontend against the JAX package's
    accumulator (fp32 FFTs: 1e-4)."""
    got = synthetic.build_tone_corpus(tmp_path / "p", n_utts=6, dev_utts=2)
    want = jsynthetic.build_tone_corpus(tmp_path / "j", n_utts=6, dev_utts=2)
    for g, w in zip(got, want):
        assert g["text"] == w["text"] and g["frames"] == w["frames"]
        assert open(g["audio"], "rb").read() == open(w["audio"], "rb").read()
    tr, dv, ev = synthetic.build_tone_corpus_heldout(tmp_path / "hp", n_train=8, n_dev=2,
                                                     n_eval=2)
    jtr, jdv, jev = jsynthetic.build_tone_corpus_heldout(tmp_path / "hj", n_train=8, n_dev=2,
                                                         n_eval=2)
    for g, w in zip(tr + dv + ev, jtr + jdv + jev):
        assert g["text"] == w["text"]
        assert open(g["audio"], "rb").read() == open(w["audio"], "rb").read()
    for name in ("train-960", "dev-clean", "test-clean"):
        p, j = ((tmp_path / d / "manifests" / f"{name}.jsonl").read_text().splitlines()
                for d in ("p", "j"))
        assert [dict(json.loads(a), audio="") for a in p] == \
            [dict(json.loads(b), audio="") for b in j]
    manifest = tmp_path / "p" / "manifests" / "train-960.jsonl"
    cmvn = compute_cmvn(manifest, n_mels=20, device="cpu", out=tmp_path / "cmvn.npz")
    acc = CMVNAccumulator(n_mels=20)
    for e in got:
        wave, _ = read_audio(e["audio"])
        feats, flens = jlog_mel(jnp.asarray(wave[None].astype(np.float32)), n_mels=20)
        acc.update(np.asarray(feats[0]), [int(flens[0])])
    stats = acc.finalize()
    np.testing.assert_allclose(cmvn.mean, stats["mean"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(1.0 / cmvn.istd, stats["std"], rtol=1e-4)


class TableLM:
    """A deterministic numpy LM: next-token log-probs are a seeded function of
    the prefix (both packages' searches call it with the same prefixes)."""

    def __init__(self, V, seed=0):
        self.V, self.seed = V, seed

    def _row(self, prefix):
        rng = np.random.default_rng([self.seed, len(prefix), *prefix])
        z = rng.normal(size=self.V)
        return z - np.log(np.exp(z).sum())

    def next_logprobs(self, prefixes):
        return np.stack([self._row(list(p)) for p in prefixes]).astype(np.float32)

    def sequence_logprob(self, sequences):
        return np.array([sum(self._row(s[:k])[s[k]] for k in range(len(s)))
                         + self._row(s)[2] for s in sequences], np.float32)


def _ctc_logp(rng, B, T, V):
    z = rng.normal(size=(B, T, V + 1)) * 2.0
    z[..., V] += 1.5                                     # blank-heavy, as trained CTC is
    return (z - np.log(np.exp(z).sum(-1, keepdims=True))).astype(np.float32)


def test_ctc_prefix_beam_matches_jax():
    rng = np.random.default_rng(3)
    V, B, T = 9, 3, 14
    logp = _ctc_logp(rng, B, T, V)
    lens = np.array([14, 9, 5])
    for lm, w in ((None, 0.0), (TableLM(V), 0.4)):
        kw = dict(blank_id=V, beam_size=4, pre_beam=5, lm=lm, lm_weight=w)
        assert ctc_decode.ctc_prefix_beam_search(logp, lens, **kw) == \
            jctc_decode.ctc_prefix_beam_search(logp, lens, **kw)
    beam = {(): (0.0, -np.inf, 0.0), (3,): (-1.2, -0.7, -0.3)}
    rows = TableLM(V).next_logprobs([[], [3]])
    got = ctc_decode._advance_beam(beam, logp[0, 1].astype(np.float64), V, 5, 4, 0.4, rows,
                                   {(): 0, (3,): 1})
    want = jctc_decode._advance_beam(beam, logp[0, 1].astype(np.float64), V, 5, 4, 0.4, rows,
                                     {(): 0, (3,): 1})
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=SCORE_TOL)


class TableAED:
    """A deterministic AED next-token scorer for the beams: the serial
    function protocol and the lockstep batch protocol."""

    def __init__(self, V, seed=1):
        self.V, self.seed = V, seed

    def row(self, b, tokens):
        rng = np.random.default_rng([self.seed, b, len(tokens), *tokens])
        z = rng.normal(size=self.V) * 1.5
        z[2] += 0.2 * len(tokens)                        # eos grows likelier
        return z - np.log(np.exp(z).sum())

    def __call__(self, b, token_lists):
        return np.stack([self.row(b, t) for t in token_lists])


class LockstepAED:
    """The batch protocol over TableAED, tracking each row's tokens."""

    def __init__(self, table, B, R):
        self.table, self.B, self.R = table, B, R

    def start(self):
        self.toks = [[[] for _ in range(self.R)] for _ in range(self.B)]
        return np.stack([self.table(b, [[]]) for b in range(self.B)])

    def advance(self, parents, tokens):
        n, r = parents.shape
        self.toks = [[self.toks[b][int(parents[b, j])] + [int(tokens[b, j])]
                      for j in range(r)] for b in range(n)]
        return np.stack([self.table(b, self.toks[b]) for b in range(n)])


def _same_nbest(got, want):
    assert len(got) == len(want)
    for g_utt, w_utt in zip(got, want):
        assert [h.tokens for h in g_utt] == [h.tokens for h in w_utt]
        for g, w in zip(g_utt, w_utt):
            np.testing.assert_allclose([g.aed, g.ctc, g.score], [w.aed, w.ctc, w.score],
                                       rtol=0, atol=SCORE_TOL)


def test_joint_beam_and_rescoring_match_jax():
    """The joint beam (pure AED, joint, positive length bonus to the cap)
    serial and lockstep, the CTC prefix scorer, and the LM rescoring."""
    rng = np.random.default_rng(5)
    V, B, T = 10, 3, 12
    logp = _ctc_logp(rng, B, T, V + 0)[..., :V + 1]
    lens = np.array([12, 8, 6])
    table = TableAED(V)
    for ctc_w, bonus in ((0.0, 0.0), (0.3, 0.0), (0.3, 0.5)):
        kw = dict(vocab_size=V, beam_size=3, ctc_weight=ctc_w, blank_id=V, pre_beam=4,
                  nbest=3, length_bonus=bonus, max_decode_len=7,
                  ctc_log_probs=logp if ctc_w else None)
        got = joint.joint_beam_search_nbest(None, lens, aed_next_logprobs=table, **kw)
        want = jjoint.joint_beam_search_nbest(None, lens, aed_next_logprobs=table, **kw)
        _same_nbest(got, want)
        lock = joint.joint_beam_search_nbest_lockstep(
            lens, batch_stepper=LockstepAED(table, B, 3), **kw)
        _same_nbest(lock, want)
        lm = TableLM(V, seed=7)
        for w in (0.0, 0.6):
            batch = joint.lm_rescore_batch(got, lm, w, ctc_weight=ctc_w, length_bonus=2.0)
            assert batch == jjoint.lm_rescore_batch(want, lm, w, ctc_weight=ctc_w,
                                                    length_bonus=2.0)
            assert batch == [joint.lm_rescore(nb, lm, w, ctc_weight=ctc_w, length_bonus=2.0)
                             for nb in got]
    sc = joint.CTCPrefixScorer(logp[0], V, 2)
    jsc = jjoint.CTCPrefixScorer(logp[0], V, 2)
    state = sc.initial_state()
    np.testing.assert_array_equal(state, jsc.initial_state())
    for prefix in ([], [4], [4, 4]):
        cand = np.array([1, 4, 2, 7])
        g, gs = sc.score(prefix, cand, state)
        w, ws = jsc.score(prefix, cand, state)
        np.testing.assert_allclose(g, w, rtol=0, atol=SCORE_TOL)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_TOL)
        state = gs[1]
