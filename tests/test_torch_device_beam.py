"""The port's on-device searches against the JAX package's on the CPU, fp32:
the cached LM step (``_lm_step``), the frame-synchronous CTC prefix beam
with and without LM fusion, the joint beam's CTC prefix terms
(``_ctc_prefix_psi``, ``_ctc_advance_r``), the AED and joint beams with the
pool's LM scores, and the serving modes ``aed_ids`` / ``beam_ids``. Each is
held to JAX's device search and to the port's host search: tokens equal,
scores within 1e-4, LM step and pool LM scores within 1e-5. Weights are
seeded in JAX and carried across by ``convert.py``; inputs come from numpy
seeds. Sizes follow ``tests/test_device_ctc_beam.py`` and
``tests/test_decoders.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnet_mamba_asr_torch import convert
from hnet_mamba_asr_torch.decoders import device_beam, device_ctc_beam
from hnet_mamba_asr_torch.decoders.ctc_decode import ctc_prefix_beam_search
from hnet_mamba_asr_torch.decoders.joint import joint_beam_search_nbest
from hnet_mamba_asr_torch.decoders.lm_scorer import CausalLMScorer
from hnet_mamba_asr_torch.models.aed import AEDHead
from hnet_mamba_asr_torch.serving.runtime import ServingModel
from hnet_mamba_asr_torch.tasks.decode_task import CachedAEDStepper, _UttStepper
from hnet_mamba_asr_torch.tasks.lm_task import build_lm
from hnet_mamba_asr_tpu.decoders import device_beam as jdevice_beam
from hnet_mamba_asr_tpu.decoders import device_ctc_beam as jdevice_ctc
from hnet_mamba_asr_tpu.decoders import lm_scorer as jscorer
from hnet_mamba_asr_tpu.models import aed as jaed
from hnet_mamba_asr_tpu.tasks import asr_task as jtask
from hnet_mamba_asr_tpu.tasks import lm_task as jlm_task

from torch_parity import HYBRID_CONFIG, module_tree, ragged_waves, seeded_tree

STEP_TOL = 1e-5                 # LM step and pool LM log-probs
SCORE_TOL = 1e-4                # beam scores (float32 accumulation)
LM_CFG = {"lm_conf": {"d_model": 16, "n_layers": 2, "n_heads": 2, "d_ff": 32,
                      "dropout": 0.0}}
LM_V = 12


def _log_softmax(x):
    m = x.max(-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))


def _random_logp(rng, B, T, V1, scale=1.5):
    return _log_softmax(scale * rng.normal(size=(B, T, V1))).astype(np.float32)


@pytest.fixture(scope="module")
def lms():
    """One seeded LM in both packages, and both scorers."""
    jmodel = jlm_task.build_lm(LM_CFG, LM_V)
    params = seeded_tree(jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)), seed=2)
    model = build_lm(LM_CFG, LM_V, device="cpu")
    convert.load_jax_params(model, params)
    jlm = jscorer.CausalLMScorer(jmodel.lm, {"params": params["lm"]})
    return jmodel.lm, jlm, CausalLMScorer(model.lm)


def test_lm_step_matches_full_forward_and_jax(lms):
    """Chained per-row cached steps (rows advancing at different rates,
    masked writes) against the port's full forward (``next_logprobs``) and
    JAX's ``_lm_step`` on the same rows, within 1e-5."""
    jlm_model, jlm, lm = lms
    rows, cap = 3, 8
    pe = jnp.asarray(jaed.sinusoidal_pe(cap, jlm_model.d_model))
    jcaches = jdevice_ctc._lm_init_caches(jlm_model, rows, cap)
    caches = device_ctc_beam._lm_init_caches(lm.lm, rows, cap, "cpu")
    tokens = np.full(rows, 1, np.int64)
    pos = np.zeros(rows, np.int64)
    grow = np.ones(rows, bool)
    prefixes = [[], [], []]
    rng = np.random.default_rng(3)
    for step in range(6):
        want, jcaches = jdevice_ctc._lm_step(jlm_model, pe, jlm.lm_params, jcaches,
                                             jnp.asarray(tokens, jnp.int32),
                                             jnp.asarray(pos, jnp.int32), jnp.asarray(grow))
        with torch.no_grad():
            got, caches = device_ctc_beam._lm_step(lm.lm, caches, torch.from_numpy(tokens),
                                                   torch.from_numpy(pos),
                                                   torch.from_numpy(grow))
        got = got.numpy()
        full = lm.next_logprobs(prefixes)
        for r in np.flatnonzero(grow):
            np.testing.assert_allclose(got[r], np.asarray(want)[r], rtol=0, atol=STEP_TOL,
                                       err_msg=f"step {step} row {r} vs JAX")
            np.testing.assert_allclose(got[r], full[r], rtol=0, atol=STEP_TOL,
                                       err_msg=f"step {step} row {r} vs full forward")
        # row 0 grows every step, row 1 every second, row 2 never again
        grow = np.array([True, step % 2 == 0, False])
        tokens = rng.integers(4, LM_V, size=rows)
        for r in np.flatnonzero(grow):
            prefixes[r].append(int(tokens[r]))
        pos = np.array([len(p) for p in prefixes])


@pytest.mark.parametrize("seed", range(6))
def test_device_ctc_beam_matches_jax_and_host(seed):
    """No-LM transcripts on fuzzed batches equal JAX's device search and the
    port's host search, at (K, P) = (4, 5) and (8, 6)."""
    r = np.random.default_rng(seed)
    B, T, V1 = 5, 14, 7
    lp = _random_logp(r, B, T, V1)
    lens = np.array([T, T - 4, T - 1, 3, T - 7])
    for K, P in ((4, 5), (8, 6)):
        kw = dict(blank_id=V1 - 1, beam_size=K, pre_beam=P)
        got = device_ctc_beam.ctc_beam_search_device(lp, lens, **kw)
        assert got == jdevice_ctc.ctc_beam_search_device(lp, lens, **kw), (K, P)
        assert got == ctc_prefix_beam_search(lp, lens, **kw), (K, P)


def test_device_ctc_beam_peaked():
    """Near-deterministic frames (repeated labels, blank crossings, tied
    candidates): the three searches agree."""
    r = np.random.default_rng(11)
    B, T, V1 = 4, 12, 6
    path = r.integers(0, V1, size=(B, T))
    lp = np.full((B, T, V1), -8.0, np.float32)
    for b in range(B):
        lp[b, np.arange(T), path[b]] = -0.01
    lp = _log_softmax(lp).astype(np.float32)
    lens = np.array([T, T - 2, T - 5, 4])
    kw = dict(blank_id=V1 - 1, beam_size=4, pre_beam=4)
    got = device_ctc_beam.ctc_beam_search_device(lp, lens, **kw)
    assert got == jdevice_ctc.ctc_beam_search_device(lp, lens, **kw)
    assert got == ctc_prefix_beam_search(lp, lens, **kw)


@pytest.mark.parametrize("weight", [0.3, 0.8])
def test_device_ctc_beam_lm_matches_jax_and_host(lms, weight):
    """LM fusion inside the frame loop gives JAX's device transcripts and
    the host engine's batched fusion, on three seeds."""
    _, jlm, lm = lms
    for seed in (0, 1, 2):
        r = np.random.default_rng(100 + seed)
        B, T, V1 = 3, 10, LM_V + 1
        lp = _random_logp(r, B, T, V1)
        lens = np.array([T, T - 3, 5])
        kw = dict(blank_id=V1 - 1, beam_size=4, pre_beam=5, lm_weight=weight)
        got = device_ctc_beam.ctc_beam_search_device(lp, lens, lm=lm, **kw)
        assert got == jdevice_ctc.ctc_beam_search_device(lp, lens, lm=jlm, **kw), seed
        assert got == ctc_prefix_beam_search(lp, lens, lm=lm, **kw), seed


def test_device_ctc_beam_lm_requires_blank_last(lms):
    with pytest.raises(ValueError, match="blank at the last class"):
        device_ctc_beam.ctc_beam_search_device(np.zeros((1, 4, 11), np.float32),
                                               np.array([4]), blank_id=0, beam_size=2,
                                               pre_beam=3, lm=lms[2], lm_weight=0.5)


def test_device_ctc_beam_padded_rows():
    """n_utts < B: rows of length 0 are skipped; the real rows equal the host
    search's on the real rows alone."""
    lp = _random_logp(np.random.default_rng(5), 4, 9, 6)
    lens = np.array([9, 7, 0, 0])
    kw = dict(blank_id=5, beam_size=3, pre_beam=4)
    got = device_ctc_beam.ctc_beam_search_device(lp, lens, n_utts=2, **kw)
    assert got == jdevice_ctc.ctc_beam_search_device(lp, lens, n_utts=2, **kw)
    assert got == ctc_prefix_beam_search(lp[:2], lens[:2], **kw)


def test_ctc_prefix_terms_match_jax():
    """_ctc_prefix_psi and _ctc_advance_r on random forward states, padded
    frames and repeated labels, at steps 0, 1 and 5: within 1e-5 of JAX's
    (the psi of JAX's reduction form)."""
    rng = np.random.default_rng(7)
    B, R, T, W, C = 2, 3, 11, 7, 4
    lens = np.array([T, 8])
    lp = _random_logp(rng, B, T, W)
    pad = np.full(W, device_beam.CTC_LOG0, np.float32)
    pad[W - 1] = 0.0
    lp = np.where(np.arange(T)[None, :, None] < lens[:, None, None], lp, pad)
    r = np.stack([rng.normal(size=(B, R, T)) - 20, np.cumsum(lp[:, None, :, W - 1], -1)
                  .repeat(R, 1)], -1).astype(np.float32)
    # past an utterance's frames the state is frozen, as the search keeps it
    for b, n in enumerate(lens):
        r[b, :, n:, 1] = np.logaddexp(r[b, :, n - 1, 0], r[b, :, n - 1, 1])[:, None]
        r[b, :, n:, 0] = device_beam.CTC_LOG0
    cand = rng.integers(0, W - 1, size=(B, R, C))
    last = cand[:, :, 0].copy()
    last[:, 0] = -1
    tok = cand[:, :, 1]
    last_frame = torch.from_numpy(lens - 1)
    for t in (0, 1, 5):
        want_psi, want_eos = jdevice_beam._ctc_prefix_psi(
            jnp.asarray(lp), jnp.asarray(r), jnp.asarray(cand), jnp.asarray(last), t, W - 1)
        psi, eos_psi = device_beam._ctc_prefix_psi(
            torch.from_numpy(lp), torch.from_numpy(r), torch.from_numpy(cand),
            torch.from_numpy(last), t, last_frame)
        np.testing.assert_allclose(psi.numpy(), np.asarray(want_psi), rtol=STEP_TOL, atol=0)
        np.testing.assert_allclose(eos_psi.numpy(), np.asarray(want_eos), rtol=STEP_TOL,
                                   atol=0)
        want_r = np.asarray(jdevice_beam._ctc_advance_r(
            jnp.asarray(lp), jnp.asarray(r), jnp.asarray(tok), jnp.asarray(last), t, W - 1))
        got_r = device_beam._ctc_advance_r(torch.from_numpy(lp), torch.from_numpy(r),
                                           torch.from_numpy(tok), torch.from_numpy(last), t,
                                           W - 1).numpy()
        live = want_r > -1e9                         # log-0 entries: both below -1e9
        np.testing.assert_array_equal(got_r > -1e9, live)
        np.testing.assert_allclose(got_r[live], want_r[live], rtol=STEP_TOL, atol=0)


@pytest.fixture(scope="module")
def heads():
    """A tiny AED head in both packages (seeded in JAX), its memory and a
    CTC posterior over V + 1 classes."""
    rng = np.random.default_rng(0)
    V, DM, S, B = LM_V, 16, 9, 4
    jhead = jaed.AEDHead(vocab_size=V, d_model=DM, n_layers=2, n_heads=2, d_ff=32,
                         dropout=0.0, max_decode_len=8)
    mem = rng.normal(size=(B, S, DM)).astype(np.float32)
    mlens = np.asarray([S, S - 3, S - 1, S - 4])
    params = module_tree(jhead, jnp.asarray(mem), jnp.asarray(mlens),
                         jnp.zeros((B, 3), jnp.int32), seed=1)
    head = AEDHead(V, DM, n_layers=2, n_heads=2, d_ff=32, max_decode_len=8)
    head.load_state_dict(convert.jax_to_state_dict(params), strict=True)
    ctc_lp = _log_softmax(rng.normal(size=(B, S, V + 1)))
    return dict(jhead=jhead, params=params, head=head, mem=mem, mlens=mlens, V=V,
                ctc_lp=ctc_lp)


def _host_nbest(h, b, w, bonus):
    stepper = CachedAEDStepper(h["head"], torch.from_numpy(h["mem"]), h["mlens"],
                               beam_rows=3)
    lp = h["ctc_lp"][b:b + 1, :h["mlens"][b]] if w > 0 else None
    return joint_beam_search_nbest(
        None, h["mlens"][b:b + 1], ctc_log_probs=lp, vocab_size=h["V"], beam_size=3,
        ctc_weight=w, blank_id=h["V"], nbest=3, max_decode_len=8, length_bonus=bonus,
        aed_next_logprobs=_UttStepper(stepper, b))[0]


@pytest.mark.parametrize("w,bonus", [(0.0, 0.0), (0.0, 0.4), (0.3, 0.0), (0.5, 0.0),
                                     (0.3, 0.4)])
def test_device_beams_match_jax_and_host(heads, lms, w, bonus):
    """The AED beam (CTC weight 0) and the joint beam (0.3, 0.5), length
    bonus 0 and 0.4 (the cap survivors' finalization), 3-best with the
    pool's LM scores: JAX's device search's hypotheses (tokens equal, scores
    within 1e-4, pool LM within 1e-5) and the port's host search's."""
    h = heads
    _, jlm, lm = lms
    kw = dict(beam_size=3, nbest=3, length_bonus=bonus, ctc_weight=w, blank_id=h["V"])
    ctc = h["ctc_lp"] if w > 0 else None
    want = jdevice_beam.beam_search_device(
        h["jhead"], h["params"], jnp.asarray(h["mem"]), h["mlens"], ctc_log_probs=ctc,
        lm=jlm, **kw)
    stats = {}
    search = device_beam.beam_search_device if w > 0 else device_beam.aed_beam_search_device
    got = search(h["head"], torch.from_numpy(h["mem"]), h["mlens"],
                 ctc_log_probs=None if ctc is None else torch.from_numpy(ctc),
                 lm=lm, stats=stats, **kw)
    assert 1 <= stats["steps"] <= stats["iters"] == 8
    for b in range(len(h["mlens"])):
        assert [x.tokens for x in got[b]] == [x.tokens for x in want[b]], (w, bonus, b)
        for f in ("score", "aed", "ctc"):
            np.testing.assert_allclose([getattr(x, f) for x in got[b]],
                                       [getattr(x, f) for x in want[b]], rtol=0,
                                       atol=SCORE_TOL, err_msg=f)
        np.testing.assert_allclose([x.lm for x in got[b]], [x.lm for x in want[b]], rtol=0,
                                   atol=STEP_TOL)
        host = _host_nbest(h, b, w, bonus)
        assert [x.tokens for x in got[b]] == [x.tokens for x in host], (w, bonus, b)
        np.testing.assert_allclose([x.score for x in got[b]], [x.score for x in host],
                                   rtol=0, atol=SCORE_TOL)


def test_serving_aed_ids_and_beam_ids_match_jax():
    """ServingModel's aed_ids (the AED head's greedy decode) and beam_ids /
    beam_lens (the device CTC beam) against JAX's greedy_decode and
    device-beam ``beam_scan`` on the same encoder output; transcribe_ids
    takes the beam."""
    V = 12
    cfg = dict(HYBRID_CONFIG, aed_conf=dict(HYBRID_CONFIG["aed_conf"], max_decode_len=6))
    jmodel = jtask.build_model(cfg, V)
    params = seeded_tree(jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)), seed=9)
    wave, wave_lens = ragged_waves(np.random.default_rng(4), [6000, 4200, 2600])
    enc = jmodel.encode(params, {"wave": jnp.asarray(wave), "wave_lens": jnp.asarray(wave_lens)},
                        train=False)
    want_aed = np.asarray(jmodel.aed.apply({"params": params["aed"]}, enc.features,
                                           enc.lengths, method="greedy_decode"))
    lp = jmodel.ctc.apply({"params": params["ctc"]}, enc.features, method="log_probs")
    want_toks, want_lens = jdevice_ctc.beam_scan(lp, enc.lengths, beam_size=10, pre_beam=30,
                                                 blank_id=jmodel.ctc.blank_id)
    model = ServingModel(cfg, params, "cpu", emit=("aed_ids", "beam_ids"))
    out = model(wave, wave_lens)
    np.testing.assert_array_equal(out["aed_ids"], want_aed)
    np.testing.assert_array_equal(out["beam_lens"], np.asarray(want_lens))
    want_ids = [np.asarray(want_toks)[b, :int(want_lens[b])].tolist() for b in range(3)]
    assert [out["beam_ids"][b, :out["beam_lens"][b]].tolist() for b in range(3)] == want_ids
    assert model.transcribe_ids(wave, wave_lens) == want_ids
    aed_only = ServingModel(cfg, params, "cpu", emit=("aed_ids",))
    eos = aed_only.model.aed.eos_id
    assert aed_only.transcribe_ids(wave, wave_lens) == [
        (row[:row.index(eos)] if eos in row else row) for row in want_aed.tolist()]
