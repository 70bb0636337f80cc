"""The port's RNN-T family against the JAX package on the CPU, fp32: the plain
transducer loss (values and gradients, a feat_length 0 row, the fp64
numpy lattice oracle), the head's loss and greedy search, the three-head
``loss_fn`` with every gradient, the host beam with and without LM fusion,
the device beam against the host beam, the rnnt decode cells against JAX's
``decode_batch``, and the serving modes ``rnnt_ids`` / ``rnnt_beam_ids``.
Weights are seeded in JAX and carried across by ``convert.py``; inputs come
from numpy seeds. The lattice kernels themselves run on the card only
(``tests/test_torch_cuda.py``)."""
import copy
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnet_mamba_asr_torch import convert
from hnet_mamba_asr_torch.data.dataset import collate_batch
from hnet_mamba_asr_torch.decoders import device_rnnt_beam
from hnet_mamba_asr_torch.decoders.lm_scorer import CausalLMScorer
from hnet_mamba_asr_torch.decoders.rnnt_decode import rnnt_beam_search
from hnet_mamba_asr_torch.models.rnnt import RNNTHead, rnnt_host_greedy
from hnet_mamba_asr_torch.ops.rnnt_cuda import rnnt_loss_cuda
from hnet_mamba_asr_torch.ops.rnnt_loss import rnnt_loss
from hnet_mamba_asr_torch.serving.runtime import ServingModel
from hnet_mamba_asr_torch.serving.server import MicroBatcher
from hnet_mamba_asr_torch.tasks import decode_task
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_torch.tasks.lm_task import build_lm
from hnet_mamba_asr_tpu.decoders import lm_scorer as jscorer
from hnet_mamba_asr_tpu.decoders import rnnt_decode as jrnnt_decode
from hnet_mamba_asr_tpu.models import rnnt as jrnnt
from hnet_mamba_asr_tpu.ops import rnnt_loss as jrnnt_loss
from hnet_mamba_asr_tpu.tasks import asr_task as jtask
from hnet_mamba_asr_tpu.tasks import decode_task as jdecode
from hnet_mamba_asr_tpu.tasks import lm_task as jlm_task

from torch_parity import HYBRID_CONFIG, ragged_waves, seeded_tree

# fp32 on both sides, summation order only: the loss to 1e-5 relative, its
# gradients to 1e-5 absolute (each is a probability, at most 1 in size);
# head and model gradients to 1e-4 of each leaf's max, as tests/test_torch_train.py
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5
LEAF_TOL = 1e-4
SCORE_TOL = 1e-4                # beam scores: float32 accumulation against float64
LM_TOL = 1e-5                   # LM log-probs, the cached step against the full forward
V = 6                           # the JAX tests' transducer vocabulary
D = 10
HEAD_KW = dict(vocab_size=V, d_memory=D, d_pred=8, d_joint=16, context=2, max_symbols=3,
               max_decode_len=24)
LM_CFG = {"lm_conf": {"d_model": 16, "n_layers": 1, "n_heads": 2, "d_ff": 32, "dropout": 0.0}}
# the narrow hybrid model with all three heads
RNNT_CONFIG = dict(copy.deepcopy(HYBRID_CONFIG),
                   model_conf={"ctc_weight": 0.3, "aed_weight": 0.7, "rnnt_weight": 1.0,
                               "lsm_weight": 0.1},
                   rnnt_conf={"d_pred": 8, "d_joint": 16, "max_decode_len": 24})
MODEL_V = 12


def _np_oracle(logits, T_b, y, U_b, blank):
    """The Graves lattice in fp64 numpy (tests/test_rnnt.py's oracle)."""
    lp = np.asarray(logits, np.float64)
    lp = lp - lp.max(-1, keepdims=True)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    alpha = np.full((T_b, U_b + 1), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(T_b):
        for u in range(U_b + 1):
            if t == 0 and u == 0:
                continue
            a = alpha[t - 1, u] + lp[t - 1, u, blank] if t else -np.inf
            c = alpha[t, u - 1] + lp[t, u - 1, y[u - 1]] if u else -np.inf
            alpha[t, u] = np.logaddexp(a, c)
    return -(alpha[T_b - 1, U_b] + lp[T_b - 1, U_b, blank])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _head(params) -> RNNTHead:
    head = RNNTHead(**HEAD_KW)
    head.load_state_dict(convert.jax_to_state_dict(params), strict=True)
    return head


@pytest.fixture(scope="module")
def heads():
    """A JAX RNNTHead with seeded params per seed, its port, and seeded memory."""
    jhead = jrnnt.RNNTHead(**HEAD_KW)
    out = []
    for seed in range(3):
        r = np.random.default_rng(70 + seed)
        B, T = 3, 8
        mem = (r.normal(size=(B, T, D)) * 1.5).astype(np.float32)
        lens = np.array([T, 6, 3], np.int32)
        shapes = jax.eval_shape(partial(jhead.init, method="loss"), jax.random.PRNGKey(0),
                                jnp.asarray(mem), jnp.asarray(lens),
                                jnp.zeros((B, 3), jnp.int32), jnp.full((B,), 3))
        params = seeded_tree(shapes["params"], seed)
        out.append((jhead, params, _head(params), mem, lens))
    return out


@pytest.fixture(scope="module")
def lms():
    """One seeded LM over the transducer's vocabulary in both packages."""
    jmodel = jlm_task.build_lm(LM_CFG, V)
    params = seeded_tree(jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)), seed=3)
    model = build_lm(LM_CFG, V, device="cpu")
    convert.load_jax_params(model, params)
    return jscorer.CausalLMScorer(jmodel.lm, {"params": params["lm"]}), CausalLMScorer(model.lm)


# ---- the loss ---------------------------------------------------------------------
def test_plain_rnnt_loss_matches_jax_and_the_oracle():
    """tests/test_rnnt.py's case (B 3 T 7 U 4 V 6) plus a feat_length 0 row:
    values and gradients against JAX's rnnt_loss, values against the fp64
    lattice; the empty row is finite and equals its feat_length 1 value."""
    rng = np.random.default_rng(0)
    B, T, U, Vc = 4, 7, 4, 6
    logits = rng.normal(size=(B, T, U + 1, Vc)).astype(np.float32)
    feat = np.array([T, 5, 3, 0], np.int32)
    targets = rng.integers(0, Vc - 1, size=(B, U)).astype(np.int32)
    tlen = np.array([U, 2, 3, 2], np.int32)
    g = rng.normal(size=B).astype(np.float32)

    def jloss(lg):
        return jrnnt_loss.rnnt_loss(lg, jnp.asarray(feat), jnp.asarray(targets),
                                    jnp.asarray(tlen), blank_id=Vc - 1, reduction="none")
    want = np.asarray(jloss(jnp.asarray(logits)))
    want_g = np.asarray(jax.grad(lambda lg: (jloss(lg) * jnp.asarray(g)).sum())(
        jnp.asarray(logits)))
    x = torch.tensor(logits, requires_grad=True)
    got = rnnt_loss_cuda(x, torch.from_numpy(feat), torch.from_numpy(targets),
                         torch.from_numpy(tlen), blank_id=Vc - 1, reduction="none")
    (got_g,) = torch.autograd.grad(got, x, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=GRAD_ATOL)
    assert np.isfinite(got.detach().numpy()).all() and np.isfinite(got_g.numpy()).all()
    for b in range(3):
        np.testing.assert_allclose(got[b].item(), _np_oracle(logits[b], feat[b], targets[b],
                                                              tlen[b], Vc - 1), rtol=LOSS_RTOL)
    one = rnnt_loss(torch.from_numpy(logits[3:]), torch.tensor([1]),
                    torch.from_numpy(targets[3:]), torch.from_numpy(tlen[3:]),
                    blank_id=Vc - 1, reduction="none")
    assert got[3].item() == one.item()
    for red in ("mean", "sum"):
        r = rnnt_loss(torch.from_numpy(logits), torch.from_numpy(feat),
                      torch.from_numpy(targets), torch.from_numpy(tlen), blank_id=Vc - 1,
                      reduction=red)
        np.testing.assert_allclose(r.item(), getattr(want, red)(), rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="reduction"):
        rnnt_loss(torch.from_numpy(logits), torch.from_numpy(feat), torch.from_numpy(targets),
                  torch.from_numpy(tlen), blank_id=Vc - 1, reduction="max")


def test_lattice_check_holds_the_mass_and_rejects_planted_faults():
    """The check the card holds the loss kernels to (``measure.rnnt_check``),
    on the CPU with the plain pair's fp64 results rounded to fp32 as the
    result under test (``tests/test_torch_rnnt_fused.py`` holds the plain
    pair to JAX): they conserve the alignment mass (each frame's cb and
    each label's cl sum to -g_b), each cell's dlogits sum to 0, and they
    pass the check, a feat_length 0 row, an empty target and pad columns
    included; each planted fault of ``measure.rnnt_faults`` is rejected."""
    from hnet_mamba_asr_torch.ops.rnnt_loss import rnnt_bwd_plain, rnnt_fwd_plain
    from hnet_mamba_asr_torch.tools.measure import rnnt_check, rnnt_faults, rnnt_pair
    rng = np.random.default_rng(4)
    B, T, U, Vc = 4, 30, 9, 11
    logits = (rng.normal(size=(B, T, U + 1, Vc + 5)) * 2).astype(np.float32)
    targets = torch.from_numpy(rng.integers(0, Vc - 1, size=(B, U)).astype(np.int32))
    fl, tl = torch.tensor([T, 21, 0, 12]), torch.tensor([U, 5, 3, 0])
    g = torch.from_numpy((rng.normal(size=B) + 2.0).astype(np.float32))
    refs = [rnnt_pair(rnnt_fwd_plain, rnnt_bwd_plain, torch.from_numpy(logits).to(dtype),
                      targets, fl, tl, g.to(dtype), Vc, Vc - 1)
            for dtype in (torch.float32, torch.float64)]
    assert rnnt_check(refs[1], *refs, fl, tl, g, Vc)["mass"] <= 1e-12
    got = (refs[0][0], *(r.float() for r in refs[1][1:]))
    c = rnnt_check(got, *refs, fl, tl, g, Vc)
    assert c["ok"], c
    faults = rnnt_faults(got, fl, tl, targets, Vc - 1)
    assert len(faults) == 4
    for name, fault in faults.items():
        assert not rnnt_check(fault, *refs, fl, tl, g, Vc)["ok"], name


# ---- the head -----------------------------------------------------------------------
def test_head_loss_greedy_and_history_match_jax(heads):
    """RNNTHead.loss per row (with its gradients), greedy_decode's tokens and
    lengths, and the history threaded block by block, against JAX."""
    jhead, params, head, mem, lens = heads[0]
    r = np.random.default_rng(5)
    targets = r.integers(0, V, size=(3, 4)).astype(np.int32)
    tlen = np.array([4, 1, 2], np.int32)
    jp = {"params": params}

    def jloss(p):
        return jhead.apply({"params": p}, jnp.asarray(mem), jnp.asarray(lens),
                           jnp.asarray(targets), jnp.asarray(tlen), method="loss")
    want = np.asarray(jloss(params))
    want_g = _leaves(jax.grad(lambda p: jloss(p).sum())(params))
    got = head.loss(torch.from_numpy(mem), torch.from_numpy(lens), torch.from_numpy(targets),
                    torch.from_numpy(tlen))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_RTOL)
    grads = torch.autograd.grad(got.sum(), list(head.parameters()))
    got_g = _leaves(convert.state_dict_to_jax_tree(
        {n: g for (n, _), g in zip(head.named_parameters(), grads)}))
    assert got_g.keys() == want_g.keys()
    for k, w in want_g.items():
        np.testing.assert_allclose(got_g[k], w, rtol=0, atol=LEAF_TOL * np.abs(w).max(),
                                   err_msg=k)
    wt, wl = jhead.apply(jp, jnp.asarray(mem), jnp.asarray(lens), method="greedy_decode")
    gt, gl = head.greedy_decode(torch.from_numpy(mem), torch.from_numpy(lens))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    # two blocks with the history threaded through == one pass
    h0 = torch.full((3, 2), 1, dtype=torch.long)
    t1, l1, h1 = head.greedy_decode(torch.from_numpy(mem[:, :4]),
                                    torch.from_numpy(np.minimum(lens, 4)), h0, True)
    t2, l2, _ = head.greedy_decode(torch.from_numpy(mem[:, 4:]),
                                   torch.from_numpy(np.maximum(lens - 4, 0)), h1, True)
    joined = [t1[b, :l1[b]].tolist() + t2[b, :l2[b]].tolist() for b in range(3)]
    assert joined == [gt[b, :gl[b]].tolist() for b in range(3)]


@pytest.fixture(scope="module")
def three_heads():
    """The JAX model with CTC, AED and RNN-T heads, one seeded tree, a batch of
    3 utterances and a padding row, and the JAX loss, stats and gradients."""
    rng = np.random.default_rng(0)
    model = jtask.build_model(RNNT_CONFIG, MODEL_V)
    params = seeded_tree(jax.eval_shape(model.init_params, jax.random.PRNGKey(0)), seed=1)
    items = [{"wave": (0.1 * rng.normal(size=n)).astype(np.float32), "n_samples": n,
              "tokens": rng.integers(4, MODEL_V, size=u).astype(np.int32), "id": f"u{i}",
              "index": i} for i, (n, u) in enumerate(zip([16000, 9100, 12000], [6, 3, 4]))]
    batch = collate_batch(items, pad_id=3, seed=7, epoch=0, batch_multiple=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "ids"}
    (loss, stats), grads = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss_fn(p, b, 0, False), has_aux=True))(params, jb)
    return dict(model=model, params=params, batch=batch, loss=float(loss),
                stats={k: np.asarray(v) for k, v in stats.items()}, grads=_leaves(grads))


def test_three_head_loss_fn_and_gradients_match_jax(three_heads):
    """loss_fn with 0.3 CTC + 0.7 AED + 1.0 RNN-T (rows / (tokens + 1), a
    padding row masked out) and every parameter's gradient against
    jax.value_and_grad of the JAX loss_fn; the convert round trip keeps the
    rnnt subtree."""
    j = three_heads
    model = build_model(RNNT_CONFIG, MODEL_V, device="cpu")
    convert.load_jax_params(model, j["params"])
    batch = {k: torch.as_tensor(v) for k, v in j["batch"].items() if k != "ids"}
    loss, stats = model.loss_fn(batch, 0, False)
    assert set(stats) == set(j["stats"])
    np.testing.assert_allclose(loss.item(), j["loss"], rtol=LOSS_RTOL)
    for k, v in j["stats"].items():
        np.testing.assert_allclose(stats[k].float().numpy(), v, rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
    assert float(stats["loss/rnnt"]) > 0
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = _leaves(convert.state_dict_to_jax_tree(
        {n: g for (n, _), g in zip(model.named_parameters(), grads)}))
    assert got.keys() == j["grads"].keys() and any("/rnnt/" in k for k in got)
    for k, w in j["grads"].items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=LEAF_TOL * np.abs(w).max() + 1e-12,
                                   err_msg=k)
    back = _leaves(convert.state_dict_to_jax_tree(model.state_dict()))
    for k, w in _leaves(j["params"]).items():
        assert np.array_equal(back[k], w), k
    # without a CTC head the trainer's inline decode is the transducer's greedy
    no_ctc = copy.deepcopy(RNNT_CONFIG)
    no_ctc["model_conf"]["ctc_weight"] = 0.0
    m2 = build_model(no_ctc, MODEL_V, device="cpu")
    convert.load_jax_params(m2, {k: v for k, v in j["params"].items() if k != "ctc"})
    enc = m2.encode(batch)
    assert m2.greedy_decode(batch) == rnnt_host_greedy(
        *m2.rnnt.greedy_decode(enc.features, enc.lengths))


# ---- the beams ----------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True])
def test_host_beam_matches_jax(heads, lms, fused):
    """The host engine against JAX's host engine: the same n-best sequences
    in the same order, acoustic and fused scores to float64 rounding of the
    same fp32 log-probs."""
    jlm, lm = lms
    for jhead, params, head, mem, lens in heads[:2]:
        kw = dict(beam_size=4, nbest=4, lm_weight=0.6 if fused else 0.0)
        want = jrnnt_decode.rnnt_beam_search(jhead, params, jnp.asarray(mem),
                                             jnp.asarray(lens), lm=jlm if fused else None,
                                             **kw)
        got = rnnt_beam_search(head, torch.from_numpy(mem), torch.from_numpy(lens),
                               lm=lm if fused else None, **kw)
        for g, w in zip(got, want):
            assert [h.tokens for h in g] == [h.tokens for h in w]
            np.testing.assert_allclose([h.aed for h in g], [h.aed for h in w], rtol=0,
                                       atol=SCORE_TOL)
            np.testing.assert_allclose([h.score for h in g], [h.score for h in w], rtol=0,
                                       atol=SCORE_TOL)
        best = rnnt_beam_search(head, torch.from_numpy(mem), torch.from_numpy(lens),
                                beam_size=4, lm=lm if fused else None,
                                lm_weight=kw["lm_weight"])
        assert best == [g[0].tokens for g in got]


@pytest.mark.parametrize("fused", [False, True])
def test_device_beam_matches_host_beam(heads, lms, fused):
    """The device beam against the port's host beam: the n-best sequences in
    the same order, acoustic scores to float32 accumulation; fused, each
    row's LM log-prob equals sequence_logprob (eos included); beam_decode
    gives the best row, and a row decoded alone gives its batched result."""
    _, lm = lms
    w = 0.6 if fused else 0.0
    for _, _, head, mem, lens in heads:
        host = rnnt_beam_search(head, torch.from_numpy(mem), torch.from_numpy(lens),
                                beam_size=4, nbest=4, lm=lm if fused else None, lm_weight=w)
        res = device_rnnt_beam.beam_decode_nbest(head, torch.from_numpy(mem),
                                                 torch.from_numpy(lens), 4,
                                                 lm=lm.lm if fused else None, lm_weight=w)
        ftoks, fplen, fscore = (r.numpy() for r in res[:3])
        for b in range(mem.shape[0]):
            rows = [k for k in range(4) if fscore[b, k] > -5.0e8]
            dev = [ftoks[b, k, :fplen[b, k]].tolist() for k in rows]
            assert dev == [h.tokens for h in host[b]], b
            np.testing.assert_allclose(fscore[b, rows], [h.aed for h in host[b]], rtol=0,
                                       atol=SCORE_TOL)
            if fused:
                np.testing.assert_allclose(res[3].numpy()[b, rows], lm.sequence_logprob(dev),
                                           rtol=0, atol=LM_TOL)
        if not fused:
            toks, tl = device_rnnt_beam.beam_decode(head, torch.from_numpy(mem),
                                                    torch.from_numpy(lens), 4)
            assert [toks[b, :tl[b]].tolist() for b in range(3)] == [h[0].tokens for h in host]
            alone = device_rnnt_beam.beam_decode_nbest(head, torch.from_numpy(mem[1:2, :6]),
                                                       torch.from_numpy(lens[1:2]), 4)
            assert [alone[0][0, k, :alone[1][0, k]].tolist() for k in range(4)
                    if alone[2][0, k] > -5.0e8] == [h.tokens for h in host[1]]
    # the streaming state, as in JAX, does not combine with LM fusion
    with pytest.raises(ValueError, match="streaming state"):
        device_rnnt_beam.beam_decode_nbest(head, torch.from_numpy(mem), torch.from_numpy(lens),
                                           4, lm=lm.lm, state=res[:3])


# ---- the decode cells and the serving modes -------------------------------------------
@pytest.fixture(scope="module")
def rnnt_model():
    """The three-head narrow model over 12 ids in both packages, a tiny LM in
    both, and a batch of 3 utterances."""
    V12 = MODEL_V
    jmodel = jtask.build_model(RNNT_CONFIG, V12)
    params = seeded_tree(jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)), seed=4)
    model = build_model(RNNT_CONFIG, V12, device="cpu")
    convert.load_jax_params(model, params)
    jlm_model = jlm_task.build_lm(LM_CFG, V12)
    lm_params = seeded_tree(jax.eval_shape(jlm_model.init_params, jax.random.PRNGKey(0)), seed=6)
    lm = build_lm(LM_CFG, V12, device="cpu")
    convert.load_jax_params(lm, lm_params)
    rng = np.random.default_rng(8)
    items = [{"wave": (0.1 * rng.normal(size=n)).astype(np.float32), "n_samples": n,
              "tokens": rng.integers(4, V12, size=3).astype(np.int32), "id": f"u{i}",
              "index": i} for i, n in enumerate([5200, 3100, 4400])]
    return dict(jmodel=jmodel, params=params, model=model, items=items,
                batch=collate_batch(items, pad_id=3, seed=0, epoch=0),
                jlm=jscorer.CausalLMScorer(jlm_model.lm, {"params": lm_params["lm"]}),
                lm=CausalLMScorer(lm.lm))


class _Tok:
    """ids -> text for decode records (a space-joined id string)."""
    bos_id, eos_id, pad_id = 1, 2, 3

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


RNNT_DECODE = {"read_outs": ["rnnt"], "search": ["greedy", "beam"], "lm": "on",
               "beam_size": 3, "lm_weight": 0.5, "rescore_weight": 0.6,
               "rescore_length_bonus": 2.0}


def test_rnnt_cells_match_jax(rnnt_model):
    """rnnt_greedy, rnnt_beam and rnnt_beam_lm through decode_batch against
    JAX's decode_batch: all three on the host engines (device_beam false);
    on the default device engines rnnt_greedy and rnnt_beam against JAX's,
    and rnnt_beam_lm (fused in the frame loop) against the port's host
    engine. An utterance decoded alone gives its batched transcript."""
    m = rnnt_model
    tok = _Tok()
    cells = decode_task.expand_cells(RNNT_DECODE)
    assert [c["name"] for c in cells] == ["rnnt_greedy", "rnnt_beam", "rnnt_beam_lm"]
    decode_task.check_heads(m["model"], cells)
    host_dc = dict(RNNT_DECODE, device_beam=False)
    alone = collate_batch(m["items"][1:2], pad_id=3, seed=0, epoch=0)
    for cell in cells:
        host = decode_task.decode_batch(m["model"], tok, m["batch"], cell, host_dc, lm=m["lm"])
        want = jdecode.decode_batch(m["jmodel"], m["params"], tok, m["batch"], cell, host_dc,
                                    lm=m["jlm"])
        assert [r["hyp"] for r in host] == [r["hyp"] for r in want], cell["name"]
        dev = decode_task.decode_batch(m["model"], tok, m["batch"], cell, RNNT_DECODE,
                                       lm=m["lm"])
        if not cell["lm"]:
            want = jdecode.decode_batch(m["jmodel"], m["params"], tok, m["batch"], cell,
                                        RNNT_DECODE, lm=m["jlm"])
        assert [r["hyp"] for r in dev] == [r["hyp"] for r in want], cell["name"]
        engine = "greedy" if cell["search"] == "greedy" else "device"
        assert {r["engine"] for r in dev} == {engine}
        one = decode_task.decode_batch(m["model"], tok, alone, cell, RNNT_DECODE, lm=m["lm"])
        assert one[0]["hyp"] == dev[1]["hyp"], cell["name"]
    no_rnnt = build_model(HYBRID_CONFIG, MODEL_V, device="cpu")
    with pytest.raises(ValueError, match="RNNT head"):
        decode_task.check_heads(no_rnnt, cells)


def test_serving_rnnt_modes(rnnt_model):
    """ServingModel's rnnt_ids / rnnt_lens (greedy) and rnnt_beam_ids /
    rnnt_beam_lens (the device beam; both held to JAX above) on the
    encoder's output of the same audio; transcribe_ids and the micro-batcher
    take the beam; a model without the head refuses the modes."""
    m = rnnt_model
    wave, wave_lens = ragged_waves(np.random.default_rng(4), [6000, 4200, 2600])
    model = m["model"]
    with torch.no_grad():
        enc = model.encode({"wave": torch.from_numpy(wave),
                            "wave_lens": torch.from_numpy(wave_lens)})
    wt, wl = model.rnnt.greedy_decode(enc.features, enc.lengths)
    bt, bl = device_rnnt_beam.beam_decode(model.rnnt, enc.features, enc.lengths, 10)
    sm = ServingModel(RNNT_CONFIG, m["params"], "cpu", emit=("rnnt_ids", "rnnt_beam_ids"))
    out = sm(wave, wave_lens)
    np.testing.assert_array_equal(out["rnnt_ids"], wt.numpy())
    np.testing.assert_array_equal(out["rnnt_lens"], wl.numpy())
    np.testing.assert_array_equal(out["rnnt_beam_ids"], bt.numpy())
    np.testing.assert_array_equal(out["rnnt_beam_lens"], bl.numpy())
    beam = rnnt_host_greedy(bt, bl)
    assert sm.transcribe_ids(wave, wave_lens) == beam
    batcher = MicroBatcher(sm, max_wait_ms=500.0)
    try:
        served = [f.result(timeout=120)["ids"]
                  for f in [batcher.submit(w[:n]) for w, n in zip(wave, wave_lens)]]
    finally:
        batcher.close()
    assert served == beam
    greedy = ServingModel(RNNT_CONFIG, m["params"], "cpu", emit=("rnnt_ids",))
    assert greedy.transcribe_ids(wave, wave_lens) == rnnt_host_greedy(wt, wl)
    for mode in ("rnnt_ids", "rnnt_beam_ids"):
        with pytest.raises(ValueError, match="RNNT head"):
            ServingModel(HYBRID_CONFIG, None, "cpu", vocab_size=MODEL_V, emit=(mode,))


def test_full_width_literals_and_parameter_count():
    """tools/gate.py's RNN-T config is configs/typeA_small_N1.yaml with
    model_conf.rnnt_weight 1.0 and rnnt_conf at the JAX defaults; its
    parameter count is the JAX model's (jax.eval_shape), the gate config's
    78,858,409 plus the head's 844,789. The MoE configs are the gate config
    and the fusion LM with 8 experts, top 2, in every decoder layer and
    block."""
    import yaml

    from hnet_mamba_asr_torch.tools import gate
    repo = Path(__file__).resolve().parents[1]
    cfg = yaml.safe_load((repo / "configs" / "typeA_small_N1.yaml").read_text())
    lit = gate.RNNT_CONFIG
    for key in ("frontend_conf", "specaug_conf", "encoder", "encoder_conf", "head",
                "aed_conf"):
        assert lit[key] == cfg[key], key
    assert lit["model_conf"] == dict(cfg["model_conf"], rnnt_weight=1.0)
    jhead = jtask.build_rnnt_head({"encoder_conf": cfg["encoder_conf"]}, gate.VOCAB)
    assert lit["rnnt_conf"] == {k: getattr(jhead, k) for k in lit["rnnt_conf"]}
    assert gate.MOE_CONFIG["aed_conf"] == dict(cfg["aed_conf"], moe=gate.MOE)
    assert gate.LM_MOE_CONFIG["lm_conf"] == dict(gate.LM_CONFIG["lm_conf"], moe=gate.MOE)
    jm = jtask.build_model(lit, gate.VOCAB)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert n_jax == 79_703_198 and n_jax - 78_858_409 == 844_789
    model = build_model(lit, gate.VOCAB, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert sum(p.numel() for p in model.rnnt.parameters()) == 844_789
