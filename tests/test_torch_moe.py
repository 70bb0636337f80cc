"""The port's MoE FFN against the JAX package on the CPU, fp32: ``MoEFFN``
at top_k 1 and 2 with capacity drops and a token mask (output, aux loss,
dropped share, every gradient), the MoE AED decoder in the hybrid
``loss_fn`` (its stats and gradients) and in a decode step, the MoE LM's
loss, and dropless scoring (the fusion LM's capacity, the scorer, the
device searches' dense-mix LM step). Weights are seeded in JAX and carried
across by ``convert.py``; inputs come from numpy seeds."""
import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnet_mamba_asr_torch import convert
from hnet_mamba_asr_torch.decoders.device_ctc_beam import _lm_init_caches, _lm_step
from hnet_mamba_asr_torch.decoders.lm_scorer import CausalLMScorer
from hnet_mamba_asr_torch.models.aed import AEDHead
from hnet_mamba_asr_torch.models.moe import MoEFFN, capacity
from hnet_mamba_asr_torch.tasks import decode_task
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_torch.tasks.lm_task import build_lm
from hnet_mamba_asr_tpu.decoders import lm_scorer as jscorer
from hnet_mamba_asr_tpu.models import aed as jaed
from hnet_mamba_asr_tpu.models import moe as jmoe
from hnet_mamba_asr_tpu.tasks import asr_task as jtask
from hnet_mamba_asr_tpu.tasks import lm_task as jlm_task

from torch_parity import HYBRID_CONFIG, NARROW_VOCAB, ragged_waves, seeded_tree

# fp32 on both sides, summation order only: outputs and losses to 1e-5,
# gradients to 1e-4 of each leaf's max (tests/test_torch_train.py's bounds)
# plus 1e-7 for leaves whose gradient is zero but for rounding (the LM's
# attention key biases: a bias on every key of a query shifts its logits
# alike)
TOL = 1e-5
LEAF_TOL = 1e-4
ZERO_GRAD_ATOL = 1e-7
MOE = {"n_experts": 4, "top_k": 2, "capacity_factor": 1.0, "aux_weight": 0.05}
LM_CFG = {"lm_conf": {"d_model": 16, "n_layers": 2, "n_heads": 2, "d_ff": 32, "dropout": 0.0,
                      "moe": dict(MOE, capacity_factor=0.5)}}
LM_V = 12


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_grads(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=LEAF_TOL * np.abs(w).max() + ZERO_GRAD_ATOL, err_msg=k)


def _named_grads(module, grads) -> dict:
    return _leaves(convert.state_dict_to_jax_tree(
        {n: g for (n, _), g in zip(module.named_parameters(), grads)}))


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_jax(top_k):
    """Output, aux, dropped share and the gradients of (y . g + aux) with
    respect to x and every parameter, with capacity drops (capacity factor
    0.5) and masked tokens; the capacity rule is JAX's."""
    D, Fh, E = 16, 32, 4
    rng = np.random.default_rng(top_k)
    x = rng.normal(size=(2, 24, D)).astype(np.float32)
    mask = np.ones((2, 24), bool)
    mask[1, 18:] = False
    g = rng.normal(size=x.shape).astype(np.float32)
    jm = jmoe.MoEFFN(D, Fh, E, top_k=top_k, capacity_factor=0.5)
    params = seeded_tree(jax.eval_shape(partial(jm.init, token_mask=jnp.asarray(mask)),
                                        jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                         seed=top_k)

    def jf(p, xx):
        y, mv = jm.apply({"params": p}, xx, token_mask=jnp.asarray(mask), mutable=["moe"])
        aux, stats = jmoe.moe_aux_from_vars(mv, 1.0)
        return (y * jnp.asarray(g)).sum() + aux, (y, aux, stats["moe/dropped"])
    (_, (wy, waux, wdrop)), (gp, gx) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    m = MoEFFN(D, Fh, E, top_k=top_k, capacity_factor=0.5)
    m.load_state_dict(convert.jax_to_state_dict(params), strict=True)
    xt = torch.tensor(x, requires_grad=True)
    y, aux, dropped = m(xt, torch.from_numpy(mask))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(wy), rtol=0, atol=TOL)
    np.testing.assert_allclose(aux.item(), float(waux), rtol=TOL)
    np.testing.assert_allclose(dropped.item(), float(wdrop), rtol=0, atol=1e-7)
    assert dropped.item() > 0 and (y[1, 18:] == 0).all()
    grads = torch.autograd.grad((y * torch.from_numpy(g)).sum() + aux,
                                [xt] + list(m.parameters()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx), rtol=0,
                               atol=LEAF_TOL * np.abs(np.asarray(gx)).max())
    _assert_grads(_leaves({n: t.numpy() for (n, _), t in zip(m.named_parameters(), grads[1:])}),
                  _leaves(gp))
    assert capacity(48, top_k, E, 0.5) == 8 * top_k and capacity(18, 2, 4, 2.0) == 24


@pytest.fixture(scope="module")
def aed_moe():
    """The hybrid model with an MoE AED decoder in JAX: one seeded tree, a
    batch of 3 utterances and a padding row, the loss, stats and gradients."""
    cfg = copy.deepcopy(HYBRID_CONFIG)
    cfg["aed_conf"]["moe"] = dict(MOE)
    model = jtask.build_model(cfg, NARROW_VOCAB)
    params = seeded_tree(jax.eval_shape(model.init_params, jax.random.PRNGKey(0)), seed=3)
    rng = np.random.default_rng(2)
    wave, wave_lens = ragged_waves(rng, [9000, 6000, 7000, 4000])
    tokens = rng.integers(4, NARROW_VOCAB, size=(4, 7)).astype(np.int32)
    batch = {"wave": wave, "wave_lens": wave_lens, "tokens": tokens,
             "token_lens": np.array([7, 3, 5, 2], np.int32),
             "row_mask": np.array([True, True, True, False]),
             "aug_ref": np.array([0, 0], np.int32), "item_index": np.arange(4, dtype=np.int32)}
    (loss, stats), grads = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss_fn(p, b, 0, False), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(cfg=cfg, model=model, params=params, batch=batch, loss=float(loss),
                stats={k: np.asarray(v) for k, v in stats.items()}, grads=_leaves(grads))


def test_aed_moe_loss_fn_matches_jax(aed_moe):
    """loss_fn with the MoE AED (aux at aux_weight in the AED loss, routing
    bos + tokens of the real rows): loss, every stat including moe/aux and
    moe/dropped, and every gradient, the routers' and experts' included."""
    j = aed_moe
    model = build_model(j["cfg"], NARROW_VOCAB, device="cpu")
    assert model.aed.layers[0].moe is not None
    convert.load_jax_params(model, j["params"])
    loss, stats = model.loss_fn({k: torch.as_tensor(v) for k, v in j["batch"].items()}, 0,
                                False)
    assert set(stats) == set(j["stats"]) and {"moe/aux", "moe/dropped"} <= set(stats)
    np.testing.assert_allclose(loss.item(), j["loss"], rtol=TOL)
    for k, v in j["stats"].items():
        np.testing.assert_allclose(stats[k].float().numpy(), v, rtol=TOL, atol=1e-6,
                                   err_msg=k)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = _named_grads(model, grads)
    assert any(k.endswith("/moe/router") for k in got)
    _assert_grads(got, j["grads"])


def test_aed_moe_decode_step_matches_jax(aed_moe):
    """The MoE AED's decode_step (every row routed, as JAX's step) against
    JAX's, two steps."""
    j = aed_moe
    jhead = j["model"].aed
    p = {"params": j["params"]["aed"]}
    rng = np.random.default_rng(3)
    mem = rng.normal(size=(3, 10, 32)).astype(np.float32)
    mlens = np.array([10, 7, 4], np.int32)
    head = AEDHead(NARROW_VOCAB, 32, n_layers=1, n_heads=2, d_ff=64, moe_experts=4,
                   moe_top_k=2, moe_capacity_factor=1.0)
    head.load_state_dict(convert.jax_to_state_dict(j["params"]["aed"]), strict=True)
    jc, jkpm = jhead.apply(p, jnp.asarray(mem), jnp.asarray(mlens), 8, method="decode_start")
    with torch.no_grad():
        tc, tkpm = head.decode_start(torch.from_numpy(mem), torch.from_numpy(mlens), 8)
    par = np.arange(3)
    for pos, tok in enumerate(([1, 1, 1], [5, 9, 4])):
        tok = np.asarray(tok)
        want, jc = jhead.apply(p, jc, jkpm, jnp.asarray(par), jnp.asarray(tok), pos,
                               method="decode_step")
        with torch.no_grad():
            got, tc = head.decode_step(tc, tkpm, torch.from_numpy(par), torch.from_numpy(tok),
                                       pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL * np.abs(np.asarray(want)).max())


def test_lm_moe_loss_and_dropless_scoring():
    """The MoE LM's loss (aux at aux_weight, moe/aux and moe/dropped, every
    gradient) against JAX's LMModel at capacity factor 0.5 (drops); the
    fusion LM scores dropless (capacity factor E / top_k): its next-token
    log-probs match JAX's dropless scorer, and the device searches'
    dense-mix cached step equals its full forward."""
    jmodel = jlm_task.build_lm(LM_CFG, LM_V)
    params = seeded_tree(jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)), seed=4)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(4, LM_V, size=(3, 6)).astype(np.int32),
             "token_lens": np.array([6, 2, 4], np.int32), "row_mask": np.array([1, 1, 0], bool)}
    (wloss, wstats), wgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, 0, False), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = build_lm(LM_CFG, LM_V, device="cpu")
    convert.load_jax_params(model, params)
    loss, stats = model.loss_fn({k: torch.as_tensor(v) for k, v in batch.items()}, 0, False)
    assert set(stats) == set(wstats)
    np.testing.assert_allclose(loss.item(), float(wloss), rtol=TOL)
    for k, v in wstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=TOL, atol=1e-6, err_msg=k)
    assert float(stats["moe/dropped"]) > 0
    _assert_grads(_named_grads(model, torch.autograd.grad(loss, list(model.parameters()))),
                  _leaves(wgrads))

    cfg = decode_task.dropless(LM_CFG)
    assert cfg["lm_conf"]["moe"]["capacity_factor"] == 2.0
    assert decode_task.dropless({"lm_conf": {"d_model": 8}}) == {"lm_conf": {"d_model": 8}}
    jdrop = jlm_task.build_lm(cfg, LM_V)
    lm = build_lm(cfg, LM_V, device="cpu")
    convert.load_jax_params(lm, params)
    prefixes = [[], [5], [7, 4, 9], [4, 4, 11, 6, 8]]
    want = jscorer.CausalLMScorer(jdrop.lm, {"params": params["lm"]}).next_logprobs(prefixes)
    scorer = CausalLMScorer(lm.lm)
    np.testing.assert_allclose(scorer.next_logprobs(prefixes), np.asarray(want), rtol=0,
                               atol=TOL)
    # the cached dense-mix step over a sequence == the full forward's log-probs
    seq = [1, 7, 4, 9, 5]
    with torch.no_grad():
        full = torch.log_softmax(lm.lm(torch.tensor([seq])).float(), -1)[0]
        caches = _lm_init_caches(lm.lm, 1, 8, "cpu")
        for pos, tok in enumerate(seq):
            step, caches = _lm_step(lm.lm, caches, torch.tensor([tok]), torch.tensor([pos]),
                                    torch.tensor([True]))
            np.testing.assert_allclose(step[0].numpy(), full[pos].numpy(), rtol=0, atol=TOL)
