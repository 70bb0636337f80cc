"""H-Net dynamic chunking in the port against the JAX package and against the
oracles of tests/test_hnet_chunk.py, on the CPU in fp32: the EMA smoother
(values, gradients, zero gradient at saturation, and the recurrence the
Hopper kernel computes), the router, the ratio loss, chunk (membership and
the index scatter) and dechunk (EMA -> gather -> STE), and the fixed-pool
chunker. The port trims the compressed buffer (models/hnet_chunk.py), so
slots are compared where they are valid."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity import assert_boundaries_equal, module_tree

from hnet_mamba_asr_torch.convert import jax_to_state_dict
from hnet_mamba_asr_torch.models import hnet_chunk
from hnet_mamba_asr_torch.models.fixed_pool import FixedPoolChunker
from hnet_mamba_asr_torch.models.hnet_chunk import (
    DynamicChunker, RoutingModule, compressed_slots, ratio_loss)
from hnet_mamba_asr_torch.ops.ema import ema_smooth, ema_smooth_sequential
from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda
from hnet_mamba_asr_tpu.models import fixed_pool as jfixed
from hnet_mamba_asr_tpu.models import hnet_chunk as jchunk
from hnet_mamba_asr_tpu.ops import ema as jema

# fp32, summation order only: the EMA's matmul (M terms), the router's
# projections and cosine, the pooled means
TOL = dict(rtol=1e-5, atol=1e-5)
B, L, D = 4, 40, 32


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---- EMA -------------------------------------------------------------------------
def _ema_inputs(rng, Bs, M, Ds, saturate=False):
    z = rng.normal(size=(Bs, M, Ds)).astype(np.float32)
    p = (rng.uniform(size=(Bs, M)) * 0.8 + 0.1).astype(np.float32)
    if saturate:
        p[:, ::10] = 1.0
        p[:, 5::10] = 0.0
    return z, p


@pytest.mark.parametrize("shape,saturate", [((4, 200, 32), False), ((2, 120, 32), True),
                                            ((3, 1, 8), False), ((2, 2, 5), True)])
def test_ema_matches_jax_values_and_gradients(rng, shape, saturate):
    """ema_smooth against the JAX ema_smooth and the sequential oracle, with
    the gradients of z and p against jax.grad."""
    z, p = _ema_inputs(rng, *shape, saturate)
    w = rng.normal(size=shape).astype(np.float32)
    f = lambda zz, pp: (jema.ema_smooth(zz, pp) * w).sum()
    want = np.asarray(jema.ema_smooth(jnp.asarray(z), jnp.asarray(p)))
    wz, wp = (np.asarray(g) for g in jax.grad(f, argnums=(0, 1))(jnp.asarray(z),
                                                                   jnp.asarray(p)))
    tz, tp = _t(z).requires_grad_(), _t(p).requires_grad_()
    got = ema_smooth(tz, tp)
    gz, gp = torch.autograd.grad((got * _t(w)).sum(), (tz, tp), allow_unused=True)
    # the weights exp(S_t - S_j) difference two cumsums of up to 200 logs
    # (|S| ~ 1e2), summed in other orders by XLA and torch: ~1e-5 relative
    # per weight in fp32. The same 1e-4 holds the matmul form against the
    # recurrence (tests/test_hnet_chunk.py's bound)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ema_smooth_sequential(_t(z), _t(p)).numpy(), want,
                               rtol=1e-4, atol=1e-4)
    # a gradient sums up to M x D terms: 1e-5 of its largest element
    np.testing.assert_allclose(gz.numpy(), wz, rtol=0, atol=1e-5 * np.abs(wz).max())
    np.testing.assert_allclose(np.zeros_like(wp) if gp is None else gp.numpy(), wp,
                               rtol=0, atol=1e-5 * max(np.abs(wp).max(), 1.0))
    if saturate and shape[1] > 10:
        assert (gp.numpy()[:, 10::10] == 0).all() and (gp.numpy()[:, 5::10] == 0).all()
        assert np.abs(gp.numpy()[:, 1:]).sum() > 0


def test_ema_gradients_match_sequential_oracle():
    """Two independent autodiff paths (matmul form and literal recurrence),
    the zero at a saturated p included (tests/test_hnet_chunk.py)."""
    x = _t(np.random.default_rng(0).normal(size=(1, 6, 3)).astype(np.float32))
    p = _t(np.array([[1.0, 0.3, 0.7, 1.0, 0.4, 0.6]], np.float32))

    def grads(fn):
        xx, pp = x.clone().requires_grad_(), p.clone().requires_grad_()
        return torch.autograd.grad(fn(xx, pp).sum(), (xx, pp))

    (gx, gp), (rx, rp) = grads(ema_smooth), grads(ema_smooth_sequential)
    torch.testing.assert_close(gx, rx, rtol=0, atol=1e-5)
    torch.testing.assert_close(gp, rp, rtol=0, atol=1e-5)
    assert gp[0, 3] == 0.0


def test_ema_directional_finite_difference(rng):
    """The analytic gradient against central differences along a random
    direction (fp32, as tests/test_hnet_chunk.py checks the JAX form)."""
    x = _t(rng.normal(size=(1, 8, 4)).astype(np.float32))
    p = _t((rng.uniform(size=(1, 8)) * 0.8 + 0.1).astype(np.float32))
    vx = _t(rng.normal(size=(1, 8, 4)).astype(np.float32))
    vp = _t(rng.normal(size=(1, 8)).astype(np.float32))
    f = lambda a, b: (ema_smooth(a, b) ** 2).sum()
    xx, pp = x.clone().requires_grad_(), p.clone().requires_grad_()
    gx, gp = torch.autograd.grad(f(xx, pp), (xx, pp))
    analytic = float((gx * vx).sum() + (gp * vp).sum())
    eps = 1e-3
    numeric = float(f(x + eps * vx, p + eps * vp) - f(x - eps * vx, p - eps * vp)) / (2 * eps)
    assert abs(analytic - numeric) < 2e-2 * max(1.0, abs(analytic))


def ema_backward_recurrence(z, p, zbar, g, p_clamp=1e-4):
    """What csrc/ema.cu's backward computes, step for step: the reverse
    recurrence h_t = g_t + (1 - P_{t+1}) h_{t+1}, dz_t = P_t h_t (dz_0 = h_0),
    dP_t = sum_d h_t (z_t - zbar_{t-1}) inside the clamp's range, dP_0 = 0."""
    lo, hi = p_clamp, 1.0 - p_clamp
    pc = p.clamp(lo, hi)
    M = z.shape[1]
    dz, dp = torch.zeros_like(z), torch.zeros_like(p)
    h = torch.zeros_like(z[:, 0])
    for t in range(M - 1, -1, -1):
        nxt = pc[:, t + 1, None] if t + 1 < M else torch.zeros_like(pc[:, :1])
        h = g[:, t] + (1.0 - nxt) * h
        dz[:, t] = h if t == 0 else pc[:, t, None] * h
        if t > 0:
            inside = (p[:, t] >= np.float32(lo)) & (p[:, t] <= np.float32(hi))
            dp[:, t] = torch.where(inside, (h * (z[:, t] - zbar[:, t - 1])).sum(-1), 0.0)
    return dz, dp


@pytest.mark.parametrize("M,saturate", [(70, False), (130, True), (1, False)])
def test_kernel_backward_recurrence_is_autograd_of_ema(rng, M, saturate):
    """The reverse recurrence of the Hopper backward, from the forward's
    output, gives autograd's gradients of ema_smooth (fp32)."""
    z, p = _ema_inputs(rng, 3, M, 16, saturate)
    g = _t(rng.normal(size=z.shape).astype(np.float32))
    tz, tp = _t(z).requires_grad_(), _t(p).requires_grad_()
    zbar = ema_smooth(tz, tp)
    want = torch.autograd.grad(zbar, (tz, tp), g, allow_unused=True)
    dz, dp = ema_backward_recurrence(_t(z), _t(p), zbar.detach(), g)
    want_dp = torch.zeros_like(dp) if want[1] is None else want[1]
    # fp32 in two summation orders (matmul form vs recurrence): 1e-5 of the max
    for got, w in ((dz, want[0]), (dp, want_dp)):
        torch.testing.assert_close(got, w, rtol=0,
                                   atol=1e-5 * max(w.abs().max().item(), 1.0))
    if saturate:
        assert (dp[:, 10::10] == 0).all() and (dp[:, 5::10] == 0).all()


def test_ema_wrapper_runs_the_plain_version_on_the_cpu(rng):
    z, p = _ema_inputs(rng, 2, 30, 8)
    before = (ema_cuda.launches, ema_cuda.bwd_launches)
    assert torch.equal(ema_cuda(_t(z), _t(p)), ema_smooth(_t(z), _t(p)))
    assert (ema_cuda.launches, ema_cuda.bwd_launches) == before


# ---- router and ratio loss --------------------------------------------------------
def _router_pair(rng, d=D, identity=True):
    jr = jchunk.RoutingModule(d)
    x = rng.normal(size=(B, L, d)).astype(np.float32)
    tree = (jr.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"] if identity
            else module_tree(jr, jnp.asarray(x), seed=3))
    r = RoutingModule(d)
    r.load_state_dict(jax_to_state_dict(tree), strict=True)
    return jr, tree, r, x


def test_router_init_is_the_identity():
    r = RoutingModule(8)
    assert torch.equal(r.W_q.weight, torch.eye(8)) and torch.equal(r.W_k.weight, torch.eye(8))
    assert r.W_q.bias is None and r.W_k.bias is None


@pytest.mark.parametrize("identity", [True, False])
def test_router_matches_jax(rng, identity):
    jr, tree, r, x = _router_pair(rng, identity=identity)
    mask = np.ones((B, L), bool)
    mask[1, 30:] = mask[3, 11:] = False
    jp, jb = jr.apply({"params": tree}, jnp.asarray(x), jnp.asarray(mask))
    p, b = r(_t(x), _t(mask))
    assert_boundaries_equal(b.numpy(), jb, jp)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), **TOL)


def test_router_range_first_frame_and_causality(rng):
    _, _, r, x = _router_pair(rng)
    p, b = r(_t(x))
    assert p.shape == (B, L) and ((p >= 0) & (p <= 1)).all()
    assert (p[:, 0] == 1).all() and (b[:, 0] == 1).all()
    assert ((b == 0) | (b == 1)).all()
    x2 = x[:1].copy()
    x2[0, 21:] = rng.normal(size=(L - 21, D))
    torch.testing.assert_close(r(_t(x2))[0][0, :21], p[0, :21], rtol=0, atol=1e-6)
    p_same, b_same = r(torch.ones(1, L, D))
    torch.testing.assert_close(p_same[0, 1:], torch.zeros(L - 1), rtol=0, atol=1e-4)
    assert b_same[0, 1:].sum() == 0


def test_router_zero_frames_give_finite_gradients(rng):
    """Zero frames (empty slots feeding a Type B stage-2 router): the clamp
    inside the sqrt keeps NaN out of the gradients."""
    r = RoutingModule(8)
    x = _t(rng.normal(size=(2, 6, 8)).astype(np.float32))
    x[:, 3:] = 0.0
    x.requires_grad_()
    mask = torch.tensor([[1, 1, 1, 0, 0, 0]] * 2, dtype=torch.bool)
    p, b = r(x, mask)
    grads = torch.autograd.grad(ratio_loss(p, b, 2.0, mask), [x, *r.parameters()])
    assert all(torch.isfinite(g).all() for g in grads)


def test_ratio_loss_matches_jax(rng):
    p = rng.uniform(size=(B, L)).astype(np.float32)
    b = (p >= 0.5).astype(np.float32)
    mask = rng.uniform(size=(B, L)) < 0.8
    for N in (1, 2, 3.0):
        for m in (None, mask):
            want = float(jchunk.ratio_loss(jnp.asarray(p), jnp.asarray(b), N,
                                           None if m is None else jnp.asarray(m)))
            got = ratio_loss(_t(p), _t(b), N, None if m is None else _t(m))
            assert abs(float(got) - want) <= 1e-6, (N, m is None)
    assert float(ratio_loss(_t(p), _t(b), 1)) == 0.0
    on = np.zeros((1, 1000), np.float32)
    on[0, ::4] = 1.0
    off = torch.ones(1, 1000)
    assert float(ratio_loss(_t(on), _t(on), 4)) < float(ratio_loss(off, off, 4))
    pt = _t(p).requires_grad_()
    (g,) = torch.autograd.grad(ratio_loss(pt, _t(b), 3), pt)
    assert (g != 0).any()


# ---- chunk and dechunk ---------------------------------------------------------------
def _chunker_pair(rng, N=2, d=D, ema=True, length=L, rows=B):
    jc = jchunk.DynamicChunker(d_model=d, N=N, ema_smoothing=ema)
    x = rng.normal(size=(rows, length, d)).astype(np.float32)
    tree = module_tree(jc, jnp.asarray(x), seed=4)
    tc = DynamicChunker(d, N=N, ema_smoothing=ema)
    tc.load_state_dict(jax_to_state_dict(tree), strict=True)
    return jc, tree, tc, x


def _ragged_mask(rows, length):
    mask = np.ones((rows, length), bool)
    for i in range(1, rows):
        mask[i, length - 7 * i:] = False
    return mask


@pytest.mark.parametrize("ema", [True, False])
def test_chunk_and_dechunk_match_jax(rng, ema):
    """chunk (p, b, membership, the scatter on valid slots, z_mask, ratio
    loss, kept fraction) and dechunk (values, and the gradients of x, z_proc
    and the router through the whole block) against the JAX chunker."""
    jc, tree, tc, x = _chunker_pair(rng, ema=ema)
    mask = _ragged_mask(B, L)
    jco = jc.apply({"params": tree}, jnp.asarray(x), jnp.asarray(mask), method="chunk")
    co = tc.chunk(_t(x), _t(mask))
    assert_boundaries_equal(co.b.numpy(), jco.b, jco.p)
    np.testing.assert_allclose(co.p.detach().numpy(), np.asarray(jco.p), **TOL)
    np.testing.assert_array_equal(co.membership.numpy(), np.asarray(jco.membership))
    counts = np.asarray(jco.z_mask).sum(1)
    M = co.z.shape[1]
    assert M == min(L, -(-counts.max() // 64) * 64)
    np.testing.assert_array_equal(co.z_mask.numpy(), np.asarray(jco.z_mask)[:, :M])
    for i, n in enumerate(counts):
        np.testing.assert_array_equal(co.z[i, :n].detach().numpy(), np.asarray(jco.z)[i, :n])
        assert not co.z[i, n:].any()
    assert abs(co.ratio_loss.item() - float(jco.ratio_loss)) <= 1e-6
    assert float(co.kept_fraction) == pytest.approx(float(jco.kept_fraction), abs=1e-7)

    w = rng.normal(size=(D, D)).astype(np.float32) * 0.1
    noise = rng.normal(size=(B, L, D)).astype(np.float32)

    def jloss(params, xx):
        c = jc.apply({"params": params}, xx, jnp.asarray(mask), method="chunk")
        y = jc.apply({"params": params}, c.z @ w, c, method="dechunk")
        return (y * noise).sum() + 0.03 * c.ratio_loss, y

    (jl, jy), (jg_params, jg_x) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        tree, jnp.asarray(x))
    tx = _t(x).requires_grad_()
    c = tc.chunk(tx, _t(mask))
    y = tc.dechunk(c.z @ _t(w), c)
    loss = (y * _t(noise)).sum() + 0.03 * c.ratio_loss
    grads = torch.autograd.grad(loss, [tx, tc.router.W_q.weight, tc.router.W_k.weight])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = [np.asarray(jg_x), np.asarray(jg_params["router"]["W_q"]["kernel"]).T,
            np.asarray(jg_params["router"]["W_k"]["kernel"]).T]
    for got, w_ in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), w_, rtol=0, atol=1e-4 * np.abs(w_).max())


def test_membership_and_scatter_match_the_per_row_oracle(rng):
    _, _, tc, x = _chunker_pair(rng)
    mask = np.ones((B, L), bool)
    mask[:, L - 7:] = False
    co = tc.chunk(_t(x), _t(mask))
    bv = co.b.numpy()
    exp = np.maximum(np.cumsum(bv, axis=1) - 1, 0)
    np.testing.assert_array_equal(co.membership.numpy(), exp)
    for i in range(B):
        idx = np.nonzero(bv[i] > 0.5)[0]
        np.testing.assert_array_equal(co.z[i, :len(idx)].detach().numpy(), x[i, idx])
        assert not co.z[i, len(idx):].any()
        assert co.z_mask[i].sum() == len(idx) and co.z_mask[i, :len(idx)].all()
    assert (bv * ~mask).sum() == 0


def test_dechunk_matches_the_eq5_8_9_oracle(rng):
    """An independent Eq. 5 -> 8 -> 9 oracle over the kept frames."""
    _, _, tc, x = _chunker_pair(rng, d=5, length=12, rows=2)
    co = tc.chunk(_t(x))
    zp = rng.normal(size=tuple(co.z.shape)).astype(np.float32)
    out = tc.dechunk(_t(zp), co).detach().numpy()
    pv, bv, mv = co.p.detach().numpy(), co.b.numpy(), co.membership.numpy()
    for bi in range(2):
        kept = [t for t in range(12) if bv[bi, t] > 0.5]
        zbar = []
        for j, t in enumerate(kept):
            zbar.append(zp[bi, 0].astype(np.float64) if j == 0 else
                        pv[bi, t] * zp[bi, j] + (1 - pv[bi, t]) * zbar[j - 1])
        for t in range(12):
            np.testing.assert_allclose(out[bi, t], zbar[int(mv[bi, t])], atol=1e-5)


def test_dechunk_ste_forward_factor_and_gradient(rng):
    """The STE multiplies by c + (1 - c) in the forward (1 up to rounding,
    as in JAX) and scales the gathered gradient by c = p^b (1-p)^(1-b)."""
    _, _, tc, x = _chunker_pair(rng, d=4, length=10, rows=1, ema=False)
    co = tc.chunk(_t(x))
    zp = _t(rng.normal(size=tuple(co.z.shape)).astype(np.float32)).requires_grad_()
    out = tc.dechunk(zp, co)
    gathered = zp.detach()[0, co.membership[0].long()]
    torch.testing.assert_close(out[0].detach(), gathered, rtol=0, atol=1e-6)
    p = co.p.detach().requires_grad_()
    out = tc.dechunk(zp.detach(), co._replace(p=p))
    (gp,) = torch.autograd.grad(out.sum(), p)
    c_grad = torch.where(co.b > 0.5, 1.0, -1.0)
    torch.testing.assert_close(gp[0], c_grad[0] * gathered.sum(-1), rtol=1e-6, atol=1e-6)


def test_chunk_bf16_membership_exact_at_length_1200(rng):
    _, _, tc, x = _chunker_pair(rng, length=1200, rows=2)
    tc = DynamicChunker(D, N=2, dtype=torch.bfloat16)
    xb = _t(x).to(torch.bfloat16)
    co = tc.chunk(xb)
    assert int(co.membership.max()) < co.z.shape[1]
    for i in range(2):
        idx = np.nonzero(co.b[i].float().numpy() > 0.5)[0]
        assert torch.equal(co.z[i, :len(idx)], xb[i, idx])
        assert int(co.z_mask[i].sum()) == len(idx)


def test_compressed_slots():
    assert compressed_slots(torch.tensor([3, 70]), 300) == 128
    assert compressed_slots(torch.tensor([64, 1]), 300) == 64
    assert compressed_slots(torch.tensor([200]), 150) == 150
    assert compressed_slots(torch.tensor([0, 0]), 40) == 40
    assert hnet_chunk.SLOT_MULTIPLE == 64


def test_n1_chunker_is_the_identity(rng):
    tc = DynamicChunker(D, N=1)
    assert tc.router is None and not list(tc.parameters())
    x = _t(rng.normal(size=(B, L, D)).astype(np.float32)).requires_grad_()
    co = tc.chunk(x)
    assert co.z is x and float(co.ratio_loss) == 0.0 and float(co.kept_fraction) == 1.0
    y = tc.dechunk(co.z, co)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, torch.ones_like(g))


# ---- fixed-pool chunker ----------------------------------------------------------------
@pytest.mark.parametrize("stride", [2, 4])
def test_fixed_pool_matches_jax(rng, stride):
    jc = jfixed.FixedPoolChunker(d_model=D, N=stride)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = _ragged_mask(B, L)
    jco = jc.apply({}, jnp.asarray(x), jnp.asarray(mask), method="chunk")
    tc = FixedPoolChunker(D, N=float(stride))
    co = tc.chunk(_t(x), _t(mask))
    M = co.z.shape[1]
    n_valid = np.asarray(jco.z_mask).sum(1)
    np.testing.assert_array_equal(co.z_mask.numpy(), np.asarray(jco.z_mask)[:, :M])
    for i, n in enumerate(n_valid):
        np.testing.assert_allclose(co.z[i, :n].numpy(), np.asarray(jco.z)[i, :n], **TOL)
    for a, b_ in ((co.b, jco.b), (co.p, jco.p), (co.membership, jco.membership)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    assert float(co.kept_fraction) == pytest.approx(float(jco.kept_fraction), abs=1e-7)
    assert float(co.ratio_loss) == 0.0
    zp = rng.normal(size=(B, L, D)).astype(np.float32)
    want = np.asarray(jc.apply({}, jnp.asarray(zp), jco, method="dechunk"))
    got = tc.dechunk(_t(zp[:, :M]), co).numpy()
    lengths = mask.sum(1)
    for i, n in enumerate(lengths):
        np.testing.assert_array_equal(got[i, :n], want[i, :n])


def test_fixed_pool_stride_rules(rng):
    with pytest.raises(ValueError, match="needs an integer stride; got N=1.5"):
        FixedPoolChunker(D, N=1.5)
    tc = FixedPoolChunker(D, N=1.0)
    x = _t(rng.normal(size=(2, 9, D)).astype(np.float32))
    co = tc.chunk(x)
    assert co.z is x and tc.dechunk(co.z, co) is x
    assert not list(tc.parameters())
