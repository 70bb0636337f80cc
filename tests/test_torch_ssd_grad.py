"""Gradients of the port's SSD on the CPU: autograd of
hnet_mamba_asr_torch/ops/ssd.py::ssd_chunked (the plain backward) against
jax.grad of the JAX ssd_chunked, plain and with its hand-written intra-chunk
VJP (custom_vjp=True); the gradient cases of tests/test_ssd.py; the SSDScan
node on CPU tensors; and the backward kernel's algorithm (csrc/ssd_bwd.cu),
written out in torch, against autograd and jax.grad, in fp32 and with the
bf16 instance's operand roundings."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import torch_parity  # noqa: F401  (threads, TF32)

from hnet_mamba_asr_torch.ops.ssd import _expand_groups, ssd_chunked, ssd_reference
from hnet_mamba_asr_torch.ops.ssd_cuda import SSDScan, ssd_cuda
from hnet_mamba_asr_tpu.ops import ssd as jssd

# fp32 on both sides: the two differ in summation order only; ~1e-4 of each
# gradient's max is the repo's fp32 SSD tolerance (2e-4 on y, test_torch_ssd)
GRAD_TOL = 1e-4
# intra_dtype bf16: both round the intra-chunk scores, decays and dt, and
# autodiff rounds their cotangents, but at other points (XLA folds some casts
# away and reduces the broadcast dt in bf16; torch sums before it rounds).
# At these inputs JAX's own bf16 gradients sit up to 1.7e-2 of the max from
# its fp32 ones (dA), and the port's up to 1.5e-2 from JAX's: a bf16 ulp of
# the intra term, summed over a chunk
GRAD_TOL_BF16 = 2e-2
NAMES = ("x", "dt", "A", "B", "C")


def _inputs(rng, B=2, L=45, H=4, P=8, N=16, G=1):
    return (rng.normal(size=(B, L, H, P)).astype(np.float32),
            rng.uniform(0.001, 0.2, size=(B, L, H)).astype(np.float32),
            -rng.uniform(0.5, 8.0, size=(H,)).astype(np.float32),
            rng.normal(size=(B, L, G, N)).astype(np.float32),
            rng.normal(size=(B, L, G, N)).astype(np.float32))


def _port_grads(fn, args, w):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    loss = (fn(*leaves) * torch.from_numpy(w)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _jax_grads(fn, args, w):
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * w), argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in args])
    return [np.asarray(g) for g in grads]


def _assert_close(got, want, tol, what):
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max(),
                                   err_msg=f"{what}: d{name}")


@pytest.mark.parametrize("custom_vjp", [False, True])
@pytest.mark.parametrize("intra_dtype", [None, "bf16"])
@pytest.mark.parametrize("groups", [1, 2])
def test_gradients_match_jax(rng, groups, intra_dtype, custom_vjp):
    """Every input's gradient against jax.grad of the JAX ssd_chunked (and of
    its custom-VJP path), fp32, G = 1 and G < H. With intra_dtype bf16 both
    round the intra-chunk scores, decays and dt and their gradients
    (GRAD_TOL_BF16)."""
    args = _inputs(rng, H=4, G=groups)
    w = rng.normal(size=args[0].shape).astype(np.float32)
    got = _port_grads(lambda *t: ssd_chunked(*t, chunk_size=16, intra_dtype=intra_dtype),
                      args, w)
    want = _jax_grads(lambda *a: jssd.ssd_chunked(*a, chunk_size=16, intra_dtype=intra_dtype,
                                                  custom_vjp=custom_vjp), args, w)
    _assert_close(got, want, GRAD_TOL if intra_dtype is None else GRAD_TOL_BF16,
                  f"G {groups} intra {intra_dtype} custom_vjp {custom_vjp}")


def test_gradients_match_reference(rng):
    """tests/test_ssd.py::test_gradients_match_reference: the chunked form's
    gradients against the sequential oracle's, in the port and against JAX."""
    args = _inputs(rng, B=1, L=21, H=2, P=4, N=8)

    def loss_grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_() for a in args]
        return [g.numpy() for g in torch.autograd.grad(torch.tanh(fn(*leaves)).sum(), leaves)]

    g_ref = loss_grads(ssd_reference)
    g_chk = loss_grads(lambda *t: ssd_chunked(*t, chunk_size=8))
    g_jax = jax.grad(lambda *a: jnp.sum(jnp.tanh(jssd.ssd_reference(*a))),
                     argnums=(0, 1, 2, 3, 4))(*[jnp.asarray(a) for a in args])
    for a, b, c in zip(g_ref, g_chk, g_jax):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(b, np.asarray(c), rtol=1e-3, atol=1e-3)


def test_decay_stability_long_dt(rng):
    """Large dt * |A|: output and gradients finite (decays are exps of
    negatives), and equal to the oracle's."""
    x, dt, A, Bm, Cm = _inputs(rng, L=40)
    args = (x, dt * 50.0, A, Bm, Cm)
    w = rng.normal(size=x.shape).astype(np.float32)
    got = _port_grads(lambda *t: ssd_chunked(*t, chunk_size=8), args, w)
    want = _port_grads(ssd_reference, args, w)
    for g in got:
        assert np.isfinite(g).all()
    _assert_close(got, want, 1e-3, "long dt vs ssd_reference")


def test_gradients_finite_at_production_scale(rng):
    """Chunk 128 >> 1 with |A| up to 16: the future positions' decay is
    masked before the exp, or NaN leaks into the gradients."""
    x = rng.normal(size=(1, 256, 2, 8)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, size=(1, 256, 2)).astype(np.float32)
    A = np.array([-8.0, -16.0], np.float32)
    Bm = rng.normal(size=(1, 256, 1, 8)).astype(np.float32)
    Cm = rng.normal(size=(1, 256, 1, 8)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    loss = (ssd_chunked(*leaves, chunk_size=128) ** 2).sum()
    for g in torch.autograd.grad(loss, leaves):
        assert torch.isfinite(g).all()


def test_ssdscan_on_cpu_is_the_plain_version(rng):
    """The SSDScan contract on CPU tensors: ssd_cuda is ssd_chunked forward
    and autograd of it backward, the state in and out included; no kernel is
    counted; SSDScan itself takes CUDA tensors only."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _inputs(rng, L=150, H=2))
    s0 = torch.from_numpy(rng.normal(size=(2, 2, 16, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    wf = torch.from_numpy(rng.normal(size=s0.shape).astype(np.float32))
    before = (ssd_cuda.launches, ssd_cuda.bwd_launches)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, s0)]
        y, s = fn(*leaves)
        loss = (y * w).sum() + (s * wf).sum()
        return [y.detach(), s.detach(), *torch.autograd.grad(loss, leaves)]

    got = grads(lambda *a: ssd_cuda(*a[:5], chunk_size=64, initial_state=a[5],
                                    return_final=True, intra_dtype="bf16"))
    want = grads(lambda *a: ssd_chunked(*a[:5], chunk_size=64, initial_state=a[5],
                                        return_final=True, intra_dtype="bf16"))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (ssd_cuda.launches, ssd_cuda.bwd_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        SSDScan.apply(x, dt, A, Bm, Cm, s0, "bf16", True)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    """fp32 -> bf16 hi + lo (held in fp32): an operand the kernel feeds to
    two bf16 MMAs, within ~2^-16 of t."""
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def kernel_backward(x, dt, A, B, C, dy, s0=None, ds_final=None, Q=64, intra=False, low=False):
    """csrc/ssd_bwd.cu's bf16 design in torch, fp32 arithmetic.

    The forward's chunk states; launch 1: each chunk's dD_k = C^T (e dy)
    from zero, then the reverse chain D_{k-1} = exp(ac_last) D_k + dD_k;
    launch 2: per (b, group, chunk), C B^T once, then a loop over the
    group's heads that forms <D_k, S_{k-1}>, writes dx, ddt and a per-(b, h,
    k) dA partial and keeps the group's sums (dcb, coef x D^T, e dy S^T) for
    dB and dC; the dA partials summed in a fixed order. With
    ``low`` it applies the bf16 instance's roundings: the forward's (W, the
    weighted B and S_{k-1} as product operands; ``intra`` the scores, decays
    and dt) and the kernel's own (D_k to bf16, in the products and in the
    dot with the fp32 S_{k-1}; C e and the group's dcb as bf16 hi + lo)."""
    Bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    hg = H // G
    pad = (-L) % Q
    padt = lambda t: torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
    xp, gp, dtp, Bp, Cp = padt(x), padt(dy), padt(dt), padt(B), padt(C)
    K = (L + pad) // Q
    rnd = _bf16 if low else (lambda t: t)
    pair = _split if low else (lambda t: (t,))
    cut = lambda t, k: t[:, k * Q:(k + 1) * Q]
    ac = torch.cumsum(dtp.view(Bsz, K, Q, H) * A, 2)                 # [B, K, Q, H]
    last = ac[:, :, -1]
    coef = torch.exp(last[:, :, None] - ac) * dtp.view(Bsz, K, Q, H)
    e = torch.exp(ac)
    # what the forward kernel writes: the state before each chunk
    S = torch.zeros(Bsz, H, N, P) if s0 is None else s0
    before = []
    for k in range(K):
        before.append(S)
        wB = rnd(cut(Bp, k).repeat_interleave(hg, 2) * coef[:, k, :, :, None])
        S = torch.exp(last[:, k])[..., None, None] * S + torch.einsum("bqhn,bqhp->bhnp", wB,
                                                                       cut(xp, k))
    # launch 1
    dD = [sum(torch.einsum("bqhn,bqhp->bhnp", o, cut(gp, k)) for o in
              pair(cut(Cp, k).repeat_interleave(hg, 2) * e[:, k, :, :, None])) for k in range(K)]
    D = torch.zeros(Bsz, H, N, P) if ds_final is None else ds_final
    Dk, dots = [None] * K, [None] * K
    for k in reversed(range(K)):
        Dk[k], dots[k] = D, (rnd(D) * before[k]).sum((2, 3))
        D = torch.exp(last[:, k])[..., None, None] * D + dD[k]
    ds0 = D
    # launch 2
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    dx, ddt = torch.zeros_like(xp), torch.zeros_like(dtp)
    dB, dC = torch.zeros_like(Bp), torch.zeros_like(Cp)
    dA_part = torch.zeros(Bsz, H, K)
    for b in range(Bsz):
        for g in range(G):
            for k in range(K):
                sl = slice(k * Q, (k + 1) * Q)
                Bk, Ck = Bp[b, sl, g], Cp[b, sl, g]
                cb = Ck @ Bk.T
                dcb_sum, dB_acc, dC_acc = torch.zeros(Q, Q), torch.zeros(Q, N), torch.zeros(Q, N)
                for h in range(g * hg, (g + 1) * hg):
                    xk, gk, dtk = xp[b, sl, h], gp[b, sl, h], dtp[b, sl, h]
                    a_c, cf, ek = ac[b, k, :, h], coef[b, k, :, h], e[b, k, :, h]
                    decay = torch.exp((a_c[:, None] - a_c[None, :]).masked_fill(~causal,
                                                                                -float("inf")))
                    if intra:
                        decay, dtv = _bf16(decay), _bf16(dtk)
                        cbd = _bf16(_bf16(cb) * decay)
                    else:
                        dtv, cbd = dtk, cb * decay
                    w = rnd(cbd * dtv[None, :])
                    dW = (gk @ xk.T) * causal
                    D_op = rnd(Dk[k][b, h])
                    u = Bk @ D_op
                    dx[b, sl, h] = w.T @ gk + cf[:, None] * u
                    dcoef = (xk * u).sum(1)
                    dcb_sum += dW * decay * dtv[None, :]
                    dB_acc += cf[:, None] * (xk @ D_op.T)
                    dyS = gk @ rnd(before[k][b, h]).T
                    dC_acc += ek[:, None] * dyS
                    nm = dW * cbd
                    col = nm.sum(0)
                    dac = ((nm * dtk[None, :]).sum(1) - dtk * col + ek * (Ck * dyS).sum(1)
                           - cf * dcoef)
                    dac[-1] += (cf * dcoef).sum() + torch.exp(a_c[-1]) * dots[k][b, h]
                    da = torch.flip(torch.cumsum(torch.flip(dac, [0]), 0), [0])
                    ddt[b, sl, h] = col + torch.exp(a_c[-1] - a_c) * dcoef + A[h] * da
                    dA_part[b, h, k] = (dtk * da).sum()
                dcb_ops = pair(dcb_sum)
                dB[b, sl, g] = dB_acc + sum(o.T @ Ck for o in dcb_ops)
                dC[b, sl, g] = dC_acc + sum(o @ Bk for o in dcb_ops)
    return dx[:, :L], ddt[:, :L], dA_part.sum((0, 2)), dB[:, :L], dC[:, :L], ds0


def _state_case(rng, L, groups, H=2, P=4, N=8):
    args = _inputs(rng, B=1, L=L, H=H, P=P, N=N, G=groups)
    s0 = rng.normal(size=(1, H, N, P)).astype(np.float32)
    w = rng.normal(size=args[0].shape).astype(np.float32)
    wf = rng.normal(size=s0.shape).astype(np.float32)
    return args, s0, w, wf


@pytest.mark.parametrize("L, groups", [(37, 2), (150, 1)])
def test_kernel_algorithm_matches_autograd(rng, L, groups):
    """The backward kernel's formulas, state in and out, against autograd of
    ssd_chunked at the kernel's chunk; fp32 summation order only."""
    args, s0, w, wf = _state_case(rng, L, groups)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (*args, s0)]
    y, s = ssd_chunked(*leaves[:5], chunk_size=64, initial_state=leaves[5], return_final=True)
    loss = (y * torch.from_numpy(w)).sum() + (s * torch.from_numpy(wf)).sum()
    want = torch.autograd.grad(loss, leaves)
    got = kernel_backward(*(torch.from_numpy(a) for a in args), torch.from_numpy(w),
                          torch.from_numpy(s0), torch.from_numpy(wf))
    for name, a, b in zip(NAMES + ("initial_state",), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=GRAD_TOL * b.abs().max().item(),
                                   msg=name)


def test_kernel_algorithm_matches_jax_grad(rng):
    """The same formulas against jax.grad of the JAX ssd_chunked (chunk 64,
    G < H, three chunks), state in and out; fp32."""
    args, s0, w, wf = _state_case(rng, 150, 2, H=4)
    want = jax.grad(lambda *a: sum(jnp.sum(o * c) for o, c in zip(
        jssd.ssd_chunked(*a[:5], chunk_size=64, initial_state=a[5], return_final=True),
        (w, wf))), argnums=tuple(range(6)))(*[jnp.asarray(a) for a in (*args, s0)])
    got = kernel_backward(*(torch.from_numpy(a) for a in args), torch.from_numpy(w),
                          torch.from_numpy(s0), torch.from_numpy(wf))
    for name, a, b in zip(NAMES + ("initial_state",), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=GRAD_TOL * np.abs(b).max(),
                                   err_msg=name)


# chip_smoke.py's bounds on the bf16 backward against autograd of the bf16
# ssd_chunked, as max|d| / max|g| and mean|d| / mean|g| (dA: both 4e-2)
SMOKE_GRAD_BOUND, SMOKE_MEAN_BOUND, SMOKE_DA_BOUND = 2e-2, 1e-2, 4e-2


@pytest.mark.parametrize("intra", [False, True])
def test_kernel_roundings_within_the_smoke_bounds(rng, intra):
    """The bf16 instance's operand roundings (the forward's, plus D_k to
    bf16 and C e and the group's dcb as hi + lo), state in and out, against
    autograd of ssd_chunked on bf16 x, B, C and dy, intra_dtype off and bf16,
    at the bounds chip_smoke.py holds the kernel to (H 4 in two groups, two
    chunks)."""
    args, s0, w, wf = _state_case(rng, 100, 2, H=4, P=16, N=32)
    bf = torch.bfloat16
    x, dt, A, B, C = (torch.from_numpy(a) for a in args)
    x, B, C = x.to(bf), B.to(bf), C.to(bf)
    dy = torch.from_numpy(w).to(bf)
    s0, wf = torch.from_numpy(s0), torch.from_numpy(wf)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C, s0)]
    y, s = ssd_chunked(*leaves[:5], chunk_size=64, initial_state=leaves[5], return_final=True,
                       intra_dtype="bf16" if intra else None)
    want = torch.autograd.grad((y.float() * dy.float()).sum() + (s * wf).sum(), leaves)
    got = list(kernel_backward(x, dt, A, B, C, dy, s0, wf, intra=intra, low=True))
    for i in (0, 3, 4):                                   # dx, dB, dC leave in bf16
        got[i] = _bf16(got[i])
    for name, a, b in zip(NAMES + ("initial_state",), got, want):
        d, b = (a - b.float()).abs(), b.float().abs()
        bound, mean_bound = ((SMOKE_DA_BOUND,) * 2 if name == "A"
                             else (SMOKE_GRAD_BOUND, SMOKE_MEAN_BOUND))
        assert (d.max() / b.max()).item() <= bound, name
        assert (d.mean() / b.mean()).item() <= mean_bound, name
