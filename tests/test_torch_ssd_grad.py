"""Gradients of the port's SSD on the CPU: autograd of
hnet_mamba_asr_torch/ops/ssd.py::ssd_chunked (the plain backward) against
jax.grad of the JAX ssd_chunked, plain and with its hand-written intra-chunk
VJP (custom_vjp=True); the gradient cases of tests/test_ssd.py; the SSDScan
node on CPU tensors; and the backward kernel's algorithm (csrc/ssd_bwd.cu),
written out in torch, against autograd."""
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


def kernel_backward(x, dt, A, B, C, dy, s0=None, ds_final=None, Q=64):
    """csrc/ssd_bwd.cu's algorithm in torch (fp32): per (b, h), the chunks in
    reverse with the carried gradient D of the state after the chunk; the
    per-head dB / dC summed over the group's heads at the end."""
    Bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    pad = (-L) % Q
    padt = lambda t: torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    xp, gp, dtp = padt(x), padt(dy), padt(dt)
    Bp, Cp = padt(_expand_groups(B, H)), padt(_expand_groups(C, H))
    K = (L + pad) // Q
    dx, ddt = torch.zeros_like(xp), torch.zeros_like(dtp)
    dBh, dCh = torch.zeros_like(Bp), torch.zeros_like(Cp)
    dA, ds0 = torch.zeros(H), torch.zeros(Bsz, H, N, P)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    for b in range(Bsz):
        for h in range(H):
            S = torch.zeros(N, P) if s0 is None else s0[b, h]
            before = []                                  # what the forward kernel writes
            for k in range(K):
                sl = slice(k * Q, (k + 1) * Q)
                ac = torch.cumsum(dtp[b, sl, h] * A[h], 0)
                coef = torch.exp(ac[-1] - ac) * dtp[b, sl, h]
                before.append(S)
                S = torch.exp(ac[-1]) * S + (Bp[b, sl, h] * coef[:, None]).T @ xp[b, sl, h]
            D = torch.zeros(N, P) if ds_final is None else ds_final[b, h]
            for k in reversed(range(K)):
                sl = slice(k * Q, (k + 1) * Q)
                xk, gk, Bk, Ck, dtk = xp[b, sl, h], gp[b, sl, h], Bp[b, sl, h], Cp[b, sl, h], \
                    dtp[b, sl, h]
                ac = torch.cumsum(dtk * A[h], 0)
                last = ac[-1]
                coef, e = torch.exp(last - ac) * dtk, torch.exp(ac)
                decay = torch.exp((ac[:, None] - ac[None, :]).masked_fill(~causal, -float("inf")))
                cbd = (Ck @ Bk.T) * decay
                dW = (gk @ xk.T) * causal
                nm, dcb = dW * cbd, dW * decay * dtk[None, :]
                u = Bk @ D
                dx[b, sl, h] = (cbd * dtk[None, :]).T @ gk + coef[:, None] * u
                dcoef = (xk * u).sum(1)
                dBh[b, sl, h] = dcb.T @ Ck + coef[:, None] * (xk @ D.T)
                dc_inter = e[:, None] * (gk @ before[k].T)
                dCh[b, sl, h] = dcb @ Bk + dc_inter
                dac = ((nm * dtk[None, :]).sum(1) - dtk * nm.sum(0) + (Ck * dc_inter).sum(1)
                       - coef * dcoef)
                dac[-1] += (coef * dcoef).sum() + torch.exp(last) * (D * before[k]).sum()
                da = torch.flip(torch.cumsum(torch.flip(dac, [0]), 0), [0])
                ddt[b, sl, h] = nm.sum(0) + torch.exp(last - ac) * dcoef + A[h] * da
                dA[h] += (dtk * da).sum()
                D = torch.exp(last) * D + Ck.T @ (e[:, None] * gk)
            ds0[b, h] = D
    group = lambda t: t[:, :L].reshape(Bsz, L, G, H // G, N).sum(3)
    return dx[:, :L], ddt[:, :L], dA, group(dBh), group(dCh), ds0


@pytest.mark.parametrize("L, groups", [(37, 2), (150, 1)])
def test_kernel_algorithm_matches_autograd(rng, L, groups):
    """The backward kernel's formulas, state in and out, against autograd of
    ssd_chunked at the kernel's chunk; fp32 summation order only."""
    args = _inputs(rng, B=1, L=L, H=2, P=4, N=8, G=groups)
    s0 = rng.normal(size=(1, 2, 8, 4)).astype(np.float32)
    w = rng.normal(size=args[0].shape).astype(np.float32)
    wf = rng.normal(size=s0.shape).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (*args, s0)]
    y, s = ssd_chunked(*leaves[:5], chunk_size=64, initial_state=leaves[5], return_final=True)
    loss = (y * torch.from_numpy(w)).sum() + (s * torch.from_numpy(wf)).sum()
    want = torch.autograd.grad(loss, leaves)
    got = kernel_backward(*(torch.from_numpy(a) for a in args), torch.from_numpy(w),
                          torch.from_numpy(s0), torch.from_numpy(wf))
    for name, a, b in zip(NAMES + ("initial_state",), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=GRAD_TOL * b.abs().max().item(),
                                   msg=name)
