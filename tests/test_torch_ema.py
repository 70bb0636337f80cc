"""The decomposition of the Hopper EMA kernels (csrc/ema.cu), written in
plain torch in the kernels' order of steps and held, in fp32 on the CPU, to
the JAX package's ``ema_smooth_sequential`` (values) and to the gradients of
its ``ema_smooth`` (``jax.vjp``). The kernels scan the recurrence
x_t = a_t x_{t-1} + b_t (a_t = 1 - P_t, b_t = P_t z_t; (a_0, b_0) = (0, z_0))
in chunks of C slots and tiles of T channels, a CTA each. Inside a chunk S
sub-chunks run their chains from a zero state (a thread each per pair of
channels); their end states and decay products fold, in scan order, into the
chunk's aggregate and decay product A. Across chunks the carries fold in
chunk order, inc_c = A_c carry_c + agg_c. Each sub-chunk then runs its chain
again from its carry (the chunk's, folded through the sub-chunks before it).
The backward runs the same from the last chunk for h_t = g_t + a_{t+1}
h_{t+1}, and dP sums each tile's channels into a partial per (row, slot,
tile), then the partials in tile order.

This file is the kernels' specification of what is computed in which
order, not of their bits: a fold here rounds its product and its sum apart
where the kernels' fmaf rounds once, and a tile's dP terms add in torch's
order, not the kernels' fixed walk. That two calls of the kernels give the
same bits is shown on the card (tests/test_torch_cuda.py,
``test_ema_backward_is_deterministic``), where those tests also hold the
kernels to the plain recurrence."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hnet_mamba_asr_tpu.ops import ema as jema

P_CLAMP = 1e-4
# fp32 against the literal recurrence (JAX's lax.scan), as max|d| / max|ref|:
# the chunked form reassociates each chain once at a chunk boundary (the
# carry times the decay product), 1e-5, the kernels' bound on the card.
SEQ_BOUND = 1e-5
# against the gradients of the matmul form (jax.vjp of ema_smooth): its
# weights exp(S_t - S_j) difference two cumsums of up to ~200 logs here and
# carry error of their own (8.3e-6 of the max at M 204); 5e-5.
GRAD_BOUND = 5e-5


def chain(a, w, v, x, slots):
    """x_t = a_t x_{t-1} + w_t v_t over ``slots`` in their order, from x; the
    end state and the decay product, and each slot's state."""
    A, states = torch.ones(a.shape[0]), {}
    for t in slots:
        x = a[:, t, None] * x + w[:, t, None] * v[:, t]
        A = A * a[:, t]
        states[t] = x
    return x, A, states


def fold(A, x, v):
    """A x + v of a decay product, a carry and an aggregate (the kernels'
    fmaf, rounded twice here)."""
    return A[:, None] * x + v


def scan_chunked(a, w, v, C, S, reverse=False):
    """One channel tile of the kernels' scan of x_t = a_t x_{t-1} + w_t v_t
    (from the end when ``reverse``, each a_t then belonging to the slot the
    chain leaves): chunks of C slots in S sub-chunks of C / S. Returns every
    slot's state [B, M, T]."""
    Bsz, M, T = v.shape
    sub = C // S
    chunks = [(c0, min(c0 + C, M)) for c0 in range(0, M, C)]
    if reverse:
        chunks = chunks[::-1]
    order = (lambda lo, hi: range(hi - 1, lo - 1, -1)) if reverse else range
    zero = torch.zeros(Bsz, T)
    aggs, decays, subs = [], [], []
    for c0, c1 in chunks:                              # pass 1: sub-chunks from zero
        spans = [(s0, min(s0 + sub, c1)) for s0 in range(c0, c0 + C, sub)]
        ends = [chain(a, w, v, zero, order(s0, s1))[:2] for s0, s1 in spans]
        if reverse:
            ends, spans = ends[::-1], spans[::-1]
        agg, A = ends[0]
        for end, dec in ends[1:]:                      # the sub-chunks folded in scan order
            agg, A = fold(dec, agg, end), A * dec
        aggs.append(agg)
        decays.append(A)
        subs.append((spans, ends))
    carries = chain_carries(aggs, decays)
    out = torch.empty_like(v)
    for (spans, ends), carry in zip(subs, carries):    # pass 2: each sub-chunk from its carry
        x = carry
        for (s0, s1), (end, dec) in zip(spans, ends):
            _, _, states = chain(a, w, v, x, order(s0, s1))
            for t, state in states.items():
                out[:, t] = state
            x = fold(dec, x, end)
    return out


def chain_carries(aggs, decays):
    """Carries into each chunk in scan order: carry_0 = 0, inc_0 = agg_0,
    carry_c = inc_{c-1}, inc_c = A_c carry_c + agg_c."""
    carries, inc = [torch.zeros_like(aggs[0])], aggs[0]
    for agg, A in zip(aggs[1:], decays[1:]):
        carries.append(inc)
        inc = fold(A, inc, agg)
    return carries


def ema_forward_chunked(z, p, C, S, T, p_clamp=P_CLAMP):
    """``ema_fwd_kernel``: zbar [B, M, D] (fp32)."""
    pc = p.clamp(p_clamp, 1.0 - p_clamp)
    a, w = 1.0 - pc, pc.clone()
    a[:, 0], w[:, 0] = 0.0, 1.0                        # (a_0, b_0) = (0, z_0)
    out = torch.empty_like(z)
    for d0 in range(0, z.shape[2], T):                 # tiles are independent
        out[:, :, d0:d0 + T] = scan_chunked(a, w, z[:, :, d0:d0 + T], C, S)
    return out


def ema_backward_chunked(z, p, zbar, g, C, S, T, p_clamp=P_CLAMP):
    """``ema_bwd_kernel``: dz [B, M, D] and dP [B, M] (fp32) from the
    forward's output: the reverse scan h_t = a_{t+1} h_{t+1} + g_t in chunks
    from the last one, and dP as partials per (row, slot, tile) summed in
    tile order."""
    Bsz, M, D = z.shape
    lo, hi = p_clamp, 1.0 - p_clamp
    pc = p.clamp(lo, hi)
    a_next = torch.zeros_like(pc)                      # a_{t+1}; 0 past the end
    a_next[:, :-1] = 1.0 - pc[:, 1:]
    w = pc.clone()
    w[:, 0] = 1.0                                      # dz_0 = h_0
    dz, parts = torch.empty_like(z), []
    for d0 in range(0, D, T):
        sl = slice(d0, d0 + T)
        h = scan_chunked(a_next, torch.ones_like(a_next), g[:, :, sl], C, S, reverse=True)
        dz[:, :, sl] = w[:, :, None] * h
        part = torch.zeros(Bsz, M)
        part[:, 1:] = (h[:, 1:] * (z[:, 1:, sl] - zbar[:, :-1, sl])).sum(-1)
        parts.append(part)
    dp = parts[0]
    for part in parts[1:]:                             # tile order
        dp = dp + part
    inside = (p >= np.float32(lo)) & (p <= np.float32(hi))
    inside[:, 0] = False                               # dP_0 = 0
    return dz, torch.where(inside, dp, 0.0)


# M = 1, C - 1, C, C + 1 and ~3.2 C for two chunk lengths, each in 4
# sub-chunks as the kernels' (2 and 16 slots); D 10 in tiles of 4 channels
# (the last tile holds 2)
CASES = [(C, M) for C in (8, 64) for M in (1, C - 1, C, C + 1, int(3.2 * C))]
M_MAX = max(M for _, M in CASES)


@pytest.fixture(scope="module")
def jax_reference():
    """Inputs at M_MAX and JAX's answers for every prefix M of them, from
    one compiled call each: the recurrence is causal, so zbar of z[:, :M] is
    zbar[:, :M], and the gradients of sum(ema_smooth(z[:, :M]) * g[:, :M])
    are those of the whole with g zero past M, cut to M."""
    rng = np.random.default_rng(0)
    z = rng.normal(size=(2, M_MAX, 10)).astype(np.float32)
    p = (rng.uniform(size=(2, M_MAX)) * 0.8 + 0.1).astype(np.float32)
    p[:, ::10] = 1.0                                   # saturated boundaries
    p[:, 5::10] = 0.0                                  # pad slots
    g = rng.normal(size=z.shape).astype(np.float32)
    seq = np.asarray(jema.ema_smooth_sequential(jnp.asarray(z), jnp.asarray(p), P_CLAMP))
    _, vjp = jax.vjp(lambda zz, pp: jema.ema_smooth(zz, pp, P_CLAMP), jnp.asarray(z),
                     jnp.asarray(p))

    def at(M):
        gm = g.copy()
        gm[:, M:] = 0.0
        wz, wp = (np.asarray(a)[:, :M] for a in vjp(jnp.asarray(gm)))
        return (*(torch.from_numpy(a[:, :M].copy()) for a in (z, p, g)),
                torch.from_numpy(seq[:, :M].copy()), torch.from_numpy(wz.copy()),
                torch.from_numpy(wp.copy()))
    return at


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("C,M", CASES)
def test_chunked_scan_matches_jax(jax_reference, C, M):
    z, p, g, want, wz, wp = jax_reference(M)
    zbar = ema_forward_chunked(z, p, C, S=4, T=4)
    assert _rel(zbar, want) <= SEQ_BOUND
    if M == 1:
        assert torch.equal(zbar, z)
    dz, dp = ema_backward_chunked(z, p, zbar, g, C, S=4, T=4)
    assert _rel(dz, wz) <= GRAD_BOUND
    if M > 1:
        assert _rel(dp, wp) <= GRAD_BOUND
    assert not dp[:, 0].any() and not dp[:, ::10].any() and not dp[:, 5::10].any()
