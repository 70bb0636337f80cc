"""Mamba-2 selective state-space scan (SSD), forward, in plain PyTorch.

Counterpart of ``hnet_mamba_asr_tpu/ops/ssd.py``, with the same semantics and
shapes:

- ``ssd_reference``: the per-timestep recurrence, a Python loop over L; the
  oracle the tests hold everything else to.
- ``ssd_chunked``: the blockwise SSD form (Dao & Gu 2024). Within a chunk of
  Q positions the recurrence unrolls into a masked decay-weighted matmul;
  chunk boundary states carry it across chunks. It is the plain version of
  the Hopper kernel in ``ops/ssd_cuda.py`` and runs wherever tensors live.
- ``ssd``: the dispatch a model calls (``ops/ssd_cuda.py``).

Recurrence (per batch b, head h; state S in R^{N x P}):

    a_t = dt_t * A_h                       (A_h < 0, so exp(a_t) in (0, 1])
    S_t = exp(a_t) * S_{t-1} + dt_t * B_t outer x_t
    y_t = C_t @ S_t                        (+ D_h * x_t skip, applied by caller)

Shapes: x [B,L,H,P], dt [B,L,H], A [H], B/C [B,L,G,N] with G groups shared by
H//G heads each. y comes back in x's dtype; state and accumulation are fp32.

Rounding (``ssd_chunked``, as the JAX ``ssd_chunked`` rounds): the operands
of the three products with x and S, namely the intra-chunk weights W, the
decay-weighted B and the state before each chunk, are rounded to x's dtype;
every product accumulates in fp32. ``intra_dtype='bf16'`` also rounds the
scores C.B, the decays and dt to bf16 and forms W in bf16; with fp32 x the
last product of W (by dt) stays fp32, which is what XLA computes for the JAX
source, whose bf16 -> fp32 cast right after it folds that rounding away.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _expand_groups(mat: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, L, G, N] -> [B, L, H, N] by repeating each group over its heads."""
    G = mat.shape[2]
    if G == n_heads:
        return mat
    if n_heads % G:
        raise ValueError(f"n_heads={n_heads} not divisible by groups={G}")
    return mat.repeat_interleave(n_heads // G, dim=2)


def normalize_intra_dtype(intra_dtype: str | None) -> str | None:
    """'bf16'/'bfloat16' -> 'bf16'; None/'fp32'/'float32' -> None; else raise."""
    if intra_dtype in (None, "", "fp32", "float32"):
        return None
    if intra_dtype in ("bf16", "bfloat16"):
        return "bf16"
    raise ValueError(f"ssd intra_dtype must be None/'fp32' or 'bf16', "
                     f"got {intra_dtype!r}")


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 ``t`` rounded to ``dtype`` and held in fp32 again."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def ssd_reference(x, dt, A, B, C, initial_state=None, return_final=False):
    """Sequential oracle: loop over L with an fp32 state. Returns y [B,L,H,P]
    (or ``(y, S_final [B,H,N,P])`` with ``return_final``)."""
    Bsz, L, H, P = x.shape
    N = B.shape[-1]
    Bh = _expand_groups(B, H).float()
    Ch = _expand_groups(C, H).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    S = (torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * Af)[..., None, None]          # [B,H,1,1]
        S = decay * S + (dtf[:, t, :, None, None] * Bh[:, t, :, :, None]
                         * xf[:, t, :, None, :])                    # [B,H,N,P]
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], S))
    y = torch.stack(ys, dim=1).to(x.dtype)                          # [B,L,H,P]
    return (y, S) if return_final else y


def ssd_chunked(x, dt, A, B, C, chunk_size: int = 256, initial_state=None,
                return_final: bool = False, intra_dtype: str | None = None):
    """Chunked SSD: the same outputs as ``ssd_reference`` (fp32-accumulated),
    up to the roundings of x's dtype and ``intra_dtype`` (module docstring).

    L is padded up to a multiple of ``chunk_size`` internally (dt = 0 padding
    is an exact no-op for the recurrence: decay 1 and no state update).
    ``initial_state`` / ``return_final`` carry the [B, H, N, P] state across
    calls.
    """
    intra_dtype = normalize_intra_dtype(intra_dtype)
    low = x.dtype                                                   # MMA operand type
    Bsz, L, H, P = x.shape
    Q = int(chunk_size)
    pad = (-L) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    Lp = L + pad
    K = Lp // Q
    N = B.shape[-1]

    Bh = _expand_groups(B, H)
    Ch = _expand_groups(C, H)
    # head-major chunked views [B, K, H, Q, *]
    xc = x.reshape(Bsz, K, Q, H, P).permute(0, 1, 3, 2, 4).float()
    dtc = dt.reshape(Bsz, K, Q, H).permute(0, 1, 3, 2).float()
    Bc = Bh.reshape(Bsz, K, Q, H, N).permute(0, 1, 3, 2, 4).float()
    Cc = Ch.reshape(Bsz, K, Q, H, N).permute(0, 1, 3, 2, 4).float()

    a = dtc * A.float()[None, None, :, None]                        # [B,K,H,Q] (<= 0)
    ac = torch.cumsum(a, dim=3)                                     # within-chunk cumsum

    # intra-chunk: masked decay attention. Mask BEFORE the exp: the future
    # differences are positive and their exp overflows.
    seg = ac[..., :, None] - ac[..., None, :]                       # [B,K,H,Q,S]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    scores = torch.einsum("bkhqn,bkhsn->bkhqs", Cc, Bc)            # C_q . B_s
    if intra_dtype == "bf16":
        bf = torch.bfloat16
        weights = _rounded(_rounded(scores, bf) * _rounded(decay, bf), bf)
        weights = weights * _rounded(dtc, bf)[..., None, :]
    else:
        weights = scores * decay * dtc[..., None, :]
    weights = _rounded(weights, low)
    y_intra = torch.einsum("bkhqs,bkhsp->bkhqp", weights, xc)

    # chunk boundary states: S_k = sum_s exp(ac[last] - ac[s]) dt_s B_s x_s^T
    decay_to_end = torch.exp(ac[..., -1:] - ac)                     # [B,K,H,Q]
    wB = _rounded(Bc * (decay_to_end * dtc)[..., None], low)
    states = torch.einsum("bkhqn,bkhqp->bkhnp", wB, xc)

    # inter-chunk recurrence over the K chunk states
    chunk_decay = torch.exp(ac[..., -1])                            # [B,K,H]
    S = (torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    before = []
    for k in range(K):
        before.append(S)                                            # state BEFORE chunk k
        S = chunk_decay[:, k, :, None, None] * S + states[:, k]
    S_before = torch.stack(before, dim=1)                           # [B,K,H,N,P]

    # inter-chunk contribution: y_inter[q] = exp(ac[q]) * C_q @ S_before
    y_inter = torch.einsum("bkhqn,bkhnp->bkhqp", Cc, _rounded(S_before, low))
    y_inter = y_inter * torch.exp(ac)[..., None]

    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(Bsz, Lp, H, P)
    y = y[:, :L].to(x.dtype)
    return (y, S) if return_final else y


def ssd(x, dt, A, B, C, chunk_size: int = 256, intra_dtype: str | None = None):
    """The scan a model calls: the hand-written kernel on CUDA tensors; its
    wrapper runs ``ssd_chunked`` for tensors that lie on the CPU."""
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    return ssd_cuda(x, dt, A, B, C, chunk_size=chunk_size, intra_dtype=intra_dtype)
