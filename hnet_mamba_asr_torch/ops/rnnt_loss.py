"""RNN-T (transducer) loss, the plain version: counterpart of
``hnet_mamba_asr_tpu/ops/rnnt_loss.py``, in JAX's formulation.

The transducer objective marginalizes every monotonic alignment of the
labels y[0:U) to T encoder frames through the (T, U+1) lattice

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + label[t, u-1])
    loss = -(alpha[T-1, U] + blank[T-1, U])

as JAX computes it: a loop over frames with the alpha row [B, U+1] as
carry, and inside each frame the label chain as one cumulative logsumexp
over u after an exclusive cumsum of the label scores, differentiated by
autograd. The finite NEG_INF (-1e30) and the soft -3e4 mask of label
transitions past a row's target length are JAX's: with -inf, or with
-1e30 in the cumsum, ``logcumsumexp`` and the cumsum give inf - inf = NaN
gradients. A row with feat_length 0 gives the value of feat_length 1
(finite), as in JAX; callers mask such rows.

The CPU route of ``ops/rnnt_cuda.py::rnnt_loss_cuda`` and the CPU tests use
this version. Beside it, ``rnnt_fwd_plain`` / ``rnnt_bwd_plain`` are the
plain versions of the kernels of ``csrc/rnnt.cu``, with their signatures:
the forward from the logits to (loss, lse, w), the backward from those to
(dlogits, cb, cl), both walking the lattice's anti-diagonals vectorised over
the batch. ``w``, ``cb`` and ``cl`` are stored as the kernels store them,
by anti-diagonal: [B, T+U, U+1] with cell (t, u) at [b, t+u, u] (``skew`` /
``unskew``). The CPU tests hold them to JAX's ``rnnt_loss`` and its
gradient; ``chip_smoke.py`` holds the kernels to them.
"""
from __future__ import annotations

import torch

NEG_INF = -1.0e30
SOFT_NEG = -3.0e4


def lattice_scores(logits: torch.Tensor, targets: torch.Tensor, target_lengths: torch.Tensor,
                   blank_id: int):
    """logits [B, T, U+1, V] -> (blank [B, T, U+1], label [B, T, U]) fp32
    log-probs: the fp32 log-softmax over V, the blank column and the
    targets' column (ids clipped to [0, V))."""
    B, T, U1, V = logits.shape
    U = U1 - 1
    if targets.shape[1] != U:
        raise ValueError(f"targets U={targets.shape[1]} != logits U+1-1={U}")
    lp = torch.log_softmax(logits.float(), dim=-1)
    blank = lp[..., blank_id]
    tgt = targets.long().clamp(0, V - 1)
    label = torch.gather(lp[:, :, :U, :], 3, tgt[:, None, :, None].expand(B, T, U, 1))[..., 0]
    return blank, label


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def lattice_nll(blank: torch.Tensor, label: torch.Tensor, feat_lengths: torch.Tensor,
                target_lengths: torch.Tensor) -> torch.Tensor:
    """blank [B, T, U+1], label [B, T, U] fp32 log-probs -> the per-row
    negative log-likelihood [B] (JAX's frame scan)."""
    B, T, U1 = blank.shape
    U = U1 - 1
    dev = blank.device
    u_ids = torch.arange(U, device=dev)
    lab = torch.where((u_ids[None, :] < target_lengths[:, None])[:, None, :], label,
                      torch.full((), SOFT_NEG, device=dev))
    alpha = torch.full((B, U1), NEG_INF, device=dev)
    alpha[:, 0] = 0.0
    zero = torch.zeros((B, 1), device=dev)
    betas = []
    for t in range(T):
        # alpha = base(u) entering frame t; the label chain unrolls to one
        # cumulative logsumexp: A_t(u) = c[u] + logcumsumexp_u(base - c)
        c = torch.cat([zero, torch.cumsum(lab[:, t], dim=1)], dim=1)
        beta = c + torch.logcumsumexp(alpha - c, dim=1)
        alpha = torch.where((t < feat_lengths)[:, None], beta + blank[:, t], alpha)
        betas.append(beta)
    betas = torch.stack(betas, dim=1)                                   # [B, T, U+1]
    last = (feat_lengths.long() - 1).clamp(min=0)
    ar = torch.arange(B, device=dev)
    u_last = target_lengths.long().clamp(0, U)
    return -(betas[ar, last, u_last] + blank[ar, last, u_last])


def skew(x: torch.Tensor) -> torch.Tensor:
    """[B, T, U+1] -> [B, T+U, U+1] by anti-diagonal: cell (t, u) at
    [b, t+u, u], 0 where a diagonal has no cell."""
    B, T, U1 = x.shape
    t = (torch.arange(T + U1 - 1, device=x.device)[:, None]
         - torch.arange(U1, device=x.device)[None, :])
    out = torch.gather(x, 1, t.clamp(0, T - 1).expand(B, -1, -1))
    return torch.where((t >= 0) & (t < T), out, torch.zeros((), dtype=x.dtype, device=x.device))


def unskew(x: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T+U, U+1] by anti-diagonal -> [B, T, U+1]."""
    B, _, U1 = x.shape
    d = torch.arange(T, device=x.device)[:, None] + torch.arange(U1, device=x.device)[None, :]
    return torch.gather(x, 1, d.expand(B, -1, -1))


def _plain_lattice(logits, feat_lengths, target_lengths, classes):
    """The logits' V classes in the compute dtype (fp64 for fp64 logits,
    else fp32), and each row's T_b, U_b and last diagonal T_b - 1 + U_b."""
    x = logits[..., :classes] if classes is not None else logits
    x = x.to(torch.float64 if logits.dtype == torch.float64 else torch.float32)
    _, T, U1, _ = x.shape
    tb = torch.as_tensor(feat_lengths, device=x.device).long().clamp(1, T)
    ub = torch.as_tensor(target_lengths, device=x.device).long().clamp(0, U1 - 1)
    return x, tb, ub, tb - 1 + ub


def rnnt_fwd_plain(logits: torch.Tensor, targets: torch.Tensor, feat_lengths: torch.Tensor,
                   target_lengths: torch.Tensor, blank_id: int, classes: int | None = None):
    """The forward kernel's function: logits [B, T, U+1, W] (the first
    ``classes`` columns are the classes, all W without it) -> (loss [B],
    lse [B, T, U+1], w [B, T+U, U+1]): the per-row NLL, each cell's
    log-sum-exp and the share of its mass that came in by the blank (0
    outside the lattice and at (0, 0)), in fp32 (fp64 for fp64 logits)."""
    x, tb, ub, last = _plain_lattice(logits, feat_lengths, target_lengths, classes)
    B, T, U1, V = x.shape
    U = U1 - 1
    lse = torch.logsumexp(x, dim=-1)
    tgt = targets.to(x.device).long().clamp(0, V - 1)
    label = torch.gather(x[:, :, :U], 3, tgt[:, None, :, None].expand(B, T, U, 1))[..., 0]
    sb = skew(x[..., blank_id] - lse)
    sl = skew(torch.nn.functional.pad(label - lse[:, :, :U], (0, 1)))
    u = torch.arange(U1, device=x.device)
    alpha = torch.full((B, U1), NEG_INF, dtype=x.dtype, device=x.device)
    alpha[:, 0] = 0.0
    neg = alpha[:, 1:2].clone()
    w = torch.zeros((B, T + U, U1), dtype=x.dtype, device=x.device)
    final = torch.zeros(B, dtype=x.dtype, device=x.device)
    ar = torch.arange(B, device=x.device)
    for d in range(1, int(last.max()) + 1):
        t = d - u
        active = (t >= 0) & (t < tb[:, None]) & (u <= ub[:, None])
        a = torch.where(t >= 1, alpha + sb[:, d - 1], NEG_INF)
        c = torch.cat([neg, alpha[:, :-1] + sl[:, d - 1, :-1]], 1)
        v = torch.logaddexp(a, c)
        w[:, d] = torch.where(active, torch.exp(a - v), 0.0)
        alpha = torch.where(active, v, NEG_INF)
        final = torch.where(last == d, alpha[ar, ub], final)
    return -(final + sb[ar, last, ub]), lse, w


def rnnt_bwd_plain(logits: torch.Tensor, lse: torch.Tensor, w: torch.Tensor,
                   targets: torch.Tensor, feat_lengths: torch.Tensor,
                   target_lengths: torch.Tensor, blank_id: int, g: torch.Tensor,
                   classes: int | None = None):
    """The backward kernel's function: from the forward's lse and shares and
    the loss's gradient g [B] -> (dlogits in the logits' dtype and shape,
    zeros outside each lattice and past ``classes``; cb, cl [B, T+U, U+1]:
    the gradients of the blank and label scores, 0 outside the lattice)."""
    x, tb, ub, last = _plain_lattice(logits, feat_lengths, target_lengths, classes)
    B, T, U1, V = x.shape
    U = U1 - 1
    u = torch.arange(U1, device=x.device)
    w = w.to(x.dtype)
    g = g.to(x.device, x.dtype)[:, None]
    gam = torch.zeros((B, U1), dtype=x.dtype, device=x.device)
    zero = gam[:, :1].clone()
    cb = torch.zeros((B, T + U, U1), dtype=x.dtype, device=x.device)
    cl = torch.zeros_like(cb)
    for d in range(int(last.max()), -1, -1):
        t = d - u
        active = (t >= 0) & (t < tb[:, None]) & (u <= ub[:, None])
        final_frame = t == tb[:, None] - 1
        wn = w[:, d + 1] if d + 1 < T + U else torch.zeros_like(gam)
        vb = torch.where(t < tb[:, None] - 1, gam * wn,
                         (final_frame & (u == ub[:, None])).to(x.dtype))
        vl = torch.where(u < ub[:, None], torch.cat([gam[:, 1:] * (1 - wn[:, 1:]), zero], 1),
                         0.0)
        cb[:, d] = torch.where(active & ~(final_frame & (u != ub[:, None])), -g * vb, 0.0)
        cl[:, d] = torch.where(active & (u < ub[:, None]), -g * vl, 0.0)
        gam = torch.where(active, vb + vl, 0.0)
    cbn, cln = unskew(cb, T), unskew(cl, T)
    dl = -torch.exp(x - lse.to(x.dtype)[..., None]) * (cbn + cln)[..., None]
    dl[..., blank_id] += cbn
    tgt = torch.nn.functional.pad(targets.to(x.device).long().clamp(0, V - 1), (0, 1))
    dl.scatter_add_(3, tgt[:, None, :, None].expand(B, T, U1, 1), cln[..., None])
    out = torch.zeros(logits.shape, dtype=logits.dtype, device=logits.device)
    out[..., :V] = dl
    return out, cb, cl


def rnnt_loss(logits: torch.Tensor, feat_lengths: torch.Tensor, targets: torch.Tensor,
              target_lengths: torch.Tensor, *, blank_id: int,
              reduction: str = "mean") -> torch.Tensor:
    """logits [B, T, U+1, V] (unnormalized joint outputs), feat_lengths [B],
    targets [B, U] (padding past target_lengths ignored), target_lengths
    [B] <= U -> -log P(y | x): [B] for "none", a scalar for "mean" / "sum"
    (over the batch; no per-length normalization)."""
    blank, label = lattice_scores(logits, targets, target_lengths, blank_id)
    return reduce_loss(lattice_nll(blank, label, feat_lengths, target_lengths), reduction)
