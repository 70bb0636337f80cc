"""Mixture-of-Experts FFN with capacity dispatch, counterpart of
``hnet_mamba_asr_tpu/models/moe.py``: a drop-in for the dense GELU FFN of
the Transformer LM blocks and the AED decoder layers.

Routing is JAX's, exactly: fp32 router logits and softmax, the top ``k``
experts (ties to the lower index, as ``lax.top_k``) with their gates
renormalized, padded tokens (``token_mask`` False) routed nowhere. Every
expert owns C = ceil(S k cf / E) slots (cf rounded to 1/1024), rounded up to
a multiple of 8 and capped at S rounded up to 8; slots go in slot-major
order (every token's first choice before any second choice, earlier tokens
first within a choice), and a token over its expert's capacity is dropped
from that expert (its branch adds 0 there). When a global batch's rows
are split over ranks (``parallel/collectives.py::rows_split_over``), the
capacity is the global batch's and the positions are those of its global
slot-major order (one all-gather of the ranks' per-choice expert counts),
so that each rank keeps and drops what one process would.

JAX builds [S, E, C] one-hot dispatch and combine tensors for the TPU's
matrix unit; here the kept (token, slot) pairs are indexed into an [E, C, D]
buffer, the experts run as two batched matmuls (``torch.bmm``, as JAX leaves
them to XLA), and each token gathers its k outputs back, weighted by its
gates, summed over its choices in order. No atomics.

Instead of flax's ``sow``, ``forward`` returns the Switch load-balance aux
loss E sum_e f_e p_e and the dropped share with the output; ``moe_aux``
averages a list of them over layers, as ``moe_aux_from_vars`` does.
Parameters keep the JAX names and stacked layouts: ``router`` [D, E],
``w1`` [E, D, F], ``b1`` [E, F], ``w2`` [E, F, D], ``b2`` [E, D].

Under expert parallelism (``mp``, ``parallel/model_parallel.py``) a rank
holds experts [r E / ep, (r + 1) E / ep) and the router whole. The ranks of
an ep group hold the same rows (the batch splits over dp only), so they
route alike (capacity and slot order over the dp group's global batch) and
need no all-to-all: each rank fills and runs its own experts' slots from
``copy_to_model`` of the tokens (the router reads them as they are), and
the picked outputs, zeros where an expert is not the rank's, are summed
over the ranks in fp32 (``reduce_from_model``: x + 0 = x) before the
gate-weighted sum over each token's choices, in choice order, so that ep
computes one process's bits where the expert GEMMs agree.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn as nn
import torch.nn.functional as F

from hnet_mamba_asr_torch.models.mamba2 import dense, lecun_normal_
from hnet_mamba_asr_torch.parallel.model_parallel import even_split
from hnet_mamba_asr_torch.parallel.collectives import (all_gather, batch_sum, row_slice,
                                                       rows_group)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def capacity(S: int, k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert for S tokens (JAX's rule)."""
    C = max(1, -(-S * k * int(round(capacity_factor * 1024)) // (n_experts * 1024)))
    return min(_round_up(S, 8), _round_up(C, 8))


def _global_offsets(onehot: torch.Tensor, k: int, S: int, rank: int) -> torch.Tensor:
    """[k, E]: what a slot's position in its expert's queue gains when this
    rank's S tokens are one block of a global batch split over ranks in
    order: the earlier choices' entries of every rank, and this choice's
    entries of the earlier ranks, less this rank's earlier choices."""
    mine = onehot.reshape(k, S, -1).sum(1)                             # [k, E]
    every = all_gather(mine, rows_group())                             # [W, k, E]
    total = every.sum(0)
    return (torch.cumsum(total, 0) - total + every[:rank].sum(0)
            - (torch.cumsum(mine, 0) - mine))


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``lax.top_k``'s order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


class MoEFFN(nn.Module):
    """Top-k routed mixture of tanh-GELU FFN experts: x [..., D] -> (y [..., D],
    aux, dropped)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.float32,
                 generator=None):
        super().__init__()
        E, D, Fh = n_experts, d_model, d_ff
        self.n_experts, self.top_k, self.capacity_factor = E, top_k, capacity_factor
        self.dtype = dtype
        self.router = nn.Parameter(torch.empty(D, E))
        self.w1 = nn.Parameter(torch.empty(E, D, Fh))
        self.b1 = nn.Parameter(torch.zeros(E, Fh))
        self.w2 = nn.Parameter(torch.empty(E, Fh, D))
        self.b2 = nn.Parameter(torch.zeros(E, D))
        # flax lecun_normal: fan_in D for the router and w1 (batch axis 0), F for w2
        lecun_normal_(self.router, D, generator)
        lecun_normal_(self.w1, D, generator)
        lecun_normal_(self.w2, Fh, generator)
        self.mp = None                       # an ep Plane (parallel/model_parallel.py)

    def ep_plan(self, ep: int, prefix: str = "") -> dict:
        """The stacked expert leaves split over their expert axis: rank r
        holds experts [r E / ep, (r + 1) E / ep); the router stays whole."""
        return {leaf: (0, even_split(getattr(self, leaf).shape[0], ep, f"{prefix}.{leaf}", 0,
                                     getattr(self, leaf).shape))
                for leaf in ("w1", "b1", "w2", "b2")}

    def route(self, xs: torch.Tensor, valid: torch.Tensor):
        """xs [S, D], valid [S] -> (probs [S, E] fp32, gates [S, k], experts
        [S, k]); invalid tokens' gates are 0."""
        probs = torch.softmax(xs.float() @ self.router, dim=-1)
        gates, experts = top_k_stable(probs, min(self.top_k, self.n_experts))
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        return probs, torch.where(valid[:, None], gates, 0.0), experts

    def experts(self, xin: torch.Tensor, s: int | None = None) -> torch.Tensor:
        """[E, C, D] -> every expert's FFN over its slots [E, C, D] (the
        experts of ep shard ``s``: [E / ep, C, D])."""
        cd = self.dtype
        w1, b1, w2, b2 = ((self.w1, self.b1, self.w2, self.b2) if s is None else
                          (self.mp.take(getattr(self, n), n, s) for n in ("w1", "b1", "w2", "b2")))
        h = F.gelu(torch.bmm(xin, w1.to(cd)) + b1.to(cd)[:, None, :], approximate="tanh")
        return torch.bmm(h, w2.to(cd)) + b2.to(cd)[:, None, :]

    def _picked_ep(self, xs, flat_e, pos, keep, token, C: int) -> torch.Tensor:
        """[k S, D]: each (choice, token)'s expert output, from the shards of
        ``mp``, zeros where the token was dropped (module docstring)."""
        mp, cd = self.mp, self.dtype
        El, D = self.n_experts // mp.size, xs.shape[-1]
        xes = mp.fan(xs)
        parts = []
        for xe, s in zip(xes, mp.shards):
            mine = keep & (flat_e >= s * El) & (flat_e < (s + 1) * El)
            kept = mine.nonzero()[:, 0]
            e, slot = flat_e[kept] - s * El, pos[kept]
            xin = torch.zeros(El, C, D, dtype=cd, device=xs.device)
            xin[e, slot] = xe[token[kept]].to(cd)
            out = self.experts(xin, s)
            picked = torch.zeros(flat_e.shape[0], D, dtype=torch.float32, device=xs.device)
            parts.append(picked.index_put((kept,), out[e, slot].float()))
        return mp.reduce(parts).to(cd)

    def forward(self, x: torch.Tensor, token_mask: torch.Tensor | None = None):
        E, D = self.n_experts, x.shape[-1]
        lead = x.shape[:-1]
        S = math.prod(lead)
        k = min(self.top_k, E)
        xs = x.reshape(S, D)
        dev = x.device
        valid = (torch.ones(S, dtype=torch.bool, device=dev) if token_mask is None
                 else token_mask.reshape(S))
        probs, gates, experts = self.route(xs, valid)
        part = row_slice()                     # the rows of one global batch, split
        C = capacity(S * (part[1] if part else 1), k, E, self.capacity_factor)

        # slot-major positions: choice j of token s is entry j * S + s
        flat_e = experts.T.reshape(-1)                                 # [k S]
        flat_gate = gates.T.reshape(-1)
        flat_valid = valid.repeat(k) & (flat_gate > 0)
        onehot = F.one_hot(flat_e, E) * flat_valid[:, None]            # [k S, E]
        pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
        if part:
            pos = pos + _global_offsets(onehot, k, S, part[0])[
                torch.arange(k * S, device=dev) // S, flat_e]
        keep = flat_valid & (pos < C)

        # dispatch the kept (token, slot) pairs into [E, C, D]; run the experts
        cd = self.dtype
        token = torch.arange(k * S, device=dev) % S
        if self.mp is not None:
            picked = self._picked_ep(xs, flat_e, pos, keep, token, C)
        else:
            kept = keep.nonzero()[:, 0]
            xin = torch.zeros(E, C, D, dtype=cd, device=dev)
            xin[flat_e[kept], pos[kept]] = xs[token[kept]].to(cd)
            out = self.experts(xin)
            picked = out[flat_e, pos.clamp(max=C - 1)]                 # [k S, D]

        # combine: each token's k choices, gate-weighted, summed in choice order
        w = torch.where(keep, flat_gate, 0.0).to(cd)
        y = (w[:, None] * picked).reshape(k, S, D).sum(0)

        # Switch load-balance aux and the dropped share
        # the routing shares of the global batch (batch_sum) before the aux
        vf = valid.float()
        n_valid = batch_sum(vf.sum()).clamp(min=1.0)
        f_e = batch_sum((F.one_hot(experts[:, 0], E).float() * vf[:, None]).sum(0)) / n_valid
        p_e = batch_sum((probs * vf[:, None]).sum(0)) / n_valid
        aux = E * (f_e * p_e).sum()
        dropped = 1.0 - batch_sum(keep.sum()) / batch_sum(flat_valid.sum()).clamp(min=1)
        return y.reshape(*lead, D).to(x.dtype), aux, dropped.detach().float()


def dense_mix(moe: MoEFFN, h: torch.Tensor, dtype: torch.dtype, rows: int = 0) -> torch.Tensor:
    """The MoE FFN of h [R, D] in its dense-mix form (the JAX device searches'
    LM step): every expert on every row, mixed by each row's renormalized
    top-k gates. With no token dropped (a dropless capacity) it is the
    module's function, up to summation order. The router's and experts'
    GEMMs run in ``rows``-row blocks (``models/mamba2.py::dense``), so that a
    row's result does not depend on the rows beside it."""
    def linear(x, w, b):
        return dense(x, SimpleNamespace(weight=w.T, bias=b), dtype, row_block=rows)

    probs = torch.softmax(linear(h.float(), moe.router, None).float(), dim=-1)
    gates, experts = top_k_stable(probs, min(moe.top_k, moe.n_experts))
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    gate_full = torch.zeros_like(probs).scatter(1, experts, gates).to(dtype)
    y = 0.0
    for e in range(moe.n_experts):
        f = F.gelu(linear(h, moe.w1[e], moe.b1[e]), approximate="tanh")
        y = y + gate_full[:, e, None] * linear(f, moe.w2[e], moe.b2[e])
    return y


def moe_aux(stats: list, weight: float):
    """(weighted aux loss, {"moe/aux", "moe/dropped"}) from the (aux,
    dropped) pairs of every MoE layer of a forward: the means over layers,
    so that the weight does not depend on the layer count."""
    if not stats:
        z = torch.zeros(())
        return z, {"moe/aux": z, "moe/dropped": z}
    aux = sum(a for a, _ in stats) / len(stats)
    dropped = sum(d for _, d in stats) / len(stats)
    return weight * aux, {"moe/aux": aux.detach(), "moe/dropped": dropped.detach()}
