"""Pre-norm residual Mamba-2 blocks and stacks with length-aware
bidirection, counterpart of ``hnet_mamba_asr_tpu/models/mamba_block.py``.

A block is ``y = x + Mamba2_fwd(LN(x)) [+ reverse(Mamba2_bwd(reverse(LN(x))))]``
where ``reverse`` flips only the valid span of each sequence (padding stays
in place), so the causal scan never sees padding on valid outputs. A stack
is N blocks and a final LayerNorm. LayerNorms use flax's eps of 1e-6 and
fp32 statistics.

``step`` streams a causal block or stack from carried states (in fp32, as
JAX's ``models/streaming.py::_stack_stream``).

``remat_policy`` (``encoder_conf.remat_policy``, as in the JAX stack) sets
what a block keeps for its backward while training: ``none`` keeps
everything; ``full`` recomputes the block (``torch.utils.checkpoint``), so
its two SSD forward kernels run twice per step; ``dots`` keeps only the
matrix products' outputs (``aten.mm`` / ``aten.addmm``, JAX's
``dots_saveable``) through selective checkpointing.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F

from hnet_mamba_asr_torch.models.mamba2 import Mamba2

LN_EPS = 1e-6        # flax nn.LayerNorm default (torch's is 1e-5)


def reverse_sequences(x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Reverse along time; with lengths, only each row's valid span [0, L) is
    reversed and padding positions are untouched."""
    if lengths is None:
        return torch.flip(x, dims=[1])
    B, T = x.shape[0], x.shape[1]
    pos = torch.arange(T, device=x.device)[None, :]
    L = lengths.reshape(B, 1).to(x.device)
    idx = torch.where(pos < L, L - 1 - pos, pos).clamp(0, T - 1)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm in fp32, cast to the compute dtype (flax's promotion)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(dtype)


class MambaBlock(nn.Module):
    """Pre-norm residual Mamba-2 layer; bidirectional adds a reversed pass."""

    def __init__(self, d_model: int, bidirectional: bool = True, d_state: int = 128,
                 d_conv: int = 4, expand: int = 2, headdim: int = 64,
                 chunk_size: int = 256, ssd_intra_dtype: str | None = None,
                 ssd_out_compute_dtype: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(d_model=d_model, d_state=d_state, d_conv=d_conv, expand=expand,
                  headdim=headdim, chunk_size=chunk_size, ssd_intra_dtype=ssd_intra_dtype,
                  ssd_out_compute_dtype=ssd_out_compute_dtype, dtype=dtype,
                  generator=generator)
        self.dtype = dtype
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.fwd = Mamba2(**kw)
        self.bwd = Mamba2(**kw) if bidirectional else None

    def mixer(self, x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        """The block's output without its residual: the directions' sum."""
        h = layer_norm(x, self.norm, self.dtype)
        y = self.fwd(h)
        if self.bwd is not None:
            hr = reverse_sequences(h, lengths)
            y = y + reverse_sequences(self.bwd(hr), lengths)
        return y

    def forward(self, x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        return x + self.mixer(x, lengths)

    def step(self, x: torch.Tensor, state: dict, n_real: torch.Tensor | None = None):
        """One block of a stream, in fp32 (``Mamba2.step``): causal blocks only."""
        if self.bwd is not None:
            raise ValueError("a bidirectional block cannot stream: it reads the future")
        y, state = self.fwd.step(layer_norm(x, self.norm, torch.float32), state, n_real)
        return x + y, state


REMAT_POLICIES = ("none", "full", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``dots``: keep the matmul outputs."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class MambaStack(nn.Module):
    """n_layers MambaBlocks and a final LayerNorm; shape-preserving. The
    remat policy acts only where autograd records a graph (training)."""

    def __init__(self, n_layers: int, d_model: int, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, remat_policy: str = "full",
                 **block_kw):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; "
                             f"choices: {', '.join(REMAT_POLICIES)}")
        self.dtype = dtype
        self.remat_policy = remat_policy
        self.blocks = nn.ModuleList(
            MambaBlock(d_model, dtype=dtype, generator=generator, **block_kw)
            for _ in range(n_layers))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def _block_call(self, block, x, lengths):
        if self.remat_policy == "none" or not torch.is_grad_enabled():
            return block(x, lengths)
        from torch.utils import checkpoint
        if self.remat_policy == "full":
            return checkpoint.checkpoint(block, x, lengths, use_reentrant=False)
        if not hasattr(checkpoint, "create_selective_checkpoint_contexts"):
            raise NotImplementedError("remat_policy 'dots' needs torch's selective "
                                      "checkpointing (torch >= 2.4)")
        return checkpoint.checkpoint(
            block, x, lengths, use_reentrant=False,
            context_fn=partial(checkpoint.create_selective_checkpoint_contexts, _dots_policy))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        for block in self.blocks:
            x = self._block_call(block, x, lengths)
        return layer_norm(x, self.norm, self.dtype)

    def step(self, x: torch.Tensor, states: list, n_real: torch.Tensor | None = None):
        """One block of a stream through the stack, in fp32, from the
        blocks' carried states (JAX's ``_stack_stream``) -> (out, states)."""
        new = []
        for block, state in zip(self.blocks, states):
            x, state = block.step(x, state, n_real)
            new.append(state)
        return layer_norm(x, self.norm, torch.float32), new

    def fresh_states(self, batch: int, device) -> list:
        return [block.fwd.fresh_state(batch, device) for block in self.blocks]
