"""H-Net chunking at N = 1, counterpart of
``hnet_mamba_asr_tpu/models/hnet_chunk.py::identity_chunk``.

At N = 1 every frame is its own boundary: chunk and dechunk are the identity,
with no router parameters and a zero ratio loss. The dynamic router, the
ratio loss and the EMA dechunk (N > 1) are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ChunkOutput(NamedTuple):
    z: torch.Tensor              # [B, M, D]  compressed vectors (M = L)
    z_mask: torch.Tensor         # [B, M]     True where a real chunk
    p: torch.Tensor              # [B, L]     soft boundary probabilities
    b: torch.Tensor              # [B, L]     hard boundary indicators {0., 1.}
    membership: torch.Tensor     # [B, L]     chunk slot of each fine frame
    ratio_loss: torch.Tensor     # scalar     0.0 at N = 1
    kept_fraction: torch.Tensor  # scalar     realized mean keep fraction


def identity_chunk(x: torch.Tensor, mask: torch.Tensor | None) -> ChunkOutput:
    """The shared N=1 passthrough: every frame is its own boundary."""
    B, L, _ = x.shape
    ones = torch.ones(B, L, dtype=x.dtype, device=x.device)
    if mask is not None:
        ones = ones * mask.to(x.dtype)
        z_mask = mask
    else:
        z_mask = torch.ones(B, L, dtype=torch.bool, device=x.device)
    memb = torch.arange(L, dtype=torch.int32, device=x.device)[None].expand(B, L)
    return ChunkOutput(z=x, z_mask=z_mask, p=ones, b=ones, membership=memb,
                       ratio_loss=torch.zeros((), device=x.device),
                       kept_fraction=torch.ones((), device=x.device))
