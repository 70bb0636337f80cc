"""The Hopper RNN-T lattice kernels (``csrc/rnnt.cu``): bind, launch,
differentiate.

Counterpart of ``hnet_mamba_asr_tpu/ops/rnnt_loss.py::rnnt_loss``, which the
JAX package leaves to XLA as a frame scan. The log-softmax over V+1 and the
gathers of the blank and target columns stay PyTorch ops
(``ops/rnnt_loss.py::lattice_scores``); the kernels take the two fp32 score
arrays and walk the lattice, forward (``rnnt_fwd``: the per-row loss and
each cell's share of its mass that came in by the blank) and backward
(``rnnt_bwd``: both gradients, from the shares alone). The source is
compiled with the port's other kernels (``ops/cuda_build.py``) and loaded
with ``ctypes``.

``rnnt_loss_cuda`` is the wrapper the RNN-T head calls. CPU logits go to
the plain version, ``ops/rnnt_loss.py::rnnt_loss``, which autograd
differentiates; CUDA logits launch the kernels or raise. ``RNNTLattice``
joins the pair as one autograd node, and autograd carries its gradients back
through the gathers and the log-softmax into the joint's logits.
``rnnt_loss_cuda.launches`` and ``rnnt_loss_cuda.bwd_launches`` count the
launches.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from hnet_mamba_asr_torch.ops import cuda_build
from hnet_mamba_asr_torch.ops.rnnt_loss import lattice_scores, reduce_loss, rnnt_loss

_lock = threading.Lock()
_loaded: dict = {}


def build():
    """The kernel library, built with every kernel of the port at first use."""
    info = cuda_build.build_all()
    with _lock:
        if "lib" not in _loaded:
            lib = ctypes.CDLL(str(info["paths"]["rnnt"]))
            ptr, c_int = ctypes.c_void_p, ctypes.c_int
            lib.hnet_rnnt_max_labels.argtypes = []
            lib.hnet_rnnt_max_labels.restype = c_int
            lib.hnet_rnnt_fwd.argtypes = [ptr] * 6 + [c_int] * 4 + [ptr]
            lib.hnet_rnnt_fwd.restype = c_int
            lib.hnet_rnnt_bwd.argtypes = [ptr] * 6 + [c_int] * 4 + [ptr]
            lib.hnet_rnnt_bwd.restype = c_int
            lib.hnet_rnnt_error_string.argtypes = [c_int]
            lib.hnet_rnnt_error_string.restype = ctypes.c_char_p
            _loaded["lib"] = lib
        return _loaded["lib"]


def threads_for(U: int) -> int:
    """A CTA's threads: a warp per 32 cells of the widest diagonal (U+1), at
    most 512 (they stride beyond)."""
    return min(512, -(-(U + 1) // 32) * 32)


def _check(blank: torch.Tensor, label: torch.Tensor, lib) -> None:
    if blank.dtype != torch.float32 or label.dtype != torch.float32:
        raise TypeError(f"rnnt kernels take fp32 scores, got {blank.dtype} and {label.dtype}")
    if blank.dim() != 3 or label.dim() != 3 or tuple(label.shape) != (
            blank.shape[0], blank.shape[1], blank.shape[2] - 1):
        raise ValueError(f"rnnt kernels take blank [B, T, U+1] and label [B, T, U], got "
                         f"{tuple(blank.shape)} and {tuple(label.shape)}")
    if blank.device.type != "cuda" or label.device != blank.device:
        raise ValueError(f"rnnt kernel inputs must be on one CUDA device, got {blank.device} "
                         f"and {label.device}")
    if blank.shape[2] - 1 > lib.hnet_rnnt_max_labels():
        raise ValueError(f"rnnt kernels take U <= {lib.hnet_rnnt_max_labels()}, got "
                         f"{blank.shape[2] - 1}")


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.hnet_rnnt_error_string(code).decode()
        raise RuntimeError(f"rnnt {what} kernel launch failed: cudaError {code} ({msg})")


def _lengths(x: torch.Tensor, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32).contiguous()


def _forward(blank, label, feat_lengths, target_lengths):
    """Launch the forward kernel: (loss [B], share [B, T, U+1])."""
    lib = build()
    _check(blank, label, lib)
    B, T, U1 = blank.shape
    share = torch.empty_like(blank)
    loss = torch.empty(B, dtype=torch.float32, device=blank.device)
    if B:
        with torch.cuda.device(blank.device):
            code = lib.hnet_rnnt_fwd(blank.data_ptr(), label.data_ptr(),
                                     feat_lengths.data_ptr(), target_lengths.data_ptr(),
                                     share.data_ptr(), loss.data_ptr(), B, T, U1 - 1,
                                     threads_for(U1 - 1),
                                     torch.cuda.current_stream(blank.device).cuda_stream)
        _raise_on(lib, code, "forward")
        rnnt_loss_cuda.launches += 1
    return loss, share


def _backward(share, feat_lengths, target_lengths, g):
    """Launch the backward kernel: (dblank [B, T, U+1], dlabel [B, T, U])."""
    lib = build()
    B, T, U1 = share.shape
    g = g.float().contiguous()
    dblank = torch.empty_like(share)
    dlabel = torch.empty((B, T, U1 - 1), dtype=torch.float32, device=share.device)
    if B:
        with torch.cuda.device(share.device):
            code = lib.hnet_rnnt_bwd(share.data_ptr(), feat_lengths.data_ptr(),
                                     target_lengths.data_ptr(), g.data_ptr(),
                                     dblank.data_ptr(), dlabel.data_ptr(), B, T, U1 - 1,
                                     threads_for(U1 - 1),
                                     torch.cuda.current_stream(share.device).cuda_stream)
        _raise_on(lib, code, "backward")
        rnnt_loss_cuda.bwd_launches += 1
    return dblank, dlabel


class RNNTLattice(torch.autograd.Function):
    """blank [B, T, U+1], label [B, T, U] fp32 log-probs, lengths [B] -> the
    per-row NLL [B]: the forward kernel, and the backward kernel over the
    kept shares."""

    @staticmethod
    def forward(ctx, blank, label, feat_lengths, target_lengths):
        fl = _lengths(feat_lengths, blank.device)
        tl = _lengths(target_lengths, blank.device)
        blank, label = blank.contiguous(), label.contiguous()
        loss, share = _forward(blank, label, fl, tl)
        ctx.save_for_backward(share, fl, tl)
        return loss

    @staticmethod
    def backward(ctx, g):
        share, fl, tl = ctx.saved_tensors
        dblank, dlabel = _backward(share, fl, tl, g)
        return dblank, dlabel, None, None


def lattice_nll_cuda(blank: torch.Tensor, label: torch.Tensor, feat_lengths,
                     target_lengths) -> torch.Tensor:
    """The kernels' entry on score arrays already on the card: an
    ``RNNTLattice`` node when grad mode is on and a score requires grad,
    else the forward kernel alone."""
    if torch.is_grad_enabled() and (blank.requires_grad or label.requires_grad):
        return RNNTLattice.apply(blank, label, feat_lengths, target_lengths)
    return _forward(blank.contiguous(), label.contiguous(),
                    _lengths(feat_lengths, blank.device),
                    _lengths(target_lengths, blank.device))[0]


def rnnt_loss_cuda(logits: torch.Tensor, feat_lengths: torch.Tensor, targets: torch.Tensor,
                   target_lengths: torch.Tensor, *, blank_id: int,
                   reduction: str = "mean") -> torch.Tensor:
    """``rnnt_loss``'s contract: logits [B, T, U+1, V] in any float dtype
    (the log-softmax runs in fp32) -> [B] for "none", else a scalar.

    On CPU tensors it runs the plain ``rnnt_loss``. On CUDA tensors it takes
    the log-softmax and the gathers in PyTorch and walks the lattice with
    the kernels."""
    if logits.device.type == "cpu":
        return rnnt_loss(logits, feat_lengths, targets, target_lengths, blank_id=blank_id,
                         reduction=reduction)
    if logits.device.type != "cuda":
        raise ValueError(f"rnnt kernels run on CUDA tensors, got {logits.device}")
    blank, label = lattice_scores(logits, targets, target_lengths, blank_id)
    return reduce_loss(lattice_nll_cuda(blank, label, feat_lengths, target_lengths), reduction)


rnnt_loss_cuda.launches = 0
rnnt_loss_cuda.bwd_launches = 0
