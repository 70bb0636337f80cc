"""The Hopper RNN-T loss kernels (``csrc/rnnt.cu``): bind, launch,
differentiate.

Counterpart of ``hnet_mamba_asr_tpu/ops/rnnt_loss.py::rnnt_loss``, which the
JAX package leaves to XLA. The kernels compute the whole function from the
joint's logits: the forward (``rnnt_fwd``, two launches: a pass over the
logits for each lattice cell's fp32 log-sum-exp and its blank and label
scores, then the wavefront for the per-row loss and each cell's blank
share ``w``) and the backward (``rnnt_bwd``, two launches: the reverse
wavefront over ``w`` for the coefficients ``cb`` / ``cl``, then a pass that
writes dlogits from the logits, ``lse`` and the coefficients). The source is
compiled with the port's other kernels (``ops/cuda_build.py``) and loaded
with ``ctypes``.

``rnnt_loss_cuda`` is the wrapper the RNN-T head calls. CPU logits go to
the plain version, ``ops/rnnt_loss.py::rnnt_loss``, which autograd
differentiates; CUDA logits launch the kernels or raise. ``RNNTLattice``
joins the pair as one autograd node on the logits: it keeps the logits,
``lse`` and ``w`` and returns dlogits. The logits may carry pad columns past
``classes`` (the joint GEMM's output padded to a multiple of 8), which the
kernels skip and give zero gradient, and their rows may be any fixed number
of elements apart, so a padded or sliced GEMM output is read in place.
``rnnt_loss_cuda.launches`` and ``rnnt_loss_cuda.bwd_launches`` count the
forward and backward calls. ``ops/rnnt_loss.py::rnnt_fwd_plain`` /
``rnnt_bwd_plain`` are the plain versions with the signatures of
``_forward`` / ``_backward``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from hnet_mamba_asr_torch.ops import cuda_build
from hnet_mamba_asr_torch.ops.rnnt_loss import reduce_loss, rnnt_loss

_lock = threading.Lock()
_loaded: dict = {}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def build():
    """The kernel library, built with every kernel of the port at first use."""
    info = cuda_build.build_all()
    with _lock:
        if "lib" not in _loaded:
            lib = ctypes.CDLL(str(info["paths"]["rnnt"]))
            ptr, c_int, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.hnet_rnnt_max_labels.argtypes = []
            lib.hnet_rnnt_max_labels.restype = c_int
            lib.hnet_rnnt_fwd.argtypes = ([c_int, ptr, c_ll, c_int, c_int] + [ptr] * 8
                                          + [c_int] * 3 + [ptr])
            lib.hnet_rnnt_fwd.restype = c_int
            lib.hnet_rnnt_bwd.argtypes = ([c_int, ptr, ptr, c_ll, c_int, c_int] + [ptr] * 8
                                          + [c_int] * 3 + [ptr])
            lib.hnet_rnnt_bwd.restype = c_int
            lib.hnet_rnnt_error_string.argtypes = [c_int]
            lib.hnet_rnnt_error_string.restype = ctypes.c_char_p
            _loaded["lib"] = lib
        return _loaded["lib"]


def _rows(logits: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(logits, ld): the logits with their (b, t, u) rows ld elements apart,
    a copy only where the layout has no such stride."""
    B, T, U1, W = logits.shape
    ld = logits.stride(2) if U1 > 1 else (logits.stride(1) if T > 1 else W)
    want = (T * U1 * ld, U1 * ld, ld, 1)
    if ld >= W and all(n == 1 or s == w for n, s, w in zip(logits.shape, logits.stride(), want)):
        return logits, ld
    return logits.contiguous(), W


def _check(logits: torch.Tensor, targets: torch.Tensor, classes: int, blank_id: int,
           lib) -> None:
    if logits.dtype not in DTYPES:
        raise TypeError(f"rnnt kernels take bf16 or fp32 logits, got {logits.dtype}")
    if logits.dim() != 4 or logits.shape[1] < 1:
        raise ValueError(f"rnnt kernels take logits [B, T, U+1, V], got {tuple(logits.shape)}")
    if logits.device.type != "cuda":
        raise ValueError(f"rnnt kernel inputs must be on a CUDA device, got {logits.device}")
    B, _, U1, W = logits.shape
    if tuple(targets.shape) != (B, U1 - 1):
        raise ValueError(f"targets {tuple(targets.shape)} do not match logits "
                         f"{tuple(logits.shape)}: want [B, U]")
    if not 0 < classes <= W or not 0 <= blank_id < classes:
        raise ValueError(f"classes {classes} / blank_id {blank_id} outside the logits' {W} "
                         "columns")
    if U1 - 1 > lib.hnet_rnnt_max_labels():
        raise ValueError(f"rnnt kernels take U <= {lib.hnet_rnnt_max_labels()}, got {U1 - 1}")


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.hnet_rnnt_error_string(code).decode()
        raise RuntimeError(f"rnnt {what} kernel launch failed: cudaError {code} ({msg})")


def _ints(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32).contiguous()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward(logits, targets, feat_lengths, target_lengths, blank_id: int,
             classes: int | None = None):
    """Launch the forward pair: (loss [B], lse [B, T, U+1], w [B, T+U, U+1])
    from logits [B, T, U+1, W] (the first ``classes`` columns, all W
    without it)."""
    lib = build()
    classes = logits.shape[-1] if classes is None else classes
    _check(logits, targets, classes, blank_id, lib)
    logits, ld = _rows(logits)
    B, T, U1, _ = logits.shape
    dev = logits.device
    f32 = dict(dtype=torch.float32, device=dev)
    lse = torch.empty((B, T, U1), **f32)
    sblank, slabel, share = (torch.empty((B, T + U1 - 1, U1), **f32) for _ in range(3))
    loss = torch.empty(B, **f32)
    if B:
        tg, fl, tl = (_ints(x, dev) for x in (targets, feat_lengths, target_lengths))
        with torch.cuda.device(dev):
            code = lib.hnet_rnnt_fwd(DTYPES[logits.dtype], logits.data_ptr(), ld, classes,
                                     blank_id, tg.data_ptr(), fl.data_ptr(), tl.data_ptr(),
                                     lse.data_ptr(), sblank.data_ptr(), slabel.data_ptr(),
                                     share.data_ptr(), loss.data_ptr(), B, T, U1 - 1,
                                     _stream(dev))
        _raise_on(lib, code, "forward")
        rnnt_loss_cuda.launches += 1
    return loss, lse, share


def _backward(logits, lse, w, targets, feat_lengths, target_lengths, blank_id: int, g,
              classes: int | None = None):
    """Launch the backward pair: (dlogits in the logits' dtype, shape and
    row stride; cb, cl [B, T+U, U+1]) from the forward's lse and shares and
    the loss's gradient g [B]."""
    lib = build()
    classes = logits.shape[-1] if classes is None else classes
    _check(logits, targets, classes, blank_id, lib)
    logits, ld = _rows(logits)
    B, T, U1, W = logits.shape
    dev = logits.device
    dlogits = torch.empty((B, T, U1, ld), dtype=logits.dtype, device=dev)[..., :W]
    cb, cl = torch.empty_like(w), torch.empty_like(w)
    if B:
        tg, fl, tl = (_ints(x, dev) for x in (targets, feat_lengths, target_lengths))
        g = g.to(dev, torch.float32).contiguous()
        with torch.cuda.device(dev):
            code = lib.hnet_rnnt_bwd(DTYPES[logits.dtype], logits.data_ptr(),
                                     dlogits.data_ptr(), ld, classes, blank_id, tg.data_ptr(),
                                     fl.data_ptr(), tl.data_ptr(), lse.data_ptr(),
                                     w.data_ptr(), g.data_ptr(), cb.data_ptr(), cl.data_ptr(),
                                     B, T, U1 - 1, _stream(dev))
        _raise_on(lib, code, "backward")
        rnnt_loss_cuda.bwd_launches += 1
    return dlogits, cb, cl


class RNNTLattice(torch.autograd.Function):
    """logits [B, T, U+1, W] (bf16 or fp32; ``classes`` of the W columns),
    targets [B, U], lengths [B] -> the per-row NLL [B]: the forward pair, and
    the backward pair over the kept logits, lse and shares -> dlogits."""

    @staticmethod
    def forward(ctx, logits, targets, feat_lengths, target_lengths, blank_id, classes):
        x, _ = _rows(logits)
        dev = x.device
        tg, fl, tl = (_ints(v, dev) for v in (targets, feat_lengths, target_lengths))
        loss, lse, w = _forward(x, tg, fl, tl, blank_id, classes)
        ctx.save_for_backward(x, lse, w, tg, fl, tl)
        ctx.blank_id, ctx.classes = blank_id, classes
        return loss

    @staticmethod
    def backward(ctx, g):
        x, lse, w, tg, fl, tl = ctx.saved_tensors
        dlogits, _, _ = _backward(x, lse, w, tg, fl, tl, ctx.blank_id, g, ctx.classes)
        return dlogits, None, None, None, None, None


def rnnt_loss_cuda(logits: torch.Tensor, feat_lengths: torch.Tensor, targets: torch.Tensor,
                   target_lengths: torch.Tensor, *, blank_id: int, reduction: str = "mean",
                   classes: int | None = None) -> torch.Tensor:
    """``rnnt_loss``'s contract: logits [B, T, U+1, V] in any float dtype
    (the log-softmax runs in fp32) -> [B] for "none", else a scalar.
    ``classes``: the number of classes when the logits carry pad columns
    after them (ignored, zero gradient).

    On CPU tensors it runs the plain ``rnnt_loss``. On CUDA tensors it
    launches the kernels (bf16 or fp32 logits) or raises."""
    if logits.device.type == "cpu":
        x = logits if classes is None else logits[..., :classes]
        return rnnt_loss(x, feat_lengths, targets, target_lengths, blank_id=blank_id,
                         reduction=reduction)
    if logits.device.type != "cuda":
        raise ValueError(f"rnnt kernels run on CUDA tensors, got {logits.device}")
    classes = logits.shape[-1] if classes is None else classes
    return reduce_loss(RNNTLattice.apply(logits, targets, feat_lengths, target_lengths, blank_id,
                                      classes), reduction)


rnnt_loss_cuda.launches = 0
rnnt_loss_cuda.bwd_launches = 0
