"""The Hopper EMA kernels (``csrc/ema.cu``): bind, launch, differentiate.

Counterpart of ``hnet_mamba_asr_tpu/ops/ema.py::ema_smooth``, which the JAX
package leaves to XLA as an [M x M] matmul per row. The kernels compute the
recurrence zbar_t = P_t z_t + (1 - P_t) zbar_{t-1} (zbar_0 = z_0), forward
and backward, with P clamped to [p_clamp, 1 - p_clamp] and no gradient
outside that range. The source is compiled with the port's other kernels
(``ops/cuda_build.py``) and loaded with ``ctypes``.

``ema_cuda`` is the wrapper the dechunk calls. A tensor on the CPU goes to
the plain version, ``ops/ema.py::ema_smooth``, which autograd
differentiates; a CUDA tensor launches the forward kernel or raises, and
when grad mode is on and z or p requires grad the call goes through
``EMASmooth``, whose backward is the backward kernel. The backward reads the
forward's output (kept by autograd, in z's dtype) for zbar_{t-1}.
``ema_cuda.launches`` and ``ema_cuda.bwd_launches`` count the kernels'
launches (one kernel a call each way).

The kernels scan in chunks across CTAs and need scratch: a ticket and
counters (int32, which every call leaves at zero), flags (int32) and the
chunks' carries and dP partials (fp32). ``_scratch`` keeps one set per
(device, stream), grown to the largest call, and gives every call a new
epoch, which the kernels' flags carry, so that the flags never need a
reset. A graph's replays would all reuse the epoch of its capture, so a
call while the stream captures a CUDA graph raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from hnet_mamba_asr_torch.ops import cuda_build
from hnet_mamba_asr_torch.ops.ema import ema_smooth

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
EPOCHS = 1 << 30            # a flag word keeps the epoch above its 2 state bits
SCRATCH = ("counts", "flags", "floats")

_lock = threading.Lock()
_loaded: dict = {}
_scratch_by_stream: dict = {}


def build(defines: tuple[str, ...] = ()):
    """The kernel library, built with every kernel of the port at first use.
    ``defines`` (``("EMA_PHASE_CLOCKS",)``) build an instrumented library;
    the first call in a process decides which one it uses."""
    info = cuda_build.build_all({"ema": tuple(defines)})
    with _lock:
        if "lib" not in _loaded:
            lib = ctypes.CDLL(str(info["paths"]["ema"]))
            ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            c_uint = ctypes.c_uint
            lib.hnet_ema_scratch.argtypes = [c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
            lib.hnet_ema_scratch.restype = None
            lib.hnet_ema_fwd.argtypes = [c_int, ptr, ptr, ptr, c_int, c_int, c_int,
                                         c_float, c_float, ptr, ptr, ptr, c_uint, ptr]
            lib.hnet_ema_fwd.restype = c_int
            lib.hnet_ema_bwd.argtypes = ([c_int] + [ptr] * 6 + [c_int] * 3
                                         + [c_float, c_float, ptr, ptr, ptr, c_uint, ptr])
            lib.hnet_ema_bwd.restype = c_int
            lib.hnet_ema_error_string.argtypes = [c_int]
            lib.hnet_ema_error_string.restype = ctypes.c_char_p
            _loaded["lib"] = lib
        return _loaded["lib"]


def _check(z: torch.Tensor, p: torch.Tensor) -> None:
    if z.dtype not in DTYPE_CODES:
        raise TypeError(f"ema kernel takes z in float32 or bfloat16, got {z.dtype}")
    if p.dtype != torch.float32:
        raise TypeError(f"ema kernel takes p in float32, got {p.dtype}")
    if z.dim() != 3 or tuple(p.shape) != tuple(z.shape[:2]):
        raise ValueError(f"ema kernel takes z [B, M, D] and p [B, M], got "
                         f"{tuple(z.shape)} and {tuple(p.shape)}")
    if z.device != p.device or z.device.type != "cuda":
        raise ValueError(f"ema kernel inputs must be on one CUDA device, got {z.device} "
                         f"and {p.device}")
    if not (z.is_contiguous() and p.is_contiguous()):
        raise ValueError("ema kernel inputs must be contiguous")


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.hnet_ema_error_string(code).decode()
        raise RuntimeError(f"ema {what} kernel launch failed: cudaError {code} ({msg})")


def _clamp_range(p_clamp: float) -> tuple[float, float]:
    return float(p_clamp), 1.0 - float(p_clamp)        # torch.clamp's bounds


def _scratch(lib, z: torch.Tensor) -> tuple[int, int, int, int]:
    """(counts, flags, floats, epoch) for a call at z's shape on the current
    stream of z's device: the kept buffers, grown (counts and flags zeroed)
    when the call needs more, and a new epoch; at the last epoch the flags
    are zeroed again and the count starts over.

    Raises while the stream is capturing a CUDA graph: the epoch is fixed
    at capture, so a replay would find the flags of the replay before it
    already raised with its own epoch and fold their stale carries in."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("ema kernels cannot be captured in a CUDA graph: each call needs "
                           "an epoch of its own for its look-back flags")
    sizes = (ctypes.c_longlong * 3)()
    lib.hnet_ema_scratch(*z.shape, sizes)
    key = (z.device.index, torch.cuda.current_stream(z.device).cuda_stream)
    with _lock:
        s = _scratch_by_stream.get(key)
        if s is None or any(s[k].numel() < n for k, n in zip(SCRATCH, sizes)):
            n = {k: max(v, 0 if s is None else s[k].numel()) for k, v in zip(SCRATCH, sizes)}
            s = _scratch_by_stream[key] = {
                "counts": torch.zeros(n["counts"], dtype=torch.int32, device=z.device),
                "flags": torch.zeros(n["flags"], dtype=torch.int32, device=z.device),
                "floats": torch.empty(n["floats"], dtype=torch.float32, device=z.device),
                "epoch": 0}
        s["epoch"] += 1
        if s["epoch"] == EPOCHS:
            s["flags"].zero_()
            s["epoch"] = 1
        return (*(s[k].data_ptr() for k in SCRATCH), s["epoch"])


def _forward(z: torch.Tensor, p: torch.Tensor, p_clamp: float) -> torch.Tensor:
    _check(z, p)
    Bsz, M, D = z.shape
    lib = build()
    out = torch.empty_like(z)
    with torch.cuda.device(z.device):
        code = lib.hnet_ema_fwd(DTYPE_CODES[z.dtype], z.data_ptr(), p.data_ptr(),
                                out.data_ptr(), Bsz, M, D, *_clamp_range(p_clamp),
                                *_scratch(lib, z),
                                torch.cuda.current_stream(z.device).cuda_stream)
    _raise_on(lib, code, "forward")
    ema_cuda.launches += 1
    return out


def _backward(z, p, zbar, g, p_clamp: float):
    """Launch the backward kernel: ``(dz in z's dtype, dp fp32)``."""
    Bsz, M, D = z.shape
    lib = build()
    g = g.to(z.dtype).contiguous()
    dz = torch.empty_like(z)
    dp = torch.empty_like(p)
    with torch.cuda.device(z.device):
        code = lib.hnet_ema_bwd(DTYPE_CODES[z.dtype], z.data_ptr(), p.data_ptr(),
                                zbar.data_ptr(), g.data_ptr(), dz.data_ptr(), dp.data_ptr(),
                                Bsz, M, D, *_clamp_range(p_clamp), *_scratch(lib, z),
                                torch.cuda.current_stream(z.device).cuda_stream)
    _raise_on(lib, code, "backward")
    ema_cuda.bwd_launches += 1
    return dz, dp


class EMASmooth(torch.autograd.Function):
    """``ema_smooth`` as one autograd node on CUDA tensors: the forward
    kernel, and the backward kernel over the kept output."""

    @staticmethod
    def forward(ctx, z, p, p_clamp=1e-4):
        if z.device.type != "cuda":
            raise ValueError(f"EMASmooth runs the kernels on CUDA tensors, got {z.device}")
        zbar = _forward(z, p, p_clamp)
        ctx.p_clamp = p_clamp
        ctx.save_for_backward(z, p, zbar)
        return zbar

    @staticmethod
    def backward(ctx, g):
        z, p, zbar = ctx.saved_tensors
        dz, dp = _backward(z, p, zbar, g, ctx.p_clamp)
        return dz, dp, None


def ema_cuda(z: torch.Tensor, p: torch.Tensor, p_clamp: float = 1e-4) -> torch.Tensor:
    """``ema_smooth``'s contract: z [B, M, D] (fp32 or bf16), p [B, M] fp32
    -> zbar [B, M, D] in z's dtype.

    On CPU tensors it runs ``ema_smooth``. On CUDA tensors it launches the
    forward kernel, which computes the recurrence with an fp32 state (the
    plain version's matmul rounds its weights to z's dtype; the kernel does
    not). With grad mode on and z or p requiring grad, the call is an
    ``EMASmooth`` node, whose backward is the backward kernel.
    """
    if z.device.type == "cpu":
        return ema_smooth(z, p, p_clamp)
    if z.device.type != "cuda":
        raise ValueError(f"ema kernel runs on CUDA tensors, got {z.device}")
    z, p = z.contiguous(), p.contiguous()
    if torch.is_grad_enabled() and (z.requires_grad or p.requires_grad):
        return EMASmooth.apply(z, p, p_clamp)
    return _forward(z, p, p_clamp)


ema_cuda.launches = 0
ema_cuda.bwd_launches = 0
