"""The Hopper SSD scan kernels (``csrc/ssd_fwd.cu``, ``csrc/ssd_bwd.cu``):
build, bind, launch, differentiate.

Counterpart of the Pallas kernel ``hnet_mamba_asr_tpu/ops/ssd_pallas.py``
(forward) and of the JAX package's autodiff of ``ops/ssd.py::ssd_chunked``
(backward). Each source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (``ops/cuda_build.py``: every kernel
of the port at the first launch, in parallel, from the package's own
sources) and loaded with ``ctypes``.

``ssd_cuda`` is the wrapper a model calls. A tensor on the CPU goes to the
plain version, ``ops/ssd.py::ssd_chunked``, which autograd differentiates; a
CUDA tensor launches the forward kernel or raises, and when grad mode is on
and an input requires grad the call goes through ``SSDScan``, whose backward
is the backward kernel. ``ssd_cuda.launches`` and ``ssd_cuda.bwd_launches``
count the kernels' launches: one per call (a bf16 backward call launches
two kernels, the reverse chain and the chunk terms, and counts once).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from hnet_mamba_asr_torch.ops import cuda_build
from hnet_mamba_asr_torch.ops.ssd import normalize_intra_dtype, ssd_chunked

CHUNK = 64                      # the kernels' chunk length
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_loaded: dict = {}


# (headdim P, d_state N) -> the names of the forward and backward libraries
SHAPES = {(64, 128): ("ssd_fwd", "ssd_bwd"), (16, 16): ("ssd_fwd_p16n16", "ssd_bwd_p16n16")}


def build(defines: tuple[str, ...] = ()) -> dict:
    """Compile (once per process and source hash; ``cuda_build.build_all``
    builds every kernel of the port, one ``nvcc`` per source, started
    together) and load the SSD libraries.

    Returns ``{"lib", "bwd", "libs", "path", "bwd_path", "seconds", "log",
    "cached"}``: ``lib`` is the forward library and ``bwd`` the backward's
    for (P, N) = (64, 128), and ``libs`` maps each (P, N) of ``SHAPES`` to
    its (forward, backward) pair (the (16, 16) pair holds the fp32 kernels
    only); ``seconds`` is the build's time (0 when every library was
    already on disk) and ``log`` the compiler's report (registers, shared
    memory, spills). ``defines`` (e.g. ``("SSD_PHASE_CLOCKS",)``) build an
    instrumented (64, 128) forward; the first call in a process decides
    which one it uses.
    """
    info = cuda_build.build_all({"ssd_fwd": tuple(defines)})
    with _lock:
        if "lib" in _loaded:
            return _loaded
        paths = info["paths"]
        ptr, c_int = ctypes.c_void_p, ctypes.c_int
        libs = {}
        for shape, (fwd_name, bwd_name) in SHAPES.items():
            lib = ctypes.CDLL(str(paths[fwd_name]))
            lib.hnet_ssd_fwd.argtypes = [c_int] + [ptr] * 9 + [c_int] * 7 + [ptr]
            lib.hnet_ssd_fwd.restype = c_int
            lib.hnet_ssd_fwd_supported.argtypes = [c_int, c_int]
            lib.hnet_ssd_fwd_supported.restype = c_int
            lib.hnet_ssd_fwd_has_bf16.restype = c_int
            lib.hnet_ssd_fwd_bf16_cluster_size.argtypes = [c_int]
            lib.hnet_ssd_fwd_bf16_cluster_size.restype = c_int
            lib.hnet_cuda_error_string.argtypes = [c_int]
            lib.hnet_cuda_error_string.restype = ctypes.c_char_p
            bwd = ctypes.CDLL(str(paths[bwd_name]))
            if lib.hnet_ssd_fwd_has_bf16():
                bwd.hnet_ssd_bwd_bf16.argtypes = [ptr] * 17 + [c_int] * 7 + [ptr]
                bwd.hnet_ssd_bwd_bf16.restype = c_int
                bwd.hnet_ssd_bwd_bf16_splits.argtypes = [c_int] * 4
                bwd.hnet_ssd_bwd_bf16_splits.restype = c_int
            bwd.hnet_ssd_bwd_fp32.argtypes = [ptr] * 14 + [c_int] * 7 + [ptr]
            bwd.hnet_ssd_bwd_fp32.restype = c_int
            bwd.hnet_ssd_bwd_supported.argtypes = [c_int, c_int]
            bwd.hnet_ssd_bwd_supported.restype = c_int
            libs[shape] = (lib, bwd)
        lib, bwd = libs[(64, 128)]
        _loaded.update(lib=lib, bwd=bwd, libs=libs, path=str(paths["ssd_fwd"]),
                       bwd_path=str(paths["ssd_bwd"]), log=info["log"],
                       cached=info["cached"], seconds=info["seconds"])
        return _loaded


def _libs(x, P: int, N: int):
    """The (forward, backward) libraries for headdim P and d_state N."""
    pair = build()["libs"].get((P, N))
    if pair is None:
        raise ValueError(f"ssd kernel is not built for headdim P={P}, d_state N={N}; "
                         f"built: {sorted(SHAPES)}")
    if x.dtype == torch.bfloat16 and not pair[0].hnet_ssd_fwd_has_bf16():
        raise ValueError(f"the bf16 ssd kernel is built for (P, N) = (64, 128) only, "
                         f"got ({P}, {N})")
    return pair


def _check(x, dt, A, B, C, initial_state) -> None:
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"ssd kernel takes x in float32 or bfloat16, got {x.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"B and C must share x's dtype {x.dtype}, "
                        f"got {B.dtype} and {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype} and {A.dtype}")
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"x must be [B,L,H,P] and B/C [B,L,G,N], got "
                         f"{tuple(x.shape)} and {tuple(B.shape)}")
    Bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (tuple(dt.shape) != (Bsz, L, H) or tuple(A.shape) != (H,)
            or tuple(B.shape) != (Bsz, L, G, N) or tuple(C.shape) != tuple(B.shape)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    # the bf16 grid is (cluster, H, batch): its y and z sides take 65535
    if L < 1 or not 1 <= Bsz <= 65535 or not 1 <= H <= 65535 or H % G:
        raise ValueError(f"unsupported sizes batch={Bsz} L={L} H={H} G={G}")
    tensors = [x, dt, A, B, C]
    if initial_state is not None:
        if (initial_state.dtype != torch.float32
                or tuple(initial_state.shape) != (Bsz, H, N, P)):
            raise ValueError("initial_state must be float32 [B,H,N,P] = "
                             f"{(Bsz, H, N, P)}, got {initial_state.dtype} "
                             f"{tuple(initial_state.shape)}")
        tensors.append(initial_state)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all ssd inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd kernel inputs must be contiguous")


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = build()["lib"].hnet_cuda_error_string(code).decode()
        raise RuntimeError(f"ssd {what} kernel launch failed: cudaError {code} ({msg})")


def _forward(x, dt, A, B, C, initial_state, return_final: bool, intra_bf16: bool,
             keep_states: bool):
    """Launch the forward kernel: ``(y, s_final or None, s_chunks or None)``;
    ``s_chunks`` [B, H, K, N, P] fp32 is the state before each chunk of 64,
    which the backward kernel reads."""
    _check(x, dt, A, B, C, initial_state)
    Bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    lib = _libs(x, P, N)[0]
    y = torch.empty_like(x)
    s_final = (torch.empty(Bsz, H, N, P, dtype=torch.float32, device=x.device)
               if return_final else None)
    s_chunks = (torch.empty(Bsz, H, -(-L // CHUNK), N, P, dtype=torch.float32,
                            device=x.device) if keep_states else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        code = lib.hnet_ssd_fwd(
            DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), ptr(initial_state), y.data_ptr(), ptr(s_final),
            ptr(s_chunks), Bsz, L, H, G, P, N, int(intra_bf16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(code, "forward")
    ssd_cuda.launches += 1
    return y, s_final, s_chunks


def _backward(x, dt, A, B, C, s_chunks, dy, ds_final, intra_bf16: bool,
              want_ds0: bool = True):
    """Launch the backward kernel: ``(dx, ddt, dA, dB, dC, d_initial_state
    or None)``.

    bf16 inputs take the two launches of the Hopper design (the reverse
    state chain, then the chunk terms with the sums over a group's heads in
    the kernel); fp32 inputs take the SIMT kernel, whose per-head dB / dC
    come out as fp32 partials. The sums left here (dA over batch and chunks;
    fp32 dB / dC over the heads of a group, or over the head splits of a
    bf16 call at a small batch) are plain reductions in a fixed order, so
    the result does not depend on block order."""
    Bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    dy = dy.to(x.dtype).contiguous()
    if ds_final is not None:
        ds_final = ds_final.float().contiguous()
    bwd = _libs(x, P, N)[1]
    dev, f32 = x.device, torch.float32
    dx = torch.empty_like(x)
    ddt = torch.empty(Bsz, L, H, dtype=f32, device=dev)
    ds0 = torch.empty(Bsz, H, N, P, dtype=f32, device=dev) if want_ds0 else None
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if x.dtype == torch.bfloat16:
            K = -(-L // CHUNK)
            splits = bwd.hnet_ssd_bwd_bf16_splits(Bsz, L, H, G)
            if splits < 1:
                _raise_on(-splits, "backward")
            dA_part = torch.empty(Bsz, H, K, dtype=f32, device=dev)
            d_after = torch.empty(Bsz, H, K, N, P, dtype=x.dtype, device=dev)   # D_k
            dB, dC = torch.empty_like(B), torch.empty_like(C)
            parts = (torch.empty(2, splits, Bsz, L, G, N, dtype=f32, device=dev)
                     if splits > 1 else None)
            code = bwd.hnet_ssd_bwd_bf16(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                dy.data_ptr(), s_chunks.data_ptr(), ptr(ds_final), d_after.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(),
                dA_part.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                None if parts is None else parts[0].data_ptr(),
                None if parts is None else parts[1].data_ptr(), ptr(ds0),
                Bsz, L, H, G, P, N, int(intra_bf16), stream)
        else:
            dA_part = torch.empty(Bsz, H, dtype=f32, device=dev)
            parts = torch.empty(2, Bsz, L, H, N, dtype=f32, device=dev)
            code = bwd.hnet_ssd_bwd_fp32(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                dy.data_ptr(), s_chunks.data_ptr(), ptr(ds_final), dx.data_ptr(),
                ddt.data_ptr(), dA_part.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
                ptr(ds0), Bsz, L, H, G, P, N, int(intra_bf16), stream)
    _raise_on(code, "backward")
    ssd_cuda.bwd_launches += 1
    dA = dA_part.sum(0) if dA_part.dim() == 2 else dA_part.sum((0, 2))
    if x.dtype == torch.float32:
        dB, dC = parts.view(2, Bsz, L, G, H // G, N).sum(4)
    elif parts is not None:
        dB, dC = parts.sum(1).to(B.dtype)
    return dx, ddt, dA, dB, dC, ds0


class SSDScan(torch.autograd.Function):
    """``ssd_chunked`` at chunk 64 as one autograd node on CUDA tensors: the
    forward kernel (which also writes the state before every chunk) and the
    backward kernel. Returns y, or ``(y, S_final)`` with ``return_final``;
    the gradient reaches x, dt, A, B, C and ``initial_state``. CPU tensors
    never get here: ``ssd_cuda`` sends them to ``ssd_chunked``, which
    autograd differentiates."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state=None, intra_dtype=None,
                return_final=False):
        if x.device.type != "cuda":
            raise ValueError(f"SSDScan runs the kernels on CUDA tensors, got {x.device}")
        intra = normalize_intra_dtype(intra_dtype)
        ctx.intra, ctx.return_final = intra, return_final
        y, s_final, s_chunks = _forward(x, dt, A, B, C, initial_state, return_final,
                                        intra == "bf16", keep_states=True)
        ctx.save_for_backward(x, dt, A, B, C, s_chunks)
        return (y, s_final) if return_final else y

    @staticmethod
    def backward(ctx, dy, ds_final=None):
        x, dt, A, B, C, s_chunks = ctx.saved_tensors
        dx, ddt, dA, dB, dC, ds0 = _backward(x, dt, A, B, C, s_chunks, dy,
                                             ds_final if ctx.return_final else None,
                                             ctx.intra == "bf16", ctx.needs_input_grad[5])
        return dx, ddt, dA, dB, dC, ds0, None, None


def ssd_cuda(x, dt, A, B, C, chunk_size: int = 256, initial_state=None,
             return_final: bool = False, intra_dtype: str | None = None):
    """SSD with ``ssd_chunked``'s contract: y [B,L,H,P] in x.dtype, or
    ``(y, S_final [B,H,N,P] fp32)`` with ``return_final``.

    On CPU tensors it runs ``ssd_chunked``. On CUDA tensors it launches the
    forward kernel, which computes ``ssd_chunked`` at its own chunk length,
    64 (in fp32 the result does not depend on it, so ``chunk_size`` is not
    used there; in bf16 the roundings of W and the state fall at chunk
    bounds). With grad mode on and an input that requires grad, the call is
    an ``SSDScan`` node, whose backward is the backward kernel: the result
    is never detached from its inputs.
    """
    intra = normalize_intra_dtype(intra_dtype)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk_size=chunk_size,
                           initial_state=initial_state, return_final=return_final,
                           intra_dtype=intra)
    if x.device.type != "cuda":
        raise ValueError(f"ssd kernel runs on CUDA tensors, got {x.device}")
    inputs = (x, dt, A, B, C) + (() if initial_state is None else (initial_state,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return SSDScan.apply(x, dt, A, B, C, initial_state, intra, return_final)
    y, s_final, _ = _forward(x, dt, A, B, C, initial_state, return_final,
                             intra == "bf16", keep_states=False)
    return (y, s_final) if return_final else y


ssd_cuda.launches = 0
ssd_cuda.bwd_launches = 0
