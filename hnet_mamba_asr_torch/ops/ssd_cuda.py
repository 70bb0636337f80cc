"""The Hopper SSD scan kernel (``csrc/ssd_fwd.cu``): build, bind, launch.

Counterpart of the Pallas kernel ``hnet_mamba_asr_tpu/ops/ssd_pallas.py``.
The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``. The build happens at the
first launch, from the package's own source, into ``_build/`` beside this
package; the library's name carries a hash of the source and the flags, so
an edited source is rebuilt and never mixed with an old library.

``ssd_cuda`` is the wrapper a model calls. A tensor on the CPU goes to the
plain version, ``ops/ssd.py::ssd_chunked``; a CUDA tensor launches the kernel
or raises. ``ssd_cuda.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from hnet_mamba_asr_torch.ops.ssd import normalize_intra_dtype, ssd_chunked

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "ssd_fwd.cu"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the SSD kernel is built from "
                           f"{SOURCE} at first use and needs the CUDA toolkit")
    return found


def build(defines: tuple[str, ...] = ()) -> dict:
    """Compile (once per process and source hash) and load the kernel library.

    Returns ``{"lib", "path", "seconds", "log", "cached"}``: ``seconds`` is
    this call's build time (0 when the library was already on disk) and
    ``log`` the compiler's report (registers, shared memory, spills).
    ``defines`` (e.g. ``("SSD_PHASE_CLOCKS",)``) build an instrumented
    library; the first call in a process decides which one it uses.
    """
    with _lock:
        if "lib" in _loaded:
            return _loaded
        src = SOURCE.read_bytes()
        flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
        tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
        path = BUILD_DIR / f"libssd_fwd_{tag}.so"
        t0 = time.perf_counter()
        log, cached = "", path.exists()
        if not cached:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        ptr = ctypes.c_void_p
        lib.hnet_ssd_fwd.argtypes = [ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr,
                                     ptr, ptr] + [ctypes.c_int] * 7 + [ptr]
        lib.hnet_ssd_fwd.restype = ctypes.c_int
        lib.hnet_ssd_fwd_supported.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.hnet_ssd_fwd_supported.restype = ctypes.c_int
        lib.hnet_ssd_fwd_bf16_cluster_size.argtypes = [ctypes.c_int]
        lib.hnet_ssd_fwd_bf16_cluster_size.restype = ctypes.c_int
        lib.hnet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hnet_cuda_error_string.restype = ctypes.c_char_p
        _loaded.update(lib=lib, path=str(path), log=log, cached=cached,
                       seconds=0.0 if cached else time.perf_counter() - t0)
        return _loaded


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


def ssd_cuda(x, dt, A, B, C, chunk_size: int = 256, initial_state=None,
             return_final: bool = False, intra_dtype: str | None = None):
    """SSD forward with ``ssd_chunked``'s contract: y [B,L,H,P] in x.dtype,
    or ``(y, S_final [B,H,N,P] fp32)`` with ``return_final``.

    On CPU tensors it runs ``ssd_chunked``. On CUDA tensors it launches the
    kernel, which computes ``ssd_chunked`` at its own chunk length, 64
    (in fp32 the result does not depend on it, so ``chunk_size`` is not used
    there; in bf16 the roundings of W and the state fall at chunk bounds).
    """
    intra_bf16 = int(normalize_intra_dtype(intra_dtype) == "bf16")
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk_size=chunk_size,
                           initial_state=initial_state, return_final=return_final,
                           intra_dtype=intra_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ssd kernel runs on CUDA tensors, got {x.device}")
    _check(x, dt, A, B, C, initial_state)
    Bsz, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    lib = build()["lib"]
    if not lib.hnet_ssd_fwd_supported(P, N):
        raise ValueError(f"ssd kernel is not built for headdim P={P}, d_state N={N}")
    y = torch.empty_like(x)
    s_final = (torch.empty(Bsz, H, N, P, dtype=torch.float32, device=x.device)
               if return_final else None)
    with torch.cuda.device(x.device):
        code = lib.hnet_ssd_fwd(
            DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            y.data_ptr(), None if s_final is None else s_final.data_ptr(),
            Bsz, L, H, G, P, N, intra_bf16,
            torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"ssd kernel launch failed: cudaError {code} "
                           f"({lib.hnet_cuda_error_string(code).decode()})")
    ssd_cuda.launches += 1
    return (y, s_final) if return_final else y


ssd_cuda.launches = 0
