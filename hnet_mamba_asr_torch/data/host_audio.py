"""The port's host audio library (``csrc/host_audio.cpp``): FLAC decoding and
polyphase resampling in C++, bound with ctypes.

The library is built at first use with the host C++ compiler
(``c++ -O3 -shared -fPIC -std=c++17``; ``$CXX`` names another) into
``_build/`` beside the package, its file name keyed on a hash of the source
and the command, as ``ops/cuda_build.py`` keys the CUDA libraries. A build
or load that fails raises with the command and the compiler's output: there
is no fall-back to the numpy twins (``data/flac.py::decode_flac_bytes``,
``data/audio.py::resample_plain``), which exist for the tests.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "host_audio.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_F64 = ctypes.POINTER(ctypes.c_double)

_lock = threading.Lock()
_lib = None

FLAC_ERRORS = {-1: "bad magic or no STREAMINFO", -2: "truncated stream",
               -3: "unsupported or corrupt frame", -4: "more samples than STREAMINFO says",
               -5: "frame CRC mismatch"}


def compiler() -> str:
    cxx = os.environ.get("CXX", "c++")
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"no C++ compiler ({cxx!r} is not on PATH): the host audio "
                           f"library is built from {SOURCE} at first use")
    return found


def library_path() -> Path:
    cmd = " ".join((os.environ.get("CXX", "c++"), *FLAGS))
    tag = hashlib.sha256(SOURCE.read_bytes() + cmd.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libhost_audio_{tag}.so"


def build() -> Path:
    """Compile the library unless it is on disk (atomic: tmp, rename)."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler(), *FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host audio library build failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path


def lib():
    """The loaded library (built on the first call in a process)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                handle = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"host audio library {path} does not load: {e}") from e
            handle.hmasr_resample_poly.restype = None
            handle.hmasr_resample_poly.argtypes = [_F64, ctypes.c_int64, _F64, ctypes.c_int64,
                                                   ctypes.c_int64, ctypes.c_int64, _F64,
                                                   ctypes.c_int64]
            handle.hmasr_flac_decode.restype = ctypes.c_int64
            handle.hmasr_flac_decode.argtypes = [_U8, ctypes.c_int64, _I32, ctypes.c_int64,
                                                 _I64]
            _lib = handle
        return _lib


def resample_poly(x: np.ndarray, kern: np.ndarray, up: int, down: int,
                  n_out: int) -> np.ndarray:
    """out[j] = sum_s x[s] kern[j down + len(kern) // 2 - s up] (float64)."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    kern = np.ascontiguousarray(kern, dtype=np.float64)
    out = np.empty(n_out, dtype=np.float64)
    lib().hmasr_resample_poly(x.ctypes.data_as(_F64), len(x), kern.ctypes.data_as(_F64),
                              len(kern), up, down, out.ctypes.data_as(_F64), n_out)
    return out


def flac_decode(data: bytes) -> tuple[np.ndarray, int, int]:
    """FLAC bytes -> (samples int32 [n, channels], sample_rate, bps), every
    frame's CRC-8 and CRC-16 checked. Raises ValueError on a stream the
    decoder refuses (a bad CRC, more than 2 channels, STREAMINFO without a
    sample count)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    info = np.zeros(4, dtype=np.int64)
    handle = lib()
    # a capacity-0 call reads STREAMINFO (and returns -4 at the first frame)
    handle.hmasr_flac_decode(buf.ctypes.data_as(_U8), len(buf), None, 0,
                             info.ctypes.data_as(_I64))
    channels, total = int(info[0]), int(info[3])
    if channels == 0:
        raise ValueError(f"flac: {FLAC_ERRORS[-1]}")
    if total <= 0 or channels not in (1, 2):
        raise ValueError(f"flac: the host decoder needs 1-2 channels and STREAMINFO's "
                         f"sample count (channels {channels}, total {total})")
    out = np.empty(total * channels, dtype=np.int32)
    n = handle.hmasr_flac_decode(buf.ctypes.data_as(_U8), len(buf), out.ctypes.data_as(_I32),
                                 out.size, info.ctypes.data_as(_I64))
    if n < 0:
        raise ValueError(f"flac: {FLAC_ERRORS.get(int(n), f'error {n}')}")
    return out[:n * channels].reshape(-1, channels), int(info[1]), int(info[2])
