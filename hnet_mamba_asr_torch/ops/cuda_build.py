"""Build the port's hand-written CUDA kernels: one ``nvcc`` per source in
``csrc/``, all started together, each into a shared library with a plain C
interface under ``_build/`` beside this package.

A library's name carries a hash of its source, the headers it includes and
the flags, so an edited source or header is rebuilt and never mixed with an
old library. ``ops/ssd_cuda.py``, ``ops/ema_cuda.py`` and ``ops/rnnt_cuda.py`` load their
libraries from here with ``ctypes``; the first of them to launch builds all
of them.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# library name -> (source, headers it includes)
SOURCES = {"ssd_fwd": (CSRC / "ssd_fwd.cu", (CSRC / "ssd_common.cuh",)),
           "ssd_bwd": (CSRC / "ssd_bwd.cu", (CSRC / "ssd_common.cuh",)),
           "ssd_fwd_p16n16": (CSRC / "ssd_fwd.cu", (CSRC / "ssd_common.cuh",)),
           "ssd_bwd_p16n16": (CSRC / "ssd_bwd.cu", (CSRC / "ssd_common.cuh",)),
           "ema": (CSRC / "ema.cu", ()),
           "rnnt": (CSRC / "rnnt.cu", ())}
# macros a library is always built with: the SSD kernels for headdim 16 and
# d_state 16 (the narrow models of the tone-corpus gate; fp32 kernels only)
FIXED_DEFINES = {"ssd_fwd_p16n16": ("SSD_HEADDIM=16", "SSD_DSTATE=16"),
                 "ssd_bwd_p16n16": ("SSD_HEADDIM=16", "SSD_DSTATE=16")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_built: dict = {}


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found: the kernels are built from {CSRC} at first "
                           "use and need the CUDA toolkit")
    return found


def build_all(defines: dict[str, tuple[str, ...]] | None = None) -> dict:
    """Compile (once per process and source hash) every library of
    ``SOURCES``, one ``nvcc`` per source, started together.

    ``defines`` maps a library to extra ``-D`` macros (e.g. ``{"ssd_fwd":
    ("SSD_PHASE_CLOCKS",)}`` for an instrumented forward); the first call
    in a process decides which build it uses. Returns ``{"paths": {name:
    path}, "seconds", "log", "cached"}``: ``seconds`` is this build's time
    (0 when every library was already on disk) and ``log`` the compiler's
    report (registers, shared memory, spills).
    """
    defines = defines or {}
    with _lock:
        if _built:
            return _built
        t0 = time.perf_counter()
        paths, jobs = {}, {}
        for name, (source, headers) in SOURCES.items():
            flags = (*NVCC_FLAGS, *(f"-D{d}" for d in
                                    FIXED_DEFINES.get(name, ()) + tuple(defines.get(name, ()))))
            blob = source.read_bytes() + b"".join(h.read_bytes() for h in headers)
            tag = hashlib.sha256(blob + " ".join(flags).encode()).hexdigest()[:16]
            paths[name] = BUILD_DIR / f"lib{name}_{tag}.so"
            if not paths[name].exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
                jobs[name] = (tmp, subprocess.Popen(
                    [nvcc(), *flags, "-o", str(tmp), str(source)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = {name: proc.communicate()[0] for name, (_, proc) in jobs.items()}
        for name, (tmp, proc) in jobs.items():
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCES[name][0]} "
                                   f"({proc.returncode}):\n{outs[name]}")
            os.replace(tmp, paths[name])
        logs = [f"{SOURCES[name][0].name}:\n{out}" for name, out in outs.items()]
        _built.update(paths=paths, log="\n".join(logs), cached=not jobs,
                      seconds=time.perf_counter() - t0 if jobs else 0.0)
        return _built
