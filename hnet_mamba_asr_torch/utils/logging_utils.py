"""Process-wide logging: console + rotating file, one file per entry point.

Counterpart of ``hnet_mamba_asr_tpu/utils/logging_utils.py``: each process
of a multi-process run gets its own log file suffixed with its rank, so
concurrent writers never interleave. ``$HMASR_LOG_DIR`` overrides the log
directory (useful for tests and cluster runs).
"""
from __future__ import annotations

import logging
import logging.handlers
import os
import sys
from pathlib import Path

_CONFIGURED = False

_FMT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def _process_index() -> int:
    """The process's rank from the launcher's environment; single-process -> 0."""
    for var in ("JAX_PROCESS_INDEX", "PROCESS_INDEX", "RANK"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def setup_logging(name: str = "run", log_dir: str | os.PathLike | None = None,
                  level: int = logging.INFO) -> None:
    """Configure the root logger once per process: stderr + rotating file.

    ``name`` labels the entry point (decode/score/...). The file is
    ``<log_dir>/<name>.log`` (rank-suffixed when the rank is > 0), rotating at
    50 MB x 5 backups. Re-invocation is a no-op (first caller wins).
    """
    global _CONFIGURED
    if _CONFIGURED:
        return
    root = logging.getLogger()
    root.setLevel(level)
    con = logging.StreamHandler(sys.stderr)
    con.setFormatter(logging.Formatter(_FMT))
    root.addHandler(con)

    ld = os.environ.get("HMASR_LOG_DIR", log_dir)
    if ld is not None:
        ld = Path(ld)
        ld.mkdir(parents=True, exist_ok=True)
        idx = _process_index()
        fname = f"{name}.log" if idx == 0 else f"{name}.rank{idx}.log"
        fh = logging.handlers.RotatingFileHandler(
            ld / fname, maxBytes=50 * 1024 * 1024, backupCount=5)
        fh.setFormatter(logging.Formatter(_FMT))
        root.addHandler(fh)
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)
