"""Numeric metrics sink, counterpart of
``hnet_mamba_asr_tpu/utils/metrics_logger.py``: an append-only
``metrics.jsonl`` (one record ``{"step", "time", <meta>, <scalars>}`` a line,
flushed as written) and an atomic ``summary.json`` (tmp, then
``os.replace``) under ``run_dir``. A resumed run appends (with a
``{"event": "resume"}`` marker line when the file is not empty), a fresh
run truncates. The records keep JAX's keys. The JAX sink's optional
TensorBoard writer (tensorboardX) is left out: neither machine has it.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path


class MetricsLogger:
    """metrics.jsonl + summary.json under ``run_dir`` (one process)."""

    def __init__(self, run_dir: str | os.PathLike, resume: bool = False):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._summary: dict = {}
        jsonl_path = self.run_dir / "metrics.jsonl"
        summary_path = self.run_dir / "summary.json"
        if resume and summary_path.exists():
            try:
                self._summary = json.loads(summary_path.read_text())
            except json.JSONDecodeError:
                self._summary = {}
        if not resume:
            jsonl_path.write_text("")
        self._jsonl = open(jsonl_path, "a")
        if resume and jsonl_path.stat().st_size:
            # a resumed run may log again the steps after its last checkpoint;
            # the marker tells a reader where the new segment starts
            self._jsonl.write(json.dumps({"event": "resume", "time": time.time()}) + "\n")
            self._jsonl.flush()

    def log_scalar(self, key: str, value: float, step: int, **meta) -> None:
        self.log_scalars({key: value}, step, **meta)

    def log_scalars(self, payload: dict, step: int, **meta) -> None:
        rec = {"step": int(step), "time": time.time(), **meta,
               **{k: _scalarize(v) for k, v in payload.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()                      # per record: a killed run keeps its lines

    def update_summary(self, **kv) -> None:
        self._summary.update({k: _scalarize(v) for k, v in kv.items()})
        self._write_summary()

    def append_summary(self, key: str, record) -> None:
        """Append ``record`` to a list-valued summary key (kept across resumes)."""
        self._summary.setdefault(key, []).append(record)
        self._write_summary()

    def _write_summary(self) -> None:
        path = self.run_dir / "summary.json"
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self._summary, indent=2, default=str))
        os.replace(tmp, path)                    # readers never see a torn file

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def _scalarize(v):
    """A numpy / torch scalar -> a Python float or int; anything else as is."""
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    return v
