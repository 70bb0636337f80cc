"""Background checkpoint writer, counterpart of
``hnet_mamba_asr_tpu/training/async_ckpt.py``: the pickling and the disk
writes of a save overlap the next epoch's steps.

- torch's optimizer step changes the parameters and moments in place, so
  the caller copies the state to the host before it submits (the trainer's
  ``save_checkpoint``); the worker only pickles and writes those copies, and
  no later step can reach into a save.
- Every file operation of the checkpoint directory (writes, best symlinks,
  pruning) goes through the one FIFO queue, so their order is the
  synchronous order and no two threads touch the directory at once.
- Decisions that read the trainer's live state (``metric_history``) are
  made on the main thread when a job is submitted; a job only does IO.
- The first failure of a job is raised on the main thread by the next
  ``submit`` / ``flush`` / ``close``; later jobs are drained unrun.
"""
from __future__ import annotations

import atexit
import queue
import threading

__all__ = ["AsyncWriter"]


class AsyncWriter:
    """Single-threaded FIFO executor for checkpoint IO; ``maxsize`` bounds
    the jobs (and host copies of the state) outstanding."""

    def __init__(self, name: str = "ckpt-writer", maxsize: int = 8):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._exc: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()
        # the worker is a daemon thread: a save in flight at exit would be lost
        atexit.register(self.close)

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                self._q.task_done()
                return
            try:
                if self._exc is None:     # after a failure, drain without running
                    fn()
            except BaseException as e:    # noqa: BLE001 - must cross threads
                self._exc = e
            finally:
                self._q.task_done()

    def _check(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("async checkpoint write failed") from exc

    def submit(self, fn) -> None:
        """Enqueue ``fn`` to run in order; raises any earlier failure."""
        if self._closed:
            raise RuntimeError("AsyncWriter is closed")
        self._check()
        self._q.put(fn)

    def flush(self) -> None:
        """Block until everything submitted so far has run; raise failures."""
        self._q.join()
        self._check()

    def close(self) -> None:
        """Flush, then stop the worker thread (idempotent)."""
        if self._closed:
            return
        self._q.join()
        self._closed = True
        self._q.put(None)
        self._q.join()
        self._thread.join(timeout=60)
        self._check()
