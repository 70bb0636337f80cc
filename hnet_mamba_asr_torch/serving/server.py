"""Micro-batching ASR server over the port's ``ServingModel``.

Counterpart of ``hnet_mamba_asr_tpu/serving/server.py`` (offline path): a
background worker coalesces requests that arrive within a short window into
one padded batch, runs the model once, and fans the results back out.

    python -m hnet_mamba_asr_torch.serving.server --config-json cfg.json \
        --params artifact/params.npz --device cuda --port 8000 [--emit beam_ids]

A row's ids come from the CTC prefix beam (``beam_ids``), else CTC greedy
(``frame_ids``), else the AED greedy decode cut at its first eos
(``aed_ids``), as in the JAX server.

HTTP surface (JSON responses):
    POST /v1/transcribe   body = WAV (PCM16 mono) or raw float32 PCM
                          (Content-Type: application/octet-stream);
                          -> {"ids": [...], "text": "...", "enc_frames": N}
                          (text only when the model has a tokenizer table)
    GET  /v1/health       -> {"status": "ok", buckets, emit, pending}
    GET  /v1/stats        -> request/batch counters, mean batch occupancy,
                             p50/p95 end-to-end latency ms
"""
from __future__ import annotations

import io
import json
import threading
import time
import wave as wave_mod
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from hnet_mamba_asr_torch.serving.runtime import ServingModel, detokenize, ids_per_row


def decode_audio(body: bytes, content_type: str) -> np.ndarray:
    """Request body -> float32 waveform in [-1, 1]. WAV must be PCM16 mono."""
    if content_type.startswith("application/octet-stream"):
        if len(body) % 4:
            raise ValueError("raw PCM body length must be a multiple of 4 "
                             "(little-endian float32)")
        return np.frombuffer(body, "<f4").astype(np.float32)
    with wave_mod.open(io.BytesIO(body)) as w:
        if w.getcomptype() != "NONE" or w.getsampwidth() != 2:
            raise ValueError("WAV must be uncompressed PCM16")
        n, ch = w.getnframes(), w.getnchannels()
        pcm = np.frombuffer(w.readframes(n), "<i2").astype(np.float32)
        if ch > 1:                       # downmix: serving is mono
            pcm = pcm.reshape(-1, ch).mean(axis=1)
        return pcm / 32768.0


class MicroBatcher:
    """Coalesce concurrent requests into padded batches for the model.

    Requests that arrive within ``max_wait_ms`` of the first pending one (or
    until ``max_batch`` is reached) run as ONE model call. Each submit
    returns a Future resolving to the per-utterance result dict.
    """

    def __init__(self, model: ServingModel, max_batch: int | None = None,
                 max_wait_ms: float = 20.0):
        if not {"beam_ids", "frame_ids", "aed_ids"} & set(model.emit):
            raise ValueError(f"the batcher serves beam_ids, frame_ids or aed_ids; model "
                             f"emits {model.emit}")
        self.model = model
        self.max_batch = min(int(max_batch or model.max_batch), model.max_batch)
        self.max_samples = model.max_samples
        self.max_wait = max_wait_ms / 1e3
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self.n_requests = 0
        self.n_batches = 0
        self.occupancy_sum = 0
        self._lat = deque(maxlen=1024)          # end-to-end seconds
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side ----------------------------------------------------------
    def submit(self, wave: np.ndarray) -> Future:
        wave = np.asarray(wave, np.float32).reshape(-1)
        if wave.shape[0] > self.max_samples:
            raise ValueError(
                f"utterance of {wave.shape[0]} samples exceeds the largest "
                f"exported bucket ({self.max_samples}); chunk upstream or "
                "use a streaming artifact")
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.append((wave, fut, time.perf_counter()))
            self._cv.notify()
        return fut

    @property
    def pending(self) -> int:
        with self._cv:
            return len(self._q)

    def stats(self) -> dict:
        with self._cv:
            lat = sorted(self._lat)
        pct = lambda p: (lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3  # noqa: E731
                         if lat else None)
        return {
            "requests": self.n_requests, "batches": self.n_batches,
            "mean_batch_occupancy": (self.occupancy_sum / self.n_batches
                                     if self.n_batches else None),
            "latency_ms_p50": pct(0.50), "latency_ms_p95": pct(0.95),
        }

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=30)

    # -- worker side ----------------------------------------------------------
    def _take_batch(self) -> list | None:
        with self._cv:
            while not self._q and not self._closed:
                self._cv.wait()
            if not self._q:
                return None                      # closed and drained
            deadline = time.perf_counter() + self.max_wait
            while len(self._q) < self.max_batch and not self._closed:
                left = deadline - time.perf_counter()
                if left <= 0 or not self._cv.wait(timeout=left):
                    break
            n = min(len(self._q), self.max_batch)
            return [self._q.popleft() for _ in range(n)]

    def _run(self):
        while True:
            items = self._take_batch()
            if items is None:
                return
            waves = [w for w, _, _ in items]
            lens = np.asarray([w.shape[0] for w in waves], np.int64)
            batch = np.zeros((len(waves), int(lens.max())), np.float32)
            for i, w in enumerate(waves):
                batch[i, :w.shape[0]] = w
            try:
                out = self.model(batch, lens)
                results = self._per_row(out, len(waves))
            except Exception as e:  # noqa: BLE001 — resolve, don't kill the worker
                for _, fut, _ in items:
                    if not fut.cancelled():
                        fut.set_exception(e)
                continue
            now = time.perf_counter()
            with self._cv:
                self.n_requests += len(items)
                self.n_batches += 1
                self.occupancy_sum += len(items)
                for _, _, t0 in items:
                    self._lat.append(now - t0)
            for (_, fut, _), res in zip(items, results):
                if not fut.cancelled():
                    fut.set_result(res)

    def _per_row(self, out: dict, n: int) -> list[dict]:
        tok = self.model.tokenizer
        ids = ids_per_row(out, self.model.blank_id, self.model.eos_id)
        rows = []
        for i in range(n):
            r: dict = {"ids": ids[i], "enc_frames": int(out["enc_lengths"][i])}
            if tok is not None:
                r["text"] = detokenize(tok, ids[i])
            rows.append(r)
        return rows


def make_server(model: ServingModel, host: str = "127.0.0.1", port: int = 0,
                max_wait_ms: float = 20.0, max_batch: int | None = None):
    """Build (ThreadingHTTPServer, MicroBatcher); the caller runs
    ``serve_forever``. port=0 binds an ephemeral port
    (``server.server_address[1]``)."""
    batcher = MicroBatcher(model, max_batch=max_batch, max_wait_ms=max_wait_ms)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):               # quiet; stats endpoint instead
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/health":
                self._json(200, {"status": "ok", "buckets": model.buckets,
                                 "emit": list(model.emit),
                                 "pending": batcher.pending})
            elif self.path == "/v1/stats":
                self._json(200, batcher.stats())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/v1/transcribe":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                wave = decode_audio(self.rfile.read(n),
                                    self.headers.get("Content-Type", ""))
                res = batcher.submit(wave).result(timeout=120)
                self._json(200, res)
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — surface, don't crash
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.batcher = batcher
    return httpd, batcher


def main(argv=None, config: dict | None = None):
    """Serve over HTTP. The model config comes from ``--config-json`` or the
    ``config`` argument; weights from ``--params`` (a JAX ``params.npz``) or,
    without it, from ``--seed`` (then ``--vocab-size`` is required)."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-json", default=None)
    ap.add_argument("--params", default=None)
    ap.add_argument("--vocab-size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cmvn", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--emit", default="frame_ids",
                    help="comma-separated emit modes: frame_ids, log_probs, aed_ids, beam_ids")
    args = ap.parse_args(argv)
    if config is None:
        if args.config_json is None:
            ap.error("--config-json is required")
        with open(args.config_json) as f:
            config = json.load(f)
    model = ServingModel(config, args.params, args.device, vocab_size=args.vocab_size,
                         cmvn=args.cmvn, seed=args.seed, max_batch=args.max_batch,
                         emit=tuple(args.emit.split(",")))
    httpd, batcher = make_server(model, args.host, args.port, args.max_wait_ms,
                                 args.max_batch)
    print(f"serving on {httpd.server_address} (device {model.device}, "
          f"max_batch {model.max_batch}, max_samples {model.max_samples})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        batcher.close()
        httpd.server_close()


if __name__ == "__main__":
    main()
