#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: serve Type A Small (N=1).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Drives the port (``hnet_mamba_asr_torch``) through the entry points a user
calls, at the full width of ``configs/typeA_small_N1.yaml`` with seeded
random weights, and fails (non-zero exit) when any phase fails:

1. build   -- compile the hand-written SSD kernel from ``csrc/``;
2. kernel  -- the kernel against its plain PyTorch version (``ssd_chunked``
              at the kernel's chunk length and intra_dtype) at the serving
              shapes (B 8 and 1, L 248 / 873 / 1000, H 12 / 16), bf16 with
              intra_dtype bf16 and fp32, with both times, the bound and
              the share of it; one time with a cold L2;
3. model   -- the whole model on the card (kernel path) against the same
              weights and batch on the CPU (plain path), fp32, TF32 off;
4. serve   -- 9 requests through the micro-batching server, one over HTTP,
              in the config's bf16; solo == batched; the kernel's launch
              count is 40 per model call.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# configs/typeA_small_N1.yaml, the parts the serving model reads (the card's
# machine has no PyYAML; tests/test_torch_slice.py holds this equal to the
# YAML). The CMVN file it names is not in the repository: the smoke computes
# its own statistics from seeded audio.
GATE_CONFIG = {
    "frontend_conf": {"sample_rate": 16000, "n_mels": 80, "win_length": 400,
                      "hop_length": 160, "cmvn": "features/cmvn_train960.npz"},
    "encoder": "dcasr",
    "encoder_conf": {"arch_type": "A", "d_outer": 384, "d_main": 512, "n_enc": 4,
                     "n_main": 12, "n_dec": 4, "bidirectional": True, "d_state": 128,
                     "headdim": 64, "ssd_chunk_size": 256, "ssd_intra_dtype": "bf16",
                     "remat_policy": "none",
                     "hnet": {"compression_N": 1, "chunker": "dynamic",
                              "ema_smoothing": True}},
    "head": "ctc",
    "model_conf": {"ctc_weight": 0.3, "aed_weight": 0.7, "lsm_weight": 0.1,
                   "hnet_ratio_beta": 0.03},
    "train": {"precision": "bf16"},
}
VOCAB = 500                     # bpe_500: 501 CTC classes
SEED = 1                        # experiment.seed
SR = 16000
SSD_CALLS_PER_FORWARD = 40      # 20 bidirectional blocks x (fwd + bwd)
# kernel vs plain (ssd_chunked at the kernel's chunk length, same inputs and
# intra_dtype), as max|y_kernel - y_plain| / max|y_plain| and mean|d| /
# mean|y|: fp32 differs in summation order and exp's last ulp only; in bf16
# both sides round W, the weighted B and the state at the same points and y
# at the end, and part by one bf16 ulp (2^-7 of max|y| at most) where a value
# sits on a rounding boundary, rarely (tests/test_torch_cuda.py)
KERNEL_CHUNK = 64
SSD_BOUND = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
SSD_MEAN_BOUND = {"float32": 1e-5, "bfloat16": 1e-3}
# the fp32 state from bf16-rounded operands: one flipped rounding moves a
# term by a bf16 ulp
STATE_BOUND = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# whole model, fp32 on both paths with TF32 off: log-mel by cuFFT vs the CPU
# FFT, GEMMs and the SSD in other summation orders, through 20 blocks
LOGPROB_BOUND = 5e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def synth_audio(rng, seconds: float):
    """Seeded speech-like test signal: a few gliding harmonics under noise."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 250) * (1 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.2, 2) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    sig = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t) ** 2
    return (0.05 * sig * env + 0.01 * rng.normal(size=n)).astype(np.float32)


def phase_build():
    from hnet_mamba_asr_torch.ops import ssd_cuda
    t0 = time.perf_counter()
    info = ssd_cuda.build()
    seconds = time.perf_counter() - t0
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"phase 1 build: ok, ssd_fwd.cu built in {seconds:.2f} s -> {info['path']}")
    return seconds


def phase_kernel():
    from hnet_mamba_asr_torch.ops.ssd import ssd_chunked
    from hnet_mamba_asr_torch.ops.ssd_cuda import build, ssd_cuda
    from hnet_mamba_asr_torch.tools.measure import cuda_ms, kernel_ms, ssd_cost, ssd_inputs
    lib = build()["lib"]
    rows = []
    for dtype, intra in ((torch.bfloat16, "bf16"), (torch.float32, None)):
        name = str(dtype).removeprefix("torch.")
        for Bsz in (8, 1):
            for L in (248, 873, 1000):
                for H in (12, 16):
                    x, dt, A, B, C = ssd_inputs(Bsz, L, H, dtype, seed=SEED)
                    y = ssd_cuda(x, dt, A, B, C, intra_dtype=intra)
                    ref = ssd_chunked(x, dt, A, B, C, chunk_size=KERNEL_CHUNK,
                                      intra_dtype=intra)
                    torch.cuda.synchronize()
                    if not torch.isfinite(y).all():
                        raise AssertionError(f"ssd kernel output not finite "
                                             f"({name}, B {Bsz}, L {L}, H {H})")
                    d = (y.float() - ref.float()).abs()
                    abs_err = d.max().item()
                    rel = abs_err / ref.float().abs().max().item()
                    mean = d.mean().item() / ref.float().abs().mean().item()
                    call_ms = cuda_ms(lambda: ssd_cuda(x, dt, A, B, C, intra_dtype=intra))
                    # the kernel's device time; the events' time if the
                    # profiler's traces came back empty
                    ms = kernel_ms(lambda: ssd_cuda(x, dt, A, B, C, intra_dtype=intra),
                                   "ssd_fwd") or call_ms
                    plain_ms = cuda_ms(lambda: ssd_chunked(
                        x, dt, A, B, C, chunk_size=KERNEL_CHUNK, intra_dtype=intra))
                    cost = ssd_cost(Bsz, L, H, 1, 64, 128, name)
                    blocks = Bsz * H * (lib.hnet_ssd_fwd_bf16_cluster_size(L)
                                        if dtype == torch.bfloat16 else 1)
                    log(f"  ssd {name} intra {intra} B{Bsz} L{L} H{H} P64 N128 G1: "
                        f"max|d|/max|y| {rel:.3e} (bound {SSD_BOUND[name]:g}) mean|d|/mean|y| "
                        f"{mean:.3e} (bound {SSD_MEAN_BOUND[name]:g}) max|d| {abs_err:.3e}; "
                        f"kernel {ms:.4f} ms (call {call_ms:.4f} ms) plain {plain_ms:.4f} ms; bound "
                        f"{cost['bound_ms'] * 1e3:.2f} us ({cost['bound_by']}: bytes "
                        f"{cost['bytes_us']:.2f} us, ops {cost['ops_us']:.2f} us), share "
                        f"{cost['bound_ms'] / ms:.2%}; {blocks} blocks")
                    if not (rel <= SSD_BOUND[name] and mean <= SSD_MEAN_BOUND[name]):
                        raise AssertionError(f"ssd kernel disagrees with ssd_chunked: "
                                             f"{rel:.3e}, mean {mean:.3e} ({name}, B {Bsz}, "
                                             f"L {L}, H {H})")
                    rows.append(dict(dtype=name, B=Bsz, H=H, L=L, rel=rel, abs_err=abs_err,
                                     ms=ms, call_ms=call_ms, plain_ms=plain_ms, **cost))
    # the serving case once more with a cold L2: a 64 MB write between launches
    x, dt, A, B, C = ssd_inputs(8, 873, 16, torch.bfloat16, seed=SEED)
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device="cuda")
    cold = cuda_ms(lambda: ssd_cuda(x, dt, A, B, C, intra_dtype="bf16"), flush=flush)
    warm = next(r["call_ms"] for r in rows if (r["dtype"], r["B"], r["L"], r["H"])
                == ("bfloat16", 8, 873, 16))
    log(f"  ssd bfloat16 intra bf16 B8 L873 H16, L2 cold (64 MB written before each "
        f"launch, each timed alone): kernel {cold:.4f} ms (back-to-back, L2 warm: "
        f"{warm:.4f} ms)")
    del flush
    # the state in and out (streaming / long-form contract of ssd_chunked);
    # bf16 at L 1100 takes two rounds and carries the state between them
    for dtype, L, intra in ((torch.float32, 300, None), (torch.bfloat16, 1100, "bf16")):
        name = str(dtype).removeprefix("torch.")
        x, dt, A, B, C = ssd_inputs(2, L, 12, dtype, seed=SEED + 3)
        s0 = torch.randn(2, 12, 128, 64, device="cuda")
        y, s = ssd_cuda(x, dt, A, B, C, initial_state=s0, return_final=True, intra_dtype=intra)
        yr, sr = ssd_chunked(x, dt, A, B, C, chunk_size=KERNEL_CHUNK, initial_state=s0,
                             return_final=True, intra_dtype=intra)
        rel_y = ((y.float() - yr.float()).abs().max() / yr.float().abs().max()).item()
        rel_s = ((s - sr).abs().max() / sr.abs().max()).item()
        log(f"  ssd {name} L{L} initial_state/return_final: y {rel_y:.3e} state {rel_s:.3e}")
        if not (rel_y <= SSD_BOUND[name] and rel_s <= STATE_BOUND[name]):
            raise AssertionError(f"ssd kernel state in/out disagrees with ssd_chunked ({name})")
    log("phase 2 kernel: ok")
    return rows


def make_cmvn(torch_device: str):
    """CMVN statistics from seeded audio (the config's file is not shipped)."""
    from hnet_mamba_asr_torch.data.features import GlobalCMVN
    from hnet_mamba_asr_torch.ops.melspec import log_mel_spectrogram
    wave = synth_audio(np.random.default_rng(SEED + 100), 20.0)
    feats, _ = log_mel_spectrogram(torch.from_numpy(wave).to(torch_device))
    f = feats[0].double().cpu().numpy()
    return GlobalCMVN(f.mean(0), np.sqrt(np.maximum(f.var(0), 1e-8)))


def phase_model(cmvn):
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.serving.runtime import ServingModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = copy.deepcopy(GATE_CONFIG)
    cfg["train"]["precision"] = "fp32"
    # fp32 throughout: with intra_dtype bf16 the intra-chunk weights are
    # rounded to bf16, and a score whose two summation orders (SIMT vs the
    # CPU) straddle a rounding boundary moves its weight by a bf16 ulp;
    # through 20 blocks that reached 1.2e-2 in log-prob (one H100 run). The
    # kernel's intra epilogue is held in phase 2 and tests/test_torch_cuda.py.
    cfg["encoder_conf"]["ssd_intra_dtype"] = None
    rng = np.random.default_rng(SEED + 1)
    waves = [synth_audio(rng, 6.0), synth_audio(rng, 3.5)]
    lens = np.array([len(w) for w in waves])
    batch = np.zeros((2, lens.max()), np.float32)
    for i, w in enumerate(waves):
        batch[i, :len(w)] = w
    kw = dict(vocab_size=VOCAB, cmvn=cmvn, seed=SEED, emit=("frame_ids", "log_probs"))
    gpu = ServingModel(cfg, None, "cuda", **kw)
    before = ssd_cuda.launches
    out_k = gpu(batch, lens)
    torch.cuda.synchronize()
    if ssd_cuda.launches - before != SSD_CALLS_PER_FORWARD:
        raise AssertionError("the model's CUDA forward did not run the SSD kernel "
                             f"{SSD_CALLS_PER_FORWARD} times")
    cpu = ServingModel(cfg, None, "cpu", **kw)
    out_p = cpu(batch, lens)
    if not np.array_equal(out_k["enc_lengths"], out_p["enc_lengths"]):
        raise AssertionError("encoder lengths differ between the paths")
    worst, agree, total = 0.0, 0, 0
    for i, n in enumerate(out_k["enc_lengths"]):
        lk, lp = out_k["log_probs"][i, :n], out_p["log_probs"][i, :n]
        if not np.isfinite(lk).all():
            raise AssertionError("kernel-path log-probs are not finite")
        worst = max(worst, float(np.abs(lk - lp).max()))
        agree += int((out_k["frame_ids"][i, :n] == out_p["frame_ids"][i, :n]).sum())
        total += int(n)
    log(f"  model fp32 (TF32 off), 2 rows of {lens.tolist()} samples -> "
        f"{out_k['enc_lengths'].tolist()} frames: max|d log_prob| {worst:.3e} "
        f"(bound {LOGPROB_BOUND:g}), frame ids equal on {agree}/{total}")
    if not worst <= LOGPROB_BOUND:
        raise AssertionError(f"kernel path disagrees with the plain path: {worst:.3e}")
    del gpu
    torch.cuda.empty_cache()
    log("phase 3 model: ok")


def phase_serve(cmvn):
    from hnet_mamba_asr_torch.models.encoder import subsampled_length
    from hnet_mamba_asr_torch.ops.melspec import frame_count
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.serving.runtime import ServingModel, collapse_ctc
    from hnet_mamba_asr_torch.serving.server import make_server
    model = ServingModel(GATE_CONFIG, None, "cuda", vocab_size=VOCAB, cmvn=cmvn,
                         seed=SEED, max_batch=8, max_samples=40 * SR)
    rng = np.random.default_rng(SEED + 2)
    seconds = [float(s) for s in rng.uniform(2.0, 16.0, size=8)] + [35.0]
    waves = [synth_audio(rng, s) for s in seconds]
    warm = waves[0]
    model(warm[None], [len(warm)])                   # cuBLAS / cuDNN set-up
    torch.cuda.synchronize()

    httpd, batcher = make_server(model, "127.0.0.1", 0, max_wait_ms=50.0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        ssd_cuda.launches = 0
        model.calls = 0
        http_result = {}

        def post_long():
            req = urllib.request.Request(
                f"{url}/v1/transcribe", data=waves[-1].tobytes(),
                headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=300) as r:
                http_result.update(json.loads(r.read()))

        t0 = time.perf_counter()
        poster = threading.Thread(target=post_long)
        poster.start()
        futures = [batcher.submit(w) for w in waves[:-1]]
        results = [f.result(timeout=300) for f in futures]
        poster.join(timeout=300)
        if poster.is_alive() or not http_result:
            raise AssertionError("the HTTP request did not complete")
        results.append(http_result)
        alone = model(waves[0][None], [len(waves[0])])
        solo = collapse_ctc(alone["frame_ids"], alone["enc_lengths"], model.blank_id)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, calls = ssd_cuda.launches, model.calls

        with urllib.request.urlopen(f"{url}/v1/health", timeout=30) as r:
            health = json.loads(r.read())
        stats = batcher.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        server.join(timeout=30)

    for s, w, r in zip(seconds, waves, results):
        want = int(subsampled_length(frame_count(len(w))))
        ok_ids = all(isinstance(t, int) and 0 <= t < VOCAB for t in r["ids"])
        log(f"  request {s:6.2f} s: enc_frames {r['enc_frames']} (expected {want}), "
            f"{len(r['ids'])} ids")
        if r["enc_frames"] != want or not ok_ids:
            raise AssertionError(f"bad result for the {s:.2f} s request: {r}")
    if solo != results[0]["ids"]:
        raise AssertionError("request 0 served alone differs from its batched result: "
                             f"{solo} vs {results[0]['ids']}")
    if calls < 2 or launches != SSD_CALLS_PER_FORWARD * calls:
        raise AssertionError(f"kernel launches {launches} != {SSD_CALLS_PER_FORWARD} x "
                             f"{calls} model calls")
    if health.get("status") != "ok":
        raise AssertionError(f"health: {health}")
    log(f"  served {len(results)} requests ({stats['batches']} batches, mean occupancy "
        f"{stats['mean_batch_occupancy']:.2f}) + 1 solo in {wall:.3f} s; latency "
        f"p50 {stats['latency_ms_p50']:.1f} ms p95 {stats['latency_ms_p95']:.1f} ms; "
        f"solo == batched; ssd launches {launches} = {SSD_CALLS_PER_FORWARD} x {calls} calls")
    log("phase 4 serve: ok")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "hnet_mamba_asr_torch" / "csrc" / "ssd_fwd.cu").exists():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phase_build()
    rows = phase_kernel()
    cmvn = make_cmvn("cuda")
    phase_model(cmvn)
    launches = phase_serve(cmvn)
    main = next(r for r in rows if (r["dtype"], r["B"], r["L"], r["H"])
                == ("bfloat16", 8, 248, 16))
    log("kernel summary: ssd_fwd at bf16 (intra bf16) B8 L248 H16 P64 N128 "
        "(a 10 s request, main stack); no single PyTorch call computes the scan")
    log(json.dumps({"kernels": [{
        "name": "ssd_fwd", "route": "cuda",
        "source": "hnet_mamba_asr_torch/csrc/ssd_fwd.cu",
        "replaces": "hnet_mamba_asr_tpu/ops/ssd_pallas.py:33",
        "launches": launches, "max_abs_err": main["abs_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "roofline_share": main["bound_ms"] / main["ms"]}]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
