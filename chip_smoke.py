#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: serve and train Type A
Small at N=1 and with H-Net dynamic chunking at N=2.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Drives the port (``hnet_mamba_asr_torch``) through the entry points a user
calls, at the full width of ``configs/typeA_small_N1.yaml`` and
``configs/typeA_small_N2.yaml`` with seeded random weights, and fails
(non-zero exit) when any phase fails:

1. build    -- compile the hand-written kernels (SSD forward and backward,
               the H-Net EMA) from ``csrc/``, one nvcc per source, started
               together;
2. kernel   -- the forward kernel against its plain PyTorch version
               (``ssd_chunked`` at the kernel's chunk length and
               intra_dtype) at the serving shapes (B 8 and 1, L 248 / 873 /
               1000, H 12 / 16) and the training ones (B 32, L 249), bf16
               with intra_dtype bf16 and fp32, with both times, the bound and
               the share of it; one time with a cold L2;
   backward -- the backward kernel's gradients of x, dt, A, B, C against
               autograd of ``ssd_chunked`` at the training shapes (B 32,
               L 249, H 12 / 16), at L 873 (two cluster rounds) and at B 1,
               fp32 and bf16, intra_dtype off and bf16, with both times, the
               bound and the share of it; two calls on the same inputs are
               bitwise equal; then bf16 with the state in and out at L 1100
               (three rounds of the reverse chain): every input's gradient
               and d(initial_state);
   ema      -- the EMA kernels (forward and backward) against the plain
               recurrence and the plain matmul form at the dechunk's shapes
               (B 64 M 128 / 256, B 8 M 880, D 384 and 512, B 1), bf16 and
               fp32, with saturated P and M = 1: zbar, dz, dP, zero dP at
               saturated slots, two calls bitwise equal; both times and the
               bound;
3. model    -- the whole model on the card (kernel path) against the same
               weights and batch on the CPU (plain path), fp32, TF32 off;
   hnet     -- the same at N = 2 (Type A), N = 4 (Type B, n_mid 1) and with
               the fixed-pool chunker at N = 2, depth 1 + 2 + 1, 4
               utterances of 2-16 s: the boundaries equal, then features
               and log-probs;
4. serve    -- 9 requests through the micro-batching server, one over HTTP,
               in the config's bf16; solo == batched; the kernel's launch
               count is 40 per model call; then the same at N = 2 (40 SSD
               and 1 EMA launches per call);
5. train    -- the gate config (hybrid 0.3 CTC + 0.7 AED, bf16, SpecAugment,
               AED dropout, remat none, accum_grad 2) through ``Trainer``,
               3 updates of 2 micro-batches of 32 x 10 s: finite losses and
               gradient norms, step time, mel-frames/s, peak memory, 40 + 40
               SSD kernel launches per micro-step; then one micro-step per
               remat policy: full and dots give none's loss and gradient
               norm with 80 forward launches; then the N = 2 config (one
               micro-batch of 64 x 10 s, remat full, the damped router
               group): 3 updates, finite, a positive ratio loss, the
               router's rate and eps, 80 + 40 SSD and 1 + 1 EMA launches per
               micro-step;
6. descent  -- 5 updates on one fixed batch of 8 x 10 s at a constant lr of
               1e-3: the loss falls;
7. grads    -- one fp32 micro-step at full width and depth 1 + 2 + 1 on the
               card and on the CPU: every parameter's gradient agrees
               (1e-3 of its max; the first conv's 1e-2); then at N = 2,
               the boundaries equal first, the router's leaves included;
8. bench    -- ``bench.py``'s gate-cell step (CTC only, clip 5 + AdamW
               1e-3): mel-frames/s at 32 x 10 s with remat none and at
               64 x 10 s with remat full.

The line before the last is a JSON summary of the kernels, with the
launches of the N = 2 training run; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

# the gate config and its test data; outside a checkout this import fails
from hnet_mamba_asr_torch.tools.gate import (
    GATE_CONFIG, GATE_TRAIN, N2_CONFIG, N2_TRAIN, N2_TRAIN_ROWS, SEED, SR, TRAIN_FRAMES,
    TRAIN_ROWS, VOCAB, draw_routers, gate_trainer, make_cmvn, synth_audio, train_batches)
from hnet_mamba_asr_torch.tools.measure import BWD_SHAPES, EMA_SHAPES

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
# SSD backward: the kernel's gradients against autograd of ssd_chunked at
# the kernel's chunk, per tensor, as max|d| / max|g_plain| and mean|d| /
# mean|g_plain|. fp32: summation order only. bf16 inputs or intra_dtype bf16:
# autograd of the plain version rounds each gradient where the forward casts
# (W, the weighted B, S before the chunk, the intra scores, decays and dt) and
# the kernel keeps them in fp32. Readings at BWD_SHAPES (four runs, H100,
# equal in each: the inputs are seeded and neither side uses atomics): dx,
# ddt, dB, dC <= 6.2e-3 of the max and 3.1e-3 of the mean. dA is H numbers,
# each a sum of B x L terms of both signs, so it keeps more of each term's
# rounding: <= 1.55e-2 (bf16, intra bf16, H 12) and 7.1e-3 of the mean; in
# fp32 <= 1.9e-5.
GRAD_BOUND = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_MEAN_BOUND = {"float32": 1e-5, "bfloat16": 1e-2}
DA_BOUND = {"float32": 1e-3, "bfloat16": 4e-2}
GRAD_NAMES = ("x", "dt", "A", "B", "C", "initial_state")
# B, L, H of the training step; the backward's shapes add L 873 and B 1
TRAIN_SHAPES = BWD_SHAPES[:2]
FWD_SHAPES = tuple((Bsz, L, H) for Bsz in (8, 1) for L in (248, 873, 1000)
                   for H in (12, 16)) + TRAIN_SHAPES
# one micro-step on the card against the CPU, fp32, TF32 off, per parameter:
# max|d| to 1e-3 of the leaf's max and mean|d| to 1e-3 of its mean|g|.
# cuFFT, cuDNN, cuBLAS, the SSD kernels and CTC's atomics sum in other orders
# than the CPU: 273 of the 275 leaves parted by <= 1.05e-4 of their max (four
# runs, H100). The first conv's weight and bias gradients are sums over ~4e4
# positions with heavy cancellation and parted by 3.55e-3 and 2.26e-3 of
# their max (the same four runs); they have a bound of their own.
PARAM_GRAD_BOUND = 1e-3
PARAM_GRAD_MEAN_BOUND = 1e-3
CONV1_GRAD_BOUND = 1e-2
CONV1_LEAVES = ("encoder.subsample.conv1.weight", "encoder.subsample.conv1.bias")
# the EMA kernel against fp32 references on the same values, as max|d| /
# max|ref| (tests/test_torch_cuda.py): the plain recurrence in the kernel's
# order 1e-5 in fp32; the plain matmul form, whose weights difference two
# cumsums of M logs (|S| up to ~6e2 at M 880), 1e-3; bf16, where the kernel
# rounds zbar and dz once and reads zbar_{t-1} in bf16, 1e-2. Against the
# plain form run on the same bf16 inputs (it rounds its weights to bf16,
# the kernel does not) the forward's gap is 1e-2 too.
EMA_SEQ_BOUND = {"float32": 1e-5, "bfloat16": 1e-2}
EMA_BOUND = {"float32": 1e-3, "bfloat16": 1e-2}
# the H-Net models on the card against the CPU, fp32, TF32 off, depth
# 1 + 2 + 1: the boundaries exactly, then features as max|d| / max|f| on
# valid frames, and log-probs as in phase 3
FEATURE_BOUND = 1e-3
N2_SSD_CALLS = 40               # Type A N=2: 20 blocks x 2 directions per forward
# (label, encoder_conf changes, EMA stages, bidirectional blocks) of the
# card-vs-CPU H-Net models at depth 1 + 2 + 1
HNET_VARIANTS = (
    ("Type A N=2", {}, 1, 4),
    ("Type B N=4", {"arch_type": "B", "n_mid": 1,
                    "hnet": {"compression_N": 4, "chunker": "dynamic", "ema_smoothing": True}},
     2, 6),
    ("fixed N=2", {"hnet": {"compression_N": 2, "chunker": "fixed", "ema_smoothing": True}},
     0, 4))


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_build():
    from hnet_mamba_asr_torch.ops import cuda_build, ema_cuda, ssd_cuda
    t0 = time.perf_counter()
    info = ssd_cuda.build()
    ema_cuda.build()
    seconds = time.perf_counter() - t0
    for line in info["log"].splitlines():
        if line.endswith(".cu:") or "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    paths = cuda_build.build_all()["paths"]
    log(f"phase 1 build: ok, {', '.join(src.name for src, _ in cuda_build.SOURCES.values())} "
        f"built in {seconds:.2f} s -> {', '.join(str(p) for p in paths.values())}")
    return seconds


def phase_kernel():
    from hnet_mamba_asr_torch.ops.ssd import ssd_chunked
    from hnet_mamba_asr_torch.ops.ssd_cuda import build, ssd_cuda
    from hnet_mamba_asr_torch.tools.measure import cuda_ms, kernel_ms, ssd_cost, ssd_inputs
    lib = build()["lib"]
    rows = []
    for dtype, intra in ((torch.bfloat16, "bf16"), (torch.float32, None)):
        name = str(dtype).removeprefix("torch.")
        for Bsz, L, H in FWD_SHAPES:
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


def phase_backward():
    """The backward kernel's gradients against autograd of ssd_chunked on the
    same inputs and dy, through ssd_cuda (SSDScan), and the kernel's time
    alone (the forward's chunk states kept once) against the plain
    backward's (autograd of ssd_chunked over a kept graph)."""
    from hnet_mamba_asr_torch.ops import ssd_cuda as mod
    from hnet_mamba_asr_torch.ops.ssd import ssd_chunked
    from hnet_mamba_asr_torch.tools.measure import cuda_ms, kernel_ms, ssd_bwd_cost, ssd_inputs
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for intra in ("bf16", None):
            kind = "bfloat16" if dtype == torch.bfloat16 or intra else "float32"
            for Bsz, L, H in BWD_SHAPES:
                args = ssd_inputs(Bsz, L, H, dtype, seed=SEED + 5)
                gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
                dy = torch.randn(args[0].shape, generator=gen, device="cuda").to(dtype)
                leaves = [t.clone().requires_grad_() for t in args]
                before = mod.ssd_cuda.bwd_launches
                got = torch.autograd.grad(mod.ssd_cuda(*leaves, intra_dtype=intra), leaves, dy)
                torch.cuda.synchronize()
                if mod.ssd_cuda.bwd_launches != before + 1:
                    raise AssertionError("the gradient through ssd_cuda did not launch the "
                                         "backward kernel once")
                plain = [t.clone().requires_grad_() for t in args]
                y_plain = ssd_chunked(*plain, chunk_size=KERNEL_CHUNK, intra_dtype=intra)
                want = torch.autograd.grad(y_plain, plain, dy, retain_graph=True)
                errs, abs_err = check_grads(got, want, args, kind,
                                            f"{name}, intra {intra}, B {Bsz}, L {L}, H {H}")
                bf = intra == "bf16"
                _, _, states = mod._forward(*args, None, False, bf, keep_states=True)
                run = lambda: mod._backward(*args, states, dy, None, bf, False)
                one, two = run(), run()
                if not all(torch.equal(a, b) for a, b in zip(one, two) if a is not None):
                    raise AssertionError(f"two backward calls on the same inputs differ "
                                         f"({name}, intra {intra}, B {Bsz}, L {L}, H {H})")
                del one, two
                call_ms = cuda_ms(run)
                ms = kernel_ms(run, "ssd_bwd") or call_ms
                plain_ms = cuda_ms(lambda: torch.autograd.grad(y_plain, plain, dy,
                                                               retain_graph=True))
                cost = ssd_bwd_cost(Bsz, L, H, 1, 64, 128, name)
                log(f"  ssd_bwd {name} intra {intra} B{Bsz} L{L} H{H}: max|d|/max|g| / "
                    f"mean|d|/mean|g| {', '.join(errs)} (bounds {GRAD_BOUND[kind]:g} / "
                    f"{GRAD_MEAN_BOUND[kind]:g}, dA {DA_BOUND[kind]:g}); kernel {ms:.4f} ms "
                    f"(call {call_ms:.4f} ms) plain backward {plain_ms:.4f} ms; bound "
                    f"{cost['bound_ms'] * 1e3:.2f} us ({cost['bound_by']}: bytes "
                    f"{cost['bytes_us']:.2f} us, ops {cost['ops_us']:.2f} us), share "
                    f"{cost['bound_ms'] / ms:.2%}; {bwd_grid(mod, dtype, Bsz, L, H)}")
                rows.append(dict(dtype=name, intra=intra, B=Bsz, H=H, L=L, abs_err=abs_err,
                                 ms=ms, call_ms=call_ms, plain_ms=plain_ms, **cost))
                del got, want, y_plain, states
    log("  ssd_bwd: two calls on the same inputs gave bitwise-equal gradients at every shape")
    # the state in and out: L 1100 is K 18 chunks, three rounds of the
    # reverse chain's cluster, D carried between them
    Bsz, L, H = 2, 1100, 16
    args = ssd_inputs(Bsz, L, H, torch.bfloat16, seed=SEED + 7)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    s0 = torch.randn(Bsz, H, 128, 64, generator=gen, device="cuda")
    w = torch.randn(args[0].shape, generator=gen, device="cuda")
    w_final = torch.randn(s0.shape, generator=gen, device="cuda")

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (*args, s0)]
        y, s = fn(*leaves)
        return torch.autograd.grad((y.float() * w).sum() + (s * w_final).sum(), leaves)

    got = grads(lambda *a: mod.ssd_cuda(*a[:5], initial_state=a[5], return_final=True,
                                        intra_dtype="bf16"))
    want = grads(lambda *a: ssd_chunked(*a[:5], chunk_size=KERNEL_CHUNK, initial_state=a[5],
                                        return_final=True, intra_dtype="bf16"))
    errs, _ = check_grads(got, want, (*args, s0), "bfloat16",
                          f"bfloat16, intra bf16, B {Bsz}, L {L}, H {H}, state in and out")
    log(f"  ssd_bwd bfloat16 intra bf16 B{Bsz} L{L} H{H} initial_state/return_final: "
        f"max|d|/max|g| / mean|d|/mean|g| {', '.join(errs)}")
    log("phase 2 backward: ok")
    return rows


def phase_ema():
    """The EMA kernels through ema_cuda (EMASmooth) against the plain
    recurrence and the plain matmul form, in fp32 on the same values; the
    forward against the plain form on the same inputs too; zero dP at
    saturated slots; two calls bitwise equal; the kernels' device times
    (each alone: the backward from a kept output) against the plain ones."""
    from hnet_mamba_asr_torch.ops import ema_cuda as mod
    from hnet_mamba_asr_torch.ops.ema import ema_smooth, ema_smooth_sequential
    from hnet_mamba_asr_torch.tools.measure import (
        cuda_ms, ema_bwd_cost, ema_cost, ema_inputs, kernel_ms)
    cases = [(dtype, shape, False) for dtype in (torch.bfloat16, torch.float32)
             for shape in EMA_SHAPES]
    cases += [(dtype, (64, 256, 384), True) for dtype in (torch.bfloat16, torch.float32)]
    cases += [(dtype, (4, 1, 384), False) for dtype in (torch.bfloat16, torch.float32)]
    rows = []
    for dtype, (Bsz, M, D), saturate in cases:
        name = str(dtype).removeprefix("torch.")
        what = f"{name} B{Bsz} M{M} D{D}{' saturated' if saturate else ''}"
        z, p = ema_inputs(Bsz, M, D, dtype, seed=SEED + 30, saturate=saturate)
        g = torch.randn(z.shape, generator=torch.Generator().manual_seed(SEED + 31)
                        ).to("cuda", dtype)
        zl, pl = z.clone().requires_grad_(), p.clone().requires_grad_()
        before = (mod.ema_cuda.launches, mod.ema_cuda.bwd_launches)
        out = mod.ema_cuda(zl, pl)
        dz, dp = torch.autograd.grad(out, (zl, pl), g)
        torch.cuda.synchronize()
        if (mod.ema_cuda.launches, mod.ema_cuda.bwd_launches) != (before[0] + 1, before[1] + 1):
            raise AssertionError(f"ema_cuda did not launch each kernel once ({what})")
        got = (out, dz, dp)
        errs, abs_err = [], {"fwd": 0.0, "bwd": 0.0}
        for fn, bounds in ((ema_smooth_sequential, EMA_SEQ_BOUND), (ema_smooth, EMA_BOUND)):
            zf, pf = z.float().requires_grad_(), p.clone().requires_grad_()
            ref = fn(zf, pf)
            rz, rp = torch.autograd.grad(ref, (zf, pf), g.float(), allow_unused=True)
            refs = (ref.detach(), rz, torch.zeros_like(p) if rp is None else rp)
            for key, a, b in zip(("zbar", "dz", "dP"), got, refs):
                d = (a.float() - b).abs().max().item()
                rel = d / max(b.abs().max().item(), 1e-30)
                errs.append(f"{key} {rel:.2e}")
                if fn is ema_smooth:
                    part = "fwd" if key == "zbar" else "bwd"
                    abs_err[part] = max(abs_err[part], d)
                if not (torch.isfinite(a).all() and rel <= bounds[name]):
                    raise AssertionError(f"ema kernel disagrees with {fn.__name__}: {key} "
                                         f"{rel:.3e} (bound {bounds[name]:g}; {what})")
        same = ema_smooth(z, p).float()
        gap = ((out.float() - same).abs().max() / same.abs().max()).item()
        if not gap <= EMA_BOUND["bfloat16"]:
            raise AssertionError(f"ema kernel vs the plain form on the same inputs: "
                                 f"{gap:.3e} ({what})")
        if dp[:, 0].any() or (saturate and (dp[:, ::10].any() or dp[:, 5::10].any())):
            raise AssertionError(f"dP is not zero at slot 0 or a saturated slot ({what})")
        zbar = mod._forward(z, p, 1e-4)
        fwd = lambda: mod._forward(z, p, 1e-4)
        bwd = lambda: mod._backward(z, p, zbar, g, 1e-4)
        one, two = (fwd(), *bwd()), (fwd(), *bwd())
        if not all(torch.equal(a, b) for a, b in zip(one, two)):
            raise AssertionError(f"two ema calls on the same inputs differ ({what})")
        ms = {"fwd": kernel_ms(fwd, "ema_fwd") or cuda_ms(fwd),
              "bwd": kernel_ms(bwd, "ema_bwd") or cuda_ms(bwd)}
        zl2, pl2 = z.clone().requires_grad_(), p.clone().requires_grad_()
        y_plain = ema_smooth(zl2, pl2)
        plain = {"fwd": cuda_ms(lambda: ema_smooth(z, p)),
                 "bwd": cuda_ms(lambda: torch.autograd.grad(y_plain, (zl2, pl2), g, retain_graph=True,
                                                            allow_unused=True))}
        cost = {"fwd": ema_cost(Bsz, M, D, name), "bwd": ema_bwd_cost(Bsz, M, D, name)}
        log(f"  ema {what}: max|d|/max|ref| vs recurrence, vs matmul form "
            f"{', '.join(errs)}; vs the plain form on the same inputs {gap:.2e}; "
            + "; ".join(f"{k} kernel {ms[k]:.4f} ms plain {plain[k]:.4f} ms bound "
                        f"{cost[k]['bound_ms'] * 1e3:.2f} us ({cost[k]['bound_by']}) share "
                        f"{cost[k]['bound_ms'] / ms[k]:.2%}" for k in ("fwd", "bwd")))
        rows.append(dict(dtype=name, B=Bsz, M=M, D=D, saturate=saturate, ms=ms, plain=plain,
                         cost=cost, abs_err=abs_err, gap=gap))
    log("  ema: two calls on the same inputs gave bitwise-equal outputs and gradients")
    log("phase 2 ema: ok")
    return rows


def bwd_grid(mod, dtype, Bsz: int, L: int, H: int) -> str:
    """The backward's launches at this shape (G 1)."""
    if dtype == torch.float32:
        return f"{Bsz * H} blocks"
    K = -(-L // KERNEL_CHUNK)
    splits = mod.build()["bwd"].hnet_ssd_bwd_bf16_splits(Bsz, L, H, 1)
    return (f"chain {Bsz * H * min(K, 8)} CTAs in clusters of {min(K, 8)}, chunk terms "
            f"{Bsz * K * splits} CTAs ({splits} per group)")


def check_grads(got, want, args, kind: str, what: str):
    """Each gradient against autograd's, in its input's dtype and shape,
    finite, within GRAD_BOUND / GRAD_MEAN_BOUND (dA: DA_BOUND); returns the
    readings and the largest absolute difference."""
    errs, abs_err = [], 0.0
    for gname, a, b, t in zip(GRAD_NAMES, got, want, args):
        if a.dtype != t.dtype or a.shape != t.shape or not torch.isfinite(a).all():
            raise AssertionError(f"d{gname}: {a.dtype} {tuple(a.shape)} or not finite ({what})")
        d = (a.float() - b.float()).abs()
        rel = (d.max() / b.float().abs().max()).item()
        mean = (d.mean() / b.float().abs().mean()).item()
        bound, mean_bound = ((DA_BOUND[kind],) * 2 if gname == "A" else
                             (GRAD_BOUND[kind], GRAD_MEAN_BOUND[kind]))
        errs.append(f"d{gname} {rel:.2e}/{mean:.2e}")
        abs_err = max(abs_err, d.max().item())
        if not (rel <= bound and mean <= mean_bound):
            raise AssertionError(
                f"ssd backward kernel disagrees with autograd of ssd_chunked: d{gname} "
                f"{rel:.3e} (bound {bound:g}), mean {mean:.3e} (bound {mean_bound:g}) ({what})")
    return errs, abs_err


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


def check_boundaries(got, want, what: str) -> None:
    """Hard boundaries, compared first and exactly: a frame whose p rounds
    the other way moves every later frame's slot. On a mismatch, name how
    many frames sit within 1e-4 of 0.5."""
    for stage, ((p, b), (_, b_ref)) in enumerate(zip(got, want)):
        if not torch.equal(b.cpu(), b_ref.cpu()):
            near = int(((p.cpu() - 0.5).abs() < 1e-4).sum())
            raise AssertionError(f"{what}: stage {stage + 1} boundaries differ on "
                                 f"{int((b.cpu() != b_ref.cpu()).sum())} frames; {near} frames "
                                 f"have |p - 0.5| < 1e-4")


def phase_hnet_model(cmvn):
    """Type A N=2, Type B N=4 and the fixed-pool chunker at N=2 on the card
    (kernel path) against the CPU (plain path), fp32, TF32 off, full width,
    depth 1 + 2 + 1 (Type B: n_mid 1), 4 utterances of 2-16 s, the routers
    drawn at random (``draw_routers``: about half the frames kept):
    boundaries equal, then features and log-probs; the kernels' launches
    per forward."""
    from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED + 20)
    seconds = rng.uniform(2.0, 16.0, size=4)
    waves = [synth_audio(rng, float(t)) for t in seconds]
    lens = np.array([len(w) for w in waves])
    wave = np.zeros((len(waves), lens.max()), np.float32)
    for i, w in enumerate(waves):
        wave[i, :len(w)] = w
    for label, change, ema_stages, blocks in HNET_VARIANTS:
        cfg = copy.deepcopy(N2_CONFIG)
        cfg["train"]["precision"] = "fp32"
        cfg["encoder_conf"].update(n_enc=1, n_main=2, n_dec=1, **copy.deepcopy(change))
        out = {}
        for device in ("cuda", "cpu"):
            model = build_model(cfg, VOCAB, cmvn=cmvn, seed=SEED, device=device)
            draw_routers(model, SEED + 21)
            batch = {"wave": torch.from_numpy(wave).to(device),
                     "wave_lens": torch.from_numpy(lens).to(device)}
            launches = (ssd_cuda.launches, ema_cuda.launches)
            with torch.no_grad():
                enc = model.encode(batch)
                logp = model.ctc.log_probs(enc.features)
            if device == "cuda":
                torch.cuda.synchronize()
                got = (ssd_cuda.launches - launches[0], ema_cuda.launches - launches[1])
                if got != (2 * blocks, ema_stages):
                    raise AssertionError(f"{label}: launches (ssd, ema) {got}, want "
                                         f"{(2 * blocks, ema_stages)}")
            out[device] = (enc, logp.cpu())
            del model
        (ek, lk), (ep, lp) = out["cuda"], out["cpu"]
        check_boundaries(ek.boundaries, ep.boundaries, f"{label}, card vs CPU")
        n = ep.lengths.numpy()
        if not np.array_equal(ek.lengths.cpu().numpy(), n):
            raise AssertionError(f"{label}: encoder lengths differ")
        fk, fp = ek.features.cpu(), ep.features
        feat = max(((fk[i, :c] - fp[i, :c]).abs().max() / fp[i, :c].abs().max()).item()
                   for i, c in enumerate(n))
        worst = max((lk[i, :c] - lp[i, :c]).abs().max().item() for i, c in enumerate(n))
        log(f"  {label} fp32 (TF32 off), depth 1+2+1, {len(n)} rows of "
            f"{np.round(seconds, 2).tolist()} s -> {n.tolist()} frames: boundaries equal; kept "
            f"{[round(k.item(), 4) for k in ek.kept_fractions]}, slots "
            f"{[z.shape[1] for z in ek.chunk_embeddings]}; max|d feature|/max|f| {feat:.3e} "
            f"(bound {FEATURE_BOUND:g}), max|d log_prob| {worst:.3e} (bound {LOGPROB_BOUND:g}); "
            f"ssd {2 * blocks} and ema {ema_stages} launches per forward")
        if not (feat <= FEATURE_BOUND and worst <= LOGPROB_BOUND):
            raise AssertionError(f"{label}: the card disagrees with the CPU: features "
                                 f"{feat:.3e}, log-probs {worst:.3e}")
    torch.cuda.empty_cache()
    log("phase 3 hnet: ok")


def phase_serve(cmvn, config=GATE_CONFIG, label="gate", ema_per_call=0):
    """9 requests (8 of 2-16 s and one of 35 s over HTTP) through the
    micro-batcher in bf16; the first alone == batched; SSD_CALLS_PER_FORWARD
    SSD and ``ema_per_call`` EMA launches per model call. At N > 1 the
    routers are drawn at random (``draw_routers``), so that requests are
    chunked and a request alone gets another buffer size than in a batch."""
    from hnet_mamba_asr_torch.models.encoder import subsampled_length
    from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda
    from hnet_mamba_asr_torch.ops.melspec import frame_count
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.serving.runtime import ServingModel, collapse_ctc
    from hnet_mamba_asr_torch.serving.server import make_server
    model = ServingModel(config, None, "cuda", vocab_size=VOCAB, cmvn=cmvn,
                         seed=SEED, max_batch=8, max_samples=40 * SR)
    if ema_per_call:
        draw_routers(model.model, SEED + 22)
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
        ssd_cuda.launches = ema_cuda.launches = 0
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
        launches, ema_launches, calls = ssd_cuda.launches, ema_cuda.launches, model.calls

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
    if calls < 2 or launches != SSD_CALLS_PER_FORWARD * calls \
            or ema_launches != ema_per_call * calls:
        raise AssertionError(f"kernel launches: ssd {launches}, ema {ema_launches} over "
                             f"{calls} model calls; want {SSD_CALLS_PER_FORWARD} and "
                             f"{ema_per_call} per call")
    if health.get("status") != "ok":
        raise AssertionError(f"health: {health}")
    log(f"  {label}: served {len(results)} requests ({stats['batches']} batches, mean "
        f"occupancy {stats['mean_batch_occupancy']:.2f}) + 1 solo in {wall:.3f} s; latency "
        f"p50 {stats['latency_ms_p50']:.1f} ms p95 {stats['latency_ms_p95']:.1f} ms; "
        f"solo == batched; ssd launches {launches} = {SSD_CALLS_PER_FORWARD} x {calls} calls, "
        f"ema {ema_launches} = {ema_per_call} x {calls}")
    log(f"phase 4 serve {label}: ok")
    return launches


def phase_train(cmvn, tmp: Path) -> dict:
    """The gate config through Trainer: 3 updates of accum_grad 2 x (32 x
    10 s), hybrid, bf16, SpecAugment, AED dropout, remat none; then one
    micro-step with each remat policy."""
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    accum = GATE_TRAIN["accum_grad"]
    batches = train_batches(np.random.default_rng(SEED + 10), 3 * accum, TRAIN_ROWS)
    trainer = gate_trainer(GATE_CONFIG, batches, GATE_TRAIN, cmvn, tmp / "train", max_steps=3)
    torch.cuda.reset_peak_memory_stats()
    ssd_cuda.launches = ssd_cuda.bwd_launches = 0
    trainer.train()
    torch.cuda.synchronize()
    fwd, bwd = ssd_cuda.launches, ssd_cuda.bwd_launches
    peak = torch.cuda.max_memory_allocated()
    micro = accum * len(trainer.history)
    for r in trainer.history:
        log(f"  step {r['step']}: loss {r['loss/total']:.4f} (ctc {r['loss/ctc']:.4f}, aed "
            f"{r['loss/aed']:.4f}) grad norm {r['grad_norm']:.6g} lr {r['lr']:.3e} kept "
            f"{r['kept_fraction']:.3f} infeasible {r['ctc_infeasible']:.0f}; {r['ms']:.1f} ms "
            f"(CUDA events), {r['frames']} mel frames")
        if not (math.isfinite(r["loss/total"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"step {r['step']}: loss or gradient not finite: {r}")
    if len(trainer.history) != 3 or micro != len(batches):
        raise AssertionError(f"{len(trainer.history)} updates of {micro} micro-steps, want 3 "
                             f"of {len(batches)}")
    timed = trainer.history[1:]                      # after one warm-up step
    step_ms = float(np.mean([r["ms"] for r in timed]))
    fps = float(np.mean([r["frames"] for r in timed])) / step_ms * 1e3
    log(f"  train: {step_ms:.1f} ms per update of {accum} x ({TRAIN_ROWS} x 10 s) after one "
        f"warm-up update, {fps:.0f} mel-frames/s; max_memory_allocated {peak / 1e9:.2f} GB; "
        f"ssd launches per micro-step: forward {fwd / micro:g}, backward {bwd / micro:g}")
    if fwd != SSD_CALLS_PER_FORWARD * micro or bwd != SSD_CALLS_PER_FORWARD * micro:
        raise AssertionError(f"ssd launches {fwd} forward, {bwd} backward over {micro} "
                             f"micro-steps; want {SSD_CALLS_PER_FORWARD} each per micro-step")
    batch = trainer._to_device(batches[0])
    del trainer
    remat_micro_steps(cmvn, batch)
    torch.cuda.empty_cache()
    log("phase 5 train: ok")
    return {"ssd_fwd": fwd, "ssd_bwd": bwd, "step_ms": step_ms, "fps": fps, "peak": peak}


# a remat policy only moves where the forward is computed: the same kernels
# on the same inputs give the same loss; the gradients' global norm parts
# only by CTC's atomics (CUDA's CTC backward), whose order flips bf16
# roundings downstream
REMAT_LOSS_BOUND = 1e-6
REMAT_NORM_BOUND = 1e-3


def remat_micro_steps(cmvn, batch) -> None:
    """One micro-step of the gate config (train mode, step 0) on ``batch``
    per remat policy, each from the seeded weights: ``full`` and ``dots``
    give remat ``none``'s loss and gradient norm, and run each block's two
    scans again in its backward (80 forward and 40 backward launches)."""
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    out = {}
    for policy in ("none", "full", "dots"):
        cfg = copy.deepcopy(GATE_CONFIG)
        cfg["encoder_conf"]["remat_policy"] = policy
        model = build_model(cfg, VOCAB, cmvn=cmvn, seed=SEED).train()
        torch.cuda.synchronize()
        ssd_cuda.launches = ssd_cuda.bwd_launches = 0
        loss, _ = model.loss_fn(batch, 0, True)
        loss.backward()
        torch.cuda.synchronize()
        launches = (ssd_cuda.launches, ssd_cuda.bwd_launches)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad.float()) for p in model.parameters()])).item()
        out[policy] = {"loss": loss.item(), "grad_norm": norm, "launches": launches}
        del model, loss
        ref = out["none"]
        d_loss = abs(out[policy]["loss"] - ref["loss"]) / abs(ref["loss"])
        d_norm = abs(norm - ref["grad_norm"]) / ref["grad_norm"]
        log(f"  remat {policy}, one micro-step: loss {out[policy]['loss']:.6f} grad norm "
            f"{norm:.6g} (vs none: {d_loss:.2e} / {d_norm:.2e}, bounds {REMAT_LOSS_BOUND:g} / "
            f"{REMAT_NORM_BOUND:g}); ssd launches forward {launches[0]}, backward "
            f"{launches[1]}")
        want = (SSD_CALLS_PER_FORWARD * (1 if policy == "none" else 2), SSD_CALLS_PER_FORWARD)
        if launches != want:
            raise AssertionError(f"remat {policy}: ssd launches {launches}, want {want}")
        if not (math.isfinite(norm) and d_loss <= REMAT_LOSS_BOUND
                and d_norm <= REMAT_NORM_BOUND):
            raise AssertionError(f"remat {policy} changes the micro-step: {out[policy]} vs "
                                 f"none {ref}")


def phase_train_n2(cmvn, tmp: Path) -> dict:
    """configs/typeA_small_N2.yaml through Trainer: 3 updates of one
    micro-batch of 64 x 10 s (its batch_bins, accum_grad 1), hybrid, bf16,
    SpecAugment, AED dropout, remat full, the damped router group. Every
    kernel's count is set to 0 just before and read just after: the launches
    of this slice's main path."""
    from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    batches = train_batches(np.random.default_rng(SEED + 14), 3, N2_TRAIN_ROWS)
    trainer = gate_trainer(N2_CONFIG, batches, N2_TRAIN, cmvn, tmp / "train_n2", max_steps=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_cuda.launches = ssd_cuda.bwd_launches = ema_cuda.launches = ema_cuda.bwd_launches = 0
    trainer.train()
    torch.cuda.synchronize()
    launches = {"ssd_fwd": ssd_cuda.launches, "ssd_bwd": ssd_cuda.bwd_launches,
                "ema_fwd": ema_cuda.launches, "ema_bwd": ema_cuda.bwd_launches}
    peak = torch.cuda.max_memory_allocated()
    for r in trainer.history:
        log(f"  n2 step {r['step']}: loss {r['loss/total']:.4f} (ctc {r['loss/ctc']:.4f}, aed "
            f"{r['loss/aed']:.4f}, ratio {r['loss/ratio']:.4f}) grad norm {r['grad_norm']:.6g} "
            f"lr {r['lr']:.3e} kept_fraction {r['kept_fraction']:.4f}; {r['ms']:.1f} ms "
            f"(CUDA events), {r['frames']} mel frames")
        if not (math.isfinite(r["loss/total"]) and math.isfinite(r["grad_norm"])
                and r["loss/ratio"] > 0 and 0 < r["kept_fraction"] < 1):
            raise AssertionError(f"n2 step {r['step']}: {r}")
    if len(trainer.history) != 3:
        raise AssertionError(f"{len(trainer.history)} N=2 updates, want 3")
    router = [g for g in trainer.opt.param_groups if g.get("label") == "router"]
    last_lr = trainer.lr_schedule(trainer.global_step - 1)
    if not (len(router) == 1 and len(router[0]["params"]) == 2
            and router[0]["lr"] == 0.5 * last_lr and router[0]["eps"] == 1e-5):
        raise AssertionError(f"the router group is not damped as the config says: {router}")
    with torch.no_grad():
        enc = trainer.model.encode(trainer._to_device(batches[0]))
    slots, kept = enc.chunk_embeddings[0].shape[1], enc.kept_fractions[0].item()
    timed = trainer.history[1:]
    step_ms = float(np.mean([r["ms"] for r in timed]))
    fps = float(np.mean([r["frames"] for r in timed])) / step_ms * 1e3
    micro = len(trainer.history)
    want = {"ssd_fwd": 2 * N2_SSD_CALLS * micro, "ssd_bwd": N2_SSD_CALLS * micro,
            "ema_fwd": micro, "ema_bwd": micro}
    log(f"  train n2: {step_ms:.1f} ms per update of {N2_TRAIN_ROWS} x 10 s after one warm-up "
        f"update, {fps:.0f} mel-frames/s; max_memory_allocated {peak / 1e9:.2f} GB; router "
        f"group lr {router[0]['lr']:.4e} = 0.5 x {last_lr:.4e}, eps {router[0]['eps']:g}; "
        f"at the first batch after training: kept fraction {kept:.4f}, {slots} slots of the "
        f"compressed buffer for L {enc.features.shape[1]}; launches per micro-step "
        + ", ".join(f"{k} {v / micro:g}" for k, v in launches.items()))
    if launches != want:
        raise AssertionError(f"N=2 launches {launches}, want {want}")
    del trainer
    torch.cuda.empty_cache()
    log("phase 5 train n2: ok")
    return {"launches": launches, "step_ms": step_ms, "fps": fps, "peak": peak,
            "slots": slots, "kept": kept}


# bench.py's optimizer (optax.adamw(1e-3) after clip_by_global_norm(5.0)),
# constant lr; weight decay 1e-4 (optax's default) on >= 2-D leaves
BENCH_TRAIN = {"optim": "adamw", "optim_conf": {"lr": 1e-3, "weight_decay": 1e-4},
               "scheduler": None, "grad_clip": 5.0, "accum_grad": 1, "max_epoch": 1}


def phase_descent(cmvn, tmp: Path) -> None:
    """5 updates on one fixed batch of 8 x 10 s: the loss falls (the
    config's warmuplr starts at ~3e-8 and could not show it)."""
    batch = train_batches(np.random.default_rng(SEED + 11), 1, 8)[0]
    trainer = gate_trainer(GATE_CONFIG, [batch] * 5, BENCH_TRAIN, cmvn, tmp / "descent",
                           max_steps=5)
    trainer.train()
    losses = [r["loss/total"] for r in trainer.history]
    log(f"  fixed batch of 8 x 10 s, lr 1e-3 constant: losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}")
    if len(losses) != 5 or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall over 5 steps: {losses}")
    del trainer
    torch.cuda.empty_cache()
    log("phase 6 descent: ok")


def phase_grads(cmvn, config=GATE_CONFIG, label="gate") -> float:
    """One fp32 micro-step (hybrid loss, eval mode) at full width and depth
    1 + 2 + 1, intra_dtype off, on the card (kernels) and on the CPU (plain
    path): every parameter's gradient agrees (at N > 1 after the
    boundaries, compared first, with the routers drawn at random:
    ``draw_routers``)."""
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.training.trainer import DEVICE_KEYS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = copy.deepcopy(config)
    cfg["encoder_conf"].update(n_enc=1, n_main=2, n_dec=1, ssd_intra_dtype=None)
    cfg["train"]["precision"] = "fp32"
    batch = train_batches(np.random.default_rng(SEED + 12), 1, 2)[0]
    out = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, VOCAB, cmvn=cmvn, seed=SEED, device=device).train()
        draw_routers(model, SEED + 23)
        b = dict(batch, **{k: torch.as_tensor(batch[k]).to(device) for k in DEVICE_KEYS})
        with torch.no_grad():
            bounds = model.encode(b).boundaries
        loss, _ = model.loss_fn(b, 0, False)
        loss.backward()
        out[device] = (loss.item(), {n: p.grad.detach().cpu()
                                     for n, p in model.named_parameters()}, bounds)
        del model, loss
    (loss_k, gk, bk), (loss_p, gp, bp) = out["cuda"], out["cpu"]
    check_boundaries(bk, bp, f"{label} gradients, card vs CPU")
    rows = []
    for name, g in gp.items():
        if not torch.isfinite(gk[name]).all():
            raise AssertionError(f"{name}: card gradient not finite")
        d = (gk[name] - g).abs()
        bound = CONV1_GRAD_BOUND if name in CONV1_LEAVES else PARAM_GRAD_BOUND
        rows.append(((d.max() / g.abs().max().clamp(min=1e-30)).item(),
                     (d.mean() / g.abs().mean().clamp(min=1e-30)).item(), name, bound))
    rows.sort(reverse=True)
    worst_mean = max(r[1] for r in rows)
    log(f"  {label} fp32 depth 1+2+1, 2 x 10 s, hybrid: loss card {loss_k:.6f} cpu "
        f"{loss_p:.6f}; "
        f"{len(gp)} parameter gradients, max|d|/max|g| worst "
        + ", ".join(f"{r[0]:.2e} ({r[2]}, bound {r[3]:g})" for r in rows[:4])
        + f"; mean|d|/mean|g| worst {worst_mean:.2e} (bound {PARAM_GRAD_MEAN_BOUND:g})"
        + "".join(f"; {r[2]} {r[0]:.2e}" for r in rows if ".router." in r[2]))
    over = [r for r in rows if not r[0] <= r[3]]
    if over or not (worst_mean <= PARAM_GRAD_MEAN_BOUND
                    and abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)):
        raise AssertionError(f"card and CPU gradients disagree: {over or rows[:3]}")
    torch.cuda.empty_cache()
    log(f"phase 7 grads {label}: ok")


def phase_bench(tmp: Path) -> dict:
    """bench.py's gate-cell step: CTC only, no SpecAugment, clip 5 + AdamW
    1e-3, 32 x 10 s with remat none (intra bf16) and 64 x 10 s with remat
    full; mel-frames/s over 3 updates after 2 warm-ups (CUDA events)."""
    out = {}
    for rows, policy, intra in ((32, "none", "bf16"), (64, "full", None)):
        cfg = copy.deepcopy(GATE_CONFIG)
        cfg.pop("specaug_conf")
        cfg["model_conf"] = {"ctc_weight": 1.0, "aed_weight": 0.0}
        cfg["encoder_conf"].update(remat_policy=policy, ssd_intra_dtype=intra)
        batch = train_batches(np.random.default_rng(SEED + 13), 1, rows)[0]
        torch.cuda.reset_peak_memory_stats()
        trainer = gate_trainer(cfg, [batch] * 5, BENCH_TRAIN, None, tmp / f"bench{rows}",
                               max_steps=5)
        trainer.train()
        ms = float(np.mean([r["ms"] for r in trainer.history[2:]]))
        fps = rows * TRAIN_FRAMES / ms * 1e3
        peak = torch.cuda.max_memory_allocated()
        log(f"  bench step {rows} x 10 s ({rows * TRAIN_FRAMES} frames), remat {policy}, intra "
            f"{intra}: {ms:.1f} ms, {fps:.0f} mel-frames/s, max_memory_allocated "
            f"{peak / 1e9:.2f} GB; losses {[round(r['loss/total'], 4) for r in trainer.history]}")
        if not all(math.isfinite(r["loss/total"]) for r in trainer.history):
            raise AssertionError("bench step: loss not finite")
        out[policy] = {"rows": rows, "ms": ms, "fps": fps}
        del trainer
        torch.cuda.empty_cache()
    log("phase 8 bench: ok")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t_start = time.perf_counter()
    phase_build()
    fwd_rows = phase_kernel()
    bwd_rows = phase_backward()
    ema_rows = phase_ema()
    cmvn = make_cmvn("cuda")
    phase_model(cmvn)
    phase_hnet_model(cmvn)
    phase_serve(cmvn)
    phase_serve(cmvn, N2_CONFIG, "n2", ema_per_call=1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        train = phase_train(cmvn, Path(tmp))
        train_n2 = phase_train_n2(cmvn, Path(tmp))
        phase_descent(cmvn, Path(tmp))
        phase_grads(cmvn)
        phase_grads(cmvn, N2_CONFIG, "n2")
        bench = phase_bench(Path(tmp))
    log(f"training summary: gate config {train['step_ms']:.1f} ms per update of 2 x 32 x 10 s, "
        f"{train['fps']:.0f} mel-frames/s, peak {train['peak'] / 1e9:.2f} GB; N=2 config "
        f"{train_n2['step_ms']:.1f} ms per update of 64 x 10 s, {train_n2['fps']:.0f} "
        f"mel-frames/s, peak {train_n2['peak'] / 1e9:.2f} GB, kept fraction "
        f"{train_n2['kept']:.4f}, {train_n2['slots']} slots; bench.py step "
        f"{bench['none']['fps']:.0f} (32 x 10 s, remat none) and {bench['full']['fps']:.0f} "
        f"(64 x 10 s, remat full) mel-frames/s; {time.perf_counter() - t_start:.1f} s in all")
    main_shape = ("bfloat16", TRAIN_ROWS, 249, 16)
    fwd = next(r for r in fwd_rows if (r["dtype"], r["B"], r["L"], r["H"]) == main_shape)
    bwd = next(r for r in bwd_rows if (r["dtype"], r["B"], r["L"], r["H"]) == main_shape
               and r["intra"] == "bf16")
    ema = next(r for r in ema_rows if (r["dtype"], r["B"], r["M"], r["D"], r["saturate"])
               == ("bfloat16", 64, 256, 384, False))
    log(f"kernel summary: ssd_fwd / ssd_bwd at bf16 (intra bf16) B{TRAIN_ROWS} L249 H16 P64 "
        f"N128 (a micro-batch of 32 x 10 s, main stack); ema_fwd / ema_bwd at bf16 B64 M256 "
        f"D384 (the dechunk of 64 x 10 s); launches from the N=2 training run (3 "
        f"micro-steps of 64 x 10 s, remat full); no single PyTorch call computes the scan, "
        f"the EMA or their gradients")
    ssd = lambda r: dict(max_abs_err=r["abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"], bound_by=r["bound_by"])
    ema_row = lambda k: dict(max_abs_err=ema["abs_err"][k], ms=ema["ms"][k],
                             plain_ms=ema["plain"][k], bound_ms=ema["cost"][k]["bound_ms"],
                             bound_by=ema["cost"][k]["bound_by"])
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"hnet_mamba_asr_torch/csrc/{source}",
         "replaces": replaces, "launches": train_n2["launches"][name], **row,
         "library_ms": None, "roofline_share": row["bound_ms"] / row["ms"]}
        for name, source, replaces, row in (
            ("ssd_fwd", "ssd_fwd.cu", "hnet_mamba_asr_tpu/ops/ssd_pallas.py:33", ssd(fwd)),
            ("ssd_bwd", "ssd_bwd.cu", "hnet_mamba_asr_tpu/ops/ssd.py:148", ssd(bwd)),
            ("ema_fwd", "ema.cu", "hnet_mamba_asr_tpu/ops/ema.py:30", ema_row("fwd")),
            ("ema_bwd", "ema.cu", "hnet_mamba_asr_tpu/ops/ema.py:30", ema_row("bwd")))]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
