#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: serve, train and decode
Type A Small at N=1 and with H-Net dynamic chunking at N=2.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Drives the port (``hnet_mamba_asr_torch``) through the entry points a user
calls, at the full width of ``configs/typeA_small_N1.yaml`` and
``configs/typeA_small_N2.yaml`` with seeded random weights, and fails
(non-zero exit) when any phase fails:

1. build    -- compile the hand-written kernels (SSD forward and backward
               at (P, N) = (64, 128) and, fp32 only, (16, 16); the H-Net
               EMA) from ``csrc/``, one nvcc per library, started together;
2. kernel   -- the forward kernel against its plain PyTorch version
               (``ssd_chunked`` at the kernel's chunk length and
               intra_dtype) at the serving shapes (B 8 and 1, L 248 / 873 /
               1000, H 12 / 16), the full-width decode batch's (B 8, L 380)
               and the training ones (B 32, L 249), bf16 with intra_dtype
               bf16 and fp32, and the (16, 16) fp32 build at the tone
               runs' shapes (B 24 / 13 / 3, L 63, H 4) with intra_dtype off
               and bf16, with both times, the bound and the share of it;
               one time with a cold L2;
   backward -- the backward kernel's gradients of x, dt, A, B, C against
               autograd of ``ssd_chunked`` at the training shapes (B 32,
               L 249, H 12 / 16), at L 873 (two cluster rounds) and at B 1,
               fp32 and bf16, intra_dtype off and bf16, and the (16, 16) fp32
               build at the tone shapes, with both times, the bound and the
               share of it; two calls on the same inputs are
               bitwise equal; then bf16 with the state in and out at L 1100
               (three rounds of the reverse chain): every input's gradient
               and d(initial_state);
   ema      -- the EMA kernels (forward and backward) against the plain
               recurrence and the plain matmul form at the dechunk's shapes
               (B 64 M 128 / 256, B 8 M 880, D 384 and 512, B 1 M 64 / 880),
               bf16 and fp32, with saturated P, M = 1, M = 64 and 65 (one
               chunk of the kernel's scan, and one slot more) and D 1030
               (nine channel tiles, element loads): zbar, dz, dP, zero dP
               at saturated slots, two calls bitwise equal; both times and
               the bound;
3. model    -- the whole model on the card (kernel path) against the same
               weights and batch on the CPU (plain path), fp32, TF32 off;
   hnet     -- the same at N = 2 (Type A), N = 4 (Type B, n_mid 1) and with
               the fixed-pool chunker at N = 2, depth 1 + 2 + 1, 4
               utterances of 2-16 s: the boundaries equal, then features
               and log-probs;
4. serve    -- 9 requests through the micro-batching server, one over HTTP,
               in the config's bf16; solo == batched; the kernel's launch
               count is 40 per model call; then the same at N = 2 (40 SSD
               and 1 EMA launches per call); then the gate config serving
               beam_ids (the device CTC prefix beam) and aed_ids (AED cap
               64): 8 requests in one call, each alone and through the
               micro-batcher, ids equal;
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
               64 x 10 s with remat full;
9. intra    -- one block per position (first enc, a main, the last dec) of
               the gate config at its own numerics (bf16, intra bf16): the
               card's mixer (kernel chunk 64; the block less its residual)
               against the CPU's (ssd_chunked at 256) within 26 x 2^-8 of
               its output; the whole model's log-prob gap recorded;
10. gate    -- the N=1 gate proof on the synthetic tone corpus: tokenizer,
               CMVN, ``overfit_config`` through Trainer (120 epochs), then
               ``decode_task`` ctc_greedy and the ``eval/score.py`` gate:
               dev WER < 5.0 and falling, test-clean WER < 12.0;
11. matrix  -- the hybrid tone model (0.3 CTC + 0.7 AED) and a narrow LM
               trained on the training text; all 7 cells, each cell's WER
               and seconds per utterance, the AED and joint cells below
               their WER at the initial weights;
12. n2      -- ``overfit_config(compression_n=2)`` for 120 epochs: finite,
               the ratio loss not rising, the kept fraction near 1/2, its
               trajectory;
13. decode  -- the full-width gate config (seeded) and the full-width
               ``lm_transformer_500`` LM (seeded): 8 utterances of 2-16 s
               through the 7 cells of the config's decode block, shared
               encoder, AED cap 64 (seeded weights never emit eos), once on
               the device searches (the default) and once on the host's
               (``device_beam: false``): RTF, encoder and search seconds per
               cell, the SSD launches, the device's idle share per cell; the
               device engine's kernel launches per search step and host
               reads of its active mask; the engines' disagreements and
               ties; the psi and r-scan shares of a joint step; each
               utterance alone == inside the batch in every beam cell of
               both engines, in bf16;
14. parity  -- depth 1 + 2 + 1, a 2-layer AED and a 2-layer LM, fp32, TF32
               off: decode_step log-probs card vs CPU to 1e-5, the 7 cells'
               transcripts card == CPU for both engines and device ==
               lockstep on both sides, a request alone == inside a batch for
               ctc_beam_lm and joint_beam on both engines.

The line before the last is a JSON summary of the kernels, with the
launches of the full-width decode run on the device engine (ssd_fwd) and of
the N = 2 training run (the others), and every path's counts; the last line is
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
    TRAIN_ROWS, VOCAB, decode_batch_items, draw_routers, gate_trainer, make_cmvn, synth_audio,
    train_batches)
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
# serving (B 8 and 1 at 10 s, 35 s, 40 s), the full-width decode batch (8
# utterances of up to 15.2 s: L 380, six chunks) and the training step
FWD_SHAPES = (tuple((Bsz, L, H) for Bsz in (8, 1) for L in (248, 873, 1000)
                    for H in (12, 16)) + ((8, 380, 12), (8, 380, 16)) + TRAIN_SHAPES)
# the tone models' (P, N) = (16, 16) build, fp32 only: the tone gate's
# training and decode batch (24 utterances of up to 63 frames, 4 heads) and
# the N=2 tone run's batches of batch_bins 1500 (3, 8 and 13 utterances)
TONE_SHAPES = ((24, 63, 4), (13, 63, 4), (3, 63, 4))
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
    cases = ([(torch.bfloat16, "bf16", 64, 128, s) for s in FWD_SHAPES]
             + [(torch.float32, None, 64, 128, s) for s in FWD_SHAPES]
             + [(torch.float32, intra, 16, 16, s) for intra in (None, "bf16")
                for s in TONE_SHAPES])
    for dtype, intra, P, N, (Bsz, L, H) in cases:
        name = str(dtype).removeprefix("torch.")
        # fp32 with intra bf16 rounds the intra-chunk weights as bf16 does
        kind = "bfloat16" if intra else name
        x, dt, A, B, C = ssd_inputs(Bsz, L, H, dtype, seed=SEED, P=P, N=N)
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
        cost = ssd_cost(Bsz, L, H, 1, P, N, name)
        blocks = Bsz * H * (lib.hnet_ssd_fwd_bf16_cluster_size(L)
                            if dtype == torch.bfloat16 else 1)
        log(f"  ssd {name} intra {intra} B{Bsz} L{L} H{H} P{P} N{N} G1: "
            f"max|d|/max|y| {rel:.3e} (bound {SSD_BOUND[kind]:g}) mean|d|/mean|y| "
            f"{mean:.3e} (bound {SSD_MEAN_BOUND[kind]:g}) max|d| {abs_err:.3e}; "
            f"kernel {ms:.4f} ms (call {call_ms:.4f} ms) plain {plain_ms:.4f} ms; bound "
            f"{cost['bound_ms'] * 1e3:.2f} us ({cost['bound_by']}: bytes "
            f"{cost['bytes_us']:.2f} us, ops {cost['ops_us']:.2f} us), share "
            f"{cost['bound_ms'] / ms:.2%}; {blocks} blocks")
        if not (rel <= SSD_BOUND[kind] and mean <= SSD_MEAN_BOUND[kind]):
            raise AssertionError(f"ssd kernel disagrees with ssd_chunked: "
                                 f"{rel:.3e}, mean {mean:.3e} ({name}, intra {intra}, "
                                 f"B {Bsz}, L {L}, H {H}, P {P}, N {N})")
        rows.append(dict(dtype=name, intra=intra, P=P, B=Bsz, H=H, L=L, rel=rel,
                         abs_err=abs_err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         **cost))
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
    cases = [(dtype, intra, 64, 128, s) for dtype in (torch.bfloat16, torch.float32)
             for intra in ("bf16", None) for s in BWD_SHAPES]
    cases += [(torch.float32, intra, 16, 16, s) for intra in ("bf16", None)
              for s in TONE_SHAPES]
    for dtype, intra, P, N, (Bsz, L, H) in cases:
        name = str(dtype).removeprefix("torch.")
        kind = "bfloat16" if dtype == torch.bfloat16 or intra else "float32"
        what = f"{name}, intra {intra}, B {Bsz}, L {L}, H {H}, P {P}, N {N}"
        args = ssd_inputs(Bsz, L, H, dtype, seed=SEED + 5, P=P, N=N)
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
        errs, abs_err = check_grads(got, want, args, kind, what)
        bf = intra == "bf16"
        _, _, states = mod._forward(*args, None, False, bf, keep_states=True)
        run = lambda: mod._backward(*args, states, dy, None, bf, False)
        one, two = run(), run()
        if not all(torch.equal(a, b) for a, b in zip(one, two) if a is not None):
            raise AssertionError(f"two backward calls on the same inputs differ "
                                 f"({what})")
        del one, two
        call_ms = cuda_ms(run)
        ms = kernel_ms(run, "ssd_bwd") or call_ms
        plain_ms = cuda_ms(lambda: torch.autograd.grad(y_plain, plain, dy,
                                                       retain_graph=True))
        cost = ssd_bwd_cost(Bsz, L, H, 1, P, N, name)
        log(f"  ssd_bwd {name} intra {intra} B{Bsz} L{L} H{H} P{P} N{N}: max|d|/max|g| "
            f"/ mean|d|/mean|g| {', '.join(errs)} (bounds {GRAD_BOUND[kind]:g} / "
            f"{GRAD_MEAN_BOUND[kind]:g}, dA {DA_BOUND[kind]:g}); kernel {ms:.4f} ms "
            f"(call {call_ms:.4f} ms) plain backward {plain_ms:.4f} ms; bound "
            f"{cost['bound_ms'] * 1e3:.2f} us ({cost['bound_by']}: bytes "
            f"{cost['bytes_us']:.2f} us, ops {cost['ops_us']:.2f} us), share "
            f"{cost['bound_ms'] / ms:.2%}; {bwd_grid(mod, dtype, Bsz, L, H)}")
        rows.append(dict(dtype=name, intra=intra, P=P, B=Bsz, H=H, L=L, abs_err=abs_err,
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
    # one chunk of the kernel's scan and one slot more; a D of nine channel
    # tiles that 16 bytes of channels do not divide (no channel cap)
    cases += [(dtype, shape, True) for dtype in (torch.bfloat16, torch.float32)
              for shape in ((2, 64, 384), (2, 65, 384), (2, 70, 1030))]
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


def phase_serve_modes(cmvn) -> dict:
    """The gate config (AED cap DECODE_CAP: seeded weights never emit eos)
    serving beam_ids and aed_ids in bf16: 8 requests of 2-16 s in one call,
    through the micro-batcher and each alone; beam ids and eos-cut AED ids
    alone == batched, the batcher's rows the beam's ids; 40 SSD launches per
    call; ms per call."""
    from hnet_mamba_asr_torch.models.aed import strip_hypothesis
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.serving.runtime import ServingModel
    from hnet_mamba_asr_torch.serving.server import MicroBatcher
    cfg = copy.deepcopy(GATE_CONFIG)
    cfg["aed_conf"]["max_decode_len"] = DECODE_CAP
    model = ServingModel(cfg, None, "cuda", vocab_size=VOCAB, cmvn=cmvn, seed=SEED,
                         max_batch=8, max_samples=40 * SR, emit=("beam_ids", "aed_ids"))
    rng = np.random.default_rng(SEED + 3)
    waves = [synth_audio(rng, float(s)) for s in rng.uniform(2.0, 16.0, size=8)]
    lens = np.array([len(w) for w in waves])
    padded = np.zeros((8, lens.max()), np.float32)
    for i, w in enumerate(waves):
        padded[i, :len(w)] = w
    model(padded[:1, :lens[0]], lens[:1])            # cuBLAS / cuDNN set-up
    torch.cuda.synchronize()

    def rows(out):
        return ([out["beam_ids"][i, :out["beam_lens"][i]].tolist()
                 for i in range(len(out["beam_lens"]))],
                [strip_hypothesis(r, model.eos_id) for r in out["aed_ids"]])

    ssd_cuda.launches = 0
    t0 = time.perf_counter()
    batched = rows(model(padded, lens))
    batch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    alone = [rows(model(w[None], [len(w)])) for w in waves]
    alone_ms = (time.perf_counter() - t0) * 1e3 / len(waves)
    launches = ssd_cuda.launches
    batcher = MicroBatcher(model, max_wait_ms=50.0)
    try:
        served = [f.result(timeout=300)["ids"] for f in [batcher.submit(w) for w in waves]]
        stats = batcher.stats()
    finally:
        batcher.close()
    beam_alone = [a[0][0] for a in alone]
    aed_alone = [a[1][0] for a in alone]
    log(f"  beam_ids + aed_ids, 8 requests of {sorted(round(len(w) / SR, 2) for w in waves)} "
        f"s: one call {batch_ms:.1f} ms, alone {alone_ms:.1f} ms a call; beam alone == "
        f"batched {beam_alone == batched[0]}, aed alone == batched {aed_alone == batched[1]}, "
        f"micro-batcher rows == beam ids {served == batched[0]} ({stats['batches']} "
        f"batches); beam lengths {[len(b) for b in batched[0]]}, aed lengths "
        f"{[len(a) for a in batched[1]]}; ssd launches {launches} over 9 calls")
    differ = {name: [i for i, (a, b) in enumerate(zip(got, batched[k])) if a != b]
              for name, got, k in (("beam", beam_alone, 0), ("aed", aed_alone, 1),
                                   ("batcher", served, 0))}
    if any(differ.values()):
        raise AssertionError(f"served ids differ alone and batched, by request: {differ}")
    if launches != 9 * SSD_CALLS_PER_FORWARD:
        raise AssertionError(f"{launches} ssd_fwd launches over 9 calls")
    if not all(0 <= t < VOCAB for ids in batched[0] + batched[1] for t in ids):
        raise AssertionError("served ids out of the vocabulary")
    del model
    torch.cuda.empty_cache()
    log("phase 4 serve beam_ids / aed_ids: ok")
    return {"batch_ms": batch_ms, "alone_ms": alone_ms}


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


# ---- the decode slice ---------------------------------------------------------
# intra-bf16 blocks (repair 0.1): a block of the gate config at its own
# numerics (bf16, ssd_intra_dtype bf16) on the card (kernel, chunk 64) against
# the CPU (plain ssd_chunked at the config's chunk, 256), same weights and
# input. Both paths round every operand below to bf16, at different places
# (the chunk bounds of the intra weights) or in different summation orders
# (cuBLAS, cuDNN, the kernel against the CPU), so each may part by one
# rounding, at most 2^-8 of that operand's magnitude. The operands on a
# block's path: LN(x); per direction in_proj, conv, SiLU, the SSD's W, its
# weighted B, its state S and y, y + D x, SiLU(z), the gated product, the
# RMSNorm and out_proj (12); the directions' sum: 1 + 2 x 12 + 1 = 26. The
# check reads the mixer's output (the block's output less its residual x,
# MambaBlock.mixer): the residual is the same on both sides, and its own
# rounding (one bf16 ulp of max|x|, ~8) would hide the mixer's gap. The bound
# counts each rounding at the scale of the mixer's output, whose norms
# (LayerNorm in, gated RMSNorm before out_proj) keep every operand's rounding
# relative: max|d| <= 26 x 2^-8 x max|mixer|. The block's whole output is
# printed beside it (the residual's ulp, recorded).
BLOCK_ROUNDINGS = 26
BLOCK_POSITIONS = (("enc block 0", "enc", 0), ("main block 0", "main", 0),
                   ("dec block 3 (last)", "dec", -1))


def phase_intra_blocks(cmvn) -> dict:
    """One block per position type of the gate config at full width, bf16
    with intra bf16: the card's kernel path against the CPU's plain path,
    within the derived bound; then the whole 20-block model's log-probs at
    the same setting, card against CPU, recorded and not gated."""
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.serving.runtime import ServingModel
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    cfg = copy.deepcopy(GATE_CONFIG)
    models = {dev: build_model(cfg, VOCAB, cmvn=cmvn, seed=SEED, device=dev)
              for dev in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(SEED + 40)
    lengths = torch.tensor([249, 173])
    out = {"blocks": {}, "model": {}}
    for label, stack, idx in BLOCK_POSITIONS:
        d = getattr(models["cpu"].encoder, stack).blocks[idx].norm.normalized_shape[0]
        x = torch.randn(2, 249, d, generator=gen).to(torch.bfloat16)
        mixes, ys = {}, {}
        for dev, model in models.items():
            block = getattr(model.encoder, stack).blocks[idx]
            before = ssd_cuda.launches
            with torch.no_grad():
                mixes[dev] = block.mixer(x.to(dev), lengths.to(dev)).float().cpu()
                ys[dev] = block(x.to(dev), lengths.to(dev)).float().cpu()
            if dev == "cuda" and ssd_cuda.launches != before + 4:
                raise AssertionError(f"{label}: the card's block did not launch the kernel "
                                     f"twice per call")
        valid = (torch.arange(249)[None, :] < lengths[:, None])[..., None]
        gap = lambda got: (((got["cuda"] - got["cpu"]).abs() * valid).max().item(),
                           (got["cpu"].abs() * valid).max().item())
        diff, scale = gap(mixes)
        y_diff, y_scale = gap(ys)
        bound = BLOCK_ROUNDINGS * 2.0 ** -8 * scale
        log(f"  {label} (d {d}), bf16 intra bf16, 2 rows of {lengths.tolist()} frames: card "
            f"(kernel, chunk 64) vs CPU (ssd_chunked, chunk 256): mixer max|d| {diff:.4e}, "
            f"max|mixer| {scale:.4e}, max|d|/max|mixer| {diff / scale:.4e} (bound "
            f"{BLOCK_ROUNDINGS} x 2^-8 = {BLOCK_ROUNDINGS * 2.0 ** -8:.4e}); block output "
            f"with the residual max|d| {y_diff:.4e}, max|y| {y_scale:.4e} (recorded)")
        if not (math.isfinite(diff) and diff <= bound):
            raise AssertionError(f"{label}: the card's mixer parts from the CPU's by "
                                 f"{diff:.4e}, beyond the derived bound {bound:.4e}")
        out["blocks"][label] = diff / scale
    del models
    rng = np.random.default_rng(SEED + 41)
    waves = [synth_audio(rng, 6.0), synth_audio(rng, 3.5)]
    lens = np.array([len(w) for w in waves])
    batch = np.zeros((2, lens.max()), np.float32)
    for i, w in enumerate(waves):
        batch[i, :len(w)] = w
    kw = dict(vocab_size=VOCAB, cmvn=cmvn, seed=SEED, emit=("frame_ids", "log_probs"))
    # the card; the CPU at the config's chunk (256) and at the kernel's (64):
    # CPU against CPU shows how far the chunk length alone moves the model
    cfg64 = copy.deepcopy(cfg)
    cfg64["encoder_conf"]["ssd_chunk_size"] = 64
    res = {"card": ServingModel(cfg, None, "cuda", **kw)(batch, lens),
           "cpu": ServingModel(cfg, None, "cpu", **kw)(batch, lens),
           "cpu64": ServingModel(cfg64, None, "cpu", **kw)(batch, lens)}

    def gap(a, b):
        worst, agree, total = 0.0, 0, 0
        for i, n in enumerate(res[b]["enc_lengths"]):
            la, lb = res[a]["log_probs"][i, :n], res[b]["log_probs"][i, :n]
            worst = max(worst, float(np.abs(la - lb).max()))
            agree += int((res[a]["frame_ids"][i, :n] == res[b]["frame_ids"][i, :n]).sum())
            total += int(n)
        return worst, agree, total

    for a, b, what in (("card", "cpu", "card (chunk 64) vs CPU (chunk 256)"),
                       ("card", "cpu64", "card vs CPU, both at chunk 64"),
                       ("cpu64", "cpu", "CPU at chunk 64 vs CPU at chunk 256")):
        w, agr, tot = gap(a, b)
        log(f"  whole model (20 blocks), bf16 intra bf16, {what}: max|d log_prob| {w:.4e}, "
            f"frame ids equal on {agr}/{tot} (recorded, not gated)")
        out["model"][what] = w
    torch.cuda.empty_cache()
    log("phase 9 intra blocks: ok")
    return out


def tone_setup(root: Path, device: str = "cuda"):
    """The tone corpus under ``root``, its 12-piece tokenizer (trained on the
    train manifest's text, as scripts/build_tokenizer.py does) and the CMVN
    of the train manifest at 20 mels."""
    from hnet_mamba_asr_torch.data.audio import load_manifest
    from hnet_mamba_asr_torch.data.features import compute_cmvn
    from hnet_mamba_asr_torch.data.synthetic import build_tone_corpus
    from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
    build_tone_corpus(root)
    train = root / "manifests" / "train-960.jsonl"
    texts = [e["text"] for e in load_manifest(train)]
    tok = Tokenizer.train(texts, root / "tok" / "bpe", vocab_size=12, hard_vocab_limit=False)
    if any(tok.decode(tok.encode(t)) != t for t in texts):
        raise AssertionError("the tone tokenizer does not round-trip")
    cmvn = compute_cmvn(train, n_mels=20, device=device, out=root / "cmvn.npz")
    return tok, cmvn


def tone_load(root: Path):
    """The tokenizer and CMVN that ``tone_setup`` wrote under ``root``."""
    from hnet_mamba_asr_torch.data.features import GlobalCMVN
    from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
    return Tokenizer(root / "tok" / "bpe.model"), GlobalCMVN.load(root / "cmvn.npz")


def tone_train(cfg, tok, cmvn, root: Path, name: str, seed: int = 0, device: str = "cuda"):
    """Train a model of ``cfg`` (an ``overfit_config`` dict) through Trainer
    on the tone corpus, with the dev split validated every
    valid_interval_epoch epochs; returns the trainer."""
    from hnet_mamba_asr_torch.data.dataset import ItemLoader, manifest_items
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.training.trainer import Trainer, flatten_config
    mdir = root / "manifests"
    bins = int(cfg["batch_bins"])
    train = ItemLoader(manifest_items(mdir / "train-960.jsonl", tok), bins, seed=seed)
    dev = ItemLoader(manifest_items(mdir / "dev-clean.jsonl", tok), bins, shuffle=False)
    model = build_model(cfg, tok.vocab_size, cmvn=cmvn, seed=seed, device=device)
    trainer = Trainer(model, train, flatten_config(cfg), dev_loaders={"dev-clean": dev},
                      tokenizer=tok, ckpt_dir=root / name, seed=seed, device=device)
    trainer.train()
    return trainer


def tone_decode(model, tok, root: Path, decode_cfg, out_dir: Path, lm=None) -> dict:
    """Decode test-clean through every cell of ``decode_cfg`` with the shared
    encoder and score it with the port's gate (ctc_greedy, WER < 12.0)."""
    from hnet_mamba_asr_torch.data.dataset import ItemLoader, manifest_items
    from hnet_mamba_asr_torch.eval.score import format_report, score_decode_dir
    from hnet_mamba_asr_torch.tasks import decode_task
    manifest = root / "manifests" / "test-clean.jsonl"
    cells = decode_task.expand_cells(decode_cfg)
    decode_task.check_heads(model, cells)
    loader = ItemLoader(manifest_items(manifest, tok), int(decode_cfg.get("batch_bins", 8000)),
                        shuffle=False)
    summaries = decode_task.decode_split_shared(
        model, tok, loader, cells, decode_cfg, out_dir=out_dir, split="test-clean", lm=lm,
        audio_seconds=decode_task.audio_seconds_from_manifest(manifest))
    scores = score_decode_dir(out_dir, n_bootstrap=50,
                              goal_cfg={"sane_test_clean_wer_below": 12.0},
                              gate_cell="ctc_greedy")
    for line in format_report(scores["splits"], scores["gate"]).splitlines():
        log(f"    {line}")
    return {"summaries": {s["cell"]: s for s in summaries}, "scores": scores}


# the tone gate's training length. tests/test_overfit_gate.py trains 40
# epochs (one update each) from JAX's draw at PRNGKey(0) and passes. On the
# CPU (tests/torch_gate_trajectory.py) the port trained from that same draw,
# carried by convert.py, gives JAX's dev WER at every validation (74.1, 51.9,
# 25.9, 0.0), but JAX's own draws at PRNGKey(1..3) end epoch 40 at 18.5,
# 33.3 and 59.3, and the port's seeds 0..3 at 22.2, 18.5, 63.0 and 22.2:
# 40 updates suffice for one JAX draw in four and for none of the port's
# four, and the two packages train alike from the same draw. So the
# proof trains 120 epochs (scripts/analysis/overfit_gate.py's length for the
# held-out gate; the warmuplr schedule does not depend on it) and prints the
# dev WER at epoch 40 beside the final one.
GATE_EPOCHS = 120


def phase_gate_proof(tmp: Path) -> dict:
    """The N=1 gate proof: overfit_config (d 32, CTC only, lr 3e-3;
    GATE_EPOCHS epochs) through Trainer on the tone corpus, then test-clean
    through decode_task's ctc_greedy and the port's score gate: the final
    dev WER < 5.0 and below the first, the gate passes with a test-clean WER
    < 12.0 on 24 utterances (tests/test_overfit_gate.py's bounds)."""
    from hnet_mamba_asr_torch.data.synthetic import overfit_config
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    root = tmp / "gate"
    tok, cmvn = tone_setup(root)
    cfg = overfit_config(root, max_epoch=GATE_EPOCHS)
    ssd_cuda.launches = ssd_cuda.bwd_launches = 0
    t0 = time.perf_counter()
    trainer = tone_train(cfg, tok, cmvn, root, "ckpt")
    train_s = time.perf_counter() - t0
    launches = {"ssd_fwd": ssd_cuda.launches, "ssd_bwd": ssd_cuda.bwd_launches}
    wers = list(trainer.metric_history[("valid", "wer")].values())
    losses = [r["loss/total"] for r in trainer.history]
    log(f"  gate proof N=1: {len(trainer.history)} updates in {train_s:.1f} s, loss "
        f"{losses[0]:.4f} -> {losses[39]:.4f} (epoch 40) -> {losses[-1]:.4f}, dev WER every 10 "
        f"epochs {[round(w, 2) for w in wers]} (epoch 40: {wers[3]:.2f}); ssd launches "
        f"forward {launches['ssd_fwd']}, backward {launches['ssd_bwd']} (P 16 N 16, fp32)")
    if not (len(wers) >= 3 and wers[-1] < 5.0 and wers[-1] < wers[0]
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"the gate model did not learn: dev WER {wers}")
    if not (launches["ssd_fwd"] and launches["ssd_bwd"]):
        raise AssertionError(f"the tone training did not run the SSD kernels: {launches}")
    res = tone_decode(trainer.model, tok, root, cfg["decode"], root / "decode")
    gate = res["scores"]["gate"]
    n = res["scores"]["splits"]["test-clean"]["cells"]["ctc_greedy"]["n_utts"]
    if not (gate.get("passed") and gate["wer"] < 12.0 and n == 24):
        raise AssertionError(f"the gate failed: {gate}, {n} utterances")
    log("phase 10 gate proof: ok")
    return {"dev_wer": wers, "gate": gate, "updates": len(trainer.history), "train_s": train_s,
            "launches": launches, "ms_per_update": 1e3 * train_s / len(trainer.history)}


# the decode block of the hybrid tone matrix: the gate config's search
# settings over the tone model (the LM is the narrow one trained here)
TONE_DECODE = {"read_outs": ["ctc", "aed", "joint"], "search": ["greedy", "beam"],
               "beam_size": 10, "pre_beam": 30, "ctc_weight": 0.3, "length_bonus": 0.0,
               "lm": "enabled", "lm_weight": 0.3, "rescore_weight": 0.6,
               "rescore_length_bonus": 2.0, "device_beam": False, "batch_bins": 8000}
TONE_LM = {"lm_conf": {"d_model": 64, "n_layers": 2, "n_heads": 4, "d_ff": 256,
                       "dropout": 0.1, "lsm_weight": 0.0}}
TONE_LM_TRAIN = {"optim": "adamw", "optim_conf": {"lr": 3e-3, "weight_decay": 0.0},
                 "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 30},
                 "max_epoch": 100, "grad_clip": 5.0, "log_interval": 100,
                 "valid_interval_epoch": 1000}


def phase_tone_matrix(tmp: Path) -> dict:
    """The hybrid tone model (ctc 0.3, aed 0.7, GATE_EPOCHS epochs) and a
    narrow LM trained on the training text (~300 updates), then all 7 cells
    on test-clean: each cell's WER and seconds per utterance, a hypothesis
    for every utterance, ctc_greedy through the gate, and every AED and
    joint cell below its WER at the model's initial weights."""
    from hnet_mamba_asr_torch.data.audio import load_manifest
    from hnet_mamba_asr_torch.data.synthetic import overfit_config
    from hnet_mamba_asr_torch.decoders.lm_scorer import CausalLMScorer
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tasks.lm_task import TokenLineLoader, build_lm
    from hnet_mamba_asr_torch.training.trainer import Trainer
    root = tmp / "gate"
    tok, cmvn = tone_load(root)
    cfg = overfit_config(root, ctc_weight=0.3, aed_weight=0.7, max_epoch=GATE_EPOCHS)
    trainer = tone_train(cfg, tok, cmvn, root, "hybrid")
    wers = list(trainer.metric_history[("valid", "wer")].values())
    lines = [tok.encode(e["text"]) for e in load_manifest(root / "manifests" / "train-960.jsonl")]
    lm = build_lm(TONE_LM, tok.vocab_size, seed=0)
    lm_trainer = Trainer(lm, TokenLineLoader(lines, 64, seed=0), TONE_LM_TRAIN,
                         ckpt_dir=root / "lm", seed=0)
    lm_trainer.train()
    lm_losses = [r["loss/total"] for r in lm_trainer.history]
    log(f"  hybrid tone model: {len(trainer.history)} updates, dev WER (CTC greedy) {wers}; "
        f"LM {len(lm_losses)} updates, loss {lm_losses[0]:.4f} -> {lm_losses[-1]:.4f}")
    scorer = CausalLMScorer(lm.lm, bos_id=tok.bos_id, eos_id=tok.eos_id, pad_id=tok.pad_id)
    trained = tone_decode(trainer.model, tok, root, TONE_DECODE, root / "matrix", lm=scorer)
    init_model = build_model(cfg, tok.vocab_size, cmvn=cmvn, seed=0)
    init = tone_decode(init_model, tok, root, TONE_DECODE, root / "matrix_init", lm=scorer)
    cells = trained["scores"]["splits"]["test-clean"]["cells"]
    cells0 = init["scores"]["splits"]["test-clean"]["cells"]
    rows = {}
    for name, s in cells.items():
        per_utt = trained["summaries"][name]["decode_s"] / s["n_utts"]
        rows[name] = {"wer": s["wer_exact"], "wer_init": cells0[name]["wer_exact"],
                      "s_per_utt": per_utt, "n_utts": s["n_utts"]}
        log(f"  {name:<14} WER {s['wer_exact']:7.3f} (initial weights "
            f"{cells0[name]['wer_exact']:7.3f}), {per_utt * 1e3:.2f} ms per utterance, "
            f"{s['n_utts']} utterances, engine {trained['summaries'][name]['engine']}")
    if len(cells) != 7 or any(r["n_utts"] != 24 for r in rows.values()):
        raise AssertionError(f"a cell lacks hypotheses: {rows}")
    if not trained["scores"]["gate"].get("passed"):
        raise AssertionError(f"ctc_greedy failed the gate: {trained['scores']['gate']}")
    worse = [n for n, r in rows.items() if n.startswith(("aed", "joint"))
             and not r["wer"] < r["wer_init"]]
    if worse:
        raise AssertionError(f"trained cells not below their initial WER: {worse}: {rows}")
    del trainer, lm_trainer, init_model
    torch.cuda.empty_cache()
    log("phase 11 tone matrix: ok")
    return rows


def phase_n2_stability(tmp: Path) -> dict:
    """overfit_config(compression_n=2) for 120 epochs of batch_bins 1500
    (scripts/analysis/overfit_gate.py's N=2 batch): every loss and gradient
    norm finite, ratio_last <= ratio_first + 0.05, |kept_last - 0.5| < 0.25;
    the kept-fraction trajectory."""
    from hnet_mamba_asr_torch.data.synthetic import overfit_config
    from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda
    root = tmp / "gate"
    tok, cmvn = tone_load(root)
    cfg = overfit_config(root, compression_n=2, max_epoch=120, batch_bins=1500,
                         valid_interval=20)
    ema_cuda.launches = ema_cuda.bwd_launches = 0
    t0 = time.perf_counter()
    trainer = tone_train(cfg, tok, cmvn, root, "n2")
    train_s = time.perf_counter() - t0
    h = trainer.history
    finite = all(math.isfinite(r["loss/total"]) and math.isfinite(r["grad_norm"]) for r in h)
    kept = [r["kept_fraction"] for r in h]
    ratio_first, ratio_last = h[0]["loss/ratio"], h[-1]["loss/ratio"]
    wers = list(trainer.metric_history[("valid", "wer")].values())
    stride = max(1, len(h) // 12)
    log(f"  n2 stability: {len(h)} updates in {train_s:.1f} s; ratio loss {ratio_first:.4f} -> "
        f"{ratio_last:.4f}; kept fraction {kept[0]:.4f} -> {kept[-1]:.4f} (target 0.5); "
        f"dev WER {wers}; ema launches forward {ema_cuda.launches}, backward "
        f"{ema_cuda.bwd_launches}")
    log("  kept-fraction trajectory (step: kept): " + ", ".join(
        f"{h[i]['step']}: {kept[i]:.4f}" for i in range(0, len(h), stride)))
    stable = (finite and ratio_last <= ratio_first + 0.05 and abs(kept[-1] - 0.5) < 0.25)
    if not stable:
        raise AssertionError(f"N=2 not stable: finite {finite}, ratio {ratio_first} -> "
                             f"{ratio_last}, kept {kept[-1]}")
    del trainer
    torch.cuda.empty_cache()
    log("phase 12 n2 stability: ok")
    return {"kept": kept, "ratio": (ratio_first, ratio_last), "updates": len(h),
            "train_s": train_s, "dev_wer": wers}


# the full-width decode run: the gate config's decode block with both cuts
# that seeded weights force (they never emit eos, so every AED and joint beam
# runs to its cap): the AED cap at 64 tokens (512 in the config)
DECODE_CAP = 64
DECODE_UTTS = 8


# engine labels and their decode blocks: the config's own (device_beam
# absent: the device searches, the JAX package's default) and the host's
ENGINES = (("device", {}), ("lockstep", {"device_beam": False}))
# a disagreement between the engines is a tie when their best scores agree
# within this share of their magnitude (float32 against float64 scoring)
TIE_SHARE = 1e-4
STEP_PROBE = 16                 # search steps profiled for the launches per step


def profile_cell(fn) -> tuple[float, int, float]:
    """(idle share, kernel launches, window s) of one synchronised call of
    ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from hnet_mamba_asr_torch.tools.measure import device_rows
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t1) * 1e6
    rows = device_rows(prof)
    return 1.0 - sum(r[0] for r in rows) / window_us, sum(r[2] for r in rows), window_us / 1e6


def device_call_ms(fn, n: int = 10) -> float:
    """Mean device ms of ``fn``'s kernels over n calls after 2 warm-ups."""
    from torch.profiler import ProfilerActivity, profile
    from hnet_mamba_asr_torch.tools.measure import device_rows
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(r[0] for r in device_rows(prof)) / n / 1e3


def phase_decode_full(cmvn, tmp: Path) -> dict:
    """typeA_small_N1 at full width (78,858,409 parameters, seeded, bf16 intra
    bf16) and lm_transformer_500 at full width (seeded, fp32): 8 synthetic
    utterances of 2-16 s in one batch through all 7 cells of the config's
    decode block with the shared encoder, once per engine: the device
    searches (the config's default) and the host's (``device_beam: false``).
    Per cell and engine the real-time factor, encoder and search seconds and
    the device's idle share (each cell alone under torch.profiler on the two
    shortest utterances); the device engine's steps and host reads of its
    active mask; the engines' disagreements (ties: best scores within
    TIE_SHARE) and, in the CTC cells, what they come from; at the batch of
    8, the device searches' kernel launches per step (their first
    STEP_PROBE steps) and the psi and r-scan shares of a joint step; the SSD
    launches of each run; then every utterance alone against its transcript
    in the batch, in each beam cell of both engines."""
    from hnet_mamba_asr_torch.data.dataset import ItemLoader, collate_batch
    from hnet_mamba_asr_torch.decoders import device_beam, device_ctc_beam
    from hnet_mamba_asr_torch.decoders.ctc_decode import ctc_prefix_beam_search
    from hnet_mamba_asr_torch.decoders.lm_scorer import CausalLMScorer
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.tasks import decode_task
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tasks.lm_task import build_lm
    from hnet_mamba_asr_torch.tools.gate import GATE_DECODE, LM_CONFIG, seeded_tokenizer
    cfg = copy.deepcopy(GATE_CONFIG)
    cfg["aed_conf"]["max_decode_len"] = DECODE_CAP
    model = build_model(cfg, VOCAB, cmvn=cmvn, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    lm = build_lm(LM_CONFIG, VOCAB, seed=SEED)
    tok = seeded_tokenizer(tmp / "tok500.model")
    scorer = CausalLMScorer(lm.lm, bos_id=tok.bos_id, eos_id=tok.eos_id, pad_id=tok.pad_id)
    items = decode_batch_items(np.random.default_rng(SEED + 50), DECODE_UTTS)
    audio_s = {it["id"]: it["n_samples"] / SR for it in items}
    total_audio = sum(audio_s.values())
    loader = ItemLoader(items, 10 ** 7, shuffle=False)
    short = sorted(items, key=lambda it: it["n_samples"])[:2]
    short_batch = next(iter(ItemLoader(short, 10 ** 7, shuffle=False)))
    runs = {}
    for engine, change in ENGINES:
        dc = dict(GATE_DECODE, **change)
        cells = decode_task.expand_cells(dc)
        torch.cuda.synchronize()
        ssd_cuda.launches = 0
        t0 = time.perf_counter()
        summaries = decode_task.decode_split_shared(
            model, tok, loader, cells, dc, audio_seconds=audio_s,
            out_dir=tmp / f"full_{engine}", split="synthetic", lm=scorer)
        wall = time.perf_counter() - t0
        launches = ssd_cuda.launches
        records = {c["name"]: {r["id"]: r for r in map(json.loads, (
            tmp / f"full_{engine}" / c["name"] / "synthetic.jsonl").read_text().splitlines())}
            for c in cells}
        rows = {}
        t1 = time.perf_counter()
        enc, _ = decode_task.encode_batch(model, short_batch)
        for cell in cells:
            idle, _, _ = profile_cell(lambda: decode_task.decode_batch(
                model, tok, short_batch, cell, dc, lm=scorer, enc=enc, enc_s=0.0))
            rec = next(iter(records[cell["name"]].values()))
            rows[cell["name"]] = dict(idle_short=idle, steps=rec.get("search_steps"),
                                      host_reads=rec.get("host_reads"))
        for s in summaries:
            rows[s["cell"]].update(rtf=s["rtf"], encoder_s=s["encoder_s"],
                                   search_s=s["search_s"], engine=s["engine"])
        profiled = time.perf_counter() - t1
        t1 = time.perf_counter()
        alone = [(c["name"], it["id"], decode_task.decode_batch(
            model, tok, collate_batch([it], pad_id=3, seed=0, epoch=0), c, dc,
            lm=scorer)[0]["hyp"]) for it in items for c in cells if c["search"] == "beam"]
        differ = sorted({(name, uid) for name, uid, hyp in alone
                         if hyp != records[name][uid]["hyp"]})
        log(f"  {engine}: bf16, each of the {DECODE_UTTS} utterances alone vs inside the "
            f"batch, 6 beam cells: {len(alone) - len(differ)}/{len(alone)} transcripts equal "
            f"({time.perf_counter() - t1:.1f} s; decode run {wall:.1f} s, profiled cells "
            f"{profiled:.1f} s)")
        if differ:
            raise AssertionError(f"{engine}: alone and batched transcripts differ: {differ}")
        if launches != 2 * SSD_CALLS_PER_FORWARD:
            raise AssertionError(f"{engine}: {launches} ssd_fwd launches in the decode run")
        bad = [s["cell"] for s in summaries if s["n_utts"] != DECODE_UTTS]
        if bad:
            raise AssertionError(f"{engine}: cells without a record for every utterance: {bad}")
        runs[engine] = dict(cells=rows, records=records, launches=launches, wall=wall)

    # the engines' disagreements, and which of them are ties
    agree = {}
    for name, dev_recs in runs["device"]["records"].items():
        n_diff, n_tie = 0, 0
        for uid, d in dev_recs.items():
            h = runs["lockstep"]["records"][name][uid]
            if d["hyp"] == h["hyp"]:
                continue
            n_diff += 1
            a, b = d["score"], h["score"]
            tie = (a is not None and b is not None
                   and abs(a - b) <= TIE_SHARE * max(abs(a), abs(b)))
            n_tie += tie
            log(f"    {name} {uid}: device {a} vs lockstep {b}: {'tie' if tie else 'no tie'}")
        agree[name] = {"differ": n_diff, "ties": n_tie}

    t1 = time.perf_counter()
    full_batch = next(iter(loader))
    K, P = GATE_DECODE["beam_size"], GATE_DECODE["pre_beam"]
    lm_w = GATE_DECODE["lm_weight"]
    with torch.inference_mode():
        enc, _ = decode_task.encode_batch(model, full_batch)
        lengths = enc.lengths.cpu().numpy()
        logp = model.ctc.log_probs(enc.features)
        B, T, W = logp.shape
        lm_cap = min(T + 1, device_ctc_beam.LM_CACHE_CAP)
        gen = torch.Generator(device="cuda").manual_seed(SEED)

        # where the CTC cells' disagreements come from: bf16 logits give
        # exactly equal log-probs, which the engines order differently (the
        # device's top_k: the lower class first; the host's reversed argsort:
        # the higher); the device search again in float64, then both engines
        # once the ties are broken by U(0, 1e-5) noise in float64
        valid = torch.arange(T, device="cuda")[None, :] < enc.lengths[:, None]
        top = torch.sort(logp[..., :W - 1], dim=-1, descending=True).values
        boundary_ties = (top[..., P - 1] == top[..., P])[valid].float().mean().item()
        untied = logp.double() + 1e-5 * torch.rand(logp.shape, generator=gen, device="cuda",
                                                   dtype=torch.float64)
        row_of = {u: i for i, u in enumerate(full_batch["ids"])}
        for name, w in (("ctc_beam", 0.0), ("ctc_beam_lm", lm_w)):
            host = runs["lockstep"]["records"][name]
            uids = [u for u, d in runs["device"]["records"][name].items()
                    if d["hyp"] != host[u]["hyp"]]
            if not uids:
                continue
            kw = dict(K=K, P=P, blank=W - 1, lm_weight=w, lm=lm.lm if w else None, lm_cap=lm_cap)
            toks, blen, _ = device_ctc_beam._beam_scan(logp.double(), enc.lengths, **kw)
            agree[name]["f64_equal"] = sum(
                tok.decode(toks[row_of[u], :int(blen[row_of[u]])].tolist()) == host[u]["hyp"]
                for u in uids)
            toks, blen, _ = device_ctc_beam._beam_scan(untied, enc.lengths, **kw)
            want = ctc_prefix_beam_search(untied.cpu().numpy(), lengths, blank_id=W - 1,
                                          beam_size=K, pre_beam=P, lm=scorer if w else None,
                                          lm_weight=w)
            agree[name]["untied_equal"] = sum(toks[b, :int(blen[b])].tolist() == want[b]
                                              for b in range(B))

        # kernel launches per step of each device search at the batch of 8:
        # its first STEP_PROBE frames / label steps under the profiler
        per_step = {}
        for name, w in (("ctc_beam", 0.0), ("ctc_beam_lm", lm_w)):
            _, kernels, _ = profile_cell(lambda: device_ctc_beam._beam_scan(
                logp[:, :STEP_PROBE], enc.lengths.clamp(max=STEP_PROBE), K=K, P=P,
                blank=W - 1, lm_weight=w, lm=lm.lm if w else None, lm_cap=lm_cap))
            per_step[name] = kernels / STEP_PROBE
        for name, ctc in (("aed_beam", None), ("joint_beam", logp)):
            st = {}
            idle, kernels, window = profile_cell(lambda: device_beam._beam_scan(
                model.aed, enc.features, lengths.tolist(),
                torch.full((B,), STEP_PROBE, device="cuda"), ctc, beam_size=K, nbest=1,
                length_bonus=0.0, pre=P, n_iters=STEP_PROBE,
                ctc_weight=GATE_DECODE["ctc_weight"] if ctc is not None else 0.0,
                blank=W - 1, stats=st))
            per_step[name] = kernels / st["steps"]
            if ctc is not None:
                step_ms = (1.0 - idle) * window * 1e3 / st["steps"]

        # the CTC prefix terms' share of a joint step, at the run's shapes
        C = P + 1
        r_state = torch.stack([-20.0 - torch.rand((B, K, T), generator=gen, device="cuda"),
                               torch.cumsum(logp[:, None, :, W - 1], -1).expand(B, K, T)], -1)
        cand = torch.randint(0, W - 1, (B, K, C), generator=gen, device="cuda")
        last_frame = torch.as_tensor(lengths - 1, device="cuda")
        t_mid = 16
        psi_ms = device_call_ms(lambda: device_beam._ctc_prefix_psi(
            logp, r_state, cand, cand[..., 0], t_mid, last_frame))
        scan_ms = device_call_ms(lambda: device_beam._ctc_advance_r(
            logp, r_state, cand[..., 1], cand[..., 0], t_mid, W - 1))
    shares = {"psi_ms": psi_ms, "r_scan_ms": scan_ms, "joint_step_device_ms": step_ms,
              "psi_share": psi_ms / step_ms, "r_scan_share": scan_ms / step_ms}
    for name, n in per_step.items():
        runs["device"]["cells"][name]["launches_per_step"] = n
    probes_s = time.perf_counter() - t1

    for s_name in runs["device"]["cells"]:
        for engine, _ in ENGINES:
            c = runs[engine]["cells"][s_name]
            extra = ""
            if engine == "device" and c["steps"] is not None:
                extra = (f"; {c['steps']} search steps, {c['host_reads']} host reads of the "
                         f"active mask")
            if engine == "device" and "launches_per_step" in c:
                extra += f", {c['launches_per_step']:.1f} device ops a step at B {B}"
            log(f"  {s_name:<14} {engine:<8} RTF {c['rtf']:.5f}: encoder {c['encoder_s']:.4f} s, "
                f"search {c['search_s']:.4f} s over {DECODE_UTTS} utterances "
                f"({total_audio:.2f} s of audio); device idle {c['idle_short']:.2%} (the 2 "
                f"shortest){extra}")
        a = agree[s_name]
        log(f"  {s_name:<14} engines differ on {a['differ']}/{DECODE_UTTS} utterances, "
            f"{a['ties']} of them ties"
            + (f"; with float64 scores the device search gives the lockstep transcript on "
               f"{a['f64_equal']} of them; with the exact ties broken, float64 device == "
               f"lockstep on {a['untied_equal']}/{B} utterances" if "f64_equal" in a else ""))
    log(f"  exact ties at the pre-beam boundary (the non-blank log-probs ranked {P} and "
        f"{P + 1} equal): {boundary_ties:.2%} of the frames")
    log(f"  joint step (B {B}, R {K}, C {C}, T {T}, step {t_mid}): psi {psi_ms:.4f} ms, r-scan "
        f"{scan_ms:.4f} ms of a {step_ms:.4f} ms device step ({shares['psi_share']:.1%}, "
        f"{shares['r_scan_share']:.1%}); probes {probes_s:.1f} s")
    log(f"  full width: {n_params:,} ASR parameters, LM "
        f"{sum(p.numel() for p in lm.parameters()):,}; {DECODE_UTTS} utterances of "
        f"{sorted(round(a, 2) for a in audio_s.values())} s in one batch, shared encoder: "
        f"ssd_fwd launches per engine {[runs[e]['launches'] for e, _ in ENGINES]} (the "
        f"untimed warm-up pass and the one timed pass, {SSD_CALLS_PER_FORWARD} each); "
        f"{sum(r['wall'] for r in runs.values()):.1f} s of decode runs; cuts: AED cap "
        f"{DECODE_CAP} tokens (seeded weights never emit eos)")
    if n_params != 78_858_409:
        raise AssertionError(f"full-width decode: {n_params} parameters")
    del model, lm, scorer, enc, logp, r_state, untied
    torch.cuda.empty_cache()
    log("phase 13 decode full width: ok")
    return {"engines": {e: {k: v for k, v in r.items() if k != "records"}
                        for e, r in runs.items()},
            "agree": agree, "boundary_ties": boundary_ties, "joint_shares": shares,
            "n_params": n_params}


# card against CPU: decode_step log-probs to 1e-5 of their max, fp32, TF32 off
STEP_BOUND = 1e-5
SMALL_CAP = 12


def phase_decode_parity(cmvn, tmp: Path) -> dict:
    """Depth 1 + 2 + 1, a 2-layer AED and a 2-layer LM, full width, fp32
    (intra off), TF32 off, seeded: decode_step log-probs card vs CPU; all 7
    cells' transcripts on 4 utterances of 1.5-3 s through both engines (the
    device searches and the host's), card == CPU for each engine and device
    == lockstep on each side; a request alone and inside the batch for
    ctc_beam_lm and joint_beam on the card, for each engine."""
    from hnet_mamba_asr_torch.data.dataset import collate_batch
    from hnet_mamba_asr_torch.decoders.lm_scorer import CausalLMScorer
    from hnet_mamba_asr_torch.tasks import decode_task
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tasks.lm_task import build_lm
    from hnet_mamba_asr_torch.tools.gate import GATE_DECODE, LM_CONFIG, seeded_tokenizer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = copy.deepcopy(GATE_CONFIG)
    cfg["train"]["precision"] = "fp32"
    cfg["encoder_conf"].update(n_enc=1, n_main=2, n_dec=1, ssd_intra_dtype=None)
    cfg["aed_conf"].update(n_layers=2, max_decode_len=SMALL_CAP)
    lm_cfg = {"lm_conf": dict(LM_CONFIG["lm_conf"], n_layers=2)}
    tok = seeded_tokenizer(tmp / "tok500_parity.model")
    items = decode_batch_items(np.random.default_rng(SEED + 60), 4, seconds=(1.5, 3.0))
    batch = collate_batch(items, pad_id=3, seed=0, epoch=0)
    hyps, steps, alone = {}, {}, {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, VOCAB, cmvn=cmvn, seed=SEED, device=dev)
        lm = build_lm(lm_cfg, VOCAB, seed=SEED, device=dev)
        scorer = CausalLMScorer(lm.lm, bos_id=tok.bos_id, eos_id=tok.eos_id, pad_id=tok.pad_id)
        enc, _ = decode_task.encode_batch(model, batch)
        with torch.no_grad():
            caches, kpm = model.aed.decode_start(enc.features, enc.lengths, SMALL_CAP + 1)
            rows = enc.features.shape[0]
            par = torch.arange(rows, device=dev)
            lp0, caches = model.aed.decode_step(caches, kpm, par, torch.full(
                (rows,), tok.bos_id, device=dev), 0)
            lp1, _ = model.aed.decode_step(caches, kpm, par.flip(0), torch.arange(
                5, 5 + rows, device=dev), 1)
        steps[dev] = (lp0.cpu(), lp1.cpu())
        for engine, change in ENGINES:
            dc = dict(GATE_DECODE, **change)
            cells = decode_task.expand_cells(dc)
            hyps[dev, engine] = {c["name"]: [r["hyp"] for r in decode_task.decode_batch(
                model, tok, batch, c, dc, lm=scorer, enc=enc, enc_s=0.0)] for c in cells}
            if dev == "cuda":
                for name in ("ctc_beam_lm", "joint_beam"):
                    cell = next(c for c in cells if c["name"] == name)
                    alone[engine, name] = [decode_task.decode_batch(
                        model, tok, collate_batch([it], pad_id=3, seed=0, epoch=0), cell, dc,
                        lm=scorer)[0]["hyp"] for it in items]
        del model, lm, scorer, enc
    # bos and pad sit at -1e9 on both sides; the bound reads the other classes
    keep = torch.ones(VOCAB, dtype=torch.bool)
    keep[[tok.bos_id, tok.pad_id]] = False
    step_err = max(((a - b)[:, keep].abs().max() / b[:, keep].abs().max()).item()
                   for a, b in zip(steps["cuda"], steps["cpu"]))
    log(f"  decode_step fp32 (TF32 off), 2 steps x {len(items)} rows: max|d|/max|log_prob| "
        f"{step_err:.3e} over the classes other than bos and pad (bound {STEP_BOUND:g})")
    if not step_err <= STEP_BOUND:
        raise AssertionError(f"decode_step log-probs part card vs CPU: {step_err:.3e}")
    failed = []
    pairs = [(f"{e} card == CPU", ("cuda", e), ("cpu", e)) for e, _ in ENGINES] + [
        (f"{d} device == lockstep", (d, "device"), (d, "lockstep")) for d in ("cuda", "cpu")]
    for label, a, b in pairs:
        differ = [n for n in hyps[b] if hyps[a][n] != hyps[b][n]]
        log(f"  {label}: {7 - len(differ)}/7 cells equal; "
            f"{sum(len(h.split()) for n in hyps[a] for h in hyps[a][n])} words over "
            f"{len(items)} utterances")
        for n in differ:
            log(f"    {n}: {hyps[a][n]} | {hyps[b][n]}")
            failed.append((label, n))
    for (engine, name), got in alone.items():
        ok = got == hyps["cuda", engine][name]
        log(f"  {engine} {name}: each of {len(items)} requests alone == inside the batch: {ok}")
        if not ok:
            failed.append((f"{engine} alone == batched", name))
    if failed:
        raise AssertionError(f"decode parity failed: {failed}")
    torch.cuda.empty_cache()
    log("phase 14 decode parity: ok")
    return {"step_err": step_err}


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
    modes = phase_serve_modes(cmvn)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        train = phase_train(cmvn, Path(tmp))
        train_n2 = phase_train_n2(cmvn, Path(tmp))
        phase_descent(cmvn, Path(tmp))
        phase_grads(cmvn)
        phase_grads(cmvn, N2_CONFIG, "n2")
        bench = phase_bench(Path(tmp))
        intra = phase_intra_blocks(cmvn)
        gate = phase_gate_proof(Path(tmp))
        matrix = phase_tone_matrix(Path(tmp))
        n2 = phase_n2_stability(Path(tmp))
        full = phase_decode_full(cmvn, Path(tmp))
        phase_decode_parity(cmvn, Path(tmp))
    log(f"training summary: gate config {train['step_ms']:.1f} ms per update of 2 x 32 x 10 s, "
        f"{train['fps']:.0f} mel-frames/s, peak {train['peak'] / 1e9:.2f} GB; N=2 config "
        f"{train_n2['step_ms']:.1f} ms per update of 64 x 10 s, {train_n2['fps']:.0f} "
        f"mel-frames/s, peak {train_n2['peak'] / 1e9:.2f} GB, kept fraction "
        f"{train_n2['kept']:.4f}, {train_n2['slots']} slots; bench.py step "
        f"{bench['none']['fps']:.0f} (32 x 10 s, remat none) and {bench['full']['fps']:.0f} "
        f"(64 x 10 s, remat full) mel-frames/s")
    log(f"decode summary: intra-bf16 mixers max|d|/max|mixer| "
        + ", ".join(f"{k} {v:.3e}" for k, v in intra["blocks"].items())
        + f" (bound {BLOCK_ROUNDINGS * 2.0 ** -8:.4f}), whole model log-prob "
        + ", ".join(f"{k} {v:.3e}" for k, v in intra["model"].items())
        + f"; gate proof dev WER {gate['dev_wer']}, test-clean {gate['gate']['wer']:.3f}; "
        f"tone matrix WER "
        + ", ".join(f"{k} {v['wer']:.2f}" for k, v in matrix.items())
        + f"; N=2 kept {n2['kept'][0]:.4f} -> {n2['kept'][-1]:.4f} over {n2['updates']} "
        f"updates; full-width RTF device / lockstep "
        + ", ".join(f"{k} {v['rtf']:.4f} / {full['engines']['lockstep']['cells'][k]['rtf']:.4f}"
                    for k, v in full["engines"]["device"]["cells"].items())
        + f"; engines differ {sum(a['differ'] for a in full['agree'].values())} times "
        f"({sum(a['ties'] for a in full['agree'].values())} ties); served beam_ids + aed_ids "
        f"{modes['batch_ms']:.1f} ms for 8 requests; {time.perf_counter() - t_start:.1f} s "
        f"in all")
    main_shape = ("bfloat16", TRAIN_ROWS, 249, 16)
    fwd = next(r for r in fwd_rows if (r["dtype"], r["B"], r["L"], r["H"]) == main_shape)
    bwd = next(r for r in bwd_rows if (r["dtype"], r["B"], r["L"], r["H"]) == main_shape
               and r["intra"] == "bf16")
    ema = next(r for r in ema_rows if (r["dtype"], r["B"], r["M"], r["D"], r["saturate"])
               == ("bfloat16", 64, 256, 384, False))
    log(f"kernel summary: ssd_fwd / ssd_bwd at bf16 (intra bf16) B{TRAIN_ROWS} L249 H16 P64 "
        f"N128 (a micro-batch of 32 x 10 s, main stack); ema_fwd / ema_bwd at bf16 B64 M256 "
        f"D384 (the dechunk of 64 x 10 s); launches: ssd_fwd from the full-width decode run "
        f"of the device engine (this slice's main path: one warm-up and one shared encoder "
        f"pass; its searches launch no hand kernel), the others from "
        f"the N=2 training run (3 micro-steps of 64 x 10 s, remat full), every path's in "
        f"launches_by_path; no single PyTorch call computes the scan, the EMA or their "
        f"gradients")
    by_path = {"decode_device_engine": {"ssd_fwd": full["engines"]["device"]["launches"]},
               "decode_lockstep": {"ssd_fwd": full["engines"]["lockstep"]["launches"]},
               "train_n2": train_n2["launches"],
               "gate_proof_tone_n1": gate["launches"],
               "train_gate": {"ssd_fwd": train["ssd_fwd"], "ssd_bwd": train["ssd_bwd"]}}
    launches = dict(train_n2["launches"], ssd_fwd=full["engines"]["device"]["launches"])
    ssd = lambda r: dict(max_abs_err=r["abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"], bound_by=r["bound_by"])
    ema_row = lambda k: dict(max_abs_err=ema["abs_err"][k], ms=ema["ms"][k],
                             plain_ms=ema["plain"][k], bound_ms=ema["cost"][k]["bound_ms"],
                             bound_by=ema["cost"][k]["bound_by"])
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"hnet_mamba_asr_torch/csrc/{source}",
         "replaces": replaces, "launches": launches[name],
         "launches_by_path": {k: v[name] for k, v in by_path.items() if name in v}, **row,
         "library_ms": None, "roofline_share": row["bound_ms"] / row["ms"]}
        for name, source, replaces, row in (
            ("ssd_fwd", "ssd_fwd.cu", "hnet_mamba_asr_tpu/ops/ssd_pallas.py:33", ssd(fwd)),
            ("ssd_bwd", "ssd_bwd.cu", "hnet_mamba_asr_tpu/ops/ssd.py:148", ssd(bwd)),
            ("ema_fwd", "ema.cu", "hnet_mamba_asr_tpu/ops/ema.py:34", ema_row("fwd")),
            ("ema_bwd", "ema.cu", "hnet_mamba_asr_tpu/ops/ema.py:34", ema_row("bwd")))]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
