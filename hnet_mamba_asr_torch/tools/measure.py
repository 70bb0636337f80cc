#!/usr/bin/env python3
"""Measurements of the port on one CUDA card, for PERF.md.

    python3 hnet_mamba_asr_torch/tools/measure.py ssd   [--repo DIR]
    python3 hnet_mamba_asr_torch/tools/measure.py ssd_bwd [--repo DIR]
    python3 hnet_mamba_asr_torch/tools/measure.py bwd_phases
    python3 hnet_mamba_asr_torch/tools/measure.py ema   [--repo DIR]
    python3 hnet_mamba_asr_torch/tools/measure.py ema_phases
    python3 hnet_mamba_asr_torch/tools/measure.py serve [--repo DIR] [--profile] [--config n2]
    python3 hnet_mamba_asr_torch/tools/measure.py phases
    python3 hnet_mamba_asr_torch/tools/measure.py train [--config n2|rnnt|moe]
    python3 hnet_mamba_asr_torch/tools/measure.py aed_step
    python3 hnet_mamba_asr_torch/tools/measure.py rnnt  [--repo DIR]
    python3 hnet_mamba_asr_torch/tools/measure.py stream

Run as a file, from the root of a checkout. ``--repo`` names the checkout
whose ``hnet_mamba_asr_torch`` is measured, this one
by default, so that two versions are timed by the same code: unpack the
other into a directory that ``.gitignore`` lists and run both in one chip
call, in turns (old, new, new, old).

- ``ssd``: the SSD kernel (``ssd_cuda``) at the serving shapes, B 1 and 8,
  L 248 / 873 / 1000, H 12 / 16, P 64, N 128, G 1, bf16 (with
  ``intra_dtype`` bf16 where the version takes it) and fp32. CUDA events
  over 20 back-to-back calls after 3 warm-ups on one input (L2 warm), and
  the kernel's own device time from a ``torch.profiler`` trace of 20 calls,
  and the host time a call takes to enqueue. One JSON line per shape with
  the three times and the bound of ``ssd_cost``.
- ``ssd_bwd``: the SSD backward kernel alone (``ssd_cuda._backward``, from
  the chunk states of one forward launch, kept) at ``chip_smoke.py``'s
  ``BWD_SHAPES`` (B 32 L 249 H 16 / 12, B 8 L 873 H 16, B 1 L 249 H 16),
  bf16 and fp32, ``intra_dtype`` bf16 and off: the kernels' device time
  per call (every kernel whose name holds ``ssd_bwd``), CUDA events around
  the call, and the bound of ``ssd_bwd_cost``; one JSON line per shape,
  with each kernel's own time. Run the two versions in turns in one call
  (old, new, new, old).
- ``bwd_phases``: where the bf16 backward's chunk-terms launch spends its
  time, at B 32 L 249 H 16: ``csrc/ssd_bwd.cu`` built again in a temporary
  directory as variants, one with the per-head copies cut (compute only),
  one with the compute cut (copies only), and with the copies cut, one per
  phase cut (the side warps' scalars, the Q x Q phase, the [Q][N]
  products, B D, the barrier before dx, dx); each variant's kernel time.
  The variants compute wrong gradients: only their times are read.
- ``ema``: the H-Net EMA kernels (``ops/ema_cuda.py``) at ``EMA_SHAPES``
  (``chip_smoke.py``'s), bf16 and fp32: the forward's and the backward's
  device time per call and device kernels per call, the plain version's
  time (``ema_smooth`` and autograd of it, CUDA events) and the bounds of
  ``ema_cost`` / ``ema_bwd_cost``, and a digest of zbar, dz and dP (two
  versions on the same inputs agree bitwise when their digests do); one
  JSON line per shape. It calls
  ``_forward`` / ``_backward``, whose arguments are the same in every
  version, so ``--repo`` times the parent too (old, new, new, old).
- ``ema_phases``: where an EMA CTA spends its time, from a build with
  ``-DEMA_PHASE_CLOCKS`` whose CTAs stamp the global timer at their phase
  bounds (``EMA_PHASES``): the call's span, the spread of the CTAs' starts
  and each phase's mean length, at bf16 B 64 M 256, B 8 M 880, B 1 M 880
  and B 1 M 64 (D 384).
- ``serve``: whole-model serve calls of the gate config (``--config n2``:
  configs/typeA_small_N2.yaml, its routers drawn at random so that they
  keep about half the frames) in bf16 with seeded weights, host clock
  around a synced call, 10 calls after 3 warm-ups, at 8 x 10 s, 1 x 35 s,
  8 x 35 s and 1 x 3 s. With ``--profile``, a ``torch.profiler`` window of
  3 calls at 8 x 10 s: device time by kernel and the device's idle share.
- ``phases``: where a bf16 kernel call spends its time, from a build with
  ``-DSSD_PHASE_CLOCKS`` whose CTAs stamp the global timer at the bounds of
  their first round (loads, state term, cluster barrier, chain, barrier,
  output). Mean phase lengths over the CTAs, at B 8 L 248 / 873 H 16 and
  B 1 L 873 H 12.
- ``train``: one update of the gate config's training step (``measure_train``;
  ``--config n2``: the N = 2 config's, one micro-batch of 64 x 10 s, remat
  full, with the routers at their init and drawn at random; ``--config
  rnnt``: the gate config with the RNN-T head, ``--config moe``: with the
  MoE AED decoder, both as the gate config's update): forward /
  backward / optimizer device time by CUDA events, the kept fraction and
  the buffer's slots, then a profiled update's device time by kernel and
  idle share.
- ``aed_step``: one AED decode step of the full-width decode run with the
  attention grouped per utterance or not and the GEMMs in row blocks or
  not (``measure_aed_step``).
- ``rnnt``: the RNN-T loss through ``rnnt_loss_cuda`` at ``RNNT_SHAPES``
  and the edge rows (``chip_smoke.py``'s), bf16 and fp32 logits (the
  joint's padded GEMM output): forward and backward to the logits, CUDA
  events per call, the device time of every kernel a call runs and of the
  loss kernels among them, the bounds of ``rnnt_cost`` / ``rnnt_bwd_cost``
  and the plain ``rnnt_loss``'s time (forward, and autograd to the
  logits); one JSON line per shape. The entry is the same in every
  version (a parent without ``classes`` gets the logits sliced, as its
  head passed them), so ``--repo`` times the parent too (old, new, new,
  old). ``train --config rnnt`` adds one micro-step's device time by
  kernel class on the joint's lattice (``rnnt_step_profile``).
- ``stream``: streaming ticks (``measure_stream``): the causal gate config
  and its N = 2 sibling (routers drawn at random) through a
  ``StreamingSessionPool`` at B 1 and 8 sessions, ``block_enc`` 16 (640 ms
  of audio a tick), each session fed one block a round (``feed_many``):
  a tick's host time (the round, synced), its device time and the
  device's idle share (a ``torch.profiler`` window of 5 ticks), the
  launches of ``ssd_fwd`` and ``ema_fwd`` a tick, and the real-time factor
  of a session (tick time / 640 ms); then the carried ``ema_fwd``
  (``ema_stream_cuda``) at ``EMA_STREAM_SHAPES``: device time, the plain
  ``ema_stream``'s, the bound of ``ema_stream_cost`` (which counts z and P
  on the real rows only).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}    # fp32: SIMT, no tensor cores
CHUNK = 64                                             # the kernel's chunk length


def ssd_cost(Bsz: int, L: int, H: int, G: int, P: int, N: int, dtype: str) -> dict:
    """Least time of one SSD forward on the H100: each input read once and y
    written once, against the FLOPs of the chunked form at the kernel's chunk
    length over the chunks this L needs: C.B^T once per group (the heads of
    a group share it), and per head W.x, the state update B'^T.x and C.S."""
    es = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * Bsz * L * H * P * es          # x in, y out
              + 2 * Bsz * L * G * N * es        # B, C
              + Bsz * L * H * 4 + H * 4)        # dt, A
    K = -(-L // CHUNK)
    flops = Bsz * K * 2 * (G * CHUNK * CHUNK * N
                           + H * (CHUNK * CHUNK * P + 2 * CHUNK * N * P))
    return _bound(nbytes, flops, dtype)


def ssd_bwd_cost(Bsz: int, L: int, H: int, G: int, P: int, N: int, dtype: str) -> dict:
    """Least time of one SSD backward (the VJP of ``ssd_chunked`` given dy)
    on the H100: x, dy, B, C, dt and A read once and dx, dB, dC, ddt and dA
    written once (the chunk states the kernel reads are the design's, not
    the function's), against the FLOPs of the chunked backward over the
    chunks this L needs. Once per group: C.B^T, and dCB^T.C and dCB.B for
    the intra-chunk dB and dC, where dCB is the sum over the group's heads
    of each head's masked, decayed dy.x^T (elementwise, not a product). Per
    head: dy.x^T, W^T.dy, and B.D, x.D^T, dy.S^T and C^T.dy against the
    state's gradient D and the state S."""
    es = 2 if dtype == "bfloat16" else 4
    nbytes = (3 * Bsz * L * H * P * es          # x, dy in; dx out
              + 4 * Bsz * L * G * N * es        # B, C in; dB, dC out
              + 2 * Bsz * L * H * 4 + 2 * H * 4)  # dt in, ddt out; A in, dA out
    K = -(-L // CHUNK)
    flops = Bsz * K * 2 * (3 * G * CHUNK * CHUNK * N
                           + H * (2 * CHUNK * CHUNK * P + 4 * CHUNK * N * P))
    return _bound(nbytes, flops, dtype)


def ema_cost(Bsz: int, M: int, D: int, dtype: str) -> dict:
    """Least time of one EMA forward on the H100: z read once, zbar written
    once, P read once; 3 FLOPs per element (the recurrence's two products
    and a sum) at the fp32 SIMT rate."""
    es = 2 if dtype == "bfloat16" else 4
    return _bound(2 * Bsz * M * D * es + Bsz * M * 4, 3 * Bsz * M * D, "float32")


def ema_bwd_cost(Bsz: int, M: int, D: int, dtype: str) -> dict:
    """Least time of one EMA backward given dL/dzbar: z, zbar, g and P read
    once, dz and dP written once (zbar is what the function needs of the
    forward); ~6 FLOPs per element (h, dz, the dP term and its sum)."""
    es = 2 if dtype == "bfloat16" else 4
    return _bound(4 * Bsz * M * D * es + 2 * Bsz * M * 4, 6 * Bsz * M * D, "float32")


def ema_stream_cost(n_real, M: int, D: int, dtype: str) -> dict:
    """Least time of one carried EMA forward over a block of M slots whose
    row b is real up to ``n_real[b]``: z and P read on the real rows only (a
    padding row emits the carry and needs neither), zbar written on every
    row, the counts read, the carry (fp32) and ``has`` read once and
    written once; 3 FLOPs per real element as ``ema_cost``."""
    es = 2 if dtype == "bfloat16" else 4
    counts = torch.as_tensor(n_real).tolist()
    Bsz, real = len(counts), int(sum(counts))
    return _bound(real * (D * es + 4) + Bsz * M * D * es + Bsz * 4 + 2 * Bsz * (4 * D + 1),
                  3 * real * D, "float32")


def _lattice_cells(feat_lens, tgt_lens, T: int, U: int) -> tuple[int, int]:
    """(cells, label cells) of the rows' lattices: T_b (U_b + 1) and T_b U_b,
    T_b = clamp(feat_length, 1, T), U_b = clamp(target_length, 0, U)."""
    tb = np.clip(np.asarray(feat_lens), 1, T)
    ub = np.clip(np.asarray(tgt_lens), 0, U)
    return int((tb * (ub + 1)).sum()), int((tb * ub).sum())


def rnnt_cost(feat_lens, tgt_lens, T: int, U: int, V: int, itemsize: int) -> dict:
    """Least time of the RNN-T loss's forward from the logits on the H100,
    for this run's lengths: the V logits of every lattice cell read once
    (``itemsize`` bytes each), its lse and blank share written once (fp32),
    the targets and lengths read and the loss written; ~5 fp32 operations a
    logit (the max, the difference, its scale, exp and the sum) at the SIMT
    rate."""
    n1, _ = _lattice_cells(feat_lens, tgt_lens, T, U)
    B = len(np.asarray(feat_lens))
    return _bound(n1 * V * itemsize + 8 * n1 + 4 * B * (U + 3), 5 * n1 * V, "float32")


def rnnt_bwd_cost(feat_lens, tgt_lens, T: int, U: int, V: int, cols: int,
                  itemsize: int) -> dict:
    """Least time of the RNN-T loss's backward given the loss's gradient:
    the logits of every lattice cell read once, dlogits written once over
    the whole [B, T, U+1, cols] buffer (zeros outside the lattices and in
    the pad columns), lse and the shares of every lattice cell read, the
    coefficients cb and cl of every cell written; ~5 fp32 operations a logit
    (the difference, its scale, exp, the multiply-add, the one-hot term)."""
    n1, _ = _lattice_cells(feat_lens, tgt_lens, T, U)
    B = len(np.asarray(feat_lens))
    rows = B * T * (U + 1)
    return _bound(n1 * V * itemsize + rows * cols * itemsize + 8 * n1 + 8 * rows
                  + 4 * B * (U + 3), 5 * n1 * V, "float32")


def _bound(nbytes: int, flops: int, dtype: str) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bytes": nbytes, "flops": flops, "bytes_us": t_bytes * 1e6,
            "ops_us": t_ops * 1e6, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def cuda_ms(fn, n: int = 20, flush: torch.Tensor | None = None) -> float:
    """Mean ms of ``fn`` on the device: CUDA events around n launches after
    3 warm-ups; with ``flush``, each launch timed alone after rewriting that
    buffer (L2 cold)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n
    pairs = []
    for i in range(n):
        flush.fill_(float(i))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / n


def digest(*tensors) -> str:
    """A short hash of the tensors' bytes: two versions' results on the same
    inputs are bitwise equal when their digests are."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def device_us(event) -> float:
    """Self device time of a profiler ``key_averages`` row, in us."""
    t = getattr(event, "self_device_time_total", None)
    return getattr(event, "self_cuda_time_total", 0.0) if t is None else t


def device_rows(prof) -> list[tuple[float, str, int]]:
    """(self device us, name, count) of the profiler rows that ran on the
    device (kernels, copies, sets), largest first. An operator's row
    repeats the device time of the kernels it launched, so summing every
    row with device time counts that time twice."""
    from torch.autograd import DeviceType
    rows = [(device_us(ev), ev.key, ev.count) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and device_us(ev) > 0]
    return sorted(rows, reverse=True)


def kernel_ms(fn, match: str, n: int = 20, tries: int = 3) -> float | None:
    times = kernel_times(fn, match, n, tries)
    return sum(times.values()) if times else None


def kernel_times(fn, match: str, n: int = 20, tries: int = 3) -> dict:
    """Mean device time in ms that one call of ``fn`` spends in each kernel
    whose name contains ``match`` (each launched once per call; a call may
    launch several), from a ``torch.profiler`` trace of n calls after 3
    warm-ups: the kernels' own time, without the host's launch gaps that
    ``cuda_ms`` includes. Each kernel's time is its mean over the launches
    the trace holds (a trace now and then comes back with fewer or no device
    events); ``kernel_ms`` is a call's time, the sum of those means, or None
    after ``tries`` traces without any."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [ev for ev in prof.key_averages() if match in ev.key and device_us(ev) > 0]
        if rows:
            return {ev.key: device_us(ev) / ev.count / 1e3 for ev in rows}
    return {}


def kernel_launches(fn, match: str, n: int = 10, tries: int = 3) -> float | None:
    """Device kernels whose name contains ``match`` that one call of ``fn``
    launches, from ``torch.profiler`` traces of n calls after a warm-up: the
    most any of ``tries`` traces holds (a trace now and then comes back with
    fewer device events than ran, never more; None when none holds such a
    kernel)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        most = max(most, sum(ev.count for ev in prof.key_averages()
                             if match in ev.key and device_us(ev) > 0))
    return most / n if most else None


def host_us(fn, n: int = 50) -> float:
    """Mean host time in us of one call of ``fn``: what the caller's thread
    spends to enqueue it (the device is not waited for)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def ssd_inputs(Bsz, L, H, dtype, seed=0, P=64, N=128):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(Bsz, L, H, P, generator=gen).to("cuda", dtype),
            (torch.rand(Bsz, L, H, generator=gen) * 0.2 + 0.001).cuda(),
            (-(torch.rand(H, generator=gen) * 15 + 1)).cuda(),
            torch.randn(Bsz, L, 1, N, generator=gen).to("cuda", dtype),
            torch.randn(Bsz, L, 1, N, generator=gen).to("cuda", dtype))


def measure_ssd(tag: str) -> None:
    import inspect

    from hnet_mamba_asr_torch.ops import ssd_cuda as mod
    mod.build()
    takes_intra = "intra_dtype" in inspect.signature(mod.ssd_cuda).parameters
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        kw = {"intra_dtype": "bf16"} if takes_intra and dtype == torch.bfloat16 else {}
        for Bsz in (8, 1):
            for L in (248, 873, 1000):
                for H in (12, 16):
                    args = ssd_inputs(Bsz, L, H, dtype)
                    call_ms = cuda_ms(lambda: mod.ssd_cuda(*args, **kw))
                    ms = kernel_ms(lambda: mod.ssd_cuda(*args, **kw), "ssd_fwd")
                    host = host_us(lambda: mod.ssd_cuda(*args, **kw))
                    cost = ssd_cost(Bsz, L, H, 1, 64, 128, name)
                    print(json.dumps({"version": tag, "dtype": name, "intra": kw.get("intra_dtype"),
                                      "B": Bsz, "L": L, "H": H, "ms": ms, "call_ms": call_ms,
                                      "host_us": host,
                                      "bound_ms": cost["bound_ms"], "bound_by": cost["bound_by"],
                                      "share": cost["bound_ms"] / ms if ms else None}),
                          flush=True)


BWD_SHAPES = ((32, 249, 16), (32, 249, 12), (8, 873, 16), (1, 249, 16))   # chip_smoke.py's
# the EMA's [B, M, D]: training micro-batches of 64 x 10 s (M <= 128 or 256
# slots of the compressed buffer), a 35 s utterance's 880 slots at N = 1 of
# stage 1, Type B's stage 2 (D 512), one short request, and a 35 s request
# served alone at N = 2 (M <= L: the longest buffer it can have)
EMA_SHAPES = ((64, 128, 384), (64, 256, 384), (8, 880, 384), (32, 128, 512), (1, 64, 384),
              (1, 880, 384))


# the carried EMA: the streaming shape (B 8 sessions, a block of 16 rows,
# d_outer 384) and the dechunk's training shape
EMA_STREAM_SHAPES = ((8, 16, 384), (64, 256, 384))


def ema_stream_inputs(Bsz, M, D, seed=0):
    """(z, P, n_real, carry) of a block on the card, fp32: P saturated at
    every 5th slot, real counts from 0 to M, a mix of ``has``."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn(Bsz, M, D, generator=gen)
    p = torch.rand(Bsz, M, generator=gen)
    p[:, ::5] = 1.0
    n_real = torch.randint(0, M + 1, (Bsz,), generator=gen)
    n_real[0], n_real[-1] = 0, M
    carry = {"ema": torch.randn(Bsz, D, generator=gen),
             "has": torch.rand(Bsz, generator=gen) < 0.7}
    return (z.cuda(), p.cuda(), n_real.cuda(), {k: v.cuda() for k, v in carry.items()})


def ema_inputs(Bsz, M, D, dtype, seed=0, saturate=False):
    """z [B, M, D] and P [B, M] on the card: P in (0.1, 0.9), or with
    saturate every 10th slot at 1 (a hard boundary) and the next 5th at 0
    (a pad slot)."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn(Bsz, M, D, generator=gen).to("cuda", dtype)
    p = torch.rand(Bsz, M, generator=gen) * 0.8 + 0.1
    if saturate:
        p[:, ::10] = 1.0
        p[:, 5::10] = 0.0
    return z, p.cuda()


def measure_ema(tag: str) -> None:
    from hnet_mamba_asr_torch.ops import ema_cuda as mod
    from hnet_mamba_asr_torch.ops.ema import ema_smooth
    mod.build()
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for Bsz, M, D in EMA_SHAPES:
            z, p = ema_inputs(Bsz, M, D, dtype)
            g = torch.randn(z.shape, generator=torch.Generator().manual_seed(1)).to("cuda", dtype)
            zbar = mod._forward(z, p, 1e-4)
            dz, dp = mod._backward(z, p, zbar, g, 1e-4)
            fwd = lambda: mod._forward(z, p, 1e-4)
            bwd = lambda: mod._backward(z, p, zbar, g, 1e-4)
            zl, pl = z.clone().requires_grad_(), p.clone().requires_grad_()
            y_plain = ema_smooth(zl, pl)
            row = {"version": tag, "dtype": name, "B": Bsz, "M": M, "D": D,
                   "digest": digest(zbar, dz, dp), "fwd_ms": kernel_ms(fwd, "ema_fwd"), "fwd_call_ms": cuda_ms(fwd),
                   "bwd_ms": kernel_ms(bwd, "ema_bwd"), "bwd_call_ms": cuda_ms(bwd),
                   "fwd_launches": kernel_launches(fwd, "ema_fwd"),
                   "bwd_launches": kernel_launches(bwd, "ema_bwd"),
                   "plain_fwd_ms": cuda_ms(lambda: ema_smooth(z, p)),
                   "plain_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
                       y_plain, (zl, pl), g, retain_graph=True, allow_unused=True))}
            for key, cost in (("fwd", ema_cost(Bsz, M, D, name)),
                              ("bwd", ema_bwd_cost(Bsz, M, D, name))):
                ms = row[f"{key}_ms"]
                row.update({f"{key}_bound_ms": cost["bound_ms"],
                            f"{key}_bound_by": cost["bound_by"],
                            f"{key}_share": cost["bound_ms"] / ms if ms else None})
            print(json.dumps(row), flush=True)


# the phases an EMA CTA stamps (-DEMA_PHASE_CLOCKS), in order
EMA_PHASES = {"fwd": ("ticket", "loads", "pass 1", "publish aggregate and look-back",
                      "barrier", "publish prefix", "pass 2", "store"),
              "bwd": ("ticket", "loads of g", "pass 1", "publish aggregate and look-back",
                      "barrier", "publish prefix", "loads of z, zbar", "pass 2", "dP partials",
                      "counter and store of dz", "dP sum")}


def measure_ema_phases(tag: str) -> None:
    """Where a CTA of the EMA kernels spends its time: a build with
    -DEMA_PHASE_CLOCKS whose CTAs stamp the global timer at their phase
    bounds; per direction and bf16 shape the call's span, the spread of the
    CTAs' starts, and each phase's mean length over the CTAs."""
    from hnet_mamba_asr_torch.ops import ema_cuda as mod
    lib = mod.build(("EMA_PHASE_CLOCKS",))
    lib.hnet_ema_phase_times.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hnet_ema_phase_times.restype = ctypes.c_int
    for Bsz, M, D in ((64, 256, 384), (8, 880, 384), (1, 880, 384), (1, 64, 384)):
        z, p = ema_inputs(Bsz, M, D, torch.bfloat16)
        g = torch.randn(z.shape, generator=torch.Generator().manual_seed(1)
                        ).to("cuda", torch.bfloat16)
        zbar = mod._forward(z, p, 1e-4)
        n = Bsz * -(-M // 64) * -(-D // 128)
        for way, run in (("fwd", lambda: mod._forward(z, p, 1e-4)),
                         ("bwd", lambda: mod._backward(z, p, zbar, g, 1e-4))):
            for _ in range(4):
                run()
            torch.cuda.synchronize()
            stamps = np.zeros((n, 16), np.uint64)
            if lib.hnet_ema_phase_times(stamps.ctypes.data, n) != 0:
                raise RuntimeError("could not read the phase stamps")
            k = len(EMA_PHASES[way]) + 1
            t = stamps[:, :k].astype(np.float64) / 1e3                  # us
            d = np.diff(t, axis=1)
            print(json.dumps({"version": tag, "way": way, "B": Bsz, "M": M, "D": D,
                              "ctas": n, "span_us": float(t[:, -1].max() - t[:, 0].min()),
                              "start_spread_us": float(t[:, 0].max() - t[:, 0].min()),
                              "cta_us": float((t[:, -1] - t[:, 0]).mean()),
                              "phases_us": {name: float(d[:, i].mean())
                                            for i, name in enumerate(EMA_PHASES[way])}}),
                  flush=True)


def measure_ssd_bwd(tag: str) -> None:
    """The backward kernel alone, through the version's own ``_forward`` /
    ``_backward`` (whose arguments are the same in every version)."""
    from hnet_mamba_asr_torch.ops import ssd_cuda as mod
    mod.build()
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for intra in (True, False):
            for Bsz, L, H in BWD_SHAPES:
                args = ssd_inputs(Bsz, L, H, dtype, seed=5)
                dy = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(6)
                                 ).to("cuda", dtype)
                _, _, states = mod._forward(*args, None, False, intra, keep_states=True)
                run = lambda: mod._backward(*args, states, dy, None, intra, False)
                call_ms = cuda_ms(run)
                times = kernel_times(run, "ssd_bwd")
                ms = sum(times.values()) if times else None
                cost = ssd_bwd_cost(Bsz, L, H, 1, 64, 128, name)
                print(json.dumps({"version": tag, "kernel": "ssd_bwd", "dtype": name,
                                  "intra": "bf16" if intra else None, "B": Bsz, "L": L, "H": H,
                                  "ms": ms, "call_ms": call_ms, "bound_ms": cost["bound_ms"],
                                  "bound_by": cost["bound_by"],
                                  "share": cost["bound_ms"] / ms if ms else None,
                                  "kernels_ms": {re.search(r"ssd_bwd\w*", k).group(0): v
                                                 for k, v in times.items()}}),
                      flush=True)
                del states


# launch 2's phases, cut from a copy of its source by these markers
BWD_CUTS = {
    "side warps": ("    // two warps without a Q x Q tile", "    // ---- Q x Q: dW = dy x^T"),
    "Q x Q": ("    // ---- Q x Q: dW = dy x^T", "    // ---- [Q][N], columns"),
    "[Q][N] products": ("    // ---- [Q][N], columns", "    // ---- u = B D for dx's rows"),
    "B D": ("    // ---- u = B D for dx's rows", "    __syncthreads();                // W is in"),
    "barrier before dx": ("    __syncthreads();                // W is in",
                          "    // ---- dx = W^T dy + coef * u"),
    "dx": ("    // ---- dx = W^T dy + coef * u", "  __syncthreads();                  // the last"),
}
NEXT_HEAD_COPIES = "    if (i + 1 < nh)                 // the next head's copies fly while"


def measure_bwd_phases(tag: str) -> None:
    from hnet_mamba_asr_torch.ops import cuda_build
    from hnet_mamba_asr_torch.ops import ssd_cuda as mod
    bwd = mod.build()["bwd"]
    source, (header,) = cuda_build.SOURCES["ssd_bwd"]
    src = source.read_text()

    def cut(text: str, start: str, end: str, keep_tail: str = "") -> str:
        a, b = text.index(start), text.index(end)
        return text[:a] + "#if 0\n" + text[a:b] + "#endif\n" + keep_tail + text[b:]

    no_copies = src.replace(NEXT_HEAD_COPIES, "    if (false)  //")
    # the dx cut ends at the head loop's closing brace, which stays
    dx_a, dx_b = BWD_CUTS["dx"]
    loop_end = src.rindex("  }\n", 0, src.index(dx_b))
    variants = {"whole": src, "copies cut (compute only)": no_copies,
                "compute cut (copies only)": src[:src.index(BWD_CUTS["Q x Q"][0])] + "#if 0\n"
                + src[src.index(BWD_CUTS["Q x Q"][0]):loop_end] + "#endif\n" + src[loop_end:]}
    for phase, (a, b) in BWD_CUTS.items():
        if phase == "dx":
            end = no_copies.rindex("  }\n", 0, no_copies.index(dx_b))
            i = no_copies.index(dx_a)
            variants[f"copies and {phase} cut"] = (no_copies[:i] + "#if 0\n" + no_copies[i:end]
                                                   + "#endif\n" + no_copies[end:])
        else:                       # dx still reads u when B D is cut
            variants[f"copies and {phase} cut"] = cut(
                no_copies, a, b, "    float u[2][4] = {};\n" if phase == "B D" else "")
    args = ssd_inputs(32, 249, 16, torch.bfloat16, seed=5)
    dy = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(6)).to("cuda", args[0].dtype)
    _, _, states = mod._forward(*args, None, False, True, keep_states=True)
    with tempfile.TemporaryDirectory(prefix="bwd_phases_") as tmp:
        shutil.copy(header, tmp)
        jobs = {}
        for i, (name, text) in enumerate(variants.items()):
            path = Path(tmp) / f"v{i}.cu"
            path.write_text(text)
            jobs[name] = (path.with_suffix(".so"), subprocess.Popen(
                [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(path.with_suffix(".so")), str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (lib_path, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on the variant {name!r}:\n{out}")
            lib = ctypes.CDLL(str(lib_path))
            for fn in ("hnet_ssd_bwd_bf16", "hnet_ssd_bwd_bf16_splits", "hnet_ssd_bwd_supported"):
                getattr(lib, fn).argtypes = getattr(bwd, fn).argtypes
                getattr(lib, fn).restype = getattr(bwd, fn).restype
            mod._loaded["bwd"] = lib
            mod._loaded["libs"][(64, 128)] = (mod._loaded["lib"], lib)
            times = kernel_times(lambda: mod._backward(*args, states, dy, None, True, False),
                                 "ssd_bwd_chunk")
            print(json.dumps({"version": tag, "bwd_phases": name, "B": 32, "L": 249, "H": 16,
                              "chunk_kernel_ms": sum(times.values()) if times else None}),
                  flush=True)
    mod._loaded["bwd"] = bwd
    mod._loaded["libs"][(64, 128)] = (mod._loaded["lib"], bwd)


PHASES = ("loads of x, B, dt", "cumsum + state term", "cluster barrier 1", "chain",
          "cluster barrier 2", "output (C wait, W, products, store)")


def measure_phases(tag: str) -> None:
    from hnet_mamba_asr_torch.ops import ssd_cuda as mod
    lib = mod.build(("SSD_PHASE_CLOCKS",))["lib"]
    lib.hnet_ssd_fwd_phase_times.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hnet_ssd_fwd_phase_times.restype = ctypes.c_int
    for Bsz, L, H in ((8, 248, 16), (8, 873, 16), (1, 873, 12)):
        args = ssd_inputs(Bsz, L, H, torch.bfloat16)
        for _ in range(4):
            mod.ssd_cuda(*args, intra_dtype="bf16")
        torch.cuda.synchronize()
        n = lib.hnet_ssd_fwd_bf16_cluster_size(L) * H * Bsz
        stamps = np.zeros((n, 8), np.uint64)
        if lib.hnet_ssd_fwd_phase_times(stamps.ctypes.data, n) != 0:
            raise RuntimeError("could not read the phase stamps")
        t = stamps[:, :7].astype(np.float64) / 1e3                 # us
        d = np.diff(t, axis=1)
        print(json.dumps({"version": tag, "B": Bsz, "L": L, "H": H, "ctas": n,
                          "span_us": float(t[:, 6].max() - t[:, 0].min()),
                          "cta_round0_us": float((t[:, 6] - t[:, 0]).mean()),
                          "phases_us": {k: float(d[:, i].mean()) for i, k in enumerate(PHASES)}}),
              flush=True)


# the RNN-T loss's [B, T, U]: a training micro-batch of 32 x 10 s (U 64
# tokens at most), the full-width decode batch (8 utterances, T 380, 128
# ids), a 35 s utterance (T 880, 256 ids) and the AED cap of U 512; then
# the edge rows (T_b 1, U_b 0, feat_length 0, rows shorter than the batch,
# a target equal to the blank and one past V)
RNNT_SHAPES = ((32, 249, 64), (8, 380, 128), (1, 880, 256), (2, 300, 512))
RNNT_EDGE = ((6, 40, 12), ((40, 12), (1, 5), (17, 0), (0, 3), (25, 7), (1, 0)))
RNNT_EDGE_TARGETS = ((0, 3, 500), (4, 1, 777))     # (row, label, id)
RNNT_CLASSES = 501          # bpe_500's V + 1, the blank last
RNNT_BLANK = 500
RNNT_COLS = 504             # the joint GEMM's columns (models/rnnt.py::OUT_COLS)


def rnnt_inputs(Bsz: int, T: int, U: int, dtype=torch.bfloat16, seed: int = 0, lengths=None):
    """(logits [B, T, U+1, RNNT_COLS] in ``dtype``, targets [B, U],
    feat_lengths, target_lengths) on the card: the joint's padded GEMM
    output, RNNT_CLASSES classes of N(0, 4) logits and the pad columns set
    to 1e4, which the kernels must not read; targets in [0, RNNT_BLANK);
    the row lengths given as (T_b, U_b) pairs (then RNNT_EDGE_TARGETS as
    well), or drawn in [T/2, T] and [U/2, U] with the first row full."""
    gen = torch.Generator().manual_seed(seed)
    if lengths is None:
        fl = torch.randint(T // 2, T + 1, (Bsz,), generator=gen)
        tl = torch.randint(U // 2, U + 1, (Bsz,), generator=gen)
        fl[0], tl[0] = T, U
    else:
        fl, tl = (torch.tensor(x) for x in zip(*lengths))
    targets = torch.randint(0, RNNT_BLANK, (Bsz, U), generator=gen)
    if lengths is not None:
        for b, u, y in RNNT_EDGE_TARGETS:
            targets[b, u] = y
    cuda_gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.empty((Bsz, T, U + 1, RNNT_COLS), dtype=dtype, device="cuda")
    for b in range(Bsz):                 # a row at a time in fp32
        logits[b] = torch.randn((T, U + 1, RNNT_COLS), generator=cuda_gen, device="cuda") * 2
    logits[..., RNNT_CLASSES:] = 1e4
    return logits, targets.cuda(), fl.cuda(), tl.cuda()


# the loss kernels against the plain pair (ops/rnnt_loss.py::rnnt_fwd_plain,
# rnnt_bwd_plain) on the same logits: the loss to RNNT_LOSS_RTOL of itself
# against the plain pair in fp32; cb and cl (the gradients of the blank and
# label scores) against the plain pair in fp64 to RNNT_GRAD_BOUND of their
# largest; and the alignment mass. Every alignment leaves each frame t < T_b
# by one blank and emits each label u < U_b once, so a row's cb summed over
# u is -g_b at every such frame and its cl summed over t is -g_b at every
# such label. The sums are held to RNNT_MASS_BOUND of |g_b|: a fault on
# cells of low occupancy, which the bound on the largest gradient cannot
# see, moves them (rnnt_faults). dlogits against the plain pair in fp64:
# one rounding to the logits' dtype of each element (RNNT_ROUNDING of it)
# plus RNNT_GRAD_BOUND of their largest. Each lattice cell's dlogits summed
# over v is 0 (the softmax sums to 1): held to RNNT_CELL_BOUND of |cb| +
# |cl| at the cell (bf16: up to 2 (|cb| + |cl|) of terms, each rounded by
# 2^-8 of itself at most), plus V steps of the dtype's smallest subnormal
# where a cell's terms underflow; this is the check that sees a softmax
# term dropped on cells of low occupancy.
RNNT_LOSS_RTOL = 1e-5
RNNT_GRAD_BOUND = 2e-3
RNNT_MASS_BOUND = 1e-5
RNNT_ROUNDING = {torch.float64: 0.0, torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}
RNNT_CELL_BOUND = {torch.float64: 1e-5, torch.float32: 1e-5, torch.bfloat16: 1e-2}
RNNT_SUBNORMAL = {torch.float64: 2.0 ** -1074, torch.float32: 2.0 ** -149,
                  torch.bfloat16: 2.0 ** -133}


def lattice_masks(feat_lens, tgt_lens, T: int, U: int):
    """(cells [B, T, U+1], label cells [B, T, U]) bool masks of each row's
    lattice."""
    dev = feat_lens.device
    t = torch.arange(T, device=dev)[None, :, None]
    u = torch.arange(U + 1, device=dev)[None, None, :]
    tb = feat_lens.clamp(1, T)[:, None, None]
    ub = tgt_lens.clamp(0, U)[:, None, None]
    return (t < tb) & (u <= ub), (t < tb) & (u[..., :U] < ub)


def rnnt_result(loss, dlogits, cb, cl) -> tuple:
    """A pair's outputs (``_forward``'s loss, ``_backward``'s dlogits, cb,
    cl, or the plain pair's) as ``rnnt_check`` takes them: (loss, cb
    [B, T, U+1], cl [B, T, U], dlogits)."""
    from hnet_mamba_asr_torch.ops.rnnt_loss import unskew
    T = dlogits.shape[1]
    return loss, unskew(cb, T), unskew(cl, T)[..., :-1], dlogits


def rnnt_pair(fwd, bwd, logits, targets, feat_lens, tgt_lens, g, classes=None,
              blank_id: int = RNNT_BLANK) -> tuple:
    """A forward and backward pair (the kernels' ``_forward`` / ``_backward``
    or the plain ``rnnt_fwd_plain`` / ``rnnt_bwd_plain``) on the logits, as
    ``rnnt_check`` takes their results (``rnnt_result``)."""
    args = (targets, feat_lens, tgt_lens, blank_id)
    loss, lse, w = fwd(logits, *args, classes)
    return rnnt_result(loss, *bwd(logits, lse, w, *args, g, classes))


def rnnt_check(got, ref, ref64, feat_lens, tgt_lens, g, classes: int) -> dict:
    """Hold the kernels' (loss, cb, cl, dlogits) (``rnnt_result``) against
    the plain pair's in fp32 (``ref``) and fp64 (``ref64``) for incoming
    gradients ``g``: the readings, and ``ok`` when each is within its bound
    and every value is finite and exactly 0 outside the lattices and in the
    pad columns."""
    B, T, U1 = got[1].shape
    U = U1 - 1
    in_b, in_l = lattice_masks(feat_lens, tgt_lens, T, U)
    dtype = got[3].dtype
    gmax = max(r.abs().max().item() for r in ref64[1:3] if r.numel())
    err = lambda x, y: max((a.double() - b.double()).abs().max().item()
                           for a, b in zip(x[1:3], y[1:3]) if a.numel()) / gmax
    g64 = g.double()
    frames = (got[1].double().sum(2) + g64[:, None]).abs() / g64.abs()[:, None]
    labels = (got[2].double().sum(1) + g64[:, None]).abs() / g64.abs()[:, None]
    mass = max(frames[in_b[:, :, 0]].max().item(),
               labels[in_l[:, 0, :]].max().item() if in_l.any() else 0.0)
    d, d64 = got[3][..., :classes].double(), ref64[3][..., :classes].double()
    dl_err = (((d - d64).abs() - RNNT_ROUNDING[dtype] * d64.abs()).clamp(min=0).max().item()
              / d64.abs().max().item())
    occupancy = got[1].double().abs() + torch.nn.functional.pad(got[2].double().abs(), (0, 1))
    cell = (d.sum(-1).abs() - classes * RNNT_SUBNORMAL[dtype]).clamp(min=0)
    cell = (cell / occupancy.clamp(min=1e-300))[in_b].max().item()
    del d, d64
    r = {"loss_rel": ((got[0] - ref[0]).abs() / ref[0].abs()).max().item(),
         "grad_err": err(got, ref64), "grad_err_fp32": err(got, ref),
         "plain_err": err(ref, ref64), "mass": mass, "dlogit_err": dl_err, "cell_sum": cell,
         "finite": all(bool(torch.isfinite(a).all()) for a in got),
         "zeros": not (got[1][~in_b].any() or got[2][~in_l].any() or got[3][~in_b].any()
                       or got[3][..., classes:].any())}
    r["ok"] = bool(r["finite"] and r["zeros"] and r["loss_rel"] <= RNNT_LOSS_RTOL
                   and r["grad_err"] <= RNNT_GRAD_BOUND and r["mass"] <= RNNT_MASS_BOUND
                   and r["dlogit_err"] <= RNNT_GRAD_BOUND
                   and r["cell_sum"] <= RNNT_CELL_BOUND[dtype])
    return r


def rnnt_faults(got, feat_lens, tgt_lens, targets, blank_id: int) -> dict:
    """Planted faults of the loss's backward, each of which ``rnnt_check``
    must reject: name -> (loss, cb, cl, dlogits), from ``got`` as
    ``rnnt_result`` gives it."""
    loss, cb, cl, dlogits = got
    B, T, U1 = cb.shape
    in_b, in_l = lattice_masks(feat_lens, tgt_lens, T, U1 - 1)
    last = torch.arange(T, device=cb.device)[None, :, None] == (
        feat_lens.clamp(1, T) - 1)[:, None, None]
    small = cb.abs() < 1e-4 * cb.abs().max()
    cl_cells = torch.nn.functional.pad(cl, (0, 1))
    occupancy = cb.abs() + cl_cells.abs()
    low = in_b & (occupancy > 0) & (occupancy < 1e-4 * occupancy.max())
    # the one-hot terms alone: the softmax term dropped
    hot = torch.zeros(dlogits.shape, dtype=torch.float32, device=dlogits.device)
    hot[..., blank_id] = cb
    tgt = torch.nn.functional.pad(targets.long().clamp(0, dlogits.shape[-1] - 1), (0, 1))
    hot.scatter_add_(3, tgt[:, None, :, None].expand(B, T, U1, 1), cl_cells[..., None].float())
    return {"cl shifted by one label": (loss, cb, torch.roll(cl, 1, dims=2) * in_l, dlogits),
            "the last frame's blank zeroed": (loss, torch.where(last, 0.0, cb), cl, dlogits),
            "blank cells below 1e-4 of the largest zeroed": (
                loss, torch.where(small, 0.0, cb), cl, dlogits),
            "the softmax term dropped on cells below 1e-4 of the largest occupancy": (
                loss, cb, cl, torch.where(low[..., None], hot.to(dlogits.dtype), dlogits))}


def rnnt_timing(logits, targets, feat_lens, tgt_lens, g) -> dict:
    """The kernels' device ms (their own time in a profiler trace, else the
    call's) and each kernel's, their launches per call and call ms, the
    plain version's ms (``rnnt_loss`` on the logits, and autograd of it to
    the logits) and the bound of each pair for these lengths."""
    from hnet_mamba_asr_torch.ops import rnnt_cuda as mod
    from hnet_mamba_asr_torch.ops.rnnt_loss import rnnt_loss
    B, T, U1, cols = logits.shape
    args = (targets, feat_lens.int(), tgt_lens.int(), RNNT_BLANK)
    _, lse, w = mod._forward(logits, *args, RNNT_CLASSES)
    fwd = lambda: mod._forward(logits, *args, RNNT_CLASSES)
    bwd = lambda: mod._backward(logits, lse, w, *args, g, RNNT_CLASSES)
    x = logits[..., :RNNT_CLASSES].detach().clone().requires_grad_()
    plain = lambda y: rnnt_loss(y, feat_lens, targets, tgt_lens, blank_id=RNNT_BLANK,
                                reduction="none")
    y_plain = plain(x)
    size = logits.element_size()
    r = {"call_ms": {"fwd": cuda_ms(fwd), "bwd": cuda_ms(bwd)},
         "launches": {"fwd": kernel_launches(fwd, "rnnt_fwd"),
                      "bwd": kernel_launches(bwd, "rnnt_bwd")},
         "plain_ms": {"fwd": cuda_ms(lambda: plain(x.detach()), n=3),
                      "bwd": cuda_ms(lambda: torch.autograd.grad(y_plain, x, g,
                                                                 retain_graph=True), n=3)},
         "cost": {"fwd": rnnt_cost(feat_lens.cpu(), tgt_lens.cpu(), T, U1 - 1, RNNT_CLASSES,
                                   size),
                  "bwd": rnnt_bwd_cost(feat_lens.cpu(), tgt_lens.cpu(), T, U1 - 1,
                                       RNNT_CLASSES, cols, size)}}
    r["parts"] = {"fwd": kernel_times(fwd, "rnnt_fwd"), "bwd": kernel_times(bwd, "rnnt_bwd")}
    r["ms"] = {k: sum(r["parts"][k].values()) or r["call_ms"][k] for k in ("fwd", "bwd")}
    r["share"] = {k: r["cost"][k]["bound_ms"] / r["ms"][k] for k in ("fwd", "bwd")}
    return r


def call_device_ms(fn, n: int = 5) -> dict:
    """Device ms of one call of ``fn``, every kernel it runs, and the ms of
    those whose name holds "rnnt", from a ``torch.profiler`` trace of n calls
    after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    return {"all": sum(d for d, _, _ in rows) / n / 1e3,
            "rnnt_kernels": sum(d for d, k, _ in rows if "rnnt" in k) / n / 1e3,
            "kernels": {k[:70]: [d / n / 1e3, c / n] for d, k, c in rows}}


def measure_rnnt(tag: str) -> None:
    """The loss through its public entry, ``rnnt_loss_cuda``, as the RNN-T
    head calls it (this tree: the padded logits and their classes; a parent
    without ``classes``: the logits sliced to their classes, as its head
    passed them), forward and backward to the padded logits: CUDA events
    per call, the device time of every kernel a call runs and of the loss
    kernels among them; and this tree's bounds. The plain version's ms for
    the tree that has the fused pair."""
    import inspect
    from hnet_mamba_asr_torch.ops import rnnt_cuda as mod
    from hnet_mamba_asr_torch.ops.rnnt_loss import rnnt_loss
    fused = "classes" in inspect.signature(mod.rnnt_loss_cuda).parameters
    mod.build()
    for dtype in (torch.bfloat16, torch.float32):
        for (Bsz, T, U), lengths in [(shape, None) for shape in RNNT_SHAPES] + [RNNT_EDGE]:
            logits, tg, fl, tl = rnnt_inputs(Bsz, T, U, dtype, lengths=lengths)
            g = torch.randn(Bsz, generator=torch.Generator().manual_seed(1)).cuda()

            def loss_of(x):
                if fused:
                    return mod.rnnt_loss_cuda(x, fl, tg, tl, blank_id=RNNT_BLANK,
                                              reduction="none", classes=RNNT_CLASSES)
                return mod.rnnt_loss_cuda(x[..., :RNNT_CLASSES], fl, tg, tl, blank_id=RNNT_BLANK,
                                          reduction="none")

            leaf = logits.detach().requires_grad_()
            y = loss_of(leaf)
            fwd = lambda: loss_of(logits)
            bwd = lambda: torch.autograd.grad(y, leaf, g, retain_graph=True)
            size = logits.element_size()
            row = {"version": tag, "dtype": str(dtype).removeprefix("torch."), "B": Bsz, "T": T,
                   "U": U, "edge_rows": lengths is not None,
                   "fwd_call_ms": cuda_ms(fwd), "bwd_call_ms": cuda_ms(bwd),
                   "fwd_device": call_device_ms(fwd), "bwd_device": call_device_ms(bwd),
                   "fwd_bound_ms": rnnt_cost(fl.cpu(), tl.cpu(), T, U, RNNT_CLASSES,
                                             size)["bound_ms"],
                   "bwd_bound_ms": rnnt_bwd_cost(fl.cpu(), tl.cpu(), T, U, RNNT_CLASSES,
                                                 RNNT_COLS, size)["bound_ms"]}
            if fused:
                x = logits[..., :RNNT_CLASSES].detach().clone().requires_grad_()
                yp = rnnt_loss(x, fl, tg, tl, blank_id=RNNT_BLANK, reduction="none")
                row["plain_fwd_ms"] = cuda_ms(lambda: rnnt_loss(
                    x.detach(), fl, tg, tl, blank_id=RNNT_BLANK, reduction="none"), n=3)
                row["plain_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    yp, x, g, retain_graph=True), n=3)
                del x, yp
            print(json.dumps(row), flush=True)
            del logits, leaf, y
            torch.cuda.empty_cache()


# one RNN-T micro-step's device time on the ops whose inputs span the
# joint's lattice, by the op's name: (class, substrings), first match
STEP_CLASSES = (("log-softmax", ("softmax",)),
                ("gather / scatter / select / slice", ("gather", "scatter", "index", "select",
                                                       "slice")),
                ("cast / copy", ("copy", "_to_copy")),
                ("fill / zeros", ("fill", "zero")),
                ("joint GEMMs", ("mm", "linear")))


def rnnt_step_profile(model, batch) -> dict:
    """One RNN-T micro-step (``loss_fn`` forward and backward, after one
    warm-up) under ``torch.profiler`` with shapes: the device ms of the
    kernels launched by ops whose inputs span the joint's lattice ([B, T,
    U+1, ...] or [B, T, U, ...], or its B T (U+1) rows as one dimension) by
    ``STEP_CLASSES``
    (else "joint elementwise": the add, tanh and sums), the loss kernels'
    (names holding "rnnt_"), the step's whole device time, and the lattice
    ops' names and input shapes."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    head, shapes = model.rnnt, []
    joint = head.joint

    def spy(*a, **kw):
        out = joint(*a, **kw)
        shapes.append(tuple(out.shape))
        return out

    head.joint = spy
    try:
        for k in range(2):
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                loss, _ = model.loss_fn(batch, 0, True)
                loss.backward()
                torch.cuda.synchronize()
    finally:
        del head.joint
    model.zero_grad(set_to_none=True)
    B, T, U1 = shapes[-1][:3]
    rows = B * T * U1

    def spans(input_shapes) -> bool:
        for s in input_shapes or ():
            s = list(s) if isinstance(s, (list, tuple)) else []
            if rows in s[:2] or (s[:2] == [B, T] and len(s) > 2 and s[2] in (U1 - 1, U1)):
                return True
        return False

    classes, ops = defaultdict(float), defaultdict(float)
    for ev in prof.key_averages(group_by_input_shape=True):
        us = device_us(ev)
        if (ev.device_type == DeviceType.CUDA or us <= 0 or "rnnt" in ev.key.lower()
                or not spans(ev.input_shapes)):
            continue
        name = next((c for c, keys in STEP_CLASSES if any(k in ev.key for k in keys)),
                    "joint elementwise")
        classes[name] += us / 1e3
        ops[f"{ev.key} {ev.input_shapes}"[:160]] += us / 1e3
    kernels = device_rows(prof)
    loss_kernels = {k[:60]: d / 1e3 for d, k, _ in kernels if "rnnt_" in k}
    return {"lattice": [B, T, U1, shapes[-1][3]],
            "device_ms": sum(d for d, _, _ in kernels) / 1e3,
            "classes_ms": dict(classes, **{"loss kernels": sum(loss_kernels.values())}),
            "loss_kernels_ms": loss_kernels,
            "lattice_ops_ms": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}


def _configs() -> dict:
    """name -> (model config, trainer config, rows per micro-batch)."""
    from hnet_mamba_asr_torch.tools import gate
    return {"gate": (gate.GATE_CONFIG, gate.GATE_TRAIN, gate.TRAIN_ROWS),
            "n2": (gate.N2_CONFIG, gate.N2_TRAIN, gate.N2_TRAIN_ROWS),
            "rnnt": (gate.RNNT_CONFIG, gate.GATE_TRAIN, gate.TRAIN_ROWS),
            "moe": (gate.MOE_CONFIG, gate.GATE_TRAIN, gate.TRAIN_ROWS)}


def measure_serve(tag: str, profile: bool, config: str) -> None:
    from hnet_mamba_asr_torch.serving.runtime import ServingModel
    from hnet_mamba_asr_torch.tools import gate
    cmvn = gate.make_cmvn("cuda")
    model = ServingModel(_configs()[config][0], None, "cuda", vocab_size=gate.VOCAB,
                         cmvn=cmvn, seed=gate.SEED)
    if config == "n2":                 # a router that keeps ~1/2, as a trained one
        gate.draw_routers(model.model, gate.SEED + 22)
    rng = np.random.default_rng(7)

    def batch(n, seconds):
        w = np.stack([gate.synth_audio(rng, seconds) for _ in range(n)])
        return w, [w.shape[1]] * n

    cases = {"8x10s": batch(8, 10.0), "1x35s": batch(1, 35.0),
             "8x35s": batch(8, 35.0), "1x3s": batch(1, 3.0)}
    for label, (w, lens) in cases.items():
        for _ in range(3):
            model(w, lens)
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            model(w, lens)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({"version": tag, "config": config, "serve": label,
                          "ms_mean": float(np.mean(times)),
                          "ms_min": float(np.min(times)), "ms_max": float(np.max(times))}),
              flush=True)
    if not profile:
        return
    from torch.profiler import ProfilerActivity, profile as torch_profile
    w, lens = cases["8x10s"]
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            model(w, lens)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    print(json.dumps({"version": tag, "config": config, "profile": "3 calls of 8x10s",
                      "window_ms": window_us / 1e3,
                      "device_ms": busy / 1e3, "idle_share": 1 - busy / window_us,
                      "top": [{"name": k[:90], "ms": d / 1e3, "share": d / busy, "count": c}
                              for d, k, c in rows[:12]]}), flush=True)


def open_sessions(pool, n: int, rng) -> list[int]:
    """``n`` sessions of ``pool``, each given the samples of a window less
    one block (so that every later block makes one tick)."""
    sids = [pool.open() for _ in range(n)]
    first = pool.S_win - 4 * pool.E * pool.hop
    pool.feed_many([(sid, rng.normal(size=first).astype(np.float32) * 0.05) for sid in sids])
    return sids


def stream_rounds(pool, sids, rounds: int, rng) -> float:
    """``rounds`` rounds of ``feed_many``, each session one block of samples
    a round (one tick a round) -> the host ms of a round, synced."""
    block = 4 * pool.E * pool.hop
    t0 = time.perf_counter()
    for _ in range(rounds):
        pool.feed_many([(sid, rng.normal(size=block).astype(np.float32) * 0.05)
                        for sid in sids])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / rounds


def measure_stream(tag: str) -> None:
    """Streaming ticks and the carried EMA kernel (the module docstring)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from hnet_mamba_asr_torch.ops.ema import ema_stream
    from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda, ema_stream_cuda
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.serving.runtime import StreamingSessionPool
    from hnet_mamba_asr_torch.tools import gate
    cmvn = gate.make_cmvn("cuda")
    rng = np.random.default_rng(11)
    for config, name in ((gate.GATE_CAUSAL_CONFIG, "n1"), (gate.N2_CAUSAL_CONFIG, "n2")):
        for B in (1, 8):
            pool = StreamingSessionPool(config, None, "cuda", block_enc=16, batch=B, cmvn=cmvn,
                                        seed=gate.SEED, vocab_size=gate.VOCAB)
            if name == "n2":
                gate.draw_routers(pool.model, gate.SEED + 22)
            sids = open_sessions(pool, B, rng)
            stream_rounds(pool, sids, 3, rng)                  # warm-up
            ssd0, ema0, ticks0 = ssd_cuda.launches, ema_cuda.launches, pool.n_ticks
            host_ms = stream_rounds(pool, sids, 10, rng)
            ticks = pool.n_ticks - ticks0
            launches = {"ssd_fwd": (ssd_cuda.launches - ssd0) / ticks,
                        "ema_fwd": (ema_cuda.launches - ema0) / ticks}
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                stream_rounds(pool, sids, 5, rng)
                window_us = (time.perf_counter() - t0) * 1e6
            rows = device_rows(prof)
            busy = sum(r[0] for r in rows)
            kernels = sum(r[2] for r in rows) / 5
            print(json.dumps({
                "version": tag, "stream": name, "sessions": B, "block_enc": pool.E,
                "ticks": ticks, "tick_host_ms": host_ms, "tick_device_ms": busy / 5e3,
                "idle_share": 1 - busy / window_us, "device_ops_per_tick": kernels,
                "launches_per_tick": launches, "rtf_per_session": host_ms / (4 * pool.E * 10),
                "top": [{"name": k[:80], "ms": d / 5e3, "count": c / 5}
                        for d, k, c in rows[:8]]}), flush=True)
            del pool
            torch.cuda.empty_cache()
    for Bsz, M, D in EMA_STREAM_SHAPES:
        z, p, n_real, carry = ema_stream_inputs(Bsz, M, D, seed=41)
        fn = lambda: ema_stream_cuda(z, p, n_real, carry)  # noqa: E731
        ms = kernel_ms(fn, "ema_fwd")
        print(json.dumps({"version": tag, "ema_stream": [Bsz, M, D], "kernel_ms": ms,
                          "call_ms": cuda_ms(fn),
                          "plain_ms": cuda_ms(lambda: ema_stream(z, p, n_real, carry)),
                          "real_rows": int(n_real.sum()),
                          **ema_stream_cost(n_real, M, D, "float32")}), flush=True)


def measure_train(tag: str, config: str, routers: str = "init") -> None:
    """One update of a config's training step as chip_smoke.py runs it
    (hybrid, bf16, SpecAugment; the gate config: 2 micro-batches of 32 x
    10 s, remat none; n2: 1 of 64 x 10 s, remat full), after 2 updates of
    warm-up: CUDA events split each micro-step into forward (loss_fn) and
    backward and the update into clip + AdamW; then a ``torch.profiler``
    window over one more update gives the device time by kernel and the
    device's idle share. ``routers``: "init" keeps the routers' identity
    init (which keeps one frame per row of seeded audio), "random" draws
    them at random (``gate.draw_routers``: about half the frames kept, where
    the ratio loss drives a trained N = 2 router)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda
    from hnet_mamba_asr_torch.ops.rnnt_cuda import rnnt_loss_cuda
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.tools import gate
    model_cfg, train_cfg, rows = _configs()[config]
    cmvn = gate.make_cmvn("cuda")
    accum = train_cfg["accum_grad"]
    batches = gate.train_batches(np.random.default_rng(7), accum, rows)
    with tempfile.TemporaryDirectory(prefix="measure_train_") as tmp:
        trainer = gate.gate_trainer(model_cfg, batches * 2, train_cfg, cmvn,
                                     tmp, max_steps=2)
        if routers == "random":
            gate.draw_routers(trainer.model, gate.SEED + 24)
        trainer.train()
    trainer.model.train()
    dev = [trainer._to_device(b) for b in batches]

    def update(split=None):
        for b in dev:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            loss, _ = trainer.model.loss_fn(b, trainer.global_step, True)
            ev[1].record()
            (loss / trainer.accum_grad).backward()
            ev[2].record()
            if split is not None:
                split.append(ev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        trainer._apply_step()
        ev[1].record()
        torch.cuda.synchronize()
        if split is not None:
            split.append(ev)

    split: list = []
    ssd_cuda.launches = ssd_cuda.bwd_launches = ema_cuda.launches = ema_cuda.bwd_launches = 0
    rnnt_loss_cuda.launches = rnnt_loss_cuda.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    update(split)
    fwd = sum(e[0].elapsed_time(e[1]) for e in split[:-1])
    bwd = sum(e[1].elapsed_time(e[2]) for e in split[:-1])
    opt = split[-1][0].elapsed_time(split[-1][1])
    total = split[0][0].elapsed_time(split[-1][1])
    launches = {"ssd_fwd_launches": ssd_cuda.launches, "ssd_bwd_launches": ssd_cuda.bwd_launches,
                "ema_fwd_launches": ema_cuda.launches, "ema_bwd_launches": ema_cuda.bwd_launches,
                "rnnt_fwd_launches": rnnt_loss_cuda.launches,
                "rnnt_bwd_launches": rnnt_loss_cuda.bwd_launches}
    with torch.no_grad():
        enc = trainer.model.encode(dev[0])
    print(json.dumps({"version": tag, "config": config, "routers": routers,
                      "train_update": f"{accum} x ({rows} x 10 s), hybrid, bf16",
                      "ms": total, "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": opt,
                      "mel_frames_per_s": accum * rows * gate.TRAIN_FRAMES / (total / 1e3),
                      **launches,
                      "kept_fraction": [k.item() for k in enc.kept_fractions],
                      "slots": [z.shape[1] for z in enc.chunk_embeddings],
                      "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}),
          flush=True)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        update()
        window_us = (time.perf_counter() - t0) * 1e6
    top = device_rows(prof)
    busy = sum(r[0] for r in top)
    print(json.dumps({"version": tag, "config": config, "routers": routers,
                      "profile": f"1 update, {accum} x ({rows} x 10 s)",
                      "window_ms": window_us / 1e3, "device_ms": busy / 1e3,
                      "idle_share": 1 - busy / window_us,
                      "top": [{"name": k[:90], "ms": d / 1e3, "share": d / busy, "count": c}
                              for d, k, c in top[:15]]}), flush=True)
    if config == "rnnt":
        print(json.dumps({"version": tag, "config": config,
                          "rnnt_micro_step": rnnt_step_profile(trainer.model, dev[0])}),
              flush=True)


def measure_aed_step(tag: str) -> None:
    """The AED decode step of chip_smoke.py's full-width decode run (the gate
    config's head in bf16 with seeded weights, over the encoder's output for
    its 8 utterances, 8 x 16 rows as ``BatchedCachedAEDStepper`` runs a beam
    of 10) at position 32, four ways: the attention one utterance's rows at
    a time over its own keys (``decode_groups``) or over every row at once,
    and the GEMMs in blocks of ``DECODE_ROWS`` rows or whole. CUDA events
    around 20 steps after 3 warm-ups; one JSON line per way."""
    import copy
    from hnet_mamba_asr_torch.data.dataset import ItemLoader
    from hnet_mamba_asr_torch.models import aed
    from hnet_mamba_asr_torch.tasks import decode_task
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tools.gate import (
        GATE_CONFIG, SEED, VOCAB, decode_batch_items, make_cmvn)
    cfg = copy.deepcopy(GATE_CONFIG)
    cfg["aed_conf"]["max_decode_len"] = 64
    model = build_model(cfg, VOCAB, cmvn=make_cmvn("cuda"), seed=SEED)
    items = decode_batch_items(np.random.default_rng(SEED + 50), 8)
    enc, _ = decode_task.encode_batch(model, next(iter(ItemLoader(items, 10 ** 7,
                                                                  shuffle=False))))
    stepper = decode_task.BatchedCachedAEDStepper(
        model.aed, enc.features, enc.lengths.cpu().numpy(), beam_rows=10)
    stepper.start()
    gen = np.random.default_rng(SEED)
    for _ in range(31):
        stepper.advance(gen.integers(0, 10, (8, 10)), gen.integers(4, VOCAB, (8, 10)))
    rows = stepper.B * stepper.R
    parents = torch.arange(rows, device="cuda")
    tokens = torch.randint(4, VOCAB, (rows,), device="cuda")
    block = aed.DECODE_ROWS
    try:
        for groups in (stepper._groups, None):
            for row_block in (block, 0):
                aed.DECODE_ROWS = row_block
                with torch.inference_mode():
                    ms = cuda_ms(lambda: model.aed.decode_step(
                        stepper._caches, stepper._kpm, parents, tokens, stepper._pos, groups))
                print(json.dumps({"version": tag, "aed_step": f"{rows} rows, 6 layers, bf16, "
                                  f"memory {tuple(enc.features.shape)}, position "
                                  f"{stepper._pos}", "grouped": groups is not None,
                                  "row_block": row_block, "ms": ms}), flush=True)
    finally:
        aed.DECODE_ROWS = block


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("ssd", "ssd_bwd", "bwd_phases", "ema", "ema_phases",
                                     "serve", "phases", "train", "aed_step", "rnnt",
                                     "stream"))
    ap.add_argument("--config", choices=("gate", "n2", "rnnt", "moe"), default="gate",
                    help="serve / train: the gate config (N = 1), configs/typeA_small_N2, "
                         "or the gate config with the RNN-T head or the MoE AED decoder")
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default=None, help="label of the version in the output")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "repo": str(repo), "torch": torch.__version__}), flush=True)
    tag = args.tag or repo.name
    if args.what == "ssd":
        measure_ssd(tag)
    elif args.what == "ssd_bwd":
        measure_ssd_bwd(tag)
    elif args.what == "bwd_phases":
        measure_bwd_phases(tag)
    elif args.what == "phases":
        measure_phases(tag)
    elif args.what == "ema":
        measure_ema(tag)
    elif args.what == "ema_phases":
        measure_ema_phases(tag)
    elif args.what == "aed_step":
        measure_aed_step(tag)
    elif args.what == "rnnt":
        measure_rnnt(tag)
    elif args.what == "stream":
        measure_stream(tag)
    elif args.what == "train":
        for routers in ("init", "random") if args.config == "n2" else ("init",):
            measure_train(tag, args.config, routers)
    else:
        measure_serve(tag, args.profile, args.config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
