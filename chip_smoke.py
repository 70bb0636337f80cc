#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: serve, train and decode
Type A Small at N=1, with H-Net dynamic chunking at N=2, with the RNN-T head
and with an MoE AED decoder, stream their causal siblings, run the
interpretability suite, and run the multi-rank planes (DDP, FSDP, sequence
parallelism, decoding over ranks) on processes sharing the card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Drives the port (``hnet_mamba_asr_torch``) through the entry points a user
calls, at the full width of ``configs/typeA_small_N1.yaml`` and
``configs/typeA_small_N2.yaml`` with seeded random weights, and fails
(non-zero exit) when any phase fails:

1. build    -- compile the hand-written kernels (SSD forward and backward
               at (P, N) = (64, 128) and, fp32 only, (16, 16); the H-Net
               EMA; the RNN-T lattice) from ``csrc/``, one nvcc per
               library, started together;
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
   rnnt     -- the RNN-T loss kernels (rnnt_fwd: logits -> loss, lse and
               the blank shares, two launches; rnnt_bwd: -> dlogits, two
               launches) against the plain pair (``rnnt_fwd_plain`` /
               ``rnnt_bwd_plain``) from the joint's padded bf16 and fp32
               logits at B 32 T 249 U 64 (training), B 8 T 380 U 128 (the
               decode batch), B 1 T 880 U 256 (35 s), U 512 and with edge
               rows (T_b 1, U_b 0, feat_length 0, rows shorter than the
               batch, a target equal to the blank and one past V; also as
               501 contiguous columns): the loss against fp32, cb / cl and
               dlogits against fp64, every frame's and label's alignment
               mass, each cell's dlogits summed to 0, zeros outside the
               lattices and in the pad columns, two calls bitwise equal;
               four planted faults rejected by the same check; the times
               of each launch, the bound;
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
               micro-batcher, ids equal; then the RNN-T config serving
               rnnt_ids and rnnt_beam_ids the same way (the 4 shortest
               alone, a cut for the time limit);
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
               micro-step; then the RNN-T config (the gate config with
               rnnt_weight 1.0, 79,703,198 parameters): 3 updates of 2 x 32
               x 10 s, 40 + 40 SSD and 1 + 1 loss calls per micro-step,
               step time and peak memory; a profiled micro-step: its device
               time by kernel class on the joint's lattice, no
               log-softmax, gather, select, slice, cast or copy there;
6. descent  -- 5 updates on one fixed batch of 8 x 10 s at a constant lr of
               1e-3: the loss falls;
7. grads    -- one fp32 micro-step at full width and depth 1 + 2 + 1 on the
               card and on the CPU: every parameter's gradient agrees
               (1e-3 of its max; the first conv's 1e-2); then at N = 2,
               the boundaries equal first, the router's leaves included;
               then the RNN-T config (the same bounds), one call of each
               loss kernel pair (from the joint's fp32 logits);
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
13. decode  -- the full-width gate config (seeded; its AED decoder at 2
               of 6 layers) and the full-width ``lm_transformer_500`` LM
               (seeded; 4 of 16 layers): 8 utterances of 2-16 s
               through the 7 cells of the config's decode block, shared
               encoder, AED cap 64 (seeded weights never emit eos), once on
               the device searches (the default) and once on the host's
               (``device_beam: false``): RTF, encoder and search seconds per
               cell, the SSD launches, the device's idle share of 4 cells
               on the device engine; the
               device engine's kernel launches per search step and host
               reads of its active mask; the engines' disagreements and
               ties; the psi and r-scan shares of a joint step; the 2
               shortest utterances alone == inside the batch in every beam
               cell of both engines (a cut for the time limit), in bf16;
14. parity  -- depth 1 + 2 + 1, a 2-layer AED and a 2-layer LM, fp32, TF32
               off: decode_step log-probs card vs CPU to 1e-5, the 7 cells'
               transcripts card == CPU for both engines and device ==
               lockstep on both sides, a request alone == inside a batch for
               ctc_beam_lm and joint_beam on both engines;
15. rnnt    -- the RNN-T config at full width and the full-width LM (4 of
               its 16 layers, a cut for the time limit, as phase 13's): the
               8 utterances of phase 13 through rnnt_greedy, rnnt_beam and
               rnnt_beam_lm on the device engine and the host's (its
               rnnt_beam_lm on the 2 shortest): RTF, encoder and search
               seconds, idle share; the engines' transcripts equal (where
               they part in bf16, in fp32 but on ties); the shortest
               request alone == batched in rnnt_beam_lm;
16. gate    -- after 11, on its corpus: the RNN-T recipe of
               tests/test_overfit_gate_rnnt.py (rnnt 1.0, ctc 0, d_pred 32,
               d_joint 64, lr 5e-3, 240 epochs) through the lattice
               kernels, rnnt_greedy and the gate at 15.0; test-clean
               through rnnt_beam and rnnt_beam_lm (11's LM) as well, on
               both engines: transcripts equal (or tied), the 4 shortest
               utterances alone == batched in both beam cells;
17. moe     -- MoEFFN (8 experts, top 2) card vs CPU in fp32 with capacity
               drops; the MoE gate config through Trainer (3 updates,
               moe/aux and moe/dropped finite); aed_beam at full width and
               the AED's dropped share; ctc_beam_lm with the MoE LM (4 of
               its 16 layers, a cut for the time limit) scored dropless,
               the 2 shortest requests alone == batched;
18. stream  -- the carried EMA kernel against ema_stream (B 8 M 16, B 64
               M 256, D 384), the fp32 SSD kernel at L 16 from a carried
               state (zero-dt rows exact no-ops); the causal gate config and
               its N = 2 sibling streamed (CausalStreamingEncoder, blocks of
               16) against offline in fp32 (features within 2e-4, CTC ids
               and boundaries equal); the causal transducer's greedy and
               beam ids streamed == offline, and the beam's whole carried
               state (every hypothesis, its length and score) == one pass
               over the same frames; 8 pooled sessions == each
               alone; the windowed encoder's frame counts and a covering
               window within 1e-4;
19. artifacts -- the gate config at full width exported (frame_ids,
               log_probs, beam_ids, aed_ids) in fp32 and int8 and served from
               the artifact (``load_serving_artifact``): phase 4's 8 requests
               bitwise equal to the direct ``ServingModel`` (int8: to a
               direct model holding the dequantized int8 tree); sizes, load
               time, call times, the int8 log-prob gap and id agreement;
               ``serving/server.py::main`` from the artifact answers an HTTP
               request with the direct call's ids; an N = 2 causal streaming
               artifact at batch 8 gives its source pool's ids; then
               ``configs/typeA_small_N1.yaml`` read by the port's YAML reader
               == GATE_CONFIG, and every CLI (export_serving fp32 / int8,
               serve, transcribe, decode with the LM cells, score_wer) once
               on the card at narrow width; then that YAML file itself at
               full width (bf16, 80 mels, the seeded 500-piece tokenizer)
               through export_serving, serve, transcribe --cell ctc_greedy
               and a greedy-only decode, each launching ssd_fwd;
20. train CLIs -- a synthetic LibriSpeech tree (train-clean-100: 48
               utterances of 2-16 s, three in four FLAC; dev-clean: 4)
               through build_manifests, build_tokenizer (500 pieces, its
               round trip) and compute_cmvn on the card; then
               ``configs/typeA_small_N1.yaml`` itself through the train CLI
               (78,858,409 parameters, bf16, speed perturbation 0.9 / 1.0 /
               1.1 through a perturb cache, accum_grad 2; overrides: paths,
               max_epoch 2, validation every epoch, keep_nbest_models 1 and
               no kept-all): items 3x the entries with #sp ids, the cache
               written in epoch 0 and read in epoch 1, per update CUDA-event
               ms, mel-frames/s, peak memory and the loader's wait; a
               ``--resume auto`` run to max_epoch 4 whose first update is
               step k + 1 at the schedule's rate for k and whose early
               stopping (patience 0, an unbeatable min_delta) ends it after
               epoch 2; the best symlinks, pruning, the .ave files,
               metrics.jsonl and summary.json with provenance; one epoch
               at accum_grad 1 with train.scan_steps 1 and 2: the same
               parameters bitwise, one host read a group (the card's
               synchronizing calls counted in torch's sync debug mode);
               ``configs/typeA_large_N1.yaml`` through the train CLI for one
               update (4 micro-steps of 16k frames, remat dots;
               210,967,945 parameters); ``configs/lm_transformer_500.yaml``
               through train_lm over a synthetic corpus file (one epoch, its
               valid.loss.ave.ckpt); the decode CLI's ctc_greedy,
               ctc_beam and ctc_beam_lm over dev-clean from the ASR's
               valid.loss.ave.ckpt with that LM; the host library's FLAC
               decode == the numpy twin on one file, and its ms per item;
21. interp  -- (a) the tone-corpus interpretability gate
               (``tools/interp_e2e.py``): analytic alignments checked, an N=2
               model trained 12 epochs through the train CLI (validation and
               a kept checkpoint every epoch), the four run_interp modes
               through the CLI with the 'torch' probe backend: the word-id
               probe on frames >= 0.8, the phone-class probe above its
               majority, every aligned utterance's boundaries scored with
               finite P/R/F1 and a random floor, every perturbation scored
               with its consistency block, one emergence row per epoch; (b)
               that final checkpoint's boundary report on the card in fp32
               (TF32 off) and on the CPU: the hard boundaries equal, then the
               reports; (c) ``configs/typeA_small_N2.yaml`` at full width
               (seeded, random routers, a trainer-layout checkpoint) through
               run_interp boundaries and probes on the tone audio: seconds
               per mode (encoder and all), 40 ssd_fwd and 1 ema_fwd per
               encoder pass; (d) the 'torch' probe fit on the card against
               scipy's float64 optimum on the host at n 20,000, d 384, k 50
               and k 2 (probabilities within 2e-5 and decisions equal where
               scipy is confident; at k 50 scipy starts from the card's
               weights; its final gradient below 1e-5), and a timed fit at n
               200,000, d 384, k 500 with the time reckoned at the configs'
               train_cap of 1,000,000;
22. ranks   -- the multi-rank planes, every process at once on the card
               while the one-process references run here: a pair probing
               which collectives gloo takes on CUDA tensors (``chip_smoke.py
               --gloo-probe``); two ranks sharing the card under gloo
               (``--ranks-worker``): DDP's gradients of one micro-step of
               the gate config (8 rows: 7 x 10 s and a pad, SpecAugment and
               AED dropout on) against one process's in fp32 (TF32 off;
               bf16's gap recorded) and against one process's witness of
               the same row split (``split_grads``: 1e-5 of each leaf's max
               in fp32, phase 7's bounds in bf16), 2 updates under DDP
               (FSDP where gloo takes its collectives), sp = 2 on
               ``configs/typeA_small_N2.yaml`` (fp32, routers drawn, 2 x 35
               s): features, ratio loss, kept fraction, loss and every
               gradient against the offline update's, each rank's ssd_fwd
               (return_final) / ssd_bwd (ds_final) / ema_fwd / ema_bwd
               launches, and in bf16 the boundaries first (a flip only
               within the router's own rounding gap of 0.5), then the
               features; tp = 2 (dp = 1): the gate config's gradient of one
               micro-step against the one-process witness (a virtual plane:
               both shards in turn; 1e-5 of each leaf's max in fp32, phase
               7's bounds in bf16) and against one process (phase 7's
               bounds in fp32), each rank's ssd_fwd / ssd_bwd launches at 6
               and 8 heads, micro-step and optimizer ms, peak, params +
               moments; the N=2 config in bf16 with random routers, one
               forward: the ranks' boundaries equal, against one process
               within the router's gap, the EMA kernels on the replicated
               dechunk; ep = 2 on the MoE config (fp32): the loss, moe/aux,
               moe/dropped and every gradient against one process (1e-5 of
               each leaf's max); decode.tp = 2 in fp32 (the AED at
               DECODE_AED_LAYERS layers) in ctc_greedy, ctc_beam and
               joint_beam == one process (transcripts, beam scores within
               1e-5) and ctc_greedy alone == batched in bf16; pp = 2 (dp =
               1, 6 of the 12 main blocks a stage, 2 microbatches): the
               gate config's micro-step (fp32, bf16) against the one-process
               witness running both stages in turn (loss, features and
               gradients bitwise, or within a one-ulp control's gap) and
               plain one process (fp32, as tp), each stage's launches, ms,
               peak and params + moments; the N=2 config's forwards (fp32:
               boundaries equal, features 1e-5; bf16 as sp's); two Trainer
               updates gathered to rank 0 against the witness's and one
               process's (within 4x a two-update one-ulp control); a second
               probe pair for gloo's send / recv; in the parent,
               train.scan_steps = 2 over the two global batches (one host
               read, counted as the card's synchronizing calls; bitwise
               those of scan_steps = 1); the gate
               config's ctc_greedy
               and aed_beam decoded over 2 ranks == one process (transcripts
               and beam scores); one rank under NCCL: the fp32 gradients,
               DDP and FSDP updates (no checkpoint written), FSDP's
               parameters against DDP's; params + moments and peak memory
               per rank, update ms (one shared card); ``tools/smoke_2proc.py``
               (train, resume, decode through the CLIs at d 32 on the tone
               corpus, two processes) passing all its checks.

The line before the last is a JSON summary of the kernels, with the
launches of the full-width decode run on the device engine (ssd_fwd), of
the RNN-T training run (rnnt_fwd, rnnt_bwd) and of the N = 2 training run
(the others), and every path's counts (the streaming paths' as stream_*,
the artifacts' as artifacts_*, the training CLIs' as train_cli_*, the
interpretability runs' as interp_*, a rank's sp update as
sp_update_rank0, a pp stage's micro-step as pp_update_stage0 / 1; a
streaming path's ema_fwd is the carried form);
the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
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
# a tp = 2 rank's heads at the training shape (6 of the encoder's 12, 8 of the
# main stack's 16; phase 22)
TP_SHAPES = ((32, 249, 6), (32, 249, 8))
FWD_SHAPES = (tuple((Bsz, L, H) for Bsz in (8, 1) for L in (248, 873, 1000)
                    for H in (12, 16)) + ((8, 380, 12), (8, 380, 16)) + TRAIN_SHAPES
              + TP_SHAPES)
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


LOG_FILE = []                   # main() opens $CHIP_SMOKE_LOG here, when set


def log(msg: str) -> None:
    print(msg, flush=True)
    for f in LOG_FILE:              # the whole log, which the end of stdout is not
        f.write(msg + "\n")
        f.flush()


def kernel_name(key: str) -> str:
    """A profiler row's kernel name without its namespace and arguments."""
    return key.split("::")[-1].split("<")[0].split("(")[0]


def phase_build():
    from hnet_mamba_asr_torch.ops import cuda_build, ema_cuda, rnnt_cuda, ssd_cuda
    t0 = time.perf_counter()
    info = ssd_cuda.build()
    ema_cuda.build()
    rnnt_cuda.build()
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
             for intra in ("bf16", None) for s in BWD_SHAPES + TP_SHAPES]
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
    model = ServingModel(config, None, "cuda", vocab_size=VOCAB, cmvn=cmvn, seed=SEED)
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
                         emit=("beam_ids", "aed_ids"))
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
    ``draw_routers``) within PARAM_GRAD_BOUND of its max and
    PARAM_GRAD_MEAN_BOUND of its mean (the first conv's leaves within
    CONV1_GRAD_BOUND)."""
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
        + "".join(f"; {r[2]} {r[0]:.2e}" for r in rows if ".router." in r[2]
                  or r[2].startswith("rnnt.")))
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


def phase_tone_matrix(tmp: Path) -> tuple:
    """The hybrid tone model (ctc 0.3, aed 0.7, GATE_EPOCHS epochs) and a
    narrow LM trained on the training text (~300 updates), then all 7 cells
    on test-clean: each cell's WER and seconds per utterance, a hypothesis
    for every utterance, ctc_greedy through the gate, and every AED and
    joint cell below its WER at the model's initial weights. Returns the
    cells' rows and the LM's scorer (phase 16 fuses it)."""
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
    return rows, scorer


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
# the depth of phase 13's full-width decode run, cut so that the smoke stays
# well inside its time limit on a slow host (its time for the same work
# varies by up to 1.4x from host to host): the widths are the configs', the
# AED decoder keeps 2 of its 6 layers and the LM 4 of its 16 (phases 15 and
# 17 cut their LMs the same way)
DECODE_AED_LAYERS = 2
DECODE_LM_LAYERS = 4
DECODE_N_PARAMS = 67_815_593    # the gate config with the 2-layer AED decoder


def cut_lm(config: dict) -> dict:
    """An LM config at DECODE_LM_LAYERS layers."""
    return {**config, "lm_conf": {**config["lm_conf"], "n_layers": DECODE_LM_LAYERS}}


# engine labels and their decode blocks: the config's own (device_beam
# absent: the device searches, the JAX package's default) and the host's
ENGINES = (("device", {}), ("lockstep", {"device_beam": False}))
# a disagreement between the engines is a tie when their best scores agree
# within this share of their magnitude (float32 against float64 scoring)
TIE_SHARE = 1e-4
# search steps profiled for the launches per step (phases 13 and 15; cut
# from 16 to make room for phase 20)
STEP_PROBE = 8
# cuts that make room for phases 20 and 22 inside the time limit: each
# engine checks its ALONE_UTTS shortest utterances alone (of 8), and a cell's
# idle share is profiled on the PROFILE_UTTS shortest, on the device engine
# only and for PROFILE_CELLS only (every cell of both engines took ~87 s of
# profiling on the slowest host seen)
ALONE_UTTS = 2
PROFILE_UTTS = 1
# and the host engine (lockstep) decodes its LM cells over the
# LOCKSTEP_LM_UTTS shortest (the device engine all 8 in every cell), as
# phase 15's host engine does
LOCKSTEP_LM_UTTS = 4
PROFILE_CELLS = ("ctc_greedy", "ctc_beam", "aed_beam", "joint_beam")


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
    """typeA_small_N1 at full width (seeded, bf16 intra bf16) with its AED
    decoder cut to DECODE_AED_LAYERS layers (67,815,593 parameters) and
    lm_transformer_500 at full width cut to DECODE_LM_LAYERS layers
    (seeded, fp32): 8 synthetic
    utterances of 2-16 s in one batch through all 7 cells of the config's
    decode block with the shared encoder, once per engine: the device
    searches (the config's default) and the host's (``device_beam: false``;
    its LM cells over the LOCKSTEP_LM_UTTS shortest, a second run).
    Per cell and engine the real-time factor, encoder and search seconds; the
    device's idle share of PROFILE_CELLS on the device engine (each cell alone
    under torch.profiler on the PROFILE_UTTS shortest utterances); the device
    engine's steps and host reads of its
    active mask; the engines' disagreements (ties: best scores within
    TIE_SHARE) and, in the CTC cells, what they come from; at the batch of
    8, the device searches' kernel launches per step (their first
    STEP_PROBE steps) and the psi and r-scan shares of a joint step; the SSD
    launches of each run; then the ALONE_UTTS shortest utterances alone
    against their transcripts in the batch, in each beam cell, on each
    engine (a cut that keeps the smoke inside its limit)."""
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
    cfg["aed_conf"].update(max_decode_len=DECODE_CAP, n_layers=DECODE_AED_LAYERS)
    model = build_model(cfg, VOCAB, cmvn=cmvn, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    lm = build_lm(cut_lm(LM_CONFIG), VOCAB, seed=SEED)
    tok = seeded_tokenizer(tmp / "tok500.model")
    scorer = CausalLMScorer(lm.lm, bos_id=tok.bos_id, eos_id=tok.eos_id, pad_id=tok.pad_id)
    items = decode_batch_items(np.random.default_rng(SEED + 50), DECODE_UTTS)
    audio_s = {it["id"]: it["n_samples"] / SR for it in items}
    loader = ItemLoader(items, 10 ** 7, shuffle=False)
    by_length = sorted(items, key=lambda it: it["n_samples"])
    short = by_length[:PROFILE_UTTS]
    short_batch = next(iter(ItemLoader(short, 10 ** 7, shuffle=False)))
    runs = {}
    for engine, change in ENGINES:
        dc = dict(GATE_DECODE, **change)
        cells = decode_task.expand_cells(dc)
        # (cells, utterances) of each decode run of this engine
        plan = [(cells, items)]
        if engine == "lockstep":
            plan = [([c for c in cells if not c["lm"]], items),
                    ([c for c in cells if c["lm"]], by_length[:LOCKSTEP_LM_UTTS])]
        utts = {c["name"]: len(run_items) for run_cells, run_items in plan for c in run_cells}
        torch.cuda.synchronize()
        ssd_cuda.launches = 0
        t0 = time.perf_counter()
        summaries = [s for run_cells, run_items in plan
                     for s in decode_task.decode_split_shared(
                         model, tok, ItemLoader(run_items, 10 ** 7, shuffle=False), run_cells,
                         dc, audio_seconds={it["id"]: audio_s[it["id"]] for it in run_items},
                         out_dir=tmp / f"full_{engine}", split="synthetic", lm=scorer)]
        wall = time.perf_counter() - t0
        launches = ssd_cuda.launches
        records = {c["name"]: {r["id"]: r for r in map(json.loads, (
            tmp / f"full_{engine}" / c["name"] / "synthetic.jsonl").read_text().splitlines())}
            for c in cells}
        rows = {}
        t1 = time.perf_counter()
        enc, _ = decode_task.encode_batch(model, short_batch)
        for cell in cells:
            idle = None
            if engine == "device" and cell["name"] in PROFILE_CELLS:
                idle, _, _ = profile_cell(lambda: decode_task.decode_batch(
                    model, tok, short_batch, cell, dc, lm=scorer, enc=enc, enc_s=0.0))
            rec = next(iter(records[cell["name"]].values()))
            rows[cell["name"]] = dict(idle_short=idle, steps=rec.get("search_steps"),
                                      host_reads=rec.get("host_reads"))
        for s in summaries:
            rows[s["cell"]].update(rtf=s["rtf"], encoder_s=s["encoder_s"],
                                   search_s=s["search_s"], engine=s["engine"],
                                   n=s["n_utts"], audio_s=s["audio_s"])
        profiled = time.perf_counter() - t1
        t1 = time.perf_counter()
        checked = by_length[:ALONE_UTTS]
        alone = [(c["name"], it["id"], decode_task.decode_batch(
            model, tok, collate_batch([it], pad_id=3, seed=0, epoch=0), c, dc,
            lm=scorer)[0]["hyp"]) for it in checked for c in cells if c["search"] == "beam"]
        differ = sorted({(name, uid) for name, uid, hyp in alone
                         if hyp != records[name][uid]["hyp"]})
        log(f"  {engine}: bf16, each of the {len(checked)} "
            f"{'utterances' if len(checked) == DECODE_UTTS else 'shortest utterances'} alone "
            f"vs inside the batch, 6 beam cells: {len(alone) - len(differ)}/{len(alone)} "
            f"transcripts equal "
            f"({time.perf_counter() - t1:.1f} s; decode run {wall:.1f} s, profiled cells "
            f"{profiled:.1f} s)")
        if differ:
            raise AssertionError(f"{engine}: alone and batched transcripts differ: {differ}")
        if launches != 2 * len(plan) * SSD_CALLS_PER_FORWARD:
            raise AssertionError(f"{engine}: {launches} ssd_fwd launches in the decode runs")
        bad = [s["cell"] for s in summaries if s["n_utts"] != utts[s["cell"]]]
        if bad:
            raise AssertionError(f"{engine}: cells without a record for every utterance: {bad}")
        runs[engine] = dict(cells=rows, records=records, launches=launches, wall=wall)

    # the engines' disagreements, and which of them are ties
    agree = {}
    for name, dev_recs in runs["device"]["records"].items():
        n_diff, n_tie = 0, 0
        both = [(d, runs["lockstep"]["records"][name][uid]) for uid, d in dev_recs.items()
                if uid in runs["lockstep"]["records"][name]]
        for d, h in both:
            uid = d["id"]
            if d["hyp"] == h["hyp"]:
                continue
            n_diff += 1
            a, b = d["score"], h["score"]
            tie = (a is not None and b is not None
                   and abs(a - b) <= TIE_SHARE * max(abs(a), abs(b)))
            n_tie += tie
            log(f"    {name} {uid}: device {a} vs lockstep {b}: {'tie' if tie else 'no tie'}")
        agree[name] = {"differ": n_diff, "ties": n_tie, "compared": len(both)}

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
        # ctc_beam only (ctc_beam_lm's would take ~25 s on the slowest host,
        # its host search with the LM in Python twice: cut for the limit)
        for name, w in (("ctc_beam", 0.0),):
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
            idle = ("not measured" if c["idle_short"] is None else
                    f"{c['idle_short']:.2%} (the {PROFILE_UTTS} shortest)")
            log(f"  {s_name:<14} {engine:<8} RTF {c['rtf']:.5f}: encoder {c['encoder_s']:.4f} s, "
                f"search {c['search_s']:.4f} s over {c['n']} utterances "
                f"({c['audio_s']:.2f} s of audio); device idle {idle}{extra}")
        a = agree[s_name]
        log(f"  {s_name:<14} engines differ on {a['differ']}/{a['compared']} utterances, "
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
        f"ssd_fwd launches per engine {[runs[e]['launches'] for e, _ in ENGINES]} (per "
        f"decode run the untimed warm-up pass and the one timed pass, "
        f"{SSD_CALLS_PER_FORWARD} each); "
        f"{sum(r['wall'] for r in runs.values()):.1f} s of decode runs; cuts: AED cap "
        f"{DECODE_CAP} tokens (seeded weights never emit eos), AED {DECODE_AED_LAYERS} and "
        f"LM {DECODE_LM_LAYERS} layers, the lockstep engine's LM cells over the "
        f"{LOCKSTEP_LM_UTTS} shortest")
    if n_params != DECODE_N_PARAMS:
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


# ---- the RNN-T family and the MoE FFN ----------------------------------------------
def phase_rnnt_kernel() -> list:
    """The RNN-T loss kernels against the plain pair (``rnnt_fwd_plain`` /
    ``rnnt_bwd_plain``) from the joint's padded bf16 and fp32 logits at the
    training shape (B 32 T 249 U 64), the decode batch's (B 8 T 380 U 128),
    a 35 s utterance's (B 1 T 880 U 256), U 512 and with edge rows (T_b 1,
    U_b 0, feat_length 0, rows shorter than the batch, a target equal to the
    blank and one past V; and there the logits as 501 contiguous columns,
    which take element loads), as ``measure.rnnt_check`` holds them: the
    loss against the plain pair in fp32, cb / cl and dlogits against it in
    fp64, the alignment mass of every frame and label, each cell's dlogits
    summed to 0, zeros outside each lattice and in the pad columns; two
    calls bitwise equal; at the training shape, the four planted faults
    (``measure.rnnt_faults``) each rejected by that check; the kernels'
    time and each launch's, their bound and the plain version's time
    (``measure.rnnt_timing``)."""
    import importlib.util
    from hnet_mamba_asr_torch.ops import rnnt_cuda
    from hnet_mamba_asr_torch.ops.rnnt_loss import rnnt_bwd_plain, rnnt_fwd_plain
    from hnet_mamba_asr_torch.tools.measure import (
        RNNT_BLANK, RNNT_CELL_BOUND, RNNT_CLASSES, RNNT_EDGE, RNNT_GRAD_BOUND, RNNT_LOSS_RTOL,
        RNNT_MASS_BOUND, RNNT_SHAPES, rnnt_check, rnnt_faults, rnnt_inputs, rnnt_pair,
        rnnt_timing)

    rows = []
    cases = [(dtype, s, None, False) for s in RNNT_SHAPES for dtype in (torch.bfloat16,
                                                                         torch.float32)]
    cases += [(dtype, RNNT_EDGE[0], RNNT_EDGE[1], packed) for packed in (False, True)
              for dtype in (torch.bfloat16, torch.float32)]
    for dtype, (Bsz, T, U), lengths, packed in cases:
        logits, tg, fl, tl = rnnt_inputs(Bsz, T, U, dtype, seed=SEED, lengths=lengths)
        classes = RNNT_CLASSES
        if packed:
            logits, classes = logits[..., :RNNT_CLASSES].contiguous(), None
        g = torch.randn(Bsz, generator=torch.Generator().manual_seed(SEED)).cuda()
        got = rnnt_pair(rnnt_cuda._forward, rnnt_cuda._backward, logits, tg, fl, tl, g, classes)
        again = rnnt_pair(rnnt_cuda._forward, rnnt_cuda._backward, logits, tg, fl, tl, g,
                          classes)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        ref, ref64 = (rnnt_pair(rnnt_fwd_plain, rnnt_bwd_plain, logits.to(d), tg, fl, tl,
                                g.to(d), classes) for d in (torch.float32, torch.float64))
        c = rnnt_check(got, ref, ref64, fl, tl, g, RNNT_CLASSES)
        name = str(dtype).removeprefix("torch.")
        faults = {}
        if (Bsz, T, U) == RNNT_SHAPES[0]:
            faults = {k: rnnt_check(f, ref, ref64, fl, tl, g, RNNT_CLASSES)
                      for k, f in rnnt_faults(got, fl, tl, tg, RNNT_BLANK).items()}
        abs_err = {"fwd": (got[0] - ref[0]).abs().max().item(),
                   "bwd": (got[3].double() - ref64[3]).abs().max().item()}
        del ref, ref64
        tm = rnnt_timing(logits, tg, fl, tl, g) if not packed else None
        log(f"  rnnt {name} B{Bsz} T{T} U{U}{' edge rows' if lengths else ''}"
            f"{', 501 contiguous columns' if packed else ''}: loss rel {c['loss_rel']:.3e} "
            f"(bound {RNNT_LOSS_RTOL:g}); cb/cl against fp64 max|d|/max|g| kernel "
            f"{c['grad_err']:.3e} (bound {RNNT_GRAD_BOUND:g}), plain fp32 {c['plain_err']:.3e}; "
            f"dlogits beyond one {name} rounding {c['dlogit_err']:.3e} of their max (bound "
            f"{RNNT_GRAD_BOUND:g}); cells' dlogit sums {c['cell_sum']:.3e} of |cb| + |cl| "
            f"(bound {RNNT_CELL_BOUND[dtype]:g}); alignment mass {c['mass']:.3e} of |g| (bound "
            f"{RNNT_MASS_BOUND:g}); zeros outside the lattices and in the pad columns "
            f"{c['zeros']}, bitwise repeat {bitwise}")
        if tm is not None:
            ms, plain, cost = tm["ms"], tm["plain_ms"], tm["cost"]
            log(f"    kernel fwd {ms['fwd']:.4f} ms bwd {ms['bwd']:.4f} ms ("
                + ", ".join(f"{kernel_name(k)} {v:.4f}"
                            for part in tm["parts"].values() for k, v in part.items())
                + f"; launches a call {tm['launches']['fwd']} / {tm['launches']['bwd']}), plain "
                f"fwd {plain['fwd']:.3f} ms bwd {plain['bwd']:.3f} ms; bound fwd "
                f"{cost['fwd']['bound_ms'] * 1e3:.2f} us bwd "
                f"{cost['bwd']['bound_ms'] * 1e3:.2f} us ({cost['fwd']['bound_by']}), share "
                f"{tm['share']['fwd']:.2%} / "
                f"{tm['share']['bwd']:.2%}")
        for k, f in faults.items():
            log(f"    planted fault, {k}: cb/cl {f['grad_err']:.3e}, mass {f['mass']:.3e}, "
                f"cell sums {f['cell_sum']:.3e}, dlogits {f['dlogit_err']:.3e}, zeros "
                f"{f['zeros']}: {'rejected' if not f['ok'] else 'NOT REJECTED'}")
        if not (c["ok"] and bitwise) or any(f["ok"] for f in faults.values()) or (
                tm is not None and tm["launches"] != {"fwd": 2, "bwd": 2}):
            raise AssertionError(f"rnnt kernels at {name} B {Bsz} T {T} U {U}: {c}, bitwise "
                                 f"{bitwise}, launches {tm and tm['launches']}, planted faults "
                                 f"passed: {[k for k, f in faults.items() if f['ok']]}")
        if tm is not None:
            rows.append(dict(dtype=name, B=Bsz, T=T, U=U, edge=lengths is not None, ms=ms,
                             plain_ms=plain, cost=cost, check=c, abs_err=abs_err,
                             parts=tm["parts"]))
        del logits, got
        torch.cuda.empty_cache()
    found = importlib.util.find_spec("torchaudio") is not None
    log(f"  library: torchaudio {'installed' if found else 'not installed'}; no PyTorch "
        f"call computes the transducer loss")
    log("phase 2 rnnt: ok")
    return rows


def phase_rnnt_grads(cmvn) -> dict:
    """phase_grads for the gate config with the RNN-T head (depth 1 + 2 + 1,
    fp32): the card's micro-step goes through the loss kernels, one call
    each way."""
    from hnet_mamba_asr_torch.ops.rnnt_cuda import rnnt_loss_cuda
    from hnet_mamba_asr_torch.tools.gate import RNNT_CONFIG
    rnnt_loss_cuda.launches = rnnt_loss_cuda.bwd_launches = 0
    phase_grads(cmvn, RNNT_CONFIG, "rnnt")
    launches = {"rnnt_fwd": rnnt_loss_cuda.launches, "rnnt_bwd": rnnt_loss_cuda.bwd_launches}
    if launches != {"rnnt_fwd": 1, "rnnt_bwd": 1}:
        raise AssertionError(f"the card's RNN-T micro-step launched {launches}")
    return launches


def phase_train_config(cmvn, tmp: Path, config=None, label="rnnt") -> dict:
    """The gate config with the RNN-T head (or ``config``: the MoE AED
    decoder) through Trainer: 3 updates of accum_grad 2 x (32 x 10 s), bf16:
    finite losses, 40 + 40 SSD launches and (RNN-T) one rnnt_fwd and one
    rnnt_bwd launch per micro-step; step time and peak memory; with MoE the
    moe/aux and moe/dropped stats finite."""
    from hnet_mamba_asr_torch.ops.rnnt_cuda import rnnt_loss_cuda
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.tools.gate import RNNT_CONFIG
    config = RNNT_CONFIG if config is None else config
    accum = GATE_TRAIN["accum_grad"]
    batches = train_batches(np.random.default_rng(SEED + 13), 3 * accum, TRAIN_ROWS)
    trainer = gate_trainer(config, batches, GATE_TRAIN, cmvn, tmp / f"train_{label}",
                           max_steps=3)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    torch.cuda.reset_peak_memory_stats()
    ssd_cuda.launches = ssd_cuda.bwd_launches = 0
    rnnt_loss_cuda.launches = rnnt_loss_cuda.bwd_launches = 0
    trainer.train()
    torch.cuda.synchronize()
    launches = {"ssd_fwd": ssd_cuda.launches, "ssd_bwd": ssd_cuda.bwd_launches,
                "rnnt_fwd": rnnt_loss_cuda.launches, "rnnt_bwd": rnnt_loss_cuda.bwd_launches}
    peak = torch.cuda.max_memory_allocated()
    micro = accum * len(trainer.history)
    moe = "moe/aux" in trainer.history[0]
    for r in trainer.history:
        extra = (f", moe aux {r['moe/aux']:.4f} dropped {r['moe/dropped']:.4f}" if moe
                 else f", rnnt {r['loss/rnnt']:.4f}")
        log(f"  {label} step {r['step']}: loss {r['loss/total']:.4f} (ctc {r['loss/ctc']:.4f}, "
            f"aed {r['loss/aed']:.4f}{extra}) grad norm {r['grad_norm']:.6g}; {r['ms']:.1f} ms "
            f"(CUDA events)")
        vals = [r["loss/total"], r["grad_norm"]] + ([r["moe/aux"], r["moe/dropped"]] if moe
                                                   else [r["loss/rnnt"]])
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{label} step {r['step']}: not finite: {r}")
    timed = trainer.history[1:]
    step_ms = float(np.mean([r["ms"] for r in timed]))
    fps = float(np.mean([r["frames"] for r in timed])) / step_ms * 1e3
    log(f"  {label}: {n_params:,} parameters; {step_ms:.1f} ms per update of {accum} x "
        f"({TRAIN_ROWS} x 10 s) after one warm-up update, {fps:.0f} mel-frames/s; "
        f"max_memory_allocated {peak / 1e9:.2f} GB; launches per micro-step "
        + ", ".join(f"{k} {v / micro:g}" for k, v in launches.items()))
    want_rnnt = micro if config is RNNT_CONFIG else 0
    if (len(trainer.history) != 3 or launches["ssd_fwd"] != SSD_CALLS_PER_FORWARD * micro
            or launches["ssd_bwd"] != SSD_CALLS_PER_FORWARD * micro
            or launches["rnnt_fwd"] != want_rnnt or launches["rnnt_bwd"] != want_rnnt):
        raise AssertionError(f"{label}: {len(trainer.history)} updates, launches {launches} "
                             f"over {micro} micro-steps")
    if config is RNNT_CONFIG and n_params != 79_703_198:
        raise AssertionError(f"the RNN-T config has {n_params} parameters")
    step = None
    if config is RNNT_CONFIG:
        step = rnnt_micro_step(trainer, batches[0])
    del trainer
    torch.cuda.empty_cache()
    log(f"phase 5 train {label}: ok")
    return {"launches": launches, "step_ms": step_ms, "fps": fps, "peak": peak,
            "n_params": n_params, "step": step}


# the kernel classes of measure.STEP_CLASSES that the RNN-T micro-step must
# not run on the joint's lattice: the loss kernels take the logits as the
# joint's GEMM writes them and return dlogits in the same layout
RNNT_ABSENT = ("log-softmax", "gather / scatter / select / slice", "cast / copy")


def rnnt_micro_step(trainer, batch) -> dict:
    """One RNN-T micro-step (forward and backward of ``loss_fn``) profiled
    (``measure.rnnt_step_profile``): the device ms by kernel class on the
    ops that span the joint's lattice, listed with the loss kernels; no
    log-softmax, gather, select, slice, cast or copy kernel over the
    lattice, and the two forward and two backward loss launches."""
    from hnet_mamba_asr_torch.ops.rnnt_cuda import rnnt_loss_cuda
    from hnet_mamba_asr_torch.tools.measure import rnnt_step_profile
    b = trainer._to_device(batch)
    trainer.model.train()
    before = (rnnt_loss_cuda.launches, rnnt_loss_cuda.bwd_launches)
    prof = rnnt_step_profile(trainer.model, b)
    calls = (rnnt_loss_cuda.launches - before[0], rnnt_loss_cuda.bwd_launches - before[1])
    log(f"  rnnt micro-step profile, lattice {prof['lattice']}: device {prof['device_ms']:.2f} "
        f"ms; on the lattice by class "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in prof["classes_ms"].items())
        + "; loss kernels " + ", ".join(f"{kernel_name(k)} {v:.4f} ms"
                                       for k, v in prof["loss_kernels_ms"].items())
        + f"; {calls[0]} forward and {calls[1]} backward calls in 2 profiled micro-steps")
    for k, v in list(prof["lattice_ops_ms"].items())[:12]:
        log(f"    {v:8.3f} ms  {k}")
    present = {k: v for k, v in prof["classes_ms"].items() if k in RNNT_ABSENT and v > 0}
    names = [kernel_name(k) for k in prof["loss_kernels_ms"]]
    if present or calls != (2, 2) or len(names) != 4:
        raise AssertionError(f"the RNN-T micro-step ran {present} on the lattice, loss calls "
                             f"{calls}, loss kernels {names}")
    return prof


def _requests(seed: int, n: int = 8):
    rng = np.random.default_rng(seed)
    waves = [synth_audio(rng, float(s)) for s in rng.uniform(2.0, 16.0, size=n)]
    lens = np.array([len(w) for w in waves])
    padded = np.zeros((n, lens.max()), np.float32)
    for i, w in enumerate(waves):
        padded[i, :len(w)] = w
    return waves, lens, padded


# requests of phase 4's RNN-T serving decoded alone: the shortest 4 of 8 (a
# cut for the time limit; the micro-batcher still serves all 8)
RNNT_SERVE_ALONE = 4


def phase_rnnt_serve(cmvn) -> dict:
    """The RNN-T config serving rnnt_ids (greedy) and rnnt_beam_ids (the
    device beam, 10 wide) in bf16: 8 requests of 2-16 s in one call, the
    RNNT_SERVE_ALONE shortest alone and all 8 through the micro-batcher: ids
    equal; ms per call."""
    from hnet_mamba_asr_torch.serving.runtime import ServingModel
    from hnet_mamba_asr_torch.serving.server import MicroBatcher
    from hnet_mamba_asr_torch.tools.gate import RNNT_CONFIG
    model = ServingModel(RNNT_CONFIG, None, "cuda", vocab_size=VOCAB, cmvn=cmvn, seed=SEED,
                         emit=("rnnt_ids", "rnnt_beam_ids"))
    waves, lens, padded = _requests(SEED + 4)
    model(padded[:1, :lens[0]], lens[:1])

    def rows(out):
        return ([out["rnnt_ids"][i, :out["rnnt_lens"][i]].tolist() for i in range(len(lens))],
                [out["rnnt_beam_ids"][i, :out["rnnt_beam_lens"][i]].tolist()
                 for i in range(len(lens))])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = rows(model(padded, lens))
    batch_ms = (time.perf_counter() - t0) * 1e3
    short = sorted(range(len(waves)), key=lambda i: len(waves[i]))[:RNNT_SERVE_ALONE]
    t0 = time.perf_counter()
    alone = [model(waves[i][None], [len(waves[i])]) for i in short]
    alone_ms = (time.perf_counter() - t0) * 1e3 / len(short)
    greedy_alone = [o["rnnt_ids"][0, :o["rnnt_lens"][0]].tolist() for o in alone]
    beam_alone = [o["rnnt_beam_ids"][0, :o["rnnt_beam_lens"][0]].tolist() for o in alone]
    batcher = MicroBatcher(model, max_wait_ms=50.0)
    try:
        served = [f.result(timeout=600)["ids"] for f in [batcher.submit(w) for w in waves]]
        stats = batcher.stats()
    finally:
        batcher.close()
    log(f"  rnnt_ids + rnnt_beam_ids, 8 requests of "
        f"{sorted(round(len(w) / SR, 2) for w in waves)} s: one call {batch_ms:.1f} ms, alone "
        f"{alone_ms:.1f} ms a call (the {len(short)} shortest); greedy alone == batched "
        f"{greedy_alone == [batched[0][i] for i in short]}, beam alone == batched "
        f"{beam_alone == [batched[1][i] for i in short]}, micro-batcher rows == beam ids "
        f"{served == batched[1]} ({stats['batches']} batches); greedy lengths "
        f"{[len(b) for b in batched[0]]}, beam lengths {[len(b) for b in batched[1]]}")
    differ = {name: [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
              for name, got, want in (("greedy", greedy_alone, [batched[0][i] for i in short]),
                                      ("beam", beam_alone, [batched[1][i] for i in short]),
                                      ("batcher", served, batched[1]))}
    if any(differ.values()):
        raise AssertionError(f"served RNN-T ids differ alone and batched: {differ}")
    if not all(0 <= t < VOCAB for ids in batched[0] + batched[1] for t in ids):
        raise AssertionError("served RNN-T ids out of the vocabulary")
    del model
    torch.cuda.empty_cache()
    log("phase 4 serve rnnt_ids / rnnt_beam_ids: ok")
    return {"batch_ms": batch_ms, "alone_ms": alone_ms}


# the full-width RNN-T decode run: the config's search settings over the
# transducer's cells, the engines of ENGINES (the host's transducer engine
# is "serial": one utterance at a time)
RNNT_DECODE = {"read_outs": ["rnnt"], "search": ["greedy", "beam"], "beam_size": 10,
               "lm": "enabled", "lm_weight": 0.3, "rescore_weight": 0.6,
               "rescore_length_bonus": 2.0}
# what the run spends on the slowest searches, to stay within its time
# limit: the host's rnnt_beam_lm, one utterance at a time in Python, decodes
# the RNNT_HOST_LM_UTTS shortest of the 8 and its rnnt_beam the
# RNNT_HOST_BEAM_UTTS shortest (the device engine all 8 in every cell), and
# the device engine's rnnt_beam_lm decodes the RNNT_ALONE shortest alone
RNNT_HOST_LM_UTTS = 2
RNNT_HOST_BEAM_UTTS = 4
RNNT_ALONE = 1


def phase_rnnt_decode_full(cmvn, tmp: Path) -> dict:
    """The RNN-T config at full width (seeded, bf16) and the full-width LM
    (seeded, fp32) cut to DECODE_LM_LAYERS layers, as phase 13's: phase 13's
    8 utterances through rnnt_greedy, rnnt_beam and rnnt_beam_lm with the
    shared encoder on the device engine and the
    host's (its rnnt_beam over the RNNT_HOST_BEAM_UTTS shortest, its
    rnnt_beam_lm over the RNNT_HOST_LM_UTTS shortest): per cell
    and engine the RTF, encoder and search seconds, and on the device engine
    the device's idle share (the cell alone on the first STEP_PROBE frames
    of the shortest utterance under torch.profiler); the engines'
    disagreements in bf16 and their scores; where they part, those
    utterances again with the same weights in fp32, where the two engines
    give the same transcripts (a disagreement only where the best scores
    tie within TIE_SHARE); the RNNT_ALONE shortest utterances alone ==
    batched in rnnt_beam_lm on the device engine (the served modes hold all
    8 alone == batched, phase 4)."""
    from hnet_mamba_asr_torch.data.dataset import ItemLoader, collate_batch
    from hnet_mamba_asr_torch.decoders.lm_scorer import CausalLMScorer
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.tasks import decode_task
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tasks.lm_task import build_lm
    from hnet_mamba_asr_torch.tools.gate import LM_CONFIG, RNNT_CONFIG, seeded_tokenizer
    model = build_model(RNNT_CONFIG, VOCAB, cmvn=cmvn, seed=SEED)
    lm = build_lm(cut_lm(LM_CONFIG), VOCAB, seed=SEED)
    tok = seeded_tokenizer(tmp / "tok500_rnnt.model")
    scorer = CausalLMScorer(lm.lm, bos_id=tok.bos_id, eos_id=tok.eos_id, pad_id=tok.pad_id)
    items = decode_batch_items(np.random.default_rng(SEED + 50), DECODE_UTTS)
    audio_s = {it["id"]: it["n_samples"] / SR for it in items}
    by_length = sorted(items, key=lambda it: it["n_samples"])
    short_batch = next(iter(ItemLoader(by_length[:1], 10 ** 7, shuffle=False)))
    runs = {}
    for engine, change in ENGINES:
        dc = dict(RNNT_DECODE, **change)
        cells = decode_task.expand_cells(dc)
        # (cells, utterances) of each decode run of this engine
        plan = [(cells, items)]
        if engine == "lockstep":
            plan = [([c for c in cells if c["name"] == name], run_items)
                    for name, run_items in (("rnnt_greedy", items),
                                            ("rnnt_beam", by_length[:RNNT_HOST_BEAM_UTTS]),
                                            ("rnnt_beam_lm", by_length[:RNNT_HOST_LM_UTTS]))]
        torch.cuda.synchronize()
        ssd_cuda.launches = 0
        t0 = time.perf_counter()
        summaries = [s for run_cells, run_items in plan
                     for s in decode_task.decode_split_shared(
                         model, tok, ItemLoader(run_items, 10 ** 7, shuffle=False), run_cells,
                         dc, audio_seconds={it["id"]: audio_s[it["id"]] for it in run_items},
                         out_dir=tmp / f"rnnt_{engine}", split="synthetic", lm=scorer)]
        wall = time.perf_counter() - t0
        launches = ssd_cuda.launches
        records = {c["name"]: {r["id"]: r for r in map(json.loads, (
            tmp / f"rnnt_{engine}" / c["name"] / "synthetic.jsonl").read_text().splitlines())}
            for c in cells}
        rows = {c["name"]: dict(idle_short=None, utts=len(run_items))
                for run_cells, run_items in plan for c in run_cells}
        t1 = time.perf_counter()
        enc, _ = decode_task.encode_batch(model, short_batch)
        # the profiler's cost grows with the launches it records: the
        # searches' first STEP_PROBE frames
        enc = enc._replace(features=enc.features[:, :STEP_PROBE],
                           lengths=enc.lengths.clamp(max=STEP_PROBE))
        for cell in cells if engine == "device" else ():
            idle, _, _ = profile_cell(lambda: decode_task.decode_batch(
                model, tok, short_batch, cell, dc, lm=scorer, enc=enc, enc_s=0.0))
            rows[cell["name"]]["idle_short"] = idle
        log(f"  {engine}: decode run {wall:.1f} s, profiled cells "
            f"{time.perf_counter() - t1:.1f} s")
        for s in summaries:
            rows[s["cell"]].update(rtf=s["rtf"], encoder_s=s["encoder_s"],
                                   search_s=s["search_s"], engine=s["engine"], n=s["n_utts"])
        runs[engine] = dict(cells=rows, records=records, wall=wall, launches=launches,
                            forwards=2 * len(plan))
    agree = {name: sorted(u for u, h in runs["lockstep"]["records"][name].items()
                          if h["hyp"] != runs["device"]["records"][name][u]["hyp"])
             for name in runs["device"]["records"]}
    # where the engines part in bf16: the same weights in fp32, where they
    # agree but on ties (float32 scores against float64)
    fp32 = {}
    if any(agree.values()):
        cfg32 = copy.deepcopy(RNNT_CONFIG)
        cfg32["train"]["precision"] = "fp32"
        cfg32["encoder_conf"]["ssd_intra_dtype"] = None
        model32 = build_model(cfg32, VOCAB, cmvn=cmvn, seed=SEED)
        for cell in decode_task.expand_cells(RNNT_DECODE):
            uids = agree[cell["name"]]
            if not uids:
                continue
            batch = next(iter(ItemLoader([it for it in items if it["id"] in uids], 10 ** 7,
                                         shuffle=False)))
            enc32, _ = decode_task.encode_batch(model32, batch)
            got = {e: decode_task.decode_batch(model32, tok, batch, cell,
                                               dict(RNNT_DECODE, **ch), lm=scorer, enc=enc32,
                                               enc_s=0.0) for e, ch in ENGINES}
            diff, ties = 0, 0
            for d, h in zip(got["device"], got["lockstep"]):
                if d["hyp"] == h["hyp"]:
                    continue
                diff += 1
                a, b = d["score"], h["score"]
                ties += (a is not None and b is not None
                         and abs(a - b) <= TIE_SHARE * max(abs(a), abs(b)))
            fp32[cell["name"]] = {"differ": diff, "ties": ties}
        del model32
    dc = dict(RNNT_DECODE)
    lm_cell = next(c for c in decode_task.expand_cells(dc) if c["name"] == "rnnt_beam_lm")
    t1 = time.perf_counter()
    alone = {it["id"]: decode_task.decode_batch(model, tok, collate_batch(
        [it], pad_id=3, seed=0, epoch=0), lm_cell, dc, lm=scorer)[0]["hyp"]
        for it in by_length[:RNNT_ALONE]}
    alone_s = time.perf_counter() - t1
    alone_ok = all(h == runs["device"]["records"]["rnnt_beam_lm"][u]["hyp"]
                   for u, h in alone.items())
    for name in runs["device"]["cells"]:
        for engine, _ in ENGINES:
            c = runs[engine]["cells"][name]
            idle = ("not measured" if c["idle_short"] is None
                    else f"{c['idle_short']:.2%} (the shortest alone, {STEP_PROBE} frames)")
            audio = sum(sorted(audio_s.values())[:c["utts"]])
            log(f"  {name:<13} {c['engine']:<7} RTF {c['rtf']:.5f}: encoder "
                f"{c['encoder_s']:.4f} s, search {c['search_s']:.4f} s over {c['utts']} "
                f"utterances ({audio:.2f} s of audio); device idle {idle}")
        log(f"  {name:<13} engines differ in bf16 on {len(agree[name])}/"
            f"{len(runs['lockstep']['records'][name])}"
            + (f"; in fp32 on {fp32[name]['differ']} of those, {fp32[name]['ties']} of them "
               f"ties" if name in fp32 else ""))
    log(f"  rnnt_beam_lm device engine: the {RNNT_ALONE} shortest requests alone == inside "
        f"the batch {alone_ok} ({alone_s:.1f} s); decode runs "
        f"{[round(r['wall'], 1) for r in runs.values()]} s; hypothesis lengths (device) "
        + ", ".join(f"{n} {[len(r['hyp'].split()) for r in recs.values()]}"
                    for n, recs in runs["device"]["records"].items()))
    bad = [n for n, f in fp32.items() if f["differ"] != f["ties"]]
    missing = [(e, n) for e, r in runs.items() for n, c in r["cells"].items()
               if c["n"] != c["utts"]]
    if bad or missing or not alone_ok:
        raise AssertionError(f"RNN-T decode: fp32 engines differ beyond ties in {bad}, cells "
                             f"without every utterance {missing}, alone == batched {alone_ok}")
    if any(r["launches"] != r["forwards"] * SSD_CALLS_PER_FORWARD for r in runs.values()):
        raise AssertionError(f"RNN-T decode ssd launches {[r['launches'] for r in runs.values()]}")
    del model, lm, scorer, enc
    torch.cuda.empty_cache()
    log("phase 15 rnnt decode full width: ok")
    return {"engines": {e: r["cells"] for e, r in runs.items()},
            "bf16_differ": {k: len(v) for k, v in agree.items()}, "fp32": fp32}


# the RNN-T tone gate (tests/test_overfit_gate_rnnt.py's recipe): JAX trains
# 240 epochs from its own draw; see RNNT_GATE_EPOCHS
RNNT_GATE_EPOCHS = 240
RNNT_GATE_WER = 15.0            # tests/test_overfit_gate_rnnt.py's bar
# the trained transducer's three cells (the gate config's search settings;
# the LM is phase 11's narrow tone LM) and the test-clean utterances, the
# shortest first, decoded alone in each beam cell on the device engine
RNNT_TONE_DECODE = dict(RNNT_DECODE, batch_bins=8000)
RNNT_TONE_ALONE = 4


def rnnt_tone_decode(model, tok, root: Path, lm, out: Path) -> dict:
    """test-clean through rnnt_greedy, rnnt_beam and rnnt_beam_lm (fp32
    model, fused ``lm``) on the device engine and the host's: each cell's
    scores, the engines' disagreements (ties: best scores within
    TIE_SHARE), and the RNNT_TONE_ALONE shortest utterances alone against
    their device-engine transcripts in the batch, in both beam cells."""
    from hnet_mamba_asr_torch.data.dataset import ItemLoader, collate_batch, manifest_items
    from hnet_mamba_asr_torch.eval.score import score_decode_dir
    from hnet_mamba_asr_torch.tasks import decode_task
    manifest = root / "manifests" / "test-clean.jsonl"
    items = manifest_items(manifest, tok)
    records, scores = {}, {}
    for engine, change in ENGINES:
        dc = dict(RNNT_TONE_DECODE, **change)
        cells = decode_task.expand_cells(dc)
        decode_task.decode_split_shared(
            model, tok, ItemLoader(items, dc["batch_bins"], shuffle=False), cells, dc,
            out_dir=out / engine, split="test-clean", lm=lm,
            audio_seconds=decode_task.audio_seconds_from_manifest(manifest))
        scores[engine] = score_decode_dir(out / engine, n_bootstrap=50,
                                          goal_cfg={"sane_test_clean_wer_below": RNNT_GATE_WER},
                                          gate_cell="rnnt_greedy")
        records[engine] = {c["name"]: {r["id"]: r for r in map(json.loads, (
            out / engine / c["name"] / "test-clean.jsonl").read_text().splitlines())}
            for c in cells}
    agree = {}
    for name, dev in records["device"].items():
        host = records["lockstep"][name]
        differ = [u for u in dev if dev[u]["hyp"] != host[u]["hyp"]]
        ties = [u for u in differ if dev[u]["score"] is not None
                and host[u]["score"] is not None
                and abs(dev[u]["score"] - host[u]["score"])
                <= TIE_SHARE * max(abs(dev[u]["score"]), abs(host[u]["score"]))]
        agree[name] = {"n": len(dev), "differ": len(differ), "ties": len(ties)}
    dc = dict(RNNT_TONE_DECODE)
    beam_cells = [c for c in decode_task.expand_cells(dc) if c["search"] == "beam"]
    shortest = sorted(items, key=lambda it: it["n_samples"])[:RNNT_TONE_ALONE]
    alone = [(c["name"], it["id"], decode_task.decode_batch(
        model, tok, collate_batch([it], pad_id=tok.pad_id, seed=0, epoch=0), c, dc,
        lm=lm)[0]["hyp"]) for it in shortest for c in beam_cells]
    alone_differ = [(n, u) for n, u, h in alone if h != records["device"][n][u]["hyp"]]
    lengths = {n: float(np.mean([len(r["hyp"].split()) for r in recs.values()]))
               for n, recs in records["device"].items()}
    return {"scores": scores, "agree": agree, "alone": len(alone),
            "alone_differ": alone_differ, "mean_words": lengths}


def phase_rnnt_gate(tmp: Path, lm) -> dict:
    """The RNN-T gate proof on the tone corpus (phase 10's): overfit_config
    with ctc 0, rnnt 1.0, d_pred 32, d_joint 64, lr 5e-3 for
    RNNT_GATE_EPOCHS epochs through Trainer, the lattice kernels' gradients
    (one launch each way per update), then test-clean through decode_task's
    rnnt_greedy, rnnt_beam and rnnt_beam_lm (phase 11's tone LM) on both
    engines (``rnnt_tone_decode``) and the port's score gate: the dev WER
    collapses below RNNT_GATE_WER and below its first value, test-clean's
    rnnt_greedy WER is below RNNT_GATE_WER on 24 utterances, the engines
    give the same transcripts in every cell (or tie), and the beam cells
    decode the RNNT_TONE_ALONE shortest utterances alone as in the batch."""
    from hnet_mamba_asr_torch.data.synthetic import overfit_config
    from hnet_mamba_asr_torch.ops.rnnt_cuda import rnnt_loss_cuda
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    root = tmp / "gate"
    tok, cmvn = tone_load(root)
    cfg = overfit_config(root, max_epoch=RNNT_GATE_EPOCHS, lr=5.0e-3, valid_interval=40,
                         ctc_weight=0.0)
    cfg["model_conf"]["rnnt_weight"] = 1.0
    cfg["rnnt_conf"] = {"d_pred": 32, "d_joint": 64}
    ssd_cuda.launches = ssd_cuda.bwd_launches = 0
    rnnt_loss_cuda.launches = rnnt_loss_cuda.bwd_launches = 0
    t0 = time.perf_counter()
    trainer = tone_train(cfg, tok, cmvn, root, "rnnt")
    train_s = time.perf_counter() - t0
    launches = {"ssd_fwd": ssd_cuda.launches, "ssd_bwd": ssd_cuda.bwd_launches,
                "rnnt_fwd": rnnt_loss_cuda.launches, "rnnt_bwd": rnnt_loss_cuda.bwd_launches}
    wers = list(trainer.metric_history[("valid", "wer")].values())
    losses = [r["loss/total"] for r in trainer.history]
    log(f"  rnnt gate: {len(trainer.history)} updates in {train_s:.1f} s, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, dev WER every 40 epochs "
        f"{[round(w, 2) for w in wers]}; launches {launches}")
    if not (wers and wers[-1] < RNNT_GATE_WER and wers[-1] < wers[0]
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"the RNN-T gate model did not learn: dev WER {wers}")
    if launches["rnnt_fwd"] < len(trainer.history) or launches["rnnt_bwd"] != len(
            trainer.history):
        raise AssertionError(f"the RNN-T training did not run the lattice kernels: {launches}")
    t0 = time.perf_counter()
    res = rnnt_tone_decode(trainer.model, tok, root, lm, root / "decode_rnnt")
    gate = res["scores"]["device"]["gate"]
    cells = {e: sc["splits"]["test-clean"]["cells"] for e, sc in res["scores"].items()}
    for name, a in res["agree"].items():
        log(f"  {name:<13} test-clean WER device {cells['device'][name]['wer']:.3f}, host "
            f"{cells['lockstep'][name]['wer']:.3f}, {res['mean_words'][name]:.1f} words an "
            f"utterance; engines differ on {a['differ']}/{a['n']}, {a['ties']} of them ties")
    log(f"  rnnt_greedy gate {gate}; beam cells alone == inside the batch on "
        f"{res['alone'] - len(res['alone_differ'])}/{res['alone']} ({RNNT_TONE_ALONE} "
        f"shortest utterances x 2 cells); decodes {time.perf_counter() - t0:.1f} s")
    n = cells["device"]["rnnt_greedy"]["n_utts"]
    apart = [k for k, a in res["agree"].items() if a["differ"] != a["ties"] or a["n"] != n]
    if not (n == 24 and cells["device"]["rnnt_greedy"]["wer"] < RNNT_GATE_WER
            and gate.get("passed")):
        raise AssertionError(f"the RNN-T gate failed: {cells['device']['rnnt_greedy']}, {gate}")
    if apart or res["alone_differ"]:
        raise AssertionError(f"RNN-T tone decode: engines apart beyond ties in {apart}, "
                             f"alone != batched {res['alone_differ']}")
    del trainer
    torch.cuda.empty_cache()
    log("phase 16 rnnt gate proof: ok")
    return {"dev_wer": wers, "wer": cells["device"]["rnnt_greedy"]["wer"],
            "launches": launches, "train_s": train_s, "updates": len(losses),
            "agree": res["agree"]}


# MoEFFN card vs CPU in fp32 (TF32 off): the routing equal, then the output
# and aux to 1e-5 and every gradient to 1e-4 of its max (summation order)
MOE_BOUND = 1e-5
MOE_GRAD_BOUND = 1e-4
# the capacity factor of that check: random tokens spread over the experts
# evenly enough that 1.25 drops none; at 0.5 each expert owns 100 slots of
# its ~200 choices and drops are present
MOE_FFN_CAPACITY = 0.5
MOE_ALONE = 2                   # ctc_beam_lm requests with the MoE LM decoded alone


def phase_moe(cmvn, tmp: Path) -> dict:
    """The MoE FFN and models: MoEFFN (d 384, d_ff 2048, 8 experts, top 2,
    capacity MOE_FFN_CAPACITY) card vs CPU in fp32 on 4 x 200 tokens with a
    token mask, capacity drops present; the MoE gate config through Trainer (3
    updates); aed_beam at full width on the MoE model (AED cap DECODE_CAP),
    and the dropped share of its teacher-forced decoder on the batch's
    references; ctc_beam_lm at full width with the MoE fusion LM (cut to
    DECODE_LM_LAYERS layers, as phase 13's) scored dropless, the MOE_ALONE
    shortest requests alone == inside the batch."""
    from hnet_mamba_asr_torch.data.dataset import ItemLoader, collate_batch
    from hnet_mamba_asr_torch.decoders.lm_scorer import CausalLMScorer
    from hnet_mamba_asr_torch.models.moe import MoEFFN
    from hnet_mamba_asr_torch.tasks import decode_task
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tasks.lm_task import build_lm
    from hnet_mamba_asr_torch.tools.gate import (
        GATE_DECODE, LM_MOE_CONFIG, MOE, MOE_CONFIG, seeded_tokenizer)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(4, 200, 384, generator=gen)
    mask = torch.ones(4, 200, dtype=torch.bool)
    mask[3, 120:] = False
    g = torch.randn(x.shape, generator=gen)
    out = {}
    for dev in ("cuda", "cpu"):
        m = MoEFFN(384, 2048, MOE["n_experts"], MOE["top_k"], MOE_FFN_CAPACITY,
                   generator=torch.Generator().manual_seed(SEED)).to(dev)
        xd = x.to(dev).requires_grad_()
        y, aux, dropped = m(xd, mask.to(dev))
        grads = torch.autograd.grad((y * g.to(dev)).sum() + aux, [xd] + list(m.parameters()))
        out[dev] = (y.detach().cpu(), aux.item(), dropped.item(), [t.cpu() for t in grads])
    (yk, auxk, dk, gk), (yp, auxp, dp, gp) = out["cuda"], out["cpu"]
    y_err = ((yk - yp).abs().max() / yp.abs().max()).item()
    g_err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(gk, gp))
    log(f"  MoEFFN fp32 card vs CPU, 4 x 200 tokens (120 of the last masked): dropped "
        f"{dk:.4f} (CPU {dp:.4f}), aux {auxk:.6f} (CPU {auxp:.6f}), y max|d|/max|y| "
        f"{y_err:.3e} (bound {MOE_BOUND:g}), gradients worst {g_err:.3e} (bound "
        f"{MOE_GRAD_BOUND:g})")
    if not (dk == dp and dk > 0 and y_err <= MOE_BOUND and g_err <= MOE_GRAD_BOUND
            and abs(auxk - auxp) <= MOE_BOUND * abs(auxp)):
        raise AssertionError("MoEFFN card and CPU disagree")
    train = phase_train_config(cmvn, tmp, MOE_CONFIG, "moe")

    # aed_beam at full width on the MoE model, and the MoE LM scoring dropless
    cfg = copy.deepcopy(MOE_CONFIG)
    cfg["aed_conf"]["max_decode_len"] = DECODE_CAP
    model = build_model(cfg, VOCAB, cmvn=cmvn, seed=SEED)
    lm = build_lm(decode_task.dropless(cut_lm(LM_MOE_CONFIG)), VOCAB, seed=SEED)
    tok = seeded_tokenizer(tmp / "tok500_moe.model")
    scorer = CausalLMScorer(lm.lm, bos_id=tok.bos_id, eos_id=tok.eos_id, pad_id=tok.pad_id)
    items = decode_batch_items(np.random.default_rng(SEED + 50), DECODE_UTTS)
    audio_s = {it["id"]: it["n_samples"] / SR for it in items}
    dc = dict(GATE_DECODE, read_outs=["ctc", "aed"])
    cells = [c for c in decode_task.expand_cells(dc) if c["name"] in ("aed_beam", "ctc_beam_lm")]
    summaries = decode_task.decode_split_shared(
        model, tok, ItemLoader(items, 10 ** 7, shuffle=False), cells, dc,
        audio_seconds=audio_s, out_dir=tmp / "moe_decode", split="synthetic", lm=scorer)
    recs = {c["name"]: {r["id"]: r["hyp"] for r in map(json.loads, (
        tmp / "moe_decode" / c["name"] / "synthetic.jsonl").read_text().splitlines())}
        for c in cells}
    lm_cell = next(c for c in cells if c["name"] == "ctc_beam_lm")
    alone_ok = all(decode_task.decode_batch(model, tok, collate_batch([it], pad_id=3, seed=0,
                                                                      epoch=0), lm_cell, dc,
                                            lm=scorer)[0]["hyp"] == recs["ctc_beam_lm"][it["id"]]
                   for it in sorted(items, key=lambda it: it["n_samples"])[:MOE_ALONE])
    batch = next(iter(ItemLoader(items, 10 ** 7, shuffle=False)))
    enc, _ = decode_task.encode_batch(model, batch)
    with torch.inference_mode():
        toks = torch.as_tensor(batch["tokens"]).cuda()
        ys_in, _, _ = model.aed.add_sos_eos(toks, torch.as_tensor(batch["token_lens"]).cuda())
        stats = []
        model.aed(enc.features, enc.lengths, ys_in, moe_stats=stats)
        aed_dropped = float(sum(d for _, d in stats) / len(stats))
    for s in summaries:
        log(f"  MoE {s['cell']:<12} RTF {s['rtf']:.5f}: encoder {s['encoder_s']:.4f} s, search "
            f"{s['search_s']:.4f} s over {s['n_utts']} utterances, engine {s['engine']}")
    log(f"  MoE AED teacher-forced on the references: dropped share {aed_dropped:.4f} "
        f"(capacity 1.25: a request alone and in a batch route differently by design, not "
        f"compared); MoE LM dropless (capacity factor "
        f"{lm.lm.blocks[0].moe.capacity_factor:g}): ctc_beam_lm {MOE_ALONE} requests alone == "
        f"inside the batch {alone_ok}; LM parameters {sum(p.numel() for p in lm.parameters()):,}")
    if not alone_ok or any(s["n_utts"] != DECODE_UTTS for s in summaries):
        raise AssertionError("MoE decode: a cell lacks records, or the dropless LM's "
                             "ctc_beam_lm differs alone and batched")
    del model, lm, scorer, enc
    torch.cuda.empty_cache()
    log("phase 17 moe: ok")
    return {"train": train, "aed_dropped": aed_dropped, "ffn_dropped": dk,
            "rtf": {s["cell"]: s["rtf"] for s in summaries}}

# streaming (phase 18): streamed against offline in fp32 (TF32 off), at
# JAX's bar (tests/test_streaming.py), every block of 16 encoder frames
# (640 ms); the carried EMA kernel against ema_stream, as max|d| / max|ref|
# (the recurrence in fp32: EMA_SEQ_BOUND); the covering window at JAX's
# 1e-4 (tests/test_streaming.py:98)
STREAM_BOUND = 2e-4
WINDOW_BOUND = 1e-4
# a carried beam's scores against one pass over the same frames (fp32 sums)
BEAM_CARRY_BOUND = 1e-5
STREAM_BLOCK = 16
STREAM_SESSIONS = 8
# the transducer's utterance (4 labels a frame x 99 frames fit its 512-token
# cap offline) and the exact-causal and windowed ones
STREAM_SECONDS = (4.0, 6.0)


def _stream_feed(feed, wave, rng) -> list:
    """Ragged pushes of 0.05-0.3 s through ``feed``; its outputs, joined."""
    out, i = [], 0
    while i < len(wave):
        n = int(rng.integers(800, 4800))
        out += feed(wave[i:i + n])
        i += n
    return out


def _tail(stream) -> list:
    """A stream's ``finish()`` as a list of its segment (none at the end)."""
    tail = stream.finish()
    return [] if tail is None else [tail]


def _close(got, want, bound) -> float:
    """max |got - want| / (bound (1 + |want|)): <= 1 is assert_allclose's
    pass at rtol = atol = bound."""
    return ((got - want).abs() / (bound * (1 + want.abs()))).max().item()


def _check_beam_carry(model, pool, wave, rng, K: int, L: int) -> None:
    """The whole carried beam of a streamed transducer session: the streamed
    encoder's blocks (each padded to the block, its real frames counted, as
    the pool's step passes them) through beam_decode_nbest with the last
    call's beam passed back as ``state`` == one pass over the same frames
    (the same live hypotheses, each with its tokens and length, scores
    within BEAM_CARRY_BOUND (1 + |s|)); and the session's last carried beam
    (the pool's resident state after ``finish``) == that carried beam,
    bitwise."""
    from hnet_mamba_asr_torch.decoders.device_rnnt_beam import beam_decode_nbest
    from hnet_mamba_asr_torch.models.streaming import CausalStreamingEncoder
    stream = CausalStreamingEncoder(model, block_enc=STREAM_BLOCK)
    blocks = _stream_feed(stream.accept, wave, rng) + _tail(stream)
    state = None
    with torch.inference_mode():
        for f in blocks:
            pad = torch.zeros(STREAM_BLOCK - len(f), f.shape[1], device=f.device)
            state = beam_decode_nbest(model.rnnt, torch.cat([f, pad])[None],
                                      torch.tensor([len(f)], device=f.device), K, state=state,
                                      token_buf_len=L)
        frames = torch.cat(blocks)[None]
        one = beam_decode_nbest(model.rnnt, frames,
                                torch.tensor([frames.shape[1]], device=frames.device), K,
                                token_buf_len=L)

    def hyps(beam):
        toks, lens, score = (t[0].cpu() for t in beam[:3])
        live = score > -1e29
        return [toks[k, :lens[k]].tolist() for k in range(K) if live[k]], score[live]
    got, got_s = hyps(state)
    want, want_s = hyps(one)
    same = got == want
    ratio = _close(got_s, want_s, BEAM_CARRY_BOUND) if same else float("inf")
    pool_same = all(torch.equal(a, b) for a, b in zip(pool._resident[0]["beam"], state))
    log(f"  stream rnnt beam carry: {len(blocks)} blocks with the beam passed back == one pass "
        f"over the same {frames.shape[1]} frames: {len(want)} live hypotheses of {K} "
        f"(lengths {[len(h) for h in want]}) equal {same}, scores {want_s.tolist()} within "
        f"{ratio:.3f} of {BEAM_CARRY_BOUND:g} (1 + |s|); the session's last carried beam == "
        f"it bitwise {pool_same}")
    if not (same and ratio <= 1.0 and pool_same):
        raise AssertionError("the streamed transducer beam's carried state is not one pass's")


def drive_pool(pool, waves, rng) -> list:
    """One session a wave in ``pool``: lockstep rounds of 6400 samples
    (``feed_many``) over the first half, then ragged feeds of 900-5000
    samples (sizes from ``rng``), then ``finish``: -> each session's ids."""
    sids = [pool.open() for _ in waves]
    got = {s: [] for s in sids}
    start = -(-max(len(w) for w in waves) // 2 // 6400) * 6400
    for pos in range(0, start, 6400):               # lockstep rounds, then ragged feeds
        for sid, t in pool.feed_many([(s, w[pos:pos + 6400])
                                      for s, w in zip(sids, waves)]).items():
            got[sid] += t
    sizes = rng.integers(900, 5000, size=len(waves))
    pos = [min(start, len(w)) for w in waves]
    while any(q < len(w) for q, w in zip(pos, waves)):
        for k, sid in enumerate(sids):
            if pos[k] < len(waves[k]):
                got[sid] += pool.feed(sid, waves[k][pos[k]:pos[k] + sizes[k]])
                pos[k] += int(sizes[k])
    return [got[s] + pool.finish(s) for s in sids]


def phase_stream(cmvn) -> dict:
    """Streaming on the card, at full width from seed 1, TF32 off:
    (1) the carried ema_fwd (ema_stream_cuda) against ema_stream at B 8
    M 16 and B 64 M 256, D 384, fp32 (mixed has, real counts 0 .. M,
    saturated P): within EMA_SEQ_BOUND, has exact, two calls bitwise equal;
    the fp32 SSD kernel at L 16 from a carried state: a block of zero-dt
    rows leaves the state bitwise as it was, and a block whose tail has
    zero dt gives the state of its real rows; (2) the causal gate config and
    its N = 2 sibling (routers from draw_routers) in fp32, intra off,
    streamed (CausalStreamingEncoder, ragged pushes) against the same model
    offline: boundaries equal (frames within 1e-4 of 0.5 named), features
    at STREAM_BOUND, StreamingCTCGreedy's ids equal the offline collapse;
    (3) the causal transducer (RNN-T alone) in fp32 through
    StreamingServingModel, greedy and beam 8 wide: ids equal offline
    greedy_decode and beam_decode_nbest at the same token buffer, and the
    beam's whole carried state as _check_beam_carry holds it; (4) 8
    sessions of the causal gate config in its own precision (bf16 head)
    pooled in one StreamingSessionPool of 8 rows (feed_many rounds, then
    ragged feeds) against each alone (StreamingServingModel): ids equal;
    (5) the windowed StreamingEncoder over the gate config in fp32: frame
    counts equal offline's, a covering window at WINDOW_BOUND. Each path's
    ssd_fwd and ema_fwd launches, counted from 0 around it."""
    from hnet_mamba_asr_torch.decoders.device_rnnt_beam import beam_decode_nbest
    from hnet_mamba_asr_torch.models.ctc_head import greedy_decode as collapse_ctc
    from hnet_mamba_asr_torch.models.streaming import (
        CausalStreamingEncoder, StreamingCTCGreedy, StreamingEncoder)
    from hnet_mamba_asr_torch.ops.ema import ema_stream
    from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda, ema_stream_cuda
    from hnet_mamba_asr_torch.ops.ssd import ssd_chunked
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.serving.runtime import (
        StreamingServingModel, StreamingSessionPool)
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tools.gate import (
        GATE_CAUSAL_CONFIG, N2_CAUSAL_CONFIG, RNNT_CAUSAL_CONFIG)
    from hnet_mamba_asr_torch.tools.measure import (
        EMA_STREAM_SHAPES, cuda_ms, ema_stream_cost, ema_stream_inputs, kernel_ms, ssd_inputs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"ema": [], "launches": {}}

    def counted(path, fn, *args):
        """Run a main path with the kernels' counts from 0; keep its launches."""
        ssd_cuda.launches = ema_cuda.launches = 0
        res = fn(*args)
        torch.cuda.synchronize()
        out["launches"][path] = {"ssd_fwd": ssd_cuda.launches, "ema_fwd": ema_cuda.launches}
        if ssd_cuda.launches == 0:
            raise AssertionError(f"{path}: ssd_fwd was not launched")
        return res

    # (1) the kernels at the stream's shapes
    for Bsz, M, D in EMA_STREAM_SHAPES:
        z, p, n_real, carry = ema_stream_inputs(Bsz, M, D, seed=SEED + 40)
        got, st = ema_stream_cuda(z, p, n_real, carry)
        got2, st2 = ema_stream_cuda(z, p, n_real, carry)
        want, wst = ema_stream(z, p, n_real, carry)
        torch.cuda.synchronize()
        d = max((got - want).abs().max().item(), (st["ema"] - wst["ema"]).abs().max().item())
        rel = d / max(want.abs().max().item(), wst["ema"].abs().max().item())
        same = torch.equal(got, got2) and torch.equal(st["ema"], st2["ema"])
        fn = lambda: ema_stream_cuda(z, p, n_real, carry)  # noqa: E731
        ms, clock = kernel_ms(fn, "ema_fwd"), "the profiler's device time"
        if ms is None:
            ms, clock = cuda_ms(fn), "CUDA events around the call (no device time traced)"
        plain_ms = cuda_ms(lambda: ema_stream(z, p, n_real, carry))
        cost = ema_stream_cost(n_real, M, D, "float32")
        log(f"  ema_fwd carried fp32 B{Bsz} M{M} D{D} (real counts {n_real.min().item()}.."
            f"{n_real.max().item()}, {int(n_real.sum())} of {Bsz * M} rows): max|d|/max|ref| "
            f"{rel:.2e} (bound {EMA_SEQ_BOUND['float32']:g}), max|d| {d:.2e}, has equal "
            f"{torch.equal(st['has'], wst['has'])}, two calls bitwise equal {same}; kernel "
            f"{ms:.4f} ms ({clock}) plain {plain_ms:.4f} ms bound "
            f"{cost['bound_ms'] * 1e3:.2f} us ({cost['bound_by']}) share "
            f"{cost['bound_ms'] / ms:.2%}")
        if not (rel <= EMA_SEQ_BOUND["float32"] and same and torch.isfinite(got).all()
                and torch.equal(st["has"], wst["has"])):
            raise AssertionError(f"carried ema_fwd disagrees with ema_stream (B {Bsz} M {M})")
        out["ema"].append(dict(B=Bsz, M=M, D=D, abs_err=d, ms=ms, clock=clock,
                               plain_ms=plain_ms, **cost))
    x, dt, A, Bm, C = ssd_inputs(8, STREAM_BLOCK, 12, torch.float32, seed=SEED + 41)
    s0 = torch.randn(8, 12, 128, 64, device="cuda")
    y, s1 = ssd_cuda(x, dt, A, Bm, C, initial_state=s0, return_final=True)
    yr, sr = ssd_chunked(x, dt, A, Bm, C, chunk_size=STREAM_BLOCK, initial_state=s0,
                         return_final=True)
    _, s_idle = ssd_cuda(x, torch.zeros_like(dt), A, Bm, C, initial_state=s0,
                         return_final=True)
    tail = dt.clone()
    tail[:, 9:] = 0.0
    _, s_tail = ssd_cuda(x, tail, A, Bm, C, initial_state=s0, return_final=True)
    _, s_head = ssd_cuda(*(t[:, :9].contiguous() for t in (x, dt)), A,
                         *(t[:, :9].contiguous() for t in (Bm, C)), initial_state=s0,
                         return_final=True)
    rel_y = ((y - yr).abs().max() / yr.abs().max()).item()
    rel_s = ((s1 - sr).abs().max() / sr.abs().max()).item()
    log(f"  ssd fp32 L{STREAM_BLOCK} (< the kernel's chunk 64) from a carried state: y "
        f"{rel_y:.2e}, state {rel_s:.2e} off ssd_chunked; zero-dt block leaves the state "
        f"bitwise {torch.equal(s_idle, s0)}; zero dt on rows 9-15 == rows 0-8 alone: bitwise "
        f"{torch.equal(s_tail, s_head)}, max|d| {(s_tail - s_head).abs().max().item():.2e}")
    if not (rel_y <= SSD_BOUND["float32"] and rel_s <= STATE_BOUND["float32"]
            and torch.equal(s_idle, s0)
            and (s_tail - s_head).abs().max().item() <= STATE_BOUND["float32"] * sr.abs().max()):
        raise AssertionError("the fp32 ssd kernel at the stream's block breaks the carry")

    # (2) exact-causal streaming against offline, N = 1 and N = 2
    rng = np.random.default_rng(SEED + 42)
    for label, config in (("n1", GATE_CAUSAL_CONFIG), ("n2", N2_CAUSAL_CONFIG)):
        cfg = copy.deepcopy(config)
        cfg["train"]["precision"] = "fp32"
        cfg["encoder_conf"]["ssd_intra_dtype"] = None
        model = build_model(cfg, VOCAB, cmvn=cmvn, seed=SEED)
        if label == "n2":
            draw_routers(model, SEED + 43)
        wave = synth_audio(rng, STREAM_SECONDS[1])
        batch = {"wave": torch.from_numpy(wave[None]).cuda(),
                 "wave_lens": torch.tensor([len(wave)], device="cuda")}
        with torch.inference_mode():
            enc = model.encode(batch)
            ids = model.ctc.frame_argmax(enc.features)
        n = int(enc.lengths[0])
        want_ids = collapse_ctc(ids.cpu(), enc.lengths.cpu(), model.ctc.blank_id)[0]
        seen = []
        if label == "n2":           # the streamed boundaries, block by block
            router = model.encoder.chunk.router
            step = router.step

            def spy(x, n_real, state):
                p, b, st = step(x, n_real, state)
                seen.append((p[0, :int(n_real[0])], b[0, :int(n_real[0])]))
                return p, b, st
            router.step = spy
        stream = CausalStreamingEncoder(model, block_enc=STREAM_BLOCK)
        sc = StreamingCTCGreedy(model, stream)
        feats = []

        def run():
            toks = []
            for f in _stream_feed(stream.accept, wave, rng) + _tail(stream):
                feats.append(f)
                toks += sc.ids(f)
            return toks
        toks = counted(f"stream_{label}", run)
        got = torch.cat(feats)[:n]
        if label == "n2":
            router.step = step
            p = torch.cat([s[0] for s in seen])[None, :n]
            b = torch.cat([s[1] for s in seen])[None, :n]
            check_boundaries(((p, b),), (enc.boundaries[0],),
                             f"{label} streamed vs offline")
        ratio = _close(got, enc.features[0, :n], STREAM_BOUND)
        d = (got - enc.features[0, :n]).abs().max().item()
        kept = f", kept {enc.kept_fractions[0].item():.4f}" if label == "n2" else ""
        log(f"  stream {label} ({STREAM_SECONDS[1]:.1f} s, {n} frames, {len(feats)} blocks of "
            f"{STREAM_BLOCK}{kept}): max|d feature| {d:.3e} ({ratio:.3f} of the bound "
            f"{STREAM_BOUND:g} (1 + |f|)); ids equal offline {toks == want_ids} "
            f"({len(toks)} tokens); launches {out['launches'][f'stream_{label}']}")
        if label == "n2" and not 0.05 < enc.kept_fractions[0].item() < 0.95:
            raise AssertionError(f"n2 routers keep {enc.kept_fractions[0].item():.4f}")
        if label == "n2" and out["launches"]["stream_n2"]["ema_fwd"] == 0:
            raise AssertionError("stream_n2: ema_fwd was not launched")
        if not (ratio <= 1.0 and toks == want_ids and len(feats) > 1):
            raise AssertionError(f"stream {label} disagrees with offline: {ratio:.3f}, ids "
                                 f"{toks == want_ids}")
        out[label] = {"max_abs": d, "frames": n}
        del model, stream, sc
        torch.cuda.empty_cache()

    # (3) the streaming transducer, greedy and beam, against offline
    cfg = copy.deepcopy(RNNT_CAUSAL_CONFIG)
    cfg["train"]["precision"] = "fp32"
    cfg["encoder_conf"]["ssd_intra_dtype"] = None
    wave = synth_audio(rng, STREAM_SECONDS[0])
    for decode in ("greedy", "beam"):
        sm = StreamingServingModel(cfg, None, vocab_size=VOCAB, cmvn=cmvn, seed=SEED,
                                   block_enc=STREAM_BLOCK, decode=decode)
        model = sm.pool.model
        K, L = sm.pool.beam_size, sm.pool.token_buf_len
        batch = {"wave": torch.from_numpy(wave[None]).cuda(),
                 "wave_lens": torch.tensor([len(wave)], device="cuda")}
        with torch.inference_mode():
            enc = model.encode(batch)
            if decode == "greedy":
                toks, lens = model.rnnt.greedy_decode(enc.features, enc.lengths)
                want = toks[0, :int(lens[0])].tolist()
            else:
                ftoks, fplen, fscore = beam_decode_nbest(model.rnnt, enc.features, enc.lengths,
                                                         K, token_buf_len=L)
                k = int(torch.argmax(fscore[0]))
                want = ftoks[0, k, :int(fplen[0, k])].tolist()
        fed = counted(f"stream_rnnt_{decode}", lambda: _stream_feed(sm.feed, wave, rng))
        got = sm.finish()
        if decode == "greedy":
            got = fed + got
        log(f"  stream rnnt {decode} ({STREAM_SECONDS[0]:.1f} s, {int(enc.lengths[0])} frames): "
            f"ids equal offline {got == want} ({len(got)} tokens; feeds returned {len(fed)}); "
            f"launches {out['launches'][f'stream_rnnt_{decode}']}")
        if got != want or (decode == "beam" and fed):
            raise AssertionError(f"streamed transducer {decode} ids differ from offline")
        if decode == "beam":
            _check_beam_carry(model, sm.pool, wave, rng, K, L)
        del sm, model
        torch.cuda.empty_cache()

    # (4) pooled sessions against each alone, in the config's own precision
    kw = dict(vocab_size=VOCAB, cmvn=cmvn, seed=SEED, block_enc=STREAM_BLOCK)
    pool = StreamingSessionPool(GATE_CAUSAL_CONFIG, None, batch=STREAM_SESSIONS, **kw)
    waves = [synth_audio(rng, float(t)) for t in rng.uniform(2.0, 6.0, size=STREAM_SESSIONS)]
    ticks0 = pool.n_ticks
    t0 = time.perf_counter()
    pooled_ids = counted("stream_pool", drive_pool, pool, waves, rng)
    pool_s = time.perf_counter() - t0
    ticks = pool.n_ticks - ticks0
    del pool
    torch.cuda.empty_cache()
    alone = StreamingServingModel(GATE_CAUSAL_CONFIG, None, **kw)
    alone_ids = [_stream_feed(alone.feed, w, rng) + alone.finish() for w in waves]
    differ = [k for k, (a, b) in enumerate(zip(pooled_ids, alone_ids)) if a != b]
    log(f"  stream pool: {STREAM_SESSIONS} sessions of "
        f"{sorted(round(len(w) / SR, 2) for w in waves)} s (bf16 head) in a pool of "
        f"{STREAM_SESSIONS} rows, {ticks} ticks in {pool_s:.2f} s; pooled == alone "
        f"{not differ} (tokens {[len(i) for i in pooled_ids]}); launches "
        f"{out['launches']['stream_pool']}")
    if differ:
        raise AssertionError(f"pooled streaming sessions differ from alone: {differ}")
    del alone
    torch.cuda.empty_cache()

    # (5) the windowed encoder over the bidirectional gate config
    cfg = copy.deepcopy(GATE_CONFIG)
    cfg["train"]["precision"] = "fp32"
    cfg["encoder_conf"]["ssd_intra_dtype"] = None
    model = build_model(cfg, VOCAB, cmvn=cmvn, seed=SEED)
    wave = synth_audio(rng, STREAM_SECONDS[1])
    with torch.inference_mode():
        enc = model.encode({"wave": torch.from_numpy(wave[None]).cuda(),
                            "wave_lens": torch.tensor([len(wave)], device="cuda")})
    off = enc.features[0, :int(enc.lengths[0])]
    se = StreamingEncoder(model, seg_frames=96, left_ctx=256, lookahead=32)
    frames = len(torch.cat(_stream_feed(se.accept, wave, rng) + _tail(se)))
    # a lookahead past the utterance's end: one window, at finish(), sees it all
    se = StreamingEncoder(model, seg_frames=96, left_ctx=1024, lookahead=640)
    cover = counted("stream_windowed",
                    lambda: torch.cat(_stream_feed(se.accept, wave, rng) + _tail(se)))
    ratio = _close(cover, off, WINDOW_BOUND) if cover.shape == off.shape else float("inf")
    log(f"  stream windowed gate config fp32 ({STREAM_SECONDS[1]:.1f} s, {len(off)} frames): "
        f"frames {frames} at left_ctx 256 / lookahead 32, {len(cover)} covering; covering "
        f"max|d| {(cover - off).abs().max().item():.3e} ({ratio:.3f} of the bound "
        f"{WINDOW_BOUND:g} (1 + |f|)); launches {out['launches']['stream_windowed']}")
    if not (frames == len(off) and ratio <= 1.0):
        raise AssertionError("the windowed stream disagrees with offline")
    del model
    torch.cuda.empty_cache()
    log("phase 18 stream: ok")
    return out


ARTIFACT_EMIT = ("frame_ids", "log_probs", "beam_ids", "aed_ids")
ARTIFACT_BUDGET_S = 60.0        # the artifacts phase's own time budget
# the narrow model the CLIs run on the card: the tone runs' widths (the
# (16, 16) fp32 SSD build), hybrid heads, a 1-layer LM, the 7 decode cells
CLI_CONFIG = """
experiment: {{name: cli_card, seed: 0}}
data:
  manifests_dir: {root}/manifests
  eval_splits: [test-clean]
  wire_dtype: int16
bpemodel: {root}/tok/bpe.model
frontend_conf: {{sample_rate: 16000, n_mels: 20, win_length: 400, hop_length: 160,
                 cmvn: {root}/cmvn.npz}}
encoder: dcasr
encoder_conf: {{arch_type: A, d_outer: 32, d_main: 32, n_enc: 1, n_main: 1, n_dec: 1,
                d_state: 16, headdim: 16, ssd_chunk_size: 32, hnet: {{compression_N: 1}}}}
aed_conf: {{n_layers: 1, n_heads: 2, d_ff: 256, dropout: 0.0, max_decode_len: 8}}
model_conf: {{ctc_weight: 0.5, aed_weight: 0.5}}
lm_conf: {{d_model: 32, n_layers: 1, n_heads: 2, d_ff: 64, dropout: 0.0}}
batch_bins: 8000
train: {{precision: fp32}}
decode:
  read_outs: [ctc, aed, joint]
  search: [greedy, beam]
  beam_size: 2
  pre_beam: 4
  ctc_weight: 0.3
  share_encoder: true
  lm: enabled
  lm_config: {root}/cfg.yaml
  lm_checkpoint: {root}/lm.ckpt
  lm_weight: 0.2
  rescore_weight: 0.3
  batch_bins: 8000
score: {{gate_cell: ctc_greedy}}
goal: {{sane_test_clean_wer_below: 12.0}}
"""


def serve_http(argv, wave) -> dict:
    """``serving/server.py::main(argv)`` in a thread: one raw-PCM request to
    /v1/transcribe, then the server is shut down. -> the JSON answer."""
    from hnet_mamba_asr_torch.serving import server
    ready, box = threading.Event(), {}

    def on_ready(httpd, ctl):
        box["httpd"] = httpd
        ready.set()

    thread = threading.Thread(target=server.main, kwargs=dict(argv=argv, on_ready=on_ready),
                              daemon=True)
    thread.start()
    if not ready.wait(300):
        raise AssertionError(f"the server did not start: {argv}")
    try:
        url = f"http://127.0.0.1:{box['httpd'].server_address[1]}/v1/transcribe"
        req = urllib.request.Request(url, data=np.asarray(wave, np.float32).tobytes(),
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())
    finally:
        box["httpd"].shutdown()
        thread.join(timeout=60)
        if thread.is_alive():
            raise AssertionError("the server thread did not stop")


def artifact_cli_workspace(root: Path) -> Path:
    """The tone corpus with test-clean's odd utterances as FLAC, its
    tokenizer and CMVN, the narrow YAML config, and seeded checkpoints of
    the model and the LM written by ``training/checkpoint.py``. -> the
    config's path."""
    from hnet_mamba_asr_torch.convert import state_dict_to_jax_tree
    from hnet_mamba_asr_torch.data.audio import load_manifest, read_audio, write_manifest
    from hnet_mamba_asr_torch.data.flac import write_flac
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tasks.lm_task import build_lm
    from hnet_mamba_asr_torch.training.checkpoint import save_checkpoint
    from hnet_mamba_asr_torch.utils.config import load_config
    tok, cmvn = tone_setup(root)
    test = root / "manifests" / "test-clean.jsonl"
    entries = load_manifest(test)
    for i, e in enumerate(entries):
        if i % 2:
            wave, sr = read_audio(e["audio"])
            e["audio"] = str(Path(e["audio"]).with_suffix(".flac"))
            write_flac(e["audio"], wave, sr)
    write_manifest(entries, test)
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(CLI_CONFIG.format(root=root))
    cfg = load_config(cfg_path)
    model = build_model(cfg, tok.vocab_size, cmvn=cmvn, seed=SEED)
    save_checkpoint(root / "asr.ckpt", {"params": state_dict_to_jax_tree(model.state_dict()),
                                        "epoch": 1})
    lm = build_lm(cfg, tok.vocab_size)
    save_checkpoint(root / "lm.ckpt", {"params": state_dict_to_jax_tree(lm.state_dict())})
    return cfg_path


FULL_CLI_UTTS = 4               # test-clean utterances of the full-width CLI pass


def full_width_clis(root: Path, cmvn, counted) -> dict:
    """``configs/typeA_small_N1.yaml`` itself (full width, bf16, 80 mels)
    through export_serving, serve (the exported artifact, one HTTP request),
    transcribe --cell ctc_greedy (the 1 s length grid) and a greedy-only
    decode with provenance: overrides point its tokenizer
    (``seeded_tokenizer``'s 500 pieces), CMVN (``cmvn``, saved) and
    manifests at ``root``; the weights are a seeded full-width checkpoint
    written by ``training/checkpoint.py``; test-clean holds FULL_CLI_UTTS
    synthetic utterances of 2-12 s, the odd ones FLAC. The tools run on
    their default device, the card. ``counted(path, fn, *args)`` runs each
    tool and counts its launches. -> the tools' results."""
    from hnet_mamba_asr_torch.convert import state_dict_to_jax_tree
    from hnet_mamba_asr_torch.data.audio import write_manifest, write_wav
    from hnet_mamba_asr_torch.data.flac import write_flac
    from hnet_mamba_asr_torch.scripts import decode, export_serving, transcribe
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tools.gate import seeded_tokenizer
    from hnet_mamba_asr_torch.training.checkpoint import save_checkpoint
    from hnet_mamba_asr_torch.utils.config import load_config
    (root / "manifests").mkdir(parents=True)
    tok = seeded_tokenizer(root / "bpe_500.model")
    cmvn.save(root / "cmvn.npz")
    rng = np.random.default_rng(SEED + 60)
    entries = []
    for i, sec in enumerate(rng.uniform(2.0, 12.0, size=FULL_CLI_UTTS)):
        wave = synth_audio(rng, float(sec))
        path = root / (f"f{i}.flac" if i % 2 else f"f{i}.wav")
        (write_flac if i % 2 else write_wav)(path, wave, SR)
        entries.append({"id": f"f{i}", "audio": str(path), "frames": len(wave),
                        "text": " ".join(f"t{j}" for j in rng.integers(4, VOCAB, size=8))})
    write_manifest(entries, root / "manifests" / "test-clean.jsonl")
    yaml_path = Path(__file__).resolve().parent / "configs" / "typeA_small_N1.yaml"
    overrides = [f"bpemodel={root / 'bpe_500.model'}", f"frontend_conf.cmvn={root / 'cmvn.npz'}",
                 f"data.manifests_dir={root / 'manifests'}"]
    cfg = load_config(yaml_path, overrides)
    model = build_model(cfg, tok.vocab_size, cmvn=cmvn, seed=SEED)
    save_checkpoint(root / "asr.ckpt", {"params": state_dict_to_jax_tree(model.state_dict()),
                                        "epoch": 1})
    n_params = sum(p.numel() for p in model.parameters())
    del model
    base = ["--config", str(yaml_path), "--checkpoint", str(root / "asr.ckpt")]
    paths = [e["audio"] for e in entries]
    res = {"n_params": n_params, "precision": cfg["train"]["precision"],
           "d_outer": cfg["encoder_conf"]["d_outer"]}

    def export_and_serve():
        export_serving.run(export_serving.parse_args(
            base + ["--buckets", "8x192000", "--out", str(root / "art")] + overrides))
        return serve_http([str(root / "art"), "--port", "0", "--max-wait-ms", "1"],
                          synth_audio(np.random.default_rng(SEED + 61), 5.0))
    res["http"] = counted("artifacts_cli_full_serve", export_and_serve)
    res["transcribe"] = counted("artifacts_cli_full_transcribe", transcribe.main,
                                base + ["--cell", "ctc_greedy"] + paths + overrides)
    res["decode"] = counted("artifacts_cli_full_decode", decode.run, decode.parse_args(
        base + ["--splits", "test-clean", "--out-dir", str(root / "decode")] + overrides
        + ["decode.read_outs=[ctc]", "decode.search=[greedy]", "decode.lm=none"]))
    res["manifest"] = json.loads((root / "art" / "manifest.json").read_text())
    res["config"] = cfg
    res["paths"] = paths
    with open(root / "decode" / "ctc_greedy" / "test-clean.jsonl") as f:
        res["decoded"] = {r["id"]: r["hyp"] for r in map(json.loads, f)}
    res["ids"] = [e["id"] for e in entries]
    return res


def phase_artifacts(cmvn) -> dict:
    """Serving artifacts and the command-line tools on the card.

    Full width, through the API: the gate config (seeded, AED cap
    DECODE_CAP) exported with frame_ids, log_probs, beam_ids and aed_ids in
    fp32 and int8; ``load_serving_artifact`` on the card serves phase 4's 8
    requests: the fp32 artifact's outputs bitwise equal to the direct
    ``ServingModel``'s, the int8 artifact's to a direct model holding
    ``dequantize_tree`` of the same int8 tree; sizes, load time, the served
    call's time from the artifact and directly, the int8-vs-fp32 log-prob gap
    and id agreement (reported, not gated); ``serving/server.py::main`` from
    the artifact answers one HTTP request with the direct call's ids; an N = 2
    causal streaming artifact at batch 8 gives the ids of the pool it was
    exported from on the same audio. Narrow width, through the CLIs:
    ``configs/typeA_small_N1.yaml`` by the port's YAML reader == GATE_CONFIG
    on the model's keys; export_serving (fp32, int8), serve, transcribe
    (ctc_greedy, joint_beam), decode (shared encoder, the LM cells) and
    score_wer, each once on the card; full width, through the CLIs:
    ``full_width_clis`` on the YAML file itself. Each path's ssd_fwd /
    ema_fwd launches."""
    import os
    from hnet_mamba_asr_torch.convert import load_jax_params, state_dict_to_jax_tree
    from hnet_mamba_asr_torch.data.audio import load_manifest, read_audio
    from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.scripts import decode, export_serving, score_wer, transcribe
    from hnet_mamba_asr_torch.serving.export import (save_serving_artifact,
                                                     save_streaming_artifact)
    from hnet_mamba_asr_torch.serving.quant import dequantize_tree, quantize_tree
    from hnet_mamba_asr_torch.serving.runtime import (
        ServingModel, StreamingSessionPool, ids_per_row, load_serving_artifact,
        load_streaming_pool)
    from hnet_mamba_asr_torch.tools.gate import N2_CAUSAL_CONFIG
    from hnet_mamba_asr_torch.utils.config import load_config
    t_phase = time.perf_counter()
    out = {"launches": {}}

    def counted(path, fn, *args, ema=False):
        ssd_cuda.launches = ema_cuda.launches = 0
        res = fn(*args)
        torch.cuda.synchronize()
        out["launches"][path] = {"ssd_fwd": ssd_cuda.launches, "ema_fwd": ema_cuda.launches}
        if ssd_cuda.launches == 0 or (ema and ema_cuda.launches == 0):
            raise AssertionError(f"{path}: a kernel of the path was not launched: "
                                 f"{out['launches'][path]}")
        return res

    def same(a: dict, b: dict) -> bool:
        return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)

    def timed(fn):
        """-> (fn's result, its ms on the host clock, synchronized)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    with tempfile.TemporaryDirectory(prefix="chip_smoke_artifacts_") as tmp:
        tmp = Path(tmp)
        # phase 4's 8 requests (the same draws), at full width
        cfg = copy.deepcopy(GATE_CONFIG)
        cfg["aed_conf"]["max_decode_len"] = DECODE_CAP
        rng = np.random.default_rng(SEED + 2)
        waves = [synth_audio(rng, float(s)) for s in rng.uniform(2.0, 16.0, size=8)]
        lens = np.array([len(w) for w in waves])
        padded = np.zeros((8, lens.max()), np.float32)
        for i, w in enumerate(waves):
            padded[i, :len(w)] = w
        direct = ServingModel(cfg, None, "cuda", vocab_size=VOCAB, cmvn=cmvn, seed=SEED,
                              emit=ARTIFACT_EMIT)
        direct(padded[:1, :lens[0]], lens[:1])               # cuBLAS / cuDNN set-up
        want, direct_ms = timed(lambda: direct(padded, lens))
        alone0 = direct.transcribe_ids(waves[0][None], lens[:1])[0]
        sizes, export_s = {}, {}
        for q in (None, "int8"):
            t0 = time.perf_counter()
            save_serving_artifact(tmp / f"art_{q}", direct.model, buckets=[(8, 40 * SR)],
                                  emit=ARTIFACT_EMIT, quantize=q, config=cfg)
            export_s[q] = time.perf_counter() - t0
            sizes[q] = os.path.getsize(tmp / f"art_{q}" / "params.npz")
        t0 = time.perf_counter()
        art = load_serving_artifact(tmp / "art_None")
        load_s = time.perf_counter() - t0
        got, art_ms = timed(lambda: counted("artifacts_serve", art, padded, lens))
        fp32_same = same(got, want)
        del art
        torch.cuda.empty_cache()
        # int8: a direct model holding the dequantized int8 tree
        deq = dequantize_tree(quantize_tree(state_dict_to_jax_tree(direct.model.state_dict())))
        load_jax_params(direct.model, deq)
        want8 = direct(padded, lens)
        t0 = time.perf_counter()
        art8 = load_serving_artifact(tmp / "art_int8")
        load8_s = time.perf_counter() - t0
        got8, art8_ms = timed(lambda: counted("artifacts_serve_int8", art8, padded, lens))
        int8_same = same(got8, want8)
        gap = max(float(np.abs(got8["log_probs"][b, :n] - want["log_probs"][b, :n]).max())
                  for b, n in enumerate(want["enc_lengths"]))
        frames = int(want["enc_lengths"].sum())
        agree = sum(int((got8["frame_ids"][b, :n] == want["frame_ids"][b, :n]).sum())
                    for b, n in enumerate(want["enc_lengths"]))
        beam8 = ids_per_row({k: got8[k] for k in ("beam_ids", "beam_lens", "enc_lengths")},
                            None, None)
        beam = ids_per_row({k: want[k] for k in ("beam_ids", "beam_lens", "enc_lengths")},
                           None, None)
        aed_agree = sum(np.array_equal(a, b) for a, b in zip(got8["aed_ids"], want["aed_ids"]))
        del art8, direct
        torch.cuda.empty_cache()
        log(f"  artifacts, gate config at full width ({len(waves)} requests of "
            f"{sorted(round(len(w) / SR, 2) for w in waves)} s, emit {', '.join(ARTIFACT_EMIT)}, "
            f"AED cap {DECODE_CAP}): params.npz fp32 {sizes[None]:,} B, int8 {sizes['int8']:,} B "
            f"({sizes[None] / sizes['int8']:.2f}x); export {export_s[None]:.2f} / "
            f"{export_s['int8']:.2f} s; load {load_s:.2f} s (fp32), {load8_s:.2f} s (int8, "
            f"dequantized once); served call (host clock, synchronized; direct, then the "
            f"artifact) {art_ms:.1f} ms from the fp32 artifact, {direct_ms:.1f} ms direct; "
            f"the int8 artifact's first "
            f"call {art8_ms:.1f} ms; fp32 artifact == direct bitwise {fp32_same}, int8 "
            f"artifact == direct(dequantize_tree(q8)) bitwise {int8_same}; int8 vs fp32: "
            f"log-prob max|d| {gap:.4e}, frame ids equal {agree}/{frames} "
            f"({agree / frames:.4%}), beam ids equal {sum(a == b for a, b in zip(beam8, beam))}"
            f"/8, aed ids equal {aed_agree}/8; launches {out['launches']}")
        if not (fp32_same and int8_same):
            raise AssertionError("artifact outputs differ from the direct model's")

        # the HTTP server from the artifact: one request, the direct call's ids
        http = counted("artifacts_http", serve_http,
                       [str(tmp / "art_None"), "--port", "0", "--max-wait-ms", "1"], waves[0])
        log(f"  server main from the artifact: {len(http['ids'])} ids, == the direct call's "
            f"{http['ids'] == alone0}; launches {out['launches']['artifacts_http']}")
        if http["ids"] != alone0:
            raise AssertionError("the served HTTP answer differs from the direct call")
        torch.cuda.empty_cache()

        # an N = 2 causal streaming artifact at batch 8 against its own pool
        kw = dict(vocab_size=VOCAB, cmvn=cmvn, seed=SEED, block_enc=STREAM_BLOCK)
        pool = StreamingSessionPool(N2_CAUSAL_CONFIG, None, batch=STREAM_SESSIONS, **kw)
        draw_routers(pool.model, SEED + 44)
        srng = np.random.default_rng(SEED + 45)
        swaves = [synth_audio(srng, float(t)) for t in srng.uniform(2.0, 6.0,
                                                                   size=STREAM_SESSIONS)]
        want_ids = drive_pool(pool, swaves, np.random.default_rng(SEED + 46))
        save_streaming_artifact(tmp / "stream", pool.model, batch=STREAM_SESSIONS,
                                block_enc=STREAM_BLOCK, config=N2_CAUSAL_CONFIG)
        del pool
        torch.cuda.empty_cache()
        apool = load_streaming_pool(tmp / "stream")
        got_ids = counted("artifacts_stream_n2", drive_pool, apool, swaves,
                          np.random.default_rng(SEED + 46), ema=True)
        log(f"  N=2 causal streaming artifact, {STREAM_SESSIONS} sessions of "
            f"{sorted(round(len(w) / SR, 2) for w in swaves)} s in a pool of "
            f"{apool.B}: ids == its source pool's {got_ids == want_ids} (tokens "
            f"{[len(i) for i in got_ids]}); launches {out['launches']['artifacts_stream_n2']}")
        if got_ids != want_ids:
            raise AssertionError("the streaming artifact's ids differ from its pool's")
        del apool
        torch.cuda.empty_cache()
        full_s = time.perf_counter() - t_phase

        # narrow width, through the CLIs, on the card (their default device)
        yaml_cfg = load_config(Path(__file__).resolve().parent / "configs" /
                               "typeA_small_N1.yaml")
        differ = [k for k in GATE_CONFIG if (yaml_cfg[k] if k != "train" else
                                            {"precision": yaml_cfg[k]["precision"]})
                  != GATE_CONFIG[k]]
        if differ:
            raise AssertionError(f"the YAML reader's typeA_small_N1.yaml differs from "
                                 f"GATE_CONFIG at {differ}")
        root = tmp / "cli"
        cfg_path = artifact_cli_workspace(root)
        base = ["--config", str(cfg_path), "--checkpoint", str(root / "asr.ckpt")]
        wavs = [e["audio"] for e in load_manifest(root / "manifests" / "test-clean.jsonl")][:4]

        def clis() -> dict:
            res = {}
            for q in (None, "int8"):
                export_serving.run(export_serving.parse_args(
                    base + ["--out", str(root / f"art_{q}"), "--buckets", "8x160000",
                            "--emit", "frame_ids", "beam_ids", "aed_ids",
                            *(["--quantize", q] if q else [])]))
            w0, _ = read_audio(wavs[0])
            res["http"] = serve_http([str(root / "art_int8"), "--port", "0",
                                      "--max-wait-ms", "1"], w0.astype(np.float32))
            res["transcribe"] = {cell: transcribe.main(base + ["--cell", cell] + wavs)
                                 for cell in ("ctc_greedy", "joint_beam")}
            res["decode"] = decode.run(decode.parse_args(
                base + ["--out-dir", str(root / "decode")]))
            try:
                score_wer.run(score_wer.parse_args(
                    ["--decode-dir", str(root / "decode"), "--config", str(cfg_path),
                     "--n-bootstrap", "50"]))
                res["score_exit"] = 0
            except SystemExit as e:
                res["score_exit"] = e.code
            return res
        t0 = time.perf_counter()
        res = counted("artifacts_cli", clis)
        cli_s = time.perf_counter() - t0
        cells = sorted(p.name for p in (root / "decode").iterdir()
                       if p.is_dir() and p.name not in ("logs", "score"))
        scores = json.loads((root / "decode" / "score" / "scores.json").read_text())
        card = res["decode"]["provenance"]["env"].get("card")
        log(f"  CLIs on the card (narrow: d 32, 1 + 1 + 1 blocks, fp32; {len(wavs)} files, "
            f"test-clean {len(cells)} cells with FLAC and WAV): export fp32 + int8, serve "
            f"({len(res['http']['ids'])} ids over HTTP), transcribe "
            + ", ".join(f"{c} {[r['hyp'] for r in rs]}" for c, rs in res["transcribe"].items())
            + f", decode {cells} (shared encoder; provenance card {card!r}), score_wer exit "
            f"{res['score_exit']} (gate {'passed' if scores['gate'].get('passed') else 'failed'}"
            f", seeded weights) in {cli_s:.1f} s; launches {out['launches']['artifacts_cli']}")
        want_cells = ["aed_beam", "aed_beam_lm", "ctc_beam", "ctc_beam_lm", "ctc_greedy",
                      "joint_beam", "joint_beam_lm"]
        if not (cells == want_cells and (root / "decode" / "summary.json").exists()
                and res["score_exit"] in (0, 2) and card
                and all([r["id"] for r in rs] == wavs for rs in res["transcribe"].values())):
            raise AssertionError("a command-line tool did not complete on the card")

        # configs/typeA_small_N1.yaml itself at full width through the CLIs
        t0 = time.perf_counter()
        full = full_width_clis(tmp / "cli_full", cmvn, counted)
        full_cli_s = time.perf_counter() - t0
        same_hyps = sum(r["hyp"] == full["decoded"][i]
                        for r, i in zip(full["transcribe"], full["ids"]))
        log(f"  CLIs on the card at full width (configs/typeA_small_N1.yaml, "
            f"{full['precision']}, d_outer {full['d_outer']}, {full['n_params']:,} parameters, "
            f"vocabulary {VOCAB}; {FULL_CLI_UTTS} files, WAV and FLAC): export_serving + serve "
            f"({len(full['http']['ids'])} ids over HTTP), transcribe ctc_greedy, decode "
            f"ctc_greedy (transcribe == decode on {same_hyps}/{FULL_CLI_UTTS} utterances, "
            f"reported) in {full_cli_s:.1f} s; launches "
            + ", ".join(f"{k[len('artifacts_cli_full_'):]} {out['launches'][k]}"
                        for k in out["launches"] if k.startswith("artifacts_cli_full_")))
        cells = sorted(p.name for p in (tmp / "cli_full" / "decode").iterdir()
                       if p.is_dir() and p.name != "logs")
        if not (full["manifest"]["config"] == json.loads(json.dumps(full["config"]))
                and isinstance(full["http"].get("text"), str)
                and [r["id"] for r in full["transcribe"]] == full["paths"]
                and sorted(full["decoded"]) == sorted(full["ids"]) and cells == ["ctc_greedy"]
                and (tmp / "cli_full" / "decode" / "summary.json").exists()):
            raise AssertionError("a command-line tool did not complete at full width")
    phase_s = time.perf_counter() - t_phase
    log(f"  artifacts phase: {phase_s:.1f} s (full width {full_s:.1f} s, CLIs {cli_s:.1f} s "
        f"narrow, {full_cli_s:.1f} s full width; budget {ARTIFACT_BUDGET_S:.0f} s)")
    log("phase 19 artifacts: ok")
    out.update(sizes=sizes, load_s={"fp32": load_s, "int8": load8_s},
               call_ms={"fp32_artifact": art_ms, "fp32_direct": direct_ms,
                        "int8_artifact_first_call": art8_ms},
               gap=gap, frame_agree=agree / frames, seconds=phase_s)
    return out


# phase 20: the training entry points on a synthetic LibriSpeech tree
TRAIN_CLI_SPLITS = {"train-clean-100": 48, "dev-clean": 4}
TRAIN_CLI_BUDGET_S = 105.0      # the phase's own time budget (scan_steps' two runs: ~15 s)
LM_CORPUS_LINES = 3000
GATE_N_PARAMS = 78_858_409
LARGE_N_PARAMS = 210_967_945    # tests/test_torch_train_configs.py holds it to JAX's
LARGE_SSD_CALLS = 60            # 6 + 18 + 6 bidirectional blocks


def phase_train_clis() -> dict:
    """The data-preparation and training CLIs on the card (phase 20 of the
    module's docstring), in a temporary directory. -> the runs' numbers."""
    from hnet_mamba_asr_torch.data import flac, host_audio, lm_text
    from hnet_mamba_asr_torch.data.audio import apply_speed_perturb, load_manifest
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.scripts import (build_manifests, build_tokenizer, compute_cmvn,
                                              decode, train, train_lm)
    from hnet_mamba_asr_torch.tools.gate import lexicon, librispeech_tree
    from hnet_mamba_asr_torch.training.checkpoint import load_checkpoint
    configs = Path(__file__).resolve().parent / "configs"
    out, launches, secs = {}, {}, {}
    t_phase = time.perf_counter()

    def counted(path, fn, *args):
        ssd_cuda.launches = ssd_cuda.bwd_launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        secs[path] = time.perf_counter() - t0
        launches[path] = {"ssd_fwd": ssd_cuda.launches, "ssd_bwd": ssd_cuda.bwd_launches}
        out[f"{path}_peak"] = torch.cuda.max_memory_allocated()
        return res

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_cli_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        librispeech_tree(root / "LibriSpeech", TRAIN_CLI_SPLITS, seed=SEED + 70, workers=8)
        tree_s = time.perf_counter() - t0
        mdir = root / "manifests"
        build_manifests.run(["--root", str(root / "LibriSpeech"), "--out-dir", str(mdir),
                             "--splits", *TRAIN_CLI_SPLITS])
        tok = build_tokenizer.run(["--manifests", str(mdir / "train-clean-100.jsonl"),
                                   "--out", str(root / "bpe_500"), "--vocab-size", "500"])
        counted("train_cli_cmvn", compute_cmvn.run,
                ["--manifest", str(mdir / "train-clean-100.jsonl"), "--out",
                 str(root / "cmvn.npz")])
        secs["prep"] = time.perf_counter() - t0
        entries = load_manifest(mdir / "train-clean-100.jsonl")
        if tok.vocab_size != 500 or len(entries) != TRAIN_CLI_SPLITS["train-clean-100"]:
            raise AssertionError(f"data preparation: vocabulary {tok.vocab_size}, "
                                 f"{len(entries)} entries")

        # the host library on this machine: one FLAC equal to the numpy twin,
        # then the longest FLAC and its 0.9 resample timed
        flacs = sorted((e for e in entries if e["audio"].endswith(".flac")),
                       key=lambda e: e["frames"])
        short, longest = flacs[0], flacs[-1]
        data = Path(short["audio"]).read_bytes()
        if not np.array_equal(host_audio.flac_decode(data)[0], flac.decode_flac_bytes(data)[0]):
            raise AssertionError("the host library's FLAC decode differs from the numpy twin")
        t0 = time.perf_counter()
        wave, _ = flac.read_flac(longest["audio"])
        flac_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        apply_speed_perturb(wave, SR, 0.9)
        resample_ms = (time.perf_counter() - t0) * 1e3
        host = {"seconds": longest["frames"] / SR, "flac_ms": flac_ms,
                "resample_ms": resample_ms}

        yaml_gate = configs / "typeA_small_N1.yaml"
        paths = [f"bpemodel={root / 'bpe_500.model'}", f"frontend_conf.cmvn={root / 'cmvn.npz'}",
                 f"data.manifests_dir={mdir}", "data.train_manifest=train-clean-100",
                 "data.dev_splits=[dev-clean]", f"data.perturb_cache_dir={root / 'perturb'}"]
        exp = root / "exp_gate"

        def gate_args(*extra, exp_dir=exp):
            return train.parse_args(["--config", str(yaml_gate), "--exp-dir", str(exp_dir),
                                     *extra, *paths])
        first = counted("train_cli_gate", train.run, gate_args(
            "train.max_epoch=2", "eval.valid_interval_epoch=1", "keep_all_checkpoints=false",
            "keep_nbest_models=1"))
        ds = first.train_loader.dataset
        n_params = sum(p.numel() for p in first.model.parameters())
        k = first.global_step
        gate_hist = first.history
        gate_sched = first.lr_schedule
        precision = first.cfg["precision"]
        n_batches, n_dev = len(first.train_loader), len(first.dev_loaders["dev-clean"])
        cache = (ds.cache_misses, ds.cache_hits)
        ids = [ds[i]["id"] for i in range(3)] if len(ds) == 3 * len(entries) else []
        del first, ds
        torch.cuda.empty_cache()
        es = ("early_stopping={enable: true, require_all: true, criteria: [{phase: valid, "
              "metric: loss, mode: min, patience: 0, min_delta: 1.0e9}]}")
        resumed = counted("train_cli_gate_resume", train.run, gate_args(
            "--resume", "auto", "train.max_epoch=4", "eval.valid_interval_epoch=1",
            "keep_all_checkpoints=false", "keep_nbest_models=1", es))
        res_hist, res_epoch, res_step = resumed.history, resumed.epoch, resumed.global_step
        best = {m: resumed._best_epoch("valid", m, "min") for m in ("wer", "loss")}
        metric_history = resumed.metric_history
        del resumed
        torch.cuda.empty_cache()
        files = sorted(os.listdir(exp / "checkpoints"))
        want_files = sorted({f"epoch{e:04d}.ckpt" for e in (2, *best.values())}
                            | {"latest.ckpt", "valid.wer.best.ckpt", "valid.loss.best.ckpt",
                               "valid.wer.ave.ckpt", "valid.loss.ave.ckpt"})
        links = {m: os.readlink(exp / "checkpoints" / f"valid.{m}.best.ckpt") for m in best}
        lines = [json.loads(ln) for ln in open(exp / "metrics.jsonl")]
        summary = json.loads((exp / "summary.json").read_text())
        checks = {
            "parameters": n_params == GATE_N_PARAMS,
            "items 3x with #sp ids": ids == [f"{entries[0]['id']}#sp0.9", entries[0]["id"],
                                            f"{entries[0]['id']}#sp1.1"],
            "cache written in epoch 0, read in epoch 1": cache == (96, 96),
            "resumed at step k + 1 with lr(k)": (res_hist[0]["step"] == k + 1
                                                 and res_hist[0]["lr"] == gate_sched(k)),
            "early stop after epoch 2": res_epoch == 2 and summary["epochs"] == 3,
            "pruned to the best": files == want_files,
            "best symlinks": links == {m: f"epoch{e:04d}.ckpt" for m, e in best.items()},
            "metrics.jsonl": (sum(ln.get("event") == "resume" for ln in lines) == 1
                              and {"valid/loss", "valid/wer", "valid/cer",
                                   "dev_dev-clean/loss"} <= set().union(*lines)),
            "summary.json": (len(summary["provenance"]) == 2
                             and summary["final_step"] == res_step
                             and summary["provenance"][0]["env"]["card"] is not None
                             and summary["best_valid_loss_epoch"] == best["loss"]),
            "history": set(metric_history) == {("train", "loss"), ("valid", "loss"),
                                               ("valid", "wer"), ("valid", "cer")},
        }
        hist = gate_hist + res_hist
        for r in hist:
            if not (math.isfinite(r["loss/total"]) and math.isfinite(r["grad_norm"])):
                raise AssertionError(f"train CLI step {r['step']}: not finite: {r}")
        # every batch is a micro-step (an epoch's partial update group runs and
        # is dropped), each validation encodes every dev batch twice (loss and
        # greedy decode)
        for path, epochs in (("train_cli_gate", 2), ("train_cli_gate_resume", 1)):
            want = {"ssd_bwd": SSD_CALLS_PER_FORWARD * epochs * n_batches,
                    "ssd_fwd": SSD_CALLS_PER_FORWARD * epochs * (n_batches + 2 * n_dev)}
            if launches[path] != want:
                raise AssertionError(f"{path}: ssd launches {launches[path]}, want {want} "
                                     f"({epochs} epochs of {n_batches} batches, {n_dev} dev)")
        # train.scan_steps (which excludes the config's accum_grad 2): one
        # epoch at scan_steps 1, then 2, the groups' updates in a row between
        # host reads; the parameters equal bit for bit
        runs = {}
        for K in (1, 2):
            with syncs_per_read() as (syncs, _):
                tr = counted(f"train_cli_gate_scan{K}", train.run, gate_args(
                    "train.max_epoch=1", "accum_grad=1", f"train.scan_steps={K}",
                    "keep_nbest_models=0", exp_dir=root / f"exp_scan{K}"))
            runs[K] = {"params": {k: v.detach().cpu() for k, v in tr.model.state_dict().items()},
                       "reads": tr.host_reads, "steps": tr.global_step,
                       "groups": [h["group"] for h in tr.history], "syncs": syncs}
            del tr
            torch.cuda.empty_cache()
        one, two = runs[1], runs[2]
        checks["scan_steps=2 parameters bitwise"] = all(
            torch.equal(v, one["params"][key]) for key, v in two["params"].items())
        # the groups form (one read for each 2 updates), and the card's
        # synchronizing calls show one read a group
        checks["scan_steps=2 one host read a group"] = (
            one["reads"] == one["steps"] == two["steps"] >= 2
            and two["reads"] == len(two["syncs"]) == -(-two["steps"] // 2)
            and one_read_a_group(one["syncs"], two["syncs"], 2))
        out["scan"] = {K: {k: v for k, v in r.items() if k != "params"} for K, r in runs.items()}
        del runs, one, two
        ave_params = load_checkpoint(exp / "checkpoints" / "valid.loss.ave.ckpt")["averaged"]
        out["gate"] = dict(history=hist, k=k, cache=cache, best=best, files=files,
                           averaged=ave_params, checks=checks, n_params=n_params,
                           precision=precision)

        # the large config: one update of 4 micro-steps of 16k frames, remat dots
        large = counted("train_cli_large", train.run, train.parse_args(
            ["--config", str(configs / "typeA_large_N1.yaml"), "--exp-dir",
             str(root / "exp_large"), "train.max_steps=1", *paths]))
        n_large = sum(p.numel() for p in large.model.parameters())
        out["large"] = dict(history=large.history, n_params=n_large,
                            remat=large.model.encoder.main.remat_policy)
        del large
        torch.cuda.empty_cache()
        lf, lb = launches["train_cli_large"]["ssd_fwd"], launches["train_cli_large"]["ssd_bwd"]
        checks["large: 1 update, 4 micro-steps, remat dots"] = (
            len(out["large"]["history"]) == 1 and n_large == LARGE_N_PARAMS
            and out["large"]["remat"] == "dots" and lf == 2 * LARGE_SSD_CALLS * 4
            and lb == LARGE_SSD_CALLS * 4)

        # the LM through train_lm over a corpus file, one epoch
        rng = np.random.default_rng(SEED + 71)
        words = [w.upper() for w in lexicon(np.random.default_rng(SEED + 70), 400)]
        (root / "lm_corpus.txt").write_text("\n".join(
            " ".join(rng.choice(words, size=int(rng.integers(3, 25))))
            for _ in range(LM_CORPUS_LINES)) + "\n")
        # the token counts of the corpus, single-process (the CLI reuses the sidecar)
        t0 = time.perf_counter()
        n_lines = len(lm_text.LMTextDataset(tok, corpus_path=root / "lm_corpus.txt"))
        count_s = time.perf_counter() - t0
        lm_exp = root / "exp_lm"
        lm = counted("train_cli_lm", train_lm.run, train_lm.parse_args(
            ["--config", str(configs / "lm_transformer_500.yaml"), "--exp-dir", str(lm_exp),
             "train.max_epoch=1", f"bpemodel={root / 'bpe_500.model'}",
             f"data.lm_corpus={root / 'lm_corpus.txt'}", f"data.manifests_dir={mdir}",
             "data.dev_splits=[dev-clean]"]))
        out["lm"] = dict(history=lm.history, n_params=sum(p.numel() for p in lm.model.parameters()),
                         valid=lm.metric_history[("valid", "loss")][0],
                         lines_per_s=n_lines / count_s)
        del lm
        lm_ave = lm_exp / "checkpoints" / "valid.loss.ave.ckpt"
        checks["train_lm wrote valid.loss.ave.ckpt"] = lm_ave.exists()

        # the decode CLI from the files the trainers wrote
        dec = counted("train_cli_decode", decode.run, decode.parse_args(
            ["--config", str(yaml_gate), "--checkpoint",
             str(exp / "checkpoints" / "valid.loss.ave.ckpt"), "--splits", "dev-clean",
             "--out-dir", str(root / "decode"), *paths, "decode.read_outs=[ctc]",
             "decode.search=[greedy, beam]", f"decode.lm_checkpoint={lm_ave}",
             f"decode.lm_config={configs / 'lm_transformer_500.yaml'}"]))
        cells = sorted(c["cell"] for c in dec["cells"])
        n_recs = {c: len((root / "decode" / c / "dev-clean.jsonl").read_text().splitlines())
                  for c in cells}
        out["decode"] = {c["cell"]: c for c in dec["cells"]}
        checks["decode from the .ave files"] = (
            cells == ["ctc_beam", "ctc_beam_lm", "ctc_greedy"]
            and set(n_recs.values()) == {TRAIN_CLI_SPLITS["dev-clean"]}
            and launches["train_cli_decode"]["ssd_fwd"] > 0)
    phase_s = time.perf_counter() - t_phase
    cold = [r for r in gate_hist if r["epoch"] == 0]
    warm = [r for r in hist if r["epoch"] > 0]
    fmt = lambda rs, key: ", ".join(f"{r[key]:.1f}" for r in rs)      # noqa: E731
    log(f"  data: {sum(TRAIN_CLI_SPLITS.values())} utterances written in {tree_s:.1f} s, "
        f"manifests + tokenizer ({tok.vocab_size} pieces) + CMVN on the card "
        f"{secs['prep']:.1f} s; host library: FLAC {host['flac_ms']:.2f} ms and resample "
        f"(0.9) {host['resample_ms']:.2f} ms for {host['seconds']:.2f} s of audio")
    log(f"  gate config through the train CLI ({n_params:,} parameters, "
        f"{out['gate']['precision']}, 3 x "
        f"{len(entries)} items): updates (ms, CUDA events) epoch 0 [{fmt(cold, 'ms')}], later "
        f"[{fmt(warm, 'ms')}]; mel-frames/s "
        + ", ".join(f"{r['frames'] / r['ms'] * 1e3:.0f}" for r in hist)
        + f"; loader wait (ms) cold [{fmt(cold, 'wait_ms')}], warm [{fmt(warm, 'wait_ms')}]; "
        f"peak {out['train_cli_gate_peak'] / 1e9:.2f} / {out['train_cli_gate_resume_peak'] / 1e9:.2f}"
        f" GB; cache misses / hits {cache}; valid {dict(metric_history[('valid', 'loss')])} "
        f"(loss), {dict(metric_history[('valid', 'wer')])} (WER); runs "
        f"{secs['train_cli_gate']:.1f} + {secs['train_cli_gate_resume']:.1f} s; files {files}; "
        f"one epoch at accum_grad 1, train.scan_steps=1 / 2: "
        f"{secs['train_cli_gate_scan1']:.1f} / {secs['train_cli_gate_scan2']:.1f} s, "
        f"{out['scan'][1]['steps']} / {out['scan'][2]['steps']} updates in "
        f"{out['scan'][1]['reads']} / {out['scan'][2]['reads']} host reads (updates a read "
        f"{out['scan'][2]['groups']} at 2); synchronizing CUDA calls a read (the first from "
        f"the run's start) {out['scan'][1]['syncs']} / {out['scan'][2]['syncs']}")
    lr = out["large"]["history"][0]
    log(f"  typeA_large_N1 ({n_large:,} parameters, remat {out['large']['remat']}): one update "
        f"of 4 micro-steps {lr['ms']:.1f} ms, {lr['frames'] / lr['ms'] * 1e3:.0f} "
        f"mel-frames/s, peak {out['train_cli_large_peak'] / 1e9:.2f} GB, run "
        f"{secs['train_cli_large']:.1f} s; LM ({out['lm']['n_params']:,}) "
        f"{len(out['lm']['history'])} updates, "
        f"[{fmt(out['lm']['history'], 'ms')}] ms, valid loss {out['lm']['valid']:.4f}, corpus "
        f"index + token counts {out['lm']['lines_per_s']:.0f} lines/s (one process), run "
        f"{secs['train_cli_lm']:.1f} s; decode "
        + ", ".join(f"{c} RTF {v['rtf']:.4f}" for c, v in sorted(out["decode"].items()))
        + f" in {secs['train_cli_decode']:.1f} s; launches {launches}")
    log(f"  train CLIs phase: {phase_s:.1f} s (budget {TRAIN_CLI_BUDGET_S:.0f} s); checks "
        + ", ".join(f"{k} {v}" for k, v in checks.items()))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"train CLIs: {failed}")
    log("phase 20 train CLIs: ok")
    # the paths that run the SSD kernels (CMVN and the LM run none)
    out.update(launches={k: v for k, v in launches.items() if any(v.values())},
               seconds=phase_s, host=host, secs=secs)
    return out


INTERP_EPOCHS = 12              # tests/test_interp_e2e.py's length and word-probe bar
INTERP_WORD_BAR = 0.8
INTERP_BUDGET_S = 90.0          # the phase's own time budget
INTERP_FULL_MODES = ("boundaries", "probes")
PROBE_TOL = 2e-5                # predicted probabilities where scipy is confident
PROBE_CONFIDENT = 0.6
PROBE_CHECK = (20_000, 384, 50)         # n, d (the full width's d_outer), k
PROBE_TIMED = (200_000, 384, 500)       # k: the configs' interp.probe.top_k_words
PROBE_TRAIN_CAP = 1_000_000             # the configs' interp.probe.train_cap
PROBE_MAX_ITER = 1000                   # and max_iter
PROBE_SEP = 0.15                # the clusters' mean spread (unit noise): half confident


def probe_clusters(rng, n: int, d: int, k: int, n_test: int = 0):
    """Seeded Gaussian clusters: class means N(0, PROBE_SEP^2 I) in d
    dimensions, unit noise, labels uniform over k -> (X, y, X_test, y_test)."""
    means = rng.normal(size=(k, d)) * PROBE_SEP
    y = rng.integers(0, k, size=n + n_test)
    X = (means[y] + rng.normal(size=(n + n_test, d))).astype(np.float32)
    return X[:n], y[:n], X[n:], y[n:]


def probe_against_scipy(rng, n: int, d: int, k: int) -> dict:
    """The 'torch' fit on the card against scipy's float64 optimum on the
    host, on k seeded clusters: predicted probabilities within PROBE_TOL and
    decisions equal where scipy's top probability exceeds PROBE_CONFIDENT.
    scipy (gtol 1e-8, no stop on the decrease alone) starts from zeros at k 2
    and from the card's weights at k 50, where a start from zeros took 281
    iterations (78 s on the host) and this ~1/3 of them: the objective is
    convex and its optimum's probabilities unique, so the start does not
    move the optimum (tests/test_torch_interp.py holds the two starts within
    1e-6 of each other). Its float64 line search stalls near |grad| 1e-6
    (a step's decrease falls below f's rounding); its final |grad| must be
    below the device fit's own stop, 1e-5."""
    from hnet_mamba_asr_torch.interp import probes
    X, y, X_test, _ = probe_clusters(rng, n, d, k, n_test=5000)
    t0 = time.perf_counter()
    W, b, n_iter, grad = probes.torch_lbfgs_weights(X, y, k, max_iter=PROBE_MAX_ITER, C=1.0)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    W64, b64, n_iter64, grad64 = probes.lbfgs_weights(
        X, y, k, max_iter=5000, C=1.0, gtol=1e-8, ftol=0.0, init=(W, b) if k > 2 else None)
    host_s = time.perf_counter() - t0
    got, want = probes.predict_proba(W, b, X_test), probes.predict_proba(W64, b64, X_test)
    confident = want.max(axis=1) > PROBE_CONFIDENT
    out = dict(n=n, d=d, k=k, n_iter=n_iter, grad=grad, scipy_n_iter=n_iter64,
               scipy_grad=grad64, card_s=card_s, scipy_s=host_s,
               confident=float(confident.mean()),
               max_abs=float(np.abs(got - want)[confident].max()),
               decisions=bool((got.argmax(1) == want.argmax(1))[confident].all()))
    log(f"  probe fit k {k}, n {n}, d {d}: card {card_s:.2f} s, {n_iter} iterations, "
        f"|grad| {grad:.2e}; scipy float64 from {'it' if k > 2 else 'zeros'} {host_s:.2f} s, "
        f"{n_iter64} iterations, "
        f"|grad| {grad64:.2e}; where scipy is confident ({out['confident']:.1%} of 5000): "
        f"max|d p| {out['max_abs']:.3e} (bound {PROBE_TOL:g}), decisions equal "
        f"{out['decisions']}")
    if not (out["max_abs"] <= PROBE_TOL and out["decisions"] and confident.any()
            and grad64 < probes.TORCH_GTOL):
        raise AssertionError(f"the device probe is not scipy's optimum: {out}")
    return out


def phase_interp(cmvn) -> dict:
    """The interpretability suite on the card (phase 21 of the module's
    docstring), in a temporary directory. -> the runs' numbers."""
    from hnet_mamba_asr_torch.convert import load_jax_params, state_dict_to_jax_tree
    from hnet_mamba_asr_torch.data.audio import load_manifest
    from hnet_mamba_asr_torch.data.dataset import ASRDataset, make_dataloader
    from hnet_mamba_asr_torch.data.features import GlobalCMVN
    from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
    from hnet_mamba_asr_torch.interp import driver
    from hnet_mamba_asr_torch.interp.alignments import load_alignments
    from hnet_mamba_asr_torch.interp.probes import torch_lbfgs_weights
    from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.scripts import run_interp
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tasks.decode_task import encode_batch, load_model_params
    from hnet_mamba_asr_torch.tools import interp_e2e
    from hnet_mamba_asr_torch.tools.gate import seeded_tokenizer
    from hnet_mamba_asr_torch.training.checkpoint import save_checkpoint
    from hnet_mamba_asr_torch.utils.config import load_config
    out, launches, secs = {}, {}, {}
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def counted(path, fn, *args):
        ssd_cuda.launches = ssd_cuda.bwd_launches = ema_cuda.launches = ema_cuda.bwd_launches = 0
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        secs[path] = time.perf_counter() - t0
        launches[path] = {"ssd_fwd": ssd_cuda.launches, "ssd_bwd": ssd_cuda.bwd_launches,
                          "ema_fwd": ema_cuda.launches, "ema_bwd": ema_cuda.bwd_launches}
        return res

    with tempfile.TemporaryDirectory(prefix="chip_smoke_interp_") as tmp:
        root = Path(tmp) / "tone"
        # (a) the tone gate: train at N=2 through the train CLI, then the four
        # run_interp modes through the CLI, gated as the JAX script gates
        gate = counted("interp_tone_gate", interp_e2e.run, interp_e2e.parse_args(
            ["--root", str(root), "--epochs", str(INTERP_EPOCHS), "--word-probe-bar",
             str(INTERP_WORD_BAR), "--probe-backend", "torch"]))
        out["gate"] = gate
        log(f"  (a) tone gate, N=2, {INTERP_EPOCHS} epochs: train {gate['train_s']:.1f} s, "
            "modes " + ", ".join(f"{m} {v:.1f} s" for m, v in gate["mode_s"].items())
            + f"; word-id probe (frames) {gate['probe_frames']['word_id_accuracy']:.4f} "
            f"(bar {INTERP_WORD_BAR}), phone class "
            f"{gate['probe_frames']['phone_class_accuracy']:.4f} vs majority "
            f"{gate['probe_frames']['phone_class_majority']:.4f}; boundary words "
            f"{gate['boundary_words']} (random F1 {gate['boundary_random_f1']:.4f}); probe "
            f"iterations {gate['probe_n_iter']}; perturbations "
            f"{gate['robustness_perturbations']}; emergence epochs {gate['emergence_epochs']}, "
            f"words F1 {[round(v, 4) for v in gate['emergence_words_f1']]}; checks "
            f"{gate['checks']}; launches {launches['interp_tone_gate']}")
        if not gate["gate"] or len(gate["emergence_epochs"]) != INTERP_EPOCHS:
            raise AssertionError(f"interp tone gate failed: {gate['checks']}")

        # (b) the final checkpoint's boundary report, card (fp32, TF32 off)
        # against the plain path on the CPU: hard boundaries equal, then P/R/F1
        cfg = load_config(gate["config"])
        tok = Tokenizer(root / "tok" / "bpe.model")
        tone_cmvn = GlobalCMVN.load(root / "cmvn.npz")
        params = load_model_params(gate["checkpoint"])[0]
        aligns = {r["id"]: r for r in load_alignments(root / "alignments" / "dev-clean.jsonl")}
        entries = [e for e in load_manifest(root / "manifests" / "dev-clean.jsonl")
                   if e["id"] in aligns]
        durations = driver.durations_from_entries(entries)
        reports, encs = {}, {}
        for device in ("cuda", "cpu"):
            model = build_model(cfg, tok.vocab_size, cmvn=tone_cmvn, device=device)
            load_jax_params(model, params)
            encs[device] = []

            def encode(batch, model=model, seen=encs[device]):
                seen.append(encode_batch(model, batch)[0])
                return seen[-1]
            loader = make_dataloader(ASRDataset(entries, tok), 8000)[0]
            reports[device] = counted(f"interp_tone_{device}", lambda: driver.boundary_report(
                encode, loader, aligns, durations, tol=0.06)[0])
        for i, (got, want) in enumerate(zip(encs["cuda"], encs["cpu"])):
            check_boundaries(got.boundaries, want.boundaries, f"interp tone batch {i}")
        if reports["cuda"] != reports["cpu"]:
            raise AssertionError(f"interp: the card's boundary report differs from the CPU's: "
                                 f"{reports['cuda']} vs {reports['cpu']}")
        words = reports["cuda"]["stage0"]["words"]
        log(f"  (b) tone checkpoint card vs CPU (fp32, TF32 off): boundaries equal in "
            f"{len(encs['cuda'])} batch(es), reports equal (words P/R/F1 "
            f"{words['precision']:.4f} / {words['recall']:.4f} / {words['f1']:.4f})")

        # (c) configs/typeA_small_N2.yaml at full width (seeded, random
        # routers, a checkpoint as the trainer writes it) through run_interp
        # boundaries and probes on the tone audio and its alignments
        full = Path(tmp) / "full"
        full.mkdir()
        seeded_tokenizer(full / "bpe_500.model")
        cmvn.save(full / "cmvn.npz")
        yaml_path = Path(__file__).resolve().parent / "configs" / "typeA_small_N2.yaml"
        overrides = [f"bpemodel={full / 'bpe_500.model'}",
                     f"frontend_conf.cmvn={full / 'cmvn.npz'}",
                     f"data.manifests_dir={root / 'manifests'}",
                     f"interp.alignments_dir={root / 'alignments'}",
                     f"interp.probe_train_manifest={root / 'manifests' / 'probe-train.jsonl'}",
                     f"interp.probe_train_alignments={root / 'alignments' / 'probe-train.jsonl'}"]
        full_cfg = load_config(yaml_path, overrides)
        model = build_model(full_cfg, VOCAB, cmvn=cmvn, seed=SEED)
        draw_routers(model, SEED + 80)
        save_checkpoint(full / "asr.ckpt", {"params": state_dict_to_jax_tree(model.state_dict()),
                                            "epoch": 1})
        n_params = sum(p.numel() for p in model.parameters())
        del model
        torch.cuda.empty_cache()
        out["full"] = {}
        for mode in INTERP_FULL_MODES:
            path = f"interp_full_{mode}"
            res = counted(path, run_interp.run, run_interp.parse_args(
                ["--config", str(yaml_path), "--checkpoint", str(full / "asr.ckpt"), "--mode",
                 mode, "--out-dir", str(full / "out")] + overrides))
            passes, n = res["encoder_passes"], launches[path]
            out["full"][mode] = dict(seconds=res["seconds"], passes=passes, launches=n)
            log(f"  (c) {yaml_path.name} at full width ({n_params:,} parameters, "
                f"{full_cfg['train']['precision']}) run_interp --mode {mode}: "
                f"{res['seconds']['total']:.2f} s ({res['seconds']['encoder']:.2f} s in "
                f"{passes} encoder passes); launches {n}")
            if n["ssd_fwd"] != SSD_CALLS_PER_FORWARD * passes or n["ema_fwd"] != passes \
                    or passes == 0:
                raise AssertionError(f"{path}: launches {n} for {passes} encoder passes")
        block = res["probes"]
        if set(block) != {"frames", "chunks_s0"}:
            raise AssertionError(f"interp full width: probe levels {sorted(block)}")
        out["full"]["probes"]["accuracy"] = {f"{lvl}/{task}": r["accuracy"]
                                             for lvl, b in block.items() for task, r in b.items()}

    # (d) the device probe fit against scipy, a timed word-id-sized fit, and
    # the 2-class model
    rng = np.random.default_rng(SEED + 81)
    out["probe_check"] = probe_against_scipy(rng, *PROBE_CHECK)
    out["probe_binary"] = probe_against_scipy(rng, PROBE_CHECK[0], PROBE_CHECK[1], 2)
    n, d, k = PROBE_TIMED
    X, y, _, _ = probe_clusters(rng, n, d, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, n_iter, grad = torch_lbfgs_weights(X, y, k, max_iter=PROBE_MAX_ITER, C=1.0)
    fit_s = time.perf_counter() - t0
    out["probe_timed"] = dict(n=n, d=d, k=k, seconds=fit_s, n_iter=n_iter, grad=grad,
                              reckoned_train_cap_s=fit_s * PROBE_TRAIN_CAP / n)
    log(f"  (d) word-id-sized fit n {n}, d {d}, k {k} on the card: {fit_s:.2f} s, {n_iter} "
        f"iterations (max {PROBE_MAX_ITER}), final |grad| {grad:.2e}; at the configs' "
        f"train_cap of {PROBE_TRAIN_CAP:,} "
        f"reckoned {out['probe_timed']['reckoned_train_cap_s']:.1f} s (linear in n)")
    phase_s = time.perf_counter() - t_phase
    log(f"  interp phase: {phase_s:.1f} s (budget {INTERP_BUDGET_S:.0f} s); seconds {secs}")
    log("phase 21 interp: ok")
    out.update(launches={k: v for k, v in launches.items() if any(v.values())},
               seconds=phase_s)
    return out


# ── phase 22: the multi-rank planes ──────────────────────────────────────────
RANKS_BUDGET_S = 110.0          # the phase's own time budget
RANKS_ROWS = 8                  # 7 real utterances of 10 s and a padding row
SP_SECONDS = 35.0               # 2 x 35 s, one shard of 17.5 s per rank
# fp32, TF32 off, one card: DDP's mean of two half-batch gradients against
# one process's gradient of the whole batch, per leaf as max|d| / max|g|.
# Half a batch takes other cuDNN / cuBLAS kernels and other SSD-backward
# reduction groups than the whole; the leaves that sum one number per head
# or channel over every position of every row (a_log, dt_bias, the first
# conv's) cancel heavily and keep more of that rounding, as in phase 7 (on
# an H100: worst 1.21e-3, an a_log; one rank under NCCL against one process
# <= 2.8e-7). bf16's gap to the whole batch is recorded, not
# bounded: half a batch rounds its activations at other kernels' boundaries
# (3.87e-2 then). split_grads is the witness: one process, the same row
# slices, the global sums; its gap to the whole batch is the split's
# rounding, and DDP is held to it per leaf within RANKS_SPLIT_BOUND of the
# leaf's max in fp32 (only the collectives' sums and the CTC backward's
# atomics part them) and within phase 7's bounds in bf16.
RANKS_GRAD_BOUND = PARAM_GRAD_BOUND
RANKS_SUM_LEAVES = (".a_log", ".dt_bias", *CONV1_LEAVES)
RANKS_SPLIT_BOUND = 1e-5
FSDP_RTOL, FSDP_ATOL = 2e-4, 2e-5         # tests/test_fsdp.py:92
# sp = 2 against the offline encoder, fp32 with intra_dtype off
# (tests/test_seq_parallel.py's bounds): features on valid frames, the ratio
# loss and kept fraction, the loss (relative) and every gradient leaf (of
# its max)
SP_FEATURE_BOUND, SP_SCALAR_BOUND, SP_LOSS_RTOL, SP_GRAD_RTOL = 2e-4, 1e-6, 2e-4, 5e-3
RANKS_CELLS = ("ctc_greedy", "aed_beam")
# tp = 2 and ep = 2 on the pair (the ranks share the card; dp = 1, so both
# ranks of the model group hold every row): the gate config's gradient
# against the witness (one process computing both shards in turn, a
# virtual plane of parallel/model_parallel.py) within RANKS_SPLIT_BOUND of
# each leaf's max in fp32 and phase 7's bounds in bf16; and in fp32 against
# plain one process within RANKS_SPLIT_BOUND of each leaf's max, except the
# leaves a rounding control moves further: those within ULP_RATIO times the
# control's gap, and never past phase 7's bounds. The control is plain one
# process again with every weight moved one ulp, up or down at random
# (ulp_twin): the size of rounding the narrower GEMMs and the ranks' fp32
# partial sums bring in, through the plain code (on an H100 it moved 424 of
# the 563 leaves past 1e-5, and tp's gap read at most 2.16 times its gap on
# any leaf, a main-stack a_log). The
# MoE config's (8 experts, top 2) under ep against one process, bitwise where
# the expert GEMMs agree, else within EP_GRAD_BOUND of each leaf's max;
# decode.tp = 2 in fp32 (TF32 off) against one process in TP_CELLS with the
# AED at DECODE_AED_LAYERS of its 6 layers (phase 13's cut), and ctc_greedy
# alone == batched under tp in bf16
EP_GRAD_BOUND = 1e-5
ULP_RATIO = 4.0
TP_CELLS = ("ctc_greedy", "ctc_beam", "joint_beam")
# the H-Net's hard boundaries (p >= 0.5) under sp and tp against one
# process. In fp32 (TF32 off) the boundaries are equal and the router's
# probabilities p within BOUNDARY_CLIFF (tests/torch_parity.py's 1e-4), the
# features within SP_FEATURE_BOUND (sp, JAX's) or RANKS_SPLIT_BOUND (tp) of
# their max. In bf16 one process's own p lies ~1e-3 from its fp32 p, so a
# flip near 0.5 says nothing; a path is held instead to be as close to the
# fp32 pass as one process in bf16 is, within BF16_RATIO: max|p - p_fp32|
# on every valid frame, and the features' max|d| / max|f| to the fp32 pass
# on the rows whose boundaries agree in all three passes
BOUNDARY_CLIFF = 1e-4
BF16_RATIO = 2.0
# pp = 2 on the pair (dp = 1, both ranks every row): the gate config's 12
# main-stack blocks, 6 a stage, over PP_MICROBATCHES microbatches of the 8
# rows. The witness is one process running both stages in turn on the same
# microbatches with the same gradient sums in the same order
# (parallel/pipeline.py without a group): a rank's loss, features and
# gradients equal it bitwise, or a leaf lies within the one-ulp control's gap
# (ulp_twin, fp32 and bf16), and is named; in fp32 the ranks are also held to
# plain one process as tp is (1e-5 of each leaf's max, or ULP_RATIO times the
# control's gap up to phase 7's bounds). Two Trainer updates: the gathered
# parameters equal the witness's two updates bitwise, or within a two-update
# control's gap (one process's updates from weights one ulp away), and one
# process's within ULP_RATIO times that gap. A rank's SSD calls a pass: 2
# directions x (the 8 outer blocks + its 6 blocks per microbatch)
PP_MICROBATCHES = 2
PP_SSD_PER_PASS = 2 * (8 + 6 * PP_MICROBATCHES)


def decode_model(model):
    """The gate model (bf16) for decoding, its AED capped at DECODE_CAP
    (seeded weights never emit eos)."""
    model.aed.max_decode_len = DECODE_CAP
    return model.eval()
GLOO_CUDA_OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
                 "reduce_scatter_tensor")
# the point-to-point ops, in a pair of their own after those (a probe ends at
# its first refusal, and gloo refuses reduce_scatter_tensor): a refusal may
# crash the group (gloo's send / recv hand the tensor's pointer to its TCP
# transport), so they come last in their pair too
GLOO_P2P_OPS = ("send_recv", "batch_isend_irecv")
GLOO_P2P_TIMEOUT_S = 20.0


def ranks_batch(rng, seconds: float, rows: int, real: int, base: int = 0) -> dict:
    """A host batch of ``real`` seeded utterances of ``seconds`` padded with
    ``rows - real`` padding rows (PCM16 wire, as the gate loader ships)."""
    from hnet_mamba_asr_torch.data.dataset import collate_batch
    n = int(seconds * SR)
    items = [{"wave": synth_audio(rng, 0.0, n), "n_samples": n,
              "tokens": rng.integers(4, VOCAB, size=int(rng.integers(10, 40))).astype(np.int32),
              "id": f"utt{base + i}", "index": base + i} for i in range(real)]
    return collate_batch(items, pad_id=3, seed=SEED, epoch=0, batch_multiple=rows,
                         snap_lengths=False, wire_dtype="int16")


def ranks_configs() -> dict:
    """The phase's configs: the gate config in fp32 (intra off, TF32 off)
    and as it is (bf16), configs/typeA_small_N2.yaml in fp32 for sp and as
    it is for sp and tp in bf16, the MoE config in fp32 for ep, all at full
    width and depth, remat full (three processes share the card); and the
    gate config in fp32 with its AED at DECODE_AED_LAYERS layers for
    decode.tp."""
    def cut(config, precision):
        cfg = copy.deepcopy(config)
        cfg["encoder_conf"]["remat_policy"] = "full"
        if precision == "fp32":
            cfg["encoder_conf"]["ssd_intra_dtype"] = None
            cfg["train"]["precision"] = "fp32"
        return cfg
    from hnet_mamba_asr_torch.tools.gate import MOE_CONFIG
    dec = cut(GATE_CONFIG, "fp32")
    dec["aed_conf"].update(n_layers=DECODE_AED_LAYERS, max_decode_len=DECODE_CAP)
    return {"fp32": cut(GATE_CONFIG, "fp32"), "bf16": cut(GATE_CONFIG, "bf16"),
            "sp": cut(N2_CONFIG, "fp32"), "sp_bf16": cut(N2_CONFIG, "bf16"),
            "moe": cut(MOE_CONFIG, "fp32"), "dec": dec}


# the updates of DDP against FSDP: Adam's eps 0.1 makes an update near-linear
# in its gradient (at 1e-8 an element whose gradient is rounding noise moves
# by the rate's size, and FSDP's per-tensor step rounds otherwise than the
# fused one), as in tests/test_torch_fsdp.py
RANKS_TRAIN = dict(GATE_TRAIN, accum_grad=1, max_epoch=1, max_steps=2, scheduler=None,
                   log_interval=1, async_ckpt=False, valid_interval_epoch=1,
                   optim_conf=dict(GATE_TRAIN["optim_conf"], eps=0.1))


@contextlib.contextmanager
def syncs_per_read():
    """Counts the synchronizing CUDA calls (torch's sync debug mode: a copy
    to the host, ``.item()``, ``nonzero()``, a stream or device sync) that
    a ``Trainer`` makes up to each host read of its records. Yields a list
    that gets, at each ``Trainer._commit``, the calls since the one before
    (the first: since the block began), that read's own included, and a
    dict that gets, on leaving, {"file:line" of the Python call: calls}."""
    from hnet_mamba_asr_torch.training.trainer import Trainer
    counts, sites, commit = [], {}, Trainer._commit
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def syncs():
            return [w for w in caught if "synchronizing CUDA operation" in str(w.message)]

        def marked(self, updates, sums):
            commit(self, updates, sums)
            counts.append(len(syncs()) - sum(counts))

        Trainer._commit = marked
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counts, sites
        finally:
            torch.cuda.set_sync_debug_mode("default")
            Trainer._commit = commit
            for w in syncs():
                site = f"{Path(w.filename).name}:{w.lineno}"
                sites[site] = sites.get(site, 0) + 1


def one_read_a_group(one: list, two: list, K: int) -> bool:
    """Whether a run at scan_steps = K made, for each group of K updates
    (the last may hold fewer), the synchronizing calls of those updates at
    scan_steps = 1 (``one``, a list a read) less one for each update but
    the first: the model's own calls stay, the trainer reads once a group."""
    return two == [sum(one[i:i + K]) - len(one[i:i + K]) + 1 for i in range(0, len(one), K)]


def unsaved_trainer(*args, **kw):
    """A ``Trainer`` that writes no checkpoint: phase 22 reads its model and
    history, and each save would gather and pickle ~1 GB while every other
    process of the phase runs (a multi-rank run's checkpoints and resume on
    the card are tools/smoke_2proc.py's)."""
    from hnet_mamba_asr_torch.training.trainer import Trainer

    class Unsaved(Trainer):
        def save_checkpoint(self) -> None:
            pass
    return Unsaved(*args, **kw)


def _grad_gap(got: dict, ref: dict) -> list:
    """[(max|d| / max|g|, leaf, mean|d| / mean|g|)] worst first."""
    rows = []
    for name, g in ref.items():
        d = (got[name].float() - g.float()).abs()
        rows.append(((d.max() / g.float().abs().max().clamp(min=1e-30)).item(), name,
                     (d.mean() / g.float().abs().mean().clamp(min=1e-30)).item()))
    return sorted(rows, reverse=True)


def boundary_gap(p, b, p_ref, b_ref, lengths) -> dict:
    """The hard boundaries of one pass against a reference pass on each
    row's valid frames: how many differ, their distances |p_ref - 0.5| (the
    10 largest), the router's gap max|p - p_ref| over the valid frames
    (p comes from the encoder stack before any chunking, so it measures
    that stack's rounding), and which rows agree on every frame."""
    L = min(b.shape[1], b_ref.shape[1])
    valid = torch.arange(L)[None, :] < torch.as_tensor(lengths).cpu()[:, None]
    diff = (b[:, :L].float().cpu() != b_ref[:, :L].float().cpu()) & valid
    p, p_ref = p[:, :L].float().cpu(), p_ref[:, :L].float().cpu()
    dist = (p_ref - 0.5).abs()[diff]
    return {"differ": int(diff.sum()), "frames": int(valid.sum()),
            "max_dist": float(dist.max()) if len(dist) else 0.0,
            "dists": sorted(dist.tolist(), reverse=True)[:10],
            "p_gap": float((p - p_ref).abs()[valid].max()),
            "rows_agree": [bool(x) for x in ~diff.any(1)]}


def encoded(enc, group=None) -> dict:
    """An encoder output's router p and boundaries b of the first stage and
    its features, on the host (an sp rank's p and b gathered over
    ``group`` into whole rows)."""
    p, b = enc.boundaries[0]
    if group is not None:
        from hnet_mamba_asr_torch.parallel.collectives import all_gather
        p, b = (all_gather(t, group).permute(1, 0, 2).reshape(t.shape[0], -1) for t in (p, b))
    return {"p": p.float().cpu(), "b": b.float().cpu(), "features": enc.features.float().cpu(),
            "kept": float(enc.kept_fractions[0])}


def bf16_against_fp32(got: dict, ref16: dict, ref32: dict, lengths) -> dict:
    """A bf16 pass ``got`` and one process's bf16 pass ``ref16`` each
    against one process's fp32 pass ``ref32`` of the same rows (module
    constants, BF16_RATIO): the boundaries of ``got`` against ``ref16``,
    both passes' router gaps to fp32, and both passes' feature gaps to
    fp32 on the rows whose boundaries agree in all three."""
    bg = boundary_gap(got["p"], got["b"], ref16["p"], ref16["b"], lengths)
    mine = boundary_gap(got["p"], got["b"], ref32["p"], ref32["b"], lengths)
    ctrl = boundary_gap(ref16["p"], ref16["b"], ref32["p"], ref32["b"], lengths)
    rows = [a and m and c for a, m, c in zip(bg["rows_agree"], mine["rows_agree"],
                                             ctrl["rows_agree"])]
    return {"boundaries": bg, "p_gap": mine["p_gap"], "ctrl_p_gap": ctrl["p_gap"],
            "ctrl_flips": ctrl["dists"], "rows": sum(rows),
            "feature_gap": row_feature_gap(got["features"], ref32["features"], lengths, rows),
            "ctrl_feature_gap": row_feature_gap(ref16["features"], ref32["features"], lengths,
                                                rows),
            "gap_to_ref16": row_feature_gap(got["features"], ref16["features"], lengths,
                                            bg["rows_agree"])}


def bf16_ok(r: dict) -> bool:
    """``bf16_against_fp32``'s holds: p and, where rows agree, the features
    as close to fp32 as one process in bf16 is, within BF16_RATIO."""
    return r["p_gap"] <= BF16_RATIO * r["ctrl_p_gap"] and (
        r["rows"] == 0 or r["feature_gap"] <= BF16_RATIO * r["ctrl_feature_gap"])


def bf16_line(r: dict) -> str:
    bg = r["boundaries"]
    return (f"boundaries first, {bg['differ']} of {bg['frames']} valid frames differ from one "
            f"process in bf16, their |p - 0.5| (largest first) "
            f"{[f'{d:.3e}' for d in bg['dists']]}, max|p - p_ref| {bg['p_gap']:.3e}; against "
            f"one process in fp32 max|p - p_fp32| {r['p_gap']:.3e}, one process in bf16 "
            f"{r['ctrl_p_gap']:.3e} (its own flips at |p - 0.5| "
            f"{[f'{d:.3e}' for d in r['ctrl_flips'][:5]]}), ratio "
            f"{r['p_gap'] / max(r['ctrl_p_gap'], 1e-30):.3f} (bound {BF16_RATIO:g}); features "
            f"to fp32 on the {r['rows']} rows all three agree on {r['feature_gap']:.3e}, one "
            f"process in bf16 {r['ctrl_feature_gap']:.3e}; to one process in bf16 on the "
            f"{sum(bg['rows_agree'])} rows that agree with it {r['gap_to_ref16']:.3e}")


def ulp_twin(model, seed: int):
    """A copy of ``model`` whose every weight moved one ulp, up or down at
    random from ``seed``: the same function up to rounding."""
    twin = copy.deepcopy(model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in twin.parameters():
            up = (torch.rand(p.shape, generator=g) < 0.5).to(p.device)
            p.copy_(torch.nextafter(p, torch.where(up, math.inf, -math.inf).to(p.dtype)))
    return twin


def row_feature_gap(f, ref, lengths, rows) -> float:
    """max over ``rows`` of max|d| / max|ref| on each row's valid frames."""
    f, ref = f.float().cpu(), ref.float().cpu()
    gaps = [((f[i, :n].float() - ref[i, :n].float()).abs().max()
             / ref[i, :n].float().abs().max()).item()
            for i, n in enumerate(int(x) for x in lengths) if rows[i] and n > 0]
    return max(gaps) if gaps else float("nan")


def gathered_grads(tr) -> dict:
    """The gradients of a tp / ep trainer's model, whole (every rank of a
    plane takes part in each split leaf's gather), on the host."""
    return {n: (tr._gather_leaf(n, p.grad) if n in tr.mp_plan else p.grad).detach().cpu()
            for n, p in tr.model.named_parameters()}


def split_grads(model, batch: dict, world: int, on_card) -> dict:
    """One process's witness of what DDP over ``world`` ranks computes: each
    rank's rows (``rank_rows``) through ``loss_fn`` with every ``batch_sum``
    made global and the AED dropout's draw taken for the global batch, the
    gradients summed over the slices (DDP's mean of the ranks' gradients of
    the global loss). Two passes: the first records each slice's
    ``batch_sum`` operands in call order, the second adds the other slices'
    to each, as the all-reduce would. -> {leaf: gradient on the host}."""
    from hnet_mamba_asr_torch.models import aed, moe
    from hnet_mamba_asr_torch.parallel import collectives as col
    from hnet_mamba_asr_torch.parallel.mesh import rank_rows
    saved = (col._ROWS_GROUP, col.all_reduce_sum, col.row_slice, aed.row_slice, moe.row_slice)
    seen = [[] for _ in range(world)]
    at = {"slice": 0, "call": 0, "record": True}

    def global_sum(x, group=None):
        r, i = at["slice"], at["call"]
        at["call"] += 1
        if at["record"]:
            seen[r].append(x.detach().clone())
            return x
        return x + sum(seen[o][i] for o in range(world) if o != r)

    def part():
        return at["slice"], world

    col._ROWS_GROUP, col.all_reduce_sum = "witness", global_sum
    col.row_slice = aed.row_slice = moe.row_slice = part
    model.zero_grad(set_to_none=True)
    try:
        for record in (True, False):
            for r in range(world):
                at.update(slice=r, call=0, record=record)
                loss, _ = model.loss_fn(on_card(rank_rows(batch, r, world)), 0, True)
                if not record:
                    loss.backward()
                del loss
    finally:
        (col._ROWS_GROUP, col.all_reduce_sum, col.row_slice, aed.row_slice,
         moe.row_slice) = saved
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def _wait_for(path: Path, timeout: float = 600.0) -> Path:
    """``path`` once another process has written it (atomically)."""
    t0 = time.perf_counter()
    while not path.exists():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.1)
    return path


def _save_atomic(obj, path: Path) -> None:
    torch.save(obj, path.with_suffix(".tmp"))
    os.replace(path.with_suffix(".tmp"), path)


def ranks_worker(tmp: Path) -> None:
    """One rank of phase 22 (``chip_smoke.py --ranks-worker DIR``): two
    ranks share the card under gloo, one rank alone runs NCCL."""
    import pickle

    import torch.distributed as dist

    from hnet_mamba_asr_torch.data.dataset import ItemLoader
    from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.parallel import mesh as pmesh
    from hnet_mamba_asr_torch.parallel.seq_parallel import SPModel, sp_encode
    from hnet_mamba_asr_torch.tasks.decode_task import decode_split
    from hnet_mamba_asr_torch.tools.gate import seeded_tokenizer
    world = int(os.environ["WORLD_SIZE"])
    pmesh.init_distributed("cuda", "gloo" if world > 1 else "nccl")
    rank = dist.get_rank()
    dev = pmesh.rank_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = pickle.loads((tmp / "job.pkl").read_bytes())
    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "stages": [("joined", time.time())]}

    def stage(name):
        out["stages"].append((name, time.time()))
        print(f"[rank {rank} of {world}] {name}", flush=True)

    def model_of(key):
        """The parent's build of ``key``'s config (routers drawn at N=2),
        loaded from its file: a full-width build draws ~80 M weights on the
        host, which every process at once would contend for."""
        return torch.load(_wait_for(tmp / f"base_{key}.pt"), map_location=dev,
                          weights_only=False).train()

    # each use of a base takes a copy on the card of the untouched one. The
    # updates go first: they wait only for the gloo probe and the parent's
    # first build, while the parent makes the references that sp and the
    # gradient stages wait for (its whole-batch gradients and split
    # witnesses first, so that its offline sp update runs warm).
    bases = {}

    def fresh(label):
        if label not in bases:
            bases[label] = model_of(label)
        return copy.deepcopy(bases[label])

    # 2 updates under DDP, then FSDP, on each rank's rows of 2 global batches;
    # FSDP2 needs all_gather_into_tensor and reduce_scatter_tensor, which gloo
    # may refuse on CUDA tensors: then FSDP runs at world size 1 under NCCL only
    rows = [pmesh.rank_rows(b, rank, world) for b in job["updates"]]
    trees = {}
    gloo = json.loads(_wait_for(tmp / "gloo.json").read_text()) if world > 1 else {}
    fsdp_ok = world == 1 or all(gloo[op] == "ok" for op in
                                ("all_gather_into_tensor", "reduce_scatter_tensor"))
    out["fsdp_ran"] = fsdp_ok
    for label, extra in (("ddp", {}), ("fsdp", {"fsdp": True}))[:2 if fsdp_ok else 1]:
        stage(f"updates {label}")
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        tr = unsaved_trainer(fresh("fp32"), rows, dict(RANKS_TRAIN, **extra),
                     ckpt_dir=tmp / f"u{world}{rank}{label}", seed=SEED, device=dev)
        tr.train()
        state = [p for p in tr.model.parameters()] + [
            t for st in tr.opt.state.values() for k, t in st.items()
            if torch.is_tensor(t) and k != "step"]
        local = sum((t.to_local() if pmesh.is_dtensor(t) else t).numel() * 4 for t in state)
        trees[label] = pmesh.full_state(tr.model.state_dict(), keep=True)
        out[label] = {"ms": [h["ms"] for h in tr.history], "loss": [h["loss/total"]
                                                                   for h in tr.history],
                      "state_bytes": local, "peak": torch.cuda.max_memory_allocated(dev),
                      "sharded": sum(pmesh.is_dtensor(p) for p in tr.model.parameters())}
        del tr
        torch.cuda.empty_cache()
    out["fsdp_vs_ddp"] = max(
        ((trees["fsdp"][k] - v).abs() - FSDP_RTOL * v.abs()).max().item() for k, v in
        trees["ddp"].items()) if fsdp_ok else None
    out["ddp_tree_digest"] = float(sum(v.double().sum() for v in trees["ddp"].values()))
    del trees
    if world > 1:
        # sp = 2 on configs/typeA_small_N2.yaml: encoder, loss, gradients
        stage("sp")
        model = model_of("sp")
        sp = SPModel(model, pmesh.make_mesh(2, dev))
        ref = torch.load(_wait_for(tmp / "ref_sp.pt"), map_location=dev)
        batch = {k: torch.as_tensor(v).to(dev) if isinstance(v, np.ndarray) else v
                 for k, v in job["sp_batch"].items() if k != "ids"}
        with torch.no_grad():
            feats, flens = model.features(batch, False)
            enc = sp_encode(model.encoder, feats, flens, sp.shards)
        n = ref["lengths"]
        f = enc.features[:, :ref["features"].shape[1]]
        gap = max(((f[i, :n[i]] - ref["features"][i, :n[i]]).abs().max()
                   / ref["features"][i, :n[i]].abs().max()).item() for i in range(len(n)))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        ssd_cuda.launches = ssd_cuda.bwd_launches = ema_cuda.launches = ema_cuda.bwd_launches = 0
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        loss, stats = sp.loss_fn(batch, 0, False)
        loss.backward()
        t1.record()
        t1.synchronize()
        launches = {"ssd_fwd": ssd_cuda.launches, "ssd_bwd": ssd_cuda.bwd_launches,
                    "ema_fwd": ema_cuda.launches, "ema_bwd": ema_cuda.bwd_launches}
        grads = {}
        for name, p in model.named_parameters():
            g = p.grad.detach().clone()
            dist.all_reduce(g)
            grads[name] = g / world
        got = encoded(enc, sp.shards.group)
        out["sp"] = {"boundaries": boundary_gap(got["p"], got["b"], ref["p"], ref["b"], n),
                     "feature_gap": gap, "ratio": float(enc.ratio_loss),
                     "ref_ratio": ref["ratio"], "kept": float(enc.kept_fractions[0]),
                     "ref_kept": ref["kept"], "loss": loss.item(), "ref_loss": ref["loss"],
                     "grad_gap": _grad_gap(grads, ref["grads"]), "launches": launches,
                     "ms": t0.elapsed_time(t1),
                     "peak": torch.cuda.max_memory_allocated(dev) - before}
        shards = sp.shards
        ref32 = {k: ref[k].cpu() for k in ("p", "b", "features")}
        del model, sp, ref, grads, loss
        # the config's own bf16, against one process in bf16 and in fp32
        model = model_of("sp_bf16").eval()
        ref = torch.load(_wait_for(tmp / "ref_sp16.pt"), map_location="cpu")
        with torch.no_grad():
            feats, flens = model.features(batch, False)
            got = encoded(sp_encode(model.encoder, feats, flens, shards), shards.group)
        n = ref["lengths"]
        out["sp_bf16"] = dict(bf16_against_fp32(got, ref, ref32, n),
                              all_rows_gap=row_feature_gap(got["features"], ref["features"], n,
                                                           [True] * len(n)),
                              kept=got["kept"], ref_kept=ref["kept"])
        del model, ref, got
        torch.cuda.empty_cache()
        tp_stages(out, tmp, job, dev, model_of, fresh, stage)
        pp_stages(out, tmp, job, dev, model_of, fresh, stage)
    # DDP gradients of one micro-step against one rank's (train mode: the
    # row-keyed SpecAugment and AED dropout); bf16's gap on the gloo pair only
    for label in ("fp32", "bf16")[:2 if world > 1 else 1]:
        stage(f"grad {label}")
        tr = unsaved_trainer(fresh(label), [], RANKS_TRAIN,
                             ckpt_dir=tmp / f"g{world}{rank}{label}", seed=SEED, device=dev)
        stats = tr._micro_step(pmesh.rank_rows(job["batch"], rank, world))
        ref = torch.load(_wait_for(tmp / f"ref_{label}.pt"), map_location=dev)
        grads = {n: p.grad for n, p in tr.model.named_parameters()}
        out[f"grad_{label}"] = {"gap": _grad_gap(grads, ref["grads"]),
                                "split_gap": _grad_gap(grads, ref["split"]) if world > 1 else None,
                                "loss": float(stats["loss/total"]), "ref_loss": ref["loss"]}
        del grads, tr, ref
        torch.cuda.empty_cache()
    if world > 1:
        # decoding over the two ranks
        stage("decode")
        tok = seeded_tokenizer(tmp / f"tok{rank}.json")
        model = decode_model(fresh("bf16"))
        out["decode"] = {}
        for cell in job["cells"]:
            where = tmp / f"ranks{rank}_{cell['name']}.jsonl"
            loader = ItemLoader(job["decode_items"], 32000, pad_id=tok.pad_id, shuffle=False,
                                batch_multiple=world)
            decode_split(model, tok, loader, cell, job["decode_cfg"], audio_seconds={},
                         out_path=where, ranks=(rank, world))
            out["decode"][cell["name"]] = where.read_text() if where.exists() else None
    stage("done")
    (tmp / f"out{world}_{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def tp_stages(out: dict, tmp: Path, job: dict, dev, model_of, fresh, stage) -> None:
    """The pair's tp = 2 and ep = 2 stages (phase 22): dp = 1, so both ranks
    of the model group hold every row of the batch."""
    from hnet_mamba_asr_torch.data.dataset import ItemLoader
    from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.parallel import mesh as pmesh
    from hnet_mamba_asr_torch.parallel.model_parallel import place_model, plane_of
    from hnet_mamba_asr_torch.tasks.decode_task import decode_batch, decode_split
    from hnet_mamba_asr_torch.tools.gate import seeded_tokenizer
    tp_mesh = pmesh.make_mesh(device=dev, tp=2)

    def timed_step(tr, batch) -> dict:
        """One micro-step, then the update, on CUDA events: launches,
        seconds, peak memory above the start, the gathered gradients."""
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        ssd_cuda.launches = ssd_cuda.bwd_launches = ema_cuda.launches = ema_cuda.bwd_launches = 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        stats = tr._micro_step(batch)
        ev[1].record()
        launches = {"ssd_fwd": ssd_cuda.launches, "ssd_bwd": ssd_cuda.bwd_launches,
                    "ema_fwd": ema_cuda.launches, "ema_bwd": ema_cuda.bwd_launches}
        grads = gathered_grads(tr)
        ev[1].synchronize()
        t_apply = torch.cuda.Event(enable_timing=True)
        t_apply.record()
        tr._apply_step()
        ev[2].record()
        ev[2].synchronize()
        return {"stats": {k: float(v) for k, v in stats.items()}, "launches": launches,
                "grads": grads, "ms": ev[0].elapsed_time(ev[1]),
                "apply_ms": t_apply.elapsed_time(ev[2]),
                "peak": torch.cuda.max_memory_allocated(dev) - before,
                "state_bytes": 12 * sum(p.numel() for p in tr.model.parameters())}

    for label in ("fp32", "bf16"):
        stage(f"tp {label}")
        tr = unsaved_trainer(fresh(label), [], dict(RANKS_TRAIN, tp=2),
                             ckpt_dir=tmp / f"tp{label}", seed=SEED, device=dev, mesh=tp_mesh)
        r = timed_step(tr, job["batch"])
        ref = torch.load(_wait_for(tmp / f"ref_{label}.pt"), map_location="cpu")
        wit = torch.load(_wait_for(tmp / f"ref_tpw_{label}.pt"), map_location="cpu")
        grads = r.pop("grads")
        out[f"tp_{label}"] = dict(r, gap=_grad_gap(grads, ref["grads"]), ref_loss=ref["loss"],
                                  witness_gap=_grad_gap(grads, wit["grads"]),
                                  witness_loss=wit["loss"],
                                  bitwise=sum(torch.equal(grads[n], g)
                                              for n, g in wit["grads"].items()))
        del tr, grads, ref, wit
        torch.cuda.empty_cache()
    # N=2 with random routers: one forward of the 8 rows of 10 s in fp32 and
    # in bf16 against one process (and in bf16 against the witness)
    batch = {k: torch.as_tensor(v).to(dev) if isinstance(v, np.ndarray) else v
             for k, v in job["batch"].items() if k != "ids"}
    refs = {k: torch.load(_wait_for(tmp / f"ref_tpn2_{k}.pt"), map_location="cpu")
            for k in ("fp32", "bf16", "witness")}
    n = refs["fp32"]["lengths"]
    for label, base in (("fp32", "sp"), ("bf16", "sp_bf16")):
        stage(f"tp n2 {label}")
        model = model_of(base).eval()
        place_model(model, plane_of(tp_mesh, "tp", 2))
        ssd_cuda.launches = ema_cuda.launches = 0
        with torch.no_grad():
            got = encoded(model.encoder(*model.features(batch, False)))
        r = {"launches": {"ssd_fwd": ssd_cuda.launches, "ema_fwd": ema_cuda.launches},
             "b": got["b"], "kept": got["kept"], "ref_kept": refs[label]["kept"]}
        if label == "fp32":
            r.update(boundaries=boundary_gap(got["p"], got["b"], refs["fp32"]["p"],
                                             refs["fp32"]["b"], n),
                     feature_gap=row_feature_gap(got["features"], refs["fp32"]["features"], n,
                                                 [True] * len(n)))
        else:
            w = refs["witness"]
            r.update(bf16_against_fp32(got, refs["bf16"], refs["fp32"], n),
                     witness_equal=all(torch.equal(got[k], w[k]) for k in ("p", "b", "features")))
        out[f"tp_n2_{label}"] = r
        del model, got
    del refs
    # ep = 2 on the MoE config: one update against one process
    stage("ep")
    tr = unsaved_trainer(model_of("moe"), [], dict(RANKS_TRAIN, ep=2), ckpt_dir=tmp / "ep",
                         seed=SEED, device=dev, mesh=pmesh.make_mesh(device=dev, ep=2))
    r = timed_step(tr, job["batch"])
    ref = torch.load(_wait_for(tmp / "ref_moe.pt"), map_location="cpu")
    grads = r.pop("grads")
    out["ep"] = dict(r, gap=_grad_gap(grads, ref["grads"]), ref_stats=ref["stats"],
                     bitwise=sum(torch.equal(grads[n], g) for n, g in ref["grads"].items()))
    del tr, grads, ref
    torch.cuda.empty_cache()
    # decode.tp = 2: fp32 against one process; ctc_greedy alone == batched in bf16
    stage("decode tp")
    rank = int(os.environ["RANK"])
    tok = seeded_tokenizer(tmp / f"tok_tp{rank}.json")
    model = decode_model(model_of("dec"))
    place_model(model, plane_of(tp_mesh, "tp", 2))
    out["decode_tp"] = {}
    for cell in job["tp_cells"]:
        where = tmp / f"tp{rank}_{cell['name']}.jsonl"
        loader = ItemLoader(job["decode_items"], 32000, pad_id=tok.pad_id, shuffle=False)
        decode_split(model, tok, loader, cell, job["decode_cfg"], audio_seconds={},
                     out_path=where, ranks=(0, 1, 2))
        out["decode_tp"][cell["name"]] = where.read_text() if where.exists() else None
    model = decode_model(fresh("bf16"))
    place_model(model, plane_of(tp_mesh, "tp", 2))
    cell = next(c for c in job["tp_cells"] if c["name"] == "ctc_greedy")
    items = job["decode_items"]
    batched = decode_batch(model, tok, next(iter(ItemLoader(items, 10 ** 7, shuffle=False))),
                           cell, job["decode_cfg"])
    alone = [decode_batch(model, tok, next(iter(ItemLoader([it], 10 ** 7, shuffle=False))),
                          cell, job["decode_cfg"])[0] for it in items]
    out["tp_alone"] = {"same": {r["id"]: r["hyp"] for r in alone}     # the loader sorts rows
                       == {r["id"]: r["hyp"] for r in batched}, "n": len(items)}
    del model
    torch.cuda.empty_cache()


def pp_stages(out: dict, tmp: Path, job: dict, dev, model_of, fresh, stage) -> None:
    """The pair's pp = 2 stages (phase 22): dp = 1, both ranks hold every
    row; rank r holds the main stack's blocks [6 r, 6 r + 6). Each rank
    compares the leaves it holds."""
    from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda
    from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
    from hnet_mamba_asr_torch.parallel import mesh as pmesh
    from hnet_mamba_asr_torch.parallel.pipeline import PPModel
    rank = int(os.environ["RANK"])
    pp_mesh = pmesh.make_mesh(device=dev, pp=2)
    batch = {k: torch.as_tensor(v).to(dev) if isinstance(v, np.ndarray) else v
             for k, v in job["batch"].items() if k != "ids"}

    def held_bytes(tr) -> int:
        tensors = list(tr.model.parameters()) + [t for st in tr.opt.state.values()
                                                 for k, t in st.items()
                                                 if torch.is_tensor(t) and k != "step"]
        return sum(t.numel() * t.element_size() for t in tensors)

    for label in ("fp32", "bf16"):
        stage(f"pp {label}")
        pm = PPModel(fresh(label), pp_mesh, microbatches=PP_MICROBATCHES)
        tr = unsaved_trainer(pm, [], dict(RANKS_TRAIN, pp=2), ckpt_dir=tmp / f"pp{label}",
                             seed=SEED, device=dev)
        with torch.no_grad():                       # the same rows and SpecAugment draw
            feats = pm.encode(batch, True).features.float().cpu()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        ssd_cuda.launches = ssd_cuda.bwd_launches = ema_cuda.launches = ema_cuda.bwd_launches = 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        stats = tr._micro_step(job["batch"])
        ev[1].record()
        launches = {"ssd_fwd": ssd_cuda.launches, "ssd_bwd": ssd_cuda.bwd_launches,
                    "ema_fwd": ema_cuda.launches, "ema_bwd": ema_cuda.bwd_launches}
        grads = {n: p.grad.detach().cpu() for n, p in tr.model.named_parameters()}
        tr._apply_step()
        ev[2].record()
        ev[2].synchronize()
        r = {"stats": {k: float(v) for k, v in stats.items()}, "launches": launches,
             "ms": ev[0].elapsed_time(ev[1]), "apply_ms": ev[1].elapsed_time(ev[2]),
             "peak": torch.cuda.max_memory_allocated(dev) - before,
             "state_bytes": held_bytes(tr), "leaves": len(grads)}
        wit = torch.load(_wait_for(tmp / f"ref_ppw_{label}.pt"), map_location="cpu")
        ref = torch.load(_wait_for(tmp / f"ref_{label}.pt"), map_location="cpu")
        mine = {n: wit["grads"][n] for n in grads}
        out[f"pp_{label}"] = dict(
            r, witness_gap=_grad_gap(grads, mine), witness_loss=wit["loss"],
            bitwise=sum(torch.equal(grads[n], g) for n, g in mine.items()),
            features_equal=torch.equal(feats, wit["features"]),
            gap=_grad_gap(grads, {n: ref["grads"][n] for n in grads}), ref_loss=ref["loss"])
        del tr, pm, grads, wit, ref
        torch.cuda.empty_cache()
    # configs/typeA_small_N2.yaml, routers drawn: one forward of the rows
    refs = {k: torch.load(_wait_for(tmp / f"ref_tpn2_{k}.pt"), map_location="cpu")
            for k in ("fp32", "bf16")}
    n = refs["fp32"]["lengths"]
    for label, base in (("fp32", "sp"), ("bf16", "sp_bf16")):
        stage(f"pp n2 {label}")
        pm = PPModel(model_of(base).eval(), pp_mesh, microbatches=PP_MICROBATCHES)
        ssd_cuda.launches = ema_cuda.launches = 0
        with torch.no_grad():
            got = encoded(pm.encode(batch))
        r = {"launches": {"ssd_fwd": ssd_cuda.launches, "ema_fwd": ema_cuda.launches},
             "b": got["b"], "kept": got["kept"], "ref_kept": refs[label]["kept"]}
        if label == "fp32":
            r.update(boundaries=boundary_gap(got["p"], got["b"], refs["fp32"]["p"],
                                             refs["fp32"]["b"], n),
                     feature_gap=row_feature_gap(got["features"], refs["fp32"]["features"], n,
                                                 [True] * len(n)))
        else:
            r.update(bf16_against_fp32(got, refs["bf16"], refs["fp32"], n))
        out[f"pp_n2_{label}"] = r
        del pm, got
    del refs
    # two updates through Trainer (train.pp = 2) on the two global batches;
    # the stages gathered to rank 0 for the parent
    stage("pp updates")
    tr = unsaved_trainer(PPModel(fresh("fp32"), pp_mesh, microbatches=PP_MICROBATCHES),
                         job["updates"],
                         dict(RANKS_TRAIN, pp=2), ckpt_dir=tmp / "ppu", seed=SEED, device=dev)
    tr.train()
    params, _ = tr._stages_gathered(tr.model.state_dict(), tr.opt.state_dict())
    if rank == 0:
        _save_atomic({k: v.detach().cpu() for k, v in params.items()}, tmp / "pp_updates.pt")
    out["pp_updates"] = {"ms": [h["ms"] for h in tr.history],
                         "loss": [h["loss/total"] for h in tr.history],
                         "host_reads": tr.host_reads, "steps": tr.global_step}
    del tr, params
    torch.cuda.empty_cache()


def gloo_probe(ops=GLOO_CUDA_OPS) -> None:
    """One rank of a probe (``chip_smoke.py --gloo-probe [p2p]``): each of
    ``ops`` in turn under gloo on CUDA tensors, its result checked, "<op>
    ok" printed; the first that raises ends the process (a group that has
    refused a collective may crash on the next one)."""
    from datetime import timedelta

    import torch.distributed as dist

    from hnet_mamba_asr_torch.parallel import mesh as pmesh
    pmesh.init_distributed("cuda", "gloo", timeout_s=60)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = pmesh.rank_device("cuda")
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    full = torch.cat([torch.arange(4, dtype=torch.float32, device=dev) + 10 * r
                      for r in range(world)])

    def run(op):
        if op == "all_reduce":
            y = x.clone()
            dist.all_reduce(y)
            return y, full.reshape(world, 4).sum(0)
        if op == "broadcast":
            y = x.clone()
            dist.broadcast(y, 0)
            return y, full[:4]
        if op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(parts, x)
            return torch.cat(parts), full
        if op == "all_gather_into_tensor":
            y = x.new_empty(4 * world)
            dist.all_gather_into_tensor(y, x)
            return y, full
        if op == "reduce_scatter_tensor":
            y = x.new_empty(4 // world)
            dist.reduce_scatter_tensor(y, full.clone())
            return y, world * full[rank * 4 // world:(rank + 1) * 4 // world]
        # the ring shift rank r -> r + 1, as pp's stage shift would use it
        y = torch.empty_like(x)
        peer_to, peer_from = (rank + 1) % world, (rank - 1) % world
        if op == "send_recv":
            works = [dist.isend(x, peer_to), dist.irecv(y, peer_from)]
        else:
            works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer_to),
                                            dist.P2POp(dist.irecv, y, peer_from)])
        for w in works:
            w.wait(timedelta(seconds=GLOO_P2P_TIMEOUT_S))
        return y, full[peer_from * 4:(peer_from + 1) * 4]

    for op in ops:
        try:
            got, want = run(op)
            torch.cuda.synchronize(dev)
            if not torch.equal(got, want):
                raise AssertionError(f"{got.tolist()} != {want.tolist()}")
        except Exception as e:  # noqa: BLE001 - the probe's finding
            print(f"{op} refused: {type(e).__name__}: {str(e).splitlines()[-1][:100]}",
                  flush=True)
            os._exit(1)
        print(f"{op} ok", flush=True)
    dist.destroy_process_group()


def _spawn_ranks(tmp: Path, world: int, port: int, log_name: str,
                 mode=("--ranks-worker",)) -> list:
    procs = []
    for r in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), HMASR_LOG_DIR=str(tmp / "logs"),
                   PYTHONFAULTHANDLER="1")
        args = [sys.executable, str(Path(__file__).resolve()), *mode]
        if mode == ("--ranks-worker",):
            args.append(str(tmp))
        procs.append(subprocess.Popen(args, env=env, stdout=open(tmp / f"{log_name}{r}.log", "w"),
                                      stderr=subprocess.STDOUT))
    return procs


def tp_checks(res: dict, out: dict, solo_dec: dict, job: dict) -> list:
    """Phase 22's tp and ep checks on the pair's results, logged with their
    bounds."""
    checks = []
    ulp = {n: v for v, n, _ in out["ulp_fp32"]}
    bound = {n: max(RANKS_SPLIT_BOUND, min(ULP_RATIO * v, CONV1_GRAD_BOUND if n in CONV1_LEAVES
                                           else PARAM_GRAD_BOUND)) for n, v in ulp.items()}
    log(f"  rounding control, gate config fp32: one process with every weight one ulp away "
        f"against one process, max|d|/max|g| worst "
        + ", ".join(f"{v:.2e} ({n})" for v, n, _ in out["ulp_fp32"][:3])
        + f"; {sum(v > RANKS_SPLIT_BOUND for v in ulp.values())} of {len(ulp)} leaves over "
        f"{RANKS_SPLIT_BOUND:g} (each leaf's bound below: {RANKS_SPLIT_BOUND:g}, or "
        f"{ULP_RATIO:g} x the control's gap up to phase 7's); N=2 config fp32 forward, the "
        f"same rows as tp N=2: features {out['ulp_n2']['feature_gap']:.3e} of max, max|p - "
        f"p_ref| {out['ulp_n2']['p_gap']:.3e}")
    for key in ("2_0", "2_1"):
        who = f"tp=2 rank {key[-1]}"
        for label in ("fp32", "bf16"):
            t = res[key][f"tp_{label}"]
            gap, wit = t["gap"], {n: v for v, n, _ in t["witness_gap"]}
            if label == "fp32":
                # the witness's gradient within RANKS_SPLIT_BOUND of each leaf's
                # max (as DDP's split), one process's within the control's bound
                over = [(v, n) for n, v in wit.items() if v > RANKS_SPLIT_BOUND] + [
                    (v, n) for v, n, _ in gap if v > bound[n]]
                loss_ok = abs(t["stats"]["loss/total"] - t["ref_loss"]) <= 1e-5 * abs(
                    t["ref_loss"])
                ratio = sorted(((v / max(ulp[n], 1e-30), n, v) for v, n, _ in gap
                                if v > RANKS_SPLIT_BOUND), reverse=True)
                log(f"    {who} fp32: {len(ratio)} leaves over {RANKS_SPLIT_BOUND:g} of max "
                    f"against one process, the largest ratios to the control's gap: "
                    + ", ".join(f"{r:.2f} ({n}, {v:.2e})" for r, n, v in ratio[:5]))
            else:
                over = [(v, n) for n, v in wit.items() if v > (
                    CONV1_GRAD_BOUND if n in CONV1_LEAVES else PARAM_GRAD_BOUND)]
                loss_ok = t["stats"]["loss/total"] == t["witness_loss"]
            log(f"  {who} gate config {label}, one update of {RANKS_ROWS} rows (both ranks "
                f"every row): loss {t['stats']['loss/total']:.7f} vs one process "
                f"{t['ref_loss']:.7f}, witness {t['witness_loss']:.7f}; vs one process "
                f"max|d|/max|g| worst " + ", ".join(f"{v:.2e} ({n})" for v, n, _ in gap[:3])
                + "; vs the witness worst " + ", ".join(
                    f"{v:.2e} ({n})" for v, n, _ in t["witness_gap"][:3])
                + f", {t['bitwise']} of {len(gap)} leaves bitwise; over the bounds "
                + ("(the witness 1e-5, one process the control's)" if label == "fp32"
                   else "(phase 7s)") + f": {len(over)} leaves "
                f"{sorted(over, reverse=True)[:5]}; launches "
                f"{t['launches']}; micro-step {t['ms']:.1f} ms, update step "
                f"{t['apply_ms']:.1f} ms, peak above the start {t['peak'] / 1e9:.3f} GB, "
                f"params + moments {t['state_bytes'] / 1e9:.3f} GB a rank")
            checks += [(f"{who} {label} gradients", not over and loss_ok),
                       (f"{who} {label} launches", t["launches"]["ssd_fwd"] == 2 * 40
                        and t["launches"]["ssd_bwd"] == 40)]
        n2, bg = res[key]["tp_n2_fp32"], res[key]["tp_n2_fp32"]["boundaries"]
        log(f"  {who} configs/typeA_small_N2.yaml fp32, random routers, one forward of "
            f"{RANKS_ROWS} rows (7 x 10 s and a pad) vs one process: boundaries first, "
            f"{bg['differ']} of {bg['frames']} differ, max|p - p_ref| {bg['p_gap']:.3e} (bound "
            f"{BOUNDARY_CLIFF:g}); features {n2['feature_gap']:.3e} of max (bound "
            f"{RANKS_SPLIT_BOUND:g}); kept {n2['kept']:.7f} vs {n2['ref_kept']:.7f}; launches "
            f"{n2['launches']}")
        checks.append((f"{who} n2 fp32", bg["differ"] == 0 and bg["p_gap"] <= BOUNDARY_CLIFF
                       and n2["feature_gap"] <= RANKS_SPLIT_BOUND))
        n2 = res[key]["tp_n2_bf16"]
        log(f"  {who} configs/typeA_small_N2.yaml bf16, the same rows: equal to the witness "
            f"(p, b, features bitwise) {n2['witness_equal']}; " + bf16_line(n2)
            + f"; kept {n2['kept']:.7f} vs {n2['ref_kept']:.7f}; launches {n2['launches']}")
        checks.append((f"{who} n2 bf16", n2["witness_equal"] and bf16_ok(n2)))
        checks += [(f"{who} n2 {label} launches", res[key][f"tp_n2_{label}"]["launches"] == {
            "ssd_fwd": N2_SSD_CALLS, "ema_fwd": 1}) for label in ("fp32", "bf16")]
        e = res[key]["ep"]
        over = [(v, n) for v, n, _ in e["gap"] if v > EP_GRAD_BOUND]
        st, ref = e["stats"], e["ref_stats"]
        log(f"  ep=2 rank {key[-1]} MoE config fp32 (8 experts, top 2), one update vs one "
            f"process: loss {st['loss/total']:.7f} vs {ref['loss/total']:.7f}, moe/aux "
            f"{st['moe/aux']:.7f} vs {ref['moe/aux']:.7f}, moe/dropped {st['moe/dropped']:.7f} "
            f"vs {ref['moe/dropped']:.7f}; {e['bitwise']} of {len(e['gap'])} leaves bitwise, "
            f"worst " + ", ".join(f"{v:.2e} ({n})" for v, n, _ in e["gap"][:3])
            + f"; over {EP_GRAD_BOUND:g} of max: {len(over)} leaves {over[:5]}; launches "
            f"{e['launches']}; micro-step "
            f"{e['ms']:.1f} ms, peak above the start {e['peak'] / 1e9:.3f} GB, params + "
            f"moments {e['state_bytes'] / 1e9:.3f} GB a rank")
        checks.append((f"ep rank {key[-1]}", not over and st["moe/dropped"] == ref["moe/dropped"]
                       and abs(st["loss/total"] - ref["loss/total"]) <= 1e-6 * abs(
                           ref["loss/total"])
                       and abs(st["moe/aux"] - ref["moe/aux"]) <= 1e-6 * abs(ref["moe/aux"])))
    checks += [(f"tp n2 {label} ranks' boundaries equal", torch.equal(
        res["2_0"][f"tp_n2_{label}"]["b"], res["2_1"][f"tp_n2_{label}"]["b"]))
        for label in ("fp32", "bf16")]
    for cell in job["tp_cells"]:
        name = cell["name"]
        got = [json.loads(x) for x in res["2_0"]["decode_tp"][name].splitlines()]
        want = [json.loads(x) for x in solo_dec["tp_" + name].splitlines()]
        same = [(r["id"], r["hyp"]) for r in got] == [(r["id"], r["hyp"]) for r in want]
        worst = max((abs(a["score"] - b["score"]) / max(abs(b["score"]), 1e-30)
                     for a, b in zip(got, want) if b["score"] is not None), default=0.0)
        log(f"  decode.tp=2 fp32 {name}: {len(got)} utterances, transcripts equal to one "
            f"process: {same}; beam scores' worst relative gap {worst:.2e} (bound 1e-5)")
        checks.append((f"decode.tp {name}", same and worst <= 1e-5
                       and res["2_1"]["decode_tp"][name] is None))
    a = res["2_0"]["tp_alone"]
    log(f"  decode.tp=2 bf16 ctc_greedy: each of {a['n']} utterances alone == batched: "
        f"{a['same']}")
    checks.append(("decode.tp alone == batched", a["same"] and res["2_1"]["tp_alone"]["same"]))
    return checks


def phase_ranks(cmvn) -> dict:
    """Phase 22, the multi-rank planes (module docstring). Every process
    starts at once on the one card: a pair of processes per gloo probe, two
    ranks under gloo (DDP, FSDP where gloo takes its collectives, sp = 2,
    decoding over ranks), one rank under NCCL (DDP and FSDP at world size 1)
    and tools/smoke_2proc.py (two processes, gloo, the tone corpus at d 32);
    the one-process references run here meanwhile, and the ranks wait for
    their files."""
    import pickle
    import shutil
    import socket

    from hnet_mamba_asr_torch.data.dataset import ItemLoader
    from hnet_mamba_asr_torch.parallel.mesh import fsdp_plan
    from hnet_mamba_asr_torch.parallel.model_parallel import Plane, place_model
    from hnet_mamba_asr_torch.parallel.pipeline import PPModel
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tasks.decode_task import decode_split, expand_cells
    from hnet_mamba_asr_torch.tools.gate import seeded_tokenizer
    from hnet_mamba_asr_torch.training.trainer import DEVICE_KEYS
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    rng = np.random.default_rng(SEED + 22)
    cfgs = ranks_configs()
    job = {"batch": ranks_batch(rng, 10.0, RANKS_ROWS, RANKS_ROWS - 1),
           "updates": [ranks_batch(rng, 10.0, RANKS_ROWS, RANKS_ROWS - 1, RANKS_ROWS * k)
                       for k in (1, 2)],
           "sp_batch": ranks_batch(rng, SP_SECONDS, 2, 2),
           "decode_items": decode_batch_items(np.random.default_rng(SEED + 13), 8),
           "decode_cfg": {"beam_size": 4},
           "cells": [c for c in expand_cells({"read_outs": ["ctc", "aed"],
                                              "search": ["greedy", "beam"], "lm": "none"})
                     if c["name"] in RANKS_CELLS],
           "tp_cells": [c for c in expand_cells({"read_outs": ["ctc", "joint"],
                                                 "search": ["greedy", "beam"], "lm": "none"})
                        if c["name"] in TP_CELLS]}
    (tmp / "job.pkl").write_bytes(pickle.dumps(job))
    secs, out = {}, {}

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    t_spawn = time.time()
    probe = (_spawn_ranks(tmp, 2, free_port(), "probe", ("--gloo-probe",))
             + _spawn_ranks(tmp, 2, free_port(), "probe_p2p", ("--gloo-probe", "p2p")))
    pair = _spawn_ranks(tmp, 2, free_port(), "pair")
    single = _spawn_ranks(tmp, 1, free_port(), "single")
    smoke = subprocess.Popen(
        [sys.executable, "-m", "hnet_mamba_asr_torch.tools.smoke_2proc", "--device", "cuda",
         "--backend", "gloo", "--root", str(tmp / "smoke2p"), "--timeout", "300"],
        cwd=Path(__file__).resolve().parent, stdout=open(tmp / "smoke2p.log", "w"),
        stderr=subprocess.STDOUT)
    everyone = probe + pair + single + [smoke]
    gloo = {}

    def publish_probe():
        """gloo.json for the ranks as soon as the probe ends: each op's
        verdict from its log ("not probed" after a refusal; a probe still
        running after 120 s is stopped)."""
        for p in probe:
            try:
                p.wait(120)
            except subprocess.TimeoutExpired:
                p.kill()
        # a refusal from either rank (the other may have crashed on it)
        lines = [ln for name in ("probe", "probe_p2p") for r in range(2)
                 for ln in (tmp / f"{name}{r}.log").read_text().splitlines()]
        for op in GLOO_CUDA_OPS + GLOO_P2P_OPS:
            said = [ln.split(" ", 1)[1] for ln in lines if ln.startswith(op + " ")]
            gloo[op] = next((v for v in said if v != "ok"), said[0] if said else "not probed")
        out["probe_codes"] = [p.returncode for p in probe]
        (tmp / "gloo.json.tmp").write_text(json.dumps(gloo))
        os.replace(tmp / "gloo.json.tmp", tmp / "gloo.json")
        secs["gloo_probes"] = time.perf_counter() - t0

    try:
        def on_card(batch):
            return dict(batch, **{k: torch.as_tensor(batch[k]).cuda() for k in DEVICE_KEYS})

        t0 = time.perf_counter()
        waiter = threading.Thread(target=publish_probe, daemon=True)
        waiter.start()
        bases = {}
        for label in ("fp32", "bf16"):
            model = bases[label] = build_model(cfgs[label], VOCAB, cmvn=cmvn, seed=SEED).train()
            _save_atomic(model, tmp / f"base_{label}.pt")        # the ranks' copy
            loss, _ = model.loss_fn(on_card(job["batch"]), 0, True)
            loss.backward()
            whole = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
            split = split_grads(model, job["batch"], 2, on_card)   # zeroes the gradients
            out[f"witness_{label}"] = _grad_gap(split, whole)
            _save_atomic({"loss": loss.item(), "grads": whole, "split": split},
                         tmp / f"ref_{label}.pt")
            del whole, split                       # the weights are untouched: a base
            if label == "fp32":               # FSDP over 2 ranks, by its plan
                plan = fsdp_plan(model, 2)
                out["fsdp2_bytes"] = 12 * sum(p.numel() // (2 if plan[n] is not None else 1)
                                              for n, p in model.named_parameters())
            del loss
        model = build_model(cfgs["sp"], VOCAB, cmvn=cmvn, seed=SEED).train()
        draw_routers(model, SEED + 23)
        _save_atomic(model, tmp / "base_sp.pt")
        b = on_card(job["sp_batch"])
        with torch.no_grad():
            enc = model.encode(b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss, stats = model.loss_fn(b, 0, False)
        loss.backward()
        ev[1].record()
        ev[1].synchronize()
        out["sp_offline"] = {"ms": ev[0].elapsed_time(ev[1]),
                             "peak": torch.cuda.max_memory_allocated() - before}
        _save_atomic(dict(encoded(enc), lengths=enc.lengths.cpu(), ratio=float(enc.ratio_loss),
                          loss=loss.item(), grads={n: p.grad.detach().cpu()
                                                   for n, p in model.named_parameters()}),
                     tmp / "ref_sp.pt")
        del enc, loss
        with torch.no_grad():                      # tp N=2's fp32 reference
            enc = model.eval().encode(on_card(job["batch"]))
            ref32 = dict(encoded(enc), lengths=enc.lengths.cpu())
            _save_atomic(ref32, tmp / "ref_tpn2_fp32.pt")
            twin = encoded(ulp_twin(model, SEED + 25).encode(on_card(job["batch"])))
        out["ulp_n2"] = {"p_gap": boundary_gap(twin["p"], twin["b"], ref32["p"], ref32["b"],
                                               ref32["lengths"])["p_gap"],
                         "feature_gap": row_feature_gap(twin["features"], ref32["features"],
                                                        ref32["lengths"],
                                                        [True] * len(ref32["lengths"]))}
        del model, enc, twin, ref32
        model = build_model(cfgs["sp_bf16"], VOCAB, cmvn=cmvn, seed=SEED).eval()
        draw_routers(model, SEED + 23)
        _save_atomic(model, tmp / "base_sp_bf16.pt")
        for rows, name in ((b, "ref_sp16"), (on_card(job["batch"]), "ref_tpn2_bf16")):
            with torch.no_grad():
                enc = model.encode(rows)
            _save_atomic(dict(encoded(enc), lengths=enc.lengths.cpu()), tmp / f"{name}.pt")
        place_model(model, Plane("tp", 2))         # tp N=2's bf16 witness
        with torch.no_grad():
            enc = model.encode(on_card(job["batch"]))
        _save_atomic(encoded(enc), tmp / "ref_tpn2_witness.pt")
        del model, enc
        # tp's witnesses: a virtual plane computes both shards in turn here
        for label in ("fp32", "bf16"):
            model = torch.load(tmp / f"base_{label}.pt", map_location="cuda",
                               weights_only=False).train()
            place_model(model, Plane("tp", 2))
            loss, _ = model.loss_fn(on_card(job["batch"]), 0, True)
            loss.backward()
            _save_atomic({"loss": loss.item(), "grads": {n: p.grad.detach().cpu() for n, p in
                                                         model.named_parameters()}},
                         tmp / f"ref_tpw_{label}.pt")
            del model, loss
        # pp's witnesses: both stages in turn here, on the same microbatches
        for label in ("fp32", "bf16"):
            pm = PPModel(torch.load(tmp / f"base_{label}.pt", map_location="cuda",
                                    weights_only=False).train(), pp=2,
                         microbatches=PP_MICROBATCHES)
            loss, _ = pm.loss_fn(on_card(job["batch"]), 0, True)
            loss.backward()
            with torch.no_grad():
                feats = pm.encode(on_card(job["batch"]), True).features.float().cpu()
            _save_atomic({"loss": loss.item(), "features": feats,
                          "grads": {n: p.grad.detach().cpu() for n, p in
                                    pm.model.named_parameters()}}, tmp / f"ref_ppw_{label}.pt")
            del pm, loss
        model = build_model(cfgs["moe"], VOCAB, cmvn=cmvn, seed=SEED).train()
        _save_atomic(model, tmp / "base_moe.pt")
        loss, st = model.loss_fn(on_card(job["batch"]), 0, True)
        loss.backward()
        _save_atomic({"stats": {k: float(st[k]) for k in ("loss/total", "moe/aux", "moe/dropped")},
                      "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()}},
                     tmp / "ref_moe.pt")
        del model, loss
        dec_model = build_model(cfgs["dec"], VOCAB, cmvn=cmvn, seed=SEED)
        _save_atomic(dec_model, tmp / "base_dec.pt")
        secs["references"] = time.perf_counter() - t0
        # the rounding control of tp's fp32 gradients: one process, every
        # weight one ulp away
        model = ulp_twin(bases["fp32"], SEED + 24)
        loss, _ = model.loss_fn(on_card(job["batch"]), 0, True)
        loss.backward()
        out["ulp_fp32"] = _grad_gap({n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                                    torch.load(tmp / "ref_fp32.pt")["grads"])
        del model, loss
        model = ulp_twin(bases["bf16"], SEED + 26)          # and of pp's bf16 gradients
        loss, _ = model.loss_fn(on_card(job["batch"]), 0, True)
        loss.backward()
        out["ulp_bf16"] = _grad_gap({n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                                    torch.load(tmp / "ref_bf16.pt")["grads"])
        del model, loss
        # pp's two updates: the witness's, from the untouched base
        pp_refs = {}
        wit = unsaved_trainer(PPModel(torch.load(tmp / "base_fp32.pt", map_location="cuda",
                                                 weights_only=False), pp=2,
                                      microbatches=PP_MICROBATCHES),
                              job["updates"], RANKS_TRAIN, ckpt_dir=tmp / "ppw", seed=SEED)
        wit.train()
        pp_refs["witness"] = {k: v.detach().cpu() for k, v in wit.model.state_dict().items()}
        pp_refs["witness_loss"] = [h["loss/total"] for h in wit.history]
        del wit
        waiter.join()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        solo = unsaved_trainer(bases.pop("fp32"), job["updates"], RANKS_TRAIN,
                               ckpt_dir=tmp / "solo", seed=SEED)
        solo.train()
        out["solo"] = {"ms": [h["ms"] for h in solo.history],
                       "peak": torch.cuda.max_memory_allocated()}
        pp_refs["solo"] = {k: v.detach().cpu() for k, v in solo.model.state_dict().items()}
        del solo
        # the rounding control of two updates: one process from weights one
        # ulp away
        ctrl = unsaved_trainer(ulp_twin(torch.load(tmp / "base_fp32.pt", map_location="cuda",
                                                   weights_only=False), SEED + 27),
                               job["updates"], RANKS_TRAIN, ckpt_dir=tmp / "ppc", seed=SEED)
        ctrl.train()
        pp_refs["control"] = {k: v.detach().cpu() for k, v in ctrl.model.state_dict().items()}
        del ctrl
        # train.scan_steps: the two global batches as one group of 2
        # updates (one host read) against 2 single updates, bf16 (whose
        # gradients repeat bitwise)
        scans = {}
        for K in (1, 2):
            tr = unsaved_trainer(torch.load(tmp / "base_bf16.pt", map_location="cuda",
                                            weights_only=False), job["updates"],
                                 dict(RANKS_TRAIN, scan_steps=K), ckpt_dir=tmp / f"scan{K}",
                                 seed=SEED)
            with syncs_per_read() as (syncs, sites):
                tr.train()
            scans[K] = {"params": {k: v.detach().cpu() for k, v in tr.model.state_dict().items()},
                        "reads": tr.host_reads, "groups": [h["group"] for h in tr.history],
                        "ms": [h["ms"] for h in tr.history], "syncs": syncs, "sites": sites}
            del tr
        out["scan"] = {K: {k: v for k, v in r.items() if k != "params"} for K, r in scans.items()}
        out["scan"]["bitwise"] = all(torch.equal(v, scans[1]["params"][k])
                                     for k, v in scans[2]["params"].items())
        del scans
        tok = seeded_tokenizer(tmp / "tok.json")
        model = decode_model(bases.pop("bf16"))
        solo_dec = {}
        for cell in job["cells"]:
            loader = ItemLoader(job["decode_items"], 32000, pad_id=tok.pad_id, shuffle=False)
            where = tmp / f"solo_{cell['name']}.jsonl"
            decode_split(model, tok, loader, cell, job["decode_cfg"], audio_seconds={},
                         out_path=where)
            solo_dec[cell["name"]] = where.read_text()
        del model
        model = decode_model(dec_model)
        for cell in job["tp_cells"]:                   # decode.tp's reference
            loader = ItemLoader(job["decode_items"], 32000, pad_id=tok.pad_id, shuffle=False)
            where = tmp / f"solo_tp_{cell['name']}.jsonl"
            decode_split(model, tok, loader, cell, job["decode_cfg"], audio_seconds={},
                         out_path=where)
            solo_dec["tp_" + cell["name"]] = where.read_text()
        del model, dec_model
        torch.cuda.empty_cache()
        secs["one_process"] = time.perf_counter() - t0
        codes = {}
        for name, procs in (("pair", pair), ("single", single), ("smoke_2proc", [smoke])):
            codes[name] = [p.wait(600) for p in procs]
            secs[name] = time.perf_counter() - t0
    finally:
        for p in everyone:                      # stop every process it started
            if p.poll() is None:
                p.kill()
    if any(c != [0] * len(c) for c in codes.values()):
        for f in sorted(tmp.glob("*.log")):
            log(f"  ----- {f.name} -----\n" + f.read_text()[-3000:])
        raise AssertionError(f"phase 22 processes exited {codes}")
    res = {k: pickle.loads((tmp / f"out{k}.pkl").read_bytes())
           for k in ("2_0", "2_1", "1_0")}
    pp_refs["pp"] = torch.load(tmp / "pp_updates.pt")
    smoke_line = [ln for ln in (tmp / "smoke2p.log").read_text().splitlines()
                  if "ALL CHECKS PASSED" in ln]
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"  gloo on CUDA tensors (torch {torch.__version__}): " + ", ".join(
        f"{k} {v}" for k, v in gloo.items()) + f"; the probe pair exited {out['probe_codes']}")
    checks = []
    for key, who in (("2_0", "DDP 2 ranks gloo"), ("1_0", "DDP 1 rank NCCL")):
        r = res[key]
        for label in ("fp32", "bf16")[:2 if key == "2_0" else 1]:
            g = r[f"grad_{label}"]
            gap = g["gap"]
            over = [(v, n) for v, n, _ in gap if v > (CONV1_GRAD_BOUND if n.endswith(
                RANKS_SUM_LEAVES) else RANKS_GRAD_BOUND)]
            log(f"  {who} vs one process, gate config {label}, one micro-step of {RANKS_ROWS} "
                f"rows (7 x 10 s + a pad, SpecAugment and dropout on): loss {g['loss']:.7f} vs "
                f"{g['ref_loss']:.7f}; {len(gap)} leaves, max|d|/max|g| worst "
                + ", ".join(f"{v:.2e} ({n})" for v, n, _ in gap[:3])
                + f"; mean|d|/mean|g| worst {max(m for _, _, m in gap):.2e}"
                + ("" if label == "bf16" else f"; over the bounds: {over}"))
            ok = abs(g["loss"] - g["ref_loss"]) <= 1e-6 * abs(g["ref_loss"]) and all(
                math.isfinite(v) for v, _, _ in gap)
            checks.append((f"{who} {label} gradients", ok and (label == "bf16" or not over)))
            if g["split_gap"] is not None:
                wit, sg = out[f"witness_{label}"], g["split_gap"]
                split_over = [(v, n) for v, n, _ in sg if v > (
                    RANKS_SPLIT_BOUND if label == "fp32" else
                    CONV1_GRAD_BOUND if n in CONV1_LEAVES else PARAM_GRAD_BOUND)]
                log(f"    witness (one process, the same 2 row slices, global sums) vs the "
                    f"whole batch, {label}: max|d|/max|g| worst "
                    + ", ".join(f"{v:.2e} ({n})" for v, n, _ in wit[:3])
                    + f"; {who} vs the witness: worst "
                    + ", ".join(f"{v:.2e} ({n})" for v, n, _ in sg[:3])
                    + f"; over the bounds: {split_over}")
                checks.append((f"{who} {label} gradients vs the split witness", not split_over))
        log(f"  {who}: params + moments per rank {r['ddp']['state_bytes'] / 1e9:.3f} GB, "
            f"max_memory_allocated {r['ddp']['peak'] / 1e9:.2f} GB, update ms "
            f"{[round(m, 1) for m in r['ddp']['ms']]} (one shared card; one process "
            f"{[round(m, 1) for m in out['solo']['ms']]}, {out['solo']['peak'] / 1e9:.2f} GB)")
        if not r["fsdp_ran"]:
            log(f"  {who}: FSDP not run (gloo refuses reduce_scatter_tensor on CUDA tensors; "
                f"over 2 ranks its plan would hold {out['fsdp2_bytes'] / 1e9:.3f} GB of params "
                f"+ moments per rank)")
            continue
        log(f"  {who}: FSDP vs DDP after 2 updates, max(|d| - rtol|p|) {r['fsdp_vs_ddp']:.3e} "
            f"(atol {FSDP_ATOL:g}); params + moments per rank {r['fsdp']['state_bytes'] / 1e9:.3f}"
            f" GB ({r['fsdp']['sharded']} sharded leaves), max_memory_allocated "
            f"{r['fsdp']['peak'] / 1e9:.2f} GB, update ms "
            f"{[round(m, 1) for m in r['fsdp']['ms']]} (one shared card)")
        checks.append((f"{who} FSDP vs DDP", r["fsdp_vs_ddp"] <= FSDP_ATOL))
    checks.append(("ranks bitwise equal", res["2_0"]["ddp_tree_digest"]
                   == res["2_1"]["ddp_tree_digest"]))
    for key in ("2_0", "2_1"):
        s = res[key]["sp"]
        gap, bg = s["grad_gap"], s["boundaries"]
        log(f"  sp=2 rank {key[-1]} vs offline, configs/typeA_small_N2.yaml fp32, 2 x "
            f"{SP_SECONDS:g} s: boundaries first, {bg['differ']} of {bg['frames']} differ, "
            f"max|p - p_ref| {bg['p_gap']:.3e} (bound {BOUNDARY_CLIFF:g}); features "
            f"{s['feature_gap']:.2e} of max, ratio "
            f"{s['ratio']:.7f} vs {s['ref_ratio']:.7f}, kept {s['kept']:.7f} vs "
            f"{s['ref_kept']:.7f}, loss {s['loss']:.6f} vs {s['ref_loss']:.6f}, gradients worst "
            + ", ".join(f"{v:.2e} ({n})" for v, n, _ in gap[:3])
            + f"; launches {s['launches']}; update {s['ms']:.1f} ms, peak above the "
            f"update's start {s['peak'] / 1e9:.3f} GB (offline {out['sp_offline']['ms']:.1f} ms, "
            f"{out['sp_offline']['peak'] / 1e9:.3f} GB)")
        checks += [
            (f"sp rank {key} boundaries", bg["differ"] == 0 and bg["p_gap"] <= BOUNDARY_CLIFF),
            (f"sp rank {key} features", s["feature_gap"] <= SP_FEATURE_BOUND),
            (f"sp rank {key} ratio and kept", abs(s["ratio"] - s["ref_ratio"]) <= SP_SCALAR_BOUND
             and abs(s["kept"] - s["ref_kept"]) <= SP_SCALAR_BOUND),
            (f"sp rank {key} loss", abs(s["loss"] - s["ref_loss"])
             <= SP_LOSS_RTOL * abs(s["ref_loss"])),
            (f"sp rank {key} gradients", gap[0][0] <= SP_GRAD_RTOL),
            (f"sp rank {key} launches", s["launches"] == {
                "ssd_fwd": 2 * N2_SSD_CALLS, "ssd_bwd": N2_SSD_CALLS, "ema_fwd": 1,
                "ema_bwd": 1})]
    s16 = res["2_0"]["sp_bf16"]
    log(f"  sp=2 in the config's bf16 (encoder only), the same rows: " + bf16_line(s16)
        + f"; features to one process in bf16 on every row {s16['all_rows_gap']:.3e} of max "
        f"(recorded: a flip moves every later slot); kept {s16['kept']:.7f} vs "
        f"{s16['ref_kept']:.7f}")
    checks.append(("sp bf16 as close to fp32 as one process", bf16_ok(s16)))
    checks += tp_checks(res, out, solo_dec, job)
    checks += pp_checks(res, out, pp_refs)
    sc = out["scan"]
    log(f"  train.scan_steps=2, gate config bf16, one process, the two global batches of "
        f"{RANKS_ROWS} rows: {len(sc[2]['groups'])} updates in {sc[2]['reads']} host read(s) "
        f"(updates a read {sc[2]['groups']}; scan_steps=1: {sc[1]['reads']} reads), parameters "
        f"bitwise those of scan_steps=1: {sc['bitwise']}; update ms {[round(m, 1) for m in sc[2]['ms']]}"
        f" (scan_steps=1: {[round(m, 1) for m in sc[1]['ms']]}); synchronizing CUDA calls a "
        f"read (from the run's start) {sc[2]['syncs']} (scan_steps=1: {sc[1]['syncs']}; their "
        f"Python call sites: " + ", ".join(f"{k} x{v}" for k, v in sorted(
            sc[1]["sites"].items(), key=lambda kv: -kv[1])) + ")")
    checks.append(("scan_steps=2 one read for the group of 2, bitwise",
                   sc["bitwise"] and sc[2]["reads"] == 1 and sc[2]["groups"] == [2, 2]
                   and sc[1]["reads"] == 2 and one_read_a_group(sc[1]["syncs"], sc[2]["syncs"], 2)))
    for cell in job["cells"]:
        name = cell["name"]
        got = [json.loads(x) for x in res["2_0"]["decode"][name].splitlines()]
        want = [json.loads(x) for x in solo_dec[name].splitlines()]
        # the records' transcripts and the beam's scores, equal: the token ids
        # are not in the records, and a transcript may spell two id sequences
        same = ([(r["id"], r["hyp"], r["score"]) for r in got]
                == [(r["id"], r["hyp"], r["score"]) for r in want])
        log(f"  decode over 2 ranks, {name}: {len(got)} utterances, transcripts and scores "
            f"({'none: greedy' if got and got[0]['score'] is None else 'the beam'}'s) equal "
            f"to one process: {same}")
        checks.append((f"decode {name}", same and res["2_1"]["decode"][name] is None))
    checks.append(("smoke_2proc", bool(smoke_line)))
    log("  " + (smoke_line[0] if smoke_line else "smoke_2proc printed no result"))
    for key, r in res.items():
        log(f"  rank {key[-1]} of {key[0]}, seconds after the spawn: " + ", ".join(
            f"{name} {t - t_spawn:.1f}" for name, t in r["stages"]))
    phase_s = time.perf_counter() - t_phase
    log(f"  ranks phase: {phase_s:.1f} s (budget {RANKS_BUDGET_S:.0f} s); seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    failed = [name for name, ok in checks if not ok]
    if failed:
        raise AssertionError(f"phase 22 checks failed: {failed}")
    log("phase 22 ranks: ok")
    return {"seconds": phase_s, "launches": {
                "sp_update_rank0": res["2_0"]["sp"]["launches"],
                "tp_update_rank0": res["2_0"]["tp_bf16"]["launches"],
                "tp_n2_forward_rank0": res["2_0"]["tp_n2_bf16"]["launches"],
                "ep_update_rank0": res["2_0"]["ep"]["launches"],
                "pp_update_stage0": res["2_0"]["pp_bf16"]["launches"],
                "pp_update_stage1": res["2_1"]["pp_bf16"]["launches"],
                "pp_n2_forward_stage0": res["2_0"]["pp_n2_bf16"]["launches"]},
            "results": res, "solo": out, "gloo_cuda": gloo}


def pp_checks(res: dict, out: dict, refs: dict) -> list:
    """Phase 22's pp checks on the pair's results, logged with their bounds."""
    checks = []
    ulp = {label: {n: v for v, n, _ in out[f"ulp_{label}"]} for label in ("fp32", "bf16")}
    bound = {n: max(RANKS_SPLIT_BOUND, min(ULP_RATIO * v, CONV1_GRAD_BOUND if n in CONV1_LEAVES
                                           else PARAM_GRAD_BOUND)) for n, v in ulp["fp32"].items()}
    log(f"  rounding control, gate config bf16: one process with every weight one ulp away "
        f"against one process, max|d|/max|g| worst "
        + ", ".join(f"{v:.2e} ({n})" for v, n, _ in out["ulp_bf16"][:3]))
    for key in ("2_0", "2_1"):
        who = f"pp=2 stage {key[-1]}"
        for label in ("fp32", "bf16"):
            t = res[key][f"pp_{label}"]
            apart = sorted(((v, n) for v, n, _ in t["witness_gap"] if v > 0), reverse=True)
            over = [(v, n) for v, n in apart if v > ulp[label][n]]
            ok = (not over and t["features_equal"]
                  and t["stats"]["loss/total"] == t["witness_loss"])
            line = (f"  {who} gate config {label}, one micro-step of {RANKS_ROWS} rows in "
                    f"{PP_MICROBATCHES} microbatches: loss {t['stats']['loss/total']:.7f}, the "
                    f"witness {t['witness_loss']:.7f}, one process {t['ref_loss']:.7f}; "
                    f"features equal to the witness {t['features_equal']}; {t['bitwise']} of "
                    f"{t['leaves']} leaves bitwise, the others (within the {label} ulp "
                    f"control's gap?) " + ", ".join(
                        f"{n} {v:.2e} (control {ulp[label][n]:.2e})" for v, n in apart[:6])
                    + f"; over: {over[:5]}")
            if label == "fp32":
                plain = [(v, n) for v, n, _ in t["gap"] if v > bound[n]]
                ok = ok and not plain and abs(t["stats"]["loss/total"] - t["ref_loss"]) <= (
                    1e-5 * abs(t["ref_loss"]))
                line += (f"; vs one process worst " + ", ".join(
                    f"{v:.2e} ({n})" for v, n, _ in t["gap"][:3])
                    + f", over the bounds (1e-5 or {ULP_RATIO:g} x the control's, up to "
                    f"phase 7's): {plain[:5]}")
            log(line + f"; launches {t['launches']}; micro-step {t['ms']:.1f} ms, update step "
                f"{t['apply_ms']:.1f} ms, peak above the start {t['peak'] / 1e9:.3f} GB, "
                f"params + moments {t['state_bytes'] / 1e9:.3f} GB a rank")
            checks += [(f"{who} {label} gradients", ok),
                       (f"{who} {label} launches", t["launches"] == {
                           "ssd_fwd": 2 * PP_SSD_PER_PASS, "ssd_bwd": PP_SSD_PER_PASS,
                           "ema_fwd": 0, "ema_bwd": 0})]
        n2, bg = res[key]["pp_n2_fp32"], res[key]["pp_n2_fp32"]["boundaries"]
        log(f"  {who} configs/typeA_small_N2.yaml fp32, random routers, one forward of "
            f"{RANKS_ROWS} rows vs one process: boundaries first, {bg['differ']} of "
            f"{bg['frames']} differ, max|p - p_ref| {bg['p_gap']:.3e} (bound "
            f"{BOUNDARY_CLIFF:g}); features {n2['feature_gap']:.3e} of max (bound "
            f"{RANKS_SPLIT_BOUND:g}); kept {n2['kept']:.7f} vs {n2['ref_kept']:.7f}; launches "
            f"{n2['launches']}")
        checks.append((f"{who} n2 fp32", bg["differ"] == 0 and bg["p_gap"] <= BOUNDARY_CLIFF
                       and n2["feature_gap"] <= RANKS_SPLIT_BOUND))
        n2 = res[key]["pp_n2_bf16"]
        log(f"  {who} configs/typeA_small_N2.yaml bf16, the same rows: " + bf16_line(n2)
            + f"; kept {n2['kept']:.7f} vs {n2['ref_kept']:.7f}; launches {n2['launches']}")
        checks.append((f"{who} n2 bf16", bf16_ok(n2)))
        checks += [(f"{who} n2 {label} launches", res[key][f"pp_n2_{label}"]["launches"] == {
            "ssd_fwd": PP_SSD_PER_PASS, "ema_fwd": 1}) for label in ("fp32", "bf16")]
    checks += [(f"pp n2 {label} stages' boundaries equal", torch.equal(
        res["2_0"][f"pp_n2_{label}"]["b"], res["2_1"][f"pp_n2_{label}"]["b"]))
        for label in ("fp32", "bf16")]
    # two Trainer updates: each leaf's max|p - p_ref| against the witness's
    # (bitwise, or within the control's) and one process's (within
    # ULP_RATIO times the control's), the control being one process's two
    # updates from weights one ulp away: its gap to one process is the
    # rounding scale of two updates (a leaf near 1 that moves by ~1e-6
    # keeps few bits of its change; a key bias's gradient is rounding noise)
    upd, ctrl, solo = refs["pp"], refs["control"], refs["solo"]
    rows, bitwise, over = [], 0, []
    for n in ulp["fp32"]:
        scale = (ctrl[n].float() - solo[n].float()).abs().max().item()
        gaps = [(upd[n].float() - refs[k][n].float()).abs().max().item() / max(scale, 1e-30)
                for k in ("witness", "solo")]
        bitwise += torch.equal(upd[n], refs["witness"][n])
        rows.append((*gaps, n))
        if gaps[0] > 1 or gaps[1] > ULP_RATIO:
            over.append((n, *gaps))
    u = res["2_0"]["pp_updates"]
    log(f"  pp=2 two Trainer updates of the gate config fp32 ({u['steps']} steps, "
        f"{u['host_reads']} host reads): losses {[round(x, 7) for x in u['loss']]}, the witness "
        f"{[round(x, 7) for x in refs['witness_loss']]}; gathered parameters: {bitwise} of "
        f"{len(rows)} bitwise equal to the witness's; max|p - p_ref| over the control's "
        f"max|p_ulp - p_one| vs the witness worst "
        + ", ".join(f"{g:.3f} ({n})" for g, _, n in sorted(rows, reverse=True)[:3])
        + f" (bound 1), vs one process worst " + ", ".join(
            f"{g:.3f} ({n})" for _, g, n in sorted(rows, key=lambda r: -r[1])[:3])
        + f" (bound {ULP_RATIO:g}); over: {over[:5]}; update ms stage 0 "
        f"{[round(m, 1) for m in u['ms']]}, stage 1 "
        f"{[round(m, 1) for m in res['2_1']['pp_updates']['ms']]}")
    checks.append(("pp two updates", not over and u["steps"] == 2))
    return checks


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    if os.environ.get("CHIP_SMOKE_LOG"):         # the whole log, as well as stdout
        path = Path(os.environ["CHIP_SMOKE_LOG"])
        path.parent.mkdir(parents=True, exist_ok=True)
        LOG_FILE.append(open(path, "w"))
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t_start = time.perf_counter()

    def run(fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log(f"  ({fn.__name__}: {time.perf_counter() - t0:.1f} s)")
        return out

    run(phase_build)
    fwd_rows = run(phase_kernel)
    bwd_rows = run(phase_backward)
    ema_rows = run(phase_ema)
    rnnt_rows = run(phase_rnnt_kernel)
    cmvn = make_cmvn("cuda")
    run(phase_model, cmvn)
    run(phase_hnet_model, cmvn)
    run(phase_serve, cmvn)
    run(phase_serve, cmvn, N2_CONFIG, "n2", ema_per_call=1)
    modes = run(phase_serve_modes, cmvn)
    rnnt_serve = run(phase_rnnt_serve, cmvn)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        train = run(phase_train, cmvn, Path(tmp))
        train_n2 = run(phase_train_n2, cmvn, Path(tmp))
        train_rnnt = run(phase_train_config, cmvn, Path(tmp))
        run(phase_descent, cmvn, Path(tmp))
        run(phase_grads, cmvn)
        run(phase_grads, cmvn, N2_CONFIG, "n2")
        rnnt_grads = run(phase_rnnt_grads, cmvn)
        bench = run(phase_bench, Path(tmp))
        intra = run(phase_intra_blocks, cmvn)
        gate = run(phase_gate_proof, Path(tmp))
        matrix, tone_lm = run(phase_tone_matrix, Path(tmp))
        rnnt_gate = run(phase_rnnt_gate, Path(tmp), tone_lm)
        n2 = run(phase_n2_stability, Path(tmp))
        full = run(phase_decode_full, cmvn, Path(tmp))
        rnnt_full = run(phase_rnnt_decode_full, cmvn, Path(tmp))
        moe = run(phase_moe, cmvn, Path(tmp))
        run(phase_decode_parity, cmvn, Path(tmp))
    stream = run(phase_stream, cmvn)
    artifacts = run(phase_artifacts, cmvn)
    train_cli = run(phase_train_clis)
    interp = run(phase_interp, cmvn)
    ranks = run(phase_ranks, cmvn)
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
        f"updates; full-width (depth-cut) RTF device / lockstep "
        + ", ".join(f"{k} {v['rtf']:.4f} / {full['engines']['lockstep']['cells'][k]['rtf']:.4f}"
                    for k, v in full["engines"]["device"]["cells"].items())
        + f"; engines differ {sum(a['differ'] for a in full['agree'].values())} times "
        f"({sum(a['ties'] for a in full['agree'].values())} ties); served beam_ids + aed_ids "
        f"{modes['batch_ms']:.1f} ms for 8 requests; {time.perf_counter() - t_start:.1f} s "
        f"in all")
    log(f"rnnt and moe summary: RNN-T config ({train_rnnt['n_params']:,} parameters) "
        f"{train_rnnt['step_ms']:.1f} ms per update of 2 x 32 x 10 s, {train_rnnt['fps']:.0f} "
        f"mel-frames/s, peak {train_rnnt['peak'] / 1e9:.2f} GB, a micro-step's device "
        f"{train_rnnt['step']['device_ms']:.2f} ms (on the joint's lattice: "
        + ", ".join(f"{k} {v:.3f}" for k, v in train_rnnt["step"]["classes_ms"].items())
        + f" ms); MoE config "
        f"({moe['train']['n_params']:,}) {moe['train']['step_ms']:.1f} ms, peak "
        f"{moe['train']['peak'] / 1e9:.2f} GB; served rnnt_ids + rnnt_beam_ids "
        f"{rnnt_serve['batch_ms']:.1f} ms for 8 requests; RNN-T RTF device / serial "
        + ", ".join(f"{k} {v['rtf']:.4f} / {rnnt_full['engines']['lockstep'][k]['rtf']:.4f}"
                    for k, v in rnnt_full["engines"]["device"].items())
        + f"; RNN-T tone gate dev WER {rnnt_gate['dev_wer']}, test-clean "
        f"{rnnt_gate['wer']:.3f}; MoE AED dropped {moe['aed_dropped']:.4f}, RTF "
        + ", ".join(f"{k} {v:.4f}" for k, v in moe["rtf"].items()))
    log(f"stream summary: causal gate config streamed == offline (max|d feature| "
        f"{stream['n1']['max_abs']:.3e}), N=2 {stream['n2']['max_abs']:.3e}; carried ema_fwd "
        + ", ".join(f"B{r['B']} M{r['M']} D{r['D']} {r['ms']:.4f} ms ({r['clock']}; bound "
                    f"{r['bound_ms'] * 1e3:.2f} us, share {r['bound_ms'] / r['ms']:.2%}, plain "
                    f"{r['plain_ms']:.4f} ms)" for r in stream["ema"])
        + "; launches " + json.dumps(stream["launches"]))
    log(f"artifacts summary: params.npz fp32 {artifacts['sizes'][None]:,} B, int8 "
        f"{artifacts['sizes']['int8']:,} B; load {artifacts['load_s']['fp32']:.2f} / "
        f"{artifacts['load_s']['int8']:.2f} s; served call (8 requests, 4 emit modes) "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in artifacts["call_ms"].items())
        + f"; int8 vs fp32 log-prob max|d| {artifacts['gap']:.4e}, frame ids equal "
        f"{artifacts['frame_agree']:.4%}; phase {artifacts['seconds']:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s in all")
    log(f"interp summary: tone gate word-id probe "
        f"{interp['gate']['probe_frames']['word_id_accuracy']:.4f}, run_interp at full width "
        + ", ".join(f"{m} {v['seconds']['total']:.2f} s ({v['passes']} passes)"
                    for m, v in interp["full"].items())
        + f"; probe fit vs scipy max|d p| {interp['probe_check']['max_abs']:.3e} (k 50), "
        f"{interp['probe_binary']['max_abs']:.3e} (k 2); n {PROBE_TIMED[0]:,} k "
        f"{PROBE_TIMED[2]} fit {interp['probe_timed']['seconds']:.2f} s, "
        f"{interp['probe_timed']['n_iter']} iterations; phase {interp['seconds']:.1f} s; "
        f"{time.perf_counter() - t_start:.1f} s in all")
    sp = ranks["results"]["2_0"]["sp"]
    log(f"ranks summary: gloo on CUDA "
        + ", ".join(f"{k} {v if v in ('ok', 'not probed') else 'refused'}"
                    for k, v in ranks["gloo_cuda"].items())
        + f"; sp=2 update {sp['ms']:.1f} ms, {sp['peak'] / 1e9:.2f} GB per rank (offline "
        f"{ranks['solo']['sp_offline']['ms']:.1f} ms, "
        f"{ranks['solo']['sp_offline']['peak'] / 1e9:.2f} GB); tp=2 bf16 micro-step "
        f"{ranks['results']['2_0']['tp_bf16']['ms']:.1f} ms, params + moments "
        f"{ranks['results']['2_0']['tp_bf16']['state_bytes'] / 1e9:.3f} GB a rank; ep=2 "
        f"micro-step {ranks['results']['2_0']['ep']['ms']:.1f} ms; pp=2 bf16 micro-step "
        f"{ranks['results']['2_0']['pp_bf16']['ms']:.1f} / "
        f"{ranks['results']['2_1']['pp_bf16']['ms']:.1f} ms (stage 0 / 1), params + moments "
        f"{ranks['results']['2_0']['pp_bf16']['state_bytes'] / 1e9:.3f} / "
        f"{ranks['results']['2_1']['pp_bf16']['state_bytes'] / 1e9:.3f} GB; phase "
        f"{ranks['seconds']:.1f} s; {time.perf_counter() - t_start:.1f} s in all")
    main_shape = ("bfloat16", TRAIN_ROWS, 249, 16)
    fwd = next(r for r in fwd_rows if (r["dtype"], r["B"], r["L"], r["H"]) == main_shape)
    bwd = next(r for r in bwd_rows if (r["dtype"], r["B"], r["L"], r["H"]) == main_shape
               and r["intra"] == "bf16")
    ema = next(r for r in ema_rows if (r["dtype"], r["B"], r["M"], r["D"], r["saturate"])
               == ("bfloat16", 64, 256, 384, False))
    rnnt = next(r for r in rnnt_rows
                if (r["dtype"], r["B"], r["T"], r["U"]) == ("bfloat16", TRAIN_ROWS, 249, 64))
    log(f"kernel summary: ssd_fwd / ssd_bwd at bf16 (intra bf16) B{TRAIN_ROWS} L249 H16 P64 "
        f"N128 (a micro-batch of 32 x 10 s, main stack); ema_fwd / ema_bwd at bf16 B64 M256 "
        f"D384 (the dechunk of 64 x 10 s); rnnt_fwd / rnnt_bwd from bf16 logits at "
        f"B{TRAIN_ROWS} T249 U64 V+1 501 in 504 columns (a micro-batch of 32 x 10 s; two "
        f"launches a call each way, their times summed); launches (calls): ssd_fwd from the "
        f"full-width decode run "
        f"of the device engine (one warm-up and one shared encoder pass; its searches launch "
        f"no hand kernel), rnnt_fwd / rnnt_bwd from the RNN-T training run (this slice's main "
        f"path: 3 updates of 2 micro-steps), the others from the N=2 training run (3 "
        f"micro-steps of 64 x 10 s, remat full), every path's in launches_by_path; no single "
        f"PyTorch call computes the scan, the EMA, the transducer lattice or their gradients "
        f"(torchaudio is not installed)")
    by_path = {"decode_device_engine": {"ssd_fwd": full["engines"]["device"]["launches"]},
               "decode_lockstep": {"ssd_fwd": full["engines"]["lockstep"]["launches"]},
               "train_n2": train_n2["launches"],
               "gate_proof_tone_n1": gate["launches"],
               "train_gate": {"ssd_fwd": train["ssd_fwd"], "ssd_bwd": train["ssd_bwd"]},
               "train_rnnt": train_rnnt["launches"], "grads_rnnt": rnnt_grads,
               "gate_proof_rnnt_tone": rnnt_gate["launches"],
               "train_moe": moe["train"]["launches"], **stream["launches"],
               **artifacts["launches"], **train_cli["launches"], **interp["launches"],
               **ranks["launches"]}
    launches = dict(train_n2["launches"], ssd_fwd=full["engines"]["device"]["launches"],
                    rnnt_fwd=train_rnnt["launches"]["rnnt_fwd"],
                    rnnt_bwd=train_rnnt["launches"]["rnnt_bwd"])
    ssd = lambda r: dict(max_abs_err=r["abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=r["bound_ms"], bound_by=r["bound_by"])
    ema_row = lambda k: dict(max_abs_err=ema["abs_err"][k], ms=ema["ms"][k],
                             plain_ms=ema["plain"][k], bound_ms=ema["cost"][k]["bound_ms"],
                             bound_by=ema["cost"][k]["bound_by"])
    rnnt_row = lambda k: dict(max_abs_err=rnnt["abs_err"][k], ms=rnnt["ms"][k],
                              plain_ms=rnnt["plain_ms"][k], bound_ms=rnnt["cost"][k]["bound_ms"],
                              bound_by=rnnt["cost"][k]["bound_by"])
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"hnet_mamba_asr_torch/csrc/{source}",
         "replaces": replaces, "launches": launches[name],
         "launches_by_path": {k: v[name] for k, v in by_path.items() if name in v}, **row,
         "library_ms": None, "roofline_share": row["bound_ms"] / row["ms"]}
        for name, source, replaces, row in (
            ("ssd_fwd", "ssd_fwd.cu", "hnet_mamba_asr_tpu/ops/ssd_pallas.py:33", ssd(fwd)),
            ("ssd_bwd", "ssd_bwd.cu", "hnet_mamba_asr_tpu/ops/ssd.py:148", ssd(bwd)),
            ("ema_fwd", "ema.cu", "hnet_mamba_asr_tpu/ops/ema.py:34", ema_row("fwd")),
            ("ema_bwd", "ema.cu", "hnet_mamba_asr_tpu/ops/ema.py:34", ema_row("bwd")),
            ("rnnt_fwd", "rnnt.cu", "hnet_mamba_asr_tpu/ops/rnnt_loss.py:34", rnnt_row("fwd")),
            ("rnnt_bwd", "rnnt.cu", "hnet_mamba_asr_tpu/ops/rnnt_loss.py:34",
             rnnt_row("bwd")))]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ranks-worker":
        ranks_worker(Path(sys.argv[2]))          # one rank of phase 22
        sys.exit(0)
    if sys.argv[1:2] == ["--gloo-probe"]:
        # one rank of phase 22's probes: the collectives, or the p2p ops
        gloo_probe(GLOO_P2P_OPS if sys.argv[2:] == ["p2p"] else GLOO_CUDA_OPS)
        sys.exit(0)
    sys.exit(main())
