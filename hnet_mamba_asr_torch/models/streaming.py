"""Streaming encoder inference, counterpart of
``hnet_mamba_asr_tpu/models/streaming.py``.

Two kinds, as in JAX:

- ``StreamingEncoder``: overlapping windows of the offline encoder, for any
  config (bidirectional ones included). The encoder frames of an emission
  segment come from the offline encoder run over [segment start - left_ctx,
  segment end + lookahead) mel frames, keeping only the segment. Window
  starts are multiples of 4 mel frames, so the x4 conv grid of a window
  coincides with the offline one; the only approximation is the truncated
  context (history before ``left_ctx``, future past ``lookahead``), and it
  vanishes at the end of the audio and as the contexts grow. Every window is
  padded to one length, so every call has one shape.
- ``CausalStreamingEncoder``: exact streaming of a causal config
  (``bidirectional: false``) from carried states. The conv subsampling sees
  7 mel frames, so a window of 4 E + 4 mel frames gives E encoder frames;
  every Mamba-2 layer carries its conv tail and SSD state
  (``models/mamba2.py::Mamba2.step``); at N > 1 each dynamic-chunking level
  carries its router key and EMA state (``models/hnet_chunk.py::
  DynamicChunker.stream``), and its stacks run on compacted blocks with a
  count of real slots per row. It runs in fp32 whatever the config's dtype,
  as JAX's does, with the SSD kernel at L = E from the carried state and the
  EMA kernel's carried form on the card. Every op of the step is per row, so
  a batch of B independent streams (``step_wave``) is what the session pool
  of ``serving/runtime.py`` runs.

``StreamingCTCGreedy`` turns either kind's segments into token ids, carrying
the CTC collapse across segments.

Segments come back as tensors on the model's device.
"""
from __future__ import annotations

import numpy as np
import torch

from hnet_mamba_asr_torch.models.hnet_chunk import DynamicChunker
from hnet_mamba_asr_torch.models.mamba2 import STREAM_ROWS, dense

F32 = torch.float32


def subsampled_count(n_mel: int) -> int:
    """Mel frames -> encoder frames under the x4 VALID conv stack."""
    return ((n_mel - 1) // 2 - 1) // 2


class SampleBuffer:
    """The received samples of one stream from an absolute offset on, and
    the count of mel frames they make (center=False framing)."""

    def __init__(self, hop: int, win: int):
        self.hop, self.win = hop, win
        self.buf = np.zeros(0, np.float32)
        self.start = 0                           # absolute offset of buf[0]
        self.total = 0                           # samples received

    def add(self, samples) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        self.buf = np.concatenate([self.buf, samples])
        self.total += len(samples)

    def mel_ready(self) -> int:
        return max(0, (self.total - self.win) // self.hop + 1)

    def window(self, s0: int, n: int) -> np.ndarray:
        """Samples [s0, s0 + n), zero past the received ones."""
        seg = self.buf[s0 - self.start:s0 - self.start + n]
        out = np.zeros(n, np.float32)
        out[:len(seg)] = seg
        return out

    def drop_before(self, s: int) -> None:
        if s > self.start:
            self.buf = self.buf[s - self.start:]
            self.start = s


class StreamingEncoder:
    """Feed waveform samples incrementally; receive encoder-frame segments of
    the offline encoder over overlapping windows.

    All frame quantities are mel frames (10 ms) and multiples of 4:
    ``seg_frames`` per emission, ``left_ctx`` history, ``lookahead`` future.
    ``accept(samples)`` returns zero or more [E_seg, d] segments;
    ``finish()`` the rest (exact at the end of the audio), or None."""

    def __init__(self, model, *, seg_frames: int = 96, left_ctx: int = 512,
                 lookahead: int = 32):
        for name, v in (("seg_frames", seg_frames), ("left_ctx", left_ctx),
                        ("lookahead", lookahead)):
            if v % 4 != 0 or v < 4:
                raise ValueError(f"{name} must be a positive multiple of 4, got {v}")
        self.model = model
        self.seg, self.left_ctx, self.lookahead = int(seg_frames), int(left_ctx), int(lookahead)
        self.hop, self.win = int(model.hop), int(model.win)
        self.max_mel = self.left_ctx + self.seg + self.lookahead
        self.max_samples = (self.max_mel - 1) * self.hop + self.win
        self.reset()

    def reset(self) -> None:
        self._buf = SampleBuffer(self.hop, self.win)
        self._e0 = 0                             # next emission start (mel)

    @torch.inference_mode()
    def _run_window(self, w0: int, w1: int) -> torch.Tensor:
        """The encoder frames of mel window [w0, w1), through the offline
        encoder over one padded window length."""
        s0, s1 = w0 * self.hop, (w1 - 1) * self.hop + self.win
        seg = self._buf.window(s0, s1 - s0)
        wave = np.zeros((1, self.max_samples), np.float32)
        wave[0, :len(seg)] = seg
        dev = self.model.device
        enc = self.model.encode({"wave": torch.from_numpy(wave).to(dev),
                                 "wave_lens": torch.tensor([len(seg)], device=dev)})
        return enc.features[0, :subsampled_count(w1 - w0)]

    def _emit(self, end_mel: int) -> torch.Tensor:
        w0 = max(0, self._e0 - self.left_ctx)
        out = self._run_window(w0, end_mel + self.lookahead)
        lo, hi = self._e0 // 4 - w0 // 4, end_mel // 4 - w0 // 4
        self._e0 = end_mel
        self._buf.drop_before(max(0, self._e0 - self.left_ctx) * self.hop)
        return out[lo:hi]

    def accept(self, samples) -> list[torch.Tensor]:
        self._buf.add(samples)
        out = []
        while self._buf.mel_ready() >= self._e0 + self.seg + self.lookahead:
            out.append(self._emit(self._e0 + self.seg))
        return out

    def finish(self) -> torch.Tensor | None:
        n_mel = self._buf.mel_ready()
        total_enc = subsampled_count(n_mel)
        if total_enc <= self._e0 // 4:
            return None
        w0 = max(0, self._e0 - self.left_ctx)
        out = self._run_window(w0, n_mel)
        lo = self._e0 // 4 - w0 // 4
        self._e0 = n_mel
        return out[lo:total_enc - w0 // 4]


class CausalStreamingEncoder:
    """Exact streaming of a causal config: ``block_enc`` encoder frames a
    step from 4 ``block_enc`` + 4 mel frames, every layer's state carried.
    Matches the offline encoder to numeric noise at any block size, with a
    latency of one block. Raises for bidirectional configs (use
    ``StreamingEncoder``) and for the fixed-pool chunker at N > 1.

    ``accept`` / ``finish`` stream one utterance; ``step_wave`` advances a
    batch of independent streams one block from their states
    (``fresh_states``)."""

    def __init__(self, model, *, block_enc: int = 16):
        enc = model.encoder
        if int(block_enc) < 1:
            raise ValueError(f"block_enc must be >= 1, got {block_enc}")
        if enc.bidirectional:
            raise ValueError("CausalStreamingEncoder requires bidirectional=false — use "
                             "StreamingEncoder (window approximation) for bidirectional "
                             "configs")
        levels = [enc.chunk] if enc.arch_type == "A" else [enc.chunk1, enc.chunk2]
        self._identity = all(c.identity for c in levels)
        if not self._identity and not all(isinstance(c, DynamicChunker) for c in levels):
            raise ValueError("exact chunked streaming supports the dynamic chunker only "
                             "(got chunker='fixed')")
        if not self._identity and not all(c.ema_smoothing for c in levels):
            raise ValueError("exact chunked streaming needs hnet.ema_smoothing: true")
        self.model, self.encoder = model, enc
        self.hop, self.win = int(model.hop), int(model.win)
        self.E = int(block_enc)
        self.W_mel = 4 * self.E + 4              # covers mel [4j, 4j + 6] for each j
        self.S_win = (self.W_mel - 1) * self.hop + self.win
        self.reset()

    # ---- the batched step ------------------------------------------------------
    def fresh_states(self, batch: int = 1) -> dict:
        """The states of ``batch`` streams that have seen nothing."""
        enc, dev = self.encoder, self.model.device
        st = {"enc": enc.enc.fresh_states(batch, dev), "dec": enc.dec.fresh_states(batch, dev),
              "main": enc.main.fresh_states(batch, dev)}
        if enc.arch_type == "B":
            st["mid"] = enc.mid.fresh_states(batch, dev)
            st["mid_dec"] = enc.mid_dec.fresh_states(batch, dev)
            st["chunk1"] = enc.chunk1.fresh_state(batch, enc.d_outer, dev)
            st["chunk2"] = enc.chunk2.fresh_state(batch, enc.d_main, dev)
        elif not self._identity:
            st["chunk"] = enc.chunk.fresh_state(batch, enc.d_outer, dev)
        return st

    @torch.inference_mode()
    def step(self, mel: torch.Tensor, states: dict):
        """mel [B, W_mel, n_mels] (CMVN'd) -> (encoder frames [B, E, d_outer]
        fp32, the new states)."""
        enc = self.encoder
        x = enc.subsample.frames(mel, F32, STREAM_ROWS)
        st = dict(states)
        x_enc, st["enc"] = enc.enc.step(x, st["enc"])
        lin = lambda layer, v: dense(v, layer, F32, row_block=STREAM_ROWS)  # noqa: E731
        if self._identity:
            z, st["main"] = enc.main.step(lin(enc.proj_in, x_enc), st["main"])
            x_dech = lin(enc.proj_out, z)
        elif enc.arch_type == "A":
            def inner(z, kept):
                z, st["main"] = enc.main.step(lin(enc.proj_in, z), st["main"], kept)
                return lin(enc.proj_out, z)
            x_dech, st["chunk"] = enc.chunk.stream(x_enc, self._all_real(x_enc), st["chunk"],
                                                   inner)
        else:
            def inner2(z2, k2):
                z2, st["main"] = enc.main.step(z2, st["main"], k2)
                return z2

            def inner1(z1, k1):
                z1, st["mid"] = enc.mid.step(lin(enc.proj1_in, z1), st["mid"], k1)
                up2, st["chunk2"] = enc.chunk2.stream(z1, k1, st["chunk2"], inner2)
                z1, st["mid_dec"] = enc.mid_dec.step(z1 + up2, st["mid_dec"], k1)
                return lin(enc.proj1_out, z1)
            x_dech, st["chunk1"] = enc.chunk1.stream(x_enc, self._all_real(x_enc),
                                                     st["chunk1"], inner1)
        x_out, st["dec"] = enc.dec.step(x_enc + x_dech, st["dec"])
        return x_out, st

    @staticmethod
    def _all_real(x: torch.Tensor) -> torch.Tensor:
        return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)

    @torch.inference_mode()
    def step_wave(self, wave: torch.Tensor, states: dict):
        """wave [B, S_win] (samples [4 e0 hop, ...) of each stream, zero past
        its end) -> log-mel, CMVN -> ``step``."""
        lens = torch.full((wave.shape[0],), wave.shape[1], device=wave.device)
        feats, _ = self.model.features({"wave": wave, "wave_lens": lens})
        return self.step(feats[:, :self.W_mel], states)

    # ---- one utterance ---------------------------------------------------------
    def reset(self) -> None:
        self._buf = SampleBuffer(self.hop, self.win)
        self._e0 = 0                             # encoder frames emitted
        self._states = self.fresh_states(1)

    def _advance(self, n_valid: int) -> torch.Tensor:
        wave = self._buf.window(4 * self._e0 * self.hop, self.S_win)
        out, self._states = self.step_wave(
            torch.from_numpy(wave[None]).to(self.model.device), self._states)
        self._e0 += n_valid
        self._buf.drop_before(4 * self._e0 * self.hop)
        return out[0, :n_valid]

    def accept(self, samples) -> list[torch.Tensor]:
        self._buf.add(samples)
        out = []
        while self._buf.mel_ready() >= 4 * (self._e0 + self.E) + 4:
            out.append(self._advance(self.E))
        return out

    def finish(self) -> torch.Tensor | None:
        remaining = subsampled_count(self._buf.mel_ready()) - self._e0
        if remaining <= 0:
            return None
        return self._advance(remaining)          # the zero-padded tail is causal-safe


def collapse(frame_ids, prev: int, blank_id: int) -> tuple[list[int], int]:
    """CTC collapse of a segment's frame ids given the previous frame's id
    -> (new token ids, the last frame's id)."""
    out = []
    for fid in np.asarray(frame_ids).tolist():
        if fid != prev and fid != blank_id:
            out.append(int(fid))
        prev = fid
    return out, prev


class StreamingCTCGreedy:
    """Incremental CTC greedy over a streaming encoder: the collapse state
    (the previous frame's id) carries across segments, so the tokens equal
    the collapse of the concatenated frame argmaxes."""

    def __init__(self, model, stream):
        if model.ctc is None:
            raise ValueError("StreamingCTCGreedy needs the model's CTC head")
        self.ctc, self.stream = model.ctc, stream
        self.blank = model.ctc.blank_id
        self._prev = self.blank

    def reset(self) -> None:
        self._prev = self.blank
        self.stream.reset()

    def ids(self, feats: torch.Tensor) -> list[int]:
        """The token ids of one segment [E, d], the collapse carried."""
        with torch.inference_mode():
            ids = self.ctc.frame_argmax(feats[None], STREAM_ROWS)[0].cpu()
        out, self._prev = collapse(ids, self._prev, self.blank)
        return out

    def accept(self, samples) -> list[int]:
        toks: list[int] = []
        for feats in self.stream.accept(samples):
            toks += self.ids(feats)
        return toks

    def finish(self) -> list[int]:
        feats = self.stream.finish()
        if feats is None or len(feats) == 0:
            return []
        return self.ids(feats)
