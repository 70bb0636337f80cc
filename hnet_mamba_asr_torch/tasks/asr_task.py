"""ASR task assembly for serving: config dict -> the wired model.

Counterpart of the serving part of ``hnet_mamba_asr_tpu/tasks/asr_task.py``.
``build_model(config, vocab_size)`` assembles ``DCASRModel`` = log-mel
frontend + CMVN + encoder + CTC head, in the compute dtype that
``train.precision`` names (weights stay fp32). Only the CTC head is ported:
the AED and RNN-T heads of a hybrid config are not built, and the serving
runtime refuses requests for their outputs. Training (SpecAugment, losses)
is not ported yet.

``encoder_conf.ssd_intra_dtype`` reaches the SSD scan as its
``intra_dtype``, as in the JAX model (whose serving forward runs the XLA
``ssd_chunked``): 'bf16' forms the intra-chunk weights in bf16.
"""
from __future__ import annotations

import logging

import torch
import torch.nn as nn

from hnet_mamba_asr_torch.data.features import GlobalCMVN
from hnet_mamba_asr_torch.models.ctc_head import CTCHead, greedy_decode as ctc_host_greedy
from hnet_mamba_asr_torch.models.encoder import DCASREncoder, EncoderOutput
from hnet_mamba_asr_torch.ops.melspec import log_mel_spectrogram

logger = logging.getLogger(__name__)

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp16": torch.float16}


def build_encoder(config, dtype=torch.float32, generator=None) -> DCASREncoder:
    name = str(config.get("encoder", "dcasr")).lower()
    if name != "dcasr":
        raise ValueError(f"unknown encoder {name!r}; choices: ['dcasr']")
    ec = config["encoder_conf"]
    h = ec.get("hnet", {}) or {}
    return DCASREncoder(
        n_mels=int(config.get("frontend_conf", {}).get("n_mels", 80)),
        d_outer=int(ec["d_outer"]), d_main=int(ec["d_main"]),
        n_enc=int(ec["n_enc"]), n_main=int(ec["n_main"]), n_dec=int(ec["n_dec"]),
        arch_type=str(ec["arch_type"]), N=h.get("compression_N", 1),
        bidirectional=bool(ec.get("bidirectional", True)),
        chunker=str(h.get("chunker", "dynamic")),
        d_state=int(ec.get("d_state", 128)), headdim=int(ec.get("headdim", 64)),
        chunk_size=int(ec.get("ssd_chunk_size", 256)),
        ssd_intra_dtype=ec.get("ssd_intra_dtype"),
        ssd_out_compute_dtype=bool(ec.get("ssd_out_compute_dtype", False)),
        dtype=dtype, generator=generator)


def build_head(config, vocab_size: int, dtype=torch.float32, generator=None) -> CTCHead:
    name = str(config.get("head", "ctc")).lower()
    if name != "ctc":
        raise ValueError(f"unknown head {name!r}; choices: ['ctc']")
    return CTCHead(int(config["encoder_conf"]["d_outer"]), int(vocab_size), dtype,
                   generator)


class DCASRModel(nn.Module):
    """Frontend + encoder + CTC head (eval-mode serving forward)."""

    def __init__(self, encoder: DCASREncoder, ctc_head: CTCHead, *, n_mels: int = 80,
                 win_length: int = 400, hop_length: int = 160,
                 sample_rate: int = 16000, cmvn: GlobalCMVN | None = None):
        super().__init__()
        self.encoder = encoder
        self.ctc = ctc_head
        self.n_mels, self.win, self.hop = n_mels, win_length, hop_length
        self.sample_rate = sample_rate
        self.cmvn = cmvn

    def features(self, batch: dict):
        """{wave [B, S], wave_lens [B]} -> (log-mel + CMVN feats fp32, lengths)."""
        feats, flens = log_mel_spectrogram(
            batch["wave"], batch["wave_lens"], win_length=self.win,
            hop_length=self.hop, n_mels=self.n_mels, sample_rate=self.sample_rate)
        if self.cmvn is not None:
            feats = self.cmvn(feats)
        return feats, flens

    def encode(self, batch: dict) -> EncoderOutput:
        feats, flens = self.features(batch)
        return self.encoder(feats, flens)

    @torch.inference_mode()
    def greedy_decode(self, batch: dict) -> list[list[int]]:
        """CTC greedy: host-side id lists for every row."""
        enc = self.encode(batch)
        ids = self.ctc.frame_argmax(enc.features)
        return ctc_host_greedy(ids.cpu(), enc.lengths.cpu(), self.ctc.blank_id)


def build_model(config, vocab_size: int, cmvn: GlobalCMVN | None = None, *,
                seed: int = 0) -> DCASRModel:
    """Assemble the serving model on the CPU, in eval mode, with weights
    drawn from ``seed``.

    A config whose CTC weight is 0 raises: only the CTC head is ported.
    """
    mc = config.get("model_conf", {}) or {}
    if float(mc.get("ctc_weight", 1.0)) <= 0.0:
        raise NotImplementedError("only the CTC head is ported; model_conf.ctc_weight "
                                  "must be > 0")
    skipped = [k for k in ("aed_weight", "rnnt_weight") if float(mc.get(k, 0.0)) > 0]
    if skipped:
        logger.info("build_model: not building the heads of %s (not ported)", skipped)
    train = config.get("train")
    dtype = DTYPES[str(train.get("precision", "fp32"))] if isinstance(train, dict) \
        else torch.float32
    fc = config.get("frontend_conf", {}) or {}
    gen = torch.Generator().manual_seed(int(seed))
    model = DCASRModel(build_encoder(config, dtype, gen),
                       build_head(config, vocab_size, dtype, gen),
                       n_mels=int(fc.get("n_mels", 80)),
                       win_length=int(fc.get("win_length", 400)),
                       hop_length=int(fc.get("hop_length", 160)),
                       sample_rate=int(fc.get("sample_rate", 16000)), cmvn=cmvn)
    return model.eval()
