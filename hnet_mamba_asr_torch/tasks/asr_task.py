"""ASR task assembly: config dict -> the wired, trainable model.

Counterpart of ``hnet_mamba_asr_tpu/tasks/asr_task.py``. ``build_model(config,
vocab_size)`` assembles ``DCASRModel`` = log-mel frontend + CMVN +
SpecAugment + encoder + (CTC head iff ctc_weight > 0) + (AED head iff
aed_weight > 0) + (RNN-T head iff rnnt_weight > 0) + hybrid loss, in the
compute dtype that ``train.precision`` names (weights stay fp32), on the card
unless the caller passes ``device="cpu"``. ``aed_conf.moe`` makes the AED
decoder's FFNs routed MoE FFNs, whose load-balance aux loss joins the AED
loss at ``aed_conf.moe.aux_weight``.

Model contract of the trainer (``training/trainer.py``), as in the JAX
package: the batch is a dict {wave, wave_lens, tokens, token_lens, row_mask,
aug_ref = [seed, epoch], item_index}; ``loss_fn(batch, step, train)``
returns ``(loss, stats)`` with the JAX stats keys; padded batch rows are
excluded from every loss and stat by row_mask. Randomness is a function of
integers: SpecAugment of (seed, epoch, item_index), AED dropout of
(17, step).

``encoder_conf.ssd_intra_dtype`` reaches the SSD scan as its
``intra_dtype`` and ``encoder_conf.remat_policy`` the Mamba stacks, as in the
JAX model.
"""
from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn as nn

from hnet_mamba_asr_torch.data.features import GlobalCMVN
from hnet_mamba_asr_torch.models.aed import AEDHead, label_smoothing_loss, strip_hypothesis
from hnet_mamba_asr_torch.models.ctc_head import CTCHead, greedy_decode as ctc_host_greedy
from hnet_mamba_asr_torch.models.encoder import DCASREncoder, EncoderOutput
from hnet_mamba_asr_torch.models.moe import moe_aux
from hnet_mamba_asr_torch.models.rnnt import RNNTHead, rnnt_host_greedy
from hnet_mamba_asr_torch.ops.ctc_loss import ctc_infeasible, ctc_loss
from hnet_mamba_asr_torch.ops.melspec import log_mel_spectrogram
from hnet_mamba_asr_torch.ops.specaug import seed_from, spec_augment, specaug_kwargs
from hnet_mamba_asr_torch.parallel.collectives import batch_sum
from hnet_mamba_asr_torch.training.loss import HybridLossWeights, combine_losses

logger = logging.getLogger(__name__)

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp16": torch.float16}
DROPOUT_SEED = 17           # AED dropout draws from (17, step), as the JAX loss_fn


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
        n_mid=int(ec.get("n_mid", 4)), arch_type=str(ec["arch_type"]),
        N=h.get("compression_N", 1),
        bidirectional=bool(ec.get("bidirectional", True)),
        hnet_ema=bool(h.get("ema_smoothing", True)),
        chunker=str(h.get("chunker", "dynamic")),
        d_state=int(ec.get("d_state", 128)), headdim=int(ec.get("headdim", 64)),
        chunk_size=int(ec.get("ssd_chunk_size", 256)),
        ssd_intra_dtype=ec.get("ssd_intra_dtype"),
        ssd_out_compute_dtype=bool(ec.get("ssd_out_compute_dtype", False)),
        remat_policy=str(ec.get("remat_policy", "full")),
        dtype=dtype, generator=generator)


def build_head(config, vocab_size: int, dtype=torch.float32, generator=None) -> CTCHead:
    name = str(config.get("head", "ctc")).lower()
    if name != "ctc":
        raise ValueError(f"unknown head {name!r}; choices: ['ctc']")
    return CTCHead(int(config["encoder_conf"]["d_outer"]), int(vocab_size), dtype,
                   generator)


def build_aed_head(config, vocab_size: int, dtype=torch.float32, generator=None) -> AEDHead:
    ac = config.get("aed_conf", {}) or {}
    mc = config.get("model_conf", {}) or {}
    moe = ac.get("moe", {}) or {}
    return AEDHead(vocab_size=int(vocab_size), d_model=int(config["encoder_conf"]["d_outer"]),
                   n_layers=int(ac.get("n_layers", 6)), n_heads=int(ac.get("n_heads", 4)),
                   d_ff=int(ac.get("d_ff", 2048)), dropout=float(ac.get("dropout", 0.1)),
                   lsm_weight=float(mc.get("lsm_weight", 0.1)),
                   max_decode_len=int(ac.get("max_decode_len", 512)),
                   moe_experts=int(moe.get("n_experts", 0)), moe_top_k=int(moe.get("top_k", 2)),
                   moe_capacity_factor=float(moe.get("capacity_factor", 1.25)),
                   dtype=dtype, generator=generator)


def build_rnnt_head(config, vocab_size: int, dtype=torch.float32, generator=None) -> RNNTHead:
    """The transducer head from ``rnnt_conf`` (JAX's defaults)."""
    rc = config.get("rnnt_conf", {}) or {}
    return RNNTHead(vocab_size=int(vocab_size), d_memory=int(config["encoder_conf"]["d_outer"]),
                    d_pred=int(rc.get("d_pred", 256)), d_joint=int(rc.get("d_joint", 512)),
                    context=int(rc.get("context", 2)),
                    max_symbols=int(rc.get("max_symbols", 4)),
                    max_decode_len=int(rc.get("max_decode_len", 512)),
                    dtype=dtype, generator=generator)


def step_generator(step: int, device) -> torch.Generator:
    """The dropout generator of a training step, on ``device``."""
    return torch.Generator(device=device).manual_seed(seed_from(DROPOUT_SEED, step))


class DCASRModel(nn.Module):
    """Frontend + encoder + CTC / AED / RNN-T heads + hybrid loss."""

    def __init__(self, encoder: DCASREncoder, ctc_head: CTCHead | None,
                 aed_head: AEDHead | None = None, weights: HybridLossWeights | None = None,
                 *, rnnt_head: RNNTHead | None = None, n_mels: int = 80,
                 win_length: int = 400, hop_length: int = 160, sample_rate: int = 16000,
                 cmvn: GlobalCMVN | None = None, specaug_conf: dict | None = None,
                 moe_aux_weight: float = 0.01):
        super().__init__()
        if ctc_head is None and aed_head is None and rnnt_head is None:
            raise ValueError("DCASRModel needs at least one of ctc/aed/rnnt heads")
        self.encoder = encoder
        self.ctc = ctc_head
        self.aed = aed_head
        self.rnnt = rnnt_head
        self.moe_aux_weight = moe_aux_weight
        self.weights = weights or HybridLossWeights()
        self.n_mels, self.win, self.hop = n_mels, win_length, hop_length
        self.sample_rate = sample_rate
        self.cmvn = cmvn
        self.specaug = dict(specaug_conf) if specaug_conf else None

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def features(self, batch: dict, train: bool = False):
        """{wave [B, S], wave_lens [B]} -> (log-mel + CMVN feats fp32, lengths);
        in training, SpecAugment from the batch's aug_ref = [seed, epoch] and
        item_index."""
        feats, flens = log_mel_spectrogram(
            batch["wave"], batch["wave_lens"], win_length=self.win,
            hop_length=self.hop, n_mels=self.n_mels, sample_rate=self.sample_rate)
        if self.cmvn is not None:
            feats = self.cmvn(feats)
        if train and self.specaug is not None:
            seed, epoch = (int(v) for v in np.asarray(_host(batch["aug_ref"])))
            feats = spec_augment(feats, flens, seed, epoch, _host(batch["item_index"]),
                                 **self.specaug)
        return feats, flens

    def encode(self, batch: dict, train: bool = False) -> EncoderOutput:
        feats, flens = self.features(batch, train)
        return self.encoder(feats, flens)

    def loss_fn(self, batch: dict, step: int, train: bool):
        """-> (loss, stats): the weighted hybrid loss, and detached stats with
        the JAX keys (loss/total, loss/ctc, loss/aed, loss/ratio, loss/rnnt,
        ctc_infeasible, kept_fraction and, for Type B, kept_fraction_1,
        batch_weight; moe/aux and moe/dropped with an MoE AED). CTC rows are
        divided by their token length (torch's 'mean'), RNN-T rows by their
        token length + 1, then averaged over the real rows; the AED loss is
        the token-mean label-smoothed CE over real rows, plus the MoE aux
        loss at its weight. Every mean is over the global batch: with
        ``parallel/collectives.py::rows_split_over`` set, the counts and
        sums go over the ranks that split its rows."""
        return self.heads_loss(self.encode(batch, train), batch, step, train)

    def heads_loss(self, enc: EncoderOutput, batch: dict, step: int, train: bool):
        """``loss_fn`` from an encoder output: the heads, their losses and the
        stats (the sequence-parallel model encodes on its own, then calls
        this on the gathered features)."""
        row_mask = batch["row_mask"]
        tokens, token_lens = batch["tokens"], batch["token_lens"]
        # every count and sum over rows is the global batch's (batch_sum): a
        # rank of a multi-rank run forms the loss of the whole batch
        n_real = batch_sum(row_mask.sum().float()).clamp(min=1.0)
        stats: dict = {}
        ctc = aed = rnnt = None
        if self.ctc is not None:
            logp = self.ctc.log_probs(enc.features)
            rows = ctc_loss(logp, enc.lengths, tokens, token_lens, blank_id=self.ctc.blank_id)
            rows = rows / token_lens.clamp(min=1)
            ctc = batch_sum((rows * row_mask).sum()) / n_real
            stats["ctc_infeasible"] = batch_sum((ctc_infeasible(enc.lengths, tokens, token_lens)
                                                 & row_mask).sum())
        if self.aed is not None:
            ys_in, ys_out, out_lens = self.aed.add_sos_eos(tokens, token_lens)
            gen = step_generator(step, enc.features.device) if train else None
            moe = [] if self.aed.moe_experts > 0 else None
            tok_mask = None
            if moe is not None:                          # bos + tokens of the real rows
                tok_mask = ((torch.arange(ys_in.shape[1], device=ys_in.device)[None, :]
                             <= token_lens[:, None]) & row_mask[:, None])
            logits = self.aed(enc.features, enc.lengths, ys_in, generator=gen,
                              token_mask=tok_mask, moe_stats=moe)
            aed = label_smoothing_loss(logits, ys_out, out_lens, self.aed.lsm_weight,
                                       row_mask=row_mask)
            if moe is not None:
                aux, moe_stats = moe_aux(moe, self.moe_aux_weight)
                aed = aed + aux
                stats.update(moe_stats)
        if self.rnnt is not None:
            rows = self.rnnt.loss(enc.features, enc.lengths, tokens, token_lens)
            rows = rows / (token_lens + 1).clamp(min=1)              # per symbol
            rnnt = batch_sum((rows * row_mask).sum()) / n_real
        out = combine_losses(self.weights, ctc_loss=ctc, aed_loss=aed,
                             ratio_loss=enc.ratio_loss, rnnt_loss=rnnt)
        stats.update({k: v.detach() for k, v in out.items()})
        for i, kf in enumerate(enc.kept_fractions):
            stats["kept_fraction" if i == 0 else f"kept_fraction_{i}"] = kf.detach()
        stats["batch_weight"] = batch_sum(row_mask.sum())
        return out["loss/total"], stats

    @torch.inference_mode()
    def greedy_decode(self, batch: dict, encode=None) -> list[list[int]]:
        """CTC greedy when a CTC head exists, else the RNN-T head's greedy
        search, else the AED head's KV-cached greedy decode (JAX's order):
        host-side id lists for every row. ``encode``: the encoder pass in
        place of ``self.encode`` (the pipelined one)."""
        enc = (encode or self.encode)(batch)
        if self.ctc is not None:
            ids = self.ctc.frame_argmax(enc.features)
            return ctc_host_greedy(ids.cpu(), enc.lengths.cpu(), self.ctc.blank_id)
        if self.rnnt is not None:
            return rnnt_host_greedy(*self.rnnt.greedy_decode(enc.features, enc.lengths))
        ids = self.aed.greedy_decode(enc.features, enc.lengths).cpu().numpy()
        return [strip_hypothesis(row, self.aed.eos_id) for row in ids]


def _host(value):
    """A batch entry the host reads (aug_ref, item_index) as numpy."""
    return value.cpu().numpy() if torch.is_tensor(value) else np.asarray(value)


def build_model(config, vocab_size: int, cmvn: GlobalCMVN | None = None, *,
                seed: int = 0, device="cuda") -> DCASRModel:
    """Assemble the model with weights drawn from ``seed``, on ``device`` (the
    card by default), in eval mode; heads exist iff their weight > 0."""
    mc = config.get("model_conf", {}) or {}
    weights = HybridLossWeights.from_config(mc)
    if max(weights.ctc_weight, weights.aed_weight, weights.rnnt_weight) <= 0.0:
        raise ValueError("model_conf needs ctc_weight, aed_weight or rnnt_weight > 0")
    train = config.get("train")
    dtype = DTYPES[str(train.get("precision", "fp32"))] if isinstance(train, dict) \
        else torch.float32
    fc = config.get("frontend_conf", {}) or {}
    sc = config.get("specaug_conf")
    gen = torch.Generator().manual_seed(int(seed))
    encoder = build_encoder(config, dtype, gen)
    ctc = build_head(config, vocab_size, dtype, gen) if weights.ctc_weight > 0 else None
    aed = build_aed_head(config, vocab_size, dtype, gen) if weights.aed_weight > 0 else None
    rnnt = (build_rnnt_head(config, vocab_size, dtype, gen) if weights.rnnt_weight > 0
            else None)
    moe = ((config.get("aed_conf", {}) or {}).get("moe", {}) or {})
    model = DCASRModel(encoder, ctc, aed, weights, rnnt_head=rnnt,
                       moe_aux_weight=float(moe.get("aux_weight", 0.01)),
                       n_mels=int(fc.get("n_mels", 80)),
                       win_length=int(fc.get("win_length", 400)),
                       hop_length=int(fc.get("hop_length", 160)),
                       sample_rate=int(fc.get("sample_rate", 16000)), cmvn=cmvn,
                       specaug_conf=specaug_kwargs(sc) if sc else None)
    return model.to(torch.device(device)).eval()
