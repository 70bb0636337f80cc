"""LM task: config dict -> ``TransformerLM`` wired for ``training/trainer.py``,
counterpart of ``hnet_mamba_asr_tpu/tasks/lm_task.py``.

``LMModel.loss_fn`` emits ``batch_weight`` = scored tokens (+1 eos per
line), so that the trainer's weighted loss makes ``exp(loss)`` a token-
weighted perplexity. Dropout draws from (23, step), as in the JAX task. An
MoE LM (``lm_conf.moe``) adds its load-balance aux loss at ``aux_weight``.
``build_lm`` reads ``lm_conf`` (the LM computes in fp32, as the JAX
``build_lm`` builds it). ``build_lm_dataloaders`` reads the corpus file
``data.lm_corpus`` and the dev manifests' transcripts (``data/lm_text.py``);
``TokenLineLoader`` batches tokenized lines held in memory under a token
budget.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn

from hnet_mamba_asr_torch.data.lm_text import LMTextDataset, make_lm_dataloader
from hnet_mamba_asr_torch.models.lm import TransformerLM
from hnet_mamba_asr_torch.models.moe import moe_aux
from hnet_mamba_asr_torch.ops.specaug import seed_from
from hnet_mamba_asr_torch.parallel.collectives import batch_sum
from hnet_mamba_asr_torch.parallel.mesh import world
from hnet_mamba_asr_torch.tasks.build import _resolve, resolve_manifests

DROPOUT_SEED = 23
logger = logging.getLogger(__name__)


class LMModel(nn.Module):
    """Trainer-contract wrapper around TransformerLM (its parameters under
    ``lm``, as the JAX task's ``{"lm": params}``)."""

    def __init__(self, lm: TransformerLM, max_tokens: int = 512, moe_aux_weight: float = 0.0):
        super().__init__()
        self.lm = lm
        self.max_tokens = max_tokens
        self.moe_aux_weight = moe_aux_weight

    def loss_fn(self, batch: dict, step: int, train: bool):
        """-> (loss, stats); an MoE LM adds its load-balance aux loss at
        ``moe_aux_weight`` and the stats moe/aux and moe/dropped."""
        tokens, lens, row_mask = batch["tokens"], batch["token_lens"], batch["row_mask"]
        gen = (torch.Generator(device=tokens.device).manual_seed(seed_from(DROPOUT_SEED, step))
               if train else None)
        moe_stats = [] if self.lm.moe_experts > 0 else None
        loss, acc = self.lm.loss(tokens, lens, gen, row_mask=row_mask, moe_stats=moe_stats)
        stats = {"lm/token_acc": acc.detach(),
                 "batch_weight": batch_sum(((lens + 1) * row_mask).sum())}
        if moe_stats is not None:
            aux, mstats = moe_aux(moe_stats, self.moe_aux_weight)
            loss = loss + aux
            stats.update(mstats)
        stats["loss/total"] = loss.detach()
        return loss, stats


def build_lm(config: Mapping[str, Any], vocab_size: int, max_tokens: int | None = None, *,
             seed: int = 0, device="cuda") -> LMModel:
    """``lm_conf`` -> LMModel with weights drawn from ``seed``, on ``device``
    (the card by default), in eval mode."""
    lc = (config or {}).get("lm_conf", {}) or {}
    mc = lc.get("moe", {}) or {}
    gen = torch.Generator().manual_seed(int(seed))
    lm = TransformerLM(vocab_size=int(vocab_size), d_model=int(lc.get("d_model", 512)),
                       n_layers=int(lc.get("n_layers", 8)), n_heads=int(lc.get("n_heads", 8)),
                       d_ff=int(lc.get("d_ff", 2048)), dropout=float(lc.get("dropout", 0.1)),
                       lsm_weight=float(lc.get("lsm_weight", 0.0)),
                       moe_experts=int(mc.get("n_experts", 0)),
                       moe_top_k=int(mc.get("top_k", 2)),
                       moe_capacity_factor=float(mc.get("capacity_factor", 1.25)),
                       generator=gen)
    model = LMModel(lm, max_tokens=int(max_tokens or lc.get("max_line_tokens", 512)),
                    moe_aux_weight=float(mc.get("aux_weight", 0.01)))
    return model.to(torch.device(device)).eval()


def build_lm_dataloaders(cfg, repo_root, tokenizer, *, seed: int = 0,
                        row_split: tuple[int, int] | None = None):
    """-> (train loader over ``data.lm_corpus``, its sampler, {dev split:
    loader over the split manifest's transcripts}); batches of at most
    ``batch_tokens`` (rows x longest line), lines cut at
    ``lm_conf.max_line_tokens``. Dev loaders are unshuffled. Over several
    ranks (``row_split`` = (rank, count), by default the process group's)
    each train batch is split into equal row slices (``row_shard``), rows
    padded to a multiple of the rank count; dev is not split."""
    rank, count = row_split if row_split is not None else world()
    data = cfg.get("data", {}) or {}
    batch_tokens = int(cfg["batch_tokens"])
    max_tokens = int((cfg.get("lm_conf", {}) or {}).get("max_line_tokens", 512))
    corpus = _resolve(data["lm_corpus"], Path(repo_root))
    train_ds = LMTextDataset(tokenizer, corpus_path=corpus, max_tokens=max_tokens)
    train_loader, train_sampler = make_lm_dataloader(
        train_ds, batch_tokens, shuffle=True, seed=seed, num_replicas=count, rank=rank,
        batch_multiple=count, row_shard=count > 1)
    _, dev_manifests = resolve_manifests(cfg, repo_root)
    dev_loaders = {}
    for name, mpath in dev_manifests.items():
        ds = LMTextDataset.from_manifest(mpath, tokenizer, max_tokens=max_tokens)
        dev_loaders[name], _ = make_lm_dataloader(ds, batch_tokens, shuffle=False, seed=seed)
    logger.info("lm dataloaders: train=%d batches (%s), dev=%s", len(train_sampler),
                corpus.name, {k: len(v) for k, v in dev_loaders.items()})
    return train_loader, train_sampler, dev_loaders


class TokenLineLoader:
    """Token lines -> host batches ``{tokens, token_lens, row_mask}``: lines
    sorted by length and packed while (rows x longest line) stays within
    ``batch_tokens``, lines longer than ``max_tokens`` cut, the batches'
    order shuffled by (seed + epoch); tokens padded with ``pad_id`` to a
    multiple of 8."""

    def __init__(self, lines: Sequence[Sequence[int]], batch_tokens: int, *,
                 max_tokens: int = 512, pad_id: int = 3, seed: int = 0, shuffle: bool = True):
        self.lines = [np.asarray(ln[:max_tokens], np.int32) for ln in lines if len(ln)]
        self.pad_id, self.seed, self.shuffle, self.epoch = pad_id, seed, shuffle, 0
        order = sorted(range(len(self.lines)), key=lambda i: len(self.lines[i]))
        self.batches, cur, cur_max = [], [], 0
        for i in order:
            n = len(self.lines[i]) + 1                   # + eos
            if cur and (len(cur) + 1) * max(cur_max, n) > batch_tokens:
                self.batches.append(cur)
                cur, cur_max = [], 0
            cur.append(i)
            cur_max = max(cur_max, n)
        if cur:
            self.batches.append(cur)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        order = np.arange(len(self.batches))
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(order)
        for k in order:
            rows = [self.lines[i] for i in self.batches[k]]
            u = max(8, -(-max(len(r) for r in rows) // 8) * 8)
            tokens = np.full((len(rows), u), self.pad_id, np.int32)
            for j, r in enumerate(rows):
                tokens[j, :len(r)] = r
            yield {"tokens": tokens, "token_lens": np.array([len(r) for r in rows], np.int32),
                   "row_mask": np.ones(len(rows), bool)}
