"""Training loop, counterpart of ``hnet_mamba_asr_tpu/training/trainer.py``
for one card.

Model contract (the JAX one, built by ``tasks/asr_task.py`` and
``tasks/lm_task.py``): ``loss_fn(batch, step, train) -> (loss, stats)`` with
"loss/total" and "batch_weight" in the stats, and, for an ASR model,
``greedy_decode(batch) -> list[list[int]]`` for the inline dev WER.
``train_loader`` yields host batches (numpy dicts, ``data/dataset.py``) and
may have ``set_epoch``.

- Steps: each batch is a micro-step whose loss is divided by ``accum_grad``
  before its backward, so that the fp32 ``.grad`` of the parameters sums to
  the mean gradient (the JAX ``micro_step``); every ``accum_grad`` micro-steps
  one update: the global-norm clip (L2 only), the learning rate of the
  update's count, AdamW. A partial group at the end of an epoch is dropped,
  as in the JAX loop. The compute dtype is the model's (bf16 for the gate
  config) from fp32 master weights.
- Determinism: SpecAugment is a function of (seed, epoch, item index),
  dropout of (17, step), the sampler's order of (seed + epoch); a checkpoint
  holds integers, not RNG state, so ``train(resume=...)`` continues exactly.
- Checkpoints: ``epoch%04d.ckpt`` and ``latest.ckpt`` every
  ``valid_interval_epoch`` epochs, at the last epoch and at ``max_steps``
  (``training/checkpoint.py``), in the JAX package's layout.
- ``history`` keeps one record per update: step, loss, grad norm, lr, mel
  frames of the real rows and the update's time (CUDA events on the card,
  from its first micro-step to the end of the optimizer step). The host
  waits for the device once per update, when it reads the stats and the
  gradient norm, so that it queues the next micro-step while the device
  runs the last.

N-best selection, early stopping, best symlinks, checkpoint averaging,
``scan_steps``, meshes and FSDP are not ported; their keys raise where they
would change what a run does.
"""
from __future__ import annotations

import copy
import logging
import time
from pathlib import Path

import numpy as np
import torch

from hnet_mamba_asr_torch.convert import jax_to_state_dict, state_dict_to_jax_tree
from hnet_mamba_asr_torch.data.dataset import feat_frames
from hnet_mamba_asr_torch.eval.metrics import word_errors
from hnet_mamba_asr_torch.training import checkpoint as ckpt
from hnet_mamba_asr_torch.training.optim import build_optimizer, clip_by_global_norm, set_lr
from hnet_mamba_asr_torch.utils.config import flatten_config  # noqa: F401 (re-export)

logger = logging.getLogger(__name__)

DEVICE_KEYS = ("wave", "wave_lens", "tokens", "token_lens", "row_mask")
NOT_PORTED = ("scan_steps", "fsdp", "tp", "pp", "sp", "ep")


class Trainer:
    """Single-card training loop over host batches."""

    def __init__(self, model, train_loader, cfg, *, dev_loaders=None, tokenizer=None,
                 ckpt_dir="checkpoints", seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.train_loader = train_loader
        self.dev_loaders = dict(dev_loaders or {})
        self.tokenizer = tokenizer
        self.cfg = dict(cfg)
        self.seed = int(seed)
        self.ckpt_dir = Path(ckpt_dir)
        g = self.cfg.get
        for key in NOT_PORTED:
            if g(key) not in (None, False, 0, 1):
                raise NotImplementedError(f"train.{key}={g(key)!r} is not ported")
        if str(g("ckpt_backend", "pickle")) != "pickle":
            raise NotImplementedError("only the pickle checkpoint backend is ported")
        if (g("early_stopping") or {}).get("enable", False):
            logger.warning("Trainer: early stopping is not ported; the run goes to max_epoch")
        self.max_epoch = int(g("max_epoch", 120))
        self.grad_clip = float(g("grad_clip", 5.0))
        if float(g("grad_clip_type", 2.0)) != 2.0:
            raise ValueError("only L2 grad clipping is supported")
        self.accum_grad = max(1, int(g("accum_grad", 1)))
        self.log_interval = int(g("log_interval", 50))
        self.valid_interval = int(g("valid_interval_epoch", 10))
        self.max_steps = g("max_steps")
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.opt, self.lr_schedule = build_optimizer(
            g("optim", "adamw"), dict(g("optim_conf", {}) or {}), g("scheduler"),
            dict(g("scheduler_conf", {}) or {}), self.model)
        self.epoch, self.global_step = 0, 0
        self.metric_history: dict[tuple[str, str], dict[int, float]] = {}
        self.history: list[dict] = []
        logger.info("Trainer: device=%s params=%.1fM accum_grad=%d", self.device,
                    sum(p.numel() for p in self.params) / 1e6, self.accum_grad)

    # ---- one update ------------------------------------------------------
    def _to_device(self, batch: dict) -> dict:
        out = dict(batch)
        for k in DEVICE_KEYS:
            if k in batch:                        # an LM batch has no audio
                out[k] = torch.as_tensor(batch[k]).to(self.device, non_blocking=True)
        return out

    def _micro_step(self, batch: dict) -> dict:
        loss, stats = self.model.loss_fn(self._to_device(batch), self.global_step, True)
        (loss / self.accum_grad).backward()
        return stats

    def _apply_step(self) -> tuple[float, float]:
        gnorm = clip_by_global_norm(self.params, self.grad_clip)
        lr = float(self.lr_schedule(self.global_step))
        set_lr(self.opt, lr)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.global_step += 1
        return float(gnorm), lr

    def _timer(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @staticmethod
    def _elapsed_ms(start, end) -> float:
        if isinstance(start, torch.cuda.Event):
            end.synchronize()
            return start.elapsed_time(end)
        return (end - start) * 1e3

    # ---- one epoch --------------------------------------------------------
    def _train_epoch(self) -> None:
        if hasattr(self.train_loader, "set_epoch"):
            self.train_loader.set_epoch(self.epoch)
        sums = np.zeros(2)                         # epoch's sum of loss x weight, weight
        micro, step_stats, frames, start, keys = 0, [], 0, None, []

        def fold() -> dict:
            # the micro-steps' stats to the host, one copy per update
            cols = dict(zip(keys, torch.stack(step_stats).cpu().numpy().T))
            sums[:] += ((cols["loss/total"] * cols["batch_weight"]).sum(),
                        cols["batch_weight"].sum())
            return cols

        for batch in self.train_loader:
            batch = dict(batch)
            batch.pop("ids", None)
            if start is None:
                start = self._timer()
            stats = self._micro_step(batch)
            keys = list(stats)
            step_stats.append(torch.stack([stats[k].float() for k in keys]))
            rows = np.asarray(batch["row_mask"], bool)
            if "wave_lens" in batch:
                frames += sum(feat_frames(int(n)) for n in np.asarray(batch["wave_lens"])[rows])
            micro += 1
            if micro % self.accum_grad:
                continue
            gnorm, lr = self._apply_step()
            end = self._timer()
            record = {"step": self.global_step, "epoch": self.epoch, "grad_norm": gnorm,
                      "lr": lr, "frames": frames, "ms": self._elapsed_ms(start, end)}
            record.update({k: float(v.mean()) for k, v in fold().items()})
            self.history.append(record)
            if self.global_step % self.log_interval == 0:
                logger.info("step %d: %s", self.global_step, record)
            step_stats, frames, start = [], 0, None
            if self.max_steps and self.global_step >= self.max_steps:
                break
        if step_stats:
            fold()
        self.opt.zero_grad(set_to_none=True)      # a partial group is dropped
        self._record("train", "loss", sums[0] / max(1.0, sums[1]))

    def _record(self, phase: str, metric: str, value: float) -> None:
        self.metric_history.setdefault((phase, metric), {})[self.epoch] = float(value)

    # ---- validation ------------------------------------------------------------
    def validate(self) -> dict:
        """Loss and greedy WER (CTC, or AED without a CTC head) on every dev
        split (token ids as words when there is no tokenizer)."""
        per_split, agg = {}, {"loss": [], "wer": []}
        decode = (self.tokenizer.decode if self.tokenizer is not None
                  else lambda ids: " ".join(str(int(i)) for i in ids))
        for name, loader in self.dev_loaders.items():
            ls = ws = 0.0
            werr = wtot = 0
            for batch in loader:
                batch = dict(batch)
                batch.pop("ids", None)
                dev_batch = self._to_device(batch)
                with torch.no_grad():
                    _, stats = self.model.loss_fn(dev_batch, 0, False)
                w = float(stats["batch_weight"])
                ls += float(stats["loss/total"]) * w
                ws += w
                if hasattr(self.model, "greedy_decode"):
                    hyps = self.model.greedy_decode(dev_batch)
                    tokens, tlens = np.asarray(batch["tokens"]), np.asarray(batch["token_lens"])
                    for j in np.flatnonzero(np.asarray(batch["row_mask"], bool)):
                        we, wc = word_errors(decode(hyps[j]), decode(tokens[j, :tlens[j]]))
                        werr += we
                        wtot += wc
            if ws <= 0:
                raise RuntimeError(f"validation split {name}: no batches scored")
            m = {"loss": ls / ws}
            if wtot > 0:
                m["wer"] = 100.0 * werr / wtot
            per_split[name] = m
            for k in agg:
                if k in m:
                    agg[k].append(m[k])
        for k, values in agg.items():
            if values:
                self._record("valid", k, sum(values) / len(values))
        return per_split

    # ---- checkpoints ----------------------------------------------------------
    def save_checkpoint(self) -> None:
        state = {"params": state_dict_to_jax_tree(self.model.state_dict()),
                 "opt_state_format": "torch",
                 "torch_opt_state": ckpt.optimizer_state(self.opt),
                 "epoch": self.epoch, "global_step": self.global_step,
                 "metric_history": copy.deepcopy(self.metric_history),
                 "config": self.cfg, "seed": self.seed}
        for p in (self.ckpt_dir / f"epoch{self.epoch:04d}.ckpt",
                  self.ckpt_dir / "latest.ckpt"):
            ckpt.save_checkpoint(p, state)

    def load_checkpoint(self, path) -> None:
        state = ckpt.load_checkpoint(path)
        if state.get("opt_state_format") != "torch":
            raise ValueError(f"{path}: not a checkpoint of the port (its optimizer state "
                             "is optax's); load its params with convert.load_jax_params")
        self.model.load_state_dict(jax_to_state_dict(state["params"]), strict=True)
        ckpt.load_optimizer_state(self.opt, state["torch_opt_state"])
        self.global_step = int(state["global_step"])
        self.metric_history = state.get("metric_history", {})
        self.epoch = int(state["epoch"]) + 1          # the saved epoch completed
        logger.info("resumed %s -> epoch %d (step %d)", path, self.epoch, self.global_step)

    # ---- the training loop -----------------------------------------------------
    def train(self, resume=None) -> None:
        path = ckpt.resolve_resume(self.ckpt_dir, resume)
        if path is not None and Path(path).exists():
            self.load_checkpoint(path)
        self.model.train()
        for epoch in range(self.epoch, self.max_epoch):
            if self.max_steps and self.global_step >= self.max_steps:
                break
            self.epoch = epoch
            self._train_epoch()
            save_now = (epoch + 1) % self.valid_interval == 0 or epoch + 1 == self.max_epoch
            if save_now and self.dev_loaders:
                logger.info("epoch %d valid: %s", epoch, self.validate())
            at_budget = bool(self.max_steps) and self.global_step >= self.max_steps
            if save_now or at_budget:
                self.save_checkpoint()
            if at_budget:
                break
        self.model.eval()
