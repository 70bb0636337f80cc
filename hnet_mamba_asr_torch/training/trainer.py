"""Training loop, counterpart of ``hnet_mamba_asr_tpu/training/trainer.py``,
on one card or on the ranks of a process group.

Model contract (the JAX one, built by ``tasks/asr_task.py`` and
``tasks/lm_task.py``): ``loss_fn(batch, step, train) -> (loss, stats)`` with
"loss/total" and "batch_weight" in the stats, and, for an ASR model,
``greedy_decode(batch) -> list[list[int]]`` for the inline dev WER / CER.
``train_loader`` yields host batches (numpy dicts, ``data/dataset.py``) and
may have ``set_epoch``.

- Steps: each batch is a micro-step whose loss is divided by ``accum_grad``
  before its backward, so that the fp32 ``.grad`` of the parameters sums to
  the mean gradient (the JAX ``micro_step``); every ``accum_grad`` micro-steps
  one update: the global-norm clip (L2 only), the learning rate of the
  update's count, the optimizer (``training/optim.py``). A partial group at
  the end of an epoch is dropped, as in the JAX loop. The compute dtype is
  the model's (bf16 for the gate config) from fp32 master weights.
- Determinism: SpecAugment is a function of (seed, epoch, item index),
  dropout of (17, step), the sampler's order of (seed + epoch); a checkpoint
  holds integers, not RNG state, so ``train(resume=...)`` continues exactly.
- Validation (every ``valid_interval_epoch`` epochs and at the last): each
  dev split's weighted loss and, with a tokenizer and a model that has
  ``greedy_decode``, WER and CER of the decoded text, logged as
  ``dev_<split>/<metric>``; their means over the splits are
  ``metric_history[("valid", metric)]``.
- Selection, as JAX's: ``best_model_criterion`` ([phase, metric, mode]
  triples) picks the best epoch per criterion (``<phase>.<metric>.best.ckpt``
  symlinks), pruning keeps the union of each criterion's
  ``keep_nbest_models`` best epochs and the current one (unless
  ``keep_all_checkpoints``), early stopping fires when the epochs since the
  last best that beat the running best by more than ``min_delta`` exceed
  ``patience`` (all criteria with ``require_all``, else any), and at the end
  the N best of each criterion are averaged in fp32 into
  ``<phase>.<metric>.ave.ckpt``.
- Checkpoints: ``epoch%04d.ckpt`` and ``latest.ckpt`` at each validation
  epoch and at ``max_steps`` (``training/checkpoint.py``), in the JAX
  package's layout. With ``async_ckpt`` (default) the state is copied to the
  host on the main thread and pickled and written by ``AsyncWriter``'s
  thread, which also runs the symlink and pruning jobs in order; a load or
  an average waits for it.
- Metrics: with a ``MetricsLogger`` every ``_record`` is a JSONL line, every
  ``log_interval`` updates a ``train/*`` window (the update's mean stats,
  ``train/lr``, ``train/grad_norm``, ``train/samples_per_s``), the
  provenance goes under ``summary.json``'s "provenance" and the closing
  summary holds ``final_step``, ``epochs``, ``n_devices``, ``config`` and
  ``best_<phase>_<metric>[_epoch]``.
- ``history`` keeps one record per update: step, epoch, loss, grad norm, lr,
  mel frames of the real rows, the update's time (CUDA events on the card,
  from its first micro-step to the end of the optimizer step) and
  ``wait_ms``, the host time the loop waited on the loader for its batches,
  and ``group``, the updates its host read committed. The host reads the
  device once per update (``host_reads``): the gradient norm and the stats
  of its micro-steps in one copy, after which its CUDA events are read, so
  that it queues the next micro-step while the device runs the last. Each
  micro-step runs as soon as its batch arrives.
- ``scan_steps`` = K > 1 (JAX's fused scan of K updates): the updates run
  as their batches arrive, and their gradient norms, stats and timings stay
  on the device until one host read commits K records, or fewer at the
  epoch's end or at ``max_steps``. JAX groups only batches of one shape
  because its K updates are one traced call; eager updates have no trace,
  so any batches group, and the parameters are those of K single updates.
  It excludes ``accum_grad`` (JAX's error).

- Ranks (a ``torch.distributed`` process group, ``parallel/mesh.py``):
  every rank holds its row slice of each global batch (``row_shard``
  loaders); the losses' batch-wide sums run over the ranks that split the
  rows (``parallel/collectives.py::rows_split_over``: the world, or the dp
  axis of a model with ``rows_group``, ``parallel/seq_parallel.py::SPModel``),
  so every rank forms the loss of the global batch. The model runs under
  DDP (gradients averaged over every rank, not synchronized in the
  micro-steps of an accumulation group but the last) or, with
  ``train.fsdp``, FSDP2 (``parallel/mesh.py::shard_model``: large leaves
  and their moments sharded over every rank, the others replicated and
  their gradients averaged by ``sync_replicated_grads``; the optimizer then
  steps tensor by tensor, for a foreach step cannot mix shards and whole
  tensors). Only rank 0 writes: checkpoints (under FSDP gathered leaf by
  leaf from every rank first, in the same JAX layout), ``metrics.jsonl``,
  ``summary.json`` (``n_devices`` = the rank count) and the symlinks. A
  resume loads the full state on every rank and re-shards it.
- tp / ep (``mesh`` with a tp and / or an ep axis, ``parallel/mesh.py::
  make_mesh``): the trainer builds its planes and keeps each rank's shard
  of the model (``parallel/model_parallel.py::place_model``, by
  ``tp_plan`` / ``ep_plan``). The rows split over the dp axis only: DDP
  runs over the dp group and ``rows_split_over`` is the dp group, for the
  ranks of a tp / ep group hold the same rows. Before the clip, the
  gradients that several ranks of a plane hold are averaged over it
  (``sync_replicas``), and the clip's norm counts each element once
  (``clip_by_global_norm(split=)``). Checkpoints are gathered to the full
  JAX-layout state on rank 0 (``convert.gather_state``, moments too); a
  resume re-shards them (``shard_state``). ``summary.json`` holds the mesh.

- pp (``parallel/pipeline.py::PPModel``, on the (dp, pp) mesh of
  ``make_mesh(pp=)``): a rank holds its stage's main-stack blocks and the
  replicated rest; the rows split over the dp axis (DDP and
  ``rows_split_over`` take the dp group). Before the clip the replicated
  leaves' gradients are averaged over the pp group (equal up to the CTC
  backward's atomics), and the clip's norm is the norm of every leaf's
  norm in one process's order (``PPModel.leaf_norms``: the stage leaves
  from their stage, the replicated ones once). The optimizer holds the
  rank's leaves only. Checkpoints gather the stages to rank 0 (parameters
  and moments, in one process's layout and optimizer order); a resume
  keeps the rank's stage.

fsdp with tp / ep / pp and the orbax backend raise.
"""
from __future__ import annotations

import copy
import json
import logging
import os
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from hnet_mamba_asr_torch.convert import (gather_stages, gather_state, jax_to_state_dict,
                                          shard_state, stage_state, state_dict_to_jax_tree)
from hnet_mamba_asr_torch.data.manifests import feat_frames
from hnet_mamba_asr_torch.eval.metrics import char_errors, word_errors
from hnet_mamba_asr_torch.parallel import mesh as pmesh
from hnet_mamba_asr_torch.parallel import model_parallel as mpar
from hnet_mamba_asr_torch.parallel.collectives import rows_split_over
from hnet_mamba_asr_torch.parallel.pipeline import main_block
from hnet_mamba_asr_torch.training import checkpoint as ckpt
from hnet_mamba_asr_torch.training.async_ckpt import AsyncWriter
from hnet_mamba_asr_torch.training.optim import (build_optimizer, clip_by_global_norm,
                                                 label_names, set_lr)
from hnet_mamba_asr_torch.utils.config import flatten_config  # noqa: F401 (re-export)

logger = logging.getLogger(__name__)

DEVICE_KEYS = ("wave", "wave_lens", "tokens", "token_lens", "row_mask")


def _owned(obj):
    """A copy of every numpy array in a nested state (no view of a live tensor)."""
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, dict):
        return {k: _owned(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_owned(v) for v in obj)
    return obj


class _LossModule(torch.nn.Module):
    """The model's ``loss_fn`` as a module's forward, for DDP and FSDP to
    wrap (their hooks run around a forward). ``net`` owns the parameters."""

    def __init__(self, model):
        super().__init__()
        self.net = model if isinstance(model, torch.nn.Module) else model.model
        self.loss = model.loss_fn

    def forward(self, batch, step, train):
        return self.loss(batch, step, train)


class Trainer:
    """Training loop over host batches, on one card or the ranks of a
    process group."""

    def __init__(self, model, train_loader, cfg, *, dev_loaders=None, tokenizer=None,
                 metrics=None, ckpt_dir="checkpoints", seed: int = 0, provenance=None,
                 device="cuda", mesh=None):
        self.device = torch.device(device)
        model.to(self.device)
        self.model = model
        self.rank, self.world = pmesh.world()
        self.is_main = self.rank == 0
        self.distributed = torch.distributed.is_available() and torch.distributed.is_initialized()
        self.train_loader = train_loader
        self.dev_loaders = dict(dev_loaders or {})
        self.tokenizer = tokenizer
        self.metrics = metrics if self.is_main else None
        self.provenance = provenance
        self.cfg = dict(cfg)
        self.seed = int(seed)
        self.ckpt_dir = Path(ckpt_dir)
        if self.is_main:
            self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        g = self.cfg.get
        if int(g("sp", 1) or 1) > 1 and not hasattr(model, "rows_group"):
            raise ValueError(f"train.sp={g('sp')} needs the model wrapped in "
                             "parallel/seq_parallel.py::SPModel (scripts/train.py does)")
        if str(g("ckpt_backend", "pickle")) != "pickle":
            raise NotImplementedError("only the pickle checkpoint backend is ported")
        tp, _, pp, ep, _ = pmesh.validate_planes(self.cfg)
        # the pipeline's stages (parallel/pipeline.py::PPModel); on ranks when
        # they have a group, else every stage in this process
        self.pp = getattr(model, "stages", None)
        if pp > 1 and self.pp is None:
            raise ValueError(f"train.pp={pp} needs the model wrapped in "
                             "parallel/pipeline.py::PPModel (scripts/train.py does)")
        self.pp_ranks = self.pp is not None and self.pp.group is not None
        self.mp_plan = {}
        if tp > 1 or ep > 1:
            if mesh is None or "dp" not in (mesh.mesh_dim_names or ()):
                raise ValueError(f"train.tp={tp} / train.ep={ep} need the (dp, tp, ep) mesh of "
                                 "their ranks (parallel/mesh.py::make_mesh; scripts/train.py "
                                 "builds it)")
            self.mp_plan = mpar.place_model(model, mpar.plane_of(mesh, "tp", tp),
                                            mpar.plane_of(mesh, "ep", ep))
        self.planes = mpar.model_planes(model)
        self.split = list(mpar.split_leaves(model))
        self.mesh_shape = (dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
                           if mesh is not None else {"dp": self.world})
        self.max_epoch = int(g("max_epoch", 120))
        self.grad_clip = float(g("grad_clip", 5.0))
        if float(g("grad_clip_type", 2.0)) != 2.0:
            raise ValueError("only L2 grad clipping is supported")
        self.accum_grad = max(1, int(g("accum_grad", 1)))
        self.scan_steps = max(1, int(g("scan_steps", 1) or 1))
        if self.scan_steps > 1 and self.accum_grad > 1:
            raise ValueError("scan_steps and accum_grad are mutually exclusive")
        self.host_reads = 0
        self.log_interval = int(g("log_interval", 50))
        self.valid_interval = int(g("valid_interval_epoch", 10))
        self.keep_nbest = int(g("keep_nbest_models", 5))
        self.keep_all = bool(g("keep_all_checkpoints", False))
        self.max_steps = g("max_steps")
        self.best_model_criterion = [tuple(c) for c in
                                     g("best_model_criterion", [["valid", "loss", "min"]])]
        self.early_stopping = dict(g("early_stopping", {}) or {})
        # the ranks that split a batch's rows: the dp axis of an SPModel, a
        # PPModel or a tp / ep mesh, else all
        self.rows_group = None
        if self.distributed:
            self.rows_group = getattr(model, "rows_group", torch.distributed.group.WORLD)
            if self.mp_plan:
                self.rows_group = mesh.get_group("dp")
        # DDP averages over every rank (an sp rank's gradient is its shard's
        # part), but the ranks of a tp / ep / pp group share theirs: the dp
        # group only
        ddp_group = self.rows_group if self.mp_plan or self.pp_ranks else None
        self.fsdp = bool(g("fsdp", False)) and self.distributed
        self._ddp = self._root = None
        if self.fsdp:
            self._root = _LossModule(model)
            plan = pmesh.shard_model(self._root, self.device,
                                     int(g("fsdp_min_elems", pmesh._FSDP_MIN_ELEMS)),
                                     units=getattr(model, "fsdp_units", True))
            self.fsdp_plan = {k.split(".", 1)[1]: v for k, v in plan.items()}   # less "net."
        elif self.distributed and torch.distributed.get_world_size(ddp_group) > 1:
            from torch.nn.parallel import DistributedDataParallel
            self._ddp = DistributedDataParallel(
                _LossModule(model), broadcast_buffers=False, process_group=ddp_group,
                device_ids=[self.device.index or 0] if self.device.type == "cuda" else None)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.opt, self.lr_schedule = build_optimizer(
            g("optim", "adamw"), dict(g("optim_conf", {}) or {}), g("scheduler"),
            dict(g("scheduler_conf", {}) or {}), self.model)
        self.epoch, self.global_step = 0, 0
        self.metric_history: dict[tuple[str, str], dict[int, float]] = {}
        self.history: list[dict] = []
        self._ckpt_writer = (AsyncWriter() if bool(g("async_ckpt", True)) and self.is_main
                             else None)
        logger.info("Trainer: device=%s rank %d of %d (%s) params=%.1fM accum_grad=%d "
                    "optim=%s sched=%s dev_splits=%s", self.device, self.rank, self.world,
                    ("fsdp" if self.fsdp else "ddp" if self._ddp
                     else "no DDP" if self.distributed else "one process")
                    + f", mesh {self.mesh_shape}",
                    sum(p.numel() for p in self.params) / 1e6, self.accum_grad,
                    g("optim", "adamw"), g("scheduler"), list(self.dev_loaders))

    # ---- one update ------------------------------------------------------
    def _to_device(self, batch: dict) -> dict:
        out = dict(batch)
        for k in DEVICE_KEYS:
            if k in batch:                        # an LM batch has no audio
                out[k] = torch.as_tensor(batch[k]).to(self.device, non_blocking=True)
        return out

    def _micro_step(self, batch: dict, sync: bool = True) -> dict:
        """One micro-step's forward and backward; ``sync`` False (a micro-step
        of an accumulation group before its last) skips DDP's all-reduce."""
        batch = self._to_device(batch)
        with rows_split_over(self.rows_group):
            if self._ddp is not None:
                with nullcontext() if sync else self._ddp.no_sync():
                    loss, stats = self._ddp(batch, self.global_step, True)
                    (loss / self.accum_grad).backward()
                return stats
            if self._root is not None:
                loss, stats = self._root(batch, self.global_step, True)
            else:
                loss, stats = self.model.loss_fn(batch, self.global_step, True)
            (loss / self.accum_grad).backward()
        return stats

    def _apply_step(self) -> tuple[torch.Tensor, float]:
        """The update from the accumulated gradients -> (the gradient norm
        before the clip, on the device; the rate)."""
        if self.fsdp:
            pmesh.sync_replicated_grads(self.params)
        if self.split:
            mpar.sync_replicas(self.model, self.split)
        norms = None
        if self.pp_ranks:
            pmesh.sync_replicated_grads(self.model.replicated(), group=self.pp.group)
            norms = self.model.leaf_norms()
        gnorm = clip_by_global_norm(self.params, self.grad_clip, self.split, leaf_norms=norms)
        lr = float(self.lr_schedule(self.global_step))
        set_lr(self.opt, lr)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.global_step += 1
        return gnorm, lr

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

    # ---- bookkeeping ----------------------------------------------------------
    def _record(self, phase: str, metric: str, value: float) -> None:
        self.metric_history.setdefault((phase, metric), {})[self.epoch] = float(value)
        if self.metrics is not None:
            self.metrics.log_scalar(f"{phase}/{metric}", float(value), self.global_step,
                                    split=phase, epoch=self.epoch)

    def _best_epoch(self, phase, metric, mode):
        hist = self.metric_history.get((phase, metric))
        if not hist:
            return None
        pick = min if mode == "min" else max
        return pick(hist, key=lambda e: hist[e])

    def _finish_step(self, record: dict, rows: int) -> None:
        """The JAX ``_finish_step``'s log window: every ``log_interval``
        updates, this update's mean stats with the rate applied, the gradient
        norm and the rows a second since the last window."""
        self.history.append(record)
        win = self._window
        win["rows"] += rows
        step = record["step"]
        if step % self.log_interval:
            return
        dt = time.time() - win["t0"]
        logger.info("step %d: %s", step, record)
        if self.metrics is not None:
            payload = {k: record[k] for k in self._stat_keys}
            payload.update({"train/lr": record["lr"], "train/grad_norm": record["grad_norm"],
                            "train/samples_per_s": win["rows"] / dt if dt > 0 else 0.0})
            self.metrics.log_scalars(payload, step, split="train", epoch=self.epoch)
        win["rows"], win["t0"] = 0, time.time()

    # ---- one epoch --------------------------------------------------------
    def _add_micro_step(self, u: dict, batch: dict) -> None:
        """A micro-step of the update ``u``; what the device computes for the
        record stays there until ``_commit``."""
        stats = self._micro_step(batch, sync=len(u["stats"]) + 1 == self.accum_grad)
        self._stat_keys = list(stats)
        u["stats"].append(torch.stack([stats[k].detach().float() for k in self._stat_keys]))
        real = np.asarray(batch["row_mask"], bool)
        u["rows"] += int(real.sum())
        if "wave_lens" in batch:
            u["frames"] += sum(feat_frames(int(n)) for n in np.asarray(batch["wave_lens"])[real])

    def _commit(self, updates: list, sums: np.ndarray) -> None:
        """One host read for ``updates``: their gradient norms and their
        micro-steps' stats in one copy; then each applied update's record.
        A group's stats count in the epoch's loss either way."""
        parts = [torch.stack(u["stats"]).reshape(-1) for u in updates]
        parts += [u["gnorm"].reshape(1).float() for u in updates if "gnorm" in u]
        host = torch.cat(parts).cpu().numpy()
        self.host_reads += 1
        off, n_keys = 0, len(self._stat_keys)
        group = sum("gnorm" in u for u in updates)
        rows = []
        for u in updates:
            m = len(u["stats"]) * n_keys
            cols = dict(zip(self._stat_keys, host[off:off + m].reshape(-1, n_keys).T))
            off += m
            sums[:] += ((cols["loss/total"] * cols["batch_weight"]).sum(),
                        cols["batch_weight"].sum())
            rows.append(cols)
        for u, cols in zip(updates, rows):
            if "gnorm" not in u:
                continue
            record = {"step": u["step"], "epoch": self.epoch, "grad_norm": float(host[off]),
                      "lr": u["lr"], "frames": u["frames"],
                      "ms": self._elapsed_ms(u["start"], u["end"]), "wait_ms": u["wait"] * 1e3,
                      "group": group}
            off += 1
            record.update({k: float(v.mean()) for k, v in cols.items()})
            self._finish_step(record, u["rows"])

    def _train_epoch(self) -> None:
        if hasattr(self.train_loader, "set_epoch"):
            self.train_loader.set_epoch(self.epoch)
        self._window = {"rows": 0, "t0": time.time()}
        sums = np.zeros(2)                         # epoch's sum of loss x weight, weight
        self._stat_keys = []
        # the update whose micro-steps run, and the applied updates that
        # wait for their host read (scan_steps of them)
        update, pending = None, []
        batches = iter(self.train_loader)
        ids_log = os.environ.get("HMASR_CONSUMED_IDS")
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            wait = time.perf_counter() - t_wait
            if batch is None:
                break
            batch = dict(batch)
            ids = batch.pop("ids", None)
            if ids_log and ids is not None:
                # the per-rank audit of consumed utterances (tools/smoke_2proc.py)
                with open(ids_log, "a") as f:
                    f.write(json.dumps({"epoch": self.epoch, "ids": list(ids)}) + "\n")
            if update is None:
                update = {"start": self._timer(), "stats": [], "frames": 0, "rows": 0,
                          "wait": 0.0}
            update["wait"] += wait
            self._add_micro_step(update, batch)
            if len(update["stats"]) < self.accum_grad:
                continue
            update["gnorm"], update["lr"] = self._apply_step()
            update["step"], update["end"] = self.global_step, self._timer()
            pending.append(update)
            update = None
            done = bool(self.max_steps) and self.global_step >= self.max_steps
            if len(pending) == self.scan_steps or done:
                self._commit(pending, sums)
                pending = []
            if done:
                break
        if update is not None:                    # a partial accumulation: dropped
            pending.append(update)
            self.opt.zero_grad(set_to_none=True)
        if pending:
            self._commit(pending, sums)
        self._record("train", "loss", sums[0] / max(1.0, sums[1]))

    # ---- validation ------------------------------------------------------------
    def validate(self) -> dict:
        """Per dev split: the weighted loss and, with a tokenizer and a model
        that has ``greedy_decode``, WER and CER (%) of the decoded text;
        ``valid/<metric>`` records the mean over the splits."""
        root = getattr(self, "_root", None)
        if root is not None:
            root.unshard()                   # the root's leaves, for greedy_decode too
        try:
            return self._validate()
        finally:
            if root is not None:
                root.reshard()

    def _validate(self) -> dict:
        per_split, agg = {}, {"loss": [], "wer": [], "cer": []}
        score = self.tokenizer is not None and hasattr(self.model, "greedy_decode")
        for name, loader in self.dev_loaders.items():
            ls = ws = 0.0
            werr = wtot = cerr = ctot = 0
            for batch in loader:
                batch = dict(batch)
                batch.pop("ids", None)
                b_real = int(np.asarray(batch["row_mask"]).sum())
                dev_batch = self._to_device(batch)
                with torch.no_grad():
                    _, stats = self.model.loss_fn(dev_batch, 0, False)
                w = float(stats["batch_weight"]) if "batch_weight" in stats else float(b_real)
                ls += float(stats["loss/total"]) * w
                ws += w
                if score:
                    hyps = self.model.greedy_decode(dev_batch)
                    tokens, tlens = np.asarray(batch["tokens"]), np.asarray(batch["token_lens"])
                    for j in range(b_real):
                        ref = self.tokenizer.decode(tokens[j, :tlens[j]].tolist())
                        hyp = self.tokenizer.decode(hyps[j])
                        we, wc = word_errors(hyp, ref)
                        ce, cc = char_errors(hyp, ref)
                        werr += we
                        wtot += wc
                        cerr += ce
                        ctot += cc
            if ws <= 0:
                raise RuntimeError(f"validation split {name}: no batches scored")
            m = {"loss": ls / ws}
            if wtot > 0:
                m["wer"] = 100.0 * werr / wtot
            if ctot > 0:
                m["cer"] = 100.0 * cerr / ctot
            per_split[name] = m
            for k in agg:
                if k in m:
                    agg[k].append(m[k])
            if self.metrics is not None:
                self.metrics.log_scalars({f"dev_{name}/{k}": v for k, v in m.items()},
                                         self.global_step, split=name, epoch=self.epoch)
        for k, values in agg.items():
            if values:
                self._record("valid", k, sum(values) / len(values))
        return per_split

    # ---- selection / early stop --------------------------------------------------
    def _submit(self, fn) -> None:
        """Run a checkpoint-directory job on the writer's queue (or now); rank
        0's alone."""
        if not self.is_main:
            return
        self._ckpt_writer.submit(fn) if self._ckpt_writer else fn()

    def _update_best_symlinks(self) -> None:
        # which criteria this epoch is best for is decided now, on the live
        # history; the link is made after the epoch file it points to
        updates = [(phase, metric) for phase, metric, mode in self.best_model_criterion
                   if self._best_epoch(phase, metric, mode) == self.epoch]
        epoch = self.epoch
        self._submit(lambda: [ckpt.update_best_symlink(self.ckpt_dir, phase, metric, epoch)
                              for phase, metric in updates])

    def _nbest(self, phase, metric, mode) -> list[int]:
        hist = self.metric_history.get((phase, metric), {})
        return sorted(hist, key=lambda e: hist[e], reverse=(mode == "max"))[:self.keep_nbest]

    def _prune_checkpoints(self) -> None:
        if self.keep_nbest <= 0 or self.keep_all:
            return
        keep = {self.epoch}
        for criterion in self.best_model_criterion:
            keep.update(self._nbest(*criterion))

        def prune() -> None:
            for p in self.ckpt_dir.glob("epoch*.ckpt"):
                if int(p.stem[5:]) not in keep:
                    ckpt.remove_checkpoint(p)
        self._submit(prune)

    def _last_significant_best(self, phase, metric, mode, min_delta):
        """The last epoch that beat the running best by more than
        ``min_delta``: improvements below it neither reset the patience nor
        move the reference (``_best_epoch``, which selection uses, takes no
        threshold)."""
        hist = self.metric_history.get((phase, metric))
        if not hist:
            return None
        best_ep = best_val = None
        for e in sorted(hist):
            v = hist[e]
            if (best_val is None or (v < best_val - min_delta if mode == "min"
                                     else v > best_val + min_delta)):
                best_ep, best_val = e, v
        return best_ep

    def _should_early_stop(self) -> bool:
        es = self.early_stopping
        if not es.get("enable", False):
            return False
        results = []
        for c in es.get("criteria", []):
            be = self._last_significant_best(c["phase"], c["metric"], c.get("mode", "min"),
                                             float(c.get("min_delta", 0.0)))
            results.append(be is not None and (self.epoch - be) > int(c["patience"]))
        if not results:
            return False
        stop = all(results) if es.get("require_all", True) else any(results)
        if stop:
            logger.info("early stop at epoch %d (criteria stalled: %s)", self.epoch, results)
        return stop

    def _average_nbest(self) -> None:
        if self.keep_nbest <= 0 or not self.is_main:
            return
        self.flush_checkpoints()                   # averaging reads the epoch files
        for phase, metric, mode in self.best_model_criterion:
            paths = [self.ckpt_dir / f"epoch{e:04d}.ckpt"
                     for e in self._nbest(phase, metric, mode)]
            paths = [p for p in paths if p.exists()]
            if not paths:
                continue
            ckpt.save_checkpoint(self.ckpt_dir / f"{phase}.{metric}.ave.ckpt",
                                 ckpt.average_checkpoints(paths))
            logger.info("averaged %d ckpts -> %s.%s.ave.ckpt", len(paths), phase, metric)

    # ---- checkpoints ----------------------------------------------------------
    def save_checkpoint(self) -> None:
        """``epoch%04d.ckpt`` and ``latest.ckpt``: the state is copied to the
        host here, so that later steps (which update it in place) cannot
        reach into a save the writer thread still pickles. Under FSDP every
        rank takes part in gathering each leaf; rank 0 alone writes."""
        params, opt_state = self.model.state_dict(), self.opt.state_dict()
        if self.fsdp:
            params = pmesh.full_state(params, keep=self.is_main)
            opt_state = pmesh.full_state(opt_state, keep=self.is_main)
        if self.mp_plan:
            params, opt_state = self._gathered(params, opt_state)
        if self.pp_ranks:
            params, opt_state = self._stages_gathered(params, opt_state)
        if not self.is_main:
            return
        state = {"params": state_dict_to_jax_tree(params),
                 "opt_state_format": "torch",
                 "torch_opt_state": ckpt.optimizer_state(opt_state),
                 "epoch": self.epoch, "global_step": self.global_step,
                 "metric_history": copy.deepcopy(self.metric_history),
                 "config": self.cfg, "seed": self.seed}
        if self.device.type == "cpu":
            state = _owned(state)                 # CPU tensors' numpy views share memory
        paths = [self.ckpt_dir / f"epoch{self.epoch:04d}.ckpt", self.ckpt_dir / "latest.ckpt"]
        self._submit(lambda: [ckpt.save_checkpoint(p, state) for p in paths])

    def _param_names(self) -> list:
        """The optimizer's parameter indices' names (its state_dict's keys)."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        return [names[id(p)] for grp in self.opt.param_groups for p in grp["params"]]

    def _gather_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A tp / ep leaf (or its moment) gathered whole from its plane's ranks."""
        dim, idx, plane = self.mp_plan[name]
        group = self.planes[plane].group
        parts = [torch.empty_like(t) for _ in range(self.planes[plane].size)]
        torch.distributed.all_gather(parts, t.contiguous(), group=group)
        return gather_state([{name: p} for p in parts], {name: (dim, idx)})[name]

    def _gathered(self, params: dict, opt_state: dict):
        """The full parameters and moments of a tp / ep run (every rank takes
        part in each leaf's gather)."""
        params = {k: self._gather_leaf(k, v) if k in self.mp_plan else v
                  for k, v in params.items()}
        names = self._param_names()
        state = {i: {k: self._gather_leaf(names[int(i)], t) if torch.is_tensor(t)
                     and names[int(i)] in self.mp_plan and t.dim() > 0 else t
                     for k, t in st.items()} for i, st in opt_state["state"].items()}
        return params, dict(opt_state, state=state)

    def _sharded(self, params: dict):
        """A full state's shard for this rank, and the optimizer's ``place``."""
        ranks = {name: plane.rank for name, plane in self.planes.items()}
        params = {k: shard_state({k: v}, {k: self.mp_plan[k][:2]}, ranks[self.mp_plan[k][2]])[k]
                  if k in self.mp_plan else v for k, v in params.items()}
        names = self._param_names()
        flat = [p for grp in self.opt.param_groups for p in grp["params"]]

        def place(idx, t):
            name = names[idx]
            if name not in self.mp_plan or t.dim() == 0 or t.shape == flat[idx].shape:
                return t
            return shard_state({name: t}, {name: self.mp_plan[name][:2]},
                               ranks[self.mp_plan[name][2]])[name]
        return params, place

    def _full_order(self) -> tuple[list, dict]:
        """One process's optimizer order of the whole model's leaves, and
        {group label: their names} (``PPModel.layout``)."""
        meta = [(n, torch.empty(shape, device="meta")) for n, shape in self.model.layout]
        by_label = label_names(meta)
        return [n for names in by_label.values() for n in names], by_label

    def _stages_gathered(self, params: dict, opt_state: dict):
        """The whole model's parameters and moments from every stage of this
        rank's pp group (every rank takes part), in one process's optimizer
        order."""
        names = self._param_names()
        state = {names[int(i)]: st for i, st in opt_state["state"].items()}

        def host(v):
            return v.detach().cpu() if torch.is_tensor(v) else v

        mine = ({k: host(v) for k, v in params.items() if main_block(k) is not None},
                {n: {k: host(t) for k, t in st.items()} for n, st in state.items()
                 if main_block(n) is not None})
        parts = [None] * self.pp.n
        torch.distributed.all_gather_object(parts, mine, group=self.pp.group)
        params = gather_stages([params] + [p for p, _ in parts])
        for _, st in parts:
            state.update(st)
        order, by_label = self._full_order()
        index = {n: i for i, n in enumerate(order)}
        groups = [dict(g, params=[index[n] for n in by_label[g["label"]]])
                  for g in opt_state["param_groups"]]
        return params, {"state": {index[n]: state[n] for n in order if n in state},
                        "param_groups": groups}

    def _stage_of(self, params: dict, saved: dict):
        """This rank's stage of a whole state: the parameters and, in the
        rank's optimizer order, the moments."""
        params = stage_state(params, self.pp.n, self.pp.rank)
        order, _ = self._full_order()
        pos = {n: i for i, n in enumerate(self._param_names())}
        by_label = label_names([(n, p) for n, p in self.model.named_parameters()
                                if p.requires_grad])
        state = {pos[order[int(i)]]: st for i, st in saved["state"].items()
                 if order[int(i)] in pos}
        groups = [dict(g, params=[pos[n] for n in by_label[g["label"]]])
                  for g in saved["param_groups"]]
        return params, {"state": state, "param_groups": groups}

    def flush_checkpoints(self) -> None:
        """Wait for pending saves; raise a writer failure."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.flush()

    def load_checkpoint(self, path) -> None:
        self.flush_checkpoints()
        state = ckpt.load_checkpoint(path)
        if state.get("opt_state_format") != "torch":
            raise ValueError(f"{path}: not a checkpoint of the port (its optimizer state "
                             "is optax's); load its params with convert.load_jax_params")
        params = jax_to_state_dict(state["params"])
        opt_state = state["torch_opt_state"]
        place = None
        if self.fsdp:                       # re-shard the full state, moments too
            current = self.model.state_dict()
            params = {k: pmesh.like(v, current[k]) for k, v in params.items()}
            flat = [p for g in self.opt.param_groups for p in g["params"]]

            def place(idx, t):
                p = flat[idx]
                return pmesh.like(t, p) if tuple(t.shape) == tuple(p.shape) else t
        if self.mp_plan:                    # this rank's shard of the full state
            params, place = self._sharded(params)
        if self.pp_ranks:                   # this rank's stage of the full state
            params, opt_state = self._stage_of(params, opt_state)
        self.model.load_state_dict(params, strict=True)
        ckpt.load_optimizer_state(self.opt, opt_state, place=place)
        self.global_step = int(state["global_step"])
        self.metric_history = state.get("metric_history", {})
        self.epoch = int(state["epoch"]) + 1          # the saved epoch completed
        logger.info("resumed %s -> epoch %d (step %d)", path, self.epoch, self.global_step)

    # ---- the training loop -----------------------------------------------------
    def train(self, resume=None) -> None:
        if self.metrics is not None and self.provenance is not None:
            self.metrics.append_summary("provenance", self.provenance)
        path = ckpt.resolve_resume(self.ckpt_dir, resume)
        if path is not None and Path(path).exists():
            self.load_checkpoint(path)
        self.model.train()
        for epoch in range(self.epoch, self.max_epoch):
            if self.max_steps and self.global_step >= self.max_steps:
                break                                 # a resumed run already at budget
            self.epoch = epoch
            self._train_epoch()
            save_now = (epoch + 1) % self.valid_interval == 0 or epoch + 1 == self.max_epoch
            if save_now and self.dev_loaders:
                logger.info("epoch %d valid: %s", epoch, self.validate())
            if save_now:
                self.save_checkpoint()
                if self.dev_loaders:
                    self._update_best_symlinks()
                self._prune_checkpoints()
                if self.dev_loaders and self._should_early_stop():
                    break
            if self.max_steps and self.global_step >= self.max_steps:
                if not save_now:
                    self.save_checkpoint()
                break
        self._average_nbest()
        if self._ckpt_writer is not None:
            self._ckpt_writer.close()
            self._ckpt_writer = None                  # later saves run synchronously
        if self.distributed:
            # rank 0's files are on disk before any rank goes on (to read
            # them: a resume, a decode of latest.ckpt)
            torch.distributed.barrier()
        self.model.eval()
        if self.metrics is not None:
            summary = {"final_step": self.global_step, "epochs": self.epoch + 1,
                       "n_devices": self.world, "mesh": self.mesh_shape, "config": self.cfg}
            for phase, metric, mode in self.best_model_criterion:
                be = self._best_epoch(phase, metric, mode)
                if be is not None:
                    summary[f"best_{phase}_{metric}"] = self.metric_history[(phase, metric)][be]
                    summary[f"best_{phase}_{metric}_epoch"] = be
            self.metrics.update_summary(**summary)
