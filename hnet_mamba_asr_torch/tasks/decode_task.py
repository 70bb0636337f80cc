"""Decode task: a trained model -> transcripts across the 7-cell matrix,
counterpart of ``hnet_mamba_asr_tpu/tasks/decode_task.py``.

Cells are read-out x search x +/-LM: greedy is CTC only; AED and joint are
beam only; the LM lives on the beam side: first-pass shallow fusion for the
CTC prefix beam (``lm_weight``), second-pass n-best rescoring for AED and
joint (``rescore_weight`` / ``rescore_length_bonus``). The matrix:
ctc_greedy, ctc_beam, ctc_beam_lm, aed_beam, aed_beam_lm, joint_beam,
joint_beam_lm; transducer models add rnnt_greedy, rnnt_beam and rnnt_beam_lm
(first-pass fusion at ``lm_weight``, then the surviving beam re-ranked at
``rescore_weight`` with ``ctc_weight`` 0).

Engines. By default, as in the JAX package, every beam cell runs on the
device: ``decoders/device_ctc_beam.py`` for the CTC prefix beam (LM fusion
inside the frame loop), ``decoders/device_beam.py`` for the AED and joint
beams (the pool's LM scores in the same call) and
``decoders/device_rnnt_beam.py`` for the transducer beam (LM fusion inside
the frame loop), scoring in float32. ``decode.device_beam: false`` runs the
host engines instead, scoring in float64: one batched device call per
global step for AED / joint (``decode.batch_beams`` false: one utterance at
a time), one per frame for the CTC beams and one per expansion round of an
utterance's frame for the transducer (``decoders/rnnt_decode.py``). Every record states its ``engine``; the device engine's
records add their search steps and host reads.

Timing: device work is fenced with ``torch.cuda.synchronize()`` before the
clock is read, and a cell's search time is amortized over its utterances;
each record carries ``encoder_s`` and ``search_s`` beside ``decode_s``.
``decode_split_shared`` encodes each batch once and fans it out to every
cell, charging each cell its share of the encoder's seconds.
"""
from __future__ import annotations

import json
import logging
import pickle
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from hnet_mamba_asr_torch.decoders.ctc_decode import ctc_prefix_beam_search
from hnet_mamba_asr_torch.decoders.device_beam import beam_search_device
from hnet_mamba_asr_torch.decoders.device_ctc_beam import ctc_beam_search_device
from hnet_mamba_asr_torch.decoders.device_rnnt_beam import beam_decode_nbest
from hnet_mamba_asr_torch.decoders.joint import (
    Hypothesis, joint_beam_search_nbest, joint_beam_search_nbest_lockstep, lm_rescore_batch)
from hnet_mamba_asr_torch.decoders.lm_scorer import CausalLMScorer, bucket
from hnet_mamba_asr_torch.decoders.rnnt_decode import rnnt_beam_search
from hnet_mamba_asr_torch.models.aed import decode_groups
from hnet_mamba_asr_torch.models.ctc_head import greedy_decode as ctc_host_greedy
from hnet_mamba_asr_torch.models.rnnt import rnnt_host_greedy
from hnet_mamba_asr_torch.parallel.mesh import rank_rows

logger = logging.getLogger(__name__)

SAMPLE_RATE = 16000


def as_str_list(value, default: list[str]) -> list[str]:
    if value is None:
        return list(default)
    if isinstance(value, str):
        return [value]
    return [str(v) for v in value]


def expand_cells(decode_cfg: Mapping[str, Any]) -> list[dict]:
    """decode block -> ordered matrix cells (greedy CTC-only, LM on beams)."""
    dc = dict(decode_cfg or {})
    read_outs = as_str_list(dc.get("read_outs"), ["ctc"])
    searches = as_str_list(dc.get("search"), ["greedy", "beam"])
    lm_val = dc.get("lm", "none")
    with_lm = str(lm_val).lower() not in ("none", "false", "")
    cells, seen = [], set()
    for ro in read_outs:
        if ro not in ("ctc", "aed", "joint", "rnnt"):
            raise ValueError(f"unknown read_out {ro!r}")
        for s in searches:
            if s not in ("greedy", "beam"):
                raise ValueError(f"unknown search {s!r}")
            if s == "greedy" and ro not in ("ctc", "rnnt"):
                continue                # greedy: CTC frame-argmax / RNNT scan
            lm_opts = [False, True] if (s == "beam" and with_lm) else [False]
            for use_lm in lm_opts:      # every beam (incl. rnnt) gets an LM cell
                name = f"{ro}_{s}" + ("_lm" if use_lm else "")
                if name in seen:
                    continue
                seen.add(name)
                cells.append({"read_out": ro, "search": s, "lm": use_lm, "name": name})
    if not cells:
        raise ValueError(f"decode config yields no cells (read_outs={read_outs}, "
                         f"search={searches}); greedy applies to CTC only")
    return cells


def check_heads(model, cells: list[dict]) -> None:
    for c in cells:
        if c["read_out"] in ("ctc", "joint") and model.ctc is None:
            raise ValueError(f"cell {c['name']}: model has no CTC head")
        if c["read_out"] in ("aed", "joint") and model.aed is None:
            raise ValueError(f"cell {c['name']}: model has no AED head")
        if c["read_out"] == "rnnt" and model.rnnt is None:
            raise ValueError(f"cell {c['name']}: model has no RNNT head")


def engine_for(decode_cfg: Mapping[str, Any], cell: Mapping[str, Any]) -> str:
    """The search engine of a cell: greedy; device (``device_beam`` absent or
    true); or, with ``device_beam: false``, lockstep or serial (the
    transducer's host beam runs one utterance at a time)."""
    dc = dict(decode_cfg or {})
    if cell["search"] == "greedy":
        return "greedy"
    if bool(dc.get("device_beam", True)):
        return "device"
    if cell["read_out"] == "rnnt" or (cell["read_out"] != "ctc"
                                      and not bool(dc.get("batch_beams", True))):
        return "serial"
    return "lockstep"


class _ParamsUnpickler(pickle.Unpickler):
    """Unpickles a JAX package checkpoint with numpy and builtins only."""

    ALLOWED = ("numpy", "builtins", "collections", "copyreg", "_codecs")

    def find_class(self, module, name):
        if module.split(".")[0] in self.ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint holds {module}.{name}: a JAX package "
                                     "pickle checkpoint holds numpy arrays only")


def load_model_params(ckpt_path: str | Path) -> tuple[dict, dict]:
    """Weights from a JAX package pickle checkpoint (a trainer checkpoint or
    an .ave / .best file; the port's own checkpoints share the layout) ->
    (the flax param tree of numpy arrays, meta), read with pickle and numpy
    only. Load the tree with ``convert.load_jax_params``."""
    path = Path(ckpt_path)
    if path.is_dir():
        raise NotImplementedError(f"{path}: orbax checkpoints are not ported")
    with open(path, "rb") as f:
        state = _ParamsUnpickler(f).load()
    meta = {k: state[k] for k in ("epoch", "global_step", "averaged") if k in state}
    logger.info("loaded weights %s %s", path.name, meta or "")
    return state["params"], meta


def load_lm_scorer(decode_cfg: Mapping[str, Any], lm_config: Mapping[str, Any], tokenizer,
                   *, device="cuda") -> CausalLMScorer:
    """The fusion LM of ``lm_config`` (a config dict with ``lm_conf``; the
    port takes dicts, e.g. ``tools/gate.py::LM_CONFIG``) with the weights of
    ``decode.lm_checkpoint`` (a JAX package or port checkpoint), on
    ``device``; the LM shares the tokenizer's vocabulary."""
    from hnet_mamba_asr_torch.convert import load_jax_params
    from hnet_mamba_asr_torch.tasks.lm_task import build_lm
    dc = dict(decode_cfg or {})
    if not dc.get("lm_checkpoint"):
        raise ValueError("decode.lm requires decode.lm_checkpoint")
    lm = build_lm(dropless(lm_config), tokenizer.vocab_size, device=device)
    params, _ = load_model_params(dc["lm_checkpoint"])
    load_jax_params(lm, params if "lm" in params else {"lm": params})
    return CausalLMScorer(lm.lm, bos_id=tokenizer.bos_id, eos_id=tokenizer.eos_id,
                          pad_id=tokenizer.pad_id)


def dropless(lm_config: Mapping[str, Any]) -> Mapping[str, Any]:
    """An MoE LM config with capacity_factor E / top_k, as JAX's
    ``load_lm_scorer`` sets it: C >= S, so no token is dropped and a prefix's
    score never depends on what else shares the batch (and the device
    searches' dense-mix LM step is the module's function). Other configs as
    they are."""
    lc = (lm_config or {}).get("lm_conf", {}) or {}
    mc = lc.get("moe")
    if not mc:
        return lm_config
    E, k = int(mc.get("n_experts", 0)), int(mc.get("top_k", 2))
    logger.info("fusion LM is MoE (E=%d top_k=%d): dropless scoring (capacity_factor "
                "-> %.1f)", E, k, E / max(k, 1))
    return dict(lm_config, lm_conf=dict(lc, moe=dict(mc, capacity_factor=E / max(k, 1))))


def length_bonus_for(decode_cfg: Mapping[str, Any]) -> float:
    """Acoustic-beam per-token bonus; default 0.0 (the LM-side bias is
    ``rescore_length_bonus``, applied at re-rank time only)."""
    return float((decode_cfg or {}).get("length_bonus", 0.0))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CachedAEDStepper:
    """KV-cached incremental scorer of one utterance at a time for the
    label-synchronous beam: ``start(b) -> [1, V]`` feeds bos to utterance
    b; ``advance(parents, tokens) -> [n, V]`` gathers each row's cache from
    its parent row, appends the token and returns next-token log-probs.
    Rows are padded to ``bucket(beam_rows, 4)``."""

    def __init__(self, aed, features, lengths, *, beam_rows: int = 16):
        self.aed = aed
        self.features = features
        self.lengths = torch.as_tensor(np.asarray(lengths), device=features.device)
        self.rows = bucket(beam_rows, lo=4)
        self.cap = aed.max_decode_len + 1
        self._caches = self._kpm = None
        self._pos = 0

    @torch.inference_mode()
    def start(self, b: int) -> np.ndarray:
        dev = self.features.device
        mem = self.features[b:b + 1].expand(self.rows, -1, -1)
        mlen = self.lengths[b:b + 1].expand(self.rows)
        caches, self._kpm = self.aed.decode_start(mem, mlen, self.cap)
        self._groups = decode_groups([int(self.lengths[b])], self.rows)
        bos = torch.full((self.rows,), self.aed.bos_id, dtype=torch.long, device=dev)
        logp, self._caches = self.aed.decode_step(caches, self._kpm,
                                                  torch.arange(self.rows, device=dev), bos, 0,
                                                  self._groups)
        self._pos = 1
        return logp[:1].cpu().numpy()

    @torch.inference_mode()
    def advance(self, parents, tokens) -> np.ndarray:
        n = len(parents)
        par = np.zeros(self.rows, np.int64)
        tok = np.full(self.rows, self.aed.eos_id, np.int64)
        par[:n] = parents
        tok[:n] = tokens
        dev = self.features.device
        logp, self._caches = self.aed.decode_step(
            self._caches, self._kpm, torch.from_numpy(par).to(dev),
            torch.from_numpy(tok).to(dev), self._pos, self._groups)
        self._pos += 1
        return logp[:n].cpu().numpy()


class BatchedCachedAEDStepper:
    """KV-cached scorer advancing every utterance's beam in one device call.

    Utterance b owns rows [b*R, (b+1)*R) of a (B*R)-row cache; the memory
    K/V and padding mask are projected once per utterance and repeated over
    its R rows, so the parent gathers (which touch only the self-attention
    rings) never mix memories, and each step attends one utterance's R rows
    at a time (``models/aed.py::decode_groups``). The lockstep protocol:
    ``start() -> [n, 1, V]``, ``advance(parents [n, r], tokens [n, r]) ->
    [n, r, V]`` with local parent indices."""

    def __init__(self, aed, features, lengths, *, beam_rows: int = 16,
                 n_utts: int | None = None):
        self.aed = aed
        self.R = bucket(beam_rows, lo=4)
        self.B = int(features.shape[0])
        self.n = int(n_utts) if n_utts is not None else self.B
        self.cap = aed.max_decode_len + 1
        self.features = features
        self.lengths = torch.as_tensor(np.asarray(lengths), device=features.device)
        self._caches = self._kpm = None
        self._pos = 0

    @torch.inference_mode()
    def start(self) -> np.ndarray:
        dev, R = self.features.device, self.R
        rows = self.B * R
        caches, kpm = self.aed.decode_start(self.features, self.lengths, self.cap)
        caches = [{k: (torch.zeros((rows,) + v.shape[1:], dtype=v.dtype, device=dev)
                       if k in ("self_k", "self_v") else v.repeat_interleave(R, dim=0))
                   for k, v in c.items()} for c in caches]
        self._kpm = kpm.repeat_interleave(R, dim=0)
        self._groups = decode_groups(self.lengths.tolist(), R)
        bos = torch.full((rows,), self.aed.bos_id, dtype=torch.long, device=dev)
        logp, self._caches = self.aed.decode_step(caches, self._kpm,
                                                  torch.arange(rows, device=dev), bos, 0,
                                                  self._groups)
        self._pos = 1
        return logp.reshape(self.B, R, -1)[:self.n, :1].cpu().numpy()

    @torch.inference_mode()
    def advance(self, parents, tokens) -> np.ndarray:
        parents = np.asarray(parents, np.int64)
        tokens = np.asarray(tokens, np.int64)
        n, r = parents.shape
        par = np.zeros((self.B, self.R), np.int64)
        tok = np.full((self.B, self.R), self.aed.eos_id, np.int64)
        par[:n, :r] = parents
        tok[:n, :r] = tokens
        gpar = par + np.arange(self.B, dtype=np.int64)[:, None] * self.R
        dev = self.features.device
        logp, self._caches = self.aed.decode_step(
            self._caches, self._kpm, torch.from_numpy(gpar.reshape(-1)).to(dev),
            torch.from_numpy(tok.reshape(-1)).to(dev), self._pos, self._groups)
        self._pos += 1
        return logp.reshape(self.B, self.R, -1)[:n, :r].cpu().numpy()


class _UttStepper:
    """Bind a CachedAEDStepper to one utterance row of the batch."""

    def __init__(self, stepper: CachedAEDStepper, i: int):
        self._stepper = stepper
        self._i = i

    def start(self, _b: int) -> np.ndarray:
        return self._stepper.start(self._i)

    def advance(self, parents, tokens) -> np.ndarray:
        return self._stepper.advance(parents, tokens)


def _device_batch(batch: dict, device: torch.device) -> dict:
    return {"wave": torch.as_tensor(np.asarray(batch["wave"])).to(device),
            "wave_lens": torch.as_tensor(np.asarray(batch["wave_lens"])).to(device)}


@torch.inference_mode()
def encode_batch(model, batch: dict):
    """(EncoderOutput, seconds): the fenced encoder pass of a host batch."""
    device = model.device
    t0 = time.perf_counter()
    enc = model.encode(_device_batch(batch, device))
    _sync(device)
    return enc, time.perf_counter() - t0


@torch.inference_mode()
def decode_batch(model, tokenizer, batch: dict, cell: Mapping[str, Any],
                 decode_cfg: Mapping[str, Any], lm=None, enc=None,
                 enc_s: float | None = None) -> list[dict]:
    """One collated host batch through one cell -> per-utterance records
    {id, ref, hyp, decode_s, encoder_s, search_s, engine, score} (score: the
    beam's own score of hyp, after any LM re-rank; None for greedy); the device engine
    adds the batch's ``search_steps`` (frames or label steps) and
    ``host_reads`` (of its active mask).

    ``enc`` / ``enc_s``: a precomputed EncoderOutput and the encoder seconds
    to charge this cell (``decode_split_shared``)."""
    dc = dict(decode_cfg or {})
    engine = engine_for(dc, cell)
    device = model.device
    beam_size = int(dc.get("beam_size", 10))
    pre_beam = dc.get("pre_beam")
    lm_weight = float(dc.get("lm_weight", 0.0)) if cell["lm"] else 0.0
    rescore_weight = float(dc.get("rescore_weight", lm_weight)) if cell["lm"] else 0.0
    rescore_length_bonus = (float(dc.get("rescore_length_bonus", 0.0))
                            if cell["lm"] else 0.0)
    use_lm = lm if cell["lm"] else None
    if cell["lm"] and lm is None:
        raise ValueError(f"cell {cell['name']} needs decode.lm_checkpoint")
    length_bonus = length_bonus_for(dc)

    ids = batch.get("ids", [])
    n_real = int(np.asarray(batch["row_mask"]).sum())
    if enc is None:
        enc, enc_s = encode_batch(model, batch)
    enc_s = float(enc_s or 0.0)
    lengths = enc.lengths.cpu().numpy()

    hyps: list[list[int]] = []
    scores: list = []                                    # the engine's score of each hyp
    steps: dict = {}
    t0 = time.perf_counter()
    if cell["read_out"] == "ctc" and cell["search"] == "greedy":
        frame_ids = model.ctc.frame_argmax(enc.features).cpu()
        hyps = ctc_host_greedy(frame_ids, lengths, model.ctc.blank_id)[:n_real]
    elif cell["read_out"] == "rnnt" and cell["search"] == "greedy":
        hyps = rnnt_host_greedy(*model.rnnt.greedy_decode(enc.features, enc.lengths))[:n_real]
    elif cell["read_out"] == "rnnt":                     # transducer beam
        hyps = _rnnt_beam(model, enc, n_real, cell, engine, beam_size, use_lm, lm_weight,
                          rescore_weight, rescore_length_bonus, scores, steps)
    elif cell["read_out"] == "ctc":                      # prefix beam (+/-LM)
        logp = model.ctc.log_probs(enc.features)
        if engine != "device":
            logp = logp.cpu().numpy()
        _sync(device)
        dt = time.perf_counter() - t0
        enc_s += dt                                      # shared projection: amortized
        t0 += dt
        kw = dict(blank_id=model.ctc.blank_id, beam_size=beam_size,
                  pre_beam=int(pre_beam or 30), lm=use_lm, lm_weight=lm_weight,
                  scores=scores)
        if engine == "device":
            hyps = ctc_beam_search_device(logp, lengths, n_utts=n_real, **kw)
            steps = {"steps": int(logp.shape[1]), "host_reads": 0}
        else:
            hyps = ctc_prefix_beam_search(logp[:n_real], lengths[:n_real], **kw)
    else:                                                # aed / joint beam
        ctc_w = 0.0 if cell["read_out"] == "aed" else float(dc.get("ctc_weight", 0.3))
        ctc_logp = model.ctc.log_probs(enc.features) if ctc_w > 0.0 else None
        pre = int(pre_beam) if pre_beam else None
        nbest = beam_size if cell["lm"] else 1
        if engine == "device":
            nbest_all = beam_search_device(
                model.aed, enc.features, lengths, beam_size=beam_size, nbest=nbest,
                length_bonus=length_bonus, pre_beam=pre, n_utts=n_real,
                ctc_log_probs=ctc_logp, ctc_weight=ctc_w,
                blank_id=model.ctc.blank_id if model.ctc is not None else None,
                lm=use_lm, stats=steps)
        else:
            ctc_logp = ctc_logp.cpu().numpy() if ctc_logp is not None else None
            kw = dict(vocab_size=model.aed.vocab_size, beam_size=beam_size, ctc_weight=ctc_w,
                      bos_id=tokenizer.bos_id, eos_id=tokenizer.eos_id,
                      pad_id=tokenizer.pad_id,
                      blank_id=model.ctc.blank_id if model.ctc is not None else None,
                      length_bonus=length_bonus, pre_beam=pre,
                      max_decode_len=model.aed.max_decode_len)
            if engine == "lockstep":
                stepper = BatchedCachedAEDStepper(model.aed, enc.features, lengths,
                                                  beam_rows=beam_size, n_utts=n_real)
                nbest_all = joint_beam_search_nbest_lockstep(
                    lengths[:n_real], batch_stepper=stepper,
                    ctc_log_probs=ctc_logp[:n_real] if ctc_logp is not None else None,
                    nbest=nbest, **kw)
            else:                                        # serial: one utterance at a time
                stepper = CachedAEDStepper(model.aed, enc.features, lengths,
                                           beam_rows=beam_size)
                nbest_all = []
                for i in range(n_real):
                    lp_i = ctc_logp[i:i + 1, :lengths[i]] if ctc_logp is not None else None
                    nbest_all += joint_beam_search_nbest(
                        None, lengths[i:i + 1], ctc_log_probs=lp_i, nbest=nbest,
                        aed_next_logprobs=_UttStepper(stepper, i), **kw)
        if cell["lm"]:
            hyps = lm_rescore_batch(nbest_all, use_lm, rescore_weight, ctc_weight=ctc_w,
                                    length_bonus=rescore_length_bonus, scores=scores)
        else:
            hyps = [nb[0].tokens if nb else [] for nb in nbest_all]
            scores = [nb[0].score if nb else None for nb in nbest_all]
    _sync(device)
    search_s = (time.perf_counter() - t0) / max(n_real, 1)

    per_utt_enc = enc_s / max(n_real, 1)
    tokens = np.asarray(batch["tokens"])
    tlens = np.asarray(batch["token_lens"])
    records = []
    for i in range(n_real):
        ref_ids = tokens[i, :int(tlens[i])].tolist()
        records.append({"id": ids[i], "ref": tokenizer.decode(ref_ids),
                        "hyp": tokenizer.decode(hyps[i]),
                        "decode_s": round(per_utt_enc + search_s, 6),
                        "encoder_s": per_utt_enc, "search_s": search_s, "engine": engine,
                        "score": scores[i] if scores else None,
                        **({"search_steps": steps["steps"], "host_reads": steps["host_reads"]}
                           if steps else {})})
    return records


def _rnnt_beam(model, enc, n_real: int, cell, engine: str, beam_size: int, lm,
               lm_weight: float, rescore_weight: float, rescore_length_bonus: float,
               scores: list, steps: dict) -> list[list[int]]:
    """The transducer beam of a batch on ``engine``: the best hypothesis per
    utterance, or, in the LM cell, first-pass fusion at ``lm_weight`` (when
    set) and the surviving beam re-ranked by ``lm_rescore_batch`` at
    ``rescore_weight`` with ctc_weight 0 (the acoustic score in ``.aed``).
    The device engine's fused pool carries its LM log-probs (eos included)
    in ``.lm``; its ``.score`` is acoustic + lm_weight * that, on another
    scale than the host engine's label-only fused score, so the two
    engines' scores are not compared; the re-rank reads ``.aed`` and
    ``.lm``."""
    rnnt = model.rnnt
    if engine == "device":
        steps.update(steps=int(enc.features.shape[1]), host_reads=0)
    if not cell["lm"]:                                   # the best hypothesis, its score
        if engine == "device":
            ftoks, fplen, fscore = beam_decode_nbest(rnnt, enc.features, enc.lengths,
                                                     beam_size)
            best = torch.argmax(fscore, dim=1)
            ar = torch.arange(ftoks.shape[0], device=ftoks.device)
            out = rnnt_host_greedy(ftoks[ar, best], fplen[ar, best])[:n_real]
            scores.extend(fscore[ar, best][:n_real].tolist())
        else:
            nbest = rnnt_beam_search(rnnt, enc.features, enc.lengths, beam_size=beam_size,
                                     nbest=1)[:n_real]
            out = [nb[0].tokens for nb in nbest]
            scores.extend(nb[0].aed for nb in nbest)
        return out
    fuse = lm_weight != 0.0
    if engine == "device":
        res = beam_decode_nbest(rnnt, enc.features, enc.lengths, beam_size,
                                lm=lm.lm if fuse else None, lm_weight=lm_weight)
        ftoks, fplen, fscore = (r.cpu().numpy() for r in res[:3])
        flms = res[3].cpu().numpy() if fuse else None
        nbest_all = []
        for b in range(n_real):
            rows = [Hypothesis(tokens=ftoks[b, k, :fplen[b, k]].tolist(),
                               aed=float(fscore[b, k]), ctc=0.0,
                               lm=float(flms[b, k]) if fuse else None,
                               score=float(fscore[b, k])
                               + (lm_weight * float(flms[b, k]) if fuse else 0.0))
                    for k in range(fscore.shape[1]) if fscore[b, k] > -5.0e8]
            rows.sort(key=lambda h: h.score, reverse=True)
            nbest_all.append(rows[:beam_size])
    else:
        nbest_all = rnnt_beam_search(rnnt, enc.features, enc.lengths, beam_size=beam_size,
                                     nbest=beam_size, lm=lm if fuse else None,
                                     lm_weight=lm_weight)[:n_real]
    return lm_rescore_batch(nbest_all, lm, rescore_weight, ctc_weight=0.0,
                            length_bonus=rescore_length_bonus, scores=scores)


def _summary(cell: str, n: int, dec_s: float, aud_s: float, enc_s: float, search_s: float,
             engine: str) -> dict:
    return {"cell": cell, "n_utts": n, "decode_s": round(dec_s, 3), "audio_s": round(aud_s, 3),
            "rtf": round(dec_s / aud_s, 5) if aud_s > 0 else None,
            "encoder_s": enc_s, "search_s": search_s, "engine": engine}


def _rows_records(ranks, batch: dict, decode) -> list[dict]:
    """``decode(batch)``'s records over the ranks that split its rows: each
    rank decodes its row slice (none where the slice holds no real row) and
    rank 0 gets every rank's records in row order (the others get []).
    ``ranks`` = (dp index, dp count[, tp]): under decode.tp the tp ranks of
    a dp index decode the same rows, and the first one's records count."""
    rank, count = ranks[:2]
    tp = ranks[2] if len(ranks) > 2 else 1
    if count * tp == 1:
        return decode(batch)
    import torch.distributed as dist
    local = rank_rows(batch, rank, count)
    mine = decode(local) if np.asarray(local["row_mask"]).any() else []
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, mine)
    return [r for part in parts[::tp] for r in part] if dist.get_rank() == 0 else []


def _writes(ranks) -> bool:
    """Whether this rank writes a split's records: rank 0 of the group."""
    if len(ranks) > 2 and ranks[2] > 1:
        import torch.distributed as dist
        return dist.get_rank() == 0
    return ranks[0] == 0


def decode_split(model, tokenizer, loader, cell, decode_cfg, *,
                 audio_seconds: Mapping[str, float], out_path: str | Path, lm=None,
                 ranks: tuple[int, int] = (0, 1)) -> dict:
    """Decode one split through one cell; write per-utterance JSONL; return
    the summary. The first batch is encoded once, untimed, as a warm-up.
    ``ranks`` = (rank, count[, tp]): the batch rows are split over the
    ranks of the process group (its dp axis under decode.tp) and rank 0
    writes every record (``_rows_records``)."""
    out_path = Path(out_path)
    main = _writes(ranks)
    if main:
        out_path.parent.mkdir(parents=True, exist_ok=True)
    warm = next(iter(loader), None)
    if warm is not None:
        encode_batch(model, rank_rows(warm, *ranks[:2]))
    n, dec_s, aud_s, enc_s, search_s = 0, 0.0, 0.0, 0.0, 0.0
    engine = engine_for(decode_cfg, cell)
    with open(out_path, "w", encoding="utf-8") if main else nullcontext() as w:
        for batch in loader:
            for r in _rows_records(ranks, batch, lambda b: decode_batch(
                    model, tokenizer, b, cell, decode_cfg, lm=lm)):
                r["audio_s"] = round(audio_seconds.get(r["id"], 0.0), 3)
                w.write(json.dumps(r) + "\n")
                n += 1
                dec_s += r["decode_s"]
                aud_s += r["audio_s"]
                enc_s += r["encoder_s"]
                search_s += r["search_s"]
    summary = _summary(cell["name"], n, dec_s, aud_s, enc_s, search_s, engine)
    logger.info("decoded %s: %s", out_path.name, summary)
    return summary


def decode_split_shared(model, tokenizer, loader, cells, decode_cfg, *,
                        audio_seconds: Mapping[str, float], out_dir: str | Path, split: str,
                        lm=None, ranks: tuple[int, int] = (0, 1)) -> list[dict]:
    """Decode one split through every cell with ONE encoder pass per batch:
    each batch is encoded once and fanned out to every cell, whose records
    are charged the encoder's seconds divided by the cell count. Writes
    ``<out_dir>/<cell>/<split>.jsonl`` (rank 0; ``ranks`` as in
    ``decode_split``)."""
    out_dir = Path(out_dir)
    main = _writes(ranks)
    writers = {}
    for cell in cells if main else ():
        path = out_dir / cell["name"] / f"{split}.jsonl"
        path.parent.mkdir(parents=True, exist_ok=True)
        writers[cell["name"]] = open(path, "w", encoding="utf-8")
    totals = {c["name"]: [0, 0.0, 0.0, 0.0, 0.0] for c in cells}

    def all_cells(local: dict) -> list[dict]:
        enc, enc_s = encode_batch(model, local)
        return [dict(r, cell=cell["name"]) for cell in cells
                for r in decode_batch(model, tokenizer, local, cell, decode_cfg, lm=lm,
                                      enc=enc, enc_s=enc_s / len(cells))]

    try:
        warm = False
        for batch in loader:
            if not warm:                                 # untimed warm-up
                encode_batch(model, rank_rows(batch, *ranks[:2]))
                warm = True
            recs_all = _rows_records(ranks, batch, all_cells)
            for cell in cells:
                recs = [{k: v for k, v in r.items() if k != "cell"} for r in recs_all
                        if r["cell"] == cell["name"]]
                t = totals[cell["name"]]
                for r in recs:
                    r["audio_s"] = round(audio_seconds.get(r["id"], 0.0), 3)
                    writers[cell["name"]].write(json.dumps(r) + "\n")
                    t[0] += 1
                    t[1] += r["decode_s"]
                    t[2] += r["audio_s"]
                    t[3] += r["encoder_s"]
                    t[4] += r["search_s"]
    finally:
        for w in writers.values():
            w.close()
    summaries = [_summary(c["name"], *totals[c["name"]], engine_for(decode_cfg, c))
                 for c in cells]
    for s in summaries:
        logger.info("decoded %s/%s (shared encoder): %s", s["cell"], split, s)
    return summaries


def audio_seconds_from_manifest(manifest_path: str | Path) -> dict[str, float]:
    out = {}
    with open(manifest_path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                e = json.loads(line)
                out[e["id"]] = e["frames"] / SAMPLE_RATE
    return out
