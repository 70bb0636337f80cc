"""Serving runtime: the offline serving forward in eager PyTorch.

Counterpart of ``hnet_mamba_asr_tpu/serving/runtime.py``'s ``ServingModel``
for the emit modes that ``scripts/export_serving.py`` exports: raw padded
waveform -> log-mel -> CMVN -> encoder, then per mode the CTC frame argmax
(``frame_ids``, collapsed on the host), the CTC log-probs (``log_probs``),
the AED head's KV-cached greedy decode (``aed_ids``, eos-filled after the
first eos), the device CTC prefix beam (``beam_ids`` / ``beam_lens``,
``decoders/device_ctc_beam.py::beam_scan``), the RNN-T head's greedy search
(``rnnt_ids`` / ``rnnt_lens``) or its device beam (``rnnt_beam_ids`` /
``rnnt_beam_lens``, ``decoders/device_rnnt_beam.py::beam_decode``), as JAX's
``serving/export.py`` defines them. PyTorch runs eagerly, so a call runs at
its own shape: the (batch, samples) buckets only bound what a call may
hold, and fail with the JAX runtime's words.

Streaming (JAX's ``StreamingServingModel`` and ``StreamingSessionPool``):
``StreamingSessionPool`` advances up to ``batch`` concurrent sessions a tick
through the step JAX's ``serving/export.py::save_streaming_artifact``
builds: log-mel and CMVN on the device over the window of samples, the
exact-causal encoder step (``models/streaming.py::CausalStreamingEncoder``,
fp32, carried states), then the CTC frame argmax (collapsed on the host with
a carried previous id) or, for a model with no CTC head, the transducer's
greedy search (the label history carried) or its beam (the beam carried;
the running best is a ``partial`` until ``finish``). ``StreamingServingModel``
is one session of a pool of one.

Weights come from a JAX param tree or ``params.npz`` (``convert.py``), or are
drawn from a seed.

Artifacts (``serving/export.py``): ``load_serving_artifact``,
``load_streaming_artifact`` and ``load_streaming_pool`` read an artifact
directory, the port's or one that JAX's ``save_serving_artifact`` /
``save_streaming_artifact`` wrote, check its ``format_version``, dequantize
an int8 ``params.npz`` once (``serving/quant.py``), and rebuild the model
from the manifest's config (a JAX artifact carries none: pass ``config=``;
its traced ``.shlo`` programs are not read).
"""
from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import torch

from hnet_mamba_asr_torch.convert import load_jax_params, load_params_npz
from hnet_mamba_asr_torch.data.features import GlobalCMVN
from hnet_mamba_asr_torch.decoders.device_ctc_beam import beam_scan
from hnet_mamba_asr_torch.decoders.device_rnnt_beam import beam_decode, beam_decode_nbest
from hnet_mamba_asr_torch.models.aed import strip_hypothesis
# the CTC collapse of repeats and blanks, per valid row span
from hnet_mamba_asr_torch.models.ctc_head import greedy_decode as collapse_ctc
from hnet_mamba_asr_torch.models.mamba2 import STREAM_ROWS
from hnet_mamba_asr_torch.models.streaming import (
    CausalStreamingEncoder, SampleBuffer, collapse, subsampled_count)
from hnet_mamba_asr_torch.serving.quant import dequantize_tree
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_torch.tasks.build import REPO_ROOT, build_cmvn

EMIT_MODES = ("frame_ids", "log_probs", "aed_ids", "beam_ids", "rnnt_ids", "rnnt_beam_ids")
BEAM_SIZE, PRE_BEAM = 10, 30    # the beams' width: the JAX export's defaults
DEFAULT_BUCKETS = ((8, 40 * 16000),)    # (batch, samples): 8 calls of up to 40 s
FORMAT_VERSION = 1              # the artifact format, as JAX's runtime reads it


def detokenize(tok_meta: dict, ids) -> str:
    """ids -> text from a tokenizer table shaped like a JAX serving manifest's
    ``tokenizer`` entry: drop specials and out-of-range ids, join the pieces,
    map the word boundary to a space."""
    pieces = tok_meta["pieces"]
    drop = set(tok_meta.get("drop_ids", ()))
    wb = tok_meta.get("word_boundary", "▁")
    out = [pieces[int(i)] for i in ids
           if 0 <= int(i) < len(pieces) and int(i) not in drop]
    return "".join(out).replace(wb, " ").strip()


def ids_per_row(out: dict, blank_id: int | None, eos_id: int | None) -> list[list[int]]:
    """Token ids per utterance from a serving call's outputs, in the JAX
    runtime's precedence: the CTC prefix beam beats CTC greedy, which beats
    the RNN-T beam, which beats RNN-T greedy, which beats the AED greedy
    decode (cut at its first eos)."""
    for key, lens in (("beam_ids", "beam_lens"), ("frame_ids", None),
                      ("rnnt_beam_ids", "rnnt_beam_lens"), ("rnnt_ids", "rnnt_lens")):
        if key in out and lens is None:
            return collapse_ctc(out[key], out["enc_lengths"], blank_id)
        if key in out:
            return [row[:int(n)].tolist() for row, n in zip(out[key], out[lens])]
    if "aed_ids" in out:
        return [strip_hypothesis(row, eos_id) for row in out["aed_ids"]]
    raise ValueError(f"outputs {sorted(out)} hold no frame_ids, beam_ids, rnnt_ids, "
                     "rnnt_beam_ids or aed_ids")


def require_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device without a card raises
    (there is no quiet fall-back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available "
                           "(torch.cuda.is_available() is false); pass device 'cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def load_model(config: dict, params, device, vocab_size: int | None = None,
               cmvn: GlobalCMVN | str | Path | None = None, seed: int = 0):
    """-> (the model of ``config`` on ``device`` with the weights of
    ``params`` (a JAX param tree or the path of a ``params.npz``), or drawn
    from ``seed`` when it is None, and its vocabulary size)."""
    device = require_device(device)
    if isinstance(params, (str, Path)):
        params = load_params_npz(params)
    if vocab_size is None:
        if params is None:
            raise ValueError("vocab_size is required for seeded weights")
        vocab_size = (int(np.asarray(params["ctc"]["proj"]["kernel"]).shape[1]) - 1
                      if "ctc" in params else
                      int(np.asarray(params["rnnt"]["out"]["kernel"]).shape[1]) - 1)
    if isinstance(cmvn, (str, Path)):
        cmvn = GlobalCMVN.load(cmvn)
    model = build_model(config, vocab_size, cmvn=cmvn, seed=seed, device=device)
    if params is not None:
        load_jax_params(model, params)
    return model, int(vocab_size)


class ServingModel:
    """Callable serving model: ``(wave [B, S], wave_lens [B]) ->
    {enc_lengths, <emit modes>}`` as numpy arrays.

    ``params``: a JAX param tree, the path of a JAX ``params.npz``, or None
    for weights drawn from ``seed`` (then ``vocab_size`` is required).
    ``tokenizer``: an optional table as in a JAX manifest, for text output.
    ``buckets``: the (batch, samples) shapes a call must fit in one of.
    ``beam_size`` /
    ``pre_beam``: the ``beam_ids`` and ``rnnt_beam_ids`` beams.
    ``device``: the card by default; pass "cpu" for the plain path.
    """

    def __init__(self, config: dict, params=None, device="cuda", *,
                 vocab_size: int | None = None,
                 cmvn: GlobalCMVN | str | Path | None = None,
                 tokenizer: dict | None = None, seed: int = 0,
                 buckets: list[tuple[int, int]] = DEFAULT_BUCKETS,
                 emit: tuple[str, ...] = ("frame_ids",),
                 beam_size: int = BEAM_SIZE, pre_beam: int = PRE_BEAM):
        emit = tuple(emit)
        for e in emit:
            if e not in EMIT_MODES:
                raise ValueError(f"unknown emit mode {e!r}; choices: {EMIT_MODES}")
        self.device = torch.device(device)
        model, vocab_size = load_model(config, params, self.device, vocab_size, cmvn, seed)
        for e in emit:
            name = "AED" if e == "aed_ids" else "RNNT" if e.startswith("rnnt") else "CTC"
            if getattr(model, name.lower()) is None:
                raise ValueError(f"emit mode {e!r} needs the model's {name} head")
        self.model = model
        self.vocab_size = int(vocab_size)
        self.blank_id = model.ctc.blank_id if model.ctc is not None else None
        self.eos_id = model.aed.eos_id if model.aed is not None else None
        self.emit = emit
        self.tokenizer = tokenizer
        self._buckets = sorted({(int(b), int(n)) for b, n in buckets})
        if not self._buckets:
            raise ValueError("artifact has no shape buckets")
        self.max_batch = max(b for b, _ in self._buckets)
        self.max_samples = max(n for _, n in self._buckets)
        self.beam_size, self.pre_beam = int(beam_size), int(pre_beam)
        self.manifest: dict | None = None    # an artifact's, when loaded from one
        self.calls = 0                       # model forwards run

    @property
    def buckets(self) -> list[tuple[int, int]]:
        """The (batch, samples) limits, in the JAX runtime's terms."""
        return list(self._buckets)

    def fits(self, batch: int, samples: int) -> bool:
        """Whether a call of ``batch`` rows of ``samples`` fits a bucket."""
        return any(b >= batch and n >= samples for b, n in self._buckets)

    @torch.inference_mode()
    def __call__(self, wave, wave_lens) -> dict:
        wave = np.asarray(wave, np.float32)
        wave_lens = np.asarray(wave_lens, np.int64)
        B, S = wave.shape
        if not self.fits(B, S):
            raise ValueError(
                f"no bucket fits batch={B} samples={S}; available: "
                f"{self.buckets} (longer audio must be chunked upstream)")
        batch = {"wave": torch.from_numpy(wave).to(self.device),
                 "wave_lens": torch.from_numpy(wave_lens).to(self.device)}
        enc = self.model.encode(batch)
        self.calls += 1
        out = {"enc_lengths": enc.lengths}
        if "frame_ids" in self.emit:
            out["frame_ids"] = self.model.ctc.frame_argmax(enc.features)
        if "log_probs" in self.emit or "beam_ids" in self.emit:
            logp = self.model.ctc.log_probs(enc.features)
            if "log_probs" in self.emit:
                out["log_probs"] = logp
            if "beam_ids" in self.emit:
                out["beam_ids"], out["beam_lens"] = beam_scan(
                    logp, enc.lengths, beam_size=self.beam_size, pre_beam=self.pre_beam,
                    blank_id=self.blank_id)
        if "aed_ids" in self.emit:
            out["aed_ids"] = self.model.aed.greedy_decode(enc.features, enc.lengths)
        if "rnnt_ids" in self.emit:
            out["rnnt_ids"], out["rnnt_lens"] = self.model.rnnt.greedy_decode(
                enc.features, enc.lengths)
        if "rnnt_beam_ids" in self.emit:
            out["rnnt_beam_ids"], out["rnnt_beam_lens"] = beam_decode(
                self.model.rnnt, enc.features, enc.lengths, self.beam_size)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def transcribe_ids(self, wave, wave_lens) -> list[list[int]]:
        """Token ids per utterance, in ``ids_per_row``'s precedence."""
        return ids_per_row(self(wave, wave_lens), self.blank_id, self.eos_id)

    def transcribe_text(self, wave, wave_lens) -> list[str]:
        if self.tokenizer is None:
            raise ValueError("no tokenizer table given: pass tokenizer= or "
                             "consume transcribe_ids() instead")
        return [detokenize(self.tokenizer, ids)
                for ids in self.transcribe_ids(wave, wave_lens)]


# ---- streaming ------------------------------------------------------------------
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _tree_cat(rows: list):
    """One-row state trees -> one tree of their rows, in order."""
    first = rows[0]
    if isinstance(first, dict):
        return {k: _tree_cat([r[k] for r in rows]) for k in first}
    if isinstance(first, list):
        return [_tree_cat([r[i] for r in rows]) for i in range(len(first))]
    return torch.cat(rows, dim=0)


class _StreamSession:
    __slots__ = ("buf", "e0", "prev", "states", "pending", "finishing", "target_enc",
                 "partial")

    def __init__(self, states, hop: int, win: int):
        self.buf = SampleBuffer(hop, win)
        self.e0 = 0                              # encoder frames emitted
        self.prev = -1                           # the CTC collapse's carry
        self.states = states                     # one-row tree, or None while pooled
        self.pending: list[int] = []             # ids the ticks emitted
        self.finishing = False
        self.target_enc = 0
        self.partial: list[int] = []             # beam: the running best


class StreamingSessionPool:
    """Multi-session streaming transcription: one step advances up to
    ``batch`` concurrent sessions a block of ``block_enc`` encoder frames
    (640 ms of audio at 16, the default).

    ``open()`` -> sid; ``feed(sid, samples)`` -> the token ids that became
    final; ``finish(sid)`` drains the zero-padded tail (causal-safe) and
    frees the session; ``partial(sid)``: a beam session's running best.
    Sessions map to rows only for a tick. While the slot layout stays the
    same from tick to tick, the pooled state stays on the card as the step
    left it; a change of layout gathers each session's rows back first. Every
    op of the step is per row (its GEMMs in fixed row blocks), so a session
    pooled gives what it gives alone. Thread-safe: concurrent feeds coalesce
    into shared ticks (``_drain``); the lock is released during each step.

    ``config`` and ``params`` as for ``ServingModel``; ``decode`` "greedy"
    or "beam" (a transducer-only model's beam of ``beam_size`` over a token
    buffer of ``token_buf_len``). The transducer is chosen, as in JAX, when
    the model has no CTC head. The step runs on the card unless ``device``
    is "cpu".
    """

    def __init__(self, config: dict, params=None, device="cuda", *, block_enc: int = 16,
                 batch: int = 1, decode: str = "greedy", beam_size: int = 8,
                 token_buf_len: int = 256, cmvn: GlobalCMVN | str | Path | None = None,
                 tokenizer: dict | None = None, seed: int = 0, vocab_size: int | None = None):
        if int(batch) < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if decode not in ("greedy", "beam"):
            raise ValueError(f"decode must be greedy|beam, got {decode!r}")
        self.device = torch.device(device)
        model, self.vocab_size = load_model(config, params, self.device, vocab_size, cmvn, seed)
        self._rnnt = model.ctc is None and model.rnnt is not None
        if model.ctc is None and not self._rnnt:
            raise ValueError("streaming serving requires a CTC or RNNT head")
        self._beam = decode == "beam"
        if self._beam and not self._rnnt:
            raise ValueError("decode='beam' requires an RNNT-only model (the transducer "
                             "beam is the streaming-exact one)")
        self.model, self.tokenizer = model, tokenizer
        self.encoder = CausalStreamingEncoder(model, block_enc=block_enc)
        self.B, self.E = int(batch), self.encoder.E
        self.hop, self.win, self.S_win = self.encoder.hop, self.encoder.win, self.encoder.S_win
        self.blank_id = model.ctc.blank_id if model.ctc is not None else model.rnnt.blank_id
        self.beam_size, self.token_buf_len = int(beam_size), int(token_buf_len)
        self._template = self._fresh_row()
        self._sessions: dict[int, _StreamSession] = {}
        self._next_sid = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._draining = False
        self._resident = None           # (pooled state tree on the device, slot sids)
        self.n_ticks = 0                # steps run (coalescing evidence)

    def _fresh_row(self) -> dict:
        st = {"encoder": self.encoder.fresh_states(1)}
        dev = self.device
        if self._rnnt and self._beam:
            K, L = self.beam_size, self.token_buf_len
            score = torch.full((1, K), -1.0e30, device=dev)
            score[:, 0] = 0.0
            st["beam"] = [torch.zeros((1, K, L), dtype=torch.long, device=dev),
                          torch.zeros((1, K), dtype=torch.long, device=dev), score]
        elif self._rnnt:
            st["hist"] = torch.full((1, self.model.rnnt.context), self.model.rnnt.bos_id,
                                    dtype=torch.long, device=dev)
        return st

    @torch.inference_mode()
    def step(self, wave: torch.Tensor, n_valid: torch.Tensor, states: dict):
        """The device step over B rows: wave [B, S_win], n_valid [B] ->
        (CTC frame ids [B, E], or the transducer's (tokens, lengths)), the
        new states."""
        x, enc = self.encoder.step_wave(wave, states["encoder"])
        if not self._rnnt:
            return self.model.ctc.frame_argmax(x, STREAM_ROWS), {"encoder": enc}
        rnnt = self.model.rnnt
        if self._beam:
            ftoks, fplen, fscore = beam_decode_nbest(rnnt, x, n_valid, self.beam_size,
                                                     state=states["beam"])
            best = torch.argmax(fscore, dim=1)
            ar = torch.arange(x.shape[0], device=x.device)
            return ((ftoks[ar, best], fplen[ar, best]),
                    {"encoder": enc, "beam": [ftoks, fplen, fscore]})
        toks, lens, hist = rnnt.greedy_decode(x, n_valid, hist=states["hist"], return_hist=True)
        return (toks, lens), {"encoder": enc, "hist": hist}

    # ---- sessions -----------------------------------------------------------------
    def _session(self, sid: int) -> _StreamSession:
        ses = self._sessions.get(sid)
        if ses is None:
            raise ValueError(f"unknown or closed session {sid}")
        return ses

    def open(self) -> int:
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            self._sessions[sid] = _StreamSession(self._template, self.hop, self.win)
            return sid

    def close(self, sid: int) -> None:
        with self._lock:
            self._sessions.pop(sid, None)

    @property
    def active(self) -> int:
        with self._lock:
            return len(self._sessions)

    def feed(self, sid: int, samples) -> list[int]:
        """Add samples to a session; -> the token ids that became final (for
        any progress a tick made on it; a beam session's are [])."""
        return self.feed_many([(sid, samples)])[sid]

    def feed_many(self, items) -> dict[int, list[int]]:
        """Deposit audio for several sessions, then drain once, so that every
        ready session shares the ticks. ``items``: (sid, samples) pairs ->
        {sid: new final ids}."""
        with self._cond:
            sids = []
            for sid, samples in items:
                ses = self._session(sid)
                if ses.finishing:
                    raise ValueError(f"session {sid} is finished")
                ses.buf.add(samples)
                sids.append(sid)
            self._drain(tuple(sids))
            out = {}
            for sid in sids:
                ses = self._session(sid)
                out[sid], ses.pending = ses.pending, []
            return out

    def finish(self, sid: int) -> list[int]:
        """Drain a session's tail and close it: -> its last final ids (a beam
        session's whole transcript)."""
        with self._cond:
            ses = self._session(sid)
            ses.finishing = True
            ses.target_enc = max(0, subsampled_count(ses.buf.mel_ready()))
            self._drain((sid,))
            out = list(ses.partial) if self._beam else ses.pending
            del self._sessions[sid]
            return out

    def partial(self, sid: int) -> list[int]:
        """A beam session's current best whole hypothesis (it may change)."""
        with self._lock:
            return list(self._session(sid).partial)

    # ---- pooled ticks ---------------------------------------------------------------
    def _ready(self, ses: _StreamSession) -> int:
        """Encoder frames a tick can make final for this session (0: none)."""
        if ses.buf.mel_ready() >= 4 * (ses.e0 + self.E) + 4:
            return self.E
        if ses.finishing and ses.target_enc > ses.e0:
            return min(self.E, ses.target_enc - ses.e0)
        return 0

    def _drain(self, interest) -> None:
        """Caller holds the lock. One drainer at a time ticks every ready
        session until none is; the lock is released during each step, so
        other threads deposit meanwhile and the drainer's next scan takes
        them into the same ticks. A caller returns as soon as none of its
        ``interest`` sessions is ready, and does not wait behind another
        drain (that would admit one deposit a drain and serialize the pool
        into ticks of one)."""
        while True:
            if not any((ses := self._sessions.get(sid)) is not None and self._ready(ses)
                       for sid in interest):
                return
            if self._draining:
                self._cond.wait()
                continue
            self._draining = True
            try:
                while True:
                    ready = [(sid, n) for sid, ses in self._sessions.items()
                             if (n := self._ready(ses)) > 0]
                    if not ready:
                        break
                    for i in range(0, len(ready), self.B):
                        self._tick(ready[i:i + self.B])
            finally:
                self._draining = False
                self._cond.notify_all()

    def _unpool(self) -> None:
        """Hand the resident pooled rows back to their sessions (on the device)."""
        if self._resident is None:
            return
        states, slots = self._resident
        self._resident = None
        for slot, sid in enumerate(slots):
            ses = self._sessions.get(sid)
            if ses is not None:
                ses.states = _tree_map(lambda t: t[slot:slot + 1], states)

    def _tick(self, group: list) -> None:
        """One pooled step over ``group`` = [(sid, frames)]. The caller, the
        drainer, holds the lock; it is released for the step, and sessions
        closed meanwhile are skipped after it."""
        group = [(sid, n) for sid, n in group if sid in self._sessions]
        if not group:
            return
        sids = tuple(sid for sid, _ in group)
        wave = np.zeros((self.B, self.S_win), np.float32)
        n_valid = np.zeros(self.B, np.int64)
        for slot, (sid, n) in enumerate(group):
            ses = self._sessions[sid]
            wave[slot] = ses.buf.window(4 * ses.e0 * self.hop, self.S_win)
            n_valid[slot] = n
        if self._resident is not None and self._resident[1] == sids:
            states = self._resident[0]           # the last tick's, never left the card
        else:
            self._unpool()
            rows = [self._sessions[sid].states for sid in sids]
            states = _tree_cat(rows + [self._template] * (self.B - len(rows)))
        self.n_ticks += 1
        self._cond.release()
        try:
            out, states = self.step(torch.from_numpy(wave).to(self.device),
                                    torch.from_numpy(n_valid).to(self.device), states)
            out = [o.cpu().numpy() for o in out] if self._rnnt else out.cpu().numpy()
        finally:
            self._cond.acquire()
        self._resident = (states, sids)
        for slot, (sid, n) in enumerate(group):
            ses = self._sessions.get(sid)
            if ses is None:                      # closed during the step
                continue
            ses.states = None                    # its rows are resident
            ses.e0 += n
            ses.buf.drop_before(4 * ses.e0 * self.hop)
            if not self._rnnt:
                toks, ses.prev = collapse(out[slot, :n], ses.prev, self.blank_id)
                ses.pending += toks
                continue
            final = out[0][slot, :int(out[1][slot])].tolist()
            if self._beam:
                ses.partial = final              # the whole best so far: replaces
            else:
                ses.pending += final


class StreamingServingModel:
    """One streaming session (a ``StreamingSessionPool`` of one): ``feed``
    any number of samples -> the token ids that became final, with one
    block's latency; ``finish()`` drains the tail and starts a new
    utterance; a beam's ``feed`` returns [] and ``partial`` its running best,
    ``finish`` the final transcript. Arguments as for the pool; ``batch``
    must be 1."""

    def __init__(self, config: dict, params=None, device="cuda", *, batch: int = 1, **kw):
        if int(batch) != 1:
            raise ValueError(f"batch {batch}: StreamingServingModel serves one session — use "
                             "StreamingSessionPool for multi-session streaming")
        self.pool = StreamingSessionPool(config, params, device, batch=1, **kw)
        self._sid = self.pool.open()

    def reset(self) -> None:
        self.pool.close(self._sid)
        self._sid = self.pool.open()

    def feed(self, samples) -> list[int]:
        return self.pool.feed(self._sid, samples)

    @property
    def partial(self) -> list[int]:
        return self.pool.partial(self._sid)

    def finish(self) -> list[int]:
        out = self.pool.finish(self._sid)
        self._sid = self.pool.open()
        return out


# ---- artifacts ------------------------------------------------------------------
def _cmvn_from(mean, istd) -> GlobalCMVN:
    """A GlobalCMVN holding exactly these statistics (no 1 / (1 / istd))."""
    cmvn = GlobalCMVN(mean, np.ones_like(mean))
    cmvn.istd = np.asarray(istd, dtype=np.float32)
    return cmvn


def read_artifact(artifact_dir: str | Path, config: dict | None = None, cmvn=None):
    """An artifact directory -> (manifest, config, fp32 param tree, CMVN).

    The config is the caller's, else the manifest's (the port's artifacts
    carry it; a JAX artifact does not, and then ``config`` is required). The
    CMVN is the caller's, else the artifact's ``cmvn.npz``, else (a JAX
    artifact, whose programs hold it) the file the config names
    (``tasks/build.py::build_cmvn``; a relative path resolves against the
    repository root, as the command-line tools resolve the config's paths)."""
    d = Path(artifact_dir)
    manifest = json.loads((d / "manifest.json").read_text())
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"artifact format {manifest.get('format_version')!r} != "
            f"supported {FORMAT_VERSION} — re-export with this runtime")
    port = manifest.get("runtime") == "torch"
    if config is None and port and isinstance(manifest.get("config"), dict):
        config = manifest["config"]
    if config is None:
        raise ValueError(f"{d}: the artifact carries no config (a JAX export): pass "
                         "config=, the model config it was exported from")
    params = dequantize_tree(load_params_npz(d / "params.npz"))   # int8 -> fp32, once
    if cmvn is None:
        if port and manifest.get("cmvn"):
            with np.load(d / manifest["cmvn"]) as z:
                cmvn = _cmvn_from(z["mean"], z["istd"])
        elif not port:
            cmvn = build_cmvn(config, REPO_ROOT)
    return manifest, config, params, cmvn


def load_serving_artifact(artifact_dir: str | Path, device="cuda", config: dict | None = None,
                          cmvn=None) -> ServingModel:
    """An offline artifact -> its ``ServingModel`` on ``device`` (the card by
    default): the manifest's emit modes, buckets, beam, tokenizer table and
    vocabulary."""
    manifest, config, params, cmvn = read_artifact(artifact_dir, config, cmvn)
    if manifest.get("kind") == "streaming":
        raise ValueError("a streaming artifact — use load_streaming_artifact or "
                         "load_streaming_pool")
    beam = manifest.get("beam") or {}
    model = ServingModel(config, params, device, vocab_size=int(manifest["vocab_size"]),
                         cmvn=cmvn, tokenizer=manifest.get("tokenizer"),
                         buckets=[(b["batch"], b["samples"]) for b in manifest["buckets"]],
                         emit=tuple(manifest["emit"]),
                         beam_size=beam.get("beam_size", BEAM_SIZE),
                         pre_beam=beam.get("pre_beam", PRE_BEAM))
    model.manifest = manifest
    return model


def _stream_kw(artifact_dir, device, config, cmvn) -> dict:
    manifest, config, params, cmvn = read_artifact(artifact_dir, config, cmvn)
    if manifest.get("kind") != "streaming":
        raise ValueError("not a streaming artifact — use load_serving_artifact for "
                         "offline kinds")
    s = manifest["streaming"]
    return dict(config=config, params=params, device=device,
                block_enc=int(s["block_enc"]), batch=int(s.get("batch", 1)),
                decode=s.get("decode", "greedy"), beam_size=int(s.get("beam_size", 8)),
                token_buf_len=int(s.get("token_buf_len", 256)), cmvn=cmvn,
                tokenizer=manifest.get("tokenizer"), vocab_size=int(manifest["vocab_size"]))


def load_streaming_pool(artifact_dir: str | Path, device="cuda", config: dict | None = None,
                        cmvn=None) -> StreamingSessionPool:
    """A streaming artifact -> its ``StreamingSessionPool`` (the manifest's
    batch, block, decode, beam and token buffer) on ``device``."""
    return StreamingSessionPool(**_stream_kw(artifact_dir, device, config, cmvn))


def load_streaming_artifact(artifact_dir: str | Path, device="cuda",
                            config: dict | None = None, cmvn=None) -> StreamingServingModel:
    """A streaming artifact exported at batch 1 -> one ``StreamingServingModel``."""
    kw = _stream_kw(artifact_dir, device, config, cmvn)
    if kw["batch"] != 1:
        raise ValueError(f"artifact exported at batch {kw['batch']} — use "
                         "StreamingSessionPool for multi-session artifacts")
    return StreamingServingModel(**kw)
