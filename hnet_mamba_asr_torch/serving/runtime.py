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
``serving/export.py`` defines them. PyTorch runs eagerly, so there
are no shape buckets; the ``max_batch`` and ``max_samples`` limits take
their place and fail with the JAX runtime's words.

Weights come from a JAX param tree or ``params.npz`` (``convert.py``), or are
drawn from a seed.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from hnet_mamba_asr_torch.convert import load_jax_params, load_params_npz
from hnet_mamba_asr_torch.data.features import GlobalCMVN
from hnet_mamba_asr_torch.decoders.device_ctc_beam import beam_scan
from hnet_mamba_asr_torch.decoders.device_rnnt_beam import beam_decode
from hnet_mamba_asr_torch.models.aed import strip_hypothesis
# the CTC collapse of repeats and blanks, per valid row span
from hnet_mamba_asr_torch.models.ctc_head import greedy_decode as collapse_ctc
from hnet_mamba_asr_torch.tasks.asr_task import build_model

EMIT_MODES = ("frame_ids", "log_probs", "aed_ids", "beam_ids", "rnnt_ids", "rnnt_beam_ids")
BEAM_SIZE, PRE_BEAM = 10, 30    # the beams' width: the JAX export's defaults


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


class ServingModel:
    """Callable serving model: ``(wave [B, S], wave_lens [B]) ->
    {enc_lengths, <emit modes>}`` as numpy arrays.

    ``params``: a JAX param tree, the path of a JAX ``params.npz``, or None
    for weights drawn from ``seed`` (then ``vocab_size`` is required).
    ``tokenizer``: an optional table as in a JAX manifest, for text output.
    ``device``: the card by default; pass "cpu" for the plain path.
    """

    def __init__(self, config: dict, params=None, device="cuda", *,
                 vocab_size: int | None = None,
                 cmvn: GlobalCMVN | str | Path | None = None,
                 tokenizer: dict | None = None, seed: int = 0,
                 max_batch: int = 8, max_samples: int = 40 * 16000,
                 emit: tuple[str, ...] = ("frame_ids",)):
        emit = tuple(emit)
        for e in emit:
            if e not in EMIT_MODES:
                raise ValueError(f"unknown emit mode {e!r}; choices: {EMIT_MODES}")
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
        self.device = torch.device(device)
        model = build_model(config, vocab_size, cmvn=cmvn, seed=seed, device=self.device)
        for e in emit:
            name = "AED" if e == "aed_ids" else "RNNT" if e.startswith("rnnt") else "CTC"
            if getattr(model, name.lower()) is None:
                raise ValueError(f"emit mode {e!r} needs the model's {name} head")
        if params is not None:
            load_jax_params(model, params)
        self.model = model
        self.vocab_size = int(vocab_size)
        self.blank_id = model.ctc.blank_id if model.ctc is not None else None
        self.eos_id = model.aed.eos_id if model.aed is not None else None
        self.emit = emit
        self.tokenizer = tokenizer
        self.max_batch, self.max_samples = int(max_batch), int(max_samples)
        self.calls = 0                       # model forwards run

    @property
    def buckets(self) -> list[tuple[int, int]]:
        """The one (batch, samples) limit, in the JAX runtime's terms."""
        return [(self.max_batch, self.max_samples)]

    @torch.inference_mode()
    def __call__(self, wave, wave_lens) -> dict:
        wave = np.asarray(wave, np.float32)
        wave_lens = np.asarray(wave_lens, np.int64)
        B, S = wave.shape
        if B > self.max_batch or S > self.max_samples:
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
                    logp, enc.lengths, beam_size=BEAM_SIZE, pre_beam=PRE_BEAM,
                    blank_id=self.blank_id)
        if "aed_ids" in self.emit:
            out["aed_ids"] = self.model.aed.greedy_decode(enc.features, enc.lengths)
        if "rnnt_ids" in self.emit:
            out["rnnt_ids"], out["rnnt_lens"] = self.model.rnnt.greedy_decode(
                enc.features, enc.lengths)
        if "rnnt_beam_ids" in self.emit:
            out["rnnt_beam_ids"], out["rnnt_beam_lens"] = beam_decode(
                self.model.rnnt, enc.features, enc.lengths, BEAM_SIZE)
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
