"""Serving runtime: the offline CTC serving forward in eager PyTorch.

Counterpart of ``hnet_mamba_asr_tpu/serving/runtime.py``'s ``ServingModel``
for the ``frame_ids`` emit mode that ``scripts/export_serving.py`` exports:
raw padded waveform -> log-mel -> CMVN -> encoder -> CTC frame argmax, then
the host collapse of repeats and blanks. PyTorch runs eagerly, so there are
no shape buckets; the ``max_batch`` and ``max_samples`` limits take their
place and fail with the JAX runtime's words.

Weights come from a JAX param tree or ``params.npz`` (``convert.py``), or are
drawn from a seed.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from hnet_mamba_asr_torch.convert import load_jax_params, load_params_npz
from hnet_mamba_asr_torch.data.features import GlobalCMVN
# the CTC collapse of repeats and blanks, per valid row span
from hnet_mamba_asr_torch.models.ctc_head import greedy_decode as collapse_ctc
from hnet_mamba_asr_torch.tasks.asr_task import build_model

EMIT_PORTED = ("frame_ids", "log_probs")
EMIT_NOT_PORTED = ("aed_ids", "beam_ids", "rnnt_ids", "rnnt_beam_ids")


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


class ServingModel:
    """Callable serving model: ``(wave [B, S], wave_lens [B]) -> {enc_lengths,
    frame_ids}`` as numpy arrays.

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
            if e in EMIT_NOT_PORTED:
                raise NotImplementedError(f"emit mode {e!r} is not ported; "
                                          f"choices: {EMIT_PORTED}")
            if e not in EMIT_PORTED:
                raise ValueError(f"unknown emit mode {e!r}; choices: {EMIT_PORTED}")
        if isinstance(params, (str, Path)):
            params = load_params_npz(params)
        if vocab_size is None:
            if params is None:
                raise ValueError("vocab_size is required for seeded weights")
            vocab_size = int(np.asarray(params["ctc"]["proj"]["kernel"]).shape[1]) - 1
        if isinstance(cmvn, (str, Path)):
            cmvn = GlobalCMVN.load(cmvn)
        self.device = torch.device(device)
        model = build_model(config, vocab_size, cmvn=cmvn, seed=seed, device=self.device)
        if model.ctc is None:
            raise NotImplementedError("serving needs the CTC head (model_conf.ctc_weight "
                                      "> 0); its aed_ids and beam_ids emit modes are not ported")
        if params is not None:
            load_jax_params(model, params)
        self.model = model
        self.vocab_size = int(vocab_size)
        self.blank_id = self.model.ctc.blank_id
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
        if "log_probs" in self.emit:
            out["log_probs"] = self.model.ctc.log_probs(enc.features)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def transcribe_ids(self, wave, wave_lens) -> list[list[int]]:
        """CTC greedy token ids per utterance."""
        if "frame_ids" not in self.emit:
            raise ValueError(f"model emits {self.emit}, not frame_ids")
        out = self(wave, wave_lens)
        return collapse_ctc(out["frame_ids"], out["enc_lengths"], self.blank_id)

    def transcribe_text(self, wave, wave_lens) -> list[str]:
        if self.tokenizer is None:
            raise ValueError("no tokenizer table given: pass tokenizer= or "
                             "consume transcribe_ids() instead")
        return [detokenize(self.tokenizer, ids)
                for ids in self.transcribe_ids(wave, wave_lens)]
