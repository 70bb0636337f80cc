"""Serving export: a model's weights and everything needed to serve them, as
one directory, counterpart of ``hnet_mamba_asr_tpu/serving/export.py``.

    manifest.json   JAX's keys and meanings (format_version, vocab_size,
                    blank_id, emit, quantize, buckets, beam, tokenizer; for
                    streaming kind and streaming), plus "runtime": "torch",
                    torch_version, the resolved config dict ("config") and
                    the CMVN file ("cmvn")
    params.npz      path-keyed weights in the JAX layout: keys are JAX's
                    keystr paths (``training/checkpoint.py::tree_to_path_dict``),
                    written from the model through
                    ``convert.py::state_dict_to_jax_tree``; int8 leaves as
                    JAX's ``~q8`` / ``~scale`` subtrees (``serving/quant.py``)
    cmvn.npz        the model's CMVN statistics (mean, istd), when it has one

With the same weights, ``params.npz`` holds the keys, dtypes and arrays of
the one JAX's exporter writes, fp32 and int8 alike.

No traced program. JAX writes one StableHLO program per (batch, samples)
bucket; the port writes none, because ``torch.export`` cannot carry what its
paths do: the ctypes-bound CUDA kernels (``ops/cuda_build.py``), the host
read that sizes the trimmed buffer at N > 1, and the searches' host reads of
their active mask. The runtime (``serving/runtime.py::load_serving_artifact``)
rebuilds the model from the manifest's config instead. A bucket row keeps
``batch`` and ``samples`` and has no ``file``: the buckets are the limits a
call must fit, and ``platforms`` is empty. int8 is dequantized once at load:
the artifact is ~4x smaller in its quantized leaves, the weights in memory
are fp32 as before.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from hnet_mamba_asr_torch.convert import load_jax_params, state_dict_to_jax_tree
from hnet_mamba_asr_torch.serving.quant import quantize_tree
from hnet_mamba_asr_torch.serving.runtime import FORMAT_VERSION

VALID_EMIT = ("frame_ids", "log_probs", "aed_ids", "beam_ids",
              "rnnt_ids", "rnnt_beam_ids")


def _tokenizer_meta(tokenizer) -> dict:
    """Embed the id->piece table so the runtime can emit text."""
    if tokenizer is None:
        return {}
    return {"tokenizer": {
        "pieces": list(tokenizer.pieces),
        # mirror data/tokenizer.Tokenizer.decode exactly: drop bos/eos/pad
        # but KEEP unk (it renders as its piece text)
        "drop_ids": sorted({int(tokenizer.bos_id), int(tokenizer.eos_id),
                            int(tokenizer.pad_id)}),
        "word_boundary": "▁",
    }}


def path_dict(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A nested dict / list tree -> {JAX keystr path: array}, as
    ``tree_to_path_dict`` keys it ("['encoder']['enc']...", "[0]")."""
    if isinstance(tree, dict):
        out: dict = {}
        for k in sorted(tree):
            out.update(path_dict(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(path_dict(v, f"{prefix}[{i}]"))
        return out
    return {prefix: np.asarray(tree)}


def _write_weights(out: Path, model, params, quantize, quantize_min_size: int,
                   config) -> dict:
    """params.npz (and cmvn.npz) from the model's weights -> the manifest's
    port-only keys."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    if not isinstance(config, dict):
        raise ValueError("config= (the model's resolved config dict) is required: the "
                         "runtime rebuilds the model from it")
    if params is not None:
        load_jax_params(model, params)
    tree = state_dict_to_jax_tree(model.state_dict())
    if quantize == "int8":
        tree = quantize_tree(tree, min_size=quantize_min_size)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "params.npz", **path_dict(tree))
    cmvn = None
    if model.cmvn is not None:
        cmvn = "cmvn.npz"
        np.savez(out / cmvn, mean=model.cmvn.mean, istd=model.cmvn.istd)
    return {"platforms": [], "jax_version": None, "runtime": "torch",
            "torch_version": torch.__version__, "config": config, "cmvn": cmvn}


def save_serving_artifact(out_dir: str | Path, model, params=None,
                          buckets: list[tuple[int, int]] = (),
                          emit: tuple[str, ...] = ("frame_ids",),
                          quantize: str | None = None,
                          quantize_min_size: int = 4096,
                          extra_meta: dict | None = None,
                          tokenizer=None,
                          beam_size: int = 10, pre_beam: int = 30, *,
                          config: dict | None = None) -> Path:
    """Export ``model`` (the port's, from ``tasks/asr_task.py::build_model``;
    ``params``, a JAX param tree, is loaded into it first when given) for
    calls that fit one of the (batch, samples) ``buckets``.

    ``emit`` names the outputs (``VALID_EMIT``); ``beam_size`` / ``pre_beam``
    set the beams of ``beam_ids`` and ``rnnt_beam_ids``. ``tokenizer``
    embeds the id->piece table for text output. ``quantize="int8"`` stores
    the large weights as int8 + per-channel scales (``serving/quant.py``).
    ``config`` is the model's resolved config dict; the manifest carries it.
    JAX's arguments but ``platforms`` (no program is traced).

    Returns the artifact directory. Fails loudly on an emit mode the model
    cannot serve, on no bucket or duplicate buckets, or on a bucket under one
    STFT window.
    """
    emit = tuple(emit)
    for e in emit:
        if e not in VALID_EMIT:
            raise ValueError(f"unknown emit mode {e!r}; choices: {VALID_EMIT}")
    if not emit:
        raise ValueError("emit must name at least one output")
    if ("frame_ids" in emit or "log_probs" in emit or "beam_ids" in emit) \
            and model.ctc is None:
        raise ValueError("frame_ids/log_probs/beam_ids require a CTC head")
    if "aed_ids" in emit and model.aed is None:
        raise ValueError("aed_ids requires an AED head")
    if ("rnnt_ids" in emit or "rnnt_beam_ids" in emit) and model.rnnt is None:
        raise ValueError("rnnt_ids/rnnt_beam_ids require an RNNT head")
    buckets = [(int(b), int(n)) for b, n in buckets]
    if not buckets:
        raise ValueError("buckets must name at least one (batch, samples) shape: "
                         "the runtime serves no call without one")
    if len(set(buckets)) != len(buckets):
        raise ValueError(f"duplicate buckets in {buckets}")
    for B, S in buckets:
        if B < 1 or S < 400:
            raise ValueError(f"bucket ({B}, {S}) must be >=1 row and >=400 "
                             "samples (one STFT window)")
    out = Path(out_dir)
    port_meta = _write_weights(out, model, params, quantize, quantize_min_size, config)
    vocab = (model.ctc.num_classes - 1 if model.ctc is not None
             else model.aed.vocab_size if model.aed is not None
             else model.rnnt.vocab_size)
    manifest = {
        "format_version": FORMAT_VERSION,
        "vocab_size": int(vocab),
        "blank_id": int(model.ctc.blank_id) if model.ctc is not None else None,
        "emit": list(emit),
        "quantize": quantize,
        "buckets": [{"batch": B, "samples": S} for B, S in buckets],
        **({"beam": {"beam_size": int(beam_size), "pre_beam": int(pre_beam)}}
           if "beam_ids" in emit or "rnnt_beam_ids" in emit else {}),
        **port_meta,
        **_tokenizer_meta(tokenizer),
        **(extra_meta or {}),
    }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return out


def save_streaming_artifact(out_dir: str | Path, model, params=None,
                            block_enc: int = 16,
                            batch: int = 1,
                            quantize: str | None = None,
                            quantize_min_size: int = 4096,
                            extra_meta: dict | None = None,
                            tokenizer=None,
                            stream_decode: str = "greedy",
                            beam_size: int = 8,
                            token_buf_len: int = 256, *,
                            config: dict | None = None) -> Path:
    """Export exact causal streaming (``models/streaming.py``, a causal
    config): the runtime's ``StreamingSessionPool`` advances up to ``batch``
    sessions a block of ``block_enc`` encoder frames; the CTC frame argmax,
    or for an RNNT-only model its greedy search or (``stream_decode="beam"``)
    its beam of ``beam_size`` over ``token_buf_len`` tokens. Arguments and
    checks as JAX's, but ``platforms``; ``config`` as for
    ``save_serving_artifact``."""
    from hnet_mamba_asr_torch.models.streaming import CausalStreamingEncoder

    use_rnnt = model.ctc is None and model.rnnt is not None
    if model.ctc is None and not use_rnnt:
        raise ValueError("streaming serving requires a CTC or RNNT head")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if stream_decode not in ("greedy", "beam"):
        raise ValueError(f"stream_decode must be greedy|beam, "
                         f"got {stream_decode!r}")
    use_beam = stream_decode == "beam"
    if use_beam and not use_rnnt:
        raise ValueError("stream_decode='beam' requires an RNNT-only model "
                         "(the transducer beam is the streaming-exact one)")
    cse = CausalStreamingEncoder(model, block_enc=block_enc)   # refuses a non-causal model
    out = Path(out_dir)
    port_meta = _write_weights(out, model, params, quantize, quantize_min_size, config)
    head = model.rnnt if use_rnnt else model.ctc
    manifest = {
        "format_version": FORMAT_VERSION,
        "kind": "streaming",
        "vocab_size": int(head.num_classes - 1),
        "blank_id": int(head.blank_id),
        "emit": ["rnnt_ids"] if use_rnnt else ["frame_ids"],
        "quantize": quantize,
        "streaming": {"block_enc": int(block_enc), "w_mel": int(cse.W_mel),
                      "s_win": int(cse.S_win), "hop": int(cse.hop),
                      "win": int(cse.win), "batch": int(batch),
                      "decode": stream_decode if use_rnnt else "greedy",
                      **({"beam_size": int(beam_size),
                          "token_buf_len": int(token_buf_len)}
                         if use_beam else {})},
        **port_meta,
        **_tokenizer_meta(tokenizer),
        **(extra_meta or {}),
    }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return out
