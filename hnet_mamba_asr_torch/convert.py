"""Carry JAX weights into the port: flax param tree -> ``state_dict``.

Reads the nested-dict param tree that the JAX package's ``init_params`` or a
checkpoint gives (numpy leaves), or the path-keyed ``params.npz`` that
``scripts/export_serving.py`` writes (keys like
``['encoder']['dec']['block_0']['bwd']['a_log']``). The layouts change so:

- Dense ``kernel`` [in, out] -> ``weight`` [out, in];
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- LayerNorm ``scale`` -> ``weight``;
- Mamba2 ``conv_w`` [d_conv, C] -> the depthwise layout [C, 1, d_conv];
- ``block_<i>`` -> ``blocks.<i>``; every other name is kept.

The ``aed`` and ``rnnt`` subtrees are skipped (their heads are not ported),
and a log line says so. int8-quantized artifacts raise, and so does any key
that the model does not have or that it has and the tree lacks.
"""
from __future__ import annotations

import logging
import re
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

SKIPPED_HEADS = ("aed", "rnnt")
QUANT_KEYS = ("~q8", "~scale")           # serving/quant.py's int8 leaf subtree
_KEY_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]")
_BLOCK_RE = re.compile(r"^block_(\d+)$")


def params_to_tree(flat: dict):
    """Path-keyed flat dict (jax keystr paths like "['a'][0]['b']") -> nested
    dicts/lists; port of ``hnet_mamba_asr_tpu/serving/runtime.py``'s parser,
    which cannot be imported without jax."""
    tree: dict = {}
    for path, leaf in flat.items():
        keys = [name if name else int(idx) for name, idx in _KEY_RE.findall(path)]
        if not keys or "".join(_KEY_RE.sub("", path).split()):
            raise ValueError(f"unparseable params key {path!r}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"non-contiguous list indices {sorted(node)}")
            return [node[i] for i in range(len(node))]
        return node

    return listify(tree)


def load_params_npz(path: str | Path) -> dict:
    """A path-keyed ``params.npz`` -> the nested JAX param tree."""
    with np.load(path) as z:
        return params_to_tree({k: z[k] for k in z.files})


def _convert_leaf(path: list[str], a: np.ndarray) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    mods = [f"blocks.{m.group(1)}" if (m := _BLOCK_RE.match(p)) else p for p in mods]
    if leaf == "kernel":
        if a.ndim == 2:
            a = a.T                                   # [in, out] -> [out, in]
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)               # HWIO -> OIHW
        else:
            raise ValueError(f"unexpected {a.ndim}-D kernel at {'/'.join(path)}")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf == "conv_w":
        a = a.T[:, None, :]                           # [d_conv, C] -> [C, 1, d_conv]
    return ".".join(mods + [leaf]), a


def jax_to_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    """JAX param tree -> the port's state_dict keys and layouts (fp32)."""
    skipped = [k for k in SKIPPED_HEADS if k in tree]
    if skipped:
        logger.info("convert: skipping the %s subtrees (heads not ported)", skipped)
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            if any(k in node for k in QUANT_KEYS):
                raise ValueError(f"int8-quantized weights at {'/'.join(path)}: "
                                 "the port loads unquantized params only")
            for k, v in node.items():
                walk(v, path + [str(k)])
            return
        key, a = _convert_leaf(path, np.asarray(node, dtype=np.float32))
        out[key] = torch.from_numpy(np.array(a, order="C"))    # owned copy

    for k, v in tree.items():
        if k not in SKIPPED_HEADS:
            walk(v, [str(k)])
    return out


def load_jax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load a JAX param tree, or the path of a ``params.npz``, into ``model``.
    Every key must match both ways, with the same shape."""
    if isinstance(params, (str, Path)):
        params = load_params_npz(params)
    sd = jax_to_state_dict(params)
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    unknown = sorted(set(sd) - set(want))
    if missing or unknown:
        raise KeyError(f"param keys do not match the model: missing {missing}, "
                       f"unknown {unknown}")
    bad = [f"{k}: {tuple(sd[k].shape)} vs {tuple(want[k].shape)}"
           for k in sd if sd[k].shape != want[k].shape]
    if bad:
        raise ValueError(f"param shapes do not match the model: {bad}")
    model.load_state_dict(sd, strict=True)
    return model
