"""Carry weights between the JAX package and the port, both ways.

``jax_to_state_dict`` reads the nested-dict param tree that the JAX
package's ``init_params`` or a checkpoint gives (numpy leaves), or the
path-keyed ``params.npz`` that ``scripts/export_serving.py`` writes (keys
like ``['encoder']['dec']['block_0']['bwd']['a_log']``).
``state_dict_to_jax_tree`` gives the flax tree back, as numpy arrays, so
that a checkpoint the port writes loads in the JAX package. The layouts
change so:

- Dense ``kernel`` [in, out] <-> ``weight`` [out, in];
- the head-axis kernels of flax's attention (the LM's ``query`` / ``key`` /
  ``value`` [d, H, dh] <-> [H, dh, d], ``out`` [H, dh, d] <-> [d, H, dh]),
  their output axes first, as a Dense weight's;
- Conv ``kernel`` HWIO <-> ``weight`` OIHW;
- LayerNorm ``scale`` <-> ``weight``;
- Embed ``embedding`` [V, d] <-> ``weight`` [V, d];
- Mamba2 ``conv_w`` [d_conv, C] <-> the depthwise layout [C, 1, d_conv];
- ``block_<i>`` <-> ``blocks.<i>`` and ``layer_<i>`` <-> ``layers.<i>``;
  every other name is kept.

MoE FFNs keep their stacked leaves as they are (``router`` [D, E], ``w1``
[E, D, F], ``b1``, ``w2`` [E, F, D], ``b2``). A head subtree (``ctc``,
``aed``, ``rnnt``) is skipped when the model lacks that head; a log line
says so. int8-quantized artifacts raise, and so does any key that the model
does not have or that it has and the tree lacks.

``shard_state`` / ``gather_state`` split a full state into a tp / ep rank's
shards and back; ``stage_state`` / ``gather_stages`` into a pp rank's stage
(the main stack's blocks of the stage, keyed by their global index, and
every other leaf) and back.
"""
from __future__ import annotations

import logging
import re
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

HEADS = ("ctc", "aed", "rnnt")            # top-level subtrees a model may lack
QUANT_KEYS = ("~q8", "~scale")           # serving/quant.py's int8 leaf subtree
_KEY_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]")
_LIST_RE = re.compile(r"^(block|layer)_(\d+)$")


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
    mods = [f"{m.group(1)}s.{m.group(2)}" if (m := _LIST_RE.match(p)) else p for p in mods]
    if leaf == "kernel":
        if a.ndim == 2:
            a = a.T                                   # [in, out] -> [out, in]
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)               # HWIO -> OIHW
        elif a.ndim == 3:                             # attention's head axes
            a = a.transpose(2, 0, 1) if mods[-1] == "out" else a.transpose(1, 2, 0)
        else:
            raise ValueError(f"unexpected {a.ndim}-D kernel at {'/'.join(path)}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    elif leaf == "conv_w":
        a = a.T[:, None, :]                           # [d_conv, C] -> [C, 1, d_conv]
    return ".".join(mods + [leaf]), a


def _jax_leaf(key: str, a: np.ndarray) -> tuple[list[str], np.ndarray]:
    """The inverse of ``_convert_leaf``: a state_dict key -> JAX path, leaf."""
    *mods, leaf = key.split(".")
    path: list[str] = []
    for m in mods:
        if m.isdigit() and path and path[-1] in ("blocks", "layers"):
            path[-1] = f"{path[-1][:-1]}_{m}"
        else:
            path.append(m)
    if leaf == "weight":
        if a.ndim == 4:
            a, leaf = a.transpose(2, 3, 1, 0), "kernel"   # OIHW -> HWIO
        elif a.ndim == 3:
            a, leaf = (a.transpose(1, 2, 0) if path[-1] == "out"
                       else a.transpose(2, 0, 1)), "kernel"
        elif a.ndim == 2:
            a, leaf = (a, "embedding") if path[-1] == "embed" else (a.T, "kernel")
        elif a.ndim == 1:
            leaf = "scale"
        else:
            raise ValueError(f"unexpected {a.ndim}-D weight at {key}")
    elif leaf == "conv_w":
        a = a[:, 0, :].T                              # [C, 1, d_conv] -> [d_conv, C]
    return path + [leaf], a


def state_dict_to_jax_tree(state_dict: dict) -> dict:
    """The port's state_dict -> the flax param tree, leaf for leaf, as fp32
    numpy arrays (the layout the JAX package's checkpoints hold)."""
    tree: dict = {}
    for key, value in state_dict.items():
        path, a = _jax_leaf(key, value.detach().float().cpu().numpy())
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return tree


def jax_to_state_dict(tree: dict, skip: tuple[str, ...] = ()) -> dict[str, torch.Tensor]:
    """JAX param tree -> the port's state_dict keys and layouts (fp32),
    without the top-level subtrees named in ``skip``."""
    skipped = [k for k in skip if k in tree]
    if skipped:
        logger.info("convert: skipping the %s subtrees (heads not in the model)", skipped)
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
        if k not in skip:
            walk(v, [str(k)])
    return out


def load_jax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load a JAX param tree, or the path of a ``params.npz``, into ``model``.
    Every key must match both ways, with the same shape."""
    if isinstance(params, (str, Path)):
        params = load_params_npz(params)
    sd = jax_to_state_dict(params, skip=tuple(h for h in HEADS
                                              if getattr(model, h, None) is None))
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


def shard_state(state, plan: dict, rank: int) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s shard of a full state: a JAX param tree (converted
    first) or the port's state_dict, by a tp / ep plan
    (``parallel/mesh.py::tp_plan`` / ``ep_plan``: {name: (dim, [indices per
    rank], ...)}); the leaves the plan does not name stay whole."""
    if any(isinstance(v, (dict, list)) for v in state.values()):
        state = jax_to_state_dict(state)
    out = {}
    for k, v in state.items():
        v = torch.as_tensor(v)
        if k in plan:
            dim, idx = plan[k][0], plan[k][1]
            v = v.index_select(dim, idx[rank].to(v.device))
        out[k] = v
    return out


def gather_state(shards: list, plan: dict) -> dict[str, torch.Tensor]:
    """The full state_dict from every rank's shard (``shard_state``'s
    inverse, in rank order): each planned leaf's rows are put back at their
    global indices (the rows every rank holds, B and C's, from the last)."""
    out = {}
    for k, v in shards[0].items():
        if k not in plan:
            out[k] = v
            continue
        dim, idx = plan[k][0], plan[k][1]
        shape = list(v.shape)
        shape[dim] = int(torch.cat(idx).max()) + 1
        full = v.new_empty(shape)
        for r, shard in enumerate(shards):
            full.index_copy_(dim, idx[r].to(v.device), shard[k])
        out[k] = full
    return out


def stage_state(state, pp: int, s: int) -> dict[str, torch.Tensor]:
    """Stage ``s``'s share of a full state (a JAX param tree, converted
    first, or the port's state_dict) over ``pp`` stages: the main stack's
    blocks [s k, (s + 1) k), k = n_main / pp, under their global names, and
    every leaf outside the main stack's blocks."""
    from hnet_mamba_asr_torch.parallel.pipeline import main_block, stage_range
    if any(isinstance(v, (dict, list)) for v in state.values()):
        state = jax_to_state_dict(state)
    blocks = [i for i in map(main_block, state) if i is not None]
    keep = stage_range(max(blocks) + 1 if blocks else 0, pp, s)
    return {k: v for k, v in state.items() if main_block(k) is None or main_block(k) in keep}


def gather_stages(states: list) -> dict[str, torch.Tensor]:
    """The full state_dict from every stage's (``stage_state``'s inverse,
    in stage order): each main-stack block from the stage that holds it,
    every other leaf from the first."""
    from hnet_mamba_asr_torch.parallel.pipeline import main_block
    out = dict(states[0])
    for st in states[1:]:
        out.update({k: v for k, v in st.items() if main_block(k) is not None})
    return out
