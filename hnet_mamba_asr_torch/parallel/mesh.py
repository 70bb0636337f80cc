"""Process launch, the planes of a run and where its parameters live:
counterpart of ``hnet_mamba_asr_tpu/parallel/mesh.py`` over
``torch.distributed``.

- ``init_distributed`` joins the process group of a ``torchrun`` launch
  (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``)
  and does nothing without those variables; it is idempotent, and a store or
  connection failure raises (never a quiet fall-back to one process, whose
  every rank would then write as rank 0). The backend is explicit: NCCL on the
  card, gloo on the CPU, and gloo over CUDA tensors only when asked for (one
  card cannot hold two NCCL ranks; two processes sharing one card run gloo).
- ``validate_planes`` parses train.{tp, sp, pp, ep, fsdp} with the JAX
  package's return value and error texts; fsdp composed with tp, ep or pp
  is not ported yet and raises.
- ``make_mesh`` is a ``DeviceMesh`` over (dp,), (dp, sp), (dp, pp), (dp,
  tp), (dp, ep) or (dp, tp, ep), in JAX's rank order (the last axis
  fastest).
- ``tp_plan`` / ``ep_plan`` are JAX's ``tp_specs`` / ``ep_specs`` on the
  port's parameter names: {leaf: (dim, [the global indices along dim that
  rank r holds, in its local order])}, collected from the modules' own
  ``tp_plan`` / ``ep_plan`` (each beside the code that reads its layout):
  Mamba-2's fused ``in_proj`` by hand (z, x and dt by heads, B and C
  whole), attention by heads, the FFN's hidden layer and the H-Net
  ``proj_in`` / ``proj_out`` by columns, MoE experts by their leading
  axis. An indivisible dimension raises.
- ``fsdp_plan`` / ``shard_model`` are JAX's ``fsdp_specs`` /
  ``place_params(fsdp=True)``: every leaf of at least ``_FSDP_MIN_ELEMS``
  elements with a dimension the rank count divides is sharded over that
  (largest) dimension by FSDP2's ``fully_shard``; the other leaves stay
  replicated (FSDP2 ignores them, and ``sync_replicated_grads`` averages
  their gradients). The units of ``fully_shard`` are the modules whose
  forward the model calls (Mamba blocks, the subsampling, decoder layers,
  LM blocks), then the root, which gathers whatever else it holds for the
  whole loss.
- ``rank_rows`` is JAX's ``shard_batch`` for a process that holds a batch
  whole: each rank keeps its contiguous row slice, ``REPLICATED_BATCH_KEYS``
  stay whole, and a batch whose rows the rank count does not divide raises.
- ``full_state`` gathers a sharded model or optimizer state to full tensors
  one leaf at a time (every rank takes part, rank 0 keeps the host copies);
  ``like`` places a full tensor back as a shard.
"""
from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from hnet_mamba_asr_torch.parallel.model_parallel import module_plan

_FSDP_MIN_ELEMS = 8192          # below this, all-gather latency > bytes saved
REPLICATED_BATCH_KEYS = frozenset({"aug_ref"})
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _launched() -> bool:
    return all(os.environ.get(k) for k in ENV_KEYS)


def resolve_backend(backend: str | None, device) -> str:
    """The backend a run asks for, or the device's default: NCCL for CUDA,
    gloo for the CPU. NCCL on the CPU raises."""
    dev = torch.device(device)
    if backend in (None, "", "auto"):
        return "nccl" if dev.type == "cuda" else "gloo"
    backend = str(backend).lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist backend must be nccl or gloo, got {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs CUDA tensors; use gloo on the CPU")
    return backend


def init_distributed(device="cuda", backend: str | None = None,
                     timeout_s: float = 600.0) -> bool:
    """Join the process group of a torchrun launch; False without one.

    Idempotent. Raises where a launch is configured but cannot be joined (a
    bad store address, a peer that never comes), and where NCCL would put
    two ranks on one device."""
    if not _launched():
        return False
    if dist.is_initialized():
        return True
    backend = resolve_backend(backend, device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        n_dev = torch.cuda.device_count()
        if local_world > n_dev:
            raise ValueError(
                f"NCCL cannot run {local_world} ranks on {n_dev} CUDA device(s) of one "
                "host: it refuses two ranks on one device. Launch one rank per device, or "
                "ask for the gloo backend (--dist-backend gloo) to share a device")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return True


def rank_device(device) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` (modulo the card count,
    so that gloo ranks share a card) on a launched CUDA run, else
    ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda" or not _launched():
        return dev
    return torch.device("cuda", int(os.environ["LOCAL_RANK"]) % max(1, torch.cuda.device_count()))


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def validate_planes(flat: dict) -> tuple[int, int, int, int, bool]:
    """Parse and validate the parallelism planes of a flattened train config.

    Returns ``(tp, sp, pp, ep, fsdp)`` with JAX's composition rules and
    errors (sp and pp exclude every other model-parallel plane; tp and ep
    compose; sp / pp with scan_steps raise). fsdp with tp, ep or pp is not
    ported and raises NotImplementedError after those checks."""
    tp = int(flat.get("tp", 1))
    sp = int(flat.get("sp", 1))
    pp = int(flat.get("pp", 1))
    ep = int(flat.get("ep", 1))
    fsdp = bool(flat.get("fsdp", False))
    planes = sum(p > 1 for p in (tp, sp, pp, ep))
    if planes > 1 and not (planes == 2 and tp > 1 and ep > 1):
        raise ValueError("train.sp / train.pp are mutually exclusive with "
                         "every other model-parallel plane; train.tp and "
                         "train.ep may compose into a (dp, tp, ep) mesh "
                         "(their sharded parameter sets are disjoint)")
    if (sp > 1 or pp > 1) and int(flat.get("scan_steps", 1)) > 1:
        raise ValueError("train.sp/pp with train.scan_steps is not "
                         "supported (shard_map inside the fused scan is "
                         "untested); use accum_grad instead")
    if fsdp and (tp > 1 or ep > 1 or pp > 1):
        raise NotImplementedError("train.fsdp with train.tp / train.ep / train.pp is not "
                                  "ported (a later slice: FSDP2 over the dp sub-mesh of a "
                                  "2-D mesh)")
    return tp, sp, pp, ep, fsdp


def make_mesh(sp: int = 1, device="cuda", tp: int = 1, ep: int = 1, pp: int = 1):
    """A ``DeviceMesh`` of every rank of the process group: (dp,), (dp, sp)
    when ``sp`` > 1, (dp, pp) when ``pp`` > 1, (dp, tp), (dp, ep) or (dp,
    tp, ep) when ``tp`` / ``ep`` > 1, in JAX's rank order (``reshape(n //
    model, tp, ep)``: the last axis fastest, rank = (dp_index * tp +
    tp_index) * ep + ep_index, or dp_index * pp + stage); None without a
    process group."""
    model = sp * tp * ep * pp
    if not (dist.is_available() and dist.is_initialized()):
        if model > 1:
            what = (f"train.sp={sp}" if sp > 1 else f"train.pp={pp}" if pp > 1
                    else f"tp*ep={tp}*{ep}")
            raise ValueError(f"{what} needs {model} ranks; launch them with torchrun")
        return None
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    dev_type = torch.device(device).type
    for name, size in (("sp", sp), ("pp", pp)):
        if size > 1:
            if n % size:
                # pp: JAX's make_mesh(tp=pp, tp_axis="pp") text
                raise ValueError(f"{n} devices not divisible by tp*ep={size}*1" if name == "pp"
                                 else f"{n} ranks not divisible by sp={size}")
            return init_device_mesh(dev_type, (n // size, size), mesh_dim_names=("dp", name))
    if model <= 1:
        return init_device_mesh(dev_type, (n,), mesh_dim_names=("dp",))
    if n % model:
        raise ValueError(f"{n} devices not divisible by tp*ep={tp}*{ep}")
    axes = [(name, size) for name, size in (("tp", tp), ("ep", ep)) if size > 1]
    return init_device_mesh(dev_type, (n // model, *(size for _, size in axes)),
                            mesh_dim_names=("dp", *(name for name, _ in axes)))


def mesh_axis(mesh, name: str):
    """(group, rank in it, its size) of a mesh axis; (None, 0, 1) where the
    mesh or the axis does not exist."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None, 0, 1
    return (mesh.get_group(name), mesh.get_local_rank(name),
            mesh.size(mesh.mesh_dim_names.index(name)))


# ── tensor- and expert-parallel parameters ───────────────────────────────────
def _collect(model: torch.nn.Module, plane: str, n: int) -> dict:
    plan = {}
    for prefix, m in model.named_modules():
        local = module_plan(m, plane, n, prefix)
        for key, entry in (local or {}).items():
            plan[f"{prefix}.{key}" if prefix else key] = entry
    return plan


def tp_plan(model: torch.nn.Module, tp: int) -> dict:
    """JAX's ``tp_specs`` (``_TP_COLUMN`` in_proj, linear1, q/k/v_proj,
    proj_in; ``_TP_ROW`` out_proj, linear2, proj_out) on the port's leaves:
    {name: (dim, [rank r's global indices along dim])}; the leaves it does
    not name stay whole on every rank. The router, the EMA dechunk, the
    subsampling, the heads' read-outs and every LayerNorm stay replicated,
    as do Type B's ``proj1_in`` / ``proj1_out`` (JAX's rule names neither)."""
    return _collect(model, "tp", tp)


def ep_plan(model: torch.nn.Module, ep: int) -> dict:
    """JAX's ``ep_specs``: every MoE FFN's stacked ``w1``, ``b1``, ``w2``,
    ``b2`` split over their expert axis (rank r holds experts [r E / ep,
    (r + 1) E / ep)); the router stays replicated."""
    return _collect(model, "ep", ep)


# ── fully-sharded parameters (FSDP2 over every rank) ─────────────────────────
def fsdp_plan(model: torch.nn.Module, n_shards: int,
              min_elems: int = _FSDP_MIN_ELEMS) -> dict:
    """{parameter name: the dim it shards over, or None (replicated)}: JAX's
    ``fsdp_specs`` rule, the largest dimension the shard count divides (the
    first of equals) of every leaf of at least ``min_elems`` elements."""
    plan = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        cands = [i for i, d in enumerate(shape) if d % n_shards == 0]
        if not shape or int(np.prod(shape)) < min_elems or not cands:
            plan[name] = None
        else:
            plan[name] = max(cands, key=lambda i: shape[i])
    return plan


def _fsdp_units(model: torch.nn.Module) -> list:
    from hnet_mamba_asr_torch.models.aed import DecoderLayerQKNorm
    from hnet_mamba_asr_torch.models.encoder import ConvSubsampling4
    from hnet_mamba_asr_torch.models.lm import LMBlock
    from hnet_mamba_asr_torch.models.mamba_block import MambaBlock
    kinds = (MambaBlock, ConvSubsampling4, DecoderLayerQKNorm, LMBlock)
    return [m for m in model.modules() if isinstance(m, kinds)]


def shard_model(root: torch.nn.Module, device="cuda",
                min_elems: int = _FSDP_MIN_ELEMS, units: bool = True) -> dict:
    """``fully_shard`` the units of ``root`` (unless ``units`` is False) and
    then ``root`` over a 1-D mesh of every rank, by ``fsdp_plan``; returns
    the plan. The parameters stay the module's own objects (DTensors where
    sharded), so an optimizer built afterwards holds the shards and its
    moments are sharded with them. Without units, the root gathers every
    leaf for its whole forward (the sequence-parallel encoder calls its
    blocks' parts, not their forward: JAX's fsdp + sp gathers the whole
    tree at the shard_map boundary the same way)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    n = dist.get_world_size()
    mesh = init_device_mesh(torch.device(device).type, (n,))
    plan = fsdp_plan(root, n, min_elems)
    by_param = {p: plan[name] for name, p in root.named_parameters()}
    replicated = {p for p, dim in by_param.items() if dim is None}

    def place(p):
        return Shard(by_param[p])

    for unit in (_fsdp_units(root) if units else []) + [root]:
        mine = set(unit.parameters())
        fully_shard(unit, mesh=mesh, shard_placement_fn=place,
                    ignored_params=mine & replicated)
    return plan


def is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def sync_replicated_grads(params, group=None) -> None:
    """Average the gradients of the parameters FSDP leaves replicated over
    the ranks (one all-reduce of their concatenation)."""
    grads = [p.grad for p in params if p.grad is not None and not is_dtensor(p.grad)]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def full_state(state, keep: bool):
    """A nested state (a state_dict, an optimizer state) with every DTensor
    gathered to a full tensor, one leaf at a time, and every tensor copied to
    the host when ``keep`` (rank 0); None leaves elsewhere. Every rank must
    call it in the same order."""
    if torch.is_tensor(state):
        t = state.full_tensor() if is_dtensor(state) else state
        return t.detach().cpu().clone() if keep else None
    if isinstance(state, dict):
        return {k: full_state(v, keep) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(full_state(v, keep) for v in state)
    return state


def like(full: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``full`` placed as ``ref``: this rank's shard of it where ``ref`` is a
    DTensor, else on ``ref``'s device."""
    full = full.to(device=ref.device, dtype=ref.dtype)
    if not is_dtensor(ref):
        return full
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full, ref.device_mesh, ref.placements)


def rank_rows(batch: dict, rank: int, count: int) -> dict:
    """This rank's contiguous row slice of a host batch that every rank holds
    whole. Batch-major arrays are sliced, ``REPLICATED_BATCH_KEYS`` and
    scalars pass, ``ids`` (the real rows' ids, which lead the rows) is cut
    to the slice's real rows. A batch-major array whose rows ``count`` does
    not divide raises: the ranks would hold different shapes."""
    if count == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if k == "ids":
            continue
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1 \
                and k not in REPLICATED_BATCH_KEYS:
            B = v.shape[0]
            if B % count:
                raise ValueError(
                    f"rank_rows['{k}']: {B} rows are not divisible by the {count} ranks "
                    "that split the batch; pad the batch to a multiple of the rank count "
                    "(batch_multiple)")
            per = B // count
            out[k] = v[rank * per:(rank + 1) * per]
        else:
            out[k] = v
    if "ids" in batch:
        B = next(v.shape[0] for k, v in batch.items() if k == "row_mask")
        per = B // count
        out["ids"] = list(batch["ids"])[rank * per:(rank + 1) * per]
    return out
