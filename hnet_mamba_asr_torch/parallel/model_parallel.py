"""Tensor and expert parallelism by hand (Megatron style), the port's
counterpart of the GSPMD annotations of ``hnet_mamba_asr_tpu/parallel/mesh.py``
(``tp_specs``, ``ep_specs``, ``place_params``).

JAX annotates where the bytes live and lets GSPMD insert the collectives;
the function stays the one-device function. The port places the shards
itself (``place_model``: each rank builds the whole model from the seed, as
one process does, then keeps its shard, by each split module's own
``tp_plan`` / ``ep_plan``, which ``parallel/mesh.py::tp_plan`` / ``ep_plan``
collect) and its modules call the collectives where a split ends
(``parallel/collectives.py``: ``copy_to_model`` before a column-split GEMM
or a rank's own experts, ``reduce_from_model`` after a row-split GEMM or
the experts' combine, ``gather_from_model`` after a column split whose
consumer needs every column, ``all_reduce_sum`` for the gated RMSNorm's
sum of squares).

A module of a split holds a ``Plane`` as ``mp``: the plane's group, size
and rank and the module's own leaves' plan. On a rank (``group`` set) the
module computes its one shard from its parameters, which are that shard.
Without a group and with ``size`` > 1 the plane is *virtual*: one process
holds the whole parameters and computes every shard in turn, taking each
shard's slice of them, and sums or concatenates the shards' parts in rank
order where the ranks would run a collective. That is the one-process
witness of what the ranks compute (the same GEMM shapes, the same partial
sums), against which the card's bf16 tp run is held. Dropout inside a
split draws the whole tensor and keeps the shard's heads or columns; the
virtual plane replays the generator for each shard (``each_shard``), so
that every shard sees the draw the ranks see.
"""
from __future__ import annotations

import torch

from hnet_mamba_asr_torch.parallel.collectives import (all_reduce_sum, copy_to_model,
                                                       gather_from_model, reduce_from_model)


class Plane:
    """One model-parallel plane ("tp" or "ep") as one module computes it;
    ``index``: the module's leaves' plan {local name: (dim, [rank r's
    global indices])}."""

    def __init__(self, name: str, size: int, rank: int = 0, group=None,
                 index: dict | None = None):
        self.name, self.size, self.rank, self.group = name, int(size), int(rank), group
        self.virtual = group is None
        self.shards = list(range(self.size)) if self.virtual else [self.rank]
        self.index = dict(index or {})

    def bind(self, index: dict) -> "Plane":
        return Plane(self.name, self.size, self.rank, self.group, index)

    def take(self, p: torch.Tensor, name: str, s: int) -> torch.Tensor:
        """Shard ``s`` of the leaf ``name``: the parameter itself on a rank
        (it is the shard), its slice of the whole on a virtual plane."""
        if not self.virtual or name not in self.index:
            return p
        dim, idx = self.index[name]
        return p.index_select(dim, idx[s].to(p.device))

    def each_shard(self, generator: torch.Generator | None = None):
        """The shards this process computes; on a virtual plane each starts
        from the same state of ``generator``, as every rank does."""
        if generator is None or not self.virtual:
            yield from self.shards
            return
        state = generator.get_state()
        for s in self.shards:
            generator.set_state(state)
            yield s

    def fan(self, x: torch.Tensor) -> list:
        """``x`` for each shard this process computes (``copy_to_model`` on a
        rank): its gradient is the sum over the shards, in fp32, rounded
        once, on a rank and on a virtual plane alike."""
        if not self.virtual:
            return [copy_to_model(x, self.group)]
        if not (torch.is_grad_enabled() and x.requires_grad):
            return [x] * self.size
        return list(_Fan.apply(x, self.size))

    def reduce(self, parts: list) -> torch.Tensor:
        """The sum of the shards' parts (``reduce_from_model``), in rank order."""
        return _in_order(parts) if self.virtual else reduce_from_model(parts[0], self.group)

    def sum(self, parts: list) -> list:
        """The sum of the shards' parts, for each shard, which uses it for its
        own channels (``all_reduce_sum``: the gradient is the sum of the
        shards' gradients of it)."""
        if not self.virtual:
            return [all_reduce_sum(parts[0], self.group)]
        return self.fan(_in_order(parts))

    def gather(self, parts: list, dim: int = -1) -> torch.Tensor:
        return torch.cat(parts, dim) if self.virtual else gather_from_model(parts[0], self.group,
                                                                            dim)


class _Fan(torch.autograd.Function):
    """n views of x whose gradients are summed in fp32 in shard order, then
    cast: the virtual plane's ``copy_to_model``."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.dtype = x.dtype
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                total = g.float() if total is None else total + g.float()
        return (None if total is None else total.to(ctx.dtype)), None


def _in_order(parts: list) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def indivisible(name: str, dim: int, size: int, n: int, shape) -> ValueError:
    """JAX's ``device_put`` text for a dimension a plane does not divide."""
    return ValueError(f"{name}: a split over {n} ranks implies that the global size of its "
                      f"dimension {dim} should be divisible by {n}, but it is equal to "
                      f"{size} (full shape: {tuple(shape)})")


def even_split(count: int, n: int, name: str, dim: int, shape) -> list:
    """The n contiguous ranges of ``count`` (raises where n does not divide it)."""
    if count % n:
        raise indivisible(name, dim, count, n, shape)
    per = count // n
    return [torch.arange(r * per, (r + 1) * per) for r in range(n)]


def column_row_plan(prefix: str, column, row, units: int, n: int, unit: int = 1) -> dict:
    """A module's plan for column-split GEMMs (weight rows and bias) and
    row-split ones (weight columns; their bias stays whole), by blocks of
    ``unit`` features (a head): ``units`` blocks in all."""
    blocks = even_split(units, n, f"{prefix}.{column[0]}.weight", 0, (units * unit,))
    idx = [torch.arange(b[0] * unit, (b[-1] + 1) * unit) for b in blocks]
    plan = {}
    for name in column:
        plan[f"{name}.weight"] = (0, idx)
        plan[f"{name}.bias"] = (0, idx)
    for name in row:
        plan[f"{name}.weight"] = (1, idx)
    return plan


def module_plan(m: torch.nn.Module, plane: str, n: int, prefix: str = "") -> dict | None:
    """The split over ``n`` ranks of plane ``plane`` ("tp" or "ep") of one
    module's own leaves (names relative to it), from the module's own
    ``tp_plan`` / ``ep_plan`` (beside the code that reads the layout), or
    None for a module the plane does not split."""
    planner = getattr(m, f"{plane}_plan", None)
    return None if planner is None else planner(n, prefix)


def plane_of(mesh, name: str, size: int) -> Plane | None:
    """The plane ``name`` of a ``DeviceMesh`` (its group and this rank's place
    on it); a virtual plane of ``size`` shards without a mesh; None where
    the plane has one shard."""
    if size <= 1:
        return None
    if mesh is None:
        return Plane(name, size)
    return Plane(name, size, mesh.get_local_rank(name), mesh.get_group(name))


def place_model(model: torch.nn.Module, tp: Plane | None = None,
                ep: Plane | None = None) -> dict:
    """Bind ``tp`` / ``ep`` to the modules they split and, on ranks, keep
    this rank's shard of each split leaf (``convert.shard_state``'s slice).
    Returns the merged plan {name: (dim, [indices per rank], plane name)}.
    The two planes' leaves are disjoint (JAX asserts the same in
    ``place_params``)."""
    merged = {}
    for plane in (tp, ep):
        if plane is None or plane.size <= 1:
            continue
        for prefix, m in model.named_modules():
            local = module_plan(m, plane.name, plane.size, prefix)
            if local is None:
                continue
            if getattr(m, "mp", None) is not None:
                raise ValueError(f"{prefix}: already split over {m.mp.name}")
            m.mp = plane.bind(local)
            for key, (dim, idx) in local.items():
                name = f"{prefix}.{key}" if prefix else key
                if name in merged:
                    raise ValueError(f"{name} split by two planes")
                merged[name] = (dim, idx, plane.name)
                if not plane.virtual:
                    p = m.get_parameter(key)
                    p.data = p.data.index_select(dim, idx[plane.rank].to(p.device)).contiguous()
    return merged


def split_leaves(model: torch.nn.Module):
    """(parameter, plane, dim, share) of every leaf a rank holds a shard of:
    ``share`` [the leaf's length along dim] is 1 / the number of the plane's
    ranks that hold each index (B and C's rows of a tp ``in_proj`` are on
    every rank)."""
    for m in model.modules():
        plane = getattr(m, "mp", None)
        if plane is None or plane.virtual:
            continue
        for key, (dim, idx) in plane.index.items():
            holders = torch.bincount(torch.cat(idx))
            yield m.get_parameter(key), plane, dim, 1.0 / holders[idx[plane.rank]].float()


def model_planes(model: torch.nn.Module) -> dict:
    """{plane name: a Plane of the model's} for the planes bound to it."""
    out = {}
    for m in model.modules():
        plane = getattr(m, "mp", None)
        if plane is not None:
            out.setdefault(plane.name, plane)
    return out


def sync_replicas(model: torch.nn.Module, split: list) -> None:
    """Average over each plane's group the gradients its ranks all hold:
    every leaf the plane does not split, and the shared rows of those it
    does (B and C's). They are equal up to the last bits (torch's CUDA CTC
    backward and the H-Net slot gathers sum with atomics), and the average
    keeps the ranks' copies of each weight the same after every update.
    ``split``: ``split_leaves(model)``."""
    import torch.distributed as dist
    for plane in model_planes(model).values():
        if plane.virtual:
            continue
        mine = {id(p): (dim, (share < 1).nonzero()[:, 0])
                for p, pl, dim, share in split if pl.name == plane.name}
        views = []
        for p in model.parameters():
            if p.grad is None:
                continue
            dim, rows = mine.get(id(p), (None, None))
            if dim is None:
                views.append((p.grad, None, None))
            elif len(rows):
                views.append((p.grad, dim, rows.to(p.grad.device)))
        parts = [g if dim is None else g.index_select(dim, rows) for g, dim, rows in views]
        flat = torch.cat([t.reshape(-1).float() for t in parts])
        dist.all_reduce(flat, group=plane.group)
        flat /= plane.size
        off = 0
        for (g, dim, rows), t in zip(views, parts):
            avg = flat[off:off + t.numel()].view_as(t).to(g.dtype)
            off += t.numel()
            if dim is None:
                g.copy_(avg)
            else:
                g.index_copy_(dim, rows, avg)
