"""Pipeline parallelism: the main Mamba stack split into stages over the
ranks of a ``pp`` axis, driven by a GPipe schedule. Counterpart of
``hnet_mamba_asr_tpu/parallel/pipeline.py``, whose design this keeps:

- stage s holds the main stack's blocks [s k, (s + 1) k), k = n_main / pp
  (``stage_range``); every rank builds the whole model from the seed, as one
  process does, then drops the other stages' blocks (``keep_stage``). The
  kept blocks keep their global index as their name
  (``encoder.main.blocks.{i}``), so a rank's state_dict keys map to JAX's
  ``encoder/main/block_{i}``. Everything outside the main stack's blocks
  (the subsampling, the outer stacks, the chunker, the main stack's final
  LayerNorm, the heads) is replicated, and every rank of a pp group computes
  it on the same rows;
- the schedule: the rows are split into M microbatches (M = pp by
  default); at tick t = 0 .. M + pp - 2 stage s runs its blocks on
  microbatch t - s (a bubble, t - s outside [0, M), computes nothing), and
  one shift moves every stage's output to the next stage. Every rank makes
  every tick's shift, bubble or not, in the same order, or the group would
  deadlock. The lengths of a microbatch's rows (the length-aware reverse of
  a bidirectional block) are known to every rank;
- the three exchanges (``parallel/collectives.py``): into the pipeline,
  x (the ``proj_in`` output, alike on every rank) passes ``copy_to_model``
  and only stage 0 reads it: its gradient, stage 0's dx and zeros from the
  other stages summed over the group, is the one process's on every rank;
  out of the pipeline, the last stage's buffer (zeros elsewhere) passes
  ``reduce_from_model``, a sum over the group whose adjoint is the
  identity (an all-reduce there would hand the last stage pp times the
  cotangent, as every rank computes the same loss downstream); between
  stages, ``stage_shift`` moves a tensor one rank up the group and its
  adjoint one rank down;
- the backward is written out (``_Pipeline``), not left to autograd's graph
  order, which may order independent nodes differently on different ranks
  and never calls the backward of an exchange whose output the loss does
  not read: reverse ticks, in which stage s takes the gradient of its
  output for microbatch t - s (the last stage from the buffer's gradient,
  the others from the reverse shift), runs its blocks' backward from the
  graph it kept, and shifts its input's gradient to the stage before. A
  stage's parameters are inputs of the ``_Pipeline`` node, whose backward
  returns their gradients summed over the microbatches in reverse tick
  order, so autograd accumulates each into ``.grad`` once (DDP's hooks over
  the dp group fire there). Bubble ticks compute nothing but still shift;
- remat: a stage runs its blocks through ``MambaStack._block_call`` with
  grad on, so the config's ``remat_policy`` holds inside a stage: ``full``
  keeps each block's input per microbatch and recomputes the block in its
  backward (JAX checkpoints every block here: the same two forward passes),
  ``none`` keeps every activation of every microbatch until its backward;
- the main stack's final LayerNorm runs on every rank after the exchange
  out, as in JAX.

A process without a pp group runs every stage in turn (``Stages`` with
``group`` None): the same schedule, shifts as a hand-over between stages
in one process, the one-process witness of what the ranks compute (the
same microbatches, the same gradient sums in the same order). ``PPModel``
is the trainer's model for ``train.pp`` (JAX's ``PPModel``): features ->
``pp_encode`` -> the port's own ``DCASRModel.heads_loss``, so CTC, the AED
with its MoE aux loss, the RNN-T loss and the ratio loss are the plain
loss's (JAX's ``pp_loss_fn`` builds only CTC and AED). Type A only, as in
JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from hnet_mamba_asr_torch.models.mamba_block import layer_norm
from hnet_mamba_asr_torch.parallel.collectives import (copy_to_model, reduce_from_model,
                                                       stage_shift)

MAIN_BLOCKS = "encoder.main.blocks."


class Stages(NamedTuple):
    group: object           # the pp group; None: every stage in this process
    rank: int               # this rank's stage
    n: int                  # stages

    @property
    def mine(self) -> range:
        """The stages this process runs."""
        return range(self.n) if self.group is None else range(self.rank, self.rank + 1)


def stage_range(n_main: int, pp: int, s: int) -> range:
    """The global indices of stage ``s``'s blocks: [s k, (s + 1) k)."""
    if n_main % pp:
        raise ValueError(f"n_layers {n_main} not divisible by pp={pp}")
    k = n_main // pp
    return range(s * k, (s + 1) * k)


def main_block(name: str) -> int | None:
    """The global main-stack block index of a parameter name, or None."""
    if not name.startswith(MAIN_BLOCKS):
        return None
    return int(name[len(MAIN_BLOCKS):].split(".", 1)[0])


def keep_stage(stack, pp: int, s: int) -> None:
    """Drop every block of ``stack`` but stage ``s``'s; the kept blocks
    keep their global index as their name."""
    keep = stage_range(len(stack.blocks), pp, s)
    for key in list(stack.blocks._modules):
        if int(key) not in keep:
            del stack.blocks._modules[key]


class _Plan(NamedTuple):
    stack: object
    stages: Stages
    M: int
    blocks: dict            # stage -> its blocks (those this process holds)
    params: dict            # stage -> its blocks' parameters


def _plan(stack, stages: Stages, microbatches) -> _Plan:
    held = list(stack.blocks)
    if stages.group is None:
        k = len(held) // stages.n
        blocks = {s: held[s * k:(s + 1) * k] for s in stages.mine}
    else:
        blocks = {stages.rank: held}
    params = {s: [p for b in bl for p in b.parameters()] for s, bl in blocks.items()}
    return _Plan(stack, stages, int(microbatches or stages.n), blocks, params)


def _hand_over(sent: dict, stages: Stages, step: int, like: torch.Tensor) -> dict:
    """Each stage's tensor to stage + ``step``: {receiving stage: tensor}.
    On a rank, one ``stage_shift`` of the group (zeros from a stage that
    sent nothing at this tick)."""
    if stages.group is None:
        return {s + step: t for s, t in sent.items()}
    mine = sent.get(stages.rank)
    got = stage_shift(torch.zeros_like(like) if mine is None else mine, stages.group, step)
    return {stages.rank: got}


def _forward_ticks(plan: _Plan, x: torch.Tensor, lengths: torch.Tensor, keep: bool):
    """The forward schedule -> (the last stage's outputs per microbatch,
    {(stage, microbatch): (its input leaf, its output)} when ``keep``)."""
    st, M = plan.stages, plan.M
    if x.shape[0] % M:
        raise ValueError(f"local batch {x.shape[0]} not divisible by microbatches={M}")
    xs, ls = x.chunk(M), lengths.chunk(M)
    ticks = M + st.n - 1
    inbox, saved, outs = {}, {}, [None] * M
    for t in range(ticks):
        sent = {}
        for s in st.mine:
            mb = t - s
            if not 0 <= mb < M:
                continue                                  # a bubble
            h = xs[mb] if s == 0 else inbox[s]
            if keep:
                h = h.detach().requires_grad_()
            out = h
            for block in plan.blocks[s]:
                out = plan.stack._block_call(block, out, ls[mb])
            if keep:
                saved[(s, mb)] = (h, out)
            out = out.detach()
            if s == st.n - 1:
                outs[mb] = out
            sent[s] = out
        if t < ticks - 1:
            inbox = _hand_over(sent, st, 1, xs[0])
    return outs, saved


def _backward_ticks(plan: _Plan, saved: dict, g: torch.Tensor):
    """The reverse schedule -> (dx, or zeros off stage 0; the gradients of
    ``plan.params`` in their order, each summed over the microbatches in
    reverse tick order)."""
    st, M = plan.stages, plan.M
    gs = g.chunk(M)
    ticks = M + st.n - 1
    inbox, dxs = {}, [None] * M
    acc = {s: [None] * len(ps) for s, ps in plan.params.items()}
    for t in reversed(range(ticks)):
        sent = {}
        for s in st.mine:
            mb = t - s
            if not 0 <= mb < M:
                continue
            gout = gs[mb] if s == st.n - 1 else inbox[s]
            h, out = saved.pop((s, mb))
            d = torch.autograd.grad(out, [h] + plan.params[s], gout, allow_unused=True)
            for i, dp in enumerate(d[1:]):
                if dp is not None:
                    acc[s][i] = dp if acc[s][i] is None else acc[s][i] + dp
            if s == 0:
                dxs[mb] = d[0]
            sent[s] = d[0]
        if t > 0:
            inbox = _hand_over(sent, st, -1, gs[0])
    dx = torch.cat(dxs) if 0 in st.mine else torch.zeros_like(g)
    grads = [torch.zeros_like(p) if a is None else a
             for s in st.mine for p, a in zip(plan.params[s], acc[s])]
    return dx, grads


class _Pipeline(torch.autograd.Function):
    """x -> the last stage's buffer (zeros on the other stages' ranks), with
    the explicit reverse schedule as its backward; the stages' parameters
    are inputs, so their gradients reach ``.grad`` through this node."""

    @staticmethod
    def forward(ctx, x, lengths, plan, *params):
        with torch.enable_grad():
            outs, saved = _forward_ticks(plan, x, lengths, keep=True)
        ctx.plan, ctx.saved = plan, saved
        if plan.stages.n - 1 in plan.stages.mine:
            return torch.cat(outs)
        return torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        dx, grads = _backward_ticks(ctx.plan, ctx.saved, g.contiguous())
        ctx.saved = None
        # dx is zeros, never None, off stage 0: every rank then runs the
        # backward of the exchange into the pipeline (a sum over the group)
        return (dx, None, None, *grads)


def pp_stack_apply(stack, x: torch.Tensor, lengths: torch.Tensor, stages: Stages,
                   microbatches: int | None = None) -> torch.Tensor:
    """``MambaStack.forward`` (blocks + final LayerNorm) with the blocks
    pipelined over ``stages``: ``x`` [B, L, D] and ``lengths`` [B] alike on
    every rank of the group, ``stack`` holding this rank's stage (every
    block without a group). The same output on every rank."""
    plan = _plan(stack, stages, microbatches)
    params = [p for s in stages.mine for p in plan.params[s]]
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        buf = _Pipeline.apply(copy_to_model(x, stages.group), lengths, plan, *params)
    else:
        outs, _ = _forward_ticks(plan, x, lengths, keep=False)
        buf = (torch.cat(outs) if stages.n - 1 in stages.mine else torch.zeros_like(x))
    if stages.group is not None:
        buf = reduce_from_model(buf, stages.group)
    return layer_norm(buf, stack.norm, stack.dtype)


def pp_encode(encoder, feats: torch.Tensor, flens: torch.Tensor, stages: Stages,
              microbatches: int | None = None):
    """The Type A encoder with its main stack pipelined; everything else runs
    through the encoder's own modules (``DCASREncoder.forward``'s ``main``)."""
    if encoder.arch_type != "A":
        raise ValueError("pipeline parallelism supports Type A configs (v1); "
                         "Type B has three compressed stacks to pipeline")
    return encoder(feats, flens, main=lambda z, lengths: pp_stack_apply(
        encoder.main, z, lengths, stages, microbatches))


class PPModel:
    """The trainer's model for ``train.pp`` (the JAX ``PPModel``): the main
    stack pipelined over the mesh's pp axis, the rest of ``DCASRModel``
    (``__getattr__``) replicated; every batch's rows split over the dp axis
    (``rows_group``) and held whole by each rank of a pp group. Without a
    mesh, ``pp`` stages run in turn in this process (the witness).

    ``layout``: the whole model's (name, shape) in parameter order, taken
    before the other stages are dropped; the trainer gathers checkpoints
    and takes the clip's norm in that order."""

    def __init__(self, model, mesh=None, *, pp: int | None = None,
                 microbatches: int | None = None):
        if mesh is not None:
            names = mesh.mesh_dim_names or ()
            if "pp" not in names:
                raise ValueError(f"mesh {names} has no 'pp' axis")
            stages = Stages(mesh.get_group("pp"), mesh.get_local_rank("pp"),
                            mesh.size(names.index("pp")))
            self.rows_group = mesh.get_group("dp") if "dp" in names else None
        else:
            if not pp or int(pp) < 1:
                raise ValueError("a PPModel without a mesh takes pp= (its stages, run in turn)")
            stages, self.rows_group = Stages(None, 0, int(pp)), None
        if model.encoder.arch_type != "A":
            raise ValueError("pipeline parallelism supports Type A (v1)")
        n_main = len(model.encoder.main.blocks)
        if n_main % stages.n:
            raise ValueError(f"n_main={n_main} not divisible by pp={stages.n}")
        self.model, self.stages, self.microbatches = model, stages, microbatches
        self.layout = [(n, tuple(p.shape)) for n, p in model.named_parameters()
                       if p.requires_grad]
        if stages.group is not None:
            keep_stage(model.encoder.main, stages.n, stages.rank)

    def encode(self, batch: dict, train: bool = False):
        feats, flens = self.model.features(batch, train)
        return pp_encode(self.model.encoder, feats, flens, self.stages, self.microbatches)

    def loss_fn(self, batch: dict, step: int, train: bool):
        return self.model.heads_loss(self.encode(batch, train), batch, step, train)

    def greedy_decode(self, batch: dict):
        return self.model.greedy_decode(batch, encode=self.encode)

    def replicated(self) -> list:
        """The parameters every rank of a pp group holds (all but the
        stage's blocks)."""
        return [p for n, p in self.model.named_parameters()
                if p.requires_grad and main_block(n) is None]

    def leaf_norms(self) -> torch.Tensor:
        """Every leaf's gradient norm over the whole model, in its parameter
        order (``layout``): this rank's stage leaves and, from stage 0, the
        replicated ones, summed over the pp group (each slot has one
        contributor: exact) -> the clip's norm of one process's leaves."""
        index = {n: i for i, (n, _) in enumerate(self.layout)}
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.grad is not None and (main_block(n) is not None or self.stages.rank == 0)]
        vec = torch.zeros(len(self.layout), device=self.model.device)
        if named:
            vec[torch.tensor([index[n] for n, _ in named], device=vec.device)] = torch.stack(
                [torch.linalg.vector_norm(p.grad.float()) for _, p in named])
        if self.stages.group is not None:
            torch.distributed.all_reduce(vec, group=self.stages.group)
        return vec

    def __getattr__(self, name):
        return getattr(self.model, name)
