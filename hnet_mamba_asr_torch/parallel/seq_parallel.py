"""Sequence parallelism: the encoder's time axis split over the ranks of an
``sp`` axis, exact against the offline encoder. Counterpart of
``hnet_mamba_asr_tpu/parallel/seq_parallel.py``, whose design this keeps:

- every rank of an sp group holds the same rows; the log-mel features are
  computed whole on each (they are small) and each rank takes its block of
  T / sp frames plus the 3-frame right halo that the x4 subsampling reads
  (the frame count is padded to a multiple of 4 sp; the pad frames lie
  beyond every valid length);
- a Mamba-2 layer's only couplings across shards are the depthwise conv's
  3-frame tail (a halo from the left) and the SSD state. Each rank runs the
  SSD kernel (``ops/ssd_cuda.py::ssd_cuda``) on its block from a zero state
  with ``return_final``; one all-gather of the shards' (sum dt A [B, H],
  final state [B, H, N, P] fp32) and an exclusive log-domain prefix give
  the state entering the shard, whose term is added in closed form,
  ``y_t += C_t exp(cumsum(dt A)_t) S_in``. The gradient of the final state
  reaches the kernel's backward as its ``ds_final``;
- the backward direction of a bidirectional block reverses the global
  sequence (a local flip and the mirror permutation of the shards); pad
  frames, which then lead the valid ones, are exact no-ops (dt and the conv
  input zeroed: decay 1, no update);
- at N > 1 each shard routes its frames (the router's k_{t-1} is the
  previous shard's last key), compacts its kept frames to the front of an
  equal-size local buffer (its slot count, the largest count over the ranks
  rounded up to 64, goes through one all-reduce max per level) and the
  compressed stacks run on these valid-compacted buffers: the conv tail is
  the last 3 globally valid rows before the shard, a reverse flips each
  shard's valid span and mirrors the shards. The dechunk's EMA runs the EMA
  kernel (``ops/ema_cuda.py::ema_cuda``) on the local buffer from a zero
  carry (a shard after the first prepends one zero slot, so that its first
  slot decays a zero carry instead of starting the stream), and one
  all-gather of (sum log(1 - P) over the valid slots, the last valid
  zbar) gives the carry entering the shard, added as exp(S_t) zbar_in;
  frames before the shard's first boundary take that carry. The ratio loss
  takes F and G over every frame of every rank;
- Type B nests the same machinery: the stage-2 router runs on the stage-1
  compacted stream (its k_{t-1} is the last globally valid stage-1 row).

Every cross-shard exchange goes through ``parallel/collectives.py``'s
differentiable all-gather. A hard boundary b = 1[p >= 0.5] may flip where
p lies within ~1e-6 of 0.5 under the changed reduction order; bf16 with
``intra_dtype`` bf16 rounds at other chunk starts than offline (the
shards' boundaries), so exactness holds in fp32 with intra off.

``SPModel`` is the trainer's model for ``train.sp``: the loss of
``DCASRModel.heads_loss`` on the features gathered from the sp group; its
``rows_group`` (the dp axis) is where the batch's rows are split.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from hnet_mamba_asr_torch.models.encoder import EncoderOutput, subsampled_length
from hnet_mamba_asr_torch.models.hnet_chunk import (SLOT_MULTIPLE, gather_slots,
                                                    scatter_to_slots)
from hnet_mamba_asr_torch.models.mamba2 import dense
from hnet_mamba_asr_torch.models.mamba_block import layer_norm
from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda
from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
from hnet_mamba_asr_torch.parallel.collectives import (all_gather, all_reduce_max,
                                                       all_reduce_sum, group_rank,
                                                       group_size)


class Shards(NamedTuple):
    group: object           # the sp group
    rank: int               # this rank's shard index
    n: int                  # shards


# ── cross-shard primitives ───────────────────────────────────────────────────
def _halo_from_left(x: torch.Tensor, n: int, sh: Shards) -> torch.Tensor:
    """The previous shard's last ``n`` frames (zeros on shard 0)."""
    if x.shape[1] < n:
        raise ValueError(f"local block ({x.shape[1]} frames) shorter than the halo ({n}); "
                         "use fewer sp shards for this length")
    if sh.n == 1:
        return torch.zeros_like(x[:, -n:])
    g = all_gather(x[:, -n:], sh.group)
    # shard 0 keeps the gather in its graph (times 0), so that every rank
    # runs the gather's backward collective
    return g[sh.rank - 1] if sh.rank > 0 else g[0] * 0


def _mirror(x: torch.Tensor, sh: Shards) -> torch.Tensor:
    """Shard j <-> shard n-1-j, no local change."""
    if sh.n == 1:
        return x
    return all_gather(x, sh.group)[sh.n - 1 - sh.rank]


def _block_reverse(x: torch.Tensor, sh: Shards) -> torch.Tensor:
    """Reverse the global time axis: a local flip and the mirror."""
    return _mirror(torch.flip(x, dims=[1]), sh)


def _reverse_valid(x: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Per row, reverse the first ``counts`` slots; the others become zeros."""
    L = x.shape[1]
    idx = counts[:, None].long() - 1 - torch.arange(L, device=x.device)[None, :]
    out = torch.gather(x, 1, idx.clamp(min=0)[..., None].expand(-1, -1, x.shape[-1]))
    return torch.where((idx >= 0)[..., None], out, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))


def _mirror_compressed(x, counts, sh: Shards):
    """Globally reverse a per-shard valid-compacted stream: each shard's
    valid span reversed, then the shards mirrored -> (stream, its counts)."""
    return _mirror(_reverse_valid(x, counts), sh), _mirror(counts, sh)


def _last_valid_tail(x: torch.Tensor, counts: torch.Tensor, n: int, sh: Shards):
    """The last ``n`` globally valid rows strictly before this shard's
    segment of a per-shard valid-compacted x [B, L, D], oldest first; zeros
    where fewer exist. Each shard offers its last min(n, count) rows; the
    newest n of the earlier shards' offers are taken."""
    B, L, D = x.shape
    j = torch.arange(n, device=x.device)
    idx = counts[:, None].long() - n + j[None, :]                       # [B, n]
    cand = torch.gather(x, 1, idx.clamp(min=0)[..., None].expand(-1, -1, D))
    if sh.n == 1:
        return torch.zeros(B, n, D, dtype=x.dtype, device=x.device)
    gv = all_gather(cand, sh.group)                                     # [S, B, n, D]
    gvalid = all_gather((idx >= 0).to(torch.int32), sh.group) > 0       # [S, B, n]
    shard = torch.arange(sh.n, device=x.device)[:, None, None]
    key = torch.where(gvalid & (shard < sh.rank), shard * n + j[None, None, :], -1)
    key = key.permute(1, 0, 2).reshape(B, sh.n * n)
    vals = gv.permute(1, 0, 2, 3).reshape(B, sh.n * n, D)
    top, pos = torch.topk(key, n, dim=1)                                # newest first
    tail = torch.gather(vals, 1, pos[..., None].expand(-1, -1, D))
    tail = torch.where((top >= 0)[..., None], tail, torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))
    return torch.flip(tail, dims=[1])


def _prefix(totals: torch.Tensor, finals: torch.Tensor, sh: Shards):
    """The carry entering this shard of a scalar-decay linear recurrence:
    sum over earlier shards s of exp(sum of their and later earlier shards'
    log decays) final_s, from each shard's (total log decay [B, ...], final
    state [B, ...]); the masks act in the log domain, before the exp."""
    gd = all_gather(totals, sh.group)                                   # [S, B, ...]
    gs = all_gather(finals, sh.group)
    c = torch.cumsum(gd, dim=0)
    top = c[max(sh.rank - 1, 0)]
    sel = (torch.arange(sh.n, device=c.device) < sh.rank).view((-1,) + (1,) * (c.dim() - 1))
    logw = torch.where(sel, top[None] - c, torch.full_like(c, float("-inf")))
    w = torch.exp(logw)
    return (w.reshape(w.shape + (1,) * (gs.dim() - w.dim())) * gs).sum(0)


# ── a Mamba-2 layer on a time block ──────────────────────────────────────────
def _mamba2_sp(layer, u, sh: Shards, pad_mask=None, counts=None):
    """``models/mamba2.py::Mamba2.forward`` on a local block [B, L, D] with
    the conv-tail halo, the pad no-ops (``pad_mask`` True = real frame, or
    ``counts`` for a valid-compacted stream) and the SSD state relay."""
    if layer.ngroups != 1:
        raise ValueError("sequence parallelism supports ngroups == 1")
    cd = layer.dtype
    L = u.shape[1]
    z, xBC, dt_raw = layer._project(u, cd)
    if counts is not None:
        pad_mask = torch.arange(L, device=u.device)[None, :] < counts[:, None]
    if pad_mask is not None:
        xBC = xBC * pad_mask[..., None].to(xBC.dtype)
    n = layer.d_conv - 1
    tail = (_last_valid_tail(xBC, counts, n, sh) if counts is not None
            else _halo_from_left(xBC, n, sh))
    conv_in = torch.cat([tail, xBC], dim=1)
    conv = F.conv1d(conv_in.transpose(1, 2), layer.conv_w.to(cd), layer.conv_b.to(cd),
                    groups=conv_in.shape[-1])
    x, B_mat, C_mat = layer._heads(F.silu(conv.transpose(1, 2)))
    dt = F.softplus(dt_raw.float() + layer.dt_bias)                     # [B, L, H]
    if pad_mask is not None:
        dt = torch.where(pad_mask[..., None], dt, 0.0)
    dt = dt.contiguous()
    A = -torch.exp(layer.a_log)
    y, s_local = ssd_cuda(x, dt, A, B_mat, C_mat, chunk_size=layer.chunk_size,
                          return_final=True, intra_dtype=layer.ssd_intra_dtype)
    if sh.n > 1:
        # a_sum <= 0 (dt >= 0, A < 0): every weight below is <= 1
        s_in = _prefix(dt.sum(dim=1) * A, s_local.float(), sh)          # [B, H, N, P]
        cum = torch.exp(torch.cumsum(dt, dim=1) * A)                     # [B, L, H]
        corr = torch.einsum("bln,blh,bhnp->blhp", C_mat[:, :, 0].float(), cum, s_in)
        y = (y.float() + corr).to(y.dtype)
    return layer._output(y, x, z, cd)


def _block_sp(block, x, rev_mask, sh: Shards):
    """A pre-norm residual MambaBlock on a time block."""
    h = layer_norm(x, block.norm, block.dtype)
    y = _mamba2_sp(block.fwd, h, sh)
    if block.bwd is not None:
        yb = _mamba2_sp(block.bwd, _block_reverse(h, sh), sh, pad_mask=rev_mask)
        y = y + _block_reverse(yb, sh)
    return x + y


def _block_sp_c(block, z, counts, sh: Shards):
    """A MambaBlock on a per-shard valid-compacted stream."""
    h = layer_norm(z, block.norm, block.dtype)
    y = _mamba2_sp(block.fwd, h, sh, counts=counts)
    if block.bwd is not None:
        hr, cr = _mirror_compressed(h, counts, sh)
        yb = _mamba2_sp(block.bwd, hr, sh, counts=cr)
        y = y + _reverse_valid(_mirror(yb, sh), counts)
    return z + y


def _stack_sp(stack, x, aux, sh: Shards, compressed: bool = False):
    """A MambaStack's blocks and final LayerNorm; a block is recomputed in the
    backward unless the stack's remat policy is none."""
    fn = _block_sp_c if compressed else _block_sp
    remat = stack.remat_policy != "none" and torch.is_grad_enabled()
    for block in stack.blocks:
        if remat:
            from torch.utils import checkpoint
            x = checkpoint.checkpoint(fn, block, x, aux, sh, use_reentrant=False)
        else:
            x = fn(block, x, aux, sh)
    return layer_norm(x, stack.norm, stack.dtype)


# ── chunking under sp ─────────────────────────────────────────────────────────
def _route(router, x, k_prev_of, valid, first: bool):
    """p, b of ``RoutingModule`` on a local block, k_{t-1} of slot 0 from
    ``k_prev_of(k)``; ``first``: this block starts the stream."""
    q = dense(x, router.W_q, router.dtype).float()
    k = dense(x, router.W_k, router.dtype)
    k_prev = torch.cat([k_prev_of(k), k[:, :-1]], dim=1).float()
    first_rows = torch.full_like(q[:, 0, 0], first, dtype=torch.bool)
    p = router._p(q, k_prev, first_rows)
    m = valid.to(p.dtype)
    return p * m, (p >= 0.5).to(p.dtype) * m


def _ratio(p, b, mask, N: float):
    """The ratio loss and kept fraction of one stage over every frame of the
    batch: its rows and shards lie over every rank (the world group)."""
    m = mask.float()
    denom = all_reduce_sum(m.sum()).clamp(min=1.0)
    Fv = all_reduce_sum((b.float() * m).sum()) / denom
    G = all_reduce_sum((p.float() * m).sum()) / denom
    coef = N / (N - 1.0)
    return coef * ((N - 1.0) * Fv * G + (1.0 - Fv) * (1.0 - G)), Fv


def _compact(x, p, b, limit: int):
    """Kept rows to the front of an equal-size local buffer: (lm (-1 before
    the shard's first boundary), memb, counts, z_buf, P_buf)."""
    keep = b > 0.5
    lm = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    memb = lm.clamp(min=0)
    counts = keep.sum(dim=1)
    top = int(all_reduce_max(counts.max().reshape(1))) if counts.numel() else 0
    M = min(limit, -(-max(top, 1) // SLOT_MULTIPLE) * SLOT_MULTIPLE)
    return lm, memb, counts, scatter_to_slots(x, memb, keep, M), scatter_to_slots(p, memb, keep, M)


def _ema_sp(z, P, counts, sh: Shards, p_clamp: float = 1e-4):
    """The dechunk's EMA on a valid-compacted local buffer z [B, M, D] with
    the carry relay -> (zbar [B, M, D] in z's dtype, the carry entering the
    shard [B, D] fp32)."""
    B, M, D = z.shape
    first = sh.rank == 0
    if first:
        zbar = ema_cuda(z, P, p_clamp)
    else:                      # slot 0 decays a zero carry: prepend a zero slot
        zbar = ema_cuda(F.pad(z, (0, 0, 1, 0)), F.pad(P, (1, 0)), p_clamp)[:, 1:]
    if sh.n == 1:
        return zbar, torch.zeros(B, D, device=z.device)
    valid = torch.arange(M, device=z.device)[None, :] < counts[:, None]
    log_keep = torch.where(valid, torch.log1p(-P.float().clamp(p_clamp, 1.0 - p_clamp)), 0.0)
    if first:
        log_keep = torch.cat([torch.zeros_like(log_keep[:, :1]), log_keep[:, 1:]], dim=1)
    S = torch.cumsum(log_keep, dim=1)                                    # inclusive, <= 0
    last = (counts.long() - 1).clamp(min=0)
    z_last = torch.gather(zbar.float(), 1, last[:, None, None].expand(-1, 1, D))[:, 0]
    z_last = torch.where((counts > 0)[:, None], z_last, 0.0)
    zbar_in = _prefix(S[:, -1], z_last, sh)                              # [B, D]
    zbar = (zbar.float() + torch.exp(S)[..., None] * zbar_in[:, None]).to(z.dtype)
    return zbar, zbar_in


def _dechunk_sp(chunker, zc, P_buf, counts, memb, lm, p, b, sh: Shards):
    """``DynamicChunker.dechunk`` under sp: the EMA with its relay, the
    gather back (frames before the shard's first boundary take the carry),
    the confidence STE."""
    if chunker.ema_smoothing:
        zbar, zbar_in = _ema_sp(zc, P_buf, counts, sh)
        prev = zbar_in.to(zbar.dtype)
    else:
        zbar = zc
        prev = _last_valid_tail(zc, counts, 1, sh)[:, 0]
    x_up = gather_slots(zbar, memb)
    x_up = torch.where((lm >= 0)[..., None], x_up, prev[:, None])
    c = torch.where(b > 0.5, p, 1.0 - p)
    ste = (c + (1.0 - c).detach())[..., None]
    return x_up * ste.to(x_up.dtype)


def _chunk_level(chunker, x, valid, N, sh: Shards, compressed_counts=None):
    """Route, ratio, compact one level; ``compressed_counts``: x is itself a
    valid-compacted stream (Type B stage 2)."""
    if compressed_counts is None:
        k_prev_of = lambda k: _halo_from_left(k, 1, sh)                  # noqa: E731
    else:
        k_prev_of = lambda k: _last_valid_tail(k, compressed_counts, 1, sh)  # noqa: E731
    p, b = _route(chunker.router, x, k_prev_of, valid, sh.rank == 0)
    ratio, kept = _ratio(p, b, valid, N)
    lm, memb, counts, z_buf, P_buf = _compact(x, p, b, x.shape[1])
    return dict(p=p, b=b, ratio=ratio, kept=kept, lm=lm, memb=memb, counts=counts,
                z=z_buf, P=P_buf)


# ── the encoder ───────────────────────────────────────────────────────────────
def sp_supported(encoder) -> tuple[bool, str]:
    """(True, "") where ``sp_encode`` runs the encoder: N = 1, or the
    dynamic chunker at N > 1."""
    from hnet_mamba_asr_torch.models.hnet_chunk import DynamicChunker
    chunker = encoder.chunk if encoder.arch_type == "A" else encoder.chunk1
    if not chunker.identity and not isinstance(chunker, DynamicChunker):
        return False, ("N > 1 sequence parallelism supports the dynamic chunker only "
                       f"(got {type(chunker).__name__})")
    return True, ""


def sp_encode(encoder, feats: torch.Tensor, flens: torch.Tensor, sh: Shards) -> EncoderOutput:
    """The encoder on this rank's time block of ``feats`` [B, T, n_mels]
    (every rank of the sp group holds all of it) -> an EncoderOutput whose
    features are gathered from the group: [B, T'/4, d_outer], T' = T padded
    to a multiple of 4 sp, one or more frames longer than offline, the extra
    frames beyond every valid length. Boundaries (p, b) are this shard's:
    the fine grid's frames [rank L_s, (rank + 1) L_s) at stage 1, the
    shard's compacted layout at stage 2."""
    ok, why = sp_supported(encoder)
    if not ok:
        raise ValueError(why)
    B, T, _ = feats.shape
    Tp = -(-T // (4 * sh.n)) * 4 * sh.n
    Ts = Tp // sh.n
    if Ts // 4 < 4:
        raise ValueError(f"per-shard encoder block {Ts // 4} frames is shorter than the conv "
                         "halo (d_conv - 1 = 3 frames); use fewer sp shards")
    feats = F.pad(feats, (0, 0, 0, Tp + 3 - T))                         # + the last halo
    local = feats[:, sh.rank * Ts:(sh.rank + 1) * Ts + 3]
    x = encoder.subsample.frames(local)                                  # [B, Ls, d]
    Ls = x.shape[1]
    L_tot = sh.n * Ls
    lengths = subsampled_length(flens)
    gpos = sh.rank * Ls + torch.arange(Ls, device=x.device)[None, :]
    fwd_mask = gpos < lengths[:, None]
    rev_mask = gpos >= (L_tot - lengths)[:, None]
    cd = encoder.dtype
    x_enc = _stack_sp(encoder.enc, x, rev_mask, sh)

    def level(chunker, stream, valid, counts_in=None):
        return _chunk_level(chunker, stream, valid, float(chunker.N), sh, counts_in)

    if encoder.arch_type == "A":
        if encoder.chunk.identity:
            z = _stack_sp(encoder.main, dense(x_enc, encoder.proj_in, cd), rev_mask, sh)
            x_dech = dense(z, encoder.proj_out, cd)
            fm = fwd_mask.float()
            stages = [(fm, fm, torch.ones((), device=x.device))]
            ratio = torch.zeros((), device=x.device)
        else:
            c1 = level(encoder.chunk, x_enc, fwd_mask)
            zc = _stack_sp(encoder.main, dense(c1["z"], encoder.proj_in, cd), c1["counts"],
                           sh, compressed=True)
            x_dech = _dechunk_sp(encoder.chunk, dense(zc, encoder.proj_out, cd), c1["P"],
                                 c1["counts"], c1["memb"], c1["lm"], c1["p"], c1["b"], sh)
            stages, ratio = [(c1["p"], c1["b"], c1["kept"])], c1["ratio"]
    elif encoder.chunk1.identity:                                       # Type B, N = 1
        z1 = _stack_sp(encoder.mid, dense(x_enc, encoder.proj1_in, cd), rev_mask, sh)
        z2 = _stack_sp(encoder.main, z1, rev_mask, sh)
        z1_dec = _stack_sp(encoder.mid_dec, z1 + z2, rev_mask, sh)
        x_dech = dense(z1_dec, encoder.proj1_out, cd)
        one = torch.ones((), device=x.device)
        fm = fwd_mask.float()
        stages = [(fm, fm, one), (fm, fm, one)]
        ratio = torch.zeros((), device=x.device)
    else:                                                               # Type B, N > 1
        c1 = level(encoder.chunk1, x_enc, fwd_mask)
        counts1 = c1["counts"]
        z1 = _stack_sp(encoder.mid, dense(c1["z"], encoder.proj1_in, cd), counts1, sh,
                       compressed=True)
        valid1 = torch.arange(z1.shape[1], device=x.device)[None, :] < counts1[:, None]
        c2 = level(encoder.chunk2, z1, valid1, counts1)
        z2 = _stack_sp(encoder.main, c2["z"], c2["counts"], sh, compressed=True)
        x2 = _dechunk_sp(encoder.chunk2, z2, c2["P"], c2["counts"], c2["memb"], c2["lm"],
                         c2["p"], c2["b"], sh)
        z1_dec = _stack_sp(encoder.mid_dec, z1 + x2, counts1, sh, compressed=True)
        x_dech = _dechunk_sp(encoder.chunk1, dense(z1_dec, encoder.proj1_out, cd), c1["P"],
                             counts1, c1["memb"], c1["lm"], c1["p"], c1["b"], sh)
        stages = [(c1["p"], c1["b"], c1["kept"]), (c2["p"], c2["b"], c2["kept"])]
        ratio = c1["ratio"] + c2["ratio"]
    out = _stack_sp(encoder.dec, x_enc + x_dech, rev_mask, sh)
    full = all_gather(out, sh.group)                                    # [S, B, Ls, D]
    full = full.permute(1, 0, 2, 3).reshape(B, L_tot, out.shape[-1])
    return EncoderOutput(full, lengths, ratio, tuple((p, b) for p, b, _ in stages),
                         (out,), tuple(k for _, _, k in stages))


class SPModel:
    """The trainer's model for ``train.sp`` (the JAX ``SPModel``): the
    encoder runs sequence-parallel over the mesh's sp axis, the heads on the
    gathered features; everything else is the wrapped ``DCASRModel``'s
    (``__getattr__``). Every batch's rows are split over the dp axis
    (``rows_group``) and held whole by each rank of an sp group. Under
    FSDP the whole tree is gathered for the step (``fsdp_units``: the sp
    encoder calls its blocks' parts, not their forward)."""

    fsdp_units = False

    def __init__(self, model, mesh):
        ok, why = sp_supported(model.encoder)
        if not ok:
            raise ValueError(why)
        names = mesh.mesh_dim_names or ()
        if "sp" not in names:
            raise ValueError(f"mesh {names} has no 'sp' axis")
        self.model, self.mesh = model, mesh
        sp = mesh.get_group("sp")
        self.shards = Shards(sp, group_rank(sp), group_size(sp))
        self.rows_group = mesh.get_group("dp") if "dp" in names else None

    def loss_fn(self, batch: dict, step: int, train: bool):
        feats, flens = self.model.features(batch, train)
        enc = sp_encode(self.model.encoder, feats, flens, self.shards)
        return self.model.heads_loss(enc, batch, step, train)

    def greedy_decode(self, batch: dict):
        return self.model.greedy_decode(batch)

    def __getattr__(self, name):
        return getattr(self.model, name)
