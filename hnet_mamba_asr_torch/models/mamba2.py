"""Mamba-2 layer (selective SSM with the SSD scan), counterpart of
``hnet_mamba_asr_tpu/models/mamba2.py``:

    u --in_proj--> [z | xBC | dt]
    xBC --causal depthwise conv(d_conv) + bias -> SiLU--> [x | B | C]
    dt = softplus(dt + dt_bias);  A = -exp(a_log)            (fp32)
    y = SSD(x, dt, A, B, C) + D * x
    y = RMSNorm(y * SiLU(z)) * g             (gated RMSNorm, fp32 statistics)
    out = y @ out_proj

``step`` streams the layer: one block of a stream from a carried state (the
conv tail and the SSD state), as JAX's ``models/streaming.py::_mamba2_stream``.

Under tensor parallelism (``mp``, ``parallel/model_parallel.py``) a rank
holds H / tp heads: its in_proj rows [z_r | x_r | dt_r | B | C] run as two
GEMMs, the rank's z | x | dt on ``copy_to_model(u)`` and B | C (one group,
whole on every rank) on u itself, whose gradient is whole already; B and C
pass ``copy_to_model`` after the conv, so that their gradient, and their
rows' and conv channels', is the sum over every rank's heads. The SSD runs
the rank's heads, the gated RMSNorm's fp32 mean-square is (the ranks' sum
of squares) / d_inner, and the row-split out_proj's partial product is
summed over the ranks in fp32, then cast.

Parameters keep the JAX names and are stored in fp32; ``dtype`` is the
compute dtype (bf16 for the gate config), to which weights are cast at use,
as flax does with ``param_dtype=float32``. Initialization follows the same
recipes: flax's lecun-normal for projections and the conv, A ~ U(1, 16) via
its log, and dt ~ LogUniform(1e-3, 0.1) through inverse softplus with a 1e-4
floor.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from hnet_mamba_asr_torch.ops.ssd import ssd
from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
from hnet_mamba_asr_torch.parallel.model_parallel import even_split

# the row block of the streaming step's GEMMs (dense(row_block=)): a
# session's rows give the same bits alone and pooled with others
STREAM_ROWS = 64
# the row block of a row-split GEMM's fp32 partial product outside training
# (tp): cuBLAS picks the fp32 kernel, and with it the summation order, by
# the row count, and a request alone parted from the same request in a
# batch in bf16 without the blocks (measured on an H100)
TP_ROWS = 256


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator | None):
    """flax ``lecun_normal``: truncated normal (+-2 std) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


def new_linear(d_in: int, d_out: int, bias: bool, generator) -> nn.Linear:
    """nn.Linear with flax Dense's init: lecun-normal weight, zero bias."""
    layer = nn.Linear(d_in, d_out, bias=bias)
    lecun_normal_(layer.weight, d_in, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype, **kw) -> torch.Tensor:
    """``dense_w`` of a layer's weight and bias."""
    return dense_w(x, layer.weight, layer.bias, dtype, **kw)


def row_partial(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
                row_block: int = 0) -> torch.Tensor:
    """A row-split GEMM's partial product x @ w.T in fp32 from operands
    rounded to ``dtype``: the ranks' partials are summed in fp32 and cast
    once, as one GEMM accumulates and rounds (two bf16 partials summed
    would round twice). Outside training the rows run in blocks of
    ``TP_ROWS`` at least (``row_block``), so that a row's result does not
    depend on the batch."""
    if not row_block and not torch.is_grad_enabled():
        row_block = TP_ROWS
    return dense_w(x.to(dtype).float(), w.to(dtype).float(), None, torch.float32,
                   row_block=row_block)


def dense_w(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, dtype: torch.dtype, *,
            row_multiple: int = 1, col_multiple: int = 1, row_block: int = 0,
            keep_pad: bool = False) -> torch.Tensor:
    """x @ w.T + b in the compute ``dtype`` from fp32 weights, as a flax
    Dense with ``param_dtype=float32`` computes.

    ``row_multiple`` / ``col_multiple`` keep each row's result independent
    of how many rows the batch has. cuBLAS picks its GEMM kernel, and with it
    the summation order, by the shape. For most of the model's GEMMs one
    kernel serves every row count, but for a long reduction over few rows it
    splits K, and for an odd N it takes other kernels at other row counts; in
    bf16 a one-ulp difference then grows through the encoder into different
    transcripts for one request alone and inside a batch. Padding the rows
    to a multiple of ``row_multiple`` (one multiple at least) and N to a
    multiple of ``col_multiple`` keeps one kernel for every batch (measured
    on an H100). ``row_block`` goes further, for row counts that vary over
    a wide range (the decode path: a beam's rows, a batch's memory): the
    rows run as GEMMs of exactly ``row_block`` rows each, the last padded,
    so that every call has one shape whatever the row count.
    ``keep_pad`` returns the padded columns too (zeros of the padded weight
    rows and bias), without a slice whose backward would copy the gradient
    into a zero-filled buffer of the padded shape.
    """
    w = w.to(dtype)
    b = None if b is None else b.to(dtype)
    n_out = w.shape[0]
    if col_multiple > 1 and n_out % col_multiple:
        pad = col_multiple - n_out % col_multiple
        w = F.pad(w, (0, 0, 0, pad))
        b = None if b is None else F.pad(b, (0, pad))
    rows = x.reshape(-1, x.shape[-1]).to(dtype)
    m = rows.shape[0]
    if row_block:
        rows = F.pad(rows, (0, 0, 0, -m % row_block))
        out = torch.cat([F.linear(part, w, b) for part in rows.split(row_block)])
        return out[:m, :n_out].reshape(*x.shape[:-1], n_out)
    if row_multiple > 1:
        rows = F.pad(rows, (0, 0, 0, max(row_multiple, -(-m // row_multiple) * row_multiple) - m))
    if keep_pad and rows.shape[0] == m:
        return F.linear(rows, w, b).reshape(*x.shape[:-1], w.shape[0])
    return F.linear(rows, w, b)[:m, :n_out].reshape(*x.shape[:-1], n_out)


class Mamba2(nn.Module):
    """One Mamba-2 mixing layer: [B, L, d_model] -> [B, L, d_model].

    ``ssd_intra_dtype`` ('bf16' or None) goes to the scan as its
    ``intra_dtype``, as in the JAX layer. ``ssd_out_compute_dtype`` is
    accepted for config compatibility and ignored: in the JAX layer it
    compiles to the same program.
    """

    def __init__(self, d_model: int, d_state: int = 128, d_conv: int = 4,
                 expand: int = 2, headdim: int = 64, ngroups: int = 1,
                 chunk_size: int = 256, ssd_intra_dtype: str | None = None,
                 ssd_out_compute_dtype: bool = False, dtype: torch.dtype = torch.float32,
                 a_init_range: tuple[float, float] = (1.0, 16.0),
                 dt_min: float = 0.001, dt_max: float = 0.1,
                 dt_init_floor: float = 1e-4,
                 generator: torch.Generator | None = None):
        super().__init__()
        d_inner = expand * d_model
        if d_inner % headdim != 0:
            raise ValueError(f"expand*d_model ({d_inner}) must be divisible by "
                             f"headdim ({headdim})")
        self.d_inner, self.headdim, self.d_state = d_inner, headdim, d_state
        self.n_heads = d_inner // headdim
        self.ngroups, self.d_conv, self.chunk_size = ngroups, d_conv, chunk_size
        self.ssd_intra_dtype = ssd_intra_dtype
        self.dtype = dtype
        d_bc = ngroups * d_state
        conv_dim = d_inner + 2 * d_bc
        H = self.n_heads

        self.in_proj = new_linear(d_model, 2 * d_inner + 2 * d_bc + H, False, generator)
        # depthwise conv weight [C, 1, d_conv]; JAX keeps it as [d_conv, C]
        # with fan_in d_conv
        self.conv_w = nn.Parameter(lecun_normal_(torch.empty(conv_dim, 1, d_conv),
                                                 d_conv, generator))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim))
        u = torch.rand(H, generator=generator)
        dt = torch.exp(u * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
        dt = torch.clamp(dt, min=dt_init_floor)
        # inverse softplus, so that softplus(dt_bias) == dt at init
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        lo, hi = a_init_range
        self.a_log = nn.Parameter(torch.log(lo + (hi - lo) * torch.rand(H, generator=generator)))
        self.d_skip = nn.Parameter(torch.ones(H))
        self.norm_scale = nn.Parameter(torch.ones(d_inner))
        self.out_proj = new_linear(d_inner, d_model, False, generator)
        self.mp = None                       # a tp Plane (parallel/model_parallel.py)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        if self.mp is not None:
            return self._forward_tp(u)
        cd = self.dtype
        z, xBC, dt_raw = self._project(u, cd)

        # causal depthwise conv over the concatenated x|B|C channels
        x, B_mat, C_mat = self._heads(self._conv(xBC, self.conv_w, self.conv_b, cd))

        dt = F.softplus(dt_raw.float() + self.dt_bias)               # [B,L,H] fp32
        A = -torch.exp(self.a_log)                                   # [H], < 0
        y = ssd(x, dt, A, B_mat, C_mat, chunk_size=self.chunk_size,
                intra_dtype=self.ssd_intra_dtype)                    # [B,L,H,P]
        return self._output(y, x, z, cd)

    def _conv(self, xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, cd: torch.dtype):
        """The causal depthwise conv + bias, then SiLU, over [B, L, C]."""
        L = xbc.shape[1]
        conv = F.conv1d(xbc.transpose(1, 2), w.to(cd), b.to(cd), padding=self.d_conv - 1,
                        groups=xbc.shape[-1])
        return F.silu(conv[..., :L].transpose(1, 2))

    def tp_plan(self, tp: int, prefix: str = "") -> dict:
        """The tp split of this layer's leaves, in the layout ``_forward_tp``
        reads: z, x, dt and the per-head leaves by heads, B and C whole on
        every rank; rank r's in_proj rows are [z_r | x_r | dt_r | B | C] and
        its conv channels [x_r | B | C]."""
        di, H, dbc = self.d_inner, self.n_heads, self.ngroups * self.d_state
        heads = even_split(H, tp, f"{prefix}.n_heads", 0, (H,))
        chans = [torch.arange(h[0] * self.headdim, (h[-1] + 1) * self.headdim) for h in heads]
        bc = torch.arange(2 * di, 2 * di + 2 * dbc)
        rows = [torch.cat([c, di + c, 2 * di + 2 * dbc + h, bc]) for c, h in zip(chans, heads)]
        conv = [torch.cat([c, torch.arange(di, di + 2 * dbc)]) for c in chans]
        plan = {"in_proj.weight": (0, rows), "conv_w": (0, conv), "conv_b": (0, conv),
                "norm_scale": (0, chans), "out_proj.weight": (1, chans)}
        plan.update({leaf: (0, heads) for leaf in ("dt_bias", "a_log", "d_skip")})
        return plan

    def _forward_tp(self, u: torch.Tensor) -> torch.Tensor:
        """``forward`` on the shards of ``mp`` (module docstring), in
        ``tp_plan``'s layout."""
        mp, cd = self.mp, self.dtype
        Bsz, L = u.shape[:2]
        dl, Hl = self.d_inner // mp.size, self.n_heads // mp.size
        G, N, own = self.ngroups, self.d_state, 2 * dl + Hl
        take = mp.take
        first = mp.shards[0]
        w_in, cw, cb = (take(self.in_proj.weight, "in_proj.weight", first),
                        take(self.conv_w, "conv_w", first), take(self.conv_b, "conv_b", first))
        bc = self._conv(dense_w(u, w_in[own:], None, cd), cw[dl:], cb[dl:], cd)
        B_mat, C_mat = (mp.fan(t.reshape(Bsz, L, G, N).contiguous())
                        for t in bc.split(G * N, dim=-1))
        uc = mp.fan(u)
        gated, squares = [], []
        for i, s in enumerate(mp.shards):
            w_in = take(self.in_proj.weight, "in_proj.weight", s)
            z, x, dt_raw = dense_w(uc[i], w_in[:own], None, cd).split([dl, dl, Hl], dim=-1)
            x = self._conv(x, take(self.conv_w, "conv_w", s)[:dl],
                           take(self.conv_b, "conv_b", s)[:dl], cd)
            x = x.reshape(Bsz, L, Hl, self.headdim).contiguous()
            dt = F.softplus(dt_raw.float() + take(self.dt_bias, "dt_bias", s))
            A = -torch.exp(take(self.a_log, "a_log", s))
            y = ssd(x, dt, A, B_mat[i], C_mat[i], chunk_size=self.chunk_size,
                    intra_dtype=self.ssd_intra_dtype)
            y = y + take(self.d_skip, "d_skip", s)[None, None, :, None].to(y.dtype) * x
            g = y.reshape(Bsz, L, dl) * F.silu(z).to(y.dtype)
            gated.append(g)
            squares.append(g.float().square().sum(dim=-1, keepdim=True))
        parts = [row_partial((g.float() * torch.rsqrt(sq / self.d_inner + 1e-5)
                              * take(self.norm_scale, "norm_scale", s)).to(cd),
                             take(self.out_proj.weight, "out_proj.weight", s), cd)
                 for s, g, sq in zip(mp.shards, gated, mp.sum(squares))]
        return mp.reduce(parts).to(cd)

    def _project(self, u: torch.Tensor, cd: torch.dtype, row_block: int = 0):
        """in_proj, split -> (z, x|B|C, dt before its bias)."""
        zxbcdt = dense(u, self.in_proj, cd, row_block=row_block)
        d_bc = self.ngroups * self.d_state
        return torch.split(zxbcdt, [self.d_inner, self.d_inner + 2 * d_bc, self.n_heads], dim=-1)

    def _heads(self, xBC: torch.Tensor):
        """The conv's output [B, L, x|B|C] -> x [B, L, H, P], B and C [B, L, G, N]."""
        Bsz, L, _ = xBC.shape
        G, N = self.ngroups, self.d_state
        x, B_mat, C_mat = torch.split(xBC, [self.d_inner, G * N, G * N], dim=-1)
        return (x.reshape(Bsz, L, self.n_heads, self.headdim).contiguous(),
                B_mat.reshape(Bsz, L, G, N).contiguous(), C_mat.reshape(Bsz, L, G, N).contiguous())

    def _output(self, y: torch.Tensor, x: torch.Tensor, z: torch.Tensor, cd: torch.dtype,
                row_block: int = 0) -> torch.Tensor:
        """The scan's y [B, L, H, P] -> the D skip, the gated RMSNorm (norm
        after gating, fp32 statistics), out_proj in ``cd``."""
        Bsz, L = y.shape[:2]
        y = y + self.d_skip[None, None, :, None].to(y.dtype) * x
        gated = y.reshape(Bsz, L, self.d_inner) * F.silu(z).to(y.dtype)
        g32 = gated.float()
        rms = torch.rsqrt(g32.square().mean(dim=-1, keepdim=True) + 1e-5)
        y = (g32 * rms * self.norm_scale).to(cd)
        return dense(y, self.out_proj, cd, row_block=row_block)

    def step(self, u: torch.Tensor, state: dict, n_real: torch.Tensor | None = None):
        """One block of a stream, u [B, E, d_model] -> (out [B, E, d_model],
        the new state), from ``state`` = {"conv": [B, d_conv - 1, conv_dim]
        (the last rows of x|B|C), "ssd": [B, H, N, P]}, both fp32.

        In fp32 whatever the layer's dtype, as JAX's streaming runs it, and
        the SSD at chunk max(8, E) from the carried state (the kernel on the
        card). ``n_real`` [B] marks each row's first rows as real and the rest
        as padding (a compacted block): dt is zeroed there, so the SSD state
        does not move, and the conv tail is taken at the row's own offset;
        a padding row's output is not defined."""
        f32 = torch.float32
        L = u.shape[1]
        z, xBC, dt_raw = self._project(u, f32, STREAM_ROWS)
        conv_in = torch.cat([state["conv"], xBC], dim=1)              # [B, d_conv-1+E, C]
        C = conv_in.shape[-1]
        conv = F.conv1d(conv_in.transpose(1, 2), self.conv_w, self.conv_b, groups=C)
        x, B_mat, C_mat = self._heads(F.silu(conv.transpose(1, 2)))
        if n_real is None:
            conv_state = conv_in[:, L:]
        else:
            idx = n_real.long()[:, None] + torch.arange(self.d_conv - 1, device=u.device)
            conv_state = conv_in.gather(1, idx[..., None].expand(-1, -1, C))
        dt = F.softplus(dt_raw + self.dt_bias)
        if n_real is not None:
            real = torch.arange(L, device=u.device)[None, :] < n_real[:, None]
            dt = torch.where(real[..., None], dt, 0.0)
        A = -torch.exp(self.a_log)
        y, S = ssd_cuda(x, dt.contiguous(), A, B_mat, C_mat, chunk_size=max(8, L),
                        initial_state=state["ssd"].contiguous(), return_final=True)
        return self._output(y, x, z, f32, STREAM_ROWS), {"conv": conv_state.contiguous(),
                                                          "ssd": S}

    def fresh_state(self, batch: int, device) -> dict:
        """The state of a stream that has seen nothing: zeros."""
        conv_dim = self.d_inner + 2 * self.ngroups * self.d_state
        return {"conv": torch.zeros(batch, self.d_conv - 1, conv_dim, device=device),
                "ssd": torch.zeros(batch, self.n_heads, self.d_state, self.headdim,
                                   device=device)}
