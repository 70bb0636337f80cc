"""The hand-written Hopper kernels (the SSD scan at (P, N) = (64, 128) and,
fp32, (16, 16), and the H-Net EMA, forward and backward) against their plain
PyTorch versions, on the card. Marked ``gpu``: skipped where no CUDA
device is present. Run on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py``."""
import pytest
import torch

from hnet_mamba_asr_torch.ops.ema import ema_smooth, ema_smooth_sequential
from hnet_mamba_asr_torch.ops.ema_cuda import ema_cuda
from hnet_mamba_asr_torch.ops.ssd import ssd_chunked
from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda

pytestmark = pytest.mark.gpu

Q = 64            # the kernel's chunk length: the plain version runs at it too
# max|y - y_plain| / max|y_plain|. fp32: summation order and exp's last ulp
# only. bf16: both sides round W, the weighted B and the state to bf16 at
# the same points and y to bf16 at the end, so they part only where an fp32
# value sits on a bf16 rounding boundary and the two summation orders (MMA
# vs cuBLAS) or exps tip it: one bf16 ulp of y, 2^-7 of max|y| at most
# (tighter than the 1e-2 this file held the kernel to against an fp32 plain
# result before the plain version rounded). The mean bound holds that such
# flips are rare.
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
# fp32 inputs with intra_dtype bf16: the scores, decays and dt are rounded
# to bf16 on both sides, so a W element may part by one bf16 ulp; that is
# the bf16 bound on y's maximum, the fp32 one on its mean
MEAN_BOUND = {torch.float32: 1e-5, torch.bfloat16: 1e-3}    # mean|d| / mean|y|
# the fp32 state from bf16-rounded operands: one flipped rounding moves a
# term by a bf16 ulp
STATE_BOUND = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SSD kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, B, L, H, P, N, G, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, L, H, P, generator=g).to(cuda, dtype),
            (torch.rand(B, L, H, generator=g) * 0.2 + 0.001).to(cuda),
            (-(torch.rand(H, generator=g) * 15 + 1)).to(cuda),
            torch.randn(B, L, G, N, generator=g).to(cuda, dtype),
            torch.randn(B, L, G, N, generator=g).to(cuda, dtype))


# (B, L, H, P, N, G): K = 1 and L = 1; one chunk per CTA (K <= 8); the switch
# to two chunks per CTA at L = 8 Q + 1; the serving lengths; K 16 (L 1000);
# two rounds (L > 16 Q); groups 2 and 4
SHAPES = [(2, 37, 4, 64, 128, 2), (1, 1, 12, 64, 128, 1), (3, 130, 12, 64, 128, 1),
          (2, 8 * Q + 1, 4, 64, 128, 1), (2, 873, 16, 64, 128, 4),
          (1, 1000, 12, 64, 128, 1), (2, 1100, 4, 64, 128, 2)]


@pytest.mark.parametrize("intra_dtype", [None, "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda, dtype, shape, intra_dtype):
    Bsz, L, H, P, N, G = shape
    x, dt, A, B, C = _inputs(cuda, *shape, dtype)
    s0 = torch.randn(Bsz, H, N, P, device=cuda)
    before = ssd_cuda.launches
    y, s = ssd_cuda(x, dt, A, B, C, initial_state=s0, return_final=True,
                    intra_dtype=intra_dtype)
    y_p, s_p = ssd_chunked(x, dt, A, B, C, chunk_size=Q, initial_state=s0,
                           return_final=True, intra_dtype=intra_dtype)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape and torch.isfinite(y).all()
    d = (y.float() - y_p.float()).abs()
    rel = (d.max() / y_p.float().abs().max()).item()
    mean = (d.mean() / y_p.float().abs().mean()).item()
    rel_s = ((s - s_p).abs().max() / s_p.abs().max()).item()
    bound = BOUND[torch.bfloat16 if intra_dtype == "bf16" else dtype]
    assert rel <= bound and mean <= MEAN_BOUND[dtype], (rel, mean)
    assert rel_s <= STATE_BOUND[dtype], rel_s
    y2 = ssd_cuda(x, dt, A, B, C, intra_dtype=intra_dtype)       # no state in or out
    y2_p = ssd_chunked(x, dt, A, B, C, chunk_size=Q, intra_dtype=intra_dtype)
    d2 = (y2.float() - y2_p.float()).abs()
    assert (d2.max() / y2_p.float().abs().max()).item() <= bound


@pytest.mark.parametrize("intra_dtype", [None, "bf16"])
def test_alone_equals_batched(cuda, intra_dtype):
    """A row alone gives bitwise the result it gets inside a batch with a
    longer L (nonzero data past its length), on its valid span."""
    x, dt, A, B, C = _inputs(cuda, 3, 700, 12, 64, 128, 1, torch.bfloat16, seed=1)
    batched = ssd_cuda(x, dt, A, B, C, intra_dtype=intra_dtype)
    for row, n in ((1, 455), (2, 64), (0, 700)):
        alone = ssd_cuda(*(t[row:row + 1, :n].contiguous() for t in (x, dt)), A,
                         *(t[row:row + 1, :n].contiguous() for t in (B, C)),
                         intra_dtype=intra_dtype)
        assert torch.equal(alone[0], batched[row, :n]), (row, n)


def test_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, B, C = _inputs(cuda, 1, 8, 2, 32, 16, 1, torch.float32)
    with pytest.raises(ValueError, match="not built"):
        ssd_cuda(x, dt, A, B, C)                  # (64, 128) and (16, 16) are built
    x, dt, A, B, C = _inputs(cuda, 1, 8, 2, 16, 16, 1, torch.bfloat16)
    with pytest.raises(ValueError, match="64, 128"):
        ssd_cuda(x, dt, A, B, C)                  # the (16, 16) build is fp32 only
    x, dt, A, B, C = _inputs(cuda, 1, 8, 2, 64, 128, 1, torch.float32)
    with pytest.raises(TypeError):
        ssd_cuda(x.half(), dt, A, B.half(), C.half())
    with pytest.raises(ValueError, match="contiguous"):
        ssd_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, B, C)
    with pytest.raises(ValueError, match="intra_dtype"):
        ssd_cuda(x, dt, A, B, C, intra_dtype="fp16")


# Gradients through ssd_cuda (the backward kernel) against autograd of
# ssd_chunked at chunk 64, as max|d| / max|g_plain| per tensor, and
# mean|d| / mean|g_plain|. fp32: summation order only (dA sums B x L terms of
# both signs, so its bound is looser). bf16 inputs or intra_dtype bf16:
# autograd of the plain version rounds every gradient where the forward
# casts (W, B * coef, S_{k-1}, the intra scores, decays and dt) and the
# kernel keeps them in fp32; on the CPU that difference alone reaches
# 6.5e-3 of the max and 7.4e-3 of the mean (dA), so the bound is 2e-2.
GRAD_BOUND = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_MEAN_BOUND = {"float32": 1e-5, "bfloat16": 1e-2}
DA_BOUND = {"float32": 1e-3, "bfloat16": 2e-2}
GRAD_NAMES = ("x", "dt", "A", "B", "C", "initial_state")

# K 1 with groups; K 3; K 9 (two rounds of the chains); the training shape
# at B 2 (the bf16 backward splits each group's heads over CTAs); K 18 at
# the main path's 16 heads (three rounds of the reverse chain)
GRAD_SHAPES = [(2, 37, 4, 64, 128, 2), (3, 130, 12, 64, 128, 1),
               (2, 8 * Q + 1, 4, 64, 128, 1), (2, 249, 16, 64, 128, 1),
               (1, 1100, 16, 64, 128, 1)]


def _grads(fn, args, w, w_final):
    leaves = [t.detach().clone().requires_grad_() for t in args]
    y, s = fn(*leaves)
    loss = (y.float() * w).sum() + (s * w_final).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("intra_dtype", [None, "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_kernel_gradients_match_plain(cuda, dtype, shape, intra_dtype):
    """The backward kernel through ssd_cuda, with the state in and out:
    every input's gradient, not a detached result (before the backward
    kernel, y on the card had no autograd node and the scan's gradient was
    dropped)."""
    Bsz, L, H, P, N, G = shape
    x, dt, A, B, C = _inputs(cuda, *shape, dtype, seed=2)
    g = torch.Generator().manual_seed(3)
    s0 = torch.randn(Bsz, H, N, P, generator=g).to(cuda)
    w = torch.randn(Bsz, L, H, P, generator=g).to(cuda)
    w_final = torch.randn(Bsz, H, N, P, generator=g).to(cuda)
    args = (x, dt, A, B, C, s0)
    before = ssd_cuda.bwd_launches
    got = _grads(lambda *a: ssd_cuda(*a[:5], initial_state=a[5], return_final=True,
                                     intra_dtype=intra_dtype), args, w, w_final)
    torch.cuda.synchronize()
    assert ssd_cuda.bwd_launches == before + 1
    want = _grads(lambda *a: ssd_chunked(*a[:5], chunk_size=Q, initial_state=a[5],
                                         return_final=True, intra_dtype=intra_dtype),
                  args, w, w_final)
    kind = "bfloat16" if dtype == torch.bfloat16 or intra_dtype == "bf16" else "float32"
    for name, a, b, t in zip(GRAD_NAMES, got, want, args):
        assert a.dtype == t.dtype and a.shape == t.shape and torch.isfinite(a).all(), name
        d = (a.float() - b.float()).abs()
        rel = (d.max() / b.float().abs().max()).item()
        mean = (d.mean() / b.float().abs().mean()).item()
        bound, mean_bound = ((DA_BOUND[kind],) * 2 if name == "A"
                             else (GRAD_BOUND[kind], GRAD_MEAN_BOUND[kind]))
        assert rel <= bound and mean <= mean_bound, (name, rel, mean)


# the fp32 build for headdim 16 and d_state 16 (the tone corpus's narrow
# models): K 1, K 3 with groups, two rounds
SMALL_SHAPES = [(3, 37, 4, 16, 16, 1), (2, 130, 4, 16, 16, 2), (2, 8 * Q + 9, 2, 16, 16, 1)]


@pytest.mark.parametrize("intra_dtype", [None, "bf16"])
@pytest.mark.parametrize("shape", SMALL_SHAPES)
def test_p16_n16_kernels_match_plain(cuda, shape, intra_dtype):
    """The (P, N) = (16, 16) fp32 forward and backward against the plain
    version, with the state in and out, at the fp32 bounds."""
    Bsz, L, H, P, N, G = shape
    x, dt, A, B, C = _inputs(cuda, *shape, torch.float32, seed=4)
    g = torch.Generator().manual_seed(5)
    s0 = torch.randn(Bsz, H, N, P, generator=g).to(cuda)
    w = torch.randn(Bsz, L, H, P, generator=g).to(cuda)
    w_final = torch.randn(Bsz, H, N, P, generator=g).to(cuda)
    y, s = ssd_cuda(x, dt, A, B, C, initial_state=s0, return_final=True,
                    intra_dtype=intra_dtype)
    y_p, s_p = ssd_chunked(x, dt, A, B, C, chunk_size=Q, initial_state=s0,
                           return_final=True, intra_dtype=intra_dtype)
    bound = BOUND[torch.bfloat16 if intra_dtype == "bf16" else torch.float32]
    assert ((y - y_p).abs().max() / y_p.abs().max()).item() <= bound
    assert ((s - s_p).abs().max() / s_p.abs().max()).item() <= STATE_BOUND[torch.float32]
    before = ssd_cuda.bwd_launches
    args = (x, dt, A, B, C, s0)
    got = _grads(lambda *a: ssd_cuda(*a[:5], initial_state=a[5], return_final=True,
                                     intra_dtype=intra_dtype), args, w, w_final)
    assert ssd_cuda.bwd_launches == before + 1
    want = _grads(lambda *a: ssd_chunked(*a[:5], chunk_size=Q, initial_state=a[5],
                                         return_final=True, intra_dtype=intra_dtype),
                  args, w, w_final)
    kind = "bfloat16" if intra_dtype == "bf16" else "float32"
    for name, a, b in zip(GRAD_NAMES, got, want):
        d = (a - b).abs()
        rel = (d.max() / b.abs().max()).item()
        mean = (d.mean() / b.abs().mean()).item()
        bound, mean_bound = ((DA_BOUND[kind],) * 2 if name == "A"
                             else (GRAD_BOUND[kind], GRAD_MEAN_BOUND[kind]))
        assert torch.isfinite(a).all() and rel <= bound and mean <= mean_bound, (name, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_is_deterministic(cuda, dtype):
    """Two backward calls on the same inputs give bitwise-equal gradients:
    the sums over heads, splits, batch and chunks run in a fixed order, with
    no float atomics."""
    from hnet_mamba_asr_torch.ops.ssd_cuda import _backward, _forward
    for shape in ((4, 249, 16, 64, 128, 1), (1, 249, 16, 64, 128, 2)):
        x, dt, A, B, C = _inputs(cuda, *shape, dtype, seed=6)
        dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)).to(cuda, dtype)
        ds = torch.randn(shape[0], shape[2], 128, 64, generator=torch.Generator().manual_seed(8)
                         ).to(cuda)
        _, _, states = _forward(x, dt, A, B, C, None, False, True, keep_states=True)
        one = _backward(x, dt, A, B, C, states, dy, ds, True)
        two = _backward(x, dt, A, B, C, states, dy, ds, True)
        for a, b in zip(one, two):
            assert torch.equal(a, b)


def test_training_call_is_differentiable(cuda):
    """A call without the state, as the model makes it: the gradient of
    every input equals the plain one, and a call with no input requiring
    grad (serving) keeps no state for a backward."""
    x, dt, A, B, C = _inputs(cuda, 2, 249, 12, 64, 128, 1, torch.float32, seed=4)
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y = ssd_cuda(*leaves)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * w).sum(), leaves)
    plain = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    want = torch.autograd.grad((ssd_chunked(*plain, chunk_size=Q) * w).sum(), plain)
    for name, a, b in zip(GRAD_NAMES, got, want):
        bound = DA_BOUND["float32"] if name == "A" else GRAD_BOUND["float32"]
        assert ((a - b).abs().max() / b.abs().max()).item() <= bound, name
    with torch.no_grad():
        assert ssd_cuda(*leaves).grad_fn is None


# ---- the EMA kernel (csrc/ema.cu) ----------------------------------------------------
# As max|d| / max|ref| against fp32 references on the same values.
# - The plain recurrence (ema_smooth_sequential, and autograd of it): fp32
#   in the kernel's order of operations, 1e-5. In bf16 the kernel rounds
#   zbar and dz once at the store and reads zbar_{t-1} for dP from its bf16
#   output: 2^-8 of the max per rounding, 1e-2 with room.
# - The plain matmul form (ema_smooth, and autograd of it): its weights
#   exp(S_t - S_j) difference two cumsums of M logs, |S| up to ~6e2 at
#   M 880, in fp32; it parted from the kernel by 1.5e-4 there (H100), so
#   1e-3. In bf16 it also rounds its weights to bf16: 1e-2.
SEQ_BOUND = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
EMA_BOUND = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
# (B, M, D): M = 1; a partial chunk and a D that 16 bytes of bf16 channels do
# not divide; four chunks at Type B's stage-2 width (four channel tiles); a 35 s
# utterance's slots at N = 1 (14 chunks); M = one chunk and one chunk + 1
# (the kernel's chunk is 64 slots); D 1030, nine channel tiles, the last of 6
EMA_SHAPES = [(3, 1, 384), (2, 70, 100), (4, 256, 512), (1, 880, 384), (2, 64, 384),
              (2, 65, 384), (2, 70, 1030)]


def _ema_inputs(cuda, Bsz, M, D, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(Bsz, M, D, generator=g).to(cuda, dtype)
    p = torch.rand(Bsz, M, generator=g) * 0.8 + 0.1
    p[:, ::10] = 1.0                                     # saturated boundaries
    p[:, 5::10] = 0.0                                    # pad slots
    return z, p.to(cuda)


def _ema_reference(fn, z, p, g):
    """fn's output and its gradients of z and p, in fp32 on z's values."""
    zf, pf = z.float().requires_grad_(), p.clone().requires_grad_()
    out = fn(zf, pf)
    dz, dp = torch.autograd.grad(out, (zf, pf), g.float(), allow_unused=True)
    return out.detach(), dz, torch.zeros_like(p) if dp is None else dp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", EMA_SHAPES)
def test_ema_kernel_matches_plain(cuda, dtype, shape):
    """Forward, dz and dP against the plain recurrence and against the plain
    matmul form (fp32, the same values); zero dP at saturated slots and at
    slot 0."""
    z, p = _ema_inputs(cuda, *shape, dtype)
    zl, pl = z.clone().requires_grad_(), p.clone().requires_grad_()
    before = (ema_cuda.launches, ema_cuda.bwd_launches)
    out = ema_cuda(zl, pl)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    dz, dp = torch.autograd.grad(out, (zl, pl), g)
    torch.cuda.synchronize()
    assert (ema_cuda.launches, ema_cuda.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and dz.dtype == dtype and dp.dtype == torch.float32
    rel = lambda a, b: ((a.float() - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
    for fn, bound in ((ema_smooth_sequential, SEQ_BOUND[dtype]), (ema_smooth, EMA_BOUND[dtype])):
        for a, b in zip((out, dz, dp), _ema_reference(fn, z, p, g)):
            assert torch.isfinite(a).all() and rel(a, b) <= bound, (fn.__name__, rel(a, b))
    assert not dp[:, 0].any() and not dp[:, ::10].any() and not dp[:, 5::10].any()
    if shape[1] == 1:
        assert torch.equal(out, z)


@pytest.mark.parametrize("shape", [(8, 300, 384)] + EMA_SHAPES[3:])
def test_ema_backward_is_deterministic(cuda, shape):
    """The carries fold in chunk order wherever the look-back stops, and dP
    sums each tile's channels and then the tiles in a fixed order, with no
    float atomics: two calls give bitwise-equal outputs and gradients."""
    from hnet_mamba_asr_torch.ops.ema_cuda import _backward, _forward
    for dtype in (torch.float32, torch.bfloat16):
        z, p = _ema_inputs(cuda, *shape, dtype, seed=2)
        g = torch.randn(z.shape, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
        zbar = _forward(z, p, 1e-4)
        assert torch.equal(zbar, _forward(z, p, 1e-4))
        one, two = _backward(z, p, zbar, g, 1e-4), _backward(z, p, zbar, g, 1e-4)
        assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_ema_kernel_refuses_what_it_does_not_take(cuda):
    from hnet_mamba_asr_torch.ops.ema_cuda import _forward
    z, p = _ema_inputs(cuda, 1, 8, 16, torch.float32)
    with pytest.raises(TypeError):
        ema_cuda(z.half(), p)
    with pytest.raises(TypeError):
        ema_cuda(z, p.to(torch.bfloat16))
    # no channel cap: D 1025 (not a multiple of 16 bytes of channels) is taken
    wide = torch.randn(1, 8, 1025, generator=torch.Generator().manual_seed(4)).to(cuda)
    got = ema_cuda(wide, p)
    want = ema_smooth_sequential(wide, p)
    assert ((got - want).abs().max() / want.abs().max()).item() <= SEQ_BOUND[torch.float32]
    with pytest.raises(ValueError):
        ema_cuda(z, p[:, :4].contiguous())
    with pytest.raises(ValueError):
        ema_cuda(z, p.cpu())
    with pytest.raises(ValueError):
        _forward(z[:, :, ::2], p, 1e-4)
    with torch.no_grad():
        assert ema_cuda(z.requires_grad_(), p).grad_fn is None


def test_ema_kernels_refuse_cuda_graph_capture(cuda):
    """Every replay of a captured graph would reuse the epoch of its capture
    and take the look-back flags of the replay before it for its own: a call
    under capture raises before it launches, and the kernels work on after."""
    from hnet_mamba_asr_torch.ops.ema_cuda import _backward, _forward
    z, p = _ema_inputs(cuda, 2, 200, 384, torch.float32)
    g = torch.randn(z.shape, generator=torch.Generator().manual_seed(1)).to(cuda)
    zbar = _forward(z, p, 1e-4)          # built and warmed up outside the capture
    dz, dp = _backward(z, p, zbar, g, 1e-4)
    for call in (lambda: _forward(z, p, 1e-4), lambda: _backward(z, p, zbar, g, 1e-4)):
        with pytest.raises(RuntimeError, match="CUDA graph"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                call()
    torch.cuda.synchronize()
    assert torch.equal(_forward(z, p, 1e-4), zbar)
    assert all(torch.equal(a, b) for a, b in zip(_backward(z, p, zbar, g, 1e-4), (dz, dp)))
