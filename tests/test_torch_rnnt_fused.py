"""The plain versions of the RNN-T loss kernels (``ops/rnnt_loss.py::
rnnt_fwd_plain`` / ``rnnt_bwd_plain``: logits -> (loss, lse, w) -> (dlogits,
cb, cl), the kernels' signatures and layouts) against JAX's ``rnnt_loss``
and ``jax.grad`` of it with respect to the logits, on the CPU in fp32, with
edge rows: feat_length 0 and 1, target_length 0, a row shorter than the
batch, a target equal to ``blank_id`` and one past V (clipped), and pad
columns after the classes (the joint GEMM's padded output). The kernels
themselves run on the card only (``tests/test_torch_cuda.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnet_mamba_asr_torch.ops.rnnt_loss import (
    rnnt_bwd_plain, rnnt_fwd_plain, rnnt_loss, skew, unskew)
from hnet_mamba_asr_tpu.ops import rnnt_loss as jrnnt_loss

B, T, U, V = 4, 12, 5, 9
COLS = 12                 # V classes and 3 pad columns
BLANK = 2                 # a middle class: a target can equal it, and one past V clips elsewhere
FEAT = np.array([T, 0, 1, 7], np.int32)
TLEN = np.array([U, 3, 0, 4], np.int32)
LOSS_RTOL = 1e-5          # fp32 on both sides, summation order only
GRAD_TOL = 1e-5           # of the largest dlogit
MASS_TOL = 1e-6           # a frame's cb, a label's cl summed, against -g_b, of |g_b|
CELL_TOL = 1e-6           # a cell's dlogits summed over v, of |cb| + |cl| there


@pytest.fixture(scope="module")
def case():
    """Seeded logits with pad columns, targets with the blank and a clipped
    id, the incoming gradient; JAX's loss and gradient; the plain pair's."""
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(B, T, U + 1, COLS)) * 2).astype(np.float32)
    logits[..., V:] = 1e4                             # pad columns: never read
    targets = rng.integers(0, V, size=(B, U)).astype(np.int32)
    targets[0, 1] = BLANK
    targets[3, 2] = V + 4                             # clipped to V - 1
    g = (rng.normal(size=B) + 0.5).astype(np.float32)

    def jloss(lg):
        return jrnnt_loss.rnnt_loss(lg, jnp.asarray(FEAT), jnp.asarray(targets),
                                    jnp.asarray(TLEN), blank_id=BLANK, reduction="none")
    x = jnp.asarray(logits[..., :V])
    want = np.asarray(jloss(x))
    want_g = np.asarray(jax.grad(lambda lg: (jloss(lg) * jnp.asarray(g)).sum())(x))
    args = (torch.from_numpy(targets), torch.from_numpy(FEAT), torch.from_numpy(TLEN), BLANK)
    lg = torch.from_numpy(logits)
    loss, lse, w = rnnt_fwd_plain(lg, *args, classes=V)
    dlogits, cb, cl = rnnt_bwd_plain(lg, lse, w, *args, torch.from_numpy(g), classes=V)
    return dict(logits=logits, targets=targets, g=g, want=want, want_g=want_g, loss=loss,
                lse=lse, w=w, dlogits=dlogits, cb=cb, cl=cl)


def _inside():
    t = np.arange(T)[None, :, None]
    u = np.arange(U + 1)[None, None, :]
    return (t < np.clip(FEAT, 1, T)[:, None, None]) & (u <= TLEN[:, None, None])


def test_plain_pair_matches_jax_loss_and_gradient(case):
    """The loss to 1e-5 relative and dlogits to 1e-5 of their largest against
    JAX; the feat_length 0 row gives the feat_length 1 value; the plain
    pair's loss equals the frame scan's (``rnnt_loss``, the CPU route)."""
    np.testing.assert_allclose(case["loss"].numpy(), case["want"], rtol=LOSS_RTOL)
    d = case["dlogits"].numpy()
    assert d.shape == case["logits"].shape and d.dtype == np.float32
    np.testing.assert_allclose(d[..., :V], case["want_g"], rtol=0,
                               atol=GRAD_TOL * np.abs(case["want_g"]).max())
    scan = rnnt_loss(torch.from_numpy(case["logits"][..., :V]), torch.from_numpy(FEAT),
                     torch.from_numpy(case["targets"]), torch.from_numpy(TLEN),
                     blank_id=BLANK, reduction="none")
    np.testing.assert_allclose(case["loss"].numpy(), scan.numpy(), rtol=LOSS_RTOL)
    one, _, _ = rnnt_fwd_plain(torch.from_numpy(case["logits"][1:2]),
                               torch.from_numpy(case["targets"][1:2]), torch.tensor([1]),
                               torch.from_numpy(TLEN[1:2]), BLANK, classes=V)
    assert one.item() == case["loss"][1].item()
    np.testing.assert_allclose(case["lse"].numpy(), torch.logsumexp(
        torch.from_numpy(case["logits"][..., :V]), -1).numpy(), rtol=1e-6)


def test_plain_pair_zeros_outside_the_lattice(case):
    """dlogits, cb and cl exactly 0 outside each row's lattice, dlogits in
    the pad columns; cl 0 at u = U_b and cb at the last frame below U_b."""
    inside = _inside()
    d = case["dlogits"].numpy()
    assert not d[~inside].any() and not d[..., V:].any()
    cb, cl = unskew(case["cb"], T).numpy(), unskew(case["cl"], T).numpy()
    assert not cb[~inside].any() and not cl[~inside].any()
    for b in range(B):
        tb, ub = max(FEAT[b], 1), TLEN[b]
        assert not cl[b, :, ub].any() and not cb[b, tb - 1, :ub].any()
    # the layout by anti-diagonal holds each cell once
    assert torch.equal(skew(unskew(case["w"], T)), case["w"])


def test_plain_pair_conserves_the_alignment_mass(case):
    """Each frame's cb summed over u and each label's cl summed over t are
    -g_b (every alignment leaves each frame by one blank and emits each label
    once); each cell's dlogits sum to 0 over v (the softmax sums to 1)."""
    cb, cl = unskew(case["cb"], T).double(), unskew(case["cl"], T).double()
    g = torch.from_numpy(case["g"]).double()
    for b in range(B):
        tb, ub = max(FEAT[b], 1), TLEN[b]
        np.testing.assert_allclose(cb[b, :tb].sum(1).numpy(), -g[b].item(), rtol=0,
                                   atol=MASS_TOL * abs(g[b].item()))
        if ub:
            np.testing.assert_allclose(cl[b, :, :ub].sum(0).numpy(), -g[b].item(), rtol=0,
                                       atol=MASS_TOL * abs(g[b].item()))
    cells = case["dlogits"].double().sum(-1).abs()
    occupancy = cb.abs() + cl.abs()
    assert (cells <= CELL_TOL * occupancy).all(), (cells / occupancy.clamp(min=1e-30)).max()


def test_plain_pair_in_bf16_and_fp64(case):
    """bf16 logits: the pair computes in fp32 and returns dlogits in bf16,
    each within one bf16 rounding of the fp32 pair's on the same values;
    fp64 logits: fp64 throughout, within 1e-5 of the fp32 pair."""
    args = (torch.from_numpy(case["targets"]), torch.from_numpy(FEAT), torch.from_numpy(TLEN),
            BLANK)
    g = torch.from_numpy(case["g"])
    lg16 = torch.from_numpy(case["logits"]).to(torch.bfloat16)
    loss16, lse16, w16 = rnnt_fwd_plain(lg16, *args, classes=V)
    assert lse16.dtype == torch.float32 and w16.dtype == torch.float32
    d16, _, _ = rnnt_bwd_plain(lg16, lse16, w16, *args, g, classes=V)
    loss32, lse32, w32 = rnnt_fwd_plain(lg16.float(), *args, classes=V)
    d32, _, _ = rnnt_bwd_plain(lg16.float(), lse32, w32, *args, g, classes=V)
    assert d16.dtype == torch.bfloat16 and torch.equal(loss16, loss32)
    assert ((d16.float() - d32).abs() <= 2.0 ** -8 * d32.abs()).all()
    lg64 = torch.from_numpy(case["logits"]).double()
    loss64, lse64, w64 = rnnt_fwd_plain(lg64, *args, classes=V)
    d64, _, _ = rnnt_bwd_plain(lg64, lse64, w64, *args, g, classes=V)
    assert d64.dtype == torch.float64
    np.testing.assert_allclose(loss64.numpy(), case["loss"].numpy(), rtol=LOSS_RTOL)
    np.testing.assert_allclose(d64.numpy(), case["dlogits"].numpy(), rtol=0,
                               atol=GRAD_TOL * d64.abs().max().item())
