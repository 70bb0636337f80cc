"""The port's SSD (hnet_mamba_asr_torch/ops/ssd.py and the CPU side of the
kernel wrapper) against the JAX package's ssd_reference, ssd_chunked and the
Pallas kernel in interpret mode, at the repo's SSD tolerance of 2e-4
(tests/test_ssd_pallas.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_parity  # noqa: F401  (threads, TF32)

from hnet_mamba_asr_torch.ops.ssd import ssd, ssd_chunked, ssd_reference
from hnet_mamba_asr_torch.ops.ssd_cuda import ssd_cuda
from hnet_mamba_asr_tpu.ops import ssd as jssd
from hnet_mamba_asr_tpu.ops.ssd_pallas import ssd_pallas

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(rng, B=2, L=37, H=3, P=8, N=16, G=1):
    return (rng.normal(size=(B, L, H, P)).astype(np.float32),
            rng.uniform(0.001, 0.2, size=(B, L, H)).astype(np.float32),
            -rng.uniform(0.5, 8.0, size=(H,)).astype(np.float32),
            rng.normal(size=(B, L, G, N)).astype(np.float32),
            rng.normal(size=(B, L, G, N)).astype(np.float32))


def _torch(args):
    return [torch.from_numpy(a) for a in args]


def _jax(args):
    return [jnp.asarray(a) for a in args]


JAX_IMPLS = {
    "reference": lambda a: jssd.ssd_reference(*a),
    "chunked": lambda a: jssd.ssd_chunked(*a, chunk_size=16),
    "pallas": lambda a: ssd_pallas(*a, chunk_size=16, interpret=True),
}
PORT_IMPLS = {
    "reference": lambda t: ssd_reference(*t),
    "chunked": lambda t: ssd_chunked(*t, chunk_size=16),
    "dispatch": lambda t: ssd(*t, chunk_size=8),
}


@pytest.mark.parametrize("jax_impl", sorted(JAX_IMPLS))
def test_port_matches_jax(rng, jax_impl):
    args = _inputs(rng)
    want = np.asarray(JAX_IMPLS[jax_impl](_jax(args)))
    for name, impl in PORT_IMPLS.items():
        np.testing.assert_allclose(impl(_torch(args)).numpy(), want, **TOL,
                                   err_msg=f"port {name} vs jax {jax_impl}")


def test_chunk_invariance(rng):
    args = _inputs(rng, L=48)
    want = np.asarray(jssd.ssd_chunked(*_jax(args), chunk_size=8))
    for q in (8, 16, 64):
        np.testing.assert_allclose(ssd_chunked(*_torch(args), chunk_size=q).numpy(),
                                   want, **TOL, err_msg=f"chunk {q}")


def test_groups(rng):
    args = _inputs(rng, H=4, G=2)
    want = np.asarray(jssd.ssd_reference(*_jax(args)))
    np.testing.assert_allclose(ssd_reference(*_torch(args)).numpy(), want, **TOL)
    np.testing.assert_allclose(ssd_chunked(*_torch(args), chunk_size=8).numpy(),
                               want, **TOL)


def test_strong_decay_finite(rng):
    x, dt, A, Bm, Cm = _inputs(rng, L=40)
    args = (x, dt * 50.0, A, Bm, Cm)
    out = ssd_chunked(*_torch(args), chunk_size=8).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(jssd.ssd_reference(*_jax(args))), **TOL)


def test_initial_state_and_final_state(rng):
    args = _inputs(rng, L=29)
    s0 = rng.normal(size=(2, 3, 16, 8)).astype(np.float32)
    y_j, s_j = jssd.ssd_chunked(*_jax(args), chunk_size=8,
                                initial_state=jnp.asarray(s0), return_final=True)
    for fn in (lambda t, s: ssd_reference(*t, initial_state=s, return_final=True),
               lambda t, s: ssd_chunked(*t, chunk_size=8, initial_state=s,
                                        return_final=True)):
        y, s = fn(_torch(args), torch.from_numpy(s0))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **TOL)


def test_wrapper_on_cpu_runs_the_plain_version(rng):
    t = _torch(_inputs(rng))
    s0 = torch.from_numpy(rng.normal(size=(2, 3, 16, 8)).astype(np.float32))
    before = ssd_cuda.launches
    y, s = ssd_cuda(*t, chunk_size=16, initial_state=s0, return_final=True)
    y_p, s_p = ssd_chunked(*t, chunk_size=16, initial_state=s0, return_final=True)
    assert torch.equal(y, y_p) and torch.equal(s, s_p)
    assert ssd_cuda.launches == before          # the count is of kernel launches


def test_wrapper_refuses_other_devices(rng):
    t = [a.to("meta") for a in _torch(_inputs(rng))]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_cuda(*t)
