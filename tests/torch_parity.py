"""Shared set-up for the parity tests of the PyTorch port against the JAX
package (tests/test_torch_*.py): one seeded param tree in the JAX layout,
fed to both packages, in fp32 with TF32 off."""
from __future__ import annotations

import numpy as np
import torch

import jax

torch.set_num_threads(1)                 # tier-1 runs several workers
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NARROW_CONFIG = {
    "encoder_conf": {"arch_type": "A", "d_outer": 32, "d_main": 48, "n_enc": 1,
                     "n_main": 2, "n_dec": 1, "d_state": 16, "headdim": 16,
                     "hnet": {"compression_N": 1}},
    "model_conf": {"ctc_weight": 1.0, "aed_weight": 0.0},
    "train": {"precision": "fp32"},
}
NARROW_VOCAB = 30
# the same encoder with the hybrid heads of the gate config (0.3 CTC + 0.7
# AED) and a one-layer AED decoder
HYBRID_CONFIG = {
    "encoder_conf": NARROW_CONFIG["encoder_conf"],
    "aed_conf": {"n_layers": 1, "n_heads": 2, "d_ff": 64, "dropout": 0.1},
    "model_conf": {"ctc_weight": 0.3, "aed_weight": 0.7, "lsm_weight": 0.1},
    "train": {"precision": "fp32"},
}


def seeded_tree(shapes, seed: int = 0):
    """A JAX param tree of the given shapes (e.g. from ``jax.eval_shape`` of
    an init) filled from numpy by leaf name. Unlike flax's init it gives the
    biases and norm scales non-trivial values, so the converter's handling
    of each is exercised."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "a_log":
            a = np.log(rng.uniform(1.0, 16.0, s.shape))
        elif name == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), s.shape))
            a = dt + np.log(-np.expm1(-dt))
        elif name in ("kernel", "conv_w"):
            a = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "norm_scale", "d_skip", "q_g", "k_g"):
            a = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            a = 0.1 * rng.normal(size=s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def module_tree(module, *example_args, seed: int = 0):
    """Seeded params for a flax module, shaped by an abstract init."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *example_args)
    return seeded_tree(shapes["params"], seed)


def ragged_waves(rng, lengths, total=None):
    """[B, total] float32 speech-scale noise, zero past each row's length."""
    total = total or max(lengths)
    wave = np.zeros((len(lengths), total), np.float32)
    for i, n in enumerate(lengths):
        wave[i, :n] = 0.1 * rng.normal(size=n)
    return wave, np.asarray(lengths, np.int32)


def assert_boundaries_equal(got_b, want_b, p, what: str = "") -> None:
    """Hard boundaries are a cliff: one frame whose p rounds to the other
    side of 0.5 moves every later frame's slot. Compare them first, exactly;
    on a mismatch name how many frames sit within 1e-4 of 0.5."""
    got_b, want_b, p = (np.asarray(a, np.float32) for a in (got_b, want_b, p))
    if not np.array_equal(got_b, want_b):
        near = int((np.abs(p - 0.5) < 1e-4).sum())
        raise AssertionError(f"boundaries differ on {int((got_b != want_b).sum())} frames "
                             f"{what}; {near} frames have |p - 0.5| < 1e-4")
