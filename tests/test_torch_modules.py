"""Each module of the port's serving slice against its JAX counterpart, built
from one seeded param tree in the JAX layout and carried over by
hnet_mamba_asr_torch/convert.py. fp32 on both sides."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity import module_tree, ragged_waves

from hnet_mamba_asr_torch.convert import load_jax_params
from hnet_mamba_asr_torch.data.features import GlobalCMVN
from hnet_mamba_asr_torch.models.ctc_head import CTCHead
from hnet_mamba_asr_torch.models.encoder import ConvSubsampling4
from hnet_mamba_asr_torch.models.mamba2 import Mamba2
from hnet_mamba_asr_torch.models.mamba_block import MambaBlock, reverse_sequences
from hnet_mamba_asr_torch.ops.melspec import frame_count, log_mel_spectrogram
from hnet_mamba_asr_tpu.data import features as jfeatures
from hnet_mamba_asr_tpu.models import ctc_head as jctc
from hnet_mamba_asr_tpu.models import encoder as jencoder
from hnet_mamba_asr_tpu.models import mamba2 as jmamba2
from hnet_mamba_asr_tpu.models import mamba_block as jblock
from hnet_mamba_asr_tpu.ops import melspec as jmelspec

# log-mel: the port takes an rFFT where JAX takes a DFT matmul; both fp32
MEL_ATOL = 1e-4
# one layer or block in fp32: summation order only
MODULE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("int16", [False, True])
def test_log_mel_and_cmvn(rng, tmp_path, int16):
    wave, lens = ragged_waves(rng, [4000, 2650])
    if int16:
        wave = np.round(wave * 32767).astype(np.int16)
    feats_j, flens_j = jmelspec.log_mel_spectrogram(jnp.asarray(wave), jnp.asarray(lens))
    feats_t, flens_t = log_mel_spectrogram(torch.from_numpy(wave), torch.from_numpy(lens))
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), rtol=0, atol=MEL_ATOL)
    np.testing.assert_array_equal(flens_t.numpy(), np.asarray(flens_j))
    np.testing.assert_array_equal(frame_count(lens), np.asarray(jmelspec.frame_count(lens)))

    jcmvn = jfeatures.GlobalCMVN(rng.normal(size=80), rng.uniform(0.5, 2.0, size=80))
    jcmvn.save(tmp_path / "cmvn.npz")
    cmvn = GlobalCMVN.load(tmp_path / "cmvn.npz")
    np.testing.assert_allclose(cmvn(feats_t).numpy(), np.asarray(jcmvn(feats_j)),
                               rtol=0, atol=MEL_ATOL * float(np.abs(jcmvn.istd).max()))


def _load(module, tree):
    load_jax_params(module, tree)
    return module.eval()


def test_mamba2(rng):
    jm = jmamba2.Mamba2(d_model=16, d_state=8, headdim=8, chunk_size=16)
    u = rng.normal(size=(2, 37, 16)).astype(np.float32)
    tree = module_tree(jm, jnp.asarray(u))
    want = np.asarray(jax.jit(jm.apply)({"params": tree}, jnp.asarray(u)))
    tm = _load(Mamba2(16, d_state=8, headdim=8, chunk_size=16), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, **MODULE_TOL)


def test_mamba2_bf16_intra(rng):
    """ssd_intra_dtype='bf16' reaches the scan in both packages (fp32 layer,
    H 2); the intra-chunk weights then carry bf16 roundings, at the SSD
    tolerance of tests/test_torch_ssd.py scaled to the layer's output."""
    jm = jmamba2.Mamba2(d_model=16, d_state=8, headdim=16, chunk_size=16,
                        ssd_intra_dtype="bf16")
    u = rng.normal(size=(2, 37, 16)).astype(np.float32)
    tree = module_tree(jm, jnp.asarray(u))
    want = np.asarray(jax.jit(jm.apply)({"params": tree}, jnp.asarray(u)))
    tm = _load(Mamba2(16, d_state=8, headdim=16, chunk_size=16, ssd_intra_dtype="bf16"),
               tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, **MODULE_TOL)
    fp32 = _load(Mamba2(16, d_state=8, headdim=16, chunk_size=16), tree)
    with torch.no_grad():
        assert not np.allclose(fp32(torch.from_numpy(u)).numpy(), want, **MODULE_TOL)


def test_reverse_sequences(rng):
    x = rng.normal(size=(3, 9, 4)).astype(np.float32)
    lens = np.array([9, 5, 0], np.int32)
    want = np.asarray(jblock.reverse_sequences(jnp.asarray(x), jnp.asarray(lens)))
    got = reverse_sequences(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(reverse_sequences(torch.from_numpy(x)).numpy(),
                                  np.asarray(jblock.reverse_sequences(jnp.asarray(x))))


def test_mamba_block_ragged(rng):
    jm = jblock.MambaBlock(d_model=16, d_state=8, headdim=8, chunk_size=8)
    x = rng.normal(size=(2, 20, 16)).astype(np.float32)    # padding is not zero
    lens = np.array([20, 13], np.int32)
    tree = module_tree(jm, jnp.asarray(x), jnp.asarray(lens))
    want = np.asarray(jax.jit(jm.apply)({"params": tree}, jnp.asarray(x),
                                        jnp.asarray(lens)))
    tm = _load(MambaBlock(16, d_state=8, headdim=8, chunk_size=8), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, **MODULE_TOL)


def test_conv_subsampling(rng):
    jm = jencoder.ConvSubsampling4(n_mels=80, d_model=8)
    feats = rng.normal(size=(2, 41, 80)).astype(np.float32)
    lens = np.array([41, 30], np.int32)
    tree = module_tree(jm, jnp.asarray(feats), jnp.asarray(lens))
    x_j, l_j = jax.jit(jm.apply)({"params": tree}, jnp.asarray(feats), jnp.asarray(lens))
    tm = _load(ConvSubsampling4(80, 8), tree)
    with torch.no_grad():
        x_t, l_t = tm(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), **MODULE_TOL)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))


def test_ctc_head(rng):
    jm = jctc.CTCHead(d_model=16, vocab_size=11)
    feats = rng.normal(size=(2, 7, 16)).astype(np.float32)
    tree = module_tree(jm, jnp.asarray(feats))
    tm = _load(CTCHead(16, 11), tree)
    with torch.no_grad():
        lp = tm.log_probs(torch.from_numpy(feats)).numpy()
        ids = tm.frame_argmax(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(
        lp, np.asarray(jm.apply({"params": tree}, jnp.asarray(feats), method="log_probs")),
        **MODULE_TOL)
    np.testing.assert_array_equal(
        ids, np.asarray(jm.apply({"params": tree}, jnp.asarray(feats),
                                 method="frame_argmax")))
    assert tm.blank_id == jm.blank_id == 11


@pytest.mark.parametrize("pair", [("DCASREncoder", jencoder.DCASREncoder),
                                  ("MambaStack", jblock.MambaStack)])
def test_constructor_defaults_match_jax(pair):
    """The port's encoder and Mamba stack take JAX's constructor defaults for
    every argument both have, remat_policy ("full") among them."""
    import dataclasses
    import inspect
    from hnet_mamba_asr_torch.models import encoder, mamba_block
    name, jcls = pair
    cls = getattr(encoder, name, None) or getattr(mamba_block, name)
    mine = {k: p.default for k, p in inspect.signature(cls.__init__).parameters.items()
            if p.default is not inspect.Parameter.empty}
    theirs = {f.name: f.default for f in dataclasses.fields(jcls)
              if f.default is not dataclasses.MISSING}
    shared = sorted(set(mine) & set(theirs) - {"dtype"})
    assert "remat_policy" in shared and mine["remat_policy"] == "full"
    assert {k: mine[k] for k in shared} == {k: theirs[k] for k in shared}
