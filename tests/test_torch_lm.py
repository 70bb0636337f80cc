"""The port's external Transformer LM against the JAX package's: logits and
loss of ``models/lm.py``, ``decoders/lm_scorer.py``'s two scoring
interfaces, the convert round trip of flax's attention kernels, and the
``configs/lm_transformer_500.yaml`` literal. One seeded param tree feeds
both packages, fp32 with TF32 off, held within 1e-5."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hnet_mamba_asr_torch import convert
from hnet_mamba_asr_torch.decoders.lm_scorer import CausalLMScorer
from hnet_mamba_asr_torch.tasks.lm_task import TokenLineLoader, build_lm
from hnet_mamba_asr_torch.tools.gate import LM_CONFIG
from hnet_mamba_asr_tpu.decoders import lm_scorer as jscorer
from hnet_mamba_asr_tpu.tasks import lm_task as jlm_task

from torch_parity import seeded_tree

V = 20
TOL = 1e-5
NARROW_LM = {"lm_conf": {"d_model": 32, "n_layers": 2, "n_heads": 4, "d_ff": 48,
                         "dropout": 0.1, "lsm_weight": 0.1}}


@pytest.fixture(scope="module")
def lms():
    """The JAX LM and the port's, loaded with one seeded tree."""
    jmodel = jlm_task.build_lm(NARROW_LM, V)
    params = seeded_tree(jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)), seed=3)
    model = build_lm(NARROW_LM, V, device="cpu")
    convert.load_jax_params(model, params)
    return jmodel, params, model


def _ragged(rng, n, lo, hi):
    return [rng.integers(4, V, size=int(rng.integers(lo, hi))).tolist() for _ in range(n)]


def test_logits_and_loss_match_jax(lms):
    jmodel, params, model = lms
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, size=(3, 9)).astype(np.int32)
    ids[1, 6:] = 3                                       # pad tail: embedding zeroed
    want = np.asarray(jmodel.lm.apply({"params": params["lm"]}, jnp.asarray(ids)))
    with torch.no_grad():
        got = model.lm(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())
    tokens = rng.integers(4, V, size=(3, 8)).astype(np.int32)
    lens = np.array([8, 3, 5], np.int32)
    row_mask = np.array([True, True, False])
    batch = {"tokens": tokens, "token_lens": lens, "row_mask": row_mask}
    jloss, jstats = jmodel.loss_fn(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                   0, False)
    with torch.no_grad():
        loss, stats = model.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()}, 0,
                                    False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    np.testing.assert_allclose(stats["lm/token_acc"].item(), float(jstats["lm/token_acc"]))
    assert int(stats["batch_weight"]) == int(jstats["batch_weight"]) == 13


def test_scorer_matches_jax(lms):
    """next_logprobs and sequence_logprob within 1e-5 of the JAX scorer's,
    every row alone equal to itself inside the batch, and the sum of the
    per-step log-probs (plus eos) equal to the sequence log-prob."""
    jmodel, params, model = lms
    rng = np.random.default_rng(1)
    prefixes = _ragged(rng, 21, 0, 19)                   # two length buckets, 2 chunks
    jsc = jscorer.CausalLMScorer(jmodel.lm, {"params": params["lm"]})
    sc = CausalLMScorer(model.lm)
    want = jsc.next_logprobs(prefixes)
    got = sc.next_logprobs(prefixes)
    assert got.shape == (21, V) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    alone = np.concatenate([sc.next_logprobs([p]) for p in prefixes[:4]])
    np.testing.assert_array_equal(alone, got[:4])
    seqs = _ragged(rng, 5, 0, 12)
    want_s = jsc.sequence_logprob(seqs)
    got_s = sc.sequence_logprob(seqs)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=TOL)
    steps = [float(sum(sc.next_logprobs([s[:k]])[0, s[k]] for k in range(len(s)))
                   + sc.next_logprobs([s])[0, 2]) for s in seqs]
    np.testing.assert_allclose(steps, got_s, rtol=0, atol=TOL)


def test_load_lm_scorer_reads_a_jax_checkpoint(lms, tmp_path):
    """decode_task.load_lm_scorer builds the LM of a config dict and loads a
    checkpoint the JAX package wrote (pickle, numpy only): the scores of
    the scorer built from the same tree."""
    from types import SimpleNamespace
    from hnet_mamba_asr_torch.tasks.decode_task import load_lm_scorer
    from hnet_mamba_asr_tpu.training import checkpoint as jckpt
    _, params, model = lms
    path = tmp_path / "lm.ckpt"
    jckpt.save_checkpoint(path, {"params": params, "epoch": 3})
    tok = SimpleNamespace(vocab_size=V, bos_id=1, eos_id=2, pad_id=3)
    sc = load_lm_scorer({"lm_checkpoint": str(path)}, NARROW_LM, tok, device="cpu")
    prefixes = [[], [5, 6], [7, 8, 9, 10]]
    np.testing.assert_array_equal(sc.next_logprobs(prefixes),
                                  CausalLMScorer(model.lm).next_logprobs(prefixes))
    with pytest.raises(ValueError, match="lm_checkpoint"):
        load_lm_scorer({}, NARROW_LM, tok, device="cpu")


def test_convert_round_trip_and_token_batches(lms):
    """The port's state_dict back to the flax tree is the tree it loaded
    (the attention's 3-D kernels included); the token-line loader packs
    under its budget with eos counted and pads with pad."""
    _, params, model = lms
    back = convert.state_dict_to_jax_tree(model.state_dict())
    flat = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(back)}
    assert set(flat) == set(got)
    assert any(v.ndim == 3 for v in flat.values())
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])
    lines = [[5] * n for n in (3, 9, 4, 1, 7)]
    loader = TokenLineLoader(lines, 20, seed=2)
    batches = list(loader)
    assert sorted(int(n) for b in batches for n in b["token_lens"]) == [1, 3, 4, 7, 9]
    for b in batches:
        assert len(b["tokens"]) * (int(b["token_lens"].max()) + 1) <= 20
        assert b["tokens"].shape[1] % 8 == 0 and (b["tokens"][b["tokens"] != 5] == 3).all()


def test_lm_literal_matches_yaml():
    """tools/gate.py's LM_CONFIG is configs/lm_transformer_500.yaml's lm_conf,
    and the LM it builds at the 500-piece vocabulary has ~51 M parameters."""
    path = Path(__file__).parents[1] / "configs" / "lm_transformer_500.yaml"
    cfg = yaml.safe_load(path.read_text())
    assert LM_CONFIG["lm_conf"] == cfg["lm_conf"]
    model = build_lm(LM_CONFIG, 500, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    jmodel = jlm_task.build_lm(cfg, 500)
    jn = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))))
    assert n == jn and 50e6 < n < 52e6, n
