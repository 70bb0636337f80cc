"""The port's H-Net models against the JAX package on the CPU, in fp32: the
encoder at Type A N=2, Type B N=4 and the fixed-pool control, the hybrid
loss_fn at N=2 with every gradient (the routers' included), the optimizer's
three groups against optax, the trimmed compressed buffer against M = L,
checkpoints with the router group, and configs/typeA_small_N2.yaml (its
literal in tools/gate.py and its parameter count)."""
import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax
from torch_parity import (
    HYBRID_CONFIG, NARROW_CONFIG, NARROW_VOCAB, assert_boundaries_equal, ragged_waves,
    seeded_tree)

from hnet_mamba_asr_torch import convert
from hnet_mamba_asr_torch.data import dataset
from hnet_mamba_asr_torch.models import fixed_pool, hnet_chunk
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_torch.tools import gate
from hnet_mamba_asr_torch.training import optim
from hnet_mamba_asr_torch.training.trainer import Trainer
from hnet_mamba_asr_tpu.tasks import asr_task as jtask
from hnet_mamba_asr_tpu.training import optim as joptim

REPO = Path(__file__).resolve().parents[1]
V = NARROW_VOCAB
# the same bounds as tests/test_torch_train.py: fp32, summation order only
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
FEATURE_TOL = 1e-4
# N > 1 variants of the narrow encoder (tests/torch_parity.py)
VARIANTS = {"A_N2": {"hnet": {"compression_N": 2}},
            "B_N4": {"arch_type": "B", "n_mid": 1, "hnet": {"compression_N": 4}},
            "fixed_N2": {"hnet": {"compression_N": 2, "chunker": "fixed"}},
            "fixed_B_N4": {"arch_type": "B", "n_mid": 1,
                           "hnet": {"compression_N": 4, "chunker": "fixed"}}}
LENGTHS = [16000, 9100, 12000]


def _config(base, variant):
    cfg = copy.deepcopy(base)
    cfg["encoder_conf"].update(copy.deepcopy(VARIANTS[variant]))
    return cfg


def _jax_params(config, seed=1):
    jm = jtask.build_model(config, V)
    return jm, seeded_tree(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=seed)


def _port(config, params=None, **kw):
    model = build_model(config, V, device="cpu", **kw)
    if params is not None:
        convert.load_jax_params(model, params)
    return model


def _wave_batch():
    wave, lens = ragged_waves(np.random.default_rng(0), LENGTHS)
    return ({"wave": jnp.asarray(wave), "wave_lens": jnp.asarray(lens)},
            {"wave": torch.from_numpy(wave), "wave_lens": torch.from_numpy(lens)})


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _compare_encodings(got, want):
    """Boundaries first and exactly, then features on valid frames, chunk
    embeddings on valid slots, ratio loss and kept fractions."""
    assert len(got.boundaries) == len(want.boundaries)
    for (p, b), (jp, jb) in zip(got.boundaries, want.boundaries):
        assert_boundaries_equal(b.detach().numpy(), jb, jp)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0,
                                   atol=FEATURE_TOL)
    n = got.lengths.numpy()
    np.testing.assert_array_equal(n, np.asarray(want.lengths))
    f, jf = got.features.detach().numpy(), np.asarray(want.features)
    for i in range(len(n)):
        np.testing.assert_allclose(f[i, :n[i]], jf[i, :n[i]], rtol=0, atol=FEATURE_TOL)
    for z, jz, (_, jb) in zip(got.chunk_embeddings, want.chunk_embeddings, want.boundaries):
        counts = np.asarray(jb).sum(1).astype(int)
        for i, c in enumerate(counts):
            np.testing.assert_allclose(z[i, :c].detach().numpy(), np.asarray(jz)[i, :c],
                                       rtol=0, atol=FEATURE_TOL)
    assert abs(got.ratio_loss.item() - float(want.ratio_loss)) <= 1e-6
    for k, jk in zip(got.kept_fractions, want.kept_fractions):
        assert k.item() == pytest.approx(float(jk), abs=1e-7)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_encoder_matches_jax(variant):
    cfg = _config(NARROW_CONFIG, variant)
    jm, params = _jax_params(cfg)
    jb, tb = _wave_batch()
    want = jax.jit(lambda p, b: jm.encode(p, b, train=False))(params, jb)
    with torch.no_grad():
        got = _port(cfg, params).encode(tb)
    _compare_encodings(got, want)
    if variant.startswith("fixed"):
        assert got.ratio_loss.item() == 0.0
    else:
        assert got.ratio_loss.item() > 0.0


@pytest.fixture(scope="module")
def hybrid_n2():
    """The JAX hybrid model at N = 2, one seeded param tree, a batch of 3
    utterances and a padding row, and the JAX loss, stats and gradients."""
    cfg = _config(HYBRID_CONFIG, "A_N2")
    jm, params = _jax_params(cfg)
    rng = np.random.default_rng(0)
    items = [{"wave": (0.1 * rng.normal(size=n)).astype(np.float32), "n_samples": n,
              "tokens": rng.integers(4, V, size=u).astype(np.int32), "id": f"u{i}",
              "index": i} for i, (n, u) in enumerate(zip(LENGTHS, [6, 3, 4]))]
    batch = dataset.collate_batch(items, pad_id=3, seed=7, epoch=0, batch_multiple=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "ids"}
    (loss, stats), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, 0, False), has_aux=True))(params, jbatch)
    return dict(config=cfg, params=params, batch=batch, loss=float(loss),
                stats={k: np.asarray(v) for k, v in stats.items()}, grads=grads)


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items() if k != "ids"}


def test_loss_fn_and_gradients_match_jax(hybrid_n2):
    """loss_fn (hybrid 0.3 CTC + 0.7 AED + 0.03 ratio at N = 2, a padding
    row, eval mode): the loss, every stat and every parameter's gradient,
    the router's W_q / W_k included, against jax.value_and_grad."""
    j = hybrid_n2
    model = _port(j["config"], j["params"])
    loss, stats = model.loss_fn(_torch_batch(j["batch"]), 0, False)
    assert set(stats) == set(j["stats"])
    np.testing.assert_allclose(loss.item(), j["loss"], rtol=LOSS_RTOL)
    for k, v in j["stats"].items():
        np.testing.assert_allclose(stats[k].float().numpy(), v, rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
    assert float(stats["loss/ratio"]) > 0 and 0 < float(stats["kept_fraction"]) < 1
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    got = _leaves(convert.state_dict_to_jax_tree({n: g for (n, _), g in zip(named, grads)}))
    want = _leaves(j["grads"])
    assert got.keys() == want.keys()
    assert any("['router']['W_q']" in k for k in want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_TOL * np.abs(w).max() + 1e-12,
                                   err_msg=k)


def test_type_b_stats_match_jax():
    """Type B emits kept_fraction_1 (stage 2) beside kept_fraction, and sums
    the two stages' ratio losses."""
    cfg = _config(HYBRID_CONFIG, "B_N4")
    cfg["model_conf"] = {"ctc_weight": 1.0, "hnet_ratio_beta": 0.03}
    jm, params = _jax_params(cfg)
    rng = np.random.default_rng(1)
    items = [{"wave": (0.1 * rng.normal(size=n)).astype(np.float32), "n_samples": n,
              "tokens": rng.integers(4, V, size=3).astype(np.int32), "id": str(i),
              "index": i} for i, n in enumerate(LENGTHS)]
    batch = dataset.collate_batch(items, pad_id=3, seed=7, epoch=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "ids"}
    jloss, jstats = jax.jit(lambda p, b: jm.loss_fn(p, b, 0, False))(params, jbatch)
    with torch.no_grad():
        loss, stats = _port(cfg, params).loss_fn(_torch_batch(batch), 0, False)
    assert set(stats) == set(jstats) and "kept_fraction_1" in stats
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k].float().numpy(), np.asarray(v), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)


def test_optimizer_three_groups_match_optax(hybrid_n2):
    """Clip -> AdamW in three groups (default, no_decay and the damped router:
    lr x router_lr_mult, eps router_eps, the default weight decay) ->
    warmuplr, over 3 updates on the same params and gradients as the JAX
    build_optimizer."""
    conf = {"lr": 1e-2, "weight_decay": 0.1, "betas": [0.9, 0.98], "router_lr_mult": 0.5,
            "router_eps": 1e-3}
    sched = ("warmuplr", {"warmup_steps": 2})
    params = hybrid_n2["params"]
    rng = np.random.default_rng(3)
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * (3.0 if k else 0.01)).astype(np.float32), params)
        for k in range(3)]
    tx, _, labels = joptim.build_optimizer("adamw", dict(conf), *sched, params, grad_clip=1.0)
    assert "router" in jax.tree_util.tree_leaves(labels)

    @jax.jit
    def update(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    state, p = tx.init(params), params
    for g in grads:
        p, state = update(g, state, p)
    model = _port(hybrid_n2["config"], params)
    opt, schedule = optim.build_optimizer("adamw", dict(conf), *sched, model)
    by_label = {g["label"]: g for g in opt.param_groups}
    assert set(by_label) == {"default", "no_decay", "router"}
    router = by_label["router"]
    assert (router["lr_mult"], router["eps"], router["weight_decay"]) == (0.5, 1e-3, 0.1)
    assert len(router["params"]) == 2
    named = dict(model.named_parameters())
    for count, g in enumerate(grads):
        for k, t in convert.jax_to_state_dict(g).items():
            named[k].grad = t
        optim.clip_by_global_norm(list(named.values()), 1.0)
        optim.set_lr(opt, schedule(count))
        opt.step()
    assert router["lr"] == 0.5 * schedule(2)
    got = _leaves(convert.state_dict_to_jax_tree(model.state_dict()))
    for k, w in _leaves(p).items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)


def test_convert_keeps_the_router_leaves(hybrid_n2):
    """JAX tree -> torch -> JAX tree, bit for bit, with the router's W_q /
    W_k under encoder/chunk/router, where the optimizer finds them."""
    model = _port(hybrid_n2["config"], hybrid_n2["params"])
    sd = model.state_dict()
    assert {"encoder.chunk.router.W_q.weight", "encoder.chunk.router.W_k.weight"} <= set(sd)
    assert [n for n, lab in optim.param_labels(model.named_parameters()).items()
            if lab == "router"] == ["encoder.chunk.router.W_q.weight",
                                    "encoder.chunk.router.W_k.weight"]
    back = _leaves(convert.state_dict_to_jax_tree(sd))
    want = _leaves(hybrid_n2["params"])
    assert back.keys() == want.keys()
    for k, w in want.items():
        assert np.array_equal(back[k], w), k


@pytest.mark.parametrize("variant", ["A_N2", "B_N4", "fixed_N2"])
def test_trimmed_buffer_equals_the_full_one(monkeypatch, variant):
    """The compressed buffer at the batch's largest count (rounded up to 64)
    and at M = L give the same features and valid-slot chunk embeddings,
    and, with remat full (each block recomputed, never the router), the
    same gradients."""
    cfg = _config(HYBRID_CONFIG, variant)
    cfg["encoder_conf"]["remat_policy"] = "full"
    wave, lens = ragged_waves(np.random.default_rng(2), [60000, 52000])   # L 92
    tb = {"wave": torch.from_numpy(wave), "wave_lens": torch.from_numpy(lens)}

    def run():
        model = _port(cfg, seed=5).train()
        enc = model.encoder(*model.features(tb))
        params = list(model.parameters())
        loss = (enc.features.square() * (enc.features > 0)).mean() + enc.ratio_loss
        return enc, torch.autograd.grad(loss, params, allow_unused=True)

    trimmed, g_trim = run()
    L = trimmed.features.shape[1]
    assert trimmed.chunk_embeddings[0].shape[1] == 64 < L      # fewer than 64 kept
    for mod in (hnet_chunk, fixed_pool):
        monkeypatch.setattr(mod, "compressed_slots", lambda counts, L: L)
    full, g_full = run()
    assert full.chunk_embeddings[0].shape[1] == L
    n = trimmed.lengths
    for i in range(len(n)):
        torch.testing.assert_close(trimmed.features[i, :n[i]], full.features[i, :n[i]],
                                   rtol=0, atol=1e-5)
    for zt, zf, (_, b) in zip(trimmed.chunk_embeddings, full.chunk_embeddings,
                              trimmed.boundaries):
        for i, c in enumerate(b.sum(1).long().tolist()):
            torch.testing.assert_close(zt[i, :c], zf[i, :c], rtol=0, atol=1e-5)
    for a, b in zip(g_trim, g_full):
        if b is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(b.abs().max().item(), 1e-3))


def test_remat_policies_keep_the_gradients_at_n2(hybrid_n2):
    """Recomputing the blocks does not recompute the router, so the trimmed
    buffer has one shape in the forward and the recomputation."""
    def grads(policy):
        cfg = copy.deepcopy(hybrid_n2["config"])
        cfg["encoder_conf"]["remat_policy"] = policy
        model = _port(cfg, hybrid_n2["params"])
        loss, _ = model.loss_fn(_torch_batch(hybrid_n2["batch"]), 0, False)
        return torch.autograd.grad(loss, list(model.parameters()))
    for a, b in zip(grads("full"), grads("none")):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_trainer_resumes_the_router_group(tmp_path):
    """Two updates straight == one, a checkpoint, and one more after
    resume, with the three groups (the router's rate and eps) restored."""
    cfg = _config(HYBRID_CONFIG, "A_N2")
    train_cfg = {"optim": "adamw", "optim_conf": {"lr": 2e-3, "weight_decay": 1e-2,
                                                  "router_lr_mult": 0.5, "router_eps": 1e-5},
                 "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 3},
                 "grad_clip": 1.0, "valid_interval_epoch": 1}
    rng = np.random.default_rng(4)
    items = [{"wave": (0.1 * rng.normal(size=n)).astype(np.float32), "n_samples": n,
              "tokens": rng.integers(4, V, size=3).astype(np.int32), "id": str(i),
              "index": i} for i, n in enumerate([8000, 9000, 6400, 7200])]

    def trainer(path, epochs):
        loader = dataset.ItemLoader(items, max_frames=110, seed=3)
        return Trainer(_port(cfg, seed=4), loader, dict(train_cfg, max_epoch=epochs),
                       ckpt_dir=path, seed=3, device="cpu")

    straight = trainer(tmp_path / "a", 2)
    straight.train()
    first = trainer(tmp_path / "b", 1)
    first.train()
    resumed = trainer(tmp_path / "b", 2)
    resumed.train(resume="auto")
    assert resumed.global_step == straight.global_step == 4
    groups = {g["label"]: g for g in resumed.opt.param_groups}
    assert groups["router"]["eps"] == 1e-5 and groups["router"]["lr_mult"] == 0.5
    assert groups["router"]["lr"] == 0.5 * groups["default"]["lr"]
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert any(h["kept_fraction"] < 1 for h in straight.history)


def test_n2_literal_is_the_yaml():
    """tools/gate.py's copy of configs/typeA_small_N2.yaml, which
    chip_smoke.py and tools/measure.py run: the model's keys and the
    trainer's."""
    with open(REPO / "configs" / "typeA_small_N2.yaml") as f:
        cfg = yaml.safe_load(f)
    lit = gate.N2_CONFIG
    for key in ("frontend_conf", "specaug_conf", "encoder", "encoder_conf", "head",
                "aed_conf", "model_conf"):
        assert lit[key] == cfg[key], key
    assert lit["train"]["precision"] == cfg["train"]["precision"]
    want = {k: cfg[k] for k in ("optim", "optim_conf", "scheduler", "scheduler_conf",
                                "accum_grad")}
    want.update({k: cfg["train"][k] for k in ("max_epoch", "grad_clip", "grad_clip_type",
                                              "log_interval")})
    want["valid_interval_epoch"] = cfg["eval"]["valid_interval_epoch"]
    assert gate.N2_TRAIN == want
    assert gate.N2_BATCH_BINS == cfg["batch_bins"] and gate.SEED == cfg["experiment"]["seed"]


def test_n2_parameter_count_is_the_jax_count():
    """Type A Small N=2, hybrid: the JAX model's count (jax.eval_shape), the
    N = 1 gate's 78,858,409 and the router's two 384 x 384 matrices."""
    jm = jtask.build_model(gate.N2_CONFIG, gate.VOCAB)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    model = build_model(gate.N2_CONFIG, gate.VOCAB, device="cpu")
    got = sum(p.numel() for p in model.parameters())
    assert got == want == 78_858_409 + 2 * 384 ** 2
    assert model.encoder.chunk.router is not None
    assert model.encoder.main.remat_policy == "full"
