"""The port's training path against the JAX package on the CPU, in fp32, at a
narrow hybrid config (tests/torch_parity.py::HYBRID_CONFIG): SpecAugment,
the CTC loss, the AED head, loss_fn and every parameter's gradient, the
optimizer and its schedule, checkpoints both ways, the host batch contract,
and the trainer's resume and gradient accumulation."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from torch_parity import HYBRID_CONFIG, NARROW_VOCAB, module_tree, ragged_waves, seeded_tree

from hnet_mamba_asr_torch import convert
from hnet_mamba_asr_torch.data import dataset
from hnet_mamba_asr_torch.eval.metrics import word_errors
from hnet_mamba_asr_torch.models.aed import AEDHead, label_smoothing_loss
from hnet_mamba_asr_torch.ops import specaug
from hnet_mamba_asr_torch.ops.ctc_loss import ctc_infeasible, ctc_loss
from hnet_mamba_asr_torch.tasks.asr_task import build_model, step_generator
from hnet_mamba_asr_torch.training import optim
from hnet_mamba_asr_torch.training.trainer import Trainer
from hnet_mamba_asr_tpu.data import dataset as jdataset
from hnet_mamba_asr_tpu.eval import metrics as jmetrics
from hnet_mamba_asr_tpu.models import aed as jaed
from hnet_mamba_asr_tpu.ops import ctc_loss as jctc_loss
from hnet_mamba_asr_tpu.ops import specaug as jspecaug
from hnet_mamba_asr_tpu.tasks import asr_task as jtask
from hnet_mamba_asr_tpu.training import checkpoint as jckpt
from hnet_mamba_asr_tpu.training import optim as joptim

# fp32 on both sides, summation order only: log-mel (rFFT vs XLA's FFT),
# 4 Mamba blocks, the CTC forward algorithm (torch's native op vs the JAX
# scan) and the AED decoder. Losses to 1e-5 relative; each gradient leaf to
# 1e-4 of its own max (the worst leaf, an a_log, sits at 2.2e-5).
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
V = NARROW_VOCAB
SPECAUG = {"freq_mask_width_range": [0, 5], "num_freq_mask": 2,
           "time_mask_width_ratio_range": [0.0, 0.2], "num_time_mask": 3}


def _items(rng, lengths, token_lens):
    return [{"wave": (0.1 * rng.normal(size=n)).astype(np.float32), "n_samples": n,
             "tokens": rng.integers(4, V, size=u).astype(np.int32), "id": f"u{i}", "index": i}
            for i, (n, u) in enumerate(zip(lengths, token_lens))]


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if k != "ids"}


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items() if k != "ids"}


def _tree_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_model(config, params=None, seed=0):
    model = build_model(config, V, seed=seed, device="cpu")
    if params is not None:
        convert.load_jax_params(model, params)
    return model


@pytest.fixture(scope="module")
def hybrid():
    """The JAX hybrid model, one seeded param tree, a batch of 3 utterances
    and a padding row, and the JAX loss, stats and gradients."""
    rng = np.random.default_rng(0)
    model = jtask.build_model(HYBRID_CONFIG, V)
    params = seeded_tree(jax.eval_shape(model.init_params, jax.random.PRNGKey(0)), seed=1)
    batch = dataset.collate_batch(_items(rng, [16000, 9100, 12000], [6, 3, 4]), pad_id=3,
                                  seed=7, epoch=0, batch_multiple=4)
    (loss, stats), grads = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss_fn(p, b, 0, False), has_aux=True))(params, _jax_batch(batch))
    return dict(model=model, params=params, batch=batch, loss=float(loss),
                stats={k: np.asarray(v) for k, v in stats.items()}, grads=grads)


# ---- SpecAugment --------------------------------------------------------------
def _jax_draws(seed, epoch, index, *, freq_masks, freq_width, time_masks, time_width,
               time_width_ratio):
    """The raw numbers _augment_one draws from (seed, epoch, index)."""
    key = jspecaug.augment_key(seed, epoch, index)
    k_fw, k_fs, k_tw, k_ts = jax.random.split(key, 4)
    fw = jax.random.randint(k_fw, (freq_masks,), 0, freq_width + 1)
    u_fs = jax.random.uniform(k_fs, (freq_masks,))
    tw = (jax.random.uniform(k_tw, (time_masks,)) if time_width_ratio is not None
          else jax.random.randint(k_tw, (time_masks,), 0, time_width + 1))
    u_ts = jax.random.uniform(k_ts, (time_masks,))
    return [torch.from_numpy(np.array(a)) for a in (fw, u_fs, tw, u_ts)]


@pytest.mark.parametrize("conf", [
    {"freq_mask_width_range": [0, 27], "num_freq_mask": 2,
     "time_mask_width_ratio_range": [0.0, 0.05], "num_time_mask": 10},   # the gate config
    {"freq_mask_width_range": [0, 10], "num_freq_mask": 3,
     "time_mask_width_range": [0, 40], "num_time_mask": 2}])
def test_specaug_matches_jax_given_its_draws(rng, conf):
    """The apply step, given the draws _augment_one makes, gives JAX's
    spec_augment output bit for bit (widths, starts, adaptive cap, masks)."""
    kw = specaug.specaug_kwargs(conf)
    feats = rng.normal(size=(4, 300, 80)).astype(np.float32)
    lengths = np.array([300, 233, 120, 17], np.int32)
    index = np.array([5, 0, 17, 3], np.int32)
    seed, epoch = 11, 2
    keys = jnp.stack([jspecaug.augment_key(seed, epoch, int(i)) for i in index])
    want = np.asarray(jspecaug.spec_augment(jnp.asarray(feats), jnp.asarray(lengths), keys, **kw))
    draws = [torch.stack(d) for d in zip(*(_jax_draws(seed, epoch, int(i), **kw) for i in index))]
    masks = specaug.widths_starts(80, torch.from_numpy(lengths), *draws,
                                  time_width_ratio=kw["time_width_ratio"])
    got = specaug.apply_masks(torch.from_numpy(feats), *masks).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any()
    if kw["time_width_ratio"] is not None:       # the adaptive cap holds
        cap = (np.float32(kw["time_width_ratio"]) * lengths.astype(np.float32)).astype(int)
        assert (masks[2].numpy() <= cap[:, None]).all()


def test_specaug_is_a_function_of_seed_epoch_and_index(rng):
    kw = specaug.specaug_kwargs(SPECAUG)
    feats = torch.from_numpy(rng.normal(size=(3, 200, 80)).astype(np.float32))
    lengths = torch.tensor([200, 150, 90])
    a = specaug.spec_augment(feats, lengths, 1, 0, [4, 5, 6], **kw)
    assert torch.equal(a, specaug.spec_augment(feats, lengths, 1, 0, [4, 5, 6], **kw))
    # a row's masks depend on its own index only, not on its batch
    assert torch.equal(a[1:2], specaug.spec_augment(feats[1:2], lengths[1:2], 1, 0, [5], **kw))
    assert not torch.equal(a, specaug.spec_augment(feats, lengths, 1, 1, [4, 5, 6], **kw))


# ---- CTC and AED ---------------------------------------------------------------
def test_ctc_loss_and_infeasible_match_jax(rng):
    """Rows: feasible, with repeats, empty target, and infeasible (0 loss
    and 0 gradient, counted by ctc_infeasible); values and gradients."""
    T, C = 20, 8
    logits = rng.normal(size=(4, T, C)).astype(np.float32)
    flens = np.array([20, 15, 9, 4], np.int32)
    targets = np.array([[1, 2, 2, 3, 4, 5], [3, 3, 3, 1, 0, 0], [0] * 6, [2, 2, 5, 6, 0, 0]],
                       np.int32)
    tlens = np.array([6, 4, 0, 4], np.int32)

    def jloss(lg):
        lp = jax.nn.log_softmax(lg, -1)
        return jctc_loss.ctc_loss(lp, jnp.asarray(flens), jnp.asarray(targets),
                                  jnp.asarray(tlens), blank_id=0, reduction="none")

    want = np.asarray(jloss(jnp.asarray(logits)))
    want_g = np.asarray(jax.grad(lambda lg: jloss(lg).sum())(jnp.asarray(logits)))
    lg = torch.from_numpy(logits).requires_grad_()
    got = ctc_loss(torch.log_softmax(lg, -1), torch.from_numpy(flens),
                   torch.from_numpy(targets), torch.from_numpy(tlens), blank_id=0)
    (got_g,) = torch.autograd.grad(got.sum(), lg)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_RTOL, atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=1e-5)
    assert want[3] == 0 and not got_g[3].any()
    inf = ctc_infeasible(torch.from_numpy(flens), torch.from_numpy(targets),
                         torch.from_numpy(tlens))
    np.testing.assert_array_equal(inf.numpy(), np.asarray(jctc_loss.ctc_infeasible(
        jnp.asarray(flens), jnp.asarray(targets), jnp.asarray(tlens))))
    assert inf.tolist() == [False, False, False, True]


def test_aed_forward_and_label_smoothing_match_jax(rng):
    """Teacher-forced AED logits (eval: no dropout) and the label-smoothed
    CE with length and row masks, against the flax head."""
    d, U = 32, 5
    jhead = jaed.AEDHead(vocab_size=V, d_model=d, n_layers=2, n_heads=2, d_ff=48)
    mem = rng.normal(size=(3, 11, d)).astype(np.float32)
    mlens = np.array([11, 7, 3], np.int32)
    ys = rng.integers(4, V, size=(3, U)).astype(np.int32)
    ylens = np.array([5, 2, 0], np.int32)
    ys_in, ys_out, out_lens = jhead.add_sos_eos(jnp.asarray(ys), jnp.asarray(ylens))
    params = module_tree(jhead, jnp.asarray(mem), jnp.asarray(mlens), ys_in, seed=2)
    want = np.asarray(jax.jit(jhead.apply)({"params": params}, jnp.asarray(mem),
                                           jnp.asarray(mlens), ys_in))
    row_mask = np.array([True, True, False])
    want_loss = float(jaed.label_smoothing_loss(jnp.asarray(want), ys_out, out_lens, 0.1,
                                                row_mask=jnp.asarray(row_mask)))
    head = AEDHead(V, d, n_layers=2, n_heads=2, d_ff=48)
    head.load_state_dict(convert.jax_to_state_dict(params), strict=True)
    t_in, t_out, t_lens = head.add_sos_eos(torch.from_numpy(ys), torch.from_numpy(ylens))
    for a, b in ((t_in, ys_in), (t_out, ys_out), (t_lens, out_lens)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with torch.no_grad():
        got = head(torch.from_numpy(mem), torch.from_numpy(mlens), t_in)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    loss = label_smoothing_loss(got, t_out, t_lens, 0.1, row_mask=torch.from_numpy(row_mask))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    # the MoE decoder (aed_conf.moe): the flax head's logits, pad slots unrouted
    jmoe_head = jaed.AEDHead(vocab_size=V, d_model=d, n_layers=2, n_heads=2, d_ff=48,
                             moe_experts=4, moe_top_k=2, moe_capacity_factor=1.0)
    mparams = module_tree(jmoe_head, jnp.asarray(mem), jnp.asarray(mlens), ys_in, seed=3)
    want_moe = np.asarray(jax.jit(jmoe_head.apply)({"params": mparams}, jnp.asarray(mem),
                                                   jnp.asarray(mlens), ys_in))
    moe_head = AEDHead(V, d, n_layers=2, n_heads=2, d_ff=48, moe_experts=4, moe_top_k=2,
                       moe_capacity_factor=1.0)
    moe_head.load_state_dict(convert.jax_to_state_dict(mparams), strict=True)
    with torch.no_grad():
        got_moe = moe_head(torch.from_numpy(mem), torch.from_numpy(mlens), t_in)
    np.testing.assert_allclose(got_moe.numpy(), want_moe, rtol=0, atol=1e-4)


def test_aed_dropout_is_a_function_of_the_step(rng):
    head = AEDHead(V, 16, n_layers=1, n_heads=2, d_ff=32, dropout=0.3,
                   generator=torch.Generator().manual_seed(0))
    mem, ml = torch.from_numpy(rng.normal(size=(2, 6, 16)).astype(np.float32)), torch.tensor([6, 4])
    ys = torch.tensor([[1, 5, 6], [1, 7, 3]])
    run = lambda step: head(mem, ml, ys, generator=step_generator(step, "cpu"))
    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    assert not torch.equal(run(3), head(mem, ml, ys))        # no generator: eval


# ---- the whole loss ------------------------------------------------------------
def test_loss_fn_and_gradients_match_jax(hybrid):
    """loss_fn (hybrid 0.3 CTC + 0.7 AED, a padding row masked out, eval
    mode) and the gradient of every parameter against jax.value_and_grad of
    the JAX loss_fn, with the same stats keys."""
    j = hybrid
    model = _port_model(HYBRID_CONFIG, j["params"])
    loss, stats = model.loss_fn(_torch_batch(j["batch"]), 0, False)
    assert set(stats) == set(j["stats"])
    np.testing.assert_allclose(loss.item(), j["loss"], rtol=LOSS_RTOL)
    for k, v in j["stats"].items():
        np.testing.assert_allclose(stats[k].float().numpy(), v, rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
    assert float(stats["loss/ctc"]) > 0 and float(stats["loss/aed"]) > 0
    assert int(stats["batch_weight"]) == 3
    params = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, params)
    got = _tree_leaves(convert.state_dict_to_jax_tree(
        {n: g for (n, _), g in zip(model.named_parameters(), grads)}))
    want = _tree_leaves(j["grads"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_TOL * np.abs(w).max() + 1e-12,
                                   err_msg=k)


def test_convert_round_trip_is_the_identity(hybrid):
    """JAX tree -> torch state_dict -> JAX tree gives back every leaf, AED
    included, bit for bit."""
    model = _port_model(HYBRID_CONFIG, hybrid["params"])
    back = _tree_leaves(convert.state_dict_to_jax_tree(model.state_dict()))
    want = _tree_leaves(hybrid["params"])
    assert back.keys() == want.keys() and any("['aed']" in k for k in want)
    for k, w in want.items():
        assert back[k].shape == w.shape and np.array_equal(back[k], w), k


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_keep_the_gradients(hybrid, policy):
    """Recomputation changes what is stored, not what is computed."""
    def grads(p):
        cfg = copy.deepcopy(HYBRID_CONFIG)
        cfg["encoder_conf"]["remat_policy"] = p
        model = _port_model(cfg, hybrid["params"])
        loss, _ = model.loss_fn(_torch_batch(hybrid["batch"]), 0, False)
        return torch.autograd.grad(loss, list(model.parameters()))
    for a, b in zip(grads(policy), grads("none")):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_build_model_heads_and_refusals():
    assert _port_model(HYBRID_CONFIG).aed is not None
    ctc_only = copy.deepcopy(HYBRID_CONFIG)
    ctc_only["model_conf"] = {"ctc_weight": 1.0, "aed_weight": 0.0}
    assert _port_model(ctc_only).aed is None
    # the MoE AED decoder builds with the JAX model's parameter tree
    moe = copy.deepcopy(HYBRID_CONFIG)
    moe["aed_conf"]["moe"] = {"n_experts": 4}
    jmoe = jtask.build_model(moe, V)
    tree = seeded_tree(jax.eval_shape(jmoe.init_params, jax.random.PRNGKey(0)))
    assert _port_model(moe, tree).aed.layers[0].moe.n_experts == 4
    bad = copy.deepcopy(HYBRID_CONFIG)
    bad["encoder_conf"]["remat_policy"] = "offload"
    with pytest.raises(ValueError, match="remat_policy"):
        _port_model(bad)


# ---- optimizer -------------------------------------------------------------------
def test_warmup_lr_matches_jax():
    mine, theirs = optim.warmup_lr(6e-4, 20000), joptim.warmup_lr(6e-4, 20000)
    for count in (0, 1, 2, 100, 19999, 20000, 60000):
        np.testing.assert_allclose(mine(count), float(theirs(count)), rtol=1e-6)
    assert optim.build_schedule(None, 1e-3)(5) == 1e-3


def test_optimizer_matches_optax(hybrid, rng):
    """Clip -> AdamW (decay on >= 2-D leaves) -> warmuplr over 3 updates on
    the same params and gradients as the JAX build_optimizer."""
    conf = {"lr": 1e-2, "weight_decay": 0.1, "betas": [0.9, 0.98], "router_lr_mult": 1.0}
    sched = ("warmuplr", {"warmup_steps": 2})
    params = hybrid["params"]
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * (3.0 if k else 0.01)).astype(np.float32), params)
        for k in range(3)]                       # the first under the clip, the others over
    tx, _, _ = joptim.build_optimizer("adamw", dict(conf), *sched, params, grad_clip=1.0)
    @jax.jit
    def update(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    state, p = tx.init(params), params
    for g in grads:
        p, state = update(g, state, p)
    model = _port_model(HYBRID_CONFIG, params)
    opt, schedule = optim.build_optimizer("adamw", dict(conf), *sched, model)
    named = dict(model.named_parameters())
    for count, g in enumerate(grads):
        for k, t in convert.jax_to_state_dict(g).items():
            named[k].grad = t
        optim.clip_by_global_norm(list(named.values()), 1.0)
        optim.set_lr(opt, schedule(count))
        opt.step()
    got = _tree_leaves(convert.state_dict_to_jax_tree(model.state_dict()))
    for k, w in _tree_leaves(p).items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.build_optimizer("lamb", dict(conf), None, None, model)


# ---- host batches ----------------------------------------------------------------
def test_collate_and_sampler_match_jax(rng):
    items = _items(rng, [16000, 9100, 30000, 4000, 12000], [6, 3, 9, 1, 4])
    for wire in ("float32", "int16"):
        kw = dict(pad_id=3, seed=5, epoch=2, batch_multiple=4, wire_dtype=wire)
        got, want = dataset.collate_batch(items, **kw), jdataset.collate_batch(items, **kw)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    lengths = [dataset.feat_frames(s["n_samples"]) for s in items] * 7
    for epoch in (0, 3):
        a = dataset.BucketBatchSampler(lengths, 400, num_replicas=2, rank=1, seed=9)
        b = jdataset.BucketBatchSampler(lengths, 400, num_replicas=2, rank=1, seed=9)
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert list(a) == list(b) and len(a) == len(b)


def test_word_errors_match_jax():
    for hyp, ref in (("a b c", "a b c"), ("a x c d", "a b c"), ("", "a b"), ("a b", "")):
        assert word_errors(hyp, ref) == jmetrics.word_errors(hyp, ref)


# ---- trainer and checkpoints -------------------------------------------------------
TRAIN_CFG = {"optim": "adamw", "optim_conf": {"lr": 2e-3, "weight_decay": 1e-2},
             "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 3},
             "grad_clip": 1.0, "grad_clip_type": 2.0, "valid_interval_epoch": 1,
             "log_interval": 1}


def _loader(seed=3, **kw):
    items = _items(np.random.default_rng(seed), [8000, 9000, 6400, 7200, 8800, 5600],
                   [4, 5, 3, 4, 4, 2])
    return dataset.ItemLoader(items, max_frames=110, seed=seed, **kw)


def _trainer(tmp_path, config, max_epoch, **cfg):
    from hnet_mamba_asr_torch.tools.gate import seeded_tokenizer
    model = _port_model(config, seed=4)
    tmp_path.mkdir(parents=True, exist_ok=True)
    return Trainer(model, _loader(), dict(TRAIN_CFG, max_epoch=max_epoch, **cfg),
                   dev_loaders={"dev": _loader(seed=8, shuffle=False)},
                   tokenizer=seeded_tokenizer(tmp_path / "tok.model", V),
                   ckpt_dir=tmp_path, seed=3, device="cpu")


def test_resume_is_bit_exact(tmp_path):
    """N steps, save, load, M more == N + M steps straight, on the CPU, with
    SpecAugment and AED dropout on (both functions of integers)."""
    cfg = dict(copy.deepcopy(HYBRID_CONFIG), specaug_conf=SPECAUG)
    straight = _trainer(tmp_path / "a", cfg, 2)
    straight.train()
    assert straight.global_step == 6 and len(straight.history) == 6
    first = _trainer(tmp_path / "b", cfg, 1)
    first.train()
    assert (tmp_path / "b" / "epoch0000.ckpt").exists()
    resumed = _trainer(tmp_path / "b", cfg, 2)
    resumed.train(resume="auto")
    assert resumed.global_step == 6
    assert [h["loss/total"] for h in resumed.history] == \
        [h["loss/total"] for h in straight.history[3:]]
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert straight.metric_history == resumed.metric_history
    assert ("valid", "wer") in straight.metric_history


def test_accum_grad_two_half_batches_equal_one_full(tmp_path):
    """accum_grad 2 over two halves (same token counts, no dropout) gives the
    full batch's gradient: each micro-step's loss is divided by accum."""
    cfg = copy.deepcopy(HYBRID_CONFIG)
    cfg["aed_conf"]["dropout"] = 0.0
    items = _items(np.random.default_rng(6), [8000, 8000, 8000, 8000], [4, 4, 4, 4])
    batch = lambda rows: dataset.collate_batch(rows, pad_id=3, seed=0, epoch=0)

    def grads(accum, batches):
        t = _trainer(tmp_path, cfg, 1, accum_grad=accum)
        for b in batches:
            t._micro_step(b)
        return [p.grad.clone() for p in t.params]

    for a, b in zip(grads(2, [batch(items[:2]), batch(items[2:])]), grads(1, [batch(items)])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(b.abs().max().item(), 1e-3))


def test_checkpoint_loads_in_jax(tmp_path, hybrid):
    """A checkpoint the port writes is read by the JAX package's
    load_checkpoint; its params, applied by the JAX model, give the port's
    CTC log-probs."""
    t = _trainer(tmp_path, HYBRID_CONFIG, 1, max_steps=1)
    t.train()
    state = jckpt.load_checkpoint(tmp_path / "latest.ckpt")
    assert (state["global_step"], state["epoch"], state["seed"]) == (1, 0, 3)
    assert state["opt_state_format"] == "torch" and "torch_opt_state" in state
    jmodel = hybrid["model"]
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(state["params"])
    wave, lens = ragged_waves(np.random.default_rng(1), [9000, 6000])

    @jax.jit
    def log_probs(p, w, n):
        enc = jmodel.encode(p, {"wave": w, "wave_lens": n})
        return enc.lengths, jmodel.ctc.apply({"params": p["ctc"]}, enc.features,
                                             method="log_probs")

    enc_lengths, want = (np.asarray(a) for a in log_probs(state["params"], wave, lens))
    with torch.no_grad():
        penc = t.model.encode({"wave": torch.from_numpy(wave), "wave_lens": torch.from_numpy(lens)})
        got = t.model.ctc.log_probs(penc.features).numpy()
    np.testing.assert_array_equal(penc.lengths.numpy(), enc_lengths)
    for i, n in enumerate(enc_lengths):
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=0, atol=2e-4)


def test_specaug_at_init_gives_finite_gradients():
    """The gate config's depth (4 + 12 + 4 blocks) with its SpecAugment, at
    the port's init: a fully masked frame would reach every block as an
    all-zero vector if the subsampling's biases started at zero (flax's
    init; the JAX model's gradients are then inf / NaN), and each block's
    norms scale its gradient by ~1e5 on the way back."""
    cfg = copy.deepcopy(HYBRID_CONFIG)
    cfg["encoder_conf"] = dict(cfg["encoder_conf"], n_enc=4, n_main=12, n_dec=4)
    cfg["specaug_conf"] = {"freq_mask_width_range": [0, 27], "num_freq_mask": 2,
                           "time_mask_width_ratio_range": [0.0, 0.05], "num_time_mask": 10}
    batch = dataset.collate_batch(_items(np.random.default_rng(2), [160240, 120000], [6, 4]),
                                  pad_id=3, seed=1, epoch=0)
    model = _port_model(cfg, seed=1)
    feats, _ = model.features(_torch_batch(batch), True)
    assert (feats.abs().amax(-1) == 0).sum() > 40              # whole frames masked
    loss, _ = model.loss_fn(_torch_batch(batch), 0, True)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert max(g.abs().max().item() for g in grads) < 1e3
