"""The port's pipeline plane (``parallel/pipeline.py``) on the CPU against
the JAX package, at the widths of ``tests/test_pipeline.py`` (d_outer 24,
d_main 36, n_main 4, headdim 12, d_state 16, chunk 16), the weights carried
across by ``convert.py``: the stack (unidirectional and bidirectional) at
pp = 2 against JAX's ``MambaStack.apply`` (2e-5), the encoder at N = 1 and
N = 4 against JAX's plain encoder (2e-4, the ratio loss 1e-6), the loss and
every gradient against JAX's ``loss_fn`` (2e-4, 5e-3 of each leaf's max),
the MoE-AED loss against the port's plain loss (aux included), one Trainer
update at (dp, pp) = (2, 2) against the port's one process (1e-4), the
gathered checkpoint in one process and one process's checkpoint resumed
under pp, the stage shift's adjoint and the guards. Four gloo ranks
(``tests/torch_dist.py``), spawned once for the file, run as a (dp, pp) =
(2, 2) mesh; JAX's references are computed while they run. Also JAX's own
``pp_loss_fn``, which leaves out the MoE aux loss that its ``loss_fn`` adds
(recorded, not repaired), and ``train.scan_steps``: the port's versions of
``tests/test_trainer.py``'s scan tests, with the host reads counted."""
import copy
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_dist import run_pair

from hnet_mamba_asr_torch import convert
from hnet_mamba_asr_torch.parallel import mesh as pmesh
from hnet_mamba_asr_torch.parallel.pipeline import PPModel, Stages, pp_encode, stage_range
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_torch.training import checkpoint as ckpt
from hnet_mamba_asr_torch.training.trainer import Trainer
from hnet_mamba_asr_tpu.models.mamba_block import MambaStack as JStack
from hnet_mamba_asr_tpu.parallel.mesh import make_mesh as jmake_mesh
from hnet_mamba_asr_tpu.parallel.pipeline import pp_loss_fn, stack_block_params
from hnet_mamba_asr_tpu.tasks import asr_task as jtask

VOCAB = 40
AUX_WEIGHT = 0.5
# tests/test_pipeline.py::test_pp_trainer_step_matches_plain's, without async saves
TCFG = {"max_epoch": 1, "grad_clip": 5.0, "accum_grad": 1, "log_interval": 1,
        "valid_interval_epoch": 1, "keep_nbest_models": 0, "optim": "adamw",
        "optim_conf": {"lr": 1e-3, "weight_decay": 0.01}, "scheduler": "warmuplr",
        "scheduler_conf": {"warmup_steps": 10}, "async_ckpt": False}


def _config(bidirectional=True, N=1, n_main=4, moe=False):
    """tests/test_pipeline.py's config; ``moe``: the AED's FFNs MoE (4
    experts, top 2, capacity for every token, aux weight AUX_WEIGHT)."""
    cfg = {
        "encoder": "dcasr", "head": "ctc",
        "frontend_conf": {"n_mels": 24, "win_length": 400, "hop_length": 160},
        "encoder_conf": {"d_outer": 24, "d_main": 36, "n_enc": 1,
                         "n_main": n_main, "n_dec": 1, "arch_type": "A",
                         "d_state": 16, "headdim": 12, "ssd_chunk_size": 16,
                         "bidirectional": bidirectional,
                         "hnet": {"compression_N": N}},
        "aed_conf": {"n_layers": 1, "n_heads": 2, "d_ff": 48, "dropout": 0.0},
        "model_conf": {"ctc_weight": 0.3, "aed_weight": 0.7, "lsm_weight": 0.1},
        "train": {"precision": "fp32"},
    }
    if moe:
        cfg["aed_conf"]["moe"] = {"n_experts": 4, "top_k": 2, "capacity_factor": 2.0,
                                  "aux_weight": AUX_WEIGHT}
    return cfg


def _batch(B=4, T_mel=64, lens_mel=(64, 50, 40, 57), seed=0):
    rng = np.random.default_rng(seed)
    n_samples = (T_mel - 1) * 160 + 400
    wave = (rng.normal(size=(B, n_samples)) * 0.1).astype(np.float32)
    wave_lens = np.asarray([(n - 1) * 160 + 400 for n in lens_mel], np.int32)
    for b, wl in enumerate(wave_lens):
        wave[b, wl:] = 0.0
    return {
        "wave": wave, "wave_lens": wave_lens,
        "tokens": rng.integers(4, VOCAB, size=(B, 6)).astype(np.int32),
        "token_lens": np.full(B, 6, np.int32),
        "row_mask": np.ones(B, bool),
        "aug_ref": np.array([0, 0], np.int32),
        "item_index": np.arange(B, dtype=np.int32),
    }


def _err(a, b, lengths=None):
    """tests/test_pipeline.py's error: max|d| / max|b| on the valid frames."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if lengths is not None:
        mask = (np.arange(a.shape[1])[None, :] < np.asarray(lengths)[:, None])[..., None]
        a, b = a * mask, b * mask
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _jax_model(cfg, seed=1):
    """JAX's model and a JAX param tree of the port's seeded draw (JAX's
    eager init of every config would take most of the file's time)."""
    return jtask.build_model(cfg, VOCAB), convert.state_dict_to_jax_tree(
        build_model(cfg, VOCAB, seed=seed, device="cpu").state_dict())


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _owner(results, name):
    """The rank of dp group 0 that holds a leaf: its stage's for a
    main-stack block, rank 0 for a replicated leaf."""
    from hnet_mamba_asr_torch.parallel.pipeline import main_block
    i = main_block(name)
    return results[0] if i is None or i < 2 else results[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the job, JAX's references, the four ranks' results, tmp)."""
    tmp = tmp_path_factory.mktemp("pp")
    rng = np.random.default_rng(0)
    job, refs = {"stack": {}, "encode": {}}, {"stack": {}, "encode": {}}
    x = rng.normal(size=(4, 24, 36)).astype(np.float32)
    lengths = np.asarray([24, 17, 9, 22], np.int32)
    jobs = []
    for bid in (False, True):
        stack = JStack(4, 36, bidirectional=bid, d_state=16, headdim=12, chunk_size=16,
                       remat=False)
        p = stack.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths))["params"]
        job["stack"][bid] = {"tree": jax.tree_util.tree_map(np.asarray, p), "x": x,
                             "lengths": lengths}
        jobs.append(lambda stack=stack, p=p, bid=bid: refs["stack"].update(
            {bid: np.asarray(stack.apply({"params": p}, jnp.asarray(x), jnp.asarray(lengths)))}))
    batch = _batch()
    for N in (1, 4):
        model, tree = _jax_model(_config(True, N=N))
        feats, flens = model.features(batch, train=False)
        job["encode"][N] = {"config": _config(True, N=N), "vocab": VOCAB, "tree": tree,
                            "feats": np.asarray(feats), "flens": np.asarray(flens)}

        def encode(model=model, tree=tree, feats=feats, flens=flens, N=N):
            off = jax.jit(lambda p: model.encoder.apply({"params": p}, feats, flens))(
                tree["encoder"])
            refs["encode"][N] = {"features": np.asarray(off.features),
                                 "lengths": np.asarray(off.lengths),
                                 "ratio": float(off.ratio_loss)}
        jobs.append(encode)
    job["loss"] = dict(job["encode"][4], batch=batch)

    def loss_and_grads(model=model, tree=tree):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: model.loss_fn(p, batch, 0, False)[0]))(tree)
        refs["loss"] = {"loss": float(loss), "grads": jax.tree_util.tree_map(np.asarray, grads)}
    jobs.append(loss_and_grads)
    moe_model, moe_tree = _jax_model(_config(True, moe=True))
    job["moe"] = {"config": _config(True, moe=True), "vocab": VOCAB, "tree": moe_tree,
                  "batch": batch}

    def jax_moe():
        plain, stats = jax.jit(lambda p: moe_model.loss_fn(p, batch, 0, False))(moe_tree)
        pp = jax.jit(lambda p: pp_loss_fn(moe_model, p, batch, 0, False,
                                          jmake_mesh(2, tp=2, tp_axis="pp"))[0])(moe_tree)
        refs["jax_moe"] = {"plain": float(plain), "pp": float(pp),
                           "aux": float(stats["moe/aux"])}
    jobs.append(jax_moe)
    _, step_tree = _jax_model(_config(False))
    job["step"] = {"config": _config(False), "vocab": VOCAB, "tree": step_tree,
                   "batch": batch, "train_cfg": TCFG}
    out = {}
    threads = [threading.Thread(target=lambda: out.update(ranks=run_pair("pp", job, tmp,
                                                                          world=4)))]
    threads += [threading.Thread(target=fn) for fn in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert "ranks" in out and {"stack", "encode", "loss", "jax_moe"} <= set(refs), \
        "a worker failed"
    return job, refs, out["ranks"], tmp


def test_mesh_is_dp_major_with_pp_fastest(ranks):
    """JAX's reshape(n // pp, pp): rank = dp_index * pp + stage."""
    _, _, results, _ = ranks
    assert [r["where"][:2] for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert results[0]["where"][2] == {"dp": 2, "pp": 2}


def test_stage_shift_and_its_adjoint(ranks):
    """Stage 1 receives stage 0's tensor, stage 0 zeros; <S x, y> summed
    over the group equals <x, S^T y> with S^T the shift by -1."""
    _, _, results, _ = ranks
    for lo, hi in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(results[hi]["shift"]["sx"], results[lo]["shift"]["x"])
        assert not results[lo]["shift"]["sx"].any()
    for r in results:
        a, b = r["shift"]["dots"]
        assert abs(a - b) <= 1e-12 * max(1.0, abs(a))


@pytest.mark.parametrize("bidirectional", [False, True])
def test_pp_stack_matches_jax(ranks, bidirectional):
    """pp_stack_apply at pp = 2 == JAX's MambaStack.apply (2e-5); a stage
    holds its two blocks under their global names."""
    _, refs, results, _ = ranks
    for r in results:
        assert _err(r["stack"][bidirectional], refs["stack"][bidirectional]) < 2e-5
    for r, blocks in zip(results, ([0, 1], [2, 3], [0, 1], [2, 3])):
        held = sorted({int(k.split(".")[1]) for k in r["stack_keys"][bidirectional]
                       if k.startswith("blocks.")})
        assert held == blocks


@pytest.mark.parametrize("N", [1, 4])
def test_pp_encode_matches_jax(ranks, N):
    """The whole encoder with its main stack pipelined == JAX's plain
    encoder, dynamic chunking included (N = 4)."""
    _, refs, results, _ = ranks
    ref = refs["encode"][N]
    for r in results:
        got = r["encode"][N]
        np.testing.assert_array_equal(got["lengths"], ref["lengths"])
        assert _err(got["features"], ref["features"], ref["lengths"]) < 2e-4
        assert got["ratio"] == pytest.approx(ref["ratio"], abs=1e-6)


def test_pp_loss_and_grads_match_jax(ranks):
    """The pp loss and every leaf's gradient, the stages' from the rank
    that holds them, against jax.value_and_grad of JAX's loss_fn."""
    _, refs, results, _ = ranks
    ref = refs["loss"]
    for r in results:
        assert abs(r["loss"]["loss"] - ref["loss"]) < 2e-4 * max(1.0, abs(ref["loss"]))
    names = results[0]["loss"]["grads"].keys() | results[1]["loss"]["grads"].keys()
    grads = {n: torch.from_numpy(_owner(results, n)["loss"]["grads"][n]) for n in names}
    got = _leaves(convert.state_dict_to_jax_tree(grads))
    want = _leaves(ref["grads"])
    assert got.keys() == want.keys()
    for k, leaf in want.items():
        err = np.abs(leaf - got[k]).max() / max(np.abs(leaf).max(), 1e-3)
        assert err < 5e-3, f"{k}: {err}"


def test_pp_moe_loss_equals_the_plain_loss(ranks):
    """The port's pp loss is the plain loss, the MoE aux term included (its
    heads are DCASRModel.heads_loss)."""
    _, _, results, _ = ranks
    for r in results:
        assert r["moe_plain"]["aux"] > 0.1
        assert abs(r["moe_pp"]["aux"] - r["moe_plain"]["aux"]) <= 2e-4
        assert abs(r["moe_pp"]["loss"] - r["moe_plain"]["loss"]) <= 2e-4


def test_jax_pp_loss_leaves_out_the_moe_aux(ranks):
    """The reference's gap (recorded, not repaired): JAX's pp_loss_fn builds
    CTC and AED only, so on an MoE AED its loss is the plain loss less
    aed_weight x aux_weight x aux (every token within capacity, so the
    logits agree)."""
    _, refs, _, _ = ranks
    r = refs["jax_moe"]
    gap = r["plain"] - r["pp"]
    assert gap > 1e-2
    assert gap == pytest.approx(0.7 * AUX_WEIGHT * r["aux"], rel=1e-4, abs=1e-5)


def test_pp_trainer_update_matches_one_process(ranks):
    """One update at (dp, pp) = (2, 2), each dp group on its half of the rows,
    DDP over dp: rank 0's gathered checkpoint is one process's update within
    1e-4 per leaf; the replicated leaves are bitwise equal on the four ranks
    and each stage's on its two dp ranks; rank 0 alone writes."""
    _, _, results, tmp = ranks
    got = _leaves(ckpt.load_checkpoint(tmp / "pp_rank0" / "latest.ckpt")["params"])
    want = _leaves(results[0]["solo"])
    assert got.keys() == want.keys()
    for k, leaf in want.items():
        assert np.abs(got[k] - leaf).max() < 1e-4, k
    assert all(r["ddp"] for r in results)
    assert results[0]["files"] == ["epoch0000.ckpt", "latest.ckpt"]
    assert all(r["files"] is None for r in results[1:])
    for k, v in results[0]["local"].items():
        if not k.startswith("encoder.main.blocks."):
            for r in results[1:]:
                np.testing.assert_array_equal(r["local"][k], v, err_msg=k)
    for lo, hi in ((0, 2), (1, 3)):
        assert results[lo]["local"].keys() == results[hi]["local"].keys()
        for k, v in results[lo]["local"].items():
            np.testing.assert_array_equal(results[hi]["local"][k], v, err_msg=k)
        assert results[lo]["history"] == results[hi]["history"]


def test_pp_checkpoint_loads_into_one_process(ranks):
    """The gathered checkpoint is one process's layout: a one-process
    Trainer loads it, and holds its parameters and the stages' moments,
    bit for bit."""
    job, _, results, tmp = ranks
    step = job["step"]
    model = build_model(step["config"], VOCAB, device="cpu")
    tr = Trainer(model, [], dict(TCFG), ckpt_dir=tmp / "one", device="cpu")
    path = tmp / "pp_rank0" / "latest.ckpt"
    tr.load_checkpoint(path)
    want = _leaves(ckpt.load_checkpoint(path)["params"])
    got = _leaves(convert.state_dict_to_jax_tree(model.state_dict()))
    for k, leaf in want.items():
        np.testing.assert_array_equal(got[k], leaf, err_msg=k)
    names = tr._param_names()
    state = tr.opt.state_dict()["state"]
    assert len(state) == len(names)
    for i, st in state.items():
        mine = _owner(results, names[i])["local_opt"][names[i]]
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(st[key].numpy(), mine[key], err_msg=names[i])
    assert tr.global_step == 1


def test_one_process_checkpoint_resumes_under_pp(ranks):
    """One process's checkpoint resumed by a pp Trainer: each rank holds
    its stage of the parameters and of the moments, bit for bit."""
    _, _, results, tmp = ranks
    state = ckpt.load_checkpoint(tmp / "solo" / "latest.ckpt")
    for r in results:
        stage = r["where"][1]
        want = convert.stage_state(state["params"], 2, stage)
        assert r["resumed"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(r["resumed"][k], v.numpy(), err_msg=k)
        assert r["resumed_opt"].keys() == want.keys() & results[0]["solo_opt"].keys()
        for name, moments in r["resumed_opt"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(moments[key],
                                              results[0]["solo_opt"][name][key], err_msg=name)
        assert r["resumed_step"] == 1


def test_pp_guards(ranks):
    """JAX's texts: a mesh without a pp axis, n_main or the rank count that
    pp does not divide, Type B; a pp config without the PPModel."""
    _, _, results, tmp = ranks
    assert "no 'pp' axis" in results[0]["errors"]["no_pp_axis"]
    assert results[0]["errors"]["pp3"] == "4 devices not divisible by tp*ep=3*1"
    with pytest.raises(ValueError) as want:
        stack_block_params({"block_0": {}}, 3, 2)
    with pytest.raises(ValueError) as got:
        stage_range(3, 2, 0)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="n_main=3 not divisible by pp=2"):
        PPModel(build_model(_config(n_main=3), VOCAB, device="cpu"), pp=2)
    type_b = copy.deepcopy(_config())
    type_b["encoder_conf"].update(arch_type="B", n_mid=1, hnet={"compression_N": 4})
    model_b = build_model(type_b, VOCAB, device="cpu")
    with pytest.raises(ValueError, match=r"supports Type A \(v1\)"):
        PPModel(model_b, pp=2)
    with pytest.raises(ValueError, match="Type B has three compressed stacks to pipeline"):
        pp_encode(model_b.encoder, torch.zeros(1, 64, 24), torch.tensor([64]), Stages(None, 0, 2))
    with pytest.raises(ValueError, match="PPModel"):
        Trainer(build_model(_config(), VOCAB, device="cpu"), [], dict(TCFG, pp=2),
                ckpt_dir=tmp / "guard", device="cpu")
    with pytest.raises(ValueError, match="scan_steps"):
        pmesh.validate_planes({"pp": 2, "scan_steps": 2})
    with pytest.raises(NotImplementedError, match="train.pp is not ported"):
        pmesh.validate_planes({"pp": 2, "fsdp": True})


def test_one_process_stages_equal_the_plain_model():
    """Without a group every stage runs in turn in one process (the ranks'
    witness): the loss, every gradient and the greedy ids of the plain
    model, remat full and none, N = 1 and N = 4."""
    batch = _batch()
    tb = {k: torch.as_tensor(v) if k in ("wave", "wave_lens", "tokens", "token_lens",
                                         "row_mask") else v for k, v in batch.items()}
    for N in (1, 4):
        for remat in ("full", "none"):
            cfg = _config(True, N=N)
            cfg["encoder_conf"]["remat_policy"] = remat
            plain = build_model(cfg, VOCAB, device="cpu")
            staged = PPModel(copy.deepcopy(plain), pp=2)
            l0, _ = plain.loss_fn(tb, 0, False)
            l0.backward()
            l1, _ = staged.loss_fn(tb, 0, False)
            l1.backward()
            assert abs(l1.item() - l0.item()) <= 1e-6 * abs(l0.item())
            ref = dict(plain.named_parameters())
            for n, p in staged.model.named_parameters():
                g = ref[n].grad
                assert (p.grad - g).abs().max() <= 1e-5 * g.abs().max().clamp(min=1e-6), n
            assert staged.greedy_decode(tb) == plain.greedy_decode(tb)


# ---- train.scan_steps: tests/test_trainer.py:142-175 on the port ------------------
class _Toy(torch.nn.Module):
    """tests/test_trainer.py's linear regression on the port's contract."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(4, 1))
        self.b = torch.nn.Parameter(torch.zeros(1))

    def loss_fn(self, batch, step, train):
        x, y = torch.as_tensor(batch["x"]), torch.as_tensor(batch["y"])
        err = ((x @ self.w + self.b - y) ** 2).mean(dim=1)
        mask = batch["row_mask"].float()
        loss = (err * mask).sum() / mask.sum().clamp(min=1)
        return loss, {"loss/total": loss, "batch_weight": mask.sum()}


def _toy_batches(n=6, sizes=None, seed=0):
    rng = np.random.default_rng(seed)
    w = np.array([[1.0], [-2.0], [0.5], [3.0]])
    out = []
    for B in sizes or [16] * n:
        x = rng.normal(size=(B, 4)).astype(np.float32)
        out.append({"x": x, "y": (x @ w + 0.1).astype(np.float32),
                    "row_mask": np.ones(B, bool), "ids": []})
    return out


TOY_CFG = {"max_epoch": 1, "grad_clip": 5.0, "accum_grad": 1, "log_interval": 2,
           "valid_interval_epoch": 1, "keep_nbest_models": 2, "optim": "adamw",
           "optim_conf": {"lr": 0.1}, "scheduler": None, "scheduler_conf": {},
           "async_ckpt": False}


def _toy_train(tmp, batches, **cfg):
    from torch_dist import ListLoader
    tr = Trainer(_Toy(), ListLoader(batches), dict(TOY_CFG, **cfg), ckpt_dir=tmp,
                 device="cpu")
    tr.train()
    return tr


def test_scan_steps_matches_sequential(tmp_path):
    """K = 3 over 6 batches: the parameters and the epoch's loss of
    step-by-step training (JAX's bounds), in 2 host reads instead of 6."""
    a = _toy_train(tmp_path / "a", _toy_batches())
    b = _toy_train(tmp_path / "b", _toy_batches(), scan_steps=3)
    assert b.global_step == a.global_step == 6
    np.testing.assert_allclose(b.model.w.detach().numpy(), a.model.w.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    assert b.metric_history[("train", "loss")][0] == pytest.approx(
        a.metric_history[("train", "loss")][0], rel=1e-5)
    assert (a.host_reads, b.host_reads) == (6, 2)
    assert [h["step"] for h in b.history] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(h["grad_norm"]) and h["ms"] >= 0 for h in b.history)


def test_scan_steps_partial_group_flushes(tmp_path):
    """5 batches at K = 2: 2 groups and a single update at the epoch's end
    (3 reads); batches of other shapes group all the same (eager updates
    have no trace); ``max_steps`` commits the group it cuts."""
    tr = _toy_train(tmp_path / "a", _toy_batches(5), scan_steps=2)
    assert (tr.global_step, tr.host_reads) == (5, 3)
    tr = _toy_train(tmp_path / "b", _toy_batches(sizes=[16, 16, 8, 16, 16]), scan_steps=2)
    assert (tr.global_step, tr.host_reads) == (5, 3)
    assert [h["group"] for h in tr.history] == [2, 2, 2, 2, 1]
    tr = _toy_train(tmp_path / "c", _toy_batches(6), scan_steps=2, max_steps=3)
    assert (tr.global_step, tr.host_reads) == (3, 2)
    assert [h["group"] for h in tr.history] == [2, 2, 1]


class _Logged(_Toy):
    """The toy with a log of its micro-steps, shared with its loader's."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def loss_fn(self, batch, step, train):
        self.log.append("step")
        return super().loss_fn(batch, step, train)


class _LoggedLoader:
    def __init__(self, batches, log):
        self.batches, self.log = batches, log

    def __iter__(self):
        for b in self.batches:
            self.log.append("fetch")
            yield dict(b)


@pytest.mark.parametrize("cfg, reads", [({"accum_grad": 2}, 2), ({"scan_steps": 2}, 2)])
def test_micro_steps_run_as_batches_arrive(tmp_path, cfg, reads):
    """Each micro-step runs before the loader is asked for the next batch,
    in an accumulation and in a group of updates, so the loader's wait
    overlaps the device's work."""
    log = []
    tr = Trainer(_Logged(log), _LoggedLoader(_toy_batches(4), log), dict(TOY_CFG, **cfg),
                 ckpt_dir=tmp_path, device="cpu")
    tr.train()
    assert log == ["fetch", "step"] * 4
    assert tr.host_reads == reads


def test_scan_steps_excludes_accum(tmp_path):
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(_Toy(), [], dict(TOY_CFG, scan_steps=2, accum_grad=2), ckpt_dir=tmp_path,
                device="cpu")
