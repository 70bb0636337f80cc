"""Gloo ranks on the CPU for the multi-rank parity tests
(tests/test_torch_dist.py, test_torch_fsdp.py, test_torch_seq_parallel.py,
test_torch_tp.py, test_torch_ep.py, test_torch_pp.py).

``run_pair(suite, job, tmp, world=2)`` pickles ``job`` (numpy only: JAX-layout param
trees, host batches, configs), starts ``world`` processes of this file with a
torchrun environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``; one thread each) and returns each rank's result
dict. A rank runs ``SUITES[suite](job, rank, tmp)``, which may compute its
one-process references first and then joins the group through the port's
``parallel/mesh.py::init_distributed``. The ranks import torch and the port,
never JAX, so a file spawns its group once and runs all of its cases there.
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def run_pair(suite: str, job: dict, tmp: Path, timeout: float = 300.0,
             world: int = 2) -> list[dict]:
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "job.pkl").write_bytes(pickle.dumps(job))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
        procs.append(subprocess.Popen([sys.executable, __file__, suite, str(tmp)], env=env,
                                      stdout=open(tmp / f"rank{r}.log", "w"),
                                      stderr=subprocess.STDOUT))
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            codes.append("timeout")
    if any(codes):
        logs = "\n".join(f"--- rank {r} ---\n" + (tmp / f"rank{r}.log").read_text()[-3000:]
                         for r in range(world))
        raise AssertionError(f"ranks exited {codes}\n{logs}")
    return [pickle.loads((tmp / f"out{r}.pkl").read_bytes()) for r in range(world)]


# ── the ranks' side ─────────────────────────────────────────────────────────
class ListLoader:
    """Host batches from a list, the trainer's loader contract."""

    def __init__(self, batches):
        self.batches = list(batches)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter([dict(b) for b in self.batches])

    def __len__(self):
        return len(self.batches)


def _model(config, vocab, tree):
    from hnet_mamba_asr_torch import convert
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    model = build_model(config, vocab, device="cpu")
    if tree is not None:
        convert.load_jax_params(model, tree)
    return model


def _tree(model):
    from hnet_mamba_asr_torch.convert import state_dict_to_jax_tree
    from hnet_mamba_asr_torch.parallel.mesh import full_state
    return state_dict_to_jax_tree(full_state(model.state_dict(), keep=True))


def _train(case, batches, ckpt_dir, model=None):
    from hnet_mamba_asr_torch.training.trainer import Trainer
    model = model if model is not None else _model(case["config"], case["vocab"], case["tree"])
    tr = Trainer(model, ListLoader(batches), case["train_cfg"], ckpt_dir=ckpt_dir,
                 seed=0, device="cpu")
    tr.train()
    return tr


def _rows(batches, rank, count):
    from hnet_mamba_asr_torch.parallel.mesh import rank_rows
    return [rank_rows(b, rank, count) for b in batches]


def _listing(path: Path):
    return sorted(os.listdir(path)) if path.exists() else None


def suite_dist(job, rank, tmp):
    """DDP updates against one process, rank 1 writing nothing, and decoding
    over the ranks against one process."""
    from hnet_mamba_asr_torch.parallel.mesh import init_distributed
    from hnet_mamba_asr_torch.tasks.decode_task import decode_split
    from hnet_mamba_asr_torch.tools.gate import seeded_tokenizer
    from hnet_mamba_asr_torch.data.dataset import ItemLoader
    out = {"solo": {}, "ddp": {}, "decode_solo": {}, "decode": {}}
    tok = seeded_tokenizer(tmp / f"tok{rank}.json", job["decode"]["vocab"])
    dec = job["decode"]
    model = _model(dec["config"], dec["vocab"], None)

    def decode(cell, ranks, where):
        loader = ItemLoader(dec["items"], dec["max_frames"], pad_id=tok.pad_id,
                            shuffle=False, batch_multiple=ranks[1])
        decode_split(model, tok, loader, cell, dec["cfg"], audio_seconds={},
                     out_path=where, ranks=ranks)
        return where.read_text() if where.exists() else None

    if rank == 0:                               # one-process references first
        for name, case in job["ddp"].items():
            if case.get("solo"):
                tr = _train(case, case["batches"], tmp / f"solo_{name}")
                out["solo"][name] = _tree(tr.model)
        for cell in dec["cells"]:
            out["decode_solo"][cell["name"]] = decode(cell, (0, 1), tmp / f"solo_{cell['name']}")
    init_distributed("cpu", timeout_s=120)
    for name, case in job["ddp"].items():
        ckpt_dir = tmp / f"ddp_{name}_rank{rank}"
        tr = _train(case, _rows(case["batches"], rank, 2), ckpt_dir)
        out["ddp"][name] = {"tree": _tree(tr.model), "files": _listing(ckpt_dir),
                            "loss": [h["loss/total"] for h in tr.history],
                            "grad_norm": [h["grad_norm"] for h in tr.history],
                            "ddp": tr._ddp is not None}
    for cell in dec["cells"]:
        out["decode"][cell["name"]] = decode(cell, (rank, 2),
                                             tmp / f"ranks{rank}_{cell['name']}")
    return out


def suite_fsdp(job, rank, tmp):
    """FSDP against DDP on the same batches, the moments' shards, a gathered
    checkpoint and its resume."""
    import torch

    from hnet_mamba_asr_torch.parallel.mesh import init_distributed, is_dtensor
    init_distributed("cpu", timeout_s=120)
    case = job["case"]
    batches = _rows(case["batches"], rank, 2)
    out = {}
    ddp = _train(case, batches, tmp / f"ddp_rank{rank}")
    out["ddp"] = _tree(ddp.model)
    fs_case = dict(case, train_cfg=dict(case["train_cfg"], fsdp=True,
                                        fsdp_min_elems=job["min_elems"]))
    ckpt_dir = tmp / ("fsdp_ckpt" if rank == 0 else "fsdp_ckpt_rank1")
    fs = _train(fs_case, batches, ckpt_dir)
    out["fsdp"] = _tree(fs.model)
    out["files"] = _listing(ckpt_dir)
    params = dict(fs.model.named_parameters())
    out["sharded"] = sorted(n for n, p in params.items() if is_dtensor(p))
    out["plan"] = fs.fsdp_plan

    def local_bytes(t):
        t = t.to_local() if is_dtensor(t) else t
        return t.numel() * t.element_size()

    moments = [t for st in fs.opt.state.values() for k, t in st.items()
               if torch.is_tensor(t) and k != "step"]
    out["moments_sharded"] = sum(is_dtensor(t) for t in moments)
    out["moments"] = len(moments)
    out["bytes"] = {
        "fsdp": sum(local_bytes(p) for p in params.values()) + sum(map(local_bytes, moments)),
        "ddp": sum(local_bytes(p) for p in ddp.model.parameters())
        + sum(local_bytes(t) for st in ddp.opt.state.values() for k, t in st.items()
              if torch.is_tensor(t) and k != "step")}
    before = _tree(fs.model)
    # resume from the gathered checkpoint: the same weights, bit for bit
    again = _model(case["config"], case["vocab"], None)
    torch.distributed.barrier()                 # rank 0's file is written
    tr = _resume(fs_case, again, tmp / "fsdp_ckpt")
    out["resumed"] = _tree(tr.model)
    out["before"] = before
    out["resumed_step"] = tr.global_step
    return out


def _resume(case, model, ckpt_dir):
    from hnet_mamba_asr_torch.training.trainer import Trainer
    tr = Trainer(model, ListLoader([]), case["train_cfg"], ckpt_dir=ckpt_dir, seed=0,
                 device="cpu")
    tr.load_checkpoint(ckpt_dir / "latest.ckpt")
    return tr


def suite_sp(job, rank, tmp):
    """sp_encode per config, the sp loss and gradients against the offline
    loss, and fsdp composed with sp training."""
    import torch
    import torch.distributed as dist

    from hnet_mamba_asr_torch.parallel.mesh import init_distributed, make_mesh
    from hnet_mamba_asr_torch.parallel.collectives import all_gather
    from hnet_mamba_asr_torch.parallel.seq_parallel import SPModel, Shards, sp_encode
    init_distributed("cpu", timeout_s=120)
    sh = Shards(dist.group.WORLD, rank, 2)
    out = {"encode": {}, "loss": {}}
    for name, case in job["encode"].items():
        model = _model(case["config"], case["vocab"], case["tree"])
        feats = torch.from_numpy(case["feats"])
        flens = torch.from_numpy(case["flens"])
        with torch.no_grad():
            enc = sp_encode(model.encoder, feats, flens, sh)
            p, b = (all_gather(t, sh.group).permute(1, 0, 2).reshape(t.shape[0], -1)
                    for t in enc.boundaries[0])
        out["encode"][name] = {"features": enc.features.numpy(), "ratio": float(enc.ratio_loss),
                               "kept": [float(k) for k in enc.kept_fractions],
                               "p": p.numpy(), "b": b.numpy()}
    for name, case in job["loss"].items():
        model = _model(case["config"], case["vocab"], case["tree"])
        batch = {k: torch.as_tensor(v) for k, v in case["batch"].items() if k != "ids"}
        sp = SPModel(model, make_mesh(2, "cpu"))
        loss, stats = sp.loss_fn(batch, 0, False)
        loss.backward()
        grads = {}
        for n, prm in model.named_parameters():
            g = prm.grad.clone() if prm.grad is not None else torch.zeros_like(prm)
            dist.all_reduce(g)
            grads[n] = (g / 2).numpy()                   # the average DDP takes
        model.zero_grad(set_to_none=True)
        ref, ref_stats = model.loss_fn(batch, 0, False)  # offline, no collective
        ref.backward()
        out["loss"][name] = {
            "loss": float(loss), "ref": float(ref),
            "kept": float(stats["kept_fraction"]), "ref_kept": float(ref_stats["kept_fraction"]),
            "ratio": float(stats["loss/ratio"]), "ref_ratio": float(ref_stats["loss/ratio"]),
            "grads": grads,
            "ref_grads": {n: prm.grad.numpy() for n, prm in model.named_parameters()
                          if prm.grad is not None}}
    case = job["fsdp_sp"]
    model = _model(case["config"], case["vocab"], case["tree"])
    from hnet_mamba_asr_torch.training.trainer import Trainer
    tr = Trainer(SPModel(model, make_mesh(2, "cpu")), ListLoader(case["batches"]),
                 case["train_cfg"], ckpt_dir=tmp / f"fsdp_sp{rank}", seed=0, device="cpu")
    tr.train()
    out["fsdp_sp"] = {"loss": [h["loss/total"] for h in tr.history], "tree": _tree(tr.model),
                      "fsdp": tr.fsdp}
    return out


def _local(model):
    return {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}


def _mp_trainer(case, batches, ckpt_dir, mesh, planes):
    """A tp / ep Trainer on ``mesh`` (the config's train.tp / train.ep set)."""
    from hnet_mamba_asr_torch.training.trainer import Trainer
    model = _model(case["config"], case["vocab"], case["tree"])
    return Trainer(model, ListLoader(batches), dict(case["train_cfg"], **planes),
                   ckpt_dir=ckpt_dir, seed=0, device="cpu", mesh=mesh)


def _mp_train(case, batches, ckpt_dir, mesh, planes):
    tr = _mp_trainer(case, batches, ckpt_dir, mesh, planes)
    tr.train()
    return tr


def _ckpt_tree(path):
    from hnet_mamba_asr_torch.training import checkpoint as ckpt
    return ckpt.load_checkpoint(path)["params"]


def suite_tp(job, rank, tmp):
    """tp = 2: updates against one process and the virtual-plane witness,
    the gathered checkpoint and its re-sharded resume, the N=2 encoder's
    boundaries and features, and decode.tp over the cells."""
    import torch

    from hnet_mamba_asr_torch.parallel.mesh import init_distributed, make_mesh
    from hnet_mamba_asr_torch.parallel.model_parallel import Plane, place_model, plane_of
    from hnet_mamba_asr_torch.tasks.decode_task import decode_batch
    out = {"solo": {}, "witness": {}, "tp": {}, "local": {}, "encode": {}, "decode": {}}
    if rank == 0:                               # one-process references first
        for name, case in job["update"].items():
            out["solo"][name] = _tree(_train(case, case["batches"], tmp / f"solo_{name}").model)
            witness = _model(case["config"], case["vocab"], case["tree"])
            place_model(witness, Plane("tp", 2))        # every shard in one process
            out["witness"][name] = _tree(_train(case, case["batches"], tmp / f"wit_{name}",
                                                model=witness).model)
        enc = job["encode"]
        model = _model(enc["config"], enc["vocab"], enc["tree"])
        with torch.no_grad():
            e = model.encoder(torch.from_numpy(enc["feats"]), torch.from_numpy(enc["flens"]))
        out["encode_solo"] = {"features": e.features.numpy(), "p": e.boundaries[0][0].numpy(),
                              "b": e.boundaries[0][1].numpy()}
    init_distributed("cpu", timeout_s=120)
    mesh = make_mesh(device="cpu", tp=2)
    for name, case in job["update"].items():
        ckpt_dir = tmp / f"tp_{name}_rank{rank}"
        tr = _mp_train(case, case["batches"], ckpt_dir, mesh, {"tp": 2})
        out["local"][name] = _local(tr.model)
        out["files"] = _listing(ckpt_dir)
        if rank == 0:
            out["tp"][name] = _ckpt_tree(ckpt_dir / "latest.ckpt")
        torch.distributed.barrier()
        again = _mp_trainer(dict(case, tree=None), [], tmp / f"again_{name}_rank{rank}", mesh,
                            {"tp": 2})
        again.load_checkpoint(tmp / f"tp_{name}_rank0" / "latest.ckpt")
        out.setdefault("resumed", {})[name] = _local(again.model)
        out.setdefault("mesh", tr.mesh_shape)
    enc = job["encode"]
    model = _model(enc["config"], enc["vocab"], enc["tree"])
    place_model(model, plane_of(mesh, "tp", 2))
    with torch.no_grad():
        e = model.encoder(torch.from_numpy(enc["feats"]), torch.from_numpy(enc["flens"]))
    out["encode"] = {"features": e.features.numpy(), "p": e.boundaries[0][0].numpy(),
                     "b": e.boundaries[0][1].numpy()}
    dec = job["decode"]
    model = _model(dec["config"], dec["vocab"], dec["tree"]).eval()
    place_model(model, plane_of(mesh, "tp", 2))

    class Tok:
        bos_id, eos_id, pad_id = 1, 2, 3

        def decode(self, ids):
            return " ".join(str(int(i)) for i in ids)

    for cell in dec["cells"]:
        for engine, dc in dec["engines"].items():
            recs = decode_batch(model, Tok(), dict(dec["batch"]), cell, dc)
            out["decode"][(cell["name"], engine)] = [(r["hyp"], r["score"]) for r in recs]
    return out


def suite_ep(job, rank, tmp):
    """World 4: the MoE FFN over ep = 2 (rows whole) and (dp, ep) = (2, 2)
    (rows split), the (dp, tp, ep) = (1, 2, 2) and (2, 1, 2) updates, and
    the LM trainer's train.ep through scripts/train_lm.py."""
    import torch
    import torch.distributed as dist

    from hnet_mamba_asr_torch import convert
    from hnet_mamba_asr_torch.models.moe import MoEFFN, moe_aux
    from hnet_mamba_asr_torch.parallel.collectives import rows_split_over
    from hnet_mamba_asr_torch.parallel.mesh import (init_distributed, make_mesh, mesh_axis,
                                                    rank_rows)
    from hnet_mamba_asr_torch.parallel.model_parallel import place_model, plane_of
    from hnet_mamba_asr_torch.scripts import train_lm
    out = {"moe": {}, "update": {}, "local": {}}
    lm_args = ["--config", str(job["lm_yaml"]), "--device", "cpu"]
    if rank == 0:                 # the CLI alone: no launch in its environment
        from hnet_mamba_asr_torch.parallel.mesh import ENV_KEYS
        launch = {k: os.environ.pop(k) for k in ENV_KEYS}
        try:
            solo = train_lm.run(train_lm.parse_args(lm_args + ["--exp-dir",
                                                               str(tmp / "lm_solo")]))
        finally:
            os.environ.update(launch)
        out["lm_solo"] = _tree(solo.model)
    init_distributed("cpu", timeout_s=120)
    mesh = make_mesh(device="cpu", ep=2)
    dp_group, dp_rank, _ = mesh_axis(mesh, "dp")
    f = job["moe"]
    for name, split in (("ep2", False), ("dp2ep2", True)):
        m = MoEFFN(f["D"], f["F"], f["E"], top_k=2, capacity_factor=2.0)
        m.load_state_dict(convert.jax_to_state_dict(f["tree"]))
        place_model(m, ep=plane_of(mesh, "ep", 2))
        x = torch.from_numpy(f["x"])
        with rows_split_over(dp_group if split else None):
            xs = rank_rows({"x": x}, dp_rank, 2)["x"] if split else x
            y, aux, dropped = m(xs)
            loss = (y ** 2).sum()
            if split:
                from hnet_mamba_asr_torch.parallel.collectives import batch_sum
                loss = batch_sum(loss)
            loss = loss + moe_aux([(aux, dropped)], 0.01)[0]
            loss.backward()
        grads = {}
        for n, p in m.named_parameters():
            g = p.grad.clone()
            if split:                               # DDP's mean over the dp group
                dist.all_reduce(g, group=dp_group)
                g /= 2
            if n != "router":
                parts = [torch.empty_like(g) for _ in range(2)]
                dist.all_gather(parts, g, group=mesh.get_group("ep"))
                g = torch.cat(parts)
            grads[n] = g.numpy()
        out["moe"][name] = {"loss": float(loss), "grads": grads, "dropped": float(dropped)}
    meshes = {"tp2ep2": make_mesh(device="cpu", tp=2, ep=2), "dp2ep2": mesh}
    case = job["update"]
    for name, planes in (("tp2ep2", {"tp": 2, "ep": 2}), ("dp2ep2", {"ep": 2})):
        m3 = meshes[name]
        _, r, n = mesh_axis(m3, "dp")
        ckpt_dir = tmp / f"{name}_rank{rank}"
        tr = _mp_train(case, _rows(case["batches"], r, n), ckpt_dir, m3, planes)
        out["local"][name] = _local(tr.model)
        if rank == 0:
            out["update"][name] = _ckpt_tree(ckpt_dir / "latest.ckpt")
        out.setdefault("mesh", {})[name] = tr.mesh_shape
    tr = train_lm.run(train_lm.parse_args(lm_args + ["--exp-dir", str(tmp / f"lm_ep{rank}"),
                                                     "--dist-backend", "gloo", "train.ep=2"]))
    if rank == 0:
        out["lm_ep"] = _ckpt_tree(tmp / "lm_ep0" / "checkpoints" / "latest.ckpt")
    out["lm_mesh"] = tr.mesh_shape
    return out


def _by_name(tr) -> dict:
    """A trainer's optimizer state keyed by parameter name, as numpy."""
    import torch
    names = tr._param_names()
    return {names[int(i)]: {k: t.numpy() for k, t in st.items() if torch.is_tensor(t)}
            for i, st in tr.opt.state_dict()["state"].items()}


def suite_pp(job, rank, tmp):
    """World 4, a (dp, pp) = (2, 2) mesh: the shift's adjoint; the stack, the
    encoder, the loss and its gradients and the MoE-AED loss under pp = 2
    (every row on both dp groups); one Trainer update with the rows split
    over dp, its gathered checkpoint, and one process's checkpoint resumed
    under pp; the guards that need a process group."""
    import torch
    import torch.distributed as dist

    from hnet_mamba_asr_torch import convert
    from hnet_mamba_asr_torch.models.mamba_block import MambaStack
    from hnet_mamba_asr_torch.parallel.collectives import stage_shift
    from hnet_mamba_asr_torch.parallel.mesh import init_distributed, make_mesh, mesh_axis
    from hnet_mamba_asr_torch.parallel.pipeline import (PPModel, Stages, keep_stage, pp_encode,
                                                        pp_stack_apply)
    from hnet_mamba_asr_torch.training.trainer import Trainer
    out = {"stack": {}, "stack_keys": {}, "encode": {}, "errors": {}}

    def tensors(batch):
        return {k: torch.as_tensor(v) if k in ("wave", "wave_lens", "tokens", "token_lens",
                                               "row_mask") else v for k, v in batch.items()}

    step = job["step"]
    if rank == 0:                                # one process's update and checkpoint
        tr = _train(step, [step["batch"]], tmp / "solo")
        out["solo"] = _tree(tr.model)
        out["solo_opt"] = _by_name(tr)
    moe = job["moe"]
    plain = _model(moe["config"], moe["vocab"], moe["tree"])
    loss, stats = plain.loss_fn(tensors(moe["batch"]), 0, False)
    out["moe_plain"] = {"loss": float(loss), "aux": float(stats["moe/aux"])}
    init_distributed("cpu", timeout_s=120)
    mesh = make_mesh(device="cpu", pp=2)
    pp_group, stage, _ = mesh_axis(mesh, "pp")
    _, dp_rank, dp = mesh_axis(mesh, "dp")
    out["where"] = (dp_rank, stage, dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))
    st = Stages(pp_group, stage, 2)
    # the shift and its adjoint: <S x, y> = <x, S^T y> summed over the group
    gen = torch.Generator().manual_seed(rank)
    x, y = torch.randn(6, generator=gen), torch.randn(6, generator=gen)
    sx = stage_shift(x, pp_group, 1)
    dots = torch.stack([(sx * y).sum(), (x * stage_shift(y, pp_group, -1)).sum()]).double()
    dist.all_reduce(dots, group=pp_group)
    out["shift"] = {"x": x.numpy(), "sx": sx.numpy(), "dots": dots.tolist()}
    for bid, case in job["stack"].items():
        stack = MambaStack(4, 36, bidirectional=bid, d_state=16, headdim=12, chunk_size=16,
                           remat_policy="none")
        stack.load_state_dict(convert.jax_to_state_dict(case["tree"]))
        keep_stage(stack, 2, stage)
        out["stack_keys"][bid] = sorted(stack.state_dict())
        with torch.no_grad():
            out["stack"][bid] = pp_stack_apply(stack, torch.from_numpy(case["x"]),
                                               torch.from_numpy(case["lengths"]), st).numpy()
    for n, case in job["encode"].items():
        pm = PPModel(_model(case["config"], case["vocab"], case["tree"]), mesh)
        with torch.no_grad():
            enc = pp_encode(pm.encoder, torch.from_numpy(case["feats"]),
                            torch.from_numpy(case["flens"]), pm.stages)
        out["encode"][n] = {"features": enc.features.numpy(), "lengths": enc.lengths.numpy(),
                            "ratio": float(enc.ratio_loss)}
    case = job["loss"]
    pm = PPModel(_model(case["config"], case["vocab"], case["tree"]), mesh)
    loss, _ = pm.loss_fn(tensors(case["batch"]), 0, False)
    loss.backward()
    out["loss"] = {"loss": float(loss), "grads": {n: p.grad.numpy() for n, p in
                                                  pm.model.named_parameters()}}
    pm = PPModel(_model(moe["config"], moe["vocab"], moe["tree"]), mesh)
    loss, stats = pm.loss_fn(tensors(moe["batch"]), 0, False)
    out["moe_pp"] = {"loss": float(loss), "aux": float(stats["moe/aux"])}
    # one update at (dp, pp) = (2, 2), each dp group on its rows
    ckpt_dir = tmp / f"pp_rank{rank}"
    tr = Trainer(PPModel(_model(step["config"], step["vocab"], step["tree"]), mesh),
                 ListLoader(_rows([step["batch"]], dp_rank, dp)),
                 dict(step["train_cfg"], pp=2), ckpt_dir=ckpt_dir, seed=0, device="cpu")
    tr.train()
    out["local"], out["local_opt"] = _local(tr.model), _by_name(tr)
    out["files"] = _listing(ckpt_dir)
    out["ddp"] = tr._ddp is not None
    out["history"] = [h["loss/total"] for h in tr.history]
    # one process's checkpoint resumed under pp: this rank's stage of it
    again = Trainer(PPModel(_model(step["config"], step["vocab"], None), mesh), ListLoader([]),
                    dict(step["train_cfg"], pp=2), ckpt_dir=tmp / f"again{rank}", seed=0,
                    device="cpu")
    again.load_checkpoint(tmp / "solo" / "latest.ckpt")
    out["resumed"], out["resumed_opt"] = _local(again.model), _by_name(again)
    out["resumed_step"] = again.global_step
    for name, fn in (("no_pp_axis", lambda: PPModel(_model(step["config"], step["vocab"], None),
                                                    make_mesh(device="cpu"))),
                     ("pp3", lambda: make_mesh(device="cpu", pp=3))):
        try:
            fn()
            out["errors"][name] = None
        except ValueError as e:
            out["errors"][name] = str(e)
    return out


SUITES = {"dist": suite_dist, "fsdp": suite_fsdp, "sp": suite_sp, "tp": suite_tp,
          "ep": suite_ep, "pp": suite_pp}


def main(suite: str, tmp: str) -> None:
    import torch
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tmp)
    rank = int(os.environ["RANK"])
    job = pickle.loads((tmp / "job.pkl").read_bytes())
    out = SUITES[suite](job, rank, tmp)
    (tmp / f"out{rank}.pkl").write_bytes(pickle.dumps(out))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
