"""Two gloo ranks on the CPU for the multi-rank parity tests
(tests/test_torch_dist.py, test_torch_fsdp.py, test_torch_seq_parallel.py).

``run_pair(suite, job, tmp)`` pickles ``job`` (numpy only: JAX-layout param
trees, host batches, configs), starts two processes of this file with a
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


def run_pair(suite: str, job: dict, tmp: Path, timeout: float = 300.0) -> list[dict]:
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "job.pkl").write_bytes(pickle.dumps(job))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(r), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1",
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
                         for r in range(2))
        raise AssertionError(f"ranks exited {codes}\n{logs}")
    return [pickle.loads((tmp / f"out{r}.pkl").read_bytes()) for r in range(2)]


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


SUITES = {"dist": suite_dist, "fsdp": suite_fsdp, "sp": suite_sp}


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
