"""Two real processes through the port's entry points: a torchrun-style
launch (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK`` per child) of the train CLI (fresh, then ``--resume auto``)
and the decode CLI, on the synthetic tone corpus at d 32.

    python -m hnet_mamba_asr_torch.tools.smoke_2proc [--device cuda|cpu]
        [--backend gloo|nccl] [--fsdp | --sp | --pp | --tp | --ep] [--root DIR]
        [--timeout S]

Counterpart of the JAX package's ``scripts/smoke_2proc.py``. After both
children exit 0 the parent checks, from their files:

- per epoch, the two ranks consumed equal counts of batches whose row
  slices are disjoint and together the corpus (with ``--sp``, ``--pp``,
  ``--tp`` or ``--ep`` both ranks of the model group consume the same rows:
  the check is that they are equal);
- the parameters are bitwise equal across the ranks after training and
  after the resume (a sha256 of the full state, gathered under FSDP, pp, tp
  and ep);
- ``summary.json`` holds one provenance record per run, written by rank 0,
  with ``process_count`` 2, and ``metrics.jsonl`` a resume marker;
- the decode over both ranks (``decode.n_devices=2``, or ``decode.tp=2``
  with ``--tp``; written by rank 0) equals each rank's own whole-split
  decode, transcript for transcript.

``--tp`` and ``--ep`` train with ``train.tp=2`` / ``train.ep=2`` a config
with an AED head (with ``--ep`` an MoE AED of 4 experts); ``--pp`` with
``train.pp=2`` the config with 2 main-stack blocks, one a stage.

Exit 0 when every check passes. Two ranks on one card run gloo
(``--backend gloo``, the default): NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

N_PROC = 2
PLANES = {None: [], "fsdp": ["train.fsdp=true", "train.fsdp_min_elems=512"],
          "sp": ["train.sp=2"], "pp": ["train.pp=2"], "tp": ["train.tp=2"],
          "ep": ["train.ep=2"]}
SAME_ROWS = ("sp", "pp", "tp", "ep")         # the planes whose ranks hold the same rows


def _digest(trainer) -> str:
    import hashlib

    from hnet_mamba_asr_torch.parallel.mesh import full_state
    state = full_state(trainer.model.state_dict(), keep=True)
    if trainer.mp_plan:                          # tp / ep: the gathered whole
        state = trainer._gathered(state, trainer.opt.state_dict())[0]
    if trainer.pp_ranks:                         # pp: every stage's blocks
        state = trainer._stages_gathered(state, trainer.opt.state_dict())[0]
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].float().numpy().tobytes())
    return h.hexdigest()


def child_main(rank: int, root: Path, device: str, backend: str, plane: str | None):
    from hnet_mamba_asr_torch.scripts import decode, train
    cfg, exp = str(root / "cfg.json"), str(root / "exp")
    common = ["--device", device, "--dist-backend", backend]
    planes = PLANES[plane]
    trainer = train.run(train.parse_args(["--config", cfg, "--exp-dir", exp, *common, *planes]))
    if trainer.world != N_PROC:
        raise AssertionError(f"rank {rank}: world {trainer.world} != {N_PROC}")
    fresh = _digest(trainer)
    trainer = train.run(train.parse_args(["--config", cfg, "--exp-dir", exp, "--resume",
                                          "auto", *common, "train.max_epoch=3", *planes]))
    resumed = _digest(trainer)
    (root / f"digest_rank{rank}.json").write_text(json.dumps({"fresh": fresh,
                                                              "resumed": resumed}))
    ckpt = f"{exp}/checkpoints/latest.ckpt"
    decode.run(decode.parse_args(["--config", cfg, "--checkpoint", ckpt, "--splits",
                                  "dev-clean", "--out-dir", str(root / "decode_ranks"),
                                  *common, "decode.tp=2" if plane == "tp" else
                                  "decode.n_devices=2"]))
    decode.run(decode.parse_args(["--config", cfg, "--checkpoint", ckpt, "--splits",
                                  "dev-clean", "--out-dir", str(root / f"decode_rank{rank}"),
                                  *common]))
    print(f"[child {rank}] all stages OK", flush=True)


def prep(root: Path, plane: str | None = None) -> None:
    """The tone corpus, its tokenizer, CMVN (on the CPU) and a d-32 config
    (with an AED head for tp and ep, of MoE experts for ep, 2 main-stack
    blocks for pp)."""
    from hnet_mamba_asr_torch.data.audio import load_manifest
    from hnet_mamba_asr_torch.data.features import compute_cmvn
    from hnet_mamba_asr_torch.data.synthetic import build_tone_corpus, overfit_config
    from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
    build_tone_corpus(root)
    train = root / "manifests" / "train-960.jsonl"
    Tokenizer.train([e["text"] for e in load_manifest(train)], root / "tok" / "bpe",
                    vocab_size=12, hard_vocab_limit=False)
    compute_cmvn(train, n_mels=20, device="cpu", out=root / "cmvn.npz")
    cfg = overfit_config(root, max_epoch=2, valid_interval=1, batch_bins=2000,
                         **({"ctc_weight": 0.7, "aed_weight": 0.3} if plane in ("tp", "ep")
                            else {}))
    cfg["experiment"]["name"] = "smoke_2proc"
    if plane == "pp":
        cfg["encoder_conf"]["n_main"] = 2
    if plane in ("tp", "ep"):
        cfg["aed_conf"] = {"n_layers": 1, "n_heads": 2, "d_ff": 64, "dropout": 0.1,
                           "max_decode_len": 8}
        if plane == "ep":
            cfg["aed_conf"]["moe"] = {"n_experts": 4, "top_k": 2, "capacity_factor": 1.25,
                                      "aux_weight": 0.01}
    (root / "cfg.json").write_text(json.dumps(cfg, indent=1))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(root: Path, device: str, backend: str, plane: str | None,
           timeout: float) -> list[int]:
    """Start the two children, wait for both (killing them past ``timeout``)."""
    port = _free_port()
    children = []
    for r in range(N_PROC):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(N_PROC), RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(N_PROC),
                   HMASR_CONSUMED_IDS=str(root / f"consumed_rank{r}.jsonl"),
                   HMASR_LOG_DIR=str(root / "logs"))
        args = [sys.executable, "-m", "hnet_mamba_asr_torch.tools.smoke_2proc", "--child",
                "--rank", str(r), "--root", str(root), "--device", device,
                "--backend", backend] + ([f"--{plane}"] if plane else [])
        children.append(subprocess.Popen(args, env=env, stdout=open(root / f"child{r}.log", "w"),
                                         stderr=subprocess.STDOUT))
    codes = []
    for c in children:
        try:
            codes.append(c.wait(timeout))
        except subprocess.TimeoutExpired:
            for k in children:
                k.kill()
            codes.append(-9)
    return codes


def check(root: Path, same_rows: bool) -> dict:
    """The parent's checks over the children's files -> counts."""
    by_epoch: dict = {}
    for r in range(N_PROC):
        for line in (root / f"consumed_rank{r}.jsonl").read_text().splitlines():
            rec = json.loads(line)
            by_epoch.setdefault(rec["epoch"], [[] for _ in range(N_PROC)])[r].append(rec["ids"])
    corpus = {json.loads(line)["id"] for line in
              (root / "manifests" / "train-960.jsonl").read_text().splitlines()}
    if not by_epoch:
        raise AssertionError("no consumed-ids records written")
    for epoch, per_rank in sorted(by_epoch.items()):
        counts = [len(x) for x in per_rank]
        if len(set(counts)) != 1:
            raise AssertionError(f"epoch {epoch}: unequal batch counts per rank {counts}")
        ids = [set(i for b in x for i in b) for x in per_rank]
        if same_rows:
            if per_rank[0] != per_rank[1]:
                raise AssertionError(f"epoch {epoch}: the model group's ranks consumed "
                                     "different rows")
        elif ids[0] & ids[1]:
            raise AssertionError(f"epoch {epoch}: ranks consumed overlapping utterances "
                                 f"{sorted(ids[0] & ids[1])[:5]}")
        if set().union(*ids) != corpus:
            raise AssertionError(f"epoch {epoch}: the consumed ids are not the corpus")
    digests = [json.loads((root / f"digest_rank{r}.json").read_text()) for r in range(N_PROC)]
    if digests[0] != digests[1]:
        raise AssertionError(f"parameters differ across the ranks: {digests}")
    prov = json.loads((root / "exp" / "summary.json").read_text())["provenance"]
    if len(prov) != 2 or any(p["env"]["process_count"] != N_PROC for p in prov):
        raise AssertionError(f"expected 2 provenance records of 2 processes, got "
                             f"{[p['env'].get('process_count') for p in prov]}")
    events = [json.loads(line).get("event") for line in
              (root / "exp" / "metrics.jsonl").read_text().splitlines()]
    if "resume" not in events:
        raise AssertionError("no resume marker in metrics.jsonl")
    hyps = {}
    for name in ["decode_ranks"] + [f"decode_rank{r}" for r in range(N_PROC)]:
        recs = [json.loads(line) for line in
                (root / name / "ctc_greedy" / "dev-clean.jsonl").read_text().splitlines()]
        hyps[name] = [(x["id"], x["hyp"]) for x in recs]
    if not hyps["decode_ranks"] or len(set(map(tuple, hyps.values()))) != 1:
        raise AssertionError(f"decodes differ: {hyps}")
    return {"epochs": len(by_epoch), "decoded": len(hyps["decode_ranks"]),
            "digest": digests[0]["resumed"][:16]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    which = ap.add_mutually_exclusive_group()
    for name in ("fsdp", "sp", "pp", "tp", "ep"):
        which.add_argument(f"--{name}", dest="plane", action="store_const", const=name)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.child:
        child_main(args.rank, Path(args.root), args.device, args.backend, args.plane)
        return 0
    root = Path(args.root) if args.root else Path(tempfile.mkdtemp(prefix="smoke2p_"))
    root.mkdir(parents=True, exist_ok=True)
    prep(root, args.plane)
    codes = launch(root, args.device, args.backend, args.plane, args.timeout)
    if any(codes):
        for r in range(N_PROC):
            print(f"----- child {r} log tail -----\n"
                  + (root / f"child{r}.log").read_text()[-4000:])
        print(f"[smoke_2proc] children exited {codes}")
        return 1
    out = check(root, args.plane in SAME_ROWS)
    print(f"[smoke_2proc] ALL CHECKS PASSED {json.dumps(out)} root={root}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
