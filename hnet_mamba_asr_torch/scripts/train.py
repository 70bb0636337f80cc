"""Train an ASR model from a YAML config (and key=value overrides).

    python -m hnet_mamba_asr_torch.scripts.train --config configs/typeA_small_N1.yaml \
        [--resume auto|<ckpt>] [--exp-dir DIR] [--device cuda] [key.path=value ...]

    torchrun --nproc_per_node 2 -m hnet_mamba_asr_torch.scripts.train --config ... \
        [--dist-backend nccl|gloo] [train.fsdp=true | train.sp=2 | train.pp=2 | train.tp=2
        | train.ep=2]

The JAX package's ``scripts/train.py``: config -> tokenizer, CMVN and
dataloaders (``tasks/build.py``: speed perturbation, the perturb cache,
prefetch) -> ``build_model`` -> ``Trainer.train``. Artifacts land under
``experiments/<experiment.name>/`` (or ``--exp-dir``): ``checkpoints/``
(``epoch%04d.ckpt``, ``latest.ckpt``, the best symlinks, the averaged
``*.ave.ckpt``), ``metrics.jsonl``, ``summary.json`` with the provenance,
``logs/``.

Under torchrun the process group is joined first (``parallel/mesh.py``:
NCCL on the card, one rank per card; ``--dist-backend gloo`` lets ranks
share a card, and is the CPU's), then the planes are validated, then the
mesh is built: each train batch's rows are split over the dp axis,
``train.fsdp`` shards the large leaves over every rank, ``train.sp`` runs
the encoder sequence-parallel (``parallel/seq_parallel.py``), ``train.pp``
pipelines the main stack's blocks over the pp axis of a (dp, pp) mesh
(``parallel/pipeline.py::PPModel``, JAX's ``make_mesh(tp=pp,
tp_axis="pp")``), ``train.tp``
splits the Mamba-2 heads, the H-Net projections and the AED's attention
heads and FFN over the tp axis and ``train.ep`` the MoE AED's experts over
the ep axis (both together on a (dp, tp, ep) mesh; ``parallel/
model_parallel.py``). ``train.scan_steps`` runs K updates between host
reads. Rank 0 alone writes. ``train.fsdp`` with tp / ep / pp raises.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from hnet_mamba_asr_torch.scripts import REPO_ROOT


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--resume", default=None,
                    help="'auto' = the latest checkpoint; or an explicit path")
    ap.add_argument("--exp-dir", default=None, help="instead of experiments/<name>")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="under torchrun; default NCCL on the card, gloo on the CPU")
    ap.add_argument("overrides", nargs="*", help="key.path=value dotlist")
    return ap.parse_args(argv)


def run(args):
    from hnet_mamba_asr_torch.serving.runtime import require_device
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.tasks.build import build_cmvn, build_dataloaders, build_tokenizer
    from hnet_mamba_asr_torch.training.trainer import Trainer
    from hnet_mamba_asr_torch.utils.config import flatten_config, load_config
    from hnet_mamba_asr_torch.utils.logging_utils import get_logger, setup_logging
    from hnet_mamba_asr_torch.utils.metrics_logger import MetricsLogger
    from hnet_mamba_asr_torch.utils.provenance import collect_provenance

    from hnet_mamba_asr_torch.parallel import mesh as pmesh
    from hnet_mamba_asr_torch.parallel.pipeline import PPModel
    from hnet_mamba_asr_torch.parallel.seq_parallel import SPModel

    device = require_device(args.device)
    launched = pmesh.init_distributed(device, args.dist_backend)
    device = pmesh.rank_device(device)
    cfg = load_config(args.config, args.overrides)
    tp, sp, pp, ep, _ = pmesh.validate_planes(flatten_config(cfg))
    rank, n_ranks = pmesh.world()
    name = (cfg.get("experiment", {}) or {}).get("name", Path(args.config).stem)
    exp_dir = Path(args.exp_dir) if args.exp_dir else REPO_ROOT / "experiments" / name
    setup_logging("train", exp_dir / "logs")
    logger = get_logger("train")
    seed = int((cfg.get("experiment", {}) or {}).get("seed", 0))

    tokenizer = build_tokenizer(cfg, REPO_ROOT)
    cmvn = build_cmvn(cfg, REPO_ROOT)
    model = build_model(cfg, tokenizer.vocab_size, cmvn=cmvn, seed=seed, device=device)
    if ep > 1 and getattr(model.aed, "moe_experts", 0) <= 0:
        raise ValueError("train.ep > 1 needs an MoE AED decoder "
                         "(set aed_conf.moe.n_experts)")
    mesh = (pmesh.make_mesh(sp, device, tp=tp, ep=ep, pp=pp)
            if launched or tp * ep * pp > 1 else None)
    _, dp_rank, dp_size = pmesh.mesh_axis(mesh, "dp")
    # under pp a rank's rows split into pp microbatches (PPModel's default)
    train_loader, _, dev_loaders = build_dataloaders(cfg, REPO_ROOT, tokenizer, seed=seed,
                                                     row_split=(dp_rank, dp_size),
                                                     rows_multiple=pp)
    if sp > 1:
        model = SPModel(model, mesh)
    if pp > 1:
        model = PPModel(model, mesh)
    metrics = MetricsLogger(exp_dir, resume=args.resume is not None) if rank == 0 else None
    prov = collect_provenance(cfg, repo_root=REPO_ROOT, seed=seed, n_devices=n_ranks,
                              artifacts={"tokenizer": cfg.get("bpemodel")})
    trainer = Trainer(model, train_loader, flatten_config(cfg), dev_loaders=dev_loaders,
                      tokenizer=tokenizer, metrics=metrics, ckpt_dir=exp_dir / "checkpoints",
                      seed=seed, provenance=prov, device=device, mesh=mesh)
    logger.info("training %s -> %s (rank %d of %d)", name, exp_dir, rank, n_ranks)
    try:
        trainer.train(resume=args.resume)
    finally:
        if metrics is not None:
            metrics.close()
    return trainer


if __name__ == "__main__":
    run(parse_args())
