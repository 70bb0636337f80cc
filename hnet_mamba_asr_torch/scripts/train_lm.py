"""Train the external Transformer LM on the LM corpus (the ASR model's BPE
vocabulary).

    python -m hnet_mamba_asr_torch.scripts.train_lm --config configs/lm_transformer_500.yaml \
        [--resume auto|<ckpt>] [--exp-dir DIR] [--device cuda] [key.path=value ...]

The JAX package's ``scripts/train_lm.py``: the train loader reads
``data.lm_corpus`` (``data/lm_text.py``: a byte-offset line index and the
token counts cached beside the file), the dev loaders the transcripts of
``data.dev_splits``' manifests; the same ``Trainer`` as ASR, whose LM emits
``batch_weight`` = scored tokens, so exp(valid/loss) is the token-weighted
perplexity. ``valid.loss.ave.ckpt`` under ``checkpoints/`` is the file
``decode.lm_checkpoint`` names. Under torchrun (``--dist-backend`` as in
``scripts/train.py``) each train batch's rows are split over the ranks and
``train.fsdp`` shards the large leaves; ``train.ep`` splits an MoE LM's
experts (``lm_conf.moe``) over an ep axis of the ranks, the dense layers
staying whole, as JAX's train_lm's (dp, ep) mesh; tensor, pipeline and
sequence parallelism raise (JAX's LM trainer builds no tp mesh, and the LM
has no SSD encoder to split).
"""
from __future__ import annotations

import argparse
from pathlib import Path

from hnet_mamba_asr_torch.scripts import REPO_ROOT


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--exp-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("overrides", nargs="*")
    return ap.parse_args(argv)


def run(args):
    from hnet_mamba_asr_torch.serving.runtime import require_device
    from hnet_mamba_asr_torch.tasks.build import build_tokenizer
    from hnet_mamba_asr_torch.tasks.lm_task import build_lm, build_lm_dataloaders
    from hnet_mamba_asr_torch.training.trainer import Trainer
    from hnet_mamba_asr_torch.utils.config import flatten_config, load_config
    from hnet_mamba_asr_torch.utils.logging_utils import get_logger, setup_logging
    from hnet_mamba_asr_torch.utils.metrics_logger import MetricsLogger
    from hnet_mamba_asr_torch.utils.provenance import collect_provenance

    from hnet_mamba_asr_torch.parallel import mesh as pmesh

    device = require_device(args.device)
    pmesh.init_distributed(device, args.dist_backend)
    device = pmesh.rank_device(device)
    rank, n_ranks = pmesh.world()
    cfg = load_config(args.config, args.overrides)
    name = (cfg.get("experiment", {}) or {}).get("name", Path(args.config).stem)
    exp_dir = Path(args.exp_dir) if args.exp_dir else REPO_ROOT / "experiments" / name
    setup_logging("train_lm", exp_dir / "logs")
    logger = get_logger("train_lm")
    seed = int((cfg.get("experiment", {}) or {}).get("seed", 0))
    flat = flatten_config(cfg)
    tp, sp, pp, ep, _ = pmesh.validate_planes(flat)
    if sp > 1:
        raise ValueError("train.sp splits the ASR encoder's time axis; the LM has none")
    if pp > 1:
        raise ValueError("train.pp pipelines the ASR encoder's main stack; the LM trainer "
                         "takes train.ep only")
    if tp > 1:
        raise ValueError("train.tp splits the ASR model; the LM trainer takes train.ep only")
    tokenizer = build_tokenizer(cfg, REPO_ROOT)
    model = build_lm(cfg, tokenizer.vocab_size, seed=seed, device=device)
    if ep > 1 and model.lm.moe_experts <= 0:
        raise ValueError("train.ep > 1 needs an MoE LM (lm_conf.moe)")
    mesh = pmesh.make_mesh(device=device, ep=ep) if ep > 1 else None
    _, dp_rank, dp_size = pmesh.mesh_axis(mesh, "dp")
    train_loader, _, dev_loaders = build_lm_dataloaders(
        cfg, REPO_ROOT, tokenizer, seed=seed, row_split=(dp_rank, dp_size) if mesh else None)
    metrics = MetricsLogger(exp_dir, resume=args.resume is not None) if rank == 0 else None
    prov = collect_provenance(cfg, repo_root=REPO_ROOT, seed=seed, n_devices=n_ranks)
    trainer = Trainer(model, train_loader, flat, dev_loaders=dev_loaders, tokenizer=None,
                      metrics=metrics, ckpt_dir=exp_dir / "checkpoints", seed=seed,
                      provenance=prov, device=device, mesh=mesh)
    logger.info("training LM %s -> %s", name, exp_dir)
    try:
        trainer.train(resume=args.resume)
    finally:
        if metrics is not None:
            metrics.close()
    return trainer


if __name__ == "__main__":
    run(parse_args())
