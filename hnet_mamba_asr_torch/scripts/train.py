"""Train an ASR model from a YAML config (and key=value overrides).

    python -m hnet_mamba_asr_torch.scripts.train --config configs/typeA_small_N1.yaml \
        [--resume auto|<ckpt>] [--exp-dir DIR] [--device cuda] [key.path=value ...]

The JAX package's ``scripts/train.py`` on one card: config -> tokenizer,
CMVN and dataloaders (``tasks/build.py``: speed perturbation, the perturb
cache, prefetch) -> ``build_model`` -> ``Trainer.train``. Artifacts land
under ``experiments/<experiment.name>/`` (or ``--exp-dir``):
``checkpoints/`` (``epoch%04d.ckpt``, ``latest.ckpt``, the best symlinks,
the averaged ``*.ave.ckpt``), ``metrics.jsonl``, ``summary.json`` with the
provenance, ``logs/``. The model-parallel planes (``train.tp``, ``sp``,
``pp``, ``ep``, ``fsdp``) and ``scan_steps`` are not ported and raise.
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

    device = require_device(args.device)
    cfg = load_config(args.config, args.overrides)
    name = (cfg.get("experiment", {}) or {}).get("name", Path(args.config).stem)
    exp_dir = Path(args.exp_dir) if args.exp_dir else REPO_ROOT / "experiments" / name
    setup_logging("train", exp_dir / "logs")
    logger = get_logger("train")
    seed = int((cfg.get("experiment", {}) or {}).get("seed", 0))

    tokenizer = build_tokenizer(cfg, REPO_ROOT)
    cmvn = build_cmvn(cfg, REPO_ROOT)
    train_loader, _, dev_loaders = build_dataloaders(cfg, REPO_ROOT, tokenizer, seed=seed)
    model = build_model(cfg, tokenizer.vocab_size, cmvn=cmvn, seed=seed, device=device)
    metrics = MetricsLogger(exp_dir, resume=args.resume is not None)
    prov = collect_provenance(cfg, repo_root=REPO_ROOT, seed=seed,
                              artifacts={"tokenizer": cfg.get("bpemodel")})
    trainer = Trainer(model, train_loader, flatten_config(cfg), dev_loaders=dev_loaders,
                      tokenizer=tokenizer, metrics=metrics, ckpt_dir=exp_dir / "checkpoints",
                      seed=seed, provenance=prov, device=device)
    logger.info("training %s -> %s", name, exp_dir)
    try:
        trainer.train(resume=args.resume)
    finally:
        metrics.close()
    return trainer


if __name__ == "__main__":
    run(parse_args())
