"""Dev WER trajectory of the tone gate (``overfit_config``: d 32, CTC only,
lr 3e-3; with ``--rnnt`` the transducer recipe of
``tests/test_overfit_gate_rnnt.py``: RNN-T only, d_pred 32, d_joint 64, lr
5e-3, validated every 40 epochs) on the CPU in fp32, three ways over the
same corpus, tokenizer and CMVN:

1. the JAX package through ``scripts/train.py``, as
   ``tests/test_overfit_gate.py`` runs it (init ``PRNGKey(0)``);
2. the port's ``Trainer`` from those same initial params, carried across by
   ``convert.py``, and from JAX's draws at other keys;
3. the port's ``Trainer`` from its own seeded draws (``build_model(seed=s)``).

If (2) tracks (1), the port trains as JAX does and any gap between (1) and
(3) is the initial draw; if (2) parts from (1), the port's training differs.

    JAX_PLATFORMS=cpu python tests/torch_gate_trajectory.py [--epochs 40] [--seeds 0 1 2 3]
        [--jax-keys 1 2 3] [--rnnt]

Prints one line per run and, last, a JSON object with every trajectory.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))


# the transducer recipe's overrides of overfit_config (tests/test_overfit_gate_rnnt.py)
RNNT_OVERRIDES = ["model_conf.ctc_weight=0.0", "model_conf.rnnt_weight=1.0",
                  "rnnt_conf.d_pred=32", "rnnt_conf.d_joint=64", "optim_conf.lr=5.0e-3",
                  "eval.valid_interval_epoch=40"]


def rnnt_recipe(cfg: dict) -> dict:
    """overfit_config's dict with RNNT_OVERRIDES applied."""
    cfg["model_conf"].update(ctc_weight=0.0, rnnt_weight=1.0)
    cfg["rnnt_conf"] = {"d_pred": 32, "d_joint": 64}
    cfg["optim_conf"]["lr"] = 5.0e-3
    cfg["eval"]["valid_interval_epoch"] = 40
    return cfg


def jax_run(root: Path, epochs: int, keys, rnnt: bool = False):
    """Train through the JAX scripts; returns the dev WERs and the initial
    params at PRNGKey(k) for k in (0, *keys)."""
    import build_tokenizer
    import compute_cmvn
    import jax
    import numpy as np
    import train as train_script

    from hnet_mamba_asr_tpu.data.synthetic import build_tone_corpus, overfit_config
    from hnet_mamba_asr_tpu.tasks.asr_task import build_model
    from hnet_mamba_asr_tpu.tasks.build import build_cmvn, build_tokenizer as jtok
    from hnet_mamba_asr_tpu.utils.config import load_config

    build_tone_corpus(root)
    (root / "cfg.yaml").write_text(overfit_config(root, max_epoch=epochs))
    build_tokenizer.run(["--manifests", str(root / "manifests" / "train-960.jsonl"),
                         "--out", str(root / "tok" / "bpe"), "--vocab-size", "12",
                         "--no-hard-limit"])
    compute_cmvn.run(["--manifest", str(root / "manifests" / "train-960.jsonl"),
                      "--out", str(root / "cmvn.npz"), "--n-mels", "20"])
    cfg = load_config(root / "cfg.yaml", RNNT_OVERRIDES if rnnt else [])
    tok = jtok(cfg, REPO)
    model = build_model(cfg, tok.vocab_size, cmvn=build_cmvn(cfg, REPO))
    inits = {k: jax.tree_util.tree_map(np.asarray, model.init_params(jax.random.PRNGKey(k)))
             for k in (0, *keys)}
    train_script.run(train_script.parse_args(
        ["--config", str(root / "cfg.yaml"), "--exp-dir", str(root / "exp")]
        + (RNNT_OVERRIDES if rnnt else [])))
    lines = [json.loads(s) for s in (root / "exp" / "metrics.jsonl").read_text().splitlines()]
    return [m["dev_dev-clean/wer"] for m in lines if "dev_dev-clean/wer" in m], inits


def port_run(root: Path, epochs: int, name: str, seed: int = 0, init=None, rnnt: bool = False):
    """Train the port on the CPU from ``init`` (a JAX param tree) or from
    ``build_model(seed=seed)``; returns the dev WERs."""
    from hnet_mamba_asr_torch import convert
    from hnet_mamba_asr_torch.data.dataset import ItemLoader, manifest_items
    from hnet_mamba_asr_torch.data.features import GlobalCMVN
    from hnet_mamba_asr_torch.data.synthetic import overfit_config
    from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.training.trainer import Trainer, flatten_config

    cfg = overfit_config(root, max_epoch=epochs)
    if rnnt:
        cfg = rnnt_recipe(cfg)
    tok = Tokenizer(root / "tok" / "bpe.model")
    cmvn = GlobalCMVN.load(root / "cmvn.npz")
    mdir, bins = root / "manifests", int(cfg["batch_bins"])
    train = ItemLoader(manifest_items(mdir / "train-960.jsonl", tok), bins, seed=seed)
    dev = ItemLoader(manifest_items(mdir / "dev-clean.jsonl", tok), bins, shuffle=False)
    model = build_model(cfg, tok.vocab_size, cmvn=cmvn, seed=seed, device="cpu")
    if init is not None:
        convert.load_jax_params(model, init)
    trainer = Trainer(model, train, flatten_config(cfg), dev_loaders={"dev-clean": dev},
                      tokenizer=tok, ckpt_dir=root / name, seed=seed, device="cpu")
    trainer.train()
    return list(trainer.metric_history[("valid", "wer")].values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    ap.add_argument("--jax-keys", type=int, nargs="*", default=[1, 2, 3])
    ap.add_argument("--rnnt", action="store_true", help="the transducer recipe")
    args = ap.parse_args()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        out["jax"], inits = jax_run(root, args.epochs, args.jax_keys, args.rnnt)
        print(f"JAX, PRNGKey(0): dev WER {out['jax']}", flush=True)
        for k, init in inits.items():
            name = f"port_jax_key_{k}"
            out[name] = port_run(root, args.epochs, name, init=init, rnnt=args.rnnt)
            print(f"port, JAX's initial params at PRNGKey({k}): dev WER {out[name]}", flush=True)
        for s in args.seeds:
            out[f"port_seed_{s}"] = port_run(root, args.epochs, f"port_{s}", seed=s,
                                             rnnt=args.rnnt)
            print(f"port, seed {s}: dev WER {out[f'port_seed_{s}']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
