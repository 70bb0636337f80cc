"""The port's training entry point on the CPU against the JAX package:
checkpoint selection, pruning and early stopping against JAX's own Trainer
methods on scripted metric histories; ``average_checkpoints`` on the port's
files against JAX's; ``Trainer.validate`` against JAX's on the same batches
and hypotheses (per-split loss / WER / CER, the ``dev_<split>/*`` scalars,
``metric_history``); and ``python -m hnet_mamba_asr_torch.scripts.train
--device cpu`` over a synthetic LibriSpeech tree at d 32 (speed
perturbation, validation, pruning to the best, N-best averaging, the metrics
sink, a resume equal to an uninterrupted run bitwise, early stopping), whose
averaged checkpoint the decode CLI reads."""
import itertools
import json
import os

import numpy as np
import pytest
import torch

import jax

from hnet_mamba_asr_torch.scripts import build_manifests, build_tokenizer, compute_cmvn
from hnet_mamba_asr_torch.scripts import decode as decode_cli
from hnet_mamba_asr_torch.scripts import train as train_cli
from hnet_mamba_asr_torch.tools.gate import librispeech_tree, seeded_tokenizer
from hnet_mamba_asr_torch.training import checkpoint as ckpt
from hnet_mamba_asr_torch.training.trainer import Trainer
from hnet_mamba_asr_tpu.data.tokenizer import Tokenizer as JTokenizer
from hnet_mamba_asr_tpu.parallel.mesh import make_mesh
from hnet_mamba_asr_tpu.training import checkpoint as jckpt
from hnet_mamba_asr_tpu.training.trainer import Trainer as JTrainer

CRITERIA = [("valid", "wer", "min"), ("valid", "loss", "min"), ("valid", "acc", "max")]


def _stub(cls, tmp, history, epoch, **kw):
    t = cls.__new__(cls)
    t.__dict__.update(dict(is_main=True, metric_history=history, epoch=epoch, ckpt_dir=tmp,
                           _ckpt_writer=None, best_model_criterion=CRITERIA, keep_nbest=2,
                           keep_all=False, metrics=None, early_stopping={}), **kw)
    return t


def _history(rng, n):
    # ties, steps below min_delta and worse epochs, by a coarse random walk
    return {(p, m): {e: float(np.round(v, 2)) for e, v in
                     enumerate(5 + np.cumsum(rng.choice([-0.3, -0.02, 0.0, 0.2], size=n)))}
            for p, m, _ in CRITERIA}


@pytest.mark.parametrize("seed", range(4))
def test_selection_and_stopping_match_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    n = 9
    history = _history(rng, n)
    for epoch, require_all, patience, min_delta in itertools.product(
            (0, 4, n - 1), (True, False), (0, 2), (0.0, 0.05, 0.25)):
        hist = {k: {e: v for e, v in h.items() if e <= epoch} for k, h in history.items()}
        es = {"enable": True, "require_all": require_all,
              "criteria": [{"phase": "valid", "metric": "wer", "mode": "min",
                            "patience": patience, "min_delta": min_delta},
                           {"phase": "valid", "metric": "acc", "mode": "max",
                            "patience": patience + 1, "min_delta": min_delta}]}
        port = _stub(Trainer, tmp_path, hist, epoch, early_stopping=es)
        jax_ = _stub(JTrainer, tmp_path, hist, epoch, early_stopping=es)
        assert port._should_early_stop() == JTrainer._should_early_stop(jax_)
        for p, m, mode in CRITERIA:
            assert port._best_epoch(p, m, mode) == JTrainer._best_epoch(jax_, p, m, mode)
            assert (port._last_significant_best(p, m, mode, min_delta)
                    == JTrainer._last_significant_best(jax_, p, m, mode, min_delta))
    kept = {}
    for cls, name in ((Trainer, "port"), (JTrainer, "jax")):
        d = tmp_path / name
        d.mkdir()
        for e in range(n):
            (d / f"epoch{e:04d}.ckpt").write_bytes(b"x")
        t = _stub(cls, d, history, n - 1)
        cls._prune_checkpoints(t)
        kept[name] = sorted(os.listdir(d))
    assert kept["port"] == kept["jax"] and 1 <= len(kept["port"]) <= 7


def test_average_checkpoints_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(3):
        params = {"enc": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                          "b": rng.normal(size=3).astype(np.float32)},
                  "ctc": {"kernel": rng.normal(size=(3, 5)).astype(np.float32)}}
        paths.append(tmp_path / f"epoch{i:04d}.ckpt")
        ckpt.save_checkpoint(paths[-1], {"params": params, "epoch": i})
    got, want = ckpt.average_checkpoints(paths), jckpt.average_checkpoints(paths)
    assert got["averaged"] == want["averaged"] == [str(p) for p in paths]
    leaves = lambda t: {jax.tree_util.keystr(p): v for p, v in  # noqa: E731
                        jax.tree_util.tree_leaves_with_path(t)}
    g, w = leaves(got["params"]), leaves(want["params"])
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].dtype == np.float32 and np.array_equal(g[k], np.asarray(w[k])), k
    ckpt.update_best_symlink(tmp_path, "valid", "loss", 1)
    assert os.readlink(tmp_path / "valid.loss.best.ckpt") == "epoch0001.ckpt"
    ckpt.remove_checkpoint(tmp_path / "valid.loss.best.ckpt")
    assert (tmp_path / "epoch0001.ckpt").exists()


class _Sink:
    def __init__(self):
        self.lines = []

    def log_scalar(self, key, value, step, **meta):
        self.log_scalars({key: value}, step, **meta)

    def log_scalars(self, payload, step, **meta):
        self.lines.append({"step": step, **meta, **{k: float(v) for k, v in payload.items()}})


def test_validate_matches_jax(tmp_path):
    """Both validations over the same two dev splits: scripted losses and
    weights per batch, scripted greedy hypotheses; with and without a
    tokenizer (JAX scores no WER / CER without one)."""
    rng = np.random.default_rng(5)
    tok = seeded_tokenizer(tmp_path / "tok.model", 20)
    splits = {}
    for name, n_batches in (("dev-a", 2), ("dev-b", 1)):
        batches = []
        for _ in range(n_batches):
            rows, real = 3, int(rng.integers(1, 4))
            lens = rng.integers(1, 6, size=rows).astype(np.int32)
            batches.append({"tokens": rng.integers(4, 20, size=(rows, 8)).astype(np.int32),
                            "token_lens": lens, "row_mask": np.arange(rows) < real,
                            "ids": [f"u{i}" for i in range(real)],
                            "loss": np.float32(rng.uniform(1, 3)),
                            "hyps": [rng.integers(4, 20, size=rng.integers(0, 6)).tolist()
                                     for _ in range(rows)]})
        splits[name] = batches

    def by_loss(b):                       # the batch a (device) batch came from
        return next(x for bs in splits.values() for x in bs
                    if np.isclose(x["loss"], float(np.asarray(b["loss"]))))

    def stats(b):
        return {"loss/total": float(np.asarray(b["loss"])),
                "batch_weight": float(np.asarray(b["row_mask"]).sum()) + 0.5}

    class PortModel(torch.nn.Module):
        def loss_fn(self, b, step, train):
            return None, {k: torch.tensor(v) for k, v in stats(b).items()}

        def greedy_decode(self, b):
            return by_loss(b)["hyps"]

    class JaxModel:
        def greedy_decode(self, params, b):
            return by_loss(b)["hyps"]

    def loaders():
        return {k: [{kk: vv for kk, vv in b.items() if kk != "hyps"} for b in v]
                for k, v in splits.items()}

    for tokenizer in (tok, None):
        port = Trainer.__new__(Trainer)
        port.__dict__.update(device=torch.device("cpu"), model=PortModel(),
                             dev_loaders=loaders(), tokenizer=tokenizer, metrics=_Sink(),
                             metric_history={}, epoch=3, global_step=11)
        jax_ = JTrainer.__new__(JTrainer)
        jax_.__dict__.update(mesh=make_mesh(1), model=JaxModel(), params=None,
                             _eval_loss=lambda p, b: (None, stats(b)),
                             dev_loaders=loaders(), tokenizer=JTokenizer(tok.model_path)
                             if tokenizer else None, metrics=_Sink(), is_main=True,
                             metric_history={}, epoch=3, global_step=11)
        got, want = port.validate(), JTrainer.validate(jax_)
        assert got == want
        assert port.metric_history == jax_.metric_history
        assert port.metrics.lines == jax_.metrics.lines
        assert ("wer" in got["dev-a"]) == ("cer" in got["dev-a"]) == (tokenizer is not None)
        assert (("valid", "cer") in port.metric_history) == (tokenizer is not None)


# ---- the train CLI ------------------------------------------------------------------
CONFIG = """
experiment: {{name: cli_train, seed: 0}}
data: {{manifests_dir: {root}/manifests, train_manifest: train-clean-100,
        dev_splits: [dev-clean], wire_dtype: int16, perturb_cache_dir: {root}/pcache}}
bpemodel: {root}/bpe.model
frontend_conf: {{sample_rate: 16000, n_mels: 20, win_length: 400, hop_length: 160,
                 cmvn: {root}/cmvn.npz}}
specaug_conf: {{freq_mask_width_range: [0, 4], num_freq_mask: 1,
                time_mask_width_ratio_range: [0.0, 0.05], num_time_mask: 2}}
encoder: dcasr
encoder_conf: {{arch_type: A, d_outer: 32, d_main: 32, n_enc: 1, n_main: 1, n_dec: 1,
                d_state: 16, headdim: 16, ssd_chunk_size: 32, hnet: {{compression_N: 1}}}}
aed_conf: {{n_layers: 1, n_heads: 2, d_ff: 64, dropout: 0.1, max_decode_len: 8}}
model_conf: {{ctc_weight: 0.3, aed_weight: 0.7, lsm_weight: 0.1}}
batch_bins: 400
accum_grad: 2
optim: adamw
optim_conf: {{lr: 1.0e-3, weight_decay: 1.0e-2}}
scheduler: warmuplr
scheduler_conf: {{warmup_steps: 10}}
train: {{max_epoch: 3, grad_clip: 1.0, precision: fp32, log_interval: 1,
         speed_perturb: [0.9, 1.0, 1.1]}}
eval: {{valid_interval_epoch: 1}}
best_model_criterion: [[valid, wer, min], [valid, loss, min]]
keep_nbest_models: 1
keep_all_checkpoints: false
early_stopping: {{enable: false}}
decode: {{read_outs: [ctc], search: [greedy], lm: none, batch_bins: 400}}
"""


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    librispeech_tree(root / "LS", {"train-clean-100": 8, "dev-clean": 3}, seed=3,
                     seconds=(0.3, 1.5))
    build_manifests.run(["--root", str(root / "LS"), "--out-dir", str(root / "manifests"),
                         "--splits", "train-clean-100", "dev-clean"])
    build_tokenizer.run(["--manifests", str(root / "manifests" / "train-clean-100.jsonl"),
                         "--out", str(root / "bpe"), "--vocab-size", "36"])
    compute_cmvn.run(["--manifest", str(root / "manifests" / "train-clean-100.jsonl"),
                      "--out", str(root / "cmvn.npz"), "--n-mels", "20", "--device", "cpu"])
    (root / "cfg.yaml").write_text(CONFIG.format(root=root))
    return root


def _train(root, exp, *extra):
    return train_cli.run(train_cli.parse_args(
        ["--config", str(root / "cfg.yaml"), "--exp-dir", str(root / exp), "--device", "cpu",
         *extra]))


def test_train_cli_resumes_bitwise_and_writes_its_files(workspace):
    root = workspace
    straight = _train(root, "a")
    assert straight.epoch == 2 and straight.global_step > 0
    first = _train(root, "b", "train.max_epoch=2")
    assert first.epoch == 1 and len(first.train_loader.dataset) == 3 * 8
    resumed = _train(root, "b", "--resume", "auto")
    assert resumed.history[0]["step"] == first.global_step + 1
    assert resumed.history[0]["lr"] == resumed.lr_schedule(first.global_step)
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert straight.metric_history == resumed.metric_history
    assert set(straight.metric_history) == {("train", "loss"), ("valid", "loss"),
                                            ("valid", "wer"), ("valid", "cer")}
    files = sorted(os.listdir(root / "b" / "checkpoints"))
    best = {m: resumed._best_epoch("valid", m, "min") for m in ("wer", "loss")}
    assert files == sorted({f"epoch{e:04d}.ckpt" for e in (2, *best.values())}
                           | {"latest.ckpt", "valid.wer.best.ckpt", "valid.loss.best.ckpt",
                              "valid.wer.ave.ckpt", "valid.loss.ave.ckpt"})
    for m, e in best.items():
        assert os.readlink(root / "b" / "checkpoints" / f"valid.{m}.best.ckpt") == \
            f"epoch{e:04d}.ckpt"
    ave = ckpt.load_checkpoint(root / "b" / "checkpoints" / "valid.loss.ave.ckpt")
    assert ave["averaged"] == [str(root / "b" / "checkpoints" / f"epoch{best['loss']:04d}.ckpt")]
    lines = [json.loads(ln) for ln in open(root / "b" / "metrics.jsonl")]
    assert sum(ln.get("event") == "resume" for ln in lines) == 1
    assert {"train/lr", "train/grad_norm", "train/samples_per_s", "dev_dev-clean/cer",
            "valid/wer"} <= set().union(*lines)
    summary = json.loads((root / "b" / "summary.json").read_text())
    assert len(summary["provenance"]) == 2 and summary["final_step"] == resumed.global_step
    assert summary["epochs"] == 3 and summary["n_devices"] == 1
    assert summary["best_valid_loss_epoch"] == best["loss"]
    assert sorted(p.name for p in (root / "pcache").iterdir())[0].endswith("#sp0.9.npy")

    # the decode CLI reads the averaged file
    out = decode_cli.run(decode_cli.parse_args(
        ["--config", str(root / "cfg.yaml"), "--checkpoint",
         str(root / "b" / "checkpoints" / "valid.loss.ave.ckpt"), "--splits", "dev-clean",
         "--out-dir", str(root / "decode"), "--device", "cpu"]))
    assert [c["cell"] for c in out["cells"]] == ["ctc_greedy"]
    assert len((root / "decode" / "ctc_greedy" / "dev-clean.jsonl").read_text().splitlines()) == 3


def test_train_cli_early_stopping(workspace):
    """patience 0 and a min_delta no run can beat: the first epoch stays the
    last significant best, so the run stops after its second epoch."""
    es = ("early_stopping={enable: true, require_all: true, criteria: "
          "[{phase: valid, metric: loss, mode: min, patience: 0, min_delta: 1.0e9}]}")
    trainer = _train(workspace, "es", "train.max_epoch=5", es)
    assert trainer.epoch == 1
    summary = json.loads((workspace / "es" / "summary.json").read_text())
    assert summary["epochs"] == 2 and summary["final_step"] == trainer.global_step
