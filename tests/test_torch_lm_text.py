"""The port's LM text pipeline (data/lm_text.py, tasks/lm_task.py) against
the JAX package's on the CPU: ``LMTextDataset`` / ``make_lm_dataloader``
batches on a small corpus file (blank and whitespace-only lines, an
unterminated last line) and on manifest transcripts; the line-index and
token-length sidecars reused, and rebuilt when the corpus changes; and
``python -m hnet_mamba_asr_torch.scripts.train_lm --device cpu`` on a d-32
LM writing the ``valid.loss.ave.ckpt`` that ``load_lm_scorer`` loads."""
import json
import os
import shutil

import numpy as np
import torch

from hnet_mamba_asr_torch.convert import jax_to_state_dict
from hnet_mamba_asr_torch.data import lm_text
from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
from hnet_mamba_asr_torch.scripts import train_lm
from hnet_mamba_asr_torch.tasks.decode_task import load_lm_scorer
from hnet_mamba_asr_torch.tools.gate import lexicon
from hnet_mamba_asr_torch.training import checkpoint as ckpt
from hnet_mamba_asr_torch.utils.config import load_config
from hnet_mamba_asr_tpu.data import lm_text as jlm_text
from hnet_mamba_asr_tpu.data.tokenizer import Tokenizer as JTokenizer


def _corpus(tmp_path, n=300):
    rng = np.random.default_rng(4)
    words = [w.upper() for w in lexicon(rng, 60)]
    lines = [" ".join(rng.choice(words, size=int(rng.integers(1, 14)))) for _ in range(n)]
    lines[5], lines[17], lines[40] = "", "   \t ", " " + lines[40] + "  "
    text = "\n".join(lines)                              # no newline after the last line
    Tokenizer.train([ln for ln in lines if ln.strip()], tmp_path / "bpe", vocab_size=48,
                    hard_vocab_limit=False)
    return text, lines


def _batches(loader, epochs=2):
    out = []
    for e in range(epochs):
        loader.set_epoch(e)
        out.extend(loader)
    return out


def _same(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys() and a["ids"] == b["ids"]
        for k in ("tokens", "token_lens", "row_mask"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_lm_batches_match_jax(tmp_path):
    text, lines = _corpus(tmp_path)
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "corpus.txt").write_text(text)
    tok, jtok = Tokenizer(tmp_path / "bpe.model"), JTokenizer(tmp_path / "bpe.model")
    ds = lm_text.LMTextDataset(tok, corpus_path=tmp_path / "port" / "corpus.txt", max_tokens=9)
    jds = jlm_text.LMTextDataset(jtok, corpus_path=tmp_path / "jax" / "corpus.txt",
                                 max_tokens=9)
    assert len(ds) == len(jds) == len(lines) - 2
    assert np.array_equal(ds.offsets, jds.offsets) and ds.lengths == jds.lengths
    got, _ = lm_text.make_lm_dataloader(ds, 96, shuffle=True, seed=3)
    want, _ = jlm_text.make_lm_dataloader(jds, 96, shuffle=True, seed=3)
    _same(_batches(got), _batches(want))
    manifest = tmp_path / "dev.jsonl"
    manifest.write_text("".join(json.dumps({"id": str(i), "text": ln}) + "\n"
                                for i, ln in enumerate(lines[:40])))
    dev = lm_text.LMTextDataset.from_manifest(manifest, tok)
    jdev = jlm_text.LMTextDataset.from_manifest(manifest, jtok)
    got, _ = lm_text.make_lm_dataloader(dev, 64, shuffle=False, batch_multiple=4)
    want, _ = jlm_text.make_lm_dataloader(jdev, 64, shuffle=False, batch_multiple=4)
    _same(list(got), list(want))


def test_sidecars_reused_and_rebuilt(tmp_path):
    text, _ = _corpus(tmp_path)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(text)
    tok = Tokenizer(tmp_path / "bpe.model")
    first = lm_text.LMTextDataset(tok, corpus_path=corpus)
    idx, lens = corpus.with_suffix(".txt.idx.npz"), corpus.with_suffix(".txt.len.bpe.npz")
    stamps = (idx.stat().st_mtime_ns, lens.stat().st_mtime_ns)
    again = lm_text.LMTextDataset(tok, corpus_path=corpus)
    assert (idx.stat().st_mtime_ns, lens.stat().st_mtime_ns) == stamps
    assert again.lengths == first.lengths
    corpus.write_text(text + "\nONE MORE LINE HERE")
    os.utime(corpus, ns=(stamps[0] + 10 ** 9, stamps[0] + 10 ** 9))
    grown = lm_text.LMTextDataset(tok, corpus_path=corpus)
    assert len(grown) == len(first) + 1
    assert grown.lengths[:-1] == first.lengths and grown.lengths[-1] == len(
        tok.encode("ONE MORE LINE HERE"))
    with np.load(idx) as z:
        assert len(z["offsets"]) == len(grown)
    lens.write_bytes(b"torn")                           # an unreadable sidecar is rebuilt
    assert lm_text.LMTextDataset(tok, corpus_path=corpus).lengths == grown.lengths


LM_YAML = """
experiment: {{name: lm_cli, seed: 1}}
bpemodel: {root}/bpe.model
data: {{lm_corpus: {root}/corpus.txt, manifests_dir: {root}/manifests, dev_splits: [dev-clean]}}
lm_conf: {{d_model: 32, n_layers: 1, n_heads: 2, d_ff: 64, dropout: 0.1, lsm_weight: 0.0,
          max_line_tokens: 32}}
batch_tokens: 400
optim: adamw
optim_conf: {{lr: 1.0e-3, weight_decay: 1.0e-6, betas: [0.9, 0.98]}}
scheduler: warmuplr
scheduler_conf: {{warmup_steps: 20}}
train: {{max_epoch: 2, grad_clip: 5.0, precision: fp32, log_interval: 2}}
eval: {{valid_interval_epoch: 1}}
best_model_criterion: [[valid, loss, min]]
keep_nbest_models: 2
keep_all_checkpoints: false
early_stopping: {{enable: false}}
"""


def test_train_lm_cli_writes_the_decode_checkpoint(tmp_path):
    text, lines = _corpus(tmp_path)
    (tmp_path / "corpus.txt").write_text(text)
    (tmp_path / "manifests").mkdir()
    (tmp_path / "manifests" / "dev-clean.jsonl").write_text(
        "".join(json.dumps({"id": str(i), "text": ln}) + "\n" for i, ln in enumerate(lines[:30])))
    (tmp_path / "lm.yaml").write_text(LM_YAML.format(root=tmp_path))
    trainer = train_lm.run(train_lm.parse_args(
        ["--config", str(tmp_path / "lm.yaml"), "--exp-dir", str(tmp_path / "exp"),
         "--device", "cpu"]))
    ave = tmp_path / "exp" / "checkpoints" / "valid.loss.ave.ckpt"
    assert ave.exists() and trainer.global_step > 0
    assert set(trainer.metric_history) == {("train", "loss"), ("valid", "loss")}
    cfg = load_config(tmp_path / "lm.yaml")
    tok = Tokenizer(tmp_path / "bpe.model")
    scorer = load_lm_scorer({"lm_checkpoint": str(ave)}, cfg, tok, device="cpu")
    averaged = ckpt.load_checkpoint(ave)
    assert len(averaged["averaged"]) == 2
    want = jax_to_state_dict(averaged["params"])
    for k, v in scorer.lm.state_dict().items():
        assert torch.equal(v, want[f"lm.{k}"]), k
    summary = json.loads((tmp_path / "exp" / "summary.json").read_text())
    assert summary["best_valid_loss_epoch"] in (0, 1) and "provenance" in summary
    shutil.rmtree(tmp_path / "exp")
