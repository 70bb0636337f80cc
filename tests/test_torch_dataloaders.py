"""The port's host data pipeline against the JAX package's on a synthetic
LibriSpeech-layout tree (WAV and FLAC, 0.3-2 s): ``build_manifest`` line for
line; ``build_dataloaders`` batches (speed perturbation 0.9 / 1.0 / 1.1,
the perturb cache, the int16 wire) bitwise over two epochs; the cache's
files written in epoch 0 and read back in epoch 1; a truncated cache file
recomputed; prefetch 2 == prefetch 0; a worker's exception raised in the
consumer."""
import json

import numpy as np
import pytest

from hnet_mamba_asr_torch.data import dataset as tdataset
from hnet_mamba_asr_torch.data.manifests import build_manifest
from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
from hnet_mamba_asr_torch.tasks.build import build_dataloaders
from hnet_mamba_asr_torch.tools.gate import librispeech_tree
from hnet_mamba_asr_tpu.data.manifests import build_manifest as jbuild_manifest
from hnet_mamba_asr_tpu.data.tokenizer import Tokenizer as JTokenizer
from hnet_mamba_asr_tpu.tasks.build import build_dataloaders as jbuild_dataloaders

KEYS = ("wave", "wave_lens", "tokens", "token_lens", "row_mask", "aug_ref", "item_index")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ls")
    librispeech_tree(root / "LS", {"train-clean-100": 7, "dev-clean": 3}, seed=2,
                     seconds=(0.3, 2.0), wav_every=3)
    for split in ("train-clean-100", "dev-clean"):
        build_manifest(root / "LS", [split], root / "manifests" / f"{split}.jsonl")
    lines = [json.loads(ln)["text"] for ln in
             open(root / "manifests" / "train-clean-100.jsonl")]
    Tokenizer.train(lines, root / "bpe", vocab_size=40, hard_vocab_limit=False)
    return root


def _cfg(root, cache, **train):
    return {"batch_bins": 500,
            "train": {"speed_perturb": [0.9, 1.0, 1.1], **train},
            "data": {"manifests_dir": str(root / "manifests"),
                     "train_manifest": "train-clean-100", "dev_splits": ["dev-clean"],
                     "wire_dtype": "int16", "perturb_cache_dir": str(root / cache)}}


def _epochs(loader, n=2):
    out = []
    for epoch in range(n):
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["ids"] == b["ids"]
        for k in KEYS:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_manifest_matches_jax(tree, tmp_path):
    for split in ("train-clean-100", "dev-clean"):
        jbuild_manifest(tree / "LS", [split], tmp_path / f"{split}.jsonl")
        got = (tree / "manifests" / f"{split}.jsonl").read_text().splitlines()
        assert got == (tmp_path / f"{split}.jsonl").read_text().splitlines()
    entries = [json.loads(ln) for ln in got]
    assert {e["audio"].rsplit(".", 1)[1] for e in entries} == {"wav", "flac"}


def test_dataloaders_match_jax_over_two_epochs(tree):
    tok, jtok = Tokenizer(tree / "bpe.model"), JTokenizer(tree / "bpe.model")
    train, _, dev = build_dataloaders(_cfg(tree, "pc_port"), tree, tok, seed=4)
    jtrain, _, jdev = jbuild_dataloaders(_cfg(tree, "pc_jax"), tree, jtok, n_devices=1, seed=4)
    assert train.prefetch == 2 and len(train.dataset) == 3 * 7
    epoch0_port = list(train)
    cached = sorted(p.name for p in (tree / "pc_port").iterdir())
    assert len(cached) == 14 and all("#sp0.9" in n or "#sp1.1" in n for n in cached)
    assert train.dataset.cache_misses == 14 and train.dataset.cache_hits == 0
    train.set_epoch(1)
    for got, want in zip([epoch0_port, list(train)], _epochs(jtrain)):
        _assert_same(got, want)
    assert train.dataset.cache_hits == 14            # epoch 1 read every file back
    ids = [i for b in epoch0_port for i in b["ids"]]
    assert sum("#sp" in i for i in ids) == 14 and len(ids) == 21
    _assert_same(list(dev["dev-clean"]), list(jdev["dev-clean"]))


def test_truncated_cache_file_is_recomputed(tree):
    tok = Tokenizer(tree / "bpe.model")
    train, _, _ = build_dataloaders(_cfg(tree, "pc_trunc", prefetch=0), tree, tok, seed=4)
    want = list(train)
    victim = sorted((tree / "pc_trunc").iterdir())[0]
    size = victim.stat().st_size
    victim.write_bytes(victim.read_bytes()[:size // 2])
    train.dataset.cache_misses = 0
    _assert_same(list(train), want)
    assert train.dataset.cache_misses == 1 and victim.stat().st_size == size


def test_prefetch_matches_serial_and_raises_worker_errors(tree):
    tok = Tokenizer(tree / "bpe.model")
    serial, _, _ = build_dataloaders(_cfg(tree, "pc_pf", prefetch=0), tree, tok, seed=1)
    ahead, _, _ = build_dataloaders(_cfg(tree, "pc_pf", prefetch=2), tree, tok, seed=1)
    assert serial.prefetch == 0 and ahead.prefetch == 2
    for a, b in zip(_epochs(serial), _epochs(ahead)):
        _assert_same(a, b)
    entries = ahead.dataset.entries
    entries[len(entries) // 2] = dict(entries[len(entries) // 2],
                                      audio=str(tree / "missing.wav"))
    ahead.dataset.perturb_cache_dir = None
    with pytest.raises(FileNotFoundError):
        list(ahead)
    # row_shard over one process: the unsharded batches, row for row
    one, _ = tdataset.make_dataloader(serial.dataset, 500, row_shard=True)
    plain, _ = tdataset.make_dataloader(serial.dataset, 500)
    _assert_same(list(one), list(plain))
