"""The port's data-parallel plane on the CPU against the JAX package: the
row-sharded loaders against JAX's ``row_shard`` loaders row for row, the
process launch (``parallel/mesh.py::init_distributed``), a DDP update of two
gloo ranks against JAX's ``Trainer`` on a 2-device virtual mesh on a global
batch whose real rows and tokens differ between the ranks (N = 1 and
N = 2), ranks bitwise equal after it, rank 1 writing nothing, SpecAugment
and AED dropout drawing on two ranks what one rank draws, and decoding over
two ranks against one process. The two ranks run as one gloo group
(``tests/torch_dist.py``), spawned once for the file."""
import copy
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from torch_dist import run_pair
from torch_parity import HYBRID_CONFIG, NARROW_VOCAB, seeded_tree

from hnet_mamba_asr_torch.data import dataset, lm_text
from hnet_mamba_asr_torch.data.synthetic import build_tone_corpus
from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
from hnet_mamba_asr_torch.parallel import mesh as pmesh
from hnet_mamba_asr_torch.tasks.build import build_dataloaders
from hnet_mamba_asr_tpu.data import dataset as jdataset
from hnet_mamba_asr_tpu.data import lm_text as jlm_text
from hnet_mamba_asr_tpu.data.tokenizer import Tokenizer as JTokenizer
from hnet_mamba_asr_tpu.parallel.mesh import make_mesh as jmake_mesh, place_params
from hnet_mamba_asr_tpu.tasks import asr_task as jtask
from hnet_mamba_asr_tpu.tasks import build as jbuild
from hnet_mamba_asr_tpu.training.trainer import Trainer as JTrainer

REPO = Path(__file__).resolve().parents[1]
V = NARROW_VOCAB
# fp32 on both sides, 2 updates: the bounds of tests/test_fsdp.py. Adam's eps
# is 0.1, so that an update is near-linear in its gradient: at the default
# 1e-8 an element whose gradient is of the order of eps (rounding noise, an
# AED embedding row no target uses) is normalized into an update of the
# rate's size, and its summation order decides it
RTOL, ATOL = 2e-4, 2e-5
TRAIN_CFG = {"max_epoch": 1, "grad_clip": 5.0, "accum_grad": 1, "log_interval": 1,
             "valid_interval_epoch": 1, "keep_nbest_models": 1, "optim": "adamw",
             "optim_conf": {"lr": 1e-2, "weight_decay": 1e-2, "eps": 1e-1}, "scheduler": None,
             "scheduler_conf": {}, "best_model_criterion": [["valid", "loss", "min"]],
             "early_stopping": {}, "async_ckpt": False}
SPECAUG = {"freq_mask_width_range": [0, 5], "num_freq_mask": 2,
           "time_mask_width_ratio_range": [0.0, 0.2], "num_time_mask": 3}


def _config(n: int, dropout: float = 0.0, specaug=None, moe=None):
    cfg = copy.deepcopy(HYBRID_CONFIG)
    cfg["aed_conf"]["dropout"] = dropout
    if moe:
        cfg["aed_conf"]["moe"] = moe
    if n > 1:
        cfg["encoder_conf"]["hnet"] = {"compression_N": n}
        cfg["model_conf"]["hnet_ratio_beta"] = 0.03
    if specaug:
        cfg["specaug_conf"] = specaug
    return cfg


def _batches(seed: int = 0):
    """Two global batches of 3 real rows and a padding row (batch_multiple 4):
    rank 0 holds 2 real rows, rank 1 one and the pad, with other token
    counts, so per-rank means differ from the global ones."""
    rng = np.random.default_rng(seed)
    out = []
    for k, (lens, toks) in enumerate((([16000, 9100, 12000], [6, 3, 2]),
                                      ([12000, 16000, 7000], [2, 7, 3]))):
        items = [{"wave": (0.1 * rng.normal(size=n)).astype(np.float32), "n_samples": n,
                  "tokens": rng.integers(4, V, size=u).astype(np.int32),
                  "id": f"b{k}u{i}", "index": 4 * k + i}
                 for i, (n, u) in enumerate(zip(lens, toks))]
        out.append(dataset.collate_batch(items, pad_id=3, seed=7, epoch=0, batch_multiple=4))
    return out


DDP_CASES = {"N1": _config(1), "N2": _config(2)}
# two ranks against one process of the port: SpecAugment and AED dropout
# on; an MoE AED decoder whose capacity (0.5) drops tokens
SOLO_CASES = {"aug": _config(1, 0.1, SPECAUG),
              "moe": _config(1, moe={"n_experts": 2, "top_k": 1, "capacity_factor": 0.5})}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The trees, batches and decode job; the two ranks' results."""
    tmp = tmp_path_factory.mktemp("dist")
    job = {"ddp": {}, "decode": None}
    trees = {}
    for name, cfg in list(DDP_CASES.items()) + list(SOLO_CASES.items()):
        jm = jtask.build_model(cfg, V)
        trees[name] = seeded_tree(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=1)
        job["ddp"][name] = {"config": cfg, "vocab": V, "tree": jax.tree_util.tree_map(
            np.asarray, trees[name]), "batches": _batches(), "train_cfg": TRAIN_CFG,
            "solo": name in SOLO_CASES}
    dec_cfg = dict(copy.deepcopy(HYBRID_CONFIG), rnnt_conf={"d_pred": 8, "d_joint": 16,
                                                             "max_decode_len": 12})
    dec_cfg["model_conf"]["rnnt_weight"] = 0.5
    dec_cfg["aed_conf"]["max_decode_len"] = 6
    rng = np.random.default_rng(3)
    items = [{"wave": (0.1 * rng.normal(size=n)).astype(np.float32), "n_samples": n,
              "tokens": rng.integers(4, V, size=3).astype(np.int32), "id": f"d{i}", "index": i}
             for i, n in enumerate([8000, 12000, 5000, 9000, 11000])]
    job["decode"] = {"config": dec_cfg, "vocab": V, "items": items, "max_frames": 230,
                     "cfg": {"beam_size": 3},
                     "cells": [c for c in _cells() if c["name"] in
                               ("ctc_greedy", "ctc_beam", "aed_beam", "rnnt_greedy")]}
    return job, trees, run_pair("dist", job, tmp)


def _cells():
    from hnet_mamba_asr_torch.tasks.decode_task import expand_cells
    return expand_cells({"read_outs": ["ctc", "aed", "rnnt"], "search": ["greedy", "beam"],
                         "lm": "none"})


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _jax_update(name, cfg, tree, tmp):
    jm = jtask.build_model(cfg, V)
    batches = _batches()
    loader = type("L", (), {"set_epoch": lambda self, e: None, "__len__": lambda self: 2,
                            "__iter__": lambda self: iter([dict(b) for b in batches])})()
    jt = JTrainer(jm, loader, TRAIN_CFG, ckpt_dir=tmp / f"jax_{name}", mesh=jmake_mesh(2))
    jt.params = place_params(tree, jt.mesh)
    jt.opt_state = jt._normalize_placement(jt.tx.init(jt.params))
    jt.train()
    return jax.device_get(jt.params)


@pytest.mark.parametrize("name", list(DDP_CASES))
def test_ddp_update_matches_jax_two_devices(pair, name, tmp_path):
    """Two gloo ranks, each with its rows of two global batches, train to
    the parameters JAX's Trainer reaches on a 2-device mesh; the batch's
    real rows and tokens differ between the ranks, so a rank-local mean of
    any loss term (CTC rows, AED tokens, the ratio's F and G) would not."""
    job, trees, results = pair
    want = _jax_update(name, DDP_CASES[name], trees[name], tmp_path)
    for r in range(2):
        assert results[r]["ddp"][name]["ddp"]
        _assert_close(results[r]["ddp"][name]["tree"], want)


@pytest.mark.parametrize("name", list(DDP_CASES) + list(SOLO_CASES))
def test_ranks_stay_bitwise_equal_and_rank1_writes_nothing(pair, name):
    _, _, results = pair
    a, b = (_leaves(results[r]["ddp"][name]["tree"]) for r in range(2))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert results[0]["ddp"][name]["files"] == ["epoch0000.ckpt", "latest.ckpt"]
    assert results[1]["ddp"][name]["files"] is None
    assert results[0]["ddp"][name]["loss"] == results[1]["ddp"][name]["loss"]
    assert all(np.isfinite(results[0]["ddp"][name]["grad_norm"]))


@pytest.mark.parametrize("name", list(SOLO_CASES))
def test_two_ranks_train_what_one_process_trains(pair, name):
    """aug: SpecAugment (keyed by each row's item index) and AED dropout (the
    global batch's draw, each rank keeping its rows); moe: the experts'
    capacity and slot order of the global batch, with drops. Two ranks
    train to the one-process parameters."""
    _, _, results = pair
    _assert_close(results[0]["ddp"][name]["tree"], results[0]["solo"][name])


@pytest.mark.parametrize("cell", ["ctc_greedy", "ctc_beam", "aed_beam", "rnnt_greedy"])
def test_decode_over_ranks_equals_one_process(pair, cell):
    """5 utterances in batches padded to 2 rows (a partial last batch):
    rank 0 writes the one-process records, id, reference, hypothesis and
    score; rank 1 writes nothing."""
    _, _, results = pair
    solo = [json.loads(x) for x in results[0]["decode_solo"][cell].splitlines()]
    ranks = [json.loads(x) for x in results[0]["decode"][cell].splitlines()]
    assert results[1]["decode"][cell] is None
    assert sorted(r["id"] for r in ranks) == [f"d{i}" for i in range(5)]
    assert [(r["id"], r["ref"], r["hyp"]) for r in ranks] == \
        [(r["id"], r["ref"], r["hyp"]) for r in solo]
    for a, b in zip(ranks, solo):
        assert (a["score"] is None) == (b["score"] is None)
        if a["score"] is not None:
            assert a["score"] == pytest.approx(b["score"], rel=1e-5, abs=1e-5)


# ---- loaders -----------------------------------------------------------------
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    entries = build_tone_corpus(root, n_utts=16)
    JTokenizer.train([e["text"] for e in entries], root / "tok" / "bpe", vocab_size=12,
                     hard_vocab_limit=False)
    cfg = {"data": {"manifests_dir": str(root / "manifests"), "train_manifest": "train-960",
                    "dev_splits": ["dev-clean"]},
           "batch_bins": 1200, "frontend_conf": {"n_mels": 20}, "train": {"prefetch": 0}}
    return root, cfg, entries


def test_row_shard_loaders_match_jax(corpus, monkeypatch):
    """``build_dataloaders`` over two ranks: the same global batch sequence,
    equal padded shapes, disjoint row slices whose union is the corpus, each
    rank's rows equal to JAX's ``row_shard`` loader's; dev unsharded."""
    root, cfg, entries = corpus
    tok, jtok = Tokenizer(root / "tok" / "bpe.model"), JTokenizer(root / "tok" / "bpe.model")
    got, dev = [], []
    for rank in (0, 1):
        train, _, devs = build_dataloaders(cfg, root, tok, seed=0, row_split=(rank, 2))
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        jtrain, _, _ = jbuild.build_dataloaders(cfg, root, jtok, n_devices=2, seed=0)
        mine, theirs = list(train), list(jtrain)
        assert len(mine) == len(theirs) > 0
        for a, b in zip(mine, theirs):
            assert a.keys() == b.keys()
            for k in a:
                if k == "ids":
                    assert a[k] == b[k]
                else:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        got.append(mine)
        dev.append([tuple(b["ids"]) for b in devs["dev-clean"]])
    for a, b in zip(*got):
        assert a["wave"].shape == b["wave"].shape and not set(a["ids"]) & set(b["ids"])
    assert {i for r in got for b in r for i in b["ids"]} == {e["id"] for e in entries}
    assert dev[0] == dev[1] and {i for b in dev[0] for i in b} == {f"u{i}" for i in range(8)}


@pytest.mark.parametrize("rank", [0, 1])
def test_lm_row_shard_matches_jax(corpus, rank):
    """``make_lm_dataloader(row_shard=True)`` over 2 ranks: each rank's rows
    of every global batch equal JAX's ``LMDataLoader(row_shard=...)``'s."""
    root, _, _ = corpus
    rng = np.random.default_rng(5)
    lines = [" ".join(rng.choice(list("abcd"), size=int(rng.integers(1, 9))))
             for _ in range(37)]
    got, want = (
        list(mod.make_lm_dataloader(mod.LMTextDataset(tok(root / "tok" / "bpe.model"),
                                                      lines=lines), 40, shuffle=True, seed=1,
                                    num_replicas=2, rank=rank, batch_multiple=2,
                                    row_shard=True)[0])
        for mod, tok in ((lm_text, Tokenizer), (jlm_text, JTokenizer)))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert a["ids"] == b["ids"]
        for k in ("tokens", "token_lens", "row_mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("replicas", [2, 3, 4])
def test_sampler_shards_disjoint_equal_as_jax(replicas):
    lengths = np.random.default_rng(0).integers(50, 400, size=97).tolist()
    for rank in range(replicas):
        mine = dataset.BucketBatchSampler(lengths, 2000, replicas, rank, shuffle=True, seed=3)
        theirs = jdataset.BucketBatchSampler(lengths, 2000, replicas, rank, shuffle=True,
                                             seed=3)
        for epoch in (0, 1):
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert [list(b) for b in mine] == [list(b) for b in theirs]


def test_row_shard_refuses_unequal_slices(corpus):
    root, cfg, _ = corpus
    tok = Tokenizer(root / "tok" / "bpe.model")
    ds = dataset.ASRDataset(root / "manifests" / "train-960.jsonl", tok)
    sampler = dataset.BucketBatchSampler(ds.lengths, 1200)
    with pytest.raises(ValueError, match="divisible by process count"):
        dataset.DataLoader(ds, sampler, batch_multiple=3, row_shard=(0, 2))
    with pytest.raises(ValueError, match="not divisible by the 2 ranks"):
        pmesh.rank_rows({"row_mask": np.ones(3, bool)}, 0, 2)


# ---- launch ------------------------------------------------------------------
def test_init_distributed_without_a_launch_does_nothing(monkeypatch):
    for k in pmesh.ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert pmesh.init_distributed("cpu") is False
    assert pmesh.world() == (0, 1) and pmesh.make_mesh(1, "cpu") is None
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pmesh.make_mesh(2, "cpu")


def test_backend_rules(monkeypatch):
    assert pmesh.resolve_backend(None, "cpu") == "gloo"
    assert pmesh.resolve_backend(None, "cuda") == "nccl"
    assert pmesh.resolve_backend("gloo", "cuda") == "gloo"
    with pytest.raises(ValueError, match="NCCL backend needs CUDA"):
        pmesh.resolve_backend("nccl", "cpu")
    if torch.cuda.device_count() < 2:               # two NCCL ranks on one device
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "1")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("LOCAL_RANK", "0")
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="refuses two ranks on one device"):
            pmesh.init_distributed("cuda", "nccl")


def test_init_distributed_raises_on_a_bad_store():
    """Rank 1 of a launch whose store nobody serves: an error, never a quiet
    single-process run."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
               RANK="1", LOCAL_RANK="1", PYTHONPATH=str(REPO))
    code = ("from hnet_mamba_asr_torch.parallel.mesh import init_distributed\n"
            "init_distributed('cpu', timeout_s=1)\nprint('joined')")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and "joined" not in res.stdout
