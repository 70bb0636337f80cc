"""The port's decode slice against the JAX package on the CPU, fp32: the AED
head's KV-cached ``decode_step`` and ``greedy_decode``, the 7-cell matrix of
``tasks/decode_task.py`` on a tiny hybrid model trained for one step (JAX's
``decode_batch`` with ``device_beam: false``, and with it absent: the
device engines of both packages), a JAX pickle checkpoint loaded by the
port, ``expand_cells``, the engines and refusals, and the gate config's
decode literal. Weights are one seeded param tree carried across by
``convert.py``."""
import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from hnet_mamba_asr_torch import convert
from hnet_mamba_asr_torch.data.dataset import ItemLoader, collate_batch, manifest_items
from hnet_mamba_asr_torch.data.synthetic import build_tone_corpus
from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
from hnet_mamba_asr_torch.decoders.lm_scorer import CausalLMScorer
from hnet_mamba_asr_torch.eval.score import score_decode_dir
from hnet_mamba_asr_torch.models.aed import AEDHead, strip_hypothesis
from hnet_mamba_asr_torch.tasks import decode_task
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_torch.tasks.lm_task import build_lm
from hnet_mamba_asr_torch.tools.gate import GATE_DECODE
from hnet_mamba_asr_tpu.decoders import lm_scorer as jscorer
from hnet_mamba_asr_tpu.models import aed as jaed
from hnet_mamba_asr_tpu.tasks import asr_task as jtask
from hnet_mamba_asr_tpu.tasks import decode_task as jdecode
from hnet_mamba_asr_tpu.tasks import lm_task as jlm_task
from hnet_mamba_asr_tpu.training import checkpoint as jckpt

from torch_parity import HYBRID_CONFIG, module_tree, seeded_tree

TOL = 1e-5                      # AED log-probs, fp32 on both sides
REPO = Path(__file__).resolve().parents[1]
# every cell of the matrix, with the LM, at a small beam and a short cap
DECODE = {"read_outs": ["ctc", "aed", "joint"], "search": ["greedy", "beam"], "lm": "on",
          "beam_size": 3, "pre_beam": 5, "ctc_weight": 0.3, "lm_weight": 0.3,
          "rescore_weight": 0.6, "rescore_length_bonus": 2.0, "device_beam": False}
CELLS = ["ctc_greedy", "ctc_beam", "ctc_beam_lm", "aed_beam", "aed_beam_lm", "joint_beam",
         "joint_beam_lm"]


def test_aed_decode_step_and_greedy_match_jax():
    """decode_start / decode_step with parent gathers, and the KV-cached
    greedy decode, against the flax head: log-probs within 1e-5, ids equal."""
    rng = np.random.default_rng(0)
    V, d, cap = 14, 32, 6
    jhead = jaed.AEDHead(vocab_size=V, d_model=d, n_layers=2, n_heads=2, d_ff=48,
                         max_decode_len=cap)
    mem = rng.normal(size=(3, 10, d)).astype(np.float32)
    mlens = np.array([10, 6, 3], np.int32)
    params = module_tree(jhead, jnp.asarray(mem), jnp.asarray(mlens),
                         jnp.ones((3, 4), jnp.int32), seed=4)
    head = AEDHead(V, d, n_layers=2, n_heads=2, d_ff=48, max_decode_len=cap)
    head.load_state_dict(convert.jax_to_state_dict(params), strict=True)
    jp = {"params": params}
    jc, jkpm = jhead.apply(jp, jnp.asarray(mem), jnp.asarray(mlens), cap + 1,
                           method="decode_start")
    with torch.no_grad():
        tc, tkpm = head.decode_start(torch.from_numpy(mem), torch.from_numpy(mlens), cap + 1)
    steps = [(np.arange(3), np.full(3, 1)), (np.array([2, 0, 0]), np.array([5, 3, 7])),
             (np.array([1, 1, 2]), np.array([2, 9, 4])),
             (np.array([0, 2, 1]), np.array([8, 8, 6]))]
    for pos, (par, tok) in enumerate(steps):
        want, jc = jhead.apply(jp, jc, jkpm, jnp.asarray(par, jnp.int32),
                               jnp.asarray(tok, jnp.int32), pos, method="decode_step")
        with torch.no_grad():
            got, tc = head.decode_step(tc, tkpm, torch.from_numpy(par), torch.from_numpy(tok),
                                       pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL * np.abs(np.asarray(want)).max())
    want_ids = np.asarray(jhead.apply(jp, jnp.asarray(mem), jnp.asarray(mlens),
                                      method="greedy_decode"))
    got_ids = head.greedy_decode(torch.from_numpy(mem), torch.from_numpy(mlens)).numpy()
    np.testing.assert_array_equal(got_ids, want_ids)
    assert strip_hypothesis([5, 6, 2, 7, 2], 2) == [5, 6]


@pytest.fixture(scope="module")
def tone(tmp_path_factory):
    """A tone corpus of 5 utterances, its 12-piece tokenizer, a tiny hybrid
    model after one JAX training step (written by the JAX package's
    checkpoint module) and a tiny LM, in both packages."""
    root = tmp_path_factory.mktemp("tone")
    entries = build_tone_corpus(root, n_utts=5, dev_utts=2)
    tok = Tokenizer.train([e["text"] for e in entries], root / "tok" / "bpe", vocab_size=12,
                          hard_vocab_limit=False)
    V = tok.vocab_size
    cfg = copy.deepcopy(HYBRID_CONFIG)
    cfg["aed_conf"] = dict(cfg["aed_conf"], max_decode_len=6)
    jmodel = jtask.build_model(cfg, V)
    params = seeded_tree(jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)), seed=5)
    items = manifest_items(root / "manifests" / "test-clean.jsonl", tok)
    batch = collate_batch(items, pad_id=3, seed=0, epoch=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "ids"}
    grads = jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(p, b, 0, False)[0]))(params, jbatch)
    tx = optax.adamw(1e-2)
    opt_state = tx.init(params)
    updates, opt_state = tx.update(grads, opt_state, params)
    params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
    ckpt = root / "epoch0000.ckpt"
    jckpt.save_checkpoint(ckpt, {"params": params, "opt_state": jckpt.tree_to_path_dict(
        opt_state), "epoch": 0, "global_step": 1, "config": cfg, "seed": 0})
    lm_cfg = {"lm_conf": {"d_model": 16, "n_layers": 1, "n_heads": 2, "d_ff": 32}}
    jlm = jlm_task.build_lm(lm_cfg, V)
    lm_params = seeded_tree(jax.eval_shape(jlm.init_params, jax.random.PRNGKey(0)), seed=6)
    lm = build_lm(lm_cfg, V, device="cpu")
    convert.load_jax_params(lm, lm_params)
    return dict(root=root, tok=tok, cfg=cfg, jmodel=jmodel, params=params, items=items,
                batch=batch, ckpt=ckpt,
                jlm=jscorer.CausalLMScorer(jlm.lm, {"params": lm_params["lm"]}),
                lm=CausalLMScorer(lm.lm))


def _jax_hyps(tone, cell, batch=None):
    recs = jdecode.decode_batch(tone["jmodel"], tone["params"], tone["tok"],
                                batch or tone["batch"], cell, DECODE, lm=tone["jlm"])
    return {r["id"]: r["hyp"] for r in recs}


def test_seven_cells_match_jax(tone, tmp_path):
    """Every cell through decode_split_shared (one encoder pass per batch,
    two batches) gives JAX's decode_batch transcripts; the records state
    their engine and score through the port's gate; the checkpoint JAX
    wrote loads with pickle and numpy only."""
    params, meta = decode_task.load_model_params(tone["ckpt"])
    assert meta == {"epoch": 0, "global_step": 1}
    model = build_model(tone["cfg"], tone["tok"].vocab_size, device="cpu")
    convert.load_jax_params(model, params)
    cells = decode_task.expand_cells(DECODE)
    assert [c["name"] for c in cells] == CELLS
    decode_task.check_heads(model, cells)
    loader = ItemLoader(tone["items"], 600, shuffle=False)
    assert len(loader) == 2
    audio_s = decode_task.audio_seconds_from_manifest(
        tone["root"] / "manifests" / "test-clean.jsonl")
    summaries = decode_task.decode_split_shared(
        model, tone["tok"], loader, cells, DECODE, audio_seconds=audio_s,
        out_dir=tmp_path / "decode", split="test-clean", lm=tone["lm"])
    assert [s["n_utts"] for s in summaries] == [5] * 7
    assert [s["engine"] for s in summaries] == ["greedy"] + ["lockstep"] * 6
    for cell in cells:
        want = _jax_hyps(tone, cell)
        recs = [json.loads(line) for line in
                (tmp_path / "decode" / cell["name"] / "test-clean.jsonl").read_text().splitlines()]
        assert {r["id"]: r["hyp"] for r in recs} == want, cell["name"]
    one = decode_task.decode_split(model, tone["tok"], loader, cells[-1], DECODE,
                                   audio_seconds=audio_s, lm=tone["lm"],
                                   out_path=tmp_path / "alone" / "test-clean.jsonl")
    assert one["n_utts"] == 5 and one["engine"] == "lockstep"
    assert (tmp_path / "alone" / "test-clean.jsonl").read_text().count("\n") == 5
    scores = score_decode_dir(tmp_path / "decode", n_bootstrap=20,
                              goal_cfg={"sane_test_clean_wer_below": 12.0},
                              gate_cell="ctc_greedy")
    assert set(scores["splits"]["test-clean"]["cells"]) == set(CELLS)
    assert scores["gate"]["evaluated"] and scores["gate"]["cell"] == "ctc_greedy"


def test_default_engine_seven_cells_match_jax(tone):
    """With device_beam absent both packages run their device searches: the
    7 cells of the checkpoint JAX wrote give JAX's default decode_batch
    transcripts, the six beam cells on the port's device engine, and each
    utterance decoded alone gives its batched transcript."""
    params, _ = decode_task.load_model_params(tone["ckpt"])
    model = build_model(tone["cfg"], tone["tok"].vocab_size, device="cpu")
    convert.load_jax_params(model, params)
    dc = {k: v for k, v in DECODE.items() if k != "device_beam"}
    alone = collate_batch(tone["items"][2:3], pad_id=3, seed=0, epoch=0)
    for cell in decode_task.expand_cells(dc):
        recs = decode_task.decode_batch(model, tone["tok"], tone["batch"], cell, dc,
                                        lm=tone["lm"])
        want = jdecode.decode_batch(tone["jmodel"], tone["params"], tone["tok"],
                                    tone["batch"], cell, dc, lm=tone["jlm"])
        assert [r["hyp"] for r in recs] == [r["hyp"] for r in want], cell["name"]
        engine = "greedy" if cell["search"] == "greedy" else "device"
        assert {r["engine"] for r in recs} == {engine}, cell["name"]
        one = decode_task.decode_batch(model, tone["tok"], alone, cell, dc, lm=tone["lm"])
        assert one[0]["hyp"] == recs[2]["hyp"], cell["name"]


def test_serial_engine_and_one_utterance_alone(tone):
    """batch_beams false (one utterance at a time) gives the lockstep
    transcripts, and an utterance decoded alone gives its batched one."""
    model = build_model(tone["cfg"], tone["tok"].vocab_size, device="cpu")
    convert.load_jax_params(model, tone["params"])
    alone = collate_batch(tone["items"][1:2], pad_id=3, seed=0, epoch=0)
    for name in ("joint_beam_lm", "aed_beam", "ctc_beam_lm"):
        cell = next(c for c in decode_task.expand_cells(DECODE) if c["name"] == name)
        lock = decode_task.decode_batch(model, tone["tok"], tone["batch"], cell, DECODE,
                                        lm=tone["lm"])
        serial = decode_task.decode_batch(model, tone["tok"], tone["batch"], cell,
                                          dict(DECODE, batch_beams=False), lm=tone["lm"])
        one = decode_task.decode_batch(model, tone["tok"], alone, cell, DECODE, lm=tone["lm"])
        assert [r["hyp"] for r in serial] == [r["hyp"] for r in lock], name
        assert one[0]["hyp"] == lock[1]["hyp"] and one[0]["id"] == lock[1]["id"], name
        assert {r["engine"] for r in serial} == {"lockstep" if name.startswith("ctc")
                                                 else "serial"}


def test_model_greedy_decode_without_ctc_matches_jax(tone):
    """An AED-only model's greedy_decode (the trainer's inline dev WER) is
    the AED head's KV-cached greedy, cut at eos: JAX's ids."""
    cfg = copy.deepcopy(tone["cfg"])
    cfg["model_conf"] = dict(cfg["model_conf"], ctc_weight=0.0, aed_weight=1.0)
    V = tone["tok"].vocab_size
    jmodel = jtask.build_model(cfg, V)
    params = seeded_tree(jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)), seed=7)
    batch = {k: v for k, v in tone["batch"].items() if k != "ids"}
    want = jmodel.greedy_decode(params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = build_model(cfg, V, device="cpu")
    convert.load_jax_params(model, params)
    got = model.greedy_decode({k: torch.as_tensor(v) for k, v in batch.items()})
    assert got == [list(map(int, w)) for w in want]


def test_expand_cells_and_refusals():
    """expand_cells gives JAX's cells for several decode blocks; the beam
    cells' engine is the device search when device_beam is absent or true,
    as in JAX, and the host's with device_beam: false; the RNN-T cells raise
    NotImplementedError."""
    blocks = [{}, GATE_DECODE, {"read_outs": "aed", "search": "beam", "lm": "none"},
              {"read_outs": ["joint", "ctc"], "search": ["beam", "greedy"], "lm": True},
              {"read_outs": ["rnnt", "ctc"], "lm": "enabled"}]
    for dc in blocks:
        assert decode_task.expand_cells(dc) == jdecode.expand_cells(dc), dc
    for bad in ({"read_outs": ["aed"], "search": ["greedy"]}, {"read_outs": ["x"]}):
        with pytest.raises(ValueError):
            decode_task.expand_cells(bad)
    beam = {"read_out": "joint", "search": "beam", "lm": False, "name": "joint_beam"}
    assert decode_task.engine_for({"device_beam": True}, beam) == "device"
    assert decode_task.engine_for({}, beam) == "device"
    assert decode_task.engine_for({"device_beam": False}, beam) == "lockstep"
    assert decode_task.engine_for({"device_beam": False, "batch_beams": False},
                                  beam) == "serial"
    rnnt = {"read_out": "rnnt", "search": "greedy", "lm": False, "name": "rnnt_greedy"}
    with pytest.raises(NotImplementedError, match="RNN-T"):
        decode_task.engine_for({}, rnnt)


def test_decode_literal_matches_yaml():
    """tools/gate.py's GATE_DECODE is configs/typeA_small_N1.yaml's decode block."""
    cfg = yaml.safe_load((REPO / "configs" / "typeA_small_N1.yaml").read_text())
    assert GATE_DECODE == cfg["decode"]
    assert [c["name"] for c in decode_task.expand_cells(GATE_DECODE)] == CELLS
