"""The PyTorch port never imports JAX or the JAX package: its serving and
training slices (N = 1 and the H-Net models: Type A N = 2 with the EMA
dechunk, Type B, the fixed-pool chunker), every module of the decode slice
with a tiny decode of all 7 cells (the beams on the device searches), the
aed_ids and beam_ids serving modes, and chip_smoke.py run in a fresh
interpreter with jax, flax and hnet_mamba_asr_tpu absent from
sys.modules."""
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
import chip_smoke
import hnet_mamba_asr_torch.tools.measure
import hnet_mamba_asr_torch.ops.cuda_build, hnet_mamba_asr_torch.ops.ema_cuda
from hnet_mamba_asr_torch.models.fixed_pool import FixedPoolChunker
from hnet_mamba_asr_torch.models.hnet_chunk import DynamicChunker
from hnet_mamba_asr_torch.serving.runtime import ServingModel
from hnet_mamba_asr_torch.serving.server import MicroBatcher
cfg = {"encoder_conf": {"arch_type": "A", "d_outer": 32, "d_main": 48, "n_enc": 1,
                        "n_main": 2, "n_dec": 1, "d_state": 16, "headdim": 16},
       "train": {"precision": "fp32"}}
model = ServingModel(cfg, None, "cpu", vocab_size=30)
batcher = MicroBatcher(model, max_wait_ms=1.0)
try:
    res = batcher.submit(0.1 * np.random.default_rng(0).normal(size=6000)).result(timeout=60)
finally:
    batcher.close()
import tempfile
from hnet_mamba_asr_torch.data.dataset import ItemLoader
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_torch.training.trainer import Trainer
rng = np.random.default_rng(1)
items = [{"wave": 0.1 * rng.normal(size=6000).astype(np.float32), "n_samples": 6000,
          "tokens": np.array([5, 6, 7], np.int32), "id": str(i), "index": i} for i in range(2)]
cfg = dict(cfg, model_conf={"ctc_weight": 0.3, "aed_weight": 0.7},
           aed_conf={"n_layers": 1, "n_heads": 2, "d_ff": 32},
           specaug_conf={"num_time_mask": 2, "time_mask_width_ratio_range": [0, 0.1]})
with tempfile.TemporaryDirectory() as tmp:
    trainer = Trainer(build_model(cfg, 30, device="cpu"), ItemLoader(items, 100),
                      {"max_epoch": 1, "max_steps": 1}, ckpt_dir=tmp, device="cpu")
    trainer.train()
    kept = []
    for change in ({"hnet": {"compression_N": 2}},
                   {"arch_type": "B", "n_mid": 1, "hnet": {"compression_N": 4}},
                   {"hnet": {"compression_N": 2, "chunker": "fixed"}}):
        hcfg = dict(cfg, encoder_conf=dict(cfg["encoder_conf"], **change))
        htrainer = Trainer(build_model(hcfg, 30, device="cpu"), ItemLoader(items, 100),
                           {"max_epoch": 1, "max_steps": 1,
                            "optim_conf": {"router_lr_mult": 0.5, "router_eps": 1e-5}},
                           ckpt_dir=tmp + "/h", device="cpu")
        htrainer.train()
        kept.append(htrainer.history[-1]["kept_fraction"])
import hnet_mamba_asr_torch.data.audio, hnet_mamba_asr_torch.data.synthetic
import hnet_mamba_asr_torch.decoders.ctc_decode, hnet_mamba_asr_torch.decoders.joint
import hnet_mamba_asr_torch.eval.metrics, hnet_mamba_asr_torch.eval.score
import hnet_mamba_asr_torch.models.lm
from hnet_mamba_asr_torch.data.dataset import collate_batch
from hnet_mamba_asr_torch.data.features import compute_cmvn
from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
from hnet_mamba_asr_torch.decoders.lm_scorer import CausalLMScorer
from hnet_mamba_asr_torch.tasks import decode_task
from hnet_mamba_asr_torch.tasks.lm_task import build_lm
with tempfile.TemporaryDirectory() as tmp:
    tok = Tokenizer.train(["a b c", "b c d a"], tmp + "/bpe", vocab_size=12,
                          hard_vocab_limit=False)
    dmodel = build_model(dict(cfg, aed_conf=dict(cfg["aed_conf"], max_decode_len=3)),
                         tok.vocab_size, device="cpu")
    lm = build_lm({"lm_conf": {"d_model": 16, "n_layers": 1, "n_heads": 2, "d_ff": 32}},
                  tok.vocab_size, device="cpu")
    dbatch = collate_batch([dict(it, tokens=np.array(tok.encode("a b"), np.int32))
                            for it in items], pad_id=3, seed=0, epoch=0)
    dc = {"read_outs": ["ctc", "aed", "joint"], "search": ["greedy", "beam"], "lm": "on",
          "beam_size": 2, "pre_beam": 3}
    cells = {c["name"]: len(decode_task.decode_batch(dmodel, tok, dbatch, c, dc,
                                                     lm=CausalLMScorer(lm.lm)))
             for c in decode_task.expand_cells(dc)}
    smodel = ServingModel(dict(cfg, aed_conf=dict(cfg["aed_conf"], max_decode_len=3)), None,
                          "cpu", vocab_size=30, emit=("aed_ids", "beam_ids"))
    served = smodel(np.stack([it["wave"] for it in items]), np.array([6000, 6000]))
print(json.dumps({"enc_frames": res["enc_frames"], "steps": trainer.global_step,
                  "kept": kept, "cells": cells,
                  "engines": sorted({r["engine"] for c in decode_task.expand_cells(dc)
                                     for r in decode_task.decode_batch(
                                         dmodel, tok, dbatch, c, dc,
                                         lm=CausalLMScorer(lm.lm))}),
                  "served": {k: list(v.shape) for k, v in served.items()},
                  "jax_modules": sorted(m for m in sys.modules if m.split(".")[0] in
                                        ("jax", "jaxlib", "flax", "hnet_mamba_asr_tpu"))}))
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax_modules"] == []
    assert out["enc_frames"] == 8            # 6000 samples: 36 mel frames
    assert out["steps"] == 1
    assert len(out["kept"]) == 3 and all(0 < k <= 1 for k in out["kept"])
    assert out["cells"] == {c: 2 for c in ("ctc_greedy", "ctc_beam", "ctc_beam_lm", "aed_beam",
                                           "aed_beam_lm", "joint_beam", "joint_beam_lm")}
    assert out["engines"] == ["device", "greedy"]
    assert out["served"] == {"enc_lengths": [2], "aed_ids": [2, 3], "beam_ids": [2, 8],
                             "beam_lens": [2]}
