"""The PyTorch port never imports JAX or the JAX package: its serving and
training slices (N = 1 and the H-Net models: Type A N = 2 with the EMA
dechunk, Type B, the fixed-pool chunker), every module of the decode slice
with a tiny decode of all 10 cells (the beams on the device searches) by a
model with the RNN-T head and an MoE AED decoder and an MoE LM, the
aed_ids, beam_ids, rnnt_ids and rnnt_beam_ids serving modes, a streaming
session pool at N = 2, and chip_smoke.py run in a fresh interpreter with jax, flax and
hnet_mamba_asr_tpu absent from sys.modules; the deployment slice (the YAML
reader, FLAC, the artifacts and every CLI of hnet_mamba_asr_torch.scripts) and the
training slice (the host audio library's binding, manifests, the speed-perturbed
loader, the LM corpus reader, the optimizer registry, checkpoints, the async
writer, the trainer, the metrics sink) with PyYAML blocked as well, as the card's
machine has none; the interpretability slice (interp/, eval/efficiency.py, the
run_interp / efficiency / run_mfa CLIs, tools/interp_e2e.py) with jax, flax,
hnet_mamba_asr_tpu, PyYAML and scikit-learn blocked; the multi-rank planes
(parallel/, tools/smoke_2proc.py's two processes) with jax, flax, the JAX
package and PyYAML blocked."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

SCRIPT = """
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
import chip_smoke
import hnet_mamba_asr_torch.tools.measure
import hnet_mamba_asr_torch.ops.cuda_build, hnet_mamba_asr_torch.ops.ema_cuda
import hnet_mamba_asr_torch.ops.rnnt_cuda, hnet_mamba_asr_torch.models.moe
import hnet_mamba_asr_torch.decoders.rnnt_decode, hnet_mamba_asr_torch.decoders.device_rnnt_beam
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
moe = {"n_experts": 2, "top_k": 1}
rcfg = dict(cfg, model_conf=dict(cfg["model_conf"], rnnt_weight=1.0),
            rnnt_conf={"d_pred": 8, "d_joint": 16, "max_decode_len": 6},
            aed_conf=dict(cfg["aed_conf"], max_decode_len=3, moe=moe))
with tempfile.TemporaryDirectory() as tmp:
    tok = Tokenizer.train(["a b c", "b c d a"], tmp + "/bpe", vocab_size=12,
                          hard_vocab_limit=False)
    dmodel = build_model(rcfg, tok.vocab_size, device="cpu")
    lm = build_lm(decode_task.dropless({"lm_conf": {"d_model": 16, "n_layers": 1,
                                                    "n_heads": 2, "d_ff": 32, "moe": moe}}),
                  tok.vocab_size, device="cpu")
    dbatch = collate_batch([dict(it, tokens=np.array(tok.encode("a b"), np.int32))
                            for it in items], pad_id=3, seed=0, epoch=0)
    dc = {"read_outs": ["ctc", "aed", "joint", "rnnt"], "search": ["greedy", "beam"],
          "lm": "on", "beam_size": 2, "pre_beam": 3}
    cells = {c["name"]: len(decode_task.decode_batch(dmodel, tok, dbatch, c, dc,
                                                     lm=CausalLMScorer(lm.lm)))
             for c in decode_task.expand_cells(dc)}
    smodel = ServingModel(rcfg, None, "cpu", vocab_size=30,
                          emit=("aed_ids", "beam_ids", "rnnt_ids", "rnnt_beam_ids"))
    served = smodel(np.stack([it["wave"] for it in items]), np.array([6000, 6000]))
from hnet_mamba_asr_torch.serving.runtime import StreamingSessionPool
from hnet_mamba_asr_torch.serving.server import make_streaming_server
scfg = dict(cfg, model_conf={"ctc_weight": 1.0, "aed_weight": 0.0},
            encoder_conf=dict(cfg["encoder_conf"], bidirectional=False,
                              hnet={"compression_N": 2}))
pool = StreamingSessionPool(scfg, None, "cpu", block_enc=4, batch=2, vocab_size=30)
sid = pool.open()
streamed = pool.feed(sid, items[0]["wave"]) + pool.finish(sid)
print(json.dumps({"stream_ticks": pool.n_ticks, "enc_frames": res["enc_frames"], "steps": trainer.global_step,
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
    assert out["stream_ticks"] == 2          # 8 encoder frames in blocks of 4
    assert out["enc_frames"] == 8            # 6000 samples: 36 mel frames
    assert out["steps"] == 1
    assert len(out["kept"]) == 3 and all(0 < k <= 1 for k in out["kept"])
    assert out["cells"] == {c: 2 for c in ("ctc_greedy", "ctc_beam", "ctc_beam_lm", "aed_beam",
                                           "aed_beam_lm", "joint_beam", "joint_beam_lm",
                                           "rnnt_greedy", "rnnt_beam", "rnnt_beam_lm")}
    assert out["engines"] == ["device", "greedy"]
    assert out["served"] == {"enc_lengths": [2], "aed_ids": [2, 3], "beam_ids": [2, 8],
                             "beam_lens": [2], "rnnt_ids": [2, 6], "rnnt_lens": [2],
                             "rnnt_beam_ids": [2, 6], "rnnt_beam_lens": [2]}


NO_YAML_SCRIPT = """
import importlib, json, pkgutil, sys, tempfile
sys.modules["yaml"] = None              # the card's machine has no PyYAML
import numpy as np, torch
torch.set_num_threads(1)
import chip_smoke
import hnet_mamba_asr_torch.scripts as scripts
names = ["hnet_mamba_asr_torch.utils.config", "hnet_mamba_asr_torch.utils.logging_utils",
         "hnet_mamba_asr_torch.utils.provenance", "hnet_mamba_asr_torch.tasks.build",
         "hnet_mamba_asr_torch.data.flac", "hnet_mamba_asr_torch.data.audio",
         "hnet_mamba_asr_torch.serving.quant", "hnet_mamba_asr_torch.serving.export",
         "hnet_mamba_asr_torch.serving.runtime", "hnet_mamba_asr_torch.serving.server",
         "hnet_mamba_asr_torch.data.host_audio", "hnet_mamba_asr_torch.data.manifests",
         "hnet_mamba_asr_torch.data.dataset", "hnet_mamba_asr_torch.data.lm_text",
         "hnet_mamba_asr_torch.tasks.lm_task", "hnet_mamba_asr_torch.training.optim",
         "hnet_mamba_asr_torch.training.checkpoint", "hnet_mamba_asr_torch.training.async_ckpt",
         "hnet_mamba_asr_torch.training.trainer", "hnet_mamba_asr_torch.utils.metrics_logger"]
names += [f"hnet_mamba_asr_torch.scripts.{m.name}" for m in pkgutil.iter_modules(scripts.__path__)]
for name in names:
    importlib.import_module(name)
from hnet_mamba_asr_torch.utils.config import load_config
from hnet_mamba_asr_torch.serving.export import save_serving_artifact
from hnet_mamba_asr_torch.serving.runtime import load_serving_artifact
from hnet_mamba_asr_torch.tasks.asr_task import build_model
cfg = load_config("configs/typeA_small_N1.yaml", ["encoder_conf.d_outer=16", "encoder_conf.d_main=24",
    "encoder_conf.n_enc=1", "encoder_conf.n_main=1", "encoder_conf.n_dec=1",
    "encoder_conf.d_state=8", "encoder_conf.headdim=8", "frontend_conf.n_mels=20",
    "frontend_conf.cmvn=null", "model_conf.aed_weight=0", "train.precision=fp32"])
with tempfile.TemporaryDirectory() as tmp:
    save_serving_artifact(tmp, build_model(cfg, 12, device="cpu"), buckets=[(1, 8000)],
                          quantize="int8", quantize_min_size=64, config=cfg)
    out = load_serving_artifact(tmp, "cpu")(np.zeros((1, 6000), np.float32), [6000])
print(json.dumps({"modules": len(names), "enc_lengths": out["enc_lengths"].tolist(),
                  "absent": sorted(m for m in sys.modules if m.split(".")[0] in
                                   ("jax", "jaxlib", "flax", "hnet_mamba_asr_tpu")
                                   or (m == "yaml" and sys.modules[m] is not None))}))
"""


def test_deployment_slice_runs_without_jax_or_pyyaml():
    proc = subprocess.run([sys.executable, "-c", NO_YAML_SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["absent"] == []
    assert out["modules"] == 33                       # 20 modules and the 13 CLIs
    assert out["enc_lengths"] == [8]                  # 6000 samples: 36 mel frames


INTERP_SCRIPT = """
import contextlib, io, json, sys
for name in ("jax", "jaxlib", "flax", "optax", "hnet_mamba_asr_tpu", "yaml", "sklearn"):
    sys.modules[name] = None            # none of them on the card's machine
import numpy as np, torch
torch.set_num_threads(1)
import hnet_mamba_asr_torch.interp.alignments, hnet_mamba_asr_torch.interp.driver
import hnet_mamba_asr_torch.tools.interp_e2e
from hnet_mamba_asr_torch.interp.probes import train_probe
from hnet_mamba_asr_torch.scripts import efficiency, run_interp, run_mfa
helps = []
for mod in (run_interp, run_mfa, efficiency):
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            mod.parse_args(["--help"])
        except SystemExit as e:
            helps.append(e.code)
with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
    report = efficiency.run(efficiency.parse_args(["--config", "configs/typeA_small_N2.yaml"]))
rng = np.random.default_rng(0)
X = rng.normal(size=(60, 4)) + np.repeat(np.eye(4)[:3] * 3, 20, axis=0)
y = ["a"] * 20 + ["b"] * 20 + ["c"] * 20
errors = {}
for backend, device in (("sklearn", "cpu"), ("torch", "cuda")):
    try:
        train_probe(list(X), y, list(X), y, backend=backend, device=device)
    except RuntimeError as e:
        errors[backend] = str(e)
try:
    run_interp.run(run_interp.parse_args(["--config", "x", "--checkpoint", "y"]))
except RuntimeError as e:
    errors["run_interp"] = str(e)
fit = train_probe(list(X), y, list(X), y, backend="jax", device="cpu")
print(json.dumps({"helps": helps, "params": report["params"]["total"], "errors": errors,
                  "fit": [fit["backend"], fit["accuracy"]],
                  "loaded": sorted(m for m in sys.modules if sys.modules[m] is not None and
                                   m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                       "hnet_mamba_asr_tpu", "yaml",
                                                       "sklearn"))}))
"""


def test_interp_slice_runs_without_jax_pyyaml_or_sklearn():
    proc = subprocess.run([sys.executable, "-c", INTERP_SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["helps"] == [0, 0, 0]
    assert out["params"] == 79_153_321                 # configs/typeA_small_N2.yaml at 500
    assert "'sklearn'" in out["errors"]["sklearn"]
    assert "no CUDA device" in out["errors"]["torch"]  # the card by default, no fall-back
    assert "no CUDA device" in out["errors"]["run_interp"]
    assert out["fit"] == ["torch", 1.0]


RANKS_SCRIPT = """
import json, sys, tempfile
for name in ("jax", "jaxlib", "flax", "optax", "hnet_mamba_asr_tpu", "yaml"):
    sys.modules[name] = None            # none of them on the card's machine
import torch
torch.set_num_threads(1)
import hnet_mamba_asr_torch.parallel.collectives, hnet_mamba_asr_torch.parallel.mesh
import hnet_mamba_asr_torch.parallel.seq_parallel, hnet_mamba_asr_torch.parallel.pipeline
import hnet_mamba_asr_torch.scripts.train, hnet_mamba_asr_torch.scripts.train_lm
import hnet_mamba_asr_torch.scripts.decode
from hnet_mamba_asr_torch.tools import smoke_2proc
with tempfile.TemporaryDirectory() as tmp:
    code = smoke_2proc.main(["--device", "cpu", "--root", tmp, "--timeout", "240"]
                            + sys.argv[1:])
print(json.dumps({"code": code,
                  "absent": sorted(m for m in sys.modules if m.split(".")[0] in
                                   ("jax", "jaxlib", "flax", "hnet_mamba_asr_tpu", "yaml")
                                   and sys.modules[m] is not None)}))
"""


@pytest.mark.parametrize("plane", [[], ["--fsdp"], ["--sp"], ["--pp"], ["--tp"], ["--ep"]],
                         ids=["ddp", "fsdp", "sp", "pp", "tp", "ep"])
def test_multi_rank_planes_run_without_jax(plane):
    """parallel/ and tools/smoke_2proc.py with jax, flax, the JAX package and
    PyYAML blocked; the smoke's two processes (gloo, one thread each) train
    through the train CLI (DDP, ``train.fsdp=true``, ``train.sp=2``,
    ``train.pp=2``, ``train.tp=2`` or ``train.ep=2``), resume, and decode over both ranks
    (``decode.tp=2`` under tp) and alone, and pass its checks (disjoint
    equal row slices covering the corpus, or equal ones under sp, tp, ep;
    ranks bitwise equal, one provenance record per run, the resume marker,
    equal transcripts)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", RANKS_SCRIPT, *plane], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"code": 0, "absent": []}
    assert "ALL CHECKS PASSED" in proc.stdout
