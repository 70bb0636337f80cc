"""The PyTorch port never imports JAX: its serving and training slices and
chip_smoke.py run in a fresh interpreter with jax and flax absent from
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
print(json.dumps({"enc_frames": res["enc_frames"], "steps": trainer.global_step,
                  "jax_modules": sorted(m for m in sys.modules
                                        if m.split(".")[0] in ("jax", "jaxlib", "flax"))}))
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax_modules"] == []
    assert out["enc_frames"] == 8            # 6000 samples: 36 mel frames
    assert out["steps"] == 1
