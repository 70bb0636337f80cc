"""The configs the training CLIs take, read by the port's YAML reader and
built by the port on the meta device: each parameter count equals the JAX
model's (``jax.eval_shape`` of its init) at vocabulary 500 (750 for the LM
of that vocabulary); ``typeA_large_N1.yaml`` keeps remat ``dots``, and
``typeA_small_N1_ctc.yaml`` builds no AED head."""
import numpy as np
import pytest
import torch

import jax

from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_torch.tasks.lm_task import build_lm
from hnet_mamba_asr_torch.utils.config import load_config
from hnet_mamba_asr_tpu.tasks import asr_task as jtask
from hnet_mamba_asr_tpu.tasks import lm_task as jlm_task


def _jax_count(model) -> int:
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    return sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("name,vocab", [("typeA_large_N1", 500), ("typeA_small_N1_ctc", 500)])
def test_asr_config_counts_equal_jax(name, vocab):
    cfg = load_config(f"configs/{name}.yaml")
    with torch.device("meta"):
        model = build_model(cfg, vocab, device="meta")
    got = sum(p.numel() for p in model.parameters())
    assert got == _jax_count(jtask.build_model(cfg, vocab))
    if name == "typeA_large_N1":
        assert got == 210_967_945
        assert cfg["encoder_conf"]["remat_policy"] == "dots"
        assert {b.remat_policy for b in (model.encoder.enc, model.encoder.main,
                                         model.encoder.dec)} == {"dots"}
    else:
        assert model.aed is None and model.ctc is not None
        assert "ssd_intra_dtype" not in cfg["encoder_conf"]


def test_lm_750_count_equals_jax():
    cfg = load_config("configs/lm_transformer_750.yaml")
    with torch.device("meta"):
        lm = build_lm(cfg, 750, device="meta")
    assert sum(p.numel() for p in lm.parameters()) == _jax_count(jlm_task.build_lm(cfg, 750))
