"""The port's efficiency report (hnet_mamba_asr_torch/eval/efficiency.py and
its CLI) against the JAX package's: the whole report for the two small
configs at vocab 500, and the encoder closed forms against the port's
instantiated modules over JAX's matrix (tests/test_efficiency.py: A N1,
A N2 dynamic, A N2 fixed, B N4)."""
from pathlib import Path

import numpy as np
import pytest

from hnet_mamba_asr_torch.eval import efficiency as teff
from hnet_mamba_asr_torch.models.encoder import ConvSubsampling4, DCASREncoder
from hnet_mamba_asr_torch.models.mamba2 import Mamba2
from hnet_mamba_asr_torch.models.mamba_block import MambaStack
from hnet_mamba_asr_torch.scripts import efficiency as tcli
from hnet_mamba_asr_torch.utils.config import load_config
from hnet_mamba_asr_tpu.eval import efficiency as jeff
from hnet_mamba_asr_tpu.utils.config import load_config as jload_config

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["typeA_small_N1", "typeA_small_N2"])
def test_report_matches_jax(name, capsys):
    """The report through the CLI, the vocabulary taken from the tokenizer's
    name (the file is not in the repository), against JAX's report at vocab
    500; the printed table; the FLOPs at another kept fraction."""
    path = REPO / "configs" / f"{name}.yaml"
    cfg, jcfg = load_config(path), jload_config(str(path), [])
    want = jeff.efficiency_report(jcfg, 500, audio_seconds=7.5)
    got = tcli.run(tcli.parse_args(["--config", str(path), "--audio-seconds", "7.5"]))
    out = capsys.readouterr()
    np.testing.assert_equal(got, want)
    assert out.out.strip() == jeff.format_efficiency(want)
    assert "from its name" in out.err
    np.testing.assert_equal(teff.encoder_flops(cfg["encoder_conf"], 750, kept_fractions=[0.3]),
                            jeff.encoder_flops(jcfg["encoder_conf"], 750, kept_fractions=[0.3]))


def test_rnnt_and_type_b_reports_match_jax():
    base = {"encoder_conf": {"arch_type": "B", "d_outer": 16, "d_main": 24, "n_enc": 1,
                             "n_main": 2, "n_dec": 1, "n_mid": 1, "d_state": 8, "headdim": 8,
                             "hnet": {"compression_N": 4}},
            "frontend_conf": {"n_mels": 20},
            "model_conf": {"ctc_weight": 0.5, "rnnt_weight": 1.0, "aed_weight": 0.5},
            "aed_conf": {"n_layers": 1, "n_heads": 2, "d_ff": 32},
            "rnnt_conf": {"d_pred": 8, "d_joint": 16, "context": 3}}
    np.testing.assert_equal(teff.efficiency_report(base, 30, audio_seconds=3.0),
                            jeff.efficiency_report(base, 30, audio_seconds=3.0))
    with pytest.raises(ValueError, match="kept fraction"):
        teff.efficiency_report(base, 30, kept_fractions=[0.5])


DIMS = dict(d_state=8, headdim=8)


@pytest.mark.parametrize("arch,N,chunker", [("A", 1, "dynamic"), ("A", 2, "dynamic"),
                                            ("A", 2, "fixed"), ("B", 4, "dynamic")])
def test_encoder_closed_forms_count_the_port_encoder(arch, N, chunker):
    enc_conf = {"arch_type": arch, "d_outer": 16, "d_main": 24, "n_enc": 1, "n_main": 2,
                "n_dec": 1, "n_mid": 1, "bidirectional": True, **DIMS,
                "hnet": {"compression_N": N, "chunker": chunker}}
    enc = DCASREncoder(n_mels=20, d_outer=16, d_main=24, n_enc=1, n_main=2, n_dec=1,
                       n_mid=1, arch_type=arch, N=N, chunker=chunker, chunk_size=16, **DIMS)
    stack = lambda n, d: teff.mamba_stack_params(n, d, True, **DIMS)      # noqa: E731
    br = {"subsample": teff.conv_subsample_params(20, 16), "enc_stack": stack(1, 16),
          "dec_stack": stack(1, 16), "projections": (16 * 24 + 24) + (24 * 16 + 16),
          "main_stack": stack(2, 24)}
    if arch == "A":
        br["chunker"] = teff.chunker_params(chunker, 16, N)
    else:
        br["chunker"] = (teff.chunker_params(chunker, 16, N ** 0.5)
                         + teff.chunker_params(chunker, 24, N ** 0.5))
        br.update(mid_stack=stack(1, 24), mid_dec_stack=stack(1, 24))
    assert teff.count_params(enc) == sum(br.values())
    assert set(teff.encoder_params(enc_conf, n_mels=20)["breakdown"]) == set(br)
    np.testing.assert_equal(teff.encoder_params(enc_conf, n_mels=20),
                            jeff.encoder_params(enc_conf, n_mels=20))
    np.testing.assert_equal(teff.encoder_flops(enc_conf, 777, n_mels=20),
                            jeff.encoder_flops(enc_conf, 777, n_mels=20))


@pytest.mark.parametrize("bidir", [True, False])
def test_block_closed_forms_count_the_port_modules(bidir):
    for d_model, d_state, headdim in [(16, 8, 8), (32, 16, 8), (64, 128, 64)]:
        assert teff.count_params(Mamba2(d_model, d_state=d_state, headdim=headdim)) == \
            teff.mamba2_params(d_model, d_state=d_state, headdim=headdim)
    assert teff.count_params(MambaStack(2, 16, bidirectional=bidir, **DIMS)) == \
        teff.mamba_stack_params(2, 16, bidir, **DIMS)
    assert teff.count_params(ConvSubsampling4(20, 16)) == teff.conv_subsample_params(20, 16)
