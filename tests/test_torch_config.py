"""The port's config reader (hnet_mamba_asr_torch/utils/config.py) against
PyYAML and the JAX package's utils/config.py: its own YAML reader gives what
yaml.safe_load gives on every configs/*.yaml and on the end-to-end test's
template, types included; overrides, flatten_config and the fingerprint
equal JAX's, error cases too; constructs outside the subset raise with
their line number."""
import math
from pathlib import Path

import pytest
import yaml

from hnet_mamba_asr_torch.utils import config as tcfg
from hnet_mamba_asr_tpu.utils import config as jcfg

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


def same(a, b) -> bool:
    """Equal values of the same types, in the same key order (1 == 1.0 ==
    True would pass a plain ==)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_all_six_configs_are_in_the_comparison():
    assert [p.name for p in CONFIGS] == [
        "lm_transformer_500.yaml", "lm_transformer_750.yaml", "typeA_large_N1.yaml",
        "typeA_small_N1.yaml", "typeA_small_N1_ctc.yaml", "typeA_small_N2.yaml"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_reader_equals_pyyaml_on_configs(path):
    text = path.read_text()
    assert same(tcfg.loads(text), yaml.safe_load(text))
    assert same(tcfg.load_config(path, ["train.max_epoch=3", "optim_conf.lr=1e-3"]),
                jcfg.load_config(path, ["train.max_epoch=3", "optim_conf.lr=1e-3"]))


def test_reader_equals_pyyaml_on_e2e_template(tmp_path):
    import test_scripts_e2e
    text = test_scripts_e2e._write_cfg(tmp_path).read_text()
    got = tcfg.loads(text)
    assert same(got, yaml.safe_load(text))
    assert isinstance(got["frontend_conf"], dict) and len(got["frontend_conf"]) == 5


SCALARS = ["1.0e-3", "1e-3", "1e3", "1.0E-3", "1.0e+3", "0x1F", "+0x1f", "017", "08", "0o17",
           "0b101", "1_000", "-1_0", "1:30", "1:30.5", ".inf", "-.inf", ".nan", "1.", ".5",
           "+.5", "1.5_0", "+1", "-0", "00", "yes", "No", "on", "OFF", "y", "n", "true_ish",
           "~", "null", "Null", "", "'q'", "'it''s'", '"a\\tb\\u00e9"', "a b",
           "foo # bar", "foo#bar", "a:b", "http://x.y/z"]
DOCS = ["a: b", "[a, b,]", "{a, b: c}", "[1e-3, 1.0e-3]", "[a:b]", "{a: [1, 2], b: {c: d}}",
        "- a", "[]", "{}", "[[1, 2], [3]]", "{a: }", "- [a, b]\n- {c: 1}\n-\n  - x",
        "a:\n- 1\n- 2\nb: 3", "- a: 1\n  b: 2\n- c", "k: 'x # y' # c",
        "x: [a,\n   b]  # c\ny: {p: 1,\n    q: [2, 3]}", "---\na: 1", "a:\n  b:\n    c: 1\n  d: 2",
        "1: one\nyes: 2\nnull: 3", "a: 1\na: 2", "key:\n  value"]


@pytest.mark.parametrize("text", SCALARS + DOCS)
def test_reader_equals_pyyaml_on_constructs(text):
    assert same(tcfg.loads(text), yaml.safe_load(text)), text


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &x 1", 2), ("a: *x", 1), ("a: !!str 1", 1), ("a: 1\nb: |\n  x", 2),
    ("a: >\n  x", 1), ("? a\n: b", 1), ("a: b\n  c", 2), ("a:\n\tb: 1", 2),
    ("a: 2001-12-14T10:00:00", 1), ("a: 1\nb: 2001-12-14", 2), ("a: [1,\n\n 2]", 2), ("a: 'x\n y'", 1), ("<<: 1", 1),
    ("a: b: c", 1), ("a:\n  b: 1\n c: 2", 3), ("a: [1, 2", 1), ("a: 1\n---\nb: 2", 2),
    ("- a\nb: 1", 2), ("a: {b: 1}}", 1)])
def test_outside_the_subset_raises_with_line(text, line):
    with pytest.raises(tcfg.YAMLSubsetError, match=rf"line {line}\b"):
        tcfg.loads(text)


def test_load_yaml_names_the_file(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("a: 1\nb: &anchor 2\n")
    with pytest.raises(tcfg.YAMLSubsetError, match=r"bad\.yaml: line 2"):
        tcfg.load_yaml(p)
    (tmp_path / "empty.yaml").write_text("# nothing\n")
    assert tcfg.load_yaml(tmp_path / "empty.yaml") == jcfg.load_yaml(tmp_path / "empty.yaml") == {}


OVERRIDES = ["1", "1.5", "1e-3", "-2", "true", "null", "[0.9, 0.98]", "hello", "hello world",
             "{a: 1}", "[1e-3]", "yes", "~", "", "'x'", "{a: 1", "0x10", "inf", "a: b"]


@pytest.mark.parametrize("text", OVERRIDES)
def test_parse_value_equals_jax(text):
    assert same(tcfg.parse_value(text), jcfg.parse_value(text))


def test_overrides_and_merge_equal_jax():
    cfg = {"train": {"max_epoch": 10}, "optim": "adamw"}
    ov = ["train.max_epoch=20", "optim_conf.lr=1e-3", "optim=sgd", "a.b.c=[1, 2]",
          "train=null", "train.max_epoch=5"]
    assert same(tcfg.apply_overrides(cfg, ov), jcfg.apply_overrides(cfg, ov))
    assert cfg == {"train": {"max_epoch": 10}, "optim": "adamw"}
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError, match="key=value"):
            mod.apply_overrides({}, ["no_equals_sign"])
    a, b = {"x": {"y": 1, "z": 2}, "k": 1}, {"x": {"y": 9}, "new": True}
    assert same(tcfg.deep_merge(a, b), jcfg.deep_merge(a, b))


FLATTEN = [{}, {"train": {"max_epoch": 3, "precision": "fp32"}, "eval": {"valid_interval_epoch": 2},
                "accum_grad": 4, "optim": "sgd", "optim_conf": {"lr": 0.1}},
           {"train": {"fsdp": True, "fsdp_min_elems": 64, "sp": 2, "max_epoch": 3}},
           {"train": {"keep_all_checkpoints": True, "accum_grad": 4}},
           {"train": {"valid_interval_epoch": 2}}, {"accum_grad": 4, "train": {"accum_grad": 4}},
           {"early_stopping": None, "optim_conf": None, "train": {"max_steps": 7}}]


@pytest.mark.parametrize("cfg", FLATTEN + [None], ids=range(len(FLATTEN) + 1))
def test_flatten_config_equals_jax(cfg):
    if cfg is None:                     # every config in the repository
        for path in CONFIGS:
            c = jcfg.load_yaml(path)
            assert same(tcfg.flatten_config(c), jcfg.flatten_config(c)), path.name
        return
    assert same(tcfg.flatten_config(cfg), jcfg.flatten_config(cfg))


@pytest.mark.parametrize("cfg,match", [
    ({"keep_all_checkpoints": False, "train": {"keep_all_checkpoints": True}}, "contradicts"),
    ({"train": {"x": 1}, "eval": {"x": 2}}, "BOTH")])
def test_flatten_config_errors_equal_jax(cfg, match):
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError, match=match):
            mod.flatten_config(cfg)


def test_config_fingerprint_equals_jax():
    for path in CONFIGS:
        c = jcfg.load_yaml(path)
        assert tcfg.config_fingerprint(c) == jcfg.config_fingerprint(c)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_run_assembly_paths_equal_jax(path, tmp_path):
    """tasks/build.py's resolve_manifests equals JAX's on every config, with
    its relative manifests_dir against two roots, an absolute one and a
    train_manifest of its own."""
    from hnet_mamba_asr_torch.tasks import build as tbuild
    from hnet_mamba_asr_tpu.tasks import build as jbuild
    cfg = tcfg.load_config(path)
    variants = [cfg, tcfg.apply_overrides(cfg, [f"data.manifests_dir={tmp_path / 'm'}",
                                                "data.train_manifest=train-clean-100"])]
    for c in variants:
        for root in (REPO, tmp_path):
            assert tbuild.resolve_manifests(c, root) == jbuild.resolve_manifests(c, root)


def test_tokenizer_and_cmvn_from_config_equal_jax(tmp_path):
    """build_tokenizer and build_cmvn read the files a config names, relative
    to the root or absolute, as JAX's; no bpemodel raises with JAX's words and
    no CMVN path gives None."""
    import numpy as np
    from hnet_mamba_asr_torch.data.features import GlobalCMVN
    from hnet_mamba_asr_torch.tasks import build as tbuild
    from hnet_mamba_asr_torch.tools.gate import seeded_tokenizer
    from hnet_mamba_asr_tpu.tasks import build as jbuild
    (tmp_path / "tok").mkdir()
    seeded_tokenizer(tmp_path / "tok" / "bpe.model", vocab=40)
    rng = np.random.default_rng(0)
    GlobalCMVN(rng.normal(size=80), rng.uniform(0.5, 2.0, size=80)).save(tmp_path / "cmvn.npz")
    for tok_path, cmvn_path in (("tok/bpe.model", "cmvn.npz"),
                                (str(tmp_path / "tok" / "bpe.model"), str(tmp_path / "cmvn.npz"))):
        cfg = {"bpemodel": tok_path, "frontend_conf": {"cmvn": cmvn_path}}
        t, j = tbuild.build_tokenizer(cfg, tmp_path), jbuild.build_tokenizer(cfg, tmp_path)
        assert t.pieces == j.pieces and t.vocab_size == j.vocab_size == 40
        tc, jc = tbuild.build_cmvn(cfg, tmp_path), jbuild.build_cmvn(cfg, tmp_path)
        np.testing.assert_array_equal(tc.mean, jc.mean)
        np.testing.assert_array_equal(tc.istd, jc.istd)
    assert tbuild.build_cmvn({}, tmp_path) is None and jbuild.build_cmvn({}, tmp_path) is None
    for mod in (tbuild, jbuild):
        with pytest.raises(ValueError, match="config needs a 'bpemodel' path"):
            mod.build_tokenizer({}, tmp_path)
