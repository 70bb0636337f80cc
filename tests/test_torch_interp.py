"""The port's interpretability suite (hnet_mamba_asr_torch/interp/, the
run_mfa CLI) against the JAX package's on the CPU: the host copies
(alignments, boundary scoring, perturbation time maps, probe labels and
spans) on seeded cases; the probe backends ('torch' fp32 L-BFGS on the CPU,
JAX's 'jax', scipy's 'lbfgs') against a float64 optimum and sklearn; the
reports of both packages' drivers over the same tone-corpus utterances with
one seeded N=2 model (boundaries, probes with 'lbfgs', robustness under
noise and silence), boundaries compared first; run_mfa of both packages over
a fake aligner."""
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_parity import assert_boundaries_equal, seeded_tree

from hnet_mamba_asr_torch import convert
from hnet_mamba_asr_torch.data import synthetic as tsyn
from hnet_mamba_asr_torch.data import dataset as tds
from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
from hnet_mamba_asr_torch.interp import alignments as tal
from hnet_mamba_asr_torch.interp import boundary_align as tba
from hnet_mamba_asr_torch.interp import driver as tdrv
from hnet_mamba_asr_torch.interp import probes as tpr
from hnet_mamba_asr_torch.scripts import run_mfa as trun_mfa
from hnet_mamba_asr_torch.tasks.asr_task import build_model
from hnet_mamba_asr_tpu.data import dataset as jds
from hnet_mamba_asr_tpu.data import synthetic as jsyn
from hnet_mamba_asr_tpu.interp import alignments as jal
from hnet_mamba_asr_tpu.interp import boundary_align as jba
from hnet_mamba_asr_tpu.interp import driver as jdrv
from hnet_mamba_asr_tpu.interp import probes as jpr
from hnet_mamba_asr_tpu.tasks import asr_task as jtask

REPO = Path(__file__).resolve().parents[1]
PROB_TOL = 2e-5              # the reference's own bar on predicted probabilities

TEXTGRID = '''File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 2.0
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 2.0
        intervals: size = 3
        intervals [1]:
            xmin = 0.0
            xmax = 0.5
            text = ""
        intervals [2]:
            xmin = 0.5
            xmax = 1.2
            text = "hello"
        intervals [3]:
            xmin = 1.2
            xmax = 2.0
            text = "world"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = 2.0
        intervals: size = 3
        intervals [1]:
            xmin = 0.5
            xmax = 0.8
            text = "HH"
        intervals [2]:
            xmin = 0.8
            xmax = 1.2
            text = "AH0"
        intervals [3]:
            xmin = 1.2
            xmax = 2.0
            text = "W"
'''

JAX = {"al": jal, "ba": jba, "drv": jdrv, "pr": jpr, "syn": jsyn}
PORT = {"al": tal, "ba": tba, "drv": tdrv, "pr": tpr, "syn": tsyn}


def _times(rng, n=8, top=3.0):
    return sorted(rng.uniform(0.0, top, size=n).tolist())


def _units(rng, n=6):
    edges = np.cumsum(rng.uniform(0.05, 0.4, size=n + 1))
    return [[f"w{i}", float(edges[i]), float(edges[i + 1])] for i in range(n)]


def _record(rng):
    return {"id": "u", "words": _units(rng), "phones": [
        [p, s, e] for p, (_, s, e) in zip(["AH0", "S", "spn", "M", "IY1", "B"], _units(rng))]}


def _perturbed(m, rng):
    perts = m["drv"].perturbations_from_config({"noise_snr_db": [10], "speed_factors": [0.9],
                                                "silence": {"duration_s": 0.3}})
    times, rec = _times(rng), _record(rng)
    return [(p.name, p.transform_times(times, 3.0), p.transform_record(rec, 3.0),
             p.transform_duration(3.0), p.transform_samples(48000)) for p in perts]


# each case draws its inputs from a fresh default_rng(0) and returns a value
# that both packages must give equally
HOST_CASES = {
    "parse_textgrid": lambda m, rng: m["al"].parse_textgrid(TEXTGRID),
    "alignment_record": lambda m, rng: m["al"].alignment_record(
        "u", m["al"].parse_textgrid(TEXTGRID)),
    "check_alignment": lambda m, rng: [m["al"].check_alignment(
        m["al"].alignment_record("u", m["al"].parse_textgrid(TEXTGRID)), text, dur)
        for text, dur in (("hello world", 2.0), ("goodbye world", 2.0),
                          ("hello world", 1.0))],
    "select_subset": lambda m, rng: m["al"].select_subset(
        [{"id": f"u{i}", "frames": int(f)} for i, f in
         enumerate(rng.integers(16000, 320000, size=60))], hours=0.05, seed=3),
    "frame_boundary_times": lambda m, rng: [m["ba"].frame_boundary_times(
        (rng.uniform(size=40) > 0.6).astype(np.float32), L, drop_first=df)
        for L in (40, 25) for df in (True, False)],
    "stage2_boundary_times": lambda m, rng: m["ba"].stage2_boundary_times(
        (rng.uniform(size=40) > 0.4).astype(np.float32),
        (rng.uniform(size=40) > 0.5).astype(np.float32), 37),
    "true_edges": lambda m, rng: m["ba"].true_edges(_units(rng, 9)),
    "match_prf_rvalue": lambda m, rng: [
        (m["ba"].match_boundaries(_times(rng), _times(rng), tol),
         m["ba"].prf(*m["ba"].match_boundaries(_times(rng), _times(rng), tol)),
         m["ba"].r_value(0.7, 0.3)) for tol in (0.02, 0.1, 0.3)],
    "aggregate_baseline": lambda m, rng: (
        m["ba"].aggregate([(2, 3, 4), (1, 2, 2), (0, 5, 1)]),
        m["ba"].random_baseline([{"n_pred": 4, "true": _times(rng, 5), "duration": 3.0}
                                 for _ in range(6)], tol=0.05, seed=2, trials=4)),
    "score_utterances": lambda m, rng: {k: v for k, v in m["ba"].score_utterances(
        {f"u{i}": _times(rng) for i in range(4)},
        {f"u{i}": {"words": _units(rng), "phones": _units(rng)} for i in range(1, 5)},
        "words", 0.05, durations={f"u{i}": 3.0 for i in range(5)}).items()},
    "perturbation_time_maps": _perturbed,
    "noise_wave": lambda m, rng: m["drv"].NoisePerturbation(10.0).apply_wave(
        rng.normal(size=4000), "utt7", seed=3),
    "silence_wave": lambda m, rng: m["drv"].SilencePerturbation(0.2, 0.3).apply_wave(
        rng.normal(size=4000).astype(np.float32), "u", sample_rate=16000),
    "utt_seed": lambda m, rng: [m["drv"].utt_seed(s, u) for s in (1, 2) for u in ("a", "b")],
    "matched_deltas": lambda m, rng: m["drv"].matched_deltas(_times(rng), _times(rng), 0.2),
    "flatten_metrics": lambda m, rng: m["drv"].flatten_metrics(
        {"stage0": {"phones": {"f1": 0.5, "random_baseline": {"f1": 0.3},
                               "missing_alignments": [], "n_hit": 3}}}),
    "frame_labels": lambda m, rng: [m["pr"].frame_labels(_record(rng), n, tier)
                                    for n in (0, 12, 40) for tier in ("words", "phones")],
    "chunk_spans": lambda m, rng: [m["pr"].chunk_spans(b, L) for b, L in (
        ((rng.uniform(size=30) > 0.6).astype(np.float32), 30), ([0, 0, 1, 0], 4),
        ([0, 0, 0], 3), ([], 0), ((rng.uniform(size=30) > 0.3).astype(np.float32), 17))],
    "labels_and_sampling": lambda m, rng: (
        m["pr"].majority_label(["a", "b", "a", None]), m["pr"].to_classes(["AH0", "S", "M"]),
        m["pr"].subsample(list(range(50)), [str(i % 7) for i in range(50)], 20, seed=4),
        m["pr"].top_k_filter(list(range(30)), [str(int(v)) for v in rng.integers(0, 6, 30)],
                             3)),
    "tone_alignment_records": lambda m, rng: m["syn"].tone_alignment_records(
        [{"id": f"u{i}", "text": " ".join(rng.choice(list("abcd"), size=int(k)))}
         for i, k in enumerate(rng.integers(2, 6, size=5))]),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_copies_match_jax(case):
    want = HOST_CASES[case](JAX, np.random.default_rng(0))
    got = HOST_CASES[case](PORT, np.random.default_rng(0))
    np.testing.assert_equal(got, want)


# ── probe backends ─────────────────────────────────────────────────────────────
def _probe_data(rng, n=120, d=6, classes=("x", "y", "z")):
    """tests/test_interp.py's clusters."""
    X, y = [], []
    for i, c in enumerate(classes):
        mu = np.zeros(d)
        mu[i] = 3.0
        X.extend(rng.normal(size=(n, d)) + mu)
        y.extend([c] * n)
    return X, y


def _optimum(X, y_labels, k):
    """The float64 optimum: scipy L-BFGS-B at gtol 1e-8, no stop on the
    decrease alone."""
    classes, y = tpr._encode_labels(y_labels)
    return tpr.lbfgs_weights(X, y, k, max_iter=5000, C=1.0, gtol=1e-8, ftol=0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_backend_reaches_the_float64_optimum(seed):
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import balanced_accuracy_score

    rng = np.random.default_rng(seed)
    Xtr, ytr = _probe_data(rng)
    Xte, yte = _probe_data(rng, n=40)
    classes, y = tpr._encode_labels(ytr)
    W, b, n_iter, _ = tpr.torch_lbfgs_weights(Xtr, y, 3, max_iter=1000, C=1.0, device="cpu")
    W64, b64, _, grad = _optimum(Xtr, ytr, 3)
    assert grad < tpr.TORCH_GTOL
    got, want = tpr.predict_proba(W, b, Xte), tpr.predict_proba(W64, b64, Xte)
    assert np.abs(got - want).max() <= PROB_TOL
    assert 0 < n_iter < 1000
    # the optimum's probabilities do not depend on scipy's start (the card's
    # check starts scipy from the device fit's weights)
    classes, y = tpr._encode_labels(ytr)
    W0, b0, _, _ = tpr.lbfgs_weights(Xtr, y, 3, max_iter=5000, C=1.0, gtol=1e-8, ftol=0.0,
                                     init=(W, b))
    assert np.abs(tpr.predict_proba(W0, b0, Xte) - want).max() <= 1e-6

    out = tpr.train_probe(Xtr, ytr, Xte, yte, backend="torch", max_iter=1000, device="cpu")
    ref = jpr.train_probe(Xtr, ytr, Xte, yte, backend="jax", max_iter=1000)
    plain = tpr.train_probe(Xtr, ytr, Xte, yte, backend="lbfgs", max_iter=1000)
    assert out["backend"] == "torch" and plain["backend"] == "lbfgs"
    sk = LogisticRegression(max_iter=2000, C=1.0, tol=1e-7).fit(np.asarray(Xtr), ytr)
    confident = sk.predict_proba(np.asarray(Xte)).max(axis=1) > 0.6
    sk_pred = sk.predict(np.asarray(Xte))
    for backend_preds in (tpr._torch_lbfgs_fit(Xtr, ytr, Xte, max_iter=1000, C=1.0,
                                               device="cpu")[0],
                          jpr._jax_lbfgs_fit(Xtr, ytr, Xte, max_iter=1000, C=1.0)[0],
                          tpr._lbfgs_fit(Xtr, ytr, Xte, max_iter=1000, C=1.0)[0]):
        np.testing.assert_array_equal(backend_preds[confident], sk_pred[confident])
    preds = tpr._torch_lbfgs_fit(Xtr, ytr, Xte, max_iter=1000, C=1.0, device="cpu")[0]
    assert out["balanced_accuracy"] == pytest.approx(balanced_accuracy_score(yte, preds),
                                                     abs=1e-12)
    for key in ("accuracy", "majority_baseline", "chance", "n_classes", "n_train", "n_test"):
        assert out[key] == pytest.approx(ref[key], abs=0.02), key


def test_balanced_accuracy_is_sklearns():
    from sklearn.metrics import balanced_accuracy_score
    rng = np.random.default_rng(3)
    y = rng.choice(list("abcde"), size=200, p=[0.5, 0.2, 0.15, 0.1, 0.05])
    pred = np.where(rng.uniform(size=200) < 0.7, y, rng.choice(list("abcdf"), size=200))
    assert tpr.balanced_accuracy(y, pred) == pytest.approx(balanced_accuracy_score(y, pred),
                                                           abs=1e-12)


def test_two_class_fit_is_sklearns_binary_model():
    """sklearn's 2-class model is one penalized weight vector and a free
    intercept: the port's 'torch' and 'lbfgs' backends fit that objective."""
    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(5)
    Xtr, ytr = _probe_data(rng, classes=("x", "y"))
    Xte, yte = _probe_data(rng, n=40, classes=("x", "y"))
    sk = LogisticRegression(max_iter=5000, C=1.0, tol=1e-10).fit(np.asarray(Xtr), ytr)
    want = sk.predict_proba(np.asarray(Xte))
    classes, y = tpr._encode_labels(ytr)
    for W, b, _, _ in (tpr.torch_lbfgs_weights(Xtr, y, 2, max_iter=1000, C=1.0, device="cpu"),
                       _optimum(Xtr, ytr, 2)):
        assert W.shape == (6, 1) and b.shape == (1,)
        assert np.abs(tpr.predict_proba(W, b, Xte) - want).max() <= PROB_TOL
    for backend in ("torch", "lbfgs"):
        out = tpr.train_probe(Xtr, ytr, Xte, yte, backend=backend, device="cpu")
        assert out["backend"] == backend and out["n_classes"] == 2
        assert out["accuracy"] == pytest.approx(float(np.mean(sk.predict(np.asarray(Xte))
                                                              == np.asarray(yte))))


def test_sklearn_backend_raises_where_sklearn_is_missing(monkeypatch):
    rng = np.random.default_rng(0)
    Xtr, ytr = _probe_data(rng)
    for name in ("sklearn", "sklearn.linear_model"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(RuntimeError, match="'sklearn'"):
        tpr.train_probe(Xtr, ytr, Xtr, ytr, backend="sklearn")
    with pytest.raises(ValueError, match="backend must be"):
        tpr.train_probe(Xtr, ytr, Xtr, ytr, backend="jax_gpu")


def test_torch_backend_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    rng = np.random.default_rng(0)
    Xtr, ytr = _probe_data(rng)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpr.train_probe(Xtr, ytr, Xtr, ytr, backend="jax")       # the configs' name


# ── the slice as a whole: both drivers on one seeded N=2 model ───────────────
N2_CHANGES = {"n_main": 2, "hnet": {"compression_N": 2}}
ROBUSTNESS = {"noise_snr_db": [10], "speed_factors": [], "silence": {"duration_s": 0.3}}


@pytest.fixture(scope="module")
def tone(tmp_path_factory):
    """The tone corpus with its analytic alignments (8 dev utterances scored,
    16 disjoint probe-training ones), a tokenizer, and a tiny Type A N=2
    model (d 32, 1 + 2 + 1 blocks) on one seeded param tree (random routers)
    in both packages."""
    root = tmp_path_factory.mktemp("tone_interp")
    entries = tsyn.build_tone_corpus(root)
    records = {r["id"]: r for r in tsyn.tone_alignment_records(entries)}
    tok = Tokenizer.train([e["text"] for e in entries], root / "bpe", vocab_size=12,
                          hard_vocab_limit=False)
    cfg = tsyn.overfit_config(root, compression_n=2)
    cfg["encoder_conf"].update(N2_CHANGES)
    jm = jtask.build_model(cfg, tok.vocab_size)
    params = seeded_tree(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=4)
    model = build_model(cfg, tok.vocab_size, device="cpu")
    convert.load_jax_params(model, params)
    jencode = jax.jit(lambda p, b: jm.encode(p, b, train=False))

    def jax_encode(batch):
        return jencode(params, {k: jnp.asarray(batch[k]) for k in ("wave", "wave_lens")})

    def port_encode(batch):
        with torch.no_grad():
            return model.encode({k: torch.as_tensor(batch[k]) for k in ("wave", "wave_lens")})

    return dict(entries=entries, dev=entries[:8], train=entries[8:], records=records, tok=tok,
                durations=tdrv.durations_from_entries(entries[:8]),
                encode={"jax": jax_encode, "port": port_encode})


def _loader(side, entries, tok, pert=None):
    """Each package's own eval loader (batch_bins 8000: one batch a split)."""
    mod, drv = (jds, jdrv) if side == "jax" else (tds, tdrv)
    ds = (mod.ASRDataset(entries, tok, augment=False) if pert is None
          else drv.PerturbedDataset(entries, tok, pert, seed=1))
    return mod.make_dataloader(ds, 8000, batch_multiple=1)[0]


def _reports(tone, side):
    drv = jdrv if side == "jax" else tdrv
    enc, tok, recs = tone["encode"][side], tone["tok"], tone["records"]
    dev_al = {e["id"]: recs[e["id"]] for e in tone["dev"]}
    train_al = {e["id"]: recs[e["id"]] for e in tone["train"]}
    bounds_report, bounds = drv.boundary_report(enc, _loader(side, tone["dev"], tok), dev_al,
                                                tone["durations"], tol=0.06,
                                                baseline_trials=5)
    probes = drv.probe_report(enc, _loader(side, tone["train"], tok),
                              _loader(side, tone["dev"], tok), train_al, dev_al, n_stages=1,
                              top_k_words=4, train_cap=5000, test_cap=2000, max_iter=300,
                              backend="lbfgs")
    perts = drv.perturbations_from_config(ROBUSTNESS)
    collect = (jba if side == "jax" else tba).collect_boundaries
    robust = drv.robustness_report(
        perts, lambda p: collect(enc, _loader(side, tone["dev"], tok, p)), bounds, dev_al,
        tone["durations"], tol=0.06, baseline_trials=5)
    return bounds, bounds_report, probes, robust


def test_reports_match_jax(tone):
    """Both drivers, each over its own package's loader and model, on the
    same weights and utterances: the collected boundaries first (each
    utterance's hard boundaries, named frames near 0.5 on a mismatch), then
    the boundary, probe ('lbfgs' on both) and robustness reports."""
    batch = next(iter(_loader("port", tone["dev"], tone["tok"])))
    (pj, bj), = tone["encode"]["jax"](batch).boundaries
    (pt, bt), = tone["encode"]["port"](batch).boundaries
    assert_boundaries_equal(bt.numpy(), np.asarray(bj), np.asarray(pj), "(tone dev batch)")
    got, want = _reports(tone, "port"), _reports(tone, "jax")
    np.testing.assert_equal(got[0], want[0])
    assert sum(len(t) for t in got[0][0].values()) > 0       # the routers cut chunks
    np.testing.assert_equal(got[1], want[1])
    np.testing.assert_equal(got[3], want[3])
    # the probes: equal but for scipy's iteration counts, which the features'
    # last bits move (the two encoders agree to ~1e-6, not bit for bit)
    iters = {}
    for side, report in (("port", got[2]), ("jax", want[2])):
        for level, block in report.items():
            for task, result in block.items():
                iters[side, level, task] = result.pop("n_iter")
    np.testing.assert_equal(got[2], want[2])
    for (side, level, task), n in iters.items():
        if side == "port":
            assert abs(n - iters["jax", level, task]) <= 0.25 * iters["jax", level, task]


def test_collect_boundaries_reads_device_and_bf16_tensors():
    """The port's EncoderOutput may hold bf16 tensors (np.asarray raises on
    them): collect_boundaries and collect_probe_data move them to the host,
    read each row to its own length, and skip padded rows past ``ids``."""
    b = torch.zeros(3, 10, dtype=torch.bfloat16)
    b[:, ::3] = 1
    feats = torch.arange(3 * 10 * 2, dtype=torch.bfloat16).reshape(3, 10, 2)

    class Out:
        boundaries = ((b.float() * 0.5 + 0.25, b),)
        lengths = torch.tensor([10, 7, 10])
        features = feats
        chunk_embeddings = (feats[:, :4],)

    batch = {"ids": ["u0", "u1"]}
    bounds = tba.collect_boundaries(lambda _: Out, [batch])
    assert set(bounds[0]) == {"u0", "u1"}
    assert bounds[0]["u1"] == pytest.approx([3 * 0.04 + 0.0225, 6 * 0.04 + 0.0225])
    align = {"u1": {"phones": [["AA", 0.0, 0.2], ["S", 0.2, 0.4]]}}
    X, y = tpr.collect_probe_data(lambda _: Out, [batch], align, "phones", level="chunks")
    assert y == ["AA", "S", "S"] and len(X) == 3 and X[0].dtype == np.float32


# ── run_mfa over a fake aligner ──────────────────────────────────────────────
FAKE_MFA = """#!{python}
# fake 'mfa align CORPUS DICT MODEL OUT ...': a TextGrid per .lab, the words
# spread evenly over 0.7 s; 'u2' gets a wrong word, 'u3' no file
import sys
from pathlib import Path
corpus, out = Path(sys.argv[2]), Path(sys.argv[5])
for lab in corpus.glob("*/*.lab"):
    if lab.stem == "u3":
        continue
    words = lab.read_text().split()
    if lab.stem == "u2":
        words[0] = "zz"
    n = len(words)
    tiers = []
    for name, labels in (("words", words), ("phones", ["AA"] * n)):
        ivs = "".join(f'''
        intervals [{{i + 1}}]:
            xmin = {{0.7 * i / n}}
            xmax = {{0.7 * (i + 1) / n}}
            text = "{{w}}"''' for i, w in enumerate(labels))
        tiers.append(f'''
    item [{{len(tiers) + 1}}]:
        class = "IntervalTier"
        name = "{{name}}"
        intervals: size = {{n}}{{ivs}}''')
    (out / lab.parent.name).mkdir(parents=True, exist_ok=True)
    (out / lab.parent.name / (lab.stem + ".TextGrid")).write_text(
        'File type = "ooTextFile"\\nObject class = "TextGrid"\\nitem []:' + "".join(tiers))
"""


def test_run_mfa_matches_jax(tmp_path):
    spec = importlib.util.spec_from_file_location("jax_run_mfa", REPO / "scripts" / "run_mfa.py")
    jrun_mfa = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jrun_mfa)
    fake = tmp_path / "mfa"
    fake.write_text(FAKE_MFA.format(python=sys.executable))
    os.chmod(fake, 0o755)
    entries = tsyn.build_tone_corpus(tmp_path / "corpus", n_utts=6)
    outs = {}
    for name, mod in (("jax", jrun_mfa), ("port", trun_mfa)):
        for hours in (None, 0.001):
            out = tmp_path / name / f"{hours}" / "dev.jsonl"
            argv = ["--manifest", str(tmp_path / "corpus" / "manifests" / "train-960.jsonl"),
                    "--out", str(out), "--mfa-bin", str(fake)]
            mod.process_split(mod.parse_args(argv + (["--hours", str(hours)] if hours else [])))
            outs[name, hours] = [p.read_text() for p in sorted(out.parent.glob("dev*"))]
    for hours in (None, 0.001):
        assert outs["port", hours] == outs["jax", hours]
    accepted = tal.load_alignments(tmp_path / "port" / "None" / "dev.jsonl")
    assert [r["id"] for r in accepted] == [e["id"] for e in entries if e["id"] not in ("u2", "u3")]
    rejected = outs["port", None][1]
    assert '"u2"' in rejected and '"u3"' in rejected
