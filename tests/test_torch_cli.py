"""The port's command-line tools (python -m hnet_mamba_asr_torch.scripts.*)
in-process with --device cpu, on a workspace like tests/test_scripts_e2e.py's:
WAV and FLAC audio, a tokenizer trained in-process, CMVN, a seeded model
and LM written as JAX package checkpoints, and a YAML config read by the
port's reader. export_serving (fp32 and int8), serve over HTTP, transcribe
(hypotheses equal to the JAX package's scripts/transcribe.py for
ctc_greedy and joint_beam), decode with a shared encoder and the LM cells,
score_wer (host code, no --device) and its gate's exit code; without a
card the default --device cuda of the tools that run a model raises."""
import importlib.util
import io
import json
import threading
import urllib.request
import wave as wave_mod
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from torch_parity import seeded_tree

from hnet_mamba_asr_torch.data.audio import write_manifest, write_wav
from hnet_mamba_asr_torch.data.features import compute_cmvn
from hnet_mamba_asr_torch.data.flac import write_flac
from hnet_mamba_asr_torch.data.tokenizer import Tokenizer
from hnet_mamba_asr_torch.scripts import decode, export_serving, score_wer, serve, transcribe
from hnet_mamba_asr_torch.serving.runtime import load_serving_artifact

REPO = Path(__file__).resolve().parents[1]
TEXTS = ["aa bb cc", "bb aa", "cc cc bb", "aa", "bb cc", "cc aa aa bb"]

CONFIG = """
experiment: {{name: cli, seed: 0}}
data:
  manifests_dir: {root}/manifests
  eval_splits: [test-clean]
  wire_dtype: int16
bpemodel: {root}/tok/bpe.model
frontend_conf: {{sample_rate: 16000, n_mels: 20, win_length: 400, hop_length: 160,
                 cmvn: {root}/cmvn.npz}}
encoder: dcasr
encoder_conf: {{arch_type: A, d_outer: 16, d_main: 24, n_enc: 1, n_main: 1,
                n_dec: 1, d_state: 8, headdim: 8, ssd_chunk_size: 16,
                hnet: {{compression_N: 1}}}}
aed_conf: {{n_layers: 1, n_heads: 2, d_ff: 256, dropout: 0.0, max_decode_len: 8}}
model_conf: {{ctc_weight: 0.5, aed_weight: 0.5, lsm_weight: 0.1}}
lm_conf: {{d_model: 16, n_layers: 1, n_heads: 2, d_ff: 32, dropout: 0.0}}
batch_bins: 2000
train: {{precision: fp32}}
decode:
  read_outs: [ctc, aed, joint]
  search: [greedy, beam]
  beam_size: 2
  pre_beam: 4
  ctc_weight: 0.3
  share_encoder: true
  lm: enabled
  lm_config: {root}/cfg.yaml
  lm_checkpoint: {root}/lm.ckpt
  lm_weight: 0.2
  rescore_weight: 0.3
  batch_bins: 2000
score: {{gate_cell: ctc_greedy}}
goal: {{sane_test_clean_wer_below: 12.0}}
"""


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Audio (WAV and FLAC), manifests, tokenizer, CMVN, the config, and
    seeded JAX package checkpoints of the ASR model and the LM."""
    from hnet_mamba_asr_tpu.data.features import GlobalCMVN as JCMVN
    from hnet_mamba_asr_tpu.tasks import asr_task as jtask
    from hnet_mamba_asr_tpu.tasks import lm_task as jlm
    from hnet_mamba_asr_tpu.training.checkpoint import save_checkpoint
    from hnet_mamba_asr_tpu.utils.config import load_config

    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    (root / "manifests").mkdir()
    entries = []
    for i, text in enumerate(TEXTS):
        n = int(rng.integers(4000, 9000))
        w = rng.normal(size=n) * 0.1
        path = root / (f"u{i}.flac" if i % 2 else f"u{i}.wav")
        (write_flac if i % 2 else write_wav)(path, w, 16000)
        entries.append({"id": f"u{i}", "audio": str(path), "text": text, "frames": n})
    write_manifest(entries[:4], root / "manifests" / "train-960.jsonl")
    write_manifest(entries[4:], root / "manifests" / "test-clean.jsonl")
    tok = Tokenizer.train(TEXTS, root / "tok" / "bpe", vocab_size=24, hard_vocab_limit=False)
    compute_cmvn(root / "manifests" / "train-960.jsonl", n_mels=20, device="cpu",
                 out=root / "cmvn.npz")
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(CONFIG.format(root=root))
    cfg = load_config(cfg_path)
    jm = jtask.build_model(cfg, tok.vocab_size, cmvn=JCMVN.load(root / "cmvn.npz"))
    params = seeded_tree(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=1)
    save_checkpoint(root / "asr.ckpt", {"params": params, "epoch": 1})
    lm = jlm.build_lm(cfg, tok.vocab_size)
    save_checkpoint(root / "lm.ckpt", {"params": seeded_tree(
        jax.eval_shape(lm.init_params, jax.random.PRNGKey(0)), seed=2)})
    return {"root": root, "cfg": cfg_path, "ckpt": root / "asr.ckpt", "tok": tok,
            "wavs": [e["audio"] for e in entries if e["audio"].endswith(".wav")]}


def _export(ws, out, *extra):
    return export_serving.run(export_serving.parse_args(
        ["--config", str(ws["cfg"]), "--checkpoint", str(ws["ckpt"]), "--out", str(out),
         "--device", "cpu", *extra]))


def _wav_bytes(path) -> bytes:
    return Path(path).read_bytes()


def _pcm(path) -> np.ndarray:
    with wave_mod.open(io.BytesIO(_wav_bytes(path))) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32768.0


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_export_cli(ws, tmp_path, quantize):
    out = tmp_path / "art"
    _export(ws, out, "--buckets", "2x16000", "4x32000", "--emit", "frame_ids", "beam_ids",
            *(["--quantize", quantize] if quantize else []))
    man = json.loads((out / "manifest.json").read_text())
    assert man["quantize"] == quantize and man["runtime"] == "torch"
    assert man["buckets"] == [{"batch": 2, "samples": 16000}, {"batch": 4, "samples": 32000}]
    assert man["config"]["encoder_conf"]["d_main"] == 24 and man["cmvn"] == "cmvn.npz"
    assert man["checkpoint"] == str(ws["ckpt"]) and man["epoch"] == 1
    assert man["tokenizer"]["pieces"] == ws["tok"].pieces
    sm = load_serving_artifact(out, "cpu")
    w = _pcm(ws["wavs"][0])
    ids = sm.transcribe_ids(w[None], [len(w)])
    assert sm.transcribe_text(w[None], [len(w)]) == [ws["tok"].decode(ids[0])]
    with np.load(out / "params.npz") as z:
        dtypes = {str(z[k].dtype) for k in z.files}
    assert dtypes == ({"float32", "int8"} if quantize else {"float32"})


def test_serve_cli_answers_http(ws, tmp_path):
    out = tmp_path / "art"
    _export(ws, out, "--buckets", "2x16000")
    ready = threading.Event()
    box = {}

    def on_ready(httpd, ctl):
        box["httpd"] = httpd
        ready.set()

    thread = threading.Thread(target=serve.main, daemon=True, kwargs=dict(
        argv=[str(out), "--port", "0", "--device", "cpu", "--max-wait-ms", "1"],
        on_ready=on_ready))
    thread.start()
    assert ready.wait(60)
    httpd = box["httpd"]
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        req = urllib.request.Request(f"{url}/v1/transcribe", data=_wav_bytes(ws["wavs"][1]),
                                     headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())
        with urllib.request.urlopen(f"{url}/v1/health", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        thread.join(timeout=30)
    w = _pcm(ws["wavs"][1])
    sm = load_serving_artifact(out, "cpu")
    assert got["ids"] == sm.transcribe_ids(w[None], [len(w)])[0]
    assert got["text"] == ws["tok"].decode(got["ids"])
    assert health["status"] == "ok" and health["buckets"] == [[2, 16000]]
    assert not thread.is_alive()


@pytest.mark.parametrize("cell", ["ctc_greedy", "joint_beam"])
def test_transcribe_cli_equals_jax(ws, tmp_path, cell):
    spec = importlib.util.spec_from_file_location("jax_transcribe", REPO / "scripts" /
                                                  "transcribe.py")
    jt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jt)
    argv = ["--config", str(ws["cfg"]), "--checkpoint", str(ws["ckpt"]), "--cell", cell,
            "--batch-size", "3", *ws["wavs"]]
    want = jt.run(jt.parse_args(argv))
    got = transcribe.main(argv + ["--device", "cpu", "--out", str(tmp_path / "h.jsonl")])
    assert [r["id"] for r in got] == ws["wavs"]
    assert [r["hyp"] for r in got] == [r["hyp"] for r in want]
    assert [json.loads(l)["hyp"] for l in (tmp_path / "h.jsonl").read_text().splitlines()] \
        == [r["hyp"] for r in want]


def test_decode_and_score_cli(ws, tmp_path):
    out = tmp_path / "decode"
    summary = decode.run(decode.parse_args(
        ["--config", str(ws["cfg"]), "--checkpoint", str(ws["ckpt"]), "--out-dir", str(out),
         "--device", "cpu"]))
    cells = sorted(p.name for p in out.iterdir() if p.is_dir() and p.name != "logs")
    assert cells == ["aed_beam", "aed_beam_lm", "ctc_beam", "ctc_beam_lm", "ctc_greedy",
                     "joint_beam", "joint_beam_lm"]
    recs = [json.loads(l) for l in (out / "ctc_greedy" / "test-clean.jsonl").read_text()
            .splitlines()]
    assert sorted(r["id"] for r in recs) == ["u4", "u5"]         # a WAV and a FLAC
    assert all(set(r) >= {"id", "ref", "hyp", "decode_s", "audio_s"} for r in recs)
    on_disk = json.loads((out / "summary.json").read_text())
    assert on_disk["weights_meta"] == {"epoch": 1} == summary["weights_meta"]
    assert len(on_disk["cells"]) == 7 and on_disk["provenance"]["config_fingerprint"]
    assert on_disk["provenance"]["env"]["torch"] == torch.__version__
    with pytest.raises(SystemExit) as exc:             # seeded weights: the gate fails
        score_wer.run(score_wer.parse_args(
            ["--decode-dir", str(out), "--config", str(ws["cfg"]), "--n-bootstrap", "20"]))
    assert exc.value.code == 2
    scores = json.loads((out / "score" / "scores.json").read_text())
    assert set(scores["splits"]["test-clean"]["cells"]) == set(cells)
    assert scores["gate"]["evaluated"] and not scores["gate"]["passed"]
    assert "GATE" in (out / "score" / "report.txt").read_text()
    with pytest.raises(ValueError, match=r"decode\.tp=2 needs 2 ranks \(got 1\)"):
        decode.run(decode.parse_args(["--config", str(ws["cfg"]), "--checkpoint",
                                      str(ws["ckpt"]), "--device", "cpu", "decode.tp=2"]))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_default_device_raises_without_a_card(ws, tmp_path):
    base = ["--config", str(ws["cfg"]), "--checkpoint", str(ws["ckpt"])]
    calls = [lambda: export_serving.run(export_serving.parse_args(
                 base + ["--out", str(tmp_path / "a")])),
             lambda: transcribe.main(base + ws["wavs"]),
             lambda: decode.run(decode.parse_args(base + ["--out-dir", str(tmp_path / "d")]))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    _export(ws, tmp_path / "art", "--buckets", "1x16000")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([str(tmp_path / "art"), "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving_artifact(tmp_path / "art")
