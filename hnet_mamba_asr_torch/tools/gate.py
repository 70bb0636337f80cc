"""The gate config (``configs/typeA_small_N1.yaml``, Type A Small N=1), its
dynamic-chunking sibling (``configs/typeA_small_N2.yaml``), the gate
config's decode block, the fusion LM (``configs/lm_transformer_500.yaml``),
the gate config with an RNN-T head or an MoE AED decoder (and the LM with
MoE blocks), and the causal siblings that stream, as the port's checks and
measurements run them: the configs' keys as dicts
(the card's machine has no PyYAML; ``tests/test_torch_slice.py``,
``tests/test_torch_hnet_train.py``, ``tests/test_torch_decode.py`` and
``tests/test_torch_lm.py`` hold the dicts equal to the YAML), seeded test
audio, CMVN statistics, training batches and a ``Trainer`` on the card.
``chip_smoke.py`` and ``tools/measure.py`` both build from here.
"""
from __future__ import annotations

import numpy as np
import torch

# the parts of configs/typeA_small_N1.yaml the model reads. The CMVN file it
# names is not in the repository: make_cmvn computes statistics from seeded
# audio.
GATE_CONFIG = {
    "frontend_conf": {"sample_rate": 16000, "n_mels": 80, "win_length": 400,
                      "hop_length": 160, "cmvn": "features/cmvn_train960.npz"},
    "specaug_conf": {"freq_mask_width_range": [0, 27], "num_freq_mask": 2,
                     "time_mask_width_ratio_range": [0.0, 0.05], "num_time_mask": 10},
    "encoder": "dcasr",
    "encoder_conf": {"arch_type": "A", "d_outer": 384, "d_main": 512, "n_enc": 4,
                     "n_main": 12, "n_dec": 4, "bidirectional": True, "d_state": 128,
                     "headdim": 64, "ssd_chunk_size": 256, "ssd_intra_dtype": "bf16",
                     "remat_policy": "none",
                     "hnet": {"compression_N": 1, "chunker": "dynamic",
                              "ema_smoothing": True}},
    "head": "ctc",
    "aed_conf": {"n_layers": 6, "n_heads": 4, "d_ff": 2048, "dropout": 0.1,
                 "max_decode_len": 512},
    "model_conf": {"ctc_weight": 0.3, "aed_weight": 0.7, "lsm_weight": 0.1,
                   "hnet_ratio_beta": 0.03},
    "train": {"precision": "bf16"},
}
# the trainer's keys of the same file (optim, scheduler, train, eval)
GATE_TRAIN = {"optim": "adamw",
              "optim_conf": {"lr": 6.0e-4, "weight_decay": 1.0e-2, "betas": [0.9, 0.999]},
              "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 20000},
              "max_epoch": 120, "grad_clip": 1.0, "grad_clip_type": 2.0,
              "log_interval": 50, "accum_grad": 2, "valid_interval_epoch": 5}
BATCH_BINS = 32000              # batch_bins: frames per micro-batch (max B x T)
# the parts of configs/typeA_small_N2.yaml the model reads: Type A Small with
# dynamic chunking at N = 2 (router, ratio loss, EMA dechunk); the SSD's
# intra-chunk weights stay fp32 and remat is JAX's default, full
N2_CONFIG = {
    "frontend_conf": GATE_CONFIG["frontend_conf"],
    "specaug_conf": GATE_CONFIG["specaug_conf"],
    "encoder": "dcasr",
    "encoder_conf": {"arch_type": "A", "d_outer": 384, "d_main": 512, "n_enc": 4,
                     "n_main": 12, "n_dec": 4, "bidirectional": True, "d_state": 128,
                     "headdim": 64, "ssd_chunk_size": 256,
                     "hnet": {"compression_N": 2, "chunker": "dynamic",
                              "ema_smoothing": True}},
    "head": "ctc",
    "aed_conf": GATE_CONFIG["aed_conf"],
    "model_conf": GATE_CONFIG["model_conf"],
    "train": {"precision": "bf16"},
}
N2_TRAIN = {"optim": "adamw",
            "optim_conf": {"lr": 6.0e-4, "weight_decay": 1.0e-2, "betas": [0.9, 0.999],
                           "router_lr_mult": 0.5, "router_eps": 1.0e-5},
            "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 20000},
            "max_epoch": 120, "grad_clip": 1.0, "grad_clip_type": 2.0,
            "log_interval": 50, "accum_grad": 1, "valid_interval_epoch": 5}
N2_BATCH_BINS = 64000
# the decode block of configs/typeA_small_N1.yaml: the 7-cell matrix (the LM
# checkpoint it names is not in the repository; checks draw LM weights)
GATE_DECODE = {"splits": ["dev-clean", "dev-other", "test-clean", "test-other"],
               "read_outs": ["ctc", "aed", "joint"], "search": ["greedy", "beam"],
               "beam_size": 10, "pre_beam": 30, "ctc_weight": 0.3, "length_bonus": 0.0,
               "lm": "enabled", "lm_config": "configs/lm_transformer_500.yaml",
               "lm_checkpoint":
                   "experiments/lm_transformer_500/checkpoints/valid.loss.ave.ckpt",
               "lm_weight": 0.3, "rescore_weight": 0.6, "rescore_length_bonus": 2.0}
# the model of configs/lm_transformer_500.yaml (~51 M parameters at V 500)
LM_CONFIG = {"lm_conf": {"d_model": 512, "n_layers": 16, "n_heads": 8, "d_ff": 2048,
                         "dropout": 0.1, "lsm_weight": 0.0, "max_line_tokens": 512}}
# the gate config with the transducer head beside its CTC and AED heads
# (model_conf.rnnt_weight 1.0, rnnt_conf at the JAX defaults): one model for
# the 10-cell matrix
RNNT_CONFIG = {**GATE_CONFIG,
               "model_conf": {**GATE_CONFIG["model_conf"], "rnnt_weight": 1.0},
               "rnnt_conf": {"d_pred": 256, "d_joint": 512, "context": 2, "max_symbols": 4,
                             "max_decode_len": 512}}
# the gate config with a routed MoE FFN in every AED decoder layer, and the
# fusion LM with the same MoE in every block (scored dropless at decode)
MOE = {"n_experts": 8, "top_k": 2, "capacity_factor": 1.25, "aux_weight": 0.01}
MOE_CONFIG = {**GATE_CONFIG, "aed_conf": {**GATE_CONFIG["aed_conf"], "moe": MOE}}
LM_MOE_CONFIG = {"lm_conf": {**LM_CONFIG["lm_conf"], "moe": MOE}}
# the causal siblings that stream exactly (encoder_conf.bidirectional false,
# every width and depth as in their configs): the gate config, the N=2
# config, and the gate config's causal widths with the transducer head alone
# (the model a streaming transducer serves: no CTC head, so the transducer
# is the one that streams)
GATE_CAUSAL_CONFIG = {**GATE_CONFIG,
                      "encoder_conf": {**GATE_CONFIG["encoder_conf"], "bidirectional": False}}
N2_CAUSAL_CONFIG = {**N2_CONFIG,
                    "encoder_conf": {**N2_CONFIG["encoder_conf"], "bidirectional": False}}
RNNT_CAUSAL_CONFIG = {**GATE_CAUSAL_CONFIG,
                      "model_conf": {**GATE_CONFIG["model_conf"], "ctc_weight": 0.0,
                                     "aed_weight": 0.0, "rnnt_weight": 1.0},
                      "rnnt_conf": RNNT_CONFIG["rnnt_conf"]}
VOCAB = 500                     # bpe_500: 501 CTC classes
SEED = 1                        # experiment.seed
SR = 16000
# training: utterances of 1000 mel frames (10.015 s), 32 per micro-batch
# (the config's batch_bins; 64 at N = 2); L 249 after the 4x subsampling
TRAIN_FRAMES = 1000
TRAIN_ROWS = BATCH_BINS // TRAIN_FRAMES
N2_TRAIN_ROWS = N2_BATCH_BINS // TRAIN_FRAMES
TRAIN_SAMPLES = (TRAIN_FRAMES - 1) * 160 + 400


def synth_audio(rng, seconds: float, samples: int | None = None):
    """Seeded speech-like test signal: a few gliding harmonics under noise."""
    n = int(seconds * SR) if samples is None else samples
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 250) * (1 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.2, 2) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    sig = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t) ** 2
    return (0.05 * sig * env + 0.01 * rng.normal(size=n)).astype(np.float32)


def make_cmvn(torch_device: str):
    """CMVN statistics from seeded audio (the config's file is not shipped)."""
    from hnet_mamba_asr_torch.data.features import GlobalCMVN
    from hnet_mamba_asr_torch.ops.melspec import log_mel_spectrogram
    wave = synth_audio(np.random.default_rng(SEED + 100), 20.0)
    feats, _ = log_mel_spectrogram(torch.from_numpy(wave).to(torch_device))
    f = feats[0].double().cpu().numpy()
    return GlobalCMVN(f.mean(0), np.sqrt(np.maximum(f.var(0), 1e-8)))


def train_batches(rng, n_batches: int, rows: int) -> list[dict]:
    """Host batches as the gate config's loader makes them (PCM16 wire, row
    masks, aug_ref, item indices): ``rows`` utterances of TRAIN_FRAMES mel
    frames each, with 20-39 random BPE ids."""
    from hnet_mamba_asr_torch.data.dataset import collate_batch
    out = []
    for k in range(n_batches):
        items = [{"wave": synth_audio(rng, 0.0, TRAIN_SAMPLES), "n_samples": TRAIN_SAMPLES,
                  "tokens": rng.integers(4, VOCAB, size=int(rng.integers(20, 40))).astype(
                      np.int32), "id": f"utt{k * rows + i}", "index": k * rows + i}
                 for i in range(rows)]
        out.append(collate_batch(items, pad_id=3, seed=SEED, epoch=0, snap_lengths=False,
                                 wire_dtype="int16"))
    return out


def draw_routers(model, seed: int) -> None:
    """Redraw every router's W_q and W_k as N(0, 1/d) from ``seed`` (on the
    CPU, then copied to the model's device, so that two models built from
    one seed stay equal). At their identity init on seeded audio the routers
    keep one frame per row (adjacent encoder frames are nearly parallel, so
    p ~ 0), and the main stack would see rows of length 1, whose gradients
    of A are identically zero; random projections give p ~ 0.5 +- 0.03, a
    kept fraction of about 1/2, which the ratio loss drives a trained N = 2
    router toward."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, param in model.named_parameters():
            if ".router." in f".{name}":
                param.copy_(torch.randn(param.shape, generator=gen) / param.shape[1] ** 0.5)


def gate_trainer(config, loader, train_cfg, cmvn, ckpt_dir, **overrides):
    """A Trainer on the card over ``loader`` for a model of ``config``
    with weights from SEED."""
    from hnet_mamba_asr_torch.tasks.asr_task import build_model
    from hnet_mamba_asr_torch.training.trainer import Trainer
    model = build_model(config, VOCAB, cmvn=cmvn, seed=SEED)
    return Trainer(model, loader, dict(train_cfg, **overrides), ckpt_dir=ckpt_dir, seed=SEED)


def seeded_tokenizer(path, vocab: int = VOCAB):
    """A tokenizer with ``vocab`` pieces (the 4 specials, then "▁t4" ...), for
    decoding models of ``vocab`` classes with seeded weights (the config's
    bpe_500 model is not in the repository)."""
    import json
    from pathlib import Path
    from hnet_mamba_asr_torch.data.tokenizer import SPECIAL_PIECES, Tokenizer
    pieces = list(SPECIAL_PIECES) + [f"▁t{i}" for i in range(len(SPECIAL_PIECES), vocab)]
    path = Path(path)
    path.write_text(json.dumps({"format": "hmasr-bpe", "version": 1, "pieces": pieces,
                                "merges": []}, ensure_ascii=False), encoding="utf-8")
    return Tokenizer(path)


def decode_batch_items(rng, n: int, seconds=(2.0, 16.0)) -> list[dict]:
    """``n`` seeded synthetic utterances of ``seconds`` with 10-40 random
    reference ids."""
    items = []
    for i, s in enumerate(rng.uniform(*seconds, size=n)):
        w = synth_audio(rng, float(s))
        items.append({"wave": w, "n_samples": len(w), "id": f"utt{i}", "index": i,
                      "tokens": rng.integers(4, VOCAB, size=int(rng.integers(10, 40))).astype(
                          np.int32)})
    return items


def lexicon(rng, n_words: int = 400) -> list[str]:
    """``n_words`` distinct seeded lower-case words of 2-9 letters: enough
    distinct letter pairs that a BPE of 500 pieces trains on their text."""
    words: set[str] = set()
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(words) < n_words:
        words.add("".join(rng.choice(letters, size=int(rng.integers(2, 10)))))
    return sorted(words)


def _write_utterance(job) -> None:
    from hnet_mamba_asr_torch.data.audio import write_wav
    from hnet_mamba_asr_torch.data.flac import write_flac
    path, seed, samples = job
    wave = synth_audio(np.random.default_rng(seed), 0.0, samples=samples)
    (write_flac if path.endswith(".flac") else write_wav)(path, wave, SR)


def librispeech_tree(root, splits: dict, seed: int, seconds=(2.0, 16.0), wav_every: int = 4,
                     n_words: int = 400, workers: int = 1) -> dict:
    """A seeded synthetic corpus in LibriSpeech's layout under ``root``:
    ``<split>/<speaker>/<chapter>/<speaker>-<chapter>-<nnnn>.{flac,wav}``
    beside ``<speaker>-<chapter>.trans.txt``, ``splits[split]`` utterances of
    ``seconds`` each (every ``wav_every``-th a WAV, the rest FLAC), two
    speakers a split, transcripts of 2.5 words a second from ``lexicon``.
    ``workers`` > 1 encodes in that many spawned processes. -> {split: [(id, text,
    samples)]}."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from pathlib import Path
    rng = np.random.default_rng(seed)
    words = lexicon(rng, n_words)
    jobs, out = [], {}
    for s_i, (split, n) in enumerate(splits.items()):
        out[split] = []
        for i in range(n):
            spk, chap = 100 + 10 * s_i + i % 2, 7
            uid = f"{spk}-{chap}-{i:04d}"
            d = Path(root) / split / str(spk) / str(chap)
            d.mkdir(parents=True, exist_ok=True)
            samples = int(rng.uniform(*seconds) * SR)
            text = " ".join(rng.choice(words, size=max(1, int(2.5 * samples / SR))))
            with open(d / f"{spk}-{chap}.trans.txt", "a") as f:
                f.write(f"{uid} {text.upper()}\n")
            ext = ".wav" if i % wav_every == 0 else ".flac"
            jobs.append((str(d / f"{uid}{ext}"), seed * 1000 + s_i * 100 + i, samples))
            out[split].append((uid, text.upper(), samples))
    if workers > 1:
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(_write_utterance, jobs))
    else:
        for job in jobs:
            _write_utterance(job)
    return out
