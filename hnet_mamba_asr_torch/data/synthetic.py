"""Deterministic synthetic tone-word corpora, counterpart of
``hnet_mamba_asr_tpu/data/synthetic.py`` (the port keeps its own copy): each
"word" is a pure tone at a word-specific frequency and an utterance is a
short sequence of them, so a correctly wired train -> decode -> score
pipeline drives CTC-greedy WER to ~0 (the overfit gate of
``tests/test_overfit_gate.py`` and ``scripts/analysis/overfit_gate.py``).
The corpus layout is deterministic, so its forced alignments are known
analytically (``tone_alignment_records``, the interpretability gate's truth).

``overfit_config`` returns the gate's config as a dict, where the JAX
package returns YAML text: the port takes config dicts (the card's machine
has no PyYAML).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from hnet_mamba_asr_torch.data.audio import write_wav, write_manifest

SAMPLE_RATE = 16000

# Word -> tone frequency (Hz). Spread across the mel range so every word owns
# distinct filterbank bins even at n_mels=20.
TONE_WORDS = {"a": 330.0, "b": 740.0, "c": 1560.0, "d": 3100.0}

# The corpus timing grid: tone_word / tone_utterance synthesize with these.
WORD_S = 0.25
GAP_S = 0.08


def tone_word(word: str, *, duration_s: float = WORD_S,
              sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """One word: a ramped sine at the word's frequency."""
    t = np.arange(int(duration_s * sample_rate)) / sample_rate
    sig = 0.3 * np.sin(2 * np.pi * TONE_WORDS[word] * t)
    n = len(t)
    env = np.minimum(1.0, np.minimum(np.arange(n), np.arange(n)[::-1]) / 400.0)
    return sig * env


def tone_utterance(words: list[str], rng: np.random.Generator, *,
                   gap_s: float = GAP_S, noise: float = 0.01,
                   sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Words separated by silence gaps, plus a low noise floor."""
    gap = np.zeros(int(gap_s * sample_rate))
    parts = [gap]
    for w in words:
        parts += [tone_word(w, sample_rate=sample_rate), gap]
    wave = np.concatenate(parts)
    return wave + noise * rng.standard_normal(len(wave))


def build_tone_corpus(root: str | Path, *, n_utts: int = 24, seed: int = 0,
                      min_words: int = 2, max_words: int = 5,
                      dev_utts: int = 8) -> list[dict]:
    """WAVs + manifests under ``root``: train-960 = all utts, test-clean = all
    utts (the overfit gate scores the training data), dev-clean = a slice.

    Fully determined by ``seed`` — the corpus regenerates bit-identically.
    """
    root = Path(root)
    (root / "manifests").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    vocab = list(TONE_WORDS)
    entries = []
    for i in range(n_utts):
        k = int(rng.integers(min_words, max_words + 1))
        words = [vocab[int(j)] for j in rng.integers(0, len(vocab), size=k)]
        wave = tone_utterance(words, rng)
        path = root / f"u{i}.wav"
        write_wav(path, wave, SAMPLE_RATE)
        entries.append({"id": f"u{i}", "audio": str(path),
                        "text": " ".join(words), "frames": len(wave)})
    write_manifest(entries, root / "manifests" / "train-960.jsonl")
    write_manifest(entries[:dev_utts], root / "manifests" / "dev-clean.jsonl")
    write_manifest(entries, root / "manifests" / "test-clean.jsonl")
    return entries


def build_tone_corpus_heldout(root: str | Path, *, n_train: int = 96,
                              n_dev: int = 8, n_eval: int = 12, seed: int = 0,
                              min_words: int = 2, max_words: int = 5
                              ) -> tuple[list[dict], list[dict], list[dict]]:
    """Train/dev/eval corpora with PAIRWISE-DISJOINT word sequences.

    The overfit gate scores the training utterances, so it can only prove
    memorization. This builder is the held-out
    analogue of the reference's evaluation design (reference:
    src/dcasr/eval/score.py:187-209 gates test-clean, a split the model
    never trained on; src/dcasr/tasks/build.py:121-129 keeps dev unsharded
    because it is held out):

      - no dev or eval WORD SEQUENCE (as an ordered tuple) ever appears in
        train — decoding them right requires the audio->token map to
        generalize, not a lookup;
      - each split synthesizes waveforms from its OWN noise stream
        (seed, split)-keyed, so even a shared sequence could not share a
        waveform bit pattern;
      - every vocabulary word is guaranteed to appear in train (coverage —
        generalization to unseen SEQUENCES, not unseen WORDS, is the claim).

    Writes train-960 / dev-clean / test-clean manifests under ``root`` and
    returns the three entry lists. Fully determined by ``seed``.
    """
    root = Path(root)
    (root / "manifests").mkdir(parents=True, exist_ok=True)
    vocab = list(TONE_WORDS)
    seq_rng = np.random.default_rng((seed, 0xC0))
    need = n_train + n_dev + n_eval
    seqs: list[tuple[str, ...]] = []
    seen: set[tuple[str, ...]] = set()
    while len(seqs) < need:
        k = int(seq_rng.integers(min_words, max_words + 1))
        s = tuple(vocab[int(j)] for j in seq_rng.integers(0, len(vocab), k))
        if s not in seen:                    # uniqueness => disjoint splits
            seen.add(s)
            seqs.append(s)
    train_seqs = seqs[:n_train]
    covered = {w for s in train_seqs for w in s}
    assert covered == set(vocab), f"train split missing words: {covered}"

    splits = {"train-960": (train_seqs, "tr"),
              "dev-clean": (seqs[n_train:n_train + n_dev], "dv"),
              "test-clean": (seqs[n_train + n_dev:], "ev")}
    out: dict[str, list[dict]] = {}
    for si, (split, (split_seqs, tag)) in enumerate(splits.items()):
        wave_rng = np.random.default_rng((seed, 0xA0 + si))  # fresh noise
        entries = []
        for i, words in enumerate(split_seqs):
            # jitter the TRAIN noise floor per utterance: identical noise
            # statistics across train utterances let the tiny model key on
            # the noise realization itself; varied amplitude forces the
            # tone->token map to carry the decision (held-out splits keep
            # the fixed default floor — the gate's difficulty is unchanged)
            amp = (float(wave_rng.uniform(0.004, 0.02))
                   if split == "train-960" else 0.01)
            wave = tone_utterance(list(words), wave_rng, noise=amp)
            path = root / f"{tag}{i}.wav"
            write_wav(path, wave, SAMPLE_RATE)
            entries.append({"id": f"{tag}{i}", "audio": str(path),
                            "text": " ".join(words), "frames": len(wave)})
        write_manifest(entries, root / "manifests" / f"{split}.jsonl")
        out[split] = entries
    tr, dv, ev = (out["train-960"], out["dev-clean"], out["test-clean"])
    tr_set = {e["text"] for e in tr}
    assert not tr_set & {e["text"] for e in dv}
    assert not tr_set & {e["text"] for e in ev}
    return tr, dv, ev


def overfit_config(root: str | Path, *, compression_n: int = 1,
                   max_epoch: int = 40, lr: float = 3e-3,
                   ratio_weight: float = 0.03, d_model: int = 32,
                   batch_bins: int = 8000, precision: str = "fp32",
                   valid_interval: int = 10, scan_steps: int = 1,
                   arch_type: str = "A", ctc_weight: float = 1.0,
                   aed_weight: float = 0.0) -> dict:
    """The gate config as a dict: tiny Type A model, CTC-only, no SpecAug
    (the keys and values of the JAX package's YAML text).

    ``compression_n`` > 1 turns on real H-Net dynamic chunking (the N=2
    router-stability runs); the ratio loss then pulls kept_fraction to ~1/N.
    """
    root = Path(root)
    hnet = {"compression_N": int(compression_n)}
    if compression_n > 1:
        hnet["router_lr_mult"] = 0.1
    return {
        "experiment": {"name": "overfit_gate", "seed": 0},
        "data": {"manifests_dir": f"{root}/manifests", "train_manifest": "train-960",
                 "dev_splits": ["dev-clean"], "eval_splits": ["test-clean"]},
        "bpemodel": f"{root}/tok/bpe.model",
        "frontend_conf": {"sample_rate": 16000, "n_mels": 20, "win_length": 400,
                          "hop_length": 160, "cmvn": f"{root}/cmvn.npz"},
        "specaug_conf": None,
        "encoder": "dcasr",
        "encoder_conf": {"arch_type": arch_type, "d_outer": d_model, "d_main": d_model,
                         "n_enc": 1, "n_main": 1, "n_dec": 1, "n_mid": 1, "d_state": 16,
                         "headdim": 16, "ssd_chunk_size": 32, "dropout": 0.0,
                         "hnet": hnet},
        "head": "ctc",
        "model_conf": {"ctc_weight": ctc_weight, "aed_weight": aed_weight,
                       "ratio_weight": ratio_weight},
        "batch_bins": batch_bins,
        "optim": "adamw",
        "optim_conf": {"lr": lr, "weight_decay": 0.0},
        "scheduler": "warmuplr",
        "scheduler_conf": {"warmup_steps": 30},
        "train": {"max_epoch": max_epoch, "grad_clip": 5.0, "precision": precision,
                  "log_interval": 10, "scan_steps": scan_steps},
        "eval": {"valid_interval_epoch": valid_interval},
        "best_model_criterion": [["valid", "loss", "min"]],
        "keep_nbest_models": 2,
        "decode": {"read_outs": ["ctc"], "search": ["greedy"], "lm": "disabled",
                   "batch_bins": batch_bins},
        "score": {"gate_cell": "ctc_greedy"},
        "goal": {"sane_test_clean_wer_below": 12.0},
    }


# Tone word -> a stand-in ARPA phone with a real manner class (vowel /
# fricative / nasal: interp/probes.py ``_MANNER``), so the phone-class probe
# has more than one class to separate on the synthetic corpus.
TONE_PHONES = {"a": "AA", "b": "IY", "c": "S", "d": "M"}


def tone_alignment_records(entries: list[dict]) -> list[dict]:
    """Exact forced alignments for a ``build_tone_corpus`` corpus: the layout
    is gap, word, gap, word, ..., so every word's interval is known, the
    synthetic analogue of the aligner's TextGrids. Each word doubles as a
    single phone (``TONE_PHONES``) so both probe tiers are populated."""
    records = []
    for e in entries:
        words, phones = [], []
        for i, w in enumerate(e["text"].split()):
            start = GAP_S + i * (WORD_S + GAP_S)
            end = start + WORD_S
            words.append([w, round(start, 6), round(end, 6)])
            phones.append([TONE_PHONES[w], round(start, 6), round(end, 6)])
        records.append({"id": e["id"], "words": words, "phones": phones})
    return records
