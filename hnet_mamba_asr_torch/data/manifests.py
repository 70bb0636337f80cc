"""JSONL manifests from a LibriSpeech-layout corpus, counterpart of
``hnet_mamba_asr_tpu/data/manifests.py``.

``build_manifest`` scans ``<root>/<split>/*/*/*.trans.txt`` and writes one
line ``{"id", "audio", "text", "frames"}`` per transcript line whose audio
(``<id>.wav``, else ``<id>.flac``) sits beside it; ``frames`` is the sample
count, read from the WAV or FLAC header without decoding. ``load_manifest``
and ``write_manifest`` live in ``data/audio.py``.
"""
from __future__ import annotations

import glob
import json
import logging
import os
from pathlib import Path

from hnet_mamba_asr_torch.data.audio import audio_info

logger = logging.getLogger(__name__)

TRAIN_960 = ["train-clean-100", "train-clean-360", "train-other-500"]
WIN_LENGTH, HOP_LENGTH = 400, 160
SAMPLE_RATE = 16000


def feat_frames(n_samples: int) -> int:
    """Feature-frame count for an n-sample waveform (frontend contract)."""
    return max(0, 1 + (n_samples - WIN_LENGTH) // HOP_LENGTH)


def build_manifest(librispeech_root, splits, out_path) -> Path:
    """Scan LibriSpeech-style splits -> a JSONL manifest; returns its path."""
    root, out_path = Path(librispeech_root), Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with open(out_path, "w") as w:
        for split in splits:
            for tf in sorted(glob.glob(str(root / split / "*" / "*" / "*.trans.txt"))):
                d = os.path.dirname(tf)
                with open(tf) as f:
                    for line in f:
                        uid, _, text = line.strip().partition(" ")
                        if not text:
                            continue
                        audio = None
                        for ext in (".wav", ".flac"):
                            cand = os.path.join(d, uid + ext)
                            if os.path.exists(cand):
                                audio = cand
                                break
                        if audio is None:
                            logger.warning("no audio for %s", uid)
                            continue
                        frames = (audio_info(audio)["frames"] if audio.endswith(".wav")
                                  else _flac_frames(audio))
                        w.write(json.dumps({"id": uid, "audio": audio, "text": text,
                                            "frames": frames}) + "\n")
                        n += 1
                        if n % 50000 == 0:
                            logger.info("manifest: %d utterances scanned", n)
    logger.info("manifest written: %d utterances -> %s", n, out_path)
    return out_path


def _flac_frames(path: str) -> int:
    """Total samples from a FLAC STREAMINFO header (no payload decode)."""
    with open(path, "rb") as f:
        if f.read(4) != b"fLaC":
            raise ValueError(f"{path}: not a FLAC file")
        f.read(4)                                     # STREAMINFO's block header
        info = f.read(34)
    return ((info[13] & 0x0F) << 32) | int.from_bytes(info[14:18], "big")
