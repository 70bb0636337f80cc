"""Serve an exported ASR artifact over HTTP with micro-batching.

Thin CLI over ``hnet_mamba_asr_torch/serving/server.py``:

    python -m hnet_mamba_asr_torch.scripts.serve <artifact_dir> [--port 8000] \
        [--max-wait-ms 20] [--device cuda]
"""
from hnet_mamba_asr_torch.serving.server import main

if __name__ == "__main__":
    main()
