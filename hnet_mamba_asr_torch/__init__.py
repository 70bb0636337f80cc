"""PyTorch and CUDA port of hnet_mamba_asr_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths (``ops/ssd.py``, ``models/mamba2.py``,
...) and is held against it by the tests in ``tests/test_torch_*.py``. It
imports ``torch`` and never ``jax``.
"""
