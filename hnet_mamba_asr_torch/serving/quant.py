"""Weight-only int8 quantization for serving artifacts, in numpy.

Counterpart of ``hnet_mamba_asr_tpu/serving/quant.py``, over the param tree
in the JAX layout (``convert.py::state_dict_to_jax_tree``), whose channel
axis is the last one: quantize before the tree becomes torch tensors (a
torch ``Linear.weight`` is [out, in], so its scales would fall on the wrong
axis). Symmetric per-output-channel absmax; for a kernel w[..., out]:

    scale[out] = max|w[..., out]| / 127        (0 -> 1, avoids div-by-zero)
    q8 = round(w / scale)  in [-127, 127]
    w' = q8 * scale        (max elementwise error scale/2)

Only floating leaves with ndim >= 2 and size >= ``min_size`` quantize;
biases, norm scales and per-head vectors stay as they are. A quantized leaf
becomes the subtree {"~q8": int8, "~scale": f32}, as in JAX, so a
``params.npz`` holds the same keys in both packages.

The port dequantizes once, at load (``dequantize_tree``, the JAX
expression ``q8.astype(float32) * scale``, so the fp32 weights equal JAX's
bit for bit). JAX fuses the dequantize into each matmul of its traced
program; the port has no int8 GEMM, so int8 shrinks the artifact and not
the weight traffic of a call.
"""
from __future__ import annotations

import numpy as np

Q8_KEY, SCALE_KEY = "~q8", "~scale"


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def quantize_tree(params, min_size: int = 4096):
    """fp params tree -> same tree with large >=2-D leaves int8-quantized."""
    def q(leaf):
        a = np.asarray(leaf)
        if a.ndim < 2 or a.size < min_size or not np.issubdtype(a.dtype, np.floating):
            return a
        a = a.astype(np.float32)
        amax = np.max(np.abs(a), axis=tuple(range(a.ndim - 1)))
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q8 = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
        return {Q8_KEY: q8, SCALE_KEY: scale}
    return _map(q, params)


def _is_q(node) -> bool:
    return isinstance(node, dict) and set(node) == {Q8_KEY, SCALE_KEY}


def dequantize_tree(qparams):
    """Inverse of quantize_tree: every quantized leaf back to fp32 (a tree
    with none comes back as it was)."""
    if _is_q(qparams):
        return np.asarray(qparams[Q8_KEY]).astype(np.float32) * np.asarray(qparams[SCALE_KEY])
    if isinstance(qparams, dict):
        return {k: dequantize_tree(v) for k, v in qparams.items()}
    if isinstance(qparams, (list, tuple)):
        return type(qparams)(dequantize_tree(v) for v in qparams)
    return qparams


def quantization_error(params, qparams) -> float:
    """Max |w - dq(q(w))| / channel-amax over quantized leaves (<= 1/254)."""
    if _is_q(qparams):
        w = np.asarray(params, np.float32)
        dq = qparams[Q8_KEY].astype(np.float32) * qparams[SCALE_KEY]
        amax = np.maximum(np.max(np.abs(w), axis=tuple(range(w.ndim - 1))), 1e-12)
        return float(np.max(np.abs(w - dq) / amax))
    if isinstance(qparams, dict):
        return max([0.0] + [quantization_error(params[k], v) for k, v in qparams.items()])
    if isinstance(qparams, (list, tuple)):
        return max([0.0] + [quantization_error(p, v) for p, v in zip(params, qparams)])
    return 0.0
