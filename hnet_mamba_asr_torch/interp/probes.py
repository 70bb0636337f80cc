"""Linear probes on frozen representations: phone id / phone class / word id.

Counterpart of ``hnet_mamba_asr_tpu/interp/probes.py``. A probe is a plain
multinomial logistic regression, too weak to compute anything itself, so its
accuracy measures what is LINEARLY readable from a representation
(capability spec: reference src/dcasr/interp/probes.py). Labeling geometry:
a 25 Hz frame takes the unit whose interval contains its center time
(0.04*i + 0.0425 s, the frontend+conv timing model); a chunk takes the
majority label over its fine-frame span. ARPA stress digits collapse (AH0 ->
AH); 'spn' (OOV) and silence stay unlabeled; the word probe restricts to the
top-K most frequent TRAINING words with coverage reported. The labeling,
collection and sampling code is the JAX package's, reading the port's
``EncoderOutput`` (tensors on the card, bf16 too) through ``host_array``.

Backends, all minimizing sklearn's EXACT convex objective from zeros
(unique optimum, so they agree): with k > 2 classes the multinomial
0.5*||W||^2 + C * sum_i CE_i, with 2 classes sklearn's binary model, one
penalized weight vector w and an unpenalized intercept b,
0.5*||w||^2 + C * sum_i log(1 + exp(-s_i (w.x_i + b))), s_i = +-1 for
classes[1] / classes[0]:
  - 'torch': L-BFGS (memory 10, Hager-Zhang's approximate Wolfe line
             search) in fp32 on the device (the card by default; TF32 off
             during the fit), stopping at inf-norm(grad) < 1e-5 or
             ``max_iter``, as the JAX package's device backend does; 'jax'
             (the configs' name) aliases here;
  - 'lbfgs': scipy L-BFGS-B on the host in float64 (gtol 1e-4), the plain
             version; 'scipy' aliases here;
  - 'sklearn': where scikit-learn imports; elsewhere (the card's machine has
             none) it raises.
"""
from __future__ import annotations

import math
import random
from collections import Counter
from typing import Mapping, Sequence

import numpy as np
import torch

from hnet_mamba_asr_torch.interp.boundary_align import (
    BOUNDARY_OFFSET_S, FRAME_PERIOD_S, host_array)
from hnet_mamba_asr_torch.utils.logging_utils import get_logger

logger = get_logger(__name__)

FRAME0_CENTER_S = BOUNDARY_OFFSET_S + FRAME_PERIOD_S / 2      # 0.0425

_MANNER = {
    "vowel": "AA AE AH AO AW AY EH ER EY IH IY OW OY UH UW",
    "stop": "B D G K P T",
    "affricate": "CH JH",
    "fricative": "DH F HH S SH TH V Z ZH",
    "nasal": "M N NG",
    "liquid": "L R",
    "glide": "W Y",
}
_PHONE_CLASSES = {phone: manner
                  for manner, phones in _MANNER.items()
                  for phone in phones.split()}
EXCLUDED_PHONES = {"spn"}                         # OOV pseudo-phone


def collapse_stress(phone: str) -> str:
    """AH0/AH1/AH2 -> AH (MFA ARPA phones carry stress digits)."""
    return phone.rstrip("012")


def phone_class(phone: str) -> str | None:
    return _PHONE_CLASSES.get(collapse_stress(phone))


def to_classes(labels: Sequence[str]) -> list[str]:
    """Phones -> manner classes; raises on classless labels (a label reaching
    here without a class is a wiring bug, not data)."""
    classes = []
    for label in labels:
        manner = phone_class(label)
        if manner is None:
            raise ValueError(f"phone {label!r} has no manner class")
        classes.append(manner)
    return classes


def frame_time(i: int) -> float:
    return FRAME_PERIOD_S * i + FRAME0_CENTER_S


def frame_labels(record: Mapping, n_frames: int, tier: str) -> list[str | None]:
    """Per 25 Hz frame: the unit whose interval contains the frame CENTER
    (None where none does — silence / padding)."""
    units = record[tier]
    n = int(n_frames)
    if not units or n <= 0:
        return [None] * n
    centers = FRAME_PERIOD_S * np.arange(n) + FRAME0_CENTER_S
    starts = np.asarray([float(u[1]) for u in units])
    ends = np.asarray([float(u[2]) for u in units])
    # unit index whose start is the last one <= center; then verify coverage
    slot = np.searchsorted(starts, centers, side="right") - 1
    labels: list[str | None] = [None] * n
    for i in range(n):
        k = slot[i]
        if k < 0 or not (centers[i] < ends[k]):
            continue
        text = str(units[k][0])
        if tier == "phones":
            if text in EXCLUDED_PHONES:
                continue
            text = collapse_stress(text)
        labels[i] = text
    return labels


def chunk_spans(b_row: Sequence[float], length: int) -> list[tuple[int, int]]:
    """Boundary vector -> per-chunk [start, end) frame spans, chunk order.

    Mirrors membership = clamp(cumsum(b) - 1, 0): frames BEFORE the first
    boundary merge into chunk 0 (only reachable with duck-typed encoders —
    the production router forces b[0] = 1)."""
    n = int(length)
    if n <= 0:
        return []
    starts = np.nonzero(np.asarray(b_row[:n], dtype=np.float32) >= 0.5)[0]
    starts = starts.tolist() or [0]
    if starts[0] != 0:
        starts[0] = 0
    return list(zip(starts, starts[1:] + [n]))


def majority_label(labels: Sequence[str | None]) -> str | None:
    tally = Counter(l for l in labels if l is not None)
    return tally.most_common(1)[0][0] if tally else None


def collect_probe_data(encode_fn, loader, alignments: Mapping[str, Mapping],
                       tier: str, *, level: str = "frames",
                       stage: int = 0) -> tuple[list, list]:
    """Run the encoder; return (vectors, labels) for labeled positions only.

    level='frames': fine-rate outputs per frame. level='chunks': stage-N chunk
    embeddings labeled by majority over the chunk's fine span (stage 1 spans
    compose through stage-0 chunks). A row's chunks are its first slots of
    the (trimmed) chunk buffer; padded rows past ``ids`` are skipped.

    CONTRACT: probe train/test loaders must cover DISJOINT utterances — the
    reference's audit measured +0.77 accuracy from contamination on a RANDOM
    encoder. The driver asserts this on consumed ids.
    """
    if level not in ("frames", "chunks"):
        raise ValueError(f"level must be 'frames' or 'chunks', got {level!r}")
    vectors, labels = [], []
    for batch in loader:
        ids = batch.get("ids", [])
        enc = encode_fn(batch)
        lengths = host_array(enc.lengths, np.int64)
        if level == "frames":
            feats = host_array(enc.features)
        else:
            hard = [host_array(b) for _, b in enc.boundaries]
            if stage > 0 and len(enc.chunk_embeddings) < 2:
                raise ValueError("stage 1 requested but encoder has one stage")
            zs = host_array(enc.chunk_embeddings[stage])
        for row, uid in enumerate(ids):
            if uid not in alignments:
                continue
            L = int(lengths[row])
            frame_y = frame_labels(alignments[uid], L, tier)
            if level == "frames":
                for i, lab in enumerate(frame_y):
                    if lab is not None:
                        vectors.append(feats[row, i])
                        labels.append(lab)
                continue
            spans = chunk_spans(hard[0][row], L)
            z = zs[row]
            if stage > 0:
                level2 = chunk_spans(hard[1][row], len(spans))  # spans over stage-0 chunks
                spans = [(spans[a][0], spans[b - 1][1])
                         for a, b in level2 if b <= len(spans)]
            for j, (a, b) in enumerate(spans):
                if j >= z.shape[0]:
                    break
                lab = majority_label(frame_y[a:b])
                if lab is not None:
                    vectors.append(z[j])
                    labels.append(lab)
    logger.info("probe data: level=%s tier=%s stage=%d -> %d labeled samples",
                level, tier, stage, len(vectors))
    return vectors, labels


def subsample(X: Sequence, y: Sequence, cap: int, seed: int = 1):
    """Seeded uniform subsample to at most ``cap`` (pairing preserved)."""
    if len(X) <= cap:
        return list(X), list(y)
    keep = list(range(len(X)))
    random.Random(seed).shuffle(keep)
    keep = sorted(keep[:cap])
    return [X[i] for i in keep], [y[i] for i in keep]


def top_k_filter(X: Sequence, y: Sequence, k: int):
    """Keep only the k most frequent labels; returns (X, y, kept fraction).
    Call on the TRAINING side only — the keep-set must come from train
    frequencies (the test side follows via the unseen-class drop)."""
    frequent = {label for label, _ in Counter(y).most_common(k)}
    rows = [i for i, label in enumerate(y) if label in frequent]
    return ([X[i] for i in rows], [y[i] for i in rows],
            len(rows) / max(1, len(y)))


def _encode_labels(y_train) -> tuple[list, np.ndarray]:
    classes = sorted(set(y_train))
    index = {c: i for i, c in enumerate(classes)}
    return classes, np.asarray([index[c] for c in y_train])


def _split_theta(theta, d: int, cols: int):
    return theta[:d * cols].reshape(d, cols), theta[d * cols:]


SCIPY_FTOL = 2.220446049250313e-09      # L-BFGS-B's default relative decrease stop


def lbfgs_weights(X, y, k: int, *, max_iter: int, C: float, gtol: float = 1e-4,
                  ftol: float = SCIPY_FTOL, init=None):
    """scipy L-BFGS-B in float64 on the host (the plain version) on sklearn's
    objective for ``k`` classes (labels ``y`` in 0..k-1), from zeros or from
    ``init`` = (W, bias) -> (W [d, k], or [d, 1] for sklearn's binary model
    at k 2; bias; n_iter; the inf-norm of the final gradient). The probes
    fit from zeros at L-BFGS-B's defaults with gtol 1e-4, as the JAX
    package's. A yardstick optimum takes a small gtol and ftol 0 (no stop on
    the decrease alone); the objective is convex and its optimum's
    probabilities unique, whatever the start."""
    from scipy.optimize import minimize

    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y)
    n, d = X.shape
    cols = 1 if k == 2 else k
    if cols == 1:
        Y = y[:, None].astype(np.float64)
    else:
        Y = np.zeros((n, k))
        Y[np.arange(n), y] = 1.0

    def value_and_grad(theta):
        W, bias = _split_theta(theta, d, cols)
        z = X @ W + bias
        if cols == 1:                                   # log(1 + e^z) - y z
            nll = (np.logaddexp(0.0, z) - Y * z).sum()
            probs = 0.5 * (1.0 + np.tanh(0.5 * z))      # sigmoid without overflow
        else:
            z = z - z.max(axis=1, keepdims=True)
            logZ = np.log(np.exp(z).sum(axis=1))
            nll = (logZ - z[np.arange(n), y]).sum()
            probs = np.exp(z - logZ[:, None])
        g_logits = C * (probs - Y)
        return (0.5 * (W ** 2).sum() + C * nll,
                np.concatenate([(X.T @ g_logits + W).ravel(), g_logits.sum(axis=0)]))

    theta0 = (np.zeros(d * cols + cols) if init is None else
              np.concatenate([np.ravel(init[0]), np.ravel(init[1])]).astype(np.float64))
    sol = minimize(value_and_grad, theta0, jac=True,
                   method="L-BFGS-B",
                   options={"maxiter": int(max_iter), "gtol": float(gtol),
                            "ftol": float(ftol)})
    W, bias = _split_theta(sol.x, d, cols)
    return W, bias, int(sol.nit), float(np.abs(sol.jac).max())


TORCH_GTOL = 1e-5            # the JAX device backend's stop: inf-norm(grad) < 1e-5
LBFGS_MEMORY = 10            # optax.lbfgs's and L-BFGS-B's default memory
# Hager-Zhang's approximate Wolfe line search: a step t is taken when the
# slope along d has flattened (phi'(t) >= SIGMA phi'(0)) and not turned up
# past (2 DELTA - 1) phi'(0), and the objective has not risen by more than
# EPS |f|. Near the optimum the decrease an fp32 step makes is below the
# rounding of f itself, so sufficient decrease is judged from the slopes,
# which fp32 still resolves (the objective is convex: phi' is monotone).
SIGMA, DELTA, EPS = 0.9, 0.1, 1e-6
MAX_LINE_EVALS = 25


def torch_lbfgs_weights(X, y, k: int, *, max_iter: int, C: float, device="cuda"):
    """L-BFGS in fp32 on ``device`` (the card by default; without one it
    raises) on sklearn's objective for ``k`` classes, from zeros ->
    (W [d, k] or [d, 1] at k 2 and bias as float32 numpy arrays, n_iter, the
    inf-norm of the final gradient).

    It stops at inf-norm(grad) < 1e-5 or after ``max_iter`` updates, as the
    JAX package's device backend does, or where a line search finds no step
    (fp32 can make no further progress). An evaluation is one product
    X @ W and one X.T @ G, the gradient in closed form; TF32 is off during
    the fit and restored after."""
    from hnet_mamba_asr_torch.serving.runtime import require_device

    dev = require_device(device)
    X = torch.as_tensor(np.asarray(X, dtype=np.float32), device=dev)
    y = torch.as_tensor(np.asarray(y, dtype=np.int64), device=dev)
    n, d = X.shape
    cols = 1 if k == 2 else k
    Y = (y[:, None].float() if cols == 1
         else torch.nn.functional.one_hot(y, k).float())

    def evaluate(theta):
        """-> (objective as a float, accumulated in float64; gradient)."""
        W, bias = _split_theta(theta, d, cols)
        z = X @ W + bias
        if cols == 1:
            nll = torch.nn.functional.softplus(z) - Y * z
            probs = torch.sigmoid(z)
        else:
            lse = torch.logsumexp(z, dim=1)
            nll = lse - z.gather(1, y[:, None])[:, 0]
            probs = torch.exp(z - lse[:, None])
        g_logits = C * (probs - Y)
        grad = torch.cat([(X.T @ g_logits + W).reshape(-1), g_logits.sum(dim=0)])
        f = 0.5 * (W.double() ** 2).sum() + C * nll.double().sum()
        return f.item(), grad

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            theta = torch.zeros(d * cols + cols, device=dev)
            f, g = evaluate(theta)
            pairs: list[tuple[torch.Tensor, torch.Tensor, float]] = []
            n_iter = 0
            while n_iter < max_iter and g.abs().max().item() >= TORCH_GTOL:
                direction = _two_loop(g, pairs)
                slope0 = torch.dot(g, direction).item()
                if slope0 >= 0:                      # not a descent direction: restart
                    pairs.clear()
                    direction, slope0 = -g, -torch.dot(g, g).item()
                t0 = 1.0 if pairs else min(1.0, 1.0 / g.abs().sum().item())
                step = _line_search(evaluate, theta, direction, f, slope0, t0)
                if step is None:
                    break
                t, f, g_new = step
                s_vec, y_vec = t * direction, g_new - g
                ys = torch.dot(y_vec, s_vec).item()
                if ys > 0:
                    pairs.append((s_vec, y_vec, 1.0 / ys))
                    del pairs[:-LBFGS_MEMORY]
                theta = theta + s_vec
                g = g_new
                n_iter += 1
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    W, bias = _split_theta(theta, d, cols)
    return W.cpu().numpy(), bias.cpu().numpy(), n_iter, g.abs().max().item()


def _two_loop(g: torch.Tensor, pairs) -> torch.Tensor:
    """The L-BFGS direction -H g from the stored (s, y, 1 / y.s) pairs, H0 =
    (s.y / y.y) I from the newest pair."""
    q = g.clone()
    alphas = []
    for s_vec, y_vec, rho in reversed(pairs):
        a = rho * torch.dot(s_vec, q)
        q -= a * y_vec
        alphas.append(a)
    if pairs:
        s_vec, y_vec, rho = pairs[-1]
        q *= 1.0 / (rho * torch.dot(y_vec, y_vec))
    for (s_vec, y_vec, rho), a in zip(pairs, reversed(alphas)):
        q += (a - rho * torch.dot(y_vec, q)) * s_vec
    return -q


def _line_search(evaluate, theta, direction, f0: float, slope0: float, t: float):
    """A step along ``direction`` meeting the approximate Wolfe conditions
    (SIGMA, DELTA, EPS above) -> (t, f, grad), or None after MAX_LINE_EVALS
    evaluations without one. Expands by 2 until the slope has flattened, then
    takes secant steps on the slope inside the bracket."""
    lo, slope_lo, hi, slope_hi = 0.0, slope0, math.inf, 0.0
    for _ in range(MAX_LINE_EVALS):
        f, g = evaluate(theta + t * direction)
        slope = torch.dot(g, direction).item()
        if f > f0 + EPS * abs(f0) or slope > (2 * DELTA - 1) * slope0:
            hi, slope_hi = t, slope                  # past the minimum along d
        elif slope < SIGMA * slope0:
            lo, slope_lo = t, slope                  # still steep
        else:
            return t, f, g
        if math.isinf(hi):
            t = 2.0 * t
        else:
            width = hi - lo
            secant = (lo - slope_lo * width / (slope_hi - slope_lo)
                      if slope_hi > slope_lo else lo + 0.5 * width)
            t = min(max(secant, lo + 0.1 * width), hi - 0.1 * width)
    return None


def predict_proba(W, bias, X) -> np.ndarray:
    """Class probabilities [n, k] in float64 of a fit's weights (sklearn's
    binary model where W has one column: [1 - p, p])."""
    z = np.asarray(X, dtype=np.float64) @ np.asarray(W, np.float64) + np.asarray(
        bias, np.float64)
    if z.shape[1] == 1:
        p = 0.5 * (1.0 + np.tanh(0.5 * z[:, 0]))
        return np.stack([1.0 - p, p], axis=1)
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def _decide(W, bias, X_test, classes) -> np.ndarray:
    scores = np.asarray(X_test, dtype=np.float64) @ np.asarray(W, np.float64) + bias
    picks = (scores[:, 0] > 0).astype(int) if scores.shape[1] == 1 else scores.argmax(axis=1)
    return np.asarray([classes[i] for i in picks])


def _lbfgs_fit(X_train, y_train, X_test, *, max_iter: int, C: float):
    """scipy L-BFGS-B on sklearn's exact objective -> (predictions, n_iter)."""
    classes, y = _encode_labels(y_train)
    W, bias, n_iter, _ = lbfgs_weights(X_train, y, len(classes), max_iter=max_iter, C=C)
    return _decide(W, bias, X_test, classes), n_iter


def _torch_lbfgs_fit(X_train, y_train, X_test, *, max_iter: int, C: float, device):
    """The device L-BFGS on sklearn's exact objective -> (predictions,
    n_iter); the decisions are taken on the host from the fp32 weights."""
    classes, y = _encode_labels(y_train)
    W, bias, n_iter, _ = torch_lbfgs_weights(X_train, y, len(classes), max_iter=max_iter,
                                             C=C, device=device)
    return _decide(W, bias, X_test, classes), n_iter


def _sklearn_fit(X_train, y_train, X_test, *, max_iter: int, C: float, seed: int):
    try:
        from sklearn.linear_model import LogisticRegression
    except ImportError as err:
        raise RuntimeError(
            "probe backend 'sklearn' needs scikit-learn, which does not import here "
            f"({err}); use backend 'torch' (L-BFGS on the card) or 'lbfgs' "
            "(scipy on the host)") from err
    model = LogisticRegression(max_iter=max_iter, C=C, random_state=seed)
    model.fit(np.asarray(X_train), y_train)
    return model.predict(np.asarray(X_test)), int(np.max(model.n_iter_))


def balanced_accuracy(y_true, y_pred) -> float:
    """The mean over the classes present in ``y_true`` of their recall
    (sklearn's ``balanced_accuracy_score``, unadjusted)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float(np.mean([np.mean(y_pred[y_true == c] == c) for c in np.unique(y_true)]))


_BACKEND_ALIASES = {"jax": "torch", "scipy": "lbfgs"}


def train_probe(X_train, y_train, X_test, y_test, *, max_iter: int = 200,
                C: float = 1.0, seed: int = 1, backend: str = "torch",
                device="cuda") -> dict:
    """Fit + score a probe vs majority/chance baselines; ``device`` is the
    'torch' backend's (the card by default).

    Test items whose class never appears in training are dropped and counted
    in ``n_test_dropped_unseen`` — report it beside accuracy (on skewed labels
    the headline could otherwise describe under half the frames)."""
    backend = _BACKEND_ALIASES.get(backend, backend)
    if backend not in ("sklearn", "lbfgs", "torch"):
        raise ValueError(
            f"backend must be 'torch', 'lbfgs' or 'sklearn', got {backend!r}")
    seen_classes = set(y_train)
    if len(seen_classes) < 2:
        raise ValueError(f"probe needs >= 2 training classes, got {len(seen_classes)}")
    keep = [i for i, label in enumerate(y_test) if label in seen_classes]
    dropped = len(y_test) - len(keep)
    X_test = [X_test[i] for i in keep]
    y_test = [y_test[i] for i in keep]
    if not y_train or not y_test:
        raise ValueError("empty probe train or test set")
    if backend == "sklearn":
        predictions, n_iter = _sklearn_fit(X_train, y_train, X_test, max_iter=max_iter,
                                           C=C, seed=seed)
    elif backend == "torch":
        predictions, n_iter = _torch_lbfgs_fit(X_train, y_train, X_test,
                                               max_iter=max_iter, C=C, device=device)
    else:
        predictions, n_iter = _lbfgs_fit(X_train, y_train, X_test,
                                         max_iter=max_iter, C=C)
    majority = Counter(y_train).most_common(1)[0][0]
    return {"accuracy": float(np.mean(predictions == np.asarray(y_test))),
            "balanced_accuracy": balanced_accuracy(y_test, predictions),
            "majority_baseline": sum(l == majority for l in y_test) / len(y_test),
            "chance": 1.0 / len(seen_classes), "n_classes": len(seen_classes),
            "n_train": len(y_train), "n_test": len(y_test),
            "n_test_dropped_unseen": dropped,
            "n_iter": n_iter, "backend": backend}
