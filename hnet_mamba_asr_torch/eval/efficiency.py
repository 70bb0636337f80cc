"""Analytic efficiency accounting: parameter counts + inference GFLOPs.

Counterpart of ``hnet_mamba_asr_tpu/eval/efficiency.py`` (host code; the
closed forms are a copy). Derives params/FLOPs in closed form from the SAME
config keys the build seam consumes, so efficiency tables come from the run
config rather than a profiler (capability spec: reference
src/dcasr/eval/efficiency.py — the accounting CONVENTIONS are kept identical
so numbers are comparable across the frameworks). Heads are counted by
instantiating the port's own modules on the CPU (exact by construction);
encoder closed forms are pinned against instantiated models in tests, and
the production Small config reproduces the published 78.9M.

FLOP policy (recorded in every report): 1 MAC = 2 FLOPs; matmul/conv/SSD-scan
terms only; biases, norms, activations, gates, residuals, reductions, gathers
excluded (sub-percent). The Mamba-2 SSD scan is counted as the linear
recurrence (2 * d_inner * d_state MACs/token) — the ALGORITHMIC count; the
chunked-SSD kernel executes ~2.1x that matmul work, and all cross-cell
comparisons share the convention. The EMA dechunk smoother is counted as
implemented: one causal LxL matmul, 2 * L^2 * d.

Internal design: one stage-spec walk (`_stage_table`) yields every encoder
stage with its parameter count and FLOP count, and the public
``encoder_params`` / ``encoder_flops`` are projections of that table.
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping

from hnet_mamba_asr_torch.utils.logging_utils import get_logger

logger = get_logger(__name__)

MAMBA2_DEFAULTS = dict(d_state=128, d_conv=4, expand=2, headdim=64, ngroups=1)

ASSUMPTIONS = [
    "1 MAC = 2 FLOPs; matmul/conv/scan terms only",
    "biases, norms, activations, gates, residuals, reductions, gathers excluded (<1%)",
    "Mamba-2 SSD scan counted as the linear recurrence (2*d_inner*d_state MACs/token)"
    " = ALGORITHMIC flops; the chunked-SSD kernel executes ~2.1x that matmul work",
    "EMA smoother counted as implemented: one causal matmul, 2*L^2*d per utterance",
    "input frames = 100 * audio_seconds (100 Hz frontend), one utterance per report",
    "compressed lengths = keep_fraction * L0 as continuous expectations",
    "AED secondary numbers assume a KV-cached decoder; measured decode RTF is the"
    " ground truth for decode speed",
]


# ── Mamba-2 dimension helpers ─────────────────────────────────────────────────
def _dims(d_model: int, d_state: int, expand: int, headdim: int, ngroups: int):
    d_inner = expand * d_model
    if d_inner % headdim:
        raise ValueError(f"expand*d_model ({d_inner}) not divisible by "
                         f"headdim ({headdim}) — no such Mamba2 exists")
    nheads = d_inner // headdim
    return (d_inner, nheads,
            2 * d_inner + 2 * ngroups * d_state + nheads,   # d_in_proj
            d_inner + 2 * ngroups * d_state)                # conv_dim


def mamba2_params(d_model: int, *, d_state: int = 128, d_conv: int = 4,
                  expand: int = 2, headdim: int = 64, ngroups: int = 1) -> int:
    d_inner, nheads, d_in_proj, conv_dim = _dims(d_model, d_state, expand,
                                                 headdim, ngroups)
    pieces = (d_model * d_in_proj,        # in_proj (bias-free)
              conv_dim * d_conv + conv_dim,  # depthwise conv w + b
              3 * nheads,                 # A_log, D, dt_bias
              d_inner,                    # gated-RMSNorm gain
              d_inner * d_model)          # out_proj (bias-free)
    return sum(pieces)


def mamba2_flops_per_token(d_model: int, *, d_state: int = 128, d_conv: int = 4,
                           expand: int = 2, headdim: int = 64,
                           ngroups: int = 1) -> float:
    d_inner, _, d_in_proj, conv_dim = _dims(d_model, d_state, expand,
                                            headdim, ngroups)
    macs = (d_model * d_in_proj + conv_dim * d_conv
            + 2 * d_inner * d_state      # scan: state update + readout
            + d_inner * d_model)
    return 2.0 * macs


def mamba_stack_params(n_layers: int, d_model: int, bidirectional: bool = True,
                       **mamba_kw) -> int:
    directions = 2 if bidirectional else 1
    per_block = 2 * d_model + directions * mamba2_params(d_model, **mamba_kw)
    return n_layers * per_block + 2 * d_model             # + final LayerNorm


def mamba_stack_flops(n_layers: int, d_model: int, n_tokens: float,
                      bidirectional: bool = True, **mamba_kw) -> float:
    directions = 2 if bidirectional else 1
    return (n_layers * directions * n_tokens
            * mamba2_flops_per_token(d_model, **mamba_kw))


# ── other stage closed forms ──────────────────────────────────────────────────
def subsampled_frames(n_frames: int) -> int:
    """Valid 25 Hz length after two k=3, s=2 VALID convs."""
    return max(((n_frames - 1) // 2 - 1) // 2, 0)


def conv_subsample_params(n_mels: int, d_model: int) -> int:
    f_out = ((n_mels - 1) // 2 - 1) // 2
    return (d_model * 9 + d_model                  # conv1 (1 in-ch, 3x3)
            + d_model * d_model * 9 + d_model      # conv2
            + d_model * f_out * d_model + d_model)  # flatten-freq projection


def conv_subsample_flops(n_frames: int, n_mels: int, d_model: int) -> float:
    t1, f1 = (n_frames - 1) // 2, (n_mels - 1) // 2
    t2, f2 = (t1 - 1) // 2, (f1 - 1) // 2
    macs = (t1 * f1 * 9 * d_model
            + t2 * f2 * 9 * d_model * d_model
            + t2 * f2 * d_model * d_model)
    return 2.0 * macs


def chunker_params(kind: str, d_model: int, N: float) -> int:
    """Only dynamic chunking at N > 1 carries parameters (router W_q + W_k)."""
    active = str(kind).lower() == "dynamic" and N != 1
    return 2 * d_model * d_model if active else 0


def router_flops(d_model: int, n_tokens: float) -> float:
    return 2.0 * 2 * d_model * d_model * n_tokens         # W_q + W_k per frame


def ema_flops(n_tokens: float, d_model: int) -> float:
    return 2.0 * n_tokens * n_tokens * d_model            # causal LxL matmul


def ctc_head_flops(d_model: int, vocab_size: int, n_tokens: float) -> float:
    return 2.0 * n_tokens * d_model * (vocab_size + 1)


def count_params(module) -> int:
    """Total parameter elements of a torch module."""
    return sum(p.numel() for p in module.parameters())


# ── config adapter ────────────────────────────────────────────────────────────
def _arch(enc: Mapping[str, Any], n_mels: int) -> dict:
    hnet = dict(enc.get("hnet", {}) or {})
    arch_type = str(enc["arch_type"])
    if arch_type not in ("A", "B"):
        raise ValueError(f"arch_type must be 'A' or 'B', got {arch_type!r}")
    n = int(hnet.get("compression_N", 1))
    chunker = str(hnet.get("chunker", "dynamic")).lower()
    if arch_type == "B" and chunker == "fixed" and (n ** 0.5) % 1 != 0:
        raise ValueError(f"Type B fixed-pool needs a perfect-square N, got {n}")
    return {"type": arch_type, "N": n,
            "n_stages": 1 if arch_type == "A" else 2,
            "kept_default": ([1.0 / n] if arch_type == "A"
                             else [1.0 / n ** 0.5] * 2),
            "n_mels": int(n_mels), "d_outer": int(enc["d_outer"]),
            "d_main": int(enc["d_main"]), "n_enc": int(enc["n_enc"]),
            "n_main": int(enc["n_main"]), "n_dec": int(enc["n_dec"]),
            "n_mid": int(enc.get("n_mid", 4)),
            "bidir": bool(enc.get("bidirectional", True)),
            "chunker": chunker, "ema": bool(hnet.get("ema_smoothing", True)),
            "mamba_kw": {"d_state": int(enc.get("d_state", 128)),
                         "d_conv": int(enc.get("d_conv", 4)),
                         "expand": int(enc.get("expand", 2)),
                         "headdim": int(enc.get("headdim", 64))}}


def _stage_table(a: dict, n_frames: int, kept: list[float],
                 use_ema: bool) -> Iterator[tuple[str, int, float]]:
    """Yield (stage, params, flops) for one utterance of ``n_frames`` input."""
    kw = a["mamba_kw"]
    l0 = float(subsampled_frames(n_frames))
    stack_p = lambda n, d: mamba_stack_params(n, d, a["bidir"], **kw)
    stack_f = lambda n, d, t: mamba_stack_flops(n, d, t, a["bidir"], **kw)
    proj_p = ((a["d_outer"] * a["d_main"] + a["d_main"])
              + (a["d_main"] * a["d_outer"] + a["d_outer"]))

    yield ("subsample", conv_subsample_params(a["n_mels"], a["d_outer"]),
           conv_subsample_flops(n_frames, a["n_mels"], a["d_outer"]))
    yield ("enc_stack", stack_p(a["n_enc"], a["d_outer"]),
           stack_f(a["n_enc"], a["d_outer"], l0))
    yield ("dec_stack", stack_p(a["n_dec"], a["d_outer"]),
           stack_f(a["n_dec"], a["d_outer"], l0))
    if a["type"] == "A":
        m = kept[0] * l0
        active = a["chunker"] == "dynamic" and a["N"] != 1
        yield ("chunker", chunker_params(a["chunker"], a["d_outer"], a["N"]),
               0.0)
        yield ("router", 0,
               router_flops(a["d_outer"], l0) if active else 0.0)
        yield ("ema", 0,
               ema_flops(l0, a["d_outer"]) if (active and use_ema) else 0.0)
        yield ("projections", proj_p,
               2.0 * (m * a["d_outer"] * a["d_main"]) * 2)
        yield ("main_stack", stack_p(a["n_main"], a["d_main"]),
               stack_f(a["n_main"], a["d_main"], m))
    else:
        per_stage_n = a["N"] ** 0.5
        m1, m2 = kept[0] * l0, kept[0] * kept[1] * l0
        active = a["chunker"] == "dynamic" and per_stage_n != 1
        yield ("chunker",
               chunker_params(a["chunker"], a["d_outer"], per_stage_n)
               + chunker_params(a["chunker"], a["d_main"], per_stage_n),
               0.0)
        yield ("router", 0,
               (router_flops(a["d_outer"], l0) + router_flops(a["d_main"], m1))
               if active else 0.0)
        yield ("ema", 0,
               (ema_flops(m1, a["d_main"]) + ema_flops(l0, a["d_outer"]))
               if (active and use_ema) else 0.0)
        yield ("projections", proj_p, 2.0 * (m1 * a["d_outer"] * a["d_main"]) * 2)
        yield ("mid_stack", stack_p(a["n_mid"], a["d_main"]),
               stack_f(a["n_mid"], a["d_main"], m1))
        yield ("main_stack", stack_p(a["n_main"], a["d_main"]),
               stack_f(a["n_main"], a["d_main"], m2))
        yield ("mid_dec_stack", stack_p(a["n_mid"], a["d_main"]),
               stack_f(a["n_mid"], a["d_main"], m1))


def _resolve_kept(a: dict, kept_fractions) -> list[float]:
    if kept_fractions is None:
        return list(a["kept_default"])
    if not isinstance(kept_fractions, (list, tuple)):
        raise ValueError("kept_fractions must be a list, got "
                         f"{type(kept_fractions).__name__}")
    kept = [float(k) for k in kept_fractions]
    if len(kept) != a["n_stages"]:
        raise ValueError(f"need {a['n_stages']} kept fraction(s) for type "
                         f"{a['type']}, got {len(kept)}")
    out_of_range = [k for k in kept if not 0.0 < k <= 1.0]
    if out_of_range:
        raise ValueError(f"kept fraction(s) outside (0, 1]: {out_of_range}")
    return kept


# ── public projections ────────────────────────────────────────────────────────
def encoder_params(enc: Mapping[str, Any], n_mels: int = 80) -> dict:
    a = _arch(enc, n_mels)
    table = {name: p for name, p, _ in
             _stage_table(a, 1000, a["kept_default"], a["ema"])}
    # params-only view drops the flops-only rows
    breakdown = {k: v for k, v in table.items() if k not in ("router", "ema")}
    return {"breakdown": breakdown, "total": sum(breakdown.values())}


def encoder_flops(enc: Mapping[str, Any], n_frames: int, n_mels: int = 80,
                  kept_fractions=None, ema: bool | None = None) -> dict:
    a = _arch(enc, n_mels)
    kept = _resolve_kept(a, kept_fractions)
    use_ema = a["ema"] if ema is None else bool(ema)
    flops = {name: f for name, _, f in
             _stage_table(a, n_frames, kept, use_ema) if name != "chunker"}
    l0 = float(subsampled_frames(n_frames))
    compressed = ([kept[0] * l0] if a["type"] == "A"
                  else [kept[0] * l0, kept[0] * kept[1] * l0])
    return {"breakdown": flops, "total": sum(flops.values()),
            "frames_25hz": l0, "compressed_frames": compressed,
            "kept_fractions": kept}


def head_params(config: Mapping[str, Any], vocab_size: int) -> dict:
    """CTC / AED / RNN-T head params by instantiating the port's modules on
    the CPU with the arguments the JAX package counts with."""
    from hnet_mamba_asr_torch.models.aed import AEDHead
    from hnet_mamba_asr_torch.models.ctc_head import CTCHead
    from hnet_mamba_asr_torch.models.rnnt import RNNTHead
    model_conf = dict(config.get("model_conf", {}) or {})
    d_outer = int(config["encoder_conf"]["d_outer"])
    w_ctc = float(model_conf.get("ctc_weight", 1.0))
    w_aed = float(model_conf.get("aed_weight", 0.0))
    w_rnnt = float(model_conf.get("rnnt_weight", 0.0))
    if w_ctc <= 0 and w_aed <= 0 and w_rnnt <= 0:
        raise ValueError(
            "model_conf needs ctc_weight, aed_weight or rnnt_weight > 0")
    counts = {"ctc_head": 0, "aed_head": 0, "rnnt_head": 0}
    if w_ctc > 0:
        counts["ctc_head"] = count_params(CTCHead(d_outer, int(vocab_size)))
    if w_aed > 0:
        aed_conf = dict(config.get("aed_conf", {}) or {})
        counts["aed_head"] = count_params(AEDHead(
            vocab_size=int(vocab_size), d_model=d_outer,
            n_layers=int(aed_conf.get("n_layers", 6)),
            n_heads=int(aed_conf.get("n_heads", 4)),
            d_ff=int(aed_conf.get("d_ff", 2048))))
    if w_rnnt > 0:
        rc = dict(config.get("rnnt_conf", {}) or {})
        counts["rnnt_head"] = count_params(RNNTHead(
            vocab_size=int(vocab_size), d_memory=d_outer,
            d_pred=int(rc.get("d_pred", 256)), d_joint=int(rc.get("d_joint", 512)),
            context=int(rc.get("context", 2))))
    return counts


def aed_flops_per_token(vocab_size: int, d_model: int, n_layers: int, d_ff: int,
                        memory_len: float, ctx_len: float) -> dict:
    """Decode-dependent secondary numbers (KV-cached decoder equivalent)."""
    per_layer = (4 * d_model * d_model + 2 * ctx_len * d_model       # self-attn
                 + 2 * d_model * d_model + 2 * memory_len * d_model  # cross-attn
                 + 2 * d_model * d_ff)                               # FFN
    return {"per_token": 2.0 * (n_layers * per_layer + d_model * vocab_size),
            "memory_kv_per_utt": 2.0 * n_layers * 2 * memory_len
            * d_model * d_model,
            "ctx_len": ctx_len, "memory_len": memory_len}


def efficiency_report(config: Mapping[str, Any], vocab_size: int,
                      audio_seconds: float = 10.0, kept_fractions=None) -> dict:
    if not audio_seconds > 0:
        raise ValueError(f"audio_seconds must be positive, got {audio_seconds}")
    enc = config["encoder_conf"]
    n_mels = int((config.get("frontend_conf", {}) or {}).get("n_mels", 80))
    n_frames = int(round(100 * audio_seconds))
    a = _arch(enc, n_mels)

    p_enc = encoder_params(enc, n_mels)
    p_heads = head_params(config, vocab_size)
    params = {"encoder": p_enc["total"], **p_heads,
              "total": p_enc["total"] + p_heads["ctc_head"]
              + p_heads["aed_head"] + p_heads["rnnt_head"],
              "encoder_breakdown": p_enc["breakdown"]}

    f_enc = encoder_flops(enc, n_frames, n_mels, kept_fractions)
    flop_rows = dict(f_enc["breakdown"])
    if p_heads["ctc_head"]:
        flop_rows["ctc_head"] = ctc_head_flops(a["d_outer"], int(vocab_size),
                                               f_enc["frames_25hz"])
    total_flops = sum(flop_rows.values())
    flops = {"audio_seconds": float(audio_seconds), "input_frames": n_frames,
             "frames_25hz": f_enc["frames_25hz"],
             "kept_fractions": f_enc["kept_fractions"],
             "compressed_frames": f_enc["compressed_frames"],
             "gflops_total": total_flops / 1e9,
             "gflops_per_second": total_flops / 1e9 / max(audio_seconds, 1e-9),
             "breakdown_gflops": {k: v / 1e9 for k, v in flop_rows.items()}}
    if p_heads["aed_head"]:
        aed_conf = dict(config.get("aed_conf", {}) or {})
        flops["aed_secondary"] = aed_flops_per_token(
            int(vocab_size), a["d_outer"], int(aed_conf.get("n_layers", 6)),
            int(aed_conf.get("d_ff", 2048)),
            memory_len=f_enc["frames_25hz"], ctx_len=32.0)
    if p_heads["rnnt_head"]:
        rc = dict(config.get("rnnt_conf", {}) or {})
        dj = int(rc.get("d_joint", 512))
        dp_ = int(rc.get("d_pred", 256))
        ctx = int(rc.get("context", 2))
        # per encoder frame: enc_proj + one blank joint evaluation; per
        # emitted token: predictor embed-concat projection + output matmul
        flops["rnnt_secondary"] = {
            "per_frame": 2.0 * (a["d_outer"] * dj + dj * (vocab_size + 1)),
            "per_token": 2.0 * (ctx * dp_ * dj + dj * (vocab_size + 1)),
        }

    arch = {k: a[k] for k in ("type", "N", "chunker", "d_outer", "d_main",
                              "n_enc", "n_main", "n_dec", "n_mid", "bidir",
                              "ema")}
    arch["vocab"] = int(vocab_size)
    return {"arch": arch, "params": params, "flops": flops,
            "assumptions": ASSUMPTIONS}


def format_efficiency(report: Mapping[str, Any]) -> str:
    a, p, f = report["arch"], report["params"], report["flops"]
    head = (f"arch type {a['type']}  N={a['N']:g}  chunker={a['chunker']}  "
            f"d {a['d_outer']}/{a['d_main']}  "
            f"layers {a['n_enc']}/{a['n_main']}/{a['n_dec']}")
    if a["type"] == "B":
        head += f" (mid {a['n_mid']})"
    head += f"  bidir={a['bidir']}  V={a['vocab']}"
    lines = [
        head,
        f"params: total {p['total'] / 1e6:.2f}M  (encoder "
        f"{p['encoder'] / 1e6:.2f}M, ctc {p['ctc_head'] / 1e6:.2f}M, "
        f"aed {p['aed_head'] / 1e6:.2f}M, rnnt {p['rnnt_head'] / 1e6:.2f}M)",
        f"flops @ {f['audio_seconds']:g}s: {f['gflops_total']:.2f} GFLOPs "
        f"({f['gflops_per_second']:.2f} GFLOPs/s), kept={f['kept_fractions']}",
        f"{'stage':<16}{'params(M)':>10}{'GFLOPs':>10}{'share':>8}",
    ]
    total = f["gflops_total"] or 1.0
    param_rows = {**p["encoder_breakdown"], "ctc_head": p["ctc_head"],
                  "aed_head": p["aed_head"], "rnnt_head": p["rnnt_head"]}
    for stage, gflops in f["breakdown_gflops"].items():
        lines.append(f"{stage:<16}{param_rows.get(stage, 0) / 1e6:>10.2f}"
                     f"{gflops:>10.2f}{100 * gflops / total:>7.1f}%")
    return "\n".join(lines)
