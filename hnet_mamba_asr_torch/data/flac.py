"""Dependency-free FLAC codec: spec-based decoder + lossless encoder.

The port's copy of ``hnet_mamba_asr_tpu/data/flac.py``. LibriSpeech ships
as FLAC. ``read_flac`` decodes through the port's host library
(``data/host_audio.py``, C++, every frame's CRCs checked), as the JAX
package's ``read_flac`` goes through its native decoder; the numpy decoder
here is its plain twin. Written from the FLAC format specification (RFC
9639):

- ``decode_flac_bytes``: full subset decoder — constant /
  verbatim / fixed(0-4) / LPC subframes, rice + rice2 residuals with escape
  partitions, all four channel assignments (independent, left/side,
  right/side, mid/side), wasted bits, fixed and variable blocking, CRC-8 and
  CRC-16 verification. Pure numpy/stdlib.
- ``write_flac``: a real encoder (constant / fixed / LPC prediction chosen
  per subframe, rice partitioning, stereo decorrelation modes, wasted-bit
  packing). Losslessness means round-trips are bit-exact regardless of
  predictor quality, which makes encoder+decoder mutually verifying — they
  share no bit-level code.

Audio IO entry points live in data/audio.py (``read_audio`` dispatches here).
"""
from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

_SYNC = 0x3FFE                                       # 14-bit frame sync code

_SR_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
             7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_BPS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_BPS_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}

_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


# ── CRCs (frame header CRC-8 poly 0x07, frame CRC-16 poly 0x8005) ─────────────
def _crc_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    tab = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        r = i << (width - 8)
        for _ in range(8):
            r = ((r << 1) ^ poly) if r & top else (r << 1)
        tab[i] = r & mask
    return tab


_CRC8_TAB = _crc_table(0x07, 8)
_CRC16_TAB = _crc_table(0x8005, 16)


def _crc8(buf) -> int:
    c = 0
    for b in memoryview(buf):
        c = int(_CRC8_TAB[(c ^ b) & 0xFF])
    return c


def _crc16(buf) -> int:
    c = 0
    for b in memoryview(buf):
        c = int(_CRC16_TAB[((c >> 8) ^ b) & 0xFF]) ^ ((c << 8) & 0xFFFF)
    return c


# ── bit IO ────────────────────────────────────────────────────────────────────
class _BitReader:
    def __init__(self, buf: bytes, byte_pos: int = 0):
        self.buf = buf
        self.bitpos = byte_pos * 8

    def read(self, n: int) -> int:
        end = self.bitpos + n
        b0, b1 = self.bitpos >> 3, (end + 7) >> 3
        if b1 > len(self.buf):
            raise ValueError("flac: truncated stream")
        chunk = int.from_bytes(self.buf[b0:b1], "big")
        self.bitpos = end
        return (chunk >> ((b1 << 3) - end)) & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count of 0 bits before the next 1 bit."""
        q = 0
        buf, pos = self.buf, self.bitpos
        while True:
            byte = buf[pos >> 3]
            rem = 8 - (pos & 7)
            window = byte & ((1 << rem) - 1)
            if window:
                lead = rem - window.bit_length()
                self.bitpos = pos + lead + 1
                return q + lead
            q += rem
            pos += rem
            if (pos >> 3) >= len(buf):
                raise ValueError("flac: truncated unary code")

    def align(self) -> None:
        self.bitpos = (self.bitpos + 7) & ~7

    @property
    def byte_pos(self) -> int:
        return self.bitpos >> 3


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_unary(self, q: int) -> None:
        self.write(1, q + 1)                          # q zeros then a one

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.out)


def _read_coded_number(br: _BitReader) -> int:
    """UTF-8-style frame/sample number (extended to 36 bits)."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n_more = 0
    mask = 0x40
    while b0 & mask:
        n_more += 1
        mask >>= 1
    if n_more < 1 or n_more > 6:
        raise ValueError("flac: bad coded number")
    v = b0 & (mask - 1)
    for _ in range(n_more):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("flac: bad coded number continuation")
        v = (v << 6) | (b & 0x3F)
    return v


def _write_coded_number(bw: _BitWriter, v: int) -> None:
    if v < 0x80:
        bw.write(v, 8)
        return
    payload = []
    n = 1
    while True:
        payload.append(0x80 | (v & 0x3F))
        v >>= 6
        n += 1
        if v < (1 << (7 - n)):
            break
    head = ((0xFF << (8 - n)) & 0xFF) | v
    bw.write(head, 8)
    for b in reversed(payload):
        bw.write(b, 8)


# ── STREAMINFO ────────────────────────────────────────────────────────────────
def parse_streaminfo(block: bytes) -> dict:
    br = _BitReader(block)
    info = {"min_blocksize": br.read(16), "max_blocksize": br.read(16),
            "min_framesize": br.read(24), "max_framesize": br.read(24),
            "sample_rate": br.read(20), "channels": br.read(3) + 1,
            "bps": br.read(5) + 1, "total_samples": br.read(36),
            "md5": block[18:34]}
    return info


def _find_streaminfo(data: bytes) -> tuple[dict, int]:
    """-> (streaminfo, offset of first audio frame)."""
    if data[:4] != b"fLaC":
        raise ValueError("flac: missing fLaC marker")
    pos, info = 4, None
    while True:
        if pos + 4 > len(data):
            raise ValueError("flac: truncated metadata")
        hdr = data[pos]
        length = int.from_bytes(data[pos + 1:pos + 4], "big")
        if (hdr & 0x7F) == 0:
            info = parse_streaminfo(data[pos + 4:pos + 4 + length])
        pos += 4 + length
        if hdr & 0x80:
            break
    if info is None:
        raise ValueError("flac: no STREAMINFO block")
    return info, pos


# ── decoding ──────────────────────────────────────────────────────────────────
def _decode_residual(br: _BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError("flac: reserved residual method")
    pbits = 4 + method
    escape = (1 << pbits) - 1
    po = br.read(4)
    n_part = 1 << po
    if blocksize % n_part:
        raise ValueError("flac: bad partition order")
    res = np.empty(blocksize - order, dtype=np.int64)
    w = 0
    for p in range(n_part):
        cnt = (blocksize >> po) - (order if p == 0 else 0)
        if cnt < 0:
            raise ValueError("flac: predictor order exceeds first partition")
        param = br.read(pbits)
        if param == escape:
            raw = br.read(5)
            for i in range(cnt):
                res[w + i] = br.read_signed(raw) if raw else 0
        else:
            for i in range(cnt):
                q = br.read_unary()
                u = (q << param) | br.read(param)
                res[w + i] = (u >> 1) ^ -(u & 1)
        w += cnt
    return res


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("flac: bad subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
    eff = bps - wasted
    if stype == 0:                                    # constant
        s = np.full(blocksize, br.read_signed(eff), dtype=np.int64)
    elif stype == 1:                                  # verbatim
        s = np.fromiter((br.read_signed(eff) for _ in range(blocksize)),
                        dtype=np.int64, count=blocksize)
    elif 8 <= stype <= 12:                            # fixed predictor
        order = stype - 8
        s = np.empty(blocksize, dtype=np.int64)
        for i in range(order):
            s[i] = br.read_signed(eff)
        res = _decode_residual(br, blocksize, order)
        coefs = _FIXED_COEFS[order]
        for i in range(order, blocksize):
            s[i] = res[i - order] + sum(c * int(s[i - 1 - j])
                                        for j, c in enumerate(coefs))
    elif stype >= 32:                                 # LPC
        order = (stype & 31) + 1
        s = np.empty(blocksize, dtype=np.int64)
        for i in range(order):
            s[i] = br.read_signed(eff)
        prec = br.read(4) + 1
        if prec == 16:
            raise ValueError("flac: invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("flac: negative LPC shift")
        coefs = [br.read_signed(prec) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        for i in range(order, blocksize):
            acc = sum(c * int(s[i - 1 - j]) for j, c in enumerate(coefs))
            s[i] = res[i - order] + (acc >> shift)
    else:
        raise ValueError(f"flac: reserved subframe type {stype}")
    return s << wasted if wasted else s


def _decode_frame(data: bytes, pos: int, info: dict,
                  verify_crc: bool) -> tuple[list[np.ndarray], int]:
    br = _BitReader(data, pos)
    if br.read(14) != _SYNC:
        raise ValueError(f"flac: lost sync at byte {pos}")
    br.read(1)                                        # reserved
    br.read(1)                                        # blocking strategy
    bs_code = br.read(4)
    sr_code = br.read(4)
    chan = br.read(4)
    ss_code = br.read(3)
    br.read(1)                                        # reserved
    _read_coded_number(br)
    if bs_code == 0:
        raise ValueError("flac: reserved blocksize code")
    elif bs_code == 1:
        blocksize = 192
    elif bs_code <= 5:
        blocksize = 576 << (bs_code - 2)
    elif bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    else:
        blocksize = 256 << (bs_code - 8)
    if sr_code == 12:
        br.read(8)
    elif sr_code in (13, 14):
        br.read(16)
    elif sr_code == 15:
        raise ValueError("flac: invalid sample-rate code")
    if ss_code == 0:
        bps = info["bps"]
    elif ss_code in _BPS_TABLE:
        bps = _BPS_TABLE[ss_code]
    else:
        raise ValueError(f"flac: reserved sample-size code {ss_code}")
    hdr_end = br.byte_pos
    crc8 = br.read(8)
    if verify_crc and _crc8(data[pos:hdr_end]) != crc8:
        raise ValueError(f"flac: frame header CRC-8 mismatch at byte {pos}")

    if chan <= 7:
        n_ch = chan + 1
        subs = [_decode_subframe(br, blocksize, bps) for _ in range(n_ch)]
    elif chan == 8:                                   # left/side: L, S=L-R
        left = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        subs = [left, left - side]
    elif chan == 9:                                   # right/side: S=L-R, R
        side = _decode_subframe(br, blocksize, bps + 1)
        right = _decode_subframe(br, blocksize, bps)
        subs = [right + side, right]
    elif chan == 10:                                  # mid/side: M=(L+R)>>1, S
        mid = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        m = (mid << 1) | (side & 1)
        subs = [(m + side) >> 1, (m - side) >> 1]
    else:
        raise ValueError("flac: reserved channel assignment")
    br.align()
    crc_end = br.byte_pos
    crc16 = br.read(16)
    if verify_crc and _crc16(data[pos:crc_end]) != crc16:
        raise ValueError(f"flac: frame CRC-16 mismatch at byte {pos}")
    return subs, br.byte_pos


def decode_flac_bytes(data: bytes, *, verify_crc: bool = True
                      ) -> tuple[np.ndarray, int, int]:
    """FLAC byte stream -> (samples int32 [n, channels], sample_rate, bps)."""
    info, pos = _find_streaminfo(data)
    chunks: list[list[np.ndarray]] = []
    total = 0
    want = info["total_samples"]
    while pos + 2 < len(data) and (not want or total < want):
        subs, pos = _decode_frame(data, pos, info, verify_crc)
        chunks.append(subs)
        total += len(subs[0])
    if not chunks:
        raise ValueError("flac: no audio frames")
    n_ch = len(chunks[0])
    out = np.stack([np.concatenate([c[ch] for c in chunks])
                    for ch in range(n_ch)], axis=1)
    if want:
        out = out[:want]
    return out.astype(np.int32), info["sample_rate"], info["bps"]


def read_flac(path: str | Path) -> tuple[np.ndarray, int]:
    """FLAC file -> (float64 mono waveform in [-1, 1], sample_rate), decoded by
    the host library."""
    from hnet_mamba_asr_torch.data.host_audio import flac_decode
    samples, sr, bps = flac_decode(Path(path).read_bytes())
    x = samples.astype(np.float64) / float(1 << (bps - 1))
    return (x[:, 0] if x.shape[1] == 1 else x.mean(axis=1)), sr


def flac_info(path: str | Path) -> dict:
    """STREAMINFO fields without decoding audio (the spec mandates STREAMINFO
    to be the first metadata block)."""
    with open(path, "rb") as f:
        head = f.read(4 + 4 + 34)
    if head[:4] != b"fLaC":
        raise ValueError("flac: missing fLaC marker")
    return parse_streaminfo(head[8:42])


# ── encoding ──────────────────────────────────────────────────────────────────
def _zigzag(v: np.ndarray) -> np.ndarray:
    return (v << 1) ^ (v >> 63)


def _best_rice_param(u: np.ndarray, pbits: int) -> tuple[int, int]:
    """-> (param, cost_bits); param == escape marker means raw encoding."""
    escape = (1 << pbits) - 1
    n = len(u)
    if n == 0:
        return 0, 0
    best_k, best_cost = 0, None
    total = int(u.sum())
    for k in range(escape):
        cost = n * (k + 1) + total
        if cost < (best_cost if best_cost is not None else 1 << 62):
            best_k, best_cost = k, cost
        total = int((u >> (k + 1)).sum())             # next k's quotient sum
    raw_bits = max(int(u.max()).bit_length() + 1, 1)
    raw_cost = 5 + n * raw_bits
    if raw_cost < best_cost:
        return escape, raw_cost
    return best_k, best_cost


def _encode_residual(bw: _BitWriter, res: np.ndarray, blocksize: int,
                     order: int, po: int, rice2: bool) -> None:
    while po > 0 and (blocksize % (1 << po) or (blocksize >> po) <= order):
        po -= 1
    pbits = 5 if rice2 else 4
    escape = (1 << pbits) - 1
    bw.write(1 if rice2 else 0, 2)
    bw.write(po, 4)
    u = _zigzag(res.astype(np.int64))
    w = 0
    for p in range(1 << po):
        cnt = (blocksize >> po) - (order if p == 0 else 0)
        part = u[w:w + cnt]
        param, _ = _best_rice_param(part, pbits)
        bw.write(param, pbits)
        if param == escape:
            raw = int(max(int(part.max()).bit_length() + 1, 1)) if cnt else 1
            bw.write(raw, 5)
            for v in res[w:w + cnt]:
                bw.write(int(v) & ((1 << raw) - 1), raw)
        else:
            for uv in part:
                bw.write_unary(int(uv) >> param)
                if param:
                    bw.write(int(uv) & ((1 << param) - 1), param)
        w += cnt
    assert w == blocksize - order


def _fixed_residual(s: np.ndarray, order: int) -> np.ndarray:
    r = s.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _lpc_quantize(s: np.ndarray, order: int, precision: int
                  ) -> tuple[list[int], int] | None:
    """Levinson-Durbin on the block's autocorrelation -> quantized coefs."""
    x = s.astype(np.float64)
    n = len(x)
    if n <= order:
        return None
    ac = np.array([np.dot(x[:n - k], x[k:]) for k in range(order + 1)])
    if ac[0] == 0:
        return None
    err = ac[0]
    a = np.zeros(order)
    for i in range(order):
        acc = ac[i + 1] - sum(a[j] * ac[i - j] for j in range(i))
        k = acc / err
        new_a = a.copy()
        for j in range(i):
            new_a[j] = a[j] - k * a[i - 1 - j]
        new_a[i] = k
        a = new_a
        err *= (1.0 - k * k)
        if err <= 0 or not np.isfinite(err):
            return None
    cmax = np.abs(a).max()
    if cmax == 0 or not np.isfinite(cmax):
        return None
    shift = min(15, max(1, precision - 1 - int(np.floor(np.log2(cmax))) - 1))
    q = np.round(a * (1 << shift)).astype(np.int64)
    lim = 1 << (precision - 1)
    q = np.clip(q, -lim, lim - 1)
    return [int(v) for v in q], shift


def _lpc_residual(s: np.ndarray, coefs: list[int], shift: int) -> np.ndarray:
    order = len(coefs)
    sl = s.astype(np.int64)
    acc = np.zeros(len(s) - order, dtype=np.int64)
    for j, c in enumerate(coefs):
        acc += c * sl[order - 1 - j:len(s) - 1 - j]
    return sl[order:] - (acc >> shift)


def _encode_subframe(bw: _BitWriter, s: np.ndarray, bps: int, *, po: int,
                     rice2: bool, use_lpc: bool, lpc_order: int,
                     lpc_precision: int) -> None:
    s = s.astype(np.int64)
    n = len(s)
    wasted = 0
    if np.any(s):
        ored = int(np.bitwise_or.reduce(s))
        wasted = (ored & -ored).bit_length() - 1
        # a wasted-bits count must leave at least 1 effective bit
        wasted = min(wasted, bps - 1)
        if wasted:
            s = s >> wasted
    eff = bps - wasted

    def header(stype: int) -> None:
        bw.write(0, 1)
        bw.write(stype, 6)
        if wasted:
            bw.write(1, 1)
            bw.write(1, wasted)                       # unary: wasted-1 zeros, 1
        else:
            bw.write(0, 1)

    if np.all(s == s[0]):
        header(0)
        bw.write(int(s[0]) & ((1 << eff) - 1), eff)
        return
    # candidate predictors: fixed 0-2 always; LPC optionally
    best = None                                       # (cost, kind, payload)
    for order in (0, 1, 2):
        if n <= order:
            continue
        res = _fixed_residual(s, order)
        cost = order * eff + int((_zigzag(res) >> 6).sum()) + len(res)
        if best is None or cost < best[0]:
            best = (cost, "fixed", order, res)
    if use_lpc and n > lpc_order:
        got = _lpc_quantize(s, lpc_order, lpc_precision)
        if got is not None:
            coefs, shift = got
            res = _lpc_residual(s, coefs, shift)
            cost = (lpc_order * eff + 4 + 5 + lpc_order * lpc_precision
                    + int((_zigzag(res) >> 6).sum()) + len(res))
            if cost < best[0]:
                best = (cost, "lpc", (coefs, shift), res)
    _, kind, meta, res = best
    if kind == "fixed":
        order = meta
        header(8 + order)
        for i in range(order):
            bw.write(int(s[i]) & ((1 << eff) - 1), eff)
        _encode_residual(bw, res, n, order, po, rice2)
    else:
        coefs, shift = meta
        order = len(coefs)
        header(32 + order - 1)
        for i in range(order):
            bw.write(int(s[i]) & ((1 << eff) - 1), eff)
        bw.write(lpc_precision - 1, 4)
        bw.write(shift, 5)
        for c in coefs:
            bw.write(c & ((1 << lpc_precision) - 1), lpc_precision)
        _encode_residual(bw, res, n, order, po, rice2)


def write_flac(path: str | Path, samples: np.ndarray, sample_rate: int, *,
               bps: int = 16, blocksize: int = 4096, channel_mode: str = "auto",
               partition_order: int = 0, rice2: bool = False,
               use_lpc: bool = True, lpc_order: int = 8,
               lpc_precision: int = 14) -> None:
    """Encode to FLAC. ``samples``: float in [-1, 1] (converted to ``bps``-bit
    PCM) or integer PCM, shape [n] or [n, channels] (1-2 channels).
    channel_mode: auto | independent | left_side | right_side | mid_side."""
    x = np.asarray(samples)
    if np.issubdtype(x.dtype, np.floating):
        lim = (1 << (bps - 1)) - 1
        x = np.round(np.clip(x, -1.0, 1.0) * lim).astype(np.int64)
    else:
        x = x.astype(np.int64)
    if x.ndim == 1:
        x = x[:, None]
    n, n_ch = x.shape
    if n_ch not in (1, 2):
        raise ValueError(f"flac: {n_ch} channels unsupported (1-2)")
    if channel_mode == "auto":
        channel_mode = "independent"

    md5 = hashlib.md5()
    width = bps // 8
    inter = x.astype("<i8")
    frame_bytes = np.zeros((n, n_ch, width), dtype=np.uint8)
    for k in range(width):
        frame_bytes[:, :, k] = ((inter >> (8 * k)) & 0xFF).astype(np.uint8)
    md5.update(frame_bytes.tobytes())

    frames = bytearray()
    kw = dict(po=partition_order, rice2=rice2, use_lpc=use_lpc,
              lpc_order=lpc_order, lpc_precision=lpc_precision)
    for fi, start in enumerate(range(0, n, blocksize)):
        blk = x[start:start + blocksize]
        bs = len(blk)
        bw = _BitWriter()
        bw.write(_SYNC, 14)
        bw.write(0, 1)                                # reserved
        bw.write(0, 1)                                # fixed blocksize strategy
        bw.write(7, 4)                                # blocksize: 16 bits at end
        bw.write(0, 4)                                # sample rate: STREAMINFO
        if n_ch == 1 or channel_mode == "independent":
            bw.write(n_ch - 1, 4)
        else:
            bw.write({"left_side": 8, "right_side": 9,
                      "mid_side": 10}[channel_mode], 4)
        bw.write(_BPS_CODE[bps], 3)
        bw.write(0, 1)                                # reserved
        _write_coded_number(bw, fi)
        bw.write(bs - 1, 16)
        bw.align()
        hdr = bw.bytes()
        bw = _BitWriter()
        for b in hdr:
            bw.write(b, 8)
        bw.write(_crc8(hdr), 8)
        if n_ch == 1 or channel_mode == "independent":
            for ch in range(n_ch):
                _encode_subframe(bw, blk[:, ch], bps, **kw)
        else:
            left, right = blk[:, 0], blk[:, 1]
            side = left - right
            if channel_mode == "left_side":
                _encode_subframe(bw, left, bps, **kw)
                _encode_subframe(bw, side, bps + 1, **kw)
            elif channel_mode == "right_side":
                _encode_subframe(bw, side, bps + 1, **kw)
                _encode_subframe(bw, right, bps, **kw)
            else:                                     # mid/side
                mid = (left + right) >> 1
                _encode_subframe(bw, mid, bps, **kw)
                _encode_subframe(bw, side, bps + 1, **kw)
        bw.align()
        body = bw.bytes()
        frames += body
        frames += _crc16(body).to_bytes(2, "big")

    si = _BitWriter()
    si.write(blocksize if n else 16, 16)              # min blocksize
    si.write(blocksize if n else 16, 16)              # max blocksize
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(n_ch - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    si.align()
    streaminfo = si.bytes() + md5.digest()
    assert len(streaminfo) == 34
    out = bytearray(b"fLaC")
    out += bytes([0x80]) + (34).to_bytes(3, "big") + streaminfo
    out += frames
    Path(path).write_bytes(bytes(out))
