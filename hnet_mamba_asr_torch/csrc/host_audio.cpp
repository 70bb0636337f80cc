// Host audio library of hnet_mamba_asr_torch: FLAC decoding and polyphase
// resampling for the training data pipeline (LibriSpeech ships as FLAC;
// speed perturbation resamples every utterance at 0.9 and 1.1).
//
// Plain C ABI, bound with ctypes by data/host_audio.py, which builds this
// file at first use with the host C++ compiler into the package's _build/
// directory (c++ -O3 -shared -fPIC -std=c++17). This is host code: nothing
// here runs on the card. The plain twins the tests hold it to are
// data/flac.py::decode_flac_bytes and data/audio.py::resample_plain.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Polyphase resampling: out[j] = conv(zero_stuffed(x, up), kern)[j*down + pad]
// computed sparsely (only the non-zero taps, about nk / up per output).
void hmasr_resample_poly(const double* x, int64_t n, const double* kern,
                         int64_t nk, int64_t up, int64_t down,
                         double* out, int64_t n_out) {
  const int64_t pad = nk / 2;
  for (int64_t j = 0; j < n_out; ++j) {
    const int64_t t = j * down + pad;  // index into the full convolution
    // kernel index k must satisfy 0 <= k < nk and (t - k) % up == 0 with
    // 0 <= (t - k) / up < n
    int64_t s_lo = (t - (nk - 1) + up - 1) / up;  // ceil((t - nk + 1) / up)
    if (t - (nk - 1) <= 0) s_lo = 0;
    int64_t s_hi = t / up;                         // floor(t / up)
    if (s_hi > n - 1) s_hi = n - 1;
    double acc = 0.0;
    for (int64_t s = std::max<int64_t>(0, s_lo); s <= s_hi; ++s) {
      const int64_t k = t - s * up;
      if (k >= 0 && k < nk) acc += x[s] * kern[k];
    }
    out[j] = acc;
  }
}

}  // extern "C"

// ── FLAC decoder ─────────────────────────────────────────────────────────────
// The FLAC subset (RFC 9639): constant / verbatim / fixed / LPC subframes,
// rice + rice2 residuals with escape partitions, all stereo decorrelation
// modes, wasted bits, CRC-8 / CRC-16 verified on every frame.

namespace {

struct BitReader {
  const uint8_t* buf;
  int64_t nbytes;
  int64_t bitpos = 0;
  bool ok = true;

  uint64_t read(int n) {
    int64_t end = bitpos + n;
    if (((end + 7) >> 3) > nbytes) { ok = false; return 0; }
    uint64_t v = 0;
    int64_t pos = bitpos;
    int need = n;
    while (need > 0) {
      int rem = 8 - (pos & 7);
      int take = need < rem ? need : rem;
      uint8_t byte = buf[pos >> 3];
      uint8_t chunk = (byte >> (rem - take)) & ((1u << take) - 1);
      v = (v << take) | chunk;
      pos += take;
      need -= take;
    }
    bitpos = end;
    return v;
  }

  int64_t read_signed(int n) {
    uint64_t v = read(n);
    if (n > 0 && (v & (1ull << (n - 1)))) return (int64_t)v - (1ll << n);
    return (int64_t)v;
  }

  int64_t read_unary() {
    int64_t q = 0;
    while (ok) {
      if ((bitpos >> 3) >= nbytes) { ok = false; return 0; }
      int rem = 8 - (bitpos & 7);
      uint8_t window = buf[bitpos >> 3] & ((1u << rem) - 1);
      if (window) {
        // zeros before the leading 1: rem - bit_length(window)
        int lead = rem - (32 - __builtin_clz((unsigned)window));
        bitpos += lead + 1;
        return q + lead;
      }
      q += rem;
      bitpos += rem;
    }
    return 0;
  }

  void align() { bitpos = (bitpos + 7) & ~7ll; }
  int64_t byte_pos() const { return bitpos >> 3; }
};

uint8_t kCrc8Tab[256];
uint16_t kCrc16Tab[256];
bool kTabsInit = [] {
  for (int i = 0; i < 256; ++i) {
    uint32_t r8 = i;
    for (int b = 0; b < 8; ++b) r8 = (r8 & 0x80) ? ((r8 << 1) ^ 0x07) : (r8 << 1);
    kCrc8Tab[i] = (uint8_t)r8;
    uint32_t r16 = (uint32_t)i << 8;
    for (int b = 0; b < 8; ++b)
      r16 = (r16 & 0x8000) ? ((r16 << 1) ^ 0x8005) : (r16 << 1);
    kCrc16Tab[i] = (uint16_t)r16;
  }
  return true;
}();

uint8_t crc8(const uint8_t* p, int64_t n) {
  uint8_t c = 0;
  for (int64_t i = 0; i < n; ++i) c = kCrc8Tab[c ^ p[i]];
  return c;
}

uint16_t crc16(const uint8_t* p, int64_t n) {
  uint16_t c = 0;
  for (int64_t i = 0; i < n; ++i)
    c = kCrc16Tab[((c >> 8) ^ p[i]) & 0xFF] ^ (uint16_t)(c << 8);
  return c;
}

bool read_coded_number(BitReader& br, uint64_t* out) {
  uint64_t b0 = br.read(8);
  if (b0 < 0x80) { *out = b0; return br.ok; }
  int n_more = 0;
  uint64_t mask = 0x40;
  while (b0 & mask) { ++n_more; mask >>= 1; }
  if (n_more < 1 || n_more > 6) return false;
  uint64_t v = b0 & (mask - 1);
  for (int i = 0; i < n_more; ++i) {
    uint64_t b = br.read(8);
    if ((b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return br.ok;
}

bool decode_residual(BitReader& br, int64_t blocksize, int order,
                     int64_t* res) {
  int method = (int)br.read(2);
  if (method > 1) return false;
  int pbits = 4 + method;
  uint64_t escape = (1ull << pbits) - 1;
  int po = (int)br.read(4);
  int64_t n_part = 1ll << po;
  if (blocksize % n_part) return false;
  int64_t w = 0;
  for (int64_t p = 0; p < n_part; ++p) {
    int64_t cnt = (blocksize >> po) - (p == 0 ? order : 0);
    if (cnt < 0) return false;
    uint64_t param = br.read(pbits);
    if (param == escape) {
      int raw = (int)br.read(5);
      for (int64_t i = 0; i < cnt; ++i)
        res[w + i] = raw ? br.read_signed(raw) : 0;
    } else {
      for (int64_t i = 0; i < cnt; ++i) {
        int64_t q = br.read_unary();
        uint64_t u = ((uint64_t)q << param) | br.read((int)param);
        res[w + i] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    w += cnt;
  }
  return br.ok;
}

const int kFixedCoefs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool decode_subframe(BitReader& br, int64_t blocksize, int bps, int64_t* s,
                     std::vector<int64_t>& scratch) {
  if (br.read(1)) return false;
  int stype = (int)br.read(6);
  int wasted = 0;
  if (br.read(1)) wasted = 1 + (int)br.read_unary();
  int eff = bps - wasted;
  if (eff <= 0 || !br.ok) return false;
  if (stype == 0) {
    int64_t v = br.read_signed(eff);
    for (int64_t i = 0; i < blocksize; ++i) s[i] = v;
  } else if (stype == 1) {
    for (int64_t i = 0; i < blocksize; ++i) s[i] = br.read_signed(eff);
  } else if (stype >= 8 && stype <= 12) {
    int order = stype - 8;
    if (blocksize < order) return false;
    for (int i = 0; i < order; ++i) s[i] = br.read_signed(eff);
    scratch.resize(blocksize - order);
    if (!decode_residual(br, blocksize, order, scratch.data())) return false;
    const int* c = kFixedCoefs[order];
    for (int64_t i = order; i < blocksize; ++i) {
      int64_t acc = scratch[i - order];
      for (int j = 0; j < order; ++j) acc += (int64_t)c[j] * s[i - 1 - j];
      s[i] = acc;
    }
  } else if (stype >= 32) {
    int order = (stype & 31) + 1;
    if (blocksize < order) return false;
    for (int i = 0; i < order; ++i) s[i] = br.read_signed(eff);
    int prec = (int)br.read(4) + 1;
    if (prec == 16) return false;
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    int64_t coefs[32];
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(prec);
    scratch.resize(blocksize - order);
    if (!decode_residual(br, blocksize, order, scratch.data())) return false;
    for (int64_t i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coefs[j] * s[i - 1 - j];
      s[i] = scratch[i - order] + (acc >> shift);
    }
  } else {
    return false;
  }
  if (wasted)
    for (int64_t i = 0; i < blocksize; ++i) s[i] <<= wasted;
  return br.ok;
}

}  // namespace

extern "C" {

// FLAC byte stream -> interleaved int32 samples. Returns samples per channel
// (>= 0) or a negative error: -1 bad magic / no STREAMINFO, -2 truncated,
// -3 unsupported/corrupt frame, -4 capacity exceeded, -5 CRC mismatch.
// info4 out: {channels, sample_rate, bps, total_samples (STREAMINFO)}.
int64_t hmasr_flac_decode(const uint8_t* data, int64_t nbytes, int32_t* out,
                          int64_t capacity, int64_t* info4) {
  if (nbytes < 42 || data[0] != 'f' || data[1] != 'L' || data[2] != 'a' ||
      data[3] != 'C')
    return -1;
  int64_t pos = 4;
  int si_channels = 0, si_bps = 0;
  int64_t si_sr = 0, si_total = 0;
  bool have_si = false;
  while (pos + 4 <= nbytes) {
    uint8_t hdr = data[pos];
    int64_t length = ((int64_t)data[pos + 1] << 16) |
                     ((int64_t)data[pos + 2] << 8) | data[pos + 3];
    if ((hdr & 0x7F) == 0 && length >= 34 && pos + 4 + 34 <= nbytes) {
      BitReader br{data + pos + 4, length};
      br.read(16); br.read(16); br.read(24); br.read(24);
      si_sr = (int64_t)br.read(20);
      si_channels = (int)br.read(3) + 1;
      si_bps = (int)br.read(5) + 1;
      si_total = (int64_t)br.read(36);
      have_si = true;
    }
    pos += 4 + length;
    if (hdr & 0x80) break;
  }
  if (!have_si || pos > nbytes) return -1;
  info4[0] = si_channels; info4[1] = si_sr; info4[2] = si_bps;
  info4[3] = si_total;

  std::vector<int64_t> ch0, ch1, scratch;
  int64_t written = 0;
  while (pos + 2 < nbytes && (si_total == 0 || written < si_total)) {
    BitReader br{data, nbytes};
    br.bitpos = pos * 8;
    if (br.read(14) != 0x3FFE) return -3;
    br.read(2);
    int bs_code = (int)br.read(4);
    int sr_code = (int)br.read(4);
    int chan = (int)br.read(4);
    int ss_code = (int)br.read(3);
    br.read(1);
    uint64_t num;
    if (!read_coded_number(br, &num)) return -3;
    int64_t blocksize;
    if (bs_code == 0) return -3;
    else if (bs_code == 1) blocksize = 192;
    else if (bs_code <= 5) blocksize = 576ll << (bs_code - 2);
    else if (bs_code == 6) blocksize = (int64_t)br.read(8) + 1;
    else if (bs_code == 7) blocksize = (int64_t)br.read(16) + 1;
    else blocksize = 256ll << (bs_code - 8);
    if (sr_code == 12) br.read(8);
    else if (sr_code == 13 || sr_code == 14) br.read(16);
    else if (sr_code == 15) return -3;
    int bps;
    switch (ss_code) {
      case 0: bps = si_bps; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -3;
    }
    if (!br.ok) return -2;
    int64_t hdr_end = br.byte_pos();
    uint64_t c8 = br.read(8);
    if (crc8(data + pos, hdr_end - pos) != c8) return -5;

    int n_ch = si_channels;
    ch0.resize(blocksize);
    ch1.resize(blocksize);
    if (chan <= 7) {
      if (chan + 1 != n_ch) return -3;
      if (!decode_subframe(br, blocksize, bps, ch0.data(), scratch)) return -3;
      for (int c = 1; c < n_ch; ++c) {
        // >2 channels: decode each into ch1 and interleave immediately below
        if (c == 1) {
          if (!decode_subframe(br, blocksize, bps, ch1.data(), scratch))
            return -3;
        } else {
          return -3;  // >2 channels unsupported (LibriSpeech is mono/stereo)
        }
      }
    } else if (chan == 8) {                 // left/side
      if (n_ch != 2) return -3;
      if (!decode_subframe(br, blocksize, bps, ch0.data(), scratch)) return -3;
      if (!decode_subframe(br, blocksize, bps + 1, ch1.data(), scratch))
        return -3;
      for (int64_t i = 0; i < blocksize; ++i) ch1[i] = ch0[i] - ch1[i];
    } else if (chan == 9) {                 // right/side
      if (n_ch != 2) return -3;
      if (!decode_subframe(br, blocksize, bps + 1, ch0.data(), scratch))
        return -3;
      if (!decode_subframe(br, blocksize, bps, ch1.data(), scratch)) return -3;
      for (int64_t i = 0; i < blocksize; ++i) ch0[i] = ch1[i] + ch0[i];
    } else if (chan == 10) {                // mid/side
      if (n_ch != 2) return -3;
      if (!decode_subframe(br, blocksize, bps, ch0.data(), scratch)) return -3;
      if (!decode_subframe(br, blocksize, bps + 1, ch1.data(), scratch))
        return -3;
      for (int64_t i = 0; i < blocksize; ++i) {
        int64_t m = (ch0[i] << 1) | (ch1[i] & 1);
        int64_t s = ch1[i];
        ch0[i] = (m + s) >> 1;
        ch1[i] = (m - s) >> 1;
      }
    } else {
      return -3;
    }
    br.align();
    int64_t crc_end = br.byte_pos();
    uint64_t c16 = br.read(16);
    if (!br.ok) return -2;
    if (crc16(data + pos, crc_end - pos) != c16) return -5;

    int64_t take = blocksize;
    if (si_total && written + take > si_total) take = si_total - written;
    if ((written + take) * n_ch > capacity) return -4;
    for (int64_t i = 0; i < take; ++i) {
      out[(written + i) * n_ch] = (int32_t)ch0[i];
      if (n_ch == 2) out[(written + i) * n_ch + 1] = (int32_t)ch1[i];
    }
    written += take;
    pos = br.byte_pos();
  }
  return written;
}

}  // extern "C"
