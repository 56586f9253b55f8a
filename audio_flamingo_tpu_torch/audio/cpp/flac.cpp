// Native FLAC decoder (subset): native-FLAC container, CONSTANT/VERBATIM/FIXED/LPC
// subframes, 4- and 5-bit Rice residual partitions, independent + left-side/right-side/
// mid-side stereo, 8/16/24-bit sample depths — covering every stream a CD-style or
// speech-corpus FLAC produces (SURVEY.md §2.10 row 9: libsndfile/ffmpeg decode role).
//
// The PyTorch port's copy of audio_flamingo_tpu/audio/cpp/flac.cpp. FLAC is lossless, so
// decode(encode(x)) must equal x bit-exactly; the port's pure-Python decoder
// (audio_flamingo_tpu_torch/audio/flac.py) is its reference (tests/test_torch_audio_io.py).
// Error codes: -1 not FLAC, -2 bad STREAMINFO, -3 bad frame header, -4 bad subframe,
// -5 out of memory.
//
// Compiled with audioio.cpp by one g++ call (audio_flamingo_tpu_torch/audio/io.py).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  uint64_t len;     // bytes
  uint64_t bitpos;  // absolute bit position (MSB-first)

  bool ok() const { return bitpos <= len * 8; }

  uint32_t bits(int n) {  // n <= 32
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      uint64_t byte = bitpos >> 3;
      if (byte >= len) { bitpos += 1; continue; }
      int off = 7 - (int)(bitpos & 7);
      v = (v << 1) | ((data[byte] >> off) & 1);
      bitpos += 1;
    }
    return v;
  }

  uint64_t bits64(int n) {
    uint64_t v = 0;
    if (n > 32) { v = bits(n - 32); return (v << 32) | bits(32); }
    return bits(n);
  }

  int32_t sbits(int n) {  // signed two's complement
    uint32_t v = bits(n);
    if (n < 32 && (v & (1u << (n - 1)))) v |= ~((1u << n) - 1);
    return (int32_t)v;
  }

  uint32_t unary() {
    uint32_t q = 0;
    while (bitpos < len * 8) {
      uint64_t byte = bitpos >> 3;
      int off = 7 - (int)(bitpos & 7);
      bitpos += 1;
      if ((data[byte] >> off) & 1) return q;
      ++q;
    }
    return q;
  }

  void align() { bitpos = (bitpos + 7) & ~7ull; }
};

// frame-header UTF-8-style coded number (up to 36 bits)
bool read_coded_number(BitReader& br, uint64_t* out) {
  uint32_t b0 = br.bits(8);
  int extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) { *out = b0; return true; }
  else if ((b0 & 0xE0) == 0xC0) { v = b0 & 0x1F; extra = 1; }
  else if ((b0 & 0xF0) == 0xE0) { v = b0 & 0x0F; extra = 2; }
  else if ((b0 & 0xF8) == 0xF0) { v = b0 & 0x07; extra = 3; }
  else if ((b0 & 0xFC) == 0xF8) { v = b0 & 0x03; extra = 4; }
  else if ((b0 & 0xFE) == 0xFC) { v = b0 & 0x01; extra = 5; }
  else if (b0 == 0xFE) { v = 0; extra = 6; }
  else return false;
  for (int i = 0; i < extra; ++i) {
    uint32_t b = br.bits(8);
    if ((b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

bool read_residual(BitReader& br, int blocksize, int order,
                   std::vector<int64_t>& res) {
  uint32_t method = br.bits(2);
  if (method > 1) return false;
  int pbits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 15 : 31;
  uint32_t porder = br.bits(4);
  uint32_t nparts = 1u << porder;
  if (blocksize % (int)nparts != 0) return false;
  int idx = order;
  for (uint32_t p = 0; p < nparts; ++p) {
    int n = blocksize / (int)nparts - (p == 0 ? order : 0);
    if (n < 0) return false;
    uint32_t param = br.bits(pbits);
    if (param == escape) {
      uint32_t raw = br.bits(5);
      for (int i = 0; i < n; ++i) res[idx++] = raw ? br.sbits((int)raw) : 0;
    } else {
      for (int i = 0; i < n; ++i) {
        uint64_t q = br.unary();
        uint64_t v = (q << param) | br.bits((int)param);
        res[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);  // zigzag
      }
    }
    if (!br.ok()) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& out) {
  if (br.bits(1) != 0) return false;  // zero pad bit
  uint32_t type = br.bits(6);
  int wasted = 0;
  if (br.bits(1) == 1) wasted = 1 + (int)br.unary();
  int ebps = bps - wasted;
  out.assign(blocksize, 0);

  if (type == 0) {  // CONSTANT
    int64_t v = br.sbits(ebps);
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) out[i] = br.sbits(ebps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order 0..4
    int order = (int)type - 8;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(ebps);
    if (!read_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t p = 0;
      switch (order) {
        case 0: p = 0; break;
        case 1: p = out[i - 1]; break;
        case 2: p = 2 * out[i - 1] - out[i - 2]; break;
        case 3: p = 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        case 4: p = 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4]; break;
      }
      out[i] += p;
    }
  } else if (type >= 32) {  // LPC, order = type - 31
    int order = (int)type - 31;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(ebps);
    int precision = (int)br.bits(4) + 1;
    if (precision == 16) return false;  // 1111 is invalid
    int shift = br.sbits(5);
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br.sbits(precision);
    if (!read_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t p = 0;
      for (int j = 0; j < order; ++j) p += coef[j] * out[i - 1 - j];
      out[i] += p >> shift;
    }
  } else {
    return false;
  }
  if (wasted) for (int i = 0; i < blocksize; ++i) out[i] <<= wasted;
  return br.ok();
}

}  // namespace

extern "C" {

// Decode a native-FLAC buffer to mono float32 (channels averaged, samples scaled by
// 2^-(bps-1) like the WAV path). Returns 0 on success.
int af_decode_flac(const uint8_t* data, uint64_t len, float** out, uint64_t* out_len,
                   int* sample_rate) {
  if (len < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
  BitReader br{data, len, 32};

  // metadata blocks; STREAMINFO is mandatory and first
  int sr = 0, channels = 0, bps = 0;
  uint64_t total_samples = 0;
  bool last = false, have_info = false;
  while (!last) {
    last = br.bits(1) != 0;
    uint32_t type = br.bits(7);
    uint32_t blen = br.bits(24);
    if (type == 0 && blen >= 34) {
      br.bits(16); br.bits(16);  // min/max block size
      br.bits(24); br.bits(24);  // min/max frame size
      sr = (int)br.bits(20);
      channels = (int)br.bits(3) + 1;
      bps = (int)br.bits(5) + 1;
      total_samples = br.bits64(36);
      // fields read so far = 18 bytes; skip the 16-byte md5 + any extension bytes
      br.bitpos += (uint64_t)(blen - 18) * 8;
      have_info = true;
    } else {
      br.bitpos += (uint64_t)blen * 8;
    }
    if (!br.ok()) return -2;
  }
  if (!have_info || sr == 0 || channels <= 0 || bps < 4) return -2;

  std::vector<float> mono;
  if (total_samples) mono.reserve(total_samples);
  std::vector<std::vector<int64_t>> ch(channels);
  const double scale = 1.0 / (double)(1ll << (bps - 1));

  while (br.bitpos + 32 <= len * 8) {
    // frame header
    if (br.bits(14) != 0x3FFE) break;  // sync
    br.bits(1);                        // reserved
    br.bits(1);                        // blocking strategy
    uint32_t bs_code = br.bits(4);
    uint32_t sr_code = br.bits(4);
    uint32_t ch_code = br.bits(4);
    uint32_t ss_code = br.bits(3);
    br.bits(1);  // reserved
    uint64_t num;
    if (!read_coded_number(br, &num)) return -3;

    int blocksize;
    if (bs_code == 1) blocksize = 192;
    else if (bs_code >= 2 && bs_code <= 5) blocksize = 576 << (bs_code - 2);
    else if (bs_code == 6) blocksize = (int)br.bits(8) + 1;
    else if (bs_code == 7) blocksize = (int)br.bits(16) + 1;
    else if (bs_code >= 8) blocksize = 256 << (bs_code - 8);
    else return -3;

    if (sr_code == 12) br.bits(8);        // kHz value inline
    else if (sr_code == 13 || sr_code == 14) br.bits(16);

    int fbps = bps;
    switch (ss_code) {
      case 0: break;
      case 1: fbps = 8; break;
      case 2: fbps = 12; break;
      case 4: fbps = 16; break;
      case 5: fbps = 20; break;
      case 6: fbps = 24; break;
      case 7: fbps = 32; break;
      default: return -3;
    }
    br.bits(8);  // header CRC

    int nch = channels;
    int mode = 0;  // 0 independent, 1 left/side, 2 right/side, 3 mid/side
    if (ch_code <= 7) { nch = (int)ch_code + 1; }
    else if (ch_code == 8) { nch = 2; mode = 1; }
    else if (ch_code == 9) { nch = 2; mode = 2; }
    else if (ch_code == 10) { nch = 2; mode = 3; }
    else return -3;

    for (int c = 0; c < nch; ++c) {
      int sbps = fbps;
      // the side channel carries one extra bit
      if ((mode == 1 && c == 1) || (mode == 2 && c == 0) || (mode == 3 && c == 1))
        sbps += 1;
      if (!decode_subframe(br, blocksize, sbps, ch[c])) return -4;
    }
    br.align();
    br.bits(16);  // frame CRC
    if (!br.ok()) return -4;

    for (int i = 0; i < blocksize; ++i) {
      double acc = 0.0;
      if (mode == 0) {
        for (int c = 0; c < nch; ++c) acc += (double)ch[c][i];
        acc /= nch;
      } else if (mode == 1) {  // left/side: right = left - side
        int64_t l = ch[0][i], s = ch[1][i];
        acc = 0.5 * (double)(l + (l - s));
      } else if (mode == 2) {  // right/side: left = right + side
        int64_t r = ch[1][i], s = ch[0][i];
        acc = 0.5 * (double)((r + s) + r);
      } else {                 // mid/side: m2 = l+r exactly (same parity as side)
        int64_t m = ch[0][i], s = ch[1][i];
        int64_t l2 = ((m << 1) | (s & 1)) + s;   // == 2*left
        int64_t r2 = ((m << 1) | (s & 1)) - s;   // == 2*right
        acc = 0.25 * (double)(l2 + r2);
      }
      mono.push_back((float)(acc * scale));
    }
    if (total_samples && mono.size() >= total_samples) break;
  }

  if (total_samples && mono.size() > total_samples) mono.resize(total_samples);
  float* buf = (float*)malloc(sizeof(float) * (mono.empty() ? 1 : mono.size()));
  if (!buf) return -5;
  memcpy(buf, mono.data(), sizeof(float) * mono.size());
  *out = buf;
  *out_len = mono.size();
  *sample_rate = sr;
  return 0;
}

}  // extern "C"
