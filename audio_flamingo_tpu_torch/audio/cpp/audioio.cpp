// Native audio I/O of the PyTorch port: WAV decode + windowed-sinc polyphase resampler.
//
// The port's copy of audio_flamingo_tpu/audio/cpp/audioio.cpp. Exposed as a C ABI
// consumed via ctypes (audio_flamingo_tpu_torch/audio/io.py, which builds it with
// flac.cpp by one g++ call into the port's _build/); the numpy versions in io.py are
// its reference (tests/test_torch_audio_io.py). Error codes: -1 not RIFF/WAVE, -2 no
// fmt/data chunk, -3 zero sample width, -4 out of memory, -5 unsupported bit depth,
// -6 unsupported format tag, -7 bad resampler arguments.
//
// The resampler computes the taps of each of the L output phases once, where the JAX
// copy recomputes every tap (a Bessel series) for every output sample; the taps are the
// same Kaiser-windowed sinc, so outputs agree with the numpy reference to float rounding.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

double bessel_i0(double x) {
  // series expansion; converges quickly for the beta range we use
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) { return (uint16_t)p[0] | ((uint16_t)p[1] << 8); }

uint64_t gcd_u64(uint64_t a, uint64_t b) {
  while (b) {
    uint64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

extern "C" {

void af_free(void* p) { free(p); }

// Decode a RIFF/WAVE buffer to mono float32. Supports PCM 8/16/24/32-bit and
// IEEE float32/float64, any channel count (averaged to mono).
// Returns 0 on success; fills *out (malloc'd), *out_len, *sample_rate.
int af_decode_wav(const uint8_t* data, uint64_t len, float** out, uint64_t* out_len,
                  int* sample_rate) {
  if (len < 44 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WAVE", 4) != 0)
    return -1;
  uint64_t pos = 12;
  int fmt_tag = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* pcm = nullptr;
  uint64_t pcm_len = 0;
  while (pos + 8 <= len) {
    const uint8_t* hdr = data + pos;
    uint32_t chunk_len = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + chunk_len > len) chunk_len = (uint32_t)(len - pos - 8);
    if (memcmp(hdr, "fmt ", 4) == 0 && chunk_len >= 16) {
      fmt_tag = rd_u16(body);
      channels = rd_u16(body + 2);
      sr = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt_tag == 0xFFFE && chunk_len >= 40) fmt_tag = rd_u16(body + 24);  // extensible
    } else if (memcmp(hdr, "data", 4) == 0) {
      pcm = body;
      pcm_len = chunk_len;
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are word-aligned
  }
  if (!pcm || channels <= 0 || sr == 0) return -2;

  uint64_t bytes_per_sample = bits / 8;
  if (bytes_per_sample == 0) return -3;
  uint64_t n_frames = pcm_len / (bytes_per_sample * channels);
  float* buf = (float*)malloc(sizeof(float) * n_frames);
  if (!buf) return -4;

  for (uint64_t i = 0; i < n_frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* s = pcm + (i * channels + c) * bytes_per_sample;
      double v = 0.0;
      if (fmt_tag == 1) {  // integer PCM
        if (bits == 8) {
          v = ((double)s[0] - 128.0) / 128.0;
        } else if (bits == 16) {
          v = (double)(int16_t)rd_u16(s) / 32768.0;
        } else if (bits == 24) {
          int32_t x = (int32_t)((uint32_t)s[0] | ((uint32_t)s[1] << 8) |
                                ((uint32_t)s[2] << 16));
          if (x & 0x800000) x |= ~0xFFFFFF;
          v = (double)x / 8388608.0;
        } else if (bits == 32) {
          v = (double)(int32_t)rd_u32(s) / 2147483648.0;
        } else {
          free(buf);
          return -5;
        }
      } else if (fmt_tag == 3) {  // IEEE float
        if (bits == 32) {
          float f;
          memcpy(&f, s, 4);
          v = f;
        } else if (bits == 64) {
          double d;
          memcpy(&d, s, 8);
          v = d;
        } else {
          free(buf);
          return -5;
        }
      } else {
        free(buf);
        return -6;
      }
      acc += v;
    }
    buf[i] = (float)(acc / channels);
  }
  *out = buf;
  *out_len = n_frames;
  *sample_rate = (int)sr;
  return 0;
}

// Rational polyphase resampler with a Kaiser-windowed sinc prototype.
// L/M = sr_out/sr_in reduced; filter cutoff at min(sr_in, sr_out)/2 with `zeros`
// zero-crossings per side and Kaiser beta.
int af_resample(const float* in, uint64_t n_in, int sr_in, int sr_out, int zeros,
                double beta, float** out, uint64_t* n_out) {
  if (sr_in <= 0 || sr_out <= 0 || zeros <= 0) return -7;
  if (sr_in == sr_out) {
    float* buf = (float*)malloc(sizeof(float) * (n_in ? n_in : 1));
    if (!buf) return -4;
    memcpy(buf, in, sizeof(float) * n_in);
    *out = buf;
    *n_out = n_in;
    return 0;
  }
  uint64_t g = gcd_u64((uint64_t)sr_in, (uint64_t)sr_out);
  uint64_t L = (uint64_t)sr_out / g;  // upsample factor
  uint64_t M = (uint64_t)sr_in / g;   // downsample factor

  // anti-alias lowpass cutoff in cycles per INPUT sample; width set by `zeros`
  double fc = (L >= M) ? 0.5 : 0.5 * (double)L / (double)M;
  double half_width = (double)zeros / (2.0 * fc);  // input samples per side
  double i0b = bessel_i0(beta);

  // Output j sits at t_out = j M / L = q + r / L input samples (q = jM div L,
  // r = jM mod L). Its taps depend on the phase r only: tap k - q of phase r weights
  // input sample k.
  std::vector<int64_t> first(L);
  std::vector<std::vector<double>> taps(L);
  for (uint64_t r = 0; r < L; ++r) {
    double frac = (double)r / (double)L;
    int64_t lo = (int64_t)ceil(frac - half_width);
    int64_t hi = (int64_t)floor(frac + half_width);
    first[r] = lo;
    for (int64_t k = lo; k <= hi; ++k) {
      double t = (double)k - frac;
      double arg = t / half_width;
      double win = bessel_i0(beta * sqrt(fmax(1.0 - arg * arg, 0.0))) / i0b;
      double s = (t == 0.0) ? 2.0 * fc : sin(2.0 * kPi * fc * t) / (kPi * t);
      taps[r].push_back(s * win);
    }
  }

  uint64_t out_n = (n_in * L) / M;
  float* buf = (float*)malloc(sizeof(float) * (out_n ? out_n : 1));
  if (!buf) return -4;
  for (uint64_t j = 0; j < out_n; ++j) {
    uint64_t q = j * M / L, r = j * M % L;
    int64_t k0 = (int64_t)q + first[r];
    const std::vector<double>& tr = taps[r];
    double acc = 0.0;
    for (size_t i = 0; i < tr.size(); ++i) {
      int64_t k = k0 + (int64_t)i;
      if (k < 0 || k >= (int64_t)n_in) continue;
      acc += tr[i] * (double)in[k];
    }
    buf[j] = (float)acc;
  }
  *out = buf;
  *n_out = out_n;
  return 0;
}

}  // extern "C"
