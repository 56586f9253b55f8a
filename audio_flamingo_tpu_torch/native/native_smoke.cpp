// Sanitizer smoke test of the port's native code: WAV and FLAC decode, the resampler and
// the BPE engine (audio/cpp/audioio.cpp, audio/cpp/flac.cpp, runtime/cpp/bpe.cpp) under
// ASan/UBSan. Build with CMakeLists.txt (AF_SANITIZE=ON), or in one g++ call:
//
//   g++ -std=c++17 -g -O1 -fsanitize=address,undefined -fno-sanitize-recover=all \
//       native_smoke.cpp ../audio/cpp/audioio.cpp ../audio/cpp/flac.cpp \
//       ../runtime/cpp/bpe.cpp -o native_smoke && ./native_smoke
//
// Every check calls abort() on failure (not assert: it must hold under -DNDEBUG too).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
int af_decode_wav(const uint8_t* data, uint64_t len, float** out, uint64_t* out_len,
                  int* sample_rate);
int af_decode_flac(const uint8_t* data, uint64_t len, float** out, uint64_t* out_len,
                   int* sample_rate);
int af_resample(const float* in, uint64_t n_in, int sr_in, int sr_out, int zeros,
                double beta, float** out, uint64_t* n_out);
void af_free(void* p);
void* af_bpe_new(const char* vocab_data, uint64_t vocab_len, const char* merges_data,
                 uint64_t merges_len);
void af_bpe_free(void* handle);
int64_t af_bpe_encode(void* handle, const char* pretoken, uint64_t len, int32_t* out,
                      uint64_t out_cap);
}

#define CHECK(cond)                                                    \
  do {                                                                 \
    if (!(cond)) {                                                     \
      fprintf(stderr, "native_smoke: %s:%d: %s\n", __FILE__, __LINE__, \
              #cond);                                                  \
      abort();                                                         \
    }                                                                  \
  } while (0)

static void wr_u32(std::vector<uint8_t>& v, uint32_t x) {
  for (int i = 0; i < 4; ++i) v.push_back((x >> (8 * i)) & 0xFF);
}
static void wr_u16(std::vector<uint8_t>& v, uint16_t x) {
  v.push_back(x & 0xFF);
  v.push_back((x >> 8) & 0xFF);
}

static std::vector<uint8_t> pcm16_wav(int n, int channels, int sr) {
  std::vector<uint8_t> wav;
  wav.insert(wav.end(), {'R', 'I', 'F', 'F'});
  wr_u32(wav, 36 + n * 2 * channels);
  wav.insert(wav.end(), {'W', 'A', 'V', 'E', 'f', 'm', 't', ' '});
  wr_u32(wav, 16);
  wr_u16(wav, 1);                            // PCM
  wr_u16(wav, (uint16_t)channels);
  wr_u32(wav, (uint32_t)sr);
  wr_u32(wav, (uint32_t)(sr * 2 * channels));  // byte rate
  wr_u16(wav, (uint16_t)(2 * channels));       // block align
  wr_u16(wav, 16);                             // bits
  wav.insert(wav.end(), {'d', 'a', 't', 'a'});
  wr_u32(wav, (uint32_t)(n * 2 * channels));
  for (int i = 0; i < n * channels; ++i) wr_u16(wav, (uint16_t)(int16_t)(i * 13 % 4096 - 2048));
  return wav;
}

int main() {
  // --- WAV decode: 1000 samples of PCM16 mono 16 kHz, then stereo 48 kHz
  const int n = 1000;
  std::vector<uint8_t> wav = pcm16_wav(n, 1, 16000);
  float* pcm = nullptr;
  uint64_t pcm_n = 0;
  int sr = 0;
  int rc = af_decode_wav(wav.data(), wav.size(), &pcm, &pcm_n, &sr);
  CHECK(rc == 0 && pcm_n == (uint64_t)n && sr == 16000);
  std::vector<uint8_t> stereo = pcm16_wav(n, 2, 48000);
  float* mix = nullptr;
  uint64_t mix_n = 0;
  rc = af_decode_wav(stereo.data(), stereo.size(), &mix, &mix_n, &sr);
  CHECK(rc == 0 && mix_n == (uint64_t)n && sr == 48000);

  // --- resample 16k -> 48k and 48k -> 16k (lengths), 44.1k -> 16k (finite)
  float* up = nullptr;
  uint64_t up_n = 0;
  rc = af_resample(pcm, pcm_n, 16000, 48000, 16, 8.555, &up, &up_n);
  CHECK(rc == 0 && up_n == 3 * pcm_n);
  float* down = nullptr;
  uint64_t down_n = 0;
  rc = af_resample(mix, mix_n, 48000, 16000, 16, 8.555, &down, &down_n);
  CHECK(rc == 0 && down_n == mix_n / 3);
  float* odd = nullptr;
  uint64_t odd_n = 0;
  rc = af_resample(mix, mix_n, 44100, 16000, 16, 8.555, &odd, &odd_n);
  CHECK(rc == 0 && odd_n == mix_n * 160 / 441);
  for (uint64_t i = 0; i < odd_n; ++i) CHECK(odd[i] == odd[i]);
  af_free(pcm);
  af_free(mix);
  af_free(up);
  af_free(down);
  af_free(odd);

  // --- truncated or garbage WAV and FLAC must fail cleanly (no OOB reads under ASan)
  rc = af_decode_wav(wav.data(), 20, &pcm, &pcm_n, &sr);
  CHECK(rc != 0);
  std::vector<uint8_t> garbage(64, 0xAB);
  rc = af_decode_wav(garbage.data(), garbage.size(), &pcm, &pcm_n, &sr);
  CHECK(rc != 0);
  rc = af_decode_flac(garbage.data(), garbage.size(), &pcm, &pcm_n, &sr);
  CHECK(rc != 0);
  // a FLAC stream with a STREAMINFO block, then a frame of noise cut short
  std::vector<uint8_t> flac = {'f', 'L', 'a', 'C', 0x80, 0x00, 0x00, 0x22};
  const uint8_t info[34] = {0x10, 0x00, 0x10, 0x00, 0, 0, 0, 0, 0, 0, 0x03, 0xE8, 0x00,
                            0xF0, 0x00, 0x00, 0x03, 0xE8};
  flac.insert(flac.end(), info, info + 34);
  for (int i = 0; i < 48; ++i) flac.push_back((uint8_t)(0xFF - i * 7));
  flac[42] = 0xFF;
  flac[43] = 0xF8;
  for (uint64_t cut = 42; cut <= flac.size(); cut += 3) {
    float* f = nullptr;
    uint64_t f_n = 0;
    if (af_decode_flac(flac.data(), cut, &f, &f_n, &sr) == 0) af_free(f);
  }

  // --- BPE
  std::string vocab = "a\nb\nc\nab\nabc\n\xc3\xa9\nab\xc3\xa9";
  std::string merges = "a b\nab c\nab \xc3\xa9";
  void* bpe = af_bpe_new(vocab.data(), vocab.size(), merges.data(), merges.size());
  CHECK(bpe);
  int32_t ids[16];
  int64_t m = af_bpe_encode(bpe, "abc", 3, ids, 16);
  CHECK(m == 1 && ids[0] == 4);  // "abc" fully merged
  m = af_bpe_encode(bpe, "abab", 4, ids, 16);
  CHECK(m == 2 && ids[0] == 3 && ids[1] == 3);
  m = af_bpe_encode(bpe, "ab\xc3\xa9" "c", 5, ids, 16);  // a two-byte code point merges whole
  CHECK(m == 2 && ids[0] == 6 && ids[1] == 2);
  m = af_bpe_encode(bpe, "zzz", 3, ids, 16);  // unknown pieces -> -1, no crash
  CHECK(m == -1);
  m = af_bpe_encode(bpe, "abab", 4, ids, 16);  // from the cache
  CHECK(m == 2 && ids[0] == 3 && ids[1] == 3);
  std::string many(40, 'c');
  m = af_bpe_encode(bpe, many.data(), many.size(), ids, 16);  // 40 ids into 16: -1
  CHECK(m == -1);
  m = af_bpe_encode(bpe, "\xc3", 1, ids, 16);  // a cut code point: unknown, no over-read
  CHECK(m == -1);
  af_bpe_free(bpe);

  printf("native_smoke: OK\n");
  return 0;
}
