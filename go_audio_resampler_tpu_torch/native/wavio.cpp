// Native WAV reader/writer for the resample-wav CLI and data loading.
//
// C++ counterpart of the reference's fast WAV path: the buffered
// fastWAVWriter with header patch-up on close and 16/24/32-bit little-endian
// PCM support (cmd/resample-wav/main.go:546-731) and the streaming reader
// (helpers.go:29-75).  Exposed through a C ABI consumed via ctypes
// (go_audio_resampler_tpu/utils/wav.py); samples cross the boundary as
// normalized float32 interleaved frames.
//
// Build: make -C go_audio_resampler_tpu/native  (produces libwavio.so)

#include <cstdint>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

namespace {

constexpr uint32_t kRiffMagic = 0x46464952;  // "RIFF"
constexpr uint32_t kWaveMagic = 0x45564157;  // "WAVE"
constexpr uint32_t kFmtMagic = 0x20746d66;   // "fmt "
constexpr uint32_t kDataMagic = 0x61746164;  // "data"
constexpr size_t kIOBufFrames = 65536;       // streaming chunk (main.go:38)

struct Reader {
  FILE* f = nullptr;
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint16_t format = 1;  // 1 = PCM, 3 = IEEE float
  uint64_t data_bytes = 0;
  uint64_t read_bytes = 0;
  std::vector<uint8_t> buf;
};

struct Writer {
  FILE* f = nullptr;
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint16_t format = 1;          // 1 = PCM, 3 = IEEE float32
  uint32_t data_size_pos = 40;  // file offset of the data chunk size field
  uint32_t fact_pos = 0;        // file offset of the fact frame count (fmt 3)
  uint64_t data_bytes = 0;
  std::vector<uint8_t> buf;
};

bool read_u32(FILE* f, uint32_t* v) { return fread(v, 4, 1, f) == 1; }
bool read_u16(FILE* f, uint16_t* v) { return fread(v, 2, 1, f) == 1; }

void put_u32(std::vector<uint8_t>& b, uint32_t v) {
  b.push_back(v & 0xff); b.push_back((v >> 8) & 0xff);
  b.push_back((v >> 16) & 0xff); b.push_back((v >> 24) & 0xff);
}
void put_u16(std::vector<uint8_t>& b, uint16_t v) {
  b.push_back(v & 0xff); b.push_back((v >> 8) & 0xff);
}

}  // namespace

extern "C" {

// ---- reader ----------------------------------------------------------------

void* wav_read_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  uint32_t magic, size, wave;
  if (!read_u32(f, &magic) || magic != kRiffMagic ||
      !read_u32(f, &size) || !read_u32(f, &wave) || wave != kWaveMagic) {
    fclose(f);
    return nullptr;
  }
  auto* r = new Reader();
  r->f = f;
  // Chunk walk: find fmt and data (robust to LIST/fact/etc. chunks).
  while (true) {
    uint32_t id, len;
    if (!read_u32(f, &id) || !read_u32(f, &len)) break;
    if (id == kFmtMagic) {
      uint16_t fmt, ch, block, bits;
      uint32_t rate, byte_rate;
      if (!read_u16(f, &fmt) || !read_u16(f, &ch) || !read_u32(f, &rate) ||
          !read_u32(f, &byte_rate) || !read_u16(f, &block) ||
          !read_u16(f, &bits)) break;
      r->format = fmt;
      r->channels = ch;
      r->sample_rate = rate;
      r->bits = bits;
      if (len > 16) fseek(f, len - 16, SEEK_CUR);
    } else if (id == kDataMagic) {
      r->data_bytes = len;
      // Positioned at sample data; ready to stream.
      if (r->channels && r->bits &&
          (r->format == 1 || (r->format == 3 && r->bits == 32))) {
        return r;
      }
      break;
    } else {
      fseek(f, len + (len & 1), SEEK_CUR);
    }
  }
  fclose(f);
  delete r;
  return nullptr;
}

int wav_read_info(void* handle, uint32_t* rate, uint32_t* channels,
                  uint32_t* bits, uint64_t* frames) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return -1;
  *rate = r->sample_rate;
  *channels = r->channels;
  *bits = r->bits;
  const uint32_t frame_bytes = r->channels * (r->bits / 8);
  *frames = frame_bytes ? r->data_bytes / frame_bytes : 0;
  return 0;
}

// Reads up to max_frames interleaved frames as normalized float32.
// Returns frames read (0 at EOF, negative on error).
int64_t wav_read_samples(void* handle, float* out, int64_t max_frames) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return -1;
  const uint32_t bytes_per_sample = r->bits / 8;
  const uint32_t frame_bytes = r->channels * bytes_per_sample;
  uint64_t remaining = (r->data_bytes - r->read_bytes) / frame_bytes;
  int64_t want = std::min<int64_t>(max_frames, (int64_t)remaining);
  if (want <= 0) return 0;
  r->buf.resize((size_t)want * frame_bytes);
  size_t got = fread(r->buf.data(), frame_bytes, (size_t)want, r->f);
  r->read_bytes += got * frame_bytes;
  const uint8_t* p = r->buf.data();
  const int64_t n = (int64_t)got * r->channels;
  if (r->format == 3) {  // IEEE float32
    memcpy(out, p, (size_t)n * 4);
  } else if (r->bits == 16) {
    constexpr float kScale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; i++) {
      int16_t v;
      memcpy(&v, p + i * 2, 2);
      out[i] = v * kScale;
    }
  } else if (r->bits == 24) {
    constexpr float kScale = 1.0f / 8388608.0f;
    for (int64_t i = 0; i < n; i++) {
      const uint8_t* q = p + i * 3;
      int32_t v = (int32_t)((uint32_t)q[0] | ((uint32_t)q[1] << 8) |
                            ((uint32_t)q[2] << 16));
      if (v & 0x800000) v |= ~0xffffff;  // sign extend
      out[i] = v * kScale;
    }
  } else if (r->bits == 32) {
    constexpr double kScale = 1.0 / 2147483648.0;
    for (int64_t i = 0; i < n; i++) {
      int32_t v;
      memcpy(&v, p + i * 4, 4);
      out[i] = (float)(v * kScale);
    }
  } else if (r->bits == 8) {
    constexpr float kScale = 1.0f / 128.0f;
    for (int64_t i = 0; i < n; i++) out[i] = ((int)p[i] - 128) * kScale;
  } else {
    return -2;
  }
  return (int64_t)got;
}

void wav_read_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return;
  if (r->f) fclose(r->f);
  delete r;
}

// ---- writer ----------------------------------------------------------------

// fmt 1 = integer PCM (16/24/32 bit); fmt 3 = IEEE float32 (requires
// bits == 32).  The float header follows the WAVE_FORMAT_IEEE_FLOAT
// convention: 18-byte fmt chunk (cbSize = 0) plus a fact chunk whose
// frame count is patched on close, like the RIFF/data sizes.
void* wav_write_open_fmt(const char* path, uint32_t rate, uint32_t channels,
                         uint32_t bits, uint32_t fmt) {
  if (fmt == 1) {
    if (bits != 16 && bits != 24 && bits != 32) return nullptr;
  } else if (fmt == 3) {
    if (bits != 32) return nullptr;
  } else {
    return nullptr;
  }
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  w->sample_rate = rate;
  w->channels = (uint16_t)channels;
  w->bits = (uint16_t)bits;
  w->format = (uint16_t)fmt;
  // Provisional header; sizes patched on close (main.go:644-683 analog).
  std::vector<uint8_t> h;
  put_u32(h, kRiffMagic);
  put_u32(h, 36);  // patched later
  put_u32(h, kWaveMagic);
  put_u32(h, kFmtMagic);
  put_u32(h, fmt == 3 ? 18 : 16);
  put_u16(h, (uint16_t)fmt);
  put_u16(h, w->channels);
  put_u32(h, rate);
  put_u32(h, rate * channels * (bits / 8));
  put_u16(h, (uint16_t)(channels * (bits / 8)));
  put_u16(h, (uint16_t)bits);
  if (fmt == 3) {
    put_u16(h, 0);  // cbSize
    put_u32(h, 0x74636166);  // "fact"
    put_u32(h, 4);
    w->fact_pos = (uint32_t)h.size();
    put_u32(h, 0);  // frame count, patched later
  }
  put_u32(h, kDataMagic);
  w->data_size_pos = (uint32_t)h.size();
  put_u32(h, 0);  // patched later
  fwrite(h.data(), 1, h.size(), f);
  return w;
}

void* wav_write_open(const char* path, uint32_t rate, uint32_t channels,
                     uint32_t bits) {
  return wav_write_open_fmt(path, rate, channels, bits, 1);
}

// Writes interleaved normalized float32 frames, clamped to [-1, 1] and
// scaled to the target PCM width (main.go:686-723 analog).
int64_t wav_write_samples(void* handle, const float* in, int64_t frames) {
  auto* w = static_cast<Writer*>(handle);
  if (!w) return -1;
  const int64_t n = frames * w->channels;
  const uint32_t bps = w->bits / 8;
  if (w->format == 3) {
    // IEEE float32: bytes pass through unscaled (and unclamped — float
    // output keeps headroom above full scale, matching libsoxr's float
    // I/O convention).  Little-endian hosts only (x86/ARM).
    size_t wrote = fwrite(in, 4, (size_t)n, w->f);
    w->data_bytes += wrote * 4;
    return (int64_t)(wrote / w->channels);
  }
  w->buf.resize((size_t)n * bps);
  uint8_t* p = w->buf.data();
  if (w->bits == 16) {
    for (int64_t i = 0; i < n; i++) {
      float v = std::max(-1.0f, std::min(1.0f, in[i]));
      int32_t s = (int32_t)lrintf(v * 32767.0f);
      p[i * 2] = s & 0xff;
      p[i * 2 + 1] = (s >> 8) & 0xff;
    }
  } else if (w->bits == 24) {
    for (int64_t i = 0; i < n; i++) {
      float v = std::max(-1.0f, std::min(1.0f, in[i]));
      int32_t s = (int32_t)lrintf(v * 8388607.0f);
      p[i * 3] = s & 0xff;
      p[i * 3 + 1] = (s >> 8) & 0xff;
      p[i * 3 + 2] = (s >> 16) & 0xff;
    }
  } else {  // 32
    for (int64_t i = 0; i < n; i++) {
      double v = std::max(-1.0, std::min(1.0, (double)in[i]));
      int64_t s = llrint(v * 2147483647.0);
      uint32_t u = (uint32_t)(int32_t)s;
      p[i * 4] = u & 0xff;
      p[i * 4 + 1] = (u >> 8) & 0xff;
      p[i * 4 + 2] = (u >> 16) & 0xff;
      p[i * 4 + 3] = (u >> 24) & 0xff;
    }
  }
  size_t wrote = fwrite(w->buf.data(), 1, (size_t)n * bps, w->f);
  w->data_bytes += wrote;
  return (int64_t)(wrote / (w->channels * bps));
}

int wav_write_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  if (!w) return -1;
  // Patch RIFF and data chunk sizes (and the fact frame count for fmt 3).
  uint32_t riff_size = (uint32_t)(w->data_size_pos - 8 + 4 + w->data_bytes);
  uint32_t data_size = (uint32_t)w->data_bytes;
  fseek(w->f, 4, SEEK_SET);
  fwrite(&riff_size, 4, 1, w->f);
  if (w->fact_pos) {
    uint32_t nframes =
        (uint32_t)(w->data_bytes / (w->channels * (w->bits / 8)));
    fseek(w->f, (long)w->fact_pos, SEEK_SET);
    fwrite(&nframes, 4, 1, w->f);
  }
  fseek(w->f, (long)w->data_size_pos, SEEK_SET);
  fwrite(&data_size, 4, 1, w->f);
  int rc = fclose(w->f);
  delete w;
  return rc;
}

}  // extern "C"
