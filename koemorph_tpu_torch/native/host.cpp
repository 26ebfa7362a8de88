// Host-side corpus parsers: WAV decode and blendshape JSONL, tight C++
// loops behind a plain C ABI, loaded with ctypes by
// koemorph_tpu_torch/data/native.py (built there at first use with
// g++ -O2 -shared -fPIC).
//
// The pure-Python readers (data/wav.py, data/io.py) own the error
// semantics: every entry point returns a negative code on input it does
// not take, and the caller then runs the strict Python loop, which
// raises its own error or decodes what the fast path declined.
//
// ABI: int64 sizes, caller-allocated outputs, return codes < 0 on error.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

struct KmWavInfo {
  int32_t sample_rate;
  int32_t channels;
  int32_t bits_per_sample;
  int32_t audio_format;   // 1 = PCM, 3 = IEEE float
  int64_t n_frames;       // samples per channel
  int64_t data_offset;    // byte offset of the PCM payload
  int64_t data_size;      // bytes of the PCM payload
};

static const uint16_t KM_PCM = 1;
static const uint16_t KM_IEEE = 3;
static const uint16_t KM_EXTENSIBLE = 0xFFFE;

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8));
}

// Parse the RIFF headers. Returns 0 on success, < 0 on input it declines.
int64_t km_wav_info(const uint8_t* buf, int64_t len, KmWavInfo* info) {
  if (len < 12 || std::memcmp(buf, "RIFF", 4) != 0 ||
      std::memcmp(buf + 8, "WAVE", 4) != 0)
    return -1;
  int64_t pos = 12;
  bool have_fmt = false, have_data = false;
  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  int64_t data_off = 0, data_size = 0;
  while (pos + 8 <= len) {
    const uint8_t* id = buf + pos;
    uint32_t size = rd_u32(buf + pos + 4);
    int64_t body = pos + 8;
    if (body + (int64_t)size > len) size = (uint32_t)(len - body);
    if (std::memcmp(id, "fmt ", 4) == 0 && size >= 16) {
      fmt_code = rd_u16(buf + body);
      channels = rd_u16(buf + body + 2);
      rate = rd_u32(buf + body + 4);
      bits = rd_u16(buf + body + 14);
      if (fmt_code == KM_EXTENSIBLE && size >= 26)
        fmt_code = rd_u16(buf + body + 24);  // the SubFormat GUID's prefix
      have_fmt = true;
    } else if (std::memcmp(id, "data", 4) == 0) {
      data_off = body;
      data_size = size;
      have_data = true;
    }
    pos = body + size + (size & 1);
  }
  if (!have_fmt || !have_data || channels == 0 || bits == 0) return -2;
  if (fmt_code != KM_PCM && fmt_code != KM_IEEE) return -3;
  int bytes = bits / 8;
  if (bytes == 0) return -4;
  info->sample_rate = (int32_t)rate;
  info->channels = (int32_t)channels;
  info->bits_per_sample = (int32_t)bits;
  info->audio_format = (int32_t)fmt_code;
  info->n_frames = data_size / (bytes * channels);
  info->data_offset = data_off;
  info->data_size = data_size;
  return 0;
}

// Decode the payload to float32 in [-1, 1]: n_frames * channels values
// (interleaved), or n_frames with mono_mix != 0 (the channels' average).
// Returns n_frames, or < 0 for a sample format it declines.
int64_t km_wav_decode(const uint8_t* buf, int64_t len, const KmWavInfo* info,
                      float* out, int32_t mono_mix) {
  const uint8_t* p = buf + info->data_offset;
  if (info->data_offset + info->data_size > len) return -1;
  const int64_t frames = info->n_frames;
  const int ch = info->channels;
  const int bits = info->bits_per_sample;
  const int fmt = info->audio_format;

  auto sample_at = [&](int64_t i) -> float {
    switch (bits) {
      case 16: {
        int16_t v;
        std::memcpy(&v, p + i * 2, 2);
        return (float)v / 32768.0f;
      }
      case 24: {
        const uint8_t* q = p + i * 3;
        int32_t v = (int32_t)((uint32_t)q[0] << 8 | (uint32_t)q[1] << 16 |
                              (uint32_t)q[2] << 24) >> 8;
        return (float)v / 8388608.0f;
      }
      case 32: {
        if (fmt == KM_IEEE) {
          float v;
          std::memcpy(&v, p + i * 4, 4);
          return v;
        }
        int32_t v;
        std::memcpy(&v, p + i * 4, 4);
        return (float)((double)v / 2147483648.0);
      }
      case 64: {
        double v;
        std::memcpy(&v, p + i * 8, 8);
        return (float)v;
      }
      default:
        return 0.0f;
    }
  };

  if ((bits != 16 && bits != 24 && bits != 32 && bits != 64) ||
      (bits == 64 && fmt != KM_IEEE))
    return -2;

  if (mono_mix && ch > 1) {
    const float inv = 1.0f / (float)ch;
    for (int64_t f = 0; f < frames; ++f) {
      float acc = 0.0f;
      for (int c = 0; c < ch; ++c) acc += sample_at(f * ch + c);
      out[f] = acc * inv;
    }
  } else {
    const int64_t total = frames * ch;
    for (int64_t i = 0; i < total; ++i) out[i] = sample_at(i);
  }
  return frames;
}

// ---------------------------------------------------------------------------
// Blendshape JSONL parse
// ---------------------------------------------------------------------------
//
// Lines of the shape the capture pipeline writes:
//   {"timestamp": <num>, "blendshapes": [<num> x n_coeffs]}
// (any key order; other keys skipped). A line that does not parse cleanly
// stops the parse with its negative line number.

static const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// One JSON number at *pp; advances *pp. NAN when none parses.
static double parse_num(const char** pp, const char* end) {
  char* q = nullptr;
  double v = std::strtod(*pp, &q);
  if (q == *pp || q > end) return NAN;
  *pp = q;
  return v;
}

// Skip one JSON value (number, string, bool, null, array, object): a
// shallow bracket matcher, enough for keys the parse does not read.
static const char* skip_value(const char* p, const char* end) {
  p = skip_ws(p, end);
  if (p >= end) return nullptr;
  if (*p == '"') {
    ++p;
    while (p < end && *p != '"') p += (*p == '\\') ? 2 : 1;
    return p < end ? p + 1 : nullptr;
  }
  if (*p == '[' || *p == '{') {
    char open = *p, close = (open == '[') ? ']' : '}';
    int depth = 0;
    while (p < end) {
      if (*p == '"') {
        ++p;
        while (p < end && *p != '"') p += (*p == '\\') ? 2 : 1;
        if (p >= end) return nullptr;
      } else if (*p == open) {
        ++depth;
      } else if (*p == close) {
        if (--depth == 0) return p + 1;
      }
      ++p;
    }
    return nullptr;
  }
  while (p < end && *p != ',' && *p != '}' && *p != ']' && *p != '\n') ++p;
  return p;
}

// Parse a JSONL buffer into ts_out [max_frames] (timestamps) and bs_out
// [max_frames * n_coeffs] (rows). Returns the frames parsed, or
// -(line number) at the first line it declines.
int64_t km_parse_blendshape_jsonl(const char* buf, int64_t len,
                                  double* ts_out, float* bs_out,
                                  int64_t max_frames, int32_t n_coeffs) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t frame = 0, line_no = 0;
  while (p < end && frame < max_frames) {
    ++line_no;
    const char* line_end = (const char*)std::memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    const char* q = skip_ws(p, line_end);
    if (q == line_end) {  // blank line
      p = line_end + 1;
      continue;
    }
    if (*q != '{') return -line_no;
    ++q;
    bool have_ts = false, have_bs = false;
    while (true) {
      q = skip_ws(q, line_end);
      if (q < line_end && *q == '}') break;
      if (q >= line_end || *q != '"') return -line_no;
      const char* key = q + 1;
      const char* key_end = (const char*)std::memchr(key, '"',
                                                     line_end - key);
      if (!key_end) return -line_no;
      size_t klen = (size_t)(key_end - key);
      q = skip_ws(key_end + 1, line_end);
      if (q >= line_end || *q != ':') return -line_no;
      q = skip_ws(q + 1, line_end);

      if (klen == 9 && std::memcmp(key, "timestamp", 9) == 0) {
        double v = parse_num(&q, line_end);
        if (std::isnan(v) && !(q < line_end)) return -line_no;
        ts_out[frame] = v;
        have_ts = true;
      } else if (klen == 11 && std::memcmp(key, "blendshapes", 11) == 0) {
        if (q >= line_end || *q != '[') return -line_no;
        ++q;
        float* row = bs_out + frame * n_coeffs;
        int32_t i = 0;
        while (true) {
          q = skip_ws(q, line_end);
          if (q < line_end && *q == ']') {
            ++q;
            break;
          }
          if (i >= n_coeffs) return -line_no;  // too many values
          double v = parse_num(&q, line_end);
          if (std::isnan(v)) return -line_no;
          row[i++] = (float)v;
          q = skip_ws(q, line_end);
          if (q < line_end && *q == ',') ++q;
        }
        if (i != n_coeffs) return -line_no;    // too few values
        have_bs = true;
      } else {
        q = skip_value(q, line_end);
        if (!q) return -line_no;
      }
      q = skip_ws(q, line_end);
      if (q < line_end && *q == ',') {
        ++q;
        continue;
      }
      if (q < line_end && *q == '}') break;
      return -line_no;
    }
    if (!have_ts || !have_bs) return -line_no;
    ++frame;
    p = line_end + 1;
  }
  return frame;
}

// Count the non-blank lines (the probe that sizes the outputs).
int64_t km_count_lines(const char* buf, int64_t len) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t n = 0;
  while (p < end) {
    const char* line_end = (const char*)std::memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    if (skip_ws(p, line_end) != line_end) ++n;
    p = line_end + 1;
  }
  return n;
}

}  // extern "C"
