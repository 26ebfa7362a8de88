// Batch emitter of the multi-session server's output frames: one JSON row
// per session, {"timestamp": t, "session": i, "blendshapes": [...]}, sent
// as UDP datagrams (sendmmsg) or formatted as JSONL, for the whole
// (sessions, coeffs) float32 frame batch in one call. The Python
// json.dumps loop is the wire contract; these rows carry the same fields,
// values within 5e-10 (float32 bit-exact for |v| >= 2^-6), the timestamp
// within 1e-6, and a non-finite value as NaN / Infinity / -Infinity, as
// json.dumps writes it.
//
// Built with `g++ -O2 -shared -fPIC` at first use
// (koemorph_tpu_torch/data/native.py).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/uio.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

// The header {"timestamp": %.6f, "session": %lld, "blendshapes": [ takes
// at most this many bytes; a longer one (a timestamp beyond ~1e25) is an
// error, never an overrun.
#define KM_HEADER_MAX 80
// One value and its ", " separator take at most this many bytes.
#define KM_VALUE_MAX 34

static inline char* km_fmt_nonfinite(char* p, double v) {
  const char* s = (v != v) ? "NaN" : (v > 0 ? "Infinity" : "-Infinity");
  size_t n = std::strlen(s);
  std::memcpy(p, s, n);
  return p + n;
}

// Fixed-point float32 -> decimal: 9 fractional digits, trailing zeros
// trimmed (absolute error <= 5e-10). Values beyond 4e9 take %.9g (a JSON
// number); non-finite values are written as json.dumps writes them.
// Writes at most 32 chars; returns the new cursor.
static inline char* km_fmt_f32(char* p, float v) {
  if (!std::isfinite(v)) return km_fmt_nonfinite(p, (double)v);
  if (v > 4.0e9f || v < -4.0e9f)
    return p + snprintf(p, 32, "%.9g", (double)v);
  if (v < 0) { *p++ = '-'; v = -v; }
  double d = (double)v;
  uint64_t ip = (uint64_t)d;
  uint64_t frac = (uint64_t)llround((d - (double)ip) * 1e9);
  if (frac >= 1000000000ULL) { frac -= 1000000000ULL; ++ip; }
  char tmp[20];
  int ti = 0;
  do { tmp[ti++] = (char)('0' + ip % 10); ip /= 10; } while (ip);
  while (ti) *p++ = tmp[--ti];
  if (frac) {
    *p++ = '.';
    char fb[9];
    for (int k = 8; k >= 0; --k) { fb[k] = (char)('0' + frac % 10); frac /= 10; }
    int last = 8;
    while (fb[last] == '0') --last;
    for (int k = 0; k <= last; ++k) *p++ = fb[k];
  }
  return p;
}

// One frame row -> {"timestamp": t, "session": i, "blendshapes": [...]}.
// Returns the bytes written (no NUL), or -1 when the header exceeds
// KM_HEADER_MAX or the row may not fit in cap: every write is bounded
// before it is made.
static int km_fmt_row(char* out, int cap, double timestamp, int64_t session,
                      const float* row, int64_t n) {
  if (cap <= KM_HEADER_MAX) return -1;
  int off;
  if (std::isfinite(timestamp)) {
    off = snprintf(out, KM_HEADER_MAX + 1,
                   "{\"timestamp\": %.6f, \"session\": %lld, "
                   "\"blendshapes\": [",
                   timestamp, (long long)session);
  } else {
    char ts[16];
    *km_fmt_nonfinite(ts, timestamp) = '\0';
    off = snprintf(out, KM_HEADER_MAX + 1,
                   "{\"timestamp\": %s, \"session\": %lld, "
                   "\"blendshapes\": [",
                   ts, (long long)session);
  }
  // snprintf returns the length it would have written: a header that did
  // not fit was cut at KM_HEADER_MAX and is refused here
  if (off < 0 || off > KM_HEADER_MAX) return -1;
  if ((int64_t)cap - off < KM_VALUE_MAX * n + 2) return -1;
  char* p = out + off;
  for (int64_t j = 0; j < n; ++j) {
    if (j) { *p++ = ','; *p++ = ' '; }
    p = km_fmt_f32(p, row[j]);
  }
  *p++ = ']';
  *p++ = '}';
  return (int)(p - out);
}

extern "C" {

// Send one JSON datagram per session row over an existing unconnected UDP
// socket fd to ip:port (a dotted quad). Returns the datagrams sent, -1 for
// a bad address, -2 for a row that does not fit its buffer. A batch that
// the kernel takes only in part (a full socket buffer) drops the rest, as
// a fire-and-forget sendto loop would.
int64_t km_emit_frames_udp(const float* frames, int64_t n_sessions,
                           int64_t n_coeffs, double timestamp,
                           int32_t sockfd, const char* ip, int32_t port) {
  struct sockaddr_in dest;
  std::memset(&dest, 0, sizeof(dest));
  dest.sin_family = AF_INET;
  dest.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, ip, &dest.sin_addr) != 1) return -1;
  enum { KM_MMSG_BATCH = 64, KM_ROW_CAP = 2048 };
  static thread_local char bufs[KM_MMSG_BATCH][KM_ROW_CAP];
  struct mmsghdr msgs[KM_MMSG_BATCH];
  struct iovec iovs[KM_MMSG_BATCH];
  int64_t sent = 0;
  for (int64_t base = 0; base < n_sessions; base += KM_MMSG_BATCH) {
    int nb = (int)((n_sessions - base < (int64_t)KM_MMSG_BATCH)
                       ? n_sessions - base : (int64_t)KM_MMSG_BATCH);
    for (int k = 0; k < nb; ++k) {
      int64_t i = base + k;
      int len = km_fmt_row(bufs[k], KM_ROW_CAP, timestamp, i,
                           frames + i * n_coeffs, n_coeffs);
      if (len < 0) return -2;
      iovs[k].iov_base = bufs[k];
      iovs[k].iov_len = (size_t)len;
      std::memset(&msgs[k], 0, sizeof(msgs[k]));
      msgs[k].msg_hdr.msg_name = &dest;
      msgs[k].msg_hdr.msg_namelen = sizeof(dest);
      msgs[k].msg_hdr.msg_iov = &iovs[k];
      msgs[k].msg_hdr.msg_iovlen = 1;
    }
    int got = sendmmsg(sockfd, msgs, (unsigned)nb, 0);
    if (got > 0) sent += got;
  }
  return sent;
}

// Format the whole frame batch as JSONL (one row and a newline per
// session) into out[0:cap]. Returns the bytes written, or -2 when a row
// does not fit (a header over KM_HEADER_MAX included).
int64_t km_format_frames_jsonl(const float* frames, int64_t n_sessions,
                               int64_t n_coeffs, double timestamp,
                               char* out, int64_t cap) {
  int64_t off = 0;
  for (int64_t i = 0; i < n_sessions; ++i) {
    int64_t room = cap - off - 1;          // one byte kept for the newline
    if (room > 0x7fffffff) room = 0x7fffffff;
    if (room <= 0) return -2;
    int len = km_fmt_row(out + off, (int)room, timestamp, i,
                         frames + i * n_coeffs, n_coeffs);
    if (len < 0) return -2;
    off += len;
    out[off++] = '\n';
  }
  return off;
}

}  // extern "C"
