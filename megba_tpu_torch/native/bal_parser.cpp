// Fast BAL text parser — the native data-loader of the host runtime.
//
// Role equivalent of the reference's example-side line parser
// (reference examples/BAL_Double.cpp:74-139, which fscanf's 4.5M
// observation lines for Final-13682) and of its host-side problem
// construction costs (SURVEY.md section 3.1 flags SoA appends as the
// build bottleneck).  Design is new: read the file into one
// NUL-terminated buffer (safe for token scanners even when the file ends
// mid-token) and scan it once with std::from_chars — locale-independent,
// allocation-free number parsing.  C ABI for ctypes binding — no
// pybind11 in this image.

#include <cctype>
#include <cerrno>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Cursor {
  const char* p;
  const char* end;  // points at the trailing '\0'
};

inline void skip_space(Cursor& c) {
  while (c.p < c.end && std::isspace(static_cast<unsigned char>(*c.p))) ++c.p;
}

// Locale-independent double parse; BAL files use plain C formatting.
inline bool next_double(Cursor& c, double* out) {
  skip_space(c);
  if (c.p >= c.end) return false;
  auto res = std::from_chars(c.p, c.end, *out);
  if (res.ec != std::errc() || res.ptr == c.p) return false;
  c.p = res.ptr;
  return true;
}

inline bool next_long(Cursor& c, long* out) {
  skip_space(c);
  if (c.p >= c.end) return false;
  auto res = std::from_chars(c.p, c.end, *out, 10);
  if (res.ec != std::errc() || res.ptr == c.p) return false;
  c.p = res.ptr;
  return true;
}

// Whole-file read with a trailing NUL so scanning can never run past the
// buffer (mmap would leave the final token unterminated when the file
// size is an exact multiple of the page size).
struct Buffer {
  std::vector<char> data;

  bool load(const char* path) {
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    if (sz < 0) {
      std::fclose(f);
      return false;
    }
    std::fseek(f, 0, SEEK_SET);
    data.resize(static_cast<size_t>(sz) + 1);
    size_t got = sz ? std::fread(data.data(), 1, static_cast<size_t>(sz), f) : 0;
    std::fclose(f);
    if (got != static_cast<size_t>(sz)) return false;
    data[static_cast<size_t>(sz)] = '\0';
    return true;
  }

  Cursor cursor() const {
    return Cursor{data.data(), data.data() + data.size() - 1};
  }
};

}  // namespace

extern "C" {

// Reads only the header. Returns 0 on success.
int megba_bal_header(const char* path, int64_t* n_cam, int64_t* n_pt,
                     int64_t* n_obs) {
  Buffer b;
  if (!b.load(path)) return -1;
  Cursor c = b.cursor();
  long a, bb, d;
  if (!next_long(c, &a) || !next_long(c, &bb) || !next_long(c, &d)) return -2;
  if (a < 0 || bb < 0 || d < 0) return -3;
  *n_cam = a;
  *n_pt = bb;
  *n_obs = d;
  return 0;
}

// Full parse into caller-allocated buffers:
//   obs      [n_obs * 2] double
//   cam_idx  [n_obs] int32
//   pt_idx   [n_obs] int32
//   cameras  [n_cam * 9] double
//   points   [n_pt * 3] double
// Returns 0 on success, negative error codes on malformed input.
int megba_bal_parse(const char* path, int64_t n_cam, int64_t n_pt,
                    int64_t n_obs, double* obs, int32_t* cam_idx,
                    int32_t* pt_idx, double* cameras, double* points) {
  Buffer b;
  if (!b.load(path)) return -1;
  Cursor c = b.cursor();
  long a, bb, d;
  if (!next_long(c, &a) || !next_long(c, &bb) || !next_long(c, &d)) return -2;
  if (a != n_cam || bb != n_pt || d != n_obs) return -3;

  for (int64_t i = 0; i < n_obs; ++i) {
    long ci, pi;
    double u, v;
    if (!next_long(c, &ci) || !next_long(c, &pi) || !next_double(c, &u) ||
        !next_double(c, &v))
      return -4;
    if (ci < 0 || ci >= n_cam || pi < 0 || pi >= n_pt) return -5;
    cam_idx[i] = static_cast<int32_t>(ci);
    pt_idx[i] = static_cast<int32_t>(pi);
    obs[2 * i] = u;
    obs[2 * i + 1] = v;
  }
  for (int64_t i = 0; i < n_cam * 9; ++i)
    if (!next_double(c, &cameras[i])) return -6;
  for (int64_t i = 0; i < n_pt * 3; ++i)
    if (!next_double(c, &points[i])) return -7;
  skip_space(c);
  if (c.p != c.end) return -8;  // trailing garbage
  return 0;
}

}  // extern "C"
