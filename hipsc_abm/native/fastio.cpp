// Native output tier: CSV serialization for the production run's host side.
//
// The framework's value CSVs (simulation.py step_values parity,
// reference simulation.py:300-347) stringify the float64-upcast hstack of
// every agent array — at 500k+ agents Python's csv module spends seconds
// per step on str() calls, and since outputs ride a single background
// worker (utils/io.py), that serialization bounds the end-to-end wall of
// the full-output production run (BENCHMARKS.md, BASELINE config 5).
//
// This file reproduces the Python output byte-for-byte:
//  - write_values_csv: Python repr(float) semantics (shortest round-trip
//    digits via std::to_chars, then CPython's fixed/scientific placement
//    rule: scientific iff decimal exponent > 15 or < -4, exponent printed
//    with a sign and at least two digits) and csv.writer's CRLF line ends.
//  - write_matrix_e18: np.savetxt(fmt='%.18e', delimiter=',') parity via
//    the same libc %..e formatting, LF line ends.
//
// Built lazily by hipsc_abm/native/__init__.py (g++ -O2 -shared) and
// bound with ctypes; every caller falls back to the Python writers when the
// toolchain or the .so is unavailable.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Python-repr a double into buf, returning the length. Matches
// CPython's format_float_short(type='r'): shortest round-trip digit
// string, fixed notation for decimal point position in (-3, 17),
// scientific otherwise with signed >=2-digit exponent.
int py_repr_double(double v, char* buf) {
  char* p = buf;
  if (std::isnan(v)) {
    std::memcpy(p, "nan", 3);
    return 3;
  }
  if (std::signbit(v)) *p++ = '-';
  if (std::isinf(v)) {
    std::memcpy(p, "inf", 3);
    return static_cast<int>(p - buf) + 3;
  }
  double a = std::fabs(v);

  // shortest round-trip digits + exponent from to_chars scientific:
  // "d[.ddd]e±x" with value = d.ddd * 10^x
  char sci[64];
  auto res = std::to_chars(sci, sci + sizeof(sci), a,
                           std::chars_format::scientific);
  char digits[32];
  int ndig = 0;
  int exp10 = 0;
  {
    char* s = sci;
    for (; s < res.ptr && *s != 'e'; ++s) {
      if (*s != '.') digits[ndig++] = *s;
    }
    ++s;  // past 'e'
    bool neg = (*s == '-');
    if (*s == '+' || *s == '-') ++s;
    for (; s < res.ptr; ++s) exp10 = exp10 * 10 + (*s - '0');
    if (neg) exp10 = -exp10;
  }
  int decpt = exp10 + 1;  // value = 0.digits * 10^decpt

  if (decpt > 16 || decpt < -3) {
    // scientific: d[.ddd]e±XX
    *p++ = digits[0];
    if (ndig > 1) {
      *p++ = '.';
      std::memcpy(p, digits + 1, ndig - 1);
      p += ndig - 1;
    }
    *p++ = 'e';
    *p++ = exp10 < 0 ? '-' : '+';
    int e = exp10 < 0 ? -exp10 : exp10;
    char ebuf[8];
    int en = 0;
    do {
      ebuf[en++] = static_cast<char>('0' + e % 10);
      e /= 10;
    } while (e);
    while (en < 2) ebuf[en++] = '0';
    while (en) *p++ = ebuf[--en];
  } else if (decpt <= 0) {
    // 0.000digits
    *p++ = '0';
    *p++ = '.';
    for (int i = 0; i < -decpt; ++i) *p++ = '0';
    std::memcpy(p, digits, ndig);
    p += ndig;
  } else if (decpt >= ndig) {
    // digits000.0
    std::memcpy(p, digits, ndig);
    p += ndig;
    for (int i = 0; i < decpt - ndig; ++i) *p++ = '0';
    *p++ = '.';
    *p++ = '0';
  } else {
    // dig.its
    std::memcpy(p, digits, decpt);
    p += decpt;
    *p++ = '.';
    std::memcpy(p, digits + decpt, ndig - decpt);
    p += ndig - decpt;
  }
  return static_cast<int>(p - buf);
}

struct FileCloser {
  std::FILE* f;
  ~FileCloser() {
    if (f) std::fclose(f);
  }
};

}  // namespace

extern "C" {

// Direct formatter export so tests can property-check byte parity with
// Python's repr. Returns the formatted length; buf needs >= 40 bytes.
int hipsc_fmt_repr(double v, char* buf) { return py_repr_double(v, buf); }

// Values CSV (csv.writer parity: header line then one row per agent, CRLF
// line terminators, no trailing separator). cols: ncols pointers to
// contiguous float64 columns of length nrows. Rows are formatted in
// parallel chunks (per-chunk buffers, written in order), since the Python
// side serializes all outputs through one background worker thread.
// Returns 0 on success.
int hipsc_write_values_csv(const char* path, const char* header_line,
                           int64_t nrows, int32_t ncols,
                           const double** cols) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  FileCloser closer{f};

  if (std::fputs(header_line, f) == EOF) return 2;
  if (std::fwrite("\r\n", 1, 2, f) != 2) return 2;

  unsigned hw = std::thread::hardware_concurrency();
  int64_t nchunks = std::min<int64_t>(
      std::max<unsigned>(1, std::min(hw, 16u)), std::max<int64_t>(nrows, 1));
  int64_t per = (nrows + nchunks - 1) / nchunks;
  std::vector<std::string> bufs(nchunks);

  auto fmt_chunk = [&](int64_t k) {
    // ceil-division chunks can run out before the last k (nrows=17 over
    // 16 chunks of 2): clamp, or hi - lo goes negative and reserve() throws
    int64_t lo = std::min(nrows, k * per), hi = std::min(nrows, lo + per);
    if (lo >= hi) return;
    std::string& buf = bufs[k];
    buf.reserve((hi - lo) * (ncols * 10 + 2));
    char num[48];
    for (int64_t r = lo; r < hi; ++r) {
      for (int32_t c = 0; c < ncols; ++c) {
        if (c) buf.push_back(',');
        int n = py_repr_double(cols[c][r], num);
        buf.append(num, n);
      }
      buf.append("\r\n");
    }
  };
  std::vector<std::thread> threads;
  for (int64_t k = 1; k < nchunks; ++k) threads.emplace_back(fmt_chunk, k);
  fmt_chunk(0);
  for (auto& t : threads) t.join();

  for (auto& buf : bufs)
    if (!buf.empty() &&
        std::fwrite(buf.data(), 1, buf.size(), f) != buf.size())
      return 2;
  return 0;
}

// np.savetxt(fmt='%.18e', delimiter=',') parity: LF line ends, one
// trailing newline per row, parallel chunk formatting as above.
// Returns 0 on success.
int hipsc_write_matrix_e18(const char* path, const double* data,
                           int64_t nrows, int64_t ncols) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  FileCloser closer{f};

  unsigned hw = std::thread::hardware_concurrency();
  int64_t nchunks = std::min<int64_t>(
      std::max<unsigned>(1, std::min(hw, 16u)), std::max<int64_t>(nrows, 1));
  int64_t per = (nrows + nchunks - 1) / nchunks;
  std::vector<std::string> bufs(nchunks);

  auto fmt_chunk = [&](int64_t k) {
    // ceil-division chunks can run out before the last k (nrows=17 over
    // 16 chunks of 2): clamp, or hi - lo goes negative and reserve() throws
    int64_t lo = std::min(nrows, k * per), hi = std::min(nrows, lo + per);
    if (lo >= hi) return;
    std::string& buf = bufs[k];
    buf.reserve((hi - lo) * (ncols * 26 + 1));
    char num[64];
    for (int64_t r = lo; r < hi; ++r) {
      const double* row = data + r * ncols;
      for (int64_t c = 0; c < ncols; ++c) {
        if (c) buf.push_back(',');
        int n = std::snprintf(num, sizeof(num), "%.18e", row[c]);
        buf.append(num, n);
      }
      buf.push_back('\n');
    }
  };
  std::vector<std::thread> threads;
  for (int64_t k = 1; k < nchunks; ++k) threads.emplace_back(fmt_chunk, k);
  fmt_chunk(0);
  for (auto& t : threads) t.join();

  for (auto& buf : bufs)
    if (!buf.empty() &&
        std::fwrite(buf.data(), 1, buf.size(), f) != buf.size())
      return 2;
  return 0;
}

}  // extern "C"
