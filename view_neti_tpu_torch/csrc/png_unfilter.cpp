// PNG row unfiltering (PNG specification, section 9: filter types None,
// Sub, Up, Average and Paeth), a host helper of data/image_io.py.
//
// Average and Paeth depend on the byte bpp places before in the same row,
// so a row is serial; a compiled loop decodes a 1600x1200 RGB scan in a
// few milliseconds where Python would take seconds.
//
// Built with the host C++ compiler into build/kernels/ at first use and
// loaded with ctypes (ops/build.py: host_library).
#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// src: height rows of (1 + rowbytes) bytes, each a filter-type byte and the
// filtered row (the inflated IDAT stream); dst: height x rowbytes bytes.
// bpp: bytes per complete pixel (at least 1). Returns 0, or 1 + the index
// of the first row with an unknown filter type.
int png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height,
                 int64_t rowbytes, int64_t bpp) {
  const uint8_t* prev = nullptr;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (rowbytes + 1);
    const uint8_t type = in[0];
    ++in;
    uint8_t* out = dst + y * rowbytes;
    for (int64_t x = 0; x < rowbytes; ++x) {
      const int a = x >= bpp ? out[x - bpp] : 0;
      const int b = prev ? prev[x] : 0;
      const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return static_cast<int>(y + 1);
      }
      out[x] = static_cast<uint8_t>(in[x] + pred);
    }
    prev = out;
  }
  return 0;
}

}  // extern "C"
