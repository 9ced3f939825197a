// Huffman-coded JPEG decoding (ITU-T T.81: baseline, extended-sequential
// and progressive, SOF0/SOF1/SOF2, 8-bit samples), a host helper of
// data/image_io.py.
//
// The output is what PIL's Image.open(p).convert("RGB") gives through
// libjpeg-turbo with its defaults, bit for bit, so the arithmetic is
// libjpeg-turbo's:
//   * progressive scans into a whole-image coefficient buffer (jdphuff.c):
//     DC first and refinement scans, AC first scans with EOB runs, AC
//     refinement with correction bits; restarts reset the DC predictors
//     and the EOB run;
//   * block smoothing (jdcoefct.c, libjpeg-turbo >= 2.1): when the scans
//     leave the DC or one of the first nine AC coefficients not fully
//     refined, each block's missing low-frequency coefficients are
//     estimated from the DC values of its 5x5 neighbourhood;
//   * the JDCT_ISLOW integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2,
//     DESCALE rounding, the post-IDCT range-limit table indexed with
//     RANGE_MASK);
//   * "fancy" triangular chroma upsampling (jdsample.c): h2v1 with the
//     alternating +1/+2 bias, h2v2 over the rows above and below with
//     +8/+7, h1v2 with +1/+2; the first and last column and row repeated
//     (jdmainct.c duplicates the image's first and last sample rows as
//     context); plain replication when a component is 2 samples wide or
//     less, or for other integral factors;
//   * the fixed-point YCbCr->RGB tables of jdcolor.c (SCALEBITS 16), and
//     for four-component files its YCCK->CMYK conversion (Adobe transform
//     2) or CMYK as stored; then Pillow's reading of those samples as
//     inverted CMYK ("CMYK;I") and its CMYK->RGB conversion.
// Gray images come out with one channel, the others with three. EXIF
// orientation is not applied. Decoding stops at the first EOI, so a second
// image after it (an MPO's) is not read. A file without Huffman tables
// (a motion-JPEG frame) gets the standard ones, as libjpeg gives them.
//
// Lossless, hierarchical and arithmetic-coded files, 12-bit samples and
// truncated or corrupt entropy-coded data fail with a message naming the
// feature.
//
// Built with the host C++ compiler into build/kernels/ at first use and
// loaded with ctypes (ops/build.py: host_library).
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for run lengths past the block's end (as libjpeg's
    // jpeg_natural_order), so that a corrupt run stays in the block
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t mincode[17] = {}, maxcode[18] = {}, valptr[17] = {};
  uint8_t look_nbits[512] = {};   // 9-bit lookahead: code length, 0 = slow
  uint8_t look_sym[512] = {};

  void build(const uint8_t* bits, const uint8_t* values, int count) {
    std::memcpy(vals, values, count);
    int code = 0, k = 0;
    std::memset(look_nbits, 0, sizeof(look_nbits));
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l]; ++i) {
        if (l <= 9) {
          const int lo = code << (9 - l), n = 1 << (9 - l);
          for (int j = 0; j < n; ++j) {
            look_nbits[lo + j] = static_cast<uint8_t>(l);
            look_sym[lo + j] = values[k];
          }
        }
        ++code;
        ++k;
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      if (code > (1 << l)) fail("corrupt JPEG: bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

// The standard Huffman tables of ITU-T T.81 K.3 (counts per code length
// 1-16, then the values): luminance and chrominance DC and AC, which
// libjpeg installs in slots 0 and 1 when a file defines no table there
// (motion-JPEG frames; jdhuff.c: std_huff_tables).
const uint8_t kStdBits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLuma[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChroma[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;          // Huffman tables of the current scan
  int bw = 0, bh = 0;          // blocks across and down, MCU-padded
  int ds_w = 0, ds_h = 0;      // samples across and down (downsampled_*)
  int dc_pred = 0;
  std::vector<int16_t> coef;   // bh x bw blocks of 64, natural order
  // the quantization table, latched at the component's first scan (as
  // libjpeg's latch_quant_tables)
  bool latched = false;
  uint16_t quant[64] = {};
  // per zigzag position: -1 before any scan, then the Al of the last scan
  // that coded it (0: exact); libjpeg's coef_bits
  int coef_bits[64];
  Component() { std::fill(coef_bits, coef_bits + 64, -1); }
};

// Entropy-coded data: byte stuffing removed, zero bits supplied past a
// marker or the end of the data (as libjpeg does), and an error when a
// decode consumes one of those bits.
struct BitReader {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  int fake = 0;                 // zero bits past the data, at acc's bottom
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      int b = 0;
      if (at_marker || pos >= n) {
        at_marker = true;
        fake += 8;
      } else if (d[pos] == 0xFF) {
        if (pos + 1 < n && d[pos + 1] == 0x00) {
          b = 0xFF;
          pos += 2;
        } else {
          at_marker = true;
          fake += 8;
        }
      } else {
        b = d[pos++];
      }
      acc |= static_cast<uint64_t>(b) << (56 - nbits);
      nbits += 8;
    }
  }
  int peek(int k) {
    if (nbits < k) fill();
    return static_cast<int>(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    nbits -= k;
    if (nbits < fake)
      fail("truncated or corrupt JPEG: entropy-coded data ends early");
  }
  int bits(int k) {
    if (k == 0) return 0;
    const int v = peek(k);
    skip(k);
    return v;
  }
  // Discard the buffered bits and move to the next marker.
  void reset() {
    acc = 0;
    nbits = fake = 0;
    at_marker = false;
    while (pos < n) {
      if (d[pos] == 0xFF && pos + 1 < n && d[pos + 1] != 0x00 &&
          d[pos + 1] != 0xFF)
        return;
      ++pos;
    }
  }
};

inline int extend(int v, int t) {
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

int decode_huffman(BitReader& br, const Huffman& h) {
  const int look = br.peek(9);
  const int nb = h.look_nbits[look];
  if (nb) {
    br.skip(nb);
    return h.look_sym[look];
  }
  for (int l = 10; l <= 16; ++l) {
    const int code = br.peek(l);
    if (code <= h.maxcode[l]) {
      br.skip(l);
      return h.vals[h.valptr[l] + code - h.mincode[l]];
    }
  }
  fail("corrupt JPEG: bad Huffman code");
}

// jidctint.c (libjpeg-turbo), jpeg_idct_islow
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

struct RangeLimit {
  // libjpeg's sample_range_limit table; idct() indexes it at
  // CENTERJSAMPLE (128) + (value & RANGE_MASK)
  uint8_t table[5 * 256 + 128];
  const uint8_t* idct;
  RangeLimit() {
    uint8_t* t = table + 256;
    std::memset(table, 0, 256);
    for (int i = 0; i < 256; ++i) t[i] = static_cast<uint8_t>(i);
    t += 128;
    for (int i = 128; i < 512; ++i) t[i] = 255;
    std::memset(t + 512, 0, 512 - 128);
    std::memcpy(t + 1024 - 128, table + 256, 128);
    idct = t;
  }
};

const RangeLimit kRange;
constexpr int RANGE_MASK = 1023;

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int* w = ws + c;
    auto dq = [&](int r) { return int64_t{in[8 * r]} * q[8 * r]; };
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      const int dc = static_cast<int>(dq(0) * (1 << PASS1_BITS));
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = dq(2), z3 = dq(6);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = dq(0);
    z3 = dq(4);
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = dq(7);
    tmp1 = dq(5);
    tmp2 = dq(3);
    tmp3 = dq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CONST_BITS - PASS1_BITS;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, s));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, s));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, s));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, s));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, s));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, s));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, s));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, s));
  }
  const uint8_t* lim = kRange.idct;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<int64_t>(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v =
          lim[static_cast<int>(descale(w[0], PASS1_BITS + 3)) & RANGE_MASK];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t{w[0]} + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (int64_t{w[0]} - w[4]) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CONST_BITS + PASS1_BITS + 3;
    auto put = [&](int c, int64_t x) {
      o[c] = lim[static_cast<int>(descale(x, s)) & RANGE_MASK];
    };
    put(0, tmp10 + tmp3);
    put(7, tmp10 - tmp3);
    put(1, tmp11 + tmp2);
    put(6, tmp11 - tmp2);
    put(2, tmp12 + tmp1);
    put(5, tmp12 - tmp1);
    put(3, tmp13 + tmp0);
    put(4, tmp13 - tmp0);
  }
}

// The smoothing estimate of one coefficient (jdcoefct.c): num / Q rounded
// half away from zero, at most (1 << Al) - 1 in magnitude when Al > 0.
inline int smooth_pred(int64_t num, int64_t q, int al) {
  int pred = static_cast<int>(((q << 7) + (num >= 0 ? num : -num)) /
                              (q << 8));
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return num >= 0 ? pred : -pred;
}

// Pillow's CMYK->RGB (Convert.c: cmyk2rgb) on samples it unpacked as
// inverted CMYK ("CMYK;I"): with the stored samples c and k, nk = k and
// each channel is nk - MULDIV255(255 - c, nk).
inline uint8_t cmyk_channel(int c, int k) {
  const int t = (255 - c) * k + 128;
  const int v = k - (((t >> 8) + t) >> 8);
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

struct Decoder {
  const uint8_t* d;
  int64_t n;
  int64_t pos = 0;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  bool frame = false, progressive = false;
  int scans = 0;
  std::vector<Component> comps;
  uint16_t quant[4][64] = {};
  bool quant_defined[4] = {};
  Huffman dc[4], ac[4];

  Decoder(const uint8_t* data, int64_t size) : d(data), n(size) {}

  int u8() {
    if (pos >= n) fail("truncated JPEG: ends inside a marker segment");
    return d[pos++];
  }
  int u16() {
    const int hi = u8();
    return (hi << 8) | u8();
  }

  // The next marker code, skipping fill bytes (and stray data).
  int next_marker() {
    while (pos < n) {
      if (d[pos] != 0xFF) {
        ++pos;
        continue;
      }
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) break;
      const int m = d[pos++];
      if (m != 0x00) return m;
    }
    return -1;
  }

  void parse_header() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    while (true) {
      const int m = next_marker();
      if (m < 0) fail("truncated JPEG: no start of scan");
      if (m == 0xDA) {
        if (!frame) fail("corrupt JPEG: scan before the frame header");
        pos -= 2;           // decode() reads the SOS segment
        const uint8_t* ac_vals[2] = {kStdAcLuma, kStdAcChroma};
        for (int t = 0; t < 2; ++t) {
          if (!dc[t].defined) dc[t].build(kStdBits[t], kStdDcVals, 12);
          if (!ac[t].defined) ac[t].build(kStdBits[2 + t], ac_vals[t], 162);
        }
        return;
      }
      segment(m);
    }
  }

  void segment(int m) {
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) return;
    if (m == 0xD9) fail("truncated JPEG: end of image before any scan");
    const int64_t start = pos;
    const int len = u16();
    if (len < 2 || start + len > n)
      fail("truncated JPEG: ends inside a marker segment");
    const int64_t end = start + len;
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
        sof(end, m == 0xC2);
        break;
      case 0xC3:
        fail("lossless JPEG (SOF3) is not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xDE:
        fail("hierarchical JPEG (SOF5-7, DHP) is not supported");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCC:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        fail("arithmetic-coded JPEG (SOF9-11, SOF13-15, DAC) is not "
             "supported");
      case 0xC4:
        dht(end);
        break;
      case 0xDB:
        dqt(end);
        break;
      case 0xDD:
        restart_interval = u16();
        break;
      case 0xDC:
        fail("JPEG with a DNL marker is not supported");
      case 0xE0:
        if (len >= 7 && std::memcmp(d + pos, "JFIF\0", 5) == 0)
          saw_jfif = true;
        break;
      case 0xEE:
        if (len >= 14 && std::memcmp(d + pos, "Adobe", 5) == 0) {
          saw_adobe = true;
          adobe_transform = d[pos + 11];
        }
        break;
      default:
        break;              // APPn, COM and the rest: skipped
    }
    pos = end;
  }

  void sof(int64_t end, bool prog) {
    if (frame) fail("corrupt JPEG: two frame headers");
    progressive = prog;
    const int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG is not supported");
    height = u16();
    width = u16();
    const int nc = u8();
    if (height == 0) fail("JPEG with a DNL marker is not supported");
    if (width == 0) fail("corrupt JPEG: zero width");
    if (nc != 1 && nc != 3 && nc != 4)
      fail("JPEG with " + std::to_string(nc) + " components is not "
           "supported");
    if (pos + 3 * nc > end) fail("corrupt JPEG: short frame header");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt JPEG: bad component parameters");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v)
        fail("JPEG with non-integral sampling factors is not supported");
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      c.ds_w = static_cast<int>(
          (static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.ds_h = static_cast<int>(
          (static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
    frame = true;
  }

  void dht(int64_t end) {
    while (pos < end) {
      const int tc_th = u8();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: bad Huffman table id");
      uint8_t bits[17] = {};
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = static_cast<uint8_t>(u8());
        count += bits[l];
      }
      if (count > 256 || pos + count > end)
        fail("corrupt JPEG: bad Huffman table");
      (tc ? ac : dc)[th].build(bits, d + pos, count);
      pos += count;
    }
  }

  void dqt(int64_t end) {
    while (pos < end) {
      const int pq_tq = u8();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) fail("corrupt JPEG: bad quantization table");
      for (int k = 0; k < 64; ++k)
        quant[tq][kZigzag[k]] = static_cast<uint16_t>(pq ? u16() : u8());
      quant_defined[tq] = true;
    }
  }

  // A sequential scan's block: DC difference and the 63 AC coefficients.
  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    const int s = decode_huffman(br, dc[c.td]);
    const int diff = s ? extend(br.bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      const int rs = decode_huffman(br, ac[c.ta]);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        blk[kZigzag[k]] = static_cast<int16_t>(extend(br.bits(sz), sz));
      } else if (r == 15) {
        k += 15;
      } else {
        break;
      }
    }
  }

  // The progressive scan kinds (jdphuff.c). Values are scaled by 1 << al
  // as unsigned shifts (libjpeg's LEFT_SHIFT).
  static int16_t scaled(int v, int al) {
    return static_cast<int16_t>(static_cast<uint32_t>(v) << al);
  }

  void dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    const int s = decode_huffman(br, dc[c.td]);
    c.dc_pred += s ? extend(br.bits(s), s) : 0;
    blk[0] = scaled(c.dc_pred, al);
  }

  static void dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  void ac_first(BitReader& br, const Huffman& h, int16_t* blk, int ss,
                int se, int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = decode_huffman(br, h);
      int r = rs >> 4;
      const int sz = rs & 15;
      if (sz) {
        k += r;
        blk[kZigzag[k]] = scaled(extend(br.bits(sz), sz), al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) + br.bits(r) - 1;
        break;
      }
    }
  }

  static void refine_bit(BitReader& br, int16_t& coef, int p1) {
    if (br.bits(1) && (coef & p1) == 0)
      coef = static_cast<int16_t>(coef >= 0 ? coef + p1 : coef - p1);
  }

  void ac_refine(BitReader& br, const Huffman& h, int16_t* blk, int ss,
                 int se, int al, int& eobrun) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = decode_huffman(br, h);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = br.bits(1) ? p1 : -p1;
        } else if (r != 15) {
          eobrun = (1 << r) + br.bits(r);
          break;                  // the rest of the block is an EOB run
        }
        // advance over the nonzero coefficients, appending their
        // correction bits, and over r zero ones
        do {
          int16_t& coef = blk[kZigzag[k]];
          if (coef != 0) {
            refine_bit(br, coef, p1);
          } else if (--r < 0) {
            break;                // the zero coefficient to set
          }
          ++k;
        } while (k <= se);
        if (s) blk[kZigzag[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kZigzag[k]];
        if (coef != 0) refine_bit(br, coef, p1);
      }
      --eobrun;
    }
  }

  void scan(int64_t seg_end) {
    const int ns = u8();
    if (ns < 1 || ns > 4) fail("corrupt JPEG: bad scan header");
    std::vector<Component*> in_scan;
    for (int i = 0; i < ns; ++i) {
      const int id = u8(), tables = u8();
      Component* c = nullptr;
      for (auto& x : comps)
        if (x.id == id) c = &x;
      if (!c) fail("corrupt JPEG: scan names an unknown component");
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > 3 || c->ta > 3)
        fail("corrupt JPEG: bad Huffman table id in a scan");
      in_scan.push_back(c);
    }
    const int ss = u8(), se = u8(), ahal = u8();
    const int ah = ahal >> 4, al = ahal & 15;
    if (!progressive) {
      if (ss != 0 || se != 63 || ahal != 0)
        fail("corrupt JPEG: not a sequential scan");
    } else if ((ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) ||
               (ah != 0 && al != ah - 1) || al > 13) {
      fail("corrupt JPEG: bad progression parameters");
    }
    const bool dc_scan = ss == 0, first = ah == 0;
    for (auto* c : in_scan) {
      const bool need_dc = !progressive || (dc_scan && first);
      const bool need_ac = !progressive || !dc_scan;
      if ((need_dc && !dc[c->td].defined) || (need_ac && !ac[c->ta].defined))
        fail("corrupt JPEG: scan uses an undefined Huffman table");
      if (!c->latched) {
        if (!quant_defined[c->tq])
          fail("corrupt JPEG: undefined quantization table");
        std::memcpy(c->quant, quant[c->tq], sizeof(c->quant));
        c->latched = true;
      }
      for (int k = ss; k <= se; ++k) c->coef_bits[k] = progressive ? al : 0;
    }
    pos = seg_end;
    for (auto* c : in_scan) c->dc_pred = 0;
    BitReader br{d, n, pos};
    int next_rst = 0, eobrun = 0;
    int64_t todo = 0;
    int units_x, units_y;
    if (ns == 1) {
      // a non-interleaved scan: one block per unit over the component's
      // own blocks, not the MCU-padded grid
      units_x = (in_scan[0]->ds_w + 7) / 8;
      units_y = (in_scan[0]->ds_h + 7) / 8;
    } else {
      units_x = mcus_x;
      units_y = mcus_y;
    }
    auto block = [&](Component& c, int16_t* blk) {
      if (!progressive)
        decode_block(br, c, blk);
      else if (dc_scan && first)
        dc_first(br, c, blk, al);
      else if (dc_scan)
        dc_refine(br, blk, al);
      else if (first)
        ac_first(br, ac[c.ta], blk, ss, se, al, eobrun);
      else
        ac_refine(br, ac[c.ta], blk, ss, se, al, eobrun);
    };
    for (int uy = 0; uy < units_y; ++uy) {
      for (int ux = 0; ux < units_x; ++ux) {
        if (restart_interval && todo == restart_interval) {
          br.reset();
          if (br.pos + 1 >= n || d[br.pos + 1] != 0xD0 + next_rst)
            fail("corrupt JPEG: missing restart marker");
          br.pos += 2;
          next_rst = (next_rst + 1) & 7;
          todo = 0;
          eobrun = 0;
          for (auto* c : in_scan) c->dc_pred = 0;
        }
        ++todo;
        if (ns == 1) {
          Component& c = *in_scan[0];
          block(c, c.coef.data() + (static_cast<size_t>(uy) * c.bw + ux) * 64);
          continue;
        }
        for (auto* cp : in_scan) {
          Component& c = *cp;
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx) {
              const size_t row = static_cast<size_t>(uy) * c.v + by;
              const size_t col = static_cast<size_t>(ux) * c.h + bx;
              block(c, c.coef.data() + (row * c.bw + col) * 64);
            }
        }
      }
    }
    br.reset();
    pos = br.pos;
    ++scans;
  }

  // Every scan up to the first EOI (or the end of the data, as libjpeg
  // takes a file without one).
  void decode_scans() {
    while (true) {
      const int m = next_marker();
      if (m < 0) {
        if (scans) return;
        fail("truncated JPEG: no scan");
      }
      if (m == 0xD9) return;
      if (m == 0xDA) {
        const int64_t start = pos;
        const int len = u16();
        if (len < 2 || start + len > n)
          fail("truncated JPEG: ends inside a marker segment");
        scan(start + len);
      } else {
        segment(m);
      }
    }
  }

  // jdcoefct.c's smoothing_ok: a progressive file whose every component
  // has its DC at least partly known and nonzero quantizers at the DC and
  // the first nine AC positions (zigzag 0-9), and some of those AC
  // coefficients not exact.
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (const auto& c : comps) {
      if (!c.latched) return false;
      for (int k = 0; k < 10; ++k)
        if (c.quant[kZigzag[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // One component's samples (its MCU-padded blocks, stride bw * 8): the
  // IDCT of every block, through jdcoefct.c's decompress_smooth_data when
  // `smooth`: the component's own blocks (not the padding), each with the
  // DC values of the rows above and below as it picks them per iMCU row
  // (the MCU-padded rows and its count of the last row's blocks
  // included), estimating only coefficients that are zero and not exact.
  void component_plane(const Component& c, bool smooth,
                       std::vector<uint8_t>& plane) const {
    const int stride = c.bw * 8;
    plane.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
    auto blk = [&](int row, int col) {
      return c.coef.data() + (static_cast<size_t>(row) * c.bw + col) * 64;
    };
    auto out = [&](int row, int col) {
      return plane.data() + static_cast<size_t>(row) * 8 * stride + col * 8;
    };
    if (!smooth) {
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(blk(by, bx), c.quant, out(by, bx), stride);
      return;
    }
    const int* bits = c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
    const int64_t Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8],
                  Q20 = c.quant[16], Q11 = c.quant[9], Q02 = c.quant[2],
                  Q03 = c.quant[3], Q12 = c.quant[10], Q21 = c.quant[17],
                  Q30 = c.quant[24];
    const int hib = (c.ds_h + 7) / 8, wib = (c.ds_w + 7) / 8;
    const int total = mcus_y, last_col = wib - 1;
    int16_t ws[64];
    for (int r = 0; r < total; ++r) {
      int block_rows = c.v;
      if (r == total - 1 && hib % c.v) block_rows = hib % c.v;
      const int image_block_rows = block_rows * total;
      for (int b = 0; b < block_rows; ++b) {
        const int R = r * c.v + b, ibr = r * block_rows + b;
        const int prev = ibr > 0 ? R - 1 : R;
        const int pprev = ibr > 1 ? R - 2 : prev;
        const int next = ibr < image_block_rows - 1 ? R + 1 : R;
        const int nnext = ibr < image_block_rows - 2 ? R + 2 : next;
        const int rows[5] = {pprev, prev, R, next, nnext};
        for (int col = 0; col <= last_col; ++col) {
          std::memcpy(ws, blk(R, col), sizeof(ws));
          // DC[i][j]: the 5x5 window's row i, column j (2, 2: this block);
          // columns past the component's blocks repeat the edge's
          int DC[5][5];
          for (int j = 0; j < 5; ++j) {
            const int x = std::min(std::max(col + j - 2, 0), last_col);
            for (int i = 0; i < 5; ++i) DC[i][j] = blk(rows[i], x)[0];
          }
          const int DC01 = DC[0][0], DC02 = DC[0][1], DC03 = DC[0][2],
                    DC04 = DC[0][3], DC05 = DC[0][4], DC06 = DC[1][0],
                    DC07 = DC[1][1], DC08 = DC[1][2], DC09 = DC[1][3],
                    DC10 = DC[1][4], DC11 = DC[2][0], DC12 = DC[2][1],
                    DC13 = DC[2][2], DC14 = DC[2][3], DC15 = DC[2][4],
                    DC16 = DC[3][0], DC17 = DC[3][1], DC18 = DC[3][2],
                    DC19 = DC[3][3], DC20 = DC[3][4], DC21 = DC[4][0],
                    DC22 = DC[4][1], DC23 = DC[4][2], DC24 = DC[4][3],
                    DC25 = DC[4][4];
          int al;
          if ((al = bits[1]) != 0 && ws[1] == 0)
            ws[1] = static_cast<int16_t>(smooth_pred(Q00 * (change_dc ?
                (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                 13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
                 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                 DC21 - DC22 + DC24 + DC25) :
                (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)), Q01, al));
          if ((al = bits[2]) != 0 && ws[8] == 0)
            ws[8] = static_cast<int16_t>(smooth_pred(Q00 * (change_dc ?
                (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
                (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)), Q10, al));
          if ((al = bits[3]) != 0 && ws[16] == 0)
            ws[16] = static_cast<int16_t>(smooth_pred(Q00 * (change_dc ?
                (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                 14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
                 DC23) :
                (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)),
                Q20, al));
          if ((al = bits[4]) != 0 && ws[9] == 0)
            ws[9] = static_cast<int16_t>(smooth_pred(Q00 * (change_dc ?
                (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                 DC21 - DC25) :
                (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                 DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09)), Q11, al));
          if ((al = bits[5]) != 0 && ws[2] == 0)
            ws[2] = static_cast<int16_t>(smooth_pred(Q00 * (change_dc ?
                (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                 14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                 2 * DC19) :
                (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)),
                Q02, al));
          if (change_dc) {
            if ((al = bits[6]) != 0 && ws[3] == 0)
              ws[3] = static_cast<int16_t>(smooth_pred(Q00 *
                  (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19),
                  Q03, al));
            if ((al = bits[7]) != 0 && ws[10] == 0)
              ws[10] = static_cast<int16_t>(smooth_pred(Q00 *
                  (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19),
                  Q12, al));
            if ((al = bits[8]) != 0 && ws[17] == 0)
              ws[17] = static_cast<int16_t>(smooth_pred(Q00 *
                  (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19),
                  Q21, al));
            if ((al = bits[9]) != 0 && ws[24] == 0)
              ws[24] = static_cast<int16_t>(smooth_pred(Q00 *
                  (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19),
                  Q30, al));
            ws[0] = static_cast<int16_t>(smooth_pred(Q00 *
                (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                 6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25),
                Q00, 0));
          }
          idct_islow(ws, c.quant, out(R, col), stride);
        }
      }
    }
  }

  // The component's samples at full size: plane (ds_h x ds_w) -> out
  // (height x width), libjpeg-turbo's upsampling.
  static void upsample(const std::vector<uint8_t>& plane, int stride,
                       const Component& c, int hf, int vf, int width,
                       int height, std::vector<uint8_t>& out) {
    out.assign(static_cast<size_t>(width) * height, 0);
    const int W = c.ds_w, H = c.ds_h;
    auto at = [&](int y, int x) -> int {
      y = y < 0 ? 0 : (y >= H ? H - 1 : y);
      return plane[static_cast<size_t>(y) * stride + x];
    };
    const bool h2v1 = hf == 2 && vf == 1 && W > 2;
    const bool h2v2 = hf == 2 && vf == 2 && W > 2;
    const bool h1v2 = hf == 1 && vf == 2;
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out.data() + static_cast<size_t>(y) * width;
      const int iy = y / vf;
      if (h2v1) {
        for (int x = 0; x < width; ++x) {
          const int ix = x >> 1;
          const int near = at(iy, ix);
          if (x & 1) {
            const int far = at(iy, ix + 1 < W ? ix + 1 : W - 1);
            o[x] = static_cast<uint8_t>((near * 3 + far + 2) >> 2);
          } else {
            const int far = at(iy, ix > 0 ? ix - 1 : 0);
            o[x] = static_cast<uint8_t>((near * 3 + far + 1) >> 2);
          }
        }
      } else if (h2v2) {
        const int other = (y & 1) ? iy + 1 : iy - 1;
        auto colsum = [&](int ix) {
          ix = ix < 0 ? 0 : (ix >= W ? W - 1 : ix);
          return at(iy, ix) * 3 + at(other, ix);
        };
        for (int x = 0; x < width; ++x) {
          const int ix = x >> 1;
          const int here = colsum(ix);
          if (x & 1)
            o[x] = static_cast<uint8_t>((here * 3 + colsum(ix + 1) + 7) >> 4);
          else
            o[x] = static_cast<uint8_t>((here * 3 + colsum(ix - 1) + 8) >> 4);
        }
      } else if (h1v2) {
        const int other = (y & 1) ? iy + 1 : iy - 1;
        const int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; ++x)
          o[x] = static_cast<uint8_t>(
              (at(iy, x) * 3 + at(other, x) + bias) >> 2);
      } else {
        for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>(
            plane[static_cast<size_t>(iy) * stride + x / hf]);
      }
    }
  }

  void output(uint8_t* out) {
    const int nc = static_cast<int>(comps.size());
    const bool smooth = smoothing_ok();
    std::vector<std::vector<uint8_t>> full(nc);
    std::vector<uint8_t> plane;
    for (int ci = 0; ci < nc; ++ci) {
      Component& c = comps[ci];
      if (!c.latched) fail("corrupt JPEG: a component in no scan");
      component_plane(c, smooth, plane);
      const int stride = c.bw * 8;
      const int hf = hmax / c.h, vf = vmax / c.v;
      if (hf == 1 && vf == 1) {
        full[ci].resize(static_cast<size_t>(width) * height);
        for (int y = 0; y < height; ++y)
          std::memcpy(full[ci].data() + static_cast<size_t>(y) * width,
                      plane.data() + static_cast<size_t>(y) * stride, width);
      } else {
        upsample(plane, stride, c, hf, vf, width, height, full[ci]);
      }
    }
    const size_t npix = static_cast<size_t>(width) * height;
    if (nc == 1) {
      std::memcpy(out, full[0].data(), npix);
      return;
    }
    // jdcolor.c: YCbCr unless the file says RGB (an Adobe transform of 0,
    // or component ids 'R', 'G', 'B' without a JFIF or Adobe marker); a
    // four-component file is YCCK under an Adobe transform other than 0,
    // else CMYK
    bool ycc = true;
    if (nc == 4) {
      ycc = saw_adobe && adobe_transform != 0;
    } else if (saw_jfif) {
      ycc = true;
    } else if (saw_adobe) {
      ycc = adobe_transform != 0;
    } else if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66) {
      ycc = false;
    }
    const uint8_t *P0 = full[0].data(), *P1 = full[1].data(),
                  *P2 = full[2].data();
    if (!ycc) {
      for (size_t i = 0; i < npix; ++i) {
        if (nc == 4) {
          const int k = full[3][i];
          out[3 * i] = cmyk_channel(P0[i], k);
          out[3 * i + 1] = cmyk_channel(P1[i], k);
          out[3 * i + 2] = cmyk_channel(P2[i], k);
        } else {
          out[3 * i] = P0[i];
          out[3 * i + 1] = P1[i];
          out[3 * i + 2] = P2[i];
        }
      }
      return;
    }
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = int64_t{1} << (SCALEBITS - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t{1} << SCALEBITS) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    // range_limit[] of jdcolor.c: the simple table, clamping to 0..255
    auto clamp = [](int v) {
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    for (size_t i = 0; i < npix; ++i) {
      const int y = P0[i], cb = P1[i], cr = P2[i];
      const int r = clamp(y + cr_r[cr]);
      const int g =
          clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      const int b = clamp(y + cb_b[cb]);
      if (nc == 4) {
        // ycck_cmyk_convert: C, M, Y = 255 - R, G, B; K as stored
        const int k = full[3][i];
        out[3 * i] = cmyk_channel(255 - r, k);
        out[3 * i + 1] = cmyk_channel(255 - g, k);
        out[3 * i + 2] = cmyk_channel(255 - b, k);
      } else {
        out[3 * i] = static_cast<uint8_t>(r);
        out[3 * i + 1] = static_cast<uint8_t>(g);
        out[3 * i + 2] = static_cast<uint8_t>(b);
      }
    }
  }
};

void copy_error(const std::string& msg, char* err, int64_t errlen) {
  if (errlen <= 0) return;
  std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// dims: height, width, channels (1 for gray, else 3: RGB) of the image.
// Returns 0, or 1 with the reason in err.
int jpeg_header(const uint8_t* data, int64_t size, int32_t* dims, char* err,
                int64_t errlen) {
  try {
    Decoder dec(data, size);
    dec.parse_header();
    dims[0] = dec.height;
    dims[1] = dec.width;
    dims[2] = dec.comps.size() == 1 ? 1 : 3;
    return 0;
  } catch (const Error& e) {
    copy_error(e.msg, err, errlen);
    return 1;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

// out: height x width x channels bytes, as jpeg_header gives them.
int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, char* err,
                int64_t errlen) {
  try {
    Decoder dec(data, size);
    dec.parse_header();
    dec.decode_scans();
    dec.output(out);
    return 0;
  } catch (const Error& e) {
    copy_error(e.msg, err, errlen);
    return 1;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

// rgb (n x 3) from the stored CMYK samples cmyk (n x 4), as the decoder
// converts a four-component file.
void jpeg_cmyk_to_rgb(const uint8_t* cmyk, uint8_t* rgb, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    for (int c = 0; c < 3; ++c)
      rgb[3 * i + c] = cmyk_channel(cmyk[4 * i + c], cmyk[4 * i + 3]);
}

}  // extern "C"
