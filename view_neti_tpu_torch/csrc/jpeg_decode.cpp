// JPEG decoding (ITU-T T.81 with 8-bit samples: baseline,
// extended-sequential and progressive, Huffman- or arithmetic-coded,
// SOF0/1/2/9/10, and lossless Huffman-coded, SOF3), a host helper of
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
//     inverted CMYK ("CMYK;I") and its CMYK->RGB conversion;
//   * arithmetic decoding (jdarith.c, jaricom.c; T.81 Annex D, F.2.4 and
//     G.2): the QM-coder's interval register with the byte stuffing and
//     the zero bits past a marker of arith_decode, the DC statistics (64
//     bins a table, conditioned on L and U from DAC) and the AC statistics
//     (256 bins, split at Kx), the sign and refinement bits at the fixed
//     probability 0.5; the sequential MCU decoder and the four progressive
//     ones, whose coefficients go through the same buffer, smoothing,
//     IDCT, upsampling and colour conversion as Huffman's. At each restart
//     the statistics, the coder and the DC predictions and contexts are
//     reset. A bad code (a magnitude or a run past the block) leaves the
//     rest of its restart interval's blocks as they were, as libjpeg does
//     after its JWRN_ARITH_BAD_CODE warning;
//   * lossless decoding (jdlhuff.c, jddiffct.c, jdlossls.c; T.81 Annex
//     H): Huffman-coded differences of categories 0-16 (16 is 32768 with
//     no extra bits), added modulo 2^16 to the prediction of selection
//     value Ss (1-7); the first row of a scan and of each restart interval
//     predicted from the left, from 2^(P - Pt - 1) at its first sample,
//     the first column from above (libjpeg resets the prediction when a
//     restart falls in an iMCU row, at that row's top), each sample then
//     shifted left by Pt into 8 bits; plain replication for subsampled
//     components (libjpeg's fancy upsampling needs DCT blocks). Without a
//     JFIF or Adobe marker a three-component lossless file is RGB; marked
//     YCbCr (or YCCK), it fails, as libjpeg-turbo converts no lossless
//     data.
// Gray images come out with one channel, the others with three. EXIF
// orientation is not applied. Decoding stops at the first EOI (or after
// the only scan of a single-scan file), so a second image after it (an
// MPO's) is not read. A file without Huffman tables
// (a motion-JPEG frame) gets the standard ones, as libjpeg gives them.
//
// Corrupt entropy-coded data decodes as libjpeg decodes it (HuffBits,
// ArithReader). Lossless arithmetic-coded (SOF11) and hierarchical files
// (SOF5-7, SOF13-15), other sample precisions than 8 bits (which Pillow
// refuses), lossless files marked YCbCr, a lossless restart interval that
// splits a row of MCUs (libjpeg's JERR_BAD_RESTART), truncated data (where
// libjpeg would wait for more input, which Pillow turns into an error),
// restart markers out of order (which libjpeg resyncs) and corrupt marker
// segments fail with a message naming the feature or the fault.
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
  int count = 0;
  uint8_t vals[256] = {};
  int32_t mincode[17] = {}, maxcode[18] = {}, valptr[17] = {};
  uint8_t look_nbits[512] = {};   // 9-bit lookahead: code length, 0 = slow
  uint8_t look_sym[512] = {};

  void build(const uint8_t* bits, const uint8_t* values, int n) {
    count = n;
    std::memcpy(vals, values, n);
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
  int dc_context = 0;          // arithmetic DC conditioning (F.1.4.4.1.2)
  std::vector<int16_t> coef;   // bh x bw blocks of 64, natural order
  // lossless files: the reconstructed values (modulo 2^16) and the output
  // samples, bh x bw samples (a block is one sample there)
  std::vector<int32_t> value;
  std::vector<uint8_t> samples;
  // the quantization table, latched at the component's first scan (as
  // libjpeg's latch_quant_tables)
  bool latched = false;
  uint16_t quant[64] = {};
  // per zigzag position: -1 before any scan, then the Al of the last scan
  // that coded it (0: exact); libjpeg's coef_bits
  int coef_bits[64];
  Component() { std::fill(coef_bits, coef_bits + 64, -1); }
};

// jaricom.c: T.81 Table D.2, the probability estimation state machine, as
// libjpeg packs it: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
// Next_Index_LPS. Entry 113 is the fixed probability 0.5 (T.851 Table 5)
// of the sign and refinement bits.
constexpr int64_t qe_entry(int64_t qe, int nlps, int nmps, int sw) {
  return (qe << 16) | (int64_t{nmps} << 8) | (int64_t{sw} << 7) | nlps;
}
const int64_t kAritab[114] = {
    qe_entry(0x5a1d, 1, 1, 1),     qe_entry(0x2586, 14, 2, 0),
    qe_entry(0x1114, 16, 3, 0),    qe_entry(0x080b, 18, 4, 0),
    qe_entry(0x03d8, 20, 5, 0),    qe_entry(0x01da, 23, 6, 0),
    qe_entry(0x00e5, 25, 7, 0),    qe_entry(0x006f, 28, 8, 0),
    qe_entry(0x0036, 30, 9, 0),    qe_entry(0x001a, 33, 10, 0),
    qe_entry(0x000d, 35, 11, 0),   qe_entry(0x0006, 9, 12, 0),
    qe_entry(0x0003, 10, 13, 0),   qe_entry(0x0001, 12, 13, 0),
    qe_entry(0x5a7f, 15, 15, 1),   qe_entry(0x3f25, 36, 16, 0),
    qe_entry(0x2cf2, 38, 17, 0),   qe_entry(0x207c, 39, 18, 0),
    qe_entry(0x17b9, 40, 19, 0),   qe_entry(0x1182, 42, 20, 0),
    qe_entry(0x0cef, 43, 21, 0),   qe_entry(0x09a1, 45, 22, 0),
    qe_entry(0x072f, 46, 23, 0),   qe_entry(0x055c, 48, 24, 0),
    qe_entry(0x0406, 49, 25, 0),   qe_entry(0x0303, 51, 26, 0),
    qe_entry(0x0240, 52, 27, 0),   qe_entry(0x01b1, 54, 28, 0),
    qe_entry(0x0144, 56, 29, 0),   qe_entry(0x00f5, 57, 30, 0),
    qe_entry(0x00b7, 59, 31, 0),   qe_entry(0x008a, 60, 32, 0),
    qe_entry(0x0068, 62, 33, 0),   qe_entry(0x004e, 63, 34, 0),
    qe_entry(0x003b, 32, 35, 0),   qe_entry(0x002c, 33, 9, 0),
    qe_entry(0x5ae1, 37, 37, 1),   qe_entry(0x484c, 64, 38, 0),
    qe_entry(0x3a0d, 65, 39, 0),   qe_entry(0x2ef1, 67, 40, 0),
    qe_entry(0x261f, 68, 41, 0),   qe_entry(0x1f33, 69, 42, 0),
    qe_entry(0x19a8, 70, 43, 0),   qe_entry(0x1518, 72, 44, 0),
    qe_entry(0x1177, 73, 45, 0),   qe_entry(0x0e74, 74, 46, 0),
    qe_entry(0x0bfb, 75, 47, 0),   qe_entry(0x09f8, 77, 48, 0),
    qe_entry(0x0861, 78, 49, 0),   qe_entry(0x0706, 79, 50, 0),
    qe_entry(0x05cd, 48, 51, 0),   qe_entry(0x04de, 50, 52, 0),
    qe_entry(0x040f, 50, 53, 0),   qe_entry(0x0363, 51, 54, 0),
    qe_entry(0x02d4, 52, 55, 0),   qe_entry(0x025c, 53, 56, 0),
    qe_entry(0x01f8, 54, 57, 0),   qe_entry(0x01a4, 55, 58, 0),
    qe_entry(0x0160, 56, 59, 0),   qe_entry(0x0125, 57, 60, 0),
    qe_entry(0x00f6, 58, 61, 0),   qe_entry(0x00cb, 59, 62, 0),
    qe_entry(0x00ab, 61, 63, 0),   qe_entry(0x008f, 61, 32, 0),
    qe_entry(0x5b12, 65, 65, 1),   qe_entry(0x4d04, 80, 66, 0),
    qe_entry(0x412c, 81, 67, 0),   qe_entry(0x37d8, 82, 68, 0),
    qe_entry(0x2fe8, 83, 69, 0),   qe_entry(0x293c, 84, 70, 0),
    qe_entry(0x2379, 86, 71, 0),   qe_entry(0x1edf, 87, 72, 0),
    qe_entry(0x1aa9, 87, 73, 0),   qe_entry(0x174e, 72, 74, 0),
    qe_entry(0x1424, 72, 75, 0),   qe_entry(0x119c, 74, 76, 0),
    qe_entry(0x0f6b, 74, 77, 0),   qe_entry(0x0d51, 75, 78, 0),
    qe_entry(0x0bb6, 77, 79, 0),   qe_entry(0x0a40, 77, 48, 0),
    qe_entry(0x5832, 80, 81, 1),   qe_entry(0x4d1c, 88, 82, 0),
    qe_entry(0x438e, 89, 83, 0),   qe_entry(0x3bdd, 90, 84, 0),
    qe_entry(0x34ee, 91, 85, 0),   qe_entry(0x2eae, 92, 86, 0),
    qe_entry(0x299a, 93, 87, 0),   qe_entry(0x2516, 86, 71, 0),
    qe_entry(0x5570, 88, 89, 1),   qe_entry(0x4ca9, 95, 90, 0),
    qe_entry(0x44d9, 96, 91, 0),   qe_entry(0x3e22, 97, 92, 0),
    qe_entry(0x3824, 99, 93, 0),   qe_entry(0x32b4, 99, 94, 0),
    qe_entry(0x2e17, 93, 86, 0),   qe_entry(0x56a8, 95, 96, 1),
    qe_entry(0x4f46, 101, 97, 0),  qe_entry(0x47e5, 102, 98, 0),
    qe_entry(0x41cf, 103, 99, 0),  qe_entry(0x3c3d, 104, 100, 0),
    qe_entry(0x375e, 99, 93, 0),   qe_entry(0x5231, 105, 102, 0),
    qe_entry(0x4c0f, 106, 103, 0), qe_entry(0x4639, 107, 104, 0),
    qe_entry(0x415e, 103, 99, 0),  qe_entry(0x5627, 105, 106, 1),
    qe_entry(0x50e7, 108, 107, 0), qe_entry(0x4b85, 109, 103, 0),
    qe_entry(0x5597, 110, 109, 0), qe_entry(0x504f, 111, 107, 0),
    qe_entry(0x5a10, 110, 111, 1), qe_entry(0x5522, 112, 109, 0),
    qe_entry(0x59eb, 112, 111, 1), qe_entry(0x5a1d, 113, 113, 0)};

// The position of the 0xFF just before the next marker code at or after
// pos (past stuffed zeros, fill bytes and data left unread), or n.
int64_t next_marker_at(const uint8_t* d, int64_t n, int64_t pos) {
  while (pos < n && !(d[pos] == 0xFF && pos + 1 < n && d[pos + 1] != 0x00 &&
                      d[pos + 1] != 0xFF))
    ++pos;
  return pos;
}

// The arithmetic decoder of jdarith.c (arith_decode): C holds the base of
// the interval and the next input bits above a floating cut point (CT
// bits), A the interval's size. Past a marker it is fed zero bytes (legal
// in arithmetic coding); running out of data is a truncated file.
struct ArithReader {
  const uint8_t* d;
  int64_t n, pos;
  int64_t c = 0, a = 0;
  int ct = -16;                 // -16: two bytes to read before decoding
  bool at_marker = false;       // pos is at the marker's first 0xFF

  int next_byte() {
    if (at_marker) return 0;
    if (pos >= n)
      fail("truncated JPEG: arithmetic-coded data ends early");
    const int64_t start = pos;
    int data = d[pos++];
    if (data == 0xFF) {
      do {
        if (pos >= n)
          fail("truncated JPEG: arithmetic-coded data ends early");
        data = d[pos++];
      } while (data == 0xFF);
      if (data == 0) {
        data = 0xFF;            // a stuffed zero
      } else {
        at_marker = true;
        pos = start;
        data = 0;
      }
    }
    return data;
  }

  // One binary decision with the statistics bin *st (state index in bits
  // 0-6, the more probable symbol in bit 7), which it updates.
  int decode(uint8_t* st) {
    while (a < 0x8000) {        // renormalization and input, D.2.6
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;      // decoding and estimation, D.2.4-5
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  void restart() {
    c = a = 0;
    ct = -16;
    at_marker = false;
  }

  // Move to the next marker (skipping what the decoder left unread).
  void to_marker() {
    at_marker = false;
    pos = next_marker_at(d, n, pos);
  }
};

inline int extend(int v, int t) {
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

// Huffman-coded data read as libjpeg-turbo's decoders read it (jdhuff.c:
// jpeg_fill_bit_buffer with a 64-bit buffer, MIN_GET_BITS 57; jdhuff.h:
// HUFF_DECODE with 8 bits of lookahead; jpeg_huff_decode), so that a file
// ends early, or a marker cuts its data, where libjpeg finds it: data
// that ends before a marker is truncated (libjpeg suspends for more
// input, and Pillow raises); past a marker the buffer is padded with zero
// bits and `insufficient` set (JWRN_HIT_MARKER), after which the MCU
// decoders leave their MCUs as they are until the next restart; a code no
// table holds decodes as 0 (JWRN_HUFF_BAD_CODE). Pillow ignores both
// warnings. This is the lossless decoder's reading step for step; the DCT
// decoders' fast path (whole MCUs from a buffer with room, which depends
// on how Pillow feeds libjpeg) reads the same bits, so only where a file
// without an EOI counts as truncated can differ.
struct HuffBits {
  static constexpr int MIN_GET_BITS = 57;
  const uint8_t* d;
  int64_t n, pos;
  uint64_t buf = 0;
  int bits_left = 0;
  bool at_marker = false;       // pos is at the marker's first 0xFF
  bool insufficient = false;

  [[noreturn]] static void truncated() {
    fail("truncated JPEG: entropy-coded data ends before a marker");
  }

  void fill(int nbits) {
    if (!at_marker) {
      while (bits_left < MIN_GET_BITS) {
        if (pos >= n) truncated();
        const int64_t start = pos;
        int c = d[pos++];
        if (c == 0xFF) {
          do {
            if (pos >= n) truncated();
            c = d[pos++];
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            at_marker = true;
            pos = start;
            break;
          }
        }
        buf = (buf << 8) | static_cast<uint64_t>(c);
        bits_left += 8;
      }
      if (!at_marker) return;
    }
    if (nbits > bits_left) {
      insufficient = true;
      buf <<= MIN_GET_BITS - bits_left;
      bits_left = MIN_GET_BITS;
    }
  }
  void check(int nbits) {
    if (bits_left < nbits) fill(nbits);
  }
  int get(int nbits) {
    bits_left -= nbits;
    return static_cast<int>((buf >> bits_left) & ((1u << nbits) - 1));
  }
  int bits(int nbits) {
    if (nbits == 0) return 0;
    check(nbits);
    return get(nbits);
  }

  int decode(const Huffman& h) {
    int l = 9;
    if (bits_left < 8) {
      fill(0);
      if (bits_left < 8) l = 1;
    }
    if (l == 9) {
      const int look = static_cast<int>((buf >> (bits_left - 8)) & 0xFF);
      const int nb = h.look_nbits[look << 1];
      if (nb && nb <= 8) {
        bits_left -= nb;
        return h.look_sym[look << 1];
      }
    }
    check(l);
    int code = get(l);
    while (code > h.maxcode[l]) {
      code <<= 1;
      check(1);
      code |= get(1);
      ++l;
    }
    if (l > 16) return 0;
    return h.vals[h.valptr[l] + code - h.mincode[l]];
  }

  // The buffered bits dropped and the next marker found (after any data
  // left unread), as at a restart (jdhuff.c: process_restart) and at the
  // scan's end; a restart clears `insufficient` once its RSTn is read.
  int64_t to_marker() {
    bits_left = 0;
    pos = next_marker_at(d, n, pos);
    at_marker = false;
    insufficient = false;
    return pos;
  }
};

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
  bool frame = false, progressive = false, arith = false, lossless = false;
  int scans = 0;
  std::vector<Component> comps;
  uint16_t quant[4][64] = {};
  bool quant_defined[4] = {};
  Huffman dc[4], ac[4];
  // arithmetic coding: the DAC conditioning of each table (defaults L = 0,
  // U = 1, Kx = 5), the statistics bins, the fixed-probability bin
  uint8_t dc_L[16], dc_U[16], ac_K[16];
  uint8_t dc_stats[16][64] = {}, ac_stats[16][256] = {};
  uint8_t fixed_bin[4] = {113, 0, 0, 0};

  Decoder(const uint8_t* data, int64_t size) : d(data), n(size) {
    std::fill(dc_L, dc_L + 16, 0);
    std::fill(dc_U, dc_U + 16, 1);
    std::fill(ac_K, ac_K + 16, 5);
  }

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
      case 0xC3:
      case 0xC9:
      case 0xCA:
        arith = m >= 0xC9;
        lossless = m == 0xC3;
        sof(end, m == 0xC2 || m == 0xCA);
        break;
      case 0xCB:
        fail("lossless arithmetic-coded JPEG (SOF11) is not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xDE:
        fail("hierarchical JPEG (SOF5-7, DHP) is not supported");
      case 0xCD:
      case 0xCE:
      case 0xCF:
        fail("hierarchical arithmetic-coded JPEG (SOF13-15) is not "
             "supported");
      case 0xCC:
        dac(end);
        break;
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
    const int unit = lossless ? 1 : 8;
    mcus_x = (width + unit * hmax - 1) / (unit * hmax);
    mcus_y = (height + unit * vmax - 1) / (unit * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v)
        fail("JPEG with non-integral sampling factors is not supported");
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      c.ds_w = static_cast<int>(
          (static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.ds_h = static_cast<int>(
          (static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      // a lossless file's "blocks" are single samples
      const size_t blocks = static_cast<size_t>(c.bw) * c.bh;
      if (lossless) {
        c.value.assign(blocks, 0);
        c.samples.assign(blocks, 0);
      } else {
        c.coef.assign(blocks * 64, 0);
      }
    }
    frame = true;
  }

  // jdmarker.c's get_dac: (Tc << 4 | Tb, value) pairs; a DC table's value
  // is U << 4 | L with L <= U, an AC table's Kx.
  void dac(int64_t end) {
    while (pos + 2 <= end) {
      const int index = u8(), val = u8();
      if (index >= 32) fail("corrupt JPEG: bad DAC table index");
      if (index >= 16) {
        ac_K[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_L[index] = static_cast<uint8_t>(val & 15);
        dc_U[index] = static_cast<uint8_t>(val >> 4);
        if (dc_L[index] > dc_U[index])
          fail("corrupt JPEG: bad DAC conditioning (L > U)");
      }
    }
    if (pos != end) fail("corrupt JPEG: bad DAC segment length");
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
  void decode_block(HuffBits& br, Component& c, int16_t* blk) {
    const int s = br.decode(dc[c.td]);
    const int diff = s ? extend(br.bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(ac[c.ta]);
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

  void dc_first(HuffBits& br, Component& c, int16_t* blk, int al) {
    const int s = br.decode(dc[c.td]);
    c.dc_pred += s ? extend(br.bits(s), s) : 0;
    blk[0] = scaled(c.dc_pred, al);
  }

  static void dc_refine(HuffBits& br, int16_t* blk, int al) {
    if (br.bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  void ac_first(HuffBits& br, const Huffman& h, int16_t* blk, int ss,
                int se, int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = br.decode(h);
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

  static void refine_bit(HuffBits& br, int16_t& coef, int p1) {
    if (br.bits(1) && (coef & p1) == 0)
      coef = static_cast<int16_t>(coef >= 0 ? coef + p1 : coef - p1);
  }

  void ac_refine(HuffBits& br, const Huffman& h, int16_t* blk, int ss,
                 int se, int al, int& eobrun) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br.decode(h);
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

  // The arithmetic-coded MCU decoders of jdarith.c. Each returns false on
  // a bad code (a magnitude past 2^15 or a run past the scan's band),
  // where libjpeg warns and decodes nothing more until the next restart.

  // F.2.4.1: one DC difference, added to c.dc_pred (modulo 2^16), with
  // the conditioning category it sets for the next one.
  bool arith_dc_diff(ArithReader& ar, Component& c) {
    uint8_t* st = dc_stats[c.td] + c.dc_context;
    if (ar.decode(st) == 0) {
      c.dc_context = 0;
      return true;
    }
    const int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m != 0) {
      st = dc_stats[c.td] + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        ++st;
      }
    }
    if (m < ((1 << dc_L[c.td]) >> 1))
      c.dc_context = 0;
    else if (m > ((1 << dc_U[c.td]) >> 1))
      c.dc_context = 12 + sign * 4;
    else
      c.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    c.dc_pred = (c.dc_pred + v) & 0xffff;
    return true;
  }

  // F.2.4.2: the AC coefficients ss..se of one block, scaled by 1 << al.
  bool arith_ac(ArithReader& ar, int tbl, int16_t* blk, int ss, int se,
                int al) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;                 // end of block
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) return false;
      }
      const int sign = ar.decode(fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m != 0 && ar.decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= ac_K[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kZigzag[k]] = scaled(v, al);
    }
    return true;
  }

  // G.1.3.3: the next bit of every coefficient ss..se known nonzero, and
  // the newly nonzero ones (+-1 << al), with the EOB decision only past
  // the block's last nonzero coefficient.
  bool arith_ac_refine(ArithReader& ar, int tbl, int16_t* blk, int ss,
                       int se, int al) {
    const int p1 = 1 << al, m1 = -p1;
    int kex = se;
    while (kex > 0 && !blk[kZigzag[kex]]) --kex;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;      // end of block
      for (;;) {
        int16_t& coef = blk[kZigzag[k]];
        if (coef) {
          if (ar.decode(st + 2))
            coef = static_cast<int16_t>(coef + (coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {
          coef = static_cast<int16_t>(ar.decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return false;
      }
    }
    return true;
  }

  using Mcu = std::vector<std::pair<Component*, int16_t*>>;

  bool arith_mcu(ArithReader& ar, const Mcu& mcu, int ss, int se, int ah,
                 int al) {
    for (const auto& [c, blk] : mcu) {
      if (!progressive) {                       // decode_mcu
        if (!arith_dc_diff(ar, *c)) return false;
        blk[0] = static_cast<int16_t>(c->dc_pred);
        if (!arith_ac(ar, c->ta, blk, 1, 63, 0)) return false;
      } else if (ss == 0 && ah == 0) {          // decode_mcu_DC_first
        if (!arith_dc_diff(ar, *c)) return false;
        blk[0] = scaled(c->dc_pred, al);
      } else if (ss == 0) {                     // decode_mcu_DC_refine
        if (ar.decode(fixed_bin))
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      } else if (ah == 0) {                     // decode_mcu_AC_first
        if (!arith_ac(ar, c->ta, blk, ss, se, al)) return false;
      } else {                                  // decode_mcu_AC_refine
        if (!arith_ac_refine(ar, c->ta, blk, ss, se, al)) return false;
      }
    }
    return true;
  }

  // jdarith.c's start_pass and process_restart: zeroed statistics for the
  // tables the scan codes with, the DC predictions and contexts cleared.
  void arith_reset(const std::vector<Component*>& in_scan, int ss, int ah) {
    for (auto* c : in_scan) {
      if (!progressive || (ss == 0 && ah == 0)) {
        std::memset(dc_stats[c->td], 0, sizeof(dc_stats[0]));
        c->dc_pred = 0;
        c->dc_context = 0;
      }
      if (!progressive || ss)
        std::memset(ac_stats[c->ta], 0, sizeof(ac_stats[0]));
    }
  }

  // The restart marker RSTn expected at pos (after the data left unread).
  void restart_marker(int64_t at, int& next_rst) {
    if (at + 1 >= n || d[at + 1] != 0xD0 + next_rst)
      fail("corrupt JPEG: missing restart marker");
    next_rst = (next_rst + 1) & 7;
  }

  void scan(int64_t seg_end) {
    const int ns = u8();
    if (ns < 1 || ns > 4 || seg_end - pos != 2 * ns + 3)
      fail("corrupt JPEG: bad scan header");
    std::vector<Component*> in_scan;
    const int max_table = arith ? 15 : 3;
    for (int i = 0; i < ns; ++i) {
      const int id = u8(), tables = u8();
      Component* c = nullptr;
      for (auto& x : comps)
        if (x.id == id) c = &x;
      if (!c) fail("corrupt JPEG: scan names an unknown component");
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > max_table || c->ta > max_table)
        fail("corrupt JPEG: bad entropy table id in a scan");
      in_scan.push_back(c);
    }
    const int ss = u8(), se = u8(), ahal = u8();
    const int ah = ahal >> 4, al = ahal & 15;
    if (lossless) {
      pos = seg_end;
      lossless_scan(in_scan, ss, se, ah, al);
      ++scans;
      return;
    }
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
      if (!arith && ((need_dc && !dc[c->td].defined) ||
                     (need_ac && !ac[c->ta].defined)))
        fail("corrupt JPEG: scan uses an undefined Huffman table");
      // jdhuff.c: jpeg_make_d_derived_tbl's check of a DC table
      const Huffman& h = dc[c->td];
      if (!arith && need_dc &&
          std::any_of(h.vals, h.vals + h.count, [](int v) { return v > 15; }))
        fail("corrupt JPEG: a DC Huffman table's category above 15");
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
    HuffBits br{d, n, pos};
    ArithReader ar{d, n, pos};
    if (arith) arith_reset(in_scan, ss, ah);
    bool arith_ok = true;
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
    Mcu mcu;
    for (int uy = 0; uy < units_y; ++uy) {
      for (int ux = 0; ux < units_x; ++ux) {
        if (restart_interval && todo == restart_interval) {
          if (arith) {
            ar.to_marker();
            restart_marker(ar.pos, next_rst);
            ar.pos += 2;
            ar.restart();
            arith_reset(in_scan, ss, ah);
            arith_ok = true;
          } else {
            restart_marker(br.to_marker(), next_rst);
            br.pos += 2;
            eobrun = 0;
            for (auto* c : in_scan) c->dc_pred = 0;
          }
          todo = 0;
        }
        ++todo;
        mcu.clear();
        if (ns == 1) {
          Component& c = *in_scan[0];
          mcu.emplace_back(&c, c.coef.data() +
                                   (static_cast<size_t>(uy) * c.bw + ux) * 64);
        } else {
          for (auto* c : in_scan)
            for (int by = 0; by < c->v; ++by)
              for (int bx = 0; bx < c->h; ++bx) {
                const size_t row = static_cast<size_t>(uy) * c->v + by;
                const size_t col = static_cast<size_t>(ux) * c->h + bx;
                mcu.emplace_back(c, c->coef.data() + (row * c->bw + col) * 64);
              }
        }
        if (arith) {
          if (arith_ok) arith_ok = arith_mcu(ar, mcu, ss, se, ah, al);
        } else if (!br.insufficient) {
          // past a marker libjpeg leaves the MCUs as they are
          for (const auto& [c, blk] : mcu) block(*c, blk);
        }
      }
    }
    if (arith) {
      ar.to_marker();
      pos = ar.pos;
    } else {
      pos = br.to_marker();
    }
    ++scans;
  }

  // One lossless scan (jddiffct.c, jdlhuff.c, jdlossls.c): the Huffman-
  // coded differences of an iMCU row (v sample rows of each component),
  // then each of its rows undifferenced with the prediction of selection
  // value ss and shifted left by al. MCUs are one sample of a single-
  // component scan, else h x v samples of each component in turn. Once a
  // marker has cut the data, each later row of MCUs is zero differences
  // from restarted predictors, as jdlhuff.c's decode_mcus gives it.
  void lossless_scan(const std::vector<Component*>& in_scan, int ss, int se,
                     int ah, int al) {
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al > 7)
      fail("corrupt JPEG: bad lossless scan parameters");
    const int ns = static_cast<int>(in_scan.size());
    for (auto* c : in_scan) {
      const Huffman& h = dc[c->td];
      if (!h.defined)
        fail("corrupt JPEG: scan uses an undefined Huffman table");
      if (std::any_of(h.vals, h.vals + h.count, [](int v) { return v > 16; }))
        fail("corrupt JPEG: a lossless Huffman table's category above 16");
      c->latched = true;                  // a lossless file has no tables
    }
    const int per_row = ns == 1 ? in_scan[0]->ds_w : mcus_x;
    if (restart_interval % per_row)
      fail("lossless JPEG whose restart interval (" +
           std::to_string(restart_interval) + " MCUs) splits a row of " +
           std::to_string(per_row) + " MCUs is not supported");
    HuffBits br{d, n, pos};
    int next_rst = 0;
    int rows_to_go = restart_interval / per_row;
    // every component's predictor restarts from its first-row form at the
    // scan's start and at each restart (jdlossls.c: start_pass_lossless)
    std::vector<bool> first_row(ns, true);
    std::vector<std::vector<int>> diff(ns);
    for (int i = 0; i < ns; ++i)
      diff[i].assign(static_cast<size_t>(in_scan[i]->v) * in_scan[i]->bw, 0);
    auto difference = [&](const Component& c) {
      const int s = br.decode(dc[c.td]);
      if (s == 0 || s == 16) return s == 16 ? 32768 : 0;
      br.check(s);
      return extend(br.get(s), s);
    };
    const int init = 1 << (8 - al - 1);
    for (int r = 0; r < mcus_y; ++r) {
      const Component& c0 = *in_scan[0];
      int mcu_rows = 1;
      if (ns == 1) {
        const int last = c0.ds_h - r * c0.v;
        mcu_rows = std::min(c0.v, last);
      }
      for (int yoff = 0; yoff < mcu_rows; ++yoff) {
        if (restart_interval && rows_to_go == 0) {
          restart_marker(br.to_marker(), next_rst);
          br.pos += 2;
          std::fill(first_row.begin(), first_row.end(), true);
          rows_to_go = restart_interval / per_row;
        }
        if (br.insufficient) {
          for (int i = 0; i < ns; ++i) {
            const int rows = ns == 1 ? 1 : in_scan[i]->v;
            const size_t row0 = ns == 1 ? yoff : 0;
            std::fill_n(diff[i].begin() + row0 * in_scan[i]->bw,
                        static_cast<size_t>(rows) * in_scan[i]->bw, 0);
          }
          std::fill(first_row.begin(), first_row.end(), true);
        } else if (ns == 1) {
          int* out = diff[0].data() + static_cast<size_t>(yoff) * c0.bw;
          for (int x = 0; x < per_row; ++x) out[x] = difference(c0);
        } else {
          for (int mx = 0; mx < per_row; ++mx)
            for (int i = 0; i < ns; ++i) {
              const Component& c = *in_scan[i];
              for (int by = 0; by < c.v; ++by)
                for (int bx = 0; bx < c.h; ++bx)
                  diff[i][static_cast<size_t>(by) * c.bw + mx * c.h + bx] =
                      difference(c);
            }
        }
        if (restart_interval) --rows_to_go;
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = *in_scan[i];
        for (int row = 0; row < c.v; ++row) {
          const int y = r * c.v + row;
          if (y >= c.ds_h) break;
          const int* df = diff[i].data() + static_cast<size_t>(row) * c.bw;
          int32_t* cur = c.value.data() + static_cast<size_t>(y) * c.bw;
          const int32_t* up = cur - c.bw;
          if (first_row[i]) {
            int ra = (df[0] + init) & 0xFFFF;
            cur[0] = ra;
            for (int x = 1; x < c.ds_w; ++x) cur[x] = ra = (df[x] + ra) & 0xFFFF;
            first_row[i] = false;
          } else {
            int rb = up[0], ra = (df[0] + rb) & 0xFFFF, rc;
            cur[0] = ra;
            for (int x = 1; x < c.ds_w; ++x) {
              rc = rb;
              rb = up[x];
              int pred;
              switch (ss) {
                case 1: pred = ra; break;
                case 2: pred = rb; break;
                case 3: pred = rc; break;
                case 4: pred = ra + rb - rc; break;
                case 5: pred = ra + ((rb - rc) >> 1); break;
                case 6: pred = rb + ((ra - rc) >> 1); break;
                default: pred = (ra + rb) >> 1; break;
              }
              cur[x] = ra = (df[x] + pred) & 0xFFFF;
            }
          }
          uint8_t* smp = c.samples.data() + static_cast<size_t>(y) * c.bw;
          for (int x = 0; x < c.ds_w; ++x)
            smp[x] = static_cast<uint8_t>(cur[x] << al);
        }
      }
    }
    pos = br.to_marker();
  }

  // Every scan up to the first EOI. A file of one scan ends with it (as
  // Pillow stops once libjpeg has given every row); a progressive file, or
  // one whose first scan leaves out a component, is read to its EOI first
  // (jdapistd.c: jpeg_start_decompress), so data that ends before the EOI
  // is a truncated file there.
  void decode_scans() {
    bool multi_scan = false;
    while (true) {
      const int m = next_marker();
      if (m < 0) {
        if (scans) fail("truncated JPEG: the data ends before its EOI");
        fail("truncated JPEG: no scan");
      }
      if (m == 0xD9) return;
      if (m == 0xDA) {
        const int64_t start = pos;
        const int len = u16();
        if (len < 2 || start + len > n)
          fail("truncated JPEG: ends inside a marker segment");
        if (scans == 0)
          multi_scan = progressive || d[pos] < static_cast<int>(comps.size());
        scan(start + len);
        if (!multi_scan) return;
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
  // (jdsample.c; fancy only when `fancy`: libjpeg's needs DCT blocks)
  static void upsample(const uint8_t* plane, int stride, const Component& c,
                       int hf, int vf, int width, int height, bool fancy,
                       std::vector<uint8_t>& out) {
    out.assign(static_cast<size_t>(width) * height, 0);
    const int W = c.ds_w, H = c.ds_h;
    auto at = [&](int y, int x) -> int {
      y = y < 0 ? 0 : (y >= H ? H - 1 : y);
      return plane[static_cast<size_t>(y) * stride + x];
    };
    const bool h2v1 = fancy && hf == 2 && vf == 1 && W > 2;
    const bool h2v2 = fancy && hf == 2 && vf == 2 && W > 2;
    const bool h1v2 = fancy && hf == 1 && vf == 2;
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

  // jdapimin.c's default_decompress_parms: whether the file's colour is
  // YCbCr (or YCCK). Three components are YCbCr under a JFIF marker or an
  // Adobe transform other than 0, RGB under transform 0; without either
  // marker, RGB if the ids are 'R', 'G', 'B' or the file is lossless, else
  // YCbCr. Four are YCCK under an Adobe transform other than 0, else CMYK.
  bool ycc_colour() const {
    const int nc = static_cast<int>(comps.size());
    if (nc == 1) return false;
    if (nc == 4) return saw_adobe && adobe_transform != 0;
    if (saw_jfif) return true;
    if (saw_adobe) return adobe_transform != 0;
    if (lossless) return false;
    return !(comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66);
  }

  // Before any scan is decoded, as libjpeg fails in jpeg_start_decompress.
  void check_output() const {
    if (lossless && ycc_colour())
      fail("lossless JPEG marked YCbCr or YCCK (a JFIF marker or an Adobe "
           "transform other than 0) is not supported: libjpeg-turbo does "
           "no colour conversion of lossless data");
  }

  void output(uint8_t* out) {
    const int nc = static_cast<int>(comps.size());
    const bool smooth = smoothing_ok();
    std::vector<std::vector<uint8_t>> full(nc);
    std::vector<uint8_t> idct_plane;
    for (int ci = 0; ci < nc; ++ci) {
      Component& c = comps[ci];
      if (!c.latched) fail("corrupt JPEG: a component in no scan");
      const uint8_t* plane = c.samples.data();
      int stride = c.bw;
      if (!lossless) {
        component_plane(c, smooth, idct_plane);
        plane = idct_plane.data();
        stride = c.bw * 8;
      }
      const int hf = hmax / c.h, vf = vmax / c.v;
      if (hf == 1 && vf == 1) {
        full[ci].resize(static_cast<size_t>(width) * height);
        for (int y = 0; y < height; ++y)
          std::memcpy(full[ci].data() + static_cast<size_t>(y) * width,
                      plane + static_cast<size_t>(y) * stride, width);
      } else {
        upsample(plane, stride, c, hf, vf, width, height, !lossless,
                 full[ci]);
      }
    }
    const size_t npix = static_cast<size_t>(width) * height;
    if (nc == 1) {
      std::memcpy(out, full[0].data(), npix);
      return;
    }
    // jdcolor.c: YCbCr->RGB, YCCK->CMYK, or the samples as stored
    const bool ycc = ycc_colour();
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
    dec.check_output();
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
