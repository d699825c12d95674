// Host image library of the port's readers and helpers: a baseline JPEG
// decoder, resize by a factor and affine warps (nearest, linear, cubic)
// with a constant border, each with OpenCV's rules, so that the port
// gives what cv2 gives without cv2.
//
// Built with the host C++ compiler (-O2 -std=c++17 -fPIC -shared
// -ffp-contract=off; never -ffast-math: the warps' float rounding is part
// of their contract) and called through ctypes (data/imgproc.py). Every
// function is pure: no global state but constant tables, so the loader's
// threads call it at once.
//
// JPEG: SOF0 / SOF1, 8-bit, 1 or 3 components, Huffman coding (standard or
// optimised tables), restart intervals, any integral sampling factors.
// The arithmetic follows libjpeg's public algorithms as libjpeg-turbo
// (which OpenCV bundles) runs them by default: the `islow` integer IDCT
// (jidctint.c), "fancy" triangle upsampling of the chroma (jdsample.c:
// h2v1, h1v2, h2v2; box replication otherwise) and the fixed-point
// YCbCr -> RGB tables (jdcolor.c). Progressive, lossless, hierarchical and
// arithmetic-coded files, 12-bit samples, 2 or 4 components, RGB-coded
// 3-component files and an EXIF orientation that turns or mirrors the
// image are refused with a message.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// jpeg_natural_order, with 16 extra entries so a corrupt run cannot index
// past the block.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- Huffman

constexpr int kLookBits = 9;

struct Huffman {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18] = {0};
  int32_t valoffset[18] = {0};
  // (length << 8) | symbol for codes of at most kLookBits bits, 0 otherwise
  uint16_t look[1 << kLookBits] = {0};

  void derive() {  // jdhuff.c, jpeg_make_d_derived_tbl
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) throw Error("bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        int base = huffcode[p] << (kLookBits - l);
        for (int k = 0; k < (1 << (kLookBits - l)); k++)
          look[base + k] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
  }
};

// Entropy-coded data: removes the 0xFF00 stuffing and stops at a marker,
// feeding zeros past it (libjpeg does the same on a premature end).
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint32_t acc = 0;  // MSB-aligned
  int nbits = 0;
  bool at_marker = false;

  BitReader(const uint8_t* data, size_t size, size_t start)
      : d(data), n(size), pos(start) {}

  void fill() {
    while (nbits <= 24) {
      uint32_t c = 0;
      if (!at_marker && pos < n) {
        c = d[pos];
        if (c == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;
          if (q < n && d[q] == 0) {
            pos = q + 1;
          } else {
            at_marker = true;  // pos stays on the marker's first 0xFF
            c = 0;
          }
        } else {
          pos++;
        }
      }
      acc |= c << (24 - nbits);
      nbits += 8;
    }
  }
  int get_bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) fill();
    int v = static_cast<int>(acc >> (32 - k));
    acc <<= k;
    nbits -= k;
    return v;
  }
  int decode(const Huffman& h) {
    if (nbits < 16) fill();
    uint16_t e = h.look[acc >> (32 - kLookBits)];
    if (e) {
      int l = e >> 8;
      acc <<= l;
      nbits -= l;
      return e & 0xFF;
    }
    int code = get_bits(1), l = 1;
    while (code > h.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      if (++l > 16) return 0;  // corrupt data: libjpeg returns 0 too
    }
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  void reset() {  // drop the bits left before a restart marker
    acc = 0;
    nbits = 0;
  }
};

inline int extend(int v, int t) {  // HUFF_EXTEND
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

// ------------------------------------------------------------ islow IDCT

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// The post-IDCT range limit: libjpeg's table indexed by (x & 1023).
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      t[i] = static_cast<uint8_t>(v);
    }
  }
};

// jidctint.c, jpeg_idct_islow, on a block of dequantised-on-the-fly
// coefficients in natural order; writes 8x8 samples at out (row stride).
void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out,
                int stride) {
  static const RangeLimit range;
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const int16_t* qt = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = (int(in[0]) * int(qt[0])) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = int(in[16]) * int(qt[16]);
    z3 = int(in[48]) * int(qt[48]);
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int(in[0]) * int(qt[0]);
    z3 = int(in[32]) * int(qt[32]);
    tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = int(in[56]) * int(qt[56]);
    tmp1 = int(in[40]) * int(qt[40]);
    tmp2 = int(in[24]) * int(qt[24]);
    tmp3 = int(in[8]) * int(qt[8]);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = int(descale(tmp10 + tmp3, n));
    w[56] = int(descale(tmp10 - tmp3, n));
    w[8] = int(descale(tmp11 + tmp2, n));
    w[48] = int(descale(tmp11 - tmp2, n));
    w[16] = int(descale(tmp12 + tmp1, n));
    w[40] = int(descale(tmp12 - tmp1, n));
    w[24] = int(descale(tmp13 + tmp0, n));
    w[32] = int(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    const int n = kConstBits + kPass1Bits + 3;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t dc = range.t[int(descale(w[0], kPass1Bits + 3)) & 1023];
      for (int k = 0; k < 8; k++) o[k] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = range.t[int(descale(tmp10 + tmp3, n)) & 1023];
    o[7] = range.t[int(descale(tmp10 - tmp3, n)) & 1023];
    o[1] = range.t[int(descale(tmp11 + tmp2, n)) & 1023];
    o[6] = range.t[int(descale(tmp11 - tmp2, n)) & 1023];
    o[2] = range.t[int(descale(tmp12 + tmp1, n)) & 1023];
    o[5] = range.t[int(descale(tmp12 - tmp1, n)) & 1023];
    o[3] = range.t[int(descale(tmp13 + tmp0, n)) & 1023];
    o[4] = range.t[int(descale(tmp13 - tmp0, n)) & 1023];
  }
}

// ------------------------------------------------- YCbCr -> RGB (jdcolor.c)

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    const int kScale = 16;
    const int64_t half = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return int64_t(x * (1 << 16) + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ------------------------------------------------------------- the frame

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;  // blocks per row / column of the plane
  int dw = 0, dh = 0;  // downsampled width / height (the real samples)
  std::vector<uint8_t> plane;
  int dc = 0;
};

struct Jpeg {
  const uint8_t* d;
  size_t n;
  std::string name;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0, restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame = false;
  Component comp[3];
  Huffman dc[4], ac[4];
  int16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};

  Jpeg(const uint8_t* data, size_t size) : d(data), n(size) {}

  [[noreturn]] void fail(const std::string& why) const { throw Error(why); }

  int u16(size_t p) const {
    if (p + 2 > n) fail("truncated marker segment");
    return (d[p] << 8) | d[p + 1];
  }

  // EXIF orientation in an APP1 segment [p, p + len); malformed EXIF is
  // ignored, as cv2 ignores it.
  void check_exif(size_t p, size_t len) const {
    if (len < 14 || std::memcmp(d + p, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = d + p + 6;
    size_t tn = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto r16 = [&](size_t o) -> int {
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto r32 = [&](size_t o) -> uint32_t {
      return le ? (uint32_t(t[o]) | (uint32_t(t[o + 1]) << 8) |
                   (uint32_t(t[o + 2]) << 16) | (uint32_t(t[o + 3]) << 24))
                : ((uint32_t(t[o]) << 24) | (uint32_t(t[o + 1]) << 16) |
                   (uint32_t(t[o + 2]) << 8) | uint32_t(t[o + 3]));
    };
    if (r16(2) != 42) return;
    size_t ifd = r32(4);
    if (ifd + 2 > tn) return;
    int count = r16(ifd);
    for (int i = 0; i < count; i++) {
      size_t e = ifd + 2 + 12 * size_t(i);
      if (e + 12 > tn) return;
      if (r16(e) == 0x0112 && r16(e + 2) == 3) {
        int orient = r16(e + 8);
        if (orient >= 2 && orient <= 8)
          fail("EXIF orientation " + std::to_string(orient) +
               " (cv2 would turn or mirror the image; only orientation 1 "
               "is read)");
        return;
      }
    }
  }

  void read_sof(size_t p, int len) {
    if (frame) fail("more than one frame header");
    frame = true;
    if (len < 8) fail("short frame header");
    int prec = d[p];
    if (prec != 8)
      fail(std::to_string(prec) + "-bit samples (only 8-bit JPEGs are read)");
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = d[p + 5];
    if (height == 0) fail("frame height 0 (a DNL marker is not read)");
    if (width == 0) fail("frame width 0");
    if (ncomp == 4)
      fail("4 components (CMYK / Adobe four-component JPEGs are not read)");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + " components (only 1 or 3 are read)");
    if (len < 6 + 3 * ncomp) fail("short frame header");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad sampling factors or quantisation table id");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v)
        fail("fractional sampling factors are not read");
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
    }
  }

  // The colour space as libjpeg guesses it (jdapimin.c,
  // default_decompress_parms); an RGB-coded file is refused.
  void check_colorspace() const {
    if (ncomp != 3) return;
    bool rgb;
    if (jfif) rgb = false;
    else if (adobe) rgb = adobe_transform == 0;
    else rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    if (rgb)
      fail("RGB-coded 3-component JPEG (no YCbCr transform) is not read");
  }

  void read_dht(size_t p, int len) {
    size_t end = p + len;
    while (p < end) {
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table id");
      Huffman& h = tc ? ac[th] : dc[th];
      if (p + 17 > end) fail("truncated Huffman table");
      int total = 0;
      h.bits[0] = 0;
      for (int l = 1; l <= 16; l++) {
        h.bits[l] = d[p + l];
        total += h.bits[l];
      }
      if (total > 256 || p + 17 + total > end) fail("bad Huffman table");
      std::memset(h.vals, 0, sizeof(h.vals));
      std::memcpy(h.vals, d + p + 17, total);
      h.derive();
      h.present = true;
      p += 17 + total;
    }
  }

  void read_dqt(size_t p, int len) {
    size_t end = p + len;
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      if (tq > 3 || pq > 1) fail("bad quantisation table");
      if (p + 1 + 64 * (pq + 1) > end) fail("truncated quantisation table");
      for (int k = 0; k < 64; k++) {
        int v = pq ? ((d[p + 1 + 2 * k] << 8) | d[p + 2 + 2 * k])
                   : d[p + 1 + k];
        qt[tq][kNatural[k]] = static_cast<int16_t>(v);  // ISLOW_MULT_TYPE
      }
      qt_present[tq] = true;
      p += 1 + 64 * (pq + 1);
    }
  }

  void decode_block(BitReader& br, Component& c, int bx, int by) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    int t = br.decode(hd);
    int diff = t ? extend(br.get_bits(t), t) : 0;
    c.dc += diff;
    coef[0] = static_cast<int16_t>(c.dc);
    for (int k = 1; k < 64;) {
      int rs = br.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = static_cast<int16_t>(extend(br.get_bits(s), s));
        k++;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    int stride = c.bw * 8;
    uint8_t* out = c.plane.data() + size_t(by) * 8 * stride + bx * 8;
    idct_islow(coef, qt[c.tq], out, stride);
  }

  // Position of the next marker at or after p (skipping stray bytes, as
  // libjpeg's next_marker does).
  size_t find_marker(size_t p) const {
    while (p + 1 < n) {
      if (d[p] == 0xFF && d[p + 1] != 0 && d[p + 1] != 0xFF) return p;
      p++;
    }
    return n;
  }

  size_t read_scan(size_t p, int len, bool decode) {
    int ns = d[p];
    if (ns < 1 || ns > ncomp || len < 4 + 2 * ns) fail("bad scan header");
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = d[p + 1 + 2 * i], tables = d[p + 2 + 2 * i];
      Component* c = nullptr;
      for (int k = 0; k < ncomp; k++)
        if (comp[k].id == id) c = &comp[k];
      if (!c) fail("scan names an unknown component");
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].present ||
          !ac[c->ta].present)
        fail("scan uses an undefined Huffman table");
      if (!qt_present[c->tq]) fail("undefined quantisation table");
      sc[i] = c;
    }
    size_t q = p + 1 + 2 * ns;
    int ss = d[q], se = d[q + 1], ahal = d[q + 2];
    if (ss != 0 || se != 63 || ahal != 0)
      fail("spectral selection or successive approximation in a "
           "sequential scan");
    size_t data = p + len;
    if (!decode) return data;
    for (int i = 0; i < ns; i++) {
      Component* c = sc[i];
      if (c->plane.empty()) c->plane.assign(size_t(c->bw) * 8 * c->bh * 8, 0);
      c->dc = 0;
    }
    BitReader br(d, n, data);
    int nx, ny;
    if (ns == 1) {  // non-interleaved: one block per MCU
      nx = (sc[0]->dw + 7) / 8;
      ny = (sc[0]->dh + 7) / 8;
    } else {
      nx = mcux;
      ny = mcuy;
    }
    long done = 0;
    int next_rst = 0;
    for (int my = 0; my < ny; my++) {
      for (int mx = 0; mx < nx; mx++) {
        if (restart && done > 0 && done % restart == 0) {
          br.reset();
          size_t m = find_marker(br.pos);
          if (m + 1 >= n || d[m + 1] != 0xD0 + next_rst)
            fail("missing or out-of-order restart marker");
          next_rst = (next_rst + 1) & 7;
          br.pos = m + 2;
          br.at_marker = false;
          for (int i = 0; i < ns; i++) sc[i]->dc = 0;
        }
        if (ns == 1) {
          decode_block(br, *sc[0], mx, my);
        } else {
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++)
                decode_block(br, c, mx * c.h + h, my * c.v + v);
          }
        }
        done++;
      }
    }
    return find_marker(br.pos);
  }

  // Walks the markers. With decode=false it stops at the first scan
  // (headers only); with decode=true it decodes every scan to EOI.
  void parse(bool decode) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    size_t p = 2;
    bool scanned = false;
    while (true) {
      p = find_marker(p);
      if (p + 1 >= n) {
        if (scanned) return;  // no EOI: libjpeg warns and keeps the image
        fail("no image data before the end of the file");
      }
      int m = d[p + 1];
      p += 2;
      if (m == 0xD9) {
        if (!scanned) fail("no image data before EOI");
        return;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray restart marker
      if (m == 0x01) continue;               // TEM, no length
      int len = u16(p);
      if (len < 2 || p + len > n) fail("truncated marker segment");
      size_t body = p + 2;
      int blen = len - 2;
      switch (m) {
        case 0xC0: case 0xC1:
          read_sof(body, blen);
          break;
        case 0xC2: case 0xC6: case 0xCA: case 0xCE:
          fail("progressive JPEG (only baseline and extended sequential "
               "Huffman JPEGs are read)");
        case 0xC3: case 0xC7: case 0xCB: case 0xCF:
          fail("lossless JPEG is not read");
        case 0xC5:
          fail("hierarchical JPEG is not read");
        case 0xC9: case 0xCC: case 0xCD:
          fail("arithmetic-coded JPEG is not read");
        case 0xC4:
          read_dht(body, blen);
          break;
        case 0xDB:
          read_dqt(body, blen);
          break;
        case 0xDD:
          if (blen < 2) fail("short restart interval");
          restart = u16(body);
          break;
        case 0xE0:
          if (blen >= 5 && std::memcmp(d + body, "JFIF\0", 5) == 0)
            jfif = true;
          break;
        case 0xE1:
          check_exif(body, blen);
          break;
        case 0xEE:
          if (blen >= 12 && std::memcmp(d + body, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = d[body + 11];
          }
          break;
        case 0xDA:
          if (!frame) fail("scan before the frame header");
          check_colorspace();
          if (!decode) return;
          p = read_scan(body, blen, true);
          scanned = true;
          continue;
        default:
          break;
      }
      p = body + blen;
    }
  }

  // Chroma upsampling (jdsample.c) of component c to width x height.
  std::vector<uint8_t> upsample(const Component& c) const {
    const int W = width, H = height;
    std::vector<uint8_t> out(size_t(W) * H);
    const int stride = c.bw * 8;
    const uint8_t* in = c.plane.data();
    const int he = hmax / c.h, ve = vmax / c.v;
    const int dw = c.dw, dh = c.dh;
    auto at = [&](int y, int x) -> int { return in[size_t(y) * stride + x]; };
    if (he == 1 && ve == 1) {
      for (int y = 0; y < H; y++)
        std::memcpy(&out[size_t(y) * W], in + size_t(y) * stride, W);
    } else if (he == 2 && ve == 1 && dw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < H; y++)
        for (int x = 0; x < W; x++) {
          int i = x >> 1, t = 3 * at(y, i);
          out[size_t(y) * W + x] = static_cast<uint8_t>(
              (x & 1) ? (t + at(y, std::min(i + 1, dw - 1)) + 2) >> 2
                      : (t + at(y, std::max(i - 1, 0)) + 1) >> 2);
        }
    } else if (he == 1 && ve == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < H; y++) {
        int i = y >> 1;
        int nb = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; x++)
          out[size_t(y) * W + x] =
              static_cast<uint8_t>((3 * at(i, x) + at(nb, x) + bias) >> 2);
      }
    } else if (he == 2 && ve == 2 && dw > 2) {  // h2v2_fancy_upsample
      std::vector<int> colsum(dw);
      for (int y = 0; y < H; y++) {
        int i = y >> 1;
        int nb = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
        for (int k = 0; k < dw; k++) colsum[k] = 3 * at(i, k) + at(nb, k);
        for (int x = 0; x < W; x++) {
          int j = x >> 1, t = 3 * colsum[j];
          out[size_t(y) * W + x] = static_cast<uint8_t>(
              (x & 1) ? (t + colsum[std::min(j + 1, dw - 1)] + 7) >> 4
                      : (t + colsum[std::max(j - 1, 0)] + 8) >> 4);
        }
      }
    } else {  // h2v1 / h2v2 at width <= 2, and int_upsample: replication
      for (int y = 0; y < H; y++)
        for (int x = 0; x < W; x++)
          out[size_t(y) * W + x] = in[size_t(y / ve) * stride + x / he];
    }
    return out;
  }

  void to_rgb(uint8_t* rgb) {
    const int W = width, H = height;
    for (int i = 0; i < ncomp; i++)
      if (comp[i].plane.empty()) fail("a component has no scan");
    if (ncomp == 1) {
      const Component& c = comp[0];
      for (int y = 0; y < H; y++)
        for (int x = 0; x < W; x++) {
          uint8_t v = c.plane[size_t(y) * c.bw * 8 + x];
          uint8_t* o = rgb + (size_t(y) * W + x) * 3;
          o[0] = o[1] = o[2] = v;
        }
      return;
    }
    static const ColorTables tab;
    std::vector<uint8_t> Y = upsample(comp[0]), Cb = upsample(comp[1]),
                         Cr = upsample(comp[2]);
    for (size_t i = 0, np = size_t(W) * H; i < np; i++) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      uint8_t* o = rgb + i * 3;
      o[0] = clamp255(y + tab.cr_r[cr]);
      o[1] = clamp255(y + int((tab.cb_g[cb] + tab.cr_g[cr]) >> 16));
      o[2] = clamp255(y + tab.cb_b[cb]);
    }
  }
};

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::snprintf(err, size_t(errlen), "%s", msg);
  }
}

// ------------------------------------------------------- resize (cv2 rules)

// cv2's interpolateCubic: A = -0.75, float32.
inline void cubic_coeffs(float x, float* c) {
  const float A = -0.75f;
  c[0] = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A;
  c[1] = ((A + 2) * x - (A + 3)) * x * x + 1;
  c[2] = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1;
  c[3] = 1.f - c[0] - c[1] - c[2];
}

inline uint8_t round_u8(float v) {  // cvRound (half to even) + saturate
  long r = std::lrintf(v);
  return static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
}

struct Taps {
  std::vector<int> idx;     // n_out x 4 source indices, clamped
  std::vector<float> coef;  // n_out x 4
};

Taps cubic_taps(int n_in, int n_out, double inv_scale) {
  Taps t;
  t.idx.resize(size_t(n_out) * 4);
  t.coef.resize(size_t(n_out) * 4);
  const double scale = 1.0 / inv_scale;
  for (int o = 0; o < n_out; o++) {
    float f = static_cast<float>((o + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= s;
    cubic_coeffs(f, &t.coef[size_t(o) * 4]);
    for (int k = 0; k < 4; k++) {
      int i = s - 1 + k;
      t.idx[size_t(o) * 4 + k] = i < 0 ? 0 : (i >= n_in ? n_in - 1 : i);
    }
  }
  return t;
}

// One pixel of the 3-channel cubic warp at source (xs, ys): per channel
// the taps 0-3 of each row summed in order, then rows 0-3 (the channels'
// sums interleave).
inline void cubic_px(const uint8_t* src, int h, int w, float xs, float ys,
                     int border, uint8_t* px) {
  constexpr int CN = 3;
  const int sx = static_cast<int>(std::floor(xs));
  const int sy = static_cast<int>(std::floor(ys));
  float wx[4], wy[4];
  cubic_coeffs(xs - float(sx), wx);
  cubic_coeffs(ys - float(sy), wy);
  const bool inside = sx >= 1 && sy >= 1 && sx + 2 < w && sy + 2 < h;
  float acc[CN];
#pragma GCC unroll 4
  for (int i = 0; i < 4; i++) {
    const int yy = sy - 1 + i;
    float r[CN];
    if (inside) {  // every tap in the image
      const uint8_t* row = src + (size_t(yy) * w + (sx - 1)) * CN;
      const float w0 = wx[0], w1 = wx[1], w2 = wx[2], w3 = wx[3];
#pragma GCC unroll 4
      for (int c = 0; c < CN; c++) {
        float v = row[c] * w0;
        v = v + row[CN + c] * w1;
        v = v + row[2 * CN + c] * w2;
        r[c] = v + row[3 * CN + c] * w3;
      }
    } else {
      for (int j = 0; j < 4; j++) {
        const int xx = sx - 1 + j;
        const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
        for (int c = 0; c < CN; c++) {
          const int v = in ? src[(size_t(yy) * w + xx) * CN + c] : border;
          r[c] = j == 0 ? v * wx[0] : r[c] + v * wx[j];
        }
      }
    }
#pragma GCC unroll 4
    for (int c = 0; c < CN; c++)
      acc[c] = i == 0 ? r[c] * wy[0] : acc[c] + r[c] * wy[i];
  }
  for (int c = 0; c < CN; c++) px[c] = round_u8(acc[c]);
}

// One pixel of the linear warp at source (xs, ys), cn channels: the four
// taps around floor(xs), floor(ys) (a tap outside the image takes the
// border) blended along x, then along y, each blend fmaf(t, b - a, a) in
// float32; rounded half to even and saturated.
inline void linear_px(const uint8_t* src, int h, int w, int cn, float xs,
                      float ys, int border, uint8_t* px) {
  const int sx = static_cast<int>(std::floor(xs));
  const int sy = static_cast<int>(std::floor(ys));
  const float a = xs - float(sx), b = ys - float(sy);
  auto tap = [&](int yy, int xx, int c) -> float {
    const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
    return float(in ? src[(size_t(yy) * w + xx) * cn + c] : border);
  };
  for (int c = 0; c < cn; c++) {
    const float p00 = tap(sy, sx, c), p01 = tap(sy, sx + 1, c);
    const float p10 = tap(sy + 1, sx, c), p11 = tap(sy + 1, sx + 1, c);
    const float v0 = std::fmaf(a, p01 - p00, p00);
    const float v1 = std::fmaf(a, p11 - p10, p10);
    px[c] = round_u8(std::fmaf(b, v1 - v0, v0));
  }
}

}  // namespace

extern "C" {

// Headers only: the frame's height and width. 0 on success, else 1 with
// the cause in err.
int npp_jpeg_info(const uint8_t* data, size_t size, int* height, int* width,
                  char* err, int errlen) {
  try {
    Jpeg j(data, size);
    j.parse(false);
    if (!j.frame) throw Error("no frame header");
    *height = j.height;
    *width = j.width;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Decodes into out, height x width x 3 uint8 RGB (the sizes npp_jpeg_info
// gave). 0 on success, else 1 with the cause in err.
int npp_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out,
                    int height, int width, char* err, int errlen) {
  try {
    Jpeg j(data, size);
    j.parse(true);
    if (!j.frame) throw Error("no frame header");
    if (j.height != height || j.width != width)
      throw Error("frame size differs from the one given");
    j.to_rgb(out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// cv2.resize(src, None, fx, fy, INTER_CUBIC) for uint8 with cn channels:
// float32 taps (A = -0.75) at (d + 0.5) / f - 0.5, indices clamped; the
// horizontal pass first, then the vertical one, both summed in float32.
void npp_resize_cubic_u8(const uint8_t* src, int h, int w, int cn,
                         uint8_t* dst, int oh, int ow, double fx, double fy) {
  Taps tx = cubic_taps(w, ow, fx), ty = cubic_taps(h, oh, fy);
  std::vector<float> rows(size_t(h) * ow * cn);
  for (int y = 0; y < h; y++) {
    const uint8_t* s = src + size_t(y) * w * cn;
    float* r = &rows[size_t(y) * ow * cn];
    for (int x = 0; x < ow; x++) {
      const int* ix = &tx.idx[size_t(x) * 4];
      const float* a = &tx.coef[size_t(x) * 4];
      for (int c = 0; c < cn; c++) {
        float v = s[ix[0] * cn + c] * a[0];
        v += s[ix[1] * cn + c] * a[1];
        v += s[ix[2] * cn + c] * a[2];
        v += s[ix[3] * cn + c] * a[3];
        r[x * cn + c] = v;
      }
    }
  }
  for (int y = 0; y < oh; y++) {
    const int* iy = &ty.idx[size_t(y) * 4];
    const float* b = &ty.coef[size_t(y) * 4];
    const float* r0 = &rows[size_t(iy[0]) * ow * cn];
    const float* r1 = &rows[size_t(iy[1]) * ow * cn];
    const float* r2 = &rows[size_t(iy[2]) * ow * cn];
    const float* r3 = &rows[size_t(iy[3]) * ow * cn];
    uint8_t* o = dst + size_t(y) * ow * cn;
    for (int k = 0; k < ow * cn; k++) {
      float v = r0[k] * b[0];
      v += r1[k] * b[1];
      v += r2[k] * b[2];
      v += r3[k] * b[3];
      o[k] = round_u8(v);
    }
  }
}

// cv2.resize(src, None, fx, fy, INTER_NEAREST): source index
// floor(d * (1 / f)), clamped to the last.
void npp_resize_nearest_u8(const uint8_t* src, int h, int w, int cn,
                           uint8_t* dst, int oh, int ow, double fx,
                           double fy) {
  const double ifx = 1.0 / fx, ify = 1.0 / fy;
  std::vector<int> xs(ow);
  for (int x = 0; x < ow; x++)
    xs[x] = std::min(static_cast<int>(std::floor(x * ifx)), w - 1);
  for (int y = 0; y < oh; y++) {
    int sy = std::min(static_cast<int>(std::floor(y * ify)), h - 1);
    const uint8_t* s = src + size_t(sy) * w * cn;
    uint8_t* o = dst + size_t(y) * ow * cn;
    for (int x = 0; x < ow; x++)
      for (int c = 0; c < cn; c++) o[x * cn + c] = s[xs[x] * cn + c];
  }
}

// cv2.warpAffine(src, M, (ow, oh), flags, BORDER_CONSTANT, border) for
// uint8 with cn channels, by OpenCV 5's coordinate rule: M inverted in
// float64 (invertAffineTransform), the inverse cast to float32 (m); per
// row base = f32(f32(m01 * y) + m02), per pixel xs = fmaf(m00, x, base)
// (ys likewise). interp = 0: nearest, xs and ys rounded half to even, a
// source outside the image takes the border. interp = 1, cubic (cn = 3
// only): float32 taps (A = -0.75) around floor(xs), floor(ys); a tap
// outside the image takes the border; the four taps of each row summed,
// then the rows; rounded and saturated. interp = 2: linear (linear_px).
// Returns 1 for a cubic warp of cn != 3.
// Built twice, with and without the FMA instructions (chosen at load
// time): fmaf is exact either way, the hardware one is faster.
__attribute__((target_clones("fma", "default")))
int npp_warp_affine_u8(const uint8_t* src, int h, int w, int cn,
                       uint8_t* dst, int oh, int ow, const double* M,
                       int interp, int border) {
  const bool cubic = interp == 1;
  if (cubic && cn != 3) return 1;
  double D = M[0] * M[4] - M[1] * M[3];
  D = D != 0 ? 1. / D : 0;
  double A11 = M[4] * D, A22 = M[0] * D, A12 = M[1] * -D, A21 = M[3] * -D;
  double b1 = -A11 * M[2] - A12 * M[5];
  double b2 = -A21 * M[2] - A22 * M[5];
  const float m00 = float(A11), m01 = float(A12), m02 = float(b1);
  const float m10 = float(A21), m11 = float(A22), m12 = float(b2);
  const uint8_t bv = static_cast<uint8_t>(border);
  for (int y = 0; y < oh; y++) {
    const float fy = float(y);
    const float bx = m01 * fy + m02;  // each operation rounded to float32
    const float by = m11 * fy + m12;
    uint8_t* o = dst + size_t(y) * ow * cn;
    for (int x = 0; x < ow; x++) {
      const float fxv = float(x);
      const float xs = std::fmaf(m00, fxv, bx);
      const float ys = std::fmaf(m10, fxv, by);
      uint8_t* px = o + size_t(x) * cn;
      // Far outside (or not finite): every tap is the border.
      if (!(std::fabs(xs) < 1e8f && std::fabs(ys) < 1e8f)) {
        for (int c = 0; c < cn; c++) px[c] = bv;
        continue;
      }
      if (interp == 2) {
        linear_px(src, h, w, cn, xs, ys, border, px);
      } else if (!cubic) {
        long ix = std::lrintf(xs), iy = std::lrintf(ys);
        if (ix < 0 || iy < 0 || ix >= w || iy >= h) {
          for (int c = 0; c < cn; c++) px[c] = bv;
        } else {
          const uint8_t* s = src + (size_t(iy) * w + ix) * cn;
          for (int c = 0; c < cn; c++) px[c] = s[c];
        }
      } else {
        cubic_px(src, h, w, xs, ys, border, px);
      }
    }
  }
  return 0;
}

}  // extern "C"
