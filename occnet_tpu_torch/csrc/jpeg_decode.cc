// Baseline JPEG decoder with the arithmetic of libjpeg-turbo's default
// decompression in TensorFlow (`tf.io.decode_jpeg(data, channels=3)`):
// JDCT_IFAST (the AAN integer IDCT of jidctfst.c, quantisation tables
// pre-scaled as in jddctmgr.c), fancy upsampling (jdsample.c: h2v1 and h2v2
// triangle filters, the image's first / last sample rows replicated as
// context) and jdcolor.c's YCbCr -> RGB tables.  The same coefficients give
// the same pixels, bit for bit.
//
// Scope: sequential Huffman JPEG (SOF0 / SOF1), 8-bit samples, 1 or 3
// components, sampling 4:4:4, 4:2:2 or 4:2:0, interleaved or not, restart
// markers.  Anything else (progressive, arithmetic coding, lossless, 12-bit,
// CMYK, other sampling factors) is refused with a message, never decoded
// approximately.
//
// Plain C interface for ctypes, built by the host C++ compiler:
//   occ_jpeg_size(data, n, &h, &w, err, errlen)      -> 0 or -1
//   occ_jpeg_decode(data, n, out, out_bytes, err, errlen) -> 0 or -1
// `out` is (h, w, 3) uint8 RGB, row-major.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zigzag -> natural order; the 16 extra entries keep a corrupt run length
// inside the block, as libjpeg's jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jddctmgr.c: AAN scale factors, scaled up by 14 bits, natural order
const int kAanScales[64] = {
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,
    19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,
    12873, 17855, 16819, 15137, 12873, 10114, 6967,  3552,
    8867,  12299, 11585, 10426, 8867,  6967,  4799,  2446,
    4520,  6270,  5906,  5315,  4520,  3552,  2446,  1247};

const int kIfastScaleBits = 2;  // jdct.h, 8-bit samples
const int kConstBits = 8;       // jidctfst.c
const int kPass1Bits = 2;
const int kFix_1_082392200 = 277;
const int kFix_1_414213562 = 362;
const int kFix_1_847759065 = 473;
const int kFix_2_613125930 = 669;

struct Error {
  std::string msg;
};

struct Huffman {
  bool defined = false;
  int maxcode[18];  // largest code of each length, -1 if none
  int valoffset[17];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | value, 0 if the code is longer
  uint16_t look[512];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;       // Huffman tables of the current scan
  int dc_pred = 0;
  int bw = 0, bh = 0;       // blocks wide / high, padded to whole MCUs
  int dw = 0, dh = 0;       // downsampled width / height in samples
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // bw * 8 x bh * 8 samples after the IDCT
};

struct Decoder {
  const uint8_t *data;
  size_t n, pos = 0;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool frame = false;
  int restart_interval = 0;
  int adobe_transform = -1;  // APP14; -1 when absent
  bool jfif = false;
  int quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;

  // entropy-coded segment reader
  uint64_t acc = 0;
  int nbits = 0;
  bool hit_marker = false;

  Decoder(const uint8_t *d, size_t len) : data(d), n(len) {}

  [[noreturn]] void fail(const std::string &m) { throw Error{m}; }

  int byte() {
    if (pos >= n) fail("truncated JPEG data");
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // --- headers -----------------------------------------------------------

  void read_dqt(int len) {
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("bad quantisation table id");
      if (pq != 0) fail("16-bit quantisation tables are not supported");
      for (int i = 0; i < 64; i++) quant[tq][kNatural[i]] = byte();
      quant_defined[tq] = true;
    }
  }

  void read_dht(int len) {
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table id");
      Huffman &t = tc == 0 ? dc[th] : ac[th];
      int counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; l++) {
        counts[l] = byte();
        total += counts[l];
      }
      if (total > 256) fail("bad Huffman table");
      for (int i = 0; i < total; i++) t.vals[i] = static_cast<uint8_t>(byte());
      // canonical codes (JPEG F.2.2.3)
      int code = 0, k = 0;
      std::memset(t.look, 0, sizeof(t.look));
      for (int l = 1; l <= 16; l++) {
        t.valoffset[l] = k - code;
        for (int i = 0; i < counts[l]; i++, k++, code++) {
          if (code >= (1 << l)) fail("bad Huffman table");
          if (l <= 9) {
            int shift = 9 - l;
            for (int f = 0; f < (1 << shift); f++)
              t.look[(code << shift) | f] =
                  static_cast<uint16_t>((l << 8) | t.vals[k]);
          }
        }
        t.maxcode[l] = counts[l] ? code - 1 : -1;
        code <<= 1;
      }
      t.maxcode[17] = 0x7fffffff;
      t.defined = true;
    }
  }

  void read_sof(int len) {
    if (frame) fail("more than one frame");
    int precision = byte();
    if (precision != 8)
      fail("only 8-bit JPEG is supported (this one is " +
           std::to_string(precision) + "-bit)");
    height = word();
    width = word();
    int nc = byte();
    if (height <= 0) fail("JPEG height 0 (DNL) is not supported");
    if (width <= 0) fail("bad JPEG width");
    if (nc != 1 && nc != 3)
      fail("only 1- or 3-component JPEG is supported (this one has " +
           std::to_string(nc) + ")");
    if (len != 8 + 3 * nc) fail("bad SOF length");
    comps.resize(nc);
    for (auto &c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad component parameters");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (nc == 1) {
      // a single component is decoded at its own size, whatever its factors
      comps[0].h = comps[0].v = hmax = vmax = 1;
    } else {
      const Component &y = comps[0];
      bool chroma_1x1 = comps[1].h == 1 && comps[1].v == 1 &&
                        comps[2].h == 1 && comps[2].v == 1;
      bool ok = chroma_1x1 && ((y.h == 1 && y.v == 1) ||
                               (y.h == 2 && y.v == 1) ||
                               (y.h == 2 && y.v == 2));
      if (!ok) fail("unsupported sampling factors (4:4:4, 4:2:2 and 4:2:0 only)");
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto &c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
    frame = true;
  }

  void read_app14(int len) {
    size_t end = pos + len - 2;
    if (len >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0)
      adobe_transform = data[pos + 11];
    pos = end;
  }

  // --- entropy decoding --------------------------------------------------

  void fill() {
    while (nbits <= 56) {
      int b = 0;
      if (!hit_marker) {
        if (pos >= n) {
          hit_marker = true;
        } else if (data[pos] == 0xFF) {
          // 0xFF 0x00 is a stuffed 0xFF; fill bytes 0xFF 0xFF precede a marker
          size_t q = pos + 1;
          while (q < n && data[q] == 0xFF) q++;
          if (q < n && data[q] == 0x00) {
            b = 0xFF;
            pos = q + 1;
          } else {
            hit_marker = true;  // a marker: feed zeros, as libjpeg does
          }
        } else {
          b = data[pos++];
        }
      }
      acc |= static_cast<uint64_t>(b) << (56 - nbits);
      nbits += 8;
    }
  }

  int bits(int k) {
    if (k == 0) return 0;
    if (nbits < k) fill();
    int v = static_cast<int>(acc >> (64 - k));
    acc <<= k;
    nbits -= k;
    return v;
  }

  int decode(const Huffman &t) {
    if (nbits < 16) fill();
    int look = t.look[acc >> (64 - 9)];
    if (look) {
      int l = look >> 8;
      acc <<= l;
      nbits -= l;
      return look & 255;
    }
    int code = static_cast<int>(acc >> (64 - 9));
    int l = 9;
    acc <<= 9;
    nbits -= 9;
    while (code > t.maxcode[l]) {
      code = (code << 1) | bits(1);
      if (++l > 16) fail("corrupt JPEG data: bad Huffman code");
    }
    return t.vals[code + t.valoffset[l]];
  }

  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  void decode_block(Component &c, int16_t *blk) {
    int s = decode(dc[c.td]);
    int diff = s ? extend(bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(c.dc_pred);
    const Huffman &t = ac[c.ta];
    for (int k = 1; k < 64;) {
      int rs = decode(t);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(bits(s), s));
        k++;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void restart(int expected) {
    // discard the buffered bits and any unread padding, then read RSTn
    acc = 0;
    nbits = 0;
    hit_marker = false;
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                            data[pos + 1] != 0xFF))
      pos++;
    if (pos + 1 >= n || data[pos + 1] != 0xD0 + expected)
      fail("corrupt JPEG data: missing restart marker");
    pos += 2;
  }

  void read_scan(int len) {
    if (!frame) fail("scan before frame header");
    int ns = byte();
    if (ns < 1 || ns > static_cast<int>(comps.size()) || len != 6 + 2 * ns)
      fail("bad SOS");
    std::vector<Component *> sc;
    for (int i = 0; i < ns; i++) {
      int id = byte(), tables = byte();
      Component *found = nullptr;
      for (auto &c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("SOS names an unknown component");
      found->td = tables >> 4;
      found->ta = tables & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].defined ||
          !ac[found->ta].defined)
        fail("scan uses an undefined Huffman table");
      if (!quant_defined[found->tq])
        fail("component uses an undefined quantisation table");
      sc.push_back(found);
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0)
      fail("not a sequential scan (progressive JPEG is not supported)");
    for (auto *c : sc) c->dc_pred = 0;
    acc = 0;
    nbits = 0;
    hit_marker = false;

    int units_x, units_y;
    if (ns == 1) {  // non-interleaved: one block an MCU, unpadded
      Component *c = sc[0];
      units_x = (c->dw + 7) / 8;
      units_y = (c->dh + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    int todo = restart_interval, next_rst = 0;
    for (int my = 0; my < units_y; my++) {
      for (int mx = 0; mx < units_x; mx++) {
        if (restart_interval && todo == 0) {
          restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          todo = restart_interval;
          for (auto *c : sc) c->dc_pred = 0;
        }
        if (ns == 1) {
          Component *c = sc[0];
          decode_block(*c, &c->coef[(static_cast<size_t>(my) * c->bw + mx) * 64]);
        } else {
          for (auto *c : sc)
            for (int v = 0; v < c->v; v++)
              for (int h = 0; h < c->h; h++) {
                size_t b = static_cast<size_t>(my * c->v + v) * c->bw +
                           mx * c->h + h;
                decode_block(*c, &c->coef[b * 64]);
              }
        }
        todo--;
      }
    }
    // skip to the next marker
    while (pos + 1 < n && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                            !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
      pos++;
  }

  void parse(bool headers_only) {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    bool scanned = false;
    while (true) {
      // find the next marker, skipping fill bytes
      int b = byte();
      if (b != 0xFF) fail("corrupt JPEG data: expected a marker");
      int m = byte();
      while (m == 0xFF) m = byte();
      if (m == 0xD9) break;  // EOI
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      int len = word();
      if (len < 2 || pos + len - 2 > n) fail("truncated JPEG data");
      size_t end = pos + len - 2;
      if (m == 0xC0 || m == 0xC1) {
        read_sof(len);
        if (headers_only) return;
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        fail("progressive JPEG is not supported");
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        fail("lossless JPEG is not supported");
      } else if (m == 0xC5) {
        fail("hierarchical JPEG is not supported");
      } else if (m == 0xC9 || m == 0xCD) {
        fail("arithmetic-coded JPEG is not supported");
      } else if (m == 0xC4) {
        read_dht(len);
      } else if (m == 0xCC) {
        fail("arithmetic-coded JPEG is not supported");
      } else if (m == 0xDB) {
        read_dqt(len);
      } else if (m == 0xDD) {
        restart_interval = word();
      } else if (m == 0xDA) {
        read_scan(len);
        scanned = true;
        continue;  // read_scan left pos at the next marker
      } else if (m == 0xDC) {
        fail("DNL markers are not supported");
      } else if (m == 0xE0) {
        if (len >= 7 && std::memcmp(data + pos, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xEE) {
        read_app14(len);
      }
      pos = end;
    }
    if (!frame) fail("no frame header");
    if (!headers_only && !scanned) fail("no scan");
  }

  // --- reconstruction ----------------------------------------------------

  // jidctfst.c (USE_ACCURATE_ROUNDING undefined: every descale truncates)
  static int multiply(int v, int c) { return (v * c) >> kConstBits; }

  static void idct_ifast(const int16_t *in, const int *q, uint8_t *out,
                         int stride, const uint8_t *limit) {
    int ws[64];
    for (int col = 0; col < 8; col++) {
      const int16_t *ip = in + col;
      const int *qp = q + col;
      int *wp = ws + col;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
          ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
        int dcval = ip[0] * qp[0];
        for (int r = 0; r < 8; r++) wp[8 * r] = dcval;
        continue;
      }
      int tmp0 = ip[0] * qp[0], tmp1 = ip[16] * qp[16];
      int tmp2 = ip[32] * qp[32], tmp3 = ip[48] * qp[48];
      int tmp10 = tmp0 + tmp2, tmp11 = tmp0 - tmp2;
      int tmp13 = tmp1 + tmp3;
      int tmp12 = multiply(tmp1 - tmp3, kFix_1_414213562) - tmp13;
      tmp0 = tmp10 + tmp13;
      tmp3 = tmp10 - tmp13;
      tmp1 = tmp11 + tmp12;
      tmp2 = tmp11 - tmp12;
      int tmp4 = ip[8] * qp[8], tmp5 = ip[24] * qp[24];
      int tmp6 = ip[40] * qp[40], tmp7 = ip[56] * qp[56];
      int z13 = tmp6 + tmp5, z10 = tmp6 - tmp5;
      int z11 = tmp4 + tmp7, z12 = tmp4 - tmp7;
      tmp7 = z11 + z13;
      tmp11 = multiply(z11 - z13, kFix_1_414213562);
      int z5 = multiply(z10 + z12, kFix_1_847759065);
      tmp10 = multiply(z12, kFix_1_082392200) - z5;
      tmp12 = multiply(z10, -kFix_2_613125930) + z5;
      tmp6 = tmp12 - tmp7;
      tmp5 = tmp11 - tmp6;
      tmp4 = tmp10 + tmp5;
      wp[0] = tmp0 + tmp7;
      wp[56] = tmp0 - tmp7;
      wp[8] = tmp1 + tmp6;
      wp[48] = tmp1 - tmp6;
      wp[16] = tmp2 + tmp5;
      wp[40] = tmp2 - tmp5;
      wp[32] = tmp3 + tmp4;
      wp[24] = tmp3 - tmp4;
    }
    const int shift = kPass1Bits + 3;
    for (int row = 0; row < 8; row++) {
      const int *wp = ws + 8 * row;
      uint8_t *op = out + static_cast<size_t>(row) * stride;
      int tmp10 = wp[0] + wp[4], tmp11 = wp[0] - wp[4];
      int tmp13 = wp[2] + wp[6];
      int tmp12 = multiply(wp[2] - wp[6], kFix_1_414213562) - tmp13;
      int tmp0 = tmp10 + tmp13, tmp3 = tmp10 - tmp13;
      int tmp1 = tmp11 + tmp12, tmp2 = tmp11 - tmp12;
      int z13 = wp[5] + wp[3], z10 = wp[5] - wp[3];
      int z11 = wp[1] + wp[7], z12 = wp[1] - wp[7];
      int tmp7 = z11 + z13;
      tmp11 = multiply(z11 - z13, kFix_1_414213562);
      int z5 = multiply(z10 + z12, kFix_1_847759065);
      tmp10 = multiply(z12, kFix_1_082392200) - z5;
      tmp12 = multiply(z10, -kFix_2_613125930) + z5;
      int tmp6 = tmp12 - tmp7;
      int tmp5 = tmp11 - tmp6;
      int tmp4 = tmp10 + tmp5;
      op[0] = limit[((tmp0 + tmp7) >> shift) & 1023];
      op[7] = limit[((tmp0 - tmp7) >> shift) & 1023];
      op[1] = limit[((tmp1 + tmp6) >> shift) & 1023];
      op[6] = limit[((tmp1 - tmp6) >> shift) & 1023];
      op[2] = limit[((tmp2 + tmp5) >> shift) & 1023];
      op[5] = limit[((tmp2 - tmp5) >> shift) & 1023];
      op[4] = limit[((tmp3 + tmp4) >> shift) & 1023];
      op[3] = limit[((tmp3 - tmp4) >> shift) & 1023];
    }
  }

  void reconstruct() {
    // jdmaster.c's post-IDCT range limit: x & 1023 -> clamp(x + 128) for
    // x in [-384, 383], wrapping beyond
    uint8_t limit[1024];
    for (int y = 0; y < 1024; y++)
      limit[y] = static_cast<uint8_t>(y < 128 ? y + 128 : y < 512 ? 255
                                      : y < 896 ? 0 : y - 896);
    for (auto &c : comps) {
      int q[64];
      for (int i = 0; i < 64; i++)  // jddctmgr.c, DESCALE rounds here
        q[i] = (quant[c.tq][i] * kAanScales[i] +
                (1 << (14 - kIfastScaleBits - 1))) >>
               (14 - kIfastScaleBits);
      int stride = c.bw * 8;
      c.plane.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct_ifast(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], q,
                     &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8],
                     stride, limit);
      std::vector<int16_t>().swap(c.coef);
    }
  }

  // one output row of a component at full resolution (jdsample.c)
  void upsample_row(const Component &c, int row, uint8_t *out) const {
    const int stride = c.bw * 8;
    const uint8_t *plane = c.plane.data();
    int fancy = c.dw > 2;
    if (c.h == hmax && c.v == vmax) {
      std::memcpy(out, plane + static_cast<size_t>(row) * stride, width);
      return;
    }
    if (c.v == vmax) {  // h2v1
      const uint8_t *in = plane + static_cast<size_t>(row) * stride;
      if (!fancy) {
        for (int x = 0; x < width; x++) out[x] = in[x >> 1];
        return;
      }
      std::vector<uint8_t> full(2 * c.dw);
      uint8_t *o = full.data();
      int v = in[0];
      *o++ = static_cast<uint8_t>(v);
      *o++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < c.dw - 1; i++) {
        v = in[i] * 3;
        *o++ = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
        *o++ = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
      }
      v = in[c.dw - 1];
      *o++ = static_cast<uint8_t>((v * 3 + in[c.dw - 2] + 1) >> 2);
      *o++ = static_cast<uint8_t>(v);
      std::memcpy(out, full.data(), width);
      return;
    }
    // h2v2: the nearer input row and the next nearer (above for an even
    // output row, below for an odd one), the image's edge rows replicated
    int r = row >> 1;
    if (r > c.dh - 1) r = c.dh - 1;
    if (!fancy) {
      const uint8_t *in = plane + static_cast<size_t>(r) * stride;
      for (int x = 0; x < width; x++) out[x] = in[x >> 1];
      return;
    }
    int r1 = (row & 1) ? r + 1 : r - 1;
    if (r1 < 0) r1 = 0;
    if (r1 > c.dh - 1) r1 = c.dh - 1;
    const uint8_t *in0 = plane + static_cast<size_t>(r) * stride;
    const uint8_t *in1 = plane + static_cast<size_t>(r1) * stride;
    std::vector<uint8_t> full(2 * c.dw);
    uint8_t *o = full.data();
    int thiscol = in0[0] * 3 + in1[0];
    int nextcol = in0[1] * 3 + in1[1];
    *o++ = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
    *o++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
    int lastcol = thiscol;
    thiscol = nextcol;
    for (int i = 2; i < c.dw; i++) {
      nextcol = in0[i] * 3 + in1[i];
      *o++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
      *o++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
    }
    *o++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
    *o++ = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
    std::memcpy(out, full.data(), width);
  }

  void to_rgb(uint8_t *out) const {
    const size_t row_bytes = static_cast<size_t>(width) * 3;
    if (comps.size() == 1) {
      std::vector<uint8_t> g(width);
      for (int y = 0; y < height; y++) {
        upsample_row(comps[0], y, g.data());
        uint8_t *o = out + y * row_bytes;
        for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      }
      return;
    }
    // jdcolor.c: YCbCr -> RGB unless an Adobe marker says "no transform"
    // (or, without JFIF / Adobe markers, the component ids spell R, G, B)
    bool transform = true;
    if (adobe_transform == 0) transform = false;
    if (!jfif && adobe_transform < 0 && comps[0].id == 'R' &&
        comps[1].id == 'G' && comps[2].id == 'B')
      transform = false;
    const int kScaleBits = 16;
    const int64_t kHalf = int64_t(1) << (kScaleBits - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t(1) << 16) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScaleBits);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto clamp = [](int v) {
      return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    };
    std::vector<uint8_t> yr(width), cbr(width), crr(width);
    for (int y = 0; y < height; y++) {
      upsample_row(comps[0], y, yr.data());
      upsample_row(comps[1], y, cbr.data());
      upsample_row(comps[2], y, crr.data());
      uint8_t *o = out + y * row_bytes;
      if (!transform) {
        for (int x = 0; x < width; x++) {
          o[3 * x] = yr[x];
          o[3 * x + 1] = cbr[x];
          o[3 * x + 2] = crr[x];
        }
        continue;
      }
      for (int x = 0; x < width; x++) {
        int yy = yr[x], cb = cbr[x], cr = crr[x];
        o[3 * x] = clamp(yy + cr_r[cr]);
        o[3 * x + 1] = clamp(
            yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScaleBits));
        o[3 * x + 2] = clamp(yy + cb_b[cb]);
      }
    }
  }
};

void set_error(char *err, int errlen, const std::string &m) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", m.c_str());
}

}  // namespace

extern "C" {

int occ_jpeg_size(const uint8_t *data, size_t n, int *h, int *w, char *err,
                  int errlen) {
  try {
    Decoder d(data, n);
    d.parse(true);
    *h = d.height;
    *w = d.width;
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, e.what());
  }
  return -1;
}

int occ_jpeg_decode(const uint8_t *data, size_t n, uint8_t *out,
                    size_t out_bytes, char *err, int errlen) {
  try {
    Decoder d(data, n);
    d.parse(false);
    if (out_bytes != static_cast<size_t>(d.width) * d.height * 3)
      throw Error{"output buffer has the wrong size"};
    d.reconstruct();
    d.to_rgb(out);
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, e.what());
  }
  return -1;
}

}  // extern "C"
