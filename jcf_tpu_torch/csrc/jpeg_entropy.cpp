// JPEG markers and Huffman decoding on the host: a JPEG's bytes -> the
// quantized DCT coefficients of each component, with its quantization
// table, sampling factors and block grid. The card (csrc/jpeg.cu) and the
// plain versions (data/jpeg.py) take it from there: dequantize + IDCT,
// chroma upsampling, YCbCr -> RGB.
//
// What it reads, as libjpeg-turbo reads it with its defaults: SOI, EOI,
// APPn and COM (skipped, apart from APP0 "JFIF" and APP14 "Adobe", which
// decide the colour space as jdapimin.c decides it), DQT (8- and 16-bit),
// DHT, SOF0 / SOF1 (baseline and extended sequential) and SOF2
// (progressive), SOS, DRI and RST0-7. Progressive scans: DC and AC first
// and refinement scans with EOB runs (jdphuff.c). Everything else raises:
// arithmetic coding (SOF9 and up, DAC), lossless and hierarchical frames,
// precision other than 8 bits, 2 or 4 components (CMYK / YCCK), and data
// that is truncated or corrupt (a Huffman code no table holds, a
// coefficient index past 63, a missing or misnumbered restart marker,
// entropy data that ends before the scan's last block). libjpeg would
// warn and fill such data with zeros; this decoder refuses it instead.
// A progressive image whose scans leave one of the first ten coefficients
// short of full precision is refused too: libjpeg would smooth its blocks
// (do_block_smoothing, jdcoefct.c), which nothing here reproduces.
//
// Coefficients are int16 as libjpeg's JCOEF, in natural (row-major)
// order, one 64-entry block per 8 x 8 block of the component's coded grid
// (whole MCUs: mcus_x * h blocks wide, mcus_y * v high; blocks a scan
// never codes stay 0). The DC predictor is an int as in jdhuff.c, stored
// truncated to int16.
//
// A plain C interface for ctypes (which releases the interpreter lock for
// the call): jcf_jpeg_open parses and decodes, jcf_jpeg_copy copies the
// result into caller buffers, jcf_jpeg_close frees it. Built with g++.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Error{buf};
}

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t values[256] = {};
  int maxcode[18] = {};   // largest code of each length, -1 if none
  int valoffset[17] = {}; // values index of a code of each length, minus that code
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | value, 0 if longer

  void build(const uint8_t* bits, const uint8_t* vals, int n) {
    std::memcpy(values, vals, n);
    int code = 0, k = 0;
    std::memset(look, 0, sizeof look);
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      if (bits[len - 1]) {
        for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
          if (len <= kLookBits) {
            const int shift = kLookBits - len;
            for (int j = 0; j < (1 << shift); ++j)
              look[(code << shift) | j] = (uint16_t)((len << 8) | vals[k]);
          }
        }
        maxcode[len] = code - 1;
      } else {
        maxcode[len] = -1;
      }
      if (code > (1 << len)) fail("bad Huffman table (code lengths overfull)");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;      // coded grid in blocks (whole MCUs)
  int width_blocks = 0, height_blocks = 0;  // blocks a single-component scan codes
  bool quant_latched = false;
  int32_t quant[64] = {};  // natural order
  int coef_bits[64];       // progressive: current Al of each coefficient, -1 none yet
  size_t offset = 0;       // into coefs, in int16 entries
};

// Entropy-coded data with 0xFF00 stuffing; stops at a marker and feeds
// zero bits after it, which a valid scan never consumes.
struct BitReader {
  const uint8_t* data;
  size_t len, pos;
  uint64_t buf = 0;
  int nbits = 0;
  int fake = 0;  // zero bits fed past a marker or the end, at the bottom of buf
  bool at_marker = false;

  void reset(size_t p) {
    pos = p;
    buf = 0;
    nbits = 0;
    fake = 0;
    at_marker = false;
  }

  void fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!at_marker && pos < len) {
        b = data[pos];
        if (b == 0xFF) {
          const uint32_t next = pos + 1 < len ? data[pos + 1] : 0x100;
          if (next == 0x00) {
            pos += 2;
          } else {
            at_marker = true;  // pos stays on the marker's 0xFF
            b = 0;
            fake += 8;
          }
        } else {
          ++pos;
        }
      } else {
        at_marker = true;
        fake += 8;
      }
      buf |= (uint64_t)b << (56 - nbits);
      nbits += 8;
    }
  }

  void consumed(int n) {
    buf <<= n;
    nbits -= n;
    if (nbits < fake) fail("entropy-coded data ends early (truncated or corrupt)");
  }

  int bits(int n) {  // n in 0..16
    if (n == 0) return 0;
    if (nbits < n) fill();
    const int v = (int)(buf >> (64 - n));
    consumed(n);
    return v;
  }

  int bit() { return bits(1); }

  int decode(const Huffman& t) {
    if (nbits < 16) fill();
    const int peek = (int)(buf >> (64 - kLookBits));
    const uint16_t e = t.look[peek];
    if (e) {
      consumed(e >> 8);
      return e & 0xFF;
    }
    int len = kLookBits + 1;
    int code = (int)(buf >> (64 - len));
    while (len <= 16 && code > t.maxcode[len]) {
      ++len;
      code = (int)(buf >> (64 - len));
    }
    if (len > 16) fail("corrupt entropy-coded data (no Huffman code matches)");
    consumed(len);
    return t.values[code + t.valoffset[len]];
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;

  int width = 0, height = 0, ncomp = 0, max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
  bool progressive = false, frame = false, jfif = false, adobe = false;
  int adobe_transform = -1, restart_interval = 0;
  Component comp[4];
  bool qdefined[4] = {};
  int32_t qtables[4][64] = {};
  Huffman dc_tables[4], ac_tables[4];
  std::vector<int16_t> coefs;

  // the current scan
  int scomp[4] = {}, nscomp = 0, ss = 0, se = 0, ah = 0, al = 0;
  int dc_sel[4] = {}, ac_sel[4] = {};

  int u8() {
    if (pos >= len) fail("unexpected end of file");
    return data[pos++];
  }
  int u16() {
    const int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    // skips fill bytes; anything else before a marker is corrupt data
    if (pos >= len) fail("unexpected end of file (no EOI marker)");
    if (data[pos] != 0xFF) fail("corrupt data: 0x%02x where a marker belongs", data[pos]);
    while (pos < len && data[pos] == 0xFF) ++pos;
    if (pos >= len) fail("unexpected end of file");
    return data[pos++];
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      const int pq_tq = u8(), pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad DQT table %d precision %d", tq, pq);
      for (int k = 0; k < 64; ++k) qtables[tq][kNatural[k]] = pq ? u16() : u8();
      qdefined[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      const int tc_th = u8(), tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT table class %d id %d", tc, th);
      uint8_t bits[16], vals[256];
      int n = 0;
      for (int i = 0; i < 16; ++i) n += bits[i] = (uint8_t)u8();
      if (n > 256) fail("bad DHT table (%d values)", n);
      for (int i = 0; i < n; ++i) vals[i] = (uint8_t)u8();
      (tc ? ac_tables : dc_tables)[th].build(bits, vals, n);
    }
  }

  void read_sof(int marker) {
    if (frame) fail("more than one frame header");
    const int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8)
      fail("a %d-bit JPEG; the decoder takes 8-bit samples", precision);
    if (height == 0) fail("a JPEG whose height comes later (DNL); not supported");
    if (width == 0) fail("a JPEG of width 0");
    if (ncomp == 4) fail("a 4-component (CMYK / YCCK) JPEG; the decoder takes 1 or 3");
    if (ncomp != 1 && ncomp != 3) fail("a JPEG of %d components; the decoder takes 1 or 3", ncomp);
    for (int c = 0; c < ncomp; ++c) {
      comp[c].id = u8();
      const int hv = u8();
      comp[c].h = hv >> 4;
      comp[c].v = hv & 15;
      comp[c].tq = u8();
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4 || comp[c].tq > 3)
        fail("bad sampling factors or table of component %d", c);
      max_h = std::max(max_h, comp[c].h);
      max_v = std::max(max_v, comp[c].v);
    }
    progressive = marker == 0xC2;
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    size_t total = 0;
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.bw = mcus_x * k.h;
      k.bh = mcus_y * k.v;
      k.width_blocks = (int)(((long long)width * k.h + 8LL * max_h - 1) / (8LL * max_h));
      k.height_blocks = (int)(((long long)height * k.v + 8LL * max_v - 1) / (8LL * max_v));
      k.offset = total;
      for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
      total += (size_t)k.bw * k.bh * 64;
    }
    coefs.assign(total, 0);
    frame = true;
  }

  void read_sos() {
    if (!frame) fail("a scan before the frame header");
    const int n = u8();
    if (n < 1 || n > ncomp) fail("bad scan of %d components", n);
    nscomp = n;
    for (int i = 0; i < n; ++i) {
      const int id = u8(), sel = u8();
      int c = 0;
      while (c < ncomp && comp[c].id != id) ++c;
      if (c == ncomp) fail("a scan names component id %d, which the frame lacks", id);
      for (int j = 0; j < i; ++j)
        if (scomp[j] == c) fail("a scan names component id %d twice", id);
      scomp[i] = c;
      dc_sel[i] = sel >> 4;
      ac_sel[i] = sel & 15;
      if (dc_sel[i] > 3 || ac_sel[i] > 3) fail("bad Huffman table selector");
    }
    ss = u8();
    se = u8();
    const int a = u8();
    ah = a >> 4;
    al = a & 15;
    if (progressive) {
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || n != 1))
        fail("bad progressive scan (Ss %d, Se %d, %d components)", ss, se, n);
      if (al > 13 || (ah != 0 && ah != al + 1)) fail("bad progressive scan (Ah %d, Al %d)", ah, al);
    }
    int blocks_per_mcu = 0;
    for (int i = 0; i < n; ++i) blocks_per_mcu += comp[scomp[i]].h * comp[scomp[i]].v;
    if (n > 1 && blocks_per_mcu > 10) fail("more than 10 blocks in an MCU");
    // each component's quantization table is taken at its first scan (jdinput.c)
    for (int i = 0; i < n; ++i) {
      Component& k = comp[scomp[i]];
      if (!k.quant_latched) {
        if (!qdefined[k.tq]) fail("quantization table %d is not defined", k.tq);
        std::memcpy(k.quant, qtables[k.tq], sizeof k.quant);
        k.quant_latched = true;
      }
    }
    decode_scan();
  }

  int16_t* block(int c, int by, int bx) {
    return coefs.data() + comp[c].offset + ((size_t)by * comp[c].bw + bx) * 64;
  }

  const Huffman& table(Huffman* tables, int sel) {
    if (!tables[sel].defined) fail("Huffman table %d used before it is defined", sel);
    return tables[sel];
  }

  void decode_scan() {
    BitReader br{data, len, pos};
    int last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0;
    const bool single = nscomp == 1;
    const int units_x = single ? comp[scomp[0]].width_blocks : mcus_x;
    const int units_y = single ? comp[scomp[0]].height_blocks : mcus_y;
    const long long units = (long long)units_x * units_y;
    const bool need_dc = !progressive || (ss == 0 && ah == 0);
    const bool need_ac = !progressive || ss > 0;
    const Huffman* dct[4] = {};
    const Huffman* act[4] = {};
    for (int i = 0; i < nscomp; ++i) {
      if (need_dc) dct[i] = &table(dc_tables, dc_sel[i]);
      if (need_ac) act[i] = &table(ac_tables, ac_sel[i]);
    }
    int restarts = 0;
    for (long long u = 0; u < units; ++u) {
      if (restart_interval && u > 0 && u % restart_interval == 0) {
        // the bits left in this interval's last byte are padding
        const size_t p = marker_from(br.pos);
        if (p + 1 >= len || data[p + 1] != 0xD0 + (restarts & 7))
          fail("restart marker RST%d missing or misnumbered", restarts & 7);
        ++restarts;
        br.reset(p + 2);
        for (int& d : last_dc) d = 0;
        eobrun = 0;
      }
      const int mx = (int)(u % units_x), my = (int)(u / units_x);
      for (int i = 0; i < nscomp; ++i) {
        const int c = scomp[i];
        const int nh = single ? 1 : comp[c].h, nv = single ? 1 : comp[c].v;
        for (int yy = 0; yy < nv; ++yy)
          for (int xx = 0; xx < nh; ++xx) {
            int16_t* b = block(c, my * nv + yy, mx * nh + xx);
            if (!progressive) {
              decode_baseline(br, b, *dct[i], *act[i], last_dc[i]);
            } else if (ss == 0) {
              if (ah == 0) {
                const int s = br.decode(*dct[i]);
                if (s > 16) fail("corrupt entropy-coded data (DC category %d)", s);
                const int diff = s ? extend(br.bits(s), s) : 0;
                last_dc[i] += diff;
                b[0] = (int16_t)((unsigned)last_dc[i] << al);
              } else if (br.bit()) {
                b[0] = (int16_t)(b[0] | (1 << al));
              }
            } else if (ah == 0) {
              decode_ac_first(br, b, *act[i], eobrun);
            } else {
              decode_ac_refine(br, b, *act[i], eobrun);
            }
          }
      }
    }
    // the scan's coefficients now have precision al
    if (progressive) {
      for (int i = 0; i < nscomp; ++i)
        for (int k = ss; k <= se; ++k) comp[scomp[i]].coef_bits[k] = al;
    }
    pos = marker_from(br.pos);
  }

  // the position of the first marker at or after p (past the padding bits
  // of the entropy-coded data's last byte, and fill bytes)
  size_t marker_from(size_t p) const {
    while (p + 1 < len && !(data[p] == 0xFF && data[p + 1] != 0x00 && data[p + 1] != 0xFF)) ++p;
    if (p + 1 >= len) fail("unexpected end of file inside a scan");
    return p;
  }

  void decode_baseline(BitReader& br, int16_t* b, const Huffman& dc, const Huffman& ac,
                       int& last) {
    int s = br.decode(dc);
    if (s > 16) fail("corrupt entropy-coded data (DC category %d)", s);
    if (s) s = extend(br.bits(s), s);
    last += s;
    b[0] = (int16_t)last;
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(ac), r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt entropy-coded data (coefficient index %d)", k);
        b[kNatural[k]] = (int16_t)extend(br.bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_ac_first(BitReader& br, int16_t* b, const Huffman& ac, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = br.decode(ac), r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt entropy-coded data (coefficient index %d)", k);
        b[kNatural[k]] = (int16_t)((unsigned)extend(br.bits(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        --eobrun;
        break;
      }
    }
  }

  void decode_ac_refine(BitReader& br, int16_t* b, const Huffman& ac, int& eobrun) {
    const int p1 = 1 << al, m1 = -p1;
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt entropy-coded data (refinement size %d)", s);
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* c = b + kNatural[k];
          if (*c != 0) {
            if (br.bit() && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > 63) fail("corrupt entropy-coded data (coefficient index %d)", k);
          b[kNatural[k]] = (int16_t)s;
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* c = b + kNatural[k];
        if (*c != 0 && br.bit() && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
      }
      --eobrun;
    }
  }

  void run() {
    if (len < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    bool scanned = false;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m == 0xD8) fail("a second SOI marker");
      if (m >= 0xD0 && m <= 0xD7) fail("RST%d outside a scan", m - 0xD0);
      if (m == 0x01) continue;  // TEM, no length
      const int seg = u16();
      if (seg < 2 || pos + seg - 2 > len) fail("marker 0x%02x runs past the end of the file", m);
      const size_t end = pos + seg - 2;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m);
      } else if (m == 0xC3 || (m >= 0xC5 && m <= 0xC7)) {
        fail("a lossless or hierarchical JPEG (SOF%d); not supported", m - 0xC0);
      } else if ((m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF) || m == 0xCC) {
        fail("an arithmetic-coded JPEG (marker 0x%02x); not supported", m);
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xDD) {
        restart_interval = u16();
      } else if (m == 0xDA) {
        read_sos();
        scanned = true;
        continue;
      } else if (m == 0xE0 && seg - 2 >= 14 && std::memcmp(data + pos, "JFIF\0", 5) == 0) {
        jfif = true;
      } else if (m == 0xEE && seg - 2 >= 12 && std::memcmp(data + pos, "Adobe", 5) == 0) {
        adobe = true;
        adobe_transform = data[pos + 11];
      } else if (!((m >= 0xE0 && m <= 0xEF) || m == 0xFE)) {
        fail("unsupported marker 0x%02x", m);
      }
      if (pos > end) fail("marker 0x%02x longer than its length says", m);
      pos = end;
    }
    if (!frame || !scanned) fail("a JPEG without a frame or a scan");
    for (int c = 0; c < ncomp; ++c) {
      if (!comp[c].quant_latched) fail("component %d is in no scan", c);
      if (!progressive) continue;
      for (int k = 0; k < 10; ++k)
        if (comp[c].coef_bits[k] != 0)
          fail("progressive scans leave coefficient %d of component %d short of full "
               "precision (libjpeg would smooth the blocks; not supported)", k, c);
    }
  }

  // 1 where the three components are YCbCr (jdapimin.c: JFIF, else Adobe's
  // transform, else the component ids)
  int ycc() const {
    if (ncomp != 3) return 0;
    if (jfif) return 1;
    if (adobe) return adobe_transform == 0 ? 0 : 1;
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) return 0;
    return 1;
  }
};

}  // namespace

extern "C" {

// Parses and decodes `data`; returns a handle (free it with jcf_jpeg_close)
// or null, with the reason in err. info (5 + 4 * 3 ints): width, height,
// components, 1 for YCbCr -> RGB, 1 for progressive, then per component h,
// v, coded blocks wide, coded blocks high.
void* jcf_jpeg_open(const uint8_t* data, long long len, int* info, char* err, int err_len) {
  Decoder* d = new (std::nothrow) Decoder();
  if (!d) {
    snprintf(err, err_len, "out of memory");
    return nullptr;
  }
  d->data = data;
  d->len = (size_t)len;
  try {
    d->run();
  } catch (const Error& e) {
    snprintf(err, err_len, "%s", e.msg.c_str());
    delete d;
    return nullptr;
  } catch (const std::bad_alloc&) {
    snprintf(err, err_len, "out of memory");
    delete d;
    return nullptr;
  }
  d->data = nullptr;  // the caller's buffer is not kept
  const int head[5] = {d->width, d->height, d->ncomp, d->ycc(), d->progressive ? 1 : 0};
  std::memcpy(info, head, sizeof head);
  for (int c = 0; c < 3; ++c) {
    const bool on = c < d->ncomp;
    info[5 + 4 * c + 0] = on ? d->comp[c].h : 0;
    info[5 + 4 * c + 1] = on ? d->comp[c].v : 0;
    info[5 + 4 * c + 2] = on ? d->comp[c].bw : 0;
    info[5 + 4 * c + 3] = on ? d->comp[c].bh : 0;
  }
  return d;
}

// coefs: every component's blocks in turn (int16 [bh * bw, 64] each);
// quant: int32 [components, 64], natural order
void jcf_jpeg_copy(void* handle, int16_t* coefs, int32_t* quant) {
  const Decoder* d = static_cast<const Decoder*>(handle);
  std::memcpy(coefs, d->coefs.data(), d->coefs.size() * sizeof(int16_t));
  for (int c = 0; c < d->ncomp; ++c) std::memcpy(quant + 64 * c, d->comp[c].quant, 64 * 4);
}

void jcf_jpeg_close(void* handle) { delete static_cast<Decoder*>(handle); }

}  // extern "C"
