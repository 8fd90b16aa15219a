// JPEG entropy decoder: a file's quantized DCT coefficients, with no
// libjpeg.
//
// The host half of the split decode (data/native_decode.py
// decode_jpeg_coeffs): it parses the markers and Huffman-decodes the
// scans, and the device finishes the decode (ops/jpeg_decode.py:
// dequantization, inverse DCT, chroma upsampling, YCbCr -> RGB).  The
// quantized coefficients are exact integers, so this decoder gives
// libjpeg's jpeg_read_coefficients values bit for bit.
//
// Handled: SOI, APPn / COM (skipped), DQT (8- and 16-bit tables), SOF0 /
// SOF1 (sequential Huffman) and SOF2 (progressive Huffman: spectral
// selection, DC and AC successive approximation, EOB runs), DHT, DRI and
// restart markers, SOS, EOI.  Refused: arithmetic coding, lossless and
// hierarchical frames, precision other than 8 bits, layouts other than
// grey, 4:4:4 and 4:2:0 (luma 1x1 or 2x2 with 1x1 chroma), Cb and Cr on
// different quantization tables, and files whose data ends before EOI.
//
// C ABI only (loaded with ctypes).
//
// Build: g++ -O3 -fPIC -shared -o libjpeg_coeffs.so jpeg_coeffs.cc

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
  kOk = 0,
  kCorrupt = -1,
  kNotJpeg = -2,
  kCapacity = -3,
  kLayout = -4,
  kArithmetic = -5,
  kPrecision = -6,
  kLossless = -7,
  kChromaTables = -8,
  kTruncated = -9,
};

// zigzag index -> natural (row-major) index, with 16 spare entries so a
// corrupt run past 63 stays inside the block
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huff {
  bool defined = false;
  int maxcode[18];    // largest code of each length, -1 if none
  int valoffset[18];  // symbol index of a code of that length, minus code
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol; 0: longer
};

bool build_huff(Huff* h, const uint8_t* counts, const uint8_t* syms) {
  int n = 0;
  for (int l = 0; l < 16; ++l) n += counts[l];
  if (n > 256) return false;
  memcpy(h->vals, syms, n);
  memset(h->look, 0, sizeof(h->look));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    const int c = counts[l - 1];
    h->valoffset[l] = k - code;
    h->maxcode[l] = c ? code + c - 1 : -1;
    for (int i = 0; i < c; ++i, ++code, ++k) {
      if (l <= kLookBits) {
        const int shift = kLookBits - l;
        for (int j = 0; j < (1 << shift); ++j)
          h->look[(code << shift) | j] =
              static_cast<uint16_t>((l << 8) | h->vals[k]);
      }
    }
    if (code > (1 << l)) return false;  // not a prefix code
    code <<= 1;
  }
  h->maxcode[17] = 0x7fffffff;
  h->defined = true;
  return true;
}

// Entropy-coded data: bytes with 0xFF00 stuffing, ended by a marker.
// Past the marker (or the end of the buffer) it feeds zeros, as libjpeg
// does.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  bool stopped = false;  // p is at a marker (or the end): feed zeros

  void fill() {
    while (bits <= 56) {
      unsigned b = 0;
      if (!stopped) {
        if (p >= end) {
          stopped = true;
        } else if (*p != 0xFF) {
          b = *p++;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;
          if (q < end && *q == 0x00) {
            b = 0xFF;
            p = q + 1;
          } else {
            p = q - 1;  // the marker's last 0xFF
            stopped = true;
          }
        }
      }
      buf |= static_cast<uint64_t>(b) << (56 - bits);
      bits += 8;
    }
  }
  unsigned peek(int n) {
    if (bits < n) fill();
    return static_cast<unsigned>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    bits -= n;
  }
  unsigned get(int n) {
    if (n == 0) return 0;
    const unsigned v = peek(n);
    skip(n);
    return v;
  }
  void reset() {
    buf = 0;
    bits = 0;
    stopped = false;
  }
};

inline int extend(unsigned v, int s) {
  return s == 0 ? 0
                : (v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1
                                       : static_cast<int>(v));
}

struct Component {
  int id, h, v, tq;
  int width_in_blocks, height_in_blocks;
  int bx, by;  // allocated block grid (iMCU-padded)
  int dc_tbl, ac_tbl;
  std::vector<int16_t> coef;  // [by][bx][64], natural order
  int16_t* block(int row, int col) {
    return coef.data() + (static_cast<size_t>(row) * bx + col) * 64;
  }
};

// the next marker at or after p: its 0xFF, or nullptr
const uint8_t* find_marker(const uint8_t* p, const uint8_t* end) {
  for (; p + 1 < end; ++p)
    if (p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF) return p;
  return nullptr;
}

struct Decoder {
  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {}

  const uint8_t* data;
  size_t len;
  uint16_t qt[4][64] = {};  // natural order
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  Component comp[4];
  int ncomp = 0;
  int width = 0, height = 0;
  int max_h = 1, max_v = 1;
  int mcus_x = 0, mcus_y = 0;
  bool progressive = false;
  bool frame = false;
  int restart_interval = 0;
  bool corrupt = false;
  int scans = 0;

  // scan state
  Component* sc[4] = {};
  int nsc = 0;
  int ss = 0, se = 63, ah = 0, al = 0;
  int pred[4] = {};
  int eobrun = 0;

  int decode_sym(Bits& b, const Huff& h) {
    const unsigned look = b.peek(16);
    const int e = h.look[look >> (16 - kLookBits)];
    if (e >> 8) {
      b.skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      const int c = static_cast<int>(look >> (16 - l));
      if (c <= h.maxcode[l]) {
        b.skip(l);
        return h.vals[(c + h.valoffset[l]) & 0xFF];
      }
    }
    corrupt = true;
    b.skip(16);
    return 0;
  }

  int parse_sof(const uint8_t* s, int n, int marker) {
    if (frame) return kCorrupt;
    if (n < 6) return kCorrupt;
    if (s[0] != 8) return kPrecision;
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    ncomp = s[5];
    if (height == 0 || width == 0 || ncomp < 1 || ncomp > 4 ||
        n < 6 + 3 * ncomp)
      return kCorrupt;
    progressive = marker == 0xC2;
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.id = s[6 + 3 * c];
      k.h = s[7 + 3 * c] >> 4;
      k.v = s[7 + 3 * c] & 15;
      k.tq = s[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        return kCorrupt;
      if (k.h > max_h) max_h = k.h;
      if (k.v > max_v) max_v = k.v;
    }
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.width_in_blocks = (width * k.h + 8 * max_h - 1) / (8 * max_h);
      k.height_in_blocks = (height * k.v + 8 * max_v - 1) / (8 * max_v);
      k.bx = mcus_x * k.h;
      k.by = mcus_y * k.v;
    }
    frame = true;
    return kOk;
  }

  // 0 grey, 1 4:4:4, 2 4:2:0, else -1 (rir_decoder.cc subsamp_code)
  int subsamp() const {
    if (ncomp == 1) return 0;
    if (ncomp != 3) return -1;
    if (comp[1].h != 1 || comp[1].v != 1 || comp[2].h != 1 ||
        comp[2].v != 1)
      return -1;
    if (comp[0].h == 2 && comp[0].v == 2) return 2;
    if (comp[0].h == 1 && comp[0].v == 1) return 1;
    return -1;
  }

  int parse_dqt(const uint8_t* s, int n) {
    int i = 0;
    while (i < n) {
      const int pq = s[i] >> 4, tq = s[i] & 15;
      ++i;
      if (tq > 3 || pq > 1 || i + 64 * (pq + 1) > n) return kCorrupt;
      for (int z = 0; z < 64; ++z) {
        qt[tq][kNatural[z]] =
            pq ? static_cast<uint16_t>((s[i + 2 * z] << 8) | s[i + 2 * z + 1])
               : s[i + z];
      }
      qt_defined[tq] = true;
      i += 64 * (pq + 1);
    }
    return kOk;
  }

  int parse_dht(const uint8_t* s, int n) {
    int i = 0;
    while (i < n) {
      if (i + 17 > n) return kCorrupt;
      const int tc = s[i] >> 4, th = s[i] & 15;
      if (tc > 1 || th > 3) return kCorrupt;
      int count = 0;
      for (int l = 0; l < 16; ++l) count += s[i + 1 + l];
      if (i + 17 + count > n) return kCorrupt;
      Huff* h = tc ? &ac[th] : &dc[th];
      if (!build_huff(h, s + i + 1, s + i + 17)) return kCorrupt;
      i += 17 + count;
    }
    return kOk;
  }

  int parse_sos(const uint8_t* s, int n) {
    if (!frame || n < 1) return kCorrupt;
    nsc = s[0];
    if (nsc < 1 || nsc > 4 || n < 4 + 2 * nsc) return kCorrupt;
    for (int i = 0; i < nsc; ++i) {
      const int id = s[1 + 2 * i];
      Component* k = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) k = &comp[c];
      if (k == nullptr) return kCorrupt;
      k->dc_tbl = s[2 + 2 * i] >> 4;
      k->ac_tbl = s[2 + 2 * i] & 15;
      if (k->dc_tbl > 3 || k->ac_tbl > 3) return kCorrupt;
      sc[i] = k;
    }
    ss = s[1 + 2 * nsc];
    se = s[2 + 2 * nsc];
    ah = s[3 + 2 * nsc] >> 4;
    al = s[3 + 2 * nsc] & 15;
    if (progressive) {
      if (ss > se || se > 63 || (ss == 0 && se != 0) ||
          (ss > 0 && nsc != 1) || al > 13)
        return kCorrupt;
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    for (int i = 0; i < nsc; ++i) {
      const bool need_dc = !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !progressive ? true : ss > 0;
      if (need_dc && !dc[sc[i]->dc_tbl].defined) return kCorrupt;
      if (need_ac && !ac[sc[i]->ac_tbl].defined) return kCorrupt;
    }
    return kOk;
  }

  void decode_block(Bits& b, Component* k, int ci, int16_t* blk) {
    if (!progressive) {
      const int s = decode_sym(b, dc[k->dc_tbl]);
      if (s > 16) {
        corrupt = true;
        return;
      }
      pred[ci] += extend(b.get(s), s);
      blk[0] = static_cast<int16_t>(pred[ci]);
      const Huff& h = ac[k->ac_tbl];
      for (int z = 1; z < 64; ++z) {
        const int rs = decode_sym(b, h);
        const int r = rs >> 4, sz = rs & 15;
        if (sz) {
          z += r;
          blk[kNatural[z]] = static_cast<int16_t>(extend(b.get(sz), sz));
        } else {
          if (r != 15) break;
          z += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans
      if (ah == 0) {
        const int s = decode_sym(b, dc[k->dc_tbl]);
        if (s > 16) {
          corrupt = true;
          return;
        }
        pred[ci] += extend(b.get(s), s);
        blk[0] = static_cast<int16_t>(static_cast<unsigned>(pred[ci]) << al);
      } else if (b.get(1)) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }
      return;
    }
    const Huff& h = ac[k->ac_tbl];
    if (ah == 0) {  // AC first pass
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int z = ss; z <= se; ++z) {
        const int rs = decode_sym(b, h);
        const int r = rs >> 4, s = rs & 15;
        if (s) {
          z += r;
          blk[kNatural[z]] = static_cast<int16_t>(
              static_cast<unsigned>(extend(b.get(s), s)) << al);
        } else if (r == 15) {
          z += 15;
        } else {
          eobrun = (1 << r) - 1;
          if (r) eobrun += b.get(r);
          break;
        }
      }
      return;
    }
    // AC refinement (libjpeg jdphuff.c decode_mcu_AC_refine)
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int z = ss;
    if (eobrun == 0) {
      for (; z <= se; ++z) {
        const int rs = decode_sym(b, h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) corrupt = true;
          s = b.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += b.get(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[z];
          if (*c != 0) {
            if (b.get(1) && (*c & p1) == 0)
              *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
          } else if (--r < 0) {
            break;
          }
          ++z;
        } while (z <= se);
        if (s) blk[kNatural[z]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; z <= se; ++z) {
        int16_t* c = blk + kNatural[z];
        if (*c != 0 && b.get(1) && (*c & p1) == 0)
          *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
      }
      --eobrun;
    }
  }

  // decode the scan whose data starts at p; returns where it ended (the
  // next marker) or nullptr when the data ran out
  const uint8_t* decode_scan(const uint8_t* p, const uint8_t* end) {
    for (int i = 0; i < nsc; ++i) {
      Component* k = sc[i];
      if (k->coef.empty())
        k->coef.assign(static_cast<size_t>(k->bx) * k->by * 64, 0);
    }
    Bits b{p, end};
    for (int i = 0; i < 4; ++i) pred[i] = 0;
    eobrun = 0;
    // one component: its blocks in raster order, no MCU padding;
    // interleaved: MCUs of h x v blocks of each component
    const bool single = nsc == 1;
    const int nx = single ? sc[0]->width_in_blocks : mcus_x;
    const int ny = single ? sc[0]->height_in_blocks : mcus_y;
    const long total = static_cast<long>(nx) * ny;
    long todo = restart_interval;
    for (long m = 0; m < total; ++m) {
      if (restart_interval && todo == 0) {
        b.reset();
        const uint8_t* q = find_marker(b.p, end);
        if (q == nullptr) return nullptr;
        if (q[1] < 0xD0 || q[1] > 0xD7) {
          corrupt = true;
          return q;
        }
        b.p = q + 2;
        for (int i = 0; i < 4; ++i) pred[i] = 0;
        eobrun = 0;
        todo = restart_interval;
      }
      const int my = static_cast<int>(m / nx), mx = static_cast<int>(m % nx);
      if (single) {
        decode_block(b, sc[0], 0, sc[0]->block(my, mx));
      } else {
        for (int i = 0; i < nsc; ++i) {
          Component* k = sc[i];
          for (int yy = 0; yy < k->v; ++yy)
            for (int xx = 0; xx < k->h; ++xx)
              decode_block(b, k, i,
                           k->block(my * k->v + yy, mx * k->h + xx));
        }
      }
      if (corrupt) return nullptr;
      if (restart_interval) --todo;
    }
    return find_marker(b.p, end);
  }

  // headers_only: stop at the first SOS (dims); else decode every scan
  int run(bool headers_only) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    if (len < 4 || p[0] != 0xFF || p[1] != 0xD8) return kNotJpeg;
    p += 2;
    while (true) {
      const uint8_t* q = find_marker(p, end);
      if (q == nullptr) return kTruncated;
      const int marker = q[1];
      p = q + 2;
      if (marker == 0xD9) break;  // EOI
      if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
      if (p + 2 > end) return kTruncated;
      const int seglen = (p[0] << 8) | p[1];
      if (seglen < 2) return kCorrupt;
      if (p + seglen > end) return kTruncated;
      const uint8_t* s = p + 2;
      const int n = seglen - 2;
      p += seglen;
      int rc = kOk;
      switch (marker) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          rc = parse_sof(s, n, marker);
          if (rc == kOk && subsamp() < 0) rc = kLayout;
          break;
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
          rc = kLossless;  // lossless and hierarchical frames
          break;
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          rc = kArithmetic;
          break;
        case 0xC4:
          rc = parse_dht(s, n);
          break;
        case 0xDB:
          rc = parse_dqt(s, n);
          break;
        case 0xDD:
          if (n < 2) return kCorrupt;
          restart_interval = (s[0] << 8) | s[1];
          break;
        case 0xDA:
          if (!frame) return kCorrupt;
          if (headers_only) return kOk;
          rc = parse_sos(s, n);
          if (rc != kOk) return rc;
          p = decode_scan(p, end);
          ++scans;
          if (corrupt) return kCorrupt;
          if (p == nullptr) return kTruncated;
          break;
        default:  // APPn, COM, DAC, DNL and others: skipped
          break;
      }
      if (rc != kOk) return rc;
    }
    if (!frame || (!headers_only && scans == 0)) return kCorrupt;
    return kOk;
  }

  // iMCU-padded output grid of rir_decoder.cc: luma blocks, chroma blocks
  void grid(int ss_code, int* by, int* bx, int* cby, int* cbx) const {
    const int unit = ss_code == 2 ? 16 : 8, mul = ss_code == 2 ? 2 : 1;
    *by = (height + unit - 1) / unit * mul;
    *bx = (width + unit - 1) / unit * mul;
    *cby = ss_code == 0 ? 0 : (ss_code == 2 ? *by / 2 : *by);
    *cbx = ss_code == 0 ? 0 : (ss_code == 2 ? *bx / 2 : *bx);
  }
};

}  // namespace

extern "C" {

// Dims of the coefficient layout: h, w, luma blocks by / bx, chroma
// blocks cby / cbx (0 for grey) and the subsampling code (0 grey, 1
// 4:4:4, 2 4:2:0).  Reads the headers up to the first scan.  0 on
// success; negative for a file this decoder refuses or cannot read.
int rir_coeff_dims(const uint8_t* data, size_t len, int* h, int* w, int* by,
                   int* bx, int* cby, int* cbx, int* subsamp) {
  Decoder d(data, len);
  const int rc = d.run(true);
  if (rc != kOk) return rc;
  if (d.ncomp == 3 && d.comp[1].tq != d.comp[2].tq) return kChromaTables;
  *h = d.height;
  *w = d.width;
  *subsamp = d.subsamp();
  d.grid(*subsamp, by, bx, cby, cbx);
  return kOk;
}

// Entropy-decode the file and write the top-left k x k of every block's
// quantized coefficients (natural order) on the iMCU-padded grid of
// rir_coeff_dims: coef_y [by, bx, k, k], coef_c [2, cby, cbx, k, k]
// (untouched for grey); blocks past a component's own extent in blocks
// (the scans' MCU padding) are written as zeros.  quant_y / quant_c get
// the k x k dequantization tables of luma and chroma (quant_c untouched
// for grey).  Capacities are in bytes.
int rir_coeffs(const uint8_t* data, size_t len, int k, int16_t* coef_y,
               long cap_y, int16_t* coef_c, long cap_c, float* quant_y,
               float* quant_c, int* out_h, int* out_w, int* out_by,
               int* out_bx, int* out_cby, int* out_cbx, int* out_subsamp) {
  if (k < 1 || k > 8) return kLayout;
  Decoder d(data, len);
  const int rc = d.run(false);
  if (rc != kOk) return rc;
  const int ss_code = d.subsamp();
  if (d.ncomp == 3 && d.comp[1].tq != d.comp[2].tq) return kChromaTables;
  int want_by[3], want_bx[3];
  d.grid(ss_code, &want_by[0], &want_bx[0], &want_by[1], &want_bx[1]);
  want_by[2] = want_by[1];
  want_bx[2] = want_bx[1];
  const long need_y = static_cast<long>(want_by[0]) * want_bx[0] * k * k;
  const long need_c =
      d.ncomp == 3 ? 2L * want_by[1] * want_bx[1] * k * k : 0;
  if (need_y * 2 > cap_y || need_c * 2 > cap_c) return kCapacity;
  for (int c = 0; c < d.ncomp; ++c) {
    Component& comp = d.comp[c];
    if (!d.qt_defined[comp.tq]) return kCorrupt;
    if (c < 2) {
      float* q = c == 0 ? quant_y : quant_c;
      for (int r = 0; r < k; ++r)
        for (int cc = 0; cc < k; ++cc)
          q[r * k + cc] = static_cast<float>(d.qt[comp.tq][r * 8 + cc]);
    }
    int16_t* out =
        c == 0 ? coef_y
               : coef_c + (c - 1) * static_cast<long>(want_by[1]) *
                              want_bx[1] * k * k;
    for (int row = 0; row < want_by[c]; ++row) {
      for (int col = 0; col < want_bx[c]; ++col) {
        int16_t* dst =
            out + (static_cast<long>(row) * want_bx[c] + col) * k * k;
        if (row < comp.height_in_blocks && col < comp.width_in_blocks &&
            !comp.coef.empty()) {
          const int16_t* blk = comp.block(row, col);
          for (int r = 0; r < k; ++r)
            memcpy(dst + r * k, blk + r * 8, sizeof(int16_t) * k);
        } else {
          memset(dst, 0, sizeof(int16_t) * k * k);
        }
      }
    }
  }
  *out_h = d.height;
  *out_w = d.width;
  *out_by = want_by[0];
  *out_bx = want_bx[0];
  *out_cby = d.ncomp == 3 ? want_by[1] : 0;
  *out_cbx = d.ncomp == 3 ? want_bx[1] : 0;
  *out_subsamp = ss_code;
  return kOk;
}

}  // extern "C"
