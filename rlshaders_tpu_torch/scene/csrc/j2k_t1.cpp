// JPEG 2000 tier-1 (EBCOT) decoding of code-blocks, as OpenJPEG 2.5 does.
//
// The native counterpart of scene/j2k_t1.py::decode_block, step for step:
// the MQ decoder over the block's bytes with an artificial 0xFF 0xFF at
// their end, then the cleanup, significance and refinement passes over
// stripes of four rows (code-block style 0). Integer only, so no compiler
// flag changes a result.
//
// rls_j2k_t1(data, table, n, out): row i of `table` (8 int32) is a block:
// where its bytes start in `data` and their length, its width, height,
// orientation (0 LL, 1 HL, 2 LH, 3 HH), top bit-plane (counted from 1),
// pass count, and where its w * h coefficients go in `out`. Returns 0.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const uint16_t QE[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
    0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
    0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
    0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t NMPS[47] = {
    1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t NLPS[47] = {
    1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
    15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t SWITCH[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1};
const int MAG = 14, RUN = 17, UNI = 18;

struct MQ {
  const uint8_t* buf;  // the block's bytes, then 0xFF 0xFF
  size_t bp;
  uint32_t a, c;
  int ct;
  uint8_t st[19], mps[19];

  explicit MQ(const uint8_t* b) : buf(b), bp(0) {
    c = static_cast<uint32_t>(buf[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
    std::memset(st, 0, sizeof st);
    std::memset(mps, 0, sizeof mps);
    st[UNI] = 46;
    st[RUN] = 3;
    st[0] = 4;
  }
  void bytein() {
    uint32_t nxt = buf[bp + 1];
    if (buf[bp] == 0xFF) {
      if (nxt > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += nxt << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += nxt << 8;
      ct = 8;
    }
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    int s = st[cx];
    uint32_t qe = QE[s];
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = mps[cx];
        st[cx] = NMPS[s];
      } else {
        d = 1 - mps[cx];
        mps[cx] ^= SWITCH[s];
        st[cx] = NLPS[s];
      }
      a = qe;
      renorm();
      return d;
    }
    c -= qe << 16;
    if (a & 0x8000) return mps[cx];
    if (a < qe) {
      d = 1 - mps[cx];
      mps[cx] ^= SWITCH[s];
      st[cx] = NLPS[s];
    } else {
      d = mps[cx];
      st[cx] = NMPS[s];
    }
    renorm();
    return d;
  }
};

int zc_context(int h, int v, int d, int orient) {
  if (orient == 3) {
    int hv = h + v;
    if (d >= 3) return 8;
    if (d == 2) return hv ? 7 : 6;
    if (d == 1) return hv >= 2 ? 5 : 3 + hv;
    return hv < 2 ? hv : 2;
  }
  if (orient == 1) {
    int t = h;
    h = v;
    v = t;
  }
  if (h == 2) return 8;
  if (h == 1) return v ? 7 : (d ? 6 : 5);
  if (v) return 2 + v;
  return d < 2 ? d : 2;
}

// (horizontal + 1) * 3 + (vertical + 1) -> context and xor bit
const int SC_CX[9] = {13, 12, 11, 10, 9, 10, 11, 12, 13};
const int SC_XOR[9] = {1, 1, 1, 1, 0, 0, 0, 0, 0};

struct Block {
  int w, h, orient, stride;
  std::vector<uint8_t> sig, neg, vis, ref;
  int32_t* val;
  MQ* mq;

  int at(int y, int x) const { return y * stride + x; }
  int context(int y, int x) const {
    const uint8_t* s = sig.data();
    int i = at(y, x);
    int hh = s[i - 1] + s[i + 1];
    int vv = s[i - stride] + s[i + stride];
    int dd = s[i - stride - 1] + s[i - stride + 1] + s[i + stride - 1] +
             s[i + stride + 1];
    return zc_context(hh, vv, dd, orient);
  }
  int contribution(int i) const { return !sig[i] ? 0 : (neg[i] ? -1 : 1); }
  void significant(int y, int x, int32_t one) {
    int i = at(y, x);
    int hc = contribution(i - 1) + contribution(i + 1);
    int vc = contribution(i - stride) + contribution(i + stride);
    hc = hc < -1 ? -1 : (hc > 1 ? 1 : hc);
    vc = vc < -1 ? -1 : (vc > 1 ? 1 : vc);
    int k = (hc + 1) * 3 + (vc + 1);
    int s = mq->decode(SC_CX[k]) ^ SC_XOR[k];
    val[(y - 1) * w + (x - 1)] = s ? -one : one;
    sig[i] = 1;
    neg[i] = static_cast<uint8_t>(s);
  }
};

void decode_block(const uint8_t* data, int len, int w, int h, int orient,
                  int numbps, int passes, int32_t* out) {
  std::memset(out, 0, sizeof(int32_t) * w * h);
  if (numbps < 1 || passes < 1 || w <= 0 || h <= 0) return;
  std::vector<uint8_t> buf(data, data + len);
  buf.push_back(0xFF);
  buf.push_back(0xFF);
  MQ mq(buf.data());
  Block b;
  b.w = w;
  b.h = h;
  b.orient = orient;
  b.stride = w + 2;
  size_t cells = static_cast<size_t>(h + 2) * (w + 2);
  b.sig.assign(cells, 0);
  b.neg.assign(cells, 0);
  b.vis.assign(cells, 0);
  b.ref.assign(cells, 0);
  b.val = out;
  b.mq = &mq;
  int kind = 2, plane = numbps;
  for (int p = 0; p < passes && plane >= 1; ++p) {
    int32_t one = (1 << plane) | ((1 << plane) >> 1);
    for (int y0 = 1; y0 <= h; y0 += 4) {
      int y1 = y0 + 4 < h + 1 ? y0 + 4 : h + 1;
      for (int x = 1; x <= w; ++x) {
        if (kind == 0) {  // significance propagation
          for (int y = y0; y < y1; ++y) {
            int i = b.at(y, x);
            if (b.sig[i]) continue;
            int cx = b.context(y, x);
            if (cx) {
              if (mq.decode(cx)) b.significant(y, x, one);
              b.vis[i] = 1;
            }
          }
        } else if (kind == 1) {  // magnitude refinement
          int32_t half = (1 << plane) >> 1;
          for (int y = y0; y < y1; ++y) {
            int i = b.at(y, x);
            if (!b.sig[i] || b.vis[i]) continue;
            int cx = MAG + (b.ref[i] ? 2 : (b.context(y, x) > 0 ? 1 : 0));
            int v = mq.decode(cx);
            int32_t& cur = out[(y - 1) * w + (x - 1)];
            cur += (v ^ (cur < 0)) ? half : -half;
            b.ref[i] = 1;
          }
        } else {  // cleanup
          int y = y0;
          if (y0 + 3 <= h) {
            bool run = true;
            for (int yy = y0; yy < y0 + 4 && run; ++yy) {
              int i = b.at(yy, x);
              if (b.sig[i] || b.vis[i] || b.context(yy, x)) run = false;
            }
            if (run) {
              if (!mq.decode(RUN)) continue;
              int r = mq.decode(UNI) << 1;
              r |= mq.decode(UNI);
              y = y0 + r;
              b.significant(y, x, one);
              ++y;
            }
          }
          for (int yy = y; yy < y1; ++yy) {
            int i = b.at(yy, x);
            if (b.sig[i] || b.vis[i]) continue;
            if (mq.decode(b.context(yy, x))) b.significant(yy, x, one);
          }
        }
      }
    }
    if (kind == 2) std::memset(b.vis.data(), 0, cells);
    if (++kind == 3) {
      kind = 0;
      --plane;
    }
  }
}

}  // namespace

extern "C" int rls_j2k_t1(const char* data, const int32_t* table, int n,
                          int32_t* out) {
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(data);
  for (int k = 0; k < n; ++k) {
    const int32_t* r = table + 8 * k;
    decode_block(bytes + r[0], r[1], r[2], r[3], r[4], r[5], r[6],
                 out + r[7]);
  }
  return 0;
}
