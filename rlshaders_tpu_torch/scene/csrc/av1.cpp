// AV1 intra-frame tile decoding for still AVIF images, as dav1d decodes
// them: the symbol decoder and CDF adaptation, partitions, intra mode info
// (segment ids, skip, CDEF index, delta q and lf, y and uv modes with angle
// deltas, CFL, palette with its colour cache, filter intra, intra block
// copy), transform sizes and types, coefficients, dequantization, the
// inverse transforms, intra prediction and the three in-loop filters
// (deblocking, CDEF, loop restoration). Section numbers refer to the AV1
// bitstream specification. 8-bit samples only; av1.py parses the headers
// and hands the frame's parameters over as `FrameHeader`.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

#include "av1_tables.h"

namespace {

// ---------------------------------------------------------------------------
// constants
// ---------------------------------------------------------------------------
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
       D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
       PAETH_PRED, UV_CFL_PRED };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
       PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A,
       PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4 };
enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8,
       BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64,
       BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128,
       BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64,
       BLOCK_64X16, BLOCK_INVALID };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4,
       TX_8X16, TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16,
       TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16 };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
       FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
       V_ADST, H_ADST, V_FLIPADST, H_FLIPADST };
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

const int BW[22] = {4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64, 128,
                    128, 4, 16, 8, 32, 16, 64};
const int BH[22] = {4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128, 64,
                    128, 16, 4, 32, 8, 64, 16};
const int TXW[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8,
                     32, 16, 64};
const int TXH[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32,
                     8, 64, 16};
const int SPLIT_TX[19] = {TX_4X4, TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_4X4,
                          TX_4X4, TX_8X8, TX_8X8, TX_16X16, TX_16X16,
                          TX_32X32, TX_32X32, TX_4X8, TX_8X4, TX_8X16,
                          TX_16X8, TX_16X32, TX_32X16};
const int MAX_TX_RECT[22] = {TX_4X4, TX_4X8, TX_8X4, TX_8X8, TX_8X16,
                             TX_16X8, TX_16X16, TX_16X32, TX_32X16, TX_32X32,
                             TX_32X64, TX_64X32, TX_64X64, TX_64X64,
                             TX_64X64, TX_64X64, TX_4X16, TX_16X4, TX_8X32,
                             TX_32X8, TX_16X64, TX_64X16};
const int MODE_TO_TXFM[14] = {DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT,
                              ADST_ADST, ADST_DCT, DCT_ADST, DCT_ADST,
                              ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
                              ADST_ADST, DCT_DCT};
const int INTRA_MODE_CONTEXT[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const int TX_SET1_INV[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT,
                            DCT_ADST};
const int TX_SET2_INV[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
// libaom's av1_ext_tx_inv for the inter sets (intra block copy)
const int INTER_SET1_INV[16] = {IDTX, V_DCT, H_DCT, V_ADST, H_ADST,
                                V_FLIPADST, H_FLIPADST, DCT_DCT, ADST_DCT,
                                DCT_ADST, FLIPADST_DCT, DCT_FLIPADST,
                                ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST,
                                FLIPADST_ADST};
const int INTER_SET2_INV[12] = {IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT,
                                DCT_ADST, FLIPADST_DCT, DCT_FLIPADST,
                                ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST,
                                FLIPADST_ADST};
const int FILTER_INTRA_DIR[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED,
                                 DC_PRED};
const int ROW_SHIFT[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2,
                           2, 2};
const int SIG_REF[3][5][2] = {{{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
                              {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
                              {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
const int MAG_REF[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}},
                              {{0, 1}, {1, 0}, {0, 2}},
                              {{0, 1}, {1, 0}, {2, 0}}};

int log2i(int x) { int n = 0; while ((1 << (n + 1)) <= x) n++; return n; }
int block_size(int w, int h) {
  for (int b = 0; b < 22; b++) if (BW[b] == w && BH[b] == h) return b;
  return BLOCK_INVALID;
}
int tx_size_of(int w, int h) {
  for (int t = 0; t < 19; t++) if (TXW[t] == w && TXH[t] == h) return t;
  return -1;
}
int sqr_up(int t) { int m = std::max(TXW[t], TXH[t]); return tx_size_of(m, m); }
int sqr(int t) { int m = std::min(TXW[t], TXH[t]); return tx_size_of(m, m); }
inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline int clip1(int v) { return clip3(0, 255, v); }
inline int round2(int64_t x, int n) {
  if (n == 0) return (int)x;
  return (int)((x + ((int64_t)1 << (n - 1))) >> n);
}
inline int round2signed(int64_t x, int n) {
  return x >= 0 ? round2(x, n) : -round2(-x, n);
}
int ceil_log2(int x) { if (x < 2) return 0; int i = 1, p = 2; while (p < x) { i++; p <<= 1; } return i; }

// ---------------------------------------------------------------------------
// frame parameters (av1.py FIELDS, in order)
// ---------------------------------------------------------------------------
struct FrameHeader {
  int32_t width, height, ss_x, ss_y, num_planes, use_128,
      enable_filter_intra, enable_intra_edge_filter, disable_cdf_update,
      allow_screen_content_tools, allow_intrabc, base_q_idx, dq_y_dc,
      dq_u_dc, dq_u_ac, dq_v_dc, dq_v_ac, qm_y, qm_u, qm_v, seg_enabled,
      seg_feature_enabled[64], seg_feature_data[64], seg_id_pre_skip,
      last_active_seg_id, delta_q_present, delta_q_res, delta_lf_present,
      delta_lf_res, delta_lf_multi, lf_level[4], lf_sharpness,
      lf_delta_enabled, lf_ref_deltas[8], lf_mode_deltas[2], cdef_damping,
      cdef_bits, cdef_y_pri[8], cdef_y_sec[8], cdef_uv_pri[8],
      cdef_uv_sec[8], lr_type[3], lr_size[3], tx_mode, reduced_tx_set,
      tile_cols, tile_rows, tile_cols_log2, tile_rows_log2,
      mi_col_starts[65], mi_row_starts[65], coded_lossless, all_lossless,
      matrix_coefficients;
  // film_grain_params (5.9.30), as dav1d keeps them
  int32_t apply_grain, grain_seed, num_y_points, y_points[14][2],
      chroma_scaling_from_luma, num_uv_points[2], uv_points[2][10][2],
      scaling_shift, ar_coeff_lag, ar_coeffs_y[24], ar_coeffs_uv[2][25],
      ar_coeff_shift, grain_scale_shift, uv_mult[2], uv_luma_mult[2],
      uv_offset[2], overlap_flag, clip_to_restricted_range;
};

// ---------------------------------------------------------------------------
// the tool census
// ---------------------------------------------------------------------------
enum {
  C_PART = 0,                   // 10 partition types
  C_YMODE = C_PART + 10,        // 13 y modes
  C_UVMODE = C_YMODE + 13,      // 14 uv modes
  C_ANGLE_DELTA = C_UVMODE + 14,  // non-zero angle deltas
  C_CFL, C_FILTER_INTRA, C_PALETTE_Y, C_PALETTE_UV, C_INTRABC,
  C_TXSIZE,                     // 19 tx sizes
  C_TXTYPE = C_TXSIZE + 19,     // 16 tx types
  C_LOSSLESS = C_TXTYPE + 16, C_SEGMENTATION, C_DELTA_Q, C_DELTA_LF,
  C_DEBLOCK, C_CDEF, C_WIENER, C_SGRPROJ, C_SWITCHABLE, C_TILES,
  C_COUNT
};
const char *census_name(int i) {
  static const char *part[10] = {"partition_none", "partition_horz",
      "partition_vert", "partition_split", "partition_horz_a",
      "partition_horz_b", "partition_vert_a", "partition_vert_b",
      "partition_horz_4", "partition_vert_4"};
  static const char *modes[14] = {"dc", "v", "h", "d45", "d135", "d113",
      "d157", "d203", "d67", "smooth", "smooth_v", "smooth_h", "paeth",
      "cfl"};
  static const char *txs[19] = {"4x4", "8x8", "16x16", "32x32", "64x64",
      "4x8", "8x4", "8x16", "16x8", "16x32", "32x16", "32x64", "64x32",
      "4x16", "16x4", "8x32", "32x8", "16x64", "64x16"};
  static const char *txt[16] = {"dct_dct", "adst_dct", "dct_adst",
      "adst_adst", "flipadst_dct", "dct_flipadst", "flipadst_flipadst",
      "adst_flipadst", "flipadst_adst", "idtx", "v_dct", "h_dct", "v_adst",
      "h_adst", "v_flipadst", "h_flipadst"};
  static const char *rest[] = {"angle_delta", "cfl", "filter_intra",
      "palette_y", "palette_uv", "intrabc"};
  static const char *tail[] = {"lossless", "segmentation", "delta_q",
      "delta_lf", "deblock", "cdef", "wiener", "sgrproj", "switchable",
      "tiles"};
  static char buf[64];
  if (i < C_YMODE) return part[i - C_PART];
  if (i < C_UVMODE) { snprintf(buf, sizeof buf, "y_%s", modes[i - C_YMODE]); return buf; }
  if (i < C_ANGLE_DELTA) { snprintf(buf, sizeof buf, "uv_%s", modes[i - C_UVMODE]); return buf; }
  if (i < C_TXSIZE) return rest[i - C_ANGLE_DELTA];
  if (i < C_TXTYPE) { snprintf(buf, sizeof buf, "tx_%s", txs[i - C_TXSIZE]); return buf; }
  if (i < C_LOSSLESS) { snprintf(buf, sizeof buf, "txtype_%s", txt[i - C_TXTYPE]); return buf; }
  return tail[i - C_LOSSLESS];
}

// ---------------------------------------------------------------------------
// CDFs (spec form: cumulative values ending in 32768, then a counter)
// ---------------------------------------------------------------------------
struct Cdfs {
  uint16_t kf_y[5][5][14];
  uint16_t angle_delta[8][8];
  uint16_t uv_mode[2][13][15];
  uint16_t partition[20][11];
  uint16_t tx1[4][13][8];
  uint16_t tx2[4][13][6];
  uint16_t cfl_sign[9];
  uint16_t cfl_alpha[6][17];
  uint16_t tx8[3][3];
  uint16_t txsz[3][3][4];
  uint16_t filter_intra[22][3];
  uint16_t filter_intra_mode[6];
  uint16_t pal_y_size[7][8], pal_uv_size[7][8];
  uint16_t pal_y_color[7][5][9], pal_uv_color[7][5][9];
  uint16_t pal_y_mode[7][3][3], pal_uv_mode[2][3];
  uint16_t intrabc[3];
  uint16_t delta_q[5], delta_lf[5], delta_lf_multi[4][5];
  uint16_t skip[3][3];
  uint16_t seg_id[3][9];
  uint16_t restoration_type[4], use_wiener[3], use_sgrproj[3];
  uint16_t mv_joint[5], mv_class[2][12], mv_class0[2][3], mv_bit[2][10][3],
      mv_sign[2][3];
  uint16_t inter_tx1[4][17], inter_tx2[4][13], inter_tx3[4][3];
  uint16_t txfm_split[21][3];
  uint16_t txb_skip[5][13][3];
  uint16_t eob_extra[5][2][9][3];
  uint16_t dc_sign[2][3][3];
  uint16_t eob16[2][2][6], eob32[2][2][7], eob64[2][2][8], eob128[2][2][9],
      eob256[2][2][10], eob512[2][2][11], eob1024[2][2][12];
  uint16_t base_eob[5][2][4][4];
  uint16_t base[5][2][42][5];
  uint16_t br[5][2][21][5];
};

#define CP(dst, src) memcpy(dst, src, sizeof(dst))
void init_cdfs(Cdfs &c, int base_q_idx) {
  CP(c.kf_y, AV1_KF_Y_MODE_CDF);
  CP(c.angle_delta, AV1_ANGLE_DELTA_CDF);
  CP(c.uv_mode, AV1_UV_MODE_CDF);
  CP(c.partition, AV1_PARTITION_CDF);
  CP(c.tx1, AV1_INTRA_TX_SET1_CDF);
  CP(c.tx2, AV1_INTRA_TX_SET2_CDF);
  CP(c.cfl_sign, AV1_CFL_SIGN_CDF);
  CP(c.cfl_alpha, AV1_CFL_ALPHA_CDF);
  CP(c.tx8, AV1_TX_8X8_CDF);
  CP(c.txsz, AV1_TX_SIZE_CDF);
  CP(c.filter_intra, AV1_FILTER_INTRA_CDF);
  CP(c.filter_intra_mode, AV1_FILTER_INTRA_MODE_CDF);
  CP(c.pal_y_size, AV1_PALETTE_Y_SIZE_CDF);
  CP(c.pal_uv_size, AV1_PALETTE_UV_SIZE_CDF);
  CP(c.pal_y_color, AV1_PALETTE_Y_COLOR_CDF);
  CP(c.pal_uv_color, AV1_PALETTE_UV_COLOR_CDF);
  CP(c.pal_y_mode, AV1_PALETTE_Y_MODE_CDF);
  CP(c.pal_uv_mode, AV1_PALETTE_UV_MODE_CDF);
  CP(c.intrabc, AV1_INTRABC_CDF);
  CP(c.inter_tx1, AV1_INTER_TX_SET1_CDF);
  CP(c.inter_tx2, AV1_INTER_TX_SET2_CDF);
  CP(c.inter_tx3, AV1_INTER_TX_SET3_CDF);
  CP(c.txfm_split, AV1_TXFM_SPLIT_CDF);
  CP(c.delta_q, AV1_DELTA_LF_MULTI_CDF[0]);
  CP(c.delta_lf, AV1_DELTA_LF_MULTI_CDF[0]);
  CP(c.delta_lf_multi, AV1_DELTA_LF_MULTI_CDF);
  CP(c.skip, AV1_SKIP_CDF);
  CP(c.seg_id, AV1_SEGMENT_ID_CDF);
  CP(c.restoration_type, AV1_RESTORATION_TYPE_CDF);
  CP(c.use_wiener, AV1_USE_WIENER_CDF);
  CP(c.use_sgrproj, AV1_USE_SGRPROJ_CDF);
  CP(c.mv_joint, AV1_MV_JOINT_CDF);
  CP(c.mv_class, AV1_MV_CLASS_CDF);
  CP(c.mv_class0, AV1_MV_CLASS0_CDF);
  CP(c.mv_bit, AV1_MV_BIT_CDF);
  CP(c.mv_sign, AV1_MV_SIGN_CDF);
  int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
  CP(c.txb_skip, AV1_TXB_SKIP_CDF[q]);
  CP(c.eob_extra, AV1_EOB_EXTRA_CDF[q]);
  CP(c.dc_sign, AV1_DC_SIGN_CDF[q]);
  CP(c.eob16, AV1_EOB_PT_16_CDF[q]);
  CP(c.eob32, AV1_EOB_PT_32_CDF[q]);
  CP(c.eob64, AV1_EOB_PT_64_CDF[q]);
  CP(c.eob128, AV1_EOB_PT_128_CDF[q]);
  CP(c.eob256, AV1_EOB_PT_256_CDF[q]);
  CP(c.eob512, AV1_EOB_PT_512_CDF[q]);
  CP(c.eob1024, AV1_EOB_PT_1024_CDF[q]);
  CP(c.base_eob, AV1_COEFF_BASE_EOB_CDF[q]);
  CP(c.base, AV1_COEFF_BASE_CDF[q]);
  CP(c.br, AV1_COEFF_BR_CDF[q]);
}

// ---------------------------------------------------------------------------
// the symbol decoder (8.2)
// ---------------------------------------------------------------------------
struct SymbolDecoder {
  const uint8_t *buf;
  int64_t bitpos, endbit;
  uint32_t value, range;
  int64_t maxbits;
  bool update;

  int bit() {
    if (bitpos >= endbit) { bitpos++; return 0; }
    int b = (buf[bitpos >> 3] >> (7 - (bitpos & 7))) & 1;
    bitpos++;
    return b;
  }
  uint32_t bits(int n) { uint32_t x = 0; for (int i = 0; i < n; i++) x = (x << 1) | bit(); return x; }

  void init(const uint8_t *data, int sz, bool disable_update) {
    buf = data; bitpos = 0; endbit = (int64_t)sz * 8;
    int nb = std::min(sz * 8, 15);
    uint32_t b = bits(nb);
    uint32_t padded = b << (15 - nb);
    value = ((1u << 15) - 1) ^ padded;
    range = 1u << 15;
    maxbits = (int64_t)8 * sz - 15;
    update = !disable_update;
  }
  void renorm(uint32_t newrange) {
    int b = 15 - log2i((int)newrange);
    range = newrange << b;
    int nb = (int)std::min<int64_t>(b, std::max<int64_t>(0, maxbits));
    uint32_t nd = bits(nb);
    uint32_t pd = nd << (b - nb);
    value = pd ^ (((value + 1) << b) - 1);
    maxbits -= b;
  }
  int symbol(uint16_t *cdf, int n) {
    uint32_t cur = range, prev;
    int s = -1;
    do {
      s++;
      prev = cur;
      uint32_t f = (1u << 15) - cdf[s];
      cur = ((range >> 8) * (f >> 6) >> 1) + 4 * (uint32_t)(n - s - 1);
    } while (value < cur);
    uint32_t nr = prev - cur;
    value -= cur;
    renorm(nr);
    if (update) {
      int rate = 3 + (cdf[n] > 15) + (cdf[n] > 31) + std::min(log2i(n), 2);
      uint32_t tmp = 0;
      for (int i = 0; i < n - 1; i++) {
        tmp = (i == s) ? (1u << 15) : tmp;
        if (tmp < cdf[i]) cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
        else cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
      }
      cdf[n] += (cdf[n] < 32);
    }
    return s;
  }
  int boolean() {
    uint16_t cdf[3] = {1 << 14, 1 << 15, 0};
    bool u = update;
    update = false;
    int b = symbol(cdf, 2);
    update = u;
    return b;
  }
  int literal(int n) { int x = 0; for (int i = 0; i < n; i++) x = 2 * x + boolean(); return x; }
  int ns(int n) {
    int w = log2i(n) + 1;
    int m = (1 << w) - n;
    int v = literal(w - 1);
    if (v < m) return v;
    return (v << 1) - m + literal(1);
  }
  // dav1d's read_golomb
  unsigned golomb() {
    int len = 0;
    unsigned val = 1;
    while (!boolean() && len < 32) len++;
    while (len--) val = (val << 1) + boolean();
    return val - 1;
  }
};

// ---------------------------------------------------------------------------
// inverse transforms (7.13.2), with dav1d's clamps of the sums
// ---------------------------------------------------------------------------
const int COSPI[65] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973, 3948,
    3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564, 3513, 3461,
    3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896, 2824, 2751, 2675,
    2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019, 1931, 1842, 1751, 1660,
    1567, 1474, 1380, 1285, 1189, 1092, 995, 897, 799, 700, 601, 501, 401,
    301, 201, 101, 0};
inline int32_t hb(int w0, int32_t a, int w1, int32_t b) {
  return (int32_t)(((int64_t)w0 * a + (int64_t)w1 * b + 2048) >> 12);
}
struct Clamp { int32_t lo, hi; int32_t operator()(int64_t v) const { return (int32_t)(v < lo ? lo : v > hi ? hi : v); } };
int brev(int nb, int x) { int r = 0; for (int i = 0; i < nb; i++) r = (r << 1) | ((x >> i) & 1); return r; }

void odd_part(int32_t *T, int b, int M, int N, const Clamp &cl) {
  int lgN = log2i(N);
  for (int k = 0; k < M / 2; k++) {
    int a = b + k, c = b + M - 1 - k;
    int th = brev(lgN, a) * 64 / N;
    int32_t x = T[a], y = T[c];
    T[a] = hb(COSPI[64 - th], x, -COSPI[th], y);
    T[c] = hb(COSPI[th], x, COSPI[64 - th], y);
  }
  for (int g = 1; g <= M / 4; g *= 2) {
    for (int k = 0; k < M / (2 * g); k++) {
      int s = b + k * 2 * g;
      for (int t = 0; t < g; t++) {
        int p = s + t, q = s + 2 * g - 1 - t;
        int32_t x = T[p], y = T[q];
        if (k % 2 == 0) { T[p] = cl((int64_t)x + y); T[q] = cl((int64_t)x - y); }
        else { T[p] = cl((int64_t)y - x); T[q] = cl((int64_t)x + y); }
      }
    }
    int Np = N / (4 * g), lg = log2i(Np);
    for (int x = 0; x < M / 2; x++) {
      int blk = x / (4 * g), r = x % (4 * g);
      if (r < g || r >= 3 * g) continue;
      int th = (64 / Np) * brev(lg, Np / 2 + blk);
      int p = b + x, q = b + M - 1 - x;
      int32_t u = T[p], v = T[q];
      if (r < 2 * g) { T[p] = hb(-COSPI[th], u, COSPI[64 - th], v); T[q] = hb(COSPI[64 - th], u, COSPI[th], v); }
      else { T[p] = hb(-COSPI[64 - th], u, -COSPI[th], v); T[q] = hb(-COSPI[th], u, COSPI[64 - th], v); }
    }
  }
}
void idct_rec(int32_t *T, int n, const Clamp &cl) {
  if (n == 2) {
    int32_t x = T[0], y = T[1];
    T[0] = hb(COSPI[32], x, COSPI[32], y);
    T[1] = hb(COSPI[32], x, -COSPI[32], y);
    return;
  }
  int M = n / 2;
  idct_rec(T, M, cl);
  odd_part(T, M, M, n, cl);
  for (int i = 0; i < M; i++) {
    int32_t e = T[i], o = T[n - 1 - i];
    T[i] = cl((int64_t)e + o);
    T[n - 1 - i] = cl((int64_t)e - o);
  }
}
void idct(int32_t *T, int lg, const Clamp &cl) {
  int n = 1 << lg;
  int32_t c[64];
  for (int i = 0; i < n; i++) c[i] = T[brev(lg, i)];
  idct_rec(c, n, cl);
  memcpy(T, c, n * sizeof(int32_t));
}
void iadst4(int32_t *X) {
  int64_t s0 = 1321LL * X[0], s1 = 2482LL * X[0], s2 = 3344LL * X[1],
          s3 = 3803LL * X[2], s4 = 1321LL * X[2], s5 = 2482LL * X[3],
          s6 = 3803LL * X[3];
  int64_t a7 = (int64_t)X[0] - X[2];
  int64_t b7 = a7 + X[3];
  s0 += s3; s1 -= s4; s3 = s2; s2 = 3344 * b7; s0 += s5; s1 -= s6;
  int64_t x0 = s0 + s3, x1 = s1 + s3, x2 = s2, x3 = s0 + s1 - s3;
  X[0] = round2(x0, 12); X[1] = round2(x1, 12); X[2] = round2(x2, 12); X[3] = round2(x3, 12);
}
void rot(int32_t *b, int i, int j, int w0, int w1, int w2, int w3) {
  int32_t x = b[i], y = b[j];
  b[i] = hb(w0, x, w1, y);
  b[j] = hb(w2, x, w3, y);
}
void iadst8(int32_t *X, const Clamp &cl) {
  const int *C = COSPI;
  int32_t b[8] = {X[7], X[0], X[5], X[2], X[3], X[4], X[1], X[6]};
  const int ang[4] = {4, 20, 36, 52};
  for (int k = 0; k < 4; k++) rot(b, 2 * k, 2 * k + 1, C[ang[k]], C[64 - ang[k]], C[64 - ang[k]], -C[ang[k]]);
  for (int i = 0; i < 4; i++) { int32_t x = b[i], y = b[i + 4]; b[i] = cl((int64_t)x + y); b[i + 4] = cl((int64_t)x - y); }
  rot(b, 4, 5, C[16], C[48], C[48], -C[16]);
  rot(b, 6, 7, -C[48], C[16], C[16], C[48]);
  const int ii[4] = {0, 1, 4, 5};
  for (int k = 0; k < 4; k++) { int i = ii[k]; int32_t x = b[i], y = b[i + 2]; b[i] = cl((int64_t)x + y); b[i + 2] = cl((int64_t)x - y); }
  rot(b, 2, 3, C[32], C[32], C[32], -C[32]);
  rot(b, 6, 7, C[32], C[32], C[32], -C[32]);
  X[0] = b[0]; X[1] = -b[4]; X[2] = b[6]; X[3] = -b[2]; X[4] = b[3]; X[5] = -b[7]; X[6] = b[5]; X[7] = -b[1];
}
void iadst16(int32_t *X, const Clamp &cl) {
  const int *C = COSPI;
  const int p[16] = {15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14};
  int32_t b[16];
  for (int i = 0; i < 16; i++) b[i] = X[p[i]];
  for (int k = 0; k < 8; k++) { int a = 2 + 8 * k; rot(b, 2 * k, 2 * k + 1, C[a], C[64 - a], C[64 - a], -C[a]); }
  for (int i = 0; i < 8; i++) { int32_t x = b[i], y = b[i + 8]; b[i] = cl((int64_t)x + y); b[i + 8] = cl((int64_t)x - y); }
  rot(b, 8, 9, C[8], C[56], C[56], -C[8]);
  rot(b, 10, 11, C[40], C[24], C[24], -C[40]);
  rot(b, 12, 13, -C[56], C[8], C[8], C[56]);
  rot(b, 14, 15, -C[24], C[40], C[40], C[24]);
  for (int base = 0; base < 16; base += 8)
    for (int i = 0; i < 4; i++) { int32_t x = b[base + i], y = b[base + i + 4]; b[base + i] = cl((int64_t)x + y); b[base + i + 4] = cl((int64_t)x - y); }
  for (int base = 0; base < 16; base += 8) {
    rot(b, base + 4, base + 5, C[16], C[48], C[48], -C[16]);
    rot(b, base + 6, base + 7, -C[48], C[16], C[16], C[48]);
  }
  const int ii[8] = {0, 1, 4, 5, 8, 9, 12, 13};
  for (int k = 0; k < 8; k++) { int i = ii[k]; int32_t x = b[i], y = b[i + 2]; b[i] = cl((int64_t)x + y); b[i + 2] = cl((int64_t)x - y); }
  for (int i = 2; i < 16; i += 4) rot(b, i, i + 1, C[32], C[32], C[32], -C[32]);
  const int o[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
  for (int i = 0; i < 16; i++) X[i] = (i & 1) ? -b[o[i]] : b[o[i]];
}
void iidentity(int32_t *T, int lg) {
  int n = 1 << lg;
  for (int i = 0; i < n; i++) {
    if (lg == 2) T[i] = round2((int64_t)T[i] * 5793, 12);
    else if (lg == 3) T[i] = T[i] * 2;
    else if (lg == 4) T[i] = round2((int64_t)T[i] * 11586, 12);
    else T[i] = T[i] * 4;
  }
}
void iwht(int32_t *T, int shift) {
  int32_t a = T[0] >> shift, c = T[1] >> shift, d = T[2] >> shift, b = T[3] >> shift;
  a += c; d -= b;
  int32_t e = (a - d) >> 1;
  b = e - b; c = e - c;
  a -= b; d += c;
  T[0] = a; T[1] = b; T[2] = c; T[3] = d;
}
// 1: DCT, 2: ADST, 3: flipped ADST, 0: identity; horizontal (row) and
// vertical (column) kinds of each tx type
const int ROW_KIND[16] = {1, 1, 2, 2, 1, 3, 3, 3, 2, 0, 0, 1, 0, 2, 0, 3};
const int COL_KIND[16] = {1, 2, 1, 2, 3, 1, 3, 2, 3, 0, 1, 0, 2, 0, 3, 0};
void tx1d(int32_t *T, int lg, int kind, const Clamp &cl) {
  if (kind == 1) idct(T, lg, cl);
  else if (kind == 0) iidentity(T, lg);
  else if (lg == 2) iadst4(T);
  else if (lg == 3) iadst8(T, cl);
  else iadst16(T, cl);
}

// ---------------------------------------------------------------------------
// the decoder
// ---------------------------------------------------------------------------
struct Plane {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  uint8_t &at(int y, int x) { return px[(size_t)y * w + x]; }
};

struct Decoder {
  const FrameHeader &fh;
  int64_t *census;
  int mi_rows, mi_cols, planes, ssx, ssy;
  Plane cur[3];
  // per 4x4 luma unit
  std::vector<uint8_t> mi_size, y_mode, uv_mode, skip_a, seg_id, inter_tx,
      is_inter_a, pal_size[2], delta_lf_a[4];
  std::vector<uint8_t> pal_colors[2];
  std::vector<uint8_t> tx_types;
  std::vector<int16_t> mvs;  // intrabc vectors (row, col) per mi
  // per 4x4 plane unit: the loop-filter tx size, the block's skip && inter
  std::vector<uint8_t> lf_txsz[3];
  std::vector<int8_t> cdef_idx;  // per 64x64
  int cdef_stride;
  // loop restoration units
  int lr_unit_rows[3], lr_unit_cols[3];
  std::vector<int8_t> lr_type[3];
  std::vector<int16_t> lr_coef[3];  // 2x3 wiener taps or 2 sgr xqd + set
  // tile state
  int mi_row_start, mi_row_end, mi_col_start, mi_col_end;
  SymbolDecoder sd;
  Cdfs cdf;
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
  int current_q, delta_lf[4];
  int ref_sgr_xqd[3][2], ref_lr_wiener[3][2][3];
  bool read_deltas;
  uint8_t block_decoded[3][34][34];
  // block state
  int mi_row, mi_col, msize, bw4, bh4, has_chroma, avail_u, avail_l,
      avail_u_chroma, avail_l_chroma, skip, segment_id, lossless, ymode,
      uvmode, angle_y, angle_uv, cfl_u, cfl_v, use_filter_intra,
      filter_intra_mode, pal_sz_y, pal_sz_uv, tx_size, use_intrabc, is_inter;
  int max_luma_w, max_luma_h;
  uint8_t pal_y[8], pal_u[8], pal_v[8];
  uint8_t color_map_y[64 * 64], color_map_uv[64 * 64];
  int mv_row, mv_col;
  int lossless_seg[8];
  int err;

  Decoder(const FrameHeader &h, int64_t *cen)
      : fh(h), census(cen), err(0) {
    mi_cols = 2 * ((fh.width + 7) >> 3);
    mi_rows = 2 * ((fh.height + 7) >> 3);
    planes = fh.num_planes;
    ssx = fh.ss_x; ssy = fh.ss_y;
    // transform blocks that start inside the frame's 4x4 grid are predicted
    // and reconstructed whole, so each plane keeps 64 samples past it
    cur[0].w = mi_cols * 4 + 64; cur[0].h = mi_rows * 4 + 64;
    for (int p = 1; p < planes; p++) { cur[p].w = ((mi_cols * 4) >> ssx) + 64; cur[p].h = ((mi_rows * 4) >> ssy) + 64; }
    for (int p = 0; p < planes; p++) cur[p].px.assign((size_t)cur[p].w * cur[p].h, 0);
    size_t n = (size_t)mi_rows * mi_cols;
    mi_size.assign(n, 0); y_mode.assign(n, 0); uv_mode.assign(n, 0);
    skip_a.assign(n, 0); seg_id.assign(n, 0); inter_tx.assign(n, 0);
    is_inter_a.assign(n, 0);
    tx_types.assign(n, 0); mvs.assign(2 * n, 0);
    for (int i = 0; i < 4; i++) delta_lf_a[i].assign(n, 0);
    for (int i = 0; i < 2; i++) { pal_size[i].assign(n, 0); pal_colors[i].assign(8 * n, 0); }
    for (int p = 0; p < planes; p++) lf_txsz[p].assign(n, 0);
    cdef_stride = (mi_cols + 15) >> 4;
    cdef_idx.assign((size_t)cdef_stride * ((mi_rows + 15) >> 4), -1);
    for (int s = 0; s < 8; s++) {
      int q = qindex(true, s);
      lossless_seg[s] = q == 0 && fh.dq_y_dc == 0 && fh.dq_u_ac == 0 &&
                        fh.dq_u_dc == 0 && fh.dq_v_ac == 0 && fh.dq_v_dc == 0;
    }
    for (int p = 0; p < planes; p++) {
      int sx = p ? ssx : 0, sy = p ? ssy : 0;
      int size = fh.lr_size[p];
      int pw = round2(fh.width, sx), ph = round2(fh.height, sy);
      lr_unit_cols[p] = std::max((pw + (size >> 1)) / size, 1);
      lr_unit_rows[p] = std::max((ph + (size >> 1)) / size, 1);
      lr_type[p].assign((size_t)lr_unit_rows[p] * lr_unit_cols[p], 0);
      lr_coef[p].assign((size_t)lr_unit_rows[p] * lr_unit_cols[p] * 8, 0);
    }
  }

  size_t mi(int r, int c) const { return (size_t)r * mi_cols + c; }
  bool seg_feature(int seg, int f) const { return fh.seg_enabled && fh.seg_feature_enabled[seg * 8 + f]; }
  int qindex(bool ignore_delta, int seg) const {
    if (seg_feature(seg, 0)) {
      int d = fh.seg_feature_data[seg * 8];
      int q = fh.base_q_idx + d;
      if (!ignore_delta && fh.delta_q_present) q = current_q + d;
      return clip3(0, 255, q);
    }
    if (!ignore_delta && fh.delta_q_present) return current_q;
    return fh.base_q_idx;
  }
  bool inside(int r, int c) const {
    return c >= mi_col_start && c < mi_col_end && r >= mi_row_start && r < mi_row_end;
  }
  void count(int i) { if (census) census[i]++; }

  // ---------------------------------------------------------------- tiles
  void decode_tile(const uint8_t *p, int size) {
    sd.init(p, size, fh.disable_cdf_update);
    for (int pl = 0; pl < planes; pl++) {
      int sx = pl ? ssx : 0;
      above_level[pl].assign((mi_cols >> sx) + 32, 0);
      above_dc[pl].assign((mi_cols >> sx) + 32, 0);
      for (int pass = 0; pass < 2; pass++) {
        ref_sgr_xqd[pl][pass] = AV1_SGRPROJ_XQD_MID[pass];
        for (int i = 0; i < 3; i++) ref_lr_wiener[pl][pass][i] = AV1_WIENER_TAPS_MID[i];
      }
    }
    for (int i = 0; i < 4; i++) delta_lf[i] = 0;
    current_q = fh.base_q_idx;
    int sb4 = fh.use_128 ? 32 : 16;
    int sbsize = fh.use_128 ? BLOCK_128X128 : BLOCK_64X64;
    for (int r = mi_row_start; r < mi_row_end && !err; r += sb4) {
      for (int pl = 0; pl < planes; pl++) {
        int sy = pl ? ssy : 0;
        left_level[pl].assign((mi_rows >> sy) + 32, 0);
        left_dc[pl].assign((mi_rows >> sy) + 32, 0);
      }
      for (int c = mi_col_start; c < mi_col_end && !err; c += sb4) {
        read_deltas = fh.delta_q_present;
        clear_cdef(r, c);
        clear_block_decoded(r, c, sb4);
        read_lr(r, c, sbsize);
        decode_partition(r, c, sbsize);
      }
      // dav1d fails a tile whose symbols ran past its data by more than
      // the decoder's 15-bit window, at the end of each superblock row
      if (sd.maxbits < -14 && !err) err = -4;
    }
  }
  void clear_cdef(int r, int c) {
    cdef_idx[(size_t)(r >> 4) * cdef_stride + (c >> 4)] = -1;
    if (fh.use_128) {
      for (int dr = 0; dr < 2; dr++)
        for (int dc = 0; dc < 2; dc++) {
          int rr = (r >> 4) + dr, cc = (c >> 4) + dc;
          if (rr < (mi_rows + 15) >> 4 && cc < cdef_stride) cdef_idx[(size_t)rr * cdef_stride + cc] = -1;
        }
    }
  }
  void clear_block_decoded(int r, int c, int sb4) {
    for (int pl = 0; pl < planes; pl++) {
      int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
      int sbw4 = (mi_col_end - c) >> sx, sbh4 = (mi_row_end - r) >> sy;
      for (int y = -1; y <= (sb4 >> sy); y++)
        for (int x = -1; x <= (sb4 >> sx); x++) {
          uint8_t v;
          if (y < 0 && x < sbw4) v = 1;
          else if (x < 0 && y < sbh4) v = 1;
          else v = 0;
          block_decoded[pl][y + 1][x + 1] = v;
        }
      block_decoded[pl][(sb4 >> sy) + 1][0] = 0;
    }
  }
  uint8_t &bdec(int pl, int y, int x) { return block_decoded[pl][y + 1][x + 1]; }

  // ---------------------------------------------------- loop restoration
  void read_lr(int r, int c, int bsize) {
    if (fh.allow_intrabc) return;
    int w = BW[bsize] >> 2, h = BH[bsize] >> 2;
    for (int pl = 0; pl < planes; pl++) {
      if (fh.lr_type[pl] == RESTORE_NONE) continue;
      int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
      int usize = fh.lr_size[pl];
      int ny = 4 >> sy, nx = 4 >> sx;  // MI_SIZE in the plane's samples
      int row0 = (r * ny + usize - 1) / usize;
      int row1 = std::min(lr_unit_rows[pl], ((r + h) * ny + usize - 1) / usize);
      int col0 = (c * nx + usize - 1) / usize;
      int col1 = std::min(lr_unit_cols[pl], ((c + w) * nx + usize - 1) / usize);
      for (int ur = row0; ur < row1; ur++)
        for (int uc = col0; uc < col1; uc++) read_lr_unit(pl, ur, uc);
    }
  }
  int decode_signed_subexp_with_ref_bool(int low, int high, int k, int r) {
    int x = decode_unsigned_subexp_with_ref_bool(high - low, k, r - low);
    return x + low;
  }
  int decode_unsigned_subexp_with_ref_bool(int mx, int k, int r) {
    int v = decode_subexp_bool(mx, k);
    if ((r << 1) <= mx) return inverse_recenter(r, v);
    return mx - 1 - inverse_recenter(mx - 1 - r, v);
  }
  int decode_subexp_bool(int numSyms, int k) {
    int i = 0, mk = 0;
    while (true) {
      int b2 = i ? k + i - 1 : k;
      int a = 1 << b2;
      if (numSyms <= mk + 3 * a) {
        return sd.ns(numSyms - mk) + mk;
      }
      if (sd.literal(1)) { i++; mk += a; }
      else return sd.literal(b2) + mk;
    }
  }
  static int inverse_recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v & 1) return r - ((v + 1) >> 1);
    return r + (v >> 1);
  }
  void read_lr_unit(int pl, int ur, int uc) {
    int t = fh.lr_type[pl];
    int restoration_type = RESTORE_NONE;
    if (t == RESTORE_WIENER) {
      if (sd.symbol(cdf.use_wiener, 2)) restoration_type = RESTORE_WIENER;
    } else if (t == RESTORE_SGRPROJ) {
      if (sd.symbol(cdf.use_sgrproj, 2)) restoration_type = RESTORE_SGRPROJ;
    } else {
      int s = sd.symbol(cdf.restoration_type, 3);
      restoration_type = s;  // 0 none, 1 wiener, 2 sgrproj
      count(C_SWITCHABLE);
    }
    size_t u = (size_t)ur * lr_unit_cols[pl] + uc;
    lr_type[pl][u] = (int8_t)restoration_type;
    int16_t *co = &lr_coef[pl][u * 8];
    if (restoration_type == RESTORE_WIENER) {
      count(C_WIENER);
      for (int pass = 0; pass < 2; pass++) {
        int first;
        if (pl) { first = 1; co[pass * 3] = 0; }
        else first = 0;
        for (int j = first; j < 3; j++) {
          int mn = AV1_WIENER_TAPS_MIN[j], mx = AV1_WIENER_TAPS_MAX[j];
          int k = j + 1;  // Wiener_Taps_K = {1, 2, 3}
          int v = decode_signed_subexp_with_ref_bool(mn, mx + 1, k, ref_lr_wiener[pl][pass][j]);
          co[pass * 3 + j] = (int16_t)v;
          ref_lr_wiener[pl][pass][j] = v;
        }
      }
    } else if (restoration_type == RESTORE_SGRPROJ) {
      count(C_SGRPROJ);
      int set = sd.literal(4);
      co[6] = (int16_t)set;
      for (int i = 0; i < 2; i++) {
        int radius = AV1_SGR_PARAMS[set][i * 2];
        int mn = AV1_SGRPROJ_XQD_MIN[i], mx = AV1_SGRPROJ_XQD_MAX[i];
        int v;
        if (radius) {
          v = decode_signed_subexp_with_ref_bool(mn, mx + 1, 4, ref_sgr_xqd[pl][i]);
        } else {
          v = 0;
          if (i == 1) v = clip3(mn, mx, (1 << 7) - ref_sgr_xqd[pl][0]);
        }
        co[i] = (int16_t)v;
        ref_sgr_xqd[pl][i] = v;
      }
    }
  }

  // ----------------------------------------------------------- partitions
  void decode_partition(int r, int c, int bsize) {
    if (r >= mi_rows || c >= mi_cols || err) return;
    int avu = inside(r - 1, c), avl = inside(r, c - 1);
    int n4 = BW[bsize] >> 2, half = n4 >> 1, quarter = half >> 1;
    bool has_rows = (r + half) < mi_rows, has_cols = (c + half) < mi_cols;
    int partition;
    if (bsize < BLOCK_8X8) partition = PARTITION_NONE;
    else {
      int bsl = log2i(n4);  // Mi_Width_Log2
      int above = avu && log2i(BW[mi_size[mi(r - 1, c)]] >> 2) < bsl;
      int left = avl && log2i(BH[mi_size[mi(r, c - 1)]] >> 2) < bsl;
      int ctx = left * 2 + above;
      uint16_t *pc = cdf.partition[(bsl - 1) * 4 + ctx];
      int ns = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
      if (has_rows && has_cols) partition = sd.symbol(pc, ns);
      else if (has_cols) {
        auto P = [&](int e) { return e < ns ? (int)pc[e] - (e ? pc[e - 1] : 0) : 0; };
        int psum = P(PARTITION_VERT) + P(PARTITION_SPLIT) + P(PARTITION_HORZ_A) +
                   P(PARTITION_VERT_A) + P(PARTITION_VERT_B);
        if (bsize != BLOCK_128X128) psum += P(PARTITION_VERT_4);
        uint16_t t[3] = {(uint16_t)(32768 - psum), 32768, 0};
        bool u = sd.update; sd.update = false;
        partition = sd.symbol(t, 2) ? PARTITION_SPLIT : PARTITION_HORZ;
        sd.update = u;
      } else if (has_rows) {
        auto P = [&](int e) { return e < ns ? (int)pc[e] - (e ? pc[e - 1] : 0) : 0; };
        int psum = P(PARTITION_HORZ) + P(PARTITION_SPLIT) + P(PARTITION_HORZ_A) +
                   P(PARTITION_HORZ_B) + P(PARTITION_VERT_A);
        if (bsize != BLOCK_128X128) psum += P(PARTITION_HORZ_4);
        uint16_t t[3] = {(uint16_t)(32768 - psum), 32768, 0};
        bool u = sd.update; sd.update = false;
        partition = sd.symbol(t, 2) ? PARTITION_SPLIT : PARTITION_VERT;
        sd.update = u;
      } else partition = PARTITION_SPLIT;
    }
    // dav1d refuses the partitions that give 4:2:2 chroma no block size
    if (ssx && !ssy && planes > 1 &&
        (partition == PARTITION_VERT || partition == PARTITION_VERT_4 ||
         partition == PARTITION_VERT_A || partition == PARTITION_VERT_B)) {
      err = -5;
      return;
    }
    count(C_PART + partition);
    int w = BW[bsize], h = BH[bsize];
    int sub, split = block_size(w / 2, h / 2);
    switch (partition) {
      case PARTITION_NONE: sub = bsize; break;
      case PARTITION_HORZ: case PARTITION_HORZ_A: case PARTITION_HORZ_B: sub = block_size(w, h / 2); break;
      case PARTITION_VERT: case PARTITION_VERT_A: case PARTITION_VERT_B: sub = block_size(w / 2, h); break;
      case PARTITION_SPLIT: sub = split; break;
      case PARTITION_HORZ_4: sub = block_size(w, h / 4); break;
      default: sub = block_size(w / 4, h); break;
    }
    if (sub == BLOCK_INVALID) { err = -2; return; }
    switch (partition) {
      case PARTITION_NONE: decode_block(r, c, sub); break;
      case PARTITION_HORZ:
        decode_block(r, c, sub);
        if (has_rows) decode_block(r + half, c, sub);
        break;
      case PARTITION_VERT:
        decode_block(r, c, sub);
        if (has_cols) decode_block(r, c + half, sub);
        break;
      case PARTITION_SPLIT:
        decode_partition(r, c, sub);
        decode_partition(r, c + half, sub);
        decode_partition(r + half, c, sub);
        decode_partition(r + half, c + half, sub);
        break;
      case PARTITION_HORZ_A:
        decode_block(r, c, split); decode_block(r, c + half, split); decode_block(r + half, c, sub); break;
      case PARTITION_HORZ_B:
        decode_block(r, c, sub); decode_block(r + half, c, split); decode_block(r + half, c + half, split); break;
      case PARTITION_VERT_A:
        decode_block(r, c, split); decode_block(r + half, c, split); decode_block(r, c + half, sub); break;
      case PARTITION_VERT_B:
        decode_block(r, c, sub); decode_block(r, c + half, split); decode_block(r + half, c + half, split); break;
      case PARTITION_HORZ_4:
        for (int i = 0; i < 4; i++) if (i < 3 || r + quarter * 3 < mi_rows) decode_block(r + quarter * i, c, sub);
        break;
      case PARTITION_VERT_4:
        for (int i = 0; i < 4; i++) if (i < 3 || c + quarter * 3 < mi_cols) decode_block(r, c + quarter * i, sub);
        break;
    }
  }

  // --------------------------------------------------------------- blocks
  void decode_block(int r, int c, int bsize) {
    if (err) return;
    mi_row = r; mi_col = c; msize = bsize;
    bw4 = BW[bsize] >> 2; bh4 = BH[bsize] >> 2;
    if (bh4 == 1 && ssy && (mi_row & 1) == 0) has_chroma = 0;
    else if (bw4 == 1 && ssx && (mi_col & 1) == 0) has_chroma = 0;
    else has_chroma = planes > 1;
    avail_u = inside(r - 1, c); avail_l = inside(r, c - 1);
    avail_u_chroma = avail_u; avail_l_chroma = avail_l;
    if (has_chroma) {
      if (ssy && bh4 == 1) avail_u_chroma = inside(r - 2, c);
      if (ssx && bw4 == 1) avail_l_chroma = inside(r, c - 2);
    } else avail_u_chroma = avail_l_chroma = 0;
    intra_frame_mode_info();
    if (err) return;
    palette_tokens();
    read_block_tx_size();
    if (skip) reset_block_context();
    for (int y = 0; y < bh4; y++) {
      if (r + y >= mi_rows) break;
      for (int x = 0; x < bw4; x++) {
        if (c + x >= mi_cols) break;
        size_t i = mi(r + y, c + x);
        y_mode[i] = (uint8_t)ymode;
        uv_mode[i] = (uint8_t)uvmode;
        is_inter_a[i] = (uint8_t)is_inter;
        skip_a[i] = (uint8_t)skip;
        mi_size[i] = (uint8_t)bsize;
        seg_id[i] = (uint8_t)segment_id;
        pal_size[0][i] = (uint8_t)pal_sz_y;
        pal_size[1][i] = (uint8_t)pal_sz_uv;
        for (int k = 0; k < 8; k++) { pal_colors[0][i * 8 + k] = pal_y[k]; pal_colors[1][i * 8 + k] = pal_u[k]; }
        for (int k = 0; k < 4; k++) delta_lf_a[k][i] = (uint8_t)(int8_t)delta_lf[k];
        mvs[2 * i] = (int16_t)mv_row; mvs[2 * i + 1] = (int16_t)mv_col;
      }
    }
    if (use_intrabc) predict_intrabc();
    residual();
  }
  void reset_block_context() {
    for (int pl = 0; pl < 1 + 2 * has_chroma; pl++) {
      int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
      for (int i = mi_col >> sx; i < ((mi_col + bw4) >> sx); i++) { above_level[pl][i] = 0; above_dc[pl][i] = 0; }
      for (int i = mi_row >> sy; i < ((mi_row + bh4) >> sy); i++) { left_level[pl][i] = 0; left_dc[pl][i] = 0; }
    }
  }

  void intra_frame_mode_info() {
    skip = 0;
    use_intrabc = 0; is_inter = 0; mv_row = mv_col = 0;
    pal_sz_y = pal_sz_uv = 0;
    use_filter_intra = 0;
    angle_y = angle_uv = 0;
    ymode = DC_PRED; uvmode = DC_PRED;
    memset(pal_y, 0, 8); memset(pal_u, 0, 8); memset(pal_v, 0, 8);
    if (fh.seg_id_pre_skip) intra_segment_id();
    else segment_id = 0;
    // read_skip
    if (fh.seg_id_pre_skip && seg_feature(segment_id, 6)) skip = 1;
    else {
      int ctx = (avail_u ? skip_a[mi(mi_row - 1, mi_col)] : 0) + (avail_l ? skip_a[mi(mi_row, mi_col - 1)] : 0);
      skip = sd.symbol(cdf.skip[ctx], 2);
    }
    if (!fh.seg_id_pre_skip) intra_segment_id();
    lossless = lossless_seg[segment_id];
    if (lossless) count(C_LOSSLESS);
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    read_deltas = false;
    if (fh.allow_intrabc) use_intrabc = sd.symbol(cdf.intrabc, 2);
    if (use_intrabc) {
      count(C_INTRABC);
      is_inter = 1;
      read_intrabc_mv();
      return;
    }
    int am = avail_u ? y_mode[mi(mi_row - 1, mi_col)] : DC_PRED;
    int lm = avail_l ? y_mode[mi(mi_row, mi_col - 1)] : DC_PRED;
    ymode = sd.symbol(cdf.kf_y[INTRA_MODE_CONTEXT[am]][INTRA_MODE_CONTEXT[lm]], 13);
    count(C_YMODE + ymode);
    bool use_angle = msize >= BLOCK_8X8;
    if (use_angle && ymode >= V_PRED && ymode <= D67_PRED) {
      angle_y = sd.symbol(cdf.angle_delta[ymode - V_PRED], 7) - 3;
      if (angle_y) count(C_ANGLE_DELTA);
    }
    if (has_chroma) {
      int cfl_allowed;
      if (lossless && plane_res_size(msize, 1) == BLOCK_4X4) cfl_allowed = 1;
      else if (!lossless && std::max(BW[msize], BH[msize]) <= 32) cfl_allowed = 1;
      else cfl_allowed = 0;
      uvmode = sd.symbol(cdf.uv_mode[cfl_allowed][ymode], cfl_allowed ? 14 : 13);
      count(C_UVMODE + uvmode);
      if (uvmode == UV_CFL_PRED) read_cfl_alphas();
      if (use_angle && uvmode >= V_PRED && uvmode <= D67_PRED) {
        angle_uv = sd.symbol(cdf.angle_delta[uvmode - V_PRED], 7) - 3;
        if (angle_uv) count(C_ANGLE_DELTA);
      }
    }
    if (msize >= BLOCK_8X8 && BW[msize] <= 64 && BH[msize] <= 64 && fh.allow_screen_content_tools)
      palette_mode_info();
    if (fh.enable_filter_intra && ymode == DC_PRED && pal_sz_y == 0 && std::max(BW[msize], BH[msize]) <= 32) {
      use_filter_intra = sd.symbol(cdf.filter_intra[msize], 2);
      if (use_filter_intra) {
        filter_intra_mode = sd.symbol(cdf.filter_intra_mode, 5);
        count(C_FILTER_INTRA);
      }
    }
  }
  void intra_segment_id() {
    if (fh.seg_enabled) read_segment_id();
    else segment_id = 0;
  }
  void read_segment_id() {
    int prevUL = -1, prevU = -1, prevL = -1;
    if (avail_u && avail_l) prevUL = seg_id[mi(mi_row - 1, mi_col - 1)];
    if (avail_u) prevU = seg_id[mi(mi_row - 1, mi_col)];
    if (avail_l) prevL = seg_id[mi(mi_row, mi_col - 1)];
    int pred;
    if (prevU == -1) pred = prevL == -1 ? 0 : prevL;
    else if (prevL == -1) pred = prevU;
    else pred = prevUL == prevU ? prevU : prevL;
    if (skip) { segment_id = pred; return; }
    int ctx;
    if (prevUL < 0) ctx = 0;
    else if (prevUL == prevU && prevUL == prevL) ctx = 2;
    else if (prevUL == prevU || prevUL == prevL || prevU == prevL) ctx = 1;
    else ctx = 0;
    int s = sd.symbol(cdf.seg_id[ctx], 8);
    int mx = fh.last_active_seg_id + 1;
    int v;
    if (!pred) v = s;
    else if (pred >= mx - 1) v = mx - s - 1;
    else if (2 * pred < mx) {
      if (s <= 2 * pred) v = (s & 1) ? pred + ((s + 1) >> 1) : pred - (s >> 1);
      else v = s;
    } else {
      if (s <= 2 * (mx - pred - 1)) v = (s & 1) ? pred + ((s + 1) >> 1) : pred - (s >> 1);
      else v = mx - (s + 1);
    }
    segment_id = clip3(0, fh.last_active_seg_id, v);
    count(C_SEGMENTATION);
  }
  void read_cdef() {
    if (skip || !cdef_on()) return;
    int r = mi_row & ~15, c = mi_col & ~15;
    int8_t &ci = cdef_idx[(size_t)(r >> 4) * cdef_stride + (c >> 4)];
    if (ci == -1) {
      int v = sd.literal(fh.cdef_bits);
      for (int y = r; y < mi_row + bh4; y += 16)
        for (int x = c; x < mi_col + bw4; x += 16)
          if (y < mi_rows && x < mi_cols) cdef_idx[(size_t)(y >> 4) * cdef_stride + (x >> 4)] = (int8_t)v;
    }
  }
  // av1.py sets the damping to 0 where the frame reads no CDEF index
  bool cdef_on() const { return fh.cdef_damping != 0; }
  void read_delta_qindex() {
    int sbsize = fh.use_128 ? BLOCK_128X128 : BLOCK_64X64;
    if (msize == sbsize && skip) return;
    if (read_deltas) {
      int a = sd.symbol(cdf.delta_q, 4);
      if (a == 3) {
        int rem = sd.literal(3) + 1;
        a = sd.literal(rem) + (1 << rem) + 1;
      }
      if (a) {
        int sign = sd.literal(1);
        int red = sign ? -a : a;
        current_q = clip3(1, 255, current_q + (red << fh.delta_q_res));
        count(C_DELTA_Q);
      }
    }
  }
  void read_delta_lf() {
    int sbsize = fh.use_128 ? BLOCK_128X128 : BLOCK_64X64;
    if (msize == sbsize && skip) return;
    if (read_deltas && fh.delta_lf_present) {
      int n = 1;
      if (fh.delta_lf_multi) n = planes > 1 ? 4 : 2;
      for (int i = 0; i < n; i++) {
        uint16_t *cd = fh.delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf;
        int a = sd.symbol(cd, 4);
        if (a == 3) {
          int rem = sd.literal(3) + 1;
          a = sd.literal(rem) + (1 << rem) + 1;
        }
        if (a) {
          int sign = sd.literal(1);
          int red = sign ? -a : a;
          delta_lf[i] = clip3(-63, 63, delta_lf[i] + (red << fh.delta_lf_res));
          count(C_DELTA_LF);
        }
      }
    }
  }
  void read_cfl_alphas() {
    count(C_CFL);
    int signs = sd.symbol(cdf.cfl_sign, 8);
    int su = (signs + 1) / 3, sv = (signs + 1) % 3;
    if (su) {
      int a = sd.symbol(cdf.cfl_alpha[(su - 1) * 3 + sv], 16);
      cfl_u = su == 1 ? -(a + 1) : a + 1;
    } else cfl_u = 0;
    if (sv) {
      int a = sd.symbol(cdf.cfl_alpha[(sv - 1) * 3 + su], 16);
      cfl_v = sv == 1 ? -(a + 1) : a + 1;
    } else cfl_v = 0;
  }
  int plane_res_size(int bsize, int pl) {
    int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
    int w = std::max(BW[bsize] >> sx, 4), h = std::max(BH[bsize] >> sy, 4);
    int b = block_size(w, h);
    if (b == BLOCK_INVALID) { err = -3; return BLOCK_4X4; }
    return b;
  }

  // --------------------------------------------------------------- palette
  int palette_cache(int pl, uint8_t *cache) {
    int aboveN = 0, leftN = 0;
    if ((mi_row * 4) % 64 && avail_u) aboveN = pal_size[pl][mi(mi_row - 1, mi_col)];
    if (avail_l) leftN = pal_size[pl][mi(mi_row, mi_col - 1)];
    const uint8_t *ac = aboveN ? &pal_colors[pl][mi(mi_row - 1, mi_col) * 8] : nullptr;
    const uint8_t *lc = leftN ? &pal_colors[pl][mi(mi_row, mi_col - 1) * 8] : nullptr;
    int ai = 0, li = 0, n = 0;
    while (ai < aboveN && li < leftN) {
      int a = ac[ai], l = lc[li];
      if (l < a) { if (n == 0 || l != cache[n - 1]) cache[n++] = (uint8_t)l; li++; }
      else { if (n == 0 || a != cache[n - 1]) cache[n++] = (uint8_t)a; ai++; if (l == a) li++; }
    }
    while (ai < aboveN) { int v = ac[ai++]; if (n == 0 || v != cache[n - 1]) cache[n++] = (uint8_t)v; }
    while (li < leftN) { int v = lc[li++]; if (n == 0 || v != cache[n - 1]) cache[n++] = (uint8_t)v; }
    return n;
  }
  void palette_mode_info() {
    int bctx = log2i(BW[msize] >> 2) + log2i(BH[msize] >> 2) - 2;
    if (ymode == DC_PRED) {
      int ctx = 0;
      if (avail_u && pal_size[0][mi(mi_row - 1, mi_col)] > 0) ctx++;
      if (avail_l && pal_size[0][mi(mi_row, mi_col - 1)] > 0) ctx++;
      if (sd.symbol(cdf.pal_y_mode[bctx][ctx], 2)) {
        count(C_PALETTE_Y);
        pal_sz_y = sd.symbol(cdf.pal_y_size[bctx], 7) + 2;
        uint8_t cache[16];
        int n = palette_cache(0, cache), idx = 0;
        for (int i = 0; i < n && idx < pal_sz_y; i++) if (sd.literal(1)) pal_y[idx++] = cache[i];
        if (idx < pal_sz_y) { pal_y[idx++] = (uint8_t)sd.literal(8); }
        int bits = 0;
        if (idx < pal_sz_y) bits = 5 + sd.literal(2);
        while (idx < pal_sz_y) {
          int d = sd.literal(bits) + 1;
          pal_y[idx] = (uint8_t)clip1(pal_y[idx - 1] + d);
          int range = 256 - pal_y[idx] - 1;
          bits = std::min(bits, ceil_log2(range));
          idx++;
        }
        std::sort(pal_y, pal_y + pal_sz_y);
      }
    }
    if (has_chroma && uvmode == DC_PRED) {
      int ctx = pal_sz_y > 0;
      if (sd.symbol(cdf.pal_uv_mode[ctx], 2)) {
        count(C_PALETTE_UV);
        pal_sz_uv = sd.symbol(cdf.pal_uv_size[bctx], 7) + 2;
        uint8_t cache[16];
        int n = palette_cache(1, cache), idx = 0;
        for (int i = 0; i < n && idx < pal_sz_uv; i++) if (sd.literal(1)) pal_u[idx++] = cache[i];
        if (idx < pal_sz_uv) pal_u[idx++] = (uint8_t)sd.literal(8);
        int bits = 0;
        if (idx < pal_sz_uv) bits = 5 + sd.literal(2);
        while (idx < pal_sz_uv) {
          int d = sd.literal(bits);
          pal_u[idx] = (uint8_t)clip1(pal_u[idx - 1] + d);
          int range = 256 - pal_u[idx];
          bits = std::min(bits, ceil_log2(range));
          idx++;
        }
        std::sort(pal_u, pal_u + pal_sz_uv);
        if (sd.literal(1)) {
          int bits2 = 4 + sd.literal(2);
          pal_v[0] = (uint8_t)sd.literal(8);
          for (int i = 1; i < pal_sz_uv; i++) {
            int d = sd.literal(bits2);
            if (d && sd.literal(1)) d = -d;
            int v = pal_v[i - 1] + d;
            if (v < 0) v += 256;
            if (v >= 256) v -= 256;
            pal_v[i] = (uint8_t)clip1(v);
          }
        } else {
          for (int i = 0; i < pal_sz_uv; i++) pal_v[i] = (uint8_t)sd.literal(8);
        }
      }
    }
  }
  void palette_tokens() {
    int bh = BH[msize], bw = BW[msize];
    int onh = std::min(bh, (mi_rows - mi_row) * 4), onw = std::min(bw, (mi_cols - mi_col) * 4);
    if (pal_sz_y) color_map(color_map_y, pal_sz_y, bw, bh, onw, onh, cdf.pal_y_color);
    if (pal_sz_uv) {
      bw >>= ssx; bh >>= ssy; onw >>= ssx; onh >>= ssy;
      if (bw < 4) { bw += 2; onw += 2; }
      if (bh < 4) { bh += 2; onh += 2; }
      color_map(color_map_uv, pal_sz_uv, bw, bh, onw, onh, cdf.pal_uv_color);
    }
  }
  void color_map(uint8_t *m, int n, int bw, int bh, int onw, int onh, uint16_t (*cdfs)[5][9]) {
    m[0] = (uint8_t)sd.ns(n);
    for (int i = 1; i < onh + onw - 1; i++) {
      for (int j = std::min(i, onw - 1); j >= std::max(0, i - onh + 1); j--) {
        int r = i - j, c = j;
        int scores[8] = {0}, order[8];
        for (int k = 0; k < 8; k++) order[k] = k;
        if (c > 0) scores[m[r * bw + c - 1]] += 2;
        if (r > 0 && c > 0) scores[m[(r - 1) * bw + c - 1]] += 1;
        if (r > 0) scores[m[(r - 1) * bw + c]] += 2;
        for (int k = 0; k < 3; k++) {
          int ms = scores[k], mi2 = k;
          for (int l = k + 1; l < n; l++) if (scores[l] > ms) { ms = scores[l]; mi2 = l; }
          if (mi2 != k) {
            ms = scores[mi2];
            int mo = order[mi2];
            for (int l = mi2; l > k; l--) { scores[l] = scores[l - 1]; order[l] = order[l - 1]; }
            scores[k] = ms; order[k] = mo;
          }
        }
        int hash = scores[0] * 1 + scores[1] * 2 + scores[2] * 2;
        int ctx = AV1_PALETTE_COLOR_CONTEXT[hash];
        int s = sd.symbol(cdfs[n - 2][ctx], n);
        m[r * bw + c] = (uint8_t)order[s];
      }
    }
    for (int i = 0; i < onh; i++) for (int j = onw; j < bw; j++) m[i * bw + j] = m[i * bw + onw - 1];
    for (int i = onh; i < bh; i++) for (int j = 0; j < bw; j++) m[i * bw + j] = m[(onh - 1) * bw + j];
  }

  // ---------------------------------------------------------------- tx size
  void read_block_tx_size() {
    if (use_intrabc && fh.tx_mode == 2 && msize > BLOCK_4X4 && !skip && !lossless) {
      read_var_tx_size();
      return;
    }
    read_tx_size(!skip || !is_inter);
    for (int y = 0; y < bh4; y++)
      for (int x = 0; x < bw4; x++)
        if (mi_row + y < mi_rows && mi_col + x < mi_cols) inter_tx[mi(mi_row + y, mi_col + x)] = (uint8_t)tx_size;
  }
  void read_var_tx_size() {
    int mx = MAX_TX_RECT[msize];
    int tw4 = TXW[mx] >> 2, th4 = TXH[mx] >> 2;
    for (int row = mi_row; row < mi_row + bh4; row += th4)
      for (int col = mi_col; col < mi_col + bw4; col += tw4) var_tx(row, col, mx, 0);
  }
  int above_tx_w(int row, int col) {
    if (row == mi_row) {
      if (!avail_u) return 64;
      size_t i = mi(row - 1, col);
      if (skip_a[i] && is_inter_a[i]) return BW[mi_size[i]];
    }
    return TXW[inter_tx[mi(row - 1, col)]];
  }
  int left_tx_h(int row, int col) {
    if (col == mi_col) {
      if (!avail_l) return 64;
      size_t i = mi(row, col - 1);
      if (skip_a[i] && is_inter_a[i]) return BH[mi_size[i]];
    }
    return TXH[inter_tx[mi(row, col - 1)]];
  }
  void var_tx(int row, int col, int txsz, int depth) {
    if (row >= mi_rows || col >= mi_cols) return;
    int split = 0;
    if (txsz != TX_4X4 && depth != 2) {
      int above = above_tx_w(row, col) < TXW[txsz];
      int left = left_tx_h(row, col) < TXH[txsz];
      int size = std::min(64, std::max(BW[msize], BH[msize]));
      int maxsz = tx_size_of(size, size);
      int ctx = (sqr_up(txsz) != maxsz) * 3 + (TX_64X64 - maxsz) * 6 + above + left;
      split = sd.symbol(cdf.txfm_split[ctx], 2);
    }
    int w4 = TXW[txsz] >> 2, h4 = TXH[txsz] >> 2;
    if (split) {
      int sub = SPLIT_TX[txsz];
      int sw = TXW[sub] >> 2, sh = TXH[sub] >> 2;
      for (int i = 0; i < h4; i += sh)
        for (int j = 0; j < w4; j += sw) var_tx(row + i, col + j, sub, depth + 1);
    } else {
      for (int i = 0; i < h4; i++)
        for (int j = 0; j < w4; j++)
          if (row + i < mi_rows && col + j < mi_cols) inter_tx[mi(row + i, col + j)] = (uint8_t)txsz;
      tx_size = txsz;
    }
  }
  int tx_depth_ctx(int max_rect) {
    int maxw = TXW[max_rect], maxh = TXH[max_rect];
    int aw = 0, lh = 0;
    if (avail_u) {
      size_t i = mi(mi_row - 1, mi_col);
      if (is_inter_a[i]) aw = BW[mi_size[i]];
      else aw = (skip_a[i] && is_inter_a[i]) ? BW[mi_size[i]] : TXW[inter_tx[i]];
    }
    if (avail_l) {
      size_t i = mi(mi_row, mi_col - 1);
      if (is_inter_a[i]) lh = BH[mi_size[i]];
      else lh = (skip_a[i] && is_inter_a[i]) ? BH[mi_size[i]] : TXH[inter_tx[i]];
    }
    return (aw >= maxw) + (lh >= maxh);
  }
  void read_tx_size(bool allow_select) {
    if (lossless) { tx_size = TX_4X4; return; }
    int max_rect = MAX_TX_RECT[msize];
    int depth_max = 0;
    for (int t = max_rect; t != TX_4X4; t = SPLIT_TX[t]) depth_max++;
    tx_size = max_rect;
    if (msize > BLOCK_4X4 && allow_select && fh.tx_mode == 2) {
      int ctx = tx_depth_ctx(max_rect);
      int cat = depth_max - 1;
      int depth;
      if (cat == 0) depth = sd.symbol(cdf.tx8[ctx], 2);
      else depth = sd.symbol(cdf.txsz[cat - 1][ctx], 3);
      for (int i = 0; i < depth; i++) tx_size = SPLIT_TX[tx_size];
    }
  }

  // ------------------------------------------------------ intra block copy
  // the motion vector prediction of 7.10.2, for intra block copy (every
  // candidate is an intra-block-copy block of this frame)
  int stack_mv[8][2], stack_w[8], n_found, found_match;
  void lower_mv(int *mv) {
    for (int i = 0; i < 2; i++) {
      int a = std::abs(mv[i]), ai = (a + 3) >> 3;
      mv[i] = mv[i] > 0 ? ai << 3 : -(ai << 3);
    }
  }
  void add_candidate(int r, int c, int weight) {
    size_t i = mi(r, c);
    if (!is_inter_a[i]) return;
    int mv[2] = {mvs[2 * i], mvs[2 * i + 1]};
    lower_mv(mv);
    found_match = 1;
    int k;
    for (k = 0; k < n_found; k++) if (stack_mv[k][0] == mv[0] && stack_mv[k][1] == mv[1]) break;
    if (k < n_found) stack_w[k] += weight;
    else if (n_found < 8) { stack_mv[n_found][0] = mv[0]; stack_mv[n_found][1] = mv[1]; stack_w[n_found] = weight; n_found++; }
  }
  void scan_row(int drow) {
    int end4 = std::min(std::min(bw4, mi_cols - mi_col), 16);
    int dcol = 0;
    bool step16 = bw4 >= 16;
    if (std::abs(drow) > 1) { drow += mi_row & 1; dcol = 1 - (mi_col & 1); }
    for (int i = 0; i < end4;) {
      int r = mi_row + drow, c = mi_col + dcol + i;
      if (!inside(r, c)) break;
      int len = std::min(bw4, BW[mi_size[mi(r, c)]] >> 2);
      if (std::abs(drow) > 1) len = std::max(2, len);
      if (step16) len = std::max(4, len);
      add_candidate(r, c, len * 2);
      i += len;
    }
  }
  void scan_col(int dcol) {
    int end4 = std::min(std::min(bh4, mi_rows - mi_row), 16);
    int drow = 0;
    bool step16 = bh4 >= 16;
    if (std::abs(dcol) > 1) { drow = 1 - (mi_row & 1); dcol += mi_col & 1; }
    for (int i = 0; i < end4;) {
      int r = mi_row + drow + i, c = mi_col + dcol;
      if (!inside(r, c)) break;
      int len = std::min(bh4, BH[mi_size[mi(r, c)]] >> 2);
      if (std::abs(dcol) > 1) len = std::max(2, len);
      if (step16) len = std::max(4, len);
      add_candidate(r, c, len * 2);
      i += len;
    }
  }
  void scan_point(int drow, int dcol) {
    int r = mi_row + drow, c = mi_col + dcol;
    if (!inside(r, c)) return;
    if (drow == -1 && dcol == bw4) {  // the top right: decoded yet?
      int sbmask = fh.use_128 ? 31 : 15;
      if (!bdec(0, (mi_row & sbmask) - 1, (mi_col & sbmask) + bw4)) return;
    }
    add_candidate(r, c, 4);
  }
  void sort_stack(int start, int end) {
    while (end > start) {
      int ne = start;
      for (int k = start + 1; k < end; k++)
        if (stack_w[k - 1] < stack_w[k]) {
          std::swap(stack_w[k - 1], stack_w[k]);
          std::swap(stack_mv[k - 1][0], stack_mv[k][0]);
          std::swap(stack_mv[k - 1][1], stack_mv[k][1]);
          ne = k;
        }
      end = ne;
    }
  }
  void find_mv_stack() {
    n_found = 0;
    found_match = 0;
    scan_row(-1);
    found_match = 0;
    scan_col(-1);
    found_match = 0;
    if (std::max(bw4, bh4) <= 16) scan_point(-1, bw4);
    int nearest = n_found;
    for (int k = 0; k < nearest; k++) stack_w[k] += 640;
    scan_point(-1, -1);
    scan_row(-3);
    scan_col(-3);
    if (bh4 > 1) scan_row(-5);
    if (bw4 > 1) scan_col(-5);
    sort_stack(0, nearest);
    sort_stack(nearest, n_found);
    for (int k = n_found; k < 2; k++) stack_mv[k][0] = stack_mv[k][1] = 0;
    for (int k = 0; k < n_found; k++) {
      int top = -(mi_row * 4 * 8), bottom = (mi_rows - bh4 - mi_row) * 4 * 8;
      int left = -(mi_col * 4 * 8), right = (mi_cols - bw4 - mi_col) * 4 * 8;
      stack_mv[k][0] = clip3(top - 128 - bh4 * 32, bottom + 128 + bh4 * 32, stack_mv[k][0]);
      stack_mv[k][1] = clip3(left - 128 - bw4 * 32, right + 128 + bw4 * 32, stack_mv[k][1]);
    }
  }
  int mv_component(int comp) {
    int sign = sd.symbol(cdf.mv_sign[comp], 2);
    int cls = sd.symbol(cdf.mv_class[comp], 11);
    int mag;
    if (cls == 0) {
      int b = sd.symbol(cdf.mv_class0[comp], 2);
      mag = ((b << 3) | (3 << 1) | 1) + 1;
    } else {
      int d = 0;
      for (int i = 0; i < cls; i++) d |= sd.symbol(cdf.mv_bit[comp][i], 2) << i;
      mag = 2 << (cls + 2);
      mag += ((d << 3) | (3 << 1) | 1) + 1;
    }
    return sign ? -mag : mag;
  }
  void read_intrabc_mv() {
    ymode = uvmode = DC_PRED;
    find_mv_stack();
    int pred[2] = {stack_mv[0][0], stack_mv[0][1]};
    if (pred[0] == 0 && pred[1] == 0) { pred[0] = stack_mv[1][0]; pred[1] = stack_mv[1][1]; }
    if (pred[0] == 0 && pred[1] == 0) {
      int sb4 = fh.use_128 ? 32 : 16;
      if (mi_row - sb4 < mi_row_start) { pred[0] = 0; pred[1] = -(sb4 * 4 + 256) * 8; }
      else { pred[0] = -(sb4 * 4 * 8); pred[1] = 0; }
    }
    int joint = sd.symbol(cdf.mv_joint, 4);
    int diff[2] = {0, 0};
    if (joint == 2 || joint == 3) diff[0] = mv_component(0);
    if (joint == 1 || joint == 3) diff[1] = mv_component(1);
    int mvy = pred[0] + diff[0], mvx = pred[1] + diff[1];
    // dav1d clips the vector to the decoded part of the tile
    int border_left = mi_col_start * 4, border_top = mi_row_start * 4;
    if (has_chroma) {
      if (bw4 < 2 && ssx) border_left += 4;
      if (bh4 < 2 && ssy) border_top += 4;
    }
    int src_left = mi_col * 4 + (mvx >> 3), src_top = mi_row * 4 + (mvy >> 3);
    int src_right = src_left + bw4 * 4, src_bottom = src_top + bh4 * 4;
    int border_right = ((mi_col_end + (bw4 - 1)) & ~(bw4 - 1)) * 4;
    if (src_left < border_left) { src_right += border_left - src_left; src_left = border_left; }
    else if (src_right > border_right) { src_left -= src_right - border_right; src_right = border_right; }
    if (src_top < border_top) { src_bottom += border_top - src_top; src_top = border_top; }
    int sbl = fh.use_128 ? 5 : 4;
    int sbx = (mi_col >> sbl) << (sbl + 2), sby = (mi_row >> sbl) << (sbl + 2);
    int sbsz = 1 << (sbl + 2);
    if (src_bottom > sby && src_right > sbx) {
      if (src_top - border_top >= src_bottom - sby) { src_top -= src_bottom - sby; src_bottom = sby; }
      else if (src_left - border_left >= src_right - sbx) { src_left -= src_right - sbx; src_right = sbx; }
    }
    if (src_bottom > sby + sbsz) { src_top -= src_bottom - (sby + sbsz); src_bottom = sby + sbsz; }
    if (src_bottom > sby && src_right > sbx) { err = -52; return; }
    mv_col = (src_left - mi_col * 4) * 8;
    mv_row = (src_top - mi_row * 4) * 8;
  }
  void predict_intrabc() {
    for (int pl = 0; pl < 1 + has_chroma * 2; pl++) {
      int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
      int psz = plane_res_size(msize, pl);
      int w = BW[psz], h = BH[psz];
      int bx = (mi_col >> sx) * 4, by = (mi_row >> sy) * 4;
      int lastx = ((fh.width + sx) >> sx) - 1, lasty = ((fh.height + sy) >> sy) - 1;
      int px = (bx << 4) + ((2 * mv_col) >> sx), py = (by << 4) + ((2 * mv_row) >> sy);
      int fx = px & 15, fy = py & 15, ix = px >> 4, iy = py >> 4;
      Plane &P = cur[pl];
      static thread_local int mid[130 * 128];
      for (int r = 0; r < h + 1; r++)
        for (int c = 0; c < w; c++) {
          int y0 = clip3(0, lasty, iy + r);
          int a = P.at(y0, clip3(0, lastx, ix + c)), b = P.at(y0, clip3(0, lastx, ix + c + 1));
          mid[r * w + c] = round2((128 - fx * 8) * a + fx * 8 * b, 3);
        }
      for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
          int v = round2((128 - fy * 8) * mid[r * w + c] + fy * 8 * mid[(r + 1) * w + c], 11);
          P.at(by + r, bx + c) = (uint8_t)clip1(v);
        }
    }
  }

  // --------------------------------------------------------------- residual
  int get_tx_size(int pl, int txsz) {
    if (pl == 0) return txsz;
    int uvb = plane_res_size(msize, pl);
    int uvtx = MAX_TX_RECT[uvb];
    if (TXW[uvtx] == 64 || TXH[uvtx] == 64) {
      if (TXW[uvtx] == 16) return TX_16X32;
      if (TXH[uvtx] == 16) return TX_32X16;
      return TX_32X32;
    }
    return uvtx;
  }
  void residual() {
    int wc = std::max(1, BW[msize] >> 6), hc = std::max(1, BH[msize] >> 6);
    for (int cy = 0; cy < hc; cy++)
      for (int cx = 0; cx < wc; cx++) {
        int mrc = mi_row + (cy << 4), mcc = mi_col + (cx << 4);
        for (int pl = 0; pl < 1 + has_chroma * 2; pl++) {
          int txsz = lossless ? TX_4X4 : get_tx_size(pl, tx_size);
          int stepx = TXW[txsz] >> 2, stepy = TXH[txsz] >> 2;
          int psz = plane_res_size(msize, pl);
          int n4w = BW[psz] >> 2, n4h = BH[psz] >> 2;
          int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
          int bxb = (mi_col >> sx) * 4, byb = (mi_row >> sy) * 4;
          if (is_inter && !lossless && pl == 0) {
            int sub = (wc > 1 || hc > 1) ? BLOCK_64X64 : msize;
            transform_tree(mcc * 4, mrc * 4, BW[sub], BH[sub]);
            continue;
          }
          for (int y = 0; y < std::min(n4h, 16 >> sy); y += stepy)
            for (int x = 0; x < std::min(n4w, 16 >> sx); x += stepx)
              transform_block(pl, bxb, byb, txsz, x + ((cx << 4) >> sx), y + ((cy << 4) >> sy));
        }
      }
  }
  void transform_tree(int sx, int sy, int w, int h) {
    if (sx >= mi_cols * 4 || sy >= mi_rows * 4) return;
    int txsz = inter_tx[mi(sy >> 2, sx >> 2)];
    if (TXW[txsz] == w && TXH[txsz] == h) { transform_block(0, sx, sy, txsz, 0, 0); return; }
    if (w > h) { transform_tree(sx, sy, w / 2, h); transform_tree(sx + w / 2, sy, w / 2, h); }
    else if (w < h) { transform_tree(sx, sy, w, h / 2); transform_tree(sx, sy + h / 2, w, h / 2); }
    else {
      transform_tree(sx, sy, w / 2, h / 2); transform_tree(sx + w / 2, sy, w / 2, h / 2);
      transform_tree(sx, sy + h / 2, w / 2, h / 2); transform_tree(sx + w / 2, sy + h / 2, w / 2, h / 2);
    }
  }
  void transform_block(int pl, int basex, int basey, int txsz, int x, int y) {
    if (err) return;
    int startx = basex + 4 * x, starty = basey + 4 * y;
    int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
    int row = (starty << sy) >> 2, col = (startx << sx) >> 2;
    int sbmask = fh.use_128 ? 31 : 15;
    int sbr = row & sbmask, sbc = col & sbmask;
    int stepx = TXW[txsz] >> 2, stepy = TXH[txsz] >> 2;
    int maxx = (mi_cols * 4) >> sx, maxy = (mi_rows * 4) >> sy;
    if (startx >= maxx || starty >= maxy) return;
    if (!is_inter) {
      if ((pl == 0 && pal_sz_y) || (pl != 0 && pal_sz_uv)) predict_palette(pl, startx, starty, x, y, txsz);
      else {
        bool is_cfl = pl > 0 && uvmode == UV_CFL_PRED;
        int mode = pl == 0 ? ymode : (is_cfl ? DC_PRED : uvmode);
        int log2w = log2i(TXW[txsz]), log2h = log2i(TXH[txsz]);
        predict_intra(pl, startx, starty,
                      (pl == 0 ? avail_l : avail_l_chroma) || x > 0,
                      (pl == 0 ? avail_u : avail_u_chroma) || y > 0,
                      bdec(pl, (sbr >> sy) - 1, (sbc >> sx) + stepx),
                      bdec(pl, (sbr >> sy) + stepy, (sbc >> sx) - 1),
                      mode, log2w, log2h);
        if (is_cfl) predict_cfl(pl, startx, starty, txsz);
      }
      if (pl == 0) {
        max_luma_w = startx + stepx * 4;
        max_luma_h = starty + stepy * 4;
      }
    }
    if (!skip) {
      int eob = coeffs(startx, starty, pl, txsz);
      last_eob = eob;
      if (eob > 0) reconstruct(pl, startx, starty, txsz);
    }
    for (int i = 0; i < stepy; i++)
      for (int j = 0; j < stepx; j++) {
        int rr = (row >> sy) + i, cc = (col >> sx) + j;
        int pw = (mi_cols + sx) >> sx;  // 4x4 columns of the plane
        int ph = (mi_rows + sy) >> sy;
        if (rr < ph && cc < pw) lf_txsz[pl][(size_t)rr * mi_cols + cc] = (uint8_t)txsz;
        bdec(pl, (sbr >> sy) + i, (sbc >> sx) + j) = 1;
      }
  }

  // ------------------------------------------------------------ prediction
  int filter_type(int pl) {
    int as = 0, ls = 0;
    if (pl == 0 ? avail_u : avail_u_chroma) {
      int r = mi_row - 1, c = mi_col;
      if (pl > 0) { if (ssx && !(mi_col & 1)) c++; if (ssy && (mi_row & 1)) r--; }
      as = is_smooth(r, c, pl);
    }
    if (pl == 0 ? avail_l : avail_l_chroma) {
      int r = mi_row, c = mi_col - 1;
      if (pl > 0) { if (ssx && (mi_col & 1)) c--; if (ssy && !(mi_row & 1)) r++; }
      ls = is_smooth(r, c, pl);
    }
    return as || ls;
  }
  int is_smooth(int r, int c, int pl) {
    int m;
    size_t i = mi(r, c);
    if (pl == 0) m = y_mode[i];
    else { if (is_inter_a[i]) return 0; m = uv_mode[i]; }
    return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
  }
  void predict_intra(int pl, int x, int y, int have_left, int have_above,
                     int have_above_rt, int have_below_lft, int mode,
                     int log2w, int log2h) {
    Plane &P = cur[pl];
    int w = 1 << log2w, h = 1 << log2h;
    int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
    int maxx = ((mi_cols * 4) >> sx) - 1, maxy = ((mi_rows * 4) >> sy) - 1;
    int above_buf[64 * 2 + 32 + 16], left_buf[64 * 2 + 32 + 16];
    int *above = above_buf + 16, *left = left_buf + 16;
    int n = w + h;
    if (!have_above && have_left) for (int i = 0; i < n; i++) above[i] = P.at(y, x - 1);
    else if (!have_above && !have_left) for (int i = 0; i < n; i++) above[i] = 127;
    else {
      int lim = std::min(maxx, x + (have_above_rt ? 2 * w : w) - 1);
      for (int i = 0; i < n; i++) above[i] = P.at(y - 1, std::min(lim, x + i));
    }
    if (!have_left && have_above) for (int i = 0; i < n; i++) left[i] = P.at(y - 1, x);
    else if (!have_left && !have_above) for (int i = 0; i < n; i++) left[i] = 129;
    else {
      int lim = std::min(maxy, y + (have_below_lft ? 2 * h : h) - 1);
      for (int i = 0; i < n; i++) left[i] = P.at(std::min(lim, y + i), x - 1);
    }
    int corner;
    if (have_above && have_left) corner = P.at(y - 1, x - 1);
    else if (have_above) corner = P.at(y - 1, x);
    else if (have_left) corner = P.at(y, x - 1);
    else corner = 128;
    above[-1] = corner; left[-1] = corner;
    static thread_local uint8_t pred[64 * 64];
    if (pl == 0 && use_filter_intra) {
      int w4 = w >> 2, h2 = h >> 1;
      for (int i2 = 0; i2 < h2; i2++)
        for (int j4 = 0; j4 < w4; j4++) {
          int p[7];
          for (int i = 0; i < 7; i++) {
            if (i < 5) {
              if (i2 == 0) p[i] = above[(j4 << 2) + i - 1];
              else if (j4 == 0 && i == 0) p[i] = left[(i2 << 1) - 1];
              else p[i] = pred[((i2 << 1) - 1) * w + (j4 << 2) + i - 1];
            } else {
              if (j4 == 0) p[i] = left[(i2 << 1) + i - 5];
              else p[i] = pred[((i2 << 1) + i - 5) * w + (j4 << 2) - 1];
            }
          }
          for (int i = 0; i < 8; i++) {
            int pr = 0;
            for (int j = 0; j < 7; j++) pr += AV1_FILTER_INTRA_TAPS[filter_intra_mode][i][j] * p[j];
            pred[((i2 << 1) + (i >> 2)) * w + (j4 << 2) + (i & 3)] = (uint8_t)clip1(round2signed(pr, 4));
          }
        }
    } else if (mode >= V_PRED && mode <= D67_PRED) {
      int angle_delta = pl == 0 ? angle_y : angle_uv;
      int pangle = AV1_MODE_TO_ANGLE[mode] + angle_delta * 3;
      int up_above = 0, up_left = 0;
      if (fh.enable_intra_edge_filter) {
        int ftype = filter_type(pl);
        if (pangle != 90 && pangle != 180) {
          if (pangle > 90 && pangle < 180 && (w + h) >= 24) {
            int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
            left[-1] = above[-1] = v;
          }
          if (have_above) {
            int strength = edge_strength(w, h, ftype, pangle - 90);
            int npx = std::min(w, maxx - x + 1) + (pangle < 90 ? h : 0) + 1;
            edge_filter(above, npx, strength);
          }
          if (have_left) {
            int strength = edge_strength(w, h, ftype, pangle - 180);
            int npx = std::min(h, maxy - y + 1) + (pangle > 180 ? w : 0) + 1;
            edge_filter(left, npx, strength);
          }
        }
        up_above = upsample_sel(w, h, ftype, pangle - 90);
        int npx = w + (pangle < 90 ? h : 0);
        if (up_above) edge_upsample(above, npx);
        up_left = upsample_sel(w, h, ftype, pangle - 180);
        npx = h + (pangle > 180 ? w : 0);
        if (up_left) edge_upsample(left, npx);
      }
      int dx = 0, dy = 0;
      if (pangle < 90) dx = AV1_DR_INTRA_DERIVATIVE[pangle];
      else if (pangle > 90 && pangle < 180) dx = AV1_DR_INTRA_DERIVATIVE[180 - pangle];
      if (pangle > 90 && pangle < 180) dy = AV1_DR_INTRA_DERIVATIVE[pangle - 90];
      else if (pangle > 180) dy = AV1_DR_INTRA_DERIVATIVE[270 - pangle];
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (pangle < 90) {
            int idx = (i + 1) * dx;
            int base = (idx >> (6 - up_above)) + (j << up_above);
            int shift = ((idx << up_above) >> 1) & 0x1F;
            int maxbase = (w + h - 1) << up_above;
            if (base < maxbase) v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
            else v = above[maxbase];
          } else if (pangle > 90 && pangle < 180) {
            int idx = (j << 6) - (i + 1) * dx;
            int base = idx >> (6 - up_above);
            if (base >= -(1 << up_above)) {
              int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
              v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
            } else {
              idx = (i << 6) - (j + 1) * dy;
              base = idx >> (6 - up_left);
              int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
              v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
            }
          } else if (pangle > 180) {
            int idx = (j + 1) * dy;
            int base = (idx >> (6 - up_left)) + (i << up_left);
            int shift = ((idx << up_left) >> 1) & 0x1F;
            v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
          } else if (pangle == 90) v = above[j];
          else v = left[i];
          pred[i * w + j] = (uint8_t)v;
        }
    } else if (mode == SMOOTH_PRED) {
      const int32_t *wx = sm_weights(log2w), *wy = sm_weights(log2h);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int s = wy[i] * above[j] + (256 - wy[i]) * left[h - 1] + wx[j] * left[i] + (256 - wx[j]) * above[w - 1];
          pred[i * w + j] = (uint8_t)round2(s, 9);
        }
    } else if (mode == SMOOTH_V_PRED) {
      const int32_t *wy = sm_weights(log2h);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          pred[i * w + j] = (uint8_t)round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
    } else if (mode == SMOOTH_H_PRED) {
      const int32_t *wx = sm_weights(log2w);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          pred[i * w + j] = (uint8_t)round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
    } else if (mode == DC_PRED) {
      int avg;
      if (have_above && have_left) {
        int s = 0;
        for (int k = 0; k < w; k++) s += above[k];
        for (int k = 0; k < h; k++) s += left[k];
        avg = (s + ((w + h) >> 1)) / (w + h);
      } else if (have_above) {
        int s = 0;
        for (int k = 0; k < w; k++) s += above[k];
        avg = (s + (w >> 1)) >> log2w;
      } else if (have_left) {
        int s = 0;
        for (int k = 0; k < h; k++) s += left[k];
        avg = (s + (h >> 1)) >> log2h;
      } else avg = 128;
      memset(pred, avg, (size_t)w * h);
    } else {  // PAETH
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int base = above[j] + left[i] - corner;
          int pl_ = std::abs(base - left[i]), pt = std::abs(base - above[j]), ptl = std::abs(base - corner);
          int v;
          if (pl_ <= pt && pl_ <= ptl) v = left[i];
          else if (pt <= ptl) v = above[j];
          else v = corner;
          pred[i * w + j] = (uint8_t)v;
        }
    }
    for (int i = 0; i < h; i++) {
      if (y + i >= P.h) break;
      for (int j = 0; j < w; j++) {
        if (x + j >= P.w) break;
        P.at(y + i, x + j) = pred[i * w + j];
      }
    }
  }
  const int32_t *sm_weights(int lg) {
    static const int off[7] = {0, 0, 0, 4, 12, 28, 60};
    return AV1_SM_WEIGHTS + off[lg];
  }
  int edge_strength(int w, int h, int ftype, int delta) {
    int d = std::abs(delta), blk = w + h, s = 0;
    if (ftype == 0) {
      if (blk <= 8) { if (d >= 56) s = 1; }
      else if (blk <= 12) { if (d >= 40) s = 1; }
      else if (blk <= 16) { if (d >= 40) s = 1; }
      else if (blk <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
      else if (blk <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
      else { if (d >= 1) s = 3; }
    } else {
      if (blk <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
      else if (blk <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
      else if (blk <= 24) { if (d >= 4) s = 3; }
      else { if (d >= 1) s = 3; }
    }
    return s;
  }
  void edge_filter(int *buf, int sz, int strength) {
    if (!strength) return;
    int edge[300];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
      int s = 0;
      for (int j = 0; j < 5; j++) {
        int k = clip3(0, sz - 1, i - 2 + j);
        s += AV1_INTRA_EDGE_KERNEL[strength - 1][j] * edge[k];
      }
      buf[i - 1] = (s + 8) >> 4;
    }
  }
  int upsample_sel(int w, int h, int ftype, int delta) {
    int d = std::abs(delta), blk = w + h;
    if (d <= 0 || d >= 40) return 0;
    return ftype == 0 ? blk <= 16 : blk <= 8;
  }
  void edge_upsample(int *buf, int npx) {
    int dup[300];
    dup[0] = buf[-1];
    for (int i = -1; i < npx; i++) dup[i + 2] = buf[i];
    dup[npx + 2] = buf[npx - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < npx; i++) {
      int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s = clip1(round2(s, 4));
      buf[2 * i - 1] = s;
      buf[2 * i] = dup[i + 2];
    }
  }
  void predict_palette(int pl, int startx, int starty, int x, int y, int txsz) {
    int w = TXW[txsz], h = TXH[txsz];
    const uint8_t *pal = pl == 0 ? pal_y : pl == 1 ? pal_u : pal_v;
    const uint8_t *m = pl == 0 ? color_map_y : color_map_uv;
    int bw = BW[msize];
    if (pl) { bw >>= ssx; if (bw < 4) bw += 2; }
    Plane &P = cur[pl];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int v = pal[m[(y * 4 + i) * bw + x * 4 + j]];
        if (starty + i < P.h && startx + j < P.w) P.at(starty + i, startx + j) = (uint8_t)v;
      }
  }
  void predict_cfl(int pl, int startx, int starty, int txsz) {
    int w = TXW[txsz], h = TXH[txsz];
    int alpha = pl == 1 ? cfl_u : cfl_v;
    static thread_local int L[64 * 64];
    int64_t avg = 0;
    for (int i = 0; i < h; i++) {
      int ly = std::min(starty + i, ((max_luma_h) >> ssy) - 1) << ssy;
      for (int j = 0; j < w; j++) {
        int lx = std::min(startx + j, ((max_luma_w) >> ssx) - 1) << ssx;
        int t = 0;
        for (int dy = 0; dy <= ssy; dy++)
          for (int dx = 0; dx <= ssx; dx++) t += cur[0].at(ly + dy, lx + dx);
        int v = t << (3 - ssx - ssy);
        L[i * w + j] = v;
        avg += v;
      }
    }
    int lavg = round2(avg, log2i(w) + log2i(h));
    Plane &P = cur[pl];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        if (starty + i >= P.h || startx + j >= P.w) continue;
        int dc = P.at(starty + i, startx + j);
        int sl = round2signed((int64_t)alpha * (L[i * w + j] - lavg), 6);
        P.at(starty + i, startx + j) = (uint8_t)clip1(dc + sl);
      }
  }

  // ----------------------------------------------------------- coefficients
  int32_t quant[1024];
  int plane_tx_type;
  int get_tx_set(int txsz) {
    int up = sqr_up(txsz);
    if (up > TX_32X32) return 0;
    if (is_inter) {
      if (fh.reduced_tx_set || up == TX_32X32) return 3;
      if (sqr(txsz) == TX_16X16) return 2;
      return 1;
    }
    if (up == TX_32X32) return 0;
    if (fh.reduced_tx_set) return 2;
    if (sqr(txsz) == TX_16X16) return 2;
    return 1;
  }
  static bool in_inter_set(int set, int t) {
    if (set == 1) return true;
    if (set == 2) { for (int i = 0; i < 12; i++) if (INTER_SET2_INV[i] == t) return true; return false; }
    if (set == 3) return t == IDTX || t == DCT_DCT;
    return t == DCT_DCT;
  }
  static bool in_intra_set(int set, int t) {
    if (set == 0) return t == DCT_DCT;
    if (set == 1) { for (int i = 0; i < 7; i++) if (TX_SET1_INV[i] == t) return true; return false; }
    for (int i = 0; i < 5; i++) if (TX_SET2_INV[i] == t) return true;
    return false;
  }
  int compute_tx_type(int pl, int txsz, int bx4, int by4) {
    if (lossless || sqr_up(txsz) > TX_32X32) return DCT_DCT;
    int set = get_tx_set(txsz);
    if (pl == 0) return tx_types[mi(by4, bx4)];
    if (is_inter) {
      int x4 = std::max(mi_col, bx4 << ssx), y4 = std::max(mi_row, by4 << ssy);
      int t = tx_types[mi(y4, x4)];
      if (!in_inter_set(set, t)) return DCT_DCT;
      return t;
    }
    int t = MODE_TO_TXFM[uvmode];
    if (!in_intra_set(set, t)) return DCT_DCT;
    return t;
  }
  static int tx_class(int t) {
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return TX_CLASS_VERT;
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return TX_CLASS_HORIZ;
    return TX_CLASS_2D;
  }
  const int16_t *get_scan(int txsz) {
    if (txsz == TX_16X64) return AV1_SCAN_16X32;
    if (txsz == TX_64X16) return AV1_SCAN_32X16;
    if (sqr_up(txsz) == TX_64X64) return AV1_SCAN_32X32;
    int w = TXW[txsz], h = TXH[txsz];
    if (plane_tx_type != IDTX) {
      int cls = tx_class(plane_tx_type);
      static thread_local int16_t mscan[1024];
      if (cls == TX_CLASS_VERT) {  // mrow: raster order
        for (int i = 0; i < w * h; i++) mscan[i] = (int16_t)i;
        return mscan;
      }
      if (cls == TX_CLASS_HORIZ) {  // mcol: column by column
        int k = 0;
        for (int c = 0; c < w; c++) for (int r = 0; r < h; r++) mscan[k++] = (int16_t)(r * w + c);
        return mscan;
      }
    }
    switch (txsz) {
      case TX_4X4: return AV1_SCAN_4X4;
      case TX_8X8: return AV1_SCAN_8X8;
      case TX_16X16: return AV1_SCAN_16X16;
      case TX_32X32: return AV1_SCAN_32X32;
      case TX_4X8: return AV1_SCAN_4X8;
      case TX_8X4: return AV1_SCAN_8X4;
      case TX_8X16: return AV1_SCAN_8X16;
      case TX_16X8: return AV1_SCAN_16X8;
      case TX_16X32: return AV1_SCAN_16X32;
      case TX_32X16: return AV1_SCAN_32X16;
      case TX_4X16: return AV1_SCAN_4X16;
      case TX_16X4: return AV1_SCAN_16X4;
      case TX_8X32: return AV1_SCAN_8X32;
      default: return AV1_SCAN_32X8;
    }
  }
  int coeff_base_ctx_offset(int txsz, int row, int col) {
    int w = TXW[txsz], h = TXH[txsz];
    row = std::min(row, 4); col = std::min(col, 4);
    if (row == 0 && col == 0) return 0;
    if (w == h) {
      int s = row + col;
      return s == 1 ? 1 : s <= 3 ? 6 : 21;  // hmm: (1,1) is 6
    }
    if (w > h) {
      if (col < 2) return 16;
      return row + col <= 3 ? 6 : 21;
    }
    if (row < 2) return 11;
    return row + col <= 3 ? 6 : 21;
  }
  int adjusted(int txsz) {
    switch (txsz) {
      case TX_64X64: case TX_32X64: case TX_64X32: return TX_32X32;
      case TX_16X64: return TX_16X32;
      case TX_64X16: return TX_32X16;
      default: return txsz;
    }
  }
  int coeffs(int startx, int starty, int pl, int txsz) {
    int x4 = startx >> 2, y4 = starty >> 2, w4 = TXW[txsz] >> 2, h4 = TXH[txsz] >> 2;
    int sqr_c = sqr(txsz), up = sqr_up(txsz);
    int txsz_ctx = (sqr_c + up + 1) >> 1;
    int ptype = pl > 0;
    int seg_eob = (txsz == TX_16X64 || txsz == TX_64X16) ? 512 : std::min(1024, TXW[txsz] * TXH[txsz]);
    memset(quant, 0, sizeof(int32_t) * seg_eob);
    int eob = 0, cul = 0, dc_cat = 0;
    int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
    int maxx4 = mi_cols, maxy4 = mi_rows;
    if (pl) { maxx4 >>= sx; maxy4 >>= sy; }  // spec: maxX4 >> subsampling
    // all_zero context
    int ctx;
    int w = TXW[txsz], h = TXH[txsz];
    int bsz = plane_res_size(msize, pl);
    int bw = BW[bsz], bh = BH[bsz];
    if (pl == 0) {
      int top = 0, left = 0;
      for (int k = 0; k < w4; k++) if (x4 + k < maxx4) top = std::max(top, (int)above_level[pl][x4 + k]);
      for (int k = 0; k < h4; k++) if (y4 + k < maxy4) left = std::max(left, (int)left_level[pl][y4 + k]);
      top = std::min(top, 255); left = std::min(left, 255);
      if (bw == w && bh == h) ctx = 0;
      else if (top == 0 && left == 0) ctx = 1;
      else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
      else if (std::max(top, left) <= 3) ctx = 4;
      else if (std::min(top, left) <= 3) ctx = 5;
      else ctx = 6;
    } else {
      int above = 0, left = 0;
      for (int i = 0; i < w4; i++) if (x4 + i < maxx4) { above |= above_level[pl][x4 + i]; above |= above_dc[pl][x4 + i]; }
      for (int i = 0; i < h4; i++) if (y4 + i < maxy4) { left |= left_level[pl][y4 + i]; left |= left_dc[pl][y4 + i]; }
      ctx = (above != 0) + (left != 0) + 7;
      if (bw * bh > w * h) ctx += 3;
    }
    int all_zero = sd.symbol(cdf.txb_skip[txsz_ctx][ctx], 2);
    if (all_zero) {
      if (pl == 0)
        for (int i = 0; i < w4; i++)
          for (int j = 0; j < h4; j++)
            if (y4 + j < mi_rows && x4 + i < mi_cols) tx_types[mi(y4 + j, x4 + i)] = DCT_DCT;
    } else {
      if (pl == 0) transform_type(x4, y4, txsz);
      plane_tx_type = compute_tx_type(pl, txsz, x4, y4);
      count(C_TXTYPE + plane_tx_type);
      count(C_TXSIZE + txsz);
      const int16_t *scan = get_scan(txsz);
      int eob_multi = std::min(log2i(TXW[txsz]), 5) + std::min(log2i(TXH[txsz]), 5) - 4;
      int cls = tx_class(plane_tx_type);
      int mctx = cls == TX_CLASS_2D ? 0 : 1;
      int eob_pt;
      switch (eob_multi) {
        case 0: eob_pt = sd.symbol(cdf.eob16[ptype][mctx], 5); break;
        case 1: eob_pt = sd.symbol(cdf.eob32[ptype][mctx], 6); break;
        case 2: eob_pt = sd.symbol(cdf.eob64[ptype][mctx], 7); break;
        case 3: eob_pt = sd.symbol(cdf.eob128[ptype][mctx], 8); break;
        case 4: eob_pt = sd.symbol(cdf.eob256[ptype][mctx], 9); break;
        case 5: eob_pt = sd.symbol(cdf.eob512[ptype][mctx], 10); break;
        default: eob_pt = sd.symbol(cdf.eob1024[ptype][mctx], 11); break;
      }
      eob_pt += 1;
      eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
      int shift = eob_pt - 3;
      if (shift >= 0) {
        if (sd.symbol(cdf.eob_extra[txsz_ctx][ptype][eob_pt - 3], 2)) eob += 1 << shift;
        for (int i = 1; i < std::max(0, eob_pt - 2); i++) {
          shift = std::max(0, eob_pt - 2) - 1 - i;
          if (sd.literal(1)) eob += 1 << shift;
        }
      }
      int adj = adjusted(txsz);
      int bwl = log2i(TXW[adj]), txh = TXH[adj], txw = TXW[adj];
      for (int c = eob - 1; c >= 0; c--) {
        int pos = scan[c];
        int level;
        int row = pos >> bwl, col = pos - (row << bwl);
        if (c == eob - 1) {
          int ec;
          if (c == 0) ec = 0;
          else if (c <= (txh << bwl) / 8) ec = 1;
          else if (c <= (txh << bwl) / 4) ec = 2;
          else ec = 3;
          level = sd.symbol(cdf.base_eob[txsz_ctx][ptype][ec], 3) + 1;
        } else {
          int mag = 0;
          for (int k = 0; k < 5; k++) {
            int rr = row + SIG_REF[cls][k][0], cc = col + SIG_REF[cls][k][1];
            if (rr >= 0 && cc >= 0 && rr < txh && cc < (1 << bwl))
              mag += std::min(std::abs(quant[(rr << bwl) + cc]), 3);
          }
          int bctx = std::min((mag + 1) >> 1, 4);
          if (cls == TX_CLASS_2D) {
            if (row == 0 && col == 0) bctx = 0;
            else bctx += coeff_base_ctx_offset(txsz, row, col);
          } else {
            int idx = cls == TX_CLASS_VERT ? row : col;
            bctx += 26 + 5 * std::min(idx, 2);
          }
          level = sd.symbol(cdf.base[txsz_ctx][ptype][bctx], 4);
        }
        if (level > 2) {
          int mag = 0;
          for (int k = 0; k < 3; k++) {
            int rr = row + MAG_REF[cls][k][0], cc = col + MAG_REF[cls][k][1];
            if (rr >= 0 && cc >= 0 && rr < txh && cc < (1 << bwl))
              mag += std::min(quant[rr * txw + cc], 15);
          }
          mag = std::min((mag + 1) >> 1, 6);
          int brctx;
          if (pos == 0) brctx = mag;
          else if (cls == TX_CLASS_2D) brctx = (row < 2 && col < 2) ? mag + 7 : mag + 14;
          else if (cls == TX_CLASS_HORIZ) brctx = col == 0 ? mag + 7 : mag + 14;
          else brctx = row == 0 ? mag + 7 : mag + 14;
          for (int idx = 0; idx < 4; idx++) {
            int br = sd.symbol(cdf.br[std::min(txsz_ctx, 3)][ptype][brctx], 4);
            level += br;
            if (br < 3) break;
          }
        }
        quant[pos] = level;
      }
      for (int c = 0; c < eob; c++) {
        int pos = scan[c];
        int sign = 0;
        if (quant[pos] != 0) {
          if (c == 0) {
            int dcs = 0;
            for (int k = 0; k < w4; k++) if (x4 + k < maxx4) { int s = above_dc[pl][x4 + k]; if (s == 1) dcs--; else if (s == 2) dcs++; }
            for (int k = 0; k < h4; k++) if (y4 + k < maxy4) { int s = left_dc[pl][y4 + k]; if (s == 1) dcs--; else if (s == 2) dcs++; }
            int dctx = dcs < 0 ? 1 : dcs > 0 ? 2 : 0;
            sign = sd.symbol(cdf.dc_sign[ptype][dctx], 2);
          } else sign = sd.literal(1);
        }
        if (quant[pos] > 14) {
          unsigned g = sd.golomb();
          quant[pos] = (int32_t)((g + 15) & 0xFFFFF);
        }
        if (pos == 0 && quant[pos] > 0) dc_cat = sign ? 1 : 2;
        quant[pos] &= 0xFFFFF;
        cul += quant[pos];
        if (sign) quant[pos] = -quant[pos];
      }
      cul = std::min(63, cul);
    }
    for (int i = 0; i < w4; i++) if (x4 + i < (int)above_level[pl].size()) { above_level[pl][x4 + i] = (uint8_t)cul; above_dc[pl][x4 + i] = (uint8_t)dc_cat; }
    for (int i = 0; i < h4; i++) if (y4 + i < (int)left_level[pl].size()) { left_level[pl][y4 + i] = (uint8_t)cul; left_dc[pl][y4 + i] = (uint8_t)dc_cat; }
    return eob;
  }
  void transform_type(int x4, int y4, int txsz) {
    int set = get_tx_set(txsz);
    int t = DCT_DCT;
    int q = fh.seg_enabled ? qindex(true, segment_id) : fh.base_q_idx;
    if (set > 0 && q > 0 && is_inter) {
      int s = sqr(txsz);
      if (set == 1) t = INTER_SET1_INV[sd.symbol(cdf.inter_tx1[s], 16)];
      else if (set == 2) t = INTER_SET2_INV[sd.symbol(cdf.inter_tx2[s], 12)];
      else t = sd.symbol(cdf.inter_tx3[s], 2) ? DCT_DCT : IDTX;
    } else if (set > 0 && q > 0) {
      int dir = use_filter_intra ? FILTER_INTRA_DIR[filter_intra_mode] : ymode;
      int s = sqr(txsz);
      if (set == 1) t = TX_SET1_INV[sd.symbol(cdf.tx1[s][dir], 7)];
      else t = TX_SET2_INV[sd.symbol(cdf.tx2[s][dir], 5)];
    }
    for (int i = 0; i < (TXW[txsz] >> 2); i++)
      for (int j = 0; j < (TXH[txsz] >> 2); j++)
        if (y4 + j < mi_rows && x4 + i < mi_cols) tx_types[mi(y4 + j, x4 + i)] = (uint8_t)t;
  }

  // ---------------------------------------------------------- reconstruction
  int last_eob;
  void reconstruct(int pl, int x, int y, int txsz) {
    int lw = log2i(TXW[txsz]), lh = log2i(TXH[txsz]);
    int w = 1 << lw, h = 1 << lh;
    int tw = std::min(32, w), th = std::min(32, h);
    int pels = w * h;
    int dq_shift = (pels > 256) + (pels > 1024);
    int q = qindex(false, segment_id);
    int dcq, acq;
    if (pl == 0) { dcq = AV1_DC_QLOOKUP[clip3(0, 255, q + fh.dq_y_dc)]; acq = AV1_AC_QLOOKUP[clip3(0, 255, q)]; }
    else if (pl == 1) { dcq = AV1_DC_QLOOKUP[clip3(0, 255, q + fh.dq_u_dc)]; acq = AV1_AC_QLOOKUP[clip3(0, 255, q + fh.dq_u_ac)]; }
    else { dcq = AV1_DC_QLOOKUP[clip3(0, 255, q + fh.dq_v_dc)]; acq = AV1_AC_QLOOKUP[clip3(0, 255, q + fh.dq_v_ac)]; }
    // the quantizer matrix (7.12.3): a 5-bit weight per position, for a
    // 2D transform type of a block that is not lossless, below level 15
    // (flat); libaom's weights run column by column
    const uint8_t *qm = nullptr;
    int qm_level = pl == 0 ? fh.qm_y : pl == 1 ? fh.qm_u : fh.qm_v;
    if (!lossless && qm_level < 15 && plane_tx_type < IDTX)
      qm = &AV1_QM[qm_level][pl > 0][AV1_QM_OFFSET[txsz]];
    static thread_local int32_t R[64 * 64];
    int32_t T[64];
    // dequantized coefficients in R (rows of th, stride w)
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) R[i * w + j] = 0;
    for (int i = 0; i < th; i++)
      for (int j = 0; j < tw; j++) {
        int32_t c = quant[i * tw + j];
        if (!c) continue;
        int64_t qv = (i == 0 && j == 0) ? dcq : acq;
        if (qm) qv = (qv * qm[j * th + i] + 16) >> 5;
        int64_t a = std::abs((int64_t)c);
        int64_t dq = ((a * qv) & 0xFFFFFF) >> dq_shift;
        if (c < 0) dq = std::min<int64_t>(dq, 32768), dq = -dq;
        else dq = std::min<int64_t>(dq, 32767);
        R[i * w + j] = (int32_t)dq;
      }
    int t = plane_tx_type;
    int flip_ud = t == FLIPADST_DCT || t == FLIPADST_ADST || t == V_FLIPADST || t == FLIPADST_FLIPADST;
    int flip_lr = t == DCT_FLIPADST || t == ADST_FLIPADST || t == H_FLIPADST || t == FLIPADST_FLIPADST;
    if (!lossless && t == DCT_DCT && last_eob == 1) {
      // dav1d's DC-only shortcut, which skips the intermediate clamps
      int64_t dc = R[0];
      if (std::abs(lw - lh) == 1) dc = (dc * 181 + 128) >> 8;
      dc = (dc * 181 + 128) >> 8;
      int rs = ROW_SHIFT[txsz];
      dc = (dc + ((1 << rs) >> 1)) >> rs;
      dc = (dc * 181 + 128 + 2048) >> 12;
      Plane &P = cur[pl];
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          if (y + i < P.h && x + j < P.w) P.at(y + i, x + j) = (uint8_t)clip1(P.at(y + i, x + j) + (int)dc);
      return;
    }
    if (lossless) {
      for (int i = 0; i < 4; i++) { for (int j = 0; j < 4; j++) T[j] = R[i * 4 + j]; iwht(T, 2); for (int j = 0; j < 4; j++) R[i * 4 + j] = T[j]; }
      for (int j = 0; j < 4; j++) { for (int i = 0; i < 4; i++) T[i] = R[i * 4 + j]; iwht(T, 0); for (int i = 0; i < 4; i++) R[i * 4 + j] = T[i]; }
    } else {
      Clamp rowc{-(1 << 15), (1 << 15) - 1};
      Clamp colc{-(1 << 15), (1 << 15) - 1};
      int rs = ROW_SHIFT[txsz];
      int rk = ROW_KIND[t], ck = COL_KIND[t];
      bool rect2 = std::abs(lw - lh) == 1;
      for (int i = 0; i < h; i++) {
        if (i >= 32) { for (int j = 0; j < w; j++) R[i * w + j] = 0; continue; }
        bool any = false;
        for (int j = 0; j < w; j++) { T[j] = R[i * w + j]; any |= T[j] != 0; }
        if (!any) continue;
        if (rect2) for (int j = 0; j < w; j++) T[j] = round2((int64_t)T[j] * 2896, 12);
        for (int j = 0; j < w; j++) T[j] = rowc(T[j]);
        tx1d(T, lw, rk, rowc);
        for (int j = 0; j < w; j++) R[i * w + j] = round2(T[j], rs);
      }
      for (int i = 0; i < h * w; i++) R[i] = colc(R[i]);
      for (int j = 0; j < w; j++) {
        for (int i = 0; i < h; i++) T[i] = R[i * w + j];
        tx1d(T, lh, ck, colc);
        for (int i = 0; i < h; i++) R[i * w + j] = round2(T[i], 4);
      }
    }
    Plane &P = cur[pl];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int xx = flip_lr ? w - j - 1 : j, yy = flip_ud ? h - i - 1 : i;
        if (y + yy < P.h && x + xx < P.w) P.at(y + yy, x + xx) = (uint8_t)clip1(P.at(y + yy, x + xx) + R[i * w + j]);
      }
  }

  // ------------------------------------------------------- deblocking (7.14)
  int lf_level(int r, int c, int pl, int pass) {
    size_t i = mi(r, c);
    int seg = seg_id[i];
    int dl = fh.delta_lf_multi ? (int8_t)delta_lf_a[pl == 0 ? pass : pl + 1][i] : (int8_t)delta_lf_a[0][i];
    int idx = pl == 0 ? pass : pl + 1;
    int base = clip3(0, 63, dl + fh.lf_level[idx]);
    int lvl = base;
    if (seg_feature(seg, 1 + idx)) lvl = clip3(0, 63, lvl + fh.seg_feature_data[seg * 8 + 1 + idx]);
    if (fh.lf_delta_enabled) {
      int nshift = lvl >> 5;
      lvl = clip3(0, 63, lvl + (fh.lf_ref_deltas[0] * (1 << nshift)));
    }
    return lvl;
  }
  void deblock() {
    if (!fh.lf_level[0] && !fh.lf_level[1]) return;
    count(C_DEBLOCK);
    for (int pl = 0; pl < planes; pl++) {
      if (pl && !fh.lf_level[1 + pl]) continue;
      int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
      for (int pass = 0; pass < 2; pass++)
        for (int row = 0; row < mi_rows; row += (1 << sy))
          for (int col = 0; col < mi_cols; col += (1 << sx))
            edge(pl, pass, row, col, sx, sy);
    }
  }
  void edge(int pl, int pass, int row, int col, int sx, int sy) {
    int dx = pass == 0, dy = pass == 1;
    int x = col * 4, y = row * 4;
    row |= sy; col |= sx;
    if (x >= fh.width || y >= fh.height) return;
    if (pass == 0 && x == 0) return;
    if (pass == 1 && y == 0) return;
    int xp = x >> sx, yp = y >> sy;
    int prow = row - (dy << sy), pcol = col - (dx << sx);
    size_t i = mi(row, col);
    int bs = mi_size[i];
    int txsz = lf_txsz[pl][(size_t)(row >> sy) * mi_cols + (col >> sx)];
    int psz = plane_res_size(bs, pl);
    int skp = skip_a[i], intra = !is_inter_a[i];
    int ptx = lf_txsz[pl][(size_t)(prow >> sy) * mi_cols + (pcol >> sx)];
    int is_block_edge = pass == 0 ? xp % BW[psz] == 0 : yp % BH[psz] == 0;
    int is_tx_edge = pass == 0 ? xp % TXW[txsz] == 0 : yp % TXH[txsz] == 0;
    // only a skipped inter (intra block copy) block keeps its inner
    // transform edges unfiltered
    int apply = is_tx_edge && (is_block_edge || !skp || intra);
    int base = pass == 0 ? std::min(TXW[ptx], TXW[txsz]) : std::min(TXH[ptx], TXH[txsz]);
    int fsize = pl == 0 ? std::min(16, base) : std::min(8, base);
    int lvl = lf_level(row, col, pl, pass);
    if (lvl == 0) lvl = lf_level(prow, pcol, pl, pass);
    if (!apply || lvl == 0) return;
    int sh = fh.lf_sharpness > 4 ? 2 : fh.lf_sharpness > 0 ? 1 : 0;
    int limit = fh.lf_sharpness > 0 ? clip3(1, 9 - fh.lf_sharpness, lvl >> sh) : std::max(1, lvl >> sh);
    int blimit = 2 * (lvl + 2) + limit;
    int thresh = lvl >> 4;
    for (int k = 0; k < 4; k++) sample_filter(pl, xp + dy * k, yp + dx * k, limit, blimit, thresh, dx, dy, fsize);
  }
  void sample_filter(int pl, int x, int y, int limit, int blimit, int thresh, int dx, int dy, int fsize) {
    Plane &P = cur[pl];
    auto Q = [&](int k) -> int { return P.at(y + dy * k, x + dx * k); };
    auto Pp = [&](int k) -> int { return P.at(y - dy * (k + 1), x - dx * (k + 1)); };
    int q0 = Q(0), q1 = Q(1), p0 = Pp(0), p1 = Pp(1);
    int hev = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
    int mask = std::abs(p1 - p0) <= limit && std::abs(q1 - q0) <= limit && std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 <= blimit;
    int flat = 0, flat2 = 0;
    int len = pl == 0 ? fsize : (fsize == 8 ? 6 : fsize);
    if (len >= 6) {
      int q2 = Q(2), p2 = Pp(2);
      mask = mask && std::abs(p2 - p1) <= limit && std::abs(q2 - q1) <= limit;
      flat = std::abs(p1 - p0) <= 1 && std::abs(q1 - q0) <= 1 && std::abs(p2 - p0) <= 1 && std::abs(q2 - q0) <= 1;
      if (len >= 8) {
        int q3 = Q(3), p3 = Pp(3);
        mask = mask && std::abs(p3 - p2) <= limit && std::abs(q3 - q2) <= limit;
        flat = flat && std::abs(p3 - p0) <= 1 && std::abs(q3 - q0) <= 1;
      }
      if (len == 16) {
        flat2 = std::abs(Pp(6) - p0) <= 1 && std::abs(Q(6) - q0) <= 1 && std::abs(Pp(5) - p0) <= 1 &&
                std::abs(Q(5) - q0) <= 1 && std::abs(Pp(4) - p0) <= 1 && std::abs(Q(4) - q0) <= 1;
      }
    }
    if (!mask) return;
    if (fsize == 4 || !flat) {
      auto c4 = [](int v) { return clip3(-128, 127, v); };
      int ps1 = p1 - 128, ps0 = p0 - 128, qs0 = q0 - 128, qs1 = q1 - 128;
      int f = hev ? c4(ps1 - qs1) : 0;
      f = c4(f + 3 * (qs0 - ps0));
      int f1 = c4(f + 4) >> 3, f2 = c4(f + 3) >> 3;
      P.at(y, x) = (uint8_t)(c4(qs0 - f1) + 128);
      P.at(y - dy, x - dx) = (uint8_t)(c4(ps0 + f2) + 128);
      if (!hev) {
        f = round2(f1, 1);
        P.at(y + dy, x + dx) = (uint8_t)(c4(qs1 - f) + 128);
        P.at(y - 2 * dy, x - 2 * dx) = (uint8_t)(c4(ps1 + f) + 128);
      }
    } else {
      int lg = (fsize == 8 || !flat2) ? 3 : 4;
      int n = lg == 4 ? 6 : pl == 0 ? 3 : 2;
      int n2 = (lg == 3 && pl == 0) ? 0 : 1;
      int F[16], out[16];
      for (int k = -(n + 1); k <= n; k++) F[k + 8] = k >= 0 ? Q(k) : Pp(-k - 1);
      for (int ii = -n; ii < n; ii++) {
        int t = 0;
        for (int j = -n; j <= n; j++) {
          int p = clip3(-(n + 1), n, ii + j);
          int tap = std::abs(j) <= n2 ? 2 : 1;
          t += F[p + 8] * tap;
        }
        out[ii + 8] = round2(t, lg);
      }
      for (int ii = -n; ii < n; ii++) {
        if (ii >= 0) P.at(y + dy * ii, x + dx * ii) = (uint8_t)out[ii + 8];
        else P.at(y - dy * (-ii), x - dx * (-ii)) = (uint8_t)out[ii + 8];
      }
    }
  }

  // ------------------------------------------------------------ CDEF (7.15)
  std::vector<uint8_t> dbk[3];  // the deblocked frame, when CDEF runs
  bool cdef_ran = false;
  void cdef() {
    if (!cdef_on()) return;
    bool any = false;
    for (size_t i = 0; i < cdef_idx.size(); i++) any |= cdef_idx[i] != -1;
    if (!any) return;
    count(C_CDEF);
    for (int pl = 0; pl < planes; pl++) dbk[pl] = cur[pl].px;
    cdef_ran = true;
    for (int r = 0; r < mi_rows; r += 2)
      for (int c = 0; c < mi_cols; c += 2) {
        int idx = cdef_idx[(size_t)(r >> 4) * cdef_stride + (c >> 4)];
        if (idx == -1) continue;
        bool sk = skip_a[mi(r, c)] && skip_a[mi(r + 1, c)] && skip_a[mi(r, c + 1)] && skip_a[mi(r + 1, c + 1)];
        if (sk) continue;
        int var, ydir = cdef_direction(r, c, var);
        int pri = fh.cdef_y_pri[idx], sec = fh.cdef_y_sec[idx];
        int dir = pri == 0 ? 0 : ydir;
        int varstr = (var >> 6) ? std::min(log2i(var >> 6), 12) : 0;
        pri = var ? (pri * (4 + varstr) + 8) >> 4 : 0;
        cdef_filter(0, r, c, pri, sec, fh.cdef_damping, dir);
        if (planes == 1) continue;
        pri = fh.cdef_uv_pri[idx]; sec = fh.cdef_uv_sec[idx];
        dir = pri == 0 ? 0 : (ssx && !ssy ? AV1_CDEF_UV_DIR_422[ydir] : ydir);
        cdef_filter(1, r, c, pri, sec, fh.cdef_damping - 1, dir);
        cdef_filter(2, r, c, pri, sec, fh.cdef_damping - 1, dir);
      }
  }
  int cdef_direction(int r, int c, int &var) {
    int cost[8] = {0}, partial[8][15] = {{0}};
    int x0 = c * 4, y0 = r * 4;
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) {
        int x = dbk[0][(size_t)(y0 + i) * cur[0].w + x0 + j] - 128;
        partial[0][i + j] += x;
        partial[1][i + j / 2] += x;
        partial[2][i] += x;
        partial[3][3 + i - j / 2] += x;
        partial[4][7 + i - j] += x;
        partial[5][3 - i / 2 + j] += x;
        partial[6][j] += x;
        partial[7][i / 2 + j] += x;
      }
    const int32_t *D = AV1_CDEF_DIV_TABLE;
    for (int i = 0; i < 8; i++) { cost[2] += partial[2][i] * partial[2][i]; cost[6] += partial[6][i] * partial[6][i]; }
    cost[2] *= D[8]; cost[6] *= D[8];
    for (int i = 0; i < 7; i++) {
      cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * D[i + 1];
      cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * D[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * D[8];
    cost[4] += partial[4][7] * partial[4][7] * D[8];
    for (int i = 1; i < 8; i += 2) {
      for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
      cost[i] *= D[8];
      for (int j = 0; j < 3; j++)
        cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) * D[2 * j + 2];
    }
    int best = 0, ydir = 0;
    for (int i = 0; i < 8; i++) if (cost[i] > best) { best = cost[i]; ydir = i; }
    var = (best - cost[(ydir + 4) & 7]) >> 10;
    return ydir;
  }
  static int constrain(int diff, int thr, int damping) {
    if (!thr) return 0;
    int adj = std::max(0, damping - log2i(thr));
    int val = std::min(std::abs(diff), std::max(0, thr - (std::abs(diff) >> adj)));
    return diff < 0 ? -val : val;
  }
  void cdef_filter(int pl, int r, int c, int pri, int sec, int damping, int dir) {
    int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
    int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy, w = 8 >> sx, h = 8 >> sy;
    const std::vector<uint8_t> &src = dbk[pl];
    int stride = cur[pl].w;
    auto get = [&](int i, int j, bool &ok) -> int {
      int y = y0 + i, x = x0 + j;
      int cr = (y << sy) >> 2, cc = (x << sx) >> 2;
      ok = y >= 0 && x >= 0 && cr < mi_rows && cc < mi_cols;
      return ok ? src[(size_t)y * stride + x] : 0;
    };
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int x = src[(size_t)(y0 + i) * stride + x0 + j];
        int sum = 0, mx = x, mn = x;
        for (int k = 0; k < 2; k++)
          for (int sign = -1; sign <= 1; sign += 2) {
            bool ok;
            int p = get(i + sign * AV1_CDEF_DIRECTIONS[dir][k][0], j + sign * AV1_CDEF_DIRECTIONS[dir][k][1], ok);
            if (ok) {
              sum += AV1_CDEF_PRI_TAPS[pri & 1][k] * constrain(p - x, pri, damping);
              mx = std::max(p, mx); mn = std::min(p, mn);
            }
            for (int off = -2; off <= 2; off += 4) {
              int d2 = (dir + off) & 7;
              int s2 = get(i + sign * AV1_CDEF_DIRECTIONS[d2][k][0], j + sign * AV1_CDEF_DIRECTIONS[d2][k][1], ok);
              if (ok) {
                sum += AV1_CDEF_SEC_TAPS[pri & 1][k] * constrain(s2 - x, sec, damping);
                mx = std::max(s2, mx); mn = std::min(s2, mn);
              }
            }
          }
        cur[pl].at(y0 + i, x0 + j) = (uint8_t)clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4));
      }
  }

  // ------------------------------------------------ loop restoration (7.17)
  std::vector<uint8_t> pre[3];  // the frame before restoration
  int stripe_start, stripe_end, plane_end_x, plane_end_y;
  int src(int pl, int x, int y) {
    x = std::max(0, std::min(plane_end_x, x));
    y = std::max(0, std::min(plane_end_y, y));
    if (y < stripe_start || y > stripe_end) {
      y = y < stripe_start ? std::max(stripe_start - 2, y) : std::min(stripe_end + 2, y);
      // outside the stripe: the deblocked frame, before CDEF
      return (cdef_ran ? dbk[pl] : pre[pl])[(size_t)y * cur[pl].w + x];
    }
    return pre[pl][(size_t)y * cur[pl].w + x];
  }
  void restore() {
    bool any = false;
    for (int pl = 0; pl < planes; pl++) any |= fh.lr_type[pl] != RESTORE_NONE;
    if (!any) return;
    for (int pl = 0; pl < planes; pl++) pre[pl] = cur[pl].px;
    for (int y = 0; y < fh.height; y += 4)
      for (int x = 0; x < fh.width; x += 4)
        for (int pl = 0; pl < planes; pl++)
          if (fh.lr_type[pl] != RESTORE_NONE) restore_block(pl, y >> 2, x >> 2);
  }
  void restore_block(int pl, int row, int col) {
    int sx = pl ? ssx : 0, sy = pl ? ssy : 0;
    if ((sx && (col & 1)) || (sy && (row & 1))) return;  // a chroma sample pair
    int luma_y = row * 4;
    int stripe = (luma_y + 8) / 64;
    stripe_start = (-8 + stripe * 64) >> sy;
    stripe_end = stripe_start + (64 >> sy) - 1;
    int usize = fh.lr_size[pl];
    int urows = lr_unit_rows[pl], ucols = lr_unit_cols[pl];
    int ur = std::min(urows - 1, ((row * 4 + 8) >> sy) / usize);
    int uc = std::min(ucols - 1, ((col * 4) >> sx) / usize);
    plane_end_x = round2(fh.width, sx) - 1;
    plane_end_y = round2(fh.height, sy) - 1;
    int x = (col * 4) >> sx, y = (row * 4) >> sy;
    int w = std::min(4 >> sx, plane_end_x - x + 1), h = std::min(4 >> sy, plane_end_y - y + 1);
    // a chroma step of two luma units covers 4 >> s samples twice over
    if (sx) w = std::min(4, plane_end_x - x + 1);
    if (sy) h = std::min(4, plane_end_y - y + 1);
    size_t u = (size_t)ur * ucols + uc;
    int t = lr_type[pl][u];
    const int16_t *co = &lr_coef[pl][u * 8];
    if (t == RESTORE_WIENER) wiener(pl, co, x, y, w, h);
    else if (t == RESTORE_SGRPROJ) sgr(pl, co, x, y, w, h);
  }
  void wiener(int pl, const int16_t *co, int x, int y, int w, int h) {
    int vf[7], hf[7];
    for (int pass = 0; pass < 2; pass++) {
      int *f = pass == 0 ? vf : hf;
      f[3] = 128;
      for (int i = 0; i < 3; i++) { int c = co[pass * 3 + i]; f[i] = c; f[6 - i] = c; f[3] -= 2 * c; }
    }
    int inter[10][4];
    const int offset = 1 << (8 + 7 - 3 - 1), limit = (1 << (8 + 1 + 7 - 3)) - 1;
    for (int r = 0; r < h + 6; r++)
      for (int c = 0; c < w; c++) {
        int sum = 0;
        for (int t = 0; t < 7; t++) sum += hf[t] * src(pl, x + c + t - 3, y + r - 3);
        int v = round2(sum, 3);
        inter[r][c] = clip3(-offset, limit - offset, v);
      }
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        int sum = 0;
        for (int t = 0; t < 7; t++) sum += vf[t] * inter[r + t][c];
        cur[pl].at(y + r, x + c) = (uint8_t)clip1(round2(sum, 11));
      }
  }
  void box(int pl, int x, int y, int w, int h, int set, int pass, int F[4][4]) {
    int r = AV1_SGR_PARAMS[set][pass * 2];
    int64_t s = AV1_SGR_PARAMS[set][pass * 2 + 1];
    int n = (2 * r + 1) * (2 * r + 1);
    int A[6][6], B[6][6];
    int one_over_n = ((1 << 12) + (n / 2)) / n;
    for (int i = -1; i < h + 1; i++)
      for (int j = -1; j < w + 1; j++) {
        int64_t a = 0, b = 0;
        for (int dy = -r; dy <= r; dy++)
          for (int dx = -r; dx <= r; dx++) {
            int c = src(pl, x + j + dx, y + i + dy);
            a += c * c; b += c;
          }
        int64_t p = std::max<int64_t>(0, a * n - b * b);
        int64_t z = (p * s + (1 << 19)) >> 20;
        int a2;
        if (z >= 255) a2 = 256;
        else if (z == 0) a2 = 1;
        else a2 = (int)(((z << 8) + (z / 2)) / (z + 1));
        int64_t b2 = (int64_t)((1 << 8) - a2) * b * one_over_n;
        A[i + 1][j + 1] = a2;
        B[i + 1][j + 1] = (int)((b2 + (1 << 11)) >> 12);
      }
    for (int i = 0; i < h; i++) {
      int shift = 5;
      if (pass == 0 && (i & 1)) shift = 4;
      for (int j = 0; j < w; j++) {
        int64_t a = 0, b = 0;
        for (int dy = -1; dy <= 1; dy++)
          for (int dx = -1; dx <= 1; dx++) {
            int wt;
            if (pass == 0) wt = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
            else wt = (dx == 0 || dy == 0) ? 4 : 3;
            a += wt * A[i + dy + 1][j + dx + 1];
            b += wt * B[i + dy + 1][j + dx + 1];
          }
        int64_t v = a * pre[pl][(size_t)(y + i) * cur[pl].w + x + j] + b;
        F[i][j] = round2(v, 8 + shift - 4);
      }
    }
  }
  void sgr(int pl, const int16_t *co, int x, int y, int w, int h) {
    int set = co[6];
    int F0[4][4], F1[4][4];
    int r0 = AV1_SGR_PARAMS[set][0], r1 = AV1_SGR_PARAMS[set][2];
    if (r0) box(pl, x, y, w, h, set, 0, F0);
    if (r1) box(pl, x, y, w, h, set, 1, F1);
    int w0 = co[0], w1 = co[1], w2 = (1 << 7) - w0 - w1;
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int64_t u = (int64_t)pre[pl][(size_t)(y + i) * cur[pl].w + x + j] << 4;
        int64_t v = w1 * u;
        v += r0 ? (int64_t)w0 * F0[i][j] : w0 * u;
        v += r1 ? (int64_t)w2 * F1[i][j] : w2 * u;
        cur[pl].at(y + i, x + j) = (uint8_t)clip1(round2(v, 4 + 7));
      }
  }
};

// ---------------------------------------------------------------------------
// film grain synthesis (7.18.3), as dav1d's filmgrain_tmpl.c and
// fg_apply_tmpl.c lay it out for 8-bit samples: the grain templates from
// the 16-bit LFSR and the gaussian sequence, the auto-regressive filter,
// the scaling LUTs, then 32x32 blocks at random offsets into the
// templates, blended where blocks overlap, scaled and clipped
// ---------------------------------------------------------------------------
const int GRAIN_W = 82, GRAIN_H = 73, SUB_GRAIN_W = 44, SUB_GRAIN_H = 38;
const int FG_BLOCK = 32;
typedef int16_t GrainLut[GRAIN_H + 1][GRAIN_W];

inline int grain_random(int bits, unsigned *state) {
  const unsigned r = *state;
  const unsigned bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
  *state = (r >> 1) | (bit << 15);
  return (*state >> (16 - bits)) & ((1 << bits) - 1);
}
inline int fg_round2(int x, int shift) { return (x + ((1 << shift) >> 1)) >> shift; }

void grain_y(GrainLut &buf, const FrameHeader &g) {
  unsigned seed = (unsigned)g.grain_seed;
  const int shift = 4 + g.grain_scale_shift;
  for (int y = 0; y < GRAIN_H; y++)
    for (int x = 0; x < GRAIN_W; x++)
      buf[y][x] = (int16_t)fg_round2(AV1_GAUSSIAN_SEQUENCE[grain_random(11, &seed)], shift);
  const int lag = g.ar_coeff_lag;
  for (int y = 3; y < GRAIN_H; y++)
    for (int x = 3; x < GRAIN_W - 3; x++) {
      const int32_t *coeff = g.ar_coeffs_y;
      int sum = 0;
      for (int dy = -lag; dy <= 0; dy++)
        for (int dx = -lag; dx <= lag; dx++) {
          if (!dx && !dy) break;
          sum += *(coeff++) * buf[y + dy][x + dx];
        }
      buf[y][x] = (int16_t)clip3(-128, 127, buf[y][x] + fg_round2(sum, g.ar_coeff_shift));
    }
}

void grain_uv(GrainLut &buf, const GrainLut &buf_y, const FrameHeader &g,
              int uv, int subx, int suby) {
  unsigned seed = (unsigned)g.grain_seed ^ (uv ? 0x49d8 : 0xb524);
  const int shift = 4 + g.grain_scale_shift;
  const int cw = subx ? SUB_GRAIN_W : GRAIN_W, ch = suby ? SUB_GRAIN_H : GRAIN_H;
  for (int y = 0; y < ch; y++)
    for (int x = 0; x < cw; x++)
      buf[y][x] = (int16_t)fg_round2(AV1_GAUSSIAN_SEQUENCE[grain_random(11, &seed)], shift);
  const int lag = g.ar_coeff_lag;
  for (int y = 3; y < ch; y++)
    for (int x = 3; x < cw - 3; x++) {
      const int32_t *coeff = g.ar_coeffs_uv[uv];
      int sum = 0;
      for (int dy = -lag; dy <= 0; dy++)
        for (int dx = -lag; dx <= lag; dx++) {
          if (!dx && !dy) {
            // the current sample: the luma grain under it
            if (!g.num_y_points) break;
            int luma = 0;
            const int lx = ((x - 3) << subx) + 3, ly = ((y - 3) << suby) + 3;
            for (int i = 0; i <= suby; i++)
              for (int j = 0; j <= subx; j++) luma += buf_y[ly + i][lx + j];
            sum += fg_round2(luma, subx + suby) * *coeff;
            break;
          }
          sum += *(coeff++) * buf[y + dy][x + dx];
        }
      buf[y][x] = (int16_t)clip3(-128, 127, buf[y][x] + fg_round2(sum, g.ar_coeff_shift));
    }
}

void grain_scaling(const int32_t (*points)[2], int num, uint8_t scaling[256]) {
  if (num == 0) { memset(scaling, 0, 256); return; }
  memset(scaling, points[0][1], points[0][0]);
  for (int i = 0; i < num - 1; i++) {
    const int bx = points[i][0], by = points[i][1];
    const int dx = points[i + 1][0] - bx, dy = points[i + 1][1] - by;
    const int delta = dy * ((0x10000 + (dx >> 1)) / dx);
    for (int x = 0, d = 0x8000; x < dx; x++) {
      scaling[bx + x] = (uint8_t)(by + (d >> 16));
      d += delta;
    }
  }
  const int n = points[num - 1][0];
  memset(&scaling[n], points[num - 1][1], 256 - n);
}

inline int grain_at(const GrainLut &lut, const int off[2][2], int sx, int sy,
                    int bx, int by, int x, int y) {
  const int r = off[bx][by];
  const int ox = 3 + (2 >> sx) * (3 + (r >> 4)), oy = 3 + (2 >> sy) * (3 + (r & 15));
  return lut[oy + y + (FG_BLOCK >> sy) * by][ox + x + (FG_BLOCK >> sx) * bx];
}

// One row of 32x32 luma blocks (row `row_num`, `bh` rows high) of a plane
// of width `pw`, or of chroma blocks (`luma` set, the frame's luma rows
// of the same blocks, `lw` wide): the noise of each sample, added and
// clipped. `src` and `dst` have a stride of `stride`.
void grain_rows(uint8_t *dst, const uint8_t *src, int stride, int pw,
                const FrameHeader &g, const uint8_t scaling[256],
                const GrainLut &lut, int bh, int row_num, const uint8_t *luma,
                int lstride, int lw, int uv, int sx, int sy, bool is_id) {
  const int rows = 1 + (g.overlap_flag && row_num > 0);
  int lo = 0, hi = 255;
  if (g.clip_to_restricted_range) { lo = 16; hi = luma && !is_id ? 240 : 235; }
  unsigned seed[2];
  for (int i = 0; i < rows; i++) {
    seed[i] = (unsigned)g.grain_seed;
    seed[i] ^= (unsigned)((((row_num - i) * 37 + 178) & 0xFF) << 8);
    seed[i] ^= (unsigned)(((row_num - i) * 173 + 105) & 0xFF);
  }
  static const int w_luma[2][2] = {{27, 17}, {17, 27}};
  static const int w_sub[2][2] = {{23, 22}, {0, 0}};
  const int (*wx)[2] = sx ? w_sub : w_luma;
  const int (*wy)[2] = sy ? w_sub : w_luma;
  int off[2][2] = {{0, 0}, {0, 0}};
  auto blend = [](int old, int cur, const int *w) {
    return clip3(-128, 127, fg_round2(old * w[0] + cur * w[1], 5));
  };
  for (int bx = 0; bx < pw; bx += FG_BLOCK >> sx) {
    const int bw = std::min(FG_BLOCK >> sx, pw - bx);
    const int ystart = g.overlap_flag && row_num ? std::min(2 >> sy, bh) : 0;
    const int xstart = g.overlap_flag && bx ? std::min(2 >> sx, bw) : 0;
    if (g.overlap_flag && bx)
      for (int i = 0; i < rows; i++) off[1][i] = off[0][i];
    for (int i = 0; i < rows; i++) off[0][i] = grain_random(8, &seed[i]);
    auto add = [&](int x, int y, int grain) {
      const int s = src[(size_t)y * stride + bx + x];
      int val = s;
      if (luma) {
        const int lx = std::min((bx + x) << sx, lw - 1);
        const uint8_t *l = luma + (size_t)(y << sy) * lstride;
        int avg = l[lx];
        if (sx) avg = (avg + l[std::min(lx + 1, lw - 1)] + 1) >> 1;
        val = avg;
        if (!g.chroma_scaling_from_luma)
          val = clip1(((avg * g.uv_luma_mult[uv] + s * g.uv_mult[uv]) >> 6) + g.uv_offset[uv]);
      }
      const int noise = fg_round2(scaling[val] * grain, g.scaling_shift);
      dst[(size_t)y * stride + bx + x] = (uint8_t)clip3(lo, hi, s + noise);
    };
    for (int y = ystart; y < bh; y++) {
      for (int x = xstart; x < bw; x++) add(x, y, grain_at(lut, off, sx, sy, 0, 0, x, y));
      for (int x = 0; x < xstart; x++)
        add(x, y, blend(grain_at(lut, off, sx, sy, 1, 0, x, y), grain_at(lut, off, sx, sy, 0, 0, x, y), wx[x]));
    }
    for (int y = 0; y < ystart; y++) {
      for (int x = xstart; x < bw; x++)
        add(x, y, blend(grain_at(lut, off, sx, sy, 0, 1, x, y), grain_at(lut, off, sx, sy, 0, 0, x, y), wy[y]));
      for (int x = 0; x < xstart; x++) {
        const int top = blend(grain_at(lut, off, sx, sy, 1, 1, x, y), grain_at(lut, off, sx, sy, 0, 1, x, y), wx[x]);
        const int cur = blend(grain_at(lut, off, sx, sy, 1, 0, x, y), grain_at(lut, off, sx, sy, 0, 0, x, y), wx[x]);
        add(x, y, blend(top, cur, wy[y]));
      }
    }
  }
}

// The frame's planes with grain added (dav1d's prep_grain and
// apply_grain_row over every row of blocks); nothing changes unless
// dav1d's has_grain holds. `y`, `u`, `v` are cropped planes.
void apply_grain(const FrameHeader &g, uint8_t *y, uint8_t *u, uint8_t *v) {
  if (!g.apply_grain || !(g.num_y_points || g.num_uv_points[0] ||
                          g.num_uv_points[1] ||
                          (g.clip_to_restricted_range && g.chroma_scaling_from_luma)))
    return;
  const int w = g.width, h = g.height, sx = g.ss_x, sy = g.ss_y;
  const int cw = (w + sx) >> sx;
  const bool chroma = g.num_planes > 1 &&
      (g.num_uv_points[0] || g.num_uv_points[1] || g.chroma_scaling_from_luma);
  std::vector<GrainLut> lut(3);
  uint8_t scaling[3][256];
  grain_y(lut[0], g);
  if (chroma) {
    for (int pl = 0; pl < 2; pl++)
      if (g.num_uv_points[pl] || g.chroma_scaling_from_luma) grain_uv(lut[1 + pl], lut[0], g, pl, sx, sy);
  }
  grain_scaling(g.y_points, g.num_y_points, scaling[0]);
  for (int pl = 0; pl < 2; pl++) grain_scaling(g.uv_points[pl], g.num_uv_points[pl], scaling[1 + pl]);
  // chroma reads the luma before its grain
  std::vector<uint8_t> luma(y, y + (size_t)w * h);
  const bool is_id = g.matrix_coefficients == 0;
  for (int row = 0; row * FG_BLOCK < h; row++) {
    const int bh = std::min(h - row * FG_BLOCK, FG_BLOCK);
    uint8_t *yr = y + (size_t)row * FG_BLOCK * w;
    if (g.num_y_points)
      grain_rows(yr, &luma[(size_t)row * FG_BLOCK * w], w, w, g, scaling[0], lut[0], bh, row, nullptr, 0, 0, 0, 0, 0, false);
    if (!chroma) continue;
    const int cbh = (bh + sy) >> sy;
    const size_t coff = (size_t)((row * FG_BLOCK) >> sy) * cw;
    const uint8_t *lr = &luma[(size_t)row * FG_BLOCK * w];
    for (int pl = 0; pl < 2; pl++) {
      if (!g.chroma_scaling_from_luma && !g.num_uv_points[pl]) continue;
      uint8_t *c = (pl ? v : u) + coff;
      grain_rows(c, c, cw, cw, g, scaling[g.chroma_scaling_from_luma ? 0 : 1 + pl], lut[1 + pl], cbh, row, lr, w, w, pl, sx, sy, is_id);
    }
  }
}

}  // namespace

extern "C" {

int rls_av1_census_size() { return C_COUNT; }

// libyuv's fixed-point YUV to RGB (YuvPixel) after its bilinear 2x chroma
// upsampling (I420/I422ToARGBMatrixFilter), as this libavif converts
// 8-bit BT.601, BT.709 and BT.2020 images; k holds YG, YB, UB, UG, VG, VR.
// u and v null: grey (I400ToARGBMatrix). rgb is (h, w, 3).
void rls_av1_yuv_rgb(const uint8_t *y, const uint8_t *u, const uint8_t *v,
                     int w, int h, int ssx, int ssy, const int32_t *k,
                     uint8_t *rgb) {
  const int yg = k[0], yb = k[1], ub = k[2], ug = k[3], vg = k[4], vr = k[5];
  const int cw = (w + ssx) >> ssx, ch = (h + ssy) >> ssy;
  std::vector<int> uu(w), vv(w);
  for (int r = 0; r < h; r++) {
    const uint8_t *yr = y + (size_t)r * w;
    uint8_t *out = rgb + (size_t)r * w * 3;
    if (!u) {
      for (int x = 0; x < w; x++) {
        int g = clip1((int)(((uint32_t)(yr[x] * 0x0101 * yg) >> 16) + yb) >> 6);
        out[3 * x] = out[3 * x + 1] = out[3 * x + 2] = (uint8_t)g;
      }
      continue;
    }
    int ny = ssy ? std::min(r >> 1, ch - 1) : r;
    int fy = ny;
    if (ssy) fy = clip3(0, ch - 1, (r & 1) ? (r >> 1) + 1 : (r >> 1) - 1);
    for (int x = 0; x < w; x++) {
      int nx = x, fx = x;
      if (ssx) {
        nx = std::min(x >> 1, cw - 1);
        fx = clip3(0, cw - 1, (x & 1) ? (x >> 1) + 1 : (x >> 1) - 1);
        if (x == 0 || x == w - 1) fx = nx;
      }
      const uint8_t *un = u + (size_t)ny * cw, *uf = u + (size_t)fy * cw;
      const uint8_t *vn = v + (size_t)ny * cw, *vf = v + (size_t)fy * cw;
      if (ssx && ssy) {
        uu[x] = (9 * un[nx] + 3 * un[fx] + 3 * uf[nx] + uf[fx] + 8) >> 4;
        vv[x] = (9 * vn[nx] + 3 * vn[fx] + 3 * vf[nx] + vf[fx] + 8) >> 4;
      } else if (ssx) {
        uu[x] = (3 * un[nx] + un[fx] + 2) >> 2;
        vv[x] = (3 * vn[nx] + vn[fx] + 2) >> 2;
      } else {
        uu[x] = un[x];
        vv[x] = vn[x];
      }
    }
    for (int x = 0; x < w; x++) {
      int y1 = (int)((uint32_t)(yr[x] * 0x0101 * yg) >> 16);
      int cu = uu[x] - 128, cv = vv[x] - 128;
      out[3 * x] = (uint8_t)clip1((y1 + vr * cv + yb) >> 6);
      out[3 * x + 1] = (uint8_t)clip1((y1 - ug * cu - vg * cv + yb) >> 6);
      out[3 * x + 2] = (uint8_t)clip1((y1 + ub * cu + yb) >> 6);
    }
  }
}

// libyuv's ARGBUnattenuate as its x86 rows compute it: the colour
// widened to 16 bits (times 257) times its table's 16-bit 1 / alpha, the
// high half packed to a byte with signed saturation (so at alpha 1 a
// colour of 128 or more becomes 0); alpha 0 gives 0 and libavif leaves
// alpha 255 alone
void rls_av1_unattenuate(uint8_t *rgb, const uint8_t *a, int n) {
  for (int i = 0; i < n; i++) {
    int al = a[i];
    if (al == 255) continue;
    uint32_t ia = al == 0 ? 0 : al == 1 ? 0xFFFF : 65536 / al;
    for (int c = 0; c < 3; c++) {
      uint8_t &p = rgb[3 * i + c];
      uint32_t v = ((uint32_t)p * 257 * ia) >> 16;
      p = (uint8_t)(v >= 32768 ? 0 : std::min<uint32_t>(v, 255));
    }
  }
}
const char *rls_av1_census_name(int i) { return census_name(i); }

// Decode the tiles of one intra frame. `hdr` is av1.py's header array,
// `tiles` (start, size) pairs into `data`; the planes are written cropped
// to the frame's size (u and v at the chroma size, none for 4:0:0).
// Returns 0, or a negative code for a malformed stream.
int rls_av1_decode(const uint8_t *data, const int32_t *hdr,
                   const int32_t *tiles, int n_tiles, uint8_t *y, uint8_t *u,
                   uint8_t *v, int64_t *census) {
  const FrameHeader &fh = *reinterpret_cast<const FrameHeader *>(hdr);
  Decoder *d = new Decoder(fh, census);
  if (n_tiles > 1 && census) census[C_TILES]++;
  for (int t = 0; t < n_tiles && !d->err; t++) {
    int row = t / fh.tile_cols, col = t % fh.tile_cols;
    d->mi_row_start = fh.mi_row_starts[row];
    d->mi_row_end = fh.mi_row_starts[row + 1];
    d->mi_col_start = fh.mi_col_starts[col];
    d->mi_col_end = fh.mi_col_starts[col + 1];
    init_cdfs(d->cdf, fh.base_q_idx);
    d->decode_tile(data + tiles[2 * t], tiles[2 * t + 1]);
  }
  int err = d->err;
  if (!err) {
    d->deblock();
    d->cdef();
    d->restore();
    int w = fh.width, h = fh.height;
    for (int r = 0; r < h; r++) memcpy(y + (size_t)r * w, &d->cur[0].px[(size_t)r * d->cur[0].w], w);
    if (fh.num_planes > 1) {
      int cw = (w + fh.ss_x) >> fh.ss_x, ch = (h + fh.ss_y) >> fh.ss_y;
      for (int r = 0; r < ch; r++) {
        memcpy(u + (size_t)r * cw, &d->cur[1].px[(size_t)r * d->cur[1].w], cw);
        memcpy(v + (size_t)r * cw, &d->cur[2].px[(size_t)r * d->cur[2].w], cw);
      }
    }
    apply_grain(fh, y, u, v);
  }
  delete d;
  return err;
}

}  // extern "C"
