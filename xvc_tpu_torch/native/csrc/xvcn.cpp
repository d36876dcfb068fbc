// xvcn: native host runtime for the sequential entropy-coding tail.
//
// Exact behavioral mirror of the Python reference implementation in
// xvc_tpu/cabac and xvc_tpu/syntax (which is itself bit-exact against
// reference xvc streams; ref: src/xvc_common_lib/context_model.cc,
// src/xvc_dec_lib/entropy_decoder.cc, src/xvc_enc_lib/entropy_encoder.cc,
// src/xvc_dec_lib/syntax_reader.cc, src/xvc_enc_lib/syntax_writer.cc,
// src/xvc_enc_lib/rdo_quant.cc).  CABAC is inherently sequential, so it
// runs on the host in C++ while the DSP runs as batched XLA/TPU programs;
// this file is the performance path, the Python twin is the validation
// path (native-on vs native-off must be bit-exact, like the reference's
// SIMD contract in test/xvc_test/simd_test.cc).
//
// Context-state arrays are owned by Python (numpy uint8); all functions
// take raw pointers per call so RDO snapshot/restore stays a numpy copy.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#if defined(__AVX2__)
#include <immintrin.h>
#endif

#define XVCN_API extern "C" __attribute__((visibility("default")))

static const int kFracBitsPrecision = 15;
static const int kEntropyBypassBits = 1 << kFracBitsPrecision;

// ---- normative tables (context_model.py) ----

static const uint8_t kNextStateMps[128] = {
    2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
    50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65,
    66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81,
    82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97,
    98, 99, 100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110, 111,
    112, 113, 114, 115, 116, 117, 118, 119, 120, 121, 122, 123,
    124, 125, 124, 125, 126, 127};

static const uint8_t kNextStateLps[128] = {
    1, 0, 0, 1, 2, 3, 4, 5, 4, 5, 8, 9, 8, 9, 10, 11,
    12, 13, 14, 15, 16, 17, 18, 19, 18, 19, 22, 23, 22, 23, 24, 25,
    26, 27, 26, 27, 30, 31, 30, 31, 32, 33, 32, 33, 36, 37, 36, 37,
    38, 39, 38, 39, 42, 43, 42, 43, 44, 45, 44, 45, 46, 47, 48, 49,
    48, 49, 50, 51, 52, 53, 52, 53, 54, 55, 54, 55, 56, 57, 58, 59,
    58, 59, 60, 61, 60, 61, 60, 61, 62, 63, 64, 65, 64, 65, 66, 67,
    66, 67, 66, 67, 68, 69, 68, 69, 70, 71, 70, 71, 70, 71, 72, 73,
    72, 73, 72, 73, 74, 75, 74, 75, 74, 75, 76, 77, 76, 77, 126, 127};

static const uint32_t kEntropyBits[128] = {
    0x07b23, 0x085f9, 0x074a0, 0x08cbc, 0x06ee4, 0x09354, 0x067f4, 0x09c1b,
    0x060b0, 0x0a62a, 0x05a9c, 0x0af5b, 0x0548d, 0x0b955, 0x04f56, 0x0c2a9,
    0x04a87, 0x0cbf7, 0x045d6, 0x0d5c3, 0x04144, 0x0e01b, 0x03d88, 0x0e937,
    0x039e0, 0x0f2cd, 0x03663, 0x0fc9e, 0x03347, 0x10600, 0x03050, 0x10f95,
    0x02d4d, 0x11a02, 0x02ad3, 0x12333, 0x0286e, 0x12cad, 0x02604, 0x136df,
    0x02425, 0x13f48, 0x021f4, 0x149c4, 0x0203e, 0x1527b, 0x01e4d, 0x15d00,
    0x01c99, 0x166de, 0x01b18, 0x17017, 0x019a5, 0x17988, 0x01841, 0x18327,
    0x016df, 0x18d50, 0x015d9, 0x19547, 0x0147c, 0x1a083, 0x0138e, 0x1a8a3,
    0x01251, 0x1b418, 0x01166, 0x1bd27, 0x01068, 0x1c77b, 0x00f7f, 0x1d18e,
    0x00eda, 0x1d91a, 0x00e19, 0x1e254, 0x00d4f, 0x1ec9a, 0x00c90, 0x1f6e0,
    0x00c01, 0x1fef8, 0x00b5f, 0x208b1, 0x00ab6, 0x21362, 0x00a15, 0x21e46,
    0x00988, 0x2285d, 0x00934, 0x22ea8, 0x008a8, 0x239b2, 0x0081d, 0x24577,
    0x007c9, 0x24ce6, 0x00763, 0x25663, 0x00710, 0x25e8f, 0x006a0, 0x26a26,
    0x00672, 0x26f23, 0x005e8, 0x27ef8, 0x005ba, 0x284b5, 0x0055e, 0x29057,
    0x0050c, 0x29bab, 0x004c1, 0x2a674, 0x004a7, 0x2aa5e, 0x0046f, 0x2b32f,
    0x0041f, 0x2c0ad, 0x003e7, 0x2ca8d, 0x003ba, 0x2d323, 0x0010c, 0x3bfbb};

static const uint8_t kRenormTable[32] = {
    6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

static const uint8_t kRangeTable[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216},
    {123, 150, 178, 205}, {116, 142, 169, 195}, {111, 135, 160, 185},
    {105, 128, 152, 175}, {100, 122, 144, 166}, {95, 116, 137, 158},
    {90, 110, 130, 150}, {85, 104, 123, 142}, {81, 99, 117, 135},
    {77, 94, 111, 128}, {73, 89, 105, 122}, {69, 85, 100, 116},
    {66, 80, 95, 110}, {62, 76, 90, 104}, {59, 72, 86, 99},
    {56, 69, 81, 94}, {53, 65, 77, 89}, {51, 62, 73, 85},
    {48, 59, 69, 80}, {46, 56, 66, 76}, {43, 53, 63, 72},
    {41, 50, 59, 69}, {39, 48, 56, 65}, {37, 45, 54, 62},
    {35, 43, 51, 59}, {33, 41, 48, 56}, {32, 39, 46, 53},
    {30, 37, 43, 50}, {29, 35, 41, 48}, {27, 33, 39, 45},
    {26, 31, 37, 43}, {24, 30, 35, 41}, {23, 28, 33, 39},
    {22, 27, 32, 37}, {21, 26, 30, 35}, {20, 24, 29, 33},
    {19, 23, 27, 31}, {18, 22, 26, 30}, {17, 21, 25, 28},
    {16, 20, 23, 27}, {15, 19, 22, 25}, {14, 18, 21, 24},
    {14, 17, 20, 23}, {13, 16, 19, 22}, {12, 15, 18, 21},
    {12, 14, 17, 20}, {11, 14, 16, 19}, {11, 13, 15, 18},
    {10, 12, 15, 17}, {10, 12, 14, 16}, {9, 11, 13, 15},
    {9, 11, 12, 14}, {8, 10, 12, 14}, {8, 9, 11, 13},
    {7, 9, 11, 12}, {7, 9, 10, 12}, {7, 8, 10, 11},
    {6, 8, 9, 11}, {6, 7, 9, 10}, {6, 7, 8, 9},
    {2, 2, 2, 2}};

// ---- scan tables (scan.py) ----

static const int kLastPosGroupIdx[128] = {
    0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
    8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9,
    10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10,
    11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11,
    12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12,
    12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12, 12,
    13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13,
    13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13};

static const int kLastPosMinInGroup[14] = {
    0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96};

static const int kGolombRiceRangeExt[10] = {6, 5, 6, 3, 3, 3, 3, 3, 3, 3};

static const int kScanCoeff2x2[3][4] = {
    {0, 2, 1, 3}, {0, 1, 2, 3}, {0, 2, 1, 3}};
static const int kScanCoeff4x4[3][16] = {
    {0, 4, 1, 8, 5, 2, 12, 9, 6, 3, 13, 10, 7, 14, 11, 15},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15}};

enum ScanOrder { kDiagonal = 0, kHorizontal = 1, kVertical = 2 };

// inverse of kScanCoeff4x4 / kScanCoeff2x2: raster position -> scan index
static const int kScanCoeff2x2Inv[3][4] = {
    {0, 2, 1, 3}, {0, 1, 2, 3}, {0, 2, 1, 3}};
static const int kScanCoeff4x4Inv[3][16] = {
    {0, 2, 5, 9, 1, 4, 8, 12, 3, 7, 11, 14, 6, 10, 13, 15},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15}};

// scan.py derive_subblock_scan; table must hold width*height entries
static void DeriveSubblockScan(int scan_order, int width, int height,
                               int* table) {
  int n = width * height;
  int pos_x = 0, pos_y = 0;
  if (scan_order == kDiagonal) {
    for (int i = 0; i < n; i++) {
      table[i] = pos_y * width + pos_x;
      if (pos_x == width - 1 || pos_y == 0) {
        pos_y += pos_x + 1;
        pos_x = 0;
        if (pos_y >= height) {
          pos_x += pos_y - (height - 1);
          pos_y = height - 1;
        }
      } else {
        pos_x += 1;
        pos_y -= 1;
      }
    }
  } else if (scan_order == kHorizontal) {
    for (int i = 0; i < n; i++) {
      table[i] = pos_y * width + pos_x;
      if (pos_x == width - 1) { pos_x = 0; pos_y += 1; } else { pos_x += 1; }
    }
  } else {
    for (int i = 0; i < n; i++) {
      table[i] = pos_y * width + pos_x;
      if (pos_y == height - 1) { pos_x += 1; pos_y = 0; } else { pos_y += 1; }
    }
  }
}

// Cached subblock scan tables + inverse (raster -> scan index), keyed by
// (scan_order, log2 sw, log2 sh); sw/sh are powers of two <= 32.  Built
// lazily per thread (a TU parse is single-threaded).
struct NScanTables {
  int sub_scan[1024];
  uint16_t sub_inv[1024];
};

static inline int size_to_log2(int s);

static const NScanTables& get_subblock_scan(int scan_order, int sw, int sh) {
  thread_local static NScanTables* cache[3][7][7] = {};
  int lw = size_to_log2(sw), lh = size_to_log2(sh);
  NScanTables*& slot = cache[scan_order][lw][lh];
  if (!slot) {
    slot = new NScanTables();
    DeriveSubblockScan(scan_order, sw, sh, slot->sub_scan);
    for (int i = 0; i < sw * sh; i++)
      slot->sub_inv[slot->sub_scan[i]] = (uint16_t)i;
  }
  return *slot;
}

// ---- restriction flag bits (mirrors xvc_tpu/native/__init__.py order) ----

enum RestrBit {
  R_EXT2_CABAC_ALT_RESIDUAL_CTX = 1 << 0,
  R_CABAC_COEFF_SIG_CTX = 1 << 1,
  R_CABAC_COEFF_GREATER1_CTX = 1 << 2,
  R_CABAC_COEFF_GREATER2_CTX = 1 << 3,
  R_CABAC_COEFF_LAST_POS_CTX = 1 << 4,
  R_CABAC_SUBBLOCK_CSBF_CTX = 1 << 5,
  R_EXT_CABAC_ALT_LAST_POS_CTX = 1 << 6,
  R_TRANSFORM_CBF = 1 << 7,
  R_TRANSFORM_SUBBLOCK_CSBF = 1 << 8,
  R_TRANSFORM_LAST_POSITION = 1 << 9,
  R_TRANSFORM_RESIDUAL_GREATER_THAN_FLAGS = 1 << 10,
  R_TRANSFORM_RESIDUAL_GREATER2 = 1 << 11,
  R_TRANSFORM_SIGN_HIDING = 1 << 12,
  R_TRANSFORM_ADAPTIVE_EXP_GOLOMB = 1 << 13,
};

// ---- context family offsets (order mirrors native/__init__.py) ----

enum FamIdx {
  F_CSBF_LUMA = 0, F_CSBF_CHROMA, F_SIG_LUMA, F_SIG_CHROMA,
  F_GREATER1_LUMA, F_GREATER1_CHROMA, F_GREATER2_LUMA, F_GREATER2_CHROMA,
  F_EXT_CSBF_LUMA, F_EXT_CSBF_CHROMA, F_EXT_SIG_LUMA, F_EXT_SIG_CHROMA,
  F_EXT_GREATER1_LUMA, F_EXT_GREATER1_CHROMA,
  F_LAST_X_LUMA, F_LAST_X_CHROMA, F_LAST_Y_LUMA, F_LAST_Y_CHROMA,
  F_NUM_FAMILIES,
};

static const int kCtxIndexMap4x4[16] = {
    0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};

static const int kMaxNumC1Flags = 8;
static const int kMaxNumC2Flags = 1;
static const int kCoeffRemainBinReduction = 3;
static const int kSignHidingThreshold = 3;

struct CoeffCtxParams {
  const int32_t* offsets;  // F_NUM_FAMILIES entries
  uint64_t restr;
  int is_luma;
  int scan_order;
  int width, height, width_log2, height_log2;
};

static inline int size_to_log2(int s) { return 31 - __builtin_clz(s); }

// contexts.py get_subblock_csbf_ctx; *pattern out
static int GetSubblockCsbfCtx(const CoeffCtxParams& p,
                              const uint8_t* subblock_csbf,
                              int posx, int posy, int sw, int sh,
                              int* pattern_sig_ctx) {
  int right = 0, below = 0;
  int base;
  if (!(p.restr & R_EXT2_CABAC_ALT_RESIDUAL_CTX))
    base = p.offsets[p.is_luma ? F_EXT_CSBF_LUMA : F_EXT_CSBF_CHROMA];
  else
    base = p.offsets[p.is_luma ? F_CSBF_LUMA : F_CSBF_CHROMA];
  if (posx < sw - 1) right = subblock_csbf[posy * sw + posx + 1] ? 1 : 0;
  if (posy < sh - 1) below = subblock_csbf[(posy + 1) * sw + posx] ? 1 : 0;
  *pattern_sig_ctx = right + (below << 1);
  if (p.restr & R_CABAC_SUBBLOCK_CSBF_CTX) return base;
  return base + (right | below);
}

// contexts.py get_coeff_sig_ctx (coeff = partially decoded levels)
template <typename C>
static int GetCoeffSigCtx(const CoeffCtxParams& p, int pattern_sig_ctx,
                          int posx, int posy, const C* coeff,
                          int stride) {
  if (!(p.restr & R_EXT2_CABAC_ALT_RESIDUAL_CTX)) {
    int width = 1 << p.width_log2, height = 1 << p.height_log2;
    int size = (p.width_log2 + p.height_log2) >> 1;
    int posxy = posx + posy;
    if (p.restr & R_CABAC_COEFF_SIG_CTX) return p.offsets[F_EXT_SIG_LUMA];
    int offset = 0;
    if (posx < width - 1) {
      offset += coeff[posy * stride + posx + 1] ? 1 : 0;
      if (posx < width - 2) offset += coeff[posy * stride + posx + 2] ? 1 : 0;
      if (posy < height - 1)
        offset += coeff[(posy + 1) * stride + posx + 1] ? 1 : 0;
    }
    if (posy < height - 1) {
      offset += coeff[(posy + 1) * stride + posx] ? 1 : 0;
      if (posy < height - 2)
        offset += coeff[(posy + 2) * stride + posx] ? 1 : 0;
    }
    if (offset > 5) offset = 5;
    int start_offset = (posxy < 2) ? 6 : 0;
    if (p.is_luma && posxy < 5) start_offset += 6;
    if (size > 2 && p.is_luma)
      start_offset += 18 << ((size - 3) < 1 ? (size - 3) : 1);
    int base = p.offsets[p.is_luma ? F_EXT_SIG_LUMA : F_EXT_SIG_CHROMA];
    return base + start_offset + offset;
  }
  int base = p.offsets[p.is_luma ? F_SIG_LUMA : F_SIG_CHROMA];
  if ((posx == 0 && posy == 0) || (p.restr & R_CABAC_COEFF_SIG_CTX))
    return base;
  if (p.width_log2 == 2 && p.height_log2 == 2)
    return base + kCtxIndexMap4x4[4 * posy + posx];
  int start_offset = p.is_luma ? 21 : 12;
  if (p.width_log2 == 3 && p.height_log2 == 3)
    start_offset = (p.scan_order == kDiagonal) ? 9 : 15;
  int pxs = posx & 3, pys = posy & 3;
  int cnt;
  if (pattern_sig_ctx == 0) {
    if (pxs + pys <= 2) cnt = (pxs + pys == 0) ? 2 : 1; else cnt = 0;
  } else if (pattern_sig_ctx == 1) {
    cnt = (pys <= 1) ? ((pys == 0) ? 2 : 1) : 0;
  } else if (pattern_sig_ctx == 2) {
    cnt = (pxs <= 1) ? ((pxs == 0) ? 2 : 1) : 0;
  } else {
    cnt = 2;
  }
  int comp_offset = (p.is_luma && ((posx >> 2) + (posy >> 2)) > 0) ? 3 : 0;
  return base + start_offset + comp_offset + cnt;
}

// contexts.py _ext_greater_ctx
template <typename C>
static int ExtGreaterCtx(const CoeffCtxParams& p, int posx, int posy,
                         int is_last_coeff, const C* coeff, int stride,
                         int threshold) {
  int posxy = posx + posy;
  int base_l = p.offsets[F_EXT_GREATER1_LUMA];
  int base_c = p.offsets[F_EXT_GREATER1_CHROMA];
  if (is_last_coeff) return p.is_luma ? base_l : base_c;
  int offset = 0;
  if (posx < p.width - 1) {
    offset += (abs(coeff[posy * stride + posx + 1]) > threshold) ? 1 : 0;
    if (posx < p.width - 2)
      offset += (abs(coeff[posy * stride + posx + 2]) > threshold) ? 1 : 0;
    if (posy < p.height - 1)
      offset +=
          (abs(coeff[(posy + 1) * stride + posx + 1]) > threshold) ? 1 : 0;
  }
  if (posy < p.height - 1) {
    offset += (abs(coeff[(posy + 1) * stride + posx]) > threshold) ? 1 : 0;
    if (posy < p.height - 2)
      offset += (abs(coeff[(posy + 2) * stride + posx]) > threshold) ? 1 : 0;
  }
  offset = (offset < 4 ? offset : 4) + 1;
  if (p.is_luma) {
    int start_offset = (posxy < 3) ? 10 : ((posxy < 10) ? 5 : 0);
    return base_l + start_offset + offset;
  }
  return base_c + offset;
}

// Fused neighbor statistics: the Sig/Greater1/Greater2/GolombRiceK
// contexts of the default (EXT) residual coding all read the same
// 5-neighbor template; the RDO quantizer computes all four per
// coefficient against the same decided-level state, so one pass over
// the neighbors replaces four (ref role: the per-flag ctx calls of
// rdo_quant.cc feeding cabac_contexts.cc GetCoeff*Ctx).
struct CoeffNbrStats {
  int nz, gt1, gt2, abs_sum;
};

template <typename C>
static inline CoeffNbrStats CoeffNeighborStats(int posx, int posy, int w,
                                               int h, const C* coeff,
                                               int stride) {
  CoeffNbrStats s = {0, 0, 0, 0};
  const C* row = coeff + posy * stride + posx;
  int a;
#define XVCN_NBR_ACC(v)                                                \
  a = (int)(v); a = a < 0 ? -a : a;                                    \
  s.nz += a != 0; s.gt1 += a > 1; s.gt2 += a > 2; s.abs_sum += a;
  if (posx < w - 2 && posy < h - 2) {
    // interior: all five neighbors in range, no per-load branches
    XVCN_NBR_ACC(row[1]);
    XVCN_NBR_ACC(row[2]);
    XVCN_NBR_ACC(row[stride + 1]);
    XVCN_NBR_ACC(row[stride]);
    XVCN_NBR_ACC(row[2 * stride]);
    return s;
  }
  if (posx < w - 1) {
    XVCN_NBR_ACC(row[1]);
    if (posx < w - 2) { XVCN_NBR_ACC(row[2]); }
    if (posy < h - 1) { XVCN_NBR_ACC(row[stride + 1]); }
  }
  if (posy < h - 1) {
    XVCN_NBR_ACC(row[stride]);
    if (posy < h - 2) { XVCN_NBR_ACC(row[2 * stride]); }
  }
#undef XVCN_NBR_ACC
  return s;
}

// EXT-branch of GetCoeffSigCtx from precomputed stats (same math as the
// scanning form above).
static int ExtSigCtxFromStats(const CoeffCtxParams& p, int posx, int posy,
                              int nz) {
  if (p.restr & R_CABAC_COEFF_SIG_CTX) return p.offsets[F_EXT_SIG_LUMA];
  int size = (p.width_log2 + p.height_log2) >> 1;
  int posxy = posx + posy;
  int offset = nz > 5 ? 5 : nz;
  int start_offset = (posxy < 2) ? 6 : 0;
  if (p.is_luma && posxy < 5) start_offset += 6;
  if (size > 2 && p.is_luma)
    start_offset += 18 << ((size - 3) < 1 ? (size - 3) : 1);
  int base = p.offsets[p.is_luma ? F_EXT_SIG_LUMA : F_EXT_SIG_CHROMA];
  return base + start_offset + offset;
}

static int ExtGreaterCtxFromStats(const CoeffCtxParams& p, int posx,
                                  int posy, int is_last_coeff,
                                  int gt_count) {
  int base_l = p.offsets[F_EXT_GREATER1_LUMA];
  int base_c = p.offsets[F_EXT_GREATER1_CHROMA];
  if (is_last_coeff) return p.is_luma ? base_l : base_c;
  int offset = (gt_count < 4 ? gt_count : 4) + 1;
  if (p.is_luma) {
    int posxy = posx + posy;
    int start_offset = (posxy < 3) ? 10 : ((posxy < 10) ? 5 : 0);
    return base_l + start_offset + offset;
  }
  return base_c + offset;
}

static int GolombRiceKFromStats(int abs_sum, int nz) {
  int threshold = 4 + abs_sum - nz;
  for (int k = 0; k < 10; k++)
    if ((1 << (k + 3)) > threshold) return k;
  return 9;
}

// contexts.py get_coeff_greater1_ctx
template <typename C>
static int GetCoeffGreater1Ctx(const CoeffCtxParams& p, int ctx_set, int c1,
                               int posx, int posy, int is_last_coeff,
                               const C* coeff, int stride) {
  if (!(p.restr & R_EXT2_CABAC_ALT_RESIDUAL_CTX)) {
    if (p.restr & R_CABAC_COEFF_GREATER1_CTX)
      return p.offsets[p.is_luma ? F_EXT_GREATER1_LUMA : F_EXT_GREATER1_CHROMA];
    return ExtGreaterCtx(p, posx, posy, is_last_coeff, coeff, stride, 1);
  }
  if (p.restr & R_CABAC_COEFF_GREATER1_CTX)
    return p.offsets[p.is_luma ? F_GREATER1_LUMA : F_GREATER1_CHROMA];
  return p.offsets[p.is_luma ? F_GREATER1_LUMA : F_GREATER1_CHROMA] +
         4 * ctx_set + c1;
}

// contexts.py get_coeff_greater2_ctx
template <typename C>
static int GetCoeffGreater2Ctx(const CoeffCtxParams& p, int ctx_set,
                               int posx, int posy, int is_last_coeff,
                               const C* coeff, int stride) {
  if (!(p.restr & R_EXT2_CABAC_ALT_RESIDUAL_CTX)) {
    if (p.restr & R_CABAC_COEFF_GREATER2_CTX)
      return p.offsets[p.is_luma ? F_EXT_GREATER1_LUMA : F_EXT_GREATER1_CHROMA];
    return ExtGreaterCtx(p, posx, posy, is_last_coeff, coeff, stride, 2);
  }
  if (p.restr & R_CABAC_COEFF_GREATER2_CTX)
    return p.offsets[p.is_luma ? F_EXT_GREATER1_LUMA : F_EXT_GREATER1_CHROMA];
  return p.offsets[p.is_luma ? F_GREATER2_LUMA : F_GREATER2_CHROMA] + ctx_set;
}

// contexts.py get_coeff_golomb_rice_k
template <typename C>
static int GetCoeffGolombRiceK(int posx, int posy, int width, int height,
                               const C* coeff, int stride) {
  int offset = 0, num = 0;
  if (posx < width - 1) {
    int c = coeff[posy * stride + posx + 1];
    offset += abs(c); num += c ? 1 : 0;
    if (posx < width - 2) {
      c = coeff[posy * stride + posx + 2];
      offset += abs(c); num += c ? 1 : 0;
    }
    if (posy < height - 1) {
      c = coeff[(posy + 1) * stride + posx + 1];
      offset += abs(c); num += c ? 1 : 0;
    }
  }
  if (posy < height - 1) {
    int c = coeff[(posy + 1) * stride + posx];
    offset += abs(c); num += c ? 1 : 0;
    if (posy < height - 2) {
      c = coeff[(posy + 2) * stride + posx];
      offset += abs(c); num += c ? 1 : 0;
    }
  }
  int threshold = 4 + offset - num;
  for (int k = 0; k < 10; k++)
    if ((1 << (k + 3)) > threshold) return k;
  return 9;
}

// contexts.py get_coeff_last_pos_ctx
static int GetCoeffLastPosCtx(const CoeffCtxParams& p, int width, int height,
                              int pos, int is_pos_x) {
  int size = is_pos_x ? width : height;
  if (p.is_luma) {
    int base = p.offsets[is_pos_x ? F_LAST_X_LUMA : F_LAST_Y_LUMA];
    if ((p.restr & R_CABAC_COEFF_LAST_POS_CTX) &&
        (p.restr & R_EXT_CABAC_ALT_LAST_POS_CTX))
      return base;
    int offset, shift;
    if (!(p.restr & R_EXT_CABAC_ALT_LAST_POS_CTX)) {
      static const int offset_map[8] = {0, 0, 0, 3, 6, 10, 15, 21};
      int size_log2 = size_to_log2(size);
      offset = offset_map[size_log2];
      shift = (size_log2 + 1) >> 2;
    } else {
      int size_bits = size_to_log2(size) - 2;
      offset = size_bits * 3 + ((size_bits + 1) >> 2);
      shift = (size_bits + 3) >> 2;
    }
    return base + offset + (pos >> shift);
  }
  int base = p.offsets[is_pos_x ? F_LAST_X_CHROMA : F_LAST_Y_CHROMA];
  if ((p.restr & R_CABAC_COEFF_LAST_POS_CTX) &&
      (p.restr & R_EXT_CABAC_ALT_LAST_POS_CTX))
    return base;
  int shift;
  if (!(p.restr & R_EXT_CABAC_ALT_LAST_POS_CTX)) {
    shift = size >> 3;
    if (shift < 0) shift = 0;
    if (shift > 2) shift = 2;
  } else {
    shift = size_to_log2(size) - 2;
  }
  return base + (pos >> shift);
}

// ---- entropy decoder (entropy_decoder.py) ----

struct XvcnDec {
  const uint8_t* buf;
  int64_t len;
  int64_t pos;
  int bit_mask;  // BitReader state for rewind/finish
  uint8_t* ctx;  // set per call
  int ctx_update;
  int64_t range;
  int64_t value;
  int bits_needed;
  int error;
};

static inline int DecReadByte(XvcnDec* d) {
  if (d->pos >= d->len) { d->error = 1; return 0; }
  return d->buf[d->pos++];
}

XVCN_API XvcnDec* xvcn_dec_create(const uint8_t* buf, int64_t len,
                                  int64_t pos, int ctx_update) {
  XvcnDec* d = new XvcnDec();
  d->buf = buf; d->len = len; d->pos = pos; d->bit_mask = 0x80;
  d->ctx = nullptr; d->ctx_update = ctx_update;
  d->range = 510; d->bits_needed = -8; d->error = 0;
  d->value = (DecReadByte(d) << 8) | DecReadByte(d);
  return d;
}

XVCN_API void xvcn_dec_destroy(XvcnDec* d) { delete d; }
XVCN_API int64_t xvcn_dec_get_pos(XvcnDec* d) { return d->pos; }
XVCN_API int xvcn_dec_get_error(XvcnDec* d) { return d->error; }
XVCN_API void xvcn_dec_set_ctx(XvcnDec* d, uint8_t* ctx) { d->ctx = ctx; }

static inline int DecodeBin(XvcnDec* d, int ctx_idx) {
  int state = d->ctx[ctx_idx];
  int mps = state & 1;
  int lps = kRangeTable[state >> 1][(d->range >> 6) & 3];
  d->range -= lps;
  int64_t scaled_range = d->range << 7;
  int binval, num_bits;
  if (d->value < scaled_range) {
    binval = mps;
    if (d->ctx_update) d->ctx[ctx_idx] = kNextStateMps[state];
    if (scaled_range >= (256 << 7)) return binval;
    num_bits = 1;
  } else {
    binval = 1 - mps;
    d->value -= scaled_range;
    d->range = lps;
    if (d->ctx_update) d->ctx[ctx_idx] = kNextStateLps[state];
    num_bits = kRenormTable[lps >> 3];
  }
  d->value <<= num_bits;
  d->range <<= num_bits;
  d->bits_needed += num_bits;
  if (d->bits_needed >= 0) {
    d->value |= (int64_t)DecReadByte(d) << d->bits_needed;
    d->bits_needed -= 8;
  }
  return binval;
}

static inline int DecodeBypass(XvcnDec* d) {
  d->value += d->value;
  d->bits_needed += 1;
  if (d->bits_needed >= 0) {
    d->bits_needed = -8;
    d->value += DecReadByte(d);
  }
  int64_t scaled_range = d->range << 7;
  if (d->value >= scaled_range) {
    d->value -= scaled_range;
    return 1;
  }
  return 0;
}

static inline uint32_t DecodeBypassBins(XvcnDec* d, int num_bins) {
  uint32_t bins = 0;
  while (num_bins > 8) {
    d->value = (d->value << 8) +
               ((int64_t)DecReadByte(d) << (8 + d->bits_needed));
    int64_t scaled_range = d->range << 15;
    for (int i = 0; i < 8; i++) {
      bins += bins;
      scaled_range >>= 1;
      if (d->value >= scaled_range) {
        bins += 1;
        d->value -= scaled_range;
      }
    }
    num_bins -= 8;
  }
  d->bits_needed += num_bins;
  d->value <<= num_bins;
  if (d->bits_needed >= 0) {
    d->value += (int64_t)DecReadByte(d) << d->bits_needed;
    d->bits_needed -= 8;
  }
  int64_t scaled_range = d->range << (num_bins + 7);
  for (int i = 0; i < num_bins; i++) {
    bins += bins;
    scaled_range >>= 1;
    if (d->value >= scaled_range) {
      bins += 1;
      d->value -= scaled_range;
    }
  }
  return bins;
}

static void DecRewind(XvcnDec* d, int num_bits) {
  for (int i = 0; i < num_bits; i++) {
    d->bit_mask <<= 1;
    if (d->bit_mask == 0x100) { d->bit_mask = 0x1; d->pos -= 1; }
  }
}

static inline int DecodeBinTrm(XvcnDec* d) {
  d->range -= 2;
  int64_t scaled_range = d->range << 7;
  if (d->value >= scaled_range) {
    DecRewind(d, -d->bits_needed);
    return 1;
  }
  if (scaled_range < (256 << 7)) {
    d->range = scaled_range >> 6;
    d->value <<= 1;
    d->bits_needed += 1;
    if (d->bits_needed == 0) {
      d->bits_needed = -8;
      d->value += DecReadByte(d);
    }
  }
  return 0;
}

XVCN_API int xvcn_dec_decode_bin(XvcnDec* d, uint8_t* ctx, int ctx_idx) {
  d->ctx = ctx;
  return DecodeBin(d, ctx_idx);
}
XVCN_API int xvcn_dec_decode_bypass(XvcnDec* d) { return DecodeBypass(d); }
XVCN_API uint32_t xvcn_dec_decode_bypass_bins(XvcnDec* d, int n) {
  return DecodeBypassBins(d, n);
}
XVCN_API int xvcn_dec_decode_bin_trm(XvcnDec* d) { return DecodeBinTrm(d); }

// BitReader.read_bits(1) + skip_bits (EntropyDecoder.finish)
XVCN_API void xvcn_dec_finish(XvcnDec* d) {
  // read one bit MSB-first from (pos, bit_mask)
  d->bit_mask >>= 1;
  if (!d->bit_mask) {
    d->bit_mask = 0x80;
    if (d->pos < d->len) d->pos += 1;
  }
  // skip_bits: byte align
  if (d->bit_mask != 0x80) {
    d->bit_mask = 0x80;
    if (d->pos < d->len) d->pos += 1;
  }
}

// ---- entropy encoder (entropy_encoder.py) ----

struct XvcnEnc {
  uint8_t* ctx;  // set per call
  int ctx_update;
  int counting;  // no byte output, frac_bits only
  uint64_t low;
  int64_t range;
  int bits_left;
  int buffered_byte;
  int num_buffered_bytes;
  uint64_t frac_bits;
  uint8_t* out;
  int64_t out_len;
  int64_t out_cap;
  int out_shift;  // bit position within last byte (BitWriter.shift)
  int error;
};

static void EncGrow(XvcnEnc* e) {
  int64_t cap = e->out_cap * 2;
  if (cap < 4096) cap = 4096;
  e->out = (uint8_t*)realloc(e->out, cap);
  e->out_cap = cap;
}

static inline void EncWriteByte(XvcnEnc* e, int b) {
  if (e->out_len >= e->out_cap) EncGrow(e);
  e->out[e->out_len++] = (uint8_t)(b & 0xFF);
}

static inline void EncWriteBit(XvcnEnc* e, int bit) {
  if (e->out_shift) {
    e->out[e->out_len - 1] |= (bit & 1) << (8 - e->out_shift - 1);
    e->out_shift = (e->out_shift + 1) & 7;
  } else {
    if (e->out_len >= e->out_cap) EncGrow(e);
    e->out[e->out_len++] = (uint8_t)((bit & 1) << 7);
    e->out_shift = 1;
  }
}

static inline void EncWriteBits(XvcnEnc* e, uint64_t value, int n) {
  for (int i = n - 1; i >= 0; i--) EncWriteBit(e, (value >> i) & 1);
}

XVCN_API XvcnEnc* xvcn_enc_create(int ctx_update, int counting,
                                  int64_t out_cap) {
  XvcnEnc* e = new XvcnEnc();
  e->ctx = nullptr; e->ctx_update = ctx_update; e->counting = counting;
  e->low = 0; e->range = 510; e->bits_left = 23;
  e->buffered_byte = 0xFF; e->num_buffered_bytes = 0;
  e->frac_bits = 0; e->out_len = 0; e->out_shift = 0; e->error = 0;
  e->out_cap = counting ? 0 : (out_cap > 0 ? out_cap : 4096);
  e->out = counting ? nullptr : (uint8_t*)malloc(e->out_cap);
  return e;
}

XVCN_API void xvcn_enc_destroy(XvcnEnc* e) {
  if (e->out) free(e->out);
  delete e;
}

XVCN_API uint64_t xvcn_enc_get_frac_bits(XvcnEnc* e) { return e->frac_bits; }
XVCN_API void xvcn_enc_set_frac_bits(XvcnEnc* e, uint64_t fb) {
  e->frac_bits = fb;
}
XVCN_API int xvcn_enc_get_error(XvcnEnc* e) { return e->error; }
XVCN_API int64_t xvcn_enc_get_out_len(XvcnEnc* e) { return e->out_len; }
XVCN_API void xvcn_enc_copy_out(XvcnEnc* e, uint8_t* dst) {
  memcpy(dst, e->out, e->out_len);
}

static void EncWriteOut(XvcnEnc* e) {
  uint64_t lead_byte = e->low >> (24 - e->bits_left);
  e->bits_left += 8;
  e->low &= 0xFFFFFFFFull >> e->bits_left;
  if (lead_byte == 0xFF) {
    e->num_buffered_bytes += 1;
  } else {
    if (e->num_buffered_bytes > 0) {
      int carry = (int)(lead_byte >> 8);
      int byte = e->buffered_byte + carry;
      e->buffered_byte = (int)(lead_byte & 0xFF);
      EncWriteByte(e, byte);
      byte = (0xFF + carry) & 0xFF;
      while (e->num_buffered_bytes > 1) {
        EncWriteByte(e, byte);
        e->num_buffered_bytes -= 1;
      }
    } else {
      e->num_buffered_bytes = 1;
      e->buffered_byte = (int)lead_byte;
    }
  }
}

static inline void EncodeBin(XvcnEnc* e, int binval, int ctx_idx) {
  int state = e->ctx[ctx_idx];
  int mps = state & 1;
  e->frac_bits += kEntropyBits[state ^ binval];
  if (e->counting) {
    if (e->ctx_update)
      e->ctx[ctx_idx] =
          (binval != mps) ? kNextStateLps[state] : kNextStateMps[state];
    return;
  }
  int lps = kRangeTable[state >> 1][(e->range >> 6) & 3];
  e->range -= lps;
  int num_bits;
  if (binval != mps) {
    num_bits = kRenormTable[lps >> 3];
    e->low += e->range;
    e->range = lps;
    if (e->ctx_update) e->ctx[ctx_idx] = kNextStateLps[state];
  } else {
    num_bits = (e->range < 256) ? 1 : 0;
    if (e->ctx_update) e->ctx[ctx_idx] = kNextStateMps[state];
  }
  e->low <<= num_bits;
  e->range <<= num_bits;
  e->bits_left -= num_bits;
  if (num_bits && e->bits_left < 12) EncWriteOut(e);
}

static inline void EncodeBypass(XvcnEnc* e, int binval) {
  e->frac_bits += kEntropyBypassBits;
  if (e->counting) return;
  e->low <<= 1;
  if (binval) e->low += e->range;
  e->bits_left -= 1;
  if (e->bits_left < 12) EncWriteOut(e);
}

static inline void EncodeBypassBins(XvcnEnc* e, uint32_t binvals,
                                    int num_bins) {
  e->frac_bits += (uint64_t)kEntropyBypassBits * num_bins;
  if (e->counting) return;
  while (num_bins > 8) {
    num_bins -= 8;
    uint32_t pattern = binvals >> num_bins;
    e->low <<= 8;
    e->low += (uint64_t)e->range * pattern;
    binvals -= pattern << num_bins;
    e->bits_left -= 8;
    if (e->bits_left < 12) EncWriteOut(e);
  }
  e->low <<= num_bins;
  e->low += (uint64_t)e->range * binvals;
  e->bits_left -= num_bins;
  if (e->bits_left < 12) EncWriteOut(e);
}

static inline void EncodeBinTrm(XvcnEnc* e, int binval) {
  e->frac_bits += kEntropyBits[126 ^ binval];
  if (e->counting) return;
  e->range -= 2;
  int num_bits;
  if (binval) {
    e->low += e->range;
    e->range = 2;
    num_bits = 7;
  } else {
    num_bits = (e->range < 256) ? 1 : 0;
  }
  e->low <<= num_bits;
  e->range <<= num_bits;
  e->bits_left -= num_bits;
  if (e->bits_left < 12) EncWriteOut(e);
}

XVCN_API void xvcn_enc_encode_bin(XvcnEnc* e, uint8_t* ctx, int binval,
                                  int ctx_idx) {
  e->ctx = ctx;
  EncodeBin(e, binval, ctx_idx);
}
XVCN_API void xvcn_enc_encode_bypass(XvcnEnc* e, int binval) {
  EncodeBypass(e, binval);
}
XVCN_API void xvcn_enc_encode_bypass_bins(XvcnEnc* e, uint32_t binvals,
                                          int n) {
  EncodeBypassBins(e, binvals, n);
}
XVCN_API void xvcn_enc_encode_bin_trm(XvcnEnc* e, int binval) {
  EncodeBinTrm(e, binval);
}

// EntropyEncoder.finish: flush carry chain + final bits, zero-pad to byte
XVCN_API void xvcn_enc_finish(XvcnEnc* e) {
  if (e->counting) return;
  if (e->low >> (32 - e->bits_left)) {
    EncWriteByte(e, (e->buffered_byte + 1) & 0xFF);
    while (e->num_buffered_bytes > 1) {
      EncWriteByte(e, 0x00);
      e->num_buffered_bytes -= 1;
    }
    e->low -= 1ull << (32 - e->bits_left);
  } else {
    if (e->num_buffered_bytes > 0) EncWriteByte(e, e->buffered_byte & 0xFF);
    while (e->num_buffered_bytes > 1) {
      EncWriteByte(e, 0xFF);
      e->num_buffered_bytes -= 1;
    }
  }
  EncWriteBits(e, e->low >> 8, 24 - e->bits_left);
  EncWriteBits(e, 1, 1);
  e->out_shift = 0;  // pad_zero_bits
}

// ---- residual coefficient parse (syntax/reader.py _read_coeff_subblock) ----

static int ReadCoeffRemainExpGolomb(XvcnDec* d, uint64_t restr,
                                    int golomb_rice_k) {
  int threshold = !(restr & R_EXT2_CABAC_ALT_RESIDUAL_CTX)
                      ? kGolombRiceRangeExt[golomb_rice_k]
                      : kCoeffRemainBinReduction;
  int prefix = 0;
  while (DecodeBypass(d) != 0) {
    prefix += 1;
    if (d->error) return 0;
  }
  if (prefix < threshold) {
    int code_word = (int)DecodeBypassBins(d, golomb_rice_k);
    return (prefix << golomb_rice_k) + code_word;
  }
  int code_word = (int)DecodeBypassBins(d, prefix - threshold + golomb_rice_k);
  return code_word +
         ((((1 << (prefix - threshold)) + threshold - 1)) << golomb_rice_k);
}

static void ReadCoeffLastPos(XvcnDec* d, const CoeffCtxParams& p,
                             int* out_x, int* out_y) {
  int width = p.width, height = p.height;
  if (p.scan_order == kVertical) { int t = width; width = height; height = t; }
  int group_idx_x = kLastPosGroupIdx[width - 1];
  int group_idx_y = kLastPosGroupIdx[height - 1];
  int pos_last_x = 0;
  while (pos_last_x < group_idx_x) {
    int ctx = GetCoeffLastPosCtx(p, width, height, pos_last_x, 1);
    if (!DecodeBin(d, ctx)) break;
    pos_last_x += 1;
  }
  int pos_last_y = 0;
  while (pos_last_y < group_idx_y) {
    int ctx = GetCoeffLastPosCtx(p, width, height, pos_last_y, 0);
    if (!DecodeBin(d, ctx)) break;
    pos_last_y += 1;
  }
  if (pos_last_x > 3) {
    int offset = 0;
    int count = (pos_last_x - 2) >> 1;
    for (int i = count - 1; i >= 0; i--) offset += DecodeBypass(d) << i;
    pos_last_x = kLastPosMinInGroup[pos_last_x] + offset;
  }
  if (pos_last_y > 3) {
    int offset = 0;
    int count = (pos_last_y - 2) >> 1;
    for (int i = count - 1; i >= 0; i--) offset += DecodeBypass(d) << i;
    pos_last_y = kLastPosMinInGroup[pos_last_y] + offset;
  }
  if (p.scan_order == kVertical) {
    int t = pos_last_x; pos_last_x = pos_last_y; pos_last_y = t;
  }
  *out_x = pos_last_x;
  *out_y = pos_last_y;
}


template <typename C>
static int ReadCoefficientsT(
    XvcnDec* d, uint8_t* ctx, const int32_t* offsets, uint64_t restr,
    int width, int height, int subblock_shift, int is_luma, int scan_order,
    C* dst, int stride) {
  d->ctx = ctx;
  CoeffCtxParams p;
  p.offsets = offsets; p.restr = restr; p.is_luma = is_luma;
  p.scan_order = scan_order; p.width = width; p.height = height;
  p.width_log2 = size_to_log2(width);
  p.height_log2 = size_to_log2(height);
  int log2size = p.width_log2;
  int subblock_mask = (1 << subblock_shift) - 1;
  int subblock_size = 1 << (subblock_shift * 2);

  int sw = width >> subblock_shift;
  int sh = height >> subblock_shift;
  int nbr_subblocks = sw * sh;
  uint8_t subblock_csbf[1024];
  memset(subblock_csbf, 0, nbr_subblocks);
  const NScanTables& st = get_subblock_scan(scan_order, sw, sh);
  const int* sub_scan = st.sub_scan;
  const int* scan_table = (subblock_shift == 1)
                              ? kScanCoeff2x2[scan_order]
                              : kScanCoeff4x4[scan_order];
  const int* scan_inv = (subblock_shift == 1)
                            ? kScanCoeff2x2Inv[scan_order]
                            : kScanCoeff4x4Inv[scan_order];

  int subblock_last_index = nbr_subblocks - 1;
  int subblock_last_coeff_offset = 1;
  int coeff_num_non_zero = 0;
  int total_num_sig_coeff = 0;
  int subblock_coeff[16];
  int subblock_pos[16];
  memset(subblock_coeff, 0, sizeof(subblock_coeff));
  memset(subblock_pos, 0, sizeof(subblock_pos));
  subblock_pos[0] = -1;
  int last_nonzero_pos = -1;
  int first_nonzero_pos = subblock_size;

  if (!(restr & R_TRANSFORM_LAST_POSITION)) {
    int pos_last_x, pos_last_y;
    ReadCoeffLastPos(d, p, &pos_last_x, &pos_last_y);
    if (pos_last_x >= width || pos_last_y >= height) { d->error = 1; return 0; }
    // O(1) inverse-scan lookup (sub_inv + within-subblock inverse) in
    // place of the old exhaustive scan-table walk
    int pos_last_index =
        ((int)st.sub_inv[(pos_last_y >> subblock_shift) * sw +
                         (pos_last_x >> subblock_shift)]
         << (2 * subblock_shift)) +
        scan_inv[((pos_last_y & subblock_mask) << subblock_shift) +
                 (pos_last_x & subblock_mask)];
    int pos_last = (pos_last_y << log2size) + pos_last_x;
    subblock_last_index = pos_last_index >> (2 * subblock_shift);
    subblock_last_coeff_offset =
        ((subblock_last_index + 1) << (2 * subblock_shift)) -
        pos_last_index + 1;
    if ((restr & R_TRANSFORM_CBF) && (restr & R_TRANSFORM_SUBBLOCK_CSBF) &&
        pos_last_x == 0 && pos_last_y == 0) {
      subblock_last_coeff_offset -= 1;
    } else {
      subblock_coeff[0] = 1;
      coeff_num_non_zero = 1;
      dst[pos_last_y * stride + pos_last_x] = 1;
    }
    subblock_pos[0] = pos_last;
    int subblock_last_offset = subblock_last_index << (2 * subblock_shift);
    last_nonzero_pos = pos_last_index - subblock_last_offset;
    first_nonzero_pos = pos_last_index - subblock_last_offset;
  }

  int c1 = 1;
  for (int subblock_index = subblock_last_index; subblock_index >= 0;
       subblock_index--) {
    int subblock_scan = sub_scan[subblock_index];
    int ssy = subblock_scan / sw;
    int ssx = subblock_scan - ssy * sw;
    int spx = ssx << subblock_shift, spy = ssy << subblock_shift;

    int is_last_subblock = (subblock_index == subblock_last_index &&
                            !(restr & R_TRANSFORM_LAST_POSITION) &&
                            !(restr & R_TRANSFORM_CBF));
    int is_first_subblock =
        (subblock_index == 0 && !(restr & R_TRANSFORM_CBF));
    int pattern_sig_ctx;
    if (is_last_subblock || is_first_subblock ||
        (restr & R_TRANSFORM_SUBBLOCK_CSBF)) {
      subblock_csbf[subblock_scan] = 1;
      GetSubblockCsbfCtx(p, subblock_csbf, ssx, ssy, sw, sh,
                         &pattern_sig_ctx);
    } else {
      int cidx = GetSubblockCsbfCtx(p, subblock_csbf, ssx, ssy, sw, sh,
                                    &pattern_sig_ctx);
      subblock_csbf[subblock_scan] = (uint8_t)DecodeBin(d, cidx);
    }
    if (!subblock_csbf[subblock_scan]) continue;

    for (int coeff_index = subblock_size - subblock_last_coeff_offset;
         coeff_index >= 0; coeff_index--) {
      int so = scan_table[coeff_index];
      int coeff_scan_x = spx + (so & subblock_mask);
      int coeff_scan_y = spy + (so >> subblock_shift);
      int not_first_subblock =
          subblock_index > 0 && !(restr & R_TRANSFORM_SUBBLOCK_CSBF);
      int sig;
      if (coeff_index == 0 && not_first_subblock && coeff_num_non_zero == 0) {
        sig = 1;
      } else {
        int cidx = GetCoeffSigCtx(p, pattern_sig_ctx, coeff_scan_x,
                                  coeff_scan_y, dst, stride);
        sig = DecodeBin(d, cidx) != 0;
      }
      if (sig) {
        subblock_coeff[coeff_num_non_zero] = 1;
        subblock_pos[coeff_num_non_zero] =
            (coeff_scan_y << log2size) + coeff_scan_x;
        coeff_num_non_zero += 1;
        dst[coeff_scan_y * stride + coeff_scan_x] = 1;
        if (last_nonzero_pos == -1) last_nonzero_pos = coeff_index;
        first_nonzero_pos = coeff_index;
      } else {
        dst[coeff_scan_y * stride + coeff_scan_x] = 0;
      }
    }
    subblock_last_coeff_offset = 1;
    if (!coeff_num_non_zero) continue;

    int ctx_set = (subblock_index > 0 && is_luma) ? 2 : 0;
    if (c1 == 0) ctx_set += 1;
    c1 = 1;
    int first_c2_idx = -1;

    int max_num_c1_flags = kMaxNumC1Flags;
    if (restr & R_TRANSFORM_RESIDUAL_GREATER_THAN_FLAGS) max_num_c1_flags = 0;
    for (int i = 0; i < coeff_num_non_zero; i++) {
      if (i == max_num_c1_flags) break;
      int coeff_scan_y = subblock_pos[i] >> log2size;
      int coeff_scan_x = subblock_pos[i] - (coeff_scan_y << log2size);
      int cidx = GetCoeffGreater1Ctx(p, ctx_set, c1, coeff_scan_x,
                                     coeff_scan_y,
                                     (i == 0 && is_last_subblock), dst,
                                     stride);
      int greater1 = DecodeBin(d, cidx);
      if (greater1) {
        c1 = 0;
        if (first_c2_idx == -1 && !(restr & R_TRANSFORM_RESIDUAL_GREATER2))
          first_c2_idx = i;
        subblock_coeff[i] = 2;
        dst[coeff_scan_y * stride + coeff_scan_x] = 2;
      } else if (0 < c1 && c1 < 3) {
        c1 += 1;
      }
    }

    if (first_c2_idx >= 0) {
      int coeff_scan_y = subblock_pos[first_c2_idx] >> log2size;
      int coeff_scan_x =
          subblock_pos[first_c2_idx] - (coeff_scan_y << log2size);
      int cidx = GetCoeffGreater2Ctx(p, ctx_set, coeff_scan_x, coeff_scan_y,
                                     (first_c2_idx == 0 && is_last_subblock),
                                     dst, stride);
      int abs_lvl = DecodeBin(d, cidx);
      subblock_coeff[first_c2_idx] += abs_lvl;
      dst[coeff_scan_y * stride + coeff_scan_x] += abs_lvl;
    }

    int sign_hidden = 0;
    if (!(restr & R_TRANSFORM_SIGN_HIDING) &&
        last_nonzero_pos - first_nonzero_pos > kSignHidingThreshold)
      sign_hidden = 1;
    last_nonzero_pos = -1;
    first_nonzero_pos = subblock_size;

    uint32_t coeff_signs;
    if (sign_hidden) {
      coeff_signs = DecodeBypassBins(d, coeff_num_non_zero - 1);
      coeff_signs <<= 32 - (coeff_num_non_zero - 1);
    } else {
      coeff_signs = DecodeBypassBins(d, coeff_num_non_zero);
      coeff_signs <<= 32 - coeff_num_non_zero;
    }

    if (c1 == 0 || coeff_num_non_zero > max_num_c1_flags) {
      int first_coeff_greater2 =
          (restr & R_TRANSFORM_RESIDUAL_GREATER2) ? 0 : 1;
      int golomb_rice_k = 0;
      for (int i = 0; i < coeff_num_non_zero; i++) {
        int coeff_scan_y = subblock_pos[i] >> log2size;
        int coeff_scan_x = subblock_pos[i] - (coeff_scan_y << log2size);
        int base_level =
            (i < max_num_c1_flags) ? (2 + first_coeff_greater2) : 1;
        if (subblock_coeff[i] == base_level) {
          if (!(restr & R_EXT2_CABAC_ALT_RESIDUAL_CTX))
            golomb_rice_k = GetCoeffGolombRiceK(coeff_scan_x, coeff_scan_y,
                                                width, height, dst, stride);
          int abs_lvl = ReadCoeffRemainExpGolomb(d, restr, golomb_rice_k);
          subblock_coeff[i] += abs_lvl;
          dst[coeff_scan_y * stride + coeff_scan_x] += abs_lvl;
          if (subblock_coeff[i] > 3 * (1 << golomb_rice_k) &&
              !(restr & R_TRANSFORM_ADAPTIVE_EXP_GOLOMB))
            golomb_rice_k = golomb_rice_k + 1 < 4 ? golomb_rice_k + 1 : 4;
        }
        if (subblock_coeff[i] >= 2) first_coeff_greater2 = 0;
      }
    }

    int abs_sum = 0;
    for (int i = 0; i < coeff_num_non_zero; i++) {
      int coeff_scan_y = subblock_pos[i] >> log2size;
      int coeff_scan_x = subblock_pos[i] - (coeff_scan_y << log2size);
      int coeff = subblock_coeff[i];
      abs_sum += coeff;
      if (i == coeff_num_non_zero - 1 && sign_hidden) {
        int sign = (abs_sum & 1) ? -1 : 1;
        dst[coeff_scan_y * stride + coeff_scan_x] = sign * coeff;
      } else {
        int sign = (coeff_signs & 0x80000000u) ? -1 : 0;
        dst[coeff_scan_y * stride + coeff_scan_x] = (coeff ^ sign) - sign;
        coeff_signs <<= 1;
      }
    }
    total_num_sig_coeff += coeff_num_non_zero;
    coeff_num_non_zero = 0;
    if (d->error) return 0;
  }

  if (!total_num_sig_coeff && subblock_pos[0] != -1) {
    int coeff_scan_y = subblock_pos[0] >> log2size;
    int coeff_scan_x = subblock_pos[0] - (coeff_scan_y << log2size);
    dst[coeff_scan_y * stride + coeff_scan_x] = 0;
  }
  return total_num_sig_coeff;
}

XVCN_API int xvcn_read_coefficients(
    XvcnDec* d, uint8_t* ctx, const int32_t* offsets, uint64_t restr,
    int width, int height, int subblock_shift, int is_luma, int scan_order,
    int32_t* dst, int stride) {
  return ReadCoefficientsT<int32_t>(d, ctx, offsets, restr, width, height,
                                    subblock_shift, is_luma, scan_order, dst,
                                    stride);
}

// int16 coefficient store: half the cache footprint of the int32 form
// (the reference parses into int16 Coeff arrays, syntax_reader.cc); used
// by the native picture decoder's arena
XVCN_API int xvcn_read_coefficients16(
    XvcnDec* d, uint8_t* ctx, const int32_t* offsets, uint64_t restr,
    int width, int height, int subblock_shift, int is_luma, int scan_order,
    int16_t* dst, int stride) {
  return ReadCoefficientsT<int16_t>(d, ctx, offsets, restr, width, height,
                                    subblock_shift, is_luma, scan_order, dst,
                                    stride);
}

// ---- residual coefficient write (syntax/writer.py _write_coeff_subblock) ----

static void WriteCoeffRemainExpGolomb(XvcnEnc* e, uint64_t restr,
                                      int code_number, int golomb_rice_k) {
  int threshold = !(restr & R_EXT2_CABAC_ALT_RESIDUAL_CTX)
                      ? kGolombRiceRangeExt[golomb_rice_k]
                      : kCoeffRemainBinReduction;
  if (code_number < (threshold << golomb_rice_k)) {
    int length = code_number >> golomb_rice_k;
    EncodeBypassBins(e, (1u << (length + 1)) - 2, length + 1);
    EncodeBypassBins(e, code_number & ((1 << golomb_rice_k) - 1),
                     golomb_rice_k);
  } else {
    int length = golomb_rice_k;
    code_number -= threshold << golomb_rice_k;
    while (code_number >= (1 << length)) {
      code_number -= 1 << length;
      length += 1;
    }
    int num_bins = threshold + length + 1 - golomb_rice_k;
    EncodeBypassBins(e, (1u << num_bins) - 2, num_bins);
    EncodeBypassBins(e, code_number, length);
  }
}

static void WriteCoeffLastPos(XvcnEnc* e, const CoeffCtxParams& p,
                              int last_pos_x, int last_pos_y) {
  int width = p.width, height = p.height;
  if (p.scan_order == kVertical) {
    int t = last_pos_x; last_pos_x = last_pos_y; last_pos_y = t;
    t = width; width = height; height = t;
  }
  int group_idx_x = kLastPosGroupIdx[last_pos_x];
  int group_idx_y = kLastPosGroupIdx[last_pos_y];
  for (int i = 0; i < group_idx_x; i++)
    EncodeBin(e, 1, GetCoeffLastPosCtx(p, width, height, i, 1));
  if (group_idx_x < kLastPosGroupIdx[width - 1])
    EncodeBin(e, 0, GetCoeffLastPosCtx(p, width, height, group_idx_x, 1));
  for (int i = 0; i < group_idx_y; i++)
    EncodeBin(e, 1, GetCoeffLastPosCtx(p, width, height, i, 0));
  if (group_idx_y < kLastPosGroupIdx[height - 1])
    EncodeBin(e, 0, GetCoeffLastPosCtx(p, width, height, group_idx_y, 0));
  if (group_idx_x > 3) {
    int length = (group_idx_x - 2) >> 1;
    int remain_x = last_pos_x - kLastPosMinInGroup[group_idx_x];
    for (int i = length - 1; i >= 0; i--)
      EncodeBypass(e, (remain_x >> i) & 1);
  }
  if (group_idx_y > 3) {
    int length = (group_idx_y - 2) >> 1;
    int remain_y = last_pos_y - kLastPosMinInGroup[group_idx_y];
    for (int i = length - 1; i >= 0; i--)
      EncodeBypass(e, (remain_y >> i) & 1);
  }
}

XVCN_API int xvcn_write_coefficients(
    XvcnEnc* e, uint8_t* ctx, const int32_t* offsets, uint64_t restr,
    int width, int height, int subblock_shift, int is_luma, int scan_order,
    const int32_t* src, int stride) {
  e->ctx = ctx;
  CoeffCtxParams p;
  p.offsets = offsets; p.restr = restr; p.is_luma = is_luma;
  p.scan_order = scan_order; p.width = width; p.height = height;
  p.width_log2 = size_to_log2(width);
  p.height_log2 = size_to_log2(height);
  int log2size = p.width_log2;
  int subblock_mask = (1 << subblock_shift) - 1;
  int subblock_size = 1 << (2 * subblock_shift);

  int sw = width >> subblock_shift;
  int sh = height >> subblock_shift;
  int nbr_subblocks = sw * sh;
  uint8_t subblock_csbf[1024];
  memset(subblock_csbf, 0, nbr_subblocks);
  if (!(restr & R_TRANSFORM_CBF)) subblock_csbf[0] = 1;
  int sub_scan[1024];
  DeriveSubblockScan(scan_order, sw, sh, sub_scan);
  const int* scan_table = (subblock_shift == 1)
                              ? kScanCoeff2x2[scan_order]
                              : kScanCoeff4x4[scan_order];

  int subblock_last_index = nbr_subblocks - 1;
  int subblock_last_coeff_offset = 1;
  uint32_t coeff_signs = 0;
  int coeff_num_non_zero = 0;
  int total_num_sig_coeff = 0;
  int subblock_coeff[16];
  int subblock_pos[16];
  memset(subblock_coeff, 0, sizeof(subblock_coeff));
  memset(subblock_pos, 0, sizeof(subblock_pos));
  int pos_last_index = 0;
  int pos_last_x = 0, pos_last_y = 0;

  for (int subblock_index = 0; subblock_index < nbr_subblocks;
       subblock_index++) {
    int subblock_scan = sub_scan[subblock_index];
    int sy = subblock_scan / sw;
    int sx = subblock_scan - sy * sw;
    int spx = sx << subblock_shift, spy = sy << subblock_shift;
    for (int coeff_index = 0; coeff_index < subblock_size; coeff_index++) {
      int so = scan_table[coeff_index];
      int cxx = spx + (so & subblock_mask);
      int cyy = spy + (so >> subblock_shift);
      if (src[cyy * stride + cxx]) {
        pos_last_index = (subblock_index << (2 * subblock_shift)) +
                         coeff_index;
        pos_last_x = cxx;
        pos_last_y = cyy;
        subblock_csbf[subblock_scan] = 1;
      }
    }
  }

  int last_nonzero_pos = -1;
  int first_nonzero_pos = subblock_size;
  if (!(restr & R_TRANSFORM_LAST_POSITION)) {
    WriteCoeffLastPos(e, p, pos_last_x, pos_last_y);
    subblock_last_index = pos_last_index >> (2 * subblock_shift);
    int last_coeff = src[pos_last_y * stride + pos_last_x];
    subblock_last_coeff_offset =
        ((subblock_last_index + 1) << (2 * subblock_shift)) -
        pos_last_index + 1;
    if ((restr & R_TRANSFORM_CBF) && (restr & R_TRANSFORM_SUBBLOCK_CSBF) &&
        pos_last_x == 0 && pos_last_y == 0) {
      subblock_last_coeff_offset -= 1;
    } else {
      coeff_num_non_zero = 1;
      coeff_signs = (last_coeff < 0) ? 1 : 0;
    }
    subblock_coeff[0] = abs(last_coeff);
    subblock_pos[0] = (pos_last_y << log2size) + pos_last_x;
    int subblock_last_offset = subblock_last_index << (2 * subblock_shift);
    last_nonzero_pos = pos_last_index - subblock_last_offset;
    first_nonzero_pos = pos_last_index - subblock_last_offset;
  }

  int c1 = 1;
  for (int subblock_index = subblock_last_index; subblock_index >= 0;
       subblock_index--) {
    int subblock_scan = sub_scan[subblock_index];
    int sy = subblock_scan / sw;
    int sx = subblock_scan - sy * sw;
    int spx = sx << subblock_shift, spy = sy << subblock_shift;

    if (restr & R_TRANSFORM_SUBBLOCK_CSBF) subblock_csbf[subblock_scan] = 1;
    int sig = subblock_csbf[subblock_scan] != 0;
    int is_last_subblock = (subblock_index == subblock_last_index &&
                            !(restr & R_TRANSFORM_LAST_POSITION) &&
                            !(restr & R_TRANSFORM_CBF));
    int is_first_subblock =
        (subblock_index == 0 && !(restr & R_TRANSFORM_CBF));
    int pattern_sig_ctx;
    if (is_last_subblock || is_first_subblock ||
        (restr & R_TRANSFORM_SUBBLOCK_CSBF)) {
      GetSubblockCsbfCtx(p, subblock_csbf, sx, sy, sw, sh, &pattern_sig_ctx);
    } else {
      int cidx =
          GetSubblockCsbfCtx(p, subblock_csbf, sx, sy, sw, sh,
                             &pattern_sig_ctx);
      EncodeBin(e, sig ? 1 : 0, cidx);
    }
    if (!sig) continue;

    for (int coeff_index = subblock_size - subblock_last_coeff_offset;
         coeff_index >= 0; coeff_index--) {
      int so = scan_table[coeff_index];
      int cxx = spx + (so & subblock_mask);
      int cyy = spy + (so >> subblock_shift);
      int coeff = src[cyy * stride + cxx];
      int not_first_subblock =
          subblock_index > 0 && !(restr & R_TRANSFORM_SUBBLOCK_CSBF);
      if (coeff_index == 0 && not_first_subblock && coeff_num_non_zero == 0) {
        // implicit 1
      } else {
        int cidx = GetCoeffSigCtx(p, pattern_sig_ctx, cxx, cyy, src, stride);
        EncodeBin(e, coeff ? 1 : 0, cidx);
      }
      if (coeff) {
        subblock_coeff[coeff_num_non_zero] = abs(coeff);
        subblock_pos[coeff_num_non_zero] = (cyy << log2size) + cxx;
        coeff_num_non_zero += 1;
        coeff_signs = (coeff_signs << 1) + ((coeff < 0) ? 1 : 0);
        if (last_nonzero_pos == -1) last_nonzero_pos = coeff_index;
        first_nonzero_pos = coeff_index;
      }
    }
    subblock_last_coeff_offset = 1;
    if (!coeff_num_non_zero) {
      last_nonzero_pos = -1;
      first_nonzero_pos = subblock_size;
      continue;
    }

    int max_num_c1_flags = kMaxNumC1Flags;
    if (restr & R_TRANSFORM_RESIDUAL_GREATER_THAN_FLAGS) max_num_c1_flags = 0;
    int ctx_set = (subblock_index > 0 && is_luma) ? 2 : 0;
    if (c1 == 0) ctx_set += 1;
    c1 = 1;
    int first_c2_idx = -1;
    for (int i = 0; i < coeff_num_non_zero; i++) {
      if (i == max_num_c1_flags) break;
      int cyy = subblock_pos[i] >> log2size;
      int cxx = subblock_pos[i] - (cyy << log2size);
      int greater1 = (subblock_coeff[i] > 1) ? 1 : 0;
      int cidx = GetCoeffGreater1Ctx(p, ctx_set, c1, cxx, cyy,
                                     (i == 0 && is_last_subblock), src,
                                     stride);
      EncodeBin(e, greater1, cidx);
      if (greater1) {
        c1 = 0;
        if (first_c2_idx == -1 && !(restr & R_TRANSFORM_RESIDUAL_GREATER2))
          first_c2_idx = i;
      } else if (0 < c1 && c1 < 3) {
        c1 += 1;
      }
    }

    if (first_c2_idx >= 0) {
      int cyy = subblock_pos[first_c2_idx] >> log2size;
      int cxx = subblock_pos[first_c2_idx] - (cyy << log2size);
      int greater2 = (subblock_coeff[first_c2_idx] > 2) ? 1 : 0;
      int cidx = GetCoeffGreater2Ctx(p, ctx_set, cxx, cyy,
                                     (first_c2_idx == 0 && is_last_subblock),
                                     src, stride);
      EncodeBin(e, greater2, cidx);
    }

    int sign_hidden = 0;
    if (!(restr & R_TRANSFORM_SIGN_HIDING) &&
        last_nonzero_pos - first_nonzero_pos > kSignHidingThreshold)
      sign_hidden = 1;
    last_nonzero_pos = -1;
    first_nonzero_pos = subblock_size;

    if (sign_hidden)
      EncodeBypassBins(e, coeff_signs >> 1, coeff_num_non_zero - 1);
    else
      EncodeBypassBins(e, coeff_signs, coeff_num_non_zero);

    if (c1 == 0 || coeff_num_non_zero > max_num_c1_flags) {
      int first_coeff_greater2 =
          (restr & R_TRANSFORM_RESIDUAL_GREATER2) ? 0 : 1;
      int golomb_rice_k = 0;
      for (int i = 0; i < coeff_num_non_zero; i++) {
        int cyy = subblock_pos[i] >> log2size;
        int cxx = subblock_pos[i] - (cyy << log2size);
        int base_level =
            (i < max_num_c1_flags) ? (2 + first_coeff_greater2) : 1;
        if (subblock_coeff[i] >= base_level) {
          if (!(restr & R_EXT2_CABAC_ALT_RESIDUAL_CTX))
            golomb_rice_k = GetCoeffGolombRiceK(cxx, cyy, width, height, src,
                                                stride);
          WriteCoeffRemainExpGolomb(e, restr, subblock_coeff[i] - base_level,
                                    golomb_rice_k);
          if (subblock_coeff[i] > 3 * (1 << golomb_rice_k) &&
              !(restr & R_TRANSFORM_ADAPTIVE_EXP_GOLOMB))
            golomb_rice_k = golomb_rice_k + 1 < 4 ? golomb_rice_k + 1 : 4;
        }
        if (subblock_coeff[i] >= 2) first_coeff_greater2 = 0;
      }
    }

    total_num_sig_coeff += coeff_num_non_zero;
    coeff_num_non_zero = 0;
    coeff_signs = 0;
  }
  return total_num_sig_coeff;
}

// ---- RDO quantization (codec/rdo_quant.py, ref: rdo_quant.cc:203-953) ----

static const int64_t kI64Max = 0x7FFFFFFFFFFFFFFFll;
static const int kLambdaPrecision = 16;
static const int kQuantShift = 14;
static const int kIQuantShift = 6;
static const int kMaxTrDynamicRange = 15;

struct RdoCodeState {
  int ctx_set = 0;
  int c1 = 1;
  int c1_idx = 0;
  int c2_idx = 0;
  int golomb_rice_k = 0;
};

static inline int64_t BitCost(int64_t bits, int64_t lambda_fp) {
  return (bits * lambda_fp) >> kLambdaPrecision;
}

static inline int64_t EBits(int state, int binval) {
  return kEntropyBits[state ^ binval];
}

// rdo_quant.py _abs_level_bits
static int64_t AbsLevelBits(uint64_t restr, int64_t quant_level, int c1_state,
                            int c2_state, const RdoCodeState& cs) {
  int base_level = (cs.c1_idx < kMaxNumC1Flags)
                       ? (2 + ((cs.c2_idx < kMaxNumC2Flags) ? 1 : 0))
                       : 1;
  int threshold = !(restr & R_EXT2_CABAC_ALT_RESIDUAL_CTX)
                      ? kGolombRiceRangeExt[cs.golomb_rice_k]
                      : kCoeffRemainBinReduction;
  int64_t bits_sum = kEntropyBypassBits;
  int grk = cs.golomb_rice_k;
  if (quant_level >= base_level) {
    int64_t code_number = quant_level - base_level;
    if (code_number < ((int64_t)threshold << grk)) {
      int64_t length = code_number >> grk;
      bits_sum += (length + 1 + grk) * kEntropyBypassBits;
    } else {
      int length = grk;
      code_number -= (int64_t)threshold << grk;
      while (code_number >= (1ll << length)) {
        code_number -= 1ll << length;
        length += 1;
      }
      int64_t num_bins = length + threshold + length + 1 - grk;
      bits_sum += num_bins * kEntropyBypassBits;
    }
    if (cs.c1_idx < kMaxNumC1Flags) {
      bits_sum += EBits(c1_state, 1);
      if (cs.c2_idx < kMaxNumC2Flags) bits_sum += EBits(c2_state, 1);
    }
  } else if (quant_level == 1) {
    bits_sum += EBits(c1_state, 0);
  } else if (quant_level == 2) {
    bits_sum += EBits(c1_state, 1);
    bits_sum += EBits(c2_state, 0);
  } else {
    return 0;
  }
  return bits_sum;
}

// rdo_quant.py _update_code_state
static void UpdateCodeState(int64_t quant_level, RdoCodeState* cs) {
  int base_level = (cs->c1_idx < kMaxNumC1Flags)
                       ? (2 + ((cs->c2_idx < kMaxNumC2Flags) ? 1 : 0))
                       : 1;
  if (quant_level >= 1) cs->c1_idx += 1;
  if (quant_level >= 2) {
    cs->c2_idx += 1;
    cs->c1 = 0;
  } else if (quant_level >= 1 && 0 < cs->c1 && cs->c1 < 3) {
    cs->c1 += 1;
  }
  if (quant_level >= base_level) {
    if (quant_level > 3ll * (1 << cs->golomb_rice_k))
      cs->golomb_rice_k =
          (cs->golomb_rice_k + 1 < 4) ? cs->golomb_rice_k + 1 : 4;
  }
}

// rdo_quant.py _last_pos_bits (counting only; no ctx update)
static int64_t LastPosBits(const CoeffCtxParams& p, const uint8_t* ctx,
                           int last_pos_x, int last_pos_y) {
  int width = p.width, height = p.height;
  int64_t bits = 0;
  if (p.scan_order == kVertical) {
    int t = last_pos_x; last_pos_x = last_pos_y; last_pos_y = t;
    t = width; width = height; height = t;
  }
  int group_idx_x = kLastPosGroupIdx[last_pos_x];
  int group_idx_y = kLastPosGroupIdx[last_pos_y];
  for (int i = 0; i < group_idx_x; i++)
    bits += EBits(ctx[GetCoeffLastPosCtx(p, width, height, i, 1)], 1);
  if (group_idx_x < kLastPosGroupIdx[width - 1])
    bits +=
        EBits(ctx[GetCoeffLastPosCtx(p, width, height, group_idx_x, 1)], 0);
  for (int i = 0; i < group_idx_y; i++)
    bits += EBits(ctx[GetCoeffLastPosCtx(p, width, height, i, 0)], 1);
  if (group_idx_y < kLastPosGroupIdx[height - 1])
    bits +=
        EBits(ctx[GetCoeffLastPosCtx(p, width, height, group_idx_y, 0)], 0);
  if (group_idx_x > 3)
    bits += (int64_t)((group_idx_x - 2) >> 1) * kEntropyBypassBits;
  if (group_idx_y > 3)
    bits += (int64_t)((group_idx_y - 2) >> 1) * kEntropyBypassBits;
  return bits;
}

XVCN_API int xvcn_quant_rdo(
    const uint8_t* ctx, const int32_t* offsets, uint64_t restr,
    int width, int height, int subblock_shift, int is_luma, int scan_order,
    int bitdepth, int qp_per, int fwd_scale_base, int64_t inv_scale_q,
    int64_t lambda_fp, int cbf_ctx_idx, int64_t rd_factor,
    const int32_t* src, int32_t* out, int stride) {
  CoeffCtxParams p;
  p.offsets = offsets; p.restr = restr; p.is_luma = is_luma;
  p.scan_order = scan_order; p.width = width; p.height = height;
  p.width_log2 = size_to_log2(width);
  p.height_log2 = size_to_log2(height);
  int width_log2 = p.width_log2, height_log2 = p.height_log2;
  int subblock_width = width >> subblock_shift;
  int subblock_height = height >> subblock_shift;
  int subblock_size = 1 << (2 * subblock_shift);
  int subblock_mask = (1 << subblock_shift) - 1;
  int transform_shift =
      kMaxTrDynamicRange - bitdepth - ((width_log2 + height_log2) >> 1);
  int size_rounding_bias = ((width_log2 + height_log2) % 2) ? 1 : 0;
  int shift = kQuantShift + qp_per + transform_shift;
  int size_bias_shift = size_rounding_bias ? 7 : 0;
  int64_t size_bias_offset =
      size_rounding_bias ? (1ll << (size_bias_shift - 1)) : 0;
  int64_t scale = (int64_t)fwd_scale_base * (size_rounding_bias ? 181 : 1);
  int cost_scale = kFracBitsPrecision - 2 * transform_shift -
                   2 * (bitdepth - 8) + 2 * size_rounding_bias;
  int fwd_shift = shift + size_bias_shift;
  int64_t fwd_offset = 1ll << (fwd_shift - 1);
  int inv_shift =
      kIQuantShift - transform_shift + (size_rounding_bias ? 8 : 0);
  int64_t inv_scale = inv_scale_q * (size_rounding_bias ? 181 : 1);

  int sub_scan[1024];
  DeriveSubblockScan(scan_order, subblock_width, subblock_height, sub_scan);
  const int* scan_table = (subblock_shift == 1)
                              ? kScanCoeff2x2[scan_order]
                              : kScanCoeff4x4[scan_order];
  int nbr_subblocks = subblock_width * subblock_height;

  uint8_t subblock_csbf[1024];
  int64_t csbf_bits_to_zero[1024];
  memset(subblock_csbf, 0, nbr_subblocks);
  memset(csbf_bits_to_zero, 0, nbr_subblocks * sizeof(int64_t));
  int n = width * height;
  // narrow per-coefficient side arrays: err_dist is stored as an int16
  // quantity already; the rate deltas are fractional-bit counts
  // (<= ~50 bins * 2^15 < 2^21) -- int32 with headroom.  Reads promote
  // to int64 in the cost arithmetic.
  static thread_local int16_t err_dist[4096];
  static thread_local int32_t sig_rate[4096];
  static thread_local int32_t rate_up[4096];
  static thread_local int32_t rate_down[4096];
  static thread_local int64_t coeff_cost_to_zero[4096];
  static thread_local int32_t coeff_sig_bits[4096];
  memset(err_dist, 0, n * sizeof(int16_t));
  memset(sig_rate, 0, n * sizeof(int32_t));
  memset(rate_up, 0, n * sizeof(int32_t));
  memset(rate_down, 0, n * sizeof(int32_t));
  memset(coeff_cost_to_zero, 0, n * sizeof(int64_t));
  memset(coeff_sig_bits, 0, n * sizeof(int32_t));

  RdoCodeState code_state;
  int last_pos_index = -1;
  int64_t comp_zero_dist = 0;
  int64_t comp_code_cost = 0;

  for (int si = nbr_subblocks - 1; si >= 0; si--) {
    int sscan = sub_scan[si];
    int ssy = sscan / subblock_width;
    int ssx = sscan - ssy * subblock_width;
    int spx = ssx << subblock_shift, spy = ssy << subblock_shift;
    int sub_index = si << (2 * subblock_shift);
    int last_c1 = code_state.c1;
    code_state = RdoCodeState();
    code_state.ctx_set = (sub_index > 0 && is_luma) ? 2 : 0;
    if (last_c1 == 0) code_state.ctx_set += 1;

    int64_t subblock_zero_dist = 0;
    int64_t subblock_code_cost = 0;
    // one pass gathers the subblock in scan order; the quantization and
    // zero-cost arithmetic then runs as straight-line (vectorizable)
    // loops shared by the fast path and the decision loop below
    int32_t abs_a[16];
    int64_t zc_a[16], q_a[16];
    for (int off = 0; off < subblock_size; off++) {
      int so = scan_table[off];
      int32_t a = src[(spy + (so >> subblock_shift)) * stride + spx +
                      (so & subblock_mask)];
      abs_a[off] = a < 0 ? -a : a;
    }
    for (int off = 0; off < subblock_size; off++) {
      int64_t a = abs_a[off];
      zc_a[off] = (a * a) << cost_scale;
      q_a[off] = (a * scale + fwd_offset) >> fwd_shift;
    }
    if (last_pos_index == -1) {
      // Trailing-subblock fast path: before the last position is found
      // the per-coefficient loop only zeroes and accumulates the zero
      // distortion; if nothing in this subblock quantizes nonzero the
      // whole subblock reduces to that (bit-exact shortcut — contexts,
      // code_state and the csbf arrays are untouched by zero runs).
      int64_t zc = 0, qsum = 0;
      for (int off = 0; off < subblock_size; off++) {
        zc += zc_a[off];
        qsum += q_a[off];
      }
      if (qsum == 0) {
        for (int off = 0; off < subblock_size; off++) {
          int so = scan_table[off];
          out[(spy + (so >> subblock_shift)) * stride + spx +
              (so & subblock_mask)] = 0;
        }
        comp_code_cost += zc;
        comp_zero_dist += zc;
        continue;
      }
    }
    int pattern_sig_ctx;
    int csbf_ctx = GetSubblockCsbfCtx(p, subblock_csbf, ssx, ssy,
                                      subblock_width, subblock_height,
                                      &pattern_sig_ctx);
    int num_non_zero = 0;

    for (int off = subblock_size - 1; off >= 0; off--) {
      int so = scan_table[off];
      int scan_x = spx + (so & subblock_mask);
      int scan_y = spy + (so >> subblock_shift);
      int index = sub_index + off;
      int64_t abs_coeff = abs_a[off];
      int64_t coeff_zero_cost = zc_a[off];
      subblock_zero_dist += coeff_zero_cost;
      int64_t quant_coeff = q_a[off];
      if (quant_coeff && last_pos_index == -1) {
        last_pos_index = index;
      } else if (last_pos_index == -1) {
        out[scan_y * stride + scan_x] = 0;
        subblock_code_cost += coeff_zero_cost;
        continue;
      }

      int sig_ctx, c1_ctx, c2_ctx;
      if (!(restr & R_EXT2_CABAC_ALT_RESIDUAL_CTX)) {
        // Default residual coding: all four contexts share one
        // 5-neighbor scan over the already-decided levels.
        CoeffNbrStats ns =
            CoeffNeighborStats(scan_x, scan_y, width, height, out, stride);
        sig_ctx = (restr & R_CABAC_COEFF_SIG_CTX)
                      ? p.offsets[F_EXT_SIG_LUMA]
                      : ExtSigCtxFromStats(p, scan_x, scan_y, ns.nz);
        c1_ctx = (restr & R_CABAC_COEFF_GREATER1_CTX)
                     ? p.offsets[is_luma ? F_EXT_GREATER1_LUMA
                                         : F_EXT_GREATER1_CHROMA]
                     : ExtGreaterCtxFromStats(p, scan_x, scan_y,
                                              index == last_pos_index,
                                              ns.gt1);
        c2_ctx = (restr & R_CABAC_COEFF_GREATER2_CTX)
                     ? p.offsets[is_luma ? F_EXT_GREATER1_LUMA
                                         : F_EXT_GREATER1_CHROMA]
                     : ExtGreaterCtxFromStats(p, scan_x, scan_y,
                                              index == last_pos_index,
                                              ns.gt2);
        code_state.golomb_rice_k = GolombRiceKFromStats(ns.abs_sum, ns.nz);
      } else {
        sig_ctx = GetCoeffSigCtx(p, pattern_sig_ctx, scan_x, scan_y, out,
                                 stride);
        c1_ctx = GetCoeffGreater1Ctx(p, code_state.ctx_set, code_state.c1,
                                     scan_x, scan_y,
                                     index == last_pos_index, out, stride);
        c2_ctx = GetCoeffGreater2Ctx(p, code_state.ctx_set, scan_x, scan_y,
                                     index == last_pos_index, out, stride);
      }
      int64_t sig0_bits = EBits(ctx[sig_ctx], 0);
      int64_t sig1_bits = EBits(ctx[sig_ctx], 1);
      if (last_pos_index == index ||
          (sub_index > 0 && off == 0 && num_non_zero == 0))
        sig1_bits = 0;

      int64_t best_cost = kI64Max;
      int64_t best_cost_sig = 0;
      int64_t best_level = quant_coeff;
      if (quant_coeff > 0) {
        best_cost_sig = sig1_bits;
        // _quant_coeff_rdo
        int c1_state = ctx[c1_ctx], c2_state = ctx[c2_ctx];
        int64_t bl = quant_coeff, bc = kI64Max;
        for (int step = 0; step < 2; step++) {
          int64_t level = quant_coeff - 1 + step;
          if (step == 0 && quant_coeff <= 1) continue;
          int64_t bits = sig1_bits + AbsLevelBits(restr, level, c1_state,
                                                  c2_state, code_state);
          int64_t dequant;
          if (inv_shift > 0)
            dequant = (level * inv_scale + (1ll << (inv_shift - 1))) >>
                      inv_shift;
          else
            dequant = (level * inv_scale) << (-inv_shift);
          if (dequant < -32768) dequant = -32768;
          if (dequant > 32767) dequant = 32767;
          int64_t err = abs_coeff - dequant;
          int64_t cost = ((err * err) << cost_scale) +
                         BitCost(bits, lambda_fp);
          if (step == 0 || cost <= bc) {
            bc = cost;
            bl = level;
          }
        }
        best_level = bl;
        best_cost = bc;
      }
      if (last_pos_index != index && quant_coeff < 3) {
        int64_t cost = coeff_zero_cost + BitCost(sig0_bits, lambda_fp);
        if (cost <= best_cost) {
          best_cost = cost;
          best_cost_sig = sig0_bits;
          best_level = 0;
        }
      }
      out[scan_y * stride + scan_x] = (int32_t)best_level;
      coeff_cost_to_zero[index] = coeff_zero_cost - best_cost;
      coeff_sig_bits[index] = best_cost_sig;
      subblock_code_cost += best_cost;
      int64_t orig_scaled =
          (abs_coeff * scale + size_bias_offset) >> size_bias_shift;
      int64_t quant_err = orig_scaled - (best_level << shift);
      err_dist[index] = (int16_t)(quant_err >> (shift - 8));
      sig_rate[index] =
          (last_pos_index != index) ? (sig1_bits - sig0_bits) : 0;
      if (best_level) {
        subblock_csbf[sscan] = 1;
        num_non_zero += 1;
        int c1_state = ctx[c1_ctx], c2_state = ctx[c2_ctx];
        int64_t lvl_rate =
            AbsLevelBits(restr, best_level, c1_state, c2_state, code_state);
        rate_up[index] = -lvl_rate + AbsLevelBits(restr, best_level + 1,
                                                  c1_state, c2_state,
                                                  code_state);
        rate_down[index] = -lvl_rate + AbsLevelBits(restr, best_level - 1,
                                                    c1_state, c2_state,
                                                    code_state);
      } else {
        rate_up[index] = EBits(ctx[c1_ctx], 0);
      }
      UpdateCodeState(best_level, &code_state);
    }

    // _eval_zero_subblock
    {
      int64_t csbf_bits = 0;
      bool zeroed = false;
      if (last_pos_index >= 0 && sub_index != 0 &&
          sub_index + subblock_size <= last_pos_index) {
        int csbf_state = ctx[csbf_ctx];
        int64_t csbf_zero_cost = EBits(csbf_state, 0);
        int64_t csbf_code_bits = EBits(csbf_state, 1);
        int64_t subblock_zero_cost =
            subblock_zero_dist + BitCost(csbf_zero_cost, lambda_fp);
        if (subblock_csbf[sscan]) {
          int64_t cost_cost =
              subblock_code_cost + BitCost(csbf_code_bits, lambda_fp);
          if (subblock_zero_cost < cost_cost) {
            zeroed = true;
            csbf_bits = csbf_zero_cost;
            subblock_code_cost = subblock_zero_cost;
          } else {
            csbf_bits = csbf_code_bits;
            subblock_code_cost = cost_cost;
          }
        } else {
          csbf_bits = csbf_zero_cost;
          subblock_code_cost = subblock_zero_cost;
        }
      }
      csbf_bits_to_zero[sscan] = csbf_bits;
      if (zeroed) {
        subblock_csbf[sscan] = 0;
        for (int off = 0; off < subblock_size; off++) {
          int so = scan_table[off];
          out[(spy + (so >> subblock_shift)) * stride + spx +
              (so & subblock_mask)] = 0;
          coeff_cost_to_zero[sub_index + off] = 0;
        }
      }
    }
    comp_code_cost += subblock_code_cost;
    comp_zero_dist += subblock_zero_dist;
  }

  if (last_pos_index < 0) return 0;

  // _eval_last_pos
  {
    int cbf_state = ctx[cbf_ctx_idx];
    comp_code_cost += BitCost(EBits(cbf_state, 1), lambda_fp);
    int start_last_index = last_pos_index % subblock_size;
    int64_t best_cost = kI64Max;
    int best_last_pos_plus1 = 0;
    bool stop_search = false;
    for (int si = nbr_subblocks - 1; si >= 0; si--) {
      int sub_index = si << (2 * subblock_shift);
      if (sub_index > last_pos_index) continue;
      int sscan = sub_scan[si];
      comp_code_cost -= BitCost(csbf_bits_to_zero[sscan], lambda_fp);
      if (!subblock_csbf[sscan]) continue;
      int ssy = sscan / subblock_width;
      int ssx = sscan - ssy * subblock_width;
      int spx = ssx << subblock_shift, spy = ssy << subblock_shift;
      for (int off = start_last_index; off >= 0; off--) {
        int so = scan_table[off];
        int scan_x = spx + (so & subblock_mask);
        int scan_y = spy + (so >> subblock_shift);
        int index = sub_index + off;
        int coeff_val = out[scan_y * stride + scan_x];
        if (!coeff_val) {
          comp_code_cost += coeff_cost_to_zero[index];
          continue;
        }
        int64_t last_pos_bits = LastPosBits(p, ctx, scan_x, scan_y);
        int64_t implicit_sig = coeff_sig_bits[index];
        int64_t cost = comp_code_cost + BitCost(last_pos_bits, lambda_fp) -
                       BitCost(implicit_sig, lambda_fp);
        if (cost < best_cost) {
          best_cost = cost;
          best_last_pos_plus1 = index + 1;
        }
        if (coeff_val > 1) {
          stop_search = true;
          break;
        }
        comp_code_cost += coeff_cost_to_zero[index];
      }
      if (stop_search) break;
      start_last_index = subblock_size - 1;
    }
    int64_t comp_zero_cost =
        comp_zero_dist + BitCost(EBits(cbf_state, 0), lambda_fp);
    if (comp_zero_cost < best_cost) {
      for (int y = 0; y < height; y++)
        memset(out + y * stride, 0, width * sizeof(int32_t));
      return 0;
    }
    last_pos_index = best_last_pos_plus1;
  }
  if (last_pos_index < 0) {
    for (int y = 0; y < height; y++)
      memset(out + y * stride, 0, width * sizeof(int32_t));
    return 0;
  }

  int last_subblock_index = last_pos_index - (last_pos_index &
                                              (subblock_size - 1));
  for (int si = nbr_subblocks - 1; si >= 0; si--) {
    int sub_index = si << (2 * subblock_shift);
    if (sub_index < last_subblock_index) break;
    int sscan = sub_scan[si];
    int ssy = sscan / subblock_width;
    int ssx = sscan - ssy * subblock_width;
    int spx = ssx << subblock_shift, spy = ssy << subblock_shift;
    int last_pos_index_end = 0;
    if (sub_index == last_subblock_index)
      last_pos_index_end = last_pos_index % subblock_size;
    for (int off = subblock_size - 1; off >= last_pos_index_end; off--) {
      int so = scan_table[off];
      out[(spy + (so >> subblock_shift)) * stride + spx +
          (so & subblock_mask)] = 0;
    }
  }

  int num_non_zero = 0;
  for (int y = 0; y < height; y++)
    for (int x = 0; x < width; x++) {
      if (out[y * stride + x]) num_non_zero += 1;
      if (src[y * stride + x] < 0) out[y * stride + x] = -out[y * stride + x];
    }

  if ((restr & R_TRANSFORM_SIGN_HIDING) || num_non_zero <= 1 ||
      subblock_shift <= 1)
    return num_non_zero;

  // _sign_hide_rdo
  num_non_zero = 0;
  int is_last_subblock = -1;
  for (int si = nbr_subblocks - 1; si >= 0; si--) {
    int sscan = sub_scan[si];
    int ssy = sscan / subblock_width;
    int ssx = sscan - ssy * subblock_width;
    int spx = ssx << subblock_shift, spy = ssy << subblock_shift;
    int sub_index = si << (2 * subblock_shift);

    int first_in_subblock = subblock_size;
    int last_in_subblock = -1;
    int64_t subblock_sum = 0;
    for (int off = subblock_size - 1; off >= 0; off--) {
      int so = scan_table[off];
      int v = out[(spy + (so >> subblock_shift)) * stride + spx +
                  (so & subblock_mask)];
      if (v) {
        if (off < first_in_subblock) first_in_subblock = off;
        if (off > last_in_subblock) last_in_subblock = off;
        subblock_sum += v;
        num_non_zero += 1;
      }
    }
    if (last_in_subblock >= 0 && is_last_subblock == -1)
      is_last_subblock = 1;
    if (last_in_subblock - first_in_subblock < 4) {
      if (is_last_subblock == 1) is_last_subblock = 0;
      continue;
    }
    int so_f = scan_table[first_in_subblock];
    int first_sign = (out[(spy + (so_f >> subblock_shift)) * stride + spx +
                          (so_f & subblock_mask)] > 0)
                         ? 0
                         : 1;
    if (first_sign == (subblock_sum & 1)) {
      if (is_last_subblock == 1) is_last_subblock = 0;
      continue;
    }
    int start_off =
        (is_last_subblock == 1) ? last_in_subblock : subblock_size - 1;
    int64_t best_cost = kI64Max;
    int best_level_delta = 0;
    int best_y = -1, best_x = -1;
    for (int off = start_off; off >= 0; off--) {
      int so = scan_table[off];
      int yy = spy + (so >> subblock_shift);
      int xx = spx + (so & subblock_mask);
      int index = sub_index + off;
      int coeff_lvl = out[yy * stride + xx];
      int64_t cost;
      int level_delta;
      if (coeff_lvl != 0) {
        int64_t cost_inc = rd_factor * (-err_dist[index]) + rate_up[index];
        int64_t cost_dec =
            rd_factor * err_dist[index] + rate_down[index] -
            ((abs(coeff_lvl) == 1) ? sig_rate[index] : 0);
        if (is_last_subblock == 1 && off == last_in_subblock &&
            abs(coeff_lvl) == 1)
          cost_dec -= 4ll * kEntropyBypassBits;
        if (cost_inc < cost_dec) {
          cost = cost_inc;
          level_delta = 1;
        } else {
          level_delta = -1;
          if (off == first_in_subblock && abs(coeff_lvl) == 1)
            cost = (1ll << 31) - 1;
          else
            cost = cost_dec;
        }
      } else {
        int64_t ed = err_dist[index];
        cost = rd_factor * -(ed < 0 ? -ed : ed) + rate_up[index] +
               sig_rate[index] + kEntropyBypassBits;
        level_delta = 1;
        if (off < first_in_subblock) {
          int sign = (src[yy * stride + xx] >= 0) ? 0 : 1;
          if (sign != first_sign) cost = (1ll << 31) - 1;
        }
      }
      if (cost < best_cost) {
        best_cost = cost;
        best_level_delta = level_delta;
        best_y = yy;
        best_x = xx;
      }
    }
    int cur = out[best_y * stride + best_x];
    if (cur == 32767 || cur == -32768) best_level_delta = -1;
    if (!cur) num_non_zero += 1;
    if (src[best_y * stride + best_x] >= 0)
      out[best_y * stride + best_x] += best_level_delta;
    else
      out[best_y * stride + best_x] -= best_level_delta;
    if (!out[best_y * stride + best_x]) num_non_zero -= 1;
    if (is_last_subblock == 1) is_last_subblock = 0;
  }
  return num_non_zero;
}

XVCN_API int xvcn_version() { return 1; }

// ---- deblocking filter (ops/deblock.py, ref: deblocking_filter.cc) ----

static const int kDeblockTcTable[54] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6,
    7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};
static const int kDeblockBetaTable[64] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9,
    10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30,
    32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60,
    62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88};

// deblock restriction flag bits (order mirrors native/__init__.py
// DEBLOCK_FLAG_ORDER)
enum DeblockFlagBit {
  D_STRONG_FILTER = 1 << 0,
  D_WEAK_FILTER = 1 << 1,
  D_BOUNDARY_STRENGTH_ZERO = 1 << 2,
  D_BOUNDARY_STRENGTH_ONE = 1 << 3,
  D_INITIAL_SAMPLE_DECISION = 1 << 4,
  D_WEAK_SAMPLE_DECISION = 1 << 5,
  D_TWO_SAMPLES_WEAK_FILTER = 1 << 6,
  D_DEPENDING_ON_QP = 1 << 7,
};

// per-CU attribute record layout (mirrors codec/deblock_native.py)
enum CuAttr {
  A_POS_X = 0, A_POS_Y, A_WIDTH, A_HEIGHT, A_IS_INTRA, A_CBF_Y,
  A_QP0, A_QP1, A_REF_POC0, A_REF_POC1, A_REF_IDX0, A_MV0,  // A_MV0..+15
  A_NUM = A_MV0 + 16,
};

template <typename T>
struct DeblockCtx {
  T* plane;           // current component plane (padded origin applied)
  int64_t stride;
  int bitdepth;
  int beta_offset, tc_offset;
  uint64_t dflags;
};

template <typename T>
static inline int32_t DbGet(const DeblockCtx<T>& c, int x, int y, int dir,
                            int i, int j) {
  // i = along edge, j = across edge (negative = p side)
  if (dir == 0) return c.plane[(int64_t)(y + i) * c.stride + x + j];
  return c.plane[(int64_t)(y + j) * c.stride + x + i];
}
template <typename T>
static inline void DbSet(const DeblockCtx<T>& c, int x, int y, int dir,
                         int i, int j, int32_t v) {
  if (dir == 0) c.plane[(int64_t)(y + i) * c.stride + x + j] = (T)v;
  else c.plane[(int64_t)(y + j) * c.stride + x + i] = (T)v;
}

static int DeblockBoundaryStrength(const int32_t* p, const int32_t* q,
                                   int pos_x, int pos_y, int dir,
                                   int pred_type_bi, uint64_t dflags) {
  const int one_step = 16;
  int bs = (dflags & D_BOUNDARY_STRENGTH_ZERO) ? 1 : 0;
  int corner_p, corner_q;
  if (dir == 0) {
    corner_p = (pos_y - p[A_POS_Y]) < (p[A_HEIGHT] >> 1) ? 1 : 3;
    corner_q = (pos_y - q[A_POS_Y]) < (q[A_HEIGHT] >> 1) ? 0 : 2;
  } else {
    corner_p = (pos_x - p[A_POS_X]) < (p[A_WIDTH] >> 1) ? 2 : 3;
    corner_q = (pos_x - q[A_POS_X]) < (q[A_WIDTH] >> 1) ? 0 : 1;
  }
  const int32_t* mvp0 = p + A_MV0 + corner_p * 2;
  const int32_t* mvp1 = p + A_MV0 + 8 + corner_p * 2;
  const int32_t* mvq0 = q + A_MV0 + corner_q * 2;
  const int32_t* mvq1 = q + A_MV0 + 8 + corner_q * 2;
  if (p[A_IS_INTRA] || q[A_IS_INTRA]) {
    bs = 2;
  } else if (p[A_CBF_Y] || q[A_CBF_Y]) {
    bs = 1;
  } else if (pred_type_bi) {
    int rp0 = p[A_REF_POC0], rp1 = p[A_REF_POC1];
    int rq0 = q[A_REF_POC0], rq1 = q[A_REF_POC1];
    if ((rp0 == rq0 && rp1 == rq1) || (rp0 == rq1 && rp1 == rq0)) {
      bool c1 = abs(mvp0[0] - mvq0[0]) >= one_step ||
                abs(mvp0[1] - mvq0[1]) >= one_step ||
                abs(mvp1[0] - mvq1[0]) >= one_step ||
                abs(mvp1[1] - mvq1[1]) >= one_step;
      bool c2 = abs(mvp0[0] - mvq1[0]) >= one_step ||
                abs(mvp0[1] - mvq1[1]) >= one_step ||
                abs(mvp1[0] - mvq0[0]) >= one_step ||
                abs(mvp1[1] - mvq0[1]) >= one_step;
      if (rp0 != rp1) {
        if (rp0 == rq0) {
          if (c1) bs = 1;
        } else {
          if (c2) bs = 1;
        }
      } else {
        if (c1 && c2) bs = 1;
      }
    } else {
      bs = 1;
    }
  } else {
    if (p[A_REF_IDX0] != q[A_REF_IDX0]) {
      bs = 1;
    } else {
      if (abs(mvp0[0] - mvq0[0]) >= one_step ||
          abs(mvp0[1] - mvq0[1]) >= one_step)
        bs = 1;
    }
  }
  if (bs == 1 && (dflags & D_BOUNDARY_STRENGTH_ONE)) bs = 2;
  return bs;
}

#if defined(__AVX2__)
// ---- 4-lane deblock filter kernels ----
// One group = 4 consecutive positions along the edge; lanes are those
// positions, s[0..7] = p3,p2,p1,p0,q0,q1,q2,q3 across the edge.  For
// horizontal edges (dir==1) the lanes are contiguous columns; for
// vertical edges (dir==0) a 4x4 transpose in each half gives the same
// layout.  All math mirrors the scalar loops op-for-op (bit-exact).
struct Db4 { __m128i s[8]; };

// sample-type-dispatched vector load/store: lanes are widened to int32
// on load and packed back on store so ALL the filter math below is
// shared between the int32 (Python-path) and int16 (native rec
// surface) plane types, bit-exactly
static inline __m128i db_load4(const int32_t* p) {
  return _mm_loadu_si128((const __m128i*)p);
}
static inline __m128i db_load4(const int16_t* p) {
  return _mm_cvtepi16_epi32(_mm_loadl_epi64((const __m128i*)p));
}
static inline void db_store4(int32_t* p, __m128i v) {
  _mm_storeu_si128((__m128i*)p, v);
}
static inline void db_store4(int16_t* p, __m128i v) {
  _mm_storel_epi64((__m128i*)p, _mm_packs_epi32(v, v));
}
static inline void db_load8(const int32_t* p, __m128i* lo, __m128i* hi) {
  *lo = _mm_loadu_si128((const __m128i*)p);
  *hi = _mm_loadu_si128((const __m128i*)(p + 4));
}
static inline void db_load8(const int16_t* p, __m128i* lo, __m128i* hi) {
  __m128i r = _mm_loadu_si128((const __m128i*)p);
  *lo = _mm_cvtepi16_epi32(r);
  *hi = _mm_cvtepi16_epi32(_mm_srli_si128(r, 8));
}
static inline void db_store8(int32_t* p, __m128i lo, __m128i hi) {
  _mm_storeu_si128((__m128i*)p, lo);
  _mm_storeu_si128((__m128i*)(p + 4), hi);
}
static inline void db_store8(int16_t* p, __m128i lo, __m128i hi) {
  _mm_storeu_si128((__m128i*)p, _mm_packs_epi32(lo, hi));
}

static inline void db4_transpose(__m128i r0, __m128i r1, __m128i r2,
                                 __m128i r3, __m128i* o) {
  __m128i t0 = _mm_unpacklo_epi32(r0, r1);
  __m128i t1 = _mm_unpackhi_epi32(r0, r1);
  __m128i t2 = _mm_unpacklo_epi32(r2, r3);
  __m128i t3 = _mm_unpackhi_epi32(r2, r3);
  o[0] = _mm_unpacklo_epi64(t0, t2);
  o[1] = _mm_unpackhi_epi64(t0, t2);
  o[2] = _mm_unpacklo_epi64(t1, t3);
  o[3] = _mm_unpackhi_epi64(t1, t3);
}

template <typename T>
static inline Db4 db4_load(const DeblockCtx<T>& c, int x, int y, int dir,
                           int g) {
  Db4 d;
  if (dir == 1) {
    for (int j = 0; j < 8; j++)
      d.s[j] = db_load4(c.plane + (int64_t)(y + j - 4) * c.stride + x + g);
  } else {
    __m128i lo[4], hi[4];
    for (int i = 0; i < 4; i++) {
      const T* r = c.plane + (int64_t)(y + g + i) * c.stride + x - 4;
      db_load8(r, &lo[i], &hi[i]);
    }
    db4_transpose(lo[0], lo[1], lo[2], lo[3], d.s);
    db4_transpose(hi[0], hi[1], hi[2], hi[3], d.s + 4);
  }
  return d;
}

template <typename T>
static inline void db4_store(const DeblockCtx<T>& c, int x, int y, int dir,
                             int g, const Db4& d) {
  if (dir == 1) {
    for (int j = 1; j < 7; j++)  // only p2..q2 can change
      db_store4(c.plane + (int64_t)(y + j - 4) * c.stride + x + g, d.s[j]);
  } else {
    __m128i lo[4], hi[4];
    db4_transpose(d.s[0], d.s[1], d.s[2], d.s[3], lo);
    db4_transpose(d.s[4], d.s[5], d.s[6], d.s[7], hi);
    for (int i = 0; i < 4; i++) {
      T* r = c.plane + (int64_t)(y + g + i) * c.stride + x - 4;
      db_store8(r, lo[i], hi[i]);
    }
  }
}

static inline __m128i db_clamp_add(__m128i nv, __m128i v, __m128i lim) {
  __m128i d = _mm_sub_epi32(nv, v);
  d = _mm_max_epi32(d, _mm_sub_epi32(_mm_setzero_si128(), lim));
  d = _mm_min_epi32(d, lim);
  return _mm_add_epi32(v, d);
}

static inline __m128i db_clip_px(__m128i v, __m128i vmax) {
  return _mm_min_epi32(_mm_max_epi32(v, _mm_setzero_si128()), vmax);
}
#endif  // __AVX2__

template <typename T>
static bool DeblockCheckStrong(const DeblockCtx<T>& c, int x, int y, int dir,
                               int i, int beta, int tc) {
  int p3 = DbGet(c, x, y, dir, i, -4), p0 = DbGet(c, x, y, dir, i, -1);
  int q0 = DbGet(c, x, y, dir, i, 0), q3 = DbGet(c, x, y, dir, i, 3);
  return (abs(p3 - p0) + abs(q0 - q3)) < (beta >> 3) &&
         abs(p0 - q0) < ((tc * 5 + 1) >> 1);
}

template <typename T>
static void DeblockFilterEdgeLuma(const DeblockCtx<T>& c, int x, int y,
                                  int dir, int subblock_size, int bs,
                                  int qp) {
  const int group = 4;
  int bitdepth_shift = c.bitdepth - 8;
  int sample_max = (1 << c.bitdepth) - 1;
  int nbr_groups = subblock_size / group;
  for (int gi = 0; gi < nbr_groups; gi++) {
    int index_beta = qp + c.beta_offset;
    if (index_beta < 0) index_beta = 0;
    if (index_beta > 63) index_beta = 63;
    int beta = kDeblockBetaTable[index_beta] << bitdepth_shift;
    int g = gi * group;
#if defined(__AVX2__)
    // one vector load of the whole group feeds the gating decisions AND
    // the filters (the scalar path re-gathers ~20 samples per group)
    Db4 blk = db4_load(c, x, y, dir, g);
    __m128i dpv = _mm_abs_epi32(_mm_add_epi32(
        _mm_sub_epi32(blk.s[1], _mm_slli_epi32(blk.s[2], 1)), blk.s[3]));
    __m128i dqv = _mm_abs_epi32(_mm_add_epi32(
        _mm_sub_epi32(blk.s[4], _mm_slli_epi32(blk.s[5], 1)), blk.s[6]));
    int dp0 = _mm_extract_epi32(dpv, 0), dp3 = _mm_extract_epi32(dpv, 3);
    int dq0 = _mm_extract_epi32(dqv, 0), dq3 = _mm_extract_epi32(dqv, 3);
#else
    auto dp = [&](int i) {
      return abs(DbGet(c, x, y, dir, i, -3) - 2 * DbGet(c, x, y, dir, i, -2) +
                 DbGet(c, x, y, dir, i, -1));
    };
    auto dq = [&](int i) {
      return abs(DbGet(c, x, y, dir, i, 0) - 2 * DbGet(c, x, y, dir, i, 1) +
                 DbGet(c, x, y, dir, i, 2));
    };
    int dp0 = dp(g), dq0 = dq(g), dp3 = dp(g + 3), dq3 = dq(g + 3);
#endif
    int d0 = dp0 + dq0, d3 = dp3 + dq3;
    int d = d0 + d3;
    if (d >= beta && !(c.dflags & D_INITIAL_SAMPLE_DECISION)) continue;
    int index_tc = qp + c.tc_offset + 2 * (bs - 1);
    if (index_tc < 0) index_tc = 0;
    if (index_tc > 53) index_tc = 53;
    int tc = kDeblockTcTable[index_tc] << bitdepth_shift;

#if defined(__AVX2__)
    __m128i str1 = _mm_add_epi32(
        _mm_abs_epi32(_mm_sub_epi32(blk.s[0], blk.s[3])),
        _mm_abs_epi32(_mm_sub_epi32(blk.s[4], blk.s[7])));
    __m128i str2 = _mm_abs_epi32(_mm_sub_epi32(blk.s[3], blk.s[4]));
    int b8 = beta >> 3, t5 = (tc * 5 + 1) >> 1;
    bool strong = ((d0 << 1) < (beta >> 2)) && ((d3 << 1) < (beta >> 2)) &&
                  _mm_extract_epi32(str1, 0) < b8 &&
                  _mm_extract_epi32(str2, 0) < t5 &&
                  _mm_extract_epi32(str1, 3) < b8 &&
                  _mm_extract_epi32(str2, 3) < t5;
#else
    bool strong = ((d0 << 1) < (beta >> 2)) && ((d3 << 1) < (beta >> 2)) &&
                  DeblockCheckStrong(c, x, y, dir, g, beta, tc) &&
                  DeblockCheckStrong(c, x, y, dir, g + 3, beta, tc);
#endif
    if (strong && !(c.dflags & D_STRONG_FILTER)) {
      int tc2 = 2 * tc;
#if defined(__AVX2__)
      Db4 d = blk;
      const __m128i p3 = d.s[0], p2 = d.s[1], p1 = d.s[2], p0 = d.s[3];
      const __m128i q0 = d.s[4], q1 = d.s[5], q2 = d.s[6], q3 = d.s[7];
      const __m128i vtc2 = _mm_set1_epi32(tc2);
      const __m128i c2 = _mm_set1_epi32(2), c4 = _mm_set1_epi32(4);
      auto add3 = [](__m128i a, __m128i b, __m128i cc) {
        return _mm_add_epi32(_mm_add_epi32(a, b), cc);
      };
      __m128i np2 = _mm_srai_epi32(
          add3(_mm_slli_epi32(p3, 1),
               _mm_add_epi32(_mm_slli_epi32(p2, 1), p2),
               add3(p1, p0, _mm_add_epi32(q0, c4))), 3);
      __m128i np1 = _mm_srai_epi32(add3(p2, p1, add3(p0, q0, c2)), 2);
      __m128i np0 = _mm_srai_epi32(
          add3(p2, _mm_slli_epi32(p1, 1),
               add3(_mm_slli_epi32(p0, 1), _mm_slli_epi32(q0, 1),
                    _mm_add_epi32(q1, c4))), 3);
      __m128i nq0 = _mm_srai_epi32(
          add3(p1, _mm_slli_epi32(p0, 1),
               add3(_mm_slli_epi32(q0, 1), _mm_slli_epi32(q1, 1),
                    _mm_add_epi32(q2, c4))), 3);
      __m128i nq1 = _mm_srai_epi32(add3(p0, q0, add3(q1, q2, c2)), 2);
      __m128i nq2 = _mm_srai_epi32(
          add3(p0, q0, add3(q1, _mm_add_epi32(_mm_slli_epi32(q2, 1), q2),
                            _mm_add_epi32(_mm_slli_epi32(q3, 1), c4))), 3);
      d.s[1] = db_clamp_add(np2, p2, vtc2);
      d.s[2] = db_clamp_add(np1, p1, vtc2);
      d.s[3] = db_clamp_add(np0, p0, vtc2);
      d.s[4] = db_clamp_add(nq0, q0, vtc2);
      d.s[5] = db_clamp_add(nq1, q1, vtc2);
      d.s[6] = db_clamp_add(nq2, q2, vtc2);
      db4_store(c, x, y, dir, g, d);
#else
      for (int i = g; i < g + group; i++) {
        int p3 = DbGet(c, x, y, dir, i, -4), p2 = DbGet(c, x, y, dir, i, -3);
        int p1 = DbGet(c, x, y, dir, i, -2), p0 = DbGet(c, x, y, dir, i, -1);
        int q0 = DbGet(c, x, y, dir, i, 0), q1 = DbGet(c, x, y, dir, i, 1);
        int q2 = DbGet(c, x, y, dir, i, 2), q3 = DbGet(c, x, y, dir, i, 3);
        int np2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
        int np1 = (p2 + p1 + p0 + q0 + 2) >> 2;
        int np0 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
        int nq0 = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3;
        int nq1 = (p0 + q0 + q1 + q2 + 2) >> 2;
        int nq2 = (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3;
        auto cl = [&](int nv, int v) {
          int dlt = nv - v;
          if (dlt < -tc2) dlt = -tc2;
          if (dlt > tc2) dlt = tc2;
          return v + dlt;
        };
        DbSet(c, x, y, dir, i, -3, cl(np2, p2));
        DbSet(c, x, y, dir, i, -2, cl(np1, p1));
        DbSet(c, x, y, dir, i, -1, cl(np0, p0));
        DbSet(c, x, y, dir, i, 0, cl(nq0, q0));
        DbSet(c, x, y, dir, i, 1, cl(nq1, q1));
        DbSet(c, x, y, dir, i, 2, cl(nq2, q2));
      }
#endif
    } else {
      if (c.dflags & D_WEAK_FILTER) continue;
      int side_threshold = (beta + (beta >> 1)) >> 3;
      bool filter_p1 = (dp0 + dp3) < side_threshold;
      bool filter_q1 = (dq0 + dq3) < side_threshold;
      int threshold = tc * 10;
      int half_tc = tc >> 1;
#if defined(__AVX2__)
      Db4 d = blk;
      const __m128i p2 = d.s[1], p1 = d.s[2], p0 = d.s[3];
      const __m128i q0 = d.s[4], q1 = d.s[5], q2 = d.s[6];
      __m128i delta = _mm_srai_epi32(
          _mm_add_epi32(
              _mm_sub_epi32(
                  _mm_mullo_epi32(_mm_set1_epi32(9), _mm_sub_epi32(q0, p0)),
                  _mm_mullo_epi32(_mm_set1_epi32(3), _mm_sub_epi32(q1, p1))),
              _mm_set1_epi32(8)), 4);
      __m128i apply;
      if (c.dflags & D_WEAK_SAMPLE_DECISION) {
        apply = _mm_set1_epi32(-1);
      } else {
        apply = _mm_cmpgt_epi32(_mm_set1_epi32(threshold),
                                _mm_abs_epi32(delta));
      }
      const __m128i vtc = _mm_set1_epi32(tc);
      delta = _mm_max_epi32(delta, _mm_sub_epi32(_mm_setzero_si128(), vtc));
      delta = _mm_min_epi32(delta, vtc);
      const __m128i vmax = _mm_set1_epi32(sample_max);
      d.s[3] = _mm_blendv_epi8(p0, db_clip_px(_mm_add_epi32(p0, delta),
                                              vmax), apply);
      d.s[4] = _mm_blendv_epi8(q0, db_clip_px(_mm_sub_epi32(q0, delta),
                                              vmax), apply);
      if (!(c.dflags & D_TWO_SAMPLES_WEAK_FILTER)) {
        const __m128i one = _mm_set1_epi32(1);
        const __m128i vhtc = _mm_set1_epi32(half_tc);
        if (filter_p1) {
          __m128i dp1 = _mm_srai_epi32(
              _mm_add_epi32(
                  _mm_sub_epi32(
                      _mm_srai_epi32(
                          _mm_add_epi32(_mm_add_epi32(p2, p0), one), 1),
                      p1),
                  delta), 1);
          dp1 = _mm_max_epi32(dp1, _mm_sub_epi32(_mm_setzero_si128(),
                                                 vhtc));
          dp1 = _mm_min_epi32(dp1, vhtc);
          d.s[2] = _mm_blendv_epi8(
              p1, db_clip_px(_mm_add_epi32(p1, dp1), vmax), apply);
        }
        if (filter_q1) {
          __m128i dq1 = _mm_srai_epi32(
              _mm_sub_epi32(
                  _mm_sub_epi32(
                      _mm_srai_epi32(
                          _mm_add_epi32(_mm_add_epi32(q2, q0), one), 1),
                      q1),
                  delta), 1);
          dq1 = _mm_max_epi32(dq1, _mm_sub_epi32(_mm_setzero_si128(),
                                                 vhtc));
          dq1 = _mm_min_epi32(dq1, vhtc);
          d.s[5] = _mm_blendv_epi8(
              q1, db_clip_px(_mm_add_epi32(q1, dq1), vmax), apply);
        }
      }
      db4_store(c, x, y, dir, g, d);
#else
      for (int i = g; i < g + group; i++) {
        int p1 = DbGet(c, x, y, dir, i, -2), p0 = DbGet(c, x, y, dir, i, -1);
        int q0 = DbGet(c, x, y, dir, i, 0), q1 = DbGet(c, x, y, dir, i, 1);
        int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
        if (abs(delta) >= threshold &&
            !(c.dflags & D_WEAK_SAMPLE_DECISION))
          continue;
        if (delta < -tc) delta = -tc;
        if (delta > tc) delta = tc;
        auto clip_px = [&](int v) {
          if (v < 0) return 0;
          if (v > sample_max) return sample_max;
          return v;
        };
        DbSet(c, x, y, dir, i, -1, clip_px(p0 + delta));
        DbSet(c, x, y, dir, i, 0, clip_px(q0 - delta));
        if (!(c.dflags & D_TWO_SAMPLES_WEAK_FILTER)) {
          if (filter_p1) {
            int p2 = DbGet(c, x, y, dir, i, -3);
            int dp1 = ((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1);
            if (dp1 < -half_tc) dp1 = -half_tc;
            if (dp1 > half_tc) dp1 = half_tc;
            DbSet(c, x, y, dir, i, -2, clip_px(p1 + dp1));
          }
          if (filter_q1) {
            int q2 = DbGet(c, x, y, dir, i, 2);
            int dq1 = ((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1);
            if (dq1 < -half_tc) dq1 = -half_tc;
            if (dq1 > half_tc) dq1 = half_tc;
            DbSet(c, x, y, dir, i, 1, clip_px(q1 + dq1));
          }
        }
      }
#endif
    }
  }
}

template <typename T>
static void DeblockFilterEdgeChroma(DeblockCtx<T> c, T* const planes[2],
                                    int64_t strides[2], int x, int y,
                                    int scale_x, int scale_y, int dir,
                                    int subblock_size, int qp) {
  int bitdepth_shift = c.bitdepth - 8;
  int index_tc = qp + c.tc_offset + 2;
  if (index_tc < 0) index_tc = 0;
  if (index_tc > 53) index_tc = 53;
  int tc = kDeblockTcTable[index_tc] << bitdepth_shift;
  int scaled = dir == 0 ? (subblock_size >> scale_y)
                        : (subblock_size >> scale_x);
  int sample_max = (1 << c.bitdepth) - 1;
  for (int comp = 0; comp < 2; comp++) {
    c.plane = planes[comp];
    c.stride = strides[comp];
    for (int i = 0; i < scaled; i++) {
      int p1 = DbGet(c, x, y, dir, i, -2), p0 = DbGet(c, x, y, dir, i, -1);
      int q0 = DbGet(c, x, y, dir, i, 0), q1 = DbGet(c, x, y, dir, i, 1);
      int delta = (((q0 - p0) * 4) + p1 - q1 + 4) >> 3;
      if (delta < -tc) delta = -tc;
      if (delta > tc) delta = tc;
      int np0 = p0 + delta;
      int nq0 = q0 - delta;
      if (np0 < 0) np0 = 0;
      if (np0 > sample_max) np0 = sample_max;
      if (nq0 < 0) nq0 = 0;
      if (nq0 > sample_max) nq0 = sample_max;
      DbSet(c, x, y, dir, i, -1, np0);
      DbSet(c, x, y, dir, i, 0, nq0);
    }
  }
}

// One direction pass over one CU tree.
template <typename T>
static void DeblockPassT(
    T* y_plane, int64_t y_stride,
    T* u_plane, int64_t u_stride,
    T* v_plane, int64_t v_stride,
    int pic_width, int pic_height, int bitdepth, int csx, int csy,
    int ctu_size, int num_ctu_x, int num_ctu_y, int subblock_size,
    int deblock_luma, int deblock_chroma, int pred_type_bi,
    int beta_offset, int tc_offset, uint64_t dflags, int direction,
    const int32_t* cu_map, int map_stride, const int32_t* cu_attr) {
  DeblockCtx<T> luma_ctx;
  luma_ctx.plane = y_plane;
  luma_ctx.stride = y_stride;
  luma_ctx.bitdepth = bitdepth;
  luma_ctx.beta_offset = beta_offset;
  luma_ctx.tc_offset = tc_offset;
  luma_ctx.dflags = dflags;
  T* cplanes[2] = {u_plane, v_plane};
  int64_t cstrides[2] = {u_stride, v_stride};

  for (int ctu_idx = 0; ctu_idx < num_ctu_x * num_ctu_y; ctu_idx++) {
    int ctu_x = (ctu_idx % num_ctu_x) * ctu_size;
    int ctu_y = (ctu_idx / num_ctu_x) * ctu_size;
    for (int dy = 0; dy < ctu_size; dy += subblock_size) {
      for (int dx = 0; dx < ctu_size; dx += subblock_size) {
        int x = ctu_x + dx, y = ctu_y + dy;
        if (x >= pic_width || y >= pic_height) continue;
        int qi = cu_map[(y >> 2) * map_stride + (x >> 2)];
        if (qi < 0) continue;
        int pi = -1;
        if (direction == 0) {
          if (x > 0) pi = cu_map[(y >> 2) * map_stride + ((x - 1) >> 2)];
        } else {
          if (y > 0) pi = cu_map[((y - 1) >> 2) * map_stride + (x >> 2)];
        }
        if (pi < 0 || pi == qi) continue;  // CU-interior: never an edge
        const int32_t* q = cu_attr + (int64_t)qi * A_NUM;
        const int32_t* p = cu_attr + (int64_t)pi * A_NUM;
        if (p[A_POS_X] == q[A_POS_X] && p[A_POS_Y] == q[A_POS_Y]) continue;
        int bs = DeblockBoundaryStrength(p, q, x, y, direction, pred_type_bi,
                                         dflags);
        if (!bs) continue;
        int qp = (p[A_QP0] + q[A_QP0] + 1) >> 1;
        if (dflags & D_DEPENDING_ON_QP) qp = 32;
        if (deblock_luma)
          DeblockFilterEdgeLuma(luma_ctx, x, y, direction, subblock_size, bs,
                                qp);
        if (deblock_chroma && bs == 2) {
          int chroma_qp = (p[A_QP1] + q[A_QP1] + 1) >> 1;
          if (dflags & D_DEPENDING_ON_QP) chroma_qp = 31;
          int cx = x >> csx, cy = y >> csy;
          if ((direction == 0 && (cx & 7) == 0) ||
              (direction == 1 && (cy & 7) == 0)) {
            DeblockFilterEdgeChroma(luma_ctx, cplanes, cstrides, cx, cy, csx,
                                    csy, direction, subblock_size, chroma_qp);
          }
        }
      }
    }
  }
}

XVCN_API void xvcn_deblock_pass(
    int32_t* y_plane, int64_t y_stride, int32_t* u_plane, int64_t u_stride,
    int32_t* v_plane, int64_t v_stride, int pic_width, int pic_height,
    int bitdepth, int csx, int csy, int ctu_size, int num_ctu_x,
    int num_ctu_y, int subblock_size, int deblock_luma, int deblock_chroma,
    int pred_type_bi, int beta_offset, int tc_offset, uint64_t dflags,
    int direction, const int32_t* cu_map, int map_stride,
    const int32_t* cu_attr) {
  DeblockPassT<int32_t>(y_plane, y_stride, u_plane, u_stride, v_plane,
                        v_stride, pic_width, pic_height, bitdepth, csx, csy,
                        ctu_size, num_ctu_x, num_ctu_y, subblock_size,
                        deblock_luma, deblock_chroma, pred_type_bi,
                        beta_offset, tc_offset, dflags, direction, cu_map,
                        map_stride, cu_attr);
}

// ---- distortion metrics (ops/metrics.py, ref: sample_metric.cc) ----

#include <cmath>

enum MetricTypeId {
  M_SSD = 0, M_SATD = 1, M_SAD = 2, M_SAD_FAST = 3, M_SAD_AC_ONLY = 4,
  M_SAD_AC_ONLY_FAST = 5, M_SATD_AC_ONLY = 6, M_STRUCTURAL_SSD = 7,
};

static inline int ilog2(int v) { return 31 - __builtin_clz(v); }

// |H_h * D * H_w| sum for a (bh x bw) block of the diff, computed as a
// radix-2 Walsh-Hadamard butterfly (n^2 log n adds instead of the n^3
// multiplies of the dense +-1 GEMM).  The butterfly emits the Sylvester
// transform in a permuted output order, which the abs-sum is invariant
// to, so the value is bit-identical to the dense matrix product.
static int64_t SatdBlockSum(int32_t* d, int bw, int bh) {
  // vertical butterflies between whole rows (vectorizes across columns)
  for (int len = 1; len < bh; len <<= 1)
    for (int i = 0; i < bh; i += len << 1)
      for (int r = i; r < i + len; r++) {
        int32_t* a = d + r * bw;
        int32_t* b = d + (r + len) * bw;
        for (int j = 0; j < bw; j++) {
          int32_t x = a[j], y = b[j];
          a[j] = x + y;
          b[j] = x - y;
        }
      }
  int64_t total = 0;
  for (int r = 0; r < bh; r++) {
    int32_t* v = d + r * bw;
    for (int len = 1; len < bw; len <<= 1)
      for (int i = 0; i < bw; i += len << 1)
        for (int j = i; j < i + len; j++) {
          int32_t x = v[j], y = v[j + len];
          v[j] = x + y;
          v[j + len] = x - y;
        }
    for (int j = 0; j < bw; j++) total += v[j] < 0 ? -v[j] : v[j];
  }
  return total;
}

static inline int64_t SatdScale(int64_t s, int bw, int bh) {
  if (bw == 4 && bh == 4) return (s + 1) >> 1;
  if (bw == bh) return (s + 2) >> 2;
  return (int64_t)(2.0 * (double)s / sqrt((double)(bw * bh)));
}

static int64_t SatdBlock(int32_t* d, int bw, int bh) {
  return SatdScale(SatdBlockSum(d, bw, bh), bw, bh);
}

#if defined(__AVX2__)
// In-register horizontal WHT over 8 int32 lanes (Sylvester order up to
// an output permutation, which the abs-sum ignores).
static inline __m256i wht8_h(__m256i v) {
  __m256i sw = _mm256_shuffle_epi32(v, 0xB1);  // adjacent pairs swapped
  __m256i r = _mm256_blend_epi32(_mm256_add_epi32(v, sw),
                                 _mm256_sub_epi32(sw, v), 0xAA);
  sw = _mm256_shuffle_epi32(r, 0x4E);          // 2-groups swapped
  r = _mm256_blend_epi32(_mm256_add_epi32(r, sw),
                         _mm256_sub_epi32(sw, r), 0xCC);
  sw = _mm256_permute2x128_si256(r, r, 0x01);  // 4-halves swapped
  return _mm256_blend_epi32(_mm256_add_epi32(r, sw),
                            _mm256_sub_epi32(sw, r), 0xF0);
}

static inline __m128i wht4_h(__m128i v) {
  __m128i sw = _mm_shuffle_epi32(v, 0xB1);
  __m128i r = _mm_blend_epi32(_mm_add_epi32(v, sw),
                              _mm_sub_epi32(sw, v), 0xA);
  sw = _mm_shuffle_epi32(r, 0x4E);
  return _mm_blend_epi32(_mm_add_epi32(r, sw),
                         _mm_sub_epi32(sw, r), 0xC);
}

static inline int64_t hsum256(__m256i v) {
  __m128i lo = _mm256_castsi256_si128(v);
  __m128i hi = _mm256_extracti128_si256(v, 1);
  __m128i t = _mm_add_epi32(lo, hi);
  t = _mm_add_epi32(t, _mm_shuffle_epi32(t, 0x4E));
  t = _mm_add_epi32(t, _mm_shuffle_epi32(t, 0xB1));
  return (int64_t)_mm_cvtsi128_si32(t);
}

// one bw x bh SATD block sum, bw in {4, 8, 16}, bh <= 16
static inline __m256i satd_load8(const int32_t* p) {
  return _mm256_loadu_si256((const __m256i*)p);
}
static inline __m256i satd_load8(const int16_t* p) {
  return _mm256_cvtepi16_epi32(_mm_loadu_si128((const __m128i*)p));
}

template <typename T1, typename T2>
static int64_t SatdBlockSumAvx(const T1* s1, int64_t st1,
                               const T2* s2, int64_t st2,
                               int bw, int bh, int32_t dcs) {
  const __m256i vdc = _mm256_set1_epi32(dcs);
  if (bw == 8) {
    __m256i v[16];
    for (int i = 0; i < bh; i++)
      v[i] = _mm256_sub_epi32(
          _mm256_sub_epi32(
              satd_load8(s1 + i * st1),
              satd_load8(s2 + i * st2)),
          vdc);
    for (int len = 1; len < bh; len <<= 1)
      for (int i = 0; i < bh; i += len << 1)
        for (int r = i; r < i + len; r++) {
          __m256i a = v[r], b = v[r + len];
          v[r] = _mm256_add_epi32(a, b);
          v[r + len] = _mm256_sub_epi32(a, b);
        }
    __m256i acc = _mm256_setzero_si256();
    for (int i = 0; i < bh; i++)
      acc = _mm256_add_epi32(acc, _mm256_abs_epi32(wht8_h(v[i])));
    return hsum256(acc);
  }
  if (bw == 16) {
    __m256i v0[8], v1[8];
    for (int i = 0; i < bh; i++) {
      v0[i] = _mm256_sub_epi32(
          _mm256_sub_epi32(
              satd_load8(s1 + i * st1),
              satd_load8(s2 + i * st2)),
          vdc);
      v1[i] = _mm256_sub_epi32(
          _mm256_sub_epi32(
              satd_load8(s1 + i * st1 + 8),
              satd_load8(s2 + i * st2 + 8)),
          vdc);
    }
    for (int len = 1; len < bh; len <<= 1)
      for (int i = 0; i < bh; i += len << 1)
        for (int r = i; r < i + len; r++) {
          __m256i a = v0[r], b = v0[r + len];
          v0[r] = _mm256_add_epi32(a, b);
          v0[r + len] = _mm256_sub_epi32(a, b);
          a = v1[r]; b = v1[r + len];
          v1[r] = _mm256_add_epi32(a, b);
          v1[r + len] = _mm256_sub_epi32(a, b);
        }
    __m256i acc = _mm256_setzero_si256();
    for (int i = 0; i < bh; i++) {
      __m256i a = _mm256_add_epi32(v0[i], v1[i]);  // len=8 stage
      __m256i b = _mm256_sub_epi32(v0[i], v1[i]);
      acc = _mm256_add_epi32(acc, _mm256_abs_epi32(wht8_h(a)));
      acc = _mm256_add_epi32(acc, _mm256_abs_epi32(wht8_h(b)));
    }
    return hsum256(acc);
  }
  // bw == 4
  __m128i v[16];
  const __m128i vdc4 = _mm256_castsi256_si128(vdc);
  for (int i = 0; i < bh; i++)
    v[i] = _mm_sub_epi32(
        _mm_sub_epi32(_mm_loadu_si128((const __m128i*)(s1 + i * st1)),
                      _mm_loadu_si128((const __m128i*)(s2 + i * st2))),
        vdc4);
  for (int len = 1; len < bh; len <<= 1)
    for (int i = 0; i < bh; i += len << 1)
      for (int r = i; r < i + len; r++) {
        __m128i a = v[r], b = v[r + len];
        v[r] = _mm_add_epi32(a, b);
        v[r + len] = _mm_sub_epi32(a, b);
      }
  __m128i acc4 = _mm_setzero_si128();
  for (int i = 0; i < bh; i++)
    acc4 = _mm_add_epi32(acc4, _mm_abs_epi32(wht4_h(v[i])));
  __m128i t = _mm_add_epi32(acc4, _mm_shuffle_epi32(acc4, 0x4E));
  t = _mm_add_epi32(t, _mm_shuffle_epi32(t, 0xB1));
  return (int64_t)_mm_cvtsi128_si32(t);
}
#endif  // __AVX2__

template <typename T1, typename T2>
static int64_t ComputeSatd(const T1* s1, int64_t st1, const T2* s2,
                           int64_t st2, int w, int h, int bitdepth,
                           int64_t dc_sub) {
  int bw, bh;
  if (w == 2 || h == 2) { bw = bh = 2; }
  else if (w == 4 && h == 4) { bw = bh = 4; }
  else if (h == 4 && w > h) { bw = 8; bh = 4; }
  else if (w == 4 && h > w) { bw = 4; bh = 8; }
  else if (w > h) { bw = 16; bh = 8; }
  else if (w < h) { bw = 8; bh = 16; }
  else { bw = bh = 8; }
  int64_t total = 0;
  // diffs fit int32 with headroom: |diff| <= 2^15 + |dc_sub|, and the
  // 16x16 Hadamard gain of 256 keeps every intermediate under 2^25
  int32_t dcs = (int32_t)dc_sub;
#if defined(__AVX2__)
  if (bw >= 4) {
    for (int y = 0; y < h; y += bh)
      for (int x = 0; x < w; x += bw)
        total += SatdScale(
            SatdBlockSumAvx(s1 + (int64_t)y * st1 + x, st1,
                            s2 + (int64_t)y * st2 + x, st2, bw, bh, dcs),
            bw, bh);
    return total >> (bitdepth - 8);
  }
#endif
  int32_t d[256];
  for (int y = 0; y < h; y += bh)
    for (int x = 0; x < w; x += bw) {
      for (int i = 0; i < bh; i++)
        for (int j = 0; j < bw; j++)
          d[i * bw + j] = s1[(y + i) * st1 + x + j] -
                          s2[(y + i) * st2 + x + j] - dcs;
      if (bw == 2)
        total += SatdBlockSum(d, 2, 2);
      else
        total += SatdBlock(d, bw, bh);
    }
  return total >> (bitdepth - 8);
}

static int64_t TruncDiv(int64_t a, int64_t b) {
  int64_t q = (a < 0 ? -a : a) / b;
  return a >= 0 ? q : -q;
}

template <typename T1, typename T2>
static int64_t StructuralBlock(int z, double strength, int size,
                               const T1* s1, int64_t st1,
                               const T2* s2, int64_t st2, int bitdepth) {
  int64_t n = (int64_t)size * size;
  int shift = 2 * (bitdepth - 8);
  int64_t c1 = ((n * n * 26634) >> 12) << shift;
  int64_t c2 = ((n * n * 239708) >> 12) << shift;
  int64_t c4 = 255 * 255;
  double wf = (4.0 * z - 0.054 * z * z - 70.0) * strength;
  int64_t w = (int64_t)wf;
  if (w < 0) w = 0;
  w >>= 4;
  int64_t w1 = 64 - (w >> 1);
  int64_t w2 = 2 * w;
  int64_t orig_sum = 0, reco_sum = 0, orig_orig = 0, reco_reco = 0,
          orig_reco = 0, ssd = 0;
  for (int i = 0; i < size; i++)
    for (int j = 0; j < size; j++) {
      int64_t a1 = s1[i * st1 + j], a2 = s2[i * st2 + j];
      orig_sum += a1;
      reco_sum += a2;
      orig_orig += a1 * a1;
      reco_reco += a2 * a2;
      orig_reco += a1 * a2;
      int64_t dd = a1 - a2;
      ssd += dd * dd;
    }
  double m = (double)(orig_sum - reco_sum) / (double)n;
  double a = ((double)c4 - m * m + (double)c1) / (double)(c4 + c1);
  double b = (2.0 * (double)n * (double)orig_reco -
              2.0 * (double)(orig_sum * reco_sum) + (double)c2) /
             (double)(n * orig_orig - orig_sum * orig_sum +
                      n * reco_reco - reco_sum * reco_sum + c2);
  ssd >>= shift;
  int64_t x = c4 >> ((8 - size) >> 1);
  double t = (double)(w1 * ssd) + (double)(w2 * x) * (1.0 - a * b);
  return ((int64_t)t) >> 6;
}

template <typename T1, typename T2>
static int64_t MetricT(
    int metric_type, const T1* s1, int64_t st1, const T2* s2,
    int64_t st2, int w, int h, int bitdepth, int qp_raw_luma,
    double structural_strength) {
  int64_t dist = 0;
  switch (metric_type) {
    case M_SSD: {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int64_t d = (int64_t)s1[i * st1 + j] - s2[i * st2 + j];
          dist += d * d;
        }
      return dist >> (2 * (bitdepth - 8));
    }
    case M_SAD: {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int64_t d = (int64_t)s1[i * st1 + j] - s2[i * st2 + j];
          dist += d < 0 ? -d : d;
        }
      return dist >> (bitdepth - 8);
    }
    case M_SAD_FAST: {
      for (int i = 0; i < h; i += 2)
        for (int j = 0; j < w; j++) {
          int64_t d = (int64_t)s1[i * st1 + j] - s2[i * st2 + j];
          dist += d < 0 ? -d : d;
        }
      return (dist * 2) >> (bitdepth - 8);
    }
    case M_SAD_AC_ONLY:
    case M_SAD_AC_ONLY_FAST: {
      int step = metric_type == M_SAD_AC_ONLY_FAST ? 2 : 1;
      int64_t delta_sum = 0;
      for (int i = 0; i < h; i += step)
        for (int j = 0; j < w; j++)
          delta_sum += (int64_t)s1[i * st1 + j] - s2[i * st2 + j];
      delta_sum *= step;
      int64_t avg = TruncDiv(delta_sum, (int64_t)w * h);
      for (int i = 0; i < h; i += step)
        for (int j = 0; j < w; j++) {
          int64_t d = (int64_t)s1[i * st1 + j] - s2[i * st2 + j] - avg;
          dist += d < 0 ? -d : d;
        }
      return (dist * step) >> (bitdepth - 8);
    }
    case M_SATD:
      return ComputeSatd(s1, st1, s2, st2, w, h, bitdepth, 0);
    case M_SATD_AC_ONLY: {
      int64_t sum = 0;
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
          sum += (int64_t)s1[i * st1 + j] - s2[i * st2 + j];
      int64_t avg = TruncDiv(sum, (int64_t)w * h);
      return ComputeSatd(s1, st1, s2, st2, w, h, bitdepth, avg);
    }
    case M_STRUCTURAL_SSD: {
      int size = (h < 8 || w < 8) ? 4 : 8;
      for (int by = 0; by + size <= h; by += size)
        for (int bx = 0; bx + size <= w; bx += size)
          dist += StructuralBlock(qp_raw_luma, structural_strength, size,
                                  s1 + by * st1 + bx, st1,
                                  s2 + by * st2 + bx, st2, bitdepth);
      return dist;
    }
    default:
      return -1;
  }
}

XVCN_API int64_t xvcn_metric(
    int metric_type, const int32_t* s1, int64_t st1, const int32_t* s2,
    int64_t st2, int w, int h, int bitdepth, int qp_raw_luma,
    double structural_strength) {
  return MetricT<int32_t, int32_t>(metric_type, s1, st1, s2, st2, w, h,
                                   bitdepth, qp_raw_luma,
                                   structural_strength);
}

// ---- intra prediction (ops/intra_pred.py, ref: intra_prediction.cc) ----

static const int kAngleTable[17] = {-32, -26, -21, -17, -13, -9, -5, -2, 0,
                                    2, 5, 9, 13, 17, 21, 26, 32};
static const int kAngleTableExt[33] = {
    -32, -29, -26, -23, -21, -19, -17, -15, -13, -11, -9, -7,
    -5, -3, -2, -1, 0, 1, 2, 3, 5, 7, 9, 11, 13, 15, 17, 19,
    21, 23, 26, 29, 32};
static const int kInvAngleTable[8] = {4096, 1638, 910, 630, 482, 390, 315,
                                      256};
static const int kInvAngleTableExt[16] = {8192, 4096, 2731, 1638, 1170, 910,
                                          745, 630, 546, 482, 431, 390, 356,
                                          315, 282, 256};

// [1 2 1] reference filter (ref: intra_prediction.cc:850-871)
XVCN_API void xvcn_intra_filter_ref(const int32_t* top, const int32_t* left,
                                    int width, int height, int32_t* ftop,
                                    int32_t* fleft) {
  int n = width + height;
  ftop[0] = ((top[0] << 1) + top[1] + left[0] + 2) >> 2;
  for (int x = 1; x < n; x++)
    ftop[x] = ((top[x] << 1) + top[x - 1] + top[x + 1] + 2) >> 2;
  ftop[n] = top[n];
  fleft[0] = ((left[0] << 1) + top[0] + left[1] + 2) >> 2;
  for (int y = 1; y < n - 1; y++)
    fleft[y] = ((left[y] << 1) + left[y - 1] + left[y + 1] + 2) >> 2;
  fleft[n - 1] = left[n - 1];
}

// (ref: intra_prediction.cc:365-399); dc_filter handled by caller flag
XVCN_API void xvcn_intra_pred_dc(const int32_t* top, const int32_t* left,
                                 int width, int height, int dc_filter,
                                 int32_t* out) {
  int64_t sum = 0;
  for (int x = 0; x < width; x++) sum += top[1 + x];
  for (int y = 0; y < height; y++) sum += left[y];
  int total = width + height;
  int dc_val = (int)((sum + (total >> 1)) / total);
  for (int i = 0; i < width * height; i++) out[i] = dc_val;
  if (dc_filter) {
    for (int y = height - 1; y > 0; y--)
      out[y * width] = (left[y] + 3 * out[y * width] + 2) >> 2;
    for (int x = 1; x < width; x++)
      out[x] = (top[1 + x] + 3 * out[x] + 2) >> 2;
    out[0] = (top[1] + left[0] + 2 * out[0] + 2) >> 2;
  }
}

// (ref: intra_prediction.cc:401-423)
XVCN_API void xvcn_intra_pred_planar(const int32_t* top, const int32_t* left,
                                     int width, int height, int32_t* out) {
  int wl2 = ilog2(width), hl2 = ilog2(height);
  int64_t top_right = top[1 + width];
  int64_t bottom_left = left[height];
  int shift = wl2 + hl2 + 1;
  int64_t offset = 1ll << (shift - 1);
  for (int y = 0; y < height; y++)
    for (int x = 0; x < width; x++) {
      int64_t hor = (int64_t)(height - 1 - y) * top[1 + x] +
                    (int64_t)(y + 1) * bottom_left;
      int64_t ver = (int64_t)(width - 1 - x) * left[y] +
                    (int64_t)(x + 1) * top_right;
      out[y * width + x] = (int32_t)(((hor << wl2) + (ver << hl2) + offset)
                                     >> shift);
    }
}

// (ref: intra_prediction.cc:425-558); flags: bit0 = ver/hor post filter
// disabled
XVCN_API void xvcn_intra_pred_angular(const int32_t* top_in,
                                      const int32_t* left_in, int width,
                                      int height, int mode, int ext67,
                                      int post_filter, int disable_vh_post,
                                      int bitdepth, int32_t* out) {
  int diag = ext67 ? 34 : 18;
  int hor_mode = ext67 ? 18 : 10;
  int ver_mode = ext67 ? 50 : 26;
  bool is_horizontal = mode < diag;

  static thread_local int32_t flip_top[2 * 128 + 1];
  static thread_local int32_t flip_left[2 * 128];
  const int32_t *t, *l;
  int w, h, angle_offset;
  if (is_horizontal) {
    int top_size = width + height;
    flip_top[0] = top_in[0];
    for (int i = 0; i < top_size; i++) flip_top[1 + i] = left_in[i];
    for (int i = 0; i < top_size; i++) flip_left[i] = top_in[1 + i];
    t = flip_top;
    l = flip_left;
    w = height;
    h = width;
    angle_offset = hor_mode - mode;
  } else {
    t = top_in;
    l = left_in;
    w = width;
    h = height;
    angle_offset = mode - ver_mode;
  }
  int angle = ext67 ? kAngleTableExt[16 + angle_offset]
                    : kAngleTable[8 + angle_offset];
  int max_val = (1 << bitdepth) - 1;

  static thread_local int32_t tmp_out[128 * 128];
  int32_t* o = is_horizontal ? tmp_out : out;

  if (angle == 0) {
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) o[y * w + x] = t[1 + x];
    if (post_filter && !disable_vh_post) {
      int above_left = t[0];
      int above = t[1];
      for (int y = 0; y < h; y++) {
        int val = above + ((l[y] - above_left) >> 1);
        if (val < 0) val = 0;
        if (val > max_val) val = max_val;
        o[y * w] = val;
      }
    }
  } else {
    static thread_local int32_t ref_buf[4 * 128 + 2];
    const int32_t* ref_line;
    int ref_off;
    if (angle < 0) {
      int num_projected = -((h * angle) >> 5) - 1;
      int base = num_projected + 1;
      for (int i = 0; i <= w; i++) ref_buf[base - 1 + i] = t[i];
      const int* inv_tab = ext67 ? kInvAngleTableExt : kInvAngleTable;
      int inv_angle = inv_tab[-angle_offset - 1];
      int inv_angle_sum = 128;
      for (int i = 0; i < num_projected; i++) {
        inv_angle_sum += inv_angle;
        ref_buf[base - 2 - i] = l[(inv_angle_sum >> 8) - 1];
      }
      ref_line = ref_buf;
      ref_off = base;
    } else {
      ref_line = t;
      ref_off = 1;
    }
    int angle_sum = 0;
    for (int y = 0; y < h; y++) {
      angle_sum += angle;
      int offset = angle_sum >> 5;
      int iw = angle_sum & 31;
      const int32_t* seg = ref_line + ref_off + offset;
      if (iw) {
        // int32 is exact: samples are <= 14-bit, weights <= 32, so the
        // interpolation sum stays under 2^20 -- and vectorizes 8-wide
        int32_t w0 = 32 - iw, w1 = iw;
        for (int x = 0; x < w; x++)
          o[y * w + x] = (w0 * seg[x] + w1 * seg[x + 1] + 16) >> 5;
      } else {
        for (int x = 0; x < w; x++) o[y * w + x] = seg[x];
      }
    }
    if (post_filter && (angle >= -1 && angle <= 1) && ext67 &&
        !disable_vh_post) {
      for (int y = 0; y < h; y++) {
        int val = o[y * w] + ((l[y] - t[0]) >> 2);
        if (val < 0) val = 0;
        if (val > max_val) val = max_val;
        o[y * w] = val;
      }
    }
  }
  if (is_horizontal) {
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) out[x * width + y] = o[y * w + x];
  }
}

// ---- sub-pel motion compensation (codec/inter_mc.py,
//      ref: inter_prediction.cc:1174-1378 + simd kernels) ----

static const int16_t kMcLumaFilter[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};
static const int16_t kMcLumaFilterHp[16][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},      {0, 1, -3, 63, 4, -2, 1, 0},
    {-1, 2, -5, 62, 8, -3, 1, 0},   {-1, 3, -8, 60, 13, -4, 1, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0}, {-1, 4, -11, 52, 26, -8, 3, -1},
    {-1, 3, -9, 47, 31, -10, 4, -1}, {-1, 4, -11, 45, 34, -10, 4, -1},
    {-1, 4, -11, 40, 40, -11, 4, -1}, {-1, 4, -10, 34, 45, -11, 4, -1},
    {-1, 4, -10, 31, 47, -9, 3, -1}, {-1, 3, -8, 26, 52, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}, {0, 1, -4, 13, 60, -8, 3, -1},
    {0, 1, -3, 8, 62, -5, 2, -1},   {0, 1, -2, 4, 63, -3, 1, 0}};
static const int16_t kMcChromaFilter[8][4] = {
    {0, 64, 0, 0},   {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};
static const int16_t kMcChromaFilterHp[32][4] = {
    {0, 64, 0, 0},   {-1, 63, 2, 0},  {-2, 62, 4, 0},  {-2, 60, 7, -1},
    {-2, 58, 10, -2}, {-3, 57, 12, -2}, {-4, 56, 14, -2}, {-4, 55, 15, -2},
    {-4, 54, 16, -2}, {-5, 53, 18, -2}, {-6, 52, 20, -2}, {-6, 49, 24, -3},
    {-6, 46, 28, -4}, {-5, 44, 29, -4}, {-4, 42, 30, -4}, {-4, 39, 33, -4},
    {-4, 36, 36, -4}, {-4, 33, 39, -4}, {-4, 30, 42, -4}, {-4, 29, 44, -5},
    {-4, 28, 46, -6}, {-3, 24, 49, -6}, {-2, 20, 52, -6}, {-2, 18, 53, -5},
    {-2, 16, 54, -4}, {-2, 15, 55, -4}, {-2, 14, 56, -4}, {-2, 12, 57, -3},
    {-2, 10, 58, -2}, {-1, 7, 60, -2}, {0, 4, 62, -2},  {0, 2, 63, -1}};

static const int kMcInternalPrecision = 14;
static const int kMcFilterPrecision = 6;
static const int kMcInternalOffset = 1 << (kMcInternalPrecision - 1);

// flat int32 -> int16 convert (MC shadow planes; samples fit int16)
XVCN_API void xvcn_to_i16(const int32_t* src, int64_t n, int16_t* dst) {
  for (int64_t i = 0; i < n; i++) dst[i] = (int16_t)src[i];
}

#if defined(__AVX2__)
// ---- int16 MC filter kernels ----
// The scalar loops widen int16 samples to int32 before multiplying, so
// the compiler emits 32-bit multiplies; these kernels keep the samples
// as int16 pairs and use the widening multiply-accumulate (pmaddwd),
// doubling the vector throughput — the same structure as the
// reference's SIMD filters (ref: src/xvc_common_lib/simd/
// inter_prediction_simd.cc).  Bit-exact: every sum is the same int32.

// 8 int32 sums for outputs j..j+7 of a TAPS-tap horizontal filter.
template <int TAPS>
static inline __m256i mc_h_sums8(const int16_t* s, const __m128i* fp) {
  __m128i e = _mm_setzero_si128(), o = _mm_setzero_si128();
  for (int p = 0; p < TAPS / 2; p++) {
    e = _mm_add_epi32(e, _mm_madd_epi16(
        _mm_loadu_si128((const __m128i*)(s + 2 * p)), fp[p]));
    o = _mm_add_epi32(o, _mm_madd_epi16(
        _mm_loadu_si128((const __m128i*)(s + 2 * p + 1)), fp[p]));
  }
  return _mm256_set_m128i(_mm_unpackhi_epi32(e, o),
                          _mm_unpacklo_epi32(e, o));
}

// 8 int32 sums for outputs (·, j..j+7) of a TAPS-tap vertical filter.
template <int TAPS>
static inline __m256i mc_v_sums8(const int16_t* s, int64_t stride,
                                 const __m128i* fp) {
  __m128i lo = _mm_setzero_si128(), hi = _mm_setzero_si128();
  for (int p = 0; p < TAPS / 2; p++) {
    __m128i a = _mm_loadu_si128((const __m128i*)(s + (2 * p) * stride));
    __m128i b = _mm_loadu_si128(
        (const __m128i*)(s + (2 * p + 1) * stride));
    lo = _mm_add_epi32(lo, _mm_madd_epi16(_mm_unpacklo_epi16(a, b),
                                          fp[p]));
    hi = _mm_add_epi32(hi, _mm_madd_epi16(_mm_unpackhi_epi16(a, b),
                                          fp[p]));
  }
  return _mm256_set_m128i(hi, lo);
}

static inline __m256i mc_trunc16(__m256i v) {  // (int16_t) cast per lane
  return _mm256_srai_epi32(_mm256_slli_epi32(v, 16), 16);
}

// output-type-dispatched 8-lane store (int16 rec surfaces store packed;
// values at this point always fit int16)
static inline void mc_store8(int32_t* out, __m256i v) {
  _mm256_storeu_si256((__m256i*)out, v);
}
static inline void mc_store8(int16_t* out, __m256i v) {
  __m128i p = _mm_packs_epi32(_mm256_castsi256_si128(v),
                              _mm256_extracti128_si256(v, 1));
  _mm_storeu_si128((__m128i*)out, p);
}

static inline void mc_pack_pairs(const int16_t* f, int pairs,
                                 __m128i* fp) {
  for (int p = 0; p < pairs; p++)
    fp[p] = _mm_set1_epi32((int32_t)(uint16_t)f[2 * p] |
                           ((int32_t)f[2 * p + 1] << 16));
}

// 4-lane tails for w % 8 == 4 blocks (4-wide luma from binary splits,
// 4-wide chroma of 8x8 CUs).  64-bit loads are exact: no reads beyond
// the TAPS-tap support of the 4 outputs.
template <int TAPS>
static inline __m128i mc_h_sums4(const int16_t* s, const __m128i* fp) {
  __m128i e = _mm_setzero_si128(), o = _mm_setzero_si128();
  for (int p = 0; p < TAPS / 2; p++) {
    e = _mm_add_epi32(e, _mm_madd_epi16(
        _mm_loadl_epi64((const __m128i*)(s + 2 * p)), fp[p]));
    o = _mm_add_epi32(o, _mm_madd_epi16(
        _mm_loadl_epi64((const __m128i*)(s + 2 * p + 1)), fp[p]));
  }
  return _mm_unpacklo_epi32(e, o);
}

template <int TAPS>
static inline __m128i mc_v_sums4(const int16_t* s, int64_t stride,
                                 const __m128i* fp) {
  __m128i acc = _mm_setzero_si128();
  for (int p = 0; p < TAPS / 2; p++) {
    __m128i a = _mm_loadl_epi64((const __m128i*)(s + (2 * p) * stride));
    __m128i b = _mm_loadl_epi64(
        (const __m128i*)(s + (2 * p + 1) * stride));
    acc = _mm_add_epi32(acc, _mm_madd_epi16(_mm_unpacklo_epi16(a, b),
                                            fp[p]));
  }
  return acc;
}

static inline __m128i mc_trunc16_4(__m128i v) {  // (int16_t) cast per lane
  return _mm_srai_epi32(_mm_slli_epi32(v, 16), 16);
}

static inline void mc_store4(int32_t* out, __m128i v) {
  _mm_storeu_si128((__m128i*)out, v);
}
static inline void mc_store4(int16_t* out, __m128i v) {
  _mm_storel_epi64((__m128i*)out, _mm_packs_epi32(v, v));
}

// w must be a multiple of 4; shift1 must be >= 0 (bitdepth >= 8).
template <int TAPS, typename D>
static void xvcn_mc_filter_i16(
    int mode, const int16_t* plane, int64_t stride, int x0, int y0,
    int w, int h, int bitdepth, const int16_t* fxs, const int16_t* fys,
    int frac_x, int frac_y, D* out, int64_t ostride) {
  const int max_val = (1 << bitdepth) - 1;
  const int half = TAPS / 2 - 1;
  const int shift1 = kMcFilterPrecision - (kMcInternalPrecision - bitdepth);
  const int32_t offset1 = -(kMcInternalOffset << shift1);
  const __m256i vzero = _mm256_setzero_si256();
  const __m256i vmax = _mm256_set1_epi32(max_val);
  __m128i fx[4], fy[4];
  mc_pack_pairs(fxs, TAPS / 2, fx);
  mc_pack_pairs(fys, TAPS / 2, fy);

  const int w8 = w & ~7;
  const __m128i vzero4 = _mm_setzero_si128();
  const __m128i vmax4 = _mm_set1_epi32(max_val);
  if (frac_y == 0) {
    const int16_t* s = plane + (int64_t)y0 * stride + x0 - half;
    if (mode == 0) {
      const __m256i voff = _mm256_set1_epi32(1 << (kMcFilterPrecision - 1));
      const __m128i voff4 = _mm256_castsi256_si128(voff);
      for (int i = 0; i < h; i++) {
        for (int j = 0; j < w8; j += 8) {
          __m256i v = mc_h_sums8<TAPS>(s + i * stride + j, fx);
          v = _mm256_srai_epi32(_mm256_add_epi32(v, voff),
                                kMcFilterPrecision);
          v = _mm256_min_epi32(_mm256_max_epi32(v, vzero), vmax);
          mc_store8(out + i * ostride + j, v);
        }
        if (w & 4) {
          __m128i v = mc_h_sums4<TAPS>(s + i * stride + w8, fx);
          v = _mm_srai_epi32(_mm_add_epi32(v, voff4), kMcFilterPrecision);
          v = _mm_min_epi32(_mm_max_epi32(v, vzero4), vmax4);
          mc_store4(out + i * ostride + w8, v);
        }
      }
    } else {
      const __m256i voff = _mm256_set1_epi32(offset1);
      const __m128i voff4 = _mm256_castsi256_si128(voff);
      for (int i = 0; i < h; i++) {
        for (int j = 0; j < w8; j += 8) {
          __m256i v = mc_h_sums8<TAPS>(s + i * stride + j, fx);
          v = _mm256_srai_epi32(_mm256_add_epi32(v, voff), shift1);
          mc_store8(out + i * ostride + j, mc_trunc16(v));
        }
        if (w & 4) {
          __m128i v = mc_h_sums4<TAPS>(s + i * stride + w8, fx);
          v = _mm_srai_epi32(_mm_add_epi32(v, voff4), shift1);
          mc_store4(out + i * ostride + w8, mc_trunc16_4(v));
        }
      }
    }
    return;
  }
  if (frac_x == 0) {
    const int16_t* s = plane + (int64_t)(y0 - half) * stride + x0;
    if (mode == 0) {
      const __m256i voff = _mm256_set1_epi32(1 << (kMcFilterPrecision - 1));
      const __m128i voff4 = _mm256_castsi256_si128(voff);
      for (int i = 0; i < h; i++) {
        for (int j = 0; j < w8; j += 8) {
          __m256i v = mc_v_sums8<TAPS>(s + i * stride + j, stride, fy);
          // reference casts to int16 before the final clip
          v = mc_trunc16(_mm256_srai_epi32(_mm256_add_epi32(v, voff),
                                           kMcFilterPrecision));
          v = _mm256_min_epi32(_mm256_max_epi32(v, vzero), vmax);
          mc_store8(out + i * ostride + j, v);
        }
        if (w & 4) {
          __m128i v = mc_v_sums4<TAPS>(s + i * stride + w8, stride, fy);
          v = mc_trunc16_4(_mm_srai_epi32(_mm_add_epi32(v, voff4),
                                          kMcFilterPrecision));
          v = _mm_min_epi32(_mm_max_epi32(v, vzero4), vmax4);
          mc_store4(out + i * ostride + w8, v);
        }
      }
    } else {
      const __m256i voff = _mm256_set1_epi32(offset1);
      const __m128i voff4 = _mm256_castsi256_si128(voff);
      for (int i = 0; i < h; i++) {
        for (int j = 0; j < w8; j += 8) {
          __m256i v = mc_v_sums8<TAPS>(s + i * stride + j, stride, fy);
          v = _mm256_srai_epi32(_mm256_add_epi32(v, voff), shift1);
          mc_store8(out + i * ostride + j, mc_trunc16(v));
        }
        if (w & 4) {
          __m128i v = mc_v_sums4<TAPS>(s + i * stride + w8, stride, fy);
          v = _mm_srai_epi32(_mm_add_epi32(v, voff4), shift1);
          mc_store4(out + i * ostride + w8, mc_trunc16_4(v));
        }
      }
    }
    return;
  }
  // two-stage: horizontal into int16 intermediates, then vertical
  static thread_local int16_t tmp[(64 + 8) * 64];
  const int16_t* s = plane + (int64_t)(y0 - half) * stride + x0 - half;
  int th = h + TAPS - 1;
  {
    const __m256i voff = _mm256_set1_epi32(offset1);
    const __m128i voff4 = _mm256_castsi256_si128(voff);
    for (int i = 0; i < th; i++) {
      for (int j = 0; j < w8; j += 8) {
        __m256i v = mc_h_sums8<TAPS>(s + i * stride + j, fx);
        v = _mm256_srai_epi32(_mm256_add_epi32(v, voff), shift1);
        v = mc_trunc16(v);
        __m128i p16 = _mm_packs_epi32(_mm256_castsi256_si128(v),
                                      _mm256_extracti128_si256(v, 1));
        _mm_storeu_si128((__m128i*)(tmp + i * w + j), p16);
      }
      if (w & 4) {
        __m128i v = mc_h_sums4<TAPS>(s + i * stride + w8, fx);
        v = _mm_srai_epi32(_mm_add_epi32(v, voff4), shift1);
        v = mc_trunc16_4(v);
        _mm_storel_epi64((__m128i*)(tmp + i * w + w8),
                         _mm_packs_epi32(v, v));
      }
    }
  }
  if (mode == 0) {
    int shift2 = kMcFilterPrecision + (kMcInternalPrecision - bitdepth);
    const __m256i voff = _mm256_set1_epi32(
        (kMcInternalOffset << kMcFilterPrecision) + (1 << (shift2 - 1)));
    const __m128i voff4 = _mm256_castsi256_si128(voff);
    for (int i = 0; i < h; i++) {
      for (int j = 0; j < w8; j += 8) {
        __m256i v = mc_v_sums8<TAPS>(tmp + i * w + j, w, fy);
        v = mc_trunc16(_mm256_srai_epi32(_mm256_add_epi32(v, voff),
                                         shift2));
        v = _mm256_min_epi32(_mm256_max_epi32(v, vzero), vmax);
        mc_store8(out + i * ostride + j, v);
      }
      if (w & 4) {
        __m128i v = mc_v_sums4<TAPS>(tmp + i * w + w8, w, fy);
        v = mc_trunc16_4(_mm_srai_epi32(_mm_add_epi32(v, voff4), shift2));
        v = _mm_min_epi32(_mm_max_epi32(v, vzero4), vmax4);
        mc_store4(out + i * ostride + w8, v);
      }
    }
  } else {
    for (int i = 0; i < h; i++) {
      for (int j = 0; j < w8; j += 8) {
        __m256i v = mc_v_sums8<TAPS>(tmp + i * w + j, w, fy);
        v = mc_trunc16(_mm256_srai_epi32(v, kMcFilterPrecision));
        mc_store8(out + i * ostride + j, v);
      }
      if (w & 4) {
        __m128i v = mc_v_sums4<TAPS>(tmp + i * w + w8, w, fy);
        v = mc_trunc16_4(_mm_srai_epi32(v, kMcFilterPrecision));
        mc_store4(out + i * ostride + w8, v);
      }
    }
  }
}
#endif  // __AVX2__

// mode 0: final samples (clipped); mode 1: 14-bit short intermediates
// (values equal the reference's int16 intermediates).
// TAPS is a compile-time constant (8 luma / 4 chroma) so the filter
// inner loops fully unroll and vectorize; S is the source sample type —
// int16 shadow planes halve the load bandwidth AND let the compiler use
// the widening int16 multiply-accumulate (pmaddwd-class) forms, the
// same reason the reference keeps its frame store in int16
// (ref: src/xvc_common_lib/sample_buffer.h + simd/inter_prediction_simd.cc).
template <typename S, int TAPS, typename D>
static void xvcn_mc_filter(
    int mode, const S* plane, int64_t stride, int x0, int y0,
    int w, int h, int bitdepth, const int16_t* fx, const int16_t* fy,
    int frac_x, int frac_y, D* out, int64_t ostride) {
  int max_val = (1 << bitdepth) - 1;
  const int half = TAPS / 2 - 1;
  int shift1 = kMcFilterPrecision - (kMcInternalPrecision - bitdepth);
  int32_t offset1 = shift1 >= 0 ? -(kMcInternalOffset << shift1) : 0;

  if (frac_y == 0) {
    const S* s = plane + (int64_t)y0 * stride + x0 - half;
    if (mode == 0) {
      int shift = kMcFilterPrecision;
      int32_t offset = 1 << (shift - 1);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int32_t sum = 0;
          for (int t2 = 0; t2 < TAPS; t2++)
            sum += fx[t2] * (int32_t)s[i * stride + j + t2];
          int32_t v = (sum + offset) >> shift;
          if (v < 0) v = 0;
          if (v > max_val) v = max_val;
          out[i * ostride + j] = (D)v;
        }
    } else {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int32_t sum = 0;
          for (int t2 = 0; t2 < TAPS; t2++)
            sum += fx[t2] * (int32_t)s[i * stride + j + t2];
          out[i * ostride + j] = (D)(int16_t)((sum + offset1) >> shift1);
        }
    }
    return;
  }
  if (frac_x == 0) {
    const S* s = plane + (int64_t)(y0 - half) * stride + x0;
    if (mode == 0) {
      int shift = kMcFilterPrecision;
      int32_t offset = 1 << (shift - 1);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int32_t sum = 0;
          for (int t2 = 0; t2 < TAPS; t2++)
            sum += fy[t2] * (int32_t)s[(i + t2) * stride + j];
          // reference casts to int16 before the final clip
          int v = (int16_t)((sum + offset) >> shift);
          if (v < 0) v = 0;
          if (v > max_val) v = max_val;
          out[i * ostride + j] = (D)v;
        }
    } else {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int32_t sum = 0;
          for (int t2 = 0; t2 < TAPS; t2++)
            sum += fy[t2] * (int32_t)s[(i + t2) * stride + j];
          out[i * ostride + j] = (D)(int16_t)((sum + offset1) >> shift1);
        }
    }
    return;
  }
  // two-stage: horizontal into int16 intermediates, then vertical
  static thread_local int16_t tmp[(64 + 8) * 64];
  const S* s = plane + (int64_t)(y0 - half) * stride + x0 - half;
  int th = h + TAPS - 1;
  for (int i = 0; i < th; i++)
    for (int j = 0; j < w; j++) {
      int32_t sum = 0;
      for (int t2 = 0; t2 < TAPS; t2++)
        sum += fx[t2] * (int32_t)s[i * stride + j + t2];
      int32_t v;
      if (shift1 >= 0)
        v = (sum + offset1) >> shift1;
      else
        v = (sum - (kMcInternalOffset >> -shift1)) << -shift1;
      tmp[i * w + j] = (int16_t)v;
    }
  if (mode == 0) {
    int shift2 = kMcFilterPrecision + (kMcInternalPrecision - bitdepth);
    int32_t offset2 = (kMcInternalOffset << kMcFilterPrecision) +
                      (1 << (shift2 - 1));
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int32_t sum = 0;
        for (int t2 = 0; t2 < TAPS; t2++)
          sum += fy[t2] * tmp[(i + t2) * w + j];
        int v = (int16_t)((sum + offset2) >> shift2);
        if (v < 0) v = 0;
        if (v > max_val) v = max_val;
        out[i * ostride + j] = (D)v;
      }
  } else {
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int32_t sum = 0;
        for (int t2 = 0; t2 < TAPS; t2++)
          sum += fy[t2] * tmp[(i + t2) * w + j];
        out[i * ostride + j] = (D)(int16_t)(sum >> kMcFilterPrecision);
      }
  }
}

template <typename S, typename D>
static void xvcn_mc_unipred_t(
    int mode, const S* plane, int64_t stride, int x0, int y0,
    int w, int h, int frac_x, int frac_y, int bitdepth, int is_luma,
    int high_prec, D* out, int64_t ostride) {
  if (frac_x == 0 && frac_y == 0) {
    const S* src0 = plane + (int64_t)y0 * stride + x0;
    int max_val = (1 << bitdepth) - 1;
    if (mode == 0) {
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v = src0[i * stride + j];
          if (v < 0) v = 0;
          if (v > max_val) v = max_val;
          out[i * ostride + j] = (D)v;
        }
    } else {
      int shift = kMcInternalPrecision - bitdepth;
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int16_t v = (int16_t)((int32_t)src0[i * stride + j] << shift);
          out[i * ostride + j] = (D)(int16_t)(v - kMcInternalOffset);
        }
    }
    return;
  }
  bool i16_fast = false;
#if defined(__AVX2__)
  i16_fast = sizeof(S) == 2 && (w & 3) == 0 && w >= 4 &&
             kMcFilterPrecision >= kMcInternalPrecision - bitdepth;
#endif
  if (is_luma) {
    const int16_t* fx = high_prec ? kMcLumaFilterHp[frac_x]
                                  : kMcLumaFilter[frac_x];
    const int16_t* fy = high_prec ? kMcLumaFilterHp[frac_y]
                                  : kMcLumaFilter[frac_y];
#if defined(__AVX2__)
    if (i16_fast) {
      xvcn_mc_filter_i16<8, D>(mode, (const int16_t*)(const void*)plane,
                            stride, x0, y0, w, h, bitdepth, fx, fy,
                            frac_x, frac_y, out, ostride);
      return;
    }
#endif
    xvcn_mc_filter<S, 8, D>(mode, plane, stride, x0, y0, w, h, bitdepth, fx,
                         fy, frac_x, frac_y, out, ostride);
  } else {
    const int16_t* fx = high_prec ? kMcChromaFilterHp[frac_x]
                                  : kMcChromaFilter[frac_x];
    const int16_t* fy = high_prec ? kMcChromaFilterHp[frac_y]
                                  : kMcChromaFilter[frac_y];
#if defined(__AVX2__)
    if (i16_fast) {
      xvcn_mc_filter_i16<4, D>(mode, (const int16_t*)(const void*)plane,
                            stride, x0, y0, w, h, bitdepth, fx, fy,
                            frac_x, frac_y, out, ostride);
      return;
    }
#endif
    xvcn_mc_filter<S, 4, D>(mode, plane, stride, x0, y0, w, h, bitdepth, fx,
                         fy, frac_x, frac_y, out, ostride);
  }
}

XVCN_API void xvcn_mc_unipred(
    int mode, const int32_t* plane, int64_t stride, int x0, int y0,
    int w, int h, int frac_x, int frac_y, int bitdepth, int is_luma,
    int high_prec, int32_t* out, int64_t ostride) {
  xvcn_mc_unipred_t<int32_t, int32_t>(mode, plane, stride, x0, y0, w, h,
                                      frac_x, frac_y, bitdepth, is_luma,
                                      high_prec, out, ostride);
}

// ---------------------------------------------------------------------------
// Separable integer transforms in GEMM form (the matrices are supplied
// by Python from the generated closed-form tables; behavioral twin of
// xvc_tpu/ops/transform.py, ref: src/xvc_common_lib/transform.cc).
// All sums fit 32 bits (|m| <= 2^8, |coeff| <= 2^15, <=32 zero-out
// terms), so the GEMMs accumulate in int32 — exact and vectorizable.
// ---------------------------------------------------------------------------

static inline int32_t xvcn_clip16i(int64_t v) {
  if (v < -32768) return -32768;
  if (v > 32767) return 32767;
  return (int32_t)v;
}

// Trailing-zero extent of a coefficient block: QP>=~30 blocks
// concentrate nonzeros top-left, and every trailing all-zero row/col
// deletes a whole rank-1 update from both GEMM stages.  The block
// behind `c` is fully written (parse memsets, quantizers write every
// position), so one O(area) scan over mostly-zero memory is safe and
// pays for itself many times over.
template <typename C>
static inline void xvcn_nz_extent(const C* c, int rows, int cols,
                                  int stride, int* out_h, int* out_w) {
  int nzh = rows;
  while (nzh > 1) {
    const C* row = c + (int64_t)(nzh - 1) * stride;
    int j = 0;
    while (j < cols && row[j] == 0) j++;
    if (j < cols) break;
    nzh--;
  }
  int nzw = 1;
  for (int r = 0; r < nzh; r++) {
    const C* row = c + (int64_t)r * stride;
    for (int j = cols - 1; j >= nzw; j--)
      if (row[j] != 0) { nzw = j + 1; break; }
  }
  *out_h = nzh;
  *out_w = nzw;
}

// inverse: out = clip16((clip16((M1[:nzh]^T C[:nzh,:C] + a1) >> s1)
//                        [:, :nzw] M2[:nzw] + a2) >> s2)
// Width-templated rank-1-update form: both inner loops run over
// contiguous full-width rows with compile-time trip counts (so they
// vectorize), while the dynamic nzh/nzw extents trim the rank of each
// stage.  C = min(W, 32) bounds the coefficient columns that can be
// nonzero (64-point zero-out); rows >= nzh of `dq` are never read, so
// callers may dequantize only the first nzh rows.
template <int W>
static void xvcn_inv_tx_w(const int32_t* dq, int height, int nzh, int nzw,
                          const int32_t* m1, const int32_t* m2,
                          int shift1, int shift2, int32_t* out) {
  const int C = W < 32 ? W : 32;
  int32_t a1 = 1 << (shift1 - 1);
  int32_t a2 = 1 << (shift2 - 1);
  // int32 accumulation is exact: <= 32 taps of (8-bit basis) x
  // (clip16 operand) stays under 2^28 + rounding
  int32_t temp[64 * 32];
  for (int i = 0; i < height; i++) {
    int32_t acc[C];
    for (int j = 0; j < C; j++) acc[j] = a1;
    for (int r = 0; r < nzh; r++) {
      int32_t m = m1[r * height + i];
      const int32_t* c = dq + (int64_t)r * W;
      for (int j = 0; j < C; j++) acc[j] += m * c[j];
    }
    int32_t* t = temp + i * C;
    for (int j = 0; j < C; j++) t[j] = xvcn_clip16i(acc[j] >> shift1);
  }
  for (int i = 0; i < height; i++) {
    int32_t acc[W];
    for (int j = 0; j < W; j++) acc[j] = a2;
    const int32_t* t = temp + i * C;
    for (int r = 0; r < nzw; r++) {
      int32_t tv = t[r];
      const int32_t* m = m2 + r * W;
      for (int j = 0; j < W; j++) acc[j] += tv * m[j];
    }
    int32_t* o = out + (int64_t)i * W;
    for (int j = 0; j < W; j++) o[j] = xvcn_clip16i(acc[j] >> shift2);
  }
}

// extent-aware entry: nzh/nzw from xvcn_nz_extent on the *levels* (the
// extent is preserved by dequantization: level==0 -> dq==0)
static void xvcn_inv_transform_nz(
    const int32_t* dq, int height, int width,
    const int32_t* m1, const int32_t* m2,
    int shift1, int shift2, int zo_min, int nzh, int nzw, int32_t* out) {
  if (zo_min == 32) {
    switch (width) {
      case 2: return xvcn_inv_tx_w<2>(dq, height, nzh, nzw, m1, m2,
                                      shift1, shift2, out);
      case 4: return xvcn_inv_tx_w<4>(dq, height, nzh, nzw, m1, m2,
                                      shift1, shift2, out);
      case 8: return xvcn_inv_tx_w<8>(dq, height, nzh, nzw, m1, m2,
                                      shift1, shift2, out);
      case 16: return xvcn_inv_tx_w<16>(dq, height, nzh, nzw, m1, m2,
                                        shift1, shift2, out);
      case 32: return xvcn_inv_tx_w<32>(dq, height, nzh, nzw, m1, m2,
                                        shift1, shift2, out);
      case 64: return xvcn_inv_tx_w<64>(dq, height, nzh, nzw, m1, m2,
                                        shift1, shift2, out);
      default: break;
    }
  }
  // generic fallback (non-standard zero-out): rank-trimmed, inner
  // loops contiguous over the temp/matrix rows
  int in1 = height < zo_min ? height : zo_min;
  int cols1 = width < zo_min ? width : zo_min;
  if (nzh < in1) in1 = nzh;
  int in2 = cols1 < nzw ? cols1 : nzw;
  int32_t a1 = 1 << (shift1 - 1);
  int32_t a2 = 1 << (shift2 - 1);
  int32_t temp[64 * 64];
  for (int i = 0; i < height; i++) {
    int32_t acc[64];
    for (int j = 0; j < cols1; j++) acc[j] = a1;
    for (int r = 0; r < in1; r++) {
      int32_t m = m1[r * height + i];
      const int32_t* c = dq + (int64_t)r * width;
      for (int j = 0; j < cols1; j++) acc[j] += m * c[j];
    }
    int32_t* t = temp + i * 64;
    for (int j = 0; j < cols1; j++) t[j] = xvcn_clip16i(acc[j] >> shift1);
  }
  for (int i = 0; i < height; i++) {
    int32_t acc[64];
    for (int j = 0; j < width; j++) acc[j] = a2;
    const int32_t* t = temp + i * 64;
    for (int r = 0; r < in2; r++) {
      int32_t tv = t[r];
      const int32_t* m = m2 + r * width;
      for (int j = 0; j < width; j++) acc[j] += tv * m[j];
    }
    int32_t* o = out + (int64_t)i * width;
    for (int j = 0; j < width; j++) o[j] = xvcn_clip16i(acc[j] >> shift2);
  }
}

XVCN_API void xvcn_inv_transform(
    const int32_t* coeff, int height, int width,
    const int32_t* m1, const int32_t* m2,
    int shift1, int shift2, int zo_min, int32_t* out) {
  int rows_s = height < zo_min ? height : zo_min;
  int cols_s = width < zo_min ? width : zo_min;
  int nzh, nzw;
  xvcn_nz_extent(coeff, rows_s, cols_s, width, &nzh, &nzw);
  xvcn_inv_transform_nz(coeff, height, width, m1, m2, shift1, shift2,
                        zo_min, nzh, nzw, out);
}

// fixed-width forward stages (compile-time bounds vectorize fully,
// the same treatment xvcn_inv_tx_w gives the inverse)
template <int W>
static void xvcn_fwd_tx_w(const int32_t* resi, int height,
                          const int32_t* mh, const int32_t* mv,
                          int shift1, int shift2, int zo_min, int32_t* out) {
  const int O1 = W < 32 ? W : 32;
  int o2 = height < zo_min ? height : zo_min;
  int32_t a1 = 1 << (shift1 - 1);
  int32_t a2 = 1 << (shift2 - 1);
  int32_t mht[W * O1];
  for (int r = 0; r < W; r++)
    for (int j = 0; j < O1; j++) mht[r * O1 + j] = mh[j * W + r];
  int32_t temp[64 * O1];
  for (int i = 0; i < height; i++) {
    int32_t acc[O1];
    for (int j = 0; j < O1; j++) acc[j] = a1;
    const int32_t* rr = resi + i * W;
    for (int r = 0; r < W; r++) {
      int32_t v = rr[r];
      const int32_t* mt = mht + r * O1;
      for (int j = 0; j < O1; j++) acc[j] += v * mt[j];
    }
    int32_t* t = temp + i * O1;
    for (int j = 0; j < O1; j++) t[j] = acc[j] >> shift1;
  }
  for (int i = 0; i < height * W; i++) out[i] = 0;
  for (int i = 0; i < o2; i++) {
    int32_t acc[O1];
    for (int j = 0; j < O1; j++) acc[j] = a2;
    for (int r = 0; r < height; r++) {
      int32_t m = mv[i * height + r];
      const int32_t* t = temp + r * O1;
      for (int j = 0; j < O1; j++) acc[j] += m * t[j];
    }
    for (int j = 0; j < O1; j++)
      out[i * W + j] = acc[j] >> shift2;
  }
}

// forward: temp = (R Mh[:o1]^T + a1) >> s1 ; C[:o2,:o1] = (Mv[:o2] temp
// + a2) >> s2, zero elsewhere
XVCN_API void xvcn_fwd_transform(
    const int32_t* resi, int height, int width,
    const int32_t* mh, const int32_t* mv,
    int shift1, int shift2, int zo_min, int32_t* out) {
  switch (width) {
    case 4: return xvcn_fwd_tx_w<4>(resi, height, mh, mv, shift1, shift2,
                                    zo_min, out);
    case 8: return xvcn_fwd_tx_w<8>(resi, height, mh, mv, shift1, shift2,
                                    zo_min, out);
    case 16: return xvcn_fwd_tx_w<16>(resi, height, mh, mv, shift1, shift2,
                                      zo_min, out);
    case 32: return xvcn_fwd_tx_w<32>(resi, height, mh, mv, shift1, shift2,
                                      zo_min, out);
    case 64: return xvcn_fwd_tx_w<64>(resi, height, mh, mv, shift1, shift2,
                                      zo_min, out);
    default: break;
  }
  int o1 = width < zo_min ? width : zo_min;
  int o2 = height < zo_min ? height : zo_min;
  int32_t a1 = 1 << (shift1 - 1);
  int32_t a2 = 1 << (shift2 - 1);
  // Both stages accumulate exactly in int32.  Stage 1: |resi| <= 2^14
  // (14-bit internal cap), |basis| <= 365 < 2^8.6, <= 64 taps ->
  // |sum| < 2^28.6.  Stage 2: the stage-1 shift is wl2+bitdepth-9 for
  // 6-bit(+2 for 8-bit) matrices, so |temp| < 2^15.6 by construction
  // and |acc| <= 64 * 365 * 2^15.6 < 2^30.1 -- 2x margin.  Both loops
  // are broadcast-accumulate across contiguous j so they vectorize
  // (mh is transposed once per call; matrices are <= 64x32 ints).
  int32_t mht[64 * 32];
  for (int r = 0; r < width; r++)
    for (int j = 0; j < o1; j++) mht[r * o1 + j] = mh[j * width + r];
  int32_t temp[64 * 32];
  for (int i = 0; i < height; i++) {
    int32_t acc[32];
    for (int j = 0; j < o1; j++) acc[j] = a1;
    const int32_t* rr = resi + i * width;
    for (int r = 0; r < width; r++) {
      int32_t v = rr[r];
      const int32_t* mt = mht + r * o1;
      for (int j = 0; j < o1; j++) acc[j] += v * mt[j];
    }
    int32_t* t = temp + i * 32;
    for (int j = 0; j < o1; j++) t[j] = acc[j] >> shift1;
  }
  for (int i = 0; i < height * width; i++) out[i] = 0;
  for (int i = 0; i < o2; i++) {
    int32_t acc[32];
    for (int j = 0; j < o1; j++) acc[j] = a2;
    for (int r = 0; r < height; r++) {
      int32_t m = mv[i * height + r];
      const int32_t* t = temp + r * 32;
      for (int j = 0; j < o1; j++) acc[j] += m * t[j];
    }
    for (int j = 0; j < o1; j++)
      out[i * width + j] = acc[j] >> shift2;
  }
}

// ---------------------------------------------------------------------------
// Fused dequant + inverse transform + reconstruct + distortion: the
// encoder's per-candidate evaluation tail in one call (behavioral twin
// of Quantize::Inverse + InverseTransform::Transform + AddClip + metric,
// ref: src/xvc_enc_lib/transform_encoder.cc:203-285).  tx_kind:
// 0 = generic separable GEMM (matrices supplied), 1 = DC-only fast
// path, 2 = transform skip.  Writes the reconstruction into rec and the
// residual into resi_out (used by the inter resi-domain metric), and
// returns the unweighted distortion from xvcn_metric.
// ---------------------------------------------------------------------------
template <typename R>
static int64_t ReconDistT(
    const int32_t* levels, int height, int width,
    int dq_scale, int dq_shift, int tx_kind,
    const int32_t* m1, const int32_t* m2,
    int shift1, int shift2, int zo_min,
    int skip_shift, int skip_scale, int dc_shift,
    const int32_t* pred, int64_t pred_stride,
    const int32_t* orig, int64_t orig_stride,
    R* rec, int64_t rec_stride,
    int32_t* resi_out, int bitdepth, int metric_kind, int metric_qp,
    double struct_str) {
  int n = height * width;
  int nzh = height, nzw = width;
  if (tx_kind == 0) {
    // only the nonzero level extent feeds the inverse transform, so
    // dequantize just those rows (the quantizer writes every position,
    // making the extent scan safe)
    int rows_s = height < zo_min ? height : zo_min;
    int cols_s = width < zo_min ? width : zo_min;
    xvcn_nz_extent(levels, rows_s, cols_s, width, &nzh, &nzw);
    n = nzh * width;
  } else if (tx_kind == 1) {
    n = 1;  // DC-only path reads dq[0]
  }
  int32_t dq[64 * 64];
  if (dq_shift > 0) {
    int64_t off = (int64_t)1 << (dq_shift - 1);
    for (int i = 0; i < n; i++)
      dq[i] = xvcn_clip16i(((int64_t)levels[i] * dq_scale + off)
                           >> dq_shift);
  } else {
    for (int i = 0; i < n; i++)
      dq[i] = xvcn_clip16i(((int64_t)levels[i] * dq_scale)
                           << (-dq_shift));
  }
  n = height * width;
  if (tx_kind == 0) {
    xvcn_inv_transform_nz(dq, height, width, m1, m2, shift1, shift2,
                          zo_min, nzh, nzw, resi_out);
  } else if (tx_kind == 1) {
    int64_t add = (int64_t)1 << (dc_shift - 1);
    int32_t val = (int32_t)(((((int64_t)dq[0] + 1) >> 1) + add)
                            >> dc_shift);
    for (int i = 0; i < n; i++) resi_out[i] = val;
  } else {
    if (skip_shift > 0) {
      int64_t off = (int64_t)1 << (skip_shift - 1);
      for (int i = 0; i < n; i++)
        resi_out[i] = (int32_t)(((int64_t)dq[i] * skip_scale + off)
                                >> skip_shift);
    } else {
      for (int i = 0; i < n; i++)
        resi_out[i] = (int32_t)(((int64_t)dq[i] * skip_scale)
                                << (-skip_shift));
    }
  }
  int max_val = (1 << bitdepth) - 1;
  for (int i = 0; i < height; i++) {
    for (int j = 0; j < width; j++) {
      int v = pred[i * pred_stride + j] + resi_out[i * width + j];
      if (v < 0) v = 0;
      if (v > max_val) v = max_val;
      rec[i * rec_stride + j] = (R)v;
    }
  }
  return MetricT<int32_t, R>(metric_kind, orig, orig_stride, rec,
                             rec_stride, width, height, bitdepth,
                             metric_qp, struct_str);
}

XVCN_API int64_t xvcn_recon_dist(
    const int32_t* levels, int height, int width,
    int dq_scale, int dq_shift, int tx_kind,
    const int32_t* m1, const int32_t* m2,
    int shift1, int shift2, int zo_min,
    int skip_shift, int skip_scale, int dc_shift,
    const int32_t* pred, int64_t pred_stride,
    const int32_t* orig, int64_t orig_stride,
    int32_t* rec, int64_t rec_stride,
    int32_t* resi_out, int bitdepth, int metric_kind, int metric_qp,
    double struct_str) {
  return ReconDistT<int32_t>(levels, height, width, dq_scale, dq_shift,
                             tx_kind, m1, m2, shift1, shift2, zo_min,
                             skip_shift, skip_scale, dc_shift, pred,
                             pred_stride, orig, orig_stride, rec,
                             rec_stride, resi_out, bitdepth, metric_kind,
                             metric_qp, struct_str);
}

// ---------------------------------------------------------------------------
// All-mode intra SATD pre-pass in one call: predict every candidate
// mode against the supplied reference samples and return its SATD
// (behavioral twin of the per-mode loop in
// src/xvc_enc_lib/intra_search.cc:188-303 feeding
// DetermineSlowIntraModes).  Reference samples are computed by the
// caller (availability/padding already applied); the [1 2 1] filter
// decision per mode follows intra_prediction.cc:342-363.
// ---------------------------------------------------------------------------
XVCN_API void xvcn_intra_prepass_satd(
    const int32_t* top, const int32_t* left, int width, int height,
    int ext67, int disable_ref_filter, int disable_dc_post,
    int disable_vh_post, int disable_planar, int post_filter,
    const int32_t* orig, int64_t orig_stride, int bitdepth,
    int num_modes, int64_t* out_satd) {
  static thread_local int32_t ftop[2 * 128 + 1];
  static thread_local int32_t fleft[2 * 128];
  static thread_local int32_t pred[64 * 64];
  bool have_filtered = false;
  static const int kThr[8] = {0, 20, 10, 7, 1, 0, 10, 0};
  static const int kThrExt[8] = {0, 20, 20, 14, 2, 0, 20, 0};
  int hor_mode = ext67 ? 18 : 10;
  int ver_mode = ext67 ? 50 : 26;
  int size = (ilog2(width) + ilog2(height)) >> 1;
  int thr = ext67 ? kThrExt[size] : kThr[size];

  for (int m = 0; m < num_modes; m++) {
    int mode = m;
    if (disable_planar && mode == 0) mode = 1;
    int d1 = mode - hor_mode;
    if (d1 < 0) d1 = -d1;
    int d2 = mode - ver_mode;
    if (d2 < 0) d2 = -d2;
    int mode_diff = d1 < d2 ? d1 : d2;
    bool use_filt = !disable_ref_filter && mode_diff > thr;
    const int32_t* t = top;
    const int32_t* l = left;
    if (use_filt) {
      if (!have_filtered) {
        xvcn_intra_filter_ref(top, left, width, height, ftop, fleft);
        have_filtered = true;
      }
      t = ftop;
      l = fleft;
    }
    if (mode == 0) {
      xvcn_intra_pred_planar(t, l, width, height, pred);
    } else if (mode == 1) {
      xvcn_intra_pred_dc(top, left, width, height,
                         post_filter && !disable_dc_post, pred);
    } else {
      xvcn_intra_pred_angular(t, l, width, height, mode, ext67,
                              post_filter, disable_vh_post, bitdepth,
                              pred);
    }
    out_satd[m] = xvcn_metric(M_SATD, orig, orig_stride, pred, width,
                              width, height, bitdepth, 0, 0.0);
  }
}

// ---- full-picture decoder (separate unit for readability; same TU so it
// can reuse the static engine internals above) ----
#include "xvcn_pic.inc"
#include "xvcn_enc.inc"
#include "xvcn_enc_inter.inc"
