// Production host entropy coder: CABAC engine + intra slice-data serializer.
//
// C++ twin of homerhevc_tpu/hevc/{cabac,syntax}.py — byte-exact (validated by
// tests/test_native_cabac.py against the Python serializer on identical
// FrameDesc inputs). Python owns tables & context init; this library gets the
// initialized context-state array and the frame description tensors and emits
// the CABAC payload of one slice (or one WPP row substream).
//
// Parity with reference: hmr_binary_encoding.c / hmr_arithmetic_encoding.c
// (HM-derived engine; spec 9.3) — reimplemented from the same spec.
//
// Build: g++ -O3 -shared -fPIC -o libhevcenc.so hevcenc.cpp

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#include <x86intrin.h>

namespace {

// ---- profiling (env HEVCENC_PROF=1; hevcenc_prof_read to fetch) -------------
// slots: 0=slice cycles, 1=setup (nzb4/wire expand) cycles, 2=residual cycles,
// 3=ctx bins, 4=bypass bins, 5=payload bytes, 6=slices, 7=luma residual bins,
// 8=chroma residual bins
static std::atomic<uint64_t> g_prof[10];
static bool prof_on() {
  static int v = -1;
  if (v < 0) v = std::getenv("HEVCENC_PROF") ? 1 : 0;
  return v == 1;
}

#ifdef HEVCENC_FINEPROF
// harness-only (single-thread) sub-scope cycle counters inside residual():
// 0=prologue 1=gather 2=sig-loop 3=greater1/sign 4=remaining 5=CG count
uint64_t g_fine[8];
#define FP_T(v) uint64_t v = __rdtsc()
#define FP_ADD(i, a, b) g_fine[i] += (b) - (a)
#define FP_CNT(i) g_fine[i]++
#else
#define FP_T(v)
#define FP_ADD(i, a, b)
#define FP_CNT(i)
#endif

// ---- spec tables (identical values to hevc/tables.py) ----------------------

static const uint8_t kLps[64][4] = {
  {128,176,208,240},{128,167,197,227},{128,158,187,216},{123,150,178,205},
  {116,142,169,195},{111,135,160,185},{105,128,152,175},{100,122,144,166},
  {95,116,137,158},{90,110,130,150},{85,104,123,142},{81,99,117,135},
  {77,94,111,128},{73,89,105,122},{69,85,100,116},{66,80,95,110},
  {62,76,90,104},{59,72,86,99},{56,69,81,94},{53,65,77,89},
  {51,62,73,85},{48,59,69,80},{46,56,66,76},{43,53,63,72},
  {41,50,59,69},{39,48,56,65},{37,45,54,62},{35,43,51,59},
  {33,41,48,56},{32,39,46,53},{30,37,43,50},{29,35,41,48},
  {27,33,39,45},{26,31,37,43},{24,30,35,41},{23,28,33,39},
  {22,27,32,37},{21,26,30,35},{20,24,29,33},{19,23,27,31},
  {18,22,26,30},{17,21,25,28},{16,20,23,27},{15,19,22,25},
  {14,18,21,24},{14,17,20,23},{13,16,19,22},{12,15,18,21},
  {12,14,17,20},{11,14,16,19},{11,13,15,18},{10,12,15,17},
  {10,12,14,16},{9,11,13,15},{9,11,12,14},{8,10,12,14},
  {8,9,11,13},{7,9,11,12},{7,9,10,12},{7,8,10,11},
  {6,8,9,11},{6,7,9,10},{6,7,8,9},{2,2,2,2},
};
static const uint8_t kRenorm[32] = {
  6,5,4,4,3,3,3,3,2,2,2,2,2,2,2,2,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1};
static const uint8_t kTransLps[64] = {
  0,0,1,2,2,4,4,5,6,7,8,9,9,11,11,12,13,13,15,15,16,16,18,18,19,19,21,21,
  22,22,23,24,24,25,26,26,27,27,28,29,29,30,30,30,31,32,32,33,33,33,34,34,
  35,35,35,36,36,36,37,37,37,38,38,63};
static const int8_t kCtxMap4x4[16] = {0,1,4,5,2,3,4,5,6,6,8,8,7,7,8,8};

// context layout offsets — MUST match hevc/ctx_tables.py OFF
enum CtxOff {
  SPLIT_FLAG = 0, SKIP_FLAG = 3, MERGE_FLAG = 6, MERGE_IDX = 7,
  PART_SIZE = 8, PRED_MODE = 12, INTRA_PRED_MODE = 13, CHROMA_PRED_MODE = 14,
  INTER_DIR = 16, MVD = 21, REF_PIC = 23, DQP = 25, QT_CBF = 28,
  QT_ROOT_CBF = 36, SIG_CG = 37, SIG = 41, LAST_X = 83, LAST_Y = 113,
  ONE = 143, ABS = 167, MVP_IDX = 173, TRANS_SUBDIV = 174,
  TRANSFORM_SKIP = 177, TQ_BYPASS = 179, SAO_MERGE = 180, SAO_TYPE = 181,
  NUM_CTX = 182,
};

// packed-state transition LUTs (state byte = (idx << 1) | mps): one load
// replaces the branch + arithmetic in the hottest loop (bin())
struct NextStateTables {
  uint8_t mps[128], lps[128];
  uint8_t next2[256];   // fused: next2[(s << 1) | is_lps]
  NextStateTables() {
    for (int s = 0; s < 128; s++) {
      int idx = s >> 1, m = s & 1;
      int nm = idx < 62 ? idx + 1 : 62;
      mps[s] = (uint8_t)((nm << 1) | m);
      lps[s] = idx == 0 ? (uint8_t)(m ^ 1)
                        : (uint8_t)((kTransLps[idx] << 1) | m);
      next2[(s << 1) | 0] = mps[s];
      next2[(s << 1) | 1] = lps[s];
    }
  }
};
static const NextStateTables g_next;

struct Cabac {
  std::vector<uint8_t>* out;
  uint8_t* ctx;
  uint32_t low = 0, range = 510;
  int bits_left = 23, num_buffered = 0;
  uint32_t buffered = 0xFF;
  uint64_t nbins = 0, nbyp = 0;   // published to g_prof under HEVCENC_PROF
  // bit-level writer (the payload starts byte-aligned; we only emit whole
  // bytes until finish(), which can leave a partial byte)
  uint32_t acc = 0; int accbits = 0;

  void put_bits(uint32_t v, int n) {
    acc = (acc << n) | v; accbits += n;
    while (accbits >= 8) {
      accbits -= 8;
      out->push_back((acc >> accbits) & 0xFF);
    }
    acc &= (1u << accbits) - 1;
  }
  void write_out() {
    uint32_t lead = low >> (24 - bits_left);
    bits_left += 8;
    low &= 0xFFFFFFFFu >> bits_left;
    if (lead == 0xFF) { num_buffered++; return; }
    if (num_buffered > 0) {
      uint32_t carry = lead >> 8;
      put_bits((buffered + carry) & 0xFF, 8);
      uint32_t fill = (0xFF + carry) & 0xFF;
      for (int i = 0; i < num_buffered - 1; i++) put_bits(fill, 8);
      num_buffered = 1;
      buffered = lead & 0xFF;
    } else {
      num_buffered = 1;
      buffered = lead;
    }
  }
  // Branchless bin: the MPS/LPS split, renorm count and state transition
  // all become cmov/clz/table-load — sig/g1 bins carry ~50% unpredictable
  // outcomes, so removing the branch removes the dominant misprediction
  // cost of the serializer's hottest loop (same arithmetic as spec 9.3 /
  // hmr_binary_encoding.c:173; renorm shift = clz(new_range) - 23 equals
  // the kRenorm table for every reachable LPS value).
  inline void bin(int ctx_idx, uint32_t b) {
    nbins++;
    uint8_t s = ctx[ctx_idx];
    uint32_t lps = kLps[s >> 1][(range >> 6) & 3];
    uint32_t mrange = range - lps;
    uint32_t is_lps = (uint32_t)(b != (s & 1u));
    uint32_t nr = is_lps ? lps : mrange;
    low += mrange & (0u - is_lps);
    int sh = __builtin_clz(nr) - 23;
    low <<= sh;
    range = nr << sh;
    bits_left -= sh;
    ctx[ctx_idx] = g_next.next2[((uint32_t)s << 1) | is_lps];
    if (__builtin_expect(bits_left < 12, 0)) write_out();
  }
  inline void bypass(uint32_t b) {
    nbyp++;
    low = (low << 1) + (range & (0u - (uint32_t)(b != 0)));
    if (--bits_left < 12) write_out();
  }
  inline void bypass_bins(uint32_t v, int n) {
    nbyp += n;
    while (n > 8) {
      n -= 8;
      uint32_t pat = v >> n;
      low = (low << 8) + range * pat;
      v -= pat << n;
      bits_left -= 8;
      if (bits_left < 12) write_out();
    }
    low = (low << n) + range * v;
    bits_left -= n;
    if (bits_left < 12) write_out();
  }
  inline void terminate(uint32_t b) {
    range -= 2;
    if (b) {
      low = (low + range) << 7;
      range = 2 << 7;
      bits_left -= 7;
    } else if (range >= 256) {
      return;
    } else {
      low <<= 1; range <<= 1; bits_left--;
    }
    if (bits_left < 12) write_out();
  }
  void finish() {
    if ((low >> (32 - bits_left)) & ((1u << bits_left) - 1)) {
      put_bits(buffered + 1, 8);
      for (int i = 0; i < num_buffered - 1; i++) put_bits(0x00, 8);
      low -= 1u << (32 - bits_left);
    } else {
      if (num_buffered > 0) put_bits(buffered, 8);
      for (int i = 0; i < num_buffered - 1; i++) put_bits(0xFF, 8);
    }
    put_bits((low >> 8) & ((1u << (24 - bits_left)) - 1), 24 - bits_left);
    // rbsp stop bit + alignment
    put_bits(1, 1);
    if (accbits) put_bits(0, 8 - accbits);
  }
};

// ---- scan tables ------------------------------------------------------------

struct Scans {
  // [log2size 2..5][scan 0..2] -> scan-pos -> raster
  std::vector<int> coeff[6][3];
  std::vector<int> cg[6][3];
  // within-CG inverse map: raster position inside the 4x4 group (y*4+x)
  // -> scan index 0..15 (the within-CG pattern is CG-independent)
  uint8_t cg_inv[3][16];
  Scans() {
    for (int lg = 2; lg <= 5; lg++) {
      int n = 1 << lg;
      for (int s = 0; s < 3; s++) {
        coeff[lg][s] = build_coeff(n, s);
        cg[lg][s] = build_order(n / 4 ? n / 4 : 1, s);
      }
    }
    for (int s = 0; s < 3; s++) {
      auto in = pos_order(4, s);
      for (int k = 0; k < 16; k++)
        cg_inv[s][in[k].second * 4 + in[k].first] = (uint8_t)k;
    }
  }
  static std::vector<std::pair<int,int>> diag(int n) {
    std::vector<std::pair<int,int>> o;
    int x = 0, y = 0;
    while ((int)o.size() < n * n) {
      while (y >= 0) {
        if (x < n && y < n) o.push_back({x, y});
        y--; x++;
      }
      y = x; x = 0;
    }
    return o;
  }
  static std::vector<std::pair<int,int>> pos_order(int n, int s) {
    std::vector<std::pair<int,int>> o;
    if (s == 0) return diag(n);
    if (s == 1) { for (int y=0;y<n;y++) for (int x=0;x<n;x++) o.push_back({x,y}); }
    else        { for (int x=0;x<n;x++) for (int y=0;y<n;y++) o.push_back({x,y}); }
    return o;
  }
  static std::vector<int> build_order(int n, int s) {
    std::vector<int> v;
    for (auto& p : pos_order(n, s)) v.push_back(p.second * n + p.first);
    return v;
  }
  static std::vector<int> build_coeff(int n, int s) {
    std::vector<int> v;
    if (n == 4) return build_order(4, s);
    int ncg = n / 4;
    auto cgo = pos_order(ncg, s);
    auto in = pos_order(4, s);
    for (auto& c : cgo)
      for (auto& i : in)
        v.push_back((c.second * 4 + i.second) * n + c.first * 4 + i.first);
    return v;
  }
};
static Scans g_scans;

// Precomputed significance-context increments: [log2-2][scan][cidx][prev]
// [scan_pos] -> ctx inc (twin of sig_ctx below, which stays as the oracle
// for the table builder). Removes the per-coefficient branch chain from
// the hottest serializer loop.
struct SigCtxLut {
  std::vector<uint8_t> t[4][3][2][4];
  SigCtxLut();
};
static int sig_ctx_ref(int px, int py, int log2, int cidx, int scan_sel,
                       int prev) {
  static const int8_t kMap4[16] = {0,1,4,5,2,3,4,5,6,6,8,8,7,7,8,8};
  if (log2 == 2) return kMap4[4 * py + px];
  if (px == 0 && py == 0) return 0;
  int xi = px & 3, yi = py & 3, cnt;
  if (prev == 0) cnt = (xi + yi == 0) ? 2 : (xi + yi <= 2 ? 1 : 0);
  else if (prev == 1) cnt = yi == 0 ? 2 : (yi == 1 ? 1 : 0);
  else if (prev == 2) cnt = xi == 0 ? 2 : (xi == 1 ? 1 : 0);
  else cnt = 2;
  int off;
  if (log2 == 3) off = (cidx == 0 && scan_sel != 0) ? 15 : 9;
  else off = cidx == 0 ? 21 : 12;
  int extra = (cidx == 0 && ((px >> 2) + (py >> 2)) > 0) ? 3 : 0;
  return off + extra + cnt;
}
SigCtxLut::SigCtxLut() {
  for (int lg = 2; lg <= 5; lg++) {
    int n = 1 << lg;
    for (int s = 0; s < 3; s++) {
      const std::vector<int>& scan = g_scans.coeff[lg][s];
      for (int cidx = 0; cidx < 2; cidx++)
        for (int prev = 0; prev < 4; prev++) {
          auto& v = t[lg - 2][s][cidx][prev];
          v.resize(n * n);
          for (int pos = 0; pos < n * n; pos++) {
            int r = scan[pos];
            v[pos] = (uint8_t)sig_ctx_ref(r & (n - 1), r >> lg, lg, cidx,
                                          s, prev);
          }
        }
    }
  }
}
static SigCtxLut g_sigctx;

// ---- frame description + params ---------------------------------------------

struct Params {
  int width, height;
  int log2_ctu, log2_min_cb, log2_min_tb, log2_max_tb;
  int max_tr_depth_intra;
  int max_tr_depth_inter;
  int sign_hiding;      // SBH_THRESHOLD gate uses quant-adjusted levels
  int cu_qp_delta;      // PPS cu_qp_delta_enabled (QG = CTB)
  int slice_qp;
  int slice_type;       // 2 = I, 1 = P, 0 = B
  int wpp;              // entropy_coding_sync substreams
  int dist0, dist1;     // POC(cur) - POC(first ref) per list (AMVP scaling)
};

struct Desc {
  const uint8_t *cu_depth, *part_nxn, *luma_mode, *chroma_mode, *tr_depth;
  const int16_t *coef_y, *coef_u, *coef_v;
  // inter maps (P slices; may be null for I)
  const uint8_t *skip, *inter_mode, *merge_idx, *mvp_flag, *root_cbf;
  const int32_t *mv;     // (h8, w8, 2)
  // B slices: list-1 motion (null for P / L0-uni B)
  const int32_t *mv_l1;
  const uint8_t *mvp_flag_l1;
  // per-unit prediction direction bitmask (1=L0, 2=L1, 3=BI); null = all
  // BI when mv_l1 is set, else all L0 (twin of FrameDesc.inter_dir)
  const uint8_t *inter_dir;
  // inter CU partition per unit: 0=2Nx2N, 1=2NxN, 2=Nx2N (P slices;
  // null = all 2Nx2N; twin of FrameDesc.inter_part)
  const uint8_t *inter_part;
  const uint8_t *pred_mode;  // 0 = inter, 1 = intra
  // per-8x8 luma QP targets (cu_qp_delta; null = flat slice QP)
  const int8_t *qp_map;
  // SAO per-CTU params (may be null)
  const uint8_t *sao_merge_left, *sao_merge_up;
  const int32_t *sao_type_l, *sao_type_c, *sao_eo_l, *sao_eo_c;
  const int32_t *sao_band;   // (cy, cx, 3)
  const int32_t *sao_off;    // (cy, cx, 3, 4)
  int ctus_x;
  int w8, w4, w, cw;   // strides
  // per-4x4-block significance maps (1 byte per spatial 4x4 block of each
  // coefficient plane, built once per frame by build_nzb4): every cbf
  // query and coefficient-group skip decision reads these instead of
  // scanning the mostly-zero dense planes
  const uint8_t *nzb4_y, *nzb4_u, *nzb4_v;
  int w4b, cw4b;       // nzb4 strides (w/4, cw/4)
  // wire-direct residual access (null => serialize from the dense
  // planes): the device's CG wire (ops/pack.py pack_sparse_cg) arrives
  // in spatial 4x4-block order, so the serializer reads coefficients
  // straight off it — no dense unpack, no re-scan. mf = per-CG 16-bit
  // significance masks (luma blocks raster, then U, then V); voff =
  // first value index of each CG; vals = decoded levels in wire order.
  const uint16_t *mf;
  const int32_t *voff;
  const int16_t *vals;
  long cg_base_u, cg_base_v;   // CG index bases of the chroma planes
};

// One pass over a dense coefficient plane -> 4x4-block significance map.
// Reads each 4x4 block as four unaligned uint64 row loads (w, h are
// multiples of 4 by CTU padding).
static void build_nzb4(const int16_t* plane, int w, int h, uint8_t* out) {
  int w4 = w >> 2, h4 = h >> 2;
  for (int by = 0; by < h4; by++) {
    const int16_t* r0 = plane + (size_t)(by << 2) * w;
    uint8_t* o = out + (size_t)by * w4;
    for (int bx = 0; bx < w4; bx++) {
      const int16_t* b = r0 + (bx << 2);
      uint64_t acc = 0;
      for (int j = 0; j < 4; j++) {
        uint64_t v;
        memcpy(&v, b + (size_t)j * w, 8);
        acc |= v;
      }
      o[bx] = acc != 0;
    }
  }
}

// Any nonzero 4x4 block inside a 4-aligned square region (block coords).
static inline bool region_nz4(const uint8_t* nzb4, int stride4,
                              int x, int y, int size) {
  int bx = x >> 2, by = y >> 2, n = size >> 2;
  for (int j = 0; j < n; j++) {
    const uint8_t* row = nzb4 + (size_t)(by + j) * stride4 + bx;
    for (int i = 0; i < n; i++)
      if (row[i]) return true;
  }
  return false;
}

// uint16-mask twin of region_nz4 for the wire-direct path.
static inline bool region_nzm(const uint16_t* mf, int stride4,
                              int x, int y, int size) {
  int bx = x >> 2, by = y >> 2, n = size >> 2;
  for (int j = 0; j < n; j++) {
    const uint16_t* row = mf + (size_t)(by + j) * stride4 + bx;
    for (int i = 0; i < n; i++)
      if (row[i]) return true;
  }
  return false;
}

struct Enc {
  Params p;
  Desc d;
  Cabac c;
  // cu_qp_delta chain (QG = CTB): qPY_PREV + per-QG coded flag
  int qp_pred = 0;
  bool qp_coded = false;

  int depth_at(int x, int y) const { return d.cu_depth[(y>>3)*d.w8 + (x>>3)]; }
  int lmode(int x, int y) const { return d.luma_mode[(y>>2)*d.w4 + (x>>2)]; }
  int cmode(int x, int y) const { return d.chroma_mode[(y>>3)*d.w8 + (x>>3)]; }
  int trd(int x, int y) const { return d.tr_depth[(y>>3)*d.w8 + (x>>3)]; }
  bool nxn(int x, int y) const { return d.part_nxn[(y>>3)*d.w8 + (x>>3)] != 0; }

  // cbf queries ride the 4x4-block significance maps (all TU coordinates
  // are 4-aligned: min TB is 4 and chroma of the smallest luma TU folds
  // into one 4x4); wire-direct frames read the wire masks instead
  bool nz_y(int x, int y, int size) const {
    if (d.mf) return region_nzm(d.mf, d.w4b, x, y, size);
    return region_nz4(d.nzb4_y, d.w4b, x, y, size);
  }
  bool nz_u(int x, int y, int size) const {
    if (d.mf) return region_nzm(d.mf + d.cg_base_u, d.cw4b, x, y, size);
    return region_nz4(d.nzb4_u, d.cw4b, x, y, size);
  }
  bool nz_v(int x, int y, int size) const {
    if (d.mf) return region_nzm(d.mf + d.cg_base_v, d.cw4b, x, y, size);
    return region_nz4(d.nzb4_v, d.cw4b, x, y, size);
  }

  static int scan_idx_for(int mode, int log2, bool luma) {
    if (log2 == 2 || (log2 == 3 && luma)) {
      if (mode >= 6 && mode <= 14) return 2;
      if (mode >= 22 && mode <= 30) return 1;
    }
    return 0;
  }

  // ---- residual coding ----------------------------------------------------
  // CG-sparse: the 4x4-block significance map (nzb4) decides which 16-
  // coefficient groups exist at all; only those are gathered from the dense
  // plane. Zero CGs cost one context bin and no memory traffic — at working
  // QPs ~95% of a TU's groups are zero, so this replaces the former
  // O(size^2) scan gather with a handful of 16-element reads.
  uint64_t res_cycles = 0;   // published to g_prof under HEVCENC_PROF
  uint64_t tot_nbins = 0, tot_nbyp = 0;   // WPP per-row Cabac roll-up
  uint64_t res_bins[2] = {0, 0};          // luma/chroma residual bins

  void residual(const int16_t* plane, int stride, const uint8_t* nzb4,
                int stride4, int bx, int by,
                int log2, int cidx, int scan_sel) {
    uint64_t t0 = prof_on() ? __rdtsc() : 0;
    uint64_t b0 = t0 ? c.nbins + c.nbyp : 0;
    FP_T(tp0);
    int size = 1 << log2;
    int szmask = size - 1;
    const std::vector<int>& scan = g_scans.coeff[log2][scan_sel];
    const std::vector<int>& cgo = g_scans.cg[log2][scan_sel];
    int ncg = size / 4 > 0 ? size / 4 : 1;
    int n_cg_tot = ncg * ncg;
    int bx4 = bx >> 2, by4 = by >> 2;
    // wire-direct plane views (mask + value-offset arrays share CG index)
    const uint16_t* mf = nullptr;
    const int32_t* voff = nullptr;
    if (d.mf) {
      long base = cidx == 0 ? 0 : (cidx == 1 ? d.cg_base_u : d.cg_base_v);
      mf = d.mf + base;
      voff = d.voff + base;
    }

    bool cg_nz_r[64];   // indexed by raster CG position within the TU
    if (log2 == 2) {
      cg_nz_r[0] = true;                      // caller guaranteed cbf
    } else if (mf) {
      for (int cy = 0; cy < ncg; cy++) {
        const uint16_t* row = mf + (size_t)(by4 + cy) * stride4 + bx4;
        for (int cx = 0; cx < ncg; cx++) cg_nz_r[cy * ncg + cx] = row[cx] != 0;
      }
    } else {
      for (int cy = 0; cy < ncg; cy++) {
        const uint8_t* row = nzb4 + (size_t)(by4 + cy) * stride4 + bx4;
        for (int cx = 0; cx < ncg; cx++) cg_nz_r[cy * ncg + cx] = row[cx] != 0;
      }
    }
    int last_cg = n_cg_tot - 1;
    while (last_cg > 0 && !cg_nz_r[cgo[last_cg]]) last_cg--;

    // gather one CG's 16 coefficients in scan order: wire-direct frames
    // read the mask + packed values (rank via popcount), dense frames
    // gather from the plane
    int16_t sc16[16];
    const uint8_t* cg_inv = g_scans.cg_inv[scan_sel];
    auto gather = [&](int ci) {
      if (mf) {
        // wire-direct: walk the set bits (ascending raster pos == packed
        // value order) instead of 16 per-position popcount probes
        int r = cgo[ci];
        size_t cg = (size_t)(by4 + r / ncg) * stride4 + bx4 + r % ncg;
        unsigned m = mf[cg];
        const int16_t* vp = d.vals + voff[cg];
        memset(sc16, 0, sizeof sc16);
        while (m) {
          int pos = __builtin_ctz(m);
          m &= m - 1;
          sc16[cg_inv[pos]] = *vp++;
        }
        return;
      }
      const int* sp = &scan[ci * 16];
      for (int k = 0; k < 16; k++) {
        int r = sp[k];
        sc16[k] = plane[(size_t)(by + (r >> log2)) * stride + bx + (r & szmask)];
      }
    };
    gather(last_cg);
    int last_in = 15;
    while (last_in > 0 && !sc16[last_in]) last_in--;
    int last_pos = last_cg * 16 + last_in;
    int last_raster = scan[last_pos];
    int last_x = last_raster & szmask, last_y = last_raster >> log2;
    if (scan_sel == 2) { int t = last_x; last_x = last_y; last_y = t; }
    encode_last(last_x, last_y, log2, cidx);

    int num_cg = last_cg + 1;
    auto right_below = [&](int ci) {
      int r = cgo[ci];
      int cgx = r % ncg, cgy = r / ncg;
      int res = 0;
      if (cgx + 1 < ncg && cg_nz_r[r + 1]) res |= 1;
      if (cgy + 1 < ncg && cg_nz_r[r + ncg]) res |= 2;
      return res;
    };

    FP_T(tp1);
    FP_ADD(0, tp0, tp1);
    int c1 = 1;
    for (int ci = num_cg - 1; ci >= 0; ci--) {
      bool in_last = ci == num_cg - 1;
      int prev_csbf = right_below(ci);
      bool infer_dc = false;
      bool coded_sb = true;
      bool has_nz = cg_nz_r[cgo[ci]];
      if (!in_last && ci != 0) {
        coded_sb = has_nz;
        c.bin(SIG_CG + (cidx ? 2 : 0) + (prev_csbf ? 1 : 0), coded_sb);
        infer_dc = true;
      }
      if (!coded_sb) continue;
      FP_CNT(5);
      FP_T(tg0);
      if (!in_last) {
        if (has_nz) gather(ci);
        else memset(sc16, 0, sizeof sc16);   // DC CG inferred-coded, all zero
      }
      FP_T(tg1);
      FP_ADD(1, tg0, tg1);
      int cg_start = ci * 16;
      int start_n = in_last ? last_in : 15;
      int pos_list[16]; int n_nz = 0;         // local (within-CG) scan offsets
      int num_found = 0;
      const uint8_t* ctx_lut =
          g_sigctx.t[log2 - 2][scan_sel][cidx ? 1 : 0][prev_csbf].data();
      int sig_base = SIG + (cidx ? 27 : 0);
      for (int n = start_n; n >= 0; n--) {
        int sig = sc16[n] != 0;
        if (in_last && n == start_n) { pos_list[n_nz++] = n; num_found++; continue; }
        if (n == 0 && infer_dc && num_found == 0) { pos_list[n_nz++] = n; continue; }
        c.bin(sig_base + ctx_lut[cg_start + n], sig);
        if (sig) { pos_list[n_nz++] = n; num_found++; }
      }
      FP_T(ts1);
      FP_ADD(2, tg1, ts1);
      if (!n_nz) continue;
      int absv[16], sgn[16];
      for (int i = 0; i < n_nz; i++) {
        int v = sc16[pos_list[i]];
        absv[i] = v < 0 ? -v : v;
        sgn[i] = v < 0;
      }
      int first_sc = pos_list[n_nz - 1];
      int last_sc = pos_list[0];
      bool hide = p.sign_hiding && (last_sc - first_sc) >= 4;
      int ctx_set = (ci > 0 && cidx == 0) ? 2 : 0;
      if (c1 == 0) ctx_set++;
      c1 = 1;
      int base_one = ONE + (cidx ? 16 : 0) + 4 * ctx_set;
      int num_g1 = n_nz < 8 ? n_nz : 8;
      int first_g1 = -1;
      for (int i = 0; i < num_g1; i++) {
        int g1 = absv[i] > 1;
        c.bin(base_one + c1, g1);
        if (g1) { c1 = 0; if (first_g1 < 0) first_g1 = i; }
        else if (c1 > 0 && c1 < 3) c1++;
      }
      if (first_g1 >= 0)
        c.bin(ABS + (cidx ? 4 : 0) + ctx_set, absv[first_g1] > 2);
      int n_signs = hide ? n_nz - 1 : n_nz;
      for (int i = 0; i < n_signs; i++) c.bypass(sgn[i]);
      FP_T(tb1);
      FP_ADD(3, ts1, tb1);
      if (c1 == 0 || n_nz > 8) {
        int rice = 0, fc2 = 1;
        for (int i = 0; i < n_nz; i++) {
          int base = i < 8 ? 2 + fc2 : 1;
          if (absv[i] >= base) {
            remaining(absv[i] - base, rice);
            if (absv[i] > (3 << rice)) rice = rice < 4 ? rice + 1 : 4;
          }
          if (absv[i] >= 2) fc2 = 0;
        }
        FP_T(tr1);
        FP_ADD(4, tb1, tr1);
      }
    }
    if (t0) {
      res_cycles += __rdtsc() - t0;
      res_bins[cidx ? 1 : 0] += c.nbins + c.nbyp - b0;
    }
  }

  void remaining(int v, int r) {
    if (v < (3 << r)) {
      int len = v >> r;
      c.bypass_bins((1u << (len + 1)) - 2, len + 1);
      if (r) c.bypass_bins(v & ((1 << r) - 1), r);
    } else {
      int len = r;
      v -= 3 << r;
      while (v >= (1 << len)) { v -= 1 << len; len++; }
      c.bypass_bins((1u << (3 + len + 1 - r)) - 2, 3 + len + 1 - r);
      if (len) c.bypass_bins(v, len);
    }
  }

  static int last_prefix(int v) {
    if (v < 4) return v;
    int bl = 32 - __builtin_clz((unsigned)v);
    return 2 * (bl - 1) + ((v >> (bl - 2)) & 1);
  }

  void encode_last(int lx, int ly, int log2, int cidx) {
    int off, shift;
    if (cidx == 0) { off = 3 * (log2 - 2) + ((log2 - 1) >> 2); shift = (log2 + 1) >> 2; }
    else { off = 15; shift = log2 - 2; }
    int gmax = (log2 << 1) - 1;
    int vals[2] = {lx, ly};
    int bases[2] = {LAST_X, LAST_Y};
    for (int k = 0; k < 2; k++) {
      int pre = last_prefix(vals[k]);
      for (int i = 0; i < pre; i++) c.bin(bases[k] + off + (i >> shift), 1);
      if (pre < gmax) c.bin(bases[k] + off + (pre >> shift), 0);
    }
    for (int k = 0; k < 2; k++) {
      int pre = last_prefix(vals[k]);
      if (pre > 3) {
        int sl = (pre >> 1) - 1;
        c.bypass_bins(vals[k] - ((2 + (pre & 1)) << sl), sl);
      }
    }
  }

  // ---- MPM ------------------------------------------------------------------
  void mpm_list(int left, int above, int out[3]) {
    if (left == above) {
      if (left < 2) { out[0] = 0; out[1] = 1; out[2] = 26; }
      else {
        out[0] = left;
        out[1] = 2 + ((left + 29) % 32);
        out[2] = 2 + ((left - 1) % 32);
      }
    } else {
      out[0] = left; out[1] = above;
      if (left != 0 && above != 0) out[2] = 0;
      else if (left != 1 && above != 1) out[2] = 1;
      else out[2] = 26;
    }
  }

  // ---- transform tree ---------------------------------------------------------
  void transform_tree(int x0, int y0, int xb, int yb, int log2, int depth,
                      int blk, bool intra_split, int max_depth,
                      bool pcb, bool pcr) {
    int size = 1 << log2;
    int target = trd(x0, y0);
    bool split = target > depth;
    if (log2 <= p.log2_max_tb && log2 > p.log2_min_tb &&
        depth < max_depth && !(intra_split && depth == 0)) {
      c.bin(TRANS_SUBDIV + (5 - log2), split);
    } else {
      if (log2 > p.log2_max_tb || (intra_split && depth == 0)) split = true;
      else split = false;
    }
    int cx = x0 >> 1, cy = y0 >> 1, cs = size >> 1;
    bool cbf_cb = pcb, cbf_cr = pcr;
    if (log2 > 2) {
      cbf_cb = nz_u(cx, cy, cs);
      cbf_cr = nz_v(cx, cy, cs);
      if (pcb) c.bin(QT_CBF + 4 + depth, cbf_cb);
      if (pcr) c.bin(QT_CBF + 4 + depth, cbf_cr);
    }
    if (split) {
      int half = size >> 1;
      int order[4][2] = {{0,0},{half,0},{0,half},{half,half}};
      for (int i = 0; i < 4; i++)
        transform_tree(x0 + order[i][0], y0 + order[i][1], x0, y0,
                       log2 - 1, depth + 1, i, intra_split, max_depth,
                       cbf_cb, cbf_cr);
      return;
    }
    bool cbf_luma = nz_y(x0, y0, size);
    if (is_intra(x0, y0) || depth != 0 || cbf_cb || cbf_cr)
      c.bin(QT_CBF + (depth == 0 ? 1 : 0), cbf_luma);
    transform_unit(x0, y0, xb, yb, log2, depth, blk, cbf_luma, cbf_cb, cbf_cr);
  }

  // cu_qp_delta_abs/sign (spec 7.3.8.10, 9.3.3.8): TU to cMax 5 with
  // ctx {DQP+0 bin 0, DQP+1 after}, EG0 bypass suffix, bypass sign.
  // Twin of SliceDataEncoder._encode_cu_qp_delta.
  void code_cu_qp_delta(int x0, int y0) {
    int qp = d.qp_map ? d.qp_map[(y0 >> 3) * d.w8 + (x0 >> 3)] : p.slice_qp;
    int delta = qp - qp_pred;
    int a = delta < 0 ? -delta : delta;
    int tu = a < 5 ? a : 5;
    c.bin(DQP + 0, tu > 0);
    if (tu > 0) {
      for (int i = 1; i < tu; i++) c.bin(DQP + 1, 1);
      if (tu < 5) c.bin(DQP + 1, 0);
      if (a >= 5) {
        int v = a - 5 + 1;
        int nb = 0;
        while ((2 << nb) <= v) nb++;          // nb = floor(log2(v))
        c.bypass_bins(((1u << nb) - 1) << 1, nb + 1);  // nb ones + 0
        c.bypass_bins(v - (1 << nb), nb);
      }
      c.bypass(delta < 0);
    }
    qp_pred = qp;
  }

  void transform_unit(int x0, int y0, int xb, int yb, int log2, int depth,
                      int blk, bool cbf_luma, bool cbf_cb, bool cbf_cr) {
    if (log2 == 2) {
      cbf_cb = cbf_cb && nz_u(xb >> 1, yb >> 1, 4);
      cbf_cr = cbf_cr && nz_v(xb >> 1, yb >> 1, 4);
    }
    if (!(cbf_luma || cbf_cb || cbf_cr)) return;
    if (p.cu_qp_delta && !qp_coded) {
      code_cu_qp_delta(x0, y0);
      qp_coded = true;
    }
    int size = 1 << log2;
    if (cbf_luma) {
      int sel = is_intra(x0, y0)
          ? scan_idx_for(lmode(x0, y0), log2, true) : 0;
      residual(d.coef_y, d.w, d.nzb4_y, d.w4b, x0, y0, log2, 0, sel);
    }
    if (log2 > 2 || blk == 3) {
      int cx, cy, clog2, mx, my;
      if (log2 > 2) { cx = x0 >> 1; cy = y0 >> 1; clog2 = log2 - 1; mx = x0; my = y0; }
      else { cx = xb >> 1; cy = yb >> 1; clog2 = 2; mx = xb; my = yb; }
      int csel = is_intra(mx, my)
          ? scan_idx_for(cmode(mx, my), clog2, false) : 0;
      if (cbf_cb) residual(d.coef_u, d.cw, d.nzb4_u, d.cw4b, cx, cy, clog2, 1, csel);
      if (cbf_cr) residual(d.coef_v, d.cw, d.nzb4_v, d.cw4b, cx, cy, clog2, 2, csel);
    }
  }

  // ---- inter derivations (twin of hevc/inter.py) -------------------------------
  bool is_intra(int x, int y) const {
    return d.pred_mode == nullptr || d.pred_mode[(y>>3)*d.w8 + (x>>3)] != 0;
  }
  static int zaddr(int px, int py, int ctu) {
    int zx = (px % ctu) / 4, zy = (py % ctu) / 4, v = 0;
    for (int b = 0; b < 8; b++) {
      v |= ((zx >> b) & 1) << (2 * b);
      v |= ((zy >> b) & 1) << (2 * b + 1);
    }
    return v;
  }
  bool coded_before(int x, int y, int cx0, int cy0) const {
    if (x < 0 || y < 0) return false;
    int ctu = 1 << p.log2_ctu;
    int cw = (p.width + ctu - 1) / ctu;
    int a = (y / ctu) * cw + x / ctu;
    int b = (cy0 / ctu) * cw + cx0 / ctu;
    if (a != b) return a < b;
    return zaddr(x, y, ctu) < zaddr(cx0, cy0, ctu);
  }
  struct MV { int x, y, ref; };
  bool motion_at_list(const int32_t* mvarr, int x, int y, int cx0, int cy0,
                      MV* out) const {
    if (x < 0 || y < 0 || x >= p.width || y >= p.height) return false;
    if (!coded_before(x, y, cx0, cy0)) return false;
    int u = (y >> 3) * d.w8 + (x >> 3);
    if (d.pred_mode[u] != 0) return false;  // intra
    out->x = mvarr[2 * u];
    out->y = mvarr[2 * u + 1];
    out->ref = 0;
    return true;
  }
  bool motion_at(int x, int y, int cx0, int cy0, MV* out) const {
    return motion_at_list(d.mv, x, y, cx0, cy0, out);
  }
  int merge_list(int x0, int y0, int n, MV out[5]) const {
    MV a1, b1, b0, a0, b2;
    bool ha1 = motion_at(x0 - 1, y0 + n - 1, x0, y0, &a1);
    bool hb1 = motion_at(x0 + n - 1, y0 - 1, x0, y0, &b1);
    bool hb0 = motion_at(x0 + n, y0 - 1, x0, y0, &b0);
    bool ha0 = motion_at(x0 - 1, y0 + n, x0, y0, &a0);
    bool hb2 = motion_at(x0 - 1, y0 - 1, x0, y0, &b2);
    int cnt = 0;
    auto same = [](bool hx, const MV& u, bool hy, const MV& v) {
      return hx && hy && u.x == v.x && u.y == v.y && u.ref == v.ref;
    };
    if (ha1) out[cnt++] = a1;
    if (hb1 && !same(hb1, b1, ha1, a1)) out[cnt++] = b1;
    if (hb0 && !same(hb0, b0, hb1, b1)) out[cnt++] = b0;
    if (ha0 && !same(ha0, a0, ha1, a1)) out[cnt++] = a0;
    if (cnt < 4 && hb2 && !same(hb2, b2, ha1, a1) && !same(hb2, b2, hb1, b1))
      out[cnt++] = b2;
    while (cnt < 5) out[cnt++] = MV{0, 0, 0};
    return 5;
  }
  int dir_at(int x, int y) const {
    // direction bitmask of an inter unit (1=L0, 2=L1, 3=BI)
    if (d.inter_dir) return d.inter_dir[(y >> 3) * d.w8 + (x >> 3)];
    return d.mv_l1 ? 3 : 1;
  }
  // spec 8.5.3.2.6 / 8.5.3.2.8 POC-distance MV scaling (twin of
  // hevc/inter.py scale_mv)
  static int scale_one(int v, int tb, int td) {
    if (td < -128) td = -128; if (td > 127) td = 127;
    if (tb < -128) tb = -128; if (tb > 127) tb = 127;
    int q = 16384 + (std::abs(td) >> 1);
    int tx = q / td;                       // C division: trunc toward zero
    long dsf = ((long)tb * tx + 32) >> 6;
    if (dsf < -4096) dsf = -4096; if (dsf > 4095) dsf = 4095;
    long p = dsf * v;
    long s = (std::labs(p) + 127) >> 8;
    long r = p >= 0 ? s : -s;
    if (r < -32768) r = -32768; if (r > 32767) r = 32767;
    return (int)r;
  }
  struct Lists { bool h0, h1; MV m0, m1; };
  bool lists_at(int x, int y, int cx0, int cy0, Lists* out) const {
    if (x < 0 || y < 0 || x >= p.width || y >= p.height) return false;
    if (!coded_before(x, y, cx0, cy0)) return false;
    int u = (y >> 3) * d.w8 + (x >> 3);
    if (d.pred_mode && d.pred_mode[u] != 0) return false;  // intra
    int dir = d.inter_dir ? d.inter_dir[u] : (d.mv_l1 ? 3 : 1);
    out->h0 = (dir & 1) != 0;
    out->h1 = (dir & 2) != 0 && d.mv_l1 != nullptr;
    if (out->h0) out->m0 = MV{d.mv[2 * u], d.mv[2 * u + 1], 0};
    if (out->h1) out->m1 = MV{d.mv_l1[2 * u], d.mv_l1[2 * u + 1], 0};
    return out->h0 || out->h1;
  }
  // two-list spatial AMVP with scaling (twin of hevc/inter.py
  // amvp_candidates_2; HM fillMvpCand order)
  void amvp_list_2(int x0, int y0, int n, int lx, MV out[2]) const {
    int dists[2] = {p.dist0, p.dist1};
    int ly = 1 - lx;
    Lists A[2], B[3];
    bool hA[2], hB[3];
    hA[0] = lists_at(x0 - 1, y0 + n, x0, y0, &A[0]);
    hA[1] = lists_at(x0 - 1, y0 + n - 1, x0, y0, &A[1]);
    hB[0] = lists_at(x0 + n, y0 - 1, x0, y0, &B[0]);
    hB[1] = lists_at(x0 + n - 1, y0 - 1, x0, y0, &B[1]);
    hB[2] = lists_at(x0 - 1, y0 - 1, x0, y0, &B[2]);
    auto same_poc = [&](const Lists& c, MV* mv) {
      bool hx = lx == 0 ? c.h0 : c.h1;
      const MV& mx = lx == 0 ? c.m0 : c.m1;
      if (hx) { *mv = mx; return true; }
      bool hy = lx == 0 ? c.h1 : c.h0;
      const MV& my = lx == 0 ? c.m1 : c.m0;
      if (hy && dists[ly] == dists[lx]) { *mv = my; return true; }
      return false;
    };
    auto scaled = [&](const Lists& c, MV* mv) {
      bool hx = lx == 0 ? c.h0 : c.h1;
      const MV& mx = lx == 0 ? c.m0 : c.m1;
      if (hx) { *mv = mx; return true; }
      bool hy = lx == 0 ? c.h1 : c.h0;
      const MV& my = lx == 0 ? c.m1 : c.m0;
      if (hy) {
        *mv = MV{scale_one(my.x, dists[lx], dists[ly]),
                 scale_one(my.y, dists[lx], dists[ly]), 0};
        return true;
      }
      return false;
    };
    bool have_a = false, have_b = false;
    MV mva{0, 0, 0}, mvb{0, 0, 0};
    for (int k = 0; k < 2 && !have_a; k++)
      if (hA[k] && same_poc(A[k], &mva)) have_a = true;
    bool avail_a = hA[0] || hA[1];
    if (!have_a && avail_a)
      for (int k = 0; k < 2 && !have_a; k++)
        if (hA[k] && scaled(A[k], &mva)) have_a = true;
    for (int k = 0; k < 3 && !have_b; k++)
      if (hB[k] && same_poc(B[k], &mvb)) have_b = true;
    if (!avail_a) {
      // isScaledFlagLX == 0 (spec 8.5.3.2.7 steps 4-5): the same-POC B
      // takes A's place and B is derived again, scaled
      have_a = have_b;
      mva = mvb;
      have_b = false;
      for (int k = 0; k < 3 && !have_b; k++)
        if (hB[k] && scaled(B[k], &mvb)) have_b = true;
    }
    int cnt = 0;
    if (have_a) out[cnt++] = mva;
    if (have_b && (!have_a || mvb.x != mva.x || mvb.y != mva.y))
      out[cnt++] = mvb;
    while (cnt < 2) out[cnt++] = MV{0, 0, 0};
  }
  void amvp_list_of(const int32_t* mvarr, int x0, int y0, int n,
                    MV out[2]) const {
    MV a0, a1, b0, b1, b2, mva, mvb;
    bool hva = false, hvb = false;
    if (motion_at_list(mvarr, x0 - 1, y0 + n, x0, y0, &a0)) { mva = a0; hva = true; }
    else if (motion_at_list(mvarr, x0 - 1, y0 + n - 1, x0, y0, &a1)) { mva = a1; hva = true; }
    if (motion_at_list(mvarr, x0 + n, y0 - 1, x0, y0, &b0)) { mvb = b0; hvb = true; }
    else if (motion_at_list(mvarr, x0 + n - 1, y0 - 1, x0, y0, &b1)) { mvb = b1; hvb = true; }
    else if (motion_at_list(mvarr, x0 - 1, y0 - 1, x0, y0, &b2)) { mvb = b2; hvb = true; }
    int cnt = 0;
    if (hva) out[cnt++] = mva;
    if (hvb && (!hva || mvb.x != mva.x || mvb.y != mva.y)) out[cnt++] = mvb;
    while (cnt < 2) out[cnt++] = MV{0, 0, 0};
  }
  void amvp_list(int x0, int y0, int n, MV out[2]) const {
    amvp_list_of(d.mv, x0, y0, n, out);
  }

  // ---- rectangular PUs (P slices; twin of hevc/inter.py rect fns) ----------
  // Same-CU availability follows PU decode order (PU0 precedes PU1), not
  // the 4x4 z-curve — any reachable same-CU position lies in PU0.
  bool motion_at_rect(int x, int y, int px0, int py0,
                      int cux, int cuy, int cun, MV* out) const {
    if (x < 0 || y < 0 || x >= p.width || y >= p.height) return false;
    bool same_cu = (x >= cux && x < cux + cun && y >= cuy && y < cuy + cun);
    if (!same_cu && !coded_before(x, y, px0, py0)) return false;
    int u = (y >> 3) * d.w8 + (x >> 3);
    if (d.pred_mode && d.pred_mode[u] != 0) return false;
    out->x = d.mv[2 * u]; out->y = d.mv[2 * u + 1]; out->ref = 0;
    return true;
  }
  int rect_merge_list(int x0, int y0, int pw, int ph, int part, int pu_idx,
                      MV out[5]) const {
    int cux = x0, cuy = y0, cun;
    if (part == 1) { cuy -= pu_idx ? ph : 0; cun = pw; }   // 2NxN
    else { cux -= pu_idx ? pw : 0; cun = ph; }             // Nx2N
    MV a1, b1, b0, a0, b2;
    bool ha1 = motion_at_rect(x0 - 1, y0 + ph - 1, x0, y0, cux, cuy, cun, &a1);
    bool hb1 = motion_at_rect(x0 + pw - 1, y0 - 1, x0, y0, cux, cuy, cun, &b1);
    bool hb0 = motion_at_rect(x0 + pw, y0 - 1, x0, y0, cux, cuy, cun, &b0);
    bool ha0 = motion_at_rect(x0 - 1, y0 + ph, x0, y0, cux, cuy, cun, &a0);
    bool hb2 = motion_at_rect(x0 - 1, y0 - 1, x0, y0, cux, cuy, cun, &b2);
    if (part == 2 && pu_idx == 1) ha1 = false;   // A1 in PU0 (8.5.3.2.3)
    if (part == 1 && pu_idx == 1) hb1 = false;   // B1 in PU0
    int cnt = 0;
    auto same = [](bool hx, const MV& u, bool hy, const MV& v) {
      return hx && hy && u.x == v.x && u.y == v.y && u.ref == v.ref;
    };
    if (ha1) out[cnt++] = a1;
    if (hb1 && !same(hb1, b1, ha1, a1)) out[cnt++] = b1;
    if (hb0 && !same(hb0, b0, hb1, b1)) out[cnt++] = b0;
    if (ha0 && !same(ha0, a0, ha1, a1)) out[cnt++] = a0;
    if (cnt < 4 && hb2 && !same(hb2, b2, ha1, a1) && !same(hb2, b2, hb1, b1))
      out[cnt++] = b2;
    while (cnt < 5) out[cnt++] = MV{0, 0, 0};
    return 5;
  }
  void rect_amvp_list(int x0, int y0, int pw, int ph, int part, int pu_idx,
                      MV out[2]) const {
    int cux = x0, cuy = y0, cun;
    if (part == 1) { cuy -= pu_idx ? ph : 0; cun = pw; }
    else { cux -= pu_idx ? pw : 0; cun = ph; }
    MV a0, a1, b0, b1, b2, mva, mvb;
    bool hva = false, hvb = false;
    if (motion_at_rect(x0 - 1, y0 + ph, x0, y0, cux, cuy, cun, &a0)) { mva = a0; hva = true; }
    else if (motion_at_rect(x0 - 1, y0 + ph - 1, x0, y0, cux, cuy, cun, &a1)) { mva = a1; hva = true; }
    if (motion_at_rect(x0 + pw, y0 - 1, x0, y0, cux, cuy, cun, &b0)) { mvb = b0; hvb = true; }
    else if (motion_at_rect(x0 + pw - 1, y0 - 1, x0, y0, cux, cuy, cun, &b1)) { mvb = b1; hvb = true; }
    else if (motion_at_rect(x0 - 1, y0 - 1, x0, y0, cux, cuy, cun, &b2)) { mvb = b2; hvb = true; }
    int cnt = 0;
    if (hva) out[cnt++] = mva;
    if (hvb && (!hva || mvb.x != mva.x || mvb.y != mva.y)) out[cnt++] = mvb;
    while (cnt < 2) out[cnt++] = MV{0, 0, 0};
  }

  void inter_cu_rect(int x0, int y0, int log2, int part) {
    // part_mode "01" = 2NxN, "00(1)" = Nx2N (AMP off, spec 9.3.3.7);
    // per-PU merge/AMVP motion, then rqt_root_cbf (always coded)
    int size = 1 << log2, half = size >> 1;
    c.bin(PART_SIZE, 0);
    c.bin(PART_SIZE + 1, part == 1);
    if (part == 2 && log2 == p.log2_min_cb && log2 > 3)
      c.bin(PART_SIZE + 2, 1);
    int pus[2][4];
    if (part == 1) {
      int t0[4] = {x0, y0, size, half}, t1[4] = {x0, y0 + half, size, half};
      memcpy(pus[0], t0, sizeof t0); memcpy(pus[1], t1, sizeof t1);
    } else {
      int t0[4] = {x0, y0, half, size}, t1[4] = {x0 + half, y0, half, size};
      memcpy(pus[0], t0, sizeof t0); memcpy(pus[1], t1, sizeof t1);
    }
    for (int i = 0; i < 2; i++) {
      int px = pus[i][0], py = pus[i][1], pw = pus[i][2], ph = pus[i][3];
      int u = (py >> 3) * d.w8 + (px >> 3);
      int mode = d.inter_mode[u];
      c.bin(MERGE_FLAG, mode == 1);
      if (mode == 1) {
        encode_merge_idx(d.merge_idx[u]);
        continue;
      }
      MV mvp[2];
      rect_amvp_list(px, py, pw, ph, part, i, mvp);
      int f = d.mvp_flag[u];
      encode_mvd(d.mv[2 * u] - mvp[f].x, d.mv[2 * u + 1] - mvp[f].y);
      c.bin(MVP_IDX, f);
    }
    int u0 = (y0 >> 3) * d.w8 + (x0 >> 3);
    int rcbf = d.root_cbf[u0];
    c.bin(QT_ROOT_CBF, rcbf);
    if (rcbf) {
      bool forced = p.max_tr_depth_inter == 0;
      transform_tree(x0, y0, x0, y0, log2, 0, 0, forced,
                     p.max_tr_depth_inter + (forced ? 1 : 0), true, true);
    }
  }

  void encode_merge_idx(int idx, int max_cand = 5) {
    if (max_cand <= 1) return;
    c.bin(MERGE_IDX, idx > 0);
    if (idx > 0) {
      for (int i = 1; i < idx; i++) c.bypass(1);
      if (idx < max_cand - 1) c.bypass(0);
    }
  }
  void encode_eg_bypass(int value, int k) {
    while (value >= (1 << k)) { c.bypass(1); value -= 1 << k; k++; }
    c.bypass(0);
    while (k) { k--; c.bypass((value >> k) & 1); }
  }
  void encode_mvd(int mx, int my) {
    int ax = mx < 0 ? -mx : mx, ay = my < 0 ? -my : my;
    c.bin(MVD, ax > 0);
    c.bin(MVD, ay > 0);
    if (ax > 0) c.bin(MVD + 1, ax > 1);
    if (ay > 0) c.bin(MVD + 1, ay > 1);
    if (ax > 0) { if (ax > 1) encode_eg_bypass(ax - 2, 1); c.bypass(mx < 0); }
    if (ay > 0) { if (ay > 1) encode_eg_bypass(ay - 2, 1); c.bypass(my < 0); }
  }

  void inter_cu(int x0, int y0, int log2) {
    int u = (y0 >> 3) * d.w8 + (x0 >> 3);
    if (d.inter_part && d.inter_part[u]) {
      inter_cu_rect(x0, y0, log2, d.inter_part[u]);
      return;
    }
    c.bin(PART_SIZE, 1);  // 2Nx2N
    int mode = d.inter_mode[u];  // 1=merge, 2=amvp
    c.bin(MERGE_FLAG, mode == 1);
    if (mode == 1) {
      encode_merge_idx(d.merge_idx[u]);
    } else {
      bool b_lists = p.slice_type == 0 && d.mv_l1 != nullptr;
      int cdir = b_lists ? dir_at(x0, y0) : 1;
      if (p.slice_type == 0) {
        // inter_pred_idc (9.3.3.7): bin0 = BI (ctx by depth); uni adds
        // bin1 = L1 (ctx 4)
        int depth = d.cu_depth[u];
        c.bin(INTER_DIR + depth, cdir == 3 ? 1 : 0);
        if (cdir != 3) c.bin(INTER_DIR + 4, cdir == 2 ? 1 : 0);
      }
      if (cdir & 1) {
        MV mvp[2];
        if (b_lists) amvp_list_2(x0, y0, 1 << log2, 0, mvp);
        else amvp_list(x0, y0, 1 << log2, mvp);
        int f = d.mvp_flag[u];
        encode_mvd(d.mv[2 * u] - mvp[f].x, d.mv[2 * u + 1] - mvp[f].y);
        c.bin(MVP_IDX, f);
      }
      if (cdir & 2) {
        MV mvp1[2];
        amvp_list_2(x0, y0, 1 << log2, 1, mvp1);
        int f1 = d.mvp_flag_l1[u];
        encode_mvd(d.mv_l1[2 * u] - mvp1[f1].x,
                   d.mv_l1[2 * u + 1] - mvp1[f1].y);
        c.bin(MVP_IDX, f1);
      }
    }
    int rcbf = d.root_cbf[u];
    if (mode != 1) c.bin(QT_ROOT_CBF, rcbf);
    if (rcbf)
      transform_tree(x0, y0, x0, y0, log2, 0, 0, false,
                     p.max_tr_depth_inter, true, true);
  }

  // ---- SAO ------------------------------------------------------------------------
  void sao_ctu(int cx, int cy) {
    int ci = cy * d.ctus_x + cx;
    bool ml = d.sao_merge_left[ci] != 0;
    bool mu = d.sao_merge_up[ci] != 0;
    if (cx > 0) c.bin(SAO_MERGE, ml);
    if (cy > 0 && !(cx > 0 && ml)) c.bin(SAO_MERGE, mu);
    if ((cx > 0 && ml) || mu) return;
    for (int cidx = 0; cidx < 3; cidx++) {
      int t = cidx == 0 ? d.sao_type_l[ci] : d.sao_type_c[ci];
      if (cidx < 2) {
        c.bin(SAO_TYPE, t != 0);
        if (t != 0) c.bypass(t == 2);
      }
      if (t == 0) continue;
      const int32_t* off = d.sao_off + (ci * 3 + cidx) * 4;
      for (int i = 0; i < 4; i++) {
        int v = off[i] < 0 ? -off[i] : off[i];
        for (int k = 0; k < v; k++) c.bypass(1);
        if (v < 7) c.bypass(0);
      }
      if (t == 1) {
        for (int i = 0; i < 4; i++) if (off[i]) c.bypass(off[i] < 0);
        c.bypass_bins(d.sao_band[ci * 3 + cidx], 5);
      } else {
        if (cidx == 0) c.bypass_bins(d.sao_eo_l[ci], 2);
        else if (cidx == 1) c.bypass_bins(d.sao_eo_c[ci], 2);
      }
    }
  }

  // ---- CU -----------------------------------------------------------------------
  void coding_unit(int x0, int y0, int log2) {
    if (p.slice_type != 2) {
      int u = (y0 >> 3) * d.w8 + (x0 >> 3);
      int ctx = 0;
      if (x0 > 0 && d.skip[(y0 >> 3) * d.w8 + ((x0 - 1) >> 3)]) ctx++;
      if (y0 > 0 && d.skip[((y0 - 1) >> 3) * d.w8 + (x0 >> 3)]) ctx++;
      int sk = d.skip[u];
      c.bin(SKIP_FLAG + ctx, sk);
      if (sk) { encode_merge_idx(d.merge_idx[u]); return; }
      bool ii = is_intra(x0, y0);
      c.bin(PRED_MODE, ii ? 1 : 0);
      if (!ii) { inter_cu(x0, y0, log2); return; }
      intra_cu(x0, y0, log2);
      return;
    }
    intra_cu(x0, y0, log2);
  }

  void intra_cu(int x0, int y0, int log2) {
    bool is_nxn = nxn(x0, y0);
    if (log2 == p.log2_min_cb) c.bin(PART_SIZE, is_nxn ? 0 : 1);
    int n_pu = is_nxn ? 4 : 1;
    int size = 1 << log2;
    int pu = is_nxn ? size >> 1 : size;
    int modes[4], mpms[4][3], in_mpm[4];
    for (int i = 0; i < n_pu; i++) {
      int px = x0 + (i & 1) * pu, py = y0 + (i >> 1) * pu;
      modes[i] = lmode(px, py);
      int left = (px > 0 && is_intra(px - 1, py)) ? lmode(px - 1, py) : 1;
      int ctu = 1 << p.log2_ctu;
      int above = (py > 0 && (py % ctu) != 0 && is_intra(px, py - 1))
          ? lmode(px, py - 1) : 1;
      mpm_list(left, above, mpms[i]);
      in_mpm[i] = (modes[i] == mpms[i][0] || modes[i] == mpms[i][1] ||
                   modes[i] == mpms[i][2]);
      c.bin(INTRA_PRED_MODE, in_mpm[i]);
    }
    for (int i = 0; i < n_pu; i++) {
      if (in_mpm[i]) {
        int idx = modes[i] == mpms[i][0] ? 0 : (modes[i] == mpms[i][1] ? 1 : 2);
        c.bypass(idx != 0);
        if (idx) c.bypass(idx - 1);
      } else {
        int s[3] = {mpms[i][0], mpms[i][1], mpms[i][2]};
        if (s[0] > s[1]) { int t = s[0]; s[0] = s[1]; s[1] = t; }
        if (s[0] > s[2]) { int t = s[0]; s[0] = s[2]; s[2] = t; }
        if (s[1] > s[2]) { int t = s[1]; s[1] = s[2]; s[2] = t; }
        int rem = modes[i];
        for (int k = 2; k >= 0; k--) if (rem > s[k]) rem--;
        c.bypass_bins(rem, 5);
      }
    }
    // chroma mode
    int cm = cmode(x0, y0);
    int lm = modes[0];
    int syn;
    if (cm == lm) syn = 4;
    else {
      int cands[4] = {0, 26, 10, 1};
      for (int i = 0; i < 4; i++) if (cands[i] == lm) cands[i] = 34;
      syn = 0;
      for (int i = 0; i < 4; i++) if (cands[i] == cm) { syn = i; break; }
    }
    if (syn == 4) c.bin(CHROMA_PRED_MODE, 0);
    else { c.bin(CHROMA_PRED_MODE, 1); c.bypass_bins(syn, 2); }
    int max_depth = p.max_tr_depth_intra + (is_nxn ? 1 : 0);
    transform_tree(x0, y0, x0, y0, log2, 0, 0, is_nxn, max_depth, true, true);
  }

  void coding_quadtree(int x0, int y0, int log2, int depth) {
    int size = 1 << log2;
    bool inside = (x0 + size <= p.width) && (y0 + size <= p.height);
    int cur = depth_at(x0, y0);
    int split;
    if (inside && log2 > p.log2_min_cb) {
      int ctx = 0;
      if (x0 > 0 && depth_at(x0 - 1, y0) > depth) ctx++;
      if (y0 > 0 && depth_at(x0, y0 - 1) > depth) ctx++;
      split = cur > depth;
      c.bin(SPLIT_FLAG + ctx, split);
    } else {
      split = (!inside && log2 > p.log2_min_cb) ? 1
              : (log2 > p.log2_min_cb && cur > depth);
    }
    if (split) {
      int half = size >> 1;
      int order[4][2] = {{0,0},{half,0},{0,half},{half,half}};
      for (int i = 0; i < 4; i++) {
        int x1 = x0 + order[i][0], y1 = y0 + order[i][1];
        if (x1 < p.width && y1 < p.height)
          coding_quadtree(x1, y1, log2 - 1, depth + 1);
      }
    } else {
      coding_unit(x0, y0, log2);
    }
  }
};

}  // namespace

extern "C" {

// Encode slice data for an I or P slice, optionally as WPP row substreams.
// Returns total payload length (rows concatenated); when wpp != 0, fills
// row_sizes[ctus_y] with each substream's byte length.
long hevcenc_encode_slice2(
    const uint8_t* ctx_init,     // NUM_CTX initialized context states
    int width, int height, int log2_ctu, int log2_min_cb,
    int log2_min_tb, int log2_max_tb,
    int max_tr_depth_intra, int max_tr_depth_inter,
    int sign_hiding, int slice_type, int wpp, int dist0, int dist1,
    int cu_qp_delta, int slice_qp,
    const uint8_t* cu_depth, const uint8_t* part_nxn,
    const uint8_t* luma_mode, const uint8_t* chroma_mode,
    const uint8_t* tr_depth, const uint8_t* pred_mode,
    const int8_t* qp_map,
    const int16_t* coef_y, const int16_t* coef_u, const int16_t* coef_v,
    const uint8_t* skip, const uint8_t* inter_mode, const uint8_t* merge_idx,
    const uint8_t* mvp_flag, const uint8_t* root_cbf, const int32_t* mv,
    const int32_t* mv_l1, const uint8_t* mvp_flag_l1,
    const uint8_t* inter_dir, const uint8_t* inter_part,
    const uint8_t* sao_merge_left, const uint8_t* sao_merge_up,
    const int32_t* sao_type_l, const int32_t* sao_type_c,
    const int32_t* sao_eo_l, const int32_t* sao_eo_c,
    const int32_t* sao_band, const int32_t* sao_off,
    uint8_t* out_buf, long out_cap, long* row_sizes, int n_threads,
    // CG wire (nullable): when wire_cg_bitmap is set the residual coder
    // reads the device wire directly and the dense coef planes may be
    // null (ops/pack.py pack_sparse_cg order: spatial 4x4 blocks, luma
    // then U then V)
    const uint8_t* wire_cg_bitmap, const uint16_t* wire_masks16,
    const uint8_t* wire_codes, const int32_t* wire_esc_idx,
    const int16_t* wire_esc_val,
    long wire_count, long wire_esc_count, long wire_cg_count) {
  uint64_t t_start = prof_on() ? __rdtsc() : 0;
  uint64_t t_setup = 0;
  if (const char* dp = std::getenv("HEVCENC_DUMP")) {
    // capture the first intra wire-direct slice's inputs for the offline
    // profiling harness (tools/hevcprof.cpp); format: scalars then
    // length-prefixed buffers in a fixed order
    static std::atomic<int> dumped{0};
    if (slice_type == 2 && wire_cg_bitmap && !dumped.exchange(1)) {
      FILE* f = fopen(dp, "wb");
      if (f) {
        long scal[16] = {width, height, log2_ctu, log2_min_cb, log2_min_tb,
                         log2_max_tb, max_tr_depth_intra, max_tr_depth_inter,
                         sign_hiding, slice_type, cu_qp_delta, slice_qp,
                         wire_count, wire_esc_count, wire_cg_count, 0};
        fwrite(scal, sizeof scal, 1, f);
        long w8 = (long)(width >> 3) * (height >> 3);
        long w4 = (long)(width >> 2) * (height >> 2);
        long ncg_tot2 = w4 + 2 * w8;   // luma 4x4 CGs + 2 chroma planes
        auto wr = [&](const void* p2, long n) {
          fwrite(&n, sizeof n, 1, f);
          if (n) fwrite(p2, 1, (size_t)n, f);
        };
        wr(ctx_init, NUM_CTX);
        wr(cu_depth, w8); wr(part_nxn, w8);
        wr(luma_mode, w4); wr(chroma_mode, w8);
        wr(tr_depth, w8); wr(pred_mode, w8);
        wr(wire_cg_bitmap, (ncg_tot2 + 7) >> 3);
        wr(wire_masks16, wire_cg_count * 2);
        wr(wire_codes, (wire_count + 3) >> 2);
        wr(wire_esc_idx, wire_esc_count * 4);
        wr(wire_esc_val, wire_esc_count * 2);
        fclose(f);
      }
    }
  }
  Enc e;
  e.p = Params{width, height, log2_ctu, log2_min_cb, log2_min_tb,
               log2_max_tb, max_tr_depth_intra, max_tr_depth_inter,
               sign_hiding, cu_qp_delta, slice_qp, slice_type, wpp,
               dist0, dist1};
  e.qp_pred = slice_qp;
  e.d.cu_depth = cu_depth; e.d.part_nxn = part_nxn;
  e.d.qp_map = qp_map;
  e.d.luma_mode = luma_mode; e.d.chroma_mode = chroma_mode;
  e.d.tr_depth = tr_depth; e.d.pred_mode = pred_mode;
  e.d.coef_y = coef_y; e.d.coef_u = coef_u; e.d.coef_v = coef_v;
  e.d.skip = skip; e.d.inter_mode = inter_mode; e.d.merge_idx = merge_idx;
  e.d.mvp_flag = mvp_flag; e.d.root_cbf = root_cbf; e.d.mv = mv;
  e.d.mv_l1 = mv_l1; e.d.mvp_flag_l1 = mvp_flag_l1;
  e.d.inter_dir = inter_dir;
  e.d.inter_part = inter_part;
  e.d.sao_merge_left = sao_merge_left; e.d.sao_merge_up = sao_merge_up;
  e.d.sao_type_l = sao_type_l; e.d.sao_type_c = sao_type_c;
  e.d.sao_eo_l = sao_eo_l; e.d.sao_eo_c = sao_eo_c;
  e.d.sao_band = sao_band; e.d.sao_off = sao_off;
  e.d.w8 = width >> 3; e.d.w4 = width >> 2; e.d.w = width;
  e.d.cw = width >> 1;
  int ctu = 1 << log2_ctu;
  int cw = (width + ctu - 1) / ctu, ch = (height + ctu - 1) / ctu;
  e.d.ctus_x = cw;
  bool has_sao = sao_merge_left != nullptr;

  e.d.w4b = width >> 2; e.d.cw4b = width >> 3;
  long ncg_y = (size_t)(width >> 2) * (height >> 2);
  long ncg_c = (size_t)(width >> 3) * (height >> 3);
  long ncg_tot = ncg_y + 2 * ncg_c;
  std::vector<uint8_t> nzy, nzu, nzv;
  std::vector<uint16_t> mf;
  std::vector<int32_t> voff;
  std::vector<int16_t> vals;
  e.d.mf = nullptr; e.d.voff = nullptr; e.d.vals = nullptr;
  if (wire_cg_bitmap) {
    // wire-direct: expand the compacted CG masks to a full-frame mask
    // array + per-CG value offsets, and decode the 2-bit level codes
    // (escapes overwrite). One O(ncg)+O(count) pass replaces the dense
    // unpack AND every dense-plane scan in the serializer.
    mf.assign(ncg_tot, 0);
    voff.assign(ncg_tot, 0);
    long ci = 0;
    int32_t off = 0;
    long nbytes = (ncg_tot + 7) >> 3;
    for (long B = 0; B < nbytes; B++) {
      unsigned b = wire_cg_bitmap[B];
      while (b) {
        int g = __builtin_ctz(b);
        b &= b - 1;
        long cg = (B << 3) + g;
        if (ci >= wire_cg_count || cg >= ncg_tot) return -2;
        unsigned m = (uint16_t)wire_masks16[ci++];
        mf[cg] = (uint16_t)m;
        voff[cg] = off;
        off += __builtin_popcount(m);
      }
    }
    if (ci != wire_cg_count || off != wire_count) return -2;
    static const int16_t lut[4] = {1, -1, 2, -2};
    vals.resize(wire_count);
    for (long i = 0; i < wire_count; i++)
      vals[i] = lut[(wire_codes[i >> 2] >> ((i & 3) * 2)) & 3];
    for (long eidx = 0; eidx < wire_esc_count; eidx++) {
      long pi = wire_esc_idx[eidx];
      if (pi < 0 || pi >= wire_count) return -2;
      vals[pi] = wire_esc_val[eidx];
    }
    e.d.mf = mf.data();
    e.d.voff = voff.data();
    e.d.vals = vals.data();
    e.d.cg_base_u = ncg_y;
    e.d.cg_base_v = ncg_y + ncg_c;
  } else {
    // 4x4-block significance maps (one pass per plane; every cbf query
    // and CG skip in the serializer reads these instead of the dense
    // planes)
    nzy.resize(ncg_y);
    nzu.resize(ncg_c);
    nzv.resize(ncg_c);
    build_nzb4(coef_y, width, height, nzy.data());
    build_nzb4(coef_u, width >> 1, height >> 1, nzu.data());
    build_nzb4(coef_v, width >> 1, height >> 1, nzv.data());
    e.d.nzb4_y = nzy.data(); e.d.nzb4_u = nzu.data(); e.d.nzb4_v = nzv.data();
  }

  std::vector<uint8_t> all;
  all.reserve(out_cap);
  uint8_t ctx[NUM_CTX];
  memcpy(ctx, ctx_init, NUM_CTX);
  if (t_start) t_setup = __rdtsc();

  auto publish = [&](uint64_t nb, uint64_t by, uint64_t res, long bytes,
                     uint64_t rb0, uint64_t rb1) {
    if (!t_start) return;
    g_prof[0] += __rdtsc() - t_start;
    g_prof[1] += t_setup - t_start;
    g_prof[2] += res;
    g_prof[3] += nb;
    g_prof[4] += by;
    g_prof[5] += (uint64_t)bytes;
    g_prof[6] += 1;
    g_prof[7] += rb0;
    g_prof[8] += rb1;
  };

  if (!wpp) {
    std::vector<uint8_t> out;
    out.reserve(out_cap < (1 << 20) ? out_cap : (1 << 20));
    e.c.out = &out;
    e.c.ctx = ctx;
    int n = cw * ch;
    for (int i = 0; i < n; i++) {
      int cx = i % cw, cy = i / cw;
      e.qp_coded = false;           // QG = CTB
      if (has_sao) e.sao_ctu(cx, cy);
      e.coding_quadtree(cx * ctu, cy * ctu, log2_ctu, 0);
      e.c.terminate(i == n - 1);
    }
    e.c.finish();
    if ((long)out.size() > out_cap) return -1;
    memcpy(out_buf, out.data(), out.size());
    publish(e.c.nbins, e.c.nbyp, e.res_cycles, (long)out.size(),
            e.res_bins[0], e.res_bins[1]);
    return (long)out.size();
  }

  // WPP: one CABAC substream per CTB row. The analysis maps are complete
  // before serialization starts, so the ONLY cross-row dependency is the
  // entropy-sync context fork after CTB 1 of the row above (spec 9.3.1;
  // reference per-row substream threads, hmr_encoder_lib.c:1071-1090,2849).
  // Rows therefore run on a thread pool: each row waits on one atomic for
  // its predecessor's context snapshot, publishes its own after CTB 1, and
  // serializes the rest of the row fully independently.
  std::vector<std::vector<uint8_t>> rows(ch);
  std::vector<std::vector<uint8_t>> snaps(ch);
  std::unique_ptr<std::atomic<int>[]> ready(new std::atomic<int>[ch]);
  for (int i = 0; i < ch; i++) ready[i].store(0, std::memory_order_relaxed);

  auto encode_row = [&](Enc& er, int cy) {
    std::vector<uint8_t>& out = rows[cy];
    out.reserve(64 << 10);
    uint8_t rowctx[NUM_CTX];
    if (cy == 0) {
      memcpy(rowctx, ctx_init, NUM_CTX);
    } else {
      while (!ready[cy - 1].load(std::memory_order_acquire))
        std::this_thread::yield();
      memcpy(rowctx, snaps[cy - 1].data(), NUM_CTX);
    }
    er.c = Cabac{};
    er.c.out = &out;
    er.c.ctx = rowctx;
    er.qp_pred = slice_qp;          // qPY_PREV resets per WPP CTB row
    for (int cx = 0; cx < cw; cx++) {
      er.qp_coded = false;          // QG = CTB
      if (has_sao) er.sao_ctu(cx, cy);
      er.coding_quadtree(cx * ctu, cy * ctu, log2_ctu, 0);
      er.c.terminate(cy == ch - 1 && cx == cw - 1);
      if (cx == 1 && cy != ch - 1) {
        snaps[cy].assign(rowctx, rowctx + NUM_CTX);
        ready[cy].store(1, std::memory_order_release);
      }
    }
    if (cy != ch - 1) er.c.terminate(1);
    er.c.finish();
    er.tot_nbins += er.c.nbins;     // Cabac{} resets per row; roll up
    er.tot_nbyp += er.c.nbyp;
  };

  if (n_threads < 1) n_threads = 1;
  if (n_threads > ch) n_threads = ch;
  if (cw < 2) n_threads = 1;        // no CTB-1 snapshot exists to fork from

  if (n_threads == 1) {
    // sequential: propagate the snapshot chain in-place (cw == 1 keeps
    // the previous effective snapshot, matching the Python serializer)
    for (int cy = 0; cy < ch; cy++) {
      if (cw < 2 && cy > 0 && !ready[cy - 1].load(std::memory_order_relaxed)) {
        if (cy >= 2 && ready[cy - 2].load(std::memory_order_relaxed))
          snaps[cy - 1] = snaps[cy - 2];
        else
          snaps[cy - 1].assign(ctx_init, ctx_init + NUM_CTX);
        ready[cy - 1].store(1, std::memory_order_relaxed);
      }
      encode_row(e, cy);
    }
  } else {
    std::vector<std::thread> pool;
    std::atomic<uint64_t> pb{0}, py{0}, pr{0}, p0{0}, p1{0};
    for (int t = 1; t < n_threads; t++) {
      pool.emplace_back([&, t]() {
        Enc er;
        er.p = e.p; er.d = e.d;
        for (int cy = t; cy < ch; cy += n_threads) encode_row(er, cy);
        pb += er.tot_nbins; py += er.tot_nbyp; pr += er.res_cycles;
        p0 += er.res_bins[0]; p1 += er.res_bins[1];
      });
    }
    for (int cy = 0; cy < ch; cy += n_threads) encode_row(e, cy);
    for (auto& th : pool) th.join();
    e.tot_nbins += pb; e.tot_nbyp += py; e.res_cycles += pr;
    e.res_bins[0] += p0; e.res_bins[1] += p1;
  }

  for (int cy = 0; cy < ch; cy++) {
    row_sizes[cy] = (long)rows[cy].size();
    all.insert(all.end(), rows[cy].begin(), rows[cy].end());
  }
  if ((long)all.size() > out_cap) return -1;
  memcpy(out_buf, all.data(), all.size());
  publish(e.tot_nbins, e.tot_nbyp, e.res_cycles, (long)all.size(),
          e.res_bins[0], e.res_bins[1]);
  return (long)all.size();
}

// Fetch-and-reset the HEVCENC_PROF counters: [slice_cycles, setup_cycles,
// residual_cycles, ctx_bins, bypass_bins, payload_bytes, slices,
// luma_res_bins, chroma_res_bins, 0].
void hevcenc_prof_read(uint64_t* out10) {
  for (int i = 0; i < 10; i++) out10[i] = g_prof[i].exchange(0);
}

// Expand the device wire format (significance bitmap + compacted int8
// levels + escape list, see ops/pack.py) into a dense int16 plane buffer.
// esc_idx holds ascending packed-order indices of levels whose int16 value
// exceeded the int8 range. Returns consumed value count, or -1 on a
// bitmap/count mismatch.
long hevcenc_unpack_sparse8(
    const uint8_t* bitmap, const int8_t* vals8, long count,
    const int32_t* esc_idx, const int16_t* esc_val, long esc_count,
    long n_total, int16_t* out) {
  long vi = 0, e = 0;
  long next_esc = esc_count > 0 ? esc_idx[0] : -1;
  for (long i = 0; i < n_total; i += 8) {
    uint8_t b = bitmap[i >> 3];
    if (!b) {
      memset(out + i, 0, 8 * sizeof(int16_t));
      continue;
    }
    for (int k = 0; k < 8; k++) {
      if ((b >> k) & 1) {
        int16_t v = (int16_t)vals8[vi];
        if (vi == next_esc) {
          v = esc_val[e];
          e++;
          next_esc = e < esc_count ? esc_idx[e] : -1;
        }
        out[i + k] = v;
        vi++;
      } else {
        out[i + k] = 0;
      }
    }
  }
  if (vi != count) return -1;
  return vi;
}

// Expand the 2-bit wire format (see ops/pack.py pack_sparse2): each
// nonzero is a 2-bit code {0:+1, 1:-1, 2:+2, 3:-2}, packed 4 per byte in
// compaction order; esc_idx/esc_val override the rare |level| > 2 cases.
// Returns consumed value count, or -1 on a bitmap/count mismatch.
long hevcenc_unpack_sparse2(
    const uint8_t* bitmap, const uint8_t* codes, long count,
    const int32_t* esc_idx, const int16_t* esc_val, long esc_count,
    long n_total, int16_t* out) {
  static const int16_t lut[4] = {1, -1, 2, -2};
  long vi = 0, e = 0;
  long next_esc = esc_count > 0 ? esc_idx[0] : -1;
  for (long i = 0; i < n_total; i += 8) {
    uint8_t b = bitmap[i >> 3];
    if (!b) {
      memset(out + i, 0, 8 * sizeof(int16_t));
      continue;
    }
    for (int k = 0; k < 8; k++) {
      if ((b >> k) & 1) {
        int16_t v = lut[(codes[vi >> 2] >> ((vi & 3) * 2)) & 3];
        if (vi == next_esc) {
          v = esc_val[e];
          e++;
          next_esc = e < esc_count ? esc_idx[e] : -1;
        }
        out[i + k] = v;
        vi++;
      } else {
        out[i + k] = 0;
      }
    }
  }
  if (vi != count) return -1;
  return vi;
}

// Expand the two-tier CG wire format (ops/pack.py pack_sparse_cg):
// cg_bitmap has one presence bit per SPATIAL 4x4 coefficient group
// (plane blocks in raster order, planes concatenated); masks16 holds
// the 16-bit significance mask of each nonzero CG in that order (bit k
// = coefficient (k/4, k%4) of the block); codes/escapes are the
// pack_sparse2 value wire. Output planes are raster int16, laid out
// consecutively in `out` (w0*h0 | w1*h1 | w2*h2). Returns consumed
// value count, or -1 on a mask/count mismatch.
long hevcenc_unpack_sparse_cg(
    const uint8_t* cg_bitmap, const uint16_t* masks16, const uint8_t* codes,
    long count, long cg_count,
    const int32_t* esc_idx, const int16_t* esc_val, long esc_count,
    long n_total, int16_t* out,
    int w0, int h0, int w1, int h1, int w2, int h2) {
  static const int16_t lut[4] = {1, -1, 2, -2};
  if ((long)w0 * h0 + (long)w1 * h1 + (long)w2 * h2 != n_total) return -1;
  memset(out, 0, (size_t)n_total * sizeof(int16_t));
  // per-plane CG ranges and raster bases
  long ncg0 = ((long)w0 >> 2) * (h0 >> 2), ncg1 = ((long)w1 >> 2) * (h1 >> 2);
  long ncg2 = ((long)w2 >> 2) * (h2 >> 2);
  long vi = 0, ci = 0, e = 0;
  long next_esc = esc_count > 0 ? esc_idx[0] : -1;
  long nbytes = (ncg0 + ncg1 + ncg2 + 7) >> 3;
  for (long B = 0; B < nbytes; B++) {
    unsigned b = cg_bitmap[B];
    while (b) {
      int g = __builtin_ctz(b);
      b &= b - 1;
      if (ci >= cg_count) return -1;
      unsigned m = masks16[ci++];
      long cg = (B << 3) + g;
      int pw;
      int16_t* base;
      long rel = cg;
      if (rel < ncg0) { pw = w0; base = out; }
      else if ((rel -= ncg0) < ncg1) { pw = w1; base = out + (long)w0 * h0; }
      else { rel -= ncg1; pw = w2; base = out + (long)w0 * h0 + (long)w1 * h1; }
      long w4 = pw >> 2;
      int16_t* o = base + (rel / w4) * 4 * pw + (rel % w4) * 4;
      while (m) {
        int t = __builtin_ctz(m);
        m &= m - 1;
        int16_t v = lut[(codes[vi >> 2] >> ((vi & 3) * 2)) & 3];
        if (vi == next_esc) {
          v = esc_val[e];
          e++;
          next_esc = e < esc_count ? esc_idx[e] : -1;
        }
        o[(t >> 2) * pw + (t & 3)] = v;
        vi++;
      }
    }
  }
  if (vi != count || ci != cg_count) return -1;
  return vi;
}

}  // extern "C"
