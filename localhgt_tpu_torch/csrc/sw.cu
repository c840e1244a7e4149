// Batched affine-gap Smith-Waterman for Hopper (sm_90a): kernels K1 and K2.
//
// K1 `lht_sw_align` replaces localhgt_tpu/ops/pallas_sw.py::sw_align_pallas
// (kernel _sw_align_kernel): score plus query and reference spans through
// an origin register, no traceback. K2 `lht_sw_score` replaces
// pallas_sw.py::sw_score_pallas (kernel _sw_score_kernel): score only.
// Nothing of the M x N matrix touches device memory: a kernel reads M + N
// bytes and writes 20 (K1) or 4 (K2) bytes per alignment, so both are bound
// by the integer instructions they execute, not by memory.
//
// ---- K1 ----
// Recurrence (identical to the Pallas body, row i over columns j):
//   H1 = max(max(Hdiag + sub, 0), F)      F = Mf + open + i*ext
//   E  = prefmax_{j'<j}(H1 - j'*ext) + open + j*ext
//   H  = max(H1, E);  Mf = max(Mf, H - i*ext)
//
// Mapping: one warp per alignment. Lane l holds the NPL contiguous columns
// [l*NPL, (l+1)*NPL) in registers; the loop runs over the M query rows.
// The diagonal neighbour of a lane's first column comes from lane l-1 by
// __shfl_up_sync, and E's prefix max is a scan inside the lane followed by
// a warp scan of the lane totals.
//
// Tie rules, which decide the start coordinates and are reproduced exactly:
//   * H1 prefers the diagonal over F, H prefers H1 over E, Mf keeps the
//     older value: each takes the challenger only when strictly greater;
//   * E's prefix max takes the LATEST j' among tied maxima (the Pallas
//     log-step shift-max keeps the current value on ties);
//   * the best cell is max H, then the earliest row, then the smallest j.
//
// Wide references (512 < N <= 4096) cannot keep N/32 columns per lane in
// registers: five int32 arrays of up to 128 would spill. There one block
// aligns one pair: each thread holds 8 contiguous columns and each warp a
// contiguous stripe of 256. Per row, the diagonal neighbour of a warp's
// first column and the warps' E prefix totals pass through shared memory,
// with two barriers a row; the tie rules above hold across stripes (an
// earlier stripe's prefix wins only when strictly greater).
//
// ---- K2 ----
// K2 returns only the score, so no tie rule binds it, and it computes the
// same numbers cell by cell in the Gotoh form, which needs no i*ext or
// j*ext term (equal to the form above in integers: F below is
// Mf + open + i*ext, and E is the prefix maximum written as a recurrence):
//   H1[i][j] = max(H[i-1][j-1] + sub(q[i], r[j]), F[i][j], 0)
//   H [i][j] = max(H1[i][j], E[i][j])
//   E [i][j+1] = max(E[i][j] + ext, H1[i][j] + open + ext)  E[i][0] = NEG+open
//   F [i+1][j] = max(F[i][j] + ext, H [i][j] + open + ext)  F[0][j] = NEG+open
//   score = max(0, max H)
// sub is `match` where both codes are equal and below 4, else `mismatch`.
//
// Mapping: an anti-diagonal wavefront (sw_score_kernel). A group of G lanes
// holds one alignment, lane l the NPL columns [l*NPL, (l+1)*NPL) as H, F
// and the column's substitution table, in registers. At step t lane l
// works on query row t - l, so it needs from lane l-1 only what that lane
// left behind one step earlier: its last H (the diagonal of the next row)
// and the E that runs out of its last column. Two independent shuffles a
// step, no scan, and G - 1 steps of fill and drain; the steps in which
// every lane has a row run without the lane's own test. (G, NPL) is chosen
// so that G * NPL is the window's width: NPL is any integer, and groups of
// 8 or 16 lanes put four or two alignments into a warp (LHT_SCORE_PAIRS
// lists the pairs with the N each serves).
//
// A cell is 7.5 instructions: one byte permute for sub (the column holds
// its score against each of the four query codes in the bytes of one word,
// and the query is staged, 32 rows at a time into a ring in shared memory,
// as the selector that picks its byte), `__viaddmax_s32_relu` for H1, a
// max for H, an add and a `__viaddmax_s32` each for E and F, and half a
// `__vimax3_s32` for the maximum. 5.5 of them are permutes and maxima,
// which only the SM's 64-lane integer pipe runs.
// Columns past N are not masked out of the maximum: with mismatch <= 0,
// ext <= 0 and open + ext <= 0 their H cannot exceed that of a real cell.
// Other parameters, and scores that do not fit a byte of the table, take a
// guarded instantiation with a compare and a select for sub (lht_sw_score).
//
// Wide references (512 < N <= 4096): one block per alignment, as many
// alignments as there are on an SM being too few warps otherwise. The same
// kernel body, G = 32: warp w holds the stripe of 256 columns after warp
// w-1's and runs the same wavefront some rows behind it. The edge between
// two stripes (the left warp's last H and outgoing E of every row) goes
// through a ring of 256 rows in shared memory. A warp publishes the number
// of steps it has finished after every 32; its right neighbour waits for
// the rows of its next 32 steps, and it waits for its right neighbour
// before it overwrites rows of the ring. No block barrier in the loop, and
// no warp waits for one to its right except where the ring is full.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); it never synchronises or allocates.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

template <int NPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sw_align_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ r,
                int32_t* __restrict__ out, long long B, int M, int N,
                int match, int mismatch, int go, int ge) {
  const int lane = threadIdx.x & 31;
  const long long b =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform across the warp
  const uint8_t* qb = q + b * M;
  const uint8_t* rb = r + b * N;
  const int j0 = lane * NPL;
  const int np1 = N + 1;

  int rc[NPL], H[NPL], O[NPL], Mf[NPL], MfO[NPL];
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const int j = j0 + c;
    rc[c] = j < N ? (int)rb[j] : 4;
    H[c] = 0;
    O[c] = 0;
    Mf[c] = kNeg;
    MfO[c] = 0;
  }
  int bH = 0, bI = 0, bJ = 0, bO = 0;  // this lane's best cell

  for (int i = 0; i < M; ++i) {
    const int qi = qb[i];
    int hl = __shfl_up_sync(kFull, H[NPL - 1], 1);
    int ol = __shfl_up_sync(kFull, O[NPL - 1], 1);
    if (lane == 0) {
      hl = 0;
      ol = 0;
    }
    const int fadd = go + i * ge;
    int H1[NPL], O1[NPL];
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int hd = c == 0 ? hl : H[c - 1];
      const int od = c == 0 ? ol : O[c - 1];
      const int sub =
          (rc[c] == qi && rc[c] < 4 && qi < 4) ? match : mismatch;
      const int diag = hd + sub;
      const int diag_o = hd > 0 ? od : i * np1 + (j0 + c);
      const int h0 = diag > 0 ? diag : 0;
      const int f = Mf[c] + fadd;
      if (f > h0) {
        H1[c] = f;
        O1[c] = MfO[c];
      } else {
        H1[c] = h0;
        O1[c] = diag_o;
      }
    }
    // inclusive prefix max of T = H1 - j*ext inside the lane, later wins ties
    int sv = kNeg, so = 0;
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int t = H1[c] - (j0 + c) * ge;
      if (t >= sv) {
        sv = t;
        so = O1[c];
      }
    }
    // warp inclusive scan of the lane totals: an earlier lane wins only
    // when strictly greater
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int pv = __shfl_up_sync(kFull, sv, d);
      const int po = __shfl_up_sync(kFull, so, d);
      if (lane >= d && pv > sv) {
        sv = pv;
        so = po;
      }
    }
    int ev = __shfl_up_sync(kFull, sv, 1);
    int eo = __shfl_up_sync(kFull, so, 1);
    if (lane == 0) {
      ev = kNeg;
      eo = 0;
    }
    // ev/eo now hold the exclusive prefix (j' < j) for the lane's first column
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int j = j0 + c;
      const int e = ev + go + j * ge;
      int h, o;
      if (e > H1[c]) {
        h = e;
        o = eo;
      } else {
        h = H1[c];
        o = O1[c];
      }
      if (h < 0) h = 0;
      const int t = H1[c] - j * ge;
      if (t >= ev) {
        ev = t;
        eo = O1[c];
      }
      const int mv = h - i * ge;
      if (mv > Mf[c]) {
        Mf[c] = mv;
        MfO[c] = o;
      }
      if (j < N && h > bH) {
        bH = h;
        bI = i;
        bJ = j;
        bO = o;
      }
      H[c] = h;
      O[c] = o;
    }
  }
  // best over lanes: max H, then earliest row, then smallest column
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int oh = __shfl_xor_sync(kFull, bH, d);
    const int oi = __shfl_xor_sync(kFull, bI, d);
    const int oj = __shfl_xor_sync(kFull, bJ, d);
    const int oo = __shfl_xor_sync(kFull, bO, d);
    if (oh > bH || (oh == bH && (oi < bI || (oi == bI && oj < bJ)))) {
      bH = oh;
      bI = oi;
      bJ = oj;
      bO = oo;
    }
  }
  if (lane == 0) {
    int32_t* ob = out + b * 5;
    if (bH <= 0) {
      ob[0] = ob[1] = ob[2] = ob[3] = ob[4] = 0;
    } else {
      const int qs = bO / np1;
      ob[0] = bH;
      ob[1] = qs;
      ob[2] = bI;
      ob[3] = bO - qs * np1;
      ob[4] = bJ;
    }
  }
}

int columns_per_lane(int N) {
  int npl = 1;
  while (npl * 32 < N) npl *= 2;
  return npl;
}

constexpr int kNarrowMaxN = 16 * 32;  // the widest one-warp dispatch
constexpr int kWideNPL = 8;           // columns per thread, wide variant
constexpr int kWideMaxWarps = 16;
constexpr int kWideMaxN = kWideNPL * 32 * kWideMaxWarps;  // 4096

// K1's wide variant: one block of ceil(N / 256) warps per alignment. The
// recurrence and the tie rules are those of sw_align_kernel, term for term.
__global__ void __launch_bounds__(32 * kWideMaxWarps)
sw_align_wide_kernel(const uint8_t* __restrict__ q,
                     const uint8_t* __restrict__ r, int32_t* __restrict__ out,
                     int M, int N, int match, int mismatch, int go, int ge) {
  constexpr int NPL = kWideNPL;
  // per warp: E prefix total of the row (value, origin) and the last
  // column's H and origin of the previous row
  __shared__ int sTotV[kWideMaxWarps], sTotO[kWideMaxWarps];
  __shared__ int sEdgeH[kWideMaxWarps], sEdgeO[kWideMaxWarps];
  __shared__ int sBest[4][kWideMaxWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long b = blockIdx.x;
  const uint8_t* qb = q + b * M;
  const uint8_t* rb = r + b * N;
  const int j0 = threadIdx.x * NPL;
  const int np1 = N + 1;

  int rc[NPL], H[NPL], O[NPL], Mf[NPL], MfO[NPL];
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const int j = j0 + c;
    rc[c] = j < N ? (int)rb[j] : 4;
    H[c] = 0;
    O[c] = 0;
    Mf[c] = kNeg;
    MfO[c] = 0;
  }
  if (lane == 31) {
    sEdgeH[warp] = 0;
    sEdgeO[warp] = 0;
  }
  __syncthreads();
  int bH = 0, bI = 0, bJ = 0, bO = 0;  // this thread's best cell

  for (int i = 0; i < M; ++i) {
    const int qi = qb[i];
    int hl = __shfl_up_sync(kFull, H[NPL - 1], 1);
    int ol = __shfl_up_sync(kFull, O[NPL - 1], 1);
    if (lane == 0) {
      hl = warp == 0 ? 0 : sEdgeH[warp - 1];
      ol = warp == 0 ? 0 : sEdgeO[warp - 1];
    }
    const int fadd = go + i * ge;
    int H1[NPL], O1[NPL];
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int hd = c == 0 ? hl : H[c - 1];
      const int od = c == 0 ? ol : O[c - 1];
      const int sub =
          (rc[c] == qi && rc[c] < 4 && qi < 4) ? match : mismatch;
      const int diag = hd + sub;
      const int diag_o = hd > 0 ? od : i * np1 + (j0 + c);
      const int h0 = diag > 0 ? diag : 0;
      const int f = Mf[c] + fadd;
      if (f > h0) {
        H1[c] = f;
        O1[c] = MfO[c];
      } else {
        H1[c] = h0;
        O1[c] = diag_o;
      }
    }
    int sv = kNeg, so = 0;
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int t = H1[c] - (j0 + c) * ge;
      if (t >= sv) {
        sv = t;
        so = O1[c];
      }
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int pv = __shfl_up_sync(kFull, sv, d);
      const int po = __shfl_up_sync(kFull, so, d);
      if (lane >= d && pv > sv) {
        sv = pv;
        so = po;
      }
    }
    if (lane == 31) {
      sTotV[warp] = sv;
      sTotO[warp] = so;
    }
    __syncthreads();  // every warp's row total is written
    // prefix over the earlier stripes, in column order: the later wins ties
    int wv = kNeg, wo = 0;
    for (int w = 0; w < warp; ++w) {
      if (sTotV[w] >= wv) {
        wv = sTotV[w];
        wo = sTotO[w];
      }
    }
    int ev = __shfl_up_sync(kFull, sv, 1);
    int eo = __shfl_up_sync(kFull, so, 1);
    if (lane == 0 || wv > ev) {  // lanes of this warp are later than wv
      ev = wv;
      eo = wo;
    }
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int j = j0 + c;
      const int e = ev + go + j * ge;
      int h, o;
      if (e > H1[c]) {
        h = e;
        o = eo;
      } else {
        h = H1[c];
        o = O1[c];
      }
      if (h < 0) h = 0;
      const int t = H1[c] - j * ge;
      if (t >= ev) {
        ev = t;
        eo = O1[c];
      }
      const int mv = h - i * ge;
      if (mv > Mf[c]) {
        Mf[c] = mv;
        MfO[c] = o;
      }
      if (j < N && h > bH) {
        bH = h;
        bI = i;
        bJ = j;
        bO = o;
      }
      H[c] = h;
      O[c] = o;
    }
    if (lane == 31) {
      sEdgeH[warp] = H[NPL - 1];
      sEdgeO[warp] = O[NPL - 1];
    }
    __syncthreads();  // edges written; totals read by every warp
  }
  // best over the block: max H, then earliest row, then smallest column
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int oh = __shfl_xor_sync(kFull, bH, d);
    const int oi = __shfl_xor_sync(kFull, bI, d);
    const int oj = __shfl_xor_sync(kFull, bJ, d);
    const int oo = __shfl_xor_sync(kFull, bO, d);
    if (oh > bH || (oh == bH && (oi < bI || (oi == bI && oj < bJ)))) {
      bH = oh;
      bI = oi;
      bJ = oj;
      bO = oo;
    }
  }
  if (lane == 0) {
    sBest[0][warp] = bH;
    sBest[1][warp] = bI;
    sBest[2][warp] = bJ;
    sBest[3][warp] = bO;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < nwarps; ++w) {
    const int oh = sBest[0][w], oi = sBest[1][w], oj = sBest[2][w];
    if (oh > bH || (oh == bH && (oi < bI || (oi == bI && oj < bJ)))) {
      bH = oh;
      bI = oi;
      bJ = oj;
      bO = sBest[3][w];
    }
  }
  int32_t* ob = out + b * 5;
  if (bH <= 0) {
    ob[0] = ob[1] = ob[2] = ob[3] = ob[4] = 0;
  } else {
    const int qs = bO / np1;
    ob[0] = bH;
    ob[1] = qs;
    ob[2] = bI;
    ob[3] = bO - qs * np1;
    ob[4] = bJ;
  }
}

// ------------------------------------------------------------------ K2
//
// Tuning switches, set only by `python -m localhgt_tpu_torch.tune_sw`; the
// package's own build defines none of them:
//   LHT_SW_G, LHT_SW_NPL   one (lanes a group, columns a lane) pair for
//                          every N <= G * NPL instead of the table below;
//   LHT_SW_SCAN            the row-by-row mapping (sw_score_scan_kernel);
//   LHT_SW_TABLE           0: the substitution score as a compare and a
//                          select; 1: as one byte permute out of a table
//                          word a column (score_row);
//   LHT_SW_WIDE_NPL        columns a lane of the wide mapping.
#ifndef LHT_SW_SCAN
#define LHT_SW_SCAN 0
#endif
#ifndef LHT_SW_TABLE
#define LHT_SW_TABLE 1
#endif
#ifndef LHT_SW_WIDE_NPL
#define LHT_SW_WIDE_NPL 8
#endif

constexpr int kScoreWarps = 4;           // warps a block, N <= 512
// query rows staged at a time, and the steps between two progress counts
// of a stripe of the wide mapping; a power of two
constexpr int kChunk = 32;
constexpr int kScoreWideNPL = LHT_SW_WIDE_NPL;
constexpr int kEdgeRows = 256;           // rows of a stripe's edge in the ring
// codes that never match: a query code above 3 and a reference code above
// 3 (or a column past N) must differ from each other too
constexpr int kPadQ = 254, kPadR = 255;

// What a query row is staged as and what a reference column is held as.
// kTable: the column is a word of four bytes, byte a the score against
// query code a, and the row is the byte-permute selector that picks its
// byte sign-extended, or for a code above 3 the whole of `mismatch`.
// Otherwise both are codes, those above 3 mapped to kPadQ and kPadR.
template <bool kTable>
__device__ __forceinline__ int query_entry(int code) {
  if (kTable) return code > 3 ? 0x7654 : 0x8880 + 0x1111 * code;
  return code > 3 ? kPadQ : code;
}

template <bool kTable>
__device__ __forceinline__ int column_entry(int code, int match,
                                            int mismatch) {
  if (!kTable) return code > 3 ? kPadR : code;
  int word = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    word |= ((code == a ? match : mismatch) & 0xff) << (8 * a);
  return word;
}

// Rows [row0, row0 + kChunk) of one query into the two-chunk ring of a
// group, the G lanes sharing the loads; rows past M are code 4.
template <int G, bool kTable>
__device__ __forceinline__ void stage_query(uint16_t* ring,
                                            const uint8_t* qb, int M,
                                            int row0, int lg) {
#pragma unroll
  for (int u = 0; u < kChunk / G; ++u) {
    const int row = row0 + lg + u * G;
    const int code = row < M ? (int)qb[row] : 4;
    ring[row & (2 * kChunk - 1)] = (uint16_t)query_entry<kTable>(code);
  }
}

// One query row against the NPL columns of a lane. hd: H of the row above
// at the column left of the lane's first; e: E of this row at the lane's
// first column. Leaves the lane's H and F for the next row and returns E
// for the column right of the lane's last.
template <int NPL, bool kTable>
__device__ __forceinline__ int score_row(const int (&rc)[NPL], int (&H)[NPL],
                                         int (&F)[NPL], int qi, int hd, int e,
                                         int match, int mismatch, int goe,
                                         int ge) {
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    int sub;
    if (kTable)
      asm("prmt.b32 %0, %1, %2, %3;"
          : "=r"(sub)
          : "r"(rc[c]), "r"(mismatch), "r"(qi));
    else
      sub = rc[c] == qi ? match : mismatch;
    const int h1 = __viaddmax_s32_relu(hd, sub, F[c]);  // max(hd+sub, F, 0)
    hd = H[c];
    const int h = max(h1, e);
    e = __viaddmax_s32(e, ge, h1 + goe);
    F[c] = __viaddmax_s32(F[c], ge, h + goe);
    H[c] = h;
  }
  return e;
}

// max(best, H[0..NPL)) over the columns left of `nvalid` (all when !kGuard)
template <int NPL, bool kGuard>
__device__ __forceinline__ int row_best(const int (&H)[NPL], int best,
                                        int nvalid) {
  if (kGuard) {
#pragma unroll
    for (int c = 0; c < NPL; ++c)
      if (c < nvalid) best = max(best, H[c]);
  } else {
#pragma unroll
    for (int c = 0; c + 1 < NPL; c += 2)
      best = __vimax3_s32(best, H[c], H[c + 1]);
    if (NPL & 1) best = max(best, H[NPL - 1]);
  }
  return best;
}

// K2, anti-diagonal wavefront. A group of G lanes holds one alignment, lane
// l the NPL columns [l*NPL, (l+1)*NPL); at step t lane l works on query row
// t - l, so a step needs from the lane to its left only what that lane
// left behind one step earlier (its last H and the E that runs out of its
// last column), and no scan. kWide: one block per alignment, G = 32, warp w
// the stripe of 32*NPL columns after warp w-1's; the edge between two
// stripes goes through a ring in shared memory (see the header).
// kGuard: the maximum skips the columns past N, and the substitution score
// is a compare and a select whatever LHT_SW_TABLE says (see lht_sw_score).
template <int G, int NPL, bool kWide, bool kGuard>
__global__ void __launch_bounds__(32 * (kWide ? kWideMaxWarps : kScoreWarps))
sw_score_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ r,
                int32_t* __restrict__ out, long long B, int M, int N,
                int match, int mismatch, int go, int ge) {
  static_assert(!kWide || G == 32, "a stripe is a whole warp");
  static_assert(G <= kChunk, "the query ring holds the rows of two chunks, "
                             "and a group's lanes are spread over G");
  constexpr int kGroups = 32 / G;
  constexpr int kWarps = kWide ? kWideMaxWarps : kScoreWarps;
  constexpr bool kTable = LHT_SW_TABLE && !kGuard;
  __shared__ uint16_t sQuery[kWarps][kGroups][2 * kChunk];
  __shared__ int sProgress[kWarps];  // wide: steps each warp has finished
  __shared__ int sBest[kWarps];
  extern __shared__ int2 sEdge[];  // wide: [warps - 1][kEdgeRows] (H, E)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lg = lane & (G - 1);
  long long b;
  int j0;
  if (kWide) {
    b = blockIdx.x;
    j0 = (warp * 32 + lane) * NPL;
    if (lane == 0) sProgress[warp] = 0;
    __syncthreads();
  } else {
    b = ((long long)blockIdx.x * kScoreWarps + warp) * kGroups;
    if (b >= B) return;  // uniform across the warp
    b += lane / G;
    j0 = lg * NPL;
  }
  // a group past B repeats the last alignment and writes nothing, so that
  // every shuffle below has the whole warp
  const bool live = b < B;
  if (!live) b = B - 1;
  const uint8_t* qb = q + b * M;
  const uint8_t* rb = r + b * N;
  uint16_t* myq = sQuery[warp][lane / G];

  int rc[NPL], H[NPL], F[NPL];
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const int j = j0 + c;
    rc[c] = column_entry<kTable>(j < N ? (int)rb[j] : 4, match, mismatch);
    H[c] = 0;
    F[c] = kNeg + go;
  }
  const int nvalid = N - j0;
  const int goe = go + ge;
  int best = 0;
  int hlast = 0, eout = 0;  // what the lane to the right takes next step
  int hprev = 0;            // H of the row above, left of the first column

  // One step. kAll: every lane of the warp has a row (G-1 <= t < M), so
  // the lane's own test and the branch around the row are left out.
  auto step = [&](int t, auto all) {
    constexpr bool kAll = decltype(all)::value;
    const int i = t - lg;
    const bool active = kAll || (unsigned)i < (unsigned)M;
    int hleft = __shfl_up_sync(kFull, hlast, 1, G);
    int e = __shfl_up_sync(kFull, eout, 1, G);
    if (lg == 0) {
      hleft = 0;
      e = kNeg + go;  // column 0 has no column to its left
      if (kWide) {
        if (warp > 0 && active) {
          const int2 v = sEdge[(warp - 1) * kEdgeRows + (i & (kEdgeRows - 1))];
          hleft = v.x;
          e = v.y;
        }
      }
    }
    if (active) {
      const int qi = myq[i & (2 * kChunk - 1)];
      eout = score_row<NPL, kTable>(rc, H, F, qi, hprev, e, match, mismatch,
                                    goe, ge);
      best = row_best<NPL, kGuard>(H, best, nvalid);
      hlast = H[NPL - 1];
      if (kWide) {
        if (lane == 31 && warp + 1 < nwarps)
          sEdge[warp * kEdgeRows + (i & (kEdgeRows - 1))] =
              make_int2(hlast, eout);
      }
    }
    hprev = hleft;  // the left lane's row i is this lane's row above next
  };

  const int T = M + G - 1;
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int tend = min(t0 + kChunk, T);
    __syncwarp();
    stage_query<G, kTable>(myq, qb, M, t0, lg);
    if (kWide) {
      // the left stripe's last lane is 31 steps behind its first: rows up
      // to tend-1 are in the ring once that warp finished tend+31 steps
      if (warp > 0) {
        const int need = min(tend + 31, T);
        while (*(volatile int*)&sProgress[warp - 1] < need) __nanosleep(20);
      }
      // these steps write rows up to tend-32: the right stripe must have
      // read the rows kEdgeRows before them
      if (warp + 1 < nwarps) {
        const int need = tend - 31 - kEdgeRows;
        while (*(volatile int*)&sProgress[warp + 1] < need) __nanosleep(20);
      }
      __threadfence_block();
    }
    __syncwarp();
    int t = t0;
    for (; t < min(tend, G - 1); ++t) step(t, std::false_type());
    for (; t < min(tend, M); ++t) step(t, std::true_type());
    for (; t < tend; ++t) step(t, std::false_type());
    if (kWide) {
      __syncwarp();
      if (lane == 31) {
        __threadfence_block();
        *(volatile int*)&sProgress[warp] = tend;
      }
    }
  }

#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, d, G));
  if (!kWide) {
    if (lg == 0 && live) out[b] = best;
    return;
  }
  if (lane == 0) sBest[warp] = best;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < nwarps; ++w) best = max(best, sBest[w]);
  out[b] = best;
}

#if LHT_SW_SCAN
// K2, row by row: every lane of a group works on the same query row, and
// E's prefix over the lanes is a scan of log2(G) shuffle steps a row. Kept
// for `tune_sw`, which times it against the wavefront.
template <int G, int NPL, bool kGuard>
__global__ void __launch_bounds__(32 * kScoreWarps)
sw_score_scan_kernel(const uint8_t* __restrict__ q,
                     const uint8_t* __restrict__ r, int32_t* __restrict__ out,
                     long long B, int M, int N, int match, int mismatch,
                     int go, int ge) {
  constexpr int kGroups = 32 / G;
  __shared__ uint16_t sQuery[kScoreWarps][kGroups][2 * kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lg = lane & (G - 1);
  long long b = ((long long)blockIdx.x * kScoreWarps + warp) * kGroups;
  if (b >= B) return;
  b += lane / G;
  const bool live = b < B;
  if (!live) b = B - 1;
  const uint8_t* qb = q + b * M;
  const uint8_t* rb = r + b * N;
  uint16_t* myq = sQuery[warp][lane / G];
  const int j0 = lg * NPL;
  const int goe = go + ge;

  int rc[NPL], H[NPL], F[NPL];
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const int j = j0 + c;
    rc[c] = column_entry<false>(j < N ? (int)rb[j] : 4, match, mismatch);
    H[c] = 0;
    F[c] = kNeg + go;
  }
  const int nvalid = N - j0;
  int best = 0;
  for (int i0 = 0; i0 < M; i0 += kChunk) {
    const int iend = min(i0 + kChunk, M);
    __syncwarp();
    stage_query<G, false>(myq, qb, M, i0, lg);
    __syncwarp();
    for (int i = i0; i < iend; ++i) {
      const int qi = myq[i & (2 * kChunk - 1)];
      int hd = __shfl_up_sync(kFull, H[NPL - 1], 1, G);
      if (lg == 0) hd = 0;
      int h1[NPL];
      int sv = kNeg;  // max of H1 - j*ext over the lane's columns
#pragma unroll
      for (int c = 0; c < NPL; ++c) {
        const int sub = rc[c] == qi ? match : mismatch;
        h1[c] = __viaddmax_s32_relu(hd, sub, F[c]);
        hd = H[c];
        sv = __viaddmax_s32(h1[c], -(j0 + c) * ge, sv);
      }
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const int pv = __shfl_up_sync(kFull, sv, d, G);
        if (lg >= d) sv = max(sv, pv);
      }
      int ev = __shfl_up_sync(kFull, sv, 1, G);
      if (lg == 0) ev = kNeg;
#pragma unroll
      for (int c = 0; c < NPL; ++c) {
        const int h = __viaddmax_s32(ev, go + (j0 + c) * ge, h1[c]);
        ev = __viaddmax_s32(h1[c], -(j0 + c) * ge, ev);
        F[c] = __viaddmax_s32(F[c], ge, h + goe);
        H[c] = h;
      }
      best = row_best<NPL, kGuard>(H, best, nvalid);
    }
  }
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, d, G));
  if (lg == 0 && live) out[b] = best;
}
#endif  // LHT_SW_SCAN

template <int G, int NPL, bool kGuard>
int launch_score(const uint8_t* q, const uint8_t* r, int32_t* out,
                 long long B, int M, int N, int match, int mismatch, int go,
                 int ge, cudaStream_t s) {
  constexpr int kPerBlock = kScoreWarps * (32 / G);
  const long long blocks = (B + kPerBlock - 1) / kPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
#if LHT_SW_SCAN
  sw_score_scan_kernel<G, NPL, kGuard>
      <<<(unsigned)blocks, 32 * kScoreWarps, 0, s>>>(q, r, out, B, M, N,
                                                     match, mismatch, go, ge);
#else
  sw_score_kernel<G, NPL, false, kGuard>
      <<<(unsigned)blocks, 32 * kScoreWarps, 0, s>>>(
          q, r, out, B, M, N, match, mismatch, go, ge);
#endif
  return (int)cudaGetLastError();
}

template <bool kGuard>
int launch_score_wide(const uint8_t* q, const uint8_t* r, int32_t* out,
                      long long B, int M, int N, int match, int mismatch,
                      int go, int ge, cudaStream_t s) {
  constexpr int kStripe = 32 * kScoreWideNPL;
  const int warps = (N + kStripe - 1) / kStripe;
  if (warps > kWideMaxWarps || B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t ring = (size_t)(warps - 1) * kEdgeRows * sizeof(int2);
  sw_score_kernel<32, kScoreWideNPL, true, kGuard>
      <<<(unsigned)B, 32 * warps, ring, s>>>(q, r, out, B, M, N, match,
                                             mismatch, go, ge);
  return (int)cudaGetLastError();
}

// (lanes a group, columns a lane) for N <= 512, narrowest first: the first
// pair with G * NPL >= N runs. Every window accbkp makes from 150-bp reads
// (32, 64, 96, 128, 160) fits its pair exactly, as do 192, 256, 320, 384
// and 512. Groups of 8 lanes, four alignments a warp, were the fastest at
// 96, 128 and 160 on an H100 (tune_sw: 7 steps of fill, and the step's
// shuffles and loop shared by 12 to 20 cells); wider windows take more
// lanes so that a lane's H, F and table words stay in registers.
#if defined(LHT_SW_G) && defined(LHT_SW_NPL)
#define LHT_SCORE_PAIRS(X) X(LHT_SW_G, LHT_SW_NPL)
#else
#define LHT_SCORE_PAIRS(X)                                              \
  X(8, 4) X(8, 8) X(8, 12) X(8, 16) X(8, 20) X(16, 12) X(16, 16)        \
  X(32, 10) X(32, 12) X(32, 16)
#endif
}  // namespace

extern "C" int lht_sw_align(const uint8_t* q, const uint8_t* r, int32_t* out,
                            long long B, int M, int N, int match,
                            int mismatch, int go, int ge, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (N > kNarrowMaxN) {
    if (N > kWideMaxN || B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int warps = (N + 32 * kWideNPL - 1) / (32 * kWideNPL);
    sw_align_wide_kernel<<<(unsigned)B, 32 * warps, 0, s>>>(
        q, r, out, M, N, match, mismatch, go, ge);
    return (int)cudaGetLastError();
  }
  const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 grid((unsigned)blocks), block(32 * kWarpsPerBlock);
#define LHT_ALIGN_CASE(NPL)                                                  \
  case NPL:                                                                  \
    sw_align_kernel<NPL><<<grid, block, 0, s>>>(q, r, out, B, M, N, match,   \
                                                mismatch, go, ge);           \
    break;
  switch (columns_per_lane(N)) {
    LHT_ALIGN_CASE(1)
    LHT_ALIGN_CASE(2)
    LHT_ALIGN_CASE(4)
    LHT_ALIGN_CASE(8)
    LHT_ALIGN_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LHT_ALIGN_CASE
  return (int)cudaGetLastError();
}

extern "C" int lht_sw_score(const uint8_t* q, const uint8_t* r, int32_t* out,
                            long long B, int M, int N, int match,
                            int mismatch, int go, int ge, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  // A column past N holds a code that never matches. Where a mismatch and
  // both gap steps cost something (or nothing), its H is at most the H of
  // a cell above or left of it, so it cannot raise the maximum and no cell
  // is masked. Other parameters take the guarded kernels, which leave
  // those columns out of the maximum.
  const bool decays = mismatch <= 0 && ge <= 0 && go + ge <= 0;
#if LHT_SW_TABLE
  // the table holds a score in a byte
  const bool plain = decays && match >= -128 && match <= 127 &&
                     mismatch >= -128;
#else
  const bool plain = decays;
#endif
  if (N > kNarrowMaxN) {
    if (N > kWideMaxN) return (int)cudaErrorInvalidValue;
    return plain ? launch_score_wide<false>(q, r, out, B, M, N, match,
                                             mismatch, go, ge, s)
                  : launch_score_wide<true>(q, r, out, B, M, N, match,
                                            mismatch, go, ge, s);
  }
  if (!plain)
    return launch_score<32, 16, true>(q, r, out, B, M, N, match, mismatch,
                                      go, ge, s);
#define LHT_SCORE_CASE(G, NPL)                                              \
  if (N <= G * NPL)                                                         \
    return launch_score<G, NPL, false>(q, r, out, B, M, N, match, mismatch, \
                                       go, ge, s);
  LHT_SCORE_PAIRS(LHT_SCORE_CASE)
#undef LHT_SCORE_CASE
  return (int)cudaErrorInvalidValue;
}
