// Batched affine-gap Smith-Waterman for Hopper (sm_90a): kernels K1 and K2.
//
// K1 `lht_sw_align` replaces localhgt_tpu/ops/pallas_sw.py::sw_align_pallas
// (kernel _sw_align_kernel): score plus query and reference spans through
// an origin register, no traceback. K2 `lht_sw_score` replaces
// pallas_sw.py::sw_score_pallas (kernel _sw_score_kernel): score only.
//
// Recurrence (identical to the Pallas body, row i over columns j):
//   H1 = max(max(Hdiag + sub, 0), F)      F = Mf + open + i*ext
//   E  = prefmax_{j'<j}(H1 - j'*ext) + open + j*ext
//   H  = max(H1, E);  Mf = max(Mf, H - i*ext)
//
// Mapping: one warp per alignment. Lane l holds the NPL contiguous columns
// [l*NPL, (l+1)*NPL) in registers; the loop runs over the M query rows.
// The diagonal neighbour of a lane's first column comes from lane l-1 by
// __shfl_up_sync, and E's prefix max is a scan inside the lane followed by
// a warp scan of the lane totals. Nothing of the M x N matrix touches
// device memory: the kernel reads M + N bytes and writes 20 (K1) or 4 (K2)
// bytes per alignment, so it is bound by integer instructions and shuffle
// latency, not by memory (about 10 ops per cell at 192 x 256).
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
// Each entry point launches on the given stream and returns
// cudaGetLastError(); it never synchronises or allocates.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <int NPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sw_score_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ r,
                int32_t* __restrict__ out, long long B, int M, int N,
                int match, int mismatch, int go, int ge) {
  const int lane = threadIdx.x & 31;
  const long long b =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;
  const uint8_t* qb = q + b * M;
  const uint8_t* rb = r + b * N;
  const int j0 = lane * NPL;

  int rc[NPL], H[NPL], Mf[NPL];
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const int j = j0 + c;
    rc[c] = j < N ? (int)rb[j] : 4;
    H[c] = 0;
    Mf[c] = kNeg;
  }
  int best = 0;

  for (int i = 0; i < M; ++i) {
    const int qi = qb[i];
    int hl = __shfl_up_sync(kFull, H[NPL - 1], 1);
    if (lane == 0) hl = 0;
    const int fadd = go + i * ge;
    int H1[NPL];
    int sv = kNeg;
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int hd = c == 0 ? hl : H[c - 1];
      const int sub =
          (rc[c] == qi && rc[c] < 4 && qi < 4) ? match : mismatch;
      int h0 = hd + sub;
      if (h0 < 0) h0 = 0;
      const int f = Mf[c] + fadd;
      H1[c] = f > h0 ? f : h0;
      const int t = H1[c] - (j0 + c) * ge;
      if (t > sv) sv = t;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int pv = __shfl_up_sync(kFull, sv, d);
      if (lane >= d && pv > sv) sv = pv;
    }
    int ev = __shfl_up_sync(kFull, sv, 1);
    if (lane == 0) ev = kNeg;
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int j = j0 + c;
      const int e = ev + go + j * ge;
      const int h = e > H1[c] ? e : H1[c];
      const int t = H1[c] - j * ge;
      if (t > ev) ev = t;
      const int mv = h - i * ge;
      if (mv > Mf[c]) Mf[c] = mv;
      if (j < N && h > best) best = h;
      H[c] = h;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int o = __shfl_xor_sync(kFull, best, d);
    if (o > best) best = o;
  }
  if (lane == 0) out[b] = best;
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

// Wide variant: one block of ceil(N / 256) warps per alignment. kAlign
// selects K1's five fields; otherwise K2's score. The recurrence and the
// tie rules are those of sw_align_kernel, term for term.
template <bool kAlign>
__global__ void __launch_bounds__(32 * kWideMaxWarps)
sw_wide_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ r,
               int32_t* __restrict__ out, int M, int N, int match,
               int mismatch, int go, int ge) {
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
  if (!kAlign) {
    out[b] = bH;
    return;
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

}  // namespace

#define LHT_SW_DISPATCH(KERNEL, ALIGN)                                      \
  do {                                                                      \
    if (B <= 0) return (int)cudaGetLastError();                             \
    cudaStream_t s = (cudaStream_t)stream;                                  \
    if (N > kNarrowMaxN) {                                                  \
      if (N > kWideMaxN || B > 0x7fffffffLL)                                \
        return (int)cudaErrorInvalidValue;                                  \
      const int warps = (N + 32 * kWideNPL - 1) / (32 * kWideNPL);          \
      sw_wide_kernel<ALIGN><<<(unsigned)B, 32 * warps, 0, s>>>(             \
          q, r, out, M, N, match, mismatch, go, ge);                        \
      return (int)cudaGetLastError();                                       \
    }                                                                       \
    const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;     \
    const dim3 grid((unsigned)blocks), block(32 * kWarpsPerBlock);          \
    switch (columns_per_lane(N)) {                                          \
      case 1:                                                               \
        KERNEL<1><<<grid, block, 0, s>>>(q, r, out, B, M, N, match,         \
                                         mismatch, go, ge);                 \
        break;                                                              \
      case 2:                                                               \
        KERNEL<2><<<grid, block, 0, s>>>(q, r, out, B, M, N, match,         \
                                         mismatch, go, ge);                 \
        break;                                                              \
      case 4:                                                               \
        KERNEL<4><<<grid, block, 0, s>>>(q, r, out, B, M, N, match,         \
                                         mismatch, go, ge);                 \
        break;                                                              \
      case 8:                                                               \
        KERNEL<8><<<grid, block, 0, s>>>(q, r, out, B, M, N, match,         \
                                         mismatch, go, ge);                 \
        break;                                                              \
      case 16:                                                              \
        KERNEL<16><<<grid, block, 0, s>>>(q, r, out, B, M, N, match,        \
                                          mismatch, go, ge);                \
        break;                                                              \
      default:                                                              \
        return (int)cudaErrorInvalidValue;                                  \
    }                                                                       \
    return (int)cudaGetLastError();                                         \
  } while (0)

extern "C" int lht_sw_align(const uint8_t* q, const uint8_t* r, int32_t* out,
                            long long B, int M, int N, int match,
                            int mismatch, int go, int ge, void* stream) {
  LHT_SW_DISPATCH(sw_align_kernel, true);
}

extern "C" int lht_sw_score(const uint8_t* q, const uint8_t* r, int32_t* out,
                            long long B, int M, int N, int match,
                            int mismatch, int go, int ge, void* stream) {
  LHT_SW_DISPATCH(sw_score_kernel, false);
}
