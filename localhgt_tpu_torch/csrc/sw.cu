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
// ---- The recurrence ----
// The Pallas bodies compute row i over the columns j in a prefix-max form:
//   H1 = max(max(Hdiag + sub, 0), F)      F = Mf + open + i*ext
//   E  = prefmax_{j'<j}(H1 - j'*ext) + open + j*ext
//   H  = max(H1, E);  Mf = max(Mf, H - i*ext)
// Both kernels compute the same numbers cell by cell in the Gotoh form,
// which needs no i*ext or j*ext term (equal in integers: F below is
// Mf + open + i*ext, and E is the prefix maximum written as a recurrence):
//   H1[i][j] = max(H[i-1][j-1] + sub(q[i], r[j]), 0, F[i][j])
//   H [i][j] = max(H1[i][j], E[i][j])
//   E [i][j+1] = max(E[i][j] + ext, H1[i][j] + open + ext)  E[i][0] = NEG+open
//   F [i+1][j] = max(F[i][j] + ext, H [i][j] + open + ext)  F[0][j] = NEG+open
//   score = max(0, max H)
// sub is `match` where both codes are equal and below 4, else `mismatch`.
//
// K1 also carries, beside H, F and E, the origin of each: the packed index
// i*(N+1) + j of the cell that started the alignment. A cell's own index
// is a base computed once a row plus a constant a column. The Pallas tie
// rules, which decide the start coordinates (ROADMAP F1), become one order
// of the operands of each maximum:
//   * H1: the diagonal (its origin O[i-1][j-1] where H[i-1][j-1] > 0, else
//     the cell's own index) wins a tie against F;
//   * H: H1 wins a tie against E;
//   * E: the newly opened gap wins a tie against the extended one (the
//     prefix maximum takes the LATEST j' among tied maxima: the Pallas
//     log-step shift-max keeps the current value on ties);
//   * F: the extended gap wins a tie (Mf keeps the older value on ties);
//   * the best cell: max H, then the earliest row, then the smallest
//     column; a lane meets its cells in row-major order, so it keeps a
//     cell only when strictly greater, and the lanes' bests are reduced
//     lexicographically at the end (the packed index orders rows, then
//     columns).
// Each maximum with its winner is one `__vibmax_s32` (max and a predicate,
// a wins when a >= b) and one select for the origin.
//
// ---- Mapping: an anti-diagonal wavefront (both kernels) ----
// A group of G lanes holds one alignment, lane l the NPL columns
// [l*NPL, (l+1)*NPL) in registers (K2: H, F and the column's substitution
// table; K1 also O and F's origin). At step t lane l works on query row
// t - l, so it needs from lane l-1 only what that lane left behind one
// step earlier: its last H (the diagonal of the next row) and the E that
// runs out of its last column, and for K1 their origins. Two (K2) or four
// (K1) independent shuffles a step, no scan, and G - 1 steps of fill and
// drain; the steps in which every lane has a row run without the lane's
// own test. (G, NPL) is chosen so that G * NPL covers the window: NPL is
// any integer, and groups of 8 or 16 lanes put four or two alignments into
// a warp (LHT_SCORE_PAIRS and LHT_ALIGN_PAIRS list the pairs with the N
// each serves; K1 takes only 32-lane groups).
//
// The substitution score is one byte permute: the column holds its score
// against each of the four query codes in the bytes of one word, and the
// query is staged, 32 rows at a time into a ring in shared memory, as the
// selector that picks its byte.
// K2's cell is 7.5 instructions: the permute, `__viaddmax_s32_relu` for H1,
// a max for H, an add and a `__viaddmax_s32` each for E and F, and half a
// `__vimax3_s32` for the maximum. 5.5 of them are permutes and maxima,
// which only the SM's 64-lane integer pipe runs.
// K1's cell is 20 on that pipe: `__vibmax_s32` has no one instruction
// on sm_90a and compiles to a compare and a select, so a maximum with its
// winner is a compare and two selects. The permute, `__viaddmax_s32` for
// max(diag + sub, 0), a compare and a select for the diagonal's origin,
// three each for H1, H, E and F, and for the best a compare and three
// selects (its H, index and origin); and five adds (the gap steps and the
// cell's index).
// Columns past N are not masked out of the maximum: with mismatch <= 0,
// ext <= 0 and open + ext <= 0 their H cannot exceed that of a real cell
// that comes earlier in row-major order, so they cannot win K1's best
// either. Other parameters, and scores that do not fit a byte of the
// table, take a guarded instantiation with a compare and a select for sub
// that leaves those columns out of the maximum (table_fits).
//
// Wide references (512 < N <= 4096): one block per alignment, as many
// alignments as there are on an SM being too few warps otherwise. The same
// kernel body, G = 32: warp w holds the stripe of 32*NPL columns after
// warp w-1's and runs the same wavefront some rows behind it. The edge
// between two stripes (the left warp's last H and outgoing E of every row,
// with their origins for K1) goes through a ring of 256 rows in shared
// memory. A warp publishes the number of steps it has finished after every
// 8 (K1) or 16 (K2); its right neighbour waits for the rows of its next 8
// or 16 steps, and it waits for its right neighbour before it overwrites
// rows of the ring. No block barrier in the loop, and no warp waits for one
// to its right except where the ring is full. The stripes run 40 or 48
// steps apart (32 for the lanes of a warp, and the span). The bests are
// reduced over the block once, at the end.
//
// Wider references (N > 4096): bands that run together, one block a band,
// the bands of one alignment in one thread-block cluster. nb =
// ceil(N / 4096) bands, balanced: each ceil(N / nb) columns rounded up to
// whole stripes (N = 4,097 is two bands of 2,560 and 1,537 columns, not
// 4,096 + 1), the block as many warps as a band has stripes (32 x 16
// columns a warp in both kernels: K2's band block takes 16 columns a lane
// where its wide block takes 8, half the stripes to lag behind each
// other), the cluster min(nb, 8) blocks (8 is the portable cluster size).
// The edge between two bands (the int4 or int2 that the ring
// between two warps carries) goes from the last warp of block r into a
// ring of kBandRows rows in block r+1's shared memory (distributed shared
// memory), and its first warp reads it in place of column 0's boundary:
// the same protocol as the ring between two warps, its counts at cluster
// scope. The left block publishes the rows it has written in the right
// block's shared memory (a release store); the right block publishes the
// rows it has read in the left block's (also a release); each waits with
// acquire loads. No block barrier between bands: the bands run some rows
// apart, as the stripes of one block do. One cluster.sync() at the start,
// before any block touches another's shared memory, one before exit.
// Past the cluster's reach (more than 8 bands) the blocks take bands
// round-robin: block r the bands r, r+8, r+16, ..., one after another
// with a block barrier between two of its own. The counts of a ring run
// on over those rounds (round k's row i is row k*M + i of one stream), so
// a block may start its next band while its right neighbour still reads
// the band before. The edge from the cluster's last block to its first
// goes through device memory (`wrap`, M rows an alignment, which the
// caller allocates): the first block reads that edge only after its whole
// band before, so a ring would have to hold all M rows of it, and 16*M
// bytes (K1) outgrow shared memory at M > 14,000. One wrap buffer serves
// every round: band 16's row i is written after band 8 has computed row
// i, which is after band 8 read row i of band 7's edge.
// A lane keeps its best cell of a band with the strict row-major rule and
// folds it into the best of its bands before lexicographically; each
// block folds its warps' bests and puts the result into block 0's shared
// memory, and block 0 folds the blocks' bests and writes the alignment's
// result. The order (max H, then the smallest packed index) is a total
// order, so the tie rules above hold across bands.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(), the band entry points also the error of a cluster
// launch that the card refuses; none synchronises or allocates.
//
// Tuning switches, set only by `python -m localhgt_tpu_torch.tune_sw`; the
// package's own build defines none of them:
//   LHT_SW_G, LHT_SW_NPL   K2: one (lanes a group, columns a lane) pair for
//                          every N <= G * NPL instead of LHT_SCORE_PAIRS;
//   LHT_SWA_G, LHT_SWA_NPL the same for K1 instead of LHT_ALIGN_PAIRS;
//   LHT_SW_SCAN            K2 row by row (sw_score_scan_kernel);
//   LHT_SW_TABLE           0: the substitution score as a compare and a
//                          select; 1: as one byte permute out of a table
//                          word a column (both kernels);
//   LHT_SW_WIDE_NPL        columns a lane of K2's wide mapping.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef LHT_SW_SCAN
#define LHT_SW_SCAN 0
#endif
#ifndef LHT_SW_TABLE
#define LHT_SW_TABLE 1
#endif
#ifndef LHT_SW_WIDE_NPL
#define LHT_SW_WIDE_NPL 8
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kNeg = -(1 << 28);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNarrowMaxN = 16 * 32;  // the widest one-warp dispatch
constexpr int kWideMaxWarps = 16;
constexpr int kWideMaxN = 4096;  // the widest block; wider N runs in bands
constexpr int kClusterMax = 8;   // blocks a cluster: the portable size
constexpr int kBandRows = 256;   // rows of the edge ring between two bands
// 16 columns a lane in K1's wide mapping: fewer stripes, less lag between
// them and a step's shuffles shared by more cells than 8 or 4 (tune_sw on
// an H100)
constexpr int kAlignWideNPL = 16;
constexpr int kScoreWarps = 4;  // warps a block, N <= 512 (both kernels)
// query rows staged at a time; a power of two
constexpr int kChunk = 32;
constexpr int kEdgeRows = 256;  // rows of a stripe's edge in the ring
// steps between two waits and progress counts of a stripe of a wide or
// band block (a divisor of kChunk): its stripes lag 32 + the span behind
// each other, where once a chunk lets them lag 64. Measured with tune_sw
// on an H100: at B=64, M=800, N=8,192 (with build switches since removed)
// K1 1.1751 ms at 8 against 1.2128 at 16 and 1.2200 at 4, K2 0.5135 at 16
// against 0.5294 at 8 and 0.5993 at 4; at B=512, M=N=1,000 K1 0.8315
// against 0.8504 at 32, K2 0.3117 against 0.3170 at 32.
constexpr int kAlignSync = 8;
constexpr int kScoreSync = 16;
static_assert(kChunk % kAlignSync == 0 && kChunk % kScoreSync == 0,
              "a chunk is whole sync spans");
// 16 columns a lane in K2's band kernel, where its wide block takes 8:
// half the stripes, so half the lag between the first and the last (the
// same measurement: 0.5135 ms against 0.6595 at 8 and 0.5872 at 12)
constexpr int kScoreBandNPL = 16;
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

// The substitution score of column entry `rc` against query entry `qi`.
template <bool kTable>
__device__ __forceinline__ int substitution(int rc, int qi, int match,
                                            int mismatch) {
  if (!kTable) return rc == qi ? match : mismatch;
  int sub;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(sub) : "r"(rc), "r"(mismatch),
      "r"(qi));
  return sub;
}

// Whether the byte-permute table and the unmasked maximum serve these
// parameters (see the header); the others take the guarded kernels.
bool table_fits(int match, int mismatch, int go, int ge) {
  const bool decays = mismatch <= 0 && ge <= 0 && go + ge <= 0;
#if LHT_SW_TABLE
  return decays && match >= -128 && match <= 127 && mismatch >= -128;
#else
  return decays;
#endif
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

// The wide mapping's progress protocol around the steps [t0, tend) of a
// stripe: wait until the left stripe has written the ring rows these steps
// read, and until the right stripe has read the rows they overwrite.
__device__ __forceinline__ void wait_for_neighbours(const int* progress,
                                                    int warp, int nwarps,
                                                    int tend, int T) {
  // the left stripe's last lane is 31 steps behind its first: rows up to
  // tend-1 are in the ring once that warp finished tend+31 steps
  if (warp > 0) {
    const int need = min(tend + 31, T);
    while (*(volatile const int*)&progress[warp - 1] < need) __nanosleep(20);
  }
  // these steps write rows up to tend-32: the right stripe must have read
  // the rows kEdgeRows before them
  if (warp + 1 < nwarps) {
    const int need = tend - 31 - kEdgeRows;
    while (*(volatile const int*)&progress[warp + 1] < need) __nanosleep(20);
  }
  __threadfence_block();
}

__device__ __forceinline__ void publish_progress(int* progress, int warp,
                                                 int lane, int tend) {
  __syncwarp();
  if (lane == 31) {
    __threadfence_block();
    *(volatile int*)&progress[warp] = tend;
  }
}

// The counts between two bands' blocks: a count in this block's or a
// neighbour's shared memory (a generic address from map_shared_rank),
// written with release and read with acquire semantics at cluster scope.
__device__ __forceinline__ void store_release_cluster(int* p, int v) {
  asm volatile("st.release.cluster.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void wait_at_least(const int* p, int need) {
  for (;;) {
    int v;
    asm volatile("ld.acquire.cluster.s32 %0, [%1];"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
    if (v >= need) return;
    __nanosleep(20);
  }
}

// The balanced bands of a reference wider than the block (see the
// header): warps a block and the number of bands. The kernel computes the
// same number of bands from its block's width.
void band_shape(int N, int stripe, int* warps, int* nbands) {
  const int nb = (N + kWideMaxN - 1) / kWideMaxN;
  const int per = (N + nb - 1) / nb;
  *warps = (per + stripe - 1) / stripe;
  *nbands = (N + *warps * stripe - 1) / (*warps * stripe);
}

// One launch of a band kernel: `nblocks` blocks an alignment in a cluster
// of that size. Returns the error of a launch the card refuses, or
// cudaErrorLaunchOutOfResources where no cluster of that size fits.
template <typename... Args, typename... Actual>
int launch_cluster(void (*kernel)(Args...), int nblocks, long long B,
                   int threads, size_t smem, cudaStream_t s,
                   Actual... args) {
  if (B * nblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(B * nblocks));
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nblocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &config);
  if (err != cudaSuccess) return (int)err;
  if (clusters == 0) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K1

// One query row against the NPL columns of a lane. hd, od: H and origin of
// the row above at the column left of the lane's first; e, eo: E of this
// row at the lane's first column and its origin, left as the E that runs
// out of the lane's last column; start: the packed index of the first
// column's cell. Leaves the lane's H, O, F and F's origin for the next row
// and keeps the lane's best cell (bH, its index bPos and origin bO).
template <int NPL, bool kTable, bool kGuard>
__device__ __forceinline__ void align_row(
    const int (&rc)[NPL], int (&H)[NPL], int (&O)[NPL], int (&F)[NPL],
    int (&FO)[NPL], int qi, int hd, int od, int& e, int& eo, int start,
    int match, int mismatch, int goe, int ge, int nvalid, int& bH,
    int& bPos, int& bO) {
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const int sub = substitution<kTable>(rc[c], qi, match, mismatch);
    const int h0 = __viaddmax_s32(hd, sub, 0);  // max(hd + sub, 0)
    const int d_o = hd > 0 ? od : start + c;
    bool p;
    const int h1 = __vibmax_s32(h0, F[c], &p);  // the diagonal wins a tie
    const int o1 = p ? d_o : FO[c];
    hd = H[c];
    od = O[c];
    const int h = __vibmax_s32(h1, e, &p);  // H1 wins a tie
    const int o = p ? o1 : eo;
    e = __vibmax_s32(h1 + goe, e + ge, &p);  // the newly opened gap wins
    eo = p ? o1 : eo;
    F[c] = __vibmax_s32(F[c] + ge, h + goe, &p);  // the extended gap wins
    FO[c] = p ? FO[c] : o;
    H[c] = h;
    O[c] = o;
    if (!kGuard || c < nvalid) {
      bH = __vibmax_s32(bH, h, &p);  // strictly greater: earliest cell
      bPos = p ? bPos : start + c;
      bO = p ? bO : o;
    }
  }
}

// Takes the other lane's best where it is greater, or equal at an earlier
// packed index (an earlier row, then a smaller column).
__device__ __forceinline__ void take_better(int& bH, int& bPos, int& bO,
                                            int oh, int opos, int oo) {
  if (oh > bH || (oh == bH && opos < bPos)) {
    bH = oh;
    bPos = opos;
    bO = oo;
  }
}

__device__ __forceinline__ void write_align(int32_t* ob, int bH, int bPos,
                                            int bO, int np1) {
  if (bH <= 0) {
    ob[0] = ob[1] = ob[2] = ob[3] = ob[4] = 0;
    return;
  }
  const int qs = bO / np1, qe = bPos / np1;
  ob[0] = bH;
  ob[1] = qs;
  ob[2] = qe;
  ob[3] = bO - qs * np1;
  ob[4] = bPos - qe * np1;
}

// K1, anti-diagonal wavefront with origins. A group of G lanes holds one
// alignment, lane l the NPL columns [l*NPL, (l+1)*NPL); at step t lane l
// works on query row t - l and takes from the lane to its left what that
// lane left one step earlier (last H and O, outgoing E and its origin).
// kWide: one block per alignment, G = 32, warp w the stripe of 32*NPL
// columns after warp w-1's; the edge between two stripes goes through a
// ring in shared memory (see the header). kBands: one block a band, the
// bands of an alignment in one cluster, the edge between two bands
// through a ring in the right block's shared memory, and from the
// cluster's last block to its first through `wrap` (M int4 an alignment;
// see the header). kGuard: the best skips the columns past N, and the
// substitution score is a compare and a select.
template <int G, int NPL, bool kWide, bool kGuard, bool kBands = false>
__global__ void __launch_bounds__(kWide ? kWideMaxN / NPL : 32 * kScoreWarps)
sw_align_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ r,
                int32_t* __restrict__ out, long long B, int M, int N,
                int match, int mismatch, int go, int ge, int4* wrap) {
  static_assert(!kWide || G == 32, "a stripe is a whole warp");
  static_assert(!kBands || kWide, "a band is a wide block");
  static_assert(G <= kChunk, "the query ring holds the rows of two chunks, "
                             "and a group's lanes are spread over G");
  constexpr int kGroups = 32 / G;
  // wide: as many warps as stripes of 32 * NPL columns cover kWideMaxN
  constexpr int kWarps = kWide ? kWideMaxN / (32 * NPL) : kScoreWarps;
  constexpr int kStripe = 32 * NPL;
  constexpr bool kTable = LHT_SW_TABLE && !kGuard;
  // steps between two progress counts of a stripe (see kAlignSync); the
  // narrow mapping has no neighbour to wait for and runs a chunk at once
  constexpr int kSync = kWide ? kAlignSync : kChunk;
  __shared__ uint16_t sQuery[kWarps][kGroups][2 * kChunk];
  __shared__ int sProgress[kWarps];  // wide: steps each warp has finished
  __shared__ int sBest[3][kWarps];   // wide: each warp's best H, index, origin
  extern __shared__ int4 sRing[];    // wide: [warps - 1][kEdgeRows]
  // kBands: the left edge from the wrap, a chunk of it; the ring the left
  // block writes; the rows written into it and the rows the right block
  // has read of this block's edge, both counted over every round; block
  // 0: each block's best
  __shared__ int4 sIn[kBands ? kChunk : 1];
  __shared__ int4 sBandIn[kBands ? kBandRows : 1];
  __shared__ int sLink[2];
  __shared__ int sBlockBest[3][kBands ? kClusterMax : 1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lg = lane & (G - 1);
  // kBands: the block's rank in its cluster and the cluster's size
  int rank = 0, nblocks = 1;
  long long b;
  if (kBands) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = (int)cluster.block_rank();
    nblocks = (int)cluster.num_blocks();
    b = blockIdx.x / nblocks;
  } else if (kWide) {
    b = blockIdx.x;
  } else {
    b = ((long long)blockIdx.x * kScoreWarps + warp) * kGroups;
    if (b >= B) return;  // uniform across the warp
    b += lane / G;
  }
  // a group past B repeats the last alignment and writes nothing, so that
  // every shuffle below has the whole warp
  const bool live = b < B;
  if (!live) b = B - 1;
  const uint8_t* qb = q + b * M;
  const uint8_t* rb = r + b * N;
  uint16_t* myq = sQuery[warp][lane / G];
  const int np1 = N + 1;
  const int goe = go + ge;
  int bH = 0, bPos = 0, bO = 0;  // this lane's best cell (of the band)
  int aH = 0, aPos = 0, aO = 0;  // kBands: its best of the bands before
  const int band_w = (blockDim.x >> 5) * kStripe;  // kBands: columns a band
  const int nbands = kBands ? (N + band_w - 1) / band_w : 1;
  // kBands: the right block's ring and count of rows written, the left
  // block's count of rows read (the cluster's last block writes the wrap,
  // and its first reads it)
  int4* out_ring = nullptr;
  int* out_written = nullptr;
  int* in_read = nullptr;
  if (kBands) {
    cg::cluster_group cluster = cg::this_cluster();
    const int right = rank + 1 < nblocks ? rank + 1 : 0;
    out_ring = cluster.map_shared_rank(&sBandIn[0], right);
    out_written = cluster.map_shared_rank(&sLink[0], right);
    in_read = cluster.map_shared_rank(&sLink[1], rank > 0 ? rank - 1 : 0);
    if (threadIdx.x == 0) sLink[0] = sLink[1] = 0;
    cluster.sync();  // before any block touches another's shared memory
  }
  int4* wb = kBands ? wrap + b * M : nullptr;

  for (int band = rank; band < nbands; band += nblocks) {
    const int col0 = band * band_w;  // 0 unless kBands
    // the warps that hold columns of this band: all but in a last band
    // that is narrower
    const int nwarps = kBands ? min((int)(blockDim.x >> 5),
                                    (N - col0 + kStripe - 1) / kStripe)
                              : blockDim.x >> 5;
    if (kWide) {
      if (kBands && band != rank) __syncthreads();  // its band before is done
      if (lane == 0) sProgress[warp] = 0;
      __syncthreads();
    }
    if (kBands && warp >= nwarps) continue;
    const int j0 = kWide ? col0 + (warp * 32 + lane) * NPL : lg * NPL;
    // kBands: the first warp takes its left edge from the ring (or the
    // cluster's first block from the wrap), and the last warp of a band
    // that has another after it writes its right edge there. Rows count
    // on over the rounds: this round's edge in is row `in0` on of its
    // stream, its edge out row `out0` on.
    const int round = band / nblocks;
    const bool has_left = kBands && band > 0 && warp == 0;
    const bool has_right = kBands && band + 1 < nbands && warp == nwarps - 1;
    const bool ring_in = has_left && rank > 0;
    const bool wrap_in = has_left && rank == 0;
    const bool ring_out = has_right && rank + 1 < nblocks;
    const bool wrap_out = has_right && rank + 1 == nblocks;
    const int in0 = (rank > 0 ? round : round - 1) * M;
    const int out0 = round * M;

    int rc[NPL], H[NPL], O[NPL], F[NPL], FO[NPL];
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int j = j0 + c;
      rc[c] = column_entry<kTable>(j < N ? (int)rb[j] : 4, match, mismatch);
      H[c] = 0;
      O[c] = 0;
      F[c] = kNeg + go;
      FO[c] = 0;
    }
    const int nvalid = N - j0;
    // what the lane to the right takes next step
    int hlast = 0, olast = 0, eout = 0, eoout = 0;
    // H and origin of the row above, left of the first column
    int hprev = 0, oprev = 0;

    // One step. kAll: every lane of the warp has a row (G-1 <= t < M), so
    // the lane's own test and the branch around the row are left out.
    auto step = [&](int t, auto all) {
      constexpr bool kAll = decltype(all)::value;
      const int i = t - lg;
      const bool active = kAll || (unsigned)i < (unsigned)M;
      int hleft = __shfl_up_sync(kFull, hlast, 1, G);
      int oleft = __shfl_up_sync(kFull, olast, 1, G);
      int e = __shfl_up_sync(kFull, eout, 1, G);
      int eo = __shfl_up_sync(kFull, eoout, 1, G);
      if (lg == 0) {
        hleft = 0;
        oleft = 0;
        e = kNeg + go;  // column 0 has no column to its left
        eo = 0;
        if (kWide) {
          if (warp > 0 && active) {
            const int4 v =
                sRing[(warp - 1) * kEdgeRows + (i & (kEdgeRows - 1))];
            hleft = v.x;
            oleft = v.y;
            e = v.z;
            eo = v.w;
          } else if ((ring_in || wrap_in) && active) {
            const int4 v = ring_in ? sBandIn[(in0 + i) & (kBandRows - 1)]
                                   : sIn[i & (kChunk - 1)];
            hleft = v.x;
            oleft = v.y;
            e = v.z;
            eo = v.w;
          }
        }
      }
      if (active) {
        const int qi = myq[i & (2 * kChunk - 1)];
        align_row<NPL, kTable, kGuard>(rc, H, O, F, FO, qi, hprev, oprev, e,
                                       eo, i * np1 + j0, match, mismatch,
                                       goe, ge, nvalid, bH, bPos, bO);
        hlast = H[NPL - 1];
        olast = O[NPL - 1];
        eout = e;
        eoout = eo;
        if (kWide && lane == 31) {
          const int4 v = make_int4(hlast, olast, eout, eoout);
          if (warp + 1 < nwarps)
            sRing[warp * kEdgeRows + (i & (kEdgeRows - 1))] = v;
          else if (ring_out)
            out_ring[(out0 + i) & (kBandRows - 1)] = v;
          else if (wrap_out)
            __stcg(wb + i, v);
        }
      }
      // the left lane's row i is this lane's row above next step
      hprev = hleft;
      oprev = oleft;
    };

    const int T = M + G - 1;
    // The steps [ts, te) between two progress counts: wait until the
    // neighbours (wide: the stripes either side; kBands: also the blocks
    // either side) let them run, run them, publish.
    auto span = [&](int ts, int te) {
      if (kWide) wait_for_neighbours(sProgress, warp, nwarps, te, T);
      // the rows of the left edge these steps read are written; the right
      // block has read the rows of the ring they overwrite
      if (ring_in) wait_at_least(&sLink[0], in0 + min(te, M));
      if (ring_out) wait_at_least(&sLink[1], out0 + te - 31 - kBandRows);
      __syncwarp();
      int t = ts;
      for (; t < min(te, G - 1); ++t) step(t, std::false_type());
      for (; t < min(te, M); ++t) step(t, std::true_type());
      for (; t < te; ++t) step(t, std::false_type());
      if (kWide) publish_progress(sProgress, warp, lane, te);
      // the left block may overwrite the rows read; the right block may
      // read the rows written (lane 0 read them, lane 31 wrote them)
      if (ring_in && lane == 0)
        store_release_cluster(in_read, in0 + min(te, M));
      if ((ring_out || wrap_out) && lane == 31)
        store_release_cluster(out_written, out0 + min(max(te - 31, 0), M));
    };
    for (int t0 = 0; t0 < T; t0 += kChunk) {
      const int tend = min(t0 + kChunk, T);
      __syncwarp();
      stage_query<G, kTable>(myq, qb, M, t0, lg);
      // the wrap's rows of this chunk, once they are written
      if (wrap_in) {
        wait_at_least(&sLink[0], in0 + min(tend, M));
        if (t0 + lane < M) sIn[lane] = __ldcg(wb + t0 + lane);
      }
      if constexpr (kSync < kChunk) {
        for (int ts = t0; ts < tend; ts += kSync)
          span(ts, min(ts + kSync, tend));
      } else {
        span(t0, tend);
      }
    }
    if (kBands) {
      take_better(aH, aPos, aO, bH, bPos, bO);
      bH = bPos = bO = 0;
    }
  }
  if (kBands) {
    bH = aH;
    bPos = aPos;
    bO = aO;
  }

#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) {
    const int oh = __shfl_xor_sync(kFull, bH, d, G);
    const int opos = __shfl_xor_sync(kFull, bPos, d, G);
    const int oo = __shfl_xor_sync(kFull, bO, d, G);
    take_better(bH, bPos, bO, oh, opos, oo);
  }
  if (!kWide) {
    if (lg == 0 && live) write_align(out + b * 5, bH, bPos, bO, np1);
    return;
  }
  if (lane == 0) {
    sBest[0][warp] = bH;
    sBest[1][warp] = bPos;
    sBest[2][warp] = bO;
  }
  __syncthreads();
  if (kBands) {
    // every block's best into block 0's shared memory; block 0 folds them
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
        take_better(bH, bPos, bO, sBest[0][w], sBest[1][w], sBest[2][w]);
      int* best0 = cluster.map_shared_rank(&sBlockBest[0][0], 0);
      best0[rank] = bH;
      best0[kClusterMax + rank] = bPos;
      best0[2 * kClusterMax + rank] = bO;
    }
    cluster.sync();  // no block leaves while another may touch its memory
    if (rank != 0 || threadIdx.x != 0) return;
    for (int k = 1; k < nblocks; ++k)
      take_better(bH, bPos, bO, sBlockBest[0][k], sBlockBest[1][k],
                  sBlockBest[2][k]);
    write_align(out + b * 5, bH, bPos, bO, np1);
    return;
  }
  if (threadIdx.x != 0) return;
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    take_better(bH, bPos, bO, sBest[0][w], sBest[1][w], sBest[2][w]);
  write_align(out + b * 5, bH, bPos, bO, np1);
}

template <int G, int NPL, bool kGuard>
int launch_align(const uint8_t* q, const uint8_t* r, int32_t* out,
                 long long B, int M, int N, int match, int mismatch, int go,
                 int ge, cudaStream_t s) {
  constexpr int kPerBlock = kScoreWarps * (32 / G);
  const long long blocks = (B + kPerBlock - 1) / kPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sw_align_kernel<G, NPL, false, kGuard>
      <<<(unsigned)blocks, 32 * kScoreWarps, 0, s>>>(
          q, r, out, B, M, N, match, mismatch, go, ge, nullptr);
  return (int)cudaGetLastError();
}

// K1's wide block: N/512 warps for N <= kWideMaxN.
template <bool kGuard>
int launch_align_wide(const uint8_t* q, const uint8_t* r, int32_t* out,
                      long long B, int M, int N, int match, int mismatch,
                      int go, int ge, cudaStream_t s) {
  constexpr int kStripe = 32 * kAlignWideNPL;
  const int warps = (N + kStripe - 1) / kStripe;
  if (N > kWideMaxN || B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // at most 7 edges of 256 rows (28 KB): within the 48 KB of dynamic
  // shared memory a launch gets without cudaFuncSetAttribute, beside the
  // band kernel's 4 KB ring
  static_assert((kWideMaxN / kStripe - 1) * kEdgeRows * sizeof(int4) +
                        kBandRows * sizeof(int4) <=
                    44 * 1024,
                "K1 wide: the edge rings need more than 44 KB");
  const size_t ring = (size_t)(warps - 1) * kEdgeRows * sizeof(int4);
  sw_align_kernel<32, kAlignWideNPL, true, kGuard>
      <<<(unsigned)B, 32 * warps, ring, s>>>(q, r, out, B, M, N, match,
                                             mismatch, go, ge, nullptr);
  return (int)cudaGetLastError();
}

// K1 past kWideMaxN columns: one block of up to 8 warps a band, the bands
// of an alignment in a cluster (see the header). `wrap` may be null where
// there are at most kClusterMax bands.
template <bool kGuard>
int launch_align_bands(const uint8_t* q, const uint8_t* r, int32_t* out,
                       long long B, int M, int N, int match, int mismatch,
                       int go, int ge, int4* wrap, cudaStream_t s) {
  int warps, nbands;
  band_shape(N, 32 * kAlignWideNPL, &warps, &nbands);
  if (nbands > kClusterMax && wrap == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t ring = (size_t)(warps - 1) * kEdgeRows * sizeof(int4);
  return launch_cluster(sw_align_kernel<32, kAlignWideNPL, true, kGuard, true>,
                        min(nbands, kClusterMax), B, 32 * warps, ring, s, q,
                        r, out, B, M, N, match, mismatch, go, ge, wrap);
}

// (lanes a group, columns a lane) of K1 for N <= 512, narrowest first: the
// first pair with G * NPL >= N runs. K1 holds five registers a column (the
// table word, H, O, F and F's origin) where K2 holds three.
// 32 lanes an alignment: align's batches on the main path are small
// (B = 61 to 242 a launch on `big`, N = 256 for 150-bp reads padded to
// 192 rows and 32 columns either side), and a group of 8 lanes leaves most
// of the card idle there: at B = 152 and N = 256 32 x 8 took 0.054 ms
// where 8 x 32 took 0.144 ms on an H100 (tune_sw).
#if defined(LHT_SWA_G) && defined(LHT_SWA_NPL)
#define LHT_ALIGN_PAIRS(X) X(LHT_SWA_G, LHT_SWA_NPL)
#else
#define LHT_ALIGN_PAIRS(X) \
  X(32, 2) X(32, 4) X(32, 6) X(32, 8) X(32, 12) X(32, 16)
#endif

// ------------------------------------------------------------------ K2

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
    const int sub = substitution<kTable>(rc[c], qi, match, mismatch);
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
// stripes goes through a ring in shared memory (see the header). kBands:
// one block a band, the bands of an alignment in one cluster, joined as
// K1's (M int2 an alignment in `wrap`; see the header).
// kGuard: the maximum skips the columns past N, and the substitution score
// is a compare and a select whatever LHT_SW_TABLE says (see lht_sw_score).
template <int G, int NPL, bool kWide, bool kGuard, bool kBands = false>
__global__ void __launch_bounds__(32 * (kWide ? kWideMaxWarps : kScoreWarps))
sw_score_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ r,
                int32_t* __restrict__ out, long long B, int M, int N,
                int match, int mismatch, int go, int ge, int2* wrap) {
  static_assert(!kWide || G == 32, "a stripe is a whole warp");
  static_assert(!kBands || kWide, "a band is a wide block");
  static_assert(G <= kChunk, "the query ring holds the rows of two chunks, "
                             "and a group's lanes are spread over G");
  constexpr int kGroups = 32 / G;
  constexpr int kWarps = kWide ? kWideMaxWarps : kScoreWarps;
  constexpr int kStripe = 32 * NPL;
  constexpr bool kTable = LHT_SW_TABLE && !kGuard;
  constexpr int kSync = kWide ? kScoreSync : kChunk;
  __shared__ uint16_t sQuery[kWarps][kGroups][2 * kChunk];
  __shared__ int sProgress[kWarps];  // wide: steps each warp has finished
  __shared__ int sBest[kWarps];
  extern __shared__ int2 sEdge[];  // wide: [warps - 1][kEdgeRows] (H, E)
  // kBands: as in K1
  __shared__ int2 sIn[kBands ? kChunk : 1];
  __shared__ int2 sBandIn[kBands ? kBandRows : 1];
  __shared__ int sLink[2];
  __shared__ int sBlockBest[kBands ? kClusterMax : 1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lg = lane & (G - 1);
  int rank = 0, nblocks = 1;  // kBands: rank in the cluster, its size
  long long b;
  if (kBands) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = (int)cluster.block_rank();
    nblocks = (int)cluster.num_blocks();
    b = blockIdx.x / nblocks;
  } else if (kWide) {
    b = blockIdx.x;
  } else {
    b = ((long long)blockIdx.x * kScoreWarps + warp) * kGroups;
    if (b >= B) return;  // uniform across the warp
    b += lane / G;
  }
  // a group past B repeats the last alignment and writes nothing, so that
  // every shuffle below has the whole warp
  const bool live = b < B;
  if (!live) b = B - 1;
  const uint8_t* qb = q + b * M;
  const uint8_t* rb = r + b * N;
  uint16_t* myq = sQuery[warp][lane / G];
  const int goe = go + ge;
  int best = 0;  // over every band: the maximum needs no order
  const int band_w = (blockDim.x >> 5) * kStripe;  // kBands: columns a band
  const int nbands = kBands ? (N + band_w - 1) / band_w : 1;
  int2* out_ring = nullptr;
  int* out_written = nullptr;
  int* in_read = nullptr;
  if (kBands) {
    cg::cluster_group cluster = cg::this_cluster();
    const int right = rank + 1 < nblocks ? rank + 1 : 0;
    out_ring = cluster.map_shared_rank(&sBandIn[0], right);
    out_written = cluster.map_shared_rank(&sLink[0], right);
    in_read = cluster.map_shared_rank(&sLink[1], rank > 0 ? rank - 1 : 0);
    if (threadIdx.x == 0) sLink[0] = sLink[1] = 0;
    cluster.sync();  // before any block touches another's shared memory
  }
  int2* wb = kBands ? wrap + b * M : nullptr;

  for (int band = rank; band < nbands; band += nblocks) {
    const int col0 = band * band_w;  // 0 unless kBands
    // the warps that hold columns of this band: all but in a last band
    // that is narrower
    const int nwarps = kBands ? min((int)(blockDim.x >> 5),
                                    (N - col0 + kStripe - 1) / kStripe)
                              : blockDim.x >> 5;
    if (kWide) {
      if (kBands && band != rank) __syncthreads();  // its band before is done
      if (lane == 0) sProgress[warp] = 0;
      __syncthreads();
    }
    if (kBands && warp >= nwarps) continue;
    const int j0 = kWide ? col0 + (warp * 32 + lane) * NPL : lg * NPL;
    // kBands: the edges between bands, as in K1
    const int round = band / nblocks;
    const bool has_left = kBands && band > 0 && warp == 0;
    const bool has_right = kBands && band + 1 < nbands && warp == nwarps - 1;
    const bool ring_in = has_left && rank > 0;
    const bool wrap_in = has_left && rank == 0;
    const bool ring_out = has_right && rank + 1 < nblocks;
    const bool wrap_out = has_right && rank + 1 == nblocks;
    const int in0 = (rank > 0 ? round : round - 1) * M;
    const int out0 = round * M;

    int rc[NPL], H[NPL], F[NPL];
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const int j = j0 + c;
      rc[c] = column_entry<kTable>(j < N ? (int)rb[j] : 4, match, mismatch);
      H[c] = 0;
      F[c] = kNeg + go;
    }
    const int nvalid = N - j0;
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
            const int2 v =
                sEdge[(warp - 1) * kEdgeRows + (i & (kEdgeRows - 1))];
            hleft = v.x;
            e = v.y;
          } else if ((ring_in || wrap_in) && active) {
            const int2 v = ring_in ? sBandIn[(in0 + i) & (kBandRows - 1)]
                                   : sIn[i & (kChunk - 1)];
            hleft = v.x;
            e = v.y;
          }
        }
      }
      if (active) {
        const int qi = myq[i & (2 * kChunk - 1)];
        eout = score_row<NPL, kTable>(rc, H, F, qi, hprev, e, match,
                                      mismatch, goe, ge);
        best = row_best<NPL, kGuard>(H, best, nvalid);
        hlast = H[NPL - 1];
        if (kWide && lane == 31) {
          const int2 v = make_int2(hlast, eout);
          if (warp + 1 < nwarps)
            sEdge[warp * kEdgeRows + (i & (kEdgeRows - 1))] = v;
          else if (ring_out)
            out_ring[(out0 + i) & (kBandRows - 1)] = v;
          else if (wrap_out)
            __stcg(wb + i, v);
        }
      }
      hprev = hleft;  // the left lane's row i is this lane's row above next
    };

    const int T = M + G - 1;
    // The steps [ts, te) between two progress counts, as in K1.
    auto span = [&](int ts, int te) {
      if (kWide) wait_for_neighbours(sProgress, warp, nwarps, te, T);
      if (ring_in) wait_at_least(&sLink[0], in0 + min(te, M));
      if (ring_out) wait_at_least(&sLink[1], out0 + te - 31 - kBandRows);
      __syncwarp();
      int t = ts;
      for (; t < min(te, G - 1); ++t) step(t, std::false_type());
      for (; t < min(te, M); ++t) step(t, std::true_type());
      for (; t < te; ++t) step(t, std::false_type());
      if (kWide) publish_progress(sProgress, warp, lane, te);
      if (ring_in && lane == 0)
        store_release_cluster(in_read, in0 + min(te, M));
      if ((ring_out || wrap_out) && lane == 31)
        store_release_cluster(out_written, out0 + min(max(te - 31, 0), M));
    };
    for (int t0 = 0; t0 < T; t0 += kChunk) {
      const int tend = min(t0 + kChunk, T);
      __syncwarp();
      stage_query<G, kTable>(myq, qb, M, t0, lg);
      if (wrap_in) {  // the wrap's rows of this chunk, once they are written
        wait_at_least(&sLink[0], in0 + min(tend, M));
        if (t0 + lane < M) sIn[lane] = __ldcg(wb + t0 + lane);
      }
      if constexpr (kSync < kChunk) {
        for (int ts = t0; ts < tend; ts += kSync)
          span(ts, min(ts + kSync, tend));
      } else {
        span(t0, tend);
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
  if (kBands) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
        best = max(best, sBest[w]);
      cluster.map_shared_rank(&sBlockBest[0], 0)[rank] = best;
    }
    cluster.sync();  // no block leaves while another may touch its memory
    if (rank != 0 || threadIdx.x != 0) return;
    for (int k = 1; k < nblocks; ++k) best = max(best, sBlockBest[k]);
    out[b] = best;
    return;
  }
  if (threadIdx.x != 0) return;
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) best = max(best, sBest[w]);
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
          q, r, out, B, M, N, match, mismatch, go, ge, nullptr);
#endif
  return (int)cudaGetLastError();
}

// K2's wide block: N/256 warps for N <= kWideMaxN.
template <bool kGuard>
int launch_score_wide(const uint8_t* q, const uint8_t* r, int32_t* out,
                      long long B, int M, int N, int match, int mismatch,
                      int go, int ge, cudaStream_t s) {
  constexpr int kStripe = 32 * LHT_SW_WIDE_NPL;
  const int warps = (N + kStripe - 1) / kStripe;
  if (warps > kWideMaxWarps || B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t ring = (size_t)(warps - 1) * kEdgeRows * sizeof(int2);
  sw_score_kernel<32, LHT_SW_WIDE_NPL, true, kGuard>
      <<<(unsigned)B, 32 * warps, ring, s>>>(q, r, out, B, M, N, match,
                                             mismatch, go, ge, nullptr);
  return (int)cudaGetLastError();
}

// K2 past kWideMaxN columns: one block a band (up to 8 warps of 32 x
// kScoreBandNPL columns), the bands of an alignment in a cluster, as K1's.
template <bool kGuard>
int launch_score_bands(const uint8_t* q, const uint8_t* r, int32_t* out,
                       long long B, int M, int N, int match, int mismatch,
                       int go, int ge, int2* wrap, cudaStream_t s) {
  int warps, nbands;
  band_shape(N, 32 * kScoreBandNPL, &warps, &nbands);
  if (warps > kWideMaxWarps || (nbands > kClusterMax && wrap == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t ring = (size_t)(warps - 1) * kEdgeRows * sizeof(int2);
  return launch_cluster(
      sw_score_kernel<32, kScoreBandNPL, true, kGuard, true>,
      min(nbands, kClusterMax), B, 32 * warps, ring, s, q, r, out, B, M, N,
      match, mismatch, go, ge, wrap);
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
  const bool plain = table_fits(match, mismatch, go, ge);
  if (N > kNarrowMaxN) {
    if (N > kWideMaxN) return (int)cudaErrorInvalidValue;  // bands
    return plain ? launch_align_wide<false>(q, r, out, B, M, N, match,
                                            mismatch, go, ge, s)
                 : launch_align_wide<true>(q, r, out, B, M, N, match,
                                           mismatch, go, ge, s);
  }
  if (!plain)
    return launch_align<32, 16, true>(q, r, out, B, M, N, match, mismatch,
                                      go, ge, s);
#define LHT_ALIGN_CASE(G, NPL)                                              \
  if (N <= G * NPL)                                                         \
    return launch_align<G, NPL, false>(q, r, out, B, M, N, match, mismatch, \
                                       go, ge, s);
  LHT_ALIGN_PAIRS(LHT_ALIGN_CASE)
#undef LHT_ALIGN_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int lht_sw_score(const uint8_t* q, const uint8_t* r, int32_t* out,
                            long long B, int M, int N, int match,
                            int mismatch, int go, int ge, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const bool plain = table_fits(match, mismatch, go, ge);
  if (N > kNarrowMaxN) {
    if (N > kWideMaxN) return (int)cudaErrorInvalidValue;  // bands
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

// N > kWideMaxN: bands in a cluster (see the header). `wrap` is the
// caller's buffer for the edge from the cluster's last block to its first,
// needed only past kClusterMax bands (else it may be null): B x M int4 (K1:
// H, its origin, E, its origin) or int2 (K2: H, E), device memory that the
// kernel overwrites. Returns the launch's error, also where the card
// cannot hold a cluster of the bands' blocks.
extern "C" int lht_sw_align_bands(const uint8_t* q, const uint8_t* r,
                                  int32_t* out, long long B, int M, int N,
                                  int match, int mismatch, int go, int ge,
                                  void* wrap, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (N <= kWideMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int4* w = (int4*)wrap;
  return table_fits(match, mismatch, go, ge)
             ? launch_align_bands<false>(q, r, out, B, M, N, match, mismatch,
                                         go, ge, w, s)
             : launch_align_bands<true>(q, r, out, B, M, N, match, mismatch,
                                        go, ge, w, s);
}

extern "C" int lht_sw_score_bands(const uint8_t* q, const uint8_t* r,
                                  int32_t* out, long long B, int M, int N,
                                  int match, int mismatch, int go, int ge,
                                  void* wrap, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (N <= kWideMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int2* w = (int2*)wrap;
  return table_fits(match, mismatch, go, ge)
             ? launch_score_bands<false>(q, r, out, B, M, N, match, mismatch,
                                         go, ge, w, s)
             : launch_score_bands<true>(q, r, out, B, M, N, match, mismatch,
                                        go, ge, w, s);
}
