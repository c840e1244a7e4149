// Split-read vote register scan for Hopper (sm_90a): kernel K3.
//
// `lht_vote_state` replaces localhgt_tpu/ops/pallas_vote.py::vote_state
// (kernel _kernel): for each read pair, a sequential greedy scan over P
// positions x C hash candidates with a G-slot genome register. At each
// position the candidate whose genome is already in the register with the
// highest count wins (>=, so a later hash wins ties), else the first new
// genome; the winner increments its slot or is inserted into the first
// empty slot, and on a full register evicts the most recently inserted
// slot with count 1 (stamp of position p is p + 1). `hits` counts the
// positions that had a candidate.
//
// What bounds it on an H100: bytes. Each pair reads 8*P*C bytes once and
// writes 100, and the compares the scan needs are few beside them. But the
// scan is sequential per pair and full of data-dependent choices, so in
// practice two things compete: how the bytes reach the scan, and how many
// pairs an SM can walk at once to hide the scan's dependent operations.
// One thread owns one pair and keeps the register (G slots of genome,
// count, peak id, stamp) in registers.
//
// Design:
// - Input is read in the caller's [C, B, P] layout, no transposed copy.
//   A pair's row is contiguous in P, so a warp stages the rows of its own
//   32 pairs (all C candidates, both arrays) into shared memory with
//   16-byte cp.async copies, kTile positions at a time. Neighbouring lanes
//   copy neighbouring 16-byte units of one row; with kTile = 16 a row's
//   piece is 64 contiguous bytes, which device memory serves at nearly
//   twice the rate of 32-byte pieces (tune_vote.py, probe 2).
// - Loading is split from the scan: kStages tiles form a ring, and the
//   copy of tile t + kStages - 1 is in flight while each thread walks its
//   register over tile t. A warp copies only its own pairs' rows, so
//   cp.async.wait_group plus __syncwarp orders the ring; there is no
//   block barrier and warps drift apart freely.
// - A thread reads its row back as 16-byte vectors (4 positions). With a
//   row pitch of kTile words the 8 threads that share one shared-memory
//   wavefront would hit the same banks, so the 16-byte unit j of pair t is
//   stored at unit j ^ swizzle(t): the 8 threads then cover all 32 banks,
//   without padding. Shared memory is what limits the resident pairs
//   (kStages * 2C * kTile * 4 bytes a pair), so padding would cost pairs.
// - The scan's maxima over the 8 slots are trees, not chains, and the
//   first empty slot is a counter (see vote_step): with few warps resident
//   the scan is bound by the latency of its dependent operations.
// - Groups of 4 positions whose peak ids are all 0 are skipped after one
//   OR. (On the main path about half of all candidates are set, so this
//   matters only for sparse inputs.)
// - B may be ragged: rows past B are zero-filled by cp.async (src-size 0)
//   and their threads store nothing. P may be anything: a tail past P is
//   zero-filled too, and when P is not a multiple of 4 or a pointer is not
//   16-byte aligned the same ring is filled with 4-byte cp.async copies.
// The tiling constants can be overridden with -DLHT_VOTE_* for
// tune_vote.py, which is where the defaults were chosen.
//
// Launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LHT_VOTE_PAIRS
#define LHT_VOTE_PAIRS 128
#endif
#ifndef LHT_VOTE_TILE
#define LHT_VOTE_TILE 16
#endif
#ifndef LHT_VOTE_STAGES
#define LHT_VOTE_STAGES 2
#endif
// Timing probes of tune_vote.py, wrong results: 1 = every tile re-reads
// the first kStages tiles (the scan without the device-memory traffic),
// 2 = the copies without the scan
#ifndef LHT_VOTE_PROBE
#define LHT_VOTE_PROBE 0
#endif

namespace {

constexpr int G = 8;                        // register slots (n_slots)
constexpr int kPairs = LHT_VOTE_PAIRS;      // pairs = threads per block
                                            // at C <= 3 (see pairs_for)
constexpr int kTile = LHT_VOTE_TILE;        // positions per staged tile
constexpr int kStages = LHT_VOTE_STAGES;    // tiles in the ring
constexpr int kUnits = kTile / 4;           // 16-byte units per tile row
constexpr int kMaxC = 9;                    // hash functions (config: 1-9)

static_assert(kPairs % 32 == 0 && kPairs <= 1024, "whole warps");

// Pairs per block for C hash functions: a block's ring takes
// kStages * 2C * pairs * kTile * 4 bytes, so blocks shrink as C grows and
// the ring of any C <= kMaxC stays near that of C = 3.
constexpr int pairs_for(int C) {
  const int p = C <= 3 ? kPairs : C <= 6 ? kPairs / 2 : kPairs / 4;
  return p < 32 ? 32 : p / 32 * 32;
}
static_assert(kTile % 4 == 0 && kUnits >= 1 && kUnits <= 8 &&
              (kUnits & (kUnits - 1)) == 0, "tile of 4..32 positions");
static_assert(kStages >= 2, "at least a double buffer");

struct Slots {
  int g[G], c[G], p[G], t[G];
  int used;  // slots 0..used-1 hold a genome; the empty ones come last
  int hits;
};

__device__ __forceinline__ int max8(const int (&v)[G]) {
  return max(max(max(v[0], v[1]), max(v[2], v[3])),
             max(max(v[4], v[5]), max(v[6], v[7])));
}

// The unit of pair `lane` that holds its 16-byte unit j.
__device__ __forceinline__ int swizzled(int j, int lane) {
  return j ^ ((lane * kUnits >> 3) & (kUnits - 1));
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, bool vec16) {
  if (vec16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int lane_of(const int4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// One position of the scan: candidates (cg[c], cp[c]), stamp p + 1.
// The rules are those of the header; what is written for the card is
// their shape. A genome sits in at most one slot (it is inserted only when
// no slot holds it), slots fill from 0 upwards and never empty again, and
// stamps are distinct (one insertion a position). So a candidate's count
// and the eviction victim are maxima of 8 independent values, taken as
// trees and not as chains of compares, the first empty slot is a counter,
// and the winner is in the register exactly when it won as a seen genome.
// A candidate with a peak id but genome 0 matches nothing and is inserted
// into the first empty slot, which stays empty: as in the plain version.
template <int C>
__device__ __forceinline__ void vote_step(Slots& r, const int (&cg)[C],
                                          const int (&cp)[C], int p) {
  int sel_g = 0, sel_cnt = 0, sel_p = 0;
  bool sel_seen = false;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int pk = cp[c], g = cg[c];
    int m[G];  // count of the slot that holds g, -1 elsewhere
#pragma unroll
    for (int s = 0; s < G; ++s) m[s] = r.g[s] == g ? r.c[s] : -1;
    const int cnt = max8(m);
    const bool seen = cnt >= 0 && g != 0;
    // a seen genome wins with the highest count (>=: the later hash on
    // ties), else the first new genome
    const bool take = pk != 0 && (seen ? cnt >= sel_cnt : sel_p == 0);
    if (take) {
      sel_g = g;
      sel_p = pk;
      sel_cnt = seen ? cnt : 0;
      sel_seen = seen;
    }
  }
  if (sel_p == 0) return;
  ++r.hits;
  if (sel_seen) {
#pragma unroll
    for (int s = 0; s < G; ++s) r.c[s] += r.g[s] == sel_g;
    return;
  }
  // victim: the first empty slot, else the slot with the newest stamp
  // among those of count 1; none when every slot has count > 1
  int age[G];
#pragma unroll
  for (int s = 0; s < G; ++s) age[s] = r.c[s] == 1 ? r.t[s] : -1;
  const int newest = max8(age);
  const bool evict = r.used >= G && newest >= 0;
  const int empty = r.used;
  r.used += r.used < G && sel_g != 0;
#pragma unroll
  for (int s = 0; s < G; ++s) {
    if (s == empty || (evict && age[s] == newest)) {
      r.g[s] = sel_g;
      r.c[s] = 1;
      r.p[s] = sel_p;
      r.t[s] = p + 1;
    }
  }
}

// A warp copies tile `tile` of its own 32 pairs into ring stage `stage`.
// kVec = 4: 16-byte copies (P % 4 == 0, pointers 16-byte aligned);
// kVec = 1: 4-byte copies, any P and alignment.
template <int C, int kVec, int kP>
__device__ __forceinline__ void stage_tile(
    const int32_t* __restrict__ cg, const int32_t* __restrict__ cp,
    uint32_t smem, int stage, int tile, long long b_warp, long long B, int P,
    int warp, int lane) {
  constexpr int kPer = kTile / kVec;    // copies per tile row
  constexpr int kRows = 32 / kPer;      // rows a warp covers per step
#if LHT_VOTE_PROBE == 1
  tile %= kStages;
#endif
  const int p = tile * kTile + (lane % kPer) * kVec;
#pragma unroll
  for (int i = 0; i < 2 * C * kPer; ++i) {
    const int ac = i / kPer;            // array * C + candidate
    const int row = lane / kPer + (i % kPer) * kRows;  // pair in the warp
    const long long b = b_warp + row;
    const bool live = b < B && p < P;
    const int32_t* src = ac < C ? cg : cp;
    if (live) src += ((long long)(ac % C) * B + b) * P + p;
    const int word = (lane % kPer) * kVec;   // position within the row
    const int at = ((stage * 2 * C + ac) * kP + warp * 32 + row) * kTile +
                   4 * swizzled(word / 4, row) + word % 4;
    cp_async(smem + 4u * at, src, live ? 4 * kVec : 0, kVec == 4);
  }
}

template <int C, int kVec, int kP>
__global__ void __launch_bounds__(kP)
vote_kernel(const int32_t* __restrict__ cg, const int32_t* __restrict__ cp,
            int32_t* __restrict__ og, int32_t* __restrict__ oc,
            int32_t* __restrict__ op, int32_t* __restrict__ oh, long long B,
            int P) {
  extern __shared__ __align__(16) int32_t ring[];
  const uint32_t smem = (uint32_t)__cvta_generic_to_shared(ring);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b_warp = (long long)blockIdx.x * kP + warp * 32;
  if (b_warp >= B) return;  // the whole warp is past the batch
  const long long b = b_warp + lane;
  const int n_tiles = (P + kTile - 1) / kTile;

  Slots r;
#pragma unroll
  for (int s = 0; s < G; ++s) r.g[s] = r.c[s] = r.p[s] = r.t[s] = 0;
  r.used = r.hits = 0;

  // the scan of tile t out of its ring stage
  auto scan_tile = [&](int t) {
    const int32_t* tile =
        ring + ((t % kStages) * 2 * C * kP + threadIdx.x) * kTile;
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int unit = 4 * swizzled(j, lane);
      int4 vp[C];
      int any = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        vp[c] = *reinterpret_cast<const int4*>(
            tile + (C + c) * kP * kTile + unit);
        any |= vp[c].x | vp[c].y | vp[c].z | vp[c].w;
      }
      if (any == 0) continue;
      int4 vg[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        vg[c] = *reinterpret_cast<const int4*>(tile + c * kP * kTile + unit);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        int g[C], k[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          g[c] = lane_of(vg[c], w);
          k[c] = lane_of(vp[c], w);
        }
#if LHT_VOTE_PROBE == 2
        r.hits += g[0] ^ k[0];
#else
        vote_step<C>(r, g, k, t * kTile + 4 * j + w);
#endif
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      stage_tile<C, kVec, kP>(cg, cp, smem, s, s, b_warp, B, P, warp, lane);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed for every lane, and every lane is done with the
    // stage that tile t + kStages - 1 goes into
    cp_async_wait<kStages - 2>();
    __syncwarp();
    const int ahead = t + kStages - 1;
    if (ahead < n_tiles)
      stage_tile<C, kVec, kP>(cg, cp, smem, ahead % kStages, ahead, b_warp,
                              B, P, warp, lane);
    cp_async_commit();
    scan_tile(t);
  }
  if (b >= B) return;
  int4* g4 = reinterpret_cast<int4*>(og + b * G);
  int4* c4 = reinterpret_cast<int4*>(oc + b * G);
  int4* p4 = reinterpret_cast<int4*>(op + b * G);
  g4[0] = make_int4(r.g[0], r.g[1], r.g[2], r.g[3]);
  g4[1] = make_int4(r.g[4], r.g[5], r.g[6], r.g[7]);
  c4[0] = make_int4(r.c[0], r.c[1], r.c[2], r.c[3]);
  c4[1] = make_int4(r.c[4], r.c[5], r.c[6], r.c[7]);
  p4[0] = make_int4(r.p[0], r.p[1], r.p[2], r.p[3]);
  p4[1] = make_int4(r.p[4], r.p[5], r.p[6], r.p[7]);
  oh[b] = r.hits;
}

template <int C, int kVec>
int launch(const int32_t* cg, const int32_t* cp, int32_t* og, int32_t* oc,
           int32_t* op, int32_t* oh, long long B, int P, cudaStream_t s) {
  constexpr int kP = pairs_for(C);
  const int bytes = kStages * 2 * C * kP * kTile * 4;
  auto kern = vote_kernel<C, kVec, kP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((B + kP - 1) / kP)), block(kP);
  kern<<<grid, block, bytes, s>>>(cg, cp, og, oc, op, oh, B, P);
  return (int)cudaGetLastError();
}

template <int C>
int launch_c(int C_want, const int32_t* cg, const int32_t* cp, int32_t* og,
             int32_t* oc, int32_t* op, int32_t* oh, long long B, int P,
             bool vec16, cudaStream_t s) {
  if constexpr (C > kMaxC) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (C_want != C)
      return launch_c<C + 1>(C_want, cg, cp, og, oc, op, oh, B, P, vec16, s);
    return vec16 ? launch<C, 4>(cg, cp, og, oc, op, oh, B, P, s)
                 : launch<C, 1>(cg, cp, og, oc, op, oh, B, P, s);
  }
}

}  // namespace

// cg, cp: int32 [C, B, P] contiguous; og, oc, op: int32 [B, 8]; oh: [B].
// The outputs must be 16-byte aligned (a fresh torch tensor is).
extern "C" int lht_vote_state(const int32_t* cg, const int32_t* cp,
                              int32_t* og, int32_t* oc, int32_t* op,
                              int32_t* oh, long long B, int P, int C,
                              int n_slots, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (n_slots != G || C < 1 || P < 0) return (int)cudaErrorInvalidValue;
  const bool vec16 =
      P % 4 == 0 && ((uintptr_t)cg | (uintptr_t)cp) % 16 == 0;
  return launch_c<1>(C, cg, cp, og, oc, op, oh, B, P, vec16,
                     (cudaStream_t)stream);
}
