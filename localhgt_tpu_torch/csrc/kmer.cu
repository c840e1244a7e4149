// Canonical k-mer hashing and the count table's run-capped update for
// Hopper (sm_90a): kernels K4 and K5.
//
// Neither replaces a Pallas kernel. Their counterpart is the XLA program
// that localhgt_tpu/ops/count.py::count_reads_step jits, one dispatch a
// read batch: hash, crop, sort, rank-capped scatter-add. K4 also serves
// every other caller of localhgt_tpu/ops/encode.py::canonical_hashes,
// which XLA fuses into the scan, peak-set and vote programs.
//
// K4, `lht_kmer_hashes`: for codes uint8 [R, L] (A, C, G, T = 0..3, any
// other value a non-base), masks uint32 [C, 3] and k in 1..32, the
// canonical hash of every window start j as int64 [C, R, L] and its valid
// bit as bool [R, L], bit for bit what the plain torch version
// (ops/encode.py::canonical_hashes_plain) computes, at j > L - k too, where
// the plain version's zero-filled shifts define the value: a position past
// L counts as a non-base. `lht_kmer_count_keys` is the same kernel with
// the count step's epilogue: for lengths int32 [R], accept bool [R] and a
// crop `width` of the window starts, the flat 32-bit keys [C, R * width]
// that ops/count.py::count_keys_plain gives, 0xFFFFFFFF wherever the
// window is not valid, starts past lengths - k or lies in a read that is
// not accepted.
//
// The encoding (ops/encode.py): base b has three partition bits, p0 = A|T,
// p1 = A|C, p2 = A|G, and a valid bit. Stream p's window at j is
// W_p[j] = sum_{z<k} p[j+z] << (k-1-z); a hash is (W0 & m0) | (W1 & m1) |
// (W2 & m2) with one coder's masks, and the reverse complement's windows
// are the k-bit reversals of W0, ~W1 and ~W2. The canonical hash is the
// smaller of the two.
//
// What bounds K4 on an H100: bytes. A window start reads one code byte and
// writes 8C + 1 bytes (4C in the count epilogue); the bit work is a few
// dozen integer instructions. So the design only has to keep the writes
// whole and make the bit work small:
// - One warp takes 32 consecutive window starts of one row. Each lane
//   loads the code at j0 + lane and at j0 + 32 + lane, and one ballot per
//   stream and half gives that stream's 64 bits as two words; `__brev`
//   puts position j0 at the top. Lane l's window is then one funnel shift
//   of the two words by l and a shift right by 32 - k: no log-doubling,
//   no shared memory, no loop over the k codes.
// - The reverse-complement windows are `__brev` of W0, ~W1 and ~W2 shifted
//   right by 32 - k. The C hashes, their minimum and the valid bit come
//   out of the same registers.
// - A warp writes 32 consecutive int64 (or uint32) values per hash
//   function: whole 32-byte sectors. The codes are read twice (as a
//   warp's start and as the warp before's tail), from L1 or L2.
//
// K5, `lht_kmer_run_capped_update`: for one sorted key row s [N] of 32-bit
// keys (the wrapper sorts their int32 bit patterns as int32: only the
// grouping into runs matters) and an int8 table, add min(run length, cap)
// to table[h] for
// every run of equal keys h other than 0xFFFFFFFF, what
// ops/count.py::rank_capped_contrib and scatter_delta add together. One
// thread a position: the thread where a run starts counts up to `cap`
// equal successors and adds them. Each hash is one run of the row, so no
// two threads write one byte and no atomic is needed (a byte store does
// not touch its neighbours). What bounds it: bytes, the row's keys read
// once and, for every run, the 32-byte sector of its table byte read and
// written. It replaces a cummax over the row, a compaction whose boolean
// index makes the host wait, and a scatter-add. The table holds 2^k
// entries; every key other than the sentinel must be below that, as every
// canonical hash at k is.
//
// Each entry point launches on the given stream, synchronises nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 9;            // hash functions (config: 1-9)
constexpr int kThreads = 256;       // 8 warps a block
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

struct Masks {
  uint32_t m[kMaxC][3];
};

// The k-bit window of a stream whose positions j0..j0+63 sit MSB first
// in (hi, lo), starting at j0 + lane.
__device__ __forceinline__ uint32_t window(uint32_t hi, uint32_t lo, int lane,
                                           int k) {
  return __funnelshift_l(lo, hi, lane) >> (32 - k);
}

// Kernel K4. kCount = false: hashes [C, rows, L] int64 and valid [rows, L];
// tiles = ceil(L / 32). kCount = true: keys [C, rows * width] uint32;
// tiles = ceil(width / 32).
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    kmer_kernel(const uint8_t* __restrict__ codes, long long rows, int L,
                int width, int tiles, int k, int C, Masks masks,
                long long* __restrict__ hashes, uint8_t* __restrict__ valid,
                const int32_t* __restrict__ lengths,
                const uint8_t* __restrict__ accept,
                uint32_t* __restrict__ keys) {
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (warp >= rows * tiles) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long row = warp / tiles;
  const int j0 = (int)(warp - row * tiles) * 32;
  const uint8_t* r = codes + row * L;
  const int a = j0 + lane, b = a + 32;
  const uint32_t ca = a < L ? r[a] : 4u;  // past L: a non-base
  const uint32_t cb = b < L ? r[b] : 4u;

  // stream bits: p0 = A|T, p1 = A|C, p2 = A|G, valid = A|C|G|T
  uint32_t hi[4], lo[4];
#define LHT_STREAM(i, pred)                                          \
  {                                                                  \
    uint32_t c = ca;                                                 \
    hi[i] = __brev(__ballot_sync(0xFFFFFFFFu, pred));                \
    c = cb;                                                          \
    lo[i] = __brev(__ballot_sync(0xFFFFFFFFu, pred));                \
  }
  LHT_STREAM(0, c == 0 || c == 3)
  LHT_STREAM(1, c < 2)
  LHT_STREAM(2, c == 0 || c == 2)
  LHT_STREAM(3, c < 4)
#undef LHT_STREAM

  const uint32_t kmask = 0xFFFFFFFFu >> (32 - k);
  const uint32_t w0 = window(hi[0], lo[0], lane, k);
  const uint32_t w1 = window(hi[1], lo[1], lane, k);
  const uint32_t w2 = window(hi[2], lo[2], lane, k);
  // every position of the window a base (which also keeps it inside L)
  const bool ok = window(hi[3], lo[3], lane, k) == kmask;
  const uint32_t r0 = __brev(w0) >> (32 - k);
  const uint32_t r1 = __brev(~w1 & kmask) >> (32 - k);
  const uint32_t r2 = __brev(~w2 & kmask) >> (32 - k);

  const int j = a;
  if (j >= width) return;  // width = L without the count epilogue
  const long long out = row * width + j;
  const long long stride = rows * width;
  const bool live = !kCount || (ok && accept[row] && j <= lengths[row] - k);
  if (!kCount) valid[out] = ok;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= C) break;
    const uint32_t m0 = masks.m[c][0], m1 = masks.m[c][1], m2 = masks.m[c][2];
    const uint32_t fwd = (w0 & m0) | (w1 & m1) | (w2 & m2);
    const uint32_t rev = (r0 & m0) | (r1 & m1) | (r2 & m2);
    const uint32_t h = min(fwd, rev);
    if (kCount)
      keys[c * stride + out] = live ? h : kSentinel;
    else
      hashes[c * stride + out] = (long long)h;
  }
}

// Kernel K5 over one sorted key row.
__global__ void __launch_bounds__(kThreads)
    run_capped_update_kernel(const uint32_t* __restrict__ s, long long n,
                             int8_t* __restrict__ table, int cap) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const uint32_t h = s[j];
  if (h == kSentinel || (j > 0 && s[j - 1] == h)) return;
  int run = 0;  // min(run length, cap): cap 0 adds nothing
  while (run < cap && j + run < n && s[j + run] == h) ++run;
  if (run) table[h] = (int8_t)(table[h] + run);  // wraps as index_add_
}

// Blocks for `threads` threads; 0 when the grid would not fit.
unsigned blocks_for(long long threads) {
  const long long b = (threads + kThreads - 1) / kThreads;
  return b <= 0x7FFFFFFF ? (unsigned)b : 0u;
}

bool load_masks(const uint32_t* host, int C, Masks* out) {
  if (C < 1 || C > kMaxC) return false;
  for (int c = 0; c < C; ++c)
    for (int p = 0; p < 3; ++p) out->m[c][p] = host[3 * c + p];
  return true;
}

}  // namespace

// codes uint8 [rows, L]; masks_host uint32 [C, 3] in host memory;
// hashes int64 [C, rows, L]; valid bool [rows, L].
extern "C" int lht_kmer_hashes(const uint8_t* codes, long long rows, int L,
                               int k, int C, const uint32_t* masks_host,
                               long long* hashes, uint8_t* valid,
                               void* stream) {
  Masks masks;
  if (k < 1 || k > 32 || L < 1 || rows < 1 ||
      !load_masks(masks_host, C, &masks))
    return (int)cudaErrorInvalidValue;
  const int tiles = (L + 31) / 32;
  const unsigned grid = blocks_for(rows * tiles * 32);
  if (!grid) return (int)cudaErrorInvalidValue;
  kmer_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      codes, rows, L, L, tiles, k, C, masks, hashes, valid, nullptr, nullptr,
      nullptr);
  return (int)cudaGetLastError();
}

// codes uint8 [rows, L]; lengths int32 [rows]; accept bool [rows];
// keys uint32 [C, rows * width], width <= L.
extern "C" int lht_kmer_count_keys(const uint8_t* codes, long long rows,
                                   int L, int width, int k, int C,
                                   const uint32_t* masks_host,
                                   const int32_t* lengths,
                                   const uint8_t* accept, uint32_t* keys,
                                   void* stream) {
  Masks masks;
  if (k < 1 || k > 32 || L < 1 || rows < 1 || width < 1 || width > L ||
      !load_masks(masks_host, C, &masks))
    return (int)cudaErrorInvalidValue;
  const int tiles = (width + 31) / 32;
  const unsigned grid = blocks_for(rows * tiles * 32);
  if (!grid) return (int)cudaErrorInvalidValue;
  kmer_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      codes, rows, L, width, tiles, k, C, masks, nullptr, nullptr, lengths,
      accept, keys);
  return (int)cudaGetLastError();
}

// keys: one sorted row of n 32-bit keys; table int8 [2^k].
extern "C" int lht_kmer_run_capped_update(const uint32_t* keys, long long n,
                                          int8_t* table, int cap,
                                          void* stream) {
  const unsigned grid = blocks_for(n);
  if (n < 1 || cap < 0 || !grid) return (int)cudaErrorInvalidValue;
  run_capped_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      keys, n, table, cap);
  return (int)cudaGetLastError();
}
