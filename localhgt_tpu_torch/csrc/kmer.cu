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
// L counts as a non-base. `lht_kmer_count_keys` is K4 with the count
// step's epilogue: for lengths int32 [R], accept bool [R] and a crop
// `width` of the window starts, the flat 32-bit keys [C, R * width] that
// ops/count.py::count_keys_plain gives, 0xFFFFFFFF wherever the window is
// not valid, starts past lengths - k or lies in a read that is not
// accepted.
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
// - A warp writes 32 consecutive int64 values per hash function: whole
//   32-byte sectors. The codes are read twice (as a warp's start and as
//   the warp before's tail), from L1 or L2.
//
// The count epilogue writes 4C bytes a start and reads about one code
// byte a start, so its bytes are nearly all stores. One warp a 32-start
// tile, as K4 runs, lived a few microseconds and kept one 32-byte load
// in flight (1.34 TB/s on an H100). Its own kernel instead:
// - Persistent blocks, as many as the card holds at once; a warp walks
//   units of a read (up to 128 window starts: all of one read at the count
//   step's crop of 128) with a grid stride.
// - A warp issues a unit's 5 code loads (32-code words, one byte a lane)
//   together, and the next unit's loads, lengths and accept before this
//   unit's stores. Codes past width + k - 2 are no window's and are not
//   read.
// - One ballot a stream and word: 20 a unit, not 8 a tile; tile t's
//   windows are the funnel shift of words t and t + 1.
// - Each store is a whole 128-byte line a hash function, streaming
//   (`__stcs`): the keys are read back only by the sort, and C x 4 bytes
//   x 8.4 M starts exceed the 50 MB L2.
//
// K5, `lht_kmer_run_capped_update`: for C sorted key rows s [C, N] of
// 32-bit keys (the wrapper sorts their int32 bit patterns as int32: only
// the grouping into runs matters) and C int8 tables, add min(run length,
// cap) to table c [h] for every run of equal keys h other than 0xFFFFFFFF
// of row c, what ops/count.py::rank_capped_contrib and scatter_delta add
// together (each byte mod 256), in one launch for the C rows. What bounds
// it: bytes, the rows' keys read once and, for every run, the 32-byte
// sector of its table byte read and written; at the count step's 8.4 M
// keys a row that is 3.15 M sectors scattered over a 4 GiB table, so what
// the card does with random sectors decides. tune_kmer.py's probe gives
// that floor: one 32-bit atomic add whose result is not read, a thread a
// run head. A byte load and store a head is two L2 transactions and
// takes longer (so did the first K5, a thread a key, a launch a table).
// The design:
// - A thread a key, the C rows in one launch (blockIdx.y the row). The
//   thread of a run's head (its key differs from the one before, and is
//   not the sentinel) reads on to the run's end, at most cap + kScan keys,
//   from the L1 its warp's neighbours filled.
// - A head's update is one 32-bit atomic add at the L2 (the byte's sum in
//   its lane of the word), not a load and a store. A byte that overflows
//   would carry into its neighbour; the atomic returns the old word, and
//   a carry is taken back by a second atomic, which is exact because no
//   other head of the launch touches that word. A sorted row puts every
//   key of a word's 4 bytes in neighbouring runs, so a head whose run
//   before or after lies in the same word (or whose run goes on past what
//   it read) swaps the word with compare and swap instead, so that the
//   bytes of one word add independently.
// A warp's schedule (chunks of 128 keys, run ends by ballot, heads
// compacted so that a lane issues several table updates at once, on
// persistent blocks) took 11% longer than this on an H100.
//
// Each entry point launches on the given stream, synchronises nothing and
// returns cudaGetLastError() (or the error of a refused occupancy query).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 9;            // hash functions (config: 1-9)
constexpr int kThreads = 256;       // 8 warps a block
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kUnitTiles = 4;       // count epilogue: 32-start tiles a unit
constexpr int kWords = kUnitTiles + 1;  // 32-code words a unit reads
constexpr int kScan = 32;           // K5: keys read past the cap at most

struct Masks {
  uint32_t m[kMaxC][3];
};

struct Tables {
  int8_t* t[kMaxC];
};

// The k-bit window of a stream whose positions j0..j0+63 sit MSB first
// in (hi, lo), starting at j0 + lane.
__device__ __forceinline__ uint32_t window(uint32_t hi, uint32_t lo, int lane,
                                           int k) {
  return __funnelshift_l(lo, hi, lane) >> (32 - k);
}

// Kernel K4: hashes [C, rows, L] int64 and valid [rows, L]; tiles =
// ceil(L / 32).
__global__ void __launch_bounds__(kThreads)
    kmer_kernel(const uint8_t* __restrict__ codes, long long rows, int L,
                int tiles, int k, int C, Masks masks,
                long long* __restrict__ hashes, uint8_t* __restrict__ valid) {
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
    hi[i] = __brev(__ballot_sync(kFull, pred));                      \
    c = cb;                                                          \
    lo[i] = __brev(__ballot_sync(kFull, pred));                      \
  }
  LHT_STREAM(0, c == 0 || c == 3)
  LHT_STREAM(1, c < 2)
  LHT_STREAM(2, c == 0 || c == 2)
  LHT_STREAM(3, c < 4)
#undef LHT_STREAM

  const uint32_t kmask = kFull >> (32 - k);
  const uint32_t w0 = window(hi[0], lo[0], lane, k);
  const uint32_t w1 = window(hi[1], lo[1], lane, k);
  const uint32_t w2 = window(hi[2], lo[2], lane, k);
  // every position of the window a base (which also keeps it inside L)
  const bool ok = window(hi[3], lo[3], lane, k) == kmask;
  const uint32_t r0 = __brev(w0) >> (32 - k);
  const uint32_t r1 = __brev(~w1 & kmask) >> (32 - k);
  const uint32_t r2 = __brev(~w2 & kmask) >> (32 - k);

  const int j = a;
  if (j >= L) return;
  const long long out = row * L + j;
  const long long stride = rows * L;
  valid[out] = ok;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    if (c >= C) break;
    const uint32_t m0 = masks.m[c][0], m1 = masks.m[c][1], m2 = masks.m[c][2];
    const uint32_t fwd = (w0 & m0) | (w1 & m1) | (w2 & m2);
    const uint32_t rev = (r0 & m0) | (r1 & m1) | (r2 & m2);
    hashes[c * stride + out] = (long long)min(fwd, rev);
  }
}

// One unit of the count epilogue: the read it lies in, its first window
// start, and a lane's code of each of its words (a non-base past `limit`).
struct Unit {
  uint32_t code[kWords];
  int length;
  uint32_t accept;
  unsigned row;
  int j0;
};

__device__ __forceinline__ void fetch_unit(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ lengths,
    const uint8_t* __restrict__ accept, unsigned u, unsigned units_a_row,
    int L, int limit, int lane, Unit& out) {
  const unsigned row = u / units_a_row;
  const int j0 = (int)(u - row * units_a_row) * (32 * kUnitTiles);
  const uint8_t* r = codes + (long long)row * L;
  out.row = row;
  out.j0 = j0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int p = j0 + 32 * w + lane;
    out.code[w] = p < limit ? r[p] : 4u;
  }
  out.length = lengths[row];
  out.accept = accept[row];
}

// Kernel K4 with the count epilogue: keys [C, rows * width] uint32. A unit
// is kUnitTiles tiles of 32 window starts of one read; units_a_row =
// ceil(width / (32 kUnitTiles)), rows * units_a_row < 2^31.
__global__ void __launch_bounds__(kThreads)
    count_keys_kernel(const uint8_t* __restrict__ codes, long long rows,
                      int L, int width, unsigned units_a_row, int k, int C,
                      Masks masks, const int32_t* __restrict__ lengths,
                      const uint8_t* __restrict__ accept,
                      uint32_t* __restrict__ keys) {
  const int lane = threadIdx.x & 31;
  const unsigned units = (unsigned)rows * units_a_row;
  const unsigned step = gridDim.x * kWarps;
  // the last code a window below `width` reads is width + k - 2
  const int limit = min(L, width + k - 1);
  const long long stride = rows * width;
  const uint32_t kmask = kFull >> (32 - k);
  unsigned u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  Unit cur;
  if (u < units)
    fetch_unit(codes, lengths, accept, u, units_a_row, L, limit, lane, cur);
  for (; u < units; u += step) {
    Unit next;  // in flight while this unit is hashed and stored
    if (u + step < units)
      fetch_unit(codes, lengths, accept, u + step, units_a_row, L, limit,
                 lane, next);
    uint32_t bits[4][kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint32_t c = cur.code[w];
      bits[0][w] = __brev(__ballot_sync(kFull, c == 0 || c == 3));
      bits[1][w] = __brev(__ballot_sync(kFull, c < 2));
      bits[2][w] = __brev(__ballot_sync(kFull, c == 0 || c == 2));
      bits[3][w] = __brev(__ballot_sync(kFull, c < 4));
    }
    const int j0 = cur.j0;
    uint32_t* out = keys + (long long)cur.row * width;
#pragma unroll
    for (int t = 0; t < kUnitTiles; ++t) {
      if (j0 + 32 * t >= width) break;  // the whole warp together
      const uint32_t w0 = window(bits[0][t], bits[0][t + 1], lane, k);
      const uint32_t w1 = window(bits[1][t], bits[1][t + 1], lane, k);
      const uint32_t w2 = window(bits[2][t], bits[2][t + 1], lane, k);
      const bool ok = window(bits[3][t], bits[3][t + 1], lane, k) == kmask;
      const uint32_t r0 = __brev(w0) >> (32 - k);
      const uint32_t r1 = __brev(~w1 & kmask) >> (32 - k);
      const uint32_t r2 = __brev(~w2 & kmask) >> (32 - k);
      const int j = j0 + 32 * t + lane;
      if (j >= width) continue;
      const bool live = ok && cur.accept && j <= cur.length - k;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c >= C) break;
        const uint32_t m0 = masks.m[c][0], m1 = masks.m[c][1],
                       m2 = masks.m[c][2];
        const uint32_t fwd = (w0 & m0) | (w1 & m1) | (w2 & m2);
        const uint32_t rev = (r0 & m0) | (r1 & m1) | (r2 & m2);
        __stcs(out + c * stride + j, live ? min(fwd, rev) : kSentinel);
      }
    }
    cur = next;
  }
}

__device__ __forceinline__ int8_t* table_of(const Tables& tabs, int c) {
  int8_t* t = tabs.t[0];
#pragma unroll
  for (int i = 1; i < kMaxC; ++i)
    if (c == i) t = tabs.t[i];
  return t;
}

// Add `add` to byte p of the word w as the plain version adds bytes: mod
// 256, no carry into another byte. `old` is the word before an atomic add
// of add << 8p that this thread made and that no other thread's update of
// w can have met (the word holds no other head of this launch): a carry
// out of byte p is taken back, so the word ends as that byte's sum.
__device__ __forceinline__ void undo_carry(unsigned* w, unsigned old, int p,
                                           unsigned add) {
  if (p < 3 && ((old >> (8 * p)) & 0xFFu) + add > 0xFFu)
    atomicAdd(w, 0u - (1u << (8 * p + 8)));
}

// The byte update where other heads share the word: compare and swap of
// the word with byte p replaced by its sum mod 256, so that the updates of
// one word's bytes commute.
__device__ __forceinline__ void cas_add(unsigned* w, int p, unsigned add) {
  unsigned old = __ldcg(w), seen;
  do {
    seen = old;
    const unsigned b = ((seen >> (8 * p)) + add) & 0xFFu;
    old = atomicCAS(w, seen, (seen & ~(0xFFu << (8 * p))) | (b << (8 * p)));
  } while (old != seen);
}

// Kernel K5 over C sorted key rows of n keys: a thread a key of row
// blockIdx.y.
__global__ void __launch_bounds__(kThreads)
    run_capped_update_kernel(const uint32_t* __restrict__ keys, long long n,
                             Tables tabs, int cap) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n || cap <= 0) return;  // cap 0 adds nothing
  const uint32_t* s = keys + blockIdx.y * n;
  const uint32_t h = __ldg(s + j);
  const uint32_t before = j > 0 ? __ldg(s + j - 1) : kSentinel;
  if (h == kSentinel || before == h) return;  // not a run's head
  // the run's end, read at most cap + kScan keys on, and the key after it
  // (h itself when the run goes on past what was read)
  const long long stop = min(n, j + cap + kScan);
  long long e = j + 1;
  while (e < stop && __ldg(s + e) == h) ++e;
  const uint32_t after = e < n ? __ldg(s + e) : kSentinel;
  const unsigned run = (unsigned)min(e - j, (long long)cap);
  // only the runs just before and after h can hold keys of h's 4 bytes
  const bool shared =
      (before != kSentinel && (before >> 2) == (h >> 2)) ||
      (after != kSentinel && (after >> 2) == (h >> 2));
  unsigned* w = reinterpret_cast<unsigned*>(table_of(tabs, blockIdx.y) +
                                            (h & ~3u));
  if (shared) {
    cas_add(w, h & 3u, run);
  } else {
    const unsigned old = atomicAdd(w, run << (8 * (h & 3u)));
    undo_carry(w, old, h & 3u, run);
  }
}

#ifdef LHT_KMER_PROBE
// What the card takes to touch K5's table sectors: one byte
// read-modify-write a run head, one thread a head. tune_kmer.py builds it
// (-DLHT_KMER_PROBE) and times it; no path of the package launches it.
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const uint32_t* __restrict__ heads, long long n,
                 int8_t* __restrict__ table, int red) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const uint32_t h = heads[j];
  if (red)  // one atomic add at the L2 whose result is not read
    atomicAdd(reinterpret_cast<unsigned*>(table + (h & ~3u)),
              1u << (8 * (h & 3u)));
  else
    table[h] = (int8_t)(table[h] + 1);
}
#endif

// Blocks for `threads` threads; 0 when the grid would not fit.
unsigned blocks_for(long long threads) {
  const long long b = (threads + kThreads - 1) / kThreads;
  return b <= 0x7FFFFFFF ? (unsigned)b : 0u;
}

// Persistent blocks for `warps` warps of work: as many as the card holds
// at once, no more than the work needs.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, long long warps, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) per_sm = 1;
  long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  *grid = (unsigned)(blocks < 1 ? 1 : blocks);
  return cudaSuccess;
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
  kmer_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      codes, rows, L, tiles, k, C, masks, hashes, valid);
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
  const int units_a_row = (width + 32 * kUnitTiles - 1) / (32 * kUnitTiles);
  if (rows * units_a_row >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  const cudaError_t e =
      persistent_grid(count_keys_kernel, rows * units_a_row, &grid);
  if (e != cudaSuccess) return (int)e;
  count_keys_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      codes, rows, L, width, (unsigned)units_a_row, k, C, masks, lengths,
      accept, keys);
  return (int)cudaGetLastError();
}

// keys: C sorted rows of n 32-bit keys, one after the other; tables_host:
// C device pointers (in host memory) to int8 tables of 2^k entries, table
// c for row c.
extern "C" int lht_kmer_run_capped_update(const uint32_t* keys, int C,
                                          long long n,
                                          const uint64_t* tables_host,
                                          int cap, void* stream) {
  if (C < 1 || C > kMaxC || n < 1 || cap < 0)
    return (int)cudaErrorInvalidValue;
  Tables tabs = {};
  for (int c = 0; c < C; ++c) tabs.t[c] = (int8_t*)tables_host[c];
  const unsigned grid = blocks_for(n);
  if (!grid) return (int)cudaErrorInvalidValue;
  run_capped_update_kernel<<<dim3(grid, C), kThreads, 0,
                             (cudaStream_t)stream>>>(keys, n, tabs, cap);
  return (int)cudaGetLastError();
}

#ifdef LHT_KMER_PROBE
// heads: n table indices; table int8 [2^k].
extern "C" int lht_kmer_probe(const uint32_t* heads, long long n,
                              int8_t* table, int red, void* stream) {
  const unsigned grid = blocks_for(n);
  if (n < 1 || !grid) return (int)cudaErrorInvalidValue;
  probe_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(heads, n, table,
                                                          red);
  return (int)cudaGetLastError();
}
#endif
