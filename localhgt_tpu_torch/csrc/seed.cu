// The seed prefilter of the align stage for Hopper (sm_90a): kernel K6.
//
// It replaces no Pallas kernel. Its counterpart is the XLA program `pf`
// that localhgt_tpu/pipeline/align.py:367-394 jits (reached through
// seed_prefilter_device), one dispatch a read batch and mate.
//
// `lht_seed_prefilter`: for codes uint8 [B, L] (A, C, G, T = 0..3, any
// other value a non-base), lengths int32 [B] and the prefix bitmap int32
// [2^27] that pipeline/align.py::prefix_bitmap builds, out[b] = 1 iff
// some window start j <= min(lengths[b], L) - 16 has no non-base among
// codes[b, j..j+15] and its forward hash hf = sum (c[j+z] & 3) << 2(15-z)
// or its reverse-complement hash hr = sum ((3 - c[j+z]) & 3) << 2z has
// its bit set, (bitmap[h >> 5] >> (h & 31)) & 1 read as unsigned: what
// pipeline/align.py::seed_prefilter_plain computes. The result is an OR
// over the windows, so neither the order of the probes nor stopping at
// the first hit changes it.
//
// What bounds it on an H100: bytes, and of the kind the card moves worst.
// Every window of four bases makes two probes into a 512 MiB bitmap, ten
// times the 50 MB L2, at addresses the hash scatters: each probe reads a
// 32-byte sector of device memory for one bit. At `bkp`'s batch (65,536
// reads of 150 bp padded to 192) that is about 17.7 M probes on nearly as
// many distinct sectors, against 9.8 MB of codes. The integer work is a
// few dozen operations a window. So the design keeps all but the probes
// in registers and keeps many probes in flight:
// - A warp a read, 8 reads a block. It takes the read's windows 32 at a
//   time (a tile): lane l's window of tile t starts at j = 32t + l. A lane
//   loads one code of each 32 positions (coalesced byte loads, each code
//   read once), and one ballot a bit (c & 1, c & 2, c > 3) gives a stream
//   of 32 positions as one word, `__brev` puts the first position at the
//   top. A tile's windows cover its 32 positions and the next 32, whose
//   ballots the next tile reuses; one funnel shift gives the lane its
//   window's 16 bits of a stream, as K4 does (csrc/kmer.cu). A position at
//   or past the read's length counts as a non-base, so a window past the
//   last start is never valid and needs no compare of its own.
// - hf interleaves the two 16-bit windows (a Morton spread); hr is hf
//   complemented, bit-reversed and with each 2-bit pair swapped back.
// - A valid window issues its two loads together (read-only path), and
//   `__any_sync` ends the read at the first tile that hits. The next
//   tile's code load is issued before this tile's probes.
// - 65,536 reads are 8,192 blocks; 64 warps an SM keep up to 4,096 probes
//   an SM in flight, far more than the card's memory latency needs.
//
// `lht_seed_probe`, built only with -DLHT_SEED_PROBE (tune_seed.py, on no
// path of the package), takes the same arguments and makes the same two
// loads a window start j <= min(lengths[b], L) - 16, with the same early
// exit, at addresses a multiplicative hash of (b, j) scatters, reading no
// code: the floor of the random sectors without the window hashing.
//
// Each entry point launches on the given stream, synchronises nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWin = 16;             // bases a window (PREFILTER_LEN)
constexpr int kThreads = 256;        // 8 warps a block, a warp a read
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kEven = 0x55555555u;

// The 16 bits of a stream's window at j0 + lane, where positions j0 ..
// j0 + 63 sit MSB first in (hi, lo): position j0 + lane + z at bit 15 - z.
__device__ __forceinline__ uint32_t window16(uint32_t hi, uint32_t lo,
                                             int lane) {
  return __funnelshift_l(lo, hi, lane) >> 16;
}

// Bit i of a 16-bit x to bit 2i.
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & kEven;
}

// Is the bit of hash h set in the bitmap, given its word w?
__device__ __forceinline__ uint32_t bit_of(uint32_t w, uint32_t h) {
  return (w >> (h & 31)) & 1u;
}

// Kernel K6: out[row] for rows warp by warp.
__global__ void __launch_bounds__(kThreads)
    seed_prefilter_kernel(const uint8_t* __restrict__ codes, int B, int L,
                          const int32_t* __restrict__ lengths,
                          const uint32_t* __restrict__ bitmap,
                          uint8_t* __restrict__ out) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const uint8_t* r = codes + (long long)row * L;
  const int lim = min(lengths[row], L);  // a non-base from here on
  // the tile's first 32 positions, as three streams
  uint32_t c = lane < lim ? r[lane] : 4u;
  uint32_t h0 = __brev(__ballot_sync(kFull, c & 1u));
  uint32_t h1 = __brev(__ballot_sync(kFull, c & 2u));
  uint32_t hn = __brev(__ballot_sync(kFull, c > 3u));
  c = 32 + lane < lim ? r[32 + lane] : 4u;
  for (int j0 = 0; j0 <= lim - kWin; j0 += 32) {
    // the tile's second 32 positions
    const uint32_t l0 = __brev(__ballot_sync(kFull, c & 1u));
    const uint32_t l1 = __brev(__ballot_sync(kFull, c & 2u));
    const uint32_t ln = __brev(__ballot_sync(kFull, c > 3u));
    const int p = j0 + 64 + lane;  // the next tile's, in flight meanwhile
    c = p < lim ? r[p] : 4u;

    uint32_t hit = 0;
    if (window16(hn, ln, lane) == 0) {  // 16 bases
      const uint32_t hf = (spread(window16(h1, l1, lane)) << 1) |
                          spread(window16(h0, l0, lane));
      // ~hf reversed holds base z's pair at bits 2z, 2z + 1, swapped
      const uint32_t t = __brev(~hf);
      const uint32_t hr = ((t >> 1) & kEven) | ((t & kEven) << 1);
      const uint32_t wf = __ldg(bitmap + (hf >> 5));
      const uint32_t wr = __ldg(bitmap + (hr >> 5));
      hit = bit_of(wf, hf) | bit_of(wr, hr);
    }
    if (__any_sync(kFull, hit)) {
      if (lane == 0) out[row] = 1;
      return;
    }
    h0 = l0;
    h1 = l1;
    hn = ln;
  }
  if (lane == 0) out[row] = 0;
}

#ifdef LHT_SEED_PROBE
// The probe: K6's loads and early exit at scattered addresses, no codes.
__global__ void __launch_bounds__(kThreads)
    seed_probe_kernel(int B, int L, const int32_t* __restrict__ lengths,
                      const uint32_t* __restrict__ bitmap,
                      uint8_t* __restrict__ out) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;
  const int lane = threadIdx.x & 31;
  const int lim = min(lengths[row], L);
  for (int j0 = 0; j0 <= lim - kWin; j0 += 32) {
    const int j = j0 + lane;
    uint32_t hit = 0;
    if (j <= lim - kWin) {
      const uint32_t x = (uint32_t)row * 193u + (uint32_t)j;
      const uint32_t hf = x * 0x9E3779B1u;
      const uint32_t hr = (x ^ 0x5BD1E995u) * 0x85EBCA6Bu;
      hit = bit_of(__ldg(bitmap + (hf >> 5)), hf) |
            bit_of(__ldg(bitmap + (hr >> 5)), hr);
    }
    if (__any_sync(kFull, hit)) {
      if (lane == 0) out[row] = 1;
      return;
    }
  }
  if (lane == 0) out[row] = 0;
}
#endif

int blocks_for(int B) { return (B + kWarps - 1) / kWarps; }

}  // namespace

extern "C" int lht_seed_prefilter(const uint8_t* codes, int B, int L,
                                  const int32_t* lengths,
                                  const int32_t* bitmap, uint8_t* out,
                                  cudaStream_t stream) {
  if (B > 0) {
    seed_prefilter_kernel<<<blocks_for(B), kThreads, 0, stream>>>(
        codes, B, L, lengths, reinterpret_cast<const uint32_t*>(bitmap),
        out);
  }
  return (int)cudaGetLastError();
}

#ifdef LHT_SEED_PROBE
extern "C" int lht_seed_probe(const uint8_t* codes, int B, int L,
                              const int32_t* lengths, const int32_t* bitmap,
                              uint8_t* out, cudaStream_t stream) {
  (void)codes;
  if (B > 0) {
    seed_probe_kernel<<<blocks_for(B), kThreads, 0, stream>>>(
        B, L, lengths, reinterpret_cast<const uint32_t*>(bitmap), out);
  }
  return (int)cudaGetLastError();
}
#endif
