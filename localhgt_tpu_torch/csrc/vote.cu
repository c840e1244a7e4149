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
// Mapping: one thread per pair, the register (G slots of genome, count,
// pid, stamp) in registers, a sequential loop over P*C. Input is
// position-major [P*C, B], so neighbouring threads read neighbouring pairs
// and every load is coalesced. Each pair reads 8*P*C bytes once and does
// O(G) compares per candidate, so the kernel is bound by device-memory
// bandwidth on the two candidate streams (~400 MB at B=65536, P=256, C=3).
//
// Launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int G = 8;  // register slots, the vote's n_slots

__global__ void __launch_bounds__(kThreads)
vote_kernel(const int32_t* __restrict__ cg, const int32_t* __restrict__ cp,
            int32_t* __restrict__ og, int32_t* __restrict__ oc,
            int32_t* __restrict__ op, int32_t* __restrict__ oh, long long B,
            int P, int C) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  int sg[G], sc[G], sp[G], st[G];
#pragma unroll
  for (int s = 0; s < G; ++s) sg[s] = sc[s] = sp[s] = st[s] = 0;
  int hits = 0;
  long long row = b;
  for (int p = 0; p < P; ++p) {
    int sel_g = 0, sel_cnt = 0, sel_p = 0;
    for (int c = 0; c < C; ++c, row += B) {
      const int pk = cp[row];
      if (pk == 0) continue;
      const int g = cg[row];
      bool seen = false;
      int cnt = 0;
#pragma unroll
      for (int s = 0; s < G; ++s) {
        if (sg[s] == g && sg[s] != 0) {
          seen = true;
          cnt = sc[s] > cnt ? sc[s] : cnt;
        }
      }
      if (seen) {
        if (cnt >= sel_cnt) {
          sel_g = g;
          sel_p = pk;
          sel_cnt = cnt;
        }
      } else if (sel_p == 0) {
        sel_g = g;
        sel_p = pk;
        sel_cnt = 0;
      }
    }
    if (sel_p == 0) continue;
    ++hits;
    bool have = false;
#pragma unroll
    for (int s = 0; s < G; ++s) {
      if (sg[s] == sel_g && sg[s] != 0) {
        ++sc[s];
        have = true;
      }
    }
    if (have) continue;
    // victim: first empty slot, else the first slot holding the newest
    // stamp among count-1 slots; none when every slot has count > 1
    int victim = -1;
#pragma unroll
    for (int s = G - 1; s >= 0; --s)
      if (sg[s] == 0) victim = s;
    if (victim < 0) {
      int newest = -1;
#pragma unroll
      for (int s = 0; s < G; ++s) {
        if (sc[s] == 1 && st[s] > newest) {
          newest = st[s];
          victim = s;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < G; ++s) {
      if (s == victim) {
        sg[s] = sel_g;
        sc[s] = 1;
        sp[s] = sel_p;
        st[s] = p + 1;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < G; ++s) {
    og[b * G + s] = sg[s];
    oc[b * G + s] = sc[s];
    op[b * G + s] = sp[s];
  }
  oh[b] = hits;
}

}  // namespace

extern "C" int lht_vote_state(const int32_t* cg, const int32_t* cp,
                              int32_t* og, int32_t* oc, int32_t* op,
                              int32_t* oh, long long B, int P, int C,
                              int n_slots, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((B + kThreads - 1) / kThreads)), block(kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (n_slots != G) return (int)cudaErrorInvalidValue;
  vote_kernel<<<grid, block, 0, s>>>(cg, cp, og, oc, op, oh, B, P, C);
  return (int)cudaGetLastError();
}
