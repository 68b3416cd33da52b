// K1: per-track log likelihood of the sequence-register recursion.
//
// Replaces the TPU kernel extrack_tpu/ops/pallas_engine.py:_kernel (driven
// by forward_pallas, and by pallas_grad._value_call for value-only fit
// evaluations).
//
// What bounds it on Hopper: not device memory.  A track reads T*D
// positions and T*D variances once (16 B per frame at D = 2) and writes one
// float, while its walk does ~T * K * (20 + 8A) operations with A exps a
// slot and step.  The walk is a chain of short dependent steps, so latency
// and instruction issue bound it.  The design (walk.cuh, shared with K4):
// one warp per track at K <= 64 (no block barrier, reductions by warp
// shuffles, the next track's rows fetched by cp.async during the current
// walk: with one cold block per track, the loads before the first step
// took 42% of the cycles on an H100), persistent blocks, the slot tables
// in registers, the base-2 fusion on the special-function unit and a
// one-pass closing; one persistent block per track above 64 slots, a
// thread a fusion group up to 65536 (walk.cuh's wide mapping: the carries
// in shared memory as the groups' fused Gaussians, or in the block's
// global scratch where they pass what a block may opt in to; the tables
// read through L1).
// Tracks are independent, so nothing is reduced across teams and the
// result is bitwise repeatable.
//
// Variable dt (per-track or per-step intervals): the displacement
// variances come from a (B, T-1, P) stream, read from the team's shared
// slice (warp mapping, prefetched with the positions) or global memory
// (wide mapping) where the constant path reads its tables (walk.cuh).
#include "walk.cuh"

namespace extrack {

static __device__ unsigned long long g_forward_prof[kProfSlots];

}  // namespace extrack

// xs, l2: (B, T, D) float32; lengths int32 (B,); isbl float32 (B,); the
// (K,) and (K, A) tables as in extrack::Tables; sig2s: with P > 0
// (variable dt, P = S^(n+1)) the (B, T-1, P) float32 displacement
// variances, which replace s20, sig2v and s2n (null for P = 0); logl
// float32 (B,).  nblk persistent blocks; warps > 0: the warp mapping with
// that many warps a block (K <= 64), -1: the wide mapping, -2: the wide
// mapping with its publish areas in `scratch`, 2 * (2D+1) * K/A floats a
// block (null otherwise; the wrapper holds K1 to K <= 65536 and 16384
// fusion groups; K1 has no block mapping).  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int extrack_forward(const float* xs, const float* l2,
                               const int* lengths, const float* isbl,
                               const float* lp0, const float* s20,
                               const float* lt, const float* lsurv,
                               const float* endv, const float* sig2v,
                               const float* ltn, const float* s2n,
                               const float* lsn, const float* endn,
                               const float* sig2s, float* logl,
                               float* scratch, int B, int T, int D, int K,
                               int A, int P, int min_len, int nblk,
                               int warps, void* stream) {
  const extrack::Tables tb{lp0, s20, lt,  lsurv, endv, sig2v, ltn,
                           s2n, lsn, endn, K,    A,    min_len};
  const extrack::WalkArgs wa{tb,   xs,      l2,      lengths, isbl,
                             B,    T,       A,       0,       logl,
                             nullptr, scratch, 0,    sig2s,   P};
  unsigned long long* prof = nullptr;
#ifdef EXTRACK_PROFILE
  cudaGetSymbolAddress((void**)&prof, extrack::g_forward_prof);
#endif
  return extrack::launch_walk<false>(wa, D, nblk, warps, prof,
                                     static_cast<cudaStream_t>(stream));
}

// One K1 team for a launch (warps > 0: a warp of the warp mapping, -1: a
// block of the wide mapping, -2: one of the wide mapping with its publish
// areas in global scratch; P > 0: variable dt): out = threads a block,
// shared bytes a team, global scratch bytes a team (at -2: the publish
// areas).
extern "C" int extrack_forward_layout(int T, int D, int K, int A, int warps,
                                      int P, long long* out) {
  if (D < 1 || D > 3 || warps < -2 || warps == 0 || (warps > 0 && K > 64) ||
      K > (warps < 0 ? extrack::kWideMaxK : 64) || A < 1 || K % A != 0)
    return (int)cudaErrorInvalidValue;
  const extrack::WalkLayout lay =
      extrack::team_layout(warps, K, A, D, T, A, 0, false, P);
  out[0] = lay.threads;
  out[1] = (long long)lay.fixed;
  out[2] = (long long)lay.stash;
  return 0;
}

// Blocks of a K1 launch one SM keeps resident (warps and P as
// extrack_forward), or a CUDA error code, negated.
extern "C" int extrack_forward_occupancy(int D, int K, int A, int T,
                                         int warps, int P) {
  return extrack::walk_occupancy<false>(D, K, A, T, A, 0, warps, 0, P);
}

// Reads and zeroes K1's cycle split (profile builds; zeros otherwise).
extern "C" int extrack_forward_prof(unsigned long long* out) {
  unsigned long long zero[extrack::kProfSlots] = {};
  cudaError_t err =
      cudaMemcpyFromSymbol(out, extrack::g_forward_prof, sizeof zero);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(extrack::g_forward_prof, zero, sizeof zero);
  return (int)err;
}

extern "C" const char* extrack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
