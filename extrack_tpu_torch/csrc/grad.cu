// K2: per-track log likelihood and its exact gradient w.r.t. the model
// tables and the localization-error variances.
//
// Replaces the TPU kernel extrack_tpu/ops/pallas_grad.py:_grad_kernel
// (driven by _grad_call, the forward rule of neg_log_likelihood's custom
// VJP).  Its pullbacks are the hand-derived ones of interior_bwd :372 and
// close_look_bwd :189, plus a hand-derived pullback of the 2-frame closing
// (close_l2 :138, traced with jax.vjp on the TPU).
//
// What bounds it on Hopper: as for K1, instruction throughput and
// latency, not device memory; the walk runs the forward once and replays
// each step once more on the way back, from each step's entering carry
// ((T-1) * (2D+1) * K floats per track, 11.5 KB at S=2, W=6, D=2, T=10).
// Everything else of a step (update, fusion weights) is recomputed from
// the carry.  Two mappings (grad.cuh), picked per launch by the host
// (ops/grad_kernel.plan):
//   * warp mapping, K <= 64 (the fit's windows at 2 states, and S=3 up to
//     W=3): one warp per track, several tracks per block, each lane owning
//     one or two slots.  Fusion steps trade through the warp's slice of
//     shared memory between __syncwarp()s and every reduction over the
//     slots is a warp shuffle, so the walk has no block barrier (the
//     block mapping spends eight per backward step at K=64, D=2).  The
//     carry history sits in the warp's slice of shared memory when the
//     block's slices fit the card's opt-in limit, else in global scratch.
//   * block mapping, any K up to 1024: one block per track, one thread per
//     slot, block reductions, the carry history in global scratch.
// Blocks are persistent in both: block i (warp w) walks tracks i, i+grid,
// ..., so global scratch is one history per block (warp) however many
// tracks there are, and the host sizes the grid to the card's residency
// and a fixed byte budget.
//
// Table cotangents: each thread sums its own slots' (K,) cotangents in
// registers and its (K, A) rows in its block's slice of a partial buffer
// (warp mapping: its warp's shared-memory slice, summed over the warps in
// warp order at the end), over all of the block's tracks.  A second kernel
// adds the per-block partials in block order, in double, so a fit is
// repeatable from run to run (no atomics).
//
// The walk itself is grad.cuh's template, instantiated here on float; K3
// (hvp.cu) instantiates the same template on dual numbers.
#include "grad.cuh"

// Inputs as extrack_forward.  Outputs: logl (B,); ct_l2 (B, T, D), zeroed
// by the caller (rows past a track's length are not written); ct_tab
// (6K + 4KA,) = d(sum logL)/d(lp0, s20, lt, lsurv, endv, sig2v, ltn, s2n,
// lsn, endn) in that order.  Mapping: warps = 0 for the block mapping,
// else the warp mapping with `warps` (1..4) warps per block (K <= 64);
// stash_smem = 1 keeps the warp mapping's carry history in shared memory.
// Scratch: stash, unless stash_smem, one (T-1)*(2D+1)*K-float history per
// block (block mapping) or per warp (nblk*warps of them); partial
// nblk*(6K + 4KA) floats.  Returns cudaGetLastError().
extern "C" int extrack_grad(const float* xs, const float* l2,
                            const int* lengths, const float* isbl,
                            const float* lp0, const float* s20,
                            const float* lt, const float* lsurv,
                            const float* endv, const float* sig2v,
                            const float* ltn, const float* s2n,
                            const float* lsn, const float* endn, float* logl,
                            float* ct_l2, float* ct_tab, float* stash,
                            float* partial, int B, int T, int D, int K, int A,
                            int min_len, int nblk, int warps, int stash_smem,
                            void* stream) {
  const float* tabs[10] = {lp0, s20, lt, lsurv, endv,
                           sig2v, ltn, s2n, lsn, endn};
  return extrack::launch_grad_c<float>(xs, l2, lengths, isbl, tabs, logl,
                                       ct_l2, ct_tab, stash, partial, B, T,
                                       D, K, A, min_len, nblk, warps,
                                       stash_smem, stream);
}

// Blocks of one K2 launch (arguments as extrack_grad's) that one SM keeps
// resident, or -(CUDA error).
extern "C" int extrack_grad_occupancy(int D, int K, int A, int T, int warps,
                                      int stash_smem) {
  return extrack::grad_occupancy_c<float>(D, K, A, T, warps, stash_smem);
}

// Dynamic shared memory one block of the warp mapping may opt in to on
// `device` (as extrack_predict_smem); K3's is the same.
extern "C" int extrack_grad_smem(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr,
                                extrack::grad_warp_kernel<float, 2, 2>);
  if (err != cudaSuccess) return -(int)err;
  return optin - (int)attr.sharedSizeBytes;
}

#ifdef EXTRACK_PROFILE
// Profile builds only: copies K2's cycle split (kProfSlots counters, grad.cuh)
// to `out` and zeroes it on the card.
extern "C" int extrack_grad_prof(unsigned long long* out) {
  static const unsigned long long zero[extrack::kProfSlots] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, extrack::g_prof, sizeof zero);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(extrack::g_prof, zero, sizeof zero);
  return (int)err;
}
#endif
