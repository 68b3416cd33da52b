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
// the carry.  Three mappings (grad.cuh), picked per launch by the host
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
//   * wide mapping, 1024 < K <= 65536 with at most 16384 fusion groups
//     (any K when forced): a cluster of C blocks (1 to 16, on
//     neighbouring SMs) per track, a thread one or two fusion groups (K1's
//     wide walk, walk.cuh; grad_cluster_kernel).  The history is the
//     fused groups of each step ((T-3) * (2D+1) * K/A scalars a track, in
//     the cluster's global scratch); the backward trades the members'
//     carry cotangents through a (2D+1)*K exchange split over the
//     cluster's shared memory (distributed shared memory), in global
//     scratch where a block's slice does not fit; the closings deal
//     members, not groups, over the threads, for coalesced (K, A) reads
//     and adds.  The JAX package runs its XLA engine there
//     (extrack_tpu/fit.py:104-119, past pallas_grad.supports).
// Blocks (clusters) are persistent in all three: block i (warp w, cluster
// c) walks tracks i, i+grid, ..., so global scratch is one history per
// block (warp, cluster) however many tracks there are, and the host sizes
// the grid to the card's residency and the card's free memory (every such
// buffer counted: history, exchange, partial row).
//
// Table cotangents: each thread sums its own slots' (K,) cotangents in
// registers and its (K, A) rows in its block's slice of a partial buffer
// (warp mapping: its warp's shared-memory slice, summed over the warps in
// warp order at the end), over all of the block's tracks.  A second kernel
// adds the per-block partials in block order, in double, so a fit is
// repeatable from run to run (no atomics).
//
// Variable dt (per-track or per-step intervals): the walk reads a
// (B, T-1, P) stream of displacement variances and writes its cotangent,
// (B, T-1, P), in place of the s20, sig2v and s2n tables' (grad.cuh).
//
// The walk itself is grad.cuh's template, instantiated here on float; K3
// (hvp.cu) instantiates the same template on dual numbers.
#include "grad.cuh"

// Inputs as extrack_forward.  Outputs: logl (B,); ct_l2 (B, T, D), zeroed
// by the caller (rows past a track's length are not written); ct_tab
// (6K + 4KA,) = d(sum logL)/d(lp0, s20, lt, lsurv, endv, sig2v, ltn, s2n,
// lsn, endn) in that order; with P > 0 (variable dt) ct_s2 (B, T-1, P) =
// d(sum logL)/d(sig2s), zeroed by the caller (rows from a track's length
// on are not written), and the s20, sig2v and s2n columns of ct_tab are
// 0.  Mapping: warps = 0 for the block mapping, -1 for the wide mapping
// with `cluster` blocks a cluster (-2: its exchange in global scratch),
// else the warp mapping with `warps` (1..4) warps per block (K <= 64);
// stash_smem = 1 keeps the warp mapping's carry history in shared memory;
// cluster is 1 but on the wide mapping, and nblk a multiple of it there.
// Scratch: stash, unless stash_smem, one (T-1)*(2D+1)*K-float history per
// block (block mapping) or per warp (nblk*warps of them), or a cluster's
// (extrack_grad_layout); partial (nblk / cluster)*(6K + 4KA) floats.
// Returns cudaGetLastError().
extern "C" int extrack_grad(const float* xs, const float* l2,
                            const int* lengths, const float* isbl,
                            const float* lp0, const float* s20,
                            const float* lt, const float* lsurv,
                            const float* endv, const float* sig2v,
                            const float* ltn, const float* s2n,
                            const float* lsn, const float* endn,
                            const float* sig2s, float* logl, float* ct_l2,
                            float* ct_tab, float* ct_s2, float* stash,
                            float* partial, int B, int T, int D, int K, int A,
                            int P, int min_len, int nblk, int warps,
                            int stash_smem, int cluster,
                            void* stream) {
  const float* tabs[10] = {lp0, s20, lt, lsurv, endv,
                           sig2v, ltn, s2n, lsn, endn};
  return extrack::launch_grad_c<float>(
      xs, l2, lengths, isbl, tabs, sig2s, logl, ct_l2, ct_tab, ct_s2, stash,
      partial, B, T, D, K, A, P, min_len, nblk, warps, stash_smem, cluster,
      stream);
}

// Blocks of one K2 launch on the warp or block mapping (arguments as
// extrack_grad's) that one SM keeps resident, or -(CUDA error).
extern "C" int extrack_grad_occupancy(int D, int K, int A, int T, int warps,
                                      int stash_smem, int P) {
  return extrack::grad_occupancy_c<float>(D, K, A, T, warps, stash_smem, P);
}

// Clusters of `cluster` blocks of one K2 launch on the wide mapping (warps
// -1 or -2) that the card keeps resident at once, or -(CUDA error).
extern "C" int extrack_grad_cluster_occupancy(int D, int K, int A, int T,
                                              int warps, int cluster,
                                              int P) {
  return extrack::grad_cluster_occupancy_c<float>(D, K, A, T, warps, cluster,
                                                  P);
}

// One block of the wide mapping (warps -1 or -2) in a cluster of `cluster`
// blocks, for scalars of `itemsize` bytes (4: K2, 8: K3's dual numbers):
// out[0] threads, out[1] dynamic shared bytes, out[2] the cluster's
// global scratch bytes (grad_wide_layout).
extern "C" int extrack_grad_layout(int K, int A, int D, int T, int warps,
                                   int cluster, int itemsize,
                                   long long* out) {
  if (D < 1 || D > 3 || A < 1 || K % A != 0 || cluster < 1 ||
      cluster > extrack::kGradClusterMax || (warps != -1 && warps != -2))
    return (int)cudaErrorInvalidValue;
  const extrack::GradWideLayout lay = extrack::grad_wide_layout(
      K, A, D, T, cluster, warps == -2, (size_t)itemsize);
  out[0] = lay.threads;
  out[1] = (long long)lay.smem;
  out[2] = (long long)lay.scratch;
  return 0;
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
                                extrack::grad_warp_kernel<float, 2, 2, false>);
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
