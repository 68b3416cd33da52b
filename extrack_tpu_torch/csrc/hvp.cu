// K3: exact Hessian-vector products of the log likelihood: K2's outputs
// and their directional derivatives along a tangent of every input table
// and of the localization-error variances.
//
// Replaces the TPU kernel extrack_tpu/ops/pallas_hvp.py:_hvp_kernel
// (driven by _hvp_call, the tangent rule of table_grads' custom JVP).
// Like the TPU kernel, it derives nothing by hand: it is K2's walk
// (grad.cuh) instantiated on dual numbers (dual.cuh), so forward mode runs
// through K2's own forward walk, carry history, hand-derived pullbacks and
// partial reduction.  The max shifts of the exp-sums carry a zero tangent
// (the shift cancels), the 1e-30 sum guard and the log floors carry zero
// tangents on their clamped side, and the guard's indicator is constant.
//
// What bounds it on Hopper: as K2, instruction throughput and latency;
// every operation of the walk becomes about three (value, product rule),
// and the live state and the carry history double (2 * (T-1) * (2D+1) * K
// floats per track, 48.6 KB at S=2, W=6, D=2, T=20).  It runs any of
// K2's three mappings (grad.cu), as ops/hvp_kernel picks; the envelope is
// K2's (K <= 65536 and 16384 fusion groups: past 1024 slots the wide
// mapping, a cluster of blocks a track, whose exchange of carry
// cotangents, split over the cluster's shared memory, takes a block up to
// 229,376 bytes at 4^8 and D = 3 as dual numbers in clusters of 16).
// Past 1024 slots the JAX package takes extrack_tpu/fit.py:575-582
// (hessian_chunked on XLA).
// The tangent columns are reduced with K2's deterministic block-order
// (cluster-order) partial sums, so a Hessian is repeatable from run to
// run.  It runs once
// per Hessian column at the end of a fit, never inside the optimizer loop.
#include "grad.cuh"

// Arguments as extrack_grad, with every Real array as interleaved (value,
// tangent) float pairs: l2 (B, T, D, 2); each table (K, 2) or (K, A, 2);
// variable dt: sig2s (B, T-1, P, 2), the stream with its tangent, and
// ct_s2 (B, T-1, P, 2), its cotangent with the cotangent's tangent,
// zeroed by the caller; outputs logl (B, 2), ct_l2 (B, T, D, 2) zeroed by
// the caller, ct_tab (6K + 4KA, 2); scratch stash (unless stash_smem) one
// (T-1)*(2D+1)*K*2-float history per block or warp and partial
// nblk*(6K + 4KA)*2 floats; warps and stash_smem as extrack_grad's.
// Positions, lengths and the bleaching flags carry no tangent.  Returns
// cudaGetLastError().
extern "C" int extrack_hvp(const float* xs, const float* l2,
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
  return extrack::launch_grad_c<extrack::Dual>(
      xs, l2, lengths, isbl, tabs, sig2s, logl, ct_l2, ct_tab, ct_s2, stash,
      partial, B, T, D, K, A, P, min_len, nblk, warps, stash_smem, cluster,
      stream);
}

// Blocks of one K3 launch that one SM keeps resident (as
// extrack_grad_occupancy).
extern "C" int extrack_hvp_occupancy(int D, int K, int A, int T, int warps,
                                     int stash_smem, int P) {
  return extrack::grad_occupancy_c<extrack::Dual>(D, K, A, T, warps,
                                                  stash_smem, P);
}

// Clusters of one K3 launch on the wide mapping that the card keeps
// resident at once (as extrack_grad_cluster_occupancy).
extern "C" int extrack_hvp_cluster_occupancy(int D, int K, int A, int T,
                                             int warps, int cluster, int P) {
  return extrack::grad_cluster_occupancy_c<extrack::Dual>(D, K, A, T, warps,
                                                          cluster, P);
}

#ifdef EXTRACK_PROFILE
// Profile builds only: K3's cycle split (as extrack_grad_prof), then zeroed.
extern "C" int extrack_hvp_prof(unsigned long long* out) {
  static const unsigned long long zero[extrack::kProfSlots] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, extrack::g_prof, sizeof zero);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(extrack::g_prof, zero, sizeof zero);
  return (int)err;
}
#endif
