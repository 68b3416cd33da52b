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
// floats per track, 48.6 KB at S=2, W=6, D=2, T=20).  It runs either of
// K2's mappings (grad.cu), as ops/hvp_kernel picks; the envelope is K2's
// (K <= 1024).
// The tangent columns are reduced with K2's deterministic block-order
// partial sums, so a Hessian is repeatable from run to run.  It runs once
// per Hessian column at the end of a fit, never inside the optimizer loop.
#include "grad.cuh"

// Arguments as extrack_grad, with every Real array as interleaved (value,
// tangent) float pairs: l2 (B, T, D, 2); each table (K, 2) or (K, A, 2);
// outputs logl (B, 2), ct_l2 (B, T, D, 2) zeroed by the caller, ct_tab
// (6K + 4KA, 2); scratch stash (unless stash_smem) one
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
                           const float* lsn, const float* endn, float* logl,
                           float* ct_l2, float* ct_tab, float* stash,
                           float* partial, int B, int T, int D, int K, int A,
                           int min_len, int nblk, int warps, int stash_smem,
                           void* stream) {
  const float* tabs[10] = {lp0, s20, lt, lsurv, endv,
                           sig2v, ltn, s2n, lsn, endn};
  return extrack::launch_grad_c<extrack::Dual>(
      xs, l2, lengths, isbl, tabs, logl, ct_l2, ct_tab, stash, partial, B, T,
      D, K, A, min_len, nblk, warps, stash_smem, stream);
}

// Blocks of one K3 launch that one SM keeps resident (as
// extrack_grad_occupancy).
extern "C" int extrack_hvp_occupancy(int D, int K, int A, int T, int warps,
                                     int stash_smem) {
  return extrack::grad_occupancy_c<extrack::Dual>(D, K, A, T, warps,
                                                  stash_smem);
}
