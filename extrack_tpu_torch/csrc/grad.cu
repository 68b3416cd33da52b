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
// barriers, not device memory; the walk runs the forward once and replays
// each step once more on the way back.  The backward needs each step's
// entering carry.  At (T-1) * (2D+1) * K floats per track (11.5 KB at S=2,
// W=6, D=2, T=10) the history cannot live in shared memory, so it goes to
// a global scratch buffer.  Blocks are persistent: block i walks tracks i,
// i+grid, ..., so
// the scratch is grid * (T-1) * (2D+1) * K floats however many tracks there
// are, and the host sizes the grid to a fixed byte budget.  Everything
// else of a step (update, fusion weights) is recomputed from the carry.
//
// Table cotangents: each thread sums its own slot's (K,) cotangents in
// registers and its (K, A) rows in its block's slice of a partial buffer,
// over all of the block's tracks.  A second kernel adds the per-block
// partials in block order, in double, so a fit is repeatable from run to
// run (no atomics).
//
// The walk itself is grad.cuh's template, instantiated here on float; K3
// (hvp.cu) instantiates the same template on dual numbers.
#include "grad.cuh"

// Inputs as extrack_forward.  Outputs: logl (B,); ct_l2 (B, T, D), zeroed
// by the caller (rows past a track's length are not written); ct_tab
// (6K + 4KA,) = d(sum logL)/d(lp0, s20, lt, lsurv, endv, sig2v, ltn, s2n,
// lsn, endn) in that order.  Scratch: stash nblk*(T-1)*(2D+1)*K floats,
// partial nblk*(6K + 4KA) floats.  Returns cudaGetLastError().
extern "C" int extrack_grad(const float* xs, const float* l2,
                            const int* lengths, const float* isbl,
                            const float* lp0, const float* s20,
                            const float* lt, const float* lsurv,
                            const float* endv, const float* sig2v,
                            const float* ltn, const float* s2n,
                            const float* lsn, const float* endn, float* logl,
                            float* ct_l2, float* ct_tab, float* stash,
                            float* partial, int B, int T, int D, int K, int A,
                            int min_len, int nblk, void* stream) {
  const float* tabs[10] = {lp0, s20, lt, lsurv, endv,
                           sig2v, ltn, s2n, lsn, endn};
  return extrack::launch_grad_c<float>(xs, l2, lengths, isbl, tabs, logl,
                                       ct_l2, ct_tab, stash, partial, B, T,
                                       D, K, A, min_len, nblk, stream);
}
