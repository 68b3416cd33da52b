// K4: per-track log likelihood and per-frame state posteriors (the
// annotation of predict_Bs), for nb_substeps = 1.
//
// Replaces the TPU kernel extrack_tpu/ops/pallas_predict.py:_kernel
// (driven by predict_pallas).  Same semantics as the plain engine's
// forward(..., return_preds=True).  The plain engine carries, per slot,
// a history of posteriors over the frames that already left the window
// and mixes it at every fusion; the kernel stashes each fusion's weights
// instead and, at the track's last frame, carries the register's softmax
// back through them (walk.cuh): the same posteriors, in work linear in T.
// The frames still in the window come from the register codes.  Unlike
// K1, the walk does not stop at t = L-2: the fusion there is live (its
// register feeds the posteriors), and the harvest reads the update at the
// last frame t = L-1.
//
// What bounds it on Hopper: as K1, latency and instruction issue, not
// device memory; it reads the same bytes as K1 and writes T*S floats of
// posteriors per track.  The design is K1's (walk.cuh: a warp per track
// at K <= 64, persistent blocks, tables in registers, base-2 fusion,
// one-pass closing), plus the stash and backward pass in place of the
// quadratic history mix (which took half the cycles at 15..20 frames on
// an H100), and a harvest by warp reductions.  Variable dt reads the
// (B, T-1, P) stream of displacement variances as K1 does (walk.cuh).
// Past 1024 slots (up to 65536) a thread owns whole fusion groups and the
// carries live in shared memory as the groups' fused Gaussians (walk.cuh's
// wide mapping), or in the block's global scratch where they pass what a
// block may opt in to; the stash then holds each member's log2 weight
// until its group's sum is known.
#include "walk.cuh"

namespace extrack {

static __device__ unsigned long long g_predict_prof[kProfSlots];

}  // namespace extrack

// Reads and zeroes K4's cycle split (profile builds; zeros otherwise).
extern "C" int extrack_predict_prof(unsigned long long* out) {
  unsigned long long zero[extrack::kProfSlots] = {};
  cudaError_t err =
      cudaMemcpyFromSymbol(out, extrack::g_predict_prof, sizeof zero);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(extrack::g_predict_prof, zero, sizeof zero);
  return (int)err;
}

// Dynamic shared memory one K4 block may opt in to on `device`: the card's
// opt-in limit (the walk kernels use no static shared memory).  A negative
// value is a CUDA error code, negated.
extern "C" int extrack_predict_smem(int device) {
  int optin = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? optin : -(int)err;
}

// One K4 team for a launch (warps > 0: a warp of the warp mapping, 0: a
// block of the block mapping, -1: a block of the wide mapping, -2: one of
// the wide mapping with its carries in global scratch; P > 0: variable dt
// with P = S^2 patterns): out = threads a block, shared bytes of a team
// besides the stash of fusion weights, the stash's bytes a team (at -2:
// the publish areas, the softmax and the stash, all in global scratch).
extern "C" int extrack_predict_layout(int T, int D, int K, int S, int W,
                                      int warps, int P, long long* out) {
  if (D < 1 || D > 3 || warps < -2 || (warps > 0 && K > 64) ||
      K > (warps < 0 ? extrack::kWideMaxK : 1024))
    return (int)cudaErrorInvalidValue;
  const extrack::WalkLayout lay =
      extrack::team_layout(warps, K, S, D, T, S, W, true, P);
  out[0] = lay.threads;
  out[1] = (long long)lay.fixed;
  out[2] = (long long)lay.stash;
  return 0;
}

// Blocks of a K4 launch one SM keeps resident, or a CUDA error code,
// negated.
extern "C" int extrack_predict_occupancy(int D, int K, int S, int T, int W,
                                         int warps, int stash_smem, int P) {
  return extrack::walk_occupancy<true>(D, K, S, T, S, W, warps, stash_smem,
                                       P);
}

// Inputs as extrack_forward (sig2s and P: variable dt), with A == S (one
// sub-step) and K == S^W.  Outputs: logl (B,), preds (B, T, S) float32
// (every entry written).  stash_scratch: null when the stash of fusion
// weights is in shared memory (stash_smem 1), else the stash bytes of
// extrack_predict_layout for every team (nblk blocks of `warps` warps, or
// nblk blocks; warps 0 the block mapping, -1 the wide one, -2 the wide one
// with its carries in that scratch too).  Returns cudaGetLastError().
extern "C" int extrack_predict(const float* xs, const float* l2,
                               const int* lengths, const float* isbl,
                               const float* lp0, const float* s20,
                               const float* lt, const float* lsurv,
                               const float* endv, const float* sig2v,
                               const float* ltn, const float* s2n,
                               const float* lsn, const float* endn,
                               const float* sig2s, float* logl, float* preds,
                               float* stash_scratch, int B, int T, int D,
                               int K, int A, int min_len, int S, int W,
                               int nblk, int warps, int stash_smem, int P,
                               void* stream) {
  const extrack::Tables tb{lp0, s20, lt,  lsurv, endv, sig2v, ltn,
                           s2n, lsn, endn, K,    A,    min_len};
  if (!stash_smem && stash_scratch == nullptr && (T > W || warps == -2))
    return (int)cudaErrorInvalidValue;
  const extrack::WalkArgs wa{tb,    xs,    l2,           lengths,
                             isbl,  B,     T,            S,
                             W,     logl,  preds,        stash_scratch,
                             stash_smem, sig2s, P};
  unsigned long long* prof = nullptr;
#ifdef EXTRACK_PROFILE
  cudaGetSymbolAddress((void**)&prof, extrack::g_predict_prof);
#endif
  return extrack::launch_walk<true>(wa, D, nblk, warps, prof,
                                    static_cast<cudaStream_t>(stream));
}
