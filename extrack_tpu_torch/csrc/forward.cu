// K1: per-track log likelihood of the sequence-register recursion.
//
// Replaces the TPU kernel extrack_tpu/ops/pallas_engine.py:_kernel (driven
// by forward_pallas, and by pallas_grad._value_call for value-only fit
// evaluations).
//
// What bounds it on Hopper: not device memory.  A track reads T*D
// positions and T*D variances once (16 B per frame at D = 2) and writes one
// float, while its walk does ~T * K * (20 + 8A) flops with A exps and
// two block barriers per step.  The limits are instruction throughput,
// the barrier per fusion step, and occupancy (one K-thread block per
// track).  The design
// keeps the register (K * (2D+1) floats, 1.3 KB at S=2, W=6, D=2 and 4.9 KB
// at S=3, W=5) in the registers of K threads instead of one thread's, so
// nothing spills; the fusion exchanges only (2+2D)*K floats through shared
// memory per step.  Tracks are independent, so blocks need no cross-block
// reduction and the result is bitwise repeatable.
#include "common.cuh"

namespace extrack {

template <int D>
__global__ void __launch_bounds__(1024)
    forward_kernel(Tables tb, const float* __restrict__ xs,
                   const float* __restrict__ l2s,
                   const int* __restrict__ lengths,
                   const float* __restrict__ isbls, float* __restrict__ logl,
                   int T) {
  extern __shared__ float sh[];
  __shared__ float red[33];
  const int b = blockIdx.x;
  const int L = min(lengths[b], T);
  float out = 0.f;
  if (L >= 2) {
    float mx, s;
    const size_t off = (size_t)b * T * D;
    out = track_forward<float, D>(tb, xs + off, l2s + off, L, isbls[b], sh,
                                  red, nullptr, &mx, &s);
  }
  if (threadIdx.x == 0) logl[b] = out;
}

template <int D>
static int launch_forward(const Tables& tb, const float* xs, const float* l2,
                          const int* lengths, const float* isbl, float* logl,
                          int B, int T, cudaStream_t stream) {
  const int threads = (tb.K + 31) / 32 * 32;
  const size_t smem = (size_t)(2 + 2 * D) * tb.K * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(forward_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  if (B > 0)
    forward_kernel<D><<<B, threads, smem, stream>>>(tb, xs, l2, lengths,
                                                     isbl, logl, T);
  return (int)cudaGetLastError();
}

}  // namespace extrack

// xs, l2: (B, T, D) float32; lengths int32 (B,); isbl float32 (B,); the
// (K,) and (K, A) tables as in extrack::Tables; logl float32 (B,).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int extrack_forward(const float* xs, const float* l2,
                               const int* lengths, const float* isbl,
                               const float* lp0, const float* s20,
                               const float* lt, const float* lsurv,
                               const float* endv, const float* sig2v,
                               const float* ltn, const float* s2n,
                               const float* lsn, const float* endn,
                               float* logl, int B, int T, int D, int K, int A,
                               int min_len, void* stream) {
  const extrack::Tables tb{lp0, s20, lt,  lsurv, endv, sig2v, ltn,
                           s2n, lsn, endn, K,    A,    min_len};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return extrack::launch_forward<1>(tb, xs, l2, lengths, isbl, logl, B, T, st);
    case 2:
      return extrack::launch_forward<2>(tb, xs, l2, lengths, isbl, logl, B, T, st);
    case 3:
      return extrack::launch_forward<3>(tb, xs, l2, lengths, isbl, logl, B, T, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* extrack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
