// K4: per-track log likelihood and per-frame state posteriors (the
// annotation of predict_Bs), for nb_substeps = 1.
//
// Replaces the TPU kernel extrack_tpu/ops/pallas_predict.py:_kernel
// (driven by predict_pallas).  Same semantics as the plain engine's
// forward(..., return_preds=True): each slot carries a history of
// posteriors over the states of the frames that already left the window;
// every fusion mixes a child's history from its group's members with the
// fusion weights and appends the weights themselves as the dropped frame's
// posterior; at the track's last frame the register's softmax reduces the
// histories, and the register codes give the frames still in the window.
//
// Mapping: K1's.  One block walks one track at a time, thread k owns slot
// k's carry in registers, a fusion publishes the update to shared memory.
// Unlike K1, the walk does not stop at t = L-2: the fusion there is live
// (its register feeds the posteriors), and the harvest reads the update at
// the last frame t = L-1.
//
// History: only frames 0 .. T-W-1 can leave the window before a track
// ends, so a slot's history is (T-W)*S floats (the TPU kernel keeps
// (T+W)*S rows, most of them for frames before 0 or still in the window).
// A child's mix reads its group's rows, which its siblings are also
// reading, so the history is double-buffered: read one buffer, write the
// other, and the fusion's existing barrier separates the steps.  Both
// buffers (2*K*(T-W)*S floats, 7.7 KB at K=32, T=20, S=2) sit in shared
// memory when they fit in what a block may opt in to (extrack_predict_smem:
// 227 KB on Hopper); otherwise the host passes a global scratch buffer per
// persistent block.
//
// What bounds it on Hopper: as K1, instruction throughput and barriers,
// not device memory; it reads the same bytes as K1 and writes T*S floats
// of posteriors per track.  The mix adds (T-W)*S*A multiply-adds per slot
// and step, and the harvest K multiply-adds per posterior, done by one
// thread per (frame, state) output so the block needs no reduction there.
#include "common.cuh"

namespace extrack {

template <int D>
__global__ void __launch_bounds__(1024)
    predict_kernel(Tables tb, const float* __restrict__ xs,
                   const float* __restrict__ l2s,
                   const int* __restrict__ lengths,
                   const float* __restrict__ isbls, int B, int T, int S,
                   int W, float* __restrict__ logl,
                   float* __restrict__ preds,
                   float* __restrict__ cat_scratch) {
  extern __shared__ float sh[];
  __shared__ float red[33];
  const int K = tb.K, A = tb.A;                 // A == S (one sub-step)
  const int k = threadIdx.x;
  const bool act = k < K;
  const int m0 = (k % (K / A)) * A;             // first member of k's group
  const float cl2pi = 0.5f * D * kLog2Pi;
  const int HS = max(T - W, 0) * S;             // history floats per slot
  float* sbase = sh;                            // fuse_group's publish area
  float* srq = sh + K;
  float* spb = sh + (2 + 2 * D) * K;            // softmax over the register
  float* cat0 = cat_scratch != nullptr
                    ? cat_scratch + (size_t)blockIdx.x * 2 * K * HS
                    : sh + (3 + 2 * D) * K;
  float* cat1 = cat0 + (size_t)K * HS;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int L = min(lengths[b], T);
    float* pr = preds + (size_t)b * T * S;
    if (L < 2) {            // empty / 1-frame rows: logL 0, posteriors 0
      for (int j = k; j < T * S; j += blockDim.x) pr[j] = 0.f;
      if (k == 0) logl[b] = 0.f;
      continue;
    }
    const float* x = xs + (size_t)b * T * D;
    const float* l2 = l2s + (size_t)b * T * D;
    const float isbl = isbls[b];
    float m[D], s2[D], lp = act ? tb.lp0[k] : 0.f;
    const float s20 = act ? tb.s20[k] : 1.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      m[d] = x[d];
      s2[d] = l2[d] + s20;
    }
    float* cur = cat0;      // history entering this step
    float* nxt = cat1;      // history this step's fusion writes
    float out = 0.f;
    for (int t = 1; t < L; ++t) {
      float xt[D], l2t[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xt[d] = x[t * D + d];
        l2t[d] = l2[t * D + d];
      }
      Prep<float, D> p;
      prep<float, D>(m, s2, xt, l2t, p);
      const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;
      if (t == L - 1) {
        // harvest: softmax of the register (for 2-frame tracks this is
        // also the closing), then one thread per (frame, state) output
        const float fin = act ? lp + isbl * tb.endv[k] - 0.5f * logf(p.prod) -
                                    p.quad - cl2pi
                              : -INFINITY;
        const float mx = block_max(fin, red);
        const float e = act ? expf(fin - mx) : 0.f;
        const float se = block_sum(e, red);
        if (L == 2) out = mx + logf(se);
        if (act) spb[k] = e / fmaxf(se, kTiny);
        __syncthreads();
        const int nh = L - W;             // frames 0 .. nh-1: the history
        for (int j = k; j < T * S; j += blockDim.x) {
          const int f = j / S, s = j - f * S;
          float v = 0.f;
          if (f < nh) {
            for (int c = 0; c < K; ++c) v += spb[c] * cur[(size_t)c * HS + j];
          } else if (f < L) {
            // window position w (0 = oldest) is digit w of the slot code,
            // counted from the lowest-order (oldest) digit
            int pw = 1;
            for (int i = f - nh; i > 0; --i) pw *= S;
            for (int c = 0; c < K; ++c)
              if ((c / pw) % S == s) v += spb[c];
          }
          pr[j] = v;
        }
        __syncthreads();    // spb and the history are reused by the next track
        break;
      }
      if (L > 2 && t == L - 2) {
        // look-ahead closing on the pre-fusion children, as K1
        float xn[D], l2n[D], invn[D], diffn[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          xn[d] = x[(t + 1) * D + d];
          l2n[d] = l2[(t + 1) * D + d];
        }
        const float base_n = lp - p.quad - 0.5f * logf(p.prod) - cl2pi;
        float gmax = -INFINITY;
        if (act) {
          for (int a = 0; a < A; ++a) {
            const int ka = k * A + a;
            float r;
            const float g =
                base_n + tb.ltn[ka] + gate * tb.lsn[ka] + isbl * tb.endn[ka] +
                look_child<float, D>(p, xn, l2n, tb.s2n[ka], invn, diffn, r);
            gmax = fmaxf(gmax, g);
          }
        }
        const float mxl = block_max(gmax, red);
        float sl = 0.f;
        if (act) {
          for (int a = 0; a < A; ++a) {
            const int ka = k * A + a;
            float r;
            const float g =
                base_n + tb.ltn[ka] + gate * tb.lsn[ka] + isbl * tb.endn[ka] +
                look_child<float, D>(p, xn, l2n, tb.s2n[ka], invn, diffn, r);
            sl += expf(g - mxl) * r;
          }
        }
        out = mxl + logf(block_sum(sl, red));
      }
      // fusion (as K1) and the history mix
      float mx = 0.f, inv_sw = 0.f;
      const float lse = fuse_group<float, D>(p, lp - p.quad, m, s2, tb.sig2v,
                                             sh, K, m0, A, act, mx, inv_sw);
      if (act) {
        // dropped frame t+1-W: its posterior is the fusion weight of the
        // oldest digit o, the same for every child of the group
        const int fd = t + 1 - W;
        float* dst = nxt + (size_t)k * HS;
        for (int o = 0; o < A; ++o) {
          const float wo = expf(sbase[m0 + o] - mx) * srq[m0 + o] * inv_sw;
          const float* src = cur + (size_t)(m0 + o) * HS;
          if (o == 0)
            for (int j = 0; j < fd * S; ++j) dst[j] = wo * src[j];
          else
            for (int j = 0; j < fd * S; ++j) dst[j] += wo * src[j];
          if (fd >= 0) dst[fd * S + o] = wo;
        }
        lp = lse + tb.lt[k] + gate * tb.lsurv[k];
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    if (k == 0) logl[b] = out;
  }
}

template <int D>
static int launch_predict(const Tables& tb, const float* xs, const float* l2,
                          const int* lengths, const float* isbl, float* logl,
                          float* preds, float* cat_scratch, int B, int T,
                          int S, int W, int nblk, cudaStream_t stream) {
  const int threads = (tb.K + 31) / 32 * 32;
  const size_t hist = (size_t)2 * tb.K * max(T - W, 0) * S;
  const size_t smem =
      ((size_t)(3 + 2 * D) * tb.K + (cat_scratch != nullptr ? 0 : hist)) *
      sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(predict_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  if (B > 0)
    predict_kernel<D><<<nblk, threads, smem, stream>>>(
        tb, xs, l2, lengths, isbl, B, T, S, W, logl, preds, cat_scratch);
  return (int)cudaGetLastError();
}

}  // namespace extrack

// Dynamic shared memory one K4 block may opt in to on `device`: the card's
// opt-in limit less the kernel's static shared memory.  A negative value
// is a CUDA error code, negated.
extern "C" int extrack_predict_smem(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, extrack::predict_kernel<2>);
  if (err != cudaSuccess) return -(int)err;
  return optin - (int)attr.sharedSizeBytes;
}

// Inputs as extrack_forward, with A == S (one sub-step) and K == S^W.
// Outputs: logl (B,), preds (B, T, S) float32 (every entry written).
// cat_scratch: null to keep the double-buffered history in shared memory,
// or nblk * 2 * K * max(T-W, 0) * S floats of global scratch.  Blocks are
// persistent over nblk.  Returns cudaGetLastError().
extern "C" int extrack_predict(const float* xs, const float* l2,
                               const int* lengths, const float* isbl,
                               const float* lp0, const float* s20,
                               const float* lt, const float* lsurv,
                               const float* endv, const float* sig2v,
                               const float* ltn, const float* s2n,
                               const float* lsn, const float* endn,
                               float* logl, float* preds, float* cat_scratch,
                               int B, int T, int D, int K, int A, int min_len,
                               int S, int W, int nblk, void* stream) {
  const extrack::Tables tb{lp0, s20, lt,  lsurv, endv, sig2v, ltn,
                           s2n, lsn, endn, K,    A,    min_len};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return extrack::launch_predict<1>(tb, xs, l2, lengths, isbl, logl,
                                        preds, cat_scratch, B, T, S, W, nblk,
                                        st);
    case 2:
      return extrack::launch_predict<2>(tb, xs, l2, lengths, isbl, logl,
                                        preds, cat_scratch, B, T, S, W, nblk,
                                        st);
    case 3:
      return extrack::launch_predict<3>(tb, xs, l2, lengths, isbl, logl,
                                        preds, cat_scratch, B, T, S, W, nblk,
                                        st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
