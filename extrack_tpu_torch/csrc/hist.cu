// K5: the posterior-expected duration (segment-length) histogram of the
// window DP, for nb_substeps = 1.
//
// Replaces the TPU kernel extrack_tpu/ops/pallas_hist.py:_kernel (driven
// by hist_pallas).  Same semantics as the plain
// histograms.window_segment_histogram: K1's register walk, in which each
// slot also carries `run`, the distribution over the length of the run
// that holds the window's oldest frame (T bins), and `hist`, the expected
// histogram of the segments completed in the frames already dropped (S*T
// bins, state-major).  Every fusion mixes a child's rows from its group's
// members with the fusion weights; once frames drop out of the window, a
// member whose oldest run goes on into the next frame passes its run on
// grown by one, and a member whose oldest run ends there adds it to its
// histogram and passes on a fresh run of length 1.  At the track's last
// frame the softmax of the register weighs, per bin, the carried
// histogram, the carried run placed in the oldest state's row and shifted
// by the length of the window's oldest run, and the window's own segments
// (the static tables `seg`, read from global memory: the same for every
// track, so they stay in L2).
//
// Mapping: K4's.  One block per track; thread k owns slot k's Gaussian
// carry in registers, and a fusion publishes the update to shared memory.
// The run/hist rows ((1+S)*T floats per slot) are double-buffered (a
// child's mix reads its siblings' rows) and bin-major (row r of slot c at
// r*K + c, so a warp touches consecutive banks), in shared memory when
// both buffers fit what a block may opt in to, else in global scratch per
// persistent block.  A fusion at step t writes bins 0..t only (no run or
// segment is longer yet) and both buffers start each track at zero.  The
// harvest gives each warp a share of the bins and each lane a share of the
// slots (warp sums, no barrier), and writes one (S*T) row per track; the
// host sums the rows in float64 with one reduction over the tracks, so no
// float atomics are needed and a histogram computed twice is bitwise
// identical.
//
// What bounds it on Hopper: as K4, instruction issue and barriers, not
// device memory.  The transport adds (1+S)*(t+1)*S multiply-adds per slot
// at step t, and the harvest K*S*T multiply-adds per track.
#include "common.cuh"

namespace extrack {

// The explicit minimum of one block per SM lets ptxas use up to 64
// registers: with the thread bound alone it gave this kernel 32 registers
// and spills.
template <int D>
__global__ void __launch_bounds__(1024, 1)
    hist_kernel(Tables tb, const float* __restrict__ xs,
                const float* __restrict__ l2s,
                const int* __restrict__ lengths,
                const float* __restrict__ isbls,
                const float* __restrict__ seg, const int* __restrict__ ext,
                int B, int T, int S, int W, float* __restrict__ rows,
                float* __restrict__ scratch) {
  extern __shared__ float sh[];
  __shared__ float red[33];
  const int K = tb.K, A = tb.A, G = K / A;      // A == S (one sub-step)
  const int k = threadIdx.x;
  const bool act = k < K;
  const int lane = k & 31, wid = k >> 5, nwarp = blockDim.x >> 5;
  const int m0 = (k % G) * A;                   // first member of k's group
  const int ST = S * T, HS = (1 + S) * T;       // hist bins, rows per slot
  float* pub = sh;                              // fusion publish area
  float* spb = sh + (2 + 2 * D) * K;            // softmax over the register
  float* buf0 = scratch != nullptr
                    ? scratch + (size_t)blockIdx.x * 2 * K * HS
                    : sh + (3 + 2 * D) * K;
  float* buf1 = buf0 + (size_t)K * HS;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int L = min(lengths[b], T);
    float* row = rows + (size_t)b * ST;
    if (L < 2) {            // empty / 1-frame rows are never harvested
      for (int j = k; j < ST; j += blockDim.x) row[j] = 0.f;
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
    // every slot starts with a run of length 1 and no completed segment
    if (act)
      for (int r = 0; r < HS; ++r) {
        buf0[(size_t)r * K + k] = r == 0 ? 1.f : 0.f;
        buf1[(size_t)r * K + k] = 0.f;
      }
    float* cur = buf0;      // rows entering this step
    float* nxt = buf1;      // rows this step's fusion writes
    for (int t = 1; t < L; ++t) {
      float xt[D], l2t[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xt[d] = x[t * D + d];
        l2t[d] = l2[t * D + d];
      }
      Prep<float, D> p;
      prep<float, D>(m, s2, xt, l2t, p);
      if (t == L - 1) {
        // harvest: softmax of fin = lp + isBL * end + log N(x_t) (the
        // per-step constants cancel), then per bin a K-sum
        const float fin = act ? lp + isbl * tb.endv[k] - 0.5f * logf(p.prod) -
                                    p.quad
                              : -INFINITY;
        const float mx = block_max(fin, red);
        const float e = act ? expf(fin - mx) : 0.f;
        const float se = block_sum(e, red);
        if (act) spb[k] = e / fmaxf(se, kTiny);
        __syncthreads();
        // coverage: tracks longer than the window add the carried run
        // and the window's inner segments, shorter ones the segments of
        // their t+1 frames
        const bool carry = t + 1 > W;
        const float* sg = seg + (size_t)(carry ? W + 1 : t + 1) * ST * K;
        for (int j = wid; j < ST; j += nwarp) {
          const int s = j / T, mb = j - s * T;
          float v = 0.f;
          for (int c = lane; c < K; c += 32) {
            float tot = cur[(size_t)(T + j) * K + c] + sg[(size_t)j * K + c];
            if (carry && c % S == s) {
              // the oldest run: carried length + the window's run - 1
              const int src = mb - ext[c] + 1;
              if (src >= 0) tot += cur[(size_t)src * K + c];
            }
            v += spb[c] * tot;
          }
          v = warp_sum(v);
          if (lane == 0) row[j] = v;
        }
        __syncthreads();    // spb and the rows are reused by the next track
        break;
      }
      // fusion (as K1) and the run/hist transport
      const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;
      float mx = 0.f, inv_sw = 0.f;
      const float lse = fuse_group<float, D>(p, lp - p.quad, m, s2, tb.sig2v,
                                             pub, K, m0, A, act, mx, inv_sw);
      if (act) {
        const bool drop = t >= W - 1;   // the oldest frame leaves the window
        // member o's oldest state is o, its second-oldest state q (the
        // same for the whole group): the oldest run goes on iff o == q
        const int q = (k % G) % S;
        const int nb = min(t + 1, T);
        float* dst = nxt + k;
        for (int o = 0; o < A; ++o) {
          const float w = expf(pub[m0 + o] - mx) * pub[K + m0 + o] * inv_sw;
          const float* src = cur + m0 + o;
          for (int r = 0; r < nb; ++r) {
            float v = src[(size_t)r * K];
            if (drop) v = o == q ? (r > 0 ? src[(size_t)(r - 1) * K] : 0.f)
                                 : (r == 0 ? 1.f : 0.f);
            dst[(size_t)r * K] = o == 0 ? w * v : dst[(size_t)r * K] + w * v;
          }
          for (int s = 0; s < S; ++s)
            for (int r = 0; r < nb; ++r) {
              const size_t i = (size_t)(T + s * T + r) * K;
              float v = src[i];
              if (drop && o != q && s == o) v += src[(size_t)r * K];
              dst[i] = o == 0 ? w * v : dst[i] + w * v;
            }
        }
        lp = lse + tb.lt[k] + gate * tb.lsurv[k];
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

template <int D>
static int launch_hist(const Tables& tb, const float* xs, const float* l2,
                       const int* lengths, const float* isbl,
                       const float* seg, const int* ext, float* rows,
                       float* scratch, int B, int T, int S, int W, int nblk,
                       cudaStream_t stream) {
  const int threads = (tb.K + 31) / 32 * 32;
  const size_t bufs = (size_t)2 * tb.K * (1 + S) * T;
  const size_t smem =
      ((size_t)(3 + 2 * D) * tb.K + (scratch != nullptr ? 0 : bufs)) *
      sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(hist_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  if (B > 0)
    hist_kernel<D><<<nblk, threads, smem, stream>>>(
        tb, xs, l2, lengths, isbl, seg, ext, B, T, S, W, rows, scratch);
  return (int)cudaGetLastError();
}

}  // namespace extrack

// Dynamic shared memory one K5 block may opt in to on `device` (as
// extrack_predict_smem).
extern "C" int extrack_hist_smem(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, extrack::hist_kernel<2>);
  if (err != cudaSuccess) return -(int)err;
  return optin - (int)attr.sharedSizeBytes;
}

// Inputs: xs, l2 (B, T, D), lengths (B,), isbl (B,) and the six (K,) slot
// tables of extrack_forward (lp0, s20, lt, lsurv, endv, sig2v), K = S^W;
// seg (W+2, S*T, K) static segment tables and ext (K,) oldest-run lengths
// (ops/hist_kernel.segment_tables).  Output: rows (B, S*T), each track's
// expected histogram (bin s*T + m: segments of length m+1 in state s;
// zero for tracks of fewer than 2 frames).  scratch: null to keep the
// double-buffered rows in shared memory, or nblk * 2 * K * (1+S) * T
// floats of global scratch.  Blocks are persistent over nblk.  Returns
// cudaGetLastError().
extern "C" int extrack_hist(const float* xs, const float* l2,
                            const int* lengths, const float* isbl,
                            const float* lp0, const float* s20,
                            const float* lt, const float* lsurv,
                            const float* endv, const float* sig2v,
                            const float* seg, const int* ext, float* rows,
                            float* scratch, int B, int T, int D, int K,
                            int min_len, int S, int W, int nblk,
                            void* stream) {
  const extrack::Tables tb{lp0,     s20,     lt,      lsurv, endv,
                           sig2v,   nullptr, nullptr, nullptr, nullptr,
                           K,       S,       min_len};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return extrack::launch_hist<1>(tb, xs, l2, lengths, isbl, seg, ext,
                                     rows, scratch, B, T, S, W, nblk, st);
    case 2:
      return extrack::launch_hist<2>(tb, xs, l2, lengths, isbl, seg, ext,
                                     rows, scratch, B, T, S, W, nblk, st);
    case 3:
      return extrack::launch_hist<3>(tb, xs, l2, lengths, isbl, seg, ext,
                                     rows, scratch, B, T, S, W, nblk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
