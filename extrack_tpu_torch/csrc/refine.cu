// K6: position refinement, the moment-matched posterior of every
// localization's true position (mu and sigma per dimension).
//
// Replaces the TPU kernel extrack_tpu/ops/pallas_refine.py:_kernel (driven
// by refine_pallas), with the semantics of the plain refine.refine_positions:
// at an interior position t of a track, the mixture over state-matched
// pairs (prefix slot i, suffix slot j with the same newest state) of the
// product prefix prior x observation x suffix prior, each pair weighted by
// the two registers' log weights and the product's normalizer; position 0
// takes the suffix side alone, position L-1 the prefix side alone, and a
// 1-frame track the observation alone (mu = x, sigma = its localization
// error).  The priors come from two runs of a transition-only register scan
// (K1's fusion without fractions, survival or bleaching): the suffix scan
// from frame L-1 down to 0 on the transposed transitions, which stashes its
// register at every frame, then the prefix scan from frame 0, which
// combines at each frame before injecting it.
//
// Mapping: one block per track, thread k owns slot k (any S: K = S^W need
// not be a multiple of 32).  The suffix stash ((L-1) frames x (2D+1) x K
// floats, frame-major, slot-minor) is written and read back by the slot's
// own thread, so it needs no barrier; it sits in shared memory when it fits
// what a block may opt in to, else in global scratch per persistent block.
// At an interior position each thread turns its stashed suffix slot into
// the precision form centred on the observation (with a = m - x, p = 1/v:
// b = lp - a^2 p / 2, r = prod_d v^-1/2, p, n = a p) in shared memory; then
// thread i (prefix slot) loops over the K/S suffix slots of its state block
// (the threads of a state block read the same address: a broadcast) and
// keeps an online max-rescaled (sw, swm[D], swv[D]).  Pair (i, j) has
// P = p1 + p2 + 1/l2 and N = n1 + n2 per dimension, weight
// exp(b1 + b2 + sum N^2 / 2P) * r1 * r2 * prod_d P^-1/2, mean x + N/P and
// variance 1/P: no log per pair; the 2 pi powers and the observation's
// normalizer are common to all pairs and cancel.  One block reduce with the
// same rescale ends the position.
//
// What bounds it on Hopper: the pair loop, S*(K/S)^2 pairs per interior
// position at about 11D+8 operations each (one exp, one rsqrt, D
// divisions) on the CUDA cores.  It is not a matrix product (the N^2/P term does not
// separate), so the tensor cores cannot take it.
#include "common.cuh"

namespace extrack {

// Block-wide sums of N values per thread, in a fixed order (as block_sum);
// `red` holds 33*N floats.
template <int N>
static __device__ void block_sum_n(float* v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float u = warp_sum(v[q]);
    if (lane == 0) red[q * 32 + wid] = u;
  }
  __syncthreads();
  if (wid == 0) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      float u = lane < (int)(blockDim.x >> 5) ? red[q * 32 + lane] : 0.f;
      u = warp_sum(u);
      if (lane == 0) red[32 * N + q] = u;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = red[32 * N + q];
  __syncthreads();
}

// Ends a position: every thread holds its share (sw, swm[D], swv[D]) of the
// moments scaled by exp(-mx); rescale to the block's max, sum, and write
// mu = x + swm/sw, sigma = sqrt(max(swv/sw, 0)).
template <int D>
static __device__ void finish(float mx, float* acc, const float* x,
                              float* mu, float* sig, float* red) {
  const float top = block_max(mx, red);
  const float sc = expf(mx - top);
#pragma unroll
  for (int q = 0; q < 1 + 2 * D; ++q) acc[q] *= sc;
  block_sum_n<1 + 2 * D>(acc, red);
  if (threadIdx.x == 0) {
    const float inv = 1.0f / fmaxf(acc[0], kTiny);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      mu[d] = x[d] + acc[1 + d] * inv;
      sig[d] = sqrtf(fmaxf(acc[1 + D + d] * inv, 0.f));
    }
  }
}

// One side alone (a track end): observation x prior N(m, s2) per slot.
// Sets mx and acc for finish().
template <int D>
static __device__ void end_side(bool act, const float* m, const float* s2,
                                float lp, const float* x, const float* l2,
                                float& mx, float* acc) {
  mx = -INFINITY;
#pragma unroll
  for (int q = 0; q < 1 + 2 * D; ++q) acc[q] = 0.f;
  if (!act) return;
  float quad = 0.f, prod = 1.f, mu_c[D], var_c[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float a = m[d] - x[d];
    const float tot = l2[d] + s2[d];
    const float inv = 1.0f / tot;
    quad += 0.5f * a * a * inv;
    prod *= tot;
    mu_c[d] = a * l2[d] * inv;
    var_c[d] = s2[d] * l2[d] * inv;
  }
  mx = lp - quad;
  const float r = rsqrtf(prod);
  acc[0] = r;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    acc[1 + d] = r * mu_c[d];
    acc[1 + D + d] = r * var_c[d];
  }
}

// Inject observation (x, l2) into the register and fuse (transition terms
// only): the prior of the next frame in the scan's direction.
template <int D>
static __device__ void scan_step(bool act, float* m, float* s2, float& lp,
                                 const float* x, const float* l2,
                                 const float* lt, const float* sig2v,
                                 float* pub, int K, int m0, int S) {
  Prep<float, D> p;
  prep<float, D>(m, s2, x, l2, p);
  float mx, inv_sw;
  const float lse = fuse_group<float, D>(p, lp - p.quad, m, s2, sig2v, pub,
                                         K, m0, S, act, mx, inv_sw);
  if (act) lp = lse + lt[threadIdx.x];
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(1024)
    refine_kernel(const float* __restrict__ xs, const float* __restrict__ l2s,
                  const int* __restrict__ lengths,
                  const float* __restrict__ lp0f, const float* __restrict__ ltf,
                  const float* __restrict__ lp0r, const float* __restrict__ ltr,
                  const float* __restrict__ sig2v, int B, int T, int K, int S,
                  float* __restrict__ mu_out, float* __restrict__ sig_out,
                  float* __restrict__ stash_scratch) {
  extern __shared__ float sh[];
  __shared__ float red[33 * (1 + 2 * D)];
  const int k = threadIdx.x;
  const bool act = k < K;
  const int KS = K / S;
  const int m0 = (k % KS) * S;                  // first member of k's group
  const int F = 2 * D + 1;                      // stashed floats per slot
  // the fusion's publish area doubles as the suffix precompute of a
  // position (the block reduces in between separate the two uses)
  float* pub = sh;
  float* sb2 = sh;
  float* sr2 = sh + K;
  float* sp2 = sh + 2 * K;
  float* sn2 = sh + (2 + D) * K;
  float* stash = stash_scratch != nullptr
                     ? stash_scratch + (size_t)blockIdx.x * (T - 1) * F * K
                     : sh + (2 + 2 * D) * K;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int L = min(lengths[b], T);
    const float* x = xs + (size_t)b * T * D;
    const float* l2 = l2s + (size_t)b * T * D;
    float* mu = mu_out + (size_t)b * T * D;
    float* sig = sig_out + (size_t)b * T * D;
    // padded frames (and empty rows) are exact zeros
    for (int j = L * D + k; j < T * D; j += blockDim.x) mu[j] = sig[j] = 0.f;
    if (L < 2) {
      // a lone observation: mu = x, sigma = its localization error
      if (L == 1 && k < D) {
        mu[k] = x[k];
        sig[k] = sqrtf(l2[k]);
      }
      continue;
    }
    // ---- suffix scan from frame L-1 down, stashing frames L-2 .. 0 -----
    float m[D], s2[D], lp = act ? lp0r[k] : 0.f;
    const float s20 = act ? sig2v[k] : 1.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      m[d] = x[(L - 1) * D + d];
      s2[d] = l2[(L - 1) * D + d] + s20;
    }
    for (int f = L - 2; f >= 0; --f) {
      if (act) {
        float* st = stash + (size_t)f * F * K + k;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          st[d * K] = m[d];
          st[(D + d) * K] = s2[d];
        }
        st[2 * D * K] = lp;
      }
      if (f > 0)
        scan_step<D>(act, m, s2, lp, x + f * D, l2 + f * D, ltr, sig2v, pub,
                     K, m0, S);
    }
    // ---- position 0: the suffix side alone ----------------------------
    float acc[1 + 2 * D], mx;
    {
      const float* st = stash + k;
      float m2[D], v2[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        m2[d] = act ? st[d * K] : 0.f;
        v2[d] = act ? st[(D + d) * K] : 1.f;
      }
      end_side<D>(act, m2, v2, act ? st[2 * D * K] : 0.f, x, l2, mx, acc);
      finish<D>(mx, acc, x, mu, sig, red);
    }
    // ---- prefix scan with the combine ---------------------------------
    lp = act ? lp0f[k] : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      m[d] = x[d];
      s2[d] = l2[d] + s20;
    }
    for (int t = 1; t < L; ++t) {
      const float* xt = x + t * D;
      const float* l2t = l2 + t * D;
      if (t == L - 1) {             // the prefix side alone
        end_side<D>(act, m, s2, lp, xt, l2t, mx, acc);
        finish<D>(mx, acc, xt, mu + t * D, sig + t * D, red);
        break;
      }
      // suffix slot k in precision form, centred on x_t
      if (act) {
        const float* st = stash + (size_t)t * F * K + k;
        float b2 = st[2 * D * K], pv = 1.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float v = st[(D + d) * K];
          const float p2 = 1.0f / v;
          const float n2 = (st[d * K] - xt[d]) * p2;
          b2 -= 0.5f * n2 * (st[d * K] - xt[d]);
          pv *= v;
          sp2[d * K + k] = p2;
          sn2[d * K + k] = n2;
        }
        sb2[k] = b2;
        sr2[k] = rsqrtf(pv);
      }
      __syncthreads();
      mx = -INFINITY;
#pragma unroll
      for (int q = 0; q < 1 + 2 * D; ++q) acc[q] = 0.f;
      if (act) {
        // prefix slot k: the same form, with the observation's precision
        float b1 = lp, pv = 1.f, pp1[D], n1[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float p1 = 1.0f / s2[d];
          const float a1 = m[d] - xt[d];
          n1[d] = a1 * p1;
          b1 -= 0.5f * a1 * n1[d];
          pv *= s2[d];
          pp1[d] = p1 + 1.0f / l2t[d];
        }
        const int j0 = (k / KS) * KS;   // this state block's suffix slots
        for (int j = j0; j < j0 + KS; ++j) {
          float arg = b1 + sb2[j], prodP = 1.f, mu_p[D], iP[D];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float P = pp1[d] + sp2[d * K + j];
            const float N = n1[d] + sn2[d * K + j];
            iP[d] = 1.0f / P;
            mu_p[d] = N * iP[d];
            arg += 0.5f * N * mu_p[d];
            prodP *= P;
          }
          if (arg > mx) {             // online rescale to the new max
            const float sc = expf(mx - arg);
#pragma unroll
            for (int q = 0; q < 1 + 2 * D; ++q) acc[q] *= sc;
            mx = arg;
          }
          const float w = expf(arg - mx) * rsqrtf(prodP) * sr2[j];
          acc[0] += w;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            acc[1 + d] += w * mu_p[d];
            acc[1 + D + d] += w * iP[d];
          }
        }
        const float r1 = rsqrtf(pv);
#pragma unroll
        for (int q = 0; q < 1 + 2 * D; ++q) acc[q] *= r1;
      }
      finish<D>(mx, acc, xt, mu + t * D, sig + t * D, red);
      scan_step<D>(act, m, s2, lp, xt, l2t, ltf, sig2v, pub, K, m0, S);
    }
  }
}

template <int D>
static int launch_refine(const float* xs, const float* l2, const int* lengths,
                         const float* lp0f, const float* ltf,
                         const float* lp0r, const float* ltr,
                         const float* sig2v, float* mu, float* sig,
                         float* stash_scratch, int B, int T, int K, int S,
                         int nblk, cudaStream_t stream) {
  const int threads = (K + 31) / 32 * 32;
  const size_t stash = (size_t)max(T - 1, 0) * (2 * D + 1) * K;
  const size_t smem =
      ((size_t)(2 + 2 * D) * K + (stash_scratch != nullptr ? 0 : stash)) *
      sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(refine_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  if (B > 0)
    refine_kernel<D><<<nblk, threads, smem, stream>>>(
        xs, l2, lengths, lp0f, ltf, lp0r, ltr, sig2v, B, T, K, S, mu, sig,
        stash_scratch);
  return (int)cudaGetLastError();
}

}  // namespace extrack

// Dynamic shared memory one K6 block may opt in to on `device` (as
// extrack_predict_smem; the D = 3 instantiation has the largest static
// reduction buffer).
extern "C" int extrack_refine_smem(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, extrack::refine_kernel<3>);
  if (err != cudaSuccess) return -(int)err;
  return optin - (int)attr.sharedSizeBytes;
}

// Inputs: xs, l2 (B, T, D) positions and localization variances, lengths
// (B,), and the (K,) tables of ops/refine_kernel.build_refine_tables, K =
// S^W: lp0f/ltf (initial weight, transition into the newest state) for the
// prefix scan, lp0r/ltr the same on the transposed transitions for the
// suffix scan, sig2v the displacement variance of the newest step.
// Outputs mu, sig (B, T, D), every entry written (zeros past each track's
// length).  stash_scratch: null to keep the suffix stash in shared memory,
// or nblk * (T-1) * (2D+1) * K floats of global scratch.  Blocks are
// persistent over nblk.  Returns cudaGetLastError().
extern "C" int extrack_refine(const float* xs, const float* l2,
                              const int* lengths, const float* lp0f,
                              const float* ltf, const float* lp0r,
                              const float* ltr, const float* sig2v,
                              float* mu, float* sig, float* stash_scratch,
                              int B, int T, int D, int K, int S, int nblk,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return extrack::launch_refine<1>(xs, l2, lengths, lp0f, ltf, lp0r, ltr,
                                       sig2v, mu, sig, stash_scratch, B, T,
                                       K, S, nblk, st);
    case 2:
      return extrack::launch_refine<2>(xs, l2, lengths, lp0f, ltf, lp0r, ltr,
                                       sig2v, mu, sig, stash_scratch, B, T,
                                       K, S, nblk, st);
    case 3:
      return extrack::launch_refine<3>(xs, l2, lengths, lp0f, ltf, lp0r, ltr,
                                       sig2v, mu, sig, stash_scratch, B, T,
                                       K, S, nblk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
