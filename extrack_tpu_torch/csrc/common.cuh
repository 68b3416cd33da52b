// Shared device code of the forward (forward.cu), gradient (grad.cu),
// Hessian-vector-product (hvp.cu) and posterior (predict.cu) kernels: block
// reductions, the per-slot Gaussian update and its pullback, and the
// per-track forward walk.
//
// Mapping: one thread block walks one track at a time; thread k owns
// register slot k (K = S^W slots, blockDim.x = K rounded up to a warp).
// The slot's carry (mean and variance per dimension, log weight) lives in
// the thread's registers for the whole walk.  Slot k = g*A + o holds fusion
// group g (the W-n newest sub-state digits) and its n oldest digits o; the
// children of group g under new pattern a are slots a*G + g.  A fusion step
// publishes each slot's update to shared memory, and every child thread
// reads its group's A members from there (A-fold redundant, no second
// barrier).  Closings are block reductions over the slots.
//
// Everything here is a template over the scalar type `Real`: float for
// K1, K2 and K4, Dual (dual.cuh) for K3.  Positions, the bleaching flag and
// the gates carry no tangent and stay float.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "dual.cuh"

namespace extrack {

constexpr float kTiny = 1e-30f;                 // f32-safe sum guard
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float k2Pi = 6.283185307179586f;

template <typename Real>
struct TablesT {
  // per-slot (K,) tables: init prior, init displacement variance, transition
  // chain of the n newest digits (minus the per-step 2*pi constant),
  // survival, end term, displacement variance of the child's newest step
  const Real *lp0, *s20, *lt, *lsurv, *endv, *sig2v;
  // per-(slot, pattern) (K, A) look-ahead tables, row-major
  const Real *ltn, *s2n, *lsn, *endn;
  int K, A, min_len;
};
using Tables = TablesT<float>;

template <typename Real>
static __device__ __forceinline__ Real warp_max(Real v) {
  for (int o = 16; o > 0; o >>= 1) v = shift_max(v, shfl_xor(v, o));
  return v;
}

template <typename Real>
static __device__ __forceinline__ Real warp_sum(Real v) {
  for (int o = 16; o > 0; o >>= 1) v += shfl_xor(v, o);
  return v;
}

// Block-wide max / sum in a fixed order.  Every thread calls; blockDim.x is
// a multiple of 32; `red` is __shared__ Real[33].  The trailing barrier
// lets the next call reuse `red`.  The max is a shift (tangent 0).
template <typename Real>
static __device__ Real block_max(Real v, Real* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    Real u = lane < (int)(blockDim.x >> 5) ? red[lane] : Real(-INFINITY);
    u = warp_max(u);
    if (lane == 0) red[32] = u;
  }
  __syncthreads();
  const Real r = red[32];
  __syncthreads();
  return r;
}

template <typename Real>
static __device__ Real block_sum(Real v, Real* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    Real u = lane < (int)(blockDim.x >> 5) ? red[lane] : Real(0.f);
    u = warp_sum(u);
    if (lane == 0) red[32] = u;
  }
  __syncthreads();
  const Real r = red[32];
  __syncthreads();
  return r;
}

// Gaussian update of one slot against observation x with variance l2:
// tot = l2 + s2, quad = sum 0.5 (x-m)^2/tot, prod = prod tot, and the
// posterior mean / variance tail per dimension.
template <typename Real, int D>
struct Prep {
  Real inv[D], nm[D], tl[D];
  Real quad, prod;
};

template <typename Real, int D>
static __device__ __forceinline__ void prep(const Real* m, const Real* s2,
                                            const float* x, const Real* l2,
                                            Prep<Real, D>& p) {
  p.quad = Real(0.f);
  p.prod = Real(1.f);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const Real tot = l2[d] + s2[d];
    const Real inv = 1.0f / tot;
    const Real diff = x[d] - m[d];
    p.prod *= tot;
    p.quad += 0.5f * diff * diff * inv;
    p.inv[d] = inv;
    p.nm[d] = (m[d] * l2[d] + x[d] * s2[d]) * inv;
    p.tl[d] = l2[d] * s2[d] * inv;
  }
}

// Pullback through prep.  `cb` is the cotangent of the slot's log weight
// lp - quad - 0.5 log prod (every consumer sees the normalizer that way),
// cnm / ctl those of the posterior mean / tail.  Gives the carry
// cotangents dm, ds2 and this slot's share of the l2 cotangent.
template <typename Real, int D>
static __device__ __forceinline__ void prep_bwd(
    const Real* m, const Real* s2, const float* x, const Real* l2,
    const Prep<Real, D>& p, Real cb, const Real* cnm, const Real* ctl,
    Real* dm, Real* ds2, Real* dl2) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const Real inv = p.inv[d];
    const Real diff = x[d] - m[d];
    const Real e = diff * inv;
    const Real cn = cnm[d] * inv, cl = ctl[d] * inv;
    const Real ct_tot =
        0.5f * cb * (diff * e - 1.f) * inv - cn * p.nm[d] - cl * p.tl[d];
    dm[d] = cb * e + cn * l2[d];
    ds2[d] = ct_tot + cn * x[d] + cl * l2[d];
    dl2[d] = ct_tot + cn * m[d] + cl * s2[d];
  }
}

// Look-ahead child of a slot under pattern a: returns -quad_n and sets the
// normalizer factor r = prod_d (2 pi totn)^-1/2 (kept on the exp side, so
// the closing costs one log per track).
template <typename Real, int D>
static __device__ __forceinline__ Real look_child(
    const Prep<Real, D>& p, const float* xn, const Real* l2n, Real s2n_ka,
    Real* invn, Real* diffn, Real& r) {
  Real prod_n = Real(1.f), quad_n = Real(0.f);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const Real totn = s2n_ka + p.tl[d] + l2n[d];
    const Real iv = 1.0f / totn;
    const Real df = xn[d] - p.nm[d];
    prod_n *= k2Pi * totn;
    quad_n += 0.5f * df * df * iv;
    invn[d] = iv;
    diffn[d] = df;
  }
  r = xrsqrt(prod_n);
  return -quad_n;
}

// Forward walk of one track of length L >= 2 (x, l2: (T, D) rows of the
// track).  Returns the track's log likelihood (valid in every thread) and
// the closing's max shift and exp-sum.  With `stash` non-null each step's
// entering carry is written to stash[((t-1)*(2D+1) + field)*K + k] for the
// gradient kernel's backward walk.  `sh` holds (2+2D)*K scalars.
template <typename Real, int D>
static __device__ Real track_forward(const TablesT<Real>& tb, const float* x,
                                     const Real* l2, int L, float isbl,
                                     Real* sh, Real* red, Real* stash,
                                     Real* close_mx, Real* close_sum) {
  const int K = tb.K, A = tb.A, G = K / A;
  const int k = threadIdx.x;
  const bool act = k < K;
  const float cl2pi = 0.5f * D * kLog2Pi;
  Real* sbase = sh;
  Real* srq = sh + K;
  Real* snm = sh + 2 * K;
  Real* stl = sh + (2 + D) * K;

  Real m[D], s2[D], lp = act ? tb.lp0[k] : Real(0.f);
  const Real s20 = act ? tb.s20[k] : Real(1.f);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    m[d] = Real(x[d]);
    s2[d] = l2[d] + s20;
  }
  // 2-frame tracks close on the register at t = 1; longer ones close on
  // the pre-fusion children at t = L-2, and the fusion there is dead work
  const int tlast = L == 2 ? 1 : L - 2;
  Real out = Real(0.f);
  for (int t = 1; t <= tlast; ++t) {
    if (stash != nullptr && act) {
      Real* row = stash + (size_t)(t - 1) * (2 * D + 1) * K + k;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        row[d * K] = m[d];
        row[(D + d) * K] = s2[d];
      }
      row[2 * D * K] = lp;
    }
    float xt[D];
    Real l2t[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xt[d] = x[t * D + d];
      l2t[d] = l2[t * D + d];
    }
    Prep<Real, D> p;
    prep<Real, D>(m, s2, xt, l2t, p);
    const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;
    if (L == 2) {
      const Real fin = act ? lp + isbl * tb.endv[k] - 0.5f * xlog(p.prod) -
                                 p.quad - cl2pi
                           : Real(-INFINITY);
      const Real mx = block_max(fin, red);
      const Real s = block_sum(act ? xexp(fin - mx) : Real(0.f), red);
      *close_mx = mx;
      *close_sum = s;
      out = mx + xlog(s);
    } else if (t == tlast) {
      float xn[D];
      Real l2n[D], invn[D], diffn[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xn[d] = x[(t + 1) * D + d];
        l2n[d] = l2[(t + 1) * D + d];
      }
      const Real base_n = lp - p.quad - 0.5f * xlog(p.prod) - cl2pi;
      Real gmax = Real(-INFINITY);
      if (act) {
        for (int a = 0; a < A; ++a) {
          const int ka = k * A + a;
          Real r;
          const Real g =
              base_n + tb.ltn[ka] + gate * tb.lsn[ka] + isbl * tb.endn[ka] +
              look_child<Real, D>(p, xn, l2n, tb.s2n[ka], invn, diffn, r);
          gmax = shift_max(gmax, g);
        }
      }
      const Real mx = block_max(gmax, red);
      Real sl = Real(0.f);
      if (act) {
        for (int a = 0; a < A; ++a) {
          const int ka = k * A + a;
          Real r;
          const Real g =
              base_n + tb.ltn[ka] + gate * tb.lsn[ka] + isbl * tb.endn[ka] +
              look_child<Real, D>(p, xn, l2n, tb.s2n[ka], invn, diffn, r);
          sl += xexp(g - mx) * r;
        }
      }
      const Real s = block_sum(sl, red);
      *close_mx = mx;
      *close_sum = s;
      out = mx + xlog(s);
    } else {
      // fuse the oldest digits: per-step normalizers ride as rsqrt factors
      // in the exp-sum shifted by max(lp - quad); their 2*pi constants are
      // folded into lt by the host
      if (act) {
        sbase[k] = lp - p.quad;
        srq[k] = xrsqrt(p.prod);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          snm[d * K + k] = p.nm[d];
          stl[d * K + k] = p.tl[d];
        }
      }
      __syncthreads();
      if (act) {
        const int m0 = (k % G) * A;     // first member of this child's group
        Real mx = Real(-INFINITY);
        for (int o = 0; o < A; ++o) mx = shift_max(mx, sbase[m0 + o]);
        Real sw = Real(0.f), mf[D], tf[D];
#pragma unroll
        for (int d = 0; d < D; ++d) mf[d] = tf[d] = Real(0.f);
        for (int o = 0; o < A; ++o) {
          const Real w = xexp(sbase[m0 + o] - mx) * srq[m0 + o];
          sw += w;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            mf[d] += w * snm[d * K + m0 + o];
            tf[d] += w * stl[d * K + m0 + o];
          }
        }
        const Real inv_sw = 1.0f / clamp_min(sw, kTiny);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          m[d] = mf[d] * inv_sw;
          s2[d] = tb.sig2v[k] + tf[d] * inv_sw;
        }
        lp = mx + xlog(clamp_min(sw, kTiny)) + tb.lt[k] + gate * tb.lsurv[k];
      }
      __syncthreads();
    }
  }
  return out;
}

}  // namespace extrack
