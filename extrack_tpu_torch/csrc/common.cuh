// Shared device code of the forward (forward.cu), gradient (grad.cu),
// Hessian-vector-product (hvp.cu), posterior (predict.cu), histogram
// (hist.cu) and refinement (refine.cu) kernels: block reductions, the
// per-slot Gaussian update and its pullback, the fusion step and the
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

// Cycle split of a walk (tools/k2_profile.py, tools/topk_profile.py), built
// only with -DEXTRACK_PROFILE: one lead thread per track adds the clock64()
// cycles since its last mark to section i, and at the end adds its sections
// to a device array that the host reads (extrack_grad_prof,
// extrack_topk_prof).  In a normal build every call is empty.
constexpr int kProfSlots = 12;
// sections of the forward walk (track_forward and K2's warp walk)
enum { kPfStash = 0, kPfStep = 1, kPfClose = 2 };
struct Prof {
#ifdef EXTRACK_PROFILE
  long long acc[kProfSlots];
  long long t;
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < kProfSlots; ++i) acc[i] = 0;
    t = clock64();
  }
  __device__ __forceinline__ void mark(int i) {
    const long long now = clock64();
    acc[i] += now - t;
    t = now;
  }
  __device__ __forceinline__ void flush(unsigned long long* out, bool lead) {
    if (lead)
      for (int i = 0; i < kProfSlots; ++i)
        atomicAdd(out + i, (unsigned long long)acc[i]);
  }
#else
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(unsigned long long*, bool) {}
#endif
};

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

// The sums of a fusion group's A members m0 .. m0+A-1 as published in `pub`
// (fuse_group's layout): their largest base log weight mx, the exp-sum sw
// of their weights shifted by mx (normalizers as rsqrt factors), and their
// weighted posterior means mf and tails tf, not yet divided by sw.
template <typename Real, int D>
static __device__ __forceinline__ void group_sums(const Real* pub, int K,
                                                  int m0, int A, Real& mx,
                                                  Real& sw, Real* mf,
                                                  Real* tf) {
  const Real* sbase = pub;
  const Real* srq = pub + K;
  const Real* snm = pub + 2 * K;
  const Real* stl = pub + (2 + D) * K;
  mx = Real(-INFINITY);
  for (int o = 0; o < A; ++o) mx = shift_max(mx, sbase[m0 + o]);
  sw = Real(0.f);
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
}

// One fusion step, shared by every kernel's walk: slot k publishes its
// Gaussian update `p` and base log weight `base` (lp - quad) to `pub`
// ((2+2D)*K scalars), then child k moment-matches the A members of its
// group, slots m0 .. m0+A-1 (m0 = (k % (K/A)) * A, computed by the caller),
// into m and s2 (plus the child's displacement variance sig2v[k]).  The
// per-step normalizers ride as rsqrt factors in the exp-sum shifted by the
// group's max base.  Returns the group's log mass (the caller adds the
// child's transition terms) and sets mx and inv_sw, so that member o's
// fusion weight is xexp(pub[m0+o] - mx) * pub[K+m0+o] * inv_sw.  `pub`
// stays readable until the caller's next barrier.
template <typename Real, int D>
static __device__ __forceinline__ Real fuse_group(
    const Prep<Real, D>& p, Real base, Real* m, Real* s2, const Real* sig2v,
    Real* pub, int K, int m0, int A, bool act, Real& mx, Real& inv_sw) {
  const int k = threadIdx.x;
  Real* sbase = pub;
  Real* srq = pub + K;
  Real* snm = pub + 2 * K;
  Real* stl = pub + (2 + D) * K;
  if (act) {
    sbase[k] = base;
    srq[k] = xrsqrt(p.prod);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      snm[d * K + k] = p.nm[d];
      stl[d * K + k] = p.tl[d];
    }
  }
  __syncthreads();
  if (!act) return Real(0.f);
  Real sw, mf[D], tf[D];
  group_sums<Real, D>(pub, K, m0, A, mx, sw, mf, tf);
  inv_sw = 1.0f / clamp_min(sw, kTiny);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    m[d] = mf[d] * inv_sw;
    s2[d] = sig2v[k] + tf[d] * inv_sw;
  }
  return mx + xlog(clamp_min(sw, kTiny));
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
                                     Real* close_mx, Real* close_sum,
                                     Prof* pf = nullptr) {
  const int K = tb.K, A = tb.A;
  const int k = threadIdx.x;
  const bool act = k < K;
  const int m0 = (k % (K / A)) * A;   // first member of child k's group
  const float cl2pi = 0.5f * D * kLog2Pi;

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
    if (pf) pf->mark(kPfStash);
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
      if (pf) pf->mark(kPfClose);
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
      if (pf) pf->mark(kPfClose);
    } else {
      // fuse the oldest digits; the 2*pi constants of the per-step
      // normalizers are folded into lt by the host
      Real mx = Real(0.f), inv_sw = Real(0.f);
      const Real lse = fuse_group<Real, D>(p, lp - p.quad, m, s2, tb.sig2v,
                                           sh, K, m0, A, act, mx, inv_sw);
      if (act) lp = lse + tb.lt[k] + gate * tb.lsurv[k];
      __syncthreads();
      if (pf) pf->mark(kPfStep);
    }
  }
  return out;
}

}  // namespace extrack
