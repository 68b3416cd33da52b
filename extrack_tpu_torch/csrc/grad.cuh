// The gradient walk of K2 (grad.cu), templated over the scalar type so that
// K3 (hvp.cu) runs the same code on dual numbers.  See grad.cu for what the
// kernel replaces and how it is laid out.  Two mappings of a track onto
// threads: grad_warp_kernel (one warp per track, K <= 64) and grad_kernel
// (one block per track, any K up to 1024); the host picks one per launch.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace extrack {

// Sections of K2's cycle split (tools/k2_profile.py), after the forward
// walk's kPfStash, kPfStep and kPfClose (common.cuh).
enum {
  kPfStashRead = 3,   // the carry history read back
  kPfPrep = 4,        // the step's Gaussian update, recomputed
  kPfCloseBwd = 5,    // a closing's pullback and its (K, A) partials
  kPfFuseBwd = 6,     // the fusion pullback
  kPfL2Sum = 7,       // prep_bwd and the per-step l2-cotangent sums
  kPfInit = 8,        // the initial register's sums
  kPfPartials = 9,    // per-slot partial writes
};
#ifdef EXTRACK_PROFILE
static __device__ unsigned long long g_prof[kProfSlots];
#endif

constexpr int kWarpBlock = 128;    // largest warp-mapping block, 4 warps
constexpr int kBlockSmall = 256;   // block mapping's thread bounds, with
constexpr int kBlockMid = 512;     // 1024

// Blocks per SM each instantiation is compiled for (__launch_bounds__'
// second argument): the register cap, 65536 / (threads * blocks), that
// keeps the walk spill-free (ptxas -v).  The warp mapping's float walk fits
// 128 registers up to D = 2; D = 3 and dual numbers need up to 255.  The
// block mapping's walk fits 128 (its (K,) cotangents accumulate in the
// block's partial row, not in registers); at 64, which would keep twice
// the warps resident, it spills.  Blocks of 1024 threads get 64 registers
// whatever they ask: past 512 slots a track's walk state (80 to 128
// registers a slot) no longer fits one block's 64K registers, so that
// instantiation spills by construction.
template <typename Real, int D>
constexpr int warp_min_blocks() {
  return sizeof(Real) == sizeof(float) && D <= 2 ? 4 : 2;
}
template <int MaxT>
constexpr int block_min_blocks() {
  return MaxT == kBlockSmall ? 2 : 1;
}

// Block mapping.  One persistent block walks tracks blockIdx.x,
// blockIdx.x + gridDim.x, ..., thread k owning slot k (common.cuh).
// Outputs d(sum logL)/d(l2) per track and the per-block partial sums of the
// ten table cotangents (reduced by reduce_partials).  MaxT is the largest
// block it is launched with (kBlockSmall, kBlockMid or 1024).
template <typename Real, int D, int MaxT>
__global__ void __launch_bounds__(MaxT, block_min_blocks<MaxT>())
    grad_kernel(TablesT<Real> tb, const float* __restrict__ xs,
                const Real* __restrict__ l2s, const int* __restrict__ lengths,
                const float* __restrict__ isbls, int B, int T,
                Real* __restrict__ logl, Real* __restrict__ ct_l2,
                Real* __restrict__ stash_all, Real* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  Real* sh = reinterpret_cast<Real*>(sh_raw);
  __shared__ Real red[33];
  const int K = tb.K, A = tb.A, G = K / A;
  const int k = threadIdx.x;
  const bool act = k < K;
  const float cl2pi = 0.5f * D * kLog2Pi;

  Real* sbase = sh;
  Real* srq = sh + K;
  Real* snm = sh + 2 * K;
  Real* stl = sh + (2 + D) * K;
  Real* sclp = sh + (2 + 2 * D) * K;
  Real* scm = sclp + K;
  Real* scs2 = scm + D * K;

  const size_t ncols = (size_t)6 * K + (size_t)4 * K * A;
  Real* part = partial + blockIdx.x * ncols;
  Real* p_ltn = part + 6 * K;
  Real* p_s2n = p_ltn + K * A;
  Real* p_lsn = p_s2n + K * A;
  Real* p_endn = p_lsn + K * A;
  Real* stash = stash_all + (size_t)blockIdx.x * (T - 1) * (2 * D + 1) * K;
  // the (K,) tables' cotangents accumulate in the block's partial row too:
  // part[f * K + k] for lp0, s20, lt, lsurv, endv, sig2v
  Real* a_lp0 = part + k;
  Real* a_s20 = a_lp0 + K;
  Real* a_lt = a_s20 + K;
  Real* a_lsurv = a_lt + K;
  Real* a_end = a_lsurv + K;
  Real* a_sig2v = a_end + K;
  if (act) {
    for (int f = 0; f < 6; ++f) part[f * K + k] = Real(0.f);
    for (int a = 0; a < A; ++a)
      p_ltn[k * A + a] = p_s2n[k * A + a] = p_lsn[k * A + a] =
          p_endn[k * A + a] = Real(0.f);
  }
  Prof pf;
  pf.start();

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int L = min(lengths[b], T);
    if (L < 2) {            // empty / 1-frame rows: logL 0, ct_l2 stays 0
      if (k == 0) logl[b] = Real(0.f);
      continue;
    }
    const float* x = xs + (size_t)b * T * D;
    const Real* l2 = l2s + (size_t)b * T * D;
    Real* cl2 = ct_l2 + (size_t)b * T * D;
    const float isbl = isbls[b];
    Real cmx, csum;
    const Real out = track_forward<Real, D>(tb, x, l2, L, isbl, sh, red,
                                            stash, &cmx, &csum, &pf);
    if (k == 0) logl[b] = out;

    // backward walk; (cm, cs2, clp) is the cotangent of the carry that
    // step t produced, i.e. of this thread's slot entering step t+1
    Real cm[D], cs2[D], clp = Real(0.f);
#pragma unroll
    for (int d = 0; d < D; ++d) cm[d] = cs2[d] = Real(0.f);
    const int tlast = L == 2 ? 1 : L - 2;
    for (int t = tlast; t >= 1; --t) {
      Real m[D], s2[D], lp = Real(0.f);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        m[d] = Real(0.f);
        s2[d] = Real(1.f);
      }
      if (act) {
        const Real* row = stash + (size_t)(t - 1) * (2 * D + 1) * K + k;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          m[d] = row[d * K];
          s2[d] = row[(D + d) * K];
        }
        lp = row[2 * D * K];
      }
      pf.mark(kPfStashRead);
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
      pf.mark(kPfPrep);

      Real cb = Real(0.f), cnm[D], ctl[D];
#pragma unroll
      for (int d = 0; d < D; ++d) cnm[d] = ctl[d] = Real(0.f);
      if (L == 2) {
        // 2-frame closing: softmax posterior over the slots
        if (act) {
          const Real fin = lp + isbl * tb.endv[k] - 0.5f * xlog(p.prod) -
                           p.quad - cl2pi;
          const Real q = xexp(fin - cmx) / csum;
          *a_end += isbl * q;
          cb = q;
        }
        pf.mark(kPfCloseBwd);
      } else if (t == tlast) {
        // look-ahead closing: q = posterior weight of child (k, a)
        float xn[D];
        Real l2n[D], invn[D], diffn[D], cl2n[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          xn[d] = x[(t + 1) * D + d];
          l2n[d] = l2[(t + 1) * D + d];
          cl2n[d] = Real(0.f);
        }
        if (act) {
          const Real base_n = lp - p.quad - 0.5f * xlog(p.prod) - cl2pi;
          const Real inv_sum = 1.0f / csum;
          for (int a = 0; a < A; ++a) {
            const int ka = k * A + a;
            Real r;
            const Real g =
                base_n + tb.ltn[ka] + gate * tb.lsn[ka] + isbl * tb.endn[ka] +
                look_child<Real, D>(p, xn, l2n, tb.s2n[ka], invn, diffn, r);
            const Real q = xexp(g - cmx) * r * inv_sum;
            p_ltn[ka] += q;
            p_lsn[ka] += gate * q;
            p_endn[ka] += isbl * q;
            Real cs = Real(0.f);
#pragma unroll
            for (int d = 0; d < D; ++d) {
              const Real dn = diffn[d] * invn[d];
              const Real ct_totn = 0.5f * q * (diffn[d] * dn - 1.f) * invn[d];
              cnm[d] += q * dn;
              ctl[d] += ct_totn;
              cl2n[d] += ct_totn;
              cs += ct_totn;
            }
            p_s2n[ka] += cs;
            cb += q;
          }
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const Real v = block_sum(cl2n[d], red);
          if (k == 0) cl2[(t + 1) * D + d] = v;
        }
        pf.mark(kPfCloseBwd);
      } else {
        // fusion pullback.  The children's cotangents go through shared
        // memory to their group's members, next to the members' update.
        if (act) {
          *a_lt += clp;
          *a_lsurv += gate * clp;
          Real cs = Real(0.f);
#pragma unroll
          for (int d = 0; d < D; ++d) cs += cs2[d];
          *a_sig2v += cs;
          sbase[k] = lp - p.quad;
          srq[k] = xrsqrt(p.prod);
          sclp[k] = clp;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            snm[d * K + k] = p.nm[d];
            stl[d * K + k] = p.tl[d];
            scm[d * K + k] = cm[d];
            scs2[d * K + k] = cs2[d];
          }
        }
        __syncthreads();
        if (act) {
          const int g = k / A;           // this slot's fusion group
          Real mx, sw, mf[D], tf[D], cmf[D], ctf[D];
          group_sums<Real, D>(sh, K, g * A, A, mx, sw, mf, tf);
#pragma unroll
          for (int d = 0; d < D; ++d) cmf[d] = ctf[d] = Real(0.f);
          const Real inv_sw = 1.0f / clamp_min(sw, kTiny);
          // the guard's indicator has a zero tangent
          const float ok = val(sw) >= kTiny ? 1.f : 0.f;
          const Real wn = xexp(sbase[k] - mx) * srq[k] * inv_sw;
          Real clpf = Real(0.f);
          for (int a = 0; a < A; ++a) {
            const int c = a * G + g;     // child of group g under pattern a
            clpf += sclp[c];
#pragma unroll
            for (int d = 0; d < D; ++d) {
              cmf[d] += scm[d * K + c];
              ctf[d] += scs2[d * K + c];
            }
          }
          // softmax-mixture rule: the sw factors cancel against wn
          Real fac = clpf, own = Real(0.f);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            fac -= (cmf[d] * mf[d] + ctf[d] * tf[d]) * inv_sw;
            own += cmf[d] * p.nm[d] + ctf[d] * p.tl[d];
          }
          cb = (ok * fac + own) * wn;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            cnm[d] = cmf[d] * wn;
            ctl[d] = ctf[d] * wn;
          }
        }
        __syncthreads();
        pf.mark(kPfFuseBwd);
      }
      Real dm[D], ds2[D], dl2[D];
      prep_bwd<Real, D>(m, s2, xt, l2t, p, cb, cnm, ctl, dm, ds2, dl2);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const Real v = block_sum(act ? dl2[d] : Real(0.f), red);
        if (k == 0) cl2[t * D + d] = v;
        cm[d] = act ? dm[d] : Real(0.f);
        cs2[d] = act ? ds2[d] : Real(0.f);
      }
      clp = act ? cb : Real(0.f);
      pf.mark(kPfL2Sum);
    }
    // initial register: m = x_0 (no parameter), s2 = l2_0 + s20, lp = lp0
    Real cs = Real(0.f);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      cs += cs2[d];
      const Real v = block_sum(cs2[d], red);
      if (k == 0) cl2[d] = v;
    }
    if (act) {
      *a_lp0 += clp;
      *a_s20 += cs;
    }
    pf.mark(kPfInit);
  }
  pf.mark(kPfPartials);
#ifdef EXTRACK_PROFILE
  pf.flush(g_prof, k == 0);
#endif
}



// Scalars of one warp's slice of shared memory in grad_warp_kernel: the
// publish area, the cotangent accumulators, two buffers of a track's
// positions, variances, length and flag, and, when it lives there, the
// carry history.
static __host__ __device__ inline size_t warp_slice(int K, int A, int D,
                                                    int T, int stash_smem) {
  return (size_t)(9 + 4 * D) * K + (size_t)4 * K * A + (size_t)4 * T * D + 4 +
         (stash_smem ? (size_t)(T - 1) * (2 * D + 1) * K : 0);
}

// Warp mapping, for K <= 64.  Warp w of block i walks tracks
// i * wpb + w, then + gridDim.x * wpb, ...; lane l owns slots l and, when
// J = 2 (K > 32), l + 32; lanes past K idle.  The walk is
// grad_kernel's, slot for slot, but a fusion step's exchange goes through
// the warp's own slice of shared memory between __syncwarp()s and every
// reduction over the slots is a warp shuffle: the walk has no block
// barrier.  The warp's slice (warp_slice) holds the publish area
// ((3+4D)K scalars), the cotangent accumulators of its tracks (6K for the
// (K,) tables, then 4KA, [table][pattern][slot]; lane-private), the
// track's positions, variances, length and flag, double-buffered: the
// next track's are copied in by cp.async while the warp walks this one;
// and, when stash_smem, the carry history ((T-1)(2D+1)K); else the
// history is the warp's slice of stash_all.
// At the end the block sums its warps' partials in warp order (its one
// barrier) into its row of `partial`.
template <typename Real, int D, int J>
__global__ void __launch_bounds__(kWarpBlock, (warp_min_blocks<Real, D>()))
    grad_warp_kernel(TablesT<Real> tb, const float* __restrict__ xs,
                     const Real* __restrict__ l2s,
                     const int* __restrict__ lengths,
                     const float* __restrict__ isbls, int B, int T,
                     Real* __restrict__ logl, Real* __restrict__ ct_l2,
                     Real* __restrict__ stash_all, Real* __restrict__ partial,
                     int stash_smem) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  const int K = tb.K, A = tb.A, G = K / A;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const float cl2pi = 0.5f * D * kLog2Pi;
  const size_t hist_n = (size_t)(T - 1) * (2 * D + 1) * K;
  const size_t pub_n = (size_t)(3 + 4 * D) * K;
  const size_t acc_n = (size_t)6 * K + (size_t)4 * K * A;
  const size_t slice = warp_slice(K, A, D, T, stash_smem);
  Real* const smem = reinterpret_cast<Real*>(sh_raw);
  Real* ws = smem + wib * slice;
  Real* sbase = ws;
  Real* srq = ws + K;
  Real* sclp = ws + (2 + 2 * D) * K;
  Real* scm = sclp + K;
  Real* scs2 = scm + D * K;
  Real* kacc = ws + pub_n;                    // (K,) tables' cotangents
  Real* pacc = kacc + 6 * K;                  // (K, A) tables'
  // two buffers of (T, D) variances, then (T, D) positions; length, flag
  Real* rows = kacc + acc_n;
  int* meta = reinterpret_cast<int*>(rows + 4 * T * D);
  const int gw = blockIdx.x * wpb + wib, nwarps = gridDim.x * wpb;
  Real* stash = stash_smem ? rows + 4 * T * D + 4
                           : stash_all + (size_t)gw * hist_n;

  int ks[J];
  bool act[J];
  // the (K,) accumulators, kacc[f * K + k]: lp0, s20, lt, lsurv, endv, sig2v
  enum { kLp0 = 0, kS20 = 1, kLt = 2, kLsurv = 3, kEnd = 4, kSig2v = 5 };
#pragma unroll
  for (int j = 0; j < J; ++j) {
    ks[j] = j * 32 + lane;
    act[j] = ks[j] < K;
    if (act[j]) {
      const int k = ks[j];
      for (int i = 0; i < 6 + 4 * A; ++i) kacc[i * K + k] = Real(0.f);
    }
  }
  // both of a lane's children in one fusion group (K = 64 at any A): one
  // fusion
  const bool one_group = J == 2 && ks[0] % G == ks[J - 1] % G;
  Prof pf;
  pf.start();

  // track bb's rows, length and flag into buffer `buf`, asynchronously
  const int TD = T * D;
  auto fetch = [&](int bb, int buf) {
    Real* l2d = rows + buf * 2 * TD;
    float* xd = reinterpret_cast<float*>(l2d + TD);
    for (int i = lane; i < TD; i += 32) {
      __pipeline_memcpy_async(l2d + i, l2s + (size_t)bb * TD + i,
                              sizeof(Real));
      __pipeline_memcpy_async(xd + i, xs + (size_t)bb * TD + i,
                              sizeof(float));
    }
    if (lane == 0) {
      __pipeline_memcpy_async(meta + 2 * buf, lengths + bb, sizeof(int));
      __pipeline_memcpy_async(meta + 2 * buf + 1, isbls + bb, sizeof(float));
    }
    __pipeline_commit();
  };
  if (gw < B) fetch(gw, 0);
  int buf = 0;
  for (int b = gw; b < B; b += nwarps, buf ^= 1) {
    __pipeline_wait_prior(0);
    __syncwarp();           // this track's rows landed; the last one's read
    const Real* l2 = rows + buf * 2 * TD;
    const float* x = reinterpret_cast<const float*>(l2 + TD);
    const int L = min(meta[2 * buf], T);
    const float isbl = __int_as_float(meta[2 * buf + 1]);
    if (b + nwarps < B) fetch(b + nwarps, buf ^ 1);
    if (L < 2) {            // empty / 1-frame rows: logL 0, ct_l2 stays 0
      if (lane == 0) logl[b] = Real(0.f);
      continue;
    }
    Real* cl2 = ct_l2 + (size_t)b * T * D;
    const int tlast = L == 2 ? 1 : L - 2;

    // forward walk (track_forward), stashing each step's entering carry
    Real m[J][D], s2[J][D], lp[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      lp[j] = act[j] ? tb.lp0[ks[j]] : Real(0.f);
      const Real s20 = act[j] ? tb.s20[ks[j]] : Real(1.f);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        m[j][d] = Real(x[d]);
        s2[j][d] = l2[d] + s20;
      }
    }
    Real cmx = Real(0.f), csum = Real(1.f), out = Real(0.f);
    for (int t = 1; t <= tlast; ++t) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (!act[j]) continue;
        Real* row = stash + (size_t)(t - 1) * (2 * D + 1) * K + ks[j];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          row[d * K] = m[j][d];
          row[(D + d) * K] = s2[j][d];
        }
        row[2 * D * K] = lp[j];
      }
      pf.mark(kPfStash);
      float xt[D];
      Real l2t[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xt[d] = x[t * D + d];
        l2t[d] = l2[t * D + d];
      }
      Prep<Real, D> p[J];
#pragma unroll
      for (int j = 0; j < J; ++j) prep<Real, D>(m[j], s2[j], xt, l2t, p[j]);
      const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;
      if (L == 2) {
        Real fin[J], mx = Real(-INFINITY);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          fin[j] = act[j] ? lp[j] + isbl * tb.endv[ks[j]] -
                                0.5f * xlog(p[j].prod) - p[j].quad - cl2pi
                          : Real(-INFINITY);
          mx = shift_max(mx, fin[j]);
        }
        mx = warp_max(mx);
        Real e = Real(0.f);
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (act[j]) e += xexp(fin[j] - mx);
        cmx = mx;
        csum = warp_sum(e);
        out = mx + xlog(csum);
        pf.mark(kPfClose);
      } else if (t == tlast) {
        float xn[D];
        Real l2n[D], invn[D], diffn[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          xn[d] = x[(t + 1) * D + d];
          l2n[d] = l2[(t + 1) * D + d];
        }
        Real gmax = Real(-INFINITY);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const Real base_n =
              lp[j] - p[j].quad - 0.5f * xlog(p[j].prod) - cl2pi;
          for (int a = 0; a < A; ++a) {
            const int ka = ks[j] * A + a;
            Real r;
            const Real g = base_n + tb.ltn[ka] + gate * tb.lsn[ka] +
                           isbl * tb.endn[ka] +
                           look_child<Real, D>(p[j], xn, l2n, tb.s2n[ka],
                                               invn, diffn, r);
            gmax = shift_max(gmax, g);
          }
        }
        const Real mx = warp_max(gmax);
        Real sl = Real(0.f);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const Real base_n =
              lp[j] - p[j].quad - 0.5f * xlog(p[j].prod) - cl2pi;
          for (int a = 0; a < A; ++a) {
            const int ka = ks[j] * A + a;
            Real r;
            const Real g = base_n + tb.ltn[ka] + gate * tb.lsn[ka] +
                           isbl * tb.endn[ka] +
                           look_child<Real, D>(p[j], xn, l2n, tb.s2n[ka],
                                               invn, diffn, r);
            sl += xexp(g - mx) * r;
          }
        }
        cmx = mx;
        csum = warp_sum(sl);
        out = mx + xlog(csum);
        pf.mark(kPfClose);
      } else {
        // fusion: publish, then each child reads its group's members
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const int k = ks[j];
          sbase[k] = lp[j] - p[j].quad;
          srq[k] = xrsqrt(p[j].prod);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            ws[(2 + d) * K + k] = p[j].nm[d];
            ws[(2 + D + d) * K + k] = p[j].tl[d];
          }
        }
        __syncwarp();
        Real mx, sw, mf[D], tf[D], inv_sw, lse;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          if (j == 0 || !one_group) {
            group_sums<Real, D>(ws, K, (ks[j] % G) * A, A, mx, sw, mf, tf);
            inv_sw = 1.0f / clamp_min(sw, kTiny);
            lse = mx + xlog(clamp_min(sw, kTiny));
          }
#pragma unroll
          for (int d = 0; d < D; ++d) {
            m[j][d] = mf[d] * inv_sw;
            s2[j][d] = tb.sig2v[ks[j]] + tf[d] * inv_sw;
          }
          lp[j] = lse + tb.lt[ks[j]] + gate * tb.lsurv[ks[j]];
        }
        __syncwarp();
        pf.mark(kPfStep);
      }
    }
    if (lane == 0) logl[b] = out;

    // backward walk; (cm, cs2, clp) is the cotangent of the carry that
    // step t produced, i.e. of the lane's slots entering step t+1
    Real cm[J][D], cs2[J][D], clp[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      clp[j] = Real(0.f);
#pragma unroll
      for (int d = 0; d < D; ++d) cm[j][d] = cs2[j][d] = Real(0.f);
    }
    for (int t = tlast; t >= 1; --t) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        lp[j] = Real(0.f);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          m[j][d] = Real(0.f);
          s2[j][d] = Real(1.f);
        }
        if (act[j]) {
          const Real* row = stash + (size_t)(t - 1) * (2 * D + 1) * K + ks[j];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            m[j][d] = row[d * K];
            s2[j][d] = row[(D + d) * K];
          }
          lp[j] = row[2 * D * K];
        }
      }
      pf.mark(kPfStashRead);
      float xt[D];
      Real l2t[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xt[d] = x[t * D + d];
        l2t[d] = l2[t * D + d];
      }
      Prep<Real, D> p[J];
#pragma unroll
      for (int j = 0; j < J; ++j) prep<Real, D>(m[j], s2[j], xt, l2t, p[j]);
      const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;
      pf.mark(kPfPrep);

      Real cb[J], cnm[J][D], ctl[J][D];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        cb[j] = Real(0.f);
#pragma unroll
        for (int d = 0; d < D; ++d) cnm[j][d] = ctl[j][d] = Real(0.f);
      }
      if (L == 2) {
        // 2-frame closing: softmax posterior over the slots
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const Real fin = lp[j] + isbl * tb.endv[ks[j]] -
                           0.5f * xlog(p[j].prod) - p[j].quad - cl2pi;
          const Real q = xexp(fin - cmx) / csum;
          kacc[kEnd * K + ks[j]] += isbl * q;
          cb[j] = q;
        }
        pf.mark(kPfCloseBwd);
      } else if (t == tlast) {
        // look-ahead closing: q = posterior weight of child (k, a)
        float xn[D];
        Real l2n[D], invn[D], diffn[D], cl2n[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          xn[d] = x[(t + 1) * D + d];
          l2n[d] = l2[(t + 1) * D + d];
          cl2n[d] = Real(0.f);
        }
        const Real inv_sum = 1.0f / csum;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const int k = ks[j];
          const Real base_n =
              lp[j] - p[j].quad - 0.5f * xlog(p[j].prod) - cl2pi;
          for (int a = 0; a < A; ++a) {
            const int ka = k * A + a;
            Real r;
            const Real g = base_n + tb.ltn[ka] + gate * tb.lsn[ka] +
                           isbl * tb.endn[ka] +
                           look_child<Real, D>(p[j], xn, l2n, tb.s2n[ka],
                                               invn, diffn, r);
            const Real q = xexp(g - cmx) * r * inv_sum;
            pacc[(0 * A + a) * K + k] += q;
            pacc[(2 * A + a) * K + k] += gate * q;
            pacc[(3 * A + a) * K + k] += isbl * q;
            Real cs = Real(0.f);
#pragma unroll
            for (int d = 0; d < D; ++d) {
              const Real dn = diffn[d] * invn[d];
              const Real ct_totn = 0.5f * q * (diffn[d] * dn - 1.f) * invn[d];
              cnm[j][d] += q * dn;
              ctl[j][d] += ct_totn;
              cl2n[d] += ct_totn;
              cs += ct_totn;
            }
            pacc[(1 * A + a) * K + k] += cs;
            cb[j] += q;
          }
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const Real v = warp_sum(cl2n[d]);
          if (lane == 0) cl2[(t + 1) * D + d] = v;
        }
        pf.mark(kPfCloseBwd);
      } else {
        // fusion pullback: the children's cotangents go through the warp's
        // slice to their group's members, next to the members' update
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const int k = ks[j];
          kacc[kLt * K + k] += clp[j];
          kacc[kLsurv * K + k] += gate * clp[j];
          Real cs = Real(0.f);
#pragma unroll
          for (int d = 0; d < D; ++d) cs += cs2[j][d];
          kacc[kSig2v * K + k] += cs;
          sbase[k] = lp[j] - p[j].quad;
          srq[k] = xrsqrt(p[j].prod);
          sclp[k] = clp[j];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            ws[(2 + d) * K + k] = p[j].nm[d];
            ws[(2 + D + d) * K + k] = p[j].tl[d];
            scm[d * K + k] = cm[j][d];
            scs2[d * K + k] = cs2[j][d];
          }
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const int k = ks[j];
          const int g = k / A;           // this slot's fusion group
          Real mx, sw, mf[D], tf[D], cmf[D], ctf[D];
          group_sums<Real, D>(ws, K, g * A, A, mx, sw, mf, tf);
#pragma unroll
          for (int d = 0; d < D; ++d) cmf[d] = ctf[d] = Real(0.f);
          const Real inv_sw = 1.0f / clamp_min(sw, kTiny);
          // the guard's indicator has a zero tangent
          const float ok = val(sw) >= kTiny ? 1.f : 0.f;
          const Real wn = xexp(sbase[k] - mx) * srq[k] * inv_sw;
          Real clpf = Real(0.f);
          for (int a = 0; a < A; ++a) {
            const int c = a * G + g;     // child of group g under pattern a
            clpf += sclp[c];
#pragma unroll
            for (int d = 0; d < D; ++d) {
              cmf[d] += scm[d * K + c];
              ctf[d] += scs2[d * K + c];
            }
          }
          // softmax-mixture rule: the sw factors cancel against wn
          Real fac = clpf, own = Real(0.f);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            fac -= (cmf[d] * mf[d] + ctf[d] * tf[d]) * inv_sw;
            own += cmf[d] * p[j].nm[d] + ctf[d] * p[j].tl[d];
          }
          cb[j] = (ok * fac + own) * wn;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            cnm[j][d] = cmf[d] * wn;
            ctl[j][d] = ctf[d] * wn;
          }
        }
        __syncwarp();
        pf.mark(kPfFuseBwd);
      }
      Real dl2s[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dl2s[d] = Real(0.f);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        Real dm[D], ds2[D], dl2[D];
        prep_bwd<Real, D>(m[j], s2[j], xt, l2t, p[j], cb[j], cnm[j], ctl[j],
                          dm, ds2, dl2);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          if (act[j]) dl2s[d] += dl2[d];
          cm[j][d] = act[j] ? dm[d] : Real(0.f);
          cs2[j][d] = act[j] ? ds2[d] : Real(0.f);
        }
        clp[j] = act[j] ? cb[j] : Real(0.f);
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const Real v = warp_sum(dl2s[d]);
        if (lane == 0) cl2[t * D + d] = v;
      }
      pf.mark(kPfL2Sum);
    }
    // initial register: m = x_0 (no parameter), s2 = l2_0 + s20, lp = lp0
#pragma unroll
    for (int d = 0; d < D; ++d) {
      Real c = Real(0.f);
#pragma unroll
      for (int j = 0; j < J; ++j) c += cs2[j][d];
      const Real v = warp_sum(c);
      if (lane == 0) cl2[d] = v;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (!act[j]) continue;
      Real cs = Real(0.f);
#pragma unroll
      for (int d = 0; d < D; ++d) cs += cs2[j][d];
      kacc[kLp0 * K + ks[j]] += clp[j];
      kacc[kS20 * K + ks[j]] += cs;
    }
    pf.mark(kPfInit);
  }
  // the block's partial: every column summed over the warps in warp order
  __syncthreads();
  const int ncols = 6 * K + 4 * K * A;
  Real* part = partial + (size_t)blockIdx.x * ncols;
  for (int col = threadIdx.x; col < ncols; col += blockDim.x) {
    // (K, A) column f*K*A + k*A + a sits at [f][a][k] in the accumulators
    const int c = col - 6 * K, f = c / (K * A), k = (c % (K * A)) / A;
    const size_t off = pub_n + (col < 6 * K ? (size_t)col
                                            : 6 * (size_t)K +
                                                  (size_t)(f * A + c % A) * K +
                                                  k);
    Real acc = Real(0.f);
    for (int w = 0; w < wpb; ++w) acc += smem[w * slice + off];
    part[col] = acc;
  }
  pf.mark(kPfPartials);
#ifdef EXTRACK_PROFILE
  pf.flush(g_prof, lane == 0);
#endif
}

// out[j] = sum over blocks of partial[blk][j], in block order, in double.
// Works on the floats of any scalar type (a Dual column is two floats).
static __global__ void reduce_partials(const float* __restrict__ partial,
                                       int nblk, int ncols,
                                       float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ncols) return;
  double s = 0.0;
  for (int i = 0; i < nblk; ++i) s += partial[(size_t)i * ncols + j];
  out[j] = (float)s;
}

// The kernel instantiation that launch_grad runs for this K and mapping
// (warps > 0: the warp mapping with `warps` warps per block).
template <typename Real, int D>
static const void* grad_instance(int K, int warps) {
  if (warps > 0)
    return K <= 32 ? (const void*)grad_warp_kernel<Real, D, 1>
                   : (const void*)grad_warp_kernel<Real, D, 2>;
  const int threads = (K + 31) / 32 * 32;
  return threads <= kBlockSmall ? (const void*)grad_kernel<Real, D, kBlockSmall>
         : threads <= kBlockMid ? (const void*)grad_kernel<Real, D, kBlockMid>
                                : (const void*)grad_kernel<Real, D, 1024>;
}

// Dynamic shared memory of one block, as launch_grad asks for it.
template <typename Real>
static size_t grad_smem(int K, int A, int D, int T, int warps,
                        int stash_smem) {
  return (warps > 0 ? warps * warp_slice(K, A, D, T, stash_smem)
                    : (size_t)(3 + 4 * D) * K) *
         sizeof(Real);
}

// Blocks of a K2 (or K3) launch one SM keeps resident, or -error.
template <typename Real, int D>
static int grad_occupancy(int K, int A, int T, int warps, int stash_smem) {
  const void* fn = grad_instance<Real, D>(K, warps);
  const size_t smem = grad_smem<Real>(K, A, D, T, warps, stash_smem);
  const int threads = warps > 0 ? 32 * warps : (K + 31) / 32 * 32;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads,
                                                        smem);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename Real, int D>
static int launch_grad(const TablesT<Real>& tb, const float* xs,
                       const Real* l2, const int* lengths, const float* isbl,
                       Real* logl, Real* ct_l2, Real* ct_tab, Real* stash,
                       Real* partial, int B, int T, int nblk, int warps,
                       int stash_smem, cudaStream_t stream) {
  const int K = tb.K;
  if (warps < 0 || 32 * warps > kWarpBlock || (warps > 0 && K > 64) ||
      (warps == 0 && stash_smem))
    return (int)cudaErrorInvalidValue;
  const void* fn = grad_instance<Real, D>(K, warps);
  const size_t smem = grad_smem<Real>(K, tb.A, D, T, warps, stash_smem);
  // the opt-in covers the static shared memory's share of the 48 KB too
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int threads = warps > 0 ? 32 * warps : (K + 31) / 32 * 32;
  if (warps > 0) {
    void* args[] = {(void*)&tb, (void*)&xs, (void*)&l2, (void*)&lengths,
                    (void*)&isbl, (void*)&B, (void*)&T, (void*)&logl,
                    (void*)&ct_l2, (void*)&stash, (void*)&partial,
                    (void*)&stash_smem};
    cudaLaunchKernel(fn, nblk, threads, args, smem, stream);
  } else {
    void* args[] = {(void*)&tb, (void*)&xs, (void*)&l2, (void*)&lengths,
                    (void*)&isbl, (void*)&B, (void*)&T, (void*)&logl,
                    (void*)&ct_l2, (void*)&stash, (void*)&partial};
    cudaLaunchKernel(fn, nblk, threads, args, smem, stream);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int ncols = (6 * K + 4 * K * tb.A) *
                    (int)(sizeof(Real) / sizeof(float));
  reduce_partials<<<(ncols + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const float*>(partial), nblk, ncols,
      reinterpret_cast<float*>(ct_tab));
  return (int)cudaGetLastError();
}

// The C entry points of K2 and K3 share one argument list; Real is float
// (K2) or Dual (K3), every Real array given as floats (a Dual array as
// interleaved value / tangent pairs).
template <typename Real>
static int launch_grad_c(const float* xs, const float* l2,
                         const int* lengths, const float* isbl,
                         const float* const* tabs, float* logl, float* ct_l2,
                         float* ct_tab, float* stash, float* partial, int B,
                         int T, int D, int K, int A, int min_len, int nblk,
                         int warps, int stash_smem, void* stream) {
  const Real* t[10];
  for (int i = 0; i < 10; ++i) t[i] = reinterpret_cast<const Real*>(tabs[i]);
  const TablesT<Real> tb{t[0], t[1], t[2], t[3], t[4], t[5], t[6],
                         t[7], t[8], t[9], K,    A,    min_len};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Real* l2r = reinterpret_cast<const Real*>(l2);
  Real* lo = reinterpret_cast<Real*>(logl);
  Real* cl = reinterpret_cast<Real*>(ct_l2);
  Real* ct = reinterpret_cast<Real*>(ct_tab);
  Real* sa = reinterpret_cast<Real*>(stash);
  Real* pa = reinterpret_cast<Real*>(partial);
  switch (D) {
    case 1:
      return launch_grad<Real, 1>(tb, xs, l2r, lengths, isbl, lo, cl, ct, sa,
                                  pa, B, T, nblk, warps, stash_smem, st);
    case 2:
      return launch_grad<Real, 2>(tb, xs, l2r, lengths, isbl, lo, cl, ct, sa,
                                  pa, B, T, nblk, warps, stash_smem, st);
    case 3:
      return launch_grad<Real, 3>(tb, xs, l2r, lengths, isbl, lo, cl, ct, sa,
                                  pa, B, T, nblk, warps, stash_smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Occupancy query behind extrack_grad_occupancy / extrack_hvp_occupancy.
template <typename Real>
static int grad_occupancy_c(int D, int K, int A, int T, int warps,
                            int stash_smem) {
  switch (D) {
    case 1: return grad_occupancy<Real, 1>(K, A, T, warps, stash_smem);
    case 2: return grad_occupancy<Real, 2>(K, A, T, warps, stash_smem);
    case 3: return grad_occupancy<Real, 3>(K, A, T, warps, stash_smem);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace extrack
