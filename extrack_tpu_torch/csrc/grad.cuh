// The gradient walk of K2 (grad.cu), templated over the scalar type so that
// K3 (hvp.cu) runs the same code on dual numbers.  See grad.cu for what the
// kernel replaces and how it is laid out.
#pragma once

#include "common.cuh"

namespace extrack {

// One persistent block walks tracks blockIdx.x, blockIdx.x + gridDim.x, ...
// Outputs d(sum logL)/d(l2) per track and the per-block partial sums of the
// ten table cotangents (reduced by reduce_partials).
template <typename Real, int D>
__global__ void __launch_bounds__(1024)
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
  if (act)
    for (int a = 0; a < A; ++a)
      p_ltn[k * A + a] = p_s2n[k * A + a] = p_lsn[k * A + a] =
          p_endn[k * A + a] = Real(0.f);
  Real a_lp0 = Real(0.f), a_s20 = Real(0.f), a_lt = Real(0.f),
       a_lsurv = Real(0.f), a_end = Real(0.f), a_sig2v = Real(0.f);

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
                                            stash, &cmx, &csum);
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

      Real cb = Real(0.f), cnm[D], ctl[D];
#pragma unroll
      for (int d = 0; d < D; ++d) cnm[d] = ctl[d] = Real(0.f);
      if (L == 2) {
        // 2-frame closing: softmax posterior over the slots
        if (act) {
          const Real fin = lp + isbl * tb.endv[k] - 0.5f * xlog(p.prod) -
                           p.quad - cl2pi;
          const Real q = xexp(fin - cmx) / csum;
          a_end += isbl * q;
          cb = q;
        }
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
      } else {
        // fusion pullback.  The children's cotangents go through shared
        // memory to their group's members, next to the members' update.
        if (act) {
          a_lt += clp;
          a_lsurv += gate * clp;
          Real cs = Real(0.f);
#pragma unroll
          for (int d = 0; d < D; ++d) cs += cs2[d];
          a_sig2v += cs;
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
          const int m0 = g * A;
          Real mx = Real(-INFINITY);
          for (int o = 0; o < A; ++o) mx = shift_max(mx, sbase[m0 + o]);
          Real sw = Real(0.f), mf[D], tf[D], cmf[D], ctf[D];
#pragma unroll
          for (int d = 0; d < D; ++d)
            mf[d] = tf[d] = cmf[d] = ctf[d] = Real(0.f);
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
      a_lp0 += clp;
      a_s20 += cs;
    }
  }
  if (act) {
    part[0 * K + k] = a_lp0;
    part[1 * K + k] = a_s20;
    part[2 * K + k] = a_lt;
    part[3 * K + k] = a_lsurv;
    part[4 * K + k] = a_end;
    part[5 * K + k] = a_sig2v;
  }
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

template <typename Real, int D>
static int launch_grad(const TablesT<Real>& tb, const float* xs,
                       const Real* l2, const int* lengths, const float* isbl,
                       Real* logl, Real* ct_l2, Real* ct_tab, Real* stash,
                       Real* partial, int B, int T, int nblk,
                       cudaStream_t stream) {
  const int threads = (tb.K + 31) / 32 * 32;
  const size_t smem = (size_t)(3 + 4 * D) * tb.K * sizeof(Real);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(grad_kernel<Real, D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  grad_kernel<Real, D><<<nblk, threads, smem, stream>>>(
      tb, xs, l2, lengths, isbl, B, T, logl, ct_l2, stash, partial);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int ncols = (6 * tb.K + 4 * tb.K * tb.A) *
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
                         void* stream) {
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
                                  pa, B, T, nblk, st);
    case 2:
      return launch_grad<Real, 2>(tb, xs, l2r, lengths, isbl, lo, cl, ct, sa,
                                  pa, B, T, nblk, st);
    case 3:
      return launch_grad<Real, 3>(tb, xs, l2r, lengths, isbl, lo, cl, ct, sa,
                                  pa, B, T, nblk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace extrack
