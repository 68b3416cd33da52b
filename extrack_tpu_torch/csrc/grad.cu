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
#include "common.cuh"

namespace extrack {

template <int D>
__global__ void __launch_bounds__(1024)
    grad_kernel(Tables tb, const float* __restrict__ xs,
                const float* __restrict__ l2s, const int* __restrict__ lengths,
                const float* __restrict__ isbls, int B, int T,
                float* __restrict__ logl, float* __restrict__ ct_l2,
                float* __restrict__ stash_all, float* __restrict__ partial) {
  extern __shared__ float sh[];
  __shared__ float red[33];
  const int K = tb.K, A = tb.A, G = K / A;
  const int k = threadIdx.x;
  const bool act = k < K;
  const float cl2pi = 0.5f * D * kLog2Pi;

  float* sbase = sh;
  float* srq = sh + K;
  float* snm = sh + 2 * K;
  float* stl = sh + (2 + D) * K;
  float* sclp = sh + (2 + 2 * D) * K;
  float* scm = sclp + K;
  float* scs2 = scm + D * K;

  const size_t ncols = (size_t)6 * K + (size_t)4 * K * A;
  float* part = partial + blockIdx.x * ncols;
  float* p_ltn = part + 6 * K;
  float* p_s2n = p_ltn + K * A;
  float* p_lsn = p_s2n + K * A;
  float* p_endn = p_lsn + K * A;
  float* stash = stash_all + (size_t)blockIdx.x * (T - 1) * (2 * D + 1) * K;
  if (act)
    for (int a = 0; a < A; ++a)
      p_ltn[k * A + a] = p_s2n[k * A + a] = p_lsn[k * A + a] =
          p_endn[k * A + a] = 0.f;
  float a_lp0 = 0.f, a_s20 = 0.f, a_lt = 0.f, a_lsurv = 0.f, a_end = 0.f,
        a_sig2v = 0.f;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int L = min(lengths[b], T);
    if (L < 2) {            // empty / 1-frame rows: logL 0, ct_l2 stays 0
      if (k == 0) logl[b] = 0.f;
      continue;
    }
    const float* x = xs + (size_t)b * T * D;
    const float* l2 = l2s + (size_t)b * T * D;
    float* cl2 = ct_l2 + (size_t)b * T * D;
    const float isbl = isbls[b];
    float cmx, csum;
    const float out =
        track_forward<D>(tb, x, l2, L, isbl, sh, red, stash, &cmx, &csum);
    if (k == 0) logl[b] = out;

    // backward walk; (cm, cs2, clp) is the cotangent of the carry that
    // step t produced, i.e. of this thread's slot entering step t+1
    float cm[D], cs2[D], clp = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) cm[d] = cs2[d] = 0.f;
    const int tlast = L == 2 ? 1 : L - 2;
    for (int t = tlast; t >= 1; --t) {
      float m[D], s2[D], lp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        m[d] = 0.f;
        s2[d] = 1.f;
      }
      if (act) {
        const float* row = stash + (size_t)(t - 1) * (2 * D + 1) * K + k;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          m[d] = row[d * K];
          s2[d] = row[(D + d) * K];
        }
        lp = row[2 * D * K];
      }
      float xt[D], l2t[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xt[d] = x[t * D + d];
        l2t[d] = l2[t * D + d];
      }
      Prep<D> p;
      prep<D>(m, s2, xt, l2t, p);
      const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;

      float cb = 0.f, cnm[D], ctl[D];
#pragma unroll
      for (int d = 0; d < D; ++d) cnm[d] = ctl[d] = 0.f;
      if (L == 2) {
        // 2-frame closing: softmax posterior over the slots
        if (act) {
          const float fin = lp + isbl * tb.endv[k] - 0.5f * logf(p.prod) -
                            p.quad - cl2pi;
          const float q = expf(fin - cmx) / csum;
          a_end += isbl * q;
          cb = q;
        }
      } else if (t == tlast) {
        // look-ahead closing: q = posterior weight of child (k, a)
        float xn[D], l2n[D], invn[D], diffn[D], cl2n[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          xn[d] = x[(t + 1) * D + d];
          l2n[d] = l2[(t + 1) * D + d];
          cl2n[d] = 0.f;
        }
        if (act) {
          const float base_n = lp - p.quad - 0.5f * logf(p.prod) - cl2pi;
          const float inv_sum = 1.0f / csum;
          for (int a = 0; a < A; ++a) {
            const int ka = k * A + a;
            float r;
            const float g =
                base_n + tb.ltn[ka] + gate * tb.lsn[ka] + isbl * tb.endn[ka] +
                look_child<D>(p, xn, l2n, tb.s2n[ka], invn, diffn, r);
            const float q = expf(g - cmx) * r * inv_sum;
            p_ltn[ka] += q;
            p_lsn[ka] += gate * q;
            p_endn[ka] += isbl * q;
            float cs = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) {
              const float dn = diffn[d] * invn[d];
              const float ct_totn = 0.5f * q * (diffn[d] * dn - 1.f) * invn[d];
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
          const float v = block_sum(cl2n[d], red);
          if (k == 0) cl2[(t + 1) * D + d] = v;
        }
      } else {
        // fusion pullback.  The children's cotangents go through shared
        // memory to their group's members, next to the members' update.
        if (act) {
          a_lt += clp;
          a_lsurv += gate * clp;
          float cs = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) cs += cs2[d];
          a_sig2v += cs;
          sbase[k] = lp - p.quad;
          srq[k] = rsqrtf(p.prod);
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
          float mx = -INFINITY;
          for (int o = 0; o < A; ++o) mx = fmaxf(mx, sbase[m0 + o]);
          float sw = 0.f, mf[D], tf[D], cmf[D], ctf[D];
#pragma unroll
          for (int d = 0; d < D; ++d) mf[d] = tf[d] = cmf[d] = ctf[d] = 0.f;
          for (int o = 0; o < A; ++o) {
            const float w = expf(sbase[m0 + o] - mx) * srq[m0 + o];
            sw += w;
#pragma unroll
            for (int d = 0; d < D; ++d) {
              mf[d] += w * snm[d * K + m0 + o];
              tf[d] += w * stl[d * K + m0 + o];
            }
          }
          const float inv_sw = 1.0f / fmaxf(sw, kTiny);
          const float ok = sw >= kTiny ? 1.f : 0.f;
          const float wn = expf(sbase[k] - mx) * srq[k] * inv_sw;
          float clpf = 0.f;
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
          float fac = clpf, own = 0.f;
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
      float dm[D], ds2[D], dl2[D];
      prep_bwd<D>(m, s2, xt, l2t, p, cb, cnm, ctl, dm, ds2, dl2);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float v = block_sum(act ? dl2[d] : 0.f, red);
        if (k == 0) cl2[t * D + d] = v;
        cm[d] = act ? dm[d] : 0.f;
        cs2[d] = act ? ds2[d] : 0.f;
      }
      clp = act ? cb : 0.f;
    }
    // initial register: m = x_0 (no parameter), s2 = l2_0 + s20, lp = lp0
    float cs = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      cs += cs2[d];
      const float v = block_sum(cs2[d], red);
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
__global__ void reduce_partials(const float* __restrict__ partial, int nblk,
                                int ncols, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ncols) return;
  double s = 0.0;
  for (int i = 0; i < nblk; ++i) s += partial[(size_t)i * ncols + j];
  out[j] = (float)s;
}

template <int D>
static int launch_grad(const Tables& tb, const float* xs, const float* l2,
                       const int* lengths, const float* isbl, float* logl,
                       float* ct_l2, float* ct_tab, float* stash,
                       float* partial, int B, int T, int nblk,
                       cudaStream_t stream) {
  const int threads = (tb.K + 31) / 32 * 32;
  const size_t smem = (size_t)(3 + 4 * D) * tb.K * sizeof(float);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(grad_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  grad_kernel<D><<<nblk, threads, smem, stream>>>(
      tb, xs, l2, lengths, isbl, B, T, logl, ct_l2, stash, partial);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int ncols = 6 * tb.K + 4 * tb.K * tb.A;
  reduce_partials<<<(ncols + 255) / 256, 256, 0, stream>>>(partial, nblk,
                                                           ncols, ct_tab);
  return (int)cudaGetLastError();
}

}  // namespace extrack

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
  const extrack::Tables tb{lp0, s20, lt,  lsurv, endv, sig2v, ltn,
                           s2n, lsn, endn, K,    A,    min_len};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return extrack::launch_grad<1>(tb, xs, l2, lengths, isbl, logl, ct_l2,
                                     ct_tab, stash, partial, B, T, nblk, st);
    case 2:
      return extrack::launch_grad<2>(tb, xs, l2, lengths, isbl, logl, ct_l2,
                                     ct_tab, stash, partial, B, T, nblk, st);
    case 3:
      return extrack::launch_grad<3>(tb, xs, l2, lengths, isbl, logl, ct_l2,
                                     ct_tab, stash, partial, B, T, nblk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
