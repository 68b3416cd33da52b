// K5's block mapping (a thread a slot, up to 1024 slots): the device code
// and its launchers, instantiated by hist.cu (constant dt) and hist_vdt.cu
// (variable dt), two translation units that nvcc compiles side by side.
// The algorithm is described in hist.cu.
#pragma once

#include "hist.cuh"

namespace extrack {

static __device__ unsigned long long g_hist_prof[kProfSlots];

// Group g's run/hist bins at step t that child a takes, from the rows
// `cur` of the previous step into `nxt` (bin r of set u = 0 (run), 1+s
// (hist of state s) at (u*T + r)*G + g).  mb0 = (g*A) % G is the members'
// first group (`wrap`: A does not divide G, member o's group is o % G), q
// the group's state a frame newer than the oldest.  MS = A (2, 3 or 4):
// the members' weights w in registers and every member loop unrolled, SS
// = S their states; MS = SS = 0, any S and A: the weights recomputed from
// the fusion's `pub`, mx and inv_sw.  SUB: more than one sub-step a frame
// (A = S^n > S); without it A == S and member o's oldest state is o.
template <int MS, int SS, bool SUB>
static __device__ __forceinline__ void transport(
    const float* cur, float* nxt, int G, int T, int S, int A, int t,
    bool drop, int g, int a, int q, int mb0, bool wrap, const float* w,
    const float* pub, int K, int m0, float mx, float inv_sw) {
  auto wt = [&](int o) {
    if constexpr (MS > 0) {
      float v = w[0];
#pragma unroll
      for (int i = 1; i < MS; ++i)
        if (i == o) v = w[i];
      return v;
    } else {
      return ex2(pub[m0 + o] - mx) * pub[K + m0 + o] * inv_sw;
    }
  };
  // member o's rows: those of group (g*A + o) % G
  auto row = [&](int o) {
    if constexpr (MS > 0 || !SUB) {
      return mb0 + o;
    } else {
      return wrap ? o % G : mb0 + o;
    }
  };
  // the weighted sum over the members of row u, bin r
  auto mix = [&](int u, int r) {
    const float* in = cur + (size_t)(u * T + r) * G;
    float v = 0.f;
    if constexpr (MS > 0) {
      in += mb0;
#pragma unroll
      for (int o = 0; o < MS; ++o) v = fmaf(w[o], in[o], v);
    } else if constexpr (!SUB) {
      in += mb0;
      for (int o = 0; o < S; ++o) v = fmaf(wt(o), in[o], v);
    } else {
      for (int o = 0; o < A; ++o) v = fmaf(wt(o), in[row(o)], v);
    }
    return v;
  };
  const int nb = min(t + 1, T);        // bins written at this step
  const int nold = min(t, T);          // bins the sources hold
  if constexpr (!SUB) {
    // one sub-step: member o's oldest state is o
    if (drop) {
      const float wq = wt(q);
      for (int r = a; r < nb; r += S)
        nxt[(size_t)r * G + g] =
            r == 0 ? 1.f - wq : wq * cur[(size_t)(r - 1) * G + mb0 + q];
    } else {
      for (int r = a; r < nb; r += S)
        nxt[(size_t)r * G + g] = r < nold ? mix(0, r) : 0.f;
    }
    for (int s = 0; s < S; ++s) {
      const float cs = drop && s != q ? wt(s) : 0.f;
      for (int r = a; r < nb; r += S)
        nxt[(size_t)((1 + s) * T + r) * G + g] =
            r < nold ? fmaf(cs, cur[(size_t)r * G + mb0 + s], mix(1 + s, r))
                     : 0.f;
    }
  } else {
    // A = S^n members: member o's oldest state is o % S; the runs of the
    // members o = q, q+S, ... go on across the drop, the others end
    const int nS = SS > 0 ? SS : S, nA = MS > 0 ? MS : A;
    if (drop) {
      float wq = 0.f;
      for (int o = q; o < nA; o += nS) wq += wt(o);
      for (int r = a; r < nb; r += nA) {
        float v = 1.f - wq;
        if (r > 0) {
          v = 0.f;
          for (int o = q; o < nA; o += nS)
            v = fmaf(wt(o), cur[(size_t)(r - 1) * G + row(o)], v);
        }
        nxt[(size_t)r * G + g] = v;
      }
    } else {
      for (int r = a; r < nb; r += nA)
        nxt[(size_t)r * G + g] = r < nold ? mix(0, r) : 0.f;
    }
    for (int s = 0; s < S; ++s) {
      const bool ends = drop && s != q;   // runs of oldest state s end
      for (int r = a; r < nb; r += nA) {
        float v = 0.f;
        if (r < nold) {
          v = mix(1 + s, r);
          if (ends)
            for (int o = s; o < nA; o += nS)
              v = fmaf(wt(o), cur[(size_t)r * G + row(o)], v);
        }
        nxt[(size_t)((1 + s) * T + r) * G + g] = v;
      }
    }
  }
}

// One fusion and transport step of thread k (after the publish barrier):
// gather2 with the members' weights, then transport<MS, SS, SUB>.
template <int D, int MS, int SS, bool SUB>
static __device__ __forceinline__ void fuse_step(
    bool act, float* m, float* s2, float& lp, const float* pub, float add,
    float sig2v_k, int K, int m0, const float* cur, float* nxt, int G, int T,
    int S, int A, int t, bool drop, int g, int a, int q, int mb0, bool wrap,
    Prof& pf) {
  float gmx = 0.f, ginv = 0.f, w[MS > 0 ? MS : 1];
  gather2<D, MS>(act, m, s2, lp, pub, add, sig2v_k, K, m0, A, gmx, ginv, w);
  pf.mark(kHsFusion);
  if (act)
    transport<MS, SS, SUB>(cur, nxt, G, T, S, A, t, drop, g, a, q, mb0,
                           wrap, w, pub, K, m0, gmx, ginv);
}

// The track loop of hist_kernel on the row buffers at `rows_at` (both
// buffers, 2 * (K/A) * (1+S) * T floats).  The kernel calls it at two
// sites, so that the one on shared memory reads its rows with shared loads
// (a pointer that may be either is read with generic loads).  Wf: the
// frames the window covers; VDT: the (B, T-1, P) stream `s2st`; SUB:
// A = S^n children a group, n > 1.
template <int D, bool VDT, bool SUB>
static __device__ __forceinline__ void hist_tracks(
    const Tables& tb, const float* __restrict__ xs,
    const float* __restrict__ l2s, const int* __restrict__ lengths,
    const float* __restrict__ isbls, const float* __restrict__ s2st,
    const float* __restrict__ seg, int B, int T, int S, int P, int Wf,
    float* __restrict__ rows, float* rows_at, float* pubs, float* spb,
    const int* cst, const int* cgr, const int* cext, float* red) {
  const int K = tb.K, A = tb.A, G = K / A;
  const int k = threadIdx.x;
  const bool act = k < K;
  const int lane = k & 31, wid = k >> 5, nwarp = blockDim.x >> 5;
  const int m0 = (k % G) * A;                   // first member of k's group
  const int g = k % G, a = k / G;               // k's group, child index
  // the members a group, A; without sub-steps (A == S) read as S, which
  // keeps the one-sub-step walk's registers as they were tuned (read as A,
  // it ran 6% slower and spilled at D = 3)
  const int NA = SUB ? A : S;
  const int q = g % S, mb0 = (g * NA) % G;
  const bool wrap = A > G;                      // Wf = 2 past one sub-step
  const int pk = VDT ? k / (K / P) : 0;         // k's pattern in the stream
  const int ST = S * T, HS = (1 + S) * T;       // hist bins, rows per group
  const int F = 2 + 2 * D;
  int buf = 0;                                  // publish area in turn

  Prof pf;
  pf.start();
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int L = min(lengths[b], T);
    float* row = rows + (size_t)b * ST;
    if (L < 2) {            // empty / 1-frame rows are never harvested
      for (int j = k; j < ST; j += blockDim.x) row[j] = 0.f;
      continue;
    }
    const float* x = xs + (size_t)b * T * D;
    const float* l2 = l2s + (size_t)b * T * D;
    // slot k's displacement variance of step t from the stream (VDT)
    auto s2_at = [&](int t) {
      return s2st[((size_t)b * (T - 1) + t) * P + pk];
    };
    const float isbl = isbls[b];
    float m[D], s2[D], lp = act ? tb.lp0[k] : 0.f;
    const float s20 = act ? (VDT ? s2_at(0) : tb.s20[k]) : 1.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      m[d] = x[d];
      s2[d] = l2[d] + s20;
    }
    // every group starts with a run of length 1 and no completed segment:
    // bin 0 of every row, the only bin read before it is written
    float* cur = rows_at;   // rows entering this step
    float* nxt = rows_at + (size_t)G * HS;  // rows this step's fusion writes
    if (k < G) {
      cur[k] = 1.f;
      for (int s = 0; s < S; ++s) cur[(size_t)(1 + s) * T * G + k] = 0.f;
    }
    pf.mark(kHsZero);
    for (int t = 1; t < L; ++t) {
      float xt[D], l2t[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xt[d] = x[t * D + d];
        l2t[d] = l2[t * D + d];
      }
      if (t == L - 1) {
        // harvest: softmax of fin = lp + isBL * end + log N(x_t) (the
        // per-step constants cancel), then per bin a K-sum
        Prep<float, D> p;
        prep<float, D>(m, s2, xt, l2t, p);
        const float fin = act ? lp + isbl * tb.endv[k] - 0.5f * logf(p.prod) -
                                    p.quad
                              : -INFINITY;
        pf.mark(kHsFusion);
        const float mx = block_max(fin, red);
        const float e = act ? expf(fin - mx) : 0.f;
        const float se = block_sum(e, red);
        if (act) spb[k] = e / fmaxf(se, kTiny);
        __syncthreads();
        // coverage: tracks longer than the window add the carried run
        // and the window's inner segments, shorter ones the segments of
        // their t+1 frames; the rows hold bins 0 .. nw-1
        const bool carry = t + 1 > Wf;
        const int nw = min(t, T);
        const float* sg = seg + (size_t)(carry ? Wf + 1 : t + 1) * ST * K;
        for (int j = wid; j < ST; j += nwarp) {
          const int s = j / T, mb = j - s * T;
          const bool hv = mb < nw;
          float v = 0.f;
          for (int c = lane; c < K; c += 32) {
            const int gc = cgr[c];
            float tot = sg[(size_t)j * K + c];
            if (hv) tot += cur[(size_t)(T + j) * G + gc];
            if (carry && cst[c] == s) {
              // the oldest run: carried length + the window's run - 1
              const int src = mb - cext[c] + 1;
              if (src >= 0 && src < nw) tot += cur[(size_t)src * G + gc];
            }
            v = fmaf(spb[c], tot, v);
          }
          v = warp_sum(v);
          if (lane == 0) row[j] = v;
        }
        __syncthreads();    // spb and the rows are reused by the next track
        pf.mark(kHsHarvest);
        break;
      }
      // fusion (K1's, base 2) and the run/hist transport; with VDT the
      // child's variance of step t (t <= L-2 <= T-2) is read before the
      // barrier
      float sv = 0.f;
      if constexpr (VDT) sv = act ? s2_at(t) : 0.f;
      const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;
      float* pub = pubs + buf * F * K;
      buf ^= 1;
      publish2<D>(act, m, s2, lp, xt, l2t, pub, K);
      pf.mark(kHsFusion);
      __syncthreads();
      pf.mark(kHsBarrier);
      const bool drop = t >= Wf - 1;  // the oldest frame leaves the window
      const float add = act ? tb.lt[k] + gate * tb.lsurv[k] : 0.f;
      if constexpr (!VDT) sv = act ? tb.sig2v[k] : 0.f;
#define EXTRACK_HIST_STEP(MS, SS)                                          \
  fuse_step<D, MS, SS, SUB>(act, m, s2, lp, pub, add, sv, K, m0, cur, nxt, \
                            G, T, S, NA, t, drop, g, a, q, mb0, wrap, pf)
      if constexpr (!SUB) {
        switch (S) {
          case 2: EXTRACK_HIST_STEP(2, 2); break;
          case 3: EXTRACK_HIST_STEP(3, 3); break;
          case 4: EXTRACK_HIST_STEP(4, 4); break;
          default: EXTRACK_HIST_STEP(0, 0);
        }
      } else if (A == 4 && !wrap) {
        // two states, two sub-steps, the weights in registers: 18.4 ms at
        // the bench shape on an H100 against the generic loop's 25.7
        EXTRACK_HIST_STEP(4, 2);
      } else {
        EXTRACK_HIST_STEP(0, 0);
      }
#undef EXTRACK_HIST_STEP
      pf.mark(kHsTransport);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  pf.flush(g_hist_prof, threadIdx.x == 0);
}

// NT: the largest block the instantiation is launched with.  The walk is
// latency-bound, so residency counts more than registers: up to 256
// threads ptxas is held to 85 registers (6 blocks of 128 threads an SM;
// it uses 80); measured on an H100 at the bench shape, 80 registers ran
// 14.2 ms, 72 13.1 ms with 4 bytes of spill, 64 13.1 ms with 8, 125
// 22.0 ms.  The variable-dt and sub-step instantiations get the same:
// none spills at 85.
template <int NT>
constexpr int hist_min_blocks() {
  return 65536 / (NT * 80) > 1 ? 65536 / (NT * 80) : 1;
}
template <int D, int NT, bool VDT, bool SUB>
__global__ void __launch_bounds__(NT, hist_min_blocks<NT>())
    hist_kernel(Tables tb, const float* __restrict__ xs,
                const float* __restrict__ l2s,
                const int* __restrict__ lengths,
                const float* __restrict__ isbls,
                const float* __restrict__ s2st,
                const float* __restrict__ seg, const int* __restrict__ ext,
                int B, int T, int S, int P, int Wf, float* __restrict__ rows,
                float* __restrict__ scratch) {
  extern __shared__ float sh[];
  __shared__ float red[33];
  const int K = tb.K, G = K / tb.A;
  const int F = 2 + 2 * D;
  // shared memory: two fusion publish areas, the softmax over the
  // register, per-slot constants (c % S, c % G, the oldest run's length),
  // then both row buffers unless they are in global scratch
  float* pubs = sh;
  float* spb = sh + 2 * F * K;
  int* cst = reinterpret_cast<int*>(spb + K);
  int* cgr = cst + K;
  int* cext = cgr + K;
  float* srows = reinterpret_cast<float*>(cext + K);
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    cst[c] = c % S;
    cgr[c] = c % G;
    cext[c] = ext[c];
  }
  if (scratch == nullptr)
    hist_tracks<D, VDT, SUB>(tb, xs, l2s, lengths, isbls, s2st, seg, B, T,
                             S, P, Wf, rows, srows, pubs, spb, cst, cgr,
                             cext, red);
  else
    hist_tracks<D, VDT, SUB>(
        tb, xs, l2s, lengths, isbls, s2st, seg, B, T, S, P, Wf, rows,
        scratch + (size_t)blockIdx.x * 2 * G * (1 + S) * T, pubs, spb, cst,
        cgr, cext, red);
}

template <int D, int NT, bool VDT, bool SUB>
static int launch_nt(const HistArgs& h, int nblk, int threads, size_t smem,
                     cudaStream_t stream) {
  // always: at 48 KB of dynamic shared memory (K = 1024 at D = 1, rows in
  // global scratch) the static red[] passes the default limit
  cudaFuncSetAttribute(hist_kernel<D, NT, VDT, SUB>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  if (h.B > 0)
    hist_kernel<D, NT, VDT, SUB><<<nblk, threads, smem, stream>>>(
        h.tb, h.xs, h.l2, h.lengths, h.isbl, h.s2st, h.seg, h.ext, h.B, h.T,
        h.S, h.P, h.Wf, h.rows, h.scratch);
  return (int)cudaGetLastError();
}

template <int D, bool VDT, bool SUB>
static int launch_hist(const HistArgs& h, int nblk, cudaStream_t stream) {
  const BlockLayout lay = hist_layout(h.T, D, h.tb.K, h.S, h.tb.A, 0);
  const int threads = lay.threads;
  const size_t smem = lay.fixed + (h.scratch != nullptr ? 0 : lay.carry);
  if (threads <= 128)
    return launch_nt<D, 128, VDT, SUB>(h, nblk, threads, smem, stream);
  if (threads <= 256)
    return launch_nt<D, 256, VDT, SUB>(h, nblk, threads, smem, stream);
  if (threads <= 512)
    return launch_nt<D, 512, VDT, SUB>(h, nblk, threads, smem, stream);
  if (threads <= 1024)
    return launch_nt<D, 1024, VDT, SUB>(h, nblk, threads, smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace extrack
