// K5: the posterior-expected duration (segment-length) histogram of the
// window DP, at any number n of sub-steps a frame, with constant or
// variable dt.
//
// Replaces the TPU kernel extrack_tpu/ops/pallas_hist.py:_kernel (driven
// by hist_pallas; one sub-step), and JAX's XLA window engine past one
// sub-step (extrack_tpu/histograms.py:window_segment_histogram).  Same
// semantics as the plain histograms.window_segment_histogram: K1's
// register walk, in which each slot also carries `run`, the distribution
// over the length in frames of the run that holds the window's oldest
// frame (T bins), and `hist`, the expected histogram of the segments
// completed in the frames already dropped (S*T bins, state-major).  Every
// fusion mixes a child's rows from its group's members with the fusion
// weights; once frames drop out of the window (one a step, n sub-steps),
// a member whose oldest run goes on into the next frame passes its run
// on grown by one, and a member whose oldest run ends there adds it to
// its histogram and passes on a fresh run of length 1.  At the track's
// last frame the softmax of the register weighs, per bin, the carried
// histogram, the carried run placed in the oldest state's row and shifted
// by the length of the window's oldest run, and the window's own segments
// (the static tables `seg`, read from global memory: the same for every
// track, so they stay in L2).
//
// Variable dt (VDT): the displacement variances come from the track's
// (T-1, P) rows of the streamed table (P = S^(n+1) patterns, as K1's
// walk reads them, walk.cuh): the initial register reads row 0 and the
// fusion at step t row t, slot k at pattern k / (K/P), in place of s20
// and sig2v.  The read is issued before the step's barrier, from global
// memory (a block reads P floats of one row a step, so they stay in L1).
//
// Rows per fusion group.  The fusion weights of a group's A = S^n members
// are the group's, and whether a member's oldest run goes on depends on
// the group and the member's oldest state alone (it goes on where that
// state is q, the group's digit n sub-steps newer, a frame's), so the A
// children of a group get the same rows: the kernel keeps G = K/A rows
// per bin, one per group, and slot c's rows are those of group c % G.
// Group g's members are slots g*A .. g*A+A-1, whose rows are those of the
// groups (g*A + o) % G: the A consecutive groups (g*A) % G + o where A
// divides G, and o % G where it does not (a window of two frames, W = n+1,
// n >= 2).  With w_o the members' weights and old(o) = o % S member o's
// oldest state, a fusion writes, bin by bin (each bin mixed in registers
// and written once):
//   run(r)    = sum_o w_o run_o(r)                          (frames kept)
//             = r == 0 ? 1 - sum_{old(o)=q} w_o             (the oldest
//                      : sum_{old(o)=q} w_o run_o(r-1)        frame drops)
//   hist_s(r) = sum_o w_o hist_{s,o}(r) + sum_{old(o)=s} c_o run_o(r),
//               c_o = w_o where the oldest frame drops and s != q, else 0:
// no branch on the member inside a warp.  At step t only bins 0..t can be
// nonzero and bin t is new (zero in the sources), so a track starts with
// bin 0 set (run 1, hist 0) and no other zeroing: every bin is written
// before it is read, and the harvest reads only the bins written.
//
// Mapping: K4's.  One block per track; thread k owns slot k's Gaussian
// carry in registers; a fusion publishes the update to one of two shared
// areas in turn (one barrier a step), and the A children of group g split
// its bins (child a = k / G takes the bins r = a mod A).  The rows are
// double-buffered and bin-major (bin r of group g at r*G + g, so a warp
// touches consecutive banks), in shared memory when both buffers fit what
// a block may opt in to, else in global scratch per persistent block.  The
// harvest gives each warp a share of the bins and each lane a share of the
// slots (per-slot constants c % S, c % G and the oldest run's length from
// shared memory, loaded once per block), and writes one (S*T) row per
// track; the host sums the rows in float64 with one reduction over the
// tracks, so no float atomics are needed and a histogram computed twice is
// bitwise identical.
//
// What bounds it on Hopper: as K4, instruction issue and barriers, not
// device memory.  The transport adds (1+S)*(t+1)*(A+1) multiply-adds per
// group at step t, and the harvest K*S*T multiply-adds per track.
//
// Past 1024 slots (up to 16384; hist_wide_kernel) a thread owns whole
// fusion groups, as K1's and K4's wide walk (walk.cuh): member c = g*A + o
// of group g is child c / G of group c % G of the last fusion, so its
// carry is that group's fused Gaussian from shared memory plus its child
// terms (the tables through L1; VDT: the stream), and a step mixes the
// group's A member updates in registers and publishes G fused Gaussians
// ((2D+1) floats each) in place of K updates.  The thread then moves its
// group's rows itself, all (1+S)*(t+1) bins (transport_group: transport's
// sums, with the members' weights from shared memory), so the rows keep
// their layout.  The harvest computes each slot's constants (c % S, c % G,
// the oldest run's length through L1) in place of the per-slot tables in
// shared memory.  At 3 states and window 7 (K = 2187, G = 729) a track's
// rows at T = 20 take 466,560 bytes, in global scratch.  Up to 16384 slots
// the publish areas and the member weights stay in shared memory while
// they fit what a block may opt in to; past that (4 states at window 7
// and D = 3: 294,912 bytes) hist_wide_global_kernel keeps them in the
// block's global scratch behind its rows, and the barrier that ends a
// step makes them visible to the block as it does the rows.
#include "common.cuh"

namespace extrack {

// Sections of K5's cycle split (tools/walk_profile.py --split).
enum {
  kHsZero = 0, kHsFusion = 1, kHsTransport = 2, kHsBarrier = 3,
  kHsHarvest = 4
};
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

// ---- the wide mapping: 1024 < K <= 16384 slots ------------------------

constexpr int kHistWideThreads = 1024;  // the wide block's largest size
constexpr int kHistWideMaxK = 16384;

// Group g's rows at step t, every bin, from `cur` into `nxt` (transport's
// sums for all A children of the group); w: the group's A member weights,
// q, mb0 and wrap as transport's.
static __device__ __forceinline__ void transport_group(
    const float* cur, float* nxt, int G, int T, int S, int A, int t,
    bool drop, int g, int q, int mb0, bool wrap, const float* w) {
  auto row = [&](int o) { return wrap ? o % G : mb0 + o; };
  const int nb = min(t + 1, T);        // bins written at this step
  const int nold = min(t, T);          // bins the sources hold
  if (drop) {
    // the runs of the members of oldest state q go on, the others end
    float wq = 0.f;
    for (int o = q; o < A; o += S) wq += w[o];
    nxt[g] = 1.f - wq;
    for (int r = 1; r < nb; ++r) {
      float v = 0.f;
      for (int o = q; o < A; o += S)
        v = fmaf(w[o], cur[(size_t)(r - 1) * G + row(o)], v);
      nxt[(size_t)r * G + g] = v;
    }
  } else {
    for (int r = 0; r < nb; ++r) {
      float v = 0.f;
      if (r < nold)
        for (int o = 0; o < A; ++o)
          v = fmaf(w[o], cur[(size_t)r * G + row(o)], v);
      nxt[(size_t)r * G + g] = v;
    }
  }
  for (int s = 0; s < S; ++s) {
    const bool ends = drop && s != q;   // runs of oldest state s end
    const float* hin = cur + (size_t)(1 + s) * T * G;
    float* hout = nxt + (size_t)(1 + s) * T * G;
    for (int r = 0; r < nb; ++r) {
      float v = 0.f;
      if (r < nold) {
        for (int o = 0; o < A; ++o)
          v = fmaf(w[o], hin[(size_t)r * G + row(o)], v);
        if (ends)
          for (int o = s; o < A; o += S)
            v = fmaf(w[o], cur[(size_t)r * G + row(o)], v);
      }
      hout[(size_t)r * G + g] = v;
    }
  }
}

// The wide mapping's track loop (hist_tracks' arguments; the kernel calls
// it at two sites, rows in shared memory or in global scratch).  `spb`
// holds K floats: each group's member weights during the walk, the
// register's softmax at the harvest.
template <int D, bool VDT>
static __device__ __forceinline__ void hist_wide_tracks(
    const Tables& tb, const float* __restrict__ xs,
    const float* __restrict__ l2s, const int* __restrict__ lengths,
    const float* __restrict__ isbls, const float* __restrict__ s2st,
    const float* __restrict__ seg, const int* __restrict__ ext, int B,
    int T, int S, int P, int Wf, float* __restrict__ rows, float* rows_at,
    float* pubs, float* spb, float* red) {
  const int K = tb.K, A = tb.A, G = K / A;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nwarp = nt >> 5;
  const int KP = VDT ? K / P : 1;               // slots a pattern
  const bool wrap = A > G;                      // Wf = 2 past one sub-step
  const int ST = S * T, HS = (1 + S) * T;       // hist bins, rows per group
  const int F = 2 * D + 1;
  int pb = 0;                                   // publish area in turn

  Prof pf;
  pf.start();
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int L = min(lengths[b], T);
    float* row = rows + (size_t)b * ST;
    if (L < 2) {            // empty / 1-frame rows are never harvested
      for (int j = tid; j < ST; j += nt) row[j] = 0.f;
      continue;
    }
    const float* x = xs + (size_t)b * T * D;
    const float* l2 = l2s + (size_t)b * T * D;
    const float* sg = VDT ? s2st + (size_t)b * (T - 1) * P : nullptr;
    const float isbl = isbls[b];
    const float* prev = nullptr;                // the last step's groups
    float gate_prev = 0.f;
    // member c's carry entering step t (walk.cuh's wide_track)
    auto carry = [&](int c, int t, float* m, float* s2, float& lp) {
      if (t == 1) {
        lp = __ldg(tb.lp0 + c);
        const float s20 = VDT ? sg[c / KP] : __ldg(tb.s20 + c);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          m[d] = x[d];
          s2[d] = l2[d] + s20;
        }
      } else {
        const int gp = c % G;
        const float sv =
            VDT ? sg[(size_t)(t - 1) * P + c / KP] : __ldg(tb.sig2v + c);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          m[d] = prev[d * G + gp];
          s2[d] = sv + prev[(D + d) * G + gp];
        }
        lp = prev[2 * D * G + gp] + __ldg(tb.lt + c) +
             gate_prev * __ldg(tb.lsurv + c);
      }
    };
    // every group starts with a run of length 1 and no completed segment
    float* cur = rows_at;
    float* nxt = rows_at + (size_t)G * HS;
    for (int g = tid; g < G; g += nt) {
      cur[g] = 1.f;
      for (int s = 0; s < S; ++s) cur[(size_t)(1 + s) * T * G + g] = 0.f;
    }
    __syncthreads();        // the rows' bin 0 before the first transport
    pf.mark(kHsZero);
    for (int t = 1; t < L; ++t) {
      float xt[D], l2t[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xt[d] = x[t * D + d];
        l2t[d] = l2[t * D + d];
      }
      if (t == L - 1) {
        // harvest: the softmax of fin = lp + isBL * end + log N(x_t), each
        // thread's slots' fin kept in spb until the block's max is known
        float tmx = -INFINITY;
        for (int g = tid; g < G; g += nt)
          for (int o = 0; o < A; ++o) {
            const int c = g * A + o;
            float m[D], s2[D], lp;
            carry(c, t, m, s2, lp);
            Prep<float, D> p;
            prep<float, D>(m, s2, xt, l2t, p);
            const float fin = lp + isbl * __ldg(tb.endv + c) -
                              0.5f * logf(p.prod) - p.quad;
            spb[c] = fin;
            tmx = fmaxf(tmx, fin);
          }
        pf.mark(kHsFusion);
        const float mx = block_max(tmx, red);
        float te = 0.f;
        for (int g = tid; g < G; g += nt)
          for (int o = 0; o < A; ++o) {
            const float e = expf(spb[g * A + o] - mx);
            spb[g * A + o] = e;
            te += e;
          }
        const float se = fmaxf(block_sum(te, red), kTiny);
        for (int g = tid; g < G; g += nt)
          for (int o = 0; o < A; ++o) spb[g * A + o] /= se;
        __syncthreads();
        const bool held = t + 1 > Wf;
        const int nw = min(t, T);
        const float* sgt = seg + (size_t)(held ? Wf + 1 : t + 1) * ST * K;
        for (int j = wid; j < ST; j += nwarp) {
          const int s = j / T, mb = j - s * T;
          const bool hv = mb < nw;
          float v = 0.f;
          for (int c = lane; c < K; c += 32) {
            const int gc = c % G;
            float tot = sgt[(size_t)j * K + c];
            if (hv) tot += cur[(size_t)(T + j) * G + gc];
            if (held && c % S == s) {
              // the oldest run: carried length + the window's run - 1
              const int src = mb - __ldg(ext + c) + 1;
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
      // fusion of each of the thread's groups in registers, then its
      // rows; spb holds the members' log2 weights until the group's sum
      const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;
      const bool drop = t >= Wf - 1;  // the oldest frame leaves the window
      float* pub = pubs + pb * F * G;
      pb ^= 1;
      for (int g = tid; g < G; g += nt) {
        float gmx = kNegBig, gsw = 0.f, mf[D], tf[D];
#pragma unroll
        for (int d = 0; d < D; ++d) mf[d] = tf[d] = 0.f;
        float* w = spb + g * A;
        for (int o = 0; o < A; ++o) {
          float m[D], s2[D], lp;
          carry(g * A + o, t, m, s2, lp);
          Upd<D> u;
          update2<D>(m, s2, xt, l2t, u);
          const float base = kLog2e * (lp - u.quad);
          float wo = rsq(u.prod);
          if (base > gmx) {
            const float sc = ex2(gmx - base);
            gsw *= sc;
#pragma unroll
            for (int d = 0; d < D; ++d) {
              mf[d] *= sc;
              tf[d] *= sc;
            }
            gmx = base;
          } else {
            wo *= ex2(base - gmx);
          }
          gsw += wo;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            mf[d] = fmaf(wo, u.nm[d], mf[d]);
            tf[d] = fmaf(wo, u.tl[d], tf[d]);
          }
          w[o] = base - 0.5f * lg2(u.prod);
        }
        gsw = fmaxf(gsw, kTiny);
        const float inv = rcp(gsw);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          pub[d * G + g] = mf[d] * inv;
          pub[(D + d) * G + g] = tf[d] * inv;
        }
        pub[2 * D * G + g] = (gmx + lg2(gsw)) * kLn2;
        for (int o = 0; o < A; ++o) w[o] = ex2(w[o] - gmx) * inv;
        pf.mark(kHsFusion);
        transport_group(cur, nxt, G, T, S, A, t, drop, g, g % S,
                        (g * A) % G, wrap, w);
        pf.mark(kHsTransport);
      }
      __syncthreads();
      pf.mark(kHsBarrier);
      prev = pub;
      gate_prev = gate;
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  pf.flush(g_hist_prof, threadIdx.x == 0);
}

template <int D, bool VDT>
__global__ void __launch_bounds__(kHistWideThreads, 1)
    hist_wide_kernel(Tables tb, const float* __restrict__ xs,
                     const float* __restrict__ l2s,
                     const int* __restrict__ lengths,
                     const float* __restrict__ isbls,
                     const float* __restrict__ s2st,
                     const float* __restrict__ seg,
                     const int* __restrict__ ext, int B, int T, int S, int P,
                     int Wf, float* __restrict__ rows,
                     float* __restrict__ scratch) {
  extern __shared__ float sh[];
  __shared__ float red[33];
  const int G = tb.K / tb.A;
  // shared memory: two publish areas of (2D+1)*G floats, K floats of
  // member weights / softmax, then both row buffers unless they are in
  // global scratch
  float* pubs = sh;
  float* spb = sh + 2 * (2 * D + 1) * G;
  if (scratch == nullptr)
    hist_wide_tracks<D, VDT>(tb, xs, l2s, lengths, isbls, s2st, seg, ext, B,
                             T, S, P, Wf, rows, spb + tb.K, pubs, spb, red);
  else
    hist_wide_tracks<D, VDT>(
        tb, xs, l2s, lengths, isbls, s2st, seg, ext, B, T, S, P, Wf, rows,
        scratch + (size_t)blockIdx.x * 2 * G * (1 + S) * T, pubs, spb, red);
}

// The wide mapping with the publish areas and member weights in global
// scratch too: a block's scratch holds its two row buffers, then the two
// publish areas of (2D+1)*G floats, then K floats of member weights
// (hist_layout's carry at wide = 2).
template <int D, bool VDT>
__global__ void __launch_bounds__(kHistWideThreads, 1)
    hist_wide_global_kernel(Tables tb, const float* __restrict__ xs,
                            const float* __restrict__ l2s,
                            const int* __restrict__ lengths,
                            const float* __restrict__ isbls,
                            const float* __restrict__ s2st,
                            const float* __restrict__ seg,
                            const int* __restrict__ ext, int B, int T, int S,
                            int P, int Wf, float* __restrict__ rows,
                            float* scratch) {
  __shared__ float red[33];
  const int K = tb.K, G = K / tb.A;
  const size_t nrows = (size_t)2 * G * (1 + S) * T;
  float* blk = scratch + (size_t)blockIdx.x *
                             (nrows + (size_t)2 * (2 * D + 1) * G + K);
  float* pubs = blk + nrows;
  hist_wide_tracks<D, VDT>(tb, xs, l2s, lengths, isbls, s2st, seg, ext, B,
                           T, S, P, Wf, rows, blk, pubs,
                           pubs + (size_t)2 * (2 * D + 1) * G, red);
}

// The launch's arguments besides its geometry.
struct HistArgs {
  Tables tb;
  const float *xs, *l2, *isbl, *s2st, *seg;
  const int *lengths, *ext;
  float *rows, *scratch;
  int B, T, S, P, Wf;
  int wide;     // 0: a thread a slot; 1: the wide mapping; 2: the wide
                // mapping with its publish areas and weights in scratch
};

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

// K5's block for T frames, D dimensions, K slots at S states and A
// children a fusion group: a thread per slot; shared memory besides the
// rows: two fusion publish areas of (2+2D)*K floats, the softmax over the
// register and three per-slot int constants (c % S, c % G, the oldest
// run's length).  Carry: the double-buffered run and histogram rows,
// (1+S)*T floats for each of the K/A fusion groups (the A children of a
// group carry the same rows).  The wide mapping: a thread per group (at
// most 1024), shared memory besides the rows two publish areas of
// (2D+1)*G floats and K floats of member weights; the same rows.  wide = 2:
// the wide mapping with its publish areas and member weights in the carry
// (global scratch) after the rows, and no dynamic shared memory.
static BlockLayout hist_layout(int T, int D, int K, int S, int A,
                               int wide) {
  const int G = K / A;
  const size_t carry = (size_t)2 * G * (1 + S) * T * sizeof(float);
  if (wide) {
    const int threads = (G + 31) / 32 * 32;
    const size_t pub = ((size_t)2 * (2 * D + 1) * G + K) * sizeof(float);
    return {threads < kHistWideThreads ? threads : kHistWideThreads,
            wide == 2 ? 0 : pub, wide == 2 ? carry + pub : carry};
  }
  return {(K + 31) / 32 * 32,
          (size_t)(2 * (2 + 2 * D) + 4) * K * sizeof(float), carry};
}

template <int D, bool VDT>
static int launch_wide(const HistArgs& h, int nblk, cudaStream_t stream) {
  const BlockLayout lay = hist_layout(h.T, D, h.tb.K, h.S, h.tb.A, h.wide);
  if (h.wide == 2) {
    if (h.B > 0)
      hist_wide_global_kernel<D, VDT><<<nblk, lay.threads, 0, stream>>>(
          h.tb, h.xs, h.l2, h.lengths, h.isbl, h.s2st, h.seg, h.ext, h.B,
          h.T, h.S, h.P, h.Wf, h.rows, h.scratch);
    return (int)cudaGetLastError();
  }
  const size_t smem = lay.fixed + (h.scratch != nullptr ? 0 : lay.carry);
  // always: at 48 KB of dynamic shared memory the static red[] passes the
  // default limit
  cudaFuncSetAttribute(hist_wide_kernel<D, VDT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  if (h.B > 0)
    hist_wide_kernel<D, VDT><<<nblk, lay.threads, smem, stream>>>(
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

// The instantiation for the launch: the wide mapping (any number of
// sub-steps), variable dt (P > 0), more than one sub-step (A > S).
template <int D>
static int launch_dt(const HistArgs& h, int nblk, cudaStream_t stream) {
  if (h.wide)
    return h.P > 0 ? launch_wide<D, true>(h, nblk, stream)
                   : launch_wide<D, false>(h, nblk, stream);
  if (h.tb.A > h.S)
    return h.P > 0 ? launch_hist<D, true, true>(h, nblk, stream)
                   : launch_hist<D, false, true>(h, nblk, stream);
  return h.P > 0 ? launch_hist<D, true, false>(h, nblk, stream)
                 : launch_hist<D, false, false>(h, nblk, stream);
}

}  // namespace extrack

// Reads and zeroes K5's cycle split (profile builds; zeros otherwise).
extern "C" int extrack_hist_prof(unsigned long long* out) {
  unsigned long long zero[extrack::kProfSlots] = {};
  cudaError_t err =
      cudaMemcpyFromSymbol(out, extrack::g_hist_prof, sizeof zero);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(extrack::g_hist_prof, zero, sizeof zero);
  return (int)err;
}

// Dynamic shared memory one K5 block may opt in to on `device` (as
// extrack_predict_smem).
extern "C" int extrack_hist_smem(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr,
                                extrack::hist_kernel<2, 1024, false, false>);
  if (err != cudaSuccess) return -(int)err;
  return optin - (int)attr.sharedSizeBytes;
}

// K5's block for a launch (hist_layout; wide: 1 the wide mapping, 2 the
// wide mapping with its publish areas and member weights in global
// scratch, K <= 16384; 0 a thread a slot): out = threads, shared bytes
// besides the rows, row bytes per track (at 2: all the block's scratch).
extern "C" int extrack_hist_layout(int T, int D, int K, int S, int A,
                                   int wide, long long* out) {
  if (A < 1 || K % A || wide < 0 || wide > 2 ||
      (wide && K > extrack::kHistWideMaxK))
    return (int)cudaErrorInvalidValue;
  return extrack::write_layout(extrack::hist_layout(T, D, K, S, A, wide), D,
                               out);
}

// Inputs: xs, l2 (B, T, D), lengths (B,), isbl (B,) and the six (K,) slot
// tables of extrack_forward (lp0, s20, lt, lsurv, endv, sig2v), K = S^W
// at A = S^n children a fusion group (n sub-steps a frame, Wf frames in
// the window); s2st: with P > 0 (variable dt) the (B, T-1, P) streamed
// displacement variances, read in place of s20 and sig2v (P = S^(n+1));
// seg (Wf+2, S*T, K) static segment tables and ext (K,) oldest-run lengths
// (ops/hist_kernel.segment_tables).  Output: rows (B, S*T), each track's
// expected histogram (bin s*T + m: segments of length m+1 in state s;
// zero for tracks of fewer than 2 frames).  scratch: null to keep the
// double-buffered rows in shared memory, or nblk times the row bytes of
// extrack_hist_layout in global scratch.  wide: 1 the wide mapping (a
// thread per fusion group, K <= 16384), 2 the same with its publish areas
// and member weights in that scratch too (scratch required), 0 a thread
// per slot (K <= 1024).  Blocks are persistent over nblk.  Returns
// cudaGetLastError().
extern "C" int extrack_hist(const float* xs, const float* l2,
                            const int* lengths, const float* isbl,
                            const float* lp0, const float* s20,
                            const float* lt, const float* lsurv,
                            const float* endv, const float* sig2v,
                            const float* s2st, const float* seg,
                            const int* ext, float* rows, float* scratch,
                            int B, int T, int D, int K, int A, int P,
                            int min_len, int S, int Wf, int nblk, int wide,
                            void* stream) {
  if (A < 1 || K % A || (P > 0 && (s2st == nullptr || K % P)) ||
      wide < 0 || wide > 2 || (wide == 2 && scratch == nullptr) ||
      K > (wide ? extrack::kHistWideMaxK : 1024))
    return (int)cudaErrorInvalidValue;
  const extrack::HistArgs h{
      {lp0, s20, lt, lsurv, endv, sig2v, nullptr, nullptr, nullptr, nullptr,
       K, A, min_len},
      xs, l2, isbl, s2st, seg, lengths, ext, rows, scratch, B, T, S, P, Wf,
      wide};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1: return extrack::launch_dt<1>(h, nblk, st);
    case 2: return extrack::launch_dt<2>(h, nblk, st);
    case 3: return extrack::launch_dt<3>(h, nblk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
