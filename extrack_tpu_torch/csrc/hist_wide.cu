// K5 past 1024 slots: the wide mapping of the duration histogram (hist.cu
// holds the kernel a thread a slot, the algorithm and the C interface).
//
// Replaces, past the TPU kernel's VMEM budget, JAX's XLA window engine
// (extrack_tpu/histograms.py:window_segment_histogram, dispatch :631-645),
// which the Pallas kernel extrack_tpu/ops/pallas_hist.py:_kernel leaves
// to it there; the same function as the plain
// histograms.window_segment_histogram.
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
//
// Past 16384 slots (up to 2^19; hist_runs_kernel: len_hist's default
// window 7 at 5 and 6 states, 78,125 and 279,936 slots, the GUI's
// lifetime window 8 at 4 states) the static segment tables would take
// (Wf+2) * S * T * K floats (1.21 GB at 6^7, T = 20) and every harvest
// would read two S*T x K slices of them.  harvest_runs takes each slot's
// runs from its digits instead: (S+1)*T*G multiply-adds and Wf+2A reads a
// group per track, against the tables' S*T*K.  The walk and the block's
// global scratch are hist_wide_global_kernel's; the persistent grid is
// bounded by the scratch budget (ops/hist_kernel.py).  What bounds it: the
// transport's reads of the rows, K*(1+S)*(t+1) floats a step, from L2 and
// device memory (52 MB of rows a block at 6^7, T = 20).
#include "hist.cuh"

namespace extrack {

static __device__ unsigned long long g_hist_wide_prof[kProfSlots];

// ---- the wide mapping: 1024 < K <= 2^19 slots --------------------------

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

// The harvest past 16384 slots, from each slot's digits in place of the
// static tables (K * S * T floats): slot c's rows are group c % G's, and
// its window's frame states, oldest to newest, are its base-S digits at
// positions 0, n, ..., (Wf-1)n (A = S^n): those of frames 0 .. Wf-2 are
// group c % G's, the newest is the top digit of c's child index c / G.
// So a group's A slots share every run but the last, which either goes on
// into the newest frame (the children of that state) or ends, the newest
// frame then a run of length 1.  One pass over the groups, a thread a
// group in turn: U = the group's softmax mass, u_f its children's by the
// newest frame's state f; the window's segments (completed inside it when
// the window is held, all of the newest t+1 frames' otherwise) go to the
// thread's (state, length) bins, at most Wf runs a group; and, held, the
// group's weights of the oldest run's two lengths e and e+1 (the run
// reaches frame Wf-2: children whose newest state is the oldest's) go to
// `grp`.  The bins are warp sums, summed over the warps in order.  Then a
// warp a bin: the carried histogram (weights U) and the carried run
// shifted by the oldest run's length (the groups of that oldest state).
// No float atomics: a histogram computed twice is bitwise identical.
// `grp` holds 4 * G floats (the publish areas, free at the harvest).
static __device__ __forceinline__ void harvest_runs(
    const float* cur, const float* spb, float* grp, float* row, int G,
    int A, int S, int T, int Wf, int t, bool held, int nw) {
  __shared__ float part[32 * kRunsMaxBins];   // warp sums of the bins
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nwarp = nt >> 5;
  const int AS = A / S;                 // children a newest frame state
  const int lo = held ? 0 : Wf - (t + 1);   // the oldest frame counted
  const int first = held ? 1 : 0;       // runs before it join the carry
  float* gu = grp;                      // U
  float* gw0 = grp + G;                 // the oldest run's weight at e
  float* gw1 = grp + 2 * G;             // ... at e + 1
  int* ge = reinterpret_cast<int*>(grp + 3 * G);  // e
  float sb[kRunsMaxBins];               // bin s * Wf + len - 1
  for (int i = 0; i < S * Wf; ++i) sb[i] = 0.f;
  for (int g = tid; g < G; g += nt) {
    float U = 0.f;
    for (int a = 0; a < A; ++a) U += spb[(size_t)a * G + g];
    // the runs of frames lo .. Wf-2 (digit j of g at stride A), the last
    // one kept open; run r of them, state cs, length cl
    int q = g, cs = -1, cl = 0, r = -1, e = 0;
    for (int j = 0; j <= Wf - 2; ++j, q /= A) {
      if (j < lo) continue;
      const int f = q % S;
      if (f == cs) {
        ++cl;
        continue;
      }
      if (r >= first) sb[cs * Wf + cl - 1] += U;
      if (r == 0) e = cl;
      cs = f;
      cl = 1;
      ++r;
    }
    // the newest frame: the children of state cs extend the last run,
    // the others end it and start one of length 1
    float same = 0.f, other = 0.f;
    for (int f = 0; f < S; ++f) {
      float uf = 0.f;
      for (int a = f * AS; a < (f + 1) * AS; ++a)
        uf += spb[(size_t)a * G + g];
      if (f == cs) {
        same = uf;
      } else {
        other += uf;
        sb[f * Wf] += uf;
      }
    }
    if (r >= first) {
      sb[cs * Wf + cl] += same;
      sb[cs * Wf + cl - 1] += other;
    }
    gu[g] = U;
    if (held) {
      // the oldest run: e frames, or all Wf-1 and then the newest's too
      ge[g] = r == 0 ? cl : e;
      gw0[g] = r == 0 ? other : U;
      gw1[g] = r == 0 ? same : 0.f;
    }
  }
  for (int i = 0; i < S * Wf; ++i) {
    const float v = warp_sum(sb[i]);
    if (lane == 0) part[wid * kRunsMaxBins + i] = v;
  }
  __syncthreads();          // grp and the warps' bins are complete
  for (int j = wid; j < S * T; j += nwarp) {
    const int s = j / T, mb = j - s * T;
    float v = 0.f;
    if (mb < nw)
      for (int g = lane; g < G; g += 32)
        v = fmaf(gu[g], cur[(size_t)(T + j) * G + g], v);
    if (held)
      for (int g = s + S * lane; g < G; g += 32 * S) {
        // the oldest run: carried length + the window's run - 1
        const int src = mb - ge[g] + 1;
        if (src >= 0 && src < nw)
          v = fmaf(gw0[g], cur[(size_t)src * G + g], v);
        if (src >= 1 && src <= nw)
          v = fmaf(gw1[g], cur[(size_t)(src - 1) * G + g], v);
      }
    v = warp_sum(v);
    if (lane == 0) {
      if (mb < Wf)
        for (int w = 0; w < nwarp; ++w)
          v += part[w * kRunsMaxBins + s * Wf + mb];
      row[j] = v;
    }
  }
}

// The wide mapping's track loop (hist_tracks' arguments; the kernel calls
// it at two sites, rows in shared memory or in global scratch).  `spb`
// holds K floats: each group's member weights during the walk, the
// register's softmax at the harvest.  RUNS: the harvest from each slot's
// digits (harvest_runs; seg and ext unread).
template <int D, bool VDT, bool RUNS>
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
        if constexpr (RUNS) {
          // the publish areas are free: no carry is read after the softmax
          harvest_runs(cur, spb, pubs, row, G, A, S, T, Wf, t, held, nw);
        } else {
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
  pf.flush(g_hist_wide_prof, threadIdx.x == 0);
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
    hist_wide_tracks<D, VDT, false>(tb, xs, l2s, lengths, isbls, s2st, seg,
                                    ext, B, T, S, P, Wf, rows, spb + tb.K,
                                    pubs, spb, red);
  else
    hist_wide_tracks<D, VDT, false>(
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
  hist_wide_tracks<D, VDT, false>(tb, xs, l2s, lengths, isbls, s2st, seg,
                                  ext, B, T, S, P, Wf, rows, blk, pubs,
                                  pubs + (size_t)2 * (2 * D + 1) * G, red);
}

// Past 16384 slots (up to 2^19): the global-scratch kernel's walk with the
// harvest from the slots' digits (harvest_runs); no segment tables.
template <int D, bool VDT>
__global__ void __launch_bounds__(kHistWideThreads, 1)
    hist_runs_kernel(Tables tb, const float* __restrict__ xs,
                     const float* __restrict__ l2s,
                     const int* __restrict__ lengths,
                     const float* __restrict__ isbls,
                     const float* __restrict__ s2st, int B, int T, int S,
                     int P, int Wf, float* __restrict__ rows,
                     float* scratch) {
  __shared__ float red[33];
  const int K = tb.K, G = K / tb.A;
  const size_t nrows = (size_t)2 * G * (1 + S) * T;
  float* blk = scratch + (size_t)blockIdx.x *
                             (nrows + (size_t)2 * (2 * D + 1) * G + K);
  float* pubs = blk + nrows;
  hist_wide_tracks<D, VDT, true>(tb, xs, l2s, lengths, isbls, s2st, nullptr,
                                 nullptr, B, T, S, P, Wf, rows, blk, pubs,
                                 pubs + (size_t)2 * (2 * D + 1) * G, red);
}

template <int D, bool VDT>
static int launch_wide(const HistArgs& h, int nblk, cudaStream_t stream) {
  const BlockLayout lay = hist_layout(h.T, D, h.tb.K, h.S, h.tb.A, h.wide);
  if (h.wide == 3) {
    if (h.B > 0)
      hist_runs_kernel<D, VDT><<<nblk, lay.threads, 0, stream>>>(
          h.tb, h.xs, h.l2, h.lengths, h.isbl, h.s2st, h.B, h.T, h.S, h.P,
          h.Wf, h.rows, h.scratch);
    return (int)cudaGetLastError();
  }
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

template <int D>
static int launch_wide_dt(const HistArgs& h, int nblk, cudaStream_t stream) {
  return h.P > 0 ? launch_wide<D, true>(h, nblk, stream)
                 : launch_wide<D, false>(h, nblk, stream);
}

int hist_wide_launch(const HistArgs& h, int D, int nblk,
                     cudaStream_t stream) {
  switch (D) {
    case 1: return launch_wide_dt<1>(h, nblk, stream);
    case 2: return launch_wide_dt<2>(h, nblk, stream);
    case 3: return launch_wide_dt<3>(h, nblk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int hist_wide_prof(unsigned long long* out) {
  unsigned long long v[kProfSlots], zero[kProfSlots] = {};
  cudaError_t err = cudaMemcpyFromSymbol(v, g_hist_wide_prof, sizeof v);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_hist_wide_prof, zero, sizeof zero);
  if (err == cudaSuccess)
    for (int i = 0; i < kProfSlots; ++i) out[i] += v[i];
  return (int)err;
}

}  // namespace extrack
