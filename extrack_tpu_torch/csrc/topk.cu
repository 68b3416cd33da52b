// K7: the top-K duration histogram's register walk: each track keeps M
// explicit state sequences, re-selected every frame by the reference's
// one-step look-ahead score (extrack/histograms.py:179-206), then
// backtracks its final sequences and decodes their segments into the
// track's histogram row.
//
// Replaces the TPU kernel extrack_tpu/ops/pallas_topk.py:_topk_kernel
// (driven by segment_topk_pallas) and the host-side decode after it.  Same
// semantics as the plain histograms.segment_histogram.  Each register row
// holds a Gaussian mean and variance per dimension, a log-probability lp,
// an accumulated survival term ll and its newest state.  At each frame
// t = 1..L-1 of a track of L frames:
//   1. the observation folds into every row (posterior mean, variance tail
//      and log normalizer lc);
//   2. at t = L-1 the softmax of lp + ll + isBL * end[newest] + lc over the
//      rows is the track's w_final, and the walk ends;
//   3. otherwise each row p branches into A = S^n children a*M + p, scored
//      by lp + lt[a, newest] + lc plus the look-ahead integral of frame
//      t+1;
//   4. the top M children survive, ordered by score descending and, on an
//      exact tie, by child index ascending: the stable sort of the plain
//      version (the TPU's bitonic network is not stable);
//   5. each survivor records its parent slot and newest state as the
//      backpointers of step t.
// Fused (the default): the backpointers stay in shared memory (or the
// block's slice of global scratch where they do not fit), and each thread
// backtracks its own final row, decodes its same-state runs on the way
// back and adds w_final[r] to bin (run length - 1, state) of its own
// column; the block sums the columns into the track's (T*S) row in a fixed
// order.  Raw: the backpointers and w_final go to device memory instead,
// with identity parents and unchanged states for steps t >= L-1 (the
// plain version's frozen tracks), for segment_backpointers' layout.
//
// Mapping: one block per track, thread r owns register row r in registers
// for the whole walk (blockDim = M rounded up to a warp).
//
// What bounds it on Hopper: the selection and its barriers, then the
// scoring's D logs and divisions per child.  The design does only the work
// the live rows need:
//   * Live prefix.  Unused register rows carry lp = -1e30, and every child
//     of one scores exactly -1e30 in f32 (the ulp of 1e30 is 7.6e22), so
//     they tie and rank below every live child, in child-index order.  The
//     block counts the live rows once (lp0 > -1e29, a prefix) and carries
//     the count: live' = min(M, A * live).  Only the A * live live children
//     are scored and selected; the survivors past them are the lowest-index
//     unused children, in closed form (row k past them: a = k / (M-live),
//     parent live + k % (M-live)), so their backpointers are the plain
//     version's slot by slot.  At S=2 the register fills only at step
//     log2(M)-1.
//   * Selection.  Each child is one 64-bit word: the score as an
//     order-preserving unsigned integer above the complement of the child
//     index, so one unsigned compare orders by score and breaks ties by
//     index.  While A * live <= M all live children survive and a bitonic
//     sort of them (padded to a power of two) orders them, every merge up
//     to 64 words in registers.  Where the register is full,
//     the children come as A runs of `live` words (one per pattern a); one
//     bitonic network sorts every run at once (log2(live) merge levels,
//     not the log2(A * live) of a sort of all of them), and a merge-path
//     pass per further run emits the top M of the union in order: thread i
//     finds the i-th largest word by a binary search over the two sorted
//     inputs.  The survivors need no sort of their own.  (A radix select
//     of the M-th score, a compaction and a sort of the survivors measured
//     slower than the sort they save, PERF.md.)
//   * Scores round after every operation (log_normal), so that they tie
//     and order exactly as the plain version's.
//   * Decode.  A thread's backtrack reads (T-1) parents and states; the
//     columns are summed with warp shuffles and then a fixed-order pass, so
//     the same input gives the same bits (no atomics).
#include "common.cuh"

namespace extrack {

constexpr float kLiveMin = -1e29f;   // rows above it are live

// Sections of K7's cycle split (tools/topk_profile.py --split).
enum {
  kPkFold = 0, kPkClose = 1, kPkPublish = 2, kPkScore = 3, kPkSelect = 4,
  kPkSort = 5, kPkRebuild = 6, kPkTail = 7, kPkDecode = 8, kPkReduce = 9,
};
#ifdef EXTRACK_PROFILE
static __device__ unsigned long long g_prof[kProfSlots];
#endif

// log N(x; mean, var) of one dimension in the plain version's operation
// order, rounded after every operation (the intrinsics keep nvcc from
// fusing multiply-adds), so that scores tie and order exactly as there.
static __device__ __forceinline__ float log_normal(float x, float mean,
                                                   float var) {
  const float df = __fsub_rn(x, mean);
  return __fsub_rn(__fmul_rn(-0.5f, logf(__fmul_rn(var, k2Pi))),
                   __fdiv_rn(__fmul_rn(df, df), __fmul_rn(2.f, var)));
}

// order-preserving map of a float score to an unsigned integer, joined
// with the complement of the child index: a larger word is a larger score
// or, on an exact tie, a smaller index.  -0 and +0 map alike.  No word is
// 0, the sort's pad.
static __device__ __forceinline__ unsigned long long sort_word(float key,
                                                               int idx) {
  unsigned u = __float_as_uint(key + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned)idx);
}

static __device__ __forceinline__ int word_index(unsigned long long w) {
  return (int)(0xFFFFFFFFu - (unsigned)(w & 0xFFFFFFFFu));
}

// The register stages (pairs under 64 words apart) of merge size k in a
// bitonic sort of runs of NR words, each descending: lane l of a warp holds
// words 2c and 2c+1 of its chunk c (c = l mod 32) and trades with lane
// l ^ j/2.  Every lane of the warp calls.
static __device__ __forceinline__ void merge_lanes(unsigned long long& u0,
                                                   unsigned long long& u1,
                                                   int c, int k, int NR) {
  // this block sorts descending (the last merge of a run always does)
  const bool desc = k == NR || ((2 * c) & k) == 0;
  for (int j = min(k >> 1, 32); j > 1; j >>= 1) {
    const unsigned long long v0 = __shfl_xor_sync(0xffffffffu, u0, j / 2);
    const unsigned long long v1 = __shfl_xor_sync(0xffffffffu, u1, j / 2);
    // the lower word of a pair keeps the larger one in a descending block
    const bool keep_max = (((2 * c) & j) == 0) == desc;
    u0 = (u0 > v0) == keep_max ? u0 : v0;
    u1 = (u1 > v1) == keep_max ? u1 : v1;
  }
  if ((u0 < u1) == desc) {               // j = 1: the lane's own pair
    const unsigned long long w = u0;
    u0 = u1;
    u1 = w;
  }
}

// Descending bitonic sort of each run of NR words of NS in shared memory
// (powers of two, NR <= NS; NR = NS sorts them all); every thread calls,
// and the words are readable after it returns.  Lane l of a warp holds the
// words 2c and 2c+1 of chunk c (c = l mod 32).  Merge sizes up to 64 words
// stay inside a warp: each thread loads its chunks once, runs them all on
// warp shuffles and stores once, one barrier.  Each larger merge size
// runs its stages whose pairs lie 64 or more words apart in shared memory,
// one barrier each (pair q compares words i and i + j), then the rest on
// shuffles, one barrier.  Whole warps enter (blockDim is a multiple of 32);
// chunks past NS/2 (NS = 3 runs of 32) are held by no one and trade only
// among themselves.  Equal words (the pad, 0) sort either way.
static __device__ void sort_desc(unsigned long long* words, int NS, int NR) {
  const int r = threadIdx.x, nthr = blockDim.x;
  const int nc = (NS / 2 + 31) / 32 * 32;
  for (int c = r; c < nc; c += nthr) {
    const bool held = c < NS / 2;
    unsigned long long u0 = held ? words[2 * c] : 0ull;
    unsigned long long u1 = held ? words[2 * c + 1] : 0ull;
    for (int k = 2; k <= min(NR, 64); k <<= 1) merge_lanes(u0, u1, c, k, NR);
    if (held) {
      words[2 * c] = u0;
      words[2 * c + 1] = u1;
    }
  }
  __syncthreads();
  for (int k = 128; k <= NR; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      for (int q = r; q < NS / 2; q += nthr) {
        const int i = q + (q & ~(j - 1));
        const unsigned long long u = words[i], v = words[i + j];
        if (k == NR || (i & k) == 0 ? u < v : u > v) {
          words[i] = v;
          words[i + j] = u;
        }
      }
      __syncthreads();
    }
    for (int c = r; c < NS / 2; c += nthr) {
      unsigned long long u0 = words[2 * c], u1 = words[2 * c + 1];
      merge_lanes(u0, u1, c, k, NR);
      words[2 * c] = u0;
      words[2 * c + 1] = u1;
    }
    __syncthreads();
  }
}

// The i-th largest (from 0) of the union of X[0..nx) and Y[0..ny), each
// sorted descending, all words distinct: a = how many of the i larger ones
// come from X is the largest a with X[a-1] > Y[i-a] (true at the lowest
// possible a), found by binary search (merge path).
static __device__ __forceinline__ unsigned long long merge_at(
    const unsigned long long* X, int nx, const unsigned long long* Y, int ny,
    int i) {
  int lo = max(0, i - ny), hi = min(i, nx);
  while (lo < hi) {
    const int a = (lo + hi + 1) >> 1;
    if (i - a >= ny || X[a - 1] > Y[i - a])
      lo = a;
    else
      hi = a - 1;
  }
  const unsigned long long x = lo < nx ? X[lo] : 0ull;
  const unsigned long long y = i - lo < ny ? Y[i - lo] : 0ull;
  return x > y ? x : y;
}

static __host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Bytes of the walk's shared memory at the front of the block's dynamic
// shared memory: the children's words (A runs of M rounded up to a power of
// two), two merge buffers of as many words, and the parents' fold ((2D+4)
// floats a row).
static __host__ __device__ inline size_t walk_bytes(int M, int A, int D) {
  return (size_t)8 * (A + 2) * pow2_at_least(M) +
         (size_t)4 * (2 * D + 4) * M;
}

template <int D>
__global__ void __launch_bounds__(1024, 1)
    topk_kernel(const float* __restrict__ xs, const float* __restrict__ l2s,
                const int* __restrict__ lengths,
                const float* __restrict__ isbls,
                const float* __restrict__ lp0, const float* __restrict__ s20,
                const int* __restrict__ nw0, const float* __restrict__ tab,
                int T, int M, int S, int A, int newest_div, int min_len,
                int raw, int bp_smem, int region, int chunk,
                float* __restrict__ w_final, short* __restrict__ parents,
                signed char* __restrict__ states, float* __restrict__ rows) {
  extern __shared__ unsigned long long smem_w[];
  __shared__ float red[33];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_w);
  const int r = threadIdx.x, nthr = blockDim.x;
  const bool own = r < M;
  const int NSM = pow2_at_least(M);
  unsigned long long* keys = smem_w;             // A runs of NSM words
  unsigned long long* sorted = keys + (size_t)A * NSM;   // NSM words
  unsigned long long* spare = sorted + NSM;              // NSM words
  float* fold = reinterpret_cast<float*>(spare + NSM);   // (2D+4) x M
  const float* lt_tab = tab;               // (A, S)
  const float* lsurv = tab + A * S;        // (A,)
  const float* endv = lsurv + A;           // (S,)
  const float* sig2 = endv + S;            // (A*S,), index a*S + newest
  float* f_nm = fold;                      // D rows: posterior means
  float* f_tl = fold + D * M;              // D rows: variance tails
  float* f_lp = fold + 2 * D * M;
  float* f_lc = f_lp + M;
  float* f_ll = f_lc + M;
  float* f_nw = f_ll + M;                  // newest state, as a float

  const int b = blockIdx.x;
  const int L = min(lengths[b], T);
  const float* x = xs + (size_t)b * T * D;
  const float* l2 = l2s + (size_t)b * T * D;
  const float isbl = isbls[b];
  // backpointers: the block's slice of device memory (raw output, or
  // fused scratch), else shared memory after the walk's region
  short* par = bp_smem ? reinterpret_cast<short*>(smem + region)
                       : parents + (size_t)b * (T - 1) * M;
  signed char* st = bp_smem ? reinterpret_cast<signed char*>(
                                  smem + region + (size_t)2 * (T - 1) * M)
                            : states + (size_t)b * (T - 1) * M;

  Prof pf;
  pf.start();
  float m[D], s2[D], lp = 0.f, ll = 0.f, w = 0.f;
  int nw = 0;
  if (own) {
    lp = lp0[r];
    nw = nw0[r];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      m[d] = x[d];
      s2[d] = l2[d] + s20[r];
    }
  }
  int live = __syncthreads_count(own && lp > kLiveMin);
  int t = 1;
  for (; t < L; ++t) {
    const bool lv = r < live;
    // fold the observation at frame t into live row r
    float nm[D], tl[D], lc = 0.f;
    if (lv) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float xt = x[t * D + d], l2t = l2[t * D + d];
        const float tot = l2t + s2[d];
        const float q = log_normal(xt, m[d], tot);
        lc = d == 0 ? q : lc + q;
        nm[d] = __fdiv_rn(__fmul_rn(m[d], l2t) + __fmul_rn(xt, s2[d]), tot);
        tl[d] = __fdiv_rn(__fmul_rn(l2t, s2[d]), tot);
      }
    }
    pf.mark(kPkFold);
    if (t == L - 1) {
      // closing: the softmax over the live rows; the others weigh 0
      const float fin =
          lv ? lp + ll + __fmul_rn(isbl, endv[nw]) + lc : -INFINITY;
      const float mx = block_max(fin, red);
      const float e = lv ? expf(fin - mx) : 0.f;
      const float se = block_sum(e, red);
      w = e / fmaxf(se, kTiny);
      pf.mark(kPkClose);
      break;
    }
    if (lv) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        f_nm[d * M + r] = nm[d];
        f_tl[d * M + r] = tl[d];
      }
      f_lp[r] = lp;
      f_lc[r] = lc;
      f_ll[r] = ll;
      f_nw[r] = (float)nw;
    }
    __syncthreads();
    pf.mark(kPkPublish);

    // score the live children i = a*live + p (child a*M + p) against
    // frame t+1: all of them survive when they fit the register, into
    // `sorted`; else run a of them goes to keys[a*NR ..]
    const int N = A * live;
    const bool full = N > M;
    const int NR = full ? pow2_at_least(live) : pow2_at_least(N);
    float xn[D], l2n[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xn[d] = x[(t + 1) * D + d];
      l2n[d] = l2[(t + 1) * D + d];
    }
    for (int i = r; i < N; i += nthr) {
      const int a = i / live, p = i - a * live;
      const int q = (int)f_nw[p];
      const float sv = sig2[a * S + q];
      float look = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float v = log_normal(xn[d], f_nm[d * M + p],
                                   l2n[d] + (sv + f_tl[d * M + p]));
        look = d == 0 ? v : look + v;
      }
      const float key = (f_lp[p] + lt_tab[a * S + q]) + f_lc[p] + look;
      (full ? keys + a * NR + p : sorted + i)[0] =
          sort_word(key, a * M + p);
    }
    if (full) {
      for (int i = r; i < A * (NR - live); i += nthr)
        keys[(i / (NR - live)) * NR + live + i % (NR - live)] = 0ull;
    } else {
      for (int i = N + r; i < NR; i += nthr) sorted[i] = 0ull;
    }
    __syncthreads();
    pf.mark(kPkScore);
    if (full) {
      // sort the A runs, then merge them in turn, keeping the top M; the
      // last merge writes `sorted`
      sort_desc(keys, A * NR, NR);
      const unsigned long long* src = keys;
      int nsrc = live;
      for (int a = 1; a < A; ++a) {
        unsigned long long* out = (A - 1 - a) % 2 == 0 ? sorted : spare;
        const int cnt = min(M, nsrc + live);
        for (int i = r; i < cnt; i += nthr)
          out[i] = merge_at(src, nsrc, keys + a * NR, live, i);
        __syncthreads();
        src = out;
        nsrc = cnt;
      }
      pf.mark(kPkSelect);
    } else {
      sort_desc(sorted, NR, NR);
      pf.mark(kPkSort);
    }

    // survivor r rebuilds its row from its parent's fold; past the live
    // children, the unused ones in closed form
    const int nlive = min(N, M);
    if (own) {
      int a, p;
      if (r < nlive) {
        const int c = word_index(sorted[r]);
        a = c / M;
        p = c - a * M;
        const int q = (int)f_nw[p];
        const float sv = sig2[a * S + q];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          m[d] = f_nm[d * M + p];
          s2[d] = sv + f_tl[d * M + p];
        }
        lp = (f_lp[p] + lt_tab[a * S + q]) + f_lc[p];
        ll = f_ll[p] + (t + 1 >= min_len ? lsurv[a] : 0.f);
      } else {
        const int k = r - nlive;
        a = k / (M - live);
        p = live + (k - a * (M - live));
      }
      nw = a / newest_div;
      par[(size_t)(t - 1) * M + r] = (short)p;
      st[(size_t)(t - 1) * M + r] = (signed char)nw;
    }
    live = nlive;
    __syncthreads();   // the fold and the words are rewritten next step
    pf.mark(kPkRebuild);
  }
  if (raw) {
    // w_final, then steps t..T-1 (all of them for tracks of 0 or 1 frame):
    // identity parents, unchanged newest state
    if (own) {
      w_final[(size_t)b * M + r] = w;
      for (int i = t - 1; i < T - 1; ++i) {
        par[(size_t)i * M + r] = (short)r;
        st[(size_t)i * M + r] = (signed char)nw;
      }
    }
    pf.mark(kPkTail);
  } else {
    // fused decode.  Thread r backtracks final row r (frames L-1 .. 2 from
    // the backpointers of steps L-2 .. 1, frames 1 and 0 from its initial
    // pattern) and adds w to bin (run - 1) * S + state of its column for
    // every same-state run; `chunk` bins a pass, the columns over the
    // walk's region
    __syncthreads();
    float* col = reinterpret_cast<float*>(smem);      // [bin][thread]
    const int nbins = T * S, lane = r & 31, wid = r >> 5;
    const bool dec = L >= 2 && r < live;
    for (int b0 = 0; b0 < nbins; b0 += chunk) {
      const int nb = min(chunk, nbins - b0);
      for (int q = 0; q < nb; ++q) col[q * nthr + r] = 0.f;
      if (dec) {
        int cur = r, prev = -1, run = 0;
        for (int f = L - 1; f >= 0; --f) {
          int s;
          if (f >= 2) {
            const size_t at = (size_t)(f - 2) * M + cur;
            s = st[at];
            cur = par[at];
          } else {
            s = nw0[f == 1 ? cur : M + cur];
          }
          if (s == prev) {
            ++run;
          } else {
            const int bin = (run - 1) * S + prev - b0;
            if (run > 0 && bin >= 0 && bin < nb) col[bin * nthr + r] += w;
            prev = s;
            run = 1;
          }
        }
        const int bin = (run - 1) * S + prev - b0;
        if (bin >= 0 && bin < nb) col[bin * nthr + r] += w;
      }
      __syncthreads();
      pf.mark(kPkDecode);
      const int nwarps = nthr >> 5;
      for (int q = wid; q < nb; q += nwarps) {
        float v = 0.f;
        for (int i = lane; i < nthr; i += 32) v += col[q * nthr + i];
        v = warp_sum(v);
        if (lane == 0) rows[(size_t)b * nbins + b0 + q] = v;
      }
      __syncthreads();
      pf.mark(kPkReduce);
    }
  }
#ifdef EXTRACK_PROFILE
  pf.flush(g_prof, r == 0);
#endif
}

template <int D>
static int launch_topk(const float* xs, const float* l2, const int* lengths,
                       const float* isbl, const float* lp0, const float* s20,
                       const int* nw0, const float* tab, float* w_final,
                       short* parents, signed char* states, float* rows,
                       int B, int T, int M, int S, int A, int newest_div,
                       int min_len, int raw, int bp_smem, int region,
                       int chunk, cudaStream_t stream) {
  const int threads = (M + 31) / 32 * 32;
  if (M < 1 || threads > 1024 || (size_t)region < walk_bytes(M, A, D) ||
      (!raw && (chunk < 1 || (size_t)chunk * threads * 4 > (size_t)region)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)region + (bp_smem ? (size_t)3 * (T - 1) * M : 0);
  // the opt-in covers the static shared memory's share of the 48 KB too
  cudaFuncSetAttribute(topk_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  if (B > 0)
    topk_kernel<D><<<B, threads, smem, stream>>>(
        xs, l2, lengths, isbl, lp0, s20, nw0, tab, T, M, S, A, newest_div,
        min_len, raw, bp_smem, region, chunk, w_final, parents, states,
        rows);
  return (int)cudaGetLastError();
}

}  // namespace extrack

// Dynamic shared memory one K7 block may opt in to on `device` (as
// extrack_predict_smem).
extern "C" int extrack_topk_smem(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, extrack::topk_kernel<2>);
  if (err != cudaSuccess) return -(int)err;
  return optin - (int)attr.sharedSizeBytes;
}

// Inputs: xs, l2 (B, T, D), lengths (B,), isbl (B,); the register's
// initial rows lp0, s20 (M,) float and nw0 (2, M) int, their newest then
// their oldest state; tab = lt (A, S) | lsurv (A,) | end (S,) | sig2
// (A*S,) (ops/topk_kernel.topk_tables).  Shared memory: `region` bytes for
// the walk (at least walk_bytes) and the decode's columns (chunk bins of
// blockDim floats), then, when bp_smem, the backpointers ((T-1)*M int16
// and int8).
// raw = 1: outputs w_final (B, M) float and parents / states (B, T-1, M)
// int16 / int8, row t-1 of a track being step t's backpointers; every
// element written; bp_smem = 0, rows unused.
// raw = 0: output rows (B, T*S) float, bin (l-1)*S + s of a track's row
// the posterior-weighted count of its segments of length l in state s;
// with bp_smem = 0, parents / states are the backpointers' global scratch
// (B, T-1, M); w_final unused.
// One block per track, M <= 1024 (one thread per row).
// Returns cudaGetLastError().
extern "C" int extrack_topk(const float* xs, const float* l2,
                            const int* lengths, const float* isbl,
                            const float* lp0, const float* s20,
                            const int* nw0, const float* tab, float* w_final,
                            short* parents, signed char* states, float* rows,
                            int B, int T, int D, int M, int S, int A,
                            int newest_div, int min_len, int raw, int bp_smem,
                            int region, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return extrack::launch_topk<1>(xs, l2, lengths, isbl, lp0, s20, nw0,
                                     tab, w_final, parents, states, rows, B,
                                     T, M, S, A, newest_div, min_len, raw,
                                     bp_smem, region, chunk, st);
    case 2:
      return extrack::launch_topk<2>(xs, l2, lengths, isbl, lp0, s20, nw0,
                                     tab, w_final, parents, states, rows, B,
                                     T, M, S, A, newest_div, min_len, raw,
                                     bp_smem, region, chunk, st);
    case 3:
      return extrack::launch_topk<3>(xs, l2, lengths, isbl, lp0, s20, nw0,
                                     tab, w_final, parents, states, rows, B,
                                     T, M, S, A, newest_div, min_len, raw,
                                     bp_smem, region, chunk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#ifdef EXTRACK_PROFILE
// Profile builds only: copies K7's cycle split (kProfSlots counters) to `out`
// and zeroes it on the card.
extern "C" int extrack_topk_prof(unsigned long long* out) {
  static const unsigned long long zero[extrack::kProfSlots] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, extrack::g_prof, sizeof zero);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(extrack::g_prof, zero, sizeof zero);
  return (int)err;
}
#endif
