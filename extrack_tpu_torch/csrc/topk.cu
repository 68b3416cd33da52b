// K7: the top-K duration histogram's register walk: each track keeps M
// explicit state sequences, re-selected every frame by the reference's
// one-step look-ahead score (extrack/histograms.py:179-206), and writes
// parent/state backpointers that the host decodes into segments.
//
// Replaces the TPU kernel extrack_tpu/ops/pallas_topk.py:_topk_kernel
// (driven by segment_topk_pallas).  Same semantics as the plain
// histograms.segment_backpointers.  Each register row holds a Gaussian
// mean and variance per dimension, a log-probability lp, an accumulated
// survival term ll and its newest state.  At each frame t = 1..L-1 of a
// track of L frames:
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
//   5. each survivor writes its parent slot and newest state as the
//      backpointers of step t.
// Steps t >= L-1 record identity parents and unchanged states, as the
// plain version's frozen tracks do; tracks of 0 or 1 frame get w_final 0.
//
// Mapping: one block per track, blockDim >= M threads; thread r owns
// register row r in registers for the whole walk.  The fold publishes each
// row's (new mean, tail, lp, lc, ll, newest) to shared memory, from which
// every child is scored and every survivor is rebuilt.  Selection sorts
// NS = 2^ceil(log2(A*M)) 64-bit words with a bitonic network: the high
// half is the score mapped to an order-preserving unsigned integer, the
// low half the complement of the child index, so one unsigned compare
// orders by score and breaks ties by index; rows past A*M carry the key
// -3e38.  Only the (key, index) pairs move through the network; survivors
// rebuild their payload from the parent's fold.  Every output element is
// written; there are no atomics, so the same input gives the same bits.
//
// What bounds it on Hopper: the selection.  Each step runs
// log2(NS)(log2(NS)+1)/2 network stages (55 at NS = 1024).  Those whose
// pairs lie 64 or more words apart read and write shared memory behind a
// barrier each (10 of the 55); the others run on warp shuffles, with one
// barrier per merge size (sort_desc).  The scoring's A*M children cost D
// logs and divisions each.  Device memory traffic is small (the
// backpointers, 3 bytes per row and step).
#include "common.cuh"

namespace extrack {

constexpr float kKeyPad = -3e38f;   // sort pad: below every live score

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
// or, on an exact tie, a smaller index.  -0 and +0 map alike.
static __device__ __forceinline__ unsigned long long sort_word(float key,
                                                               int idx) {
  unsigned u = __float_as_uint(key + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned)idx);
}

// Descending bitonic sort of NS (a power of two) distinct words in shared
// memory.  Stages whose pairs lie 64 or more words apart run in shared
// memory, one barrier each (pair q compares words i and i + j).  The
// others run in registers: for each merge size k, lane l of a warp holds
// words 2c and 2c+1 of its chunk c and trades with lane l ^ j/2 by a warp
// shuffle, so stages j = 32..1 need no barrier; one barrier follows them.
// The words are distinct, so min and max settle every exchange.
static __device__ void sort_desc(unsigned long long* words, int NS) {
  const int r = threadIdx.x, nthr = blockDim.x;
  for (int k = 2; k <= NS; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      for (int q = r; q < NS / 2; q += nthr) {
        const int i = q + (q & ~(j - 1));
        const unsigned long long u = words[i], v = words[i + j];
        if ((i & k) == 0 ? u < v : u > v) {
          words[i] = v;
          words[i + j] = u;
        }
      }
      __syncthreads();
    }
    // whole warps enter: NS/2 and blockDim are multiples of 32, or NS <= 64
    // and warp 0 alone holds the words
    for (int c = r; c < max(NS / 2, 32); c += nthr) {
      const bool held = c < NS / 2;
      const bool desc = ((2 * c) & k) == 0;   // this block sorts descending
      unsigned long long u0 = held ? words[2 * c] : 0ull;
      unsigned long long u1 = held ? words[2 * c + 1] : 0ull;
      for (int j = min(k >> 1, 32); j > 1; j >>= 1) {
        const unsigned long long v0 = __shfl_xor_sync(0xffffffffu, u0, j / 2);
        const unsigned long long v1 = __shfl_xor_sync(0xffffffffu, u1, j / 2);
        // the lower word of a pair keeps the larger one in a descending
        // block
        const bool keep_max = (((2 * c) & j) == 0) == desc;
        u0 = (u0 > v0) == keep_max ? u0 : v0;
        u1 = (u1 > v1) == keep_max ? u1 : v1;
      }
      if ((u0 < u1) == desc) {               // j = 1: the lane's own pair
        const unsigned long long w = u0;
        u0 = u1;
        u1 = w;
      }
      if (held) {
        words[2 * c] = u0;
        words[2 * c + 1] = u1;
      }
    }
    __syncthreads();
  }
}

template <int D>
__global__ void __launch_bounds__(1024, 1)
    topk_kernel(const float* __restrict__ xs, const float* __restrict__ l2s,
                const int* __restrict__ lengths,
                const float* __restrict__ isbls,
                const float* __restrict__ lp0, const float* __restrict__ s20,
                const int* __restrict__ nw0, const float* __restrict__ tab,
                int T, int M, int S, int A, int newest_div,
                int min_len, int NS, float* __restrict__ w_final,
                short* __restrict__ parents,
                signed char* __restrict__ states) {
  extern __shared__ unsigned long long words[];   // NS sort words
  float* fold = reinterpret_cast<float*>(words + NS);   // (2D+4) x M
  __shared__ float red[33];
  const int r = threadIdx.x, nthr = blockDim.x;
  const bool own = r < M;
  const int N = A * M;
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
  float* wf = w_final + (size_t)b * M;
  short* par = parents + (size_t)b * (T - 1) * M;
  signed char* st = states + (size_t)b * (T - 1) * M;

  float m[D], s2[D], lp = 0.f, ll = 0.f;
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
  int t = 1;
  for (; t < L; ++t) {
    // fold the observation at frame t into row r
    float nm[D], tl[D], lc = 0.f;
    if (own) {
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
    if (t == L - 1) {
      // closing: the softmax over the rows; unused rows (lp = -1e30)
      // vanish
      const float fin =
          own ? lp + ll + __fmul_rn(isbl, endv[nw]) + lc : -INFINITY;
      const float mx = block_max(fin, red);
      const float e = own ? expf(fin - mx) : 0.f;
      const float se = block_sum(e, red);
      if (own) wf[r] = e / fmaxf(se, kTiny);
      break;
    }
    if (own) {
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

    // score the children c = a*M + p against frame t+1
    float xn[D], l2n[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xn[d] = x[(t + 1) * D + d];
      l2n[d] = l2[(t + 1) * D + d];
    }
    for (int c = r; c < NS; c += nthr) {
      float key = kKeyPad;
      if (c < N) {
        const int a = c / M, p = c - a * M;
        const int q = (int)f_nw[p];
        const float sv = sig2[a * S + q];
        float look = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float q = log_normal(xn[d], f_nm[d * M + p],
                                     l2n[d] + (sv + f_tl[d * M + p]));
          look = d == 0 ? q : look + q;
        }
        key = (f_lp[p] + lt_tab[a * S + q]) + f_lc[p] + look;
      }
      words[c] = sort_word(key, c);
    }
    __syncthreads();

    sort_desc(words, NS);

    // survivor r rebuilds its row from its parent's fold
    if (own) {
      const int c = (int)(0xFFFFFFFFu - (unsigned)(words[r] & 0xFFFFFFFFu));
      const int a = c / M, p = c - a * M;
      const int q = (int)f_nw[p];
      const float sv = sig2[a * S + q];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        m[d] = f_nm[d * M + p];
        s2[d] = sv + f_tl[d * M + p];
      }
      lp = (f_lp[p] + lt_tab[a * S + q]) + f_lc[p];
      ll = f_ll[p] + (t + 1 >= min_len ? lsurv[a] : 0.f);
      nw = a / newest_div;
      par[(size_t)(t - 1) * M + r] = (short)p;
      st[(size_t)(t - 1) * M + r] = (signed char)nw;
    }
    __syncthreads();   // the fold and the words are rewritten next step
  }
  // steps t..T-1 (all of them for tracks of 0 or 1 frame): identity
  // parents, unchanged newest state
  if (own) {
    if (L < 2) wf[r] = 0.f;
    for (int i = t - 1; i < T - 1; ++i) {
      par[(size_t)i * M + r] = (short)r;
      st[(size_t)i * M + r] = (signed char)nw;
    }
  }
}

static int topk_threads(int M, int NS) {
  int threads = NS / 2 > M ? NS / 2 : M;
  threads = (threads + 31) / 32 * 32;
  return threads > 1024 ? 1024 : threads;
}

template <int D>
static int launch_topk(const float* xs, const float* l2, const int* lengths,
                       const float* isbl, const float* lp0, const float* s20,
                       const int* nw0, const float* tab, float* w_final,
                       short* parents, signed char* states, int B, int T,
                       int M, int S, int A, int newest_div, int min_len,
                       cudaStream_t stream) {
  int NS = 1;
  while (NS < A * M) NS <<= 1;
  const int threads = topk_threads(M, NS);
  if (M > threads) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NS * 8 + (size_t)(2 * D + 4) * M * 4;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(topk_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  if (B > 0)
    topk_kernel<D><<<B, threads, smem, stream>>>(
        xs, l2, lengths, isbl, lp0, s20, nw0, tab, T, M, S, A, newest_div,
        min_len, NS, w_final, parents, states);
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
// initial rows lp0, s20 (M,) float and nw0 (M,) int; tab = lt (A, S) |
// lsurv (A,) | end (S,) | sig2 (A*S,) (ops/topk_kernel.topk_tables).
// Outputs, every element written: w_final (B, M) float, parents and states
// (B, T-1, M) int16 / int8, row t-1 of a track being step t's
// backpointers.  One block per track, M <= 1024 (one thread per row).
// Returns cudaGetLastError().
extern "C" int extrack_topk(const float* xs, const float* l2,
                            const int* lengths, const float* isbl,
                            const float* lp0, const float* s20,
                            const int* nw0, const float* tab, float* w_final,
                            short* parents, signed char* states, int B,
                            int T, int D, int M, int S, int A,
                            int newest_div, int min_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return extrack::launch_topk<1>(xs, l2, lengths, isbl, lp0, s20, nw0,
                                     tab, w_final, parents, states, B, T, M,
                                     S, A, newest_div, min_len, st);
    case 2:
      return extrack::launch_topk<2>(xs, l2, lengths, isbl, lp0, s20, nw0,
                                     tab, w_final, parents, states, B, T, M,
                                     S, A, newest_div, min_len, st);
    case 3:
      return extrack::launch_topk<3>(xs, l2, lengths, isbl, lp0, s20, nw0,
                                     tab, w_final, parents, states, B, T, M,
                                     S, A, newest_div, min_len, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
