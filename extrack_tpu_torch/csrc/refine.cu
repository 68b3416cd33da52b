// K6: position refinement, the moment-matched posterior of every
// localization's true position (mu and sigma per dimension).
//
// Replaces the TPU kernel extrack_tpu/ops/pallas_refine.py:_kernel (driven
// by refine_pallas), with the semantics of the plain refine.refine_positions:
// at an interior position t of a track, the mixture over state-matched
// pairs (prefix slot i, suffix slot j with the same newest state) of the
// product prefix prior x observation x suffix prior, each pair weighted by
// the two registers' log weights and the product's normalizer; position 0
// takes the suffix side alone, position L-1 the prefix side alone, and a
// 1-frame track the observation alone (mu = x, sigma = its localization
// error).  The priors come from two runs of a transition-only register scan
// (K1's fusion without fractions, survival or bleaching): the suffix scan
// from frame L-1 down to 0 on the transposed transitions, then the prefix
// scan from frame 0, which combines at each frame before injecting it.
//
// The pair algebra.  With a = m - x_t, p = 1/v per side and dimension, pair
// (i, j) has P = p1 + p2 + 1/l2 and N = a1 p1 + a2 p2, weight
// exp(b1 + b2 + sum_d N^2 / 2P) * r1 * r2 * prod_d P^-1/2 (b = lp -
// sum a^2 p / 2, r = prod_d v^-1/2), mean x + N/P and variance 1/P.  Each
// side's slot is turned once per position into a precision form scaled by
// the observation's variance c = l2_t (per position, so per-peak errors
// keep their own scale): Pt = c P (the prefix side carries the observation's
// c/l2 = 1), Nt = N sqrt(c log2(e) / 2), and b and log r in base 2.  Then
// Pt >= 1, so prod_d Pt stays in f32 range at D = 3 for any localization
// error, and per pair one rsqrt r = (prod_d Pt)^-1/2 gives every 1/Pt_d =
// r^2 prod_{e != d} Pt_e and the normalizer r itself, and one ex2 the
// weight: two MUFU operations and no division per pair.  The factors c
// and sqrt(2c / log2(e)) of the variance and the mean, and prod c^1/2 of
// the normalizer, are common to a position: they are applied once (or
// cancel).
//
// Mapping: one block per track, thread k owns slot k in both scans (K =
// S^W need not be a multiple of 32).  The suffix scan writes slot k's
// form for each interior frame to the stash ((L-2) frames, slot-major:
// one float4 per slot, plus one float (D = 2) or a second float4 (D = 3)),
// in shared memory when it fits what a block may opt in to, else in global
// scratch per persistent block.  In the pair loop each state block's
// (K/S)^2 pairs are split over about K/S threads: a thread takes R prefix
// slots (rows; PairShape) and one of R column ranges of suffix slots, read
// as vector loads that a warp's lanes share (a broadcast), each serving R
// pairs.  Columns go in tiles of J: the tile's exponents first, then one
// rescale of the thread's accumulators to the tile's max, then the
// weights: no branch.  A position ends with warp sums written to a ring of
// kRing positions; warp 0 turns them into mu and sigma, a lane per
// position, every kRing/2 positions and at the track's end.  The prefix
// forms and the fusion's publish area are double-buffered, so each fusion
// and each interior position costs one barrier.
//
// What bounds it on Hopper: instruction issue in the pair loop, S*(K/S)^2
// pairs per interior position at about 26 instructions a pair at D = 2
// (two of them MUFU), then the scans' latency around it.  It is not a
// matrix product (the N^2/P term does not separate), so the tensor cores
// cannot take it.
//
// Past 1024 slots (up to 16384: refinement at the reference's frame_len 7
// at 4 states, 6 at 5 states, 8 at 3 states, 5 at 6 states) the pair loop
// is a tiled kernel of its own, since it takes 89-99% of the cycles there
// (tools/walk_profile.py --split on the one-block-a-track kernel it
// replaced, which gave a thread one prefix row and streamed every column
// from L2 for it).  refine_scan_kernel walks both scans of a track, a
// thread whole fusion groups (K1's wide walk), and writes every interior
// frame's prefix and suffix forms to the track's global scratch;
// refine_pairs_kernel takes a (track, interior position, state block, row
// tile) a block, two prefix rows a thread against the block's columns in
// tiles of up to 512, which one thread copies into shared memory by TMA
// (cp.async.bulk, double-buffered on mbarriers) and every warp reads as
// broadcasts, so that one column's loads serve two pairs; a block's
// partial goes to a fixed slot and refine_merge_kernel adds a position's
// partials in their fixed order.  Where a scan's frames of forms fit
// shared memory it stages them there and copies each out in one bulk
// copy (a thread's own stores, S slots apart, took most of its time).
// The host cuts the tracks into chunks whose carries fit the scratch
// budget (ops/refine_kernel.py).
#include "common.cuh"

namespace extrack {

// The pair loop's shape per block size NT: R prefix slots (rows) per
// thread and J suffix slots per rescale.  Up to 512 threads R = 2, J = 4
// (with at most 128 registers a thread); at 1024 threads, 64 registers,
// R = 1, J = 4 (measured against R = 1, J = 2 and R = 2, J = 2 at 3
// states, W = 6 on an H100: 1087 against 1184 and 1093 ms).
constexpr int kRows = 2;                // the largest R (block sizing)
template <int NT>
struct PairShape {
  static constexpr int R = NT <= 512 ? 2 : 1;
  static constexpr int J = 4;
  // blocks an SM must hold: caps registers at 128 below 512 threads
  static constexpr int kMinBlocks = NT <= 256 ? 512 / NT : 1;
};
constexpr int kRing = 32;               // positions of partials kept

// Floats per slot of one frame of forms, and the frame's stride for K slots
// (slots padded to a multiple of 4, so every frame is 16-byte aligned).
__host__ __device__ constexpr int form_floats(int D) {
  return D == 1 ? 4 : D == 2 ? 5 : 8;
}
__host__ __device__ constexpr int pad4(int K) { return (K + 3) & ~3; }

// One slot's form: b (log2 weight, normalizer included), Pt[D], Nt[D].
// Fields: D = 1 (b, P0, N0, -); D = 2 (b, P0, P1, N0) + N1;
// D = 3 (b, P0, P1, P2) + (N0, N1, N2, -).
template <int D>
static __device__ __forceinline__ void store_form(float* frame, int KP, int k,
                                                  float b, const float* P,
                                                  const float* N) {
  float4* q = reinterpret_cast<float4*>(frame);
  if constexpr (D == 1) {
    q[k] = make_float4(b, P[0], N[0], 0.f);
  } else if constexpr (D == 2) {
    q[k] = make_float4(b, P[0], P[1], N[0]);
    frame[4 * KP + k] = N[1];
  } else {
    q[k] = make_float4(b, P[0], P[1], P[2]);
    reinterpret_cast<float4*>(frame + 4 * KP)[k] =
        make_float4(N[0], N[1], N[2], 0.f);
  }
}

template <int D>
static __device__ __forceinline__ void load_form(const float* frame, int KP,
                                                 int j, float& b, float* P,
                                                 float* N) {
  const float4 q = reinterpret_cast<const float4*>(frame)[j];
  b = q.x;
  if constexpr (D == 1) {
    P[0] = q.y;
    N[0] = q.z;
  } else if constexpr (D == 2) {
    P[0] = q.y;
    P[1] = q.z;
    N[0] = q.w;
    N[1] = frame[4 * KP + j];
  } else {
    P[0] = q.y;
    P[1] = q.z;
    P[2] = q.w;
    const float4 r = reinterpret_cast<const float4*>(frame + 4 * KP)[j];
    N[0] = r.x;
    N[1] = r.y;
    N[2] = r.z;
  }
}

// Slot (m, s2, lp) as a form centred on x with the observation's variance
// l2 as scale c: Pt = c/s2 (+1 on the prefix side, the observation's own
// precision), Nt = (m - x)/s2 * kn with kn = sqrt(c log2(e) / 2),
// b = log2(e) (lp - sum (m-x)^2 / 2 s2) - log2(prod s2) / 2.
template <int D>
static __device__ __forceinline__ void make_form(const float* m,
                                                 const float* s2, float lp,
                                                 const float* x,
                                                 const float* l2,
                                                 const float* kn, float obs,
                                                 float& b, float* P,
                                                 float* N) {
  float quad = 0.f, pv = 1.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float p = rcp(s2[d]);
    const float a = m[d] - x[d];
    quad += 0.5f * a * a * p;
    pv *= s2[d];
    P[d] = fmaf(l2[d], p, obs);
    N[d] = a * p * kn[d];
  }
  b = kLog2e * (lp - quad) - 0.5f * lg2(pv);
}

// One side alone (a track end): observation x prior N(m, s2) per slot.
// Sets mx (base 2) and acc (sum, mean offsets, variances) for partials().
template <int D>
static __device__ void end_side(bool act, const float* m, const float* s2,
                                float lp, const float* x, const float* l2,
                                float& mx, float* acc) {
  mx = kNegBig;
#pragma unroll
  for (int q = 0; q < 1 + 2 * D; ++q) acc[q] = 0.f;
  if (!act) return;
  float quad = 0.f, prod = 1.f, mu_c[D], var_c[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float a = m[d] - x[d];
    const float tot = l2[d] + s2[d];
    const float inv = rcp(tot);
    quad += 0.5f * a * a * inv;
    prod *= tot;
    mu_c[d] = a * l2[d] * inv;
    var_c[d] = s2[d] * l2[d] * inv;
  }
  mx = kLog2e * (lp - quad);
  const float r = rsq(prod);
  acc[0] = r;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    acc[1 + d] = r * mu_c[d];
    acc[1 + D + d] = r * var_c[d];
  }
}

// A position's warp partials: each warp rescales its lanes' shares
// (scaled by 2^-mx) to the warp's max and sums them; lane 0 writes
// (max, sums) to slot[warp * (2+2D) ...].
template <int D>
static __device__ __forceinline__ void partials(float mx, const float* acc,
                                                float* slot) {
  constexpr int F = 2 + 2 * D;
  const float wm = warp_max(mx);
  const float sc = ex2(mx - wm);
  float v[1 + 2 * D];
#pragma unroll
  for (int q = 0; q < 1 + 2 * D; ++q) v[q] = warp_sum(acc[q] * sc);
  if ((threadIdx.x & 31) == 0) {
    float* r = slot + (threadIdx.x >> 5) * F;
    r[0] = wm;
#pragma unroll
    for (int q = 0; q < 1 + 2 * D; ++q) r[1 + q] = v[q];
  }
}

// Warp 0, after a barrier: positions lo .. hi-1 (at most 32) from their
// partials in the ring, one lane each.  A position's sums are taken in warp
// order; mu = x + sum_mean / sum, sigma = sqrt(sum_var / sum).
template <int D>
static __device__ void flush(const float* ring, int nwarp, int lo, int hi,
                             const float* x, float* mu, float* sig) {
  constexpr int F = 2 + 2 * D;
  const int p = lo + (int)threadIdx.x;
  if (threadIdx.x >= 32 || p >= hi) return;
  const float* red = ring + (p % kRing) * nwarp * F;
  float top = kNegBig;
  for (int w = 0; w < nwarp; ++w) top = fmaxf(top, red[w * F]);
  float s[1 + 2 * D] = {};
  for (int w = 0; w < nwarp; ++w) {
    const float f = ex2(red[w * F] - top);
#pragma unroll
    for (int q = 0; q < 1 + 2 * D; ++q) s[q] += f * red[w * F + 1 + q];
  }
  const float inv = 1.0f / fmaxf(s[0], kTiny);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    mu[p * D + d] = x[p * D + d] + s[1 + d] * inv;
    sig[p * D + d] = sqrtf(fmaxf(s[1 + D + d] * inv, 0.f));
  }
}

// The pair loop of one interior position for this thread: rows r0 ..
// r0+R-1 (prefix slots of state block `blk`, rows >= KS masked) against
// suffix columns c0 .. c1-1 of the same block.  Returns the thread's max
// (base 2) and its shares, scaled by 2^-mx.
//
// Per pair, with o_d = prod_{e != d} Pt_e, a_d = Nt_d o_d and r =
// rsqrt(prod_d Pt): 1/Pt_d = r^2 o_d, so the exponent is b1 + b2 +
// r^2 sum_d Nt_d a_d, and with z = 2^(exponent - mx) r^3 the pair adds
// 2^(exponent - mx) r to the weight sum, z a_d to the mean sums and z o_d
// to the variance sums.  b1 is added per row and tile, not per pair.
template <int D, int R, int J, bool kMask>
static __device__ __forceinline__ void pair_tile(
    const float* sform, int KP, int blk, int c, int c1, const float* b1,
    const float (*A)[D], const float (*C)[D], float& mx, float* acc) {
  float b2[J], B2[J][D], N2[J][D];
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
    load_form<D>(sform, KP, blk + (kMask ? min(c + jj, c1 - 1) : c + jj),
                 b2[jj], B2[jj], N2[jj]);
    if (kMask && c + jj >= c1) b2[jj] = -INFINITY;
  }
  float arg[R][J], rw[R][J], r3[R][J],
      av[R][J][D], ov[R][J][D];
  float top = mx, rmax[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    float row = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      float P[D], N[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        P[d] = A[rr][d] + B2[jj][d];
        N[d] = C[rr][d] + N2[jj][d];
      }
      float o[D];
      if constexpr (D == 1) {
        o[0] = 1.f;
      } else if constexpr (D == 2) {
        o[0] = P[1];
        o[1] = P[0];
      } else {
        o[0] = P[1] * P[2];
        o[1] = P[0] * P[2];
        o[2] = P[0] * P[1];
      }
      const float r = rsq(P[0] * o[0]);
      const float r2 = r * r;
      float t = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        av[rr][jj][d] = N[d] * o[d];
        ov[rr][jj][d] = o[d];
        t = fmaf(N[d], av[rr][jj][d], t);
      }
      rw[rr][jj] = r;
      r3[rr][jj] = r2 * r;
      arg[rr][jj] = fmaf(t, r2, b2[jj]);
      row = fmaxf(row, arg[rr][jj]);
    }
    rmax[rr] = row;
    top = fmaxf(top, row + b1[rr]);
  }
  const float sc = ex2(mx - top);
  mx = top;
#pragma unroll
  for (int q = 0; q < 1 + 2 * D; ++q) acc[q] *= sc;
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    // 2^(arg + b1 - mx) as 2^(arg - off): off >= the row's max, so no
    // weight exceeds 1 where b1 and mx are as large as the log floor
    const float off = fmaxf(mx - b1[rr], rmax[rr]);
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const float e = ex2(arg[rr][jj] - off);
      acc[0] = fmaf(e, rw[rr][jj], acc[0]);
      const float z = e * r3[rr][jj];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        acc[1 + d] = fmaf(z, av[rr][jj][d], acc[1 + d]);
        acc[1 + D + d] = fmaf(z, ov[rr][jj][d], acc[1 + D + d]);
      }
    }
  }
}

template <int D, int R, int J>
static __device__ __forceinline__ void pair_loop(const float* pform,
                                                 const float* sform, int KP,
                                                 int blk, int KS, int r0,
                                                 int c0, int c1, float& mx,
                                                 float* acc) {
  float b1[R], A[R][D], C[R][D];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int i = min(r0 + rr, KS - 1);
    load_form<D>(pform, KP, blk + i, b1[rr], A[rr], C[rr]);
    if (r0 + rr >= KS) b1[rr] = -INFINITY;
  }
  int c = c0;
  for (; c + J <= c1; c += J)
    pair_tile<D, R, J, false>(sform, KP, blk, c, c1, b1, A, C, mx, acc);
  if (c < c1)
    pair_tile<D, R, J, true>(sform, KP, blk, c, c1, b1, A, C, mx, acc);
}

// Sections of K6's cycle split (tools/walk_profile.py --split).
enum {
  kRfSuffix = 0, kRfStash = 1, kRfForms = 2, kRfPairs = 3, kRfFinish = 4,
  kRfPrefix = 5
};
static __device__ unsigned long long g_refine_prof[kProfSlots];

// Per-dimension sqrt(c log2(e) / 2) of an observation's variance c (the
// scale of Nt; c > 0).
template <int D>
static __device__ __forceinline__ void scale_n(const float* l2, float* kn) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float h = 0.5f * kLog2e * l2[d];
    kn[d] = h * rsq(h);
  }
}

// NT: the largest block the instantiation is launched with; ptxas gives
// each thread up to 65536 / (NT * kMinBlocks) registers (128 up to 512
// threads, 64 at 1024).
template <int D, int NT>
__global__ void __launch_bounds__(NT, PairShape<NT>::kMinBlocks)
    refine_kernel(const float* __restrict__ xs, const float* __restrict__ l2s,
                  const int* __restrict__ lengths,
                  const float* __restrict__ lp0f, const float* __restrict__ ltf,
                  const float* __restrict__ lp0r, const float* __restrict__ ltr,
                  const float* __restrict__ sig2v, int B, int T, int K, int S,
                  float* __restrict__ mu_out, float* __restrict__ sig_out,
                  float* __restrict__ stash_scratch) {
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  constexpr int F = 2 + 2 * D;
  const int k = threadIdx.x;
  const bool act = k < K;
  const int nwarp = blockDim.x >> 5;
  const int KS = K / S;
  const int m0 = (k % KS) * S;                  // first member of k's group
  const int KP = pad4(K);
  const int FS = form_floats(D) * KP;         // floats per frame of forms
  // pair-loop work: state block s, row group g, column range h
  constexpr int R = PairShape<NT>::R, J = PairShape<NT>::J;
  const int NR = (KS + R - 1) / R;              // row groups per block
  const int TB = NR * R;                        // threads per state block
  const int CW = (KS + R - 1) / R;              // columns per range
  const bool pairs = k < S * TB;
  const int blk = (k / TB) * KS;
  const int g = (k % TB) % NR, h = (k % TB) / NR;
  const int c0 = min(h * CW, KS), c1 = min(c0 + CW, KS);
  // shared memory: two prefix-form frames, the stash (when it is not in
  // global scratch), two fusion publish areas, the ring of partials
  const size_t nst = (size_t)max(T - 2, 0) * FS;
  float* pforms = sh;
  float* stash = stash_scratch != nullptr
                     ? stash_scratch + (size_t)blockIdx.x * nst
                     : sh + 2 * FS;
  float* pubs = sh + 2 * FS + (stash_scratch != nullptr ? 0 : nst);
  float* ring = pubs + 2 * F * K;
  int buf = 0;                                  // publish area in turn
  float gmx, ginv;                              // fusion max, 1/sum (unused)

  Prof pf;
  pf.start();
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int L = min(lengths[b], T);
    const float* x = xs + (size_t)b * T * D;
    const float* l2 = l2s + (size_t)b * T * D;
    float* mu = mu_out + (size_t)b * T * D;
    float* sig = sig_out + (size_t)b * T * D;
    // padded frames (and empty rows) are exact zeros
    for (int j = L * D + k; j < T * D; j += blockDim.x) mu[j] = sig[j] = 0.f;
    if (L < 2) {
      // a lone observation: mu = x, sigma = its localization error
      if (L == 1 && k < D) {
        mu[k] = x[k];
        sig[k] = sqrtf(l2[k]);
      }
      continue;
    }
    __syncthreads();        // the previous track's readers are done
    // ---- suffix scan from frame L-1 down, stashing frames L-2 .. 1 -----
    float m[D], s2[D], kn[D], lp = act ? lp0r[k] : 0.f;
    const float s20 = act ? sig2v[k] : 1.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      m[d] = x[(L - 1) * D + d];
      s2[d] = l2[(L - 1) * D + d] + s20;
    }
    for (int f = L - 2; f >= 1; --f) {
      const float* xf = x + f * D;
      const float* l2f = l2 + f * D;
      if (act) {
        float fb, fP[D], fN[D];
        scale_n<D>(l2f, kn);
        make_form<D>(m, s2, lp, xf, l2f, kn, 0.f, fb, fP, fN);
        if (stash_scratch == nullptr)     // shared stores (see pair_loop)
          store_form<D>(sh + 2 * FS + (size_t)(f - 1) * FS, KP, k, fb, fP,
                        fN);
        else
          store_form<D>(stash + (size_t)(f - 1) * FS, KP, k, fb, fP, fN);
      }
      pf.mark(kRfStash);
      float* pub = pubs + buf * F * K;
      buf ^= 1;
      publish2<D>(act, m, s2, lp, xf, l2f, pub, K);
      __syncthreads();
      gather2<D, 0>(act, m, s2, lp, pub, act ? ltr[k] : 0.f, s20, K, m0, S,
                    gmx, ginv);
      pf.mark(kRfSuffix);
    }
    // ---- position 0: the suffix side alone ----------------------------
    float acc[1 + 2 * D], mx;
    end_side<D>(act, m, s2, lp, x, l2, mx, acc);
    partials<D>(mx, acc, ring);
    int done = 0;                                // positions written out
    pf.mark(kRfFinish);
    // ---- prefix scan with the combine ---------------------------------
    lp = act ? lp0f[k] : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      m[d] = x[d];
      s2[d] = l2[d] + s20;
    }
    for (int t = 1; t < L - 1; ++t) {
      const float* xt = x + t * D;
      const float* l2t = l2 + t * D;
      float* pform = pforms + (t & 1) * FS;
      scale_n<D>(l2t, kn);
      if (act) {
        float fb, fP[D], fN[D];
        make_form<D>(m, s2, lp, xt, l2t, kn, 1.f, fb, fP, fN);
        store_form<D>(pform, KP, k, fb, fP, fN);
      }
      float* pub = pubs + buf * F * K;
      buf ^= 1;
      publish2<D>(act, m, s2, lp, xt, l2t, pub, K);
      pf.mark(kRfForms);
      __syncthreads();
      pf.mark(kRfPrefix);
      if (t - done == kRing / 2) {               // half the ring is full
        flush<D>(ring, nwarp, done, t, x, mu, sig);
        done = t;
      }
      mx = kNegBig;
#pragma unroll
      for (int q = 0; q < 1 + 2 * D; ++q) acc[q] = 0.f;
      // two call sites, so that the one on the shared-memory stash reads
      // it with shared loads (a pointer that may be either is read with
      // generic loads)
      if (pairs && stash_scratch == nullptr)
        pair_loop<D, R, J>(pform, sh + 2 * FS + (size_t)(t - 1) * FS, KP,
                           blk, KS, g * R, c0, c1, mx, acc);
      else if (pairs)
        pair_loop<D, R, J>(pform, stash + (size_t)(t - 1) * FS, KP, blk, KS,
                           g * R, c0, c1, mx, acc);
      pf.mark(kRfPairs);
      // the position's common factors: mean l2 / kn = sqrt(2 l2 / log2 e),
      // variance l2
#pragma unroll
      for (int d = 0; d < D; ++d) {
        acc[1 + d] *= l2t[d] * rcp(kn[d]);
        acc[1 + D + d] *= l2t[d];
      }
      partials<D>(mx, acc, ring + (t % kRing) * nwarp * F);
      pf.mark(kRfFinish);
      gather2<D, 0>(act, m, s2, lp, pub, act ? ltf[k] : 0.f, s20, K, m0, S,
                    gmx, ginv);
      pf.mark(kRfPrefix);
    }
    // ---- position L-1: the prefix side alone --------------------------
    end_side<D>(act, m, s2, lp, x + (L - 1) * D, l2 + (L - 1) * D, mx, acc);
    partials<D>(mx, acc, ring + ((L - 1) % kRing) * nwarp * F);
    __syncthreads();
    flush<D>(ring, nwarp, done, L, x, mu, sig);
    pf.mark(kRfFinish);
  }
  pf.flush(g_refine_prof, threadIdx.x == 0);
}

// ---- the wide mapping: 1024 < K <= 16384 slots ------------------------
//
// Three kernels a chunk of tracks (extrack_refine, wide >= 1):
// refine_scan_kernel walks both transition-only scans of one track a
// block and writes every interior frame's prefix and suffix forms to the
// track's global scratch (its two ends' moments it writes itself);
// refine_pairs_kernel takes one (track, interior position, state block,
// row tile) a block: R prefix rows a thread in registers against every
// suffix column of the state block, the columns in tiles that one thread
// brings into shared memory by TMA bulk copies (double-buffered, each
// completing on an mbarrier) and every warp reads as broadcasts; it
// writes the block's (max, sums) partial to a fixed slot, and
// refine_merge_kernel turns a position's partials into mu and sigma in a
// fixed order (no float atomics: two launches agree bit for bit).

constexpr int kRefineWideMaxK = 16384;
constexpr int kScanThreads = 1024;       // the scan kernel's largest block
constexpr int kPairThreads = 256;        // the pair kernel's largest block
constexpr int kPairRows = 2;             // its prefix rows a thread (R)
constexpr int kTileCols = 512;           // suffix columns a shared tile
constexpr int kMergeThreads = 128;

// Forms of the tiled wide mapping: each state block's KS slots padded to
// KSP = pad4(KS), so that every block's columns start 16-byte aligned for
// the bulk copies; slot k = s*KS + j sits at s*KSP + j of a frame of
// S*KSP slots (store_form's layout).
__host__ __device__ constexpr int blk_pad(int KS) { return pad4(KS); }

// A track's carry on the wide mapping (floats): T-2 suffix frames, T-2
// prefix frames, the pair kernel's partials (nrt row tiles a state block
// and interior position), and with the publish areas in global scratch
// (gpubs) the scan's two publish areas.
__host__ __device__ inline size_t wide_frame(int D, int K, int S) {
  return (size_t)form_floats(D) * S * blk_pad(K / S);
}
__host__ __device__ inline size_t wide_parts(int T, int D, int S, int nrt) {
  return pad4(max(T - 2, 0) * S * nrt * (2 + 2 * D));
}
__host__ __device__ inline size_t wide_carry(int T, int D, int K, int S,
                                             int nrt, size_t gpubs) {
  return 2 * (size_t)max(T - 2, 0) * wide_frame(D, K, S) +
         wide_parts(T, D, S, nrt) + pad4(gpubs);
}

// The scan kernel's shape: a thread a fusion group (G = K/S), at most
// kScanThreads; two publish areas of (2D+1)*G floats; the forms staged in
// shared memory (two frames, written out to the track's scratch by bulk
// copies) where that, the publish areas and two positions' warp partials
// take at most kStageMaxBytes (a thread's 16-byte stores S slots apart
// otherwise take most of the scan's time where K is small and the tracks
// many, as at 6^4 on 2^14 walks).
constexpr size_t kStageMaxBytes = 200 * 1024;
struct ScanPlan {
  int threads;
  bool stage;
  size_t pubs, ring, stage_floats;
};
static ScanPlan scan_plan(int D, int K, int S, int wide) {
  const int G = K / S;
  ScanPlan p;
  p.threads = min(kScanThreads, (G + 31) / 32 * 32);
  p.pubs = (size_t)2 * (2 * D + 1) * G;
  p.ring = (size_t)2 * (p.threads / 32) * (2 + 2 * D);
  p.stage_floats = 2 * wide_frame(D, K, S);
  p.stage = wide == 1 && (p.pubs + p.ring + p.stage_floats) *
                                 sizeof(float) <= kStageMaxBytes;
  if (!p.stage) p.stage_floats = 0;
  return p;
}

static __device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from shared
// to global memory in one bulk group
static __device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                                  unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// The scans of one track (block b): both give a thread whole fusion groups,
// as K1's wide walk (walk.cuh): member c = g*S + o of group g is child c /
// G of group c % G of the last fusion (G = K/S), so its carry is that
// group's fused Gaussian from the publish area plus its transition and
// variance, and a step writes the member's form, mixes the group's S
// updates in registers and publishes G fused Gaussians ((2D+1) floats
// each), double-buffered.  Side 0 is the suffix scan (frames L-1 down to
// 1, forms of frames L-2 .. 1), then side 1 the prefix scan (forms of
// frames 1 .. L-2).  With `stage` a step's forms go to one of two frames
// in shared memory, which thread 0 copies out after the step's barrier.
// Positions 0 and L-1 (one side each) are reduced here; the interior's
// pairs are refine_pairs_kernel's.
template <int D>
static __device__ __forceinline__ void refine_scan_track(
    const float* __restrict__ xs, const float* __restrict__ l2s,
    const int* __restrict__ lengths, const float* __restrict__ lp0f,
    const float* __restrict__ ltf, const float* __restrict__ lp0r,
    const float* __restrict__ ltr, const float* __restrict__ sig2v, int T,
    int K, int S, float* __restrict__ mu_out, float* __restrict__ sig_out,
    float* pubs, float* ring, float* forms, float* stage) {
  constexpr int F = 2 + 2 * D;                  // a warp partial's floats
  constexpr int FG = 2 * D + 1;                 // a fused group's floats
  const int b = blockIdx.x;
  const int KS = K / S, G = KS;                 // groups: A = S members
  const int tid = threadIdx.x, nt = blockDim.x, nwarp = nt >> 5;
  const int KSP = blk_pad(KS), KP = S * KSP;
  const size_t FS = wide_frame(D, K, S);        // floats per frame of forms
  int buf = 0;                                  // publish area in turn

  Prof pf;
  pf.start();
  const int L = min(lengths[b], T);
  const float* x = xs + (size_t)b * T * D;
  const float* l2 = l2s + (size_t)b * T * D;
  float* mu = mu_out + (size_t)b * T * D;
  float* sig = sig_out + (size_t)b * T * D;
  for (int j = L * D + tid; j < T * D; j += nt) mu[j] = sig[j] = 0.f;
  if (L < 2) {
    if (L == 1 && tid < D) {
      mu[tid] = x[tid];
      sig[tid] = sqrtf(l2[tid]);
    }
    return;
  }
  // member c's carry: fresh (frame `f0` with table lp0) or group c % G
  // of the last fusion plus the transition `lt`
  const float* prev = nullptr;
  auto carry = [&](int c, int f0, const float* lp0, const float* lt,
                   float* m, float* s2, float& lp) {
    const float sv = __ldg(sig2v + c);
    if (prev == nullptr) {
      lp = __ldg(lp0 + c);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        m[d] = x[f0 * D + d];
        s2[d] = l2[f0 * D + d] + sv;
      }
    } else {
      const int gp = c % G;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        m[d] = prev[d * G + gp];
        s2[d] = sv + prev[(D + d) * G + gp];
      }
      lp = prev[2 * D * G + gp] + __ldg(lt + c);
    }
  };
  // the frame of forms of `side`'s i-th step in the track's scratch
  auto out_frame = [&](int side, int i) {
    const int f = side ? 1 + i : L - 2 - i;
    return forms + ((size_t)side * max(T - 2, 0) + f - 1) * FS;
  };
  // one scan step of `side` (its i-th, the track's k-th): every member's
  // form at its frame (the prefix side with the observation's own
  // precision), then its update mixed into its group and the groups
  // published; the caller's barrier follows
  auto scan_step = [&](int side, int i, int k) {
    const int f = side ? 1 + i : L - 2 - i;
    const int f0 = side ? 0 : L - 1;
    const float* lp0 = side ? lp0f : lp0r;
    const float* lt = side ? ltf : ltr;
    const float obs = side ? 1.f : 0.f;
    float* frame = stage != nullptr ? stage + (k & 1) * FS
                                    : out_frame(side, i);
    const float* xf = x + f * D;
    const float* l2f = l2 + f * D;
    float kn[D];
    scale_n<D>(l2f, kn);
    float* pub = pubs + buf * FG * G;
    buf ^= 1;
    for (int g = tid; g < G; g += nt) {
      float gmx = kNegBig, gsw = 0.f, mf[D], tf[D];
#pragma unroll
      for (int d = 0; d < D; ++d) mf[d] = tf[d] = 0.f;
      // the group's S members share a state block (KS is a multiple of S)
      const int pad = (g * S) / KS * (KSP - KS);
      for (int o = 0; o < S; ++o) {
        const int c = g * S + o;
        float m[D], s2[D], lp;
        carry(c, f0, lp0, lt, m, s2, lp);
        float fb, fP[D], fN[D];
        make_form<D>(m, s2, lp, xf, l2f, kn, obs, fb, fP, fN);
        store_form<D>(frame, KP, c + pad, fb, fP, fN);
        Upd<D> u;
        update2<D>(m, s2, xf, l2f, u);
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
      }
      gsw = fmaxf(gsw, kTiny);
      const float inv = rcp(gsw);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        pub[d * G + g] = mf[d] * inv;
        pub[(D + d) * G + g] = tf[d] * inv;
      }
      pub[2 * D * G + g] = (gmx + lg2(gsw)) * kLn2;
    }
    if (stage != nullptr)   // the staged forms to the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    return pub;
  };
  // one side alone at its track end (the suffix side at position 0, the
  // prefix side at L-1): the thread's slots' shares, then warp partials
  auto end_sides = [&](int side, float* slot) {
    const int f = side ? L - 1 : 0;
    const int f0 = side ? 0 : L - 1;
    const float* lp0 = side ? lp0f : lp0r;
    const float* lt = side ? ltf : ltr;
    float mx = kNegBig, acc[1 + 2 * D];
#pragma unroll
    for (int q = 0; q < 1 + 2 * D; ++q) acc[q] = 0.f;
    for (int c = tid; c < K; c += nt) {
      float m[D], s2[D], lp, cm, ca[1 + 2 * D];
      carry(c, f0, lp0, lt, m, s2, lp);
      end_side<D>(true, m, s2, lp, x + f * D, l2 + f * D, cm, ca);
      const float top = fmaxf(mx, cm);
      const float s0 = ex2(mx - top), s1 = ex2(cm - top);
#pragma unroll
      for (int q = 0; q < 1 + 2 * D; ++q) acc[q] = acc[q] * s0 + ca[q] * s1;
      mx = top;
    }
    partials<D>(mx, acc, slot);
  };
  // the suffix scan from frame L-1 down, then the prefix scan; with the
  // forms staged, thread 0 waits before step k's barrier until step k-1's
  // copy has read its frame (step k+1 writes it again), and copies step
  // k's frame out after it
  for (int side = 0; side < 2; ++side) {
    prev = nullptr;
    for (int i = 0; i < L - 2; ++i) {
      const int k = side * (L - 2) + i;
      const float* pub = scan_step(side, i, k);
      pf.mark(side ? kRfForms : kRfSuffix);
      if (stage != nullptr && tid == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      __syncthreads();
      if (stage != nullptr && tid == 0) {
        bulk_store(out_frame(side, i), stage + (k & 1) * FS,
                   (unsigned)(FS * sizeof(float)));
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
      pf.mark(kRfPrefix);
      prev = pub;
    }
    end_sides(side, ring + side * nwarp * F);
  }
  if (stage != nullptr && tid == 0)   // the copies complete before exit
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  pf.mark(kRfFinish);
  __syncthreads();
  // lanes 0 and 1 of warp 0: positions 0 and L-1 from their warp partials
  if (tid < 2) {
    const int p = tid == 0 ? 0 : L - 1;
    const float* red = ring + tid * nwarp * F;
    float top = kNegBig;
    for (int w = 0; w < nwarp; ++w) top = fmaxf(top, red[w * F]);
    float sm[1 + 2 * D] = {};
    for (int w = 0; w < nwarp; ++w) {
      const float f = ex2(red[w * F] - top);
#pragma unroll
      for (int q = 0; q < 1 + 2 * D; ++q) sm[q] += f * red[w * F + 1 + q];
    }
    const float inv = 1.0f / fmaxf(sm[0], kTiny);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      mu[p * D + d] = x[p * D + d] + sm[1 + d] * inv;
      sig[p * D + d] = sqrtf(fmaxf(sm[1 + D + d] * inv, 0.f));
    }
  }
  pf.mark(kRfFinish);
  pf.flush(g_refine_prof, threadIdx.x == 0);
}

// One block a track of the chunk (scan_plan's shape).  Shared memory: two
// staged frames of forms (with `stage`), the two publish areas (in the
// track's scratch after its forms and partials with GPUBS), two
// positions' warp partials.
template <int D, bool GPUBS>
__global__ void __launch_bounds__(kScanThreads, 1)
    refine_scan_kernel(const float* __restrict__ xs,
                       const float* __restrict__ l2s,
                       const int* __restrict__ lengths,
                       const float* __restrict__ lp0f,
                       const float* __restrict__ ltf,
                       const float* __restrict__ lp0r,
                       const float* __restrict__ ltr,
                       const float* __restrict__ sig2v, int T, int K, int S,
                       int nrt, int stage, float* __restrict__ mu_out,
                       float* __restrict__ sig_out,
                       float* __restrict__ scratch, long long stride) {
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  float* forms = scratch + (size_t)blockIdx.x * stride;
  if constexpr (GPUBS) {
    refine_scan_track<D>(xs, l2s, lengths, lp0f, ltf, lp0r, ltr, sig2v, T, K,
                         S, mu_out, sig_out,
                         forms + 2 * (size_t)max(T - 2, 0) *
                                     wide_frame(D, K, S) +
                             wide_parts(T, D, S, nrt),
                         sh, forms, nullptr);
  } else {
    const size_t staged = stage ? 2 * wide_frame(D, K, S) : 0;
    float* pubs = sh + staged;
    refine_scan_track<D>(xs, l2s, lengths, lp0f, ltf, lp0r, ltr, sig2v, T, K,
                         S, mu_out, sig_out, pubs,
                         pubs + (size_t)2 * (2 * D + 1) * (K / S), forms,
                         stage ? sh : nullptr);
  }
}

// mbarrier and bulk-copy helpers (PTX, sm_90).
static __device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}
// arrive once and expect `bytes` of copies before the phase completes
static __device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
static __device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                                 unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completing on `bar`
static __device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                                 unsigned bytes,
                                                 unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Sections of the pair kernel's cycle split (tools/walk_profile.py).
enum { kRpWait = 6, kRpPairs = 7, kRpPartial = 8 };

// The pairs of one (track c, interior position p, state block s, row
// tile rt) block of a chunk: thread t's rows rt*R*nt + rr*nt + t (rr < R
// = kPairRows; rows >= KS masked) against the KS suffix columns of block s
// in tiles of TC columns (the last one partial), pair_tile's algebra J = 4
// columns at a time (the tile-max rescale, two MUFU a pair).  Writes the
// block's (max, sums) to partial ((p-1)*S + s)*nrt + rt of track c's carry
// (`stride` floats a track, after its forms); positions past the track's
// interior exit at once.  Two rows a thread ran faster than four at the
// same rows on an H100 at every shape tried, and pad K/S less.
template <int D>
__global__ void __launch_bounds__(kPairThreads, 2)
    refine_pairs_kernel(const int* __restrict__ lengths, int T, int K, int S,
                        int nrt, int TC, float* __restrict__ scratch,
                        long long stride) {
  constexpr int R = kPairRows, J = 4;
  constexpr int F = 2 + 2 * D;
  constexpr int FF = form_floats(D);
  extern __shared__ float4 tiles4[];            // two tiles of FF*TC floats
  __shared__ unsigned long long full[2];
  __shared__ float red[(kPairThreads / 32) * F];
  const int tid = threadIdx.x, nt = blockDim.x;
  unsigned q = blockIdx.x;
  const int rt = q % nrt;
  q /= nrt;
  const int s = q % S;
  q /= S;
  const int p = q % (T - 2) + 1, c = q / (T - 2);
  if (p >= min(lengths[c], T) - 1) return;      // not an interior position
  const int KS = K / S, KSP = blk_pad(KS), KP = S * KSP;
  const size_t FS = wide_frame(D, K, S);
  float* trk = scratch + (size_t)c * stride;
  const float* sform = trk + (size_t)(p - 1) * FS;
  const float* pform = trk + (size_t)(T - 2 + p - 1) * FS;
  float* tiles = reinterpret_cast<float*>(tiles4);
  const int ntile = (KS + TC - 1) / TC;
  // thread 0 copies tile k of block s's columns into buffer k & 1: the
  // forms' first float4 a slot, then (D > 1) their second part
  auto load_tile = [&](int k) {
    unsigned long long* bar = full + (k & 1);
    float* dst = tiles + (k & 1) * FF * TC;
    const int c0 = k * TC, n4 = pad4(min(TC, KS - c0));
    const size_t col = (size_t)s * KSP + c0;
    mbar_expect(bar, (unsigned)(n4 * FF * 4));
    bulk_load(dst, sform + 4 * col, n4 * 16, bar);
    if constexpr (D == 2)
      bulk_load(dst + 4 * TC, sform + 4 * (size_t)KP + col, n4 * 4, bar);
    if constexpr (D == 3)
      bulk_load(dst + 4 * TC, sform + 4 * (size_t)KP + 4 * col, n4 * 16,
                bar);
  };
  Prof pf;
  pf.start();
  if (tid == 0) {
    mbar_init(full);
    mbar_init(full + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    load_tile(0);
    if (ntile > 1) load_tile(1);
  }
  // the thread's prefix rows
  float b1[R], A[R][D], C[R][D];
  const int r0 = rt * R * nt + tid;
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int i = r0 + rr * nt;
    load_form<D>(pform, KP, s * KSP + min(i, KS - 1), b1[rr], A[rr], C[rr]);
    if (i >= KS) b1[rr] = -INFINITY;
  }
  float mx = kNegBig, acc[1 + 2 * D];
#pragma unroll
  for (int qq = 0; qq < 1 + 2 * D; ++qq) acc[qq] = 0.f;
  for (int k = 0; k < ntile; ++k) {
    mbar_wait(full + (k & 1), (k >> 1) & 1);
    pf.mark(kRpWait);
    const float* tile = tiles + (k & 1) * FF * TC;
    const int n = min(TC, KS - k * TC);
    int cc = 0;
#pragma unroll 2
    for (; cc + J <= n; cc += J)
      pair_tile<D, R, J, false>(tile, TC, 0, cc, n, b1, A, C, mx, acc);
    if (cc < n) pair_tile<D, R, J, true>(tile, TC, 0, cc, n, b1, A, C, mx, acc);
    pf.mark(kRpPairs);
    __syncthreads();                            // every warp is done with it
    if (tid == 0 && k + 2 < ntile) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_tile(k + 2);
    }
    pf.mark(kRpWait);
  }
  // the block's partial: warp partials, then thread 0 in warp order
  partials<D>(mx, acc, red);
  __syncthreads();
  if (tid == 0) {
    const int nwarp = nt >> 5;
    float top = kNegBig;
    for (int w = 0; w < nwarp; ++w) top = fmaxf(top, red[w * F]);
    float sm[1 + 2 * D] = {};
    for (int w = 0; w < nwarp; ++w) {
      const float f = ex2(red[w * F] - top);
#pragma unroll
      for (int qq = 0; qq < 1 + 2 * D; ++qq)
        sm[qq] += f * red[w * F + 1 + qq];
    }
    float* out = trk + 2 * (size_t)(T - 2) * FS +
                 ((size_t)((p - 1) * S + s) * nrt + rt) * F;
    out[0] = top;
#pragma unroll
    for (int qq = 0; qq < 1 + 2 * D; ++qq) out[1 + qq] = sm[qq];
  }
  pf.mark(kRpPartial);
  pf.flush(g_refine_prof, tid == 0);
}

// A thread an interior position (c, p) of the chunk: its S*nrt partials
// in their fixed order, then the position's common factors (mean l2 / kn
// = sqrt(2 l2 / log2 e), variance l2), mu = x + mean, sigma = sqrt(var).
template <int D>
__global__ void __launch_bounds__(kMergeThreads)
    refine_merge_kernel(const float* __restrict__ xs,
                        const float* __restrict__ l2s,
                        const int* __restrict__ lengths, int B, int T, int K,
                        int S, int nrt, const float* __restrict__ scratch,
                        long long stride, float* __restrict__ mu_out,
                        float* __restrict__ sig_out) {
  constexpr int F = 2 + 2 * D;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * (T - 2)) return;
  const int c = i / (T - 2), p = i % (T - 2) + 1;
  if (p >= min(lengths[c], T) - 1) return;
  const float* red =
      scratch + (size_t)c * stride +
      2 * (size_t)(T - 2) * wide_frame(D, K, S) +
      (size_t)(p - 1) * S * nrt * F;
  const int n = S * nrt;
  float top = kNegBig;
  for (int w = 0; w < n; ++w) top = fmaxf(top, red[w * F]);
  float sm[1 + 2 * D] = {};
  for (int w = 0; w < n; ++w) {
    const float f = ex2(red[w * F] - top);
#pragma unroll
    for (int q = 0; q < 1 + 2 * D; ++q) sm[q] += f * red[w * F + 1 + q];
  }
  const size_t at = ((size_t)c * T + p) * D;
  float kn[D];
  scale_n<D>(l2s + at, kn);
  const float inv = 1.0f / fmaxf(sm[0], kTiny);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float l2 = l2s[at + d];
    mu_out[at + d] = xs[at + d] + sm[1 + d] * (l2 * rcp(kn[d])) * inv;
    sig_out[at + d] = sqrtf(fmaxf(sm[1 + D + d] * l2 * inv, 0.f));
  }
}

// K6's block for T frames, D dimensions, K slots at S states.  Threads: one
// per slot, and enough for the pair loop's S * ceil(K/S / R) * R threads.
// Shared memory besides the stash: two frames of prefix forms, two fusion
// publish areas of (2+2D)*K floats, and the ring of kRing positions' warp
// partials ((2+2D) floats per warp).  Carry: the suffix stash, a frame of
// forms for each interior position 1 .. T-2.  The wide mapping (rows: the
// pair kernel's rows a block, kPairRows * its threads): the scan kernel's
// block (scan_plan), a thread a fusion group up to 1024; its shared
// memory two staged frames of forms where they fit, two publish areas of
// (2D+1)*K/S floats and two positions' warp partials; carry a track
// (wide_carry): its T-2 suffix and T-2 prefix frames of forms and the
// pair kernel's partials.  wide = 2: the publish areas after them in the
// carry, nothing staged.
static BlockLayout refine_layout(int T, int D, int K, int S, int wide,
                                 int rows) {
  if (wide) {
    const ScanPlan sp = scan_plan(D, K, S, wide);
    const int nrt = (K / S + rows - 1) / rows;
    const size_t fixed =
        sp.stage_floats + (wide == 2 ? 0 : sp.pubs) + sp.ring;
    return {sp.threads, fixed * sizeof(float),
            wide_carry(T, D, K, S, nrt, wide == 2 ? sp.pubs : 0) *
                sizeof(float)};
  }
  const int KS = K / S;
  const int t = max(K, S * ((KS + kRows - 1) / kRows) * kRows);
  const int threads = (t + 31) / 32 * 32;
  const size_t FS = (size_t)form_floats(D) * pad4(K);
  const size_t fixed = 2 * FS + (size_t)2 * (2 + 2 * D) * K +
                       (size_t)kRing * (threads / 32) * (2 + 2 * D);
  return {threads, fixed * sizeof(float),
          (size_t)max(T - 2, 0) * FS * sizeof(float)};
}

// The tiled wide mapping on a chunk of B tracks whose carries (wide_carry)
// are `scratch`: the scan, then (T > 2) the pairs (NT threads a block)
// and the merge.
template <int D>
static int launch_wide(const float* xs, const float* l2, const int* lengths,
                       const float* lp0f, const float* ltf, const float* lp0r,
                       const float* ltr, const float* sig2v, float* mu,
                       float* sig, float* scratch, int B, int T, int K, int S,
                       int wide, int NT, cudaStream_t stream) {
  const int KS = K / S, rows = kPairRows * NT;
  const int nrt = (KS + rows - 1) / rows;
  const BlockLayout lay = refine_layout(T, D, K, S, wide, rows);
  const ScanPlan sp = scan_plan(D, K, S, wide);
  const long long stride = (long long)(lay.carry / sizeof(float));
  if (B <= 0) return (int)cudaGetLastError();
  if (wide == 2) {
    refine_scan_kernel<D, true><<<B, lay.threads, lay.fixed, stream>>>(
        xs, l2, lengths, lp0f, ltf, lp0r, ltr, sig2v, T, K, S, nrt, 0, mu,
        sig, scratch, stride);
  } else {
    cudaFuncSetAttribute(refine_scan_kernel<D, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)lay.fixed);
    refine_scan_kernel<D, false><<<B, lay.threads, lay.fixed, stream>>>(
        xs, l2, lengths, lp0f, ltf, lp0r, ltr, sig2v, T, K, S, nrt, sp.stage,
        mu, sig, scratch, stride);
  }
  if (T <= 2) return (int)cudaGetLastError();
  const int TC = min(kTileCols, pad4(KS));
  const size_t smem = (size_t)2 * form_floats(D) * TC * sizeof(float);
  const long long blocks = (long long)B * (T - 2) * S * nrt;
  refine_pairs_kernel<D><<<(unsigned)blocks, NT, smem, stream>>>(
      lengths, T, K, S, nrt, TC, scratch, stride);
  const int n = B * (T - 2);
  refine_merge_kernel<D><<<(n + kMergeThreads - 1) / kMergeThreads,
                           kMergeThreads, 0, stream>>>(
      xs, l2, lengths, B, T, K, S, nrt, scratch, stride, mu, sig);
  return (int)cudaGetLastError();
}

template <int D, int NT>
static int launch_nt(const float* xs, const float* l2, const int* lengths,
                     const float* lp0f, const float* ltf, const float* lp0r,
                     const float* ltr, const float* sig2v, float* mu,
                     float* sig, float* stash_scratch, int B, int T, int K,
                     int S, int nblk, int threads, size_t smem,
                     cudaStream_t stream) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(refine_kernel<D, NT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  if (B > 0)
    refine_kernel<D, NT><<<nblk, threads, smem, stream>>>(
        xs, l2, lengths, lp0f, ltf, lp0r, ltr, sig2v, B, T, K, S, mu, sig,
        stash_scratch);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_refine(const float* xs, const float* l2, const int* lengths,
                         const float* lp0f, const float* ltf,
                         const float* lp0r, const float* ltr,
                         const float* sig2v, float* mu, float* sig,
                         float* stash_scratch, int B, int T, int K, int S,
                         int nblk, cudaStream_t stream) {
  const BlockLayout lay = refine_layout(T, D, K, S, 0, 0);
  const int threads = lay.threads;
  const size_t smem = lay.fixed + (stash_scratch != nullptr ? 0 : lay.carry);
#define EXTRACK_REFINE_NT(NT)                                                 \
  launch_nt<D, NT>(xs, l2, lengths, lp0f, ltf, lp0r, ltr, sig2v, mu, sig,    \
                   stash_scratch, B, T, K, S, nblk, threads, smem, stream)
  if (threads <= 128) return EXTRACK_REFINE_NT(128);
  if (threads <= 256) return EXTRACK_REFINE_NT(256);
  if (threads <= 512) return EXTRACK_REFINE_NT(512);
  if (threads <= 1024) return EXTRACK_REFINE_NT(1024);
#undef EXTRACK_REFINE_NT
  return (int)cudaErrorInvalidValue;
}

}  // namespace extrack

// Reads and zeroes K6's cycle split (profile builds; zeros otherwise).
extern "C" int extrack_refine_prof(unsigned long long* out) {
  unsigned long long zero[extrack::kProfSlots] = {};
  cudaError_t err =
      cudaMemcpyFromSymbol(out, extrack::g_refine_prof, sizeof zero);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(extrack::g_refine_prof, zero, sizeof zero);
  return (int)err;
}

// Dynamic shared memory one K6 block may opt in to on `device` (as
// extrack_predict_smem; K6 keeps nothing in static shared memory).
extern "C" int extrack_refine_smem(int device) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, extrack::refine_kernel<3, 1024>);
  if (err != cudaSuccess) return -(int)err;
  return optin - (int)attr.sharedSizeBytes;
}

// K6's block for a launch (refine_layout; wide: 1 the tiled wide
// mapping, 2 the same with the scan's publish areas in global scratch, K
// <= 16384, rows the pair kernel's prefix rows a block): out = threads,
// shared bytes besides the stash (wide: the scan kernel's), stash bytes a
// track (wide: the track's carry, wide_carry).
extern "C" int extrack_refine_layout(int T, int D, int K, int S, int wide,
                                     int rows, long long* out) {
  if (S < 1 || K % S || wide < 0 || wide > 2 ||
      (wide && (K > extrack::kRefineWideMaxK || rows < 1)))
    return (int)cudaErrorInvalidValue;
  return extrack::write_layout(extrack::refine_layout(T, D, K, S, wide, rows),
                               D, out);
}

// Inputs: xs, l2 (B, T, D) positions and localization variances, lengths
// (B,), and the (K,) tables of ops/refine_kernel.build_refine_tables, K =
// S^W: lp0f/ltf (initial weight, transition into the newest state) for the
// prefix scan, lp0r/ltr the same on the transposed transitions for the
// suffix scan, sig2v the displacement variance of the newest step.
// Outputs mu, sig (B, T, D), every entry written (zeros past each track's
// length).  A thread a slot (K <= 1024): stash_scratch null to keep the
// suffix stash in shared memory, or nblk times the stash bytes of
// extrack_refine_layout in global scratch; blocks are persistent over
// nblk.  Returns cudaGetLastError().
extern "C" int extrack_refine(const float* xs, const float* l2,
                              const int* lengths, const float* lp0f,
                              const float* ltf, const float* lp0r,
                              const float* ltr, const float* sig2v,
                              float* mu, float* sig, float* stash_scratch,
                              int B, int T, int D, int K, int S, int nblk,
                              void* stream) {
  if (S < 1 || K % S || K > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return extrack::launch_refine<1>(xs, l2, lengths, lp0f, ltf, lp0r, ltr,
                                       sig2v, mu, sig, stash_scratch, B, T,
                                       K, S, nblk, st);
    case 2:
      return extrack::launch_refine<2>(xs, l2, lengths, lp0f, ltf, lp0r, ltr,
                                       sig2v, mu, sig, stash_scratch, B, T,
                                       K, S, nblk, st);
    case 3:
      return extrack::launch_refine<3>(xs, l2, lengths, lp0f, ltf, lp0r, ltr,
                                       sig2v, mu, sig, stash_scratch, B, T,
                                       K, S, nblk, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tiled wide mapping (1024 < K <= 16384) on one chunk of B tracks:
// inputs and outputs as extrack_refine's; scratch their carries (B times
// the carry bytes of extrack_refine_layout, required), wide 1 or 2 (the
// scan's publish areas in shared memory or in the carry), NT (a multiple
// of 32, at most 256) the pair kernel's threads.  Returns
// cudaGetLastError().
extern "C" int extrack_refine_wide(const float* xs, const float* l2,
                                   const int* lengths, const float* lp0f,
                                   const float* ltf, const float* lp0r,
                                   const float* ltr, const float* sig2v,
                                   float* mu, float* sig, float* scratch,
                                   int B, int T, int D, int K, int S,
                                   int wide, int NT, void* stream) {
  if (S < 1 || K % S || wide < 1 || wide > 2 || scratch == nullptr ||
      NT < 32 || NT > extrack::kPairThreads || NT % 32 ||
      K > extrack::kRefineWideMaxK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return extrack::launch_wide<1>(xs, l2, lengths, lp0f, ltf, lp0r, ltr,
                                     sig2v, mu, sig, scratch, B, T, K, S,
                                     wide, NT, st);
    case 2:
      return extrack::launch_wide<2>(xs, l2, lengths, lp0f, ltf, lp0r, ltr,
                                     sig2v, mu, sig, scratch, B, T, K, S,
                                     wide, NT, st);
    case 3:
      return extrack::launch_wide<3>(xs, l2, lengths, lp0f, ltf, lp0r, ltr,
                                     sig2v, mu, sig, scratch, B, T, K, S,
                                     wide, NT, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
