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
// Past 1024 slots (up to 4096; refine_wide_kernel, 1024 threads) both
// scans give a thread whole fusion groups, as K1's wide walk (walk.cuh):
// member c = g*S + o of group g is child c / G of group c % G of the last
// fusion (G = K/S), so its carry is that group's fused Gaussian from
// shared memory plus its transition and variance, and a step writes the
// member's form, mixes the group's S updates in registers and publishes G
// fused Gaussians ((2D+1) floats each).  The pair loop's units (state
// block, row group, column range; PairShape<1024>) are dealt to the
// threads in turn.  The two prefix-form frames go with the stash (at K =
// 4096, D = 3 they alone take 262,144 bytes): in shared memory when both
// fit, else in global scratch.
//
// Past 4096 slots (up to 16384: refinement at the reference's frame_len 7
// at 4 states, 6 at 5 states, 8 at 3 states, 5 at 6 states) the same
// kernel runs while its publish areas and ring fit what a block may opt
// in to, the forms in global scratch; where they do not (4^7 at D = 3:
// 2 * 7 * 4096 floats of publish areas and the ring, 262,144 bytes; 2^14
// from D = 2) refine_wide_global_kernel keeps the publish areas after the
// forms in the block's global scratch and the ring in static shared
// memory.  Both scans then give a thread up to 8 fusion groups (2^14 at 2
// states), and the pair loop, S*(K/S)^2 pairs a position (67.1 M at 4^7),
// bounds it as below 4096 slots.
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

constexpr int kRefineWideThreads = 1024;
constexpr int kRefineWideMaxK = 16384;

// Both scans and the pair loop of one block on the wide mapping.  `forms`:
// two frames of prefix forms, then the suffix stash (shared memory or
// global scratch: the kernel calls this at two sites).
template <int D>
static __device__ __forceinline__ void refine_wide_tracks(
    const float* __restrict__ xs, const float* __restrict__ l2s,
    const int* __restrict__ lengths, const float* __restrict__ lp0f,
    const float* __restrict__ ltf, const float* __restrict__ lp0r,
    const float* __restrict__ ltr, const float* __restrict__ sig2v, int B,
    int T, int K, int S, float* __restrict__ mu_out,
    float* __restrict__ sig_out, float* pubs, float* ring, float* forms) {
  constexpr int F = 2 + 2 * D;                  // a warp partial's floats
  constexpr int FG = 2 * D + 1;                 // a fused group's floats
  const int tid = threadIdx.x, nt = blockDim.x, nwarp = nt >> 5;
  const int KS = K / S, G = KS;                 // groups: A = S members
  const int KP = pad4(K);
  const int FS = form_floats(D) * KP;           // floats per frame of forms
  constexpr int R = PairShape<kRefineWideThreads>::R;
  constexpr int J = PairShape<kRefineWideThreads>::J;
  const int NR = (KS + R - 1) / R;              // row groups per block
  const int TB = NR * R;                        // units per state block
  const int CW = (KS + R - 1) / R;              // columns per range
  float* stash = forms + 2 * FS;
  int buf = 0;                                  // publish area in turn

  Prof pf;
  pf.start();
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
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
      continue;
    }
    __syncthreads();        // the previous track's readers are done
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
    // one scan step at frame f: every member's form into `frame` (obs: the
    // prefix side's own precision), then its update mixed into its group
    // and the groups published; the caller's barrier follows
    auto scan_step = [&](int f, int f0, const float* lp0, const float* lt,
                         float obs, float* frame, const float* kn) {
      const float* xf = x + f * D;
      const float* l2f = l2 + f * D;
      float* pub = pubs + buf * FG * G;
      buf ^= 1;
      for (int g = tid; g < G; g += nt) {
        float gmx = kNegBig, gsw = 0.f, mf[D], tf[D];
#pragma unroll
        for (int d = 0; d < D; ++d) mf[d] = tf[d] = 0.f;
        for (int o = 0; o < S; ++o) {
          const int c = g * S + o;
          float m[D], s2[D], lp;
          carry(c, f0, lp0, lt, m, s2, lp);
          float fb, fP[D], fN[D];
          make_form<D>(m, s2, lp, xf, l2f, kn, obs, fb, fP, fN);
          store_form<D>(frame, KP, c, fb, fP, fN);
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
      return pub;
    };
    // one side alone at frame f (a track end): the thread's slots' shares
    auto end_sides = [&](int f, int f0, const float* lp0, const float* lt,
                         float& mx, float* acc) {
      mx = kNegBig;
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
    };
    // ---- suffix scan from frame L-1 down, stashing frames L-2 .. 1 -----
    float kn[D];
    for (int f = L - 2; f >= 1; --f) {
      scale_n<D>(l2 + f * D, kn);
      prev = scan_step(f, L - 1, lp0r, ltr, 0.f,
                       stash + (size_t)(f - 1) * FS, kn);
      pf.mark(kRfSuffix);
      __syncthreads();
    }
    // ---- position 0: the suffix side alone ----------------------------
    float acc[1 + 2 * D], mx;
    end_sides(0, L - 1, lp0r, ltr, mx, acc);
    partials<D>(mx, acc, ring);
    int done = 0;                                // positions written out
    pf.mark(kRfFinish);
    // ---- prefix scan with the combine ---------------------------------
    prev = nullptr;
    for (int t = 1; t < L - 1; ++t) {
      const float* l2t = l2 + t * D;
      float* pform = forms + (t & 1) * FS;
      scale_n<D>(l2t, kn);
      const float* pub = scan_step(t, 0, lp0f, ltf, 1.f, pform, kn);
      pf.mark(kRfForms);
      __syncthreads();
      pf.mark(kRfPrefix);
      prev = pub;
      if (t - done == kRing / 2) {               // half the ring is full
        flush<D>(ring, nwarp, done, t, x, mu, sig);
        done = t;
      }
      mx = kNegBig;
#pragma unroll
      for (int q = 0; q < 1 + 2 * D; ++q) acc[q] = 0.f;
      const float* sform = stash + (size_t)(t - 1) * FS;
      for (int u = tid; u < S * TB; u += nt) {
        const int blk = (u / TB) * KS;
        const int gr = (u % TB) % NR, h = (u % TB) / NR;
        const int c0 = min(h * CW, KS), c1 = min(c0 + CW, KS);
        pair_loop<D, R, J>(pform, sform, KP, blk, KS, gr * R, c0, c1, mx,
                           acc);
      }
      pf.mark(kRfPairs);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        acc[1 + d] *= l2t[d] * rcp(kn[d]);
        acc[1 + D + d] *= l2t[d];
      }
      partials<D>(mx, acc, ring + (t % kRing) * nwarp * F);
      pf.mark(kRfFinish);
    }
    // ---- position L-1: the prefix side alone --------------------------
    end_sides(L - 1, 0, lp0f, ltf, mx, acc);
    partials<D>(mx, acc, ring + ((L - 1) % kRing) * nwarp * F);
    __syncthreads();
    flush<D>(ring, nwarp, done, L, x, mu, sig);
    pf.mark(kRfFinish);
  }
  pf.flush(g_refine_prof, threadIdx.x == 0);
}

template <int D>
__global__ void __launch_bounds__(kRefineWideThreads, 1)
    refine_wide_kernel(const float* __restrict__ xs,
                       const float* __restrict__ l2s,
                       const int* __restrict__ lengths,
                       const float* __restrict__ lp0f,
                       const float* __restrict__ ltf,
                       const float* __restrict__ lp0r,
                       const float* __restrict__ ltr,
                       const float* __restrict__ sig2v, int B, int T, int K,
                       int S, float* __restrict__ mu_out,
                       float* __restrict__ sig_out,
                       float* __restrict__ forms_scratch) {
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  // shared memory: the forms (two prefix frames, then the stash) unless
  // they are in global scratch, two publish areas of (2D+1)*G floats, the
  // ring of partials
  const size_t nforms = T > 2 ? (size_t)T * form_floats(D) * pad4(K) : 0;
  float* pubs = sh + (forms_scratch != nullptr ? 0 : nforms);
  float* ring = pubs + 2 * (2 * D + 1) * (K / S);
  if (forms_scratch == nullptr)
    refine_wide_tracks<D>(xs, l2s, lengths, lp0f, ltf, lp0r, ltr, sig2v, B,
                          T, K, S, mu_out, sig_out, pubs, ring, sh);
  else
    refine_wide_tracks<D>(xs, l2s, lengths, lp0f, ltf, lp0r, ltr, sig2v, B,
                          T, K, S, mu_out, sig_out, pubs, ring,
                          forms_scratch + (size_t)blockIdx.x * nforms);
}

// The wide mapping with its publish areas in global scratch too, after
// the block's forms (refine_layout at wide = 2), and the ring of partials
// in static shared memory.
template <int D>
__global__ void __launch_bounds__(kRefineWideThreads, 1)
    refine_wide_global_kernel(const float* __restrict__ xs,
                              const float* __restrict__ l2s,
                              const int* __restrict__ lengths,
                              const float* __restrict__ lp0f,
                              const float* __restrict__ ltf,
                              const float* __restrict__ lp0r,
                              const float* __restrict__ ltr,
                              const float* __restrict__ sig2v, int B, int T,
                              int K, int S, float* __restrict__ mu_out,
                              float* __restrict__ sig_out, float* scratch) {
  __shared__ float4 ring4[kRing * (kRefineWideThreads / 32) * (2 + 2 * D) /
                          4];
  const size_t nforms = T > 2 ? (size_t)T * form_floats(D) * pad4(K) : 0;
  float* forms = scratch + (size_t)blockIdx.x *
                               (nforms + pad4(2 * (2 * D + 1) * (K / S)));
  refine_wide_tracks<D>(xs, l2s, lengths, lp0f, ltf, lp0r, ltr, sig2v, B, T,
                        K, S, mu_out, sig_out, forms + nforms,
                        reinterpret_cast<float*>(ring4), forms);
}

// K6's block for T frames, D dimensions, K slots at S states.  Threads: one
// per slot, and enough for the pair loop's S * ceil(K/S / R) * R threads.
// Shared memory besides the stash: two frames of prefix forms, two fusion
// publish areas of (2+2D)*K floats, and the ring of kRing positions' warp
// partials ((2+2D) floats per warp).  Carry: the suffix stash, a frame of
// forms for each interior position 1 .. T-2.  The wide mapping: 1024
// threads; shared memory besides the forms two publish areas of (2D+1)*K/S
// floats and the ring; carry: the two prefix frames and the stash, T frames
// of forms (none for T = 2, which has no interior position).  wide = 2:
// the publish areas (padded to a multiple of 4 floats) after the forms in
// the carry, the ring in static shared memory, no dynamic shared memory.
static BlockLayout refine_layout(int T, int D, int K, int S, int wide) {
  if (wide) {
    const size_t FS = (size_t)form_floats(D) * pad4(K);
    const size_t forms = (T > 2 ? (size_t)T * FS : 0) * sizeof(float);
    const size_t pubs = (size_t)2 * (2 * D + 1) * (K / S);
    if (wide == 2)
      return {kRefineWideThreads, 0, forms + pad4(pubs) * sizeof(float)};
    const size_t fixed = pubs + (size_t)kRing * (kRefineWideThreads / 32) *
                                    (2 + 2 * D);
    return {kRefineWideThreads, fixed * sizeof(float), forms};
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
                         int nblk, int wide, cudaStream_t stream) {
  const BlockLayout lay = refine_layout(T, D, K, S, wide);
  const int threads = lay.threads;
  const size_t smem = lay.fixed + (stash_scratch != nullptr ? 0 : lay.carry);
  if (wide == 2) {
    if (B > 0)
      refine_wide_global_kernel<D><<<nblk, threads, 0, stream>>>(
          xs, l2, lengths, lp0f, ltf, lp0r, ltr, sig2v, B, T, K, S, mu, sig,
          stash_scratch);
    return (int)cudaGetLastError();
  }
  if (wide) {
    cudaFuncSetAttribute(refine_wide_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    if (B > 0)
      refine_wide_kernel<D><<<nblk, threads, smem, stream>>>(
          xs, l2, lengths, lp0f, ltf, lp0r, ltr, sig2v, B, T, K, S, mu, sig,
          stash_scratch);
    return (int)cudaGetLastError();
  }
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

// K6's block for a launch (refine_layout; wide: 1 the wide mapping, 2 the
// same with its publish areas in global scratch, K <= 16384): out =
// threads, shared bytes besides the stash (wide: besides the forms), stash
// (forms; at 2 forms and publish areas) bytes per track.
extern "C" int extrack_refine_layout(int T, int D, int K, int S, int wide,
                                     long long* out) {
  if (S < 1 || K % S || wide < 0 || wide > 2 ||
      (wide && K > extrack::kRefineWideMaxK))
    return (int)cudaErrorInvalidValue;
  return extrack::write_layout(extrack::refine_layout(T, D, K, S, wide), D,
                               out);
}

// Inputs: xs, l2 (B, T, D) positions and localization variances, lengths
// (B,), and the (K,) tables of ops/refine_kernel.build_refine_tables, K =
// S^W: lp0f/ltf (initial weight, transition into the newest state) for the
// prefix scan, lp0r/ltr the same on the transposed transitions for the
// suffix scan, sig2v the displacement variance of the newest step.
// Outputs mu, sig (B, T, D), every entry written (zeros past each track's
// length).  stash_scratch: null to keep the suffix stash in shared memory,
// or nblk times the stash bytes of extrack_refine_layout in global
// scratch (wide: the forms, both prefix frames and the stash; wide = 2:
// and the publish areas, scratch required).  wide: 1 the wide mapping, 2
// the same with its publish areas in global scratch (K <= 16384), else a
// thread per slot (K <= 1024).  Blocks are persistent over nblk.  Returns
// cudaGetLastError().
extern "C" int extrack_refine(const float* xs, const float* l2,
                              const int* lengths, const float* lp0f,
                              const float* ltf, const float* lp0r,
                              const float* ltr, const float* sig2v,
                              float* mu, float* sig, float* stash_scratch,
                              int B, int T, int D, int K, int S, int nblk,
                              int wide, void* stream) {
  if (S < 1 || K % S || wide < 0 || wide > 2 ||
      (wide == 2 && stash_scratch == nullptr) ||
      K > (wide ? extrack::kRefineWideMaxK : 1024))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return extrack::launch_refine<1>(xs, l2, lengths, lp0f, ltf, lp0r, ltr,
                                       sig2v, mu, sig, stash_scratch, B, T,
                                       K, S, nblk, wide, st);
    case 2:
      return extrack::launch_refine<2>(xs, l2, lengths, lp0f, ltf, lp0r, ltr,
                                       sig2v, mu, sig, stash_scratch, B, T,
                                       K, S, nblk, wide, st);
    case 3:
      return extrack::launch_refine<3>(xs, l2, lengths, lp0f, ltf, lp0r, ltr,
                                       sig2v, mu, sig, stash_scratch, B, T,
                                       K, S, nblk, wide, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
