// The walk of K1 (forward.cu: per-track log likelihood) and K4
// (predict.cu: the same plus per-frame state posteriors), one template for
// both (PRED), on two mappings of a track onto threads:
//
// * warp mapping, K <= 64 (walk_warp_kernel): one warp walks one track;
//   lane l owns slots l and, when J = 2, l + 32.  Blocks of up to four
//   warps are persistent over the tracks, and each warp copies the next
//   track's rows into its slice of shared memory by cp.async while it
//   walks the current one.  A fusion step's exchange goes through the
//   warp's slice between __syncwarp()s, and every reduction over the slots
//   is a warp shuffle: the walk has no block barrier.
// * block mapping, 64 < K <= 1024, K4 only (walk_block_kernel): one
//   persistent block walks one track at a time, thread k owning slot k,
//   with one barrier per fusion step.
// * wide mapping, 1024 < K <= 65536, and K1 from 65 slots on (it ran
//   1.14-1.75x faster than the block mapping at every K1 register of
//   81..1024 slots measured) (walk_wide_kernel, below): one persistent
//   block a track, a thread owning whole fusion groups; the carries live
//   in shared memory as the G = K/A fused Gaussians, or, where they pass
//   what a block may opt in to, in the block's global scratch
//   (walk_wide_global_kernel for K4, forward_wide_global_kernel for K1).
//
// The warp and block mappings keep each slot's (K,) tables in registers
// for the whole launch; all three fuse in base 2 on the special-function
// unit (common.cuh's update2 / group2: ex2, lg2, rcp, rsqrt), double-buffer
// the publish area (one barrier per step), and close in one pass: an
// online log-sum-exp in base 2 that rescales its sum on a new maximum, so
// each look-ahead child is evaluated once.
//
// K4's posteriors.  The plain engine carries, per slot, a history of
// posteriors over the frames that left the window and mixes it at every
// fusion (work quadratic in T).  The kernel carries none: at each fusion
// step that drops a frame it stashes the step's fusion weights, K floats
// (member o of group g's weight w_{g,o}, written by g's child o; every
// child of g holds all of them), and at the track's last frame it carries
// the register's softmax back through them, linear in T: group g's mass is
// the sum of its children's, member c = g*A + o of the step's register
// gets mass_g * w_{g,o} (written over the stash row in place), and the
// dropped frame's posterior of state o is the sum of those over the groups
// (A = S: a member's oldest digit is that frame's state).  The stash is
// (T-W) rows of K floats (only frames 0 .. T-W-1 can leave the window
// before a track ends), each padded to an odd count so that a lane per
// output reading down its row hits every bank once; it lives in the
// team's shared memory when that costs no resident tracks
// (ops/forward_kernel.plan), else in global scratch, and the walk is
// called at two sites so that each compiles to its own loads.  The frames
// still in the window are sums of the softmax weights of the slots whose
// digit matches (digits from a per-slot code): a reduce-scatter over the
// lanes in the warp mapping, warp partials in the block mapping.
//
// Variable dt (VDT): the displacement variances come per track and step
// from a (B, T-1, P) stream (P = S^(n+1) patterns of the n+1 newest
// sub-states; row t holds step t -> t+1) in place of the (K,) and (K, A)
// tables.  The walk reads the track's row of step t where the constant
// path reads its tables: slot k's initial variance at row 0, pattern
// k / (K/P); a fusion's child k at row t, the same pattern; the
// look-ahead child (k, a) at row t, pattern a*S + (k's newest digit).
// The warp mapping prefetches the track's (T-1)*P floats into its slice
// of shared memory with its positions; the block mapping reads them from
// global memory, as it does its positions.  The choice is a template
// flag, so the constant-dt instantiations keep their code.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace extrack {

// Sections of K1's and K4's cycle split (tools/walk_profile.py --split).
enum {
  kWkSetup = 0, kWkStep = 1, kWkClose = 2, kWkMix = 3, kWkHarvest = 4,
  kWkBarrier = 5
};

constexpr int kWalkWarpBlock = 128;    // the warp mapping's block: 4 warps

// Blocks per SM each instantiation is compiled for (__launch_bounds__'
// second argument): up to 80 registers with one slot a lane (24 warps an
// SM) and 128 with two, none spilling.  Measured on an H100, caps from 64
// to 102 registers moved the bench shape by less than the spread between
// runs.
template <int J>
constexpr int walk_warp_min_blocks() {
  return J == 1 ? 6 : 4;
}
template <int NT>
constexpr int walk_block_min_blocks() {
  return 65536 / (NT * 80) > 1 ? 65536 / (NT * 80) : 1;
}

// Slot k's (K,) tables, loaded once per launch.
struct SlotTabs {
  float lp0, s20, lt, lsurv, endv, sig2v;
};

static __device__ __forceinline__ SlotTabs load_slot(const Tables& tb, int k,
                                                     bool act) {
  if (!act) return {0.f, 1.f, 0.f, 0.f, 0.f, 0.f};
  return {tb.lp0[k], tb.s20[k], tb.lt[k], tb.lsurv[k], tb.endv[k],
          tb.sig2v[k]};
}

// Online log-sum-exp in base 2: (mx, s) stands for s * 2^mx.  Adding a
// term r * 2^g rescales s only when g is a new maximum.  mx starts at
// kNegBig (not -inf, so that an empty sum rescales to an empty sum).
static __device__ __forceinline__ void lse2_add(float& mx, float& s, float g,
                                                float r) {
  if (g > mx) {
    s = fmaf(s, ex2(mx - g), r);
    mx = g;
  } else {
    s = fmaf(r, ex2(g - mx), s);
  }
}

// The warp's (mx, s) in every lane: the lanes' largest mx, each lane's
// sum rescaled to it once, then summed.
static __device__ __forceinline__ void warp_lse2(float& mx, float& s) {
  const float m = warp_max(mx);
  s = warp_sum(s * ex2(mx - m));
  mx = m;
}

// The block's (mx, s) in every thread: warps' partials through `red`
// (2 floats a warp), combined in warp order.  The caller keeps `red` from
// being reused before every thread has read it.
static __device__ __forceinline__ void block_lse2(float& mx, float& s,
                                                  float* red) {
  warp_lse2(mx, s);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) {
    red[2 * wid] = mx;
    red[2 * wid + 1] = s;
  }
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < nw; ++w) mx = fmaxf(mx, red[2 * w]);
  s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[2 * w + 1] * ex2(red[2 * w] - mx);
}

// The bytes of one team's shared memory (per warp for the warp mapping,
// per block for the block mapping), besides K4's stash, and the stash's
// bytes per team.
struct WalkLayout {
  int threads;
  size_t fixed, stash;
};

// warps > 0: the warp mapping with `warps` warps a block; 0: the block
// mapping.  Floats of a team's slice, in order: two publish areas
// ((2+2D)K each); warp mapping: two buffers of a track's (T, D) variances
// and positions, two of its (T-1, P) displacement variances (variable dt,
// P > 0), then its length and flag; block mapping: the closings' and the
// harvest's warp partials; K4: the softmax over the register (K) and the
// groups' masses (G); then K4's stash of fusion weights, when in shared
// memory.
static __host__ __device__ inline WalkLayout walk_layout(int warps, int K,
                                                         int A, int D, int T,
                                                         int S, int W,
                                                         bool pred, int P) {
  const int G = K / A;
  size_t fixed = (size_t)2 * (2 + 2 * D) * K;
  if (warps > 0)
    fixed += (size_t)4 * T * D + (size_t)2 * (T - 1) * P + 4;
  else
    fixed += 4 * 32 + (pred ? (size_t)W * S * 32 : 0);
  if (pred) fixed += K + G;
  const size_t stash = pred && T > W ? (size_t)(T - W) * (K | 1) : 0;
  return {warps > 0 ? 32 * warps : (K + 31) / 32 * 32, fixed * 4, stash * 4};
}

// Everything a walk kernel reads and writes.
struct WalkArgs {
  Tables tb;
  const float* xs;
  const float* l2s;
  const int* lengths;
  const float* isbls;
  int B, T, S, W;
  float* logl;
  float* preds;           // K4: (B, T, S)
  float* stash_all;       // global scratch (K4's stash, carries in the
                          // wide global walks), or null
  int stash_smem;         // K4: the stash in the team's shared memory
  const float* sig2s;     // variable dt: (B, T-1, P) displacement variances
  int P;                  // their patterns, S^(n+1); 0: constant dt
};

// Index math of one slot of a team.
struct Slot {
  int k;                  // slot
  bool act;               // k < K
  int m0;                 // first member of k's fusion group
  int g, a;               // k's group and its child index (k = a*G + g)
  int pg;                 // the group whose member k is (k / A)
  unsigned code;          // K4: the slot's digits, oldest lowest, b bits
  unsigned hm;            // K4, warp mapping: bit i*S + s set when digit i
                          // of k is s (i*S + s < 16)
  int pat, nw;            // variable dt: k's pattern of its n+1 newest
                          // digits (k / (K/P)) and its newest digit (0 for
                          // a slot past K)
};

// One track's walk on a team (a warp for the warp mapping, BLOCK for the
// block mapping) whose J slots a thread are `sl`.  x / l2: the track's
// (T, D) rows; sg: its (T-1, P) displacement variances (VDT); stash: K4's
// stash of fusion weights; scr: K4's softmax and group masses; red: the
// block mapping's partials.  Writes logL (and K4's posterior row) for
// track b.
template <int D, int J, int AS, bool PRED, bool BLOCK, bool VDT>
static __device__ __forceinline__ void walk_track(
    const WalkArgs& wa, const SlotTabs* tab, const Slot* sl, bool one_group,
    int bits, int b, int L, float isbl, const float* x, const float* l2,
    const float* sg, float* pubs, float* scr, float* red, float* stash,
    int tid, int nteam, Prof& pf) {
  const Tables& tb = wa.tb;
  const int K = tb.K, A = AS > 0 ? AS : tb.A, G = K / A;
  const int T = wa.T, S = wa.S, W = wa.W;
  const int P = VDT ? wa.P : 0, SP = VDT ? wa.P / A : 0;   // SP: states
  const int F = 2 + 2 * D;
  const float cl2pi = 0.5f * D * kLog2Pi;
  const int ks = K | 1;                         // stash row stride
  float* pr = PRED ? wa.preds + (size_t)b * T * S : nullptr;

  auto sync = [&]() {
    if constexpr (BLOCK)
      __syncthreads();
    else
      __syncwarp();
  };
  auto lse2_team = [&](float& mx, float& s, float* r) {
    if constexpr (BLOCK)
      block_lse2(mx, s, r);
    else
      warp_lse2(mx, s);
  };

  float m[J][D], s2[J][D], lp[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    lp[j] = tab[j].lp0;
    const float s20 = VDT ? sg[sl[j].pat] : tab[j].s20;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      m[j][d] = x[d];
      s2[j][d] = l2[d] + s20;
    }
  }
  float out = 0.f;
  int pb = 0;                                   // publish area in turn
  pf.mark(kWkSetup);
  for (int t = 1;; ++t) {
    float xt[D], l2t[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xt[d] = x[t * D + d];
      l2t[d] = l2[t * D + d];
    }
    Upd<D> u[J];
#pragma unroll
    for (int j = 0; j < J; ++j) update2<D>(m[j], s2[j], xt, l2t, u[j]);
    if (t == L - 1) {
      // the register's own closing (2-frame tracks) and K4's softmax:
      // weight 2^fin * prod^-1/2 per slot; the 2 pi constants cancel in
      // the softmax and come back as cl2pi in logL
      float fin[J], r[J], mx = kNegBig, s = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        fin[j] = sl[j].act ? kLog2e * (lp[j] + isbl * tab[j].endv - u[j].quad)
                           : kNegBig;
        r[j] = sl[j].act ? rsq(u[j].prod) : 0.f;
        lse2_add(mx, s, fin[j], r[j]);
      }
      lse2_team(mx, s, red + 64);
      if (L == 2) out = (mx + lg2(s)) * kLn2 - cl2pi;
      pf.mark(kWkClose);
      if constexpr (PRED) {
        const float inv_s = rcp(s);
        const int nh = L - W;
        float p[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          p[j] = ex2(fin[j] - mx) * r[j] * inv_s;
          if (nh > 0 && sl[j].act) scr[sl[j].k] = p[j];
        }
        // frames still in the window: window position i (0 = oldest) is
        // frame nh + i and digit i of the slot code
        if constexpr (BLOCK) {
          const unsigned mask = (1u << bits) - 1u;
          for (int i = nh < 0 ? -nh : 0; i < W; ++i) {
            for (int s_ = 0; s_ < S; ++s_) {
              float v = (((sl[0].code >> (bits * i)) & mask) == s_ &&
                         sl[0].act) ? p[0] : 0.f;
              v = warp_sum(v);
              if ((tid & 31) == 0)
                red[128 + (i * S + s_) * 32 + (tid >> 5)] = v;
            }
          }
        } else {
          // the W*S <= 16 sums eight at a time: a reduce-scatter over the
          // lanes leaves the sum of output o0 + o in lanes 4o .. 4o+3
          for (int o0 = 0; o0 < W * S; o0 += 8) {
            float v[8];
#pragma unroll
            for (int o = 0; o < 8; ++o) {
              v[o] = 0.f;
#pragma unroll
              for (int j = 0; j < J; ++j)
                if ((sl[j].hm >> (o0 + o)) & 1u) v[o] += p[j];
            }
#pragma unroll
            for (int c = 4, off = 16; c >= 1; c >>= 1, off >>= 1) {
              const bool up = (tid & off) != 0;
#pragma unroll
              for (int i = 0; i < c; ++i) {
                const float send = up ? v[i] : v[i + c];
                const float keep = up ? v[i + c] : v[i];
                v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
              }
            }
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
            const int o = o0 + (tid >> 2);
            if ((tid & 3) == 0 && o < W * S && nh * S + o >= 0)
              pr[nh * S + o] = v[0];
          }
        }
        sync();   // scr, the block's partials and the last fusion's rows
        if constexpr (BLOCK) {
          const int nw = nteam >> 5;
          for (int o = tid; o < W * S; o += nteam) {
            const int i = o / S;
            if (nh + i < 0) continue;
            float v = 0.f;
            for (int w = 0; w < nw; ++w) v += red[128 + o * 32 + w];
            pr[nh * S + o] = v;
          }
        }
        // frames that left the window
        if (nh > 0) {
          float* mass = scr + K;
          // carry the slots' masses back through the stashed fusion
          // weights: the fusion that dropped frame f gave member c = g*A + o
          // of group g the mass mass_g * w_{g,o}, and frame f's posterior
          // of state o sums those over g.  Each stash row becomes those
          // masses in place, and is the next step's q.
          const float* q = scr;
          for (int f = nh - 1; f >= 0; --f) {
            sync();
            for (int g = tid; g < G; g += nteam) {
              float v = 0.f;
              for (int a = 0; a < A; ++a) v += q[a * G + g];
              mass[g] = v;
            }
            sync();
            float* row = stash + (size_t)f * ks;
#pragma unroll
            for (int j = 0; j < J; ++j)
              if (sl[j].act) row[sl[j].k] *= mass[sl[j].pg];
            q = row;
          }
          sync();
          for (int o = tid; o < nh * S; o += nteam) {
            const int f = o / S;
            const float* row = stash + (size_t)f * ks + (o - f * S);
            float v = 0.f;
            for (int g = 0; g < G; ++g) v += row[g * A];
            pr[o] = v;
          }
        }
        for (int o = L * S + tid; o < T * S; o += nteam) pr[o] = 0.f;
        pf.mark(kWkHarvest);
      }
      break;
    }
    const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;
    if (t == L - 2) {
      // look-ahead closing on the pre-fusion children, in one pass
      float xn[D], l2n[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xn[d] = x[(t + 1) * D + d];
        l2n[d] = l2[(t + 1) * D + d];
      }
      const float c2pi = D == 1 ? k2Pi : D == 2 ? k2Pi * k2Pi
                                                : k2Pi * k2Pi * k2Pi;
      float mx = kNegBig, s = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (!sl[j].act) continue;
        const float base = lp[j] - u[j].quad;
        const float rq = rsq(u[j].prod);
        const int kA = sl[j].k * A;
        for (int a = 0; a < A; ++a) {
          float prod_n = c2pi, quad_n = 0.f;
          const float s2n = VDT ? sg[t * P + a * SP + sl[j].nw]
                                : __ldg(tb.s2n + kA + a);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float totn = s2n + u[j].tl[d] + l2n[d];
            const float df = xn[d] - u[j].nm[d];
            prod_n *= totn;
            quad_n = fmaf(0.5f * df * df, rcp(totn), quad_n);
          }
          const float c = __ldg(tb.ltn + kA + a) +
                          gate * __ldg(tb.lsn + kA + a) +
                          isbl * __ldg(tb.endn + kA + a);
          lse2_add(mx, s, kLog2e * (base + c - quad_n), rq * rsq(prod_n));
        }
      }
      lse2_team(mx, s, red);
      out = (mx + lg2(s)) * kLn2 - cl2pi;
      pf.mark(kWkClose);
      if constexpr (!PRED) break;
    }
    // fusion: publish, then each child gathers its group's members
    float* pub = pubs + pb * F * K;
    pb ^= 1;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (sl[j].act) publish_upd<D>(sl[j].k, lp[j], u[j], pub, K);
    pf.mark(kWkStep);
    sync();
    pf.mark(kWkBarrier);
    // the lane's second child reuses the first one's group sums when both
    // are in one group (K = 64 at A = 2, 4, 8)
    float w[J][AS > 0 ? AS : 1], gmx[J], ginv[J];
    float mf[D], tf[D], lse = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (!sl[j].act) continue;
      if (j == 0 || !one_group)
        group2<D, AS>(pub, K, sl[j].m0, A, gmx[j], ginv[j], lse, mf, tf,
                      w[j]);
      else {
        gmx[j] = gmx[0];
        ginv[j] = ginv[0];
#pragma unroll
        for (int o = 0; o < (AS > 0 ? AS : 1); ++o) w[j][o] = w[0][o];
      }
      // the child's variance of step t -> t+1 (t <= L-2 <= T-2 here)
      const float sv = VDT ? sg[t * P + sl[j].pat] : tab[j].sig2v;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        m[j][d] = mf[d];
        s2[j][d] = sv + tf[d];
      }
      lp[j] = lse + tab[j].lt + gate * tab[j].lsurv;
    }
    pf.mark(kWkStep);
    if constexpr (PRED) {
      const int fd = t + 1 - W;               // the frame this step drops
      if (fd >= 0) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!sl[j].act) continue;
          const int g = sl[j].g, a = sl[j].a;
          auto wt = [&](int o) {
            if constexpr (AS > 0) {
              float v = w[j][0];
#pragma unroll
              for (int i = 1; i < AS; ++i)
                if (i == o) v = w[j][i];
              return v;
            } else {
              return ex2(pub[sl[j].m0 + o] - gmx[j]) * pub[K + sl[j].m0 + o] *
                     ginv[j];
            }
          };
          // stash the fusion weight of member g*A + a (child a of group g
          // writes it) for the harvest's backward pass
          stash[(size_t)fd * ks + g * A + a] = wt(a);
        }
      }
      pf.mark(kWkMix);
    }
  }
  if (tid == 0) wa.logl[b] = out;
}

// A thread's J slots and, for K4, their digit codes; `bits` per digit.
template <int J>
static __device__ __forceinline__ void slots_of(const Tables& tb, int S,
                                                int W, int P, int first,
                                                int step, Slot* sl,
                                                SlotTabs* tab, int& bits) {
  const int K = tb.K, G = K / tb.A;
  bits = 32 - __clz(max(S - 1, 1));
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = first + j * step;
    sl[j].k = k;
    sl[j].act = k < K;
    sl[j].m0 = (k % G) * tb.A;
    sl[j].g = k % G;
    sl[j].a = k / G;
    sl[j].pg = k / tb.A;
    unsigned code = 0, hm = 0;
    for (int i = 0, q = k; i < W; ++i, q /= S) {
      code |= (unsigned)(q % S) << (bits * i);
      if (i * S + q % S < 16) hm |= 1u << (i * S + q % S);
    }
    sl[j].code = code;
    sl[j].hm = sl[j].act ? hm : 0u;
    sl[j].pat = P > 0 && sl[j].act ? k / (K / P) : 0;
    sl[j].nw = P > 0 && sl[j].act ? k / (K * tb.A / P) : 0;
    tab[j] = load_slot(tb, k, sl[j].act);
  }
}

// The warp mapping's track loop; `stash` is the warp's stash (shared or
// global memory: the kernel calls this at two sites).
template <int D, int J, int AS, bool PRED, bool VDT>
static __device__ __forceinline__ void warp_tracks(const WalkArgs& wa,
                                                   float* ws, float* stash,
                                                   unsigned long long* prof) {
  const Tables& tb = wa.tb;
  const int K = tb.K, T = wa.T, B = wa.B;
  const int lane = threadIdx.x & 31, wpb = blockDim.x >> 5;
  const int gw = blockIdx.x * wpb + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * wpb;
  const int TD = T * D;
  const int SG = VDT ? (T - 1) * wa.P : 0;   // a track's streamed floats
  float* pubs = ws;
  float* rows = ws + 2 * (2 + 2 * D) * K;     // two (l2, x) buffers
  float* sgb = rows + 4 * TD;                 // two (T-1, P) buffers (VDT)
  int* meta = reinterpret_cast<int*>(sgb + 2 * SG);
  float* scr = sgb + 2 * SG + 4;
  Slot sl[J];
  SlotTabs tab[J];
  int bits;
  slots_of<J>(tb, wa.S, wa.W, VDT ? wa.P : 0, lane, 32, sl, tab, bits);
  const int G = K / tb.A;
  const bool one_group = J == 2 && 32 % G == 0;
  Prof pf;
  pf.start();

  // track bb's rows, length and flag into buffer `buf`, asynchronously
  auto fetch = [&](int bb, int buf) {
    float* l2d = rows + buf * 2 * TD;
    float* xd = l2d + TD;
    for (int i = lane; i < TD; i += 32) {
      __pipeline_memcpy_async(l2d + i, wa.l2s + (size_t)bb * TD + i, 4);
      __pipeline_memcpy_async(xd + i, wa.xs + (size_t)bb * TD + i, 4);
    }
    if constexpr (VDT) {
      float* sgd = sgb + buf * SG;
      for (int i = lane; i < SG; i += 32)
        __pipeline_memcpy_async(sgd + i, wa.sig2s + (size_t)bb * SG + i, 4);
    }
    if (lane == 0) {
      __pipeline_memcpy_async(meta + 2 * buf, wa.lengths + bb, 4);
      __pipeline_memcpy_async(meta + 2 * buf + 1, wa.isbls + bb, 4);
    }
    __pipeline_commit();
  };
  if (gw < B) fetch(gw, 0);
  int buf = 0;
  for (int b = gw; b < B; b += nwarps, buf ^= 1) {
    __pipeline_wait_prior(0);
    __syncwarp();           // this track's rows landed; the last one's read
    const float* l2 = rows + buf * 2 * TD;
    const float* x = l2 + TD;
    const int L = min(meta[2 * buf], T);
    const float isbl = __int_as_float(meta[2 * buf + 1]);
    if (b + nwarps < B) fetch(b + nwarps, buf ^ 1);
    if (L < 2) {            // empty / 1-frame rows: logL 0, posteriors 0
      if (lane == 0) wa.logl[b] = 0.f;
      if constexpr (PRED)
        for (int o = lane; o < T * wa.S; o += 32)
          wa.preds[(size_t)b * T * wa.S + o] = 0.f;
      continue;
    }
    walk_track<D, J, AS, PRED, false, VDT>(
        wa, tab, sl, one_group, bits, b, L, isbl, x, l2,
        VDT ? sgb + buf * SG : nullptr, pubs, scr, nullptr, stash, lane, 32,
        pf);
  }
  pf.flush(prof, lane == 0);
}

template <int D, int J, int AS, bool PRED, bool VDT>
__global__ void __launch_bounds__(kWalkWarpBlock, walk_warp_min_blocks<J>())
    walk_warp_kernel(WalkArgs wa, unsigned long long* prof) {
  extern __shared__ __align__(16) float smem[];
  const WalkLayout lay = walk_layout(blockDim.x >> 5, wa.tb.K, wa.tb.A, D,
                                     wa.T, wa.S, wa.W, PRED, VDT ? wa.P : 0);
  const int wib = threadIdx.x >> 5;
  const size_t fixed = lay.fixed / 4, stash = lay.stash / 4;
  if (wa.stash_smem) {
    float* ws = smem + wib * (fixed + stash);
    warp_tracks<D, J, AS, PRED, VDT>(wa, ws, ws + fixed, prof);
  } else {
    const int gw = blockIdx.x * (blockDim.x >> 5) + wib;
    warp_tracks<D, J, AS, PRED, VDT>(wa, smem + wib * fixed,
                                     wa.stash_all + (size_t)gw * stash, prof);
  }
}

// The block mapping's track loop (the kernel calls it at two sites).
template <int D, bool PRED, bool VDT>
static __device__ __forceinline__ void block_tracks(const WalkArgs& wa,
                                                    float* sh, float* stash,
                                                    unsigned long long* prof) {
  const Tables& tb = wa.tb;
  const int K = tb.K, T = wa.T;
  const int k = threadIdx.x;
  float* pubs = sh;
  float* red = sh + 2 * (2 + 2 * D) * K;
  float* scr = red + 128 + (PRED ? wa.W * wa.S * 32 : 0);
  Slot sl[1];
  SlotTabs tab[1];
  int bits;
  slots_of<1>(tb, wa.S, wa.W, VDT ? wa.P : 0, k, 0, sl, tab, bits);
  Prof pf;
  pf.start();
  for (int b = blockIdx.x; b < wa.B; b += gridDim.x) {
    __syncthreads();        // the last track's partials, softmax and rows
    const int L = min(wa.lengths[b], T);
    if (L < 2) {
      if (k == 0) wa.logl[b] = 0.f;
      if constexpr (PRED)
        for (int o = k; o < T * wa.S; o += blockDim.x)
          wa.preds[(size_t)b * T * wa.S + o] = 0.f;
      continue;
    }
    walk_track<D, 1, 0, PRED, true, VDT>(
        wa, tab, sl, false, bits, b, L, wa.isbls[b],
        wa.xs + (size_t)b * T * D, wa.l2s + (size_t)b * T * D,
        VDT ? wa.sig2s + (size_t)b * (T - 1) * wa.P : nullptr, pubs, scr,
        red, stash, k, blockDim.x, pf);
  }
  pf.flush(prof, k == 0);
}

template <int D, int NT, bool PRED, bool VDT>
__global__ void __launch_bounds__(NT, walk_block_min_blocks<NT>())
    walk_block_kernel(WalkArgs wa, unsigned long long* prof) {
  extern __shared__ __align__(16) float smem[];
  const WalkLayout lay = walk_layout(0, wa.tb.K, wa.tb.A, D, wa.T, wa.S,
                                     wa.W, PRED, 0);
  if (wa.stash_smem)
    block_tracks<D, PRED, VDT>(wa, smem, smem + lay.fixed / 4, prof);
  else
    block_tracks<D, PRED, VDT>(
        wa, smem, wa.stash_all + (size_t)blockIdx.x * (lay.stash / 4), prof);
}

// ---- the wide mapping: 1024 < K <= 65536 slots ------------------------
//
// One slot a thread stops at 1024 slots, and the per-slot (K,) and (K, A)
// tables in registers stop well before: at K = 4096 and D = 3 a track's
// carries alone are 7 floats a slot.  The wide mapping keeps no slot in
// registers between steps.  A thread owns whole fusion groups g = tid,
// tid + blockDim.x, ... (G = K/A of them): group g's members are slots
// g*A .. g*A+A-1, and member c is child c / G of group c % G of the last
// fusion, so its carry is that group's fused Gaussian (mean and tail per
// dimension, log mass), published to shared memory at the last step, plus
// its own child terms (lt, lsurv and the displacement variance, read from
// the tables through L1; VDT: from the stream).  A step reads each of the
// thread's members' groups, updates the member against the frame and
// mixes the group's A updates in registers, an online log-sum-exp in base
// 2 that rescales its sums on a new maximum; it publishes G fused
// Gaussians, (2D+1) floats each, in place of K updates ((2+2D) floats
// each), double-buffered, so a step costs one barrier.  At K = 4096 and
// D = 3 the two publish areas take 114,688 bytes at 2 states (G = 2048)
// and 57,344 at 4 (the per-slot publish of the block mapping would take
// 262,144, more than a block may opt in to).  Closings and K4's harvest
// are block reductions over the thread's partial sums; K4's stash of
// fusion weights holds each member's log2 weight until its group's sum is
// known, then the weight.
//
// Past what a block may opt in to (K4 at K = 16384 and D = 3 asks for
// 299,008 bytes at 4 states, 528,384 at 2), walk_wide_global_kernel runs
// the same walk with the publish areas and the softmax in the block's
// global scratch, ahead of its stash (wide_global_layout): only the warp
// partials stay in shared memory.  The barrier that ends a step makes the
// groups' global writes visible to the block, as it does the shared ones;
// the reads go through L1.  K1 (up to 16384 slots, the wrapper's
// envelope) runs the same walk in forward_wide_global_kernel where its two
// publish areas pass the opt-in (2 states at W = 14, 327,680 bytes at D =
// 2; 4 states at W = 7 fits, 229,376 bytes at D = 3): it has no stash, so
// its scratch is the publish areas alone.
//
// The same kernels run K4 up to 65536 slots (the GUI's labeling window at
// 3 states, 3^10 = 59049; 7^5 = 16807 still fits shared memory): a thread
// owns G / 1024 groups or more (20 at 59049 slots, 32 at 2^16), every
// offset into the stash is 64-bit, and a block's scratch (its carries,
// 1.0 MB at 59049 slots and D = 2, and (T-W) stash rows of 236 KB) bounds
// the persistent grid by the card's free memory (the wrapper's
// forward_kernel.grid).  Nothing in the walk depends on K past 16384: the
// limit is the wrapper's and this constant's.
static constexpr int kWideThreads = 1024;   // the block's largest size
constexpr int kWideMaxK = 65536;            // the envelope of the mapping

// One team's bytes of the wide mapping: two publish areas of (2D+1)*G
// floats, the closings' warp partials (2*32 each), K4's harvest partials
// (W*S per warp) and softmax over the register (K), then K4's stash.
static __host__ __device__ inline WalkLayout wide_layout(int K, int A,
                                                         int D, int T,
                                                         int S, int W,
                                                         bool pred) {
  const int G = K / A;
  size_t fixed = (size_t)2 * (2 * D + 1) * G + 4 * 32;
  if (pred) fixed += (size_t)W * S * 32 + K;
  const size_t stash = pred && T > W ? (size_t)(T - W) * (K | 1) : 0;
  const int threads = (G + 31) / 32 * 32;
  return {threads < kWideThreads ? threads : kWideThreads, fixed * 4,
          stash * 4};
}

// The wide mapping's team with its carries in global scratch: shared
// memory holds the closings' and (K4) the harvest's warp partials; a
// block's scratch holds the two publish areas and, for K4 (pred), the
// softmax over the register (K) and the stash, in that order.
static __host__ __device__ inline WalkLayout wide_global_layout(
    int K, int A, int D, int T, int S, int W, bool pred) {
  const int G = K / A;
  const size_t parts = 4 * 32 + (pred ? (size_t)W * S * 32 : 0);
  const size_t carries = (size_t)2 * (2 * D + 1) * G + (pred ? K : 0);
  const size_t stash = pred && T > W ? (size_t)(T - W) * (K | 1) : 0;
  const int threads = (G + 31) / 32 * 32;
  return {threads < kWideThreads ? threads : kWideThreads, parts * 4,
          (carries + stash) * 4};
}

// One track's walk on the wide mapping (x, l2: its (T, D) rows; sg: its
// (T-1, P) displacement variances, VDT; stash: K4's fusion weights).
template <int D, bool PRED, bool VDT>
static __device__ __forceinline__ void wide_track(
    const WalkArgs& wa, int b, int L, float isbl, const float* x,
    const float* l2, const float* sg, float* pubs, float* scr, float* red,
    float* stash, Prof& pf) {
  const Tables& tb = wa.tb;
  const int K = tb.K, A = tb.A, G = K / A;
  const int T = wa.T, S = wa.S, W = wa.W;
  const int P = VDT ? wa.P : 0, SP = VDT ? wa.P / A : 0;
  const int KP = VDT ? K / P : 1;             // slots a pattern
  const int KN = VDT ? K * A / P : 1;         // slots a newest digit
  const int tid = threadIdx.x, nt = blockDim.x;
  const int F = 2 * D + 1;
  const float cl2pi = 0.5f * D * kLog2Pi;
  const int ks = K | 1;                       // stash row stride
  const float* prev = nullptr;                // the last step's groups
  float gate_prev = 0.f;
  float out = 0.f;
  int pb = 0;

  // member c's carry entering step t: the track's first frame at t = 1,
  // else group c % G of the last fusion plus child c's terms
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
      const float sv = VDT ? sg[(t - 1) * P + c / KP] : __ldg(tb.sig2v + c);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        m[d] = prev[d * G + gp];
        s2[d] = sv + prev[(D + d) * G + gp];
      }
      lp = prev[2 * D * G + gp] + __ldg(tb.lt + c) +
           gate_prev * __ldg(tb.lsurv + c);
    }
  };

  pf.mark(kWkSetup);
  for (int t = 1;; ++t) {
    float xt[D], l2t[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xt[d] = x[t * D + d];
      l2t[d] = l2[t * D + d];
    }
    if (t == L - 1) {
      // the register's own closing (2-frame tracks) and K4's softmax; K4
      // keeps each slot's log2 weight in scr until the sum is known
      float mx = kNegBig, s = 0.f;
      for (int g = tid; g < G; g += nt) {
        for (int o = 0; o < A; ++o) {
          const int c = g * A + o;
          float m[D], s2[D], lp;
          carry(c, t, m, s2, lp);
          Upd<D> u;
          update2<D>(m, s2, xt, l2t, u);
          const float fin =
              kLog2e * (lp + isbl * __ldg(tb.endv + c) - u.quad);
          const float r = rsq(u.prod);
          lse2_add(mx, s, fin, r);
          if constexpr (PRED) scr[c] = fin - 0.5f * lg2(u.prod);
        }
      }
      block_lse2(mx, s, red + 64);
      if (L == 2) out = (mx + lg2(s)) * kLn2 - cl2pi;
      pf.mark(kWkClose);
      if constexpr (PRED) {
        float* pr = wa.preds + (size_t)b * T * S;
        const float inv_s = rcp(s);
        const int nh = L - W;
        for (int g = tid; g < G; g += nt)
          for (int o = 0; o < A; ++o)
            scr[g * A + o] = ex2(scr[g * A + o] - mx) * inv_s;
        // frames still in the window: window position i (0 = oldest) is
        // frame nh + i and digit i of the slot; the thread's sums, then
        // warp sums, then the warps' partials
        const int i0 = nh < 0 ? -nh : 0;
        int pw = 1;                     // S^i
        for (int j = 0; j < i0; ++j) pw *= S;
        for (int i = i0; i < W; ++i, pw *= S) {
          for (int s_ = 0; s_ < S; ++s_) {
            float v = 0.f;
            for (int g = tid; g < G; g += nt)
              for (int o = 0; o < A; ++o) {
                const int c = g * A + o;
                if ((c / pw) % S == s_) v += scr[c];
              }
            v = warp_sum(v);
            if ((tid & 31) == 0) red[128 + (i * S + s_) * 32 + (tid >> 5)] = v;
          }
        }
        __syncthreads();
        const int nw = nt >> 5;
        for (int o = tid; o < W * S; o += nt) {
          const int i = o / S;
          if (nh + i < 0) continue;
          float v = 0.f;
          for (int w = 0; w < nw; ++w) v += red[128 + o * 32 + w];
          pr[nh * S + o] = v;
        }
        // frames that left the window: the masses carried back through
        // the stashed fusion weights; a thread scales its own groups'
        // members (member c = g*A + o of group g gets mass_g * w_{g,o})
        if (nh > 0) {
          const float* q = scr;
          for (int f = nh - 1; f >= 0; --f) {
            __syncthreads();
            float* row = stash + (size_t)f * ks;
            for (int g = tid; g < G; g += nt) {
              float mass = 0.f;
              for (int a = 0; a < A; ++a) mass += q[a * G + g];
              for (int o = 0; o < A; ++o) row[g * A + o] *= mass;
            }
            q = row;
          }
          __syncthreads();
          for (int o = tid; o < nh * S; o += nt) {
            const int f = o / S;
            const float* row = stash + (size_t)f * ks + (o - f * S);
            float v = 0.f;
            for (int g = 0; g < G; ++g) v += row[g * A];
            pr[o] = v;
          }
        }
        for (int o = L * S + tid; o < T * S; o += nt) pr[o] = 0.f;
        pf.mark(kWkHarvest);
      }
      break;
    }
    const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;
    const bool look = t == L - 2;   // the look-ahead closing (logL)
    const bool fuse = PRED || !look;
    const int fd = t + 1 - W;       // K4: the frame this step drops
    float xn[D], l2n[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xn[d] = look ? x[(t + 1) * D + d] : 0.f;
      l2n[d] = look ? l2[(t + 1) * D + d] : 0.f;
    }
    const float c2pi = D == 1 ? k2Pi : D == 2 ? k2Pi * k2Pi
                                              : k2Pi * k2Pi * k2Pi;
    float* pub = pubs + pb * F * G;
    pb ^= 1;
    float lmx = kNegBig, ls = 0.f;  // the look-ahead's log-sum-exp
    for (int g = tid; g < G; g += nt) {
      float gmx = kNegBig, gsw = 0.f, mf[D], tf[D];
#pragma unroll
      for (int d = 0; d < D; ++d) mf[d] = tf[d] = 0.f;
      for (int o = 0; o < A; ++o) {
        const int c = g * A + o;
        float m[D], s2[D], lp;
        carry(c, t, m, s2, lp);
        Upd<D> u;
        update2<D>(m, s2, xt, l2t, u);
        const float base = kLog2e * (lp - u.quad);
        const float r = rsq(u.prod);
        if (look) {
          const int cA = c * A;
          for (int a = 0; a < A; ++a) {
            float prod_n = c2pi, quad_n = 0.f;
            const float s2n = VDT ? sg[t * P + a * SP + c / KN]
                                  : __ldg(tb.s2n + cA + a);
#pragma unroll
            for (int d = 0; d < D; ++d) {
              const float totn = s2n + u.tl[d] + l2n[d];
              const float df = xn[d] - u.nm[d];
              prod_n *= totn;
              quad_n = fmaf(0.5f * df * df, rcp(totn), quad_n);
            }
            const float cc = __ldg(tb.ltn + cA + a) +
                             gate * __ldg(tb.lsn + cA + a) +
                             isbl * __ldg(tb.endn + cA + a);
            lse2_add(lmx, ls, base + kLog2e * (cc - quad_n),
                     r * rsq(prod_n));
          }
        }
        if (fuse) {
          // the group's online sums, rescaled on a new maximum
          float wo = r;
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
          if (PRED && fd >= 0)
            stash[(size_t)fd * ks + c] = base - 0.5f * lg2(u.prod);
        }
      }
      if (fuse) {
        gsw = fmaxf(gsw, kTiny);
        const float inv = rcp(gsw);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          pub[d * G + g] = mf[d] * inv;
          pub[(D + d) * G + g] = tf[d] * inv;
        }
        pub[2 * D * G + g] = (gmx + lg2(gsw)) * kLn2;
        // K4: member o's fusion weight, for the harvest's backward pass
        if (PRED && fd >= 0)
          for (int o = 0; o < A; ++o) {
            float* w = stash + (size_t)fd * ks + g * A + o;
            *w = ex2(*w - gmx) * inv;
          }
      }
    }
    pf.mark(kWkStep);
    if (look) {
      block_lse2(lmx, ls, red);
      out = (lmx + lg2(ls)) * kLn2 - cl2pi;
      pf.mark(kWkClose);
      if constexpr (!PRED) break;
    }
    __syncthreads();
    pf.mark(kWkBarrier);
    prev = pub;
    gate_prev = gate;
  }
  if (tid == 0) wa.logl[b] = out;
}

// The wide mapping's track loop (the kernel calls it at two sites).
// GLOBAL: K4's walk with its carries in global scratch, `sh` the warp
// partials and `stash` the block's scratch (wide_global_layout: publish
// areas, softmax, stash).
template <int D, bool PRED, bool VDT, bool GLOBAL = false>
static __device__ __forceinline__ void wide_tracks(const WalkArgs& wa,
                                                   float* sh, float* stash,
                                                   unsigned long long* prof) {
  const Tables& tb = wa.tb;
  const int T = wa.T, G = tb.K / tb.A;
  float* pubs = sh;
  float* red = sh + 2 * (2 * D + 1) * G;
  float* scr = red + 128 + (PRED ? wa.W * wa.S * 32 : 0);
  if constexpr (GLOBAL) {
    red = sh;
    pubs = stash;
    scr = stash + (size_t)2 * (2 * D + 1) * G;
    stash = scr + tb.K;
  }
  Prof pf;
  pf.start();
  for (int b = blockIdx.x; b < wa.B; b += gridDim.x) {
    __syncthreads();        // the last track's partials, softmax and rows
    const int L = min(wa.lengths[b], T);
    if (L < 2) {
      if (threadIdx.x == 0) wa.logl[b] = 0.f;
      if constexpr (PRED)
        for (int o = threadIdx.x; o < T * wa.S; o += blockDim.x)
          wa.preds[(size_t)b * T * wa.S + o] = 0.f;
      continue;
    }
    wide_track<D, PRED, VDT>(
        wa, b, L, wa.isbls[b], wa.xs + (size_t)b * T * D,
        wa.l2s + (size_t)b * T * D,
        VDT ? wa.sig2s + (size_t)b * (T - 1) * wa.P : nullptr, pubs, scr,
        red, stash, pf);
  }
  pf.flush(prof, threadIdx.x == 0);
}

template <int D, bool PRED, bool VDT>
__global__ void __launch_bounds__(kWideThreads, 1)
    walk_wide_kernel(WalkArgs wa, unsigned long long* prof) {
  extern __shared__ __align__(16) float smem[];
  const WalkLayout lay = wide_layout(wa.tb.K, wa.tb.A, D, wa.T, wa.S, wa.W,
                                     PRED);
  if (wa.stash_smem)
    wide_tracks<D, PRED, VDT>(wa, smem, smem + lay.fixed / 4, prof);
  else
    wide_tracks<D, PRED, VDT>(
        wa, smem, wa.stash_all + (size_t)blockIdx.x * (lay.stash / 4), prof);
}

// K4's wide walk with its carries in the block's global scratch
// (wide_global_layout): publish areas, softmax, stash.
template <int D, bool VDT>
__global__ void __launch_bounds__(kWideThreads, 1)
    walk_wide_global_kernel(WalkArgs wa, unsigned long long* prof) {
  extern __shared__ __align__(16) float smem[];
  const WalkLayout lay = wide_global_layout(wa.tb.K, wa.tb.A, D, wa.T, wa.S,
                                            wa.W, true);
  wide_tracks<D, true, VDT, true>(
      wa, smem, wa.stash_all + (size_t)blockIdx.x * (lay.stash / 4), prof);
}

// K1's wide walk with its publish areas in the block's global scratch.
template <int D, bool VDT>
__global__ void __launch_bounds__(kWideThreads, 1)
    forward_wide_global_kernel(WalkArgs wa, unsigned long long* prof) {
  extern __shared__ __align__(16) float smem[];
  const WalkLayout lay = wide_global_layout(wa.tb.K, wa.tb.A, D, wa.T, wa.S,
                                            wa.W, false);
  wide_tracks<D, false, VDT, true>(
      wa, smem, wa.stash_all + (size_t)blockIdx.x * (lay.stash / 4), prof);
}

// The team layout of a launch: warps > 0 the warp mapping, 0 the block
// mapping, -1 the wide mapping, -2 the wide mapping with its carries in
// global scratch.
static inline WalkLayout team_layout(int warps, int K, int A, int D, int T,
                                     int S, int W, bool pred, int P) {
  if (warps == -2) return wide_global_layout(K, A, D, T, S, W, pred);
  return warps < 0 ? wide_layout(K, A, D, T, S, W, pred)
                   : walk_layout(warps, K, A, D, T, S, W, pred, P);
}

// The instantiation a launch runs: warps > 0, the warp mapping (J by K,
// the fusion's A unrolled at 2 and 4: two states, or two sub-steps or four
// states); 0, the block mapping by block size (K4 only: K1 goes from the
// warp mapping to the wide one); -1, the wide mapping; -2, the wide
// mapping with its carries in global scratch.
template <int D, bool PRED, bool VDT>
static const void* walk_instance(int K, int A, int warps) {
  if (warps == -2) {
    if constexpr (PRED)
      return (const void*)walk_wide_global_kernel<D, VDT>;
    else
      return (const void*)forward_wide_global_kernel<D, VDT>;
  }
  if (warps < 0) return (const void*)walk_wide_kernel<D, PRED, VDT>;
  if (warps > 0) {
    if (K <= 32) {
      switch (A) {
        case 2: return (const void*)walk_warp_kernel<D, 1, 2, PRED, VDT>;
        case 4: return (const void*)walk_warp_kernel<D, 1, 4, PRED, VDT>;
        default: return (const void*)walk_warp_kernel<D, 1, 0, PRED, VDT>;
      }
    }
    switch (A) {
      case 2: return (const void*)walk_warp_kernel<D, 2, 2, PRED, VDT>;
      case 4: return (const void*)walk_warp_kernel<D, 2, 4, PRED, VDT>;
      default: return (const void*)walk_warp_kernel<D, 2, 0, PRED, VDT>;
    }
  }
  if constexpr (PRED) {
    const int threads = (K + 31) / 32 * 32;
    return threads <= 128 ? (const void*)walk_block_kernel<D, 128, PRED, VDT>
         : threads <= 256 ? (const void*)walk_block_kernel<D, 256, PRED, VDT>
         : threads <= 512 ? (const void*)walk_block_kernel<D, 512, PRED, VDT>
                          : (const void*)walk_block_kernel<D, 1024, PRED, VDT>;
  } else {
    return nullptr;
  }
}

// walk_instance for a launch at D dimensions; P > 0: variable dt.
template <bool PRED>
static const void* walk_instance_for(int D, int K, int A, int warps, int P) {
  switch (D) {
    case 1: return P > 0 ? walk_instance<1, PRED, true>(K, A, warps)
                         : walk_instance<1, PRED, false>(K, A, warps);
    case 2: return P > 0 ? walk_instance<2, PRED, true>(K, A, warps)
                         : walk_instance<2, PRED, false>(K, A, warps);
    case 3: return P > 0 ? walk_instance<3, PRED, true>(K, A, warps)
                         : walk_instance<3, PRED, false>(K, A, warps);
    default: return nullptr;
  }
}

static size_t walk_smem(const WalkLayout& lay, int warps, bool stash_smem) {
  return (size_t)(warps > 0 ? warps : 1) *
         (lay.fixed + (stash_smem ? lay.stash : 0));
}

// Blocks of a K1 / K4 launch one SM keeps resident, or -error.
template <bool PRED>
static int walk_occupancy(int D, int K, int A, int T, int S, int W,
                          int warps, int stash_smem, int P) {
  const void* fn = walk_instance_for<PRED>(D, K, A, warps, P);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  const WalkLayout lay = team_layout(warps, K, A, D, T, S, W, PRED, P);
  const size_t smem = walk_smem(lay, warps, stash_smem);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, lay.threads,
                                                        smem);
  return err == cudaSuccess ? n : -(int)err;
}

// Launches K1 (PRED false) or K4 on `nblk` persistent blocks.
template <bool PRED>
static int launch_walk(const WalkArgs& wa, int D, int nblk, int warps,
                       unsigned long long* prof, cudaStream_t stream) {
  const int K = wa.tb.K, A = wa.tb.A, P = wa.P;
  if (D < 1 || D > 3 || K > (warps < 0 ? kWideMaxK : 1024) || warps < -2 ||
      32 * warps > kWalkWarpBlock || (warps > 0 && K > 64) ||
      (!PRED && warps == 0) ||
      (warps == -2 && (wa.stash_smem || wa.stash_all == nullptr)) ||
      (!PRED && wa.stash_smem) || (PRED && A != wa.S) || P < 0 ||
      (P > 0 && (wa.sig2s == nullptr || P % A != 0 || K % P != 0 ||
                 wa.T < 2)))
    return (int)cudaErrorInvalidValue;
  if (wa.B <= 0) return 0;
  const void* fn = walk_instance_for<PRED>(D, K, A, warps, P);
  const WalkLayout lay = team_layout(warps, K, A, D, wa.T, wa.S, wa.W, PRED,
                                     P);
  const size_t smem = walk_smem(lay, warps, wa.stash_smem);
  // always: an occupancy query may have set a smaller limit
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  WalkArgs a = wa;
  void* args[] = {(void*)&a, (void*)&prof};
  cudaLaunchKernel(fn, nblk, lay.threads, args, smem, stream);
  return (int)cudaGetLastError();
}

}  // namespace extrack
