// The gradient walk of K2 (grad.cu), templated over the scalar type so that
// K3 (hvp.cu) runs the same code on dual numbers.  See grad.cu for what the
// kernel replaces and how it is laid out.  Three mappings of a track onto
// threads: grad_warp_kernel (one warp per track, K <= 64), grad_kernel
// (one block per track, a thread a slot, any K up to 1024) and
// grad_cluster_kernel (the wide mapping: a cluster of 1 to 16 blocks per
// track, a thread one or two fusion groups, any K up to 65536 with at most
// 16384 groups); the host picks one per launch.
//
// Variable dt (the VDT template flag, so that the constant-dt
// instantiations keep their code): the displacement variances come from a
// (B, T-1, P) stream (P = S^(n+1) patterns of the n+1 newest sub-states;
// row t holds step t -> t+1) in place of s20, sig2v and s2n, read as
// common.cuh's track_forward reads them, and the walk writes the stream's
// cotangent, (B, T-1, P), in place of those three tables'.  Each row a
// track uses gets exactly one kind of term, so each is written once, by
// the team that owns the track (no atomics, no accumulation): row 0 the
// initial register's s20 cotangents, rows 1 .. L-3 a fusion's children's
// variance cotangents, row L-2 the look-ahead children's; each summed over
// the slots of a pattern in slot order, from the team's shared memory (the
// block mapping's look-ahead terms from its row of the partial buffer,
// whose s2n columns the stream leaves unused).  Rows past a track's length
// stay as the caller zeroed them.
#pragma once

#include <climits>

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "common.cuh"

namespace extrack {

// Sections of K2's cycle split (tools/k2_profile.py), after the forward
// walk's kPfStash, kPfStep and kPfClose (common.cuh).
enum {
  kPfStashRead = 3,   // the carry history read back
  kPfPrep = 4,        // the step's Gaussian update, recomputed
  kPfCloseBwd = 5,    // a closing's pullback and its (K, A) partials
  kPfFuseBwd = 6,     // the fusion pullback
  kPfL2Sum = 7,       // prep_bwd and the per-step l2-cotangent sums
  kPfInit = 8,        // the initial register's sums
  kPfPartials = 9,    // per-slot partial writes
};
// Sections of the wide walks' split (tools/k2_profile.py --split on the
// wide mapping): barriers and block sums are sections of their own, so a
// thread's wait for the slowest shows apart from its own work.
enum {
  kPwFuse = 0,        // forward: fusion steps (updates, history writes)
  kPwFuseSync = 1,    // forward: the fusion steps' barriers
  kPwClose = 2,       // forward: the closing (both passes, reductions)
  kPwXchRead = 3,     // backward: the children's sums from the exchange
  kPwOnline = 4,      // backward: the fusion weights recomputed
  kPwMember = 5,      // backward: members' pullbacks, exchange, partials
  kPwLook = 6,        // backward: a closing's pullback
  kPwSums = 7,        // backward: l2 sums, stream rows, their barriers
  kPwXchSync = 8,     // backward: the barrier before the exchange is reused
  kPwSetup = 9,       // partial rows zeroed, tracks skipped
};
#ifdef EXTRACK_PROFILE
static __device__ unsigned long long g_prof[kProfSlots];
#endif

constexpr int kWarpBlock = 128;    // largest warp-mapping block, 4 warps
constexpr int kBlockSmall = 256;   // block mapping's thread bounds, with
constexpr int kBlockMid = 512;     // 1024

// Blocks per SM each instantiation is compiled for (__launch_bounds__'
// second argument): the register cap, 65536 / (threads * blocks), that
// keeps the walk spill-free (ptxas -v).  The warp mapping's float walk fits
// 128 registers up to D = 2; D = 3 and dual numbers need up to 255.  The
// block mapping's walk fits 128 (its (K,) cotangents accumulate in the
// block's partial row, not in registers); at 64, which would keep twice
// the warps resident, it spills.  Blocks of 1024 threads get 64 registers
// whatever they ask: past 512 slots a track's walk state (80 to 128
// registers a slot) no longer fits one block's 64K registers, so that
// instantiation spills by construction.
template <typename Real, int D>
constexpr int warp_min_blocks() {
  return sizeof(Real) == sizeof(float) && D <= 2 ? 4 : 2;
}
template <int MaxT>
constexpr int block_min_blocks() {
  return MaxT == kBlockSmall ? 2 : 1;
}

// Block mapping.  One persistent block walks tracks blockIdx.x,
// blockIdx.x + gridDim.x, ..., thread k owning slot k (common.cuh).
// Outputs d(sum logL)/d(l2) per track and the per-block partial sums of the
// ten table cotangents (reduced by reduce_partials).  MaxT is the largest
// block it is launched with (kBlockSmall, kBlockMid or 1024).
template <typename Real, int D, int MaxT, bool VDT>
__global__ void __launch_bounds__(MaxT, block_min_blocks<MaxT>())
    grad_kernel(TablesT<Real> tb, const float* __restrict__ xs,
                const Real* __restrict__ l2s, const int* __restrict__ lengths,
                const float* __restrict__ isbls, int B, int T,
                Real* __restrict__ logl, Real* __restrict__ ct_l2,
                Real* __restrict__ stash_all, Real* __restrict__ partial,
                StreamT<Real> st) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  Real* sh = reinterpret_cast<Real*>(sh_raw);
  __shared__ Real red[33];
  const int K = tb.K, A = tb.A, G = K / A;
  const int k = threadIdx.x;
  const bool act = k < K;
  const float cl2pi = 0.5f * D * kLog2Pi;
  // variable dt: the stream's constants stay kernel parameters (st.P,
  // st.S, st.KP, st.KS) and a track's rows are recomputed where read, to
  // spare registers
  const int P = VDT ? st.P : 0;

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
  // the (K,) tables' cotangents accumulate in the block's partial row too:
  // part[f * K + k] for lp0, s20, lt, lsurv, endv, sig2v
  Real* a_lp0 = part + k;
  Real* a_s20 = a_lp0 + K;
  Real* a_lt = a_s20 + K;
  Real* a_lsurv = a_lt + K;
  Real* a_end = a_lsurv + K;
  Real* a_sig2v = a_end + K;
  if (act) {
    for (int f = 0; f < 6; ++f) part[f * K + k] = Real(0.f);
    for (int a = 0; a < A; ++a)
      p_ltn[k * A + a] = p_s2n[k * A + a] = p_lsn[k * A + a] =
          p_endn[k * A + a] = Real(0.f);
  }
  Prof pf;
  pf.start();

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int L = min(lengths[b], T);
    if (L < 2) {            // empty / 1-frame rows: logL 0, ct_l2 stays 0
      if (k == 0) logl[b] = Real(0.f);
      continue;
    }
    const float* x = xs + (size_t)b * T * D;
    const Real* l2 = l2s + (size_t)b * T * D;
    Real* cl2 = ct_l2 + (size_t)b * T * D;
    auto sg = [&]() { return st.s2 + (size_t)b * (T - 1) * P; };
    auto csg = [&]() { return st.ct + (size_t)b * (T - 1) * P; };
    const float isbl = isbls[b];
    Real cmx, csum;
    const Real out = track_forward<Real, D, VDT>(
        tb, x, l2, VDT ? sg() : nullptr, st, L, isbl, sh, red, stash, &cmx,
        &csum, &pf);
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
      pf.mark(kPfStashRead);
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
      pf.mark(kPfPrep);

      Real cb = Real(0.f), cnm[D], ctl[D];
#pragma unroll
      for (int d = 0; d < D; ++d) cnm[d] = ctl[d] = Real(0.f);
      if (L == 2) {
        // 2-frame closing: softmax posterior over the slots
        if (act) {
          const Real fin = lp + isbl * tb.endv[k] - 0.5f * xlog(p.prod) -
                           p.quad - cl2pi;
          const Real q = xexp(fin - cmx) / csum;
          *a_end += isbl * q;
          cb = q;
        }
        pf.mark(kPfCloseBwd);
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
                look_child<Real, D>(
                    p, xn, l2n,
                    VDT ? sg()[t * P + a * st.S + k / st.KS] : tb.s2n[ka],
                    invn, diffn, r);
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
            // variable dt: the block's p_s2n row holds this track's
            // look-ahead cotangents, summed into the stream below
            if constexpr (VDT)
              p_s2n[ka] = cs;
            else
              p_s2n[ka] += cs;
            cb += q;
          }
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const Real v = block_sum(cl2n[d], red);
          if (k == 0) cl2[(t + 1) * D + d] = v;
        }
        if constexpr (VDT) {
          // row t, pattern q = a*S + s: child (kk, a) over the slots kk of
          // newest digit s
          for (int q = k; q < P; q += blockDim.x) {
            const int a = q / st.S, s0 = (q % st.S) * st.KS;
            Real v = Real(0.f);
            for (int kk = s0; kk < s0 + st.KS; ++kk) v += p_s2n[kk * A + a];
            csg()[t * P + q] = v;
          }
        }
        pf.mark(kPfCloseBwd);
      } else {
        // fusion pullback.  The children's cotangents go through shared
        // memory to their group's members, next to the members' update.
        if (act) {
          *a_lt += clp;
          *a_lsurv += gate * clp;
          if constexpr (!VDT) {
            Real cs = Real(0.f);
#pragma unroll
            for (int d = 0; d < D; ++d) cs += cs2[d];
            *a_sig2v += cs;
          }
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
        if constexpr (VDT) {
          // row t: the children's variance cotangents over each pattern's
          // slots
          for (int q = k; q < P; q += blockDim.x) {
            Real v = Real(0.f);
            for (int kk = q * st.KP; kk < (q + 1) * st.KP; ++kk)
#pragma unroll
              for (int d = 0; d < D; ++d) v += scs2[d * K + kk];
            csg()[t * P + q] = v;
          }
        }
        if (act) {
          const int g = k / A;           // this slot's fusion group
          Real mx, sw, mf[D], tf[D], cmf[D], ctf[D];
          group_sums<Real, D>(sh, K, g * A, A, mx, sw, mf, tf);
#pragma unroll
          for (int d = 0; d < D; ++d) cmf[d] = ctf[d] = Real(0.f);
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
        pf.mark(kPfFuseBwd);
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
      pf.mark(kPfL2Sum);
    }
    // initial register: m = x_0 (no parameter), s2 = l2_0 + s20, lp = lp0
    Real cs = Real(0.f);
#pragma unroll
    for (int d = 0; d < D; ++d) cs += cs2[d];
    if constexpr (VDT) {
      // row 0: the s20 cotangents over each pattern's slots (the block
      // sums below keep sbase from the next track until they are read)
      if (act) sbase[k] = cs;
      __syncthreads();
      for (int q = k; q < P; q += blockDim.x) {
        Real v = Real(0.f);
        for (int kk = q * st.KP; kk < (q + 1) * st.KP; ++kk) v += sbase[kk];
        csg()[q] = v;
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const Real v = block_sum(cs2[d], red);
      if (k == 0) cl2[d] = v;
    }
    if (act) {
      *a_lp0 += clp;
      if constexpr (!VDT) *a_s20 += cs;
    }
    pf.mark(kPfInit);
  }
  if constexpr (VDT) {
    // the look-ahead scratch out of the s2n partials (their table is unused)
    __syncthreads();
    if (act)
      for (int a = 0; a < A; ++a) p_s2n[k * A + a] = Real(0.f);
  }
  pf.mark(kPfPartials);
#ifdef EXTRACK_PROFILE
  pf.flush(g_prof, k == 0);
#endif
}

// ---- the wide mapping: 1024 < K <= 65536 slots -----------------------
//
// A thread a slot stops at 1024 slots.  The wide mapping gives a thread
// whole fusion groups (G = K/A groups), as K1's wide walk does (walk.cuh):
// group g's members are slots g*A .. g*A+A-1, and member c's carry
// entering step t is group c % G of step t-1's fusion plus child c's
// terms (lt, lsurv, the displacement variance).  No slot lives in
// registers between steps.
//
// Forward: a fusion step reads each member's group, updates the member
// against the frame and mixes the group's A updates in registers (an
// online log-sum-exp that rescales its sums on a new maximum, its shift
// carrying no tangent), and writes the G fused Gaussians, (2D+1) scalars
// each, to the track's history in global scratch: row t-1 holds step t's
// fusion, the carries of step t+1.  The history is all the backward
// needs: a member's carry is recomputed from its group's row and its own
// child terms, (T-3)(2D+1)G scalars a track in place of the block
// mapping's (T-1)(2D+1)K.  The closing is one pass over every member's
// look-ahead children: an online max and sum shifted to it, combined over
// the block and then the cluster.
//
// Backward: member c of step t+1 is child c / G of group c % G of step t,
// and the thread that computes member c's carry cotangent owns group c / A,
// not group c % G.  So each step publishes its members' carry cotangents,
// (2D+1)K scalars (the exchange), and the owner of group g sums its
// children g + a*G in a order into the fused group's cotangent.  A
// member's child terms (lt, lsurv, sig2v) take the cotangent of the carry
// they built, one step later than the block mapping adds them, with the
// gate of the fusion that built it.  No atomics.
//
// A track is walked by a cluster of C blocks on neighbouring SMs
// (Hopper's thread-block clusters; C = 1 .. 16, the host's choice), so a
// thread owns one or two groups at any K (up to 16384 groups) and holds
// their children's sums in registers across the step's barriers.  Rank r
// of the cluster owns the Gc = ceil(G/C) groups r*Gc .. r*Gc+Gc-1 (the
// last rank fewer, or none), thread i of it local groups i and
// i + blockDim.x; the rank owns the members of its groups, slots r*M ..
// with M = Gc*A.  The exchange is split the same way: each rank keeps its
// own members' (2D+1)*M scalars in its shared memory, and the owner of
// group g reads its children from the ranks that own them (distributed
// shared memory).  It is single-buffered: step t reads the exchange of
// step t+1, a cluster barrier, then step t writes its own, a second
// cluster barrier.  Where a rank's slice does not fit its shared memory,
// the slices sit in the cluster's global scratch after the history (warps
// = -2 in the C interface), read through the same generic pointer.  The
// history is one per cluster in global scratch, each rank writing its
// groups' entries and reading any group's (the cluster barriers' release
// and acquire order those global writes and reads too).
//
// The closings take most of the walk's time (tools/k2_profile.py
// --split): A look-ahead children a member, each reading four (K, A)
// tables and adding to four (K, A) partials.  Dealt by groups, a warp's
// threads would sit a group's A*A entries apart, and the closings' lines
// would not stay in L1 (at 6^6: 590 KB an SM).  So the closings deal the
// rank's members over its threads (member r*M + i to thread
// i % blockDim.x, neighbours on neighbours), and the (K, A) partials are
// kept pattern-major ([a][c], reduce_partials_ak puts them back), so that
// a warp's adds to one pattern are one line.  The fusion steps keep the
// group dealing their sums need.
//
// Reductions over the track (the closing's max and sum, the l2 cotangents
// of a step) are block reductions first, each into its block's slot, then
// the C slots in rank order: every value has one order of summation, so
// K2 and K3 are bit-repeatable.  A cluster's blocks write disjoint slot
// ranges of one partial row (one row a cluster, summed in cluster order).
// Variable dt: each stream row a pattern's sum over its slots, from the
// exchange (rows 0 .. L-3) and from the partial row's s2n columns (the
// look-ahead row L-2), a warp of the cluster a pattern (its lanes' strided
// sums, then the warp's; a thread a pattern left most of the cluster
// waiting on a few long sums at a barrier).  grad_wide_layout is the one
// definition of a
// block, with a host twin in ops/grad_kernel.py.  Slot and group indices
// stay in int (K * A, a (K, A) table's size, stays below 2^31:
// launch_grad refuses more); every offset that a cluster index, T or A
// multiplies into scratch is size_t.
constexpr int kGradWideThreads = 1024;   // the block's largest size
constexpr int kGradWideGroups = 2;       // groups a thread owns, at most
constexpr int kGradWideMaxK = 65536;     // the envelope of the mapping
constexpr int kGradClusterMax = 16;      // blocks a cluster (8 portable)
constexpr int kRedScalars = 64;          // block reductions' scratch (33)
constexpr int kClusterSlot = 40;         // red[40..]: a block's sums for
enum { kSlotMax = 0, kSlotSum = 1, kSlotL2 = 2 };   // the cluster, 2 + 3D

// One block of the wide mapping: its threads, its dynamic shared bytes and
// its cluster's global scratch bytes.
struct GradWideLayout {
  int threads;
  size_t smem, scratch;
};

static __host__ __device__ inline size_t grad_wide_history(int K, int A,
                                                           int D, int T) {
  return (size_t)(T > 3 ? T - 3 : 0) * (2 * D + 1) * (K / A);
}

// One block of a cluster of C: its threads (one or two groups each), its
// shared bytes (the reductions' scratch, then its slice of the exchange
// unless xch_global) and the cluster's global scratch bytes (the history,
// then the C slices with xch_global).
static __host__ __device__ inline GradWideLayout grad_wide_layout(
    int K, int A, int D, int T, int C, bool xch_global, size_t itemsize) {
  const int Gc = (K / A + C - 1) / C;
  const size_t slice = (size_t)(2 * D + 1) * Gc * A;
  const int threads = (Gc + 31) / 32 * 32;
  return {threads < kGradWideThreads ? threads : kGradWideThreads,
          (kRedScalars + (xch_global ? 0 : slice)) * itemsize,
          (grad_wide_history(K, A, D, T) + (xch_global ? C * slice : 0)) *
              itemsize};
}

template <typename Real, int D, bool VDT>
__global__ void __launch_bounds__(kGradWideThreads, 1)
    grad_cluster_kernel(TablesT<Real> tb, const float* __restrict__ xs,
                        const Real* __restrict__ l2s,
                        const int* __restrict__ lengths,
                        const float* __restrict__ isbls, int B, int T,
                        Real* __restrict__ logl, Real* __restrict__ ct_l2,
                        Real* __restrict__ scratch_all,
                        Real* __restrict__ partial, int xch_global,
                        StreamT<Real> st) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char sh_raw[];
  Real* red = reinterpret_cast<Real*>(sh_raw);
  Real* slot = red + kClusterSlot;
  const int K = tb.K, A = tb.A, G = K / A, F = 2 * D + 1;
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int cid = blockIdx.x / C, ncl = gridDim.x / C;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Gc = (G + C - 1) / C, g0 = rank * Gc;
  const int Gr = max(0, min(Gc, G - g0));   // this rank's groups
  const int M = Gc * A, c0 = rank * M;      // a slice's members, the first
  const int Mr = Gr * A;                    // this rank's members
  const size_t xn = (size_t)F * M;
  const float cl2pi = 0.5f * D * kLog2Pi;
  const int P = VDT ? st.P : 0;
  const size_t hist_n = grad_wide_history(K, A, D, T);
  Real* hist = scratch_all + (size_t)cid *
                                 (hist_n + (xch_global ? C * xn : 0));
  // rank r's slice of the exchange: member r*M + i's carry cotangent, lp
  // at [i], m at [(1+d)*M + i], s2 at [(1+D+d)*M + i]
  Real* const xown = xch_global ? hist + hist_n + (size_t)rank * xn
                                : red + kRedScalars;
  auto xslice = [&](int r) -> const Real* {
    return xch_global ? hist + hist_n + (size_t)r * xn
                      : cl.map_shared_rank(red + kRedScalars, r);
  };
  // a slot of every rank summed in rank order
  auto slots = [&](int i) {
    Real v = Real(0.f);
    for (int r = 0; r < C; ++r) v += *cl.map_shared_rank(slot + i, r);
    return v;
  };

  // the partial row: the (K,) tables' cotangents at [f*K + c] (lp0, s20,
  // lt, lsurv, endv, sig2v), then the (K, A) tables' pattern-major,
  // [a*K + c] (ltn, s2n, lsn, endn)
  const size_t ncols = (size_t)6 * K + (size_t)4 * K * A;
  Real* part = partial + (size_t)cid * ncols;
  Real* p_ltn = part + 6 * K;
  Real* p_s2n = p_ltn + K * A;
  Real* p_lsn = p_s2n + K * A;
  Real* p_endn = p_lsn + K * A;
  enum { kLp0 = 0, kS20 = 1, kLt = 2, kLsurv = 3, kEnd = 4, kSig2v = 5 };
  Prof pf;
  pf.start();
  for (int c = c0 + tid; c < c0 + Mr; c += nt) {
    for (int f = 0; f < 6; ++f) part[f * K + c] = Real(0.f);
    for (int a = 0; a < A; ++a)
      p_ltn[a * K + c] = p_s2n[a * K + c] = p_lsn[a * K + c] =
          p_endn[a * K + c] = Real(0.f);
  }

  for (int b = cid; b < B; b += ncl) {
    const int L = min(lengths[b], T);
    if (L < 2) {            // empty / 1-frame rows: logL 0, ct_l2 stays 0
      if (rank == 0 && tid == 0) logl[b] = Real(0.f);
      continue;
    }
    pf.mark(kPwSetup);
    const float* x = xs + (size_t)b * T * D;
    const Real* l2 = l2s + (size_t)b * T * D;
    Real* cl2 = ct_l2 + (size_t)b * T * D;
    const Real* sg = VDT ? st.s2 + (size_t)b * (T - 1) * P : nullptr;
    Real* csg = VDT ? st.ct + (size_t)b * (T - 1) * P : nullptr;
    const float isbl = isbls[b];
    const int tlast = L == 2 ? 1 : L - 2;

    // member c's carry entering step t: the first frame at t = 1, else
    // group c % G of step t-1's fusion (history row t-2) plus child c's
    // terms, with the gate of that fusion
    auto carry = [&](int c, int t, Real* m, Real* s2, Real& lp) {
      if (t == 1) {
        lp = tb.lp0[c];
        const Real s20 = VDT ? sg[c / st.KP] : tb.s20[c];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          m[d] = Real(x[d]);
          s2[d] = l2[d] + s20;
        }
      } else {
        const Real* prev = hist + (size_t)(t - 2) * F * G;
        const int gp = c % G;
        const float gate_prev = t >= tb.min_len ? 1.f : 0.f;
        const Real sv = VDT ? sg[(t - 1) * P + c / st.KP] : tb.sig2v[c];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          m[d] = prev[d * G + gp];
          s2[d] = sv + prev[(D + d) * G + gp];
        }
        lp = prev[2 * D * G + gp] + tb.lt[c] + gate_prev * tb.lsurv[c];
      }
    };
    // group g's sums at step t over its members' updates: their largest
    // base log weight mx, the exp-sum sw shifted by it and the weighted
    // means mf and tails tf (group_sums' quantities, in one pass)
    auto group_online = [&](int g, int t, const float* xt, const Real* l2t,
                            Real& mx, Real& sw, Real* mf, Real* tf) {
      mx = Real(-INFINITY);
      sw = Real(0.f);
#pragma unroll
      for (int d = 0; d < D; ++d) mf[d] = tf[d] = Real(0.f);
      for (int c = g * A; c < (g + 1) * A; ++c) {
        Real m[D], s2[D], lp;
        carry(c, t, m, s2, lp);
        Prep<Real, D> p;
        prep<Real, D>(m, s2, xt, l2t, p);
        const Real base = lp - p.quad;
        if (val(base) > val(mx)) {
          const Real nmx = shift_max(mx, base);
          const Real sc = xexp(mx - nmx);
          sw = sw * sc;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            mf[d] = mf[d] * sc;
            tf[d] = tf[d] * sc;
          }
          mx = nmx;
        }
        const Real w = xexp(base - mx) * xrsqrt(p.prod);
        sw += w;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          mf[d] += w * p.nm[d];
          tf[d] += w * p.tl[d];
        }
      }
    };
    // what step t leaves to the cluster, read after its barrier: the l2
    // cotangents of its block sums (rank 0), the stream's rows (variable
    // dt: row t-1 from the exchange, the look-ahead row t from the
    // partial row)
    auto publish = [&](int t) {
      const bool lk = t == tlast && L > 2;
      if (rank == 0 && tid < D) {
        cl2[t * D + tid] = slots(kSlotL2 + tid);
        if (lk) cl2[(t + 1) * D + tid] = slots(kSlotL2 + D + tid);
        if (t == 1) cl2[tid] = slots(kSlotL2 + 2 * D + tid);
      }
      if constexpr (VDT) {
        // a warp a pattern: each lane's sum over its share of the
        // pattern's slots, then the warp's (a fixed order)
        const int lane = tid & 31;
        const int wq = (rank * nt + tid) >> 5, nwq = (C * nt) >> 5;
        if (lk)
          for (int q = wq; q < P; q += nwq) {
            const int a = q / st.S, s0 = (q % st.S) * st.KS;
            Real v = Real(0.f);
            for (int kk = s0 + lane; kk < s0 + st.KS; kk += 32)
              v += p_s2n[a * K + kk];
            v = warp_sum(v);
            if (lane == 0) csg[t * P + q] = v;
          }
        for (int q = wq; q < P; q += nwq) {
          Real v = Real(0.f);
          for (int kk = q * st.KP + lane; kk < (q + 1) * st.KP; kk += 32) {
            const int r = kk / A / Gc;
            const Real* xr = xslice(r) + (1 + D) * M + (kk - r * M);
#pragma unroll
            for (int d = 0; d < D; ++d) v += xr[d * M];
          }
          v = warp_sum(v);
          if (lane == 0) csg[(t - 1) * P + q] = v;
        }
      }
    };

    // forward walk
    Real cmx = Real(0.f), csum = Real(1.f), out = Real(0.f);
    for (int t = 1; t <= tlast; ++t) {
      float xt[D];
      Real l2t[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xt[d] = x[t * D + d];
        l2t[d] = l2[t * D + d];
      }
      const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;
      if (t == tlast) {
        // closing, over the rank's members, in one pass: each thread's
        // max and its sum shifted to it, rescaled on a new maximum (the
        // shifts carry no tangent); then the block's, then the cluster's
        float xn[D];
        Real l2n[D], invn[D], diffn[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          xn[d] = L == 2 ? 0.f : x[(t + 1) * D + d];
          l2n[d] = L == 2 ? Real(0.f) : l2[(t + 1) * D + d];
        }
        Real mx = Real(-INFINITY), s = Real(0.f);
        auto shift_to = [&](const Real& v) {
          if (val(v) > val(mx)) {
            const Real nmx = shift_max(mx, v);
            s = s * xexp(mx - nmx);
            mx = nmx;
          }
        };
        for (int c = c0 + tid; c < c0 + Mr; c += nt) {
          Real m[D], s2[D], lp;
          carry(c, t, m, s2, lp);
          Prep<Real, D> p;
          prep<Real, D>(m, s2, xt, l2t, p);
          if (L == 2) {
            const Real fin = lp + isbl * tb.endv[c] - 0.5f * xlog(p.prod) -
                             p.quad - cl2pi;
            shift_to(fin);
            s += xexp(fin - mx);
            continue;
          }
          const Real base_n = lp - p.quad - 0.5f * xlog(p.prod) - cl2pi;
          for (int a = 0; a < A; ++a) {
            const int ka = c * A + a;
            Real r;
            const Real gl =
                base_n + tb.ltn[ka] + gate * tb.lsn[ka] + isbl * tb.endn[ka] +
                look_child<Real, D>(
                    p, xn, l2n,
                    VDT ? sg[t * P + a * st.S + c / st.KS] : tb.s2n[ka],
                    invn, diffn, r);
            shift_to(gl);
            s += xexp(gl - mx) * r;
          }
        }
        // a thread without a term (mx -inf) adds nothing
        const Real bmx = block_max(mx, red);
        s = block_sum(val(mx) == -INFINITY ? Real(0.f) : s * xexp(mx - bmx),
                      red);
        if (tid == 0) {
          slot[kSlotMax] = bmx;
          slot[kSlotSum] = s;
        }
        cl.sync();
        mx = Real(-INFINITY);
        for (int r = 0; r < C; ++r)
          mx = shift_max(mx, *cl.map_shared_rank(slot + kSlotMax, r));
        s = Real(0.f);
        for (int r = 0; r < C; ++r) {
          const Real mr = *cl.map_shared_rank(slot + kSlotMax, r);
          if (val(mr) != -INFINITY)
            s += *cl.map_shared_rank(slot + kSlotSum, r) * xexp(mr - mx);
        }
        cmx = mx;
        csum = s;
        out = mx + xlog(s);
        pf.mark(kPwClose);
      } else {
        // fusion: this rank's groups' Gaussians into history row t-1
        Real* row = hist + (size_t)(t - 1) * F * G;
#pragma unroll
        for (int j = 0; j < kGradWideGroups; ++j) {
          const int lg = tid + j * nt;
          if (lg >= Gr) continue;
          const int g = g0 + lg;
          Real mx, sw, mf[D], tf[D];
          group_online(g, t, xt, l2t, mx, sw, mf, tf);
          const Real inv_sw = 1.0f / clamp_min(sw, kTiny);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            row[d * G + g] = mf[d] * inv_sw;
            row[(D + d) * G + g] = tf[d] * inv_sw;
          }
          row[2 * D * G + g] = mx + xlog(clamp_min(sw, kTiny));
        }
        pf.mark(kPwFuse);
        cl.sync();
        pf.mark(kPwFuseSync);
      }
    }
    if (rank == 0 && tid == 0) logl[b] = out;

    // backward walk: at step t each member's carry cotangent goes to its
    // rank's slice of the exchange
    for (int t = tlast; t >= 1; --t) {
      float xt[D];
      Real l2t[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xt[d] = x[t * D + d];
        l2t[d] = l2[t * D + d];
      }
      const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;
      const float gate_prev = t >= tb.min_len ? 1.f : 0.f;
      const bool fuse = t < tlast;
      const bool look = t == tlast && L > 2;
      Real dl2s[D], c0s[D], cl2n[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dl2s[d] = c0s[d] = cl2n[d] = Real(0.f);
      // member c's pullback through its update, given the cotangents of
      // its log weight (cb), posterior mean and tail: the carry's
      // cotangent to the exchange, the terms that built the carry (the
      // initial register's, or child c's of step t-1's fusion) to the
      // partial row, the l2 cotangents to the step's sums
      auto pull = [&](int c, const Real* m, const Real* s2,
                      const Prep<Real, D>& p, Real cb, const Real* cnm,
                      const Real* ctl) {
        Real dm[D], ds2[D], dl2[D];
        prep_bwd<Real, D>(m, s2, xt, l2t, p, cb, cnm, ctl, dm, ds2, dl2);
        Real cs = Real(0.f);
        Real* xw = xown + (c - c0);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          xw[(1 + d) * M] = dm[d];
          xw[(1 + D + d) * M] = ds2[d];
          dl2s[d] += dl2[d];
          c0s[d] += ds2[d];
          cs += ds2[d];
        }
        xw[0] = cb;
        if (t == 1) {
          part[kLp0 * K + c] += cb;
          if constexpr (!VDT) part[kS20 * K + c] += cs;
        } else {
          part[kLt * K + c] += cb;
          part[kLsurv * K + c] += gate_prev * cb;
          if constexpr (!VDT) part[kSig2v * K + c] += cs;
        }
      };
      if (fuse) {
        // the fused groups' cotangents (lp, m, s2): the sums over each
        // group's children, in the exchange that step t+1 wrote
        Real gc[kGradWideGroups][2 * D + 1];
#pragma unroll
        for (int j = 0; j < kGradWideGroups; ++j) {
          const int lg = tid + j * nt;
#pragma unroll
          for (int f = 0; f < 2 * D + 1; ++f) gc[j][f] = Real(0.f);
          if (lg >= Gr) continue;
          for (int c = g0 + lg; c < K; c += G) {
            const int r = c / A / Gc;
            const Real* xr = xslice(r) + (c - r * M);
            gc[j][0] += xr[0];
#pragma unroll
            for (int d = 0; d < D; ++d) {
              gc[j][1 + d] += xr[(1 + d) * M];
              gc[j][1 + D + d] += xr[(1 + D + d) * M];
            }
          }
        }
        pf.mark(kPwXchRead);
        publish(t + 1);
        pf.mark(kPwSums);
        cl.sync();            // every read of the exchange and the slots
                              // before they are overwritten
        pf.mark(kPwXchSync);
#pragma unroll
        for (int j = 0; j < kGradWideGroups; ++j) {
          const int lg = tid + j * nt;
          if (lg >= Gr) continue;
          const int g = g0 + lg;
          Real mx, sw, mf[D], tf[D];
          group_online(g, t, xt, l2t, mx, sw, mf, tf);
          const Real inv_sw = 1.0f / clamp_min(sw, kTiny);
          // the guard's indicator has a zero tangent
          const float ok = val(sw) >= kTiny ? 1.f : 0.f;
          // softmax-mixture rule: the sw factors cancel against wn
          Real fac = gc[j][0];
#pragma unroll
          for (int d = 0; d < D; ++d)
            fac -= (gc[j][1 + d] * mf[d] + gc[j][1 + D + d] * tf[d]) *
                   inv_sw;
          fac = ok * fac;
          pf.mark(kPwOnline);
          for (int c = g * A; c < (g + 1) * A; ++c) {
            // fusion pullback of member c of group g
            Real m[D], s2[D], lp;
            carry(c, t, m, s2, lp);
            Prep<Real, D> p;
            prep<Real, D>(m, s2, xt, l2t, p);
            const Real wn = xexp(lp - p.quad - mx) * xrsqrt(p.prod) * inv_sw;
            Real own = Real(0.f), cnm[D], ctl[D];
#pragma unroll
            for (int d = 0; d < D; ++d) {
              own += gc[j][1 + d] * p.nm[d] + gc[j][1 + D + d] * p.tl[d];
              cnm[d] = gc[j][1 + d] * wn;
              ctl[d] = gc[j][1 + D + d] * wn;
            }
            pull(c, m, s2, p, (fac + own) * wn, cnm, ctl);
          }
          pf.mark(kPwMember);
        }
      } else {
        // the closing's pullback, over the rank's members
        float xn[D];
        Real l2n[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          xn[d] = look ? x[(t + 1) * D + d] : 0.f;
          l2n[d] = look ? l2[(t + 1) * D + d] : Real(0.f);
        }
        for (int c = c0 + tid; c < c0 + Mr; c += nt) {
          Real m[D], s2[D], lp;
          carry(c, t, m, s2, lp);
          Prep<Real, D> p;
          prep<Real, D>(m, s2, xt, l2t, p);
          Real cb = Real(0.f), cnm[D], ctl[D];
#pragma unroll
          for (int d = 0; d < D; ++d) cnm[d] = ctl[d] = Real(0.f);
          if (!look) {
            // 2-frame closing: softmax posterior over the slots
            const Real fin = lp + isbl * tb.endv[c] - 0.5f * xlog(p.prod) -
                             p.quad - cl2pi;
            const Real q = xexp(fin - cmx) / csum;
            part[kEnd * K + c] += isbl * q;
            cb = q;
          } else {
            // look-ahead closing: q = posterior weight of child (c, a)
            const Real base_n = lp - p.quad - 0.5f * xlog(p.prod) - cl2pi;
            const Real inv_sum = 1.0f / csum;
            for (int a = 0; a < A; ++a) {
              const int ka = c * A + a, ak = a * K + c;
              Real r, invn[D], diffn[D];
              const Real gl =
                  base_n + tb.ltn[ka] + gate * tb.lsn[ka] +
                  isbl * tb.endn[ka] +
                  look_child<Real, D>(
                      p, xn, l2n,
                      VDT ? sg[t * P + a * st.S + c / st.KS] : tb.s2n[ka],
                      invn, diffn, r);
              const Real q = xexp(gl - cmx) * r * inv_sum;
              p_ltn[ak] += q;
              p_lsn[ak] += gate * q;
              p_endn[ak] += isbl * q;
              Real cs = Real(0.f);
#pragma unroll
              for (int d = 0; d < D; ++d) {
                const Real dn = diffn[d] * invn[d];
                const Real ct_totn =
                    0.5f * q * (diffn[d] * dn - 1.f) * invn[d];
                cnm[d] += q * dn;
                ctl[d] += ct_totn;
                cl2n[d] += ct_totn;
                cs += ct_totn;
              }
              // variable dt: this track's look-ahead cotangents, summed
              // into the stream after the step's barrier
              if constexpr (VDT)
                p_s2n[ak] = cs;
              else
                p_s2n[ak] += cs;
              cb += q;
            }
          }
          pull(c, m, s2, p, cb, cnm, ctl);
        }
        pf.mark(kPwLook);
      }
      // the step's l2 cotangents: block sums into this block's slots
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const Real v = block_sum(dl2s[d], red);
        if (tid == 0) slot[kSlotL2 + d] = v;
      }
      if (look)
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const Real v = block_sum(cl2n[d], red);
          if (tid == 0) slot[kSlotL2 + D + d] = v;
        }
      if (t == 1)
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const Real v = block_sum(c0s[d], red);
          if (tid == 0) slot[kSlotL2 + 2 * D + d] = v;
        }
      pf.mark(kPwSums);
      cl.sync();              // the exchange and the slots of step t
      pf.mark(kPwXchSync);
    }
    publish(1);
    cl.sync();                // step 1's reads before the next track
    pf.mark(kPwSums);
  }
  if constexpr (VDT) {
    // the look-ahead scratch out of the s2n partials (their table is
    // unused); every rank's reads of them ended at a cluster barrier
    for (int c = c0 + tid; c < c0 + Mr; c += nt)
      for (int a = 0; a < A; ++a) p_s2n[a * K + c] = Real(0.f);
  }
  pf.mark(kPwSetup);
#ifdef EXTRACK_PROFILE
  pf.flush(g_prof, tid == 0);
#endif
}



// Scalars of one warp's slice of shared memory in grad_warp_kernel: the
// publish area, the cotangent accumulators, two buffers of a track's
// positions and variances, two of its (T-1, P) displacement variances
// (variable dt, P > 0), its length and flag, and, when it lives there, the
// carry history.
static __host__ __device__ inline size_t warp_slice(int K, int A, int D,
                                                    int T, int stash_smem,
                                                    int P) {
  return (size_t)(9 + 4 * D) * K + (size_t)4 * K * A + (size_t)4 * T * D +
         (size_t)2 * (T - 1) * P + 4 +
         (stash_smem ? (size_t)(T - 1) * (2 * D + 1) * K : 0);
}

// Warp mapping, for K <= 64.  Warp w of block i walks tracks
// i * wpb + w, then + gridDim.x * wpb, ...; lane l owns slots l and, when
// J = 2 (K > 32), l + 32; lanes past K idle.  The walk is
// grad_kernel's, slot for slot, but a fusion step's exchange goes through
// the warp's own slice of shared memory between __syncwarp()s and every
// reduction over the slots is a warp shuffle: the walk has no block
// barrier.  The warp's slice (warp_slice) holds the publish area
// ((3+4D)K scalars), the cotangent accumulators of its tracks (6K for the
// (K,) tables, then 4KA, [table][pattern][slot]; lane-private), the
// track's positions, variances, (T-1, P) displacement variances (variable
// dt), length and flag, double-buffered: the next track's are copied in
// by cp.async while the warp walks this one; and, when stash_smem, the
// carry history ((T-1)(2D+1)K); else the history is the warp's slice of
// stash_all.
// At the end the block sums its warps' partials in warp order (its one
// barrier) into its row of `partial`.
template <typename Real, int D, int J, bool VDT>
__global__ void __launch_bounds__(kWarpBlock, (warp_min_blocks<Real, D>()))
    grad_warp_kernel(TablesT<Real> tb, const float* __restrict__ xs,
                     const Real* __restrict__ l2s,
                     const int* __restrict__ lengths,
                     const float* __restrict__ isbls, int B, int T,
                     Real* __restrict__ logl, Real* __restrict__ ct_l2,
                     Real* __restrict__ stash_all, Real* __restrict__ partial,
                     int stash_smem, StreamT<Real> st) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  const int K = tb.K, A = tb.A, G = K / A;
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const float cl2pi = 0.5f * D * kLog2Pi;
  // variable dt: patterns, states, slots per pattern and per newest digit
  const int P = VDT ? st.P : 0, SP = st.S, KP = st.KP, KS = st.KS;
  const int SG = (T - 1) * P;                 // a track's streamed scalars
  const size_t hist_n = (size_t)(T - 1) * (2 * D + 1) * K;
  const size_t pub_n = (size_t)(3 + 4 * D) * K;
  const size_t acc_n = (size_t)6 * K + (size_t)4 * K * A;
  const size_t slice = warp_slice(K, A, D, T, stash_smem, P);
  Real* const smem = reinterpret_cast<Real*>(sh_raw);
  Real* ws = smem + wib * slice;
  Real* sbase = ws;
  Real* srq = ws + K;
  Real* sclp = ws + (2 + 2 * D) * K;
  Real* scm = sclp + K;
  Real* scs2 = scm + D * K;
  Real* kacc = ws + pub_n;                    // (K,) tables' cotangents
  Real* pacc = kacc + 6 * K;                  // (K, A) tables'
  // two buffers of (T, D) variances, then (T, D) positions; two of the
  // (T-1, P) displacement variances (variable dt); length, flag
  Real* rows = kacc + acc_n;
  Real* sgb = rows + 4 * T * D;
  int* meta = reinterpret_cast<int*>(sgb + 2 * SG);
  const int gw = blockIdx.x * wpb + wib, nwarps = gridDim.x * wpb;
  Real* stash = stash_smem ? sgb + 2 * SG + 4
                           : stash_all + (size_t)gw * hist_n;

  int ks[J], pat[J], nw[J];
  bool act[J];
  // the (K,) accumulators, kacc[f * K + k]: lp0, s20, lt, lsurv, endv, sig2v
  enum { kLp0 = 0, kS20 = 1, kLt = 2, kLsurv = 3, kEnd = 4, kSig2v = 5 };
#pragma unroll
  for (int j = 0; j < J; ++j) {
    ks[j] = j * 32 + lane;
    act[j] = ks[j] < K;
    pat[j] = VDT && act[j] ? ks[j] / KP : 0;
    nw[j] = VDT && act[j] ? ks[j] / KS : 0;
    if (act[j]) {
      const int k = ks[j];
      for (int i = 0; i < 6 + 4 * A; ++i) kacc[i * K + k] = Real(0.f);
    }
  }
  // both of a lane's children in one fusion group (K = 64 at any A): one
  // fusion
  const bool one_group = J == 2 && ks[0] % G == ks[J - 1] % G;
  Prof pf;
  pf.start();

  // track bb's rows, length and flag into buffer `buf`, asynchronously
  const int TD = T * D;
  auto fetch = [&](int bb, int buf) {
    Real* l2d = rows + buf * 2 * TD;
    float* xd = reinterpret_cast<float*>(l2d + TD);
    for (int i = lane; i < TD; i += 32) {
      __pipeline_memcpy_async(l2d + i, l2s + (size_t)bb * TD + i,
                              sizeof(Real));
      __pipeline_memcpy_async(xd + i, xs + (size_t)bb * TD + i,
                              sizeof(float));
    }
    if constexpr (VDT) {
      Real* sgd = sgb + buf * SG;
      for (int i = lane; i < SG; i += 32)
        __pipeline_memcpy_async(sgd + i, st.s2 + (size_t)bb * SG + i,
                                sizeof(Real));
    }
    if (lane == 0) {
      __pipeline_memcpy_async(meta + 2 * buf, lengths + bb, sizeof(int));
      __pipeline_memcpy_async(meta + 2 * buf + 1, isbls + bb, sizeof(float));
    }
    __pipeline_commit();
  };
  if (gw < B) fetch(gw, 0);
  int buf = 0;
  for (int b = gw; b < B; b += nwarps, buf ^= 1) {
    __pipeline_wait_prior(0);
    __syncwarp();           // this track's rows landed; the last one's read
    const Real* l2 = rows + buf * 2 * TD;
    const float* x = reinterpret_cast<const float*>(l2 + TD);
    const int L = min(meta[2 * buf], T);
    const float isbl = __int_as_float(meta[2 * buf + 1]);
    if (b + nwarps < B) fetch(b + nwarps, buf ^ 1);
    if (L < 2) {            // empty / 1-frame rows: logL 0, ct_l2 stays 0
      if (lane == 0) logl[b] = Real(0.f);
      continue;
    }
    Real* cl2 = ct_l2 + (size_t)b * T * D;
    const Real* sg = sgb + buf * SG;              // variable dt only
    Real* csg = VDT ? st.ct + (size_t)b * SG : nullptr;
    const int tlast = L == 2 ? 1 : L - 2;

    // forward walk (track_forward), stashing each step's entering carry
    Real m[J][D], s2[J][D], lp[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      lp[j] = act[j] ? tb.lp0[ks[j]] : Real(0.f);
      const Real s20 =
          act[j] ? (VDT ? sg[pat[j]] : tb.s20[ks[j]]) : Real(1.f);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        m[j][d] = Real(x[d]);
        s2[j][d] = l2[d] + s20;
      }
    }
    Real cmx = Real(0.f), csum = Real(1.f), out = Real(0.f);
    for (int t = 1; t <= tlast; ++t) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (!act[j]) continue;
        Real* row = stash + (size_t)(t - 1) * (2 * D + 1) * K + ks[j];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          row[d * K] = m[j][d];
          row[(D + d) * K] = s2[j][d];
        }
        row[2 * D * K] = lp[j];
      }
      pf.mark(kPfStash);
      float xt[D];
      Real l2t[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xt[d] = x[t * D + d];
        l2t[d] = l2[t * D + d];
      }
      Prep<Real, D> p[J];
#pragma unroll
      for (int j = 0; j < J; ++j) prep<Real, D>(m[j], s2[j], xt, l2t, p[j]);
      const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;
      if (L == 2) {
        Real fin[J], mx = Real(-INFINITY);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          fin[j] = act[j] ? lp[j] + isbl * tb.endv[ks[j]] -
                                0.5f * xlog(p[j].prod) - p[j].quad - cl2pi
                          : Real(-INFINITY);
          mx = shift_max(mx, fin[j]);
        }
        mx = warp_max(mx);
        Real e = Real(0.f);
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (act[j]) e += xexp(fin[j] - mx);
        cmx = mx;
        csum = warp_sum(e);
        out = mx + xlog(csum);
        pf.mark(kPfClose);
      } else if (t == tlast) {
        float xn[D];
        Real l2n[D], invn[D], diffn[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          xn[d] = x[(t + 1) * D + d];
          l2n[d] = l2[(t + 1) * D + d];
        }
        Real gmax = Real(-INFINITY);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const Real base_n =
              lp[j] - p[j].quad - 0.5f * xlog(p[j].prod) - cl2pi;
          for (int a = 0; a < A; ++a) {
            const int ka = ks[j] * A + a;
            Real r;
            const Real g =
                base_n + tb.ltn[ka] + gate * tb.lsn[ka] + isbl * tb.endn[ka] +
                look_child<Real, D>(
                    p[j], xn, l2n,
                    VDT ? sg[t * P + a * SP + nw[j]] : tb.s2n[ka], invn,
                    diffn, r);
            gmax = shift_max(gmax, g);
          }
        }
        const Real mx = warp_max(gmax);
        Real sl = Real(0.f);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const Real base_n =
              lp[j] - p[j].quad - 0.5f * xlog(p[j].prod) - cl2pi;
          for (int a = 0; a < A; ++a) {
            const int ka = ks[j] * A + a;
            Real r;
            const Real g =
                base_n + tb.ltn[ka] + gate * tb.lsn[ka] + isbl * tb.endn[ka] +
                look_child<Real, D>(
                    p[j], xn, l2n,
                    VDT ? sg[t * P + a * SP + nw[j]] : tb.s2n[ka], invn,
                    diffn, r);
            sl += xexp(g - mx) * r;
          }
        }
        cmx = mx;
        csum = warp_sum(sl);
        out = mx + xlog(csum);
        pf.mark(kPfClose);
      } else {
        // fusion: publish, then each child reads its group's members
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const int k = ks[j];
          sbase[k] = lp[j] - p[j].quad;
          srq[k] = xrsqrt(p[j].prod);
#pragma unroll
          for (int d = 0; d < D; ++d) {
            ws[(2 + d) * K + k] = p[j].nm[d];
            ws[(2 + D + d) * K + k] = p[j].tl[d];
          }
        }
        __syncwarp();
        Real mx, sw, mf[D], tf[D], inv_sw, lse;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          if (j == 0 || !one_group) {
            group_sums<Real, D>(ws, K, (ks[j] % G) * A, A, mx, sw, mf, tf);
            inv_sw = 1.0f / clamp_min(sw, kTiny);
            lse = mx + xlog(clamp_min(sw, kTiny));
          }
          const Real sv = VDT ? sg[t * P + pat[j]] : tb.sig2v[ks[j]];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            m[j][d] = mf[d] * inv_sw;
            s2[j][d] = sv + tf[d] * inv_sw;
          }
          lp[j] = lse + tb.lt[ks[j]] + gate * tb.lsurv[ks[j]];
        }
        __syncwarp();
        pf.mark(kPfStep);
      }
    }
    if (lane == 0) logl[b] = out;

    // backward walk; (cm, cs2, clp) is the cotangent of the carry that
    // step t produced, i.e. of the lane's slots entering step t+1
    Real cm[J][D], cs2[J][D], clp[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      clp[j] = Real(0.f);
#pragma unroll
      for (int d = 0; d < D; ++d) cm[j][d] = cs2[j][d] = Real(0.f);
    }
    for (int t = tlast; t >= 1; --t) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        lp[j] = Real(0.f);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          m[j][d] = Real(0.f);
          s2[j][d] = Real(1.f);
        }
        if (act[j]) {
          const Real* row = stash + (size_t)(t - 1) * (2 * D + 1) * K + ks[j];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            m[j][d] = row[d * K];
            s2[j][d] = row[(D + d) * K];
          }
          lp[j] = row[2 * D * K];
        }
      }
      pf.mark(kPfStashRead);
      float xt[D];
      Real l2t[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xt[d] = x[t * D + d];
        l2t[d] = l2[t * D + d];
      }
      Prep<Real, D> p[J];
#pragma unroll
      for (int j = 0; j < J; ++j) prep<Real, D>(m[j], s2[j], xt, l2t, p[j]);
      const float gate = (t + 1 >= tb.min_len) ? 1.f : 0.f;
      pf.mark(kPfPrep);

      Real cb[J], cnm[J][D], ctl[J][D];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        cb[j] = Real(0.f);
#pragma unroll
        for (int d = 0; d < D; ++d) cnm[j][d] = ctl[j][d] = Real(0.f);
      }
      if (L == 2) {
        // 2-frame closing: softmax posterior over the slots
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const Real fin = lp[j] + isbl * tb.endv[ks[j]] -
                           0.5f * xlog(p[j].prod) - p[j].quad - cl2pi;
          const Real q = xexp(fin - cmx) / csum;
          kacc[kEnd * K + ks[j]] += isbl * q;
          cb[j] = q;
        }
        pf.mark(kPfCloseBwd);
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
        const Real inv_sum = 1.0f / csum;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const int k = ks[j];
          const Real base_n =
              lp[j] - p[j].quad - 0.5f * xlog(p[j].prod) - cl2pi;
          for (int a = 0; a < A; ++a) {
            const int ka = k * A + a;
            Real r;
            const Real g =
                base_n + tb.ltn[ka] + gate * tb.lsn[ka] + isbl * tb.endn[ka] +
                look_child<Real, D>(
                    p[j], xn, l2n,
                    VDT ? sg[t * P + a * SP + nw[j]] : tb.s2n[ka], invn,
                    diffn, r);
            const Real q = xexp(g - cmx) * r * inv_sum;
            pacc[(0 * A + a) * K + k] += q;
            pacc[(2 * A + a) * K + k] += gate * q;
            pacc[(3 * A + a) * K + k] += isbl * q;
            Real cs = Real(0.f);
#pragma unroll
            for (int d = 0; d < D; ++d) {
              const Real dn = diffn[d] * invn[d];
              const Real ct_totn = 0.5f * q * (diffn[d] * dn - 1.f) * invn[d];
              cnm[j][d] += q * dn;
              ctl[j][d] += ct_totn;
              cl2n[d] += ct_totn;
              cs += ct_totn;
            }
            // variable dt: the s2n accumulators hold this track's
            // look-ahead cotangents, summed into the stream below
            if constexpr (VDT)
              pacc[(1 * A + a) * K + k] = cs;
            else
              pacc[(1 * A + a) * K + k] += cs;
            cb[j] += q;
          }
        }
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const Real v = warp_sum(cl2n[d]);
          if (lane == 0) cl2[(t + 1) * D + d] = v;
        }
        if constexpr (VDT) {
          // row t, pattern q = a*S + s: child (kk, a) over the slots kk of
          // newest digit s
          __syncwarp();
          for (int q = lane; q < P; q += 32) {
            const int a = q / SP, s0 = (q % SP) * KS;
            Real v = Real(0.f);
            for (int kk = s0; kk < s0 + KS; ++kk)
              v += pacc[(1 * A + a) * K + kk];
            csg[t * P + q] = v;
          }
        }
        pf.mark(kPfCloseBwd);
      } else {
        // fusion pullback: the children's cotangents go through the warp's
        // slice to their group's members, next to the members' update
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const int k = ks[j];
          kacc[kLt * K + k] += clp[j];
          kacc[kLsurv * K + k] += gate * clp[j];
          if constexpr (!VDT) {
            Real cs = Real(0.f);
#pragma unroll
            for (int d = 0; d < D; ++d) cs += cs2[j][d];
            kacc[kSig2v * K + k] += cs;
          }
          sbase[k] = lp[j] - p[j].quad;
          srq[k] = xrsqrt(p[j].prod);
          sclp[k] = clp[j];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            ws[(2 + d) * K + k] = p[j].nm[d];
            ws[(2 + D + d) * K + k] = p[j].tl[d];
            scm[d * K + k] = cm[j][d];
            scs2[d * K + k] = cs2[j][d];
          }
        }
        __syncwarp();
        if constexpr (VDT) {
          // row t: the children's variance cotangents over each pattern's
          // slots
          for (int q = lane; q < P; q += 32) {
            Real v = Real(0.f);
            for (int kk = q * KP; kk < (q + 1) * KP; ++kk)
#pragma unroll
              for (int d = 0; d < D; ++d) v += scs2[d * K + kk];
            csg[t * P + q] = v;
          }
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (!act[j]) continue;
          const int k = ks[j];
          const int g = k / A;           // this slot's fusion group
          Real mx, sw, mf[D], tf[D], cmf[D], ctf[D];
          group_sums<Real, D>(ws, K, g * A, A, mx, sw, mf, tf);
#pragma unroll
          for (int d = 0; d < D; ++d) cmf[d] = ctf[d] = Real(0.f);
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
            own += cmf[d] * p[j].nm[d] + ctf[d] * p[j].tl[d];
          }
          cb[j] = (ok * fac + own) * wn;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            cnm[j][d] = cmf[d] * wn;
            ctl[j][d] = ctf[d] * wn;
          }
        }
        __syncwarp();
        pf.mark(kPfFuseBwd);
      }
      Real dl2s[D];
#pragma unroll
      for (int d = 0; d < D; ++d) dl2s[d] = Real(0.f);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        Real dm[D], ds2[D], dl2[D];
        prep_bwd<Real, D>(m[j], s2[j], xt, l2t, p[j], cb[j], cnm[j], ctl[j],
                          dm, ds2, dl2);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          if (act[j]) dl2s[d] += dl2[d];
          cm[j][d] = act[j] ? dm[d] : Real(0.f);
          cs2[j][d] = act[j] ? ds2[d] : Real(0.f);
        }
        clp[j] = act[j] ? cb[j] : Real(0.f);
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const Real v = warp_sum(dl2s[d]);
        if (lane == 0) cl2[t * D + d] = v;
      }
      pf.mark(kPfL2Sum);
    }
    // initial register: m = x_0 (no parameter), s2 = l2_0 + s20, lp = lp0
#pragma unroll
    for (int d = 0; d < D; ++d) {
      Real c = Real(0.f);
#pragma unroll
      for (int j = 0; j < J; ++j) c += cs2[j][d];
      const Real v = warp_sum(c);
      if (lane == 0) cl2[d] = v;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (!act[j]) continue;
      Real cs = Real(0.f);
#pragma unroll
      for (int d = 0; d < D; ++d) cs += cs2[j][d];
      kacc[kLp0 * K + ks[j]] += clp[j];
      if constexpr (VDT)
        sbase[ks[j]] = cs;
      else
        kacc[kS20 * K + ks[j]] += cs;
    }
    if constexpr (VDT) {
      // row 0: the s20 cotangents over each pattern's slots (the next
      // track's first __syncwarp keeps sbase until they are read)
      __syncwarp();
      for (int q = lane; q < P; q += 32) {
        Real v = Real(0.f);
        for (int kk = q * KP; kk < (q + 1) * KP; ++kk) v += sbase[kk];
        csg[q] = v;
      }
    }
    pf.mark(kPfInit);
  }
  if constexpr (VDT) {
    // the look-ahead scratch out of the s2n partials (their table is unused)
    __syncwarp();
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (act[j])
        for (int a = 0; a < A; ++a) pacc[(1 * A + a) * K + ks[j]] = Real(0.f);
  }
  // the block's partial: every column summed over the warps in warp order
  __syncthreads();
  const int ncols = 6 * K + 4 * K * A;
  Real* part = partial + (size_t)blockIdx.x * ncols;
  for (int col = threadIdx.x; col < ncols; col += blockDim.x) {
    // (K, A) column f*K*A + k*A + a sits at [f][a][k] in the accumulators
    const int c = col - 6 * K, f = c / (K * A), k = (c % (K * A)) / A;
    const size_t off = pub_n + (col < 6 * K ? (size_t)col
                                            : 6 * (size_t)K +
                                                  (size_t)(f * A + c % A) * K +
                                                  k);
    Real acc = Real(0.f);
    for (int w = 0; w < wpb; ++w) acc += smem[w * slice + off];
    part[col] = acc;
  }
  pf.mark(kPfPartials);
#ifdef EXTRACK_PROFILE
  pf.flush(g_prof, lane == 0);
#endif
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

// reduce_partials for the cluster mapping's rows, whose (K, A) columns are
// pattern-major: out[6K + f*K*A + c*A + a] sums partial[..][6K + f*K*A +
// a*K + c], in row order, in double.  `width` floats a scalar (2: Dual).
static __global__ void reduce_partials_ak(const float* __restrict__ partial,
                                          int nrow, int ncols, int K, int A,
                                          int width,
                                          float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ncols) return;
  const int col = j / width, part = j % width;
  int src = col;
  if (col >= 6 * K) {
    const int ka = (col - 6 * K) % (K * A);
    src = col - ka + (ka % A) * K + ka / A;
  }
  src = src * width + part;
  double s = 0.0;
  for (int i = 0; i < nrow; ++i) s += partial[(size_t)i * ncols + src];
  out[j] = (float)s;
}

// The kernel instantiation that launch_grad runs for this K and mapping
// (warps > 0: the warp mapping with `warps` warps per block; 0 the block
// mapping; -1 the wide mapping, -2 the wide mapping with its exchange in
// global scratch).
template <typename Real, int D, bool VDT>
static const void* grad_instance(int K, int warps) {
  if (warps < 0) return (const void*)grad_cluster_kernel<Real, D, VDT>;
  if (warps > 0)
    return K <= 32 ? (const void*)grad_warp_kernel<Real, D, 1, VDT>
                   : (const void*)grad_warp_kernel<Real, D, 2, VDT>;
  const int threads = (K + 31) / 32 * 32;
  return threads <= kBlockSmall
             ? (const void*)grad_kernel<Real, D, kBlockSmall, VDT>
         : threads <= kBlockMid
             ? (const void*)grad_kernel<Real, D, kBlockMid, VDT>
             : (const void*)grad_kernel<Real, D, 1024, VDT>;
}

// grad_instance with P > 0 for variable dt.
template <typename Real, int D>
static const void* grad_instance(int K, int warps, int P) {
  return P > 0 ? grad_instance<Real, D, true>(K, warps)
               : grad_instance<Real, D, false>(K, warps);
}

// Dynamic shared memory of one block, as launch_grad asks for it (C: the
// wide mapping's blocks a cluster).
template <typename Real>
static size_t grad_smem(int K, int A, int D, int T, int warps,
                        int stash_smem, int P, int C) {
  if (warps < 0)
    return grad_wide_layout(K, A, D, T, C, warps == -2, sizeof(Real)).smem;
  return (warps > 0 ? warps * warp_slice(K, A, D, T, stash_smem, P)
                    : (size_t)(3 + 4 * D) * K) *
         sizeof(Real);
}

// Threads of one block of a launch.
static int grad_threads(int K, int A, int D, int T, int warps, int C) {
  if (warps < 0) return grad_wide_layout(K, A, D, T, C, false, 4).threads;
  return warps > 0 ? 32 * warps : (K + 31) / 32 * 32;
}

// Blocks of a K2 (or K3) launch on the warp or block mapping one SM keeps
// resident, or -error.
template <typename Real, int D>
static int grad_occupancy(int K, int A, int T, int warps, int stash_smem,
                          int P) {
  if (warps < 0) return -(int)cudaErrorInvalidValue;
  const void* fn = grad_instance<Real, D>(K, warps, P);
  const size_t smem = grad_smem<Real>(K, A, D, T, warps, stash_smem, P, 1);
  const int threads = grad_threads(K, A, D, T, warps, 1);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads,
                                                        smem);
  return err == cudaSuccess ? n : -(int)err;
}

// A cluster launch's configuration: nblk blocks in clusters of C, and the
// attributes a cluster of more than 8 blocks needs; the dynamic shared
// memory opted in.
static cudaError_t cluster_config(const void* fn, int nblk, int threads,
                                  size_t smem, int C, cudaStream_t stream,
                                  cudaLaunchAttribute* attr,
                                  cudaLaunchConfig_t* cfg) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(nblk);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

// Clusters of C blocks of one K2 (or K3) launch on the wide mapping
// (warps -1 or -2) that the card keeps resident at once, or -error.
template <typename Real, int D>
static int grad_cluster_occupancy(int K, int A, int T, int warps, int C,
                                  int P) {
  if (C < 1 || C > kGradClusterMax || (warps != -1 && warps != -2))
    return -(int)cudaErrorInvalidValue;
  const void* fn = grad_instance<Real, D>(K, warps, P);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(
      fn, C, grad_threads(K, A, D, T, warps, C),
      grad_smem<Real>(K, A, D, T, warps, 0, P, C), C, 0, &attr, &cfg);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename Real, int D>
static int launch_grad(const TablesT<Real>& tb, const float* xs,
                       const Real* l2, const int* lengths, const float* isbl,
                       Real* logl, Real* ct_l2, Real* ct_tab, Real* stash,
                       Real* partial, StreamT<Real> st, int B, int T,
                       int nblk, int warps, int stash_smem, int C,
                       cudaStream_t stream) {
  const int K = tb.K, P = st.P;
  // the partial row's columns, as floats (a Dual column is two)
  const size_t ncols = ((size_t)6 * K + (size_t)4 * K * tb.A) *
                       (sizeof(Real) / sizeof(float));
  const bool clustered = warps < 0;
  if (clustered &&
      (C < 1 || C > kGradClusterMax || nblk % C != 0 ||
       (K / tb.A + C - 1) / C > kGradWideGroups * kGradWideThreads))
    return (int)cudaErrorInvalidValue;
  if (!clustered && C != 1) return (int)cudaErrorInvalidValue;
  if (ncols > (size_t)INT_MAX || warps < -2 || 32 * warps > kWarpBlock ||
      (warps > 0 && K > 64) ||
      (warps == 0 && K > 1024) || (warps <= 0 && stash_smem) ||
      (warps < 0 && K > kGradWideMaxK) ||
      P < 0 ||
      (P > 0 && (st.s2 == nullptr || st.ct == nullptr || P % tb.A != 0 ||
                 K % P != 0 || T < 2)))
    return (int)cudaErrorInvalidValue;
  const void* fn = grad_instance<Real, D>(K, warps, P);
  const size_t smem =
      grad_smem<Real>(K, tb.A, D, T, warps, stash_smem, P, C);
  const int threads = grad_threads(K, tb.A, D, T, warps, C);
  if (clustered) {
    int flag = warps == -2;
    void* args[] = {(void*)&tb, (void*)&xs, (void*)&l2, (void*)&lengths,
                    (void*)&isbl, (void*)&B, (void*)&T, (void*)&logl,
                    (void*)&ct_l2, (void*)&stash, (void*)&partial,
                    (void*)&flag, (void*)&st};
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    const cudaError_t err =
        cluster_config(fn, nblk, threads, smem, C, stream, &attr, &cfg);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchKernelExC(&cfg, fn, args);
  } else if (warps != 0) {
    void* args[] = {(void*)&tb, (void*)&xs, (void*)&l2, (void*)&lengths,
                    (void*)&isbl, (void*)&B, (void*)&T, (void*)&logl,
                    (void*)&ct_l2, (void*)&stash, (void*)&partial,
                    (void*)&stash_smem, (void*)&st};
    // the opt-in covers the static shared memory's share of the 48 KB too
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaLaunchKernel(fn, nblk, threads, args, smem, stream);
  } else {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    void* args[] = {(void*)&tb, (void*)&xs, (void*)&l2, (void*)&lengths,
                    (void*)&isbl, (void*)&B, (void*)&T, (void*)&logl,
                    (void*)&ct_l2, (void*)&stash, (void*)&partial,
                    (void*)&st};
    cudaLaunchKernel(fn, nblk, threads, args, smem, stream);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (clustered) {
    // one row of partials a cluster, its (K, A) columns pattern-major
    reduce_partials_ak<<<(unsigned)((ncols + 255) / 256), 256, 0, stream>>>(
        reinterpret_cast<const float*>(partial), nblk / C, (int)ncols, K,
        tb.A, (int)(sizeof(Real) / sizeof(float)),
        reinterpret_cast<float*>(ct_tab));
    return (int)cudaGetLastError();
  }
  reduce_partials<<<(unsigned)((ncols + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float*>(partial), nblk, (int)ncols,
      reinterpret_cast<float*>(ct_tab));
  return (int)cudaGetLastError();
}

// The C entry points of K2 and K3 share one argument list; Real is float
// (K2) or Dual (K3), every Real array given as floats (a Dual array as
// interleaved value / tangent pairs).  sig2s / ct_s2: the (B, T-1, P)
// stream and its cotangent for variable dt (P > 0), else null.
template <typename Real>
static int launch_grad_c(const float* xs, const float* l2,
                         const int* lengths, const float* isbl,
                         const float* const* tabs, const float* sig2s,
                         float* logl, float* ct_l2, float* ct_tab,
                         float* ct_s2, float* stash, float* partial, int B,
                         int T, int D, int K, int A, int P, int min_len,
                         int nblk, int warps, int stash_smem, int cluster,
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
  const StreamT<Real> sm{reinterpret_cast<const Real*>(sig2s),
                         reinterpret_cast<Real*>(ct_s2), P,
                         P > 0 ? P / A : 1, P > 0 ? K / P : 1,
                         P > 0 ? K * A / P : 1};
  switch (D) {
    case 1:
      return launch_grad<Real, 1>(tb, xs, l2r, lengths, isbl, lo, cl, ct, sa,
                                  pa, sm, B, T, nblk, warps, stash_smem,
                                  cluster, st);
    case 2:
      return launch_grad<Real, 2>(tb, xs, l2r, lengths, isbl, lo, cl, ct, sa,
                                  pa, sm, B, T, nblk, warps, stash_smem,
                                  cluster, st);
    case 3:
      return launch_grad<Real, 3>(tb, xs, l2r, lengths, isbl, lo, cl, ct, sa,
                                  pa, sm, B, T, nblk, warps, stash_smem,
                                  cluster, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Occupancy query behind extrack_grad_occupancy / extrack_hvp_occupancy.
template <typename Real>
static int grad_occupancy_c(int D, int K, int A, int T, int warps,
                            int stash_smem, int P) {
  switch (D) {
    case 1: return grad_occupancy<Real, 1>(K, A, T, warps, stash_smem, P);
    case 2: return grad_occupancy<Real, 2>(K, A, T, warps, stash_smem, P);
    case 3: return grad_occupancy<Real, 3>(K, A, T, warps, stash_smem, P);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// Cluster occupancy behind extrack_grad_cluster_occupancy /
// extrack_hvp_cluster_occupancy.
template <typename Real>
static int grad_cluster_occupancy_c(int D, int K, int A, int T, int warps,
                                    int C, int P) {
  switch (D) {
    case 1: return grad_cluster_occupancy<Real, 1>(K, A, T, warps, C, P);
    case 2: return grad_cluster_occupancy<Real, 2>(K, A, T, warps, C, P);
    case 3: return grad_cluster_occupancy<Real, 3>(K, A, T, warps, C, P);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace extrack
