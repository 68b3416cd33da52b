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
// The block mapping's device code is hist_block.cuh: this unit holds its
// constant-dt instantiations and the C interface, hist_vdt.cu the
// variable-dt ones.  Past 1024 slots K5 runs its wide mapping, a thread a
// fusion group, in hist_wide.cu.  Three units that nvcc compiles side by
// side.
#include "hist_block.cuh"

namespace extrack {

// The instantiation for the launch: the wide mapping (hist_wide.cu; any
// number of sub-steps), variable dt (P > 0; hist_vdt.cu), more than one
// sub-step (A > S).
template <int D>
static int launch_dt(const HistArgs& h, int nblk, cudaStream_t stream) {
  if (h.wide) return hist_wide_launch(h, D, nblk, stream);
  if (h.P > 0) return hist_vdt_launch(h, D, nblk, stream);
  return h.tb.A > h.S ? launch_hist<D, false, true>(h, nblk, stream)
                      : launch_hist<D, false, false>(h, nblk, stream);
}

}  // namespace extrack

// Reads and zeroes K5's cycle split, the three translation units' kernels
// summed (profile builds; zeros otherwise).
extern "C" int extrack_hist_prof(unsigned long long* out) {
  unsigned long long zero[extrack::kProfSlots] = {};
  cudaError_t err =
      cudaMemcpyFromSymbol(out, extrack::g_hist_prof, sizeof zero);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(extrack::g_hist_prof, zero, sizeof zero);
  if (err == cudaSuccess) err = (cudaError_t)extrack::hist_vdt_prof(out);
  if (err != cudaSuccess) return (int)err;
  return extrack::hist_wide_prof(out);
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

// The largest register of K5's launch with `wide` (0 a thread a slot, 1
// and 2 the wide mapping with the static segment tables, 3 the harvest
// from the slots' digits).
static int hist_max_k(int wide) {
  return wide == 3 ? extrack::kHistRunsMaxK
                   : wide ? extrack::kHistWideMaxK : 1024;
}

// K5's block for a launch (hist_layout; wide: 1 the wide mapping, 2 the
// wide mapping with its publish areas and member weights in global
// scratch, K <= 16384; 3 as 2 with the harvest from the slots' digits, K
// <= 2^19; 0 a thread a slot): out = threads, shared bytes besides the
// rows, row bytes per track (at 2 and 3: all the block's scratch).
extern "C" int extrack_hist_layout(int T, int D, int K, int S, int A,
                                   int wide, long long* out) {
  if (A < 1 || K % A || wide < 0 || wide > 3 || (wide && K > hist_max_k(wide)))
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
// (ops/hist_kernel.device_segment_tables; null at wide 3, whose harvest
// reads each slot's runs from its digits).  Output: rows (B, S*T), each track's
// expected histogram (bin s*T + m: segments of length m+1 in state s;
// zero for tracks of fewer than 2 frames).  scratch: null to keep the
// double-buffered rows in shared memory, or nblk times the row bytes of
// extrack_hist_layout in global scratch.  wide: 1 the wide mapping (a
// thread per fusion group, K <= 16384), 2 the same with its publish areas
// and member weights in that scratch too (scratch required), 3 as 2 with
// the harvest from the slots' digits (K <= 2^19, S*Wf <= kRunsMaxBins), 0
// a thread per slot (K <= 1024).  Blocks are persistent over nblk.
// Returns cudaGetLastError().
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
      wide < 0 || wide > 3 || (wide >= 2 && scratch == nullptr) ||
      K > hist_max_k(wide) ||
      (wide == 3 ? S * Wf > extrack::kRunsMaxBins
                 : seg == nullptr || ext == nullptr))
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
