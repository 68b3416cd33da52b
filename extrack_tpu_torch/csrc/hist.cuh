// K5's declarations shared by its three translation units: hist.cu (a
// thread a slot, up to 1024 slots, constant dt, and the C interface),
// hist_vdt.cu (the same with variable dt) and hist_wide.cu (a thread a
// fusion group past 1024 slots: the wide kernels, their global-scratch
// variant and, past 16384 slots, the harvest from each slot's digits).
// Three units so that nvcc compiles them in parallel.
#pragma once

#include "common.cuh"

namespace extrack {

// Sections of K5's cycle split (tools/walk_profile.py --split).
enum {
  kHsZero = 0, kHsFusion = 1, kHsTransport = 2, kHsBarrier = 3,
  kHsHarvest = 4
};

constexpr int kHistWideThreads = 1024;  // the wide block's largest size
constexpr int kHistWideMaxK = 16384;    // the wide mapping with seg tables
constexpr int kHistRunsMaxK = 1 << 19;  // the harvest from the digits
// (state, run length) bins of the digits' harvest a thread keeps: S * Wf
constexpr int kRunsMaxBins = 64;

// The launch's arguments besides its geometry.
struct HistArgs {
  Tables tb;
  const float *xs, *l2, *isbl, *s2st, *seg;
  const int *lengths, *ext;
  float *rows, *scratch;
  int B, T, S, P, Wf;
  int wide;     // 0: a thread a slot; 1: the wide mapping; 2: the wide
                // mapping with its publish areas and weights in scratch;
                // 3: as 2, the harvest from each slot's digits (no seg)
};

// K5's block for T frames, D dimensions, K slots at S states and A
// children a fusion group: a thread per slot; shared memory besides the
// rows: two fusion publish areas of (2+2D)*K floats, the softmax over the
// register and three per-slot int constants (c % S, c % G, the oldest
// run's length).  Carry: the double-buffered run and histogram rows,
// (1+S)*T floats for each of the K/A fusion groups (the A children of a
// group carry the same rows).  The wide mapping: a thread per group (at
// most 1024), shared memory besides the rows two publish areas of
// (2D+1)*G floats and K floats of member weights; the same rows.  wide = 2
// and 3: the wide mapping with its publish areas and member weights in
// the carry (global scratch) after the rows, and no dynamic shared memory.
static inline BlockLayout hist_layout(int T, int D, int K, int S, int A,
                                      int wide) {
  const int G = K / A;
  const size_t carry = (size_t)2 * G * (1 + S) * T * sizeof(float);
  if (wide) {
    const int threads = (G + 31) / 32 * 32;
    const size_t pub = ((size_t)2 * (2 * D + 1) * G + K) * sizeof(float);
    return {threads < kHistWideThreads ? threads : kHistWideThreads,
            wide >= 2 ? 0 : pub, wide >= 2 ? carry + pub : carry};
  }
  return {(K + 31) / 32 * 32,
          (size_t)(2 * (2 + 2 * D) + 4) * K * sizeof(float), carry};
}

// hist_vdt.cu: launches the block mapping with variable dt (h.P > 0) at D
// dimensions; returns cudaGetLastError().
int hist_vdt_launch(const HistArgs& h, int D, int nblk,
                    cudaStream_t stream);
// hist_vdt.cu: adds its kernels' cycle split to out[kProfSlots] and zeroes
// it (profile builds; zeros otherwise).
int hist_vdt_prof(unsigned long long* out);
// hist_wide.cu: launches the wide mapping (h.wide 1, 2 or 3) at D
// dimensions; returns cudaGetLastError().
int hist_wide_launch(const HistArgs& h, int D, int nblk,
                     cudaStream_t stream);
// hist_wide.cu: adds the wide kernels' cycle split to out[kProfSlots] and
// zeroes it (profile builds; zeros otherwise).
int hist_wide_prof(unsigned long long* out);

}  // namespace extrack
