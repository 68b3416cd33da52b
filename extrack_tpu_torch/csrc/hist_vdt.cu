// K5's variable-dt instantiations of the block mapping (hist_block.cuh):
// the same walk reading the (B, T-1, P) stream, in a translation unit of
// its own so that nvcc compiles them beside hist.cu's constant-dt ones.
#include "hist_block.cuh"

namespace extrack {

template <int D>
static int launch_vdt(const HistArgs& h, int nblk, cudaStream_t stream) {
  return h.tb.A > h.S ? launch_hist<D, true, true>(h, nblk, stream)
                      : launch_hist<D, true, false>(h, nblk, stream);
}

int hist_vdt_launch(const HistArgs& h, int D, int nblk,
                    cudaStream_t stream) {
  switch (D) {
    case 1: return launch_vdt<1>(h, nblk, stream);
    case 2: return launch_vdt<2>(h, nblk, stream);
    case 3: return launch_vdt<3>(h, nblk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int hist_vdt_prof(unsigned long long* out) {
  unsigned long long v[kProfSlots], zero[kProfSlots] = {};
  cudaError_t err = cudaMemcpyFromSymbol(v, g_hist_prof, sizeof v);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_hist_prof, zero, sizeof zero);
  if (err == cudaSuccess)
    for (int i = 0; i < kProfSlots; ++i) out[i] += v[i];
  return (int)err;
}

}  // namespace extrack
