// K2: all FiLM residual blocks of one generator stage in one kernel.
//
// Replaces the Pallas kernel ttsx/ops/resblock_stack_kernel.py (_stack_impl,
// body _make_kernel; public film_resblock_stack_pallas). The film arrives
// at the conditioning rate [Bf, Tf, 2nC] (per block: scale_i | shift_i);
// time step t reads row (t * Tf) / T and x's batch row b reads film row
// b % Bf. The device code, its bound and its design are in
// film_resblock.cuh, shared with K5 (resblock.cu). With dilations 1, 3, 5
// a CTA's halo is 12 rows on each side.
//
// Layouts (row-major, f32): x, y [B, T, C]; film [Bf, Tf, 2nC];
// w1s [n, 3, C, 2C]; b1s [n, 2C]; w2s [n, 3, C, C]; b2s [n, C].
#include "film_resblock.cuh"

extern "C" int ttsx_resblock_stack_f32(const float* x, const float* film,
                                       const float* w1s, const float* b1s,
                                       const float* w2s, const float* b2s,
                                       float* y, int B, int T, int C, int Bf,
                                       int Tf, int n_blocks, int d0, int d1,
                                       int d2, int d3, void* stream) {
  if (Bf <= 0 || Tf <= 0) return (int)cudaErrorInvalidValue;
  const film_resblock::StackFilm f{film, Bf, Tf, T, C, n_blocks};
  const film_resblock::Dilations dil = {{d0, d1, d2, d3}};
  return (int)film_resblock::launch(x, f, w1s, b1s, w2s, b2s, y, B, T, C,
                                    n_blocks, dil, (cudaStream_t)stream);
}
