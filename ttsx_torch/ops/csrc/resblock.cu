// K5: one FiLM residual block, FiLM at full rate.
//
// Replaces the Pallas kernel ttsx/ops/resblock_kernel.py (_resblock_impl,
// body _make_kernel; public film_resblock_pallas), which the reference
// runs per block through FiLMResidualBlock(use_pallas=True). On x, scale
// and shift [B, T, C] (the FiLM Dense output already gathered to x's
// rate), with one dilation d:
//     y = x + conv3(lrelu(glu(conv3_d(lrelu(x))) * (1 + scale) + shift))
// It runs the device code of K2 (film_resblock.cuh) with one block and
// the scale and shift read through their own pointers (no concatenated
// copy). Bound on the H100: 18 C^2 flops per row, run as three TF32
// products each, against 16 C bytes (x, scale, shift read, y written):
// operations at C >= 64, bytes at C <= 32.
// The TPU kernel windows x, scale and shift into overlapping 512 + 16 row
// tiles in device memory first; here a CTA stages its rows of x, scale and
// shift plus a halo of d + 1 on each side straight into shared memory.
//
// Layouts (row-major, f32): x, scale, shift, y [B, T, C]; w1 [3, C, 2C];
// b1 [2C]; w2 [3, C, C]; b2 [C].
#include "film_resblock.cuh"

extern "C" int ttsx_resblock_f32(const float* x, const float* scale,
                                 const float* shift, const float* w1,
                                 const float* b1, const float* w2,
                                 const float* b2, float* y, int B, int T,
                                 int C, int dilation, void* stream) {
  const film_resblock::FullRateFilm f{scale, shift, T, C};
  const film_resblock::Dilations dil = {{dilation, 0, 0, 0}};
  return (int)film_resblock::launch(x, f, w1, b1, w2, b2, y, B, T, C, 1, dil,
                                    (cudaStream_t)stream);
}
