// K1: ConvTranspose1d(k = 2f, stride f) cropped to T*f rows, plus bias.
//
// Replaces the Pallas kernel ttsx/ops/upsample_kernel.py (_upsample_impl,
// body _upsample_body). Same arithmetic: with c = f / 2, output row t*f + j
// is
//     bias + x[t]   . w[2f-1-j-c]
//          + x[t+1] . w[3f-1-j-c]   (j >= f - c)
//          + x[t-1] . w[ f-1-j-c]   (j <  f - c)
// so each output row is two dot products of length Cin. The interleave of
// the f phases into [T*f, Cout] happens in the store.
//
// Bound on the H100: operations. At the generator's shapes each output
// value costs 4*Cin flops against 4 bytes written (Cin >= 32), far above
// f32's ~20 flop/byte ridge, so the kernel is an f32 FMA loop (no tensor
// cores: the port's numerics are full f32). Design: a CTA stages its
// (tile_t + 2) input rows once in shared memory, zero outside [0, T); each
// warp owns 32 input rows x 16 output channels of one phase j, so its 32
// lanes read the same two weight rows (one L1 transaction each), and each
// thread accumulates a 4 x 4 register tile (4 rows, 4 channels).
//
// Layouts (row-major, f32): x [B, T, Cin]; w [2f, Cin, Cout] (tap-major,
// the flax ConvTranspose layout); bias [Cout]; y [B, T*f, Cout].
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;        // input rows per thread
constexpr int kCo = 4;          // output channels per thread
constexpr int kWarpRows = 32;   // 8 row groups x kRows
constexpr int kWarpCo = 16;     // 4 channel groups x kCo

__global__ void __launch_bounds__(kThreads, 2)
upsample_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y,
                int T, int Cin, int Cout, int f, int tile_t) {
  extern __shared__ float xs[];  // [(tile_t + 2)][Cin + 1], row s = t0-1+s
  const int ld = Cin + 1;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile_t;
  const float* xb = x + (size_t)b * T * Cin;
  for (int i = threadIdx.x; i < (tile_t + 2) * Cin; i += kThreads) {
    const int r = i / Cin;
    const int ci = i - r * Cin;
    const int t = t0 - 1 + r;
    xs[r * ld + ci] = (t >= 0 && t < T) ? xb[(size_t)t * Cin + ci] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cg = lane & 3;
  const int rg = lane >> 2;
  const int c = f / 2;
  const int co_tiles = (Cout + kWarpCo - 1) / kWarpCo;
  const int n_tiles = (tile_t / kWarpRows) * f * co_tiles;
  float* yb = y + (size_t)b * T * f * Cout;

  for (int tile = warp; tile < n_tiles; tile += kThreads / 32) {
    const int ct = tile % co_tiles;
    const int j = (tile / co_tiles) % f;
    const int rt = tile / (co_tiles * f);
    const int co0 = ct * kWarpCo + cg * kCo;
    const int r0 = rt * kWarpRows + rg * kRows;
    const bool co_ok = co0 < Cout;   // Cout % 4 == 0: all 4 or none
    const int i_cur = 2 * f - 1 - j - c;
    const bool next = j >= f - c;
    const int i_oth = next ? 3 * f - 1 - j - c : f - 1 - j - c;

    float acc[kRows][kCo];
    {
      float4 bv = co_ok ? *reinterpret_cast<const float4*>(bias + co0)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        acc[i][0] = bv.x; acc[i][1] = bv.y; acc[i][2] = bv.z; acc[i][3] = bv.w;
      }
    }
    const float* wc = w + (size_t)i_cur * Cin * Cout + (co_ok ? co0 : 0);
    const float* wo = w + (size_t)i_oth * Cin * Cout + (co_ok ? co0 : 0);
    // thread rows t0+r0 .. t0+r0+3 need xs rows r0 .. r0+5
    const float* xr = xs + r0 * ld;
    for (int ci = 0; ci < Cin; ++ci) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(wc + (size_t)ci * Cout));
      const float4 o = __ldg(reinterpret_cast<const float4*>(wo + (size_t)ci * Cout));
      float xv[kRows + 2];
#pragma unroll
      for (int i = 0; i < kRows + 2; ++i) xv[i] = xr[i * ld + ci];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float xc = xv[i + 1];
        const float xo = next ? xv[i + 2] : xv[i];
        acc[i][0] = fmaf(xc, a.x, fmaf(xo, o.x, acc[i][0]));
        acc[i][1] = fmaf(xc, a.y, fmaf(xo, o.y, acc[i][1]));
        acc[i][2] = fmaf(xc, a.z, fmaf(xo, o.z, acc[i][2]));
        acc[i][3] = fmaf(xc, a.w, fmaf(xo, o.w, acc[i][3]));
      }
    }
    if (!co_ok) continue;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = t0 + r0 + i;
      if (t < T) {
        *reinterpret_cast<float4*>(yb + ((size_t)t * f + j) * Cout + co0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
}

}  // namespace

extern "C" int ttsx_upsample_f32(const float* x, const float* w,
                                 const float* bias, float* y, int B, int T,
                                 int Cin, int Cout, int f, void* stream) {
  if (B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || f <= 0 || Cout % 4 != 0)
    return (int)cudaErrorInvalidValue;
  // rows per CTA: at most ~96 KB of staged input (two CTAs per SM), a
  // multiple of 32, and small enough to put about two CTAs on every SM
  int tile_t = ((96 * 1024) / (4 * (Cin + 1)) - 2) / kWarpRows * kWarpRows;
  if (tile_t > 256) tile_t = 256;
  const long long want = ((long long)B * T + 263) / 264;
  const int fill = (int)((want + kWarpRows - 1) / kWarpRows * kWarpRows);
  if (fill < tile_t) tile_t = fill;
  if (tile_t < kWarpRows) tile_t = kWarpRows;
  const size_t smem = (size_t)(tile_t + 2) * (Cin + 1) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      upsample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + tile_t - 1) / tile_t, B);
  upsample_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w, bias, y, T, Cin, Cout, f, tile_t);
  return (int)cudaGetLastError();
}
