// K2: all FiLM residual blocks of one generator stage in one kernel.
//
// Replaces the Pallas kernel ttsx/ops/resblock_stack_kernel.py (_stack_impl,
// body _make_kernel; public film_resblock_stack_pallas). For each block i
// with dilation d_i, on x [T, C]:
//     h = leaky_relu(x, 0.1), rows outside [0, T) set to zero
//     u = conv_k3_dilated_d(h) + b1            C -> 2C, taps at t-d, t, t+d
//     g = u[:, :C] * sigmoid(u[:, C:])         GLU
//     g = g * (1 + scale_i) + shift_i          FiLM, film row (t*Tf)/T
//     v = conv_k3(leaky_relu(g) masked) + b2   C -> C, taps at t-1, t, t+1
//     x = x + v
// The film arrives at the conditioning rate [Bf, Tf, 2nC] (per block:
// scale_i | shift_i) and each time step gathers its row with the integer
// rule (t * Tf) / T; x's batch index b reads film batch b % Bf, so the
// generator's band fold needs no copy of the film.
//
// Bound on the H100: operations, 54 C^2 flops per row per stage for 8
// bytes per channel of input and output. Design: a CTA owns L output
// rows plus a halo of sum(d_i + 1) rows on each side (12 for dilations
// 1, 3, 5), keeps the residual stream and the post-FiLM activation of its
// W = L + 2*halo rows in shared memory for all blocks, and writes only
// its L centre rows: intermediates never reach device memory. Rows of the
// halo are recomputed by the neighbouring CTA. Each warp computes 32 rows
// x 16 channels of a conv with f32 FMAs (4 x 4 per thread; for conv1 both
// GLU halves, so the GLU and FiLM run in registers); its lanes share the
// weight reads.
//
// Layouts (row-major, f32): x, y [B, T, C]; film [Bf, Tf, 2nC];
// w1s [n, 3, C, 2C]; b1s [n, 2C]; w2s [n, 3, C, C]; b2s [n, C].
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4;
constexpr int kRows = 4;
constexpr int kCo = 4;
constexpr int kWarpRows = 32;
constexpr int kWarpCo = 16;

struct Dilations {
  int d[kMaxBlocks];
};

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.1f * v; }

__device__ __forceinline__ void fma4(float (&acc)[kCo], float h, float4 w) {
  acc[0] = fmaf(h, w.x, acc[0]);
  acc[1] = fmaf(h, w.y, acc[1]);
  acc[2] = fmaf(h, w.z, acc[2]);
  acc[3] = fmaf(h, w.w, acc[3]);
}

__global__ void __launch_bounds__(kThreads, 2)
resblock_stack_kernel(const float* __restrict__ x,
                      const float* __restrict__ film,
                      const float* __restrict__ w1s,
                      const float* __restrict__ b1s,
                      const float* __restrict__ w2s,
                      const float* __restrict__ b2s, float* __restrict__ y,
                      int T, int C, int Bf, int Tf, int n_blocks,
                      Dilations dil, int W, int halo) {
  extern __shared__ float sm[];
  const int ld = C + 1;
  float* xs = sm;            // [W][ld] residual stream
  float* gs = sm + W * ld;   // [W][ld] masked leaky_relu(FiLM(GLU(conv1)))
  const int b = blockIdx.y;
  const int L = W - 2 * halo;
  const int t0 = blockIdx.x * L - halo;   // time step of local row 0
  const float* xb = x + (size_t)b * T * C;
  for (int i = threadIdx.x; i < W * C; i += kThreads) {
    const int r = i / C;
    const int ci = i - r * C;
    const int t = t0 + r;
    xs[r * ld + ci] = (t >= 0 && t < T) ? xb[(size_t)t * C + ci] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cg = lane & 3;
  const int rg = lane >> 2;
  const int co_tiles = (C + kWarpCo - 1) / kWarpCo;
  const int n_tiles = (W / kWarpRows) * co_tiles;
  const int fw = 2 * n_blocks * C;
  const float* fb = film + (size_t)(b % Bf) * Tf * fw;

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int d = dil.d[blk];
    const float* w1 = w1s + (size_t)blk * 3 * C * 2 * C;
    const float* b1 = b1s + (size_t)blk * 2 * C;
    const float* w2 = w2s + (size_t)blk * 3 * C * C;
    const float* b2 = b2s + (size_t)blk * C;

    // conv1 (C -> 2C, dilation d) + GLU + FiLM + leaky_relu -> gs
    for (int tile = warp; tile < n_tiles; tile += kThreads / 32) {
      const int co0 = (tile % co_tiles) * kWarpCo + cg * kCo;
      const int r0 = (tile / co_tiles) * kWarpRows + rg * kRows;
      const bool co_ok = co0 < C;
      const int cw = co_ok ? co0 : 0;
      float aa[kRows][kCo], ab[kRows][kCo];
      {
        const float4 ba = *reinterpret_cast<const float4*>(b1 + cw);
        const float4 bb = *reinterpret_cast<const float4*>(b1 + C + cw);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          aa[i][0] = ba.x; aa[i][1] = ba.y; aa[i][2] = ba.z; aa[i][3] = ba.w;
          ab[i][0] = bb.x; ab[i][1] = bb.y; ab[i][2] = bb.z; ab[i][3] = bb.w;
        }
      }
      for (int tap = 0; tap < 3; ++tap) {
        const int off = (tap - 1) * d;
        const float* rows[kRows];
        float valid[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = r0 + i + off;
          const bool ok = r >= 0 && r < W;
          rows[i] = xs + (ok ? r : 0) * ld;
          valid[i] = ok ? 1.f : 0.f;
        }
        const float* wt = w1 + (size_t)tap * C * 2 * C + cw;
        for (int ci = 0; ci < C; ++ci) {
          const float4 wa = __ldg(reinterpret_cast<const float4*>(wt + (size_t)ci * 2 * C));
          const float4 wb = __ldg(reinterpret_cast<const float4*>(wt + (size_t)ci * 2 * C + C));
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float h = valid[i] * lrelu(rows[i][ci]);
            fma4(aa[i], h, wa);
            fma4(ab[i], h, wb);
          }
        }
      }
      if (!co_ok) continue;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i;
        const int t = t0 + r;
        const bool inside = t >= 0 && t < T;
        const int tc = t < 0 ? 0 : (t >= T ? T - 1 : t);
        const long long tf = (long long)tc * Tf / T;
        const float* fr = fb + (size_t)tf * fw + 2 * blk * C + co0;
#pragma unroll
        for (int q = 0; q < kCo; ++q) {
          float g = aa[i][q] * (1.f / (1.f + expf(-ab[i][q])));
          g = g * (1.f + fr[q]) + fr[C + q];
          gs[r * ld + co0 + q] = inside ? lrelu(g) : 0.f;
        }
      }
    }
    __syncthreads();

    // conv2 (C -> C, dilation 1) + residual -> xs (zero outside [0, T))
    for (int tile = warp; tile < n_tiles; tile += kThreads / 32) {
      const int co0 = (tile % co_tiles) * kWarpCo + cg * kCo;
      const int r0 = (tile / co_tiles) * kWarpRows + rg * kRows;
      const bool co_ok = co0 < C;
      const int cw = co_ok ? co0 : 0;
      float acc[kRows][kCo];
      {
        const float4 bv = *reinterpret_cast<const float4*>(b2 + cw);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][0] = bv.x; acc[i][1] = bv.y; acc[i][2] = bv.z; acc[i][3] = bv.w;
        }
      }
      for (int tap = 0; tap < 3; ++tap) {
        const int off = tap - 1;
        const float* rows[kRows];
        float valid[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = r0 + i + off;
          const bool ok = r >= 0 && r < W;
          rows[i] = gs + (ok ? r : 0) * ld;
          valid[i] = ok ? 1.f : 0.f;
        }
        const float* wt = w2 + (size_t)tap * C * C + cw;
        for (int ci = 0; ci < C; ++ci) {
          const float4 wv = __ldg(reinterpret_cast<const float4*>(wt + (size_t)ci * C));
#pragma unroll
          for (int i = 0; i < kRows; ++i) fma4(acc[i], valid[i] * rows[i][ci], wv);
        }
      }
      if (!co_ok) continue;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i;
        const int t = t0 + r;
        const bool inside = t >= 0 && t < T;
#pragma unroll
        for (int q = 0; q < kCo; ++q) {
          float* p = xs + r * ld + co0 + q;
          *p = inside ? *p + acc[i][q] : 0.f;
        }
      }
    }
    __syncthreads();
  }

  float* yb = y + (size_t)b * T * C;
  for (int i = threadIdx.x; i < L * C; i += kThreads) {
    const int r = i / C;
    const int co = i - r * C;
    const int t = t0 + halo + r;
    if (t < T) yb[(size_t)t * C + co] = xs[(halo + r) * ld + co];
  }
}

}  // namespace

extern "C" int ttsx_resblock_stack_f32(const float* x, const float* film,
                                       const float* w1s, const float* b1s,
                                       const float* w2s, const float* b2s,
                                       float* y, int B, int T, int C, int Bf,
                                       int Tf, int n_blocks, int d0, int d1,
                                       int d2, int d3, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 4 != 0 || Bf <= 0 || Tf <= 0 ||
      n_blocks <= 0 || n_blocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  Dilations dil = {{d0, d1, d2, d3}};
  int halo = 0;
  for (int i = 0; i < n_blocks; ++i) {
    if (dil.d[i] <= 0) return (int)cudaErrorInvalidValue;
    halo += dil.d[i] + 1;
  }
  // rows per CTA: ~110 KB of shared memory (two CTAs per SM), a multiple
  // of 32, at most 512, fewer when T is short so that the card fills
  int W = (110 * 1024) / (2 * (C + 1) * (int)sizeof(float)) / kWarpRows * kWarpRows;
  if (W > 512) W = 512;
  const long long want = ((long long)B * T + 263) / 264 + 2 * halo;
  const int fill = (int)((want + kWarpRows - 1) / kWarpRows * kWarpRows);
  if (fill < W) W = fill;
  while (W - 2 * halo < kWarpRows) W += kWarpRows;
  const size_t smem = 2 * (size_t)W * (C + 1) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      resblock_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int L = W - 2 * halo;
  dim3 grid((T + L - 1) / L, B);
  resblock_stack_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, film, w1s, b1s, w2s, b2s, y, T, C, Bf, Tf, n_blocks, dil, W, halo);
  return (int)cudaGetLastError();
}
