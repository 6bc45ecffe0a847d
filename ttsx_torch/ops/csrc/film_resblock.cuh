// FiLM residual blocks over a time tile held in shared memory: the device
// code of K2 (resblock_stack.cu, all blocks of a generator stage, film at
// the conditioning rate) and K5 (resblock.cu, one block, film at full
// rate). The two differ only in where a row's FiLM scale and shift are
// read, which the Film policy gives (StackFilm / FullRateFilm below).
//
// For each block i with dilation d_i, on x [T, C]:
//     h = leaky_relu(x, 0.1), rows outside [0, T) set to zero
//     u = conv_k3_dilated_d(h) + b1            C -> 2C, taps at t-d, t, t+d
//     g = u[:, :C] * sigmoid(u[:, C:])         GLU
//     g = g * (1 + scale_i) + shift_i          FiLM
//     v = conv_k3(leaky_relu(g) masked) + b2   C -> C, taps at t-1, t, t+1
//     x = x + v
//
// Bound on the H100: operations, 18 C^2 flops per row per block for 8
// bytes per channel of x and y (K5 also reads 8 bytes of scale and
// shift). Design: a CTA owns L output rows plus a halo of sum(d_i + 1)
// rows on each side, keeps the residual stream and the post-FiLM
// activation of its W = L + 2*halo rows in shared memory for all blocks,
// and writes only its L centre rows: intermediates never reach device
// memory. Rows of the halo are recomputed by the neighbouring CTA. Each
// warp computes 32 rows x 16 channels of a conv with f32 FMAs (4 x 4 per
// thread; for conv1 both GLU halves, so the GLU and FiLM run in
// registers); its lanes share the weight reads.
//
// Layouts (row-major, f32): x, y [B, T, C]; w1s [n, 3, C, 2C]; b1s [n, 2C];
// w2s [n, 3, C, C]; b2s [n, C]; the film as the policy says.
#pragma once
#include <cuda_runtime.h>

namespace film_resblock {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4;
constexpr int kRows = 4;
constexpr int kCo = 4;
constexpr int kWarpRows = 32;
constexpr int kWarpCo = 16;

struct Dilations {
  int d[kMaxBlocks];
};

// film [Bf, Tf, 2nC] (per block: scale_i | shift_i) at the conditioning
// rate: time step t reads row (t * Tf) / T, batch row b reads film b % Bf,
// so the generator's band fold needs no copy of the film
struct StackFilm {
  const float* film;
  int Bf, Tf, T, C, n_blocks;
  __device__ __forceinline__ const float* scale(int b, int blk, int t) const {
    const long long tf = (long long)t * Tf / T;
    return film + ((size_t)(b % Bf) * Tf + tf) * (2 * n_blocks * C) +
           2 * blk * C;
  }
  __device__ __forceinline__ const float* shift(int b, int blk, int t) const {
    return scale(b, blk, t) + C;
  }
};

// scale and shift [B, T, C] each, already at x's rate (one block)
struct FullRateFilm {
  const float* sc;
  const float* sh;
  int T, C;
  __device__ __forceinline__ const float* scale(int b, int, int t) const {
    return sc + ((size_t)b * T + t) * C;
  }
  __device__ __forceinline__ const float* shift(int b, int, int t) const {
    return sh + ((size_t)b * T + t) * C;
  }
};

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.1f * v; }

__device__ __forceinline__ void fma4(float (&acc)[kCo], float h, float4 w) {
  acc[0] = fmaf(h, w.x, acc[0]);
  acc[1] = fmaf(h, w.y, acc[1]);
  acc[2] = fmaf(h, w.z, acc[2]);
  acc[3] = fmaf(h, w.w, acc[3]);
}

template <class Film>
__global__ void __launch_bounds__(kThreads, 2)
kernel(const float* __restrict__ x, Film film, const float* __restrict__ w1s,
       const float* __restrict__ b1s, const float* __restrict__ w2s,
       const float* __restrict__ b2s, float* __restrict__ y, int T, int C,
       int n_blocks, Dilations dil, int W, int halo) {
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
        const float* sc = film.scale(b, blk, tc) + co0;
        const float* sh = film.shift(b, blk, tc) + co0;
#pragma unroll
        for (int q = 0; q < kCo; ++q) {
          float g = aa[i][q] * (1.f / (1.f + expf(-ab[i][q])));
          g = g * (1.f + sc[q]) + sh[q];
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

// Checks the sizes, picks the tile and launches; returns the CUDA error.
template <class Film>
cudaError_t launch(const float* x, const Film& film, const float* w1s,
                   const float* b1s, const float* w2s, const float* b2s,
                   float* y, int B, int T, int C, int n_blocks,
                   const Dilations& dil, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 4 != 0 || n_blocks <= 0 ||
      n_blocks > kMaxBlocks || B > 65535)
    return cudaErrorInvalidValue;
  int halo = 0;
  for (int i = 0; i < n_blocks; ++i) {
    if (dil.d[i] <= 0) return cudaErrorInvalidValue;
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
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel<Film>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int L = W - 2 * halo;
  dim3 grid((T + L - 1) / L, B);
  kernel<Film><<<grid, kThreads, smem, stream>>>(
      x, film, w1s, b1s, w2s, b2s, y, T, C, n_blocks, dil, W, halo);
  return cudaGetLastError();
}

}  // namespace film_resblock
