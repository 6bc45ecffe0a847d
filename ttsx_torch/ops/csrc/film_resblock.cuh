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
// shift). The f32 FMA pipe caps at 67 TFLOP/s; both convs run on the
// tensor cores in 3xTF32 (tf32x3.cuh: three TF32 products per f32
// product, at an error near f32's).
//
// Design: a CTA owns L output rows plus a halo of sum(d_i + 1) rows on
// each side, keeps the residual stream xs and the post-FiLM activation gs
// of its W = L + 2*halo rows in shared memory for all blocks, and writes
// only its L centre rows: intermediates never reach device memory. Rows
// of the halo are recomputed by the neighbouring CTA. Per block, conv1 is
// a [W, 3C] x [3C, 2C] product and conv2 a [W, 3C] x [3C, C] one on
// mma.sync m16n8k8; the three taps are three row offsets into the
// resident tile (conv1 reads xs at -d, 0, +d and applies leaky_relu to the
// fragment, conv2 reads gs at -1, 0, +1), so no shifted copy is built. A
// row whose tap leaves the window reads the window's edge row instead:
// such rows lie in the outer halo, which no later block and no output
// reads. Operands are split into TF32 hi + lo as fragments leave shared
// memory; the partial sum restarts every kFlush k8 steps and is added to
// the accumulator on the FMA pipe, as in K1. A warp tile is 64 rows x 16
// output channels: for conv1 the n8 tiles come in pairs, channels [c,
// c+8) of the GLU's a-half and the same channels of its b-half, so a
// thread holds u_a and u_b of the same (row, channel) and the GLU, FiLM
// and masked leaky_relu run in registers before gs is written; conv2 adds
// its tile into xs in place (it reads only gs). The weights (9 C^2 floats
// a block, 576 KB at C = 128, shared by every CTA through L2) do not fit
// in shared memory beside the tile: each warp streams its tile's columns
// of B through a ring of kStages slots of two k8 steps with cp.async, a
// slot ahead of the MMAs. The window's x and block 0's film rows arrive
// by cp.async, all in flight at once; block i + 1's film rows are copied
// while block i's conv2 runs, so the epilogue reads the film from shared
// memory. Channels
// are zero-padded to a multiple of 16 in shared memory and in the weight
// copies. Shared-memory rows are padded to a stride of 4 (mod 16) floats
// and the ring is XOR-swizzled, so the fragment reads are free of bank
// conflicts. One CTA of 256 threads an SM (up to 255 registers: 64
// accumulators and 64 partial sums a thread on conv1); the launch picks W
// (a multiple of 16, within 227 KB of shared memory) that minimises waves
// x the busiest warp's tiles on this card, and the window's last warp
// tile, when shorter than 64 rows, runs its own instantiation. PERF.md
// gives the tuning verdicts (B straight from L2 with __ldg, one-step or
// three slots, 32-row warp tiles with 8 or 16 warps or two CTAs an SM,
// 32-channel conv2 tiles: each slower or no faster).
//
// Layouts (row-major, f32): x, y [B, T, C]; w1s [n, 3, C, 2C]; b1s [n, 2C];
// w2s [n, 3, C, C]; b2s [n, C]; the film as the policy says.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace film_resblock {
namespace {   // each library that includes this keeps its own kernels and statics

using tf32x3::mma_tf32;
using tf32x3::split_tf32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 4;
constexpr int kMI = 4;                  // m16 tiles of a warp tile
constexpr int kTileRows = 16 * kMI;     // rows of a warp tile
constexpr int kTileCols = 16;           // output channels of a warp tile
constexpr int kFlush = 2;               // k8 steps summed on the tensor cores per partial
constexpr int kSlot = kFlush * 8 * 32;  // floats of a ring slot: one partial's B, 8 rows a step x 32 columns
constexpr int kStages = 2;              // slots of a warp's cp.async ring
constexpr int kRing = kStages * kSlot;  // floats of a warp's ring
constexpr int kMaxRows = 1024;          // W at most
constexpr int kMaxSmem = 227 * 1024;    // one CTA an SM
static_assert(kMI == 4, "the tile dispatch in kernel() covers 1..4 m16 tiles");
static_assert(kTileCols % (8 * kFlush) == 0,
              "a tap's k8 steps (padded channels / 8) fill whole slots");
static_assert(2 * kTileCols <= 32, "a slot row holds conv1's 4 n8 tiles");

struct Dilations {
  int d[kMaxBlocks];
};

// Film policies. The kernel stages a block's scale and shift rows of its
// window in shared memory (row(t) is the film row time step t reads;
// max_rows(W) bounds the rows a window of W steps reads) and the epilogue
// reads them there: a film row serves T / Tf time steps.
//
// film [Bf, Tf, 2nC] (per block: scale_i | shift_i) at the conditioning
// rate: time step t reads row (t * Tf) / T, batch row b reads film b % Bf,
// so the generator's band fold needs no copy of the film
struct StackFilm {
  const float* film;
  int Bf, Tf, T, C, n_blocks;
  __device__ __forceinline__ int row(int t) const {
    return (int)((long long)t * Tf / T);
  }
  int max_rows(int W) const {
    const long long n = (long long)(W - 1) * Tf / T + 2;
    return n < Tf ? (int)n : Tf;
  }
  __device__ __forceinline__ const float* scale(int b, int blk, int row) const {
    return film + ((size_t)(b % Bf) * Tf + row) * (2 * n_blocks * C) +
           2 * blk * C;
  }
  __device__ __forceinline__ const float* shift(int b, int blk, int row) const {
    return scale(b, blk, row) + C;
  }
  bool aligned16() const { return reinterpret_cast<uintptr_t>(film) % 16 == 0; }
};

// scale and shift [B, T, C] each, already at x's rate (one block)
struct FullRateFilm {
  const float* sc;
  const float* sh;
  int T, C;
  __device__ __forceinline__ int row(int t) const { return t; }
  int max_rows(int W) const { return W; }
  __device__ __forceinline__ const float* scale(int b, int, int row) const {
    return sc + ((size_t)b * T + row) * C;
  }
  __device__ __forceinline__ const float* shift(int b, int, int row) const {
    return sh + ((size_t)b * T + row) * C;
  }
  bool aligned16() const {
    return reinterpret_cast<uintptr_t>(sc) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(sh) % 16 == 0;
  }
};

// channels padded to whole warp tiles, and the shared-memory row stride
__host__ __device__ __forceinline__ int padded(int C) {
  return (C + kTileCols - 1) / kTileCols * kTileCols;
}
__host__ __device__ __forceinline__ int row_stride(int C) {
  return padded(C) + 4;
}

// 4-byte words of shared memory a CTA of W rows takes: xs, gs, the rings,
// each window row's film row and a block's staged scale and shift rows
template <class Film>
int smem_floats(const Film& film, int W, int C) {
  return (2 * W + 2 * film.max_rows(W)) * row_stride(C) + kWarps * kRing +
         (W + 3) / 4 * 4;
}

// copy block blk's scale and shift of film rows [fr0, fr0 + nfr) into fs
// ([nfr][2][ld]: scale, then shift); commits no group
template <class Film>
__device__ __forceinline__ void stage_film(const Film& film, float* fs, int b,
                                           int blk, int fr0, int nfr, int C,
                                           int ld, bool vec) {
  const int q = C / 4;
  for (int i = threadIdx.x; i < nfr * 2 * q; i += kThreads) {
    const int j = i / (2 * q), h = i / q - 2 * j, c = 4 * (i - i / q * q);
    const float* src =
        (h ? film.shift(b, blk, fr0 + j) : film.scale(b, blk, fr0 + j)) + c;
    float* dst = fs + (2 * j + h) * ld + c;
    if (vec) {
      tf32x3::cp_async16(dst, src, true);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32x3::cp_async4(dst + e, src + e, true);
    }
  }
}

__device__ __forceinline__ float lrelu(float v) { return fmaxf(v, 0.1f * v); }

// where B element (k, n) of a slot lies: the columns are XOR-swizzled by
// row so that the fragment reads (k = 8f + t4 and 8f + t4 + 4, n = 8j +
// g) fall in distinct banks, and a 16-byte group stays whole
__device__ __forceinline__ int ring_at(int k, int n) {
  return k * 32 + (n ^ ((k & 3) << 3));
}

// n8 tiles of a warp tile: conv1 a, b, a, b (two GLU pairs), conv2 two
template <bool kGlu>
struct Conv {
  static constexpr int NI = kGlu ? 4 : 2;
};

// acc = one warp tile of a conv without its bias: rows [r0, r0 + 16 MI)
// of the window, output channels [c0, c0 + 16) (conv1: of each GLU
// half). conv1 (kGlu): A = leaky_relu(xs) at row offsets -d, 0, +d, w =
// w1 [3, C, 2C]; conv2: A = gs at -1, 0, +1, w = w2 [3, C, C]. B comes
// through the warp's ring of kStages slots: the lanes copy the slot
// kStages - 1 ahead of the one they multiply with cp.async (16 bytes a
// copy when vecw, else 4), zero outside the C channels. Each slot is one
// partial sum: its kFlush k8 steps run lo.hi, hi.lo, hi.hi on the
// tensor cores from zero, then the partial joins acc on the FMA pipe.
template <bool kGlu, int MI>
__device__ __forceinline__ void conv_gemm(float (&acc)[MI][Conv<kGlu>::NI][4],
                                          const float* src, float* ring,
                                          const float* __restrict__ w, int C,
                                          int ld, int W, int r0, int c0,
                                          int d, bool vecw) {
  constexpr int NI = Conv<kGlu>::NI;
  constexpr int kCopies = kFlush * NI / 2;   // 16-byte copies a lane makes a slot
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int ldw = kGlu ? 2 * C : C;
  const int tap_slots = padded(C) / (8 * kFlush);
  // the lane's copies: row of the slot, place in the slot, column of w,
  // and whether the column is a channel
  int crow[kCopies], cdst[kCopies], ccol[kCopies];
  bool cok[kCopies];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int q = lane + 32 * i;
    const int k = q / (2 * NI), j = q % (2 * NI) / 2, g0 = q % 2 * 4;
    const int ch = c0 + (kGlu ? j >> 1 : j) * 8 + g0;
    crow[i] = k;
    cdst[i] = ring_at(k, 8 * j + g0);
    cok[i] = ch < C;
    ccol[i] = (kGlu && (j & 1) ? C : 0) + (cok[i] ? ch : 0);
  }
  // copy the next slot (tap itap, channels from ici0), if there is one,
  // into ring slot `stage`; always commit a group
  int itap = 0, ici0 = 0;
  auto copy_slot = [&](int stage) {
    if (itap < 3) {
      const float* wt = w + (size_t)(itap * C + ici0) * ldw;
      float* st = ring + stage * kSlot;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const bool ok = cok[i] && ici0 + crow[i] < C;
        const float* p = ok ? wt + crow[i] * ldw + ccol[i] : w;
        if (vecw) {
          tf32x3::cp_async16(st + cdst[i], p, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tf32x3::cp_async4(st + cdst[i] + e, ok ? p + e : w, ok);
        }
      }
      ici0 += 8 * kFlush;
      if (ici0 == 8 * kFlush * tap_slots) {
        ici0 = 0;
        ++itap;
      }
    }
    tf32x3::cp_async_commit();
  };
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  __syncwarp();   // the ring's last user (tile or conv) has read it all
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) copy_slot(p);
  int s = 0;
  for (int tap = 0; tap < 3; ++tap) {
    const int off = (tap - 1) * d;
    int a[MI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r = r0 + mi * 16 + g + 8 * h + off;
        r = r < 0 ? 0 : (r >= W ? W - 1 : r);
        a[mi][h] = r * ld + t4;
      }
    for (int c = 0; c < tap_slots; ++c, ++s) {
      __syncwarp();   // every lane has read slot s - 1, whose ring slot is refilled
      copy_slot((s + kStages - 1) % kStages);
      tf32x3::cp_async_wait<kStages - 1>();
      __syncwarp();   // slot s, copied by all lanes, is visible
      const float* st = ring + s % kStages * kSlot;
      float part[MI][NI][4];
#pragma unroll
      for (int f = 0; f < kFlush; ++f) {
        const int k0 = (c * kFlush + f) * 8;
        uint32_t bh[NI][2], bl[NI][2];
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          split_tf32(st[ring_at(8 * f + t4, 8 * j + g)], bh[j][0], bl[j][0]);
          split_tf32(st[ring_at(8 * f + t4 + 4, 8 * j + g)], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const float v[4] = {src[a[mi][0] + k0], src[a[mi][1] + k0],
                              src[a[mi][0] + k0 + 4], src[a[mi][1] + k0 + 4]};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(kGlu ? lrelu(v[e]) : v[e], ah[e], al[e]);
#pragma unroll
          for (int j = 0; j < NI; ++j) {
            if (f == 0)
              mma_tf32<true>(part[mi][j], al, bh[j][0], bh[j][1]);
            else
              mma_tf32<false>(part[mi][j], al, bh[j][0], bh[j][1]);
          }
#pragma unroll
          for (int j = 0; j < NI; ++j)
            mma_tf32<false>(part[mi][j], ah, bl[j][0], bl[j][1]);
#pragma unroll
          for (int j = 0; j < NI; ++j)
            mma_tf32<false>(part[mi][j], ah, bh[j][0], bh[j][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[mi][j][e];
    }
  }
}

// conv1 (C -> 2C, dilation d) + GLU + FiLM + leaky_relu of one warp tile
// -> gs; rows outside [0, T) get zeros. frow holds each window row's film
// row, fs the block's staged film rows from fr0.
template <int MI, class Film>
__device__ __forceinline__ void conv1_tile(const Film& film, const int* frow,
                                           const float* fs, int fr0,
                                           const float* xs, float* gs,
                                           float* ring,
                                           const float* __restrict__ w1,
                                           const float* __restrict__ b1, int b,
                                           int blk, int T, int C, int ld,
                                           int W, int t0, int r0, int c0,
                                           int d, bool vecw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float acc[MI][Conv<true>::NI][4];
  conv_gemm<true, MI>(acc, xs, ring, w1, C, ld, W, r0, c0, d, vecw);
  // the thread's 4 channels (pairs p, columns e) and their biases
  float ba[2][2], bb[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = c0 + p * 8 + 2 * t4 + e;
      ba[p][e] = n < C ? __ldg(b1 + n) : 0.f;
      bb[p][e] = n < C ? __ldg(b1 + C + n) : 0.f;
    }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + mi * 16 + g + 8 * h;
      const int t = t0 + r;
      const bool inside = t >= 0 && t < T;
      const float* sc = fs + 2 * (frow[r] - fr0) * ld;
      const float* sh = sc + ld;
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = c0 + p * 8 + 2 * t4 + e;
          if (n >= C) continue;
          const float ua = acc[mi][2 * p][2 * h + e] + ba[p][e];
          const float ub = acc[mi][2 * p + 1][2 * h + e] + bb[p][e];
          // 1 / (1 + e^-ub), correctly rounded as the division is
          float v = ua * __frcp_rn(1.f + expf(-ub));
          v = v * (1.f + sc[n]) + sh[n];
          gs[r * ld + n] = inside ? lrelu(v) : 0.f;
        }
    }
}

// conv2 (C -> C, dilation 1) + bias of one warp tile, added into xs in
// place (conv2 reads only gs); rows outside [0, T) stay zero
template <int MI>
__device__ __forceinline__ void conv2_tile(const float* gs, float* xs,
                                           float* ring,
                                           const float* __restrict__ w2,
                                           const float* __restrict__ b2,
                                           int T, int C, int ld, int W,
                                           int t0, int r0, int c0, bool vecw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float acc[MI][Conv<false>::NI][4];
  conv_gemm<false, MI>(acc, gs, ring, w2, C, ld, W, r0, c0, 1, vecw);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + mi * 16 + g + 8 * h;
      const int t = t0 + r;
      const bool inside = t >= 0 && t < T;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = c0 + j * 8 + 2 * t4 + e;
          if (n >= C) continue;
          float* p = xs + r * ld + n;
          *p = inside ? *p + acc[mi][j][2 * h + e] + __ldg(b2 + n) : 0.f;
        }
    }
}

template <class Film>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const float* __restrict__ x, Film film, const float* __restrict__ w1s,
       const float* __restrict__ b1s, const float* __restrict__ w2s,
       const float* __restrict__ b2s, float* __restrict__ y, int T, int C,
       int n_blocks, Dilations dil, int W, int halo, int vec, int vecw) {
  extern __shared__ __align__(16) float sm[];
  const int Cp = padded(C), ld = row_stride(C);
  float* xs = sm;            // [W][ld] residual stream
  float* gs = sm + W * ld;   // [W][ld] masked leaky_relu(FiLM(GLU(conv1)))
  float* ring = sm + 2 * W * ld + (threadIdx.x >> 5) * kRing;   // this warp's
  int* frow = reinterpret_cast<int*>(sm + 2 * W * ld + kWarps * kRing);   // [W]
  float* fs = sm + 2 * W * ld + kWarps * kRing + (W + 3) / 4 * 4;   // staged film
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int L = W - 2 * halo;
  const int t0 = blockIdx.x * L - halo;   // time step of local row 0
  const float* xb = x + (size_t)b * T * C;
  // the film rows the window reads: rows outside [0, T) read the edge's
  const int fr0 = film.row(t0 < 0 ? 0 : t0);
  const int nfr = film.row(t0 + W - 1 < T ? t0 + W - 1 : T - 1) - fr0 + 1;

  // x's rows by cp.async, all in flight at once, zero outside [0, T) and
  // in the padded channels [C, Cp); the padded channels of gs are zero too
  // (conv2 reads them against zero B)
  if (vec) {
    const int q = Cp / 4;
    for (int i = tid; i < W * q; i += kThreads) {
      const int r = i / q, c = 4 * (i - r * q), t = t0 + r;
      const bool ok = t >= 0 && t < T && c < C;
      tf32x3::cp_async16(xs + r * ld + c, ok ? xb + (size_t)t * C + c : xb, ok);
    }
  } else {
    for (int i = tid; i < W * Cp; i += kThreads) {
      const int r = i / Cp, c = i - r * Cp, t = t0 + r;
      const bool ok = t >= 0 && t < T && c < C;
      tf32x3::cp_async4(xs + r * ld + c, ok ? xb + (size_t)t * C + c : xb, ok);
    }
  }
  stage_film(film, fs, b, 0, fr0, nfr, C, ld, vec);
  tf32x3::cp_async_commit();
  for (int i = tid; i < W * (Cp - C); i += kThreads) {
    const int r = i / (Cp - C);
    gs[r * ld + C + i - r * (Cp - C)] = 0.f;
  }
  for (int r = tid; r < W; r += kThreads) {
    const int t = t0 + r;
    frow[r] = film.row(t < 0 ? 0 : (t >= T ? T - 1 : t));
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5;
  const int ntiles = Cp / kTileCols;
  const int tiles = (W + kTileRows - 1) / kTileRows * ntiles;

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int d = dil.d[blk];
    const float* w1 = w1s + (size_t)blk * 3 * C * 2 * C;
    const float* b1 = b1s + (size_t)blk * 2 * C;
    const float* w2 = w2s + (size_t)blk * 3 * C * C;
    const float* b2 = b2s + (size_t)blk * C;

    // conv1 + GLU + FiLM + leaky_relu -> gs; a warp tile of fewer than
    // kMI m16 tiles (the window's last) runs its own instantiation
    for (int tile = warp; tile < tiles; tile += kWarps) {
      const int r0 = tile / ntiles * kTileRows;
      const int c0 = tile % ntiles * kTileCols;
      switch (min(kMI, (W - r0) / 16)) {
        case 4: conv1_tile<4>(film, frow, fs, fr0, xs, gs, ring, w1, b1, b, blk, T, C, ld, W, t0, r0, c0, d, vecw); break;
        case 3: conv1_tile<3>(film, frow, fs, fr0, xs, gs, ring, w1, b1, b, blk, T, C, ld, W, t0, r0, c0, d, vecw); break;
        case 2: conv1_tile<2>(film, frow, fs, fr0, xs, gs, ring, w1, b1, b, blk, T, C, ld, W, t0, r0, c0, d, vecw); break;
        default: conv1_tile<1>(film, frow, fs, fr0, xs, gs, ring, w1, b1, b, blk, T, C, ld, W, t0, r0, c0, d, vecw);
      }
    }
    __syncthreads();

    // the next block's film rows, in flight while conv2 runs (its first
    // ring wait completes them with the ring's first slot)
    if (blk + 1 < n_blocks) stage_film(film, fs, b, blk + 1, fr0, nfr, C, ld, vec);
    tf32x3::cp_async_commit();

    // conv2 + residual -> xs
    for (int tile = warp; tile < tiles; tile += kWarps) {
      const int r0 = tile / ntiles * kTileRows;
      const int c0 = tile % ntiles * kTileCols;
      switch (min(kMI, (W - r0) / 16)) {
        case 4: conv2_tile<4>(gs, xs, ring, w2, b2, T, C, ld, W, t0, r0, c0, vecw); break;
        case 3: conv2_tile<3>(gs, xs, ring, w2, b2, T, C, ld, W, t0, r0, c0, vecw); break;
        case 2: conv2_tile<2>(gs, xs, ring, w2, b2, T, C, ld, W, t0, r0, c0, vecw); break;
        default: conv2_tile<1>(gs, xs, ring, w2, b2, T, C, ld, W, t0, r0, c0, vecw);
      }
    }
    tf32x3::cp_async_wait<0>();   // a warp without conv2 tiles waits here
    __syncthreads();
  }

  float* yb = y + (size_t)b * T * C;
  if (vec) {
    const int q = C / 4;
    for (int i = tid; i < L * q; i += kThreads) {
      const int r = i / q, c = 4 * (i - r * q), t = t0 + halo + r;
      if (t < T)
        *reinterpret_cast<float4*>(yb + (size_t)t * C + c) =
            *reinterpret_cast<const float4*>(xs + (halo + r) * ld + c);
    }
  } else {
    for (int i = tid; i < L * C; i += kThreads) {
      const int r = i / C, c = i - r * C, t = t0 + halo + r;
      if (t < T) yb[(size_t)t * C + c] = xs[(halo + r) * ld + c];
    }
  }
}

// Rows per CTA: the W (a multiple of 16, at most kMaxRows, its shared
// memory within kMaxSmem) that minimises the launch's time counted as
// waves of one CTA an SM x the busiest warp's m16 tiles a conv (warp tiles
// dealt round robin), so a short T gets narrow windows that fill the card
// and a long T wide ones that recompute less halo. 0 if none fits.
template <class Film>
int rows_per_cta(const Film& film, int B, int T, int C, int halo, int sms) {
  const int ntiles = padded(C) / kTileCols;
  int best_w = 0;
  long long best = -1;
  for (int W = (2 * halo + 16 + 15) / 16 * 16;
       W <= kMaxRows && (long long)smem_floats(film, W, C) * sizeof(float) <= kMaxSmem;
       W += 16) {
    const int L = W - 2 * halo;
    const long long ctas = (long long)B * ((T + L - 1) / L);
    const long long waves = (ctas + sms - 1) / sms;
    const int tiles = (W + kTileRows - 1) / kTileRows * ntiles;
    int m16[kWarps] = {};
    for (int t = 0; t < tiles; ++t) {
      const int left = (W - t / ntiles * kTileRows) / 16;
      m16[t % kWarps] += left < kMI ? left : kMI;
    }
    int busiest = 0;
    for (int w = 0; w < kWarps; ++w) busiest = m16[w] > busiest ? m16[w] : busiest;
    const long long cost = waves * busiest;
    if (best < 0 || cost <= best) {   // ties: the wider tile, fewer CTAs
      best = cost;
      best_w = W;
    }
  }
  return best_w;
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
  // the shared-memory limit and the SM count, once per device
  static bool ready[64] = {};
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel<Film>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const int W = rows_per_cta(film, B, T, C, halo, sms[dev]);
  if (W == 0) return cudaErrorInvalidValue;
  const int L = W - 2 * halo;
  const long long row_tiles = ((long long)T + L - 1) / L;
  if (row_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_floats(film, W, C) * sizeof(float);
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = aligned(x) && aligned(y) && film.aligned16();
  const int vecw = aligned(w1s) && aligned(w2s);
  dim3 grid((unsigned)row_tiles, B);
  kernel<Film><<<grid, kThreads, smem, stream>>>(
      x, film, w1s, b1s, w2s, b2s, y, T, C, n_blocks, dil, W, halo, vec, vecw);
  return cudaGetLastError();
}

}  // namespace
}  // namespace film_resblock
