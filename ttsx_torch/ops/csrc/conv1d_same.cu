// A 1-D SAME convolution with stride 1 and an odd number of taps k, plus an
// optional bias, as an implicit GEMM on the tensor cores (wgmma) in
// 3xTF32:
//     y[b, m, t] = sum_{c, j} w[m, c, j] * x[b, c, t + j - p] (+ bias[m]),
// p = (k - 1) / 2, zeros outside [0, T). The discriminators' spectral-normed
// convolutions (nn/conv.py::SNConv) run their forward and their input
// gradient through it: for stride 1 and odd k, dx is the same convolution of
// dy with w transposed (Cin and Cout exchanged) and its taps reversed.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA.
// It was added because cuDNN runs them in float32 on the FMA pipes (TF32 is
// off: plain TF32 fails the training gates), and the scale discriminators'
// wide layers (Cin 64 / 256, Cout 256 / 1024, k 15 / 41, over B*T of
// 44 k-176 k samples) held most of a training step's device time. What
// bounds it is operations: the reduction r = c*k + j is K = Cin*k =
// 960-41,984 deep, and every staged input element serves k taps.
//
// GEMM view, per CTA of two warpgroups: D[t][m] over BT = 128 time steps
// (64 a warpgroup, wgmma's M) of one batch item and NB = 128 (or, for
// M <= 64, 64) output channels (wgmma's N); A[t][r] = x[b, r / k, t0 + t +
// r % k - p] comes from registers, B[m][r] = w[m][r] (w's own layout, rows
// of K) from shared memory. No im2col buffer is made (the widest layer's
// would be 3.7 GB). Per stage of BK = 32 reduction rows, cp.async copies the
// [NB, BK] slice of w and the input window of the nch channels those rows
// touch, x[b, c, t0 - p : t0 + BT + p] (the SAME zeros come from masked
// loads, so no padded copy of x is made), plus a table of BK offsets: row r
// is the window's row r / k shifted by r % k. Each thread reads its A
// fragments (the m16n8k8 layout, rows of its warp's 16 time steps) from the
// window through the table and splits them in registers; the w slice is
// split once into hi and lo tiles, K-major in wgmma's unswizzled core
// matrices (LBO 128 bytes, SBO 256). Per k8 slice, three m64nNk8 wgmmas:
// lo*hi + hi*lo, then hi*hi (3xTF32, tf32x3.cuh, f32 accuracy).
//
// Precision: the tensor cores' f32 sums truncate, so a stage's products (32
// a column, three terms each) go to a partial sum that starts from zero and
// is then added to the accumulator on the FMA pipe, rounded to nearest: the
// reductions here are up to 41,984 deep. No atomics: deterministic.
//
// Overlap: the w tiles and the raw stages are double-buffered, so the next
// stage's copies and split run while this stage's wgmmas do. One CTA an SM.
//
// Measured on an H100 SXM at 700 W, f32-equivalent TFLOP/s at the training
// cell's six shapes (batch 16), forward / input gradient: this kernel
// 58-68 / 44-67 (sums 67.7 / 71.5 ms a pass of the six); the same with x
// split into a shared-memory tile as well (both operands from shared
// memory) 52-61 / 37-60 (75.7 / 79.2 ms); on mma.sync m16n8k8 (operands
// split as fragments leave shared memory, K1's scheme) 42-48 / 32-47, 50-58
// with BK 64; cuDNN's f32 kernels 28-45 / 22-38 (113.9 / 137.3 ms).
// Swizzled (128-byte) tiles, four raw stages, or partial sums over 2-8
// stages measured no faster on the shared-memory form.
//
// Layouts (row-major, f32): x [B, C, T]; w [M, C, k], 16-byte aligned, C a
// multiple of 4 (so each K-row of w is copied in 16-byte pieces); bias [M]
// or null; y [B, M, T].
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::split_tf32;

constexpr int kThreads = 256;  // two warpgroups
constexpr int BK = 32;         // reduction rows a stage: four k8 slices
constexpr int LDA = BK + 4;    // raw w rows: conflict-free float4 reads
constexpr int BT = 128;        // time steps a CTA owns: 64 a warpgroup

struct Shape {
  int M, C, T, k, K;   // K = C * k
  int nch, ldx;        // channels of a staged window, its row stride
  int stage;           // floats a raw stage holds
};

template <int NB>      // output channels a CTA owns: wgmma's N
struct Tile {
  static constexpr int W_RAW = NB * LDA;
  static constexpr int W_TILE = NB * BK;     // floats of w_hi (or w_lo)
  static constexpr int TILES = 2 * W_TILE;   // hi and lo
  static constexpr int NACC = NB / 2;        // accumulators a thread
};

// a K-major tile [rows][BK] in wgmma's unswizzled core matrices (8 rows x
// 4 floats, 128 contiguous bytes): slice s = k / 8, row group rg = row / 8,
// half kc = (k % 8) / 4. Within a slice the kc stride (LBO) is 128 bytes
// and the rg stride (SBO) 256.
__device__ __forceinline__ int core_off(int row, int k, int rows) {
  return (k >> 3) * (rows * 8) + (row >> 3) * 64 + ((k >> 2) & 1) * 32 +
         (row & 7) * 4 + (k & 3);
}

__device__ __forceinline__ uint64_t desc(const float* p) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) |
         (uint64_t(256 >> 4) << 32);
}

// d (+)= A . B for one k8 slice: m64n128k8, A (tf32) from registers a,
// B from shared memory (descriptor db), f32 accumulators; scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A . B for one k8 slice: m64n64k8, A (tf32) from registers a,
// B from shared memory (descriptor db), f32 accumulators; scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int NB>
__device__ __forceinline__ void wgmma_rs(float (&d)[NB / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (NB == 128) wgmma_rs_n128(d, a, db, scale_d);
  else wgmma_rs_n64(d, a, db, scale_d);
}

__device__ __forceinline__ void split4(const float4 v, uint4& hi, uint4& lo) {
  split_tf32(v.x, hi.x, lo.x);
  split_tf32(v.y, hi.y, lo.y);
  split_tf32(v.z, hi.z, lo.z);
  split_tf32(v.w, hi.w, lo.w);
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
conv1d_same_wgmma(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ y,
               const Shape s) {
  using L = Tile<NB>;
  constexpr int NACC = L::NACC;
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wgi = warp >> 2, wq = warp & 3;
  const int t0 = blockIdx.x * BT, co0 = blockIdx.y * NB, b = blockIdx.z;
  const int p = (s.k - 1) / 2, width = BT + s.k - 1;
  const float* xb = x + (size_t)b * s.C * s.T;
  float* raw0 = smem + 2 * L::TILES;
  const int tr = wgi * 64 + wq * 16 + g;   // this thread's first time row

  // raw stage u: w [NB][LDA], the window [nch][ldx] (zero past C and
  // outside [0, T)), the offsets [BK]
  auto load_raw = [&](int buf, int u) {
    float* sa = raw0 + buf * s.stage;
    float* sx = sa + L::W_RAW;
    int* so = reinterpret_cast<int*>(sx + s.nch * s.ldx);
    const int r0 = u * BK, c_lo = r0 / s.k;
    for (int i = tid; i < NB * (BK / 4); i += kThreads) {
      const int m = i / (BK / 4), r = r0 + 4 * (i % (BK / 4));
      const bool ok = co0 + m < s.M && r < s.K;
      cp_async16(sa + m * LDA + (r - r0),
                 ok ? w + (size_t)(co0 + m) * s.K + r : w, ok);
    }
    for (int i = tid; i < s.nch * width; i += kThreads) {
      const int c = i / width, j = i - c * width;
      const int ci = c_lo + c, t = t0 - p + j;
      const bool ok = ci < s.C && t >= 0 && t < s.T;
      cp_async4(sx + c * s.ldx + j, ok ? xb + (size_t)ci * s.T + t : xb, ok);
    }
    if (tid < BK) {
      const int r = r0 + tid, c = r / s.k;
      so[tid] = (c - c_lo) * s.ldx + (r - c * s.k);
    }
  };

  // split raw stage rb's w into the hi and lo tiles of buffer tb; 8
  // consecutive threads take 8 rows of one 4-wide k group
  auto build = [&](int tb, int rb) {
    float* w_hi = smem + tb * L::TILES;
    float* w_lo = w_hi + L::W_TILE;
    const float* sa = raw0 + rb * s.stage;
#pragma unroll
    for (int it = 0; it < NB * BK / 4 / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int q = (idx >> 3) % (BK / 4);
      const int m = ((idx >> 3) / (BK / 4)) * 8 + (idx & 7);
      uint4 hi, lo;
      split4(*reinterpret_cast<const float4*>(sa + m * LDA + 4 * q), hi, lo);
      const int o = core_off(m, 4 * q, NB);
      *reinterpret_cast<uint4*>(w_hi + o) = hi;
      *reinterpret_cast<uint4*>(w_lo + o) = lo;
    }
    // the tiles are read by wgmma, through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  float acc[NACC], part[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0.f;

  const int nu = (s.K + BK - 1) / BK;
  load_raw(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  build(0, 0);
  __syncthreads();
  for (int u = 0; u < nu; ++u) {
    if (u + 1 < nu) load_raw((u + 1) & 1, u + 1);
    cp_async_commit();
    {
      // this stage's A fragments from the window: rows tr, tr + 8 (time),
      // columns t4, t4 + 4 of each k8 slice, split in registers
      const float* sx = raw0 + (u & 1) * s.stage + L::W_RAW;
      const int* so = reinterpret_cast<const int*>(sx + s.nch * s.ldx);
      uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
      for (int sl = 0; sl < BK / 8; ++sl) {
        const float* x0 = sx + so[sl * 8 + t4] + tr;
        const float* x1 = sx + so[sl * 8 + t4 + 4] + tr;
        split_tf32(x0[0], ah[sl][0], al[sl][0]);   // row g,   k t4
        split_tf32(x0[8], ah[sl][1], al[sl][1]);   // row g+8, k t4
        split_tf32(x1[0], ah[sl][2], al[sl][2]);   // row g,   k t4+4
        split_tf32(x1[8], ah[sl][3], al[sl][3]);   // row g+8, k t4+4
      }
      const float* w_hi = smem + (u & 1) * L::TILES;
      const float* w_lo = w_hi + L::W_TILE;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int sl = 0; sl < BK / 8; ++sl) {
        const uint64_t dbh = desc(w_hi + sl * NB * 8);
        const uint64_t dbl = desc(w_lo + sl * NB * 8);
        wgmma_rs<NB>(part, al[sl], dbh, sl > 0);   // lo*hi + hi*lo, hi*hi
        wgmma_rs<NB>(part, ah[sl], dbl, 1);
        wgmma_rs<NB>(part, ah[sl], dbh, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    if (u + 1 < nu) {   // the next stage's w tiles, while the wgmmas run
      cp_async_wait<0>();
      __syncthreads();
      build((u + 1) & 1, (u + 1) & 1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int e = 0; e < NACC; ++e) {
      asm volatile("" : "+f"(part[e])::"memory");
      acc[e] += part[e];
    }
    __syncthreads();
  }

  // acc[4j + 2h + e]: time row tr + 8h, channel 8j + 2 t4 + e
  float* yb = y + (size_t)b * s.M * s.T;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + 8 * j + 2 * t4 + e;
      if (co >= s.M) continue;
      const float bv = bias ? bias[co] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + tr + 8 * h;
        if (t < s.T) yb[(size_t)co * s.T + t] = acc[4 * j + 2 * h + e] + bv;
      }
    }
  }
}

template <int NB>
int launch(const float* x, const float* w, const float* bias, float* y, int B,
           int C, int T, int M, int k, cudaStream_t stream) {
  using L = Tile<NB>;
  Shape s;
  s.M = M, s.C = C, s.T = T, s.k = k, s.K = C * k;
  // BK consecutive rows r span at most (BK - 1) / k + 2 channels
  s.nch = (BK - 1) / k + 2 < BK ? (BK - 1) / k + 2 : BK;
  s.ldx = (BT + k - 1 + 3) & ~3;
  s.stage = (L::W_RAW + s.nch * s.ldx + BK + 3) & ~3;
  // two tile buffers and two raw stages
  const size_t smem = (size_t)(2 * L::TILES + 2 * s.stage) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const auto kernel = conv1d_same_wgmma<NB>;
  // the shared-memory limit, raised per device as a larger k needs it
  static int granted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if ((int)smem > granted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = (int)smem;
  }
  const long long m_tiles = ((long long)M + NB - 1) / NB;
  if (m_tiles > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((T + BT - 1) / BT, (unsigned)m_tiles, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, bias, y, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ttsx_conv1d_same_f32(const float* x, const float* w,
                                    const float* bias, float* y, int B, int C,
                                    int T, int M, int k, void* stream) {
  // w's rows are copied 16 bytes at a time: C a multiple of 4, w aligned
  if (B <= 0 || C <= 0 || T <= 0 || M <= 0 || k <= 0 || k % 2 == 0 ||
      C % 4 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)C * k > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (M <= 64) return launch<64>(x, w, bias, y, B, C, T, M, k, st);
  return launch<128>(x, w, bias, y, B, C, T, M, k, st);
}
