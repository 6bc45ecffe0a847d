// K1: ConvTranspose1d(k = 2f, stride f) cropped to T*f rows, plus bias, as
// an implicit GEMM on the tensor cores in 3xTF32.
//
// Replaces the Pallas kernel ttsx/ops/upsample_kernel.py (_upsample_impl,
// body _upsample_body). Same arithmetic: with c = f / 2 the reference builds
// three tap banks [Cin, f*Cout] and computes, per input row t,
//     out[t, n] = x[t-1] . w_prv[:, n] + x[t] . w_cur[:, n]
//               + x[t+1] . w_nxt[:, n] + bias[n % Cout]
// and reads out [B, T, f*Cout] as y [B, T*f, Cout]. Column n = j*Cout + co
// (phase j) of bank cur is tap 2f-1-j-c of w. Of the other two banks only
// one is nonzero: tap 3f-1-j-c on x[t+1] when j >= f-c ("next"), else tap
// f-1-j-c on x[t-1] ("prev"). So every column has two nonzero banks, and
// the prev columns are exactly those below split = (f-c)*Cout.
//
// GEMM view: M = the T input rows of one batch item, N = f*Cout, K = Cin
// for each of the two banks of a column. Output row t is one contiguous
// f*Cout row of y, so the stores are coalesced at every stage.
//
// Bound on the H100: operations at generator stages 0-1 (Cin 256 / 128, N
// 1024 / 512), bytes at stages 2-3 (N 64 / 32: x read and y written). The
// f32 FMA pipe caps at 67 TFLOP/s; the tensor cores run TF32 at 495.
// 3xTF32 splits each operand a = hi + lo (hi = a rounded to TF32, lo = a -
// hi) and sums lo*hi + hi*lo, then hi*hi, in f32 (CUTLASS's order): three
// TF32 products per f32 product, with an error near f32's (the dropped
// lo*lo is 2^-22 relative). A fragment is split as it leaves shared
// memory; a weight fragment serves all the warp's rows. The tensor cores'
// f32 sums truncate: summing all 2*Cin products of a column there missed
// the f32 gates at Cin 256 (1.5e-5 off plain on an H100), so every kFlush
// k8 steps the partial sum (32 products a column) starts from zero and is
// added to the accumulator on the FMA pipe, rounded to nearest. The
// cp.async, split and MMA helpers are in tf32x3.cuh, shared with K2 and K5.
//
// Design: a CTA owns BM input rows of one batch item x BN columns. Per K
// chunk of KC channels it stages, with cp.async into kStages buffers,
// (BM + 2) rows of x (row s holds x[t0 - 1 + s], zero outside [0, T), so a
// tile never reads another batch item) and two [KC, BN] weight tiles, cur
// and other, gathered per group of 4 columns from w's taps (4 columns
// share a phase since Cout % 4 == 0). Each warp owns TM rows x 32 columns
// (MI x 4 tiles of mma.sync m16n8k8): bank cur reads the staged x at row
// offset 1, bank other at offset 0 (prev) or 2 (next), chosen per n8 tile.
// When split is a multiple of 8 (Cout % 8 == 0, every zoo stage) each n8
// tile lies on one side of it, so a warp whose columns cross split (zoo
// stage 3: N 32, split 16) runs the other bank once, its prev tiles at
// offset 0 and its next tiles at offset 2. Only when split falls inside an
// n8 tile (Cout 12 or 4 at f 2, in the tests) does a warp run both offsets
// on all its tiles, each with B zeroed in the columns of the other kind,
// 1.5x the MMAs. Tiles: N >
// 64 (the compute-bound stages) 128 x 128 a CTA, 64 x 32 a warp, one CTA
// an SM with up to 255 registers; N <= 64, all of N in one CTA (64 or 32
// columns) and 32 x 32 a warp, two CTAs an SM. PERF.md says how the
// alternatives tried fared (one buffer, other tiles, other flush periods,
// operands split once per chunk in shared memory, persistent CTAs).
//
// Layouts (row-major, f32): x [B, T, Cin]; w [2f, Cin, Cout] (tap-major,
// the flax ConvTranspose layout); bias [Cout]; y [B, T*f, Cout].
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::mma_tf32;
using tf32x3::split_tf32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;     // cp.async buffers of the K loop
constexpr int KC = 32;         // K chunk: channels staged per step
constexpr int kWarpN = 32;
constexpr int kWideTM = 64;    // rows per warp when N > 64 (stages 0-1)
constexpr int kNarrowTM = 32;  // rows per warp when N <= 64 (stages 2-3)
constexpr int kFlush = 2;      // k8 steps summed on the tensor cores per partial
static_assert((KC / 8) % kFlush == 0, "every partial sum is flushed");
enum { kPrev = 0, kNext = 1, kTiles = 2, kMixed = 3 };

template <int BN, int TM>
struct Tile {
  static constexpr int WN = BN / kWarpN;   // warps across N
  static constexpr int WM = kWarps / WN;   // warps across M
  static constexpr int BM = WM * TM;       // input rows per CTA
  static constexpr int MI = TM / 16;       // m16 tiles per warp
  static constexpr int NI = kWarpN / 8;    // n8 tiles per warp
  static constexpr int LDA = KC + 4;       // conflict-free A fragment reads
  static constexpr int LDB = BN + 8;       // conflict-free B fragment reads
  static constexpr int A_FLOATS = (BM + 2) * LDA;
  static constexpr int STAGE = A_FLOATS + 2 * KC * LDB;
  static_assert(WN * WM == kWarps && TM % 16 == 0, "tile shape");
  static_assert(TM == 32 || TM == 64, "launch bounds: 64 / TM CTAs an SM");
  static_assert(kThreads % (BN / 4) == 0, "one 4-column group per thread");
};

// B fragments of one k8 step: [n8 tile][hi, lo][k = t4, t4 + 4]
template <int NI>
using BFrag = uint32_t[NI][2][2];

// acc (= if kFirst) += A . B in 3xTF32 for one k8 step, on the n8 tiles
// [n_lo, n_hi) of the warp. a points at the thread's element (row g,
// column t4) of the warp's first m16 tile in the staged x.
template <class L, bool kFirst>
__device__ __forceinline__ void mma_3x(float (&acc)[L::MI][L::NI][4],
                                       const float* a, const BFrag<L::NI>& b,
                                       int n_lo = 0, int n_hi = L::NI) {
  uint32_t ah[L::MI][4], al[L::MI][4];
#pragma unroll
  for (int mi = 0; mi < L::MI; ++mi) {
    const float* p = a + mi * 16 * L::LDA;
    split_tf32(p[0], ah[mi][0], al[mi][0]);                // row g,   k t4
    split_tf32(p[8 * L::LDA], ah[mi][1], al[mi][1]);       // row g+8, k t4
    split_tf32(p[4], ah[mi][2], al[mi][2]);                // row g,   k t4+4
    split_tf32(p[8 * L::LDA + 4], ah[mi][3], al[mi][3]);   // row g+8, k t4+4
  }
#pragma unroll
  for (int mi = 0; mi < L::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < L::NI; ++ni)
      if (ni >= n_lo && ni < n_hi)
        mma_tf32<kFirst>(acc[mi][ni], al[mi], b[ni][0][0], b[ni][0][1]);
#pragma unroll
  for (int mi = 0; mi < L::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < L::NI; ++ni)
      if (ni >= n_lo && ni < n_hi)
        mma_tf32<false>(acc[mi][ni], ah[mi], b[ni][1][0], b[ni][1][1]);
#pragma unroll
  for (int mi = 0; mi < L::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < L::NI; ++ni)
      if (ni >= n_lo && ni < n_hi)
        mma_tf32<false>(acc[mi][ni], ah[mi], b[ni][0][0], b[ni][0][1]);
}

// the B fragments of one bank for one k8 step, split
template <class L>
__device__ __forceinline__ void load_b(BFrag<L::NI>& b, const float* p) {
#pragma unroll
  for (int ni = 0; ni < L::NI; ++ni) {
    split_tf32(p[ni * 8], b[ni][0][0], b[ni][1][0]);
    split_tf32(p[ni * 8 + 4 * L::LDB], b[ni][0][1], b[ni][1][1]);
  }
}

template <int BN, int TM>
__global__ void __launch_bounds__(kThreads, 64 / TM)
upsample_mma(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ y, int T,
             int Cin, int Cout, int f, int vec_x) {
  using L = Tile<BN, TM>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wn = warp % L::WN, wm = warp / L::WN;
  const int N = f * Cout, c = f / 2, split = (f - c) * Cout;
  const int n0 = blockIdx.x * BN, t0 = blockIdx.y * L::BM, b = blockIdx.z;
  const float* xb = x + (size_t)b * T * Cin;

  // this thread's 4-column group of the weight tiles, the same every chunk
  constexpr int kGroups = BN / 4, kRowStep = kThreads / kGroups;
  const int q = tid % kGroups;
  const int nq = n0 + 4 * q;
  const bool nq_ok = nq < N;
  const float *wcur = w, *woth = w;
  if (nq_ok) {
    const int j = nq / Cout, co = nq - j * Cout;
    const int i_cur = 2 * f - 1 - j - c;
    const int i_oth = j >= f - c ? 3 * f - 1 - j - c : f - 1 - j - c;
    wcur = w + (size_t)i_cur * Cin * Cout + co;
    woth = w + (size_t)i_oth * Cin * Cout + co;
  }

  auto load_chunk = [&](int buf, int k0) {
    float* sa = smem + buf * L::STAGE;
    float* sb = sa + L::A_FLOATS;
    if (vec_x) {
      for (int i = tid; i < (L::BM + 2) * (KC / 4); i += kThreads) {
        const int s = i / (KC / 4), k = k0 + 4 * (i % (KC / 4));
        const int t = t0 - 1 + s;
        const bool ok = t >= 0 && t < T && k < Cin;
        cp_async16(sa + s * L::LDA + (k - k0),
                   ok ? xb + (size_t)t * Cin + k : xb, ok);
      }
    } else {
      for (int i = tid; i < (L::BM + 2) * KC; i += kThreads) {
        const int s = i / KC, k = k0 + i % KC;
        const int t = t0 - 1 + s;
        const bool ok = t >= 0 && t < T && k < Cin;
        cp_async4(sa + s * L::LDA + (k - k0),
                  ok ? xb + (size_t)t * Cin + k : xb, ok);
      }
    }
#pragma unroll
    for (int r = tid / kGroups; r < KC; r += kRowStep) {
      const bool ok = nq_ok && k0 + r < Cin;
      const size_t off = ok ? (size_t)(k0 + r) * Cout : 0;
      cp_async16(sb + r * L::LDB + 4 * q, wcur + off, ok);
      cp_async16(sb + (KC + r) * L::LDB + 4 * q, woth + off, ok);
    }
  };

  // the warp's columns: all prev, all next, the first n_prev n8 tiles
  // prev and the rest next, or both inside one tile (B masked per column)
  const int wc0 = n0 + wn * kWarpN;
  const bool live = wc0 < N;
  const int n_prev = (split - wc0) / 8;
  const int mode = wc0 + kWarpN <= split ? kPrev
                   : wc0 >= split        ? kNext
                   : split % 8 == 0      ? kTiles
                                         : kMixed;

  float acc[L::MI][L::NI][4];
#pragma unroll
  for (int mi = 0; mi < L::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < L::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int nk = (Cin + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_chunk(s, s * KC);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    const int ahead = kc + kStages - 1;
    if (ahead < nk) load_chunk(ahead % kStages, ahead * KC);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (live) {
      const float* sa = smem + (kc % kStages) * L::STAGE;
      const float* a = sa + (wm * TM + g) * L::LDA + t4;
      const float* bc = sa + L::A_FLOATS + wn * kWarpN + g;
      const float* bo = bc + KC * L::LDB;
      float part[L::MI][L::NI][4];
#pragma unroll
      for (int kk = 0; kk < KC; kk += 8) {
        // both banks' products go to the partial sum, which restarts from
        // zero every kFlush k8 steps and is then added to acc (header)
        BFrag<L::NI> fb;
        load_b<L>(fb, bc + (kk + t4) * L::LDB);
        if ((kk / 8) % kFlush == 0)
          mma_3x<L, true>(part, a + L::LDA + kk, fb);
        else
          mma_3x<L, false>(part, a + L::LDA + kk, fb);
        load_b<L>(fb, bo + (kk + t4) * L::LDB);
        if (mode == kPrev || mode == kNext) {
          mma_3x<L, false>(part, a + (mode == kNext ? 2 : 0) * L::LDA + kk, fb);
        } else if (mode == kTiles) {
          mma_3x<L, false>(part, a + kk, fb, 0, n_prev);
          mma_3x<L, false>(part, a + 2 * L::LDA + kk, fb, n_prev, L::NI);
        } else {
#pragma unroll
          for (int pass = 0; pass < 2; ++pass) {   // 0: prev, 1: next
            BFrag<L::NI> fm;
#pragma unroll
            for (int ni = 0; ni < L::NI; ++ni) {
              const bool keep = (wc0 + ni * 8 + g >= split) == (pass == 1);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                fm[ni][h][0] = keep ? fb[ni][h][0] : 0u;
                fm[ni][h][1] = keep ? fb[ni][h][1] : 0u;
              }
            }
            mma_3x<L, false>(part, a + 2 * pass * L::LDA + kk, fm);
          }
        }
        if ((kk / 8) % kFlush == kFlush - 1) {
#pragma unroll
          for (int mi = 0; mi < L::MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < L::NI; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
        }
      }
    }
    __syncthreads();
  }

  if (!live) return;
  float* yb = y + (size_t)b * T * N;
#pragma unroll
  for (int ni = 0; ni < L::NI; ++ni) {
    const int n = wc0 + ni * 8 + 2 * t4;
    if (n >= N) continue;
    const float2 bv = *reinterpret_cast<const float2*>(bias + n % Cout);
#pragma unroll
    for (int mi = 0; mi < L::MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + wm * TM + mi * 16 + g + 8 * h;
        if (t < T)
          *reinterpret_cast<float2*>(yb + (size_t)t * N + n) = make_float2(
              acc[mi][ni][2 * h] + bv.x, acc[mi][ni][2 * h + 1] + bv.y);
      }
    }
  }
}

template <int BN, int TM>
int launch(const float* x, const float* w, const float* bias, float* y, int B,
           int T, int Cin, int Cout, int f, cudaStream_t stream) {
  using L = Tile<BN, TM>;
  const auto kernel = upsample_mma<BN, TM>;
  const size_t full = (size_t)kStages * L::STAGE * sizeof(float);
  // the shared-memory limit is set once per device for this instantiation
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)full);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  // a single K chunk uses one buffer: the smaller request fits more CTAs
  const int nk = (Cin + KC - 1) / KC;
  const size_t smem =
      (size_t)(nk < kStages ? nk : kStages) * L::STAGE * sizeof(float);
  const int N = f * Cout;
  const long long row_tiles = ((long long)T + L::BM - 1) / L::BM;
  if (row_tiles > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const int vec_x = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dim3 grid((N + BN - 1) / BN, (unsigned)row_tiles, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, bias, y, T, Cin, Cout, f,
                                           vec_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ttsx_upsample_f32(const float* x, const float* w,
                                 const float* bias, float* y, int B, int T,
                                 int Cin, int Cout, int f, void* stream) {
  if (B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || f <= 0 || Cout % 4 != 0)
    return (int)cudaErrorInvalidValue;
  // weight tiles go by 16-byte cp.async, bias by 8-byte loads, y by 8-byte
  // stores
  if (reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(bias) % 8 ||
      reinterpret_cast<uintptr_t>(y) % 8)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  const int N = f * Cout;
  if (N > 64) return launch<128, kWideTM>(x, w, bias, y, B, T, Cin, Cout, f, s);
  if (N > 32) return launch<64, kNarrowTM>(x, w, bias, y, B, T, Cin, Cout, f, s);
  return launch<32, kNarrowTM>(x, w, bias, y, B, T, Cin, Cout, f, s);
}
