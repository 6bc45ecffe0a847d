// K3: the collator's log-mel frontend, wav [B, N] -> log-mel [B, T, n_mels],
// as a float64 real FFT in shared memory.
//
// Replaces the Pallas kernel ttsx/ops/mel_kernel.py (mel_frontend_pallas,
// body _mel_kernel). Per frame (T = 1 + N / hop of them): the centred frame,
// reflect-padded by n_fft/2 at both ends (edge sample not repeated) ->
// window -> real DFT -> sqrt(re^2 + im^2 + 1e-12) -> filterbank ->
// log(mel + 1e-5). The reflect padding and the frame gather, which the
// Pallas version does on the XLA side, are index arithmetic here.
//
// Float64 from the windowed sample to the log. The sample is read as f32
// and widened; the window and the twiddles are float64 tables made on the
// host; the result is rounded to f32 once, at the store. So the output is
// the exact log-mel rounded to f32. The reference kernel's dense f32
// products are not: on the near-silent bands between a pure tone's
// harmonics their sums cancel, up to 5e-2 from the exact log-mel, and an
// f32 FFT does no better.
//
// Work and bound. A real FFT by packing, z[m] = x[2m] + i x[2m+1] through
// an M = n_fft/2 point complex FFT and one split step, is about 2.5 n_fft
// log2 n_fft operations a frame (25.6 k at n_fft 1024), against the
// 4 n_fft n_bins (2.1 M) of the TPU kernel's dense bases on its MXU. The
// H100 runs float64 FMAs at half its f32 rate (34 against 67 TFLOP/s), so
// the float64 FFT is also the cheap form: at the trainer's largest batch
// [16, 98,304] (6,160 frames) about 5 us at the FP64 peak, beside 2.5 us
// for the 8.4 MB of wav in and log-mel out. Not on the tensor cores: a DFT
// as products (1024 = 32 x 32 with 32-point DFT products on the float64
// DMMA, 67 TFLOP/s) is about 0.5 MFLOP a frame, 20x the FFT's count, and
// 3xTF32 of the dense bases 80x it at the plain version's accuracy; the
// FP64 pipe running the FFT does less work than any product form.
//
// Design: one CTA per (batch row, kFrames consecutive frames); a frame has
// kTpf = M / 16 threads, each holding 16 complex points in registers (8
// frames of one warp each at n_fft 1024; at most 128 registers, no
// spills, 105,504 bytes of shared memory: 2 CTAs an SM).
// - The CTA stages its span of the row, (frames - 1) hop + n_fft samples
//   from f0 hop - n_fft/2 (clipped to the row, whose reflection covers
//   the rest), once with cp.async: 16-byte copies, 4-byte ones at the two
//   ends where the row is not 16-byte aligned. It reflects into the span
//   by index. The float64 window and twiddles come in by cp.async too.
// - Stockham passes of radix 8 (the last of radix 16 or 4 where log2 M is
//   not a multiple of 3): a thread reads the points of its butterflies,
//   applies the twiddles, takes each R-point DFT in registers and writes
//   back in place, to a frame buffer padded one slot in eight so that
//   16-byte accesses do not conflict. The first pass packs and windows the
//   frame as it reads the span. Each later pass reads its own twiddle
//   table, laid out so that its reads do not conflict either (one shared
//   table read at stride 16 s r was an 8-way conflict, the largest cost
//   on an H100). A frame's threads meet at __syncwarp, or a named
//   barrier when a frame has two warps (n_fft 2048).
// - The split step X[k] = (Z[k] + Z*[M-k])/2 - i e^(-2 pi i k/n_fft)
//   (Z[k] - Z*[M-k])/2 takes k and M - k together, k = 0..M/2, which
//   gives the Nyquist bin X[M] with no loop of its own, and leaves the
//   magnitudes in the frame buffer.
// - The filterbank by its nonzero taps (from the host: each mel's first
//   bin, the packed weights and each mel's offset into them), a thread a
//   (mel, frame), mel-major, so that a warp's lanes share a tap count.
// What bounds it (H100, knock-out variants at [16, 98,304]): not the FP64
// pipe (it runs at about a seventh of the FP64 bound) but latency: the two
// later passes, the split step with its square roots, the filterbank's
// dependent sums and each CTA's staging before its first pass each hold a
// large share of the time.
// Domain: n_fft a power of two from 64 to 2048, hop <= n_fft, N > n_fft/2.
//
// Layouts (row-major): wav [B, N] f32; window [n_fft] f64; twiddle [kTw][2]
// f64: for each pass p >= 1, W_(Ns R)^(s r) at [s][r - 1] (s < Ns = 8^p,
// 1 <= r < R), then e^(-2 pi i k / n_fft) for k = 0..M/2 (the split step);
// taps [nnz] f64; first [n_mels] i32; offset [n_mels + 1] i32; out
// [B, T, n_mels] f32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

constexpr int kPoints = 16;    // complex points a thread holds in a pass
constexpr int kMaxSmem = 232448;
constexpr double kMagFloor = 1e-12;
constexpr double kLogEps = 1e-5;

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// Radix of pass p of an FFT of 2^lg points: 8, the last 16 or 4 where lg
// is not a multiple of 3; every pass before it is of radix 8, so pass p
// combines Ns = 8^p points.
__host__ __device__ constexpr int num_passes(int lg) {
  return lg / 3 + (lg % 3 == 2);
}
__host__ __device__ constexpr int radix(int lg, int p) {
  return p + 1 < num_passes(lg) ? 8 : lg % 3 == 1 ? 16 : lg % 3 == 2 ? 4 : 8;
}
// Offset of pass p's twiddles in the table: passes 1..p-1 hold
// Ns (R - 1) entries each; the split step's follow the last pass's.
__host__ __device__ constexpr int twiddle_offset(int lg, int p) {
  return p <= 1 ? 0
                : twiddle_offset(lg, p - 1) +
                      (1 << (3 * (p - 1))) * (radix(lg, p - 1) - 1);
}

// r read backwards in log2 R bits, R = 4, 8 or 16 (no loop, so that it
// folds to a constant once the register loops unroll)
__host__ __device__ constexpr int bit_reverse(int r, int R) {
  return R == 4   ? ((r & 1) << 1) | (r >> 1)
         : R == 8 ? ((r & 1) << 2) | (r & 2) | (r >> 2)
                  : ((r & 1) << 3) | ((r & 2) << 1) | ((r & 4) >> 1) | (r >> 3);
}

template <int M>
struct Geo {
  static constexpr int kLg = ilog2(M);
  static constexpr int kPasses = num_passes(kLg);
  static constexpr int kTpf = M / kPoints;                    // threads a frame
  static constexpr int kFrames = M >= 1024 ? 2 : 256 / kTpf;  // frames a CTA
  static constexpr int kThreads = kFrames * kTpf;
  // a frame's buffer: one slot in eight padded, and one more so that the
  // frames' magnitudes fall in different banks for the filterbank
  static constexpr int kLd = M + M / 8 + 1;
  static constexpr int kSplitTw = twiddle_offset(kLg, kPasses);
  static constexpr int kTw = kSplitTw + M / 2 + 1;   // twiddle entries
  static_assert(M == 1 << kLg && M >= 32 && M <= 1024,
                "n_fft is a power of two from 64 to 2048");
  static_assert(kPasses >= 2 && radix(kLg, 0) == 8, "the first pass packs");
  static_assert(kPoints % radix(kLg, kPasses - 1) == 0,
                "a thread holds whole butterflies");
  static_assert(kThreads <= 256 && kThreads % 32 == 0, "whole warps");
  static_assert(kTpf <= 32 ? 32 % kTpf == 0 : kThreads / kTpf <= 15,
                "frames do not straddle warps; named barriers suffice");
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

__device__ __forceinline__ double2 cmul(double2 z, double a, double b) {
  return make_double2(fma(z.x, a, -z.y * b), fma(z.x, b, z.y * a));
}

// z * e^(-2 pi i k / 16), k = 0..7 (a constant once the loops unroll)
__device__ __forceinline__ double2 rot16(double2 z, int k) {
  constexpr double c = 0.92387953251128675613;  // cos(pi/8)
  constexpr double s = 0.38268343236508977173;  // sin(pi/8)
  constexpr double h = 0.70710678118654752440;  // sqrt(1/2)
  switch (k) {
    case 0: return z;
    case 1: return cmul(z, c, -s);
    case 2: return make_double2((z.x + z.y) * h, (z.y - z.x) * h);
    case 3: return cmul(z, s, -c);
    case 4: return make_double2(z.y, -z.x);
    case 5: return cmul(z, -s, -c);
    case 6: return make_double2((z.y - z.x) * h, -(z.x + z.y) * h);
    default: return cmul(z, -c, -s);
  }
}

// R-point DFT of v[0..R) in registers (R = 4, 8 or 16), by radix-2
// decimation in frequency: X[r] lands in v[bit_reverse(r, R)]. Every loop
// has a fixed trip count, so all indices are constants once unrolled and
// v stays in registers.
template <int R>
__device__ __forceinline__ void dft(double2* v) {
  constexpr int kLevels = ilog2(R);
#pragma unroll
  for (int l = 0; l < kLevels; ++l)
#pragma unroll
    for (int u = 0; u < R / 2; ++u) {
      const int h = R >> (l + 1);                  // butterfly span
      const int a = (u / h) * 2 * h + u % h;
      const double2 x = v[a], y = v[a + h];
      v[a] = make_double2(x.x + y.x, x.y + y.y);
      v[a + h] = rot16(make_double2(x.x - y.x, x.y - y.y), (u % h) * (8 / h));
    }
}

// the threads of one frame: kTpf lanes of a warp, or kTpf / 32 warps
template <int kTpf>
__device__ __forceinline__ void frame_sync() {
  if constexpr (kTpf <= 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + (int)threadIdx.x / kTpf),
                 "n"(kTpf) : "memory");
  }
}

// Pass 0 (radix 8, no twiddles): points m = j + r M/8 of butterfly j are
// z[m] = x[2m] + i x[2m+1], the windowed samples of the frame that starts
// at row index `start`, reflected into the staged span `xs` (xs[s] is row
// sample s); a frame past T reads zeros.
template <int M>
__device__ __forceinline__ void first_pass(double2* buf, const float* xs,
                                           const double2* win2, bool live,
                                           int start, int N, int t) {
  using G = Geo<M>;
  constexpr int R = 8, Q = kPoints / R;
  double2 v[kPoints];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = t + q * G::kTpf;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int m = j + r * (M / R);
      int s0 = start + 2 * m, s1 = s0 + 1;
      s0 = s0 < 0 ? -s0 : s0 >= N ? 2 * (N - 1) - s0 : s0;
      s1 = s1 < 0 ? -s1 : s1 >= N ? 2 * (N - 1) - s1 : s1;
      const double2 w = win2[m];
      v[q * R + r] = live ? make_double2((double)xs[s0] * w.x,
                                         (double)xs[s1] * w.y)
                          : make_double2(0.0, 0.0);
    }
    dft<R>(v + q * R);
#pragma unroll
    for (int r = 0; r < R; ++r) buf[pad(j * R + r)] = v[q * R + bit_reverse(r, R)];
  }
  frame_sync<G::kTpf>();
}

// Stockham pass p (radix R, Ns = 8^p points already combined), in place:
// butterfly j reads in[j + r M/R] times W_(Ns R)^((j mod Ns) r), and its
// DFT's X[r] goes to out[(j / Ns) Ns R + j mod Ns + r Ns]. The pass's
// twiddles are laid out [j mod Ns][r - 1], so that the 8 lanes of a
// 16-byte access phase read entries R - 1 apart: no bank conflicts.
template <int M, int p>
__device__ __forceinline__ void fft_pass(double2* buf, const double2* tw,
                                         int t) {
  using G = Geo<M>;
  constexpr int R = radix(G::kLg, p), Q = kPoints / R;
  constexpr int Ns = 1 << (3 * p);
  double2 v[kPoints];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[q * R + r] = buf[pad(t + q * G::kTpf + r * (M / R))];
  frame_sync<G::kTpf>();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = t + q * G::kTpf;
    const double2* w = tw + twiddle_offset(G::kLg, p) + (j % Ns) * (R - 1);
#pragma unroll
    for (int r = 1; r < R; ++r)
      v[q * R + r] = cmul(v[q * R + r], w[r - 1].x, w[r - 1].y);
    dft<R>(v + q * R);
    const int d = (j / Ns) * Ns * R + j % Ns;
#pragma unroll
    for (int r = 0; r < R; ++r)
      buf[pad(d + r * Ns)] = v[q * R + bit_reverse(r, R)];
  }
  frame_sync<G::kTpf>();
}

template <int M, int p>
__device__ __forceinline__ void later_passes(double2* buf, const double2* tw,
                                             int t) {
  if constexpr (p < Geo<M>::kPasses) {
    fft_pass<M, p>(buf, tw, t);
    later_passes<M, p + 1>(buf, tw, t);
  }
}

// The split step on Z in `buf` (natural order): |X[k]| and |X[M - k]|,
// floored, for k = 0..M/2, written back as doubles mag[0..M]; tw holds
// e^(-2 pi i k / n_fft), k = 0..M/2.
template <int M>
__device__ __forceinline__ void split_magnitudes(double2* buf,
                                                 const double2* tw, int t) {
  using G = Geo<M>;
  constexpr int K = kPoints / 2 + 1;   // k = t + q kTpf <= M/2
  double lo[K], hi[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int k = t + q * G::kTpf;
    if (k <= M / 2) {
      const double2 a = buf[pad(k)], b = buf[pad((M - k) & (M - 1))];
      const double ex = 0.5 * (a.x + b.x), ey = 0.5 * (a.y - b.y);
      const double2 g = cmul(make_double2(0.5 * (a.x - b.x), 0.5 * (a.y + b.y)),
                             tw[k].x, tw[k].y);
      const double re0 = ex + g.y, im0 = ey - g.x;     // X[k]
      const double re1 = ex - g.y, im1 = -ey - g.x;    // X[M - k]
      lo[q] = sqrt(fma(re0, re0, fma(im0, im0, kMagFloor)));
      hi[q] = sqrt(fma(re1, re1, fma(im1, im1, kMagFloor)));
    }
  }
  frame_sync<G::kTpf>();
  double* mag = reinterpret_cast<double*>(buf);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int k = t + q * G::kTpf;
    if (k <= M / 2) {
      mag[k] = lo[q];
      mag[M - k] = hi[q];
    }
  }
}

template <int M>
__global__ void __launch_bounds__(Geo<M>::kThreads, 2)
mel_fft_kernel(const float* __restrict__ wav, const double* __restrict__ window,
               const double2* __restrict__ twiddle_table,
               const double* __restrict__ taps, const int* __restrict__ first,
               const int* __restrict__ offset, float* __restrict__ out, int N,
               int T, int hop, int n_mels) {
  using G = Geo<M>;
  extern __shared__ double2 smem[];
  double2* data = smem;                                   // [kFrames][kLd]
  double2* tw = data + G::kFrames * G::kLd;               // [kTw]
  double2* win2 = tw + G::kTw;                            // [M] window pairs
  float* xs = reinterpret_cast<float*>(win2 + M);         // the span
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * G::kFrames;
  const int nf = min(G::kFrames, T - f0);
  const float* w = wav + (size_t)b * N;

  // the row samples [lo, hi) that the CTA's frames reach after reflection
  const int s0 = f0 * hop - M, s1 = (f0 + nf - 1) * hop + M;
  int lo = max(s0, 0), hi = min(s1, N);
  if (s1 > N) lo = max(0, min(lo, 2 * N - 1 - s1));
  if (s0 < 0) hi = min(N, max(hi, 1 - s0));
  const int shift = (int)((reinterpret_cast<uintptr_t>(w + lo) >> 2) & 3);
  const int n = hi - lo;
  const int head = min(n, (4 - shift) & 3), body = (n - head) >> 2;
  float* span = xs + shift;                  // span[i] = row sample lo + i
  for (int i = threadIdx.x; i < G::kTw; i += G::kThreads)
    cp_async16(reinterpret_cast<float*>(tw + i),
               reinterpret_cast<const float*>(twiddle_table + i), true);
  for (int i = threadIdx.x; i < M; i += G::kThreads)
    cp_async16(reinterpret_cast<float*>(win2 + i),
               reinterpret_cast<const float*>(window + 2 * i), true);
  for (int i = threadIdx.x; i < head; i += G::kThreads)
    cp_async4(span + i, w + lo + i, true);
  for (int c = threadIdx.x; c < body; c += G::kThreads)
    cp_async16(span + head + 4 * c, w + lo + head + 4 * c, true);
  for (int i = head + 4 * body + threadIdx.x; i < n; i += G::kThreads)
    cp_async4(span + i, w + lo + i, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int slot = threadIdx.x / G::kTpf, t = threadIdx.x % G::kTpf;
  double2* buf = data + slot * G::kLd;
  first_pass<M>(buf, span - lo, win2, slot < nf, (f0 + slot) * hop - M, N, t);
  later_passes<M, 1>(buf, tw, t);
  split_magnitudes<M>(buf, tw + G::kSplitTw, t);
  __syncthreads();

  // the filterbank, mel-major over the CTA's frames: the lanes of a warp
  // take a few neighbouring mels, whose tap counts (2 to 24 bins at
  // n_fft 1024) are alike, so they do not wait on each other
  float* ob = out + ((size_t)b * T + f0) * n_mels;
  for (int i = threadIdx.x; i < nf * n_mels; i += G::kThreads) {
    const int m = i / nf, f = i - m * nf;
    const double* mag = reinterpret_cast<const double*>(data + f * G::kLd);
    const int k0 = __ldg(first + m) - __ldg(offset + m);
    double acc = 0.0;
    for (int o = __ldg(offset + m), o1 = __ldg(offset + m + 1); o < o1; ++o)
      acc = fma(__ldg(taps + o), mag[k0 + o], acc);
    ob[f * n_mels + m] = (float)log(acc + kLogEps);
  }
}

template <int M>
int launch(const float* wav, const double* window, const double* twiddle,
           const double* taps, const int* first, const int* offset,
           float* out, int B, int N, int hop, int n_mels,
           cudaStream_t stream) {
  using G = Geo<M>;
  const int T = 1 + N / hop;
  const size_t smem = sizeof(double2) * ((size_t)G::kFrames * G::kLd + G::kTw + M)
      + sizeof(float) * ((size_t)(G::kFrames - 1) * hop + 2 * M + 4);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mel_fft_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + G::kFrames - 1) / G::kFrames, B);
  mel_fft_kernel<M><<<grid, G::kThreads, smem, stream>>>(
      wav, window, reinterpret_cast<const double2*>(twiddle), taps, first,
      offset, out, N, T, hop, n_mels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ttsx_mel_frontend_f32(const float* wav, const double* window,
                                     const double* twiddle,
                                     const double* taps, const int* first,
                                     const int* offset, float* out, int B,
                                     int N, int n_fft, int hop, int n_mels,
                                     void* stream) {
  if (B <= 0 || hop <= 0 || hop > n_fft || n_mels <= 0 || N <= n_fft / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_fft) {
    case 64: return launch<32>(wav, window, twiddle, taps, first, offset, out, B, N, hop, n_mels, s);
    case 128: return launch<64>(wav, window, twiddle, taps, first, offset, out, B, N, hop, n_mels, s);
    case 256: return launch<128>(wav, window, twiddle, taps, first, offset, out, B, N, hop, n_mels, s);
    case 512: return launch<256>(wav, window, twiddle, taps, first, offset, out, B, N, hop, n_mels, s);
    case 1024: return launch<512>(wav, window, twiddle, taps, first, offset, out, B, N, hop, n_mels, s);
    case 2048: return launch<1024>(wav, window, twiddle, taps, first, offset, out, B, N, hop, n_mels, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
