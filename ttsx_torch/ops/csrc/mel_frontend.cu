// K3: the collator's log-mel frontend, wav [B, N] -> log-mel [B, T, n_mels].
//
// Replaces the Pallas kernel ttsx/ops/mel_kernel.py (mel_frontend_pallas,
// body _mel_kernel). Same arithmetic, frame by frame: reflect-padded frame
// (centred, n_fft/2 samples each side) x window -> real DFT
// (re = sum x cos, im = sum x sin over n) -> sqrt(re^2 + im^2 + 1e-12)
// -> @ filterbank -> log(mel + 1e-5). T = 1 + N / hop. The reflect
// padding and the frame gather, which the Pallas version does on the XLA
// side, are index arithmetic here: no padded copy, no frame tensor.
//
// Work: the DFT by dense bases, as the Pallas kernel does it for the MXU,
// costs 4 n_fft n_bins flops a frame and the mel projection 2 n_bins
// n_mels (2.18 MFLOP at n_fft 1024, 80 mels), about 70x what a real FFT
// and the filterbank's nonzero taps need. It stays dense: a radix-2 f32
// FFT in its place differs from the plain version (dense products) by up
// to 0.24 in log-mel on near-silent bands of pure tones, far outside the
// 1e-4 gate. An f32 FMA loop (no tensor cores: the port's numerics are
// full f32).
// Design: one CTA per (batch row, tile of kFrames frames). The CTA stages
// its frames, windowed, in shared memory as [n_fft][kFrames] (frame
// fastest), so the inner loop reads the kFrames values of one sample n as
// four 16-byte broadcast loads; the 4x overlap of frames at hop = n_fft/4
// costs only L2 reads while staging. Each thread owns two DFT bins for
// all kFrames frames (64 accumulators) and reads its twiddles from an
// n_fft-entry cos/sin table in shared memory at index (n k) mod n_fft,
// advanced by k per sample: the same f32 values as the reference's cos/sin
// bases, without their 4.2 MB. The Nyquist bin is one warp reduction per
// frame. The kFrames x n_bins magnitudes stay in shared memory and are
// projected onto the filterbank (read through L1/L2, coalesced over mels).
//
// Layouts (row-major, f32): wav [B, N]; window [n_fft]; twiddle [2, n_fft]
// (cos, then sin of 2 pi j / n_fft); fb [n_fft/2 + 1, n_mels];
// out [B, T, n_mels].
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 16;
constexpr int kMaxFft = 2048;

__global__ void __launch_bounds__(kThreads, 2)
mel_frontend_kernel(const float* __restrict__ wav,
                    const float* __restrict__ window,
                    const float* __restrict__ twiddle,
                    const float* __restrict__ fb, float* __restrict__ out,
                    int N, int T, int n_fft, int hop, int n_mels) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [n_fft][kFrames]
  float* tc = xs + n_fft * kFrames;              // [n_fft] cos
  float* ts = tc + n_fft;                        // [n_fft] sin
  float* mag = ts + n_fft;                       // [kFrames][n_bins]
  const int half = n_fft / 2;
  const int n_bins = half + 1;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const float* w = wav + (size_t)b * N;

  for (int i = threadIdx.x; i < n_fft; i += kThreads) {
    tc[i] = twiddle[i];
    ts[i] = twiddle[n_fft + i];
  }
  for (int i = threadIdx.x; i < kFrames * n_fft; i += kThreads) {
    const int f = i / n_fft;
    const int n = i - f * n_fft;
    float v = 0.f;
    if (f0 + f < T) {
      int s = (f0 + f) * hop + n - half;  // index into the unpadded wav
      if (s < 0) s = -s;                  // reflect, edge not repeated
      if (s >= N) s = 2 * (N - 1) - s;
      v = w[s] * window[n];
    }
    xs[n * kFrames + f] = v;
  }
  __syncthreads();

  // bins [0, half): two per thread and pass
  for (int k0 = threadIdx.x; k0 < half; k0 += 2 * kThreads) {
    const int k1 = k0 + kThreads < half ? k0 + kThreads : 0;
    float re0[kFrames], im0[kFrames], re1[kFrames], im1[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) re0[f] = im0[f] = re1[f] = im1[f] = 0.f;
    int i0 = 0, i1 = 0;  // (n k) mod n_fft
    for (int n = 0; n < n_fft; ++n) {
      const float c0 = tc[i0], s0 = ts[i0], c1 = tc[i1], s1 = ts[i1];
      const float4* xv = reinterpret_cast<const float4*>(xs + n * kFrames);
#pragma unroll
      for (int q = 0; q < kFrames / 4; ++q) {
        const float4 v = xv[q];
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int f = 4 * q + j;
          re0[f] = fmaf(e[j], c0, re0[f]);
          im0[f] = fmaf(e[j], s0, im0[f]);
          re1[f] = fmaf(e[j], c1, re1[f]);
          im1[f] = fmaf(e[j], s1, im1[f]);
        }
      }
      i0 += k0;
      if (i0 >= n_fft) i0 -= n_fft;
      i1 += k1;
      if (i1 >= n_fft) i1 -= n_fft;
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      mag[f * n_bins + k0] = sqrtf(re0[f] * re0[f] + im0[f] * im0[f] + 1e-12f);
      if (k1 != 0)
        mag[f * n_bins + k1] =
            sqrtf(re1[f] * re1[f] + im1[f] * im1[f] + 1e-12f);
    }
  }

  // the Nyquist bin k = half: one warp per frame, lanes split n
  const int lane = threadIdx.x & 31;
  for (int f = threadIdx.x >> 5; f < kFrames; f += kThreads / 32) {
    float re = 0.f, im = 0.f;
    for (int n = lane; n < n_fft; n += 32) {
      const int i = (int)(((long long)n * half) % n_fft);
      re = fmaf(xs[n * kFrames + f], tc[i], re);
      im = fmaf(xs[n * kFrames + f], ts[i], im);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      re += __shfl_down_sync(0xffffffffu, re, o);
      im += __shfl_down_sync(0xffffffffu, im, o);
    }
    if (lane == 0) mag[f * n_bins + half] = sqrtf(re * re + im * im + 1e-12f);
  }
  __syncthreads();

  float* ob = out + (size_t)b * T * n_mels;
  for (int i = threadIdx.x; i < kFrames * n_mels; i += kThreads) {
    const int f = i / n_mels;
    const int m = i - f * n_mels;
    if (f0 + f >= T) continue;
    const float* mf = mag + f * n_bins;
    float acc = 0.f;
    for (int k = 0; k < n_bins; ++k)
      acc = fmaf(mf[k], __ldg(fb + (size_t)k * n_mels + m), acc);
    ob[(size_t)(f0 + f) * n_mels + m] = logf(acc + 1e-5f);
  }
}

}  // namespace

extern "C" int ttsx_mel_frontend_f32(const float* wav, const float* window,
                                     const float* twiddle, const float* fb,
                                     float* out, int B, int N, int n_fft,
                                     int hop, int n_mels, void* stream) {
  if (B <= 0 || n_fft <= 0 || n_fft % 2 || n_fft > kMaxFft || hop <= 0 ||
      n_mels <= 0 || N <= n_fft / 2)
    return (int)cudaErrorInvalidValue;
  const int T = 1 + N / hop;
  const size_t smem =
      ((size_t)n_fft * (kFrames + 2) + (size_t)kFrames * (n_fft / 2 + 1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mel_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kFrames - 1) / kFrames, B);
  mel_frontend_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      wav, window, twiddle, fb, out, N, T, n_fft, hop, n_mels);
  return (int)cudaGetLastError();
}
