// K4: the causal diagonal-SSM recurrence of the S4 layer, as chunked
// products on the tensor cores in 3xTF32.
//
// Replaces the Pallas kernel ttsx/ops/s4_kernel.py (s4_scan_pallas, body
// _s4_head_kernel). On u [B, T, C = H*e], channel c = h*e + j holds d
// scalar states, for t = 0..T-1 from s = 0:
//     s_t[m] = exp(clip(a[h, m], -50, 50)) * s_{t-1}[m] + b[h, m] * u_t[c]
//     y_t[c] = sum_m c_full[h, m, j] * s_t[m]
// b folds into the readout (exact by linearity): with dec[m] the decay and
// cc[m, j] = c_full[h, m, j] * b[h, m], the states run on u alone,
// r_t = dec * r_{t-1} + u_t, and y_t[j] = sum_m cc[m, j] r_t[m, j].
//
// Bound on the H100: operations. The recurrence is 4 B T C d f32
// operations against 8 B T C bytes of u and y; on the f32 FMA pipe (67
// TFLOP/s) each mode is a chain of dependent steps. The decays depend on
// the head and the mode, not on the channel, so over a chunk of L steps
// the recurrence becomes two products per head whose A operands are
// powers of the decays (the chunked state-space form), the same 4 B T C
// d operations on the tensor cores. The TPU kernel instead builds d
// Toeplitz blocks [L, L] a head, about L times this work.
//
// Chunk k covers t = k L + tau, 0 <= tau < L; U_k is the head's [L, e]
// input block and R_k the state at t = k L - 1 (R_0 = 0):
//     end state from zero  E_k[m, j] = sum_s dec[m]^(L-1-s) U_k[s, j]
//     carry                R_{k+1} = dec^L * R_k + E_k
//     output               Y_k[tau, j] = sum_m dec[m]^(tau+1) cc[m, j]
//                                        R_k[m, j] + local_k[tau, j]
//     local part           local_k[tau, j] = sum_{l <= tau} K[l, j]
//                                            U_k[tau - l, j]
//     lag kernel           K[l, j] = sum_m dec[m]^l cc[m, j]
// Only non-negative powers are formed (dec^-s overflows f32), and dec^L is
// taken by squaring, so fast modes underflow to 0 as the true carry does.
//
// Design: one launch; a CTA takes KC channels (8, 4 or 2) of one head and
// one batch row and walks time in groups of G = 32 / KC chunks, so that a
// group is 32 rows (chunk, channel). The carried states stay in shared
// memory across groups, and no state leaves the SM. The products are
// taken transposed, rows (chunk, channel) as M, so that the modes are N:
// - the power table dec^p, p = 0..L, is built once per CTA; one layout
//   (rows of LDV = 36) gives bank-conflict-free B fragments to both
//   products: Vend^T[s][m] = dec^(L-1-s) and W^T[m][tau] = dec^(tau+1);
// - each warp owns n8 tiles of modes (two at a time): the end states from
//   zero E^T [rows][m] = U^T [rows][s] . Vend^T; a lane holds, for one
//   channel and two modes, the end states of a quad of consecutive chunks,
//   so the carry R_{k+1} = dec^L R_k + E_k runs in its registers, the
//   quads of a group in turn (a shuffle hands the state on), and turns E_k
//   into cc * R_k in place;
// - those accumulators are the A fragments of the output product, Y^T
//   [rows][tau] += (cc R)^T [rows][m] . W^T [m][tau], with the modes of a
//   k8 step taken in the order 2 t4, 2 t4 + 1 (the accumulator's column
//   pairs), so the weighted states never touch shared memory; each warp's
//   Y^T, over its own modes, goes to shared memory, and the warps' sums
//   are added in a fixed order;
// - the local part runs on the tensor cores too, one unit (channel, n8 tile
//   of chunks) a warp: the Toeplitz block of the channel's lag kernel [L,
//   L] (zero above the diagonal) . U_j [L][chunks]; a unit computes its
//   lag kernel K = W0 . cc once (a lane a lag, on the FMA pipe).
// Every product runs mma.sync m16n8k8 in 3xTF32 (tf32x3.cuh): operands
// split into TF32 hi + lo, lo.hi + hi.lo + hi.hi, a partial sum over 2 k8
// steps on the tensor cores (their f32 sums truncate) added in f32 on the
// FMA pipe. u arrives by cp.async one group ahead (16-byte copies where KC
// is 8 and the head's channels are 16-byte aligned, else 4-byte). The
// channel width is chosen from the grid (see ttsx_s4_scan_f32). Shared
// memory grows with d (the power table, cc and the carry, 212 B a mode at
// KC = 8), which caps d at kMaxModes.
// What holds it back on an H100 (PERF.md): mma.sync's rate and latency in
// 3xTF32 (three products, their splits and loads for each f32 product),
// and each group's fixed chain (the hand-over through shared memory, two
// barriers), which the narrow layers feel most.
//
// Layouts (row-major, f32): u, y [B, T, C]; a, b [H, d]; c_full [H, d, e].
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
constexpr int kChunk = 32;                   // L: time steps per chunk
constexpr int kRows = 32;                    // rows (chunk, channel) of a group
constexpr int LDV = kChunk + 4;              // power table rows: dec^0..dec^L
constexpr int kRedFloats = kWarps * kRows * kChunk;   // the warps' Y^T
constexpr int kMaxSmem = 227 * 1024;         // an H100 block's opt-in limit
static_assert(kWarps == 8 && kChunk == 32 && kRows == 32,
              "E^T and Y^T: two m16 row tiles; Y^T: four n8 tiles of steps; "
              "a lane's share of Y^T is 8 float4; a lane a lag");
static_assert(LDV % 8 == 4 && LDV >= kChunk + 1,
              "power table: bank-conflict-free B fragments in both products");

// A CTA takes KC channels of one head and groups of G = kRows / KC chunks.
// A lane of the products holds, for a channel, a quad of consecutive
// chunks: rows g and g + 8 of both row tiles (channel g % KC, quad g / KC).
template <int KC>
struct Tile {
  static constexpr int G = kRows / KC;         // chunks a group
  static constexpr int kQuads = G / 4;
  static constexpr int kSteps = G * kChunk;    // steps a group
  // u tile [chunk][step][channel], a chunk padded so that the A fragment
  // reads (channel and quad by g, step t4) fall in distinct banks, and
  // (KC = 8) a step's channels start 16-byte aligned
  static constexpr int LDU = kChunk * KC + (KC == 2 ? 2 : 4);
  static constexpr int kUFloats = G * LDU;
  static constexpr int kLocalUnits = KC * ((G + 7) / 8);   // (channel, n8 of chunks)
  static constexpr int kLagFloats = kLocalUnits * 2 * kChunk;   // 0 at l < 0
  static constexpr int kLocFloats = KC * G * kChunk;
  static constexpr int kFixedFloats =
      2 * kUFloats + kRedFloats + kLagFloats + kLocFloats;
  // per mode (d rounded up to 8): the power table, cc, the carry, dec^L
  static constexpr int kModeFloats = LDV + 2 * KC + 1;
  static constexpr int kMaxModes =
      (kMaxSmem / 4 - kFixedFloats) / kModeFloats / 8 * 8;
  static_assert(KC == 8 || KC == 4 || KC == 2, "a quad of chunks a lane");
  static_assert(KC == 8 || (LDU * 4) % 32 == 32 / kQuads,
                "quads 4 chunks apart: their A fragment reads in disjoint banks");
  static_assert(LDU % 4 == 0 || KC != 8, "16-byte copies of a step's 8 channels");
  static_assert(kLocalUnits <= kWarps, "local part: a unit a warp");
  static_assert(kRedFloats >= 2 * kMaxModes, "prologue scratch for a and b");
};
constexpr int kMaxModes = Tile<8>::kMaxModes;   // the fewest of the widths
static_assert(Tile<4>::kMaxModes >= kMaxModes && Tile<2>::kMaxModes >= kMaxModes,
              "every width takes kMaxModes");
static_assert(kMaxModes >= 288, "the zoo's widest layer (d = 284) fits");

struct Args {
  const float* u;
  const float* a;
  const float* b;
  const float* c;
  float* y;
  int T, C, d, e;
  int d8;       // d rounded up to 8: the n8 tiles of modes
  int groups;   // ceil(T / steps a group)
  int vec;      // u rows take 16-byte copies (KC = 8, e and u's address)
};

__device__ __forceinline__ float power(float x, int n) {   // x^n by squaring
  float r = 1.f;
  for (; n; n >>= 1) {
    if (n & 1) r *= x;
    x *= x;
  }
  return r;
}

// a B fragment (b0, b1) split into TF32 hi + lo
struct BFrag {
  uint32_t h0, l0, h1, l1;
};

__device__ __forceinline__ BFrag split_b(float b0, float b1) {
  BFrag f;
  split_tf32(b0, f.h0, f.l0);
  split_tf32(b1, f.h1, f.l1);
  return f;
}

// c (+)= a . b in 3xTF32, both split: lo.hi + hi.lo + hi.hi
template <bool kZero>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const BFrag& b) {
  mma_tf32<kZero>(c, al, b.h0, b.h1);
  mma_tf32<false>(c, ah, b.l0, b.l1);
  mma_tf32<false>(c, ah, b.h0, b.h1);
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
}

template <int KC>
__global__ void __launch_bounds__(kThreads, 2) s4_chunked_kernel(Args p) {
  using TL = Tile<KC>;
  constexpr int G = TL::G, LDU = TL::LDU;
  extern __shared__ float smem[];
  const int d8 = p.d8, Nm = d8 / 8;
  float* ptv = smem;                  // [d8][LDV]: dec^p, p = 0..L
  float* ccs = ptv + d8 * LDV;        // [d8][KC]: cc
  float* rs = ccs + d8 * KC;          // [d8][KC]: the carried states
  float* decl = rs + d8 * KC;         // [d8]: dec^L
  float* us = decl + d8;              // two u tiles
  float* red = us + 2 * TL::kUFloats; // [warp][row tile, n8 of steps][lane][4]
  float* kz = red + kRedFloats;       // [unit][2 kChunk]: lag kernels
  float* lt = kz + TL::kLagFloats;    // [KC][G][kChunk]: local parts

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int ch = g % KC, cq = g / KC;   // this lane's channel and quad
  const int h = blockIdx.y, j0 = blockIdx.x * KC;
  const int nj = min(KC, p.e - j0);
  const size_t base = (size_t)blockIdx.z * p.T * p.C + (size_t)h * p.e + j0;
  const float* ub = p.u + base;
  float* yb = p.y + base;

  // u steps of group grp into its tile, zeros past T and past the head
  auto stage = [&](int grp) {
    float* dst = us + (grp & 1) * TL::kUFloats;
    if (KC == 8 && p.vec) {   // 4 channels a copy; nj is a multiple of 4
      const int r = tid / 2, q = 4 * (tid % 2), t = grp * TL::kSteps + r;
      const bool ok = t < p.T && q < nj;
      cp_async16(dst + (r / kChunk) * LDU + (r % kChunk) * KC + q,
                 ok ? ub + (size_t)t * p.C + q : p.u, ok);
    } else {
      const int j = tid % KC;
      for (int r = tid / KC; r < TL::kSteps; r += kThreads / KC) {
        const int t = grp * TL::kSteps + r;
        const bool ok = t < p.T && j < nj;
        cp_async4(dst + (r / kChunk) * LDU + (r % kChunk) * KC + j,
                  ok ? ub + (size_t)t * p.C + j : p.u, ok);
      }
    }
  };

  // the head's decays and b (in the hand-over buffer until the first
  // group) and the tile's readout rows, by cp.async with group 0's u
  float* decs = red;
  float* bs = red + d8;
  for (int m = tid; m < d8; m += kThreads) {
    const int mm = min(m, p.d - 1);
    cp_async4(decs + m, p.a + h * p.d + mm, m < p.d);
    cp_async4(bs + m, p.b + h * p.d + mm, m < p.d);
  }
  for (int i = tid; i < d8 * KC; i += kThreads) {
    const int m = i / KC, j = i % KC;
    const bool ok = m < p.d && j < nj;
    cp_async4(ccs + i, ok ? p.c + ((size_t)h * p.d + m) * p.e + j0 + j : p.c,
              ok);
    rs[i] = 0.f;
  }
  stage(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int m = tid; m < d8; m += kThreads)
    decs[m] = m < p.d ? expf(fminf(fmaxf(decs[m], -50.f), 50.f)) : 0.f;
  for (int i = tid; i < d8 * KC; i += kThreads) ccs[i] *= bs[i / KC];
  __syncthreads();
  // the power table: a thread takes 8 powers of one mode, the first by
  // squaring; dec^L by squaring
  for (int i = tid; i < d8 * 4; i += kThreads) {
    const int m = i / 4, q0 = (i % 4) * 8;
    const float dec = decs[m];
    float v = power(dec, q0);
#pragma unroll
    for (int q = q0; q < q0 + 8; ++q) {
      ptv[m * LDV + q] = v;
      v *= dec;
    }
    if (q0 == kChunk - 8) {
      v = power(dec, kChunk);
      ptv[m * LDV + kChunk] = v;
      decl[m] = v;
    }
  }

  for (int grp = 0; grp < p.groups; ++grp) {
    cp_async_wait<0>();
    __syncthreads();   // group grp's u; (grp 0) the tables; the hand-over
                       // buffer, the local parts and group grp - 1's tile
                       // are free
    if (grp + 1 < p.groups) stage(grp + 1);
    cp_async_commit();
    const float* uc = us + (grp & 1) * TL::kUFloats;

    // local part of unit (channel j, n8 tile of chunks) = warp: the lag
    // kernel's Toeplitz block [L, L] (zero above the diagonal) . U_j [L][chunk];
    // each unit keeps its own copy of its channel's lag kernel
    // (the last warps: they hold the fewest n8 tiles of modes below)
    if (const int unit = kWarps - 1 - warp; unit < TL::kLocalUnits) {
      const int j = unit % KC, c0 = 8 * (unit / KC);
      float* kj = kz + unit * 2 * kChunk + kChunk;   // K[l] at kj[l]
      if (grp == 0) {   // K[l, j] = sum_m dec^l cc[m, j], l = lane
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int m = 0; m < d8; m += 4) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            s[i] = fmaf(ptv[(m + i) * LDV + lane], ccs[(m + i) * KC + j], s[i]);
        }
        kj[lane] = (s[0] + s[1]) + (s[2] + s[3]);
        kj[lane - kChunk] = 0.f;
      }
      __syncwarp();
      const bool okc = c0 + g < G;
      const float* ucol = uc + (c0 + g) * LDU + j;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float loc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 2 * mi + 2; ks += 2) {
          float part[4];
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int k0 = (ks + s) * 8;
            const float* pa = kj + mi * 16 + g - k0 - t4;
            const float av[4] = {pa[0], pa[8], pa[-4], pa[4]};
            uint32_t ah[4], al[4];
            split4(av, ah, al);
            const BFrag b = split_b(okc ? ucol[(k0 + t4) * KC] : 0.f,
                                    okc ? ucol[(k0 + t4 + 4) * KC] : 0.f);
            if (s == 0)
              mma3<true>(part, ah, al, b);
            else
              mma3<false>(part, ah, al, b);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) loc[i] += part[i];
        }
        // C fragment: steps 16 mi + g (+ 8), chunks c0 + 2 t4 (+ 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = c0 + 2 * t4 + i % 2;
          if (c < G) lt[(j * G + c) * kChunk + mi * 16 + g + 8 * (i / 2)] = loc[i];
        }
      }
    }

    // Y^T [(chunk, channel)][tau] over this warp's n8 tiles of modes, two
    // at a time; row g (g + 8) of row tile r is chunk 4 cq + 2 r (+ 1) of
    // channel ch
    float yacc[2][4][4] = {};
    const float* ua = uc + (4 * cq) * LDU + t4 * KC + ch;
    for (int nt0 = warp; nt0 < Nm; nt0 += 2 * kWarps) {
      const int nts[2] = {nt0, nt0 + kWarps};
      const bool two = nt0 + kWarps < Nm;
      // end states from zero: E^T = U^T [rows][sigma] . Vend^T [sigma][m]
      float e[2][2][4];   // [tile][row tile][c]
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ks += 2) {
        float part[2][2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int k0 = (ks + s) * 8;
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float* pa = ua + 2 * r * LDU + k0 * KC;
            const float av[4] = {pa[0], pa[LDU], pa[4 * KC], pa[LDU + 4 * KC]};
            split4(av, ah[r], al[r]);
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (q && !two) continue;
            // Vend^T[sigma][m] = dec[m]^(L-1-sigma)
            const float* pb = ptv + (8 * nts[q] + g) * LDV + (kChunk - 1 - k0 - t4);
            const BFrag b = split_b(pb[0], pb[-4]);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              if (s == 0)
                mma3<true>(part[q][r], ah[r], al[r], b);
              else
                mma3<false>(part[q][r], ah[r], al[r], b);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              e[q][r][i] = ks ? e[q][r][i] + part[q][r][i] : part[q][r][i];
      }
      // the carry: lane (g, t4) holds E_k of channel ch and modes 8 nt +
      // 2 t4 + {0, 1} for the chunks 4 cq + k, k = 0..3 (row tile k / 2, c
      // = 2 (k % 2) + mode); the quads walk in turn, each from the end
      // state of the one before (4 KC lanes lower); E_k becomes cc * R_k
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q && !two) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = 8 * nts[q] + 2 * t4 + i;
          const float D = decl[m], w = ccs[m * KC + ch];
          float r = rs[m * KC + ch];
#pragma unroll
          for (int qq = 0; qq < TL::kQuads; ++qq) {
            if (qq) {
              const float up = __shfl_up_sync(0xffffffffu, r, 4 * KC);
              if (cq == qq) r = up;
            }
            if (cq == qq) {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                float& v = e[q][k / 2][2 * (k % 2) + i];
                const float z = w * r;
                r = fmaf(D, r, v);
                v = z;
              }
            }
          }
          if (cq == TL::kQuads - 1) rs[m * KC + ch] = r;
        }
      }
      // outputs: Y^T += (cc R)^T [rows][m] . W^T [m][tau], W^T[m][tau] =
      // dec[m]^(tau+1); the accumulators of the carry are the A fragments,
      // with the modes of a k8 step in the order 2 t4, 2 t4 + 1
      float part[2][4][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q && !two) continue;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float av[4] = {e[q][r][0], e[q][r][2], e[q][r][1], e[q][r][3]};
          split4(av, ah[r], al[r]);
        }
        const float* pb = ptv + (8 * nts[q] + 2 * t4) * LDV + g + 1;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const BFrag b = split_b(pb[8 * n], pb[LDV + 8 * n]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (q == 0)
              mma3<true>(part[r][n], ah[r], al[r], b);
            else
              mma3<false>(part[r][n], ah[r], al[r], b);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) yacc[r][n][i] += part[r][n][i];
    }
    {
      float4* x = reinterpret_cast<float4*>(red) + warp * 8 * 32 + lane;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i * 32] = make_float4(yacc[i / 4][i % 4][0], yacc[i / 4][i % 4][1],
                                yacc[i / 4][i % 4][2], yacc[i / 4][i % 4][3]);
    }
    __syncthreads();   // every warp's Y^T and the local parts

    // a thread: one accumulator tile (row tile r, n8 of steps n) of one
    // lane's place: the warps' sums in a fixed order plus the local part,
    // stored; rows g, g + 8 are chunks c, c + 1 of channel ch, steps tau,
    // tau + 1
    {
      const int r = warp / 4, n = warp % 4;
      const float4* x = reinterpret_cast<const float4*>(red) + (r * 4 + n) * 32 + lane;
      float4 s = x[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float4 v = x[w * 8 * 32];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      const int c = 4 * cq + 2 * r, tau = 8 * n + 2 * t4;
      const float2 l0 = *reinterpret_cast<const float2*>(lt + (ch * G + c) * kChunk + tau);
      const float2 l1 = *reinterpret_cast<const float2*>(lt + (ch * G + c + 1) * kChunk + tau);
      if (ch < nj) {
        const int t = grp * TL::kSteps + c * kChunk + tau;
        if (t < p.T) yb[(size_t)t * p.C + ch] = s.x + l0.x;
        if (t + 1 < p.T) yb[(size_t)(t + 1) * p.C + ch] = s.y + l0.y;
        if (t + kChunk < p.T) yb[(size_t)(t + kChunk) * p.C + ch] = s.z + l1.x;
        if (t + kChunk + 1 < p.T) yb[(size_t)(t + kChunk + 1) * p.C + ch] = s.w + l1.y;
      }
    }
  }
}

// each kernel's dynamic shared-memory limit is raised once per device, to
// the most a block may opt in to; a launch then takes what it asks for
template <int KC>
cudaError_t allow_smem(int dev, int bytes) {
  static int allowed[64] = {};
  if (!allowed[dev]) {
    int most = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(s4_chunked_kernel<KC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    allowed[dev] = most;
  }
  return bytes <= allowed[dev] ? cudaSuccess : cudaErrorInvalidValue;
}

template <int KC>
cudaError_t launch(const float* u, const float* a, const float* b,
                   const float* c, float* y, int B, int T, int C, int H, int d,
                   int dev, cudaStream_t stream) {
  using TL = Tile<KC>;
  const int e = C / H, d8 = (d + 7) / 8 * 8;
  const Args p{u, a, b, c, y, T, C, d, e, d8,
               (T + TL::kSteps - 1) / TL::kSteps,
               KC == 8 && e % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0};
  const int bytes = (d8 * TL::kModeFloats + TL::kFixedFloats) * (int)sizeof(float);
  const cudaError_t err = allow_smem<KC>(dev, bytes);
  if (err != cudaSuccess) return err;
  s4_chunked_kernel<KC><<<dim3((e + KC - 1) / KC, H, B), kThreads, bytes,
                          stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The channel tile: 8 where its CTAs make at least two full rounds of
// resident CTAs (2 an SM: four per SM), so the last round's tail is short;
// else 4 where those cover the SMs; else 2. A narrower tile walks fewer,
// longer groups in more CTAs, so that a small grid does not leave SMs idle
// while each CTA walks all of T alone; a wider one builds the power table
// and lag kernels once for more channels.
extern "C" int ttsx_s4_scan_f32(const float* u, const float* a,
                                const float* b, const float* c_full, float* y,
                                int B, int T, int C, int H, int d, int L,
                                void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || H <= 0 || C % H != 0 || d <= 0 ||
      d > kMaxModes || L != kChunk || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  const long long rows = (long long)B * H;
  const int e = C / H;
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows * ((e + 7) / 8) >= 4LL * sms)
    return (int)launch<8>(u, a, b, c_full, y, B, T, C, H, d, dev, s);
  if (rows * ((e + 3) / 4) >= sms)
    return (int)launch<4>(u, a, b, c_full, y, B, T, C, H, d, dev, s);
  return (int)launch<2>(u, a, b, c_full, y, B, T, C, H, d, dev, s);
}
