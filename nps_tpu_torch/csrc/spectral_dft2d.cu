// spectral_dft2d_fwd: 2D mode-truncated spectral convolution as truncated
// DFTs and a per-mode complex channel mix.
//
// Replaces the TPU kernel K1, nps_tpu/ops/pallas/spectral_dft.py (retired;
// in git at 92d7866^): _kernel / _forward_padded (pl.pallas_call) behind
// spectral_dft_conv_2d_pallas. Same math as the live reference
// nps_tpu/ops/spectral.py:_spectral_conv_2d_dft:
//   X[k, m]  = sum_{x,y} u[x, y] e^{-2 pi i (kx x / n1 + m y / n2)}
//              for the 2*m1 row modes kx in [0, m1) u [n1-m1, n1), m < m2
//   Y[k, m]  = sum_i X_i[k, m] W_io[k, m]   (FiLM: Y *= 1 + f or Y *= f)
//   out[x,y] = 1/(n1 n2) Re sum_{k,m} h(m) Y[k, m] e^{+2 pi i (...)}
//              with Hermitian doubling h(m) = 1 for m = 0 (and n2/2), else 2.
//
// Bound on the H100: memory bandwidth. At the main path (b=4, ci=196, co=192,
// 96x64 grid, modes 10x10) the weights are 2*196*192*200*4 B = 60 MB (more
// than the 50 MB L2) and the activations 19 MB in and 19 MB out; the flops
// (~1 GFLOP) take ~15 us at 67 TFLOP/s f32, the bytes ~29 us at 3.35 TB/s.
// The stages stay f32 on the CUDA cores: TF32 tensor cores would not hold
// the 1e-5 bar against the plain version, and the flops are not the bound.
//
// Design: three kernels on the caller's stream, with f32 scratch for the
// retained spectrum between them (X and Y, [modes, b, c], ~1 MB). What held
// each stage back in the first version, and what this one does about it:
//   1. forward DFT (dft_fwd_kernel): the first version loaded two cos/sin
//      table entries from device memory per FMA pair and staged one plane
//      per CTA before computing it. Now a grid of resident CTAs (occupancy x
//      SMs) walks the (sample, channel) planes with the tables staged in
//      shared memory once per CTA, and copies its next plane with 16-byte
//      cp.async copies as soon as the y pass has read this one, so the copy
//      overlaps the x pass. Along y a thread owns one row and m2/2 of its
//      column modes in registers (a register-tiled [n1, n2] x [n2, 2 m2]
//      product: each x value feeds m2 FMAs against broadcast table reads).
//      Along x a warp takes four row modes; each lane of a row mode takes
//      every 8th row with all 2*m2 accumulators, and the 8 lanes sum their
//      partials by shuffles in a fixed order.
//   2. mix (mix_kernel): the first version cut co=192 into tiles of 128
//      (half of every second tile idle) and streamed 4-byte weights with
//      too few bytes in flight. Now one CTA per (mode, 64 output channels):
//      a thread owns 4 consecutive output channels (float4) for a register
//      tile of BT samples (BT sized to b: 1, 2, 4 or 8; a larger b loops
//      over tiles) and a share of the input channels; [16 ci, 64 co] re/im
//      weight tiles stream through a 4-stage cp.async ring in shared memory
//      (the first chunks issued before the mode's spectrum is read, which
//      is read coalesced along ci), and the ~600 CTAs are resident
//      together. The ci shares are summed in a fixed order in shared memory
//      (no atomics); FiLM is applied in that epilogue.
//   3. inverse DFT (dft_inv_kernel): the first version expanded columns
//      first and loaded two table entries per FMA pair. Now rows first, on
//      the retained 2*m1 x m2 spectrum (-> [n1, m2] complex), then columns
//      with the Hermitian doubling folded in, real part only: 399,360 flops
//      per 96x64 plane instead of 593,920. A grid of resident CTAs walks
//      the planes; the next plane's spectrum is copied (cp.async) while the
//      column pass of this one runs. In the column pass a thread owns 4
//      adjacent output pixels of a row and holds their 2*m2 x 4 cos/sin
//      factors in registers; consecutive threads write consecutive 16-byte
//      stores.
// The mix and the inverse are launched with programmatic stream
// serialization: the mix streams its first weight chunks, and the inverse
// stages its tables, while the stage before finishes; each waits for the
// stage before's results (griddepcontrol.wait) before it reads them.
// The m2 loops are unrolled over a compile-time bound M2 (4, 8, 10 or 16,
// tables zero-padded); shapes whose rows are not a multiple of 4 floats take
// the scalar (V = 1) variants. Each kernel's shared-memory opt-in is set once
// per process. No stage calls a library.
//
// Layout contract: x f32 [b, ci, n1, n2] contiguous (NCHW); w_packed f32
// [2*m1*m2, 2, ci, co] with mode index k*m2 + m (row modes low then high);
// film f32 [b, co, 2*m1, m2] or null; tables f32: c2,s2 [n2, m2],
// c1,s1 [n1, 2m1], ic2,is2 [m2, n2], ic1,is1 [2m1, n1]; scratch xr,xi
// [modes, b, ci] and yr,yi [modes, b, co]; out f32 [b, co, n1, n2]; with
// FiLM and a gradient to come, ur,ui [modes, b, co] keep the pre-FiLM Y.
//
// spectral_dft2d_bwd and spectral_dw2d: the backward. They replace
// _pallas_bwd (nps_tpu/ops/pallas/spectral_dft.py:175 at git 92d7866^), a
// jax.vjp of the XLA form: the TPU had no backward kernel. The conv is
// linear, and the inverse's per-mode factor h(m)/(n1 n2) is real, so the
// input gradient is the same three stages run on dy [b, co, n1, n2] with the
// conjugate transpose of the weights:
//   G[k, m]  = truncated DFT of dy                       (dft_fwd_kernel)
//   H_i      = sum_o conj(W_io) G_o  per mode            (mix_adj_kernel)
//   dx       = inverse truncated DFT of H, h/(n1 n2)     (dft_inv_kernel)
// and the weight gradient is dW_io = h(m)/(n1 n2) sum_b conj(X_i) G_o per
// mode (spectral_dw_kernel), with X the forward's saved spectrum and G the
// first stage's scratch.
// Bound on the H100: memory bandwidth. At the train step (b=16, ci=196,
// co=192, 96x64, modes 10x10) dy is 75.5 MB, dx 77.1 MB, the weights 60.2 MB
// read and dW 60.2 MB written: ~273 MB, ~0.083 ms at 3.35 TB/s; the flops
// (~3 GFLOP) take ~0.05 ms at 67 TFLOP/s f32.
// What the first backward (the forward kernel on an adjoint copy of the
// weights, then torch.bmm) spent around the kernel, and what this one does:
//   1. a conjugate-transposed copy of both weight tensors per call (60 MB
//      read permuted, 60 MB written, the imaginary half negated in another
//      pass): gone. mix_adj_kernel reads the forward's pack [mode, 2, ci, co]
//      as it is: [64 ci rows] x [16 contiguous co] re/im tiles with 16-byte
//      cp.async through the same 4-stage ring as mix_kernel, rows padded to
//      20 floats so that a thread's float4 of 4 co per ci row is read without
//      bank conflicts (the transpose is in which thread reads which row);
//      the conjugate is a sign in the FMAs.
//   2. the batched product's [modes, ci, 2co] result (60 MB written): gone.
//   3. its strided unpack into [2, ci, co, m1, m2] (60 MB read, 60 MB
//      written): gone. spectral_dw_kernel writes dW once, in the
//      parameters' layout, where the modes are innermost (m1*m2 contiguous
//      floats per (part, ci, co)): a CTA owns 8 ci x 64 co for a chunk of
//      10 modes of one weight tensor, holds each mode's sums in registers,
//      stages the chunk in shared memory (rows padded to an odd length, so
//      the lanes write different banks) and then stores it with
//      consecutive threads on consecutive addresses. X and G (~5 MB, in
//      L2) come through a 3-step cp.async ring in shared memory: a
//      first version that loaded them from L2 inside the sum over b, at 8
//      warps per SM, waited on every load (0.489 ms at the train shape,
//      H100 80GB HBM3, 700 W, chip_smoke.py). The sum over b runs in a
//      fixed order with no atomics: the same bits on every call. What is
//      left (~0.11 ms against a 0.021 ms bound, PERF.md section 6): the
//      write-out, 40-byte row pieces of dW from 10 CTAs per row, costs
//      more than the sums; a CTA that owned whole rows (all m1*m2 modes)
//      would write contiguous runs, but its stage no longer fits at 8 ci
//      x 64 co (a cluster sharing the stage is the next design to try).
// FiLM: with Y scaled by f, the backward's DFT of dy is followed by
// film_bwd_kernel, which writes dfilm = h(m)/(n1 n2) Re(conj(U) G) from the
// forward's pre-FiLM Y (U) and scales G by f in place; the adjoint mix and
// the weight gradient then read G f. Its bytes (~20 MB at the train shape,
// b=16 and 192 outputs) take ~6 us at 3.35 TB/s. It is a pass of its own,
// not folded into mix_adj_kernel where that stages G: spectral_dw_kernel
// needs G f too, so the scaled G is written once for both, and the
// FiLM-free kernels stay as they are. CUDA rather than Triton: it shares
// this source's build, scratch layout and stream.
// Backward scratch: gr,gi [modes, b, co] (G, kept for the weight gradient)
// and hr,hi [modes, b, ci]; dx f32 [b, ci, n1, n2]; dw1, dw2 f32
// [2, ci, co, m1, m2]; scale f32 [modes], h(m)/(n1 n2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // inverse DFT
constexpr int kFwdThreads = 512;  // forward DFT
constexpr int kModeSplit = 2;     // threads sharing one row's column modes (divides M2)
constexpr int kRowGroups = 8;     // lanes sharing one row mode in the x pass (divides 32)
constexpr int kInvModeSplit = 2;  // threads sharing one row's modes in stage 3 (divides M2)
// mix stage
constexpr int kMixThreads = 128;
constexpr int kCoTile = 64;                      // output channels per CTA
constexpr int kCoGroups = kCoTile / 4;           // threads along co (float4 each)
constexpr int kCiGroups = kMixThreads / kCoGroups;  // threads along ci
constexpr int kCiChunk = 16;                     // ci rows per pipeline stage
constexpr int kStages = 4;
// adjoint mix: the same CTA shape, tiles of kCoTile outputs (the pack's ci)
// and kCiChunk inputs (the pack's co) per stage; a warp takes 4 inputs
constexpr int kAdjLd = kCiChunk + 4;  // padded stage row: float4 reads conflict-free
static_assert(kCiChunk == 4 * (kMixThreads / 32), "a warp takes one float4 of inputs");
static_assert(kCoTile == 64, "a lane takes outputs lane and lane + 32");
// weight gradient
constexpr int kDwThreads = 128;
constexpr int kDwIw = 2;                          // ci per warp (one float2)
constexpr int kDwTi = kDwIw * (kDwThreads / 32);  // ci per CTA
constexpr int kDwTo = 64;                         // co per CTA: two per lane
constexpr int kDwModes = 10;                      // modes per CTA
constexpr int kDwLd = kDwModes | 1;               // output stage row length, odd
constexpr int kDwSb = 16;                         // samples per staged step
constexpr int kDwStages = 3;                      // staged steps in flight

// ---- stage 1: forward truncated DFT ----------------------------------------
// floats of one staged plane, rounded up to keep what follows 16-byte aligned
__host__ __device__ __forceinline__ int fwd_plane_floats(int n1, int ld) {
  return (n1 * ld + 3) / 4 * 4;
}

// A grid of resident CTAs walks the planes; each CTA copies its next plane
// into the buffer as soon as the y pass of this one has read it, so the copy
// overlaps the x pass.
template <int M2, int V>
__global__ void __launch_bounds__(kFwdThreads)
dft_fwd_kernel(const float* __restrict__ x, const float* __restrict__ c2,
               const float* __restrict__ s2, const float* __restrict__ c1,
               const float* __restrict__ s1, float* __restrict__ xr,
               float* __restrict__ xi, int b, int ci, int n1, int n2, int K, int m2) {
  extern __shared__ __align__(16) float smem[];
  const int ld = n2 + (V == 4 ? 4 : 1);  // padded row: conflict-free row reads
  const int planes = b * ci;
  float* sx = smem;                                                       // [n1][ld]
  float2* tcol = reinterpret_cast<float2*>(sx + fwd_plane_floats(n1, ld));  // [n2][M2]
  float2* trow = tcol + n2 * M2;                                          // [n1][K]
  float2* tt = trow + n1 * K;                                             // [n1][M2]

  auto load_plane = [&](int plane) {
    if (plane >= planes) return;
    const float* src = x + static_cast<int64_t>(plane) * n1 * n2;
    if constexpr (V == 4) {
      const int q = n2 / 4;
      for (int i = threadIdx.x; i < n1 * q; i += kFwdThreads) {
        const int row = i / q, c4 = i % q;
        nps::cp_async16(sx + row * ld + 4 * c4, src + static_cast<int64_t>(row) * n2 + 4 * c4);
      }
    } else {
      for (int i = threadIdx.x; i < n1 * n2; i += kFwdThreads)
        nps::cp_async4(sx + (i / n2) * ld + i % n2, src + i);
    }
    nps::cp_async_commit();
  };

  load_plane(blockIdx.x);
  nps::launch_dependents();  // the mix may start streaming its weights
  for (int i = threadIdx.x; i < n2 * M2; i += kFwdThreads) {
    const int y = i / M2, m = i % M2;
    tcol[i] = m < m2 ? make_float2(__ldg(c2 + y * m2 + m), __ldg(s2 + y * m2 + m))
                     : make_float2(0.f, 0.f);
  }
  for (int i = threadIdx.x; i < n1 * K; i += kFwdThreads)
    trow[i] = make_float2(__ldg(c1 + i), __ldg(s1 + i));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int plane = blockIdx.x; plane < planes; plane += gridDim.x) {
    nps::cp_async_wait<0>();
    __syncthreads();  // the plane is in; the last x pass is done with tt

    // along y: T[x, m] = sum_y u[x, y] (cos - i sin)(2 pi m y / n2); a task
    // is one row and MH of its column modes
    constexpr int MH = M2 / kModeSplit;
    for (int task = threadIdx.x; task < n1 * kModeSplit; task += kFwdThreads) {
      const int r = task / kModeSplit, m0 = task % kModeSplit * MH;
      const float* row = sx + r * ld;
      float re[MH], im[MH];
#pragma unroll
      for (int m = 0; m < MH; ++m) re[m] = im[m] = 0.f;
      for (int y0 = 0; y0 < n2; y0 += V) {
        float v[V];
        if constexpr (V == 4) {
          const float4 t = *reinterpret_cast<const float4*>(row + y0);
          v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
        } else {
          v[0] = row[y0];
        }
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float2* t = tcol + (y0 + k) * M2 + m0;
#pragma unroll
          for (int m = 0; m < MH; ++m) {
            const float2 cs = t[m];
            re[m] = fmaf(v[k], cs.x, re[m]);
            im[m] = fmaf(v[k], cs.y, im[m]);
          }
        }
      }
      float2* dst = tt + r * M2 + m0;
#pragma unroll
      for (int m = 0; m < MH; ++m) dst[m] = make_float2(re[m], -im[m]);
    }
    __syncthreads();  // tt is in, and sx is free
    load_plane(plane + gridDim.x);

    // along x: X[k, m] = sum_x T[x, m] (cos - i sin)(2 pi kx x / n1). A warp
    // takes 32 / kRowGroups row modes; the kRowGroups lanes of a row mode
    // take every kRowGroups-th row and sum their partials by shuffles, in
    // the same order every time.
    constexpr int KW = 32 / kRowGroups;
    const int g = lane / KW;
    for (int k0 = warp * KW; k0 < K; k0 += kFwdThreads / kRowGroups) {
      const int k = k0 + lane % KW;
      const bool has = k < K;
      float re[M2], im[M2];
#pragma unroll
      for (int m = 0; m < M2; ++m) re[m] = im[m] = 0.f;
      for (int r = g; has && r < n1; r += kRowGroups) {
        const float2 cs = trow[r * K + k];
        const float2* t = tt + r * M2;
#pragma unroll
        for (int m = 0; m < M2; ++m) {
          const float2 a = t[m];
          re[m] = fmaf(a.x, cs.x, fmaf(a.y, cs.y, re[m]));
          im[m] = fmaf(a.y, cs.x, fmaf(-a.x, cs.y, im[m]));
        }
      }
#pragma unroll
      for (int off = KW; off < 32; off *= 2) {
#pragma unroll
        for (int m = 0; m < M2; ++m) {
          re[m] += __shfl_xor_sync(0xffffffffu, re[m], off);
          im[m] += __shfl_xor_sync(0xffffffffu, im[m], off);
        }
      }
      if (has && g == 0) {
#pragma unroll
        for (int m = 0; m < M2; ++m) {
          if (m < m2) {
            const int64_t o = static_cast<int64_t>(k * m2 + m) * planes + plane;  // [mode][b][ci]
            xr[o] = re[m];
            xi[o] = im[m];
          }
        }
      }
    }
  }
}

// ---- stage 2: per-mode complex channel mix ----------------------------------
// VEC: co % 4 == 0, so a float4 of weights is wholly inside or outside [0, co).
template <int BT, bool VEC>
__global__ void __launch_bounds__(kMixThreads)
mix_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
           const float* __restrict__ w, const float* __restrict__ film, int film_mode,
           float* __restrict__ yr, float* __restrict__ yi, float* __restrict__ ur,
           float* __restrict__ ui, int b, int ci, int co, int K, int m2) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStageFloats = kCiChunk * 2 * kCoTile;
  float* sw = smem;                                             // [stage][ci][re/im][co]
  float2* sx = reinterpret_cast<float2*>(sw + kStages * kStageFloats);  // [ci_pad][BT]
  const int mode = blockIdx.x;
  const int co0 = blockIdx.y * kCoTile;
  const int cg = threadIdx.x % kCoGroups, cig = threadIdx.x / kCoGroups;
  const int nchunks = (ci + kCiChunk - 1) / kCiChunk;
  const int ci_pad = nchunks * kCiChunk;
  const float* wm = w + static_cast<int64_t>(mode) * 2 * ci * co;
  const int k = mode / m2, m = mode % m2;

  auto load_chunk = [&](int c, int stage) {
    float* dst = sw + stage * kStageFloats;
    if (VEC) {
      for (int q = threadIdx.x; q < kCiChunk * 2 * kCoGroups; q += kMixThreads) {
        const int c4 = q % kCoGroups, part = (q / kCoGroups) % 2, il = q / (2 * kCoGroups);
        const int i = c * kCiChunk + il, o = co0 + 4 * c4;
        const bool ok = i < ci && o < co;
        const float* src = ok ? wm + (static_cast<int64_t>(part) * ci + i) * co + o : wm;
        nps::cp_async16(dst + (il * 2 + part) * kCoTile + 4 * c4, src, ok ? 16 : 0);
      }
    } else {
      for (int q = threadIdx.x; q < kCiChunk * 2 * kCoTile; q += kMixThreads) {
        const int col = q % kCoTile, part = (q / kCoTile) % 2, il = q / (2 * kCoTile);
        const int i = c * kCiChunk + il, o = co0 + col;
        const bool ok = i < ci && o < co;
        const float* src = ok ? wm + (static_cast<int64_t>(part) * ci + i) * co + o : wm;
        nps::cp_async4(dst + (il * 2 + part) * kCoTile + col, src, ok ? 4 : 0);
      }
    }
  };

  for (int b0 = 0; b0 < b; b0 += BT) {
    // the first weight chunks go out before the spectrum is read
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nchunks) load_chunk(s, s);
      nps::cp_async_commit();
    }
    if (b0 == 0) {
      nps::launch_dependents();         // the inverse may stage its tables
      nps::wait_for_previous_kernel();  // the forward's X is written
    }
    // this tile's spectrum of the mode, zero past ci and past b; consecutive
    // threads read consecutive ci (coalesced)
    for (int idx = threadIdx.x; idx < ci_pad * BT; idx += kMixThreads) {
      const int j = idx / ci_pad, i = idx % ci_pad, s = b0 + j;
      float2 v = make_float2(0.f, 0.f);
      if (i < ci && s < b) {
        const int64_t o = (static_cast<int64_t>(mode) * b + s) * ci + i;
        v = make_float2(xr[o], xi[o]);
      }
      sx[i * BT + j] = v;
    }

    float ar[BT][4], ai[BT][4];
#pragma unroll
    for (int j = 0; j < BT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) ar[j][q] = ai[j][q] = 0.f;

    for (int c = 0; c < nchunks; ++c) {
      nps::cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk c is in; every thread is done with chunk c-1
      if (c + kStages - 1 < nchunks) load_chunk(c + kStages - 1, (c + kStages - 1) % kStages);
      nps::cp_async_commit();
      const float* st = sw + (c % kStages) * kStageFloats;
#pragma unroll
      for (int ii = 0; ii < kCiChunk / kCiGroups; ++ii) {
        const int il = cig * (kCiChunk / kCiGroups) + ii;
        const float4 wr = *reinterpret_cast<const float4*>(st + (il * 2) * kCoTile + 4 * cg);
        const float4 wi =
            *reinterpret_cast<const float4*>(st + (il * 2 + 1) * kCoTile + 4 * cg);
        const float wre[4] = {wr.x, wr.y, wr.z, wr.w}, wim[4] = {wi.x, wi.y, wi.z, wi.w};
        const float2* xv = sx + (c * kCiChunk + il) * BT;
#pragma unroll
        for (int j = 0; j < BT; ++j) {
          const float2 a = xv[j];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ar[j][q] = fmaf(a.x, wre[q], fmaf(-a.y, wim[q], ar[j][q]));
            ai[j][q] = fmaf(a.x, wim[q], fmaf(a.y, wre[q], ai[j][q]));
          }
        }
      }
    }
    nps::cp_async_wait_all();
    __syncthreads();

    // sum the ci groups in a fixed order: red[cig][j][col] (re, im), in sw
    float2* red = reinterpret_cast<float2*>(sw);
#pragma unroll
    for (int j = 0; j < BT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        red[(cig * BT + j) * kCoTile + 4 * cg + q] = make_float2(ar[j][q], ai[j][q]);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * kCoTile; idx += kMixThreads) {
      const int j = idx / kCoTile, col = idx % kCoTile;
      const int s = b0 + j, o = co0 + col;
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int g = 0; g < kCiGroups; ++g) {
        const float2 v = red[(g * BT + j) * kCoTile + col];
        acc.x += v.x;
        acc.y += v.y;
      }
      if (s < b && o < co) {
        float f = 1.f;
        if (film != nullptr) {
          f = film[((static_cast<int64_t>(s) * co + o) * K + k) * m2 + m];
          if (film_mode == 0) f += 1.f;
        }
        const int64_t dst = (static_cast<int64_t>(mode) * b + s) * co + o;
        yr[dst] = acc.x * f;
        yi[dst] = acc.y * f;
        if (ur != nullptr) {  // the pre-FiLM Y, for the FiLM gradient
          ur[dst] = acc.x;
          ui[dst] = acc.y;
        }
      }
    }
    __syncthreads();  // sw and sx are reused by the next batch tile
  }
}

// ---- stage 2 of the backward: the adjoint mix --------------------------------
// H[b, i] = sum_o conj(W[i, o]) G[b, o] per mode, from the forward's pack
// [mode, 2, ci, co] as it is. One CTA per (mode, 64 outputs i); [64 i] x [16
// o] re/im tiles stream through the 4-stage cp.async ring, one contiguous
// 64-byte run of o per row, rows padded to kAdjLd floats. Lane l owns outputs
// l and l + 32 for BT samples; warp w reads o 4w..4w+3 of a chunk as one
// float4 per row (8 lanes of a phase hit 8 different 16-byte bank groups).
// The four warps' shares are summed in a fixed order.
// With FiLM, G arrives already scaled by the real factor f[b, o, mode]
// (film_bwd_kernel, launched between the DFT and this kernel).
// VEC: co % 4 == 0, so a float4 of weights is wholly inside or outside [0, co).
template <int BT, bool VEC>
__global__ void __launch_bounds__(kMixThreads)
mix_adj_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
               const float* __restrict__ w, float* __restrict__ hr, float* __restrict__ hi,
               int b, int ci, int co) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStageFloats = 2 * kCoTile * kAdjLd;
  float* sw = smem;                                             // [stage][re/im][i][kAdjLd]
  float2* sg = reinterpret_cast<float2*>(sw + kStages * kStageFloats);  // [co_pad][BT]
  const int mode = blockIdx.x;
  const int i0 = blockIdx.y * kCoTile;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nchunks = (co + kCiChunk - 1) / kCiChunk;
  const int co_pad = nchunks * kCiChunk;
  const float* wm = w + static_cast<int64_t>(mode) * 2 * ci * co;

  // stage row r = part * kCoTile + (i - i0)
  auto load_chunk = [&](int c, int stage) {
    float* dst = sw + stage * kStageFloats;
    if (VEC) {
      constexpr int kQ = kCiChunk / 4;
      for (int q = threadIdx.x; q < 2 * kCoTile * kQ; q += kMixThreads) {
        const int c4 = q % kQ, row = q / kQ;
        const int i = i0 + row % kCoTile, o = c * kCiChunk + 4 * c4;
        const bool ok = i < ci && o < co;
        const float* src = ok ? wm + (static_cast<int64_t>(row / kCoTile) * ci + i) * co + o : wm;
        nps::cp_async16(dst + row * kAdjLd + 4 * c4, src, ok ? 16 : 0);
      }
    } else {
      for (int q = threadIdx.x; q < 2 * kCoTile * kCiChunk; q += kMixThreads) {
        const int col = q % kCiChunk, row = q / kCiChunk;
        const int i = i0 + row % kCoTile, o = c * kCiChunk + col;
        const bool ok = i < ci && o < co;
        const float* src = ok ? wm + (static_cast<int64_t>(row / kCoTile) * ci + i) * co + o : wm;
        nps::cp_async4(dst + row * kAdjLd + col, src, ok ? 4 : 0);
      }
    }
  };

  for (int b0 = 0; b0 < b; b0 += BT) {
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nchunks) load_chunk(s, s);
      nps::cp_async_commit();
    }
    if (b0 == 0) {
      nps::launch_dependents();         // the inverse may stage its tables
      nps::wait_for_previous_kernel();  // the forward DFT's G is written
    }
    for (int idx = threadIdx.x; idx < co_pad * BT; idx += kMixThreads) {
      const int j = idx / co_pad, o = idx % co_pad, s = b0 + j;
      float2 v = make_float2(0.f, 0.f);
      if (o < co && s < b) {
        const int64_t src = (static_cast<int64_t>(mode) * b + s) * co + o;
        v = make_float2(gr[src], gi[src]);
      }
      sg[o * BT + j] = v;
    }

    float ar[2][BT], ai[2][BT];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < BT; ++j) ar[h][j] = ai[h][j] = 0.f;

    for (int c = 0; c < nchunks; ++c) {
      nps::cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk c is in; every thread is done with chunk c-1
      if (c + kStages - 1 < nchunks) load_chunk(c + kStages - 1, (c + kStages - 1) % kStages);
      nps::cp_async_commit();
      const float* st = sw + (c % kStages) * kStageFloats;
      float wre[2][4], wim[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int il = lane + 32 * h;
        const float4 r = *reinterpret_cast<const float4*>(st + il * kAdjLd + 4 * warp);
        const float4 m = *reinterpret_cast<const float4*>(st + (kCoTile + il) * kAdjLd + 4 * warp);
        wre[h][0] = r.x; wre[h][1] = r.y; wre[h][2] = r.z; wre[h][3] = r.w;
        wim[h][0] = m.x; wim[h][1] = m.y; wim[h][2] = m.z; wim[h][3] = m.w;
      }
      const float2* gv = sg + (c * kCiChunk + 4 * warp) * BT;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < BT; ++j) {
          const float2 g = gv[q * BT + j];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // conj(W) G = (Wr Gr + Wi Gi) + i (Wr Gi - Wi Gr)
            ar[h][j] = fmaf(wre[h][q], g.x, fmaf(wim[h][q], g.y, ar[h][j]));
            ai[h][j] = fmaf(wre[h][q], g.y, fmaf(-wim[h][q], g.x, ai[h][j]));
          }
        }
    }
    nps::cp_async_wait_all();
    __syncthreads();

    // sum the warps' input shares in a fixed order: red[warp][j][i], in sw
    float2* red = reinterpret_cast<float2*>(sw);
#pragma unroll
    for (int j = 0; j < BT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        red[(warp * BT + j) * kCoTile + lane + 32 * h] = make_float2(ar[h][j], ai[h][j]);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BT * kCoTile; idx += kMixThreads) {
      const int j = idx / kCoTile, il = idx % kCoTile;
      const int s = b0 + j, i = i0 + il;
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int g = 0; g < kMixThreads / 32; ++g) {
        const float2 v = red[(g * BT + j) * kCoTile + il];
        acc.x += v.x;
        acc.y += v.y;
      }
      if (s < b && i < ci) {
        const int64_t dst = (static_cast<int64_t>(mode) * b + s) * ci + i;
        hr[dst] = acc.x;
        hi[dst] = acc.y;
      }
    }
    __syncthreads();  // sw and sg are reused by the next batch tile
  }
}

// ---- the FiLM gradient ----------------------------------------------------------
// Between the backward's DFT of dy and its adjoint mix, when the forward
// applied FiLM (Y *= f per [b, o, mode], f = film or 1 + film). Per mode and
// (sample, output) pair p = s * co + o:
//   dfilm[p, mode] = scale[mode] (U_re G_re + U_im G_im)   (U: pre-FiLM Y)
//   G[mode, p]     = f G[mode, p]                          (in place)
// so that the adjoint mix and the weight gradient both read G f. Where
// film needs no gradient, dfilm, ur and ui are null and only G is scaled.
// G and U are [mode][p], film and dfilm [p][mode]: a CTA takes a 32 x 32 tile and
// transposes the FiLM side through shared memory (rows padded to 33), so
// every global access is a coalesced row. No sums across threads: the same
// bits on every call.
constexpr int kFilmTile = 32;
constexpr int kFilmRows = 8;  // threads along the tile's rows

__global__ void __launch_bounds__(kFilmTile * kFilmRows)
film_bwd_kernel(float* __restrict__ gr, float* __restrict__ gi, const float* __restrict__ ur,
                const float* __restrict__ ui, const float* __restrict__ film, int film_mode,
                const float* __restrict__ scale, float* __restrict__ dfilm, int modes,
                int pairs) {
  __shared__ float sf[kFilmTile][kFilmTile + 1];  // [p][mode]
  __shared__ float sd[kFilmTile][kFilmTile + 1];
  const int m0 = blockIdx.x * kFilmTile, p0 = blockIdx.y * kFilmTile;
  const int tx = threadIdx.x % kFilmTile, ty = threadIdx.x / kFilmTile;
  for (int r = ty; r < kFilmTile; r += kFilmRows) {
    const int p = p0 + r, m = m0 + tx;
    float f = 0.f;
    if (p < pairs && m < modes) {
      f = film[static_cast<int64_t>(p) * modes + m];
      if (film_mode == 0) f += 1.f;
    }
    sf[r][tx] = f;
  }
  __syncthreads();
  for (int r = ty; r < kFilmTile; r += kFilmRows) {
    const int m = m0 + r, p = p0 + tx;
    float d = 0.f;
    if (m < modes && p < pairs) {
      const int64_t o = static_cast<int64_t>(m) * pairs + p;
      const float f = sf[tx][r], g_r = gr[o], g_i = gi[o];
      if (dfilm != nullptr) d = __ldg(scale + m) * fmaf(ur[o], g_r, ui[o] * g_i);
      gr[o] = g_r * f;
      gi[o] = g_i * f;
    }
    sd[tx][r] = d;
  }
  if (dfilm == nullptr) return;  // uniform across the CTA
  __syncthreads();
  for (int r = ty; r < kFilmTile; r += kFilmRows) {
    const int p = p0 + r, m = m0 + tx;
    if (p < pairs && m < modes) dfilm[static_cast<int64_t>(p) * modes + m] = sd[r][tx];
  }
}

// ---- the weight gradient --------------------------------------------------------
// dW[part, i, o, mode] = scale[mode] sum_b conj(X[b, i]) G[b, o], into one of
// the parameters [2, ci, co, m1, m2] (nm = m1 m2 modes innermost). Block x:
// (weight tensor, chunk of kDwModes modes); y: 64 o; z: 8 i. The block walks
// its (mode, kDwSb samples) steps with the next step's X [re/im][s][8 i] and
// G [re/im][s][64 o] copied into shared memory (cp.async, a ring of
// kDwStages steps, the next two in flight) while this one is summed: warp
// w owns i 2w, 2w+1 and lane l owns o 2l, 2l+1, 4
// (i, o) pairs, re and im, summed in registers over b in order. Each mode's
// sums go to a shared stage [re/im][i][o][kDwLd] (odd row length: the lanes'
// rows spread over the banks), written out at the end with consecutive
// threads on consecutive modes of a row. VEC: ci % 4 == 0 and co % 4 == 0,
// so every staged row is whole 16-byte pieces.
template <bool VEC>
__global__ void __launch_bounds__(kDwThreads)
spectral_dw_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   const float* __restrict__ gr, const float* __restrict__ gi,
                   const float* __restrict__ scale, float* __restrict__ dw1,
                   float* __restrict__ dw2, int b, int ci, int co, int nm) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kXF = 2 * kDwSb * kDwTi, kGF = 2 * kDwSb * kDwTo;  // floats per buffer
  float* sx = smem;                   // [stage][re/im][s][kDwTi]
  float* sg = sx + kDwStages * kXF;   // [stage][re/im][s][kDwTo]
  float* so = sg + kDwStages * kGF;   // [re/im][i][o][kDwLd]
  const int chunks = (nm + kDwModes - 1) / kDwModes;
  const int t = blockIdx.x / chunks, mc0 = blockIdx.x % chunks * kDwModes;
  const int mcn = min(kDwModes, nm - mc0);
  const int o0 = blockIdx.y * kDwTo, i0 = blockIdx.z * kDwTi;
  const int il = kDwIw * (threadIdx.x / 32), ol = 2 * (threadIdx.x % 32);
  const int nsb = (b + kDwSb - 1) / kDwSb;
  const int steps = mcn * nsb;

  // step u: mode mc0 + u / nsb, samples (u % nsb) * kDwSb + [0, kDwSb)
  auto load_step = [&](int u, int buf) {
    const int mode = t * nm + mc0 + u / nsb, s0 = u % nsb * kDwSb;
    float* dx = sx + buf * kXF;
    float* dg = sg + buf * kGF;
    if (VEC) {
      for (int q = threadIdx.x; q < 2 * kDwSb * (kDwTi / 4); q += kDwThreads) {
        const int c4 = q % (kDwTi / 4), row = q / (kDwTi / 4);  // row = part * kDwSb + s
        const int s = s0 + row % kDwSb, i = i0 + 4 * c4;
        const bool ok = s < b && i < ci;
        const float* src = row < kDwSb ? xr : xi;
        if (ok) src += (static_cast<int64_t>(mode) * b + s) * ci + i;
        nps::cp_async16(dx + row * kDwTi + 4 * c4, src, ok ? 16 : 0);
      }
      for (int q = threadIdx.x; q < 2 * kDwSb * (kDwTo / 4); q += kDwThreads) {
        const int c4 = q % (kDwTo / 4), row = q / (kDwTo / 4);
        const int s = s0 + row % kDwSb, o = o0 + 4 * c4;
        const bool ok = s < b && o < co;
        const float* src = row < kDwSb ? gr : gi;
        if (ok) src += (static_cast<int64_t>(mode) * b + s) * co + o;
        nps::cp_async16(dg + row * kDwTo + 4 * c4, src, ok ? 16 : 0);
      }
    } else {
      for (int q = threadIdx.x; q < 2 * kDwSb * kDwTi; q += kDwThreads) {
        const int c = q % kDwTi, row = q / kDwTi;
        const int s = s0 + row % kDwSb, i = i0 + c;
        const bool ok = s < b && i < ci;
        const float* src = row < kDwSb ? xr : xi;
        if (ok) src += (static_cast<int64_t>(mode) * b + s) * ci + i;
        nps::cp_async4(dx + row * kDwTi + c, src, ok ? 4 : 0);
      }
      for (int q = threadIdx.x; q < 2 * kDwSb * kDwTo; q += kDwThreads) {
        const int c = q % kDwTo, row = q / kDwTo;
        const int s = s0 + row % kDwSb, o = o0 + c;
        const bool ok = s < b && o < co;
        const float* src = row < kDwSb ? gr : gi;
        if (ok) src += (static_cast<int64_t>(mode) * b + s) * co + o;
        nps::cp_async4(dg + row * kDwTo + c, src, ok ? 4 : 0);
      }
    }
  };

  float re[kDwIw][2], im[kDwIw][2];
#pragma unroll
  for (int p = 0; p < kDwIw; ++p) re[p][0] = re[p][1] = im[p][0] = im[p][1] = 0.f;
  for (int u = 0; u < kDwStages - 1; ++u) {
    if (u < steps) load_step(u, u);
    nps::cp_async_commit();
  }
  for (int u = 0; u < steps; ++u) {
    nps::cp_async_wait<kDwStages - 2>();
    __syncthreads();  // step u is in; every thread is done with step u - 1
    if (u + kDwStages - 1 < steps) load_step(u + kDwStages - 1, (u + kDwStages - 1) % kDwStages);
    nps::cp_async_commit();
    const float* cx = sx + u % kDwStages * kXF;
    const float* cg = sg + u % kDwStages * kGF;
    const int sn = min(kDwSb, b - u % nsb * kDwSb);
    for (int s = 0; s < sn; ++s) {
      // X: one address for every lane of a warp (a broadcast read)
      const float2 pr = *reinterpret_cast<const float2*>(cx + s * kDwTi + il);
      const float2 pi = *reinterpret_cast<const float2*>(cx + (kDwSb + s) * kDwTi + il);
      const float ar[kDwIw] = {pr.x, pr.y}, ai[kDwIw] = {pi.x, pi.y};
      const float2 qr = *reinterpret_cast<const float2*>(cg + s * kDwTo + ol);
      const float2 qi = *reinterpret_cast<const float2*>(cg + (kDwSb + s) * kDwTo + ol);
      const float g_r[2] = {qr.x, qr.y}, g_i[2] = {qi.x, qi.y};
#pragma unroll
      for (int p = 0; p < kDwIw; ++p)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          // conj(X) G = (Xr Gr + Xi Gi) + i (Xr Gi - Xi Gr)
          re[p][q] = fmaf(ar[p], g_r[q], fmaf(ai[p], g_i[q], re[p][q]));
          im[p][q] = fmaf(ar[p], g_i[q], fmaf(-ai[p], g_r[q], im[p][q]));
        }
    }
    if (u % nsb == nsb - 1) {  // the mode's last samples: scale and stage
      const int mc = u / nsb;
      const float sc = __ldg(scale + t * nm + mc0 + mc);
#pragma unroll
      for (int p = 0; p < kDwIw; ++p)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int row = (il + p) * kDwTo + ol + q;
          so[row * kDwLd + mc] = re[p][q] * sc;
          so[(kDwTi * kDwTo + row) * kDwLd + mc] = im[p][q] * sc;
          re[p][q] = im[p][q] = 0.f;
        }
    }
  }
  nps::cp_async_wait_all();
  __syncthreads();  // the output stage is whole

  float* out = t == 0 ? dw1 : dw2;
  for (int q = threadIdx.x; q < 2 * kDwTi * kDwTo * kDwModes; q += kDwThreads) {
    const int row = q / kDwModes, mc = q % kDwModes;  // compile-time divisors
    const int part = row / (kDwTi * kDwTo);
    const int ii = i0 + row / kDwTo % kDwTi, oo = o0 + row % kDwTo;
    if (mc < mcn && ii < ci && oo < co)
      out[((static_cast<int64_t>(part) * ci + ii) * co + oo) * nm + mc0 + mc] =
          so[row * kDwLd + mc];
  }
}

// ---- stage 3: inverse truncated DFT -----------------------------------------
// A grid of resident CTAs walks the planes; each CTA copies its next plane's
// spectrum into sy as soon as the row pass of this one has read it, so the
// copy overlaps the column pass. Each thread loads its column factors into
// registers once.
template <int M2, int V>
__global__ void __launch_bounds__(kThreads, 2)
dft_inv_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
               const float* __restrict__ ic2, const float* __restrict__ is2,
               const float* __restrict__ ic1, const float* __restrict__ is1,
               float* __restrict__ out, int b, int co, int n1, int n2, int K, int m2,
               float scale) {
  extern __shared__ __align__(16) float smem[];
  const int planes = b * co;
  float2* sy = reinterpret_cast<float2*>(smem);  // [K][M2]
  float2* trow = sy + K * M2;                    // [K][n1]
  float2* zz = trow + K * n1;                    // [n1][M2]

  // one plane's retained spectrum (yr, yi are [mode][b][co]); the padded
  // modes m >= m2 are zeroed once and never copied over
  auto load_plane = [&](int plane) {
    if (plane < planes)
      for (int i = threadIdx.x; i < K * m2; i += kThreads) {
        const int k = i / m2, m = i % m2;
        const int64_t src = static_cast<int64_t>(k * m2 + m) * planes + plane;
        float* dst = reinterpret_cast<float*>(sy + k * M2 + m);
        nps::cp_async4(dst, yr + src);
        nps::cp_async4(dst + 1, yi + src);
      }
    nps::cp_async_commit();
  };
  for (int i = threadIdx.x; i < K * M2; i += kThreads)
    if (i % M2 >= m2) sy[i] = make_float2(0.f, 0.f);
  for (int i = threadIdx.x; i < K * n1; i += kThreads)
    trow[i] = make_float2(__ldg(ic1 + i), __ldg(is1 + i));
  // the column pass: a thread owns V adjacent outputs of a row and their
  // 2*m2 x V cos/sin factors
  const int nj = n2 / V;                 // threads per output row
  const int j = threadIdx.x % nj, stream = threadIdx.x / nj;
  const int nstream = kThreads / nj;     // the wrapper keeps nj <= kThreads
  float tc[M2][V], ts[M2][V];
#pragma unroll
  for (int m = 0; m < M2; ++m)
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const bool ok = m < m2 && stream < nstream;
      tc[m][q] = ok ? __ldg(ic2 + m * n2 + j * V + q) : 0.f;
      ts[m][q] = ok ? __ldg(is2 + m * n2 + j * V + q) : 0.f;
    }
  nps::wait_for_previous_kernel();  // the mix's Y is written
  load_plane(blockIdx.x);

  for (int plane = blockIdx.x; plane < planes; plane += gridDim.x) {
    nps::cp_async_wait<0>();
    __syncthreads();  // sy is in; the last column pass is done with zz

    // along x first: Z[x, m] = sum_k Y[k, m] (cos + i sin)(2 pi kx x / n1);
    // a task is one row and MH of its modes
    constexpr int MH = M2 / kInvModeSplit;
    for (int task = threadIdx.x; task < n1 * kInvModeSplit; task += kThreads) {
      const int r = task / kInvModeSplit, m0 = task % kInvModeSplit * MH;
      float re[MH], im[MH];
#pragma unroll
      for (int m = 0; m < MH; ++m) re[m] = im[m] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float2 cs = trow[k * n1 + r];
        const float2* yk = sy + k * M2 + m0;
#pragma unroll
        for (int m = 0; m < MH; ++m) {
          const float2 a = yk[m];
          re[m] = fmaf(a.x, cs.x, fmaf(-a.y, cs.y, re[m]));
          im[m] = fmaf(a.x, cs.y, fmaf(a.y, cs.x, im[m]));
        }
      }
      float2* dst = zz + r * M2 + m0;
#pragma unroll
      for (int m = 0; m < MH; ++m) dst[m] = make_float2(re[m], im[m]);
    }
    __syncthreads();  // zz is in, and sy is free
    load_plane(plane + gridDim.x);

    // then along y, real part only, Hermitian doubling folded into ic2/is2:
    // out[x, y] = sum_m Re Z[x, m] ic2[m, y] - Im Z[x, m] is2[m, y]
    if (stream < nstream) {
      float* dst = out + static_cast<int64_t>(plane) * n1 * n2;
      for (int r = stream; r < n1; r += nstream) {
        const float2* z = zz + r * M2;
        float acc[V];
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] = 0.f;
#pragma unroll
        for (int m = 0; m < M2; ++m) {
          const float2 a = z[m];
#pragma unroll
          for (int q = 0; q < V; ++q) acc[q] = fmaf(a.x, tc[m][q], fmaf(-a.y, ts[m][q], acc[q]));
        }
        float* o = dst + static_cast<int64_t>(r) * n2 + j * V;
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[0] * scale, acc[1] * scale, acc[2] * scale, acc[3] * scale);
        } else {
          o[0] = acc[0] * scale;
        }
      }
    }
  }
}

// ---- the large-plane variant ---------------------------------------------------
// For planes whose rows, tables and modes do not fit the kernels above (a
// 512x512 plane is 1 MB in f32 against the 227 KB a CTA may use, and m2 = 20
// is above their largest unrolled bound), and for bf16 input and output at
// any plane size (the kernels above take f32). The same three stages, tiled
// so that no stage holds a whole plane or a whole table:
//   1. dft_fwd_big_kernel: one CTA per (plane, tile of kBigRows rows). The y
//      pass is a register-tiled [rows x n2] x [n2 x 2 m2] product: x and the
//      (cos, sin) table come into shared memory kBigYc columns at a time
//      through a 2-stage cp.async ring; a thread owns 2 rows and half of the
//      M2 column modes (4*M2/2 accumulators), reading each 4 x values once
//      (conflict-free, rows padded by 4 elements) against broadcast table
//      reads. Its [rows, m2] half-spectrum then goes to shared memory, and
//      the x pass of the resident kernel (4 row modes a warp, 8 lanes per
//      row mode summing by shuffles in a fixed order) contracts the tile's
//      rows to the 2*m1 row modes, tables read from L1/L2. With one row tile
//      the result is the spectrum X; with more, each tile writes its partial
//      sum and sum_tiles_kernel adds them in tile order (no atomics).
//   2. the mix: mix_kernel as above (it tiles the batch and takes any m2).
//   3. dft_inv_big_kernel: one CTA per (plane, block of kBigInvRows rows).
//      Rows first on the plane's retained spectrum (staged in shared memory)
//      for the block's rows -> Z [rows, m2] in shared memory, then the column
//      pass: a thread owns 4 adjacent outputs of kBigInvR rows, reads its 4
//      (cos, sin) factors per mode from L1 (float4), Z by broadcast, and
//      writes 16-byte (f32) or 8-byte (bf16) streaming stores.
// x and out may be f32 or bf16; the spectrum scratch, the weights and every
// sum are f32 (one rounding to bf16, on output). These are the FMA stages.
// Bound on the H100 at the ns512 shape (b=8, 132 -> 128 channels, 512x512,
// 20x20 modes): 1.2 GB of bf16 activations and f32 weights at 3.35 TB/s
// (0.358 ms). On the CUDA cores the ~51 GFLOP of the two DFT stages alone
// take 0.77 ms at 67 TFLOP/s f32, and these stages reach ~25 TFLOP/s (~1.0
// ms each at that shape, PERF.md section 6): bf16 calls there are bound by
// operations, not bytes, on these stages.
// The tensor-core stages (dft_fwd_tc_kernel, dft_inv_tc_kernel, below) take
// their places for bf16 rows of a multiple of 8 points on 16-byte aligned
// planes (tc_stages; every ns512 call): the y pass and the column pass are
// plain products with a small N ([b ci n1, n2] x [n2, 2 m2] and [b co n1,
// 2 m2] x [2 m2, n2]) and go to bf16 mma.sync with f32 sums, the x pass and
// the row pass too. The tables are split into hi + lo bf16 terms (hi =
// bf16(t), lo = bf16(t - hi), ~2^-17 relative left), so a bf16 operand
// times both gives the f32 table's product; an f32 operand (T, Y, Z) is
// split the same way and three products (hi hi, hi lo, lo hi) stand for
// the f32 one. At the ns512 shape that is ~57 GFLOP of bf16 products in
// the forward stage and ~87 in the inverse (its column pass: three
// products over K = 2 m2 = 40 padded to 48), ~0.15 ms at 989 TFLOP/s: the
// operations no longer bound the call, the bytes (0.358 ms) do. Each stage
// streams its bf16 plane once: TMA boxes (128-byte swizzle) into a 2-stage
// ring on mbarriers in the forward, 16-byte streaming stores in the
// inverse. mma.sync (m16n8k16), not wgmma: one product's accumulators are
// the next product's A fragments (T in the forward through shared memory,
// Z in the inverse in registers), where wgmma takes its operands from
// shared memory in its own layouts. Measured (PERF.md section 6, python -m
// nps_tpu_torch.tc_probe): the stages reach about half their share of the
// bytes bound; what holds them is spread over the fragment loads, the
// passes' serial phases and the rings' synchronisation, not one part.
// f32 calls keep the FMA stages: products of split bf16 terms reach 4e-6
// to 9e-6 relative (tests/test_torch_spectral_split.py), too near the f32
// plain version's 1e-5 bar to hold it at every shape (TF32 is coarser), and
// no shipped path launches the f32 large variant.
// spectral_dft2d_bwd_large: the input gradient on the same tiled stages,
// replacing _pallas_bwd (spectral_dft.py:175 at git 92d7866^) where the
// resident backward does not fit, as spectral_dft2d_bwd does on the resident
// stages: dft_fwd_big_kernel on dy (b*co planes) and sum_tiles_kernel give
// G; film_bwd_kernel when the forward applied FiLM; mix_adj_kernel on the
// forward's pack as it is; dft_inv_big_kernel into dx (b*ci planes). dy and
// dx are f32 or bf16 (dx in dy's type), G, H and every sum f32; G stays in
// gr, gi for spectral_dw2d, which takes any plane size. Its bound at the
// ns512 shape is the forward's: ~1.2 GB moved in bf16 (0.36 ms). The choice
// between it and the resident backward is the wrapper's, by shape and type
// alone; between the tensor-core and the FMA stages, as in the forward.
constexpr int kBigThreads = 256;
constexpr int kBigRows = 256;     // rows per forward CTA: 2 per thread
constexpr int kBigYc = 32;        // y columns per staged chunk
constexpr int kBigStages = 2;
constexpr int kBigLd = kBigYc + 4;  // staged row pitch in elements
constexpr int kBigInvRows = 128;  // rows per inverse CTA
constexpr int kBigInvR = 16;      // rows a thread holds per column pass

using nps::load4;
using nps::store4;
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__host__ __device__ constexpr size_t big_stage_bytes() {
  return static_cast<size_t>(kBigStages) * kBigRows * kBigLd * sizeof(T);
}

// VEC: n2 % 4 == 0 and x aligned to 4 elements, so each row's 4-element
// pieces are copied with one cp.async each (16 bytes f32, 8 bytes bf16).
template <typename T, int M2, bool VEC>
__global__ void __launch_bounds__(kBigThreads, 2)
dft_fwd_big_kernel(const T* __restrict__ x, const float* __restrict__ c2,
                   const float* __restrict__ s2, const float* __restrict__ c1,
                   const float* __restrict__ s1, float* __restrict__ pr,
                   float* __restrict__ pi, int planes, int n1, int n2, int K, int m2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int MH = M2 / 2;
  static_assert(MH % 2 == 0, "modes are read from the table in pairs");
  T* sx = reinterpret_cast<T*>(smem_raw);                                 // [stage][row][kBigLd]
  float2* st = reinterpret_cast<float2*>(smem_raw + big_stage_bytes<T>());  // [stage][kBigYc][M2]
  float2* sT = reinterpret_cast<float2*>(smem_raw);  // after the y pass: [row][M2]
  const int tile = blockIdx.x, plane = blockIdx.y;
  const int r0 = tile * kBigRows;
  const int rows = min(kBigRows, n1 - r0);
  const T* src = x + (static_cast<int64_t>(plane) * n1 + r0) * n2;
  const int nchunks = (n2 + kBigYc - 1) / kBigYc;

  auto load_chunk = [&](int c, int s) {
    T* dst = sx + s * kBigRows * kBigLd;
    const int y0 = c * kBigYc;
    if constexpr (VEC) {
      constexpr int Q = kBigYc / 4;
      for (int i = threadIdx.x; i < kBigRows * Q; i += kBigThreads) {
        const int r = i / Q, q = i % Q, y = y0 + 4 * q;
        const bool ok = r < rows && y < n2;
        const T* p = ok ? src + static_cast<int64_t>(r) * n2 + y : src;
        if constexpr (sizeof(T) == 4)
          nps::cp_async16(dst + r * kBigLd + 4 * q, p, ok ? 16 : 0);
        else
          nps::cp_async8(dst + r * kBigLd + 4 * q, p, ok ? 8 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < kBigRows * kBigYc; i += kBigThreads) {
        const int r = i / kBigYc, q = i % kBigYc, y = y0 + q;
        dst[r * kBigLd + q] =
            (r < rows && y < n2) ? src[static_cast<int64_t>(r) * n2 + y] : T(0.f);
      }
    }
    float2* tdst = st + s * kBigYc * M2;
    for (int i = threadIdx.x; i < kBigYc * M2; i += kBigThreads) {
      const int q = i / M2, m = i % M2, y = y0 + q;
      tdst[i] = (m < m2 && y < n2) ? make_float2(__ldg(c2 + y * m2 + m), __ldg(s2 + y * m2 + m))
                                   : make_float2(0.f, 0.f);
    }
    nps::cp_async_commit();
  };

  // along y: T[x, m] = sum_y u[x, y] (cos - i sin)(2 pi m y / n2); thread
  // (h, p) owns rows p and p + kBigRows/2 and modes [h MH, (h+1) MH)
  const int h = threadIdx.x / (kBigThreads / 2), p = threadIdx.x % (kBigThreads / 2);
  float re[2][MH], im[2][MH];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int m = 0; m < MH; ++m) re[j][m] = im[j][m] = 0.f;
  load_chunk(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks)
      load_chunk(c + 1, (c + 1) % kBigStages);
    else
      nps::cp_async_commit();
    nps::cp_async_wait<1>();
    __syncthreads();  // chunk c is in
    const T* xs = sx + (c % kBigStages) * kBigRows * kBigLd;
    const float2* ts = st + (c % kBigStages) * kBigYc * M2 + h * MH;
#pragma unroll 2
    for (int q0 = 0; q0 < kBigYc; q0 += 4) {
      float v[2][4];
      load4(xs + p * kBigLd + q0, v[0]);
      load4(xs + (p + kBigRows / 2) * kBigLd + q0, v[1]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4* t = reinterpret_cast<const float4*>(ts + (q0 + k) * M2);
#pragma unroll
        for (int mm = 0; mm < MH / 2; ++mm) {
          const float4 cs = t[mm];  // (cos, sin) of modes 2 mm and 2 mm + 1
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            re[j][2 * mm] = fmaf(v[j][k], cs.x, re[j][2 * mm]);
            im[j][2 * mm] = fmaf(v[j][k], cs.y, im[j][2 * mm]);
            re[j][2 * mm + 1] = fmaf(v[j][k], cs.z, re[j][2 * mm + 1]);
            im[j][2 * mm + 1] = fmaf(v[j][k], cs.w, im[j][2 * mm + 1]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with stage c % kBigStages
  }
  nps::cp_async_wait_all();
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int m = 0; m < MH; ++m)
      sT[(p + j * (kBigRows / 2)) * M2 + h * MH + m] = make_float2(re[j][m], -im[j][m]);
  __syncthreads();

  // along x over this tile's rows: X[k, m] = sum_x T[x, m] (cos - i sin)(2 pi kx x / n1)
  constexpr int KW = 32 / kRowGroups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / KW;
  const int64_t out0 = static_cast<int64_t>(tile) * K * m2;
  for (int k0 = warp * KW; k0 < K; k0 += kBigThreads / kRowGroups) {
    const int k = k0 + lane % KW;
    const bool has = k < K;
    float ar[M2], ai[M2];
#pragma unroll
    for (int m = 0; m < M2; ++m) ar[m] = ai[m] = 0.f;
    for (int r = g; has && r < rows; r += kRowGroups) {
      const int64_t xi_ = static_cast<int64_t>(r0 + r) * K + k;
      const float2 cs = make_float2(__ldg(c1 + xi_), __ldg(s1 + xi_));
      const float2* t = sT + r * M2;
#pragma unroll
      for (int m = 0; m < M2; ++m) {
        const float2 a = t[m];
        ar[m] = fmaf(a.x, cs.x, fmaf(a.y, cs.y, ar[m]));
        ai[m] = fmaf(a.y, cs.x, fmaf(-a.x, cs.y, ai[m]));
      }
    }
#pragma unroll
    for (int off = KW; off < 32; off *= 2) {
#pragma unroll
      for (int m = 0; m < M2; ++m) {
        ar[m] += __shfl_xor_sync(0xffffffffu, ar[m], off);
        ai[m] += __shfl_xor_sync(0xffffffffu, ai[m], off);
      }
    }
    if (has && g == 0) {
#pragma unroll
      for (int m = 0; m < M2; ++m) {
        if (m < m2) {
          const int64_t o = (out0 + k * m2 + m) * planes + plane;  // [tile][mode][b][ci]
          pr[o] = ar[m];
          pi[o] = ai[m];
        }
      }
    }
  }
}

// X = the tiles' partial spectra [tiles][n] summed in tile order
__global__ void __launch_bounds__(kBigThreads)
sum_tiles_kernel(const float* __restrict__ pr, const float* __restrict__ pi,
                 float* __restrict__ xr, float* __restrict__ xi, int tiles, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kBigThreads) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kBigThreads) {
    float a = 0.f, b = 0.f;
    for (int t = 0; t < tiles; ++t) {
      a += pr[t * n + i];
      b += pi[t * n + i];
    }
    xr[i] = a;
    xi[i] = b;
  }
}

// VEC: n2 % 4 == 0 and out aligned to 4 elements (16- or 8-byte stores).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kBigThreads, 2)
dft_inv_big_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                   const float* __restrict__ ic2, const float* __restrict__ is2,
                   const float* __restrict__ ic1, const float* __restrict__ is1,
                   T* __restrict__ out, int planes, int n1, int n2, int K, int m2, float scale) {
  extern __shared__ __align__(16) float2 sm2[];
  float2* sy = sm2;             // [K][m2]
  float2* sz = sy + K * m2;     // [kBigInvRows][m2]
  const int plane = blockIdx.y, r0 = blockIdx.x * kBigInvRows;
  const int rows = min(kBigInvRows, n1 - r0);
  nps::wait_for_previous_kernel();  // the mix's Y is written
  for (int i = threadIdx.x; i < K * m2; i += kBigThreads) {
    const int64_t s = static_cast<int64_t>(i) * planes + plane;  // mode i = k * m2 + m
    sy[i] = make_float2(yr[s], yi[s]);
  }
  __syncthreads();
  // rows first: Z[x, m] = sum_k Y[k, m] (cos + i sin)(2 pi kx x / n1)
  for (int i = threadIdx.x; i < kBigInvRows * m2; i += kBigThreads) {
    const int r = i / m2, m = i % m2;
    float zr = 0.f, zi = 0.f;
    if (r < rows) {
      const int xg = r0 + r;
      for (int k = 0; k < K; ++k) {
        const float c = __ldg(ic1 + static_cast<int64_t>(k) * n1 + xg);
        const float s = __ldg(is1 + static_cast<int64_t>(k) * n1 + xg);
        const float2 a = sy[k * m2 + m];
        zr = fmaf(a.x, c, fmaf(-a.y, s, zr));
        zi = fmaf(a.x, s, fmaf(a.y, c, zi));
      }
    }
    sz[i] = make_float2(zr, zi);
  }
  __syncthreads();
  // then the columns, real part only, Hermitian doubling folded into ic2/is2
  const int cg = (n2 + 3) / 4;  // threads per output row; the wrapper keeps cg <= kBigThreads
  const int j = threadIdx.x % cg, grp = threadIdx.x / cg, ngrp = kBigThreads / cg;
  if (grp >= ngrp) return;
  const int y0 = 4 * j;
  T* dst = out + (static_cast<int64_t>(plane) * n1 + r0) * n2 + y0;
  for (int rb = grp * kBigInvR; rb < rows; rb += ngrp * kBigInvR) {
    float acc[kBigInvR][4];
#pragma unroll
    for (int r = 0; r < kBigInvR; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 2
    for (int m = 0; m < m2; ++m) {
      float tc[4], ts[4];
      if constexpr (VEC) {
        const float4 c = __ldg(reinterpret_cast<const float4*>(ic2 + m * n2 + y0));
        const float4 s = __ldg(reinterpret_cast<const float4*>(is2 + m * n2 + y0));
        tc[0] = c.x; tc[1] = c.y; tc[2] = c.z; tc[3] = c.w;
        ts[0] = s.x; ts[1] = s.y; ts[2] = s.z; ts[3] = s.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = y0 + q < n2;
          tc[q] = ok ? __ldg(ic2 + m * n2 + y0 + q) : 0.f;
          ts[q] = ok ? __ldg(is2 + m * n2 + y0 + q) : 0.f;
        }
      }
      const float2* z = sz + rb * m2 + m;
#pragma unroll
      for (int r = 0; r < kBigInvR; ++r) {
        const float2 a = z[r * m2];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a.x, tc[q], fmaf(-a.y, ts[q], acc[r][q]));
      }
    }
#pragma unroll
    for (int r = 0; r < kBigInvR; ++r) {
      if (rb + r >= rows) break;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = acc[r][q] * scale;
      T* o = dst + static_cast<int64_t>(rb + r) * n2;
      if constexpr (VEC) {
        store4(o, v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (y0 + q < n2) store1(o + q, v[q]);
      }
    }
  }
}

// ---- the tensor-core DFT stages of the large-plane variant (bf16) -------------
// dft_fwd_tc_kernel and dft_inv_tc_kernel take the places of
// dft_fwd_big_kernel and dft_inv_big_kernel for bf16 x and out whose rows are
// a multiple of 8 points on 16-byte aligned planes (see the note above the
// large-plane kernels). Every table is built once on the host per shape
// (ops/spectral.py: tc_tables), split into hi + lo bf16 terms and stored in
// the order of the mma fragments, so that a lane reads its fragment with one
// 8- or 16-byte load.
constexpr int kTcThreads = 256;      // 8 warps
constexpr int kTcRows = kBigRows;    // plane rows per CTA: 32 per warp
constexpr int kTcKc = 64;            // y columns per staged chunk of x: 128-byte rows
constexpr int kTcStages = 2;
constexpr int kTcNg = 4;             // column-pass n-tiles (8 columns each) per table ring slot
constexpr int kTcInvStages = 3;      // the column pass's table ring
constexpr int kTcOutLd = 8 * kTcNg + 8;  // output staging pitch, bf16

// one ring stage: [kTcRows][kTcKc] bf16 of x (128-byte rows, the 16-byte
// pieces of row n at piece ^ (n % 8): TMA's 128-byte swizzle, so ldmatrix
// reads 8 rows of one piece from 8 bank groups), then the chunk's kTcKc / 16
// k-steps of the y table ([kTcKc / 16][MT][32] uint4)
constexpr uint32_t kTcXBytes = kTcRows * kTcKc * 2;
__host__ __device__ constexpr uint32_t tc_table_bytes(int MT) {
  return MT * (kTcKc / 16) * 32 * 16;
}
__host__ __device__ constexpr size_t tc_stage_bytes(int MT) {
  return static_cast<size_t>(kTcXBytes) + tc_table_bytes(MT);
}
// what the forward stage keeps after its y pass: T's fragments and (P | Q)
__host__ __device__ inline size_t tc_after_bytes(int MT, int NT) {
  const int I = (MT + 1) / 2;
  return static_cast<size_t>(I) * 16 * 2 * 32 * 16 + sizeof(float) * 16 * I * 8 * NT;
}

__device__ __forceinline__ const uint32_t* regs(const uint4& v) {
  return reinterpret_cast<const uint32_t*>(&v);
}

// The forward DFT stage on tensor cores, one CTA per (tile of kTcRows rows,
// plane); MT: 16-row tiles of the y table (the 2*m2 (cos | sin) mode rows in
// groups of 8, rows 0-7 of a tile hi, 8-15 lo).
//   y pass: T^T [mode rows, rows] = (hi ; lo) table [16 MT, n2] x x^T, warp w
//     owning rows [32 w, 32 w + 32) (4 n-tiles), x and the table streamed
//     kTcKc columns at a time through a 2-stage ring: one thread asks TMA
//     for the x box (the tile's rows, zeros past the plane's edge) and a
//     bulk copy for the table chunk, both completing on the stage's
//     mbarrier; T = the hi and lo products added (rows g and g+8 of the
//     same tile: one lane).
//   x pass: (P | Q) [mode rows, 2K] = T [mode rows, rows] x (c1 | s1) [rows,
//     2K], T split into hi + lo bf16 in the A-fragment order (the y pass's
//     accumulators are that order already) and staged in shared memory, the
//     table te read as B fragments {b0 hi, b1 hi, b0 lo, b1 lo}: three
//     products (hi hi, hi lo, lo hi). A warp owns an 8-column n-tile and
//     contracts all the tile's rows in a fixed order.
//   Then X_re[k, m] = P[m, k] - Q[m2 + m, k], X_im[k, m] = -P[m2 + m, k]
//   - Q[m, k] to pr, pi [tile][mode][plane] (or X itself with one tile).
template <int MT>
__global__ void __launch_bounds__(kTcThreads, MT <= 5 ? 2 : 1)
dft_fwd_tc_kernel(const __grid_constant__ CUtensorMap xmap, const uint4* __restrict__ ty,
                  const uint4* __restrict__ te, float* __restrict__ pr,
                  float* __restrict__ pi, int planes, int n1, int n2, int K, int m2, int NT) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int I = (MT + 1) / 2;  // 16-row tiles of mode rows in the x pass
  constexpr size_t kStage = tc_stage_bytes(MT);
  constexpr int kSteps = kTcKc / 16;
  // the swizzle repeats every 1024 bytes: the ring starts on such a boundary
  unsigned char* smem = smem_raw + ((1024 - (nps::smem_addr(smem_raw) & 1023)) & 1023);
  const size_t ring = kTcStages * kStage, after = tc_after_bytes(MT, NT);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (ring > after ? ring : after));
  const int tile = blockIdx.x, plane = blockIdx.y;
  const int r0 = tile * kTcRows;
  const int rows = min(kTcRows, n1 - r0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const bool active = 32 * warp < rows;  // warp-uniform
  const int nchunks = (n2 + kTcKc - 1) / kTcKc;

  const CUtensorMap* map = &xmap;
  auto load_chunk = [&](int c) {  // one thread
    unsigned char* base = smem + (c % kTcStages) * kStage;
    uint64_t* bar = bars + c % kTcStages;
    const uint4* tsrc = ty + static_cast<int64_t>(c) * kSteps * MT * 32;
    nps::mbar_expect_tx(bar, kTcXBytes + tc_table_bytes(MT));
    nps::tma_load_3d(base, map, c * kTcKc, r0, plane, bar);
    nps::bulk_load(base + kTcXBytes, tsrc, tc_table_bytes(MT), bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) nps::mbar_init(bars + s, 1);
    nps::mbar_init_fence();
    load_chunk(0);
  }
  __syncthreads();  // the barriers are initialised

  // acc[i][j]: mode-row tile i (2 I tiles, the last one zero when MT is
  // odd) x the warp's n-tile j of 8 rows
  float acc[2 * I][4][4];
#pragma unroll
  for (int i = 0; i < 2 * I; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    // stage (c + 1) % kTcStages was read in iteration c - 1, which every
    // warp has left (the barrier at its end)
    if (threadIdx.x == 0 && c + 1 < nchunks) load_chunk(c + 1);
    nps::mbar_wait(bars + c % kTcStages, (c / kTcStages) & 1);  // chunk c is in
    const unsigned char* xs = smem + (c % kTcStages) * kStage;
    const uint4* ts = reinterpret_cast<const uint4*>(xs + kTcXBytes);
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t b[4][2];
        const int q = lane / 8;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int n = 32 * warp + 8 * (2 * jj + (q >> 1)) + lane % 8;
          const int piece = (2 * kk + (q & 1)) ^ (n & 7);
          nps::ldmatrix_x4(xs + n * (kTcKc * 2) + 16 * piece, b[2 * jj][0], b[2 * jj][1],
                           b[2 * jj + 1][0], b[2 * jj + 1][1]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint4 a = ts[(kk * MT + i) * 32 + lane];
#pragma unroll
          for (int j = 0; j < 4; ++j) nps::mma_bf16(acc[i][j], regs(a), b[j]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage c % kTcStages
  }

  // T (hi + lo products) as x-pass A fragments, split into hi + lo:
  // tf[((ii * 16 + ks) * 2 + h) * 32 + lane], ks the tile's 16-row step
  // (the ring's space: every copy into it has completed)
  uint4* tf = reinterpret_cast<uint4*>(smem);
  float* pq = reinterpret_cast<float*>(smem + static_cast<size_t>(I) * 16 * 2 * 32 * 16);
  const int ldq = 8 * NT;
#pragma unroll
  for (int ii = 0; ii < I; ++ii) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // a0..a3: (tile 2ii + (q & 1), n-tile 2s + (q >> 1))
        const float* c = acc[2 * ii + (q & 1)][2 * s + (q >> 1)];
        nps::split_bf16x2(c[0] + c[2], c[1] + c[3], hi[q], lo[q]);
      }
      const int ks = 2 * warp + s;
      tf[((ii * 16 + ks) * 2 + 0) * 32 + lane] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      tf[((ii * 16 + ks) * 2 + 1) * 32 + lane] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  __syncthreads();

  const int rb0 = r0 / 16;
  for (int t = warp; t < NT; t += kTcThreads / 32) {
    float a2[I][4];
#pragma unroll
    for (int ii = 0; ii < I; ++ii)
#pragma unroll
      for (int e = 0; e < 4; ++e) a2[ii][e] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < kTcRows / 16; ++ks) {
      const uint4 bb = __ldg(te + (static_cast<int64_t>(rb0 + ks) * NT + t) * 32 + lane);
      const uint32_t bhi[2] = {bb.x, bb.y}, blo[2] = {bb.z, bb.w};
#pragma unroll
      for (int ii = 0; ii < I; ++ii) {
        const uint4 ahi = tf[((ii * 16 + ks) * 2 + 0) * 32 + lane];
        const uint4 alo = tf[((ii * 16 + ks) * 2 + 1) * 32 + lane];
        nps::mma_bf16(a2[ii], regs(ahi), bhi);
        nps::mma_bf16(a2[ii], regs(ahi), blo);
        nps::mma_bf16(a2[ii], regs(alo), bhi);
      }
    }
#pragma unroll
    for (int ii = 0; ii < I; ++ii) {
      float* p = pq + (16 * ii + g) * ldq + 8 * t + 2 * t4;
      p[0] = a2[ii][0];
      p[1] = a2[ii][1];
      p[8 * ldq] = a2[ii][2];
      p[8 * ldq + 1] = a2[ii][3];
    }
  }
  __syncthreads();
  const int64_t out0 = static_cast<int64_t>(tile) * K * m2;
  for (int i = threadIdx.x; i < K * m2; i += kTcThreads) {
    const int k = i / m2, m = i % m2;
    const float* pc = pq + m * ldq;         // the cos row of mode m
    const float* ps = pq + (m2 + m) * ldq;  // its sin row
    const int64_t o = (out0 + i) * planes + plane;  // [tile][mode][b][ci]
    pr[o] = pc[k] - ps[K + k];
    pi[o] = -ps[k] - pc[K + k];
  }
}

// Y [K, m2] of one plane (ys: re then im, mode k * m2 + m) as the row pass's
// B operand [[Yr, Yi], [-Yi, Yr]] (rows: the ic1 then the is1 row modes;
// columns: Zr then Zi), 0 outside.
__device__ __forceinline__ float tc_row_b(const float* ys, int row, int c, int K, int m2) {
  const bool second = row >= K;
  const int k = second ? row - K : row;
  if (k >= K || c >= 2 * m2) return 0.f;
  const bool im = c >= m2;
  const int i = k * m2 + (im ? c - m2 : c);
  const float re = ys[i], iv = ys[K * m2 + i];
  if (!second) return im ? iv : re;
  return im ? re : -iv;
}

// The inverse DFT stage on tensor cores, one CTA per (block of kTcRows rows,
// plane), warp w owning rows [32 w, 32 w + 32) (two 16-row m-tiles).
//   row pass: Z [rows, (Zr | Zi)] = (ic1 | is1)^T [rows, 2K] x
//     [[Yr, Yi], [-Yi, Yr]] [2K, 2 m2]: the table ta as A fragments (hi and
//     lo, from L2), Y staged once per CTA (one read of each value) and
//     split into hi + lo B fragments; three products.
//   column pass: out [rows, n2] = Z hi E hi + Z hi E lo + Z lo E hi, E =
//     (ic2 ; -is2) [2 m2, n2] with the Hermitian doubling folded in. The row
//     pass's accumulators are the column pass's A fragments in registers (C
//     and A share the row-g / row-g+8 layout), split into hi + lo there.
//     The table tb (the plane's largest operand: 96 KB at m2 = 20, n2 =
//     512) comes kTcNg n-tiles at a time through a kTcInvStages-deep
//     cp.async ring that all 8 warps read, so it crosses L2 once per CTA
//     and not once per warp; its first chunks are requested before the
//     wait for the mix, which they do not need.
//   Then the scale 1/(n1 n2), one rounding to bf16, and 16-byte stores
//   through a per-warp staging tile.
template <int MT>
__global__ void __launch_bounds__(kTcThreads, MT <= 5 ? 2 : 1)
dft_inv_tc_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                  const uint4* __restrict__ ta, const uint4* __restrict__ tb,
                  __nv_bfloat16* __restrict__ out, int planes, int n1, int n2, int K, int m2,
                  int KS1, float scale) {
  constexpr int KSZ = (MT + 1) / 2;           // k-steps of Z's 8 MT columns
  constexpr int kChunk = kTcNg * KSZ * 32;    // uint4 of tb per ring slot
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);                  // [stage][kChunk]
  uint4* yb = ring + kTcInvStages * kChunk;  // [KS1][MT][32] {b0 hi, b1 hi, b0 lo, b1 lo}
  // [warp][32][kTcOutLd]
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(yb + KS1 * MT * 32);
  float* ys = reinterpret_cast<float*>(stage + kTcThreads * kTcOutLd);          // [2][K m2]
  const int plane = blockIdx.y, r0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nt2 = n2 / 8, nchunks = (nt2 + kTcNg - 1) / kTcNg;

  auto load_chunk = [&](int c) {
    if (c < nchunks) {
      uint4* dst = ring + (c % kTcInvStages) * kChunk;
      const uint4* src = tb + static_cast<int64_t>(c) * kChunk;
      const int n = min(kTcNg, nt2 - c * kTcNg) * KSZ * 32;
      for (int i = threadIdx.x; i < n; i += kTcThreads) nps::cp_async16(dst + i, src + i);
    }
    nps::cp_async_commit();
  };
  for (int c = 0; c < kTcInvStages - 1; ++c) load_chunk(c);
  nps::wait_for_previous_kernel();  // the mix's Y is written
#pragma unroll 4
  for (int i = threadIdx.x; i < K * m2; i += kTcThreads) {
    const int64_t s = static_cast<int64_t>(i) * planes + plane;  // mode i = k * m2 + m
    ys[i] = yr[s];
    ys[K * m2 + i] = yi[s];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < KS1 * MT * 32; i += kTcThreads) {
    const int l = i % 32, t = (i / 32) % MT, s = i / (32 * MT);
    const int c = 8 * t + l / 4, kr = 16 * s + 2 * (l % 4);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = tc_row_b(ys, kr + (e & 1) + 8 * (e >> 1), c, K, m2);
    uint32_t h0, l0, h1, l1;
    nps::split_bf16x2(v[0], v[1], h0, l0);
    nps::split_bf16x2(v[2], v[3], h1, l1);
    yb[i] = make_uint4(h0, h1, l0, l1);
  }
  __syncthreads();
  const int rows_w = min(32, n1 - r0 - 32 * warp);
  const bool active = rows_w > 0;  // warp-uniform; an idle warp still loads and syncs

  // row pass, then Z as the column pass's A fragments: k-step s holds Z's
  // n-tiles 2s (a0, a1) and 2s + 1 (a2, a3)
  uint32_t ahi[2][KSZ][4], alo[2][KSZ][4];
  {
    float z[2][MT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[mt][t][e] = 0.f;
    const int64_t mt0 = (r0 + 32 * warp) / 16;
    for (int s = 0; active && s < KS1; ++s) {
      uint4 a_hi[2], a_lo[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint4* p = ta + (((mt0 + mt) * KS1 + s) * 2) * 32 + lane;
        a_hi[mt] = __ldg(p);
        a_lo[mt] = __ldg(p + 32);
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const uint4 bb = yb[(s * MT + t) * 32 + lane];
        const uint32_t bhi[2] = {bb.x, bb.y}, blo[2] = {bb.z, bb.w};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          nps::mma_bf16(z[mt][t], regs(a_hi[mt]), bhi);
          nps::mma_bf16(z[mt][t], regs(a_hi[mt]), blo);
          nps::mma_bf16(z[mt][t], regs(a_lo[mt]), bhi);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int s = 0; s < KSZ; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = 2 * s + (q >> 1), h = q & 1;
          if (t < MT) {
            nps::split_bf16x2(z[mt][t][2 * h], z[mt][t][2 * h + 1], ahi[mt][s][q], alo[mt][s][q]);
          } else {
            ahi[mt][s][q] = alo[mt][s][q] = 0u;
          }
        }
  }

  // column pass, one ring slot (kTcNg n-tiles) at a time
  __nv_bfloat16* st = stage + warp * 32 * kTcOutLd;
  __nv_bfloat16* dst = out + (static_cast<int64_t>(plane) * n1 + r0 + 32 * warp) * n2;
  for (int c = 0; c < nchunks; ++c) {
    nps::cp_async_wait<kTcInvStages - 2>();
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
    load_chunk(c + kTcInvStages - 1);
    if (!active) continue;
    const uint4* tc = ring + (c % kTcInvStages) * kChunk;
    const int t0 = c * kTcNg;
    float acc[2][kTcNg][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < kTcNg; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KSZ; ++s) {
#pragma unroll
      for (int j = 0; j < kTcNg; ++j) {
        if (t0 + j < nt2) {  // warp-uniform
          const uint4 bb = tc[(j * KSZ + s) * 32 + lane];
          const uint32_t bhi[2] = {bb.x, bb.y}, blo[2] = {bb.z, bb.w};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            nps::mma_bf16(acc[mt][j], ahi[mt][s], bhi);
            nps::mma_bf16(acc[mt][j], ahi[mt][s], blo);
            nps::mma_bf16(acc[mt][j], alo[mt][s], bhi);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < kTcNg; ++j) {
        __nv_bfloat16* p = st + (16 * mt + g) * kTcOutLd + 8 * j + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(acc[mt][j][0] * scale, acc[mt][j][1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * kTcOutLd) =
            __floats2bfloat162_rn(acc[mt][j][2] * scale, acc[mt][j][3] * scale);
      }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 32 * kTcNg; i += 32) {
      const int r = i / kTcNg, q = i % kTcNg;
      if (r < rows_w && t0 + q < nt2)
        __stcs(reinterpret_cast<uint4*>(dst + static_cast<int64_t>(r) * n2 + 8 * (t0 + q)),
               *reinterpret_cast<const uint4*>(st + r * kTcOutLd + 8 * q));
    }
    __syncwarp();
  }
  nps::cp_async_wait_all();
}

// ---- host ---------------------------------------------------------------------
struct Dims {
  int b, ci, co, n1, n2, K, m2;
};

// FiLM of one call: the factor (null: none) and its mode; ur, ui: the
// pre-FiLM Y, written by the forward (null: not kept) and read by the
// backward, which also takes the per-mode scale and writes dfilm (df).
struct Film {
  const float* f;
  int mode;
  float *ur, *ui;
  const float* scale;
  float* df;
};

size_t fwd_smem(const Dims& d, int M2, int V) {
  const int ld = d.n2 + (V == 4 ? 4 : 1);
  return sizeof(float) * (fwd_plane_floats(d.n1, ld) + 2 * (d.n2 * M2 + d.n1 * d.K + d.n1 * M2));
}
size_t mix_smem(const Dims& d, int BT) {
  const int ci_pad = (d.ci + kCiChunk - 1) / kCiChunk * kCiChunk;
  return sizeof(float) * (kStages * kCiChunk * 2 * kCoTile + 2 * ci_pad * BT);
}
// d.ci: the spectrum's channels (the pack's co), staged per batch tile
size_t mix_adj_smem(const Dims& d, int BT) {
  const int co_pad = (d.ci + kCiChunk - 1) / kCiChunk * kCiChunk;
  return sizeof(float) * (kStages * 2 * kCoTile * kAdjLd + 2 * co_pad * BT);
}
size_t inv_smem(const Dims& d, int M2) {
  return sizeof(float) * 2 * (d.K * M2 + d.K * d.n1 + d.n1 * M2);
}
// the staging ring of X and G, and the output stage (72.7 KB: 3 CTAs per SM)
constexpr size_t kDwSmem =
    sizeof(float) * (kDwStages * 2 * kDwSb * (kDwTi + kDwTo) + 2 * kDwTi * kDwTo * kDwLd);

// as many CTAs of `kernel` as are resident at once, and no more than `work`
template <typename K>
int resident_grid(K* kernel, int threads, size_t smem, int work) {
  static int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  int occ = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem);
  return max(1, min(work, occ * sms));
}

// Launch `kernel` with programmatic stream serialization (pdl): it may start
// while the previous kernel on the stream finishes, and reads that kernel's
// results only after nps::wait_for_previous_kernel(). Without pdl it is an
// ordinary launch (for a kernel whose input a collective, not the previous
// kernel, wrote).
template <typename... Params, typename... Args>
cudaError_t launch_maybe_pdl(bool pdl, void (*kernel)(Params...), dim3 grid, dim3 block,
                             size_t smem, cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}
template <typename... Params, typename... Args>
cudaError_t launch_after_previous(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                                  cudaStream_t st, Args... args) {
  return launch_maybe_pdl(true, kernel, grid, block, smem, st, args...);
}

// the kernels' shared-memory opt-in, once per process and kernel
template <auto Kernel>
cudaError_t opt_in_once() {
  static cudaError_t err = nps::allow_max_smem(Kernel);
  return err;
}

// The mix, after the forward DFT: mix_kernel, or with ADJ mix_adj_kernel on
// the same pack (d.ci, d.co are the spectrum's and the output's channels, so
// the pack is [mode, 2, d.co, d.ci] there).
template <bool ADJ, int BT, bool VEC>
cudaError_t launch_mix(const Dims& d, const float* w, const Film& film, const float* xr,
                       const float* xi, float* yr, float* yi, cudaStream_t st, bool pdl) {
  const dim3 grid(d.K * d.m2, (d.co + kCoTile - 1) / kCoTile);
  if constexpr (ADJ) {
    cudaError_t err = opt_in_once<mix_adj_kernel<BT, VEC>>();
    if (err != cudaSuccess) return err;
    return launch_maybe_pdl(pdl, mix_adj_kernel<BT, VEC>, grid, dim3(kMixThreads),
                            mix_adj_smem(d, BT), st, xr, xi, w, yr, yi, d.b, d.co, d.ci);
  } else {
    cudaError_t err = opt_in_once<mix_kernel<BT, VEC>>();
    if (err != cudaSuccess) return err;
    return launch_maybe_pdl(pdl, mix_kernel<BT, VEC>, grid, dim3(kMixThreads), mix_smem(d, BT),
                            st, xr, xi, w, film.f, film.mode, yr, yi, film.ur, film.ui, d.b,
                            d.ci, d.co, d.K, d.m2);
  }
}

// The mix at the batch tile that fits b (BT 1, 2, 4 or 8), vector weight
// reads where the pack's rows allow.
template <bool ADJ>
cudaError_t mix_stage(const Dims& d, const float* w, const Film& film, const float* xr,
                      const float* xi, float* yr, float* yi, bool w_vec, cudaStream_t st,
                      bool pdl = true) {
  const int bt = d.b > 4 ? 8 : d.b > 2 ? 4 : d.b;  // register tile in samples
  switch (bt * 2 + (w_vec ? 1 : 0)) {
    case 2: return launch_mix<ADJ, 1, false>(d, w, film, xr, xi, yr, yi, st, pdl);
    case 3: return launch_mix<ADJ, 1, true>(d, w, film, xr, xi, yr, yi, st, pdl);
    case 4: return launch_mix<ADJ, 2, false>(d, w, film, xr, xi, yr, yi, st, pdl);
    case 5: return launch_mix<ADJ, 2, true>(d, w, film, xr, xi, yr, yi, st, pdl);
    case 8: return launch_mix<ADJ, 4, false>(d, w, film, xr, xi, yr, yi, st, pdl);
    case 9: return launch_mix<ADJ, 4, true>(d, w, film, xr, xi, yr, yi, st, pdl);
    case 16: return launch_mix<ADJ, 8, false>(d, w, film, xr, xi, yr, yi, st, pdl);
    default: return launch_mix<ADJ, 8, true>(d, w, film, xr, xi, yr, yi, st, pdl);
  }
}

// The backward's FiLM stage, between the DFT of dy and the adjoint mix, when
// the forward applied FiLM: G *= f in place, and dfilm (d.ci: the forward's
// co, the spectrum's channels here).
cudaError_t film_stage(const Dims& d, const Film& film, float* gr, float* gi, cudaStream_t st) {
  if (film.f == nullptr) return cudaSuccess;
  const int modes = d.K * d.m2, pairs = d.b * d.ci;
  film_bwd_kernel<<<dim3((modes + kFilmTile - 1) / kFilmTile, (pairs + kFilmTile - 1) / kFilmTile),
                    kFilmTile * kFilmRows, 0, st>>>(gr, gi, film.ur, film.ui, film.f, film.mode,
                                                    film.scale, film.df, modes, pairs);
  return cudaGetLastError();
}

template <int M2, int V, bool ADJ>
int run_dft(const float* x, const float* c2, const float* s2, const float* c1,
            const float* s1, const float* ic2, const float* is2, const float* ic1,
            const float* is1, const float* w, const Film& film, float* xr, float* xi,
            float* yr, float* yi, float* out, const Dims& d, bool w_vec, cudaStream_t st) {
  cudaError_t err = opt_in_once<dft_fwd_kernel<M2, V>>();
  if (err == cudaSuccess) err = opt_in_once<dft_inv_kernel<M2, V>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t fs = fwd_smem(d, M2, V);
  const int fwd_grid = resident_grid(dft_fwd_kernel<M2, V>, kFwdThreads, fs, d.b * d.ci);
  dft_fwd_kernel<M2, V><<<fwd_grid, kFwdThreads, fs, st>>>(
      x, c2, s2, c1, s1, xr, xi, d.b, d.ci, d.n1, d.n2, d.K, d.m2);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (ADJ && (err = film_stage(d, film, xr, xi, st)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = mix_stage<ADJ>(d, w, film, xr, xi, yr, yi, w_vec, st)) != cudaSuccess)
    return static_cast<int>(err);

  const size_t is = inv_smem(d, M2);
  const int inv_grid = resident_grid(dft_inv_kernel<M2, V>, kThreads, is, d.b * d.co);
  return static_cast<int>(launch_after_previous(
      dft_inv_kernel<M2, V>, dim3(inv_grid), dim3(kThreads), is, st, yr, yi, ic2, is2, ic1, is1,
      out, d.b, d.co, d.n1, d.n2, d.K, d.m2,
      1.0f / (static_cast<float>(d.n1) * static_cast<float>(d.n2))));
}

// shared memory of the large-plane kernels
template <typename T, int M2>
size_t big_fwd_smem() {
  const size_t ring = big_stage_bytes<T>() + sizeof(float2) * kBigStages * kBigYc * M2;
  const size_t spectrum = sizeof(float2) * kBigRows * M2;
  return ring > spectrum ? ring : spectrum;
}
size_t big_inv_smem(const Dims& d) {
  return sizeof(float2) * static_cast<size_t>(d.K + kBigInvRows) * d.m2;
}

// X = the row tiles' partial spectra pr, pi [tiles, modes, b, ci] summed,
// when the rows take more than one tile
cudaError_t sum_tiles_stage(const Dims& d, int tiles, const float* pr, const float* pi,
                            float* xr, float* xi, cudaStream_t st) {
  if (tiles <= 1) return cudaSuccess;
  const int64_t n = static_cast<int64_t>(d.K) * d.m2 * d.b * d.ci;
  const int64_t blocks = (n + kBigThreads - 1) / kBigThreads;
  sum_tiles_kernel<<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535), kBigThreads, 0,
                     st>>>(pr, pi, xr, xi, tiles, n);
  return cudaGetLastError();
}

// The stages between the two DFT stages of the large-plane variant:
// sum_tiles_kernel when the rows take more than one tile (pr, pi [tiles,
// modes, b, ci] hold the partial spectra), with ADJ the FiLM stage, then the
// mix (with ADJ the adjoint one on the forward's pack).
template <bool ADJ>
cudaError_t big_middle(const Dims& d, int tiles, const float* w, const Film& film,
                       const float* pr, const float* pi, float* xr, float* xi, float* yr,
                       float* yi, bool w_vec, cudaStream_t st) {
  cudaError_t err = sum_tiles_stage(d, tiles, pr, pi, xr, xi, st);
  if (err != cudaSuccess) return err;
  if (ADJ && (err = film_stage(d, film, xr, xi, st)) != cudaSuccess) return err;
  return mix_stage<ADJ>(d, w, film, xr, xi, yr, yi, w_vec, st);
}

// The large-plane forward on the FMA stages: dft_fwd_big_kernel, the
// middle stages, dft_inv_big_kernel. With ADJ the input gradient: x is dy,
// d.ci and d.co are the spectrum's and the output's channels (the forward's
// co and ci).
template <typename T, int M2, bool VEC, bool ADJ>
int run_big(const T* x, const float* c2, const float* s2, const float* c1, const float* s1,
            const float* ic2, const float* is2, const float* ic1, const float* is1,
            const float* w, const Film& film, float* pr, float* pi, float* xr, float* xi,
            float* yr, float* yi, T* out, const Dims& d, bool w_vec, bool out_vec,
            cudaStream_t st) {
  cudaError_t err = opt_in_once<dft_fwd_big_kernel<T, M2, VEC>>();
  if (err == cudaSuccess) err = opt_in_once<dft_inv_big_kernel<T, true>>();
  if (err == cudaSuccess) err = opt_in_once<dft_inv_big_kernel<T, false>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (d.n1 + kBigRows - 1) / kBigRows;
  const int planes_in = d.b * d.ci;
  dft_fwd_big_kernel<T, M2, VEC><<<dim3(tiles, planes_in), kBigThreads,
                                   big_fwd_smem<T, M2>(), st>>>(
      x, c2, s2, c1, s1, tiles == 1 ? xr : pr, tiles == 1 ? xi : pi, planes_in, d.n1, d.n2,
      d.K, d.m2);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = big_middle<ADJ>(d, tiles, w, film, pr, pi, xr, xi, yr, yi, w_vec, st)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const dim3 grid((d.n1 + kBigInvRows - 1) / kBigInvRows, d.b * d.co);
  const float scale = 1.0f / (static_cast<float>(d.n1) * static_cast<float>(d.n2));
  if (out_vec)
    return static_cast<int>(launch_after_previous(
        dft_inv_big_kernel<T, true>, grid, dim3(kBigThreads), big_inv_smem(d), st, yr, yi, ic2,
        is2, ic1, is1, out, d.b * d.co, d.n1, d.n2, d.K, d.m2, scale));
  return static_cast<int>(launch_after_previous(
      dft_inv_big_kernel<T, false>, grid, dim3(kBigThreads), big_inv_smem(d), st, yr, yi, ic2,
      is2, ic1, is1, out, d.b * d.co, d.n1, d.n2, d.K, d.m2, scale));
}

// The tensor-core stages' tables (ops/spectral.py: tc_tables), in mma
// fragment order: ty [ceil(n2/64)*4][MT][32] uint4 (y pass, A), te
// [tiles*16][NT][32] uint4 (x pass, B hi | lo), ta [tiles*16][KS1][2][32]
// uint4 (row pass, A hi, lo), tb [n2/8][(MT+1)/2][32] uint4 (column pass, B
// hi | lo).
struct TcTables {
  const void *ty, *te, *ta, *tb;
};

// the x pass's (c1 | s1) columns in n-tiles of 8, and the row pass's 2K
// row modes in k-steps of 16
inline int tc_nt(const Dims& d) { return (2 * d.K + 7) / 8; }
inline int tc_ks1(const Dims& d) { return (2 * d.K + 15) / 16; }
// the ring or what follows it, the alignment slack, the stages' barriers
size_t tc_fwd_smem(int MT, const Dims& d) {
  const size_t ring = kTcStages * tc_stage_bytes(MT), after = tc_after_bytes(MT, tc_nt(d));
  return (ring > after ? ring : after) + 1024 + kTcStages * sizeof(uint64_t);
}

// x [planes][n1][n2] bf16 as TMA's 3D tensor map, in boxes of kTcKc
// columns x kTcRows rows with the 128-byte swizzle (tc_stages has checked
// that rows are 16-byte multiples on a 16-byte aligned base, as TMA needs)
cudaError_t tc_x_map(CUtensorMap* map, const void* x, const Dims& d, int planes) {
  static const auto encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d.n2), static_cast<cuuint64_t>(d.n1),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d.n2) * 2,
                                 static_cast<cuuint64_t>(d.n1) * d.n2 * 2};
  const cuuint32_t box[3] = {kTcKc, kTcRows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
size_t tc_inv_smem(int MT, const Dims& d) {
  const size_t ring = static_cast<size_t>(kTcInvStages) * kTcNg * ((MT + 1) / 2) * 32 * 16;
  return ring + static_cast<size_t>(tc_ks1(d)) * MT * 32 * 16 + kTcThreads * kTcOutLd * 2 +
         sizeof(float) * 2 * d.K * d.m2;
}

// The large-plane forward on the tensor-core stages: dft_fwd_tc_kernel, the
// middle stages, dft_inv_tc_kernel (bf16 x and out; ADJ as in run_big).
template <int MT, bool ADJ>
int run_big_tc(const __nv_bfloat16* x, const TcTables& tc, const float* w, const Film& film,
               float* pr, float* pi, float* xr, float* xi, float* yr, float* yi,
               __nv_bfloat16* out, const Dims& d, bool w_vec, cudaStream_t st) {
  cudaError_t err = opt_in_once<dft_fwd_tc_kernel<MT>>();
  if (err == cudaSuccess) err = opt_in_once<dft_inv_tc_kernel<MT>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (d.n1 + kTcRows - 1) / kTcRows;
  const int planes_in = d.b * d.ci;
  CUtensorMap xmap;
  if ((err = tc_x_map(&xmap, x, d, planes_in)) != cudaSuccess) return static_cast<int>(err);
  dft_fwd_tc_kernel<MT><<<dim3(tiles, planes_in), kTcThreads, tc_fwd_smem(MT, d), st>>>(
      xmap, static_cast<const uint4*>(tc.ty), static_cast<const uint4*>(tc.te),
      tiles == 1 ? xr : pr, tiles == 1 ? xi : pi, planes_in, d.n1, d.n2, d.K, d.m2, tc_nt(d));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = big_middle<ADJ>(d, tiles, w, film, pr, pi, xr, xi, yr, yi, w_vec, st)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const float scale = 1.0f / (static_cast<float>(d.n1) * static_cast<float>(d.n2));
  return static_cast<int>(launch_after_previous(
      dft_inv_tc_kernel<MT>, dim3(tiles, d.b * d.co), dim3(kTcThreads), tc_inv_smem(MT, d), st,
      yr, yi, static_cast<const uint4*>(tc.ta), static_cast<const uint4*>(tc.tb), out,
      d.b * d.co, d.n1, d.n2, d.K, d.m2, tc_ks1(d), scale));
}

// The stages a large-plane call runs: the tensor-core ones for bf16 rows of
// a multiple of 8 points on 16-byte aligned planes (x and out), the FMA
// ones otherwise. Mirrored by ops/spectral.py: large_stages.
template <typename T>
bool tc_stages(const Dims& d, const void* x, const void* out) {
  return std::is_same<T, __nv_bfloat16>::value && d.n2 % 8 == 0 &&
         ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
}

// the large-plane stages: the tensor-core ones where tc_stages chooses them
// (their tile count MT of mode rows by m2: 3, 5 or 8), else the FMA ones at
// the unrolled m2 bound that fits; w_co: the pack's last dim
template <typename T, bool ADJ>
int dispatch_big(const void* x, const float* w_packed, const Film& film, const float* c2,
                 const float* s2, const float* c1, const float* s1, const float* ic2,
                 const float* is2, const float* ic1, const float* is1, const TcTables& tc,
                 float* pr, float* pi, float* xr, float* xi, float* yr, float* yi, void* out,
                 const Dims& d, int w_co, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w_vec = w_co % 4 == 0 && (reinterpret_cast<uintptr_t>(w_packed) & 15) == 0;
  if (tc_stages<T>(d, x, out)) {
    if (!tc.ty || !tc.te || !tc.ta || !tc.tb) return static_cast<int>(cudaErrorInvalidValue);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (d.m2 <= 12)
      return run_big_tc<3, ADJ>(xb, tc, w_packed, film, pr, pi, xr, xi, yr, yi, ob, d, w_vec, st);
    if (d.m2 <= 20)
      return run_big_tc<5, ADJ>(xb, tc, w_packed, film, pr, pi, xr, xi, yr, yi, ob, d, w_vec, st);
    return run_big_tc<8, ADJ>(xb, tc, w_packed, film, pr, pi, xr, xi, yr, yi, ob, d, w_vec, st);
  }
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  constexpr uintptr_t kAlign = 4 * sizeof(T);
  const bool in_vec = d.n2 % 4 == 0 && (reinterpret_cast<uintptr_t>(x) % kAlign) == 0;
  const bool out_vec = d.n2 % 4 == 0 && (reinterpret_cast<uintptr_t>(out) % kAlign) == 0;
#define NPS_BIG(M2, VEC)                                                                      \
  return run_big<T, M2, VEC, ADJ>(xt, c2, s2, c1, s1, ic2, is2, ic1, is1, w_packed, film, pr, pi, \
                             xr, xi, yr, yi, ot, d, w_vec, out_vec, st)
  if (d.m2 <= 12) {
    if (in_vec) NPS_BIG(12, true); else NPS_BIG(12, false);
  } else if (d.m2 <= 20) {
    if (in_vec) NPS_BIG(20, true); else NPS_BIG(20, false);
  } else {  // the wrapper keeps m2 <= 32
    if (in_vec) NPS_BIG(32, true); else NPS_BIG(32, false);
  }
#undef NPS_BIG
}

// the three stages at the unrolled m2 bound and row width that fit; d.ci and
// d.co are the input's and the output's channels; w_co: the pack's last dim
template <bool ADJ>
int dispatch_dft(const float* x, const float* w_packed, const Film& film, const float* c2,
                 const float* s2, const float* c1, const float* s1, const float* ic2,
                 const float* is2, const float* ic1, const float* is1, float* xr, float* xi,
                 float* yr, float* yi, float* out, const Dims& d, int w_co, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte rows need n2 % 4 == 0 and aligned planes (the wrapper passes
  // fresh contiguous tensors)
  const bool v4 = d.n2 % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const bool w_vec = w_co % 4 == 0 && (reinterpret_cast<uintptr_t>(w_packed) & 15) == 0;
#define NPS_DFT(M2, V)                                                                 \
  return run_dft<M2, V, ADJ>(x, c2, s2, c1, s1, ic2, is2, ic1, is1, w_packed, film, xr, \
                             xi, yr, yi, out, d, w_vec, st)
  if (d.m2 <= 4) {
    if (v4) NPS_DFT(4, 4); else NPS_DFT(4, 1);
  } else if (d.m2 <= 8) {
    if (v4) NPS_DFT(8, 4); else NPS_DFT(8, 1);
  } else if (d.m2 <= 10) {
    if (v4) NPS_DFT(10, 4); else NPS_DFT(10, 1);
  } else {  // the wrapper keeps m2 <= 16
    if (v4) NPS_DFT(16, 4); else NPS_DFT(16, 1);
  }
#undef NPS_DFT
}

// ---- row-split stages (spatial parallelism) --------------------------------------
// Under spatial parallelism a rank holds rows [r0, r0 + n1) of an N1-row
// plane. The transform is linear in the rows, so it splits at the row
// contraction: the forward DFT of the local rows through rows [r0, r0 + n1)
// of the forward row tables gives a partial spectrum, the caller sums it
// over the x group, and the mix and the inverse to the local rows (columns
// [r0, r0 + n1) of the inverse row tables, scale 1 / (N1 n2)) follow. The
// entries below run one stage each, with the kernels above at n1 = the
// local rows; the caller passes the window's tables (ops/spectral.py:
// dft_tables_rows, tc_tables). The first kernel of each entry is an
// ordinary launch: what precedes it on the stream is the caller's
// collective, not a kernel that writes its input.

template <int M2, int V>
int split_dft_res(const float* x, const float* c2, const float* s2, const float* c1,
                  const float* s1, float* xr, float* xi, const Dims& d, cudaStream_t st) {
  cudaError_t err = opt_in_once<dft_fwd_kernel<M2, V>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t fs = fwd_smem(d, M2, V);
  const int grid = resident_grid(dft_fwd_kernel<M2, V>, kFwdThreads, fs, d.b * d.ci);
  dft_fwd_kernel<M2, V><<<grid, kFwdThreads, fs, st>>>(x, c2, s2, c1, s1, xr, xi, d.b, d.ci,
                                                       d.n1, d.n2, d.K, d.m2);
  return static_cast<int>(cudaGetLastError());
}

template <int M2, int V>
int split_inv_res(const float* yr, const float* yi, const float* ic2, const float* is2,
                  const float* ic1, const float* is1, float* out, const Dims& d, float scale,
                  cudaStream_t st) {
  cudaError_t err = opt_in_once<dft_inv_kernel<M2, V>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t is = inv_smem(d, M2);
  const int grid = resident_grid(dft_inv_kernel<M2, V>, kThreads, is, d.b * d.co);
  dft_inv_kernel<M2, V><<<grid, kThreads, is, st>>>(yr, yi, ic2, is2, ic1, is1, out, d.b, d.co,
                                                    d.n1, d.n2, d.K, d.m2, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int M2, bool VEC>
int split_dft_big(const T* x, const float* c2, const float* s2, const float* c1,
                  const float* s1, float* pr, float* pi, float* xr, float* xi, const Dims& d,
                  cudaStream_t st) {
  cudaError_t err = opt_in_once<dft_fwd_big_kernel<T, M2, VEC>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (d.n1 + kBigRows - 1) / kBigRows, planes = d.b * d.ci;
  dft_fwd_big_kernel<T, M2, VEC><<<dim3(tiles, planes), kBigThreads, big_fwd_smem<T, M2>(),
                                   st>>>(x, c2, s2, c1, s1, tiles == 1 ? xr : pr,
                                         tiles == 1 ? xi : pi, planes, d.n1, d.n2, d.K, d.m2);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_tiles_stage(d, tiles, pr, pi, xr, xi, st));
}

template <int MT>
int split_dft_tc(const __nv_bfloat16* x, const TcTables& tc, float* pr, float* pi, float* xr,
                 float* xi, const Dims& d, cudaStream_t st) {
  cudaError_t err = opt_in_once<dft_fwd_tc_kernel<MT>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (d.n1 + kTcRows - 1) / kTcRows, planes = d.b * d.ci;
  CUtensorMap xmap;
  if ((err = tc_x_map(&xmap, x, d, planes)) != cudaSuccess) return static_cast<int>(err);
  dft_fwd_tc_kernel<MT><<<dim3(tiles, planes), kTcThreads, tc_fwd_smem(MT, d), st>>>(
      xmap, static_cast<const uint4*>(tc.ty), static_cast<const uint4*>(tc.te),
      tiles == 1 ? xr : pr, tiles == 1 ? xi : pi, planes, d.n1, d.n2, d.K, d.m2, tc_nt(d));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_tiles_stage(d, tiles, pr, pi, xr, xi, st));
}

template <typename T, bool VEC>
int split_inv_big(const float* yr, const float* yi, const float* ic2, const float* is2,
                  const float* ic1, const float* is1, T* out, const Dims& d, float scale,
                  cudaStream_t st) {
  cudaError_t err = opt_in_once<dft_inv_big_kernel<T, VEC>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((d.n1 + kBigInvRows - 1) / kBigInvRows, d.b * d.co);
  dft_inv_big_kernel<T, VEC><<<grid, kBigThreads, big_inv_smem(d), st>>>(
      yr, yi, ic2, is2, ic1, is1, out, d.b * d.co, d.n1, d.n2, d.K, d.m2, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int split_inv_tc(const float* yr, const float* yi, const TcTables& tc, __nv_bfloat16* out,
                 const Dims& d, float scale, cudaStream_t st) {
  cudaError_t err = opt_in_once<dft_inv_tc_kernel<MT>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (d.n1 + kTcRows - 1) / kTcRows;
  dft_inv_tc_kernel<MT><<<dim3(tiles, d.b * d.co), kTcThreads, tc_inv_smem(MT, d), st>>>(
      yr, yi, static_cast<const uint4*>(tc.ta), static_cast<const uint4*>(tc.tb), out,
      d.b * d.co, d.n1, d.n2, d.K, d.m2, tc_ks1(d), scale);
  return static_cast<int>(cudaGetLastError());
}

// the large-plane forward DFT stage of a split call (tensor-core or FMA, as
// dispatch_big chooses them, by x alone)
template <typename T>
int split_dft_large(const void* x, const float* c2, const float* s2, const float* c1,
                    const float* s1, const TcTables& tc, float* pr, float* pi, float* xr,
                    float* xi, const Dims& d, cudaStream_t st) {
  if (tc_stages<T>(d, x, x)) {
    if (!tc.ty || !tc.te) return static_cast<int>(cudaErrorInvalidValue);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    if (d.m2 <= 12) return split_dft_tc<3>(xb, tc, pr, pi, xr, xi, d, st);
    if (d.m2 <= 20) return split_dft_tc<5>(xb, tc, pr, pi, xr, xi, d, st);
    return split_dft_tc<8>(xb, tc, pr, pi, xr, xi, d, st);
  }
  const T* xt = static_cast<const T*>(x);
  const bool vec = d.n2 % 4 == 0 && (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T))) == 0;
#define NPS_SPLIT_BIG(M2)                                                                   \
  return vec ? split_dft_big<T, M2, true>(xt, c2, s2, c1, s1, pr, pi, xr, xi, d, st)      \
             : split_dft_big<T, M2, false>(xt, c2, s2, c1, s1, pr, pi, xr, xi, d, st)
  if (d.m2 <= 12) NPS_SPLIT_BIG(12);
  if (d.m2 <= 20) NPS_SPLIT_BIG(20);
  NPS_SPLIT_BIG(32);
#undef NPS_SPLIT_BIG
}

// the large-plane inverse stage of a split call (by out alone)
template <typename T>
int split_inv_large(const float* yr, const float* yi, const float* ic2, const float* is2,
                    const float* ic1, const float* is1, const TcTables& tc, void* out,
                    const Dims& d, float scale, cudaStream_t st) {
  if (tc_stages<T>(d, out, out)) {
    if (!tc.ta || !tc.tb) return static_cast<int>(cudaErrorInvalidValue);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (d.m2 <= 12) return split_inv_tc<3>(yr, yi, tc, ob, d, scale, st);
    if (d.m2 <= 20) return split_inv_tc<5>(yr, yi, tc, ob, d, scale, st);
    return split_inv_tc<8>(yr, yi, tc, ob, d, scale, st);
  }
  T* ot = static_cast<T*>(out);
  if (d.n2 % 4 == 0 && (reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T))) == 0)
    return split_inv_big<T, true>(yr, yi, ic2, is2, ic1, is1, ot, d, scale, st);
  return split_inv_big<T, false>(yr, yi, ic2, is2, ic1, is1, ot, d, scale, st);
}

}  // namespace

// ur, ui [modes, b, co] (null: not kept) receive the pre-FiLM Y when film is
// given, for the FiLM gradient.
extern "C" int spectral_dft2d_fwd(
    const float* x, const float* w_packed, const float* film, int film_mode,
    const float* c2, const float* s2, const float* c1, const float* s1,
    const float* ic2, const float* is2, const float* ic1, const float* is1,
    float* xr, float* xi, float* yr, float* yi, float* ur, float* ui, float* out, int b,
    int ci, int co, int n1, int n2, int m1, int m2, void* stream) {
  const Film f{film, film_mode, film ? ur : nullptr, film ? ui : nullptr, nullptr, nullptr};
  return dispatch_dft<false>(x, w_packed, f, c2, s2, c1, s1, ic2, is2, ic1, is1, xr, xi, yr, yi,
                             out, Dims{b, ci, co, n1, n2, 2 * m1, m2}, co, stream);
}

// The large-plane variant of spectral_dft2d_fwd (see the note above the
// large-plane kernels): x and out f32 or (is_bf16) bf16, everything else as
// there; ty, te, ta, tb: the tensor-core stages' tables (null when the call
// takes the FMA stages; a call that takes the tensor-core ones without them
// fails with cudaErrorInvalidValue); pr, pi [ceil(n1 / 256), modes, b, ci]
// receive the row tiles' partial spectra (unused, and may be null, when
// n1 <= 256).
extern "C" int spectral_dft2d_fwd_large(
    const void* x, const float* w_packed, const float* film, int film_mode,
    const float* c2, const float* s2, const float* c1, const float* s1,
    const float* ic2, const float* is2, const float* ic1, const float* is1,
    const void* ty, const void* te, const void* ta, const void* tb,
    float* pr, float* pi, float* xr, float* xi, float* yr, float* yi, float* ur, float* ui,
    void* out, int b, int ci, int co, int n1, int n2, int m1, int m2, int is_bf16,
    void* stream) {
  const Film f{film, film_mode, film ? ur : nullptr, film ? ui : nullptr, nullptr, nullptr};
  const Dims d{b, ci, co, n1, n2, 2 * m1, m2};
  const TcTables tc{ty, te, ta, tb};
  if (is_bf16)
    return dispatch_big<__nv_bfloat16, false>(x, w_packed, f, c2, s2, c1, s1, ic2, is2, ic1,
                                              is1, tc, pr, pi, xr, xi, yr, yi, out, d, co,
                                              stream);
  return dispatch_big<float, false>(x, w_packed, f, c2, s2, c1, s1, ic2, is2, ic1, is1, tc, pr,
                                    pi, xr, xi, yr, yi, out, d, co, stream);
}

// The input gradient: dy [b, co, n1, n2] -> dx [b, ci, n1, n2] through the
// forward's pack [2*m1*m2, 2, ci, co] (ci, co are the forward's); gr, gi
// [modes, b, co] receive dy's spectrum G, hr, hi [modes, b, ci] the mix's.
// With film [b, co, 2*m1, m2] (null: none): ur, ui [modes, b, co] are the
// forward's pre-FiLM Y and scale [modes] the inverse's per-mode factor;
// dfilm [b, co, 2*m1, m2] receives the FiLM gradient, and gr, gi hold G f.
// With film but a null dfilm (film needs no gradient), ur, ui and scale
// are not read and only G is scaled.
extern "C" int spectral_dft2d_bwd(
    const float* dy, const float* w_packed, const float* film, int film_mode,
    float* ur, float* ui, const float* scale, float* dfilm,
    const float* c2, const float* s2, const float* c1, const float* s1,
    const float* ic2, const float* is2, const float* ic1, const float* is1,
    float* gr, float* gi, float* hr, float* hi, float* dx, int b, int ci,
    int co, int n1, int n2, int m1, int m2, void* stream) {
  const Film f{film, film_mode, ur, ui, scale, dfilm};
  return dispatch_dft<true>(dy, w_packed, f, c2, s2, c1, s1, ic2, is2, ic1, is1, gr, gi, hr,
                            hi, dx, Dims{b, co, ci, n1, n2, 2 * m1, m2}, co, stream);
}

// The large-plane variant of spectral_dft2d_bwd (see the note above the
// large-plane kernels): dy and dx f32 or (is_bf16) bf16, ty, te, ta, tb as in
// spectral_dft2d_fwd_large, everything else as there; pr, pi [ceil(n1 /
// 256), modes, b, co] receive the row tiles' partial spectra of dy (unused,
// and may be null, when n1 <= 256).
extern "C" int spectral_dft2d_bwd_large(
    const void* dy, const float* w_packed, const float* film, int film_mode,
    float* ur, float* ui, const float* scale, float* dfilm,
    const float* c2, const float* s2, const float* c1, const float* s1,
    const float* ic2, const float* is2, const float* ic1, const float* is1,
    const void* ty, const void* te, const void* ta, const void* tb,
    float* pr, float* pi, float* gr, float* gi, float* hr, float* hi, void* dx, int b, int ci,
    int co, int n1, int n2, int m1, int m2, int is_bf16, void* stream) {
  const Film f{film, film_mode, ur, ui, scale, dfilm};
  const Dims d{b, co, ci, n1, n2, 2 * m1, m2};
  const TcTables tc{ty, te, ta, tb};
  if (is_bf16)
    return dispatch_big<__nv_bfloat16, true>(dy, w_packed, f, c2, s2, c1, s1, ic2, is2, ic1,
                                             is1, tc, pr, pi, gr, gi, hr, hi, dx, d, co, stream);
  return dispatch_big<float, true>(dy, w_packed, f, c2, s2, c1, s1, ic2, is2, ic1, is1, tc, pr,
                                   pi, gr, gi, hr, hi, dx, d, co, stream);
}

// The weight gradient into dw1, dw2 [2, ci, co, m1, m2] from X [modes, b, ci]
// (xr, xi) and G [modes, b, co] (gr, gi), scaled per mode by scale [modes].
extern "C" int spectral_dw2d(const float* xr, const float* xi, const float* gr,
                             const float* gi, const float* scale, float* dw1, float* dw2,
                             int b, int ci, int co, int m1, int m2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nm = m1 * m2;
  const dim3 grid(2 * ((nm + kDwModes - 1) / kDwModes), (co + kDwTo - 1) / kDwTo,
                  (ci + kDwTi - 1) / kDwTi);
  cudaError_t err;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(xi) |
                         reinterpret_cast<uintptr_t>(gr) | reinterpret_cast<uintptr_t>(gi);
  if (ci % 4 == 0 && co % 4 == 0 && (ptrs & 15) == 0) {
    if ((err = opt_in_once<spectral_dw_kernel<true>>()) != cudaSuccess)
      return static_cast<int>(err);
    spectral_dw_kernel<true><<<grid, kDwThreads, kDwSmem, st>>>(xr, xi, gr, gi, scale, dw1,
                                                               dw2, b, ci, co, nm);
  } else {
    if ((err = opt_in_once<spectral_dw_kernel<false>>()) != cudaSuccess)
      return static_cast<int>(err);
    spectral_dw_kernel<false><<<grid, kDwThreads, kDwSmem, st>>>(xr, xi, gr, gi, scale, dw1,
                                                                dw2, b, ci, co, nm);
  }
  return static_cast<int>(cudaGetLastError());
}

// Stage A of a row-split call: x [b, c, n1, n2] (n1: this rank's rows, f32
// or bf16) -> its partial truncated spectrum xr, xi [modes, b, c], through
// the window's tables c1, s1 [n1, 2*m1] (and, for the tensor-core stage, ty,
// te of the window; null otherwise). resident: the resident kernel (f32),
// else the large-plane stage; pr, pi [ceil(n1 / 256), modes, b, c] take its
// row tiles' partials (may be null when n1 <= 256).
extern "C" int spectral_split_dft(const void* x, const float* c2, const float* s2,
                                  const float* c1, const float* s1, const void* ty,
                                  const void* te, float* pr, float* pi, float* xr, float* xi,
                                  int b, int c, int n1, int n2, int m1, int m2, int is_bf16,
                                  int resident, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{b, c, c, n1, n2, 2 * m1, m2};
  if (resident) {
    const float* xf = static_cast<const float*>(x);
    const bool v4 = n2 % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
#define NPS_SPLIT_RES(M2)                                                                  \
  return v4 ? split_dft_res<M2, 4>(xf, c2, s2, c1, s1, xr, xi, d, st)                     \
            : split_dft_res<M2, 1>(xf, c2, s2, c1, s1, xr, xi, d, st)
    if (m2 <= 4) NPS_SPLIT_RES(4);
    if (m2 <= 8) NPS_SPLIT_RES(8);
    if (m2 <= 10) NPS_SPLIT_RES(10);
    NPS_SPLIT_RES(16);
#undef NPS_SPLIT_RES
  }
  const TcTables tc{ty, te, nullptr, nullptr};
  if (is_bf16)
    return split_dft_large<__nv_bfloat16>(x, c2, s2, c1, s1, tc, pr, pi, xr, xi, d, st);
  return split_dft_large<float>(x, c2, s2, c1, s1, tc, pr, pi, xr, xi, d, st);
}

// The mix of a split call, on the x group's summed spectrum xr, xi [modes,
// b, c_in] -> yr, yi [modes, b, c_out]. Forward (adjoint 0): mix_kernel on
// the pack [modes, 2, c_in, c_out] with FiLM as spectral_dft2d_fwd's (ur, ui
// receive the pre-FiLM Y where given). Adjoint: xr, xi are this rank's
// partial G of dy, scaled in place by the FiLM factor (dfilm written, as in
// spectral_dft2d_bwd), then mix_adj_kernel on the forward's pack [modes, 2,
// c_out, c_in] gives this rank's partial H.
extern "C" int spectral_split_mix(float* xr, float* xi, const float* w_packed, const float* film,
                                  int film_mode, float* ur, float* ui, const float* scale,
                                  float* dfilm, float* yr, float* yi, int b, int c_in, int c_out,
                                  int m1, int m2, int adjoint, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{b, c_in, c_out, 0, 0, 2 * m1, m2};
  const int w_co = adjoint ? c_in : c_out;
  const bool w_vec = w_co % 4 == 0 && (reinterpret_cast<uintptr_t>(w_packed) & 15) == 0;
  if (adjoint) {
    const Film f{film, film_mode, ur, ui, scale, dfilm};
    cudaError_t err = film_stage(d, f, xr, xi, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(mix_stage<true>(d, w_packed, f, xr, xi, yr, yi, w_vec, st, false));
  }
  const Film f{film, film_mode, film ? ur : nullptr, film ? ui : nullptr, nullptr, nullptr};
  return static_cast<int>(mix_stage<false>(d, w_packed, f, xr, xi, yr, yi, w_vec, st, false));
}

// Stage B's inverse of a split call: yr, yi [modes, b, c] -> out [b, c, n1,
// n2] (n1: this rank's rows, f32 or bf16) through the window's inverse
// tables ic1, is1 [2*m1, n1] (and ta, tb for the tensor-core stage), scaled
// by `scale` (1 / (N1 n2) of the whole plane); resident as in
// spectral_split_dft.
extern "C" int spectral_split_inv(const float* yr, const float* yi, const float* ic2,
                                  const float* is2, const float* ic1, const float* is1,
                                  const void* ta, const void* tb, void* out, int b, int c, int n1,
                                  int n2, int m1, int m2, float scale, int is_bf16, int resident,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{b, c, c, n1, n2, 2 * m1, m2};
  if (resident) {
    float* of = static_cast<float*>(out);
    const bool v4 = n2 % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#define NPS_SPLIT_RES(M2)                                                                  \
  return v4 ? split_inv_res<M2, 4>(yr, yi, ic2, is2, ic1, is1, of, d, scale, st)          \
            : split_inv_res<M2, 1>(yr, yi, ic2, is2, ic1, is1, of, d, scale, st)
    if (m2 <= 4) NPS_SPLIT_RES(4);
    if (m2 <= 8) NPS_SPLIT_RES(8);
    if (m2 <= 10) NPS_SPLIT_RES(10);
    NPS_SPLIT_RES(16);
#undef NPS_SPLIT_RES
  }
  const TcTables tc{nullptr, nullptr, ta, tb};
  if (is_bf16)
    return split_inv_large<__nv_bfloat16>(yr, yi, ic2, is2, ic1, is1, tc, out, d, scale, st);
  return split_inv_large<float>(yr, yi, ic2, is2, ic1, is1, tc, out, d, scale, st);
}
