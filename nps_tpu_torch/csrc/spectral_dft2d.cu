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
// [modes, b, ci] and yr,yi [modes, b, co]; out f32 [b, co, n1, n2].
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
// Backward scratch: gr,gi [modes, b, co] (G, kept for the weight gradient)
// and hr,hi [modes, b, ci]; dx f32 [b, ci, n1, n2]; dw1, dw2 f32
// [2, ci, co, m1, m2]; scale f32 [modes], h(m)/(n1 n2).

#include <cuda_runtime.h>
#include <stdint.h>

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
           float* __restrict__ yr, float* __restrict__ yi, int b, int ci, int co, int K,
           int m2) {
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
// FiLM (not ported with gradients): the real factor f[b, o, mode] would
// scale G where it is staged into sg, and its own gradient Re(conj(Y) G)
// would need the forward's unscaled Y.
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

// ---- host ---------------------------------------------------------------------
struct Dims {
  int b, ci, co, n1, n2, K, m2;
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

// Launch `kernel` with programmatic stream serialization: it may start while
// the previous kernel on the stream finishes, and reads that kernel's
// results only after nps::wait_for_previous_kernel().
template <typename... Params, typename... Args>
cudaError_t launch_after_previous(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                                  cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
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
cudaError_t launch_mix(const Dims& d, const float* w, const float* film, int film_mode,
                       const float* xr, const float* xi, float* yr, float* yi,
                       cudaStream_t st) {
  const dim3 grid(d.K * d.m2, (d.co + kCoTile - 1) / kCoTile);
  if constexpr (ADJ) {
    cudaError_t err = opt_in_once<mix_adj_kernel<BT, VEC>>();
    if (err != cudaSuccess) return err;
    return launch_after_previous(mix_adj_kernel<BT, VEC>, grid, dim3(kMixThreads),
                                 mix_adj_smem(d, BT), st, xr, xi, w, yr, yi, d.b, d.co, d.ci);
  } else {
    cudaError_t err = opt_in_once<mix_kernel<BT, VEC>>();
    if (err != cudaSuccess) return err;
    return launch_after_previous(mix_kernel<BT, VEC>, grid, dim3(kMixThreads), mix_smem(d, BT),
                                 st, xr, xi, w, film, film_mode, yr, yi, d.b, d.ci, d.co, d.K,
                                 d.m2);
  }
}

template <int M2, int V, bool ADJ>
int run_dft(const float* x, const float* c2, const float* s2, const float* c1,
            const float* s1, const float* ic2, const float* is2, const float* ic1,
            const float* is1, const float* w, const float* film, int film_mode, float* xr,
            float* xi, float* yr, float* yi, float* out, const Dims& d, bool w_vec,
            cudaStream_t st) {
  cudaError_t err = opt_in_once<dft_fwd_kernel<M2, V>>();
  if (err == cudaSuccess) err = opt_in_once<dft_inv_kernel<M2, V>>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t fs = fwd_smem(d, M2, V);
  const int fwd_grid = resident_grid(dft_fwd_kernel<M2, V>, kFwdThreads, fs, d.b * d.ci);
  dft_fwd_kernel<M2, V><<<fwd_grid, kFwdThreads, fs, st>>>(
      x, c2, s2, c1, s1, xr, xi, d.b, d.ci, d.n1, d.n2, d.K, d.m2);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int bt = d.b > 4 ? 8 : d.b > 2 ? 4 : d.b;  // register tile in samples
#define NPS_MIX(BT, VEC) \
  err = launch_mix<ADJ, BT, VEC>(d, w, film, film_mode, xr, xi, yr, yi, st)
  switch (bt * 2 + (w_vec ? 1 : 0)) {
    case 2: NPS_MIX(1, false); break;
    case 3: NPS_MIX(1, true); break;
    case 4: NPS_MIX(2, false); break;
    case 5: NPS_MIX(2, true); break;
    case 8: NPS_MIX(4, false); break;
    case 9: NPS_MIX(4, true); break;
    case 16: NPS_MIX(8, false); break;
    default: NPS_MIX(8, true); break;
  }
#undef NPS_MIX
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t is = inv_smem(d, M2);
  const int inv_grid = resident_grid(dft_inv_kernel<M2, V>, kThreads, is, d.b * d.co);
  return static_cast<int>(launch_after_previous(
      dft_inv_kernel<M2, V>, dim3(inv_grid), dim3(kThreads), is, st, yr, yi, ic2, is2, ic1, is1,
      out, d.b, d.co, d.n1, d.n2, d.K, d.m2,
      1.0f / (static_cast<float>(d.n1) * static_cast<float>(d.n2))));
}

// the three stages at the unrolled m2 bound and row width that fit; d.ci and
// d.co are the input's and the output's channels; w_co: the pack's last dim
template <bool ADJ>
int dispatch_dft(const float* x, const float* w_packed, const float* film, int film_mode,
                 const float* c2, const float* s2, const float* c1, const float* s1,
                 const float* ic2, const float* is2, const float* ic1, const float* is1,
                 float* xr, float* xi, float* yr, float* yi, float* out, const Dims& d,
                 int w_co, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte rows need n2 % 4 == 0 and aligned planes (the wrapper passes
  // fresh contiguous tensors)
  const bool v4 = d.n2 % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const bool w_vec = w_co % 4 == 0 && (reinterpret_cast<uintptr_t>(w_packed) & 15) == 0;
#define NPS_DFT(M2, V)                                                                 \
  return run_dft<M2, V, ADJ>(x, c2, s2, c1, s1, ic2, is2, ic1, is1, w_packed, film,    \
                             film_mode, xr, xi, yr, yi, out, d, w_vec, st)
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

}  // namespace

extern "C" int spectral_dft2d_fwd(
    const float* x, const float* w_packed, const float* film, int film_mode,
    const float* c2, const float* s2, const float* c1, const float* s1,
    const float* ic2, const float* is2, const float* ic1, const float* is1,
    float* xr, float* xi, float* yr, float* yi, float* out, int b, int ci,
    int co, int n1, int n2, int m1, int m2, void* stream) {
  return dispatch_dft<false>(x, w_packed, film, film_mode, c2, s2, c1, s1, ic2, is2, ic1, is1,
                             xr, xi, yr, yi, out, Dims{b, ci, co, n1, n2, 2 * m1, m2}, co,
                             stream);
}

// The input gradient: dy [b, co, n1, n2] -> dx [b, ci, n1, n2] through the
// forward's pack [2*m1*m2, 2, ci, co] (ci, co are the forward's); gr, gi
// [modes, b, co] receive dy's spectrum G, hr, hi [modes, b, ci] the mix's.
extern "C" int spectral_dft2d_bwd(
    const float* dy, const float* w_packed,
    const float* c2, const float* s2, const float* c1, const float* s1,
    const float* ic2, const float* is2, const float* ic1, const float* is1,
    float* gr, float* gi, float* hr, float* hi, float* dx, int b, int ci,
    int co, int n1, int n2, int m1, int m2, void* stream) {
  return dispatch_dft<true>(dy, w_packed, nullptr, 1, c2, s2, c1, s1, ic2, is2, ic1, is1,
                            gr, gi, hr, hi, dx, Dims{b, co, ci, n1, n2, 2 * m1, m2}, co,
                            stream);
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
