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
size_t inv_smem(const Dims& d, int M2) {
  return sizeof(float) * 2 * (d.K * M2 + d.K * d.n1 + d.n1 * M2);
}

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

template <int M2, int V>
int run_dft(const float* x, const float* c2, const float* s2, const float* c1,
            const float* s1, const float* ic2, const float* is2, const float* ic1,
            const float* is1, const float* w, const float* film, int film_mode, float* xr,
            float* xi, float* yr, float* yi, float* out, const Dims& d, bool co_vec,
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
  const dim3 mix_grid(d.K * d.m2, (d.co + kCoTile - 1) / kCoTile);
  const size_t ms = mix_smem(d, bt);
#define NPS_MIX(BT, VEC)                                                            \
  do {                                                                              \
    if ((err = (opt_in_once<mix_kernel<BT, VEC>>())) != cudaSuccess)                    \
      return static_cast<int>(err);                                                 \
    err = launch_after_previous(mix_kernel<BT, VEC>, mix_grid, dim3(kMixThreads), ms, st, \
                                xr, xi, w, film, film_mode, yr, yi, d.b, d.ci, d.co, d.K,  \
                                d.m2);                                              \
  } while (0)
  switch (bt * 2 + (co_vec ? 1 : 0)) {
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

}  // namespace

extern "C" int spectral_dft2d_fwd(
    const float* x, const float* w_packed, const float* film, int film_mode,
    const float* c2, const float* s2, const float* c1, const float* s1,
    const float* ic2, const float* is2, const float* ic1, const float* is1,
    float* xr, float* xi, float* yr, float* yi, float* out, int b, int ci,
    int co, int n1, int n2, int m1, int m2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dims d{b, ci, co, n1, n2, 2 * m1, m2};
  // 16-byte rows need n2 % 4 == 0 and aligned planes (the wrapper passes
  // fresh contiguous tensors)
  const bool v4 = n2 % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const bool co_vec = co % 4 == 0 && (reinterpret_cast<uintptr_t>(w_packed) & 15) == 0;
#define NPS_DFT(M2, V)                                                                 \
  return run_dft<M2, V>(x, c2, s2, c1, s1, ic2, is2, ic1, is1, w_packed, film,         \
                        film_mode, xr, xi, yr, yi, out, d, co_vec, st)
  if (m2 <= 4) {
    if (v4) NPS_DFT(4, 4); else NPS_DFT(4, 1);
  } else if (m2 <= 8) {
    if (v4) NPS_DFT(8, 4); else NPS_DFT(8, 1);
  } else if (m2 <= 10) {
    if (v4) NPS_DFT(10, 4); else NPS_DFT(10, 1);
  } else {  // the wrapper keeps m2 <= 16
    if (v4) NPS_DFT(16, 4); else NPS_DFT(16, 1);
  }
#undef NPS_DFT
}
