// gn1_gelu_fwd: GroupNorm with one group, fused with the GELU that follows it.
//
// Replaces the TPU kernel K2, tools/pallas_group_norm_evidence.py:
// _fwd_kernel / _run_fwd (pl.pallas_call) behind group_norm_pallas. Same
// semantics: f32 sum and sum of squares over a whole sample, mean = s/n,
// var = max(q/n - mean^2, 0), inv = rsqrt(var + eps), y = (x - mean) * inv *
// gamma[c] + beta[c]; then, here, the activation that follows every such
// norm in a U-Net ResidualBlock: `act` 0 none, 1 the exact-erf GELU, 2 the
// tanh-approximate GELU (cfg_ns512_ufno's GELUTanh). (mean, inv) per sample
// are saved for the backward pass.
//
// Bound on the H100: memory bandwidth. Per element it does a few flops and
// one exp, far below the card's 67 TFLOP/s f32; the least traffic is one
// read of x and one write of y at 3.35 TB/s. The statistics need the whole
// sample before the first y can be written, and a sample of the main path
// (up to ~10.5 MB f32) is far larger than one SM's 227 KB of shared memory,
// so the Pallas design (one program holds a sample in VMEM) does not carry
// over, and a design that reads x once for the sums and once more to
// normalise can reach at most two thirds of the bound.
//
// Design: one persistent cooperative kernel that reads x from device memory
// once. The grid is as many CTAs as can be resident at once (occupancy x
// SMs: one 1024-thread CTA per SM with all of its shared memory), launched
// with cudaLaunchCooperativeKernel, so the grid-wide barrier never waits on
// a CTA that is not running. The work goes in rounds; each round takes as
// many samples (`spr`) as the grid's shared memory holds, and each sample of
// a round is cut into G = grid / spr contiguous slices, one per CTA (at the
// main path's [4, 388, 100, 68]: two rounds of two samples). In round r a
// CTA:
//   1. waits for its slice, copied into shared memory with 16-byte cp.async
//      copies (round 0 before the loop, round r during step 4 of round r-1);
//   2. folds an f32 (sum x, sum x^2) partial over it, publishes it to device
//      memory and meets every other CTA at grid.sync();
//   3. reduces its sample's G partials in a fixed order (every CTA of the
//      sample gets the same bits: the result is deterministic);
//   4. normalises, applies gamma/beta and the activation from shared memory
//      and stores y with 16-byte streaming stores; right after each store,
//      the thread copies the same 16 bytes of its slice of round r+1 into
//      the place just read, so the next round's reads stream while this
//      round's writes do. A thread only ever touches its own units of
//      shared memory, so this needs no barrier.
// grid.sync() resets its own barrier, so no state outlives a call. f32 uses
// 16-byte vectors when the sample length is a multiple of 4 (bf16: of 8);
// other lengths are copied and normalised as scalars. bf16 input keeps f32
// statistics and arithmetic and is rounded once on output. erf is the
// Abramowitz-Stegun 7.1.26 rational form (absolute error below 1.5e-7, about
// the rounding of f32 near 1) with the hardware exp: branch-free, where
// CUDA's erff takes one of two paths per lane, so a warp runs both. The tanh
// form is z * sigmoid(2u), u = sqrt(2/pi) (z + 0.044715 z^3), which equals
// 0.5 z (1 + tanh u) and takes one exp and one division (the exponent
// clamped at 80, where sigmoid is 0 to f32's range).
//
// The host side plans once per shape (gn1_gelu_plan): grid, samples per
// round, slice length, rounds; the wrapper raises on a sample larger than
// the grid's shared memory holds (about 29.8 MB f32 on an H100).
//
// Indices within a sample are 32-bit: the wrapper keeps C * hw below
// 2^31 - 2^20.
//
// Layout contract: x is NCHW (any number of spatial dims) and contiguous,
// hw = product of the spatial dims, n = C * hw per sample; gamma and beta
// are f32 [C]; y has x's shape and type; stats is f32 [b, 2]; partials is
// f32 [b, G, 2] scratch.
//
// gn1_gelu_bwd: the backward of the same op, f32 or bf16. The TPU side has no
// Pallas backward: its _gn_bwd (tools/pallas_group_norm_evidence.py:106-127)
// is one XLA fusion. With pre = xh * gamma + beta, xh = (x - mean) * inv,
// g = dy * act'(pre) (the erf form's Phi(z) + z phi(z) with one shared exp,
// or the tanh form's s + 2 z s (1 - s) u'(z), s = sigmoid(2u), one exp)
// and t = g * gamma:
//   dx     = inv * (t - mean_n(t) - xh * mean_n(t * xh))   per sample
//   dgamma = sum_{b, hw} g * xh,   dbeta = sum_{b, hw} g   per channel
// Bound on the H100: memory bandwidth, one read of x and dy and one write of
// dx (0.151 ms at [16, 388, 100, 68] f32). Design: two passes over x and dy,
// so 5 of the bound's 3 tensor passes (the two reads of the sums pass cannot
// stay in the 50 MB L2 at the main path's 338 MB):
//   1. gn1_bwd_sums: one CTA per (sample, channel) plane folds the plane's
//      sum g and sum g * xh, reduced inside the CTA in a fixed order, into
//      ws [b, C, 2]. Every per-sample and per-channel sum the gradient needs
//      is a sum of these, since gamma is constant over a plane;
//   2. gn1_bwd_reduce: one CTA per sample sums gamma[c] * ws over its
//      channels (mean_n(t), mean_n(t * xh) into coef [b, 2]); further CTAs
//      sum ws over the batch per channel into dgamma and dbeta;
//   3. gn1_bwd_apply: one CTA per plane recomputes g and writes dx with
//      streaming stores.
// bf16 x and dy (cfg_ns512_ufno's norms) are widened on load; g, xh, every
// sum, (mean, inv), dgamma and dbeta stay f32, summed in the f32 kernels'
// fixed order, and dx is rounded to bf16 once on store: half the bytes of
// the f32 backward, and the same bits on every call. Planes of a multiple
// of 4 elements load and store 4 elements at a time (16 bytes f32, 8 bf16).
// No atomics: every sum runs in the same order on every call, so
// the result is deterministic.

// gn1_gelu_fwd_stream: the same forward for a sample larger than the
// resident grid's shared memory holds (about 29.8 MB f32 on an H100; a
// top-level U-Net norm of cfg_ns512_ufno is 260 x 516^2 values, 138 MB per
// sample in bf16). The persistent kernel's one read is not possible there,
// so it streams x twice: the ceiling is 2/3 of the one-read bound. Three
// launches, no atomics, so two calls give the same bits:
//   1. gn1_stream_sums: CTAs take fixed chunks of each sample (`chunk`
//      elements, 16-byte loads where the sample allows) and write f32
//      (sum x, sum x^2) partials [b, chunks], each reduced inside its CTA in
//      a fixed order;
//   2. gn1_stream_stats: one CTA per sample sums its partials in a fixed
//      order into (mean, inv) with the same variance clamp;
//   3. gn1_stream_apply: reads x again, normalises, applies gamma/beta and
//      the activation, and writes y in x's type with streaming stores.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of T as floats, and back (the store is a streaming one).
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};
__device__ __forceinline__ void unpack16(uint4 a, float* v, float) {
  v[0] = __uint_as_float(a.x);
  v[1] = __uint_as_float(a.y);
  v[2] = __uint_as_float(a.z);
  v[3] = __uint_as_float(a.w);
}
__device__ __forceinline__ void unpack16(uint4 a, float* v, __nv_bfloat16) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h);
    v[2 * i + 1] = __high2float(h);
  }
}
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* v) {
  unpack16(*reinterpret_cast<const uint4*>(p), v, T());
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 a;
  uint32_t* w = reinterpret_cast<uint32_t*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  __stcs(reinterpret_cast<uint4*>(p), a);
}

// GELU with erf (not the tanh approximation); see the note at the top
__device__ __forceinline__ float gelu_erf(float v) {
  const float z = v * 0.70710678118654752f;
  const float t = __fdividef(1.0f, fmaf(0.3275911f, fabsf(z), 1.0f));
  const float p = t * fmaf(fmaf(fmaf(fmaf(1.061405429f, t, -1.453152027f), t,
                                     1.421413741f), t, -0.284496736f), t,
                           0.254829592f);
  const float q = p * __expf(-z * z);
  return 0.5f * v * (z >= 0.f ? 2.0f - q : q);
}

// GELU with tanh, 0.5 v (1 + tanh u), u = sqrt(2/pi) (v + 0.044715 v^3), as
// v * sigmoid(2u): one exp and one division (see the note at the top)
__device__ __forceinline__ float gelu_tanh(float v) {
  const float u2 = 1.5957691216057308f * fmaf(0.044715f * v, v * v, v);
  return __fdividef(v, 1.0f + __expf(fminf(-u2, 80.0f)));
}

// act: 0 none, 1 GELU with erf, 2 GELU with tanh
__device__ __forceinline__ float activate(float v, int act) {
  return act == 1 ? gelu_erf(v) : act == 2 ? gelu_tanh(v) : v;
}

// e / hw for 0 <= e < 2^31 without an integer division: a float estimate,
// corrected to the exact quotient.
__device__ __forceinline__ int div_hw(int e, int hw, float inv_hw) {
  int q = static_cast<int>(static_cast<float>(e) * inv_hw);
  while (q * hw > e) --q;
  while ((q + 1) * hw <= e) ++q;
  return q;
}

// Sum two values over the block; the result is valid in every thread.
// Every thread of the block must call it.
__device__ __forceinline__ float2 block_sum2(float2 v) {
  __shared__ float2 warp_part[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  if (warp == 0) {
    if (lane < kWarps) t = warp_part[lane];
    for (int off = 16; off > 0; off >>= 1) {
      t.x += __shfl_xor_sync(0xffffffffu, t.x, off);
      t.y += __shfl_xor_sync(0xffffffffu, t.y, off);
    }
    if (lane == 0) warp_part[0] = t;
  }
  __syncthreads();
  t = warp_part[0];
  __syncthreads();  // warp_part is reused by the next call
  return t;
}

struct Args {
  const void* x;
  const float* gamma;
  const float* beta;
  void* y;
  float* stats;
  float2* partials;
  int b, n, hw;
  float eps;
  int act;  // 0 none, 1 GELU (erf), 2 GELU (tanh)
  int spr, G, per, rounds, vec;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) gn1_gelu_kernel(Args a) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf = reinterpret_cast<T*>(smem_raw);
  const T* __restrict__ x = static_cast<const T*>(a.x);
  T* __restrict__ y = static_cast<T*>(a.y);
  cg::grid_group grid = cg::this_grid();

  const int slot = blockIdx.x / a.G, part = blockIdx.x % a.G;
  const bool active = slot < a.spr;
  const int lo = part * a.per;
  const int len = active ? max(0, min(a.n, lo + a.per) - lo) : 0;
  const int nv = a.vec ? len / V : len;  // units: 16-byte vectors or elements
  const float inv_hw = 1.0f / static_cast<float>(a.hw);
  const float inv_n = 1.0f / static_cast<float>(a.n);
  // this CTA's slice of round r, or null past the last round or sample
  auto slice = [&](int r) -> const T* {
    const int s = r * a.spr + slot;
    return r < a.rounds && s < a.b && len > 0 ? x + static_cast<int64_t>(s) * a.n + lo
                                               : nullptr;
  };
  // unit i of a slice into shared memory; a thread only ever touches the
  // units i = threadIdx.x + k * kThreads, so it needs no barrier but its own
  // cp.async wait
  auto fetch = [&](const T* src, int i) {
    if (a.vec)
      nps::cp_async16(buf + i * V, src + i * V);
    else
      buf[i] = src[i];
  };
  auto fold = [&](const float* v, int m, float2& acc) {
    for (int k = 0; k < m; ++k) {
      acc.x += v[k];
      acc.y = fmaf(v[k], v[k], acc.y);
    }
  };

  if (const T* src = slice(0))
    for (int i = threadIdx.x; i < nv; i += kThreads) fetch(src, i);
  nps::cp_async_commit();
  for (int r = 0; r < a.rounds; ++r) {
    const int s = r * a.spr + slot;
    const bool live = active && s < a.b;  // len may be 0: it still publishes
    float2 acc = make_float2(0.f, 0.f);
    nps::cp_async_wait_all();
    if (live) {
      for (int i = threadIdx.x; i < nv; i += kThreads) {
        float v[V];
        if (a.vec) {
          load16(buf + i * V, v);
          fold(v, V, acc);
        } else {
          v[0] = to_f(buf[i]);
          fold(v, 1, acc);
        }
      }
    }
    const float2 mine = block_sum2(acc);
    if (live && threadIdx.x == 0) a.partials[static_cast<int64_t>(s) * a.G + part] = mine;
    grid.sync();
    if (!live) continue;

    // the sample's partials, summed in the same order by each of its CTAs
    float2 tot = make_float2(0.f, 0.f);
    for (int j = threadIdx.x; j < a.G; j += kThreads) {
      const float2 p = __ldcg(a.partials + static_cast<int64_t>(s) * a.G + j);
      tot.x += p.x;
      tot.y += p.y;
    }
    tot = block_sum2(tot);
    const float mean = tot.x * inv_n;
    const float var = fmaxf(tot.y * inv_n - mean * mean, 0.0f);
    const float inv = rsqrtf(var + a.eps);
    if (part == 0 && threadIdx.x == 0) {
      a.stats[2 * s] = mean;
      a.stats[2 * s + 1] = inv;
    }

    // normalise; once a unit is stored, its shared memory takes the same
    // unit of round r + 1
    const T* next = slice(r + 1);
    T* ys = y + static_cast<int64_t>(s) * a.n + lo;
    // the channel of the thread's current unit and the offset in it, carried
    // from unit to unit (a step is kThreads * V elements)
    const int nch = a.n / a.hw;  // past the last channel only after the last unit
    int c = div_hw(lo + threadIdx.x * V, a.hw, inv_hw);
    int rem = lo + threadIdx.x * V - c * a.hw;
    float g = 0.f, bb = 0.f;
    if (c < nch) {
      g = __ldg(a.gamma + c) * inv;
      bb = __ldg(a.beta + c);
    }
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      if (a.vec) {
        float v[V];
        load16(buf + i * V, v);
        if (rem + V <= a.hw) {  // the vector lies in one channel
#pragma unroll
          for (int k = 0; k < V; ++k) v[k] = fmaf(v[k] - mean, g, bb);
        } else {  // it crosses into the next channel(s)
          int ck = c, rk = rem;
          float gk = g, bk = bb;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            if (rk == a.hw) {
              rk = 0;
              ++ck;
              gk = __ldg(a.gamma + ck) * inv;
              bk = __ldg(a.beta + ck);
            }
            v[k] = fmaf(v[k] - mean, gk, bk);
            ++rk;
          }
        }
        rem += kThreads * V;
        if (rem >= a.hw) {
          const int q = div_hw(rem, a.hw, inv_hw);
          c += q;
          rem -= q * a.hw;
          if (c < nch) {
            g = __ldg(a.gamma + c) * inv;
            bb = __ldg(a.beta + c);
          }
        }
        if (a.act) {
#pragma unroll
          for (int k = 0; k < V; ++k) v[k] = activate(v[k], a.act);
        }
        store16(ys + i * V, v);
      } else {
        const int c = div_hw(lo + i, a.hw, inv_hw);
        const float t = fmaf(to_f(buf[i]) - mean, __ldg(a.gamma + c) * inv, __ldg(a.beta + c));
        put(ys + i, activate(t, a.act));
      }
      // the store above used the unit's value, so its read of shared memory
      // is complete before the copy below overwrites it
      if (next) fetch(next, i);
    }
    nps::cp_async_commit();
  }
}

// Per element type: the shared memory a CTA gets, and the grid that fits.
struct Config {
  int smem = 0, grid = 0;
  cudaError_t err = cudaSuccess;
};

template <typename T>
const Config& config() {
  static Config cfg = [] {
    Config c;
    c.err = nps::allow_max_smem(gn1_gelu_kernel<T>);
    int dev = 0, optin = 0, sms = 0, occ = 0;
    cudaFuncAttributes attr;
    if (c.err == cudaSuccess) c.err = cudaGetDevice(&dev);
    if (c.err == cudaSuccess)
      c.err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (c.err == cudaSuccess)
      c.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (c.err == cudaSuccess) c.err = cudaFuncGetAttributes(&attr, gn1_gelu_kernel<T>);
    if (c.err != cudaSuccess) return c;
    c.smem = (optin - static_cast<int>(attr.sharedSizeBytes)) / 16 * 16;
    c.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, gn1_gelu_kernel<T>,
                                                           kThreads, c.smem);
    c.grid = occ * sms;
    return c;
  }();
  return cfg;
}

template <typename T>
int plan(int b, long long n, int* out) {
  constexpr int V = Vec16<T>::N;
  const Config& cfg = config<T>();
  if (cfg.err != cudaSuccess) return static_cast<int>(cfg.err);
  for (int i = 0; i < 6; ++i) out[i] = 0;
  if (cfg.grid < 1) return 0;
  const long long full = cfg.smem / static_cast<int>(sizeof(T));
  const int vec = n % V == 0;
  const int align = vec ? V : 1;
  auto slice = [&](int spr) {
    const long long G = cfg.grid / spr;
    return ((n + G - 1) / G + align - 1) / align * align;
  };
  // the most samples per round whose slices fit shared memory
  int spr = min(b, cfg.grid);
  while (spr >= 1 && slice(spr) > full) --spr;
  if (spr < 1) return 0;  // out[0] == 0: the sample does not fit
  // as few rounds as fit, with the samples spread evenly over them
  const int rounds = (b + spr - 1) / spr;
  spr = (b + rounds - 1) / rounds;
  out[0] = cfg.grid;
  out[1] = spr;
  out[2] = cfg.grid / spr;
  out[3] = static_cast<int>(slice(spr));
  out[4] = rounds;
  out[5] = vec;
  return 0;
}

template <typename T>
int launch(Args a, int grid, cudaStream_t stream) {
  const Config& cfg = config<T>();
  if (cfg.err != cudaSuccess) return static_cast<int>(cfg.err);
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(gn1_gelu_kernel<T>), dim3(grid), dim3(kThreads), params,
      static_cast<size_t>(cfg.smem), stream));
}

// ---- backward ----------------------------------------------------------------
constexpr int kBwdThreads = 256;

// d/dz of the exact-erf GELU: Phi(z) + z phi(z), erf as in gelu_erf; the
// exp(-z^2/2) of phi is the exp the erf form already takes
__device__ __forceinline__ float gelu_erf_grad(float v) {
  const float z = v * 0.70710678118654752f;
  const float t = __fdividef(1.0f, fmaf(0.3275911f, fabsf(z), 1.0f));
  const float p = t * fmaf(fmaf(fmaf(fmaf(1.061405429f, t, -1.453152027f), t,
                                     1.421413741f), t, -0.284496736f), t,
                           0.254829592f);
  const float e = __expf(-z * z);
  const float cdf = 0.5f * (z >= 0.f ? 2.0f - p * e : p * e);
  return fmaf(v * 0.39894228040143268f, e, cdf);
}

__device__ __forceinline__ float ex2_approx(float v) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}
__device__ __forceinline__ float rcp_approx(float v) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}

// d/dz of the tanh GELU z * s, s = sigmoid(2u): s + 2 z s (1 - s) u'(z),
// u'(z) = sqrt(2/pi) (1 + 3 * 0.044715 z^2); 1 - s is e * s (no
// cancellation), e = exp(-2u) = 2^(z (A0 + A1 z^2)) with the constants
// folded (the exponent clamped at 80 / ln 2, as gelu_tanh's), two of its
// instructions the hardware's ex2 and rcp
__device__ __forceinline__ float gelu_tanh_grad(float v) {
  const float v2 = v * v;
  const float e = ex2_approx(fminf(v * fmaf(-0.1029432395800235f, v2, -2.302208198144325f),
                                   115.41560327111708f));
  const float s = rcp_approx(1.0f + e);
  return fmaf(v * s * (e * s), fmaf(0.21406444881780076f, v2, 1.5957691216057308f), s);
}

// Sum two values over a kBwdThreads block, in a fixed order; valid in
// thread 0. Every thread of the block must call it.
__device__ __forceinline__ float2 bwd_block_sum2(float2 v) {
  constexpr int W = kBwdThreads / 32;
  __shared__ float2 part[W];
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  if (threadIdx.x == 0)
    for (int w = 0; w < W; ++w) {
      t.x += part[w].x;
      t.y += part[w].y;
    }
  return t;
}

struct BwdArgs {
  const void* x;       // f32 or bf16, as dy and dx
  const void* dy;
  const float* gamma;
  const float* beta;
  const float* stats;  // [b, 2] (mean, inv) from the forward
  float* ws;           // [b, C, 2] per-plane (sum g, sum g * xh)
  float* coef;         // [b, 2] (mean_n(t), mean_n(t * xh))
  void* dx;
  float* dgamma;
  float* dbeta;
  int b, c, hw, act;  // act as Args::act
  float inv_n;
};

// the plane's constants: mean, inv, gamma, beta
struct Plane {
  int64_t off;
  int s, ch;
  float mean, inv, g, bb;
};
__device__ __forceinline__ Plane plane_of(const BwdArgs& a) {
  Plane p;
  p.s = blockIdx.x / a.c;
  p.ch = blockIdx.x % a.c;
  p.off = static_cast<int64_t>(blockIdx.x) * a.hw;
  p.mean = __ldg(a.stats + 2 * p.s);
  p.inv = __ldg(a.stats + 2 * p.s + 1);
  p.g = __ldg(a.gamma + p.ch);
  p.bb = __ldg(a.beta + p.ch);
  return p;
}

// g and xh of one element
__device__ __forceinline__ void grad_in(const BwdArgs& a, const Plane& p, float xv, float dyv,
                                        float& g, float& xh) {
  xh = (xv - p.mean) * p.inv;
  const float z = fmaf(xh, p.g, p.bb);
  g = a.act == 1 ? dyv * gelu_erf_grad(z) : a.act == 2 ? dyv * gelu_tanh_grad(z) : dyv;
}

// VEC: hw % 4 == 0 and x, dy, dx aligned to 4 elements
template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdThreads) gn1_bwd_sums(BwdArgs a) {
  const Plane p = plane_of(a);
  const T* x = static_cast<const T*>(a.x) + p.off;
  const T* dy = static_cast<const T*>(a.dy) + p.off;
  float2 acc = make_float2(0.f, 0.f);
  auto fold = [&](float xv, float dyv) {
    float g, xh;
    grad_in(a, p, xv, dyv, g, xh);
    acc.x += g;
    acc.y = fmaf(g, xh, acc.y);
  };
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < a.hw / 4; i += kBwdThreads) {
      float xv[4], dv[4];
      nps::load4(x + 4 * i, xv);
      nps::load4(dy + 4 * i, dv);
#pragma unroll
      for (int k = 0; k < 4; ++k) fold(xv[k], dv[k]);
    }
  } else {
    for (int i = threadIdx.x; i < a.hw; i += kBwdThreads) fold(to_f(x[i]), to_f(dy[i]));
  }
  acc = bwd_block_sum2(acc);
  if (threadIdx.x == 0) reinterpret_cast<float2*>(a.ws)[blockIdx.x] = acc;
}

// CTAs [0, b): per-sample coefficients; CTAs [b, ...): per-channel dgamma,
// dbeta, one channel per thread, summed over the batch in order
__global__ void __launch_bounds__(kBwdThreads) gn1_bwd_reduce(BwdArgs a) {
  const float2* ws = reinterpret_cast<const float2*>(a.ws);
  if (blockIdx.x < static_cast<unsigned>(a.b)) {
    const int s = blockIdx.x;
    float2 acc = make_float2(0.f, 0.f);
    for (int ch = threadIdx.x; ch < a.c; ch += kBwdThreads) {
      const float2 v = ws[static_cast<int64_t>(s) * a.c + ch];
      const float gm = __ldg(a.gamma + ch);
      acc.x = fmaf(gm, v.x, acc.x);
      acc.y = fmaf(gm, v.y, acc.y);
    }
    acc = bwd_block_sum2(acc);
    if (threadIdx.x == 0) {
      a.coef[2 * s] = acc.x * a.inv_n;
      a.coef[2 * s + 1] = acc.y * a.inv_n;
    }
    return;
  }
  const int ch = (blockIdx.x - a.b) * kBwdThreads + threadIdx.x;
  if (ch >= a.c) return;
  float sg = 0.f, sgx = 0.f;
  for (int s = 0; s < a.b; ++s) {
    const float2 v = ws[static_cast<int64_t>(s) * a.c + ch];
    sg += v.x;
    sgx += v.y;
  }
  a.dbeta[ch] = sg;
  a.dgamma[ch] = sgx;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdThreads) gn1_bwd_apply(BwdArgs a) {
  const Plane p = plane_of(a);
  const T* x = static_cast<const T*>(a.x) + p.off;
  const T* dy = static_cast<const T*>(a.dy) + p.off;
  T* dx = static_cast<T*>(a.dx) + p.off;
  const float ct = __ldg(a.coef + 2 * p.s), ctx = __ldg(a.coef + 2 * p.s + 1);
  auto dx_of = [&](float xv, float dyv) {
    float g, xh;
    grad_in(a, p, xv, dyv, g, xh);
    return p.inv * (fmaf(g, p.g, -ct) - xh * ctx);
  };
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < a.hw / 4; i += kBwdThreads) {
      float xv[4], dv[4], v[4];
      nps::load4(x + 4 * i, xv);
      nps::load4(dy + 4 * i, dv);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = dx_of(xv[k], dv[k]);
      nps::store4(dx + 4 * i, v);
    }
  } else {
    for (int i = threadIdx.x; i < a.hw; i += kBwdThreads)
      put(dx + i, dx_of(to_f(x[i]), to_f(dy[i])));
  }
}

// the backward's sums (gn1_bwd_sums, gn1_bwd_reduce: ws, coef, dgamma,
// dbeta), then its apply (gn1_bwd_apply: dx)
template <typename T, bool VEC>
int bwd_sums_stage(const BwdArgs& a, cudaStream_t st) {
  gn1_bwd_sums<T, VEC><<<a.b * a.c, kBwdThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn1_bwd_reduce<<<a.b + (a.c + kBwdThreads - 1) / kBwdThreads, kBwdThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
template <typename T, bool VEC>
int bwd_apply_stage(const BwdArgs& a, cudaStream_t st) {
  gn1_bwd_apply<T, VEC><<<a.b * a.c, kBwdThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
template <typename T, bool VEC>
int launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const int err = bwd_sums_stage<T, VEC>(a, st);
  return err ? err : bwd_apply_stage<T, VEC>(a, st);
}

// ---- streaming forward ----------------------------------------------------------
struct StreamArgs {
  const void* x;
  const float* gamma;
  const float* beta;
  void* y;
  float* stats;       // [b, 2] (mean, inv); with raw the sums (sum x, sum x^2)
  float2* partials;   // [b, chunks] (sum x, sum x^2)
  int n, hw, chunk, chunks, act;
  float eps;
  float inv_count;    // 1 / the sample's element count (its whole count when split)
  int raw;            // gn1_stream_stats writes the sums, not (mean, inv)
};

// the units (16-byte vectors, or single elements) of this CTA's chunk
template <typename T, bool VEC>
__device__ __forceinline__ void chunk_units(const StreamArgs& a, int& lo, int& hi) {
  constexpr int V = VEC ? Vec16<T>::N : 1;
  const int e0 = blockIdx.x * a.chunk;  // chunk % V == 0
  lo = e0 / V;
  hi = min(a.n, e0 + a.chunk) / V;      // VEC: n % V == 0
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdThreads) gn1_stream_sums(StreamArgs a) {
  const int s = blockIdx.y;
  const T* x = static_cast<const T*>(a.x) + static_cast<int64_t>(s) * a.n;
  int lo, hi;
  chunk_units<T, VEC>(a, lo, hi);
  float2 acc = make_float2(0.f, 0.f);
  for (int i = lo + threadIdx.x; i < hi; i += kBwdThreads) {
    if constexpr (VEC) {
      constexpr int V = Vec16<T>::N;
      float v[V];
      load16(x + static_cast<int64_t>(i) * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        acc.x += v[k];
        acc.y = fmaf(v[k], v[k], acc.y);
      }
    } else {
      const float v = to_f(x[i]);
      acc.x += v;
      acc.y = fmaf(v, v, acc.y);
    }
  }
  acc = bwd_block_sum2(acc);
  if (threadIdx.x == 0) a.partials[static_cast<int64_t>(s) * a.chunks + blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kBwdThreads) gn1_stream_stats(StreamArgs a) {
  const int s = blockIdx.x;
  float2 acc = make_float2(0.f, 0.f);
  for (int j = threadIdx.x; j < a.chunks; j += kBwdThreads) {
    const float2 p = a.partials[static_cast<int64_t>(s) * a.chunks + j];
    acc.x += p.x;
    acc.y += p.y;
  }
  acc = bwd_block_sum2(acc);
  if (threadIdx.x == 0 && a.raw) {
    a.stats[2 * s] = acc.x;
    a.stats[2 * s + 1] = acc.y;
  } else if (threadIdx.x == 0) {
    const float inv_n = a.inv_count;
    const float mean = acc.x * inv_n;
    const float var = fmaxf(acc.y * inv_n - mean * mean, 0.0f);
    a.stats[2 * s] = mean;
    a.stats[2 * s + 1] = rsqrtf(var + a.eps);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdThreads) gn1_stream_apply(StreamArgs a) {
  constexpr int V = VEC ? Vec16<T>::N : 1;
  const int s = blockIdx.y;
  const int64_t off = static_cast<int64_t>(s) * a.n;
  const T* x = static_cast<const T*>(a.x) + off;
  T* y = static_cast<T*>(a.y) + off;
  const float mean = __ldg(a.stats + 2 * s), inv = __ldg(a.stats + 2 * s + 1);
  const float inv_hw = 1.0f / static_cast<float>(a.hw);
  int lo, hi;
  chunk_units<T, VEC>(a, lo, hi);
  for (int i = lo + threadIdx.x; i < hi; i += kBwdThreads) {
    float v[V];
    if constexpr (VEC)
      load16(x + static_cast<int64_t>(i) * V, v);
    else
      v[0] = to_f(x[i]);
    // the unit's channel, stepped inside it where it crosses into the next
    int c = div_hw(i * V, a.hw, inv_hw);
    int r = i * V - c * a.hw;
    float g = __ldg(a.gamma + c) * inv, bb = __ldg(a.beta + c);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (r == a.hw) {
        r = 0;
        ++c;
        g = __ldg(a.gamma + c) * inv;
        bb = __ldg(a.beta + c);
      }
      const float t = fmaf(v[k] - mean, g, bb);
      v[k] = activate(t, a.act);
      ++r;
    }
    if constexpr (VEC)
      store16(y + static_cast<int64_t>(i) * V, v);
    else
      put(y + i, v[0]);
  }
}

// the streaming forward's stages: the chunks' partial sums and their sum per
// sample (into stats: (mean, inv), or with a.raw the sums), then the stats
// from `sums` [b] (the split forward's summed sums: one chunk a sample) and
// the normalisation
template <typename T, bool VEC>
int stream_sums_stage(const StreamArgs& a, int b, cudaStream_t st) {
  gn1_stream_sums<T, VEC><<<dim3(a.chunks, b), kBwdThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn1_stream_stats<<<b, kBwdThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
template <typename T, bool VEC>
int stream_apply_stage(const StreamArgs& a, int b, cudaStream_t st) {
  gn1_stream_apply<T, VEC><<<dim3(a.chunks, b), kBwdThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
template <typename T, bool VEC>
int split_apply_stage(const StreamArgs& a, const float* sums, int b, cudaStream_t st) {
  StreamArgs s = a;
  s.partials = reinterpret_cast<float2*>(const_cast<float*>(sums));
  s.chunks = 1;
  s.raw = 0;
  gn1_stream_stats<<<b, kBwdThreads, 0, st>>>(s);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? static_cast<int>(err) : stream_apply_stage<T, VEC>(a, b, st);
}
template <typename T, bool VEC>
int launch_stream(const StreamArgs& a, int b, cudaStream_t st) {
  const int err = stream_sums_stage<T, VEC>(a, b, st);
  return err ? err : stream_apply_stage<T, VEC>(a, b, st);
}

}  // namespace

// out = [grid, samples per round, CTAs per sample, slice length, rounds,
// vector path]; grid 0 means the shape does not fit. Returns a CUDA error.
extern "C" int gn1_gelu_plan(int b, long long n, int is_bf16, int* out) {
  return is_bf16 ? plan<__nv_bfloat16>(b, n, out) : plan<float>(b, n, out);
}

// act: 0 none, 1 GELU (erf), 2 GELU (tanh)
extern "C" int gn1_gelu_fwd(const void* x, const float* gamma, const float* beta, void* y,
                            float* stats, float* partials, int b, int c, long long hw,
                            float eps, int act, int is_bf16, int grid, int spr, int G, int per,
                            int rounds, int vec, void* stream) {
  Args a;
  a.x = x;
  a.gamma = gamma;
  a.beta = beta;
  a.y = y;
  a.stats = stats;
  a.partials = reinterpret_cast<float2*>(partials);
  a.b = b;
  a.n = static_cast<int>(c * hw);  // the wrapper keeps n below 2^31 - 2^20
  a.hw = static_cast<int>(hw);
  a.eps = eps;
  a.act = act;
  a.spr = spr;
  a.G = G;
  a.per = per;
  a.rounds = rounds;
  a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, grid, s) : launch<float>(a, grid, s);
}

// The backward, three kernels (see the note at the top): x, dy and dx f32 or
// (is_bf16) bf16; act as gn1_gelu_fwd's; vec: hw % 4 == 0 and x, dy, dx
// aligned to 4 elements. Returns the first CUDA error.
extern "C" int gn1_gelu_bwd(const void* x, const void* dy, const float* gamma, const float* beta,
                            const float* stats, float* ws, float* coef, void* dx, float* dgamma,
                            float* dbeta, int b, int c, long long hw, int act, int is_bf16,
                            int vec, void* stream) {
  BwdArgs a;
  a.x = x;
  a.dy = dy;
  a.gamma = gamma;
  a.beta = beta;
  a.stats = stats;
  a.ws = ws;
  a.coef = coef;
  a.dx = dx;
  a.dgamma = dgamma;
  a.dbeta = dbeta;
  a.b = b;
  a.c = c;
  a.hw = static_cast<int>(hw);  // the wrapper keeps c * hw below 2^31 - 2^20
  a.act = act;
  a.inv_n = 1.0f / static_cast<float>(static_cast<double>(c) * hw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? launch_bwd<__nv_bfloat16, true>(a, s) : launch_bwd<__nv_bfloat16, false>(a, s);
  return vec ? launch_bwd<float, true>(a, s) : launch_bwd<float, false>(a, s);
}

// The streaming forward (see the note at the top) for samples that do not
// fit the persistent grid: chunk elements per CTA (a multiple of 8), chunks
// = ceil(c * hw / chunk); partials f32 [b, chunks, 2] scratch; vec: the
// sample length a multiple of a 16-byte vector and x, y 16-byte aligned;
// act as gn1_gelu_fwd's.
extern "C" int gn1_gelu_fwd_stream(const void* x, const float* gamma, const float* beta,
                                   void* y, float* stats, float* partials, int b, int c,
                                   long long hw, float eps, int act, int is_bf16, int chunk,
                                   int chunks, int vec, void* stream) {
  StreamArgs a;
  a.x = x;
  a.gamma = gamma;
  a.beta = beta;
  a.y = y;
  a.stats = stats;
  a.partials = reinterpret_cast<float2*>(partials);
  a.n = static_cast<int>(c * hw);  // the wrapper keeps n below 2^31 - 2^20
  a.hw = static_cast<int>(hw);
  a.chunk = chunk;
  a.chunks = chunks;
  a.act = act;
  a.eps = eps;
  a.inv_count = 1.0f / static_cast<float>(a.n);
  a.raw = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? launch_stream<__nv_bfloat16, true>(a, b, st)
               : launch_stream<__nv_bfloat16, false>(a, b, st);
  return vec ? launch_stream<float, true>(a, b, st) : launch_stream<float, false>(a, b, st);
}

// ---- split samples (spatial parallelism) ----------------------------------------
// A sample split over the ranks of an x group (each holds some rows of every
// plane) is normalised by the whole sample's statistics. The forward and the
// backward each run as two launches with a sum over the x group between,
// which the caller makes (ops/group_norm.py): the streaming forward's stages
// (the persistent kernel has no point between its sums and its apply), and
// the backward's. `count` is the whole sample's element count C * rows * W.

// sums [b, 2] <- this rank's (sum x, sum x^2) of each sample, through
// partials [b, chunks, 2]; chunk, chunks, vec as gn1_gelu_fwd_stream's.
extern "C" int gn1_split_sums(const void* x, float* sums, float* partials, int b, int c,
                              long long hw, int is_bf16, int chunk, int chunks, int vec,
                              void* stream) {
  StreamArgs a{};
  a.x = x;
  a.stats = sums;
  a.partials = reinterpret_cast<float2*>(partials);
  a.n = static_cast<int>(c * hw);
  a.hw = static_cast<int>(hw);
  a.chunk = chunk;
  a.chunks = chunks;
  a.raw = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? stream_sums_stage<__nv_bfloat16, true>(a, b, st)
               : stream_sums_stage<__nv_bfloat16, false>(a, b, st);
  return vec ? stream_sums_stage<float, true>(a, b, st) : stream_sums_stage<float, false>(a, b, st);
}

// stats [b, 2] (mean, inv) from the x group's summed sums [b, 2] over count
// elements, then y = the normalised rows of this rank; the rest as
// gn1_gelu_fwd_stream's.
extern "C" int gn1_split_apply(const void* x, const float* gamma, const float* beta, void* y,
                               const float* sums, float* stats, int b, int c, long long hw,
                               double count, float eps, int act, int is_bf16, int chunk,
                               int chunks, int vec, void* stream) {
  StreamArgs a{};
  a.x = x;
  a.gamma = gamma;
  a.beta = beta;
  a.y = y;
  a.stats = stats;
  a.n = static_cast<int>(c * hw);
  a.hw = static_cast<int>(hw);
  a.chunk = chunk;
  a.chunks = chunks;
  a.act = act;
  a.eps = eps;
  a.inv_count = static_cast<float>(1.0 / count);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? split_apply_stage<__nv_bfloat16, true>(a, sums, b, st)
               : split_apply_stage<__nv_bfloat16, false>(a, sums, b, st);
  return vec ? split_apply_stage<float, true>(a, sums, b, st)
             : split_apply_stage<float, false>(a, sums, b, st);
}

// The backward's sums over this rank's rows: ws [b, c, 2], coef [b, 2] (this
// rank's share of the per-sample means, over the whole sample's count), and
// this rank's dgamma, dbeta; the rest as gn1_gelu_bwd's.
extern "C" int gn1_split_bwd_sums(const void* x, const void* dy, const float* gamma,
                                  const float* beta, const float* stats, float* ws, float* coef,
                                  float* dgamma, float* dbeta, int b, int c, long long hw,
                                  double count, int act, int is_bf16, int vec, void* stream) {
  BwdArgs a{};
  a.x = x;
  a.dy = dy;
  a.gamma = gamma;
  a.beta = beta;
  a.stats = stats;
  a.ws = ws;
  a.coef = coef;
  a.dgamma = dgamma;
  a.dbeta = dbeta;
  a.b = b;
  a.c = c;
  a.hw = static_cast<int>(hw);
  a.act = act;
  a.inv_n = static_cast<float>(1.0 / count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? bwd_sums_stage<__nv_bfloat16, true>(a, s) : bwd_sums_stage<__nv_bfloat16, false>(a, s);
  return vec ? bwd_sums_stage<float, true>(a, s) : bwd_sums_stage<float, false>(a, s);
}

// dx of this rank's rows from the x group's summed coef [b, 2].
extern "C" int gn1_split_bwd_apply(const void* x, const void* dy, const float* gamma,
                                   const float* beta, const float* stats, const float* coef,
                                   void* dx, int b, int c, long long hw, int act, int is_bf16,
                                   int vec, void* stream) {
  BwdArgs a{};
  a.x = x;
  a.dy = dy;
  a.gamma = gamma;
  a.beta = beta;
  a.stats = stats;
  a.coef = const_cast<float*>(coef);
  a.dx = dx;
  a.b = b;
  a.c = c;
  a.hw = static_cast<int>(hw);
  a.act = act;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? bwd_apply_stage<__nv_bfloat16, true>(a, s)
               : bwd_apply_stage<__nv_bfloat16, false>(a, s);
  return vec ? bwd_apply_stage<float, true>(a, s) : bwd_apply_stage<float, false>(a, s);
}
