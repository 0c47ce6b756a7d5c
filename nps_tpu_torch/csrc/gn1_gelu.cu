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
// gn1_gelu_bwd: the backward of the same op, f32 or bf16: one launch of
// gn1_bwd_ticket (see the note at the head of the backward section below).

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
// gn1_gelu_bwd replaces the TPU side's _gn_bwd (tools/pallas_group_norm_evidence.py
// :106-127), which has no Pallas kernel: it is one XLA fusion. With
// pre = xh * gamma + beta, xh = (x - mean) * inv, g = dy * act'(pre) (the erf
// form's Phi(z) + z phi(z) with one shared exp, or the tanh form's
// s + 2 z s (1 - s) u'(z), s = sigmoid(2u), one exp) and t = g * gamma:
//   dx     = inv * (t - mean_n(t) - xh * mean_n(t * xh))   per sample
//   dgamma = sum_{b, hw} g * xh,   dbeta = sum_{b, hw} g   per channel
// Every sum is f32, in a fixed order, so two calls give the same bits.
//
// Bound on the H100: memory bandwidth, x and dy read once and dx written once
// at 3.35 TB/s (0.1512 ms at [16, 388, 100, 68] f32, 1.031 ms at
// [8, 260, 526, 526] bf16). dx needs its sample's two means, which need the
// whole sample, so x and dy are read twice: once for the sums and once for
// dx. The design lets the second read come from the 50 MB L2.
//
// Two routes, by the bytes of a sample's x and dy (ops/group_norm.py:
// gn_bwd_route), each measured on the H100 80GB HBM3 at 700 W at every input
// the twophase and ns512 train steps give it (python gn_bwd_ab.py --routes):
//   - under BWD_THREE_BELOW (7 MiB): three kernels, one CTA a plane
//     (gn1_bwd_sums, gn1_bwd_reduce, gn1_bwd_apply; launch_bwd_three). The
//     ticket kernel loses at 23 of the 29 inputs there (46 KB to 6.3 MB),
//     by up to 75%: 0.0194 against 0.0111 ms at [16, 256, 9, 5] f32, where
//     small planes are latency bound and want many short CTAs; it wins 6 by
//     at most 0.006 ms ([16, 68, 96, 64]: 0.0518 against 0.0578);
//   - from 7 MiB (every ns512 input, 8 MB and up, and the twophase inputs of
//     8.9 MB and up): gn1_bwd_ticket, faster at 18 of the 20 inputs there:
//     0.2743 against 0.2946 ms at [16, 388, 100, 68] f32, 0.0665 against
//     0.0808 at [8, 128, 125, 125] bf16, 2.021 against 2.219 at
//     [8, 260, 526, 526] bf16; slower by 0.0002 and 0.016 ms at the bf16
//     [8, 128, 258, 258] and [8, 132, 512, 512], whose planes take 4-element
//     loads on the three kernels.
//
// gn1_bwd_ticket, one launch (after a memset of its counters on the same
// stream, so a call can be captured into a CUDA graph), one item a CTA. The
// plan is Python's (ops/group_norm.py:gn_bwd_plan, gn_bwd_tickets), so the
// CPU tests check the plan that drives the kernel:
//   - each sample is cut into `items` items of `per` whole planes, sized by
//     bytes (64 KB of x and dy: one twophase, 125^2 or 526^2 plane an item;
//     planes of up to 2048 elements a warp each, 8 or more an item);
//   - the work list holds sample 0's sums items, then for each sample s the
//     sums of sample s + 1 and s's apply items in the reverse order of its
//     sums, so the planes read last are read again first, and an apply finds
//     its sample's sums done while the next sample's run;
//   - a CTA's first act is an atomicAdd on the ticket counter, which names
//     its item. Tickets go out in order to CTAs that are running, so an item
//     waits only on items with lower tickets, running or done: no deadlock at
//     any occupancy, no cooperative launch, no persistent loop;
//   - a sums item folds f32 (sum g, sum g * xh) per plane into ws [b, C]
//     (the CTA per plane; for small planes a warp each) and adds one to its
//     sample's done count with release semantics;
//   - an apply item waits (acquire, __nanosleep back-off) for its sample's
//     count; the first to get there claims the sample and builds coef[s]
//     from ws[s, :] in channel order, the others wait for it to be published;
//     the sample published last also sums dgamma and dbeta over the samples
//     in order. Then it recomputes g and writes dx with streaming stores.
// Loads are 16 bytes (8 bf16 or 4 f32 elements), two units of x and two of
// dy in flight a thread. Where a sample's x and dy fit L2 (the plan's hint)
// they go under an L2 policy (createpolicy): evict_last for the sums' reads,
// evict_first for the apply's; elsewhere under evict_normal. Measured as
// above, hints on against off: 0.2743 against 0.2899 ms at
// [16, 388, 100, 68] f32, 0.0665 against 0.0691 at [8, 128, 125, 125]; at
// [8, 260, 526, 526], whose 288 MB sample does not fit, off against on:
// 2.021 against 2.075. The elements of a plane before its first 16-byte unit
// and after its last go one by one, so any plane length takes the vector
// path; tensors that are not 16-byte aligned (a view) take single-element
// loads throughout. 64 registers, 4 CTAs an SM.
//
// Where a sample's x and dy fit L2 (twophase: 21.1 MB f32) the floor is the
// one-read bound. A 526^2 ns512 sample is 288 MB: only the tail of its sums
// that L2 still holds (the planes read last, read again first) is not read
// twice, so its floor is two reads less about 50 MB a sample.
//
// An earlier design, a persistent cooperative kernel with grid-wide barriers
// and shared-memory rounds, was slower than three plain launches (f32 0.366
// against 0.285 ms) and was taken out. This one has no grid barrier and no
// cooperative launch: ordinary CTAs take tickets, L2 holds the data between
// the two reads, and the only wait is an apply item's on its own sample's
// sums.
//
// The split entries (gn1_split_bwd_*) keep two stages with the x group's
// sum between them: gn1_bwd_split_sums (+ gn1_bwd_reduce) and
// gn1_bwd_split_apply, one CTA a plane, with the ticket kernel's per-plane
// bodies and 16-byte loads under the L2 hints.
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxPer = 32;       // planes an item may hold (the plan keeps to it)
constexpr int kTicketBlocks = 4;  // gn1_bwd_ticket's CTAs an SM: 64 registers a thread
constexpr int kUnits = 2;         // 16-byte units of x and of dy a thread has in flight

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

// Sum two values over a warp (the same butterfly in every lane, so every lane
// holds the same bits)
__device__ __forceinline__ float2 warp_sum2(float2 v) {
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  return v;
}

// Sum two values over a kBwdThreads block, in a fixed order; valid in
// thread 0. Every thread of the block must call it.
__device__ __forceinline__ float2 bwd_block_sum2(float2 v) {
  __shared__ float2 part[kBwdWarps];
  v = warp_sum2(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  if (threadIdx.x == 0)
    for (int w = 0; w < kBwdWarps; ++w) {
      t.x += part[w].x;
      t.y += part[w].y;
    }
  return t;
}

// The L2 policy of a pass's loads (sm_80 and later): with `hint`, evict_last
// for the sums' (read again soon) and evict_first for the apply's (read for
// the last time); without, evict_normal (a plain load)
__device__ __forceinline__ uint64_t l2_policy(int hint, bool sums) {
  uint64_t p;
  if (!hint)
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n" : "=l"(p));
  else if (sums)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// 16 bytes under the L2 policy `pol`, kept packed until each element is used
// (fewer registers than unpacking the units in flight)
__device__ __forceinline__ uint4 load16_hint(const void* p, uint64_t pol) {
  uint4 a;
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(a.x), "=r"(a.y), "=r"(a.z), "=r"(a.w)
               : "l"(p), "l"(pol));
  return a;
}
// element k (a constant once unrolled) of a packed unit as a float
__device__ __forceinline__ uint32_t word(uint4 a, int w) {
  return w == 0 ? a.x : w == 1 ? a.y : w == 2 ? a.z : a.w;
}
__device__ __forceinline__ float elem(uint4 a, int k, float) {
  return __uint_as_float(word(a, k));
}
__device__ __forceinline__ float elem(uint4 a, int k, __nv_bfloat16) {
  const uint32_t w = word(a, k >> 1);  // bf16 is the top half of its f32
  return __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
}

// Release and acquire at device scope, for a sample's flag
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
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
  int b, c, hw, act;   // act as Args::act
  float inv_n;
  int hint;            // the loads' L2 policies (l2_policy)
  // gn1_bwd_ticket's plan (ops/group_norm.py:gn_bwd_plan) and state
  int per, items, warp;
  int* ctr;  // [2 + 2b], zero at launch: the ticket, samples whose coef is
             // published; then per sample its sums items done and its coef's
             // state (0 none, 1 being built, 2 published)
};
__device__ __forceinline__ int* done_of(const BwdArgs& a, int s) { return a.ctr + 2 + s; }
__device__ __forceinline__ int* state_of(const BwdArgs& a, int s) { return a.ctr + 2 + a.b + s; }

// the plane's constants: mean, inv, gamma, beta
struct Plane {
  float mean, inv, g, bb;
};
__device__ __forceinline__ Plane plane_of(const BwdArgs& a, int s, int ch) {
  return {__ldg(a.stats + 2 * s), __ldg(a.stats + 2 * s + 1), __ldg(a.gamma + ch),
          __ldg(a.beta + ch)};
}

// g and xh of one element
__device__ __forceinline__ void grad_in(const BwdArgs& a, const Plane& p, float xv, float dyv,
                                        float& g, float& xh) {
  xh = (xv - p.mean) * p.inv;
  const float z = fmaf(xh, p.g, p.bb);
  g = a.act == 1 ? dyv * gelu_erf_grad(z) : a.act == 2 ? dyv * gelu_tanh_grad(z) : dyv;
}

// Visit elements [e0, e0 + hw) of x and dy (a plane) as thread `id` of `n` (a
// CTA, or a warp): VEC (the tensors 16-byte aligned): the 16-byte units inside
// the plane go to the threads in turn, kUnits units of x and of dy loaded
// before any is used, as unit(e, x unit, dy unit); the elements before the
// first unit and after the last (fewer than 8 each) go to threads 0-7 and
// 8-15 as one(e, xv, dv). Otherwise every element goes to one(), in turn. The
// assignment is fixed, so per-thread sums run in the same order on every
// call.
template <typename T, bool VEC, typename FU, typename F1>
__device__ __forceinline__ void visit_plane(const T* __restrict__ x, const T* __restrict__ dy,
                                            int64_t e0, int hw, int id, int n, uint64_t pol,
                                            FU&& unit, F1&& one) {
  const int64_t end = e0 + hw;
  if constexpr (!VEC) {
    for (int i = id; i < hw; i += n) one(e0 + i, to_f(x[e0 + i]), to_f(dy[e0 + i]));
  } else {
    constexpr int V = Vec16<T>::N;
    int64_t a0 = (e0 + V - 1) / V * V, a1 = end / V * V;
    if (a1 < a0) a0 = a1 = end;  // no whole unit: all elements one by one
    const int nv = static_cast<int>((a1 - a0) / V);
    for (int i = id; i < nv; i += kUnits * n) {
      uint4 xu[kUnits], du[kUnits];
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        if (i + j * n < nv) {
          const int64_t u = a0 + static_cast<int64_t>(i + j * n) * V;
          xu[j] = load16_hint(x + u, pol);
          du[j] = load16_hint(dy + u, pol);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnits; ++j)
        if (i + j * n < nv) unit(a0 + static_cast<int64_t>(i + j * n) * V, xu[j], du[j]);
    }
    const int head = static_cast<int>(a0 - e0), tail = static_cast<int>(end - a1);
    if (id < head) one(e0 + id, to_f(x[e0 + id]), to_f(dy[e0 + id]));
    if (id >= 8 && id - 8 < tail) one(a1 + id - 8, to_f(x[a1 + id - 8]), to_f(dy[a1 + id - 8]));
  }
}

// This thread's share of plane (s, ch)'s (sum g, sum g * xh)
template <typename T, bool VEC>
__device__ __forceinline__ float2 fold_plane(const BwdArgs& a, int s, int ch, int id, int n,
                                             uint64_t pol) {
  constexpr int V = Vec16<T>::N;
  const Plane p = plane_of(a, s, ch);
  float2 acc = make_float2(0.f, 0.f);
  auto fold = [&](float xv, float dyv) {
    float g, xh;
    grad_in(a, p, xv, dyv, g, xh);
    acc.x += g;
    acc.y = fmaf(g, xh, acc.y);
  };
  visit_plane<T, VEC>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy),
      (static_cast<int64_t>(s) * a.c + ch) * a.hw, a.hw, id, n, pol,
      [&](int64_t, uint4 xu, uint4 du) {
#pragma unroll
        for (int k = 0; k < V; ++k) fold(elem(xu, k, T()), elem(du, k, T()));
      },
      [&](int64_t, float xv, float dv) { fold(xv, dv); });
  return acc;
}

// dx of plane (s, ch) from its sample's coef (ct, ctx), as thread `id` of `n`
template <typename T, bool VEC>
__device__ __forceinline__ void apply_plane(const BwdArgs& a, int s, int ch, float ct, float ctx,
                                            int id, int n, uint64_t pol) {
  constexpr int V = Vec16<T>::N;
  const Plane p = plane_of(a, s, ch);
  T* __restrict__ dx = static_cast<T*>(a.dx);
  auto dx_of = [&](float xv, float dyv) {
    float g, xh;
    grad_in(a, p, xv, dyv, g, xh);
    return p.inv * (fmaf(g, p.g, -ct) - xh * ctx);
  };
  visit_plane<T, VEC>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy),
      (static_cast<int64_t>(s) * a.c + ch) * a.hw, a.hw, id, n, pol,
      [&](int64_t e, uint4 xu, uint4 du) {
        float v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = dx_of(elem(xu, k, T()), elem(du, k, T()));
        store16(dx + e, v);
      },
      [&](int64_t e, float xv, float dv) { put(dx + e, dx_of(xv, dv)); });
}

__device__ __forceinline__ void red_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
// a wait that has lasted seconds is a fault: stop the kernel (the launch
// then reports an error) rather than hang the device
__device__ __forceinline__ void back_off(unsigned& ns, unsigned& spins) {
  __nanosleep(ns);
  ns = min(2 * ns, 1024u);
  if (++spins == (1u << 24)) __trap();
}

// ticket t -> (kind, sample, item in the sums' order): sample 0's sums items
// 0..K-1 (kind 0); then for each sample s the sums of sample s + 1 (where
// there is one) and s's apply items K-1..0 (kind 1). ops/group_norm.py:
// gn_bwd_tickets lists the same order.
__device__ __forceinline__ void decode_ticket(int t, int b, int K, int& kind, int& s, int& k) {
  if (t < K) {
    kind = 0;
    s = 0;
    k = t;
    return;
  }
  const int u = t - K;
  if (u < (b - 1) * 2 * K) {
    const int blk = u / (2 * K), r = u % (2 * K);
    kind = r >= K;
    s = kind ? blk : blk + 1;
    k = kind ? 2 * K - 1 - r : r;
    return;
  }
  kind = 1;
  s = b - 1;
  k = K - 1 - (u - (b - 1) * 2 * K);
}

// Sample s's coef from ws[s, :] in channel order, published (state 2); the
// sample whose coef is published last also sums dgamma and dbeta over the
// samples in order. Every thread of the CTA calls it; thread 0 has claimed
// the sample (state 0 -> 1) after its sums items were all done.
__device__ void finish_sample(const BwdArgs& a, int s) {
  __shared__ int all_done;
  const float2* ws = reinterpret_cast<const float2*>(a.ws);
  float2 acc = make_float2(0.f, 0.f);
  for (int ch = threadIdx.x; ch < a.c; ch += kBwdThreads) {
    const float2 v = __ldcg(ws + static_cast<int64_t>(s) * a.c + ch);
    const float gm = __ldg(a.gamma + ch);
    acc.x = fmaf(gm, v.x, acc.x);
    acc.y = fmaf(gm, v.y, acc.y);
  }
  acc = bwd_block_sum2(acc);
  if (threadIdx.x == 0) {
    a.coef[2 * s] = acc.x * a.inv_n;
    a.coef[2 * s + 1] = acc.y * a.inv_n;
    st_release(state_of(a, s), 2);
    __threadfence();
    const bool last = atomicAdd(a.ctr + 1, 1) == a.b - 1;
    if (last) __threadfence();
    all_done = last;
  }
  __syncthreads();
  if (!all_done) return;
  for (int ch = threadIdx.x; ch < a.c; ch += kBwdThreads) {
    float sg = 0.f, sgx = 0.f;
    for (int j = 0; j < a.b; ++j) {
      const float2 v = __ldcg(ws + static_cast<int64_t>(j) * a.c + ch);
      sg += v.x;
      sgx += v.y;
    }
    a.dbeta[ch] = sg;
    a.dgamma[ch] = sgx;
  }
}

// planes [p0, p1) of sample s: their (sum g, sum g * xh) into ws, then the
// item counts itself done for its sample (a release add: nothing waits on
// its return)
template <typename T, bool VEC>
__device__ void sums_item(const BwdArgs& a, int s, int p0, int p1, uint64_t pol) {
  __shared__ float2 part[kMaxPer][kBwdWarps];
  float2* ws = reinterpret_cast<float2*>(a.ws) + static_cast<int64_t>(s) * a.c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (a.warp) {  // a warp per plane
    for (int p = p0 + warp; p < p1; p += kBwdWarps) {
      const float2 acc = warp_sum2(fold_plane<T, VEC>(a, s, p, lane, 32, pol));
      if (lane == 0) {
        ws[p] = acc;
        __threadfence();
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) red_release(done_of(a, s), 1);
  } else {  // the CTA per plane, the warps' sums added by thread 0
    for (int p = p0; p < p1; ++p) {
      const float2 acc =
          warp_sum2(fold_plane<T, VEC>(a, s, p, threadIdx.x, kBwdThreads, pol));
      if (lane == 0) part[p - p0][warp] = acc;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int p = p0; p < p1; ++p) {
        float2 t = make_float2(0.f, 0.f);
        for (int w = 0; w < kBwdWarps; ++w) {
          t.x += part[p - p0][w].x;
          t.y += part[p - p0][w].y;
        }
        ws[p] = t;
      }
      red_release(done_of(a, s), 1);
    }
  }
}

// dx of planes [p0, p1) of sample s, its coef published
template <typename T, bool VEC>
__device__ void apply_item(const BwdArgs& a, int s, int p0, int p1, uint64_t pol) {
  const float ct = __ldcg(a.coef + 2 * s), ctx = __ldcg(a.coef + 2 * s + 1);
  if (a.warp) {
    const int lane = threadIdx.x & 31;
    for (int p = p0 + (threadIdx.x >> 5); p < p1; p += kBwdWarps)
      apply_plane<T, VEC>(a, s, p, ct, ctx, lane, 32, pol);
  } else {
    for (int p = p0; p < p1; ++p)
      apply_plane<T, VEC>(a, s, p, ct, ctx, threadIdx.x, kBwdThreads, pol);
  }
}

// VEC: x, dy and dx 16-byte aligned. One item a CTA: thread 0 takes a ticket
// and, for an apply item, waits until its sample's sums items are all done,
// then makes sure the sample's coef is published: it builds it with the whole
// CTA where it claims the sample first, or waits the short while another CTA
// takes to build it.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdThreads, kTicketBlocks) gn1_bwd_ticket(BwdArgs a) {
  __shared__ int job[4];
  if (threadIdx.x == 0) {
    int kind, s, k, build = 0;
    decode_ticket(atomicAdd(a.ctr, 1), a.b, a.items, kind, s, k);
    if (kind) {
      unsigned ns = 32, spins = 0;
      while (ld_acquire(done_of(a, s)) != a.items) back_off(ns, spins);
      if (ld_acquire(state_of(a, s)) != 2) {
        build = atomicCAS(state_of(a, s), 0, 1) == 0;
        if (!build)
          while (ld_acquire(state_of(a, s)) != 2) back_off(ns, spins);
      }
    }
    job[0] = kind;
    job[1] = s;
    job[2] = k;
    job[3] = build;
  }
  __syncthreads();
  const int kind = job[0], s = job[1], p0 = job[2] * a.per, p1 = min(a.c, p0 + a.per);
  if (!kind) {
    sums_item<T, VEC>(a, s, p0, p1, l2_policy(a.hint, true));
    return;
  }
  if (job[3]) {
    finish_sample(a, s);
    __syncthreads();  // coef written before this CTA's threads read it
  }
  apply_item<T, VEC>(a, s, p0, p1, l2_policy(a.hint, false));
}

// The split entries' two stages, one CTA a plane: the planes' sums into ws
// (then gn1_bwd_reduce), and dx from the x group's summed coef.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdThreads) gn1_bwd_split_sums(BwdArgs a) {
  const int s = blockIdx.x / a.c, ch = blockIdx.x % a.c;
  const float2 acc = bwd_block_sum2(
      fold_plane<T, VEC>(a, s, ch, threadIdx.x, kBwdThreads, l2_policy(a.hint, true)));
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
__global__ void __launch_bounds__(kBwdThreads) gn1_bwd_split_apply(BwdArgs a) {
  const int s = blockIdx.x / a.c, ch = blockIdx.x % a.c;
  apply_plane<T, VEC>(a, s, ch, __ldg(a.coef + 2 * s), __ldg(a.coef + 2 * s + 1), threadIdx.x,
                      kBwdThreads, l2_policy(a.hint, false));
}

// the split backward's sums (gn1_bwd_split_sums, gn1_bwd_reduce: ws, coef,
// dgamma, dbeta), then its apply (gn1_bwd_split_apply: dx)
template <typename T, bool VEC>
int bwd_sums_stage(const BwdArgs& a, cudaStream_t st) {
  gn1_bwd_split_sums<T, VEC><<<a.b * a.c, kBwdThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn1_bwd_reduce<<<a.b + (a.c + kBwdThreads - 1) / kBwdThreads, kBwdThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
template <typename T, bool VEC>
int bwd_apply_stage(const BwdArgs& a, cudaStream_t st) {
  gn1_bwd_split_apply<T, VEC><<<a.b * a.c, kBwdThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The three-kernel route, for samples under ops/group_norm.py:BWD_THREE_BELOW
// bytes: one CTA a plane, as the split stages but with their per-plane body of
// one element a thread, or with LOAD4 (h * w % 4 == 0, x, dy and dx aligned to
// 4 elements) 4 elements a load and one load of x and of dy in flight: on
// small planes a CTA's time is the latency of its loads and of one thread's
// GELU' chain, which more threads a plane and fewer elements a thread
// shorten.
template <typename T, bool LOAD4>
__global__ void __launch_bounds__(kBwdThreads) gn1_bwd_sums(BwdArgs a) {
  const int s = blockIdx.x / a.c, ch = blockIdx.x % a.c;
  const Plane p = plane_of(a, s, ch);
  const int64_t off = static_cast<int64_t>(blockIdx.x) * a.hw;
  const T* x = static_cast<const T*>(a.x) + off;
  const T* dy = static_cast<const T*>(a.dy) + off;
  float2 acc = make_float2(0.f, 0.f);
  auto fold = [&](float xv, float dyv) {
    float g, xh;
    grad_in(a, p, xv, dyv, g, xh);
    acc.x += g;
    acc.y = fmaf(g, xh, acc.y);
  };
  if constexpr (LOAD4) {
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

template <typename T, bool LOAD4>
__global__ void __launch_bounds__(kBwdThreads) gn1_bwd_apply(BwdArgs a) {
  const int s = blockIdx.x / a.c, ch = blockIdx.x % a.c;
  const Plane p = plane_of(a, s, ch);
  const int64_t off = static_cast<int64_t>(blockIdx.x) * a.hw;
  const T* x = static_cast<const T*>(a.x) + off;
  const T* dy = static_cast<const T*>(a.dy) + off;
  T* dx = static_cast<T*>(a.dx) + off;
  const float ct = __ldg(a.coef + 2 * s), ctx = __ldg(a.coef + 2 * s + 1);
  auto dx_of = [&](float xv, float dyv) {
    float g, xh;
    grad_in(a, p, xv, dyv, g, xh);
    return p.inv * (fmaf(g, p.g, -ct) - xh * ctx);
  };
  if constexpr (LOAD4) {
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

template <typename T, bool LOAD4>
int launch_bwd_three(const BwdArgs& a, cudaStream_t st) {
  gn1_bwd_sums<T, LOAD4><<<a.b * a.c, kBwdThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn1_bwd_reduce<<<a.b + (a.c + kBwdThreads - 1) / kBwdThreads, kBwdThreads, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn1_bwd_apply<T, LOAD4><<<a.b * a.c, kBwdThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the backward: its counters zeroed, then gn1_bwd_ticket on `grid` CTAs
template <typename T, bool VEC>
int launch_bwd(const BwdArgs& a, int grid, cudaStream_t st) {
  const cudaError_t err =
      cudaMemsetAsync(a.ctr, 0, sizeof(int) * (2 + 2 * static_cast<size_t>(a.b)), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  gn1_bwd_ticket<T, VEC><<<grid, kBwdThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of gn1_bwd_ticket resident at once on the device, and its L2 bytes
template <typename T, bool VEC>
int bwd_resident(int* out) {
  int dev = 0, sms = 0, occ = 0, l2 = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, gn1_bwd_ticket<T, VEC>,
                                                        kBwdThreads, 0);
  out[0] = occ * sms;
  out[1] = l2;
  return static_cast<int>(err);
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

// out = [resident CTAs of gn1_bwd_ticket, L2 bytes] for x of that type and
// path (vec: x, dy, dx 16-byte aligned). Returns a CUDA error.
extern "C" int gn1_bwd_resident(int is_bf16, int vec, int* out) {
  if (is_bf16)
    return vec ? bwd_resident<__nv_bfloat16, true>(out) : bwd_resident<__nv_bfloat16, false>(out);
  return vec ? bwd_resident<float, true>(out) : bwd_resident<float, false>(out);
}

// The backward (see the note at the head of its section): x, dy and dx f32 or
// (is_bf16) bf16; act as gn1_gelu_fwd's; vec: x, dy, dx 16-byte aligned; ws
// f32 [b, c, 2], coef f32 [b, 2] and ctr int [2 + 2b] scratch (ctr zeroed
// here); the plan (per, items, warp, hint, grid = 2 b items) from
// ops/group_norm.py:gn_bwd_plan. Returns the first CUDA error.
extern "C" int gn1_gelu_bwd(const void* x, const void* dy, const float* gamma, const float* beta,
                            const float* stats, float* ws, float* coef, int* ctr, void* dx,
                            float* dgamma, float* dbeta, int b, int c, long long hw, int act,
                            int is_bf16, int vec, int per, int items, int warp, int hint,
                            int grid, void* stream) {
  BwdArgs a{};
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
  a.per = per;
  a.items = items;
  a.warp = warp;
  a.hint = hint;
  a.ctr = ctr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? launch_bwd<__nv_bfloat16, true>(a, grid, s)
               : launch_bwd<__nv_bfloat16, false>(a, grid, s);
  return vec ? launch_bwd<float, true>(a, grid, s) : launch_bwd<float, false>(a, grid, s);
}

// The three-kernel route (launch_bwd_three): the arguments as gn1_gelu_bwd's,
// without its counters and plan; load4: h * w % 4 == 0 and x, dy, dx aligned
// to 4 elements.
extern "C" int gn1_gelu_bwd_three(const void* x, const void* dy, const float* gamma,
                                  const float* beta, const float* stats, float* ws, float* coef,
                                  void* dx, float* dgamma, float* dbeta, int b, int c,
                                  long long hw, int act, int is_bf16, int load4, void* stream) {
  BwdArgs a{};
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
  a.hw = static_cast<int>(hw);
  a.act = act;
  a.inv_n = 1.0f / static_cast<float>(static_cast<double>(c) * hw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return load4 ? launch_bwd_three<__nv_bfloat16, true>(a, s)
                 : launch_bwd_three<__nv_bfloat16, false>(a, s);
  return load4 ? launch_bwd_three<float, true>(a, s) : launch_bwd_three<float, false>(a, s);
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
// this rank's dgamma, dbeta; vec: x and dy 16-byte aligned; the rest as
// gn1_gelu_bwd's.
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
  a.hint = 1;
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
  a.hint = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? bwd_apply_stage<__nv_bfloat16, true>(a, s)
               : bwd_apply_stage<__nv_bfloat16, false>(a, s);
  return vec ? bwd_apply_stage<float, true>(a, s) : bwd_apply_stage<float, false>(a, s);
}
