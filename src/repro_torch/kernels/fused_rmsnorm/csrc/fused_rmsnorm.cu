// Fused RMSNorm for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/fused_rmsnorm/fused_rmsnorm.py
// (_rmsnorm_kernel, fused_rmsnorm). Same function, row by row:
//   out = x * rsqrt(mean(x^2) + eps) * (1 + w)
// with the row sum in f32 and out in x's dtype, for rows of any width d.
// With a gate (the Mamba2 block's y * silu(z)) it normalizes
//   g = x * silu(gate)
// instead, rounding silu(gate) and then the product to x's dtype as the
// eager ops y * F.silu(z) do, so the kernel and the plain path differ only
// in the order of the row sum. The gate saves the two eager passes (silu,
// then the product) and their two tensors in device memory: x and the gate
// are read once and out written once.
//
// Bound on the H100: bytes (x, the gate, w read once, out written once) over
// 3.35 TB/s; a norm does ~4 operations an element. What the design does:
//
// rmsnorm_rows: a row group of `threads` threads (whole warps) holds a row
//   in registers between the sum and the scale, so the row is read from
//   device memory once; each thread holds up to NV 16-byte vectors of it,
//   kept as loaded (a gated row as g, rounded and packed back). The group
//   sums its squares by warp shuffles and, across its warps, in shared
//   memory. A gated row holds three tensors' vectors, so few of its blocks
//   fit on an SM; it runs on a persistent grid instead: each block walks
//   row blocks blockIdx.x, + gridDim.x, ..., w loaded into registers once
//   per block instead of once per row, and the loads of a thread's next row
//   issued before it reduces the current one, so a row's memory round trip
//   overlaps the previous row's sum and stores. An ungated row, or a decode
//   step's few rows, take a block per row block. (Splitting a decode row
//   across a thread block cluster, the partial sums exchanged through
//   distributed shared memory, was built and measured slower on the card
//   than one block a row at 8 x 4,096 and at the gated 8 x 7,168: PERF.md,
//   Findings.)
// rmsnorm_loop: rows whose start is not 16-byte aligned (an odd width, a
//   row stride that is not a multiple of 16 bytes) or too wide for the
//   registers: scalar loads, the row read once for the sum and again, from
//   the cache, for the scale.
//
// Split rows (tensor parallelism, a row's columns over the ranks of a model
// group): the row's sum of squares must cross the ranks between the
// reduction and the scaling, so the two become launches of their own, MODE
// SUMSQ (each row's f32 sum of squares of x or g, rounded as above, written
// to ss) and MODE SCALE (ss read, after the caller's all-reduce, in place of
// the reduction, and the mean taken over the full width d_full). Both read
// the row once, the first writing 4 bytes a row and the second the output:
// the bound is the sum of the two passes' bytes.
//
// The launch parameters (threads, rows a block, blocks) are chosen by
// ops.plan from the row count, the width and the SM count.
#include <math.h>
#include <stdint.h>

#include "../../common.cuh"
#include "../../hopper.cuh"

namespace {

constexpr int NV = 4;              // 16-byte vectors of a row a thread holds
constexpr int MAX_THREADS = 512;   // threads of a block (ops.MAX_THREADS)
constexpr int LOOP_THREADS = 256;

// what a launch computes: the whole norm, a row's sum of squares alone, or
// the scaling from a given sum of squares
enum Mode { NORM = 0, SUMSQ = 1, SCALE = 2 };

// 16 bytes of T widened to f32 (4 floats or 8 bf16 values), and back
template <typename T> __device__ __forceinline__ void widen(const uint4& r, float* f);
template <> __device__ __forceinline__ void widen<float>(const uint4& r, float* f) {
  f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
}
template <> __device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
template <typename T> __device__ __forceinline__ uint4 narrow(const float* f);
template <> __device__ __forceinline__ uint4 narrow<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 narrow<__nv_bfloat16>(const float* f) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// v rounded to T and back (the identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// x * silu(gate) as the eager ops round it: silu in f32, rounded to T, then
// the product in f32, rounded to T (F.silu computes x / (1 + exp(-x)))
template <typename T> __device__ __forceinline__ float gated(float x, float g) {
  const float s = round_to<T>(g / (1.0f + expf(-g)));
  return round_to<T>(x * s);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// this thread's vectors t + i * threads of w
template <typename T>
__device__ __forceinline__ void load_w(const T* w, uint4* wv, int nvec,
                                       int threads) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * threads;
    if (v < nvec) wv[i] = ld16(w + (long long)v * V);
  }
}

// Block (threads, rows_per_block), a row group a threadIdx.y. Row group y of
// block b takes the rows (b + k * gridDim.x) * rows_per_block + y,
// k = 0, 1, ...; thread t holds the V-element vectors t + i * threads,
// i < NV, of each. PERSIST: a grid of fewer blocks than row blocks, w loaded
// once a block and each thread's next row loaded while the current one is
// summed and stored. Otherwise a block per row block, and w loaded after
// the row's sum, so that the row's loads go out first (at a decode step's
// 8 rows that launch took ~10% less device time than loading w first, and
// no prefetch code: PERF.md, Findings).
// MODE SUMSQ writes each row's sum to ss and nothing else; MODE SCALE reads
// it there and skips the reduction. The mean's divisor is d_full (d but
// where the row is split).
template <typename T, bool GATED, bool PERSIST, int MODE>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_rows(
    const T* __restrict__ x, const T* __restrict__ gate,
    const T* __restrict__ w, T* __restrict__ out, float* __restrict__ ss_io,
    int rows, int d, long long xs, long long gs, float d_full, float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[2][MAX_THREADS / 32];   // warp sums, by iteration parity
  const int threads = blockDim.x;
  const int nvec = d / V;
  const int nw = threads >> 5;
  const int first = threadIdx.y * nw;          // the group's first warp
  const int row_blocks = (rows + blockDim.y - 1) / blockDim.y;
  const int step = gridDim.x * blockDim.y;

  uint4 wv[NV], xv[NV], gv[NV];
  if constexpr (PERSIST && MODE != SUMSQ) load_w(w, wv, nvec, threads);
  int row = blockIdx.x * blockDim.y + threadIdx.y;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = threadIdx.x + i * threads;
    if (row < rows && v < nvec) {
      xv[i] = ld16(x + row * xs + (long long)v * V);
      if (GATED) gv[i] = ld16(gate + row * gs + (long long)v * V);
    }
  }

  // every thread of a block runs the same iterations (row blocks), so the
  // barrier below is reached by all; the group past the last row idles
  for (int rb = blockIdx.x, it = 0; rb < row_blocks;
       rb += gridDim.x, row += step, ++it) {
    // the next row's loads, in flight while this row is summed and stored
    const int next = row + step;
    uint4 xn[NV], gn[NV];
    if constexpr (PERSIST) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = threadIdx.x + i * threads;
        if (next < rows && v < nvec) {
          xn[i] = ld16(x + next * xs + (long long)v * V);
          if (GATED) gn[i] = ld16(gate + next * gs + (long long)v * V);
        }
      }
    }
    const bool live = row < rows;
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = threadIdx.x + i * threads;
      if (live && v < nvec) {
        float f[V];
        widen<T>(xv[i], f);
        if (GATED) {
          float g[V];
          widen<T>(gv[i], g);
#pragma unroll
          for (int j = 0; j < V; ++j) f[j] = gated<T>(f[j], g[j]);
          xv[i] = narrow<T>(f);      // exact: f is already rounded to T
        }
#pragma unroll
        for (int j = 0; j < V; ++j) ss += f[j] * f[j];
      }
    }

    if constexpr (MODE == SCALE) {
      ss = live ? ss_io[row] : 0.0f;
    } else {
      ss = warp_sum(ss);
      if (nw > 1) {                  // the group's warp sums, by each warp
        const int lane = threadIdx.x & 31;
        float* r = red[it & 1];
        if (lane == 0) r[first + (threadIdx.x >> 5)] = ss;
        __syncthreads();
        ss = warp_sum(lane < nw ? r[first + lane] : 0.0f);
      }
      if (MODE == SUMSQ && live && threadIdx.x == 0) ss_io[row] = ss;
    }
    const float inv = rsqrtf(ss / d_full + eps);
    if constexpr (!PERSIST && MODE != SUMSQ) load_w(w, wv, nvec, threads);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = threadIdx.x + i * threads;
      if (MODE != SUMSQ && live && v < nvec) {
        float f[V], wf[V];
        widen<T>(xv[i], f);
        widen<T>(wv[i], wf);
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = f[j] * inv * (1.0f + wf[j]);
        *reinterpret_cast<uint4*>(out + (long long)row * d + (long long)v * V) =
            narrow<T>(f);
      }
      if constexpr (PERSIST) {
        xv[i] = xn[i];
        if (GATED) gv[i] = gn[i];
      }
    }
  }
}

// One block of LOOP_THREADS a row, scalar loads: the row is read for the sum
// and again (from L1/L2) for the scale. MODE as rmsnorm_rows'.
template <typename T, bool GATED, int MODE>
__global__ void __launch_bounds__(LOOP_THREADS) rmsnorm_loop(
    const T* __restrict__ x, const T* __restrict__ gate,
    const T* __restrict__ w, T* __restrict__ out, float* __restrict__ ss_io,
    int d, long long xs, long long gs, float d_full, float eps) {
  __shared__ float red[LOOP_THREADS / 32];
  const T* xr = x + (long long)blockIdx.x * xs;
  const T* gr = gate + (long long)blockIdx.x * gs;
  T* orow = out + (long long)blockIdx.x * d;
  float ss = 0.0f;
  if constexpr (MODE == SCALE) {
    ss = ss_io[blockIdx.x];
  } else {
    for (int c = threadIdx.x; c < d; c += LOOP_THREADS) {
      float v = to_f32(xr[c]);
      if (GATED) v = gated<T>(v, to_f32(gr[c]));
      ss += v * v;
    }
    ss = warp_sum(ss);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.0f;
#pragma unroll
    for (int i = 0; i < LOOP_THREADS / 32; ++i) ss += red[i];
    if constexpr (MODE == SUMSQ) {
      if (threadIdx.x == 0) ss_io[blockIdx.x] = ss;
      return;
    }
  }
  const float inv = rsqrtf(ss / d_full + eps);
  for (int c = threadIdx.x; c < d; c += LOOP_THREADS) {
    float v = to_f32(xr[c]);
    if (GATED) v = gated<T>(v, to_f32(gr[c]));
    orow[c] = from_f32<T>(v * inv * (1.0f + to_f32(w[c])));
  }
}

template <typename T, bool GATED, int MODE>
int launch(const void* x, const void* gate, const void* w, void* out,
           float* ss, int rows, int d, long long xs, long long gs,
           float d_full, float eps, int threads, int rows_per_block,
           int blocks, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gate);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (threads == 0)
    rmsnorm_loop<T, GATED, MODE><<<rows, LOOP_THREADS, 0, s>>>(
        xp, gp, wp, op, ss, d, xs, gs, d_full, eps);
  else if (blocks < (rows + rows_per_block - 1) / rows_per_block)
    rmsnorm_rows<T, GATED, true, MODE>
        <<<blocks, dim3(threads, rows_per_block), 0, s>>>(
            xp, gp, wp, op, ss, rows, d, xs, gs, d_full, eps);
  else
    rmsnorm_rows<T, GATED, false, MODE>
        <<<blocks, dim3(threads, rows_per_block), 0, s>>>(
            xp, gp, wp, op, ss, rows, d, xs, gs, d_full, eps);
  return (int)cudaGetLastError();
}

// The checks every entry point makes of its launch; 0 where they pass.
int bad_launch(int dtype, int rows, int d, int threads, int rows_per_block,
               int blocks) {
  if (rows <= 0 || d <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (threads != 0) {
    const int vec = dtype == 0 ? 4 : 8;
    if (d % vec || threads % 32 || threads > MAX_THREADS ||
        rows_per_block < 1 || threads * rows_per_block > MAX_THREADS ||
        blocks < 1 || threads * NV < d / vec)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <int MODE>
int dispatch(const void* x, const void* gate, const void* w, void* out,
             float* ss, int dtype, int rows, int d, long long xs,
             long long gs, float d_full, float eps, int threads,
             int rows_per_block, int blocks, void* stream, int device) {
  const int bad = bad_launch(dtype, rows, d, threads, rows_per_block, blocks);
  if (bad) return bad;
  const DeviceScope on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool g = gate != nullptr;
  if (dtype == 0)
    return g ? launch<float, true, MODE>(x, gate, w, out, ss, rows, d, xs, gs,
                                         d_full, eps, threads, rows_per_block,
                                         blocks, s)
             : launch<float, false, MODE>(x, gate, w, out, ss, rows, d, xs,
                                          gs, d_full, eps, threads,
                                          rows_per_block, blocks, s);
  return g ? launch<__nv_bfloat16, true, MODE>(x, gate, w, out, ss, rows, d,
                                               xs, gs, d_full, eps, threads,
                                               rows_per_block, blocks, s)
           : launch<__nv_bfloat16, false, MODE>(x, gate, w, out, ss, rows, d,
                                                xs, gs, d_full, eps, threads,
                                                rows_per_block, blocks, s);
}

}  // namespace

// x and gate (null without one): `rows` rows of width d, row strides xs and
// gs in elements; out (rows, d) contiguous; w (d,). dtype 0 = float32, 1 = bfloat16 (w in x's
// dtype). threads 0 takes rmsnorm_loop; otherwise rmsnorm_rows with `blocks`
// blocks of (threads, rows_per_block), which needs 16-byte aligned rows of a
// width that is a multiple of 16 bytes. Every entry point launches on CUDA
// device `device` (the tensors'), `stream` one of its streams. Returns a
// CUDA error code (0 on success).
extern "C" int fused_rmsnorm_fwd(const void* x, const void* gate, const void* w,
                                 void* out, int dtype, int rows, int d,
                                 long long xs, long long gs,
                                 float eps, int threads, int rows_per_block,
                                 int blocks, void* stream, int device) {
  return dispatch<NORM>(x, gate, w, out, nullptr, dtype, rows, d, xs, gs,
                        (float)d, eps, threads, rows_per_block, blocks,
                        stream, device);
}

// The split row's first pass: ss (rows,) f32 gets each row's sum of squares
// of x, or of g = x * silu(gate) rounded to x's dtype. Arguments as
// fused_rmsnorm_fwd's.
extern "C" int fused_rmsnorm_sumsq(const void* x, const void* gate, float* ss,
                                   int dtype, int rows, int d, long long xs,
                                   long long gs, int threads,
                                   int rows_per_block, int blocks,
                                   void* stream, int device) {
  return dispatch<SUMSQ>(x, gate, nullptr, nullptr, ss, dtype, rows, d, xs,
                         gs, 1.0f, 0.0f, threads, rows_per_block, blocks,
                         stream, device);
}

// The split row's second pass: out = g * rsqrt(ss / d_full + eps) * (1 + w)
// from ss (rows,) f32, the row's sum of squares over its full width d_full
// (every rank's columns); x, the gate, w and out this rank's d columns.
extern "C" int fused_rmsnorm_scale(const void* x, const void* gate,
                                   const void* w, const float* ss, void* out,
                                   int dtype, int rows, int d, long long xs,
                                   long long gs, int d_full, float eps,
                                   int threads, int rows_per_block,
                                   int blocks, void* stream, int device) {
  if (d_full < d) return (int)cudaErrorInvalidValue;
  return dispatch<SCALE>(x, gate, w, out, const_cast<float*>(ss), dtype, rows,
                         d, xs, gs, (float)d_full, eps, threads,
                         rows_per_block, blocks, stream, device);
}
