// Mamba2 SSD chunked scan forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/ssd/ssd.py (_ssd_kernel, ssd_pallas).
// Same function: for every (batch, head) the sequence is cut into chunks of
// L rows, walked in order with a P x N f32 state. Within a chunk, with cum the
// inclusive prefix sum of dt * A,
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . state                   (the state before the chunk)
//   state = exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
// and the last state is emitted. All arithmetic is f32; x, B and C are read as
// f32 or bf16, y is written in x's dtype.
//
// What differs from the TPU design: the TPU walked a (batch, head, chunk)
// grid with the chunk axis sequential and the state in VMEM scratch, on
// operands that its wrapper had transposed and padded in HBM. Here one block
// owns one (batch, head) and loops over the chunks itself, with the state in
// shared memory. x (B,S,H,P), dt (B,S,H) and B/C (B,S,G,N) are read in place
// through strides, the head's B/C group is h / (H / G), and the ragged tail
// (rows >= S) is read as zeros (dt = 0 leaves the state unchanged) and never
// written: no transposed or padded copy is made. The L x L quasi-attention
// matrix of a 256-row chunk (256 KB in f32) does not fit in shared memory, so
// the chunk is cut into 64-row query tiles; for each, the key tiles j <= i are
// staged in turn (B_j, x_j) and their 64 x 64 block of the matrix is formed,
// masked and consumed at once. The mask is a select, so exp is never taken of
// the positive exponents above the diagonal, which can overflow.
//
// The prefix sum cum is kept in f64. Under fast decay it reaches -1e3 within a
// 256-row chunk, where an f32 ulp is 1e-4: the exponents cum_i - cum_j of
// nearby rows, which carry the weight, would then be off by that much, and y
// by ~1e-5 relative (as the plain ssd_chunked is, against the recurrence).
// Differences of f64 sums, cast to f32 only as exponents, are exact to f32.
//
// Bound on the H100: bytes (x read and y written once, B/C, dt and the final
// state) over 3.35 TB/s; the causal L x L products are about 60% of that
// time at the tensor-core peak. This kernel does its products as scalar f32
// FMAs from shared memory, each thread owning a 4 x 4 block of outputs fed by
// two 16-byte shared loads per step: tensor cores are a later change.
#include <math.h>
#include <stdint.h>

#include "../../common.cuh"

namespace {

constexpr int NT = 256;         // threads per block
constexpr int TQ = 64;          // query rows per tile
constexpr int TK = 64;          // key rows per tile
constexpr int MAX_L = NT;       // chunk length: one row per thread in the scan
constexpr int MAX_P = 64;       // head dim: one 4-column group per thread
constexpr int MAX_N = 128;      // state width
constexpr int MAX_SMEM = 232448;

struct Strides {                // in elements; the last dim is contiguous
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, b_g, c_b, c_s, c_g,
      y_b, y_s, y_h;
};

constexpr int smem_floats(int P, int N) {
  return 2 * MAX_L    // cum of the chunk, f64
       + 2 * (NT / 32)  // warp totals of the scan, f64
       + N * P        // state     [N][P]
       + N * TQ       // C tile    [N][TQ]
       + N * TK       // B tile    [N][TK] (the state update: [TK][N])
       + TK * P       // x tile    [TK][P]
       + TK * TQ      // att tile  [TK][TQ]
       + MAX_L        // dt of the chunk
       + TK;          // per-row weights of the state update
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [row0, row0 + R) of a slice with row stride rs and contiguous columns,
// transposed into dst[c * R + r]; rows r >= nvalid read as zeros. Lane r
// takes row r, so the shared-memory writes of a warp are consecutive.
template <typename T>
__device__ __forceinline__ void stage_t(float* dst, const T* src, int row0,
                                        int nvalid, int R, int ncols,
                                        long long rs) {
  constexpr int VEC = 16 / sizeof(T);
  const int cpr = ncols / VEC;
  for (int idx = threadIdx.x; idx < R * cpr; idx += NT) {
    const int r = idx % R;
    const int c = idx / R;
    float v[VEC];
    if (r < nvalid) {
      load16(src + (long long)(row0 + r) * rs + c * VEC, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[(c * VEC + e) * R + r] = v[e];
  }
}

// The same rows in their own layout, dst[r * ncols + c], each row times
// scale[r] when scale is given.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int nvalid, int R, int ncols,
                                      long long rs, const float* scale) {
  constexpr int VEC = 16 / sizeof(T);
  const int cpr = ncols / VEC;
  for (int idx = threadIdx.x; idx < R * cpr; idx += NT) {
    const int r = idx / cpr;
    const int c = idx % cpr;
    float v[VEC];
    if (r < nvalid) {
      load16(src + (long long)(row0 + r) * rs + c * VEC, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.f;
    }
    const float s = scale ? scale[r] : 1.f;
    float4* d = reinterpret_cast<float4*>(dst + r * ncols + c * VEC);
#pragma unroll
    for (int e = 0; e < VEC / 4; ++e)
      d[e] = make_float4(v[4 * e] * s, v[4 * e + 1] * s, v[4 * e + 2] * s,
                         v[4 * e + 3] * s);
  }
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const T* __restrict__ Bm,
        const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ hf,
        int S, int H, int G, int P, int N, int L, Strides st) {
  extern __shared__ __align__(16) float smem[];
  double* cum = reinterpret_cast<double*>(smem);  // [MAX_L]
  double* wsum = cum + MAX_L;           // [NT / 32]
  float* state = reinterpret_cast<float*>(wsum + NT / 32);  // [N][P]
  float* cs = state + N * P;            // [N][TQ]
  float* bs = cs + N * TQ;              // [N][TK], or [TK][N]
  float* xs = bs + N * TK;              // [TK][P]
  float* att = xs + TK * P;             // [TK][TQ]
  float* dts = att + TK * TQ;           // [MAX_L]
  float* wts = dts + MAX_L;             // [TK]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / G);
  const float a = A[h];
  const T* xb = x + b * st.x_b + h * st.x_h;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const T* bb = Bm + b * st.b_b + g * st.b_g;
  const T* cb = Cm + b * st.c_b + g * st.c_g;
  T* yb = y + b * st.y_b + h * st.y_h;

  // A thread owns a 4 x 4 block of every 64-row tile product: rows ig * 4..
  // and columns cg * 4.. (head dims in y, key rows in att).
  const int ig = tid % (TQ / 4);
  const int cg = tid / (TQ / 4);
  const bool owns_p = cg < P / 4;

  for (int i = tid; i < N * P; i += NT) state[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += L) {
    const int nv = min(L, S - t0);      // rows of this chunk inside the sequence

    // ---- cum: inclusive prefix sum of dt * A within the chunk, in f64
    __syncthreads();                    // the last chunk is done with cum, dts
    {
      const float d = tid < nv ? dtb[(long long)(t0 + tid) * st.dt_s] : 0.f;
      double v = d * a;
      const int lane = tid % 32;
      const int w = tid / 32;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) wsum[w] = v;
      __syncthreads();
      for (int k = 0; k < w; ++k) v += wsum[k];
      cum[tid] = v;
      dts[tid] = d;
    }

    const int ntile = (nv + TQ - 1) / TQ;
    for (int qt = 0; qt < ntile; ++qt) {
      const int i0 = qt * TQ;
      __syncthreads();                  // cum is written; cs is free
      stage_t(cs, cb + (long long)t0 * st.c_s, i0, nv - i0, TQ, N, st.c_s);
      __syncthreads();

      // ---- the carried state: exp(cum_i) * C_i . state, before any update
      float acc[4][4] = {};
      if (owns_p) {
        for (int n = 0; n < N; ++n)
          fma4x4(acc, ld4(cs + n * TQ + ig * 4), ld4(state + n * P + cg * 4));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float e = expf((float)cum[i0 + ig * 4 + r]);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] *= e;
        }
      }

      // ---- the causal quasi-attention, one 64 x 64 key tile at a time
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * TK;
        __syncthreads();                // the last tile's bs, xs, att are read
        stage_t(bs, bb + (long long)t0 * st.b_s, j0, nv - j0, TK, N, st.b_s);
        stage(xs, xb + (long long)t0 * st.x_s, j0, nv - j0, TK, P, st.x_s,
              nullptr);
        __syncthreads();
        {
          float s[4][4] = {};
          for (int n = 0; n < N; ++n)
            fma4x4(s, ld4(cs + n * TQ + ig * 4), ld4(bs + n * TK + cg * 4));
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + cg * 4 + c;
            const double cj = cum[j];
            const float dj = dts[j];
            float o[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = i0 + ig * 4 + r;
              o[r] = j <= i ? s[r][c] * expf((float)(cum[i] - cj)) * dj : 0.f;
            }
            *reinterpret_cast<float4*>(att + (cg * 4 + c) * TQ + ig * 4) =
                make_float4(o[0], o[1], o[2], o[3]);
          }
        }
        __syncthreads();
        if (owns_p) {
          for (int j = 0; j < TK; ++j)
            fma4x4(acc, ld4(att + j * TQ + ig * 4), ld4(xs + j * P + cg * 4));
        }
      }

      if (owns_p) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ig * 4 + r;
          if (i < nv) {
            T* row = yb + (long long)(t0 + i) * st.y_s + cg * 4;
#pragma unroll
            for (int c = 0; c < 4; ++c) row[c] = from_f32<T>(acc[r][c]);
          }
        }
      }
    }

    // ---- state update: every row tile of the chunk, after all of y
    const double clast = cum[nv - 1];
    __syncthreads();                    // every tile has read the old state
    {
      const float gamma = expf((float)clast);
      for (int i = tid; i < N * P; i += NT) state[i] *= gamma;
    }
    for (int kt = 0; kt < ntile; ++kt) {
      const int j0 = kt * TK;
      __syncthreads();                  // bs, xs, wts are free
      if (tid < TK)
        wts[tid] = expf((float)(clast - cum[j0 + tid])) * dts[j0 + tid];
      __syncthreads();
      stage(xs, xb + (long long)t0 * st.x_s, j0, nv - j0, TK, P, st.x_s, wts);
      stage(bs, bb + (long long)t0 * st.b_s, j0, nv - j0, TK, N, st.b_s,
            nullptr);
      __syncthreads();
      for (int item = tid; item < (P / 4) * (N / 4); item += NT) {
        const int pg = item % (P / 4);
        const int ng = item / (P / 4);
        float u[4][4] = {};             // [n][p]
        for (int j = 0; j < TK; ++j)
          fma4x4(u, ld4(bs + j * N + ng * 4), ld4(xs + j * P + pg * 4));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float4* sp = reinterpret_cast<float4*>(state + (ng * 4 + r) * P + pg * 4);
          float4 sv = *sp;
          sv.x += u[r][0];
          sv.y += u[r][1];
          sv.z += u[r][2];
          sv.w += u[r][3];
          *sp = sv;
        }
      }
    }
  }

  __syncthreads();
  float* hb = hf + ((long long)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += NT) hb[i] = state[(i % N) * P + i / N];
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, float* hf, int B,
                   int S, int H, int G, int P, int N, int L, const Strides& st,
                   cudaStream_t stream) {
  // the opt-in to more than 48 KB of shared memory, once per instantiation,
  // at the largest size any launch asks for
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(MAX_P, MAX_N) * (int)sizeof(float));
  if (attr != cudaSuccess) return attr;
  const int smem = smem_floats(P, N) * (int)sizeof(float);
  ssd_fwd<T><<<B * H, NT, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), hf, S, H, G, P, N, L,
      st);
  return cudaGetLastError();
}

static_assert(smem_floats(MAX_P, MAX_N) * sizeof(float) <= MAX_SMEM,
              "the largest tile set must fit in shared memory");

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt and A are float32.
// x (B,S,H,P), dt (B,S,H), B/C (B,S,G,N) and y (B,S,H,P) are addressed through
// strides in elements with a contiguous last dim; A (H,) and h_final
// (B,H,P,N) f32 are contiguous. L is the chunk length. Returns a cudaError_t.
extern "C" int ssd_fwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y, void* h_final, int dtype, int B, int S, int H,
    int G, int P, int N, int L,
    long long x_b, long long x_s, long long x_h,
    long long dt_b, long long dt_s, long long dt_h,
    long long b_b, long long b_s, long long b_g,
    long long c_b, long long c_s, long long c_g,
    long long y_b, long long y_s, long long y_h, void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || L <= 0 ||
      L > MAX_L || P <= 0 || P > MAX_P || P % vec != 0 || N <= 0 ||
      N > MAX_N || N % vec != 0)
    return (int)cudaErrorInvalidValue;
  const Strides st{x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, b_g,
                   c_b, c_s, c_g, y_b, y_s, y_h};
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(A);
  float* hp = static_cast<float*>(h_final);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, dtp, ap, Bm, Cm, y, hp, B, S, H, G, P, N, L,
                              st, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dtp, ap, Bm, Cm, y, hp, B, S, H, G,
                                      P, N, L, st, s);
  return (int)cudaErrorInvalidValue;
}
