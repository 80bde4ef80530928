// Mamba2 SSD chunked scan forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/ssd/ssd.py (_ssd_kernel, ssd_pallas).
// Same function: for every (batch, head) the sequence is cut into chunks of
// L rows, walked in order with a P x N f32 state. Within a chunk, with cum the
// inclusive prefix sum of dt * A,
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) C_i . state                   (the state before the chunk)
//   state = exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
// and the last state is emitted; y is written in x's dtype.
//
// What differs from the TPU design: the TPU walked a (batch, head, chunk)
// grid with the chunk axis sequential and the state in VMEM scratch, on
// operands that its wrapper had transposed and padded in HBM. Here one block
// walks the chunks of its (batch, head) itself. x (B,S,H,P), dt (B,S,H) and
// B/C (B,S,G,N) are read in place through strides, the head's B/C group is
// h / (H / G), and the ragged tail (rows >= S) is read as zeros (dt = 0
// leaves the state unchanged) and never written: no transposed or padded
// copy is made. The causal mask is a select, so exp is never taken of the
// positive exponents above the diagonal, which can overflow.
//
// The prefix sum cum is kept in f64. Under fast decay it reaches -1e3 within a
// 256-row chunk, where an f32 ulp is 1e-4: the exponents cum_i - cum_j of
// nearby rows, which carry the weight, would then be off by that much, and y
// by ~1e-5 relative (as the plain ssd_chunked is, against the recurrence).
//
// Bound on the H100: bytes (x read and y written once, B/C, dt and the final
// state) over 3.35 TB/s; the causal L x L products take about 60% of that
// time at the bf16 tensor-core peak.
//
// bfloat16: ssd_fwd_mma, on the tensor cores (mma.sync.m16n8k16, bf16
// operands, f32 accumulators). One block of 8 warps owns (batch, head), as
// in the f32 kernel. Each chunk is staged once: x, B and C by cp.async into
// shared memory as bf16 rows whose 16-byte pieces are permuted per row
// (swz), so ldmatrix reads them without bank conflicts; widths past P and N
// are zero-filled up to the tile (NP = 16, 32, 64 or 128 for N; PB = 64 for
// P). Where two blocks' shared memory fits on an SM (zamba2-7b's widths,
// N = P = 64) the block is held to 128 registers a thread so that two run
// side by side, one computing while the other loads, stores or waits.
// The 256-row chunk is 16 query tiles of 16 rows; warp w takes tiles w and
// 15 - w, so every warp does the same causal work. For a query tile a warp
// keeps C as A fragments, adds
//   exp(cum_i) C_i . bf16(state)^T
// then walks the key tiles j0 <= i0: S = C B^T (16 x 16) in f32 registers,
// then exp(cum_i - cum_j) dt_j applied there (the select first on the
// diagonal tile; below it as exp(cum_i - cum_q) exp(cum_q - cum_j) dt_j with
// q the key tile's last row, both factors at most 1, so a thread takes 2
// exps per tile instead of 8), S rounded to bf16 as the A fragment of
// att . x, accumulated into y's registers. The finished y tile goes to the
// warp's own rows of C (no other warp reads them) and out to y by bulk
// copies (cp.async.bulk), so the warp does not wait on the stores. The state
// never leaves registers: its NP x PB tiles are spread over the 8 warps as
// mma accumulators, scaled by exp(cum_last) and updated by
//   state^T += bf16(w_j B_j)^T . x_j,   w_j = exp(cum_last - cum_j) dt_j
// each chunk, and written to shared memory in bf16 at the start of the next
// for its C . state^T. The exponents are (hi_i - hi_j) + (lo_i - lo_j) of
// cum split into two f32 parts, which keeps the f64 prefix sum's accuracy
// with no f64 arithmetic per element. ref.ssd_chunked_tc is the same
// arithmetic in plain PyTorch.
//
// float32: ssd_fwd, PR 12's scalar design, kept as flash attention keeps its
// f32 kernel: it holds the algorithm at 1e-5 against the recurrence, and
// bf16 or TF32 operands would not. One block per (batch, head), the state in
// shared memory; the L x L quasi-attention matrix of a 256-row chunk does not
// fit in shared memory, so the chunk is cut into 64-row query tiles, and for
// each the key tiles j <= i are staged in turn; products are f32 FMAs, each
// thread owning a 4 x 4 block of outputs.
#include <math.h>
#include <stdint.h>

#include "../../common.cuh"
#include "../../hopper.cuh"

namespace {

constexpr int NT = 256;         // threads per block
constexpr int TQ = 64;          // query rows per tile
constexpr int TK = 64;          // key rows per tile
constexpr int MAX_L = NT;       // chunk length: one row per thread in the scan
constexpr int MAX_P = 64;       // head dim: one 4-column group per thread
constexpr int MAX_N = 128;      // state width
constexpr int PB = MAX_P;       // the bf16 kernel's tile of P, zero-filled
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

// ================================================================ bfloat16
typedef __nv_bfloat16 bf16;
constexpr int NW = NT / 32;     // warps per block
constexpr int SM_SMEM = 233472; // shared memory of one SM
constexpr int CTA_RESERVED = 1024;  // of it, kept by the system for each block

// Element offset of (row, col) in a [rows][W] bf16 tile whose 16-byte chunks
// are permuted within each row, so that the 8 rows one ldmatrix reads, and
// the 8 rows of a warp's 4-byte stores, fall in distinct banks. A row offset
// that is a multiple of 16 adds row * W and leaves the permutation as it is.
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int CH = W / 8;                 // 16-byte chunks per row
  constexpr int RPL = CH >= 8 ? 1 : 8 / CH; // rows per 128-byte line
  const int f = CH >= 8 ? row % 8 : (row / RPL) % CH;
  return row * W + (((col / 8) ^ f) * 8) + col % 8;
}

template <int NP>
struct Tc {
  static constexpr int NT8 = PB / 8;        // n8 tiles of y and of the state
  static constexpr int TILES = (NP / 16) * NT8;   // m16 x n8 tiles of state^T
  static constexpr int TPW = TILES >= NW ? TILES / NW : 1;  // per warp
  static constexpr int SMEM = MAX_L * (PB + 2 * NP) * 2   // x, B, C
                            + NP * PB * 2                  // bf16 state^T
                            + NW * 8                       // warp totals
                            + 5 * MAX_L * 4;               // cum hi/lo, dt, w, v
  // two blocks on an SM where their shared memory fits: one computes while
  // the other waits on its loads, stores and barriers
  static constexpr int MINB = 2 * (SMEM + CTA_RESERVED) <= SM_SMEM ? 2 : 1;
};

// a bf16 pair times two f32 weights, rounded back to a bf16 pair
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t u, float lo,
                                                 float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  return pack_bf16(f.x * lo, f.y * hi);
}

template <int NP>
__global__ void __launch_bounds__(NT, (Tc<NP>::MINB))
ssd_fwd_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const bf16* __restrict__ Bm,
            const bf16* __restrict__ Cm, bf16* __restrict__ y,
            float* __restrict__ hf, int S, int H, int G, int P, int N, int L,
            Strides st) {
  using K = Tc<NP>;
  extern __shared__ __align__(16) float smem[];   // one name in this file
  bf16* xs = reinterpret_cast<bf16*>(smem);    // [MAX_L][PB], swizzled
  bf16* bs = xs + MAX_L * PB;                  // [MAX_L][NP]
  bf16* cs = bs + MAX_L * NP;                  // [MAX_L][NP]
  bf16* sth = cs + MAX_L * NP;                 // bf16(state^T) [NP][PB]
  double* wsum = reinterpret_cast<double*>(sth + NP * PB);  // [NW]
  float* chi = reinterpret_cast<float*>(wsum + NW);  // cum as f32 hi + lo
  float* clo = chi + MAX_L;
  float* dts = clo + MAX_L;
  float* wts = dts + MAX_L;                    // exp(cum_last - cum_j) dt_j
  float* vfac = wts + MAX_L;                   // exp(cum_{j|15} - cum_j) dt_j

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r = lane / 4;                      // fragment rows r and r + 8
  const int c = 2 * (lane % 4);                // fragment columns c and c + 1
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / (H / G);
  const float a = A[h];
  const bf16* xb = x + b * st.x_b + h * st.x_h;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const bf16* bb = Bm + b * st.b_b + g * st.b_g;
  const bf16* cb = Cm + b * st.c_b + g * st.c_g;
  bf16* yb = y + b * st.y_b + h * st.y_h;

  // this warp's tiles of state^T: rows n of m16 tile sm, columns p of the n8
  // tiles sn0 .. sn0 + TPW - 1 (none when the state has fewer than 8 tiles)
  const bool owns = warp * K::TPW < K::TILES;
  const int sm = warp * K::TPW / K::NT8;
  const int sn0 = warp * K::TPW % K::NT8;
  float sacc[K::TPW][4];
#pragma unroll
  for (int k = 0; k < K::TPW; ++k)
    sacc[k][0] = sacc[k][1] = sacc[k][2] = sacc[k][3] = 0.f;

  // dt of the chunk, read a chunk ahead
  float d_next = tid < min(L, S) ? dtb[(long long)tid * st.dt_s] : 0.f;
  for (int t0 = 0; t0 < S; t0 += L) {
    const int nv = min(L, S - t0);      // rows of this chunk inside the sequence
    const int nq = (nv + 15) / 16;      // 16-row tiles
    bulk_wait_read();                   // the last chunk's y has left C's rows
    __syncthreads();                    // the last chunk's reads are done
    const float d = d_next;
    if (t0 + L < S)
      d_next = tid < min(L, S - t0 - L)
                   ? dtb[(long long)(t0 + L + tid) * st.dt_s] : 0.f;

    // ---- stage x, B and C of the chunk once; rows past nv and columns past
    // P and N as zeros
    for (int i = tid; i < nq * 16 * (PB / 8); i += NT) {
      const int rr = i / (PB / 8);
      const int cc = 8 * (i % (PB / 8));
      const bool ok = rr < nv && cc < P;
      cp_async16(xs + swz<PB>(rr, cc),
                 ok ? xb + (long long)(t0 + rr) * st.x_s + cc : xb, ok ? 16 : 0);
    }
    for (int i = tid; i < nq * 16 * (NP / 8); i += NT) {
      const int rr = i / (NP / 8);
      const int cc = 8 * (i % (NP / 8));
      const bool ok = rr < nv && cc < N;
      const long long row = t0 + rr;
      cp_async16(bs + swz<NP>(rr, cc), ok ? bb + row * st.b_s + cc : bb,
                 ok ? 16 : 0);
      cp_async16(cs + swz<NP>(rr, cc), ok ? cb + row * st.c_s + cc : cb,
                 ok ? 16 : 0);
    }
    cp_async_commit();

    // ---- the state before the chunk, rounded to bf16 for C . state^T
    if (owns) {
#pragma unroll
      for (int k = 0; k < K::TPW; ++k) {
        const int p = 8 * (sn0 + k) + c;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<__nv_bfloat162*>(
              sth + 16 * sm * PB + swz<PB>(r + 8 * hr, p)) =
              __floats2bfloat162_rn(sacc[k][2 * hr], sacc[k][2 * hr + 1]);
      }
    }

    // ---- cum: inclusive prefix sum of dt * A within the chunk, in f64. Rows
    // past nv add 0, so the chunk's total is cum at its last row, cum_last.
    double clast = 0.0;
    {
      double v = d * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) wsum[warp] = v;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if (k < warp) v += wsum[k];
        clast += wsum[k];
      }
      const float hi = (float)v;
      chi[tid] = hi;
      clo[tid] = (float)(v - (double)hi);
      dts[tid] = d;
      // q = tid | 15, the last row of this row's 16-row tile, is in this warp
      const double vq = __shfl_sync(0xffffffffu, v, lane | 15);
      wts[tid] = tid < nv ? expf((float)(clast - v)) * d : 0.f;
      vfac[tid] = expf((float)(vq - v)) * d;
    }
    const float gamma = expf((float)clast);
    cp_async_wait<0>();
    __syncthreads();

    // ---- y: query tile w and, past the first 8 tiles, tile nq - 1 - w
    for (int pass = 0; pass < 2; ++pass) {
      const int t = pass == 0 ? warp : nq - 1 - warp;
      if (pass == 0 ? t >= nq : t < NW) continue;
      const int i0 = 16 * t;
      uint32_t ca[NP / 16][4];            // C of the tile as A fragments
#pragma unroll
      for (int ks = 0; ks < NP / 16; ++ks)
        ldmatrix_x4(ca[ks], cs + i0 * NP
                                + swz<NP>(lane % 16, 16 * ks + 8 * (lane / 16)));
      float acc[K::NT8][4];
#pragma unroll
      for (int j = 0; j < K::NT8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

      // the carried state: exp(cum_i) C_i . state^T (zero in the first chunk)
      if (t0 > 0) {
#pragma unroll
        for (int ks = 0; ks < NP / 16; ++ks) {
#pragma unroll
          for (int np = 0; np < PB / 16; ++np) {
            uint32_t sb[4];
            ldmatrix_x4_trans(sb, sth + 16 * ks * PB
                                      + swz<PB>(lane % 8 + 8 * ((lane / 8) % 2),
                                                16 * np + 8 * (lane / 16)));
            mma_bf16_16816(acc[2 * np], ca[ks], sb[0], sb[1]);
            mma_bf16_16816(acc[2 * np + 1], ca[ks], sb[2], sb[3]);
          }
        }
        const float e0 = expf(chi[i0 + r]);
        const float e1 = expf(chi[i0 + r + 8]);
#pragma unroll
        for (int j = 0; j < K::NT8; ++j) {
          acc[j][0] *= e0;
          acc[j][1] *= e0;
          acc[j][2] *= e1;
          acc[j][3] *= e1;
        }
      }

      // the causal quasi-attention, one 16-row key tile at a time
      const float hi_i[2] = {chi[i0 + r], chi[i0 + r + 8]};
      const float lo_i[2] = {clo[i0 + r], clo[i0 + r + 8]};
      for (int kt = 0; kt <= t; ++kt) {
        const int j0 = 16 * kt;
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < NP / 16; ++ks) {
          uint32_t kb[4];
          ldmatrix_x4(kb, bs + j0 * NP + swz<NP>(lane % 8 + 8 * (lane / 16),
                                                 16 * ks + 8 * ((lane / 8) % 2)));
          mma_bf16_16816(s[0], ca[ks], kb[0], kb[1]);
          mma_bf16_16816(s[1], ca[ks], kb[2], kb[3]);
        }
        if (kt < t) {
          // below the diagonal every j < i: exp(cum_i - cum_j) dt_j as
          // exp(cum_i - cum_q) times vfac_j, q = j0 + 15 the key tile's last
          // row; both factors are at most 1, and 2 exps replace 8
          const float hq = chi[j0 + 15], lq = clo[j0 + 15];
          const float u[2] = {__expf((hi_i[0] - hq) + (lo_i[0] - lq)),
                              __expf((hi_i[1] - hq) + (lo_i[1] - lq))};
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float vj = vfac[j0 + 8 * nb + c + e];
              s[nb][e] *= u[0] * vj;
              s[nb][2 + e] *= u[1] * vj;
            }
          }
        } else {
          // the diagonal tile: the select, then exp(cum_i - cum_j) dt_j
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = j0 + 8 * nb + c + e;
              const float hj = chi[j], lj = clo[j], dj = dts[j];
#pragma unroll
              for (int hr = 0; hr < 2; ++hr) {
                const bool keep = j <= i0 + r + 8 * hr;
                const float ex = keep ? (hi_i[hr] - hj) + (lo_i[hr] - lj) : 0.f;
                float& v = s[nb][2 * hr + e];
                v = keep ? v * __expf(ex) * dj : 0.f;
              }
            }
          }
        }
        const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                                pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]),
                                pack_bf16(s[1][2], s[1][3])};
#pragma unroll
        for (int np = 0; np < PB / 16; ++np) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, xs + j0 * PB
                                    + swz<PB>(lane % 8 + 8 * ((lane / 8) % 2),
                                              16 * np + 8 * (lane / 16)));
          mma_bf16_16816(acc[2 * np], pa, vb[0], vb[1]);
          mma_bf16_16816(acc[2 * np + 1], pa, vb[2], vb[3]);
        }
      }

      // y of the tile: through its own rows of C, which no other warp reads
      // and this one no longer needs, out by the copy engine a row at a time
      // while the warp goes on
      if (NP >= PB) {
        bf16* ys = cs + i0 * NP;        // [16][PB], rows contiguous
#pragma unroll
        for (int j = 0; j < K::NT8; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            *reinterpret_cast<__nv_bfloat162*>(ys + (r + 8 * hr) * PB + 8 * j + c) =
                __floats2bfloat162_rn(acc[j][2 * hr], acc[j][2 * hr + 1]);
        fence_async_shared();
        __syncwarp();
        if (lane < 16 && i0 + lane < nv) {
          bulk_store(yb + (long long)(t0 + i0 + lane) * st.y_s, ys + lane * PB,
                     P * 2);
          bulk_commit();
        }
      } else {
#pragma unroll
        for (int j = 0; j < K::NT8; ++j) {
          const int p = 8 * j + c;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int i = i0 + r + 8 * hr;
            if (i < nv && p < P)
              *reinterpret_cast<__nv_bfloat162*>(
                  yb + (long long)(t0 + i) * st.y_s + p) =
                  __floats2bfloat162_rn(acc[j][2 * hr], acc[j][2 * hr + 1]);
          }
        }
      }
    }

    // ---- state^T = exp(cum_last) state^T + bf16(w_j B_j)^T . x_j
    if (owns) {
#pragma unroll
      for (int k = 0; k < K::TPW; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[k][e] *= gamma;
#pragma unroll 4
      for (int kt = 0; kt < nq; ++kt) {
        const int j0 = 16 * kt;
        uint32_t am[4];
        ldmatrix_x4_trans(am, bs + j0 * NP
                                  + swz<NP>(lane % 8 + 8 * (lane / 16),
                                            16 * sm + 8 * ((lane / 8) % 2)));
        const float w0 = wts[j0 + c], w1 = wts[j0 + c + 1];
        const float w8 = wts[j0 + c + 8], w9 = wts[j0 + c + 9];
        am[0] = scale_bf16x2(am[0], w0, w1);
        am[1] = scale_bf16x2(am[1], w0, w1);
        am[2] = scale_bf16x2(am[2], w8, w9);
        am[3] = scale_bf16x2(am[3], w8, w9);
        uint32_t xv[4];
#pragma unroll
        for (int k = 0; k < K::TPW; ++k) {
          const int nt = sn0 + k;
          const bool odd = nt & 1;
          if (k == 0 || !odd)
            ldmatrix_x4_trans(xv, xs + j0 * PB
                                      + swz<PB>(lane % 8 + 8 * ((lane / 8) % 2),
                                                8 * (nt & ~1) + 8 * (lane / 16)));
          mma_bf16_16816(sacc[k], am, odd ? xv[2] : xv[0], odd ? xv[3] : xv[1]);
        }
      }
    }
  }

  bulk_wait();                          // y is written before the block ends

  // ---- the final state (B, H, P, N)
  if (owns) {
    float* hb = hf + ((long long)b * H + h) * P * N;
#pragma unroll
    for (int k = 0; k < K::TPW; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * sm + r + 8 * (e / 2);
        const int p = 8 * (sn0 + k) + c + e % 2;
        if (n < N && p < P) hb[(long long)p * N + n] = sacc[k][e];
      }
  }
}

static_assert(Tc<128>::SMEM <= MAX_SMEM && Tc<64>::MINB == 2,
              "the tile sets must fit in shared memory");

cudaError_t launch_f32(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, void* y, float* hf,
                       int B, int S, int H, int G, int P, int N, int L,
                       const Strides& st, cudaStream_t stream) {
  // the opt-in to more than 48 KB of shared memory, once per device, at the
  // largest size any launch asks for
  static SmemOptIn opt_in;
  if (const cudaError_t e = opt_in(
          ssd_fwd<float>, smem_floats(MAX_P, MAX_N) * (int)sizeof(float)))
    return e;
  const int smem = smem_floats(P, N) * (int)sizeof(float);
  ssd_fwd<float><<<B * H, NT, smem, stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), hf, S, H, G, P,
      N, L, st);
  return cudaGetLastError();
}

static_assert(smem_floats(MAX_P, MAX_N) * sizeof(float) <= MAX_SMEM,
              "the largest tile set must fit in shared memory");

template <int NP>
cudaError_t launch_mma(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, void* y, float* hf,
                       int B, int S, int H, int G, int P, int N, int L,
                       const Strides& st, cudaStream_t stream) {
  static SmemOptIn opt_in;
  if (const cudaError_t e = opt_in(ssd_fwd_mma<NP>, Tc<NP>::SMEM)) return e;
  ssd_fwd_mma<NP><<<B * H, NT, Tc<NP>::SMEM, stream>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<bf16*>(y), hf, S, H, G, P, N,
      L, st);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt and A are float32.
// x (B,S,H,P), dt (B,S,H), B/C (B,S,G,N) and y (B,S,H,P) are addressed through
// strides in elements with a contiguous last dim; A (H,) and h_final
// (B,H,P,N) f32 are contiguous. L is the chunk length. The kernel runs on
// CUDA device `device` (the tensors'), `stream` one of its streams. Returns
// a cudaError_t.
extern "C" int ssd_fwd_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y, void* h_final, int dtype, int B, int S, int H,
    int G, int P, int N, int L,
    long long x_b, long long x_s, long long x_h,
    long long dt_b, long long dt_s, long long dt_h,
    long long b_b, long long b_s, long long b_g,
    long long c_b, long long c_s, long long c_g,
    long long y_b, long long y_s, long long y_h, void* stream, int device) {
  const int vec = dtype == 0 ? 4 : 8;
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || L <= 0 ||
      L > MAX_L || P <= 0 || P > MAX_P || P % vec != 0 || N <= 0 ||
      N > MAX_N || N % vec != 0)
    return (int)cudaErrorInvalidValue;
  const DeviceScope on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  const Strides st{x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, b_g,
                   c_b, c_s, c_g, y_b, y_s, y_h};
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(A);
  float* hp = static_cast<float*>(h_final);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f32(x, dtp, ap, Bm, Cm, y, hp, B, S, H, G, P, N, L, st,
                           s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (N <= 16)
    return (int)launch_mma<16>(x, dtp, ap, Bm, Cm, y, hp, B, S, H, G, P, N,
                               L, st, s);
  if (N <= 32)
    return (int)launch_mma<32>(x, dtp, ap, Bm, Cm, y, hp, B, S, H, G, P, N,
                               L, st, s);
  if (N <= 64)
    return (int)launch_mma<64>(x, dtp, ap, Bm, Cm, y, hp, B, S, H, G, P, N,
                               L, st, s);
  return (int)launch_mma<128>(x, dtp, ap, Bm, Cm, y, hp, B, S, H, G, P, N,
                              L, st, s);
}
