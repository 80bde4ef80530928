// Single-query GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/decode_attention/decode_attention.py
// (_decode_kernel, decode_attention_bhd). Same function: each query head
// attends to the first valid_len rows of its kv head's cache with an online
// softmax in f32; rows at or past valid_len are never read; with no valid
// row the output is zero (a zero accumulator over max(l, 1e-30)).
//
// Bound on the H100: bytes. A step reads valid_len rows of K and V once; the
// arithmetic is 4 * G FLOP per cached element.
//
// What differs from the TPU design: on the TPU valid_len arrived by scalar
// prefetch and the kv blocks were a sequential grid axis. Here the cache is
// split across SMs (split-KV): the grid is (B * KV, n_split), the wrapper
// picks n_split from the cache capacity S and the SM count (never from
// valid_len, which stays on the device), and each block reads valid_len
// itself from a device pointer, so the host never waits on the device. A
// block serves all G query heads of its kv head, so each cached row is read
// from device memory once, not G times, walks the rows of its split below
// valid_len and writes f32 partials (m, l, acc[hd]) per head to scratch; a
// split that starts at or past valid_len writes m = -1e30, l = 0, acc = 0. A
// second kernel, launched by the same entry point, merges the splits:
// M = max m_i, O = sum e^(m_i - M) acc_i / max(sum e^(m_i - M) l_i, 1e-30).
// The cache is read in its stored layout (B, S, KV, hd) through strides.
//
// The softmax partial (lse != nullptr): the merge also writes, per (b, h),
// the f32 log-sum-exp of the scaled scores over the valid rows,
// lse = M + log(sum e^(m_i - M) l_i), or -inf where no row is valid (O is 0
// there), and writes O in f32 whatever the inputs' dtype. A sequence-parallel
// decode, each rank holding a block of the cache's sequence, combines its
// ranks' (O, lse) into the attention over the whole cache:
// O = sum_r e^(lse_r - L) O_r / sum_r e^(lse_r - L), L = max_r lse_r.
//
// bfloat16: decode_fwd_split_mma. Four warps per block, each streaming its
// own 16-row chunks of the split (chunk c goes to warp c % 4) through a
// two-stage cp.async ring in shared memory; chunks past valid_len are not
// read (cp.async writes zeros). The products run on the tensor cores as
// mma.sync.m16n8k16: the G query heads of the kv head are the 16 rows of A
// (zero rows when G < 16; groups of 16 heads along grid z when G > 16),
// K and V fragments come from shared memory by ldmatrix (V transposed). The
// four warps' (m, l, acc) are merged in shared memory before the block
// writes its partial.
//
// float32: decode_fwd_split_f32, scalar FMAs (one block serves all G heads
// of its split with 64-row shared-memory tiles), kept for the reason the
// flash kernel keeps one: it holds the algorithm at 2e-5, and TF32 tensor
// cores would not.
#include <math.h>
#include <stdint.h>

#include "../../common.cuh"
#include "../../hopper.cuh"

namespace {

constexpr int MAX_SMEM = 232448;            // opt-in shared memory per block

struct Strides {                // in elements; the head dim is contiguous
  long long q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h;
};

// The partials of record r = (pair * n_split + split) * G + g:
// acc[r * hd + d], ml[2 r] = m, ml[2 r + 1] = l.
struct Partials {
  float* acc;
  float* ml;
};

// ================================================================ bfloat16
constexpr int WARPS = 4;
constexpr int ROWS = 16;                    // cache rows per warp chunk

template <int HD>
struct Split {
  static constexpr int LD = HD + 8;         // padded row: conflict-free ldmatrix
  static constexpr int STAGE = 2 * ROWS * LD;   // K and V chunk, elements
  static constexpr int SMEM_KV = WARPS * 2 * STAGE * 2;
  static constexpr int SMEM_MERGE = (WARPS * 16 * (HD + 2)) * 4;
  static constexpr int SMEM = SMEM_KV > SMEM_MERGE ? SMEM_KV : SMEM_MERGE;
};

template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
decode_fwd_split_mma(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, Partials part,
                     const int* __restrict__ valid_len, int S, int KV, int G,
                     int rows_per_split, Strides st, float scale) {
  using C = Split<HD>;
  constexpr int LD = C::LD;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pair = blockIdx.x;
  const int b = pair / KV;
  const int kvh = pair % KV;
  const int g0 = 16 * blockIdx.z;             // first head of this group
  const int ng = min(16, G - g0);
  const long long rec0 = ((long long)pair * gridDim.y + blockIdx.y) * G + g0;
  const int valid = min(max(*valid_len, 0), S);
  const int s0 = blockIdx.y * rows_per_split;
  const int e = min(s0 + rows_per_split, valid);

  if (s0 >= e) {                              // no valid row in this split
    for (int i = threadIdx.x; i < ng * HD; i += WARPS * 32)
      part.acc[rec0 * HD + i] = 0.f;
    for (int g = threadIdx.x; g < ng; g += WARPS * 32) {
      part.ml[2 * (rec0 + g)] = -1e30f;
      part.ml[2 * (rec0 + g) + 1] = 0.f;
    }
    return;
  }

  // mma fragment coordinates: A/C rows r and r + 8, columns c and c + 1
  const int r = lane / 4;
  const int c = 2 * (lane % 4);

  // Q as A fragments (16 heads x HD), zero rows past the group's heads
  uint32_t qa[HD / 16][4];
  const int h0 = kvh * G + g0;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + 8 * (i % 2);
      const int col = 16 * ks + c + 8 * (i / 2);
      qa[ks][i] = row < ng ? *reinterpret_cast<const uint32_t*>(
                                 q + b * st.q_b + (long long)(h0 + row) * st.q_h
                                 + col)
                           : 0u;
    }
  }

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.f, 0.f};                    // this thread's share

  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem)
                        + warp * 2 * C::STAGE;
  const __nv_bfloat16* kbase = k + b * st.k_b + kvh * st.k_h;
  const __nv_bfloat16* vbase = v + b * st.v_b + kvh * st.v_h;
  const int n_chunks = (e - s0 + ROWS - 1) / ROWS;

  auto load = [&](int chunk, int stage) {
    __nv_bfloat16* kd = ring + stage * C::STAGE;
    __nv_bfloat16* vd = kd + ROWS * LD;
    const int row0 = s0 + ROWS * chunk;
    for (int i = lane; i < ROWS * HD / 8; i += 32) {
      const int rr = i / (HD / 8);
      const int cc = 8 * (i % (HD / 8));
      const bool ok = row0 + rr < e;
      const long long row = ok ? row0 + rr : 0;
      cp_async16(kd + rr * LD + cc, kbase + row * st.k_s + cc, ok ? 16 : 0);
      cp_async16(vd + rr * LD + cc, vbase + row * st.v_s + cc, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  int stage = 0;
  if (warp < n_chunks) load(warp, 0);
  for (int chunk = warp; chunk < n_chunks; chunk += WARPS) {
    if (chunk + WARPS < n_chunks) {
      load(chunk + WARPS, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const __nv_bfloat16* kd = ring + stage * C::STAGE;
    const __nv_bfloat16* vd = kd + ROWS * LD;

    // S = Q K^T: 16 heads x 16 rows, two n8 blocks (rows 0-7 and 8-15)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kd + (lane % 8 + 8 * (lane / 16)) * LD + 16 * ks
                          + 8 * ((lane / 8) % 2));
      mma_bf16_16816(sc[0], qa[ks], kb[0], kb[1]);
      mma_bf16_16816(sc[1], qa[ks], kb[2], kb[3]);
    }

    // online softmax per head row (r: elements 0, 1; r + 8: elements 2, 3)
    const int row0 = s0 + ROWS * chunk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const bool ok = row0 + 8 * nb + c + x < e;
          const float sv = ok ? sc[nb][2 * i + x] * scale : -INFINITY;
          sc[nb][2 * i + x] = sv;
          mx = fmaxf(mx, sv);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float p = expf(sc[nb][2 * i + x] - m_new);  // masked: 0
          sc[nb][2 * i + x] = p;
          sum += p;
        }
      }
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }

    // O += P V: P (16 heads x 16 rows) as one A fragment
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                            pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]),
                            pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vd + (lane % 8 + 8 * ((lane / 8) % 2)) * LD
                                + 8 * (2 * np + lane / 16));
      mma_bf16_16816(o[2 * np], pa, vb[0], vb[1]);
      mma_bf16_16816(o[2 * np + 1], pa, vb[2], vb[3]);
    }
    __syncwarp();                             // the stage may be refilled
    stage ^= 1;
  }

  // merge the four warps' (m, l, acc) in shared memory (the ring is free)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);  // [WARPS][16]
  float* wl = wm + WARPS * 16;                 // [WARPS][16]
  float* wo = wl + WARPS * 16;                 // [WARPS][16][HD]
  if (lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      wm[warp * 16 + r + 8 * i] = m[i];
      wl[warp * 16 + r + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* dst = wo + (warp * 16 + r + 8 * i) * HD + 8 * j + c;
      dst[0] = o[j][2 * i];
      dst[1] = o[j][2 * i + 1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * HD; i += WARPS * 32) {
    const int g = i / HD;
    const int d = i % HD;
    float mx = -1e30f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * 16 + g]);
    float acc = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(wm[w * 16 + g] - mx);
      acc += a * wo[(w * 16 + g) * HD + d];
      sum += a * wl[w * 16 + g];
    }
    part.acc[(rec0 + g) * HD + d] = acc;
    if (d == 0) {
      part.ml[2 * (rec0 + g)] = mx;
      part.ml[2 * (rec0 + g) + 1] = sum;
    }
  }
}

// ================================================================= float32
constexpr int DBK = 64;         // cache rows per shared-memory tile
constexpr int NT = 256;         // threads per block

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

int smem_f32(int G, int hd) {
  return (2 * G * hd + DBK * (hd + 4) + DBK * hd + G * DBK + 3 * G) *
         (int)sizeof(float);
}

__global__ void __launch_bounds__(NT)
decode_fwd_split_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, Partials part,
                     const int* __restrict__ valid_len, int S, int KV, int G,
                     int hd, int rows_per_split, Strides st, float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int hdp = hd + 4;               // padded K rows: conflict-free float4 reads
  float* qs = smem_f;                     // [G][hd]
  float* acc = qs + G * hd;             // [G][hd]
  float* ks = acc + G * hd;             // [DBK][hdp]
  float* vs = ks + DBK * hdp;           // [DBK][hd]
  float* sc = vs + DBK * hd;            // [G][DBK] scores, then probabilities
  float* mrow = sc + G * DBK;           // [G] running max
  float* lrow = mrow + G;               // [G] running sum
  float* arow = lrow + G;               // [G] rescale of this tile

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int pair = blockIdx.x;
  const int b = pair / KV;
  const int kvh = pair % KV;
  const int h0 = kvh * G;
  const long long rec0 = ((long long)pair * gridDim.y + blockIdx.y) * G;
  const int valid = min(max(*valid_len, 0), S);
  const int s0 = blockIdx.y * rows_per_split;
  const int e = min(s0 + rows_per_split, valid);
  const int cpr = hd / 4;

  for (int idx = tid; idx < G * hd; idx += NT) {
    const int g = idx / hd;
    const int d = idx % hd;
    qs[idx] = q[b * st.q_b + (long long)(h0 + g) * st.q_h + d];
    acc[idx] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    mrow[g] = -1e30f;
    lrow[g] = 0.f;
  }
  const float* kbase = k + b * st.k_b + kvh * st.k_h;
  const float* vbase = v + b * st.v_b + kvh * st.v_h;

  for (int kb = s0; kb < e; kb += DBK) {
    const int nk = min(DBK, e - kb);
    __syncthreads();                    // the previous tile is consumed
    for (int idx = tid; idx < nk * cpr; idx += NT) {
      const int j = idx / cpr;
      const int c = idx % cpr;
      float kf[4], vf[4];
      load16(kbase + (long long)(kb + j) * st.k_s + c * 4, kf);
      load16(vbase + (long long)(kb + j) * st.v_s + c * 4, vf);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        ks[j * hdp + c * 4 + x] = kf[x];
        vs[j * hd + c * 4 + x] = vf[x];
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * DBK; idx += NT) {
      const int g = idx / DBK;
      const int j = idx % DBK;
      float sv = -INFINITY;
      if (j < nk) {
        const float4* qv = reinterpret_cast<const float4*>(qs + g * hd);
        const float4* kr = reinterpret_cast<const float4*>(ks + j * hdp);
        float part_s = 0.f;
        for (int c = 0; c < hd / 4; ++c) {
          const float4 a = qv[c];
          const float4 bb = kr[c];
          part_s = fmaf(a.x, bb.x, part_s);
          part_s = fmaf(a.y, bb.y, part_s);
          part_s = fmaf(a.z, bb.z, part_s);
          part_s = fmaf(a.w, bb.w, part_s);
        }
        sv = part_s * scale;
      }
      sc[idx] = sv;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NT / 32) {
      float* srow = sc + g * DBK;
      float mx = -INFINITY;
      for (int j = lane; j < DBK; j += 32) mx = fmaxf(mx, srow[j]);
      mx = warp_max(mx);
      const float m_old = mrow[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < DBK; j += 32) {
        const float p = expf(srow[j] - m_new);   // rows past nk give 0
        srow[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        arow[g] = a;
        lrow[g] = lrow[g] * a + sum;
        mrow[g] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * hd; idx += NT) {
      const int g = idx / hd;
      const int d = idx % hd;
      const float* p = sc + g * DBK;
      float a = acc[idx] * arow[g];
      for (int j = 0; j < nk; ++j) a = fmaf(p[j], vs[j * hd + d], a);
      acc[idx] = a;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < G * hd; idx += NT) part.acc[rec0 * hd + idx] = acc[idx];
  for (int g = tid; g < G; g += NT) {
    part.ml[2 * (rec0 + g)] = mrow[g];
    part.ml[2 * (rec0 + g) + 1] = lrow[g];
  }
}

// ================================================================= combine
// one block per (pair, head of the group), one thread per head dim
template <typename T>
__global__ void decode_fwd_combine(Partials part, T* __restrict__ o,
                                   float* __restrict__ lse, int KV, int G,
                                   int hd, int n_split, long long o_b,
                                   long long o_h) {
  const int pair = blockIdx.x;
  const int g = blockIdx.y;
  const int d = threadIdx.x;
  const long long rec = (long long)pair * n_split * G + g;  // split 0
  float mx = -1e30f;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part.ml[2 * (rec + s * G)]);
  float acc = 0.f, sum = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const long long r = rec + (long long)s * G;
    const float a = expf(part.ml[2 * r] - mx);
    acc += a * part.acc[r * hd + d];
    sum += a * part.ml[2 * r + 1];
  }
  const int b = pair / KV;
  const int h = (pair % KV) * G + g;
  o[b * o_b + (long long)h * o_h + d] = from_f32<T>(acc / fmaxf(sum, 1e-30f));
  if (lse != nullptr && d == 0)              // (B, H), H = KV * G
    lse[(long long)b * KV * G + h] = sum > 0.f ? mx + logf(sum) : -INFINITY;
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, Partials part,
               const int* valid_len, int B, int S, int KV, int G,
               int n_split, int rows_per_split, const Strides& st, float scale,
               cudaStream_t stream) {
  using C = Split<HD>;
  static SmemOptIn opt_in;
  if (const cudaError_t e = opt_in(decode_fwd_split_mma<HD>, C::SMEM))
    return e;
  const dim3 grid(B * KV, n_split, (G + 15) / 16);
  decode_fwd_split_mma<HD><<<grid, WARPS * 32, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), part, valid_len, S, KV, G,
      rows_per_split, st, scale);
  return cudaGetLastError();
}

static_assert(Split<256>::SMEM <= MAX_SMEM, "the ring must fit");

#define REPRO_HEAD_DIMS(X) X(16) X(32) X(64) X(80) X(112) X(128) X(160) X(256)

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B,1,H,hd), caches k/v (B,S,KV,hd),
// o (B,1,H,hd), addressed through strides in elements with a contiguous head
// dim; valid_len is a device pointer to one int32. lse: nullptr, or the
// softmax partial's (B, H) f32 log-sum-exp, o then f32. scratch holds
// B * KV * n_split * G * (hd + 2) floats; the splits are rows_per_split rows
// each (n_split * rows_per_split >= S). In bf16 hd is one of REPRO_HEAD_DIMS.
// Launches the split kernel and the combine kernel on CUDA device `device`
// (the tensors'), `stream` one of its streams. Returns a cudaError_t.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const void* valid_len, void* scratch, void* lse, int dtype, int B,
    int S, int H,
    int KV, int hd, int n_split, int rows_per_split,
    long long q_b, long long q_h,
    long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h,
    long long o_b, long long o_h, float scale, void* stream, int device) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || hd % 16 != 0 ||
      hd <= 0 || hd > 1024 || n_split <= 0 ||
      (long long)n_split * rows_per_split < S)
    return (int)cudaErrorInvalidValue;
  const DeviceScope on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  const Strides st{q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h};
  const int G = H / KV;
  const int* vl = static_cast<const int*>(valid_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(scratch);
  const Partials part{acc, acc + (long long)B * KV * n_split * G * hd};
  int err = cudaErrorInvalidValue;
  if (dtype == 0) {
    const int smem = smem_f32(G, hd);
    static SmemOptIn opt_in;
    if (const cudaError_t e = opt_in(decode_fwd_split_f32, MAX_SMEM))
      return e;
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    decode_fwd_split_f32<<<dim3(B * KV, n_split), NT, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), part, vl, S, KV, G, hd, rows_per_split,
        st, scale);
    err = cudaGetLastError();
  } else if (dtype == 1) {
#define REPRO_DECODE_CASE(HD)                                               \
  case HD:                                                                  \
    err = launch_mma<HD>(q, k, v, part, vl, B, S, KV, G, n_split,           \
                         rows_per_split, st, scale, s);                     \
    break;
    switch (hd) {
      REPRO_HEAD_DIMS(REPRO_DECODE_CASE)
      default: return (int)cudaErrorInvalidValue;
    }
#undef REPRO_DECODE_CASE
  }
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KV, G);
  float* lse_out = static_cast<float*>(lse);
  if (dtype == 0 || lse_out != nullptr)
    decode_fwd_combine<float><<<grid, hd, 0, s>>>(
        part, static_cast<float*>(o), lse_out, KV, G, hd, n_split, o_b, o_h);
  else
    decode_fwd_combine<__nv_bfloat16><<<grid, hd, 0, s>>>(
        part, static_cast<__nv_bfloat16*>(o), nullptr, KV, G, hd, n_split,
        o_b, o_h);
  return cudaGetLastError();
}
