// Single-query GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/decode_attention/decode_attention.py
// (_decode_kernel, decode_attention_bhd). Same function: each query head
// attends to the first valid_len rows of its kv head's cache with an online
// softmax in f32; rows at or past valid_len are never read.
//
// What differs from the TPU design: on the TPU valid_len arrived by scalar
// prefetch and the kv blocks were a sequential grid axis. Here one block owns
// one (batch, kv head) and serves all G query heads of that kv head, so each
// K/V row is read from device memory once, not G times; it walks the cache in
// 64-row tiles staged in shared memory and stops at valid_len, which it reads
// itself from a device pointer (the cache index + 1), so the host never waits
// on the device. The cache is read in its stored layout (B, S, KV, hd) through
// strides: no transposed copy of the cache is made per step.
//
// Bound on the H100: bytes. A step reads valid_len rows of K and V once; the
// arithmetic is 4 * G FLOP per cached element. With one block per
// (batch, kv head) only B * KV SMs work, so at small batch launch latency and
// per-SM bandwidth dominate; splitting the cache across SMs with a combine
// pass is a later change.
#include <math.h>
#include <stdint.h>

#include "../../common.cuh"

namespace {

constexpr int DBK = 64;         // cache rows per shared-memory tile
constexpr int NT = 256;         // threads per block
constexpr int MAX_SMEM = 232448;

struct Strides {                // in elements; the head dim is contiguous
  long long q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h;
};

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

int smem_bytes(int G, int hd) {
  return (2 * G * hd + DBK * (hd + 4) + DBK * hd + G * DBK + 3 * G) *
         (int)sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(NT)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           const int* __restrict__ valid_len, int S, int KV, int G, int hd,
           Strides st, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) float smem[];
  const int hdp = hd + 4;               // padded K rows: conflict-free float4 reads
  float* qs = smem;                     // [G][hd]
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
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int h0 = kvh * G;
  const int valid = min(max(*valid_len, 0), S);
  const int cpr = hd / VEC;

  for (int idx = tid; idx < G * hd; idx += NT) {
    const int g = idx / hd;
    const int d = idx % hd;
    qs[idx] = to_f32(q[b * st.q_b + (long long)(h0 + g) * st.q_h + d]);
    acc[idx] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    mrow[g] = -1e30f;
    lrow[g] = 0.f;
  }
  const T* kbase = k + b * st.k_b + kvh * st.k_h;
  const T* vbase = v + b * st.v_b + kvh * st.v_h;

  for (int kb = 0; kb < valid; kb += DBK) {
    const int nk = min(DBK, valid - kb);
    __syncthreads();                    // the previous tile is consumed
    for (int idx = tid; idx < nk * cpr; idx += NT) {
      const int j = idx / cpr;
      const int c = idx % cpr;
      float kf[VEC], vf[VEC];
      load16(kbase + (long long)(kb + j) * st.k_s + c * VEC, kf);
      load16(vbase + (long long)(kb + j) * st.v_s + c * VEC, vf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[j * hdp + c * VEC + e] = kf[e];
        vs[j * hd + c * VEC + e] = vf[e];
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
        float part = 0.f;
        for (int c = 0; c < hd / 4; ++c) {
          const float4 a = qv[c];
          const float4 bb = kr[c];
          part = fmaf(a.x, bb.x, part);
          part = fmaf(a.y, bb.y, part);
          part = fmaf(a.z, bb.z, part);
          part = fmaf(a.w, bb.w, part);
        }
        sv = part * scale;
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

  for (int idx = tid; idx < G * hd; idx += NT) {
    const int g = idx / hd;
    const int d = idx % hd;
    o[b * st.o_b + (long long)(h0 + g) * st.o_h + d] =
        from_f32<T>(acc[idx] / fmaxf(lrow[g], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* valid_len, int B, int S, int KV, int G, int hd,
                   const Strides& st, float scale, cudaStream_t stream) {
  const int smem = smem_bytes(G, hd);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decode_fwd<T><<<B * KV, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), valid_len, S, KV, G, hd,
      st, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B,1,H,hd), caches k/v (B,S,KV,hd),
// o (B,1,H,hd), addressed through strides in elements with a contiguous head
// dim; valid_len is a device pointer to one int32. Returns a cudaError_t.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const void* valid_len, int dtype, int B, int S, int H, int KV, int hd,
    long long q_b, long long q_h,
    long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h,
    long long o_b, long long o_h, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || hd % 16 != 0 || hd <= 0)
    return (int)cudaErrorInvalidValue;
  const Strides st{q_b, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_h};
  const int G = H / KV;
  const int* vl = static_cast<const int*>(valid_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, vl, B, S, KV, G, hd, st, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, vl, B, S, KV, G, hd, st,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}
