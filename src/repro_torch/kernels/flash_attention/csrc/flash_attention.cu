// Causal GQA flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// (_flash_kernel, flash_attention_bhsd). Same function: an online softmax
// with f32 running max m, sum l and accumulator, kv tiles above the causal
// diagonal skipped, kv head = h / G read in place (no repeated KV), the ragged
// edge of S masked, l clamped at 1e-30, output in q's dtype.
//
// What differs from the TPU design: the TPU walks the kv blocks as a
// sequential grid axis carrying m/l/acc in VMEM scratch. Here blocks run in
// parallel and in no order, so one block owns one (batch, head, 64-row q tile)
// and walks its kv tiles in a loop, up to the diagonal. K/V tiles of 32 rows
// are staged in shared memory as f32; each q row is owned by 4 threads, each
// holding a quarter of the head dims (q and the accumulator in registers), so
// a score is a 4-lane dot product closed by two warp shuffles. The kernel
// reads the model layout (B, S, H, hd) through strides, so no transposed or
// padded copy is made, and masks the ragged edge of S itself.
//
// Bound on the H100: at the prefill shapes of the main path it is bound by
// operations (~4 FLOP per q.k pair per head dim, causal half), not bytes.
// This first version does them as scalar f32 FMAs from shared memory, far
// below the tensor cores' bf16 rate; wgmma/TMA tiles are a later change.
#include <math.h>
#include <stdint.h>

#include "../../common.cuh"

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 32;          // kv rows per shared-memory tile
constexpr int TPR = 4;          // threads per q row
constexpr int NT = BQ * TPR;    // threads per block

struct Strides {                // in elements; the head dim is contiguous
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

// NC = head_dim / 16: each of a row's 4 threads holds NC float4 chunks of it,
// chunk c = i * TPR + t covering dims [4c, 4c + 4).
template <typename T, int NC>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          int S, int G, Strides st, float scale) {
  constexpr int HD = 16 * NC;
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int CPR = HD / VEC;         // 16-byte chunks per kv row
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                     // [BK][HD]
  float* vs = smem + BK * HD;           // [BK][HD]

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int t = tid % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int q0 = blockIdx.x * BQ;
  const int qpos = q0 + r;
  const bool row_ok = qpos < S;

  float qr[NC][4];
  float acc[NC][4];
  {
    const T* qrow = q + b * st.q_b + (long long)(row_ok ? qpos : S - 1) * st.q_s
                    + h * st.q_h;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d0 = 4 * (i * TPR + t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qr[i][e] = to_f32(qrow[d0 + e]);
        acc[i][e] = 0.f;
      }
    }
  }

  const int kv_end = min(S, q0 + BQ);  // tiles above the diagonal: none
  const T* kbase = k + b * st.k_b + kvh * st.k_h;
  const T* vbase = v + b * st.v_b + kvh * st.v_h;
  float m = -1e30f;
  float l = 0.f;

  for (int kb = 0; kb < kv_end; kb += BK) {
    __syncthreads();                    // the previous tile is consumed
    for (int idx = tid; idx < BK * CPR; idx += NT) {
      const int j = idx / CPR;
      const int c = idx % CPR;
      float kf[VEC], vf[VEC];
      if (kb + j < S) {
        load16(kbase + (long long)(kb + j) * st.k_s + c * VEC, kf);
        load16(vbase + (long long)(kb + j) * st.v_s + c * VEC, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) { kf[e] = 0.f; vf[e] = 0.f; }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[j * HD + c * VEC + e] = kf[e];
        vs[j * HD + c * VEC + e] = vf[e];
      }
    }
    __syncthreads();

    float s[BK];
    float mt = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * HD);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float4 kk = kr[i * TPR + t];
        part = fmaf(qr[i][0], kk.x, part);
        part = fmaf(qr[i][1], kk.y, part);
        part = fmaf(qr[i][2], kk.z, part);
        part = fmaf(qr[i][3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kpos = kb + j;
      const bool ok = kpos < S && kpos <= qpos;
      s[j] = ok ? part * scale : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float alpha = expf(m - mt);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - mt);           // masked entries give exactly 0
      psum += s[j];
    }
    l = l * alpha + psum;
    m = mt;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vs + j * HD);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float4 vv = vr[i * TPR + t];
        acc[i][0] = fmaf(s[j], vv.x, acc[i][0]);
        acc[i][1] = fmaf(s[j], vv.y, acc[i][1]);
        acc[i][2] = fmaf(s[j], vv.z, acc[i][2]);
        acc[i][3] = fmaf(s[j], vv.w, acc[i][3]);
      }
    }
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + b * st.o_b + (long long)qpos * st.o_s + h * st.o_h;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d0 = 4 * (i * TPR + t);
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[d0 + e] = from_f32<T>(acc[i][e] / denom);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int G, const Strides& st, float scale,
                   cudaStream_t stream) {
  const int smem = 2 * BK * 16 * NC * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<T, NC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, G, st, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* o, int B, int S, int H, int G, const Strides& st,
                     float scale, cudaStream_t stream) {
#define REPRO_FLASH_CASE(NC) \
  case NC: return launch<T, NC>(q, k, v, o, B, S, H, G, st, scale, stream);
  switch (hd / 16) {
    REPRO_FLASH_CASE(1) REPRO_FLASH_CASE(2) REPRO_FLASH_CASE(3) REPRO_FLASH_CASE(4)
    REPRO_FLASH_CASE(5) REPRO_FLASH_CASE(6) REPRO_FLASH_CASE(7) REPRO_FLASH_CASE(8)
    REPRO_FLASH_CASE(9) REPRO_FLASH_CASE(10) REPRO_FLASH_CASE(11) REPRO_FLASH_CASE(12)
    REPRO_FLASH_CASE(13) REPRO_FLASH_CASE(14) REPRO_FLASH_CASE(15) REPRO_FLASH_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B,S,H,hd), k/v (B,S,KV,hd),
// o (B,S,H,hd), each addressed through its (batch, seq, head) strides in
// elements with a contiguous head dim. Returns a cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int S, int H, int KV, int hd,
    long long q_b, long long q_s, long long q_h,
    long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h,
    long long o_b, long long o_s, long long o_h,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || hd % 16 != 0 ||
      hd < 16 || hd > 256)
    return (int)cudaErrorInvalidValue;
  const Strides st{q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h};
  const int G = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(hd, q, k, v, o, B, S, H, G, st, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(hd, q, k, v, o, B, S, H, G, st, scale,
                                        s);
  return (int)cudaErrorInvalidValue;
}
