// Causal GQA flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// (_flash_kernel, flash_attention_bhsd). Same function: an online softmax
// with f32 running max m, sum l and accumulator, kv tiles above the causal
// diagonal skipped, kv head = h / G read in place (no repeated KV), the ragged
// edge of S masked (-inf scores, m starting at -1e30), l clamped at 1e-30,
// output in q's dtype. The TPU walks the kv blocks as a sequential grid axis
// carrying m/l/acc in VMEM scratch; here a block owns a q tile of one
// (batch, head) and walks its kv tiles in a loop, up to the diagonal. Both
// kernels read the model layout (B, S, H, hd) in place: no transposed or
// padded copy is made.
//
// Bound on the H100: at the GQA prefill shapes of the main path it is bound
// by operations (4 FLOP per (q, k) pair per head dim, causal half), not
// bytes; at MLA's (16 heads over 16 KV heads, q/k 192, v 128) narrowly by
// bytes, since every head has its own K and V.
//
// bfloat16: flash_fwd_wgmma, for the tensor cores. A block owns a 128-row q
// tile of one (batch, head); blocks are numbered so that the G heads of a kv
// head, then the q tiles of one (batch, kv head), run side by side and share
// its K/V tiles in L2, and each group's heaviest tiles (the causal ones
// nearest the end of S) start first. A block holds two consumer warpgroups of
// 64 q rows each and one producer warpgroup, which hands most of its registers
// to the consumers (setmaxnreg). One producer thread loads Q and then the K
// and V tiles (BK rows) by TMA into two-stage rings in shared memory (one for
// K, one for V), each stage guarded by a "full" mbarrier (bytes arrived) and
// an "empty" one (all 8 consumer warps done). The head dim is loaded in
// 64-column slabs under the 128-byte swizzle (a TMA box is at most 128 bytes
// wide under it); TMA fills the columns past hd and the rows past S with
// zeros, so Q.K^T stays exact and the ragged tile needs only the mask. Each
// warpgroup computes S = Q.K^T with wgmma (both operands in shared memory, f32
// accumulators), the online softmax in f32 registers, rounds P to bf16 in
// registers (the one numeric change from the scalar version) and adds P.V with
// wgmma (A from registers, V read MN-major through the transpose flag); a
// tile's Q.K^T and the previous tile's P.V are issued together. O / l is
// stored from registers; rows past S are dropped.
//
// float32: flash_fwd, the first version's scalar design, kept because it
// holds the algorithm at 2e-5 and the full-width f32 logits at 1e-4; TF32
// tensor cores keep about three digits and would break both. K/V tiles of 32
// rows are staged in shared memory as f32; each q row is owned by 4 threads,
// each holding a quarter of the head dims, so a score is a 4-lane dot product
// closed by two warp shuffles.
//
// Head widths: REPRO_HEAD_DIMS below, pairs (query/key width, value width).
// Equal widths for the ported configs' GQA (64, 80, 112, 128, 160, 256) and
// the smoke configs and tests (16, 32); (192, 128) for DeepSeek MLA's
// prefill (nope 128 + rope 64 against a value head of 128). Q.K^T runs over
// the first width, the O accumulator, P.V and V's tiles over the second: V
// is not padded to q's width.
#include <math.h>
#include <stdint.h>

#include <cudaTypedefs.h>

#include "../../common.cuh"
#include "../../hopper.cuh"

namespace {

struct Strides {                // in elements; the head dim is contiguous
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

// ================================================================ bfloat16
constexpr int WG_ROWS = 64;                 // q rows per consumer warpgroup
constexpr int BQ_TC = 2 * WG_ROWS;          // q rows per block
constexpr int NT_TC = 3 * 128;              // two consumer warpgroups + producer
constexpr int PRODUCER_REGS = 40;           // per thread, after setmaxnreg:
constexpr int CONSUMER_REGS = 232;          // 128 x 40 + 256 x 232 <= 65,536
constexpr int STAGES = 2;
constexpr int MAX_SMEM = 232448;            // opt-in shared memory per block
constexpr int SLAB_ROW = 128;               // bytes of one 64-column slab row

// HD: the query/key width; HDV: the value (and output) width
template <int HD, int HDV>
struct Tile {
  static constexpr int SLABS = (HD + 63) / 64;      // of Q and K
  static constexpr int V_SLABS = (HDV + 63) / 64;
  static constexpr int BK = HD <= 128 ? 128 : 64;   // kv rows per tile
  static constexpr int Q_WG = SLABS * WG_ROWS * SLAB_ROW;  // one warpgroup's Q
  static constexpr int K_TILE = SLABS * BK * SLAB_ROW;
  static constexpr int V_TILE = V_SLABS * BK * SLAB_ROW;
  static constexpr int SMEM = 1024 + 2 * Q_WG + STAGES * (K_TILE + V_TILE)
                              + 128;
};

// The work of one block: a 128-row q tile of one (batch, head). Blocks are
// numbered in the order (batch, kv head, q tile from the last, head), so the
// G heads of a kv head, then the q tiles of one (batch, kv head), run side by
// side and share its K/V tiles in L2, and each group's heaviest tiles (the
// causal ones nearest the end of S) start first.
struct Item {
  int b, h, kvh, q0, n_tiles;
};

template <int BK>
__device__ __forceinline__ Item item_at(int w, int S, int KV, int G) {
  const int n_qt = (S + BQ_TC - 1) / BQ_TC;
  Item it;
  const int g = w % G;
  int r = w / G;
  const int qt = n_qt - 1 - r % n_qt;
  r /= n_qt;
  it.kvh = r % KV;
  it.b = r / KV;
  it.h = it.kvh * G + g;
  it.q0 = qt * BQ_TC;
  it.n_tiles = (min(S, it.q0 + BQ_TC) + BK - 1) / BK;
  return it;
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; -inf gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one S tile (wgmma's accumulator layout: element 4j + 2i
// + e is row `row0 + 8i`, column kv0 + 8j + col0 + e): masks columns past the
// row (causal) or past S where `edge`, turns the raw scores s into
// P = 2^(s * scale_log2 - m), updates m (in the log2 domain) and this
// thread's share of l, and returns each row's rescale of O in alpha.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int kv0, int row0, int col0,
                                             int S, bool edge,
                                             float scale_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (edge) {
          const int col = kv0 + 8 * j + col0 + e;
          if (col > row || col >= S) s[4 * j + 2 * i + e] = -INFINITY;
        }
        mx = fmaxf(mx, s[4 * j + 2 * i + e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx * scale_log2);
    alpha[i] = ex2(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(s[4 * j + 2 * i + e], scale_log2, -m_new));
        s[4 * j + 2 * i + e] = p;                  // masked: 0
        sum += p;
      }
    }
    l[i] = l[i] * alpha[i] + sum;
    m[i] = m_new;
  }
}

// P as bf16 A fragments: the k16 block kk of P is the accumulator's column
// blocks 2kk and 2kk + 1
template <int BK>
__device__ __forceinline__ void p_fragments(const float (&s)[BK / 2],
                                            uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(NT_TC, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, long long o_b, long long o_s,
                long long o_h, int S, int KV, int G, float scale_log2) {
  using T = Tile<HD, HDV>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: align every tile to it
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + 2 * T::Q_WG;                 // [STAGES][SLABS][BK][128 B]
  uint8_t* vs = ks + STAGES * T::K_TILE;          // [STAGES][V_SLABS][BK][128 B]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * T::V_TILE);
  uint64_t* k_full = q_full + 1;                  // [STAGES] each
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const Item it = item_at<BK>(blockIdx.x, S, KV, G);
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);                  // one arrival per warp
      mbar_init(&v_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    // gives its registers to the consumers; one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * T::Q_WG);
      for (int x = 0; x < 2; ++x)
        for (int s = 0; s < T::SLABS; ++s)
          tma_load_4d(qs + x * T::Q_WG + s * WG_ROWS * SLAB_ROW, &tq, q_full,
                      64 * s, it.h, it.q0 + WG_ROWS * x, it.b);
      for (int t = 0; t < it.n_tiles; ++t) {
        const int st = t % STAGES;
        const int parity = (t / STAGES - 1) & 1;
        if (t >= STAGES) mbar_wait(&k_empty[st], parity);
        mbar_expect_tx(&k_full[st], T::K_TILE);
        for (int s = 0; s < T::SLABS; ++s)
          tma_load_4d(ks + st * T::K_TILE + s * BK * SLAB_ROW, &tk,
                      &k_full[st], 64 * s, it.kvh, t * BK, it.b);
        if (t >= STAGES) mbar_wait(&v_empty[st], parity);
        mbar_expect_tx(&v_full[st], T::V_TILE);
        for (int s = 0; s < T::V_SLABS; ++s)
          tma_load_4d(vs + st * T::V_TILE + s * BK * SLAB_ROW, &tv,
                      &v_full[st], 64 * s, it.kvh, t * BK, it.b);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    // wgmma's accumulator layout: warp w of the warpgroup holds rows
    // 16w + lane/4 (elements 4j, 4j+1) and 16w + lane/4 + 8 (4j+2, 4j+3) of
    // columns 8j + 2 (lane % 4) + {0, 1}.
    const int row0 = it.q0 + WG_ROWS * wg + 16 * (warp % 4) + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint8_t* qw = qs + wg * T::Q_WG;

    float o_acc[HDV / 2];
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) o_acc[i] = 0.f;
    float s[BK / 2];
    uint32_t pa[BK / 16][4];
    float m[2] = {-1e30f, -1e30f};
    float l[2] = {0.f, 0.f};                      // this thread's share
    float alpha[2];

    // S = Q K^T for the tile in stage st, issued and committed
    auto issue_qk = [&](int st) {
      const uint8_t* kt = ks + st * T::K_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk % 4) * 32;            // k16 step within a slab
        wgmma_ss<BK>(s,
                     desc_sw128(qw + (kk / 4) * WG_ROWS * SLAB_ROW + off, 16,
                                1024),
                     desc_sw128(kt + (kk / 4) * BK * SLAB_ROW + off, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
    };
    // O += P V for the tile in stage st, issued and committed
    auto issue_pv = [&](int st) {
      const uint8_t* vt = vs + st * T::V_TILE;
      wgmma_fence();
      fence_regs(o_acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<HDV>(o_acc, pa[kk],
                     desc_sw128(vt + kk * 16 * SLAB_ROW, BK * SLAB_ROW, 1024));
      wgmma_commit();
    };
    auto edge = [&](int t) {          // does tile t reach the diagonal or S?
      return t * BK + BK - 1 > it.q0 + WG_ROWS * wg || t * BK + BK > S;
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // Tile t's Q K^T and tile t-1's P V are issued together; the softmax
    // waits for the first, O's rescale for the second. K's stage is freed
    // as soon as Q K^T is done, V's after P V.
    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(s);
    release(&k_empty[0]);
    softmax_tile<BK>(s, m, l, alpha, 0, row0, col0, S, edge(0), scale_log2);
    p_fragments<BK>(s, pa);
    for (int t = 1; t < it.n_tiles; ++t) {
      const int st = t % STAGES;
      const int sp = (t - 1) % STAGES;
      mbar_wait(&k_full[st], (t / STAGES) & 1);
      issue_qk(st);
      mbar_wait(&v_full[sp], ((t - 1) / STAGES) & 1);
      issue_pv(sp);
      wgmma_wait<1>();                            // Q K_t^T is done
      fence_regs(s);
      release(&k_empty[st]);
      softmax_tile<BK>(s, m, l, alpha, t * BK, row0, col0, S, edge(t),
                       scale_log2);
      wgmma_wait<0>();                            // P V_(t-1) is done
      fence_regs(o_acc);
      release(&v_empty[sp]);
#pragma unroll
      for (int j = 0; j < HDV / 8; ++j) {
        o_acc[4 * j] *= alpha[0];
        o_acc[4 * j + 1] *= alpha[0];
        o_acc[4 * j + 2] *= alpha[1];
        o_acc[4 * j + 3] *= alpha[1];
      }
      p_fragments<BK>(s, pa);
    }
    const int sl = (it.n_tiles - 1) % STAGES;
    mbar_wait(&v_full[sl], ((it.n_tiles - 1) / STAGES) & 1);
    issue_pv(sl);
    wgmma_wait<0>();
    fence_regs(o_acc);

    // epilogue: O / l straight from registers, rows past S dropped
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] = 1.f / fmaxf(l[i], 1e-30f);
      const int row = row0 + 8 * i;
      if (row < S) {
        __nv_bfloat16* orow = o + it.b * o_b + (long long)row * o_s
                              + it.h * o_h + col0;
#pragma unroll
        for (int j = 0; j < HDV / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(
              o_acc[4 * j + 2 * i] * l[i], o_acc[4 * j + 2 * i + 1] * l[i]);
      }
    }
  }
}

// cuTensorMapEncodeTiled from libcuda, through the runtime's entry-point
// query (no link against libcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &res)
        != cudaSuccess || res != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) != cudaSuccess
        || res != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A bf16 tensor (B, S, heads, hd) with the given element strides as a 4-d
// tensor map (hd, heads, S, B), boxes of 64 columns x `rows` rows of one
// head, 128-byte swizzle, zeros outside the tensor.
int make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S,
             int B, long long s_h, long long s_s, long long s_b, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return REPRO_ERR_TENSOR_MAP;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_s * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : REPRO_ERR_TENSOR_MAP;
}

template <int HD, int HDV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int KV, const Strides& st, float scale,
                 cudaStream_t stream) {
  using T = Tile<HD, HDV>;
  // the opt-in to more than 48 KB of shared memory, once per device
  static SmemOptIn opt_in;
  if (const cudaError_t e = opt_in(flash_fwd_wgmma<HD, HDV>, T::SMEM))
    return e;
  CUtensorMap tq, tk, tv;
  int err;
  if ((err = make_map(&tq, q, HD, H, S, B, st.q_h, st.q_s, st.q_b, WG_ROWS)) ||
      (err = make_map(&tk, k, HD, KV, S, B, st.k_h, st.k_s, st.k_b, T::BK)) ||
      (err = make_map(&tv, v, HDV, KV, S, B, st.v_h, st.v_s, st.v_b, T::BK)))
    return err;
  const int n_items = B * H * ((S + BQ_TC - 1) / BQ_TC);
  flash_fwd_wgmma<HD, HDV><<<n_items, NT_TC, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st.o_b, st.o_s, st.o_h, S,
      KV, H / KV, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

static_assert(Tile<256, 256>::SMEM <= MAX_SMEM &&
              Tile<192, 128>::SMEM <= MAX_SMEM &&
              Tile<160, 160>::SMEM <= MAX_SMEM &&
              Tile<128, 128>::SMEM <= MAX_SMEM,
              "the tiles must fit in shared memory");

// ================================================================= float32
constexpr int BQ = 64;          // q rows per block
constexpr int BK = 32;          // kv rows per shared-memory tile
constexpr int TPR = 4;          // threads per q row
constexpr int NT = BQ * TPR;    // threads per block

// NC = head_dim / 16 (NCV = the value width / 16): each of a row's 4
// threads holds NC float4 chunks of q and NCV of the output, chunk
// c = i * TPR + t covering dims [4c, 4c + 4).
template <int NC, int NCV>
__global__ void __launch_bounds__(NT)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          int S, int G, Strides st, float scale) {
  constexpr int HD = 16 * NC;
  constexpr int HDV = 16 * NCV;
  constexpr int VEC = 4;                // floats per 16-byte load
  constexpr int CPR = HD / VEC;         // 16-byte chunks per k row
  constexpr int CPRV = HDV / VEC;       // and per v row
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                     // [BK][HD]
  float* vs = smem + BK * HD;           // [BK][HDV]

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
  float acc[NCV][4];
  {
    const float* qrow = q + b * st.q_b
                        + (long long)(row_ok ? qpos : S - 1) * st.q_s
                        + h * st.q_h;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d0 = 4 * (i * TPR + t);
#pragma unroll
      for (int e = 0; e < 4; ++e) qr[i][e] = qrow[d0 + e];
    }
#pragma unroll
    for (int i = 0; i < NCV; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    }
  }

  const int kv_end = min(S, q0 + BQ);  // tiles above the diagonal: none
  const float* kbase = k + b * st.k_b + kvh * st.k_h;
  const float* vbase = v + b * st.v_b + kvh * st.v_h;
  float m = -1e30f;
  float l = 0.f;

  for (int kb = 0; kb < kv_end; kb += BK) {
    __syncthreads();                    // the previous tile is consumed
    for (int idx = tid; idx < BK * CPR; idx += NT) {
      const int j = idx / CPR;
      const int c = idx % CPR;
      float kf[VEC] = {0.f, 0.f, 0.f, 0.f};
      if (kb + j < S) load16(kbase + (long long)(kb + j) * st.k_s + c * VEC, kf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ks[j * HD + c * VEC + e] = kf[e];
    }
    for (int idx = tid; idx < BK * CPRV; idx += NT) {
      const int j = idx / CPRV;
      const int c = idx % CPRV;
      float vf[VEC] = {0.f, 0.f, 0.f, 0.f};
      if (kb + j < S) load16(vbase + (long long)(kb + j) * st.v_s + c * VEC, vf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) vs[j * HDV + c * VEC + e] = vf[e];
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
    for (int i = 0; i < NCV; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vs + j * HDV);
#pragma unroll
      for (int i = 0; i < NCV; ++i) {
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
    float* orow = o + b * st.o_b + (long long)qpos * st.o_s + h * st.o_h;
#pragma unroll
    for (int i = 0; i < NCV; ++i) {
      const int d0 = 4 * (i * TPR + t);
#pragma unroll
      for (int e = 0; e < 4; ++e) orow[d0 + e] = acc[i][e] / denom;
    }
  }
}

template <int HD, int HDV>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KV, const Strides& st, float scale,
               cudaStream_t stream) {
  constexpr int SMEM = BK * (HD + HDV) * (int)sizeof(float);
  static SmemOptIn opt_in;
  if (const cudaError_t e = opt_in(flash_fwd<HD / 16, HDV / 16>, SMEM))
    return e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<HD / 16, HDV / 16><<<grid, NT, SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H / KV, st,
      scale);
  return cudaGetLastError();
}

#define REPRO_HEAD_DIMS(X)                                                 \
  X(16, 16) X(32, 32) X(64, 64) X(80, 80) X(112, 112) X(128, 128)         \
  X(160, 160) X(256, 256) X(192, 128)

int dispatch(int dtype, int hd, int hdv, const void* q, const void* k,
             const void* v, void* o, int B, int S, int H, int KV,
             const Strides& st, float scale, cudaStream_t stream) {
#define REPRO_FLASH_CASE(HD, HDV)                                             \
  if (hd == HD && hdv == HDV)                                                 \
    return dtype == 0                                                         \
        ? launch_f32<HD, HDV>(q, k, v, o, B, S, H, KV, st, scale, stream)     \
        : launch_wgmma<HD, HDV>(q, k, v, o, B, S, H, KV, st, scale, stream);
  REPRO_HEAD_DIMS(REPRO_FLASH_CASE)
#undef REPRO_FLASH_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B,S,H,hd), k (B,S,KV,hd),
// v (B,S,KV,hd_v), o (B,S,H,hd_v), each addressed through its (batch, seq,
// head) strides in elements with a contiguous head dim; in bf16 every
// pointer and stride is a multiple of 16 bytes (TMA). (hd, hd_v) is one of
// REPRO_HEAD_DIMS. The kernel runs on CUDA device `device` (the tensors'),
// `stream` one of its streams. Returns a cudaError_t, or
// REPRO_ERR_TENSOR_MAP.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int S, int H, int KV, int hd, int hd_v,
    long long q_b, long long q_s, long long q_h,
    long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h,
    long long o_b, long long o_s, long long o_h,
    float scale, void* stream, int device) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const DeviceScope on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  const Strides st{q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h};
  return dispatch(dtype, hd, hd_v, q, k, v, o, B, S, H, KV, st, scale,
                  static_cast<cudaStream_t>(stream));
}
