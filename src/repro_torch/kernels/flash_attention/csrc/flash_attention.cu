// Flash-attention forward for Hopper (sm_90a), two paths:
//  * the tensor-core path, for bf16 with head_dim 64, 128 or 192 (every
//    bf16 prefill the port serves, MLA's 192 included): wgmma products,
//    TMA loads, fp32 softmax;
//  * the CUDA-core path, for fp32 and for any other head_dim <= 256: fp32
//    FMAs, as the first version of this kernel.
// The caller (kernel.py) chooses the path from the type and head_dim.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd
// (the Pallas TPU kernel _flash_fwd_kernel). Both paths read q, k, v and
// write o in the models' layout, in place and with their strides:
//     q (B, Sq, Hq, dh), k/v (B, Skv, Hkv, dh), o (B, Sq, Hq, dh),
// Hq % Hkv == 0; query head h reads KV head h / (Hq / Hkv), so K and V are
// never folded, transposed or repeated in memory. Per query row both keep
// the reference's online softmax: a running max m (NEG_INF = -1e30 at the
// start), a running sum l and an fp32 accumulator, rescaled per KV tile;
// scores are (q . k) / sqrt(dh); the causal mask is aligned top-left (key
// kpos attends query qpos iff kpos <= qpos, both counted from 0), and KV
// tiles wholly above the diagonal are never loaded. The output is
// acc / max(l, 1e-30), cast to the input type. Beside it both paths write
// each row's log-sum-exp for the backward kernel (flash_attention_bwd.cu):
//     lse = log(sum_j exp(scale * s_j))   (natural log, scaled scores)
//         = scale * m + log(max(l, 1e-30)),
// fp32, one per (b, query head, query row), in a contiguous (B, Hq, Sq)
// tensor, so that P = exp(scale * s - lse) is recomputed without l or m.
//
// Bound on an H100 SXM: 4 * Hq * B * dh * pairs operations (pairs =
// unmasked (q, k) pairs) against q + k + v + o bytes. At starcoder2-3b's
// 1536-wide prefill (B = 4, Hq = 24, Hkv = 2, dh = 128, bf16, causal) that
// is 58 GFLOP against 82 MB: operations bound it (0.059 ms at 989 TFLOP/s
// on the tensor cores, 0.024 ms by bytes); at deepseek-v3's MLA prefill
// (B = 4, 128 heads, dh 192, S = 1536, causal) 464 GFLOP, 0.469 ms.
//
// Tensor-core path, FA3-style. One block owns one (b, query head, 128-row
// query tile) and 384 threads: two consumer warpgroups of 64 query rows
// each and one producer warpgroup, which gives its registers up
// (setmaxnreg 40) to the consumers (setmaxnreg 232).
//  * The producer's first lane loads the Q tile once by TMA, then streams
//    128-key tiles of K and V by TMA into a ring of three stages in dynamic
//    shared memory (224 KB at dh 128). At dh 192 a 128-key stage of K and
//    V is 96 KB, so three would not fit beside the 48 KB Q tile; there the
//    tiles are 64 keys (three stages 144 KB, 193 KB in all). A "full"
//    mbarrier per stage counts the bytes in, an "empty" one per stage
//    counts the eight consumer warps out, so the tiles ahead are in flight
//    while a step computes.
//  * TMA writes every tile in the 128-byte swizzle: rows of 64 bf16 (128
//    bytes), the 16-byte chunks of row r XORed with r % 8, one region of
//    rows per 64 columns of dh; the wgmma descriptors read that layout
//    (SWIZZLE_128B, 1024 bytes between 8-row groups), so the two agree by
//    construction and no thread touches the tiles on their way in.
//  * S = Q K^T: wgmma m64n128k16 (m64n64k16 for 64-key tiles), both
//    operands from shared memory, K as the K-major B operand; fp32 in
//    registers.
//  * The online softmax runs in registers on S: exp2 with scale * log2(e)
//    folded into the scores, the row max across the four threads of a row
//    by two shuffles, the row sum kept per thread and combined at the end.
//    Only tiles that the diagonal or the Skv edge cross are masked. The max
//    is taken on the raw scores, so a score costs one FFMA and one MUFU.EX2.
//  * O += P V: wgmma m64n{dh}k16 with P cast to bf16 in registers as the A
//    operand (the S accumulator's layout is the A fragment's) and V read
//    from shared memory as the MN-major B operand (the transpose bit).
//  * Overlap: step t issues S_t and P_{t-1} V_{t-1} together and runs
//    tile t's softmax while the second is on the tensor cores (O is
//    rescaled and P_t packed after it); and the two warpgroups take turns
//    to issue (ping-pong), so one's softmax runs under the other's
//    products.
//  * The epilogue divides by max(l, 1e-30), writes the warpgroup's 64 rows
//    in bf16 over its own rows of the Q tile, in the same swizzle, and
//    stores them with one TMA store per 64 columns; TMA clips rows >= Sq.
//    m is the raw scores' max and l sums exp2((s - m) * scale * log2 e), so
//    the row's first thread writes lse = m * scale + log(l) in natural log.
//  * Any Sq, Skv >= 1: TMA fills rows past the tensor's end with zeros and
//    keys >= Skv are masked to NEG_INF. Query tiles run from the bottom of
//    the causal triangle up, so the longest blocks start first.
// In design runs on an NVIDIA H100 80GB HBM3 the in-warpgroup overlap paid
// off only with the producer's register handover (without it, it spilled
// at the 168 registers ptxas gives 288 threads), ping-pong added a little
// on top, and a third stage or ping-pong alone gained nothing. Not done
// yet: a persistent grid, so one tile's epilogue overlaps the next loads.
//
// The TMA, mbarrier, swizzle-descriptor and wgmma wrappers are in
// hopper.cuh, shared with the backward (flash_attention_bwd.cu).
//
// CUDA-core path (fp32, or bf16 with head_dim not 64, 128 or 192). One block
// owns one (b, query head, 64-row q tile) and loops over 32-row KV tiles
// staged in shared memory as fp32; two threads share a query row, each
// computing 16 of a tile's 32 scores and half of the output columns; the
// row's max and sum are combined with one shuffle each, and P goes through
// a per-warp region of shared memory. Every ragged edge is masked (dh <=
// 256 is padded with zeros to 64, 128, 192 or 256 in shared memory; 142 KB
// of it at 256).

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Strides, in elements, of the (B, S, H) dimensions of q, k, v and o; the
// head dimension is contiguous.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// ---------------------------------------------------------------------------
// CUDA-core path

namespace simt {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per KV tile
constexpr int THREADS = 2 * BQ;     // two threads per query row
constexpr int KH = BK / 2;          // scores per thread per tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory layout, in floats: Q (BQ x LD), K (BK x LD), V (BK x LD),
// P (BQ x (BK + 1)). LD = DH + 4 keeps 16-byte alignment and moves
// neighbouring rows to other banks.
template <int DH>
constexpr int smem_floats() {
  return (BQ + 2 * BK) * (DH + 4) + BQ * (BK + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides st, int Hq, int group,
                 int Sq, int Skv, int dh, int causal, float scale) {
  constexpr int LD = DH + 4;
  constexpr int NC = DH / 8;        // float4 chunks of output per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x;
  const int r = tid >> 1;           // query row within the tile
  const int h = tid & 1;            // which half of the row's work
  const int b = blockIdx.y / Hq;
  const int head = blockIdx.y % Hq;
  const int kvh = head / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int qpos = q0 + r;

  const T* qb = q + b * st.q[0] + head * st.q[2];
  const T* kb = k + b * st.k[0] + kvh * st.k[2];
  const T* vb = v + b * st.v[0] + kvh * st.v[2];

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int rr = i / DH, c = i % DH;
    Qs[rr * LD + c] = (q0 + rr < Sq && c < dh)
                          ? to_float(qb[(q0 + rr) * st.q[1] + c]) : 0.f;
  }

  // keys that any row of this tile may attend: [0, kv_end)
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + BQ, Sq));
  const int n_tiles = (kv_end + BK - 1) / BK;

  float m_i = NEG_INF, l_i = 0.f;
  float acc[NC * 4];
#pragma unroll
  for (int c = 0; c < NC * 4; ++c) acc[c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();                // last tile's K/V reads are done
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int rr = i / DH, c = i % DH;
      const bool in = k0 + rr < Skv && c < dh;
      Ks[rr * LD + c] = in ? to_float(kb[(k0 + rr) * st.k[1] + c]) : 0.f;
      Vs[rr * LD + c] = in ? to_float(vb[(k0 + rr) * st.v[1] + c]) : 0.f;
    }
    __syncthreads();

    // scores of this thread's keys k0 + 2 * j + h, j < KH
    float s[KH];
#pragma unroll
    for (int j = 0; j < KH; ++j) s[j] = 0.f;
    for (int d = 0; d < DH; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[r * LD + d]);
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&Ks[(2 * j + h) * LD + d]);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }
    float m_t = NEG_INF;
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const int kpos = k0 + 2 * j + h;
      s[j] = (kpos < Skv && !(causal && kpos > qpos)) ? s[j] * scale
                                                      : NEG_INF;
      m_t = fmaxf(m_t, s[j]);
    }
    m_t = fmaxf(m_t, __shfl_xor_sync(0xffffffffu, m_t, 1));
    const float m_new = fmaxf(m_i, m_t);
    const float corr = expf(m_i - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const float p = expf(s[j] - m_new);
      Ps[r * (BK + 1) + 2 * j + h] = p;
      p_sum += p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    l_i = l_i * corr + p_sum;
    m_i = m_new;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[c] *= corr;
    __syncwarp();                   // the row's P is written by its pair

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float p = Ps[r * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(
            &Vs[j * LD + 4 * (2 * c + h)]);
        acc[4 * c + 0] = fmaf(p, vv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    __syncwarp();                   // P is read before the next tile writes
  }

  if (qpos < Sq) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    T* ob = o + b * st.o[0] + qpos * st.o[1] + head * st.o[2];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * (2 * c + h) + e;
        if (col < dh) ob[col] = from_float<T>(acc[4 * c + e] * inv);
      }
    }
    if (h == 0)
      lse[(static_cast<long long>(b) * Hq + head) * Sq + qpos] =
          m_i + logf(fmaxf(l_i, 1e-30f));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Strides& st, int B, int Hq, int Hkv, int sq, int skv,
           int dh, int causal, cudaStream_t stream) {
  const int bytes = smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, B * Hq);
  flash_fwd_kernel<T, DH><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, st, Hq, Hq / Hkv,
      sq, skv, dh, causal, 1.0f / sqrtf(static_cast<float>(dh)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, const Strides& st, int B, int Hq, int Hkv, int sq,
             int skv, int dh, int causal, cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, lse, st, B, Hq, Hkv, sq, skv, dh,
                         causal, stream);
  if (dh <= 128)
    return launch<T, 128>(q, k, v, o, lse, st, B, Hq, Hkv, sq, skv, dh,
                          causal, stream);
  if (dh <= 192)
    return launch<T, 192>(q, k, v, o, lse, st, B, Hq, Hkv, sq, skv, dh,
                          causal, stream);
  return launch<T, 256>(q, k, v, o, lse, st, B, Hq, Hkv, sq, skv, dh,
                        causal, stream);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// Tensor-core path

namespace tc {

using namespace hopper;

constexpr int BQ = 128;             // query rows per block
constexpr int STAGES = 3;           // K/V ring depth
constexpr int CONSUMERS = 256;      // two warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup

// Keys per K/V tile: 128, or 64 at dh 192, where three stages of 128-key
// K and V tiles (288 KB) and the Q tile would not fit a block's 227 KB
template <int DH>
constexpr int kv_tile() {
  return DH > 128 ? 64 : 128;
}

// Dynamic shared memory, from a 1024-byte aligned base: the Q tile, the K
// and V rings, then the mbarriers. A tile is dh / 64 regions, one per 64
// columns, each of its rows at 128 bytes.
template <int DH>
struct Layout {
  static constexpr int BK = kv_tile<DH>();
  static constexpr int NA = DH / ATOM;
  static constexpr int Q_BYTES = NA * BQ * ROW;
  static constexpr int KV_BYTES = NA * BK * ROW;    // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

// Ping-pong: the two consumer warpgroups take turns to issue their
// products, so one's softmax runs under the other's. Named barrier 3 + wg
// is warpgroup wg's turn; the other passes it on once its batch is issued.
__device__ __forceinline__ void take_turn(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(3 + wg) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - wg) : "memory");
}

// S = Q K^T for one warpgroup's 64 rows and a BK-key tile: k16 steps
// along dh, each 32 bytes further into the swizzled rows, the next 64
// columns one region further
template <int DH, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_wg,
                                         uint32_t k_t) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(sc, sw128_desc(q_wg + (kk / 4) * BQ * ROW + col, 16, 1024),
             sw128_desc(k_t + (kk / 4) * BK * ROW + col, 16, 1024), 1);
  }
}

// O += P V: k16 steps along the keys, 16 rows of V each; V's next 64
// columns (dh 128 and 192) lie one region (BK rows) further
template <int BK, int N>
__device__ __forceinline__ void issue_pv(float (&o)[N],
                                         const uint32_t (&p)[BK / 16][4],
                                         uint32_t v_t) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, p[kk], sw128_desc(v_t + kk * 16 * ROW, BK * ROW, 1024));
}

// The online softmax of one tile's scores, sc[4j + e] at row row0 + 8 (e /
// 2) and key k0 + 8 j + cq + e % 2. Masks only a tile that the diagonal
// (the warpgroup's first row is row_wg) or the Skv edge crosses, updates
// the running max m (raw scores: the scale is positive) and sum l, leaves
// exp(scale (s - m)) = exp2(s * scale_log2 - m * scale_log2) in sc (one
// FFMA and one ex2 a score) and O's rescale factor in corr.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0,
                                             int row0, int cq, int row_wg,
                                             int Skv, int causal,
                                             float scale_log2) {
  const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > row_wg);
  float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (edge) {
        const int key = k0 + 8 * j + cq + (e & 1);
        if (key >= Skv || (causal && key > row0 + 8 * (e >> 1)))
          sc[4 * j + e] = NEG_INF;
      }
      mt[e >> 1] = fmaxf(mt[e >> 1], sc[4 * j + e]);
    }
  }
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float mn = fmaxf(m[r], mt[r]);
    corr[r] = exp2_approx((m[r] - mn) * scale_log2);
    m[r] = mn;
    ms[r] = mn * scale_log2;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], scale_log2,
                                       -ms[e >> 1]));
      l[e >> 1] += sc[4 * j + e];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_o,
                float* __restrict__ lse, int Hq, int group, int Sq, int Skv,
                int causal, float scale_log2) {
  using L = Layout<DH>;
  constexpr int NA = L::NA;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t sq = base, sk = base + L::K_OFF, sv = base + L::V_OFF;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s), then Q's
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t qbar = bars + 16 * STAGES;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + BQ, Sq));
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), CONSUMERS / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {           // the producer warpgroup: one lane works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == CONSUMERS) {
      mbar_expect_tx(qbar, L::Q_BYTES);
      for (int a = 0; a < NA; ++a)
        tma_load(sq + a * BQ * ROW, &tm_q, qbar, a * ATOM, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES)            // the consumers released tile t - STAGES
          mbar_wait(bars + 8 * (STAGES + s), (t / STAGES - 1) & 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, 2 * L::KV_BYTES);
        for (int a = 0; a < NA; ++a) {
          const uint32_t off = s * L::KV_BYTES + a * BK * ROW;
          tma_load(sk + off, &tm_k, full, a * ATOM, kvh, t * BK, b);
          tma_load(sv + off, &tm_v, full, a * ATOM, kvh, t * BK, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128;          // this warpgroup's rows: wg*64 .. +63
  const int lane = tid % 32;
  const int r_in = (tid % 128) / 32 * 16 + lane / 4;  // and r_in + 8
  const int row0 = q0 + wg * 64 + r_in;
  const int cq = 2 * (lane % 4);     // column pair within each 8 columns
  const uint32_t q_wg = sq + wg * 64 * ROW;

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  float sc[BK / 2];
  uint32_t p[BK / 16][4];
  mbar_wait(qbar, 0);

  // Software pipeline: step t issues S_t = Q K_t^T and O += P_{t-1} V_{t-1}
  // together, runs tile t's softmax while the second product is still on
  // the tensor cores, and only then rescales O and packs P_t.
  if (wg == 1) pass_turn(1);        // warpgroup 0 issues first
  mbar_wait(bars, 0);
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  take_turn(wg);
  wgmma_fence();
  issue_qk<DH, BK>(sc, q_wg, sk);
  wgmma_commit();
  pass_turn(wg);
  wgmma_wait<0>();
  pin(sc);
  softmax_tile<BK>(sc, m, l, corr, 0, row0, cq, q0 + wg * 64, Skv, causal,
               scale_log2);
  pack_p<BK>(sc, p);
  for (int t = 1; t < n_tiles; ++t) {
    const int s = t % STAGES, sp = (t - 1) % STAGES;
    mbar_wait(bars + 8 * s, (t / STAGES) & 1);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    take_turn(wg);
    wgmma_fence();
    issue_qk<DH, BK>(sc, q_wg, sk + s * L::KV_BYTES);
    wgmma_commit();
    issue_pv<BK>(o, p, sv + sp * L::KV_BYTES);
    wgmma_commit();
    pass_turn(wg);
    wgmma_wait<1>();                // S_t is in; P_{t-1} V_{t-1} may not be
    pin(sc);
    softmax_tile<BK>(sc, m, l, corr, t * BK, row0, cq, q0 + wg * 64, Skv,
                 causal, scale_log2);
    wgmma_wait<0>();
    pin(o);
    pin(p);
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + sp));
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    pack_p<BK>(sc, p);
  }
  const int sl = (n_tiles - 1) % STAGES;
  take_turn(wg);
  wgmma_fence();
  issue_pv<BK>(o, p, sv + sl * L::KV_BYTES);
  wgmma_commit();
  if (wg == 0) pass_turn(wg);       // warpgroup 1's last turn is the end
  wgmma_wait<0>();
  pin(o);
  pin(p);
  if (lane == 0) mbar_arrive(bars + 8 * (STAGES + sl));

  // epilogue: o / l in bf16 over this warpgroup's rows of the Q tile, in
  // TMA's swizzle, then one TMA store per 64 columns
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    if (lane % 4 == 0 && row0 + 8 * r < Sq)
      lse[(static_cast<long long>(b) * Hq + h) * Sq + row0 + 8 * r] =
          m[r] * scale_log2 * LN2 + logf(fmaxf(l[r], 1e-30f));
  }
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = 8 * j + cq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wg * 64 + r_in + 8 * r;
      const int byte = (col % ATOM) * 2;
      *reinterpret_cast<uint32_t*>(
          smem + (col / ATOM) * BQ * ROW + row * ROW
          + (byte ^ ((row & 7) << 4))) =
          pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if (tid % 128 == 0) {
    for (int a = 0; a < NA; ++a)
      tma_store(&tm_o, q_wg + a * BQ * ROW, a * ATOM, h, q0 + wg * 64, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Strides& st, int B, int Hq, int Hkv, int sq, int skv,
           int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  int err = make_map(&mq, q, st.q, B, sq, Hq, DH, BQ);
  if (!err) err = make_map(&mk, k, st.k, B, skv, Hkv, DH, Layout<DH>::BK);
  if (!err) err = make_map(&mv, v, st.v, B, skv, Hkv, DH, Layout<DH>::BK);
  if (!err) err = make_map(&mo, o, st.o, B, sq, Hq, DH, BQ / 2);
  if (err) return err;
  constexpr int bytes = Layout<DH>::BYTES;
  static_assert(bytes <= 232448, "over a block's shared memory");
  const cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * Hq, (sq + BQ - 1) / BQ);
  flash_tc_kernel<DH><<<grid, THREADS, bytes, stream>>>(
      mq, mk, mv, mo, lse, Hq, Hq / Hkv, sq, skv, causal,
      LOG2E / sqrtf(static_cast<float>(DH)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers:
// q and o (B, sq, hq, dh), k and v (B, skv, hkv, dh), the head dimension
// contiguous; lse a contiguous fp32 (B, hq, sq); `strides` holds the
// (B, S, H) strides in elements of q, k, v and o, in that order (12
// values); hq % hkv == 0, sq and skv >= 1.
// Each launches on `stream` and returns the first error (0 when the launch
// was accepted): a CUDA error, or 10000 + a CUresult when a tensor map is
// refused, or 20000 when the driver has no cuTensorMapEncodeTiled.

// fp32 (dtype 0) or bf16 (dtype 1), 1 <= dh <= 256
extern "C" int flash_attention_fwd_simt(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const long long* strides, int B, int hq, int hkv, int sq, int skv,
    int dh, int causal, int dtype, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::dispatch<float>(q, k, v, o, lse, st, B, hq, hkv, sq, skv,
                                 dh, causal, s);
  return simt::dispatch<__nv_bfloat16>(q, k, v, o, lse, st, B, hq, hkv, sq,
                                       skv, dh, causal, s);
}

// bf16, dh 64, 128 or 192; every pointer 16-byte aligned and every stride
// a multiple of 8 elements (TMA's 16 bytes)
extern "C" int flash_attention_fwd_tc(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const long long* strides, int B, int hq, int hkv, int sq, int skv,
    int dh, int causal, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return tc::launch<64>(q, k, v, o, lse, st, B, hq, hkv, sq, skv, causal,
                          s);
  if (dh == 128)
    return tc::launch<128>(q, k, v, o, lse, st, B, hq, hkv, sq, skv, causal,
                           s);
  return tc::launch<192>(q, k, v, o, lse, st, B, hq, hkv, sq, skv, causal,
                         s);
}
