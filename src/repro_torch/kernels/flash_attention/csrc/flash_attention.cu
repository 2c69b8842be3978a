// Flash-attention forward for Hopper (sm_90a): fp32 or bf16 in, fp32 math.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd
// (the Pallas TPU kernel _flash_fwd_kernel). In the folded layout
//     q (BH, Sq, dh), k/v (BHkv, Skv, dh), BH % BHkv == 0,
// query head bh reads KV head bh / (BH / BHkv), so K and V are never
// repeated in memory. Per query row it keeps the online softmax of the
// reference: a running max m (NEG_INF = -1e30 at the start), a running sum
// l and an fp32 accumulator, rescaled by exp(m_old - m_new) per KV tile;
// scores are (q . k) * 1/sqrt(dh); the causal mask is aligned top-left
// (key kpos attends query qpos iff kpos <= qpos, both counted from 0), and
// KV tiles wholly above the diagonal are never loaded. The output is
// acc / max(l, 1e-30), cast to the input type.
//
// Bound on an H100 SXM: 4 * BH * dh * pairs operations (pairs = unmasked
// (q, k) pairs) against q + k + v + o bytes. At the serving shapes of
// starcoder2-3b (BH = 4 * 24, BHkv = 4 * 2, dh = 128, S ~ 1024, bf16) that
// is ~26 GFLOP against ~55 MB: operations bound it (26 us at 989 TFLOP/s
// on the tensor cores, 16 us by bytes).
//
// Design (simple and right first). This kernel does its arithmetic on the
// CUDA cores in fp32, not on the tensor cores, so it runs far above that
// bound: wgmma, TMA and a pipelined, warp-specialised (FA3-style) design are
// later work. What the design does about the work it has:
//  * one block owns one (bh, 64-row q tile) and loops over 32-row KV tiles
//    staged in shared memory, so nothing crosses blocks; q tiles are taken
//    from the bottom of the causal triangle first, so the longest blocks
//    start first;
//  * two threads share a query row: each computes 16 of the tile's 32
//    scores (keys interleaved, so the pair reads different banks) and half
//    of the output columns (16-byte chunks interleaved likewise); the row's
//    max and sum are combined with one warp shuffle each, and P goes
//    through a per-warp region of shared memory, never device memory;
//  * every ragged edge is masked: Sq, Skv and dh need not be multiples of
//    the tiles (dh <= 128 is padded with zeros to 64 or 128 in shared
//    memory), as the engine's padded widths (any multiple of 8 or 32) need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per KV tile
constexpr int THREADS = 2 * BQ;     // two threads per query row
constexpr int KH = BK / 2;          // scores per thread per tile
constexpr float NEG_INF = -1e30f;

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
                 const T* __restrict__ v, T* __restrict__ o, int group,
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
  const int bh = blockIdx.y;
  const int kvh = bh / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int qpos = q0 + r;

  const T* qb = q + (size_t)bh * Sq * dh;
  const T* kb = k + (size_t)kvh * Skv * dh;
  const T* vb = v + (size_t)kvh * Skv * dh;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int rr = i / DH, c = i % DH;
    Qs[rr * LD + c] = (q0 + rr < Sq && c < dh)
                          ? to_float(qb[(size_t)(q0 + rr) * dh + c]) : 0.f;
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
      const size_t g = (size_t)(k0 + rr) * dh + c;
      Ks[rr * LD + c] = in ? to_float(kb[g]) : 0.f;
      Vs[rr * LD + c] = in ? to_float(vb[g]) : 0.f;
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
    T* ob = o + ((size_t)bh * Sq + qpos) * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * (2 * c + h) + e;
        if (col < dh) ob[col] = from_float<T>(acc[4 * c + e] * inv);
      }
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int bhkv, int sq, int skv, int dh, int causal,
           cudaStream_t stream) {
  const int bytes = smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, DH><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh / bhkv, sq, skv, dh,
      causal, 1.0f / sqrtf(static_cast<float>(dh)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int bhkv, int sq, int skv, int dh, int causal,
             cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, bh, bhkv, sq, skv, dh, causal, stream);
  return launch<T, 128>(q, k, v, o, bh, bhkv, sq, skv, dh, causal, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers to
// contiguous tensors of one type (dtype 0: float32, 1: bfloat16):
// q and o (bh, sq, dh), k and v (bhkv, skv, dh), with bh % bhkv == 0,
// 1 <= dh <= 128, sq and skv >= 1. Launches on `stream` and returns the
// first CUDA error (0 when the launch was accepted).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int bh, int bhkv,
                                   int sq, int skv, int dh, int causal,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, bh, bhkv, sq, skv, dh, causal, s);
  return dispatch<__nv_bfloat16>(q, k, v, o, bh, bhkv, sq, skv, dh, causal,
                                 s);
}
