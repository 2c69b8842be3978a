// Flash-attention backward for Hopper (sm_90a): the gradient of
// flash_attention.cu's forward, deterministic, with no float atomics.
//
// Replaces src/repro/kernels/flash_attention/ops.py::_bwd, the JAX
// package's backward (jax.vjp of its oracle attention_ref; there is no
// Pallas backward kernel). Same layout and semantics as the forward:
//     q, dq (B, Sq, Hq, dh), k, v, dk, dv (B, Skv, Hkv, dh), o, do like q,
// any (B, S, H) strides on q, k, v, o and do (the head dimension
// contiguous); dq, dk and dv are written contiguous in the input type.
// Query head h reads KV head h / (Hq / Hkv); the causal mask is aligned
// top-left (key j attends query i iff j <= i), Sq != Skv allowed on either
// side; scores are scaled by 1 / sqrt(dh). The forward's row log-sum-exp
// (lse, fp32 (B, Hq, Sq), natural log of the scaled scores) lets the
// backward recompute P = exp(scale * q.k - lse) tile by tile, so no S^2
// tensor is ever stored:
//   (a) dsum_kernel:  D_i = sum_d dO_id O_id in fp32, one warp a row;
//   (b) dkdv kernels: one block per (b, KV head, key tile) walks every
//       query head of its group and every query tile at or below the
//       diagonal: S = Q K^T, P = exp(S scale - lse), dV += P^T dO,
//       dP = dO V^T, dS = P (dP - D), dK += scale dS^T Q. The group's sum
//       stays in the block's registers, so dK and dV are written once;
//   (c) dq kernels: one block per (b, query head, query tile) walks the key
//       tiles: the same S, P, dP and dS, then dQ += scale dS K.
// S and dP are computed twice, in (b) and in (c): 14 dh operations a scored
// pair, where FlashAttention-2 with float atomics on dQ needs 10. What the
// function needs is 8 dh (dV, dP, dS K and dS^T Q); fusing (c) into (b)
// with a deterministic reduction of dQ is later work.
//
// Bound on an H100 SXM: 8 * B * Hq * dh * pairs operations against
// q + k + v + o + do + lse read and dq + dk + dv written. Operations bound
// it at the training shapes (starcoder2-3b, B 8, SL 2816, Hq 24, dh 128,
// causal: 0.44 TFLOP, 0.44 ms at 989 TFLOP/s; 0.15 ms by bytes).
//
// Rows with no key at all (never the case for the top-left mask with
// Skv >= 1) get P = 0 and zero gradients: every masked score's P is set to
// 0 by the mask, not by its exp.
//
// Tensor-core path (bf16 at head_dim 64, 128 or 192: every bf16 training
// phase). mma.sync m16n8k16 (bf16 in, fp32 accumulators) with ldmatrix
// from shared memory; tiles of 64 query rows and 64 keys, 8 warps.
//  * (b) loads its 64-key K and V tiles once; the Q, dO, lse and D tiles of
//    each (head, query tile) come by cp.async into two buffers, the next
//    one in flight while this one computes. Stage 1: S^T = K Q^T and
//    dP^T = V dO^T, each warp 16 keys x 32 queries in registers; P^T and
//    dS^T go to shared memory in bf16. Stage 2: dV += P^T dO and
//    dK += dS^T Q, each warp 16 keys x dh / 2 columns, A from the P^T / dS^T
//    tiles by ldmatrix, B from the dO / Q tiles by ldmatrix.trans.
//  * (c) keeps its Q and dO tiles and streams 64-key K and V tiles in two
//    buffers; stage 1 as in (b) with queries as rows (S = Q K^T,
//    dP = dO V^T), dS in bf16 to shared memory; stage 2 dQ += dS K, each
//    warp 16 rows x dh / 2 columns.
//  * Rows of every tile are padded by 16 bytes in shared memory, so the
//    eight 16-byte rows an ldmatrix reads fall in distinct banks. Rows past
//    Sq or Skv are zero-filled by cp.async and masked.
//  * P and dS are rounded to bf16 for their products, as the forward rounds
//    P; S, dP, D and every sum stay fp32.
//  Shared memory at dh 192: (b) 173 KB, (c) 162 KB; one block an SM.
//  Not done yet: wgmma and TMA, a persistent grid, splitting a small GQA
//  group x key-tile grid (starcoder2-3b at SL 144: 48 blocks of (b)).
//
// CUDA-core path (fp32, or bf16 at any other head_dim <= 256: the fp32
// parity runs at dh 64, 128 and 192). fp32 FMAs on tiles of 32 query rows
// and 32 keys staged in shared memory as fp32 (head_dim padded with zeros
// to 64, 128, 192 or 256), 256 threads: for S and dP each thread owns one
// row and four keys; for the products that follow, one key (or row) and
// dh / 8 columns, dK and dV (or dQ) in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// (B, S, H) strides, in elements, of q, k, v, o and do; the head dimension
// is contiguous
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3];
};

struct Problem {
  const void *q, *k, *v, *o, *g;
  const float* lse;                 // (B, Hq, Sq)
  float* dsum;                      // D, (B, Hq, Sq)
  void *dq, *dk, *dv;               // contiguous
  Strides st;
  int B, Hq, Hkv, Sq, Skv, dh, causal;
  float scale;
};

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

// Is key kpos scored for query qpos?
__device__ __forceinline__ bool live(int qpos, int kpos, const Problem& p) {
  return qpos < p.Sq && kpos < p.Skv && !(p.causal && kpos > qpos);
}

// Query tiles of `bq` rows that keys [k0, ...) meet: all of them, or under
// the causal mask those from the one holding row k0 on
__device__ __forceinline__ int first_q_tile(int k0, int bq, int causal) {
  return causal ? k0 / bq : 0;
}

// Keys that query rows [q0, q0 + bq) meet: [0, kv_end)
__device__ __forceinline__ int kv_end(int q0, int bq, const Problem& p) {
  return p.causal ? min(p.Skv, min(q0 + bq, p.Sq)) : p.Skv;
}

// ---------------------------------------------------------------------------
// (a) D = rowsum(dO o O), one warp a (b, h, row)

template <typename T>
__global__ void __launch_bounds__(256) dsum_kernel(Problem p) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(p.B) * p.Hq * p.Sq) return;
  const int i = row % p.Sq;
  const int h = (row / p.Sq) % p.Hq;
  const int b = row / (static_cast<long long>(p.Sq) * p.Hq);
  const T* o = static_cast<const T*>(p.o) + b * p.st.o[0] + i * p.st.o[1]
               + h * p.st.o[2];
  const T* g = static_cast<const T*>(p.g) + b * p.st.g[0] + i * p.st.g[1]
               + h * p.st.g[2];
  float acc = 0.f;
  for (int c = lane; c < p.dh; c += 32)
    acc = fmaf(to_float(o[c]), to_float(g[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.dsum[row] = acc;
}

// ---------------------------------------------------------------------------
// CUDA-core path

namespace simt {

constexpr int BQ = 32;              // query rows a tile
constexpr int BK = 32;              // keys a tile
constexpr int THREADS = 256;
constexpr int LDP = BK + 1;         // P / dS rows, padded

// Shared memory, in floats: two (BQ or BK) x LD tiles for each side (Q and
// dO, K and V), P and dS (BQ x LDP), lse and D (BQ)
template <int DH>
constexpr int smem_floats() {
  return (2 * BQ + 2 * BK) * (DH + 4) + 2 * BQ * LDP + 2 * BQ;
}

// rows [r0, r0 + n) of a (B, S, H, dh) tensor at (b, h) into an n x LD fp32
// tile, zeros past S and dh
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          const long long* st, int b, int h,
                                          int r0, int n, int S, int dh) {
  constexpr int LD = DH + 4;
  const T* src = base + b * st[0] + h * st[2];
  for (int i = threadIdx.x; i < n * DH; i += THREADS) {
    const int r = i / DH, c = i % DH;
    dst[r * LD + c] = (r0 + r < S && c < dh)
                          ? to_float(src[(r0 + r) * st[1] + c]) : 0.f;
  }
}

// lse and D of rows [q0, q0 + BQ) of head (b, h); zeros past Sq
__device__ __forceinline__ void load_rows(float* lse_s, float* d_s,
                                          const Problem& p, int b, int h,
                                          int q0) {
  const int t = threadIdx.x;
  if (t < BQ) {
    const long long at = (static_cast<long long>(b) * p.Hq + h) * p.Sq + q0
                         + t;
    const bool in = q0 + t < p.Sq;
    lse_s[t] = in ? p.lse[at] : 0.f;
    d_s[t] = in ? p.dsum[at] : 0.f;
  }
}

// Stage 1 of one (BQ x BK) tile: thread t owns query row r = t / 8 and
// keys kc + 8 j (j < 4), kc = t % 8. Writes P (where `ps`) and dS, both
// BQ x LDP, masked to 0.
template <int DH>
__device__ __forceinline__ void scores(const float* Qs, const float* Gs,
                                       const float* Ks, const float* Vs,
                                       const float* lse_s, const float* d_s,
                                       float* ps, float* dss, int q0, int k0,
                                       const Problem& p) {
  constexpr int LD = DH + 4;
  const int r = threadIdx.x / 8, kc = threadIdx.x % 8;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < DH; d += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(&Qs[r * LD + d]);
    const float4 gv = *reinterpret_cast<const float4*>(&Gs[r * LD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 kv =
          *reinterpret_cast<const float4*>(&Ks[(kc + 8 * j) * LD + d]);
      const float4 vv =
          *reinterpret_cast<const float4*>(&Vs[(kc + 8 * j) * LD + d]);
      s[j] = fmaf(qv.x, kv.x, s[j]);
      s[j] = fmaf(qv.y, kv.y, s[j]);
      s[j] = fmaf(qv.z, kv.z, s[j]);
      s[j] = fmaf(qv.w, kv.w, s[j]);
      dp[j] = fmaf(gv.x, vv.x, dp[j]);
      dp[j] = fmaf(gv.y, vv.y, dp[j]);
      dp[j] = fmaf(gv.z, vv.z, dp[j]);
      dp[j] = fmaf(gv.w, vv.w, dp[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = kc + 8 * j;
    const float pr = live(q0 + r, k0 + kk, p)
                         ? expf(fmaf(s[j], p.scale, -lse_s[r])) : 0.f;
    if (ps != nullptr) ps[r * LDP + kk] = pr;
    dss[r * LDP + kk] = pr * (dp[j] - d_s[r]);
  }
}

// (b): dK and dV of keys [k0, k0 + BK) of KV head (b, kvh)
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(Problem p) {
  constexpr int LD = DH + 4;
  constexpr int NC = DH / 32;       // float4 column chunks a thread
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* Gs = Qs + BQ * LD;
  float* Ps = Gs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* lse_s = dSs + BQ * LDP;
  float* d_s = lse_s + BQ;

  const int group = p.Hq / p.Hkv;
  const int b = blockIdx.x / p.Hkv, kvh = blockIdx.x % p.Hkv;
  const int k0 = blockIdx.y * BK;
  const int kk = threadIdx.x / 8, cg = threadIdx.x % 8;

  load_tile<T, DH>(Ks, static_cast<const T*>(p.k), p.st.k, b, kvh, k0, BK,
                   p.Skv, p.dh);
  load_tile<T, DH>(Vs, static_cast<const T*>(p.v), p.st.v, b, kvh, k0, BK,
                   p.Skv, p.dh);
  float dk[4 * NC], dv[4 * NC];
#pragma unroll
  for (int c = 0; c < 4 * NC; ++c) dk[c] = dv[c] = 0.f;

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  for (int h = kvh * group; h < (kvh + 1) * group; ++h) {
    for (int qt = first_q_tile(k0, BQ, p.causal); qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();              // the last tile's reads are done
      load_tile<T, DH>(Qs, static_cast<const T*>(p.q), p.st.q, b, h, q0, BQ,
                       p.Sq, p.dh);
      load_tile<T, DH>(Gs, static_cast<const T*>(p.g), p.st.g, b, h, q0, BQ,
                       p.Sq, p.dh);
      load_rows(lse_s, d_s, p, b, h, q0);
      __syncthreads();
      scores<DH>(Qs, Gs, Ks, Vs, lse_s, d_s, Ps, dSs, q0, k0, p);
      __syncthreads();
      for (int r = 0; r < BQ; ++r) {
        const float pr = Ps[r * LDP + kk], ds = dSs[r * LDP + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = 4 * (cg + 8 * c);
          const float4 gv = *reinterpret_cast<const float4*>(&Gs[r * LD + col]);
          const float4 qv = *reinterpret_cast<const float4*>(&Qs[r * LD + col]);
          dv[4 * c + 0] = fmaf(pr, gv.x, dv[4 * c + 0]);
          dv[4 * c + 1] = fmaf(pr, gv.y, dv[4 * c + 1]);
          dv[4 * c + 2] = fmaf(pr, gv.z, dv[4 * c + 2]);
          dv[4 * c + 3] = fmaf(pr, gv.w, dv[4 * c + 3]);
          dk[4 * c + 0] = fmaf(ds, qv.x, dk[4 * c + 0]);
          dk[4 * c + 1] = fmaf(ds, qv.y, dk[4 * c + 1]);
          dk[4 * c + 2] = fmaf(ds, qv.z, dk[4 * c + 2]);
          dk[4 * c + 3] = fmaf(ds, qv.w, dk[4 * c + 3]);
        }
      }
    }
  }
  const int kpos = k0 + kk;
  if (kpos >= p.Skv) return;
  const long long at = ((static_cast<long long>(b) * p.Skv + kpos) * p.Hkv
                        + kvh) * p.dh;
  T* dkp = static_cast<T*>(p.dk) + at;
  T* dvp = static_cast<T*>(p.dv) + at;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * (cg + 8 * c) + e;
      if (col < p.dh) {
        dkp[col] = from_float<T>(dk[4 * c + e] * p.scale);
        dvp[col] = from_float<T>(dv[4 * c + e]);
      }
    }
  }
}

// (c): dQ of query rows [q0, q0 + BQ) of head (b, h)
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
dq_kernel(Problem p) {
  constexpr int LD = DH + 4;
  constexpr int NC = DH / 32;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + BQ * LD;
  float* Ks = Gs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD + BQ * LDP;   // P's room unused here
  float* lse_s = dSs + BQ * LDP;
  float* d_s = lse_s + BQ;

  const int group = p.Hq / p.Hkv;
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest first
  const int r = threadIdx.x / 8, cg = threadIdx.x % 8;

  load_tile<T, DH>(Qs, static_cast<const T*>(p.q), p.st.q, b, h, q0, BQ,
                   p.Sq, p.dh);
  load_tile<T, DH>(Gs, static_cast<const T*>(p.g), p.st.g, b, h, q0, BQ,
                   p.Sq, p.dh);
  load_rows(lse_s, d_s, p, b, h, q0);
  float dq[4 * NC];
#pragma unroll
  for (int c = 0; c < 4 * NC; ++c) dq[c] = 0.f;

  const int end = kv_end(q0, BQ, p);
  for (int k0 = 0; k0 < end; k0 += BK) {
    __syncthreads();                // the last tile's reads are done
    load_tile<T, DH>(Ks, static_cast<const T*>(p.k), p.st.k, b, kvh, k0, BK,
                     p.Skv, p.dh);
    load_tile<T, DH>(Vs, static_cast<const T*>(p.v), p.st.v, b, kvh, k0, BK,
                     p.Skv, p.dh);
    __syncthreads();
    scores<DH>(Qs, Gs, Ks, Vs, lse_s, d_s, nullptr, dSs, q0, k0, p);
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      const float ds = dSs[r * LDP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(
            &Ks[kk * LD + 4 * (cg + 8 * c)]);
        dq[4 * c + 0] = fmaf(ds, kv.x, dq[4 * c + 0]);
        dq[4 * c + 1] = fmaf(ds, kv.y, dq[4 * c + 1]);
        dq[4 * c + 2] = fmaf(ds, kv.z, dq[4 * c + 2]);
        dq[4 * c + 3] = fmaf(ds, kv.w, dq[4 * c + 3]);
      }
    }
  }
  const int qpos = q0 + r;
  if (qpos >= p.Sq) return;
  T* dqp = static_cast<T*>(p.dq)
           + ((static_cast<long long>(b) * p.Sq + qpos) * p.Hq + h) * p.dh;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * (cg + 8 * c) + e;
      if (col < p.dh) dqp[col] = from_float<T>(dq[4 * c + e] * p.scale);
    }
  }
}

template <typename T, int DH>
int launch(const Problem& p, cudaStream_t stream) {
  const int bytes = smem_floats<DH>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, DH><<<dim3(p.B * p.Hkv, (p.Skv + BK - 1) / BK), THREADS,
                       bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, DH><<<dim3(p.B * p.Hq, (p.Sq + BQ - 1) / BQ), THREADS, bytes,
                     stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Problem& p, cudaStream_t stream) {
  if (p.dh <= 64) return launch<T, 64>(p, stream);
  if (p.dh <= 128) return launch<T, 128>(p, stream);
  if (p.dh <= 192) return launch<T, 192>(p, stream);
  return launch<T, 256>(p, stream);
}

}  // namespace simt

// ---------------------------------------------------------------------------
// Tensor-core path

namespace tc {

constexpr int BQ = 64;              // query rows a tile
constexpr int BK = 64;              // keys a tile
constexpr int THREADS = 256;        // 8 warps
constexpr int LDPS = BK + 8;        // P / dS rows (bf16), padded 16 bytes
static_assert(BQ == BK, "P / dS tiles are square");

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, zero-filled where !in
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, zero-filled where !in
__device__ __forceinline__ void cp4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// d (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A tile's rows [r0, r0 + n) of a (B, S, H, DH) bf16 tensor at (b, h) into
// n x (DH + 8) shared memory by 16-byte cp.async, zeros past S
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const void* base,
                                          const long long* st, int b, int h,
                                          int r0, int n, int S) {
  constexpr int CH = DH / 8;        // 16-byte chunks a row
  const bf16* src = static_cast<const bf16*>(base) + b * st[0] + h * st[2];
  for (int i = threadIdx.x; i < n * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = r0 + r < S;
    cp16(dst + r * (DH + 8) + c, in ? src + (r0 + r) * st[1] + c : src, in);
  }
}

// lse and D of rows [q0, q0 + BQ) of head (b, h), zeros past Sq
__device__ __forceinline__ void load_rows(float* lse_s, float* d_s,
                                          const Problem& p, int b, int h,
                                          int q0) {
  const int t = threadIdx.x;
  if (t < 2 * BQ) {
    const int r = t % BQ;
    const long long at = (static_cast<long long>(b) * p.Hq + h) * p.Sq + q0
                         + r;
    const bool in = q0 + r < p.Sq;
    const float* src = t < BQ ? p.lse : p.dsum;
    cp4((t < BQ ? lse_s : d_s) + r, in ? src + at : src, in);
  }
}

// Stage 1, shared by (b) and (c): one warp's 16 rows x 32 columns of
// X Y^T and W Z^T over DH (X, W: the rows' tiles, 16 rows from row0;
// Y, Z: the columns', 32 rows from col0; all LD = DH + 8)
template <int DH>
__device__ __forceinline__ void stage1(float (&s)[4][4], float (&dp)[4][4],
                                       const bf16* X, const bf16* W,
                                       const bf16* Y, const bf16* Z,
                                       int row0, int col0) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  // A: rows row0 + lane % 16, columns + (lane / 16) * 8;
  // B (two n-tiles an ldmatrix): rows col0 + 16 jj + lane % 8 + (lane / 16)
  // * 8, columns + (lane / 8 % 2) * 8
  const bf16* xa = X + (row0 + lane % 16) * LD + (lane / 16) * 8;
  const bf16* wa = W + (row0 + lane % 16) * LD + (lane / 16) * 8;
  const int brow = col0 + lane % 8 + (lane / 16) * 8;
  const int bcol = (lane / 8 % 2) * 8;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t ax[4], aw[4];
    ldsm_x4(ax, xa + 16 * ks);
    ldsm_x4(aw, wa + 16 * ks);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t by[4], bz[4];
      ldsm_x4(by, Y + (brow + 16 * jj) * LD + 16 * ks + bcol);
      ldsm_x4(bz, Z + (brow + 16 * jj) * LD + 16 * ks + bcol);
      mma(s[2 * jj], ax, by[0], by[1]);
      mma(s[2 * jj + 1], ax, by[2], by[3]);
      mma(dp[2 * jj], aw, bz[0], bz[1]);
      mma(dp[2 * jj + 1], aw, bz[2], bz[3]);
    }
  }
}

// Stage 2, shared by (b) and (c): one warp's 16 rows x DH / 2 columns
// (from dcol) of acc += A B, A a 16 x 64 bf16 tile (LDPS) from row0, B the
// 64 x DH tile (LD = DH + 8) read transposed
template <int DH>
__device__ __forceinline__ void stage2(float (&acc)[DH / 16][4],
                                       const bf16* A, const bf16* Bm,
                                       int row0, int dcol) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x % 32;
  const bf16* aa = A + (row0 + lane % 16) * LDPS + (lane / 16) * 8;
  const bf16* bb = Bm + (lane % 8 + (lane / 8 % 2) * 8) * LD + dcol
                   + (lane / 16) * 8;
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, aa + 16 * ks);
#pragma unroll
    for (int jj = 0; jj < DH / 32; ++jj) {
      uint32_t b[4];
      ldsm_x4_t(b, bb + 16 * ks * LD + 16 * jj);
      mma(acc[2 * jj], a, b[0], b[1]);
      mma(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// Shared memory of (b): K, V (BK rows), two buffers of Q and dO (BQ rows),
// P^T and dS^T (BK x LDPS), two buffers of lse and D
template <int DH>
constexpr int dkdv_bytes() {
  return (2 * BK + 4 * BQ) * (DH + 8) * 2 + 2 * BK * LDPS * 2
         + 4 * BQ * 4;
}

// (b): dK and dV of keys [k0, k0 + BK) of KV head (b, kvh)
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(Problem p, float scale_log2) {
  constexpr int LD = DH + 8;
  constexpr int NT = DH / 16;       // n-tiles of 8 columns a warp
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + BK * LD;
  bf16* Qs = Vs + BK * LD;          // [2][BQ][LD]
  bf16* Gs = Qs + 2 * BQ * LD;      // [2][BQ][LD]
  bf16* Ps = Gs + 2 * BQ * LD;      // [BK][LDPS]
  bf16* dSs = Ps + BK * LDPS;
  float* lse_s = reinterpret_cast<float*>(dSs + BK * LDPS);   // [2][BQ]
  float* d_s = lse_s + 2 * BQ;                                // [2][BQ]

  const int group = p.Hq / p.Hkv;
  const int b = blockIdx.x / p.Hkv, kvh = blockIdx.x % p.Hkv;
  const int k0 = blockIdx.y * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw = warp % 4, half = warp / 4;

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int qt0 = first_q_tile(k0, BQ, p.causal);
  const int per_head = max(n_qt - qt0, 0);
  const int n_it = group * per_head;

  load_tile<DH>(Ks, p.k, p.st.k, b, kvh, k0, BK, p.Skv);
  load_tile<DH>(Vs, p.v, p.st.v, b, kvh, k0, BK, p.Skv);
  auto issue = [&](int it) {
    const int h = kvh * group + it / per_head;
    const int q0 = (qt0 + it % per_head) * BQ;
    const int buf = it % 2;
    load_tile<DH>(Qs + buf * BQ * LD, p.q, p.st.q, b, h, q0, BQ, p.Sq);
    load_tile<DH>(Gs + buf * BQ * LD, p.g, p.st.g, b, h, q0, BQ, p.Sq);
    load_rows(lse_s + buf * BQ, d_s + buf * BQ, p, b, h, q0);
  };
  if (n_it > 0) issue(0);
  cp_commit();

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it % 2;
    const int q0 = (qt0 + it % per_head) * BQ;
    const bf16* Qb = Qs + buf * BQ * LD;
    const bf16* Gb = Gs + buf * BQ * LD;
    const float* lse_b = lse_s + buf * BQ;
    const float* d_b = d_s + buf * BQ;
    cp_wait<0>();
    __syncthreads();                // tile it is in; iteration it - 1 done
    if (it + 1 < n_it) issue(it + 1);
    cp_commit();

    // stage 1: S^T and dP^T, 16 keys (from 16 kw) x 32 queries (from
    // 32 half) a warp
    float s[4][4], dp[4][4];
    stage1<DH>(s, dp, Ks, Vs, Qb, Gb, 16 * kw, 32 * half);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = 32 * half + 8 * j + 2 * t;      // and qi + 1
      const float l0 = lse_b[qi] * LOG2E, l1 = lse_b[qi + 1] * LOG2E;
      const float d0 = d_b[qi], d1 = d_b[qi + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kr = 16 * kw + g + 8 * r;
        const float p0 = live(q0 + qi, k0 + kr, p)
            ? exp2_approx(fmaf(s[j][2 * r], scale_log2, -l0)) : 0.f;
        const float p1 = live(q0 + qi + 1, k0 + kr, p)
            ? exp2_approx(fmaf(s[j][2 * r + 1], scale_log2, -l1)) : 0.f;
        *reinterpret_cast<uint32_t*>(Ps + kr * LDPS + qi) = pack_bf16(p0, p1);
        *reinterpret_cast<uint32_t*>(dSs + kr * LDPS + qi) =
            pack_bf16(p0 * (dp[j][2 * r] - d0), p1 * (dp[j][2 * r + 1] - d1));
      }
    }
    __syncthreads();
    // stage 2: dV += P^T dO, dK += dS^T Q, 16 keys x DH / 2 columns a warp
    stage2<DH>(dv, Ps, Gb, 16 * kw, half * DH / 2);
    stage2<DH>(dk, dSs, Qb, 16 * kw, half * DH / 2);
  }
  cp_wait<0>();

  // rows 16 kw + g (+ 8), columns half * DH / 2 + 8 j + 2 t (+ 1)
  bf16* dkp = static_cast<bf16*>(p.dk);
  bf16* dvp = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k0 + 16 * kw + g + 8 * r;
    if (kpos >= p.Skv) continue;
    const long long at = ((static_cast<long long>(b) * p.Skv + kpos) * p.Hkv
                          + kvh) * DH + half * DH / 2 + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<uint32_t*>(dkp + at + 8 * j) =
          pack_bf16(dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvp + at + 8 * j) =
          pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// Shared memory of (c): Q and dO (BQ rows), two buffers of K and V (BK
// rows), dS (BQ x LDPS), lse and D
template <int DH>
constexpr int dq_bytes() {
  return (2 * BQ + 4 * BK) * (DH + 8) * 2 + BQ * LDPS * 2 + 2 * BQ * 4;
}

// (c): dQ of query rows [q0, q0 + BQ) of head (b, h)
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(Problem p, float scale_log2) {
  constexpr int LD = DH + 8;
  constexpr int NT = DH / 16;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Gs = Qs + BQ * LD;
  bf16* Ks = Gs + BQ * LD;          // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;      // [2][BK][LD]
  bf16* dSs = Vs + 2 * BK * LD;     // [BQ][LDPS]
  float* lse_s = reinterpret_cast<float*>(dSs + BQ * LDPS);
  float* d_s = lse_s + BQ;

  const int group = p.Hq / p.Hkv;
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qw = warp % 4, half = warp / 4;
  const int n_kt = (kv_end(q0, BQ, p) + BK - 1) / BK;

  load_tile<DH>(Qs, p.q, p.st.q, b, h, q0, BQ, p.Sq);
  load_tile<DH>(Gs, p.g, p.st.g, b, h, q0, BQ, p.Sq);
  load_rows(lse_s, d_s, p, b, h, q0);
  auto issue = [&](int kt) {
    const int buf = kt % 2;
    load_tile<DH>(Ks + buf * BK * LD, p.k, p.st.k, b, kvh, kt * BK, BK,
                  p.Skv);
    load_tile<DH>(Vs + buf * BK * LD, p.v, p.st.v, b, kvh, kt * BK, BK,
                  p.Skv);
  };
  if (n_kt > 0) issue(0);
  cp_commit();

  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  float l2[2], dd[2];               // rows 16 qw + g and + 8

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt % 2, k0 = kt * BK;
    const bf16* Kb = Ks + buf * BK * LD;
    const bf16* Vb = Vs + buf * BK * LD;
    cp_wait<0>();
    __syncthreads();                // tile kt is in; tile kt - 1 done
    if (kt == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l2[r] = lse_s[16 * qw + g + 8 * r] * LOG2E;
        dd[r] = d_s[16 * qw + g + 8 * r];
      }
    }
    if (kt + 1 < n_kt) issue(kt + 1);
    cp_commit();

    // stage 1: S and dP, 16 rows (from 16 qw) x 32 keys (from 32 half)
    float s[4][4], dp[4][4];
    stage1<DH>(s, dp, Qs, Gs, Kb, Vb, 16 * qw, 32 * half);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = 32 * half + 8 * j + 2 * t;      // and kc + 1
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qr = 16 * qw + g + 8 * r;
        const float p0 = live(q0 + qr, k0 + kc, p)
            ? exp2_approx(fmaf(s[j][2 * r], scale_log2, -l2[r])) : 0.f;
        const float p1 = live(q0 + qr, k0 + kc + 1, p)
            ? exp2_approx(fmaf(s[j][2 * r + 1], scale_log2, -l2[r])) : 0.f;
        *reinterpret_cast<uint32_t*>(dSs + qr * LDPS + kc) =
            pack_bf16(p0 * (dp[j][2 * r] - dd[r]),
                      p1 * (dp[j][2 * r + 1] - dd[r]));
      }
    }
    __syncthreads();
    // stage 2: dQ += dS K, 16 rows x DH / 2 columns a warp
    stage2<DH>(dq, dSs, Kb, 16 * qw, half * DH / 2);
  }
  cp_wait<0>();

  bf16* dqp = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + 16 * qw + g + 8 * r;
    if (qpos >= p.Sq) continue;
    const long long at = ((static_cast<long long>(b) * p.Sq + qpos) * p.Hq
                          + h) * DH + half * DH / 2 + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<uint32_t*>(dqp + at + 8 * j) =
          pack_bf16(dq[j][2 * r] * p.scale, dq[j][2 * r + 1] * p.scale);
  }
}

template <int DH>
int launch(const Problem& p, cudaStream_t stream) {
  constexpr int b1 = dkdv_bytes<DH>(), b2 = dq_bytes<DH>();
  static_assert(b1 <= 232448 && b2 <= 232448, "over a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, b1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, b2);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = p.scale * LOG2E;
  dkdv_kernel<DH><<<dim3(p.B * p.Hkv, (p.Skv + BK - 1) / BK), THREADS, b1,
                    stream>>>(p, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<DH><<<dim3(p.B * p.Hq, (p.Sq + BQ - 1) / BQ), THREADS, b2,
                  stream>>>(p, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers:
// q, o, g (= dO) (B, sq, hq, dh) and k, v (B, skv, hkv, dh) with the head
// dimension contiguous, `strides` their (B, S, H) strides in elements in
// that order (15 values); lse the forward's (B, hq, sq) fp32; dsum a
// (B, hq, sq) fp32 workspace; dq, dk, dv contiguous outputs in the input
// type. dtype 0 is fp32, 1 bf16; tc 1 takes the tensor-core path (bf16, dh
// 64, 128 or 192, every pointer 16-byte aligned and every stride a
// multiple of 8 elements), 0 the CUDA-core path (dh <= 256). Launches the
// three kernels on `stream` and returns the first error (0 when every
// launch was accepted).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const float* lse, float* dsum, void* dq, void* dk,
    void* dv, const long long* strides, int B, int hq, int hkv, int sq,
    int skv, int dh, int causal, int dtype, int tc, void* stream) {
  Problem p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.g = g;
  p.lse = lse; p.dsum = dsum; p.dq = dq; p.dk = dk; p.dv = dv;
  for (int i = 0; i < 3; ++i) {
    p.st.q[i] = strides[i];
    p.st.k[i] = strides[3 + i];
    p.st.v[i] = strides[6 + i];
    p.st.o[i] = strides[9 + i];
    p.st.g[i] = strides[12 + i];
  }
  p.B = B; p.Hq = hq; p.Hkv = hkv; p.Sq = sq; p.Skv = skv; p.dh = dh;
  p.causal = causal;
  p.scale = 1.0f / sqrtf(static_cast<float>(dh));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * hq * sq;
  const unsigned blocks = static_cast<unsigned>((rows * 32 + 255) / 256);
  if (dtype == 0)
    dsum_kernel<float><<<blocks, 256, 0, s>>>(p);
  else
    dsum_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tc) {
    if (dh == 64) return tc::launch<64>(p, s);
    if (dh == 128) return tc::launch<128>(p, s);
    return tc::launch<192>(p, s);
  }
  if (dtype == 0) return simt::dispatch<float>(p, s);
  return simt::dispatch<__nv_bfloat16>(p, s);
}
