// Flash-attention backward for Hopper (sm_90a): the gradient of
// flash_attention.cu's forward, deterministic (the same inputs give the
// same dq, dk and dv to the bit), with no float atomics.
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
// tensor is ever stored; dP = dO V^T, dS = P (dP - D) with D = rowsum(dO o
// O), dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K. A masked score's P
// is set to 0 by the mask, not by its exp, so no row yields NaN.
//
// Bound on an H100 SXM: 8 * B * Hq * dh * pairs operations (pairs = scored
// (q, k) pairs: dV, dP, dS K and dS^T Q) against q + k + v + o + do + lse
// read and dq + dk + dv written. Operations bound it at the training
// shapes (starcoder2-3b, B 8, SL 2816, Hq 24, dh 128, causal: 0.44 TFLOP,
// 0.44 ms at 989 TFLOP/s; 0.15 ms by bytes).
//
// Tensor-core path (bf16 at head_dim 64, 128 or 192: every bf16 training
// phase), FlashAttention-3-style: 10 dh operations a scored pair (S and dP
// once, dV, dK, dQ), in three kernels on one stream:
//  (a) prep: D = rowsum(dO o O) and lse * log2 e of every query row into a
//      workspace padded to whole query tiles (a padded row's lse is 1e30,
//      so its P is 0 with no mask);
//  (b) the main kernel, one block per (key tile, b, KV head, part of the
//      GQA group), 384 threads: two consumer warpgroups and a producer
//      warpgroup that gives its registers up (setmaxnreg 24 / 240). The
//      block walks every query head of its part of the group and every
//      query tile that its keys meet (from the diagonal down, causal):
//       * the producer's first warp loads K and V once and streams Q, dO,
//         lse and D of each step by TMA (tiles in the 128-byte swizzle,
//         lse and D by 1-d bulk copies) into a ring of two stages behind
//         full and empty mbarriers;
//       * keys are the M dimension: S^T = K Q^T and dP^T = V dO^T are
//         wgmma with both operands in shared memory, so P^T and dS^T land
//         in registers in the A-fragment layout; dV += P^T dO and dK +=
//         dS^T Q are wgmma with A from registers and dO / Q read MN-major,
//         as the forward does P V; dS^T goes once to shared memory in bf16
//         and dQ = dS K reads it M-major, with K as the N-major B operand.
//         Only tiles that the diagonal or the Skv edge cross are masked;
//       * dh 64: 128 keys (64 a warpgroup) x 128 query rows a step, S^T and
//         dP^T by halves of 64 rows, each warpgroup dQ's rows of its half;
//         dh 128: 128 keys x 64 rows, each warpgroup 64 of dQ's columns;
//         dh 192: one warpgroup's dK and dV for 64
//         keys would take 192 registers a thread, so the two share 64 keys
//         by role: the first forms S^T, P^T (handed to the second in fp32
//         through shared memory) and dV, the second dP^T, dS^T and dK, and
//         each forms 128 of dQ's columns (the second's last 64 dropped), so
//         both issue the same wgmma. No spills: the consumers' shared-memory
//         addresses are formed in each step from an opaque base (hoisted out
//         of the walk they held registers), with explicit ld / st.shared;
//       * dQ, fixed order: each step's fp32 dQ tile goes to a shared-memory
//         buffer (two at dh 64 and 128), which the producer's second warp
//         adds into an fp32 workspace (B, Hq, query tile, BQ x dh, in the
//         accumulators' fragment order) by one bulk reduce-add once a
//         per-(b, query head, query tile) counter says that every earlier
//         key tile has added its part (the first stores, so nothing is
//         zeroed but the counters, by a memset on the stream, inside a
//         captured graph too); a counter moves only once its add is
//         complete. The order, and the grid's order with it (`order`):
//         causal, from the diagonal's key tile down, which a lockstep walk
//         reaches first, a group's key tiles launched together, the longest
//         walk first; not causal, key tile kt's walk starting at query tile
//         kt, a tile's adds in the order the walks reach it, so the blocks
//         of a group add to different tiles at once and a group's dQ stays
//         in L2; where a group has more key tiles than query tiles, key
//         tiles in order, the key tile the slowest index of the grid. Where
//         a group's key tiles outnumber the SMs (so could not all be on the
//         card at once) every block waits only on blocks launched before it;
//       * dK and dV stay in registers over the whole walk: written once in
//         bf16, or, where the wrapper splits the GQA group (to fill the card
//         at a short SL, or so that the dQ tiles of the blocks on the card
//         stay in L2 at a long one: kernel.py's bwd_parts), as fp32 parts
//         of the workspace;
//  (c) finish: dq = scale * the dQ workspace in bf16, and the parts of dK
//      and dV summed in order.
// The workspace's layout is this file's and kernel.py's bwd_workspace's.
//
// CUDA-core path (fp32, or bf16 at any other head_dim <= 256: the fp32
// parity runs at dh 64, 128 and 192). fp32 FMAs on tiles of 32 query rows
// and 32 keys staged in shared memory as fp32 (head_dim padded with zeros
// to 64, 128, 192 or 256), 256 threads: for S and dP each thread owns one
// row and four keys; for the products that follow, one key (or row) and
// dh / 8 columns, dK and dV (or dQ) in registers. D first, then (b) one
// block per (b, KV head, key tile) for dK and dV, summing the GQA group in
// registers, then (c) one block per (b, query head, query tile) for dQ: S
// and dP are formed twice, 14 dh operations a scored pair.

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
// a padded query row's lse * log2 e: exp2(s * scale_log2 - PAD_LSE2) is 0
constexpr float PAD_LSE2 = 1e30f;

// (B, S, H) strides, in elements, of q, k, v, o and do; the head dimension
// is contiguous
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3];
};

struct Problem {
  const void *q, *k, *v, *o, *g;
  const float* lse;                 // (B, Hq, Sq)
  float* work;                      // the workspace (kernel.py)
  float* dsum;                      // D, (B, Hq, Sq) on the CUDA-core path
  void *dq, *dk, *dv;               // contiguous
  Strides st;
  int B, Hq, Hkv, Sq, Skv, dh, causal, parts;
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
// CUDA-core path's D = rowsum(dO o O), one warp a (b, h, row)

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

using namespace hopper;

// A build for measurement only (examples/bench_recurrent_kernels_torch.py)
// may take parts of the main kernel out, computing wrong gradients: bit 1
// skips dQ's counters and adds (the tiles are only handed back), 2 dQ's
// product and its store, 4 the P and dS arithmetic (P = S, dS = dP)
#ifndef FLASH_BWD_ABLATE
#define FLASH_BWD_ABLATE 0
#endif
constexpr int ABLATE = FLASH_BWD_ABLATE;

constexpr int STAGES = 2;           // Q / dO ring depth
constexpr int CONSUMERS = 256;      // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup

// Keys a block (BK) and query rows a step (BQ) by head dim (kernel.py's
// TC_BWD_TILES)
template <int DH> struct Tiles;
template <> struct Tiles<64> { static constexpr int BK = 128, BQ = 128; };
template <> struct Tiles<128> { static constexpr int BK = 128, BQ = 64; };
template <> struct Tiles<192> { static constexpr int BK = 64, BQ = 64; };

// Dynamic shared memory, from a 1024-byte aligned base: K and V, the Q and
// dO rings, dS^T (bf16, [key][query], a region a 64 queries), P^T (fp32,
// dh 192 only), the dQ buffers (fp32), the lse and D rings, the mbarriers.
template <int DH>
struct Layout {
  static constexpr int BK = Tiles<DH>::BK, BQ = Tiles<DH>::BQ;
  static constexpr bool ROLES = DH > 128;   // warpgroups split by role
  static constexpr int NDQ = ROLES ? 1 : 2;  // dQ buffers
  static constexpr int NA = DH / ATOM;
  static constexpr int KV_BYTES = NA * BK * ROW;
  static constexpr int QS_BYTES = NA * BQ * ROW;   // one stage of Q or dO
  static constexpr int DS_BYTES = BQ / ATOM * BK * ROW;
  static constexpr int P_BYTES = ROLES ? 64 * BQ * 4 : 0;
  static constexpr int DQ_BYTES = BQ * DH * 4;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int G_OFF = Q_OFF + STAGES * QS_BYTES;
  static constexpr int DS_OFF = G_OFF + STAGES * QS_BYTES;
  static constexpr int P_OFF = DS_OFF + DS_BYTES;
  static constexpr int DQ_OFF = P_OFF + P_BYTES;
  static constexpr int L_OFF = DQ_OFF + NDQ * DQ_BYTES;
  static constexpr int D_OFF = L_OFF + STAGES * BQ * 4;
  static constexpr int BAR_OFF = D_OFF + STAGES * BQ * 4;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 2 * NDQ + 1)
                               + 1024;
};

struct Params {
  const float* lse2;                // (B, Hq, pad): lse * log2 e
  const float* dsum;                // (B, Hq, pad): D
  int* sems;                        // (B, Hq, n_qt): dQ parts added
  float* dq_acc;                    // (B, Hq, n_qt, BQ * dh), fragment order
  float* part;                      // parts > 1: dK's, then dV's parts
  __nv_bfloat16 *dq, *dk, *dv;
  int B, Hq, Hkv, Sq, Skv, causal, parts, n_kt, n_qt, pad, order;
  float scale, scale_log2;
};

// A named barrier of the two consumer warpgroups
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}
// this thread's writes to shared memory, seen by the async proxy (wgmma,
// bulk copies)
__device__ __forceinline__ void fence_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 1-d bulk copies (16-byte aligned, sizes multiples of 16 bytes): global to
// shared counted on `bar`; shared to global as a store or an fp32 add
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
               "%2;\n" :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_add(void* dst, uint32_t src,
                                         uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
               "[%0], [%1], %2;\n" :: "l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// d (64 x 64) (+)= A (64 x 16, shared, M-major) * B (16 x 64, shared,
// N-major): both transpose bits set
__device__ __forceinline__ void wgmma_tt(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) (+)= A (64 x 16, shared, M-major) * B (16 x 128, shared,
// N-major)
__device__ __forceinline__ void wgmma_tt(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The value, opaque to the compiler: shared-memory addresses derived from it
// in a loop are formed in each iteration, not hoisted out of the loop, where
// they would hold registers (or spill) for the whole walk
__device__ __forceinline__ uint32_t fresh(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// X^T = A B^T for one warpgroup's 64 rows of A (keys: K or V, from a_wg)
// and 64 of the stage's BQ rows of B (Q or dO, from b): k16 steps along dh,
// 32 bytes further into the swizzled rows, the next 64 columns one region
// further
template <int DH, int BK, int BQ>
__device__ __forceinline__ void issue_kq(float (&d)[32], uint32_t a_wg,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(d, sw128_desc(a_wg + (kk / 4) * BK * ROW + col, 16, 1024),
             sw128_desc(b + (kk / 4) * BQ * ROW + col, 16, 1024), kk > 0);
  }
}

// d += A B: A the BQ / 16 k16 fragments of P^T or dS^T in registers, B the
// stage's dO or Q read MN-major (16 rows a step; dh's next 64 columns one
// region, BQ rows, further)
template <int BQ, int N>
__device__ __forceinline__ void issue_rs(float (&d)[N],
                                         const uint32_t (&a)[BQ / 16][4],
                                         uint32_t b_st) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
    wgmma_rs(d, a[kk], sw128_desc(b_st + kk * 16 * ROW, BQ * ROW, 1024));
}

// dQ (64 rows x N columns) = dS K over the block's BK keys: A from the
// dS^T tile (M-major, 16 key rows a step), B from K (N-major, from the
// region of its first column)
template <int BK, int N>
__device__ __forceinline__ void issue_dq(float (&d)[N], uint32_t ds,
                                         uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_tt(d, sw128_desc(ds + kk * 16 * ROW, BK * ROW, 1024),
             sw128_desc(k + kk * 16 * ROW, BK * ROW, 1024), kk > 0);
}

// Shared memory by 32-bit address (the consumers' addresses are formed in
// the loop from an opaque base, which would leave the compiler generic
// pointers)
__device__ __forceinline__ float2 lds2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts2(uint32_t a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
               :: "r"(a), "f"(x), "f"(y) : "memory");
}
__device__ __forceinline__ void sts(uint32_t a, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(a), "r"(x) : "memory");
}

// P^T = exp2(S^T scale log2 e - lse2) in place: element 4 j + e at key
// key0 + 8 (e / 2) and query q0 + 8 j + cq + e % 2, lse2 the step's row of
// lse * log2 e (a shared address). Masks only a tile that the diagonal or
// the Skv edge crosses (`edge`); a padded query row's lse2 makes its P 0.
template <int BQ>
__device__ __forceinline__ void probs(float (&s)[BQ / 2], uint32_t lse2,
                                      int key0, int q0, int cq, bool edge,
                                      int Skv, int causal, float scale_log2) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 l = lds2(lse2 + 4 * (8 * j + cq));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pv = exp2_approx(fmaf(s[4 * j + e], scale_log2,
                                  -((e & 1) ? l.y : l.x)));
      if (edge) {
        const int key = key0 + 8 * (e >> 1), q = q0 + 8 * j + cq + (e & 1);
        if (key >= Skv || (causal && key > q)) pv = 0.f;
      }
      s[4 * j + e] = pv;
    }
  }
}

// dS^T = P^T (dP^T - D), D by query column (dsum the step's row of D, a
// shared address), packed into bf16 A fragments as it is formed
template <int BQ>
__device__ __forceinline__ void dscores(const float (&pr)[BQ / 2],
                                        const float (&dp)[BQ / 2],
                                        uint32_t dsum, int cq,
                                        uint32_t (&da)[BQ / 16][4]) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 d = lds2(dsum + 4 * (8 * j + cq));
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ds[e] = ABLATE & 4 ? dp[4 * j + e]
              : pr[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d.y : d.x));
    da[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
    da[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
  }
}

// dS^T's bf16 fragments into the [key][query] tile at `tile`, rows krow
// and krow + 8 of BK, in the 128-byte swizzle: the 16-byte chunk j % 8 of
// a row XORed with the row % 8 (a warp's stores hit every bank once)
template <int BQ, int BK>
__device__ __forceinline__ void store_ds(uint32_t tile,
                                         const uint32_t (&a)[BQ / 16][4],
                                         int krow, int cq) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      sts(tile + (j / 8) * BK * ROW + (krow + 8 * r) * ROW
          + (((j % 8) ^ (krow & 7)) << 4) + 2 * cq,
          a[j / 2][(j % 2) * 2 + r]);
}

// A warpgroup's accumulator (N fp32 a thread) to or from shared memory at
// `buf` in fragment order: float2 i of the thread at (w4 N / 2 + i) 32 +
// lane, so a warp's accesses are 256 contiguous bytes. dQ's workspace
// keeps this order (frag_index).
template <int N>
__device__ __forceinline__ void store_frag(uint32_t buf, const float (&d)[N],
                                           int w4, int lane) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    sts2(buf + 8 * ((w4 * (N / 2) + i) * 32 + lane), d[2 * i], d[2 * i + 1]);
}
template <int N>
__device__ __forceinline__ void load_frag(uint32_t buf, float (&d)[N],
                                          int w4, int lane) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 v = lds2(buf + 8 * ((w4 * (N / 2) + i) * 32 + lane));
    d[2 * i] = v.x;
    d[2 * i + 1] = v.y;
  }
}

// Where dQ's element (row r, column c) of a query tile lies in its
// fragment-ordered tile: which warpgroup formed it (dh 64: rows by halves;
// dh 128: columns by halves; dh 192: columns 128 / 64), then the thread
// and register of store_frag
template <int DH>
__device__ __forceinline__ int frag_index(int r, int c) {
  int wg, rr, cc, n, base;
  if (DH == 64) {
    wg = r / 64; rr = r % 64; cc = c; n = 32; base = wg * 128 * 32;
  } else if (DH == 128) {
    wg = c / 64; rr = r; cc = c % 64; n = 32; base = wg * 128 * 32;
  } else {
    wg = c / 128; rr = r; cc = c % 128; n = wg ? 32 : 64;
    base = wg * 128 * 64;
  }
  const int w4 = rr / 16, lane = (rr % 8) * 4 + (cc % 8) / 2;
  const int i = 2 * (cc / 8) + (rr % 16) / 8;
  return base + ((w4 * (n / 2) + i) * 32 + lane) * 2 + cc % 2;
}

// A warpgroup's dK (scaled) or dV rows, keys key0 and key0 + 8, columns
// col0 + 8 j + cq: in bf16 to `out` (B, Skv, Hkv, dh), or with parts > 1
// in fp32 to part `part` of `acc`
template <int DH, int N>
__device__ __forceinline__ void write_kv(const float (&d)[N], float mul,
                                         __nv_bfloat16* out, float* acc,
                                         const Params& p, int b, int kvh,
                                         int part, int key0, int col0,
                                         int cq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.Skv) continue;
    const long long at = ((static_cast<long long>(b) * p.Skv + key) * p.Hkv
                          + kvh) * DH + col0 + cq;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float x = d[4 * j + 2 * r], y = d[4 * j + 2 * r + 1];
      if (p.parts == 1)
        *reinterpret_cast<uint32_t*>(out + at + 8 * j) =
            pack_bf16(x * mul, y * mul);
      else
        *reinterpret_cast<float2*>(
            acc + static_cast<long long>(part) * p.B * p.Skv * p.Hkv * DH
            + at + 8 * j) = make_float2(x, y);
    }
  }
}

// (a): D and lse * log2 e of every (b, query head, row), rows padded to
// `pad`: groups of DH / 8 lanes (in 8, 16 or 32) a row, 16 bytes of o and
// dO a lane
template <int DH>
__global__ void __launch_bounds__(256)
prep_kernel(const Problem p, int pad, float* lse2, float* dsum) {
  constexpr int TPR = DH / 8;
  constexpr int G = TPR <= 8 ? 8 : TPR <= 16 ? 16 : 32;
  const int lane = threadIdx.x % 32, sub = lane % G;
  const unsigned mask = G == 32 ? 0xffffffffu
                                : ((1u << G) - 1) << (lane / G * G);
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  if (row >= static_cast<long long>(p.B) * p.Hq * pad) return;
  const int i = row % pad, h = (row / pad) % p.Hq;
  const int b = row / (static_cast<long long>(pad) * p.Hq);
  float acc = 0.f;
  if (i < p.Sq && sub < TPR) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.o) + b * p.st.o[0]
        + i * p.st.o[1] + h * p.st.o[2] + 8 * sub);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.g) + b * p.st.g[0]
        + i * p.st.g[1] + h * p.st.g[2] + 8 * sub);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(o2[e]);
      const float2 gf = __bfloat1622float2(g2[e]);
      acc = fmaf(of.x, gf.x, acc);
      acc = fmaf(of.y, gf.y, acc);
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(mask, acc, off);
  if (sub == 0) {
    dsum[row] = acc;
    lse2[row] = i < p.Sq
        ? p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + i] * LOG2E
        : PAD_LSE2;
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
bwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_g, const Params p) {
  using L = Layout<DH>;
  constexpr int BK = L::BK, BQ = L::BQ, NA = L::NA, NDQ = L::NDQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // full[s], empty[s], dq_full[i], dq_empty[i], then K and V's
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t full = bars, empty = bars + 8 * STAGES;
  const uint32_t dq_full = bars + 16 * STAGES;
  const uint32_t dq_empty = dq_full + 8 * NDQ;
  const uint32_t kvbar = dq_empty + 8 * NDQ;

  // The block's key tile and (b, KV head, part of the group), by the
  // grid's order (launch): 0, the key tile the slowest index; else a
  // group's key tiles together, 3 the shortest walk first, 1 and 2 the
  // longest first, which needs a group's blocks to fit the card at once
  const int tid = threadIdx.x;
  const int group = p.Hq / p.Hkv, gp = group / p.parts;
  int kt, grp;
  if (p.order == 0) {
    const int n_grp = p.B * p.Hkv * p.parts;
    kt = blockIdx.x / n_grp;
    grp = blockIdx.x % n_grp;
  } else {
    grp = blockIdx.x / p.n_kt;
    const int i = blockIdx.x % p.n_kt;
    kt = p.order == 3 ? p.n_kt - 1 - i : i;
  }
  const int part = grp % p.parts, kvh = grp / p.parts % p.Hkv;
  const int b = grp / p.parts / p.Hkv;
  const int h0 = kvh * group + part * gp, k0 = kt * BK;
  // per query head, the query tiles (qt0 + i) % n_qt, i < per_head: causal
  // from the diagonal's on, none for a key tile past the last query (its
  // dK and dV are 0); otherwise all, order 1 from the kt-th on
  const int qt0 = p.causal ? k0 / BQ : p.order == 1 ? kt : 0;
  const int per_head = !p.causal ? p.n_qt
                       : k0 > p.Sq - 1 ? 0 : p.n_qt - qt0;
  const int n_it = gp * per_head;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    for (int i = 0; i < NDQ; ++i) {
      mbar_init(dq_full + 8 * i, CONSUMERS / 32);
      mbar_init(dq_empty + 8 * i, 1);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {           // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int warp = (tid - CONSUMERS) / 32;
    if (tid % 32 != 0) return;
    if (warp == 0 && n_it > 0) {    // loads
      mbar_expect_tx(kvbar, 2 * L::KV_BYTES);
      for (int a = 0; a < NA; ++a) {
        tma_load(base + L::K_OFF + a * BK * ROW, &tm_k, kvbar, a * ATOM, kvh,
                 k0, b);
        tma_load(base + L::V_OFF + a * BK * ROW, &tm_v, kvbar, a * ATOM, kvh,
                 k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)           // the consumers released step it - STAGES
          mbar_wait(empty + 8 * s, (it / STAGES - 1) & 1);
        const int h = h0 + it / per_head;
        const int q0 = (qt0 + it % per_head) % p.n_qt * BQ;
        const uint32_t f = full + 8 * s;
        mbar_expect_tx(f, 2 * L::QS_BYTES + 2 * BQ * 4);
        for (int a = 0; a < NA; ++a) {
          const uint32_t off = s * L::QS_BYTES + a * BQ * ROW;
          tma_load(base + L::Q_OFF + off, &tm_q, f, a * ATOM, h, q0, b);
          tma_load(base + L::G_OFF + off, &tm_g, f, a * ATOM, h, q0, b);
        }
        const long long row = (static_cast<long long>(b) * p.Hq + h) * p.pad
                              + q0;
        bulk_load(base + L::L_OFF + s * BQ * 4, p.lse2 + row, BQ * 4, f);
        bulk_load(base + L::D_OFF + s * BQ * 4, p.dsum + row, BQ * 4, f);
      }
    } else if (warp == 1) {         // dQ's ordered adds
      // a tile's add is issued once its turn comes and its buffer goes back
      // once read; its counter moves once it is complete, checked when the
      // next tile is in (never waiting on a later turn)
      int* prev = nullptr;
      for (int it = 0; it < n_it; ++it) {
        const int i = it % NDQ;
        mbar_wait(dq_full + 8 * i, (it / NDQ) & 1);
        const int h = h0 + it / per_head;
        const int qt = (qt0 + it % per_head) % p.n_qt;
        if (!(ABLATE & 1) && prev != nullptr) {
          asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          red_release(prev, 1);
        }
        // the key tiles that add to query tile qt before this one: causal,
        // from the last that meets it down to kt + 1; order 1, those whose
        // walk reaches it sooner; order 0, 0 .. kt - 1
        int before = kt;
        if (p.causal) {
          before = min(p.n_kt - 1, min(qt * BQ + BQ - 1, p.Sq - 1) / BK) - kt;
        } else if (p.order == 1) {
          const int mine = (qt - kt + p.n_qt) % p.n_qt;
          before = 0;
          for (int o = 0; o < p.n_kt; ++o)
            before += (qt - o + p.n_qt) % p.n_qt < mine;
        }
        const long long t = (static_cast<long long>(b) * p.Hq + h) * p.n_qt
                            + qt;
        if (!(ABLATE & 1)) {
          if (before > 0) {
            while (ld_acquire(p.sems + t) != before) {
            }
            asm volatile("fence.proxy.async.global;\n" ::: "memory");
          }
          float* dst = p.dq_acc + t * (BQ * DH);
          const uint32_t src = base + L::DQ_OFF + i * L::DQ_BYTES;
          if (before == 0)
            bulk_store(dst, src, L::DQ_BYTES);
          else
            bulk_add(dst, src, L::DQ_BYTES);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        mbar_arrive(dq_empty + 8 * i);
        prev = p.sems + t;
      }
      if (!(ABLATE & 1) && prev != nullptr) {
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        red_release(prev, 1);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = tid / 128, lane = tid % 32, w4 = (tid % 128) / 32;
  const int r_in = w4 * 16 + lane / 4;   // the thread's rows: r_in, r_in + 8
  const int cq = 2 * (lane % 4);         // its column pair in each 8
  if (n_it > 0) mbar_wait(kvbar, 0);

  if constexpr (!L::ROLES) {
    // Each warpgroup owns 64 of the block's 128 keys
    const int krow = wg * 64 + r_in;
    float dk[DH / 2], dv[DH / 2];
    zero(dk);
    zero(dv);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES, i = it % NDQ;
      const int q0 = (qt0 + it % per_head) % p.n_qt * BQ;
      const uint32_t sb = fresh(base);
      const uint32_t k_wg = sb + L::K_OFF + wg * 64 * ROW;
      const uint32_t v_wg = sb + L::V_OFF + wg * 64 * ROW;
      const uint32_t qs = sb + L::Q_OFF + s * L::QS_BYTES;
      const uint32_t gs = sb + L::G_OFF + s * L::QS_BYTES;
      const uint32_t lse2 = sb + L::L_OFF + s * BQ * 4;
      const uint32_t dsum = sb + L::D_OFF + s * BQ * 4;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      // S^T, dP^T, P^T and dS^T by 64 queries at a time (dh 64: two
      // halves), so that at most 64 of each are in registers beside dK and
      // dV; P^T while dP^T is formed
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int hq = 0; hq < BQ / 64; ++hq) {
        float sc[32], dp[32];
        wgmma_fence();
        issue_kq<DH, BK, BQ>(sc, k_wg, qs + hq * 64 * ROW);   // S^T = K Q^T
        wgmma_commit();
        issue_kq<DH, BK, BQ>(dp, v_wg, gs + hq * 64 * ROW);   // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<1>();
        pin(sc);
        const int qh = q0 + hq * 64;
        const bool edge = k0 + wg * 64 + 64 > p.Skv
                          || (p.causal && k0 + wg * 64 + 63 > qh);
        if (!(ABLATE & 4))
          probs<64>(sc, lse2 + hq * 256, k0 + krow, qh, cq, edge, p.Skv,
                    p.causal, p.scale_log2);
        wgmma_wait<0>();
        pin(dp);
        pack_p<64>(sc, *reinterpret_cast<uint32_t(*)[4][4]>(pa[4 * hq]));
        dscores<64>(sc, dp, dsum + hq * 256, cq,
                    *reinterpret_cast<uint32_t(*)[4][4]>(da[4 * hq]));
      }
      bar_sync(1);                  // the last step's dQ products are done
      store_ds<BQ, BK>(sb + L::DS_OFF, da, krow, cq);
      fence_smem();
      wgmma_fence();
      issue_rs<BQ>(dv, pa, gs);     // dV += P^T dO
      issue_rs<BQ>(dk, da, qs);     // dK += dS^T Q
      wgmma_commit();
      bar_sync(2);                  // dS^T is whole
      if (it >= NDQ) mbar_wait(dq_empty + 8 * i, (it / NDQ - 1) & 1);
      // dQ: dh 64, this warpgroup's 64 query rows (a dS^T region); dh 128,
      // its 64 columns (a K region)
      float dq[32];
      wgmma_fence();
      if (!(ABLATE & 2))
        issue_dq<BK>(dq, sb + L::DS_OFF + (DH == 64 ? wg * BK * ROW : 0),
                     sb + L::K_OFF + (DH == 64 ? 0 : wg * BK * ROW));
      wgmma_commit();
      wgmma_wait<0>();
      pin(dv);
      pin(dk);
      pin(dq);
      pin(pa);
      pin(da);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (!(ABLATE & 2))
        store_frag(sb + L::DQ_OFF + i * L::DQ_BYTES + wg * 128 * 32 * 4, dq,
                   w4, lane);
      fence_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(dq_full + 8 * i);
    }
    write_kv<DH>(dk, p.scale, p.dk, p.part, p, b, kvh, part, k0 + krow, 0,
                 cq);
    write_kv<DH>(dv, 1.f, p.dv, p.part + static_cast<long long>(p.parts)
                 * p.B * p.Skv * p.Hkv * DH, p, b, kvh, part, k0 + krow, 0,
                 cq);
  } else {
    // Both warpgroups on the block's 64 keys: the first forms P^T and dV,
    // the second dS^T and dK; named barrier 1 hands P^T over, 2 dS^T back
    float acc[DH / 2];
    zero(acc);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES, i = it % NDQ;
      const int q0 = (qt0 + it % per_head) % p.n_qt * BQ;
      const uint32_t sb = fresh(base);
      const uint32_t pbuf = sb + L::P_OFF;
      const uint32_t qs = sb + L::Q_OFF + s * L::QS_BYTES;
      const uint32_t gs = sb + L::G_OFF + s * L::QS_BYTES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      float sc[BQ / 2];
      wgmma_fence();                // S^T = K Q^T | dP^T = V dO^T
      issue_kq<DH, BK, BQ>(sc, sb + (wg == 0 ? L::K_OFF : L::V_OFF),
                           wg == 0 ? qs : gs);
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      uint32_t a[BQ / 16][4];
      if (wg == 0) {
        const bool edge = k0 + 64 > p.Skv || (p.causal && k0 + 63 > q0);
        if (!(ABLATE & 4))
          probs<BQ>(sc, sb + L::L_OFF + s * BQ * 4, k0 + r_in, q0, cq, edge,
                    p.Skv, p.causal, p.scale_log2);
        store_frag(pbuf, sc, w4, lane);
        bar_arrive(1);
        pack_p<BQ>(sc, a);
      } else {
        float pr[BQ / 2];
        bar_sync(1);
        load_frag(pbuf, pr, w4, lane);
        dscores<BQ>(pr, sc, sb + L::D_OFF + s * BQ * 4, cq, a);
        store_ds<BQ, BK>(sb + L::DS_OFF, a, r_in, cq);
        fence_smem();
        bar_arrive(2);
      }
      wgmma_fence();
      issue_rs<BQ>(acc, a, wg == 0 ? gs : qs);  // dV += P^T dO | dK += dS^T Q
      wgmma_commit();
      if (wg == 0) bar_sync(2);     // dS^T is whole
      if (it >= NDQ) mbar_wait(dq_empty + 8 * i, (it / NDQ - 1) & 1);
      const uint32_t dqb = sb + L::DQ_OFF + i * L::DQ_BYTES;
      wgmma_fence();
      // dQ's columns 0-127 | 128-255, of which 192-255 (read from V's
      // first region) are dropped: both warpgroups issue the same products
      float dq[64];
      if (!(ABLATE & 2))
        issue_dq<BK>(dq, sb + L::DS_OFF, sb + L::K_OFF + wg * 2 * BK * ROW);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      pin(dq);
      pin(a);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (!(ABLATE & 2)) {
        if (wg == 0)
          store_frag(dqb, dq, w4, lane);
        else
          store_frag(dqb + 128 * 64 * 4,
                     *reinterpret_cast<const float(*)[32]>(&dq[0]), w4, lane);
      }
      fence_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(dq_full + 8 * i);
    }
    const long long n = static_cast<long long>(p.parts) * p.B * p.Skv
                        * p.Hkv * DH;
    if (wg == 0)
      write_kv<DH>(acc, 1.f, p.dv, p.part + n, p, b, kvh, part, k0 + r_in, 0,
                   cq);
    else
      write_kv<DH>(acc, p.scale, p.dk, p.part, p, b, kvh, part, k0 + r_in,
                   0, cq);
  }
}

__device__ __forceinline__ uint2 pack4(float4 v, float mul) {
  return make_uint2(pack_bf16(v.x * mul, v.y * mul),
                    pack_bf16(v.z * mul, v.w * mul));
}

// (c): dq in bf16 from the dQ workspace, and with parts > 1 dK and dV
// from their parts, summed in order; four columns a thread (16 bytes of
// the workspace: columns c .. c + 3 of a fragment-ordered tile are two
// neighbouring threads' pairs)
template <int DH>
__global__ void __launch_bounds__(256) finish_kernel(const Params p) {
  constexpr int BQ = Tiles<DH>::BQ;
  const long long nq = static_cast<long long>(p.B) * p.Sq * p.Hq * (DH / 4);
  const long long rows_kv = static_cast<long long>(p.B) * p.Skv * p.Hkv;
  const long long nk = p.parts > 1 ? rows_kv * (DH / 4) : 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < nq + nk; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < nq) {
      const int c = 4 * static_cast<int>(i % (DH / 4));
      const long long row = i / (DH / 4);          // (b, query, head)
      const int h = row % p.Hq, q = (row / p.Hq) % p.Sq;
      const int b = row / (static_cast<long long>(p.Hq) * p.Sq);
      const float* tile =
          p.dq_acc + ((static_cast<long long>(b) * p.Hq + h) * p.n_qt
                      + q / BQ) * (BQ * DH);
      const float4 v =
          *reinterpret_cast<const float4*>(tile + frag_index<DH>(q % BQ, c));
      *reinterpret_cast<uint2*>(p.dq + row * DH + c) = pack4(v, p.scale);
    } else {
      const long long j = i - nq;
      const long long at = j / (DH / 4) * DH + 4 * (j % (DH / 4));
      const long long n = rows_kv * DH;
      float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
      for (int part = 0; part < p.parts; ++part) {
        const float4 x = *reinterpret_cast<const float4*>(p.part + part * n
                                                          + at);
        const float4 y = *reinterpret_cast<const float4*>(
            p.part + (p.parts + part) * n + at);
        sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
        sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
      }
      *reinterpret_cast<uint2*>(p.dk + at) = pack4(sk, p.scale);
      *reinterpret_cast<uint2*>(p.dv + at) = pack4(sv, 1.f);
    }
  }
}

template <int DH>
int launch(const Problem& pr, int sms, cudaStream_t stream) {
  using L = Layout<DH>;
  constexpr int BK = L::BK, BQ = L::BQ;
  Params p;
  p.B = pr.B; p.Hq = pr.Hq; p.Hkv = pr.Hkv; p.Sq = pr.Sq; p.Skv = pr.Skv;
  p.causal = pr.causal; p.parts = pr.parts;
  p.n_kt = (pr.Skv + BK - 1) / BK;
  p.n_qt = (pr.Sq + BQ - 1) / BQ;
  p.pad = p.n_qt * BQ;
  // the grid's order (bwd_tc_kernel): a group's key tiles together where
  // they fit the card at once, and, not causal, where each can start its
  // walk at a query tile of its own
  p.order = pr.causal ? (p.n_kt <= sms ? 2 : 3)
                      : (p.n_kt <= sms && p.n_kt <= p.n_qt ? 1 : 0);
  p.scale = pr.scale;
  p.scale_log2 = pr.scale * LOG2E;
  // the workspace (kernel.py's bwd_workspace): lse2 and D, padded rows;
  // the counters, in a multiple of 16 bytes; dQ's tiles; dK's and dV's
  // parts
  const long long rows = static_cast<long long>(pr.B) * pr.Hq * p.pad;
  const long long tiles = static_cast<long long>(pr.B) * pr.Hq * p.n_qt;
  float* w = pr.work;
  p.lse2 = w;
  p.dsum = w + rows;
  p.sems = reinterpret_cast<int*>(w + 2 * rows);
  p.dq_acc = w + 2 * rows + (tiles + 3) / 4 * 4;
  p.part = p.dq_acc + tiles * BQ * DH;
  p.dq = static_cast<__nv_bfloat16*>(pr.dq);
  p.dk = static_cast<__nv_bfloat16*>(pr.dk);
  p.dv = static_cast<__nv_bfloat16*>(pr.dv);

  CUtensorMap mq, mk, mv, mg;
  int err = make_map(&mq, pr.q, pr.st.q, pr.B, pr.Sq, pr.Hq, DH, BQ);
  if (!err) err = make_map(&mk, pr.k, pr.st.k, pr.B, pr.Skv, pr.Hkv, DH, BK);
  if (!err) err = make_map(&mv, pr.v, pr.st.v, pr.B, pr.Skv, pr.Hkv, DH, BK);
  if (!err) err = make_map(&mg, pr.g, pr.st.g, pr.B, pr.Sq, pr.Hq, DH, BQ);
  if (err) return err;
  constexpr int G = DH / 8 <= 8 ? 8 : DH / 8 <= 16 ? 16 : 32;
  prep_kernel<DH><<<static_cast<unsigned>((rows * G + 255) / 256), 256, 0,
                    stream>>>(pr, p.pad, w, w + rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(p.sems, 0, tiles * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int bytes = L::BYTES;
  static_assert(bytes <= 232448, "over a block's shared memory");
  e = cudaFuncSetAttribute(bwd_tc_kernel<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = p.n_kt * pr.B * pr.Hkv * pr.parts;
  bwd_tc_kernel<DH><<<blocks, THREADS, bytes, stream>>>(mq, mk, mv, mg, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long work = static_cast<long long>(pr.B) * pr.Sq * pr.Hq * DH / 4
      + (pr.parts > 1 ? static_cast<long long>(pr.B) * pr.Skv * pr.Hkv * DH / 4
                      : 0);
  const int grid = static_cast<int>(
      (work + 255) / 256 < 16LL * sms ? (work + 255) / 256 : 16LL * sms);
  finish_kernel<DH><<<grid, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers:
// q, o, g (= dO) (B, sq, hq, dh) and k, v (B, skv, hkv, dh) with the head
// dimension contiguous, `strides` their (B, S, H) strides in elements in
// that order (15 values); lse the forward's (B, hq, sq) fp32; work an fp32
// workspace of kernel.py's bwd_workspace; dq, dk, dv contiguous outputs in
// the input type. dtype 0 is fp32, 1 bf16; tc 1 takes the tensor-core path
// (bf16, dh 64, 128 or 192, every pointer 16-byte aligned and every stride
// a multiple of 8 elements; `parts` divides hq / hkv), 0 the CUDA-core
// path (dh <= 256; parts 1). Launches the kernels on `stream` and returns
// the first error (0 when every launch was accepted): a CUDA error, or
// 10000 + a CUresult when a tensor map is refused, or 20000 when the
// driver has no cuTensorMapEncodeTiled.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const float* lse, float* work, void* dq, void* dk,
    void* dv, const long long* strides, int B, int hq, int hkv, int sq,
    int skv, int dh, int causal, int dtype, int tc, int parts,
    void* stream) {
  Problem p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.g = g;
  p.lse = lse; p.work = work; p.dsum = work;
  p.dq = dq; p.dk = dk; p.dv = dv;
  for (int i = 0; i < 3; ++i) {
    p.st.q[i] = strides[i];
    p.st.k[i] = strides[3 + i];
    p.st.v[i] = strides[6 + i];
    p.st.o[i] = strides[9 + i];
    p.st.g[i] = strides[12 + i];
  }
  p.B = B; p.Hq = hq; p.Hkv = hkv; p.Sq = sq; p.Skv = skv; p.dh = dh;
  p.causal = causal; p.parts = parts;
  p.scale = 1.0f / sqrtf(static_cast<float>(dh));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dh == 64) return tc::launch<64>(p, sms, s);
    if (dh == 128) return tc::launch<128>(p, sms, s);
    return tc::launch<192>(p, sms, s);
  }
  const long long rows = static_cast<long long>(B) * hq * sq;
  const unsigned blocks = static_cast<unsigned>((rows * 32 + 255) / 256);
  if (dtype == 0)
    dsum_kernel<float><<<blocks, 256, 0, s>>>(p);
  else
    dsum_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0) return simt::dispatch<float>(p, s);
  return simt::dispatch<__nv_bfloat16>(p, s);
}
