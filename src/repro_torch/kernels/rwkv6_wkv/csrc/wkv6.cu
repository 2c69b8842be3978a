// RWKV-6 WKV forward for Hopper (sm_90a): fp32 in, fp32 math, fp32 out.
//
// Replaces src/repro/kernels/rwkv6_wkv/kernel.py::wkv6_fwd (the Pallas TPU
// kernel _wkv6_kernel). Per (batch b, head h) it runs the recurrence of the
// reference oracle over a (dh x dh) state S, carried from `state0` (zeros
// when null) and returned in `state_out`:
//     y_t = r_t^T S + (sum_i r_t,i u_i k_t,i) v_t
//     S  <- diag(exp(lw_t)) S + k_t v_t^T
// r, k, v, lw and y are read and written in the model's (B, S, H, dh)
// layout in place (timestep stride H * dh, head stride dh), u as (H, dh) by
// head index, the states as (B, H, dh, dh) with S[i][j] at i * dh + j.
//
// Bound on an H100 SXM: bytes. Per (b, h, t) the recurrence does
// 5 * dh^2 + 5 * dh operations (r^T S as dh^2 multiply-adds, the decay and
// the rank-1 update as dh^2 multiplies and dh^2 multiply-adds, the bonus
// term and exp(lw)) on 5 * dh fp32 inputs and outputs: at rwkv6-3b's
// serving shapes (B = 4, H = 40, dh = 64, S = 1536) that is 5.1 GFLOP,
// 75 us at 67 TFLOP/s, against 315 MB of r, k, v, lw and y plus the
// states, 95 us at 3.35 TB/s.
//
// Design (simple and right first). The TPU kernel expands the recurrence
// into (C x C) matrix products per 64-step chunk, because its MXU wants
// matrices, and needs the log-decay clamp so that exp(-cumsum) stays finite.
// Here the state lives in registers and the steps run one after the other,
// the oracle's own arithmetic (fewer operations than the chunked form's
// four (C x C) or (dh x dh) products per chunk, and no exp(-cumsum)):
//  * one block owns one (b, h) and 16 of its dh value columns, so B * H *
//    dh / 16 blocks of 64 threads run at once (640 at the serving shape,
//    one wave on 132 SMs); columns of S evolve independently, so nothing
//    crosses blocks;
//  * the four threads of a column split its dh key rows, each keeping
//    dh / 4 entries of S in registers, and sum their parts of y_t with two
//    warp shuffles; a thread's rows are float4 groups interleaved with its
//    neighbours', so the four read adjacent 16-byte words of shared memory;
//  * 32 timesteps of r, k, exp(lw) (all rows) and v (the block's columns)
//    are staged in static shared memory (27 KB) with 16-byte loads, and the
//    bonus weight sum_i r_i u_i k_i of each step is reduced once per step by
//    one warp, not once per column;
//  * any S >= 1 runs: the last pass stages and steps only the rows that
//    exist, so a ragged tail neither adds to the state nor decays it.

#include <cuda_runtime.h>

namespace {

constexpr int T = 32;              // timesteps staged per pass
constexpr int JB = 16;             // value columns per block
constexpr int QS = 4;              // threads per column (key rows split)
constexpr int THREADS = JB * QS;

template <int DH>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, const float* __restrict__ state0,
            float* __restrict__ y, float* __restrict__ state_out, int S,
            int H) {
  constexpr int G = DH / (4 * QS);   // float4 groups of rows per thread
  constexpr int V4 = DH / 4;         // float4s per staged row
  __shared__ __align__(16) float rs[T][DH];
  __shared__ __align__(16) float ks[T][DH];
  __shared__ __align__(16) float ws[T][DH];
  __shared__ float vs[T][JB];
  __shared__ float as[T];
  __shared__ float us[DH];

  const int tid = threadIdx.x;
  const int q = tid % QS;            // which share of the key rows
  const int jl = tid / QS;           // column within the block
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j0 = blockIdx.y * JB;
  const int j = j0 + jl;

  // this thread's rows: 4 * (q + QS * g) + e for g < G, e < 4
  float st[4 * G];
  const size_t sbase = (size_t)bh * DH * DH;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (q + QS * g) + e;
      st[4 * g + e] =
          state0 != nullptr ? state0[sbase + (size_t)i * DH + j] : 0.f;
    }
  }
  for (int i = tid; i < DH; i += THREADS) us[i] = u[h * DH + i];

  const size_t row = (size_t)H * DH;                 // timestep stride
  const size_t base = (size_t)b * S * row + (size_t)h * DH;
  const int warp = tid / 32, lane = tid % 32;
  for (int t0 = 0; t0 < S; t0 += T) {
    const int n = min(T, S - t0);
    __syncthreads();                 // the last pass is done with the stage
    for (int idx = tid; idx < n * V4; idx += THREADS) {
      const int tt = idx / V4, c = 4 * (idx % V4);
      const size_t gi = base + (size_t)(t0 + tt) * row + c;
      *reinterpret_cast<float4*>(&rs[tt][c]) =
          *reinterpret_cast<const float4*>(r + gi);
      *reinterpret_cast<float4*>(&ks[tt][c]) =
          *reinterpret_cast<const float4*>(k + gi);
      const float4 l = *reinterpret_cast<const float4*>(lw + gi);
      *reinterpret_cast<float4*>(&ws[tt][c]) =
          make_float4(expf(l.x), expf(l.y), expf(l.z), expf(l.w));
    }
    for (int idx = tid; idx < n * JB; idx += THREADS) {
      const int tt = idx / JB, c = idx % JB;
      vs[tt][c] = v[base + (size_t)(t0 + tt) * row + j0 + c];
    }
    __syncthreads();
    for (int tt = warp; tt < n; tt += THREADS / 32) {
      float p = 0.f;
      for (int i = lane; i < DH; i += 32)
        p = fmaf(rs[tt][i] * us[i], ks[tt][i], p);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) as[tt] = p;
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][jl];
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = 4 * (q + QS * g);
        const float4 rr = *reinterpret_cast<const float4*>(&rs[tt][c]);
        const float4 kk = *reinterpret_cast<const float4*>(&ks[tt][c]);
        const float4 ww = *reinterpret_cast<const float4*>(&ws[tt][c]);
        acc.x = fmaf(rr.x, st[4 * g + 0], acc.x);
        acc.y = fmaf(rr.y, st[4 * g + 1], acc.y);
        acc.z = fmaf(rr.z, st[4 * g + 2], acc.z);
        acc.w = fmaf(rr.w, st[4 * g + 3], acc.w);
        st[4 * g + 0] = fmaf(ww.x, st[4 * g + 0], kk.x * vj);
        st[4 * g + 1] = fmaf(ww.y, st[4 * g + 1], kk.y * vj);
        st[4 * g + 2] = fmaf(ww.z, st[4 * g + 2], kk.z * vj);
        st[4 * g + 3] = fmaf(ww.w, st[4 * g + 3], kk.w * vj);
      }
      float part = (acc.x + acc.y) + (acc.z + acc.w);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (q == 0)
        y[base + (size_t)(t0 + tt) * row + j] = fmaf(as[tt], vj, part);
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (q + QS * g) + e;
      state_out[sbase + (size_t)i * DH + j] = st[4 * g + e];
    }
  }
}

template <int DH>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* state0, float* y, float* state_out,
           int B, int S, int H, cudaStream_t stream) {
  const dim3 grid(B * H, DH / JB);
  wkv6_kernel<DH><<<grid, THREADS, 0, stream>>>(r, k, v, lw, u, state0, y,
                                                state_out, S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers to
// contiguous float32 tensors, 16-byte aligned: r, k, v, lw and y
// (B, S, H, dh); u (H, dh); state0 (B, H, dh, dh) or null for zeros;
// state_out (B, H, dh, dh). dh is 32 or 64, B, S, H >= 1. Launches on
// `stream` and returns the first CUDA error (0 when the launch was
// accepted); 1 (cudaErrorInvalidValue) for a dh it does not take.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* lw, const void* u, const void* state0,
                        void* y, void* state_out, int B, int S, int H, int dh,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* args[6] = {static_cast<const float*>(r),
                          static_cast<const float*>(k),
                          static_cast<const float*>(v),
                          static_cast<const float*>(lw),
                          static_cast<const float*>(u),
                          static_cast<const float*>(state0)};
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(state_out);
  if (dh == 64)
    return launch<64>(args[0], args[1], args[2], args[3], args[4], args[5],
                      yo, so, B, S, H, s);
  if (dh == 32)
    return launch<32>(args[0], args[1], args[2], args[3], args[4], args[5],
                      yo, so, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
