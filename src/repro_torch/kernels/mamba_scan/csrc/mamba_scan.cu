// Mamba-1 selective scan forward for Hopper (sm_90a): x in bf16 or fp32,
// everything else fp32, fp32 math, fp32 out.
//
// Replaces src/repro/kernels/mamba_scan/kernel.py::mamba_scan_fwd (the
// Pallas TPU kernel _mamba_kernel). Per (batch b, channel d) it runs the
// recurrence over an N-wide state h, carried from `state0` (zeros when null)
// and returned in `state_out`:
//     h_t = exp(delta_t * A_d) * h_{t-1} + (delta_t * x_t) * B_t
//     y_t = <h_t, C_t> + D_d * x_t
// The discretized dA and dBx are formed in registers from (delta, A, B, x),
// so the (B, S, D, N) tensor that the model's associative scan expands never
// exists. x, delta and y are read and written in the model's (B, S, D)
// layout in place, B and C as (B, S, N), A as (D, N), D as (D,), the states
// as (B, D, N).
//
// Bound on an H100 SXM at jamba's prefill shape (B, S, D, N) =
// (4, 1536, 8192, 16), x bf16: the kernel must read x (2 bytes) and delta
// (4) and write y (4) once, 10 bytes per (b, t, d): 503 MB, 0.150 ms at
// 3.35 TB/s. It does 6 fp32 operations per (b, t, d, n) (delta * A, the
// decay, the input, the sum and the C product) and 3 per (b, t, d): 4.9
// GFLOP, 0.073 ms at 67 TFLOP/s. It takes one exp per (b, t, d, n), 805 M
// of them: 0.193 ms on the special-function units alone (16 per SM per
// clock, 132 SMs at 1.98 GHz), but a part can run as polynomials on the
// FMA pipes (~8 lane instructions each) beside them, and the split that
// ends both together takes 0.133 ms with the fp32 operations. So the bytes
// bound it, with the operations close behind.
// A decode step (S = 1, the state read and written) moves 4.4 MB: 1.3 us.
//
// Design (simple and right first). The TPU kernel walks a sequential grid
// axis over 64-step chunks with the (256, N) state in VMEM scratch. Here
// blocks run in no order, so one block owns a (b, 32-channel) slice for the
// whole sequence and the state lives in registers:
//  * four threads share a channel, each holding N / 4 of its states, and
//    sum their parts of y_t with two warp shuffles; 128 threads a block,
//    B * D / 32 blocks (1024 at the serving shape, ~8 resident per SM, so
//    ~8 warps per scheduler hide the exp and shuffle latencies);
//  * 32 timesteps of delta and x (the block's channels) and of B and C (all
//    N) are staged in static shared memory with coalesced loads, y for the
//    same steps is collected there and written back in 128-byte rows;
//  * exp(delta * A) is exp2(delta * A * log2(e)) with A * log2(e) held in
//    registers: one multiply and one MUFU.EX2 per state and step;
//  * any S >= 1 and any D run: the last pass stages and steps only the rows
//    that exist, and channels past D are masked at every load and store, so
//    ragged prefills and S = 1 decode need no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int T = 32;              // timesteps staged per pass
constexpr int CH = 32;             // channels per block
constexpr int QS = 4;              // threads per channel (states split)
constexpr int THREADS = CH * QS;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int N, typename XT>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const XT* __restrict__ x, const float* __restrict__ delta,
                  const float* __restrict__ a, const float* __restrict__ bm,
                  const float* __restrict__ cm,
                  const float* __restrict__ dvec,
                  const float* __restrict__ state0, float* __restrict__ y,
                  float* __restrict__ state_out, int S, int D) {
  constexpr int NPT = N / QS;        // states per thread
  __shared__ float ds[T][CH];
  __shared__ float xs[T][CH];
  __shared__ float ys[T][CH];
  __shared__ __align__(16) float bs[T][N];
  __shared__ __align__(16) float cs[T][N];

  const int tid = threadIdx.x;
  const int q = tid % QS;            // which share of the states
  const int cl = tid / QS;           // channel within the block
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + cl;
  const bool live = d < D;

  // this thread's states: n = q * NPT + i for i < NPT
  float a2[NPT], h[NPT];
  const size_t sbase = ((size_t)b * D + d) * N + q * NPT;
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    a2[i] = live ? a[(size_t)d * N + q * NPT + i] * LOG2E : 0.f;
    h[i] = (live && state0 != nullptr) ? state0[sbase + i] : 0.f;
  }
  const float dd = live ? dvec[d] : 0.f;

  const size_t xbase = (size_t)b * S * D;     // (b, 0, 0) of x, delta, y
  const size_t nbase = (size_t)b * S * N;     // (b, 0, 0) of B, C
  for (int t0 = 0; t0 < S; t0 += T) {
    const int n = min(T, S - t0);
    __syncthreads();                 // the last pass is done with the stage
    for (int idx = tid; idx < n * CH; idx += THREADS) {
      const int tt = idx / CH, c = idx % CH;
      const bool in = d0 + c < D;
      const size_t gi = xbase + (size_t)(t0 + tt) * D + d0 + c;
      ds[tt][c] = in ? delta[gi] : 0.f;
      xs[tt][c] = in ? to_float(x[gi]) : 0.f;
    }
    for (int idx = tid; idx < n * N; idx += THREADS) {
      const int tt = idx / N, c = idx % N;
      const size_t gi = nbase + (size_t)(t0 + tt) * N + c;
      bs[tt][c] = bm[gi];
      cs[tt][c] = cm[gi];
    }
    __syncthreads();

#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const float dl = ds[tt][cl];
      const float xv = xs[tt][cl];
      const float dx = dl * xv;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const float e = exp2f(dl * a2[i]);
        h[i] = fmaf(e, h[i], dx * bs[tt][q * NPT + i]);
        acc = fmaf(h[i], cs[tt][q * NPT + i], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0) ys[tt][cl] = fmaf(dd, xv, acc);
    }
    __syncthreads();
    for (int idx = tid; idx < n * CH; idx += THREADS) {
      const int tt = idx / CH, c = idx % CH;
      if (d0 + c < D) y[xbase + (size_t)(t0 + tt) * D + d0 + c] = ys[tt][c];
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < NPT; ++i) state_out[sbase + i] = h[i];
  }
}

template <int N, typename XT>
int launch(const void* x, const float* delta, const float* a,
           const float* bm, const float* cm, const float* dvec,
           const float* state0, float* y, float* state_out, int B, int S,
           int D, cudaStream_t stream) {
  const dim3 grid((D + CH - 1) / CH, B);
  mamba_scan_kernel<N, XT><<<grid, THREADS, 0, stream>>>(
      static_cast<const XT*>(x), delta, a, bm, cm, dvec, state0, y,
      state_out, S, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int dispatch(const void* x, const float* delta, const float* a,
             const float* bm, const float* cm, const float* dvec,
             const float* state0, float* y, float* state_out, int B, int S,
             int D, int N, cudaStream_t stream) {
  switch (N) {
    case 4:
      return launch<4, XT>(x, delta, a, bm, cm, dvec, state0, y, state_out,
                           B, S, D, stream);
    case 8:
      return launch<8, XT>(x, delta, a, bm, cm, dvec, state0, y, state_out,
                           B, S, D, stream);
    case 16:
      return launch<16, XT>(x, delta, a, bm, cm, dvec, state0, y, state_out,
                            B, S, D, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers to
// contiguous tensors: x (B, S, D), bfloat16 when x_bf16 is 1, else float32;
// float32 delta (B, S, D), a (D, N), bm and cm (B, S, N), dvec (D,), state0
// (B, D, N) or null for zeros, y (B, S, D) and state_out (B, D, N). N is 4,
// 8 or 16; B, S, D >= 1. Launches on `stream` and returns the first CUDA
// error (0 when the launch was accepted); 1 (cudaErrorInvalidValue) for an
// N it does not take.
extern "C" int mamba_scan_fwd(const void* x, int x_bf16, const void* delta,
                              const void* a, const void* bm, const void* cm,
                              const void* dvec, const void* state0, void* y,
                              void* state_out, int B, int S, int D, int N,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[6] = {static_cast<const float*>(delta),
                       static_cast<const float*>(a),
                       static_cast<const float*>(bm),
                       static_cast<const float*>(cm),
                       static_cast<const float*>(dvec),
                       static_cast<const float*>(state0)};
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(state_out);
  if (x_bf16)
    return dispatch<__nv_bfloat16>(x, f[0], f[1], f[2], f[3], f[4], f[5], yo,
                                   so, B, S, D, N, s);
  return dispatch<float>(x, f[0], f[1], f[2], f[3], f[4], f[5], yo, so, B, S,
                         D, N, s);
}
