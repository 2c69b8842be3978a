// Fused LSTM cell for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/lstm_cell/kernel.py::lstm_cell_fwd (the Pallas
// TPU kernel _lstm_kernel): one timestep over the batch,
//     z  = [x; h] @ W + b                  W: (K=D+H, H, 4), b: (H, 4)
//     c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//     h' = sigmoid(o) * tanh(c')
// with the four gates of a hidden unit adjacent in W, so one block owns all
// four gates of its units and z never leaves the SM.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
// the cell does 2*B*K*4H flops against 16*K*H bytes of W, i.e. B/2 flops
// per byte; below the card's 20 flops per byte (B < 40), as at GNMT's
// training batch B=16, it is bound by reading W once:
//     (K, H) = (1536,  512)  W 12.6 MB  >= 3.8 us   encoder bi-LSTM
//     (K, H) = (2048, 1024)  W 33.6 MB  >= 10.0 us  encoder uni, decoder 1-7
//     (K, H) = (3072, 1024)  W 50.3 MB  >= 15.0 us  decoder 0
//
// Design (simple and correct first): a block computes BM batch rows x BH
// hidden units, i.e. BM x 4*BH entries of z, as a shared-memory-tiled fp32
// product over K in chunks of TK; each thread accumulates the four gates of
// one (row, unit) as a float4 and applies the gate math in the epilogue.
// BH is small so that H/BH blocks spread the W stream over the SMs at B=16.
// Every edge is masked: B, H and K need not be multiples of the tiles.
// wgmma, TMA, bf16 and a deeper load pipeline are left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 16;            // batch rows per block
constexpr int BH = 8;             // hidden units per block (4*BH columns of W)
constexpr int TK = 64;            // contraction depth per shared-memory tile
constexpr int THREADS = BM * BH;  // one thread per (row, unit)
static_assert((TK * BH) % THREADS == 0 && (BM * TK) % THREADS == 0,
              "tile loads must divide evenly among the threads");

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(THREADS)
lstm_cell_kernel(const float* __restrict__ xh, const float4* __restrict__ w,
                 const float4* __restrict__ bias, const float* __restrict__ c,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 int B, int K, int H) {
  __shared__ float4 w_s[TK][BH];        // W[k0:k0+TK, h0:h0+BH, 0:4]
  __shared__ float x_s[TK][BM + 1];     // xh[b0:b0+BM, k0:k0+TK], transposed

  const int tid = threadIdx.x;
  const int row = tid / BH;
  const int unit = tid % BH;
  const int b0 = blockIdx.y * BM;
  const int h0 = blockIdx.x * BH;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
    for (int j = 0; j < TK * BH / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int kk = i / BH, u = i % BH;
      const int k = k0 + kk, hu = h0 + u;
      w_s[kk][u] = (k < K && hu < H) ? w[(size_t)k * H + hu]
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < BM * TK / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / TK, kk = i % TK;
      const int br = b0 + r, k = k0 + kk;
      x_s[kk][r] = (br < B && k < K) ? xh[(size_t)br * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 16
    for (int kk = 0; kk < TK; ++kk) {
      const float x = x_s[kk][row];
      const float4 wv = w_s[kk][unit];
      acc.x = fmaf(x, wv.x, acc.x);
      acc.y = fmaf(x, wv.y, acc.y);
      acc.z = fmaf(x, wv.z, acc.z);
      acc.w = fmaf(x, wv.w, acc.w);
    }
    __syncthreads();
  }

  const int br = b0 + row, hu = h0 + unit;
  if (br < B && hu < H) {
    const float4 bv = bias[hu];
    const float zi = acc.x + bv.x, zf = acc.y + bv.y;
    const float zg = acc.z + bv.z, zo = acc.w + bv.w;
    const size_t idx = (size_t)br * H + hu;
    const float cn = sigmoid(zf + 1.0f) * c[idx] + sigmoid(zi) * tanhf(zg);
    c_out[idx] = cn;
    h_out[idx] = sigmoid(zo) * tanhf(cn);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers to
// contiguous fp32 tensors: xh (B, K), w (K, H, 4), b (H, 4), c (B, H),
// h_out and c_out (B, H); w and b 16-byte aligned. Launches on `stream`
// and returns cudaGetLastError() so a refused launch is reported.
extern "C" int lstm_cell_fwd(const void* xh, const void* w, const void* b,
                             const void* c, void* h_out, void* c_out, int B,
                             int K, int H, void* stream) {
  const dim3 grid((H + BH - 1) / BH, (B + BM - 1) / BM);
  lstm_cell_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xh), static_cast<const float4*>(w),
      static_cast<const float4*>(b), static_cast<const float*>(c),
      static_cast<float*>(h_out), static_cast<float*>(c_out), B, K, H);
  return static_cast<int>(cudaGetLastError());
}
