// The gradient of one fused LSTM timestep for Hopper (sm_90a), fp32.
//
// Replaces no Pallas kernel: the JAX package differentiates its LSTM by
// XLA's autodiff of a lax.scan over the plain cell
// (src/repro/models/rnn.py::run_lstm), one step at a time. This is that
// step's backward, from the preactivations z the forward saved
// (lstm_cell.cu), for the whole-sequence autograd of ops.py:
//     dh  = dh_carry + dh_up                     (the two shares of h''s)
//     c'  = sigmoid(f + 1) c + sigmoid(i) tanh(g),  t = tanh(c')
//     dc' = dc + dh sigmoid(o) (1 - t^2)
//     dz  = [dc' tanh(g) si(1-si), dc' c sf(1-sf), dc' si (1-tanh(g)^2),
//            dh t so(1-so)]                      (B, H, 4)
//     dc_prev = dc' sf,   dxh = dz W^T           (B, K = D+H)
// dW = xh^T dz is left to one product over the whole sequence (ops.py).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
// dxh = dz W^T is 2*B*K*4H flops against 16*K*H bytes of W, B/2 flops a
// byte as in the forward; at GNMT's B = 16 it is bound by reading W once:
//     (K, H) = (1536,  512)  W 12.6 MB  >= 3.8 us
//     (K, H) = (2048, 1024)  W 33.6 MB  >= 10.0 us
//     (K, H) = (3072, 1024)  W 50.3 MB  >= 15.0 us
//
// Design (two kernels a step, launched by one call):
//  * The gate math is a small kernel of its own, a thread a (b, unit),
//    writing dz and dc_prev once. An earlier build ran it as the
//    product's prologue, where every row tile recomputed its slice of dz
//    (2048 (b, unit) pairs a block, in series), and was slower at all
//    three shapes than the two launches.
//  * Product: a cluster of CS = 8 blocks owns TR = 64 rows of W (rows of
//    K) and a tile of BM = 16 batch rows; block `rank` takes the units
//    [rank * US, (rank + 1) * US) of those rows, US = ceil(H / 8), i.e. a
//    contiguous stretch of 4 US floats of each row, and loads their dz
//    into shared memory (16 x 128 float4 a chunk of 128 units).
//  * 128 threads = 16 row groups x 8 lanes; a thread owns 4 rows
//    of W and all 16 batch rows (64 sums) and walks the units lane, lane +
//    8, ...: per unit 4 float4 of W straight from device memory (each
//    element of W is read by one thread, once; the next unit's are loaded
//    before this one's 256 FMAs) and 16 float4 of dz from shared memory.
//    Loading W two units ahead (168 registers) or through a cp.async ring
//    of 3-6 units in shared memory was no faster, and slower at K = 3072.
//  * Reduction, in a fixed order, no atomics: the 8 lanes of a row group
//    by a butterfly reduce-scatter (shuffles at distance 4, 2, 1; a lane
//    ends with 8 of the 64 sums), then the cluster's 8 partials through
//    distributed shared memory, rank r adding outputs r*128 ... in rank
//    order. So dxh is the same to the bit from run to run.
//  * Every edge is masked: any B (batch tiles on grid.y), any K (a row
//    past K reads zeros), any H (a unit past a rank's stretch is 0).
//
// LSTM_BWD_ABLATE (build-time, default 0) takes parts out to time them
// (examples/bench_recurrent_kernels_torch.py): bit 1 the gate kernel,
// bit 2 the product's loop over units, bit 4 the cluster's sum (each
// block writes its own partial). Such a build computes wrong results.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#ifndef LSTM_BWD_ABLATE
#define LSTM_BWD_ABLATE 0
#endif

namespace {

constexpr int BM = 16;            // batch rows per cluster
constexpr int R = 4;              // rows of W per thread
constexpr int LANES = 8;          // threads sharing a row group
constexpr int THREADS = 128;
constexpr int TR = R * THREADS / LANES;   // 64 rows of W per cluster
constexpr int UC = 128;           // units per chunk of dz in shared memory
constexpr int CS = 8;             // blocks per cluster

static_assert(R * BM == 64 && LANES == 8,
              "the reduce-scatter takes 64 sums over 8 lanes");

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float4 ldg_stream(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

// this thread's 4 rows of W at unit `hu` (zeros past K or past the stretch)
__device__ __forceinline__ void load_w(float4 (&wv)[R], const float4* w,
                                       int row0, int hu, bool ok, int K,
                                       int H) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    wv[i] = ok && row0 + i < K ? ldg_stream(w + (size_t)(row0 + i) * H + hu)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
}

// keep the half of `a[0, 2n)` that lane bit `hi` names in a[0, n), plus
// the partner's share of the same half
template <int N>
__device__ __forceinline__ void fold(float (&a)[R * BM], bool hi, int dist) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float send = hi ? a[j] : a[j + N];
    const float keep = hi ? a[j + N] : a[j];
    a[j] = keep + __shfl_xor_sync(0xffffffffu, send, dist);
  }
}

constexpr int GATE_THREADS = 256;

// dz and dc_prev, a thread a (b, unit)
__global__ void __launch_bounds__(GATE_THREADS)
lstm_gate_bwd_kernel(const float4* __restrict__ z, const float* __restrict__ c,
                     const float* __restrict__ dh, int ldh,
                     const float* __restrict__ dh_up,
                     const float* __restrict__ dc, float4* __restrict__ dz,
                     float* __restrict__ dc_prev, int B, int H) {
  const size_t idx = (size_t)blockIdx.x * GATE_THREADS + threadIdx.x;
  if (idx >= (size_t)B * H) return;
  const int br = static_cast<int>(idx / H), hu = static_cast<int>(idx % H);
  const float4 zz = z[idx];
  const float cc = c[idx];
  const float g = dh[(size_t)br * ldh + hu]
                  + (dh_up != nullptr ? dh_up[idx] : 0.f);
  const float si = sigmoid(zz.x), sf = sigmoid(zz.y + 1.0f);
  const float tg = tanhf(zz.z), so = sigmoid(zz.w);
  const float tc = tanhf(sf * cc + si * tg);
  const float dcn = dc[idx] + g * so * (1.0f - tc * tc);
  dz[idx] = make_float4(dcn * tg * si * (1.0f - si),
                        dcn * cc * sf * (1.0f - sf),
                        dcn * si * (1.0f - tg * tg),
                        g * tc * so * (1.0f - so));
  dc_prev[idx] = dcn * sf;
}

__global__ void __launch_bounds__(THREADS)
lstm_cell_bwd_kernel(const float4* __restrict__ dz,
                     const float4* __restrict__ w, float* __restrict__ dxh,
                     int B, int K, int H, int US) {
  __shared__ float4 dzs[BM][UC];
  __shared__ float part[BM * TR];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / CS;
  const int k0 = tile * TR;
  const int b0 = blockIdx.y * BM;
  const int u_begin = min(H, rank * US);
  const int u_end = min(H, u_begin + US);

  const int tid = threadIdx.x;
  const int rg = tid / LANES, lane = tid % LANES;
  const int row0 = k0 + rg * R;

  float acc[R * BM];              // acc[i * BM + b]: row row0 + i, batch b
#pragma unroll
  for (int j = 0; j < R * BM; ++j) acc[j] = 0.f;

  for (int cu = u_begin; cu < u_end; cu += UC) {
    const int n = min(UC, u_end - cu);
    // the first unit's rows of W are in flight while dz is staged
    float4 wv[R];
    load_w(wv, w, row0, cu + lane, lane < n, K, H);
#pragma unroll 4
    for (int it = 0; it < BM * UC / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / UC, uu = i % UC;
      dzs[r][uu] = b0 + r < B && uu < n ? dz[(size_t)(b0 + r) * H + cu + uu]
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    for (int uu = lane; uu < ((LSTM_BWD_ABLATE & 2) ? 0 : n); uu += LANES) {
      float4 wn[R];
      load_w(wn, w, row0, cu + uu + LANES, uu + LANES < n, K, H);
#pragma unroll
      for (int b = 0; b < BM; ++b) {
        const float4 d = dzs[b][uu];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float s = acc[i * BM + b];
          s = fmaf(wv[i].x, d.x, s);
          s = fmaf(wv[i].y, d.y, s);
          s = fmaf(wv[i].z, d.z, s);
          s = fmaf(wv[i].w, d.w, s);
          acc[i * BM + b] = s;
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) wv[i] = wn[i];
    }
    __syncthreads();              // dzs is free for the next chunk
  }

  // the row group's 8 lanes: lane l ends with sums 8 l ... 8 l + 7, i.e.
  // row i = l / 2 and batch rows 8 (l % 2) ... + 7
  fold<32>(acc, lane & 4, 4);
  fold<16>(acc, lane & 2, 2);
  fold<8>(acc, lane & 1, 1);
  {
    const int i = lane / 2, bb = 8 * (lane % 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) part[(bb + j) * TR + rg * R + i] = acc[j];
  }
#if LSTM_BWD_ABLATE & 4
  for (int o = tid; o < BM * TR; o += THREADS) {
    const int b = o / TR, k = k0 + o % TR, br = b0 + b;
    if (br < B && k < K) dxh[(size_t)br * K + k] = part[o];
  }
  return;
#endif
  cluster.sync();                 // every block's partial is written

  for (int o = rank * THREADS + tid; o < BM * TR; o += CS * THREADS) {
    float s = 0.f;
    for (int q = 0; q < CS; ++q) s += cluster.map_shared_rank(part, q)[o];
    const int b = o / TR, k = k0 + o % TR, br = b0 + b;
    if (br < B && k < K) dxh[(size_t)br * K + k] = s;
  }
  cluster.sync();                 // no block leaves while it is read
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers to
// fp32 tensors: z (B, H, 4), c (B, H), w (K, H, 4), dh (B, H) with rows
// `ldh` floats apart, dh_up (B, H) or null, dc (B, H); outputs dz (B, H,
// 4), dxh (B, K) and dc_prev (B, H); all but dh contiguous, z, w and dz
// 16-byte aligned. Launches the gate kernel and the product on `stream`
// and returns the first CUDA error so a refused launch is reported.
extern "C" int lstm_cell_bwd(const void* z, const void* c, const void* w,
                             const void* dh, int ldh, const void* dh_up,
                             const void* dc, void* dz, void* dxh,
                             void* dc_prev, int B, int K, int H,
                             void* stream) {
  const int tiles = (K + TR - 1) / TR;
  const int us = (H + CS - 1) / CS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * CS, (B + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
#if !(LSTM_BWD_ABLATE & 1)
  const size_t items = (size_t)B * H;
  const unsigned gate_blocks =
      static_cast<unsigned>((items + GATE_THREADS - 1) / GATE_THREADS);
  lstm_gate_bwd_kernel<<<gate_blocks, GATE_THREADS, 0, cfg.stream>>>(
      static_cast<const float4*>(z), static_cast<const float*>(c),
      static_cast<const float*>(dh), ldh, static_cast<const float*>(dh_up),
      static_cast<const float*>(dc), static_cast<float4*>(dz),
      static_cast<float*>(dc_prev), B, H);
  if (cudaError_t e = cudaGetLastError(); e != cudaSuccess)
    return static_cast<int>(e);
#endif
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, lstm_cell_bwd_kernel, static_cast<const float4*>(dz),
      static_cast<const float4*>(w), static_cast<float*>(dxh), B, K, H, us);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
