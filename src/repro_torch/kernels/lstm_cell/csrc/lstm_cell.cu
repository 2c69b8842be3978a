// Fused LSTM cell for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/lstm_cell/kernel.py::lstm_cell_fwd (the Pallas
// TPU kernel _lstm_kernel): one timestep over the batch,
//     z  = [x; h] @ W + b                  W: (K=D+H, H, 4), b: (H, 4)
//     c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)
//     h' = sigmoid(o) * tanh(c')
// with the four gates of a hidden unit adjacent in W, so one cluster owns
// all four gates of its units and z never leaves the SMs.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
// the cell does 2*B*K*4H flops against 16*K*H bytes of W, i.e. B/2 flops
// per byte; below the card's 20 flops per byte (B < 40), as at GNMT's
// training batch B=16, it is bound by reading W once:
//     (K, H) = (1536,  512)  W 12.6 MB  >= 3.8 us   encoder bi-LSTM
//     (K, H) = (2048, 1024)  W 33.6 MB  >= 10.0 us  encoder uni, decoder 1-7
//     (K, H) = (3072, 1024)  W 50.3 MB  >= 15.0 us  decoder 0
// The fp32 arithmetic (268 MFLOP at K = 2048, 4 us) fits under the bytes,
// so the design is about keeping W's stream full on every SM.
//
// Design:
//  * Split K over a thread-block cluster. A cluster of CS blocks (4 or 8,
//    chosen at launch so that every shape puts at least two blocks on each
//    SM) owns BH = 8 hidden units, i.e. 32 adjacent floats of each row of
//    W, and BM = 16 batch rows; block `rank` takes a slice of KS rows of W
//    and the same columns of xh.
//  * Each block streams its slice through a ring of NSTAGE = 3 stages in
//    dynamic shared memory, each TK = 64 rows of W (8 KB) and the matching
//    16 x 64 of xh (4 KB), filled by 16-byte cp.async (zero-filled past
//    the slice, past H and past B); two stages are in flight while the
//    third is multiplied: 37.6 KB a block, so six blocks fit an SM (a
//    fourth stage, 50 KB a block and four a SM, was slower in design runs
//    on an NVIDIA H100 80GB HBM3).
//  * In a stage, warp w takes rows [16 w, 16 w + 16); a lane owns unit
//    lane % 8 and batch rows lane / 8 + 4 i (i < 4), and accumulates those
//    four rows' four gates (16 fp32 sums) from float4 reads of W and xh.
//  * The four warps' sums are added in shared memory, then rank 0 adds the
//    CS blocks' partial z through distributed shared memory (one
//    cluster.sync before, one after so no block leaves while it is read),
//    adds the bias and applies the gate math of the plain cell.
//  * Every edge is masked: any B (batch tiles of 16 on grid.y), any H, any
//    K (xh staged by 4-byte copies when K is not a multiple of 4).
//  * For a sequence that needs its gradient, rank 0 also writes each unit's
//    four preactivations z (bias added, before the gate math) as one float4
//    (B, H, 4), which the backward (lstm_cell_bwd.cu) reads in place of a
//    second product with W; and h' goes to rows of any stride `ldh`, so a
//    sequence writes it straight into the next step's [x; h] row.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 16;            // batch rows per cluster
constexpr int BH = 8;             // hidden units per cluster: 4*BH columns
constexpr int TK = 64;            // rows of W per stage
constexpr int NSTAGE = 3;         // ring depth
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int XLD = TK + 4;       // xh row stride in shared memory (floats)
constexpr int MAX_CS = 8;

struct Stage {
  float4 w[TK][BH];               // W[k0 + kk, h0 + u, 0:4]
  float x[BM][XLD];               // xh[b0 + r, k0 + kk]
};
constexpr int SMEM_BYTES = NSTAGE * sizeof(Stage);
static_assert(WARPS * BM * BH * sizeof(float4) + THREADS * sizeof(float4)
                  <= SMEM_BYTES,
              "the reduction buffers overlay the ring");

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// stage `st` of this block's slice [k_begin, k_end) into `S`
template <bool VEC_X>
__device__ __forceinline__ void load_stage(Stage& S, const float* xh,
                                           const float* w, int st,
                                           int k_begin, int k_end, int b0,
                                           int h0, int B, int K, int H) {
  const int tid = threadIdx.x;
  const int k0 = k_begin + st * TK;
#pragma unroll
  for (int j = 0; j < TK * BH / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int kk = i / BH, u = i % BH;
    const int k = k0 + kk, hu = h0 + u;
    const bool ok = k < k_end && hu < H;
    cp_async16(&S.w[kk][u], ok ? w + ((size_t)k * H + hu) * 4 : w, ok);
  }
  if (VEC_X) {
#pragma unroll
    for (int j = 0; j < BM * TK / 4 / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / (TK / 4), kk = 4 * (i % (TK / 4));
      const int br = b0 + r, k = k0 + kk;
      const bool ok = br < B && k < k_end;
      cp_async16(&S.x[r][kk], ok ? xh + (size_t)br * K + k : xh, ok);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < BM * TK / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / TK, kk = i % TK;
      const int br = b0 + r, k = k0 + kk;
      const bool ok = br < B && k < k_end;
      cp_async4(&S.x[r][kk], ok ? xh + (size_t)br * K + k : xh, ok);
    }
  }
}

template <bool VEC_X>
__global__ void __launch_bounds__(THREADS)
lstm_cell_kernel(const float* __restrict__ xh, const float* __restrict__ w,
                 const float4* __restrict__ bias, const float* __restrict__ c,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 float4* __restrict__ z_out, int B, int K, int H, int KS,
                 int ldh) {
  extern __shared__ float4 smem4[];
  Stage* ring = reinterpret_cast<Stage*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h0 = (blockIdx.x / cs) * BH;
  const int b0 = blockIdx.y * BM;
  const int k_begin = min(K, rank * KS);
  const int k_end = min(K, k_begin + KS);
  const int n = (k_end - k_begin + TK - 1) / TK;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = lane / BH, u = lane % BH;   // rows rg + 4 i, unit u

#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < n)
      load_stage<VEC_X>(ring[st], xh, w, st, k_begin, k_end, b0, h0, B, K,
                        H);
    cp_async_commit();
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;

  for (int it = 0; it < n; ++it) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();              // stage `it` landed; `it - 1` is consumed
    const int nxt = it + NSTAGE - 1;
    if (nxt < n)
      load_stage<VEC_X>(ring[nxt % NSTAGE], xh, w, nxt, k_begin, k_end, b0,
                        h0, B, K, H);
    cp_async_commit();

    const Stage& S = ring[it % NSTAGE];
#pragma unroll
    for (int k4 = 0; k4 < TK / WARPS; k4 += 4) {
      const int kk = warp * (TK / WARPS) + k4;
      float4 wv[4], xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = S.w[kk + j][u];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const float4*>(&S.x[rg + 4 * i][kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xs[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][0] = fmaf(xs[j], wv[j].x, acc[i][0]);
          acc[i][1] = fmaf(xs[j], wv[j].y, acc[i][1]);
          acc[i][2] = fmaf(xs[j], wv[j].z, acc[i][2]);
          acc[i][3] = fmaf(xs[j], wv[j].w, acc[i][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                // the ring is free: reuse it

  // the four warps' sums -> this block's partial z (BM x BH float4)
  float4* red = smem4;                               // [WARPS][BM][BH]
  float4* part = smem4 + WARPS * BM * BH;            // [BM][BH]
#pragma unroll
  for (int i = 0; i < 4; ++i)
    red[(warp * BM + rg + 4 * i) * BH + u] =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  float4 z = red[tid];
#pragma unroll
  for (int wi = 1; wi < WARPS; ++wi) {
    const float4 v = red[wi * BM * BH + tid];
    z.x += v.x; z.y += v.y; z.z += v.z; z.w += v.w;
  }
  part[tid] = z;
  cluster.sync();                 // every block's partial is written

  if (rank == 0) {
    const int row = tid / BH, unit = tid % BH;
    const int br = b0 + row, hu = h0 + unit;
    float4 zs = part[tid];
    for (int r = 1; r < cs; ++r) {
      const float4 v = cluster.map_shared_rank(part, r)[tid];
      zs.x += v.x; zs.y += v.y; zs.z += v.z; zs.w += v.w;
    }
    if (br < B && hu < H) {
      const float4 bv = bias[hu];
      const float zi = zs.x + bv.x, zf = zs.y + bv.y;
      const float zg = zs.z + bv.z, zo = zs.w + bv.w;
      const size_t idx = (size_t)br * H + hu;
      const float cn = sigmoid(zf + 1.0f) * c[idx] + sigmoid(zi) * tanhf(zg);
      c_out[idx] = cn;
      h_out[(size_t)br * ldh + hu] = sigmoid(zo) * tanhf(cn);
      if (z_out != nullptr) z_out[idx] = make_float4(zi, zf, zg, zo);
    }
  }
  cluster.sync();                 // rank 0 has read every partial
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 132;
  }();
  return n;
}

template <bool VEC_X>
int launch(const void* xh, const void* w, const void* b, const void* c,
           void* h_out, void* c_out, void* z_out, int B, int K, int H,
           int ldh, cudaStream_t stream) {
  const int groups = (H + BH - 1) / BH;
  const int btiles = (B + BM - 1) / BM;
  // the smaller cluster when it already puts two blocks on every SM
  const int cs = groups * btiles * 4 >= 2 * sm_count() ? 4 : MAX_CS;
  const int ks = ((K + cs - 1) / cs + 3) / 4 * 4;   // a multiple of 4
  cudaError_t err = cudaFuncSetAttribute(
      lstm_cell_kernel<VEC_X>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * cs, btiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, lstm_cell_kernel<VEC_X>, static_cast<const float*>(xh),
      static_cast<const float*>(w), static_cast<const float4*>(b),
      static_cast<const float*>(c), static_cast<float*>(h_out),
      static_cast<float*>(c_out), static_cast<float4*>(z_out), B, K, H, ks,
      ldh);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers to
// fp32 tensors: xh (B, K), w (K, H, 4), b (H, 4), c (B, H), c_out (B, H)
// and z_out (B, H, 4) or null, all contiguous; h_out (B, H) with rows
// `ldh` floats apart; w, b and z_out 16-byte aligned. Launches on `stream`
// and returns the first CUDA error so a refused launch is reported.
extern "C" int lstm_cell_fwd(const void* xh, const void* w, const void* b,
                             const void* c, void* h_out, void* c_out,
                             void* z_out, int B, int K, int H, int ldh,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_x = K % 4 == 0 && reinterpret_cast<size_t>(xh) % 16 == 0;
  if (vec_x)
    return launch<true>(xh, w, b, c, h_out, c_out, z_out, B, K, H, ldh, s);
  return launch<false>(xh, w, b, c, h_out, c_out, z_out, B, K, H, ldh, s);
}
