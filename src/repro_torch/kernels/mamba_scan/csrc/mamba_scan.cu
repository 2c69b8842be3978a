// Mamba-1 selective scan forward for Hopper (sm_90a): x in bf16 or fp32,
// B, C and D in bf16 or fp32 (B and C read in place, any batch and step
// strides), A, delta and the states fp32; fp32 math, fp32 out.
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
// layout in place, B and C as (B, S, N) views with the last dimension
// contiguous, A as (D, N), D as (D,), the states as (B, D, N).
//
// Bound on an H100 SXM at jamba's prefill shape (B, S, D, N) =
// (4, 1536, 8192, 16), x bf16: the kernel must read x (2 bytes) and delta
// (4) and write y (4) once, 10 bytes per (b, t, d): 503 MB, 0.150 ms at
// 3.35 TB/s. It does 6 fp32 operations per (b, t, d, n) and 3 per
// (b, t, d): 4.9 GFLOP, 0.073 ms at 67 TFLOP/s; and one exp per
// (b, t, d, n), 805 M of them: 0.193 ms on the special-function units
// (SFUs) alone (16 per SM per clock), 0.133 ms with the fp32 operations
// when a part of the exps runs as polynomials on the FMA pipes. So the
// bytes bound it, with the operations close behind. A decode step (S = 1,
// the state read and written) moves 4.4 MB: 1.3 us.
//
// Design. The TPU kernel walks a sequential grid axis over 64-step chunks
// with the (256, N) state in VMEM scratch. Here blocks run in no order, so
// one block owns a (b, 128-channel) slice for the whole sequence, one
// thread a channel, and the state lives in registers:
//  * a thread keeps all N states of its channel and A * log2(e) in
//    registers; delta, x, delta * x and D * x are formed once per step and
//    y is summed inside the thread (four partial sums, no shuffles); B_t and
//    C_t are read from shared memory as float4 broadcasts. B * D / 128
//    blocks (256 at the serving shape), two per SM (blocks of 64 or 32
//    channels give the same 1024 warps and were no faster: 0.373 and
//    0.382 ms against 0.372 at the bf16 serving shape, 0.504 and 0.536
//    against 0.336 with fp32 inputs);
//  * exp(delta * A) is 2^(delta * A * log2(e)), one MUFU.EX2
//    (ex2.approx.ftz: underflow flushes to 0). The special-function units
//    (SFUs) are not what holds the loop back: with the exps taken out it
//    takes 0.300 ms against 0.372. Taking a part of the exps as a
//    degree-5 polynomial on the FMA pipes instead, so that the SFUs and
//    the FMA pipes would finish together, was measured and made the loop
//    slower on the bf16 serving path: one polynomial exp of 16 0.372 ms
//    against none 0.359, two 0.379, four 0.427 (H100 SXM, 700 W, CUDA
//    graphs, examples/bench_recurrent_kernels_torch.py);
//  * 32 steps of delta and x (the block's channels) and of B and C are
//    staged by 16-byte cp.async into a two-stage ring, one tile ahead of
//    the recurrence (plain loads where a row is not 16-byte aligned); B and
//    C in bf16 are widened to fp32 once per tile;
//  * y of a tile is collected in shared memory and leaves in coalesced
//    16-byte pieces, a 512-byte row of the block's channels per step; the
//    state comes in and goes out through shared memory the same way;
//  * any S >= 1 and any D run: a tile stages and steps only the rows that
//    exist, and channels past D are masked at every load and store, so
//    ragged prefills and S = 1 decode need no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// Build-time settings, for examples/bench_recurrent_kernels_torch.py's
// variants (``--variant NAME=MAMBA_SCAN_CH=64``): the package builds the
// defaults. MAMBA_SCAN_ABLATE takes parts of the work out so that their
// cost shows in the time, and a build with any of its bits set computes
// wrong results.
#ifndef MAMBA_SCAN_CH
#define MAMBA_SCAN_CH 128
#endif
#ifndef MAMBA_SCAN_ABLATE
#define MAMBA_SCAN_ABLATE 0
#endif
constexpr int NO_EXP = 1;          // exp(delta A) replaced by its argument
constexpr int NO_BC_LOADS = 2;     // B_t, C_t read from the tile's row 0
constexpr int NO_STORE = 4;        // y not stored
constexpr int ABLATE = MAMBA_SCAN_ABLATE;

constexpr int CH = MAMBA_SCAN_CH;  // channels per block, one thread each
constexpr int T = 32;              // timesteps per staged tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename E>
__device__ __forceinline__ E zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float load_any(const void* p, int bf16,
                                          size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// 2^x on the special-function unit: one MUFU.EX2
__device__ __forceinline__ float ex2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [0, n) of a slab whose row r starts at src + r * stride, COLS wide
// of which `valid` exist, into dst[T][COLS]: 16-byte cp.async when `vec`
// (every row start 16-byte aligned, `valid` a whole number of 16-byte
// pieces), else plain loads. Columns past `valid` are zeros.
template <typename E, int COLS>
__device__ __forceinline__ void stage(E* dst, const E* src, long long stride,
                                      int n, int valid, bool vec) {
  if constexpr (COLS * sizeof(E) % 16 == 0) {
    if (vec) {
      constexpr int PER = 16 / sizeof(E);
      constexpr int PIECES = COLS / PER;
      for (int i = threadIdx.x; i < n * PIECES; i += CH) {
        const int r = i / PIECES, c = (i % PIECES) * PER;
        const bool ok = c < valid;
        cp_async16(dst + r * COLS + c, ok ? src + r * stride + c : src, ok);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < n * COLS; i += CH) {
    const int r = i / COLS, c = i % COLS;
    dst[r * COLS + c] = c < valid ? src[r * stride + c] : zero<E>();
  }
}

template <int N, typename XT, typename BT>
struct Smem {
  alignas(16) float dl[2][T][CH];
  alignas(16) XT xs[2][T][CH];
  alignas(16) BT bw[2][T][N];      // B and C as stored
  alignas(16) BT cw[2][T][N];
  alignas(16) float bc[T][2 * N];  // B then C of a step, bf16 widened
  alignas(16) float ys[T][CH];     // y of the tile, stored as float4s
  static_assert(T * CH >= CH * (N + 4), "A comes in through ys");
  alignas(16) float st[CH][N + 4];  // the state on its way in and out
};

struct Args {
  const void* x;
  const float* delta;
  const float* a;
  const void* bm;
  const void* cm;
  const void* dvec;
  const float* state0;
  float* y;
  float* state_out;
  long long b_sb, b_ss, c_sb, c_ss;  // B's and C's batch and step strides
  int S, D, d_bf16, vec_xd, vec_bc;
};

template <int N, typename XT, typename BT>
__global__ void __launch_bounds__(CH, 2)
mamba_scan_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<N, XT, BT>*>(smem_raw);
  constexpr bool WIDE = std::is_same<BT, float>::value;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + tid;
  const int S = g.S, D = g.D;
  const bool live = d < D;
  const int valid = min(CH, D - d0);

  // A and the state of the block's channels are contiguous (valid x N)
  // slabs, 16-byte aligned: both come in through shared memory in 16-byte
  // coalesced pieces (A through the y tile, which is free until the first
  // step)
  auto slab_in = [&](float (*dst)[N + 4], const float* src) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i = tid; i < valid * N / 4; i += CH) {
      const int e = 4 * i;
      *reinterpret_cast<float4*>(&dst[e / N][e % N]) = s4[i];
    }
  };
  auto ast = reinterpret_cast<float (*)[N + 4]>(&sm.ys[0][0]);
  slab_in(ast, g.a + (size_t)d0 * N);
  if (g.state0 != nullptr)
    slab_in(sm.st, g.state0 + ((size_t)b * D + d0) * N);
  __syncthreads();
  float h[N], a2[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = (live && g.state0 != nullptr) ? sm.st[tid][n] : 0.f;
    a2[n] = live ? ast[tid][n] * LOG2E : 0.f;
  }
  const float dd = live ? load_any(g.dvec, g.d_bf16, d) : 0.f;

  const size_t xoff = (size_t)b * S * D + d0;
  const XT* xb = static_cast<const XT*>(g.x) + xoff;
  const float* db = g.delta + xoff;
  const BT* bb = static_cast<const BT*>(g.bm) + b * g.b_sb;
  const BT* cb = static_cast<const BT*>(g.cm) + b * g.c_sb;
  const int ntiles = (S + T - 1) / T;

  auto issue = [&](int k) {
    const int t0 = k * T, n = min(T, S - t0), s = k & 1;
    stage<float, CH>(&sm.dl[s][0][0], db + (size_t)t0 * D, D, n, valid,
                     g.vec_xd);
    stage<XT, CH>(&sm.xs[s][0][0], xb + (size_t)t0 * D, D, n, valid,
                  g.vec_xd);
    stage<BT, N>(&sm.bw[s][0][0], bb + t0 * g.b_ss, g.b_ss, n, N, g.vec_bc);
    stage<BT, N>(&sm.cw[s][0][0], cb + t0 * g.c_ss, g.c_ss, n, N, g.vec_bc);
    cp_async_commit();
  };

  // the tile's n rows of y, `valid` channels each, as 16-byte stores
  // where rows are 16-byte aligned
  float* yt = g.y + xoff;
  auto store_y = [&](float* dst, int n) {
    if (g.vec_xd) {
      for (int i = tid; i < n * (CH / 4); i += CH) {
        const int r = i / (CH / 4), c = 4 * (i % (CH / 4));
        if (c < valid)
          *reinterpret_cast<float4*>(dst + (size_t)r * D + c) =
              *reinterpret_cast<const float4*>(&sm.ys[r][c]);
      }
    } else {
      for (int i = tid; i < n * CH; i += CH) {
        const int r = i / CH, c = i % CH;
        if (c < valid) dst[(size_t)r * D + c] = sm.ys[r][c];
      }
    }
  };

  issue(0);
  for (int k = 0; k < ntiles; ++k) {
    if (k + 1 < ntiles) {
      issue(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int s = k & 1, t0 = k * T, n = min(T, S - t0);
    if constexpr (!WIDE) {
      for (int i = tid; i < n * N; i += CH) {
        const int r = i / N, c = i % N;
        sm.bc[r][c] = to_float(sm.bw[s][r][c]);
        sm.bc[r][N + c] = to_float(sm.cw[s][r][c]);
      }
      __syncthreads();
    }

#pragma unroll 2
    for (int tt = 0; tt < n; ++tt) {
      const float* bt;
      const float* ct;
      const int tb = (ABLATE & NO_BC_LOADS) ? 0 : tt;
      if constexpr (WIDE) {
        bt = &sm.bw[s][tb][0];
        ct = &sm.cw[s][tb][0];
      } else {
        bt = &sm.bc[tb][0];
        ct = &sm.bc[tb][N];
      }
      const float dl = sm.dl[s][tt][tid];
      const float xv = to_float(sm.xs[s][tt][tid]);
      const float dx = dl * xv;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 b4 = reinterpret_cast<const float4*>(bt)[q];
        const float4 c4 = reinterpret_cast<const float4*>(ct)[q];
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float arg = dl * a2[i];
          const float da = (ABLATE & NO_EXP) ? arg : ex2_sfu(arg);
          h[i] = fmaf(da, h[i], dx * bv[e]);
          acc[e] = fmaf(h[i], cv[e], acc[e]);
        }
      }
      sm.ys[tt][tid] = fmaf(dd, xv, (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
    __syncthreads();                 // the stage is free for tile k + 2
    if constexpr (!(ABLATE & NO_STORE)) store_y(yt + (size_t)t0 * D, n);
  }

#pragma unroll
  for (int n = 0; n < N; ++n) sm.st[tid][n] = h[n];
  __syncthreads();
  float4* dst =
      reinterpret_cast<float4*>(g.state_out + ((size_t)b * D + d0) * N);
  for (int i = tid; i < valid * N / 4; i += CH) {
    const int e = 4 * i;
    dst[i] = *reinterpret_cast<const float4*>(&sm.st[e / N][e % N]);
  }
}

template <int N, typename XT, typename BT>
int launch(const Args& g, int B, cudaStream_t stream) {
  auto kern = mamba_scan_kernel<N, XT, BT>;
  constexpr int smem = sizeof(Smem<N, XT, BT>);
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const dim3 grid((g.D + CH - 1) / CH, B);
  kern<<<grid, CH, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename BT>
int dispatch(const Args& g, int B, int N, cudaStream_t stream) {
  switch (N) {
    case 4:
      return launch<4, XT, BT>(g, B, stream);
    case 8:
      return launch<8, XT, BT>(g, B, stream);
    case 16:
      return launch<16, XT, BT>(g, B, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point, bound with ctypes. Device pointers: x (B, S, D)
// contiguous, bfloat16 when x_bf16 else float32; delta (B, S, D)
// contiguous float32; a (D, N) contiguous float32; dvec (D,) contiguous,
// bfloat16 when d_bf16 else float32; bm and cm (B, S, N) with the last
// dimension contiguous and batch / step strides b_sb, b_ss, c_sb, c_ss in
// elements, bfloat16 when bc_bf16 else float32; state0 (B, D, N) float32
// or null for zeros; y (B, S, D) and state_out (B, D, N) float32. N is 4,
// 8 or 16; B, S, D >= 1; a, state0 and state_out 16-byte aligned. Launches on
// `stream` and returns the first CUDA error (0 when the launch was
// accepted); 1 (cudaErrorInvalidValue) for an N it does not take.
extern "C" int mamba_scan_fwd(const void* x, int x_bf16, const void* delta,
                              const void* a, const void* bm, const void* cm,
                              int bc_bf16, long long b_sb, long long b_ss,
                              long long c_sb, long long c_ss,
                              const void* dvec, int d_bf16,
                              const void* state0, void* y, void* state_out,
                              int B, int S, int D, int N, void* stream) {
  const size_t xsize = x_bf16 ? 2 : 4, bcsize = bc_bf16 ? 2 : 4;
  Args g;
  g.x = x;
  g.delta = static_cast<const float*>(delta);
  g.a = static_cast<const float*>(a);
  g.bm = bm;
  g.cm = cm;
  g.dvec = dvec;
  g.state0 = static_cast<const float*>(state0);
  g.y = static_cast<float*>(y);
  g.state_out = static_cast<float*>(state_out);
  g.b_sb = b_sb;
  g.b_ss = b_ss;
  g.c_sb = c_sb;
  g.c_ss = c_ss;
  g.S = S;
  g.D = D;
  g.d_bf16 = d_bf16;
  g.vec_xd = D * xsize % 16 == 0 && D % 4 == 0 && aligned16(x) &&
             aligned16(delta);
  g.vec_bc = N * bcsize % 16 == 0 && aligned16(bm) && aligned16(cm) &&
             (b_sb * bcsize) % 16 == 0 && (b_ss * bcsize) % 16 == 0 &&
             (c_sb * bcsize) % 16 == 0 && (c_ss * bcsize) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return bc_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16>(g, B, N, s)
                   : dispatch<__nv_bfloat16, float>(g, B, N, s);
  return bc_bf16 ? dispatch<float, __nv_bfloat16>(g, B, N, s)
                 : dispatch<float, float>(g, B, N, s);
}
