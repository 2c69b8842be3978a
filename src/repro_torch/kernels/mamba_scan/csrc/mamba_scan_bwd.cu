// Mamba-1 selective scan backward for Hopper (sm_90a): x, B, C and D in
// bf16 or fp32 (B and C read in place through their strides), A, delta,
// gy and the states fp32; fp32 math; each gradient in its input's type.
//
// The gradient of csrc/mamba_scan.cu's function. The JAX package has no
// backward kernel: its VJP is jax.vjp of the oracle
// (src/repro/kernels/mamba_scan/ops.py:24-25), and the port's was the VJP
// of its plain version, a Python loop over time. Per (batch b, channel d),
// with the forward h_t = a_t (.) h_{t-1} + delta_t x_t B_t, a_t =
// exp(delta_t A_d), y_t = <h_t, C_t> + D_d x_t, and g = dL/dh starting
// from `gs` (zeros when null), backward in time:
//     g_t += gy_t C_t
//     dx_t = delta_t <g_t, B_t> + D_d gy_t
//     ddelta_t = sum_n g_t (A a_t h_{t-1} + x_t B_t)
//     dA_d += g_t delta_t a_t h_{t-1};  dD_d += gy_t x_t
//     dB_t = sum_d g_t delta_t x_t;  dC_t = sum_d gy_t h_t
//     g_{t-1} = a_t (.) g_t;  dstate0 = g_0.
// Layouts as the forward's: x, delta, gy, dx and ddelta (B, S, D) in
// place, B and C (B, S, N) views (dB and dC come out contiguous), A and dA
// (D, N), D and dD (D,), the states (B, D, N).
//
// h_{t-1} cannot be had back from h_t by dividing by a_t: A starts at -1
// ... -16 (models/mamba.py), so a_t can be e^-16 or less. A first pass runs
// the forward recurrence and saves h at the start of every 16-step chunk;
// the reverse pass takes the chunks last to first, recomputes the chunk's
// states from its saved start into shared memory, and walks them back.
// The exps are the forward kernel's (ex2.approx of delta A log2(e)), so the
// recomputed states are the forward's own.
//
// Bound on an H100 SXM at jamba's training shape (B, S, D, N) =
// (8, 144, 8192, 16), x bf16: it must read x (2 bytes), delta and gy (4
// each) and write dx (2) and ddelta (4) once, 16 bytes per (b, t, d): 151
// MB, 0.045 ms at 3.35 TB/s. The function's least arithmetic is one
// forward walk and one reverse walk, 20 N + 8 fp32 operations per (b, t,
// d) and 2 N exps: 3.1 GFLOP, 0.046 ms at 67 TFLOP/s, and 302 M exps,
// 0.059 ms with the exps shared between the special-function units and
// polynomials on the FMA pipes as the forward's bound counts them; so the
// operations bound it. The kernel walks forward twice (24 N + 5 operations
// and 3 N exps a (b, t, d), below), and each step of a walk is a chain
// that depends on the last, so what it can reach is set by how many such
// chains the SMs interleave and how long each is.
//
// Design:
//  * P threads share a channel (P = MAMBA_SCAN_BWD_P, at most N), each
//    with N / P of its states, their g and their dA in registers; a block
//    owns 64 channels of one batch row, 64 P threads. With one thread a
//    channel a block has two warps, an SM four under the shared memory
//    below, and each thread's step is a chain over all N states; P
//    threads a channel cut each chain to N / P states and put 4 P warps
//    on an SM. Measured at jamba's training shape (PERF.md, section 6):
//    P = 1, 2, 4, 8 take 1.086, 0.767, 0.437, 0.533 ms; kernel.py builds 4;
//  * a chunk's delta, x and gy (its channels) and B and C (widened to
//    fp32) are staged in shared memory, and the chunk's recomputed states
//    h_{t-1} with them ([16][N / P][64 P] floats, each thread its own
//    column: 64 KB at N = 16, two blocks an SM); the saved chunk starts
//    are (B, S / 16, D, N) floats in a workspace, each written and read by
//    the thread that owns them;
//  * a channel's sums over its states (<g, B> for dx, ddelta's) take
//    log2(P) shuffles among its P threads;
//  * dB_t and dC_t sum over all D channels: each step's 2 N / P values of
//    a thread are summed over the warp's 32 / P threads of the same states
//    by a transpose-reduce (2 N / P - 1 shuffles, then log2(16 / N) more;
//    each lane ends with one value's sum), over the block's 2 P warps in
//    shared memory, and over the D / 64 blocks by a second kernel from a
//    (B, S, D / 64, 2N) workspace, in order; dA and dD sum over batch and
//    time in registers and then over b by the second kernel, in order. No
//    float atomics, so a run repeats bit for bit;
//  * any S >= 1 and any D run: a chunk steps only the rows that exist, and
//    channels past D are masked and add zeros.
// Operations per (b, t, d): both forward walks (the first pass and the
// chunk's recompute) take per state the exp's argument (1), delta x B (1)
// and the multiply-add (2), and one exp, and delta x (1) per thread: 8 N
// and 2 N exps and 2 P. The reverse walk takes per state the argument
// (1), g_t (2), the two dB / dC terms (2), <g, B> (2), g a h_{t-1} (2),
// its product with A (2), dA's multiply-add (2) and g's decay (1), and one
// exp (h_t is the next step's h_{t-1}, read back): 14 N and N exps; per
// thread delta x (1), dD (2), the channel's two sums (2 log2 P) and the
// transpose-reduce (2 N / P - 1 + log2(16 / N)); and dx (3) and ddelta
// (2): 24 N + 5 + P (4 + 2 log2 P + log2(16 / N)) in all. The
// warps' and the blocks' partials add 4 N P per (b, t, 64 channels), dA's
// and dD's B (N + 1) per channel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// Threads a channel, capped at N: set at build time by kernel.py
// (``build_bwd`` passes its BWD_THREADS_PER_CHANNEL), and checked again at
// every launch.
#ifndef MAMBA_SCAN_BWD_P
#error "MAMBA_SCAN_BWD_P is set by kernel.py's build_bwd"
#endif

constexpr int CH = 64;             // channels per block
constexpr int T = 16;              // timesteps per chunk
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(MAMBA_SCAN_BWD_P == 1 || MAMBA_SCAN_BWD_P == 2 ||
                  MAMBA_SCAN_BWD_P == 4 || MAMBA_SCAN_BWD_P == 8,
              "MAMBA_SCAN_BWD_P is 1, 2, 4 or 8");

template <int N>
__host__ __device__ constexpr int threads_per_channel() {
  return MAMBA_SCAN_BWD_P < N ? MAMBA_SCAN_BWD_P : N;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename E>
__device__ __forceinline__ E from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float load_any(const void* p, int bf16,
                                          size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// 2^x on the special-function unit, as the forward kernel takes it
__device__ __forceinline__ float ex2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// v[0 .. V) summed over the warp's lanes of one residue mod P (lane
// q + P m, m = 0 .. 32 / P): lane l returns the sum of value (l / P) % V
// over its residue's lanes. Each halving step keeps the half of the
// values that bit w of m selects and adds its partner's copy of that
// half, V - 1 shuffles in all; lanes of one value are then summed by
// log2(32 / (P V)) more. Needs P V <= 32.
template <int V, int P>
__device__ __forceinline__ float transpose_sum(float (&v)[V], int lane) {
  const int m = lane / P;
#pragma unroll
  for (int w = V / 2; w >= 1; w /= 2) {
    const bool upper = m & w;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float send = upper ? v[i] : v[i + w];
      const float keep = upper ? v[i + w] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, P * w);
    }
  }
  float s = v[0];
#pragma unroll
  for (int w = P * V; w < 32; w *= 2) s += __shfl_xor_sync(FULL, s, w);
  return s;
}

template <int N, typename XT>
struct Smem {
  static constexpr int P = threads_per_channel<N>();
  float hs[T][N / P][CH * P];      // h_{t-1} of each step, a column a thread
  float dl[T][CH];
  float gy[T][CH];
  XT xs[T][CH];
  float bs[T][N];
  float cs[T][N];
  float red[T][2 * P][2 * N];      // each warp's dB, dC sums of a step
};

struct Args {
  const void* x;
  const float* delta;
  const float* a;
  const void* bm;
  const void* cm;
  const void* dvec;
  const float* state0;
  const float* gy;
  const float* gs;
  void* dx;
  float* ddelta;
  float* dstate0;
  float* hb;                       // (B, chunks, D, N): h at chunk starts
  float* pbc;                      // (B, S, blocks, 2N): dB, dC partials
  float* pda;                      // (B, D, N): dA partials
  float* pdd;                      // (B, D): dD partials
  long long b_sb, b_ss, c_sb, c_ss;
  int S, D, d_bf16, nblk;
};

template <int N, typename XT, typename BT>
__global__ void __launch_bounds__(CH * threads_per_channel<N>())
mamba_scan_bwd_kernel(const Args g) {
  constexpr int P = threads_per_channel<N>();
  constexpr int NP = N / P;        // states a thread
  constexpr int THREADS = CH * P;
  constexpr int WARPS = THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<N, XT>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ch = tid / P, q = tid % P, n0 = q * NP;
  const int blk = blockIdx.x, b = blockIdx.y;
  const int d0 = blk * CH, d = d0 + ch;
  const int S = g.S, D = g.D;
  const bool live = d < D;
  const int chunks = (S + T - 1) / T;

  float av[NP], a2[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    av[i] = live ? g.a[(size_t)d * N + n0 + i] : 0.f;
    a2[i] = av[i] * LOG2E;
  }
  const float dd = live ? load_any(g.dvec, g.d_bf16, d) : 0.f;
  const size_t xoff = (size_t)b * S * D;
  const XT* xb = static_cast<const XT*>(g.x) + xoff;
  const BT* bb = static_cast<const BT*>(g.bm) + b * g.b_sb;
  const BT* cb = static_cast<const BT*>(g.cm) + b * g.c_sb;
  // this thread's states at chunk k's start: hb[k * D * N]
  float* hb = g.hb + ((size_t)b * chunks * D + d) * N + n0;

  // steps [t0, t0 + n) of delta and x (and gy, C when `back`) of the
  // block's channels, B (and C) of the step; channels past D are zeros
  auto stage = [&](int t0, int n, bool back) {
    __syncthreads();               // the last chunk is done with the stage
    for (int i = tid; i < n * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = d0 + c < D;
      const size_t o = xoff + (size_t)(t0 + r) * D + d0 + c;
      sm.dl[r][c] = ok ? g.delta[o] : 0.f;
      sm.xs[r][c] =
          ok ? xb[(size_t)(t0 + r) * D + d0 + c] : from_float<XT>(0.f);
      if (back) sm.gy[r][c] = ok ? g.gy[o] : 0.f;
    }
    for (int i = tid; i < n * N; i += THREADS) {
      const int r = i / N, c = i % N;
      sm.bs[r][c] = to_float(bb[(t0 + r) * g.b_ss + c]);
      if (back) sm.cs[r][c] = to_float(cb[(t0 + r) * g.c_ss + c]);
    }
    __syncthreads();
  };

  // ---- pass 1: the forward recurrence, h saved at each chunk's start ----
  float h[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i)
    h[i] = (live && g.state0 != nullptr)
               ? g.state0[((size_t)b * D + d) * N + n0 + i]
               : 0.f;
  for (int k = 0; k < chunks; ++k) {
    const int t0 = k * T, n = min(T, S - t0);
    if (live) {
#pragma unroll
      for (int i = 0; i < NP; ++i) hb[(size_t)k * D * N + i] = h[i];
    }
    if (k == chunks - 1) break;    // the last chunk's steps are not needed
    stage(t0, n, false);
    for (int tt = 0; tt < n; ++tt) {
      const float dl = sm.dl[tt][ch];
      const float dx = dl * to_float(sm.xs[tt][ch]);
#pragma unroll
      for (int i = 0; i < NP; ++i)
        h[i] = fmaf(ex2_sfu(dl * a2[i]), h[i], dx * sm.bs[tt][n0 + i]);
    }
  }

  // ---- pass 2: the chunks last to first ----
  float gst[NP], dA[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    gst[i] = (live && g.gs != nullptr)
                 ? g.gs[((size_t)b * D + d) * N + n0 + i]
                 : 0.f;
    dA[i] = 0.f;
  }
  float dD = 0.f;
  XT* dxo = static_cast<XT*>(g.dx) + xoff;
  float* ddo = g.ddelta + xoff;
  float* pbc = g.pbc + (size_t)b * S * g.nblk * 2 * N;
  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * T, n = min(T, S - t0);
    stage(t0, n, true);
#pragma unroll
    for (int i = 0; i < NP; ++i)
      h[i] = live ? hb[(size_t)k * D * N + i] : 0.f;
    for (int tt = 0; tt < n; ++tt) {
      const float dl = sm.dl[tt][ch];
      const float dx = dl * to_float(sm.xs[tt][ch]);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        sm.hs[tt][i][tid] = h[i];
        h[i] = fmaf(ex2_sfu(dl * a2[i]), h[i], dx * sm.bs[tt][n0 + i]);
      }
    }
    // h[] is now the chunk's last state h_{t0+n-1}: each step's h_t is the
    // next step's h_{t-1}, read back rather than recomputed
    for (int tt = n - 1; tt >= 0; --tt) {
      const float dl = sm.dl[tt][ch];
      const float xv = to_float(sm.xs[tt][ch]);
      const float gyv = sm.gy[tt][ch];
      const float dx = dl * xv;
      float vals[2 * NP];
      float sgb = 0.f, sga = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float bv = sm.bs[tt][n0 + i], cv = sm.cs[tt][n0 + i];
        const float hp = sm.hs[tt][i][tid];
        const float at = ex2_sfu(dl * a2[i]);
        const float gn = fmaf(gyv, cv, gst[i]);      // g_t
        vals[i] = gn * dx;                           // dB's term
        vals[NP + i] = gyv * h[i];                   // dC's term, h_t
        h[i] = hp;
        sgb = fmaf(gn, bv, sgb);
        const float gah = gn * at * hp;              // g a h_{t-1}
        sga = fmaf(gah, av[i], sga);
        dA[i] = fmaf(gah, dl, dA[i]);
        gst[i] = at * gn;                            // g_{t-1}
      }
      // the channel's sums over its P threads' states; ddelta's
      // sum_n g x B is x <g, B>
#pragma unroll
      for (int off = 1; off < P; off <<= 1) {
        sgb += __shfl_xor_sync(FULL, sgb, off);
        sga += __shfl_xor_sync(FULL, sga, off);
      }
      if (live && q == 0) {
        const size_t o = (size_t)(t0 + tt) * D + d;
        dxo[o] = from_float<XT>(fmaf(dl, sgb, dd * gyv));
        ddo[o] = fmaf(xv, sgb, sga);
      }
      dD = fmaf(gyv, xv, dD);
      const float s = transpose_sum<2 * NP, P>(vals, lane);
      if (lane < 2 * N) {
        // lane l holds value l / P of states n0' = (l % P) NP ..
        const int vi = lane / P, st = (lane % P) * NP;
        sm.red[tt][warp][vi < NP ? st + vi : N + st + vi - NP] = s;
      }
    }
    __syncthreads();
    for (int i = tid; i < n * 2 * N; i += THREADS) {
      const int r = i / (2 * N), c = i % (2 * N);
      float s = sm.red[r][0][c];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += sm.red[r][w][c];
      pbc[((size_t)(t0 + r) * g.nblk + blk) * 2 * N + c] = s;
    }
  }

  if (live) {
    const size_t o = ((size_t)b * D + d) * N + n0;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (g.dstate0 != nullptr) g.dstate0[o + i] = gst[i];
      g.pda[o + i] = dA[i];
    }
    if (q == 0) g.pdd[(size_t)b * D + d] = dD;
  }
}

// dB and dC of each (b, t): the blocks' partials summed in order
template <int N, typename BT>
__global__ void reduce_bc_kernel(const float* __restrict__ pbc,
                                 BT* __restrict__ db, BT* __restrict__ dc,
                                 int rows, int nblk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * 2 * N) return;
  const int rw = i / (2 * N), c = i % (2 * N);
  const float* p = pbc + (size_t)rw * nblk * 2 * N + c;
  float s = 0.f;
  for (int k = 0; k < nblk; ++k) s += p[(size_t)k * 2 * N];
  if (c < N)
    db[(size_t)rw * N + c] = from_float<BT>(s);
  else
    dc[(size_t)rw * N + c - N] = from_float<BT>(s);
}

// dA and dD: the batch rows' partials summed in order
__global__ void reduce_ad_kernel(const float* __restrict__ pda,
                                 const float* __restrict__ pdd,
                                 float* __restrict__ da, void* ddv,
                                 int d_bf16, int B, int D, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int dn = D * N;
  if (i < dn) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += pda[(size_t)b * dn + i];
    da[i] = s;
  } else if (i < dn + D) {
    const int j = i - dn;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += pdd[(size_t)b * D + j];
    if (d_bf16)
      static_cast<__nv_bfloat16*>(ddv)[j] = __float2bfloat16(s);
    else
      static_cast<float*>(ddv)[j] = s;
  }
}

template <int N, typename XT, typename BT>
int launch(const Args& g, void* db, void* dc, float* da, void* ddv, int B,
           cudaStream_t stream) {
  auto kern = mamba_scan_bwd_kernel<N, XT, BT>;
  constexpr int smem = sizeof(Smem<N, XT>);
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  kern<<<dim3(g.nblk, B), CH * threads_per_channel<N>(), smem, stream>>>(g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = B * g.S;
  reduce_bc_kernel<N, BT><<<(rows * 2 * N + 255) / 256, 256, 0, stream>>>(
      g.pbc, static_cast<BT*>(db), static_cast<BT*>(dc), rows, g.nblk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int total = g.D * N + g.D;
  reduce_ad_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      g.pda, g.pdd, da, ddv, g.d_bf16, B, g.D, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename BT>
int dispatch(const Args& g, void* db, void* dc, float* da, void* ddv, int B,
             int N, cudaStream_t stream) {
  switch (N) {
    case 4:
      return launch<4, XT, BT>(g, db, dc, da, ddv, B, stream);
    case 8:
      return launch<8, XT, BT>(g, db, dc, da, ddv, B, stream);
    case 16:
      return launch<16, XT, BT>(g, db, dc, da, ddv, B, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Device pointers: x (B, S, D)
// contiguous, bfloat16 when x_bf16 else float32; delta and gy (B, S, D)
// contiguous float32; a (D, N) contiguous float32; dvec (D,) contiguous,
// bfloat16 when d_bf16 else float32; bm and cm (B, S, N) with the last
// dimension contiguous and batch / step strides b_sb, b_ss, c_sb, c_ss in
// elements, bfloat16 when bc_bf16 else float32; state0 and gs (B, D, N)
// float32 or null for zeros. Out: dx (B, S, D) in x's type, ddelta
// (B, S, D) float32, da (D, N) float32, db and dc (B, S, N) contiguous in
// B's type, dd (D,) in D's type, dstate0 (B, D, N) float32 or null when it
// is not wanted. Workspaces, float32: hb (B, ceil(S / chunk), D, N), pbc
// (B, S, ceil(D / channels), 2N), pda (B, D, N), pdd (B, D). `chunk` and
// `channels` must be the kernel's own (16, 64), so that the caller sized
// the workspaces right, and `threads` the MAMBA_SCAN_BWD_P it was built
// with, so that the caller counts its operations right. N is 4, 8 or 16;
// B, S, D >= 1. Launches three kernels on `stream` and returns the first
// CUDA error (0 when every launch was accepted); 1
// (cudaErrorInvalidValue) for an N, chunk, channel or thread count it
// does not take.
extern "C" int mamba_scan_bwd(
    const void* x, int x_bf16, const void* delta, const void* a,
    const void* bm, const void* cm, int bc_bf16, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, const void* dvec,
    int d_bf16, const void* state0, const void* gy, const void* gs, void* dx,
    void* ddelta, void* da, void* db, void* dc, void* dd, void* dstate0,
    void* hb, void* pbc, void* pda, void* pdd, int B, int S, int D, int N,
    int chunk, int channels, int threads, void* stream) {
  if (chunk != T || channels != CH || threads != MAMBA_SCAN_BWD_P)
    return static_cast<int>(cudaErrorInvalidValue);
  Args g;
  g.x = x;
  g.delta = static_cast<const float*>(delta);
  g.a = static_cast<const float*>(a);
  g.bm = bm;
  g.cm = cm;
  g.dvec = dvec;
  g.state0 = static_cast<const float*>(state0);
  g.gy = static_cast<const float*>(gy);
  g.gs = static_cast<const float*>(gs);
  g.dx = dx;
  g.ddelta = static_cast<float*>(ddelta);
  g.dstate0 = static_cast<float*>(dstate0);
  g.hb = static_cast<float*>(hb);
  g.pbc = static_cast<float*>(pbc);
  g.pda = static_cast<float*>(pda);
  g.pdd = static_cast<float*>(pdd);
  g.b_sb = b_sb;
  g.b_ss = b_ss;
  g.c_sb = c_sb;
  g.c_ss = c_ss;
  g.S = S;
  g.D = D;
  g.d_bf16 = d_bf16;
  g.nblk = (D + CH - 1) / CH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* daf = static_cast<float*>(da);
  if (x_bf16)
    return bc_bf16
               ? dispatch<__nv_bfloat16, __nv_bfloat16>(g, db, dc, daf, dd, B,
                                                        N, s)
               : dispatch<__nv_bfloat16, float>(g, db, dc, daf, dd, B, N, s);
  return bc_bf16 ? dispatch<float, __nv_bfloat16>(g, db, dc, daf, dd, B, N, s)
                 : dispatch<float, float>(g, db, dc, daf, dd, B, N, s);
}
