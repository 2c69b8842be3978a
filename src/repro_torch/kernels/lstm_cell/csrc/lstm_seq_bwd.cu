// The gradient of a whole LSTM layer's recurrence for Hopper (sm_90a), fp32:
// one persistent kernel launch walks every timestep of a layer backward.
//
// Replaces no Pallas kernel: the JAX package differentiates its LSTM by
// XLA's autodiff of a lax.scan over the plain cell
// (src/repro/models/rnn.py::run_lstm). This is the recurrent part of that
// scan's backward, from the preactivations z the forward saved
// (lstm_cell.cu); ops.py forms the rest, dX = dZ W_x^T and dW = XH^T dZ, as
// two products over all of a layer's rows. For t = S-1 ... 0:
//     dh  = carry + g_t                          (g: the layer's own share)
//     c'  = sigmoid(f + 1) c_t + sigmoid(i) tanh(g),  tc = tanh(c')
//     dc' = dc + dh sigmoid(o) (1 - tc^2)
//     dz_t = [dc' tanh(g) si(1-si), dc' c_t sf(1-sf), dc' si (1-tanh(g)^2),
//             dh tc so(1-so)]                    (B, H, 4)
//     dc  = dc' sf,   carry = dz_t W_h^T         (W_h = w[D:], (H, 4H))
// and returns every dz_t, dh0 = carry and dc0 = dc after step 0.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
// the walk does 2*S*B*H*4H fp32 operations against ~4*(12*S*B*H + 4*H*H)
// bytes; at GNMT's (B, S) = (16, 128) it is bound by the operations:
// 17.2 GFLOP, 0.256 ms at H = 1024, 0.064 ms at H = 512.
//
// Design:
//  * A persistent grid of ceil(H / U) blocks, U units a block (the wrapper
//    takes U = ceil(H / SMs): 8 at H = 1024 on 132 SMs, 128 blocks). Block j
//    owns units J = [jU, (j+1)U): at the start it loads its rows W_h[J]
//    (U x 4H fp32, 128 KB at H = 1024) into shared memory once, and it
//    keeps its units' dc and carry in shared memory for the whole walk.
//  * Each step: the block's gate math for its (b, unit) pairs, a thread a
//    pair (the inputs of a thread's first pair loaded a step ahead), writing
//    dz_t[:, J] into dzs; a grid barrier; then every block reads all of
//    dz_t (B x 4H, from L2) and forms carry_J = dz_t W_h[J]^T. Nothing else
//    is written between steps, so one barrier a step suffices: the next step
//    writes dz_{t-1}, which no block reads before the next barrier.
//  * The product, fp32 FMAs: 256 threads, two groups of 128, each group 8
//    batch rows of a 16-row pass; thread tg of a group takes the units
//    v = tg, tg + 128, ... of dz_t (a float4 of four gates each, read by
//    ld.global.cg, the next unit's rows in flight while this one's are
//    multiplied) and all of the block's rows of W_h, accumulating 8 x RK
//    sums (RK = U rounded up to a power of two, at most 8) as chains of
//    FMAs over v. The sums over a warp's 32 lanes: a butterfly
//    reduce-scatter (shuffles at distance 16, 8, 4, 2, 1); over a group's 4
//    warps: in warp order in shared memory. A block's carry depends on no
//    other block's partial sums: no atomics, and two calls agree to the bit.
//  * Where a step's time goes at H = 1024 (LSTM_BWD_PROFILE on an H100
//    80GB HBM3 at 700 W, ~1.94 GHz): gate math ~1.0 K cycles, the barrier
//    ~2.2 K, the product ~11.2 K, the warps' sum ~0.9 K. The product's 4.1 K
//    cycles of FMAs overlap its gather only in part: each of the 128 blocks
//    reads all of dz_t from L2 (32 MB a step); without the gather the walk
//    took 16 % less, without the FMAs 22 % less, without the barrier 12 %
//    less. Tried and not kept: loading two units ahead (255 registers,
//    spills), a per-thread cp.async ring three units deep (13 % slower), a
//    3xTF32 mma.sync product (16 batch rows as M, 8 rows of W_h as N; 3 %
//    faster at H = 1024, 19 % slower at H = 512). Sharing the gather in
//    clusters of two by multicast does not fit: W_h's rows take 128 KB of
//    the block's 227 KB, and a ring deep enough to keep L2's rate times its
//    latency in flight does not fit beside them.
//  * Where U > 8 (H above 8 SMs' worth of units) the block's rows do not
//    fit: it reads W_h from device memory (L2) every step instead, 8 rows a
//    pass over dz_t.
//  * Co-residency is a correctness requirement: the entry point checks the
//    occupancy (blocks an SM times SMs) against the grid and launches it as
//    a cooperative launch, which the runtime refuses when the grid cannot be
//    resident at once; the error goes back to the wrapper, which raises.
//  * The barrier: a monotone counter in device memory, zeroed by the
//    wrapper; each block's thread 0, after the block's writes (bar.sync),
//    adds 1 with red.release.gpu, then spins on ld.acquire.gpu until it
//    reads (step + 1) x blocks. dz_t, which other blocks write in the same
//    launch, is read only by ld.global.cg (L2), never by the non-coherent
//    path. A spin that outlasts ~16 M reads traps, so a fault is an error,
//    never a hang.
//  * Every edge is masked: any B (passes of 16 rows), any H (a unit past H
//    or past a block's stretch is 0), any S >= 1.
//
// LSTM_BWD_ABLATE (build-time, default 0) takes parts out to time them
// (examples/bench_recurrent_kernels_torch.py): bit 1 the gather (each
// thread reads one float4 of dz_t a row, through L1, for every unit), bit 2
// the grid barrier, bit 4 the product's FMAs (the loads are summed once).
// Such a build computes wrong results. LSTM_BWD_PROFILE (build-time, unset
// by default) has each block's thread 0 count its cycles by phase (gate
// math, barrier, product, the warps' sum), read back by
// lstm_seq_bwd_profile.

#include <cuda_runtime.h>

#ifndef LSTM_BWD_ABLATE
#define LSTM_BWD_ABLATE 0
#endif

#ifdef LSTM_BWD_PROFILE
// each block's thread 0's cycles summed over the walk's steps by phase:
// gate math, barrier, product (warp 0's), the warps' sum
__device__ unsigned long long phase_cycles[1024][4];
#define PHASE(i)                                                        \
  do {                                                                  \
    const long long now = clock64();                                    \
    if (threadIdx.x == 0) cycles[i] += now - mark;                      \
    mark = now;                                                         \
  } while (0)
#else
#define PHASE(i) \
  do {           \
  } while (0)
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 128;                 // threads of a batch-row group
constexpr int GROUP_WARPS = GROUP / 32;
constexpr int RB = 8;                      // batch rows a group
constexpr int PASS = RB * THREADS / GROUP; // 16 batch rows a pass
constexpr int MAX_RK = 8;                  // W_h rows a pass

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// one block's arrival at a step's barrier and its wait for all
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned target) {
  __syncthreads();
#if !(LSTM_BWD_ABLATE & 2)
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;"
                 :: "l"(count) : "memory");
    unsigned seen, spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(count) : "memory");
      if (++spins > (1u << 24)) __trap();
    } while (seen < target);
  }
#endif
  __syncthreads();
}

// keep the half of a[0, 2n) that lane bit D names in a[0, n), plus the
// partner's share of the same half, down to distance 1; once one value is
// left, add the partner's whole
template <int NA, int N, int D>
__device__ __forceinline__ void fold(float (&a)[NA], int lane) {
  if constexpr (D > 0) {
    if constexpr (N > 1) {
      const bool hi = lane & D;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const float send = hi ? a[j] : a[j + N / 2];
        const float keep = hi ? a[j + N / 2] : a[j];
        a[j] = keep + __shfl_xor_sync(0xffffffffu, send, D);
      }
      fold<NA, N / 2, D / 2>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], D);
      fold<NA, 1, D / 2>(a, lane);
    }
  }
}

// dz_t[r0 + r, v] for r < RB, zeros past B or past H; dz_t was written by
// other blocks in this launch, so it is read through L2 (ld.global.cg)
__device__ __forceinline__ void load_rows(float4 (&d)[RB],
                                          const float4* dz_t, int r0, int B,
                                          int H, int v, int v0) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r0 + r < B && v < H) {
#if LSTM_BWD_ABLATE & 1
      d[r] = dz_t[(size_t)(r0 + r) * H + v0];
#else
      d[r] = __ldcg(dz_t + (size_t)(r0 + r) * H + v);
#endif
    } else {
      d[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int RK, bool W_SMEM>
__global__ void __launch_bounds__(THREADS, 1)
lstm_seq_bwd_kernel(const float4* __restrict__ zs,
                    const float* __restrict__ cs,
                    const float4* __restrict__ wh,
                    const float* __restrict__ g,
                    const float* __restrict__ dc_in, float4* dzs,
                    float* __restrict__ dh0, float* __restrict__ dc0,
                    unsigned* count, int S, int B, int H, int U) {
  constexpr int N = RB * RK;               // sums a thread
  constexpr int NF = N >= 32 ? N / 32 : 1; // of them a lane keeps
  extern __shared__ float4 smem[];
  float4* w_s = smem;                      // RK rows of H float4
  float* carry_s = reinterpret_cast<float*>(smem + (W_SMEM ? RK * H : 0));
  float* dc_s = carry_s + B * U;           // (B, U) each
  float* red = dc_s + B * U;               // WARPS x N

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / GROUP_WARPS, tg = tid % GROUP;
  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);           // this block's units
  const int pairs = B * U;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  if constexpr (W_SMEM) {
    for (int i = tid; i < RK * H; i += THREADS) {
      const int kk = i / H, v = i % H;
      w_s[i] = kk < nu ? __ldg(wh + (size_t)(u0 + kk) * H + v) : zero;
    }
  }
  for (int p = tid; p < pairs; p += THREADS) {
    const int b = p / U, u = p % U;
    carry_s[p] = 0.f;
    dc_s[p] = dc_in != nullptr && u < nu ? dc_in[(size_t)b * H + u0 + u]
                                         : 0.f;
  }
  // the gate inputs of this thread's first pair, a step ahead: their loads
  // from device memory run during the step before's product
  const bool first = tid < pairs && tid % U < nu;
  const size_t first_idx = (size_t)(tid / U) * H + u0 + tid % U;
  float4 z_next = zero;
  float c_next = 0.f, g_next = 0.f;
  if (first) {
    const size_t idx = (size_t)(S - 1) * B * H + first_idx;
    z_next = __ldg(zs + idx);
    c_next = __ldg(cs + idx);
    g_next = __ldg(g + idx);
  }
  __syncthreads();
#ifdef LSTM_BWD_PROFILE
  long long cycles[4] = {0, 0, 0, 0}, mark = clock64();
#endif

  for (int s = 0; s < S; ++s) {
    const int t = S - 1 - s;
    // the gate math of this block's (b, unit) pairs
    for (int p = tid; p < pairs; p += THREADS) {
      const int b = p / U, u = p % U;
      if (u >= nu) continue;
      const size_t idx = ((size_t)t * B + b) * H + u0 + u;
      const bool ahead = p == tid;
      const float4 zz = ahead ? z_next : __ldg(zs + idx);
      const float cc = ahead ? c_next : __ldg(cs + idx);
      const float dh = carry_s[p] + (ahead ? g_next : __ldg(g + idx));
      const float si = sigmoid(zz.x), sf = sigmoid(zz.y + 1.0f);
      const float tgt = tanhf(zz.z), so = sigmoid(zz.w);
      const float tc = tanhf(sf * cc + si * tgt);
      const float dcn = dc_s[p] + dh * so * (1.0f - tc * tc);
      __stcg(dzs + idx, make_float4(dcn * tgt * si * (1.0f - si),
                                    dcn * cc * sf * (1.0f - sf),
                                    dcn * si * (1.0f - tgt * tgt),
                                    dh * tc * so * (1.0f - so)));
      dc_s[p] = dcn * sf;
    }
    PHASE(0);
    grid_sync(count, (unsigned)(s + 1) * gridDim.x);
    PHASE(1);
    if (first && t > 0) {
      const size_t idx = (size_t)(t - 1) * B * H + first_idx;
      z_next = __ldg(zs + idx);
      c_next = __ldg(cs + idx);
      g_next = __ldg(g + idx);
    }

    // carry_J = dz_t W_h[J]^T
    const float4* dz_t = dzs + (size_t)t * B * H;
    const int passes = W_SMEM ? 1 : (nu + RK - 1) / RK;
    for (int b0 = 0; b0 < B; b0 += PASS) {
      const int r0 = b0 + grp * RB;
      for (int kc = 0; kc < passes; ++kc) {
        float acc[N];
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] = 0.f;
        // dz_t's rows for unit v, the next unit's in flight meanwhile
        float4 d[RB];
        load_rows(d, dz_t, r0, B, H, tg, tg);
        for (int v = tg; v < H; v += GROUP) {
          float4 dn[RB];
          load_rows(dn, dz_t, r0, B, H, v + GROUP, tg);
          float4 wv[RK];
#pragma unroll
          for (int kk = 0; kk < RK; ++kk) {
            if constexpr (W_SMEM) {
              wv[kk] = w_s[kk * H + v];
            } else {
              const int k = kc * RK + kk;
              wv[kk] = k < nu ? __ldg(wh + (size_t)(u0 + k) * H + v) : zero;
            }
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) {
#if LSTM_BWD_ABLATE & 4
            acc[r] += d[r].x + d[r].y + d[r].z + d[r].w
                      + (r < RK ? wv[r].x : 0.f);
#else
#pragma unroll
            for (int kk = 0; kk < RK; ++kk) {
              float a = acc[r * RK + kk];
              a = fmaf(d[r].x, wv[kk].x, a);
              a = fmaf(d[r].y, wv[kk].y, a);
              a = fmaf(d[r].z, wv[kk].z, a);
              a = fmaf(d[r].w, wv[kk].w, a);
              acc[r * RK + kk] = a;
            }
#endif
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) d[r] = dn[r];
        }
        PHASE(2);
        fold<N, N, 16>(acc, lane);
        // lane l now holds sums l * NF ... (N >= 32) or sum l / (32 / N)
        if constexpr (N >= 32) {
#pragma unroll
          for (int i = 0; i < NF; ++i) red[warp * N + lane * NF + i] = acc[i];
        } else {
          if (lane % (32 / N) == 0) red[warp * N + lane / (32 / N)] = acc[0];
        }
        __syncthreads();
        // a group's 4 warps, in warp order
        for (int o = tid; o < 2 * N; o += THREADS) {
          const int gg = o / N, j = o % N;
          const int b = b0 + gg * RB + j / RK, u = kc * RK + j % RK;
          const float* part = red + gg * GROUP_WARPS * N + j;
          float sum = part[0];
#pragma unroll
          for (int q = 1; q < GROUP_WARPS; ++q) sum += part[q * N];
          if (b < B && u < nu) carry_s[b * U + u] = sum;
        }
        __syncthreads();
        PHASE(3);
      }
    }
  }

#ifdef LSTM_BWD_PROFILE
  if (tid == 0)
    for (int i = 0; i < 4; ++i) phase_cycles[blockIdx.x][i] = cycles[i];
#endif
  for (int p = tid; p < pairs; p += THREADS) {
    const int b = p / U, u = p % U;
    if (u >= nu) continue;
    dh0[(size_t)b * H + u0 + u] = carry_s[p];
    dc0[(size_t)b * H + u0 + u] = dc_s[p];
  }
}

template <int RK, bool W_SMEM>
int launch(const void* zs, const void* cs, const void* wh, const void* g,
           const void* dc_in, void* dzs, void* dh0, void* dc0, void* count,
           int S, int B, int H, int U, size_t smem, cudaStream_t stream) {
  auto* fn = lstm_seq_bwd_kernel<RK, W_SMEM>;
  if (cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      e != cudaSuccess)
    return static_cast<int>(e);
  const int blocks = (H + U - 1) / U;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fn, THREADS, smem);
      e != cudaSuccess)
    return static_cast<int>(e);
  if (per_sm * sms < blocks)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, fn, static_cast<const float4*>(zs), static_cast<const float*>(cs),
      static_cast<const float4*>(wh), static_cast<const float*>(g),
      static_cast<const float*>(dc_in), static_cast<float4*>(dzs),
      static_cast<float*>(dh0), static_cast<float*>(dc0),
      static_cast<unsigned*>(count), S, B, H, U);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers to
// fp32 tensors: zs (S, B, H, 4), cs (S+1, B, H), w (D+H, H, 4), g (S, B, H),
// dc_in (B, H) or null (c's cotangent after the last step); outputs dzs (S,
// B, H, 4), dh0 and dc0 (B, H); count one zeroed uint32; all contiguous, zs,
// w and dzs 16-byte aligned. U is the units a block owns. Launches the walk
// on `stream` and returns the first CUDA error, so a refused launch (a grid
// that cannot be resident at once among them) is reported.
extern "C" int lstm_seq_bwd(const void* zs, const void* cs, const void* w,
                            const void* g, const void* dc_in, void* dzs,
                            void* dh0, void* dc0, void* count, int S, int B,
                            int D, int H, int U, void* stream) {
  if (S < 1 || B < 1 || H < 1 || U < 1 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float4* wh = static_cast<const float4*>(w) + (size_t)D * H;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rk = U <= 1 ? 1 : U <= 2 ? 2 : U <= 4 ? 4 : U <= 8 ? 8 : 0;
  const size_t state = (2 * (size_t)B * U + (size_t)WARPS * RB * MAX_RK)
                       * sizeof(float);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t rows = (size_t)rk * H * sizeof(float4);
  if (rk > 0 && rows + state <= (size_t)optin) {
    const size_t smem = rows + state;
    switch (rk) {
      case 1: return launch<1, true>(zs, cs, wh, g, dc_in, dzs, dh0, dc0,
                                     count, S, B, H, U, smem, st);
      case 2: return launch<2, true>(zs, cs, wh, g, dc_in, dzs, dh0, dc0,
                                     count, S, B, H, U, smem, st);
      case 4: return launch<4, true>(zs, cs, wh, g, dc_in, dzs, dh0, dc0,
                                     count, S, B, H, U, smem, st);
      default: return launch<8, true>(zs, cs, wh, g, dc_in, dzs, dh0, dc0,
                                      count, S, B, H, U, smem, st);
    }
  }
  if (state > (size_t)optin) return static_cast<int>(cudaErrorInvalidValue);
  return launch<MAX_RK, false>(zs, cs, wh, g, dc_in, dzs, dh0, dc0, count, S,
                               B, H, U, state, st);
}

#ifdef LSTM_BWD_PROFILE
extern "C" int lstm_seq_bwd_profile(void* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles)));
}
#endif
