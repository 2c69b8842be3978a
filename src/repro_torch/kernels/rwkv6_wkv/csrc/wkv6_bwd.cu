// RWKV-6 WKV backward for Hopper (sm_90a): fp32 in, fp32 math, fp32 out.
//
// The gradient of csrc/wkv6.cu's function. The JAX package has no backward
// kernel: its VJP is jax.vjp of a lax.scan oracle
// (src/repro/kernels/rwkv6_wkv/ops.py:34-43), and the port's was the VJP of
// its plain version, a Python loop over time. Per (batch b, head h), with
// the forward y_t = S_{t-1}^T r_t + (sum_i r_t,i u_i k_t,i) v_t and
// S_t = diag(w_t) S_{t-1} + k_t v_t^T, w_t = exp(lw_t), and G_t = dL/dS_t
// starting from `gs` (zeros when null), backward in time:
//     G_{t-1} = diag(w_t) G_t + r_t gy_t^T
//     dr_t = S_{t-1} gy_t + u (.) k_t (v_t . gy_t)
//     dk_t = G_t v_t + r_t (.) u (v_t . gy_t)
//     dv_t = G_t^T k_t + (sum_i r_t,i u_i k_t,i) gy_t
//     dlw_t = w_t (.) rowsum(G_t (.) S_{t-1})
//     du = sum over b and t of r (.) k (v . gy);  dstate0 = G_0.
// Layouts as the forward's: r, k, v, lw, gy and their gradients (B, S, H,
// dh) in place, u and du (H, dh), the states and their gradients (B, H, dh,
// dh) with S[i][j] at i * dh + j.
//
// dlw needs S_{t-1} beside G_t, which run in opposite directions. S_{t-1}
// cannot be had back from S_t by dividing by w_t (w reaches e^-1 a step, so
// the error compounds), so the kernel takes the state-free form instead:
// with c(s, tau) = (prod_{s<sigma<tau} w_sigma) (.) k_s (.) r_tau
// (v_s . gy_tau), the pairs a step's decay sits between,
//     dlw_t = sum_{s<t<tau} c(s, tau)
//           = sum_{s<t} k_s (.) dk^S_s - sum_{tau<=t} r_tau (.) dr^S_tau,
// where dr^S and dk^S are dr and dk without their u terms and s = 0 is
// state0 as a key (its term rowsum(state0 (.) G_0)); gs enters through
// G. The two sums grow with S while dlw does not, so their difference is
// carried in fp64: against the fp64 VJP at S = 4096 the identity is within
// 6.1e-6 of max |dlw| (two fp32 running sums: 6.7e-5; the fp32 plain VJP
// 1.5e-7), inside the card tests' 5e-4
// (tests/test_torch_wkv6.py::test_dlw_identity_holds_at_4096_steps).
//
// Bound on an H100 SXM at rwkv6-3b's training shape (B, S, H, dh) =
// (8, 144, 40, 64): it must read r, k, v, lw and gy and write dr, dk, dv and
// dlw once, 36 dh bytes per (b, h, t): 106 MB, 0.032 ms at 3.35 TB/s. The
// function's least arithmetic is one update of G with its products by v
// and k and one of S with its product by gy, 12 dh^2, and 21 dh for the
// exps, the u terms and dlw by the identity below, per (b, h, t): 2.3
// GFLOP, 0.035 ms at 67 TFLOP/s, so the operations bound it. This kernel
// does 15 dh^2 + 114 dh + 20 (below): it carries G twice.
//
// Design (simple and right first: two sequential passes on the CUDA cores,
// as csrc/wkv6.cu's first version ran the forward):
//  * one block of 2 * dh * 4 threads owns one (b, h); 32 steps of r, k,
//    v, gy and exp(lw) are staged in static shared memory (41 KB) with
//    16-byte loads, and the step scalars v . gy and sum_i r_i u_i k_i are
//    reduced once a step by one warp;
//  * the reverse pass carries G twice, by rows and by columns, in two
//    halves of the block that step together: four threads own a row
//    (a column), dh / 4 entries each in registers, and sum dk^S_t (dv) over
//    their entries with two shuffles. The row half writes dk and
//    k (.) dk^S into dlw's place, sums du's part of its (b, h), and at the
//    end writes dstate0 = G_0 and state0's term;
//  * the forward pass carries S by rows, eight threads a row: dr, and dlw_t
//    from the fp64 running difference (its k (.) dk^S read back from dlw
//    before dlw_t is written there); without gs the last step's dlw is 0
//    exactly, as no pair spans it;
//  * du's partials, one (dh) row per (b, h), are summed over b in order by
//    a second kernel: no float atomics, so a run repeats bit for bit.
// Operations per (b, h, t): each pass stages exp(lw) (dh exps), v . gy
// (2 dh) and sum r u k (3 dh), 12 dh in both; every carried matrix entry
// costs a multiply-add of the dot product and a multiply and a multiply-add
// of the update, 5 dh^2 a matrix, three matrices (G by rows, G by columns,
// S); the partial sums and their shuffles, the u and dlw terms add 26 dh
// (rows), 22 dh (columns) and 54 dh (forward), and the step scalars'
// shuffles 20.

#include <cuda_runtime.h>

namespace {

constexpr int T = 32;              // timesteps staged per tile
constexpr int QS = 4;              // threads a row (a column), reverse pass
constexpr int QF = 2 * QS;         // threads a row, forward pass
constexpr unsigned FULL = 0xffffffffu;

template <int DH>
struct Smem {
  float r[T][DH];
  float k[T][DH];
  float w[T][DH];                  // exp(lw)
  float v[T][DH];
  float gy[T][DH];
  float vg[T];                     // v_t . gy_t
  float ruk[T];                    // sum_i r_t,i u_i k_t,i
  float u[DH];
  float b0[DH];                    // rowsum(state0 (.) G_0)
};

template <int Q>
__device__ __forceinline__ float quad_sum(float p) {
#pragma unroll
  for (int off = 1; off < Q; off <<= 1) p += __shfl_xor_sync(FULL, p, off);
  return p;
}

template <int DH>
__global__ void __launch_bounds__(2 * DH * QS)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const float* __restrict__ state0,
                const float* __restrict__ gy, const float* __restrict__ gs,
                float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dlw,
                float* __restrict__ du_part, float* __restrict__ dstate0,
                int S, int H) {
  constexpr int THREADS = 2 * DH * QS;
  constexpr int NR = DH / (4 * QS);      // float4 groups a thread, reverse
  constexpr int NF = DH / (4 * QF);      // forward
  constexpr int V4 = DH / 4;
  __shared__ __align__(16) Smem<DH> sm;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t row = (size_t)H * DH;                 // timestep stride
  const size_t base = (size_t)b * S * row + (size_t)h * DH;
  const size_t sbase = (size_t)bh * DH * DH;
  const int ntiles = (S + T - 1) / T;

  for (int i = tid; i < DH; i += THREADS) sm.u[i] = u[h * DH + i];

  // steps [t0, t0 + n) of r, k, exp(lw), v and gy into shared memory, then
  // each step's two scalars
  auto stage = [&](int t0, int n) {
    __syncthreads();                 // the last tile is done with the stage
    for (int idx = tid; idx < n * V4; idx += THREADS) {
      const int tt = idx / V4, c = 4 * (idx % V4);
      const size_t gi = base + (size_t)(t0 + tt) * row + c;
      *reinterpret_cast<float4*>(&sm.r[tt][c]) =
          *reinterpret_cast<const float4*>(r + gi);
      *reinterpret_cast<float4*>(&sm.k[tt][c]) =
          *reinterpret_cast<const float4*>(k + gi);
      *reinterpret_cast<float4*>(&sm.v[tt][c]) =
          *reinterpret_cast<const float4*>(v + gi);
      *reinterpret_cast<float4*>(&sm.gy[tt][c]) =
          *reinterpret_cast<const float4*>(gy + gi);
      const float4 l = *reinterpret_cast<const float4*>(lw + gi);
      *reinterpret_cast<float4*>(&sm.w[tt][c]) =
          make_float4(expf(l.x), expf(l.y), expf(l.z), expf(l.w));
    }
    __syncthreads();
    for (int tt = warp; tt < n; tt += THREADS / 32) {
      float pv = 0.f, pr = 0.f;
      for (int i = lane; i < DH; i += 32) {
        pv = fmaf(sm.v[tt][i], sm.gy[tt][i], pv);
        pr = fmaf(sm.r[tt][i] * sm.u[i], sm.k[tt][i], pr);
      }
      pv = quad_sum<32>(pv);
      pr = quad_sum<32>(pr);
      if (lane == 0) {
        sm.vg[tt] = pv;
        sm.ruk[tt] = pr;
      }
    }
    __syncthreads();
  };

  // ---- reverse pass: G by rows (first half) and by columns (second) ----
  const bool cols = tid >= DH * QS;
  const int me = (tid % (DH * QS)) / QS;   // the row i or the column j
  const int q = tid % QS;
  float G[4 * NR];
#pragma unroll
  for (int g = 0; g < NR; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * (q + QS * g) + e;
      G[4 * g + e] =
          gs == nullptr
              ? 0.f
              : gs[sbase + (cols ? (size_t)c * DH + me : (size_t)me * DH + c)];
    }
  }
  const float um = u[h * DH + me];
  float du_acc = 0.f;
  for (int kt = ntiles - 1; kt >= 0; --kt) {
    const int t0 = kt * T, n = min(T, S - t0);
    stage(t0, n);
    for (int tt = n - 1; tt >= 0; --tt) {
      const size_t go = base + (size_t)(t0 + tt) * row + me;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!cols) {
        // row i: dk^S_i = sum_j G_ij v_j; G_ij <- w_i G_ij + r_i gy_j
        const float wi = sm.w[tt][me], ri = sm.r[tt][me];
#pragma unroll
        for (int g = 0; g < NR; ++g) {
          const int c = 4 * (q + QS * g);
          const float4 vv = *reinterpret_cast<const float4*>(&sm.v[tt][c]);
          const float4 gg = *reinterpret_cast<const float4*>(&sm.gy[tt][c]);
          acc.x = fmaf(G[4 * g + 0], vv.x, acc.x);
          acc.y = fmaf(G[4 * g + 1], vv.y, acc.y);
          acc.z = fmaf(G[4 * g + 2], vv.z, acc.z);
          acc.w = fmaf(G[4 * g + 3], vv.w, acc.w);
          G[4 * g + 0] = fmaf(wi, G[4 * g + 0], ri * gg.x);
          G[4 * g + 1] = fmaf(wi, G[4 * g + 1], ri * gg.y);
          G[4 * g + 2] = fmaf(wi, G[4 * g + 2], ri * gg.z);
          G[4 * g + 3] = fmaf(wi, G[4 * g + 3], ri * gg.w);
        }
        const float p = quad_sum<QS>((acc.x + acc.y) + (acc.z + acc.w));
        if (q == 0) {
          const float ki = sm.k[tt][me], rvg = ri * sm.vg[tt];
          dk[go] = fmaf(rvg, um, p);
          dlw[go] = ki * p;          // k_t (.) dk^S_t, read back below
          du_acc = fmaf(rvg, ki, du_acc);
        }
      } else {
        // column j: dv_j = sum_i G_ij k_i + ruk gy_j; G_ij <- w_i G_ij +
        // r_i gy_j
        const float gj = sm.gy[tt][me];
#pragma unroll
        for (int g = 0; g < NR; ++g) {
          const int c = 4 * (q + QS * g);
          const float4 kk = *reinterpret_cast<const float4*>(&sm.k[tt][c]);
          const float4 ww = *reinterpret_cast<const float4*>(&sm.w[tt][c]);
          const float4 rr = *reinterpret_cast<const float4*>(&sm.r[tt][c]);
          acc.x = fmaf(G[4 * g + 0], kk.x, acc.x);
          acc.y = fmaf(G[4 * g + 1], kk.y, acc.y);
          acc.z = fmaf(G[4 * g + 2], kk.z, acc.z);
          acc.w = fmaf(G[4 * g + 3], kk.w, acc.w);
          G[4 * g + 0] = fmaf(ww.x, G[4 * g + 0], rr.x * gj);
          G[4 * g + 1] = fmaf(ww.y, G[4 * g + 1], rr.y * gj);
          G[4 * g + 2] = fmaf(ww.z, G[4 * g + 2], rr.z * gj);
          G[4 * g + 3] = fmaf(ww.w, G[4 * g + 3], rr.w * gj);
        }
        const float p = quad_sum<QS>((acc.x + acc.y) + (acc.z + acc.w));
        if (q == 0) dv[go] = fmaf(sm.ruk[tt], gj, p);
      }
    }
  }

  // G is G_0: the row half writes dstate0 and state0's dlw term
  if (!cols) {
    float part = 0.f;
#pragma unroll
    for (int g = 0; g < NR; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t o = sbase + (size_t)me * DH + 4 * (q + QS * g) + e;
        if (state0 != nullptr) part = fmaf(state0[o], G[4 * g + e], part);
        if (dstate0 != nullptr) dstate0[o] = G[4 * g + e];
      }
    }
    part = quad_sum<QS>(part);
    if (q == 0) {
      sm.b0[me] = part;
      du_part[(size_t)bh * DH + me] = du_acc;
    }
  }

  // ---- forward pass: S by rows, eight threads a row ----
  const int fi = tid / QF, fq = tid % QF;
  float St[4 * NF];
#pragma unroll
  for (int g = 0; g < NF; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * (fq + QF * g) + e;
      St[4 * g + e] =
          state0 == nullptr ? 0.f : state0[sbase + (size_t)fi * DH + c];
    }
  }
  const float uf = u[h * DH + fi];
  double diff = 0.0;     // sum_{s<t} k (.) dk^S - sum_{tau<t} r (.) dr^S
  for (int kt = 0; kt < ntiles; ++kt) {
    const int t0 = kt * T, n = min(T, S - t0);
    stage(t0, n);        // its first barrier also publishes b0 and dlw
    if (kt == 0) diff = sm.b0[fi];
    for (int tt = 0; tt < n; ++tt) {
      const float wi = sm.w[tt][fi], ki = sm.k[tt][fi];
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int g = 0; g < NF; ++g) {
        const int c = 4 * (fq + QF * g);
        const float4 gg = *reinterpret_cast<const float4*>(&sm.gy[tt][c]);
        const float4 vv = *reinterpret_cast<const float4*>(&sm.v[tt][c]);
        acc.x = fmaf(St[4 * g + 0], gg.x, acc.x);
        acc.y = fmaf(St[4 * g + 1], gg.y, acc.y);
        acc.z = fmaf(St[4 * g + 2], gg.z, acc.z);
        acc.w = fmaf(St[4 * g + 3], gg.w, acc.w);
        St[4 * g + 0] = fmaf(wi, St[4 * g + 0], ki * vv.x);
        St[4 * g + 1] = fmaf(wi, St[4 * g + 1], ki * vv.y);
        St[4 * g + 2] = fmaf(wi, St[4 * g + 2], ki * vv.z);
        St[4 * g + 3] = fmaf(wi, St[4 * g + 3], ki * vv.w);
      }
      const float p = quad_sum<QF>((acc.x + acc.y) + (acc.z + acc.w));
      if (fq == 0) {
        const size_t o = base + (size_t)(t0 + tt) * row + fi;
        dr[o] = fmaf(ki * sm.vg[tt], uf, p);
        const float kdk = dlw[o];
        diff -= (double)(sm.r[tt][fi] * p);
        // with no state cotangent no pair spans the last step: its dlw is
        // 0, which the running difference would give only to rounding
        dlw[o] = (gs == nullptr && t0 + tt == S - 1) ? 0.f : (float)diff;
        diff += (double)kdk;
      }
    }
  }
}

// du = sum over b of the partials, in order of b
__global__ void wkv6_du_kernel(const float* __restrict__ du_part,
                               float* __restrict__ du, int B, int HD) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HD) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += du_part[(size_t)b * HD + i];
  du[i] = s;
}

template <int DH>
int launch(const float* const* in, float* const* out, int B, int S, int H,
           cudaStream_t stream) {
  wkv6_bwd_kernel<DH><<<B * H, 2 * DH * QS, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0], out[1],
      out[2], out[3], out[4], out[6], S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int hd = H * DH;
  wkv6_du_kernel<<<(hd + 255) / 256, 256, 0, stream>>>(out[4], out[5], B,
                                                        hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Device pointers to contiguous
// float32 tensors, 16-byte aligned: r, k, v, lw, gy and dr, dk, dv, dlw
// (B, S, H, dh); u and du (H, dh); du_part (B, H, dh), a workspace;
// state0, gs and dstate0 (B, H, dh, dh), state0 and gs null for zeros,
// dstate0 null when it is not wanted. dh is 32 or 64, B, S, H >= 1.
// Launches the two kernels on `stream` and returns the first CUDA error (0
// when both launches were accepted); 1 (cudaErrorInvalidValue) for a dh it
// does not take.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* lw, const void* u, const void* state0,
                        const void* gy, const void* gs, void* dr, void* dk,
                        void* dv, void* dlw, void* du_part, void* du,
                        void* dstate0, int B, int S, int H, int dh,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in[8] = {static_cast<const float*>(r),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v),
                        static_cast<const float*>(lw),
                        static_cast<const float*>(u),
                        static_cast<const float*>(state0),
                        static_cast<const float*>(gy),
                        static_cast<const float*>(gs)};
  float* out[7] = {static_cast<float*>(dr),      static_cast<float*>(dk),
                   static_cast<float*>(dv),      static_cast<float*>(dlw),
                   static_cast<float*>(du_part), static_cast<float*>(du),
                   static_cast<float*>(dstate0)};
  if (dh == 64) return launch<64>(in, out, B, S, H, s);
  if (dh == 32) return launch<32>(in, out, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
