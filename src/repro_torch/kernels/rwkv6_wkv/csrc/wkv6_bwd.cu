// RWKV-6 WKV backward for Hopper (sm_90a): fp32 in, fp32 out; the chunked
// form, every chunk at once, its products on the tensor cores in 3xTF32.
//
// The gradient of csrc/wkv6.cu's function. The JAX package has no backward
// kernel: its VJP is jax.vjp of a lax.scan oracle
// (src/repro/kernels/rwkv6_wkv/ops.py:34-43), and the port's was the VJP
// of its plain version, a Python loop over time. Per (batch b, head h),
// with the forward y_t = S_{t-1}^T r_t + (sum_i r_t,i u_i k_t,i) v_t and
// S_t = diag(w_t) S_{t-1} + k_t v_t^T, w_t = exp(lw_t), and G_t = dL/dS_t
// starting from `gs` (zeros when null), the sequential form is
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
// Precondition: lw in [-1, 0), as for the forward (models/rwkv.py's clamp),
// so that 2^(-cs) over a chunk stays below e^C, finite in fp32.
//
// Bound on an H100 SXM at rwkv6-3b's training shape (B, S, H, dh) =
// (8, 144, 40, 64): it must read r, k, v, lw and gy and write dr, dk, dv and
// dlw once, 36 dh bytes per (b, h, t): 106 MB, 0.032 ms at 3.35 TB/s. The
// function's least arithmetic is one update of G with its products by v
// and k and one of S with its product by gy, 12 dh^2, and 21 dh for the
// exps, the u terms and dlw, per (b, h, t): 2.3 GFLOP, 0.035 ms at 67
// TFLOP/s on the CUDA cores, so the operations bound it. The sequential
// form cannot come near that: each step is a dependent chain, so a kernel
// that walks it is bound by one step's latency times S (0.615 ms there and
// 5.64 ms at (1, 4096, 40, 64) on the CUDA cores, PERF.md, section 6).
//
// Design: the forward's chunked form (csrc/wkv6.cu), run backward. Chunks
// of C = 32 steps [t0, t1]; cs the inclusive cumsum of lw over the chunk
// (log2 units in the code), cs_{t0-1} = 0, total = cs_{t1}; r~_t = r_t
// e^{cs_{t-1}}, k~_s = k_s e^{-cs_s}; M the strictly lower C x C mask.
// Over a chunk S_t1 = diag(e^total) (S_in + k~^T v), S_in = S_{t0-1}, and
// G_in = G_{t0-1} = diag(e^total) G_end + r~^T gy, G_end = G_t1. Three
// kernels:
//  1. every chunk at once, a block each: k~^T v and r~^T gy (dh x dh, the
//     summed index the chunk's steps), 2^total (fp64, rounded once, as the
//     forward takes it: it compounds over the chunks) and du's part of the
//     chunk, into the workspace;
//  2. the walks over chunks, not over steps: each thread owns four entries
//     (i, j) of one (b, h) and runs S_in <- diag(2^total) (S_in + k~^T v)
//     forward and G <- diag(2^total) G + r~^T gy backward, both from the
//     workspace, overwriting every chunk's two products with its S_in and
//     its G_end, and writes dstate0 = G_0; a row's first thread also sums
//     du's parts over the chunks. The entries are independent, so B H dh^2
//     / 4 threads walk at once and the loads run ahead of the chain. The
//     sums stay on the CUDA cores: the forward measured that a state
//     summed in the tensor cores drifts (2.1e-3 over 1536 steps);
//  3. every chunk at once again, a block each, from its two boundaries,
//     with Q = M (.) gy v^T and A = M (.) r~ k~^T:
//         dr^S = e^{cs_{t-1}} (.) (Q k~ + gy S_in^T)
//         dk^S = e^{-cs} (.) (Q^T r~ + e^total (.) v G_end^T)
//         dv   = A^T gy + (k~ e^total) G_end + (sum_i r u k) gy
//     and the u terms; dlw from the identity rowsum(S_{t-1} (.) G_{t-1}) =
//     dlw_t + r_t (.) dr^S_t and rowsum(S_t (.) G_t) = dlw_t + k_t (.)
//     dk^S_t, chained over the chunk:
//         dlw_t = rowsum(S_in (.) G_in) + sum_{t0<=s<t} k_s (.) dk^S_s
//                 - sum_{t0<=tau<=t} r_tau (.) dr^S_tau,
//     G_in being the previous chunk's G_end (dstate0 for the first chunk,
//     and no term without state0). No sum runs past a chunk, so S does not
//     wear the precision down. Without gs the last step's dlw is set to 0,
//     as no pair spans it. The first chunk's block of b = 0 sums du
//     over b.
// Every sum is taken in a fixed order, without float atomics, so a call
// repeats bit for bit.
// Products run as mma.sync m16n8k8 TF32 with fp32 accumulation in 3xTF32
// (each operand hi + lo; hi hi + hi lo + lo hi; the split below), which
// keeps the gradients within 2e-6 of the fp64 VJP at S = 4096 and lw at
// the clamp's ends, where one TF32 pass misses dlw's 1e-4 by 17 times
// (tests/test_torch_wkv6.py, the chunked emulation). Operand tiles
// are read from shared memory rows padded to dh + 4 (C + 4) floats; each
// product takes its summed index in the order (plain, or 8 ks + 2t and
// 8 ks + 2t + 1, as the forward permutes it) that makes both its
// fragments' loads free of bank conflicts, but for Q k~ and (k~ e^total)
// G_end, whose B fragments meet two-way conflicts.
// Kernel 3 holds ~106 KB of shared memory at dh = 64 (the chunk's r, k,
// r~, k~, v, gy and cs, S_in, G_end, Q and A), two blocks an SM; 8 warps a
// block, each owning 16 rows and dh / 4 columns of dr, dk and dv.
// Workspace (float32, one flat tensor): S_in and G_end of every (b, h,
// chunk), 2 B H ceil(S / C) dh^2, then 2^total and du's parts, 2 B H
// ceil(S / C) dh.
// Measured on an H100 at (8, 144, 40, 64) (PERF.md, section 6): 0.192 ms,
// kernel 1 0.057, kernel 2 0.037, kernel 3 0.098; at (1, 4096, 40, 64)
// 0.582 ms. Kernel 2 moves the boundaries at the memory rate; kernels 1
// and 3 run 1600 blocks at four and two an SM (kernel 3's registers and
// shared memory), 3.0 and 6.1 waves, each a load, a few hundred mma.sync
// a warp and the split's integer work between barriers.
// Operations per (b, h, chunk) (wkv6_bwd_flops in ops.py): the tensor-core
// products count 3 passes of 2 M N K each, 6 (5 C dh^2 + 15 C^2 dh / 4)
// (kernel 1's two and kernel 3's three dh-deep products, Q and A on their
// six lower tiles and the three triangular C-deep products); 84 C dh
// elementwise (cumsums, exps, scalings, the u terms, du's and dlw's sums;
// each warp of kernels 1 and 3 forms v . gy for itself) and 6 dh^2 (the
// walks and the boundary term); and du's sum over the chunks and b.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;              // timesteps per chunk: one per lane
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CHAIN_THREADS = 128;
constexpr int CHAIN_AHEAD = 8;     // chunks a walk loads ahead
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo: hi is x with its low 13 mantissa bits cleared, so lo = x -
// hi is exact, and lo goes to the tensor core as it is, which reads a
// TF32 operand's top 19 bits (CUTLASS's "fast" 3xTF32 split): two
// operations where rounding both parts takes five, and within ~2^-20 of x
// (the chunked emulation in tests/test_torch_wkv6.py models it)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// big + small += A B in 3xTF32: hi hi into `big`, the cross terms into
// `small`, two independent chains
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(small, al, bh0, bh1);
  mma(small, ah, bl0, bl1);
  mma(big, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// element (i, j) of a matrix in shared memory: X[i][j], X[j][i] (X^T), or
// X[i][j] s[j]
struct Rows {
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return p[i * ld + j];
  }
};
struct Cols {
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return p[j * ld + i];
  }
};
struct ScaledRows {
  const float* p;
  int ld;
  const float* s;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return p[i * ld + j] * s[j];
  }
};

template <int NT>
__device__ __forceinline__ void zero(float (&big)[NT][4],
                                     float (&small)[NT][4]) {
#pragma unroll
  for (int q = 0; q < NT; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) big[q][e] = small[q][e] = 0.f;
  }
}

// big + small += A[m0 .. m0 + 16) B[., n0 .. n0 + 8 NT) over the k-steps
// [k0, k1) of KS, in 3xTF32; the step's summed index is 8 ks + t and
// 8 ks + t + 4 (PERM false) or 8 ks + 2t and 8 ks + 2t + 1 (PERM true),
// the same for A and B
template <bool PERM, int KS, int NT, class FA, class FB>
__device__ __forceinline__ void mma_tiles(float (&big)[NT][4],
                                          float (&small)[NT][4], const FA& fa,
                                          const FB& fb, int m0, int n0,
                                          int k0, int k1, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks < k0 || ks >= k1) continue;
    const int ka = PERM ? 8 * ks + 2 * t : 8 * ks + t;
    const int kb = PERM ? ka + 1 : ka + 4;
    uint32_t ah[4], al[4];
    split(fa(m0 + g, ka), ah[0], al[0]);
    split(fa(m0 + g + 8, ka), ah[1], al[1]);
    split(fa(m0 + g, kb), ah[2], al[2]);
    split(fa(m0 + g + 8, kb), ah[3], al[3]);
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const int nn = n0 + 8 * q + g;
      mma3(big[q], small[q], ah, al, fb(ka, nn), fb(kb, nn));
    }
  }
}

// inclusive sum over the warp's lanes in lane order
__device__ __forceinline__ float lane_cumsum(float x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += o;
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// steps [t0, t0 + n) of one head's (C x DH) slice of x into dst, zeros past
// n (a ragged tail neither decays nor adds: lw = 0, r = k = v = gy = 0)
template <int DH>
__device__ __forceinline__ void load_chunk(float (*dst)[DH + 4],
                                           const float* __restrict__ x,
                                           size_t base, size_t row, int t0,
                                           int n, int tid) {
  constexpr int PIECES = DH / 4;
  for (int idx = tid; idx < C * PIECES; idx += THREADS) {
    const int i = idx / PIECES, c = (idx % PIECES) * 4;
    const bool ok = i < n;
    cp_async16(&dst[i][c], x + base + (size_t)(t0 + (ok ? i : 0)) * row + c,
               ok);
  }
}

template <int DH>
__device__ __forceinline__ void load_mat(float (*dst)[DH + 4],
                                         const float* __restrict__ src,
                                         int tid) {
  constexpr int PIECES = DH / 4;
  for (int idx = tid; idx < DH * PIECES; idx += THREADS) {
    const int i = idx / PIECES, c = (idx % PIECES) * 4;
    cp_async16(&dst[i][c], src + (size_t)i * DH + c, true);
  }
}

// lane l's CPW values of row l from column c0 (float4 reads: a quarter
// warp's eight rows fall in distinct banks)
template <int CPW, int LD>
__device__ __forceinline__ void row_get(float (&out)[CPW], const float* p,
                                        int lane, int c0) {
#pragma unroll
  for (int q = 0; q < CPW / 4; ++q) {
    const float4 a = ld4(p + lane * LD + c0 + 4 * q);
    out[4 * q] = a.x, out[4 * q + 1] = a.y, out[4 * q + 2] = a.z,
    out[4 * q + 3] = a.w;
  }
}

template <int CPW, int LD>
__device__ __forceinline__ void row_put(float* p, const float (&in)[CPW],
                                        int lane, int c0) {
#pragma unroll
  for (int q = 0; q < CPW / 4; ++q)
    st4(p + lane * LD + c0 + 4 * q,
        make_float4(in[4 * q], in[4 * q + 1], in[4 * q + 2], in[4 * q + 3]));
}

// rows m0 + g and m0 + g + 8 of a fragment pair (two columns from col) to a
// (B, S, H, dh) tensor, steps of the chunk that exist
__device__ __forceinline__ void store_pair(float* __restrict__ out,
                                           size_t base, size_t row, int t0,
                                           int n, int r0, int col,
                                           const float (&v)[4]) {
  if (r0 < n)
    *reinterpret_cast<float2*>(&out[base + (size_t)(t0 + r0) * row + col]) =
        make_float2(v[0], v[1]);
  if (r0 + 8 < n)
    *reinterpret_cast<float2*>(
        &out[base + (size_t)(t0 + r0 + 8) * row + col]) =
        make_float2(v[2], v[3]);
}

// ---- kernel 1: every chunk's k~^T v, r~^T gy and 2^total ----

template <int DH>
struct SumsSmem {
  float r[C][DH + 4];              // r, then r~
  float k[C][DH + 4];              // k, then k~
  float w[C][DH + 4];              // lw
  float v[C][DH + 4];
  float gy[C][DH + 4];
};

template <int DH>
__global__ void __launch_bounds__(THREADS)
wkv6_bwd_sums_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ lw,
                     const float* __restrict__ gy, float* __restrict__ ws_s,
                     float* __restrict__ ws_g, float* __restrict__ ws_d,
                     float* __restrict__ du_part, int S, int H) {
  __shared__ __align__(16) SumsSmem<DH> sm;
  constexpr int LD = DH + 4;
  constexpr int CPW = DH / WARPS;        // columns a warp scans
  constexpr int MS = DH / 16;            // row tiles of a (dh x dh) product
  constexpr int NS = DH / 8 * MS / WARPS;  // its column tiles per warp
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int c = blockIdx.x, nch = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t row = (size_t)H * DH;
  const size_t base = (size_t)b * S * row + (size_t)h * DH;
  const int t0 = c * C, n = min(C, S - t0);

  load_chunk<DH>(sm.r, r, base, row, t0, n, tid);
  load_chunk<DH>(sm.k, k, base, row, t0, n, tid);
  load_chunk<DH>(sm.w, lw, base, row, t0, n, tid);
  load_chunk<DH>(sm.v, v, base, row, t0, n, tid);
  load_chunk<DH>(sm.gy, gy, base, row, t0, n, tid);
  cp_async_wait_all();
  __syncthreads();

  // warp w scans columns w CPW ..; lane l is step l: du's part of each
  // column (from the step's v . gy, each warp forming it for itself), cs
  // in log2 units by shuffles, r~ and k~ in place, and 2^total rounded
  // from fp64
  {
    const int c0 = warp * CPW;
    float vg = 0.f;
#pragma unroll
    for (int q = 0; q < DH / 4; ++q) {
      const float4 a = ld4(&sm.v[lane][4 * q]), e = ld4(&sm.gy[lane][4 * q]);
      vg = fmaf(a.x, e.x, fmaf(a.y, e.y, fmaf(a.z, e.z, fmaf(a.w, e.w, vg))));
    }
    float rv[CPW], kv[CPW], wv[CPW];
    row_get<CPW, LD>(rv, &sm.r[0][0], lane, c0);
    row_get<CPW, LD>(kv, &sm.k[0][0], lane, c0);
    row_get<CPW, LD>(wv, &sm.w[0][0], lane, c0);
#pragma unroll
    for (int cc = 0; cc < CPW; ++cc) {
      const float du = warp_sum(rv[cc] * kv[cc] * vg);
      if (lane == 0) du_part[((size_t)bh * nch + c) * DH + c0 + cc] = du;
      const float cs = lane_cumsum(wv[cc] * LOG2E, lane);
      float prev = __shfl_up_sync(FULL, cs, 1);
      if (lane == 0) prev = 0.f;
      rv[cc] *= ex2(prev);
      kv[cc] *= ex2(-cs);
      if (lane == 31)
        ws_d[((size_t)bh * nch + c) * DH + c0 + cc] =
            static_cast<float>(exp2(static_cast<double>(cs)));
    }
    row_put<CPW, LD>(&sm.r[0][0], rv, lane, c0);
    row_put<CPW, LD>(&sm.k[0][0], kv, lane, c0);
  }
  __syncthreads();

  // k~^T v and r~^T gy: rows m0 .., columns n0 .. of each (dh x dh) sum
  const int m0 = 16 * (warp % MS), n0 = 8 * NS * (warp / MS);
  const size_t mo = ((size_t)bh * nch + c) * DH * DH;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    float big[NS][4], small[NS][4];
    zero(big, small);
    if (which == 0)
      mma_tiles<true, C / 8, NS>(big, small, Cols{&sm.k[0][0], LD},
                                 Rows{&sm.v[0][0], LD}, m0, n0, 0, C / 8, g,
                                 t);
    else
      mma_tiles<true, C / 8, NS>(big, small, Cols{&sm.r[0][0], LD},
                                 Rows{&sm.gy[0][0], LD}, m0, n0, 0, C / 8, g,
                                 t);
    float* out = (which == 0 ? ws_s : ws_g) + mo;
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int i = m0 + g, j = n0 + 8 * q + 2 * t;
      *reinterpret_cast<float2*>(&out[(size_t)i * DH + j]) =
          make_float2(big[q][0] + small[q][0], big[q][1] + small[q][1]);
      *reinterpret_cast<float2*>(&out[(size_t)(i + 8) * DH + j]) =
          make_float2(big[q][2] + small[q][2], big[q][3] + small[q][3]);
    }
  }
}

// ---- kernel 2: the walks over chunks ----

template <int DH>
__global__ void __launch_bounds__(CHAIN_THREADS)
wkv6_bwd_walk_kernel(const float* __restrict__ state0,
                     const float* __restrict__ gs, float* __restrict__ ws_s,
                     float* __restrict__ ws_g, const float* __restrict__ ws_d,
                     float* __restrict__ du_part, float* __restrict__ dstate0,
                     int nch) {
  constexpr size_t MAT = (size_t)DH * DH;
  const int bh = blockIdx.y;
  const int e = 4 * (blockIdx.x * CHAIN_THREADS + threadIdx.x);
  const int i = e / DH;
  const size_t so = (size_t)bh * MAT + e;
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s = state0 != nullptr ? ld4(state0 + so) : z4;
  float4 gg = gs != nullptr ? ld4(gs + so) : z4;
  float* ps = ws_s + (size_t)bh * nch * MAT + e;
  float* pg = ws_g + (size_t)bh * nch * MAT + e;
  const float* pd = ws_d + (size_t)bh * nch * DH + i;
  // the first thread of row i also sums du's parts of (b, h, i) over the
  // chunks, in order, into the first chunk's place
  const bool du_row = e % DH == 0;
  float* pu = du_part + (size_t)bh * nch * DH + i;
  float du = 0.f;
  for (int c0 = 0; c0 < nch; c0 += CHAIN_AHEAD) {
    float4 a[CHAIN_AHEAD], rg[CHAIN_AHEAD];
    float ds[CHAIN_AHEAD], dg[CHAIN_AHEAD], up[CHAIN_AHEAD];
#pragma unroll
    for (int q = 0; q < CHAIN_AHEAD; ++q) {
      const int c = c0 + q, cg = nch - 1 - c;
      if (c < nch) {
        a[q] = ld4(ps + c * MAT);
        ds[q] = pd[(size_t)c * DH];
        rg[q] = ld4(pg + cg * MAT);
        dg[q] = pd[(size_t)cg * DH];
        if (du_row) up[q] = pu[(size_t)c * DH];
      }
    }
#pragma unroll
    for (int q = 0; q < CHAIN_AHEAD; ++q) {
      const int c = c0 + q, cg = nch - 1 - c;
      if (c < nch) {
        st4(ps + c * MAT, s);          // S_in of chunk c
        s = make_float4(ds[q] * (s.x + a[q].x), ds[q] * (s.y + a[q].y),
                        ds[q] * (s.z + a[q].z), ds[q] * (s.w + a[q].w));
        st4(pg + cg * MAT, gg);        // G_end of chunk cg
        gg = make_float4(fmaf(dg[q], gg.x, rg[q].x),
                         fmaf(dg[q], gg.y, rg[q].y),
                         fmaf(dg[q], gg.z, rg[q].z),
                         fmaf(dg[q], gg.w, rg[q].w));
        if (du_row) du += up[q];
      }
    }
  }
  if (du_row) pu[0] = du;
  if (dstate0 != nullptr) st4(dstate0 + so, gg);
}

// ---- kernel 3: every chunk's gradients from its boundaries ----

template <int DH>
struct GradSmem {
  float r[C][DH + 4];              // r; after the products, x - y (below)
  float k[C][DH + 4];              // k; after the products, y
  float rt[C][DH + 4];             // r~
  float kt[C][DH + 4];             // k~
  float v[C][DH + 4];
  float gy[C][DH + 4];
  float cs[C][DH + 4];             // lw, then cs in log2 units, then dlw
  float s_in[DH][DH + 4];
  float g_end[DH][DH + 4];
  float qm[C][C + 4];              // gy v^T, strictly lower
  float am[C][C + 4];              // r~ k~^T, strictly lower
  float etot[DH];                  // the chunk's total, then 2^total
  float p[DH];                     // rowsum(S_in (.) G_in)
  float u[DH];
  float vg[C];                     // v_t . gy_t
  float bonus[C];                  // sum_i r_t,i u_i k_t,i
  float part[WARPS][C];            // the bonus's parts
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
wkv6_bwd_grad_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ lw,
                     const float* __restrict__ u,
                     const float* __restrict__ state0,
                     const float* __restrict__ gy,
                     const float* __restrict__ gs,
                     const float* __restrict__ ws_s,
                     const float* __restrict__ ws_g,
                     const float* __restrict__ dstate0,
                     const float* __restrict__ du_part, float* __restrict__ du,
                     float* __restrict__ dr, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dlw, int S,
                     int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<GradSmem<DH>*>(smem_raw);
  constexpr int LD = DH + 4, LC = C + 4;
  constexpr int CPW = DH / WARPS;
  constexpr int NT = DH / 32;            // column tiles of dr, dk, dv a warp
  constexpr int KC = C / 8, KD = DH / 8;  // k-steps over a chunk, over dh
  constexpr size_t MAT = (size_t)DH * DH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int c = blockIdx.x, nch = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t row = (size_t)H * DH;
  const size_t base = (size_t)b * S * row + (size_t)h * DH;
  const size_t mo = ((size_t)bh * nch + c) * MAT;
  const int t0 = c * C, n = min(C, S - t0);

  load_chunk<DH>(sm.r, r, base, row, t0, n, tid);
  load_chunk<DH>(sm.k, k, base, row, t0, n, tid);
  load_chunk<DH>(sm.v, v, base, row, t0, n, tid);
  load_chunk<DH>(sm.gy, gy, base, row, t0, n, tid);
  load_chunk<DH>(sm.cs, lw, base, row, t0, n, tid);
  load_mat<DH>(sm.s_in, ws_s + mo, tid);
  load_mat<DH>(sm.g_end, ws_g + mo, tid);
  for (int i = tid; i < DH; i += THREADS) sm.u[i] = u[h * DH + i];
  cp_async_wait_all();
  __syncthreads();

  // du = its (b, h) sums over b, in order, by the first chunk's block of
  // b = 0 (kernel 2 summed each (b, h) over the chunks)
  if (c == 0 && b == 0) {
    for (int i = tid; i < DH; i += THREADS) {
      float s = 0.f;
      for (int bb = 0; bb < (int)gridDim.y / H; ++bb)
        s += du_part[((size_t)bb * H + h) * nch * DH + i];
      du[h * DH + i] = s;
    }
  }

  // warp w's columns, lane l is step l: v . gy of the step (each warp for
  // itself), cs, r~, k~, the bonus's part
  {
    const int c0 = warp * CPW;
    float vg = 0.f;
#pragma unroll
    for (int q = 0; q < DH / 4; ++q) {
      const float4 a = ld4(&sm.v[lane][4 * q]), e = ld4(&sm.gy[lane][4 * q]);
      vg = fmaf(a.x, e.x, fmaf(a.y, e.y, fmaf(a.z, e.z, fmaf(a.w, e.w, vg))));
    }
    if (warp == 0) sm.vg[lane] = vg;
    float rv[CPW], kv[CPW], wv[CPW];
    row_get<CPW, LD>(rv, &sm.r[0][0], lane, c0);
    row_get<CPW, LD>(kv, &sm.k[0][0], lane, c0);
    row_get<CPW, LD>(wv, &sm.cs[0][0], lane, c0);
    float part = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPW; ++cc) {
      const int i = c0 + cc;
      const float cs = lane_cumsum(wv[cc] * LOG2E, lane);
      float prev = __shfl_up_sync(FULL, cs, 1);
      if (lane == 0) prev = 0.f;
      part = fmaf(rv[cc] * sm.u[i], kv[cc], part);
      if (lane == 31) sm.etot[i] = cs;
      rv[cc] *= ex2(prev);
      kv[cc] *= ex2(-cs);
      wv[cc] = cs;
    }
    row_put<CPW, LD>(&sm.rt[0][0], rv, lane, c0);
    row_put<CPW, LD>(&sm.kt[0][0], kv, lane, c0);
    row_put<CPW, LD>(&sm.cs[0][0], wv, lane, c0);
    sm.part[warp][lane] = part;
  }
  __syncthreads();

  // the bonus, 2^total, the boundary term and Q, A on their six tiles at
  // or below the diagonal
  if (tid < C) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += sm.part[w][tid];
    sm.bonus[tid] = s;
  } else if (tid < C + DH) {
    const int i = tid - C;
    sm.etot[i] = static_cast<float>(exp2(static_cast<double>(sm.etot[i])));
  }
  {
    // rowsum(S_in (.) G_in): G_in is the previous chunk's G_end, or G_0 =
    // dstate0 (no term without a state in)
    constexpr int TPR = THREADS / DH, PER = DH / TPR;
    const float* gp = c > 0 ? ws_g + mo - MAT
                            : (state0 != nullptr ? dstate0 + (size_t)bh * MAT
                                                 : nullptr);
    const int i = tid / TPR, j0 = (tid % TPR) * PER;
    float acc = 0.f;
    if (gp != nullptr) {
#pragma unroll
      for (int jj = 0; jj < PER; jj += 4) {
        const float4 a = ld4(gp + (size_t)i * DH + j0 + jj);
        const float4 s = ld4(&sm.s_in[i][j0 + jj]);
        acc = fmaf(a.x, s.x, fmaf(a.y, s.y, fmaf(a.z, s.z, fmaf(a.w, s.w,
                                                                acc))));
      }
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
    if (tid % TPR == 0) sm.p[i] = acc;
  }
  for (int job = warp; job < 12; job += WARPS) {
    const int tile = job % 6;
    const int ai = tile < 2 ? 0 : 1, aj = tile < 2 ? tile : tile - 2;
    float big[1][4], small[1][4];
    zero(big, small);
    if (job < 6)
      mma_tiles<false, KD, 1>(big, small, Rows{&sm.gy[0][0], LD},
                              Cols{&sm.v[0][0], LD}, 16 * ai, 8 * aj, 0, KD,
                              g, t);
    else
      mma_tiles<false, KD, 1>(big, small, Rows{&sm.rt[0][0], LD},
                              Cols{&sm.kt[0][0], LD}, 16 * ai, 8 * aj, 0, KD,
                              g, t);
    float(*dst)[LC] = job < 6 ? sm.qm : sm.am;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * ai + g + (e >= 2 ? 8 : 0);
      const int j = 8 * aj + 2 * t + (e & 1);
      dst[i][j] = j < i ? big[0][e] + small[0][e] : 0.f;
    }
  }
  __syncthreads();

  // dr, dk and dv on rows m0 .. m0 + 16 (steps), columns n0 .. n0 + 8 NT
  const int mi = warp % 2, m0 = 16 * mi, n0 = (warp / 2) * 8 * NT;
  float y[NT][4];                        // r (.) dr^S at this warp's places
  {
    // dr^S = 2^(cs_{t-1}) (Q k~ + gy S_in^T); the first over the steps
    // before the tile's last
    float big[NT][4], small[NT][4];
    zero(big, small);
    mma_tiles<false, KC, NT>(big, small, Rows{&sm.qm[0][0], LC},
                             Rows{&sm.kt[0][0], LD}, m0, n0, 0, 2 * mi + 2,
                             g, t);
    mma_tiles<false, KD, NT>(big, small, Rows{&sm.gy[0][0], LD},
                             Cols{&sm.s_in[0][0], LD}, m0, n0, 0, KD, g, t);
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = m0 + g + (e >= 2 ? 8 : 0);
        const int i = n0 + 8 * q + 2 * t + (e & 1);
        const float prev = tt > 0 ? sm.cs[tt - 1][i] : 0.f;
        const float drs = (big[q][e] + small[q][e]) * ex2(prev);
        y[q][e] = sm.r[tt][i] * drs;
        out[e] = fmaf(sm.u[i] * sm.k[tt][i], sm.vg[tt], drs);
      }
      store_pair(dr, base, row, t0, n, m0 + g, n0 + 8 * q + 2 * t, out);
    }
  }
  {
    // dk^S = 2^(-cs) (Q^T r~ + 2^total v G_end^T); the first over the
    // steps after the tile's first
    float bi[NT][4], si[NT][4], bb[NT][4], sb[NT][4];
    zero(bi, si);
    zero(bb, sb);
    mma_tiles<true, KC, NT>(bi, si, Cols{&sm.qm[0][0], LC},
                            Rows{&sm.rt[0][0], LD}, m0, n0, 2 * mi, KC, g, t);
    mma_tiles<false, KD, NT>(bb, sb, Rows{&sm.v[0][0], LD},
                             Cols{&sm.g_end[0][0], LD}, m0, n0, 0, KD, g, t);
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = m0 + g + (e >= 2 ? 8 : 0);
        const int i = n0 + 8 * q + 2 * t + (e & 1);
        const float em = ex2(-sm.cs[tt][i]);
        const float dks = em * (bi[q][e] + si[q][e]) +
                          (sm.etot[i] * em) * (bb[q][e] + sb[q][e]);
        const float rr = sm.r[tt][i], kk = sm.k[tt][i];
        out[e] = fmaf(rr * sm.u[i], sm.vg[tt], dks);
        // this warp alone reads and writes r and k at its places here
        sm.r[tt][i] = kk * dks - y[q][e];
        sm.k[tt][i] = y[q][e];
      }
      store_pair(dk, base, row, t0, n, m0 + g, n0 + 8 * q + 2 * t, out);
    }
  }
  {
    // dv = A^T gy + (k~ 2^total) G_end + bonus gy
    float big[NT][4], small[NT][4];
    zero(big, small);
    mma_tiles<true, KC, NT>(big, small, Cols{&sm.am[0][0], LC},
                            Rows{&sm.gy[0][0], LD}, m0, n0, 2 * mi, KC, g, t);
    mma_tiles<false, KD, NT>(big, small,
                             ScaledRows{&sm.kt[0][0], LD, sm.etot},
                             Rows{&sm.g_end[0][0], LD}, m0, n0, 0, KD, g, t);
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = m0 + g + (e >= 2 ? 8 : 0);
        const int j = n0 + 8 * q + 2 * t + (e & 1);
        out[e] = fmaf(sm.bonus[tt], sm.gy[tt][j], big[q][e] + small[q][e]);
      }
      store_pair(dv, base, row, t0, n, m0 + g, n0 + 8 * q + 2 * t, out);
    }
  }
  __syncthreads();

  // dlw_t = p - y_t + sum_{s<t} (x_s - y_s) by a scan over the lanes, into
  // cs's place, then stored a row at a time
  {
    const int c0 = warp * CPW;
    float zv[CPW], yv[CPW];
    row_get<CPW, LD>(zv, &sm.r[0][0], lane, c0);
    row_get<CPW, LD>(yv, &sm.k[0][0], lane, c0);
    const bool last = gs == nullptr && t0 + lane == S - 1;
#pragma unroll
    for (int cc = 0; cc < CPW; ++cc) {
      const float incl = lane_cumsum(zv[cc], lane);
      // without a state cotangent no pair spans the last step
      zv[cc] = last ? 0.f : sm.p[c0 + cc] - yv[cc] + (incl - zv[cc]);
    }
    row_put<CPW, LD>(&sm.cs[0][0], zv, lane, c0);
  }
  __syncthreads();
  constexpr int PIECES = DH / 4;
  for (int idx = tid; idx < n * PIECES; idx += THREADS) {
    const int i = idx / PIECES, q = (idx % PIECES) * 4;
    st4(&dlw[base + (size_t)(t0 + i) * row + q], ld4(&sm.cs[i][q]));
  }
}

template <int DH>
int launch(const float* const* in, float* const* out, int B, int S, int H,
           cudaStream_t stream) {
  const int bh = B * H, nch = (S + C - 1) / C;
  const size_t ws_mat = (size_t)bh * nch * DH * DH;
  float* ws_s = out[4];
  float* ws_g = ws_s + ws_mat;
  float* ws_d = ws_g + ws_mat;
  float* du_part = ws_d + (size_t)bh * nch * DH;

  wkv6_bwd_sums_kernel<DH><<<dim3(nch, bh), THREADS, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[6], ws_s, ws_g, ws_d, du_part, S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  wkv6_bwd_walk_kernel<DH>
      <<<dim3(DH * DH / 4 / CHAIN_THREADS, bh), CHAIN_THREADS, 0, stream>>>(
          in[5], in[7], ws_s, ws_g, ws_d, du_part, out[6], nch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  auto kern = wkv6_bwd_grad_kernel<DH>;
  constexpr int smem = sizeof(GradSmem<DH>);
  static bool ready = false;
  if (!ready) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  kern<<<dim3(nch, bh), THREADS, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], ws_s, ws_g,
      out[6], du_part, out[5], out[0], out[1], out[2], out[3], S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Device pointers to contiguous
// float32 tensors, 16-byte aligned: r, k, v, lw, gy and dr, dk, dv, dlw
// (B, S, H, dh), lw in [-1, 0); u and du (H, dh); state0, gs and dstate0
// (B, H, dh, dh), state0 and gs null for zeros, dstate0 null when it is not
// wanted (and only then: it is given exactly when state0 is); ws the
// workspace, B H ceil(S / 32) (2 dh^2 + 2 dh) floats. dh is 32 or 64,
// B, S, H >= 1. Launches the three kernels on `stream` and returns the first
// CUDA error (0 when every launch was accepted); 1 (cudaErrorInvalidValue)
// for a dh it does not take.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* lw, const void* u, const void* state0,
                        const void* gy, const void* gs, void* dr, void* dk,
                        void* dv, void* dlw, void* ws, void* du,
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
  float* out[7] = {static_cast<float*>(dr),  static_cast<float*>(dk),
                   static_cast<float*>(dv),  static_cast<float*>(dlw),
                   static_cast<float*>(ws),  static_cast<float*>(du),
                   static_cast<float*>(dstate0)};
  if (dh == 64) return launch<64>(in, out, B, S, H, s);
  if (dh == 32) return launch<32>(in, out, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
