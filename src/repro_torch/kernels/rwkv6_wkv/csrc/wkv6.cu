// RWKV-6 WKV forward for Hopper (sm_90a): fp32 in, fp32 out; the chunked
// form with its four matrix products on the tensor cores in 3xTF32.
//
// Replaces src/repro/kernels/rwkv6_wkv/kernel.py::wkv6_fwd (the Pallas TPU
// kernel _wkv6_kernel). Per (batch b, head h) it computes the recurrence of
// the reference oracle over a (dh x dh) state S, carried from `state0`
// (zeros when null) and returned in `state_out`:
//     y_t = r_t^T S + (sum_i r_t,i u_i k_t,i) v_t
//     S  <- diag(exp(lw_t)) S + k_t v_t^T
// r, k, v, lw and y are read and written in the model's (B, S, H, dh)
// layout in place (timestep stride H * dh, head stride dh), u as (H, dh) by
// head index, the states as (B, H, dh, dh) with S[i][j] at i * dh + j.
//
// Precondition: lw in [-1, 0), which the model's clamp guarantees
// (models/rwkv.py::_log_decay) and the Pallas kernel assumes too, so that
// exp(-cumsum(lw)) over a chunk stays below e^C, finite in fp32.
//
// Bound on an H100 SXM: bytes. Per (b, h, t) the recurrence does
// 5 * dh^2 + 5 * dh operations on 5 * dh fp32 inputs and outputs: at
// rwkv6-3b's serving shape (B = 4, H = 40, dh = 64, S = 1536) that is 5.1
// GFLOP, 75 us at the 67 TFLOP/s of the CUDA cores, against 315 MB of r, k,
// v, lw and y plus the states, 95 us at 3.35 TB/s. A decode step (S = 1)
// moves the states, 5.3 MB: 1.6 us.
//
// Design. Stepping the recurrence on the CUDA cores cannot come near the
// bound (its dependent chain per step is latency-bound at the few warps a
// (b, h) grid gives). As the Pallas kernel does, the sequence is cut into
// chunks of C steps and each chunk is four matrix products: with cs the
// inclusive cumsum of lw over the chunk, r~ = r e^(cs - lw) and
// k~ = k e^(-cs),
//     att = r~ k~^T, strictly lower, with the bonus r_i . (u k_i) on the
//           diagonal
//     y   = att v + r~ S_in
//     S_out = diag(e^total) (S_in + k~^T v)
// (the last is the Pallas kernel's diag(e^total) S_in + (k e^(total -
// cs))^T v, with the decay applied once after the sum, which keeps fp32's
// relative precision: the large terms of k~^T v are the ones e^total
// scales back). One block of eight warps owns one (b, h):
//  * C = 32, not the Pallas kernel's 64: per step the triangular products
//    cost C dh and the state products dh^2 whatever C is, so the shorter
//    chunk halves the first kind, and its 93 KB of shared memory (a
//    two-stage ring of 32 rows of r, k, lw and v, the state, att) lets two
//    blocks share an SM, so all 160 heads of the serving shape run at
//    once on 132 SMs and one block's barriers hide under the other's work;
//  * the products run as mma.sync m16n8k8 TF32 with fp32 accumulation, in
//    the 3xTF32 split: each operand is hi + lo, both rounded to TF32, and
//    the product hi hi + hi lo + lo hi, which keeps about 21 bits where one
//    TF32 pass keeps 11 (a unit roundoff of 4.9e-4, at the tolerance); the
//    cross terms go to a second accumulator, so a k-step's three products
//    form two independent chains. mma.sync rather than wgmma: each product
//    is at most 32 x 64 x 64 and is spread over eight warps, where a
//    64-row warpgroup tile would leave warps idle (argued, not measured:
//    no wgmma version was built);
//  * a chunk is three phases between barriers: each warp scans dh / 8
//    columns of lw (lane = row, read as float4s, cumsum by shuffles, in
//    log2 units, exps as MUFU.EX2) and turns r and k into r~ and k~ in
//    place; six warps form att's six tiles on or below the diagonal into
//    shared memory while two take the chunk's decay 2^total in fp64 (it
//    compounds over the chunks, so it is rounded once); then every warp
//    adds att v and r~ S_in for 16 rows and dh / 4 columns of y (stored
//    straight from the accumulators) and k~^T v for its tiles of the
//    state. The state stays in registers for the whole sequence, with a
//    copy in shared memory as the B operand of r~ S_in; k~^T v is summed
//    in the tensor cores from zero and added to it on the CUDA cores,
//    because fp32 sums in the tensor cores are not rounded to nearest and
//    a state accumulated there drifts over the chunks (measured: 2.1e-3
//    against the fp64 recurrence at lw = -1e-6 over 1536 steps, where the
//    tolerance is 5e-4);
//  * r, k, v and lw of a head are read from global memory once: 16-byte
//    cp.async into the ring, the next chunk in flight while this one
//    computes; rows are padded to dh + 4 floats (the state's to dh + 8,
//    att's to C + 8), and the summed index of att v and k~^T v is permuted
//    (8 ks + 2t and 8 ks + 2t + 1 for k = t and t + 4) in both operands, so
//    fragment loads are free of bank conflicts;
//  * a ragged tail chunk is zero-filled past S (k = v = r = 0, lw = 0): it
//    neither decays nor adds to the state, and its y rows are not stored;
//  * S = 1 (decode) takes its own kernel: blocks of 64 threads over (b, h)
//    and 16 value columns, each thread a float4 of columns on dh / 16 rows,
//    the state read and written once in 16-byte pieces, y summed over the
//    rows in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Build-time setting, for examples/bench_recurrent_kernels_torch.py's
// variants (``--variant NAME=WKV6_ABLATE=3``): its bits take products out
// so that their cost shows in the time, and a build with any bit set
// computes wrong results. The package builds it as 0.
#ifndef WKV6_ABLATE
#define WKV6_ABLATE 0
#endif
constexpr int NO_INTRA = 1;        // att = r~ k~^T and att v
constexpr int NO_STATE = 2;        // r~ S_in and k~^T v
constexpr int ONE_PASS = 4;        // hi hi only: one TF32 pass
constexpr int ABLATE = WKV6_ABLATE;

constexpr int C = 32;              // timesteps per chunk: one per lane
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to TF32 as cvt.rna.tf32.f32 does (to nearest, ties away from
// zero; 10 explicit mantissa bits), in two full-rate integer operations
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// big + small += A B in 3xTF32: hi hi into `big`, the two cross terms
// into `small` (added at the end), so the three products of a k-step form
// two independent chains
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  if constexpr (!(ABLATE & ONE_PASS)) {
    mma(small, al, bh0, bh1);
    mma(small, ah, bl0, bl1);
  }
  mma(big, ah, bh0, bh1);
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

template <int DH>
struct Stage {
  float r[C][DH + 4];              // r, then r~
  float k[C][DH + 4];              // k, then k~
  float w[C][DH + 4];              // lw
  float v[C][DH + 4];
};

template <int DH>
struct Smem {
  Stage<DH> st[2];
  float s[DH][DH + 8];             // S_in, the B operand of r~ S_in
  float att[C][C + 8];             // att, the bonus on its diagonal
  float bonus[WARPS][C];           // the bonus's parts, one per warp
  float etot[DH];                  // the chunk's total, then 2^total
  float u[DH];
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
wkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ lw,
                  const float* __restrict__ u,
                  const float* __restrict__ state0, float* __restrict__ y,
                  float* __restrict__ state_out, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);
  constexpr int KS = DH / 8;             // k-steps over dh
  constexpr int NY = DH / 32;            // y column tiles per warp
  constexpr int MS = DH / 16;            // state row tiles
  constexpr int NS = DH / 8 * MS / WARPS;  // state column tiles per warp
  constexpr int CPW = DH / WARPS;        // columns a warp scans

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group and column
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t row = (size_t)H * DH;     // timestep stride
  const size_t base = (size_t)b * S * row + (size_t)h * DH;
  const size_t sbase = (size_t)bh * DH * DH;

  const int mi = warp % 2;               // y: rows 16 mi of the chunk,
  const int col0 = (warp / 2) * 8 * NY;  // columns col0 ..
  const int jt = 2 * (mi + 1);           // att's column tiles at or below
  const int ms = warp % MS;              // S: rows 16 ms,
  const int ns0 = (warp / MS) * NS;      // column tiles ns0 ..

  float sacc[NS][4];
#pragma unroll
  for (int q = 0; q < NS; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * ms + g + (e >= 2 ? 8 : 0);
      const int j = 8 * (ns0 + q) + 2 * t + (e & 1);
      sacc[q][e] = state0 != nullptr ? state0[sbase + (size_t)i * DH + j]
                                     : 0.f;
    }
  }
  for (int i = tid; i < DH; i += THREADS) sm.u[i] = u[h * DH + i];

  const int nch = (S + C - 1) / C;
  auto issue = [&](int kc) {
    Stage<DH>& st = sm.st[kc & 1];
    const int t0 = kc * C, n = min(C, S - t0);
    constexpr int PIECES = DH / 4;
    for (int idx = tid; idx < C * PIECES; idx += THREADS) {
      const int i = idx / PIECES, c = (idx % PIECES) * 4;
      const bool ok = i < n;
      const size_t gi = base + (size_t)(t0 + (ok ? i : 0)) * row + c;
      cp_async16(&st.r[i][c], r + gi, ok);
      cp_async16(&st.k[i][c], k + gi, ok);
      cp_async16(&st.w[i][c], lw + gi, ok);
      cp_async16(&st.v[i][c], v + gi, ok);
    }
    cp_async_commit();
  };

  issue(0);
  for (int kc = 0; kc < nch; ++kc) {
    if (kc + 1 < nch) {
      issue(kc + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    Stage<DH>& st = sm.st[kc & 1];
    const int t0 = kc * C, n = min(C, S - t0);

    // warp w scans columns w CPW ..: lane l holds row l of them, read and
    // written as float4s (eight lanes' rows fall in distinct banks); cs =
    // cumsum(lw) in log2 units by shuffles, then r~ = r 2^(cs_{l-1}) and
    // k~ = k 2^(-cs_l) in place, the bonus's part from the raw r and k,
    // and the chunk's total
    {
      constexpr int V = CPW / 4;
      const int c0 = warp * CPW;
      float rv[CPW], kv[CPW], wv[CPW];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int c = c0 + 4 * q;
        const float4 a = *reinterpret_cast<const float4*>(&st.r[lane][c]);
        const float4 b = *reinterpret_cast<const float4*>(&st.k[lane][c]);
        const float4 w = *reinterpret_cast<const float4*>(&st.w[lane][c]);
        rv[4 * q] = a.x, rv[4 * q + 1] = a.y, rv[4 * q + 2] = a.z,
        rv[4 * q + 3] = a.w;
        kv[4 * q] = b.x, kv[4 * q + 1] = b.y, kv[4 * q + 2] = b.z,
        kv[4 * q + 3] = b.w;
        wv[4 * q] = w.x, wv[4 * q + 1] = w.y, wv[4 * q + 2] = w.z,
        wv[4 * q + 3] = w.w;
      }
      float part = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPW; ++cc) {
        float cs = wv[cc] * LOG2E;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(0xffffffffu, cs, off);
          if (lane >= off) cs += o;
        }
        float prev = __shfl_up_sync(0xffffffffu, cs, 1);
        if (lane == 0) prev = 0.f;
        part = fmaf(rv[cc] * sm.u[c0 + cc], kv[cc], part);
        rv[cc] *= ex2(prev);
        kv[cc] *= ex2(-cs);
        if (lane == 31) sm.etot[c0 + cc] = cs;   // the total, for now
      }
#pragma unroll
      for (int q = 0; q < V; ++q) {
        *reinterpret_cast<float4*>(&st.r[lane][c0 + 4 * q]) = make_float4(
            rv[4 * q], rv[4 * q + 1], rv[4 * q + 2], rv[4 * q + 3]);
        *reinterpret_cast<float4*>(&st.k[lane][c0 + 4 * q]) = make_float4(
            kv[4 * q], kv[4 * q + 1], kv[4 * q + 2], kv[4 * q + 3]);
      }
      sm.bonus[warp][lane] = part;
    }
    // S_in to shared memory, for r~ S_in
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int i = 16 * ms + g, j = 8 * (ns0 + q) + 2 * t;
      *reinterpret_cast<float2*>(&sm.s[i][j]) =
          make_float2(sacc[q][0], sacc[q][1]);
      *reinterpret_cast<float2*>(&sm.s[i + 8][j]) =
          make_float2(sacc[q][2], sacc[q][3]);
    }
    __syncthreads();

    // att = r~ k~^T on its six tiles at or below the diagonal, one per warp
    // of warps 0-5: strictly lower, the bonus on the diagonal. Meanwhile
    // warps 6 and 7 turn the totals into 2^total: the state's decay
    // compounds over the chunks, so it is taken in fp64 and rounded once
    if (warp >= 6) {
      const int c = tid - 6 * 32;
      if (c < DH)
        sm.etot[c] = static_cast<float>(exp2(static_cast<double>(sm.etot[c])));
    } else {
      const int ai = warp < 2 ? 0 : 1;         // row tile
      const int aj = warp < 2 ? warp : warp - 2;  // column tile
      float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4];
        const float* a = &st.r[16 * ai + g][8 * ks + t];
        split(a[0], ah[0], al[0]);
        split(a[8 * (DH + 4)], ah[1], al[1]);
        split(a[4], ah[2], al[2]);
        split(a[8 * (DH + 4) + 4], ah[3], al[3]);
        const float* bk = &st.k[8 * aj + g][8 * ks + t];
        if constexpr (!(ABLATE & NO_INTRA))
          mma3(big, small, ah, al, bk[0], bk[4]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * ai + g + (e >= 2 ? 8 : 0);
        const int j = 8 * aj + 2 * t + (e & 1);
        float val = 0.f;
        if (j < i) {
          val = big[e] + small[e];
        } else if (j == i) {
#pragma unroll
          for (int q = 0; q < WARPS; ++q) val += sm.bonus[q][i];
        }
        sm.att[i][j] = val;
      }
    }
    __syncthreads();

    // y = att v + r~ S_in on rows 16 mi, columns col0 ..; the summed index
    // j of att v is taken as 8 ks + 2t for k = t and 8 ks + 2t + 1 for
    // k = t + 4, in att and v alike, so that att's pair loads as one float2
    {
      float big[NY][4], small[NY][4];
#pragma unroll
      for (int q = 0; q < NY; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) big[q][e] = small[q][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < C / 8; ++ks) {
        if (ks < jt) {
          const float2 p0 = *reinterpret_cast<const float2*>(
              &sm.att[16 * mi + g][8 * ks + 2 * t]);
          const float2 p1 = *reinterpret_cast<const float2*>(
              &sm.att[16 * mi + g + 8][8 * ks + 2 * t]);
          uint32_t ah[4], al[4];
          split(p0.x, ah[0], al[0]);
          split(p1.x, ah[1], al[1]);
          split(p0.y, ah[2], al[2]);
          split(p1.y, ah[3], al[3]);
#pragma unroll
          for (int q = 0; q < NY; ++q) {
            const float* bv = &st.v[8 * ks + 2 * t][col0 + 8 * q + g];
            if constexpr (!(ABLATE & NO_INTRA))
              mma3(big[q], small[q], ah, al, bv[0], bv[DH + 4]);
          }
        }
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4];
        const float* a = &st.r[16 * mi + g][8 * ks + t];
        split(a[0], ah[0], al[0]);
        split(a[8 * (DH + 4)], ah[1], al[1]);
        split(a[4], ah[2], al[2]);
        split(a[8 * (DH + 4) + 4], ah[3], al[3]);
#pragma unroll
        for (int q = 0; q < NY; ++q) {
          const float* bs = &sm.s[8 * ks + t][col0 + 8 * q + g];
          if constexpr (!(ABLATE & NO_STATE))
            mma3(big[q], small[q], ah, al, bs[0], bs[4 * (DH + 8)]);
        }
      }
#pragma unroll
      for (int q = 0; q < NY; ++q) {
        const int i = 16 * mi + g, j = col0 + 8 * q + 2 * t;
        if (i < n)
          *reinterpret_cast<float2*>(&y[base + (size_t)(t0 + i) * row + j]) =
              make_float2(big[q][0] + small[q][0], big[q][1] + small[q][1]);
        if (i + 8 < n)
          *reinterpret_cast<float2*>(
              &y[base + (size_t)(t0 + i + 8) * row + j]) =
              make_float2(big[q][2] + small[q][2], big[q][3] + small[q][3]);
      }
    }

    // S <- diag(2^total) (S + k~^T v): A = k~^T (rows i of S, summed index
    // j permuted as above), B = v. The product starts from zero and is
    // added to S on the CUDA cores: accumulating S itself in the tensor
    // cores, whose fp32 sums are not rounded to nearest, drifts over the
    // chunks
    {
      float big[NS][4], small[NS][4];
#pragma unroll
      for (int q = 0; q < NS; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) big[q][e] = small[q][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < C / 8; ++ks) {
        uint32_t ah[4], al[4];
        const float* a = &st.k[8 * ks + 2 * t][16 * ms + g];
        split(a[0], ah[0], al[0]);
        split(a[8], ah[1], al[1]);
        split(a[DH + 4], ah[2], al[2]);
        split(a[DH + 4 + 8], ah[3], al[3]);
#pragma unroll
        for (int q = 0; q < NS; ++q) {
          const float* bv = &st.v[8 * ks + 2 * t][8 * (ns0 + q) + g];
          if constexpr (!(ABLATE & NO_STATE))
            mma3(big[q], small[q], ah, al, bv[0], bv[DH + 4]);
        }
      }
      const float e0 = sm.etot[16 * ms + g], e1 = sm.etot[16 * ms + g + 8];
#pragma unroll
      for (int q = 0; q < NS; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[q][e] = (sacc[q][e] + (big[q][e] + small[q][e])) *
                       (e < 2 ? e0 : e1);
      }
    }
    __syncthreads();                 // the stage is free for chunk kc + 2
  }

#pragma unroll
  for (int q = 0; q < NS; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * ms + g + (e >= 2 ? 8 : 0);
      const int j = 8 * (ns0 + q) + 2 * t + (e & 1);
      state_out[sbase + (size_t)i * DH + j] = sacc[q][e];
    }
  }
}

// one step (S = 1): block (b, h) x 16 value columns, 64 threads; thread
// (rg, cq) holds columns 4 cq .. 4 cq + 3 on rows rg + 16 m
template <int DH>
__global__ void __launch_bounds__(64)
wkv6_decode_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ lw,
                   const float* __restrict__ u,
                   const float* __restrict__ state0, float* __restrict__ y,
                   float* __restrict__ state_out, int H) {
  __shared__ float rs[DH], ks[DH], ws[DH];
  __shared__ float part[16][17];
  __shared__ float bsum[2];
  const int tid = threadIdx.x, rg = tid / 4, cq = tid % 4;
  const int bh = blockIdx.x, h = bh % H;
  const int j0 = blockIdx.y * 16, j = j0 + 4 * cq;
  const size_t xo = (size_t)bh * DH;     // (b, 0, h, 0) at S = 1
  const size_t sbase = (size_t)bh * DH * DH;
  float p = 0.f;
  if (tid < DH) {
    const float rr = r[xo + tid], kk = k[xo + tid];
    rs[tid] = rr;
    ks[tid] = kk;
    ws[tid] = expf(lw[xo + tid]);
    p = rr * u[h * DH + tid] * kk;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    p += __shfl_xor_sync(0xffffffffu, p, off);
  if (tid % 32 == 0) bsum[tid / 32] = p;
  __syncthreads();
  const float4 vv = *reinterpret_cast<const float4*>(&v[xo + j]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int m = 0; m < DH / 16; ++m) {
    const int i = rg + 16 * m;
    const size_t si = sbase + (size_t)i * DH + j;
    const float4 s = state0 != nullptr
                         ? *reinterpret_cast<const float4*>(&state0[si])
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    const float ri = rs[i], ki = ks[i], wi = ws[i];
    acc.x = fmaf(ri, s.x, acc.x);
    acc.y = fmaf(ri, s.y, acc.y);
    acc.z = fmaf(ri, s.z, acc.z);
    acc.w = fmaf(ri, s.w, acc.w);
    *reinterpret_cast<float4*>(&state_out[si]) =
        make_float4(fmaf(wi, s.x, ki * vv.x), fmaf(wi, s.y, ki * vv.y),
                    fmaf(wi, s.z, ki * vv.z), fmaf(wi, s.w, ki * vv.w));
  }
  part[rg][4 * cq + 0] = acc.x;
  part[rg][4 * cq + 1] = acc.y;
  part[rg][4 * cq + 2] = acc.z;
  part[rg][4 * cq + 3] = acc.w;
  __syncthreads();
  if (tid < 16) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q) sum += part[q][tid];
    y[xo + j0 + tid] = fmaf(bsum[0] + bsum[1], v[xo + j0 + tid], sum);
  }
}

template <int DH>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* state0, float* y, float* state_out,
           int B, int S, int H, cudaStream_t stream) {
  if (S == 1) {
    wkv6_decode_kernel<DH><<<dim3(B * H, DH / 16), 64, 0, stream>>>(
        r, k, v, lw, u, state0, y, state_out, H);
    return static_cast<int>(cudaGetLastError());
  }
  auto kern = wkv6_chunk_kernel<DH>;
  constexpr int smem = sizeof(Smem<DH>);
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  kern<<<B * H, THREADS, smem, stream>>>(r, k, v, lw, u, state0, y,
                                         state_out, S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers to
// contiguous float32 tensors, 16-byte aligned: r, k, v, lw and y
// (B, S, H, dh), lw in [-1, 0); u (H, dh); state0 (B, H, dh, dh) or null
// for zeros; state_out (B, H, dh, dh). dh is 32 or 64, B, S, H >= 1.
// Launches on `stream` (the chunked kernel, or the decode kernel when
// S = 1) and returns the first CUDA error (0 when the launch was
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
