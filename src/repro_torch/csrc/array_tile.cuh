// One 128 x 128 output tile of x @ w on the CUDA cores, float32 accumulate.
//
// Shared by os_array_matmul.cu (pass 1 of the paper's two-pass pipeline) and
// dppu_recompute.cu (pass 2).  The two must agree bit for bit: a tile the
// DPPU recomputes has to equal what a fault-free array computes there, on any
// operands.  So both run this one main loop, and every output element is the
// same sequential chain acc = fmaf(x[i, k], w[k, j], acc) over k = 0 .. K-1,
// whatever tile, block or grid it sits in.  Rows and columns outside a
// block's limits are loaded as zeros and never stored.
//
// Layout: 256 threads, TK = 8-deep K panels staged in shared memory (double
// buffered; the next panel's global loads are in flight while the current
// one is summed), each thread owning an 8 x 8 register tile: rows
// {ty*4 .. ty*4+3, 64+ty*4 .. 64+ty*4+3} and the same split of columns, so
// that its float4 shared-memory reads are conflict-free.  Operands are f32,
// bf16 or int8, widened to f32 on the way into shared memory (a bf16 x bf16
// product is exact in f32, and int8 products and sums are exact while
// |acc| < 2^24).  x and w are read through their strides; the staging lays
// the lanes along k for x and along w's unit-stride axis (W_K_FAST: along k,
// as for the transposed view of a (N, K) table), so both layouts are read
// without a copy.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace array_tile {

constexpr int TM = 128;
constexpr int TN = 128;
constexpr int TK = 8;
constexpr int THREADS = 256;
constexpr int PAD = 4;  // keeps the k-major staging stores conflict-free
constexpr int X_PER_THREAD = TM * TK / THREADS;  // 4
constexpr int W_PER_THREAD = TK * TN / THREADS;  // 4

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }

// The row (or column) of the tile that a thread's register index r in 0..7 holds.
__device__ __forceinline__ int owned(int t, int r) { return (r >> 2) * 64 + t * 4 + (r & 3); }

struct __align__(16) Shared {
  float x[2][TK][TM + PAD];
  float w[2][TK][TN + PAD];
};

// Global -> registers for the panel at k0.  x element (i, k) is staged by
// thread (k % TK) + TK * (i % 32); w element (k, j) along w's unit-stride axis.
template <bool W_K_FAST, typename T>
__device__ __forceinline__ void load_panel(
    const T* __restrict__ x, const T* __restrict__ w, int m0, int n0, int m_end, int n_end,
    int K, int k0, long long sxm, long long sxk, long long swk, long long swn,
    float (&xr)[X_PER_THREAD], float (&wr)[W_PER_THREAD]) {
  const int t = threadIdx.x;
  {
    const int k = k0 + t % TK, i = m0 + t / TK;
    const T* p = x + (long long)i * sxm + (long long)k * sxk;
#pragma unroll
    for (int r = 0; r < X_PER_THREAD; ++r)
      xr[r] = (k < K && i + r * (THREADS / TK) < m_end) ? widen(p[(long long)r * (THREADS / TK) * sxm]) : 0.f;
  }
  if (W_K_FAST) {
    const int k = k0 + t % TK, j = n0 + t / TK;
    const T* p = w + (long long)k * swk + (long long)j * swn;
#pragma unroll
    for (int r = 0; r < W_PER_THREAD; ++r)
      wr[r] = (k < K && j + r * (THREADS / TK) < n_end) ? widen(p[(long long)r * (THREADS / TK) * swn]) : 0.f;
  } else {
    const int k = k0 + t / TN, j = n0 + t % TN;
    const T* p = w + (long long)k * swk + (long long)j * swn;
#pragma unroll
    for (int r = 0; r < W_PER_THREAD; ++r)
      wr[r] = (k + r * (THREADS / TN) < K && j < n_end) ? widen(p[(long long)r * (THREADS / TN) * swk]) : 0.f;
  }
}

template <bool W_K_FAST>
__device__ __forceinline__ void store_panel(Shared& s, int buf, const float (&xr)[X_PER_THREAD],
                                            const float (&wr)[W_PER_THREAD]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < X_PER_THREAD; ++r) s.x[buf][t % TK][t / TK + r * (THREADS / TK)] = xr[r];
#pragma unroll
  for (int r = 0; r < W_PER_THREAD; ++r) {
    if (W_K_FAST)
      s.w[buf][t % TK][t / TK + r * (THREADS / TK)] = wr[r];
    else
      s.w[buf][t / TN + r * (THREADS / TN)][t % TN] = wr[r];
  }
}

// acc[r][c] = sum over k of x[m0 + owned(ty, r), k] * w[k, n0 + owned(tx, c)],
// with ty = threadIdx.x / 16 and tx = threadIdx.x % 16; rows >= m_end and
// columns >= n_end read zeros.
template <bool W_K_FAST, typename T>
__device__ __forceinline__ void accumulate_tile(
    Shared& s, const T* __restrict__ x, const T* __restrict__ w, int m0, int n0, int m_end,
    int n_end, int K, long long sxm, long long sxk, long long swk, long long swn,
    float (&acc)[8][8]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  float xr[X_PER_THREAD], wr[W_PER_THREAD];
  load_panel<W_K_FAST>(x, w, m0, n0, m_end, n_end, K, 0, sxm, sxk, swk, swn, xr, wr);
  store_panel<W_K_FAST>(s, 0, xr, wr);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += TK) {
    const bool more = k0 + TK < K;
    if (more) load_panel<W_K_FAST>(x, w, m0, n0, m_end, n_end, K, k0 + TK, sxm, sxk, swk, swn, xr, wr);
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.x[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.x[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.w[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.w[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    // the other buffer was last read before the previous barrier
    if (more) store_panel<W_K_FAST>(s, buf ^ 1, xr, wr);
    __syncthreads();
    buf ^= 1;
  }
}

}  // namespace array_tile
