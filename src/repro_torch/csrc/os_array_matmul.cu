// Pass 1 of the paper's two-pass pipeline for Hopper (sm_90a): the faulty
// output-stationary array's matmul, out = stuck_at(x @ w).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/os_array_matmul.py::os_array_matmul (body _kernel /
// _stuck_at).  It computes what that kernel computes: a float32 accumulate of
// (M, K) @ (K, N), then, at drain, the stuck-at of each faulty PE on the f32
// bit pattern of every output it owns.  Placement is tile-granular: output
// (i, j) belongs to PE((i / bm) % rows, (j / bn) % cols).  The stuck-at
// arrives as the (rows, cols) int32 AND/OR mask pair built by the wrapper, so
// the drain is one line:
//
//     out = int_as_float((float_as_int(acc) & and_grid[pe]) | or_grid[pe])
//
// (bm, bn) are the fault placement only, never the CUDA block: the PE is
// computed per output element in the epilogue, so any bm, bn >= 1 works
// (bm = bn = 1 is the engine's element placement).  The TPU kernel's bk only
// set its accumulation order; here every output is the sequential chain of
// array_tile.cuh, the same chain dppu_recompute.cu runs.
//
// What bounds it here: at the pipeline's shapes (M = 4096 tokens) a call does
// 2*M*N*K operations on (M + N)*K operands, hundreds of operations per byte,
// so it is bound by arithmetic.  This first version runs f32 FMAs on the CUDA
// cores (array_tile.cuh: 128 x 128 block tiles, 8 x 8 outputs per thread),
// not the tensor cores, so it sits far above the bf16 tensor-core bound; a
// wgmma main loop is later work.  The grid puts M on x so that the blocks
// sharing one column panel of w run together and w streams from device
// memory about once.  The kernel allocates nothing and launches on the
// caller's stream.
#include <cuda_runtime.h>

#include "array_tile.cuh"

namespace {

using namespace array_tile;

template <bool W_K_FAST, typename T>
__global__ void __launch_bounds__(THREADS) os_array_matmul_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ and_grid,
    const int* __restrict__ or_grid, float* __restrict__ out, int M, int N, int K,
    long long sxm, long long sxk, long long swk, long long swn, int bm, int bn, int rows,
    int cols) {
  __shared__ Shared s;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  float acc[8][8];
  accumulate_tile<W_K_FAST>(s, x, w, m0, n0, M, N, K, sxm, sxk, swk, swn, acc);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  int pe_col[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) pe_col[c] = ((n0 + owned(tx, c)) / bn) % cols;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = m0 + owned(ty, r);
    if (m >= M) continue;
    const int* ag = and_grid + ((m / bm) % rows) * cols;
    const int* og = or_grid + ((m / bm) % rows) * cols;
    float* o = out + (long long)m * N;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + owned(tx, c);
      if (n < N) o[n] = __int_as_float((__float_as_int(acc[r][c]) & ag[pe_col[c]]) | og[pe_col[c]]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const int* ag, const int* og, float* out, int M, int N,
            int K, long long sxm, long long sxk, long long swk, long long swn, int bm, int bn,
            int rows, int cols, cudaStream_t stream) {
  const dim3 grid((M + TM - 1) / TM, (N + TN - 1) / TN);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  if (swk == 1 && swn != 1)
    os_array_matmul_kernel<true, T><<<grid, THREADS, 0, stream>>>(
        xp, wp, ag, og, out, M, N, K, sxm, sxk, swk, swn, bm, bn, rows, cols);
  else
    os_array_matmul_kernel<false, T><<<grid, THREADS, 0, stream>>>(
        xp, wp, ag, og, out, M, N, K, sxm, sxk, swk, swn, bm, bn, rows, cols);
}

}  // namespace

// x: (M, K) with strides (sxm, sxk); w: (K, N) with strides (swk, swn), both in
// elements and of one dtype: 0 float32, 1 bfloat16, 2 int8.  and_grid /
// or_grid: (rows, cols) int32, contiguous.  out: (M, N) float32, contiguous.
// (bm, bn): the fault-placement tile.  N / 128 must be at most 65535.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unknown dtype).
extern "C" int os_array_matmul_launch(const void* x, const void* w, const void* and_grid,
                                      const void* or_grid, void* out, int M, int N, int K,
                                      long long sxm, long long sxk, long long swk,
                                      long long swn, int dtype, int bm, int bn, int rows,
                                      int cols, void* stream) {
  if (M > 0 && N > 0) {
    const int* ag = static_cast<const int*>(and_grid);
    const int* og = static_cast<const int*>(or_grid);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      launch<float>(x, w, ag, og, o, M, N, K, sxm, sxk, swk, swn, bm, bn, rows, cols, s);
    else if (dtype == 1)
      launch<__nv_bfloat16>(x, w, ag, og, o, M, N, K, sxm, sxk, swk, swn, bm, bn, rows, cols, s);
    else if (dtype == 2)
      launch<int8_t>(x, w, ag, og, o, M, N, K, sxm, sxk, swk, swn, bm, bn, rows, cols, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
