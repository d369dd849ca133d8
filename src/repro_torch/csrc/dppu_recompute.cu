// Pass 2 of the paper's two-pass pipeline for Hopper (sm_90a): the grouped
// DPPU recompute of the output tiles that faulty PEs own.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/dppu_recompute.py::dppu_recompute (body _kernel).  For
// every entry f of a tile-level fault PE table fpt (F, 2) it recomputes the
// (bm, bn) output tile (ti, tj) = fpt[f] of x @ w with a float32 accumulate,
// reading only the x row-panel [ti*bm, (ti+1)*bm) x K and the w column-panel
// K x [tj*bn, (tj+1)*bn): the table steers the reads, which is the paper's
// address generation unit (the TPU kernel did it with scalar prefetch into
// its index maps; here each block loads its own entry).  Padded entries (-1)
// are clamped to tile (0, 0), as the TPU kernel clamps them, and so return
// tile (0, 0).
//
// Grid: (F, ceil(bm / 128), ceil(bn / 128)); each block runs the main loop of
// array_tile.cuh on one 128 x 128 piece of its tile.  That loop is the one
// os_array_matmul.cu runs, so a recomputed tile equals the fault-free array's
// output bit for bit on any operands.
//
// What bounds it here: each tile does 2*bm*bn*K operations on (bm + bn)*K
// operands, 64 operations per operand at bm = bn = 128: arithmetic, on the
// CUDA cores in this first version.  The kernel allocates nothing and
// launches on the caller's stream.
#include <cuda_runtime.h>

#include "array_tile.cuh"

namespace {

using namespace array_tile;

template <bool W_K_FAST, typename T>
__global__ void __launch_bounds__(THREADS) dppu_recompute_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ fpt,
    float* __restrict__ out, int K, long long sxm, long long sxk, long long swk,
    long long swn, int bm, int bn) {
  __shared__ Shared s;
  const int f = blockIdx.x;
  const int ti = max(fpt[2 * f], 0), tj = max(fpt[2 * f + 1], 0);
  const int r0 = blockIdx.y * TM, c0 = blockIdx.z * TN;  // this block's piece of the tile
  const int m_tile = ti * bm, n_tile = tj * bn;
  float acc[8][8];
  accumulate_tile<W_K_FAST>(s, x, w, m_tile + r0, n_tile + c0, m_tile + bm, n_tile + bn, K, sxm,
                            sxk, swk, swn, acc);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* o = out + (long long)f * bm * bn;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = r0 + owned(ty, r);
    if (i >= bm) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = c0 + owned(tx, c);
      if (j < bn) o[(long long)i * bn + j] = acc[r][c];
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const int* fpt, float* out, int F, int K, long long sxm,
            long long sxk, long long swk, long long swn, int bm, int bn, cudaStream_t stream) {
  const dim3 grid(F, (bm + TM - 1) / TM, (bn + TN - 1) / TN);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  if (swk == 1 && swn != 1)
    dppu_recompute_kernel<true, T><<<grid, THREADS, 0, stream>>>(xp, wp, fpt, out, K, sxm, sxk,
                                                                 swk, swn, bm, bn);
  else
    dppu_recompute_kernel<false, T><<<grid, THREADS, 0, stream>>>(xp, wp, fpt, out, K, sxm, sxk,
                                                                  swk, swn, bm, bn);
}

}  // namespace

// x: (M, K) with strides (sxm, sxk); w: (K, N) with strides (swk, swn), both in
// elements and of one dtype: 0 float32, 1 bfloat16, 2 int8.  fpt: (F, 2) int32,
// contiguous, every entry a tile inside (M / bm, N / bn) or -1 padding.
// out: (F, bm, bn) float32, contiguous.  bm / 128 and bn / 128 must be at most
// 65535.  Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for an unknown dtype).
extern "C" int dppu_recompute_launch(const void* x, const void* w, const void* fpt, void* out,
                                     int F, int K, long long sxm, long long sxk, long long swk,
                                     long long swn, int dtype, int bm, int bn, void* stream) {
  if (F > 0 && bm > 0 && bn > 0) {
    const int* t = static_cast<const int*>(fpt);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      launch<float>(x, w, t, o, F, K, sxm, sxk, swk, swn, bm, bn, s);
    else if (dtype == 1)
      launch<__nv_bfloat16>(x, w, t, o, F, K, sxm, sxk, swk, swn, bm, bn, s);
    else if (dtype == 2)
      launch<int8_t>(x, w, t, o, F, K, sxm, sxk, swk, swn, bm, bn, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
