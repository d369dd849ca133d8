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
// set its accumulation order; here the order is the main loop's, the one
// dppu_recompute.cu runs.
//
// Two main loops, chosen by dtype alone:
//   - bf16: array_tile_wgmma.cuh, TMA + wgmma on the tensor cores.  A block
//     is two consumer warpgroups (a 128 x 128 output tile: two array-aligned
//     64 x 128 pieces) and one producer warp, with a ring of 3 stages.  The
//     epilogue runs from the accumulator registers.
//   - f32 and int8: array_tile.cuh, the sequential fmaf chain on the CUDA
//     cores (f32 on the tensor cores would be TF32; int8 products are summed
//     in f32 as the JAX kernel sums them, which an s32 wgmma would not match
//     once |acc| >= 2^24).
//
// What bounds it: at the pipeline's shapes (M = 4096) a call does 2*M*N*K
// operations on (M + N)*K operands and M*N f32 outputs.  With bf16 operands
// that is operations at the tensor cores' rate, but at the LM head the 2.5 GB
// of f32 output alone takes 57% of that time at the memory's rate.  So the
// epilogue has to overlap other blocks' main loops: the wgmma kernel holds
// its registers to fit two blocks on an SM (launch bounds 288 x 2) and its
// shared memory to half an SM's, so that while one block drains the other
// runs on the tensor cores.  On the H100 that overlap is partial: the head
// runs at about 45% of the operations bound (PERF.md).  The grid puts M on x
// so that the blocks sharing one column panel of w run together and w
// streams from device memory about once.  The kernels allocate nothing and
// launch on the caller's stream.
#include <cuda_runtime.h>

#include "array_tile.cuh"
#include "array_tile_wgmma.cuh"

namespace {

// --------------------------------------------------- f32 and int8: CUDA cores
template <bool W_K_FAST, typename T>
__global__ void __launch_bounds__(array_tile::THREADS) os_array_matmul_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ and_grid,
    const int* __restrict__ or_grid, float* __restrict__ out, int M, int N, int K,
    long long sxm, long long sxk, long long swk, long long swn, int bm, int bn, int rows,
    int cols) {
  using namespace array_tile;
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
void launch_cuda_cores(const void* x, const void* w, const int* ag, const int* og, float* out, int M,
                       int N, int K, long long sxm, long long sxk, long long swk, long long swn,
                       int bm, int bn, int rows, int cols, cudaStream_t stream) {
  using namespace array_tile;
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

// ------------------------------------------------------ bf16: tensor cores
namespace tc = array_tile_wgmma;
// two consumer warpgroups: a 128 x 128 output tile, a 96 KB ring of 3
// stages, and two blocks to an SM
using G = tc::Geometry<2, 3>;
constexpr int BLOCKS_PER_SM = 2;
constexpr int TILE_M = G::WGS * tc::WG_M;

__device__ __forceinline__ float stuck_at(float v, int and_mask, int or_mask) {
  return __int_as_float((__float_as_int(v) & and_mask) | or_mask);
}

template <bool W_K_MAJOR>
__global__ void __launch_bounds__(G::THREADS, BLOCKS_PER_SM) os_array_matmul_wgmma(
    const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
    const int* __restrict__ and_grid, const int* __restrict__ or_grid, float* __restrict__ out,
    int M, int N, int K, int bm, int bn, int rows, int cols) {
  extern __shared__ uint8_t smem_raw[];
  auto& s = tc::aligned_smem<G>(smem_raw);
  __shared__ int pe_col[tc::TILE_N];  // the PE column of each of the tile's columns
  const int m0 = blockIdx.x * TILE_M, n0 = blockIdx.y * tc::TILE_N;
  const int KT = (K + tc::STAGE_K - 1) / tc::STAGE_K;
  const int tid = threadIdx.x;
  if (tid < tc::TILE_N) pe_col[tid] = ((n0 + tid) / bn) % cols;
  if (tid == 0) tc::init_barriers<G>(s);
  __syncthreads();
  if (tid >= G::WGS * tc::WG_THREADS) {
    if (tid == G::WGS * tc::WG_THREADS) tc::produce<W_K_MAJOR, G>(s, &mx, &mw, m0, n0, KT);
    return;
  }
  const int wg = tid / tc::WG_THREADS;
  float acc[tc::ACC];
  tc::consume<W_K_MAJOR, G>(s, wg, KT, acc);

  // drain: the stuck-at of each output's PE, straight from the registers,
  // stored with the streaming hint (nothing here reads them back)
  const int t = tid % tc::WG_THREADS, lane = t % 32;
  const int row0 = m0 + wg * tc::WG_M + (t / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const bool pairs = (N % 2) == 0;  // (m, n) and (m, n + 1) share an 8-byte store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + 8 * h;
    if (m >= M) continue;
    const int* ag = and_grid + ((m / bm) % rows) * cols;
    const int* og = or_grid + ((m / bm) % rows) * cols;
    float* o = out + (long long)m * N + n0;
#pragma unroll
    for (int j = 0; j < tc::TILE_N / 8; ++j) {
      const int c = 8 * j + c0;
      const int p0 = pe_col[c], p1 = pe_col[c + 1];
      const float v0 = stuck_at(acc[4 * j + 2 * h], __ldg(ag + p0), __ldg(og + p0));
      const float v1 = stuck_at(acc[4 * j + 2 * h + 1], __ldg(ag + p1), __ldg(og + p1));
      if (pairs && n0 + c + 1 < N) {
        __stcs(reinterpret_cast<float2*>(o + c), make_float2(v0, v1));
      } else {
        if (n0 + c < N) __stcs(o + c, v0);
        if (n0 + c + 1 < N) __stcs(o + c + 1, v1);
      }
    }
  }
}

int launch_tensor_cores(const void* x, const void* w, const int* ag, const int* og, float* out, int M,
                        int N, int K, long long sxm, long long sxk, long long swk, long long swn, int bm,
                        int bn, int rows, int cols, cudaStream_t stream) {
  const bool w_k_major = swk == 1 && swn != 1;
  CUtensorMap mx, mw;
  if (!tc::encode_operands(&mx, &mw, x, w, M, N, K, sxm, sxk, swk, swn, w_k_major))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + TILE_M - 1) / TILE_M, (N + tc::TILE_N - 1) / tc::TILE_N);
  auto kernel = w_k_major ? os_array_matmul_wgmma<true> : os_array_matmul_wgmma<false>;
  const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<grid, G::THREADS, G::SMEM_BYTES, stream>>>(mx, mw, ag, og, out, M, N, K, bm, bn, rows, cols);
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// Bytes of dynamic shared memory of the bf16 kernel: its ring of stages.
extern "C" long long os_array_matmul_dynamic_smem() { return static_cast<long long>(G::SMEM_BYTES); }

// x: (M, K) with strides (sxm, sxk); w: (K, N) with strides (swk, swn), both in
// elements and of one dtype: 0 float32, 1 bfloat16, 2 int8.  and_grid /
// or_grid: (rows, cols) int32, contiguous.  out: (M, N) float32, contiguous.
// (bm, bn): the fault-placement tile.  N / 128 must be at most 65535.  bf16
// operands need sxk == 1, w with swk == 1 or swn == 1, 16-byte aligned bases
// and the other strides multiples of 8 elements (TMA).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an unknown
// dtype or a bf16 layout TMA cannot describe).
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
    int rc = 0;
    if (dtype == 0)
      launch_cuda_cores<float>(x, w, ag, og, o, M, N, K, sxm, sxk, swk, swn, bm, bn, rows, cols, s);
    else if (dtype == 1)
      rc = launch_tensor_cores(x, w, ag, og, o, M, N, K, sxm, sxk, swk, swn, bm, bn, rows, cols, s);
    else if (dtype == 2)
      launch_cuda_cores<int8_t>(x, w, ag, og, o, M, N, K, sxm, sxk, swk, swn, bm, bn, rows, cols, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}
