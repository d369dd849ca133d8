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
// its index maps; here each block loads its own entry and aims its loads
// there).  Padded entries (-1) are clamped to tile (0, 0), as the TPU kernel
// clamps them, and so return tile (0, 0).
//
// A recomputed tile equals os_array_matmul.cu's fault-free output bit for bit
// on any operands, because both run one main loop, chosen by dtype alone:
//   - bf16: array_tile_wgmma.cuh.  The grid is (FPT entry, 64-row piece,
//     128-column piece): each block computes one array-aligned 64 x 128 piece
//     that overlaps its tile (the piece pass 1 computes there, with the same
//     TMA boxes, instruction shape and K order) and stores the overlap.  At
//     bm = bn = 128 that is two pieces a tile, each wholly inside it.  One
//     consumer warpgroup and one producer warp a block, a ring of 4 stages.
//   - f32 and int8: array_tile.cuh, one 128 x 128 block piece of the tile.
//
// What bounds it: each tile does 2*bm*bn*K operations on (bm + bn)*K
// operands.  At the pipeline's 24 tiles the whole call reads 8-20 MB for
// 0.8-2.3 GFLOP, so bytes bound it; what the design does about that is to
// spread the tiles over many SMs (48 blocks at 24 tiles of 128, where one
// block a tile filled 24 of 132) and to keep the loads in flight with TMA.
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>

#include <numeric>

#include "array_tile.cuh"
#include "array_tile_wgmma.cuh"

namespace {

// --------------------------------------------------- f32 and int8: CUDA cores
template <bool W_K_FAST, typename T>
__global__ void __launch_bounds__(array_tile::THREADS) dppu_recompute_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ fpt,
    float* __restrict__ out, int K, long long sxm, long long sxk, long long swk,
    long long swn, int bm, int bn) {
  using namespace array_tile;
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
void launch_cuda_cores(const void* x, const void* w, const int* fpt, float* out, int F, int K,
                       long long sxm, long long sxk, long long swk, long long swn, int bm, int bn,
                       cudaStream_t stream) {
  using namespace array_tile;
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

// ------------------------------------------------------ bf16: tensor cores
namespace tc = array_tile_wgmma;
using G = tc::Geometry<1, 4>;  // one 64 x 128 piece a block, a ring of 4 stages

template <bool W_K_MAJOR>
__global__ void __launch_bounds__(G::THREADS) dppu_recompute_wgmma(
    const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
    const int* __restrict__ fpt, float* __restrict__ out, int K, int bm, int bn) {
  const int f = blockIdx.x;
  const int r_lo = max(fpt[2 * f], 0) * bm, c_lo = max(fpt[2 * f + 1], 0) * bn;  // the tile
  // the array-aligned piece of this block: the blockIdx.y-th and
  // blockIdx.z-th of those that overlap the tile, or none (exit)
  const int m0 = (r_lo / tc::WG_M + (int)blockIdx.y) * tc::WG_M;
  const int n0 = (c_lo / tc::TILE_N + (int)blockIdx.z) * tc::TILE_N;
  if (m0 >= r_lo + bm || n0 >= c_lo + bn) return;

  extern __shared__ uint8_t smem_raw[];
  auto& s = tc::aligned_smem<G>(smem_raw);
  const int KT = (K + tc::STAGE_K - 1) / tc::STAGE_K;
  const int tid = threadIdx.x;
  if (tid == 0) tc::init_barriers<G>(s);
  __syncthreads();
  if (tid >= tc::WG_THREADS) {
    if (tid == tc::WG_THREADS) tc::produce<W_K_MAJOR, G>(s, &mx, &mw, m0, n0, KT);
    return;
  }
  float acc[tc::ACC];
  tc::consume<W_K_MAJOR, G>(s, 0, KT, acc);

  // store the piece's overlap with the tile into out[f]
  const int lane = tid % 32;
  const int row0 = m0 + (tid / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const bool pairs = (bn % 2) == 0;  // then c_lo and every tile row start are even
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + 8 * h;
    if (m < r_lo || m >= r_lo + bm) continue;
    float* o = out + ((long long)f * bm + (m - r_lo)) * bn - c_lo;  // o[n] holds column n
#pragma unroll
    for (int j = 0; j < tc::TILE_N / 8; ++j) {
      const int n = n0 + 8 * j + c0;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      const bool in0 = n >= c_lo && n < c_lo + bn, in1 = n + 1 >= c_lo && n + 1 < c_lo + bn;
      if (pairs && in0 && in1) {
        *reinterpret_cast<float2*>(o + n) = make_float2(v0, v1);
      } else {
        if (in0) o[n] = v0;
        if (in1) o[n + 1] = v1;
      }
    }
  }
}

// The most array-aligned pieces of size `piece` that a tile of size `b`
// starting at a multiple of b can overlap: its start lies at a multiple of
// gcd(b, piece) modulo the piece.
int max_pieces(int b, int piece) {
  const int worst_offset = piece - std::gcd(b, piece);
  return (worst_offset + b - 1) / piece + 1;
}

int launch_tensor_cores(const void* x, const void* w, const int* fpt, float* out, int F, int M, int N,
                        int K, long long sxm, long long sxk, long long swk, long long swn, int bm, int bn,
                        cudaStream_t stream) {
  const bool w_k_major = swk == 1 && swn != 1;
  CUtensorMap mx, mw;
  if (!tc::encode_operands(&mx, &mw, x, w, M, N, K, sxm, sxk, swk, swn, w_k_major))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(F, max_pieces(bm, tc::WG_M), max_pieces(bn, tc::TILE_N));
  auto kernel = w_k_major ? dppu_recompute_wgmma<true> : dppu_recompute_wgmma<false>;
  const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<grid, G::THREADS, G::SMEM_BYTES, stream>>>(mx, mw, fpt, out, K, bm, bn);
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// Bytes of dynamic shared memory of the bf16 kernel: its ring of stages.
extern "C" long long dppu_recompute_dynamic_smem() { return static_cast<long long>(G::SMEM_BYTES); }

// x: (M, K) with strides (sxm, sxk); w: (K, N) with strides (swk, swn), both in
// elements and of one dtype: 0 float32, 1 bfloat16, 2 int8.  fpt: (F, 2) int32,
// contiguous, every entry a tile inside (M / bm, N / bn) or -1 padding.
// out: (F, bm, bn) float32, contiguous.  bm / 64 + 2 and bn / 128 + 2 must be
// at most 65535.  bf16 operands need the layouts os_array_matmul_launch
// names.  Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for an unknown dtype or a bf16 layout TMA cannot describe).
extern "C" int dppu_recompute_launch(const void* x, const void* w, const void* fpt, void* out,
                                     int F, int M, int N, int K, long long sxm, long long sxk,
                                     long long swk, long long swn, int dtype, int bm, int bn,
                                     void* stream) {
  if (F > 0 && bm > 0 && bn > 0) {
    const int* t = static_cast<const int*>(fpt);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int rc = 0;
    if (dtype == 0)
      launch_cuda_cores<float>(x, w, t, o, F, K, sxm, sxk, swk, swn, bm, bn, s);
    else if (dtype == 1)
      rc = launch_tensor_cores(x, w, t, o, F, M, N, K, sxm, sxk, swk, swn, bm, bn, s);
    else if (dtype == 2)
      launch_cuda_cores<int8_t>(x, w, t, o, F, K, sxm, sxk, swk, swn, bm, bn, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}
