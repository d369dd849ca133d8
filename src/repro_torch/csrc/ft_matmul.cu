// Fault-tolerant matmul for Hopper (sm_90a): out = epilogue(x @ w).
//
// Replaces the Pallas TPU kernels src/repro/kernels/ft_matmul.py::ft_matmul
// (body _kernel / _drain_tile) and ::ft_matmul_batched (body
// _kernel_batched).  It computes what they compute, at element granularity:
// a float32 accumulate of (M, K) @ (K, N), then the per-PE stuck-at /
// DPPU-repair / remap / prune epilogue applied to the f32 bit pattern of each
// output element out[i, j] -> PE(i % rows, j % cols):
//
//     out = int_as_float((float_as_int(acc) & and_grid[pe]) | or_grid[pe])
//
// with the AND/OR mask pair of repro_torch.core.engine.fault_mask_grids.
//
// The batched form, x (E, M, K) @ w (E, K, N) -> out (E, M, N) (the MoE
// expert matmuls), is the same kernel body with the expert on blockIdx.z and
// a per-expert stride for x and w: one launch for all experts.  Each expert's
// matmul is one virtual-array execution, so the PE map repeats per expert:
// out[e, i, j] -> PE(i % rows, j % cols), the expert never enters the row.
//
// What bounds it here: on the serving path M is the decode batch (4), so each
// call is a matrix-vector product that reads every weight once and does
// 2·M FLOPs per weight element: memory bandwidth, not the tensor cores.  The
// design therefore spends nothing on wgmma and keeps every weight read a
// single pass over device memory:
//   * one block owns a BM x BN = 4 x 32 output tile and walks the whole K
//     axis, so the fault epilogue sees finished sums and no reduction crosses
//     blocks (the sum is deterministic);
//   * K-panels of BK = 128 are staged in shared memory, x and w widened to
//     f32 on the way in (bf16 x bf16 products are exact in f32, so the bf16
//     path needs no f32 copy of any weight); the 8 warps split each panel's
//     K among them and reduce in a fixed order at the end;
//   * each thread loads its share of a panel into registers with all loads
//     issued together (one base pointer and one fixed step per operand), and
//     the next panel's loads are in flight while the current panel is summed
//     (register double buffering).  Still, a block waits one device-memory
//     round trip per panel: at small N too few blocks are in flight to hide
//     it, which is what bounds the kernel today;
//   * w has arbitrary strides.  The staging loop lays the 32 lanes along
//     whichever axis of w has unit stride, so both a row-major (K, N) weight
//     and the transposed view of the tied embedding table (the LM head) are
//     read coalesced, without a copy;
//   * the block's 4 x 32 slice of the two (rows, cols) mask grids sits in
//     shared memory; ragged edges are masked in the kernel, so the caller
//     pads nothing.
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 4;               // output rows per block (the decode batch)
constexpr int BN = 32;              // output columns per block, one per lane
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KW = 16;              // K values per warp per panel
constexpr int BK = WARPS * KW;      // K-panel depth staged in shared memory

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int X_PER_THREAD = BM * BK / THREADS;  // x-panel elements each thread stages
constexpr int W_PER_THREAD = BK * BN / THREADS;  // w-panel elements each thread stages
static_assert(THREADS % BK == 0 && THREADS % BN == 0, "staging steps must be whole rows");

// Staging geometry.  Thread t stages x-panel elements (t/BK + r*X_DI, t%BK):
// lanes along k.  Its w-panel elements are (kk0 + r*W_DKK, j0 + r*W_DJ) with
// the lanes along w's unit-stride axis (W_K_FAST: along k, as for the
// transposed LM-head table; else along n).  Every further element is one
// fixed step away, so a thread keeps one base pointer per operand.
constexpr int X_DI = THREADS / BK;

template <bool W_K_FAST>
struct WStaging {
  static constexpr int DKK = W_K_FAST ? 0 : THREADS / BN;
  static constexpr int DJ = W_K_FAST ? THREADS / BK : 0;
  static __device__ __forceinline__ int kk0() { return W_K_FAST ? threadIdx.x % BK : threadIdx.x / BN; }
  static __device__ __forceinline__ int j0() { return W_K_FAST ? threadIdx.x / BK : threadIdx.x % BN; }
};

// Global -> registers for the panel at k0.  All loads are issued before any
// is used, so they are in flight together.
template <bool W_K_FAST, typename XT, typename WT>
__device__ __forceinline__ void load_panel(
    const XT* __restrict__ x, const WT* __restrict__ w, int m0, int n0, int k0,
    int M, int N, int K, long long sxm, long long sxk, long long swk, long long swn,
    float (&xr)[X_PER_THREAD], float (&wr)[W_PER_THREAD]) {
  using S = WStaging<W_K_FAST>;
  const int xk = k0 + threadIdx.x % BK, xi = m0 + threadIdx.x / BK;
  const XT* px = x + (long long)xi * sxm + (long long)xk * sxk;
#pragma unroll
  for (int r = 0; r < X_PER_THREAD; ++r)
    xr[r] = (xi + r * X_DI < M && xk < K) ? widen(px[r * X_DI * sxm]) : 0.f;
  const int wk = k0 + S::kk0(), wn = n0 + S::j0();
  const WT* pw = w + (long long)wk * swk + (long long)wn * swn;
  const long long step = S::DKK * swk + S::DJ * swn;
#pragma unroll
  for (int r = 0; r < W_PER_THREAD; ++r)
    wr[r] = (wk + r * S::DKK < K && wn + r * S::DJ < N) ? widen(pw[r * step]) : 0.f;
}

// At most 64 registers, so 4 blocks fit an SM: the LM head's 4752 blocks need
// the occupancy more than a thread needs registers.
template <bool W_K_FAST, typename XT, typename WT>
__global__ void __launch_bounds__(THREADS, 4) ft_matmul_kernel(
    const XT* __restrict__ x, const WT* __restrict__ w,
    const int* __restrict__ and_grid, const int* __restrict__ or_grid,
    float* __restrict__ out, int M, int N, int K, long long sxe, long long sxm,
    long long sxk, long long swe, long long swk, long long swn, int rows, int cols) {
  using S = WStaging<W_K_FAST>;
  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][BN + 1];  // +1: conflict-free stores along k
  __shared__ float part[WARPS][BM][BN];
  __shared__ int and_s[BM][BN];
  __shared__ int or_s[BM][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  // this block's expert (0 for the plain matmul); rows restart at 0 per expert
  x += (long long)blockIdx.z * sxe;
  w += (long long)blockIdx.z * swe;
  out += (long long)blockIdx.z * M * N;

  if (tid < BM * BN) {
    const int i = tid / BN, j = tid % BN;
    const int pe = ((m0 + i) % rows) * cols + (n0 + j) % cols;
    and_s[i][j] = and_grid[pe];
    or_s[i][j] = or_grid[pe];
  }

  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  float xr[X_PER_THREAD], wr[W_PER_THREAD];
  load_panel<W_K_FAST>(x, w, m0, n0, 0, M, N, K, sxm, sxk, swk, swn, xr, wr);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < X_PER_THREAD; ++r) xs[tid / BK + r * X_DI][tid % BK] = xr[r];
#pragma unroll
    for (int r = 0; r < W_PER_THREAD; ++r) ws[S::kk0() + r * S::DKK][S::j0() + r * S::DJ] = wr[r];
    __syncthreads();
    // the next panel's loads fly while this panel is summed
    if (k0 + BK < K)
      load_panel<W_K_FAST>(x, w, m0, n0, k0 + BK, M, N, K, sxm, sxk, swk, swn, xr, wr);
#pragma unroll
    for (int t = 0; t < KW; ++t) {
      const int kk = warp * KW + t;
      const float wv = ws[kk][lane];
#pragma unroll
      for (int i = 0; i < BM; ++i) acc[i] = fmaf(xs[i][kk], wv, acc[i]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < BM; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();

  if (tid < BM * BN) {
    const int i = tid / BN, j = tid % BN;
    float s = part[0][i][j];
#pragma unroll
    for (int q = 1; q < WARPS; ++q) s += part[q][i][j];
    const int m = m0 + i, n = n0 + j;
    if (m < M && n < N) {
      const int raw = __float_as_int(s);
      out[(long long)m * N + n] = __int_as_float((raw & and_s[i][j]) | or_s[i][j]);
    }
  }
}

template <typename XT, typename WT>
void launch(const void* x, const void* w, const int* and_grid, const int* or_grid,
            float* out, int E, int M, int N, int K, long long sxe, long long sxm,
            long long sxk, long long swe, long long swk, long long swn, int rows,
            int cols, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  const XT* xp = static_cast<const XT*>(x);
  const WT* wp = static_cast<const WT*>(w);
  if (swk == 1 && swn != 1)
    ft_matmul_kernel<true, XT, WT><<<grid, THREADS, 0, stream>>>(
        xp, wp, and_grid, or_grid, out, M, N, K, sxe, sxm, sxk, swe, swk, swn, rows, cols);
  else
    ft_matmul_kernel<false, XT, WT><<<grid, THREADS, 0, stream>>>(
        xp, wp, and_grid, or_grid, out, M, N, K, sxe, sxm, sxk, swe, swk, swn, rows, cols);
}

int dispatch(const void* x, const void* w, const void* and_grid, const void* or_grid,
             void* out, int E, int M, int N, int K, long long sxe, long long sxm,
             long long sxk, long long swe, long long swk, long long swn, int x_bf16,
             int w_bf16, int rows, int cols, void* stream) {
  if (E > 0 && M > 0 && N > 0) {
    const int* ag = static_cast<const int*>(and_grid);
    const int* og = static_cast<const int*>(or_grid);
    float* o = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_bf16 && w_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(x, w, ag, og, o, E, M, N, K, sxe, sxm, sxk, swe, swk, swn, rows, cols, s);
    else if (x_bf16)
      launch<__nv_bfloat16, float>(x, w, ag, og, o, E, M, N, K, sxe, sxm, sxk, swe, swk, swn, rows, cols, s);
    else if (w_bf16)
      launch<float, __nv_bfloat16>(x, w, ag, og, o, E, M, N, K, sxe, sxm, sxk, swe, swk, swn, rows, cols, s);
    else
      launch<float, float>(x, w, ag, og, o, E, M, N, K, sxe, sxm, sxk, swe, swk, swn, rows, cols, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (M, K) with strides (sxm, sxk); w: (K, N) with strides (swk, swn), both in
// elements; x_bf16 / w_bf16 select bfloat16 (1) or float32 (0).  and_grid /
// or_grid: (rows, cols) int32, contiguous.  out: (M, N) float32, contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int ft_matmul_launch(const void* x, const void* w, const void* and_grid,
                                const void* or_grid, void* out, int M, int N, int K,
                                long long sxm, long long sxk, long long swk, long long swn,
                                int x_bf16, int w_bf16, int rows, int cols, void* stream) {
  return dispatch(x, w, and_grid, or_grid, out, 1, M, N, K, 0, sxm, sxk, 0, swk, swn,
                  x_bf16, w_bf16, rows, cols, stream);
}

// The batched form: x (E, M, K) with strides (sxe, sxm, sxk); w (E, K, N) with
// strides (swe, swk, swn); out (E, M, N) float32, contiguous.  E <= 65535.
extern "C" int ft_matmul_batched_launch(const void* x, const void* w, const void* and_grid,
                                        const void* or_grid, void* out, int E, int M, int N,
                                        int K, long long sxe, long long sxm, long long sxk,
                                        long long swe, long long swk, long long swn,
                                        int x_bf16, int w_bf16, int rows, int cols,
                                        void* stream) {
  return dispatch(x, w, and_grid, or_grid, out, E, M, N, K, sxe, sxm, sxk, swe, swk, swn,
                  x_bf16, w_bf16, rows, cols, stream);
}
