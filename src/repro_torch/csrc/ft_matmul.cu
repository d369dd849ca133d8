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
// with the AND/OR mask pair of repro_torch.core.engine.fault_mask_grids,
// stored as float32 or, rounded with __float2bfloat16_rn after the epilogue,
// as bfloat16 (the serving path's working dtype, so no cast follows).
//
// The batched form, x (E, M, K) @ w (E, K, N) -> out (E, M, N) (the MoE
// expert matmuls), is the same kernels with the expert on blockIdx.z and a
// per-expert stride for x and w: one launch for all experts.  Each expert's
// matmul is one virtual-array execution, so the PE map repeats per expert:
// out[e, i, j] -> PE(i % rows, j % cols), the expert never enters the row.
//
// What bounds it: on the serving path M is the decode batch (4), so a call
// is a matrix-vector product that reads every weight once and does 2*M FLOPs
// per weight element: device-memory bytes.  A byte-bound kernel needs bytes
// in flight (Little's law: 3.35 TB/s times ~1 us of loaded latency, about
// 25 KB an SM) and a short chain of dependent round trips; at 1-6 MB a call
// the chain (launch, one round trip, the reduction) is most of the time.
// The design, one launch per call, no workspace, no atomics:
//   * the strip kernels split K across a thread-block cluster.  A block owns
//     a strip of STRIP = 64 output columns of a 4-row tile and 1/S of K; the
//     S blocks of one strip are a cluster along grid x (S <= 8, the portable
//     size).  The ranks other than 0 store their 4 x 64 partials into rank
//     0's shared memory (distributed shared memory) and arrive at the
//     cluster barrier; rank 0 adds them in rank order, applies the epilogue
//     and stores.  S comes from the caller (repro_torch.kernels.ft_matmul.
//     ft_plan), a fixed function of (E, M, N, K, dtype, layout): never of
//     the SM count or the masks, so the sum order is the same on every run
//     and every card, and "off" and "protected" (the same kernel with other
//     masks) stay bitwise equal.  At qwen's 1024->1024 that is 16 strips x 4
//     ranks, each rank's 256 K-rows x 64 columns (32 KB) in flight at once;
//   * w arrives by 16-byte cp.async copies along its unit-stride axis N into
//     a ring of stages in shared memory, 32 KB a block in flight, so the
//     bytes in flight hold no registers;
//   * bf16 x bf16 runs on the tensor cores (mma.sync m16n8k16, f32
//     accumulate; x is the A operand, its 4 rows padded to 16 with zeros; w's
//     k16 x n8 tiles come from the ring through ldmatrix.trans).  On the CUDA
//     cores (4 f32 FMAs and a widening per weight) the expert matmuls run
//     1.3x torch.bmm, on the tensor cores about 1.07x: the instructions, not the
//     bytes, were their cost (tools/ft_matmul_sweep.py, PERF.md).  A bf16 x
//     bf16 product is exact in f32 and
//     every partial sum of small-integer operands is exact, so on those the
//     result is bitwise the plain version's; on random operands the sum
//     order is the tensor core's, fixed by the code and the hardware;
//   * f32 or mixed operands take the same strip kernel on the CUDA cores
//     (f32 on the tensor cores would be TF32): each thread owns 8 bf16 or 4
//     f32 adjacent columns and its own cells of the ring (no barrier), then
//     the warps' partials are added in warp order;
//   * the LM head reads the tied table through its transposed view (strides
//     (1, K)), so its unit-stride axis is K: the "K-fast" kernel gives each
//     warp 4 whole output columns and walks each contiguous table row with
//     one 16-byte load a lane a step, the next step's loads in flight; x
//     (4 x K, widened to f32) sits in shared memory once a block, permuted so
//     that the lanes of a warp read consecutive float4s; a fixed-order
//     __shfl_xor_sync butterfly finishes each column.  152064 or 49408
//     columns fill the card without a split, and its f32 FMAs (1.2 GFLOP at
//     qwen's head) hide under its 311 MB of loads;
//   * a layout that 16-byte loads cannot read (a base pointer or row pitch
//     that is not 16-byte aligned, a width that is not a whole number of
//     vectors, or strides that are neither of the two above) takes the
//     CUDA-core strip kernel with one scalar load a thread a K-row, through
//     w's strides: the same split, the same reduction order;
//   * every sum has one order fixed by the code: within a thread or an mma
//     in sequence, a warp's rows by a shuffle butterfly, the warps' partials
//     in warp order, the ranks' in rank order.  The same call gives the same
//     bits every time;
//   * ragged N, ragged K inside a rank's slice and ragged M are masked in the
//     loads (zero-filled copies) and in the store, so the caller pads
//     nothing; the mask grids are read in the epilogue;
//   * at prefill M is every token of the batch (8192 rows, or 960-2048 rows
//     an expert), and a call does 2 * M FLOPs per weight element: the tensor
//     cores bound it, and a 4-row block that restreams w per 4 rows runs at
//     about 2% of that bound.  From M_TILE rows an expert on (the plan's
//     choice), bf16 x bf16 takes the tile kernel below: 128 x 128 output
//     tiles on wgmma, fed by TMA, K unsplit.
// The kernels allocate nothing and launch on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "array_tile_wgmma.cuh"

namespace {

constexpr int BM = 4;                     // output rows per block (the decode batch)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STRIP = 64;                 // strip kernels: output columns per block
constexpr int MAX_SPLIT = 8;              // portable cluster size
constexpr int KF_COLS = 4;                // K-fast kernel: output columns per warp
constexpr int KF_BLOCK_COLS = WARPS * KF_COLS;
constexpr int KF_MAX_SMEM = 48 * 1024;    // K-fast: x's padded (K, 4) f32 copy

enum Layout { N_FAST = 0, K_FAST = 1, SCALAR = 2 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// element v of 16 bytes of w, as float: 8 bf16 (a bf16 is the high half of
// its f32) or 4 f32.  v is a compile-time constant after unrolling, so this
// is one shift or mask, and the 16 bytes stay packed in 4 registers.
template <typename WT>
__device__ __forceinline__ float elem(const uint4& r, int v) {
  constexpr int PER = 4 / sizeof(WT);  // elements per 32-bit word
  const int q = v / PER;
  const uint32_t u = q == 0 ? r.x : q == 1 ? r.y : q == 2 ? r.z : r.w;
  if constexpr (PER == 2) return __uint_as_float((v & 1) ? (u & 0xffff0000u) : (u << 16));
  return __uint_as_float(u);
}
template <typename WT>
__device__ __forceinline__ float elem(float r, int) { return r; }

__device__ __forceinline__ void store_out(void* out, long long o, float acc, int and_m, int or_m,
                                          int out_bf16) {
  const float v = __int_as_float((__float_as_int(acc) & and_m) | or_m);
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[o] = v;
}

// ----------------------------------------------------------- strip kernels
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// 16 bytes global -> shared, or 16 zero bytes (nothing read) when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// The cross-rank sum of the strip kernels.  Rank 0's `gather` receives the
// partials of ranks 1..split-1; its mbarrier `bar` completes once all of
// their bytes have landed.
struct ClusterSum {
  float* gather;  // [split - 1][BM * STRIP], in rank 0
  uint64_t* bar;

  // At kernel start, by every thread: rank 0 arms its mbarrier for the
  // bytes the other ranks will send, and every rank arrives at the cluster
  // barrier (its shared memory exists from here on).
  __device__ __forceinline__ void start(int split, int rank) const {
    if (split == 1) return;
    if (rank == 0 && threadIdx.x == 0) {
      const uint32_t b = smem_addr(bar);
      const uint32_t bytes = (split - 1) * BM * STRIP * (uint32_t)sizeof(float);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (rank == 0) __syncthreads();  // rank 0's own threads wait on the mbarrier too
    cluster_arrive_relaxed();
  }

  // A rank other than 0, once every rank has started (begin_send): store
  // value v of tile output idx into rank 0's gather, completing its bytes on
  // rank 0's mbarrier.
  __device__ __forceinline__ void begin_send() const { cluster_wait(); }
  __device__ __forceinline__ void send(int rank, int idx, float v) const {
    const uint32_t dst = remote(gather + (rank - 1) * BM * STRIP + idx), b = remote(bar);
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
                 ::"r"(dst), "r"(__float_as_uint(v)), "r"(b) : "memory");
  }

  // Rank 0: wait until every other rank's partials have landed.  A bounded
  // wait: a kernel that never receives them traps instead of hanging.
  __device__ __forceinline__ void receive() const {
    const uint32_t b = smem_addr(bar);
    for (long long tries = 0;; ++tries) {
      uint32_t done;
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(b)
          : "memory");
      if (done) return;
      if (tries > (1ll << 24)) __trap();
    }
  }

  // rank 0's copy of a local shared-memory address
  static __device__ __forceinline__ uint32_t remote(const void* local) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(r) : "r"(smem_addr(local)));
    return r;
  }
};

// The end of both strip kernels.  Each thread holds NV partial sums `own` of
// this rank's K-slice, for outputs idx[q] of the BM x STRIP tile (row-major),
// or none (!live); the live threads of a block hold each output once.  With
// split > 1 the ranks other than 0 send theirs into rank 0's shared memory
// (st.async through distributed shared memory, counted on rank 0's
// mbarrier) and leave; rank 0 waits for the bytes, adds the partials in
// rank order, applies the epilogue and stores.  No barrier across the
// cluster on the reduction's path and no remote reads.
template <int NV>
__device__ __forceinline__ void finish(float (&own)[NV], const int (&idx)[NV], bool live, const ClusterSum& cs,
                                       int split, int rank, int e, int m0, int n0, int M, int N,
                                       const int* and_grid, const int* or_grid, int rows, int cols,
                                       void* out, int out_bf16) {
  constexpr int TILE = BM * STRIP;
  if (split > 1) {
    if (rank > 0) {
      cs.begin_send();
      if (live) {
#pragma unroll
        for (int q = 0; q < NV; ++q) cs.send(rank, idx[q], own[q]);
      }
      return;
    }
    cs.receive();
    if (live) {
      for (int r = 1; r < split; ++r) {  // rank order
#pragma unroll
        for (int q = 0; q < NV; ++q) own[q] += cs.gather[(r - 1) * TILE + idx[q]];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int m = m0 + idx[q] / STRIP, n = n0 + idx[q] % STRIP;
      if (m < M && n < N) {
        const int pe = (m % rows) * cols + n % cols;
        store_out(out, ((long long)e * M + m) * N + n, own[q], and_grid[pe], or_grid[pe], out_bf16);
      }
    }
  }
}

// The K-slice of rank `rank` of `split`, and the number of groups of gk rows
// that cover it.
struct Slice {
  int kbeg, kend, groups;
  __device__ Slice(int K, int split, int rank, int gk) {
    const int kslice = (K + split - 1) / split;
    kbeg = min(K, rank * kslice);
    kend = min(K, kbeg + kslice);
    groups = (kend - kbeg + gk - 1) / gk;
  }
};

// --- the CUDA-core strip kernel: f32 or mixed operands, and the scalar layout
// VEC = 16 / sizeof(WT) for the 16-byte (N-fast) instantiation, 1 for the
// scalar one.  Thread t owns columns n0 + (t % TPR) * VEC .. + VEC and K-rows
// t / TPR + u * RPP (u < LOADS) of each group.  Its cells of w sit in a ring
// of STAGES groups in shared memory that only it writes and reads, so the
// ring needs no barrier: STAGES - 1 groups are in flight without holding a
// register.
template <typename WT, int VEC>
struct Strip {
  static constexpr int TPR = STRIP / VEC;                    // threads along one K-row
  static constexpr int RPP = THREADS / TPR;                  // K-rows of one pass of the block
  static constexpr int LOADS = VEC == 1 ? 8 : 2;             // cells of w a thread a group
  static constexpr int GK = LOADS * RPP;                     // K-rows a group
  static constexpr int STAGES = 6;                           // the ring
  static constexpr int XP = 512;                             // K-rows of x staged at once
  static constexpr int LPW = TPR < 32 ? 32 / TPR : 1;        // K-rows within one warp
  static constexpr int SLOTS = RPP / LPW;                    // partials after the warp butterfly
  static constexpr int OUTS = BM * STRIP / THREADS;          // outputs a thread finishes
  using Cell = std::conditional_t<VEC == 1, float, uint4>;   // one load of w (scalar: widened)
  static constexpr int RING_BYTES = STAGES * LOADS * THREADS * (int)sizeof(Cell);
  static constexpr int X_BYTES = XP * (int)sizeof(float4);
  static constexpr int SMEM = RING_BYTES + X_BYTES + (MAX_SPLIT - 1) * BM * STRIP * (int)sizeof(float);
  static_assert(STRIP % VEC == 0 && THREADS % TPR == 0 && BM * STRIP % THREADS == 0, "strip geometry");
  static_assert(XP % GK == 0 && XP * BM % THREADS == 0 && SLOTS * BM * STRIP * (int)sizeof(float) <= RING_BYTES,
                "strip buffers");
};

template <typename XT, typename WT, int VEC>
__global__ void __launch_bounds__(THREADS, 3) ft_strip_kernel(
    const XT* __restrict__ x, const WT* __restrict__ w, const int* __restrict__ and_grid,
    const int* __restrict__ or_grid, void* __restrict__ out, int M, int N, int K, int split,
    long long sxe, long long sxm, long long sxk, long long swe, long long swk, long long swn,
    int rows, int cols, int out_bf16) {
  using G = Strip<WT, VEC>;
  using Cell = typename G::Cell;
  extern __shared__ __align__(16) unsigned char smem[];
  Cell* ring = reinterpret_cast<Cell*>(smem);                                 // [STAGES][LOADS][THREADS]
  float4* xs = reinterpret_cast<float4*>(smem + G::RING_BYTES);               // [XP]: (k, row)
  __shared__ uint64_t bar;
  const ClusterSum cs{reinterpret_cast<float*>(smem + G::RING_BYTES + G::X_BYTES), &bar};

  const int tid = threadIdx.x;
  const int rank = blockIdx.x % split;  // == cluster.block_rank(): clusters are (split, 1, 1)
  const int n0 = (blockIdx.x / split) * STRIP;
  const int m0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  cs.start(split, rank);
  const Slice sl(K, split, rank, G::GK);
  const int cv = tid % G::TPR, kr = tid / G::TPR;
  const int n = n0 + cv * VEC;
  const bool n_ok = n < N;  // the 16-byte layouts have N % VEC == 0
  x += (long long)e * sxe;
  const WT* pw = w + (long long)e * swe + (long long)(n_ok ? n : 0) * swn;

  // group g's cells into its slot: zeros past the slice or the edge
  auto issue = [&](int g) {
    if (g < sl.groups) {
      Cell* slot = ring + (g % G::STAGES) * G::LOADS * THREADS + tid;
#pragma unroll
      for (int u = 0; u < G::LOADS; ++u) {
        const int k = sl.kbeg + g * G::GK + kr + u * G::RPP;
        const bool ok = n_ok && k < sl.kend;
        const WT* src = pw + (ok ? (long long)k * swk : 0);
        if constexpr (VEC == 1)
          slot[u * THREADS] = ok ? widen(*src) : 0.f;
        else
          cp_async16(smem_addr(slot + u * THREADS), src, ok);
      }
    }
    cp_async_commit();  // one group per call, empty or not, so the count stays uniform
  };
#pragma unroll
  for (int g = 0; g < G::STAGES - 1; ++g) issue(g);

  float acc[BM][VEC];
#pragma unroll
  for (int i = 0; i < BM; ++i)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[i][v] = 0.f;

  for (int g = 0; g < sl.groups; ++g) {
    const int kl = (g * G::GK) % G::XP;  // this group's first row within its x piece
    if (kl == 0) {  // the next XP rows of x, widened to f32, while the ring fills
      __syncthreads();
#pragma unroll
      for (int r = 0; r < G::XP * BM / THREADS; ++r) {
        const int f = tid + r * THREADS, kk = f % G::XP, i = f / G::XP;
        const int k = sl.kbeg + g * G::GK + kk, m = m0 + i;
        reinterpret_cast<float*>(xs + kk)[i] =
            (m < M && k < sl.kend) ? widen(x[(long long)m * sxm + (long long)k * sxk]) : 0.f;
      }
      __syncthreads();
    }
    cp_async_wait<G::STAGES - 2>();  // this thread's cells of group g have landed
    issue(g + G::STAGES - 1);        // into the slot this thread emptied last iteration
    const Cell* slot = ring + (g % G::STAGES) * G::LOADS * THREADS + tid;
#pragma unroll
    for (int u = 0; u < G::LOADS; ++u) {
      const Cell c = slot[u * THREADS];
      const float4 xv = xs[kl + kr + u * G::RPP];
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float wv = elem<WT>(c, v);
        acc[0][v] = fmaf(xv.x, wv, acc[0][v]);
        acc[1][v] = fmaf(xv.y, wv, acc[1][v]);
        acc[2][v] = fmaf(xv.z, wv, acc[2][v]);
        acc[3][v] = fmaf(xv.w, wv, acc[3][v]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring: the partials reuse it

  // the LPW K-rows of a warp that share a column: a fixed butterfly
#pragma unroll
  for (int off = G::TPR; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < BM; ++i)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[i][v] += __shfl_xor_sync(0xffffffffu, acc[i][v], off);
  float(*part)[BM][STRIP] = reinterpret_cast<float(*)[BM][STRIP]>(smem);  // [SLOTS][BM][STRIP]
  if (kr % G::LPW == 0) {
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int v = 0; v < VEC; v += 4)
          *reinterpret_cast<float4*>(&part[kr / G::LPW][i][cv * VEC + v]) =
              make_float4(acc[i][v], acc[i][v + 1], acc[i][v + 2], acc[i][v + 3]);
      } else {
        part[kr / G::LPW][i][cv] = acc[i][0];
      }
    }
  }
  __syncthreads();
  // the warps' partials in warp order: thread tid owns outputs tid + q * THREADS
  float own[G::OUTS];
  int idx[G::OUTS];
#pragma unroll
  for (int q = 0; q < G::OUTS; ++q) {
    idx[q] = tid + q * THREADS;
    const int i = idx[q] / STRIP, j = idx[q] % STRIP;
    own[q] = part[0][i][j];
#pragma unroll
    for (int s = 1; s < G::SLOTS; ++s) own[q] += part[s][i][j];
  }
  finish(own, idx, true, cs, split, rank, e, m0, n0, M, N, and_grid, or_grid, rows, cols, out, out_bf16);
}

// --- the tensor-core strip kernel: bf16 x bf16, N-fast
// mma.sync m16n8k16 (bf16 in, f32 accumulate): A is x, its 4 rows padded to
// 16 with zeros; B is a k16 x n8 tile of w, read from the ring with
// ldmatrix.trans.  Warp q owns the strip's n8 tiles q, q + WARPS, ..., so a
// warp's accumulator is its columns' finished sum over the rank's slice: no
// reduction across warps.  The ring holds STAGES stages of GK = 128 K-rows
// (16 KB), each copied by all threads (four 16-byte cells each) with
// cp.async; one __syncthreads a stage publishes it.
struct MmaStrip {
  static constexpr int NT = STRIP / 8 / WARPS;             // n8 tiles a warp
  static constexpr int CELLS = 4;                          // 16-byte cells a thread a stage
  static constexpr int GK = CELLS * THREADS * 8 / STRIP;   // K-rows a stage
  static constexpr int PITCH = (STRIP + 8) * 2;            // bytes a ring row: the 8 rows of an ldmatrix
                                                           // fall in 8 distinct 16-byte bank groups
  static constexpr int STAGES = 3;                         // two stages (32 KB) in flight
  static constexpr int STAGE_BYTES = GK * PITCH;
  static constexpr int XP = 512;                           // K-rows of x staged at once
  static constexpr int XPITCH = XP / 2 + 4;                // 32-bit words a row of x (bf16 pairs), padded
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int X_BYTES = BM * XPITCH * 4;
  static constexpr int SMEM = RING_BYTES + X_BYTES + (MAX_SPLIT - 1) * BM * STRIP * (int)sizeof(float);
  static_assert(NT >= 1 && GK % 16 == 0 && XP % GK == 0 && STRIP / 8 * GK == CELLS * THREADS, "mma strip geometry");
  static_assert(BM * XP / 2 % THREADS == 0 && STAGE_BYTES % 16 == 0, "mma strip buffers");
};

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr)
               : "memory");
}
// d += A (rows 0-7 in a0/a2, rows 8-15 zero) * B
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS, 3) ft_strip_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w, const int* __restrict__ and_grid,
    const int* __restrict__ or_grid, void* __restrict__ out, int M, int N, int K, int split, long long sxe,
    long long sxm, long long sxk, long long swe, long long swk, int rows, int cols, int out_bf16) {
  using G = MmaStrip;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem + G::RING_BYTES);             // [BM][XPITCH]
  __shared__ uint64_t bar;
  const ClusterSum cs{reinterpret_cast<float*>(smem + G::RING_BYTES + G::X_BYTES), &bar};
  const uint32_t ring = smem_addr(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;  // the mma fragments' row group and thread in group
  const int rank = blockIdx.x % split;
  const int n0 = (blockIdx.x / split) * STRIP;
  const int m0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  cs.start(split, rank);
  const Slice sl(K, split, rank, G::GK);
  x += (long long)e * sxe;
  w += (long long)e * swe;

  auto issue = [&](int g) {
    if (g < sl.groups) {
      const uint32_t stage = ring + (g % G::STAGES) * G::STAGE_BYTES;
#pragma unroll
      for (int c = 0; c < G::CELLS; ++c) {
        const int cell = tid + c * THREADS, row = cell / (STRIP / 8), ch = cell % (STRIP / 8);
        const int k = sl.kbeg + g * G::GK + row, n = n0 + ch * 8;
        const bool ok = k < sl.kend && n < N;
        cp_async16(stage + row * G::PITCH + ch * 16, w + (ok ? (long long)k * swk + n : 0), ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < G::STAGES - 1; ++g) issue(g);

  float d[G::NT][4];
#pragma unroll
  for (int t = 0; t < G::NT; ++t) d[t][0] = d[t][1] = d[t][2] = d[t][3] = 0.f;

  for (int g = 0; g < sl.groups; ++g) {
    const int kl = (g * G::GK) % G::XP;
    if (kl == 0) {  // the next XP rows of x as bf16 pairs along k, while the ring fills
      __syncthreads();  // every warp is done with the previous piece
#pragma unroll
      for (int r = 0; r < BM * G::XP / 2 / THREADS; ++r) {
        const int f = tid + r * THREADS, p = f % (G::XP / 2), i = f / (G::XP / 2);
        const int k = sl.kbeg + g * G::GK + 2 * p, m = m0 + i;
        const __nv_bfloat16* px = x + (long long)m * sxm + (long long)k * sxk;
        const uint32_t lo = (m < M && k < sl.kend) ? __bfloat16_as_ushort(px[0]) : 0u;
        const uint32_t hi = (m < M && k + 1 < sl.kend) ? __bfloat16_as_ushort(px[sxk]) : 0u;
        xs[i * G::XPITCH + p] = lo | (hi << 16);
      }
    }
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();                // stage g (and a new x piece) is visible to every warp
    issue(g + G::STAGES - 1);       // into the slot every warp finished reading last iteration
    const uint32_t stage = ring + (g % G::STAGES) * G::STAGE_BYTES;
#pragma unroll
    for (int ks = 0; ks < G::GK; ks += 16) {
      uint32_t a0 = 0u, a2 = 0u;
      if (grp < BM) {
        a0 = xs[grp * G::XPITCH + (kl + ks) / 2 + tig];
        a2 = xs[grp * G::XPITCH + (kl + ks + 8) / 2 + tig];
      }
#pragma unroll
      for (int t = 0; t < G::NT; ++t) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, stage + (ks + (lane & 15)) * G::PITCH + (warp + t * WARPS) * 16);
        mma_bf16(d[t], a0, a2, b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // d[t][0..1] is output (row grp, columns 2 tig, 2 tig + 1) of tile t
  float own[2 * G::NT];
  int idx[2 * G::NT];
#pragma unroll
  for (int t = 0; t < G::NT; ++t) {
    own[2 * t] = d[t][0];
    own[2 * t + 1] = d[t][1];
    idx[2 * t] = grp * STRIP + (warp + t * WARPS) * 8 + 2 * tig;
    idx[2 * t + 1] = idx[2 * t] + 1;
  }
  finish(own, idx, grp < BM, cs, split, rank, e, m0, n0, M, N, and_grid, or_grid, rows, cols, out, out_bf16);
}

// ------------------------------------------------------------- tile kernel
// bf16 x bf16 at prefill row counts (the plan's tile plan: bn = TILE_N), on
// array_tile_wgmma.cuh's main loop: a block computes a TILE_M x TILE_N tile of
// one expert's output with two consumer warpgroups on wgmma m64n128k16 (f32
// accumulators in registers) and one producer warp keeping TMA loads in
// flight into a ring of 128-byte-swizzled stages.  K is walked from 0 upward
// in STAGE_K stages, never split, with no atomics: a call gives the same bits
// every time.  x and w are read through 3-D tensor maps over (E, M, K) and
// (E, K, N), so a ragged edge of M, N or K is zero-filled within its own
// expert.  The epilogue is the strip kernels' on each accumulator, from the
// registers, with the mask grids staged in shared memory once a block.
//
// The name: the benchmark finds these launches by kernel name
// (hyca_bench/harness/trace.py::FT_KERNELS) and grid z, so the tile kernel is
// an overload of ft_strip_mma_kernel, told apart by its template arguments.
namespace tc = array_tile_wgmma;
using TileG = tc::Geometry<2, 3>;  // a 96 KB ring of 3 stages
constexpr int TILE_M = TileG::WGS * tc::WG_M;  // 128 output rows a block
constexpr int TILE_N = tc::TILE_N;             // 128 output columns a block
constexpr int TILE_BLOCKS_PER_SM = 2;          // one block's epilogue overlaps the other's main loop
constexpr int TILE_CONSUMERS = TileG::WGS * tc::WG_THREADS;
constexpr int MAX_GRID = 32 * 32;              // mask grids staged in shared memory up to this size

// one output element's epilogue, as the strip kernels' store_out computes it
__device__ __forceinline__ float masked(float acc, int and_m, int or_m) {
  return __int_as_float((__float_as_int(acc) & and_m) | or_m);
}

template <int TM, int TN>
__global__ void __launch_bounds__(TileG::THREADS, TILE_BLOCKS_PER_SM) ft_strip_mma_kernel(
    const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw, const int* __restrict__ and_grid,
    const int* __restrict__ or_grid, void* __restrict__ out, int M, int N, int K, int rows, int cols, int out_bf16) {
  static_assert(TM == TILE_M && TN == TILE_N, "the tile is the geometry's");
  extern __shared__ uint8_t smem_raw[];
  auto& s = tc::aligned_smem<TileG>(smem_raw);
  __shared__ int grids[2][MAX_GRID];  // and, or
  __shared__ int pe_col[TN];          // the PE column of each of the tile's columns
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM, e = blockIdx.z;
  const int KT = (K + tc::STAGE_K - 1) / tc::STAGE_K;
  const int tid = threadIdx.x;
  if (tid == 0) tc::init_barriers<TileG>(s);
  __syncthreads();
  if (tid >= TILE_CONSUMERS) {
    if (tid == TILE_CONSUMERS) tc::produce<false, TileG>(s, &mx, &mw, m0, n0, KT, e);
    return;
  }
  // the consumers stage the grids while the first stages arrive
  const bool staged = rows * cols <= MAX_GRID;
  if (staged) {
    for (int i = tid; i < rows * cols; i += TILE_CONSUMERS) {
      grids[0][i] = and_grid[i];
      grids[1][i] = or_grid[i];
    }
  }
  if (tid < TN) pe_col[tid] = (n0 + tid) % cols;
  const int wg = tid / tc::WG_THREADS;
  float acc[tc::ACC];
  tc::consume<false, TileG>(s, wg, KT, acc);
  asm volatile("bar.sync 1, %0;" ::"n"(TILE_CONSUMERS) : "memory");  // the staged grids are visible
  const int* ag = staged ? grids[0] : and_grid;
  const int* og = staged ? grids[1] : or_grid;

  // acc[i] is row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2) and column
  // 8 (i / 4) + 2 (t % 4) + i % 2 of this warpgroup's 64 x 128 piece
  const int t = tid % tc::WG_THREADS, lane = t % 32;
  const int row0 = m0 + wg * tc::WG_M + (t / 32) * 16 + lane / 4;  // the row within the expert
  const int c0 = 2 * (lane % 4);
  const bool pairs = (N % 2) == 0;  // (m, n) and (m, n + 1) share one store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + 8 * h;
    if (m >= M) continue;
    const int pr = (m % rows) * cols;
    const long long o = ((long long)e * M + m) * N + n0;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int c = 8 * j + c0;
      if (n0 + c >= N) break;
      const int p0 = pr + pe_col[c], p1 = pr + pe_col[c + 1];
      const float v0 = masked(acc[4 * j + 2 * h], ag[p0], og[p0]);
      const float v1 = masked(acc[4 * j + 2 * h + 1], ag[p1], og[p1]);
      const bool both = n0 + c + 1 < N;
      if (out_bf16) {
        __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out) + o + c;
        if (pairs && both) {
          *reinterpret_cast<__nv_bfloat162*>(ob) = __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
        } else {
          ob[0] = __float2bfloat16_rn(v0);
          if (both) ob[1] = __float2bfloat16_rn(v1);
        }
      } else {
        float* of = static_cast<float*>(out) + o + c;
        if (pairs && both) {
          *reinterpret_cast<float2*>(of) = make_float2(v0, v1);
        } else {
          of[0] = v0;
          if (both) of[1] = v1;
        }
      }
    }
  }
}

// ---------------------------------------------------------- K-fast kernel
// w (K, N) with strides (1, swn): column n is the contiguous row n of the
// table.  Warp q of block b owns columns b * KF_BLOCK_COLS + q * KF_COLS + c.
// A step covers CK = 32 * VEC values of K: lane l loads k = step * CK + l *
// VEC .. + VEC of each column.  x sits in shared memory as float4 (the 4
// rows) at the permuted position step * CK + v * 32 + l, so that the lanes'
// reads of one v are consecutive.
template <typename WT>
struct KFast {
  static constexpr int VEC = 16 / sizeof(WT);
  static constexpr int CK = 32 * VEC;
};

template <typename XT, typename WT>
__device__ __forceinline__ void kfast_load(const WT* const (&pw)[KF_COLS], const bool (&ok)[KF_COLS], int step,
                                           int kv, uint4 (&r)[KF_COLS]) {
  using G = KFast<WT>;
  const bool in_k = step * 32 + (int)(threadIdx.x & 31) < kv;
#pragma unroll
  for (int c = 0; c < KF_COLS; ++c)
    r[c] = (ok[c] && in_k) ? __ldg(reinterpret_cast<const uint4*>(pw[c] + (long long)step * G::CK))
                           : make_uint4(0, 0, 0, 0);
}

template <typename WT>
__device__ __forceinline__ void kfast_sum(const float4* xs, int step, const uint4 (&r)[KF_COLS],
                                          float (&acc)[KF_COLS][BM]) {
  using G = KFast<WT>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < G::VEC; ++v) {
    const float4 xv = xs[step * G::CK + v * 32 + lane];
#pragma unroll
    for (int c = 0; c < KF_COLS; ++c) {
      const float wv = elem<WT>(r[c], v);
      acc[c][0] = fmaf(xv.x, wv, acc[c][0]);
      acc[c][1] = fmaf(xv.y, wv, acc[c][1]);
      acc[c][2] = fmaf(xv.z, wv, acc[c][2]);
      acc[c][3] = fmaf(xv.w, wv, acc[c][3]);
    }
  }
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(THREADS, 3) ft_kfast_kernel(
    const XT* __restrict__ x, const WT* __restrict__ w, const int* __restrict__ and_grid,
    const int* __restrict__ or_grid, void* __restrict__ out, int M, int N, int K, long long sxe,
    long long sxm, long long sxk, long long swe, long long swn, int rows, int cols, int out_bf16) {
  using G = KFast<WT>;
  extern __shared__ float4 xs[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const int nb = blockIdx.x * KF_BLOCK_COLS + warp * KF_COLS;
  const int kv = K / G::VEC;  // 16-byte vectors a column (K % VEC == 0)
  const int steps = (K + G::CK - 1) / G::CK;
  x += (long long)e * sxe;
  w += (long long)e * swe;

  const WT* pw[KF_COLS];
  bool ok[KF_COLS];
#pragma unroll
  for (int c = 0; c < KF_COLS; ++c) {
    ok[c] = nb + c < N;
    pw[c] = w + (long long)(ok[c] ? nb + c : 0) * swn + lane * G::VEC;
  }
  uint4 ra[KF_COLS], rb[KF_COLS];
  if (steps > 0) kfast_load<XT, WT>(pw, ok, 0, kv, ra);  // in flight while x is staged

  for (int t = tid; t < steps * G::CK; t += THREADS) {
    const int step = t / G::CK, r = t % G::CK;
    float4 val;
    float* vf = reinterpret_cast<float*>(&val);
#pragma unroll
    for (int i = 0; i < BM; ++i)
      vf[i] = (m0 + i < M && t < K) ? widen(x[(long long)(m0 + i) * sxm + (long long)t * sxk]) : 0.f;
    xs[step * G::CK + (r % G::VEC) * 32 + r / G::VEC] = val;
  }
  __syncthreads();

  float acc[KF_COLS][BM];
#pragma unroll
  for (int c = 0; c < KF_COLS; ++c)
#pragma unroll
    for (int i = 0; i < BM; ++i) acc[c][i] = 0.f;
  for (int s = 0; s < steps; s += 2) {  // two named buffers, as in the strip kernel
    if (s + 1 < steps) kfast_load<XT, WT>(pw, ok, s + 1, kv, rb);
    kfast_sum<WT>(xs, s, ra, acc);
    if (s + 1 < steps) {
      if (s + 2 < steps) kfast_load<XT, WT>(pw, ok, s + 2, kv, ra);
      kfast_sum<WT>(xs, s + 1, rb, acc);
    }
  }

  // each column's 32 lanes: a fixed butterfly; every lane ends with the sums
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int c = 0; c < KF_COLS; ++c)
#pragma unroll
      for (int i = 0; i < BM; ++i) acc[c][i] += __shfl_xor_sync(0xffffffffu, acc[c][i], off);
  if (lane < KF_COLS * BM) {
    const int c = lane % KF_COLS, i = lane / KF_COLS;
    float s = 0.f;
#pragma unroll
    for (int cc = 0; cc < KF_COLS; ++cc)
#pragma unroll
      for (int ii = 0; ii < BM; ++ii)
        if (cc == c && ii == i) s = acc[cc][ii];
    const int m = m0 + i, n = nb + c;
    if (m < M && n < N) {
      const int pe = (m % rows) * cols + n % cols;
      store_out(out, ((long long)e * M + m) * N + n, s, and_grid[pe], or_grid[pe], out_bf16);
    }
  }
}

// ------------------------------------------------------------------ launch
struct Args {
  const void* x;
  const void* w;
  const int* and_grid;
  const int* or_grid;
  void* out;
  int E, M, N, K;
  long long sxe, sxm, sxk, swe, swk, swn;
  int rows, cols, split, bn, out_bf16;
};

// The launch of a strip kernel: grid (strips x split, row tiles, experts),
// clusters of `split` along x, SMEM bytes of dynamic shared memory.
template <typename Kernel, typename... Params>
cudaError_t launch_cluster(Kernel kernel, int smem, const Args& a, cudaStream_t stream, Params... params) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((a.N + STRIP - 1) / STRIP) * a.split), (unsigned)((a.M + BM - 1) / BM),
                     (unsigned)a.E);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, params...);
}

// Shared memory above 48 KB needs the kernel's opt-in, once.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  done = err == cudaSuccess;
  return err;
}

template <typename XT, typename WT, int VEC>
cudaError_t launch_strip(const Args& a, cudaStream_t stream) {
  constexpr int smem = Strip<WT, VEC>::SMEM;
  static bool sized = false;
  const auto kernel = ft_strip_kernel<XT, WT, VEC>;
  if (const cudaError_t err = opt_in(kernel, smem, sized)) return err;
  return launch_cluster(kernel, smem, a, stream, static_cast<const XT*>(a.x), static_cast<const WT*>(a.w),
                        a.and_grid, a.or_grid, a.out, a.M, a.N, a.K, a.split, a.sxe, a.sxm, a.sxk, a.swe,
                        a.swk, a.swn, a.rows, a.cols, a.out_bf16);
}

// the strip kernel of the ft_strip_mma_kernel overloads
using StripMmaKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const int*, const int*, void*, int, int,
                                int, int, long long, long long, long long, long long, long long, int, int, int);

cudaError_t launch_strip_mma(const Args& a, cudaStream_t stream) {
  constexpr int smem = MmaStrip::SMEM;
  static bool sized = false;
  const StripMmaKernel kernel = ft_strip_mma_kernel;
  if (const cudaError_t err = opt_in(kernel, smem, sized)) return err;
  return launch_cluster(kernel, smem, a, stream, static_cast<const __nv_bfloat16*>(a.x),
                        static_cast<const __nv_bfloat16*>(a.w), a.and_grid, a.or_grid, a.out, a.M, a.N, a.K,
                        a.split, a.sxe, a.sxm, a.sxk, a.swe, a.swk, a.rows, a.cols, a.out_bf16);
}

// The tile kernel: grid (N tiles, M tiles, E), one launch.  x's map is over
// (E, M, K), w's over (E, K, N); both need unit stride on their inner axis,
// a 16-byte aligned base and 16-byte multiples for the other strides (the
// wrapper copies an x that has not).  A single expert's slice stride is
// never read, so the call of ft_matmul (E = 1) gives it the slice's size.
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  const long long sxe = a.E > 1 ? a.sxe : a.sxm * a.M, swe = a.E > 1 ? a.swe : a.swk * a.K;
  CUtensorMap mx, mw;
  if (a.split != 1 || a.sxk != 1 || a.swn != 1 ||
      !tc::encode_bf16_3d(&mx, a.x, a.K, a.M, a.E, 2ull * a.sxm, 2ull * sxe, tc::STAGE_K, tc::WG_M) ||
      !tc::encode_bf16_3d(&mw, a.w, a.N, a.K, a.E, 2ull * a.swk, 2ull * swe, tc::ATOM_N, tc::STAGE_K))
    return cudaErrorInvalidValue;
  static bool sized = false;
  const auto kernel = ft_strip_mma_kernel<TILE_M, TILE_N>;
  if (const cudaError_t err = opt_in(kernel, (int)TileG::SMEM_BYTES, sized)) return err;
  const dim3 grid((unsigned)((a.N + TILE_N - 1) / TILE_N), (unsigned)((a.M + TILE_M - 1) / TILE_M), (unsigned)a.E);
  kernel<<<grid, TileG::THREADS, TileG::SMEM_BYTES, stream>>>(mx, mw, a.and_grid, a.or_grid, a.out, a.M, a.N, a.K,
                                                              a.rows, a.cols, a.out_bf16);
  return cudaSuccess;
}

template <typename XT, typename WT>
cudaError_t launch_kfast(const Args& a, cudaStream_t stream) {
  using G = KFast<WT>;
  const long long smem = (long long)((a.K + G::CK - 1) / G::CK) * G::CK * sizeof(float4);
  if (a.swk != 1 || a.K % G::VEC != 0 || smem > KF_MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.N + KF_BLOCK_COLS - 1) / KF_BLOCK_COLS), (unsigned)((a.M + BM - 1) / BM),
                  (unsigned)a.E);
  ft_kfast_kernel<XT, WT><<<grid, THREADS, (size_t)smem, stream>>>(
      static_cast<const XT*>(a.x), static_cast<const WT*>(a.w), a.and_grid, a.or_grid, a.out, a.M, a.N,
      a.K, a.sxe, a.sxm, a.sxk, a.swe, a.swn, a.rows, a.cols, a.out_bf16);
  return cudaSuccess;
}

template <typename XT, typename WT>
cudaError_t launch_layout(const Args& a, int layout, cudaStream_t stream) {
  switch (layout) {
    case N_FAST:
      if constexpr (std::is_same_v<XT, __nv_bfloat16> && std::is_same_v<WT, __nv_bfloat16>) {
        if (a.bn == TILE_N) return launch_tile(a, stream);
      }
      if (a.swn != 1 || a.bn != STRIP) return cudaErrorInvalidValue;
      if constexpr (std::is_same_v<XT, __nv_bfloat16> && std::is_same_v<WT, __nv_bfloat16>)
        return launch_strip_mma(a, stream);
      else
        return launch_strip<XT, WT, 16 / sizeof(WT)>(a, stream);
    case K_FAST:
      if (a.split != 1 || a.bn != KF_BLOCK_COLS) return cudaErrorInvalidValue;
      return launch_kfast<XT, WT>(a, stream);
    case SCALAR:
      if (a.bn != STRIP) return cudaErrorInvalidValue;
      return launch_strip<XT, WT, 1>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(const Args& a, int x_bf16, int w_bf16, int layout, void* stream) {
  if (a.split < 1 || a.split > MAX_SPLIT) return static_cast<int>(cudaErrorInvalidValue);
  if (a.E <= 0 || a.M <= 0 || a.N <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16 && w_bf16)
    err = launch_layout<__nv_bfloat16, __nv_bfloat16>(a, layout, s);
  else if (x_bf16)
    err = launch_layout<__nv_bfloat16, float>(a, layout, s);
  else if (w_bf16)
    err = launch_layout<float, __nv_bfloat16>(a, layout, s);
  else
    err = launch_layout<float, float>(a, layout, s);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// x: (M, K) with strides (sxm, sxk); w: (K, N) with strides (swk, swn), both in
// elements; x_bf16 / w_bf16 select bfloat16 (1) or float32 (0).  and_grid /
// or_grid: (rows, cols) int32, contiguous.  out: (M, N) contiguous, float32
// (out_bf16 = 0) or bfloat16 (1).  layout (0 N-fast, 1 K-fast, 2 scalar) and
// split (the cluster size along K, 1..8) and bn (output columns a block: 64
// for the strip kernels, 128 for the tile kernel, 32 for K-fast) are the
// caller's plan.  Returns the launch's CUDA error (0 on success).
extern "C" int ft_matmul_launch(const void* x, const void* w, const void* and_grid,
                                const void* or_grid, void* out, int M, int N, int K,
                                long long sxm, long long sxk, long long swk, long long swn,
                                int x_bf16, int w_bf16, int rows, int cols, int layout, int split,
                                int bn, int out_bf16, void* stream) {
  const Args a{x, w, static_cast<const int*>(and_grid), static_cast<const int*>(or_grid), out,
               1, M, N, K, 0, sxm, sxk, 0, swk, swn, rows, cols, split, bn, out_bf16};
  return dispatch(a, x_bf16, w_bf16, layout, stream);
}

// The batched form: x (E, M, K) with strides (sxe, sxm, sxk); w (E, K, N) with
// strides (swe, swk, swn); out (E, M, N) contiguous.  E <= 65535.
extern "C" int ft_matmul_batched_launch(const void* x, const void* w, const void* and_grid,
                                        const void* or_grid, void* out, int E, int M, int N,
                                        int K, long long sxe, long long sxm, long long sxk,
                                        long long swe, long long swk, long long swn,
                                        int x_bf16, int w_bf16, int rows, int cols, int layout,
                                        int split, int bn, int out_bf16, void* stream) {
  const Args a{x, w, static_cast<const int*>(and_grid), static_cast<const int*>(or_grid), out,
               E, M, N, K, sxe, sxm, sxk, swe, swk, swn, rows, cols, split, bn, out_bf16};
  return dispatch(a, x_bf16, w_bf16, layout, stream);
}
