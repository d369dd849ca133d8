// The bf16 main loop of the two-pass kernels on Hopper's tensor cores: TMA
// loads into a ring of 128-byte-swizzled shared-memory stages, one producer
// warp, and consumer warpgroups that each run wgmma m64n128k16 (bf16 x bf16,
// f32 accumulate in registers) on one 64-row x 128-column piece of x @ w.
//
// Shared by os_array_matmul.cu (pass 1 of the paper's two-pass pipeline) and
// dppu_recompute.cu (pass 2) for bf16 operands, it is the main loop of the
// Pallas TPU kernels src/repro/kernels/os_array_matmul.py::os_array_matmul
// and src/repro/kernels/dppu_recompute.py::dppu_recompute, which those two
// files replace; f32 and int8 operands keep the CUDA-core loop of
// array_tile.cuh.  Which loop a call takes depends only
// on the operands' dtype, so both passes take the same one.
//
// The bitwise contract.  A tile that the DPPU recomputes must equal what the
// fault-free array computes there, bit for bit, on any operands.  So every
// output element is produced here in one way: by the same wgmma instruction
// shape, over the same sequence of K stages (STAGE_K = 64 deep, four k16
// steps each, from k = 0 upward, a ragged tail zero-filled by TMA), with the
// accumulator starting at +0.  K is never split.  And both kernels compute
// only the array-aligned pieces: rows [64p, 64p + 64) and columns
// [128q, 128q + 128) of the output.  The recompute covers a tile with the
// aligned pieces that hold it, so each of its outputs comes from the same
// instruction, on the same shared-memory operands, at the same place in the
// piece, as in pass 1.  The tensor cores' internal summation order therefore
// never enters: the two passes issue identical work.
//
// Layouts, read without a copy.  x is (M, K) with unit stride along K (K-major,
// wgmma's A).  w is either (K, N) with unit stride along N (the q/up/down
// weights: MN-major, wgmma's B transposed, two 64-column swizzle atoms per
// piece) or the transposed view of an (N, K) table, unit stride along K (the
// tied LM head's table.T: K-major, wgmma's natural B).  TMA needs a 16-byte
// aligned base and 16-byte multiples for the other stride; the Python wrapper
// checks that and raises, and the launch functions return
// cudaErrorInvalidValue if a descriptor cannot be encoded.
//
// What bounds the loop: the tensor cores, once the operands arrive in time.  A
// piece takes 384 bytes of operands per k for 64 * 128 * 2 operations; most
// come from L2, since neighbouring blocks share x row-panels and w
// column-panels.  The producer keeps up to STAGES stages in flight, so TMA
// latency hides behind the wgmma of earlier stages.  The descriptors are
// built on the host with cuTensorMapEncodeTiled, fetched through the
// runtime's driver entry point, so the libraries need no -lcuda.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace array_tile_wgmma {

constexpr int WG_M = 64;       // rows of a piece: one consumer warpgroup, wgmma m64
constexpr int TILE_N = 128;    // columns of a piece: wgmma n128
constexpr int STAGE_K = 64;    // K depth of a stage: 64 bf16 = one 128-byte swizzle row
constexpr int MMA_K = 16;      // wgmma k16
constexpr int WG_THREADS = 128;
constexpr int PRODUCER_THREADS = 32;  // one warp issues every TMA load
constexpr int ACC = WG_M * TILE_N / WG_THREADS;  // 64 f32 accumulators a thread
constexpr int ATOM_N = 64;     // columns of one 128-byte swizzle atom of an MN-major w
constexpr uint32_t A_BYTES = WG_M * STAGE_K * 2;    // 8 KB a warpgroup
constexpr uint32_t B_BYTES = TILE_N * STAGE_K * 2;  // 16 KB

// A block's geometry: WGS consumer warpgroups, each on one array-aligned
// 64 x 128 piece, so a block computes rows [m0, m0 + 64 * WGS) and columns
// [n0, n0 + 128); a ring of STAGES stages.  Every operand tile is a multiple
// of 1024 bytes, so with a 1024-byte aligned base each starts on a swizzle
// period, as wgmma's descriptors assume.
template <int WGS_, int STAGES_>
struct Geometry {
  static constexpr int WGS = WGS_, STAGES = STAGES_;
  static constexpr int THREADS = WGS * WG_THREADS + PRODUCER_THREADS;
  struct Smem {
    __nv_bfloat16 a[STAGES][WGS][WG_M * STAGE_K];
    __nv_bfloat16 b[STAGES][TILE_N * STAGE_K];
    uint64_t full[STAGES];   // TMA bytes of the stage arrived
    uint64_t empty[STAGES];  // every consumer warp is done with the stage
  };
  static constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;  // + alignment slack
};

// ---------------------------------------------------------------- device
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <class G>
__device__ __forceinline__ typename G::Smem& aligned_smem(uint8_t* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<typename G::Smem*>(raw + pad);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: barriers for every stage.  The caller syncs the block after.
template <class G>
__device__ __forceinline__ void init_barriers(typename G::Smem& s) {
#pragma unroll
  for (int i = 0; i < G::STAGES; ++i) {
    bar_init(&s.full[i], 1);             // the producer's arrive, plus the TMA bytes
    bar_init(&s.empty[i], G::WGS * 4);   // lane 0 of each consumer warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// 2-D TMA load of the box at (c0 inner, c1 outer) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it cannot see that the tensor cores write them later).
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) @ B (16 x 128; K-major, or MN-major when TRANS_B).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

// The producer warp's elected thread: stage k of x rows [m0, m0 + 64 * WGS)
// and w columns [n0, n0 + 128), for k = 0 .. KT - 1, into the ring.
template <bool W_K_MAJOR, class G>
__device__ __forceinline__ void produce(typename G::Smem& s, const CUtensorMap* mx, const CUtensorMap* mw,
                                        int m0, int n0, int KT) {
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt % G::STAGES;
    if (kt >= G::STAGES) bar_wait(&s.empty[st], ((kt / G::STAGES) & 1) ^ 1);
    bar_expect_tx(&s.full[st], G::WGS * A_BYTES + B_BYTES);
    const int k0 = kt * STAGE_K;
#pragma unroll
    for (int wg = 0; wg < G::WGS; ++wg) tma_load(s.a[st][wg], mx, &s.full[st], k0, m0 + wg * WG_M);
    if (W_K_MAJOR) {
      tma_load(s.b[st], mw, &s.full[st], k0, n0);
    } else {
      tma_load(s.b[st], mw, &s.full[st], n0, k0);
      tma_load(s.b[st] + ATOM_N * STAGE_K, mw, &s.full[st], n0 + ATOM_N, k0);
    }
  }
}

// A consumer warpgroup: acc = its 64-row piece of x times the 128 columns,
// summed over the KT stages in order, from +0.  Thread t of the warpgroup
// holds rows 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2) and columns
// 8 * (i / 4) + 2 * (t % 4) + i % 2 of the piece in acc[i].
template <bool W_K_MAJOR, class G>
__device__ __forceinline__ void consume(typename G::Smem& s, int wg, int KT, float (&acc)[ACC]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  fence_acc(acc);
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt % G::STAGES;
    bar_wait(&s.full[st], (kt / G::STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < STAGE_K / MMA_K; ++kk) {
      // K-major: a k16 step is 32 bytes along the swizzled 128-byte row, and
      // the 8-row groups are 1024 bytes apart.  MN-major w: a k16 step is 16
      // rows of 128 bytes; 8-k groups 1024 bytes apart, the two 64-column
      // atoms ATOM_N * STAGE_K * 2 bytes apart.
      const uint64_t da = desc(s.a[st][wg] + kk * MMA_K, 16, 1024);
      if (W_K_MAJOR) {
        wgmma_m64n128k16<0>(acc, da, desc(s.b[st] + kk * MMA_K, 16, 1024));
      } else {
        wgmma_m64n128k16<1>(acc, da, desc(s.b[st] + kk * MMA_K * ATOM_N, ATOM_N * STAGE_K * 2, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free its buffers
    fence_acc(acc);
    if (kt > 0 && lane == 0) bar_arrive(&s.empty[(kt - 1) % G::STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (rc == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 2-D bf16 tensor map, 128-byte swizzle, zero fill out of bounds: the
// (inner, outer) tensor at base with outer stride stride_bytes, in boxes of
// (box_inner, box_outer).  False when the driver refuses it.
inline bool encode_bf16(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
                        uint64_t stride_bytes, uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {stride_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of x (M, K) with strides (sxm, 1) and of w (K, N): K-major when
// swk == 1 (strides (1, swn)), else MN-major with strides (swk, 1); strides in
// elements.  False for any other layout or a map the driver refuses.
inline bool encode_operands(CUtensorMap* mx, CUtensorMap* mw, const void* x, const void* w, int M, int N, int K,
                            long long sxm, long long sxk, long long swk, long long swn, bool w_k_major) {
  if (sxk != 1 || (w_k_major ? swk : swn) != 1) return false;
  if (!encode_bf16(mx, x, K, M, 2ull * sxm, STAGE_K, WG_M)) return false;
  if (w_k_major) return encode_bf16(mw, w, K, N, 2ull * swn, STAGE_K, TILE_N);
  return encode_bf16(mw, w, N, K, 2ull * swk, ATOM_N, STAGE_K);
}

}  // namespace array_tile_wgmma
