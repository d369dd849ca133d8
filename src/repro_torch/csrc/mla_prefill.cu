// The MLA prefill attention core on Hopper: causal softmax(q k^T * scale) v
// for every head of a batch of sequences, in one launch a layer, for
// models/attention.py::mla_forward.  It replaces no TPU kernel: the JAX
// package left MLA attention to XLA (src/repro/models/attention.py), and the
// port's plain f32 loop (kernels/mla_prefill.py::mla_prefill_ref) held most of
// the device time of a DeepSeek-V3 prefill on an H100, at about 1.5% of its
// bound.
//
// Per head, a query's key is (k_nope, k_rope): k_nope (dn) is the head's own,
// read in place from the wkv_b output view kv[..., :dn]; k_rope (dr) is one
// (B, S, dr) tensor that every head shares.  The rope part is loaded as extra
// key columns of the same tile, so q k^T = q_nope k_nope^T + q_rope k_rope^T
// accumulates in one f32 accumulator.  V is read in place from kv[..., dn:].
//
// What bounds it: the tensor cores.  A block owns 128 query rows of one
// (sequence, head) and walks the key tiles up to its diagonal one; keys past
// its last row are never loaded, and only the diagonal tile is masked.  The
// operations are S(S+1)/2 * 2 * (dn + dr + dv) a (sequence, head), against
// the q, k, v and output bytes read or written once: operations dominate from
// S = 2048 at DeepSeek-V3's widths and about equal the bytes at S = 1024.
// The design for it, FlashAttention-3 shaped:
//   * one producer thread issues every TMA load: Q once, then a ring of STAGES
//     (K, V) tiles of 128 keys, K and V on their own barriers so that q k^T
//     starts before V has landed;
//   * two consumer warpgroups, 64 query rows each: q k^T on wgmma
//     m64n128k16 (bf16 in, f32 out) over dn + 64 columns, an online softmax
//     in f32 registers (running max and sum; log2(e) folded into the scale
//     for exp2), P rounded to bf16 in registers as the A operand of a
//     register-A wgmma against V (B transposed from shared memory), the
//     output accumulated in f32;
//   * blocks in groups of HEAD_GROUP (sequence, head) pairs, each group's
//     query tiles from the last (the most keys) down: the blocks on the card
//     at one time share K and V through L2, and the long blocks start first;
//   * the epilogue divides by the row sum and stores bf16 straight into
//     (B, S, H, dv), the layout merge_heads reads.
// Rows past S (a ragged last tile) are loaded as zeros by TMA and never stored.
// The rope part is padded to one 64-column swizzle atom: where dr = 32, TMA
// fills the other 32 columns of Q and K with zeros.
// mla_prefill_f32_launch runs the same core on f32 operands of any MLA
// widths, f32 arithmetic throughout, on the CUDA cores (mla_prefill_f32_kernel).
#include <cmath>

#include "array_tile_wgmma.cuh"

namespace {

namespace tc = array_tile_wgmma;
using bf16 = __nv_bfloat16;

constexpr int BLOCK_M = 2 * tc::WG_M;  // query rows a block: two consumer warpgroups
constexpr int BLOCK_N = 128;           // keys a tile: the n of the q k^T wgmma
constexpr int ATOM = 64;               // columns of one 128-byte swizzle atom
constexpr uint32_t ATOM_BYTES = BLOCK_N * ATOM * 2;  // one atom of a 128-row tile, 16 KB
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2 * tc::WG_THREADS;
// a producer warpgroup, so that setmaxnreg can move its registers to the
// consumers: 168 a thread at launch (3 warps on each SM sub-partition's 16K
// registers), 24 for the producer and 240 for the consumers after it
constexpr int THREADS = CONSUMERS + tc::WG_THREADS;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int HEAD_GROUP = 8;  // (sequence, head) pairs whose blocks run together
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BLOCK_M == BLOCK_N, "Q and K tiles share the atom size");

template <int DN, int DR, int DV>
struct Layout {
  static_assert(DN % ATOM == 0 && DR > 0 && DR <= ATOM && (DV == 64 || DV == 128), "a supported MLA layout");
  static constexpr int QK_ATOMS = DN / ATOM + 1;  // the rope part padded to one atom
  static constexpr int V_ATOMS = DV / ATOM;
  static constexpr int O_ACC = tc::WG_M * DV / tc::WG_THREADS;  // output accumulators a thread
  struct Smem {
    bf16 q[QK_ATOMS][BLOCK_M * ATOM];
    bf16 k[STAGES][QK_ATOMS][BLOCK_N * ATOM];
    bf16 v[STAGES][V_ATOMS][BLOCK_N * ATOM];
    uint64_t q_full;
    uint64_t k_full[STAGES];
    uint64_t v_full[STAGES];
    uint64_t empty[STAGES];  // every consumer warp is done with the stage's K and V
  };
  static constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;  // + alignment slack
};

// 4-D TMA load of the box at (c0 inner, c1, c2, c3) into shared memory.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(tc::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, bf16 in registers: the accumulator layout of a 64 x 16
// piece, two values a register) @ B (16 x N, MN-major in shared memory).
template <int N>
struct PV;

template <>
struct PV<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
};

template <>
struct PV<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
};

// A wgmma descriptor (array_tile_wgmma.cuh's desc) whose address the compiler
// cannot see: it recomputes the descriptors from it in every tile rather than
// holding a dozen of them in registers across the loop.
__device__ __forceinline__ uint64_t opaque_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = tc::desc(p, lbo, sbo);
  asm volatile("" : "+l"(d));
  return d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The maps: q_nope (dn, H, S, B), q_rope (dr, H, S, B), k_nope (dn, H, S, B),
// k_rope (dr, S, B) and v (dv, H, S, B), innermost first, each loaded in boxes
// of 64 columns x 128 rows of one head and one sequence.
template <int DN, int DR, int DV>
__global__ void __launch_bounds__(THREADS, 1) mla_prefill_kernel(
    const __grid_constant__ CUtensorMap mqn, const __grid_constant__ CUtensorMap mqr,
    const __grid_constant__ CUtensorMap mkn, const __grid_constant__ CUtensorMap mkr,
    const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out, int B, int S, int H, float scale_log2) {
  using L = Layout<DN, DR, DV>;
  extern __shared__ uint8_t smem_raw[];
  auto& s = tc::aligned_smem<L>(smem_raw);

  // which (sequence, head, query tile): HEAD_GROUP pairs a group (fewer in the
  // last), and within a group the query tiles from the last down
  const int n_qt = (S + BLOCK_M - 1) / BLOCK_M;
  const int group = blockIdx.x / (HEAD_GROUP * n_qt);
  const int gsize = min(HEAD_GROUP, B * H - group * HEAD_GROUP);
  const int within = blockIdx.x - group * HEAD_GROUP * n_qt;
  const int qt = n_qt - 1 - within / gsize;
  const int bh = group * HEAD_GROUP + within % gsize;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BLOCK_M;
  const int n_kt = qt + 1;  // the key tiles up to the diagonal one
  const int tid = threadIdx.x;

  if (tid == 0) {
    tc::bar_init(&s.q_full, 1);
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      tc::bar_init(&s.k_full[i], 1);
      tc::bar_init(&s.v_full[i], 1);
      tc::bar_init(&s.empty[i], CONSUMERS / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      tc::bar_expect_tx(&s.q_full, L::QK_ATOMS * ATOM_BYTES);
#pragma unroll
      for (int a = 0; a < DN / ATOM; ++a) tma_load_4d(s.q[a], &mqn, &s.q_full, a * ATOM, h, q0, b);
      tma_load_4d(s.q[DN / ATOM], &mqr, &s.q_full, 0, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) tc::bar_wait(&s.empty[st], ((j / STAGES) & 1) ^ 1);
        const int k0 = j * BLOCK_N;
        tc::bar_expect_tx(&s.k_full[st], L::QK_ATOMS * ATOM_BYTES);
#pragma unroll
        for (int a = 0; a < DN / ATOM; ++a) tma_load_4d(s.k[st][a], &mkn, &s.k_full[st], a * ATOM, h, k0, b);
        tc::tma_load(s.k[st][DN / ATOM], &mkr, &s.k_full[st], 0, k0, b);
        tc::bar_expect_tx(&s.v_full[st], L::V_ATOMS * ATOM_BYTES);
#pragma unroll
        for (int a = 0; a < L::V_ATOMS; ++a) tma_load_4d(s.v[st][a], &mv, &s.v_full[st], a * ATOM, h, k0, b);
      }
    }
    return;
  }

  // a consumer warpgroup: query rows [q0 + 64 wg, q0 + 64 wg + 64).  Thread t
  // holds rows r0 and r0 + 8 of them; acc[i] is row r0 + 8 ((i / 2) % 2) and
  // column 8 (i / 4) + c0 + i % 2 of a 64-row piece (array_tile_wgmma.cuh)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = tid / tc::WG_THREADS, t = tid % tc::WG_THREADS, lane = t % 32;
  const int r0 = q0 + wg * tc::WG_M + (t / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float o[L::O_ACC];
#pragma unroll
  for (int i = 0; i < L::O_ACC; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  tc::bar_wait(&s.q_full, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int st = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    float sc[tc::ACC];
#pragma unroll
    for (int i = 0; i < tc::ACC; ++i) sc[i] = 0.f;
    tc::fence_acc(sc);
    tc::bar_wait(&s.k_full[st], parity);
    tc::wgmma_fence();
    // a descriptor's address field counts 16 bytes: a k16 step adds 32 bytes
    // along the swizzled row, an atom ATOM_BYTES
    const uint64_t qdesc = opaque_desc(s.q[0] + wg * tc::WG_M * ATOM, 16, 1024);
    const uint64_t kdesc = opaque_desc(s.k[st][0], 16, 1024);
#pragma unroll
    for (int a = 0; a < L::QK_ATOMS; ++a) {
#pragma unroll
      for (int kk = 0; kk < ATOM / tc::MMA_K; ++kk) {
        const uint64_t step = (a * ATOM_BYTES + kk * tc::MMA_K * 2) >> 4;
        tc::wgmma_m64n128k16<0>(sc, qdesc + step, kdesc + step);
      }
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_acc(sc);

    if (j == qt) {  // the diagonal tile: a row's later keys get weight 0
#pragma unroll
      for (int i = 0; i < tc::ACC; ++i) {
        if (j * BLOCK_N + 8 * (i / 4) + c0 + i % 2 > r0 + 8 * ((i / 2) % 2)) sc[i] = -INFINITY;
      }
    }
    // online softmax: the new running max, the old sums and outputs rescaled
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < tc::ACC; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float neg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      const float alpha = exp2f((m[r] - mx[r]) * scale_log2);
      l[r] *= alpha;
#pragma unroll
      for (int i = 2 * r; i < L::O_ACC; i += 4) {
        o[i] *= alpha;
        o[i + 1] *= alpha;
      }
      m[r] = mx[r];
      neg[r] = -mx[r] * scale_log2;
    }
    // P in bf16 as the A operand: registers 4 kk .. 4 kk + 3 hold keys
    // [16 kk, 16 kk + 16) of rows r0 and r0 + 8, as wgmma's A fragment wants
    uint32_t pa[tc::ACC / 2];
#pragma unroll
    for (int i = 0; i < tc::ACC; i += 2) {
      const int r = (i / 2) % 2;
      const float p0 = exp2f(fmaf(sc[i], scale_log2, neg[r]));
      const float p1 = exp2f(fmaf(sc[i + 1], scale_log2, neg[r]));
      l[r] += p0 + p1;
      pa[i / 2] = pack_bf16(p0, p1);
    }
    tc::bar_wait(&s.v_full[st], parity);
    // V MN-major: a k16 step is 16 key rows of 128 bytes, 8-key groups 1024
    // bytes apart, the 64-column atoms ATOM_BYTES apart
    const uint64_t vdesc = opaque_desc(s.v[st][0], ATOM_BYTES, 1024);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / tc::MMA_K; ++kk) {
      PV<DV>::mma(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                  vdesc + ((kk * tc::MMA_K * ATOM * 2) >> 4));
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) tc::bar_arrive(&s.empty[st]);
  }

  // every lane of a warp takes part in the row sums' shuffles, rows past S
  // (a ragged last tile) too; only the stores are skipped for them
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const float inv = 1.f / quad_sum(l[r]);
    if (row >= S) continue;
    bf16* dst = out + (((long long)b * S + row) * H + h) * DV + c0;
#pragma unroll
    for (int g = 0; g < DV / 8; ++g) {
      *reinterpret_cast<uint32_t*>(dst + 8 * g) = pack_bf16(o[4 * g + 2 * r] * inv, o[4 * g + 2 * r + 1] * inv);
    }
  }
}

// A bf16 tensor map of `rank` dims (innermost first), strides in bytes of
// dims 1.., boxes of 64 columns x 128 rows along dim rank - 2 (S) and 1 along
// the others; 128-byte swizzle, zero fill out of bounds.  False when the
// driver refuses it.
bool encode(CUtensorMap* map, const void* base, int rank, const uint64_t* dims, const uint64_t* strides) {
  const tc::EncodeTiled fn = tc::encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t d[4], st[3];
  cuuint32_t box[4], elem[4];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    box[i] = i == 0 ? ATOM : i == rank - 2 ? BLOCK_N : 1;
    elem[i] = 1;
    if (i > 0) st[i - 1] = strides[i - 1];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), d, st, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q_nope, *q_rope, *k_nope, *k_rope, *v;
  void* out;
  int B, S, H;
  const long long* strides;  // (b, s, h) of q_nope, q_rope, k_nope, v; (b, s) of k_rope, in elements
  float scale;
};

template <int DN, int DR, int DV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<DN, DR, DV>;
  const long long* st = a.strides;
  const uint64_t B = a.B, S = a.S, H = a.H;
  // 4-D maps (d, H, S, B): strides of h, s, b in bytes
  auto map4 = [&](CUtensorMap* m, const void* base, uint64_t d, const long long* sbsh) {
    const uint64_t dims[4] = {d, H, S, B};
    const uint64_t bytes[3] = {2ull * sbsh[2], 2ull * sbsh[1], 2ull * sbsh[0]};
    return encode(m, base, 4, dims, bytes);
  };
  CUtensorMap mqn, mqr, mkn, mkr, mv;
  const uint64_t kr_dims[3] = {DR, S, B};
  const uint64_t kr_bytes[2] = {2ull * st[13], 2ull * st[12]};
  if (!map4(&mqn, a.q_nope, DN, st) || !map4(&mqr, a.q_rope, DR, st + 3) || !map4(&mkn, a.k_nope, DN, st + 6) ||
      !map4(&mv, a.v, DV, st + 9) || !encode(&mkr, a.k_rope, 3, kr_dims, kr_bytes))
    return cudaErrorInvalidValue;
  const auto kernel = mla_prefill_kernel<DN, DR, DV>;
  static const cudaError_t sized =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM_BYTES);
  if (sized != cudaSuccess) return sized;
  const long long blocks = (long long)((a.S + BLOCK_M - 1) / BLOCK_M) * a.B * a.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, THREADS, L::SMEM_BYTES, stream>>>(mqn, mqr, mkn, mkr, mv, static_cast<bf16*>(a.out),
                                                                a.B, a.S, a.H, a.scale * LOG2E);
  return cudaSuccess;
}

// The f32 instance: the same causal core for f32 operands of any widths with
// dn + dr and dv up to F32_MAX_D, f32 arithmetic throughout on the CUDA cores
// (the tensor cores have no product that keeps f32's bits), for the exact
// configurations; no cell runs it.  A block owns F32_ROWS query rows of one
// (sequence, head), a warp one row: lane c holds the row's query and output
// columns c, c + 32, ...  The block stages F32_KEYS keys at a time, k_nope and
// k_rope side by side and v, up to its last row; each warp's scores of a
// stage are summed across its lanes, then one online-softmax step rescales
// its sum and output once a stage.
constexpr int F32_ROWS = 8, F32_KEYS = 16, F32_MAX_D = 256, F32_PER_LANE = F32_MAX_D / 32;

struct F32Strides {
  long long v[14];  // as Args::strides
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(F32_ROWS * 32) mla_prefill_f32_kernel(
    const float* __restrict__ qn, const float* __restrict__ qr, const float* __restrict__ kn,
    const float* __restrict__ kr, const float* __restrict__ v, float* __restrict__ out, int S, int H, int dn, int dr,
    int dv, const F32Strides st, float scale_log2) {
  __shared__ float sk[F32_KEYS][F32_MAX_D];
  __shared__ float sv[F32_KEYS][F32_MAX_D];
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * F32_ROWS, row = q0 + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dk = dn + dr, width = max(dk, dv), last = min(q0 + F32_ROWS, S);
  float q[F32_PER_LANE], o[F32_PER_LANE];
#pragma unroll
  for (int i = 0; i < F32_PER_LANE; ++i) {
    const int c = lane + 32 * i;
    q[i] = 0.f;
    o[i] = 0.f;
    if (row < S && c < dn) q[i] = qn[b * st.v[0] + row * st.v[1] + h * st.v[2] + c];
    else if (row < S && c < dk) q[i] = qr[b * st.v[3] + row * st.v[4] + h * st.v[5] + c - dn];
  }
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < last; k0 += F32_KEYS) {
    __syncthreads();  // every warp is done with the previous stage
    for (int e = threadIdx.x; e < F32_KEYS * width; e += F32_ROWS * 32) {
      const int j = e / width, c = e % width, key = k0 + j;
      float kval = 0.f, vval = 0.f;
      if (key < S) {
        if (c < dn) kval = kn[b * st.v[6] + key * st.v[7] + h * st.v[8] + c];
        else if (c < dk) kval = kr[b * st.v[12] + key * st.v[13] + c - dn];
        if (c < dv) vval = v[b * st.v[9] + key * st.v[10] + h * st.v[11] + c];
      }
      sk[j][c] = kval;
      sv[j][c] = vval;
    }
    __syncthreads();
    if (row >= S) continue;  // the whole warp: its shuffles stay full
    float sc[F32_KEYS], mx = m;
#pragma unroll
    for (int j = 0; j < F32_KEYS; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < F32_PER_LANE; ++i) {
        if (lane + 32 * i < dk) d = fmaf(q[i], sk[j][lane + 32 * i], d);
      }
      d = warp_sum(d);
      sc[j] = k0 + j <= row ? d * scale_log2 : -INFINITY;  // a row's later keys get weight 0
      mx = fmaxf(mx, sc[j]);
    }
    // the first stage holds key 0, so mx is finite from it on
    const float alpha = exp2f(m - mx);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < F32_PER_LANE; ++i) o[i] *= alpha;
#pragma unroll
    for (int j = 0; j < F32_KEYS; ++j) {
      const float p = exp2f(sc[j] - mx);
      l += p;
#pragma unroll
      for (int i = 0; i < F32_PER_LANE; ++i) {
        if (lane + 32 * i < dv) o[i] = fmaf(p, sv[j][lane + 32 * i], o[i]);
      }
    }
    m = mx;
  }
  if (row >= S) return;
#pragma unroll
  for (int i = 0; i < F32_PER_LANE; ++i) {
    const int c = lane + 32 * i;
    if (c < dv) out[((long long)b * S + row) * H * dv + (long long)h * dv + c] = o[i] / l;
  }
}

cudaError_t launch_f32(const Args& a, int dn, int dr, int dv, cudaStream_t stream) {
  if (dn < 0 || dr < 0 || dn + dr > F32_MAX_D || dv <= 0 || dv > F32_MAX_D || a.B * (long long)a.H > 65535)
    return cudaErrorInvalidValue;
  F32Strides st;
  for (int i = 0; i < 14; ++i) st.v[i] = a.strides[i];
  const dim3 grid((a.S + F32_ROWS - 1) / F32_ROWS, a.B * a.H);
  mla_prefill_f32_kernel<<<grid, F32_ROWS * 32, 0, stream>>>(
      static_cast<const float*>(a.q_nope), static_cast<const float*>(a.q_rope), static_cast<const float*>(a.k_nope),
      static_cast<const float*>(a.k_rope), static_cast<const float*>(a.v), static_cast<float*>(a.out), a.S, a.H, dn,
      dr, dv, st, a.scale * LOG2E);
  return cudaSuccess;
}

}  // namespace

// q_nope (B, S, H, dn), q_rope (B, S, H, dr), k_nope (B, S, H, dn), k_rope
// (B, S, dr), v (B, S, H, dv): bf16, unit stride along the last dim, every
// other stride a multiple of 8 elements, 16-byte aligned bases.  strides: the
// (b, s, h) strides of q_nope, q_rope, k_nope and v, then the (b, s) strides
// of k_rope, in elements (14 values).  out: (B, S, H, dv) bf16, contiguous.
// (dn, dr, dv) is (128, 64, 128) or (64, 32, 64).  Returns the launch's CUDA
// error (0 on success).
extern "C" int mla_prefill_launch(const void* q_nope, const void* q_rope, const void* k_nope, const void* k_rope,
                                  const void* v, void* out, int B, int S, int H, int dn, int dr, int dv,
                                  const long long* strides, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{q_nope, q_rope, k_nope, k_rope, v, out, B, S, H, strides, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dn == 128 && dr == 64 && dv == 128)
    err = launch<128, 64, 128>(a, s);
  else if (dn == 64 && dr == 32 && dv == 64)
    err = launch<64, 32, 64>(a, s);
  else
    err = cudaErrorInvalidValue;
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The f32 instance, with mla_prefill_launch's arguments: f32 operands, unit
// stride along the last dim, dn + dr and dv up to 256, B * H up to 65535; out
// (B, S, H, dv) f32, contiguous.  Returns the launch's CUDA error (0 on
// success).
extern "C" int mla_prefill_f32_launch(const void* q_nope, const void* q_rope, const void* k_nope,
                                      const void* k_rope, const void* v, void* out, int B, int S, int H, int dn,
                                      int dr, int dv, const long long* strides, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{q_nope, q_rope, k_nope, k_rope, v, out, B, S, H, strides, scale};
  const cudaError_t err = launch_f32(a, dn, dr, dv, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
