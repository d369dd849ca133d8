// DPPU scan probe for Hopper (sm_90a): flags = (AR != BAR + PR).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/dppu_recompute.py::probe_check (body _probe_kernel).
// For a row-block of the virtual PE array it recomputes the probe matmul
// (block_rows, K) @ (K, cols) with K = 8 small-int operands and compares it
// with the accumulators read back from the (possibly faulty) array.
//
// The accumulate is int32, exactly probe_check_ref's datapath (the TPU kernel
// used an f32 scratch only because its matrix unit wanted one).  Products and
// sums wrap mod 2^32 like the int32 accumulator; unsigned arithmetic keeps
// that defined.
//
// What bounds it here: the whole probe is a few hundred bytes and a few
// thousand integer operations, so its time is the launch itself.  One thread
// per (i, j) output loops over K; there is nothing to stage or reuse.
//
// So the scan step checks both halves of its complementary +/- probe pair in
// one launch (probe_check_pair_launch): flags = (AR != px @ pw) |
// (AR_neg != px @ (-pw)).  The weights are negated in the kernel, in unsigned
// arithmetic, element by element, as probe_check_ref on -pw computes it.
// empty_launch launches a kernel that does nothing: the card's launch floor,
// which is the practical bound of both probe kernels.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) probe_check_kernel(
    const int* __restrict__ px, const int* __restrict__ pw, const int* __restrict__ ar,
    int* __restrict__ flags, int B, int C, int K) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= B * C) return;
  const int i = idx / C, j = idx % C;
  unsigned acc = 0u;
  for (int k = 0; k < K; ++k)
    acc += static_cast<unsigned>(px[i * K + k]) * static_cast<unsigned>(pw[k * C + j]);
  flags[idx] = (static_cast<unsigned>(ar[idx]) != acc) ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS) probe_check_pair_kernel(
    const int* __restrict__ px, const int* __restrict__ pw, const int* __restrict__ ar,
    const int* __restrict__ ar_neg, int* __restrict__ flags, int B, int C, int K) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= B * C) return;
  const int i = idx / C, j = idx % C;
  unsigned acc = 0u, acc_neg = 0u;
  for (int k = 0; k < K; ++k) {
    const unsigned x = static_cast<unsigned>(px[i * K + k]);
    const unsigned w = static_cast<unsigned>(pw[k * C + j]);
    acc += x * w;
    acc_neg += x * (0u - w);
  }
  flags[idx] = (static_cast<unsigned>(ar[idx]) != acc || static_cast<unsigned>(ar_neg[idx]) != acc_neg) ? 1 : 0;
}

__global__ void empty_kernel() {}

}  // namespace

// px: (B, K), pw: (K, C), ar: (B, C), flags: (B, C); all int32, contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int probe_check_launch(const void* px, const void* pw, const void* ar, void* flags,
                                  int B, int C, int K, void* stream) {
  if (B > 0 && C > 0) {
    const int blocks = (B * C + THREADS - 1) / THREADS;
    probe_check_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(px), static_cast<const int*>(pw), static_cast<const int*>(ar),
        static_cast<int*>(flags), B, C, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// The pair: px (B, K), pw (K, C), ar and ar_neg (B, C), flags (B, C); all
// int32, contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int probe_check_pair_launch(const void* px, const void* pw, const void* ar, const void* ar_neg,
                                       void* flags, int B, int C, int K, void* stream) {
  if (B > 0 && C > 0) {
    const int blocks = (B * C + THREADS - 1) / THREADS;
    probe_check_pair_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(px), static_cast<const int*>(pw), static_cast<const int*>(ar),
        static_cast<const int*>(ar_neg), static_cast<int*>(flags), B, C, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of a kernel with no work, one thread.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
