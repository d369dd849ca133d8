// Device marks of the port's model spans (obs/spans.py): one-thread kernels
// that do nothing.  A span launches its begin mark on entry and its end mark
// on exit, on the current stream, only while a profiler records, so that the
// span's bounds lie on the device timeline: the kernels the stream runs
// between the begin mark's end and the end mark's start are the span's.
// Span <s> has the kernels span_begin_<s> and span_end_<s> and the launcher
// <s>_mark_launch.
#include <cuda_runtime.h>

extern "C" __global__ void span_begin_attn_mla() {}
extern "C" __global__ void span_end_attn_mla() {}

// end: 0 the begin mark, 1 the end mark.  Returns cudaGetLastError() after
// the launch.
extern "C" int attn_mla_mark_launch(int end, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (end) {
    span_end_attn_mla<<<1, 1, 0, s>>>();
  } else {
    span_begin_attn_mla<<<1, 1, 0, s>>>();
  }
  return static_cast<int>(cudaGetLastError());
}
