// Ordered scatter-add for Hopper (sm_90a): K5 of the port, the VPA
// histogram bank's sample ingestion (autoscaler_tpu_torch/vpa/histogram.py
// `HistogramBank.add_samples`). It is not the twin of a TPU kernel: the JAX
// package runs that update as XLA's scatter-add (`.at[flat].add`,
// autoscaler_tpu/vpa/histogram.py:111-119).
//
// What it computes. For a flat f32 target and K (index, value) pairs,
//
//   target[i] = ((target[i] + v_a) + v_b) + ...
//
// over the pairs whose index is i, in the order the pairs were given. That
// is the order XLA:CPU's scatter adds duplicates in (a serial loop over the
// updates), so the port's bank holds the same bits as the JAX package's.
// An atomicAdd per pair would add the duplicates of a cell in whatever order
// the threads reach it, and f32 addition does not associate.
//
// How. The wrapper sorts the indices stably on the card (torch.sort with
// stable=True): equal indices form one contiguous segment, in the pairs'
// original order, and `order` maps each sorted slot to its pair. Thread j
// looks at sorted slot j; unless it heads its segment (slot 0, or an index
// unlike the previous slot's) it leaves at once. The head reads the
// target's cell once, adds the segment's values in order, and writes the
// cell once. Segments are disjoint, so no two threads touch one cell and
// the result is the same on every run. Indices outside [0, N) are dropped,
// as XLA's scatter drops them. The add is `__fadd_rn`, which the compiler
// may not contract or reorder.
//
// What bounds it. Bytes: it reads each pair's index, order and value once
// and each touched cell once, and writes each touched cell once. The
// longest segment is a serial chain of dependent adds, each behind a load
// of its value through `order`; on a bank where one cell takes thousands of
// samples that chain, not the bytes, sets the time. Making it fast (a
// segmented scan across a warp that keeps the order) is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void ordered_scatter_add_kernel(float* __restrict__ target,
                                           const int* __restrict__ keys,
                                           const int64_t* __restrict__ order,
                                           const float* __restrict__ values,
                                           int K, int N) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= K) return;
  const int key = keys[j];
  if (j > 0 && keys[j - 1] == key) return;  // not the head of its segment
  if (key < 0 || key >= N) return;          // dropped, as XLA drops it
  float acc = target[key];
  for (int i = j; i < K && keys[i] == key; ++i) {
    acc = __fadd_rn(acc, values[order[i]]);
  }
  target[key] = acc;
}

}  // namespace

extern "C" {

// target [N] f32, keys [K] i32 sorted stably, order [K] i64 (the sort's
// permutation: sorted slot -> pair), values [K] f32 in the pairs' order.
// Returns the CUDA error of the launch (0 on success).
int ordered_scatter_add(void* target, const void* keys, const void* order,
                        const void* values, int K, int N, void* cuda_stream) {
  if (K <= 0) return 0;
  const int blocks = (K + kThreads - 1) / kThreads;
  ordered_scatter_add_kernel<<<blocks, kThreads, 0, (cudaStream_t)cuda_stream>>>(
      static_cast<float*>(target), static_cast<const int*>(keys),
      static_cast<const int64_t*>(order), static_cast<const float*>(values), K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
