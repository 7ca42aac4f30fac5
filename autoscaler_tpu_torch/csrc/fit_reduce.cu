// Tiled predicate fit with an online reduction over the nodes, for Hopper
// (sm_90a). Replaces autoscaler_tpu/ops/pallas_fit.py:78 `_kernel` (K4),
// dispatched there by `pallas_fit_reduce`.
//
// What it computes. For each pod p, over every node n:
//
//   fits[p, n] = all_r(req[p, r] <= free[n, r])
//                & class_mask[pod_class[p], node_class[n]] & node_valid[n]
//
// where a pod class outside [0, CP) or a node class outside [0, CN) never
// fits (the Pallas kernel's one-hot rows are zero there). It never holds
// the [P, N] matrix: each pod's verdicts are reduced as they are made, to
// count[p] (the number of nodes it fits) and first[p] (the lowest such
// node). The only float operation is `req <= free`, which is exact: +inf
// never fits, -0.0 equals 0.0, and negative free capacity simply fails.
//
// What bounds it on this card. Not bytes: the operands are read once (about
// 4 MB for 100k pods x 15k nodes x 6 resources, ~1 us at 3.35 TB/s). The
// work is the pairs: 1.5 G of them at that shape, each a class lookup and
// up to R compares, ~10 G operations, ~0.15 ms at 67 T operations/s. So it
// is bound by operations, and the instructions a pair costs decide its
// time.
//
// What the design does about it. One pod a thread, 128 pods a block, the
// pod's request row in registers (a template on R for R <= 8; above that
// the rows sit in shared memory and R is a loop bound). Nodes are staged
// in tiles of 256 in shared memory: free capacity transposed to
// [R, 256] (one coalesced read of the tile's [256, R] block) and one int
// per node holding its class, or -1 when the node is invalid or classless,
// so the inner loop reads only broadcast words. The class mask is a few
// hundred bytes (profile counts, bucketed to powers of two) and sits in
// shared memory too when it is at most 16 KB; a larger one is read from
// device memory through the cache. The pair test has no branch: the class
// bit and the R compares are and-ed. The Pallas grid's sequential node
// axis carried the sums across grid steps; here the node axis is split
// over a second grid axis so that the card has enough blocks in flight
// when pods are few, and the blocks of one pod merge their partial results
// with atomicAdd on the count and atomicMin on the first index, into
// outputs the wrapper zeroes (count 0, first INT_MAX). Integer atomics
// commute, so the result is exact and the same on every run. Later work:
// several pods a thread (fewer shared-memory reads a pair), packed
// compares, skipping node tiles whose classes the pod cannot take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // pods a block, one a thread
constexpr int kTile = 256;                // nodes staged a tile
constexpr int kMaskSmemBytes = 16384;     // class masks up to this go to shared memory
constexpr int kNoNode = 0x7fffffff;
constexpr int kBlocksPerSm = 16;          // 2048 threads an SM at 128 a block

bool mask_in_smem(int CP, int CN) {
  return (long long)CP * CN <= kMaskSmemBytes;
}

// Dynamic shared memory of one block: free [R, kTile] f32, node codes
// [kTile] i32, request rows [R, kThreads] f32 (the generic-R path only)
// and the class mask bytes when they are staged.
size_t smem_bytes(int R, int CP, int CN) {
  const bool generic = R > 8;
  size_t bytes = (size_t)R * kTile * 4 + (size_t)kTile * 4;
  if (generic) bytes += (size_t)R * kThreads * 4;
  if (mask_in_smem(CP, CN)) bytes += (size_t)CP * CN;
  return bytes;
}

// RT > 0: R = RT, the request row in registers; RT == 0: R = R_dyn, the
// request rows in shared memory.
template <int RT>
__global__ void fit_reduce_kernel(
    const float* __restrict__ pod_req,        // [P, R]
    const float* __restrict__ free_cap,       // [N, R]
    const int32_t* __restrict__ pod_class,    // [P]
    const int32_t* __restrict__ node_class,   // [N]
    const uint8_t* __restrict__ class_mask,   // [CP, CN]
    const uint8_t* __restrict__ node_valid,   // [N]
    int32_t* __restrict__ count_out,          // [P], zeroed by the caller
    int32_t* __restrict__ first_out,          // [P], INT_MAX from the caller
    int P, int N, int R_dyn, int CP, int CN, int tiles_per_split,
    int stage_mask) {
  const int R = RT > 0 ? RT : R_dyn;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* free_s = reinterpret_cast<float*>(smem_raw);                  // [R, kTile]
  int32_t* code_s = reinterpret_cast<int32_t*>(free_s + (size_t)R * kTile);  // [kTile]
  float* req_s = reinterpret_cast<float*>(code_s + kTile);             // [R, kThreads]
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(
      req_s + (RT > 0 ? 0 : (size_t)R * kThreads));                   // [CP, CN]

  const int num_tiles = (N + kTile - 1) / kTile;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tile1 = min(tile0 + tiles_per_split, num_tiles);
  if (tile0 >= tile1) return;  // the whole block: no barrier is skipped

  const int tid = threadIdx.x;
  const int p = blockIdx.x * kThreads + tid;

  const uint8_t* cmask = class_mask;
  if (stage_mask) {
    for (int i = tid; i < CP * CN; i += kThreads) mask_s[i] = class_mask[i];
    cmask = mask_s;  // read after the first tile's barrier below
  }

  int pc = p < P ? pod_class[p] : -1;
  const bool active = pc >= 0 && pc < CP;
  const uint8_t* crow = cmask + (size_t)(active ? pc : 0) * CN;

  float req[RT > 0 ? RT : 1];
  if (RT > 0) {
#pragma unroll
    for (int r = 0; r < (RT > 0 ? RT : 1); ++r) {
      req[r] = active ? pod_req[(size_t)p * R + r] : 0.0f;
    }
  } else {
    for (int r = 0; r < R; ++r) {
      req_s[r * kThreads + tid] = active ? pod_req[(size_t)p * R + r] : 0.0f;
    }
  }

  int count = 0;
  int first = kNoNode;
  for (int t = tile0; t < tile1; ++t) {
    const int n0 = t * kTile;
    const int tn = min(kTile, N - n0);
    __syncthreads();  // every thread is done with the previous tile
    const float* src = free_cap + (size_t)n0 * R;
    for (int i = tid; i < tn * R; i += kThreads) {
      const int n = i / R;
      free_s[(i - n * R) * kTile + n] = src[i];
    }
    for (int j = tid; j < tn; j += kThreads) {
      const int c = node_class[n0 + j];
      code_s[j] = (node_valid[n0 + j] != 0 && c >= 0 && c < CN) ? c : -1;
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < tn; ++j) {
      const int c = code_s[j];
      bool ok = c >= 0 && crow[c >= 0 ? c : 0] != 0;
      if (RT > 0) {
#pragma unroll
        for (int r = 0; r < (RT > 0 ? RT : 1); ++r) {
          ok &= req[r] <= free_s[r * kTile + j];
        }
      } else {
        for (int r = 0; r < R; ++r) {
          ok &= req_s[r * kThreads + tid] <= free_s[r * kTile + j];
        }
      }
      count += ok ? 1 : 0;
      first = min(first, ok ? n0 + j : kNoNode);
    }
  }
  if (active && count > 0) {
    atomicAdd(&count_out[p], count);
    atomicMin(&first_out[p], first);
  }
}

template <int RT>
int launch(const void* pod_req, const void* free_cap, const void* pod_class,
           const void* node_class, const void* class_mask,
           const void* node_valid, void* count_out, void* first_out, int P,
           int N, int R, int CP, int CN, cudaStream_t stream) {
  const size_t smem = smem_bytes(R, CP, CN);
  cudaError_t err = cudaFuncSetAttribute(
      fit_reduce_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // split the node tiles over grid.y until the card holds enough blocks
  const int pod_blocks = (P + kThreads - 1) / kThreads;
  const int num_tiles = (N + kTile - 1) / kTile;
  const int want = (sms * kBlocksPerSm + pod_blocks - 1) / pod_blocks;
  int splits = max(1, min(want, num_tiles));
  const int tiles_per_split = (num_tiles + splits - 1) / splits;
  splits = (num_tiles + tiles_per_split - 1) / tiles_per_split;
  const dim3 grid(pod_blocks, splits);
  fit_reduce_kernel<RT><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(pod_req), static_cast<const float*>(free_cap),
      static_cast<const int32_t*>(pod_class),
      static_cast<const int32_t*>(node_class),
      static_cast<const uint8_t*>(class_mask),
      static_cast<const uint8_t*>(node_valid), static_cast<int32_t*>(count_out),
      static_cast<int32_t*>(first_out), P, N, R, CP, CN, tiles_per_split,
      mask_in_smem(CP, CN) ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared memory a launch requests a block, in bytes.
int fit_reduce_smem_bytes(int R, int CP, int CN) {
  return (int)smem_bytes(R, CP, CN);
}

// count_out must hold zeros and first_out INT_MAX; afterwards a pod that
// fits nowhere keeps count 0 and first INT_MAX.
int fit_reduce(const void* pod_req, const void* free_cap,
               const void* pod_class, const void* node_class,
               const void* class_mask, const void* node_valid,
               void* count_out, void* first_out, int P, int N, int R, int CP,
               int CN, void* cuda_stream) {
  if (P <= 0 || N <= 0 || R <= 0 || CP < 0 || CN < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)cuda_stream;
#define FIT_REDUCE_CASE(RT)                                                  \
  case RT:                                                                   \
    return launch<RT>(pod_req, free_cap, pod_class, node_class, class_mask, \
                      node_valid, count_out, first_out, P, N, R, CP, CN, s);
  switch (R) {
    FIT_REDUCE_CASE(1)
    FIT_REDUCE_CASE(2)
    FIT_REDUCE_CASE(3)
    FIT_REDUCE_CASE(4)
    FIT_REDUCE_CASE(5)
    FIT_REDUCE_CASE(6)
    FIT_REDUCE_CASE(7)
    FIT_REDUCE_CASE(8)
    default:
      return launch<0>(pod_req, free_cap, pod_class, node_class, class_mask,
                       node_valid, count_out, first_out, P, N, R, CP, CN, s);
  }
#undef FIT_REDUCE_CASE
}

}  // extern "C"
