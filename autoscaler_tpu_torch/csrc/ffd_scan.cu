// First-fit-decreasing scan over every node group at once, for Hopper
// (sm_90a). Two kernels from one template:
//
//   ffd_scan_f32   replaces ops/pallas_binpack.py::_scan_kernel (K1): f32
//                  free-capacity carry, fit test `req <= free`.
//   ffd_scan_swar  replaces ops/pallas_binpack.py::_scan_kernel_swar (K2):
//                  integer resource axes packed several to an int32 plane,
//                  fit test by guard bit `((free | g) - req) & g == g`.
//
// What they compute. Group g's pods arrive sorted by descending score as
// a stream [G, P_pad, NP] (inactive pods carry +inf, or the per-plane
// sentinel, and fit nowhere). The carry is free capacity [NP, M] per
// group plus `opened`. For each pod: first = the lowest node it fits; the
// pod is placed iff first < cap, and node `first` loses the request.
// Closed nodes all hold free == alloc, so node `opened` stands for every
// closed node: testing nodes 0..min(opened, M-1) decides both "first open
// node that fits" and "open a new node" (the argument of the comment in
// ops/pallas_binpack.py:201-212). Outputs: free [G, NP, M], opened [G] and
// placed [G, P_pad] (one byte a step).
//
// What bounds it on this card. Not bytes: the stream is read once (0.4 GB
// at the headline shape, ~0.12 ms at 3.35 TB/s). The bound is the chain of
// P dependent steps in each group: a step cannot start before the
// previous placement has updated the carry, and each step reads up to M
// nodes. 500 groups give only ~4 warps per SM, so nothing hides that
// latency.
//
// What the design does about it. One warp per group, the group's whole
// carry in shared memory (at most M * NP * 4 bytes, 16 KB at M=1024,
// NP=4), so a step touches no device memory. Lane l owns nodes l, l+32,
// ...; the warp tests 32 nodes at a time in node order and stops at the
// first 32-node block with a hit (__ballot_sync + __ffs), so a pod that
// fits early does not pay for the whole carry. Requests are staged 32
// steps at a time into shared memory with one coalesced load and read by
// broadcast; the placed bytes are written 32 at a time. The subtract is a
// select on the hit node only (never a multiply by a 0/1 flag: inf * 0 is
// NaN). There is no multiply in the f32 path at all, so no fused
// multiply-add can change a rounding; the build still passes
// --fmad=false. Later work: more groups per SM, cutting the serial step
// (wider node tests per lane, packed compares), prefetching the next
// request block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kNoNode = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

struct F32Fit {
  using T = float;
  __device__ static bool fits(float free, float req, uint32_t) {
    return req <= free;
  }
};

struct SwarFit {
  using T = int32_t;
  // Borrow-contained guard-bit test: the subtraction borrows out of
  // exactly the fields where free < req and clears their guard bit.
  __device__ static bool fits(int32_t free, int32_t req, uint32_t guard) {
    const uint32_t z = ((uint32_t)free | guard) - (uint32_t)req;
    return (z & guard) == guard;
  }
};

template <typename Fit>
__global__ void ffd_scan_kernel(
    const typename Fit::T* __restrict__ stream,  // [G, P_pad, NP]
    const typename Fit::T* __restrict__ allocs,  // [G, NP]
    const int32_t* __restrict__ caps,            // [G], already <= M
    const int32_t* __restrict__ guards,          // [NP] (SWAR) or null
    typename Fit::T* __restrict__ free_out,      // [G, NP, M]
    int32_t* __restrict__ opened_out,            // [G]
    uint8_t* __restrict__ placed_out,            // [G, P_pad]
    int P_pad, int NP, int M) {
  using T = typename Fit::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* free_s = reinterpret_cast<T*>(smem_raw);               // [NP, M]
  T* req_s = free_s + (size_t)NP * M;                       // [32, NP]
  uint32_t* guard_s = reinterpret_cast<uint32_t*>(req_s + kWarp * NP);

  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  for (int p = 0; p < NP; ++p) {
    const T a = allocs[(size_t)g * NP + p];
    for (int m = lane; m < M; m += kWarp) free_s[p * M + m] = a;
  }
  for (int p = lane; p < NP; p += kWarp) {
    guard_s[p] = guards ? (uint32_t)guards[p] : 0u;
  }
  __syncwarp();

  const int cap = caps[g];
  int opened = 0;
  const T* gstream = stream + (size_t)g * P_pad * NP;
  uint8_t* gplaced = placed_out + (size_t)g * P_pad;

  for (int base = 0; base < P_pad; base += kWarp) {
    const T* chunk = gstream + (size_t)base * NP;
    for (int i = lane; i < kWarp * NP; i += kWarp) req_s[i] = chunk[i];
    __syncwarp();
    uint8_t my_placed = 0;
    for (int s = 0; s < kWarp; ++s) {
      const T* req = req_s + s * NP;
      const int lim = min(opened, M - 1);
      int first = kNoNode;
      for (int k0 = 0; k0 <= lim; k0 += kWarp) {
        const int m = k0 + lane;
        bool ok = m <= lim;
        for (int p = 0; ok && p < NP; ++p) {
          ok = Fit::fits(free_s[p * M + m], req[p], guard_s[p]);
        }
        const unsigned hit = __ballot_sync(kFull, ok);
        if (hit) {
          first = k0 + __ffs(hit) - 1;
          break;
        }
      }
      const bool place = first < cap;
      if (place) {
        for (int p = lane; p < NP; p += kWarp) {
          free_s[p * M + first] = free_s[p * M + first] - req[p];
        }
        opened = max(opened, first + 1);
      }
      if (lane == s) my_placed = place ? 1 : 0;
      __syncwarp();
    }
    gplaced[base + lane] = my_placed;
  }

  T* gfree = free_out + (size_t)g * NP * M;
  for (int i = lane; i < NP * M; i += kWarp) gfree[i] = free_s[i];
  if (lane == 0) opened_out[g] = opened;
}

// Dynamic shared memory of one block: the carry [NP, M], 32 staged
// requests [32, NP] and the guards [NP], all 4-byte words (f32 or int32).
size_t smem_bytes(int NP, int M) {
  return ((size_t)NP * M + (size_t)kWarp * NP + (size_t)NP) * 4;
}

template <typename Fit>
int launch(const void* stream, const void* allocs, const void* caps,
           const void* guards, void* free_out, void* opened_out,
           void* placed_out, int G, int P_pad, int NP, int M,
           void* cuda_stream) {
  using T = typename Fit::T;
  static_assert(sizeof(T) == 4, "smem_bytes counts 4-byte words");
  if (G <= 0 || NP <= 0 || M <= 0 || P_pad % kWarp != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(NP, M);
  cudaError_t err = cudaFuncSetAttribute(
      ffd_scan_kernel<Fit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffd_scan_kernel<Fit><<<G, kWarp, smem, (cudaStream_t)cuda_stream>>>(
      static_cast<const T*>(stream), static_cast<const T*>(allocs),
      static_cast<const int32_t*>(caps), static_cast<const int32_t*>(guards),
      static_cast<T*>(free_out), static_cast<int32_t*>(opened_out),
      static_cast<uint8_t*>(placed_out), P_pad, NP, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared memory each launch requests a block, in bytes.
int ffd_scan_smem_bytes(int NP, int M) { return (int)smem_bytes(NP, M); }

int ffd_scan_f32(const void* stream, const void* allocs, const void* caps,
                 void* free_out, void* opened_out, void* placed_out, int G,
                 int P_pad, int NP, int M, void* cuda_stream) {
  return launch<F32Fit>(stream, allocs, caps, nullptr, free_out, opened_out,
                        placed_out, G, P_pad, NP, M, cuda_stream);
}

int ffd_scan_swar(const void* stream, const void* allocs, const void* caps,
                  const void* guards, void* free_out, void* opened_out,
                  void* placed_out, int G, int P_pad, int NP, int M,
                  void* cuda_stream) {
  return launch<SwarFit>(stream, allocs, caps, guards, free_out, opened_out,
                         placed_out, G, P_pad, NP, M, cuda_stream);
}

}  // extern "C"
