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
// ops/pallas_binpack.py:201-212). A node at or past the cap can never be
// placed on, so the search stops at lim = min(opened, min(cap, M) - 1).
// Outputs: free [G, NP, M], opened [G] and placed [G, P_pad] (one byte a
// step).
//
// What bounds it on this card. Not bytes: the stream is read once (0.4 GB
// at the headline shape, ~0.12 ms at 3.35 TB/s), and not the node tests'
// arithmetic. The bound is the chain of P dependent steps in each group:
// a step cannot start before the previous placement has updated the
// carry. At the headline most groups reach their cap early, and from then
// on most pods fit nowhere: a search that walks every open node costs a
// serial scan of ~31 node blocks a step. All groups run at once, so the
// launch ends with its slowest group: one whose nodes run out of CPU and
// memory together, where block maxima prune least.
//
// What the design does about it, in three stages.
//  1. Several warps a group. One block of kWarps warps serves a group,
//     its whole carry in shared memory, so a step touches no device
//     memory. The search runs in rounds: in each, warp w tests the w-th
//     remaining candidate block of 32 nodes (node m on lane m % 32) and
//     finds its lowest hit with __ballot_sync + __ffs; one barrier
//     (__syncthreads_or) ends the round, and the lowest hit among the
//     warps' slots is `first`, because warps take candidates in node
//     order. Warp 0 applies the placement, then a second barrier makes it
//     visible before the next step.
//  2. Exact pruning by block maxima. summ [NP, ceil(M/32)] holds, per
//     plane (K1) or per packed field (K2), the maximum free capacity over
//     the block's nodes below the cap. A step first tests the pod against
//     the summaries of blocks 0..lim/32 (lane b takes block b, in passes
//     of 32 blocks); only the blocks that pass are searched. A node that
//     fits passes its block's summary, so the pruning never drops a hit:
//     the node tests alone still decide `first`. The summary of the hit
//     block is recomputed after each placement (warp 0, a warp max per
//     plane: an order-preserving key of the f32 bits, never an OR of
//     them, which can make NaN; for K2 a max per field, the fields read
//     off the guard bits), so it is exact at every step. Masked pods fail
//     every summary, as do pods that fit no block: such a step costs one
//     pass and no barrier.
//  3. A cheaper step. The NP planes of a node are loaded together and
//     then combined (no chain of short-circuited loads); the next 32
//     steps' requests are staged with cp.async into a second buffer while
//     the current 32 run; the placed bytes are written 32 at a time.
//
// Every branch that holds a barrier is uniform over the block: the
// candidates, `first`, `opened` and the placement are computed alike by
// every thread from shared memory that no thread writes between the
// barriers that bracket those reads. The subtract is a select on the hit
// node only (never a multiply by a 0/1 flag: inf * 0 is NaN). There is no
// multiply in the f32 path at all, so no fused multiply-add can change a
// rounding; the build still passes --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                 // warps a group (GROUP_WARPS in ops/ffd_scan.py)
constexpr int kThreads = kWarp * kWarps;
constexpr int kSteps = 32;                // steps staged at a time
constexpr int kNoNode = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

struct F32Fit {
  using T = float;
  __device__ static bool fits(float free, float req, uint32_t) {
    return req <= free;
  }
  // The maximum over the warp's lanes with `valid` set, exact for any
  // floats: a key that orders the f32 bits as the values order, NaN (which
  // fits nothing) and invalid lanes at key 0, which decodes to a NaN that
  // fits nothing.
  __device__ static float warp_max(float v, bool valid, uint32_t) {
    const uint32_t b = __float_as_uint(v);
    uint32_t key = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    if (!valid || v != v) key = 0u;
    key = __reduce_max_sync(kFull, key);
    return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
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
  // The field-wise maximum over the warp's lanes with `valid` set (0 for
  // none). The fields tile the plane from bit 0, each ending at its guard
  // bit, so the guards alone give every field's mask; the max of the
  // masked words is that field's max in place.
  __device__ static int32_t warp_max(int32_t v, bool valid, uint32_t guard) {
    const uint32_t x = valid ? (uint32_t)v : 0u;
    uint32_t out = 0u, low = 1u;
    for (uint32_t g = guard; g != 0u; g &= g - 1u) {
      const uint32_t top = g & (0u - g);
      out |= __reduce_max_sync(kFull, x & (top | (top - low)));
      low = top << 1;
    }
    return (int32_t)out;
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename Fit>
__global__ void __launch_bounds__(kThreads) ffd_scan_kernel(
    const typename Fit::T* __restrict__ stream,  // [G, P_pad, NP]
    const typename Fit::T* __restrict__ allocs,  // [G, NP]
    const int32_t* __restrict__ caps,            // [G], already <= M
    const int32_t* __restrict__ guards,          // [NP] (SWAR) or null
    typename Fit::T* __restrict__ free_out,      // [G, NP, M]
    int32_t* __restrict__ opened_out,            // [G]
    uint8_t* __restrict__ placed_out,            // [G, P_pad]
    int P_pad, int NP, int M) {
  using T = typename Fit::T;
  const int NB = (M + kWarp - 1) / kWarp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* free_s = reinterpret_cast<T*>(smem_raw);               // [NP, M]
  T* summ_s = free_s + (size_t)NP * M;                      // [NP, NB]
  T* req_s = summ_s + (size_t)NP * NB;                      // [2, kSteps, NP]
  uint32_t* guard_s = reinterpret_cast<uint32_t*>(req_s + 2 * kSteps * NP);
  int* slot_s = reinterpret_cast<int*>(guard_s + NP);       // [2, kWarps]

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int cap = caps[g];
  const int span = min(M, max(cap, 0));   // nodes that can ever be placed on
  const T* gstream = stream + (size_t)g * P_pad * NP;
  uint8_t* gplaced = placed_out + (size_t)g * P_pad;

  // the first request block, in flight while the carry is set up (an
  // empty stream has none)
  if (P_pad > 0) {
    for (int i = tid; i < kSteps * NP; i += kThreads) cp_async4(req_s + i, gstream + i);
  }
  cp_async_commit();
  for (int p = 0; p < NP; ++p) {
    const T a = allocs[(size_t)g * NP + p];
    for (int m = tid; m < M; m += kThreads) free_s[p * M + m] = a;
    // every block with a node below the cap holds alloc at its maximum;
    // the blocks past the cap are never searched
    for (int b = tid; b < NB; b += kThreads) summ_s[p * NB + b] = a;
  }
  for (int p = tid; p < NP; p += kThreads) {
    guard_s[p] = guards ? (uint32_t)guards[p] : 0u;
  }

  int opened = 0;
  int rounds = 0;   // its parity picks the slot buffer of a round
  for (int base = 0, buf = 0; base < P_pad; base += kSteps, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();   // this block's requests seen by all; the other buffer free
    if (base + kSteps < P_pad) {
      const T* next = gstream + (size_t)(base + kSteps) * NP;
      T* dst = req_s + (buf ^ 1) * kSteps * NP;
      for (int i = tid; i < kSteps * NP; i += kThreads) cp_async4(dst + i, next + i);
    }
    cp_async_commit();
    const T* reqs = req_s + buf * kSteps * NP;
    uint8_t my_placed = 0;
    for (int s = 0; s < kSteps; ++s) {
      const T* req = reqs + s * NP;
      int first = kNoNode;
      const int lim = min(opened, span - 1);   // -1 when the cap is 0
      const int nblk = lim < 0 ? 0 : lim / kWarp + 1;
      for (int q0 = 0; q0 < nblk && first == kNoNode; q0 += kWarp) {
        // the pass: lane b tests block q0 + b against its summary
        const int b = q0 + lane;
        const int bi = min(b, NB - 1);
        bool c = b < nblk;
#pragma unroll 4
        for (int p = 0; p < NP; ++p) {
          c &= Fit::fits(summ_s[p * NB + bi], req[p], guard_s[p]);
        }
        unsigned cand = __ballot_sync(kFull, c);
        while (cand != 0u) {
          // the round: warp w searches the w-th remaining candidate
          unsigned mine = cand;
          for (int i = 0; i < warp; ++i) mine &= mine - 1u;
          int hit_node = kNoNode;
          if (mine != 0u) {
            const int m0 = (q0 + __ffs(mine) - 1) * kWarp;
            const int m = m0 + lane;
            const int mi = min(m, lim);
            bool ok = m <= lim;
#pragma unroll 4
            for (int p = 0; p < NP; ++p) {
              ok &= Fit::fits(free_s[p * M + mi], req[p], guard_s[p]);
            }
            const unsigned hit = __ballot_sync(kFull, ok);
            if (hit != 0u) hit_node = m0 + __ffs(hit) - 1;
          }
          int* slots = slot_s + (rounds & 1) * kWarps;
          if (lane == 0) slots[warp] = hit_node;
          ++rounds;
          if (__syncthreads_or(hit_node != kNoNode)) {
            first = slots[0];
#pragma unroll
            for (int w = 1; w < kWarps; ++w) first = min(first, slots[w]);
            break;
          }
#pragma unroll
          for (int i = 0; i < kWarps; ++i) cand &= cand - 1u;
        }
      }
      // first <= lim < span <= cap whenever a node fits: it is placed
      const bool place = first != kNoNode;
      if (place) {
        if (warp == 0) {
          for (int p = lane; p < NP; p += kWarp) {
            free_s[p * M + first] = free_s[p * M + first] - req[p];
          }
          __syncwarp();
          const int b = first / kWarp;
          const int m = b * kWarp + lane;
          const int mi = min(m, M - 1);
          for (int p = 0; p < NP; ++p) {
            const T mx = Fit::warp_max(free_s[p * M + mi], m < span, guard_s[p]);
            if (lane == 0) summ_s[p * NB + b] = mx;
          }
        }
        opened = max(opened, first + 1);
        __syncthreads();   // the placement seen by all before the next step
      }
      if (lane == s) my_placed = place ? 1 : 0;
    }
    if (warp == 0) gplaced[base + lane] = my_placed;
  }

  __syncthreads();
  T* gfree = free_out + (size_t)g * NP * M;
  for (int i = tid; i < NP * M; i += kThreads) gfree[i] = free_s[i];
  if (tid == 0) opened_out[g] = opened;
}

// Dynamic shared memory of one block: the carry [NP, M], the block
// summaries [NP, ceil(M/32)], two staged request blocks [2, 32, NP], the
// guards [NP] and two rounds' hit slots [2, kWarps], all 4-byte words.
size_t smem_bytes(int NP, int M) {
  const size_t NB = ((size_t)M + kWarp - 1) / kWarp;
  return ((size_t)NP * M + (size_t)NP * NB + 2 * (size_t)kSteps * NP +
          (size_t)NP + 2 * (size_t)kWarps) * 4;
}

template <typename Fit>
int launch(const void* stream, const void* allocs, const void* caps,
           const void* guards, void* free_out, void* opened_out,
           void* placed_out, int G, int P_pad, int NP, int M,
           void* cuda_stream) {
  using T = typename Fit::T;
  static_assert(sizeof(T) == 4, "smem_bytes counts 4-byte words");
  if (G <= 0 || NP <= 0 || M <= 0 || P_pad < 0 || P_pad % kSteps != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(NP, M);
  cudaError_t err = cudaFuncSetAttribute(
      ffd_scan_kernel<Fit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffd_scan_kernel<Fit><<<G, kThreads, smem, (cudaStream_t)cuda_stream>>>(
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
