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
// A second entry, `fit_reduce_rows`, runs the same body with the class
// test replaced by a given [S, N] bool row a pod: the exact patch's rows
// of the few pods whose verdicts the class factors get wrong. Its slots
// vector marks padding rows (a negative slot): they are never read, and
// count nothing.
//
// What bounds it on this card. Not bytes: the operands are read once (about
// 4 MB for 100k pods x 15k nodes x 6 resources, ~1 us at 3.35 TB/s). The
// work is the pairs: 1.5 G of them at that shape, each a class test and up
// to R compares, ~10 G operations, ~0.15 ms at 67 T operations/s. So it is
// bound by operations, and the instructions a pair issues decide its time.
// The first design (one pod a thread, free staged [R, tile]) issued ~8
// shared-memory loads a pair: a warp re-read every node's R values and its
// class byte for each of its 32 pods, and the load/store unit, at about
// one wavefront a clock, held it to ~4 pairs a clock an SM.
//
// What the design does about it. Each thread holds kPods pods, so a staged
// node serves kPods pairs a load: a tile of kTile nodes is staged
// node-major, each node a record of its free values and one gate word,
// rounded up to 16-byte words and read as broadcast loads. The class test
// leaves shared memory: when CN <= 32 each pod holds its class row as a
// 32-bit mask in a register, and each node's gate word is the bit of its
// class (0 when the node is invalid or classless), so the test is one AND
// of two registers; the rows entry stages its rows as bits, one word a pod
// for 32 nodes, and tests a bit of that word. A pair's verdict sets a bit
// of a per-pod word, and each word of 32 nodes adds its popcount to the
// count and its lowest bit to the first node, so the reduction costs one
// predicated multiply-add a pair, issued on the FMA pipe while the gate
// test and the compares fill the ALU pipe (the pipe that bounds the loop:
// moving the bit off it gained 19% on the card). Compares that cannot
// fail are left out: a resource
// whose smallest free value over the tile's nodes (those whose gate can
// pass) is at least the block's largest request of it is dead in that
// tile, and the records and requests are compacted to the live resources,
// with the live count a template of the inner loop (order-preserving keys
// make the test exact; a NaN keeps its resource live). Nodes pad to whole
// tiles with gates that never pass, and blocks whose pods are all padding
// (class -1, or beyond P) leave before staging anything. Above R = 8 or
// CN = 32 a generic path compares every resource and keeps the byte lookup
// of the class mask (staged when at most 16 KB, read through the cache
// otherwise). The Pallas grid's sequential node axis carried the sums
// across grid steps; here the node axis is split over a second grid axis
// so that the card has several waves of blocks, and the blocks of one pod
// merge their partial results with atomicAdd on the count and atomicMin on
// the first index, into outputs the wrapper zeroes (count 0, first
// INT_MAX). Integer atomics commute, so the result is exact and the same
// on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // threads a block
constexpr int kPods = 4;                  // pods a thread
constexpr int kBlockPods = kThreads * kPods;
constexpr int kTile = 256;                // nodes staged a tile
constexpr int kWords = kTile / 32;        // gate words of a row tile
constexpr int kMaskSmemBytes = 16384;     // class masks up to this go to shared memory
constexpr int kMaxBitClasses = 32;        // node classes a pod's register mask holds
constexpr int kNoNode = 0x7fffffff;
constexpr int kWaves = 4;                 // waves of blocks the node split aims for
constexpr int kMaxRegR = 8;               // resources the compacting kernel takes
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kNodesPerThread = kTile / kThreads;  // nodes a thread stages a tile

// The three ways a pair is gated.
enum Gate { kClassBits = 0, kClassBytes = 1, kRows = 2 };

bool mask_in_smem(int CP, int CN) {
  return (long long)CP * CN <= kMaskSmemBytes;
}

// Words of one staged node record: R free values and the gate word.
__host__ __device__ constexpr int record_words(int R) { return (R + 1 + 3) / 4 * 4; }

// Dynamic shared memory of one block: the node records [kTile, RW] words,
// the request rows [R, kBlockPods] f32, the class mask bytes when the byte
// lookup stages them, and the rows entry's row bits [kWords, kBlockPods].
size_t smem_bytes(int R, int CP, int CN, Gate gate) {
  size_t bytes = (size_t)kTile * record_words(R) * 4 + (size_t)R * kBlockPods * 4;
  if (gate == kClassBytes && mask_in_smem(CP, CN)) bytes += (size_t)CP * CN;
  if (gate == kRows) bytes += (size_t)kWords * kBlockPods * 4;
  return bytes;
}

// Stage the row bits of the block's pods for the tile [n0, n0 + tn):
// rows_s[w * kBlockPods + i] bit b = rows[p_i, n0 + 32 w + b] != 0, zero
// past the tile's end, for pods beyond S and for padding slots (slots[p]
// < 0), whose rows are not read.
__device__ void stage_row_bits(const uint8_t* __restrict__ rows,
                               const int32_t* __restrict__ slots, uint32_t* rows_s,
                               int pod0, int S, int N, int n0, int tn) {
  for (int i = threadIdx.x; i < kWords * kBlockPods; i += kThreads) {
    const int slot = i / kWords;
    const int w = i - slot * kWords;
    const int p = pod0 + slot;
    const int j0 = w * 32;
    uint32_t bits = 0;
    if (p < S && j0 < tn && slots[p] >= 0) {
      const uint8_t* src = rows + (size_t)p * N + n0 + j0;
      if (j0 + 32 <= tn && ((reinterpret_cast<uintptr_t>(src) & 15) == 0)) {
        const uint4* v = reinterpret_cast<const uint4*>(src);
        const uint4 a = v[0], b = v[1];
        const uint32_t words[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          // one bit a nonzero byte: the bytes' low bits gathered into a nibble
          const uint32_t ones = __vcmpne4(words[k], 0u) & 0x01010101u;
          bits |= ((ones * 0x01020408u) >> 24) << (4 * k);
        }
      } else {
        for (int b = 0; b < 32 && j0 + b < tn; ++b) bits |= (src[b] != 0 ? 1u : 0u) << b;
      }
    }
    rows_s[w * kBlockPods + slot] = bits;
  }
}

// Order-preserving keys of f32 values: key(a) <= key(b) implies a <= b
// for values that are not NaN. A NaN request keys above every value and a
// NaN free capacity below, so a resource with one is never found dead.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ uint32_t req_key(float x) {
  return x != x ? 0xffffffffu : order_key(x);
}
__device__ __forceinline__ uint32_t free_key(float x) {
  return x != x ? 0u : order_key(x);
}

// The class gate of the pods a thread holds, set up once a block: their
// activity (a class in range; for the rows entry, a row that is not a
// padding slot, where pod_class holds the slots), a register
// mask over the node classes (kClassBits) or a pointer to their row of
// mask bytes (kClassBytes). Returns false when the whole block is padding.
template <int GATE>
__device__ bool setup_pods(const int32_t* __restrict__ pod_class,
                           const uint8_t* cmask, int P, int CP, int CN,
                           int (&p)[kPods], bool (&active)[kPods],
                           uint32_t (&pmask)[kPods], const uint8_t* (&crow)[kPods]) {
  const int pod0 = blockIdx.x * kBlockPods;
  bool any = false;
#pragma unroll
  for (int q = 0; q < kPods; ++q) {
    p[q] = pod0 + q * kThreads + threadIdx.x;
    int pc = 0;
    if (GATE == kRows) {
      active[q] = p[q] < P && pod_class[p[q]] >= 0;
    } else {
      pc = p[q] < P ? pod_class[p[q]] : -1;
      active[q] = pc >= 0 && pc < CP;
    }
    any |= active[q];
    pmask[q] = 0;
    crow[q] = cmask;
    if (GATE == kClassBits && active[q]) {
      for (int c = 0; c < CN; ++c) {
        pmask[q] |= (cmask[(size_t)pc * CN + c] != 0 ? 1u : 0u) << c;
      }
    }
    if (GATE == kClassBytes && active[q]) crow[q] = cmask + (size_t)pc * CN;
  }
  return __syncthreads_or(any) != 0;
}

// One pair's verdict into its bit of the pod's word: hits += bit (each
// bit is set once, so the add is an OR) when (g & sel) != 0 and req[s] <=
// rec[s] for every s < NL (ordered compares, so a NaN fails, as in C).
// Written in PTX so that the verdict stays in a predicate register and
// lands as one predicated multiply-add by ``one`` (1, but not to the
// compiler): the gate test and the compares fill the ALU pipe, and the
// add goes to the FMA pipe beside them.
template <int NL>
__device__ __forceinline__ void mark_pair(uint32_t& hits, uint32_t g, uint32_t sel,
                                          uint32_t bit, const float* req, const float* rec,
                                          uint32_t one);

// the gate test into the predicate p; then NL compares and-ed into it
// (operands %5, %6 for the first, %7, %8 for the second, ...); then the add
#define FIT_PAIR_HEAD \
  "{\n .reg .pred p;\n .reg .b32 t;\n and.b32 t, %1, %2;\n setp.ne.b32 p, t, 0;\n"
#define FIT_CMP(a, b) " setp.le.and.f32 p, %" #a ", %" #b ", p;\n"
#define FIT_PAIR_TAIL " @p mad.lo.u32 %0, %3, %4, %0;\n}"
#define FIT_REQ(k) , "f"(req[k]), "f"(rec[k])
#define FIT_MARK_PAIR(NL, CMPS, REQS)                                                  \
  template <>                                                                         \
  __device__ __forceinline__ void mark_pair<NL>(uint32_t& hits, uint32_t g,           \
                                                uint32_t sel, uint32_t bit,           \
                                                const float* req, const float* rec,   \
                                                uint32_t one) {                       \
    asm(FIT_PAIR_HEAD CMPS FIT_PAIR_TAIL                                              \
        : "+r"(hits)                                                                  \
        : "r"(g), "r"(sel), "r"(bit), "r"(one) REQS);                                 \
  }
FIT_MARK_PAIR(0, "", )
FIT_MARK_PAIR(1, FIT_CMP(5, 6), FIT_REQ(0))
FIT_MARK_PAIR(2, FIT_CMP(5, 6) FIT_CMP(7, 8), FIT_REQ(0) FIT_REQ(1))
FIT_MARK_PAIR(3, FIT_CMP(5, 6) FIT_CMP(7, 8) FIT_CMP(9, 10), FIT_REQ(0) FIT_REQ(1) FIT_REQ(2))
FIT_MARK_PAIR(4, FIT_CMP(5, 6) FIT_CMP(7, 8) FIT_CMP(9, 10) FIT_CMP(11, 12),
              FIT_REQ(0) FIT_REQ(1) FIT_REQ(2) FIT_REQ(3))
FIT_MARK_PAIR(5, FIT_CMP(5, 6) FIT_CMP(7, 8) FIT_CMP(9, 10) FIT_CMP(11, 12) FIT_CMP(13, 14),
              FIT_REQ(0) FIT_REQ(1) FIT_REQ(2) FIT_REQ(3) FIT_REQ(4))
FIT_MARK_PAIR(6, FIT_CMP(5, 6) FIT_CMP(7, 8) FIT_CMP(9, 10) FIT_CMP(11, 12) FIT_CMP(13, 14)
                     FIT_CMP(15, 16),
              FIT_REQ(0) FIT_REQ(1) FIT_REQ(2) FIT_REQ(3) FIT_REQ(4) FIT_REQ(5))
FIT_MARK_PAIR(7, FIT_CMP(5, 6) FIT_CMP(7, 8) FIT_CMP(9, 10) FIT_CMP(11, 12) FIT_CMP(13, 14)
                     FIT_CMP(15, 16) FIT_CMP(17, 18),
              FIT_REQ(0) FIT_REQ(1) FIT_REQ(2) FIT_REQ(3) FIT_REQ(4) FIT_REQ(5) FIT_REQ(6))
FIT_MARK_PAIR(8, FIT_CMP(5, 6) FIT_CMP(7, 8) FIT_CMP(9, 10) FIT_CMP(11, 12) FIT_CMP(13, 14)
                     FIT_CMP(15, 16) FIT_CMP(17, 18) FIT_CMP(19, 20),
              FIT_REQ(0) FIT_REQ(1) FIT_REQ(2) FIT_REQ(3) FIT_REQ(4) FIT_REQ(5) FIT_REQ(6)
                  FIT_REQ(7))
#undef FIT_MARK_PAIR
#undef FIT_REQ
#undef FIT_PAIR_TAIL
#undef FIT_CMP
#undef FIT_PAIR_HEAD

// The scan of one staged tile by the pods of a thread, with NL live
// resources: node records of RW words (the NL live free values, then the
// gate word), and the pods' live requests in creq. Each pair's verdict
// sets a bit of the pod's word for 32 nodes; each word adds its popcount
// to the count and its lowest bit to the first node.
template <int NL, int GATE>
__device__ __forceinline__ void scan_tile(const float* rec_s, const uint32_t* rows_s,
                                          const float (&creq)[kPods][kMaxRegR],
                                          const uint32_t (&pmask)[kPods], int n0,
                                          int (&count)[kPods], int (&first)[kPods]) {
  constexpr int RW = record_words(NL);
  const int tid = threadIdx.x;
  const uint32_t one = blockDim.x / kThreads;  // 1, unknown to the compiler
  for (int w = 0; w < kWords; ++w) {
    uint32_t g[kPods];
    uint32_t hits[kPods];
#pragma unroll
    for (int q = 0; q < kPods; ++q) {
      g[q] = GATE == kRows ? rows_s[w * kBlockPods + q * kThreads + tid] : pmask[q];
      hits[q] = 0;
    }
    uint32_t bit = 1;
#pragma unroll 8
    for (int jj = 0; jj < 32; ++jj) {
      const float* rp = rec_s + (w * 32 + jj) * RW;
      float rec[RW];
#pragma unroll
      for (int k = 0; k < RW; k += 4) {
        const float4 v = *reinterpret_cast<const float4*>(rp + k);
        rec[k] = v.x;
        rec[k + 1] = v.y;
        rec[k + 2] = v.z;
        rec[k + 3] = v.w;
      }
      const uint32_t sel = GATE == kRows ? bit : __float_as_uint(rec[NL]);
#pragma unroll
      for (int q = 0; q < kPods; ++q) mark_pair<NL>(hits[q], g[q], sel, bit, creq[q], rec, one);
      bit <<= 1;
    }
#pragma unroll
    for (int q = 0; q < kPods; ++q) {
      if (hits[q] != 0) {
        count[q] += __popc(hits[q]);
        first[q] = min(first[q], n0 + w * 32 + __ffs(hits[q]) - 1);
      }
    }
  }
}

// R <= kMaxRegR resources, the gate kClassBits or kRows. Each tile is
// staged in three steps: every thread reads the free rows of its nodes
// into registers and keeps the per-resource minimum (as a key) over the
// nodes whose gate can pass; a barrier; then a resource whose minimum is
// at least the block's largest request (of its live pods) is dead in this
// tile, every compare on it would pass, and the records and requests are
// compacted to the live resources; a barrier; then the scan, with the
// live count NL a template.
template <int GATE>
__global__ void __launch_bounds__(kThreads) fit_reduce_kernel(
    const float* __restrict__ pod_req,        // [P, R]
    const float* __restrict__ free_cap,       // [N, R]
    const int32_t* __restrict__ pod_class,    // [P] (class gate; kRows: the slots)
    const int32_t* __restrict__ node_class,   // [N] (class gate)
    const uint8_t* __restrict__ class_mask,   // [CP, CN] (class gate)
    const uint8_t* __restrict__ node_valid,   // [N] (class gate)
    const uint8_t* __restrict__ rows,         // [P, N] (kRows)
    int32_t* __restrict__ count_out,          // [P], zeroed by the caller
    int32_t* __restrict__ first_out,          // [P], INT_MAX from the caller
    int P, int N, int R, int CP, int CN, int tiles_per_split, int stage_mask) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rec_s = reinterpret_cast<float*>(smem_raw);                       // [kTile, RW]
  float* req_s = rec_s + (size_t)kTile * record_words(R);                  // [R, kBlockPods]
  uint32_t* rows_s = reinterpret_cast<uint32_t*>(req_s + (size_t)R * kBlockPods);
  __shared__ uint32_t maxkey_s[kWarpsPerBlock][kMaxRegR];
  __shared__ uint32_t minkey_s[kWarpsPerBlock][kMaxRegR];

  const int num_tiles = (N + kTile - 1) / kTile;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tile1 = min(tile0 + tiles_per_split, num_tiles);
  if (tile0 >= tile1) return;  // the whole block: no barrier is skipped

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int p[kPods];
  bool active[kPods];
  uint32_t pmask[kPods];
  const uint8_t* crow[kPods];
  // a block of padding pods stages nothing
  if (!setup_pods<GATE>(pod_class, class_mask, P, CP, CN, p, active, pmask, crow)) return;

  // the requests in shared memory, and the block's largest request of
  // each resource (as a key) over its live pods
  uint32_t mx[kMaxRegR];
#pragma unroll
  for (int r = 0; r < kMaxRegR; ++r) mx[r] = 0;
#pragma unroll
  for (int q = 0; q < kPods; ++q) {
#pragma unroll
    for (int r = 0; r < kMaxRegR; ++r) {
      if (r < R) {
        const float v = active[q] ? pod_req[(size_t)p[q] * R + r] : 0.0f;
        req_s[r * kBlockPods + q * kThreads + tid] = v;
        if (active[q]) mx[r] = max(mx[r], req_key(v));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRegR; ++r) {
    if (r < R) {
      const uint32_t m = __reduce_max_sync(0xffffffffu, mx[r]);
      if (lane == 0) maxkey_s[warp][r] = m;
    }
  }

  int count[kPods];
  int first[kPods];
  float creq[kPods][kMaxRegR];
#pragma unroll
  for (int q = 0; q < kPods; ++q) {
    count[q] = 0;
    first[q] = kNoNode;
#pragma unroll
    for (int r = 0; r < kMaxRegR; ++r) creq[q][r] = 0.0f;
  }
  uint32_t built = 0xffffffffu;  // the live set creq holds (none yet)

  for (int t = tile0; t < tile1; ++t) {
    const int n0 = t * kTile;
    const int tn = min(kTile, N - n0);
    __syncthreads();  // every thread is done with the previous tile
    // each thread's nodes: free rows in registers, the gate, the minima
    float fr[kNodesPerThread][kMaxRegR];
    uint32_t gate[kNodesPerThread];
    uint32_t mn[kMaxRegR];
#pragma unroll
    for (int r = 0; r < kMaxRegR; ++r) mn[r] = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < kNodesPerThread; ++i) {
      const int j = i * kThreads + tid;
      bool can_pass = j < tn;
      gate[i] = 0;
      if (GATE == kClassBits && j < tn) {
        const int c = node_class[n0 + j];
        can_pass = node_valid[n0 + j] != 0 && c >= 0 && c < CN;
        gate[i] = can_pass ? 1u << c : 0u;
      }
#pragma unroll
      for (int r = 0; r < kMaxRegR; ++r) {
        fr[i][r] = 0.0f;
        if (r < R && j < tn) fr[i][r] = free_cap[(size_t)(n0 + j) * R + r];
        if (can_pass) mn[r] = min(mn[r], free_key(fr[i][r]));
      }
    }
    if (GATE == kRows) {
      stage_row_bits(rows, pod_class, rows_s, blockIdx.x * kBlockPods, P, N, n0, tn);
    }
#pragma unroll
    for (int r = 0; r < kMaxRegR; ++r) {
      if (r < R) {
        const uint32_t m = __reduce_min_sync(0xffffffffu, mn[r]);
        if (lane == 0) minkey_s[warp][r] = m;
      }
    }
    __syncthreads();
    // the live resources of this tile, alike in every thread
    uint32_t live = 0;
#pragma unroll
    for (int r = 0; r < kMaxRegR; ++r) {
      if (r < R) {
        uint32_t hi = 0, lo = 0xffffffffu;
#pragma unroll
        for (int k = 0; k < kWarpsPerBlock; ++k) {
          hi = max(hi, maxkey_s[k][r]);
          lo = min(lo, minkey_s[k][r]);
        }
        if (hi > lo) live |= 1u << r;
      }
    }
    const int NL = __popc(live);
    const int RW = record_words(NL);
#pragma unroll
    for (int i = 0; i < kNodesPerThread; ++i) {
      float* dst = rec_s + (i * kThreads + tid) * RW;
#pragma unroll
      for (int r = 0; r < kMaxRegR; ++r) {
        if ((live >> r) & 1u) dst[__popc(live & ((1u << r) - 1u))] = fr[i][r];
      }
      reinterpret_cast<uint32_t*>(dst)[NL] = gate[i];
    }
    if (live != built) {
#pragma unroll
      for (int s = 0; s < kMaxRegR; ++s) {
        if (s < NL) {
          const int r = __fns(live, 0, s + 1);
#pragma unroll
          for (int q = 0; q < kPods; ++q) creq[q][s] = req_s[r * kBlockPods + q * kThreads + tid];
        }
      }
      built = live;
    }
    __syncthreads();
    switch (NL) {
#define FIT_REDUCE_SCAN(K) \
  case K:                  \
    scan_tile<K, GATE>(rec_s, rows_s, creq, pmask, n0, count, first); \
    break;
      FIT_REDUCE_SCAN(0)
      FIT_REDUCE_SCAN(1)
      FIT_REDUCE_SCAN(2)
      FIT_REDUCE_SCAN(3)
      FIT_REDUCE_SCAN(4)
      FIT_REDUCE_SCAN(5)
      FIT_REDUCE_SCAN(6)
      FIT_REDUCE_SCAN(7)
      FIT_REDUCE_SCAN(8)
#undef FIT_REDUCE_SCAN
      default:
        break;
    }
  }
#pragma unroll
  for (int q = 0; q < kPods; ++q) {
    if (count[q] > 0) {
      atomicAdd(&count_out[p[q]], count[q]);
      atomicMin(&first_out[p[q]], first[q]);
    }
  }
}

// The generic path: any R, the requests in shared memory, the gate
// kClassBytes (the byte lookup of the class mask, staged in shared memory
// when it is small) or kRows; every resource compared.
template <int GATE>
__global__ void __launch_bounds__(kThreads) fit_reduce_generic(
    const float* __restrict__ pod_req, const float* __restrict__ free_cap,
    const int32_t* __restrict__ pod_class, const int32_t* __restrict__ node_class,
    const uint8_t* __restrict__ class_mask, const uint8_t* __restrict__ node_valid,
    const uint8_t* __restrict__ rows, int32_t* __restrict__ count_out,
    int32_t* __restrict__ first_out, int P, int N, int R, int CP, int CN,
    int tiles_per_split, int stage_mask) {
  const int RW = record_words(R);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rec_s = reinterpret_cast<float*>(smem_raw);                    // [kTile, RW]
  float* req_s = rec_s + (size_t)kTile * RW;                             // [R, kBlockPods]
  unsigned char* tail = reinterpret_cast<unsigned char*>(req_s + (size_t)R * kBlockPods);
  uint32_t* rows_s = reinterpret_cast<uint32_t*>(tail);                  // [kWords, kBlockPods]
  uint8_t* mask_s = tail;                                                // [CP, CN]

  const int num_tiles = (N + kTile - 1) / kTile;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tile1 = min(tile0 + tiles_per_split, num_tiles);
  if (tile0 >= tile1) return;  // the whole block: no barrier is skipped

  const int tid = threadIdx.x;
  const uint8_t* cmask = class_mask;
  if (GATE == kClassBytes && stage_mask) {
    for (int i = tid; i < CP * CN; i += kThreads) mask_s[i] = class_mask[i];
    cmask = mask_s;  // read after the first tile's barrier below
  }
  int p[kPods];
  bool active[kPods];
  uint32_t pmask[kPods];
  const uint8_t* crow[kPods];
  if (!setup_pods<GATE>(pod_class, cmask, P, CP, CN, p, active, pmask, crow)) return;
#pragma unroll
  for (int q = 0; q < kPods; ++q) {
    for (int r = 0; r < R; ++r) {
      req_s[r * kBlockPods + q * kThreads + tid] =
          active[q] ? pod_req[(size_t)p[q] * R + r] : 0.0f;
    }
  }
  int count[kPods];
  int first[kPods];
#pragma unroll
  for (int q = 0; q < kPods; ++q) {
    count[q] = 0;
    first[q] = kNoNode;
  }
  for (int t = tile0; t < tile1; ++t) {
    const int n0 = t * kTile;
    const int tn = min(kTile, N - n0);
    __syncthreads();  // every thread is done with the previous tile
    const float* src = free_cap + (size_t)n0 * R;
    for (int i = tid; i < kTile * R; i += kThreads) {
      const int n = i / R;
      rec_s[n * RW + (i - n * R)] = n < tn ? src[i] : 0.0f;
    }
    if (GATE == kRows) {
      stage_row_bits(rows, pod_class, rows_s, blockIdx.x * kBlockPods, P, N, n0, tn);
    } else {
      for (int j = tid; j < kTile; j += kThreads) {
        int code = -1;
        if (j < tn) {
          const int c = node_class[n0 + j];
          code = (node_valid[n0 + j] != 0 && c >= 0 && c < CN) ? c : -1;
        }
        reinterpret_cast<int32_t*>(rec_s)[j * RW + R] = code;
      }
    }
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      const float* rec = rec_s + j * RW;
      const int code = __float_as_int(rec[R]);
#pragma unroll
      for (int q = 0; q < kPods; ++q) {
        bool ok = GATE == kRows
                      ? ((rows_s[(j >> 5) * kBlockPods + q * kThreads + tid] >> (j & 31)) & 1u) != 0
                      : active[q] && code >= 0 && crow[q][code >= 0 ? code : 0] != 0;
        for (int r = 0; r < R; ++r) ok &= req_s[r * kBlockPods + q * kThreads + tid] <= rec[r];
        if (ok) {
          count[q] += 1;
          first[q] = min(first[q], n0 + j);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kPods; ++q) {
    if (count[q] > 0) {
      atomicAdd(&count_out[p[q]], count[q]);
      atomicMin(&first_out[p[q]], first[q]);
    }
  }
}

// The launch geometry: pod blocks on grid.x, and the node tiles split over
// grid.y until the card holds kWaves waves of blocks (per_sm resident a
// multiprocessor). → (splits, tiles a split); grid.x is the pod blocks.
void split_nodes(int P, int N, int sms, int per_sm, int* splits_out, int* per_split_out) {
  const int pod_blocks = (P + kBlockPods - 1) / kBlockPods;
  const int num_tiles = (N + kTile - 1) / kTile;
  const long long target = (long long)sms * max(per_sm, 1) * kWaves;
  const int want = (int)((target + pod_blocks - 1) / pod_blocks);
  const int splits = max(1, min(want, num_tiles));
  const int tiles_per_split = (num_tiles + splits - 1) / splits;
  *per_split_out = tiles_per_split;
  *splits_out = (num_tiles + tiles_per_split - 1) / tiles_per_split;
}

// The card's multiprocessors and the kernel's resident blocks on each.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, size_t smem, int* sms, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
}

// Set the kernel's shared memory, split the nodes and launch; with
// geometry != nullptr, only report {grid.x, grid.y, blocks an SM}.
template <typename Kernel>
int launch(Kernel kernel, size_t smem, const void* pod_req, const void* free_cap,
           const void* pod_class, const void* node_class, const void* class_mask,
           const void* node_valid, const void* rows, void* count_out,
           void* first_out, int P, int N, int R, int CP, int CN,
           cudaStream_t stream, int* geometry) {
  int sms = 0, per_sm = 0, splits = 0, tiles_per_split = 0;
  cudaError_t err = occupancy(kernel, smem, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  split_nodes(P, N, sms, per_sm, &splits, &tiles_per_split);
  const dim3 grid((P + kBlockPods - 1) / kBlockPods, splits);
  if (geometry != nullptr) {
    geometry[0] = (int)grid.x;
    geometry[1] = (int)grid.y;
    geometry[2] = per_sm;
    return 0;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(pod_req), static_cast<const float*>(free_cap),
      static_cast<const int32_t*>(pod_class),
      static_cast<const int32_t*>(node_class),
      static_cast<const uint8_t*>(class_mask),
      static_cast<const uint8_t*>(node_valid),
      static_cast<const uint8_t*>(rows), static_cast<int32_t*>(count_out),
      static_cast<int32_t*>(first_out), P, N, R, CP, CN, tiles_per_split,
      mask_in_smem(CP, CN) ? 1 : 0);
  return (int)cudaGetLastError();
}

// The gate a launch takes: the rows entry's, register masks when the node
// classes fit a word and R fits the compacting kernel, else the byte lookup.
Gate launch_gate(bool by_rows, int R, int CN) {
  if (by_rows) return kRows;
  return (R <= kMaxRegR && CN <= kMaxBitClasses) ? kClassBits : kClassBytes;
}

int dispatch(bool by_rows, const void* pod_req, const void* free_cap,
             const void* pod_class, const void* node_class,
             const void* class_mask, const void* node_valid, const void* rows,
             void* count_out, void* first_out, int P, int N, int R, int CP,
             int CN, cudaStream_t s, int* geometry = nullptr) {
  const Gate gate = launch_gate(by_rows, R, CN);
  const size_t smem = smem_bytes(R, CP, CN, gate);
#define FIT_REDUCE_LAUNCH(KERNEL)                                              \
  return launch(KERNEL, smem, pod_req, free_cap, pod_class, node_class,         \
                class_mask, node_valid, rows, count_out, first_out, P, N, R,    \
                CP, CN, s, geometry)
  if (R <= kMaxRegR) {
    if (gate == kRows) FIT_REDUCE_LAUNCH(fit_reduce_kernel<kRows>);
    if (gate == kClassBits) FIT_REDUCE_LAUNCH(fit_reduce_kernel<kClassBits>);
  }
  if (gate == kRows) FIT_REDUCE_LAUNCH(fit_reduce_generic<kRows>);
  FIT_REDUCE_LAUNCH(fit_reduce_generic<kClassBytes>);
#undef FIT_REDUCE_LAUNCH
}

}  // namespace

extern "C" {

// The dynamic shared memory a class-gated launch requests a block, in bytes.
int fit_reduce_smem_bytes(int R, int CP, int CN) {
  return (int)smem_bytes(R, CP, CN, launch_gate(false, R, CN));
}

// The dynamic shared memory a rows launch requests a block, in bytes.
int fit_reduce_rows_smem_bytes(int R) {
  return (int)smem_bytes(R, 0, 0, kRows);
}

// The geometry a launch of P pods (rows when by_rows) over N nodes takes:
// out = {grid.x, grid.y, resident blocks an SM}. Launches nothing.
int fit_reduce_geometry(int P, int N, int R, int CP, int CN, int by_rows, int* out) {
  if (P <= 0 || N <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  return dispatch(by_rows != 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, P, N, R, CP, CN, nullptr, out);
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
  return dispatch(false, pod_req, free_cap, pod_class, node_class, class_mask,
                  node_valid, nullptr, count_out, first_out, P, N, R, CP, CN,
                  (cudaStream_t)cuda_stream);
}

// The same reduction with the class test replaced by rows[s, n] (bool
// bytes, [S, N] row-major): count and first of all_r(req[s] <= free[n])
// & rows[s, n]. slots ([S] i32) marks padding rows with a negative value:
// their rows are not read and they count nothing, and a block of them
// leaves at once. The outputs as for fit_reduce.
int fit_reduce_rows(const void* pod_req, const void* free_cap,
                    const void* rows, const void* slots, void* count_out,
                    void* first_out, int S, int N, int R, void* cuda_stream) {
  if (S <= 0 || N <= 0 || R <= 0 || slots == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(true, pod_req, free_cap, slots, nullptr, nullptr, nullptr,
                  rows, count_out, first_out, S, N, R, 0, 0,
                  (cudaStream_t)cuda_stream);
}

}  // extern "C"
