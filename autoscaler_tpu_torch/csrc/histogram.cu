// Ordered scatter-add for Hopper (sm_90a): K5 of the port, the VPA
// histogram bank's sample ingestion (autoscaler_tpu_torch/vpa/histogram.py
// `HistogramBank.add_samples`).
//
// What it replaces. No TPU kernel: the JAX package runs this update as
// XLA's scatter-add (`.at[flat].add`, autoscaler_tpu/vpa/histogram.py:111-119),
// which XLA:CPU runs as a serial loop over the updates with subnormals
// flushed (DAZ and FTZ). For a flat f32 target and K (index, value) pairs
//
//   target[i] = ftz(ftz(ftz(target[i]) + v_a) + v_b) + ...
//
// over the pairs whose index is i, in the order the pairs were given, every
// operand read with subnormals as zeros of their sign and every partial sum
// flushed the same way. Indices outside [0, N) are dropped and touch
// nothing. Cells no pair names keep their bits, subnormal or not. f32
// addition does not associate, so each cell's sum is a serial chain in pair
// order: a warp tree, a segmented scan of the values, float atomics or chunk
// partials combined afterwards would all give other bits. The add is
// `add.rn.ftz.f32` in inline PTX, which the compiler neither contracts nor
// reorders; integer atomics count and place the pairs, which is exact, and
// their order does not matter once a segment's order is restored.
//
// What bounds it. Bytes: each pair's index and value read once, each touched
// cell read and written once (the grouping's scratch moves a few times K
// more). And the chain: a cell's Lmax samples are Lmax dependent adds, ~6.5
// cycles each from shared memory on this card, 6 528 of them on the warm
// start's `total` target (300 series of ~6 400 samples each); no design
// that keeps the order goes under it. The old design's costs were a stable
// sort of the K pairs (half its time), one thread a segment behind global
// loads, and four flush passes around each call in the bank.
//
// The design, one launch of each kernel below on the caller's stream, no
// sort of the K pairs and no float atomics:
//
// 1. `count_kernel`: one int32 count a cell, warp-aggregated atomics
//    (`__match_any_sync`: one atomic a cell a 32-pair chunk).
// 2. `scan_kernel`: one pass over the N counts with a decoupled look-back
//    across tiles (a warp reads 32 tiles' flags at once): each cell's start,
//    and the touched cells compacted, in cell order, into segment records
//    {cell, start, length}.
// 3. `place_kernel`: each pair's word (position << 32 | value bits) into
//    its cell's segment. A chunk's pairs of one cell take consecutive slots
//    from one atomic, in lane order: a segment is a list of runs, one for
//    each chunk that names the cell, each run in pair order, the runs in no
//    fixed order.
// 4. `warp_chain_kernel`: a warp a segment of up to kWarpMax pairs (the
//    next segment's record loaded ahead). The words are loaded at once,
//    coalesced; a run starts where the chunk changes; the runs' headers
//    (chunk, offset, length) are sorted in registers (bitonic over shuffles:
//    a run each, not a word each), the values copied to shared memory in
//    pair order, and lane 0 chains them from there, never behind a global
//    load. Longer segments are handed on.
// 5. `block_chain_kernel`: a block a longer segment, the same steps block
//    wide (its headers sorted in shared memory), up to kBlockMax pairs and
//    kRunMax runs. Past them (`spill_chain`), the block sorts the
//    segment's own words by position: tiles of kTile words in shared
//    memory, then merge passes between the words and a second copy in the
//    scratch, O(L log L) in the segment's length whatever the batch's; the
//    sorted values come back through shared memory a tile at a time for the
//    chain.
//
// Segments are disjoint, so no two chains touch one cell, and the result is
// the same on every run. A touched cell's first add reads it flushed and
// its last add writes it flushed, so the bank needs no flush pass of its
// own around the call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // count, scan and place blocks
constexpr int kScanItems = 16;         // cells a scan thread takes
constexpr int kScanTile = kThreads * kScanItems;
constexpr int kWarpMax = 512;          // the longest segment a warp orders
constexpr int kChainWarps = 4;         // warps of a warp_chain_kernel block
constexpr int kBlockThreads = 256;
constexpr int kBlockMax = 8192;        // the longest segment a block orders
constexpr int kRunMax = 4096;          // the most runs it sorts
constexpr int kBlockSmem = kBlockMax * 4 + kRunMax * 8;
constexpr int kTile = kBlockSmem / 8;  // the words spill_chain sorts in shared memory
constexpr int kMergeItems = 32;        // the outputs a thread merges
constexpr int kBlocksPerSm = 3;        // so that ~400 long segments run at once
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPad = ~0ull;  // sorts after every word

// meta's words: the scan's tile ticket, the number of segments, the long
// list's length
enum : int { kTicket = 0, kSegments = 1, kLong = 2, kMetaWords = 3 };

__host__ __device__ __forceinline__ long long lesser(long long a, long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <typename I>
__device__ __forceinline__ int cell_of(const I* index, long long k, int N) {
  const long long x = static_cast<long long>(index[k]);
  return (x >= 0 && x < N) ? static_cast<int>(x) : -1;
}

// acc + the value bits of v[0] + ... + of v[L-1] (a word's low half), in
// order, by one thread.
template <typename W>
__device__ float chain(float acc, const W* v, int L) {
  for (int r = 0; r < L; ++r) acc = add_ftz(acc, __uint_as_float(static_cast<unsigned>(v[r])));
  return acc;
}

// Sorts s[0..P) ascending (P a power of two) in shared memory with
// `threads` threads, the caller's `rank`-th among them; `sync` orders the
// stages.
template <typename Sync>
__device__ void bitonic(unsigned long long* s, int P, int rank, int threads, Sync sync) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = rank; i < (P >> 1); i += threads) {
        const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = s[lo], b = s[hi];
        if ((a > b) == ((lo & size) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      sync();
    }
  }
}

// Sorts a warp's 32 * E words ascending in registers (bitonic): word g sits
// in lane g % 32, register g / 32; strides under 32 cross lanes by shuffle,
// longer ones swap a lane's own registers.
template <int E>
__device__ void warp_sort(unsigned long long (&v)[E], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int g = j * 32 + lane;
        const bool up = (g & size) == 0;
        if (stride >= 32) {
          const int o = j ^ (stride >> 5);
          if (o > j) {
            const unsigned long long a = v[j], b = v[o];
            const bool swap = (a > b) == up;
            v[j] = swap ? b : a;
            v[o] = swap ? a : b;
          }
        } else {
          const unsigned long long p = __shfl_xor_sync(kFull, v[j], stride);
          const bool keep_min = ((g & stride) == 0) == up;
          v[j] = keep_min == (v[j] < p) ? v[j] : p;
        }
      }
    }
  }
}

// Lanes of a warp whose pairs name one cell: `peers`, led by its lowest
// lane; `__match_any_sync` groups them, so one atomic serves a group.
template <typename I>
__global__ void count_kernel(const I* __restrict__ index, int K, int N, int* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long base = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x - lane);
       base < K; base += warps * 32) {
    const long long k = base + lane;
    const int cell = k < K ? cell_of(index, k, N) : -1;
    const unsigned peers = __match_any_sync(kFull, cell);
    if (cell >= 0 && lane == __ffs(peers) - 1) atomicAdd(&cnt[cell], __popc(peers));
  }
}

// Each pair's word (position << 32 | value bits) into its cell's segment: a
// warp's group of one cell takes consecutive slots, in lane order, from one
// atomic on the cell's cursor. So a segment is a list of runs, one for each
// 32-pair chunk (k / 32) that names the cell, each run in pair order, the
// runs in no fixed order.
template <typename I>
__global__ void place_kernel(const I* __restrict__ index, const float* __restrict__ values,
                             int K, int N, int* __restrict__ cursor,
                             unsigned long long* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long base = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x - lane);
       base < K; base += warps * 32) {
    const long long k = base + lane;
    const int cell = k < K ? cell_of(index, k, N) : -1;
    const unsigned peers = __match_any_sync(kFull, cell);
    const int leader = __ffs(peers) - 1;
    int slot = 0;
    if (cell >= 0 && lane == leader) slot = atomicAdd(&cursor[cell], __popc(peers));
    slot = __shfl_sync(kFull, slot, leader) + __popc(peers & ((1u << lane) - 1u));
    if (cell >= 0) {
      words[slot] = (static_cast<unsigned long long>(k) << 32) | __float_as_uint(values[k]);
    }
  }
}

// One exclusive prefix over the block's threads of a 64-bit value; the
// block's total into *total. All threads call it.
__device__ unsigned long long block_exclusive(unsigned long long v, unsigned long long* total) {
  __shared__ unsigned long long warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  unsigned long long x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned long long s = lane < nwarps ? warp_sums[lane] : 0ull;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const unsigned long long before = (warp > 0 ? warp_sums[warp - 1] : 0ull) + x - v;
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return before;
}

__device__ __forceinline__ unsigned long long packed(int c) {
  return static_cast<unsigned long long>(c) | (static_cast<unsigned long long>(c > 0) << 32);
}

// Each cell's packed (count, touched) = count | (count > 0) << 32 is
// prefix-summed over the N cells: the low half gives the cell's start, the
// high half its segment's number. Tiles take their number from a ticket
// (so every earlier tile has started), publish their own total at once,
// and find their prefix by looking back over 32 tiles at a time: the
// nearest tile with its prefix published, plus the totals after it.
__global__ void scan_kernel(const int* __restrict__ cnt, int N, int* __restrict__ cursor,
                            int4* __restrict__ segs, int* meta, volatile int* flags,
                            volatile unsigned long long* aggregates,
                            volatile unsigned long long* inclusives) {
  __shared__ int tile_s;
  __shared__ unsigned long long prefix_s;
  if (threadIdx.x == 0) tile_s = atomicAdd(&meta[kTicket], 1);
  __syncthreads();
  const int tile = tile_s;
  const long long first = static_cast<long long>(tile) * kScanTile + threadIdx.x * kScanItems;
  int c[kScanItems];
  if (first + kScanItems <= N) {
    const int4* q = reinterpret_cast<const int4*>(cnt + first);
#pragma unroll
    for (int j = 0; j < kScanItems / 4; ++j) {
      const int4 v = q[j];
      c[4 * j] = v.x;
      c[4 * j + 1] = v.y;
      c[4 * j + 2] = v.z;
      c[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) c[j] = first + j < N ? cnt[first + j] : 0;
  }
  unsigned long long mine = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) mine += packed(c[j]);
  unsigned long long total;
  unsigned long long before = block_exclusive(mine, &total);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0) {
      (tile == 0 ? inclusives : aggregates)[tile] = total;
      __threadfence();
      flags[tile] = tile == 0 ? 2 : 1;
    }
    unsigned long long prefix = 0;
    for (int end = tile; end > 0; end -= 32) {
      const int j = end - 32 + lane;
      int f = 2;
      unsigned long long v = 0;
      if (j >= 0) {
        while ((f = flags[j]) == 0) {
        }
        __threadfence();
        v = f == 2 ? inclusives[j] : aggregates[j];
      }
      const unsigned done = __ballot_sync(kFull, f == 2);
      // from the highest lane whose tile has its prefix, up
      const int from = done ? 31 - __clz(done) : 0;
      v = lane >= from ? v : 0ull;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
      prefix += v;
      if (done) break;
    }
    if (lane == 0) {
      if (tile > 0) {
        inclusives[tile] = prefix + total;
        __threadfence();
        flags[tile] = 2;
      }
      if (tile == gridDim.x - 1) meta[kSegments] = static_cast<int>((prefix + total) >> 32);
      prefix_s = prefix;
    }
  }
  __syncthreads();
  before += prefix_s;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    if (first + j < N) {
      const int at = static_cast<int>(before & 0xffffffffull);
      cursor[first + j] = at;
      if (c[j] > 0) segs[before >> 32] = make_int4(static_cast<int>(first + j), at, c[j], 0);
    }
    before += packed(c[j]);
  }
}

// A run's header: (chunk << 32) | (offset in the segment << 16) | length.
// No two runs of a segment share a chunk, and a chunk's pairs come before
// the next chunk's, so sorting the headers puts the runs, and so the
// segment, in pair order.
__device__ __forceinline__ unsigned long long run_header(unsigned long long chunk, int off,
                                                         int len) {
  return (chunk << 32) | (static_cast<unsigned>(off) << 16) | static_cast<unsigned>(len);
}

__device__ __forceinline__ unsigned long long chunk_of(unsigned long long word) {
  return word >> 37;  // the position's 32-pair chunk
}

// A warp's R <= 32 * E run headers hs[0..R), sorted in registers; the runs'
// values copied from ws (the segment's words) to out in pair order. out
// may alias hs.
template <int E>
__device__ void warp_order(const unsigned long long* hs, int R, const unsigned long long* ws,
                           unsigned* out, int lane) {
  unsigned long long v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = j * 32 + lane < R ? hs[j * 32 + lane] : kPad;
  warp_sort<E>(v, lane);
  __syncwarp();
  int at = 0;  // the values of the runs in registers before j's, over all lanes
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int len = j * 32 + lane < R ? static_cast<int>(v[j] & 0xffffu) : 0;
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int off = static_cast<int>((v[j] >> 16) & 0xffffu);
    for (int t = 0; t < len; ++t) out[at + incl - len + t] = static_cast<unsigned>(ws[off + t]);
    at += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();
}

// A warp a segment of 2 <= L <= kWarpMax words: the words loaded at once
// and kept in shared memory, the runs' headers found (a run starts where
// the chunk changes) and sorted, the values copied out in pair order, lane
// 0's chain.
__device__ void warp_segment(float* target, int cell, int start, int L, float before,
                             const unsigned long long* words, unsigned long long* ws,
                             unsigned long long* hs, int lane) {
  constexpr int kPer = kWarpMax / 32;
  unsigned long long w[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = j * 32 + lane;
    w[j] = e < L ? words[start + e] : 0ull;
  }
  int R = 0;
  unsigned long long last = 0;  // the chunk before this 32's first word
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j * 32 >= L) break;
    const int e = j * 32 + lane;
    if (e < L) ws[e] = w[j];
    const unsigned long long chunk = chunk_of(w[j]);
    unsigned long long prev = __shfl_up_sync(kFull, chunk, 1);
    if (lane == 0) prev = last;
    const bool head = e < L && (e == 0 || chunk != prev);
    const unsigned heads = __ballot_sync(kFull, head);
    if (head) hs[R + __popc(heads & ((1u << lane) - 1u))] = run_header(chunk, e, 0);
    R += __popc(heads);
    last = __shfl_sync(kFull, chunk, 31);
  }
  __syncwarp();
  // each run's length: the words after its first that share its chunk
  for (int h = lane; h < R; h += 32) {
    const unsigned long long chunk = hs[h] >> 32;
    const int off = static_cast<int>((hs[h] >> 16) & 0xffffu);
    int len = 1;
    while (off + len < L && chunk_of(ws[off + len]) == chunk) ++len;
    hs[h] = run_header(chunk, off, len);
  }
  __syncwarp();
  unsigned* out = reinterpret_cast<unsigned*>(hs);
  if (R <= 32) {
    warp_order<1>(hs, R, ws, out, lane);
  } else if (R <= 64) {
    warp_order<2>(hs, R, ws, out, lane);
  } else if (R <= 128) {
    warp_order<4>(hs, R, ws, out, lane);
  } else if (R <= 256) {
    warp_order<8>(hs, R, ws, out, lane);
  } else {
    warp_order<16>(hs, R, ws, out, lane);
  }
  if (lane == 0) target[cell] = chain(before, out, L);
  __syncwarp();
}

// A warp a segment, the next segment's record loaded ahead. Segments past
// kWarpMax go on the long list.
__global__ void __launch_bounds__(kChainWarps * 32)
warp_chain_kernel(float* __restrict__ target, const int4* __restrict__ segs,
                  const unsigned long long* __restrict__ words, int* meta,
                  int* __restrict__ long_list) {
  __shared__ unsigned long long words_s[kChainWarps][kWarpMax];
  __shared__ unsigned long long runs_s[kChainWarps][kWarpMax];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int S = meta[kSegments];
  const int warps = gridDim.x * kChainWarps;
  int seg = blockIdx.x * kChainWarps + w;
  int4 next = seg < S ? segs[seg] : make_int4(0, 0, 0, 0);
  for (; seg < S; seg += warps) {
    const int4 rec = next;  // {cell, start, length, 0}
    if (seg + warps < S) next = segs[seg + warps];
    const int cell = rec.x, start = rec.y, L = rec.z;
    if (L > kWarpMax) {
      if (lane == 0) long_list[atomicAdd(&meta[kLong], 1)] = seg;
      continue;
    }
    const float before = target[cell];
    if (L == 1) {
      if (lane == 0) {
        target[cell] = add_ftz(before, __uint_as_float(static_cast<unsigned>(words[start])));
      }
      continue;
    }
    warp_segment(target, cell, start, L, before, words, words_s[w], runs_s[w], lane);
  }
}

// The number of words of A[0..na) among the first d of A and B[0..nb)
// merged (merge path; no two words are equal).
__device__ int merge_split(const unsigned long long* A, int na, const unsigned long long* B,
                           int nb, int d) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (A[mid] < B[d - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A segment too long, or in too many runs, for long_chain's shared memory:
// its L words at w sorted by position, which is pair order, and chained.
// Tiles of kTile words are sorted in shared memory (bitonic) and merged
// pairwise between w and spare (L words of scratch of its own), each
// thread merging kMergeItems outputs from its merge-path split; then the
// sorted values come back through shared memory a tile at a time for
// thread 0's chain. Its cost is O(L log L) in the segment's own words.
__device__ void spill_chain(float* target, int cell, unsigned long long* w,
                            unsigned long long* spare, int L, unsigned long long* s) {
  const int tiles = (L + kTile - 1) / kTile;
  for (int t = 0; t < tiles; ++t) {
    const int n = min(kTile, L - t * kTile);
    int P = 2;
    while (P < n) P <<= 1;
    for (int i = threadIdx.x; i < P; i += blockDim.x) s[i] = i < n ? w[t * kTile + i] : kPad;
    __syncthreads();
    bitonic(s, P, threadIdx.x, blockDim.x, []() { __syncthreads(); });
    if (tiles == 1) {
      if (threadIdx.x == 0) target[cell] = chain(target[cell], s, L);
      __syncthreads();
      return;
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) w[t * kTile + i] = s[i];
    __syncthreads();
  }
  unsigned long long *src = w, *dst = spare;
  for (long long width = kTile; width < L; width <<= 1) {
    // 2 * width is a multiple of kMergeItems, so no thread's outputs
    // straddle two merges
    for (int d0 = threadIdx.x * kMergeItems; d0 < L; d0 += blockDim.x * kMergeItems) {
      const int a0 = static_cast<int>(d0 / (2 * width) * (2 * width));
      const int na = static_cast<int>(lesser(width, L - a0));
      const int nb = static_cast<int>(lesser(width, L - a0 - na));
      const unsigned long long* A = src + a0;
      const unsigned long long* B = A + na;
      int i = merge_split(A, na, B, nb, d0 - a0), j = d0 - a0 - i;
      for (int e = 0; e < kMergeItems && d0 + e < a0 + na + nb; ++e) {
        const bool take_a = j >= nb || (i < na && A[i] < B[j]);
        dst[d0 + e] = take_a ? A[i++] : B[j++];
      }
    }
    __syncthreads();
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  float acc = threadIdx.x == 0 ? target[cell] : 0.0f;
  for (int base = 0; base < L; base += kTile) {
    const int n = min(kTile, L - base);
    for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = src[base + i];
    __syncthreads();
    if (threadIdx.x == 0) acc = chain(acc, s, n);
    __syncthreads();
  }
  if (threadIdx.x == 0) target[cell] = acc;
  __syncthreads();
}

// One long segment by the whole block. Thread t takes the words
// [t * per, t * per + per) in segment order: their values into shared
// memory, the runs starting among them counted, one block prefix placing
// their headers in segment order. Each run's length is the next header's
// offset less its own; the headers are sorted (bitonic), the warps copy
// the runs' values out in pair order, and thread 0 chains them. Where the
// segment or its runs do not fit shared memory, spill_chain sorts the
// segment's own words instead.
__device__ void long_chain(float* target, int cell, int start, int L,
                           unsigned long long* words, unsigned long long* spare, unsigned* sv,
                           unsigned long long* runs) {
  constexpr int kPer = kRunMax / kBlockThreads;
  const int per = (L + kBlockThreads - 1) / kBlockThreads;
  const int from = min(L, static_cast<int>(threadIdx.x) * per), to = min(L, from + per);
  int R = 0;
  if (L <= kBlockMax) {
    int heads = 0;
    unsigned long long prev = from > 0 ? chunk_of(words[start + from - 1]) : ~0ull;
    for (int e = from; e < to; ++e) {
      const unsigned long long w = words[start + e];
      sv[e] = static_cast<unsigned>(w);
      heads += chunk_of(w) != prev;
      prev = chunk_of(w);
    }
    unsigned long long total;
    int h = static_cast<int>(block_exclusive(static_cast<unsigned long long>(heads), &total));
    R = static_cast<int>(total);
    if (R <= kRunMax) {
      prev = from > 0 ? chunk_of(words[start + from - 1]) : ~0ull;
      for (int e = from; e < to; ++e) {
        const unsigned long long chunk = chunk_of(words[start + e]);
        if (chunk != prev) runs[h++] = run_header(chunk, e, 0);
        prev = chunk;
      }
    }
    __syncthreads();
  }
  if (L <= kBlockMax && R <= kRunMax) {
    unsigned long long mine[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int h = j * kBlockThreads + threadIdx.x;
      if (h < R) {
        const int off = static_cast<int>((runs[h] >> 16) & 0xffffu);
        const int next = h + 1 < R ? static_cast<int>((runs[h + 1] >> 16) & 0xffffu) : L;
        mine[j] = run_header(runs[h] >> 32, off, next - off);
      }
    }
    __syncthreads();
    int P = 2;
    while (P < R) P <<= 1;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int h = j * kBlockThreads + threadIdx.x;
      if (h < P) runs[h] = h < R ? mine[j] : kPad;
    }
    __syncthreads();
    bitonic(runs, P, threadIdx.x, blockDim.x, []() { __syncthreads(); });
    // each run's place in pair order: thread t adds up the lengths of
    // sorted runs [t * kPer, t * kPer + kPer), one block prefix does the
    // rest, and the place replaces the chunk in the header
    int len_sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int h = threadIdx.x * kPer + j;
      mine[j] = h < R ? runs[h] : 0ull;
      len_sum += static_cast<int>(mine[j] & 0xffffu);
    }
    unsigned long long total;
    int at = static_cast<int>(block_exclusive(static_cast<unsigned long long>(len_sum), &total));
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int h = threadIdx.x * kPer + j;
      if (h < R) runs[h] = (static_cast<unsigned long long>(at) << 32) | (mine[j] & 0xffffffffu);
      at += static_cast<int>(mine[j] & 0xffffu);
    }
    __syncthreads();
    // warp w copies runs w, w + W, ...: their headers into registers first,
    // so that the copies may overwrite the headers' memory
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = kBlockThreads / 32;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int h = warp + W * (j * 32 + lane);
      mine[j] = h < R ? runs[h] : 0ull;
    }
    __syncthreads();
    unsigned* out = reinterpret_cast<unsigned*>(runs);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      for (int src = 0; src < 32 && warp + W * (j * 32 + src) < R; ++src) {
        const unsigned long long run = __shfl_sync(kFull, mine[j], src);
        const int pos = static_cast<int>(run >> 32);
        const int off = static_cast<int>((run >> 16) & 0xffffu);
        const int len = static_cast<int>(run & 0xffffu);
        for (int t = lane; t < len; t += 32) out[pos + t] = sv[off + t];
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) target[cell] = chain(target[cell], out, L);
    __syncthreads();
    return;
  }
  spill_chain(target, cell, words + start, spare + start, L, runs);
}

__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSm)
block_chain_kernel(float* __restrict__ target, const int4* __restrict__ segs,
                   unsigned long long* __restrict__ words, unsigned long long* __restrict__ spare,
                   const int* meta, const int* __restrict__ long_list) {
  extern __shared__ unsigned long long sm[];  // runs [kRunMax], then values [kBlockMax]
  unsigned* sv = reinterpret_cast<unsigned*>(sm + kRunMax);
  const int n = meta[kLong];
  for (int j = blockIdx.x; j < n; j += gridDim.x) {
    const int4 rec = segs[long_list[j]];  // {cell, start, length, 0}
    long_chain(target, rec.x, rec.y, rec.z, words, spare, sv, sm);
  }
}

// The scratch's regions, in bytes from its start, 16-byte aligned.
struct Layout {
  long long meta, cnt, flags, cursor, segs, long_list, aggregates, inclusives, words, spare,
      total;
  long long zeroed;  // meta, cnt and flags: the bytes set to 0 before the count
  int tiles, long_cap;
};

long long align16(long long x) { return (x + 15) & ~15ll; }

Layout layout(int K, int N) {
  Layout l;
  l.tiles = (N + kScanTile - 1) / kScanTile;
  l.long_cap = K / (kWarpMax + 1) < N ? K / (kWarpMax + 1) : N;
  long long at = 0;
  l.meta = at;
  at = align16(at + kMetaWords * 4ll);
  l.cnt = at;
  at = align16(at + 4ll * N);
  l.flags = at;
  at += 4ll * l.tiles;
  l.zeroed = at;
  at = align16(at);
  l.cursor = at;
  at = align16(at + 4ll * N);
  l.segs = at;
  at = align16(at + 16ll * N);
  l.long_list = at;
  at = align16(at + 4ll * (l.long_cap > 0 ? l.long_cap : 1));
  l.aggregates = at;
  at += 8ll * l.tiles;
  l.inclusives = at;
  at += 8ll * l.tiles;
  l.words = at;
  at += 8ll * K;
  l.spare = at;  // spill_chain's second copy of a segment's words
  at += K > kRunMax ? 8ll * K : 0ll;
  l.total = at;
  return l;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// How many blocks of `kernel` the card holds at once.
template <typename Kernel>
int resident(Kernel kernel, int threads, int smem) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return (per_sm > 0 ? per_sm : 1) * sm_count();
}


template <typename I>
int launch(float* target, const I* index, const float* values, int K, int N,
           unsigned char* scratch, cudaStream_t stream) {
  const Layout l = layout(K, N);
  int* meta = reinterpret_cast<int*>(scratch + l.meta);
  int* cnt = reinterpret_cast<int*>(scratch + l.cnt);
  int* flags = reinterpret_cast<int*>(scratch + l.flags);
  int* cursor = reinterpret_cast<int*>(scratch + l.cursor);
  int4* segs = reinterpret_cast<int4*>(scratch + l.segs);
  int* long_list = reinterpret_cast<int*>(scratch + l.long_list);
  auto* aggregates = reinterpret_cast<unsigned long long*>(scratch + l.aggregates);
  auto* inclusives = reinterpret_cast<unsigned long long*>(scratch + l.inclusives);
  auto* words = reinterpret_cast<unsigned long long*>(scratch + l.words);
  auto* spare = reinterpret_cast<unsigned long long*>(scratch + l.spare);
  cudaMemsetAsync(scratch, 0, l.zeroed, stream);
  const int blocks = static_cast<int>(lesser((K + kThreads - 1ll) / kThreads, sm_count() * 8ll));
  count_kernel<I><<<blocks, kThreads, 0, stream>>>(index, K, N, cnt);
  scan_kernel<<<l.tiles, kThreads, 0, stream>>>(cnt, N, cursor, segs, meta, flags, aggregates,
                                                inclusives);
  place_kernel<I><<<blocks, kThreads, 0, stream>>>(index, values, K, N, cursor, words);
  static const int warp_blocks = resident(warp_chain_kernel, kChainWarps * 32, 0);
  const long long most = lesser(K, N);  // segments there can be
  warp_chain_kernel<<<static_cast<int>(lesser((most + kChainWarps - 1) / kChainWarps,
                                              warp_blocks)),
                      kChainWarps * 32, 0, stream>>>(target, segs, words, meta, long_list);
  if (l.long_cap > 0) {
    cudaFuncSetAttribute(block_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kBlockSmem);
    static const int long_blocks = resident(block_chain_kernel, kBlockThreads, kBlockSmem);
    block_chain_kernel<<<static_cast<int>(lesser(l.long_cap, long_blocks)), kBlockThreads,
                         kBlockSmem, stream>>>(target, segs, words, spare, meta, long_list);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The scratch bytes ordered_scatter_add needs for K pairs into N cells,
// written to *bytes (a host int64). Returns 0.
int ordered_scatter_add_scratch(int K, int N, void* bytes) {
  *static_cast<long long*>(bytes) = layout(K, N).total;
  return 0;
}

// target [N] f32, index [K] i32 (index_bytes 4) or i64 (8), values [K] f32
// in the pairs' order, scratch of ordered_scatter_add_scratch's bytes, all
// on the card. Launched on cuda_stream, no synchronisation. Returns the
// CUDA error of the launches (0 on success).
int ordered_scatter_add(void* target, const void* index, int index_bytes, const void* values,
                        void* scratch, int K, int N, void* cuda_stream) {
  if (K <= 0 || N <= 0) return 0;
  auto* t = static_cast<float*>(target);
  auto* v = static_cast<const float*>(values);
  auto* s = static_cast<unsigned char*>(scratch);
  auto stream = static_cast<cudaStream_t>(cuda_stream);
  if (index_bytes == 8) {
    return launch(t, static_cast<const long long*>(index), v, K, N, s, stream);
  }
  if (index_bytes == 4) return launch(t, static_cast<const int*>(index), v, K, N, s, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
