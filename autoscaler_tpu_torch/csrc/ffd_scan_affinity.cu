// First-fit-decreasing scan gated by dynamic inter-pod (anti-)affinity and
// hard topology spread, over every node group at once, for Hopper (sm_90a).
//
//   ffd_scan_aff   replaces ops/pallas_binpack_affinity.py::_scan_kernel_aff
//                  (K3), line 150 of that file.
//
// What it computes. Group g's pods arrive sorted by descending score as a
// request stream [G, P_pad, R] f32 (masked and padding pods carry +inf and
// fit nowhere) and a bit stream [G, P_pad, BP] i32: the pod's term bitsets
// m/a/x [TP] (matches term t / requires affinity term t / requires anti
// term t, bit t%32 of plane t/32) and, with S spread terms, its spread
// bitsets spof/spmt. The carry per group: free [R, M] f32, the term bits
// pm/ha [TP, M] (a pod matching term t / holding anti term t was placed on
// node m), their group ORs pmt/hat [TP], and with spread the count planes
// spc [S, M] and totals spct [S]. For each pod the kernel evaluates, with
// seed = m & ~pmt,
//
//   dom_pm[m] = (pm[m] & nl) | (pmt & ~nl)        (dom_ha likewise)
//   viol[m]   = a & (~hl | ~(dom_pm[m] | seed)) | x & dom_pm[m] & hl
//             | m & dom_ha[m] & hl                 -> gate_open[m] = !viol
//   new_viol  = a & ~((nl & seed) | (~nl & hl & (pmt | seed)))
//             | x & ~nl & pmt & hl | m & ~nl & hat & hl  -> new_ok = !new_viol
//
// and the spread gates of the Pallas kernel (its lines 266-312): a
// group-level term compares cnt = st_count + spct against
// min(min_others_eff, cnt) and blocks the whole group; a hostname-level
// term compares spc[m] against the minimum of spc over the OPEN nodes,
// folded to 0 while minDomains > st_domnum + opened. The node gate is
// `m < opened ? gate_open[m] && !node_bad[m] : new_ok`; closed nodes all
// hold free == alloc, so node `opened` stands for every closed node and one
// first-fit minimum decides both placement and opening. A node at or past
// the cap can never be placed on, so the search stops at
// lim = min(opened, min(cap, M) - 1); a hit is placed: node `first` loses
// the request, ORs in the pod's match and anti bits, and counts it in the
// spread terms it matches.
//
// What bounds it on this card. Not bytes: the streams are read once. The
// bound is the chain of P dependent steps in each group (a step cannot
// start before the previous placement has updated the carry). Once the
// groups reach their caps most pods fit nowhere, and a scan of every open
// node costs ~28 serial 32-node blocks a step; with 100 groups, or 16 in
// the spread worlds, the card holds one block an SM or fewer, so nothing
// hides the latency of a step.
//
// What the design does about it (the design of K1/K2 in ffd_scan.cu, with
// K3's gates added, and a cheaper step).
//  1. Several warps a group. One block of kWarps warps serves a group, its
//     whole carry in dynamic shared memory ((R + 2 TP + S) M words: 160 KB
//     at R=6, TP=1, S=32, M=1024, above 48 KB, so the launch opts in), so a
//     step touches no device memory. The search runs in rounds: in each,
//     warp w takes the remaining candidate blocks kWarpBlocks w ..
//     kWarpBlocks (w + 1) - 1 (node m on lane m % 32), tests their nodes on
//     capacity and on the gates with the loads of the blocks interleaved,
//     and finds its lowest hit with __ballot_sync + __ffs; one barrier
//     (__syncthreads_or) ends the round, and the lowest hit among the
//     warps' slots is `first`, because warps take candidates in node order.
//     A round takes 32 candidates, so one round covers every block of a
//     carry of up to 1024 nodes. A round whose capacity hits all fail the
//     gates ends with no hit and the next goes on; the slots alternate
//     buffers by round parity.
//  2. Exact capacity pruning. summ [R, ceil(M/32)] holds, per resource, the
//     maximum free capacity over the block's nodes below the cap (closed
//     nodes hold alloc). A step first tests the request against the
//     summaries of blocks 0..lim/32 (lane b takes block b, in passes of 32
//     blocks); only the blocks that pass are searched. A node that fits
//     passes its block's summary, so nothing is lost: the node tests and
//     the gates still decide `first`. The max runs on order-preserving keys
//     of the f32 bits (never an OR of them, which can make a NaN). After
//     each placement the hit block's summary is recomputed, by the warps at
//     once (warp w takes resources w, w + kWarps, ...), so it is exact at
//     every step. Gate summaries are not kept: the nodes that fit on
//     capacity and the nodes that pass the gates are different nodes of the
//     same block, so they would prune nothing more.
//  3. A cheaper step. The group-level spread verdict, new_ok and the
//     hostname minima (lane i keeps term i's, read by the node tests with
//     __shfl_sync) are computed alike by every warp from shared memory that
//     nothing writes between the barriers around those reads, so every
//     branch that holds a barrier is uniform over the block. A step that a
//     group-level term blocks searches nothing; masked and padding steps are
//     skipped outright; the term gates are skipped for a pod that carries no
//     term bit. A warp finds its candidates by a binary search on popcounts.
//     The placement (free and summaries as above; pm/ha, pmt/hat, spc/spct by
//     the last warp) is followed by one barrier, which makes it visible
//     before the next step. The next 32 steps' requests and bits are staged
//     with cp.async into a second buffer while the current 32 run; the
//     placed bytes are written 32 at a time.
//
// The subtract is a select on the hit node only (never a multiply by a 0/1
// flag: inf * 0 is NaN), and the build passes --fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;        // warps a group (GROUP_WARPS in ops/ffd_scan_affinity.py)
constexpr int kThreads = kWarp * kWarps;
constexpr int kWarpBlocks = 4;   // candidate blocks a warp tests a round (WARP_BLOCKS)
constexpr int kSteps = 32;       // steps staged at a time
constexpr int kNoNode = 0x7fffffff;
constexpr int kBigI32 = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSpread = 32;
constexpr int kStats = 8;  // nl_s, hl_s, skew, mind, st_count, min_others_eff, st_min, st_domnum

__host__ __device__ inline int bit_planes(int TP, int S) {
  return 3 * TP + (S ? 2 : 0);
}

// The maximum over the warp's lanes with `valid` set, exact for any floats:
// a key that orders the f32 bits as the values order, NaN (which fits
// nothing) and invalid lanes at key 0, which decodes to a NaN that fits
// nothing.
__device__ __forceinline__ float warp_max_f32(float v, bool valid) {
  const uint32_t b = __float_as_uint(v);
  uint32_t key = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  if (!valid || v != v) key = 0u;
  key = __reduce_max_sync(kFull, key);
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The bits of x from its n-th set bit (0-based) up; 0 when x has n or
// fewer: a binary search on popcounts, five steps.
__device__ __forceinline__ unsigned from_nth_bit(unsigned x, int n) {
  if (__popc(x) <= n) return 0u;
  unsigned y = x;
  int pos = 0;
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned lo = y & ((1u << w) - 1u);
    const int c = __popc(lo);
    if (n >= c) {
      n -= c;
      y >>= w;
      pos += w;
    } else {
      y = lo;
    }
  }
  return x & ~((1u << pos) - 1u);
}

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

__global__ void __launch_bounds__(kThreads) ffd_scan_aff_kernel(
    const float* __restrict__ stream,    // [G, P_pad, R]
    const int32_t* __restrict__ bits,    // [G, P_pad, BP]
    const float* __restrict__ allocs,    // [G, R]
    const int32_t* __restrict__ caps,    // [G], already <= M
    const int32_t* __restrict__ nl,      // [TP]
    const int32_t* __restrict__ hl,      // [G, TP]
    const int32_t* __restrict__ spstat,  // [G, 8, S] or null
    float* __restrict__ free_out,        // [G, R, M]
    int32_t* __restrict__ opened_out,    // [G]
    uint8_t* __restrict__ placed_out,    // [G, P_pad]
    int P_pad, int R, int TP, int S, int M) {
  const int BP = bit_planes(TP, S);
  const int NB = (M + kWarp - 1) / kWarp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* free_s = reinterpret_cast<float*>(smem_raw);                  // [R, M]
  float* summ_s = free_s + (size_t)R * M;                              // [R, NB]
  int32_t* pm_s = reinterpret_cast<int32_t*>(summ_s + (size_t)R * NB);  // [TP, M]
  int32_t* ha_s = pm_s + (size_t)TP * M;                               // [TP, M]
  int32_t* spc_s = ha_s + (size_t)TP * M;                              // [S, M]
  float* req_s = reinterpret_cast<float*>(spc_s + (size_t)S * M);      // [2, 32, R]
  int32_t* bits_s = reinterpret_cast<int32_t*>(req_s + 2 * kSteps * R);  // [2, 32, BP]
  int32_t* pmt_s = bits_s + 2 * kSteps * BP;                           // [TP]
  int32_t* hat_s = pmt_s + TP;                                         // [TP]
  int32_t* nl_s = hat_s + TP;                                          // [TP]
  int32_t* hl_s = nl_s + TP;                                           // [TP]
  int32_t* spct_s = hl_s + TP;                                         // [S]
  int32_t* stat_s = spct_s + S;                                        // [8, S]
  int* slot_s = stat_s + kStats * S;                                   // [2, kWarps]

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int cap = caps[g];
  const int span = min(M, max(cap, 0));   // nodes that can ever be placed on
  const float* gstream = stream + (size_t)g * P_pad * R;
  const int32_t* gbits = bits + (size_t)g * P_pad * BP;
  uint8_t* gplaced = placed_out + (size_t)g * P_pad;

  // the first staged block, in flight while the carry is set up (an empty
  // stream has none)
  if (P_pad > 0) {
    for (int i = tid; i < kSteps * R; i += kThreads) cp_async4(req_s + i, gstream + i);
    for (int i = tid; i < kSteps * BP; i += kThreads) cp_async4(bits_s + i, gbits + i);
  }
  cp_async_commit();
  for (int r = 0; r < R; ++r) {
    const float a = allocs[(size_t)g * R + r];
    for (int m = tid; m < M; m += kThreads) free_s[(size_t)r * M + m] = a;
    // every block with a node below the cap holds alloc at its maximum;
    // the blocks past the cap are never searched
    for (int b = tid; b < NB; b += kThreads) summ_s[(size_t)r * NB + b] = a;
  }
  for (int i = tid; i < (2 * TP + S) * M; i += kThreads) pm_s[i] = 0;
  for (int tp = tid; tp < TP; tp += kThreads) {
    pmt_s[tp] = 0;
    hat_s[tp] = 0;
    nl_s[tp] = nl[tp];
    hl_s[tp] = hl[(size_t)g * TP + tp];
  }
  for (int i = tid; i < S; i += kThreads) spct_s[i] = 0;
  for (int i = tid; i < kStats * S; i += kThreads) {
    stat_s[i] = spstat[(size_t)g * kStats * S + i];
  }

  const int* skew_s = stat_s + 2 * S;
  int opened = 0;
  int rounds = 0;   // its parity picks the slot buffer of a round
  for (int base = 0, buf = 0; base < P_pad; base += kSteps, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();   // this block's steps seen by all; the other buffer free
    if (base + kSteps < P_pad) {
      const float* next = gstream + (size_t)(base + kSteps) * R;
      float* dst = req_s + (buf ^ 1) * kSteps * R;
      for (int i = tid; i < kSteps * R; i += kThreads) cp_async4(dst + i, next + i);
      const int32_t* bnext = gbits + (size_t)(base + kSteps) * BP;
      int32_t* bdst = bits_s + (buf ^ 1) * kSteps * BP;
      for (int i = tid; i < kSteps * BP; i += kThreads) cp_async4(bdst + i, bnext + i);
    }
    cp_async_commit();
    const float* reqs = req_s + buf * kSteps * R;
    const int32_t* bitss = bits_s + buf * kSteps * BP;
    uint8_t my_placed = 0;
    for (int s = 0; s < kSteps; ++s) {
      const float* req = reqs + s * R;
      const int32_t* b = bitss + s * BP;
      int first = kNoNode;
      if (!isinf(req[0])) {
        // -- per-step group scalars: spread verdicts, hostname minima ----
        bool group_ok = true;
        uint32_t host_act = 0;  // hostname-level terms the pod declares
        int minh = 0;           // lane i: term i's effective hostname minimum
        const uint32_t spof = S ? (uint32_t)b[3 * TP] : 0u;
        const uint32_t spmt = S ? (uint32_t)b[3 * TP + 1] : 0u;
        for (uint32_t act = spof; act; act &= act - 1) {
          const int i = __ffs(act) - 1;
          const int self_i = (spmt >> i) & 1u;
          if (stat_s[i] == 0) {  // group-level
            if (stat_s[S + i] != 0) {
              const int cnt = stat_s[4 * S + i] + spct_s[i];
              const int min_eff_z = min(stat_s[5 * S + i], cnt);
              if (cnt + self_i - min_eff_z > skew_s[i]) group_ok = false;
            }
          } else {               // hostname-level
            int v = kBigI32;
            for (int m = lane; m < opened; m += kWarp) {
              v = min(v, spc_s[(size_t)i * M + m]);
            }
            v = __reduce_min_sync(kFull, v);
            const int domnum = stat_s[7 * S + i] + opened;
            const int min_eff_h =
                stat_s[3 * S + i] > domnum ? 0 : min(stat_s[6 * S + i], v);
            if (lane == i) minh = min_eff_h;
            host_act |= 1u << i;
          }
        }

        if (group_ok) {
          bool new_ok = true;
          bool terms = false;   // the pod carries a term bit: the gates can bind
          for (int tp = 0; tp < TP; ++tp) {
            const uint32_t mp = b[tp], ap = b[TP + tp], xp = b[2 * TP + tp];
            terms |= (mp | ap | xp) != 0u;
            const uint32_t n = nl_s[tp], h = hl_s[tp];
            const uint32_t pmt = pmt_s[tp], hat = hat_s[tp];
            const uint32_t seed = mp & ~pmt;
            const uint32_t nv = (ap & ~((n & seed) | (~n & h & (pmt | seed)))) |
                                (xp & ~n & pmt & h) | (mp & ~n & hat & h);
            if (nv) new_ok = false;
          }

          // -- the search: summary passes, then rounds over candidates ----
          const int lim = min(opened, span - 1);   // -1 when the cap is 0
          const int nblk = lim < 0 ? 0 : lim / kWarp + 1;
          for (int q0 = 0; q0 < nblk && first == kNoNode; q0 += kWarp) {
            // the pass: lane j tests block q0 + j against its summary
            const int bj = q0 + lane;
            const int bi = min(bj, NB - 1);
            bool c = bj < nblk;
#pragma unroll 4
            for (int r = 0; r < R; ++r) c &= req[r] <= summ_s[(size_t)r * NB + bi];
            unsigned cand = __ballot_sync(kFull, c);
            while (cand != 0u) {
              // the round: warp w searches the remaining candidates
              // kWarpBlocks w .. kWarpBlocks (w + 1) - 1, their node loads
              // interleaved
              unsigned mine = from_nth_bit(cand, warp * kWarpBlocks);
              int hit_node = kNoNode;
              if (mine != 0u) {
                int m0[kWarpBlocks], mi[kWarpBlocks];
                bool ok[kWarpBlocks], gate[kWarpBlocks], is_open[kWarpBlocks];
#pragma unroll
                for (int j = 0; j < kWarpBlocks; ++j) {
                  const bool has = mine != 0u;
                  m0[j] = has ? (q0 + __ffs(mine) - 1) * kWarp : 0;
                  mine &= mine - 1u;
                  const int m = m0[j] + lane;
                  mi[j] = min(m, lim);
                  ok[j] = has && m <= lim;
                  is_open[j] = mi[j] < opened;
                  gate[j] = new_ok;
                }
#pragma unroll 2
                for (int r = 0; r < R; ++r) {
                  const float q = req[r];
#pragma unroll
                  for (int j = 0; j < kWarpBlocks; ++j) ok[j] &= q <= free_s[(size_t)r * M + mi[j]];
                }
                if (terms) {   // else no open node's gate can bind
#pragma unroll
                  for (int j = 0; j < kWarpBlocks; ++j) {
                    if (ok[j] && is_open[j]) {
                      gate[j] = true;
                      for (int tp = 0; tp < TP; ++tp) {
                        const uint32_t mp = b[tp], ap = b[TP + tp], xp = b[2 * TP + tp];
                        const uint32_t n = nl_s[tp], h = hl_s[tp];
                        const uint32_t pmt = pmt_s[tp], hat = hat_s[tp];
                        const uint32_t seed = mp & ~pmt;
                        const uint32_t dom_pm =
                            ((uint32_t)pm_s[(size_t)tp * M + mi[j]] & n) | (pmt & ~n);
                        const uint32_t dom_ha =
                            ((uint32_t)ha_s[(size_t)tp * M + mi[j]] & n) | (hat & ~n);
                        const uint32_t viol = (ap & (~h | ~(dom_pm | seed))) |
                                              (xp & dom_pm & h) | (mp & dom_ha & h);
                        if (viol) gate[j] = false;
                      }
                    }
                  }
                }
                // the hostname gates: a loop uniform over the warp, for the
                // shuffle of each term's minimum
                for (uint32_t act = host_act; act; act &= act - 1) {
                  const int i = __ffs(act) - 1;
                  const int mh = __shfl_sync(kFull, minh, i);
                  const int self_i = (spmt >> i) & 1u;
#pragma unroll
                  for (int j = 0; j < kWarpBlocks; ++j) {
                    if (is_open[j] && spc_s[(size_t)i * M + mi[j]] + self_i - mh > skew_s[i]) {
                      gate[j] = false;
                    }
                  }
                }
#pragma unroll
                for (int j = 0; j < kWarpBlocks; ++j) {
                  const unsigned hit = __ballot_sync(kFull, ok[j] && gate[j]);
                  if (hit_node == kNoNode && hit != 0u) hit_node = m0[j] + __ffs(hit) - 1;
                }
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
              cand = from_nth_bit(cand, kWarps * kWarpBlocks);
            }
          }
        }
      }
      // first <= lim < span <= cap whenever a node passes: it is placed
      const bool place = first != kNoNode;
      if (place) {
        // warp w updates resources w, w + kWarps, ...: node `first`'s free
        // capacity, and its block's summary recomputed with the new value
        const int blk = first / kWarp;
        const int m = blk * kWarp + lane;
        const int mi = min(m, M - 1);
        for (int r = warp; r < R; r += kWarps) {
          const float v_new = free_s[(size_t)r * M + first] - req[r];
          const float x = m == first ? v_new : free_s[(size_t)r * M + mi];
          __syncwarp();
          if (lane == 0) free_s[(size_t)r * M + first] = v_new;
          const float mx = warp_max_f32(x, m < span);
          if (lane == 0) summ_s[(size_t)r * NB + blk] = mx;
        }
        // the last warp: the term bits and the spread counts
        if (warp == kWarps - 1) {
          for (int tp = lane; tp < TP; tp += kWarp) {
            const int32_t mp = b[tp], xp = b[2 * TP + tp];
            pm_s[(size_t)tp * M + first] |= mp;
            ha_s[(size_t)tp * M + first] |= xp;
            pmt_s[tp] |= mp;
            hat_s[tp] |= xp;
          }
          if (S) {
            const uint32_t spmt = (uint32_t)b[3 * TP + 1];
            for (int i = lane; i < S; i += kWarp) {
              if (((spmt >> i) & 1u) && stat_s[S + i] != 0) {
                spc_s[(size_t)i * M + first] += 1;
                spct_s[i] += 1;
              }
            }
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
  float* gfree = free_out + (size_t)g * R * M;
  for (int i = tid; i < R * M; i += kThreads) gfree[i] = free_s[i];
  if (tid == 0) opened_out[g] = opened;
}

// Dynamic shared memory of one block: the carry free [R, M], its block
// summaries [R, ceil(M/32)], pm/ha [TP, M] and spc [S, M]; two staged
// blocks of 32 steps' requests [2, 32, R] and bits [2, 32, BP]; the group
// scalars pmt/hat/nl/hl [TP] and spct [S], the spread statics [8, S], and
// two rounds' hit slots [2, kWarps]; all 4-byte words.
size_t smem_bytes(int R, int TP, int S, int M) {
  const size_t NB = ((size_t)M + kWarp - 1) / kWarp;
  return ((size_t)(R + 2 * TP + S) * M + (size_t)R * NB +
          2 * (size_t)kSteps * (R + bit_planes(TP, S)) + 4 * (size_t)TP +
          (1 + kStats) * (size_t)S + 2 * (size_t)kWarps) * 4;
}

}  // namespace

extern "C" {

// The dynamic shared memory each launch requests a block, in bytes.
int ffd_scan_aff_smem_bytes(int R, int TP, int S, int M) {
  return (int)smem_bytes(R, TP, S, M);
}

int ffd_scan_aff(const void* stream, const void* bits, const void* allocs,
                 const void* caps, const void* nl, const void* hl,
                 const void* spstat, void* free_out, void* opened_out,
                 void* placed_out, int G, int P_pad, int R, int TP, int S,
                 int M, void* cuda_stream) {
  if (G <= 0 || R <= 0 || TP <= 0 || S < 0 || S > kMaxSpread || M <= 0 ||
      P_pad < 0 || P_pad % kSteps != 0 || (S > 0 && spstat == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(R, TP, S, M);
  cudaError_t err = cudaFuncSetAttribute(
      ffd_scan_aff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffd_scan_aff_kernel<<<G, kThreads, smem, (cudaStream_t)cuda_stream>>>(
      static_cast<const float*>(stream), static_cast<const int32_t*>(bits),
      static_cast<const float*>(allocs), static_cast<const int32_t*>(caps),
      static_cast<const int32_t*>(nl), static_cast<const int32_t*>(hl),
      static_cast<const int32_t*>(spstat), static_cast<float*>(free_out),
      static_cast<int32_t*>(opened_out), static_cast<uint8_t*>(placed_out),
      P_pad, R, TP, S, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
