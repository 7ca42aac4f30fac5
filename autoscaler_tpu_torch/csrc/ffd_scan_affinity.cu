// First-fit-decreasing scan gated by dynamic inter-pod (anti-)affinity and
// hard topology spread, over every node group at once, for Hopper (sm_90a).
//
//   ffd_scan_aff   replaces ops/pallas_binpack_affinity.py::_scan_kernel_aff
//                  (K3), line 150 of that file.
//
// What it computes. Group g's pods arrive sorted by descending score as a
// request stream [G, P_pad, R] f32 (masked and padding pods carry +inf and
// fit nowhere) and a bit stream [G, P_pad, NB] i32: the pod's term bitsets
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
// first-fit minimum decides both placement and opening. The pod places iff
// first < cap; then node `first` loses the request, ORs in the pod's match
// and anti bits, and counts it in the spread terms it matches.
//
// What bounds it on this card. Not bytes: the streams are read once. The
// bound is the chain of P dependent steps in each group (a step cannot
// start before the previous placement has updated the carry), each of
// which tests up to M nodes; and for a pod with a hostname-level spread
// term, a full minimum over the open nodes at each step, before its node
// scan. With ~100 groups there is less than one warp per SM, so nothing
// hides the latency of a step.
//
// What the design does about it. One warp per group, the group's whole
// carry in dynamic shared memory ((R + 2 TP + S) M words: 160 KB at R=6,
// TP=1, S=32, M=1024, above 48 KB, so the launch opts in), so a step
// touches no device memory. Lane l owns nodes l, l+32, ...; the warp tests
// 32 nodes at a time in node order and stops at the first 32-node block
// with a hit (__ballot_sync + __ffs). The per-group scalars of a step (the
// group-level spread verdict, new_ok, the hostname minima) are computed
// once per step before the node scan; a hostname minimum is a strided
// minimum over the open nodes and one __reduce_min_sync, taken only for the
// terms the pod declares. Masked and padding pods are skipped outright:
// they can fit no node, so they never change the carry. Requests and bits
// are staged 32 steps at a time with coalesced loads. The subtract is a
// select on the hit node (no multiply, and the build passes --fmad=false).
// Later work: several warps per group when G is small, an incremental
// hostname minimum, spread planes only for hostname-level terms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kNoNode = 0x7fffffff;
constexpr int kBigI32 = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSpread = 32;
constexpr int kStats = 8;  // nl_s, hl_s, skew, mind, st_count, min_others_eff, st_min, st_domnum

__host__ __device__ inline int bit_planes(int TP, int S) {
  return 3 * TP + (S ? 2 : 0);
}

__global__ void ffd_scan_aff_kernel(
    const float* __restrict__ stream,    // [G, P_pad, R]
    const int32_t* __restrict__ bits,    // [G, P_pad, NB]
    const float* __restrict__ allocs,    // [G, R]
    const int32_t* __restrict__ caps,    // [G], already <= M
    const int32_t* __restrict__ nl,      // [TP]
    const int32_t* __restrict__ hl,      // [G, TP]
    const int32_t* __restrict__ spstat,  // [G, 8, S] or null
    float* __restrict__ free_out,        // [G, R, M]
    int32_t* __restrict__ opened_out,    // [G]
    uint8_t* __restrict__ placed_out,    // [G, P_pad]
    int P_pad, int R, int TP, int S, int M) {
  const int NB = bit_planes(TP, S);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* free_s = reinterpret_cast<float*>(smem_raw);                // [R, M]
  int32_t* pm_s = reinterpret_cast<int32_t*>(free_s + (size_t)R * M);  // [TP, M]
  int32_t* ha_s = pm_s + (size_t)TP * M;                             // [TP, M]
  int32_t* spc_s = ha_s + (size_t)TP * M;                            // [S, M]
  float* req_s = reinterpret_cast<float*>(spc_s + (size_t)S * M);    // [32, R]
  int32_t* bits_s = reinterpret_cast<int32_t*>(req_s + kWarp * R);   // [32, NB]
  int32_t* pmt_s = bits_s + kWarp * NB;                              // [TP]
  int32_t* hat_s = pmt_s + TP;                                       // [TP]
  int32_t* nl_s = hat_s + TP;                                        // [TP]
  int32_t* hl_s = nl_s + TP;                                         // [TP]
  int32_t* spct_s = hl_s + TP;                                       // [S]
  int32_t* minh_s = spct_s + S;                                      // [S]
  int32_t* stat_s = minh_s + S;                                      // [8, S]

  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  for (int r = 0; r < R; ++r) {
    const float a = allocs[(size_t)g * R + r];
    for (int m = lane; m < M; m += kWarp) free_s[(size_t)r * M + m] = a;
  }
  for (int i = lane; i < 2 * TP * M + S * M; i += kWarp) pm_s[i] = 0;
  for (int tp = lane; tp < TP; tp += kWarp) {
    pmt_s[tp] = 0;
    hat_s[tp] = 0;
    nl_s[tp] = nl[tp];
    hl_s[tp] = hl[(size_t)g * TP + tp];
  }
  for (int i = lane; i < S; i += kWarp) spct_s[i] = 0;
  for (int i = lane; i < kStats * S; i += kWarp) {
    stat_s[i] = spstat[(size_t)g * kStats * S + i];
  }
  __syncwarp();

  const int* skew_s = stat_s + 2 * S;
  const int cap = caps[g];
  int opened = 0;
  const float* gstream = stream + (size_t)g * P_pad * R;
  const int32_t* gbits = bits + (size_t)g * P_pad * NB;
  uint8_t* gplaced = placed_out + (size_t)g * P_pad;

  for (int base = 0; base < P_pad; base += kWarp) {
    const float* chunk = gstream + (size_t)base * R;
    for (int i = lane; i < kWarp * R; i += kWarp) req_s[i] = chunk[i];
    const int32_t* bchunk = gbits + (size_t)base * NB;
    for (int i = lane; i < kWarp * NB; i += kWarp) bits_s[i] = bchunk[i];
    __syncwarp();
    uint8_t my_placed = 0;
    for (int s = 0; s < kWarp; ++s) {
      const float* req = req_s + s * R;
      const int32_t* b = bits_s + s * NB;
      int first = kNoNode;
      if (!isinf(req[0])) {
        // -- per-step group scalars: spread verdicts, hostname minima ----
        bool group_ok = true;
        uint32_t host_act = 0;  // hostname-level terms the pod declares
        const uint32_t spof = S ? (uint32_t)b[3 * TP] : 0u;
        const uint32_t spmt = S ? (uint32_t)b[3 * TP + 1] : 0u;
        for (uint32_t act = spof; act; act &= act - 1) {
          const int i = __ffs(act) - 1;
          const int self_i = (spmt >> i) & 1u;
          const int skew = skew_s[i];
          if (stat_s[i] == 0) {  // group-level
            if (stat_s[S + i] != 0) {
              const int cnt = stat_s[4 * S + i] + spct_s[i];
              const int min_eff_z = min(stat_s[5 * S + i], cnt);
              if (cnt + self_i - min_eff_z > skew) group_ok = false;
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
            if (lane == 0) minh_s[i] = min_eff_h;
            host_act |= 1u << i;
          }
        }
        __syncwarp();

        if (group_ok) {
          bool new_ok = true;
          for (int tp = 0; tp < TP; ++tp) {
            const uint32_t mp = b[tp], ap = b[TP + tp], xp = b[2 * TP + tp];
            const uint32_t n = nl_s[tp], h = hl_s[tp];
            const uint32_t pmt = pmt_s[tp], hat = hat_s[tp];
            const uint32_t seed = mp & ~pmt;
            const uint32_t nv = (ap & ~((n & seed) | (~n & h & (pmt | seed)))) |
                                (xp & ~n & pmt & h) | (mp & ~n & hat & h);
            if (nv) new_ok = false;
          }

          // -- first fit in node order, 32 nodes at a time ---------------
          const int lim = min(opened, M - 1);
          for (int k0 = 0; k0 <= lim; k0 += kWarp) {
            const int m = k0 + lane;
            bool ok = m <= lim;
            for (int r = 0; ok && r < R; ++r) {
              ok = req[r] <= free_s[(size_t)r * M + m];
            }
            if (ok && m < opened) {
              for (int tp = 0; ok && tp < TP; ++tp) {
                const uint32_t mp = b[tp], ap = b[TP + tp], xp = b[2 * TP + tp];
                const uint32_t n = nl_s[tp], h = hl_s[tp];
                const uint32_t pmt = pmt_s[tp], hat = hat_s[tp];
                const uint32_t seed = mp & ~pmt;
                const uint32_t dom_pm = ((uint32_t)pm_s[(size_t)tp * M + m] & n) | (pmt & ~n);
                const uint32_t dom_ha = ((uint32_t)ha_s[(size_t)tp * M + m] & n) | (hat & ~n);
                const uint32_t viol = (ap & (~h | ~(dom_pm | seed))) |
                                      (xp & dom_pm & h) | (mp & dom_ha & h);
                ok = viol == 0;
              }
              for (uint32_t act = host_act; ok && act; act &= act - 1) {
                const int i = __ffs(act) - 1;
                const int self_i = (spmt >> i) & 1u;
                ok = !(spc_s[(size_t)i * M + m] + self_i - minh_s[i] > skew_s[i]);
              }
            } else if (ok) {
              ok = new_ok;
            }
            const unsigned hit = __ballot_sync(kFull, ok);
            if (hit) {
              first = k0 + __ffs(hit) - 1;
              break;
            }
          }
        }
      }
      const bool place = first < cap;
      if (place) {
        __syncwarp();
        for (int r = lane; r < R; r += kWarp) {
          float* f = free_s + (size_t)r * M + first;
          *f = *f - req[r];
        }
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
        opened = max(opened, first + 1);
      }
      if (lane == s) my_placed = place ? 1 : 0;
      __syncwarp();
    }
    gplaced[base + lane] = my_placed;
  }

  float* gfree = free_out + (size_t)g * R * M;
  for (int i = lane; i < R * M; i += kWarp) gfree[i] = free_s[i];
  if (lane == 0) opened_out[g] = opened;
}

// Dynamic shared memory of one block: the carry free [R, M], pm/ha
// [TP, M] and spc [S, M]; 32 staged steps of requests [32, R] and bits
// [32, NB]; the group scalars pmt/hat/nl/hl [TP], spct and the hostname
// minima [S], and the spread statics [8, S]; all 4-byte words.
size_t smem_bytes(int R, int TP, int S, int M) {
  return ((size_t)(R + 2 * TP + S) * M + (size_t)kWarp * (R + bit_planes(TP, S)) +
          4 * (size_t)TP + (2 + kStats) * (size_t)S) * 4;
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
      P_pad % kWarp != 0 || (S > 0 && spstat == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(R, TP, S, M);
  cudaError_t err = cudaFuncSetAttribute(
      ffd_scan_aff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffd_scan_aff_kernel<<<G, kWarp, smem, (cudaStream_t)cuda_stream>>>(
      static_cast<const float*>(stream), static_cast<const int32_t*>(bits),
      static_cast<const float*>(allocs), static_cast<const int32_t*>(caps),
      static_cast<const int32_t*>(nl), static_cast<const int32_t*>(hl),
      static_cast<const int32_t*>(spstat), static_cast<float*>(free_out),
      static_cast<int32_t*>(opened_out), static_cast<uint8_t*>(placed_out),
      P_pad, R, TP, S, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
