// v7 ordered-visit ray/triangle traversal, written for Hopper (sm_90a), with
// its cull computed in the tile prologue.
//
// Replaces realtimeraytracer_tpu/render/pallas_backend.py::trace_blocks
// (kernel body _trace_kernel/_tile_body) together with the XLA cull that
// feeds it (pallas_backend.py::cull_keys; the port's plain copy is
// render/v7_backend.py::cull_keys).  One 128-ray tile per CTA, rays (Ts, 8,
// 128) f32 rows [o.xyz | d.xyz | t_min | t_max]; subcluster boxes cl_min /
// cl_max (4 CB, 3) f32 (subcluster 4B + q is lanes [32q, 32q+32) of block
// B); Baldwin-Weber coefficient blocks (CB, 12, 128) f32 rows [n | -n.A |
// r1 | -r1.A | r2 | -r2.A]; optional alpha masks (CB, 2, 128) i32 (closest
// mode only: bit b = 8 gj + gi of a triangle's 64-bit mask, word b >> 5, is
// 0 where the barycentric cell (gi, gj) = (int(8u), int(8v)) is definitely
// transparent; ops/alpha_mask.py).  Outputs: outf row 0 = t (closest; 3e38
// on a miss) or the occluded flag; outi row 0 = sorted-triangle id (-1 on a
// miss), row 1 = blocks visited, row 5 = ray-triangle pairs this ray tested
// (live rays only, up to the first hit in occluded mode: the bound's
// operation count).  Rows the kernel does not write are left as the caller
// allocated them.
//
// Design.  One thread per ray, 128 threads per tile.
//   Cull (the prologue; cull_keys' arithmetic, in its order, tile_trace.cuh):
//     the tile's rays reduce to the bundle's origin box, direction
//     interval, least t_min and greatest t_max (warp shuffles, then the
//     four warps' partials in order).  Thread `lane` takes blocks B = lane
//     + 128 k, evaluates the interval entry bound of the block's four
//     subcluster boxes, takes their least (cull_keys' amin) plus +0.0 (a -0
//     entry becomes +0, so the key does not hang on which zero a minimum
//     returns), and packs (entry bits & ~id_mask) | B, INVALID where no box
//     can be hit.  The valid keys of each round of 128 blocks are
//     compacted into shared memory by a warp ballot and the four warps'
//     counts (no atomics), in block order.
//   Sort: keys are unique (the block id sits in the low bits), so up to
//     512 keys each thread ranks its (at most four) keys against all of
//     them and scatters each to its rank: one barrier, where the bitonic
//     network took one per stage.  Above 512 keys, a bitonic network.  The
//     sorted order is the TPU kernel's order of min-pops.
//   Visits: visit i stages the i-th key's 12x128 coefficient block (and
//     with masks its two mask rows) with cp.async into one of two buffers
//     (16 bytes a thread and copy): visit i+1's block is in flight while
//     visit i is tested, and a prefetch that the stop rule makes needless
//     is waited for and never read.  Each thread waits for its own copies
//     before the stop rule's barrier, which publishes the block to the CTA:
//     one barrier per visit.  A common origin (pinhole primaries) or
//     direction (sun shadows) has its three tile-shared dot products per
//     triangle computed by each warp for itself (a warp barrier, not a CTA
//     one), removing 9 of the 21 multiply-adds per pair.  Each ray tests
//     NV = 4 triangles a step: one 16-byte broadcast load per coefficient
//     row and four independent tests (tile_trace.cuh).
//   Stop rule (exact, as on the TPU): stop when the next key's entry
//     exceeds every live ray's min(best_t, t_max), compared as int32 f32
//     bits, with one __syncthreads_or per visit.  Closest hits keep the
//     packed (quantized t | lane) key, so a tie on quantized t goes to the
//     block visited first, then the lowest lane.  Occluded rays stop at
//     their first hit (in lane order) and set best_t = -3e38, so they stop
//     holding the loop.
// The coefficient table is read from global memory (L2) on every path, so
// the TPU's resident-VMEM vs HBM-DMA split has no counterpart.
//
// What bounds it: f32 operations, 47 per ray-triangle pair tested (29 with
// a common origin, 32 with a common direction; each live ray tests a
// visited block's 128 triangles, an occluded ray stops at its first hit),
// plus the cull's 87 per (tile, subcluster box).  The cull runs here
// because as plain torch it writes a 1024-key page per tile (66 MB per
// 1080p call) and takes twice the time of the whole fused kernel (20.4
// against 10.4 ms on 1080p primaries, NVIDIA H100 80GB HBM3, 700 W).  The
// visit loop is latency-bound (each test is a dependent chain: dots, an
// IEEE division, the accept test); four tests a step and the prefetched
// block raise what a thread has in flight.  Times and ablations: PERF.md.
//
// Numerics: -fmad=false and IEEE division, the same expressions and order
// as the plain cull and the plain twin (render/v7_backend.py::cull_keys,
// trace_keys_plain), so the keys, t and ids agree bit for bit.
//
// Alpha masks (the TPU kernel's _mask_ok): a masked launch stages the
// visited block's two mask rows beside its coefficients and rejects an
// accepted pair whose (u, v) cell bit is 0, on the u and v the accept test
// just computed; ints truncate toward zero as XLA's astype(int32) does.
// The masked variant is its own instantiation, so the unmasked launch pays
// nothing for it.
#include <cuda_runtime.h>

#include "tile_trace.cuh"

namespace {

enum Mode { CLOSEST = 0, OCCLUDED = 1 };

// Keys a thread ranks in the rank sort; more than TILE x RANK_MAX keys go
// through the bitonic network.
constexpr int RANK_MAX = 4;

// Block B's key (cull_keys): the least entry of its four subcluster boxes,
// plus +0.0, packed with its id.
__device__ __forceinline__ int block_key(const Bundle& b, const float* __restrict__ cl_min,
                                         const float* __restrict__ cl_max, int blk,
                                         int id_mask) {
  float e[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) e[q] = sub_entry(b, cl_min, cl_max, NQ * blk + q);
  return pack_key(fminf(fminf(e[0], e[1]), fminf(e[2], e[3])) + 0.0f, blk, id_mask);
}

// Rank of `key` among s[0, n): the number of entries below it (16-byte
// aligned s; keys unique).
__device__ __forceinline__ int rank_of(const int* s, int n, int key) {
  int rank = 0, j = 0;
  for (; j + 4 <= n; j += 4) {
    const int4 x = *reinterpret_cast<const int4*>(s + j);
    rank += (x.x < key) + (x.y < key) + (x.z < key) + (x.w < key);
  }
  for (; j < n; ++j) rank += s[j] < key;
  return rank;
}

// Sort `p` (a power of two) ints of s ascending with the CTA's threads.
__device__ __forceinline__ void bitonic_sort(int* s, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += TILE) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int a = s[i], b = s[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            s[i] = b;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Sorts the n unique keys s[0, n) ascending in place (s holds at least the
// next power of two of n ints above TILE x RANK_MAX keys).  Every thread of
// the CTA calls it; s is published on entry and on return.
__device__ __forceinline__ void sort_keys(int* s, int n) {
  const int lane = threadIdx.x;
  if (n <= TILE * RANK_MAX) {
    int key[RANK_MAX], rank[RANK_MAX];
#pragma unroll
    for (int k = 0; k < RANK_MAX; ++k) {
      const int i = lane + k * TILE;
      key[k] = i < n ? s[i] : 0;
      rank[k] = i < n ? rank_of(s, n, key[k]) : -1;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RANK_MAX; ++k)
      if (rank[k] >= 0) s[rank[k]] = key[k];
    __syncthreads();
    return;
  }
  int p = 1;
  while (p < n) p <<= 1;
  for (int k = n + lane; k < p; k += TILE) s[k] = KEY_PAD;
  __syncthreads();
  bitonic_sort(s, p);
}

// 1 + the lane of the first triangle (in lane order) that one ray hits in
// [tmin, limit] over a staged 128-triangle tile, 0 if none.
template <int COMMON>
__device__ __forceinline__ int first_hit(const float* coef, const float* fam,
                                         const float (&o)[3], const float (&d)[3], float tmin,
                                         float limit) {
  for (int j0 = 0; j0 < TILE; j0 += NV) {
    float c[CROWS][NV], f[3][NV];
    load_step<COMMON>(coef, fam, j0, c, f);
    bool ok[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float t, u, v;
      ok[i] = pair_test<COMMON>(c, f, i, o, d, tmin, limit, t, u, v);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (ok[i]) return j0 + i + 1;
  }
  return 0;
}

// At least 4 CTAs an SM: the register cap (128) leaves ptxas no spill,
// which it made at 72-80 registers without it.
template <int MODE, int COMMON, bool MASK>
__global__ void __launch_bounds__(TILE, 4) trace_v7_kernel(
    const float* __restrict__ rays, const float* __restrict__ cl_min,
    const float* __restrict__ cl_max, const float* __restrict__ coeff,
    const int* __restrict__ amask, float* __restrict__ outf, int* __restrict__ outi, int cb,
    int cap, int id_mask) {
  // Dynamic: the tile's keys (cap ints: compacted by the cull, sorted in
  // place), then the two staging buffers.
  extern __shared__ __align__(16) int dyn[];
  int* keys = dyn;
  float* coefb = reinterpret_cast<float*>(dyn + cap);             // 2 x CROWS x TILE
  int* smaskb = reinterpret_cast<int*>(coefb + 2 * CROWS * TILE);  // 2 x 2 x TILE
  __shared__ __align__(16) float fam[WARPS][3 * TILE];             // each warp's own
  __shared__ float red[WARPS][14];
  __shared__ int wsum[2][WARPS];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane / 32;

  const float* r = rays + (size_t)tile * 8 * TILE;
  const float o[3] = {r[0 * TILE + lane], r[1 * TILE + lane], r[2 * TILE + lane]};
  const float d[3] = {r[3 * TILE + lane], r[4 * TILE + lane], r[5 * TILE + lane]};
  const float tmin = r[6 * TILE + lane], tmax = r[7 * TILE + lane];
  // The tile-shared origin or direction is lane 0's, as in the TPU kernel.
  const int cbase = COMMON == COMMON_DIR ? 3 : 0;
  const float cx = r[(cbase + 0) * TILE], cy = r[(cbase + 1) * TILE],
              cz = r[(cbase + 2) * TILE];

  // Cull: each round's valid keys go to keys[n ...] in block order; warp w
  // writes after the valid keys of warps 0 .. w-1 (wsum, double-buffered
  // by round so that one barrier a round suffices).
  const Bundle bundle = reduce_bundle(o, d, tmin, tmax, red);
  const unsigned below = (1u << (lane & 31)) - 1u;
  const int rounds = (cb + TILE - 1) / TILE;
  int n = 0;
  for (int k = 0; k < rounds; ++k) {
    const int blk = k * TILE + lane;
    const int key = blk < cb ? block_key(bundle, cl_min, cl_max, blk, id_mask) : INVALID;
    const bool valid = key != INVALID;
    const unsigned m = __ballot_sync(FULL, valid);
    if ((lane & 31) == 0) wsum[k & 1][warp] = __popc(m);
    __syncthreads();
    int off = n;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = wsum[k & 1][w];
      off += w < warp ? c : 0;
      n += c;
    }
    if (valid) keys[off + __popc(m & below)] = key;
  }
  __syncthreads();
  sort_keys(keys, n);

  // Stages visit i's block into buffer i & 1 as one copy group: 384 16-byte
  // chunks of coefficients and 64 of mask rows.
  auto stage = [&](int i) {
    const int cid = min(keys[i] & id_mask, cb - 1);
    float* cdst = coefb + (i & 1) * CROWS * TILE;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int c = lane + j * TILE;
      const int off = (c >> 5) * TILE + 4 * (c & 31);
      cp_async16(cdst + off, coeff + (size_t)cid * CROWS * TILE + off, true);
    }
    if (MASK && lane < 64) {
      const int off = (lane >> 5) * TILE + 4 * (lane & 31);
      cp_async16(smaskb + (i & 1) * 2 * TILE + off, amask + (size_t)cid * 2 * TILE + off, true);
    }
    cp_async_commit();
  };

  float best_t = BIG;
  int best_k = -1;
  int visits = 0, pairs = 0;
  float* wfam = fam[warp];
  if (n > 0) stage(0);
  for (int i = 0; i < n; ++i) {
    // This thread's copies of visit i's block; if the stop rule ends the
    // loop here, that prefetch was needless and is never read.
    cp_async_wait<0>();
    const int key = keys[i];
    const int entry = key & ~id_mask;
    const int limit_bits = __float_as_int(fminf(best_t, tmax));
    // Exact stop rule.  The barrier also publishes visit i's block to the
    // CTA and retires visit i-1's reads of the buffer the prefetch below
    // overwrites.
    if (!__syncthreads_or(limit_bits >= entry)) break;
    if (i + 1 < n) stage(i + 1);
    const int cid = min(key & id_mask, cb - 1);
    const float* coef = coefb + (i & 1) * CROWS * TILE;
    const int* smask = smaskb + (i & 1) * 2 * TILE;
    if (COMMON != COMMON_NONE) {
      for (int j = lane & 31; j < TILE; j += 32) {
#pragma unroll
        for (int f = 0; f < 3; ++f)
          wfam[f * TILE + j] = COMMON == COMMON_ORIGIN ? dot_o(coef, 4 * f, j, cx, cy, cz)
                                                       : dot_d(coef, 4 * f, j, cx, cy, cz);
      }
      __syncwarp();
    }
    ++visits;

    const bool live = MODE == CLOSEST ? true : best_t >= 0.0f;
    const float limit = MODE == CLOSEST ? fminf(best_t, tmax) : tmax;
    if (!live || !(tmin <= limit)) continue;  // this ray cannot hit here
    if (MODE == CLOSEST) {
      pairs += TILE;
      const int kbest = closest_key<COMMON, MASK>(coef, wfam, smask, o, d, tmin, limit);
      if (kbest < __float_as_int(best_t)) {
        best_t = __int_as_float(kbest & ~127);
        best_k = cid * TILE + (kbest & 127);
      }
    } else {
      const int first = first_hit<COMMON>(coef, wfam, o, d, tmin, limit);
      pairs += first ? first : TILE;
      if (first) best_t = -BIG;
    }
  }

  float* of = outf + (size_t)tile * 8 * TILE;
  int* oi = outi + (size_t)tile * 8 * TILE;
  of[lane] = MODE == CLOSEST ? best_t : (best_t < 0.0f ? 1.0f : 0.0f);
  oi[lane] = best_k;
  oi[TILE + lane] = visits;
  oi[5 * TILE + lane] = pairs;
}

typedef void (*TraceFn)(const float*, const float*, const float*, const float*, const int*,
                        float*, int*, int, int, int);

// Masks exist in closest mode only (occlusion under alpha is a ladder of
// closest traces); a masked occluded launch has no kernel.
template <int MODE, bool MASK>
TraceFn pick(int common) {
  if (common == COMMON_ORIGIN) return trace_v7_kernel<MODE, COMMON_ORIGIN, MASK>;
  if (common == COMMON_DIR) return trace_v7_kernel<MODE, COMMON_DIR, MASK>;
  return trace_v7_kernel<MODE, COMMON_NONE, MASK>;
}

TraceFn pick(int mode, int common, bool masked) {
  if (mode == CLOSEST) return masked ? pick<CLOSEST, true>(common) : pick<CLOSEST, false>(common);
  return masked ? nullptr : pick<OCCLUDED, false>(common);
}

}  // namespace

extern "C" {

// Launches one CTA per tile on `stream`.  cl_min / cl_max: (4 cb, 3) f32,
// cb >= 1; amask may be null (no alpha masks; closest mode only otherwise).
// Returns cudaGetLastError() after the launch (0 = launched), the error of
// the shared-memory opt-in, or cudaErrorInvalidValue for cb < 1 or a masked
// occluded launch.
int rt_trace_v7(const void* rays, const void* cl_min, const void* cl_max, const void* coeff,
                const void* amask, void* outf, void* outi, int ts, int cb, int id_mask,
                int mode, int common, void* stream) {
  if (ts <= 0) return 0;
  if (cb < 1) return (int)cudaErrorInvalidValue;
  // Key room: cb keys, 16-byte aligned; the bitonic network above
  // TILE x RANK_MAX keys sorts up to the next power of two.
  int cap = (cb + 3) & ~3;
  if (cb > TILE * RANK_MAX) {
    cap = 1;
    while (cap < cb) cap <<= 1;
  }
  const bool masked = amask != nullptr;
  const size_t smem = (size_t)cap * sizeof(int) +
                      (size_t)(2 * CROWS * TILE + (masked ? 2 * 2 * TILE : 0)) * sizeof(float);
  TraceFn fn = pick(mode, common, masked);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  if (smem + attr.sharedSizeBytes > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<ts, TILE, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)cl_min, (const float*)cl_max, (const float*)coeff,
      (const int*)amask, (float*)outf, (int*)outi, cb, cap, id_mask);
  return (int)cudaGetLastError();
}

const char* rt_trace_v7_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
