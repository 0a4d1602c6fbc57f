// v9 quarter-composited ordered-visit closest-hit traversal, written for
// Hopper (sm_90a), with its quarter cull computed in the tile prologue.
//
// Replaces realtimeraytracer_tpu/render/quarter_backend.py::
// trace_blocks_quarter (kernel body _trace_kernel/_tile_body) together with
// the XLA cull that feeds it (render/pallas_backend.py::cull_quarter_keys;
// the port's plain copy is render/v7_backend.py::cull_quarter_keys).  One
// 128-ray tile per CTA, rays (Ts, 8, 128) f32 rows [o.xyz | d.xyz | t_min |
// t_max]; subcluster boxes cl_min / cl_max (4 CB, 3) f32 (subcluster 4B + q
// is lanes [32q, 32q+32) of coefficient block B); coefficient blocks (CB,
// 12, 128) f32, CB <= 1024; an optional pads-before-group table group_off
// (CB*4,) i32 of the SAH-repacked panels; optional alpha masks (CB, 2, 128)
// i32 laid out like the coefficient blocks, i.e. by repacked slot (pad
// lanes 0; bit b = 8 gj + gi in word b >> 5 is 0 where the barycentric cell
// is definitely transparent, ops/alpha_mask.py).
// Outputs: outf row 0 = t (3e38 on a miss); outi row 0 = sorted-triangle id
// (-1 on a miss), row 1 = subclusters visited (4 per composite visit), row
// 5 = ray-triangle pairs this ray tested on real subclusters (live rays
// only; a drained stream's zero lanes are not counted): the bound's
// operation count.
//
// Design.  One thread per ray.
//   Cull (the prologue; cull_quarter_keys' arithmetic, in its order): the
//     tile's rays reduce to the bundle's origin box, direction interval,
//     least t_min and greatest t_max (pad lanes included, as _pack_rays pads
//     them; warp shuffles, then the four warps' partials in order).  Thread
//     `lane` takes blocks B = lane + 128 k and evaluates the interval entry
//     bound of their four subcluster boxes (_sub_entries), packing each into
//     quarter q's key ((entry bits & ~id_mask) | B, +inf bits where the box
//     cannot be hit) in shared memory; warp ballots count each stream.
//   Sort: keys of a stream are unique (the block id sits in the low bits)
//     and every invalid key is greater than every valid one, so each thread
//     counts, for each of its valid keys, the stream's keys below it (16-
//     byte loads) and writes the key to that rank: no compaction, no
//     atomics, one barrier, in place of the bitonic networks' barrier per
//     stage.
//   Visits: visit v takes the v-th key of every stream, which is the TPU
//     kernel's pop order (each iteration pops every stream's minimum).  A
//     visit composites each popped block's own 32-lane quarter into one
//     12x128 shared tile, so one pass over 128 lanes tests four subclusters
//     from (generally) four different blocks.  The tiles are gathered with
//     cp.async (16 bytes a thread and copy) into two buffers: visit v + 1's
//     four quarters are in flight while visit v is tested, and a prefetch
//     that the stop rule makes needless is dropped.  A drained stream's
//     lanes are zero-filled by the copy itself (source size 0), which fails
//     the determinant test: the TPU kernel instead re-composites block cb-1
//     there, with the same result.  The staging buffers reuse the shared
//     memory that held the prologue's keys.  Each ray tests the tile NV = 4
//     triangles a step: one 16-byte broadcast load per coefficient row and
//     four independent tests, which the scheduler overlaps.
//   Stop rule (exact, as on the TPU): the least of the four stream heads is
//     the least remaining entry bound; stop when it exceeds every live ray's
//     min(best_t, t_max), compared as int32 f32 bits, with one
//     __syncthreads_or per visit.  The winning lane's quarter names its
//     block, and group_off maps the repacked slot back to the sorted id.
//
// What bounds it: f32 operations per visit (47 per ray-triangle pair in
// general, 29 with a common origin, 128x128 pairs per visit, most of them
// live on coherent primaries) and the number of visits the cull lets
// through.  On the card the visit loop is bound by latency: each test is a
// dependent chain (dots, an IEEE division, the accept test) and a thread
// has few of them in flight, so the loop issues far below the card's rate.
// Four tests a step and the prefetched composite raise what is in flight;
// the prologue costs about a tenth of the kernel (ablations in PERF.md).
// Before the cull moved in-kernel, the plain-torch cull wrote 16 KB of keys
// per tile (265 MB per 1080p call) and cost twice the kernel it fed.
//
// The cull, the four-wide test and the staging copies live in
// tile_trace.cuh, which trace_v7.cu shares.
//
// Numerics: -fmad=false and IEEE division, the same expressions and order
// as the plain cull and the plain twin (render/v7_backend.py::
// _sub_entries, _pack_id_keys; render/quarter_backend.py::
// trace_quarter_plain), so the keys, t and ids agree bit for bit.
//
// Alpha masks (the TPU kernel's composite_amask + _mask_ok): a masked
// launch composites each popped block's mask rows by the same lane
// quarters as its coefficients, so lane j of the visit reads the mask of
// the slot it tests, which is the repacked slot (the id before the
// group_off remap).  An accepted pair whose (u, v) cell bit is 0 is
// rejected, on the u and v the accept test just computed.  The masked
// variant is its own instantiation; the unmasked launch pays nothing.
#include <cuda_runtime.h>

#include "tile_trace.cuh"

namespace {

constexpr int SUBK = 32;
constexpr int MAX_CB = 1024;                  // RESIDENT_CB

// Quarter key of subcluster c (_sub_entries + _pack_id_keys): entry bits
// with the id bits cleared, or'ed with block id `blk`; INVALID where the
// box cannot be hit by the bundle.
__device__ __forceinline__ int sub_key(const Bundle& b, const float* __restrict__ cl_min,
                                       const float* __restrict__ cl_max, int c, int blk,
                                       int id_mask) {
  return pack_key(sub_entry(b, cl_min, cl_max, c), blk, id_mask);
}

template <int COMMON, bool MASK>
__global__ void __launch_bounds__(TILE) trace_v9_kernel(
    const float* __restrict__ rays, const float* __restrict__ cl_min,
    const float* __restrict__ cl_max, const float* __restrict__ coeff,
    const int* __restrict__ group_off, const int* __restrict__ amask,
    float* __restrict__ outf, int* __restrict__ outi, int cb, int cap, int id_mask) {
  // Dynamic: NQ sorted streams of `cap` keys, then every block's quarter
  // keys (the prologue), whose room the two staging buffers take after.
  extern __shared__ __align__(16) int dyn[];
  int* sq = dyn;
  int* kall = dyn + NQ * cap;
  float* coefb = reinterpret_cast<float*>(kall);               // 2 x CROWS x TILE
  int* smaskb = reinterpret_cast<int*>(coefb + 2 * CROWS * TILE);  // 2 x 2 x TILE
  __shared__ __align__(16) float fam[3 * TILE];
  __shared__ float red[WARPS][14];
  __shared__ int wsum[NQ][WARPS];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane / 32;

  const float* r = rays + (size_t)tile * 8 * TILE;
  const float o[3] = {r[0 * TILE + lane], r[1 * TILE + lane], r[2 * TILE + lane]};
  const float d[3] = {r[3 * TILE + lane], r[4 * TILE + lane], r[5 * TILE + lane]};
  const float tmin = r[6 * TILE + lane], tmax = r[7 * TILE + lane];
  const int cbase = COMMON == COMMON_DIR ? 3 : 0;
  const float cx = r[(cbase + 0) * TILE], cy = r[(cbase + 1) * TILE],
              cz = r[(cbase + 2) * TILE];

  // Cull: quarter q's key of block B goes to kall[q * kcap + B] (INVALID
  // past cb); warp ballots count each stream's valid keys.
  const Bundle bundle = reduce_bundle(o, d, tmin, tmax, red);
  const int rounds = (cb + TILE - 1) / TILE;
  const int kcap = rounds * TILE;
  int mine[NQ] = {0, 0, 0, 0};
  for (int k = 0; k < rounds; ++k) {
    const int blk = k * TILE + lane;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int key = blk < cb ? sub_key(bundle, cl_min, cl_max, NQ * blk + q, blk, id_mask)
                               : INVALID;
      kall[q * kcap + blk] = key;
      mine[q] += __popc(__ballot_sync(FULL, key != INVALID));
    }
  }
  if ((lane & 31) == 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) wsum[q][warp] = mine[q];
  }
  __syncthreads();
  int n[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) n[q] = wsum[q][0] + wsum[q][1] + wsum[q][2] + wsum[q][3];
  // Sort: each valid key goes to its rank among its stream's keys (the
  // INVALID ones are greater than every valid key).
  for (int k = 0; k < rounds; ++k) {
    const int blk = k * TILE + lane;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int key = kall[q * kcap + blk];
      if (key == INVALID) continue;
      const int* s = kall + q * kcap;
      int rank = 0;
      for (int j = 0; j < kcap; j += 4) {
        const int4 x = *reinterpret_cast<const int4*>(s + j);
        rank += (x.x < key) + (x.y < key) + (x.z < key) + (x.w < key);
      }
      sq[q * cap + rank] = key;
    }
  }
  int nmax = 0;
#pragma unroll
  for (int q = 0; q < NQ; ++q) nmax = max(nmax, n[q]);
  __syncthreads();        // the sorted streams are written, kall's room is free

  // Stages visit v's composite into buffer v & 1: 384 16-byte chunks of
  // coefficients (row c >> 5, lanes 4 (c & 31) .. + 3, quarter (c & 31) >> 3)
  // and 64 of mask rows; drained quarters are zero-filled.
  auto stage = [&](int v) {
    float* cdst = coefb + (v & 1) * CROWS * TILE;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int c = lane + i * TILE;
      const int row = c >> 5, m = c & 31, q = m >> 3;
      const bool live = v < n[q];
      const int cid = live ? min(sq[q * cap + v] & id_mask, cb - 1) : 0;
      cp_async16(cdst + row * TILE + 4 * m, coeff + ((size_t)cid * CROWS + row) * TILE + 4 * m,
                 live);
    }
    if (MASK && lane < 64) {
      const int row = lane >> 5, m = lane & 31, q = m >> 3;
      const bool live = v < n[q];
      const int cid = live ? min(sq[q * cap + v] & id_mask, cb - 1) : 0;
      cp_async16(smaskb + (v & 1) * 2 * TILE + row * TILE + 4 * m,
                 amask + ((size_t)cid * 2 + row) * TILE + 4 * m, live);
    }
    cp_async_commit();
  };

  float best_t = BIG;
  int best_k = -1;
  int visits = 0, pairs = 0;
  if (nmax > 0) stage(0);
  for (int v = 0; v < nmax; ++v) {
    int kmin = KEY_PAD;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (v < n[q]) kmin = min(kmin, sq[q * cap + v]);
    const int entry = kmin & ~id_mask;
    const int limit_bits = __float_as_int(fminf(best_t, tmax));
    // Exact stop rule; the barrier also retires the previous visit's reads
    // of the buffer the prefetch below overwrites.
    if (!__syncthreads_or(limit_bits >= entry)) break;
    if (v + 1 < nmax) {
      stage(v + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* coef = coefb + (v & 1) * CROWS * TILE;
    const int* smask = smaskb + (v & 1) * 2 * TILE;
    if (COMMON != COMMON_NONE) {
#pragma unroll
      for (int f = 0; f < 3; ++f)
        fam[f * TILE + lane] = COMMON == COMMON_ORIGIN
                                   ? dot_o(coef, 4 * f, lane, cx, cy, cz)
                                   : dot_d(coef, 4 * f, lane, cx, cy, cz);
      __syncthreads();
    }
    ++visits;

    const float limit = fminf(best_t, tmax);
    if (!(tmin <= limit)) continue;            // this ray cannot hit here
#pragma unroll
    for (int q = 0; q < NQ; ++q) pairs += v < n[q] ? SUBK : 0;
    const int kbest = closest_key<COMMON, MASK>(coef, fam, smask, o, d, tmin, limit);
    if (kbest < __float_as_int(best_t)) {
      const int j = kbest & 127;
      const int q = j / SUBK;
      const int cid = min(sq[q * cap + v] & id_mask, cb - 1);
      best_t = __int_as_float(kbest & ~127);
      best_k = cid * TILE + j - (group_off ? group_off[cid * NQ + q] : 0);
    }
  }
  cp_async_wait<0>();     // a prefetch the stop rule made needless

  float* of = outf + (size_t)tile * 8 * TILE;
  int* oi = outi + (size_t)tile * 8 * TILE;
  of[lane] = best_t;
  oi[lane] = best_k;
  oi[TILE + lane] = NQ * visits;
  oi[5 * TILE + lane] = pairs;
}

typedef void (*TraceFn)(const float*, const float*, const float*, const float*,
                        const int*, const int*, float*, int*, int, int, int);

template <bool MASK>
TraceFn pick(int common) {
  if (common == COMMON_ORIGIN) return trace_v9_kernel<COMMON_ORIGIN, MASK>;
  if (common == COMMON_DIR) return trace_v9_kernel<COMMON_DIR, MASK>;
  return trace_v9_kernel<COMMON_NONE, MASK>;
}

}  // namespace

extern "C" {

// Launches one CTA per tile on `stream`.  cl_min / cl_max: (4 cb, 3) f32,
// 1 <= cb <= 1024; group_off may be null (panels without repacking: ids
// are slot ids); amask may be null (no alpha masks).  Returns
// cudaGetLastError() after the launch (0 = launched), the error of the
// shared-memory opt-in, or cudaErrorInvalidValue for cb outside [1, 1024].
int rt_trace_v9(const void* rays, const void* cl_min, const void* cl_max,
                const void* coeff, const void* group_off, const void* amask,
                void* outf, void* outi, int ts, int cb, int id_mask, int common,
                void* stream) {
  if (ts <= 0) return 0;
  if (cb < 1 || cb > MAX_CB) return (int)cudaErrorInvalidValue;
  const int cap = (cb + 3) & ~3;                     // 16-byte aligned streams
  const size_t streams = (size_t)NQ * cap * sizeof(int);
  const size_t keys = (size_t)NQ * ((cb + TILE - 1) / TILE) * TILE * sizeof(int);
  const size_t staging = (size_t)(2 * CROWS * TILE + (amask ? 2 * 2 * TILE : 0)) * sizeof(float);
  const size_t smem = streams + (keys > staging ? keys : staging);
  TraceFn fn = amask != nullptr ? pick<true>(common) : pick<false>(common);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  if (smem + attr.sharedSizeBytes > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<ts, TILE, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)cl_min, (const float*)cl_max, (const float*)coeff,
      (const int*)group_off, (const int*)amask, (float*)outf, (int*)outi, cb, cap, id_mask);
  return (int)cudaGetLastError();
}

const char* rt_trace_v9_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
