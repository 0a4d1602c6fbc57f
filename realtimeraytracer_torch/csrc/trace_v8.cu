// v8 per-ray two-level hierarchy traversal (non-instanced), written for
// Hopper (sm_90a).
//
// Replaces realtimeraytracer_tpu/render/hier_backend.py::trace_blocks_hier
// (kernel body _trace_kernel/_tile_body) for scenes without instancing.
// Same contract: one 128-ray tile per CTA, rays (Ts, 8, 128) f32 rows
// [o.xyz | d.xyz | t_min | t_max]; box pages from pack_hierarchy: sup
// (SPAGES, 8, 128) f32 (lane = supercluster of 128 blocks, page-major),
// blk (NSUP, 8, 128) f32 (lane = block within the super), rows
// [min.xyz | max.xyz | 0 | 0], pad lanes inverted (+BIG, -BIG);
// coefficient blocks (CB, 12, 128) f32; optional alpha masks (CB, 2, 128)
// i32 (closest mode only; bit b = 8 gj + gi in word b >> 5 is 0 where the
// barycentric cell is definitely transparent, ops/alpha_mask.py); optional
// hints (Ts, hn) i32.
// Outputs: outf row 0 = t (closest; 3e38 on a miss) or the occluded flag,
// row 1 = superclusters popped; outi row 0 = sorted-triangle id (closest,
// -1 on a miss) or the first occluder block (occluded, -1 if none), row 1
// = blocks visited (hint visits included), row 2 = -1 (the instance id of
// the instanced kernel, which is not ported), rows 3 and 4 (occluded) =
// the tile's least and greatest first-occluder block, -1 if none: the
// hints of the next correlated trace.  Work counts, only when launched with
// count = 1 (they cost the sun trace about 14% on the H100, so the render
// path launches without them): outi row 5 = ray-triangle pairs this ray
// tested (up to its first hit in occluded mode), row 6 = slab tests this
// thread made against live windows (its share of the tile's L1 and L2 box
// culls plus its own ray's per-visit tests); retired rays and empty windows
// are not counted.  They are the bound's operation count.
//
// Design.  One thread per ray.
//   Hints in: the tile's hint blocks (clamped to cb-1, -1 = skip) are
//     visited first, so the rays they occlude enter the culls retired.
//   L1: thread s slab-tests super box s against the tile's 128 rays (read
//     from shared memory) and keeps the least entry max(near, 0) over rays
//     whose window [t_min, min(best_t, t_max)] overlaps the box; the keys
//     (entry bits with the super id in the low bits) are sorted once and
//     popped in order.
//   L2: per popped super, thread b does the same for block b against the
//     live windows, then the 128 block keys are sorted and visited in order.
//   Visit: the block's 12x128 coefficients are staged in shared memory;
//     each live ray whose own slab test passes the block box under its
//     live window tests the 128 triangles (v7's math).  Occluded mode
//     retires a ray on its first hit (best_t = -3e38) and records the block.
//   Stop rules, both levels: the next key's entry exceeds every live ray's
//     min(best_t, t_max) (int32 f32 bits), one __syncthreads_or each.
//     Entries are lower bounds (id bits cleared = rounded down), so the
//     traversal is exact.
// Pad boxes are inverted; a min/max slab test would pass them with near =
// -inf, so box validity (min.x <= max.x) is tested explicitly.  Axes with
// |d| <= 1e-12 pass every slab.  Empty lanes ([3e38, -3e38)) have negative
// limit bits and never hold a loop.
// Kept from the TPU kernel: the two levels, live-window culls, ordered
// visits, exact stop rules, hints.  Dropped, being scheduling for the TPU's
// scalar unit: multi-pop `pack`, the cond `stride` and the capped re-cull
// rounds; the per-ray slab test at each visit subsumes the re-cull.  The
// coefficient table is read from global memory on every path, so the TPU's
// resident vs HBM-DMA split has no counterpart.  The JAX kernel packs L1
// ids into 12 bits and truncates above 3072 supers; here the id bits grow
// with the super count and the wrapper refuses more supers than the
// shared-memory sort holds.
//
// What bounds it: f32 operations, 47 per ray-triangle pair tested (32 with
// a common direction; rays whose slab test fails skip the visit, occluded
// rays stop at their first hit) and 27 per slab test (the tile's 128 rays
// against each super box, then against the 128 block boxes of each popped
// super, and each live ray once per visit).
//
// Alpha masks (the TPU kernel's intersect_block with am_ref): a masked
// launch stages the visited block's two mask rows in shared memory beside
// its coefficients and rejects an accepted pair whose (u, v) cell bit is
// 0, on the u and v the accept test just computed.  The masked variant is
// its own instantiation (closest mode only), so other launches pay nothing.
//
// Numerics: -fmad=false, the same expressions and order as the plain twin
// (render/hier_backend.py::trace_hier_plain).
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int SUP = 128;
constexpr int CROWS = 12;
constexpr float BIG = 3.0e38f;
constexpr float EPS = 1e-12f;
constexpr int INVALID = 0x7F800000;
constexpr int KEY_PAD = 0x7FFFFFFF;
constexpr int BLK_BITS = 7;           // block-in-super id bits of L2 keys

enum Mode { CLOSEST = 0, OCCLUDED = 1 };
enum Common { COMMON_NONE = 0, COMMON_ORIGIN = 1, COMMON_DIR = 2 };

__device__ __forceinline__ float dot_o(const float* c, int base, int j,
                                      float x, float y, float z) {
  return ((x * c[(base + 0) * TILE + j] + y * c[(base + 1) * TILE + j]) +
          z * c[(base + 2) * TILE + j]) + c[(base + 3) * TILE + j];
}

__device__ __forceinline__ float dot_d(const float* c, int base, int j,
                                      float x, float y, float z) {
  return (x * c[(base + 0) * TILE + j] + y * c[(base + 1) * TILE + j]) +
         z * c[(base + 2) * TILE + j];
}

// Slab test of one ray against box (lo, hi) with window [tmin, limit]:
// returns max(near, 0), or +inf if the ray's window misses the box.
// fl: bit a set where |d_a| <= EPS (the axis passes every slab).
__device__ __forceinline__ float slab_entry(const float* lo, const float* hi,
                                           const float* o, const float* inv,
                                           int fl, float tmin, float limit) {
  float near = 0.0f, far = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float na, fa;
    if (fl & (1 << a)) {
      na = -BIG;
      fa = BIG;
    } else {
      const float t0 = (lo[a] - o[a]) * inv[a];
      const float t1 = (hi[a] - o[a]) * inv[a];
      na = fminf(t0, t1);
      fa = fmaxf(t0, t1);
    }
    near = a == 0 ? na : fmaxf(near, na);
    far = a == 0 ? fa : fminf(far, fa);
  }
  const bool ok = lo[0] <= hi[0] && near <= far && far >= tmin && near <= limit;
  return ok ? fmaxf(near, 0.0f) : __int_as_float(INVALID);
}

// The alpha-mask bit of lane j's triangle at barycentrics (u, v); m holds
// the visited block's two mask rows (2 x TILE).
__device__ __forceinline__ bool mask_bit(const int* m, int j, float u, float v) {
  const int gi = min(max(__float2int_rz(u * 8.0f), 0), 7);
  const int gj = min(max(__float2int_rz(v * 8.0f), 0), 7);
  const int b = gj * 8 + gi;
  return ((static_cast<unsigned>(m[(b >> 5) * TILE + j]) >> (b & 31)) & 1u) != 0u;
}

// Sort `p` (a power of two) ints of s ascending with the CTA's threads.
__device__ void bitonic_sort(int* s, int p) {
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

// A barrier; with COUNT, also the number of the CTA's threads whose
// predicate holds.
template <bool COUNT>
__device__ __forceinline__ int live_count(bool pred) {
  if (COUNT) return __syncthreads_count(pred);
  __syncthreads();
  return 0;
}

struct Tile {
  float o[3][TILE];      // origins
  float inv[3][TILE];    // guarded inverse directions
  int fl[TILE];          // parallel-axis bits
  float tmin[TILE];
  float limit[TILE];     // live windows' upper ends, refreshed per cull
};

// Least entry over the tile's rays of box `b` of a (8, 128) box page, or
// +inf bits when no ray's window overlaps it.  A valid box adds `live`, the
// tile's rays with a live window, to this thread's slab count (counted once
// per cull by the caller's barrier, which keeps the count out of the ray
// loop).
template <bool COUNT>
__device__ __forceinline__ float box_min_entry(const Tile& T, const float* page,
                                              int b, int live, int* work) {
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = page[a * TILE + b];
    hi[a] = page[(3 + a) * TILE + b];
  }
  float emin = __int_as_float(INVALID);
  if (!(lo[0] <= hi[0])) return emin;
  if (COUNT) work[TILE + threadIdx.x] += live;
  for (int r = 0; r < TILE; ++r) {
    const float o[3] = {T.o[0][r], T.o[1][r], T.o[2][r]};
    const float inv[3] = {T.inv[0][r], T.inv[1][r], T.inv[2][r]};
    emin = fminf(emin, slab_entry(lo, hi, o, inv, T.fl[r], T.tmin[r], T.limit[r]));
  }
  return emin;
}

// One block visit: stage the block's coefficients, then each live ray whose
// window still overlaps the block box tests its 128 triangles.  Every thread
// of the CTA calls it (it holds barriers); lane = threadIdx.x.
template <int MODE, int COMMON, bool COUNT, bool MASK>
__device__ __forceinline__ void visit(
    int cid, const float* __restrict__ coeff, const float* __restrict__ blk,
    const int* __restrict__ amask, float* coef, float* fam, int* smask,
    const float* o, const float* d, const float* inv,
    int fl, float tmin, float tmax, float cx, float cy, float cz,
    float& best_t, int& best_k, int& visits, int* work) {
  const int lane = threadIdx.x;
  const float* cg = coeff + (size_t)cid * CROWS * TILE;
#pragma unroll
  for (int row = 0; row < CROWS; ++row)
    coef[row * TILE + lane] = cg[row * TILE + lane];
  if (MASK) {
    const int* mg = amask + (size_t)cid * 2 * TILE;
    smask[lane] = mg[lane];
    smask[TILE + lane] = mg[TILE + lane];
  }
  if (COMMON != COMMON_NONE) {
    __syncthreads();
#pragma unroll
    for (int f = 0; f < 3; ++f)
      fam[f * TILE + lane] = COMMON == COMMON_ORIGIN
                                 ? dot_o(coef, 4 * f, lane, cx, cy, cz)
                                 : dot_d(coef, 4 * f, lane, cx, cy, cz);
  }
  __syncthreads();
  ++visits;
  const float limit = fminf(best_t, tmax);
  const bool live = MODE == CLOSEST || best_t >= 0.0f;
  if (!live || !(tmin <= limit)) return;
  const float* page = blk + (size_t)(cid / SUP) * 8 * TILE;
  const int b = cid % SUP;
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = page[a * TILE + b];
    hi[a] = page[(3 + a) * TILE + b];
  }
  if (COUNT) ++work[TILE + lane];
  if (!(slab_entry(lo, hi, o, inv, fl, tmin, limit) < __int_as_float(INVALID)))
    return;
  int kbest = KEY_PAD;
  bool hit = false;
  int tested = TILE;
  for (int j = 0; j < TILE; ++j) {
    float s0, ou, ov, s1, du, dv;
    if (COMMON == COMMON_ORIGIN) {
      s0 = fam[j];
      ou = fam[TILE + j];
      ov = fam[2 * TILE + j];
    } else {
      s0 = dot_o(coef, 0, j, o[0], o[1], o[2]);
      ou = dot_o(coef, 4, j, o[0], o[1], o[2]);
      ov = dot_o(coef, 8, j, o[0], o[1], o[2]);
    }
    if (COMMON == COMMON_DIR) {
      s1 = fam[j];
      du = fam[TILE + j];
      dv = fam[2 * TILE + j];
    } else {
      s1 = dot_d(coef, 0, j, d[0], d[1], d[2]);
      du = dot_d(coef, 4, j, d[0], d[1], d[2]);
      dv = dot_d(coef, 8, j, d[0], d[1], d[2]);
    }
    const bool den_ok = fabsf(s1) > EPS;
    const float t = den_ok ? (-s0) / s1 : BIG;
    const float u = ou + t * du;
    const float v = ov + t * dv;
    bool ok = den_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
              t >= tmin && t <= limit;
    if (MASK && ok) ok = mask_bit(smask, j, u, v);
    if (MODE == CLOSEST) {
      const float tm = ok ? t : __int_as_float(INVALID);
      kbest = min(kbest, (__float_as_int(tm) & ~127) | j);
    } else if (ok) {
      hit = true;
      if (COUNT) tested = j + 1;
      break;
    }
  }
  if (COUNT) work[lane] += tested;
  if (MODE == CLOSEST) {
    if (kbest < __float_as_int(best_t)) {
      best_t = __int_as_float(kbest & ~127);
      best_k = cid * TILE + (kbest & 127);
    }
  } else if (hit) {
    best_t = -BIG;
    if (best_k < 0) best_k = cid;
  }
}

template <int MODE, int COMMON, bool COUNT, bool MASK>
__global__ void __launch_bounds__(TILE) trace_v8_kernel(
    const float* __restrict__ rays, const float* __restrict__ sup,
    const float* __restrict__ blk, const float* __restrict__ coeff,
    const int* __restrict__ amask, const int* __restrict__ hints,
    float* __restrict__ outf, int* __restrict__ outi, int nsup, int cap1,
    int cb, int hn, int l1_mask) {
  extern __shared__ int l1keys[];                 // cap1 super keys
  __shared__ Tile T;
  __shared__ float coef[CROWS * TILE];
  __shared__ float fam[3 * TILE];
  __shared__ int smask[MASK ? 2 * TILE : 1];
  __shared__ int l2keys[SUP];
  __shared__ int count;
  __shared__ int hint_lo, hint_hi;
  // Work counts (COUNT only), kept in shared memory rather than registers:
  // [0, TILE) pairs tested, [TILE, 2 TILE) slab tests.
  __shared__ int work[COUNT ? 2 * TILE : 1];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;

  const float* r = rays + (size_t)tile * 8 * TILE;
  const float o[3] = {r[0 * TILE + lane], r[1 * TILE + lane], r[2 * TILE + lane]};
  const float d[3] = {r[3 * TILE + lane], r[4 * TILE + lane], r[5 * TILE + lane]};
  const float tmin = r[6 * TILE + lane], tmax = r[7 * TILE + lane];
  const int cbase = COMMON == COMMON_DIR ? 3 : 0;
  const float cx = r[(cbase + 0) * TILE], cy = r[(cbase + 1) * TILE],
              cz = r[(cbase + 2) * TILE];
  float inv[3];
  int fl = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const bool par = fabsf(d[a]) <= EPS;
    fl |= par ? (1 << a) : 0;
    inv[a] = 1.0f / (par ? 1.0f : d[a]);
    T.o[a][lane] = o[a];
    T.inv[a][lane] = inv[a];
  }
  T.fl[lane] = fl;
  T.tmin[lane] = tmin;

  float best_t = BIG;
  int best_k = -1;
  int visits = 0, l1pops = 0;
  if (COUNT) {
    work[lane] = 0;
    work[TILE + lane] = 0;
  }

  // Hints in: visit the previous correlated trace's occluder blocks.
  for (int j = 0; j < hn; ++j) {
    const int h = hints[(size_t)tile * hn + j];
    if (h >= 0) {
      __syncthreads();            // retire the previous visit's reads
      visit<MODE, COMMON, COUNT, MASK>(min(h, cb - 1), coeff, blk, amask, coef, fam,
                                       smask, o, d, inv, fl, tmin, tmax, cx, cy, cz,
                                       best_t, best_k, visits, work);
    }
  }

  // L1: least entry per super over the live windows, sorted once.
  if (lane == 0) count = 0;
  T.limit[lane] = fminf(best_t, tmax);
  const int live1 = live_count<COUNT>(tmin <= fminf(best_t, tmax));
  for (int s = lane; s < nsup; s += TILE) {
    const float e = box_min_entry<COUNT>(T, sup + (size_t)(s / TILE) * 8 * TILE, s % TILE,
                                  live1, work);
    if (__float_as_int(e) != INVALID)
      l1keys[atomicAdd(&count, 1)] = (__float_as_int(e) & ~l1_mask) | s;
  }
  __syncthreads();
  const int n1 = count;
  int p1 = 1;
  while (p1 < n1) p1 <<= 1;
  for (int k = n1 + lane; k < p1; k += TILE) l1keys[k] = KEY_PAD;
  __syncthreads();
  bitonic_sort(l1keys, p1);

  for (int i = 0; i < n1; ++i) {
    const int key = l1keys[i];
    if (!__syncthreads_or(__float_as_int(fminf(best_t, tmax)) >= (key & ~l1_mask)))
      break;
    ++l1pops;
    const int s = key & l1_mask;
    // L2: block keys of this super against the live windows.
    T.limit[lane] = fminf(best_t, tmax);
    const int live2 = live_count<COUNT>(tmin <= fminf(best_t, tmax));
    const float e = box_min_entry<COUNT>(T, blk + (size_t)s * 8 * TILE, lane, live2, work);
    l2keys[lane] = __float_as_int(e) == INVALID
                       ? INVALID
                       : (__float_as_int(e) & ~((1 << BLK_BITS) - 1)) | lane;
    __syncthreads();
    bitonic_sort(l2keys, SUP);
    for (int j = 0; j < SUP; ++j) {
      const int k2 = l2keys[j];
      if (k2 == INVALID) break;                      // uniform: shared read
      if (!__syncthreads_or(__float_as_int(fminf(best_t, tmax)) >=
                            (k2 & ~((1 << BLK_BITS) - 1))))
        break;
      const int cid = min(s * SUP + (k2 & ((1 << BLK_BITS) - 1)), cb - 1);
      visit<MODE, COMMON, COUNT, MASK>(cid, coeff, blk, amask, coef, fam, smask, o, d,
                                       inv, fl, tmin, tmax, cx, cy, cz, best_t, best_k,
                                       visits, work);
    }
  }

  float* of = outf + (size_t)tile * 8 * TILE;
  int* oi = outi + (size_t)tile * 8 * TILE;
  of[lane] = MODE == CLOSEST ? best_t : (best_t < 0.0f ? 1.0f : 0.0f);
  of[TILE + lane] = (float)l1pops;
  oi[lane] = best_k;
  oi[TILE + lane] = visits;
  oi[2 * TILE + lane] = -1;
  if (COUNT) {
    oi[5 * TILE + lane] = work[lane];
    oi[6 * TILE + lane] = work[TILE + lane];
  }
  if (MODE == OCCLUDED) {
    // Hints out: the tile's least and greatest first-occluder block.
    if (lane == 0) {
      hint_lo = KEY_PAD;
      hint_hi = -1;
    }
    __syncthreads();
    if (best_k >= 0) {
      atomicMin(&hint_lo, best_k);
      atomicMax(&hint_hi, best_k);
    }
    __syncthreads();
    oi[3 * TILE + lane] = hint_lo == KEY_PAD ? -1 : hint_lo;
    oi[4 * TILE + lane] = hint_hi;
  }
}

typedef void (*TraceFn)(const float*, const float*, const float*, const float*,
                        const int*, const int*, float*, int*, int, int, int, int,
                        int);

// Masks exist in closest mode only (occlusion under alpha is a ladder of
// closest traces); a masked occluded launch has no kernel.
template <bool COUNT>
TraceFn pick(int mode, int common, bool masked) {
  if (mode == CLOSEST) {
    if (masked) {
      if (common == COMMON_ORIGIN) return trace_v8_kernel<CLOSEST, COMMON_ORIGIN, COUNT, true>;
      if (common == COMMON_DIR) return trace_v8_kernel<CLOSEST, COMMON_DIR, COUNT, true>;
      return trace_v8_kernel<CLOSEST, COMMON_NONE, COUNT, true>;
    }
    if (common == COMMON_ORIGIN) return trace_v8_kernel<CLOSEST, COMMON_ORIGIN, COUNT, false>;
    if (common == COMMON_DIR) return trace_v8_kernel<CLOSEST, COMMON_DIR, COUNT, false>;
    return trace_v8_kernel<CLOSEST, COMMON_NONE, COUNT, false>;
  }
  if (masked) return nullptr;
  if (common == COMMON_ORIGIN) return trace_v8_kernel<OCCLUDED, COMMON_ORIGIN, COUNT, false>;
  if (common == COMMON_DIR) return trace_v8_kernel<OCCLUDED, COMMON_DIR, COUNT, false>;
  return trace_v8_kernel<OCCLUDED, COMMON_NONE, COUNT, false>;
}

}  // namespace

extern "C" {

// Launches one CTA per tile on `stream`.  amask may be null (no alpha
// masks; closest mode only otherwise); hints may be null (hn = 0); count
// = 1 also writes the work counts (outi rows 5 and 6).  Returns
// cudaGetLastError() after the launch (0 = launched), or the error of the
// shared-memory opt-in.
int rt_trace_v8(const void* rays, const void* sup, const void* blk,
                const void* coeff, const void* amask, const void* hints,
                void* outf, void* outi, int ts, int nsup, int cb, int hn,
                int l1_mask, int mode, int common, int count, void* stream) {
  if (ts <= 0) return 0;
  int cap1 = 1;
  while (cap1 < nsup) cap1 <<= 1;
  const size_t smem = (size_t)cap1 * sizeof(int);
  const bool masked = amask != nullptr;
  TraceFn fn = count ? pick<true>(mode, common, masked) : pick<false>(mode, common, masked);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (smem + sizeof(Tile) + (CROWS + 8) * TILE * sizeof(float) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<ts, TILE, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)sup, (const float*)blk,
      (const float*)coeff, (const int*)amask, (const int*)hints, (float*)outf,
      (int*)outi, nsup, cap1, cb, hn, l1_mask);
  return (int)cudaGetLastError();
}

const char* rt_trace_v8_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
