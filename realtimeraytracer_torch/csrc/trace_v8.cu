// v8 per-ray two-level hierarchy traversal, written for Hopper (sm_90a),
// with an instanced instantiation for shared-geometry scenes.
//
// Replaces realtimeraytracer_tpu/render/hier_backend.py::trace_blocks_hier
// (kernel body _trace_kernel/_tile_body), both its non-instanced form and
// its instanced one (instanced=True: the (instance, super) pair level).
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
// row 1 = superclusters (or pairs) popped; outi row 0 = sorted-triangle id
// (closest, -1 on a miss) or the first occluder block (occluded, -1 if
// none), row 1 = blocks visited (hint visits included), row 2 = the
// instance of the closest hit (instanced closest; -1 on a miss and
// otherwise), rows 3 and 4 (occluded) = the tile's least and greatest
// first-occluder block, -1 if none: the hints of the next correlated
// trace.  Work counts, only when launched with
// count = 1 (they cost the sun trace about 14% on the H100, so the render
// path launches without them): outi row 5 = ray-triangle pairs this ray
// tested (up to its first hit in occluded mode), row 6 = slab tests this
// thread made against live windows (its share of the tile's L1 and L2 box
// culls plus its own ray's per-visit tests), row 7 (instanced) = the
// mesh-space transforms of this ray, one per popped pair while its window
// is live; retired rays and empty windows are not counted.  They are the
// bound's operation count.
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
// Instanced scenes (INST, entry rt_trace_v8_inst; the TPU kernel's
// _tile_body with instanced=True).  L1 holds (instance, super) pairs with
// world boxes (pair pages (SPAGES, 8, 128), lane = pair row); pair_tab
// (NP, 4) i32 rows [instance, blk row, block base, valid]; inst_inv (I, 12)
// f32 world-to-mesh rows [R (row-major) | t]; blk and coeff (and the masks)
// are the mesh-space pools shared by every instance.  The L1 cull runs in
// world space; per popped pair the pair row and the instance's inverse
// transform are staged in shared memory, each thread transforms its own
// ray into mesh space (((r0 x + r1 y) + r2 z) + t, directions not
// renormalized, so t is the world t: the affine map keeps it) and
// re-derives its inverse direction and parallel-axis bits; the L2 cull on
// blk row and the visits then run in mesh space with cid = block base +
// block.  Visits use per-ray columns only (a common origin or direction is
// a world column), so INST instantiates COMMON_NONE alone.  Closest keeps
// the instance of the best key; occluded retires a ray on its first hit.
// Hints are refused (hn = 0).  What changes the design against the
// non-instanced form: L1 has thousands of boxes (the 120k-triangle foliage
// has 2,584 pairs, against 8 supers baked), so each cull loops over a
// compacted list of the tile's live rays, a tile with none skips the
// traversal, and the L1 sort takes up to SPAGES*128 keys (padded to 4,096:
// 16 KB of dynamic shared memory).
//
// Numerics: -fmad=false, the same expressions and order as the plain twins
// (render/hier_backend.py::trace_hier_plain, trace_hier_inst_plain).
#include <cuda_runtime.h>

#include <type_traits>

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

// The instanced kernel's shared state (INST only).
struct InstTile {
  Tile m;                // the tile's rays in the popped pair's mesh space
  int live[TILE];        // lanes whose window is live, compacted per cull
  int nlive;
  float xf[12];          // the popped pair's instance inverse [R | t]
  int brow, bbase, inst; // its blk row, block base and instance
};

// Compacts the lanes whose window is live into I.live; returns their
// count.  Every thread of the CTA calls it (it holds barriers).  The order
// of the list varies from run to run; the culls only take minima over it.
__device__ __forceinline__ int compact_live(InstTile& I, bool live) {
  if (threadIdx.x == 0) I.nlive = 0;
  __syncthreads();
  if (live) I.live[atomicAdd(&I.nlive, 1)] = threadIdx.x;
  __syncthreads();
  return I.nlive;
}

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

// box_min_entry over the `nlive` compacted live rays `live` only (INST);
// the same minimum, as rays outside the list have empty windows.
template <bool COUNT>
__device__ __forceinline__ float box_min_entry_live(const Tile& T, const int* live,
                                                   int nlive, const float* page,
                                                   int b, int* work) {
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = page[a * TILE + b];
    hi[a] = page[(3 + a) * TILE + b];
  }
  float emin = __int_as_float(INVALID);
  if (!(lo[0] <= hi[0])) return emin;
  if (COUNT) work[TILE + threadIdx.x] += nlive;
  for (int k = 0; k < nlive; ++k) {
    const int r = live[k];
    const float o[3] = {T.o[0][r], T.o[1][r], T.o[2][r]};
    const float inv[3] = {T.inv[0][r], T.inv[1][r], T.inv[2][r]};
    emin = fminf(emin, slab_entry(lo, hi, o, inv, T.fl[r], T.tmin[r], T.limit[r]));
  }
  return emin;
}

// One block visit: stage the block's coefficients, then each live ray whose
// window still overlaps the block box (lane b of the box page `page`) tests
// its 128 triangles.  Every thread of the CTA calls it (it holds barriers);
// lane = threadIdx.x.  A closest hit that improves best_t sets best_i to
// `inst` (the instanced kernel's instance; -1 otherwise).
template <int MODE, int COMMON, bool COUNT, bool MASK>
__device__ __forceinline__ void visit(
    int cid, const float* __restrict__ coeff, const float* __restrict__ page, int b,
    const int* __restrict__ amask, float* coef, float* fam, int* smask,
    const float* o, const float* d, const float* inv,
    int fl, float tmin, float tmax, float cx, float cy, float cz,
    float& best_t, int& best_k, int inst, int& best_i, int& visits, int* work) {
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
      best_i = inst;
    }
  } else if (hit) {
    best_t = -BIG;
    if (best_k < 0) best_k = cid;
  }
}

template <int MODE, int COMMON, bool COUNT, bool MASK, bool INST>
__global__ void __launch_bounds__(TILE) trace_v8_kernel(
    const float* __restrict__ rays, const float* __restrict__ sup,
    const float* __restrict__ blk, const float* __restrict__ coeff,
    const int* __restrict__ amask, const int* __restrict__ hints,
    const int* __restrict__ pair_tab, const float* __restrict__ inst_inv,
    float* __restrict__ outf, int* __restrict__ outi, int nsup, int cap1,
    int cb, int hn, int l1_mask, int nblk, int ninst) {
  extern __shared__ int l1keys[];                 // cap1 super (pair) keys
  __shared__ Tile T;
  __shared__ float coef[CROWS * TILE];
  __shared__ float fam[3 * TILE];
  __shared__ int smask[MASK ? 2 * TILE : 1];
  __shared__ int l2keys[SUP];
  __shared__ int count;
  __shared__ int hint_lo, hint_hi;
  // Work counts (COUNT only), kept in shared memory rather than registers:
  // [0, TILE) pairs tested, [TILE, 2 TILE) slab tests, [2 TILE, 3 TILE)
  // mesh-space transforms (INST).
  __shared__ int work[COUNT ? (INST ? 3 : 2) * TILE : 1];
  __shared__ typename std::conditional<INST, InstTile, int>::type I;
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
  // The popped pair's mesh-space ray (INST; the world ray otherwise).
  float mo[3] = {o[0], o[1], o[2]}, md[3] = {d[0], d[1], d[2]};
  float minv[3] = {inv[0], inv[1], inv[2]};
  int mfl = fl;

  float best_t = BIG;
  int best_k = -1, best_i = -1;
  int visits = 0, l1pops = 0;
  if (COUNT) {
    work[lane] = 0;
    work[TILE + lane] = 0;
    if (INST) work[2 * TILE + lane] = 0;
  }

  // Hints in: visit the previous correlated trace's occluder blocks.
  for (int j = 0; j < hn; ++j) {
    const int h = hints[(size_t)tile * hn + j];
    if (h >= 0) {
      __syncthreads();            // retire the previous visit's reads
      const int hc = min(h, cb - 1);
      visit<MODE, COMMON, COUNT, MASK>(hc, coeff, blk + (size_t)(hc / SUP) * 8 * TILE,
                                       hc % SUP, amask, coef, fam, smask, o, d, inv, fl,
                                       tmin, tmax, cx, cy, cz, best_t, best_k, -1, best_i,
                                       visits, work);
    }
  }

  // L1: least entry per super (pair) over the live windows, sorted once.
  if (lane == 0) count = 0;
  T.limit[lane] = fminf(best_t, tmax);
  if constexpr (INST) {
    const int live1 = compact_live(I, tmin <= fminf(best_t, tmax));
    if (live1 > 0) {
      for (int s = lane; s < nsup; s += TILE) {
        const float e = box_min_entry_live<COUNT>(T, I.live, live1,
                                                  sup + (size_t)(s / TILE) * 8 * TILE,
                                                  s % TILE, work);
        if (__float_as_int(e) != INVALID)
          l1keys[atomicAdd(&count, 1)] = (__float_as_int(e) & ~l1_mask) | s;
      }
    }
  } else {
    const int live1 = live_count<COUNT>(tmin <= fminf(best_t, tmax));
    for (int s = lane; s < nsup; s += TILE) {
      const float e = box_min_entry<COUNT>(T, sup + (size_t)(s / TILE) * 8 * TILE, s % TILE,
                                           live1, work);
      if (__float_as_int(e) != INVALID)
        l1keys[atomicAdd(&count, 1)] = (__float_as_int(e) & ~l1_mask) | s;
    }
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
    // L2: block keys of this super (of this pair's super, in mesh space)
    // against the live windows.
    const float* page = blk + (size_t)s * 8 * TILE;
    int base = s * SUP, inst = -1;
    float e;
    if constexpr (INST) {
      if (lane < 12) {
        const int* row = pair_tab + (size_t)s * 4;
        const int ins = min(max(row[0], 0), ninst - 1);
        I.xf[lane] = inst_inv[(size_t)ins * 12 + lane];
        if (lane == 0) {
          I.inst = ins;
          I.brow = min(max(row[1], 0), nblk - 1);
          I.bbase = row[2];
        }
      }
      __syncthreads();
      inst = I.inst;
      page = blk + (size_t)I.brow * 8 * TILE;
      base = I.bbase;
      mfl = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float* x = I.xf + 3 * a;
        mo[a] = ((x[0] * o[0] + x[1] * o[1]) + x[2] * o[2]) + I.xf[9 + a];
        md[a] = (x[0] * d[0] + x[1] * d[1]) + x[2] * d[2];
        const bool par = fabsf(md[a]) <= EPS;
        mfl |= par ? (1 << a) : 0;
        minv[a] = 1.0f / (par ? 1.0f : md[a]);
        I.m.o[a][lane] = mo[a];
        I.m.inv[a][lane] = minv[a];
      }
      I.m.fl[lane] = mfl;
      I.m.tmin[lane] = tmin;
      I.m.limit[lane] = fminf(best_t, tmax);
      const bool live = tmin <= fminf(best_t, tmax);
      if (COUNT && live) ++work[2 * TILE + lane];
      const int live2 = compact_live(I, live);
      e = box_min_entry_live<COUNT>(I.m, I.live, live2, page, lane, work);
    } else {
      T.limit[lane] = fminf(best_t, tmax);
      const int live2 = live_count<COUNT>(tmin <= fminf(best_t, tmax));
      e = box_min_entry<COUNT>(T, page, lane, live2, work);
    }
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
      const int b = k2 & ((1 << BLK_BITS) - 1);
      const int cid = min(base + b, cb - 1);
      visit<MODE, COMMON, COUNT, MASK>(cid, coeff, page, b, amask, coef, fam, smask, mo, md,
                                       minv, mfl, tmin, tmax, cx, cy, cz, best_t, best_k,
                                       inst, best_i, visits, work);
    }
  }

  float* of = outf + (size_t)tile * 8 * TILE;
  int* oi = outi + (size_t)tile * 8 * TILE;
  of[lane] = MODE == CLOSEST ? best_t : (best_t < 0.0f ? 1.0f : 0.0f);
  of[TILE + lane] = (float)l1pops;
  oi[lane] = best_k;
  oi[TILE + lane] = visits;
  oi[2 * TILE + lane] = best_i;
  if (COUNT) {
    oi[5 * TILE + lane] = work[lane];
    oi[6 * TILE + lane] = work[TILE + lane];
    if (INST) oi[7 * TILE + lane] = work[2 * TILE + lane];
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
                        const int*, const int*, const int*, const float*, float*, int*,
                        int, int, int, int, int, int, int);

// Masks exist in closest mode only (occlusion under alpha is a ladder of
// closest traces); a masked occluded launch has no kernel.
template <bool COUNT>
TraceFn pick(int mode, int common, bool masked) {
  if (mode == CLOSEST) {
    if (masked) {
      if (common == COMMON_ORIGIN) return trace_v8_kernel<CLOSEST, COMMON_ORIGIN, COUNT, true, false>;
      if (common == COMMON_DIR) return trace_v8_kernel<CLOSEST, COMMON_DIR, COUNT, true, false>;
      return trace_v8_kernel<CLOSEST, COMMON_NONE, COUNT, true, false>;
    }
    if (common == COMMON_ORIGIN) return trace_v8_kernel<CLOSEST, COMMON_ORIGIN, COUNT, false, false>;
    if (common == COMMON_DIR) return trace_v8_kernel<CLOSEST, COMMON_DIR, COUNT, false, false>;
    return trace_v8_kernel<CLOSEST, COMMON_NONE, COUNT, false, false>;
  }
  if (masked) return nullptr;
  if (common == COMMON_ORIGIN) return trace_v8_kernel<OCCLUDED, COMMON_ORIGIN, COUNT, false, false>;
  if (common == COMMON_DIR) return trace_v8_kernel<OCCLUDED, COMMON_DIR, COUNT, false, false>;
  return trace_v8_kernel<OCCLUDED, COMMON_NONE, COUNT, false, false>;
}

// The instanced instantiations: per-ray columns only (COMMON_NONE).
template <bool COUNT>
TraceFn pick_inst(int mode, bool masked) {
  if (mode == CLOSEST)
    return masked ? trace_v8_kernel<CLOSEST, COMMON_NONE, COUNT, true, true>
                  : trace_v8_kernel<CLOSEST, COMMON_NONE, COUNT, false, true>;
  if (masked) return nullptr;
  return trace_v8_kernel<OCCLUDED, COMMON_NONE, COUNT, false, true>;
}

// Launches `fn` with cap1 = the L1 key count padded to a power of two, as
// dynamic shared memory, opted into where the CTA's total passes 48 KB.
int launch(TraceFn fn, size_t static_smem, const void* rays, const void* sup,
           const void* blk, const void* coeff, const void* amask, const void* hints,
           const void* pair_tab, const void* inst_inv, void* outf, void* outi, int ts,
           int nl1, int cb, int hn, int l1_mask, int nblk, int ninst, void* stream) {
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int cap1 = 1;
  while (cap1 < nl1) cap1 <<= 1;
  const size_t smem = (size_t)cap1 * sizeof(int);
  if (smem + static_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<ts, TILE, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)sup, (const float*)blk,
      (const float*)coeff, (const int*)amask, (const int*)hints,
      (const int*)pair_tab, (const float*)inst_inv, (float*)outf, (int*)outi,
      nl1, cap1, cb, hn, l1_mask, nblk, ninst);
  return (int)cudaGetLastError();
}

// An upper bound of a CTA's static shared memory (Tile, the coefficient,
// dot, mask, key and work rows, and with INST the InstTile).
constexpr size_t STATIC_SMEM = sizeof(Tile) + (CROWS + 3 + 2 + 1 + 3) * TILE * sizeof(float) + 64;

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
  const bool masked = amask != nullptr;
  TraceFn fn = count ? pick<true>(mode, common, masked) : pick<false>(mode, common, masked);
  return launch(fn, STATIC_SMEM, rays, sup, blk, coeff, amask, hints, nullptr, nullptr,
                outf, outi, ts, nsup, cb, hn, l1_mask, nsup, 1, stream);
}

// The instanced kernel: pairs (SPAGES, 8, 128) world pair boxes of which
// the first npair lanes (page-major) are pair rows; pair_tab (npair, 4)
// i32; blk (nblk, 8, 128) mesh-space block boxes; coeff (cb, 12, 128);
// amask (cb, 2, 128) or null; inst_inv (ninst, 12).  count = 1 also writes
// outi rows 5 to 7.  No hints.
int rt_trace_v8_inst(const void* rays, const void* pairs, const void* blk,
                     const void* coeff, const void* amask, const void* pair_tab,
                     const void* inst_inv, void* outf, void* outi, int ts, int npair,
                     int nblk, int cb, int ninst, int l1_mask, int mode, int count,
                     void* stream) {
  if (ts <= 0) return 0;
  const bool masked = amask != nullptr;
  TraceFn fn = count ? pick_inst<true>(mode, masked) : pick_inst<false>(mode, masked);
  return launch(fn, STATIC_SMEM + sizeof(InstTile), rays, pairs, blk, coeff, amask, nullptr,
                pair_tab, inst_inv, outf, outi, ts, npair, cb, 0, l1_mask, nblk, ninst, stream);
}

const char* rt_trace_v8_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
