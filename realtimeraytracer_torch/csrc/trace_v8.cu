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
//   Live rays: before each cull the tile's rays whose window [t_min,
//     min(best_t, t_max)] is not empty are compacted by a warp ballot (warp
//     w's live lanes at list[32 w ...], in lane order: deterministic, no
//     atomics, one barrier).  Both culls loop over that list only; a tile
//     with no live ray has no L1 key and skips the traversal.
//   L1: thread s slab-tests super box s against the live rays (read from
//     shared memory) and keeps the least entry max(near, 0); the keys
//     (entry bits with the super id in the low bits) are appended with one
//     atomic per warp and sorted once, then popped in order.
//   L2: per popped super, thread b does the same for block b, and the 128
//     block keys are sorted and visited in order.
//   Sorts: the keys are unique (the id sits in the low bits; no candidate
//     = INVALID + lane), so a thread counts the keys below its own and
//     scatters it to that rank: the 128 L2 keys take two barriers where a
//     bitonic network took 28.  L1 takes the same rank sort for up to 512
//     keys (four a thread); above that, a bitonic network.
//   Staging: the block of each visit is copied into one of two shared
//     buffers with cp.async (16 bytes a thread and copy: 384 copies for the
//     12x128 coefficients, 64 for the mask rows): while block j is tested,
//     the next sorted key's block is in flight, and a prefetch that the
//     stop rule makes needless is dropped (waited for, never read).  The
//     popped super's blk page (its six box rows) is staged the same way:
//     the next L1 key's page is in flight while this super is culled and
//     visited.  Hints are visited first, in the same way.
//   Visit, transposed: each live ray slab-tests the block box under its
//     live window; those that pass (the active rays) are compacted by a
//     ballot into shared memory.  Thread j then holds triangle j's
//     coefficients in registers and the whole CTA walks the active rays
//     together: per ray one ray-triangle test per thread (v7's math) and
//     one warp reduction (REDUX min of the packed (quantized t | lane) key,
//     or a ballot for the first hit in lane order), so a visit costs the
//     active rays, not 128 iterations for every warp that holds one.
//     Occluded mode retires a ray on its first hit (best_t = -3e38) and
//     records the block.
//   Stop rules, both levels: the next key's entry exceeds every live ray's
//     min(best_t, t_max) (int32 f32 bits), one __syncthreads_or each.
//     Entries are lower bounds (id bits cleared = rounded down), so the
//     traversal is exact.  Keys, their order and what each visit tests are
//     those of the design this replaces, so ties on quantized t still go
//     to the block visited first.
// Pad boxes are inverted; a min/max slab test would pass them with near =
// -inf, so box validity (min.x <= max.x) is tested explicitly.  Axes with
// |d| <= 1e-12 pass every slab.  Empty lanes ([3e38, -3e38)) have negative
// limit bits and never hold a loop.
// Kept from the TPU kernel: the two levels, live-window culls, ordered
// visits, exact stop rules, hints.  Dropped, being scheduling for the TPU's
// scalar unit: multi-pop `pack`, the cond `stride` and the capped re-cull
// rounds; the per-ray slab test at each visit subsumes the re-cull.  The
// coefficient table is read from global memory on every path (staged
// asynchronously), so the TPU's resident vs HBM-DMA split has no
// counterpart.  The JAX kernel packs L1 ids into 12 bits and truncates
// above 3072 supers; here the id bits grow with the super count and the
// wrapper refuses more supers than the shared-memory sort holds.
//
// What bounds it: f32 operations, 47 per ray-triangle pair tested (32 with
// a common direction; rays whose slab test fails skip the visit, occluded
// rays stop at their first hit) and 27 per slab test (the tile's live rays
// against each super box, then against the 128 block boxes of each popped
// super, and each live ray once per visit).  What held the design before
// this one far from that bound (7.0 ms against 1.0 ms on 1080p shadow
// segments, 22.5 against 1.7 ms on incoherent closest rays; NVIDIA H100
// 80GB HBM3, 700 W) was SIMT, not memory: one thread per ray looped over
// the 128 triangles, so a warp paid the full loop whenever one of its 32
// rays passed the block's slab test, and on incoherent rays a ninth of
// those lanes did.  The transposed visit pays per active ray instead.  The
// live-ray culls and the rank sorts take a few percent more, the
// asynchronous staging none measurable on v8 (its visits now read only
// their own triangle from the staged block); the instanced form's L1 cull
// (2,584 pair boxes a tile) tests four boxes a thread per pass over the
// live rays.  Ablations and times: PERF.md.
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
// has 2,584 pairs, against 8 supers baked), so the L1 sort takes up to
// SPAGES*128 keys (padded to 4,096: 16 KB of dynamic shared memory), and a
// popped pair's blk page is the pair's blk row (read from pair_tab when
// the page is staged).
//
// Multi-segment occlusion (MULTI, entry rt_trace_v8_multi; replaces
// realtimeraytracer_tpu/render/hier_backend.py::hier_occluded_multi, kernel
// body _trace_kernel_multi/_tile_body_multi).  The S stochastic shadow
// segments of one light triangle share their origin and are traced in one
// pass.  Rays (Ts, 4 + 4S, 128) f32 rows [o.xyz | t_min | (d.xyz | t_hi) x S]
// (render/hier_backend.py::pack_rays_multi; pad lanes and inactive rays
// t_min = 3e38, t_hi = -3e38), 1 <= S <= 8; sup, blk and coeff as above, a
// non-instanced scene; no hints, no masks.  Outputs: outf rows 0..S-1 = 1.0
// where sample s is occluded, which equals an occluded launch of the kernel
// above on (o, d_s, t_min, t_hi_s); outi row 0 = blocks visited, row 1 =
// supers popped.  Work counts with count = 1: outi row 4 = hull slab tests
// (this thread's share of the tile's L1 and L2 culls), row 5 = ray-triangle
// sample tests (each sample up to its first hit), row 6 = origin-family
// evaluations (one per triangle a ray reaches at a visit), row 7 = the
// per-sample slab tests at visits.
//   Design: single v8's, per (ray, sample).  The S directions, inverse
//   directions and t_hi sit in shared memory (dynamic, 28 bytes a ray and
//   sample: 28 KB at S = 8, so the launch opts in per S), the origin and
//   the occluded mask in the ray's thread.  The culls use the ray's
//   direction hull: per axis the interval [min_s d, max_s d]; a
//   sign-definite one (lo > EPS or hi < -EPS) inverts to [1/hi, 1/lo], one
//   that straddles zero passes the axis, and the slab takes the min and max
//   of (p - o) times both ends.  Division and multiplication round
//   monotonically, so every sample's own slab interval lies inside the
//   hull's: a hull entry is a lower bound for every sample and the stop
//   rules stay exact.  A ray's live limit is the greatest t_hi of its
//   samples not yet occluded (-3e38 when none is left: retired).
//     Live rays: before each cull the rays whose window [t_min, limit] is
//     not empty are compacted (compact_live); both culls loop over that
//     list only (box_min_entries, l1_keys), and a tile with no live ray
//     skips the traversal.  Both levels sort by rank (sort_keys, sort_l2);
//     the stop rule is one __syncthreads_or per key.
//     Staging: blocks and blk pages are double-buffered with cp.async as in
//     single v8 (block j + 1 in flight while block j is tested, the next L1
//     key's page while this super is culled); a prefetch the stop rule
//     makes needless is dropped.  The CTA's shared memory is kept to six
//     CTAs an SM at S = 3 (one vote word per active slot, ORed by the
//     warps; no padding in the hull tile): the visit's test loop is most
//     of the time, and it runs faster with more warps to hide its latency.
//     Visit: each live sample of each ray slab-tests the block with its own
//     inverse direction under [t_min, t_hi_s], as the single kernel's
//     per-visit test does; the rays with a sample that passes are compacted
//     with their samples to do.  If none passes, the block is neither
//     waited for nor tested (the visit still counts).  Otherwise the visit
//     is transposed: thread j holds triangle j's coefficients and the CTA
//     walks the active rays; per ray each thread computes the origin family
//     (s0, ou, ov) once, then each sample to do pays its direction dots and
//     accept test, and each warp votes once per sample.  A sample hit
//     anywhere in the block is occluded for the whole CTA (the warps' votes
//     ORed into the ray's mask).  Any-hit flags do not depend on the order
//     of the tests, so each sample's flag is the any-hit over the blocks
//     its slab test passes until it is occluded: that of a single trace.
//   What bounds it: f32 operations, 29 per sample test (three direction
//   dots 15, |s1| > eps 2, t 2, u and v 4, u + v 1, five compares), 18 per
//   origin-family evaluation (three origin dots), 45 per hull slab test (per
//   axis two subtractions, four multiplications and six min/max, then the
//   near/far combine 4, four compares and max(near, 0)) and 27 per
//   per-sample slab test.  The work counts are those of a ray walking each
//   block's triangles in order until its samples are done: a sample test
//   counts up to the sample's first hit in lane order, the origin family up
//   to the last of those; the transposed visit tests all 128 triangles of
//   the block for each sample to do, which the counts leave out.  What held
//   the design before this one far from the bound (18.6 ms against 2.26 ms
//   on 1080p light-0 segments, S = 3; NVIDIA H100 80GB HBM3, 700 W) was
//   SIMT: one thread per ray walked the 128 triangles, so a warp paid the
//   whole loop whenever one of its rays had a sample to do, and every
//   block was staged synchronously and visited under a barrier even when
//   no sample needed it.  Times and ablations: PERF.md.
//
// Numerics: -fmad=false, the same expressions and order as the plain twins
// (render/hier_backend.py::trace_hier_plain, trace_hier_inst_plain; the
// multi-segment twin trace_hier_multi_plain runs trace_hier_plain per
// sample).
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
// Resident CTAs an SM is asked to hold (at most 128 registers a thread).
// Without it ptxas spills 4 to 28 bytes in most instantiations, though
// none uses more than 120 registers.
constexpr int MIN_CTAS = 4;
constexpr int BLK_BITS = 7;           // block-in-super id bits of L2 keys

enum Mode { CLOSEST = 0, OCCLUDED = 1 };
enum Common { COMMON_NONE = 0, COMMON_ORIGIN = 1, COMMON_DIR = 2 };

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

// slab_entry for every direction of a ray's direction hull (MULTI): the
// interval of (p - o) times [ilo, ihi] per axis; fl's axes (the hull
// straddles zero) pass every slab.
__device__ __forceinline__ float hull_entry(const float* lo, const float* hi, const float* o,
                                           const float* ilo, const float* ihi, int fl,
                                           float tmin, float limit) {
  float near = 0.0f, far = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float na, fa;
    if (fl & (1 << a)) {
      na = -BIG;
      fa = BIG;
    } else {
      const float s0 = lo[a] - o[a], s1 = hi[a] - o[a];
      const float p0 = s0 * ilo[a], q0 = s0 * ihi[a];
      const float p1 = s1 * ilo[a], q1 = s1 * ihi[a];
      na = fminf(fminf(p0, q0), fminf(p1, q1));
      fa = fmaxf(fmaxf(p0, q0), fmaxf(p1, q1));
    }
    near = a == 0 ? na : fmaxf(near, na);
    far = a == 0 ? fa : fminf(far, fa);
  }
  const bool ok = lo[0] <= hi[0] && near <= far && far >= tmin && near <= limit;
  return ok ? fmaxf(near, 0.0f) : __int_as_float(INVALID);
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

// The tile's rays as the culls read them, one ray per slot: [o.xyz |
// t_min], [guarded inverse direction | the live window's upper end,
// refreshed per cull], parallel-axis bits.  get(r) reads ray r, whose
// entry(lo, hi) is its slab test against a box.
struct Tile {
  float4 ray[TILE][2];
  int fl[TILE];
  struct Ray {
    float4 a, b;
    int fl;
    __device__ __forceinline__ float entry(const float* lo, const float* hi) const {
      const float o[3] = {a.x, a.y, a.z};
      const float inv[3] = {b.x, b.y, b.z};
      return slab_entry(lo, hi, o, inv, fl, a.w, b.w);
    }
  };
  __device__ __forceinline__ Ray get(int r) const { return {ray[r][0], ray[r][1], fl[r]}; }
};

// The multi-segment kernel's rays as its culls read them: [o.xyz | t_min],
// [inverse hull lo.xyz | the live limit, refreshed per cull], the inverse
// hull's hi ends, the hull's straddle bits; entry(lo, hi) is hull_entry.
struct HullTile {
  float4 ray[TILE][2];
  float ihi[3][TILE];
  int fl[TILE];
  struct Ray {
    float4 a, b;
    float ihi[3];
    int fl;
    __device__ __forceinline__ float entry(const float* lo, const float* hi) const {
      const float o[3] = {a.x, a.y, a.z};
      const float ilo[3] = {b.x, b.y, b.z};
      return hull_entry(lo, hi, o, ilo, ihi, fl, a.w, b.w);
    }
  };
  __device__ __forceinline__ Ray get(int r) const {
    return {ray[r][0], ray[r][1], {ihi[0][r], ihi[1][r], ihi[2][r]}, fl[r]};
  }
};

// The instanced kernel's shared state (INST only).
struct InstTile {
  float xf[12];          // the popped pair's instance inverse [R | t]
  int bbase, inst;       // its block base and instance
};

// ---- asynchronous staging (cp.async, 16 bytes a thread and copy) ---------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages coefficient block `cid` (12 x 128 f32, 384 chunks) and, with
// MASK, its two mask rows (64 chunks) as one copy group.  Every thread of
// the CTA calls it.
template <bool MASK>
__device__ __forceinline__ void stage_block(const float* __restrict__ coeff,
                                            const int* __restrict__ amask, int cid,
                                            float* cdst, int* mdst) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int c = lane + i * TILE;
    const int off = (c >> 5) * TILE + 4 * (c & 31);
    cp_async16(cdst + off, coeff + (size_t)cid * CROWS * TILE + off);
  }
  if (MASK && lane < 64) {
    const int off = (lane >> 5) * TILE + 4 * (lane & 31);
    cp_async16(mdst + off, amask + (size_t)cid * 2 * TILE + off);
  }
  cp_async_commit();
}

// Stages the six box rows of a (8, 128) box page (192 chunks) as one copy
// group.  Every thread of the CTA calls it.
__device__ __forceinline__ void stage_page(const float* __restrict__ page, float* dst) {
  for (int c = threadIdx.x; c < 6 * TILE / 4; c += TILE) {
    const int off = (c >> 5) * TILE + 4 * (c & 31);
    cp_async16(dst + off, page + off);
  }
  cp_async_commit();
}

// ---- the tile's live rays, compacted without atomics ----------------------

constexpr int WARPS = TILE / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

// Warp w's live lanes sit at list[32 w, 32 w + cnt[w]), in lane order.
struct Live {
  int list[TILE];
  int cnt[WARPS];
};

// Compacts the lanes whose window is live (one ballot per warp) and returns
// their count.  Every thread of the CTA calls it: its one barrier also
// publishes the caller's earlier shared writes.
__device__ __forceinline__ int compact_live(Live& L, bool live) {
  const int lane = threadIdx.x;
  const unsigned m = __ballot_sync(FULL, live);
  if (live) L.list[(lane & ~31) + __popc(m & ((1u << (lane & 31)) - 1u))] = lane;
  if ((lane & 31) == 0) L.cnt[lane >> 5] = __popc(m);
  __syncthreads();
  int n = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) n += L.cnt[w];
  return n;
}

// Least entries over the tile's live rays (the compacted list of ray slots
// of T, a Tile or a HullTile; the other rays' windows are empty) of NB
// boxes (lane b[i] of the (8, 128) box page page[i]; boxes i >= nbox are
// skipped), +inf bits where no live window overlaps a box.  Each ray is
// read once for the NB boxes, and the NB slab tests are independent; each
// box still takes its minimum over the rays in list order.  A valid box
// adds `nlive` to *slabs (COUNT).
template <int NB, bool COUNT, class RayTile>
__device__ __forceinline__ void box_min_entries(const RayTile& T, const Live& L, int nlive,
                                                const float* const (&page)[NB],
                                                const int (&b)[NB], int nbox,
                                                float (&emin)[NB], int* slabs) {
  float lo[NB][3], hi[NB][3];
  bool ok[NB];
  bool any = false;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    emin[i] = __int_as_float(INVALID);
    ok[i] = false;
    if (i < nbox) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[i][a] = page[i][a * TILE + b[i]];
        hi[i][a] = page[i][(3 + a) * TILE + b[i]];
      }
      ok[i] = lo[i][0] <= hi[i][0];
      if (COUNT && ok[i]) *slabs += nlive;
    }
    any |= ok[i];
  }
  if (!any) return;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = L.cnt[w];
    for (int k = 0; k < c; ++k) {
      const typename RayTile::Ray ray = T.get(L.list[32 * w + k]);
#pragma unroll
      for (int i = 0; i < NB; ++i)
        if (ok[i]) emin[i] = fminf(emin[i], ray.entry(lo[i], hi[i]));
    }
  }
}

// L1 keys of the tile's live rays: the least entry of each of the nsup
// boxes of the (8, 128) pages `sup` (page-major), four a thread per pass
// (s = base + 128 i + lane), as (entry bits & ~l1_mask) | s, appended to
// keys with one atomic per warp on `count` (the order is sorted away).
// Every thread of the CTA calls it.
template <bool COUNT, class RayTile>
__device__ __forceinline__ void l1_keys(const RayTile& T, const Live& L, int nlive,
                                        const float* __restrict__ sup, int nsup, int l1_mask,
                                        int* keys, int& count, int* slabs) {
  const int lane = threadIdx.x;
  for (int base = 0; base < nsup; base += 4 * TILE) {
    const float* pg[4];
    int bl[4];
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pg[i] = sup + (size_t)(base / TILE + i) * 8 * TILE;
      bl[i] = lane;
    }
    const int nbox = min(4, (nsup - base - lane + TILE - 1) / TILE);
    box_min_entries<4, COUNT>(T, L, nlive, pg, bl, nbox, e, slabs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = base + i * TILE + lane;
      const int key = i < nbox && __float_as_int(e[i]) != INVALID
                          ? (__float_as_int(e[i]) & ~l1_mask) | s
                          : INVALID;
      const unsigned m = __ballot_sync(FULL, key != INVALID);
      int at = 0;
      if ((lane & 31) == 0 && m) at = atomicAdd(&count, __popc(m));
      at = __shfl_sync(FULL, at, 0);
      if (key != INVALID) keys[at + __popc(m & ((1u << (lane & 31)) - 1u))] = key;
    }
  }
}

// ---- key sorts -----------------------------------------------------------

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

// L1 keys held by one thread in a rank sort; more keys than TILE x
// RANK_L1 go through the bitonic network instead.
constexpr int RANK_L1 = 4;

// Sorts the n unique keys s[0, n) ascending.  Every thread of the CTA
// calls it; s is published on entry.  Up to TILE x RANK_L1 keys: each
// thread ranks its own keys (held in registers) and, after one barrier,
// scatters them in place.  Above that, a bitonic network over the keys
// padded to a power of two (cap1 >= that power).
__device__ __forceinline__ void sort_keys(int* s, int n) {
  const int lane = threadIdx.x;
  if (n <= TILE * RANK_L1) {
    int key[RANK_L1], rank[RANK_L1];
#pragma unroll
    for (int k = 0; k < RANK_L1; ++k) {
      const int i = lane + k * TILE;
      key[k] = i < n ? s[i] : 0;
      rank[k] = i < n ? rank_of(s, n, key[k]) : -1;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RANK_L1; ++k)
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

// The 128 block keys of a popped super, sorted ascending into `keys` (`in`:
// 16-byte aligned scratch).  This thread's block entry e becomes (entry
// bits with the block bits cleared) | block, or INVALID + block where no
// live window overlaps the block (after every key).  The keys are unique,
// so each thread scatters its own to its rank: two barriers where a
// bitonic network takes 28.  Every thread of the CTA calls it.
__device__ __forceinline__ void sort_l2(float e, int* in, int* keys) {
  const int lane = threadIdx.x;
  const int own = __float_as_int(e) == INVALID
                      ? INVALID + lane
                      : (__float_as_int(e) & ~((1 << BLK_BITS) - 1)) | lane;
  in[lane] = own;
  __syncthreads();
  keys[rank_of(in, SUP, own)] = own;
  __syncthreads();
}

// The alpha-mask bit of this thread's triangle at barycentrics (u, v): m0
// and m1 are its two mask words (mask_bit with the rows in registers).
__device__ __forceinline__ bool mask_bit_words(int m0, int m1, float u, float v) {
  const int gi = min(max(__float2int_rz(u * 8.0f), 0), 7);
  const int gj = min(max(__float2int_rz(v * 8.0f), 0), 7);
  const int b = gj * 8 + gi;
  return ((static_cast<unsigned>(b >> 5 ? m1 : m0) >> (b & 31)) & 1u) != 0u;
}

// A visit's active rays, slot 32 w + k for the k-th active lane of warp w
// (L.cnt[w] of them): [o.xyz | t_min], [d.xyz | limit]; and per warp and
// slot the warp's least packed key (closest) or first hit lane (occluded).
struct VisitRays {
  float4 ray[TILE][2];
  int key[WARPS][TILE];
};

// One block visit on a staged block (coef / smask: its coefficients and
// mask rows in shared memory, each thread's copies waited for by the
// caller).  Each live ray slab-tests the block box (lane b of the box page
// `page`, shared or global) under its live window; the rays that pass are
// the visit's active rays.  Then the visit is transposed: thread j holds
// triangle j's coefficients (and, with a common origin or direction, its
// shared dot products) in registers and the CTA loops over the active rays
// together, one ray-triangle pair per thread and ray, a warp reduction
// (REDUX min of the packed keys, or a ballot for the first hit) per warp
// and ray.  The pair's arithmetic and the per-ray results (the least
// packed (quantized t | lane) key; the first hit's lane) are those of a
// ray testing the 128 triangles in order.  Every thread of the CTA calls it
// (it holds two barriers); lane = threadIdx.x.  A closest hit that
// improves best_t sets best_i to `inst` (the instanced kernel's instance;
// -1 otherwise).
template <int MODE, int COMMON, bool COUNT, bool MASK>
__device__ __forceinline__ void visit(
    int cid, const float* coef, const int* smask, const float* page, int b, Live& L,
    VisitRays& V, const float* o, const float* d, const float* inv,
    int fl, float tmin, float tmax, float cx, float cy, float cz,
    float& best_t, int& best_k, int inst, int& best_i, int& visits, int* work) {
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  ++visits;
  const float limit = fminf(best_t, tmax);
  bool active = false;
  if ((MODE == CLOSEST || best_t >= 0.0f) && tmin <= limit) {
    float lo[3], hi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = page[a * TILE + b];
      hi[a] = page[(3 + a) * TILE + b];
    }
    if (COUNT) ++work[TILE + lane];
    active = slab_entry(lo, hi, o, inv, fl, tmin, limit) < __int_as_float(INVALID);
  }
  const unsigned m = __ballot_sync(FULL, active);
  const int slot = (lane & ~31) + __popc(m & ((1u << (lane & 31)) - 1u));
  if (active) {
    V.ray[slot][0] = make_float4(o[0], o[1], o[2], tmin);
    V.ray[slot][1] = make_float4(d[0], d[1], d[2], limit);
  }
  if ((lane & 31) == 0) L.cnt[warp] = __popc(m);
  __syncthreads();              // the active rays and the staged block

  float c[CROWS];
#pragma unroll
  for (int r = 0; r < CROWS; ++r) c[r] = coef[r * TILE + lane];
  float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;       // the tile-shared dot products
  if (COMMON == COMMON_ORIGIN) {
    f0 = ((cx * c[0] + cy * c[1]) + cz * c[2]) + c[3];
    f1 = ((cx * c[4] + cy * c[5]) + cz * c[6]) + c[7];
    f2 = ((cx * c[8] + cy * c[9]) + cz * c[10]) + c[11];
  } else if (COMMON == COMMON_DIR) {
    f0 = (cx * c[0] + cy * c[1]) + cz * c[2];
    f1 = (cx * c[4] + cy * c[5]) + cz * c[6];
    f2 = (cx * c[8] + cy * c[9]) + cz * c[10];
  }
  const int m0 = MASK ? smask[lane] : 0, m1 = MASK ? smask[TILE + lane] : 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int n = L.cnt[w];
    for (int k = 0; k < n; ++k) {
      const int sl = 32 * w + k;
      const float4 ra = V.ray[sl][0], rb = V.ray[sl][1];
      float s0, ou, ov, s1, du, dv;
      if (COMMON == COMMON_ORIGIN) {
        s0 = f0;
        ou = f1;
        ov = f2;
      } else {
        s0 = ((ra.x * c[0] + ra.y * c[1]) + ra.z * c[2]) + c[3];
        ou = ((ra.x * c[4] + ra.y * c[5]) + ra.z * c[6]) + c[7];
        ov = ((ra.x * c[8] + ra.y * c[9]) + ra.z * c[10]) + c[11];
      }
      if (COMMON == COMMON_DIR) {
        s1 = f0;
        du = f1;
        dv = f2;
      } else {
        s1 = (rb.x * c[0] + rb.y * c[1]) + rb.z * c[2];
        du = (rb.x * c[4] + rb.y * c[5]) + rb.z * c[6];
        dv = (rb.x * c[8] + rb.y * c[9]) + rb.z * c[10];
      }
      const bool den_ok = fabsf(s1) > EPS;
      const float t = den_ok ? (-s0) / s1 : BIG;
      const float u = ou + t * du;
      const float v = ov + t * dv;
      bool ok = den_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= ra.w && t <= rb.w;
      if (MASK && ok) ok = mask_bit_words(m0, m1, u, v);
      int r;
      if (MODE == CLOSEST) {
        const float tm = ok ? t : __int_as_float(INVALID);
        r = __reduce_min_sync(FULL, (__float_as_int(tm) & ~127) | lane);
      } else {
        const unsigned h = __ballot_sync(FULL, ok);
        r = h ? (lane & ~31) + __ffs(h) - 1 : KEY_PAD;
      }
      if ((lane & 31) == 0) V.key[warp][sl] = r;
    }
  }
  __syncthreads();              // the warps' keys
  if (!active) return;
  const int r = min(min(V.key[0][slot], V.key[1][slot]), min(V.key[2][slot], V.key[3][slot]));
  if (MODE == CLOSEST) {
    if (COUNT) work[lane] += TILE;
    if (r < __float_as_int(best_t)) {
      best_t = __int_as_float(r & ~127);
      best_k = cid * TILE + (r & 127);
      best_i = inst;
    }
  } else {
    const bool hit = r < KEY_PAD;
    if (COUNT) work[lane] += hit ? r + 1 : TILE;     // up to the first hit, in lane order
    if (hit) {
      best_t = -BIG;
      if (best_k < 0) best_k = cid;
    }
  }
}

template <int MODE, int COMMON, bool COUNT, bool MASK, bool INST>
__global__ void __launch_bounds__(TILE, MIN_CTAS) trace_v8_kernel(
    const float* __restrict__ rays, const float* __restrict__ sup,
    const float* __restrict__ blk, const float* __restrict__ coeff,
    const int* __restrict__ amask, const int* __restrict__ hints,
    const int* __restrict__ pair_tab, const float* __restrict__ inst_inv,
    float* __restrict__ outf, int* __restrict__ outi, int nsup, int cap1,
    int cb, int hn, int l1_mask, int nblk, int ninst) {
  extern __shared__ __align__(16) int l1keys[];   // cap1 super (pair) keys
  // The culls' rays and a visit's active rays share their room: a visit
  // runs between culls, and each cull rewrites the rays first.
  __shared__ union { Tile T; VisitRays V; } U;
  Tile& T = U.T;
  VisitRays& V = U.V;
  __shared__ __align__(16) float coefb[2][CROWS * TILE];      // staged blocks
  __shared__ __align__(16) int smaskb[2][MASK ? 2 * TILE : 4];
  __shared__ __align__(16) float pageb[2][6 * TILE];          // staged blk pages
  __shared__ __align__(16) int l2in[SUP];
  __shared__ int l2keys[SUP];
  __shared__ Live L;
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
  }
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
  int cbuf = 0;                     // the coefficient buffer of the next visit
  // This thread's ray as the culls read it, under its live window.
  auto publish_ray = [&](const float (&ro)[3], const float (&ri)[3], int rf) {
    T.ray[lane][0] = make_float4(ro[0], ro[1], ro[2], tmin);
    T.ray[lane][1] = make_float4(ri[0], ri[1], ri[2], fminf(best_t, tmax));
    T.fl[lane] = rf;
  };

  // Hints in: visit the previous correlated trace's occluder blocks, the
  // next one staged while the current one is tested.
  auto next_hint = [&](int j) {
    while (j < hn && hints[(size_t)tile * hn + j] < 0) ++j;
    return j;
  };
  auto hint_block = [&](int j) { return min(hints[(size_t)tile * hn + j], cb - 1); };
  int jh = next_hint(0);
  if (jh < hn) stage_block<MASK>(coeff, amask, hint_block(jh), coefb[cbuf], smaskb[cbuf]);
  while (jh < hn) {
    // The previous visit's closing barrier retired its reads of the buffer
    // the prefetch overwrites; the visit's first barrier publishes this one.
    const int jn = next_hint(jh + 1);
    if (jn < hn) {
      stage_block<MASK>(coeff, amask, hint_block(jn), coefb[cbuf ^ 1], smaskb[cbuf ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int hc = hint_block(jh);
    visit<MODE, COMMON, COUNT, MASK>(hc, coefb[cbuf], smaskb[cbuf],
                                     blk + (size_t)(hc / SUP) * 8 * TILE, hc % SUP, L, V, o, d,
                                     inv, fl, tmin, tmax, cx, cy, cz, best_t, best_k, -1, best_i,
                                     visits, work);
    cbuf ^= 1;
    jh = jn;
  }

  // L1: least entry per super (pair) over the live windows, sorted once.
  // A tile with no live ray has no key and skips the traversal.
  if (hn > 0) __syncthreads();      // the hint visits' last reads of V
  if (lane == 0) count = 0;
  publish_ray(o, inv, fl);
  int* slabs = &work[COUNT ? TILE + lane : 0];      // this thread's slab tests (COUNT)
  const int live1 = compact_live(L, tmin <= fminf(best_t, tmax));
  if (live1 > 0) l1_keys<COUNT>(T, L, live1, sup, nsup, l1_mask, l1keys, count, slabs);
  __syncthreads();
  const int n1 = count;
  sort_keys(l1keys, n1);

  // The blk page of super (pair) s: INST reads its blk row from pair_tab.
  auto page_of = [&](int s) {
    const int row = INST ? min(max(pair_tab[(size_t)s * 4 + 1], 0), nblk - 1) : s;
    return blk + (size_t)row * 8 * TILE;
  };
  int pbuf = 0;
  for (int i = 0; i < n1; ++i) {
    const int key = l1keys[i];
    if (!__syncthreads_or(__float_as_int(fminf(best_t, tmax)) >= (key & ~l1_mask)))
      break;
    ++l1pops;
    const int s = key & l1_mask;
    // This pop's blk page (the previous pop prefetched it) and the next's.
    if (i == 0) stage_page(page_of(s), pageb[pbuf]);
    const bool pre = i + 1 < n1;
    if (pre) stage_page(page_of(l1keys[i + 1] & l1_mask), pageb[pbuf ^ 1]);
    const float* page = pageb[pbuf];
    // L2: block keys of this super (of this pair's super, in mesh space:
    // the L1 cull is done, so the tile's shared rays become mesh-space
    // rays) against the live windows.
    int base = s * SUP, inst = -1;
    float e;
    if constexpr (INST) {
      if (lane < 12) {
        const int* row = pair_tab + (size_t)s * 4;
        const int ins = min(max(row[0], 0), ninst - 1);
        I.xf[lane] = inst_inv[(size_t)ins * 12 + lane];
        if (lane == 0) {
          I.inst = ins;
          I.bbase = row[2];
        }
      }
      __syncthreads();
      inst = I.inst;
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
      }
      if (COUNT && tmin <= fminf(best_t, tmax)) ++work[2 * TILE + lane];
    }
    publish_ray(mo, minv, mfl);
    if (pre) cp_async_wait<1>(); else cp_async_wait<0>();
    const int live2 = compact_live(L, tmin <= fminf(best_t, tmax));  // also publishes the page
    {
      const float* pg[1] = {page};
      const int bl[1] = {lane};
      float e1[1];
      box_min_entries<1, COUNT>(T, L, live2, pg, bl, 1, e1, slabs);
      e = e1[0];
    }
    sort_l2(e, l2in, l2keys);
    for (int j = 0; j < SUP; ++j) {
      const int k2 = l2keys[j];
      if (k2 >= INVALID) break;                      // uniform: shared read
      if (!__syncthreads_or(__float_as_int(fminf(best_t, tmax)) >=
                            (k2 & ~((1 << BLK_BITS) - 1))))
        break;
      const int b = k2 & ((1 << BLK_BITS) - 1);
      const int cid = min(base + b, cb - 1);
      // Stage this block (the previous visit prefetched all but the first)
      // and prefetch the next key's, dropped if the stop rule ends here.
      if (j == 0) stage_block<MASK>(coeff, amask, cid, coefb[cbuf], smaskb[cbuf]);
      const int kn = j + 1 < SUP ? l2keys[j + 1] : INVALID;
      if (kn < INVALID) {
        stage_block<MASK>(coeff, amask, min(base + (kn & ((1 << BLK_BITS) - 1)), cb - 1),
                          coefb[cbuf ^ 1], smaskb[cbuf ^ 1]);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      visit<MODE, COMMON, COUNT, MASK>(cid, coefb[cbuf], smaskb[cbuf], page, b, L, V, mo, md,
                                       minv, mfl, tmin, tmax, cx, cy, cz, best_t, best_k, inst,
                                       best_i, visits, work);
      cbuf ^= 1;
    }
    cp_async_wait<0>();             // a block prefetch the stop rule dropped
    pbuf ^= 1;
  }
  cp_async_wait<0>();               // a page prefetch the stop rule dropped

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
template <typename Fn>
cudaError_t opt_in(Fn fn, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return e;
  if (smem + attr.sharedSizeBytes > 48 * 1024)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return e;
}

int launch(TraceFn fn, const void* rays, const void* sup,
           const void* blk, const void* coeff, const void* amask, const void* hints,
           const void* pair_tab, const void* inst_inv, void* outf, void* outi, int ts,
           int nl1, int cb, int hn, int l1_mask, int nblk, int ninst, void* stream) {
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int cap1 = 1;
  while (cap1 < nl1) cap1 <<= 1;
  const size_t smem = (size_t)cap1 * sizeof(int);
  const cudaError_t e = opt_in(fn, smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<ts, TILE, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)sup, (const float*)blk,
      (const float*)coeff, (const int*)amask, (const int*)hints,
      (const int*)pair_tab, (const float*)inst_inv, (float*)outf, (int*)outi,
      nl1, cap1, cb, hn, l1_mask, nblk, ninst);
  return (int)cudaGetLastError();
}

// ---- MULTI: S shared-origin occlusion segments per ray --------------------

constexpr int MAX_SEGMENTS = 8;

// The tile's samples, sample-major, in dynamic shared memory (sized per S):
// dt[s][r] = [d.xyz | t_hi] of sample s of ray r, inv[s][a][r] its guarded
// inverse direction.  A ray's thread reads its own column; the visit's
// threads read one active ray's column together (a broadcast).
template <int S>
struct Samples {
  float4 dt[S][TILE];
  float inv[S][3][TILE];
};
static_assert(sizeof(Samples<MAX_SEGMENTS>) == MAX_SEGMENTS * sizeof(Samples<1>),
              "the launch sizes the samples as S times one sample's room");

// A visit's results per active slot: the samples some triangle of the
// block hits (the warps' votes ORed), and (COUNT) per warp and sample the
// warp's first hitting lane (32: none).
template <int S, bool COUNT>
struct MultiVisit {
  unsigned hit[TILE];
  unsigned char first[COUNT ? WARPS : 1][TILE][S];
};

// The greatest t_hi over ray r's samples not yet occluded, -BIG if none is
// left: the ray's live limit.
template <int S>
__device__ __forceinline__ float live_limit(const Samples<S>& P, int r, unsigned occ) {
  float lim = -BIG;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (!((occ >> s) & 1u)) lim = fmaxf(lim, P.dt[s][r].w);
  return lim;
}

// The transposed test of a staged block (coef, published) against the
// visit's active rays (L: slot values ray | samples to do << 8): thread j
// holds triangle j's coefficients in registers and the CTA walks the active
// rays together.  Per ray each thread computes the origin family (s0, ou,
// ov) once, then the direction dots and the accept test of each sample to
// do, and each warp votes once per sample.  The pair arithmetic is the
// twin's, in its order.
template <int S, bool COUNT>
__device__ __forceinline__ void test_block(const float* coef, const HullTile& T,
                                           const Samples<S>& P, const Live& L,
                                           MultiVisit<S, COUNT>& V) {
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  float c[CROWS];
#pragma unroll
  for (int r = 0; r < CROWS; ++r) c[r] = coef[r * TILE + lane];
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int n = L.cnt[w];
    for (int k = 0; k < n; ++k) {
      const int sl = 32 * w + k;
      const int at = L.list[sl];
      const int r = at & (TILE - 1);
      const unsigned todo = static_cast<unsigned>(at) >> 8;
      const float4 ra = T.ray[r][0];                      // o.xyz | t_min
      const float s0 = ((ra.x * c[0] + ra.y * c[1]) + ra.z * c[2]) + c[3];
      const float ou = ((ra.x * c[4] + ra.y * c[5]) + ra.z * c[6]) + c[7];
      const float ov = ((ra.x * c[8] + ra.y * c[9]) + ra.z * c[10]) + c[11];
      unsigned hit = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (!((todo >> s) & 1u)) continue;                // uniform: a shared read
        const float4 dt = P.dt[s][r];                     // d.xyz | t_hi
        const float s1 = (dt.x * c[0] + dt.y * c[1]) + dt.z * c[2];
        const float du = (dt.x * c[4] + dt.y * c[5]) + dt.z * c[6];
        const float dv = (dt.x * c[8] + dt.y * c[9]) + dt.z * c[10];
        const bool den_ok = fabsf(s1) > EPS;
        const float q = (-s0) / s1;       // every lane: a branch around it costs more
        const float t = den_ok ? q : BIG;
        const float u = ou + t * du;
        const float v = ov + t * dv;
        const bool ok = den_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= ra.w &&
                        t <= dt.w;
        if (COUNT) {
          const unsigned h = __ballot_sync(FULL, ok);
          hit |= static_cast<unsigned>(h != 0u) << s;
          if ((lane & 31) == 0) V.first[warp][sl][s] = h ? __ffs(h) - 1 : 32;
        } else {
          hit |= static_cast<unsigned>(__any_sync(FULL, ok)) << s;
        }
      }
      if ((lane & 31) == 0 && hit) atomicOr(&V.hit[sl], hit);
    }
  }
}

// Folds a visit's warp votes into this thread's ray (slot: its active
// slot; todo: its samples tested): a sample hit anywhere in the block is
// occluded.  COUNT: each sample tested counts the triangles up to its first
// hit in lane order (all 128 if none), and the origin family counts the
// triangles up to the last of those (the work of a ray walking the block's
// triangles in order until its samples are done).
template <int S, bool COUNT>
__device__ __forceinline__ void retire(const MultiVisit<S, COUNT>& V, int slot, unsigned todo,
                                       const Samples<S>& P, unsigned& occ, float& lim,
                                       int& tests, int& fams) {
  occ |= V.hit[slot];
  lim = live_limit<S>(P, threadIdx.x, occ);
  if (COUNT) {
    int last = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (!((todo >> s) & 1u)) continue;
      int f = TILE;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        if (V.first[w][slot][s] < 32) f = min(f, 32 * w + V.first[w][slot][s]);
      const int n = f < TILE ? f + 1 : TILE;
      tests += n;
      last = max(last, n);
    }
    fams += last;
  }
}

// One block visit (coef: the block's buffer, its copy group committed;
// pre: a later group was committed after it; page: the staged blk page,
// lane b the block's box).  Each live sample of this thread's ray
// slab-tests the block with its own inverse direction under [t_min,
// t_hi_s]; the rays with a sample that passes are compacted with the
// samples to do.  A block that no sample passes is neither waited for nor
// tested; otherwise test_block and retire.  Every thread of the CTA calls
// it.
template <int S, bool COUNT>
__device__ __forceinline__ void visit_multi(
    const float* coef, bool pre, const float* page, int b, const HullTile& T,
    const Samples<S>& P, Live& L, MultiVisit<S, COUNT>& V, const float (&o)[3], float tmin,
    int sfl, unsigned& occ, float& lim, int& visits, int& tests, int& fams, int& slabs) {
  const int lane = threadIdx.x;
  ++visits;
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = page[a * TILE + b];
    hi[a] = page[(3 + a) * TILE + b];
  }
  unsigned todo = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float thi = P.dt[s][lane].w;
    if (((occ >> s) & 1u) || !(tmin <= thi)) continue;
    if (COUNT) ++slabs;
    const float inv[3] = {P.inv[s][0][lane], P.inv[s][1][lane], P.inv[s][2][lane]};
    if (slab_entry(lo, hi, o, inv, (sfl >> (3 * s)) & 7, tmin, thi) < __int_as_float(INVALID))
      todo |= 1u << s;
  }
  // The active rays, listed as compact_live lists the live ones, each
  // with its samples to do.
  const unsigned m = __ballot_sync(FULL, todo != 0u);
  const int slot = (lane & ~31) + __popc(m & ((1u << (lane & 31)) - 1u));
  if (todo) L.list[slot] = lane | static_cast<int>(todo << 8);
  if ((lane & 31) == 0) L.cnt[lane >> 5] = __popc(m);
  __syncthreads();                          // the active rays
  int active = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) active += L.cnt[w];
  if (active == 0) return;                  // no sample needs the block
  if (todo) V.hit[slot] = 0u;
  if (pre) cp_async_wait<1>(); else cp_async_wait<0>();
  __syncthreads();                          // the staged block and the cleared votes
  test_block<S, COUNT>(coef, T, P, L, V);
  __syncthreads();                          // the warps' votes
  if (todo) retire<S, COUNT>(V, slot, todo, P, occ, lim, tests, fams);
}

template <int S, bool COUNT>
__global__ void __launch_bounds__(TILE, MIN_CTAS) trace_v8_multi_kernel(
    const float* __restrict__ rays, const float* __restrict__ sup,
    const float* __restrict__ blk, const float* __restrict__ coeff,
    float* __restrict__ outf, int* __restrict__ outi, int nsup, int cb, int l1_mask) {
  extern __shared__ __align__(16) unsigned char msmem[];   // Samples<S>, then the L1 keys
  Samples<S>& P = *reinterpret_cast<Samples<S>*>(msmem);
  int* l1keys = reinterpret_cast<int*>(msmem + sizeof(Samples<S>));
  __shared__ HullTile T;
  __shared__ __align__(16) float coefb[2][CROWS * TILE];      // staged blocks
  __shared__ __align__(16) float pageb[2][6 * TILE];          // staged blk pages
  __shared__ __align__(16) int l2in[SUP];
  __shared__ int l2keys[SUP];
  __shared__ Live L;
  __shared__ MultiVisit<S, COUNT> V;
  __shared__ int count;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;

  // This thread's ray: its samples to shared memory, its direction hull's
  // inverse to the culls' tile.
  const float* r = rays + (size_t)tile * (4 + 4 * S) * TILE;
  const float o[3] = {r[0 * TILE + lane], r[1 * TILE + lane], r[2 * TILE + lane]};
  const float tmin = r[3 * TILE + lane];
  float dlo[3], dhi[3];
  int sfl = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      d[a] = r[(4 + 4 * s + a) * TILE + lane];
      const bool par = fabsf(d[a]) <= EPS;
      sfl |= par ? 1 << (3 * s + a) : 0;
      P.inv[s][a][lane] = 1.0f / (par ? 1.0f : d[a]);
      dlo[a] = s == 0 ? d[a] : fminf(dlo[a], d[a]);
      dhi[a] = s == 0 ? d[a] : fmaxf(dhi[a], d[a]);
    }
    P.dt[s][lane] = make_float4(d[0], d[1], d[2], r[(7 + 4 * s) * TILE + lane]);
  }
  float ilo[3], ihi[3];
  int hfl = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const bool definite = dlo[a] > EPS || dhi[a] < -EPS;
    hfl |= definite ? 0 : 1 << a;
    ilo[a] = definite ? 1.0f / dhi[a] : -BIG;
    ihi[a] = definite ? 1.0f / dlo[a] : BIG;
  }
  T.ray[lane][0] = make_float4(o[0], o[1], o[2], tmin);
#pragma unroll
  for (int a = 0; a < 3; ++a) T.ihi[a][lane] = ihi[a];
  T.fl[lane] = hfl;

  unsigned occ = 0;
  float lim = live_limit<S>(P, lane, occ);
  int visits = 0, l1pops = 0, hslabs = 0, tests = 0, fams = 0, slabs = 0;

  // L1: least hull entry per super over the live rays, sorted once.  A tile
  // with no live ray has no key and skips the traversal.
  if (lane == 0) count = 0;
  T.ray[lane][1] = make_float4(ilo[0], ilo[1], ilo[2], lim);
  const int live1 = compact_live(L, tmin <= lim);
  if (live1 > 0) l1_keys<COUNT>(T, L, live1, sup, nsup, l1_mask, l1keys, count, &hslabs);
  __syncthreads();
  const int n1 = count;
  sort_keys(l1keys, n1);

  int cbuf = 0, pbuf = 0;           // the buffers of the next visit and pop
  for (int i = 0; i < n1; ++i) {
    const int key = l1keys[i];
    if (!__syncthreads_or(__float_as_int(lim) >= (key & ~l1_mask))) break;
    ++l1pops;
    const int s = key & l1_mask;
    // This pop's blk page (the previous pop prefetched it) and the next's.
    if (i == 0) stage_page(blk + (size_t)s * 8 * TILE, pageb[pbuf]);
    const bool pre = i + 1 < n1;
    if (pre) stage_page(blk + (size_t)(l1keys[i + 1] & l1_mask) * 8 * TILE, pageb[pbuf ^ 1]);
    const float* page = pageb[pbuf];
    // L2: block keys of this super against the live hulls.
    T.ray[lane][1].w = lim;
    if (pre) cp_async_wait<1>(); else cp_async_wait<0>();
    const int live2 = compact_live(L, tmin <= lim);       // also publishes the page
    float e;
    {
      const float* pg[1] = {page};
      const int bl[1] = {lane};
      float e1[1];
      box_min_entries<1, COUNT>(T, L, live2, pg, bl, 1, e1, &hslabs);
      e = e1[0];
    }
    sort_l2(e, l2in, l2keys);
    for (int j = 0; j < SUP; ++j) {
      const int k2 = l2keys[j];
      if (k2 >= INVALID) break;                      // uniform: shared read
      if (!__syncthreads_or(__float_as_int(lim) >= (k2 & ~((1 << BLK_BITS) - 1)))) break;
      const int b = k2 & ((1 << BLK_BITS) - 1);
      // Stage this block (the previous key prefetched all but the first)
      // and prefetch the next key's into the other buffer, once the copy
      // that last filled it (two keys back: a skipped block's is never
      // waited for at its visit) has landed.  A prefetch that the stop rule
      // makes needless is dropped.
      if (j == 0) stage_block<false>(coeff, nullptr, min(s * SUP + b, cb - 1), coefb[cbuf], nullptr);
      const int kn = j + 1 < SUP ? l2keys[j + 1] : INVALID;
      const bool bpre = kn < INVALID;
      if (bpre) {
        cp_async_wait<1>();
        stage_block<false>(coeff, nullptr, min(s * SUP + (kn & ((1 << BLK_BITS) - 1)), cb - 1),
                           coefb[cbuf ^ 1], nullptr);
      }
      visit_multi<S, COUNT>(coefb[cbuf], bpre, page, b, T, P, L, V, o, tmin, sfl, occ, lim,
                            visits, tests, fams, slabs);
      cbuf ^= 1;
    }
    cp_async_wait<0>();             // block copies the stop rule or a skip left
    pbuf ^= 1;
  }
  cp_async_wait<0>();               // a page prefetch the stop rule dropped

  float* of = outf + (size_t)tile * 8 * TILE;
  int* oi = outi + (size_t)tile * 8 * TILE;
#pragma unroll
  for (int s = 0; s < S; ++s) of[s * TILE + lane] = ((occ >> s) & 1u) ? 1.0f : 0.0f;
  oi[lane] = visits;
  oi[TILE + lane] = l1pops;
  if (COUNT) {
    oi[4 * TILE + lane] = hslabs;
    oi[5 * TILE + lane] = tests;
    oi[6 * TILE + lane] = fams;
    oi[7 * TILE + lane] = slabs;
  }
}

typedef void (*MultiFn)(const float*, const float*, const float*, const float*, float*, int*,
                        int, int, int);

template <bool COUNT>
MultiFn pick_multi(int s_count) {
  switch (s_count) {
    case 1: return trace_v8_multi_kernel<1, COUNT>;
    case 2: return trace_v8_multi_kernel<2, COUNT>;
    case 3: return trace_v8_multi_kernel<3, COUNT>;
    case 4: return trace_v8_multi_kernel<4, COUNT>;
    case 5: return trace_v8_multi_kernel<5, COUNT>;
    case 6: return trace_v8_multi_kernel<6, COUNT>;
    case 7: return trace_v8_multi_kernel<7, COUNT>;
    case MAX_SEGMENTS: return trace_v8_multi_kernel<MAX_SEGMENTS, COUNT>;
    default: return nullptr;
  }
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
  const bool masked = amask != nullptr;
  TraceFn fn = count ? pick<true>(mode, common, masked) : pick<false>(mode, common, masked);
  return launch(fn, rays, sup, blk, coeff, amask, hints, nullptr, nullptr,
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
  return launch(fn, rays, pairs, blk, coeff, amask, nullptr,
                pair_tab, inst_inv, outf, outi, ts, npair, cb, 0, l1_mask, nblk, ninst, stream);
}

// The multi-segment kernel: rays (ts, 4 + 4 s_count, 128), 1 <= s_count <=
// 8; sup, blk and coeff as rt_trace_v8's.  count = 1 also writes outi rows 4
// to 7.  Returns cudaErrorInvalidValue for another s_count.
int rt_trace_v8_multi(const void* rays, const void* sup, const void* blk,
                      const void* coeff, void* outf, void* outi, int ts, int nsup,
                      int cb, int l1_mask, int s_count, int count, void* stream) {
  if (ts <= 0) return 0;
  MultiFn fn = count ? pick_multi<true>(s_count) : pick_multi<false>(s_count);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int cap1 = 1;
  while (cap1 < nsup) cap1 <<= 1;
  const size_t smem = s_count * sizeof(Samples<1>) + (size_t)cap1 * sizeof(int);
  const cudaError_t e = opt_in(fn, smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<ts, TILE, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)sup, (const float*)blk, (const float*)coeff,
      (float*)outf, (int*)outi, nsup, cb, l1_mask);
  return (int)cudaGetLastError();
}

const char* rt_trace_v8_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
