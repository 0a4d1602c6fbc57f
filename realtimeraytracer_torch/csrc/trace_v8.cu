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
//   Design.  One thread per ray; its origin, t_min and the S directions,
//   inverse directions and t_hi sit in registers (S is a template
//   parameter).  The culls use the ray's direction hull: per axis the
//   interval [min_s d, max_s d]; a sign-definite one (lo > EPS or hi < -EPS)
//   inverts to [1/hi, 1/lo], one that straddles zero passes the axis, and
//   the slab takes the min and max of (p - o) times both ends.  Division and
//   multiplication round monotonically, so every sample's own slab interval
//   lies inside the hull's: a hull entry is a lower bound for every sample
//   and v8's stop rules stay exact.  A ray's live limit is the greatest t_hi
//   of its samples not yet occluded (-3e38 when none is left: retired).  At
//   a visit each live sample slab-tests the block with its own inverse
//   direction under its own window, as the single kernel's per-visit test
//   does.  Each trace then reaches every block whose slab test passes for
//   the sample until the sample is occluded and tests no other, so both
//   flags are the same any-hit over the same blocks.  Per triangle the
//   origin family (s0, ou, ov) is computed once, then each sample still
//   untested in this block pays its direction dots and accept test; a sample
//   retires at its first hit.  One thread per ray means a retired sample or
//   ray skips its math without holding its neighbours, which the TPU's
//   128-lane blocks could not do (there the fused trace lost to three
//   single ones).
//   What bounds it: f32 operations, 29 per sample test (three direction
//   dots 15, |s1| > eps 2, t 2, u and v 4, u + v 1, five compares), 18 per
//   origin-family evaluation (three origin dots), 45 per hull slab test (per
//   axis two subtractions, four multiplications and six min/max, then the
//   near/far combine 4, four compares and max(near, 0)) and 27 per
//   per-sample slab test.
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

// A barrier; with COUNT, also the number of the CTA's threads whose
// predicate holds.
template <bool COUNT>
__device__ __forceinline__ int live_count(bool pred) {
  if (COUNT) return __syncthreads_count(pred);
  __syncthreads();
  return 0;
}

// The tile's rays as the culls read them, one ray per slot: [o.xyz |
// t_min], [guarded inverse direction | the live window's upper end,
// refreshed per cull], parallel-axis bits.
struct Tile {
  float4 ray[TILE][2];
  int fl[TILE];
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

// Least entries over the tile's live rays (the compacted list; the other
// rays' windows are empty) of NB boxes (lane b[i] of the (8, 128) box page
// page[i]; boxes i >= nbox are skipped), +inf bits where no live window
// overlaps a box.  Each ray is read once for the NB boxes, and the NB slab
// tests are independent; each box still takes its minimum over the rays
// in list order.  A valid box adds `nlive` to this thread's slab count.
template <int NB, bool COUNT>
__device__ __forceinline__ void box_min_entries(const Tile& T, const Live& L, int nlive,
                                                const float* const (&page)[NB],
                                                const int (&b)[NB], int nbox,
                                                float (&emin)[NB], int* work) {
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
      if (COUNT && ok[i]) work[TILE + threadIdx.x] += nlive;
    }
    any |= ok[i];
  }
  if (!any) return;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = L.cnt[w];
    for (int k = 0; k < c; ++k) {
      const int r = L.list[32 * w + k];
      const float4 ra = T.ray[r][0], rb = T.ray[r][1];
      const int f = T.fl[r];
      const float o[3] = {ra.x, ra.y, ra.z};
      const float inv[3] = {rb.x, rb.y, rb.z};
#pragma unroll
      for (int i = 0; i < NB; ++i)
        if (ok[i]) emin[i] = fminf(emin[i], slab_entry(lo[i], hi[i], o, inv, f, ra.w, rb.w));
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
  const int live1 = compact_live(L, tmin <= fminf(best_t, tmax));
  if (live1 > 0) {
    // Four boxes a thread per pass: s = base + 128 i + lane.
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
      box_min_entries<4, COUNT>(T, L, live1, pg, bl, nbox, e, work);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = base + i * TILE + lane;
        const int key = i < nbox && __float_as_int(e[i]) != INVALID
                            ? (__float_as_int(e[i]) & ~l1_mask) | s
                            : INVALID;
        // Append this warp's keys with one atomic (the order is sorted away).
        const unsigned m = __ballot_sync(FULL, key != INVALID);
        int at = 0;
        if ((lane & 31) == 0 && m) at = atomicAdd(&count, __popc(m));
        at = __shfl_sync(FULL, at, 0);
        if (key != INVALID) l1keys[at + __popc(m & ((1u << (lane & 31)) - 1u))] = key;
      }
    }
  }
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
      box_min_entries<1, COUNT>(T, L, live2, pg, bl, 1, e1, work);
      e = e1[0];
    }
    // Sort the 128 block keys: each thread ranks its own (unique: the block
    // in the low bits; no candidate = INVALID + lane, after every key).
    const int k2own = __float_as_int(e) == INVALID
                          ? INVALID + lane
                          : (__float_as_int(e) & ~((1 << BLK_BITS) - 1)) | lane;
    l2in[lane] = k2own;
    __syncthreads();
    l2keys[rank_of(l2in, SUP, k2own)] = k2own;
    __syncthreads();
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

// The multi-segment kernel's shared ray state: origins, the inverse of each
// ray's direction hull, its straddle bits, t_min and the live limits.
struct HullTile {
  float o[3][TILE];
  float ilo[3][TILE];
  float ihi[3][TILE];
  int fl[TILE];          // bit a set where the hull's axis a straddles zero
  float tmin[TILE];
  float limit[TILE];
};

// slab_entry for every direction of a ray's hull: the interval of (p - o)
// times [ilo, ihi] per axis; fl's axes pass every slab.
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

// box_min_entry under the rays' hulls.  A valid box adds `live` to this
// thread's hull slab count.
template <bool COUNT>
__device__ __forceinline__ float hull_min_entry(const HullTile& T, const float* page, int b,
                                               int live, int& hslabs) {
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = page[a * TILE + b];
    hi[a] = page[(3 + a) * TILE + b];
  }
  float emin = __int_as_float(INVALID);
  if (!(lo[0] <= hi[0])) return emin;
  if (COUNT) hslabs += live;
  for (int r = 0; r < TILE; ++r) {
    const float o[3] = {T.o[0][r], T.o[1][r], T.o[2][r]};
    const float ilo[3] = {T.ilo[0][r], T.ilo[1][r], T.ilo[2][r]};
    const float ihi[3] = {T.ihi[0][r], T.ihi[1][r], T.ihi[2][r]};
    emin = fminf(emin, hull_entry(lo, hi, o, ilo, ihi, T.fl[r], T.tmin[r], T.limit[r]));
  }
  return emin;
}

// The greatest t_hi over the samples not yet occluded, -BIG if none is left.
template <int S>
__device__ __forceinline__ float live_limit(const float (&thi)[S], unsigned occ) {
  float lim = -BIG;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (!((occ >> s) & 1u)) lim = fmaxf(lim, thi[s]);
  return lim;
}

// One block visit for S samples: stage the coefficients; each live sample
// slab-tests the block box (lane b of `page`) with its own inverse direction
// (axis bits 3s..3s+2 of sfl) under [tmin, thi_s]; those that pass test the
// block's triangles, sharing the origin family per triangle.  Every thread
// of the CTA calls it (it holds a barrier).
template <int S, bool COUNT>
__device__ __forceinline__ void visit_multi(
    int cid, const float* __restrict__ coeff, const float* __restrict__ page, int b,
    float* coef, const float (&o)[3], const float (&d)[S][3], const float (&inv)[S][3],
    int sfl, const float (&thi)[S], float tmin, unsigned& occ, int& visits, int& tests,
    int& fams, int& slabs) {
  const int lane = threadIdx.x;
  const float* cg = coeff + (size_t)cid * CROWS * TILE;
#pragma unroll
  for (int row = 0; row < CROWS; ++row)
    coef[row * TILE + lane] = cg[row * TILE + lane];
  __syncthreads();
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
    if (((occ >> s) & 1u) || !(tmin <= thi[s])) continue;
    if (COUNT) ++slabs;
    if (slab_entry(lo, hi, o, inv[s], (sfl >> (3 * s)) & 7, tmin, thi[s]) <
        __int_as_float(INVALID))
      todo |= 1u << s;
  }
  for (int j = 0; j < TILE && todo; ++j) {
    const float s0 = dot_o(coef, 0, j, o[0], o[1], o[2]);
    const float ou = dot_o(coef, 4, j, o[0], o[1], o[2]);
    const float ov = dot_o(coef, 8, j, o[0], o[1], o[2]);
    if (COUNT) ++fams;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (!((todo >> s) & 1u)) continue;
      if (COUNT) ++tests;
      const float s1 = dot_d(coef, 0, j, d[s][0], d[s][1], d[s][2]);
      const float du = dot_d(coef, 4, j, d[s][0], d[s][1], d[s][2]);
      const float dv = dot_d(coef, 8, j, d[s][0], d[s][1], d[s][2]);
      const bool den_ok = fabsf(s1) > EPS;
      const float t = den_ok ? (-s0) / s1 : BIG;
      const float u = ou + t * du;
      const float v = ov + t * dv;
      if (den_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin && t <= thi[s]) {
        todo &= ~(1u << s);
        occ |= 1u << s;
      }
    }
  }
}

template <int S, bool COUNT>
__global__ void __launch_bounds__(TILE, MIN_CTAS) trace_v8_multi_kernel(
    const float* __restrict__ rays, const float* __restrict__ sup,
    const float* __restrict__ blk, const float* __restrict__ coeff,
    float* __restrict__ outf, int* __restrict__ outi, int nsup, int cb, int l1_mask) {
  extern __shared__ int l1keys[];                 // cap1 super keys
  __shared__ HullTile T;
  __shared__ float coef[CROWS * TILE];
  __shared__ int l2keys[SUP];
  __shared__ int count;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;

  const float* r = rays + (size_t)tile * (4 + 4 * S) * TILE;
  const float o[3] = {r[0 * TILE + lane], r[1 * TILE + lane], r[2 * TILE + lane]};
  const float tmin = r[3 * TILE + lane];
  float d[S][3], inv[S][3], thi[S];
  int sfl = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      d[s][a] = r[(4 + 4 * s + a) * TILE + lane];
      const bool par = fabsf(d[s][a]) <= EPS;
      sfl |= par ? 1 << (3 * s + a) : 0;
      inv[s][a] = 1.0f / (par ? 1.0f : d[s][a]);
    }
    thi[s] = r[(7 + 4 * s) * TILE + lane];
  }
  int hfl = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float lo = d[0][a], hi = d[0][a];
#pragma unroll
    for (int s = 1; s < S; ++s) {
      lo = fminf(lo, d[s][a]);
      hi = fmaxf(hi, d[s][a]);
    }
    const bool definite = lo > EPS || hi < -EPS;
    hfl |= definite ? 0 : 1 << a;
    T.o[a][lane] = o[a];
    T.ilo[a][lane] = definite ? 1.0f / hi : -BIG;
    T.ihi[a][lane] = definite ? 1.0f / lo : BIG;
  }
  T.fl[lane] = hfl;
  T.tmin[lane] = tmin;

  unsigned occ = 0;
  int visits = 0, l1pops = 0, hslabs = 0, tests = 0, fams = 0, slabs = 0;

  // L1: least hull entry per super over the live rays, sorted once.
  if (lane == 0) count = 0;
  T.limit[lane] = live_limit<S>(thi, occ);
  const int live1 = live_count<COUNT>(tmin <= live_limit<S>(thi, occ));
  for (int s = lane; s < nsup; s += TILE) {
    const float e = hull_min_entry<COUNT>(T, sup + (size_t)(s / TILE) * 8 * TILE, s % TILE,
                                          live1, hslabs);
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
    if (!__syncthreads_or(__float_as_int(live_limit<S>(thi, occ)) >= (key & ~l1_mask)))
      break;
    ++l1pops;
    const int s = key & l1_mask;
    // L2: block keys of this super against the live hulls.
    const float* page = blk + (size_t)s * 8 * TILE;
    T.limit[lane] = live_limit<S>(thi, occ);
    const int live2 = live_count<COUNT>(tmin <= live_limit<S>(thi, occ));
    const float e = hull_min_entry<COUNT>(T, page, lane, live2, hslabs);
    l2keys[lane] = __float_as_int(e) == INVALID
                       ? INVALID
                       : (__float_as_int(e) & ~((1 << BLK_BITS) - 1)) | lane;
    __syncthreads();
    bitonic_sort(l2keys, SUP);
    for (int j = 0; j < SUP; ++j) {
      const int k2 = l2keys[j];
      if (k2 == INVALID) break;                      // uniform: shared read
      if (!__syncthreads_or(__float_as_int(live_limit<S>(thi, occ)) >=
                            (k2 & ~((1 << BLK_BITS) - 1))))
        break;
      const int b = k2 & ((1 << BLK_BITS) - 1);
      visit_multi<S, COUNT>(min(s * SUP + b, cb - 1), coeff, page, b, coef, o, d, inv, sfl,
                            thi, tmin, occ, visits, tests, fams, slabs);
    }
  }

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

// An upper bound of the multi-segment CTA's static shared memory.
constexpr size_t MULTI_STATIC_SMEM = sizeof(HullTile) + (CROWS + 1) * TILE * sizeof(float) + 64;

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
  const size_t smem = (size_t)cap1 * sizeof(int);
  if (smem + MULTI_STATIC_SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<ts, TILE, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)sup, (const float*)blk, (const float*)coeff,
      (float*)outf, (int*)outi, nsup, cb, l1_mask);
  return (int)cudaGetLastError();
}

const char* rt_trace_v8_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
