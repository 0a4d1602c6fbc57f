// v9 quarter-composited ordered-visit closest-hit traversal, written for
// Hopper (sm_90a).
//
// Replaces realtimeraytracer_tpu/render/quarter_backend.py::
// trace_blocks_quarter (kernel body _trace_kernel/_tile_body).  Same
// contract: one 128-ray tile per CTA, rays (Ts, 8, 128) f32 rows
// [o.xyz | d.xyz | t_min | t_max]; four per-quarter key streams per tile
// (Ts, 4, nkeys) i32, a quarter-q key packing the entry bound of subcluster
// 4B + q (lanes [32q, 32q+32) of coefficient block B) with the block id B
// in the low id bits (+inf bits = no candidate); coefficient blocks
// (CB, 12, 128) f32; an optional pads-before-group table group_off
// (CB*4,) i32 of the SAH-repacked panels; optional alpha masks (CB, 2,
// 128) i32 laid out like the coefficient blocks, i.e. by repacked slot
// (pad lanes 0; bit b = 8 gj + gi in word b >> 5 is 0 where the
// barycentric cell is definitely transparent, ops/alpha_mask.py).
// Outputs: outf row 0 = t (3e38
// on a miss); outi row 0 = sorted-triangle id (-1 on a miss), row 1 =
// subclusters visited (4 per composite visit), row 5 = ray-triangle pairs
// this ray tested on real subclusters (live rays only; a drained stream's
// zero lanes are not counted): the bound's operation count.
//
// Design.  One thread per ray.  Each quarter stream's valid keys are
// compacted into shared memory and the four streams are bitonic-sorted
// side by side; visit v then takes the v-th key of every stream, which is
// the TPU kernel's pop order (each iteration pops every stream's minimum).
// A visit stages each popped block's own 32-lane quarter into one 12x128
// shared tile, so one pass over 128 lanes tests four subclusters from
// (generally) four different blocks.  A drained stream's lanes are zero,
// which fails the determinant test: the TPU kernel instead re-composites
// block cb-1 there, with the same result.  Stop rule (exact, as on the
// TPU): the least of the four stream heads is the least remaining entry
// bound; stop when it exceeds every live ray's min(best_t, t_max), compared
// as int32 f32 bits, with one __syncthreads_or per visit.  The winning
// lane's quarter names its block, and group_off maps the repacked slot
// back to the sorted id.  The coefficient table is read from global memory
// (4.8 MB at 100k triangles, resident in the 50 MB L2).
//
// What bounds it: f32 operations per visit (47 per ray-triangle pair in
// general, 29 with a common origin, 128x128 pairs per visit) and the
// number of visits the cull lets through; a visit costs what a v7 visit
// costs, but tests four 32-triangle subclusters the cull chose instead of
// one 128-triangle block.
//
// Numerics: -fmad=false, the same expressions and order as the plain
// twin (render/quarter_backend.py::trace_quarter_plain), so t and ids
// agree bit for bit.
//
// Alpha masks (the TPU kernel's composite_amask + _mask_ok): a masked
// launch composites each popped block's mask rows by the same lane
// quarters as its coefficients, so lane j of the visit reads the mask of
// the slot it tests, which is the repacked slot (the id before the
// group_off remap).  An accepted pair whose (u, v) cell bit is 0 is
// rejected, on the u and v the accept test just computed.  The masked
// variant is its own instantiation; the unmasked launch pays nothing.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int CROWS = 12;
constexpr int NQ = 4;
constexpr int SUBK = 32;
constexpr float BIG = 3.0e38f;
constexpr float EPS = 1e-12f;
constexpr int INVALID = 0x7F800000;
constexpr int KEY_PAD = 0x7FFFFFFF;

enum Common { COMMON_NONE = 0, COMMON_ORIGIN = 1, COMMON_DIR = 2 };

// ((o0*c0 + o1*c1) + o2*c2) + c3: the TPU kernel's association.
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

// The alpha-mask bit of lane j's triangle at barycentrics (u, v); m holds
// the visit's two composited mask rows (2 x TILE).
__device__ __forceinline__ bool mask_bit(const int* m, int j, float u, float v) {
  const int gi = min(max(__float2int_rz(u * 8.0f), 0), 7);
  const int gj = min(max(__float2int_rz(v * 8.0f), 0), 7);
  const int b = gj * 8 + gi;
  return ((static_cast<unsigned>(m[(b >> 5) * TILE + j]) >> (b & 31)) & 1u) != 0u;
}

template <int COMMON, bool MASK>
__global__ void __launch_bounds__(TILE) trace_v9_kernel(
    const float* __restrict__ rays, const int* __restrict__ keys,
    const float* __restrict__ coeff, const int* __restrict__ group_off,
    const int* __restrict__ amask, float* __restrict__ outf,
    int* __restrict__ outi, int nkeys, int cap, int cb, int id_mask) {
  extern __shared__ int sq[];                  // NQ streams of `cap` keys
  __shared__ float coef[CROWS * TILE];
  __shared__ float fam[3 * TILE];
  __shared__ int smask[MASK ? 2 * TILE : 1];
  __shared__ int count[NQ];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;

  const float* r = rays + (size_t)tile * 8 * TILE;
  const float ox = r[0 * TILE + lane], oy = r[1 * TILE + lane],
              oz = r[2 * TILE + lane];
  const float dx = r[3 * TILE + lane], dy = r[4 * TILE + lane],
              dz = r[5 * TILE + lane];
  const float tmin = r[6 * TILE + lane], tmax = r[7 * TILE + lane];
  const int cbase = COMMON == COMMON_DIR ? 3 : 0;
  const float cx = r[(cbase + 0) * TILE], cy = r[(cbase + 1) * TILE],
              cz = r[(cbase + 2) * TILE];

  // Compact each quarter stream's candidate keys.
  if (lane < NQ) count[lane] = 0;
  __syncthreads();
  const int* tk = keys + (size_t)tile * NQ * nkeys;
  for (int q = 0; q < NQ; ++q) {
    for (int k = lane; k < nkeys; k += TILE) {
      const int key = tk[(size_t)q * nkeys + k];
      if (key != INVALID) sq[q * cap + atomicAdd(&count[q], 1)] = key;
    }
  }
  __syncthreads();
  int n[NQ];
  int nmax = 0;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    n[q] = count[q];
    nmax = max(nmax, n[q]);
  }
  // Sort the four streams side by side: bitonic networks of size p each.
  int p = 1;
  while (p < nmax) p <<= 1;
  for (int q = 0; q < NQ; ++q)
    for (int k = n[q] + lane; k < p; k += TILE) sq[q * cap + k] = KEY_PAD;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int idx = lane; idx < NQ * p; idx += TILE) {
        const int q = idx / p;
        const int i = idx - q * p;
        const int ixj = i ^ j;
        if (ixj > i) {
          int* s = sq + q * cap;
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

  float best_t = BIG;
  int best_k = -1;
  int visits = 0, pairs = 0;
  const int my_q = lane / SUBK;
  for (int v = 0; v < nmax; ++v) {
    int kmin = KEY_PAD;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (v < n[q]) kmin = min(kmin, sq[q * cap + v]);
    const int entry = kmin & ~id_mask;
    const int limit_bits = __float_as_int(fminf(best_t, tmax));
    // Exact stop rule; the barrier also retires the previous visit's reads.
    if (!__syncthreads_or(limit_bits >= entry)) break;
    // Composite: lane j takes quarter j/32 of that quarter's popped block.
    if (v < count[my_q]) {
      const int cid = min(sq[my_q * cap + v] & id_mask, cb - 1);
      const float* cg = coeff + (size_t)cid * CROWS * TILE;
#pragma unroll
      for (int row = 0; row < CROWS; ++row)
        coef[row * TILE + lane] = cg[row * TILE + lane];
      if (MASK) {
        const int* mg = amask + (size_t)cid * 2 * TILE;
        smask[lane] = mg[lane];
        smask[TILE + lane] = mg[TILE + lane];
      }
    } else {
#pragma unroll
      for (int row = 0; row < CROWS; ++row) coef[row * TILE + lane] = 0.0f;
      if (MASK) smask[lane] = smask[TILE + lane] = 0;
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
    if (!(tmin <= limit)) continue;            // this ray cannot hit here
#pragma unroll
    for (int q = 0; q < NQ; ++q) pairs += v < n[q] ? SUBK : 0;
    int kbest = KEY_PAD;
    for (int j = 0; j < TILE; ++j) {
      float s0, ou, ov, s1, du, dv;
      if (COMMON == COMMON_ORIGIN) {
        s0 = fam[j];
        ou = fam[TILE + j];
        ov = fam[2 * TILE + j];
      } else {
        s0 = dot_o(coef, 0, j, ox, oy, oz);
        ou = dot_o(coef, 4, j, ox, oy, oz);
        ov = dot_o(coef, 8, j, ox, oy, oz);
      }
      if (COMMON == COMMON_DIR) {
        s1 = fam[j];
        du = fam[TILE + j];
        dv = fam[2 * TILE + j];
      } else {
        s1 = dot_d(coef, 0, j, dx, dy, dz);
        du = dot_d(coef, 4, j, dx, dy, dz);
        dv = dot_d(coef, 8, j, dx, dy, dz);
      }
      const bool den_ok = fabsf(s1) > EPS;
      const float t = den_ok ? (-s0) / s1 : BIG;
      const float u = ou + t * du;
      const float vv = ov + t * dv;
      bool ok = den_ok && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f &&
                t >= tmin && t <= limit;
      if (MASK && ok) ok = mask_bit(smask, j, u, vv);
      // Packed (t | lane) key: nearest quantized t, then the lowest lane.
      const float tm = ok ? t : __int_as_float(INVALID);
      kbest = min(kbest, (__float_as_int(tm) & ~127) | j);
    }
    if (kbest < __float_as_int(best_t)) {
      const int j = kbest & 127;
      const int q = j / SUBK;
      const int cid = min(sq[q * cap + v] & id_mask, cb - 1);
      best_t = __int_as_float(kbest & ~127);
      best_k = cid * TILE + j - (group_off ? group_off[cid * NQ + q] : 0);
    }
  }

  float* of = outf + (size_t)tile * 8 * TILE;
  int* oi = outi + (size_t)tile * 8 * TILE;
  of[lane] = best_t;
  oi[lane] = best_k;
  oi[TILE + lane] = NQ * visits;
  oi[5 * TILE + lane] = pairs;
}

typedef void (*TraceFn)(const float*, const int*, const float*, const int*,
                        const int*, float*, int*, int, int, int, int);

template <bool MASK>
TraceFn pick(int common) {
  if (common == COMMON_ORIGIN) return trace_v9_kernel<COMMON_ORIGIN, MASK>;
  if (common == COMMON_DIR) return trace_v9_kernel<COMMON_DIR, MASK>;
  return trace_v9_kernel<COMMON_NONE, MASK>;
}

}  // namespace

extern "C" {

// Launches one CTA per tile on `stream`.  group_off may be null (panels
// without repacking: ids are slot ids); amask may be null (no alpha
// masks).  Returns cudaGetLastError() after the launch (0 = launched), or
// the error of the shared-memory opt-in.
int rt_trace_v9(const void* rays, const void* keys, const void* coeff,
                const void* group_off, const void* amask, void* outf,
                void* outi, int ts, int nkeys, int cb, int id_mask,
                int common, void* stream) {
  if (ts <= 0) return 0;
  int cap = 1;
  while (cap < nkeys) cap <<= 1;
  const size_t smem = (size_t)NQ * cap * sizeof(int);
  const bool masked = amask != nullptr;
  TraceFn fn = masked ? pick<true>(common) : pick<false>(common);
  const size_t static_smem = (CROWS + 3) * TILE * sizeof(float) + NQ * sizeof(int) +
                             (masked ? 2 * TILE * sizeof(int) : sizeof(int));
  if (smem + static_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<ts, TILE, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const int*)keys, (const float*)coeff,
      (const int*)group_off, (const int*)amask, (float*)outf, (int*)outi,
      nkeys, cap, cb, id_mask);
  return (int)cudaGetLastError();
}

const char* rt_trace_v9_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
