// v7 ordered-visit ray/triangle traversal, written for Hopper (sm_90a).
//
// Replaces realtimeraytracer_tpu/render/pallas_backend.py::trace_blocks
// (kernel body _trace_kernel/_tile_body).  Same contract: one 128-ray tile
// per CTA, rays (Ts, 8, 128) f32 rows [o.xyz | d.xyz | t_min | t_max], the
// tile's packed block keys (Ts, nkeys) i32 (entry-distance bits with the
// block id in the low id bits, +inf bits = no candidate), Baldwin-Weber
// coefficient blocks (CB, 12, 128) f32 rows [n | -n.A | r1 | -r1.A | r2 |
// -r2.A]; optional alpha masks (CB, 2, 128) i32 (closest mode only: bit
// b = 8 gj + gi of a triangle's 64-bit mask, word b >> 5, is 0 where the
// barycentric cell (gi, gj) = (int(8u), int(8v)) is definitely
// transparent; ops/alpha_mask.py).  Outputs: outf row 0 = t (closest; 3e38 on a miss) or the
// occluded flag; outi row 0 = sorted-triangle id (-1 on a miss), row 1 =
// blocks visited, row 5 = ray-triangle pairs this ray tested (live rays
// only, up to the first hit in occluded mode: the bound's operation
// count).  Rows the kernel does not write are left as the caller allocated
// them.
//
// Design.  One thread per ray, 128 threads per tile.  The tile's valid keys
// are compacted into shared memory and bitonic-sorted once, which gives the
// same visit order as the TPU kernel's repeated min-pops (keys are unique
// within a tile).  Each visit stages the block's 12x128 coefficients (6 KB)
// in shared memory; every thread then tests its ray against the 128
// triangles, reading the rows as broadcasts.  The exact stop rule of the TPU
// kernel (stop when the next entry bound exceeds every live ray's
// min(best_t, t_max), compared as int32 f32 bits) is one __syncthreads_or
// per visit.  Occluded rays set best_t = -3e38 so they stop bounding the
// loop.  The coefficient table is read from global memory on every path: a
// 100k-triangle scene's table is 4.8 MB and stays in the 50 MB L2, so the
// TPU's resident-VMEM vs HBM-DMA split has no counterpart here.
//
// What bounds it: f32 FMAs per ray-triangle pair tested (about 21
// multiply-adds and one division; each live ray tests a visited block's 128
// triangles, an occluded ray stops at its first hit), and the number of
// visits the cull lets through.  common="origin" (pinhole primaries) and
// common="dir" (sun shadows) precompute the shared dot family once per
// triangle per visit, removing 9 of the 21 multiply-adds per pair.
//
// Numerics: built with -fmad=false so that no a*b+c is contracted.  The
// plain PyTorch twin (render/v7_backend.py::trace_keys_plain) evaluates the
// same expressions in the same order, so t and ids agree bit for bit; the
// Baldwin-Weber u = dot_o + t*dot_d is cancellation-prone, and contraction
// would move t by a few ulp.
//
// Alpha masks (the TPU kernel's _mask_ok): a masked launch stages the
// visited block's two mask rows in shared memory beside its coefficients
// and rejects an accepted pair whose (u, v) cell bit is 0, on the u and v
// the accept test just computed; ints truncate toward zero as XLA's
// astype(int32) does.  The masked variant is its own instantiation, so
// the unmasked launch pays nothing for it.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int CROWS = 12;
constexpr float BIG = 3.0e38f;
constexpr float EPS = 1e-12f;
constexpr int INVALID = 0x7F800000;
constexpr int KEY_PAD = 0x7FFFFFFF;

enum Mode { CLOSEST = 0, OCCLUDED = 1 };
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
// the visited block's two mask rows (2 x TILE).
__device__ __forceinline__ bool mask_bit(const int* m, int j, float u, float v) {
  const int gi = min(max(__float2int_rz(u * 8.0f), 0), 7);
  const int gj = min(max(__float2int_rz(v * 8.0f), 0), 7);
  const int b = gj * 8 + gi;
  return ((static_cast<unsigned>(m[(b >> 5) * TILE + j]) >> (b & 31)) & 1u) != 0u;
}

template <int MODE, int COMMON, bool MASK>
__global__ void __launch_bounds__(TILE) trace_v7_kernel(
    const float* __restrict__ rays, const int* __restrict__ keys,
    const float* __restrict__ coeff, const int* __restrict__ amask,
    float* __restrict__ outf, int* __restrict__ outi, int nkeys, int cb,
    int id_mask) {
  extern __shared__ int smem[];
  __shared__ int count;
  int* skeys = smem;                                     // sort capacity
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;

  int cap = 1;
  while (cap < nkeys) cap <<= 1;
  float* coef = reinterpret_cast<float*>(smem + cap);   // CROWS x TILE
  float* fam = coef + CROWS * TILE;                      // 3 x TILE
  int* smask = reinterpret_cast<int*>(fam + 3 * TILE);   // 2 x TILE if MASK

  const float* r = rays + (size_t)tile * 8 * TILE;
  const float ox = r[0 * TILE + lane], oy = r[1 * TILE + lane],
              oz = r[2 * TILE + lane];
  const float dx = r[3 * TILE + lane], dy = r[4 * TILE + lane],
              dz = r[5 * TILE + lane];
  const float tmin = r[6 * TILE + lane], tmax = r[7 * TILE + lane];
  // The tile-shared origin or direction is lane 0's, as in the TPU kernel.
  const int cbase = COMMON == COMMON_DIR ? 3 : 0;
  const float cx = r[(cbase + 0) * TILE], cy = r[(cbase + 1) * TILE],
              cz = r[(cbase + 2) * TILE];

  // Compact the tile's candidate keys, then sort them ascending.
  if (lane == 0) count = 0;
  __syncthreads();
  const int* tk = keys + (size_t)tile * nkeys;
  for (int k = lane; k < nkeys; k += TILE) {
    const int key = tk[k];
    if (key != INVALID) skeys[atomicAdd(&count, 1)] = key;
  }
  __syncthreads();
  const int n = count;
  int p = 1;
  while (p < n) p <<= 1;
  for (int k = n + lane; k < p; k += TILE) skeys[k] = KEY_PAD;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < p; i += TILE) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int a = skeys[i], b = skeys[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            skeys[i] = b;
            skeys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  float best_t = BIG;
  int best_k = -1;
  int visits = 0, pairs = 0;
  for (int i = 0; i < n; ++i) {
    const int key = skeys[i];
    const int entry = key & ~id_mask;
    const int limit_bits = __float_as_int(fminf(best_t, tmax));
    // Exact stop rule; the barrier also retires the previous visit's reads.
    if (!__syncthreads_or(limit_bits >= entry)) break;
    const int cid = min(key & id_mask, cb - 1);
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

    const bool live = MODE == CLOSEST ? true : best_t >= 0.0f;
    const float limit = MODE == CLOSEST ? fminf(best_t, tmax) : tmax;
    if (!live || !(tmin <= limit)) continue;   // this ray cannot hit here
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
      const float v = ov + t * dv;
      bool ok = den_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                t >= tmin && t <= limit;
      if (MASK && ok) ok = mask_bit(smask, j, u, v);
      if (MODE == CLOSEST) {
        // Packed (t | lane) key: one min finds the nearest t and, on a
        // quantized tie, the lowest lane.  Misses carry +inf bits.
        const float tm = ok ? t : __int_as_float(INVALID);
        kbest = min(kbest, (__float_as_int(tm) & ~127) | j);
      } else if (ok) {
        hit = true;
        tested = j + 1;
        break;
      }
    }
    pairs += tested;
    if (MODE == CLOSEST) {
      if (kbest < __float_as_int(best_t)) {
        best_t = __int_as_float(kbest & ~127);
        best_k = cid * TILE + (kbest & 127);
      }
    } else if (hit) {
      best_t = -BIG;
    }
  }

  float* of = outf + (size_t)tile * 8 * TILE;
  int* oi = outi + (size_t)tile * 8 * TILE;
  of[lane] = MODE == CLOSEST ? best_t : (best_t < 0.0f ? 1.0f : 0.0f);
  oi[lane] = best_k;
  oi[TILE + lane] = visits;
  oi[5 * TILE + lane] = pairs;
}

typedef void (*TraceFn)(const float*, const int*, const float*, const int*,
                        float*, int*, int, int, int);

// Masks exist in closest mode only (occlusion under alpha is a ladder of
// closest traces); a masked occluded launch has no kernel.
TraceFn pick(int mode, int common, bool masked) {
  if (mode == CLOSEST) {
    if (masked) {
      if (common == COMMON_ORIGIN) return trace_v7_kernel<CLOSEST, COMMON_ORIGIN, true>;
      if (common == COMMON_DIR) return trace_v7_kernel<CLOSEST, COMMON_DIR, true>;
      return trace_v7_kernel<CLOSEST, COMMON_NONE, true>;
    }
    if (common == COMMON_ORIGIN) return trace_v7_kernel<CLOSEST, COMMON_ORIGIN, false>;
    if (common == COMMON_DIR) return trace_v7_kernel<CLOSEST, COMMON_DIR, false>;
    return trace_v7_kernel<CLOSEST, COMMON_NONE, false>;
  }
  if (masked) return nullptr;
  if (common == COMMON_ORIGIN) return trace_v7_kernel<OCCLUDED, COMMON_ORIGIN, false>;
  if (common == COMMON_DIR) return trace_v7_kernel<OCCLUDED, COMMON_DIR, false>;
  return trace_v7_kernel<OCCLUDED, COMMON_NONE, false>;
}

}  // namespace

extern "C" {

// Launches one CTA per tile on `stream`.  amask may be null (no alpha
// masks; closest mode only otherwise).  Returns cudaGetLastError() after
// the launch (0 = launched), or the error of the shared-memory opt-in.
int rt_trace_v7(const void* rays, const void* keys, const void* coeff,
                const void* amask, void* outf, void* outi, int ts, int nkeys,
                int cb, int id_mask, int mode, int common, void* stream) {
  if (ts <= 0) return 0;
  int cap = 1;
  while (cap < nkeys) cap <<= 1;
  const bool masked = amask != nullptr;
  const size_t smem = (size_t)cap * sizeof(int) +
                      (size_t)(CROWS + 3) * TILE * sizeof(float) +
                      (masked ? (size_t)2 * TILE * sizeof(int) : 0);
  TraceFn fn = pick(mode, common, masked);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<ts, TILE, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const int*)keys, (const float*)coeff,
      (const int*)amask, (float*)outf, (int*)outi, nkeys, cb, id_mask);
  return (int)cudaGetLastError();
}

const char* rt_trace_v7_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
