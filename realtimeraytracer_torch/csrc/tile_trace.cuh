// Pieces shared by the v7 and v9 traversal kernels (trace_v7.cu,
// trace_v9.cu): the tile prologue's cull, the ray-triangle test four
// triangles a step, and asynchronous staging.  Included inside each
// source's translation unit only (its own anonymous namespace); the kernel
// build hashes this header with each source (kernels.py).
//
// Cull: _sub_entries' interval arithmetic (render/v7_backend.py, the XLA
// of render/pallas_backend.py in the JAX package) in its order, fminf /
// fmaxf where torch takes minimum, maximum and clamp_min, IEEE 1.0f / x,
// so that the entries, and the keys packed from them, are bit-equal to the
// plain cull's on the card (with -fmad=false).
//
// Test: Baldwin-Weber, the TPU kernel's association ((o0*c0 + o1*c1) +
// o2*c2) + c3, IEEE division; NV triangles a step, read with one 16-byte
// broadcast load per coefficient row, so that a thread has NV independent
// tests in flight (the loop is latency-bound: PERF.md).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int WARPS = TILE / 32;
constexpr int CROWS = 12;
constexpr int NQ = 4;                         // subcluster boxes per block
constexpr float BIG = 3.0e38f;
constexpr float EPS = 1e-12f;
constexpr int INVALID = 0x7F800000;
constexpr int KEY_PAD = 0x7FFFFFFF;
constexpr unsigned FULL = 0xFFFFFFFFu;

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
// the visit's two mask rows (2 x TILE).
__device__ __forceinline__ bool mask_bit(const int* m, int j, float u, float v) {
  const int gi = min(max(__float2int_rz(u * 8.0f), 0), 7);
  const int gj = min(max(__float2int_rz(v * 8.0f), 0), 7);
  const int b = gj * 8 + gi;
  return ((static_cast<unsigned>(m[(b >> 5) * TILE + j]) >> (b & 31)) & 1u) != 0u;
}

// Triangles tested per step of the inner loop: each step reads NV
// consecutive lanes of every coefficient row with one vector load (a
// broadcast: every thread of the warp reads the same address) and runs NV
// independent ray-triangle tests, which the scheduler can overlap.
constexpr int NV = 4;

template <int N>
__device__ __forceinline__ void load_lanes(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

// One step's coefficients (c: the NV lanes of each of the 12 rows) and,
// with a common origin or direction, the tile-shared dot products (f).
template <int COMMON>
__device__ __forceinline__ void load_step(const float* coef, const float* fam, int j0,
                                          float (&c)[CROWS][NV], float (&f)[3][NV]) {
#pragma unroll
  for (int r = 0; r < CROWS; ++r) load_lanes<NV>(coef + r * TILE + j0, c[r]);
  if (COMMON != COMMON_NONE) {
#pragma unroll
    for (int k = 0; k < 3; ++k) load_lanes<NV>(fam + k * TILE + j0, f[k]);
  }
}

// Lane i of a step: the ray's t and barycentrics (u, v) on the triangle,
// and whether it is hit in [tmin, limit].
template <int COMMON>
__device__ __forceinline__ bool pair_test(const float (&c)[CROWS][NV], const float (&f)[3][NV],
                                          int i, const float (&o)[3], const float (&d)[3],
                                          float tmin, float limit, float& t, float& u,
                                          float& v) {
  float s0, ou, ov, s1, du, dv;
  if (COMMON == COMMON_ORIGIN) {
    s0 = f[0][i];
    ou = f[1][i];
    ov = f[2][i];
  } else {
    s0 = ((o[0] * c[0][i] + o[1] * c[1][i]) + o[2] * c[2][i]) + c[3][i];
    ou = ((o[0] * c[4][i] + o[1] * c[5][i]) + o[2] * c[6][i]) + c[7][i];
    ov = ((o[0] * c[8][i] + o[1] * c[9][i]) + o[2] * c[10][i]) + c[11][i];
  }
  if (COMMON == COMMON_DIR) {
    s1 = f[0][i];
    du = f[1][i];
    dv = f[2][i];
  } else {
    s1 = (d[0] * c[0][i] + d[1] * c[1][i]) + d[2] * c[2][i];
    du = (d[0] * c[4][i] + d[1] * c[5][i]) + d[2] * c[6][i];
    dv = (d[0] * c[8][i] + d[1] * c[9][i]) + d[2] * c[10][i];
  }
  const bool den_ok = fabsf(s1) > EPS;
  t = den_ok ? (-s0) / s1 : BIG;
  u = ou + t * du;
  v = ov + t * dv;
  return den_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin && t <= limit;
}

// The least packed (quantized t | lane) key of one ray over a staged
// 128-triangle tile (coef: 12 x 128; fam: the tile-shared dot products of
// a common origin or direction; smask: the two mask rows), KEY_PAD if no
// triangle is hit in [tmin, limit].
template <int COMMON, bool MASK>
__device__ __forceinline__ int closest_key(const float* coef, const float* fam,
                                           const int* smask, const float (&o)[3],
                                           const float (&d)[3], float tmin, float limit) {
  int kbest = KEY_PAD;
  for (int j0 = 0; j0 < TILE; j0 += NV) {
    float c[CROWS][NV], f[3][NV];
    load_step<COMMON>(coef, fam, j0, c, f);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float t, u, v;
      bool ok = pair_test<COMMON>(c, f, i, o, d, tmin, limit, t, u, v);
      if (MASK && ok) ok = mask_bit(smask, j0 + i, u, v);
      // Packed (t | lane) key: nearest quantized t, then the lowest lane.
      const float tm = ok ? t : __int_as_float(INVALID);
      kbest = min(kbest, (__float_as_int(tm) & ~127) | (j0 + i));
    }
  }
  return kbest;
}

// 16 bytes from global to shared memory, asynchronously; fill = false
// writes 16 zero bytes instead (the source is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(fill ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Interval product [a_lo, a_hi] x [b_lo, b_hi] (_sub_entries' `times`).
__device__ __forceinline__ void times(float a_lo, float a_hi, float b_lo, float b_hi,
                                      float& lo, float& hi) {
  const float p1 = a_lo * b_lo, p2 = a_lo * b_hi;
  const float p3 = a_hi * b_lo, p4 = a_hi * b_hi;
  lo = fminf(fminf(p1, p2), fminf(p3, p4));
  hi = fmaxf(fmaxf(p1, p2), fmaxf(p3, p4));
}

// The tile bundle: origin box, inverse direction interval per axis, least
// t_min and greatest t_max.
struct Bundle {
  float o_lo[3], o_hi[3], inv_lo[3], inv_hi[3], tmin_lb, tmax_ub;
};

// Entry bound of subcluster box c for the bundle (_sub_entries): max(entry,
// 0) where the box may be hit, +inf elsewhere.
__device__ __forceinline__ float sub_entry(const Bundle& b, const float* __restrict__ cl_min,
                                           const float* __restrict__ cl_max, int c) {
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float bmin = cl_min[c * 3 + a], bmax = cl_max[c * 3 + a];
    float t0l, t0h, t1l, t1h;
    times(bmin - b.o_hi[a], bmin - b.o_lo[a], b.inv_lo[a], b.inv_hi[a], t0l, t0h);
    times(bmax - b.o_hi[a], bmax - b.o_lo[a], b.inv_lo[a], b.inv_hi[a], t1l, t1h);
    const float lo_a = fminf(t0l, t1l);
    const float hi_a = fmaxf(t0h, t1h);
    tn = a == 0 ? lo_a : fmaxf(tn, lo_a);
    tf = a == 0 ? hi_a : fminf(tf, hi_a);
  }
  const bool possible = tn <= tf && tf >= b.tmin_lb && tn <= b.tmax_ub;
  return possible ? fmaxf(tn, 0.0f) : __int_as_float(INVALID);
}

// _pack_id_keys: entry bits with the id bits cleared (rounded down, still a
// lower bound), or'ed with block id `blk`; INVALID for an infinite entry.
__device__ __forceinline__ int pack_key(float ent, int blk, int id_mask) {
  if (!isfinite(ent)) return INVALID;
  return (__float_as_int(ent) & ~id_mask) | blk;
}

// Reduces the tile's rays to its bundle: every thread of the CTA calls it
// (it holds a barrier) and gets the same bundle.  Pad lanes are included,
// as _pack_rays pads them.
__device__ __forceinline__ Bundle reduce_bundle(const float (&o)[3], const float (&d)[3],
                                                float tmin, float tmax, float (*red)[14]) {
  float v[14];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v[a] = o[a];
    v[3 + a] = o[a];
    v[6 + a] = d[a];
    v[9 + a] = d[a];
  }
  v[12] = tmin;
  v[13] = tmax;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 14; ++i) {
      const float x = __shfl_xor_sync(FULL, v[i], off);
      const bool is_min = i < 3 || (i >= 6 && i < 9) || i == 12;
      v[i] = is_min ? fminf(v[i], x) : fmaxf(v[i], x);
    }
  }
  const int w = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < 14; ++i) red[w][i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 14; ++i) {
    const bool is_min = i < 3 || (i >= 6 && i < 9) || i == 12;
    float x = red[0][i];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) x = is_min ? fminf(x, red[k][i]) : fmaxf(x, red[k][i]);
    v[i] = x;
  }
  Bundle b;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.o_lo[a] = v[a];
    b.o_hi[a] = v[3 + a];
    const float d_lo = v[6 + a], d_hi = v[9 + a];
    const bool span = d_lo > EPS || d_hi < -EPS;                 // sign-definite
    const float safe_hi = fabsf(d_hi) > EPS ? d_hi : EPS;
    const float safe_lo = fabsf(d_lo) > EPS ? d_lo : EPS;
    b.inv_lo[a] = span ? 1.0f / safe_hi : -BIG;
    b.inv_hi[a] = span ? 1.0f / safe_lo : BIG;
  }
  b.tmin_lb = v[12];
  b.tmax_ub = v[13];
  return b;
}

}  // namespace
