// The vector-Jacobian product of one A-Trous pair iteration (B5b), written
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates no Pallas kernel,
// and under AD its denoise dispatch runs the per-image XLA stencil
// (realtimeraytracer_tpu/ops/denoise.py:46-81, chosen in
// render/pipeline.py:50-92).  The port keeps the fused pair of
// csrc/atrous_pair.cu under AD, and this is that iteration's backward.
//
// The forward, per image c (shadowed, unshadowed), pixel x and its taps
// y = x + step * o_k, o_k in {-2..2}^2, in bounds:
//   a_xy = K_k * w_c(c_x, c_y) * w_n(n_x, n_y) * w_p(p_x, p_y)
//   o_x  = sum_y a_xy c_y / W_x,   W_x = sum_y a_xy
// with the weights of atrous_pair.cu (min(exp(-|d|^2 * inv), 1), the phi's
// reciprocals, the normal term scaled by inv_step2).  max(W, 1e-5) never
// binds (the centre tap alone gives W >= 41).  The offsets are symmetric
// and K_k = K_-k, so a_xy = a_yx (the squared differences are the same
// floats either way round) and one weight evaluation serves both roles.
// For upstream gradients g of both outputs, the thread of pixel x sums
// over its neighbours y, per image:
//   direct:  gc[x] += a_xy g[y] / W[y]
//   weight:  e_xy = g[x].(c[y] - o[x]) / W[x],  e_yx = g[y].(c[x] - o[y]) / W[y]
//            E = (e_xy + e_yx) a_xy,  gc[x] += E (-2 inv_c) (c[x] - c[y])
// and, summed over the two images (the normal and position weights are
// shared), when the geometry gradients are asked for:
//   gn[x] += sum E (-2 inv_step2 inv_n) (n[x] - n[y])
//   gp[x] += sum E (-2 inv_p) (p[x] - p[y])
// The derivative of min(exp(.), 1) is taken as exp's own at a tie (exp ==
// 1.0), as torch.clamp_max passes it; there the squared difference is
// under about 6e-8 phi and the term tiny.
//
// Design: two grid launches on the stream.  The first recomputes W of both
// images per pixel (the forward's sum, in its (ky, kx) order, so it equals
// the forward's W bit for bit); the second is the gather above, one thread
// a pixel, every operand loaded from global memory (L1 and L2 serve the
// neighbours' reloads).  No atomics: each thread writes its own pixel.
//
// What bounds it: instruction issue.  A tap costs the forward's four
// weights (four squared distances, four expf) plus about 100 f32
// operations of products and sums, and the weight pass repeats the weights;
// memory is 144 bytes a pixel (eight images read, four written).  A later
// PR may stage the tiles in shared memory as the forward does.
//
// Numerics: expf (never __expf, no --use_fast_math), built with
// -fmad=false; the sums run in another order than autograd's through the
// plain twin, so the two agree to float32 rounding, not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;   // threads per CTA across (a warp along a row)
constexpr int BY = 8;    // rows per CTA

__constant__ float KERNEL5[25] = {
    1, 4, 7, 4, 1,  4, 16, 26, 16, 4,  7, 26, 41, 26, 7,
    4, 16, 26, 16, 4,  1, 4, 7, 4, 1};

struct Weights {
  float inv_step2, inv_c, inv_n, inv_p;
};

__device__ __forceinline__ float3 ld3(const float* __restrict__ a, size_t i) {
  return make_float3(a[3 * i], a[3 * i + 1], a[3 * i + 2]);
}

__device__ __forceinline__ void st3(float* __restrict__ a, size_t i, float3 v) {
  a[3 * i] = v.x;
  a[3 * i + 1] = v.y;
  a[3 * i + 2] = v.z;
}

__device__ __forceinline__ float3 sub3(float3 a, float3 b) {
  return make_float3(a.x - b.x, a.y - b.y, a.z - b.z);
}

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

// The forward's squared distance: (d0 d0 + d1 d1) + d2 d2 with d = a - b.
__device__ __forceinline__ float sq3(float3 a, float3 b) {
  const float d0 = a.x - b.x, d1 = a.y - b.y, d2 = a.z - b.z;
  return (d0 * d0 + d1 * d1) + d2 * d2;
}

// acc += s * v
__device__ __forceinline__ void axpy3(float3& acc, float s, float3 v) {
  acc.x = acc.x + s * v.x;
  acc.y = acc.y + s * v.y;
  acc.z = acc.z + s * v.z;
}

// The shared normal-position weight times the kernel weight, and the two
// images' colour weights, of the pair (x, y); the forward's expressions.
struct PairWeights {
  float a_s, a_u;
};

__device__ __forceinline__ PairWeights pair_weights(
    const Weights& k, float kern, float3 cs_x, float3 cs_y, float3 cu_x, float3 cu_y,
    float3 n_x, float3 n_y, float3 p_x, float3 p_y) {
  const float w_cs = fminf(expf(-sq3(cs_x, cs_y) * k.inv_c), 1.0f);
  const float w_cu = fminf(expf(-sq3(cu_x, cu_y) * k.inv_c), 1.0f);
  const float w_n = fminf(expf(-(sq3(n_x, n_y) * k.inv_step2) * k.inv_n), 1.0f);
  const float w_p = fminf(expf(-sq3(p_x, p_y) * k.inv_p), 1.0f);
  const float wnp = (w_n * w_p) * kern;
  return {w_cs * wnp, w_cu * wnp};
}

// Pass 1: W of both images at every pixel, wsum = [W_s (h, w) | W_u (h, w)].
__global__ void __launch_bounds__(BX * BY) atrous_weight_sum_kernel(
    const float* __restrict__ s_in, const float* __restrict__ u_in,
    const float* __restrict__ nrm, const float* __restrict__ pos,
    float* __restrict__ wsum, int h, int w, int step, Weights k) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t i = (size_t)y * w + x;
  const float3 cs = ld3(s_in, i), cu = ld3(u_in, i), n = ld3(nrm, i), p = ld3(pos, i);
  float cum_s = 0.0f, cum_u = 0.0f;
  for (int ky = 0; ky < 5; ++ky) {
    const int yy = y + (ky - 2) * step;
    if (yy < 0 || yy >= h) continue;
#pragma unroll 1
    for (int kx = 0; kx < 5; ++kx) {
      const int xx = x + (kx - 2) * step;
      if (xx < 0 || xx >= w) continue;
      const size_t j = (size_t)yy * w + xx;
      const PairWeights a = pair_weights(k, KERNEL5[ky * 5 + kx], cs, ld3(s_in, j), cu,
                                         ld3(u_in, j), n, ld3(nrm, j), p, ld3(pos, j));
      cum_s = cum_s + a.a_s;
      cum_u = cum_u + a.a_u;
    }
  }
  wsum[i] = cum_s;
  wsum[(size_t)h * w + i] = cum_u;
}

// Pass 2: the gather, one thread a pixel.  GEOM: also the normal and
// position gradients.
template <bool GEOM>
__global__ void __launch_bounds__(BX * BY) atrous_pair_vjp_kernel(
    const float* __restrict__ s_in, const float* __restrict__ u_in,
    const float* __restrict__ nrm, const float* __restrict__ pos,
    const float* __restrict__ s_out, const float* __restrict__ u_out,
    const float* __restrict__ g_s, const float* __restrict__ g_u,
    const float* __restrict__ wsum, float* __restrict__ gs_out,
    float* __restrict__ gu_out, float* __restrict__ gn_out, float* __restrict__ gp_out,
    int h, int w, int step, Weights k) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t hw = (size_t)h * w;
  const size_t i = (size_t)y * w + x;
  const float3 cs = ld3(s_in, i), cu = ld3(u_in, i), n = ld3(nrm, i), p = ld3(pos, i);
  const float3 os = ld3(s_out, i), ou = ld3(u_out, i);
  const float3 gs = ld3(g_s, i), gu = ld3(g_u, i);
  const float ws = wsum[i], wu = wsum[hw + i];
  const float c_fac = -2.0f * k.inv_c;
  const float n_fac = -2.0f * k.inv_step2 * k.inv_n;
  const float p_fac = -2.0f * k.inv_p;
  float3 dcs = make_float3(0.0f, 0.0f, 0.0f), dcu = dcs, dn = dcs, dp = dcs;
  for (int ky = 0; ky < 5; ++ky) {
    const int yy = y + (ky - 2) * step;
    if (yy < 0 || yy >= h) continue;
#pragma unroll 1
    for (int kx = 0; kx < 5; ++kx) {
      const int xx = x + (kx - 2) * step;
      if (xx < 0 || xx >= w) continue;
      const size_t j = (size_t)yy * w + xx;
      const float3 cs_y = ld3(s_in, j), cu_y = ld3(u_in, j);
      const float3 n_y = ld3(nrm, j), p_y = ld3(pos, j);
      const PairWeights a = pair_weights(k, KERNEL5[ky * 5 + kx], cs, cs_y, cu, cu_y, n,
                                         n_y, p, p_y);
      const float ws_y = wsum[j], wu_y = wsum[hw + j];
      const float3 gs_y = ld3(g_s, j), gu_y = ld3(g_u, j);
      // Shadowed.
      const float es = (dot3(gs, sub3(cs_y, os)) / ws
                        + dot3(gs_y, sub3(cs, ld3(s_out, j))) / ws_y) * a.a_s;
      axpy3(dcs, a.a_s / ws_y, gs_y);
      axpy3(dcs, es * c_fac, sub3(cs, cs_y));
      // Unshadowed.
      const float eu = (dot3(gu, sub3(cu_y, ou)) / wu
                        + dot3(gu_y, sub3(cu, ld3(u_out, j))) / wu_y) * a.a_u;
      axpy3(dcu, a.a_u / wu_y, gu_y);
      axpy3(dcu, eu * c_fac, sub3(cu, cu_y));
      if (GEOM) {
        const float e = es + eu;
        axpy3(dn, e * n_fac, sub3(n, n_y));
        axpy3(dp, e * p_fac, sub3(p, p_y));
      }
    }
  }
  st3(gs_out, i, dcs);
  st3(gu_out, i, dcu);
  if (GEOM) {
    st3(gn_out, i, dn);
    st3(gp_out, i, dp);
  }
}

}  // namespace

extern "C" {

// The VJP of one iteration at dilation `step` (>= 1) on `stream`: inputs
// s_in, u_in, nrm, pos (the iteration's), s_out, u_out (its outputs) and
// g_s, g_u (their upstream gradients), each (h, w, 3) f32 contiguous;
// wsum is (2, h, w) f32 scratch; gs, gu receive the colour gradients and
// gn, gp the normal and position gradients (both null: not computed).
// inv_c, inv_n, inv_p are the float reciprocals of the three phi's.
// Returns cudaGetLastError() after the two launches (0 = launched), or
// cudaErrorInvalidValue for step < 1 or only one of gn, gp given.
int rt_atrous_pair_vjp(const void* s_in, const void* u_in, const void* nrm,
                       const void* pos, const void* s_out, const void* u_out,
                       const void* g_s, const void* g_u, void* wsum, void* gs,
                       void* gu, void* gn, void* gp, int h, int w, int step,
                       float inv_step2, float inv_c, float inv_n, float inv_p,
                       void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (step < 1 || (gn == nullptr) != (gp == nullptr)) return (int)cudaErrorInvalidValue;
  const Weights k{inv_step2, inv_c, inv_n, inv_p};
  const dim3 block(BX, BY);
  const dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY);
  cudaStream_t st = (cudaStream_t)stream;
  atrous_weight_sum_kernel<<<grid, block, 0, st>>>(
      (const float*)s_in, (const float*)u_in, (const float*)nrm, (const float*)pos,
      (float*)wsum, h, w, step, k);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (gn != nullptr) {
    atrous_pair_vjp_kernel<true><<<grid, block, 0, st>>>(
        (const float*)s_in, (const float*)u_in, (const float*)nrm, (const float*)pos,
        (const float*)s_out, (const float*)u_out, (const float*)g_s, (const float*)g_u,
        (const float*)wsum, (float*)gs, (float*)gu, (float*)gn, (float*)gp, h, w, step, k);
  } else {
    atrous_pair_vjp_kernel<false><<<grid, block, 0, st>>>(
        (const float*)s_in, (const float*)u_in, (const float*)nrm, (const float*)pos,
        (const float*)s_out, (const float*)u_out, (const float*)g_s, (const float*)g_u,
        (const float*)wsum, (float*)gs, (float*)gu, nullptr, nullptr, h, w, step, k);
  }
  return (int)cudaGetLastError();
}

const char* rt_atrous_pair_vjp_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
