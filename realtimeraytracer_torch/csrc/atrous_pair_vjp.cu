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
// and K_k = K_-k, so a_xy = a_yx and one weight evaluation serves both
// roles.  For upstream gradients g of both outputs and G_y = g_y / W_y,
// the thread of pixel x sums over its neighbours y, per image:
//   direct:  gc[x] += a_xy G_y
//   weight:  E = (G_x.(c[y] - o[x]) + G_y.(c[x] - o[y])) a_xy,
//            gc[x] += E (-2 inv_c) (c[x] - c[y])
// and, summed over the two images (the normal and position weights are
// shared), when the geometry gradients are asked for:
//   gn[x] += sum E (-2 inv_step2 inv_n) (n[x] - n[y])
//   gp[x] += sum E (-2 inv_p) (p[x] - p[y])
// The differences c[y] - o[x] and c[x] - o[y] are taken as differences
// (never as G.c - G.o, which cancels where the image is smooth).  Each
// exponent is below or at 0, so min(exp(.), 1) is exp(.) but at a tie
// (exp == 1.0), where its derivative is taken as exp's own, as
// torch.clamp_max passes it; there the squared difference is under about
// 6e-8 phi and the term tiny.  So a_xy is evaluated as one exp of the
// summed exponents per image: K exp(-(|dc|^2 inv_c + |dn|^2 inv_step2
// inv_n + |dp|^2 inv_p)), two expf a tap where the forward takes four.
//
// W comes from the forward: under autograd the B5 kernel writes each
// pixel's weight sums of both images (its `wsum` output), so no launch
// recomputes them.
//
// Design.  A CTA (32 x 8 threads, one output pixel each) covers 32
// columns by 8 rows of one row residue class: rows y_first + j step, j <
// 8.  There the dilated 5x5 stencil is dense in rows, so 12 staged rows
// serve the tile at any step.  Columns are one contiguous segment of 32 +
// 4 step pixels for step <= 8; above, one column residue class as well
// (36 staged columns).  The CTA first stages, per staged pixel, every
// operand its taps read, derived once: c, o and G = g / W of both images
// (one reciprocal a pixel and image, no division a tap) and n, p; 24
// floats in six float4 planes of shared memory, so a tap is six
// conflict-free 16-byte shared loads.  Then each thread sums its 25 taps
// from shared memory.  The loads of one CTA overlap the taps of the CTAs
// resident beside it (the register cap of __launch_bounds__ sets how
// many fit an SM: three with the geometry gradients, four without).
//
// What bounds it: instruction issue.  A tap is about 118 f32 operations
// with geometry gradients and 105 without, counted with an exp as one
// and a fused multiply-add as two (PERF.md); the fused multiply-adds are
// written out (fmaf), as -fmad=false forbids contracting them.  Memory is
// 104 bytes a pixel read (eight images and the two weight sums) and 48 or
// 24 written.
//
// Numerics: expf (never __expf, no --use_fast_math), built with
// -fmad=false; the sums run in another order than autograd's through the
// plain twin, so the two agree to float32 rounding, not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;          // output columns per CTA (a warp across)
constexpr int TH = 8;           // output rows per CTA (warps per CTA)
constexpr int NT = TW * TH;     // threads per CTA
constexpr int SR = TH + 4;      // staged rows
constexpr int KMAX = 8;         // contiguous column segments up to this step
// Resident CTAs an SM that the register cap aims at, with and without the
// geometry gradients (79 and 64 registers, no spill; PERF.md).
constexpr int MIN_BLOCKS_GEOM = 3;
constexpr int MIN_BLOCKS_COLOUR = 4;

__constant__ float KERNEL5[25] = {
    1, 4, 7, 4, 1,  4, 16, 26, 16, 4,  7, 26, 41, 26, 7,
    4, 16, 26, 16, 4,  1, 4, 7, 4, 1};

// The staged columns of a launch: staged column i lies at global column
// cbase + i * cstep; tap kx of the pixel in staged column i0 + 2 kstep
// lies in staged column i0 + kx * kstep.
struct Columns {
  int cstep, kstep, width;
};

__host__ __device__ inline Columns columns(int step) {
  Columns c;
  c.cstep = step <= KMAX ? 1 : step;
  c.kstep = step <= KMAX ? step : 1;
  c.width = TW + 4 * c.kstep;
  return c;
}

struct Consts {
  float neg_inv_c, neg_inv_np, neg_inv_p;   // the exponents' factors
  float c_fac, n_fac, p_fac;                // -2 inv_c, -2 inv_step2 inv_n, -2 inv_p
};

// A staged pixel: colour, output and G = g / W of both images, normal,
// position.
struct Pixel {
  float3 cs, cu, n, p, os, ou, gs, gu;
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

__device__ __forceinline__ float3 scale3(float3 a, float s) {
  return make_float3(a.x * s, a.y * s, a.z * s);
}

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x));
}

// acc + s v
__device__ __forceinline__ float3 fma3(float s, float3 v, float3 acc) {
  return make_float3(fmaf(s, v.x, acc.x), fmaf(s, v.y, acc.y), fmaf(s, v.z, acc.z));
}

// Six float4 planes of ns pixels each.
__device__ __forceinline__ void store_pixel(float4* stage, int ns, int i, const Pixel& q) {
  stage[i] = make_float4(q.cs.x, q.cs.y, q.cs.z, q.cu.x);
  stage[ns + i] = make_float4(q.cu.y, q.cu.z, q.n.x, q.n.y);
  stage[2 * ns + i] = make_float4(q.n.z, q.p.x, q.p.y, q.p.z);
  stage[3 * ns + i] = make_float4(q.os.x, q.os.y, q.os.z, q.ou.x);
  stage[4 * ns + i] = make_float4(q.ou.y, q.ou.z, q.gs.x, q.gs.y);
  stage[5 * ns + i] = make_float4(q.gs.z, q.gu.x, q.gu.y, q.gu.z);
}

__device__ __forceinline__ Pixel load_pixel(const float4* stage, int ns, int i) {
  const float4 a = stage[i], b = stage[ns + i], c = stage[2 * ns + i];
  const float4 d = stage[3 * ns + i], e = stage[4 * ns + i], f = stage[5 * ns + i];
  Pixel q;
  q.cs = make_float3(a.x, a.y, a.z);
  q.cu = make_float3(a.w, b.x, b.y);
  q.n = make_float3(b.z, b.w, c.x);
  q.p = make_float3(c.y, c.z, c.w);
  q.os = make_float3(d.x, d.y, d.z);
  q.ou = make_float3(d.w, e.x, e.y);
  q.gs = make_float3(e.z, e.w, f.x);
  q.gu = make_float3(f.y, f.z, f.w);
  return q;
}

// One CTA: stage its pixels' operands, then each thread gathers its pixel.
// GEOM: also the normal and position gradients.
template <bool GEOM>
__global__ void __launch_bounds__(NT, GEOM ? MIN_BLOCKS_GEOM : MIN_BLOCKS_COLOUR)
atrous_pair_vjp_kernel(
    const float* __restrict__ s_in, const float* __restrict__ u_in,
    const float* __restrict__ nrm, const float* __restrict__ pos,
    const float* __restrict__ s_out, const float* __restrict__ u_out,
    const float* __restrict__ g_s, const float* __restrict__ g_u,
    const float* __restrict__ wsum, float* __restrict__ gs_out,
    float* __restrict__ gu_out, float* __restrict__ gn_out, float* __restrict__ gp_out,
    int h, int w, int step, int col_residues, int row_residues, Consts k) {
  extern __shared__ float4 stage[];   // 6 planes x SR x width
  const Columns cl = columns(step);
  const int ns = SR * cl.width;
  const int cbase = cl.cstep == 1
      ? (int)blockIdx.x * TW - 2 * step
      : ((int)blockIdx.x / col_residues) * TW * step + (int)blockIdx.x % col_residues - 2 * step;
  const int y_first = ((int)blockIdx.y / row_residues) * TH * step + (int)blockIdx.y % row_residues;
  const size_t hw = (size_t)h * w;

  for (int i = threadIdx.y * TW + threadIdx.x; i < ns; i += NT) {
    const int gy = y_first + (i / cl.width - 2) * step;
    const int gx = cbase + (i % cl.width) * cl.cstep;
    if (gy < 0 || gy >= h || gx < 0 || gx >= w) continue;
    const size_t q = (size_t)gy * w + gx;
    Pixel px;
    px.cs = ld3(s_in, q);
    px.cu = ld3(u_in, q);
    px.n = ld3(nrm, q);
    px.p = ld3(pos, q);
    px.os = ld3(s_out, q);
    px.ou = ld3(u_out, q);
    px.gs = scale3(ld3(g_s, q), __frcp_rn(fmaxf(wsum[q], 1e-5f)));
    px.gu = scale3(ld3(g_u, q), __frcp_rn(fmaxf(wsum[hw + q], 1e-5f)));
    store_pixel(stage, ns, i, px);
  }
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int y = y_first + ty * step;
  const int x = cbase + (tx + 2 * cl.kstep) * cl.cstep;
  if (y >= h || x >= w) return;
  const Pixel me = load_pixel(stage, ns, (ty + 2) * cl.width + tx + 2 * cl.kstep);
  float3 acc_s = make_float3(0.0f, 0.0f, 0.0f), acc_u = acc_s, acc_n = acc_s, acc_p = acc_s;
#pragma unroll 1
  for (int ky = 0; ky < 5; ++ky) {
    const int yy = y + (ky - 2) * step;
    if (yy < 0 || yy >= h) continue;
    const int row = (ty + ky) * cl.width + tx;
#pragma unroll
    for (int kx = 0; kx < 5; ++kx) {
      const int xx = x + (kx - 2) * step;
      if (xx < 0 || xx >= w) continue;
      const Pixel o = load_pixel(stage, ns, row + kx * cl.kstep);
      const float3 dcs = sub3(me.cs, o.cs), dcu = sub3(me.cu, o.cu);
      const float3 dn = sub3(me.n, o.n), dp = sub3(me.p, o.p);
      const float t = fmaf(dot3(dp, dp), k.neg_inv_p, dot3(dn, dn) * k.neg_inv_np);
      const float kern = KERNEL5[ky * 5 + kx];
      const float a_s = kern * expf(fmaf(dot3(dcs, dcs), k.neg_inv_c, t));
      const float a_u = kern * expf(fmaf(dot3(dcu, dcu), k.neg_inv_c, t));
      // Shadowed.
      const float e_s = (dot3(me.gs, sub3(o.cs, me.os)) + dot3(o.gs, sub3(me.cs, o.os))) * a_s;
      acc_s = fma3(a_s, o.gs, acc_s);
      acc_s = fma3(e_s * k.c_fac, dcs, acc_s);
      // Unshadowed.
      const float e_u = (dot3(me.gu, sub3(o.cu, me.ou)) + dot3(o.gu, sub3(me.cu, o.ou))) * a_u;
      acc_u = fma3(a_u, o.gu, acc_u);
      acc_u = fma3(e_u * k.c_fac, dcu, acc_u);
      if (GEOM) {
        const float e = e_s + e_u;
        acc_n = fma3(e, dn, acc_n);
        acc_p = fma3(e, dp, acc_p);
      }
    }
  }
  const size_t i = (size_t)y * w + x;
  st3(gs_out, i, acc_s);
  st3(gu_out, i, acc_u);
  if (GEOM) {
    st3(gn_out, i, scale3(acc_n, k.n_fac));
    st3(gp_out, i, scale3(acc_p, k.p_fac));
  }
}

template <bool GEOM>
cudaError_t launch(const float* const* in, float* gs, float* gu, float* gn, float* gp, int h,
                   int w, int step, const Consts& k, cudaStream_t st) {
  const Columns cl = columns(step);
  const size_t smem = (size_t)6 * SR * cl.width * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        atrous_pair_vjp_kernel<GEOM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  // Column tiles (each split into its residues above KMAX) and row groups
  // of TH x step rows split into their residues (only residues inside the
  // image hold a pixel).
  const int col_residues = cl.cstep == 1 ? 1 : (step < w ? step : w);
  const int row_residues = step < h ? step : h;
  const dim3 grid((w + TW * cl.cstep - 1) / (TW * cl.cstep) * col_residues,
                  (h + TH * step - 1) / (TH * step) * row_residues);
  atrous_pair_vjp_kernel<GEOM><<<grid, dim3(TW, TH), smem, st>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], gs, gu, gn, gp, h, w, step,
      col_residues, row_residues, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The VJP of one iteration at dilation `step` (>= 1) on `stream`: inputs
// s_in, u_in, nrm, pos (the iteration's), s_out, u_out (its outputs) and
// g_s, g_u (their upstream gradients), each (h, w, 3) f32 contiguous, and
// wsum, the forward's weight sums (2, h, w) f32; gs, gu receive the colour
// gradients and gn, gp the normal and position gradients (both null: not
// computed).  inv_c, inv_n, inv_p are the float reciprocals of the three
// phi's.  Returns cudaGetLastError() after the launch (0 = launched), the
// error of the shared-memory opt-in, or cudaErrorInvalidValue for step < 1
// or only one of gn, gp given.
int rt_atrous_pair_vjp(const void* s_in, const void* u_in, const void* nrm,
                       const void* pos, const void* s_out, const void* u_out,
                       const void* g_s, const void* g_u, const void* wsum, void* gs,
                       void* gu, void* gn, void* gp, int h, int w, int step,
                       float inv_step2, float inv_c, float inv_n, float inv_p,
                       void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (step < 1 || (gn == nullptr) != (gp == nullptr)) return (int)cudaErrorInvalidValue;
  const Consts k{-inv_c, -(inv_step2 * inv_n), -inv_p,
                 -2.0f * inv_c, -2.0f * inv_step2 * inv_n, -2.0f * inv_p};
  const float* in[9] = {(const float*)s_in, (const float*)u_in, (const float*)nrm,
                        (const float*)pos, (const float*)s_out, (const float*)u_out,
                        (const float*)g_s, (const float*)g_u, (const float*)wsum};
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = gn != nullptr
      ? launch<true>(in, (float*)gs, (float*)gu, (float*)gn, (float*)gp, h, w, step, k, st)
      : launch<false>(in, (float*)gs, (float*)gu, nullptr, nullptr, h, w, step, k, st);
  return (int)e;
}

const char* rt_atrous_pair_vjp_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
