// One edge-avoiding A-Trous iteration over BOTH stochastic images, written
// for Hopper (sm_90a).
//
// Replaces realtimeraytracer_tpu/ops/denoise_pallas.py::atrous_denoise_pair
// (launcher _atrous_pair_iteration, kernel body _iter_kernel).  Inputs and
// outputs are (H, W, 3) f32 images, contiguous: the shadowed and unshadowed
// colour images, the normal and position G-buffer.  One thread per output
// pixel evaluates the 25 taps of the 5x5 kernel dilated by `step`, with one
// colour edge-stopping weight per image and the normal and position weights
// (times the kernel weight) shared by both, in the TPU kernel's term order:
//   w_c = min(exp(-|dc|^2 / c_phi), 1)
//   w_n = min(exp(-(|dn|^2 * inv_step2) / n_phi), 1)
//   w_p = min(exp(-|dp|^2 / p_phi), 1)
//   wnp = (w_n * w_p) * k;  w = w_c * wnp;  acc += c_tap * w;  cum += w
//   out = acc / max(cum, 1e-5)
// Out-of-bounds taps are skipped by a bounds test, which is what a weight of
// exactly 0 contributes in the reference.
//
// What bounds it: bytes per tap.  Each tap reads 12 floats (48 bytes) of
// which neighbouring threads share most through L1/L2; 25 taps and 4 exps
// per tap per pixel.  One pass produces both images, so the normal and
// position planes and their weights are read and computed once, not twice.
//
// Numerics: expf (never __expf, and no --use_fast_math), built with
// -fmad=false so the products and sums round as the PyTorch twin's do.
#include <cuda_runtime.h>

namespace {

__device__ const float KERNEL5[25] = {
    1, 4, 7, 4, 1,  4, 16, 26, 16, 4,  7, 26, 41, 26, 7,
    4, 16, 26, 16, 4,  1, 4, 7, 4, 1};

__device__ __forceinline__ float sq3(const float* a, const float* b) {
  const float d0 = a[0] - b[0];
  const float d1 = a[1] - b[1];
  const float d2 = a[2] - b[2];
  return (d0 * d0 + d1 * d1) + d2 * d2;
}

__device__ __forceinline__ void load3(const float* p, size_t i, float* v) {
  v[0] = p[i];
  v[1] = p[i + 1];
  v[2] = p[i + 2];
}

__global__ void atrous_pair_kernel(
    const float* __restrict__ s_in, const float* __restrict__ u_in,
    const float* __restrict__ nrm, const float* __restrict__ pos,
    float* __restrict__ s_out, float* __restrict__ u_out, int h, int w,
    int step, float inv_step2, float c_phi, float n_phi, float p_phi) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t o = ((size_t)y * w + x) * 3;
  float cs[3], cu[3], cn[3], cp[3];
  load3(s_in, o, cs);
  load3(u_in, o, cu);
  load3(nrm, o, cn);
  load3(pos, o, cp);

  float acc_s[3] = {0.0f, 0.0f, 0.0f};
  float acc_u[3] = {0.0f, 0.0f, 0.0f};
  float cum_s = 0.0f, cum_u = 0.0f;
#pragma unroll
  for (int ky = 0; ky < 5; ++ky) {
    const int yy = y + (ky - 2) * step;
    if (yy < 0 || yy >= h) continue;
#pragma unroll
    for (int kx = 0; kx < 5; ++kx) {
      const int xx = x + (kx - 2) * step;
      if (xx < 0 || xx >= w) continue;
      const size_t q = ((size_t)yy * w + xx) * 3;
      float qs[3], qu[3], qn[3], qp[3];
      load3(s_in, q, qs);
      load3(u_in, q, qu);
      load3(nrm, q, qn);
      load3(pos, q, qp);
      const float w_cs = fminf(expf(-sq3(cs, qs) / c_phi), 1.0f);
      const float w_cu = fminf(expf(-sq3(cu, qu) / c_phi), 1.0f);
      const float w_n = fminf(expf(-(sq3(cn, qn) * inv_step2) / n_phi), 1.0f);
      const float w_p = fminf(expf(-sq3(cp, qp) / p_phi), 1.0f);
      const float wnp = (w_n * w_p) * KERNEL5[ky * 5 + kx];
      const float ws = w_cs * wnp;
      const float wu = w_cu * wnp;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        acc_s[c] = acc_s[c] + qs[c] * ws;
        acc_u[c] = acc_u[c] + qu[c] * wu;
      }
      cum_s = cum_s + ws;
      cum_u = cum_u + wu;
    }
  }
  const float den_s = fmaxf(cum_s, 1e-5f);
  const float den_u = fmaxf(cum_u, 1e-5f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s_out[o + c] = acc_s[c] / den_s;
    u_out[o + c] = acc_u[c] / den_u;
  }
}

}  // namespace

extern "C" {

// One iteration at dilation `step` on `stream`; returns cudaGetLastError().
int rt_atrous_pair(const void* s_in, const void* u_in, const void* nrm,
                   const void* pos, void* s_out, void* u_out, int h, int w,
                   int step, float inv_step2, float c_phi, float n_phi,
                   float p_phi, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  atrous_pair_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)s_in, (const float*)u_in, (const float*)nrm,
      (const float*)pos, (float*)s_out, (float*)u_out, h, w, step, inv_step2,
      c_phi, n_phi, p_phi);
  return (int)cudaGetLastError();
}

const char* rt_atrous_pair_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
