// One edge-avoiding A-Trous iteration over BOTH stochastic images, written
// for Hopper (sm_90a).
//
// Replaces realtimeraytracer_tpu/ops/denoise_pallas.py::atrous_denoise_pair
// (launcher _atrous_pair_iteration, kernel body _iter_kernel).  Inputs and
// outputs are (H, W, 3) f32 images, contiguous: the shadowed and unshadowed
// colour images, the normal and position G-buffer.  Each output pixel
// evaluates the 25 taps of the 5x5 kernel dilated by `step`, with one
// colour edge-stopping weight per image and the normal and position weights
// (times the kernel weight) shared by both, in the TPU kernel's term order:
//   w_c = min(exp(-|dc|^2 / c_phi), 1)
//   w_n = min(exp(-(|dn|^2 * inv_step2) / n_phi), 1)
//   w_p = min(exp(-|dp|^2 / p_phi), 1)
//   wnp = (w_n * w_p) * k;  w = w_c * wnp;  acc += c_tap * w;  cum += w
//   out = acc / max(cum, 1e-5)
// where each division by a phi is a product with its reciprocal (inv_c =
// 1 / c_phi computed in double and rounded to float, ...), which is how
// PyTorch's CUDA division by a Python scalar evaluates the twin's
// `x / c_phi`.  When the caller passes a `wsum` buffer (the autograd
// forward, whose backward csrc/atrous_pair_vjp.cu reads it), the kernel
// also writes each pixel's cum of both images: wsum = [cum_s (h, w) |
// cum_u (h, w)].
// Out-of-bounds taps are skipped by a bounds test, which is what a weight of
// exactly 0 contributes in the reference.  Any step runs (no halo limit).
//
// Design.  A CTA (32 x 4 threads) computes TW = 32 columns by TH = 16 rows
// of one row residue class: rows y = g*TH*step + ry + j*step, j < TH.  In
// those rows the dilated 5x5 stencil is dense, so the tile needs its own
// rows plus two above and two below (SR = 20 staged rows, for any step)
// and the columns [x0 - 2 step, x0 + TW + 2 step) (for step >= TW, the
// five column bands of TW pixels the taps hit, each staged apart).  The
// four planes' staged rows are copied into shared memory with 16-byte
// cp.async copies of the AoS rows as they lie in global memory (a staged
// row segment is contiguous; its first copy starts at the 16-byte boundary
// below it, its last is cut at its end); rows above or below the image are
// not read, and columns off the image are never looked up.  Thread (tx,
// ty) computes the PY = 4 pixels of column x0 + tx in rows j = 4 ty ..
// 4 ty + 3: their taps lie in 8 staged rows, so each staged tap value (12
// floats) is read from shared memory once for up to five taps (4.8 loads a
// tap, against the 12 global loads of one thread per pixel).  Per pixel
// the taps still accumulate in the reference's (ky, kx) order, so the
// result is that of one thread per pixel, bit for bit.
//
// What bounds it: instruction issue.  Each tap is about 67 f32 operations
// counted as one each for an exp (four squared distances, four expf, the
// weights and the accumulation) and about 112 SASS instructions (expf's
// range reduction, no contraction); memory is 72 bytes a pixel and
// iteration.  A product with a phi's reciprocal is one instruction where an
// IEEE division takes a reciprocal, Newton steps, a range check and a
// branch to a slow path, and each staged tap is loaded once for up to five
// taps.  A CTA computes nothing until its tiles have landed, so each wave
// of CTAs loads before it computes: the same loop reading global memory
// directly is faster (PERF.md: times, the issue-rate floor, the ablation).
//
// Numerics: expf (never __expf, and no --use_fast_math), built with
// -fmad=false so the products and sums round as the PyTorch twin's do; the
// reciprocal products are the twin's too, so kernel and twin agree bit for
// bit (an IEEE quotient would differ from them by up to an ulp; PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;            // output columns per CTA (a warp across)
constexpr int TY = 4;             // threads per column (warps per CTA)
constexpr int PY = 4;             // output rows per thread
constexpr int TH = TY * PY;       // output rows per CTA
constexpr int SR = TH + 4;        // staged rows
constexpr int NT = TW * TY;       // threads per CTA

__constant__ float KERNEL5[25] = {
    1, 4, 7, 4, 1,  4, 16, 26, 16, 4,  7, 26, 41, 26, 7,
    4, 16, 26, 16, 4,  1, 4, 7, 4, 1};

// Pixels per staged row segment and the segments of a row: one segment of
// TW + 4 step pixels below TW, else five bands of TW pixels.
struct Geometry {
  int nseg, seg_px, seg_floats, row_floats;
};

__host__ __device__ inline Geometry geometry(int step) {
  Geometry g;
  g.nseg = step < TW ? 1 : 5;
  g.seg_px = step < TW ? TW + 4 * step : TW;
  // Room for the segment's floats, the up to 3 floats before it in its
  // first 16-byte copy, and the rounding of the last copy.
  g.seg_floats = (3 * g.seg_px + 6) & ~3;
  g.row_floats = g.nseg * g.seg_floats;
  return g;
}

// Staged row jj, segment k of a tile: its global row and its columns
// [cs, ce) clipped to the image (cs >= ce: nothing to stage).
struct Segment {
  int yy, cs, ce;
};

__device__ __forceinline__ Segment segment(const Geometry& g, int x0, int y_first, int step,
                                           int w, int jj, int k) {
  const int gs = g.nseg == 1 ? x0 - 2 * step : x0 + (k - 2) * step;
  return {y_first + (jj - 2) * step, max(gs, 0), min(gs + g.seg_px, w)};
}

__device__ __forceinline__ float sq3(const float* a, const float* b) {
  const float d0 = a[0] - b[0];
  const float d1 = a[1] - b[1];
  const float d2 = a[2] - b[2];
  return (d0 * d0 + d1 * d1) + d2 * d2;
}

__device__ __forceinline__ void load3(const float* p, float* v) {
  v[0] = p[0];
  v[1] = p[1];
  v[2] = p[2];
}

// 16 bytes (or the first `bytes` of them, the rest zero-filled) from
// global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes) : "memory");
}

__global__ void __launch_bounds__(NT) atrous_pair_kernel(
    const float* __restrict__ s_in, const float* __restrict__ u_in,
    const float* __restrict__ nrm, const float* __restrict__ pos,
    float* __restrict__ s_out, float* __restrict__ u_out, float* __restrict__ wsum, int h,
    int w, int step, int residues, float inv_step2, float inv_c, float inv_n, float inv_p) {
  extern __shared__ __align__(16) float stage[];   // 4 planes x SR x row_floats
  // Per staged row and segment: the float offset of pixel x in the row's
  // room is sbase + 3 x; schunks 16-byte copies hold it (0: not staged).
  __shared__ int sbase[SR][5];
  __shared__ int schunks[SR][5];
  const Geometry geo = geometry(step);
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int x0 = blockIdx.x * TW;
  const int group = blockIdx.y / residues, ry = blockIdx.y % residues;
  const int y_first = group * TH * step + ry;       // global row of tile row 0
  const int plane_floats = SR * geo.row_floats;

  // Each staged (row, segment): the float offset of pixel x in its room
  // and the 16-byte copies that hold it, the first at the boundary below
  // its first pixel.
  for (int it = tid; it < SR * geo.nseg; it += NT) {
    const int jj = it / geo.nseg, k = it % geo.nseg;
    const Segment sg = segment(geo, x0, y_first, step, w, jj, k);
    const int lead = (3 * (sg.yy * w + sg.cs)) & 3;   // floats before cs in its first copy
    sbase[jj][k] = k * geo.seg_floats + lead - 3 * sg.cs;
    const bool ok = sg.yy >= 0 && sg.yy < h && sg.cs < sg.ce;
    schunks[jj][k] = ok ? (lead + 3 * (sg.ce - sg.cs) + 3) / 4 : 0;
  }
  __syncthreads();
  // One warp per (plane, row, segment), a lane per 16-byte copy.
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int item = ty; item < 4 * SR * geo.nseg; item += TY) {
    const int q = item / (SR * geo.nseg), rem = item % (SR * geo.nseg);
    const int jj = rem / geo.nseg, k = rem % geo.nseg;
    const int n = schunks[jj][k];
    if (n == 0) continue;
    const Segment sg = segment(geo, x0, y_first, step, w, jj, k);
    const size_t first = (size_t)3 * ((size_t)sg.yy * w + sg.cs) & ~(size_t)3;  // float index
    const size_t end = (size_t)3 * ((size_t)sg.yy * w + sg.ce);
    const float* src = q == 0 ? s_in : q == 1 ? u_in : q == 2 ? nrm : pos;
    float* dst = stage + q * plane_floats + jj * geo.row_floats + k * geo.seg_floats;
    for (int c = tx; c < n; c += TW) {
      const size_t at = first + 4 * (size_t)c;
      const size_t left = end - at;                 // floats of the segment from `at`
      cp_async16(dst + 4 * c, src + at, left >= 4 ? 16 : (int)(4 * left));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int x = x0 + tx;
  const float* sp = stage;
  const float* up = stage + plane_floats;
  const float* np = stage + 2 * plane_floats;
  const float* pp = stage + 3 * plane_floats;

  // The thread's pixels: rows j = PY ty + p, staged row j + 2, column x.
  bool pix_ok[PY];
  float cs[PY][3], cu[PY][3], cn[PY][3], cp[PY][3];
  float acc_s[PY][3], acc_u[PY][3], cum_s[PY], cum_u[PY];
#pragma unroll
  for (int p = 0; p < PY; ++p) {
    const int jj = PY * ty + p + 2;
    pix_ok[p] = x < w && y_first + (jj - 2) * step < h;
    const int seg = geo.nseg == 1 ? 0 : 2;
    const int f = jj * geo.row_floats + (pix_ok[p] ? sbase[jj][seg] + 3 * x : 0);
    load3(sp + f, cs[p]);
    load3(up + f, cu[p]);
    load3(np + f, cn[p]);
    load3(pp + f, cp[p]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc_s[p][c] = 0.0f;
      acc_u[p][c] = 0.0f;
    }
    cum_s[p] = 0.0f;
    cum_u[p] = 0.0f;
  }

  // Staged row r of the thread's 8 holds tap row ky = r - p of pixel p.
  // Per pixel, taps accumulate in (ky, kx) order, as one thread per pixel.
#pragma unroll
  for (int r = 0; r < PY + 4; ++r) {
    const int jj = PY * ty + r;
    const int yy = y_first + (jj - 2) * step;
    if (yy < 0 || yy >= h) continue;
    const float* srow = sp + jj * geo.row_floats;
#pragma unroll 1
    for (int kx = 0; kx < 5; ++kx) {
      const int xx = x + (kx - 2) * step;
      if (xx < 0 || xx >= w) continue;
      const int f = sbase[jj][geo.nseg == 1 ? 0 : kx] + 3 * xx;
      float qs[3], qu[3], qn[3], qp[3];
      load3(srow + f, qs);
      load3(srow + plane_floats + f, qu);
      load3(srow + 2 * plane_floats + f, qn);
      load3(srow + 3 * plane_floats + f, qp);
#pragma unroll
      for (int p = 0; p < PY; ++p) {
        const int ky = r - p;
        if (ky < 0 || ky > 4 || !pix_ok[p]) continue;
        const float w_cs = fminf(expf(-sq3(cs[p], qs) * inv_c), 1.0f);
        const float w_cu = fminf(expf(-sq3(cu[p], qu) * inv_c), 1.0f);
        const float w_n = fminf(expf(-(sq3(cn[p], qn) * inv_step2) * inv_n), 1.0f);
        const float w_p = fminf(expf(-sq3(cp[p], qp) * inv_p), 1.0f);
        const float wnp = (w_n * w_p) * KERNEL5[ky * 5 + kx];
        const float ws = w_cs * wnp;
        const float wu = w_cu * wnp;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc_s[p][c] = acc_s[p][c] + qs[c] * ws;
          acc_u[p][c] = acc_u[p][c] + qu[c] * wu;
        }
        cum_s[p] = cum_s[p] + ws;
        cum_u[p] = cum_u[p] + wu;
      }
    }
  }

#pragma unroll
  for (int p = 0; p < PY; ++p) {
    if (!pix_ok[p]) continue;
    const size_t o = ((size_t)(y_first + (PY * ty + p) * step) * w + x) * 3;
    const float den_s = fmaxf(cum_s[p], 1e-5f);
    const float den_u = fmaxf(cum_u[p], 1e-5f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s_out[o + c] = acc_s[p][c] / den_s;
      u_out[o + c] = acc_u[p][c] / den_u;
    }
    if (wsum != nullptr) {
      wsum[o / 3] = cum_s[p];
      wsum[(size_t)h * w + o / 3] = cum_u[p];
    }
  }
}

}  // namespace

extern "C" {

// One iteration at dilation `step` (>= 1) on `stream`; the four inputs
// start on 16-byte boundaries; inv_c, inv_n, inv_p are the float
// reciprocals of the three phi's; wsum is null or (2, h, w) f32, which
// receives each pixel's weight sums.  Returns cudaGetLastError() after the launch
// (0 = launched), the error of the shared-memory opt-in, or
// cudaErrorInvalidValue for step < 1.
int rt_atrous_pair(const void* s_in, const void* u_in, const void* nrm,
                   const void* pos, void* s_out, void* u_out, void* wsum, int h,
                   int w, int step, float inv_step2, float inv_c, float inv_n,
                   float inv_p, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (step < 1) return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(step);
  const size_t smem = (size_t)4 * SR * geo.row_floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        atrous_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // Row groups of TH x step rows, each split into its step residues (only
  // residues below h hold a row).
  const int residues = step < h ? step : h;
  const int groups = (h + TH * step - 1) / (TH * step);
  const dim3 block(TW, TY);
  const dim3 grid((w + TW - 1) / TW, groups * residues);
  atrous_pair_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)s_in, (const float*)u_in, (const float*)nrm,
      (const float*)pos, (float*)s_out, (float*)u_out, (float*)wsum, h, w, step, residues,
      inv_step2, inv_c, inv_n, inv_p);
  return (int)cudaGetLastError();
}

const char* rt_atrous_pair_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
