// f32 FMA-chain peak probe, written for Hopper (sm_90a).
//
// Replaces scripts/r4_probe.py::vpu_peak (its Pallas kernel `kern`).  Per
// element x of a (512, 128) f32 array: b = x * 0.9999999 and eight chains
// acc_j = x * (1 + 1e-7 j), each run 64 steps of acc_j = fma(acc_j, b,
// 1e-9), then out = acc_0 + acc_1 + ... + acc_7 in that order.  The
// constants are the JAX kernel's Python floats rounded to f32.
//
// The TPU grid's 64 steps, each of which rewrites the same block, are the
// 64 slices of blockIdx.y here, every slice writing the same output.  They
// are not a loop inside a thread: the body is loop-invariant, so the
// compiler could hoist it and run fewer FLOPs than are counted.  For the
// same reason the chain scales arrive as launch parameters: 1 + 3e-7 and
// 1 + 4e-7 round to the same f32, and with compile-time scales the
// compiler merged those two chains (448 FFMA per thread, not 512).
//
// What bounds it: f32 operations, 2 x 8 x 64 = 1,024 per element and slice
// (512 FFMA), 2 x 512 x 128 x 8 x 64 x 64 = 4.295 GFLOP per call; the
// eight chains are independent, so each thread keeps eight FFMAs in flight
// and the SM's resident warps cover the rest of the FFMA latency.  The
// build passes -fmad=false, which forbids contracting a*b+c; __fmaf_rn
// keeps each step one FFMA.
#include <cuda_runtime.h>

namespace {

constexpr int CHAINS = 8;
constexpr int STEPS = 64;
constexpr int BLOCK = 256;

struct Scales {
  float c[CHAINS];
};

__global__ void __launch_bounds__(BLOCK) fma_peak_kernel(const float* __restrict__ x,
                                                         float* __restrict__ out, int n,
                                                         Scales scales) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const float xv = x[i];
  const float b = xv * (float)0.9999999;
  float acc[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) acc[j] = xv * scales.c[j];
#pragma unroll
  for (int k = 0; k < STEPS; ++k) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) acc[j] = __fmaf_rn(acc[j], b, (float)1e-9);
  }
  float o = acc[0];
#pragma unroll
  for (int j = 1; j < CHAINS; ++j) o = o + acc[j];
  out[i] = o;
}

}  // namespace

extern "C" {

// Launches (ceil(n / 256), slices) CTAs on `stream`; every slice computes
// all n outputs.  Returns cudaGetLastError() after the launch.
int rt_fma_peak(const void* x, void* out, int n, int slices, void* stream) {
  if (n <= 0 || slices <= 0) return 0;
  Scales scales;
  for (int j = 0; j < CHAINS; ++j) scales.c[j] = (float)(1.0 + 1e-7 * j);
  const dim3 grid((n + BLOCK - 1) / BLOCK, slices);
  fma_peak_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, n,
                                                            scales);
  return (int)cudaGetLastError();
}

const char* rt_fma_peak_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
