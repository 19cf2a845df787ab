// Encoder conv5 for Hopper: stride-1 VALID 3x3x3 conv plus bias, fp32.
//
// Replaces vaegam_tpu/ops/pallas_conv.py::_conv5_kernel (launched by
// _pallas_fwd, public op conv3d_s1_pallas).  Same function, in the port's
// NCDHW / OIDHW layout so that it stands in for F.conv3d with no permutes:
//   y[b, co, z, y, x] = bias[co]
//       + sum_{ci, dz, dy, dx} x[b, ci, z+dz, y+dy, x+dx] * w[co, ci, dz, dy, dx]
// for any B, Ci, Co, D, H, W (D, H, W >= 3).  Full fp32 FMA: no TF32 and no
// tensor cores, because the parity tolerance is 2e-5 and TF32 keeps ~3 digits.
//
// Bound on an H100 SXM at the main path's shape, x (32,16,8,10,6) ->
// y (32,16,6,8,4): 2*32*3072*432 = 84.9 MFLOP of fp32 FMA, ~1.3 us at the
// ~67 TFLOP/s fp32 rate; ~1.4 MB of input, weight and output, ~0.42 us at
// 3.35 TB/s.  So it is FMA-bound on paper; the simple design below runs far
// from that bound (PERF.md has its device time).
//
// The simple design: one block per (b, z_out) output plane (192 blocks for
// 132 SMs at the main path).  The block copies its 3 input z-slabs
// (3*Ci*H*W floats, contiguous per channel) and the whole weight
// (27*Ci*Co floats, 27.6 KB at 16->16) into dynamic shared memory with
// coalesced loads, so every input element is read from device memory once
// per output plane that needs it and the weight once per block.  Threads
// then stride over the plane's (co, y, x) outputs, each doing 27*Ci FMAs out
// of shared memory; a warp shares co (broadcast weight reads) and writes
// neighbouring outputs (coalesced stores).  Shared memory is ~39 KB at the
// main path and ~124 KB at the MNI-grid shape (4,16,20,25,20), hence the
// opt-in above 48 KB.  Making it fast (mma/wgmma on split TF32 or bf16, TMA
// loads, fusing bn5 and the ReLU) is left to a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
conv5_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ y,
             int ci_n, int co_n, int d_in, int h_in, int w_in) {
  extern __shared__ float smem[];
  const int d_out = d_in - 2, h_out = h_in - 2, w_out = w_in - 2;
  const int hw = h_in * w_in;
  const int slab = 3 * hw;                 // 3 z-slices of one channel
  const int b = blockIdx.x / d_out;
  const int z = blockIdx.x % d_out;
  float* xs = smem;                        // [ci][dz][h][w]
  float* ws = smem + ci_n * slab;          // [co][ci][27]

  for (int i = threadIdx.x; i < ci_n * slab; i += blockDim.x) {
    const int ci = i / slab;
    const int r = i - ci * slab;
    xs[i] = x[((size_t)(b * ci_n + ci) * d_in + z) * hw + r];
  }
  const int nw = co_n * ci_n * 27;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) ws[i] = w[i];
  __syncthreads();

  const int plane = h_out * w_out;
  for (int o = threadIdx.x; o < co_n * plane; o += blockDim.x) {
    const int co = o / plane;
    const int r = o - co * plane;
    const int yy = r / w_out;
    const int xx = r - yy * w_out;
    const float* wp = ws + co * ci_n * 27;
    float acc = 0.0f;
    for (int ci = 0; ci < ci_n; ++ci) {
      const float* xp = xs + ci * slab + yy * w_in + xx;
      const float* wc = wp + ci * 27;
#pragma unroll
      for (int dz = 0; dz < 3; ++dz)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            acc = fmaf(xp[dz * hw + dy * w_in + dx], wc[dz * 9 + dy * 3 + dx], acc);
    }
    y[((size_t)(b * co_n + co) * d_out + z) * plane + r] = acc + bias[co];
  }
}

// Largest dynamic shared memory the kernel has opted into so far, per
// device, so that the attribute is set only when a launch needs more.
constexpr int kMaxDevices = 64;
int g_smem_opted[kMaxDevices] = {0};

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).  The
// caller (ops/conv5.py) has checked shapes and the shared-memory size.
int conv5_fwd(const float* x, const float* w, const float* bias, float* y,
              int batch, int ci_n, int co_n, int d_in, int h_in, int w_in,
              void* stream) {
  const int smem = (int)(sizeof(float) *
      ((size_t)3 * ci_n * h_in * w_in + (size_t)27 * ci_n * co_n));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem > g_smem_opted[dev]) {
    err = cudaFuncSetAttribute(
        conv5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) g_smem_opted[dev] = smem;
  }
  const int blocks = batch * (d_in - 2);
  conv5_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      x, w, bias, y, ci_n, co_n, d_in, h_in, w_in);
  return (int)cudaGetLastError();
}

}  // extern "C"
