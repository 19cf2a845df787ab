// Decoder convt5 for Hopper: the stride-1, padding-0, 3x3x3 transposed conv
// from Ci channels to 1 with bias, fp32, NCDHW, forward and gradients:
//   y[n, 0, o]   = b + sum_c sum_t w[c, 0, t] * x[n, c, o - t]
//   gx[n, c, i]  = sum_t w[c, 0, t] * gy[n, 0, i + t]
//   gw[c, 0, t]  = sum_{n, i} x[n, c, i] * gy[n, 0, i + t]
//   gb           = sum gy
// for x (B, Ci, D, H, W) and y (B, 1, D+2, H+2, W+2); t runs over the 27
// taps (dz, dy, dx) of the unflipped (Ci, 1, 3, 3, 3) weight.
//
// It replaces no Pallas kernel: the JAX package leaves convt5 to XLA.  It
// was added because cuDNN serves this shape (8 channels to 1 at full
// resolution) far from its bound: the layer took ~28 ms forward and
// backward at 288 rows of the 41x49x35 grid, where its bytes allow 0.55 ms.
// Bound on an H100 SXM, each tensor read or written once at 3.35 TB/s:
// the forward reads x and writes y, the fused backward reads gy and x and
// writes gx.  At 288 rows, 41x49x35 grid: x 557.5 MB, y 81.0 MB, 0.19 +
// 0.36 ms; MNI 91x109x91 grid: x 7.99 GB, y 1.06 GB, 2.70 + 5.09 ms.  The
// 2 * 216 products per output voxel and per input voxel take 0.34 ms and
// 4.8 ms at the 67 TFLOP/s fp32 FMA rate, so exact fp32 on the FMA units
// (no TF32 split) can reach the bytes bound; the design keeps each
// tensor's bytes to one pass and feeds the FMA units from registers.
//
// Design (ops/convt5.py computes the plan: chunk widths, tile rows, shared
// memory; this file trusts it):
//   * A block owns one row n and a band of rows of the (y, x) plane, at full
//     width, and marches through z.  Per plane it stages what the band reads
//     (the forward: Ci channels of x, with the 2-row halo above; the
//     backward: the gy plane with the 2-row halo below, and Ci channels of
//     x) with cp.async, double-buffered: the next plane's copies fly while
//     this one is computed.
//   * The halo is zeros in shared memory, written once: a staged row sits
//     between zero columns, and the band's rows outside the tensor stay
//     zero, since every plane stages the same rows to the same place.  The
//     inner loops read and multiply with no mask.  The padded row stride is
//     odd, so the lanes of a warp, which take neighbouring rows, read
//     distinct banks; the price is 4-byte copies (a row of 33, 35, 89 or 91
//     floats is never 16-byte aligned anyway), a warp copying one row's
//     consecutive words at a time.
//   * Registers carry the reuse.  A thread owns X consecutive columns of one
//     row (X, 7 or 8, from the plan: the one that launches the fewest lanes,
//     idle ones included: 35 and 91 output columns split exactly into 7s; 33
//     input columns into 7s, 89 into 8s, where 12 chunks of 8 channels fill
//     three warps).  Along z each staged plane feeds three planes of
//     the result, so the thread keeps three planes of sums and rotates them:
//     a plane is complete, and leaves, once the last plane that reaches it
//     has been read.  Along x a row of X + 2 staged values serves 3 X
//     products.  The forward thread reads its channel's 27 weights
//     (broadcast) and X + 2 values a (channel, dy) for 9 X products; the
//     backward thread holds its channel's 27 weight-gradient sums in
//     registers for the whole kernel, and reads X + 2 gy values and 9
//     weights (from shared memory, which keeps it within 128 registers and
//     five blocks an SM) a dy for 18 X products.
//   * Outputs leave through shared memory: a finished plane's band is one
//     contiguous run of y (or of each gx channel), stored by consecutive
//     lanes, 16 bytes a store where the run is aligned.
//   * The weight and bias gradients leave as per-block partial sums (a block
//     sums its threads in float64 in a fixed order), and a second kernel
//     sums the blocks' partials in float64 in a fixed order: no floating
//     point atomics, so two runs give the same bits.
// All element offsets are 64-bit (the MNI x holds ~2e9 elements).  The
// kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

// Mirrors ops/convt5.py::Convt5Plan field by field (all ints).  Strides and
// sizes are in 4-byte words of dynamic shared memory.
struct Plan {
  int b, ci, d, h, w;
  // forward: chunk width, chunks a row, output rows a block, blocks a row n,
  // threads, padded row stride, words a staged channel (a multiple of 4),
  // channels a stage buffer holds (a divisor of Ci), output band words,
  // shared memory bytes, blocks
  int fx, fnch, fty, fnty, fthreads, frs, fcs, fcg, fos, fsmem, fblocks;
  // backward: chunk width, chunks a row, x rows a block, blocks a row n,
  // threads, gy and x padded row strides, words a staged gy plane, a staged
  // x channel and a gx band channel (multiples of 4), shared memory bytes,
  // blocks, partial-sum columns
  int bx, bnch, bty, bnty, bthreads, brsg, brsx, bgsz, bxs, bgxs, bsmem, bblocks, nparts;
};

constexpr int kStages = 2;  // planes staged at once: kStages - 1 in flight
constexpr int kMaxThreads = 256;
constexpr int kBwdMinBlocks = 2;  // caps the backward at 128 registers
constexpr int kReduceThreads = 256;
static_assert(kStages >= 2, "the march needs a plane in flight");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row copies: each warp takes whole rows, its lanes consecutive words.  A
// block's rows across channels are tabled once (soff: words from the
// plane's first row in global memory; doff: words in shared memory), so
// that the march computes no division and no 64-bit product a row.
struct Lanes {
  int warp, lane, warps, lanes;
  __device__ __forceinline__ Lanes()
      : warp(threadIdx.x >> 5), lane(threadIdx.x & 31), warps((blockDim.x + 31) >> 5),
        lanes(min(32, (int)blockDim.x - (int)(threadIdx.x & ~31u))) {}
};

// Stage n tabled rows of `width` floats from src + soff[i] to dst + doff[i].
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           const long long* soff, const int* doff, int n,
                                           int width) {
  const Lanes l;
  for (int i = l.warp; i < n; i += l.warps) {
    const float* s = src + soff[i];
    float* d = dst + doff[i];
    for (int col = l.lane; col < width; col += l.lanes) cp_async4(d + col, s + col);
  }
}

// Stage n rows of `width` floats, row i from src + i * sstride to
// dst + i * dstride.
__device__ __forceinline__ void stage_strided(float* dst, const float* src, int n, int width,
                                              int dstride, int sstride) {
  const Lanes l;
  for (int i = l.warp; i < n; i += l.warps) {
    const float* s = src + i * sstride;
    float* d = dst + i * dstride;
    for (int col = l.lane; col < width; col += l.lanes) cp_async4(d + col, s + col);
  }
}

// Store n tabled rows of `width` floats from shared src + boff[i] to global
// dst + soff[i] (streaming); vec: 16-byte aligned rows, width % 4 == 0.
__device__ __forceinline__ void drain_rows(float* dst, const float* src,
                                           const long long* soff, const int* boff, int n,
                                           int width, bool vec) {
  const Lanes l;
  for (int i = l.warp; i < n; i += l.warps) {
    float* d = dst + soff[i];
    const float* s = src + boff[i];
    if (vec) {
      for (int q = l.lane; q < (width >> 2); q += l.lanes)
        __stcs(reinterpret_cast<float4*>(d) + q, reinterpret_cast<const float4*>(s)[q]);
    } else {
      for (int col = l.lane; col < width; col += l.lanes) __stcs(d + col, s[col]);
    }
  }
}

// Store n consecutive floats from shared src to global dst (streaming: no
// one reads them soon); vec: both 16-byte aligned and n % 4 == 0.
__device__ __forceinline__ void drain(float* dst, const float* src, int n, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < (n >> 2); i += blockDim.x)
      __stcs(reinterpret_cast<float4*>(dst) + i, reinterpret_cast<const float4*>(src)[i]);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) __stcs(dst + i, src[i]);
  }
}

__device__ __forceinline__ void zero_smem(float* smem, int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) smem[i] = 0.0f;
}

// ---------------------------------------------------------------------------
// forward: a block owns (n, output rows [y0, y0 + fty)) and all output
// columns; thread (r, k), r fastest, owns row y0 + r, columns [k X, k X + X).
// It marches over units of a plane and a group of fcg channels.  Shared
// memory: kStages stage buffers of fcg channels x fcs words, each channel
// fty + 2 rows of frs words (row q holds input row y0 - 2 + q, input
// column u at word u + 2; the rest zero), the weights (Ci x 28 words), two
// output bands (fos words each: fty rows of W + 2) and the table of the
// staged rows (12 bytes a row: fcg x (fty + 2) rows).  Staging a plane in
// groups of channels cuts a block's shared memory, so that four blocks fit
// an SM.
// ---------------------------------------------------------------------------
template <int X>
__global__ void __launch_bounds__(kMaxThreads) convt5_fwd(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ y, Plan p, int vec_out) {
  extern __shared__ __align__(16) float smem[];
  const int ci = p.ci, D = p.d, H = p.h, W = p.w;
  const int HY = H + 2, WX = W + 2;
  const int n = blockIdx.x / p.fnty, y0 = (blockIdx.x % p.fnty) * p.fty;
  const int r = threadIdx.x % p.fty, k = threadIdx.x / p.fty;
  const int yo = y0 + r, xo = k * X;
  // input rows inside the tensor: [ylo, yhi), at band rows from ylo - y0 + 2
  const int ylo = max(y0 - 2, 0), yhi = min(y0 + p.fty, H);
  const int nout = min(p.fty, HY - y0) * WX;  // words of the output band
  const int cg = p.fcg, ngroups = ci / cg, units = D * ngroups;
  float* const ws = smem + kStages * cg * p.fcs;
  float* const os = ws + ci * 28;  // two bands: plane z fills band z & 1
  long long* const soff = reinterpret_cast<long long*>(os + 2 * p.fos);
  int* const doff = reinterpret_cast<int*>(soff + cg * (p.fty + 2));

  const size_t plane = (size_t)H * W;
  const float* const xn = x + (size_t)n * ci * D * plane + (size_t)ylo * W;
  float* const yn = y + (size_t)n * (D + 2) * HY * WX + (size_t)y0 * WX;
  const size_t out_plane = (size_t)HY * WX;
  const int first = (ylo - y0 + 2) * p.frs + 2;  // word of row ylo, column 0
  const int nr = yhi - ylo, nrows = cg * nr;     // staged rows a channel, a unit

  zero_smem(smem, kStages * cg * p.fcs);
  for (int i = threadIdx.x; i < ci * 27; i += blockDim.x)
    ws[(i / 27) * 28 + i % 27] = w[i];
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
    const int c = i / nr, row = i - c * nr;
    soff[i] = ((long long)c * D) * (long long)plane + (long long)row * W;
    doff[i] = c * p.fcs + first + row * p.frs;
  }
  const float b0 = __ldg(bias);
  __syncthreads();  // the zeros and the table land before any copy

  auto buf = [&](int u) { return smem + (u % kStages) * cg * p.fcs; };
  auto stage_unit = [&](int u) {  // plane u / ngroups, channel group u % ngroups
    if (u < units) {
      const int zi = u / ngroups, g = u - zi * ngroups;
      stage_rows(buf(u), xn + ((size_t)g * cg * D + zi) * plane, soff, doff, nrows, W);
    }
    cp_async_commit();
  };
  auto put = [&](const float (&a)[X], int zo) {  // a finished plane into its band
    float* const band = os + (zo & 1) * p.fos;
    if (yo < HY) {
#pragma unroll
      for (int j = 0; j < X; ++j)
        if (xo + j < WX) band[r * WX + xo + j] = a[j] + b0;
    }
  };
  auto store = [&](int zo) { drain(yn + zo * out_plane, os + (zo & 1) * p.fos, nout, vec_out); };

  float acc[3][X];  // acc[dz]: output plane zi + dz
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int j = 0; j < X; ++j) acc[q][j] = 0.0f;

  for (int s = 0; s + 1 < kStages; ++s) stage_unit(s);
  for (int zi = 0, u = 0; zi < D; ++zi) {
    for (int g = 0; g < ngroups; ++g, ++u) {
      // one barrier a unit: after it unit u has landed for every thread, and
      // every thread is done with unit u - 1's buffer and, at a plane's first
      // unit, with band zi & 1
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (g == 0 && zi > 0) store(zi - 1);
      stage_unit(u + kStages - 1);  // into unit u - 1's buffer
      // output (yo, xo + j) reads input row yo - dy (band row r + 2 - dy) and
      // column xo + j - dx (word xo + j - dx + 2 = xo + m, m = j + 2 - dx)
      const float* const bz = buf(u) + (r + 2) * p.frs + xo;
      for (int c = 0; c < cg; ++c) {
        float wc[28];
        const float4* w4 = reinterpret_cast<const float4*>(ws + (g * cg + c) * 28);
#pragma unroll
        for (int q = 0; q < 7; ++q) {
          const float4 v = w4[q];
          wc[4 * q] = v.x, wc[4 * q + 1] = v.y, wc[4 * q + 2] = v.z, wc[4 * q + 3] = v.w;
        }
        const float* const ch = bz + c * p.fcs;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float v[X + 2];
#pragma unroll
          for (int m = 0; m < X + 2; ++m) v[m] = ch[m - dy * p.frs];
#pragma unroll
          for (int dz = 0; dz < 3; ++dz)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const float wt = wc[dz * 9 + dy * 3 + dx];
#pragma unroll
              for (int j = 0; j < X; ++j) acc[dz][j] = fmaf(wt, v[j + 2 - dx], acc[dz][j]);
            }
        }
      }
    }
    put(acc[0], zi);  // output plane zi has seen input planes zi - 2 .. zi
#pragma unroll
    for (int j = 0; j < X; ++j) {
      acc[0][j] = acc[1][j];
      acc[1][j] = acc[2][j];
      acc[2][j] = 0.0f;
    }
  }
  // output planes D and D + 1 read only input planes D - 2 and D - 1
  __syncthreads();
  store(D - 1);
  put(acc[0], D);
  __syncthreads();
  store(D);
  put(acc[1], D + 1);
  __syncthreads();
  store(D + 1);
}

// ---------------------------------------------------------------------------
// backward: a block owns (n, x rows [y0, y0 + bty)) and all columns; thread
// (c, r, k), c fastest, owns channel c, row y0 + r, columns [k X, k X + X).
// It marches over the gy planes zg = 0 .. D + 1: gy plane zg pairs with the
// x plane zg - dz and feeds the gx plane zg - dz.  Shared memory: kStages
// stage buffers, each a gy plane of bgsz words (bty + 2 rows of brsg
// words: row q holds gy row y0 + q, column u at word u; the rest zero) and
// Ci x channels of bxs words (bty rows of brsx words: row q holds x row
// y0 + q), two gx bands (Ci channels x bgxs words each, rows of W), the
// weights (Ci x 28 words) and the table of the x rows (16 bytes a row: Ci x
// bty rows).  After the march the same memory holds
// the threads' sums for the block's float64 reduction (30 words a thread).
// part: nparts = Ci * 27 + 1 columns of bblocks float64 partials (column
// Ci * 27 is the bias gradient's).
// ---------------------------------------------------------------------------
template <int X>
__global__ void __launch_bounds__(kMaxThreads, kBwdMinBlocks) convt5_bwd(
    const float* __restrict__ gy, const float* __restrict__ x,
    const float* __restrict__ w, float* __restrict__ gx, double* __restrict__ part,
    Plan p, int vec_gx) {
  extern __shared__ __align__(16) float smem[];
  const int ci = p.ci, D = p.d, H = p.h, W = p.w;
  const int HY = H + 2, WX = W + 2;
  const int n = blockIdx.x / p.bnty, y0 = (blockIdx.x % p.bnty) * p.bty;
  const int c = threadIdx.x % ci, rk = threadIdx.x / ci;
  const int r = rk % p.bty, k = rk / p.bty;
  const int yx = y0 + r, xo = k * X;
  const int xrows = min(y0 + p.bty, H) - y0, grows = min(y0 + p.bty + 2, HY) - y0;
  // the gy rows this block sums into gb: its own rows, and the last band
  // also the two rows past H
  const int gown = (y0 + p.bty >= H) ? HY - y0 : p.bty;
  const int stride = p.bgsz + ci * p.bxs;  // words a stage buffer
  float* const gxs = smem + kStages * stride;  // two bands: gx plane z fills band z & 1
  float* const ws = gxs + 2 * ci * p.bgxs;     // channel c's 27 weights at ws[c * 28]
  long long* const soff = reinterpret_cast<long long*>(ws + ci * 28);
  int* const doff = reinterpret_cast<int*>(soff + ci * p.bty);  // in a stage buffer's x
  int* const boff = doff + ci * p.bty;                          // in a gx band
  const int nrows = ci * xrows;  // x (and gx) rows a plane

  zero_smem(smem, kStages * stride);
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
    const int cc = i / xrows, row = i - cc * xrows;
    soff[i] = ((long long)cc * D) * (long long)H * W + (long long)row * W;
    doff[i] = p.bgsz + cc * p.bxs + row * p.brsx;
    boff[i] = cc * p.bgxs + row * W;
  }
  for (int i = threadIdx.x; i < ci * 27; i += blockDim.x) ws[(i / 27) * 28 + i % 27] = w[i];
  const float* const wc = ws + c * 28;
  float gw[27];
#pragma unroll
  for (int t = 0; t < 27; ++t) gw[t] = 0.0f;
  unsigned xcol = 0;  // bit j: this thread's x column xo + j lies inside the tensor
#pragma unroll
  for (int j = 0; j < X; ++j)
    if (yx < H && xo + j < W) xcol |= 1u << j;
  __syncthreads();  // the zeros and the table land before any copy

  const size_t plane = (size_t)H * W, gplane = (size_t)HY * WX;
  const float* const gyn = gy + (size_t)n * (D + 2) * gplane + (size_t)y0 * WX;
  const float* const xn = x + (size_t)n * ci * D * plane + (size_t)y0 * W;
  float* const gxn = gx + (size_t)n * ci * D * plane + (size_t)y0 * W;

  auto buf = [&](int zg) { return smem + (zg % kStages) * stride; };
  auto stage_plane = [&](int zg) {
    if (zg < D + 2) stage_strided(buf(zg), gyn + (size_t)zg * gplane, grows, WX, p.brsg, WX);
    if (zg < D) stage_rows(buf(zg), xn + (size_t)zg * plane, soff, doff, nrows, W);
    cp_async_commit();
  };
  auto store = [&](int z) {  // gx plane z, from band z & 1
    drain_rows(gxn + (size_t)z * plane, gxs + (z & 1) * ci * p.bgxs, soff, boff, nrows, W,
               vec_gx);
  };

  // rings of three planes, plane z in slot z % 3: acc holds the gx planes
  // zg - 2 .. zg, xr the x planes zg - 2 .. zg.  The march is unrolled by
  // three so that each slot is a register, and no plane moves between them
  float acc[3][X], xr[3][X];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int j = 0; j < X; ++j) acc[q][j] = xr[q][j] = 0.0f;
  double gbsum = 0.0;  // a few gy words a plane: summed in float64

  auto step = [&](int zg, auto slot) {  // gy plane zg, zg % 3 == slot
    constexpr int S = decltype(slot)::value;
    // one barrier a plane: after it plane zg has landed for every thread,
    // and every thread is done with plane zg - 1's buffer and band zg & 1
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (zg >= 3) store(zg - 3);
    stage_plane(zg + kStages - 1);  // into plane zg - 1's buffer
    const float* const gb = buf(zg);
    // the owned rows' padding columns are zero, so whole padded rows are summed
    for (int i = threadIdx.x; i < gown * p.brsg; i += blockDim.x) gbsum += gb[i];
    const float* const xb = gb + p.bgsz + c * p.bxs + r * p.brsx + xo;
#pragma unroll
    for (int j = 0; j < X; ++j)  // x plane zg replaces zg - 3; past D the buffer is old
      xr[S][j] = zg < D ? xb[j] : 0.0f;
    // gx (yx, xo + j) and gw pair with gy row yx + dy (band row r + dy) and
    // column xo + j + dx (word xo + m, m = j + dx); gy plane zg pairs with
    // the x plane and feeds the gx plane zg - dz, slot (S - dz) % 3
    const float* const gr = gb + r * p.brsg + xo;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float g[X + 2];
#pragma unroll
      for (int m = 0; m < X + 2; ++m) g[m] = gr[dy * p.brsg + m];
#pragma unroll
      for (int dz = 0; dz < 3; ++dz)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float wt = wc[dz * 9 + dy * 3 + dx];
          float s = gw[dz * 9 + dy * 3 + dx];
#pragma unroll
          for (int j = 0; j < X; ++j) {
            acc[(S + 3 - dz) % 3][j] = fmaf(wt, g[j + dx], acc[(S + 3 - dz) % 3][j]);
            s = fmaf(xr[(S + 3 - dz) % 3][j], g[j + dx], s);
          }
          gw[dz * 9 + dy * 3 + dx] = s;
        }
    }
    // gx plane zg - 2 (slot (S + 1) % 3) has seen gy planes zg - 2 .. zg; the
    // slot starts gx plane zg + 1
    constexpr int done = (S + 1) % 3;
    if (zg >= 2) {
      float* const band = gxs + ((zg & 1) * ci + c) * p.bgxs + r * W + xo;
#pragma unroll
      for (int j = 0; j < X; ++j)
        if ((xcol >> j) & 1u) band[j] = acc[done][j];
    }
#pragma unroll
    for (int j = 0; j < X; ++j) acc[done][j] = 0.0f;
  };

  for (int s = 0; s + 1 < kStages; ++s) stage_plane(s);
  for (int zg = 0; zg < D + 2; zg += 3) {
    step(zg, std::integral_constant<int, 0>());
    if (zg + 1 < D + 2) step(zg + 1, std::integral_constant<int, 1>());
    if (zg + 2 < D + 2) step(zg + 2, std::integral_constant<int, 2>());
  }
  __syncthreads();
  store(D - 1);

  // the block's partial sums, in float64 in a fixed order
  __syncthreads();
  float* const red = smem;  // threads x 28 words, then the threads' gb sums
  double* const redb = reinterpret_cast<double*>(smem + 28 * blockDim.x);
#pragma unroll
  for (int t = 0; t < 27; ++t) red[threadIdx.x * 28 + t] = gw[t];
  redb[threadIdx.x] = gbsum;
  __syncthreads();
  const int per = blockDim.x / ci;  // threads of one channel
  for (int j = threadIdx.x; j < ci * 27 + 1; j += blockDim.x) {
    double s = 0.0;
    if (j < ci * 27) {
      const int cc = j / 27, t = j % 27;
      for (int q = 0; q < per; ++q) s += (double)red[(cc + q * ci) * 28 + t];
    } else {
      for (int q = 0; q < (int)blockDim.x; ++q) s += redb[q];
    }
    part[(size_t)j * p.bblocks + blockIdx.x] = s;
  }
}

// Column j of part (nblocks float64 partials) summed in a fixed order into
// gw[j] (j < nw) or gb[0] (j == nw).
__global__ void __launch_bounds__(kReduceThreads) convt5_reduce(
    const double* __restrict__ part, int nblocks, int nw, float* __restrict__ gw,
    float* __restrict__ gb) {
  __shared__ double red[kReduceThreads];
  const int j = blockIdx.x;
  const double* col = part + (size_t)j * nblocks;
  double s = 0.0;
  for (int i = threadIdx.x; i < nblocks; i += kReduceThreads) s += col[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (j < nw)
      gw[j] = (float)red[0];
    else
      gb[0] = (float)red[0];
  }
}

// Largest dynamic shared memory each kernel instance has opted into so far,
// per device, so that the attribute is set only when a launch needs more.
constexpr int kMaxDevices = 64, kNumX = 2;
constexpr int kXs[kNumX] = {7, 8};
int g_opted[2][kNumX][kMaxDevices] = {};

template <typename F>
cudaError_t opt_in(F* fn, int which, int xi, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* opted = g_opted[which][xi];
  if (dev >= kMaxDevices || smem > opted[dev]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted[dev] = smem;
  }
  return cudaSuccess;
}

template <int X>
int launch_fwd(const float* x, const float* w, const float* b, float* y, const Plan& p,
               int vec_out, int xi, cudaStream_t s) {
  cudaError_t err = opt_in(convt5_fwd<X>, 0, xi, p.fsmem);
  if (err != cudaSuccess) return (int)err;
  convt5_fwd<X><<<p.fblocks, p.fthreads, p.fsmem, s>>>(x, w, b, y, p, vec_out);
  return (int)cudaGetLastError();
}

template <int X>
int launch_bwd(const float* gy, const float* x, const float* w, float* gx, double* part,
               float* gw, float* gb, const Plan& p, int vec_gx, int xi, cudaStream_t s) {
  cudaError_t err = opt_in(convt5_bwd<X>, 1, xi, p.bsmem);
  if (err != cudaSuccess) return (int)err;
  convt5_bwd<X><<<p.bblocks, p.bthreads, p.bsmem, s>>>(gy, x, w, gx, part, p, vec_gx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  convt5_reduce<<<p.nparts, kReduceThreads, 0, s>>>(part, p.bblocks, p.ci * 27, gw, gb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of ints in the plan (checked by ops/convt5.py); the chunk widths X
// the kernels are built for, written to out[0 .. kNumX).
int convt5_plan_ints() { return (int)(sizeof(Plan) / sizeof(int)); }

// Planes a block stages at once (the plan's shared memory counts them).
int convt5_stages() { return kStages; }

int convt5_widths(int* out) {
  for (int i = 0; i < kNumX; ++i) out[i] = kXs[i];
  return kNumX;
}

// The forward: one launch on `stream`; returns cudaGetLastError() (0 on
// success).  `plan` is ops/convt5.py's Convt5Plan for this shape; vec_out
// selects 16-byte stores of y.  The caller has checked shapes, pointers,
// the plan's widths and its shared memory.
int convt5_forward(const float* x, const float* w, const float* b, float* y,
                   const int* plan, int vec_out, void* stream) {
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p.fx) {
    case 7: return launch_fwd<7>(x, w, b, y, p, vec_out, 0, s);
    case 8: return launch_fwd<8>(x, w, b, y, p, vec_out, 1, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The gradients: the fused pass and the reduction, two launches on
// `stream`; `part` holds plan.nparts x plan.bblocks float64 words; vec_gx
// selects 16-byte stores of gx.
int convt5_backward(const float* gy, const float* x, const float* w, float* gx,
                    double* part, float* gw, float* gb, const int* plan, int vec_gx,
                    void* stream) {
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p.bx) {
    case 7: return launch_bwd<7>(gy, x, w, gx, part, gw, gb, p, vec_gx, 0, s);
    case 8: return launch_bwd<8>(gy, x, w, gx, part, gw, gb, p, vec_gx, 1, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
