// Encoder conv5 for Hopper: stride-1 VALID 3x3x3 conv plus bias, fp32.
//
// Replaces vaegam_tpu/ops/pallas_conv.py::_conv5_kernel (launched by
// _pallas_fwd, public op conv3d_s1_pallas).  Same function, in the port's
// NCDHW / OIDHW layout so that it stands in for F.conv3d with no permutes:
//   y[b, co, z, y, x] = bias[co]
//       + sum_{ci, dz, dy, dx} x[b, ci, z+dz, y+dy, x+dx] * w[co, ci, dz, dy, dx]
// for any B, Ci, Co, D, H, W (D, H, W >= 3).
//
// Seen as a GEMM it is an implicit product with M = B*Do*Ho*Wo rows,
// N = Co and K = 27*Ci; at the main path's shape, x (32,16,8,10,6) ->
// y (32,16,6,8,4), that is 6,144 x 16 x 432.  Bounds on an H100 SXM there:
// 84.9 MFLOP is ~1.27 us at the 67 TFLOP/s fp32 FMA rate; the same work as
// split TF32 (3 tensor-core products) is ~0.51 us at 495 TFLOP/s dense
// TF32; ~1.4 MB of input, weight and output is ~0.42 us at 3.35 TB/s.
// Either way the bound is about a microsecond; what costs is latency (a
// block's set-up: loads, copies, tables) and the tensor-core issue of the
// split product.  ops/conv5_phases.py reads both per block; PERF.md has the
// readings.
//
// Design (ops/conv5.py computes the plan: block tiling, shared-memory
// layout, offsets; this file trusts it):
//   * Tensor cores on split TF32.  mma.sync m16n8k8 tf32 with each operand
//     split once as hi = rna(v), lo = rna(v - hi), accumulating
//     lo*hi + hi*lo + hi*hi in fp32 (lo*lo dropped).  That keeps fp32's
//     ~1e-6 error at K = 432, where one TF32 product is off by ~1e-3
//     (tests/test_torch_port_ops.py pins both).  mma.sync, not wgmma: the
//     A operand is read straight out of the staged input (implicit
//     im2col), which wgmma's swizzled 64-row shared-memory tiles would
//     force us to write out first.
//   * The weight never goes through shared memory.  Each of a block's 8
//     warps owns a K slice of 7 k8 steps (54 steps = 8 slices at Ci = 16)
//     and holds that slice's B fragments, split, in 56 registers, loaded
//     with __ldg (L1, then L2) while the input copies fly.  A first design
//     staged the weight with cp.async and split it into fragment order in
//     shared memory; staging and splitting it took two thirds of a block's
//     cycles, and 16-byte fragment loads fed every k step.
//   * The input in one round trip.  A block covers (b, z_out, up to 64
//     output rows of the plane in (y, x) order).  It issues its warps'
//     weight loads, then every cp.async for the input lines those rows
//     read, per (ci, dz) one contiguous run (16 bytes a copy where
//     H*W % 4 == 0 and x is 16-byte aligned, else 4), and the bias; builds
//     its address tables while they fly; and waits once.
//   * Implicit im2col from tables: A[row][k] = in[rowoff[row] + koff[k]],
//     K in the weight's own (ci, dz, dy, dx) order, so an mma quad's four
//     k lanes read neighbouring taps: overlapping addresses broadcast and
//     distinct ones fall on distinct banks; the per-channel stride puts a
//     step that crosses channels 16 banks away.  K padding reads a zeroed
//     run (and zero weights); the ragged last m16 tile clamps its rows and
//     is masked at the store.
//   * Each warp runs its K slice over every m16 tile of the block, so its
//     registers hold the weight for up to 4 tiles of A.  The 8 slices'
//     partial sums meet in shared memory; the epilogue adds them in a fixed
//     order (deterministic) with the bias and stores rows of one co, so
//     neighbouring lanes write neighbouring x positions.
//
// One-pass path (conv5_fwd_bf16, the template's kOnePass): the TPU's own
// arithmetic for the Pallas kernel's jnp.dot, which carries no precision
// and so takes Mosaic's default of one bfloat16 pass with float32
// accumulation.  Each operand is rounded once to bfloat16 (to nearest even)
// where the split path splits it; a bfloat16 value is exact in TF32, so one
// m16n8k8 TF32 product per k step forms the exact products, summed in fp32.
// The lo terms and their two products a step are dropped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Built with -DCONV5_PHASE_CLOCKS (ops/conv5_phases.py), thread 0 of each of
// the first kClockBlocks blocks records the SM, the global timer at entry and
// exit, and clock64() at each phase boundary.  Off, PHASE() compiles to nothing.
#ifdef CONV5_PHASE_CLOCKS
constexpr int kClockBlocks = 4096, kClockSlots = 10;  // clocks 0-6, ns 7-8, SM 9
__device__ long long g_clocks[kClockBlocks * kClockSlots];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE(i)                                                        \
  if (threadIdx.x == 0 && blockIdx.x < kClockBlocks)                    \
    g_clocks[blockIdx.x * kClockSlots + (i)] = clock64();
#define PHASE_NS(i)                                                     \
  if (threadIdx.x == 0 && blockIdx.x < kClockBlocks)                    \
    g_clocks[blockIdx.x * kClockSlots + (i)] = global_ns();
#else
#define PHASE(i)
#define PHASE_NS(i)
#endif

// Mirrors ops/conv5.py::Conv5Plan field by field (all ints).  Offsets are
// in 4-byte words from the start of dynamic shared memory.
struct Plan {
  int ci, co, d, h, w;
  int rows, nchunks;    // output (y, x) rows a block covers; blocks per z plane
  int mt, nslices;      // m16 tiles a block; K slices of kSliceSteps k8 steps
  int ngroups;          // n16 groups (two n8 tiles each): Co padded to 16
  int ds, cs, rstride;  // words per (ci, dz) run; per channel; per partial-sum row
  int red_off, koff_off, rowoff_off, bias_off;
  int smem, blocks;
};

constexpr int kSliceSteps = 7;  // k8 steps a warp holds in registers (54 = 8 slices at Ci=16)
constexpr int kMaxTiles = 4;    // m16 tiles a block at most

// Round to TF32 as cvt.rna.tf32.f32 does (to nearest, ties away from zero),
// in two full-rate integer ops: sign-magnitude makes adding half an ulp of
// the 10-bit mantissa and clearing the 13 low bits round the magnitude.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// Round to bfloat16 (to nearest even), kept as fp32 bits: exact in TF32.
__device__ __forceinline__ uint32_t to_bf16(float v) {
  return __float_as_uint(__bfloat162float(__float2bfloat16_rn(v)));
}

// c += a * b for one m16n8k8 tile (a row-major 16x8, b column-major 8x8).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

// Within each k8 step the mma's k slots t and t+4 of lane (g, t) take the
// neighbouring k = 8s + 2t and 8s + 2t + 1 (A and B alike; any order of k
// gives the same product), so a lane reads each operand pair as 8 bytes.
//
// The B fragments of K slice q, n16 group ng: for k8 step s and n8 tile j,
// lane (g, t) holds {b0, b1} = w[n = ng*16 + j*8 + g][k = (q*7 + s)*8 + 2t
// (+1)], zero past Co or K.  load() only issues the loads (through L1 to
// L2: every block reads the weight), so that their latency overlaps the
// staging; split() waits for them and splits each into hi and lo.
struct BSlice {
  float2 raw[kSliceSteps][2];
  uint32_t hi[kSliceSteps][2][2], lo[kSliceSteps][2][2];

  __device__ __forceinline__ void load(const float* __restrict__ w, int q, int ng,
                                       int co, int kdim, int g, int t) {
#pragma unroll
    for (int s = 0; s < kSliceSteps; ++s)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = ng * 16 + j * 8 + g, k = (q * kSliceSteps + s) * 8 + 2 * t;
        float2 v = make_float2(0.0f, 0.0f);
        if (n < co && k < kdim) {
          const float* src = w + n * kdim + k;
          if ((kdim & 1) == 0)  // 8-byte aligned, and k + 1 < kdim
            v = __ldg(reinterpret_cast<const float2*>(src));
          else
            v = make_float2(__ldg(src), k + 1 < kdim ? __ldg(src + 1) : 0.0f);
        }
        raw[s][j] = v;
      }
  }

  // kOnePass: hi holds the bfloat16 rounding and lo is not formed
  template <bool kOnePass>
  __device__ __forceinline__ void split() {
#pragma unroll
    for (int s = 0; s < kSliceSteps; ++s)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (kOnePass) {
          hi[s][j][0] = to_bf16(raw[s][j].x);
          hi[s][j][1] = to_bf16(raw[s][j].y);
        } else {
          split_tf32(raw[s][j].x, hi[s][j][0], lo[s][j][0]);
          split_tf32(raw[s][j].y, hi[s][j][1], lo[s][j][1]);
        }
      }
  }
};

template <bool kOnePass>
__global__ void __launch_bounds__(kThreads, 2)
conv5_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ y,
             const Plan p, const int vec) {
  extern __shared__ __align__(16) float smem[];
  float* slab = smem;                                  // [ci][dz][run], then zeros
  float* red = smem + p.red_off;                       // [warp][n][row] partial sums
  int* koff = reinterpret_cast<int*>(smem + p.koff_off);
  int* rowoff = reinterpret_cast<int*>(smem + p.rowoff_off);
  float* bias_s = smem + p.bias_off;

  PHASE_NS(7)
  PHASE(0)
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int d_out = p.d - 2, h_out = p.h - 2, w_out = p.w - 2;
  const int hw = p.h * p.w;
  const int chunk = blockIdx.x % p.nchunks;
  const int bz = blockIdx.x / p.nchunks;
  const int z = bz % d_out, b = bz / d_out;
  const int plane = h_out * w_out;
  const int r0 = chunk * p.rows;
  const int nrows = min(plane, r0 + p.rows) - r0;
  // input words [s0, s1) of each z-slice: the rows' first y-line .. last + 2
  int s0 = (r0 / w_out) * p.w, s1 = ((r0 + nrows - 1) / w_out + 3) * p.w;
  if (vec) {
    s0 &= ~3;
    s1 = min(hw, (s1 + 3) & ~3);
  }
  const int run = s1 - s0;
  const int kdim = 27 * p.ci;

  // 1. this warp's first weight slice, the input runs and the bias: every
  //    load and copy issued, the tables built, then one wait
  BSlice bf;
  if (warp < p.nslices) bf.load(w, warp, 0, p.co, kdim, g, t);
  const float* xb = x + ((size_t)b * p.ci * p.d + z) * hw + s0;
  if (vec) {
    const int n4 = run >> 2;
    for (int i = tid; i < p.ci * 3 * n4; i += kThreads) {
      const int r = i / n4, j = 4 * (i - r * n4);
      const int ci = r / 3, dz = r - 3 * ci;
      cp_async16(slab + ci * p.cs + dz * p.ds + j, xb + ((size_t)ci * p.d + dz) * hw + j);
    }
  } else {
    for (int i = tid; i < p.ci * 3 * run; i += kThreads) {
      const int r = i / run, j = i - r * run;
      const int ci = r / 3, dz = r - 3 * ci;
      cp_async4(slab + ci * p.cs + dz * p.ds + j, xb + ((size_t)ci * p.d + dz) * hw + j);
    }
  }
  for (int i = tid; i < p.co; i += kThreads) cp_async4(bias_s + i, bias + i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  PHASE(1)

  // while the copies fly: the address tables
  float* zeros = slab + p.ci * p.cs;
  for (int i = tid; i < p.ds; i += kThreads) zeros[i] = 0.0f;
  for (int k = tid; k < p.nslices * kSliceSteps * 8; k += kThreads) {
    int ko = p.ci * p.cs;  // K padding: the zero run
    if (k < kdim) {
      const int ci = k / 27, tap = k - 27 * ci;
      ko = ci * p.cs + (tap / 9) * p.ds + ((tap / 3) % 3) * p.w + tap % 3;
    }
    koff[k] = ko;
  }
  for (int r = tid; r < p.mt * 16; r += kThreads) {
    const int rr = r0 + min(r, nrows - 1);  // ragged tail: clamp, masked at the store
    const int yo = rr / w_out;
    rowoff[r] = yo * p.w + (rr - yo * w_out) - s0;
  }
  PHASE(2)
  bf.split<kOnePass>();
  PHASE(3)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  PHASE(4)

  // 2. product, per n16 group: warp w takes K slices w, w+8, ... for every
  //    m16 tile of the block, accumulating hi*hi + hi*lo + lo*hi in fp32
  //    (the one-pass path: the bfloat16 roundings' one product)
  float* yp = y + ((size_t)b * p.co * d_out + z) * plane + r0;
  for (int ng = 0; ng < p.ngroups; ++ng) {
    float acc[kMaxTiles][2][4] = {};
    for (int q = warp; q < p.nslices; q += kWarps) {
      if (ng > 0 || q != warp) {
        bf.load(w, q, ng, p.co, kdim, g, t);
        bf.split<kOnePass>();
      }
      const int2* kq = reinterpret_cast<const int2*>(koff + q * kSliceSteps * 8) + t;
#pragma unroll
      for (int m = 0; m < kMaxTiles; ++m) {
        if (m >= p.mt) break;
        const int ro0 = rowoff[m * 16 + g], ro1 = rowoff[m * 16 + g + 8];
#pragma unroll
        for (int s = 0; s < kSliceSteps; ++s) {
          const int2 kk = kq[s * 4];
          const int k0 = kk.x, k1 = kk.y;
          uint32_t ah[4], al[4];
          if constexpr (kOnePass) {
            ah[0] = to_bf16(slab[ro0 + k0]);
            ah[1] = to_bf16(slab[ro1 + k0]);
            ah[2] = to_bf16(slab[ro0 + k1]);
            ah[3] = to_bf16(slab[ro1 + k1]);
#pragma unroll
            for (int j = 0; j < 2; ++j)
              mma_tf32(acc[m][j], ah, bf.hi[s][j][0], bf.hi[s][j][1]);
          } else {
            split_tf32(slab[ro0 + k0], ah[0], al[0]);
            split_tf32(slab[ro1 + k0], ah[1], al[1]);
            split_tf32(slab[ro0 + k1], ah[2], al[2]);
            split_tf32(slab[ro1 + k1], ah[3], al[3]);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              mma_tf32(acc[m][j], al, bf.hi[s][j][0], bf.hi[s][j][1]);
              mma_tf32(acc[m][j], ah, bf.lo[s][j][0], bf.lo[s][j][1]);
              mma_tf32(acc[m][j], ah, bf.hi[s][j][0], bf.hi[s][j][1]);
            }
          }
        }
      }
    }
    // c0 (row g, col 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
#pragma unroll
    for (int m = 0; m < kMaxTiles; ++m) {
      if (m >= p.mt) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* rp = red + (warp * 16 + j * 8 + 2 * t) * p.rstride + m * 16 + g;
        rp[0] = acc[m][j][0];
        rp[p.rstride] = acc[m][j][1];
        rp[8] = acc[m][j][2];
        rp[p.rstride + 8] = acc[m][j][3];
      }
    }
    __syncthreads();
    PHASE(5)

    // 3. epilogue: sum the warps' partials, add the bias, store rows of one co
    const int nco = min(16, p.co - ng * 16);
    for (int o = tid; o < nco * nrows; o += kThreads) {
      const int c = o / nrows, r = o - c * nrows, co = ng * 16 + c;
      float s = bias_s[co];
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[(q * 16 + c) * p.rstride + r];
      yp[(size_t)co * d_out * plane + r] = s;
    }
    __syncthreads();  // red is rewritten by the next group
  }
  PHASE(6)
#ifdef CONV5_PHASE_CLOCKS
  if (threadIdx.x == 0 && blockIdx.x < kClockBlocks) {
    int smid;
    asm("mov.u32 %0, %%smid;" : "=r"(smid));
    g_clocks[blockIdx.x * kClockSlots + 9] = smid;
  }
#endif
  PHASE_NS(8)
}

// Largest dynamic shared memory each path of the kernel has opted into so
// far, per device, so that the attributes are set only when a launch needs
// more.
constexpr int kMaxDevices = 64;
int g_smem_opted[2][kMaxDevices] = {};

template <bool kOnePass>
int launch(const float* x, const float* w, const float* bias, float* y,
           const int* plan, int vec, void* stream) {
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int* opted = g_smem_opted[kOnePass ? 1 : 0];
  if (dev >= kMaxDevices || p.smem > opted[dev]) {
    err = cudaFuncSetAttribute(
        conv5_kernel<kOnePass>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) opted[dev] = p.smem;
  }
  conv5_kernel<kOnePass><<<p.blocks, kThreads, p.smem, (cudaStream_t)stream>>>(
      x, w, bias, y, p, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of ints in the plan conv5_fwd reads (checked by ops/conv5.py).
int conv5_plan_ints() { return (int)(sizeof(Plan) / sizeof(int)); }

// Launches on `stream`; returns cudaGetLastError() (0 on success).  `plan`
// is ops/conv5.py's Conv5Plan for this shape; `vec` selects the 16-byte
// staging path (H*W % 4 == 0 and x 16-byte aligned).  The caller has
// checked shapes, pointers and the shared-memory size.
int conv5_fwd(const float* x, const float* w, const float* bias, float* y,
              const int* plan, int vec, void* stream) {
  return launch<false>(x, w, bias, y, plan, vec, stream);
}

// The one-pass path (bfloat16 operands, fp32 sums); arguments as conv5_fwd.
int conv5_fwd_bf16(const float* x, const float* w, const float* bias, float* y,
                   const int* plan, int vec, void* stream) {
  return launch<true>(x, w, bias, y, plan, vec, stream);
}

#ifdef CONV5_PHASE_CLOCKS
int conv5_clock_slots() { return kClockSlots; }

// Copies the first n words of the clock record of the last launch to `out`.
int conv5_phase_clocks(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_clocks, sizeof(long long) * n);
}
#endif

}  // extern "C"
