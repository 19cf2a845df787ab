// The train step's guarded Adam update for Hopper, in two launches:
// apply_if_finite(chain(clip_by_global_norm?, adam(lr))) in place, as
// vaegam_tpu_torch/ops/adam.py::adam_plain computes it leaf by leaf.
//
// Replaces no TPU kernel: the JAX package leaves its optax update to XLA,
// which fuses it into the step's one program.  Run eagerly in PyTorch the
// same update is ~22 small ops a leaf, ~1,330 kernels a step over the
// model's 63 leaves, and launching them is most of the eager step's host
// time (PERF.md).  Here:
//   * adam_check (launch 1): every block scans its tiles of the gradients,
//     counts the non-finite entries and, with the clip on, sums g*g.  The
//     last block to finish (an atomic ticket, which it resets for the next
//     call or graph replay) sums the blocks' partials in a fixed order and
//     decides the step: finite, apply, the bias corrections, the clip's
//     norm and trigger, into the Work struct at a fixed device address.
//     It updates the four counters as the plain version does.
//   * adam_apply (launch 2): if the step applies, p, m and v of every leaf
//     in place; otherwise it writes nothing (the plain version writes p, m
//     and v back unchanged, the same bits).
// Each leaf stays where it is.  The kernel parameters carry a table of the
// leaves (pointers to p, g, m and v, the size, the leaf's first tile),
// built by ops/adam.py::pack from the tensors of the call, so a CUDA graph
// captured around the call replays against the same addresses and nothing
// is uploaded a step.  The table takes up to kMaxLeaves leaves (4 KB of
// kernel parameters; the model has 63).
//
// Bound on an H100 (ref41: 1,564,424 float32 parameters): the apply reads
// p, g, m and v and writes p, m and v, 28 B a parameter or 43.8 MB; the
// check reads g once more, 6.3 MB: 50.1 MB at 3.35 TB/s is 15 us.  Tiles
// of kTile elements, one block each while the grid has room, keep every SM
// streaming; 16-byte loads where a leaf's four arrays are 16-byte aligned.
//
// Arithmetic: adam_plain's per-element formulas in its order, one IEEE
// rounding per torch op (__fmul_rn and the rest, so that nvcc contracts no
// multiply and add into an FMA), each constant the leaf type's rounding of
// the same Python double, the bias corrections 1 - pow(b, count) in the
// leaf's precision as torch.pow computes them: the same bits as the plain
// version on the card.  The clip's sum of g*g is taken in double in another
// order than torch.sum's, so the clip path agrees to rounding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;       // elements a tile: a multiple of every vector width
constexpr int kMaxLeaves = 80;    // leaves a table
constexpr int kMaxBlocks = 1024;  // blocks a launch, and the check's partial slots

enum LeafFlags : int { kDouble = 1, kVec = 2 };

// ops/adam.py::LEAF, field by field.
struct Leaf {
  void* p;
  const void* g;
  void* m;
  void* v;
  int n;           // elements
  int first_tile;  // tiles of the leaves before this one
  int flags;       // kDouble: float64; kVec: p, g, m and v 16-byte aligned
  int pad;
};

struct Work;

// ops/adam.py::STEP: the launches' parameters.
struct Step {
  Leaf leaf[kMaxLeaves];
  int nleaves, ntiles;
  int skip_nonfinite;  // apply_if_finite on
  int clip_on;         // clip_by_global_norm on
  int any_double;      // some leaf is float64, so the clip's norm is
  int max_errors;      // apply_if_finite's max_consecutive_errors
  double one_minus_b1, b1, one_minus_b2, b2, eps, neg_lr, clip;
  Work* work;
  int* count;
  int* notfinite_count;
  unsigned char* last_finite;  // torch.bool
  int* total_notfinite;
};
static_assert(sizeof(Step) <= 4096, "a launch's parameters are limited to 4 KB");

// The step's device state (ops/adam.py::workspace: WORK_BYTES, zeroed once).
struct Work {
  unsigned int ticket;  // blocks of the running check done
  int apply;            // the decision: the apply writes
  int trigger;          // clip: norm < clip, so g passes as it is
  int pad;
  float bc1f, bc2f, normf, pad_f;
  double bc1d, bc2d, normd;
  unsigned long long part_nonfinite[kMaxBlocks];
  double part_sumsq[kMaxBlocks];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

template <typename T>
struct alignas(16) Vec {
  T x[16 / sizeof(T)];
};

// The leaf that tile t falls in: the last whose first tile is
// at most t (a leaf of no tiles shares its first tile with the next).
__device__ __forceinline__ int find_leaf(const Step& s, int t) {
  int lo = 0, hi = s.nleaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s.leaf[mid].first_tile <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// A block's sum, on thread 0, in a fixed order.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* shared) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) shared[threadIdx.x >> 5] = x;
  __syncthreads();
  T total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += shared[w];
  __syncthreads();
  return total;
}

template <typename T>
__device__ __forceinline__ void look(T x, bool want_sq, unsigned long long& bad, double& sq) {
  bad += !isfinite(x);
  if (want_sq) sq += (double)mul(x, x);
}

template <typename T>
__device__ __forceinline__ void check_tile(const Leaf& L, int lo, int hi, bool want_sq,
                                           unsigned long long& bad, double& sq) {
  constexpr int kV = 16 / sizeof(T);
  const T* __restrict__ g = static_cast<const T*>(L.g);
  int rest = lo;
  if (L.flags & kVec) {
    rest = lo + (hi - lo) / kV * kV;
    for (int j = lo + threadIdx.x * kV; j < rest; j += kThreads * kV) {
      const Vec<T> gv = *reinterpret_cast<const Vec<T>*>(g + j);
#pragma unroll
      for (int k = 0; k < kV; ++k) look(gv.x[k], want_sq, bad, sq);
    }
  }
  for (int j = rest + threadIdx.x; j < hi; j += kThreads) look(g[j], want_sq, bad, sq);
}

// The last check block, from the step's sums: decide, and update the
// counters as adam_plain does.
__device__ __forceinline__ void decide(const Step& s, Work* w, unsigned long long bad, double sq) {
  w->ticket = 0;
  const bool finite = !s.skip_nonfinite || bad == 0;
  const int notfinite = finite ? 0 : *s.notfinite_count + 1;
  const bool apply = finite || notfinite > s.max_errors;
  const int count_inc = *s.count + 1;
  w->apply = apply;
  w->bc1f = __fsub_rn(1.0f, powf((float)s.b1, (float)count_inc));
  w->bc2f = __fsub_rn(1.0f, powf((float)s.b2, (float)count_inc));
  w->bc1d = __dsub_rn(1.0, pow(s.b1, (double)count_inc));
  w->bc2d = __dsub_rn(1.0, pow(s.b2, (double)count_inc));
  if (s.clip_on) {
    w->normd = sqrt(sq);
    w->normf = s.any_double ? (float)w->normd : sqrtf((float)sq);
    w->trigger = s.any_double ? w->normd < s.clip : w->normf < (float)s.clip;
  }
  if (apply) *s.count = count_inc;
  *s.notfinite_count = notfinite;
  *s.last_finite = finite;
  *s.total_notfinite += !finite;
}

__global__ void __launch_bounds__(kThreads) adam_check(const Step s) {
  __shared__ unsigned long long sh_bad[kWarps];
  __shared__ double sh_sq[kWarps];
  __shared__ bool last;
  Work* w = s.work;
  unsigned long long bad = 0;
  double sq = 0.0;
  if (s.skip_nonfinite || s.clip_on) {
    for (int t = blockIdx.x; t < s.ntiles; t += gridDim.x) {
      const Leaf L = s.leaf[find_leaf(s, t)];
      const int lo = (t - L.first_tile) * kTile, hi = min(L.n, lo + kTile);
      if (L.flags & kDouble) check_tile<double>(L, lo, hi, s.clip_on, bad, sq);
      else check_tile<float>(L, lo, hi, s.clip_on, bad, sq);
    }
  }
  bad = block_sum(bad, sh_bad);
  sq = block_sum(sq, sh_sq);
  if (threadIdx.x == 0) {
    w->part_nonfinite[blockIdx.x] = bad;
    w->part_sumsq[blockIdx.x] = sq;
    __threadfence();
    last = atomicAdd(&w->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  bad = 0;
  sq = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    bad += __ldcg(&w->part_nonfinite[b]);
    sq += __ldcg(&w->part_sumsq[b]);
  }
  bad = block_sum(bad, sh_bad);
  sq = block_sum(sq, sh_sq);
  if (threadIdx.x == 0) decide(s, w, bad, sq);
}

// The step's constants in a leaf's precision.
template <typename T>
struct Coef {
  T one_minus_b1, b1, one_minus_b2, b2, eps, neg_lr, clip, bc1, bc2, norm;
  bool scale;  // clip on and not triggered: g -> (g / norm) * clip

  __device__ __forceinline__ Coef(const Step& s, const Work* w)
      : one_minus_b1((T)s.one_minus_b1), b1((T)s.b1), one_minus_b2((T)s.one_minus_b2),
        b2((T)s.b2), eps((T)s.eps), neg_lr((T)s.neg_lr), clip((T)s.clip),
        scale(s.clip_on && !w->trigger) {
    if constexpr (std::is_same<T, float>::value) {
      bc1 = w->bc1f; bc2 = w->bc2f; norm = w->normf;
    } else {
      bc1 = w->bc1d; bc2 = w->bc2d; norm = w->normd;
    }
  }
};

// adam_plain's update of one element, op by op:
//   m_new = (1 - b1) * g + b1 * m;  v_new = (1 - b2) * (g * g) + b2 * v
//   p += -lr * ((m_new / bc1) / (sqrt(v_new / bc2) + eps))
template <typename T>
__device__ __forceinline__ void update(T& p, T g, T& m, T& v, const Coef<T>& c) {
  if (c.scale) g = mul(quot(g, c.norm), c.clip);
  const T m_new = add(mul(c.one_minus_b1, g), mul(c.b1, m));
  const T v_new = add(mul(c.one_minus_b2, mul(g, g)), mul(c.b2, v));
  const T den = add(root(quot(v_new, c.bc2)), c.eps);
  p = add(p, mul(c.neg_lr, quot(quot(m_new, c.bc1), den)));
  m = m_new;
  v = v_new;
}

template <typename T>
__device__ __forceinline__ void apply_tile(const Leaf& L, int lo, int hi, const Coef<T>& c) {
  constexpr int kV = 16 / sizeof(T);
  T* __restrict__ p = static_cast<T*>(L.p);
  const T* __restrict__ g = static_cast<const T*>(L.g);
  T* __restrict__ m = static_cast<T*>(L.m);
  T* __restrict__ v = static_cast<T*>(L.v);
  int rest = lo;
  if (L.flags & kVec) {
    rest = lo + (hi - lo) / kV * kV;
    for (int j = lo + threadIdx.x * kV; j < rest; j += kThreads * kV) {
      Vec<T> pv = *reinterpret_cast<const Vec<T>*>(p + j);
      const Vec<T> gv = *reinterpret_cast<const Vec<T>*>(g + j);
      Vec<T> mv = *reinterpret_cast<const Vec<T>*>(m + j);
      Vec<T> vv = *reinterpret_cast<const Vec<T>*>(v + j);
#pragma unroll
      for (int k = 0; k < kV; ++k) update(pv.x[k], gv.x[k], mv.x[k], vv.x[k], c);
      *reinterpret_cast<Vec<T>*>(p + j) = pv;
      *reinterpret_cast<Vec<T>*>(m + j) = mv;
      *reinterpret_cast<Vec<T>*>(v + j) = vv;
    }
  }
  for (int j = rest + threadIdx.x; j < hi; j += kThreads) {
    T pj = p[j], mj = m[j], vj = v[j];
    update(pj, g[j], mj, vj, c);
    p[j] = pj;
    m[j] = mj;
    v[j] = vj;
  }
}

__global__ void __launch_bounds__(kThreads) adam_apply(const Step s) {
  const Work* w = s.work;
  if (!w->apply) return;
  const Coef<float> cf(s, w);
  const Coef<double> cd(s, w);
  for (int t = blockIdx.x; t < s.ntiles; t += gridDim.x) {
    const Leaf L = s.leaf[find_leaf(s, t)];
    const int lo = (t - L.first_tile) * kTile, hi = min(L.n, lo + kTile);
    if (L.flags & kDouble) apply_tile<double>(L, lo, hi, cd);
    else apply_tile<float>(L, lo, hi, cf);
  }
}

int grid_of(const Step& s) {
  return s.ntiles < 1 ? 1 : (s.ntiles < kMaxBlocks ? s.ntiles : kMaxBlocks);
}

}  // namespace

extern "C" {

// Sizes and limits ops/adam.py checks its layouts against.
int adam_step_bytes() { return (int)sizeof(Step); }
int adam_work_bytes() { return (int)sizeof(Work); }
int adam_tile() { return kTile; }
int adam_max_leaves() { return kMaxLeaves; }
int adam_max_blocks() { return kMaxBlocks; }

// Launches the check, then the apply, on `stream`.  `step` is
// ops/adam.py::pack's STEP record (a plain pointer: a parameter of a type
// in this file's anonymous namespace would hide the symbol).  Returns the
// first launch's error (0 on success).  The caller has checked the leaves;
// nothing is allocated, copied or waited for, so a CUDA graph may record it.
int adam_launch(const void* step, void* stream) {
  const Step& s = *static_cast<const Step*>(step);
  cudaStream_t st = (cudaStream_t)stream;
  adam_check<<<grid_of(s), kThreads, 0, st>>>(s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adam_apply<<<grid_of(s), kThreads, 0, st>>>(s);
  err = cudaGetLastError();
  return (int)err;
}

}  // extern "C"
