// Serve-round (max,+) affine-map scan for NVIDIA Hopper (sm_90a).
//
// Replaces: repro/kernels/serve_round/kernel.py::serve_scan, the Pallas TPU
// kernel that computes one fixpoint round of the schedule engine as an
// inclusive scan of 2x2 (max,+) affine maps over the channel state
// v = (depart, down):  v' = M (x) v (+) c, saturated at NEG.
//
// The TPU kernel carried the state across blocks through scratch memory and
// relied on its grid running in order.  CUDA blocks run in no order, so this
// is a three-phase scan:
//   (A) aggregate_kernel: each block composes its items' maps, in order,
//       into one aggregate map;
//   (B) carry_kernel: one block turns the aggregates, in order, into each
//       block's incoming state, starting from (NEG, NEG);
//   (C) apply_kernel: each block re-scans its items from its incoming state
//       and writes every item's depart component.
// Inside a block, each of 256 threads owns 8 consecutive items; thread
// aggregates are combined in shared memory.  All arithmetic is int64 with
// NEG = -2^62: NEG + NEG is exactly INT64_MIN (no overflow) and every sum is
// clamped back to NEG at once.  Regrouping the compositions is exact on the
// well-formed maps the ops wrapper emits (head / serving / marker /
// pass-through): finite entries are computed exactly and -inf entries stay
// far below any real time.
//
// Bound on the H100: memory.  The function reads six int64 map components
// and writes one int64 per item: 56 B per item at least.  This design moves
// about 104 B per item: phases A and C each read the maps once (C keeps a
// thread's 8 maps in registers from its aggregate to its apply loop), and C
// writes the output.  At K = 268,800
// that is 15 to 28 MB, about 5 to 8 us at 3.35 TB/s; with three dependent
// launches and one block per SM at that size the kernel is bound by latency
// instead (28 us of device time on an H100 SXM at 700 W, chip_smoke.py).
// The design does nothing about that yet: a single-pass decoupled
// look-back scan is later work.
//
// Interface: plain C, called through ctypes on PyTorch's current stream;
// every launch is checked with cudaGetLastError and the first error code is
// returned (0 = success).  The caller allocates out, agg (6 per block) and
// state (2 per block).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr long long NEG = -(1LL << 62);
constexpr int THREADS = 256;
constexpr int ITEMS = 8;  // consecutive items per thread

struct Map {
  long long m00, m01, m10, m11, c0, c1;
};

struct State {
  long long d, w;
};

struct Maps {
  const long long* m00;
  const long long* m01;
  const long long* m10;
  const long long* m11;
  const long long* c0;
  const long long* c1;
};

__device__ __forceinline__ long long mx(long long a, long long b) {
  const long long m = a > b ? a : b;
  return m < NEG ? NEG : m;
}

__device__ __forceinline__ Map identity_map() {
  Map r;
  r.m00 = 0;
  r.m01 = NEG;
  r.m10 = NEG;
  r.m11 = 0;
  r.c0 = NEG;
  r.c1 = NEG;
  return r;
}

__device__ __forceinline__ Map load_map(const Maps& in, long long i) {
  Map r;
  r.m00 = in.m00[i];
  r.m01 = in.m01[i];
  r.m10 = in.m10[i];
  r.m11 = in.m11[i];
  r.c0 = in.c0[i];
  r.c1 = in.c1[i];
  return r;
}

// m applied after p: (M, c) . (P, q) = (M (x) P, M (x) q (+) c)
__device__ __forceinline__ Map compose(const Map& m, const Map& p) {
  Map r;
  r.m00 = mx(m.m00 + p.m00, m.m01 + p.m10);
  r.m01 = mx(m.m00 + p.m01, m.m01 + p.m11);
  r.m10 = mx(m.m10 + p.m00, m.m11 + p.m10);
  r.m11 = mx(m.m10 + p.m01, m.m11 + p.m11);
  r.c0 = mx(mx(m.m00 + p.c0, m.m01 + p.c1), m.c0);
  r.c1 = mx(mx(m.m10 + p.c0, m.m11 + p.c1), m.c1);
  return r;
}

__device__ __forceinline__ State apply_map(const Map& m, const State& v) {
  State r;
  r.d = mx(mx(m.m00 + v.d, m.m01 + v.w), m.c0);
  r.w = mx(mx(m.m10 + v.d, m.m11 + v.w), m.c1);
  return r;
}

// This thread's items, read once into registers (entries past k unset).
__device__ __forceinline__ void load_items(const Maps& in, long long first,
                                           long long k, Map* m) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (first + j < k) m[j] = load_map(in, first + j);
  }
}

// Composition of this thread's items, in order.
__device__ __forceinline__ Map thread_aggregate(const Map* m, long long first,
                                                long long k) {
  Map a = identity_map();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (first + j < k) a = compose(m[j], a);
  }
  return a;
}

// In-place inclusive Hillis-Steele scan of sm[0..THREADS) (every thread of
// the block must call it).
__device__ __forceinline__ void block_inclusive_scan(Map* sm) {
  const int t = threadIdx.x;
  for (int off = 1; off < THREADS; off <<= 1) {
    const Map p = t >= off ? sm[t - off] : identity_map();
    __syncthreads();
    if (t >= off) sm[t] = compose(sm[t], p);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
aggregate_kernel(Maps in, long long k, long long* agg) {
  __shared__ Map sm[THREADS];
  const int t = threadIdx.x;
  const long long first =
      (static_cast<long long>(blockIdx.x) * THREADS + t) * ITEMS;
  Map m[ITEMS];
  load_items(in, first, k, m);
  sm[t] = thread_aggregate(m, first, k);
  __syncthreads();
  for (int stride = 1; stride < THREADS; stride <<= 1) {
    if (t % (2 * stride) == 0) sm[t] = compose(sm[t + stride], sm[t]);
    __syncthreads();
  }
  if (t == 0) {
    long long* o = agg + 6 * static_cast<long long>(blockIdx.x);
    o[0] = sm[0].m00;
    o[1] = sm[0].m01;
    o[2] = sm[0].m10;
    o[3] = sm[0].m11;
    o[4] = sm[0].c0;
    o[5] = sm[0].c1;
  }
}

__global__ void __launch_bounds__(THREADS)
carry_kernel(const long long* agg, long long n_blocks, long long* state) {
  __shared__ Map sm[THREADS];
  __shared__ State carry;
  const int t = threadIdx.x;
  if (t == 0) {
    carry.d = NEG;
    carry.w = NEG;
  }
  __syncthreads();
  for (long long base = 0; base < n_blocks; base += THREADS) {
    const long long b = base + t;
    Map a = identity_map();
    if (b < n_blocks) {
      const long long* g = agg + 6 * b;
      a.m00 = g[0];
      a.m01 = g[1];
      a.m10 = g[2];
      a.m11 = g[3];
      a.c0 = g[4];
      a.c1 = g[5];
    }
    sm[t] = a;
    __syncthreads();
    block_inclusive_scan(sm);
    const State in = carry;
    if (b < n_blocks) {
      const State s = t == 0 ? in : apply_map(sm[t - 1], in);
      state[2 * b] = s.d;
      state[2 * b + 1] = s.w;
    }
    __syncthreads();
    if (t == 0) carry = apply_map(sm[THREADS - 1], in);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
apply_kernel(Maps in, long long k, const long long* state, long long* out) {
  __shared__ Map sm[THREADS];
  const int t = threadIdx.x;
  const long long first =
      (static_cast<long long>(blockIdx.x) * THREADS + t) * ITEMS;
  Map m[ITEMS];
  load_items(in, first, k, m);
  sm[t] = thread_aggregate(m, first, k);
  __syncthreads();
  block_inclusive_scan(sm);
  State v;
  v.d = state[2 * static_cast<long long>(blockIdx.x)];
  v.w = state[2 * static_cast<long long>(blockIdx.x) + 1];
  if (t > 0) v = apply_map(sm[t - 1], v);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (first + j < k) {
      v = apply_map(m[j], v);
      out[first + j] = v.d;
    }
  }
}

constexpr long long BLOCK_ITEMS = static_cast<long long>(THREADS) * ITEMS;

}  // namespace

// Items one block scans: the caller sizes agg and state from it.
extern "C" long long serve_scan_block_items(void) { return BLOCK_ITEMS; }

extern "C" int serve_scan_launch(const long long* m00, const long long* m01,
                                 const long long* m10, const long long* m11,
                                 const long long* c0, const long long* c1,
                                 long long* out, long long k, long long* agg,
                                 long long* state, cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Maps in{m00, m01, m10, m11, c0, c1};
  const long long n_blocks = (k + BLOCK_ITEMS - 1) / BLOCK_ITEMS;
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(n_blocks);

  aggregate_kernel<<<grid, THREADS, 0, stream>>>(in, k, agg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  carry_kernel<<<1, THREADS, 0, stream>>>(agg, n_blocks, state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_kernel<<<grid, THREADS, 0, stream>>>(in, k, state, out);
  err = cudaGetLastError();
  return static_cast<int>(err);
}
