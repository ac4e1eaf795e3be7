// Segmented (max,+) depart scan for NVIDIA Hopper (sm_90a).
//
// Replaces: repro/kernels/link_contention/kernel.py::segmented_depart, the
// Pallas TPU kernel that computes, over a stream sorted by channel,
//   depart_i = max(arrive_i, depart_{i-1} on the same channel) + ser_i.
// Item i is the map f_i(x) = max(c_i, x + m_i), c = arrive + ser, m = ser;
// the first item of a channel segment (a head) resets: f_i(x) = c_i.  Maps
// are (c, m, reset) and compose as
//   g after f = g                                         if g resets,
//             = (max(g.c, f.c + g.m), f.m + g.m, f.reset)  otherwise.
//
// The TPU kernel carried the running depart across blocks through scratch
// memory and relied on its grid running in order.  CUDA blocks run in no
// order, so this is the three-phase scan of serve_round.cu:
//   (A) aggregate_kernel: each block composes its items' maps, in order,
//       into one aggregate map (which resets if the block holds a head);
//   (B) carry_kernel: one block turns the aggregates, in order, into each
//       block's incoming depart, starting from NEG (no departure);
//   (C) apply_kernel: each block re-scans its items from its incoming
//       depart and writes every item's depart.
// Each of 256 threads owns 8 consecutive items; a thread reads the channel
// of the item before its first to find its heads.  Everything is int64 with
// no rebase and no span limit: (max,+) with a reset is associative in exact
// integer arithmetic, so the regrouping is exact.  The stream's first item is
// always a head.  The channel column may be int64 or int32.
//
// Bound on the H100: memory.  The function reads channel, arrive and ser and
// writes depart: 32 B per item with an int64 channel, 28 B with int32.  This
// design reads the inputs in both A and C (C keeps a thread's maps in
// registers between its aggregate and its apply loop), about 56 B per item
// with an int64 channel, in three dependent launches, so at the engine's
// round sizes (a few hundred thousand items, about one block per SM) it is
// bound by latency, not bandwidth.  The design does nothing about that yet:
// a single-pass decoupled look-back scan is later work.
//
// Interface: plain C, called through ctypes on PyTorch's current stream;
// every launch is checked with cudaGetLastError and the first error code is
// returned (0 = success).  The caller allocates out, agg (3 per block) and
// state (1 per block).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr long long NEG = -(1LL << 62);
constexpr int THREADS = 256;
constexpr int ITEMS = 8;

struct Map {
  long long c, m;
  bool r;
};

template <typename C>
struct Stream {
  const C* chan;
  const long long* arrive;
  const long long* ser;
};

__device__ __forceinline__ Map identity_map() {
  Map f;
  f.c = NEG;
  f.m = 0;
  f.r = false;
  return f;
}

// g applied after f
__device__ __forceinline__ Map compose(const Map& g, const Map& f) {
  if (g.r) return g;
  Map o;
  const long long x = f.c + g.m;
  o.c = g.c > x ? g.c : x;
  o.m = f.m + g.m;
  o.r = f.r;
  return o;
}

__device__ __forceinline__ long long apply_map(const Map& f, long long x) {
  if (f.r) return f.c;
  const long long y = x + f.m;
  return f.c > y ? f.c : y;
}

// This thread's items, read once into registers (entries past k unset).
template <typename C>
__device__ __forceinline__ void load_items(const Stream<C>& in,
                                           long long first, long long k,
                                           Map* m) {
  C prev = first > 0 && first < k ? in.chan[first - 1] : C(0);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const long long i = first + j;
    if (i < k) {
      const C cur = in.chan[i];
      const long long s = in.ser[i];
      m[j].c = in.arrive[i] + s;
      m[j].m = s;
      m[j].r = i == 0 || cur != prev;
      prev = cur;
    }
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

template <typename C>
__global__ void __launch_bounds__(THREADS)
aggregate_kernel(Stream<C> in, long long k, long long* agg) {
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
    long long* o = agg + 3 * static_cast<long long>(blockIdx.x);
    o[0] = sm[0].c;
    o[1] = sm[0].m;
    o[2] = sm[0].r ? 1 : 0;
  }
}

__global__ void __launch_bounds__(THREADS)
carry_kernel(const long long* agg, long long n_blocks, long long* state) {
  __shared__ Map sm[THREADS];
  __shared__ long long carry;
  const int t = threadIdx.x;
  if (t == 0) carry = NEG;
  __syncthreads();
  for (long long base = 0; base < n_blocks; base += THREADS) {
    const long long b = base + t;
    Map a = identity_map();
    if (b < n_blocks) {
      const long long* g = agg + 3 * b;
      a.c = g[0];
      a.m = g[1];
      a.r = g[2] != 0;
    }
    sm[t] = a;
    __syncthreads();
    block_inclusive_scan(sm);
    const long long in = carry;
    if (b < n_blocks) state[b] = t == 0 ? in : apply_map(sm[t - 1], in);
    __syncthreads();
    if (t == 0) carry = apply_map(sm[THREADS - 1], in);
    __syncthreads();
  }
}

template <typename C>
__global__ void __launch_bounds__(THREADS)
apply_kernel(Stream<C> in, long long k, const long long* state,
             long long* out) {
  __shared__ Map sm[THREADS];
  const int t = threadIdx.x;
  const long long first =
      (static_cast<long long>(blockIdx.x) * THREADS + t) * ITEMS;
  Map m[ITEMS];
  load_items(in, first, k, m);
  sm[t] = thread_aggregate(m, first, k);
  __syncthreads();
  block_inclusive_scan(sm);
  long long v = state[blockIdx.x];
  if (t > 0) v = apply_map(sm[t - 1], v);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (first + j < k) {
      v = apply_map(m[j], v);
      out[first + j] = v;
    }
  }
}

constexpr long long BLOCK_ITEMS = static_cast<long long>(THREADS) * ITEMS;

template <typename C>
int launch(const C* chan, const long long* arrive, const long long* ser,
           long long* out, long long k, long long* agg, long long* state,
           cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Stream<C> in{chan, arrive, ser};
  const long long n_blocks = (k + BLOCK_ITEMS - 1) / BLOCK_ITEMS;
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(n_blocks);

  aggregate_kernel<C><<<grid, THREADS, 0, stream>>>(in, k, agg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  carry_kernel<<<1, THREADS, 0, stream>>>(agg, n_blocks, state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_kernel<C><<<grid, THREADS, 0, stream>>>(in, k, state, out);
  err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// Items one block scans: the caller sizes agg and state from it.
extern "C" long long segmented_depart_block_items(void) {
  return BLOCK_ITEMS;
}

extern "C" int segmented_depart_launch_i64(const long long* chan,
                                           const long long* arrive,
                                           const long long* ser,
                                           long long* out, long long k,
                                           long long* agg, long long* state,
                                           cudaStream_t stream) {
  return launch(chan, arrive, ser, out, k, agg, state, stream);
}

extern "C" int segmented_depart_launch_i32(const int* chan,
                                           const long long* arrive,
                                           const long long* ser,
                                           long long* out, long long k,
                                           long long* agg, long long* state,
                                           cudaStream_t stream) {
  return launch(chan, arrive, ser, out, k, agg, state, stream);
}
