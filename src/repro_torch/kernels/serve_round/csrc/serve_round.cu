// Serve round of the schedule engine for NVIDIA Hopper (sm_90a).
//
// Replaces: repro/kernels/serve_round/kernel.py::serve_scan, the Pallas TPU
// kernel that computes one fixpoint round of the schedule engine as an
// inclusive scan of 2x2 (max,+) affine maps over the channel state
// v = (depart, down):  v' = M (x) v (+) c, saturated at NEG.  Its JAX
// wrapper built the maps beforehand with whole-array operations (a pre-pass
// of running-max index gathers); this file does the whole round.
//
// Two entry points share the device code:
//
// * serve_round_launch, the fused round: from the fifteen sorted operands of
//   one engine round to the masked (start, depart, stall) of every item, in
//   five launches and no other operation:
//     (A) round_last_kernel: each block folds its items into one "last
//         present" aggregate (the channel of its last active item; the
//         channel and direction of its last serving item; the channel and
//         row of its last serving item with a DRAM row) and the minimum of
//         its arrivals;
//     (B) round_last_carry_kernel: one block turns those aggregates, in
//         order, into each block's incoming "last" state, and reduces the
//         minima to the round's base arrival;
//     (C) round_maps_kernel: each block scans its threads' "last"
//         aggregates, builds every item's map from the state before it
//         (head, turnaround gap, row hit or miss, the seed folded into a
//         head), scans its threads' map aggregates, and leaves each thread
//         its incoming "last" state and the composition of the maps before
//         it in the block (ThreadPrefix), and the block's aggregate map;
//     (D) carry_kernel: one block turns the aggregate maps, in order, into
//         each block's incoming (depart, down) state;
//     (E) round_finish_kernel: each thread, with no block-level step,
//         rebuilds its items' maps from its prefix, applies them from its
//         incoming state and writes start, depart and stall, with the
//         finish fused in (the depart an item's stall is measured against
//         is the running state before it, held by the thread).
//   An item's lookups are "last present" states, so no index and no gather
//   is needed: the state before item i holds the values of the last item
//   of each kind before i, and the item compares that item's channel with
//   its own.
// * serve_scan_launch, the map-only scan (the maps of ref.item_maps given),
//   in three launches: block aggregates, D, and a re-scan of each block
//   (aggregate_kernel, carry_kernel, apply_kernel).
//
// CUDA blocks run in no order, so every cross-block state goes through a
// one-block pass over the block aggregates (B and D: each thread composes a
// run of consecutive aggregates, one scan over the runs, each thread walks
// its run), where the TPU kernel carried it from grid step to grid step in
// scratch memory.  Inside a block each of 256 threads owns consecutive
// items (2 in the fused round, read as one vector load per operand array,
// so a warp's load is one contiguous span; 8 in the map-only scan, held in
// registers); thread aggregates are combined in shared memory.  All
// arithmetic is int64 with NEG = -2^62: NEG + NEG is exactly INT64_MIN (no
// overflow) and every sum is clamped back to NEG at once.  Regrouping the
// compositions is exact on well-formed maps (head / serving / marker /
// pass-through): finite entries are computed exactly and -inf entries stay
// far below any real time; "last present" states compose exactly under any
// grouping.  The round's base (minimum arrival) and the seed clamps follow
// the plain version (ref.item_maps) operation for operation, so every
// output equals it bit for bit.  ref.serve_round_blocked and
// ref.serve_scan_blocked run the same decompositions on the CPU.
//
// Bound on the H100: memory.  The fused round reads 84 B of operands per
// item (chan, arrive and the seven int64 times 8 B each, row and sd_row
// 4 B, serving, marker, direction and sd_dir 1 B) and writes 24 B: 108 B
// per item, 8.7 us at K = 268,800 over 3.35 TB/s.  This design reads 23 B
// per item in A (what the lookups and the base need) and every operand in C
// and E, and passes 88 B of prefix per thread (44 B per item) from C to E:
// about 300 B per item, in five dependent launches.  The map-only scan
// reads six int64 components and writes one: 56 B per item, moved about
// twice.
//
// Interface: plain C, called through ctypes on PyTorch's current stream;
// every launch is checked with cudaGetLastError and the first error code is
// returned (0 = success).  The caller allocates the outputs and the scratch
// (serve_round_scratch_words, serve_scan's agg and state).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr long long NEG = -(1LL << 62);
constexpr int THREADS = 256;
// consecutive items per thread: the map-only scan holds a thread's maps in
// registers; the fused round reads a thread's operands as pairs, one vector
// load per array
constexpr int ITEMS = 8;
constexpr int ROUND_ITEMS = 2;
constexpr long long BLOCK_ITEMS = static_cast<long long>(THREADS) * ITEMS;
constexpr long long ROUND_BLOCK_ITEMS =
    static_cast<long long>(THREADS) * ROUND_ITEMS;
// threads of the one-block passes over the block aggregates
constexpr int PASS_THREADS = 1024;

__device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ long long sat(long long a) {
  return a < NEG ? NEG : a;
}

__device__ __forceinline__ long long mx(long long a, long long b) {
  return sat(lmax(a, b));
}

// ---------------------------------------------------------------------------
// (max,+) maps over the state (depart, down)
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// "last present" lookups of the fused round
// ---------------------------------------------------------------------------

constexpr int HAS_ACT = 1;  // an active (serving or marker) item
constexpr int HAS_SRV = 2;  // a serving item
constexpr int HAS_ROW = 4;  // a serving item with a DRAM row (row >= 0)

// The values of the last item of each kind in a run of items; composing
// keeps the later run's value of every kind it holds.
struct Last {
  long long act_chan, srv_chan, row_chan;
  int srv_dir, row_row;
  int has;
};

__device__ __forceinline__ Last no_last() {
  Last r;
  r.act_chan = r.srv_chan = r.row_chan = 0;
  r.srv_dir = r.row_row = 0;
  r.has = 0;
  return r;
}

// m after p
__device__ __forceinline__ Last compose(const Last& m, const Last& p) {
  Last r = p;
  if (m.has & HAS_ACT) r.act_chan = m.act_chan;
  if (m.has & HAS_SRV) {
    r.srv_chan = m.srv_chan;
    r.srv_dir = m.srv_dir;
  }
  if (m.has & HAS_ROW) {
    r.row_chan = m.row_chan;
    r.row_row = m.row_row;
  }
  r.has = m.has | p.has;
  return r;
}

// The operands of one round, sorted by (channel, arrival, flat index), in
// ops.serve_round's order; bool as one byte, int8 direction and seed
// direction, int32 rows.  Every array is aligned to two items (the wrapper
// checks), so a thread reads its two items in one load.
struct Round {
  const long long* chan;
  const unsigned char* serving;
  const unsigned char* marker;
  const long long* arrive;
  const signed char* direction;
  const int* row;
  const long long* ser;
  const long long* turn;
  const long long* rhit;
  const long long* rmiss;
  const long long* retrain;
  const long long* sd_dep;
  const signed char* sd_dir;
  const int* sd_row;
  const long long* sd_down;
};

// One item's operands, in registers.
struct Ops {
  long long chan, arrive, ser, turn, rhit, rmiss, retrain, sd_dep, sd_down;
  int row, sd_row, dir, sd_dir;
  bool serving, marker;
};

// Items i and i + 1 (i even) of one array into o[0].f, o[1].f: one vector
// load when both exist, else item i alone.
#define LOAD_PAIR(VEC, arr, field)                                   \
  do {                                                               \
    if (i + 1 < k) {                                                 \
      const VEC x = *reinterpret_cast<const VEC*>(arr + i);          \
      o[0].field = x.x;                                              \
      o[1].field = x.y;                                              \
    } else {                                                         \
      o[0].field = arr[i];                                           \
    }                                                                \
  } while (0)

// What the lookups need of items i, i + 1 (those below k).
__device__ __forceinline__ void load_lookup_ops(const Round& in, long long i,
                                                long long k, Ops* o) {
  LOAD_PAIR(longlong2, in.chan, chan);
  LOAD_PAIR(uchar2, in.serving, serving);
  LOAD_PAIR(uchar2, in.marker, marker);
  LOAD_PAIR(char2, in.direction, dir);
  LOAD_PAIR(int2, in.row, row);
}

// Every operand of items i, i + 1 (those below k).
__device__ __forceinline__ void load_ops(const Round& in, long long i,
                                         long long k, Ops* o) {
  load_lookup_ops(in, i, k, o);
  LOAD_PAIR(longlong2, in.arrive, arrive);
  LOAD_PAIR(longlong2, in.ser, ser);
  LOAD_PAIR(longlong2, in.turn, turn);
  LOAD_PAIR(longlong2, in.rhit, rhit);
  LOAD_PAIR(longlong2, in.rmiss, rmiss);
  LOAD_PAIR(longlong2, in.retrain, retrain);
  LOAD_PAIR(longlong2, in.sd_dep, sd_dep);
  LOAD_PAIR(char2, in.sd_dir, sd_dir);
  LOAD_PAIR(int2, in.sd_row, sd_row);
  LOAD_PAIR(longlong2, in.sd_down, sd_down);
}

#undef LOAD_PAIR

__device__ __forceinline__ Last item_last(const Ops& o) {
  const bool act = o.serving || o.marker;
  Last r;
  r.act_chan = r.srv_chan = r.row_chan = o.chan;
  r.srv_dir = o.dir;
  r.row_row = o.row;
  r.has = (act ? HAS_ACT : 0) | (o.serving ? HAS_SRV : 0) |
          (o.serving && o.row >= 0 ? HAS_ROW : 0);
  return r;
}

// What the finish needs of an item besides its map.
struct Item {
  long long s, gap;
  bool head;
};

// An item's map (times relative to base) from the "last" state before it:
// ref.item_maps, operation for operation.
__device__ __forceinline__ Map item_map(const Ops& o, const Last& last,
                                        long long base, Item& it) {
  const bool head = (o.serving || o.marker) &&
                    !((last.has & HAS_ACT) && last.act_chan == o.chan);
  const long long dirn = o.dir;
  const long long eff_dir = (last.has & HAS_SRV) && last.srv_chan == o.chan
                                ? static_cast<long long>(last.srv_dir)
                                : static_cast<long long>(o.sd_dir);
  const long long row = o.row;
  const long long eff_row = (last.has & HAS_ROW) && last.row_chan == o.chan
                                ? static_cast<long long>(last.row_row)
                                : static_cast<long long>(o.sd_row);
  const long long gap = eff_dir != -1 && dirn != eff_dir ? o.turn : 0;
  const long long rx = row >= 0 ? (row == eff_row ? o.rhit : o.rmiss) : 0;
  const long long s = o.ser + rx;
  const long long arr = o.arrive - base;
  // seed clamps: a depart seed below base - turn / a down seed below base
  // never binds
  const long long sdep = lmax(o.sd_dep, base - o.turn) - base;
  const long long sdwn = lmax(o.sd_down, base) - base;
  const long long rp = o.retrain > 0 ? o.retrain : NEG;  // NEG = no retrain
  Map m;
  if (o.serving) {
    // depart' = max(arr+s, depart+gap+s, down+s);
    // down'   = max(down, depart' + retrain?)
    m.m00 = gap + s;
    m.m01 = s;
    m.c0 = arr + s;
    m.m10 = sat(m.m00 + rp);
    m.m11 = lmax(s + rp, 0);
    m.c1 = sat(m.c0 + rp);
  } else {
    // marker: depart' = depart; down' = max(down, arr + retrain)
    m.m00 = 0;
    m.m01 = NEG;
    m.c0 = NEG;
    m.m10 = NEG;
    m.m11 = 0;
    m.c1 = o.marker ? arr + o.retrain : NEG;
  }
  if (head) {
    // fold the seed state into c and kill the incoming state
    const long long h0 = lmax(lmax(m.m00 + sdep, m.m01 + sdwn), m.c0);
    const long long h1 = lmax(lmax(m.m10 + sdep, m.m11 + sdwn), m.c1);
    m.c0 = sat(h0);
    m.c1 = sat(h1);
    m.m00 = m.m01 = m.m10 = m.m11 = NEG;
  }
  it.s = s;
  it.gap = gap;
  it.head = head;
  return m;
}

// ---------------------------------------------------------------------------
// block-level building blocks (every thread of the block must call them)
// ---------------------------------------------------------------------------

// In-place inclusive Hillis-Steele scan of sm[0..THREADS), filled and
// synchronised by the caller.
template <typename T>
__device__ __forceinline__ void block_inclusive_scan(T* sm, const T& ident) {
  const int t = threadIdx.x;
  for (int off = 1; off < THREADS; off <<= 1) {
    const T p = t >= off ? sm[t - off] : ident;
    __syncthreads();
    if (t >= off) sm[t] = compose(sm[t], p);
    __syncthreads();
  }
}

// Pairwise tree over sm[0..THREADS), filled and synchronised by the
// caller; the block's aggregate ends in sm[0].
template <typename T>
__device__ __forceinline__ void block_tree(T* sm) {
  const int t = threadIdx.x;
  for (int stride = 1; stride < THREADS; stride <<= 1) {
    if (t % (2 * stride) == 0) sm[t] = compose(sm[t + stride], sm[t]);
    __syncthreads();
  }
}

__device__ __forceinline__ long long shfl_up(long long x, int off) {
  return __shfl_up_sync(0xffffffffu, x, off);
}

__device__ __forceinline__ int shfl_up(int x, int off) {
  return __shfl_up_sync(0xffffffffu, x, off);
}

__device__ __forceinline__ Map shfl_up(const Map& m, int off) {
  Map r;
  r.m00 = shfl_up(m.m00, off);
  r.m01 = shfl_up(m.m01, off);
  r.m10 = shfl_up(m.m10, off);
  r.m11 = shfl_up(m.m11, off);
  r.c0 = shfl_up(m.c0, off);
  r.c1 = shfl_up(m.c1, off);
  return r;
}

__device__ __forceinline__ Last shfl_up(const Last& m, int off) {
  Last r;
  r.act_chan = shfl_up(m.act_chan, off);
  r.srv_chan = shfl_up(m.srv_chan, off);
  r.row_chan = shfl_up(m.row_chan, off);
  r.srv_dir = shfl_up(m.srv_dir, off);
  r.row_row = shfl_up(m.row_row, off);
  r.has = shfl_up(m.has, off);
  return r;
}

// Inclusive scan of one value per thread over a block of NT threads, in
// thread order: Hillis-Steele inside each warp (shuffles), Hillis-Steele
// over the warp totals (warp 0), and each warp's exclusive total composed
// under its threads.  Returns the thread's inclusive value and sets `excl`
// to the composition of the threads before it (left unset for thread 0).
// tot: __shared__ T[NT / 32].  Every thread of the block must call it.
template <int NT, typename T>
__device__ __forceinline__ T block_scan(T v, T* tot, T& excl) {
  constexpr int NW = NT / 32;
  static_assert(NT % 32 == 0 && NW <= 32, "one warp scans the warp totals");
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int w = t / 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T p = shfl_up(v, off);
    if (lane >= off) v = compose(v, p);
  }
  const T before = shfl_up(v, 1);
  if (lane == 31) tot[w] = v;
  __syncthreads();
  if (w == 0) {
    T x = tot[lane < NW ? lane : 0];
#pragma unroll
    for (int off = 1; off < NW; off <<= 1) {
      const T p = shfl_up(x, off);
      if (lane >= off) x = compose(x, p);
    }
    if (lane < NW) tot[lane] = x;
  }
  __syncthreads();
  if (w > 0) {
    const T wp = tot[w - 1];
    excl = lane > 0 ? compose(before, wp) : wp;
    v = compose(v, wp);
  } else if (lane > 0) {
    excl = before;
  }
  return v;
}

__device__ __forceinline__ long long first_item(int items) {
  return (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) *
         items;
}

// The run of block aggregates [b0, b1) one thread of a one-block pass owns:
// runs of ceil(n_blocks / PASS_THREADS) in order.
__device__ __forceinline__ void thread_run(long long n_blocks, long long& b0,
                                           long long& b1) {
  const long long per = (n_blocks + PASS_THREADS - 1) / PASS_THREADS;
  b0 = lmin(n_blocks, threadIdx.x * per);
  b1 = lmin(n_blocks, b0 + per);
}

// ---------------------------------------------------------------------------
// the fused round
// ---------------------------------------------------------------------------

// What phase C leaves each thread of the fused round for phase E: the
// "last" state before its first item and the composition of the maps
// before it in its block, as one array per field (thread-major, so a warp's
// store and load of a field is one contiguous span).
struct Prefix {
  long long* word;  // 9 arrays: act_chan, srv_chan, row_chan, the 6 map words
  int* half;        // 3 arrays: srv_dir, row_row, has
  long long n;      // threads of the grid

  __device__ __forceinline__ void store(long long i, const Last& l,
                                        const Map& m) const {
    const long long w[9] = {l.act_chan, l.srv_chan, l.row_chan, m.m00,
                            m.m01,      m.m10,      m.m11,      m.c0,
                            m.c1};
#pragma unroll
    for (int f = 0; f < 9; ++f) word[f * n + i] = w[f];
    half[i] = l.srv_dir;
    half[n + i] = l.row_row;
    half[2 * n + i] = l.has;
  }

  __device__ __forceinline__ void load(long long i, Last& l, Map& m) const {
    l.act_chan = word[i];
    l.srv_chan = word[n + i];
    l.row_chan = word[2 * n + i];
    m.m00 = word[3 * n + i];
    m.m01 = word[4 * n + i];
    m.m10 = word[5 * n + i];
    m.m11 = word[6 * n + i];
    m.c0 = word[7 * n + i];
    m.c1 = word[8 * n + i];
    l.srv_dir = half[i];
    l.row_row = half[n + i];
    l.has = half[2 * n + i];
  }
};

__global__ void __launch_bounds__(THREADS)
round_last_kernel(Round in, long long k, Last* last_agg,
                  long long* min_arrive) {
  __shared__ Last sl[THREADS];
  __shared__ long long smin[THREADS];
  const int t = threadIdx.x;
  const long long first = first_item(ROUND_ITEMS);
  Last a = no_last();
  long long mn = LLONG_MAX;
  if (first < k) {
    Ops o[ROUND_ITEMS];
    const long long i = first;
    load_lookup_ops(in, i, k, o);
    if (i + 1 < k) {
      const longlong2 x = *reinterpret_cast<const longlong2*>(in.arrive + i);
      mn = lmin(x.x, x.y);
    } else {
      mn = in.arrive[i];
    }
#pragma unroll
    for (int j = 0; j < ROUND_ITEMS; ++j) {
      if (first + j < k) a = compose(item_last(o[j]), a);
    }
  }
  sl[t] = a;
  smin[t] = mn;
  __syncthreads();
  for (int stride = 1; stride < THREADS; stride <<= 1) {
    if (t % (2 * stride) == 0) {
      sl[t] = compose(sl[t + stride], sl[t]);
      smin[t] = lmin(smin[t], smin[t + stride]);
    }
    __syncthreads();
  }
  if (t == 0) {
    last_agg[blockIdx.x] = sl[0];
    min_arrive[blockIdx.x] = smin[0];
  }
}

__global__ void __launch_bounds__(PASS_THREADS)
round_last_carry_kernel(const Last* last_agg, const long long* min_arrive,
                        long long n_blocks, Last* last_in, long long* base) {
  __shared__ Last tot[PASS_THREADS / 32];
  __shared__ long long smin[PASS_THREADS];
  const int t = threadIdx.x;
  long long b0, b1;
  thread_run(n_blocks, b0, b1);
  Last a = no_last();
  long long mn = LLONG_MAX;
  for (long long b = b0; b < b1; ++b) {
    a = compose(last_agg[b], a);
    mn = lmin(mn, min_arrive[b]);
  }
  smin[t] = mn;
  Last c;
  block_scan<PASS_THREADS>(a, tot, c);
  if (t == 0) c = no_last();
  for (long long b = b0; b < b1; ++b) {
    last_in[b] = c;
    c = compose(last_agg[b], c);
  }
  for (int stride = 1; stride < PASS_THREADS; stride <<= 1) {
    if (t % (2 * stride) == 0) smin[t] = lmin(smin[t], smin[t + stride]);
    __syncthreads();
  }
  if (t == 0) *base = smin[0];
}

__global__ void __launch_bounds__(THREADS)
round_maps_kernel(Round in, long long k, const Last* last_in,
                  const long long* base_p, long long* agg, Prefix prefix) {
  __shared__ Last ltot[THREADS / 32];
  __shared__ Map mtot[THREADS / 32];
  const int t = threadIdx.x;
  const long long first = first_item(ROUND_ITEMS);
  const long long base = *base_p;
  Ops o[ROUND_ITEMS];
  Last a = no_last();
  if (first < k) {
    load_ops(in, first, k, o);
#pragma unroll
    for (int j = 0; j < ROUND_ITEMS; ++j) {
      if (first + j < k) a = compose(item_last(o[j]), a);
    }
  }
  Last before;
  block_scan<THREADS>(a, ltot, before);
  const Last block_in = last_in[blockIdx.x];
  const Last start = t == 0 ? block_in : compose(before, block_in);
  Last last = start;
  Map m = identity_map();
#pragma unroll
  for (int j = 0; j < ROUND_ITEMS; ++j) {
    if (first + j < k) {
      Item it;
      m = compose(item_map(o[j], last, base, it), m);
      last = compose(item_last(o[j]), last);
    }
  }
  Map maps_before = identity_map();
  m = block_scan<THREADS>(m, mtot, maps_before);
  prefix.store(static_cast<long long>(blockIdx.x) * THREADS + t, start,
               maps_before);
  if (t == THREADS - 1) {
    long long* g = agg + 6 * static_cast<long long>(blockIdx.x);
    g[0] = m.m00;
    g[1] = m.m01;
    g[2] = m.m10;
    g[3] = m.m11;
    g[4] = m.c0;
    g[5] = m.c1;
  }
}

// No block-level step: each thread starts from what phase C left it.
__global__ void __launch_bounds__(THREADS)
round_finish_kernel(Round in, long long k, Prefix prefix,
                    const long long* base_p, const long long* state,
                    long long* out_start, long long* out_depart,
                    long long* out_stall) {
  const int t = threadIdx.x;
  const long long first = first_item(ROUND_ITEMS);
  if (first >= k) return;
  const long long base = *base_p;
  Last last;
  Map maps_before;
  prefix.load(static_cast<long long>(blockIdx.x) * THREADS + t, last,
               maps_before);
  State v;
  v.d = state[2 * static_cast<long long>(blockIdx.x)];
  v.w = state[2 * static_cast<long long>(blockIdx.x) + 1];
  if (t > 0) v = apply_map(maps_before, v);
  Ops o[ROUND_ITEMS];
  load_ops(in, first, k, o);
  long long start[ROUND_ITEMS], depart[ROUND_ITEMS], stall[ROUND_ITEMS];
#pragma unroll
  for (int j = 0; j < ROUND_ITEMS; ++j) {
    const long long i = first + j;
    if (i < k) {
      Item it;
      const Map m = item_map(o[j], last, base, it);
      last = compose(item_last(o[j]), last);
      // the depart the stall is measured against: the seed for a head (and
      // the first item), else the item before's
      const long long eff_dep = it.head || i == 0 ? o[j].sd_dep : v.d + base;
      v = apply_map(m, v);
      const long long d = v.d + base;
      const long long st = d - it.s;
      start[j] = o[j].serving ? st : o[j].arrive;
      depart[j] = o[j].serving ? d : o[j].arrive;
      stall[j] = o[j].serving ? st - lmax(o[j].arrive, eff_dep + it.gap) : 0;
    }
  }
  if (first + 1 < k) {
    *reinterpret_cast<longlong2*>(out_start + first) =
        make_longlong2(start[0], start[1]);
    *reinterpret_cast<longlong2*>(out_depart + first) =
        make_longlong2(depart[0], depart[1]);
    *reinterpret_cast<longlong2*>(out_stall + first) =
        make_longlong2(stall[0], stall[1]);
  } else {
    out_start[first] = start[0];
    out_depart[first] = depart[0];
    out_stall[first] = stall[0];
  }
}

// ---------------------------------------------------------------------------
// the map-only scan, and the one-block pass over aggregate maps both use
// ---------------------------------------------------------------------------

__device__ __forceinline__ Map load_agg(const long long* agg, long long b) {
  const long long* g = agg + 6 * b;
  Map r;
  r.m00 = g[0];
  r.m01 = g[1];
  r.m10 = g[2];
  r.m11 = g[3];
  r.c0 = g[4];
  r.c1 = g[5];
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

__global__ void __launch_bounds__(THREADS)
aggregate_kernel(Maps in, long long k, long long* agg) {
  __shared__ Map sm[THREADS];
  const int t = threadIdx.x;
  const long long first = first_item(ITEMS);
  Map m[ITEMS];
  load_items(in, first, k, m);
  sm[t] = thread_aggregate(m, first, k);
  __syncthreads();
  block_tree(sm);
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

// Each block's incoming (depart, down) state from the aggregate maps, in
// order, starting from (NEG, NEG): each thread composes its run of
// aggregates, one scan over the runs, each thread walks its run.
__global__ void __launch_bounds__(PASS_THREADS)
carry_kernel(const long long* agg, long long n_blocks, long long* state) {
  __shared__ Map tot[PASS_THREADS / 32];
  const int t = threadIdx.x;
  long long b0, b1;
  thread_run(n_blocks, b0, b1);
  Map a = identity_map();
  for (long long b = b0; b < b1; ++b) a = compose(load_agg(agg, b), a);
  Map before = identity_map();
  block_scan<PASS_THREADS>(a, tot, before);
  State v;
  v.d = NEG;
  v.w = NEG;
  if (t > 0) v = apply_map(before, v);
  for (long long b = b0; b < b1; ++b) {
    state[2 * b] = v.d;
    state[2 * b + 1] = v.w;
    v = apply_map(load_agg(agg, b), v);
  }
}

__global__ void __launch_bounds__(THREADS)
apply_kernel(Maps in, long long k, const long long* state, long long* out) {
  __shared__ Map sm[THREADS];
  const int t = threadIdx.x;
  const long long first = first_item(ITEMS);
  Map m[ITEMS];
  load_items(in, first, k, m);
  sm[t] = thread_aggregate(m, first, k);
  __syncthreads();
  block_inclusive_scan(sm, identity_map());
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

// scratch of the fused round, in int64 words per block: each thread's
// prefix, the "last" aggregate and incoming state, the minimum arrival, the
// aggregate map and the incoming (depart, down) state
static_assert(ROUND_ITEMS == 2, "the fused round reads operands in pairs");
static_assert(sizeof(Last) % sizeof(long long) == 0, "Last packs in words");
constexpr long long LAST_WORDS = sizeof(Last) / sizeof(long long);
// 9 words and 3 halves per thread (the prefix), then per block
constexpr long long PREFIX_WORDS_PER_BLOCK = THREADS * 9 + THREADS * 3 / 2;
constexpr long long ROUND_WORDS_PER_BLOCK =
    PREFIX_WORDS_PER_BLOCK + 2 * LAST_WORDS + 1 + 6 + 2;

long long blocks_of(long long k, long long per_block) {
  return (k + per_block - 1) / per_block;
}

}  // namespace

// Items one block of the map-only scan covers: the caller sizes serve_scan's
// agg and state from it.
extern "C" long long serve_scan_block_items(void) { return BLOCK_ITEMS; }

// Items one block of the fused round covers.
extern "C" long long serve_round_block_items(void) {
  return ROUND_BLOCK_ITEMS;
}

// int64 words of scratch the fused round takes for k items.
extern "C" long long serve_round_scratch_words(long long k) {
  return blocks_of(k, ROUND_BLOCK_ITEMS) * ROUND_WORDS_PER_BLOCK + 1;
}

extern "C" int serve_scan_launch(const long long* m00, const long long* m01,
                                 const long long* m10, const long long* m11,
                                 const long long* c0, const long long* c1,
                                 long long* out, long long k, long long* agg,
                                 long long* state, cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Maps in{m00, m01, m10, m11, c0, c1};
  const long long n_blocks = blocks_of(k, BLOCK_ITEMS);
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(n_blocks);

  aggregate_kernel<<<grid, THREADS, 0, stream>>>(in, k, agg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  carry_kernel<<<1, PASS_THREADS, 0, stream>>>(agg, n_blocks, state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  apply_kernel<<<grid, THREADS, 0, stream>>>(in, k, state, out);
  err = cudaGetLastError();
  return static_cast<int>(err);
}

extern "C" int serve_round_launch(
    const long long* chan, const unsigned char* serving,
    const unsigned char* marker, const long long* arrive,
    const signed char* direction, const int* row, const long long* ser,
    const long long* turn, const long long* rhit, const long long* rmiss,
    const long long* retrain, const long long* sd_dep,
    const signed char* sd_dir, const int* sd_row, const long long* sd_down,
    long long* out_start, long long* out_depart, long long* out_stall,
    long long k, long long* scratch, cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Round in{chan,  serving, marker, arrive, direction,
                 row,   ser,     turn,   rhit,   rmiss,
                 retrain, sd_dep, sd_dir, sd_row, sd_down};
  const long long n_blocks = blocks_of(k, ROUND_BLOCK_ITEMS);
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(n_blocks);
  const long long n_threads = n_blocks * THREADS;
  const Prefix prefix{scratch,
                      reinterpret_cast<int*>(scratch + 9 * n_threads),
                      n_threads};
  Last* last_agg =
      reinterpret_cast<Last*>(scratch + PREFIX_WORDS_PER_BLOCK * n_blocks);
  Last* last_in = last_agg + n_blocks;
  long long* min_arrive = reinterpret_cast<long long*>(last_in + n_blocks);
  long long* agg = min_arrive + n_blocks;
  long long* state = agg + 6 * n_blocks;
  long long* base = state + 2 * n_blocks;

  round_last_kernel<<<grid, THREADS, 0, stream>>>(in, k, last_agg,
                                                  min_arrive);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  round_last_carry_kernel<<<1, PASS_THREADS, 0, stream>>>(
      last_agg, min_arrive, n_blocks, last_in, base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  round_maps_kernel<<<grid, THREADS, 0, stream>>>(in, k, last_in, base, agg,
                                                  prefix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  carry_kernel<<<1, PASS_THREADS, 0, stream>>>(agg, n_blocks, state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  round_finish_kernel<<<grid, THREADS, 0, stream>>>(
      in, k, prefix, base, state, out_start, out_depart, out_stall);
  return static_cast<int>(cudaGetLastError());
}
