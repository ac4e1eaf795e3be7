// Segmented (max,+) depart scan for NVIDIA Hopper (sm_90a): one launch, a
// single-pass scan with decoupled look-back.
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
// order, so this kernel carries it by decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016), in one pass over the stream:
//   * Dynamic tile ids.  A block takes its tile of TILE = THREADS * ITEMS
//     items from an atomicAdd on a counter in the workspace, not from
//     blockIdx.x, so every tile before its own was taken by a block that is
//     already running: the look-back never waits on a block that is not
//     resident, whatever the grid.  A block is WARPS scanning warps and
//     one look-back warp.
//   * Coalesced loads.  Each scanning warp owns WARP_ITEMS consecutive
//     items of the tile.  It reads them warp-striped (lane l takes items l,
//     l + 32, ...: one 256 B load per array and round), finds the heads
//     with a shuffle, and transposes the maps through shared memory, so
//     that each thread holds ITEMS consecutive items.  Every input is read once (lane 0 of
//     each warp also reads the channel before its slice, from the cache).
//   * The tile's scan.  Each thread composes its items; the scanning warps
//     scan the thread aggregates with warp shuffles, then the warp totals
//     (synchronised by a named barrier of their own).
//   * Publication.  A tile that holds a head publishes its inclusive depart
//     (the depart of its last item) at once: a map that resets ignores its
//     input, so that depart does not depend on its predecessors.  Any other
//     tile publishes its aggregate (c, m) at once, and its inclusive depart
//     once its look-back has ended.  The payload is written first, then
//     __threadfence, then the tile's status word with release semantics;
//     readers load the status with acquire semantics and the payload from
//     the L2.
//   * Look-back.  While the scanning warps load and scan the tile, the
//     look-back warp reads the status of 32 predecessors at a time,
//     nearest in lane 0, waits with __nanosleep backoff until every lane up
//     to the first inclusive prefix has published, composes the window by
//     a shuffle-down tree (nearest applied last) and stops at the first
//     inclusive prefix; otherwise it moves 32 tiles further.  An aggregate
//     never resets (a tile with a head publishes its prefix), so the first
//     reset is the first prefix.  At the engine's round shapes nearly every
//     tile holds a head, so nearly every look-back ends at its nearest
//     predecessor.  Its own warp keeps it off the scanning warps'
//     registers: 72 a thread, three blocks an SM.
//   * The depart.  Each thread applies its exclusive prefix to the tile's
//     incoming depart, walks its items, and the outputs go back through
//     shared memory to be stored warp-striped.
// Everything is int64 with no rebase and no span limit: (max,+) with a
// reset is associative in exact integer arithmetic, so any grouping of the
// tile scan and the look-back gives the same bits.  The stream's first item
// is always a head.  The channel column may be int64 or int32.
//
// Bound on the H100: memory.  The function reads channel, arrive and ser
// and writes depart: 32 B per item with an int64 channel, 28 B with int32.
// This kernel moves those bytes once, plus 4 workspace words a tile; the
// launch zeroes the counter and the status words with one cudaMemsetAsync.
//
// Interface: plain C, called through ctypes on PyTorch's current stream;
// the launch returns the first CUDA error code (0 = success).  The caller
// allocates out and a workspace of 1 + 4 * ceil(k / TILE) int64 words:
//   [0] tile counter, [1, 1 + n) tile status, then n aggregate c, n
//   aggregate m and n inclusive departs.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr long long NEG = -(1LL << 62);
constexpr int THREADS = 256;  // the threads that load and scan the tile
constexpr int ITEMS = 8;
constexpr int WARPS = THREADS / 32;
// and one more warp, the look-back warp
constexpr int BLOCK_THREADS = THREADS + 32;
constexpr int WARP_ITEMS = 32 * ITEMS;
constexpr long long TILE = static_cast<long long>(THREADS) * ITEMS;
constexpr unsigned FULL = 0xffffffffu;
// a warp's slice in shared memory: one pad word after every 16 items, so
// the striped and the transposed accesses of a half-warp hit distinct banks
constexpr int SLICE_WORDS = WARP_ITEMS + WARP_ITEMS / 16;
constexpr long long WORDS_PER_TILE = 4;

// tile status words
constexpr unsigned long long NOT_READY = 0;
constexpr unsigned long long AGGREGATE = 1;
constexpr unsigned long long PREFIX = 2;

struct Map {
  long long c, m;
  bool r;
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

__device__ __forceinline__ Map shfl_up(const Map& f, int off) {
  Map o;
  o.c = __shfl_up_sync(FULL, f.c, off);
  o.m = __shfl_up_sync(FULL, f.m, off);
  o.r = __shfl_up_sync(FULL, f.r ? 1 : 0, off) != 0;
  return o;
}

__device__ __forceinline__ Map shfl_down(const Map& f, int off) {
  Map o;
  o.c = __shfl_down_sync(FULL, f.c, off);
  o.m = __shfl_down_sync(FULL, f.m, off);
  o.r = __shfl_down_sync(FULL, f.r ? 1 : 0, off) != 0;
  return o;
}

__device__ __forceinline__ int slot(int s) { return s + s / 16; }

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Barrier of the THREADS scanning threads alone (the look-back warp may be
// waiting on other tiles meanwhile).
__device__ __forceinline__ void scan_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

// Inclusive scan of the threads' maps in thread order: Hillis-Steele inside
// each warp (shuffles), Hillis-Steele over the warp totals (warp 0), and
// each warp's exclusive total composed under its threads.  Returns the
// thread's inclusive map and sets `excl` to the composition of the threads
// before it (left unset for thread 0); tot[WARPS - 1] ends as the tile's
// aggregate.  Every scanning thread must call it.
__device__ __forceinline__ Map block_scan(Map v, Map* tot, Map& excl) {
  static_assert(WARPS <= 32, "one warp scans the warp totals");
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int w = t / 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Map p = shfl_up(v, off);
    if (lane >= off) v = compose(v, p);
  }
  const Map before = shfl_up(v, 1);
  if (lane == 31) tot[w] = v;
  scan_sync();
  if (w == 0) {
    Map x = tot[lane < WARPS ? lane : 0];
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const Map p = shfl_up(x, off);
      if (lane >= off) x = compose(x, p);
    }
    if (lane < WARPS) tot[lane] = x;
  }
  scan_sync();
  if (w > 0) {
    const Map wp = tot[w - 1];
    excl = lane > 0 ? compose(before, wp) : wp;
    v = compose(v, wp);
  } else if (lane > 0) {
    excl = before;
  }
  return v;
}

struct Workspace {
  unsigned long long* counter;
  unsigned long long* status;
  long long* agg_c;
  long long* agg_m;
  long long* incl;
};

__device__ __forceinline__ Workspace workspace(long long* ws,
                                               long long n_tiles) {
  Workspace o;
  o.counter = reinterpret_cast<unsigned long long*>(ws);
  o.status = reinterpret_cast<unsigned long long*>(ws + 1);
  o.agg_c = ws + 1 + n_tiles;
  o.agg_m = o.agg_c + n_tiles;
  o.incl = o.agg_m + n_tiles;
  return o;
}

// The depart coming into `tile` (> 0) from its predecessors, computed by
// the look-back warp (every lane calls it; lane 0's result is the one to
// use).
__device__ long long look_back(const Workspace& ws, long long tile,
                               int lane) {
  Map acc = identity_map();  // the windows read so far, nearest applied last
  unsigned sleep_ns = 16;
  for (long long base = tile - 1;; base -= 32) {
    const long long j = base - lane;
    unsigned long long st;
    for (;;) {
      st = j >= 0 ? load_acquire(ws.status + j) : PREFIX;
      const unsigned pending = __ballot_sync(FULL, st == NOT_READY);
      const unsigned prefix = __ballot_sync(FULL, st == PREFIX);
      // the lanes that must have published: all, or those before the
      // nearest prefix
      const unsigned need = prefix ? (prefix & (0u - prefix)) - 1u : FULL;
      if ((pending & need) == 0) break;
      __nanosleep(sleep_ns);
      if (sleep_ns < 128) sleep_ns *= 2;
    }
    // lanes past the nearest prefix that have not published stay the
    // identity; what they hold is behind a reset either way
    Map f = identity_map();
    if (st == PREFIX) {
      f.c = j >= 0 ? __ldcg(ws.incl + j) : NEG;
      f.m = 0;
      f.r = true;
    } else if (st == AGGREGATE) {
      f.c = __ldcg(ws.agg_c + j);
      f.m = __ldcg(ws.agg_m + j);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Map o = shfl_down(f, off);
      if (lane + off < 32) f = compose(f, o);
    }
    acc = compose(acc, f);  // lane 0's f is the whole window
    if (__shfl_sync(FULL, acc.r ? 1 : 0, 0)) return apply_map(acc, NEG);
  }
}

template <typename C>
__global__ void __launch_bounds__(BLOCK_THREADS)
depart_kernel(const C* __restrict__ chan, const long long* __restrict__ arrive,
              const long long* __restrict__ ser, long long* __restrict__ out,
              long long k, long long n_tiles, long long* wsp) {
  __shared__ long long s_c[WARPS][SLICE_WORDS];
  __shared__ long long s_m[WARPS][SLICE_WORDS];
  __shared__ unsigned char s_r[WARPS][WARP_ITEMS];
  __shared__ Map s_tot[WARPS];
  __shared__ long long s_tile;
  __shared__ long long s_in;

  const Workspace ws = workspace(wsp, n_tiles);
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int w = t / 32;
  if (t == 0) s_tile = static_cast<long long>(atomicAdd(ws.counter, 1ULL));
  __syncthreads();
  const long long tile = s_tile;
  const long long wbase = tile * TILE + static_cast<long long>(w) * WARP_ITEMS;

  Map it[ITEMS];
  Map excl;
  if (w == WARPS) {
    // the look-back warp: the incoming depart, while the other warps load
    // and scan the tile (tile 0 starts with a head and needs none)
    const long long in = tile > 0 ? look_back(ws, tile, lane) : NEG;
    if (lane == 0) s_in = in;
  } else {
    // (1) the warp's slice, warp-striped: round j, lane l holds item
    // wbase + 32 j + l; every load is issued before the first is used
    C ch[ITEMS];
    long long ar[ITEMS], sv[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = wbase + 32 * j + lane;
      ch[j] = C(0);
      ar[j] = 0;
      sv[j] = 0;
      if (i < k) {
        ch[j] = chan[i];
        ar[j] = arrive[i];
        sv[j] = ser[i];
      }
    }
    // the channel before lane 0's item of each round
    C lead = C(0);
    if (lane == 0 && wbase > 0 && wbase < k) lead = chan[wbase - 1];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int s = 32 * j + lane;
      const long long i = wbase + s;
      C before = __shfl_up_sync(FULL, ch[j], 1);
      if (lane == 0) before = lead;
      lead = __shfl_sync(FULL, ch[j], 31);
      const bool live = i < k;
      s_c[w][slot(s)] = live ? ar[j] + sv[j] : NEG;
      s_m[w][slot(s)] = sv[j];
      s_r[w][s] = live && (i == 0 || ch[j] != before);
    }
    __syncwarp();

    // (2) transposed: this thread's ITEMS consecutive items, and their
    // composition in order (items past k are the identity and skipped)
    const long long first = wbase + static_cast<long long>(lane) * ITEMS;
    Map a = identity_map();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int s = lane * ITEMS + j;
      it[j].c = s_c[w][slot(s)];
      it[j].m = s_m[w][slot(s)];
      it[j].r = s_r[w][s] != 0;
      if (first + j < k) a = compose(it[j], a);
    }

    // (3) the tile's scan; its aggregate published at once: the
    // inclusive depart when the tile holds a head, else the map
    block_scan(a, s_tot, excl);
    if (t == 0) {
      const Map tagg = s_tot[WARPS - 1];
      if (tagg.r) {
        ws.incl[tile] = tagg.c;
        __threadfence();
        store_release(ws.status + tile, PREFIX);
      } else {
        ws.agg_c[tile] = tagg.c;
        ws.agg_m[tile] = tagg.m;
        __threadfence();
        store_release(ws.status + tile, AGGREGATE);
      }
    }
  }
  __syncthreads();
  if (w == WARPS) return;

  // (4) the inclusive depart of a tile without a head
  const long long in = s_in;
  if (t == 0) {
    const Map tagg = s_tot[WARPS - 1];
    if (!tagg.r) {
      ws.incl[tile] = apply_map(tagg, in);
      __threadfence();
      store_release(ws.status + tile, PREFIX);
    }
  }

  // (5) every item's depart, stored warp-striped through the slice
  long long v = in;
  if (t > 0) v = apply_map(excl, v);
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    v = apply_map(it[j], v);
    s_c[w][slot(lane * ITEMS + j)] = v;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int s = 32 * j + lane;
    if (wbase + s < k) out[wbase + s] = s_c[w][slot(s)];
  }
}

template <typename C>
int launch(const C* chan, const long long* arrive, const long long* ser,
           long long* out, long long k, long long* ws, long long ws_words,
           cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (k + TILE - 1) / TILE;
  if (n_tiles > INT_MAX || ws_words < 1 + WORDS_PER_TILE * n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      ws, 0, static_cast<size_t>(1 + n_tiles) * sizeof(long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  depart_kernel<C><<<static_cast<unsigned>(n_tiles), BLOCK_THREADS, 0,
                    stream>>>(
      chan, arrive, ser, out, k, n_tiles, ws);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Items one block scans (a tile): the caller sizes the workspace from it.
extern "C" long long segmented_depart_block_items(void) { return TILE; }

// Blocks of the kernel (int64 channel) one SM holds at once, or -1.
extern "C" int segmented_depart_blocks_per_sm(void) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, depart_kernel<long long>, BLOCK_THREADS, 0) != cudaSuccess)
    return -1;
  return n;
}

extern "C" int segmented_depart_launch_i64(const long long* chan,
                                           const long long* arrive,
                                           const long long* ser,
                                           long long* out, long long k,
                                           long long* ws, long long ws_words,
                                           cudaStream_t stream) {
  return launch(chan, arrive, ser, out, k, ws, ws_words, stream);
}

extern "C" int segmented_depart_launch_i32(const int* chan,
                                           const long long* arrive,
                                           const long long* ser,
                                           long long* out, long long k,
                                           long long* ws, long long ws_words,
                                           cudaStream_t stream) {
  return launch(chan, arrive, ser, out, k, ws, ws_words, stream);
}
