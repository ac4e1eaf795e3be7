// Snoop-filter (DCOH) protocol scan for NVIDIA Hopper (sm_90a).
//
// Replaces: repro/core/snoop_filter.py::simulate_sf (line 210), whose
// per-request `step` the reference runs as one lax.scan; XLA compiles it
// into one device loop, and no Pallas kernel computes it.  This kernel runs
// whole request streams, one thread block per stream ("job"), several jobs
// in one launch (a policy or InvBlk sweep), each job's configuration read
// from an int64 table (the `Param` enum, mirrored by kernel.PARAMS).
//
// A step is sequential in the previous step's state, so one block walks
// its stream in order, holding the protocol state in shared memory when it
// fits (dynamic shared memory, up to the card's opt-in limit) and in the
// caller's device memory otherwise (the same code through generic
// pointers).  Each step takes four block barriers:
//   1. every thread scans its share of SF entries and of the requester's
//      cache row: the SF match and its owners, free entries, each entry's
//      InvBlk run length and policy score, the cache hit; plus, for the
//      previous step's outputs, the lines requester 0 owns and caches;
//      warp shuffles, then one shared-memory stage, reduce them, and every
//      thread combines the warps' partials itself;
//   2. the victim's run is cleared (and the conflict owner written), with
//      the post-clear match and the first free entry reduced;
//   3. the cleared lines and the conflict line are invalidated in the
//      caches, with the requester's hit slot, first empty slot and LRU slot
//      reduced;
//   4. thread 0 fills the cache slot, upserts the SF entry, updates the
//      presence bitmap, the insert counts, the clock, the bus and the
//      counters, and writes the step's outputs.
// Everything is integer (int64 picoseconds, stamps and scores; int32 tags,
// owners and counts), and the kernel equals the plain version
// (ref.sf_scan_ref) and the reference bit for bit; the points where that
// is at stake are named below where they are handled.
//
// Bound on the H100: the dependency from step to step.  The function moves
// the stream in (4 + 1 + 4 B a request, 8 more with fabric latencies), the
// per-request outputs out (8 + 1 + 8 + 8 B, 26 more with events) and the
// state in and out once, and scans some Cs + R*Cc entries a step: a few
// microseconds of bytes and operations for a 32,000-request stream, while
// the steps' barriers and reductions take about that long per step.  What
// the design does about it: one launch per sweep, state in shared memory,
// four barriers a step, one thread for the scalar tail.
//
// Interface: plain C, called through ctypes on PyTorch's current stream;
// the launch is checked with cudaGetLastError and its error code returned
// (0 = success).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long BIG = 1LL << 40;
constexpr long long SMALL = 1LL << 36;
constexpr long long INVALID_SCORE = 1LL << 60;
constexpr int MAX_INVBLK = 64;  // the cleared lines of a step: one 64-bit mask
constexpr int NONE = INT_MAX;   // "no index" in a min-index reduction

enum Policy { FIFO = 0, LRU = 1, LFI = 2, LIFO = 3, MRU = 4, BLP = 5 };

enum Param {
  P_T, P_R, P_CC, P_CS, P_F, P_POLICY, P_MAXLEN, P_T_HIT, P_T_CACHE, P_T_SF,
  P_MISS_PATH, P_BISNP_RTT, P_WRITEBACK, P_PROBE, P_TRANSFER,
  P_ADDR, P_WRITE, P_RID, P_FAB,
  P_CACHE_TAG, P_CACHE_SEQ, P_SF_TAG, P_SF_OWNER, P_SF_DIRTY, P_SF_INS,
  P_SF_ACC, P_LFI, P_PRESENT, P_CLOCK, P_SCALARS,
  P_LATENCY, P_HIT, P_OWNER0, P_CACHED0, P_FAB_ISSUE, P_BISNP_MASK,
  P_INV_LINES, P_WB_LINES, P_NEED_VICTIM, P_CONFLICT, P_INVBLK_LEN,
  P_COUNT
};

// Victim candidate: lowest score, ties to the lowest index (jnp.argmin's
// first minimum); carries the entry's tag and run so that no thread reads
// the SF after another has started clearing it.
struct Cand {
  long long score;
  int idx, tag, run;
};

__device__ __forceinline__ Cand better(Cand a, Cand b) {
  return (b.score < a.score || (b.score == a.score && b.idx < a.idx)) ? b : a;
}

__device__ __forceinline__ Cand shfl_cand(Cand c, int m) {
  Cand o;
  o.score = __shfl_xor_sync(0xffffffffu, c.score, m);
  o.idx = __shfl_xor_sync(0xffffffffu, c.idx, m);
  o.tag = __shfl_xor_sync(0xffffffffu, c.tag, m);
  o.run = __shfl_xor_sync(0xffffffffu, c.run, m);
  return o;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int m = 16; m; m >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}
__device__ __forceinline__ long long warp_sum64(long long v) {
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}
__device__ __forceinline__ int warp_or(int v) {
  for (int m = 16; m; m >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}
__device__ __forceinline__ unsigned long long warp_or64(unsigned long long v) {
  for (int m = 16; m; m >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}
__device__ __forceinline__ Cand warp_best(Cand c) {
  for (int m = 16; m; m >>= 1) c = better(c, shfl_cand(c, m));
  return c;
}

// (key, index) minimum with ties to the lowest index (jnp.argmin).
struct KeyIdx {
  long long key;
  int idx;
};
__device__ __forceinline__ KeyIdx warp_keyidx(KeyIdx v) {
  for (int m = 16; m; m >>= 1) {
    KeyIdx o{__shfl_xor_sync(0xffffffffu, v.key, m),
             __shfl_xor_sync(0xffffffffu, v.idx, m)};
    if (o.key < v.key || (o.key == v.key && o.idx < v.idx)) v = o;
  }
  return v;
}

struct Red1 {  // phase 1: lookup, capacity, victim, cache hit, counts
  int match_idx, invalid, chit, own0, cached0;
  long long owners;
  Cand best;
};
struct Red2 {  // phase 2: the clear, the post-clear match and free entry
  int n_clear, n_dirty, vmask, live_idx, free_idx;
  unsigned long long cleared;
};
struct Red3 {  // phase 3: the requester's row after invalidation
  int hit_slot, empty_slot;
  KeyIdx lru;
};

// The job's state: in shared memory (copied in and out) or in place.
struct State {
  long long *sf_ins, *sf_acc, *cache_seq, *clock;
  int *sf_tag, *sf_owner, *cache_tag, *lfi;
  unsigned char *sf_dirty, *present;
};

template <typename T>
__device__ void copy_in(T* dst, const T* src, long long n) {
  for (long long i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
}

__global__ void __launch_bounds__(THREADS, 1)
sf_scan_kernel(const long long* __restrict__ table, int smem_bytes) {
  const long long* p = table + static_cast<long long>(blockIdx.x) * P_COUNT;
  const long long T = p[P_T];
  const int R = static_cast<int>(p[P_R]);
  const int Cc = static_cast<int>(p[P_CC]);
  const int Cs = static_cast<int>(p[P_CS]);
  const int F = static_cast<int>(p[P_F]);
  const int policy = static_cast<int>(p[P_POLICY]);
  const int maxlen = static_cast<int>(p[P_MAXLEN]);
  const long long t_hit = p[P_T_HIT], t_cache = p[P_T_CACHE];
  const long long t_sf = p[P_T_SF], miss_path = p[P_MISS_PATH];
  const long long bisnp_rtt = p[P_BISNP_RTT], writeback = p[P_WRITEBACK];
  const long long probe = p[P_PROBE], transfer = p[P_TRANSFER];
  const int* addr = reinterpret_cast<const int*>(p[P_ADDR]);
  const unsigned char* is_write =
      reinterpret_cast<const unsigned char*>(p[P_WRITE]);
  const int* rid = reinterpret_cast<const int*>(p[P_RID]);
  const long long* fab = reinterpret_cast<const long long*>(p[P_FAB]);
  long long* scal = reinterpret_cast<long long*>(p[P_SCALARS]);
  long long* o_lat = reinterpret_cast<long long*>(p[P_LATENCY]);
  unsigned char* o_hit = reinterpret_cast<unsigned char*>(p[P_HIT]);
  long long* o_own0 = reinterpret_cast<long long*>(p[P_OWNER0]);
  long long* o_cached0 = reinterpret_cast<long long*>(p[P_CACHED0]);
  long long* o_issue = reinterpret_cast<long long*>(p[P_FAB_ISSUE]);
  int* o_mask = reinterpret_cast<int*>(p[P_BISNP_MASK]);
  int* o_inv = reinterpret_cast<int*>(p[P_INV_LINES]);
  int* o_wb = reinterpret_cast<int*>(p[P_WB_LINES]);
  unsigned char* o_nv = reinterpret_cast<unsigned char*>(p[P_NEED_VICTIM]);
  unsigned char* o_conf = reinterpret_cast<unsigned char*>(p[P_CONFLICT]);
  int* o_blk = reinterpret_cast<int*>(p[P_INVBLK_LEN]);

  const long long n_cache = static_cast<long long>(R) * Cc;
  State g{reinterpret_cast<long long*>(p[P_SF_INS]),
          reinterpret_cast<long long*>(p[P_SF_ACC]),
          reinterpret_cast<long long*>(p[P_CACHE_SEQ]),
          reinterpret_cast<long long*>(p[P_CLOCK]),
          reinterpret_cast<int*>(p[P_SF_TAG]),
          reinterpret_cast<int*>(p[P_SF_OWNER]),
          reinterpret_cast<int*>(p[P_CACHE_TAG]),
          reinterpret_cast<int*>(p[P_LFI]),
          reinterpret_cast<unsigned char*>(p[P_SF_DIRTY]),
          reinterpret_cast<unsigned char*>(p[P_PRESENT])};
  extern __shared__ __align__(16) unsigned char smem[];
  const long long need = 8LL * (2 * Cs + n_cache + R) +
                         4LL * (2 * Cs + n_cache + F) + Cs + F;
  const bool in_smem = need <= smem_bytes;
  State s = g;
  if (in_smem) {
    unsigned char* q = smem;
    auto take = [&](long long bytes) {
      unsigned char* at = q;
      q += bytes;
      return at;
    };
    s.sf_ins = reinterpret_cast<long long*>(take(8LL * Cs));
    s.sf_acc = reinterpret_cast<long long*>(take(8LL * Cs));
    s.cache_seq = reinterpret_cast<long long*>(take(8LL * n_cache));
    s.clock = reinterpret_cast<long long*>(take(8LL * R));
    s.sf_tag = reinterpret_cast<int*>(take(4LL * Cs));
    s.sf_owner = reinterpret_cast<int*>(take(4LL * Cs));
    s.cache_tag = reinterpret_cast<int*>(take(4LL * n_cache));
    s.lfi = reinterpret_cast<int*>(take(4LL * F));
    s.sf_dirty = take(Cs);
    s.present = take(F);
    copy_in(s.sf_ins, g.sf_ins, Cs);
    copy_in(s.sf_acc, g.sf_acc, Cs);
    copy_in(s.cache_seq, g.cache_seq, n_cache);
    copy_in(s.clock, g.clock, R);
    copy_in(s.sf_tag, g.sf_tag, Cs);
    copy_in(s.sf_owner, g.sf_owner, Cs);
    copy_in(s.cache_tag, g.cache_tag, n_cache);
    copy_in(s.lfi, g.lfi, F);
    copy_in(s.sf_dirty, g.sf_dirty, Cs);
    copy_in(s.present, g.present, F);
  }
  __shared__ Red1 r1[WARPS];
  __shared__ Red2 r2[WARPS];
  __shared__ Red3 r3[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // scalar state, kept by thread 0 only
  long long bus_free = scal[0], seq = scal[1], bisnp = scal[2],
            inval = scal[3];
  const int own_mask = static_cast<int>((1u << R) - 1u);
  __syncthreads();

  // T steps, plus one pass (i == T) that only counts the final state for
  // the last step's outputs
  for (long long i = 0; i <= T; ++i) {
    const bool last = i == T;
    const int a = last ? -1 : addr[i];
    const bool w = last ? false : is_write[i] != 0;
    const int r = last ? 0 : rid[i];
    const int rbit = static_cast<int>(1u << r);

    // ---- phase 1 ------------------------------------------------------
    int match_idx = NONE, invalid = 0, chit = 0, own0 = 0, cached0 = 0;
    long long owners = 0;
    Cand best{LLONG_MAX, NONE, -1, 1};
    for (int e = tid; e < Cs; e += THREADS) {
      const int tag = s.sf_tag[e];
      const int own = s.sf_owner[e];
      own0 += ((own & 1) != 0) & (tag >= 0);
      if (last) continue;
      if (tag == a) {
        match_idx = min(match_idx, e);
        owners += own;  // a sum, as the reference's (tags are unique)
      }
      invalid += tag < 0;
      int run = 1;
      for (int d = 1; d < maxlen; ++d) {
        const int nt = tag + d;
        const int nxt = min(max(nt, 0), F - 1);
        if (run == d && s.present[nxt] && nt < F) ++run;
      }
      // the policy scores (reference :187-207), int64
      long long score;
      switch (policy) {
        case FIFO: score = s.sf_ins[e]; break;
        case LIFO: score = -s.sf_ins[e]; break;
        case LRU: score = s.sf_acc[e]; break;
        case MRU: score = -s.sf_acc[e]; break;
        case LFI: {
          // the insert count is gathered through a clipped tag
          const int cnt = s.lfi[min(max(tag, 0), F - 1)];
          score = static_cast<long long>(cnt) * BIG + (SMALL - s.sf_ins[e]);
          break;
        }
        default:  // BLP
          score = -(static_cast<long long>(run) * BIG + s.sf_ins[e]);
      }
      if (tag < 0) score = INVALID_SCORE;
      // ties to the lowest index (the victim, reference :290)
      best = better(best, Cand{score, e, tag, run});
    }
    for (int c = tid; c < Cc; c += THREADS) {
      cached0 += s.cache_tag[c] >= 0;
      if (!last) chit |= s.cache_tag[static_cast<long long>(r) * Cc + c] == a;
    }
    {
      Red1 v{warp_min(match_idx), warp_sum(invalid), warp_or(chit),
             warp_sum(own0), warp_sum(cached0), warp_sum64(owners),
             warp_best(best)};
      if (lane == 0) r1[warp] = v;
    }
    __syncthreads();
    Red1 q1 = r1[0];
    for (int k = 1; k < WARPS; ++k) {
      const Red1& o = r1[k];
      q1.match_idx = min(q1.match_idx, o.match_idx);
      q1.invalid += o.invalid;
      q1.chit |= o.chit;
      q1.own0 += o.own0;
      q1.cached0 += o.cached0;
      q1.owners += o.owners;
      q1.best = better(q1.best, o.best);
    }
    if (tid == 0 && i > 0) {
      o_own0[i - 1] = q1.own0;
      o_cached0[i - 1] = q1.cached0;
    }
    if (last) break;

    const bool hit = q1.chit != 0;
    const bool sf_hit = q1.match_idx != NONE;
    const int others = static_cast<int>(q1.owners) & ~rbit;
    const bool conflict = sf_hit && w && others != 0;
    const bool need_victim = !sf_hit && q1.invalid == 0;
    const int v_tag = q1.best.tag;
    const int v_len = min(q1.best.run, maxlen);

    // ---- phase 2: clear the victim's run; conflict owner ---------------
    int n_clear = 0, n_dirty = 0, vmask = 0, live_idx = NONE,
        free_idx = NONE;
    unsigned long long cleared = 0;
    for (int e = tid; e < Cs; e += THREADS) {
      const int tag = s.sf_tag[e];
      // live InvBlk lines: v_tag .. v_tag + v_len - 1 (need_victim only)
      const bool clear = need_victim && tag >= v_tag && tag - v_tag < v_len;
      int post = tag;
      if (clear) {
        ++n_clear;
        n_dirty += s.sf_dirty[e] != 0;
        vmask |= s.sf_owner[e];
        cleared |= 1ull << (tag - v_tag);
        s.sf_tag[e] = -1;
        s.sf_owner[e] = 0;
        s.sf_dirty[e] = 0;
        s.sf_ins[e] = 0;
        s.sf_acc[e] = 0;
        post = -1;
      }
      // the conflict owner is written through the *old* tag (:357)
      if (conflict && tag == a) s.sf_owner[e] = rbit;
      if (post == a) live_idx = min(live_idx, e);
      if (post < 0) free_idx = min(free_idx, e);
    }
    {
      Red2 v{warp_sum(n_clear), warp_sum(n_dirty), warp_or(vmask),
             warp_min(live_idx), warp_min(free_idx), warp_or64(cleared)};
      if (lane == 0) r2[warp] = v;
    }
    __syncthreads();
    Red2 q2 = r2[0];
    for (int k = 1; k < WARPS; ++k) {
      const Red2& o = r2[k];
      q2.n_clear += o.n_clear;
      q2.n_dirty += o.n_dirty;
      q2.vmask |= o.vmask;
      q2.live_idx = min(q2.live_idx, o.live_idx);
      q2.free_idx = min(q2.free_idx, o.free_idx);
      q2.cleared |= o.cleared;
    }

    // ---- phase 3: cache invalidation (before the slot fill, :304-308) --
    int hit_slot = NONE, empty_slot = NONE;
    KeyIdx lru{LLONG_MAX, NONE};
    for (int row = 0; row < R; ++row) {
      for (int c = tid; c < Cc; c += THREADS) {
        const long long k = static_cast<long long>(row) * Cc + c;
        const int tag = s.cache_tag[k];
        const int d = tag - v_tag;
        bool inv = tag >= 0 && need_victim && d >= 0 && d < v_len &&
                   ((q2.cleared >> d) & 1ull);
        inv = inv || (conflict && row != r && tag == a);
        long long sq = s.cache_seq[k];
        int post = tag;
        if (inv) {
          s.cache_tag[k] = -1;
          s.cache_seq[k] = 0;
          post = -1;
          sq = 0;
        }
        if (row == r) {
          // first match, first empty slot, first least-recent slot
          // (jnp.argmax / argmin ties, :340-342)
          if (post == a) hit_slot = min(hit_slot, c);
          if (post < 0) empty_slot = min(empty_slot, c);
          if (sq < lru.key || (sq == lru.key && c < lru.idx)) lru = {sq, c};
        }
      }
    }
    {
      Red3 v{warp_min(hit_slot), warp_min(empty_slot), warp_keyidx(lru)};
      if (lane == 0) r3[warp] = v;
    }
    __syncthreads();

    // ---- phase 4: the scalar tail, one thread ---------------------------
    if (tid == 0) {
      Red3 q3 = r3[0];
      for (int k = 1; k < WARPS; ++k) {
        const Red3& o = r3[k];
        q3.hit_slot = min(q3.hit_slot, o.hit_slot);
        q3.empty_slot = min(q3.empty_slot, o.empty_slot);
        if (o.lru.key < q3.lru.key ||
            (o.lru.key == q3.lru.key && o.lru.idx < q3.lru.idx))
          q3.lru = o.lru;
      }
      const long long t = s.clock[r];
      const long long t_hitc = t + t_hit;
      const long long t_bus_ready = max(t_hitc, bus_free);
      const bool do_bisnp = need_victim || conflict;
      const long long extra = max(v_len - 1, 0);
      long long lat_bisnp = do_bisnp ? bisnp_rtt : 0;
      if (need_victim) lat_bisnp += extra * t_cache + extra * extra * probe;
      const long long lat_wb =
          q2.n_dirty > 0 ? static_cast<long long>(q2.n_dirty) * writeback : 0;
      // int32, as the reference computes it (python int times int32)
      const int bus_occupancy = static_cast<int>(
          static_cast<unsigned>(transfer) *
          static_cast<unsigned>(1 + (need_victim ? v_len : 0)));
      const long long lat_bus = (t_bus_ready - t_hitc) + transfer;
      const long long lat_miss =
          fab ? t_hit + fab[i] + t_sf
              : t_hit + lat_bus + miss_path + t_sf + lat_bisnp + lat_wb;
      const long long latency = hit ? t_hit : lat_miss;

      // cache slot: the hit slot (0 if the line was invalidated), else the
      // first empty slot, else the least recently used
      const int hs = q3.hit_slot == NONE ? 0 : q3.hit_slot;
      const int fill = q3.empty_slot != NONE ? q3.empty_slot : q3.lru.idx;
      const long long slot = static_cast<long long>(r) * Cc + (hit ? hs : fill);
      s.cache_tag[slot] = a;
      s.cache_seq[slot] = seq;

      // SF upsert on a cache miss (hits never reach the device)
      const bool have_entry = q2.live_idx != NONE;
      if (!hit) {
        const int new_slot = q2.free_idx == NONE ? 0 : q2.free_idx;
        const int tgt = have_entry ? q2.live_idx : new_slot;
        s.sf_tag[tgt] = a;
        s.sf_owner[tgt] |= rbit;
        s.sf_dirty[tgt] = s.sf_dirty[tgt] | w;
        if (!have_entry) s.sf_ins[tgt] = seq;
        s.sf_acc[tgt] = seq;
      }

      // presence bitmap (:372): every old value gathered first, then one
      // write per offset in order through indices clipped to F - 1, so a
      // clipped index that repeats keeps the last offset's value (XLA on
      // the CPU applies the reference's duplicate scatter in order; a run
      // ending at line F - 1 can leave that line's bit set)
      if (need_victim) {
        unsigned char old[MAX_INVBLK];
        for (int j = 0; j < maxlen; ++j)
          old[j] = s.present[min(max(v_tag + j, 0), F - 1)];
        for (int j = 0; j < maxlen; ++j)
          s.present[min(max(v_tag + j, 0), F - 1)] = old[j] && !(j < v_len);
      }
      if (!hit) {
        s.present[a] = 1;
        if (!have_entry) s.lfi[a] += 1;
      }

      // the clock of the requester only (:383); the bus does not move on
      // a hit
      s.clock[r] = t + latency;
      if (!hit) bus_free = t_bus_ready + bus_occupancy;
      ++seq;
      bisnp += do_bisnp;
      inval += (need_victim ? q2.n_clear : 0) + conflict;

      o_lat[i] = latency;
      o_hit[i] = hit;
      if (o_issue) {
        // BISnp targets: owners of the cleared lines (first R bits), and
        // the other sharers on a write conflict
        o_issue[i] = t_hitc;
        o_mask[i] = (need_victim ? (q2.vmask & own_mask) : 0) |
                    (conflict ? others : 0);
        o_inv[i] = (need_victim ? q2.n_clear : 0) + conflict;
        o_wb[i] = q2.n_dirty > 0 ? q2.n_dirty : 0;
        o_nv[i] = need_victim;
        o_conf[i] = conflict;
        o_blk[i] = need_victim ? v_len : 0;
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    scal[0] = bus_free;
    scal[1] = seq;
    scal[2] = bisnp;
    scal[3] = inval;
  }
  if (in_smem) {
    __syncthreads();
    copy_in(g.sf_ins, s.sf_ins, Cs);
    copy_in(g.sf_acc, s.sf_acc, Cs);
    copy_in(g.cache_seq, s.cache_seq, n_cache);
    copy_in(g.clock, s.clock, R);
    copy_in(g.sf_tag, s.sf_tag, Cs);
    copy_in(g.sf_owner, s.sf_owner, Cs);
    copy_in(g.cache_tag, s.cache_tag, n_cache);
    copy_in(g.lfi, s.lfi, F);
    copy_in(g.sf_dirty, s.sf_dirty, Cs);
    copy_in(g.present, s.present, F);
  }
}

}  // namespace

extern "C" int sf_scan_param_count() { return P_COUNT; }

extern "C" int sf_scan_threads() { return THREADS; }

// The most dynamic shared memory a block of this kernel may use on `device`.
extern "C" int sf_scan_max_smem(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, sf_scan_kernel) != cudaSuccess) return 0;
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

extern "C" int sf_scan_launch(const void* table, int n_jobs, int smem_bytes,
                              void* stream) {
  if (n_jobs <= 0) return 0;
  if (smem_bytes > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        sf_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sf_scan_kernel<<<n_jobs, THREADS, smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), smem_bytes);
  return static_cast<int>(cudaGetLastError());
}
