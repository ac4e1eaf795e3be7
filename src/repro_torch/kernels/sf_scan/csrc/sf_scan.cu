// Snoop-filter (DCOH) protocol scan for NVIDIA Hopper (sm_90a).
//
// Replaces: repro/core/snoop_filter.py::simulate_sf (line 210), whose
// per-request `step` the reference runs as one lax.scan; XLA compiles it
// into one device loop, and no Pallas kernel computes it.  This kernel runs
// whole request streams, one warp (a block of 32 threads) per stream
// ("job"), several jobs in one launch (a policy or InvBlk sweep), each
// job's configuration read from an int64 table (the `Param` enum, mirrored
// by kernel.PARAMS).
//
// Bound on the H100: the dependency from step to step.  The function moves
// the stream in (4 + 1 + 4 B a request, 8 more with fabric latencies), the
// per-request outputs out (8 + 1 + 8 + 8 B, 26 more with events) and the
// state in and out once: under a millisecond of bytes for a 32,000-request
// stream.  A step reads what the previous step wrote, so the stream is
// walked in order, and its time is the chain of dependent shared-memory
// accesses and instructions of each step, times the steps.
//
// What the design does about it: each step does only the work its case
// needs.
//   * Line-indexed maps, built in the preamble from the incoming state:
//     `sf_map` (line -> SF entry, F entries) and `cmap` (line -> slot, one
//     F-entry map per requester row).  The SF match, its owners, the write
//     conflict, the cache hit and the hit slot are one lookup each; the
//     cleared InvBlk lines and their cache copies take <= maxlen and
//     <= R * maxlen lookups, the conflict invalidation <= R.  The maps rest
//     on two invariants the reference keeps (valid SF tags are unique, and
//     so are a cache row's valid tags); the wrapper checks them
//     (ref.check_states) and raises on a state that breaks them.
//   * Running counts instead of recounts: free SF entries (the reference's
//     `sf_full`), requester 0's SF lines (`owner_lines`) and cache lines
//     (`cached_lines`), kept up to date as entries change.  The lowest free
//     SF entry and the lowest empty slot of a row come from two-level
//     bitmaps (`Bits`: a word of flags per 32 items, a bit per nonzero
//     word) by `__ffs`, ties to the lowest index as jnp.argmax takes them.
//   * A victim without a search for fifo, lifo, lru and mru: an order list
//     links the valid entries by stamp (insertion or access), so the
//     victim is its head or its tail, and a step that stamps an entry
//     moves it to the tail.  lfi and blp search.
//   * One warp a stream, and a search only where a step needs one: lane 0
//     runs the steps alone, its requests staged in shared memory by the
//     warp 256 at a time.  The 32 lanes join (one shuffle hands them lane
//     0's flags, `__syncwarp` orders lane 0's writes before their reads)
//     only to stage requests, or for a step that needs a search: the
//     victim's policy scores over the Cs entries (lfi and blp, an SF miss
//     with the SF full), or the least-recent slot of the requester's row
//     (a miss to a row with no empty slot, after any victim's clear).  Each
//     lane takes every 32nd item, in four running minima and in a loop
//     compiled per policy, and an xor butterfly of shuffles combines the
//     lanes' (key, index) partials, ties to the lowest index (jnp.argmin's
//     first minimum).  The step loop has no block barrier.
// The state lives in shared memory with the maps and bitmaps when it fits
// (dynamic shared memory, up to the card's opt-in limit) and otherwise in
// the caller's device memory, the maps and bitmaps then in a workspace the
// wrapper allocates (two instances of one template, so that the compiler
// knows which memory each access goes to).
//
// Everything is integer (int64 picoseconds, stamps and scores; int32 tags,
// owners and counts), and the kernel equals the plain version
// (ref.sf_scan_ref) and the reference bit for bit; ref.sf_scan_indexed is
// this algorithm in Python for the CPU tests.  The points where exactness
// is at stake are named below where they are handled.
//
// Interface: plain C, called through ctypes on PyTorch's current stream;
// the launch is checked with cudaGetLastError and its error code returned
// (0 = success).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long BIG = 1LL << 40;
constexpr long long SMALL = 1LL << 36;
constexpr int NONE = INT_MAX;   // "no index" in a min-index reduction
constexpr int STAGE = 256;     // requests staged in shared memory at a time

enum Policy { FIFO = 0, LRU = 1, LFI = 2, LIFO = 3, MRU = 4, BLP = 5 };

enum Param {
  P_T, P_R, P_CC, P_CS, P_F, P_POLICY, P_MAXLEN, P_T_HIT, P_T_CACHE, P_T_SF,
  P_MISS_PATH, P_BISNP_RTT, P_WRITEBACK, P_PROBE, P_TRANSFER,
  P_ADDR, P_WRITE, P_RID, P_FAB,
  P_CACHE_TAG, P_CACHE_SEQ, P_SF_TAG, P_SF_OWNER, P_SF_DIRTY, P_SF_INS,
  P_SF_ACC, P_LFI, P_PRESENT, P_CLOCK, P_SCALARS,
  P_LATENCY, P_HIT, P_OWNER0, P_CACHED0, P_FAB_ISSUE, P_BISNP_MASK,
  P_INV_LINES, P_WB_LINES, P_NEED_VICTIM, P_CONFLICT, P_INVBLK_LEN,
  P_WORK,
  P_COUNT
};

// (key, index) pair of a minimum search: the lesser key, ties to the
// lower index (jnp.argmin's first minimum)
struct KeyIdx {
  long long key;
  int idx;
};

__device__ __forceinline__ bool key_less(long long key, int idx, KeyIdx v) {
  return key < v.key || (key == v.key && idx < v.idx);
}

// The lanes' partials combined over the warp: an xor butterfly of
// shuffles, each lane keeping the lesser pair.
__device__ __forceinline__ KeyIdx warp_min(KeyIdx v) {
  for (int m = 16; m; m >>= 1) {
    const long long key = __shfl_xor_sync(FULL, v.key, m);
    const int idx = __shfl_xor_sync(FULL, v.idx, m);
    if (key_less(key, idx, v)) v = KeyIdx{key, idx};
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// Two-level bitmap over n items: word k of `lo` flags items 32k .. 32k+31,
// bit (k & 31) of hi[k >> 5] says whether lo[k] is nonzero.  The lowest
// flagged item takes two reads (one more per 1,024 items before it).
struct Bits {
  unsigned *lo, *hi;
  int n_hi;

  __device__ void set(int i) {
    lo[i >> 5] |= 1u << (i & 31);
    hi[i >> 10] |= 1u << ((i >> 5) & 31);
  }
  __device__ void clear(int i) {
    const unsigned v = lo[i >> 5] & ~(1u << (i & 31));
    lo[i >> 5] = v;
    if (!v) hi[i >> 10] &= ~(1u << ((i >> 5) & 31));
  }
  __device__ int lowest() const {
    for (int k = 0; k < n_hi; ++k) {
      const unsigned h = hi[k];
      if (h) {
        const int w = (k << 5) + __ffs(h) - 1;
        return (w << 5) + __ffs(lo[w]) - 1;
      }
    }
    return -1;
  }
  __device__ bool any() const {
    for (int k = 0; k < n_hi; ++k)
      if (hi[k]) return true;
    return false;
  }
};

// The job's state: in shared memory (copied in and out) or in place.
struct State {
  long long *sf_ins, *sf_acc, *cache_seq, *clock;
  int *sf_tag, *sf_owner, *cache_tag, *lfi;
  unsigned char *sf_dirty, *present;
};

// The requests, staged in shared memory STAGE at a time (one spare item
// for lane 0's read ahead).
struct Stage {
  int *a, *r;
  unsigned char* w;
  long long* fab;
};

template <typename T>
__device__ void copy(T* dst, const T* src, long long n) {
  for (long long i = threadIdx.x; i < n; i += LANES) dst[i] = src[i];
}

// Flags of `n` items, 32 to a word: word w's bit b is pred(32w + b).
template <typename Pred>
__device__ void fill_lo(unsigned* lo, int n, Pred pred) {
  for (int w = threadIdx.x; w < (n + 31) / 32; w += LANES) {
    unsigned bits = 0;
    for (int b = 0; b < 32; ++b)
      if ((w << 5) + b < n && pred((w << 5) + b)) bits |= 1u << b;
    lo[w] = bits;
  }
}

__device__ void fill_hi(const unsigned* lo, unsigned* hi, int n_lo) {
  for (int k = threadIdx.x; k < (n_lo + 31) / 32; k += LANES) {
    unsigned bits = 0;
    for (int b = 0; b < 32; ++b)
      if ((k << 5) + b < n_lo && lo[(k << 5) + b]) bits |= 1u << b;
    hi[k] = bits;
  }
}

// The InvBlk run of line `tag`: 1 plus the present lines after it, up to
// maxlen, through a clipped index and the run loop's `< F` test (:283).
__device__ __forceinline__ int run_of(const unsigned char* present, int tag,
                                      int F, int maxlen) {
  int run = 1;
  for (int d = 1; d < maxlen; ++d) {
    const int nt = tag + d;
    if (run == d && present[min(max(nt, 0), F - 1)] && nt < F) ++run;
  }
  return run;
}

// A lane's share of a search: the first minimum of key(k) over items
// lane, lane + 32, ... < n.  Four running minima take every fourth of
// them, so four compare chains run side by side, and are merged by (key,
// index) at the end: a single warp has no other warp to hide a chain's
// latency behind.
template <typename Key>
__device__ __forceinline__ KeyIdx lane_min(int n, int lane, Key key) {
  KeyIdx m[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) m[u] = KeyIdx{LLONG_MAX, NONE};
  int k = lane;
  for (; k + 3 * LANES < n; k += 4 * LANES) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long v = key(k + u * LANES);
      if (v < m[u].key) m[u] = KeyIdx{v, k + u * LANES};
    }
  }
  for (; k < n; k += LANES) {
    const long long v = key(k);
    if (v < m[0].key) m[0] = KeyIdx{v, k};
  }
#pragma unroll
  for (int u = 1; u < 4; ++u)
    if (key_less(m[u].key, m[u].idx, m[0])) m[0] = m[u];
  return m[0];
}

// This lane's share of the victim search: the policy score (reference
// :187-207, int64) of entries lane, lane + 32, ...; every entry is valid
// here (the SF is full).
template <int POLICY>
__device__ __forceinline__ KeyIdx victim_part(const State& s, int Cs, int F,
                                              int maxlen, int lane) {
  return lane_min(Cs, lane, [&](int k) -> long long {
    if constexpr (POLICY == FIFO) {
      return s.sf_ins[k];
    } else if constexpr (POLICY == LIFO) {
      return -s.sf_ins[k];
    } else if constexpr (POLICY == LRU) {
      return s.sf_acc[k];
    } else if constexpr (POLICY == MRU) {
      return -s.sf_acc[k];
    } else if constexpr (POLICY == LFI) {
      // the insert count is gathered through a clipped tag
      const int cnt = s.lfi[min(max(s.sf_tag[k], 0), F - 1)];
      return static_cast<long long>(cnt) * BIG + (SMALL - s.sf_ins[k]);
    } else {  // BLP
      const int run = run_of(s.present, s.sf_tag[k], F, maxlen);
      return -(static_cast<long long>(run) * BIG + s.sf_ins[k]);
    }
  });
}

// Shared memory a job needs for its state, maps and bitmaps
// (kernel.smem_bytes): 8-byte arrays, then 4-byte ones, then 1-byte ones.
__device__ long long job_bytes(const long long* p) {
  const long long R = p[P_R], Cc = p[P_CC], Cs = p[P_CS], F = p[P_F];
  const long long nls = (Cs + 31) / 32, nlc = (Cc + 31) / 32;
  const long long words = F + R * F + nls + (nls + 31) / 32 +
                          R * (nlc + (nlc + 31) / 32) + 2 * Cs;
  return 8 * (2 * Cs + R * Cc + R) + 4 * (2 * Cs + R * Cc + F + words) +
         Cs + F;
}

// One job, its state in shared memory (SMEM) or in place in device memory
// with its maps and bitmaps in the workspace; two instances, so that the
// compiler knows which memory every state access goes to.
template <bool SMEM>
__device__ __forceinline__ void scan_job(const long long* __restrict__ p,
                                         unsigned char* smem, Stage st) {
  const int T = static_cast<int>(p[P_T]);
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
  const long long n_cmap = static_cast<long long>(R) * F;
  const int nls = (Cs + 31) / 32, nhs = (nls + 31) / 32;
  const int nlc = (Cc + 31) / 32, nhc = (nlc + 31) / 32;
  // the maps, bitmaps and order links, in 4-byte words (kernel.work_words)
  const long long words = F + n_cmap + nls + nhs +
                          static_cast<long long>(R) * (nlc + nhc) + 2LL * Cs;
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
  int* work = reinterpret_cast<int*>(p[P_WORK]);
  const int lane = threadIdx.x;
  State s = g;
  if constexpr (SMEM) {
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
    work = reinterpret_cast<int*>(take(4LL * words));
    s.sf_dirty = take(Cs);
    s.present = take(F);
    copy(s.sf_ins, g.sf_ins, Cs);
    copy(s.sf_acc, g.sf_acc, Cs);
    copy(s.cache_seq, g.cache_seq, n_cache);
    copy(s.clock, g.clock, R);
    copy(s.sf_tag, g.sf_tag, Cs);
    copy(s.sf_owner, g.sf_owner, Cs);
    copy(s.cache_tag, g.cache_tag, n_cache);
    copy(s.lfi, g.lfi, F);
    copy(s.sf_dirty, g.sf_dirty, Cs);
    copy(s.present, g.present, F);
  }
  int* sf_map = work;
  int* cmap = work + F;  // row rr's map at cmap + rr * F
  unsigned* bits = reinterpret_cast<unsigned*>(work + F + n_cmap);
  Bits sf_free{bits, bits + nls, nhs};
  unsigned* c_lo = bits + nls + nhs;  // row rr: nlc words
  unsigned* c_hi = c_lo + static_cast<long long>(R) * nlc;  // row rr: nhc
  auto row_empty = [&](int rr) {
    return Bits{c_lo + static_cast<long long>(rr) * nlc,
                c_hi + static_cast<long long>(rr) * nhc, nhc};
  };
  // the valid SF entries in victim order (fifo, lifo, lru, mru): links
  int* before = reinterpret_cast<int*>(c_hi + static_cast<long long>(R) * nhc);
  int* after = before + Cs;

  // ---- preamble: the maps, bitmaps and running counts -----------------
  for (long long k = lane; k < F + n_cmap; k += LANES) work[k] = -1;
  __syncwarp();
  for (int e = lane; e < Cs; e += LANES) {
    const int tag = s.sf_tag[e];
    if (tag >= 0) sf_map[tag] = e;  // unique (ref.check_states)
  }
  for (long long k = lane; k < n_cache; k += LANES) {
    const int tag = s.cache_tag[k];
    if (tag >= 0) cmap[(k / Cc) * F + tag] = static_cast<int>(k % Cc);
  }
  fill_lo(sf_free.lo, Cs, [&](int e) { return s.sf_tag[e] < 0; });
  for (int rr = 0; rr < R; ++rr) {
    const int* row = s.cache_tag + static_cast<long long>(rr) * Cc;
    fill_lo(row_empty(rr).lo, Cc, [&](int c) { return row[c] < 0; });
  }
  __syncwarp();
  fill_hi(sf_free.lo, sf_free.hi, nls);
  for (int rr = 0; rr < R; ++rr)
    fill_hi(row_empty(rr).lo, row_empty(rr).hi, nlc);
  int n_free = 0, own0 = 0, cached0 = 0;
  for (int e = lane; e < Cs; e += LANES) {
    const int tag = s.sf_tag[e];
    n_free += tag < 0;
    own0 += tag >= 0 && (s.sf_owner[e] & 1);
  }
  for (int c = lane; c < Cc; c += LANES) cached0 += s.cache_tag[c] >= 0;
  n_free = warp_sum(n_free);
  own0 = warp_sum(own0);
  cached0 = warp_sum(cached0);

  // The order list.  fifo and lifo rank the entries by insertion stamp,
  // lru and mru by access stamp: the victim is the least stamp (fifo, lru)
  // or the greatest (lifo, mru), ties to the lowest index, so the list
  // holds the valid entries by (stamp, index), the index descending for
  // lifo and mru, and the victim is its head or its tail.  A step stamps
  // an entry with `seq`, above every stamp, so the list stays in order by
  // moving that entry to the tail; that holds when every valid stamp of
  // the incoming state is below `seq`, as the reference's states are.  A
  // job whose state is not so, and lfi and blp, search instead.
  const bool by_acc = policy == LRU || policy == MRU;
  const bool desc = policy == LIFO || policy == MRU;
  const long long* stamp = by_acc ? s.sf_acc : s.sf_ins;
  int below = 1;
  for (int k = lane; k < Cs; k += LANES)
    below &= s.sf_tag[k] < 0 || stamp[k] < scal[1];
  const bool use_list =
      policy != LFI && policy != BLP && __all_sync(FULL, below);
  int head = -1, tail = -1;
  if (use_list) {
    // entry f comes before entry k in the list
    auto precedes = [&](int f, long long kf, int k, long long kk) {
      return kf < kk || (kf == kk && (desc ? f > k : f < k));
    };
    // each valid entry's neighbours, by one pass over all entries (the
    // incoming state is usually empty, a carried one the SF's size)
    for (int k = lane; k < Cs; k += LANES) {
      if (s.sf_tag[k] < 0) continue;
      const long long kk = stamp[k];
      int prv = -1, nxt = -1;
      long long kp = 0, kn = 0;
      for (int f = 0; f < Cs; ++f) {
        if (f == k || s.sf_tag[f] < 0) continue;
        const long long kf = stamp[f];
        if (precedes(f, kf, k, kk)) {
          if (prv < 0 || precedes(prv, kp, f, kf)) prv = f, kp = kf;
        } else if (nxt < 0 || precedes(f, kf, nxt, kn)) {
          nxt = f, kn = kf;
        }
      }
      before[k] = prv;
      after[k] = nxt;
      if (prv < 0) head = k;
      if (nxt < 0) tail = k;
    }
    for (int m = 16; m; m >>= 1) {
      head = max(head, __shfl_xor_sync(FULL, head, m));
      tail = max(tail, __shfl_xor_sync(FULL, tail, m));
    }
  }
  __syncwarp();
  auto unlink = [&](int k) {
    const int prv = before[k], nxt = after[k];
    if (prv >= 0) after[prv] = nxt; else head = nxt;
    if (nxt >= 0) before[nxt] = prv; else tail = prv;
  };
  auto append = [&](int k) {
    before[k] = tail;
    after[k] = -1;
    if (tail >= 0) after[tail] = k; else head = k;
    tail = k;
  };

  // scalar state, kept by lane 0
  long long bus_free = scal[0], seq = scal[1], bisnp = scal[2],
            inval = scal[3];
  const int own_mask = static_cast<int>((1u << R) - 1u);
  // lane 0's step: its request (from the stage, the next one read a step
  // ahead) and what phase A found
  int a = 0, w = 0, r = 0, rbit = 0, e = -1, owners = 0, others = 0;
  int slot_a = -1;
  long long f_lat = 0, t = 0;
  bool hit = false, conflict = false, need_victim = false, ahead = false;
  int na = 0, nw = 0, nr = 0;
  long long nf = 0;

  // ---- phase A, lane 0: one lookup each; returns the search the step
  // needs first: 1 the victim (an SF miss with the SF full, no order
  // list), 2 the least-recent slot of the requester's row (a miss to a
  // full row, no victim), 0 none
  auto phase_a = [&](int k) {
    if (ahead) {
      a = na;
      w = nw;
      r = nr;
      f_lat = nf;
    } else {
      a = st.a[k];
      w = st.w[k];
      r = st.r[k];
      f_lat = st.fab[k];
    }
    na = st.a[k + 1];
    nw = st.w[k + 1];
    nr = st.r[k + 1];
    nf = st.fab[k + 1];
    ahead = true;
    rbit = static_cast<int>(1u << r);
    t = s.clock[r];
    slot_a = cmap[static_cast<long long>(r) * F + a];
    hit = slot_a >= 0;
    e = sf_map[a];
    const bool sf_hit = e >= 0;
    owners = sf_hit ? s.sf_owner[e] : 0;  // the reference's sum: one term
    others = owners & ~rbit;
    conflict = sf_hit && w && others != 0;
    need_victim = !sf_hit && n_free == 0;
    if (need_victim) return use_list ? 0 : 1;
    return !hit && !row_empty(r).any() ? 2 : 0;
  };

  auto invalidate = [&](int rr, int c, int line) {
    const long long k = static_cast<long long>(rr) * Cc + c;
    s.cache_tag[k] = -1;
    s.cache_seq[k] = 0;
    cmap[static_cast<long long>(rr) * F + line] = -1;
    row_empty(rr).set(c);
    cached0 -= rr == 0;
  };

  // ---- phase B1, lane 0: the victim's clear and the conflict; returns
  // whether the step still needs the least-recent slot of its row (a miss
  // to a row the clear left full)
  int n_clear = 0, n_dirty = 0, vmask = 0, v_len = 0;
  auto phase_b1 = [&](int victim) {
    n_clear = n_dirty = vmask = v_len = 0;
    if (need_victim) {
      const int v_tag = s.sf_tag[victim];
      v_len = min(run_of(s.present, v_tag, F, maxlen), maxlen);
      // the InvBlk lines v_tag .. v_tag + v_len - 1 that an entry holds
      for (int d = 0; d < v_len; ++d) {
        const int line = v_tag + d;
        const int ec = sf_map[line];
        if (ec < 0) continue;
        ++n_clear;
        n_dirty += s.sf_dirty[ec] != 0;
        const int own = s.sf_owner[ec];
        vmask |= own;
        own0 -= own & 1;
        s.sf_tag[ec] = -1;
        s.sf_owner[ec] = 0;
        s.sf_dirty[ec] = 0;
        s.sf_ins[ec] = 0;
        s.sf_acc[ec] = 0;
        sf_map[line] = -1;
        sf_free.set(ec);
        ++n_free;
        if (use_list) unlink(ec);
        // BISnp invalidates the line in its owners' caches (before the
        // slot fill, :304-308)
        for (int rr = 0; rr < R; ++rr) {
          const int c = cmap[static_cast<long long>(rr) * F + line];
          if (c >= 0) invalidate(rr, c, line);
        }
      }
      // presence bitmap (:372): `present[k] & ~live[j]` through indices k
      // clipped to F - 1, one offset after another, so where clipped
      // offsets repeat an index the last offset's write wins (XLA on the
      // CPU applies the reference's duplicate scatter in order; a run
      // ending at line F - 1 can leave that line's bit set).  Every value
      // is the one gathered before the writes: an index is written here
      // only by the last offset that reaches it, which reads it first.
      for (int j = 0; j < maxlen; ++j) {
        const int k = min(max(v_tag + j, 0), F - 1);
        if (k < F - 1 || j == maxlen - 1)
          s.present[k] = s.present[k] && !(j < v_len);
      }
    }
    if (conflict) {
      // the conflict BISnp invalidates line a in the other rows
      for (int rr = 0; rr < R; ++rr) {
        const int c = cmap[static_cast<long long>(rr) * F + a];
        if (rr != r && c >= 0) invalidate(rr, c, a);
      }
      // the conflict owner is written through the *old* tag (:357): the
      // entry matched before the step (nothing is cleared on a conflict)
      own0 += (rbit & 1) - (owners & 1);
      s.sf_owner[e] = rbit;
    }
    return !hit && !row_empty(r).any();
  };

  // ---- phase B2, lane 0: the fill, the upsert, the clocks, the outputs
  // (`lru_slot`: the least-recent slot, where the step searched for it)
  auto phase_b2 = [&](int i, int lru_slot) {
    const long long t_hitc = t + t_hit;
    const long long t_bus_ready = max(t_hitc, bus_free);
    const bool do_bisnp = need_victim || conflict;
    const long long extra = max(v_len - 1, 0);
    long long lat_bisnp = do_bisnp ? bisnp_rtt : 0;
    if (need_victim) lat_bisnp += extra * t_cache + extra * extra * probe;
    const long long lat_wb = static_cast<long long>(n_dirty) * writeback;
    // int32, as the reference computes it (python int times int32, :322)
    const int bus_occupancy = static_cast<int>(
        static_cast<unsigned>(transfer) * static_cast<unsigned>(1 + v_len));
    const long long lat_bus = (t_bus_ready - t_hitc) + transfer;
    const long long lat_miss =
        fab ? t_hit + f_lat + t_sf
            : t_hit + lat_bus + miss_path + t_sf + lat_bisnp + lat_wb;
    const long long latency = hit ? t_hit : lat_miss;

    // cache slot: the hit slot (0 if the line was invalidated, as
    // jnp.argmax of no match), else the lowest empty slot, else the least
    // recently used (first minimum, :340-342).  Only a victim's clear can
    // touch row r (a conflict invalidates the other rows), so without one
    // the hit slot is phase A's.
    const long long row = static_cast<long long>(r) * F;
    const int hs = need_victim ? cmap[row + a] : slot_a;
    int slot;
    if (hit) {
      slot = max(hs, 0);
    } else {
      slot = row_empty(r).lowest();
      if (slot < 0) slot = lru_slot;
    }
    const long long k = static_cast<long long>(r) * Cc + slot;
    if (!hit || hs < 0) {
      // a slot that does not hold line a (a miss: a is in no slot of the
      // row; a hit on an invalidated line: a was cleared from the row)
      const int old = s.cache_tag[k];
      if (old >= 0) {
        cmap[row + old] = -1;
      } else {
        row_empty(r).clear(slot);
        cached0 += r == 0;
      }
      cmap[row + a] = slot;
      s.cache_tag[k] = a;
    }
    s.cache_seq[k] = seq;

    // SF upsert on a cache miss (hits never reach the device): the line's
    // live entry after the clear, else the lowest free one
    if (!hit) {
      const int live = sf_map[a];
      const bool have_entry = live >= 0;
      const int tgt = max(have_entry ? live : sf_free.lowest(), 0);
      const int old_tag = s.sf_tag[tgt], old_own = s.sf_owner[tgt];
      if (old_tag != a) {
        if (old_tag >= 0) {
          sf_map[old_tag] = -1;
        } else {
          sf_free.clear(tgt);
          --n_free;
        }
        sf_map[a] = tgt;
        s.sf_tag[tgt] = a;
      }
      own0 += ((old_own | rbit) & 1) - (old_tag >= 0 && (old_own & 1));
      s.sf_owner[tgt] = old_own | rbit;
      s.sf_dirty[tgt] = s.sf_dirty[tgt] | w;
      if (!have_entry) s.sf_ins[tgt] = seq;
      s.sf_acc[tgt] = seq;
      // the entry's new stamp is the greatest: it moves to the tail
      if (use_list && (!have_entry || by_acc)) {
        if (old_tag >= 0) unlink(tgt);
        append(tgt);
      }
      s.present[a] = 1;
      if (!have_entry) s.lfi[a] += 1;
    }

    // the clock of the requester only (:383); the bus does not move on a
    // hit
    s.clock[r] = t + latency;
    if (!hit) bus_free = t_bus_ready + bus_occupancy;
    ++seq;
    bisnp += do_bisnp;
    inval += n_clear + conflict;

    o_lat[i] = latency;
    o_hit[i] = hit;
    o_own0[i] = own0;
    o_cached0[i] = cached0;
    if (o_issue) {
      // BISnp targets: owners of the cleared lines (first R bits), and the
      // other sharers on a write conflict
      o_issue[i] = t_hitc;
      o_mask[i] = (vmask & own_mask) | (conflict ? others : 0);
      o_inv[i] = n_clear + conflict;
      o_wb[i] = n_dirty;
      o_nv[i] = need_victim;
      o_conf[i] = conflict;
      o_blk[i] = v_len;
    }
  };

  // Lane 0 runs steps alone until one needs a search or the staged
  // requests run out; then the warp joins, and either stages the next
  // requests or searches, after which lane 0 goes on with the step.
  constexpr int REFILL = 4;
  int i = 0, base = 0, end = 0;  // requests [base, end) are staged
  for (;;) {
    int flags = 0;
    if (lane == 0) {
      for (;;) {
        if (i == end) {
          flags = REFILL;
          break;
        }
        flags = phase_a(i - base);
        if (flags) break;
        if (hit && !conflict && !need_victim) {
          // a hit that changes one stamp: the slot's, the clock, the
          // outputs (no victim, no invalidation, the bus does not move)
          s.cache_seq[static_cast<long long>(r) * Cc + slot_a] = seq;
          s.clock[r] = t + t_hit;
          o_lat[i] = t_hit;
          o_hit[i] = 1;
          o_own0[i] = own0;
          o_cached0[i] = cached0;
          if (o_issue) {
            o_issue[i] = t + t_hit;
            o_mask[i] = 0;
            o_inv[i] = 0;
            o_wb[i] = 0;
            o_nv[i] = 0;
            o_conf[i] = 0;
            o_blk[i] = 0;
          }
          ++seq;
        } else {
          // the list's victim, where the step needs one
          if (phase_b1(desc ? tail : head)) {
            flags = 2;  // a miss whose row the clear left full
            break;
          }
          phase_b2(i, 0);
        }
        ++i;
      }
    }
    // ---- the join -----------------------------------------------------
    flags = __shfl_sync(FULL, flags, 0);
    i = __shfl_sync(FULL, i, 0);
    if (flags == REFILL) {
      if (i >= T) break;
      __syncwarp();  // lane 0 is done with the stage
      for (int k = lane; k <= STAGE; k += LANES) {
        const int q = i + k;
        const bool in = q < T;
        st.a[k] = in ? addr[q] : 0;
        st.w[k] = in ? is_write[q] : 0;
        st.r[k] = in ? rid[q] : 0;
        st.fab[k] = in && fab ? fab[q] : 0;
      }
      base = i;
      end = min(i + STAGE, T);
      ahead = false;
      __syncwarp();
      continue;
    }
    const int rj = __shfl_sync(FULL, r, 0);  // the requester's row
    __syncwarp();  // lane 0's writes of earlier steps, seen by every lane
    if (flags == 1) {
      KeyIdx v;
      switch (policy) {
        case FIFO: v = victim_part<FIFO>(s, Cs, F, maxlen, lane); break;
        case LRU: v = victim_part<LRU>(s, Cs, F, maxlen, lane); break;
        case LFI: v = victim_part<LFI>(s, Cs, F, maxlen, lane); break;
        case LIFO: v = victim_part<LIFO>(s, Cs, F, maxlen, lane); break;
        case MRU: v = victim_part<MRU>(s, Cs, F, maxlen, lane); break;
        default: v = victim_part<BLP>(s, Cs, F, maxlen, lane);
      }
      v = warp_min(v);
      __syncwarp();  // every lane's reads done before lane 0 writes
      // after the clear, a miss may still find its row full: a second join
      int more = 0;
      if (lane == 0) more = phase_b1(v.idx);
      if (__shfl_sync(FULL, more, 0)) flags = 2;
      __syncwarp();
    }
    KeyIdx lru{LLONG_MAX, NONE};
    if (flags == 2) {
      const long long* row_seq = s.cache_seq + static_cast<long long>(rj) * Cc;
      lru = warp_min(lane_min(Cc, lane, [&](int c) { return row_seq[c]; }));
      __syncwarp();  // every lane's reads done before lane 0 writes
    }
    if (lane == 0) {
      // (a victim step has run phase B1 already, alone or after its
      // search; a step that needed only the least-recent slot runs it
      // here, where it clears nothing)
      if (!need_victim) phase_b1(0);
      phase_b2(i, lru.idx);
      ++i;
    }
  }

  if (lane == 0) {
    scal[0] = bus_free;
    scal[1] = seq;
    scal[2] = bisnp;
    scal[3] = inval;
  }
  if constexpr (SMEM) {
    __syncwarp();
    copy(g.sf_ins, s.sf_ins, Cs);
    copy(g.sf_acc, s.sf_acc, Cs);
    copy(g.cache_seq, s.cache_seq, n_cache);
    copy(g.clock, s.clock, R);
    copy(g.sf_tag, s.sf_tag, Cs);
    copy(g.sf_owner, s.sf_owner, Cs);
    copy(g.cache_tag, s.cache_tag, n_cache);
    copy(g.lfi, s.lfi, F);
    copy(g.sf_dirty, s.sf_dirty, Cs);
    copy(g.present, s.present, F);
  }
}

__global__ void __launch_bounds__(LANES, 1)
sf_scan_kernel(const long long* __restrict__ table, int smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int st_a[STAGE + 1], st_r[STAGE + 1];
  __shared__ unsigned char st_w[STAGE + 1];
  __shared__ long long st_fab[STAGE + 1];
  const Stage st{st_a, st_r, st_w, st_fab};
  const long long* p = table + static_cast<long long>(blockIdx.x) * P_COUNT;
  if (job_bytes(p) <= smem_bytes)
    scan_job<true>(p, smem, st);
  else
    scan_job<false>(p, smem, st);
}

}  // namespace

extern "C" int sf_scan_param_count() { return P_COUNT; }

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
  sf_scan_kernel<<<n_jobs, LANES, smem_bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), smem_bytes);
  return static_cast<int>(cudaGetLastError());
}
