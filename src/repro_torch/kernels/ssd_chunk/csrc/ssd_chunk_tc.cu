// Mamba-2 SSD chunk scan on Hopper's tensor cores (sm_90a: wgmma, TMA,
// mbarriers), for bf16 x, b and c with P and N multiples of 8 (P <= 64,
// N <= 128).  Float32 inputs and other shapes take the CUDA-core kernel in
// ssd_chunk.cu.
//
// Replaces: repro/kernels/ssd_chunk/kernel.py::ssd_chunk_pallas, the Pallas
// TPU kernel computing, for x (B, S, H, P), dt (B, S, H), a_log (H,) and
// b, c (B, S, N) shared by all heads, over chunks of Q steps:
//   cs     = cumsum over the chunk of logA,  logA = -exp(a_log) * dt
//   y_diag = (C B^T . exp(cs_i - cs_j) [j <= i]) (x * dt)
//   y_off  = (C state_in^T) . exp(cs_i)
//   state  = state_in * exp(cs_last) + (x * dt . exp(cs_last - cs_j))^T B
// in float32, with the (P, N) state carried from chunk to chunk in VMEM
// over an ordered grid.  This kernel also writes the state after the last
// step (the reference's _final_state) and, on request (the training
// path), each chunk's incoming state, which ssd_chunk_bwd.cu reads.
//
// Design.  One launch (after a memset of the status words); the chunk
// states go to device memory only on request (the STATES instance).
//   * Work unit: (batch row, head, segment of consecutive chunks), T
//     segments a head (kernel.py::segment_count: as many as one wave of
//     blocks holds, one block an SM; 2 at mamba2-1.3b's B 1, H 64).  A
//     block takes its unit id from an atomicAdd on a counter in the
//     workspace, so every unit before its own was taken by a block that is
//     already running, and segments k - 1 and k of a head have neighbouring
//     ids: a segment never waits on a block that is not resident.  The grid
//     is one-dimensional (B * H * T may pass 65,535).
//   * Two passes a segment.  Pass 1 (every segment but a head's last): the
//     segment's aggregate from a zero state, the state updates over its
//     chunks chained in order, and the product D of its chunk decays.  Then
//     a chained hand-off: segment k waits for segment k - 1's inclusive
//     state and publishes inclusive_k = inclusive_{k-1} D + aggregate_k
//     (payload, __threadfence, then a release store of its status word;
//     the reader polls with acquire and __nanosleep backoff and reads the
//     payload from the L2).  The chain fixes the order of every sum, so two
//     calls give the same bits.  Pass 2: the segment's chunks in order from
//     its incoming state; the last segment writes the final state.  A
//     sequence of one chunk is one unit: no pass 1, no hand-off.
//   * A block is two consumer warpgroups, a producer warp and a scan warp
//     (320 threads).  The producer's first lane streams each chunk (x
//     16 KB, B 32 KB and, in pass 2, C 32 KB) by TMA over the model layout
//     (4-d tensor maps, 128-byte swizzle) into a ring of two stages behind
//     full / empty mbarriers.  Rows past S and columns past P or N arrive
//     as zeros, which neither decay nor contribute.  The scan warp reads
//     the chunk's dt, takes its cumsum in order, one float32 add a step
//     (ref.cumsum: logA rounded, then added; the chunk cumsums reach -10^3
//     on the model's inputs, where another order moves exp(cs_i - cs_j) by
//     about 1e-4), and writes exp(cs_i), w_j = dt_j exp(cs_last - cs_j) and
//     the chunk decay beside it, behind a ready mbarrier: the 128 dependent
//     adds run ahead of the consumers, off their path.
//   * Consumer warpgroup wg owns chunk rows 64 wg .. 64 wg + 63 of y and
//     state columns n 64 wg .. 64 wg + 63.  Per chunk of pass 2:
//       - G = C B^T over keys 0-63 (wgmma, both operands in shared memory,
//         exact bf16, one part), turned in registers into M_ij = G_ij
//         exp(cs_i - cs_j) dt_j for j <= i (the mask multiplies; exp as
//         ex2.approx), split in three parts into A operands, and y = M x
//         (wgmma with A in registers, x read MN-major from the stage); the
//         same over keys 64-127;
//       - y_off = C state_in^T from the incoming state's three bf16 parts
//         in shared memory; y += exp(cs_i) y_off; y to device memory in
//         bf16 by a TMA store, staged over the warpgroup's rows of C;
//       - the state update: state = state * decay + (x w)^T B, x read
//         transposed from the stage by ldmatrix, times w, split in three
//         parts into A operands, B read MN-major; the new state's three
//         parts to shared memory for the next chunk (between chunks the
//         state lives there: hi + mid + lo gives it back exactly).
//     Pass 1 runs the state update alone.  dt sits in M and w, so x stays
//     exact bf16.  Every float32 operand that meets an exact bf16 one (M,
//     x w, the incoming state) goes in three bf16 parts, which carry it
//     exactly; the parts accumulate hi, then mid, then lo.  Products run in
//     groups of two k16 steps (one in the STATES instance) through two A
//     buffers, one formed while the other's products run; every chain of
//     products starts from zero, and its sum with other terms is made on
//     the CUDA cores after the wait.
// What ptxas taught (its notes in the build log; kernel_timing's times):
//   * no product may sit on a branch, even one uniform over the block: a
//     runtime test around each k16 step made every product a group of its
//     own (so all MAX_N columns are multiplied, zeros past N), and a test
//     around a group (skipping state updates whose w underflows, or the
//     keys 64-127 that warpgroup 0 never sees) serialized every wgmma (note
//     C7512); both warpgroups run the same products, warpgroup 0's on an M
//     of zeros;
//   * accumulators written only by their first product (scale-d false with
//     write-only operands) keep the four arrays from living through the
//     loop; before that ptxas serialized every wgmma (C7511);
//   * a select around each exp of M compiled to a branch per value, which
//     left the exps' latencies unoverlapped.
// Shared memory: two stages of 80 KB, the state's three parts (48 KB), the
// scan's arrays: 217,176 bytes, one block an SM; 168 registers (the cap of
// ten warps), no spills.  The STATES instance writes each chunk's incoming
// state from its parts in shared memory (write_states) and forms its A
// operands one k16 step at a time: the served instance sits at the cap, and
// any store of the states on the consumers' path spilled there (72 bytes
// from the registers at the top of each chunk; 24 from the parts with two
// k16 steps); with one, 167 registers and no spills.
//
// Bound on the H100: memory.  One layer's prefill at S = 4096 (B 1, H 64,
// P 64, N 128, x and y bf16) moves 72.4 MB (21.6 us at 3.35 TB/s) against
// 12.9 GFLOP of minimal work.  The kernel does about 53 GFLOP on the tensor
// cores at T = 2 (the three-part splits; G for all 128 x 128 entries a head;
// pass 1 on half the chunks), 54 us at the 989 TFLOP/s bf16 rate; x and B
// are read twice where a segment has a pass 1, the second time mostly from
// the L2.

// Interface: plain C, called through ctypes on PyTorch's current stream;
// the launch is checked with cudaGetLastError and its error code returned
// (0 = success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "../../_hopper.cuh"
#include "../../_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr unsigned FULL = 0xffffffffu;
constexpr int Q = 128;  // chunk length
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int STAGES = 2;
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 64;  // and the producer and scan warps
constexpr int SYNC = 1;                  // the consumers' named barrier
constexpr int STEPS = 2;  // k16 steps of a group of products, A in registers
// a 128-row block of 64 bf16 columns in the 128-byte swizzle, and 64 rows
// of it
constexpr int BLK = Q * 128;
constexpr int HALF = 64 * 128;
// a stage: x (one block), B and C (two blocks each)
constexpr int B_OFF = BLK;
constexpr int C_OFF = 3 * BLK;
constexpr int STAGE = 5 * BLK;
// one bf16 part of the state, (p, n) K-major: two blocks of 64 rows
constexpr int PART = 2 * HALF;
constexpr int PARTS = STAGES * STAGE;
// the scan's arrays a stage: dt, cs, exp(cs), w, then the chunk decay
constexpr int SCAN = PARTS + 3 * PART;
constexpr int SCAN_FLOATS = 4 * Q + 4;
constexpr int BARS = SCAN + STAGES * SCAN_FLOATS * 4;
constexpr int BYTES = BARS + 3 * STAGES * 8 + 8;

struct Args {
  CUtensorMap x, b, c;  // boxes of 64 columns x 128 rows
  CUtensorMap yo;       // y, boxes of 64 columns x 64 rows
  const float* dt;
  const float* a_log;
  float* state;
  float* states;    // each chunk's incoming state (batch, h, nc, p, n)
  int* head;        // the unit counter, then a status word a unit
  float* ws_state;  // an inclusive (p, n) state a unit
  int s, h, p, n, nc, segments;
};

// A descriptor's start-address field (bits 0-13) holds the shared-memory
// address / 16, so the operand `off` bytes further is the descriptor plus
// off / 16 (no carry: shared memory ends below 2^18 bytes).
__device__ __forceinline__ uint64_t at(uint64_t base, int off) {
  return base + static_cast<uint64_t>(off >> 4);
}

// 64 rows of a K-major operand `off` bytes into shared memory, its 64-column
// blocks `blk` bytes apart: the k16 step kk (kbase: the descriptor of the
// shared memory's start, K-major)
__device__ __forceinline__ uint64_t kmajor(uint64_t kbase, int off, int blk,
                                           int kk) {
  return at(kbase, off + (kk >> 2) * blk + (kk & 3) * 32);
}

// one 64-column block of a 128-row tile `off` bytes into shared memory,
// read MN-major (B transposed): the k16 step kk (mbase: the descriptor of
// the shared memory's start, MN-major)
__device__ __forceinline__ uint64_t mnmajor(uint64_t mbase, int off,
                                            int kk) {
  return at(mbase, off + kk * 2048);
}

// exp(x) for x <= 0 as 2^(x log2 e) by the SFU (ex2.approx, 2 ulp), where
// expf takes eight instructions; x log2 e rounds once, so the result is
// within about |x| 2^-24 of exp(x) relatively (6e-6 at x = -100; below
// about -104 both are 0).  Used for M alone: its 64 exps a thread and
// chunk dominated the warpgroups' work there.
__device__ __forceinline__ float exp_fast(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// STATES: also write each chunk's incoming state (the training path); the
// served path is the instance without, its code unchanged
template <bool STATES>
__global__ void __launch_bounds__(THREADS, 1)
ssd_tc(const __grid_constant__ Args a) {
  // k16 steps of a group of products, A in registers: the STATES instance
  // takes one, which frees the registers its chunk states' write needs (with
  // two it spilled); the served instance's code is unchanged
  constexpr int KSTEPS = STATES ? 1 : STEPS;
  extern __shared__ __align__(1024) unsigned char sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + BARS);
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;
  int* unit_s = reinterpret_cast<int*>(empty + STAGES);
  const int tid = threadIdx.x;

  if (tid == 0) {
    if (smem_u32(sm) % 1024 != 0) __trap();
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(ready + i, 1);
      mbar_init(empty + i, CONSUMERS / 32);
    }
    mbar_fence_init();
    *unit_s = atomicAdd(a.head, 1);
  }
  if (a.n <= 64) {
    // TMA loads one 64-column block of B and C: the other stays zero
    for (int e = tid; e < STAGES * 2 * (BLK / 16); e += THREADS) {
      const int st = e / (2 * (BLK / 16)), r = e % (2 * (BLK / 16));
      reinterpret_cast<uint4*>(sm + st * STAGE +
                               (r < BLK / 16 ? B_OFF : C_OFF) +
                               BLK)[r % (BLK / 16)] = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
  __syncthreads();

  const int unit = *unit_s;
  const int T = a.segments;
  const int bh = unit / T, k = unit - bh * T;
  const int bi = bh / a.h, hd = bh - bi * a.h;
  const int c_lo = static_cast<int>(static_cast<long long>(k) * a.nc / T);
  const int c_hi = static_cast<int>(static_cast<long long>(k + 1) * a.nc / T);
  const int n1 = k < T - 1 ? c_hi - c_lo : 0;  // chunks of pass 1
  const int items = n1 + c_hi - c_lo;           // chunks streamed
  auto chunk_of = [&](int i) { return c_lo + (i < n1 ? i : i - n1); };
  auto scan_of = [&](int i) {
    return reinterpret_cast<float*>(sm + SCAN) + (i % STAGES) * SCAN_FLOATS;
  };

  if (tid >= CONSUMERS) {
    const int lane = tid & 31;
    if (tid == CONSUMERS) {  // the producer warp's first lane: the loads
      const int nb = (a.n + 63) / 64;
      for (int i = 0; i < items; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + st, (i / STAGES - 1) & 1);
        const bool with_c = i >= n1;
        const int t0 = chunk_of(i) * Q;
        unsigned char* base = sm + st * STAGE;
        mbar_expect_tx(full + st, BLK + (with_c ? 2 : 1) * nb * BLK);
        tma_load_4d(base, &a.x, full + st, 0, hd, t0, bi);
        for (int cb = 0; cb < nb; ++cb) {
          tma_load_4d(base + B_OFF + cb * BLK, &a.b, full + st, cb * 64, 0,
                      t0, bi);
          if (with_c)
            tma_load_4d(base + C_OFF + cb * BLK, &a.c, full + st, cb * 64, 0,
                        t0, bi);
        }
      }
    } else if (tid >= CONSUMERS + 32) {  // the scan warp
      const float al = -expf(a.a_log[hd]);
      // the chunk's dt (zero past S), loaded one item ahead so that the
      // loads run under the item before's cumsum
      auto load_dt = [&](int i, float (&v)[Q / 32]) {
        const int t0 = chunk_of(i) * Q;
#pragma unroll
        for (int m = 0; m < Q / 32; ++m) {
          const int j = lane + 32 * m;
          v[m] = t0 + j < a.s ? a.dt[(static_cast<long long>(bi) * a.s + t0 +
                                      j) * a.h + hd]
                              : 0.f;
        }
      };
      float next[Q / 32];
      load_dt(0, next);
      for (int i = 0; i < items; ++i) {
        const int st = i % STAGES;
        float cur[Q / 32];
#pragma unroll
        for (int m = 0; m < Q / 32; ++m) cur[m] = next[m];
        if (i + 1 < items) load_dt(i + 1, next);
        if (i >= STAGES) mbar_wait(empty + st, (i / STAGES - 1) & 1);
        float* f = scan_of(i);
#pragma unroll
        for (int m = 0; m < Q / 32; ++m) f[lane + 32 * m] = cur[m];
        __syncwarp();
        if (lane == 0) {
          float run = 0.f;
#pragma unroll 16
          for (int j = 0; j < Q; ++j) {
            run = __fadd_rn(run, __fmul_rn(al, f[j]));
            f[Q + j] = run;
          }
        }
        __syncwarp();
        const float last = f[2 * Q - 1];
#pragma unroll
        for (int m = 0; m < Q / 32; ++m) {
          const int j = lane + 32 * m;
          f[2 * Q + j] = expf(f[Q + j]);
          f[3 * Q + j] = __fmul_rn(f[j], expf(__fsub_rn(last, f[Q + j])));
        }
        if (lane == 0) f[4 * Q] = expf(last);
        __syncwarp();
        if (lane == 0) mbar_arrive(ready + st);
      }
    }
    return;
  }

  // the consumers; the warpgroup broadcast from lane 0, so that the
  // compiler sees it uniform
  const int wg = __shfl_sync(FULL, tid >> 7, 0);
  const int w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  const int pr = 16 * w + g;  // this thread's state rows pr, pr + 8
  const int ir = 64 * wg + pr;  // and chunk rows ir, ir + 8
  const long long pn = static_cast<long long>(a.p) * a.n;
  unsigned char* parts = sm + PARTS;

  // the state (rows p, columns n of this warpgroup's half) and its update,
  // y (rows i, columns p), G or y_off (rows i, 64 columns), and two buffers
  // of A operands (KSTEPS k16 steps in three parts), so that one is formed
  // while the other's products run.  Every chain of products starts from
  // zero with a product that only writes its accumulators (the compiler
  // then keeps no earlier value of them alive: with all four arrays live
  // through the loop ptxas serialized every wgmma, note C7511); its sums
  // with other values are made after the wait, on the CUDA cores.
  float st[32], y[32], gacc[32], cacc[32];
  uint32_t A[2][3][KSTEPS][4];
#pragma unroll
  for (int r = 0; r < 32; ++r) st[r] = 0.f;

  // the descriptors of the shared memory's start, made anew for each chunk
  // (the empty asm hides that they do not change, so that the compiler
  // does not hoist every operand's descriptor out of the loop into
  // registers of its own)
  auto bases = [&](uint64_t& kbase, uint64_t& mbase) {
    const unsigned char* p = sm;
    asm volatile("" : "+l"(p));
    kbase = desc_sw128(p, 16, 1024);
    mbase = desc_sw128(p, BLK, 1024);
  };
  auto wait_in = [&](int i) {
    mbar_wait(full + i % STAGES, (i / STAGES) & 1);
    mbar_wait(ready + i % STAGES, (i / STAGES) & 1);
  };
  auto release = [&](int i) {  // this warp is done with the stage
    __syncwarp();
    if (lane == 0) {
      if ((tid & 127) == 0) bulk_wait<true>();  // y's store has read it
      mbar_arrive(empty + i % STAGES);
    }
  };
  // the values of A buffer b are made here (not moved by the compiler)
  auto fence_a = [&](int b) {
#pragma unroll
    for (int q = 0; q < 3; ++q) fence_regs(A[b][q]);
  };
  // d (+)= A_b B over KSTEPS k16 steps from k16 step kk0 of the MN-major
  // operand `off` bytes into shared memory (d overwritten when `fresh`);
  // committed, not waited for
  auto issue_rs = [&](float(&d)[32], int b, uint64_t mbase, int off, int kk0,
                      bool fresh) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint64_t db = mnmajor(mbase, off, kk0 + kk);
      if (fresh && kk == 0)
        wgmma_rs_n64_first(d, A[b][0][kk], db);
      else
        wgmma_rs_n64(d, A[b][0][kk], db);
      wgmma_rs_n64(d, A[b][1][kk], db);
      wgmma_rs_n64(d, A[b][2][kk], db);
    }
    wgmma_commit();
  };
  // gacc = C E^T over all MAX_N columns (zero past N): C this warpgroup's
  // chunk rows, E 64 rows K-major `off` bytes into shared memory, its
  // 64-column blocks `blk` bytes apart; `parts` of them (E, E + PART, ...)
  // summed; committed.  No product sits on a branch: ptxas makes every
  // product behind a runtime test a group of its own, waited for before
  // the next.
  auto issue_ss = [&](uint64_t kbase, int crow, int off, int blk,
                      int parts) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MAX_N / 16; ++kk) {
      const uint64_t da = kmajor(kbase, crow, BLK, kk);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        if (q < parts) {
          const uint64_t db = kmajor(kbase, off + q * PART, blk, kk);
          if (kk + q == 0)
            wgmma_ss_n64_first(gacc, da, db);
          else
            wgmma_ss_n64(gacc, da, db, 1);
        }
    }
    wgmma_commit();
  };
  // (x w)^T over the chunk steps of k16 steps kk0 .. kk0 + KSTEPS - 1 into A
  // buffer b: x read transposed by ldmatrix from the swizzled stage
  auto form_xw = [&](int b, const unsigned char* xs, const float* wv,
                     int kk0) {
    const int mat = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int j0 = 16 * (kk0 + kk);
      const int j = j0 + 8 * (mat >> 1) + (lane & 7);
      const int ch = 2 * w + (mat & 1);
      uint32_t v[4];
      mma::ldmatrix_x4_trans(v, xs + j * 128 + ((ch ^ (j & 7)) << 4));
      const float2 w0 = *reinterpret_cast<const float2*>(wv + j0 + 2 * qd);
      const float2 w1 =
          *reinterpret_cast<const float2*>(wv + j0 + 8 + 2 * qd);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[r]));
        const float2 ww = r < 2 ? w0 : w1;
        mma::split3(__fmul_rn(xv.x, ww.x), __fmul_rn(xv.y, ww.y),
                    A[b][0][kk][r], A[b][1][kk][r], A[b][2][kk][r]);
      }
    }
    fence_a(b);
  };
  // M over the keys of k16 steps kk0 .. kk0 + KSTEPS - 1 of the 64 keys from
  // 64 cb, from G's accumulators, into A buffer b.  Straight-line code: a
  // select around each exp made the compiler branch around it, one value
  // at a time, and the exps' latencies no longer overlapped; so every exp
  // is taken (of 0 above the diagonal, where exp(cs_i - cs_j) would
  // overflow) and the causal mask multiplies.  Warpgroup 0's rows see no
  // key of block 1: its M there is 0 and no exp is taken.
  auto form_m = [&](int b, const float* f, int cb, int kk0) {
    const float* cs = f + Q;
    const float c0 = cs[ir], c1 = cs[ir + 8];
    const bool seen = 64 * cb <= 64 * wg + 63;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      float m[8] = {};
      if (seen) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = 2 * (kk0 + kk) + u;
          const int j = 64 * cb + 8 * t + 2 * qd;
          const float2 cj = *reinterpret_cast<const float2*>(cs + j);
          const float2 dj = *reinterpret_cast<const float2*>(f + j);
          const float* gv = gacc + 4 * t;
          const float sj[2] = {cj.x, cj.y}, dtj[2] = {dj.x, dj.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool causal = j + (e & 1) <= (e < 2 ? ir : ir + 8);
            const float ex =
                exp_fast(causal ? __fsub_rn(e < 2 ? c0 : c1, sj[e & 1]) : 0.f);
            m[4 * u + e] = __fmul_rn(__fmul_rn(gv[e], ex), dtj[e & 1]) *
                           (causal ? 1.f : 0.f);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        mma::split3(m[2 * r], m[2 * r + 1], A[b][0][kk][r], A[b][1][kk][r],
                    A[b][2][kk][r]);
    }
    fence_a(b);
  };
  // cacc = (x w)^T B over this warpgroup's columns, the four groups of k16
  // steps in turn through the two A buffers; then state = state * decay +
  // cacc
  auto update = [&](int so, const float* f, uint64_t mbase) {
    const int boff = so + B_OFF + wg * BLK;
#pragma unroll
    for (int grp = 0; grp < Q / 16 / KSTEPS; ++grp) {
      if (grp >= 2) wgmma_wait<1>();  // the buffer's last products are done
      form_xw(grp & 1, sm + so, f + 3 * Q, grp * KSTEPS);
      issue_rs(cacc, grp & 1, mbase, boff, grp * KSTEPS, grp == 0);
    }
    wgmma_wait<0>();
    fence_regs(cacc);
    const float d = f[4 * Q];
#pragma unroll
    for (int r = 0; r < 32; ++r)
      st[r] = __fadd_rn(__fmul_rn(st[r], d), cacc[r]);
  };
  // this thread's elements of a (p, n) float32 state in device memory
  auto each_elem = [&](auto&& fn) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int n = 64 * wg + 8 * t + 2 * qd;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = pr + 8 * hf;
        fn(st[4 * t + 2 * hf], st[4 * t + 2 * hf + 1],
           p < a.p && n < a.n ? static_cast<long long>(p) * a.n + n : -1LL);
      }
    }
  };

  // this thread's elements of the state in the three parts that y_off
  // reads (after every consumer is done with the parts before), and back
  auto part_off = [&](int t, int hf) {
    const int p = pr + 8 * hf, nl = 8 * t + 2 * qd;
    return wg * HALF + p * 128 + (((nl >> 3) ^ (p & 7)) << 4) + (nl & 7) * 2;
  };
  // STATES: the parts are chunk `ci`'s incoming state, which goes to
  // device memory from them (hi + mid + lo, exact), 16 bytes a thread and
  // store, consecutive threads on consecutive addresses.  (Written from the
  // registers at the top of each chunk, it kept them live through the
  // chunk: 72 bytes of spill stores.)
  auto write_states = [&](int ci) {
    const unsigned char* src = parts;
    asm volatile("" : "+l"(src));  // made here, not hoisted out of the loop
    float* out = a.states + (static_cast<long long>(bh) * a.nc + ci) * pn;
    const int quads = static_cast<int>(pn / 4), row = a.n / 4;
    int e0 = tid;  // made here too: no offset of the loop kept in a register
    asm volatile("" : "+r"(e0));
    for (int e = e0; e < quads; e += CONSUMERS) {
      const int p = e / row, n = 4 * (e - p * row);
      const int off = (n >> 6) * HALF + p * 128 +
                      ((((n & 63) >> 3) ^ (p & 7)) << 4) + (n & 7) * 2;
      float v[3][4];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const uint2 raw = *reinterpret_cast<const uint2*>(src + q * PART + off);
        const float2 e01 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 e23 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        v[q][0] = e01.x, v[q][1] = e01.y, v[q][2] = e23.x, v[q][3] = e23.y;
      }
      float4 o;
      o.x = __fadd_rn(__fadd_rn(v[0][0], v[1][0]), v[2][0]);
      o.y = __fadd_rn(__fadd_rn(v[0][1], v[1][1]), v[2][1]);
      o.z = __fadd_rn(__fadd_rn(v[0][2], v[1][2]), v[2][2]);
      o.w = __fadd_rn(__fadd_rn(v[0][3], v[1][3]), v[2][3]);
      *reinterpret_cast<float4*>(out + 4LL * e) = o;
    }
  };
  auto write_parts = [&](int ci) {
    named_sync(SYNC, CONSUMERS);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t hi, mid, lo;
        mma::split3(st[4 * t + 2 * hf], st[4 * t + 2 * hf + 1], hi, mid, lo);
        const int off = part_off(t, hf);
        *reinterpret_cast<uint32_t*>(parts + off) = hi;
        *reinterpret_cast<uint32_t*>(parts + PART + off) = mid;
        *reinterpret_cast<uint32_t*>(parts + 2 * PART + off) = lo;
      }
    fence_proxy_async();
    named_sync(SYNC, CONSUMERS);
    if constexpr (STATES) write_states(ci);
  };
  auto read_parts = [&]() {
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int off = part_off(t, hf);
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(parts + off));
        const float2 mid = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(parts + PART + off));
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(parts + 2 * PART + off));
        st[4 * t + 2 * hf] = __fadd_rn(__fadd_rn(hi.x, mid.x), lo.x);
        st[4 * t + 2 * hf + 1] = __fadd_rn(__fadd_rn(hi.y, mid.y), lo.y);
      }
  };

  // pass 1: the segment's aggregate from a zero state, and its decay
  float decay = 1.f;
  for (int i = 0; i < n1; ++i) {
    uint64_t kbase, mbase;
    bases(kbase, mbase);
    wait_in(i);
    const float* f = scan_of(i);
    decay = __fmul_rn(decay, f[4 * Q]);
    update((i % STAGES) * STAGE, f, mbase);
    release(i);
  }

  // the chained hand-off: inclusive_k = inclusive_{k-1} decay + aggregate
  if (T > 1) {
    int* status = a.head + 1;
    float* mine = a.ws_state + static_cast<long long>(unit) * pn;
    if (k > 0) {
      if (tid == 0) {
        const long long start = clock64();
        unsigned ns = 32;
        while (ld_acquire(status + unit - 1) == 0) {
          __nanosleep(ns);
          ns = min(ns * 2, 1024u);
          if (clock64() - start > (1LL << 34)) __trap();
        }
      }
      named_sync(SYNC, CONSUMERS);
      const float* prev = mine - pn;
      each_elem([&](float& s0, float& s1, long long off) {
        const float2 v = off >= 0 ? __ldcg(reinterpret_cast<const float2*>(
                                        prev + off))
                                  : make_float2(0.f, 0.f);
        if (n1 > 0 && off >= 0)
          *reinterpret_cast<float2*>(mine + off) =
              make_float2(__fadd_rn(__fmul_rn(v.x, decay), s0),
                          __fadd_rn(__fmul_rn(v.y, decay), s1));
        s0 = v.x;
        s1 = v.y;
      });
    } else {
      each_elem([&](float& s0, float& s1, long long off) {
        if (off >= 0)
          *reinterpret_cast<float2*>(mine + off) = make_float2(s0, s1);
        s0 = s1 = 0.f;
      });
    }
    if (n1 > 0) {
      __threadfence();
      named_sync(SYNC, CONSUMERS);
      if (tid == 0) st_release(status + unit, 1);
    }
  }

  // pass 2: the outputs.  Between chunks the state lives in shared memory
  // as its three bf16 parts, which y_off reads and which give it back
  // exactly (hi + mid + lo, each sum exact) to the accumulators for the
  // update: its registers are free while y is made.
  write_parts(chunk_of(n1));
  for (int i = n1; i < items; ++i) {
    const int t0 = chunk_of(i) * Q;
    const int so = (i % STAGES) * STAGE;  // the stage's offset
    const int crow = so + C_OFF + wg * HALF;  // this warpgroup's rows of C
    const float* f = scan_of(i);
    uint64_t kbase, mbase;
    bases(kbase, mbase);
    wait_in(i);

    // y = M x over keys 0-63, then 64-127, each G = C B^T made first; each
    // group of M's A operands made while the group before runs
#pragma unroll
    for (int cb = 0; cb < 2; ++cb) {
      issue_ss(kbase, crow, so + B_OFF + cb * HALF, BLK, 1);
      wgmma_wait<0>();
      fence_regs(gacc);
#pragma unroll
      for (int grp = 0; grp < 4 / KSTEPS; ++grp) {
        if (grp >= 2) wgmma_wait<1>();  // the buffer's last products are done
        form_m(grp & 1, f, cb, grp * KSTEPS);
        issue_rs(y, grp & 1, mbase, so, 4 * cb + grp * KSTEPS,
                 cb == 0 && grp == 0);
      }
    }
    // y_off = C state_in^T, the incoming state in its three parts; y +=
    // exp(cs_i) y_off
    issue_ss(kbase, crow, PARTS, HALF, 3);
    wgmma_wait<0>();
    fence_regs(y);
    fence_regs(gacc);
    {
      const float e0 = f[2 * Q + ir], e1 = f[2 * Q + ir + 8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        y[4 * t] = __fadd_rn(__fmul_rn(gacc[4 * t], e0), y[4 * t]);
        y[4 * t + 1] = __fadd_rn(__fmul_rn(gacc[4 * t + 1], e0), y[4 * t + 1]);
        y[4 * t + 2] = __fadd_rn(__fmul_rn(gacc[4 * t + 2], e1), y[4 * t + 2]);
        y[4 * t + 3] = __fadd_rn(__fmul_rn(gacc[4 * t + 3], e1), y[4 * t + 3]);
      }
    }
    {
      // y in bf16 to device memory by TMA, staged over this warpgroup's
      // rows of C (read by no other product of this chunk) in the layout
      // the store reads; rows past S and columns past P are not written
      unsigned char* ys = sm + crow;
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = pr + 8 * hf;
          *reinterpret_cast<__nv_bfloat162*>(ys + r * 128 +
                                             ((t ^ (r & 7)) << 4) + 4 * qd) =
              __floats2bfloat162_rn(y[4 * t + 2 * hf], y[4 * t + 2 * hf + 1]);
        }
      fence_proxy_async();
      named_sync(SYNC + 1 + wg, 128);
      if ((tid & 127) == 0) {
        tma_store_4d(&a.yo, ys, 0, hd, t0 + 64 * wg, bi);
        bulk_commit();
      }
    }
    read_parts();
    update(so, f, mbase);
    // the new state's parts, once every consumer is done with the old
    if (i + 1 < items) write_parts(chunk_of(i + 1));
    release(i);
  }

  if ((tid & 127) == 0) bulk_wait<false>();
  if (k == T - 1) {
    float* out = a.state + static_cast<long long>(bh) * pn;
    each_elem([&](float& s0, float& s1, long long off) {
      if (off >= 0) *reinterpret_cast<float2*>(out + off) = make_float2(s0, s1);
    });
  }
}

long long header_ints(long long units) { return (1 + units + 3) / 4 * 4; }

}  // namespace

extern "C" int ssd_chunk_tc_len() { return Q; }
extern "C" int ssd_chunk_tc_max_p() { return MAX_P; }
extern "C" int ssd_chunk_tc_max_n() { return MAX_N; }
extern "C" int ssd_chunk_tc_smem() { return BYTES; }

template <bool STATES>
int launch(const Args& a, long long units, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_tc<STATES>, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_tc<STATES><<<static_cast<unsigned>(units), THREADS, BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// bytes of the workspace a call with `units` = batch * h * segments takes:
// the unit counter and a status word a unit (zeroed by the launch, padded
// to 16 bytes), then a (p, n) float32 state a unit
extern "C" long long ssd_chunk_tc_workspace(long long units, int p, int n) {
  return header_ints(units) * 4 + units * p * n * 4;
}

// x, y: (batch, s, h, p); b, c: (batch, s, n), all bf16 and 16-byte
// aligned; dt: (batch, s, h) and a_log: (h,) float32; final_state: (batch,
// h, p, n) float32; ws: ssd_chunk_tc_workspace(batch * h * segments, p, n)
// bytes, 16-byte aligned; states: null, or (batch, h, ceil(s / Q), p, n)
// float32 for each chunk's incoming state.  Everything contiguous; p and n
// multiples of 8, p <= MAX_P, n <= MAX_N, 1 <= segments <= ceil(s / Q).
extern "C" int ssd_chunk_tc_launch(const void* x, const float* dt,
                                   const float* a_log, const void* b,
                                   const void* c, void* y, float* final_state,
                                   void* ws, float* states, int batch, int s,
                                   int h, int p, int n, int segments,
                                   cudaStream_t stream) {
  const int nc = s > 0 ? (s + Q - 1) / Q : 0;
  const long long units = static_cast<long long>(batch) * h * segments;
  if (batch <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || p > MAX_P ||
      n > MAX_N || p % 8 != 0 || n % 8 != 0 || segments < 1 ||
      segments > nc || units >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {x, b, c, static_cast<const void*>(y),
                          static_cast<const void*>(ws)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  Args a{};
  int err = bf16_map_4d(&a.x, x, p, h, s, batch, Q);
  if (err == 0) err = bf16_map_4d(&a.b, b, n, 1, s, batch, Q);
  if (err == 0) err = bf16_map_4d(&a.c, c, n, 1, s, batch, Q);
  if (err == 0) err = bf16_map_4d(&a.yo, y, p, h, s, batch, 64);
  if (err != 0) return err;
  a.dt = dt;
  a.a_log = a_log;
  a.state = final_state;
  a.states = states;
  a.head = static_cast<int*>(ws);
  a.ws_state = reinterpret_cast<float*>(static_cast<int*>(ws) +
                                        header_ints(units));
  a.s = s, a.h = h, a.p = p, a.n = n, a.nc = nc, a.segments = segments;
  const cudaError_t e = cudaMemsetAsync(ws, 0, header_ints(units) * 4, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return states != nullptr ? launch<true>(a, units, stream)
                           : launch<false>(a, units, stream);
}
