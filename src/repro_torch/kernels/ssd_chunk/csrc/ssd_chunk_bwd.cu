// The gradient of the Mamba-2 SSD chunk scan on Hopper's tensor cores
// (sm_90a: wgmma, TMA, mbarriers), for bf16 x, b, c and dY with P and N
// multiples of 8 (P <= 64, N <= 128): the types and shapes the models train
// in.
//
// Replaces nothing on the TPU: repro/kernels/ssd_chunk/kernel.py::
// ssd_chunk_pallas has no gradient, and the JAX package trains an ssd layer
// by autodiff through its plain ssd_chunked.  The port trains through its
// forward kernel (ssd_chunk_tc.cu, which writes each chunk's incoming state
// S on request) and this kernel gives it its gradient.  Per batch row, head
// and chunk of Q steps (ref.ssd_chunk_bwd_plain has the derivation):
//   G = C B^T, L_ij = exp(cs_i - cs_j) [j <= i], M = G . L . dt_j,
//   w_j = dt_j exp(cs_Q - cs_j);  R = the adjoint of the state after the
//   chunk, walked from the last chunk (seeded with dS_final):
//   R_before = exp(cs_Q) R + (dY . exp(cs))^T C;
//   dx    = M^T dY + w . (B R^T)
//   dG    = (dY x^T) . L . dt_j
//   dB    = sum_h [dG^T C + w . (x R)]
//   dC    = sum_h [dG B + exp(cs) . (dY S)]
//   ddt_j = sum_i dM_ij G_ij L_ij + exp(cs_Q - cs_j) q_j - a dl_j,
//           q_j = x_j . R B_j
//   dcs   = rowsum(dM M) - colsum(dM M) + u - v, dcs_Q += sum v +
//           exp(cs_Q) <R, S>, dl = its reverse cumsum, da_log = sum dl l.
//
// Design.  Three launches after a memset of the status words; no float
// atomics, so two calls give the same bits.
//   1. ssd_bwd_walk, the adjoint walk: the forward's state update mirrored
//      (x w -> dY exp(cs), B -> C, the chunks walked from the last).  A
//      block per (batch row, head, segment of chunks), T segments a head
//      (kernel_bwd.walk_segments: 1 at mamba2-1.3b's B 1, H 64), handed out
//      from a head's last segment by an atomic counter, so a segment waits
//      only for one already running.  Pass 1 (every segment but a head's
//      first): the segment's adjoint aggregate from zero and the product D
//      of its chunk decays.  The reverse chained hand-off: inclusive_k =
//      inclusive_{k+1} D + aggregate_k, the last segment seeded with
//      dS_final.  Pass 2: each chunk's R (the adjoint after it) goes out in
//      float32 (its image: staged in shared memory, 16-byte granules
//      swizzled by the row, one bulk store), <R, S> as eight warp partials
//      (S, the forward's chunk state, in the stage); then the update.  A
//      producer warp streams dY, C and S by TMA into a two-stage ring behind
//      mbarriers; a scan warp takes the chunk's cumsum in order (ref.cumsum)
//      and exp(cs) off the consumers' path; two consumer warpgroups own 64
//      state columns n each and run (dY exp(cs))^T C on wgmma, the A operand
//      formed in registers in three bf16 parts.
//   2. ssd_bwd_grads, the chunk gradients, chunk-parallel: a block per
//      (batch row, chunk, group of heads), kernel_bwd.head_group heads (8 at
//      mamba2-1.3b's layer, 256 blocks); no hand-off, since each chunk's S
//      and R are in device memory.  B and C stay in shared memory for the
//      block.  A producer warp streams, per head, x and dY by TMA into one
//      slot and R or S (float32, bulk copies) into another, each behind its
//      own full / empty mbarriers; a scan warp takes every head's cumsum
//      first.  Consumer warpgroup wg owns chunk rows 64 wg .. 64 wg + 63.
//      The consumers split R or S into its three parts in place.  Three
//      walks over the group's heads:
//        J (rows j; x, dY, R): 32 keys i at a time, G^T = B C^T and dM^T =
//          x dY^T (m64n32, both operands in shared memory), turned in
//          registers into M^T (split in three parts into A operands of
//          dx = M^T dY) and dG^T, added in head order to the group's dG^T,
//          float32 in shared memory (each element always by one thread);
//          warpgroup 1 skips the keys i < 64, above the diagonal of all its
//          rows (exactly: only zeros leave the sums); the column sums of
//          dM M and of dM G L per row j (quad sums), its row sums per
//          column i (warp shuffles, then eight warp partials summed in
//          order); then B R^T (R's parts as the B operand) and dx = M^T dY
//          + w B R^T out in bf16;
//        K (rows j; x, R): dB = dG_grp^T C once (A from the group's dG^T,
//          split in three parts, C read MN-major), then per head, in head
//          order, dB += w . (x R) (R's parts read MN-major); q_j = B_j .
//          x R_j, v = w q, ddt's partial dM G L + exp(cs_Q - cs) q;
//        I (rows i; dY, S): dC = dG_grp B once (dG^T read transposed), then
//          per head u_i = exp(cs_i) dY_i . S C_i and dC += exp(cs) . (dY
//          S); once dG_grp B is made, the dG region is a second slot, so
//          that I's items load while the item before is used.
//      The group's dB and dC go out as float32 partials, one a group.
//   3. ssd_bwd_sum: dB and dC summed over the groups in order; a warp per
//      (batch row, chunk, head): d cs = ((rowsum - colsum) + u) - v, its
//      reverse cumsum one add a step from sum v + exp(cs_Q) <R, S>, ddt,
//      and da_log's share; a head's last block to finish (an integer
//      counter) sums da_log over batch rows, then chunks, in order.
//   Every float32 operand against an exact bf16 one (R, S, M, dG, dY exp(cs))
//   goes in three bf16 parts (kernels/_mma.cuh::split3), which carry it
//   exactly.  Rows past S and columns past P or N are zeros, which neither
//   decay nor contribute.  No product sits on a runtime branch and every
//   chain of products starts with one that only writes its accumulators
//   (PR 32's lessons, ssd_chunk_tc.cu); causal zeros are multiplied.
// What ptxas taught (its notes in the build log): addresses that do not
// change from head to head (the dG, B and dY tile offsets of a thread) were
// hoisted out of the head loops and held in registers: ptxas serialized
// every wgmma (C7512), then spilled; they are now derived anew from values
// an empty asm makes opaque (as bases() does for the descriptors), the
// warpgroup index too, and J's key quarters run in a rolled loop (fully
// unrolled, the scheduler hoisted all four quarters' work and spilled).
// Shared memory: the walk 199,768 bytes (two stages of 80 KB: dY, C, S;
// R's image staged, 32 KB; the scan's arrays); the gradients 230,528 (B and
// C 64 KB, the x / dY slot 32 KB, the R / S slot 48 KB, dG over the group
// 64 KB float32, eight heads' cs and dt 8 KB, the row-sum partials 8 KB,
// two column-sum rows): one block an SM each; ten warps cap a thread at 168
// registers (the walk takes 156, the gradients 168), no spills.
//
// Bound on the H100: memory, narrowly.  At mamba2-1.3b's layer (B 1,
// S 4,096, H 64, P 64, N 128) the gradient moves 111.1 MB (x, dY, dx, B and
// C in bf16; dt, ddt, dS_final, dB and dC in float32), 0.0332 ms, against
// 30.5 GFLOP of products at one bf16 part each (dM and M^T dY per head,
// B R^T, x R, dY S, C S^T and the R update per head, G, dG^T C and dG B
// once a batch row with dG summed over the heads), 0.0308 ms.  These
// kernels do about 90 GFLOP on the tensor cores (three parts; G^T per head
// and warpgroup; the causal zeros of warpgroup 0's keys) and add R (67 MB
// written and read twice: J and K), the forward's 67 MB of chunk states
// (read by the walk and by I), x and dY a second time, and the group
// partials (2 x 16.8 MB at eight heads a group).
//
// Interface: plain C, called through ctypes on PyTorch's current stream;
// each launch is checked with cudaGetLastError and its error code returned
// (0 = success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../_hopper.cuh"
#include "../../_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr unsigned FULL = 0xffffffffu;
constexpr int Q = 128;  // chunk length
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 64;  // and the producer and scan warps
constexpr int SYNC = 1;                  // the consumers' named barrier
constexpr int STEPS = 2;  // k16 steps of a group of products, A in registers
constexpr int GSTEPS = 1;  // the same in the gradients (registers)
constexpr int GMAX = 8;   // heads a group, at most
// a 128-row block of 64 bf16 columns in the 128-byte swizzle, and 64 rows
// of it
constexpr int BLK = Q * 128;
constexpr int HALF = 64 * 128;
// one bf16 part of a (p, n) state, K-major along n: two blocks of 64 rows;
// the three parts (hi, mid, lo)
constexpr int PART = 2 * HALF;
constexpr int PARTS_BYTES = 3 * PART;
// a (p, n) adjoint R in float32 as the walk writes it: MAX_P rows of MAX_N
// floats, 16-byte granules swizzled by the row (img_at)
constexpr int IMG_BYTES = MAX_P * MAX_N * 4;

// the walk: a stage holds dY (one block), C (two blocks) and, in pass 2, S
// (float32, P x N)
namespace walk {
constexpr int STAGES = 2;
constexpr int C_OFF = BLK;
constexpr int S_OFF = 3 * BLK;
constexpr int STAGE = 5 * BLK;
constexpr int IMG = STAGES * STAGE;  // R's image, staged for the store
// the scan's arrays a stage: dt, cs, exp(cs), then the chunk decay
constexpr int SCAN = IMG + IMG_BYTES;
constexpr int SCAN_FLOATS = 3 * Q + 4;
constexpr int BARS = SCAN + STAGES * SCAN_FLOATS * 4;
constexpr int BYTES = BARS + 3 * STAGES * 8 + 8;
}  // namespace walk

// the gradients
namespace grads {
constexpr int BT = 0;           // B (two blocks)
constexpr int CT = 2 * BLK;     // C (two blocks)
constexpr int XS = 4 * BLK;     // x (the x / dY slot)
constexpr int DYS = 5 * BLK;    // dY
constexpr int RP = 6 * BLK;  // R's or S's three parts (the R / S slot;
                             // the float32 lands there first)
constexpr int DG = RP + PARTS_BYTES;  // dG^T over the group, float32 (j, i)
constexpr int SCS = DG + Q * Q * 4;   // each head's cs, GMAX x Q
constexpr int SDT = SCS + GMAX * Q * 4;  // and dt
constexpr int RED = SDT + GMAX * Q * 4;  // row-sum partials, 2 x 8 warps x Q
constexpr int SCOL = RED + 2 * 8 * Q * 4;  // column sums, 2 x Q
constexpr int BARS = SCOL + 2 * Q * 4;
// full_bc, full_xy, empty_xy, full_r, empty_r, full_b, empty_b, dg_free,
// ready[GMAX]
constexpr int BYTES = BARS + (8 + GMAX) * 8;
}  // namespace grads

static_assert(grads::BYTES <= 232448, "the gradients' shared memory");

struct WalkArgs {
  CUtensorMap dy, c;  // boxes of 64 columns x 128 rows
  const float* dt;
  const float* a_log;
  const float* dstate;  // (batch, h, p, n) or null (zero)
  const float* states;  // each chunk's incoming state (batch, h, nc, p, n)
  int* head;            // the unit counter, then a status word a unit
  float* ws_state;      // an inclusive (p, n) adjoint a unit
  float* ws_r;          // R's image a (batch, h, chunk)
  float* rs8;           // <R, S>: eight warp partials a (batch, h, chunk)
  int s, h, p, n, nc, segments;
};

struct GradArgs {
  CUtensorMap x, dy, b, c;  // boxes of 64 columns x 128 rows
  const float* dt;
  const float* a_log;
  const float* states;
  const float* ws_r;
  bf16* dx;
  // per (batch, chunk, h, step): rowsum - colsum of dM M, u, v, and ddt's
  // partial; per (batch, chunk, h): the chunk decay
  float *rc, *u, *v, *ddtp, *dec;
  float *dbp, *dcp;  // the groups' partials (batch, groups, nc Q, n)
  int s, h, p, n, nc, group, groups;
};

struct SumArgs {
  const float* dt;
  const float* a_log;
  const float *rc, *u, *v, *ddtp, *dec, *rs8, *dbp, *dcp;
  float* share;  // da_log's share a (batch, h, chunk)
  int* count;    // the blocks of each head done (zeroed by the launch)
  float *ddt, *da, *db, *dc;
  int batch, s, h, n, nc, groups;
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

// 64 columns of an operand read MN-major (the k index down its rows), `off`
// bytes into shared memory: the k16 step kk
__device__ __forceinline__ uint64_t mnmajor(uint64_t mbase, int off,
                                            int kk) {
  return at(mbase, off + kk * 2048);
}

// d = the sum over K k16 steps of A (64 rows K-major at `aoff`, blocks
// `ablk` apart) times NP parts of B (64 rows K-major at `boff`, blocks
// `bblk` apart, parts PART apart); issued, not committed
template <int K, int NP>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t kbase,
                                       int aoff, int ablk, int boff,
                                       int bblk) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const uint64_t da = kmajor(kbase, aoff, ablk, kk);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const uint64_t db = kmajor(kbase, boff + q * PART, bblk, kk);
      if (kk + q == 0)
        wgmma_ss_n64_first(d, da, db);
      else
        wgmma_ss_n64(d, da, db, 1);
    }
  }
}

// d (64 x 32) = the sum over K k16 steps of A (as above) times B (32 rows
// K-major at `boff`, blocks `bblk` apart); issued, not committed
template <int K>
__device__ __forceinline__ void mma_ss32(float (&d)[16], uint64_t kbase,
                                         int aoff, int ablk, int boff,
                                         int bblk) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const uint64_t da = kmajor(kbase, aoff, ablk, kk);
    const uint64_t db = kmajor(kbase, boff, bblk, kk);
    if (kk == 0)
      wgmma_ss_n32_first(d, da, db);
    else
      wgmma_ss_n32(d, da, db);
  }
}

// the same with B read MN-major (64 columns at `boff`, parts PART apart)
template <int K, int NP>
__device__ __forceinline__ void mma_ss_tb(float (&d)[32], uint64_t kbase,
                                          uint64_t mbase, int aoff, int ablk,
                                          int boff) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    const uint64_t da = kmajor(kbase, aoff, ablk, kk);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const uint64_t db = mnmajor(mbase, boff + q * PART, kk);
      if (kk + q == 0)
        wgmma_ss_n64_tb_first(d, da, db);
      else
        wgmma_ss_n64_tb(d, da, db);
    }
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// the sum over the four lanes of a quad (lanes 4g .. 4g + 3), in every lane
__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(FULL, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float2 ld_bf2(const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the byte of element (row r, column col) of a swizzled tile of 128-row
// blocks of 64 bf16 columns
__device__ __forceinline__ int tile_at(int r, int col) {
  return (col >> 6) * BLK + r * 128 + ((((col & 63) >> 3) ^ (r & 7)) << 4) +
         (col & 7) * 2;
}

// the byte, within a part, of a (p, n) state's element (p, n): the
// 64-column block of n, 64 rows of 128 bytes, swizzled
__device__ __forceinline__ int part_at(int p, int n) {
  return (n >> 6) * HALF + p * 128 + ((((n & 63) >> 3) ^ (p & 7)) << 4) +
         (n & 7) * 2;
}

// the float index of element (p, n) in R's image
__device__ __forceinline__ int img_at(int p, int n) {
  return p * MAX_N + (((n >> 2) ^ (p & 7)) << 2) + (n & 3);
}

// exp(x) for x <= 0 as 2^(x log2 e) by the SFU (ex2.approx, 2 ulp), where
// expf takes eight instructions; within about |x| 2^-24 of exp(x)
// relatively (ssd_chunk_tc.cu::exp_fast, which takes M's exps the same way)
__device__ __forceinline__ float exp_fast(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

// the float index of dG^T's element (j, i), float pairs swizzled by the row
// (two-way bank conflicts at most for the accumulator layout)
__device__ __forceinline__ int dg_at(int j, int i) {
  return j * Q + ((((i >> 1) ^ ((j & 7) << 2))) << 1) + (i & 1);
}

// ---------------------------------------------------------------------------
// 1. the adjoint walk
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_walk(const __grid_constant__ WalkArgs a) {
  using namespace walk;
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
    // TMA loads one 64-column block of C: the other stays zero
    for (int e = tid; e < STAGES * (BLK / 16); e += THREADS)
      reinterpret_cast<uint4*>(sm + (e / (BLK / 16)) * STAGE + C_OFF +
                               BLK)[e % (BLK / 16)] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  __syncthreads();

  // a head's segments are handed out from its last
  const int unit = *unit_s;
  const int T = a.segments;
  const int bh = unit / T, k = T - 1 - (unit - bh * T);
  const int bi = bh / a.h, hd = bh - bi * a.h;
  const int c_lo = static_cast<int>(static_cast<long long>(k) * a.nc / T);
  const int c_hi = static_cast<int>(static_cast<long long>(k + 1) * a.nc / T);
  const int n1 = k > 0 ? c_hi - c_lo : 0;  // chunks of pass 1
  const int items = n1 + c_hi - c_lo;      // chunks streamed
  auto chunk_of = [&](int i) { return c_hi - 1 - (i < n1 ? i : i - n1); };
  auto scan_of = [&](int i) {
    return reinterpret_cast<float*>(sm + SCAN) + (i % STAGES) * SCAN_FLOATS;
  };
  const long long pn = static_cast<long long>(a.p) * a.n;

  if (tid >= CONSUMERS) {
    const int lane = tid & 31;
    if (tid == CONSUMERS) {  // the producer warp's first lane: the loads
      const int nb = (a.n + 63) / 64;
      for (int i = 0; i < items; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + st, (i / STAGES - 1) & 1);
        const int t0 = chunk_of(i) * Q;
        unsigned char* base = sm + st * STAGE;
        const uint32_t sbytes = i >= n1 ? static_cast<uint32_t>(pn * 4) : 0;
        mbar_expect_tx(full + st, BLK + nb * BLK + sbytes);
        tma_load_4d(base, &a.dy, full + st, 0, hd, t0, bi);
        for (int cb = 0; cb < nb; ++cb)
          tma_load_4d(base + C_OFF + cb * BLK, &a.c, full + st, cb * 64, 0,
                      t0, bi);
        if (sbytes > 0)
          bulk_load(base + S_OFF,
                    a.states + (static_cast<long long>(bh) * a.nc +
                                chunk_of(i)) * pn,
                    sbytes, full + st);
      }
    } else if (tid >= CONSUMERS + 32) {  // the scan warp
      const float al = -expf(a.a_log[hd]);
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
#pragma unroll
        for (int m = 0; m < Q / 32; ++m)
          f[2 * Q + lane + 32 * m] = expf(f[Q + lane + 32 * m]);
        if (lane == 0) f[3 * Q] = expf(f[2 * Q - 1]);
        __syncwarp();
        if (lane == 0) mbar_arrive(ready + st);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns columns n 64 wg .. 64 wg + 63 of R
  const int wg = __shfl_sync(FULL, tid >> 7, 0);
  const int w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  const int pr = 16 * w + g;  // this thread's rows p pr, pr + 8
  float* img = reinterpret_cast<float*>(sm + IMG);

  float st[32], cacc[32];
  uint32_t A[2][3][STEPS][4];
#pragma unroll
  for (int r = 0; r < 32; ++r) st[r] = 0.f;

  auto bases = [&](uint64_t& mbase) {
    const unsigned char* p = sm;
    asm volatile("" : "+l"(p));
    mbase = desc_sw128(p, BLK, 1024);
  };
  auto wait_in = [&](int i) {
    mbar_wait(full + i % STAGES, (i / STAGES) & 1);
    mbar_wait(ready + i % STAGES, (i / STAGES) & 1);
  };
  auto release = [&](int i) {  // this warp is done with the stage
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + i % STAGES);
  };
  auto fence_a = [&](int b) {
#pragma unroll
    for (int q = 0; q < 3; ++q) fence_regs(A[b][q]);
  };
  // d (+)= A_b C over STEPS k16 steps from kk0 (C this warpgroup's columns,
  // read MN-major); committed, not waited for
  auto issue_rs = [&](float(&d)[32], int b, uint64_t mbase, int off, int kk0,
                      bool fresh) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {
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
  // (dY exp(cs))^T over the chunk steps of k16 steps kk0 .. kk0 + STEPS - 1
  // into A buffer b: dY read transposed by ldmatrix from the swizzled stage
  auto form_a = [&](int b, const unsigned char* ys, const float* wv,
                    int kk0) {
    const int mat = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {
      const int j0 = 16 * (kk0 + kk);
      const int j = j0 + 8 * (mat >> 1) + (lane & 7);
      const int ch = 2 * w + (mat & 1);
      uint32_t v[4];
      mma::ldmatrix_x4_trans(v, ys + j * 128 + ((ch ^ (j & 7)) << 4));
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
  // cacc = (dY exp(cs))^T C over this warpgroup's columns, the four groups
  // of k16 steps in turn through the two A buffers; then R = R decay + cacc
  auto update = [&](int so, const float* f, uint64_t mbase) {
    const int coff = so + C_OFF + wg * BLK;
#pragma unroll
    for (int grp = 0; grp < Q / 16 / STEPS; ++grp) {
      if (grp >= 2) wgmma_wait<1>();  // the buffer's last products are done
      form_a(grp & 1, sm + so, f + 2 * Q, grp * STEPS);
      issue_rs(cacc, grp & 1, mbase, coff, grp * STEPS, grp == 0);
    }
    wgmma_wait<0>();
    fence_regs(cacc);
    const float d = f[3 * Q];
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
           p < a.p && n < a.n ? static_cast<long long>(p) * a.n + n : -1LL,
           img_at(p, n));
      }
    }
  };

  // pass 1: the segment's adjoint aggregate from zero, from its last chunk,
  // and its decay
  float decay = 1.f;
  for (int i = 0; i < n1; ++i) {
    uint64_t mbase;
    bases(mbase);
    wait_in(i);
    const float* f = scan_of(i);
    decay = __fmul_rn(decay, f[3 * Q]);
    update((i % STAGES) * STAGE, f, mbase);
    release(i);
  }

  // the reverse chained hand-off: the adjoint entering this segment from
  // the right (the last segment's is dS_final, or zero), and this
  // segment's inclusive one, inclusive_{k+1} decay + aggregate
  if (T > 1) {
    int* status = a.head + 1;
    float* mine = a.ws_state + static_cast<long long>(unit) * pn;
    const float* prev = nullptr;
    if (k < T - 1) {
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
      prev = mine - pn;
    } else if (a.dstate != nullptr) {
      prev = a.dstate + static_cast<long long>(bh) * pn;
    }
    each_elem([&](float& s0, float& s1, long long off, int) {
      const float2 v =
          prev != nullptr && off >= 0
              ? __ldcg(reinterpret_cast<const float2*>(prev + off))
              : make_float2(0.f, 0.f);
      if (n1 > 0 && off >= 0)
        *reinterpret_cast<float2*>(mine + off) =
            make_float2(__fadd_rn(__fmul_rn(v.x, decay), s0),
                        __fadd_rn(__fmul_rn(v.y, decay), s1));
      s0 = v.x;
      s1 = v.y;
    });
    if (n1 > 0) {
      __threadfence();
      named_sync(SYNC, CONSUMERS);
      if (tid == 0) st_release(status + unit, 1);
    }
  } else if (a.dstate != nullptr) {
    const float* seed = a.dstate + static_cast<long long>(bh) * pn;
    each_elem([&](float& s0, float& s1, long long off, int) {
      const float2 v = off >= 0 ? *reinterpret_cast<const float2*>(seed + off)
                                : make_float2(0.f, 0.f);
      s0 = v.x;
      s1 = v.y;
    });
  }

  // pass 2: each chunk's R (the adjoint after it) out in float32, <R, S>,
  // and the update, from the segment's last chunk
  for (int i = n1; i < items; ++i) {
    const int ci = chunk_of(i);
    const int so = (i % STAGES) * STAGE;
    const long long u = static_cast<long long>(bh) * a.nc + ci;
    const float* f = scan_of(i);
    uint64_t mbase;
    bases(mbase);
    // R's image, once the store of the chunk before has read it
    if (tid == 0) bulk_wait<true>();
    named_sync(SYNC, CONSUMERS);
    each_elem([&](float& s0, float& s1, long long, int off) {
      *reinterpret_cast<float2*>(img + off) = make_float2(s0, s1);
    });
    fence_proxy_async();
    named_sync(SYNC, CONSUMERS);
    if (tid == 0) {
      bulk_store(a.ws_r + u * (IMG_BYTES / 4), img, IMG_BYTES);
      bulk_commit();
    }
    wait_in(i);
    // <R, S>: R from its image, S from the stage, 16 bytes of each a thread
    // and step; this thread's products in order, then a tree over the warp
    {
      const float* sv = reinterpret_cast<const float*>(sm + so + S_OFF);
      const int quads = static_cast<int>(pn / 4), row = a.n / 4;
      int e0 = tid;  // made here: no offset of the loop kept in a register
      asm volatile("" : "+r"(e0));
      float rs = 0.f;
      for (int e = e0; e < quads; e += CONSUMERS) {
        const int p = e / row, n = 4 * (e - p * row);
        const float4 s4 = *reinterpret_cast<const float4*>(sv + 4 * e);
        const float4 r4 =
            *reinterpret_cast<const float4*>(img + img_at(p, n));
        rs = __fadd_rn(rs, __fmul_rn(r4.x, s4.x));
        rs = __fadd_rn(rs, __fmul_rn(r4.y, s4.y));
        rs = __fadd_rn(rs, __fmul_rn(r4.z, s4.z));
        rs = __fadd_rn(rs, __fmul_rn(r4.w, s4.w));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(FULL, rs, o));
      if (lane == 0) a.rs8[u * 8 + (tid >> 5)] = rs;
    }
    update(so, f, mbase);
    release(i);
  }
  if (tid == 0) bulk_wait<false>();
}

// ---------------------------------------------------------------------------
// 2. the chunk gradients
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_grads(const __grid_constant__ GradArgs a) {
  using namespace grads;
  extern __shared__ __align__(1024) unsigned char sm[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + BARS);
  uint64_t* full_bc = bars;
  uint64_t* full_xy = bars + 1;
  uint64_t* empty_xy = bars + 2;
  uint64_t* full_r = bars + 3;
  uint64_t* empty_r = bars + 4;
  uint64_t* full_b = bars + 5;  // the dG region as a second slot in I
  uint64_t* empty_b = bars + 6;
  uint64_t* dg_free = bars + 7;
  uint64_t* ready = bars + 8;
  float* dgm = reinterpret_cast<float*>(sm + DG);
  float* scs = reinterpret_cast<float*>(sm + SCS);
  float* sdt = reinterpret_cast<float*>(sm + SDT);
  float* red = reinterpret_cast<float*>(sm + RED);
  float* scol = reinterpret_cast<float*>(sm + SCOL);
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int gi = blk % a.groups, bc = blk / a.groups;
  const int ci = bc % a.nc, bi = bc / a.nc;
  const int h0 = gi * a.group, gh = min(a.group, a.h - h0);
  const int t0 = ci * Q;
  const long long pn = static_cast<long long>(a.p) * a.n;

  if (tid == 0) {
    if (smem_u32(sm) % 1024 != 0) __trap();
    mbar_init(full_bc, 1);
    mbar_init(full_xy, 1);
    mbar_init(empty_xy, CONSUMERS / 32);
    mbar_init(full_r, 1);
    mbar_init(empty_r, CONSUMERS / 32);
    mbar_init(full_b, 1);
    mbar_init(empty_b, CONSUMERS / 32);
    mbar_init(dg_free, CONSUMERS / 32);
    for (int i = 0; i < GMAX; ++i) mbar_init(ready + i, 1);
    mbar_fence_init();
  }
  if (a.n <= 64) {
    // TMA loads one 64-column block of B and C: the other stays zero
    for (int e = tid; e < 2 * (BLK / 16); e += THREADS)
      reinterpret_cast<uint4*>(sm + (e < BLK / 16 ? BT : CT) +
                               BLK)[e % (BLK / 16)] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
  }
  for (int e = tid; e < Q * Q / 4; e += THREADS)
    reinterpret_cast<float4*>(dgm)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  if (tid >= CONSUMERS) {
    const int lane = tid & 31;
    if (tid == CONSUMERS) {  // the producer warp's first lane: the loads
      const int nb = (a.n + 63) / 64;
      mbar_expect_tx(full_bc, 2 * nb * BLK);
      for (int cb = 0; cb < nb; ++cb) {
        tma_load_4d(sm + BT + cb * BLK, &a.b, full_bc, cb * 64, 0, t0, bi);
        tma_load_4d(sm + CT + cb * BLK, &a.c, full_bc, cb * 64, 0, t0, bi);
      }
      // walks J (x, dY; R) and K (x; R) over the group's heads in slot A
      // (the x / dY and R / S slots), then I (dY; S) through slots A and B
      // in turn (B: the dG region, once the consumers are done with it)
      for (int it = 0; it < 3 * gh; ++it) {
        const int ph = it / gh, hd = h0 + it % gh;
        const int m = it - 2 * gh;  // I's items
        const long long u = (static_cast<long long>(bi) * a.h + hd) * a.nc +
                            ci;
        const uint32_t fbytes =
            ph < 2 ? IMG_BYTES : static_cast<uint32_t>(pn * 4);
        const float* fsrc =
            ph < 2 ? a.ws_r + u * (IMG_BYTES / 4) : a.states + u * pn;
        if (m < 0 || (m & 1) == 0) {  // slot A, its fa-th fill
          const int fa = m < 0 ? it : 2 * gh + (m >> 1);
          if (fa > 0) mbar_wait(empty_xy, (fa - 1) & 1);
          mbar_expect_tx(full_xy, ph == 0 ? 2 * BLK : BLK);
          if (ph < 2) tma_load_4d(sm + XS, &a.x, full_xy, 0, hd, t0, bi);
          if (ph != 1) tma_load_4d(sm + DYS, &a.dy, full_xy, 0, hd, t0, bi);
          if (fa > 0) mbar_wait(empty_r, (fa - 1) & 1);
          mbar_expect_tx(full_r, fbytes);
          bulk_load(sm + RP, fsrc, fbytes, full_r);
        } else {  // slot B, its fb-th fill: dY, then S
          const int fb = m >> 1;
          if (fb == 0)
            mbar_wait(dg_free, 0);
          else
            mbar_wait(empty_b, (fb - 1) & 1);
          mbar_expect_tx(full_b, BLK + fbytes);
          tma_load_4d(sm + DG, &a.dy, full_b, 0, hd, t0, bi);
          bulk_load(sm + DG + BLK, fsrc, fbytes, full_b);
        }
      }
    } else if (tid >= CONSUMERS + 32) {  // the scan warp: each head's cs
      for (int hh = 0; hh < gh; ++hh) {
        const int hd = h0 + hh;
        const float al = -expf(a.a_log[hd]);
        float* fdt = sdt + hh * Q;
        float* fcs = scs + hh * Q;
#pragma unroll
        for (int m = 0; m < Q / 32; ++m) {
          const int j = lane + 32 * m;
          fdt[j] = t0 + j < a.s ? a.dt[(static_cast<long long>(bi) * a.s + t0 +
                                        j) * a.h + hd]
                                : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          float run = 0.f;
#pragma unroll 16
          for (int j = 0; j < Q; ++j) {
            run = __fadd_rn(run, __fmul_rn(al, fdt[j]));
            fcs[j] = run;
          }
          a.dec[(static_cast<long long>(bi) * a.nc + ci) * a.h + hd] =
              expf(run);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(ready + hh);
      }
    }
    return;
  }

  // the consumers; the warpgroup broadcast from lane 0, so that the
  // compiler sees it uniform, and read afresh where it is used (kept from
  // here, it was the one register ptxas spilled)
  auto wgroup = [&]() {
    int t = threadIdx.x;
    asm volatile("" : "+r"(t));
    return __shfl_sync(FULL, t >> 7, 0);
  };
  const int w = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  // this thread's chunk rows r0, r0 + 8
  const int r0 = 64 * wgroup() + 16 * w + g;
  uint32_t A[2][3][GSTEPS][4];  // two buffers of A operands in three parts

  auto bases = [&](uint64_t& kbase, uint64_t& mbase) {
    const unsigned char* p = sm;
    asm volatile("" : "+l"(p));
    kbase = desc_sw128(p, 16, 1024);
    mbase = desc_sw128(p, BLK, 1024);
  };
  auto fence_a = [&](int b) {
#pragma unroll
    for (int q = 0; q < 3; ++q) fence_regs(A[b][q]);
  };
  // this warp is done with a slot (its generic reads ordered before the
  // async proxy's next write)
  auto release = [&](uint64_t* empty) {
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
  };
  // d (+)= A_b X over GSTEPS k16 steps from kk0, X 64 columns read MN-major
  // at `off`; committed, not waited for
  auto issue_rs = [&](float(&d)[32], int b, uint64_t mbase, int off, int kk0,
                      bool fresh) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GSTEPS; ++kk) {
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
  // d[nh] = dG_grp^T X (rows j; X = C) or dG_grp X (rows i; X = B) over
  // both 64-column halves nh of X: A from dG^T in shared memory, split in
  // three parts, four groups of GSTEPS k16 steps through the two buffers
  auto dg_product = [&](float(&d0)[32], float(&d1)[32], bool trans,
                        int xoff) {
    uint64_t kbase, mbase;
    bases(kbase, mbase);
#pragma unroll
    for (int grp = 0; grp < Q / 16 / GSTEPS; ++grp) {
      const int b = grp & 1;
      if (grp >= 2) wgmma_wait<1>();
#pragma unroll
      for (int kk = 0; kk < GSTEPS; ++kk) {
        const int k0 = 16 * (grp * GSTEPS + kk) + 2 * qd;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = r0 + 8 * (r & 1), k = k0 + 8 * (r >> 1);
          float2 v;
          if (trans) {  // dG rows i: element (i, j) is dG^T's (j, i)
            v = make_float2(dgm[dg_at(k, row)], dgm[dg_at(k + 1, row)]);
          } else {
            v = *reinterpret_cast<const float2*>(dgm + dg_at(row, k));
          }
          mma::split3(v.x, v.y, A[b][0][kk][r], A[b][1][kk][r],
                      A[b][2][kk][r]);
        }
      }
      fence_a(b);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GSTEPS; ++kk) {
        const int ks = grp * GSTEPS + kk;
        const uint64_t e0 = mnmajor(mbase, xoff, ks);
        const uint64_t e1 = mnmajor(mbase, xoff + BLK, ks);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (grp == 0 && kk == 0 && q == 0) {
            wgmma_rs_n64_first(d0, A[b][q][kk], e0);
            wgmma_rs_n64_first(d1, A[b][q][kk], e1);
          } else {
            wgmma_rs_n64(d0, A[b][q][kk], e0);
            wgmma_rs_n64(d1, A[b][q][kk], e1);
          }
        }
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(d0);
    fence_regs(d1);
  };
  // the group's dB or dC partial rows (float32, columns below N)
  auto write_rows = [&](float* out, float(&d0)[32], float(&d1)[32]) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = t0 + r0 + 8 * hf;
      if (t >= a.s) continue;
      float* row = out + ((static_cast<long long>(bi) * a.groups + gi) *
                              a.nc * Q + t) * a.n;
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int col = 8 * u + 2 * qd;
        const float* d = u < 8 ? d0 : d1;
        const int r = 4 * (u & 7) + 2 * hf;
        if (col < a.n)
          *reinterpret_cast<float2*>(row + col) = make_float2(d[r], d[r + 1]);
      }
    }
  };
  // a head's per-step values at this thread's rows
  struct Rows {
    float cs[2], dt[2], e[2], w[2], ecs[2];
  };
  auto rows_of = [&](int hh) {
    Rows v;
    const float* cs = scs + hh * Q;
    const float last = cs[Q - 1];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf;
      v.cs[hf] = cs[r];
      v.dt[hf] = sdt[hh * Q + r];
      v.e[hf] = expf(__fsub_rn(last, v.cs[hf]));
      v.w[hf] = __fmul_rn(v.dt[hf], v.e[hf]);
      v.ecs[hf] = expf(v.cs[hf]);
    }
    return v;
  };
  // the slot's float32 state (R's image, or S as the forward wrote it)
  // into its three parts, in place: every consumer reads its elements first
  auto to_parts = [&](bool image, int off) {
    const int wg = wgroup();
    int pw = 16 * w + g, ic = 2 * qd;  // made anew each time, as in J
    asm volatile("" : "+r"(pw), "+r"(ic));
    const float* src = reinterpret_cast<const float*>(sm + off);
    float sv[32];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = pw + 8 * hf, n = 64 * wg + 8 * t + ic;
        float2 v;
        if (image)
          v = *reinterpret_cast<const float2*>(src + img_at(p, n));
        else
          v = p < a.p && n < a.n ? *reinterpret_cast<const float2*>(
                                       src + p * a.n + n)
                                 : make_float2(0.f, 0.f);
        sv[4 * t + 2 * hf] = v.x;
        sv[4 * t + 2 * hf + 1] = v.y;
      }
    named_sync(SYNC, CONSUMERS);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t hi, mid, lo;
        mma::split3(sv[4 * t + 2 * hf], sv[4 * t + 2 * hf + 1], hi, mid, lo);
        unsigned char* q =
            sm + off + part_at(pw + 8 * hf, 64 * wg + 8 * t + ic);
        *reinterpret_cast<uint32_t*>(q) = hi;
        *reinterpret_cast<uint32_t*>(q + PART) = mid;
        *reinterpret_cast<uint32_t*>(q + 2 * PART) = lo;
      }
    fence_proxy_async();
    named_sync(SYNC, CONSUMERS);
  };
  auto scalar_at = [&](int hd, int r) {  // (batch, chunk, h, step)
    return ((static_cast<long long>(bi) * a.nc + ci) * a.h + hd) * Q + r;
  };

  mbar_wait(full_bc, 0);

  // J: rows j.  dx, the sums of dM M and dM G L, dG^T added to the group's
  for (int hh = 0; hh < gh; ++hh) {
    const int hd = h0 + hh, wg = wgroup();
    mbar_wait(ready + hh, 0);
    mbar_wait(full_xy, hh & 1);
    const Rows rv = rows_of(hh);
    // this thread's row j and column offset, made anew for each head (the
    // empty asm hides that they do not change, so that the compiler keeps
    // none of the loop's addresses in registers of their own)
    int jr = r0, ic = 2 * qd;
    asm volatile("" : "+r"(jr), "+r"(ic));
    const float* cs = scs + hh * Q;
    float* rd = red + (hh & 1) * 8 * Q + (tid >> 5) * Q;
    uint64_t kbase, mbase;
    bases(kbase, mbase);
    float y[32], gq[16], dq[16];
    float col[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
    // 32 keys i at a time (a quarter): G^T and dM^T (m64n32), then M^T for
    // their two k16 steps, one A buffer each, each step's products issued
    // as the next step's operands are formed
    auto quarter = [&](int qq, bool first) {
      wgmma_fence();
      mma_ss32<Q / 16>(gq, kbase, BT + wg * HALF, BLK, CT + qq * 32 * 128,
                       BLK);
      mma_ss32<MAX_P / 16>(dq, kbase, XS + wg * HALF, BLK,
                           DYS + qq * 32 * 128, BLK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gq);
      fence_regs(dq);
      asm volatile("" : "+r"(jr), "+r"(ic));  // and for each quarter
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        float m[8];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = 2 * kk + u;  // n8 tile of the quarter
          const int i0 = 32 * qq + 8 * t + ic;
          const float2 ci2 = *reinterpret_cast<const float2*>(cs + i0);
          const float csi[2] = {ci2.x, ci2.y};
          float dg[4], tr[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hf = e >> 1, i = i0 + (e & 1);
            const bool causal = i >= jr + 8 * hf;
            // every exp is taken (of 0 above the diagonal) and the mask
            // multiplies: a select around it compiles to a branch
            const float lv =
                exp_fast(causal ? __fsub_rn(csi[e & 1], rv.cs[hf]) : 0.f) *
                (causal ? 1.f : 0.f);
            const float gl = __fmul_rn(gq[4 * t + e], lv);
            const float mv = __fmul_rn(gl, rv.dt[hf]);
            const float dmv = dq[4 * t + e];
            const float tv = __fmul_rn(dmv, mv);
            m[4 * u + e] = mv;
            dg[e] = __fmul_rn(__fmul_rn(dmv, lv), rv.dt[hf]);
            col[hf] = __fadd_rn(col[hf], tv);
            dd[hf] = __fadd_rn(dd[hf], __fmul_rn(dmv, gl));
            tr[e & 1] = __fadd_rn(tr[e & 1], tv);
          }
          // dG^T into the group's, in head order
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float2* pg =
                reinterpret_cast<float2*>(dgm + dg_at(jr + 8 * hf, i0));
            const float2 o = *pg;
            *pg = make_float2(__fadd_rn(o.x, dg[2 * hf]),
                              __fadd_rn(o.y, dg[2 * hf + 1]));
          }
          // the sums of dM M over this warp's 16 rows j, for columns i
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            tr[0] = __fadd_rn(tr[0], __shfl_xor_sync(FULL, tr[0], o));
            tr[1] = __fadd_rn(tr[1], __shfl_xor_sync(FULL, tr[1], o));
          }
          if (g == 0)
            *reinterpret_cast<float2*>(rd + i0) = make_float2(tr[0], tr[1]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          mma::split3(m[2 * r], m[2 * r + 1], A[kk][0][0][r], A[kk][1][0][r],
                      A[kk][2][0][r]);
        fence_a(kk);
        issue_rs(y, kk, mbase, DYS, 2 * qq + kk, first && kk == 0);
      }
    };
    // Warpgroup 1's rows j >= 64 see no key i < 64: its first two quarters
    // are above the diagonal, all zeros, and it skips them (exactly: only
    // zeros leave the sums), writing zeros for its row-sum partials there.
    // The first quarter apart (its first product only writes y), the others
    // in a loop kept rolled: unrolled, the scheduler hoisted work of all
    // four ahead and spilled.
    const int q0 = 2 * wg;
    if (g == 0)
      for (int i0 = ic; i0 < 32 * q0; i0 += 8)
        *reinterpret_cast<float2*>(rd + i0) = make_float2(0.f, 0.f);
    quarter(q0, true);
#pragma unroll 1
    for (int qq = q0 + 1; qq < Q / 32; ++qq) quarter(qq, false);
    wgmma_wait<0>();
    fence_regs(y);
    release(empty_xy);
    // the column sums of dM M (per row j) and dM G L, and the row sums (per
    // column i: the eight warps' partials in order)
    float* sc = scol + (hh & 1) * Q;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      col[hf] = quad_sum(col[hf]);
      dd[hf] = quad_sum(dd[hf]);
      if (qd == 0) {
        sc[jr + 8 * hf] = col[hf];
        a.ddtp[scalar_at(hd, jr + 8 * hf)] = dd[hf];
      }
    }
    named_sync(SYNC, CONSUMERS);
    if (tid < Q) {
      const float* rb = red + (hh & 1) * 8 * Q;
      float rt = 0.f;
#pragma unroll
      for (int wv = 0; wv < 8; ++wv) rt = __fadd_rn(rt, rb[wv * Q + tid]);
      a.rc[scalar_at(hd, tid)] = __fsub_rn(rt, sc[tid]);
    }
    // B R^T (R's parts as the B operand), then dx = M^T dY + w B R^T
    mbar_wait(full_r, hh & 1);
    to_parts(true, RP);
    wgmma_fence();
    float br[32];
    mma_ss<MAX_N / 16, 3>(br, kbase, BT + wg * HALF, BLK, RP, HALF);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(br);
    release(empty_r);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = t0 + jr + 8 * hf;
      if (t >= a.s) continue;
      bf16* out =
          a.dx + ((static_cast<long long>(bi) * a.s + t) * a.h + hd) * a.p;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int col2 = 8 * u + ic, r = 4 * u + 2 * hf;
        if (col2 < a.p)
          *reinterpret_cast<__nv_bfloat162*>(out + col2) =
              __floats2bfloat162_rn(
                  __fadd_rn(y[r], __fmul_rn(rv.w[hf], br[r])),
                  __fadd_rn(y[r + 1], __fmul_rn(rv.w[hf], br[r + 1])));
      }
    }
  }

  // K: rows j.  dB = dG_grp^T C, then w . (x R) per head in head order; q
  {
    float db0[32], db1[32];
    dg_product(db0, db1, false, CT);
    for (int hh = 0; hh < gh; ++hh) {
      const int hd = h0 + hh, it = gh + hh, wg = wgroup();
      const Rows rv = rows_of(hh);
      mbar_wait(full_xy, it & 1);
      mbar_wait(full_r, it & 1);
      to_parts(true, RP);
      uint64_t kbase, mbase;
      bases(kbase, mbase);
      int jr = r0, ic = 2 * qd;  // made anew for each head, as in J
      asm volatile("" : "+r"(jr), "+r"(ic));
      // x R, one 64-column half of n at a time
      float qv[2] = {0.f, 0.f};
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        float xr[32];
        float* dbv = nh ? db1 : db0;
        wgmma_fence();
        mma_ss_tb<MAX_P / 16, 3>(xr, kbase, mbase, XS + wg * HALF, BLK,
                                 RP + nh * HALF);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(xr);
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = 4 * t + 2 * hf, row = jr + 8 * hf;
            const float2 bv =
                ld_bf2(sm + BT + tile_at(row, 64 * nh + 8 * t + ic));
            qv[hf] = __fadd_rn(qv[hf], __fmul_rn(bv.x, xr[r]));
            qv[hf] = __fadd_rn(qv[hf], __fmul_rn(bv.y, xr[r + 1]));
            dbv[r] = __fadd_rn(dbv[r], __fmul_rn(rv.w[hf], xr[r]));
            dbv[r + 1] =
                __fadd_rn(dbv[r + 1], __fmul_rn(rv.w[hf], xr[r + 1]));
          }
      }
      release(empty_xy);
      release(empty_r);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float q = quad_sum(qv[hf]);
        if (qd == 0) {
          const long long o = scalar_at(hd, jr + 8 * hf);
          a.v[o] = __fmul_rn(rv.w[hf], q);
          a.ddtp[o] = __fadd_rn(a.ddtp[o], __fmul_rn(rv.e[hf], q));
        }
      }
    }
    write_rows(a.dbp, db0, db1);
  }

  // I: rows i.  dC = dG_grp B, then exp(cs) . (dY S) per head; u.  After
  // dG_grp B the dG region is free: item hh lies in slot A (dY at DYS, S
  // at RP) or, odd, in slot B (dY at DG, S at DG + BLK)
  {
    named_sync(SYNC, CONSUMERS);  // every thread's dG^T is in
    float dc0[32], dc1[32];
    dg_product(dc0, dc1, true, BT);
    release(dg_free);
    for (int hh = 0; hh < gh; ++hh) {
      const int hd = h0 + hh, wg = wgroup();
      const Rows rv = rows_of(hh);
      const bool in_b = hh & 1;
      if (in_b) {
        mbar_wait(full_b, (hh >> 1) & 1);
      } else {
        mbar_wait(full_xy, (2 * gh + (hh >> 1)) & 1);
        mbar_wait(full_r, (2 * gh + (hh >> 1)) & 1);
      }
      const int yo = in_b ? DG : DYS, so = in_b ? DG + BLK : RP;
      int ir = r0, ic = 2 * qd;  // made anew for each head, as in J
      asm volatile("" : "+r"(ir), "+r"(ic));
      to_parts(false, so);
      uint64_t kbase, mbase;
      bases(kbase, mbase);
      // u_i = exp(cs_i) dY_i . S C_i
      {
        float ys[32];
        wgmma_fence();
        mma_ss<MAX_N / 16, 3>(ys, kbase, CT + wg * HALF, BLK, so, HALF);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(ys);
        float uv[2] = {0.f, 0.f};
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = 4 * t + 2 * hf;
            const float2 dv =
                ld_bf2(sm + yo + tile_at(ir + 8 * hf, 8 * t + ic));
            uv[hf] = __fadd_rn(uv[hf], __fmul_rn(dv.x, ys[r]));
            uv[hf] = __fadd_rn(uv[hf], __fmul_rn(dv.y, ys[r + 1]));
          }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float uu = __fmul_rn(rv.ecs[hf], quad_sum(uv[hf]));
          if (qd == 0) a.u[scalar_at(hd, ir + 8 * hf)] = uu;
        }
      }
      // dC += exp(cs) . (dY S), one 64-column half of n at a time
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        float ds[32];
        float* dcv = nh ? dc1 : dc0;
        wgmma_fence();
        mma_ss_tb<MAX_P / 16, 3>(ds, kbase, mbase, yo + wg * HALF, BLK,
                                 so + nh * HALF);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(ds);
#pragma unroll
        for (int r = 0; r < 32; ++r)
          dcv[r] = __fadd_rn(dcv[r], __fmul_rn(rv.ecs[(r >> 1) & 1], ds[r]));
      }
      if (in_b) {
        release(empty_b);
      } else {
        release(empty_xy);
        release(empty_r);
      }
    }
    write_rows(a.dcp, dc0, dc1);
  }
}

// ---------------------------------------------------------------------------
// 3. the ordered sums
// ---------------------------------------------------------------------------

// threads of a block of the sum launch: 16 warps
constexpr int SUM_THREADS = 512;
constexpr int SUM_WARPS = SUM_THREADS / 32;

// The first blocks, `per_head` a head: a warp per (batch row, chunk) chain,
// its lanes staging d cs, l and v in shared memory, its first lane taking
// sum v, the reverse cumsum of d cs and da_log's share in order, its lanes
// ddt; the head's last block to finish (an integer counter) sums da_log's
// shares in order over batch rows and chunks.  The blocks after them: db,
// dc (batch, s, n) = the groups' partials in group order, four consecutive
// values a thread.
__global__ void __launch_bounds__(SUM_THREADS)
ssd_bwd_sum(const SumArgs a, int per_head) {
  // one array each, so that the first lane's loads may run ahead of its
  // stores
  __shared__ float s_dcs[SUM_WARPS][Q], s_l[SUM_WARPS][Q], s_v[SUM_WARPS][Q],
      s_dl[SUM_WARPS][Q];
  __shared__ int s_last;
  if (static_cast<int>(blockIdx.x) >= a.h * per_head) {
    const long long idx =
        4 * (static_cast<long long>(blockIdx.x - a.h * per_head) *
                 blockDim.x +
             threadIdx.x);
    const long long sn = static_cast<long long>(a.s) * a.n;
    if (idx >= a.batch * sn) return;
    const long long bi = idx / sn, rest = idx - bi * sn;
    const long long gstride = static_cast<long long>(a.nc) * Q * a.n;
    float4 sb = make_float4(0.f, 0.f, 0.f, 0.f), sc = sb;
#pragma unroll 4
    for (int gg = 0; gg < a.groups; ++gg) {
      const long long o = (bi * a.groups + gg) * gstride + rest;
      const float4 vb = *reinterpret_cast<const float4*>(a.dbp + o);
      const float4 vc = *reinterpret_cast<const float4*>(a.dcp + o);
      sb = make_float4(__fadd_rn(sb.x, vb.x), __fadd_rn(sb.y, vb.y),
                       __fadd_rn(sb.z, vb.z), __fadd_rn(sb.w, vb.w));
      sc = make_float4(__fadd_rn(sc.x, vc.x), __fadd_rn(sc.y, vc.y),
                       __fadd_rn(sc.z, vc.z), __fadd_rn(sc.w, vc.w));
    }
    *reinterpret_cast<float4*>(a.db + idx) = sb;
    *reinterpret_cast<float4*>(a.dc + idx) = sc;
    return;
  }
  const int hd = blockIdx.x / per_head, part = blockIdx.x - hd * per_head;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float al = -expf(a.a_log[hd]);
  const int chains = a.batch * a.nc;
  const int ch = part * SUM_WARPS + warp;
  if (ch < chains) {
    const int bi = ch / a.nc, c = ch - bi * a.nc;
    const long long base =
        ((static_cast<long long>(bi) * a.nc + c) * a.h + hd) * Q;
    const long long u = (static_cast<long long>(bi) * a.h + hd) * a.nc + c;
    float* dcs = s_dcs[warp];
    float* lv = s_l[warp];
    float* vv = s_v[warp];
    float* dl = s_dl[warp];
    float ddtp[Q / 32];
#pragma unroll
    for (int m = 0; m < Q / 32; ++m) {
      const int j = lane + 32 * m, t = c * Q + j;
      const float v = a.v[base + j];
      dcs[j] = __fsub_rn(__fadd_rn(a.rc[base + j], a.u[base + j]), v);
      vv[j] = v;
      lv[j] = t < a.s ? __fmul_rn(
                            al, a.dt[(static_cast<long long>(bi) * a.s + t) *
                                         a.h + hd])
                      : 0.f;
      ddtp[m] = a.ddtp[base + j];
    }
    __syncwarp();
    if (lane == 0) {
      float rs = 0.f;
#pragma unroll
      for (int wv = 0; wv < 8; ++wv) rs = __fadd_rn(rs, a.rs8[u * 8 + wv]);
      const float dec =
          a.dec[(static_cast<long long>(bi) * a.nc + c) * a.h + hd];
      float vsum = 0.f;
#pragma unroll 16
      for (int j = 0; j < Q; ++j) vsum = __fadd_rn(vsum, vv[j]);
      float run = __fadd_rn(vsum, __fmul_rn(dec, rs));
      float dac = 0.f;
#pragma unroll 16
      for (int j = Q - 1; j >= 0; --j) {
        run = __fadd_rn(run, dcs[j]);
        dl[j] = run;
        dac = __fadd_rn(dac, __fmul_rn(run, lv[j]));
      }
      a.share[u] = dac;
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < Q / 32; ++m) {
      const int j = lane + 32 * m, t = c * Q + j;
      if (t < a.s)
        a.ddt[(static_cast<long long>(bi) * a.s + t) * a.h + hd] =
            __fadd_rn(ddtp[m], __fmul_rn(al, dl[j]));
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(a.count + hd, 1) == per_head - 1;
  }
  __syncthreads();
  if (s_last && threadIdx.x == 0) {
    __threadfence();
    float sa = 0.f;
    for (int bi = 0; bi < a.batch; ++bi)
      for (int c = 0; c < a.nc; ++c)
        sa = __fadd_rn(sa, __ldcg(a.share + (static_cast<long long>(bi) *
                                                 a.h + hd) * a.nc + c));
    a.da[hd] = sa;
  }
}

long long header_ints(long long units) { return (1 + units + 3) / 4 * 4; }
long long round4(long long v) { return (v + 3) / 4 * 4; }

// the workspace's regions, in floats (each a multiple of 16 bytes)
struct Layout {
  long long header, state, image, rs8, dec, scalars, share, partial, total;
};

Layout layout(int batch, int s, int h, int p, int n, int segments,
              int group) {
  const long long nc = (s + Q - 1) / Q;
  const long long units = static_cast<long long>(batch) * h * segments;
  const long long chunks = static_cast<long long>(batch) * h * nc;
  const long long groups = (h + group - 1) / group;
  Layout l{};
  l.header = header_ints(units + h);
  l.state = l.header;
  l.image = l.state + units * p * n;
  l.rs8 = l.image + chunks * (IMG_BYTES / 4);
  l.dec = l.rs8 + chunks * 8;
  l.scalars = l.dec + round4(chunks);
  l.share = l.scalars + 4 * chunks * Q;
  l.partial = l.share + round4(chunks);
  l.total = l.partial + 2 * batch * groups * nc * Q * n;
  return l;
}

// records marks[i] on the stream, where the caller asked for marks
int mark(const cudaEvent_t* marks, int i, cudaStream_t stream) {
  return marks ? static_cast<int>(cudaEventRecord(marks[i], stream)) : 0;
}

}  // namespace

extern "C" int ssd_chunk_bwd_len() { return Q; }
extern "C" int ssd_chunk_bwd_max_p() { return MAX_P; }
extern "C" int ssd_chunk_bwd_max_n() { return MAX_N; }
extern "C" int ssd_chunk_bwd_max_group() { return GMAX; }
// dynamic shared memory of the gradients' and the walk's blocks
extern "C" int ssd_chunk_bwd_smem() { return grads::BYTES; }
extern "C" int ssd_chunk_bwd_walk_smem() { return walk::BYTES; }

// bytes of the workspace: the walk's unit counter and status words (zeroed
// by the launch), an inclusive (p, n) adjoint a unit, R's parts image a
// (batch, h, chunk), <R, S>'s warp partials, the chunk decays, the four
// per-step arrays (rowsum - colsum, u, v, ddt's partial), da_log's shares,
// and the groups' float32 partials of dB and dC
extern "C" long long ssd_chunk_bwd_workspace(int batch, int s, int h, int p,
                                             int n, int segments, int group) {
  return layout(batch, s, h, p, n, segments, group).total * 4;
}

// x, dy, dx: (batch, s, h, p) bf16; b, c: (batch, s, n) bf16; all 16-byte
// aligned; dt, ddt: (batch, s, h) float32; a_log, da_log: (h,) float32;
// states: (batch, h, ceil(s / Q), p, n) float32, each chunk's incoming state
// as the forward kernel writes it; dstate: (batch, h, p, n) float32 or null
// (zero); db, dc: (batch, s, n) float32; ws: ssd_chunk_bwd_workspace bytes,
// 16-byte aligned; marks: null, or four events recorded before the first
// launch and after each of the three.  Everything contiguous; p and n
// multiples of 8, p <= MAX_P, n <= MAX_N, 1 <= segments <= ceil(s / Q),
// 1 <= group <= GMAX heads a group.
extern "C" int ssd_chunk_bwd_launch(
    const void* x, const float* dt, const float* a_log, const void* b,
    const void* c, const void* dy, const float* states, const float* dstate,
    void* dx, float* ddt, float* da_log, float* db, float* dc, void* ws,
    int batch, int s, int h, int p, int n, int segments, int group,
    cudaStream_t stream, const cudaEvent_t* marks) {
  const int nc = s > 0 ? (s + Q - 1) / Q : 0;
  const long long units = static_cast<long long>(batch) * h * segments;
  const int groups = group > 0 ? (h + group - 1) / group : 0;
  if (batch <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || p > MAX_P ||
      n > MAX_N || p % 8 != 0 || n % 8 != 0 || segments < 1 ||
      segments > nc || group < 1 || group > GMAX || units >= (1LL << 31) ||
      static_cast<long long>(batch) * nc * groups >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {x, b, c, dy, dx, ws, states, db, dc};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const Layout l = layout(batch, s, h, p, n, segments, group);
  float* base = static_cast<float*>(ws);
  const long long chunks = static_cast<long long>(batch) * h * nc;

  WalkArgs wa{};
  int err = bf16_map_4d(&wa.dy, dy, p, h, s, batch, Q);
  if (err == 0) err = bf16_map_4d(&wa.c, c, n, 1, s, batch, Q);
  GradArgs ga{};
  if (err == 0) err = bf16_map_4d(&ga.x, x, p, h, s, batch, Q);
  if (err == 0) ga.dy = wa.dy;
  if (err == 0) err = bf16_map_4d(&ga.b, b, n, 1, s, batch, Q);
  if (err != 0) return err;
  ga.c = wa.c;
  wa.dt = ga.dt = dt;
  wa.a_log = ga.a_log = a_log;
  wa.dstate = dstate;
  wa.states = ga.states = states;
  wa.head = static_cast<int*>(ws);
  wa.ws_state = base + l.state;
  wa.ws_r = base + l.image;
  ga.ws_r = wa.ws_r;
  wa.rs8 = base + l.rs8;
  wa.s = ga.s = s, wa.h = ga.h = h, wa.p = ga.p = p, wa.n = ga.n = n;
  wa.nc = ga.nc = nc, wa.segments = segments;
  ga.dx = static_cast<bf16*>(dx);
  ga.rc = base + l.scalars;
  ga.u = ga.rc + chunks * Q;
  ga.v = ga.u + chunks * Q;
  ga.ddtp = ga.v + chunks * Q;
  ga.dec = base + l.dec;
  ga.dbp = base + l.partial;
  ga.dcp = ga.dbp + static_cast<long long>(batch) * groups * nc * Q * n;
  ga.group = group, ga.groups = groups;
  SumArgs sa{};
  sa.dt = dt;
  sa.a_log = a_log;
  sa.rc = ga.rc, sa.u = ga.u, sa.v = ga.v, sa.ddtp = ga.ddtp;
  sa.dec = ga.dec, sa.rs8 = wa.rs8, sa.dbp = ga.dbp, sa.dcp = ga.dcp;
  sa.share = base + l.share;
  sa.ddt = ddt, sa.da = da_log, sa.db = db, sa.dc = dc;
  sa.count = static_cast<int*>(ws) + 1 + units;
  sa.batch = batch, sa.s = s, sa.h = h, sa.n = n, sa.nc = nc;
  sa.groups = groups;

  if (int e = mark(marks, 0, stream)) return e;
  cudaError_t e = cudaMemsetAsync(ws, 0, l.header * 4, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(ssd_bwd_walk,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           walk::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_walk<<<static_cast<unsigned>(units), THREADS, walk::BYTES,
                 stream>>>(wa);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (int m = mark(marks, 1, stream)) return m;
  e = cudaFuncSetAttribute(ssd_bwd_grads,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           grads::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_grads<<<static_cast<unsigned>(static_cast<long long>(batch) * nc *
                                        groups),
                  THREADS, grads::BYTES, stream>>>(ga);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (int m = mark(marks, 2, stream)) return m;
  const long long quads = static_cast<long long>(batch) * s * n / 4;
  const int elem_blocks =
      static_cast<int>((quads + SUM_THREADS - 1) / SUM_THREADS);
  const int per_head = (batch * nc + SUM_WARPS - 1) / SUM_WARPS;
  ssd_bwd_sum<<<static_cast<unsigned>(h * per_head + elem_blocks),
                SUM_THREADS, 0, stream>>>(sa, per_head);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return mark(marks, 3, stream);
}
