// The gradient of the Mamba-2 SSD chunk scan on Hopper's tensor cores
// (sm_90a, mma.sync), for bf16 x, b, c and dY with P and N multiples of 8
// (P <= 64, N <= 128): the types and shapes the models train in.
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
//   ddt_j = sum_i dM_ij G_ij L_ij + exp(cs_Q - cs_j) (x_j . R B_j) - a dl_j
//   dcs   = rowsum(dM M) - colsum(dM M) + u - v, dcs_Q += sum v +
//           exp(cs_Q) <R, S>, dl = its reverse cumsum, da_log = sum dl l.
//
// Design.  Two launches (after a memset of the status words): this kernel,
// then an ordered sum of the per-head partials.  No float atomics: two calls
// give the same bits.
//   * Work unit: (batch row, head, segment of consecutive chunks), T
//     segments a head (kernel.py::segment_count, as the forward).  A block
//     takes its unit id from an atomicAdd, and a head's segments are handed
//     out from the last: segment k waits only for segment k + 1, whose id is
//     one less, taken by a block already running.
//   * Pass 1 (every segment but the first): the segment's adjoint aggregate
//     from zero over its chunks, from the last, and the product D of its
//     chunk decays.  The reverse hand-off: segment k takes segment k + 1's
//     inclusive adjoint (the last segment dS_final, or zero) and publishes
//     inclusive_k = inclusive_{k+1} D + aggregate_k (payload, fence, release
//     store of its status word; the reader polls with acquire).
//   * Pass 2: the segment's chunks from the last, R on chip (three exact
//     bf16 parts in shared memory), S read from the forward's states.  Per
//     chunk, eight warps, warp w owning chunk rows 16 w .. 16 w + 15:
//       A  rows j: B R^T (R in three parts), x_j . (R B_j), then over the
//          key blocks i >= j the transposed G and dM, M^T and its row sums,
//          dx += M^T dY (M^T in three parts); dx out in bf16;
//       B  rows j: dB = w . (x R) + dG^T C (dG^T in three parts), a head's
//          partial out in float32;
//       C  rows i: u (C S^T), dC = exp(cs) . (dY S) + dG B, a head's partial
//          out in float32, the row sums of dM M;
//       D  R's update, (dY exp(cs))^T C in three parts, a warp owning 16 rows
//          p and 64 columns n of R; <R, S>; then one thread takes the
//          reverse cumsum of dcs in order, one float32 add a step, and
//          da_log's share; ddt out.
//     Every float32 operand against an exact bf16 one goes in three bf16
//     parts (kernels/_mma.cuh::split3), which carry it exactly.  Rows past
//     S and columns past P or N are zeros in shared memory, which neither
//     decay nor contribute.
//   * The second launch sums the float32 partials of dB and dC over the
//     heads in head order, and da_log's over batch rows and segments in
//     order (per-head partials, 2 x B H S N floats: summing dG over the
//     heads first would need a block that sees every head).
//
// Bound on the H100: memory, narrowly.  At mamba2-1.3b's layer (B 1,
// S 4,096, H 64, P 64, N 128) the gradient moves 111.1 MB (x, dY, dx, B and
// C in bf16; dt, ddt, dS_final, dB and dC in float32), 0.0332 ms, against
// 30.5 GFLOP of products at one bf16 part each (dM and M^T dY per head,
// B R^T, x R, dY S, C S^T and the R update per head, G, dG^T C and dG B
// once a batch row with dG summed over the heads), 0.0308 ms.  This kernel
// does about 150 GFLOP on the tensor cores by mma.sync (three parts; G and
// dM per head, made in each phase that needs them; pass 1), and writes and
// reads the 2 x 134 MB of per-head partials and the forward's 67 MB of
// chunk states.
//
// Interface: plain C, called through ctypes on PyTorch's current stream;
// each launch is checked with cudaGetLastError and its error code returned
// (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr unsigned FULL = 0xffffffffu;
constexpr int Q = 128;  // chunk length
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
// row pitches in bf16 values (padded by 16 bytes: conflict-free ldmatrix)
constexpr int XP = MAX_P + 8;
constexpr int NP = MAX_N + 8;
// shared memory: x, dY (Q x XP), B, C (Q x NP), three parts each of S and R
// (MAX_P x NP), then the chunk's float arrays and the reductions
constexpr int X_OFF = 0;
constexpr int DY_OFF = X_OFF + Q * XP * 2;
constexpr int B_OFF = DY_OFF + Q * XP * 2;
constexpr int C_OFF = B_OFF + Q * NP * 2;
constexpr int PART = MAX_P * NP;  // bf16 values of one part
constexpr int S_OFF = C_OFF + Q * NP * 2;
constexpr int R_OFF = S_OFF + 3 * PART * 2;
constexpr int F_OFF = R_OFF + 3 * PART * 2;
enum {
  F_DT,    // dt
  F_CS,    // the in-order cumsum of l = -a dt
  F_ECS,   // exp(cs)
  F_E,     // exp(cs_Q - cs)
  F_W,     // w = dt exp(cs_Q - cs)
  F_L,     // l
  F_ROWT,  // rowsum of dM M (rows i)
  F_COLT,  // colsum of dM M (columns j)
  F_U,     // u
  F_Q,     // x_j . R B_j
  F_DDT,   // sum_i dM_ij G_ij L_ij
  F_DL,    // dl
  F_COUNT
};
constexpr int RED_OFF = F_OFF + F_COUNT * Q * 4;
constexpr int BYTES = RED_OFF + 16 * 4;

struct Args {
  const bf16 *x, *b, *c, *dy;
  const float *dt, *a_log, *states, *dstate;
  bf16* dx;
  float* ddt;
  int* head;    // the unit counter, then a status word a unit
  float* ws_r;  // an inclusive (p, n) adjoint a unit
  float* ws_da;  // da_log's share a unit
  float *ws_db, *ws_dc;  // per-head partials (batch, h, s, n)
  int s, h, p, n, nc, segments;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A fragment (rows m0 .. m0 + 15, k0 .. k0 + 15) of a tile stored [m][k]
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* t,
                                    int pitch, int m0, int k0, int lane) {
  const int i = lane >> 3;
  mma::ldmatrix_x4(a, t + (m0 + (lane & 7) + 8 * (i & 1)) * pitch + k0 +
                          8 * (i >> 1));
}

// the same of a tile stored [k][m] (A transposed)
__device__ __forceinline__ void lda_t(uint32_t (&a)[4], const bf16* t,
                                      int pitch, int m0, int k0, int lane) {
  const int i = lane >> 3;
  mma::ldmatrix_x4_trans(
      a, t + (k0 + (lane & 7) + 8 * (i >> 1)) * pitch + m0 + 8 * (i & 1));
}

// B fragments of the n8 tiles n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]) over
// k0 .. k0 + 15, of a tile stored [n][k]
__device__ __forceinline__ void ldb_nk(uint32_t (&b)[4], const bf16* t,
                                       int pitch, int n0, int k0, int lane) {
  const int i = lane >> 3;
  mma::ldmatrix_x4(b, t + (n0 + (lane & 7) + 8 * (i >> 1)) * pitch + k0 +
                          8 * (i & 1));
}

// the same of a tile stored [k][n]
__device__ __forceinline__ void ldb_kn(uint32_t (&b)[4], const bf16* t,
                                       int pitch, int n0, int k0, int lane) {
  const int i = lane >> 3;
  mma::ldmatrix_x4_trans(
      b, t + (k0 + (lane & 7) + 8 * (i & 1)) * pitch + n0 + 8 * (i >> 1));
}

// d += a (three parts) b over the n8 tiles 2t and 2t + 1 of a pair
__device__ __forceinline__ void mma3(float (&d0)[4], float (&d1)[4],
                                     const uint32_t (&hi)[4],
                                     const uint32_t (&mid)[4],
                                     const uint32_t (&lo)[4],
                                     const uint32_t (&b)[4]) {
  mma::mma_bf16(d0, hi, b[0], b[1]);
  mma::mma_bf16(d0, mid, b[0], b[1]);
  mma::mma_bf16(d0, lo, b[0], b[1]);
  mma::mma_bf16(d1, hi, b[2], b[3]);
  mma::mma_bf16(d1, mid, b[2], b[3]);
  mma::mma_bf16(d1, lo, b[2], b[3]);
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the sum over the four lanes of a quad (lanes 4g .. 4g + 3), in every lane
__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(FULL, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(FULL, v, 2));
}

// one value of a (p, n) state from its three parts at element `off`
__device__ __forceinline__ float2 from_parts(const bf16* parts, int off) {
  const float2 hi = ld_bf2(parts + off), mid = ld_bf2(parts + PART + off),
               lo = ld_bf2(parts + 2 * PART + off);
  return make_float2(__fadd_rn(__fadd_rn(hi.x, mid.x), lo.x),
                     __fadd_rn(__fadd_rn(hi.y, mid.y), lo.y));
}

__device__ __forceinline__ void to_parts(bf16* parts, int off, float v0,
                                         float v1) {
  uint32_t hi, mid, lo;
  mma::split3(v0, v1, hi, mid, lo);
  *reinterpret_cast<uint32_t*>(parts + off) = hi;
  *reinterpret_cast<uint32_t*>(parts + PART + off) = mid;
  *reinterpret_cast<uint32_t*>(parts + 2 * PART + off) = lo;
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char sm[];
  bf16* xs = reinterpret_cast<bf16*>(sm + X_OFF);
  bf16* dys = reinterpret_cast<bf16*>(sm + DY_OFF);
  bf16* bs = reinterpret_cast<bf16*>(sm + B_OFF);
  bf16* cs_ = reinterpret_cast<bf16*>(sm + C_OFF);
  bf16* sp = reinterpret_cast<bf16*>(sm + S_OFF);
  bf16* rp = reinterpret_cast<bf16*>(sm + R_OFF);
  float* f = reinterpret_cast<float*>(sm + F_OFF);
  float* red = reinterpret_cast<float*>(sm + RED_OFF);
  int* unit_s = reinterpret_cast<int*>(red + WARPS);
  const float* fdt = f + F_DT * Q;
  const float* fcs = f + F_CS * Q;
  const float* fecs = f + F_ECS * Q;
  const float* fe = f + F_E * Q;
  const float* fw = f + F_W * Q;
  const float* fl = f + F_L * Q;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  if (tid == 0) *unit_s = atomicAdd(a.head, 1);
  __syncthreads();
  const int unit = *unit_s;
  const int T = a.segments;
  const int bh = unit / T, k = T - 1 - (unit - bh * T);
  const int bi = bh / a.h, hd = bh - bi * a.h;
  const int c_lo = static_cast<int>(static_cast<long long>(k) * a.nc / T);
  const int c_hi = static_cast<int>(static_cast<long long>(k + 1) * a.nc / T);
  const float al = -expf(a.a_log[hd]);
  const long long pn = static_cast<long long>(a.p) * a.n;
  const int r0 = 16 * warp;                           // rows i or j
  const int pr0 = 16 * (warp & 3), nb0 = 64 * (warp >> 2);  // R's block

  // the chunk's tiles (x and B only in pass 2) and dt into shared memory
  auto load = [&](int ci, bool pass2) {
    const int t0 = ci * Q;
    for (int e = tid; e < Q * (MAX_N / 8); e += THREADS) {
      const int r = e / (MAX_N / 8), col = 8 * (e % (MAX_N / 8));
      const bool ok = t0 + r < a.s && col < a.n;
      const long long src =
          ok ? (static_cast<long long>(bi) * a.s + t0 + r) * a.n + col : 0;
      mma::cp_async16(cs_ + r * NP + col, a.c + src, ok);
      if (pass2) mma::cp_async16(bs + r * NP + col, a.b + src, ok);
    }
    for (int e = tid; e < Q * (MAX_P / 8); e += THREADS) {
      const int r = e / (MAX_P / 8), col = 8 * (e % (MAX_P / 8));
      const bool ok = t0 + r < a.s && col < a.p;
      const long long src =
          ok ? ((static_cast<long long>(bi) * a.s + t0 + r) * a.h + hd) *
                       a.p +
                   col
             : 0;
      mma::cp_async16(dys + r * XP + col, a.dy + src, ok);
      if (pass2) mma::cp_async16(xs + r * XP + col, a.x + src, ok);
    }
    mma::cp_async_commit();
    if (tid < Q)
      f[F_DT * Q + tid] =
          t0 + tid < a.s
              ? a.dt[(static_cast<long long>(bi) * a.s + t0 + tid) * a.h + hd]
              : 0.f;
    if (pass2) {
      // the chunk's incoming state, from the forward, in three parts
      const float* src =
          a.states + (static_cast<long long>(bh) * a.nc + ci) * pn;
      for (int e = tid; e < MAX_P * MAX_N / 2; e += THREADS) {
        const int p = e / (MAX_N / 2), n = 2 * (e % (MAX_N / 2));
        const float2 v =
            p < a.p && n < a.n
                ? *reinterpret_cast<const float2*>(src + p * a.n + n)
                : make_float2(0.f, 0.f);
        to_parts(sp, p * NP + n, v.x, v.y);
      }
    }
    mma::cp_async_wait<0>();
    __syncthreads();
  };

  // the cumsum in order (one thread, one float32 add a step), then the
  // per-step factors
  auto scan = [&]() {
    if (tid == 0) {
      float run = 0.f;
#pragma unroll 16
      for (int j = 0; j < Q; ++j) {
        run = __fadd_rn(run, __fmul_rn(al, fdt[j]));
        f[F_CS * Q + j] = run;
      }
    }
    __syncthreads();
    if (tid < Q) {
      const float last = fcs[Q - 1], csj = fcs[tid], dtj = fdt[tid];
      const float e = expf(__fsub_rn(last, csj));
      f[F_ECS * Q + tid] = expf(csj);
      f[F_E * Q + tid] = e;
      f[F_W * Q + tid] = __fmul_rn(dtj, e);
      f[F_L * Q + tid] = __fmul_rn(al, dtj);
    }
    __syncthreads();
  };

  // acc = (dY exp(cs))^T C over this warp's block of R (rows p, columns n),
  // the A operand in three parts
  auto r_products = [&](float (&acc)[8][4]) {
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < Q / 16; ++kk) {
      uint32_t av[4], hi[4], mid[4], lo[4];
      lda_t(av, dys, XP, pr0, 16 * kk, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kb = 16 * kk + 2 * qd + 8 * (r >> 1);
        const float2 v =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[r]));
        mma::split3(__fmul_rn(v.x, fecs[kb]), __fmul_rn(v.y, fecs[kb + 1]),
                    hi[r], mid[r], lo[r]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t bv[4];
        ldb_kn(bv, cs_, NP, nb0 + 16 * t, 16 * kk, lane);
        mma3(acc[2 * t], acc[2 * t + 1], hi, mid, lo, bv);
      }
    }
  };
  // this thread's elements of R's block: (row p, column n, element offset
  // in a part) for accumulator (t, 2 hf)
  auto r_elem = [&](int t, int hf, int& p, int& n) {
    p = pr0 + g + 8 * hf;
    n = nb0 + 8 * t + 2 * qd;
  };

  // the products G (or G^T) and dM (or dM^T) of one 16 x 16 block: rows r0
  // of `ra` and `da`, columns c0 of `rb` and `db`
  auto gdm = [&](float (&gt)[2][4], float (&dm)[2][4], const bf16* ra,
                 const bf16* rb, const bf16* da, const bf16* db, int c0,
                 bool with_g) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) gt[u][e] = dm[u][e] = 0.f;
    if (with_g) {
#pragma unroll
      for (int kk = 0; kk < MAX_N / 16; ++kk) {
        uint32_t av[4], bv[4];
        lda(av, ra, NP, r0, 16 * kk, lane);
        ldb_nk(bv, rb, NP, c0, 16 * kk, lane);
        mma::mma_bf16(gt[0], av, bv[0], bv[1]);
        mma::mma_bf16(gt[1], av, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < MAX_P / 16; ++kk) {
      uint32_t av[4], bv[4];
      lda(av, da, XP, r0, 16 * kk, lane);
      ldb_nk(bv, db, XP, c0, 16 * kk, lane);
      mma::mma_bf16(dm[0], av, bv[0], bv[1]);
      mma::mma_bf16(dm[1], av, bv[2], bv[3]);
    }
  };

  // pass 1: the segment's adjoint aggregate from zero, from its last chunk,
  // and the product of its decays
  float agg[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) agg[t][e] = 0.f;
  float dprod = 1.f;
  if (k > 0) {
    for (int ci = c_hi - 1; ci >= c_lo; --ci) {
      __syncthreads();
      load(ci, false);
      scan();
      const float decay = expf(fcs[Q - 1]);
      float acc[8][4];
      r_products(acc);
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          agg[t][e] = __fadd_rn(__fmul_rn(agg[t][e], decay), acc[t][e]);
      dprod = __fmul_rn(dprod, decay);
    }
  }

  // the reverse hand-off: the adjoint entering this segment from the right
  // (the last segment's is dS_final), and this segment's inclusive one
  {
    const float* prev = nullptr;
    if (k < T - 1) {
      int* status = a.head + 1;
      if (tid == 0) {
        const long long start = clock64();
        unsigned ns = 32;
        while (ld_acquire(status + unit - 1) == 0) {
          __nanosleep(ns);
          ns = min(ns * 2, 1024u);
          if (clock64() - start > (1LL << 34)) __trap();
        }
      }
      __syncthreads();
      prev = a.ws_r + static_cast<long long>(unit - 1) * pn;
    } else if (a.dstate != nullptr) {
      prev = a.dstate + static_cast<long long>(bh) * pn;
    }
    float* mine = a.ws_r + static_cast<long long>(unit) * pn;
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        int p, n;
        r_elem(t, hf, p, n);
        const bool ok = p < a.p && n < a.n;
        const long long off = static_cast<long long>(p) * a.n + n;
        const float2 v = prev != nullptr && ok
                             ? __ldcg(reinterpret_cast<const float2*>(prev + off))
                             : make_float2(0.f, 0.f);
        if (k > 0 && ok)
          *reinterpret_cast<float2*>(mine + off) = make_float2(
              __fadd_rn(__fmul_rn(v.x, dprod), agg[t][2 * hf]),
              __fadd_rn(__fmul_rn(v.y, dprod), agg[t][2 * hf + 1]));
        to_parts(rp, p * NP + n, v.x, v.y);
      }
    if (k > 0) {
      __threadfence();
      __syncthreads();
      if (tid == 0) st_release(a.head + 1 + unit, 1);
    }
  }

  // pass 2: the gradients, chunk by chunk from the segment's last
  float da_blk = 0.f;  // thread 0's
  for (int ci = c_hi - 1; ci >= c_lo; --ci) {
    __syncthreads();
    load(ci, true);
    scan();
    const int t0 = ci * Q;
    const float decay = expf(fcs[Q - 1]);
    const int ra = r0 + g, rb = r0 + g + 8;  // this thread's rows
    const float cs0 = fcs[ra], cs1 = fcs[rb];

    // A: rows j.  dx = w (B R^T) + M^T dY; q_j = x_j . R B_j; the column
    // sums of dM M; sum_i dM_ij G_ij L_ij
    {
      float acc[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < MAX_N / 16; ++kk) {
        uint32_t av[4];
        lda(av, bs, NP, r0, 16 * kk, lane);
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            uint32_t bv[4];
            ldb_nk(bv, rp + part * PART, NP, 16 * t, 16 * kk, lane);
            mma::mma_bf16(acc[2 * t], av, bv[0], bv[1]);
            mma::mma_bf16(acc[2 * t + 1], av, bv[2], bv[3]);
          }
      }
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int col = 8 * t + 2 * qd;
        const float2 x0 = ld_bf2(xs + ra * XP + col),
                     x1 = ld_bf2(xs + rb * XP + col);
        q0 = __fadd_rn(q0, __fmul_rn(x0.x, acc[t][0]));
        q0 = __fadd_rn(q0, __fmul_rn(x0.y, acc[t][1]));
        q1 = __fadd_rn(q1, __fmul_rn(x1.x, acc[t][2]));
        q1 = __fadd_rn(q1, __fmul_rn(x1.y, acc[t][3]));
      }
      q0 = quad_sum(q0);
      q1 = quad_sum(q1);
      const float w0 = fw[ra], w1 = fw[rb];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        acc[t][0] = __fmul_rn(acc[t][0], w0);
        acc[t][1] = __fmul_rn(acc[t][1], w0);
        acc[t][2] = __fmul_rn(acc[t][2], w1);
        acc[t][3] = __fmul_rn(acc[t][3], w1);
      }
      const float dt0 = fdt[ra], dt1 = fdt[rb];
      float col0 = 0.f, col1 = 0.f, dd0 = 0.f, dd1 = 0.f;
#pragma unroll 1
      for (int ib = warp; ib < Q / 16; ++ib) {
        float gt[2][4], dm[2][4], mt[2][4];
        gdm(gt, dm, bs, cs_, xs, dys, 16 * ib, true);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 16 * ib + 8 * u + 2 * qd + (e & 1);
            const int j = e < 2 ? ra : rb;
            const bool causal = i >= j;
            const float lv =
                causal ? expf(__fsub_rn(fcs[i], e < 2 ? cs0 : cs1)) : 0.f;
            const float gl = __fmul_rn(gt[u][e], lv);
            const float m = __fmul_rn(gl, e < 2 ? dt0 : dt1);
            mt[u][e] = m;
            if (e < 2) {
              col0 = __fadd_rn(col0, __fmul_rn(dm[u][e], m));
              dd0 = __fadd_rn(dd0, __fmul_rn(dm[u][e], gl));
            } else {
              col1 = __fadd_rn(col1, __fmul_rn(dm[u][e], m));
              dd1 = __fadd_rn(dd1, __fmul_rn(dm[u][e], gl));
            }
          }
        uint32_t hi[4], mid[4], lo[4];
        mma::acc_to_a3(mt[0], mt[1], hi, mid, lo);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          uint32_t bv[4];
          ldb_kn(bv, dys, XP, 16 * t, 16 * ib, lane);
          mma3(acc[2 * t], acc[2 * t + 1], hi, mid, lo, bv);
        }
      }
      col0 = quad_sum(col0);
      col1 = quad_sum(col1);
      dd0 = quad_sum(dd0);
      dd1 = quad_sum(dd1);
      if (qd == 0) {
        f[F_COLT * Q + ra] = col0;
        f[F_COLT * Q + rb] = col1;
        f[F_DDT * Q + ra] = dd0;
        f[F_DDT * Q + rb] = dd1;
        f[F_Q * Q + ra] = q0;
        f[F_Q * Q + rb] = q1;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = t0 + r0 + g + 8 * hf;
        if (t >= a.s) continue;
        bf16* out =
            a.dx + ((static_cast<long long>(bi) * a.s + t) * a.h + hd) * a.p;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int col = 8 * u + 2 * qd;
          if (col < a.p)
            *reinterpret_cast<__nv_bfloat162*>(out + col) =
                __floats2bfloat162_rn(acc[u][2 * hf], acc[u][2 * hf + 1]);
        }
      }
    }

    // B: rows j.  dB = w (x R) + dG^T C, a head's partial
    {
      float acc[16][4];
#pragma unroll
      for (int t = 0; t < 16; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < MAX_P / 16; ++kk) {
        uint32_t av[4];
        lda(av, xs, XP, r0, 16 * kk, lane);
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            uint32_t bv[4];
            ldb_kn(bv, rp + part * PART, NP, 16 * t, 16 * kk, lane);
            mma::mma_bf16(acc[2 * t], av, bv[0], bv[1]);
            mma::mma_bf16(acc[2 * t + 1], av, bv[2], bv[3]);
          }
      }
      const float w0 = fw[ra], w1 = fw[rb], dt0 = fdt[ra], dt1 = fdt[rb];
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        acc[t][0] = __fmul_rn(acc[t][0], w0);
        acc[t][1] = __fmul_rn(acc[t][1], w0);
        acc[t][2] = __fmul_rn(acc[t][2], w1);
        acc[t][3] = __fmul_rn(acc[t][3], w1);
      }
#pragma unroll 1
      for (int ib = warp; ib < Q / 16; ++ib) {
        float gt[2][4], dm[2][4];
        gdm(gt, dm, bs, cs_, xs, dys, 16 * ib, false);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 16 * ib + 8 * u + 2 * qd + (e & 1);
            const int j = e < 2 ? ra : rb;
            const float lv =
                i >= j ? expf(__fsub_rn(fcs[i], e < 2 ? cs0 : cs1)) : 0.f;
            dm[u][e] = __fmul_rn(__fmul_rn(dm[u][e], lv), e < 2 ? dt0 : dt1);
          }
        uint32_t hi[4], mid[4], lo[4];
        mma::acc_to_a3(dm[0], dm[1], hi, mid, lo);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          uint32_t bv[4];
          ldb_kn(bv, cs_, NP, 16 * t, 16 * ib, lane);
          mma3(acc[2 * t], acc[2 * t + 1], hi, mid, lo, bv);
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = t0 + r0 + g + 8 * hf;
        if (t >= a.s) continue;
        float* out =
            a.ws_db + ((static_cast<long long>(bi) * a.h + hd) * a.s + t) * a.n;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int col = 8 * u + 2 * qd;
          if (col < a.n)
            *reinterpret_cast<float2*>(out + col) =
                make_float2(acc[u][2 * hf], acc[u][2 * hf + 1]);
        }
      }
    }

    // C: rows i.  u_i = exp(cs_i) (dY_i . S C_i); dC = exp(cs) (dY S) + dG B,
    // a head's partial; the row sums of dM M
    {
      float ys[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) ys[t][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < MAX_N / 16; ++kk) {
        uint32_t av[4];
        lda(av, cs_, NP, r0, 16 * kk, lane);
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            uint32_t bv[4];
            ldb_nk(bv, sp + part * PART, NP, 16 * t, 16 * kk, lane);
            mma::mma_bf16(ys[2 * t], av, bv[0], bv[1]);
            mma::mma_bf16(ys[2 * t + 1], av, bv[2], bv[3]);
          }
      }
      float u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int col = 8 * t + 2 * qd;
        const float2 d0 = ld_bf2(dys + ra * XP + col),
                     d1 = ld_bf2(dys + rb * XP + col);
        u0 = __fadd_rn(u0, __fmul_rn(d0.x, ys[t][0]));
        u0 = __fadd_rn(u0, __fmul_rn(d0.y, ys[t][1]));
        u1 = __fadd_rn(u1, __fmul_rn(d1.x, ys[t][2]));
        u1 = __fadd_rn(u1, __fmul_rn(d1.y, ys[t][3]));
      }
      const float e0 = fecs[ra], e1 = fecs[rb];
      u0 = __fmul_rn(e0, quad_sum(u0));
      u1 = __fmul_rn(e1, quad_sum(u1));

      float acc[16][4];
#pragma unroll
      for (int t = 0; t < 16; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < MAX_P / 16; ++kk) {
        uint32_t av[4];
        lda(av, dys, XP, r0, 16 * kk, lane);
#pragma unroll
        for (int part = 0; part < 3; ++part)
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            uint32_t bv[4];
            ldb_kn(bv, sp + part * PART, NP, 16 * t, 16 * kk, lane);
            mma::mma_bf16(acc[2 * t], av, bv[0], bv[1]);
            mma::mma_bf16(acc[2 * t + 1], av, bv[2], bv[3]);
          }
      }
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        acc[t][0] = __fmul_rn(acc[t][0], e0);
        acc[t][1] = __fmul_rn(acc[t][1], e0);
        acc[t][2] = __fmul_rn(acc[t][2], e1);
        acc[t][3] = __fmul_rn(acc[t][3], e1);
      }
      float row0 = 0.f, row1 = 0.f;
#pragma unroll 1
      for (int jb = 0; jb <= warp; ++jb) {
        float gv[2][4], dm[2][4];
        gdm(gv, dm, cs_, bs, dys, xs, 16 * jb, true);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 16 * jb + 8 * u + 2 * qd + (e & 1);
            const int i = e < 2 ? ra : rb;
            const bool causal = j <= i;
            const float lv =
                causal ? expf(__fsub_rn(e < 2 ? cs0 : cs1, fcs[j])) : 0.f;
            const float dtj = fdt[j];
            const float m = __fmul_rn(__fmul_rn(gv[u][e], lv), dtj);
            if (e < 2)
              row0 = __fadd_rn(row0, __fmul_rn(dm[u][e], m));
            else
              row1 = __fadd_rn(row1, __fmul_rn(dm[u][e], m));
            dm[u][e] = __fmul_rn(__fmul_rn(dm[u][e], lv), dtj);
          }
        uint32_t hi[4], mid[4], lo[4];
        mma::acc_to_a3(dm[0], dm[1], hi, mid, lo);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          uint32_t bv[4];
          ldb_kn(bv, bs, NP, 16 * t, 16 * jb, lane);
          mma3(acc[2 * t], acc[2 * t + 1], hi, mid, lo, bv);
        }
      }
      row0 = quad_sum(row0);
      row1 = quad_sum(row1);
      if (qd == 0) {
        f[F_ROWT * Q + ra] = row0;
        f[F_ROWT * Q + rb] = row1;
        f[F_U * Q + ra] = u0;
        f[F_U * Q + rb] = u1;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = t0 + r0 + g + 8 * hf;
        if (t >= a.s) continue;
        float* out =
            a.ws_dc + ((static_cast<long long>(bi) * a.h + hd) * a.s + t) * a.n;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int col = 8 * u + 2 * qd;
          if (col < a.n)
            *reinterpret_cast<float2*>(out + col) =
                make_float2(acc[u][2 * hf], acc[u][2 * hf + 1]);
        }
      }
    }

    // D: R's update and <R, S>; then, after every warp is done with R's
    // parts, the new parts, d cs's reverse cumsum and ddt
    {
      float acc[8][4];
      r_products(acc);
      float rs = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          int p, n;
          r_elem(t, hf, p, n);
          const float2 rv = from_parts(rp, p * NP + n),
                       sv = from_parts(sp, p * NP + n);
          rs = __fadd_rn(rs, __fmul_rn(rv.x, sv.x));
          rs = __fadd_rn(rs, __fmul_rn(rv.y, sv.y));
          acc[t][2 * hf] = __fadd_rn(__fmul_rn(rv.x, decay), acc[t][2 * hf]);
          acc[t][2 * hf + 1] =
              __fadd_rn(__fmul_rn(rv.y, decay), acc[t][2 * hf + 1]);
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(FULL, rs, o));
      if (lane == 0) red[warp] = rs;
      __syncthreads();
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          int p, n;
          r_elem(t, hf, p, n);
          to_parts(rp, p * NP + n, acc[t][2 * hf], acc[t][2 * hf + 1]);
        }
      if (tid == 0) {
        const float* fq = f + F_Q * Q;
        float vsum = 0.f;
        for (int j = 0; j < Q; ++j)
          vsum = __fadd_rn(vsum, __fmul_rn(fw[j], fq[j]));
        float rsum = 0.f;
        for (int w = 0; w < WARPS; ++w) rsum = __fadd_rn(rsum, red[w]);
        float run = __fadd_rn(vsum, __fmul_rn(decay, rsum));
        float dac = 0.f;
        for (int j = Q - 1; j >= 0; --j) {
          const float v = __fmul_rn(fw[j], fq[j]);
          const float dcs = __fsub_rn(
              __fadd_rn(__fsub_rn(f[F_ROWT * Q + j], f[F_COLT * Q + j]),
                        f[F_U * Q + j]),
              v);
          run = __fadd_rn(run, dcs);
          f[F_DL * Q + j] = run;
          dac = __fadd_rn(dac, __fmul_rn(run, fl[j]));
        }
        da_blk = __fadd_rn(da_blk, dac);
      }
      __syncthreads();
      if (tid < Q && t0 + tid < a.s) {
        const float d = __fadd_rn(
            __fadd_rn(f[F_DDT * Q + tid], __fmul_rn(fe[tid], f[F_Q * Q + tid])),
            __fmul_rn(al, f[F_DL * Q + tid]));
        a.ddt[(static_cast<long long>(bi) * a.s + t0 + tid) * a.h + hd] = d;
      }
    }
  }
  if (tid == 0) a.ws_da[static_cast<long long>(bh) * T + k] = da_blk;
}

// db, dc (batch, s, n) = the per-head partials summed in head order; da_log
// (h,) = the units' shares summed over batch rows, then segments, in order
__global__ void ssd_bwd_sum(const Args a, float* db, float* dc, float* da,
                            int batch) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long sn = static_cast<long long>(a.s) * a.n;
  if (idx < batch * sn) {
    const long long bi = idx / sn, rest = idx - bi * sn;
    float sb = 0.f, sc = 0.f;
    for (int hh = 0; hh < a.h; ++hh) {
      const long long o = (bi * a.h + hh) * sn + rest;
      sb = __fadd_rn(sb, a.ws_db[o]);
      sc = __fadd_rn(sc, a.ws_dc[o]);
    }
    db[idx] = sb;
    dc[idx] = sc;
  }
  if (idx < a.h) {
    float sa = 0.f;
    for (int bi = 0; bi < batch; ++bi)
      for (int kk = 0; kk < a.segments; ++kk)
        sa = __fadd_rn(
            sa, a.ws_da[(static_cast<long long>(bi) * a.h + idx) * a.segments +
                        kk]);
    da[idx] = sa;
  }
}

long long header_ints(long long units) { return (1 + units + 3) / 4 * 4; }

}  // namespace

extern "C" int ssd_chunk_bwd_len() { return Q; }
extern "C" int ssd_chunk_bwd_max_p() { return MAX_P; }
extern "C" int ssd_chunk_bwd_max_n() { return MAX_N; }
extern "C" int ssd_chunk_bwd_smem() { return BYTES; }

// bytes of the workspace: the unit counter and a status word a unit (zeroed
// by the launch, padded to 16 bytes), an inclusive (p, n) adjoint a unit,
// da_log's share a unit (padded to 16 bytes), then the per-head partials of
// dB and dC, (batch, h, s, n) float32 each
extern "C" long long ssd_chunk_bwd_workspace(int batch, int s, int h, int p,
                                             int n, int segments) {
  const long long units = static_cast<long long>(batch) * h * segments;
  return header_ints(units) * 4 + units * p * n * 4 + header_ints(units) * 4 +
         2LL * batch * h * s * n * 4;
}

// x, dy, dx: (batch, s, h, p) bf16; b, c: (batch, s, n) bf16; all 16-byte
// aligned; dt, ddt: (batch, s, h) float32; a_log, da_log: (h,) float32;
// states: (batch, h, ceil(s / Q), p, n) float32, each chunk's incoming state
// as the forward kernel writes it; dstate: (batch, h, p, n) float32 or null
// (zero); db, dc: (batch, s, n) float32; ws: ssd_chunk_bwd_workspace bytes,
// 16-byte aligned.  Everything contiguous; p and n multiples of 8, p <=
// MAX_P, n <= MAX_N, 1 <= segments <= ceil(s / Q).
extern "C" int ssd_chunk_bwd_launch(
    const void* x, const float* dt, const float* a_log, const void* b,
    const void* c, const void* dy, const float* states, const float* dstate,
    void* dx, float* ddt, float* da_log, float* db, float* dc, void* ws,
    int batch, int s, int h, int p, int n, int segments,
    cudaStream_t stream) {
  const int nc = s > 0 ? (s + Q - 1) / Q : 0;
  const long long units = static_cast<long long>(batch) * h * segments;
  if (batch <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || p > MAX_P ||
      n > MAX_N || p % 8 != 0 || n % 8 != 0 || segments < 1 ||
      segments > nc || units >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {x, b, c, dy, dx, ws};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.b = static_cast<const bf16*>(b);
  a.c = static_cast<const bf16*>(c);
  a.dy = static_cast<const bf16*>(dy);
  a.dt = dt;
  a.a_log = a_log;
  a.states = states;
  a.dstate = dstate;
  a.dx = static_cast<bf16*>(dx);
  a.ddt = ddt;
  a.head = static_cast<int*>(ws);
  a.ws_r = reinterpret_cast<float*>(a.head + header_ints(units));
  a.ws_da = a.ws_r + units * p * n;
  a.ws_db = a.ws_da + header_ints(units);
  a.ws_dc = a.ws_db + static_cast<long long>(batch) * h * s * n;
  a.s = s, a.h = h, a.p = p, a.n = n, a.nc = nc, a.segments = segments;
  cudaError_t e = cudaMemsetAsync(ws, 0, header_ints(units) * 4, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(ssd_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd<<<static_cast<unsigned>(units), THREADS, BYTES, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = static_cast<long long>(batch) * s * n;
  const long long blocks = ((total > h ? total : h) + 255) / 256;
  ssd_bwd_sum<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(a, db, dc,
                                                                da_log, batch);
  return static_cast<int>(cudaGetLastError());
}
