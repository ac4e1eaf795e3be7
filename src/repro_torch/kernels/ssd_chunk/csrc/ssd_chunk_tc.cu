// Mamba-2 SSD chunk scan on Hopper's tensor cores (sm_90a, mma.sync), for
// bf16 x, b and c with P and N multiples of 8 (P <= 64, N <= 128).  Float32
// inputs and other shapes take the CUDA-core kernel in ssd_chunk.cu.
//
// Replaces: repro/kernels/ssd_chunk/kernel.py::ssd_chunk_pallas, the Pallas
// TPU kernel computing, for x (B, S, H, P), dt (B, S, H), a_log (H,) and
// b, c (B, S, N) shared by all heads, over chunks of Q steps:
//   cs     = cumsum over the chunk of logA,  logA = -exp(a_log) * dt
//   y_diag = (C B^T . exp(cs_i - cs_j) [j <= i]) (x * dt)
//   y_off  = (C state_in^T) . exp(cs_i)
//   state  = state_in * exp(cs_last) + (x * dt . exp(cs_last - cs_j))^T B
// in float32, with the (P, N) state carried from chunk to chunk.
//
// Design.  The three phases of ssd_chunk.cu (chunk states, the walk giving
// each chunk its incoming state, chunk outputs; one fused launch when S fits
// one chunk), with the products on the tensor cores and one block per
// (chunk, group of HG heads, batch row) of 8 warps:
//   * B and C of the chunk go to shared memory once per block (cp.async),
//     and the block computes G = C B^T (128 x 128 over N) once, for all its
//     heads, and keeps its lower triangle in shared memory in the
//     accumulator fragments' own layout.  The CUDA-core kernel recomputed G
//     for every head.
//   * Per head, x (and, for the outputs, the incoming state, staged over
//     B once G is made) goes to shared memory by cp.async while the head
//     before computes.  The chunk cumsum is taken in order, one float32 add
//     a step (ref.cumsum), for all the group's heads at once.
//   * Outputs: M_ij = G_ij exp(cs_i - cs_j) dt_j for j <= i, else 0 (a
//     select: the exp overflows above the diagonal), formed in registers
//     from G's fragments, split in three bf16 parts (_mma.cuh) into A
//     fragments, and y_diag = M_hi x + M_mid x + M_lo x with x's bf16
//     fragments from ldmatrix.trans.  y_off = exp(cs_i) (C state_in^T)
//     with state_in in three parts in shared memory.  dt moves from x * dt
//     into M, so x stays exact bf16.  Warp w takes the 16-row blocks q and
//     7 - q (q = w % 4) for half of P, so that every warp has 9 of the
//     triangle's 36 blocks (with one row block a warp, the last would have
//     8 and the first 1).
//   * Chunk states: (x w)^T B with w_j = dt_j exp(cs_last - cs_j), x w in
//     three parts in shared memory and B exact.
//   * Every float32 operand goes in three bf16 parts, which carry it
//     exactly, not the two (hi, lo) of flash_attention_tc.cu: on
//     model-like inputs (dt near 1, |M| and the states up to 10^2) the
//     hi/lo split's 2^-17 of each term moved outputs near zero past the
//     atol of 3e-5: 1.20 of the tolerance with M in two parts in the CPU
//     rehearsal (kernels/rehearse.py), then up to 3.4 with the states in
//     two parts on the card.
//   * Products that are exactly zero are skipped by warp-uniform tests, which
//     changes no result: rows whose exp(cs_i) or w_j underflows to 0 (cs
//     reaches -10^3 on model-like inputs) and blocks of M far below the
//     diagonal.
//   * The parts of a product accumulate in the tensor cores, hi, then mid,
//     then lo, into the running float32 sum.
// The chunk states go through device memory to the walk (chunk_walk.cuh)
// and back, as in ssd_chunk.cu.  The tail chunk's missing steps and the
// padding of P and N to multiples of 16 are zeros, which neither decay nor
// contribute.  Shared memory: 215,040 bytes (one block per SM).
//
// Bound on the H100: memory.  One layer's prefill at S = 4096 (B 1, H 64,
// P 64, N 128, x and y bf16) moves 72.4 MB (21.6 us at 3.35 TB/s) against
// 12.9 GFLOP of minimal work (13.0 us at the 989 TFLOP/s bf16 tensor-core
// rate); the three-part splits triple the products that take a float32
// operand, and the chunk states add 4 x 67 MB of traffic.  wgmma, TMA and
// keeping the chunk states on chip are later work.
//
// Interface: plain C, called through ctypes on PyTorch's current stream; the
// launches are checked with cudaGetLastError and its error code returned
// (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../_mma.cuh"
#include "chunk_walk.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int Q = 128;  // chunk length
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int HG = 8;  // heads per block
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int LDB = MAX_N + 8;  // row stride (bf16) of B, C, the state
constexpr int LDX = MAX_P + 8;  // row stride (bf16) of x and of x w
constexpr int RB = Q / 16;      // 16-row blocks of a chunk
// G's lower triangle of 16 x 16 blocks, each as two n8 accumulator tiles
// stored lane by lane (a float4 a lane), so that any warp reads any block
// in its own fragment layout
constexpr int G_TILES = RB * (RB + 1);
constexpr size_t SMEM_BYTES =
    sizeof(bf16) * (2 * Q * LDB + 2 * Q * LDX + 3 * Q * LDX) +
    sizeof(float4) * G_TILES * 32 + sizeof(float) * 4 * HG * Q;

// One block per (chunk, head group, batch row).  STATE: each head's chunk
// state (to `states`, with its decay, or to `final_state` when the sequence
// is one chunk).  Y: each head's chunk output, with the incoming state read
// from `states` for every chunk but the first.
template <bool Y, bool STATE>
__device__ __forceinline__ void ssd_tc_body(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a_log, const bf16* __restrict__ bm,
    const bf16* __restrict__ cm, bf16* __restrict__ y,
    float* __restrict__ states, float* __restrict__ decay,
    float* __restrict__ final_state, int s, int h, int p, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bs = reinterpret_cast<bf16*>(smem);  // Q x LDB
  bf16* cs = bs + Q * LDB;                   // Q x LDB
  bf16* xs = cs + Q * LDB;                   // 2 stages x Q x LDX
  // x w in three parts (Q x LDX each), or the incoming state in three
  // (MAX_P x LDB each)
  bf16* rs = xs + 2 * Q * LDX;
  float4* gs = reinterpret_cast<float4*>(rs + 3 * Q * LDX);  // G
  float* dts = reinterpret_cast<float*>(gs + G_TILES * 32);  // HG x Q
  float* css = dts + HG * Q;                                 // cumsums
  float* ecs = css + HG * Q;                                 // exp(cs_i)
  float* wts = ecs + HG * Q;  // dt_j exp(cs_last - cs_j)

  const int c = blockIdx.x, nc = gridDim.x, h0 = blockIdx.y * HG;
  const long long bi = blockIdx.z;
  const int nh = min(HG, h - h0);
  const int t0 = c * Q, len = min(Q, s - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int p16 = (p + 15) & ~15, n16 = (n + 15) & ~15;
  const bool state_in = Y && c > 0;
  const long long pn = static_cast<long long>(p) * n;

  // The copy loops below run over the largest shapes (MAX_P, MAX_N) with
  // fixed trip counts, so they unroll and issue their loads together;
  // entries past p16, n16 are skipped (and never read).
  // B and C of the chunk (zero past the sequence's end and past n)
  const bf16* bsrc = bm + (bi * s + t0) * static_cast<long long>(n);
  const bf16* csrc = cm + (bi * s + t0) * static_cast<long long>(n);
#pragma unroll
  for (int it = 0; it < Q * (MAX_N / 8) / THREADS; ++it) {
    const int e = tid + it * THREADS;
    const int r = e / (MAX_N / 8), k = e % (MAX_N / 8);
    if (k * 8 < n16) {
      const bool ok = r < len && k * 8 < n;
      const long long off = ok ? r * static_cast<long long>(n) + k * 8 : 0;
      mma::cp_async16(bs + r * LDB + k * 8, bsrc + off, ok);
      if (Y) mma::cp_async16(cs + r * LDB + k * 8, csrc + off, ok);
    }
  }
  // x of head h0 + hh into a stage (zero past the end and past p)
  auto load_x = [&](int hh, int stage) {
    bf16* dst = xs + stage * Q * LDX;
    const bf16* src = x + ((bi * s + t0) * h + h0 + hh) *
                              static_cast<long long>(p);
#pragma unroll
    for (int it = 0; it < Q * (MAX_P / 8) / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = e / (MAX_P / 8), k = e % (MAX_P / 8);
      if (k * 8 < p16) {
        const bool ok = r < len && k * 8 < p;
        mma::cp_async16(
            dst + r * LDX + k * 8,
            ok ? src + r * static_cast<long long>(h) * p + k * 8 : x, ok);
      }
    }
  };
  load_x(0, 0);
  mma::cp_async_commit();

#pragma unroll
  for (int it = 0; it < HG * Q / THREADS; ++it) {
    const int e = tid + it * THREADS;
    const int hh = e / Q, j = e % Q;
    dts[e] = hh < nh && j < len ? dt[(bi * s + t0 + j) * h + h0 + hh] : 0.f;
  }
  __syncthreads();
  // the cumsums, one head a thread, in order, one float32 add a step (the
  // plain version's order: the chunk cumsums reach -10^3 on the model's
  // inputs, where another order moves exp(cs_i - cs_j) by about 1e-4);
  // logA rounds before it is summed
  if (tid < nh) {
    const float a = -expf(a_log[h0 + tid]);
    float run = 0.f;
    for (int k = 0; k < Q; ++k) {
      run = __fadd_rn(run, __fmul_rn(a, dts[tid * Q + k]));
      css[tid * Q + k] = run;
    }
  }
  __syncthreads();
  for (int e = tid; e < nh * Q; e += THREADS) {
    const int hh = e / Q;
    ecs[e] = expf(css[e]);
    wts[e] = __fmul_rn(dts[e], expf(__fsub_rn(css[hh * Q + Q - 1], css[e])));
  }
  if (STATE && !Y && tid < nh)
    decay[(bi * h + h0 + tid) * nc + c] = expf(css[tid * Q + Q - 1]);

  if (Y) {
    // G = C B^T, once for the block: warp w the blocks (w, 0..w) of its
    // lower triangle
    mma::cp_async_wait<0>();
    __syncthreads();
    float gacc[Q / 8][4];
#pragma unroll
    for (int j = 0; j < Q / 8; ++j)
      gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAX_N / 16; ++kk) {
      if (kk * 16 < n16) {
        uint32_t a[4];
        mma::ldmatrix_x4(a, cs + (warp * 16 + (lane & 15)) * LDB + kk * 16 +
                                ((lane >> 4) << 3));
#pragma unroll
        for (int np = 0; np < RB; ++np) {
          if (np <= warp) {
            uint32_t b[4];
            mma::ldmatrix_x4(
                b, bs + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDB +
                       kk * 16 + (((lane >> 3) & 1) << 3));
            mma::mma_bf16(gacc[2 * np], a, b[0], b[1]);
            mma::mma_bf16(gacc[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
    }
    const int tri = warp * (warp + 1) / 2;
#pragma unroll
    for (int np = 0; np < RB; ++np) {
      if (np <= warp) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* v = gacc[2 * np + half];
          gs[((tri + np) * 2 + half) * 32 + lane] =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
  // the incoming state of head h0 + hh, float32 (p16 x n16 of MAX_P x
  // MAX_N, zero past p and n), into the staging area over B: B is read only
  // for G when Y and not STATE, which is when an incoming state exists
  float* stg = reinterpret_cast<float*>(bs);
  auto load_state = [&](int hh) {
    const float* src = states + ((bi * h + h0 + hh) * nc + c) * pn;
#pragma unroll
    for (int it = 0; it < MAX_P * (MAX_N / 4) / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = e / (MAX_N / 4), k = e % (MAX_N / 4);
      if (r < p16 && k * 4 < n16) {
        const bool ok = r < p && k * 4 < n;
        mma::cp_async16(stg + r * MAX_N + k * 4,
                        ok ? src + r * n + k * 4 : src, ok);
      }
    }
  };
  if (state_in) {
    __syncthreads();  // every warp is done with B
    load_state(0);
  }
  mma::cp_async_commit();

  // the outputs' work: warp w takes the 16-row blocks q and 7 - q, q = w %
  // 4, which together hold 9 of the triangle's 36 blocks, and half of P
  const int quad = warp & 3, pcol = (warp >> 2) * (MAX_P / 2);
  const bool y_cols = pcol < p16;

  for (int hh = 0; hh < nh; ++hh) {
    const int head = h0 + hh, stage = hh & 1;
    const bf16* xst = xs + stage * Q * LDX;
    const long long bh = bi * h + head;
    // this head's x and incoming state have landed, and every warp is
    // done with the head before
    mma::cp_async_wait<0>();
    __syncthreads();
    bf16* sh = rs;
    bf16* sm = rs + MAX_P * LDB;
    bf16* sl = rs + 2 * MAX_P * LDB;
    if (state_in) {
      // the incoming state in three parts
#pragma unroll
      for (int it = 0; it < MAX_P * (MAX_N / 2) / THREADS; ++it) {
        const int e = tid + it * THREADS;
        const int pp = e / (MAX_N / 2), k2 = (e % (MAX_N / 2)) * 2;
        if (pp < p16 && k2 < n16) {
          const float2 f =
              *reinterpret_cast<const float2*>(stg + pp * MAX_N + k2);
          uint32_t hi, mid, lo;
          mma::split3(f.x, f.y, hi, mid, lo);
          *reinterpret_cast<uint32_t*>(sh + pp * LDB + k2) = hi;
          *reinterpret_cast<uint32_t*>(sm + pp * LDB + k2) = mid;
          *reinterpret_cast<uint32_t*>(sl + pp * LDB + k2) = lo;
        }
      }
      __syncthreads();
    }
    // the next head's loads run behind this head's products
    if (hh + 1 < nh) {
      load_x(hh + 1, stage ^ 1);
      if (state_in) load_state(hh + 1);
    }
    mma::cp_async_commit();
    const float* csh = css + hh * Q;
    const float* dth = dts + hh * Q;

    if (Y && y_cols) {
      // acc[rr][j]: row block rb(rr), the n8 tile j of this warp's P half
      float acc[2][MAX_P / 16][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int j = 0; j < MAX_P / 16; ++j)
          acc[rr][j][0] = acc[rr][j][1] = acc[rr][j][2] = acc[rr][j][3] = 0.f;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int rb = rr == 0 ? quad : RB - 1 - quad;
        const int i0 = rb * 16 + g, i1 = i0 + 8;
        // y_off = exp(cs_i) (C state_in^T), skipped where exp(cs_i) is 0
        // on all 16 rows (it underflows once cs_i < -104)
        if (state_in && __any_sync(0xffffffffu, ecs[hh * Q + i0] != 0.f ||
                                                    ecs[hh * Q + i1] != 0.f)) {
#pragma unroll
          for (int kk = 0; kk < MAX_N / 16; ++kk) {
            if (kk * 16 < n16) {
              uint32_t a[4];
              mma::ldmatrix_x4(a, cs + (rb * 16 + (lane & 15)) * LDB +
                                      kk * 16 + ((lane >> 4) << 3));
#pragma unroll
              for (int pl = 0; pl < MAX_P / 32; ++pl) {
                const int pp = pcol / 16 + pl;
                if (pp * 16 < p16) {
                  const int off =
                      (pp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDB +
                      kk * 16 + (((lane >> 3) & 1) << 3);
                  uint32_t bh_[4], bm_[4], bl_[4];
                  mma::ldmatrix_x4(bh_, sh + off);
                  mma::ldmatrix_x4(bm_, sm + off);
                  mma::ldmatrix_x4(bl_, sl + off);
#pragma unroll
                  for (int half = 0; half < 2; ++half) {
                    const int i = 2 * half;
                    float(&d)[4] = acc[rr][2 * pl + half];
                    mma::mma_bf16(d, a, bh_[i], bh_[i + 1]);
                    mma::mma_bf16(d, a, bm_[i], bm_[i + 1]);
                    mma::mma_bf16(d, a, bl_[i], bl_[i + 1]);
                  }
                }
              }
            }
          }
          const float e0 = ecs[hh * Q + i0], e1 = ecs[hh * Q + i1];
#pragma unroll
          for (int j = 0; j < MAX_P / 16; ++j) {
            acc[rr][j][0] *= e0;
            acc[rr][j][1] *= e0;
            acc[rr][j][2] *= e1;
            acc[rr][j][3] *= e1;
          }
        }
        // y_diag = M_hi x + M_mid x + M_lo x over the key blocks of the
        // row block's part of the lower triangle
        const int tri = rb * (rb + 1) / 2;
        for (int kb = 0; kb <= rb; ++kb) {
          float mv[2][4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float4 gv = gs[((tri + kb) * 2 + half) * 32 + lane];
            const float gf[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = kb * 16 + half * 8 + 2 * qd + (e & 1);
              const int i = e < 2 ? i0 : i1;
              mv[half][e] =
                  j <= i ? __fmul_rn(__fmul_rn(gf[e], expf(__fsub_rn(
                                                          csh[i], csh[j]))),
                                     dth[j])
                         : 0.f;
            }
          }
          // a block of M that is all 0 (exp(cs_i - cs_j) underflows far
          // below the diagonal) adds nothing
          if (!__any_sync(0xffffffffu, mv[0][0] != 0.f || mv[0][1] != 0.f ||
                                           mv[0][2] != 0.f || mv[0][3] != 0.f ||
                                           mv[1][0] != 0.f || mv[1][1] != 0.f ||
                                           mv[1][2] != 0.f || mv[1][3] != 0.f))
            continue;
          uint32_t mh[4], mm[4], ml[4];
          mma::acc_to_a3(mv[0], mv[1], mh, mm, ml);
#pragma unroll
          for (int pl = 0; pl < MAX_P / 32; ++pl) {
            const int pp = pcol / 16 + pl;
            if (pp * 16 < p16) {
              uint32_t b[4];
              mma::ldmatrix_x4_trans(
                  b, xst +
                         (kb * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                             LDX +
                         pp * 16 + ((lane >> 4) << 3));
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                float(&d)[4] = acc[rr][2 * pl + half];
                mma::mma_bf16(d, mh, b[2 * half], b[2 * half + 1]);
                mma::mma_bf16(d, mm, b[2 * half], b[2 * half + 1]);
                mma::mma_bf16(d, ml, b[2 * half], b[2 * half + 1]);
              }
            }
          }
        }
      }
      bf16* yd = y + ((bi * s + t0) * h + head) * static_cast<long long>(p);
      const long long row = static_cast<long long>(h) * p;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int rb = rr == 0 ? quad : RB - 1 - quad;
        const int i0 = rb * 16 + g, i1 = i0 + 8;
#pragma unroll
        for (int j = 0; j < MAX_P / 16; ++j) {
          const int col = pcol + j * 8 + 2 * qd;
          if (col < p) {
            if (i0 < len)
              *reinterpret_cast<__nv_bfloat162*>(yd + i0 * row + col) =
                  __floats2bfloat162_rn(acc[rr][j][0], acc[rr][j][1]);
            if (i1 < len)
              *reinterpret_cast<__nv_bfloat162*>(yd + i1 * row + col) =
                  __floats2bfloat162_rn(acc[rr][j][2], acc[rr][j][3]);
          }
        }
      }
    }

    if (STATE) {
      // (x w) in three parts, w_j = dt_j exp(cs_last - cs_j) (the region
      // holds no incoming state when STATE)
      bf16* xh = rs;
      bf16* xm = rs + Q * LDX;
      bf16* xl = rs + 2 * Q * LDX;
      const float* w = wts + hh * Q;
#pragma unroll 8
      for (int it = 0; it < Q * (MAX_P / 2) / THREADS; ++it) {
        const int e = tid + it * THREADS;
        const int j = e / (MAX_P / 2), k2 = (e % (MAX_P / 2)) * 2;
        if (k2 < p16) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xst + j * LDX + k2));
          uint32_t hi, mid, lo;
          mma::split3(__fmul_rn(xv.x, w[j]), __fmul_rn(xv.y, w[j]), hi, mid,
                      lo);
          *reinterpret_cast<uint32_t*>(xh + j * LDX + k2) = hi;
          *reinterpret_cast<uint32_t*>(xm + j * LDX + k2) = mid;
          *reinterpret_cast<uint32_t*>(xl + j * LDX + k2) = lo;
        }
      }
      __syncthreads();
      // state (P, N) = (x w)^T B: warp (row group of 16, half of N)
      const int pr = (warp & 3) * 16, n0 = (warp >> 2) * 64;
      if (pr < p16 && n0 < n16) {
        float sacc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < Q / 16; ++kk) {
          // rows whose w_j is 0 (exp(cs_last - cs_j) underflows, or past
          // the end) add nothing
          if (__any_sync(0xffffffffu, w[kk * 16 + (lane & 15)] != 0.f)) {
            const int off = (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDX +
                            pr + (((lane >> 3) & 1) << 3);
            uint32_t ah[4], am[4], al[4];
            mma::ldmatrix_x4_trans(ah, xh + off);
            mma::ldmatrix_x4_trans(am, xm + off);
            mma::ldmatrix_x4_trans(al, xl + off);
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              if (n0 + np * 16 < n16) {
                uint32_t b[4];
                mma::ldmatrix_x4_trans(
                    b, bs +
                           (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                               LDB +
                           n0 + np * 16 + ((lane >> 4) << 3));
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  const int i = 2 * half;
                  float(&d)[4] = sacc[2 * np + half];
                  mma::mma_bf16(d, ah, b[i], b[i + 1]);
                  mma::mma_bf16(d, am, b[i], b[i + 1]);
                  mma::mma_bf16(d, al, b[i], b[i + 1]);
                }
              }
            }
          }
        }
        float* dst =
            nc == 1 ? final_state + bh * pn : states + (bh * nc + c) * pn;
        const int r0 = pr + g, r1 = r0 + 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + j * 8 + 2 * qd;
          if (col < n) {
            if (r0 < p)
              *reinterpret_cast<float2*>(dst + r0 * n + col) =
                  make_float2(sacc[j][0], sacc[j][1]);
            if (r1 < p)
              *reinterpret_cast<float2*>(dst + r1 * n + col) =
                  make_float2(sacc[j][2], sacc[j][3]);
          }
        }
      }
    }
  }
}

#define SSD_TC_ARGS                                                         \
  const bf16 *__restrict__ x, const float *__restrict__ dt,                 \
      const float *__restrict__ a_log, const bf16 *__restrict__ bm,         \
      const bf16 *__restrict__ cm, bf16 *__restrict__ y,                    \
      float *__restrict__ states, float *__restrict__ decay,                \
      float *__restrict__ final_state, int s, int h, int p, int n
#define SSD_TC_PASS \
  x, dt, a_log, bm, cm, y, states, decay, final_state, s, h, p, n

// phase 1: each chunk's state and decay
__global__ void __launch_bounds__(THREADS, 1) ssd_tc_states(SSD_TC_ARGS) {
  ssd_tc_body<false, true>(SSD_TC_PASS);
}
// phase 3: each chunk's output from its incoming state
__global__ void __launch_bounds__(THREADS, 1) ssd_tc_outputs(SSD_TC_ARGS) {
  ssd_tc_body<true, false>(SSD_TC_PASS);
}
// one chunk: the output and the final state
__global__ void __launch_bounds__(THREADS, 1) ssd_tc_fused(SSD_TC_ARGS) {
  ssd_tc_body<true, true>(SSD_TC_PASS);
}

using Kernel = void (*)(SSD_TC_ARGS);

cudaError_t launch(Kernel kernel, dim3 grid, const void* x, const float* dt,
                   const float* a_log, const void* b, const void* c, void* y,
                   float* states, float* decay, float* final_state, int s,
                   int h, int p, int n, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), dt, a_log, static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<bf16*>(y), states, decay,
      final_state, s, h, p, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_chunk_tc_len() { return Q; }
extern "C" int ssd_chunk_tc_max_p() { return MAX_P; }
extern "C" int ssd_chunk_tc_max_n() { return MAX_N; }
extern "C" int ssd_chunk_tc_smem() { return static_cast<int>(SMEM_BYTES); }

// x, y: (batch, s, h, p); b, c: (batch, s, n), all bf16; dt: (batch, s, h)
// and a_log: (h,) float32; final_state: (batch, h, p, n) float32.  states:
// (batch, h, ceil(s / Q), p, n) and decay: (batch, h, ceil(s / Q)) float32
// scratch, unused (and may be null) when s <= Q.  Everything contiguous;
// p and n multiples of 8, p <= MAX_P, n <= MAX_N.
extern "C" int ssd_chunk_tc_launch(const void* x, const float* dt,
                                   const float* a_log, const void* b,
                                   const void* c, void* y, float* final_state,
                                   float* states, float* decay, int batch,
                                   int s, int h, int p, int n,
                                   cudaStream_t stream) {
  if (batch <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || p > MAX_P ||
      n > MAX_N || p % 8 != 0 || n % 8 != 0 || batch > 65535 ||
      static_cast<long long>(batch) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (s + Q - 1) / Q;
  const dim3 grid(nc, (h + HG - 1) / HG, batch);
  if (nc == 1)
    return static_cast<int>(launch(ssd_tc_fused, grid, x, dt, a_log, b, c, y,
                                   nullptr, nullptr, final_state, s, h, p, n,
                                   stream));
  cudaError_t err = launch(ssd_tc_states, grid, x, dt, a_log, b, c, y, states,
                           decay, final_state, s, h, p, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_chunk_walk(states, decay, final_state, nc, p * n, batch * h,
                          stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch(ssd_tc_outputs, grid, x, dt, a_log, b, c, y,
                                 states, decay, final_state, s, h, p, n,
                                 stream));
}
