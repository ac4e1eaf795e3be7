// Mamba-2 SSD chunk scan for NVIDIA Hopper (sm_90a).
//
// Replaces: repro/kernels/ssd_chunk/kernel.py::ssd_chunk_pallas, the Pallas
// TPU kernel computing, for x (B, S, H, P), dt (B, S, H), a_log (H,) and
// b, c (B, S, N) shared by all heads, over chunks of Q steps:
//   cs     = cumsum over the chunk of logA,  logA = -exp(a_log) * dt
//   y_diag = (C B^T . exp(cs_i - cs_j) [j <= i]) (x * dt)
//   y_off  = (C state_in^T) . exp(cs_i)
//   state  = state_in * exp(cs_last) + (x * dt . exp(cs_last - cs_j))^T B
// with the (P, N) state carried from chunk to chunk of every (batch, head).
//
// The TPU kernel ran the chunks of a (batch, head) in order on a sequential
// grid axis, the state in VMEM scratch.  CUDA blocks run in no order, so
// this kernel takes the reference's own decomposition (models/ssd.py::
// ssd_chunked: chunk states, a sequential pass, then y_off) in three phases:
//   1. one block per (batch, head, chunk): the chunk's cumsum, its state
//      contribution and its decay exp(cs_last);
//   2. one thread per (batch, head, state element): a walk over the chunks
//      that overwrites each contribution, in place, with the state entering
//      that chunk, and writes the final state;
//   3. one block per (batch, head, chunk): y_off from the incoming state,
//      then y_diag over query-row tiles of RT rows.
// When S fits one chunk, one launch does all of it (phase 3 with no
// incoming state, then the chunk's state as the final state).
//
// The chunk is Q = 128 steps; the tail chunk is masked (its missing steps
// are zeros, which neither decay nor contribute), so any S >= 1 is taken.
// Products run in float32 FMA on the CUDA cores from shared memory: a block
// is 16 x 16 threads and each thread owns a strided register tile of its
// output (rows ty + 16 a, columns tx + 16 b), so a warp's loads are one
// broadcast address per row and 16 consecutive ones per column.  Rows of
// B and C are padded to an odd word stride so that column reads do not
// conflict.  Shared memory at P = 64, N = 128: 183,424 bytes in float32,
// 117,888 with bf16 B and C (staged as the model gives them), so one block
// per SM (the query-row tiles keep it under the 227 KB limit: whole-chunk
// scores alone would take 64 KB more).  Masked exponentials
// are selected, never multiplied by 0 (exp(cs_i - cs_j) overflows above the
// diagonal).  expf is the accurate one (no fast math).
//
// Bound on the H100: memory.  One layer's prefill at S = 4096 (B 1, H 64,
// P 64, N 128, x and y bf16) moves 72.4 MB (21.6 us at 3.35 TB/s) against
// 13.0 GFLOP of minimal work (13.2 us at the 989 TFLOP/s bf16 tensor-core
// rate).  This first kernel recomputes C B^T per head, runs on the CUDA
// cores and moves the chunk states through memory, so it runs far from it.
//
// Interface: plain C, called through ctypes on PyTorch's current stream; the
// launches are checked with cudaGetLastError and its error code returned
// (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "chunk_walk.cuh"

namespace {

constexpr int Q = 128;        // chunk length
constexpr int TX = 16;        // threads per block: TX x TX
constexpr int THREADS = TX * TX;
constexpr int RT = 32;        // query rows per score tile
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int PA = MAX_P / TX;  // P columns (or rows) per thread
constexpr int NB = MAX_N / TX;  // N columns per thread
constexpr int QA = Q / TX;      // query rows per thread
constexpr int JC = Q / TX;      // key columns per thread in a score tile
constexpr int RA = RT / TX;     // query rows per thread in a score tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// padded row stride (elements) of B and C in shared memory: an odd number
// of 32-bit words
template <typename T>
__host__ __device__ constexpr int row_stride(int n) {
  return sizeof(T) == 4 ? n + 1 : n + 2;
}

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

// shared-memory layout (byte offsets), the same on host and device
template <typename T>
struct Layout {
  size_t dts, cs, ecs, wrest, xs, r, cs_tile, ss, total;
  __host__ __device__ Layout(bool with_y, int p, int n) {
    const size_t bc = static_cast<size_t>(Q) * row_stride<T>(n) * sizeof(T);
    const size_t st = static_cast<size_t>(n) * (p + 1) * sizeof(float);
    dts = 0;
    cs = dts + Q * sizeof(float);
    ecs = cs + Q * sizeof(float);
    wrest = ecs + Q * sizeof(float);
    xs = align16(wrest + Q * sizeof(float));
    r = align16(xs + static_cast<size_t>(Q) * p * sizeof(float));
    // r holds B (T, padded rows), or the transposed state (float) first
    const size_t r_bytes = bc > st ? bc : st;
    cs_tile = align16(r + r_bytes);
    ss = with_y ? align16(cs_tile + bc) : cs_tile;
    total = with_y ? ss + static_cast<size_t>(RT) * (Q + 1) * sizeof(float)
                   : cs_tile;
  }
};

// rows [0, Q) x cols [0, cols) of a row-major global matrix into shared
// memory with row stride ld; rows >= valid are zero
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* src, long long stride,
                          int valid, int cols) {
  for (int e = threadIdx.x; e < Q * cols; e += THREADS) {
    const int r = e / cols, k = e - r * cols;
    dst[r * ld + k] = r < valid ? src[r * stride + k] : T(0.0f);
  }
}

// One block per (chunk, head, batch).  STATE: the chunk's state
// contribution (to `states`, with its decay, or to `final_state` when the
// sequence is one chunk).  Y: the chunk's output, with the incoming state
// read from `states` for every chunk but the first.
template <typename T, bool Y, bool STATE>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_log, const T* __restrict__ bm,
                 const T* __restrict__ cm, T* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ decay,
                 float* __restrict__ final_state, int s, int h, int p,
                 int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T> lay(Y, p, n);
  float* dts = reinterpret_cast<float*>(smem + lay.dts);
  float* cs = reinterpret_cast<float*>(smem + lay.cs);
  float* ecs = reinterpret_cast<float*>(smem + lay.ecs);
  float* wrest = reinterpret_cast<float*>(smem + lay.wrest);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  T* bs = reinterpret_cast<T*>(smem + lay.r);
  float* st = reinterpret_cast<float*>(smem + lay.r);
  T* cs_t = reinterpret_cast<T*>(smem + lay.cs_tile);
  float* ss = reinterpret_cast<float*>(smem + lay.ss);

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int c = blockIdx.x, nc = gridDim.x, hh = blockIdx.y;
  const long long bi = blockIdx.z;
  const int t0 = c * Q, len = min(Q, s - t0);
  const int ldb = row_stride<T>(n);
  const bool state_in = Y && c > 0;
  const long long bh = bi * h + hh;

  // dt of the chunk's steps (0 past the end)
  if (tid < Q) dts[tid] = tid < len ? dt[(bi * s + t0 + tid) * h + hh] : 0.f;
  __syncthreads();

  // cs: one thread walks the chunk in order, one float32 add a step, as
  // the plain version does, so that both take the same cumsum (the chunk
  // cumsums reach -10^3 on the model's inputs, where another order moves
  // exp(cs_i - cs_j) by about 1e-4); logA rounds before it is summed
  if (tid == 0) {
    const float a = -expf(a_log[hh]);
    float run = 0.f;
    for (int k = 0; k < Q; ++k) {
      run = __fadd_rn(run, __fmul_rn(a, dts[k]));
      cs[k] = run;
    }
  }
  // x * dt, the chunk's rows of x for this head
  const T* xsrc = x + ((bi * s + t0) * h + hh) * static_cast<long long>(p);
  for (int e = tid; e < Q * p; e += THREADS) {
    const int r = e / p, k = e - r * p;
    xs[e] = r < len ? to_f(xsrc[static_cast<long long>(r) * h * p + k]) *
                          dts[r]
                    : 0.f;
  }
  const T* bsrc = bm + (bi * s + t0) * static_cast<long long>(n);
  if (Y) {
    load_rows(cs_t, ldb, cm + (bi * s + t0) * static_cast<long long>(n), n,
              len, n);
  }
  if (state_in) {
    // the incoming state (P, N), transposed to (N, P + 1)
    const float* sp = states + (bh * nc + c) * static_cast<long long>(p) * n;
    for (int e = tid; e < p * n; e += THREADS) {
      const int pp = e / n, nn = e - pp * n;
      st[nn * (p + 1) + pp] = sp[e];
    }
  } else {
    load_rows(bs, ldb, bsrc, n, len, n);
  }
  __syncthreads();
  if (tid < Q) {
    ecs[tid] = expf(cs[tid]);
    wrest[tid] = expf(cs[Q - 1] - cs[tid]);
  }
  __syncthreads();

  if (Y) {
    float acc[QA][PA];
#pragma unroll
    for (int a = 0; a < QA; ++a)
#pragma unroll
      for (int b = 0; b < PA; ++b) acc[a][b] = 0.f;
    int pcol[PA];
#pragma unroll
    for (int b = 0; b < PA; ++b) pcol[b] = min(tx + TX * b, p - 1);
    const int pa_n = (p + TX - 1) / TX;

    if (state_in) {
      // y_off = exp(cs_i) * (C_i . state_p)
      for (int k = 0; k < n; ++k) {
        float cv[QA], sv[PA];
#pragma unroll
        for (int a = 0; a < QA; ++a)
          cv[a] = to_f(cs_t[(ty + TX * a) * ldb + k]);
#pragma unroll
        for (int b = 0; b < PA; ++b) sv[b] = st[k * (p + 1) + pcol[b]];
#pragma unroll
        for (int a = 0; a < QA; ++a)
#pragma unroll
          for (int b = 0; b < PA; ++b)
            if (b < pa_n) acc[a][b] = fmaf(cv[a], sv[b], acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < QA; ++a)
#pragma unroll
        for (int b = 0; b < PA; ++b) acc[a][b] *= ecs[ty + TX * a];
      __syncthreads();
      load_rows(bs, ldb, bsrc, n, len, n);
      __syncthreads();
    }

    // y_diag over query-row tiles (the test on i0 is uniform over the
    // block, so the barriers inside stay collective)
#pragma unroll
    for (int rt = 0; rt < Q / RT; ++rt) {
      const int i0 = rt * RT;
      if (i0 < len) {
        const int jmax = min(i0 + RT, len);  // keys any row of the tile sees
        const int jc_n = (jmax + TX - 1) / TX;
        float sc[RA][JC];
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int j = 0; j < JC; ++j) sc[a][j] = 0.f;
        for (int k = 0; k < n; ++k) {
          float cv[RA];
#pragma unroll
          for (int a = 0; a < RA; ++a)
            cv[a] = to_f(cs_t[(i0 + ty + TX * a) * ldb + k]);
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            if (j < jc_n) {
              const float bv = to_f(bs[(tx + TX * j) * ldb + k]);
#pragma unroll
              for (int a = 0; a < RA; ++a) sc[a][j] = fmaf(cv[a], bv, sc[a][j]);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          const int ii = ty + TX * a, i = i0 + ii;
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            const int jj = tx + TX * j;
            if (j < jc_n) {
              // select, never multiply by the mask: exp overflows for j > i
              ss[ii * (Q + 1) + jj] =
                  jj <= i ? expf(cs[i] - cs[jj]) * sc[a][j] : 0.f;
            }
          }
        }
        __syncthreads();
        for (int j = 0; j < jmax; ++j) {
          float sv[RA], xv[PA];
#pragma unroll
          for (int a = 0; a < RA; ++a) sv[a] = ss[(ty + TX * a) * (Q + 1) + j];
#pragma unroll
          for (int b = 0; b < PA; ++b) xv[b] = xs[j * p + pcol[b]];
#pragma unroll
          for (int a = 0; a < RA; ++a)
#pragma unroll
            for (int b = 0; b < PA; ++b)
              if (b < pa_n)
                acc[rt * RA + a][b] = fmaf(sv[a], xv[b], acc[rt * RA + a][b]);
        }
        __syncthreads();
      }
    }

    T* ydst = y + ((bi * s + t0) * h + hh) * static_cast<long long>(p);
#pragma unroll
    for (int a = 0; a < QA; ++a) {
      const int i = ty + TX * a;
#pragma unroll
      for (int b = 0; b < PA; ++b) {
        const int pp = tx + TX * b;
        if (i < len && pp < p)
          store(ydst + static_cast<long long>(i) * h * p + pp, acc[a][b]);
      }
    }
  }

  if (STATE) {
    // the chunk's contribution: sum_j (x dt)_j exp(cs_last - cs_j) B_j
    float sacc[PA][NB];
#pragma unroll
    for (int a = 0; a < PA; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) sacc[a][b] = 0.f;
    int prow[PA], ncol[NB];
#pragma unroll
    for (int a = 0; a < PA; ++a) prow[a] = min(ty + TX * a, p - 1);
#pragma unroll
    for (int b = 0; b < NB; ++b) ncol[b] = min(tx + TX * b, n - 1);
    const int nb_n = (n + TX - 1) / TX, pr_n = (p + TX - 1) / TX;
    for (int j = 0; j < len; ++j) {
      const float w = wrest[j];
      float xv[PA], bv[NB];
#pragma unroll
      for (int a = 0; a < PA; ++a) xv[a] = xs[j * p + prow[a]] * w;
#pragma unroll
      for (int b = 0; b < NB; ++b) bv[b] = to_f(bs[j * ldb + ncol[b]]);
#pragma unroll
      for (int a = 0; a < PA; ++a)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          if (a < pr_n && b < nb_n) sacc[a][b] = fmaf(xv[a], bv[b], sacc[a][b]);
    }
    const long long pn = static_cast<long long>(p) * n;
    float* dst = nc == 1 ? final_state + bh * pn : states + (bh * nc + c) * pn;
#pragma unroll
    for (int a = 0; a < PA; ++a) {
      const int pp = ty + TX * a;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int nn = tx + TX * b;
        if (pp < p && nn < n) dst[pp * n + nn] = sacc[a][b];
      }
    }
    if (nc > 1 && tid == 0) decay[bh * nc + c] = expf(cs[Q - 1]);
  }
}

template <typename T, bool Y, bool STATE>
cudaError_t launch_chunks(dim3 grid, const void* x, const float* dt,
                          const float* a_log, const void* b, const void* c,
                          void* y, float* states, float* decay,
                          float* final_state, int s, int h, int p, int n,
                          cudaStream_t stream) {
  const size_t bytes = Layout<T>(Y, p, n).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, Y, STATE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<T, Y, STATE><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), dt, a_log, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), states, decay,
      final_state, s, h, p, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const float* dt, const float* a_log,
                const void* b, const void* c, void* y, float* final_state,
                float* states, float* decay, int batch, int s, int h, int p,
                int n, cudaStream_t stream) {
  const int nc = (s + Q - 1) / Q;
  const dim3 grid(nc, h, batch);
  if (nc == 1)
    return launch_chunks<T, true, true>(grid, x, dt, a_log, b, c, y, nullptr,
                                        nullptr, final_state, s, h, p, n,
                                        stream);
  cudaError_t err = launch_chunks<T, false, true>(
      grid, x, dt, a_log, b, c, y, states, decay, final_state, s, h, p, n,
      stream);
  if (err != cudaSuccess) return err;
  err = launch_chunk_walk(states, decay, final_state, nc, p * n, batch * h,
                          stream);
  if (err != cudaSuccess) return err;
  return launch_chunks<T, true, false>(grid, x, dt, a_log, b, c, y, states,
                                       decay, final_state, s, h, p, n,
                                       stream);
}

}  // namespace

extern "C" int ssd_chunk_len() { return Q; }
extern "C" int ssd_chunk_max_p() { return MAX_P; }
extern "C" int ssd_chunk_max_n() { return MAX_N; }

// x, y: (batch, s, h, p); b, c: (batch, s, n), all bf16 when `bf16` is
// nonzero, else float32; dt: (batch, s, h) and a_log: (h,) float32;
// final_state: (batch, h, p, n) float32.  states: (batch, h, ceil(s / Q),
// p, n) and decay: (batch, h, ceil(s / Q)) float32 scratch, unused (and may
// be null) when s <= Q.  Everything contiguous.
extern "C" int ssd_chunk_launch(const void* x, const float* dt,
                                const float* a_log, const void* b,
                                const void* c, void* y, float* final_state,
                                float* states, float* decay, int bf16,
                                int batch, int s, int h, int p, int n,
                                cudaStream_t stream) {
  if (batch <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || p > MAX_P ||
      n > MAX_N || h > 65535 || batch > 65535 ||
      static_cast<long long>(batch) * h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      bf16 ? run<__nv_bfloat16>(x, dt, a_log, b, c, y, final_state, states,
                                decay, batch, s, h, p, n, stream)
           : run<float>(x, dt, a_log, b, c, y, final_state, states, decay,
                        batch, s, h, p, n, stream);
  return static_cast<int>(err);
}
