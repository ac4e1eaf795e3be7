// Causal / sliding-window GQA flash attention for NVIDIA Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention/kernel.py::flash_attention_gqa,
// the Pallas TPU kernel computing, for every query head,
//   o = softmax(q k^T / sqrt(D) masked) v
// with the causal mask (key <= query) and, when window > 0, the sliding
// window (key > query - window); scores, softmax and the PV product in
// float32, the output rounded to the input type.  Query heads are grouped
// per KV head (GQA, MQA), and K and V are never replicated.
//
// Layout: the model's own, read with strides, so nothing is transposed or
// copied: q and o (B, S, H, D), k and v (B, T, KV, D), query head h reading
// KV head h / (H / KV).  bf16 or float32 in, the same type out.
//
// Design.  One block of 16 warps per (batch, query head, 64-row query tile);
// each warp owns 4 query rows.  The block walks the KV tiles of 64 keys in
// order, so the online-softmax state (running max m, running sum l and the
// output accumulator) stays in each warp's registers across the whole walk:
// the TPU kernel carried it across an ordered grid axis in VMEM, which CUDA
// blocks cannot do.  Per tile:
//   * the K tile (transposed, padded against bank conflicts) and the V tile
//     go to shared memory in float32;
//   * each lane computes the scores of its warp's 4 rows against keys lane
//     and lane + 32, the query rows read as broadcast float4;
//   * masking, the tile's row max and sum are warp shuffles; the tile's
//     probabilities go through shared memory to the PV product, where each
//     lane accumulates the output columns lane + 32 * i.
// KV tiles that lie wholly above the diagonal or wholly before the window of
// the tile's first row are skipped (the TPU kernel executed them to add
// zero), which halves the work at S = 4096 and a window of 2048.  Any S and
// T with S <= T are taken: ragged edges are masked (the TPU wrapper
// required S and T to be multiples of its blocks).  Every row then has at
// least one key it may see, so masked entries contribute exactly zero, as
// the reference's NEG-masked softmax gives them.
//
// Bound on the H100: the tensor cores.  4 * D flops per unmasked (query,
// key) pair: at (B 1, H 10, S 4096, D 256, window 2048) 64 GFLOP, 0.065 ms
// at 989 TFLOP/s bf16, against 0.04 ms for its 23 MB.  This first kernel
// computes in float32 on the CUDA cores (67 TFLOP/s at best) from shared
// memory; tensor cores (wgmma), TMA and pipelined tiles are later work.
//
// Interface: plain C, called through ctypes on PyTorch's current stream; the
// launch is checked with cudaGetLastError and its error code returned
// (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;           // query rows per warp
constexpr int BQ = WARPS * RPW;  // query rows per block
constexpr int BK = 64;           // keys per tile: two per lane
constexpr int KT_LD = BK + 1;    // padded row of the transposed K tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// component u of x (u is a constant once the caller's loop is unrolled)
__device__ __forceinline__ float part(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

size_t smem_bytes(int d) {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * d + static_cast<size_t>(d) * KT_LD +
          static_cast<size_t>(BK) * d + BQ * BK);
}

// DPL: output columns per lane (D <= 32 * DPL)
template <typename T, int DPL>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int s, int t, int h,
          int kvh, int d, int causal, int window, float sqrt_d) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // BQ x d
  float* kt = qs + BQ * d;     // d x KT_LD (K tile, transposed)
  float* vs = kt + d * KT_LD;  // BK x d
  float* ps = vs + BK * d;     // BQ x BK (probabilities)

  const int head = blockIdx.y;
  const long long batch = blockIdx.z;
  const int kv = head / (h / kvh);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long q_stride = static_cast<long long>(h) * d;
  const long long kv_stride = static_cast<long long>(kvh) * d;
  const T* qb = q + (batch * s * h + head) * d;
  T* ob = o + (batch * s * h + head) * d;
  const T* kb = k + (batch * t * kvh + kv) * d;
  const T* vb = v + (batch * t * kvh + kv) * d;

  for (int idx = tid; idx < BQ * d; idx += THREADS) {
    const int i = idx / d, c = idx - i * d, row = q0 + i;
    qs[idx] = row < s ? to_f(qb[row * q_stride + c]) : 0.0f;
  }

  // keys any row of this tile may see
  int k_lo = 0, k_hi = t;
  if (causal) k_hi = min(t, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);

  const int r0 = warp * RPW;
  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
  }

  for (int j0 = (k_lo / BK) * BK; j0 < k_hi; j0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BK * d; idx += THREADS) {
      const int j = idx / d, c = idx - j * d, key = j0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (key < t) {
        const long long off = key * kv_stride + c;
        kx = to_f(kb[off]);
        vx = to_f(vb[off]);
      }
      kt[c * KT_LD + j] = kx;
      vs[idx] = vx;
    }
    __syncthreads();

    // scores of rows r0.. r0+3 against keys j0+lane and j0+lane+32
    float sc[RPW][2];
#pragma unroll
    for (int r = 0; r < RPW; ++r) sc[r][0] = sc[r][1] = 0.0f;
    for (int c = 0; c < d; c += 4) {
      float4 qv[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        qv[r] = *reinterpret_cast<const float4*>(qs + (r0 + r) * d + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float k0 = kt[(c + u) * KT_LD + lane];
        const float k1 = kt[(c + u) * KT_LD + lane + 32];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float qq = part(qv[r], u);
          sc[r][0] = fmaf(qq, k0, sc[r][0]);
          sc[r][1] = fmaf(qq, k1, sc[r][1]);
        }
      }
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = q0 + r0 + r;
      float x[2];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int key = j0 + lane + 32 * cc;
        const bool ok = key < t && (!causal || key <= row) &&
                        (window <= 0 || key > row - window);
        x[cc] = ok ? __fdiv_rn(sc[r][cc], sqrt_d) : -INFINITY;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x[0], x[1])));
      const float alpha = m_new == -INFINITY ? 1.0f : expf(m[r] - m_new);
      const float p0 = x[0] == -INFINITY ? 0.0f : expf(x[0] - m_new);
      const float p1 = x[1] == -INFINITY ? 0.0f : expf(x[1] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      ps[(r0 + r) * BK + lane] = p0;
      ps[(r0 + r) * BK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += p v over the tile's keys
    for (int j = 0; j < BK; j += 4) {
      float4 pv[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        pv[r] = *reinterpret_cast<const float4*>(ps + (r0 + r) * BK + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int col = lane + 32 * i;
          const float vx = col < d ? vs[(j + u) * d + col] : 0.0f;
#pragma unroll
          for (int r = 0; r < RPW; ++r)
            acc[r][i] = fmaf(part(pv[r], u), vx, acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + r0 + r;
    if (row >= s) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int col = lane + 32 * i;
      if (col < d) put(ob + row * q_stride + col, __fdiv_rn(acc[r][i], den));
    }
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int t, int h, int kvh, int d, int causal, int window,
           float sqrt_d, cudaStream_t stream) {
  const size_t bytes = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_fwd<T, DPL><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, t, h, kvh, d, causal,
      window, sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int s, int t, int h, int kvh, int d, int causal, int window,
             float sqrt_d, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 1>(q, k, v, o, b, s, t, h, kvh, d, causal, window,
                        sqrt_d, stream);
  if (d <= 64)
    return launch<T, 2>(q, k, v, o, b, s, t, h, kvh, d, causal, window,
                        sqrt_d, stream);
  if (d <= 128)
    return launch<T, 4>(q, k, v, o, b, s, t, h, kvh, d, causal, window,
                        sqrt_d, stream);
  return launch<T, 8>(q, k, v, o, b, s, t, h, kvh, d, causal, window, sqrt_d,
                      stream);
}

}  // namespace

extern "C" int flash_attention_max_head_dim() { return 256; }

// q, o: (b, s, h, d); k, v: (b, t, kvh, d); all contiguous, of one type
// (bf16 = 1, float32 = 0).  Needs 1 <= s <= t, h % kvh == 0, d % 4 == 0
// and 4 <= d <= 256.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bf16, int b,
                                      int s, int t, int h, int kvh, int d,
                                      int causal, int window, float sqrt_d,
                                      cudaStream_t stream) {
  if (b <= 0 || b > 65535 || s <= 0 || s > t || h <= 0 || h > 65535 ||
      kvh <= 0 || h % kvh != 0 || d < 4 || d > 256 || d % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, b, s, t, h, kvh, d, causal,
                                   window, sqrt_d, stream);
  return launch_d<float>(q, k, v, o, b, s, t, h, kvh, d, causal, window,
                         sqrt_d, stream);
}
