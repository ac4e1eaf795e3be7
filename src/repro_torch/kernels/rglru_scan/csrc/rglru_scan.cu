// RG-LRU linear recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces: repro/kernels/rglru_scan/kernel.py::rglru_scan_pallas, the
// Pallas TPU kernel computing, for float32 a, b of shape (B, S, D),
//   h_t = a_t * h_{t-1} + b_t      over t, from h_{-1} = 0,
// independently for every (batch, feature) column.
//
// The TPU kernel walked ordered sequence chunks and carried h from one to
// the next in VMEM scratch.  CUDA blocks run in no order, so here one block
// owns LANES adjacent features of one batch row and walks the whole
// sequence itself, in tiles of WARPS chunks of CHUNK steps, one launch and
// no state shared between blocks:
//   1. each warp loads its chunk of the tile (lane = feature, so a step's
//      32 features are one 128-byte load) into registers, and composes the
//      chunk's affine map h -> A*h + H (A = product of a, H = the chunk's
//      scan from 0);
//   2. warp 0 walks the tile's chunk maps in sequence order from the state
//      the previous tile left, writing each chunk's incoming state to shared
//      memory;
//   3. each warp re-scans its chunk from that state and writes h.
// The next tile's a and b are loaded while this tile is computed, so a and
// b are read once and h written once.  The chunk carries are composed in
// sequence order with the same roundings as ref.rglru_scan_blocked(a, b,
// CHUNK), which the kernel equals bit for bit; the first chunk starts from
// 0, so with S <= CHUNK it equals the plain version bit for bit, and longer
// sequences differ from it only by the rounding of the chunk carries.  The
// result does not depend on timing: every carry is composed in one order.
// Every multiply and add is a round-to-nearest intrinsic, so nvcc does not
// contract a*h + b into a fused multiply-add: each step rounds twice, as
// the plain version's separate PyTorch operations do.  Any S and D are
// taken; features past D are masked.
//
// Bound on the H100: memory.  The function reads a and b and writes h,
// 12 B per element (37.6 us at (1, 4096, 2560) over 3.35 TB/s), and this
// design moves exactly that.  At D = 2560 it runs 80 blocks of 512 threads,
// one per SM, each with a tile (64 KB of a and b) loading while it computes
// the one before.
//
// Interface: plain C, called through ctypes on PyTorch's current stream; the
// launch is checked with cudaGetLastError and its error code returned
// (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;  // features per block, one per lane
constexpr int WARPS = 16;  // chunks per tile, one per warp
constexpr int CHUNK = 16;  // steps per chunk
constexpr int TILE = WARPS * CHUNK;
constexpr int THREADS = WARPS * 32;

// This warp's chunk of the tile at t0: n steps (0 past the sequence's end
// or for a masked feature), read into registers.
__device__ __forceinline__ void load_chunk(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           long long off, int n, int d,
                                           float* ra, float* rb) {
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    if (j < n) {
      ra[j] = a[off + static_cast<long long>(j) * d];
      rb[j] = b[off + static_cast<long long>(j) * d];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int s, int d) {
  __shared__ float map_a[WARPS][LANES];
  __shared__ float map_h[WARPS][LANES];
  __shared__ float incoming[WARPS][LANES];
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int f = blockIdx.x * LANES + lane;
  const bool live = f < d;
  const long long col = static_cast<long long>(blockIdx.y) * s * d + f;

  // steps of this warp's chunk in the tile at t0
  auto steps = [&](int t0) {
    const int c0 = t0 + w * CHUNK;
    return live ? max(0, min(CHUNK, s - c0)) : 0;
  };
  auto offset = [&](int t0) {
    return col + static_cast<long long>(t0 + w * CHUNK) * d;
  };

  float ca[CHUNK], cb[CHUNK], na[CHUNK], nb[CHUNK];
  load_chunk(a, b, offset(0), steps(0), d, ca, cb);
  float carry = 0.0f;  // warp 0: the state the previous tile left
  for (int t0 = 0; t0 < s; t0 += TILE) {
    const int n = steps(t0);
    if (t0 + TILE < s) load_chunk(a, b, offset(t0 + TILE), steps(t0 + TILE),
                                  d, na, nb);
    // 1. this chunk's map
    float A = 1.0f, H = 0.0f;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (j < n) {
        A = __fmul_rn(A, ca[j]);
        H = __fadd_rn(__fmul_rn(ca[j], H), cb[j]);
      }
    }
    map_a[w][lane] = A;
    map_h[w][lane] = H;
    __syncthreads();
    // 2. the tile's chunk carries, in sequence order
    if (w == 0) {
      float h = carry;
      for (int c = 0; c < WARPS; ++c) {
        incoming[c][lane] = h;
        if (t0 + c * CHUNK < s)
          h = __fadd_rn(__fmul_rn(map_a[c][lane], h), map_h[c][lane]);
      }
      carry = h;
    }
    __syncthreads();
    // 3. the chunk re-scanned from its incoming state
    float h = incoming[w][lane];
    float* op = out + offset(t0);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (j < n) {
        h = __fadd_rn(__fmul_rn(ca[j], h), cb[j]);
        op[static_cast<long long>(j) * d] = h;
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      ca[j] = na[j];
      cb[j] = nb[j];
    }
  }
}

}  // namespace

extern "C" int rglru_scan_chunk() { return CHUNK; }

// Sequence steps one block walks per tile (WARPS chunks).
extern "C" int rglru_scan_tile() { return TILE; }

// a, b, out: (batch, s, d) float32 contiguous.
extern "C" int rglru_scan_launch(const float* a, const float* b, float* out,
                                 int batch, int s, int d,
                                 cudaStream_t stream) {
  if (batch <= 0 || s <= 0 || d <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((d + LANES - 1) / LANES, batch);
  rglru_scan_kernel<<<grid, THREADS, 0, stream>>>(a, b, out, s, d);
  return static_cast<int>(cudaGetLastError());
}
