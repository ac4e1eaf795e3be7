// RG-LRU linear recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces: repro/kernels/rglru_scan/kernel.py::rglru_scan_pallas, the
// Pallas TPU kernel computing, for float32 a, b of shape (B, S, D),
//   h_t = a_t * h_{t-1} + b_t      over t, from h_{-1} = 0,
// independently for every (batch, feature) column.
//
// The TPU kernel walked ordered sequence chunks and carried h from one to
// the next in VMEM scratch.  CUDA blocks run in no order, and one thread per
// column alone leaves the card mostly idle at the model's shapes (B = 1,
// D = 2560 is 2,560 threads for 132 SMs).  So the sequence is cut into
// chunks of CHUNK steps and scanned in three phases:
//   1. every (batch, chunk, feature) thread composes its chunk's affine map
//      h -> A*h + Bc (A = product of a, Bc = the chunk's scan from 0);
//   2. one thread per (batch, feature) walks the chunk maps in order and
//      writes the state entering each chunk;
//   3. every (batch, chunk, feature) thread re-scans its chunk from that
//      state and writes h.
// Phase 3 of the first chunk starts from 0, so with S <= CHUNK (one chunk,
// phases 1 and 2 skipped) the kernel equals the plain version bit for bit;
// longer sequences differ from it only by the rounding of the chunk carries.
// Every multiply and add is a round-to-nearest intrinsic, so nvcc does not
// contract a*h + b into a fused multiply-add: each step rounds twice, as
// the plain version's separate PyTorch operations do.
// Neighbouring threads take neighbouring features, so every load and store
// of a step is coalesced.  Any S and D are taken; the ragged edges are
// masked.
//
// Bound on the H100: memory.  The function reads a and b and writes h,
// 12 B per element (37.6 us at (1, 4096, 2560) over 3.35 TB/s); phases 1
// and 3 both read a and b, so the kernel moves 20 B per element.
//
// Interface: plain C, called through ctypes on PyTorch's current stream; the
// launches are checked with cudaGetLastError and its error code returned
// (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 64;

__global__ void __launch_bounds__(THREADS)
chunk_maps(const float* __restrict__ a, const float* __restrict__ b,
           float* __restrict__ agg_a, float* __restrict__ agg_b, int s,
           int d) {
  const int f = blockIdx.x * THREADS + threadIdx.x;
  if (f >= d) return;
  const int c = blockIdx.y, n_chunks = gridDim.y;
  const long long batch = blockIdx.z;
  const int t0 = c * CHUNK, t1 = min(s, t0 + CHUNK);
  const float* ap = a + (batch * s + t0) * d + f;
  const float* bp = b + (batch * s + t0) * d + f;
  float A = 1.0f, H = 0.0f;
#pragma unroll 8
  for (int t = t0; t < t1; ++t, ap += d, bp += d) {
    const float at = *ap;
    A = __fmul_rn(A, at);
    H = __fadd_rn(__fmul_rn(at, H), *bp);
  }
  const long long o = (batch * n_chunks + c) * d + f;
  agg_a[o] = A;
  agg_b[o] = H;
}

__global__ void __launch_bounds__(THREADS)
chunk_carries(const float* __restrict__ agg_a,
              const float* __restrict__ agg_b, float* __restrict__ carry,
              int n_chunks, int d) {
  const int f = blockIdx.x * THREADS + threadIdx.x;
  if (f >= d) return;
  const long long base = static_cast<long long>(blockIdx.y) * n_chunks * d;
  float h = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const long long o = base + static_cast<long long>(c) * d + f;
    carry[o] = h;
    h = __fadd_rn(__fmul_rn(agg_a[o], h), agg_b[o]);
  }
}

__global__ void __launch_bounds__(THREADS)
chunk_rescan(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ carry, float* __restrict__ out, int s,
             int d) {
  const int f = blockIdx.x * THREADS + threadIdx.x;
  if (f >= d) return;
  const int c = blockIdx.y, n_chunks = gridDim.y;
  const long long batch = blockIdx.z;
  const int t0 = c * CHUNK, t1 = min(s, t0 + CHUNK);
  const long long off = (batch * s + t0) * d + f;
  const float* ap = a + off;
  const float* bp = b + off;
  float* op = out + off;
  float h = carry ? carry[(batch * n_chunks + c) * d + f] : 0.0f;
#pragma unroll 8
  for (int t = t0; t < t1; ++t, ap += d, bp += d, op += d) {
    h = __fadd_rn(__fmul_rn(*ap, h), *bp);
    *op = h;
  }
}

}  // namespace

extern "C" int rglru_scan_chunk() { return CHUNK; }

// a, b, out: (batch, s, d) float32 contiguous.  agg_a, agg_b, carry:
// scratch of batch * ceil(s / CHUNK) * d floats each (unused, and may be
// null, when s <= CHUNK).
extern "C" int rglru_scan_launch(const float* a, const float* b, float* out,
                                 int batch, int s, int d, float* agg_a,
                                 float* agg_b, float* carry,
                                 cudaStream_t stream) {
  if (batch <= 0 || s <= 0 || d <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (s + CHUNK - 1) / CHUNK;
  if (n_chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((d + THREADS - 1) / THREADS, n_chunks, batch);
  if (n_chunks == 1) {
    chunk_rescan<<<grid, THREADS, 0, stream>>>(a, b, nullptr, out, s, d);
    return static_cast<int>(cudaGetLastError());
  }
  chunk_maps<<<grid, THREADS, 0, stream>>>(a, b, agg_a, agg_b, s, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_carries<<<dim3(grid.x, batch), THREADS, 0, stream>>>(
      agg_a, agg_b, carry, n_chunks, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_rescan<<<grid, THREADS, 0, stream>>>(a, b, carry, out, s, d);
  return static_cast<int>(cudaGetLastError());
}
