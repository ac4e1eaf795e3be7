// Flit packing / goodput efficiency for NVIDIA Hopper (sm_90a).
//
// Replaces: repro/kernels/flit_pack/kernel.py::flit_pack_pallas, the Pallas
// TPU kernel that evaluates, for every point of a flattened link-layer
// design grid (packet size x flit geometry x replay overhead),
//   n_flits = ceil(payload / max(flit_payload, 1))        int32, floor div
//   wire    = flit_size > 0 ? n_flits * flit_size : payload   int32
//   eff     = payload / max(wire * (1 + ppm * K), 1)          float32
// with K = (float)(1.0 / 1e6), the float32 value JAX gives the weakly typed
// constant 1.0 / PPM.  Every float32 operation is written with an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn), so nvcc can
// neither contract 1 + ppm * K into a fused multiply-add nor take an
// approximate division: each operation rounds once, as eager PyTorch's
// separate elementwise kernels do, and the result is bit-equal to the plain
// version.  Integer arithmetic wraps in 32 bits as the reference's does;
// the ops wrapper keeps payloads at or below MAX_PAYLOAD_B, where nothing
// wraps.
//
// The TPU kernel streamed 1024-point blocks through VMEM.  Here each thread
// handles points in a grid-stride loop, neighbouring threads on
// neighbouring points, so every load and store is coalesced.
//
// Bound on the H100: memory.  Four int32 reads and one int32 plus one
// float32 write per point: 24 B, about 7.5 us for 2^20 points and 120 us for
// 2^24 at 3.35 TB/s; the dozen integer and float operations per point are
// far below the card's rate.
//
// Interface: plain C, called through ctypes on PyTorch's current stream; the
// launch is checked with cudaGetLastError and its error code returned
// (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float K_PPM = static_cast<float>(1.0 / 1e6);

// Python / JAX floor division of int32 values (b >= 1 here).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

__global__ void __launch_bounds__(THREADS)
flit_pack_kernel(const int* __restrict__ payload,
                 const int* __restrict__ flit_size,
                 const int* __restrict__ flit_payload,
                 const int* __restrict__ replay_ppm, int* __restrict__ wire,
                 float* __restrict__ eff, long long k) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < k; i += stride) {
    const int pay = payload[i];
    const int fsize = flit_size[i];
    const int fpay = max(flit_payload[i], 1);
    const int n_flits = floor_div(wrap_add(wrap_add(pay, fpay), -1), fpay);
    const int w = fsize > 0 ? wrap_mul(n_flits, fsize) : pay;
    wire[i] = w;
    const float scale =
        __fadd_rn(1.0f, __fmul_rn(static_cast<float>(replay_ppm[i]), K_PPM));
    const float den = fmaxf(__fmul_rn(static_cast<float>(w), scale), 1.0f);
    eff[i] = __fdiv_rn(static_cast<float>(pay), den);
  }
}

}  // namespace

extern "C" int flit_pack_launch(const int* payload, const int* flit_size,
                                const int* flit_payload,
                                const int* replay_ppm, int* wire, float* eff,
                                long long k, cudaStream_t stream) {
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // enough blocks to fill the card several times over; the grid-stride loop
  // covers the rest
  long long blocks = (k + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;
  flit_pack_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      payload, flit_size, flit_payload, replay_ppm, wire, eff, k);
  return static_cast<int>(cudaGetLastError());
}
