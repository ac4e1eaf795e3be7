// Phase 2 of the SSD chunk scan of ssd_chunk.cu (the CUDA-core kernel):
// the walk over the chunks that gives each chunk its incoming state and
// writes the final state.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int WALK_THREADS = 256;
constexpr int WALK = 8;  // chunk loads in flight in the walk

// state_in[c] = state; state = state * decay[c] + contribution[c], in place
// over the contributions; one thread per (batch, head, element).  Two
// roundings a step, as the plain version's separate operations.
__global__ void __launch_bounds__(WALK_THREADS)
chunk_walk(float* __restrict__ states, const float* __restrict__ decay,
           float* __restrict__ final_state, int nc, int pn) {
  const int e = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (e >= pn) return;
  const long long bh = blockIdx.y;
  float* sp = states + bh * nc * static_cast<long long>(pn) + e;
  const float* dp = decay + bh * nc;
  float state = 0.f;
  int c = 0;
  // the loads do not depend on the state: issue WALK of them at once
  for (; c + WALK <= nc; c += WALK) {
    float contrib[WALK];
#pragma unroll
    for (int k = 0; k < WALK; ++k)
      contrib[k] = sp[static_cast<long long>(c + k) * pn];
#pragma unroll
    for (int k = 0; k < WALK; ++k) {
      sp[static_cast<long long>(c + k) * pn] = state;
      state = __fadd_rn(__fmul_rn(state, dp[c + k]), contrib[k]);
    }
  }
  for (; c < nc; ++c) {
    const float contrib = sp[static_cast<long long>(c) * pn];
    sp[static_cast<long long>(c) * pn] = state;
    state = __fadd_rn(__fmul_rn(state, dp[c]), contrib);
  }
  final_state[bh * pn + e] = state;
}

// states: (bh, nc, pn), decay: (bh, nc), final_state: (bh, pn)
inline cudaError_t launch_chunk_walk(float* states, const float* decay,
                                     float* final_state, int nc, int pn,
                                     int bh, cudaStream_t stream) {
  chunk_walk<<<dim3((pn + WALK_THREADS - 1) / WALK_THREADS, bh),
               WALK_THREADS, 0, stream>>>(states, decay, final_state, nc, pn);
  return cudaGetLastError();
}

}  // namespace
