// K3: pl-STDP weight update per synapse slot, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stdp_update.py::
// stdp_update_kernel. Per plastic slot:
//   w1 = w - arrived * (lam*alpha) * w * K_post[post]
//   w2 = clip(w1 + post_spike[post] * c_pot * exp(mu * log(max(w1, 1e-12)))
//             * K_pre[pre], w_min, w_max),   c_pot = lam * w0^(1-mu)
// non-plastic slots pass through. Two layouts: flat owner-sorted (pb == 0,
// post is absolute) and the post-block ELL layout (pb > 0, post is
// block-relative and the owning block is slot / eb).
//
// What bounds it on the card: bytes. Per slot it reads w, pre, post,
// arrived (16 B) and the plastic flag (1 B) and writes w (4 B); the trace
// and spike vectors (under 100 KB at the main path's size) stay in L2. The
// exp/log pair is a few dozen operations per slot, far below the bytes'
// time.
//
// Design. One thread per slot, consecutive threads on consecutive slots so
// every array streams coalesced; no shared memory. Non-plastic slots skip
// the gathers and the transcendentals. expf/logf (not the __expf fast
// intrinsics, no -use_fast_math) and --fmad=false keep the arithmetic to
// the Pallas kernel's op order; c_pot is computed in double by the wrapper,
// as the Pallas kernel's Python floats are. Each slot is written by its own
// thread: no atomics, deterministic.

#include <cuda_runtime.h>

namespace {

__global__ void stdp_update_kernel(const float* __restrict__ w,
                                   const int* __restrict__ pre,
                                   const int* __restrict__ post,
                                   const bool* __restrict__ plastic,
                                   const float* __restrict__ arrived,
                                   const float* __restrict__ post_spike,
                                   const float* __restrict__ k_pre,
                                   const float* __restrict__ k_post,
                                   float* __restrict__ w_out,
                                   long long n_slots, int eb, int pb,
                                   float c_dep, float c_pot, float mu,
                                   float w_min, float w_max) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_slots) return;
  const float wi = w[e];
  if (!plastic[e]) {
    w_out[e] = wi;
    return;
  }
  int p = post[e];
  if (pb > 0) p += static_cast<int>(e / eb) * pb;
  const float w1 = wi - arrived[e] * c_dep * wi * k_post[p];
  // comparisons written so that a NaN propagates, as jnp.maximum/clip do
  const float w_safe = w1 < 1e-12f ? 1e-12f : w1;
  const float pot = c_pot * expf(mu * logf(w_safe)) * k_pre[pre[e]];
  float w2 = w1 + post_spike[p] * pot;
  w2 = w2 < w_min ? w_min : w2;
  w2 = w2 > w_max ? w_max : w2;
  w_out[e] = w2;
}

}  // namespace

extern "C" int stdp_update_launch(const void* w, const void* pre,
                                  const void* post, const void* plastic,
                                  const void* arrived, const void* post_spike,
                                  const void* k_pre, const void* k_post,
                                  void* w_out, long long n_slots, int eb,
                                  int pb, float c_dep, float c_pot, float mu,
                                  float w_min, float w_max, void* stream) {
  constexpr int kThreads = 256;
  const long long grid = (n_slots + kThreads - 1) / kThreads;
  stdp_update_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const int*>(pre),
      static_cast<const int*>(post), static_cast<const bool*>(plastic),
      static_cast<const float*>(arrived),
      static_cast<const float*>(post_spike), static_cast<const float*>(k_pre),
      static_cast<const float*>(k_post), static_cast<float*>(w_out), n_slots,
      eb, pb, c_dep, c_pot, mu, w_min, w_max);
  return static_cast<int>(cudaGetLastError());
}
