// K7: the pl-STDP update over a worklist of post blocks, in place,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stdp_update.py::
// stdp_update_worklist (body _wl_kernel): K3's update on the post-block ELL
// layout, for the slots of the listed blocks only. Per plastic slot:
//   w1 = w - arrived * (lam*alpha) * w * K_post[post]
//   w2 = clip(w1 + post_spike[post] * c_pot * exp(mu * log(max(w1, 1e-12)))
//             * K_pre[pre], w_min, w_max),   c_pot = lam * w0^(1-mu)
// with post = block * pb + post_rel; non-plastic slots are not written.
//
// In place. The weights of blocks off the list keep their values, so the
// kernel writes the listed blocks' plastic slots into the resident weight
// array itself: an out-of-place result would need the other blocks copied,
// a full edge pass that the gate exists to skip.
//
// The list. `worklist` (cap entries, entries >= NB are padding) and
// `n_active` (one int32 on the device) come from the gate. The kernel
// decides the branch itself: when n_active <= cap it walks
// worklist[0 .. n_active), and when n_active > cap (the gate saturated) it
// walks the identity list 0 .. NB-1, the dense update. Entries outside
// [0, NB) are skipped, never read through; the resident arrays are indexed
// in place through the list, without compacted copies.
//
// What bounds it on the card: bytes. Per listed slot the plastic flag
// (1 B); per listed plastic slot w, pre, post_rel and arrived (16 B) read
// and w (4 B) written. The trace and spike vectors stay in L2.
//
// Design. Grid (X, NB): row y of the grid serves list entry y, and its X
// CTAs stride that block's EB slots, consecutive threads on consecutive
// slots. Rows past the list's length return at once, so an empty list
// costs one launch. The arithmetic is K3's (csrc/stdp_update.cu) op for
// op - expf/logf, the same association, --fmad=false - so a listed block's
// weights equal K3's bitwise. Each slot is written by its own thread: no
// atomics, deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerBlock = 64;  // X: CTAs striding one post block

__global__ void __launch_bounds__(kThreads)
stdp_update_worklist_kernel(float* w, const int* __restrict__ pre,
                            const int* __restrict__ post,
                            const bool* __restrict__ plastic,
                            const float* __restrict__ arrived,
                            const float* __restrict__ post_spike,
                            const float* __restrict__ k_pre,
                            const float* __restrict__ k_post,
                            const int* __restrict__ worklist,
                            const int* __restrict__ n_active_ptr, int nb,
                            int eb, int pb, int cap, float c_dep, float c_pot,
                            float mu, float w_min, float w_max) {
  const int g = blockIdx.y;
  const int n_active = *n_active_ptr;
  const bool identity = n_active > cap;
  if (g >= (identity ? nb : n_active)) return;
  const int b = identity ? g : worklist[g];
  if (b < 0 || b >= nb) return;
  const size_t base = static_cast<size_t>(b) * eb;
  const int row0 = b * pb;
  for (int s = blockIdx.x * kThreads + threadIdx.x; s < eb;
       s += gridDim.x * kThreads) {
    const size_t e = base + s;
    if (!plastic[e]) continue;
    const float wi = w[e];
    const int p = post[e] + row0;
    const float w1 = wi - arrived[e] * c_dep * wi * k_post[p];
    // comparisons written so that a NaN propagates, as jnp.maximum/clip do
    const float w_safe = w1 < 1e-12f ? 1e-12f : w1;
    const float pot = c_pot * expf(mu * logf(w_safe)) * k_pre[pre[e]];
    float w2 = w1 + post_spike[p] * pot;
    w2 = w2 < w_min ? w_min : w2;
    w2 = w2 > w_max ? w_max : w2;
    w[e] = w2;
  }
}

}  // namespace

extern "C" int stdp_update_worklist_launch(
    void* w, const void* pre, const void* post, const void* plastic,
    const void* arrived, const void* post_spike, const void* k_pre,
    const void* k_post, const void* worklist, const void* n_active, int nb,
    int eb, int pb, int cap, float c_dep, float c_pot, float mu, float w_min,
    float w_max, void* stream) {
  // sized for the identity list: the kernel learns the list's length on
  // the device, and grid rows past it return at once
  const int x_need = (eb + kThreads - 1) / kThreads;
  const dim3 grid(x_need < kCtasPerBlock ? x_need : kCtasPerBlock, nb);
  stdp_update_worklist_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(w), static_cast<const int*>(pre),
      static_cast<const int*>(post), static_cast<const bool*>(plastic),
      static_cast<const float*>(arrived),
      static_cast<const float*>(post_spike), static_cast<const float*>(k_pre),
      static_cast<const float*>(k_post), static_cast<const int*>(worklist),
      static_cast<const int*>(n_active), nb, eb, pb, cap, c_dep, c_pot, mu,
      w_min, w_max);
  return static_cast<int>(cudaGetLastError());
}
