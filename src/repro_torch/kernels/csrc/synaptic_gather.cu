// K1: the single edge pass of the hot path, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/synaptic_gather.py::
// synaptic_gather (body _kernel). For every slot of the post-block ELL
// layout (NB blocks x EB slots, PB post rows per block) it computes the
// arrival ring[(t - delay) mod D, pre] (fresh[pre] instead where delay == 1
// and fresh is given; 0 on padding), writes it to `arrived`, and sums
// w * arrival per post row and channel into i_ex / i_in.
//
// What bounds it on the card: bytes. Each slot is touched once: pre, w and
// channel are read (12 B) and the arrival is written (4 B); the ring gather
// hits a (D, M) f32 array of under 1 MB that stays in L2. There is no reuse
// to exploit, so the kernel aims at streaming the slot arrays at full
// memory rate.
//
// Design. The TPU grid (one cell per post block holding the whole ring in
// VMEM, a one-hot MXU matmul for the row sums) does not carry over: at
// hpc_benchmark scale 1 it would be 44 blocks for 132 SMs. Instead one warp
// owns one post row. The layout sorts each block's slots by (delay, post),
// so a row's slots form at most D contiguous runs, one per delay; their
// bounds come from a table built once at prepare time
// (bounds[b, (d-1)*PB + r] .. bounds[b, (d-1)*PB + r + 1]), which also
// makes per-slot delay and post reads unnecessary. Lanes stride a run with
// coalesced loads, and the row's sums are reduced by a fixed shuffle tree.
// Each row is written by exactly one warp (paper eq. 14): no atomics, and
// two launches on the same inputs give bitwise-equal outputs. The padding
// tail of each block (slots past its last run) is zeroed by the block's
// row warps.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // post rows per CTA

__global__ void __launch_bounds__(kWarps * 32)
synaptic_gather_kernel(const int* __restrict__ pre, const float* __restrict__ w,
                       const int* __restrict__ chan,
                       const int* __restrict__ bounds,
                       const float* __restrict__ ring,
                       const int* __restrict__ t_ptr,
                       const float* __restrict__ fresh,
                       float* __restrict__ i_ex, float* __restrict__ i_in,
                       float* __restrict__ arrived, int nb, int eb, int pb,
                       int d_max, int m) {
  const int lane = threadIdx.x & 31;
  const long long row_g =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row_g >= static_cast<long long>(nb) * pb) return;  // whole warp
  const int b = static_cast<int>(row_g / pb);
  const int r = static_cast<int>(row_g % pb);
  const int t = *t_ptr;
  const size_t base = static_cast<size_t>(b) * eb;
  const int* bnd = bounds + static_cast<size_t>(b) * (d_max * pb + 1);

  float ex = 0.0f, in = 0.0f;
  for (int d = 1; d <= d_max; ++d) {
    const int k = (d - 1) * pb + r;
    const int lo = bnd[k], hi = bnd[k + 1];
    if (lo >= hi) continue;
    int slot = (t - d) % d_max;  // C's % truncates: make it floor-mod
    if (slot < 0) slot += d_max;
    const float* src = (fresh != nullptr && d == 1)
                           ? fresh
                           : ring + static_cast<size_t>(slot) * m;
    for (int s = lo + lane; s < hi; s += 32) {
      const size_t e = base + s;
      const float a = src[pre[e]];
      arrived[e] = a;
      const float c = w[e] * a;
      const int ch = chan[e];
      if (ch == 0) {
        ex += c;
      } else if (ch == 1) {
        in += c;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    ex += __shfl_down_sync(0xffffffffu, ex, off);
    in += __shfl_down_sync(0xffffffffu, in, off);
  }
  if (lane == 0) {
    i_ex[row_g] = ex;
    i_in[row_g] = in;
  }
  // padding tail of block b: no run covers it, its arrival is 0
  for (int s = bnd[d_max * pb] + r * 32 + lane; s < eb; s += pb * 32) {
    arrived[base + s] = 0.0f;
  }
}

}  // namespace

extern "C" int synaptic_gather_launch(const void* pre, const void* w,
                                      const void* chan, const void* bounds,
                                      const void* ring, const void* t,
                                      const void* fresh, void* i_ex,
                                      void* i_in, void* arrived, int nb,
                                      int eb, int pb, int d_max, int m,
                                      void* stream) {
  const long long rows = static_cast<long long>(nb) * pb;
  const int grid = static_cast<int>((rows + kWarps - 1) / kWarps);
  synaptic_gather_kernel<<<grid, kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pre), static_cast<const float*>(w),
      static_cast<const int*>(chan), static_cast<const int*>(bounds),
      static_cast<const float*>(ring), static_cast<const int*>(t),
      static_cast<const float*>(fresh), static_cast<float*>(i_ex),
      static_cast<float*>(i_in), static_cast<float*>(arrived), nb, eb, pb,
      d_max, m);
  return static_cast<int>(cudaGetLastError());
}
