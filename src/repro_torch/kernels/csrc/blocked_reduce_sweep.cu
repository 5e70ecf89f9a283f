// K6: the reduction half of the edge pass over a worklist of post blocks,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/synaptic_gather.py::
// blocked_reduce_sweep (body _reduce_kernel). The activity gate's pre-pass
// has already gathered every slot's arrival into the resident (NB, EB)
// `arrived` array; for each post block on the list this kernel sums
// w * arrived per post row and channel into i_ex / i_in. Rows of blocks
// not on the list are left as the caller initialised them (zeros).
//
// The list. `worklist` (cap entries, ascending block ids, entries >= NB
// are padding) and `n_active` (one int32 on the device) come from the
// gate. The kernel decides the branch itself, so the host never reads a
// device value: when n_active <= cap it walks worklist[0 .. n_active), and
// when n_active > cap (the gate saturated) it walks the identity list
// 0 .. NB-1, the dense pass. A null worklist means the identity list
// (the full-capacity gate). Entries outside [0, NB) are skipped, never
// read through. The resident arrays are indexed in place through the list:
// no compacted copies, which would cost an edge pass.
//
// What bounds it on the card: bytes. A listed block's live slots are read
// once - w, channel and arrived, 12 B a slot - plus the block's run table;
// the outputs are 8 B a row.
//
// Design and sum order. K1's exactly (csrc/synaptic_gather.cu): one warp
// per post row, the row's per-delay runs from the (delay, post) table of
// segment_bounds, lanes striding each run, the same shuffle tree. Only the
// arrival's source differs (the pre-pass's array instead of the ring), so
// on the same arrivals every row sum equals K1's bitwise, and the gated
// backend equals the dense one bitwise. No atomics: deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // post rows per CTA

__global__ void __launch_bounds__(kWarps * 32)
blocked_reduce_sweep_kernel(const float* __restrict__ w,
                            const float* __restrict__ arrived,
                            const int* __restrict__ chan,
                            const int* __restrict__ bounds,
                            const int* __restrict__ worklist,
                            const int* __restrict__ n_active_ptr,
                            float* __restrict__ i_ex,
                            float* __restrict__ i_in, int nb, int eb, int pb,
                            int d_max, int cap) {
  const int lane = threadIdx.x & 31;
  const long long v =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  bool identity = worklist == nullptr;
  int n_list = nb;
  if (!identity) {
    const int n_active = *n_active_ptr;
    identity = n_active > cap;
    if (!identity) n_list = n_active;
  }
  if (v >= static_cast<long long>(n_list) * pb) return;  // whole warp
  const int g = static_cast<int>(v / pb);
  const int r = static_cast<int>(v % pb);
  const int b = identity ? g : worklist[g];
  if (b < 0 || b >= nb) return;  // padding entry: whole warp
  const size_t base = static_cast<size_t>(b) * eb;
  const int* bnd = bounds + static_cast<size_t>(b) * (d_max * pb + 1);

  float ex = 0.0f, in = 0.0f;
  for (int d = 1; d <= d_max; ++d) {
    const int k = (d - 1) * pb + r;
    const int lo = bnd[k], hi = bnd[k + 1];
    for (int s = lo + lane; s < hi; s += 32) {
      const size_t e = base + s;
      const float c = w[e] * arrived[e];
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
    const size_t row = static_cast<size_t>(b) * pb + r;
    i_ex[row] = ex;
    i_in[row] = in;
  }
}

}  // namespace

extern "C" int blocked_reduce_sweep_launch(
    const void* w, const void* arrived, const void* chan, const void* bounds,
    const void* worklist, const void* n_active, void* i_ex, void* i_in,
    int nb, int eb, int pb, int d_max, int cap, void* stream) {
  // sized for the identity list: the kernel learns the list's length on
  // the device, and warps past it return at once
  const long long rows = static_cast<long long>(nb) * pb;
  const int grid = static_cast<int>((rows + kWarps - 1) / kWarps);
  blocked_reduce_sweep_kernel<<<grid, kWarps * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(arrived),
      static_cast<const int*>(chan), static_cast<const int*>(bounds),
      static_cast<const int*>(worklist), static_cast<const int*>(n_active),
      static_cast<float*>(i_ex), static_cast<float*>(i_in), nb, eb, pb,
      d_max, cap);
  return static_cast<int>(cudaGetLastError());
}
