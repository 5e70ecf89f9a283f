// K1: the single edge pass of the hot path, hand-written for Hopper (sm_90a),
// and on the paths where the neuron update follows it, that update too.
//
// Replaces the Pallas TPU kernel src/repro/kernels/synaptic_gather.py::
// synaptic_gather (body _kernel). For every slot of the post-block ELL
// layout (NB blocks x EB slots, PB post rows per block) it computes the
// arrival ring[(t - delay) mod D, pre] (fresh[pre] instead where delay == 1
// and fresh is given; 0 on padding), writes it to `arrived`, and sums
// w * arrival per post row and channel. What it does with a row's two sums
// is its epilogue, a template parameter:
//   WriteSums  writes them to i_ex / i_in (synaptic_gather_launch: K1);
//   LifStep    adds the neuron's drive to the excitatory sum and takes the
//              neuron's LIF step, current or conductance by the runtime
//              cond flag (synaptic_gather_lif_launch: K1 + K2, also
//              replacing src/repro/kernels/lif_step.py::lif_step_kernel);
//   IzhikevichStep  the same with the Izhikevich step
//              (synaptic_gather_izhikevich_launch: K1 + K4, also replacing
//              src/repro/kernels/izhikevich_step.py::izhikevich_step_kernel);
//   AdexStep   the same with the AdEx step (synaptic_gather_adex_launch:
//              K1 + K5, also replacing src/repro/kernels/adex_step.py::
//              adex_step_kernel).
// The steps are neuron_math.cuh's, the very source of the standalone K2, K4
// and K5, so a fused step is bitwise equal to K1 -> add -> K2/K4/K5.
//
// What bounds it on the card: bytes. Each slot is touched once: pre, w and
// channel are read (12 B) and the arrival is written (4 B); the ring gather
// hits a (D, M) f32 array of under 1 MB that stays in L2. There is no reuse
// to exploit, so the kernel aims at streaming the slot arrays at full
// memory rate. A neuron epilogue adds the neuron's state (LIF: 41 B a
// neuron with the drive, Izhikevich and AdEx: 49 B, 45 B without it) and
// saves what K1 -> add -> K2/K4/K5 moves besides: the two sums written and
// read back (16 B a neuron), the drive's add (12 B) and two launches. At
// hpc_benchmark scale 1 that is under 0.5 MB against K1's 200 MB, and at a
// zoo network's 10 000 neurons 0.45 MB against K1's 162 MB, so the fused
// kernel's bound is K1's.
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
//
// Sum order, which every epilogue keeps: lanes stride the runs in delay
// order, the fixed shuffle tree reduces the 32 lane sums, and only then is
// the drive added (ex + drive, one rounding). K6 (blocked_reduce_sweep.cu)
// reproduces these sums bitwise, and the gated engine path, which runs K6
// and then the standalone K2, K4 or K5, must equal the fused one bitwise.
//
// A neuron epilogue belongs to the warp: after the shuffle tree lane 0
// holds the row's complete sums and is the only writer of the row, so no
// grid-wide dependency and no atomics come in. Then lane k loads the k-th
// 32-bit word of the neuron's state (v, u for Izhikevich or w_ad for AdEx,
// the synaptic state, ref_count, the group id, the drive), lane 0 gathers
// the words by shuffles, reads the group's table row (a few hundred bytes
// that stay in L1) and takes the step. The fused kernels are held to 6 CTAs
// of 256 threads an SM (__launch_bounds__), which K1's 40 registers allow;
// K1 alone keeps its own kernel without that bound. Tried on the card in one
// A/B call and not kept, each slower than this design: the state loaded
// before the edge loop, to be in flight while the warp streams its slots,
// by lane 0 (48 registers, 5 CTAs an SM) or spread over the lanes; lane 0
// loading it all after the loop under the same bound (it spilled); and
// K1 alone under the bound. Rows at or beyond n_local are the layout's
// padding rows and take no step; `arrived` and the padding-tail zeroing
// are the same for every epilogue.

#include <cuda_runtime.h>

#include "neuron_math.cuh"

namespace {

constexpr int kWarps = 8;  // post rows per CTA
// CTAs an SM must hold of a fused kernel: 6 x 256 threads at K1's 40
// registers (see the header)
constexpr int kNeuronMinBlocks = 6;

// K1 as such: lane 0 writes the row's sums to device memory.
struct WriteSums {
  float* i_ex;
  float* i_in;

  __device__ __forceinline__ void store(long long row, int lane, float ex,
                                        float in) const {
    if (lane != 0) return;
    i_ex[row] = ex;
    i_in[row] = in;
  }
};

// What both neuron epilogues take besides the model's own state.
struct NeuronIo {
  const float* drive;  // (n_local,) excitatory drive, or null: none
  const int* group_id;
  const float* table;
  int table_stride;
  int n_local;
  float* v_out;
  float* se_out;
  float* si_out;
  int* rc_out;
  bool* spike_out;

  // one 32-bit word of the neuron's state, a lane's share of the loads (0
  // past n_local or for a missing array)
  __device__ __forceinline__ unsigned word(const void* a,
                                           long long row) const {
    return a != nullptr && row < n_local
               ? static_cast<const unsigned*>(a)[row] : 0u;
  }
  // the excitatory input exactly as K1 -> add -> K2 forms it: the drive
  // is added to the finished sum, and not at all when there is none
  __device__ __forceinline__ float input_ex(float ex, float drv) const {
    return drive != nullptr ? ex + drv : ex;
  }
  __device__ __forceinline__ const float* row(unsigned gid) const {
    return table + static_cast<size_t>(static_cast<int>(gid)) * table_stride;
  }
};

// lane k's word, gathered by every lane of the warp
__device__ __forceinline__ unsigned word_of(unsigned held, int k) {
  return __shfl_sync(0xffffffffu, held, k);
}
__device__ __forceinline__ float f32_of(unsigned held, int k) {
  return __uint_as_float(word_of(held, k));
}

struct LifStep {
  const float* v;
  const float* syn_ex;
  const float* syn_in;
  const int* ref_count;
  int cond;
  NeuronIo io;

  __device__ __forceinline__ void store(long long row, int lane, float ex,
                                        float in) const {
    // lane k loads word k: v, syn_ex, syn_in, ref_count, group id, drive
    const void* a = lane == 0   ? static_cast<const void*>(v)
                    : lane == 1 ? static_cast<const void*>(syn_ex)
                    : lane == 2 ? static_cast<const void*>(syn_in)
                    : lane == 3 ? static_cast<const void*>(ref_count)
                    : lane == 4 ? static_cast<const void*>(io.group_id)
                    : lane == 5 ? static_cast<const void*>(io.drive)
                                : nullptr;
    const unsigned held = io.word(a, row);
    const neuron_math::LifState s{f32_of(held, 0), f32_of(held, 1),
                                  f32_of(held, 2),
                                  static_cast<int>(word_of(held, 3))};
    const unsigned gid = word_of(held, 4);
    const float drv = f32_of(held, 5);
    if (lane != 0 || row >= io.n_local) return;  // padding rows: no neuron
    const neuron_math::LifNext o = neuron_math::lif_update(
        s, io.input_ex(ex, drv), in, io.row(gid), cond);
    io.v_out[row] = o.v;
    io.se_out[row] = o.syn_ex;
    io.si_out[row] = o.syn_in;
    io.rc_out[row] = o.ref_count;
    io.spike_out[row] = o.spike;
  }
};

struct IzhikevichStep {
  const float* v;
  const float* u;
  const float* syn_ex;
  const float* syn_in;
  const int* ref_count;
  float* u_out;
  NeuronIo io;

  __device__ __forceinline__ void store(long long row, int lane, float ex,
                                        float in) const {
    // lane k loads word k: v, u, syn_ex, syn_in, ref_count, group id, drive
    const void* a = lane == 0   ? static_cast<const void*>(v)
                    : lane == 1 ? static_cast<const void*>(u)
                    : lane == 2 ? static_cast<const void*>(syn_ex)
                    : lane == 3 ? static_cast<const void*>(syn_in)
                    : lane == 4 ? static_cast<const void*>(ref_count)
                    : lane == 5 ? static_cast<const void*>(io.group_id)
                    : lane == 6 ? static_cast<const void*>(io.drive)
                                : nullptr;
    const unsigned held = io.word(a, row);
    const neuron_math::IzhikevichState s{f32_of(held, 0), f32_of(held, 1),
                                         f32_of(held, 2), f32_of(held, 3),
                                         static_cast<int>(word_of(held, 4))};
    const unsigned gid = word_of(held, 5);
    const float drv = f32_of(held, 6);
    if (lane != 0 || row >= io.n_local) return;  // padding rows: no neuron
    const neuron_math::IzhikevichNext o = neuron_math::izhikevich_update(
        s, io.input_ex(ex, drv), in, io.row(gid));
    io.v_out[row] = o.v;
    u_out[row] = o.u;
    io.se_out[row] = o.syn_ex;
    io.si_out[row] = o.syn_in;
    io.rc_out[row] = o.ref_count;
    io.spike_out[row] = o.spike;
  }
};

struct AdexStep {
  const float* v;
  const float* w_ad;
  const float* syn_ex;
  const float* syn_in;
  const int* ref_count;
  float* w_out;
  NeuronIo io;

  __device__ __forceinline__ void store(long long row, int lane, float ex,
                                        float in) const {
    // lane k loads word k: v, w_ad, syn_ex, syn_in, ref_count, group id,
    // drive
    const void* a = lane == 0   ? static_cast<const void*>(v)
                    : lane == 1 ? static_cast<const void*>(w_ad)
                    : lane == 2 ? static_cast<const void*>(syn_ex)
                    : lane == 3 ? static_cast<const void*>(syn_in)
                    : lane == 4 ? static_cast<const void*>(ref_count)
                    : lane == 5 ? static_cast<const void*>(io.group_id)
                    : lane == 6 ? static_cast<const void*>(io.drive)
                                : nullptr;
    const unsigned held = io.word(a, row);
    const neuron_math::AdexState s{f32_of(held, 0), f32_of(held, 1),
                                   f32_of(held, 2), f32_of(held, 3),
                                   static_cast<int>(word_of(held, 4))};
    const unsigned gid = word_of(held, 5);
    const float drv = f32_of(held, 6);
    if (lane != 0 || row >= io.n_local) return;  // padding rows: no neuron
    const neuron_math::AdexNext o = neuron_math::adex_update(
        s, io.input_ex(ex, drv), in, io.row(gid));
    io.v_out[row] = o.v;
    w_out[row] = o.w_ad;
    io.se_out[row] = o.syn_ex;
    io.si_out[row] = o.syn_in;
    io.rc_out[row] = o.ref_count;
    io.spike_out[row] = o.spike;
  }
};

// The edge pass of one post row per warp; then every lane enters the
// epilogue, lane 0 holding the row's sums.
template <class Epilogue>
__device__ __forceinline__ void gather_row(
    const int* __restrict__ pre, const float* __restrict__ w,
    const int* __restrict__ chan, const int* __restrict__ bounds,
    const float* __restrict__ ring, const int* __restrict__ t_ptr,
    const float* __restrict__ fresh, float* __restrict__ arrived, int nb,
    int eb, int pb, int d_max, int m, const Epilogue& epi) {
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
  epi.store(row_g, lane, ex, in);
  // padding tail of block b: no run covers it, its arrival is 0
  for (int s = bnd[d_max * pb] + r * 32 + lane; s < eb; s += pb * 32) {
    arrived[base + s] = 0.0f;
  }
}

#define GATHER_PARAMS                                                      \
  const int *__restrict__ pre, const float *__restrict__ w,                \
      const int *__restrict__ chan, const int *__restrict__ bounds,        \
      const float *__restrict__ ring, const int *__restrict__ t_ptr,       \
      const float *__restrict__ fresh, float *__restrict__ arrived, int nb, \
      int eb, int pb, int d_max, int m
#define GATHER_ARGS pre, w, chan, bounds, ring, t_ptr, fresh, arrived, nb, \
                    eb, pb, d_max, m

// K1.
__global__ void __launch_bounds__(kWarps * 32)
synaptic_gather_kernel(GATHER_PARAMS, const WriteSums epi) {
  gather_row(GATHER_ARGS, epi);
}

// K1 + the neuron step: held to the 6 CTAs an SM that K1's 40 registers
// allow (see the header).
template <class Epilogue>
__global__ void __launch_bounds__(kWarps * 32, kNeuronMinBlocks)
synaptic_gather_update_kernel(GATHER_PARAMS, const Epilogue epi) {
  gather_row(GATHER_ARGS, epi);
}

// K1's own arguments, shared by the four entry points.
struct Edges {
  const void* pre;
  const void* w;
  const void* chan;
  const void* bounds;
  const void* ring;
  const void* t;
  const void* fresh;
  void* arrived;
  int nb, eb, pb, d_max, m;
};

template <class Epilogue>
int launch(void (*kernel)(GATHER_PARAMS, const Epilogue), const Edges& g,
           const Epilogue& epi, void* stream) {
  const long long rows = static_cast<long long>(g.nb) * g.pb;
  const int grid = static_cast<int>((rows + kWarps - 1) / kWarps);
  kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(g.pre), static_cast<const float*>(g.w),
      static_cast<const int*>(g.chan), static_cast<const int*>(g.bounds),
      static_cast<const float*>(g.ring), static_cast<const int*>(g.t),
      static_cast<const float*>(g.fresh), static_cast<float*>(g.arrived),
      g.nb, g.eb, g.pb, g.d_max, g.m, epi);
  return static_cast<int>(cudaGetLastError());
}

NeuronIo neuron_io(const void* drive, const void* group_id,
                   const void* table, int table_stride, int n_local,
                   void* v_out, void* se_out, void* si_out, void* rc_out,
                   void* spike_out) {
  return {static_cast<const float*>(drive), static_cast<const int*>(group_id),
          static_cast<const float*>(table), table_stride, n_local,
          static_cast<float*>(v_out), static_cast<float*>(se_out),
          static_cast<float*>(si_out), static_cast<int*>(rc_out),
          static_cast<bool*>(spike_out)};
}

}  // namespace

extern "C" int synaptic_gather_launch(const void* pre, const void* w,
                                      const void* chan, const void* bounds,
                                      const void* ring, const void* t,
                                      const void* fresh, void* i_ex,
                                      void* i_in, void* arrived, int nb,
                                      int eb, int pb, int d_max, int m,
                                      void* stream) {
  return launch(synaptic_gather_kernel,
                Edges{pre, w, chan, bounds, ring, t, fresh, arrived, nb, eb,
                      pb, d_max, m},
                WriteSums{static_cast<float*>(i_ex), static_cast<float*>(i_in)},
                stream);
}

extern "C" int synaptic_gather_lif_launch(
    const void* pre, const void* w, const void* chan, const void* bounds,
    const void* ring, const void* t, const void* fresh, void* arrived, int nb,
    int eb, int pb, int d_max, int m, const void* drive, const void* v,
    const void* syn_ex, const void* syn_in, const void* ref_count,
    const void* group_id, const void* table, int table_stride, int n_local,
    int cond, void* v_out, void* se_out, void* si_out, void* rc_out,
    void* spike_out, void* stream) {
  const LifStep epi{static_cast<const float*>(v),
                    static_cast<const float*>(syn_ex),
                    static_cast<const float*>(syn_in),
                    static_cast<const int*>(ref_count), cond,
                    neuron_io(drive, group_id, table, table_stride, n_local,
                              v_out, se_out, si_out, rc_out, spike_out)};
  return launch(synaptic_gather_update_kernel<LifStep>,
                Edges{pre, w, chan, bounds, ring, t, fresh, arrived, nb, eb,
                      pb, d_max, m},
                epi, stream);
}

extern "C" int synaptic_gather_adex_launch(
    const void* pre, const void* w, const void* chan, const void* bounds,
    const void* ring, const void* t, const void* fresh, void* arrived, int nb,
    int eb, int pb, int d_max, int m, const void* drive, const void* v,
    const void* w_ad, const void* syn_ex, const void* syn_in,
    const void* ref_count, const void* group_id, const void* table,
    int table_stride, int n_local, void* v_out, void* w_out, void* se_out,
    void* si_out, void* rc_out, void* spike_out, void* stream) {
  const AdexStep epi{static_cast<const float*>(v),
                     static_cast<const float*>(w_ad),
                     static_cast<const float*>(syn_ex),
                     static_cast<const float*>(syn_in),
                     static_cast<const int*>(ref_count),
                     static_cast<float*>(w_out),
                     neuron_io(drive, group_id, table, table_stride, n_local,
                               v_out, se_out, si_out, rc_out, spike_out)};
  return launch(synaptic_gather_update_kernel<AdexStep>,
                Edges{pre, w, chan, bounds, ring, t, fresh, arrived, nb, eb,
                      pb, d_max, m},
                epi, stream);
}

extern "C" int synaptic_gather_izhikevich_launch(
    const void* pre, const void* w, const void* chan, const void* bounds,
    const void* ring, const void* t, const void* fresh, void* arrived, int nb,
    int eb, int pb, int d_max, int m, const void* drive, const void* v,
    const void* u, const void* syn_ex, const void* syn_in,
    const void* ref_count, const void* group_id, const void* table,
    int table_stride, int n_local, void* v_out, void* u_out, void* se_out,
    void* si_out, void* rc_out, void* spike_out, void* stream) {
  const IzhikevichStep epi{static_cast<const float*>(v),
                           static_cast<const float*>(u),
                           static_cast<const float*>(syn_ex),
                           static_cast<const float*>(syn_in),
                           static_cast<const int*>(ref_count),
                           static_cast<float*>(u_out),
                           neuron_io(drive, group_id, table, table_stride,
                                     n_local, v_out, se_out, si_out, rc_out,
                                     spike_out)};
  return launch(synaptic_gather_update_kernel<IzhikevichStep>,
                Edges{pre, w, chan, bounds, ring, t, fresh, arrived, nb, eb,
                      pb, d_max, m},
                epi, stream);
}
