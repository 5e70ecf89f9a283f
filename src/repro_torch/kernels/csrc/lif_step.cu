// K2: fused LIF neuron update, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/lif_step.py::
// lif_step_kernel. Per neuron: gather the group's row of the (G, 12)
// propagator table, decay the synaptic state and add this step's input,
// propagate the membrane (exact integration, or the conductance form when
// cond != 0), clamp refractory neurons to v_reset, threshold, reset and
// count the refractory period down.
//
// What bounds it on the card: bytes, and at the main path's size launch
// latency. Per neuron it reads 7 values (28 B) and writes 5 (17 B); the
// table is a few hundred bytes and stays in L1. 11 256 neurons move about
// half a megabyte, well under a microsecond of memory time.
//
// Design. One thread per neuron, no shared memory: the TPU's (1, 128) lane
// blocks have no counterpart to keep. The arithmetic follows the Pallas
// kernel's op order exactly (v*p_vv + syn_ex*p_ve + syn_in*p_vi + p_vconst,
// left to right), and the library is compiled with --fmad=false so that no
// multiply-add is contracted: a contracted FMA rounds once instead of twice
// and can move v across v_th, flipping a spike against the reference. The
// per-neuron body is neuron_math.cuh's lif_update, which K1's LIF epilogue
// (synaptic_gather.cu) inlines too: on the paths where K1 precedes the
// update, that epilogue takes the step and this kernel is not launched.

#include <cuda_runtime.h>

#include "neuron_math.cuh"

namespace {

__global__ void lif_step_kernel(const float* __restrict__ v,
                                const float* __restrict__ syn_ex,
                                const float* __restrict__ syn_in,
                                const int* __restrict__ ref_count,
                                const int* __restrict__ group_id,
                                const float* __restrict__ input_ex,
                                const float* __restrict__ input_in,
                                const float* __restrict__ table,
                                int table_stride, int n, int cond,
                                float* __restrict__ v_out,
                                float* __restrict__ se_out,
                                float* __restrict__ si_out,
                                int* __restrict__ rc_out,
                                bool* __restrict__ spike_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* tb = table + static_cast<size_t>(group_id[i]) * table_stride;
  const neuron_math::LifNext o = neuron_math::lif_update(
      {v[i], syn_ex[i], syn_in[i], ref_count[i]}, input_ex[i], input_in[i],
      tb, cond);
  v_out[i] = o.v;
  se_out[i] = o.syn_ex;
  si_out[i] = o.syn_in;
  rc_out[i] = o.ref_count;
  spike_out[i] = o.spike;
}

}  // namespace

extern "C" int lif_step_launch(const void* v, const void* syn_ex,
                               const void* syn_in, const void* ref_count,
                               const void* group_id, const void* input_ex,
                               const void* input_in, const void* table,
                               int table_stride, int n, int cond,
                               void* v_out, void* se_out, void* si_out,
                               void* rc_out, void* spike_out,
                               void* stream) {
  constexpr int kThreads = 256;
  lif_step_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(syn_ex),
      static_cast<const float*>(syn_in), static_cast<const int*>(ref_count),
      static_cast<const int*>(group_id), static_cast<const float*>(input_ex),
      static_cast<const float*>(input_in), static_cast<const float*>(table),
      table_stride, n, cond, static_cast<float*>(v_out),
      static_cast<float*>(se_out), static_cast<float*>(si_out),
      static_cast<int*>(rc_out), static_cast<bool*>(spike_out));
  return static_cast<int>(cudaGetLastError());
}
