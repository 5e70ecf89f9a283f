// K4: fused Izhikevich (2003) neuron update, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/izhikevich_step.py::
// izhikevich_step_kernel. Per neuron: gather the group's row of the (G, 11)
// parameter table, decay the synaptic state and add this step's input,
// take one forward-Euler step of
//   v' = v + dt (0.04 v^2 + 5 v + 140 - u + I),  I = i_scale (se + si) + i_e
//   u' = u + dt a (b v - u)
// with the previous step's synaptic state in I, clamp refractory neurons to
// c, threshold at v_peak, reset (v <- c, u <- u + d) and count the
// refractory period down.
//
// What bounds it on the card: bytes, and at a zoo network's 10 000 neurons
// launch latency. Per neuron it reads 8 values (32 B) and writes 6 (21 B);
// the table is a few hundred bytes and stays in L1 (read through __ldg).
//
// Design. One thread per neuron, the ragged tail masked in the kernel: the
// TPU's (1, nb) lane blocks, and the padding to a multiple of nb they need,
// have no counterpart to keep. The arithmetic follows the reference's
// izhikevich_math op for op, left to right, and the library is compiled
// with --fmad=false: the quadratic amplifies an ulp, and a contracted FMA
// rounds once where the plain twin rounds twice. The per-neuron body is
// neuron_math.cuh's izhikevich_update, which K1's Izhikevich epilogue
// (synaptic_gather.cu) inlines too: on the paths where K1 precedes the
// update, that epilogue takes the step and this kernel is not launched.

#include <cuda_runtime.h>

#include "neuron_math.cuh"

namespace {

__global__ void izhikevich_step_kernel(const float* __restrict__ v,
                                       const float* __restrict__ u,
                                       const float* __restrict__ syn_ex,
                                       const float* __restrict__ syn_in,
                                       const int* __restrict__ ref_count,
                                       const int* __restrict__ group_id,
                                       const float* __restrict__ input_ex,
                                       const float* __restrict__ input_in,
                                       const float* __restrict__ table,
                                       int table_stride, int n,
                                       float* __restrict__ v_out,
                                       float* __restrict__ u_out,
                                       float* __restrict__ se_out,
                                       float* __restrict__ si_out,
                                       int* __restrict__ rc_out,
                                       bool* __restrict__ spike_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* tb = table + static_cast<size_t>(group_id[i]) * table_stride;
  const neuron_math::IzhikevichNext o = neuron_math::izhikevich_update(
      {v[i], u[i], syn_ex[i], syn_in[i], ref_count[i]}, input_ex[i],
      input_in[i], tb);
  v_out[i] = o.v;
  u_out[i] = o.u;
  se_out[i] = o.syn_ex;
  si_out[i] = o.syn_in;
  rc_out[i] = o.ref_count;
  spike_out[i] = o.spike;
}

}  // namespace

extern "C" int izhikevich_step_launch(
    const void* v, const void* u, const void* syn_ex, const void* syn_in,
    const void* ref_count, const void* group_id, const void* input_ex,
    const void* input_in, const void* table, int table_stride, int n,
    void* v_out, void* u_out, void* se_out, void* si_out, void* rc_out,
    void* spike_out, void* stream) {
  constexpr int kThreads = 256;
  izhikevich_step_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(u),
      static_cast<const float*>(syn_ex), static_cast<const float*>(syn_in),
      static_cast<const int*>(ref_count), static_cast<const int*>(group_id),
      static_cast<const float*>(input_ex), static_cast<const float*>(input_in),
      static_cast<const float*>(table), table_stride, n,
      static_cast<float*>(v_out), static_cast<float*>(u_out),
      static_cast<float*>(se_out), static_cast<float*>(si_out),
      static_cast<int*>(rc_out), static_cast<bool*>(spike_out));
  return static_cast<int>(cudaGetLastError());
}
