// K5: fused AdEx (adaptive exponential IF, NEST aeif_psc_exp) neuron
// update, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/adex_step.py::
// adex_step_kernel. Per neuron: gather the group's row of the (G, 14)
// parameter table, decay the synaptic state and add this step's input,
// take one forward-Euler step of
//   v' = v + dt/C (-g_L (v - E_L) + g_L D_T exp(min((v - V_T)/D_T, 10))
//                  + se + si + I_e - w)
//   w' = w + dt/tau_w (a (v - E_L) - w)
// clamp refractory neurons to v_reset, threshold at v_peak, reset
// (v <- v_reset, w <- w + b) and count the refractory period down.
//
// What bounds it on the card: bytes, and at a zoo network's 10 000 neurons
// launch latency. Per neuron it reads 8 values (32 B) and writes 6 (21 B);
// the table stays in L1 (read through __ldg).
//
// Design. One thread per neuron, the ragged tail masked in the kernel. The
// arithmetic follows the reference's adex_math op for op. expf (not
// __expf) and IEEE division, as the library is built without fast math;
// --fmad=false keeps every multiply and add rounded on its own. The clamp
// is written so that a NaN argument stays NaN, as jnp.minimum and
// torch.clamp leave it (fminf would return the bound). The per-neuron body
// is neuron_math.cuh's adex_update, which K1's AdEx epilogue
// (synaptic_gather.cu) inlines too: on the paths where K1 precedes the
// update, that epilogue takes the step and this kernel is not launched.

#include <cuda_runtime.h>

#include "neuron_math.cuh"

namespace {

__global__ void adex_step_kernel(const float* __restrict__ v,
                                 const float* __restrict__ w_ad,
                                 const float* __restrict__ syn_ex,
                                 const float* __restrict__ syn_in,
                                 const int* __restrict__ ref_count,
                                 const int* __restrict__ group_id,
                                 const float* __restrict__ input_ex,
                                 const float* __restrict__ input_in,
                                 const float* __restrict__ table,
                                 int table_stride, int n,
                                 float* __restrict__ v_out,
                                 float* __restrict__ w_out,
                                 float* __restrict__ se_out,
                                 float* __restrict__ si_out,
                                 int* __restrict__ rc_out,
                                 bool* __restrict__ spike_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* tb = table + static_cast<size_t>(group_id[i]) * table_stride;
  const neuron_math::AdexNext o = neuron_math::adex_update(
      {v[i], w_ad[i], syn_ex[i], syn_in[i], ref_count[i]}, input_ex[i],
      input_in[i], tb);
  v_out[i] = o.v;
  w_out[i] = o.w_ad;
  se_out[i] = o.syn_ex;
  si_out[i] = o.syn_in;
  rc_out[i] = o.ref_count;
  spike_out[i] = o.spike;
}

}  // namespace

extern "C" int adex_step_launch(
    const void* v, const void* w_ad, const void* syn_ex, const void* syn_in,
    const void* ref_count, const void* group_id, const void* input_ex,
    const void* input_in, const void* table, int table_stride, int n,
    void* v_out, void* w_out, void* se_out, void* si_out, void* rc_out,
    void* spike_out, void* stream) {
  constexpr int kThreads = 256;
  adex_step_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(w_ad),
      static_cast<const float*>(syn_ex), static_cast<const float*>(syn_in),
      static_cast<const int*>(ref_count), static_cast<const int*>(group_id),
      static_cast<const float*>(input_ex), static_cast<const float*>(input_in),
      static_cast<const float*>(table), table_stride, n,
      static_cast<float*>(v_out), static_cast<float*>(w_out),
      static_cast<float*>(se_out), static_cast<float*>(si_out),
      static_cast<int*>(rc_out), static_cast<bool*>(spike_out));
  return static_cast<int>(cudaGetLastError());
}
