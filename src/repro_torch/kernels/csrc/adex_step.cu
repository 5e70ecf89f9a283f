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
// torch.clamp leave it (fminf would return the bound).

#include <cuda_runtime.h>

namespace {

// column order of repro_torch.kernels.adex_step._COLS (the wrapper checks
// NCOL == 14); rows lie table_stride >= kNcol floats apart, so that a
// composite model's table, which carries one more column, is read in place
enum Col {
  kPee = 0, kPii, kDtCm, kGl, kEl, kVt, kDeltaT, kVpeak, kVreset, kDtTw, kA,
  kB, kRefSteps, kIe, kNcol
};

constexpr float kExpClamp = 10.0f;  // repro_torch.kernels.adex_step.EXP_CLAMP

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
  const float vm = v[i], wm = w_ad[i], se = syn_ex[i], si = syn_in[i];
  const int rc = ref_count[i];

  se_out[i] = se * __ldg(tb + kPee) + input_ex[i];
  si_out[i] = si * __ldg(tb + kPii) + input_in[i];
  const float g_l = __ldg(tb + kGl), e_l = __ldg(tb + kEl);
  const float delta_t = __ldg(tb + kDeltaT);
  float exp_arg = (vm - __ldg(tb + kVt)) / delta_t;
  exp_arg = exp_arg > kExpClamp ? kExpClamp : exp_arg;
  const float i_exp = g_l * delta_t * expf(exp_arg);
  const float dv = -g_l * (vm - e_l) + i_exp + se + si + __ldg(tb + kIe) - wm;
  const float v_prop = vm + __ldg(tb + kDtCm) * dv;
  const float w_prop =
      wm + __ldg(tb + kDtTw) * (__ldg(tb + kA) * (vm - e_l) - wm);

  const bool refractory = rc > 0;
  const float v_reset = __ldg(tb + kVreset);
  float v_new = refractory ? v_reset : v_prop;
  const bool spike = !refractory && v_new >= __ldg(tb + kVpeak);
  if (spike) v_new = v_reset;
  v_out[i] = v_new;
  w_out[i] = spike ? w_prop + __ldg(tb + kB) : w_prop;
  // ref_steps is a float column; the cast truncates, as astype(int32) does
  rc_out[i] = spike ? static_cast<int>(__ldg(tb + kRefSteps)) : max(rc - 1, 0);
  spike_out[i] = spike;
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
