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
// rounds once where the plain twin rounds twice.

#include <cuda_runtime.h>

namespace {

// column order of repro_torch.kernels.izhikevich_step._COLS (the wrapper
// checks NCOL == 11); rows lie table_stride >= kNcol floats apart, so that
// a composite model's table, which carries one more column, is read in
// place
enum Col {
  kPee = 0, kPii, kDt, kA, kB, kC, kD, kVpeak, kRefSteps, kIe, kIscale,
  kNcol
};

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
  const float vm = v[i], um = u[i], se = syn_ex[i], si = syn_in[i];
  const int rc = ref_count[i];
  const float dt = __ldg(tb + kDt);

  se_out[i] = se * __ldg(tb + kPee) + input_ex[i];
  si_out[i] = si * __ldg(tb + kPii) + input_in[i];
  const float i_in = __ldg(tb + kIscale) * (se + si) + __ldg(tb + kIe);
  const float v_prop =
      vm + dt * (0.04f * vm * vm + 5.0f * vm + 140.0f - um + i_in);
  const float u_prop = um + dt * __ldg(tb + kA) * (__ldg(tb + kB) * vm - um);

  const bool refractory = rc > 0;
  const float c = __ldg(tb + kC);
  float v_new = refractory ? c : v_prop;
  const bool spike = !refractory && v_new >= __ldg(tb + kVpeak);
  if (spike) v_new = c;
  v_out[i] = v_new;
  u_out[i] = spike ? u_prop + __ldg(tb + kD) : u_prop;
  // ref_steps is a float column; the cast truncates, as astype(int32) does
  rc_out[i] = spike ? static_cast<int>(__ldg(tb + kRefSteps)) : max(rc - 1, 0);
  spike_out[i] = spike;
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
