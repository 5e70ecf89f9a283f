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
// and can move v across v_th, flipping a spike against the reference.

#include <cuda_runtime.h>

namespace {

// column order of repro_torch.core.snn._COLS (the wrapper checks NCOL == 12);
// rows lie table_stride >= kNcol floats apart, so that a composite model's
// table, which carries one more column, is read in place
enum Col {
  kPvv = 0, kPee, kPii, kPve, kPvi, kPvconst, kVth, kVreset, kRefSteps,
  kEex, kEin, kInvCmDt, kNcol
};

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
  const float vm = v[i], se = syn_ex[i], si = syn_in[i];
  const int rc = ref_count[i];

  se_out[i] = se * tb[kPee] + input_ex[i];
  si_out[i] = si * tb[kPii] + input_in[i];

  float v_prop;
  if (cond) {
    const float i_cond = se * (tb[kEex] - vm) - si * (vm - tb[kEin]);
    v_prop = vm * tb[kPvv] + tb[kPvconst] + i_cond * tb[kInvCmDt];
  } else {
    v_prop = vm * tb[kPvv] + se * tb[kPve] + si * tb[kPvi] + tb[kPvconst];
  }
  const bool refractory = rc > 0;
  float v_new = refractory ? tb[kVreset] : v_prop;
  const bool spike = !refractory && v_new >= tb[kVth];
  if (spike) v_new = tb[kVreset];
  v_out[i] = v_new;
  // ref_steps is a float column; the cast truncates, as astype(int32) does
  rc_out[i] = spike ? static_cast<int>(tb[kRefSteps]) : max(rc - 1, 0);
  spike_out[i] = spike;
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
