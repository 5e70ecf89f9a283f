// The per-neuron LIF (K2), Izhikevich (K4) and AdEx (K5) updates, one
// source for every kernel that takes a neuron's step: the standalone
// kernels (lif_step.cu, izhikevich_step.cu, adex_step.cu) and the neuron
// epilogues of K1 (synaptic_gather.cu).
//
// Each function takes one neuron's loaded state, its two inputs of this
// step and a pointer to its group's table row, and returns the new state
// and the spike. The libraries are built with --fmad=false and without fast
// math, so an expression gives the same bits wherever it is inlined: the
// fused K1 + K2 step is bitwise equal to K1 -> add -> K2 by construction,
// and so are K1 + K4 and K1 + K5 to K1 -> add -> K4 and K5.
//
// The arithmetic is the reference's, op for op (see each kernel's header):
// LIF in the Pallas kernel's order, v*p_vv + syn_ex*p_ve + syn_in*p_vi +
// p_vconst left to right; Izhikevich as izhikevich_math, left to right,
// with the previous step's syn_ex + syn_in driving v; AdEx as adex_math,
// with expf (not __expf), IEEE division and the exponent's argument
// clamped so that a NaN stays NaN.

#pragma once

#include <cuda_runtime.h>

namespace neuron_math {

// column order of repro_torch.core.snn._COLS (the wrappers check NCOL ==
// 12); rows lie table_stride >= kNcol floats apart, so that a composite
// model's table, which carries one more column, is read in place
namespace lif {
enum Col {
  kPvv = 0, kPee, kPii, kPve, kPvi, kPvconst, kVth, kVreset, kRefSteps,
  kEex, kEin, kInvCmDt, kNcol
};
}  // namespace lif

// column order of repro_torch.kernels.izhikevich_step._COLS (the wrappers
// check NCOL == 11), rows table_stride apart as above
namespace izhikevich {
enum Col {
  kPee = 0, kPii, kDt, kA, kB, kC, kD, kVpeak, kRefSteps, kIe, kIscale,
  kNcol
};
}  // namespace izhikevich

// column order of repro_torch.kernels.adex_step._COLS (the wrappers check
// NCOL == 14), rows table_stride apart as above
namespace adex {
enum Col {
  kPee = 0, kPii, kDtCm, kGl, kEl, kVt, kDeltaT, kVpeak, kVreset, kDtTw, kA,
  kB, kRefSteps, kIe, kNcol
};
constexpr float kExpClamp = 10.0f;  // repro_torch.kernels.adex_step.EXP_CLAMP
}  // namespace adex

struct LifState {
  float v, syn_ex, syn_in;
  int ref_count;
};

struct IzhikevichState {
  float v, u, syn_ex, syn_in;
  int ref_count;
};

struct AdexState {
  float v, w_ad, syn_ex, syn_in;
  int ref_count;
};

struct LifNext {
  float v, syn_ex, syn_in;
  int ref_count;
  bool spike;
};

struct IzhikevichNext {
  float v, u, syn_ex, syn_in;
  int ref_count;
  bool spike;
};

struct AdexNext {
  float v, w_ad, syn_ex, syn_in;
  int ref_count;
  bool spike;
};

// Decay the synaptic state and add the input, propagate the membrane (exact
// integration, or the conductance form when cond != 0), clamp refractory
// neurons to v_reset, threshold, reset and count the refractory period down.
__device__ __forceinline__ LifNext lif_update(const LifState s,
                                              float input_ex, float input_in,
                                              const float* __restrict__ tb,
                                              int cond) {
  using namespace lif;
  LifNext o;
  o.syn_ex = s.syn_ex * tb[kPee] + input_ex;
  o.syn_in = s.syn_in * tb[kPii] + input_in;
  const float vm = s.v, se = s.syn_ex, si = s.syn_in;
  float v_prop;
  if (cond) {
    const float i_cond = se * (tb[kEex] - vm) - si * (vm - tb[kEin]);
    v_prop = vm * tb[kPvv] + tb[kPvconst] + i_cond * tb[kInvCmDt];
  } else {
    v_prop = vm * tb[kPvv] + se * tb[kPve] + si * tb[kPvi] + tb[kPvconst];
  }
  const bool refractory = s.ref_count > 0;
  float v_new = refractory ? tb[kVreset] : v_prop;
  const bool spike = !refractory && v_new >= tb[kVth];
  if (spike) v_new = tb[kVreset];
  o.v = v_new;
  // ref_steps is a float column; the cast truncates, as astype(int32) does
  o.ref_count = spike ? static_cast<int>(tb[kRefSteps])
                      : max(s.ref_count - 1, 0);
  o.spike = spike;
  return o;
}

// Decay the synaptic state and add the input, take one forward-Euler step
//   v' = v + dt (0.04 v^2 + 5 v + 140 - u + I),  I = i_scale (se + si) + i_e
//   u' = u + dt a (b v - u)
// with the previous step's synaptic state in I (arrivals act from t+dt
// on), clamp refractory neurons to c, threshold at v_peak, reset
// (v <- c, u <- u + d) and count the refractory period down.
__device__ __forceinline__ IzhikevichNext izhikevich_update(
    const IzhikevichState s, float input_ex, float input_in,
    const float* __restrict__ tb) {
  using namespace izhikevich;
  IzhikevichNext o;
  const float vm = s.v, um = s.u, se = s.syn_ex, si = s.syn_in;
  const float dt = __ldg(tb + kDt);
  o.syn_ex = se * __ldg(tb + kPee) + input_ex;
  o.syn_in = si * __ldg(tb + kPii) + input_in;
  const float i_in = __ldg(tb + kIscale) * (se + si) + __ldg(tb + kIe);
  const float v_prop =
      vm + dt * (0.04f * vm * vm + 5.0f * vm + 140.0f - um + i_in);
  const float u_prop = um + dt * __ldg(tb + kA) * (__ldg(tb + kB) * vm - um);

  const bool refractory = s.ref_count > 0;
  const float c = __ldg(tb + kC);
  float v_new = refractory ? c : v_prop;
  const bool spike = !refractory && v_new >= __ldg(tb + kVpeak);
  if (spike) v_new = c;
  o.v = v_new;
  o.u = spike ? u_prop + __ldg(tb + kD) : u_prop;
  // ref_steps is a float column; the cast truncates, as astype(int32) does
  o.ref_count = spike ? static_cast<int>(__ldg(tb + kRefSteps))
                      : max(s.ref_count - 1, 0);
  o.spike = spike;
  return o;
}

// Decay the synaptic state and add the input, take one forward-Euler step
// of (v, w), clamp refractory neurons to v_reset, threshold at v_peak, reset
// (v <- v_reset, w <- w + b) and count the refractory period down.
__device__ __forceinline__ AdexNext adex_update(const AdexState s,
                                                float input_ex,
                                                float input_in,
                                                const float* __restrict__ tb) {
  using namespace adex;
  AdexNext o;
  const float vm = s.v, wm = s.w_ad, se = s.syn_ex, si = s.syn_in;
  o.syn_ex = se * __ldg(tb + kPee) + input_ex;
  o.syn_in = si * __ldg(tb + kPii) + input_in;
  const float g_l = __ldg(tb + kGl), e_l = __ldg(tb + kEl);
  const float delta_t = __ldg(tb + kDeltaT);
  float exp_arg = (vm - __ldg(tb + kVt)) / delta_t;
  exp_arg = exp_arg > kExpClamp ? kExpClamp : exp_arg;
  const float i_exp = g_l * delta_t * expf(exp_arg);
  const float dv = -g_l * (vm - e_l) + i_exp + se + si + __ldg(tb + kIe) - wm;
  const float v_prop = vm + __ldg(tb + kDtCm) * dv;
  const float w_prop =
      wm + __ldg(tb + kDtTw) * (__ldg(tb + kA) * (vm - e_l) - wm);

  const bool refractory = s.ref_count > 0;
  const float v_reset = __ldg(tb + kVreset);
  float v_new = refractory ? v_reset : v_prop;
  const bool spike = !refractory && v_new >= __ldg(tb + kVpeak);
  if (spike) v_new = v_reset;
  o.v = v_new;
  o.w_ad = spike ? w_prop + __ldg(tb + kB) : w_prop;
  // ref_steps is a float column; the cast truncates, as astype(int32) does
  o.ref_count = spike ? static_cast<int>(__ldg(tb + kRefSteps))
                      : max(s.ref_count - 1, 0);
  o.spike = spike;
  return o;
}

}  // namespace neuron_math
