// K8: fused online-softmax attention (causal or not, GQA, ragged tails),
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _kernel). For query head h of batch b, with kv head
// h / (H / Hk):
//   s = (q . k^T) * scale                       q, k read as fp32
//   s = -1e30 where kv_pos >= T or (causal and q_pos < kv_pos)
//   m' = max(m, rowmax s); p = exp(s - m'); corr = exp(m - m')
//   l' = l corr + rowsum p;  acc' = acc corr + p . v
//   out = acc / max(l, 1e-30), rounded to q's dtype
// with positions counted from 0 on both sides (no query offset: prefill and
// the full-sequence forward, never decode). The reference casts v to fp32
// before p . v, so p is not rounded; every sum is fp32.
//
// What bounds it on this card: at the LM face's prefill shape (qwen2.5-3b,
// B 4, S 512, H 16 over Hk 2, dh 128, bf16) the inputs and output are 17.8
// MB, 5.3 us at 3.35 TB/s, and the causal half of the two products is 4.3
// GFLOP, 4.4 us at the bf16 tensor-core rate: bytes, nearly balanced. This
// first design uses neither tensor cores nor asynchronous copies, so it is
// bound by its fp32 FMAs and shared-memory reads instead (PERF.md has the
// numbers); wgmma, TMA and warp specialisation are for the redesign.
//
// Design. One CTA of 256 threads (16 x 16) per (64-query tile, b * H + h).
// The Q tile is staged once in shared memory as fp32; a loop walks 64-key
// tiles, staging K and V (zero rows past T, as the reference pads), and
// skips the tiles wholly above the causal diagonal: there p = exp(-1e30 -
// m) = 0 and corr = 1 exactly, because every row has met key 0 in the first
// tile. Thread (ty, tx) owns query rows ty + 16 i and key columns tx + 16 j
// (i, j < 4) of the score tile, and value columns tx + 16 c of the
// accumulator; K rows are padded to dh + 1 floats so that the 16 columns a
// half-warp reads lie in 16 banks. Row max and row sum are butterfly
// shuffles over the 16 lanes of a row, which leave every lane the same
// value, and nothing is summed with atomics, so the result is bitwise
// deterministic. expf, IEEE division, and --fmad=false from the build.
// Inputs are read in the reference's (B, S, H, dh) layout through their
// strides (last dim contiguous), so the wrapper makes no transposed copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // query rows and key columns per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// DVT: accumulator columns per thread, ceil(dv / 16) rounded up to a power
// of two (dv <= 256)
template <typename T, int DVT>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int s_len, int t_len,
    int h, int group, int dh, int dv, long long qsb, long long qss,
    long long qsh, long long ksb, long long kst, long long ksh,
    long long vsb, long long vst, long long vsh, float scale, int causal) {
  extern __shared__ float smem[];
  const int ldk = dh + 1;
  float* qs = smem;                // kTile x ldk
  float* ks = qs + kTile * ldk;    // kTile x ldk
  float* vs = ks + kTile * ldk;    // kTile x dv
  float* ps = vs + kTile * dv;     // kTile x kTile

  const int bh = blockIdx.x;
  const int b = bh / h, hq = bh - b * h, hkv = hq / group;
  const int q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const T* qb = q + b * qsb + hq * qsh;
  const T* kb = k + b * ksb + hkv * ksh;
  const T* vb = v + b * vsb + hkv * vsh;

  for (int i = tid; i < kTile * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    qs[r * ldk + d] =
        q0 + r < s_len ? to_f32(qb[(q0 + r) * qss + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][DVT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DVT; ++c) acc[i][c] = 0.0f;
  }

  int nk = (t_len + kTile - 1) / kTile;
  if (causal) nk = min(nk, static_cast<int>(blockIdx.y) + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
    for (int i = tid; i < kTile * dh; i += kThreads) {
      const int r = i / dh, d = i - r * dh;
      ks[r * ldk + d] =
          k0 + r < t_len ? to_f32(kb[(k0 + r) * kst + d]) : 0.0f;
    }
    for (int i = tid; i < kTile * dv; i += kThreads) {
      const int r = i / dv, c = i - r * dv;
      vs[r * dv + c] = k0 + r < t_len ? to_f32(vb[(k0 + r) * vst + c]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ldk + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool valid = kp < t_len && (!causal || qp >= kp);
        sc[i][j] = valid ? sc[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, sc[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rsum += p;
        ps[(ty + 16 * i) * kTile + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
#pragma unroll
      for (int c = 0; c < DVT; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kTile + kk];
#pragma unroll
      for (int c = 0; c < DVT; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < dv ? vs[kk * dv + col] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<long long>(b) * s_len + row) * h * dv +
           static_cast<long long>(hq) * dv;
#pragma unroll
    for (int c = 0; c < DVT; ++c) {
      const int col = tx + 16 * c;
      if (col < dv) store(o + col, acc[i][c] / den);
    }
  }
}

template <typename T, int DVT>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s_len, int t_len, int h, int hk, int dh, int dv,
           const long long* st, float scale, int causal,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, DVT>;
  const size_t smem =
      sizeof(float) * (2 * kTile * (dh + 1) + kTile * dv + kTile * kTile);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (s_len + kTile - 1) / kTile);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s_len, t_len, h,
      h / hk, dh, dv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dv(const void* q, const void* k, const void* v, void* out, int b,
              int s_len, int t_len, int h, int hk, int dh, int dv,
              const long long* st, float scale, int causal,
              cudaStream_t stream) {
  const int cols = (dv + 15) / 16;
#define FA_LAUNCH(N)                                                    \
  return launch<T, N>(q, k, v, out, b, s_len, t_len, h, hk, dh, dv, st, \
                      scale, causal, stream)
  if (cols <= 1) FA_LAUNCH(1);
  if (cols <= 2) FA_LAUNCH(2);
  if (cols <= 4) FA_LAUNCH(4);
  if (cols <= 8) FA_LAUNCH(8);
  FA_LAUNCH(16);
#undef FA_LAUNCH
}

}  // namespace

// strides: q (batch, seq, head), k (batch, seq, head), v (batch, seq,
// head), in elements; the last dim of each is contiguous. The wrapper has
// checked shapes, dtypes, H % Hk == 0 and 1 <= dh, dv <= 256.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int b,
    int s_len, int t_len, int h, int hk, int dh, int dv,
    const long long* strides, float scale, int causal, int is_bf16,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dv<__nv_bfloat16>(q, k, v, out, b, s_len, t_len, h, hk,
                                    dh, dv, strides, scale, causal, st);
  return launch_dv<float>(q, k, v, out, b, s_len, t_len, h, hk, dh, dv,
                          strides, scale, causal, st);
}
