// K8: fused online-softmax attention (causal or not, GQA, ragged tails),
// hand-written for Hopper (sm_90a), in two routes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _kernel, pallas_call at :102). For query head h of
// batch b, with kv head h / (H / Hk):
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
// B 4, S 512, H 16 over Hk 2, dh 128, bf16, causal) q and the output are
// 8.39 MB each and k, v 1.05 MB each: 18.9 MB, 5.63 us at 3.35 TB/s. The
// causal half of the two products is 4.3 GFLOP, 4.4 us at the bf16
// tensor-core rate; with p split in two (below) the tensor cores do 6.5
// GFLOP, 6.5 us. Bytes and operations are nearly balanced.
//
// Route "wgmma" (bf16, dh and dv multiples of 16, every base pointer and
// stride a multiple of 16 bytes; flash_attention_kernel_wgmma). One CTA of
// three warpgroups per (128-query tile, b * H + h), causal tiles with the
// most key tiles launched first so that the last wave is a short one:
// - warpgroup 0 is the producer: it gives its registers away (setmaxnreg)
//   and one thread loads the Q tile once and 64-key K/V tiles into a ring
//   of 2-4 stages by TMA (cp.async.bulk.tensor over 4-d tensor maps of
//   (d, seq, head, batch) built from the tensors' own strides, 128-byte
//   swizzle, 64 columns a box; rows past T and columns past dh arrive as
//   zeros), each stage guarded by a full and an empty mbarrier;
// - warpgroups 1 and 2 each own 64 query rows. S = Q K^T is dh / 16
//   wgmma.m64n64k16 with both operands in shared memory (bf16 products are
//   exact in fp32, so only the order of the sums differs from the
//   reference), then times scale. The online softmax runs on the
//   accumulator fragment in registers: a thread holds 16 scores of two
//   rows, and a row lies on the four threads of a quad, so the row max and
//   sum are two xor shuffles. Only the diagonal and ragged-tail tiles are
//   masked; tiles wholly above the diagonal are skipped, which is exact
//   because every row has met key 0 in the first tile (there p =
//   exp(-1e30 - m) = 0 and corr = 1). expf throughout.
// - P V keeps p unrounded to within 2^-17: p_hi = bf16(p) and p_lo =
//   bf16(p - p_hi) are the register A operand of two wgmmas into the same
//   fp32 accumulator per 16 keys (m64n128k16 for each pair of 64-column
//   boxes of dv, m64n64k16 for a last single box; the accumulator's layout
//   is the A operand's, so no shuffle), with V's tile read as TMA stored it
//   through the descriptor's transpose bit.
// - The epilogue divides by max(l, 1e-30), rounds to bf16 and stores to
//   (B, S, H * dv) from registers. No atomics: bitwise deterministic.
// What holds it back (PERF.md, section 6): the tensor cores run at 18-36 % of
// their bf16 rate, counting P_lo V. Within a warpgroup the S product, the
// softmax and P V follow one another, and the two warpgroups reach each
// phase at about the same time; a software pipeline inside each
// warpgroup, with or without turns between the two, was not faster than
// this plain order on the card.
//
// Route "simt" (fp32, and bf16 shapes the first route does not take;
// flash_attention_kernel): one CTA of 256 threads (16 x 16) per (64-query
// tile, b * H + h). The Q tile is staged once in shared memory as fp32; a
// loop walks 64-key tiles, staging K and V (zero rows past T, as the
// reference pads), and skips the tiles wholly above the causal diagonal as
// above. Thread (ty, tx) owns query rows ty + 16 i and key columns tx + 16 j
// (i, j < 4) of the score tile, and value columns tx + 16 c of the
// accumulator; K rows are padded to dh + 1 floats so that the 16 columns a
// half-warp reads lie in 16 banks. Row max and row sum are butterfly
// shuffles over the 16 lanes of a row, which leave every lane the same
// value. Both products are fp32 FMAs on the CUDA cores.
//
// Both routes: expf, IEEE division, --fmad=false from the build; inputs
// read in the reference's (B, S, H, dh) layout through their strides (last
// dim contiguous), so the wrapper makes no transposed copy.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Route "simt": fp32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// Route "wgmma": bf16 on the tensor cores, K/V by TMA, warp-specialised
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRows = 128;       // query rows a CTA, 64 a consumer warpgroup
constexpr int kKeys = 64;        // keys a stage
constexpr int kRowBytes = 128;   // one swizzled row: 64 bf16 of one box
constexpr int kThreads = 384;    // producer warpgroup + two consumers
constexpr int kMaxStages = 4;
constexpr int kBarBytes = 1024;  // barriers, ahead of the 1024-B aligned tiles
constexpr int kSmemLimit = 232448;
constexpr int kConsumerWarps = 8;
constexpr float kNegInf = -1e30f;

struct Params {
  __nv_bfloat16* out;
  int s_len, t_len, h, group, dh, dv, n_qtiles, stages, causal;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A lost phase would
// hang the card; after 2^26 polls (seconds) it traps instead, which the
// next CUDA call reports as a launch failure.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1u << 26)) __trap();
  }
}

// one box of the 4-d map (d, seq, head, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units. Tiles are 1024-B aligned,
// so the base offset is 0.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TC_F8(d, i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TC_D32(d) TC_F8(d, 0), TC_F8(d, 8), TC_F8(d, 16), TC_F8(d, 24)
#define TC_D64(d)                                                        \
  TC_D32(d), TC_F8(d, 32), TC_F8(d, 40), TC_F8(d, 48), TC_F8(d, 56)
#define TC_D32_LIST \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31}"
#define TC_D64_LIST \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// The products, D (64 x N, fp32) += A (64 x 16) B (16 x N), accumulator in
// wgmma's layout: warp w, lane 4 g + t holds rows 16 w + g (entries 4 j,
// 4 j + 1) and 16 w + g + 8 (4 j + 2, 4 j + 3) at columns 8 j + 2 t and
// 8 j + 2 t + 1. ss (S = Q K^T, N = 64 keys): A and B K-major in shared
// memory (Q rows, K rows: dh contiguous). rs (O += P V, N = 64 or 128
// value columns): A from four bf16x2 registers a thread, B MN-major in
// shared memory (V rows, dv contiguous: the transpose bit).
template <int N>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32_LIST
        ", %32, %33, p, 1, 1, 0, 0;\n\t}"
        : TC_D32(d)
        : "l"(da), "l"(db), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32_LIST
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
        : TC_D32(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TC_D64_LIST
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
        : TC_D64(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
};

#undef TC_F8
#undef TC_D32
#undef TC_D64
#undef TC_D32_LIST
#undef TC_D64_LIST

template <int N>
__device__ __forceinline__ float (&cols(float* o, int c))[N] {
  return *reinterpret_cast<float(*)[N]>(o + 32 * c);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// O += A V for one 16-key step of a stage at vs (two 8-row groups 1024 B
// apart), value columns in pairs of 64-column boxes (N = 128, the boxes 64
// rows apart) where two remain, else one box (N = 64)
template <int NDV>
__device__ __forceinline__ void issue_pv_step(float (&o)[NDV * 32],
                                              uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3,
                                              uint32_t vs) {
  constexpr uint32_t kBox = kKeys * kRowBytes;
  if constexpr (NDV == 1) {
    Mma<64>::rs(cols<32>(o, 0), a0, a1, a2, a3, desc_sw128(vs, kBox, 1024));
  } else {
    Mma<128>::rs(cols<64>(o, 0), a0, a1, a2, a3, desc_sw128(vs, kBox, 1024));
  }
  if constexpr (NDV == 3) {
    Mma<64>::rs(cols<32>(o, 2), a0, a1, a2, a3,
                desc_sw128(vs + 2 * kBox, kBox, 1024));
  } else if constexpr (NDV == 4) {
    Mma<128>::rs(cols<64>(o, 2), a0, a1, a2, a3,
                 desc_sw128(vs + 2 * kBox, kBox, 1024));
  }
}

// NDV: 64-column boxes of dv (1-4)
template <int NDV>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel_wgmma(
    __grid_constant__ const CUtensorMap tm_q,
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v, const Params p) {
  constexpr int NS = kKeys / 2;  // scores a thread holds: 2 rows x 16
  constexpr int NP = kKeys / 4;  // bf16x2 registers of p_hi (and of p_lo)
  extern __shared__ uint8_t tc_smem[];
  const uint32_t base = smem_addr(tc_smem);
  const uint32_t bar_q = base;
  const uint32_t bar_full = base + 8;                    // + 8 stage
  const uint32_t bar_empty = base + 8 + 8 * kMaxStages;  // + 8 stage
  const uint32_t tiles = (base + kBarBytes + 1023) & ~1023u;
  const int ndh = (p.dh + 63) / 64;  // 64-column boxes of dh
  const uint32_t q_bytes = ndh * kRows * kRowBytes;
  const uint32_t k_bytes = ndh * kKeys * kRowBytes;
  const uint32_t stage_bytes = k_bytes + NDV * kKeys * kRowBytes;
  const uint32_t q_tile = tiles;
  const uint32_t ring = tiles + q_bytes;

  const int bh = blockIdx.x;
  const int b = bh / p.h, hq = bh - b * p.h, hkv = hq / p.group;
  const int q0 = (p.n_qtiles - 1 - static_cast<int>(blockIdx.y)) * kRows;
  int nk = (p.t_len + kKeys - 1) / kKeys;
  if (p.causal) nk = min(nk, (min(q0 + kRows, p.s_len) - 1) / kKeys + 1);

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < p.stages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 0) {
      mbar_expect_tx(bar_q, q_bytes);
      for (int c = 0; c < ndh; ++c)
        tma_load(q_tile + c * kRows * kRowBytes, &tm_q, bar_q, 64 * c, q0, hq,
                 b);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % p.stages;
        const uint32_t round = kt / p.stages;
        mbar_wait(bar_empty + 8 * st, (round & 1) ^ 1);
        const uint32_t full = bar_full + 8 * st;
        const uint32_t ks = ring + st * stage_bytes, vs = ks + k_bytes;
        mbar_expect_tx(full, stage_bytes);
        for (int c = 0; c < ndh; ++c)
          tma_load(ks + c * kKeys * kRowBytes, &tm_k, full, 64 * c,
                   kt * kKeys, hkv, b);
        for (int c = 0; c < NDV; ++c)
          tma_load(vs + c * kKeys * kRowBytes, &tm_v, full, 64 * c,
                   kt * kKeys, hkv, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = wg - 1;
    const int lt = tid - 128 * wg;
    const int warp = lt / 32, lane = lt % 32, g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * cw;  // this warpgroup's first query row
    const int ra = row0 + 16 * warp + g, rb = ra + 8;  // this thread's rows
    int nk_wg = 0;  // key tiles with a valid pair for these rows
    if (row0 < p.s_len) {
      nk_wg = (p.t_len + kKeys - 1) / kKeys;
      if (p.causal)
        nk_wg = min(nk_wg, min(row0 + 63, p.s_len - 1) / kKeys + 1);
    }
    const uint32_t q_wg = q_tile + 64 * cw * kRowBytes;

    float o[NDV * 32];  // 64 value columns a box
#pragma unroll
    for (int i = 0; i < NDV * 32; ++i) o[i] = 0.0f;
    float ma = kNegInf, mb = kNegInf, la = 0.0f, lb = 0.0f;

    mbar_wait(bar_q, 0);
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % p.stages;
      const uint32_t round = kt / p.stages;
      mbar_wait(bar_full + 8 * st, round & 1);
      if (kt < nk_wg) {
        const uint32_t ks = ring + st * stage_bytes, vs = ks + k_bytes;
        // S = Q K^T: dh / 16 products, 16 columns each (four per 64-column
        // box, 32 B apart inside the 128-B swizzled rows)
        float s[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] = 0.0f;
        fence_regs(s);
        wg_fence();
        for (int j = 0; j < p.dh / 16; ++j) {
          const uint32_t off = (j & 3) * 32;
          Mma<64>::ss(s,
                      desc_sw128(q_wg + (j >> 2) * kRows * kRowBytes + off, 16,
                                 1024),
                      desc_sw128(ks + (j >> 2) * kKeys * kRowBytes + off, 16,
                                 1024));
        }
        wg_commit();
        wg_wait_all();
        fence_regs(s);

        // online softmax on the fragment; masks only where a pair is
        // invalid: the diagonal and the ragged tail
        const int k0 = kt * kKeys;
        const bool edge =
            k0 + kKeys > p.t_len || (p.causal && k0 + kKeys - 1 > row0);
        float xa = kNegInf, xb = kNegInf;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          float x = s[i] * p.scale;
          if (edge) {
            const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
            const int row = (i & 2) ? rb : ra;
            if (col >= p.t_len || (p.causal && row < col)) x = kNegInf;
          }
          s[i] = x;
          if (i & 2)
            xb = fmaxf(xb, x);
          else
            xa = fmaxf(xa, x);
        }
#pragma unroll
        for (int lx = 1; lx <= 2; lx <<= 1) {  // the quad holding a row
          xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, lx));
          xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, lx));
        }
        const float na = fmaxf(ma, xa), nb = fmaxf(mb, xb);
        float sa = 0.0f, sb = 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const float e = expf(s[i] - ((i & 2) ? nb : na));
          s[i] = e;
          if (i & 2)
            sb += e;
          else
            sa += e;
        }
#pragma unroll
        for (int lx = 1; lx <= 2; lx <<= 1) {
          sa += __shfl_xor_sync(0xffffffffu, sa, lx);
          sb += __shfl_xor_sync(0xffffffffu, sb, lx);
        }
        const float ca = expf(ma - na), cb = expf(mb - nb);
        la = la * ca + sa;
        lb = lb * cb + sb;
        ma = na;
        mb = nb;

        // p = p_hi + p_lo, each bf16; pair i is (s[2 i], s[2 i + 1]), and
        // pairs 4 kk to 4 kk + 3 are the A operand of keys 16 kk to 16 kk + 15
        uint32_t ph[NP], pl[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const __nv_bfloat162 hi =
              __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
          const float2 hf = __bfloat1622float2(hi);
          ph[i] = bf16x2_bits(hi);
          pl[i] = bf16x2_bits(
              __floats2bfloat162_rn(s[2 * i] - hf.x, s[2 * i + 1] - hf.y));
        }
#pragma unroll
        for (int i = 0; i < NDV * 32; ++i) o[i] *= (i & 2) ? cb : ca;
        fence_regs(o);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          const uint32_t vk = vs + kk * 16 * kRowBytes;
          issue_pv_step<NDV>(o, ph[4 * kk], ph[4 * kk + 1],
                                 ph[4 * kk + 2], ph[4 * kk + 3], vk);
          issue_pv_step<NDV>(o, pl[4 * kk], pl[4 * kk + 1],
                                 pl[4 * kk + 2], pl[4 * kk + 3], vk);
        }
        wg_commit();
        wg_wait_all();
        fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    if (nk_wg > 0) {
      const float den_a = fmaxf(la, 1e-30f), den_b = fmaxf(lb, 1e-30f);
      const long long ld = static_cast<long long>(p.h) * p.dv;
      __nv_bfloat16* oa = p.out +
                          (static_cast<long long>(b) * p.s_len + ra) * ld +
                          static_cast<long long>(hq) * p.dv;
      __nv_bfloat16* ob = oa + 8 * ld;
#pragma unroll
      for (int j = 0; j < NDV * 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col >= p.dv) continue;
        if (ra < p.s_len)
          *reinterpret_cast<__nv_bfloat162*>(oa + col) =
              __floats2bfloat162_rn(o[4 * j] / den_a, o[4 * j + 1] / den_a);
        if (rb < p.s_len)
          *reinterpret_cast<__nv_bfloat162*>(ob + col) = __floats2bfloat162_rn(
              o[4 * j + 2] / den_b, o[4 * j + 3] / den_b);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that nothing links -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

constexpr int kErrNoEncoder = 1000;  // returned when the encoder is missing
constexpr int kErrEncode = 2000;     // + the CUresult of a failed encode

// 4-d map over (d, seq, head, batch) of a bf16 tensor with element strides
// st = (batch, seq, head); a dim of size 1 is never stepped, so its stride
// is given as 16 bytes (TMA takes only multiples of 16)
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
           int rows, int heads, int batch, const long long* st,
           int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      rows > 1 ? static_cast<cuuint64_t>(st[1]) * 2 : 16,
      heads > 1 ? static_cast<cuuint64_t>(st[2]) * 2 : 16,
      batch > 1 ? static_cast<cuuint64_t>(st[0]) * 2 : 16};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <int NDV>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, Params prm, int bh, cudaStream_t stream) {
  auto kern = flash_attention_kernel_wgmma<NDV>;
  const int ndh = (prm.dh + 63) / 64;
  const int q_bytes = ndh * kRows * kRowBytes;
  const int stage_bytes = (ndh + NDV) * kKeys * kRowBytes;
  prm.stages = (kSmemLimit - 2 * kBarBytes - q_bytes) / stage_bytes;
  if (prm.stages > kMaxStages) prm.stages = kMaxStages;  // 2 at dh = dv = 256
  const int smem = 2 * kBarBytes + q_bytes + prm.stages * stage_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, prm.n_qtiles);
  kern<<<grid, kThreads, smem, stream>>>(mq, mk, mv, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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

// The tensor-core route, bf16 only: the same arguments, and the wrapper
// has also checked that dh and dv are multiples of 16 and that every base
// pointer and every stride of a dim longer than 1 is a multiple of 16
// bytes. Returns a CUDA error, 1000 if the driver has no tensor-map
// encoder, or 2000 + its CUresult if a map is refused.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* out, int b,
    int s_len, int t_len, int h, int hk, int dh, int dv,
    const long long* strides, float scale, int causal, void* stream) {
  const tc::EncodeTiled fn = tc::encoder();
  if (fn == nullptr) return tc::kErrNoEncoder;
  CUtensorMap mq, mk, mv;
  int err = tc::encode(fn, &mq, q, dh, s_len, h, b, strides, tc::kRows);
  if (err == 0)
    err = tc::encode(fn, &mk, k, dh, t_len, hk, b, strides + 3, tc::kKeys);
  if (err == 0)
    err = tc::encode(fn, &mv, v, dv, t_len, hk, b, strides + 6, tc::kKeys);
  if (err != 0) return err;
  const tc::Params prm{static_cast<__nv_bfloat16*>(out), s_len, t_len, h,
                       h / hk, dh, dv, (s_len + tc::kRows - 1) / tc::kRows,
                       0, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((dv + 63) / 64) {
    case 1:
      return tc::launch<1>(mq, mk, mv, prm, b * h, st);
    case 2:
      return tc::launch<2>(mq, mk, mv, prm, b * h, st);
    case 3:
      return tc::launch<3>(mq, mk, mv, prm, b * h, st);
    default:
      return tc::launch<4>(mq, mk, mv, prm, b * h, st);
  }
}
