// Paged decode attention with LSE output, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py::_kernel
// (wrapper paged_decode_attention).  Semantics are those of the plain torch
// version src/repro_torch/kernels/ref.py::paged_decode_attention:
//
//   q            [N, Hq, Dk]         one query token per work row
//   k_pages      [P, page, Hkv, Dk]
//   v_pages      [P, page, Hkv, Dv]
//   block_tables [N, MB]  int32      page ids per row
//   lengths      [N]      int32      valid kv tokens per row; 0 -> inactive
//   out          [N, Hq, Dv]         q's dtype
//   lse          [N, Hq]  float32    -1e30 for an inactive row
//   k_scale, v_scale [P]  float32    per-page scales, quantized pools only
//
// The G = Hq / Hkv query heads of kv head h are q[n, h*G : (h+1)*G].
//
// Types: q and out are Tq (float or bfloat16).  Pages are Tkv: Tq itself,
// or a quantized pool of fp8 e4m3 or int8 codes with one float32 scale per
// page (src/repro_torch/kernels/quant.py).  For a quantized pool the fused
// dequant of the Pallas kernel's quantized branch happens at staging: each
// code is upcast to float32 and multiplied by its page's scale on its way
// into shared memory (upcast, then multiply, in the Pallas order).  No
// dequantized copy of the pool ever exists in device memory.
//
// Design.  One block per (work row, kv head).  The Pallas kernel's
// sequential page axis becomes a loop split over the block's warps (up to
// 16, as many as their shared memory fits): warp w takes pages w,
// w + nwarps, ...  Each warp stages its page's valid K and V rows in its
// own float32 shared memory and keeps its own online-softmax state
// (running max, sum and accumulator of the G heads), so warps never wait
// for each other inside the loop.  At the end the warps' states are merged
// by their log-sum-exp, as Phase 4 merges CP shards.  Every K/V byte is
// read from device memory once per (row, kv head).  The load and
// accumulate loops use no runtime division.
//
// What bounds it: the K/V bytes (1 per value in a quantized pool).  One
// query row per kv head does about 2*G flops per K/V element, far below
// the ~295 flop/byte at which the H100's tensor cores would become the
// limit, so the kernel uses CUDA cores.  But one block serves a (row, kv
// head), so a call with few long rows keeps few SMs busy, each walking its
// pages with CUDA-core dot products from shared memory.  Splitting rows across blocks (split-KV) and cp.async/TMA
// staging are the steps that would approach the bandwidth bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Floats of one warp's shared state:
//   k_s   [page][Dk + 1]  the page's K rows (padded against bank conflicts)
//   v_s   [page][Dv]      the page's V rows
//   p_s   [G][page]       scores, then probabilities
//   acc_s [G][Dv]         running accumulator
//   m_s, l_s, c_s [G]     running max, running sum, this page's correction
__host__ __device__ inline size_t warp_floats(int G, int Dk, int Dv, int page) {
  return (size_t)page * (Dk + 1) + (size_t)page * Dv + (size_t)G * page +
         (size_t)G * Dv + 3 * (size_t)G;
}

// Shared memory: q_s [G][Dk] (scaled queries, shared by all warps), then
// one warp_floats() region per warp.
template <typename Tq, typename Tkv>
__global__ void paged_decode_kernel(const Tq* __restrict__ q,
                                    const Tkv* __restrict__ k_pages,
                                    const Tkv* __restrict__ v_pages,
                                    const float* __restrict__ k_scale,
                                    const float* __restrict__ v_scale,
                                    const int32_t* __restrict__ block_tables,
                                    const int32_t* __restrict__ lengths,
                                    Tq* __restrict__ out,
                                    float* __restrict__ lse,
                                    int Hq, int Hkv, int Dk, int Dv, int page,
                                    int MB, float scale) {
  // a 1-byte page type is a quantized pool (fp8 e4m3 or int8 codes)
  constexpr bool kQuant = sizeof(Tkv) == 1;
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int kstride = Dk + 1;
  const size_t wfl = warp_floats(G, Dk, Dv, page);

  const int length = lengths[n];
  const size_t q_base = ((size_t)n * Hq + (size_t)h * G) * Dk;
  const size_t o_base = ((size_t)n * Hq + (size_t)h * G) * Dv;

  if (length <= 0) {
    for (int i = tid; i < G * Dv; i += blockDim.x) out[o_base + i] = from_f<Tq>(0.f);
    for (int g = tid; g < G; g += blockDim.x) lse[(size_t)n * Hq + h * G + g] = kNegInf;
    return;
  }

  float* q_s = smem;
  float* w_s = q_s + (size_t)G * Dk;          // first warp's region
  float* k_s = w_s + warp * wfl;
  float* v_s = k_s + page * kstride;
  float* p_s = v_s + page * Dv;
  float* acc_s = p_s + G * page;
  float* m_s = acc_s + G * Dv;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  // q * scale, rounded to Tq as the plain version does before the product
  for (int i = tid; i < G * Dk; i += blockDim.x)
    q_s[i] = to_f(from_f<Tq>(to_f(q[q_base + i]) * scale));
  for (int i = lane; i < G * Dv; i += 32) acc_s[i] = 0.f;
  for (int g = lane; g < G; g += 32) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int npages = (length + page - 1) / page;
  const int32_t* bt = block_tables + (size_t)n * MB;
  for (int b = warp; b < npages; b += nwarps) {
    const size_t pid = (size_t)bt[b];
    const int valid = min(page, length - b * page);
    // stage the page's valid K and V rows of kv head h: lanes walk the
    // head dim (coalesced), and the token loop is unrolled so that several
    // independent loads are in flight per lane.  A quantized page is
    // dequantized here with its two scales, read once per page.
    const Tkv* kp = k_pages + (pid * page * Hkv + h) * Dk;   // token t at t*Hkv*Dk
    const Tkv* vp = v_pages + (pid * page * Hkv + h) * Dv;
    float ks = 1.f, vs = 1.f;
    if constexpr (kQuant) {
      ks = k_scale[pid];
      vs = v_scale[pid];
    }
    for (int d = lane; d < Dk; d += 32) {
#pragma unroll 8
      for (int t = 0; t < valid; ++t) {
        const float x = to_f(kp[(size_t)t * Hkv * Dk + d]);
        k_s[t * kstride + d] = kQuant ? x * ks : x;
      }
    }
    for (int d = lane; d < Dv; d += 32) {
#pragma unroll 8
      for (int t = 0; t < valid; ++t) {
        const float x = to_f(vp[(size_t)t * Hkv * Dv + d]);
        v_s[t * Dv + d] = kQuant ? x * vs : x;
      }
    }
    __syncwarp();
    // scores for every (head, valid token) of the page
    for (int i = lane; i < G * page; i += 32) {
      const int g = i / page, t = i - g * page;
      float s = kNegInf;
      if (t < valid) {
        s = 0.f;
        const float* qg = q_s + g * Dk;
        const float* kt = k_s + t * kstride;
        for (int d = 0; d < Dk; ++d) s += qg[d] * kt[d];
      }
      p_s[i] = s;
    }
    __syncwarp();
    // online-softmax bookkeeping, one lane per head
    for (int g = lane; g < G; g += 32) {
      float* pg = p_s + g * page;
      float mx = m_s[g];
      for (int t = 0; t < valid; ++t) mx = fmaxf(mx, pg[t]);
      const float corr = expf(m_s[g] - mx);
      float sum = 0.f;
      for (int t = 0; t < valid; ++t) {
        const float p = expf(pg[t] - mx);
        pg[t] = p;
        sum += p;
      }
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = mx;
      c_s[g] = corr;
    }
    __syncwarp();
    // acc = acc * corr + p @ v
    for (int g = 0; g < G; ++g) {
      const float* pg = p_s + g * page;
      const float corr = c_s[g];
      for (int d = lane; d < Dv; d += 32) {
        float a = acc_s[g * Dv + d] * corr;
        for (int t = 0; t < valid; ++t) a += pg[t] * v_s[t * Dv + d];
        acc_s[g * Dv + d] = a;
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // merge the warps' partial states by their log-sum-exp (a warp that took
  // no page has m = -1e30, l = 0, acc = 0 and weighs nothing; warp 0 always
  // took page 0, so the merged max is finite)
  const size_t acc_off = (size_t)page * kstride + (size_t)page * Dv + (size_t)G * page;
  for (int i = tid; i < G * (Dv + 1); i += blockDim.x) {
    // i < G*Dv: output element (g, d); else the lse of head i - G*Dv
    const int g = i < G * Dv ? i / Dv : i - G * Dv;
    float mx = kNegInf;
    for (int w = 0; w < nwarps; ++w)
      mx = fmaxf(mx, w_s[w * wfl + acc_off + G * Dv + g]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      const float* acc_w = w_s + w * wfl + acc_off;   // then m [G], l [G]
      const float e = expf(acc_w[G * Dv + g] - mx);
      l += acc_w[G * Dv + G + g] * e;
      if (i < G * Dv) a += acc_w[i] * e;
    }
    if (i < G * Dv)
      out[o_base + i] = from_f<Tq>(a / fmaxf(l, 1e-30f));
    else
      lse[(size_t)n * Hq + h * G + g] = mx + logf(fmaxf(l, 1e-30f));
  }
}

template <typename Tq, typename Tkv>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const void* bt, const void* len, void* out,
           void* lse, int N, int Hq, int Hkv, int Dk, int Dv, int page, int MB,
           float scale, cudaStream_t stream) {
  if (sizeof(Tkv) == 1 && (ks == nullptr || vs == nullptr))
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  // the card's opt-in shared memory per block, read once per instantiation
  static int optin = 0;
  cudaError_t e;
  if (optin == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
  }
  // as many warps (up to kMaxWarps) as their shared state fits
  const size_t q_bytes = sizeof(float) * (size_t)G * Dk;
  const size_t w_bytes = sizeof(float) * warp_floats(G, Dk, Dv, page);
  int nwarps = kMaxWarps;
  while (nwarps > 1 && q_bytes + nwarps * w_bytes > (size_t)optin) --nwarps;
  const size_t smem = q_bytes + nwarps * w_bytes;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  // this instantiation's shared-memory opt-in (the static is per <Tq, Tkv>)
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(paged_decode_kernel<Tq, Tkv>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid(N, Hkv);
  paged_decode_kernel<Tq, Tkv><<<grid, 32 * nwarps, smem, stream>>>(
      static_cast<const Tq*>(q), static_cast<const Tkv*>(k),
      static_cast<const Tkv*>(v), ks, vs, static_cast<const int32_t*>(bt),
      static_cast<const int32_t*>(len), static_cast<Tq*>(out),
      static_cast<float*>(lse), Hq, Hkv, Dk, Dv, page, MB, scale);
  return (int)cudaGetLastError();
}

template <typename Tq>
int launch_q(int kv_type, const void* q, const void* k, const void* v,
             const float* ks, const float* vs, const void* bt, const void* len,
             void* out, void* lse, int N, int Hq, int Hkv, int Dk, int Dv,
             int page, int MB, float scale, cudaStream_t s) {
  switch (kv_type) {
    case 0:
      return launch<Tq, Tq>(q, k, v, ks, vs, bt, len, out, lse, N, Hq, Hkv, Dk,
                            Dv, page, MB, scale, s);
    case 1:
      return launch<Tq, __nv_fp8_e4m3>(q, k, v, ks, vs, bt, len, out, lse, N,
                                       Hq, Hkv, Dk, Dv, page, MB, scale, s);
    case 2:
      return launch<Tq, int8_t>(q, k, v, ks, vs, bt, len, out, lse, N, Hq, Hkv,
                                Dk, Dv, page, MB, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_type: 0 = float32, 1 = bfloat16 (q and out).  kv_type: 0 = pages in
// q's type (k_scale/v_scale unused), 1 = fp8 e4m3 codes, 2 = int8 codes
// (k_scale/v_scale [P] float32 required).  Returns cudaGetLastError() after
// the launch (0 on success).  The caller checks shapes, types, contiguity.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scale,
                            const void* v_scale, const void* block_tables,
                            const void* lengths, void* out, void* lse, int N,
                            int Hq, int Hkv, int Dk, int Dv, int page, int MB,
                            float scale, int q_type, int kv_type, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if (q_type == 0)
    return launch_q<float>(kv_type, q, k_pages, v_pages, ks, vs, block_tables,
                           lengths, out, lse, N, Hq, Hkv, Dk, Dv, page, MB,
                           scale, s);
  if (q_type == 1)
    return launch_q<__nv_bfloat16>(kv_type, q, k_pages, v_pages, ks, vs,
                                   block_tables, lengths, out, lse, N, Hq, Hkv,
                                   Dk, Dv, page, MB, scale, s);
  return (int)cudaErrorInvalidValue;
}
