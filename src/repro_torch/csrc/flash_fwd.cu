// Causal flash-attention forward with LSE output, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_fwd_kernel (wrappers _flash_fwd /
// flash_attention).  Semantics are those of the plain torch version
// src/repro_torch/kernels/ref.py::flash_attention for every row that sees
// at least one key:
//
//   q      [B, Sq, Hq, Dk]
//   k      [B, Skv, Hkv, Dk]      GQA: q head h reads kv head h*Hkv/Hq
//   v      [B, Skv, Hkv, Dv]      Dv may differ from Dk
//   kv_len [B] int32              keys at or past kv_len are masked
//   out    [B, Sq, Hq, Dv]        q's dtype
//   lse    [B, Hq, Sq] float32
//
// Causal mask: query row r (absolute position r + q_offset) sees key c iff
// r + q_offset >= c.  A row that sees no key at all (kv_len == 0) gives
// out = 0, as the Pallas kernel does (the plain version averages v there).
//
// Design.  One block per (q tile of kBQ rows, q head, batch), with a loop
// over kv tiles of kBK keys inside the block (the sequential kv grid axis
// of the Pallas kernel becomes this loop).  The loop stops at the last kv
// tile the tile's last query row can see and at kv_len (causal skip), and
// ragged tails of Sq and Skv are masked in the kernel, so the caller never
// pads.  Q, K and V tiles are staged in float32 shared memory; each warp
// owns kBQ/4 query rows: for the scores its lanes are the kBK = 32 keys of
// the tile, so the row max and sum are warp shuffles, and for the
// accumulator its lanes walk the head dim.  The running accumulator lives
// in shared memory; the loops use no runtime division.  Prefill attention
// at these lengths is bound by its operations (2*Sq*Skv*(Dk+Dv)/2 flops
// against a few MB of q/k/v), and this first version does them on CUDA
// cores in float32; tensor cores (wgmma) and a TMA-fed pipeline are the
// step that makes it fast.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 32;        // query rows per block
constexpr int kBK = 32;        // keys per kv tile (= warp size)
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory layout (floats):
//   q_s   [kBQ][Dk]       scaled queries of the tile
//   k_s   [kBK][Dk + 1]   one K tile (rows padded against bank conflicts)
//   v_s   [kBK][Dv]       one V tile
//   p_s   [kBQ][kBK + 1]  scores, then probabilities
//   acc_s [kBQ][Dv]       running accumulator
//   m_s, l_s, c_s [kBQ]   running max, running sum, this tile's correction
template <typename T>
__global__ void flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const int32_t* __restrict__ kv_len,
                                 T* __restrict__ out, float* __restrict__ lse,
                                 int Sq, int Skv, int Hq, int Hkv, int Dk, int Dv,
                                 float scale, int causal, int q_offset) {
  extern __shared__ float smem[];
  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h * Hkv / Hq;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kstride = Dk + 1;
  const int pstride = kBK + 1;

  float* q_s = smem;
  float* k_s = q_s + kBQ * Dk;
  float* v_s = k_s + kBK * kstride;
  float* p_s = v_s + kBK * Dv;
  float* acc_s = p_s + kBQ * pstride;
  float* m_s = acc_s + kBQ * Dv;
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int q0 = iq * kBQ;
  const int rows = min(kBQ, Sq - q0);
  const int klen = min(kv_len[b], Skv);
  // causal skip: keys past the tile's last visible position never load
  int kend = klen;
  if (causal) kend = min(kend, max(q0 + rows - 1 + q_offset + 1, 0));
  const int ntiles = (kend + kBK - 1) / kBK;

  // warp w owns query rows w, w + kWarps, ...; lanes walk the head dim
  for (int r = warp; r < kBQ; r += kWarps) {
    if (r < rows) {
      const T* qr = q + (((size_t)b * Sq + q0 + r) * Hq + h) * Dk;
      for (int d = lane; d < Dk; d += 32) q_s[r * Dk + d] = to_f(qr[d]) * scale;
    } else {
      for (int d = lane; d < Dk; d += 32) q_s[r * Dk + d] = 0.f;
    }
    for (int d = lane; d < Dv; d += 32) acc_s[r * Dv + d] = 0.f;
  }
  for (int r = tid; r < kBQ; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    for (int c = warp; c < kBK; c += kWarps) {
      const bool in = k0 + c < kend;
      const size_t row = ((size_t)b * Skv + k0 + c) * Hkv + hk;
      for (int d = lane; d < Dk; d += 32) k_s[c * kstride + d] = in ? to_f(k[row * Dk + d]) : 0.f;
      for (int d = lane; d < Dv; d += 32) v_s[c * Dv + d] = in ? to_f(v[row * Dv + d]) : 0.f;
    }
    __syncthreads();
    // each warp: rows warp, warp + kWarps, ...; lane = key column
    for (int r = warp; r < kBQ; r += kWarps) {
      const int kc = k0 + lane;
      bool ok = (r < rows) && (kc < klen);
      if (causal) ok = ok && (q0 + r + q_offset >= kc);
      float s = kNegInf;
      if (ok) {
        s = 0.f;
        const float* qr = q_s + r * Dk;
        const float* kr = k_s + lane * kstride;
        for (int d = 0; d < Dk; ++d) s += qr[d] * kr[d];
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      p_s[r * pstride + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncwarp();
    // acc = acc * corr + p @ v for the warp's own rows
    for (int r = warp; r < kBQ; r += kWarps) {
      const float* pr = p_s + r * pstride;
      const float corr = c_s[r];
      for (int d = lane; d < Dv; d += 32) {
        float a = acc_s[r * Dv + d] * corr;
        for (int c = 0; c < kBK; ++c) a += pr[c] * v_s[c * Dv + d];
        acc_s[r * Dv + d] = a;
      }
    }
    __syncthreads();
  }

  for (int r = warp; r < rows; r += kWarps) {
    T* orow = out + (((size_t)b * Sq + q0 + r) * Hq + h) * Dv;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    for (int d = lane; d < Dv; d += 32) orow[d] = from_f<T>(acc_s[r * Dv + d] * inv);
  }
  for (int r = tid; r < rows; r += blockDim.x)
    lse[((size_t)b * Hq + h) * Sq + q0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int Dk,
           int Dv, float scale, int causal, int q_offset, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBQ * Dk + (size_t)kBK * (Dk + 1) + (size_t)kBK * Dv +
       (size_t)kBQ * (kBK + 1) + (size_t)kBQ * Dv + 3 * (size_t)kBQ);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(kv_len), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Skv, Hq, Hkv, Dk, Dv, scale, causal, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).  The caller checks shapes, types and contiguity.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* kv_len, void* out, void* lse, int B, int Sq,
                         int Skv, int Hq, int Hkv, int Dk, int Dv, float scale,
                         int causal, int q_offset, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, kv_len, out, lse, B, Sq, Skv, Hq, Hkv, Dk, Dv,
                         scale, causal, q_offset, s);
  return launch<__nv_bfloat16>(q, k, v, kv_len, out, lse, B, Sq, Skv, Hq, Hkv, Dk,
                               Dv, scale, causal, q_offset, s);
}
