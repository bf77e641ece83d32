// Paged decode attention with LSE output, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py::_kernel
// (wrapper paged_decode_attention).  Semantics are those of the plain torch
// version src/repro_torch/kernels/ref.py::paged_decode_attention:
//
//   q            [N, Hq, Dk]         one query token per work row
//   k_pages      [P, page, Hkv, Dk]  any page/token/head strides, last dim 1
//   v_pages      [P, page, Hkv, Dv]  its own strides (may be a view of k)
//   block_tables [N, MB]  int32      page ids per row
//   lengths      [N]      int32      valid kv tokens per row; 0 -> inactive
//   out          [N, Hq, Dv]         q's dtype
//   lse          [N, Hq]  float32    -1e30 for an inactive row
//   k_scale, v_scale [P]  float32    per-page scales, quantized pools only;
//                                    both null: raw codes, a unit scale
//
// The G = Hq / Hkv query heads of kv head h are q[n, h*G : (h+1)*G].  Head
// dims go up to 640: MLA decodes over one latent "head" of kv_lora_rank +
// rope dims (MiniCPM3-4B: 256 + 32 = 288, G = 40 q heads, v the view
// k[..., :256]; DeepSeek-V3: 512 + 64 = 576, G = 128, v = k[..., :512]).
//
// Types: q and out are Tq (float or bfloat16).  Pages are Tkv: Tq itself,
// or a quantized pool of fp8 e4m3 or int8 codes with one float32 scale per
// page (src/repro_torch/kernels/quant.py).
//
// What bounds it: the K/V bytes (1 per value in a quantized pool).  One
// query row per kv head does about 2*G flops per K/V element, far below
// the ~295 flop/byte at which the H100's tensor cores would become the
// limit, so the products stay on CUDA cores.  To move bytes at the card's
// rate the design keeps many pages in flight on every SM:
//
// * Split-KV and head groups.  The grid is (N, Hkv * HG, S): block
//   (n, h * HG + j, s) takes q heads [j*gh, (j+1)*gh) of kv head h's G and
//   pages [s*pps, (s+1)*pps) of row n.  The wrapper picks the heads per
//   group (gh; HG = ceil(G / gh) groups) and the pages per split (pps) from
//   the static shapes: gh so that a group's accumulators and q fit one
//   block (all G heads but at DeepSeek-V3's G 128 x Dv 512, which takes 4
//   groups of 32, each reading the row's pages again, mostly from L2), pps
//   so that full rows give several blocks per SM.  For S > 1 the blocks write float32 partials (out [N,Hq,S,Dv], lse
//   [N,Hq,S]) into the caller's scratch and merge_kernel, launched from the
//   same C entry, merges them by their log-sum-exp into out (q's dtype) and
//   lse, as ref.merge_lse does.  A split at or past its row's length is
//   empty (out 0, lse -1e30): its block writes the lse and exits, and the
//   merge skips it.  For S == 1 the first kernel writes the result itself.
// * A ring of pages in flight.  A block of 8 warps walks its split in
//   units of 32 tokens (a unit may span pages, whose ids and scales the
//   block loads into shared memory once).  Up to three units sit in a
//   shared-memory ring, filled by cp.async copies of 16 bytes (16 fp8/int8
//   codes, 8 bf16 or 4 f32 values; 8 or 4 bytes where the strides are not
//   16-byte multiples), a warp per token and its lanes over the token's K
//   and V rows, while the block computes on the oldest.  Shared memory
//   stages K and V and passes scores and probabilities between the three
//   steps of a unit; every staged value is read once into registers,
//   where q, the partial dots and the (head, 4-column) accumulators live.
//   Where v is a view of k (MLA's latent pool), each token's latent row is
//   staged once and V is read as its first Dv values: half the ring.
// * Latency, not bytes, sets the time at decode sizes: a split walks a
//   few units one after another, so each unit's steps, its copies
//   included, are spread over all 256 threads, and its loops stay rolled.
// * Fused dequant.  A quantized unit is read from the ring as raw codes;
//   each token's page's k scale multiplies its score and its v scale its
//   probability, so no dequantized pool exists in device memory.
// * Wide heads.  Each score lane dots kChunks 4-value chunks of a K row
//   (a template parameter: 2 up to Dk 256, 3 up to Dk 384, 5 up to Dk 640)
//   against kHeads heads' q held in registers (8 heads, 4 at 5 chunks), so
//   MLA's 288- and 576-wide latents keep q in registers as the narrow
//   heads do; the ring drops to two stages where three do not fit the
//   shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kUnit = 32;       // tokens per ring stage: one per lane
constexpr int kPS = kUnit + 4;  // p_s row stride: a pass's heads, 8 bank groups
constexpr int kMaxStages = 3;   // ring depth
constexpr int kMaxPairs = 16;   // (head, 4-column) accumulators per thread
constexpr int kMaxChunks = 5;   // 4-value K chunks per score lane: Dk <= 640
constexpr int kThreads = 256;   // 8 warps per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive values (columns 4*d4 .. 4*d4+3) of a row staged in
// shared memory, as float32; quantized codes are returned unscaled.
template <typename T> __device__ __forceinline__ float4 load4(const char* row, int d4);
template <> __device__ __forceinline__ float4 load4<float>(const char* row, int d4) {
  return *reinterpret_cast<const float4*>(row + 16 * d4);
}
template <> __device__ __forceinline__ float4 load4<__nv_bfloat16>(const char* row, int d4) {
  const uint2 w = *reinterpret_cast<const uint2*>(row + 8 * d4);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
template <> __device__ __forceinline__ float4 load4<__nv_fp8_e4m3>(const char* row, int d4) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * d4);
  __nv_fp8_e4m3 c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i].__x = static_cast<__nv_fp8_storage_t>((w >> (8 * i)) & 0xffu);
  return make_float4(static_cast<float>(c[0]), static_cast<float>(c[1]),
                     static_cast<float>(c[2]), static_cast<float>(c[3]));
}
template <> __device__ __forceinline__ float4 load4<int8_t>(const char* row, int d4) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * d4);
  return make_float4(static_cast<float>(static_cast<int8_t>(w & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu)),
                     static_cast<float>(static_cast<int8_t>((w >> 16) & 0xffu)),
                     static_cast<float>(static_cast<int8_t>(w >> 24)));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// cp.async of `bytes` (<= gran) bytes into a gran-byte slot, zero-filling
// the rest; gran is 16, 8 or 4 and both addresses are gran-aligned.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int gran, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (gran == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
  else if (gran == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most n of this thread's groups are pending (n < kMaxStages)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::); break;
  }
}

struct Args {
  const void* q;
  const char* k;          // byte pointers; strides below are in bytes
  const char* v;
  const float* k_scale;
  const float* v_scale;
  const int32_t* bt;
  const int32_t* len;
  void* out;
  float* lse;
  float* part_out;        // S > 1: [N][Hq][S][Dv]
  float* part_lse;        //        [N][Hq][S]
  long long k_sp, k_st, k_sh, v_sp, v_st, v_sh;
  int Hq, Hkv, Dk, Dv, page, MB, pps, S;
  int gh, HG;             // q heads per group, groups per kv head
  int shared_kv;          // v is a view of k: each latent row is staged once
  int nstages;            // ring depth, 2..kMaxStages
  int gran;               // cp.async size in bytes: 16, 8 or 4
  int tpt;                // scores: lanes per token (kChunks*tpt 4-value chunks cover Dk)
  int tgroups;            // p @ v: token groups (kThreads / tgroups threads each)
  int page_shift;         // log2(page) when page is a power of two, else -1
  int rowk, rowv;         // bytes of one staged K / V row (16-byte multiples;
                          // rowv = rowk where shared_kv)
  int stage_bytes;        // one ring stage: kUnit K rows (and V rows)
  int head_bytes;         // shared bytes before the ring
  float scale;
};

// Tokens of the split [t_begin, t_end) of a row; empty when the split
// starts at or past the row's length.
__device__ __forceinline__ int2 split_tokens(const Args& a, int length, int s) {
  const int t_begin = s * a.pps * a.page;
  const int t_end = min(min(length, a.MB * a.page), min((s + 1) * a.pps, a.MB) * a.page);
  return make_int2(t_begin, t_end);
}

// Block (n, h * HG + j, s): tokens [t_begin, t_end) of row n, the G q
// heads [j*gh, j*gh + G) of kv head h (G = gh but in a last, smaller
// group), walked by kThreads threads in units of kUnit tokens (a unit may
// span pages).  Per unit, three steps with a barrier after each:
//  - scores: threads (token, dim lane) dot each staged K value once
//    against kHeads heads' q held in registers (kChunks 4-value chunks per
//    lane) and sum across their lanes by shuffles;
//  - softmax: a warp per head, lane = token, with the running max and sum
//    in shared memory;
//  - p @ v: thread (token group, pair) accumulates a (head, 4-column) pair
//    of the output over its group's tokens, in registers; the lanes of a
//    warp run over the heads, so a staged V value is read once per group.
// The groups' accumulators are summed once, at the end.  Every loop that
// runs once per unit stays rolled, so the unit's code is small.
//
// Shared memory: q_s [gh][Dk4*4] f32 (q*scale, zero-padded), p_s [gh][kPS]
// scores, then probabilities (times the v scale), c_s [gh] this unit's
// corrections, m_s and l_s [gh] the running max and sum, bt_s [pps] the
// split's page ids, ks_s/vs_s [pps] their scales; then the ring: nstages x
// (K [kUnit][rowk], V [kUnit][rowv]), or K alone where V is its view.
template <typename Tq, typename Tkv, int kPairs, int kChunks>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(const Args a) {
  constexpr bool kQuant = sizeof(Tkv) == 1;
  constexpr int kWarps = kThreads / 32;
  constexpr int kHeads = kChunks > 3 ? 4 : 8;   // q heads per score pass
  extern __shared__ __align__(16) char smem[];
  const int n = blockIdx.x;
  const int h = blockIdx.y / a.HG;
  const int hg = blockIdx.y - h * a.HG;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Dk4 = (a.Dk + 3) >> 2;
  const int Dv4 = (a.Dv + 3) >> 2;
  const int hq0 = h * (a.Hq / a.Hkv) + hg * a.gh;     // the group's first q head
  const int G = min(a.gh, a.Hq / a.Hkv - hg * a.gh);  // the group's q heads
  const int npairs = G * Dv4;
  const int b0 = s * a.pps;                        // the split's first page
  const int npg = min(a.pps, a.MB - b0);

  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + a.gh * Dk4 * 4;
  float* c_s = p_s + a.gh * kPS;
  float* m_s = c_s + a.gh;
  float* l_s = m_s + a.gh;
  int* bt_s = reinterpret_cast<int*>(l_s + a.gh);
  float* ks_s = reinterpret_cast<float*>(bt_s + a.pps);
  float* vs_s = ks_s + a.pps;
  char* ring = smem + a.head_bytes;

  // the page ids load beside the length, not after it
  const int32_t* bt = a.bt + (size_t)n * a.MB + b0;
  for (int i = tid; i < npg; i += kThreads) bt_s[i] = bt[i];
  const int2 span = split_tokens(a, a.len[n], s);
  const int t_begin = span.x, t_end = span.y;

  if (t_begin >= t_end) {
    // an empty split: lse -1e30, out 0 (a partial's out is never read
    // where its lse is -1e30)
    if (a.S == 1) {
      Tq* out = static_cast<Tq*>(a.out) + ((size_t)n * a.Hq + hq0) * a.Dv;
      for (int i = tid; i < G * a.Dv; i += kThreads) out[i] = from_f<Tq>(0.f);
      for (int g = tid; g < G; g += kThreads) a.lse[(size_t)n * a.Hq + hq0 + g] = kNegInf;
    } else {
      for (int g = tid; g < G; g += kThreads)
        a.part_lse[((size_t)n * a.Hq + hq0 + g) * a.S + s] = kNegInf;
    }
    return;
  }
  __syncthreads();   // bt_s

  const int stage_bytes = a.stage_bytes;
  const int voff = a.shared_kv ? 0 : kUnit * a.rowk;   // V rows in a stage
  const int nunits = (t_end - t_begin + kUnit - 1) / kUnit;
  const int kbytes = a.Dk * (int)sizeof(Tkv);
  const int vbytes = a.Dv * (int)sizeof(Tkv);
  const int kch = ((kbytes + 15) & ~15) / a.gran;   // copies per staged row
  const int vch = a.shared_kv ? 0 : ((vbytes + 15) & ~15) / a.gran;

  // stage unit u into ring slot st: a warp per token, its lanes over the
  // token's K and V chunks; only valid tokens are copied (and read)
  auto issue = [&](int u, int st) {
    const int t0 = t_begin + u * kUnit;
    const int valid = min(kUnit, t_end - t0);
    char* sk = ring + st * stage_bytes;
    char* sv = sk + voff;
#pragma unroll 1
    for (int t = warp; t < valid; t += kWarps) {
      const int tok = t0 + t;
      const int b = a.page_shift >= 0 ? tok >> a.page_shift : tok / a.page;
      const long long pid = bt_s[b - b0];
      const long long off = tok - b * a.page;
      const char* kr = a.k + pid * a.k_sp + off * a.k_st + (long long)h * a.k_sh;
      const char* vr = a.v + pid * a.v_sp + off * a.v_st + (long long)h * a.v_sh;
#pragma unroll 1
      for (int c = lane; c < kch + vch; c += 32) {
        const bool is_k = c < kch;
        const int cc = is_k ? c : c - kch;
        const int bytes = min(max((is_k ? kbytes : vbytes) - cc * a.gran, 0), a.gran);
        const char* src = (is_k ? kr : vr) + (bytes ? cc * a.gran : 0);
        cp_async((is_k ? sk + t * a.rowk : sv + t * a.rowv) + cc * a.gran, src, a.gran, bytes);
      }
    }
  };

  const int NS = a.nstages;
  for (int u = 0; u < NS - 1; ++u) {
    if (u < nunits) issue(u, u);
    cp_async_commit();
  }
  if constexpr (kQuant) {
    for (int i = tid; i < npg; i += kThreads) {
      // raw codes (no scales): each page's scale is 1
      ks_s[i] = a.k_scale ? a.k_scale[bt_s[i]] : 1.f;
      vs_s[i] = a.v_scale ? a.v_scale[bt_s[i]] : 1.f;
    }
  }
  // q * scale, rounded to Tq as the plain version does before the product
  const Tq* qp = static_cast<const Tq*>(a.q) + ((size_t)n * a.Hq + hq0) * a.Dk;
  for (int i = tid; i < G * Dk4 * 4; i += kThreads) {
    const int g = i / (Dk4 * 4), d = i - g * (Dk4 * 4);
    q_s[i] = d < a.Dk ? to_f(from_f<Tq>(to_f(qp[g * a.Dk + d]) * a.scale)) : 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // the scores' layout: tpt lanes per token (a power of two)
  const int tpt = a.tpt;
  const int t_dim = tid / tpt, c_dim = tid - t_dim * tpt;
  // p @ v's layout: tgc token groups of P threads; pair r + j*P
  const int tgc = a.tgroups;
  const int P = kThreads / tgc;
  const int tg = tid / P, r = tid - tg * P;
  float acc[kPairs][4];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

#pragma unroll 1
  for (int u = 0; u < nunits; ++u) {
    cp_async_wait(NS - 2);   // unit u has landed (this thread's copies)
    __syncthreads();         // ... everyone's; slot (u-1)%NS and p_s are free
    if (u + NS - 1 < nunits) issue(u + NS - 1, (u + NS - 1) % NS);
    cp_async_commit();

    const char* sk = ring + (u % NS) * stage_bytes;
    const char* sv = sk + voff;
    const int t0 = t_begin + u * kUnit;
    const int valid = min(kUnit, t_end - t0);

    // scores: K row t's 4-value chunks c + e*tpt against kHeads heads' q
#pragma unroll 1
    for (int g0 = 0; g0 < G; g0 += kHeads) {
      float4 qr[kHeads][kChunks];
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
        for (int e = 0; e < kChunks; ++e) {
          const int d4 = c_dim + e * tpt;
          qr[hh][e] = g0 + hh < G && d4 < Dk4
                          ? reinterpret_cast<const float4*>(q_s)[(g0 + hh) * Dk4 + d4]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll 1
      for (int t = t_dim; t < kUnit; t += kThreads / tpt) {
        float sd[kHeads];
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) sd[hh] = 0.f;
        if (t < valid) {
#pragma unroll
          for (int e = 0; e < kChunks; ++e) {
            const int d4 = c_dim + e * tpt;
            if (d4 < Dk4) {
              const float4 x = load4<Tkv>(sk + t * a.rowk, d4);
#pragma unroll
              for (int hh = 0; hh < kHeads; ++hh) sd[hh] = dot4(qr[hh][e], x, sd[hh]);
            }
          }
        }
#pragma unroll 1
        for (int o = tpt >> 1; o > 0; o >>= 1)
#pragma unroll
          for (int hh = 0; hh < kHeads; ++hh) sd[hh] += __shfl_xor_sync(0xffffffffu, sd[hh], o);
        if (c_dim == 0) {
          float ksc = 1.f;
          if constexpr (kQuant)
            if (t < valid) ksc = ks_s[(t0 + t) / a.page - b0];
#pragma unroll
          for (int hh = 0; hh < kHeads; ++hh)
            if (g0 + hh < G) p_s[(g0 + hh) * kPS + t] = t < valid ? sd[hh] * ksc : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax of each head across the unit: a warp per head, lane =
    // token; p_s turns from scores into probabilities (times the v scale)
    float vsc = 1.f;
    if constexpr (kQuant)
      if (lane < valid) vsc = vs_s[(t0 + lane) / a.page - b0];
#pragma unroll 1
    for (int g = warp; g < G; g += kWarps) {
      const float x = p_s[g * kPS + lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float pr = lane < valid ? expf(x - m_new) : 0.f;
      const float corr = expf(m_old - m_new);
      const float sum = warp_sum(pr);
      p_s[g * kPS + lane] = pr * vsc;
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + sum;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v over the group's tokens, four at a time
    // (p_s holds 0 past `valid`)
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int i = r + j * P;
      if (i < npairs) {
        const int d4 = i / G, g = i - d4 * G;
        const float corr = c_s[g];
        const float* pg = p_s + g * kPS;
        float o0 = acc[j][0] * corr, o1 = acc[j][1] * corr;
        float o2 = acc[j][2] * corr, o3 = acc[j][3] * corr;
#pragma unroll 1
        for (int t = 4 * tg; t < valid; t += 4 * tgc) {
          const float4 p4 = *reinterpret_cast<const float4*>(pg + t);
          const float pk[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 x = t + e < valid ? load4<Tkv>(sv + (t + e) * a.rowv, d4)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
            o0 = fmaf(pk[e], x.x, o0);
            o1 = fmaf(pk[e], x.y, o1);
            o2 = fmaf(pk[e], x.z, o2);
            o3 = fmaf(pk[e], x.w, o3);
          }
        }
        acc[j][0] = o0;
        acc[j][1] = o1;
        acc[j][2] = o2;
        acc[j][3] = o3;
      }
    }
  }
  cp_async_wait(0);

  // sum the token groups' accumulators (tgc > 1 only with kPairs == 1)
  if (tgc > 1) {
    float4* red = reinterpret_cast<float4*>(ring);
    __syncthreads();   // the ring is free
    red[tid] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    __syncthreads();
    if (tg == 0) {
      for (int k = 1; k < tgc; ++k) {
        const float4 x = red[k * P + r];
        acc[0][0] += x.x;
        acc[0][1] += x.y;
        acc[0][2] += x.z;
        acc[0][3] += x.w;
      }
    }
  }

  // where head g's result goes: the final out/lse, or this split's partial
  auto row_of = [&](int g) { return (size_t)n * a.Hq + hq0 + g; };
  for (int g = tid; g < G; g += kThreads) {
    const float x = m_s[g] + logf(fmaxf(l_s[g], 1e-30f));
    if (a.S == 1)
      a.lse[row_of(g)] = x;
    else
      a.part_lse[row_of(g) * a.S + s] = x;
  }
  if (tg != 0) return;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int i = r + j * P;
    if (i < npairs) {
      const int d4 = i / G, g = i - d4 * G;
      const float inv = 1.f / fmaxf(l_s[g], 1e-30f);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * d4 + c;
        if (d >= a.Dv) break;
        if (a.S == 1)
          static_cast<Tq*>(a.out)[row_of(g) * a.Dv + d] = from_f<Tq>(acc[j][c] * inv);
        else
          a.part_out[(row_of(g) * a.S + s) * a.Dv + d] = acc[j][c] * inv;
      }
    }
  }
}

// Merge the S partials of each (row, q head) by their log-sum-exp, as
// ref.merge_lse: one thread per output element (and one per lse).  An
// empty split (lse -1e30) weighs nothing and its out is not read; a row
// whose splits are all empty gets out 0, lse -1e30.
template <typename Tq>
__global__ void merge_kernel(const Args a, int N) {
  const int per_row = a.Hq * (a.Dv + 1);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)N * per_row) return;
  const int n = (int)(idx / per_row);
  const int i = (int)(idx - (long long)n * per_row);
  const bool is_out = i < a.Hq * a.Dv;
  const int hq = is_out ? i / a.Dv : i - a.Hq * a.Dv;
  const int d = is_out ? i - hq * a.Dv : 0;
  const size_t row = (size_t)n * a.Hq + hq;
  const float* pl = a.part_lse + row * a.S;
  float m = kNegInf;
  for (int s = 0; s < a.S; ++s) m = fmaxf(m, pl[s]);
  const bool any = m > kNegInf;
  float l = 0.f, o = 0.f;
  for (int s = 0; any && s < a.S; ++s) {
    if (pl[s] <= kNegInf) continue;
    const float w = expf(pl[s] - m);
    l += w;
    if (is_out) o = fmaf(w, a.part_out[(row * a.S + s) * a.Dv + d], o);
  }
  if (is_out)
    static_cast<Tq*>(a.out)[row * a.Dv + d] = from_f<Tq>(any ? o / l : 0.f);
  else
    a.lse[row] = any ? m + logf(l) : kNegInf;
}

int round16(int x) { return (x + 15) & ~15; }

template <typename Tq, typename Tkv, int kPairs, int kChunks>
int launch(Args a, int N, cudaStream_t stream) {
  if (sizeof(Tkv) == 1 && ((a.k_scale == nullptr) != (a.v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int gh = a.gh;
  const int Dk4 = (a.Dk + 3) / 4, pairs = gh * ((a.Dv + 3) / 4);
  // the copy size: the largest of 16/8/4 bytes that every base and stride allow
  const uintptr_t al = reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v) |
                       (uintptr_t)a.k_sp | (uintptr_t)a.k_st | (uintptr_t)a.k_sh |
                       (uintptr_t)a.v_sp | (uintptr_t)a.v_st | (uintptr_t)a.v_sh;
  a.gran = (al % 16 == 0) ? 16 : (al % 8 == 0) ? 8 : (al % 4 == 0) ? 4 : 0;
  if (a.gran == 0) return (int)cudaErrorInvalidValue;
  a.page_shift = -1;
  for (int sh = 0; sh < 31; ++sh)
    if (a.page == (1 << sh)) a.page_shift = sh;
  for (a.tpt = 1; a.tpt < 32 && kChunks * a.tpt < Dk4;) a.tpt *= 2;
  if (kChunks * a.tpt < Dk4) return (int)cudaErrorInvalidValue;
  // token groups for p @ v: as many as idle threads allow, up to 8
  a.tgroups = 1;
  while (kPairs == 1 && a.tgroups < 8 && 2 * a.tgroups * pairs <= kThreads) a.tgroups *= 2;
  // one 16-byte pad per staged row spreads a warp's row reads over the banks
  a.rowk = round16(a.Dk * (int)sizeof(Tkv)) + 16;
  a.rowv = a.shared_kv ? a.rowk : round16(a.Dv * (int)sizeof(Tkv)) + 16;
  a.head_bytes = round16((int)sizeof(float) * (gh * Dk4 * 4 + gh * kPS + 3 * gh + 3 * a.pps));
  a.stage_bytes = kUnit * (a.rowk + (a.shared_kv ? 0 : a.rowv));
  const size_t stage = (size_t)a.stage_bytes;

  static int optin = 0;   // the card's opt-in shared memory per block
  cudaError_t e;
  if (optin == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
  }
  a.nstages = kMaxStages;
  while (a.nstages > 2 && a.head_bytes + a.nstages * stage > (size_t)optin) --a.nstages;
  // the epilogue sums the token groups' accumulators in the ring's space
  const size_t smem = a.head_bytes + std::max(a.nstages * stage, (size_t)16 * kThreads);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  static size_t smem_set = 48 * 1024;   // per instantiation
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(paged_split_kernel<Tq, Tkv, kPairs, kChunks>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid(N, a.Hkv * a.HG, a.S);
  paged_split_kernel<Tq, Tkv, kPairs, kChunks><<<grid, kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.S == 1) return (int)e;
  const long long total = (long long)N * a.Hq * (a.Dv + 1);
  merge_kernel<Tq><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(a, N);
  return (int)cudaGetLastError();
}

// 2, 3 or kMaxChunks 4-value K chunks per score lane: the fewest that
// cover Dk with at most 32 lanes per token
template <typename Tq, typename Tkv, int kPairs>
int launch_chunks(const Args& a, int N, cudaStream_t s) {
  const int Dk4 = (a.Dk + 3) / 4;
  if (Dk4 <= 2 * 32) return launch<Tq, Tkv, kPairs, 2>(a, N, s);
  if (Dk4 <= 3 * 32) return launch<Tq, Tkv, kPairs, 3>(a, N, s);
  if (Dk4 <= kMaxChunks * 32) return launch<Tq, Tkv, kPairs, kMaxChunks>(a, N, s);
  return (int)cudaErrorInvalidValue;
}

// 1, 4 or kMaxPairs (head, 4-column) accumulators per thread: the fewest
// that cover a group's gh * Dv/4 pairs (fewer registers, more blocks per SM)
template <typename Tq, typename Tkv>
int launch_shape(const Args& a, int N, cudaStream_t s) {
  const int pairs = a.gh * ((a.Dv + 3) / 4);
  if (pairs <= kThreads) return launch_chunks<Tq, Tkv, 1>(a, N, s);
  if (pairs <= 4 * kThreads) return launch_chunks<Tq, Tkv, 4>(a, N, s);
  if (pairs <= kMaxPairs * kThreads) return launch_chunks<Tq, Tkv, kMaxPairs>(a, N, s);
  return (int)cudaErrorInvalidValue;
}

template <typename Tq>
int launch_q(int kv_type, const Args& a, int N, cudaStream_t s) {
  switch (kv_type) {
    case 0: return launch_shape<Tq, Tq>(a, N, s);
    case 1: return launch_shape<Tq, __nv_fp8_e4m3>(a, N, s);
    case 2: return launch_shape<Tq, int8_t>(a, N, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_type: 0 = float32, 1 = bfloat16 (q and out).  kv_type: 0 = pages in
// q's type (k_scale/v_scale unused), 1 = fp8 e4m3 codes, 2 = int8 codes
// (k_scale/v_scale [P] float32, or both null for raw codes read with a
// unit scale).  Page strides are in elements of
// the page type; the last dim of each pool is contiguous.  pps is the
// number of pages per split; for S = ceil(MB / pps) > 1, scratch holds
// N*Hq*S*(Dv + 1) floats (the partials), else it may be null.  gh is the
// number of q heads per head group (1..G).  shared_kv = 1 says v_pages is
// a view of k_pages (same base and strides, Dv <= Dk): each row is then
// staged once.  Returns cudaGetLastError() after the launches (0 on
// success).  The caller checks shapes, types and layouts.
extern "C" int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                            const void* k_scale, const void* v_scale,
                            const void* block_tables, const void* lengths, void* out,
                            void* lse, void* scratch, int N, int Hq, int Hkv, int Dk,
                            int Dv, int page, int MB, int pps, int gh,
                            int shared_kv, long long k_sp,
                            long long k_st, long long k_sh, long long v_sp,
                            long long v_st, long long v_sh, float scale, int q_type,
                            int kv_type, void* stream) {
  if (N == 0) return 0;
  if (pps < 1 || MB < 1 || Hkv < 1 || Hq % Hkv || gh < 1 || gh > Hq / Hkv)
    return (int)cudaErrorInvalidValue;
  if (shared_kv && (k_pages != v_pages || k_sp != v_sp || k_st != v_st || k_sh != v_sh ||
                    Dv > Dk))
    return (int)cudaErrorInvalidValue;
  const long long es = kv_type == 0 ? (q_type == 0 ? 4 : 2) : 1;
  Args a{};
  a.q = q;
  a.k = static_cast<const char*>(k_pages);
  a.v = static_cast<const char*>(v_pages);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.bt = static_cast<const int32_t*>(block_tables);
  a.len = static_cast<const int32_t*>(lengths);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.k_sp = k_sp * es; a.k_st = k_st * es; a.k_sh = k_sh * es;
  a.v_sp = v_sp * es; a.v_st = v_st * es; a.v_sh = v_sh * es;
  a.Hq = Hq; a.Hkv = Hkv; a.Dk = Dk; a.Dv = Dv; a.page = page; a.MB = MB;
  a.pps = pps;
  a.S = (MB + pps - 1) / pps;
  a.gh = gh;
  a.HG = (Hq / Hkv + gh - 1) / gh;
  a.shared_kv = shared_kv;
  a.scale = scale;
  if (a.S > 1) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    a.part_out = static_cast<float*>(scratch);
    a.part_lse = a.part_out + (size_t)N * Hq * a.S * Dv;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_type == 0) return launch_q<float>(kv_type, a, N, s);
  if (q_type == 1) return launch_q<__nv_bfloat16>(kv_type, a, N, s);
  return (int)cudaErrorInvalidValue;
}
