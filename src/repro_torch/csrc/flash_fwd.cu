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
// out = 0 and lse = -1e30, as the Pallas kernel does (the plain version
// averages v there).
//
// What bounds it: operations.  A causal prefill over S tokens does about
// 2*S*S*(Dk+Dv)/2 flops per head against O(S*(Dk+Dv)) bytes, far above the
// card's flop/byte balance, so the products must run from registers and
// tensor cores, not from shared memory.  Both variants share one shape: a
// block takes a q tile of one (batch, head) and loops over 64-key kv tiles
// (the Pallas kernel's sequential kv grid axis), stops at the tile's causal
// limit and at kv_len, and masks ragged Sq/Skv itself, so the caller never
// pads.  K/V tiles come in through a ring of cp.async copies (16 bytes
// where the head dim and base allow, else element by element; three
// stages in bf16 up to head dim 128, else two): loading the next tiles
// overlaps computing on this one.  Shared memory only stages
// tiles; the accumulators, running max and running sum stay in registers.
//
// * bfloat16: two consumer warpgroups, 64 q rows each (a 128-row tile).
//   S = Q.K^T and O += P.V run on the tensor cores as wgmma m64n64k16 (bf16
//   in, f32 accumulate): Q, K and V are read from 128-byte-swizzled shared
//   memory through matrix descriptors (V with the transpose bit), P comes
//   from the S accumulators rounded to bf16 in registers.  The softmax
//   scale is applied to S in f32 after the product.  Head dims are
//   zero-padded in shared memory to the instantiation's width (64, 128 or
//   256).
// * float32: CUDA cores (TF32 would break the 1e-4 tolerance).  A 64-row
//   tile; 256 threads each own a 4x4 micro-tile of S (4 rows x 4 keys) and
//   the same 4 rows x 4*NG columns of O in registers.  Q, K and V rows are
//   padded to 16-byte multiples, so every shared-memory read is a 16-byte
//   load of four consecutive dims: 8 FMAs per load instruction in both
//   products.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBQ = 64;   // q rows per f32 block
constexpr int kBK = 64;   // keys per kv tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The kv tiles a block walks: keys past the tile's last visible position
// (causal) and past kv_len never load.
struct Span {
  int rows;    // valid q rows of the tile
  int klen;    // keys the batch has
  int kend;    // keys the tile can see
  int ntiles;
};
__device__ __forceinline__ Span span(int q0, int bq, int Sq, int Skv, int kv_len,
                                     int causal, int q_offset) {
  Span sp;
  sp.rows = min(bq, Sq - q0);
  sp.klen = min(kv_len, Skv);
  sp.kend = sp.klen;
  if (causal) sp.kend = min(sp.kend, max(q0 + sp.rows + q_offset, 0));
  sp.ntiles = sp.kend > 0 ? (sp.kend + kBK - 1) / kBK : 0;
  return sp;
}

// 2^x by the special-function unit (relative error about 2^-22)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool visible(int row, int key, int klen, int causal, int q_offset) {
  return key < klen && (!causal || row + q_offset >= key);
}
// every key of the kv tile at k0 is visible to every row from row0 on
__device__ __forceinline__ bool tile_visible(int row0, int k0, int klen, int causal,
                                             int q_offset) {
  return k0 + kBK <= klen && (!causal || row0 + q_offset >= k0 + kBK - 1);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* kv_len;
  void* out;
  float* lse;
  int Sq, Skv, Hq, Hkv, Dk, Dv;
  float scale;
  int causal, q_offset;
  int vec_q, vec_k, vec_v;   // 16-byte copies allowed for each tensor
};

// ------------------------------------------------------------------------ //
// bfloat16: tensor cores (wgmma)
// ------------------------------------------------------------------------ //
constexpr int kWBQ = 128;   // q rows per bf16 block: two warpgroups of 64

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory (cp.async, stores) become visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64x64] += A[64x16] . B[16x64]: A (Q) and B (K^T) from shared memory,
// both K-major
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
// d[64x64] += A[64x16] . B[16x64]: A (P) from registers, B (V) from shared
// memory, MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Tiles use the 128-byte swizzle that the wgmma descriptors name: a
// [R][kD] bf16 tile is kD/64 panels of [R][64], each row 128 bytes, its
// 16-byte chunk c stored at chunk c ^ (row & 7); every panel starts on a
// 1024-byte boundary.  Byte offset of chunk c (0 .. kD/8) of row r:
template <int R>
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return (uint32_t)((c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand at p:
// 8-row groups 1024 bytes apart (the stride byte offset; the leading byte
// offset, unused with 64-wide operands, is set the same).
__device__ __forceinline__ uint64_t gmma_desc(const char* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [0, R) of a tile: row r from src + r*stride (elements), valid
// for r < nvalid, D real columns; everything else zero-filled.
template <int R, int kD>
__device__ __forceinline__ void load_tile_bf16(char* dst, const __nv_bfloat16* src,
                                               long long stride, int nvalid, int D, bool vec,
                                               int tid) {
  constexpr int C = kD / 8;
  for (int i = tid; i < R * C; i += 256) {
    const int r = i / C, c = i % C, e0 = c * 8;
    char* d = dst + swz128<R>(r, c);
    const bool rv = r < nvalid;
    if (vec) {
      const int bytes = rv ? min(max(D - e0, 0), 8) * 2 : 0;
      cp_async16(d, bytes ? src + r * stride + e0 : src, bytes);
    } else {
      __nv_bfloat16* de = reinterpret_cast<__nv_bfloat16*>(d);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        de[e] = (rv && e0 + e < D) ? src[r * stride + e0 + e] : __float2bfloat16(0.f);
    }
  }
}

// K/V ring depth of the bf16 kernel: three tiles where shared memory allows
__host__ __device__ constexpr int bf16_stages(int kD) { return kD <= 128 ? 3 : 2; }

// Two consumer warpgroups, 64 q rows each, share the block's K/V ring.
// S = Q.K^T: wgmma with Q and K from shared memory; O += P.V: wgmma with P
// from registers (the S accumulators rounded to bf16) and V from shared
// memory through the descriptor's transpose bit.  Head dims are padded
// with zeros to kD (64, 128 or 256), one 64-column panel per wgmma.
template <int kD>
__global__ void __launch_bounds__(256) flash_fwd_bf16(const Params p) {
  constexpr int kP = kD / 64;      // panels
  constexpr int kKS = kD / 16;     // k-steps of Q.K^T
  constexpr int kStages = bf16_stages(kD);
  extern __shared__ char smem_raw[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  char* q_s = smem_raw + ((1024 - (s0 & 1023)) & 1023);   // [kP][128][64]
  char* k_s = q_s + kWBQ * kD * 2;                         // [kStages][kP][64][64]
  char* v_s = k_s + kStages * kBK * kD * 2;                // [kStages][kP][64][64]

  const int iq = gridDim.x - 1 - blockIdx.x;   // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h * p.Hkv / p.Hq;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int q0 = iq * kWBQ;
  const Span sp = span(q0, kWBQ, p.Sq, p.Skv, p.kv_len[b], p.causal, p.q_offset);

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            (((size_t)b * p.Sq + q0) * p.Hq + h) * p.Dk;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            ((size_t)b * p.Skv * p.Hkv + hk) * p.Dk;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            ((size_t)b * p.Skv * p.Hkv + hk) * p.Dv;
  const long long kstride = (long long)p.Hkv * p.Dk, vstride = (long long)p.Hkv * p.Dv;

  // the ring: tiles 0 .. kStages-2 in flight before the loop
  load_tile_bf16<kWBQ, kD>(q_s, qg, (long long)p.Hq * p.Dk, sp.rows, p.Dk, p.vec_q, tid);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < sp.ntiles) {
      load_tile_bf16<kBK, kD>(k_s + st * kBK * kD * 2, kg + st * kBK * kstride, kstride,
                              sp.kend - st * kBK, p.Dk, p.vec_k, tid);
      load_tile_bf16<kBK, kD>(v_s + st * kBK * kD * 2, vg + st * kBK * vstride, vstride,
                              sp.kend - st * kBK, p.Dv, p.vec_v, tid);
    }
    cp_async_commit();
  }

  // this lane's rows of its warp's 16: g and g + 8; its columns 2t, 2t+1
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * 64 + warp * 16 + g;
  float o[kP][32];
#pragma unroll
  for (int pn = 0; pn < kP; ++pn)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[pn][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl2 = p.scale * kLog2e;
  const char* qw = q_s + wg * 64 * 128;   // this warpgroup's 64 rows

  for (int it = 0; it < sp.ntiles; ++it) {
    const int k0 = it * kBK;
    cp_async_wait<kStages - 2>();   // tile it has landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();   // ... everyone's, visible to wgmma; tile it-1's slot is free
    const int nt = it + kStages - 1;
    if (nt < sp.ntiles) {
      const int nb = nt % kStages;
      load_tile_bf16<kBK, kD>(k_s + nb * kBK * kD * 2, kg + nt * kBK * kstride, kstride,
                              sp.kend - nt * kBK, p.Dk, p.vec_k, tid);
      load_tile_bf16<kBK, kD>(v_s + nb * kBK * kD * 2, vg + nt * kBK * vstride, vstride,
                              sp.kend - nt * kBK, p.Dv, p.vec_v, tid);
    }
    cp_async_commit();
    const char* kt = k_s + (it % kStages) * kBK * kD * 2;
    const char* vt = v_s + (it % kStages) * kBK * kD * 2;

    // S = Q . K^T: 64 rows x 64 keys per warpgroup
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks)
      wgmma_ss(s, gmma_desc(qw + (ks >> 2) * (kWBQ * 128) + (ks & 3) * 32),
               gmma_desc(kt + (ks >> 2) * (kBK * 128) + (ks & 3) * 32));
    wg_commit();
    wg_wait0();

    // online softmax in the log2 domain; rows g (i = 0) and g + 8 (i = 1).
    // Only a tile that crosses kv_len or the causal diagonal is masked, in
    // one block of code that the other tiles skip.
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] *= sl2;
    if (!tile_visible(q0 + wg * 64, k0, sp.klen, p.causal, p.q_offset)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = k0 + (e >> 2) * 8 + 2 * t + (e & 1);
        if (!visible(row0 + 8 * ((e >> 1) & 1), key, sp.klen, p.causal, p.q_offset))
          s[e] = -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = fast_exp2(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
    const float base[2] = {m[0] == kNegInf ? 0.f : m[0], m[1] == kNegInf ? 0.f : m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float pe = fast_exp2(s[e] - base[(e >> 1) & 1]);
      s[e] = pe;
      l[(e >> 1) & 1] += pe;
    }
#pragma unroll
    for (int pn = 0; pn < kP; ++pn)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[pn][e] *= corr[(e >> 1) & 1];

    // O += P . V, 16 keys per step, one wgmma per 64-column panel
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int pn = 0; pn < kP; ++pn)
        wgmma_rs(o[pn], a[kk], gmma_desc(vt + pn * (kBK * 128) + kk * 16 * 128));
    wg_commit();
    wg_wait0();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg * 64 + warp * 16 + g + 8 * i;
    if (r >= sp.rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = og + (((size_t)b * p.Sq + q0 + r) * p.Hq + h) * p.Dv;
#pragma unroll
    for (int pn = 0; pn < kP; ++pn)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = pn * 64 + j * 8 + 2 * t;
        if (c < p.Dv) orow[c] = __float2bfloat16(o[pn][4 * j + 2 * i] * inv);
        if (c + 1 < p.Dv) orow[c + 1] = __float2bfloat16(o[pn][4 * j + 2 * i + 1] * inv);
      }
    if (t == 0)
      p.lse[((size_t)b * p.Hq + h) * p.Sq + q0 + r] =
          m[i] == kNegInf ? kNegInf : m[i] * kLn2 + logf(fmaxf(l[i], 1e-30f));
  }
}

// ------------------------------------------------------------------------ //
// float32: CUDA cores, register-tiled
// ------------------------------------------------------------------------ //
// Stage rows [0, 64) of a tile into a [64][ld] float tile: row r from
// src + r*stride, valid for r < nvalid, D real columns, zero-filled up to
// round4(D).  vec: 16-byte copies (D % 4 == 0, aligned base), else 4-byte.
__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const float* src,
                                              long long stride, int nvalid, int D, bool vec,
                                              int tid) {
  const int D4 = (D + 3) >> 2;
  if (vec) {
    for (int i = tid; i < kBQ * D4; i += 256) {
      const int r = i / D4, c = i - r * D4;
      const int bytes = r < nvalid ? 16 : 0;
      cp_async16(dst + r * ld + 4 * c, bytes ? src + r * stride + 4 * c : src, bytes);
    }
  } else {
    for (int i = tid; i < kBQ * D4 * 4; i += 256) {
      const int r = i / (D4 * 4), e = i - r * D4 * 4;
      const int bytes = (r < nvalid && e < D) ? 4 : 0;
      cp_async4(dst + r * ld + e, bytes ? src + r * stride + e : src, bytes);
    }
  }
}

// Shared memory (floats): q_s [64][ldk], k_s [ns][64][ldk], v_s [ns][64][ldv],
// p_s [64][68].  ldk = round4(Dk) + 4 (a warp's 4-dim reads of 8 keys fall
// in 8 bank groups), ldv = round4(Dv).  Thread (ty, tx) = (tid/16, tid%16)
// owns rows ty*4 + i and keys tx + 16*j of S, and rows ty*4 + i x columns
// 64*c + 4*tx .. +3 of O.
template <int NG>
__global__ void __launch_bounds__(256) flash_fwd_f32(const Params p, int ns) {
  extern __shared__ __align__(16) float smem_f[];
  const int ldk = ((p.Dk + 3) & ~3) + 4;
  const int ldv = (p.Dv + 3) & ~3;
  constexpr int ldp = kBK + 4;
  float* q_s = smem_f;
  float* k_s = q_s + kBQ * ldk;
  float* v_s = k_s + ns * kBK * ldk;
  float* p_s = v_s + ns * kBK * ldv;

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h * p.Hkv / p.Hq;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q0 = iq * kBQ;
  const Span sp = span(q0, kBQ, p.Sq, p.Skv, p.kv_len[b], p.causal, p.q_offset);

  const float* qg = static_cast<const float*>(p.q) + (((size_t)b * p.Sq + q0) * p.Hq + h) * p.Dk;
  const float* kg = static_cast<const float*>(p.k) + ((size_t)b * p.Skv * p.Hkv + hk) * p.Dk;
  const float* vg = static_cast<const float*>(p.v) + ((size_t)b * p.Skv * p.Hkv + hk) * p.Dv;
  const long long kstride = (long long)p.Hkv * p.Dk, vstride = (long long)p.Hkv * p.Dv;

  load_tile_f32(q_s, ldk, qg, (long long)p.Hq * p.Dk, sp.rows, p.Dk, p.vec_q, tid);
  if (sp.ntiles > 0) {
    load_tile_f32(k_s, ldk, kg, kstride, sp.kend, p.Dk, p.vec_k, tid);
    load_tile_f32(v_s, ldv, vg, vstride, sp.kend, p.Dv, p.vec_v, tid);
  }
  cp_async_commit();

  float o[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NG; ++c) o[i][c][0] = o[i][c][1] = o[i][c][2] = o[i][c][3] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const float sl2 = p.scale * kLog2e;
  const int Dk4 = (p.Dk + 3) >> 2;

  for (int it = 0; it < sp.ntiles; ++it) {
    const int k0 = it * kBK;
    if (ns == 2 && it + 1 < sp.ntiles) {
      const int nb = (it + 1) & 1;
      load_tile_f32(k_s + nb * kBK * ldk, ldk, kg + (k0 + kBK) * kstride, kstride,
                    sp.kend - k0 - kBK, p.Dk, p.vec_k, tid);
      load_tile_f32(v_s + nb * kBK * ldv, ldv, vg + (k0 + kBK) * vstride, vstride,
                    sp.kend - k0 - kBK, p.Dv, p.vec_v, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = ns == 2 ? (it & 1) : 0;
    const float* kt = k_s + buf * kBK * ldk;
    const float* vt = v_s + buf * kBK * ldv;

    // S micro-tile: rows ty*4 + i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    for (int d4 = 0; d4 < Dk4; ++d4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * ldk + 4 * d4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kt + (tx + 16 * j) * ldk + 4 * d4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // online softmax in the log2 domain; a row's 64 keys span 16 lanes.
    // Only a tile that crosses kv_len or the causal diagonal is masked.
    const bool full = tile_visible(q0, k0, sp.klen, p.causal, p.q_offset);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        s[i][j] *= sl2;
        if (!full && !visible(row, key, sp.klen, p.causal, p.q_offset)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = fast_exp2(m[i] - mx);
      m[i] = mx;
      const float base = mx == kNegInf ? 0.f : mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pe = fast_exp2(s[i][j] - base);
        p_s[(ty * 4 + i) * ldp + tx + 16 * j] = pe;
        sum += pe;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < NG; ++c) {
        o[i][c][0] *= corr; o[i][c][1] *= corr;
        o[i][c][2] *= corr; o[i][c][3] *= corr;
      }
    }
    __syncthreads();

    // O += P . V, four keys at a time
    for (int kc = 0; kc < kBK; kc += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty * 4 + i) * ldp + kc);
#pragma unroll
      for (int c = 0; c < NG; ++c) {
        const int col = 64 * c + 4 * tx;
        if (col >= ldv) continue;
        float4 vv[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          vv[kk] = *reinterpret_cast<const float4*>(vt + (kc + kk) * ldv + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pk[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            o[i][c][0] = fmaf(pk[kk], vv[kk].x, o[i][c][0]);
            o[i][c][1] = fmaf(pk[kk], vv[kk].y, o[i][c][1]);
            o[i][c][2] = fmaf(pk[kk], vv[kk].z, o[i][c][2]);
            o[i][c][3] = fmaf(pk[kk], vv[kk].w, o[i][c][3]);
          }
        }
      }
    }
    __syncthreads();
    if (ns == 1 && it + 1 < sp.ntiles) {
      load_tile_f32(k_s, ldk, kg + (k0 + kBK) * kstride, kstride, sp.kend - k0 - kBK, p.Dk,
                    p.vec_k, tid);
      load_tile_f32(v_s, ldv, vg + (k0 + kBK) * vstride, vstride, sp.kend - k0 - kBK, p.Dv,
                    p.vec_v, tid);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  float* og = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int r = ty * 4 + i;
    if (r >= sp.rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = og + (((size_t)b * p.Sq + q0 + r) * p.Hq + h) * p.Dv;
#pragma unroll
    for (int c = 0; c < NG; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * tx + e;
        if (col < p.Dv) orow[col] = o[i][c][e] * inv;
      }
    }
    if (tx == 0)
      p.lse[((size_t)b * p.Hq + h) * p.Sq + q0 + r] =
          m[i] == kNegInf ? kNegInf : m[i] * kLn2 + logf(fmaxf(l[i], 1e-30f));
  }
}

// ------------------------------------------------------------------------ //
// launch
// ------------------------------------------------------------------------ //
int optin_smem() {
  static int optin = 0;
  if (optin == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
        cudaSuccess)
      return 0;
  }
  return optin;
}

// opt the kernel into `smem` bytes of dynamic shared memory if it needs more
// than it was last given (smem_set is per instantiation)
template <typename K>
int set_smem(K kernel, size_t smem, size_t& smem_set) {
  if (smem > smem_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  return 0;
}

template <int kD>
int launch_bf16(const Params& p, int B, cudaStream_t s) {
  static size_t smem_set = 48 * 1024;
  // Q, the K/V ring, and room to align the tiles to 1024 bytes
  const size_t smem = 2 * (size_t)kD * (kWBQ + 2 * bf16_stages(kD) * kBK) + 1024;
  if (smem > (size_t)optin_smem()) return (int)cudaErrorInvalidValue;
  const int rc = set_smem(flash_fwd_bf16<kD>, smem, smem_set);
  if (rc) return rc;
  dim3 grid((p.Sq + kWBQ - 1) / kWBQ, p.Hq, B);
  flash_fwd_bf16<kD><<<grid, 256, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int NG>
int launch_f32(const Params& p, int B, cudaStream_t s) {
  static size_t smem_set = 48 * 1024;
  const size_t ldk = ((p.Dk + 3) & ~3) + 4, ldv = (p.Dv + 3) & ~3;
  const size_t fixed = kBQ * ldk + (size_t)kBQ * (kBK + 4);
  const size_t stage = kBK * (ldk + ldv);
  int ns = 2;
  if (sizeof(float) * (fixed + 2 * stage) > (size_t)optin_smem()) ns = 1;
  const size_t smem = sizeof(float) * (fixed + ns * stage);
  if (smem > (size_t)optin_smem()) return (int)cudaErrorInvalidValue;
  const int rc = set_smem(flash_fwd_f32<NG>, smem, smem_set);
  if (rc) return rc;
  dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
  flash_fwd_f32<NG><<<grid, 256, smem, s>>>(p, ns);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).  The caller checks shapes, types and contiguity
// (head dims up to 256).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kv_len,
                         void* out, void* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                         int Dk, int Dv, float scale, int causal, int q_offset, int dtype,
                         void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{};
  p.q = q; p.k = k; p.v = v;
  p.kv_len = static_cast<const int32_t*>(kv_len);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.Sq = Sq; p.Skv = Skv; p.Hq = Hq; p.Hkv = Hkv; p.Dk = Dk; p.Dv = Dv;
  p.scale = scale; p.causal = causal; p.q_offset = q_offset;
  const int es = dtype == 0 ? 4 : 2;
  const int vec_elems = 16 / es;   // a 16-byte copy's elements
  auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  p.vec_q = Dk % vec_elems == 0 && aligned(q);
  p.vec_k = Dk % vec_elems == 0 && aligned(k);
  p.vec_v = Dv % vec_elems == 0 && aligned(v);
  const int D = Dk > Dv ? Dk : Dv;
  if (dtype == 0) {
    if (Dv <= 64) return launch_f32<1>(p, B, s);
    if (Dv <= 128) return launch_f32<2>(p, B, s);
    if (Dv <= 192) return launch_f32<3>(p, B, s);
    return launch_f32<4>(p, B, s);
  }
  if (D <= 64) return launch_bf16<64>(p, B, s);
  if (D <= 128) return launch_bf16<128>(p, B, s);
  return launch_bf16<256>(p, B, s);
}
