// The decode step's routed expert FFN over the rows routed to each expert,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the decode experts to
// XLA (src/repro/core/moe_parallel.py::moe_decode_ffn, dispatch, three
// batched products over capacity bins, combine).  The port ran the same
// algorithm as three torch.bmm over [E, I*C, D] bins.  Decode sizes every
// (instance, expert) bin at C rows, and the configurations that drop no
// token (capacity factor E/k) make C the slot bucket M.  So those products
// computed I*C rows per expert where I*M*k/E are routed on average, and
// every expert's weights were read whether a row reached it or not.
// Semantics are those of src/repro_torch/kernels/moe_experts.py::plain:
//
//   x         [I*T, D]      the layer's rows, instance-major (T per instance)
//   w         [I*T, k]      float32 router weights of each row's k experts
//   src_token [I, E*C]      int32: bin (i, e) slot j holds row src of
//                           instance i (T = an empty slot); kept rows fill
//                           each bin from its first slot
//   slot_of   [I*T, k]      int32: the slot e*C + j of each (row, choice),
//                           E*C for a dropped one
//   wi_gate, wi_up [E, D, F], wo [E, F, D]   the experts' weights
//   out       [I*T, D]      sum over the k choices of w * expert output
//   fill      [I, E]        int32: the kept rows of each bin
//
// Types: x, the weights, out and the gated activations h are T (float or
// bfloat16); every sum is float32, and the expert outputs y are float32.
//
// What bounds it: the weights of the experts that some row reached, each
// read once (about 315 MB an expert for Phi-3.5-MoE in float32, 176 MB
// for DeepSeek-V3).  At decode sizes an expert sees a few rows, about
// 2 flops per weight byte per row in float32, far below what the CUDA
// cores sustain, so the products stay on CUDA cores (float32 has no
// tensor-core path with TF32 off).  An expert that many rows reach (the
// idle slots of a bucket all carry the same token, so they pile onto the
// same k experts) is bound by FFMA instead.  Four launches on the caller's
// stream, none synchronising with the host:
//
// 1. plan_kernel (one block) counts each bin's rows from src_token, scans
//    the counts in (expert, instance) order into boff [E*I + 1], and lists
//    each compact row's x row: expert e's rows are [boff[e*I],
//    boff[(e+1)*I]), bin (i, e)'s slot j is compact row boff[e*I + i] + j.
// 2. expert_gemm_kernel<T, gated> (grid: column tiles of 64 x E) computes
//    silu(x @ wi_gate[e]) * (x @ wi_up[e]) on the expert's compact rows
//    into h [R, F], R = I*T*k.  A block whose expert has no row returns
//    before it reads a weight byte.  Otherwise it streams its [K, 64]
//    weight tiles in 32-row stages through a ring of cp.async copies (four
//    stages where two blocks fit an SM) together with the same K range of
//    its rows; each staged weight value is read once into registers and
//    multiplied into the rows a thread holds.  The 256 threads split as 16
//    column groups of 4 times 16 lanes, and the lanes split into g row
//    groups and 16/g slices of K, summed in slice order through shared
//    memory at the end.  The rows a thread holds follow the expert's row
//    count, read on the device: up to 8 rows, one group of 1, 2, 4 or 8
//    (so an expert with one row does one row's FFMA, not eight), more
//    rows g groups of 8 (g the least power of two that covers them).  A
//    bin holds at most I*C rows: up to 128 rows an expert are one pass over
//    its weights, more take a pass per 128.
// 3. The same kernel, not gated, computes y = h @ wo[e] on the same
//    compact rows.
// 4. combine_kernel writes each row's sum over its k choices, in choice
//    order, of w times its slot's y row: no atomics, so every result is
//    the same from run to run.
//
// Static shapes and no allocation: the caller passes the scratch (boff
// and rows, h, y), so a CUDA graph can hold the four launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;           // 8 warps per GEMM block
constexpr int kBN = 64;                 // output columns per block
constexpr int kBK = 32;                 // K rows per ring stage
constexpr int kCG = kBN / 4;            // column groups of 4 per block
constexpr int kLanes = kThreads / kCG;  // (row group, K slice) lanes per column group
constexpr int kRT = 8;                  // rows per thread
constexpr int kMaxRows = kLanes * kRT;  // rows per pass over the weights
constexpr int kXPad = 16;               // bytes after each staged row (spreads banks)
constexpr int kMaxStages = 4;
constexpr int kSmemTwoBlocks = 113 * 1024;  // a block's share when two fit an SM
constexpr int kPlanThreads = 1024;
constexpr int kMaxK = 64;               // experts per row the combine takes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive values at p (16-byte aligned for float, 8 for bfloat16)
template <typename T> __device__ __forceinline__ float4 load4(const char* p);
template <> __device__ __forceinline__ float4 load4<float>(const char* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<__nv_bfloat16>(const char* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T> __device__ __forceinline__ void store4(T* p, float4 v);
template <> __device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&a);
  w.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

// a 16-byte cp.async; an invalid piece is zero-filled and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most n of this thread's groups are pending (n < kMaxStages)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// ---------------------------------------------------------------------------
// 1. the plan: bin counts, their scan, each compact row's x row
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kPlanThreads) plan_kernel(
    const int32_t* __restrict__ src, int I, int E, int C, int T,
    int32_t* __restrict__ fill, int32_t* __restrict__ boff, int32_t* __restrict__ rows) {
  __shared__ int s_scan[kPlanThreads];
  const int B = E * I;                       // bins in (expert, instance) order
  const int per = (B + kPlanThreads - 1) / kPlanThreads;
  const int b0 = threadIdx.x * per, b1 = min(b0 + per, B);
  int local = 0;
  for (int b = b0; b < b1; ++b) {
    const int e = b / I, i = b - e * I;
    const int32_t* s = src + ((size_t)i * E + e) * C;
    int n = 0;
    for (int j = 0; j < C; ++j) n += s[j] < T;
    fill[i * E + e] = n;
    local += n;
  }
  // inclusive scan of the threads' counts (Hillis-Steele)
  s_scan[threadIdx.x] = local;
  __syncthreads();
  for (int off = 1; off < kPlanThreads; off <<= 1) {
    const int v = threadIdx.x >= off ? s_scan[threadIdx.x - off] : 0;
    __syncthreads();
    s_scan[threadIdx.x] += v;
    __syncthreads();
  }
  int base = s_scan[threadIdx.x] - local;
  for (int b = b0; b < b1; ++b) {
    const int e = b / I, i = b - e * I;
    const int32_t* s = src + ((size_t)i * E + e) * C;
    boff[b] = base;
    for (int j = 0; j < C; ++j)
      if (s[j] < T) rows[base++] = i * T + s[j];
  }
  if (threadIdx.x == kPlanThreads - 1) boff[B] = s_scan[kPlanThreads - 1];
}

// ---------------------------------------------------------------------------
// 2, 3. one expert's rows against a 64-column tile of its weights
// ---------------------------------------------------------------------------
struct GemmArgs {
  const char* in;         // gated: x [*, K]; else h [R, K] (T)
  const int32_t* rows;    // gated: the x row of each compact row; else null
  const int32_t* boff;    // [E*I + 1]
  const char* w1;         // [E, K, N] (T): wi_gate, or wo
  const char* w2;         // gated: wi_up [E, K, N]; else null
  void* out;              // gated: h [R, N] (T); else y [R, N] float
  int I, K, N;
  int rpass;              // rows staged per pass: a power of two, 8..kMaxRows
  int stages;             // ring depth, 2..kMaxStages
  int stage_bytes;
};

// One pass over the expert's [K, 64] weight tile for its compact rows
// [p0, p0 + np), np <= rpass: g row groups of kR rows (g * kR >= np), the
// 16 lanes of a column group split into the g groups and 16/g K slices.
template <typename T, bool kGated, int kR>
__device__ __forceinline__ void gemm_pass(const GemmArgs& a, char* smem, int32_t* s_rows,
                                          int e, int r0, int p0, int np, int g) {
  constexpr int es = (int)sizeof(T);
  constexpr int kMats = kGated ? 2 : 1;
  constexpr int kWRow = kBN * es;            // bytes of a staged weight row
  constexpr int kWTile = kBK * kWRow;        // bytes of a stage's tile of one matrix
  constexpr int kWPieces = kWRow / 16;       // 16-byte pieces per weight row
  constexpr int kXRow = kBK * es + kXPad;    // bytes of a staged row of the input
  constexpr int kXPieces = kBK * es / 16;
  constexpr int kGroups = kBK / 4;           // 4-row K groups per stage
  float* red = reinterpret_cast<float*>(smem);   // the K slices' sums reuse the ring

  const int tid = threadIdx.x;
  const int cg = tid % kCG, lane = tid / kCG;
  const int nks = kLanes / g;                // K slices
  const int rg = lane % g, ks = lane / g;
  const int used = g * kR;                   // staged rows; those >= np are zeros
  const int c0 = blockIdx.x * kBN;
  const size_t wbase = (size_t)e * a.K * a.N * es;
  const char* w1 = a.w1 + wbase;
  const char* w2 = kGated ? a.w2 + wbase : nullptr;
  const int nk = (a.K + kBK - 1) / kBK;

  __syncthreads();                           // the last pass is done with smem
  for (int r = tid; r < used; r += kThreads)
    s_rows[r] = r >= np ? -1 : a.rows ? a.rows[r0 + p0 + r] : r0 + p0 + r;
  __syncthreads();

  auto load_stage = [&](int slot, int kc) {
    char* st = smem + slot * a.stage_bytes;
    const int k0 = kc * kBK;
#pragma unroll
    for (int m = 0; m < kMats; ++m) {
      const char* w = m ? w2 : w1;
      for (int p = tid; p < kBK * kWPieces; p += kThreads) {
        const int kr = p / kWPieces, pc = p - kr * kWPieces;
        const int k = k0 + kr, col = c0 + pc * (16 / es);
        const bool ok = k < a.K && col < a.N;
        cp_async16(st + m * kWTile + kr * kWRow + pc * 16,
                   ok ? w + ((size_t)k * a.N + col) * es : w, ok);
      }
    }
    char* xs = st + kMats * kWTile;
    for (int p = tid; p < used * kXPieces; p += kThreads) {
      const int r = p / kXPieces, pc = p - r * kXPieces;
      const int k = k0 + pc * (16 / es), src = s_rows[r];
      const bool ok = src >= 0 && k < a.K;
      cp_async16(xs + r * kXRow + pc * 16,
                 ok ? a.in + ((size_t)src * a.K + k) * es : a.in, ok);
    }
  };

  float acc[kMats][kR][4];
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int rr = 0; rr < kR; ++rr)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][rr][c] = 0.f;

  for (int s = 0; s < a.stages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait(a.stages - 2);             // stage kc has landed
    __syncthreads();                         // and stage kc - 1 is free
    const int nx = kc + a.stages - 1;
    if (nx < nk) load_stage(nx % a.stages, nx);
    cp_async_commit();
    const char* st = smem + (kc % a.stages) * a.stage_bytes;
    const char* xs = st + kMats * kWTile;
    // this lane's 4-row groups: global group kc*kGroups + q, q = ks mod nks
    for (int q = ((ks - kc * kGroups) % nks + nks) % nks; q < kGroups; q += nks) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int kr = q * 4 + kk;
        const float4 wa = load4<T>(st + kr * kWRow + cg * 4 * es);
        float4 wb = wa;
        if (kGated) wb = load4<T>(st + kWTile + kr * kWRow + cg * 4 * es);
#pragma unroll
        for (int rr = 0; rr < kR; ++rr) {
          const float xv =
              to_f(*reinterpret_cast<const T*>(xs + (rr * g + rg) * kXRow + kr * es));
          acc[0][rr][0] = fmaf(xv, wa.x, acc[0][rr][0]);
          acc[0][rr][1] = fmaf(xv, wa.y, acc[0][rr][1]);
          acc[0][rr][2] = fmaf(xv, wa.z, acc[0][rr][2]);
          acc[0][rr][3] = fmaf(xv, wa.w, acc[0][rr][3]);
          if (kGated) {
            acc[kMats - 1][rr][0] = fmaf(xv, wb.x, acc[kMats - 1][rr][0]);
            acc[kMats - 1][rr][1] = fmaf(xv, wb.y, acc[kMats - 1][rr][1]);
            acc[kMats - 1][rr][2] = fmaf(xv, wb.z, acc[kMats - 1][rr][2]);
            acc[kMats - 1][rr][3] = fmaf(xv, wb.w, acc[kMats - 1][rr][3]);
          }
        }
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();

  // the K slices' partial sums: red[m][ks][row][col], row = rr*g + rg
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int rr = 0; rr < kR; ++rr)
      *reinterpret_cast<float4*>(
          red + (((size_t)m * nks + ks) * used + rr * g + rg) * kBN + cg * 4) =
          make_float4(acc[m][rr][0], acc[m][rr][1], acc[m][rr][2], acc[m][rr][3]);
  __syncthreads();
  for (int o = tid; o < np * kCG; o += kThreads) {
    const int row = o / kCG, c4 = (o - row * kCG) * 4;
    if (c0 + c4 >= a.N) continue;
    float4 v[kMats];
#pragma unroll
    for (int m = 0; m < kMats; ++m) {
      v[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < nks; ++s) {
        const float4 p = *reinterpret_cast<const float4*>(
            red + (((size_t)m * nks + s) * used + row) * kBN + c4);
        v[m].x += p.x; v[m].y += p.y; v[m].z += p.z; v[m].w += p.w;
      }
    }
    const size_t at = (size_t)(r0 + p0 + row) * a.N + c0 + c4;
    if (kGated) {
      const float4 gt = v[0], up = v[kMats - 1];
      const float4 h = make_float4(gt.x / (1.f + expf(-gt.x)) * up.x,
                                   gt.y / (1.f + expf(-gt.y)) * up.y,
                                   gt.z / (1.f + expf(-gt.z)) * up.z,
                                   gt.w / (1.f + expf(-gt.w)) * up.w);
      store4<T>(static_cast<T*>(a.out) + at, h);
    } else {
      store4<float>(static_cast<float*>(a.out) + at, v[0]);
    }
  }
}

template <typename T, bool kGated>
__global__ void __launch_bounds__(kThreads, 2) expert_gemm_kernel(const GemmArgs a) {
  extern __shared__ __align__(16) char smem[];
  const int e = blockIdx.y;
  const int r0 = a.boff[e * a.I];
  const int n = a.boff[(e + 1) * a.I] - r0;
  if (n == 0) return;     // no row reached this expert: no weight byte is read
  int32_t* s_rows = reinterpret_cast<int32_t*>(
      smem + max(a.stages * a.stage_bytes, (kGated ? 2 : 1) * kMaxRows * kBN * 4));
  for (int p0 = 0; p0 < n; p0 += a.rpass) {
    const int np = min(n - p0, a.rpass);
    // up to kRT rows: one row group of the fewest rows (a power of two)
    // that hold them, every other lane a K slice; more: groups of kRT
    if (np <= 1) {
      gemm_pass<T, kGated, 1>(a, smem, s_rows, e, r0, p0, np, 1);
    } else if (np <= 2) {
      gemm_pass<T, kGated, 2>(a, smem, s_rows, e, r0, p0, np, 1);
    } else if (np <= 4) {
      gemm_pass<T, kGated, 4>(a, smem, s_rows, e, r0, p0, np, 1);
    } else {
      int g = 1;
      while (g * kRT < np) g <<= 1;
      gemm_pass<T, kGated, kRT>(a, smem, s_rows, e, r0, p0, np, g);
    }
  }
}

// ---------------------------------------------------------------------------
// 4. each row's gate-weighted sum of its slots' expert outputs
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256) combine_kernel(
    const float* __restrict__ y, const float* __restrict__ w,
    const int32_t* __restrict__ slot_of, const int32_t* __restrict__ boff, int I, int T_,
    int E, int C, int k, int D, T* __restrict__ out) {
  __shared__ int s_c[kMaxK];
  __shared__ float s_w[kMaxK];
  const int row = blockIdx.x, i = row / T_;
  if (threadIdx.x < k) {
    const int s = slot_of[(size_t)row * k + threadIdx.x];
    s_c[threadIdx.x] = s < E * C ? boff[(s / C) * I + i] + s % C : -1;
    s_w[threadIdx.x] = w[(size_t)row * k + threadIdx.x];
  }
  __syncthreads();
  for (int d = threadIdx.x * 4; d < D; d += blockDim.x * 4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int kk = 0; kk < k; ++kk) {
      if (s_c[kk] < 0) continue;               // a dropped choice adds nothing
      const float4 v = *reinterpret_cast<const float4*>(y + (size_t)s_c[kk] * D + d);
      const float g = s_w[kk];
      acc.x = fmaf(g, v.x, acc.x);
      acc.y = fmaf(g, v.y, acc.y);
      acc.z = fmaf(g, v.z, acc.z);
      acc.w = fmaf(g, v.w, acc.w);
    }
    store4<T>(out + (size_t)row * D + d, acc);
  }
}

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

template <typename T, bool kGated>
cudaError_t launch_gemm(GemmArgs a, int E, int N, cudaStream_t stream) {
  constexpr int es = (int)sizeof(T);
  constexpr int kMats = kGated ? 2 : 1;
  a.stage_bytes = kMats * kBK * kBN * es + a.rpass * (kBK * es + kXPad);
  // the deepest ring that leaves room for two blocks an SM, at least two stages
  a.stages = kMaxStages;
  while (a.stages > 2 && a.stages * a.stage_bytes > kSmemTwoBlocks) --a.stages;
  const size_t smem = (size_t)std::max(a.stages * a.stage_bytes, kMats * kMaxRows * kBN * 4) +
                      kMaxRows * sizeof(int32_t);
  if (smem > (size_t)optin_smem()) return cudaErrorInvalidValue;
  static size_t smem_set = 48 * 1024;   // per instantiation
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        expert_gemm_kernel<T, kGated>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  dim3 grid((N + kBN - 1) / kBN, E);
  expert_gemm_kernel<T, kGated><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, const void* src_token, const void* slot_of,
           const void* wi_gate, const void* wi_up, const void* wo, void* fill, void* plan,
           void* h, void* y, void* out, int I, int T_, int E, int C, int k, int D, int F,
           cudaStream_t stream) {
  int32_t* boff = static_cast<int32_t*>(plan);
  int32_t* rows = boff + E * I + 1;
  plan_kernel<<<1, kPlanThreads, 0, stream>>>(static_cast<const int32_t*>(src_token), I, E,
                                              C, T_, static_cast<int32_t*>(fill), boff, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int rpass = 8;                         // the most rows a bin can hold, I*C, up to 128
  while (rpass < I * C && rpass < kMaxRows) rpass *= 2;
  GemmArgs a{};
  a.boff = boff;
  a.I = I;
  a.rpass = rpass;
  a.in = static_cast<const char*>(x);
  a.rows = rows;
  a.w1 = static_cast<const char*>(wi_gate);
  a.w2 = static_cast<const char*>(wi_up);
  a.out = h;
  a.K = D;
  a.N = F;
  e = launch_gemm<T, true>(a, E, F, stream);
  if (e != cudaSuccess) return (int)e;
  a.in = static_cast<const char*>(h);
  a.rows = nullptr;
  a.w1 = static_cast<const char*>(wo);
  a.w2 = nullptr;
  a.out = y;
  a.K = F;
  a.N = D;
  e = launch_gemm<T, false>(a, E, D, stream);
  if (e != cudaSuccess) return (int)e;
  combine_kernel<T><<<I * T_, 256, 0, stream>>>(
      static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<const int32_t*>(slot_of), boff, I, T_, E, C, k, D, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, the weights, h and out).  plan
// holds E*I + 1 + I*T*k int32 (boff, then the compact rows' x rows), h
// I*T*k*F values of the dtype, y I*T*k*D float32.  Every tensor is
// contiguous and 16-byte aligned; D and F are multiples of 8; k <= 64.
// Returns cudaGetLastError() after the launches (0 on success).  The
// caller checks shapes, types and layouts.
extern "C" int moe_experts(const void* x, const void* w, const void* src_token,
                           const void* slot_of, const void* wi_gate, const void* wi_up,
                           const void* wo, void* fill, void* plan, void* h, void* y,
                           void* out, int I, int T, int E, int C, int k, int D, int F,
                           int dtype, void* stream) {
  if (I * T == 0) return 0;
  if (E < 1 || C < 1 || k < 1 || k > kMaxK || D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, src_token, slot_of, wi_gate, wi_up, wo, fill, plan, h, y, out,
                         I, T, E, C, k, D, F, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, src_token, slot_of, wi_gate, wi_up, wo, fill, plan, h,
                                 y, out, I, T, E, C, k, D, F, s);
  return (int)cudaErrorInvalidValue;
}
