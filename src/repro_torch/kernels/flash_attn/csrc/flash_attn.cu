// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (repro_torch/kernels/_build.py).
//
// flash_attn_fwd — replaces the TPU kernel
//   src/repro/kernels/flash_attn/flash_attn.py: flash_attention_fwd
//   -> _kernel.
// Online-softmax attention on the models' layout: q (B, Sq, KV, G, DH),
// k/v (B, Sk, KV, DH), pos_q (Sq,), pos_k (B, Sk), out like q. Query head
// (kv, g) reads kv head kv. Key j is seen by query i iff
// 0 <= pos_k[j] <= pos_q[i] and (window < 0 or pos_q[i] - pos_k[j] <
// window); an unseen key scores -1e30 (not -inf), exactly as in the
// reference, and the output is acc / max(l, 1e-30). All arithmetic is
// float32; q, k, v and out are bf16 or float32.
//
// Bound on the card: 4*DH multiply-adds per (query head, seen key) pair
// and the bytes of q, k, v, the positions and out. At the model's prefill
// (B 4, KV 8, G 4, Sq = Sk = 128) the work is ~0.5 GFLOP and ~2 MB, so
// either bound is a few microseconds; at decode (Sq 1, Sk ~144) the bytes
// of the cache bound it. This first kernel uses the CUDA cores in float32;
// tensor cores (wgmma) and TMA are later work.
//
// Design: the G query heads of one kv head are extra query rows: for a
// (b, kv) pair, row r is (query r / G, group r % G). A block owns BQ such
// rows of one (b, kv) and walks every key tile of BK keys: it stages K and
// V (float32) in shared memory, computes the BQ x BK scores (2 x 4 per
// thread), updates the running max m and denominator l per row (one warp
// per row, shuffles across the 32 keys of the tile), then rescales its
// BQ x DH accumulator (4 rows x DH/16 columns per thread, in registers) and
// adds P V. Score tiles never leave the SM, as in the Pallas kernel. So
// decode's Sq = 1 (G rows) and any Sk (the last tile masked) are handled
// by the same code. The K and V of a kv head are read once per block,
// shared by its G query heads.
//
// Every entry takes device pointers, sizes and the caller's stream,
// launches without synchronising, allocates nothing and returns
// cudaGetLastError() (or cudaErrorInvalidValue for sizes it refuses).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 32;   // keys per tile: one per lane in the softmax
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH
                          + kBQ * (kBK + 1) + 3 * kBQ)
         + sizeof(int) * (kBQ + kBK);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ pos_q,
                 const int* __restrict__ pos_k, T* __restrict__ out,
                 int sq, int sk, int kv_heads, int g, int window,
                 float scale) {
  static_assert(DH % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DJ = DH / 16;       // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                           // [kBQ][DH + 1]
  float* ks = qs + kBQ * (DH + 1);            // [kBK][DH + 1]
  float* vs = ks + kBK * (DH + 1);            // [kBK][DH]
  float* ps = vs + kBK * DH;                  // [kBQ][kBK + 1]
  float* m_s = ps + kBQ * (kBK + 1);          // [kBQ]
  float* l_s = m_s + kBQ;                     // [kBQ]
  float* corr_s = l_s + kBQ;                  // [kBQ]
  int* pq_s = reinterpret_cast<int*>(corr_s + kBQ);  // [kBQ]
  int* pk_s = pq_s + kBQ;                            // [kBK]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.y;                  // b * kv_heads + kv
  const int b = bh / kv_heads, kvh = bh % kv_heads;
  const int rows = sq * g;
  const int row0 = blockIdx.x * kBQ;

  // query rows: (b, s, kvh, gi, :) at (((b*sq + s)*KV + kvh)*G + gi)*DH
  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int gr = row0 + r;
    float val = 0.f;
    if (gr < rows) {
      const int s = gr / g, gi = gr % g;
      const long long off =
          ((static_cast<long long>(b) * sq + s) * kv_heads + kvh) * g + gi;
      val = to_f32(q[off * DH + d]);
    }
    qs[r * (DH + 1) + d] = val;
  }
  if (tid < kBQ) {
    const int gr = row0 + tid;
    pq_s[tid] = gr < rows ? pos_q[gr / g] : -1;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // score microtile: rows sr0 + {0, 1}, keys sc0 + 8 * {0..3}
  const int sr0 = (tid / 8) * 2, sc0 = tid % 8;
  // accumulator: rows ar0 + {0..3}, columns ad0 + 16 * {0..DJ-1}
  const int ar0 = (tid / 16) * 4, ad0 = tid % 16;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < sk; kt += kBK) {
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int c = i / DH, d = i % DH;
      const int key = kt + c;
      float kv_k = 0.f, kv_v = 0.f;
      if (key < sk) {
        const long long off =
            ((static_cast<long long>(b) * sk + key) * kv_heads + kvh) * DH
            + d;
        kv_k = to_f32(k[off]);
        kv_v = to_f32(v[off]);
      }
      ks[c * (DH + 1) + d] = kv_k;
      vs[c * DH + d] = kv_v;
    }
    if (tid < kBK) {
      const int key = kt + tid;
      pk_s[tid] = key < sk ? pos_k[static_cast<long long>(b) * sk + key]
                           : -1;
    }
    __syncthreads();

    // S = Q K^T * scale, masked
    {
      float s[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float q0 = qs[sr0 * (DH + 1) + d];
        const float q1 = qs[(sr0 + 1) * (DH + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float kk = ks[(sc0 + 8 * j) * (DH + 1) + d];
          s[0][j] = fmaf(q0, kk, s[0][j]);
          s[1][j] = fmaf(q1, kk, s[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = sr0 + i;
        const int pq = pq_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = sc0 + 8 * j;
          float val;
          if (kt + c >= sk) {
            val = -CUDART_INF_F;          // no such key: weight exactly 0
          } else {
            const int pk = pk_s[c];
            bool ok = pk >= 0 && pk <= pq;
            if (window >= 0) ok = ok && (pq - pk) < window;
            val = ok ? s[i][j] * scale : kNegInf;
          }
          ps[r * (kBK + 1) + c] = val;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 8, ...; lane = key
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const float sv = ps[r * (kBK + 1) + lane];
      float mx = sv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(sv - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r * (kBK + 1) + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ar0 + i;
      float pv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) pv[j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kBK; ++c) {
        const float p = ps[r * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          pv[j] = fmaf(p, vs[c * DH + ad0 + 16 * j], pv[j]);
      }
      const float corr = corr_s[r];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = acc[i][j] * corr + pv[j];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ar0 + i;
    const int gr = row0 + r;
    if (gr >= rows) continue;
    const int s = gr / g, gi = gr % g;
    const long long off =
        (((static_cast<long long>(b) * sq + s) * kv_heads + kvh) * g + gi)
        * DH;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store(out + off + ad0 + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* pos_q,
           const void* pos_k, void* out, int b, int sq, int sk,
           int kv_heads, int g, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DH>();
  static bool configured = false;   // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((sq * g + kBQ - 1) / kBQ, b * kv_heads);
  flash_fwd_kernel<T, DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_k), static_cast<T*>(out), sq, sk, kv_heads,
      g, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v,
              const void* pos_q, const void* pos_k, void* out, int b, int sq,
              int sk, int kv_heads, int g, int window, float scale,
              cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, pos_q, pos_k, out, b, sq, sk,
                                  kv_heads, g, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, pos_q, pos_k, out, b, sq, sk,
                                  kv_heads, g, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, pos_q, pos_k, out, b, sq, sk,
                                  kv_heads, g, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, pos_q, pos_k, out, b, sq, sk,
                                    kv_heads, g, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (b, sq, kv_heads, g, dh), k/v (b, sk, kv_heads, dh), pos_q (sq,) and
// pos_k (b, sk) int32, out like q. window < 0: none. bf16: the tensors are
// bf16 (else float32). dh in {16, 32, 64, 128}.
int flash_attn_fwd(const void* q, const void* k, const void* v,
                   const void* pos_q, const void* pos_k, void* out, int b,
                   int sq, int sk, int kv_heads, int g, int dh, int window,
                   float scale, int bf16, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kv_heads <= 0 || g <= 0
      || static_cast<long long>(b) * kv_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, pos_q, pos_k, out, b, sq,
                                    sk, kv_heads, g, window, scale, s);
  return launch_dh<float>(dh, q, k, v, pos_q, pos_k, out, b, sq, sk,
                          kv_heads, g, window, scale, s);
}

}  // extern "C"
