// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (repro_torch/kernels/_build.py).
//
// All three routes replace the TPU kernel
//   src/repro/kernels/flash_attn/flash_attn.py: flash_attention_fwd (:75)
//   -> _kernel (:37).
// Online-softmax attention on the models' layout: q (B, Sq, KV, G, DK),
// k (B, Sk, KV, DK), v (B, Sk, KV, DV), pos_q (Sq,), pos_k (B, Sk), out
// (B, Sq, KV, G, DV). Query head (kv, g) reads kv head kv. Key j is seen
// by query i iff 0 <= pos_k[j] <= pos_q[i] and (window < 0 or pos_q[i] -
// pos_k[j] < window); an unseen key scores -1e30 (not -inf), exactly as in
// the reference, so a row that sees no key averages V over all Sk keys; a
// slot past Sk weighs exactly 0; the output is acc / max(l, 1e-30). All
// arithmetic is float32 (the tensor-core route: bf16 products, float32
// sums); q, k, v and out are bf16 or float32. Any DK and DV in 1..576
// (MLA's decode takes 576 / 512); the tensor-core route bf16 up to 256.
//
// The G query heads of one kv head are extra query rows: for a (b, kv)
// pair, row r is (query r / G, group r % G), so K and V are read once for
// the whole group. ops.py::route picks the kernel from the row count,
// the type and the head sizes.
//
// flash_tiled_kernel (float32, or heads wider than 256, with many rows).
// A block owns BQ rows of one (b, kv) and walks every key tile of 32
// keys: it stages K and V (float32) in shared memory, computes the
// BQ x 32 scores, updates the running max m and denominator l per row
// (one warp per row, shuffles across the 32 keys of the tile), then
// rescales its BQ x DVP accumulator (in registers) and adds P V. dk and dv
// round up to instantiated widths DKP and DVP (16 to 576), so every loop
// has a compile-time bound; the extra columns of Q and K are zeros, which
// add 0 to every score, and those of V are never stored. BQ is 64 where
// shared memory and registers allow (DVP <= 128, DKP <= 256), else 16.
//
// flash_tc_kernel (bf16 prefill; many rows). Bound on the card by its
// bytes at the model's prefill (B 4, KV 8, G 4, Sq = Sk = 128: ~10 MB,
// 3.1 us) and by its operations at long prompts (Sq = Sk = 2,048: 34.8
// us), where the CUDA cores' float32 at ~3% of the bf16 rate was the
// whole story. So Q K^T and P V run on mma.sync.m16n8k16 (bf16 in,
// float32 sums). A block owns 128 rows of one (b, kv), 16 per warp; Q is
// staged once by cp.async and held as A fragments (ldmatrix) where the
// registers allow; K and V tiles of 64 keys come through a cp.async ring
// (16-byte copies, rows padded so ldmatrix is conflict-free, slots past
// Sk zero-filled, the tile's key positions with it). The online softmax
// stays in registers (a row's scores in the 4 lanes of a quad), and P is
// rounded to bf16 straight from the score accumulators into the A
// fragments of P V, with V through ldmatrix.trans. A prologue scans the
// key positions once per block: a tile that no (row, key) pair of the
// block can see (its least valid position above the block's greatest
// pos_q, or, under a window, its greatest too far below the least) is
// neither loaded nor computed, and a tile that every pair sees skips the
// mask. Skipped tiles would add exactly 0 to a row that sees a key; a row
// that sees none must average V over all slots, so a block with such a
// row walks every tile again. Shared-memory reads (each warp ldmatrixes
// the whole K and V tile) and the per-tile barrier, not the MMAs, bound
// it now (PERF.md).
//
// flash_split_kernel + flash_merge_kernel (decode; few rows). At decode
// (Sq = 1) a pair has only G rows, so a tiled block would be mostly
// padding and the grid a quarter of the card; the bytes of the cache
// bound it (Qwen3-4B: 2.4 MB, 0.72 us; over 8,192 slots 134 MB, 40.1 us).
// So the keys are split (flash-decoding): grid (KV, splits, B x row chunks
// of RB <= 16, one chunk whenever the rows fit). A block owns all rows of
// its chunk and one contiguous range of key slots, which it streams in
// tiles of TK <= 64 keys through a three-stage cp.async ring: 16-byte
// copies where the row sizes and pointers allow (each thread's copies
// fixed before the loop, so a tile costs a multiply-add per copy; the
// index arithmetic, not the memory, first bounded the loop), element loads
// with a zero-filled tail otherwise; Q, K and V stay in their own type.
// Scores: each warp takes KW keys, its lanes split d (4 columns each), and
// one butterfly of shuffles reduces the RB x KW partial sums at once (N
// values in about N shuffles, not 5 N). P V: a thread owns 4 columns of
// every row for one of KG key groups; the groups are added in order at the
// end. Each block writes its unnormalised (m, l, acc) to a float32
// workspace, and flash_merge_kernel merges the splits in split order (no
// atomics, so the result does not depend on timing) into out.
// flash_attn_split_kv_splits picks the split count from a cost rule (see
// there). Nothing here synchronises the host.
//
// Every entry takes device pointers, sizes and the caller's stream,
// launches without synchronising, allocates nothing (the workspace is the
// caller's) and returns cudaGetLastError() (or cudaErrorInvalidValue for
// sizes it refuses).

#include <cstddef>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;   // keys per tile: one per lane in the softmax
constexpr int kMaxDim = 576;
constexpr int kMaxSmem = 232448;   // the opt-in limit of one block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src-size 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes from global to shared (a key position), zero when not valid
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One block may use up to kMaxSmem bytes of dynamic shared memory; set
// once per kernel instance (a permission, not an allocation).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) configured = true;
  return err;
}

// ---------------------------------------------------------------------------
// The tiled route
// ---------------------------------------------------------------------------

namespace tiled {

template <int BQ, int DKP, int DVP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DKP + 1) + kBK * (DKP + 1) + kBK * DVP
                          + BQ * (kBK + 1) + 3 * BQ)
         + sizeof(int) * (BQ + kBK);
}

template <typename T, int BQ, int DKP, int DVP>
__global__ void __launch_bounds__(kThreads)
flash_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ pos_q,
                   const int* __restrict__ pos_k, T* __restrict__ out,
                   int sq, int sk, int kv_heads, int g, int dk, int dv,
                   int window, float scale, float* __restrict__ lse) {
  static_assert(DVP % 16 == 0 && DKP >= DVP, "widths: 16s, DKP >= DVP");
  static_assert(BQ == 16 || BQ == 32 || BQ == 64, "BQ is 16, 32 or 64");
  constexpr int DJ = DVP / 16;      // accumulator columns per thread
  constexpr int AR = BQ / 16;       // accumulator rows per thread
  constexpr int SC = BQ >= 32 ? 4 : 2;    // score keys per thread
  constexpr int SR = BQ / 8 / SC;         // score rows per thread
  constexpr int KT = kBK / SC;            // threads along the keys
  constexpr int DKS = DKP + 1;            // padded row stride
  extern __shared__ float smem[];
  float* qs = smem;                           // [BQ][DKP + 1]
  float* ks = qs + BQ * DKS;                  // [kBK][DKP + 1]
  float* vs = ks + kBK * DKS;                 // [kBK][DVP]
  float* ps = vs + kBK * DVP;                 // [BQ][kBK + 1]
  float* m_s = ps + BQ * (kBK + 1);           // [BQ]
  float* l_s = m_s + BQ;                      // [BQ]
  float* corr_s = l_s + BQ;                   // [BQ]
  int* pq_s = reinterpret_cast<int*>(corr_s + BQ);   // [BQ]
  int* pk_s = pq_s + BQ;                             // [kBK]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.y;                  // b * kv_heads + kv
  const int b = bh / kv_heads, kvh = bh % kv_heads;
  const int rows = sq * g;
  const int row0 = blockIdx.x * BQ;

  // query rows: (b, s, kvh, gi, :) at (((b*sq + s)*KV + kvh)*G + gi)*dk;
  // columns past dk are zeros, so they add 0 to every score
  for (int i = tid; i < BQ * DKP; i += kThreads) {
    const int r = i / DKP, d = i % DKP;
    const int gr = row0 + r;
    float val = 0.f;
    if (gr < rows && d < dk) {
      const int s = gr / g, gi = gr % g;
      const long long off =
          ((static_cast<long long>(b) * sq + s) * kv_heads + kvh) * g + gi;
      val = to_f32(q[off * dk + d]);
    }
    qs[r * DKS + d] = val;
  }
  if (tid < BQ) {
    const int gr = row0 + tid;
    pq_s[tid] = gr < rows ? pos_q[gr / g] : -1;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // score microtile: rows sr0 + {0..SR-1}, keys sc0 + KT * {0..SC-1}
  const int sr0 = (tid / KT) * SR, sc0 = tid % KT;
  // accumulator: rows ar0 + {0..AR-1}, columns ad0 + 16 * {0..DJ-1}
  const int ar0 = (tid / 16) * AR, ad0 = tid % 16;
  float acc[AR][DJ];
#pragma unroll
  for (int i = 0; i < AR; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < sk; kt += kBK) {
    __syncthreads();   // the previous tile's K, V and P are consumed
    // K and V of the tile; zeros past sk, past dk and past dv (those
    // columns are computed and never stored)
    for (int i = tid; i < kBK * DKP; i += kThreads) {
      const int c = i / DKP, d = i % DKP;
      const int key = kt + c;
      const long long row =
          (static_cast<long long>(b) * sk + key) * kv_heads + kvh;
      ks[c * DKS + d] = key < sk && d < dk ? to_f32(k[row * dk + d]) : 0.f;
      if (d < DVP)
        vs[c * DVP + d] = key < sk && d < dv ? to_f32(v[row * dv + d]) : 0.f;
    }
    if (tid < kBK) {
      const int key = kt + tid;
      pk_s[tid] = key < sk ? pos_k[static_cast<long long>(b) * sk + key]
                           : -1;
    }
    __syncthreads();

    // S = Q K^T * scale, masked
    {
      float s[SR][SC];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < DKP; ++d) {
        float qv[SR];
#pragma unroll
        for (int i = 0; i < SR; ++i) qv[i] = qs[(sr0 + i) * DKS + d];
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const float kk = ks[(sc0 + KT * j) * DKS + d];
#pragma unroll
          for (int i = 0; i < SR; ++i) s[i][j] = fmaf(qv[i], kk, s[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = sr0 + i;
        const int pq = pq_s[r];
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int c = sc0 + KT * j;
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
    for (int r = warp; r < BQ; r += kWarps) {
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
    for (int i = 0; i < AR; ++i) {
      const int r = ar0 + i;
      float pv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) pv[j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kBK; ++c) {
        const float p = ps[r * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          pv[j] = fmaf(p, vs[c * DVP + ad0 + 16 * j], pv[j]);
      }
      const float corr = corr_s[r];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = acc[i][j] * corr + pv[j];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int r = ar0 + i;
    const int gr = row0 + r;
    if (gr >= rows) continue;
    const int s = gr / g, gi = gr % g;
    const long long off =
        (((static_cast<long long>(b) * sq + s) * kv_heads + kvh) * g + gi)
        * dv;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = ad0 + 16 * j;
      if (d < dv) store(out + off + d, acc[i][j] / denom);
    }
  }
  // lse (b, kv_heads, g, sq) = m + log(max(l, 1e-30)), when asked for
  if (lse != nullptr && tid < BQ && row0 + tid < rows) {
    const int gr = row0 + tid;
    lse[(static_cast<long long>(bh) * g + gr % g) * sq + gr / g] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

// The operands and sizes of one call; lse may be null.
struct Call {
  const void *q, *k, *v, *pos_q, *pos_k;
  void* out;
  float* lse;
  int b, sq, sk, kv_heads, g, dk, dv, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int BQ, int DKP, int DVP>
int launch(const Call& a) {
  constexpr size_t bytes = smem_bytes<BQ, DKP, DVP>();
  static_assert(bytes <= static_cast<size_t>(kMaxSmem), "shared memory");
  static bool configured = false;
  cudaError_t err = allow_smem(flash_tiled_kernel<T, BQ, DKP, DVP>,
                               configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.sq * a.g + BQ - 1) / BQ, a.b * a.kv_heads);
  flash_tiled_kernel<T, BQ, DKP, DVP><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.pos_q),
      static_cast<const int*>(a.pos_k), static_cast<T*>(a.out), a.sq, a.sk,
      a.kv_heads, a.g, a.dk, a.dv, a.window, a.scale, a.lse);
  return static_cast<int>(cudaGetLastError());
}

// The instantiated widths, the repo's head sizes among them (192: MLA's
// prefill keys); a head size rounds up to the next one.
constexpr int kWidths[] = {16, 32, 64, 128, 192, 256, kMaxDim};
constexpr int kNumWidths = sizeof(kWidths) / sizeof(kWidths[0]);

// DVP = kWidths[J] rises to the least width >= dv, then DKP = kWidths[I]
// (never below DVP, so one loop stages K and V) to the least >= dk. BQ is
// 64 where shared memory and registers allow, else 16.
template <typename T, int I, int J>
int launch_widths(const Call& a) {
  constexpr int DKP = kWidths[I], DVP = kWidths[J];
  if constexpr (J + 1 < kNumWidths) {
    if (a.dv > DVP) return launch_widths<T, (I > J + 1 ? I : J + 1), J + 1>(a);
  }
  if constexpr (I + 1 < kNumWidths) {
    if (a.dk > DKP) return launch_widths<T, I + 1, J>(a);
  }
  return launch<T, (DKP <= 256 && DVP <= 128 ? 64 : 16), DKP, DVP>(a);
}

}  // namespace tiled

// ---------------------------------------------------------------------------
// The split-over-keys route
// ---------------------------------------------------------------------------

namespace split {

constexpr int kSmemTarget = 112 * 1024;   // two blocks per SM
constexpr int kStages = 3;                // tiles in the cp.async ring
constexpr int kTK = 64;                   // most keys per tile: two a lane
constexpr int kMaxSplits = 1024;
constexpr int kMergeThreads = 128;

// four neighbouring elements from shared memory, as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, c.x, c.y);
}

// Sums N values over the 32 lanes of a warp in about N shuffles: at each
// of the five xor offsets a lane sends the half of its values that its
// partner keeps and keeps the other half. Afterwards a lane holds in v[0
// .. N/32) the sums of values lane * N/32 + j when N >= 32, and in v[0]
// the sum of value lane >> (5 - log2 N) when N < 32.
template <int N, int O>
__device__ __forceinline__ void butterfly(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool upper = lane & O;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = upper ? v[i] : v[i + N / 2];
        const float keep = upper ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      butterfly<N / 2, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      butterfly<1, O / 2>(v, lane);
    }
  }
}

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

// Sizes of one block, the same for the split rule and the launch.
struct Geometry {
  int rb;      // rows per block: 4, 8 or 16
  int tk;      // keys per tile: 64, 32, 16 or 8, as shared memory allows
  int dkp;     // dk and dv rounded up to 4 (shared-memory row lengths)
  int dvp;
  int nqp;     // threads per key group: column quads rounded up to 2^n
  size_t ring_offset;   // bytes before the K/V ring
  size_t smem;          // bytes of dynamic shared memory
};

inline Geometry geometry(int rows, int dk, int dv, size_t elem) {
  Geometry geo;
  geo.rb = rows <= 4 ? 4 : (rows <= 8 ? 8 : 16);
  geo.dkp = (dk + 3) / 4 * 4;
  geo.dvp = (dv + 3) / 4 * 4;
  geo.nqp = 1;
  while (geo.nqp < geo.dvp / 4) geo.nqp *= 2;
  const size_t q_bytes = (elem * geo.rb * geo.dkp + 15) / 16 * 16;
  const size_t head = q_bytes
                      + sizeof(float) * (geo.rb * (kTK + 1) + 3 * geo.rb)
                      + sizeof(int) * (geo.rb + kStages * kTK);
  geo.ring_offset = (head + 15) / 16 * 16;
  const size_t red = sizeof(float) * (kThreads / geo.nqp) * geo.rb * geo.dvp;
  for (geo.tk = kTK; ; geo.tk /= 2) {
    const size_t ring = kStages * elem * geo.tk * (geo.dkp + geo.dvp);
    geo.smem = geo.ring_offset + (ring > red ? ring : red);
    if (geo.smem <= static_cast<size_t>(kSmemTarget) || geo.tk == 8) break;
  }
  return geo;
}

// One block: kv head blockIdx.x of batch row blockIdx.z / chunks, its rows
// RB * (blockIdx.z % chunks) .. + RB - 1, against the key slots
// [blockIdx.y * keys_per_split, + keys_per_split), into the workspace: acc
// (splits, pairs, rows, dv) then (m, l) (splits, pairs, rows, 2), float32,
// unnormalised. The kv heads vary fastest, so the blocks that run together
// read neighbouring slices of the same cache rows.
template <typename T, int RB>
__global__ void __launch_bounds__(kThreads, 2)
flash_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ pos_q,
                   const int* __restrict__ pos_k, float* __restrict__ ws,
                   int sq, int sk, int kv_heads, int g, int dk, int dv,
                   int dkp, int dvp, int tk, int nqp, int ring_offset,
                   int keys_per_split, int vec, int window, float scale) {
  constexpr int KW = RB <= 8 ? 4 : 2;      // keys per warp and pass
  constexpr int N = RB * KW;               // partial sums per lane
  constexpr int PER = N >= 32 ? N / 32 : 1;
  constexpr int SHIFT = N >= 32 ? 0 : 5 - log2i(N);
  static_assert((N & (N - 1)) == 0 && N >= 16 && N <= 64, "butterfly size");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);           // [RB][dkp]
  float* ss = reinterpret_cast<float*>(             // [RB][kTK + 1]
      smem_raw + (sizeof(T) * RB * dkp + 15) / 16 * 16);
  float* m_s = ss + RB * (kTK + 1);                 // [RB]
  float* l_s = m_s + RB;                            // [RB]
  float* corr_s = l_s + RB;                         // [RB]
  int* pq_s = reinterpret_cast<int*>(corr_s + RB);  // [RB]
  int* pk_s = pq_s + RB;                            // [kStages][kTK]
  T* ring = reinterpret_cast<T*>(smem_raw + ring_offset);
  const int stage_elems = tk * (dkp + dvp);         // K [tk][dkp], V [tk][dvp]
  float* red = reinterpret_cast<float*>(ring);      // after the loop

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int rows = sq * g, chunks = (rows + RB - 1) / RB;
  const int kvh = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int b = blockIdx.z / chunks;
  const int row0 = (blockIdx.z % chunks) * RB;
  const int bh = b * kv_heads + kvh;
  const int pairs = gridDim.z / chunks * kv_heads;
  const int key0 = split * keys_per_split;
  const int key1 = min(sk, key0 + keys_per_split);
  const long long kv_row0 = static_cast<long long>(b) * sk;   // slot 0

  // query row r: (b, s, kvh, gi, :) for row0 + r = s * G + gi; zeros past
  // the rows and past dk
  auto q_off = [&](int r) {
    const int gr = min(row0 + r, rows - 1);
    return (((static_cast<long long>(b) * sq + gr / g) * kv_heads + kvh) * g
            + gr % g) * dk;
  };
  constexpr int E = 16 / sizeof(T);   // elements per 16-byte copy
  if (vec) {
    const int qc = dk / E;
    for (int i = tid; i < RB * qc; i += kThreads) {
      const int r = i / qc, e = (i % qc) * E;
      cp_async16(smem_u32(qs + r * dkp + e), q + q_off(r) + e,
                 row0 + r < rows);
    }
  } else {
    for (int i = tid; i < RB * dkp; i += kThreads) {
      const int r = i / dkp, d = i % dkp;
      store(qs + i, row0 + r < rows && d < dk ? to_f32(q[q_off(r) + d])
                                              : 0.f);
    }
  }
  if (tid < RB) {
    const int gr = row0 + tid;
    pq_s[tid] = gr < rows ? pos_q[gr / g] : -1;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // A thread's 16-byte copies, the same in every tile: K chunk e_k of the
  // tile's rows c_k, c_k + k_step, ... and V chunk e_v of rows c_v, ...
  // (threads past the last whole row copy nothing), so a tile costs a
  // multiply-add per copy and no division.
  const int kc = vec ? dk / E : 1, vc = vec ? dv / E : 1;
  const int k_step = kThreads / kc, v_step = kThreads / vc;
  const int c_k = tid < k_step * kc ? tid / kc : kTK;
  const int c_v = tid < v_step * vc ? tid / vc : kTK;
  const int e_k = tid % kc * E, e_v = tid % vc * E;
  const long long head0 = kv_row0 * kv_heads + kvh;   // row of slot 0
  const T* k_src = k + head0 * dk + e_k;
  const T* v_src = v + head0 * dv + e_v;
  const long long k_stride = static_cast<long long>(kv_heads) * dk;
  const long long v_stride = static_cast<long long>(kv_heads) * dv;

  // Stage the keys t0 .. t0 + tk - 1 (zeros from key1 on) and their
  // positions, all asynchronously (with Q in the first group): a plain
  // load here would stall the block for a memory latency per tile.
  auto load_tile = [&](int t0, int stage) {
    T* ks = ring + stage * stage_elems;
    T* vs = ks + tk * dkp;
    if (vec) {
      for (int c = c_k; c < tk; c += k_step) {
        const int key = t0 + c;
        const bool valid = key < key1;
        cp_async16(smem_u32(ks + c * dkp + e_k),
                   k_src + (valid ? key : key0) * k_stride, valid);
      }
      for (int c = c_v; c < tk; c += v_step) {
        const int key = t0 + c;
        const bool valid = key < key1;
        cp_async16(smem_u32(vs + c * dvp + e_v),
                   v_src + (valid ? key : key0) * v_stride, valid);
      }
    } else {
      for (int i = tid; i < tk * (dkp + dvp); i += kThreads) {
        const bool is_k = i < tk * dkp;
        const int j = is_k ? i : i - tk * dkp;
        const int width = is_k ? dkp : dvp;
        const int c = j / width, e = j % width;
        const int key = t0 + c;
        float val = 0.f;
        if (key < key1 && e < (is_k ? dk : dv)) {
          const long long row = (kv_row0 + key) * kv_heads + kvh;
          val = to_f32(is_k ? k[row * dk + e] : v[row * dv + e]);
        }
        store((is_k ? ks : vs) + c * width + e, val);
      }
    }
    if (tid < tk) {    // past key1 a zero, never read: those keys are -inf
      const int key = t0 + tid;
      const bool valid = key < key1;
      cp_async4(smem_u32(pk_s + stage * kTK + tid),
                pos_k + kv_row0 + (valid ? key : key0), valid);
    }
  };

  const int qd_count = dkp / 4;
  const int nq = dvp / 4;                       // column quads
  const int kg = tid / nqp, groups = kThreads / nqp;
  const int quad = tid % nqp;
  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  const int tiles = key1 > key0 ? (key1 - key0 + tk - 1) / tk : 0;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < tiles) load_tile(key0 + t * tk, t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    const int stage = t % kStages;
    const int t0 = key0 + t * tk;
    const int n = min(tk, key1 - t0);           // real keys in the tile
    cp_async_wait<kStages - 2>();
    // tile t has landed for every thread; tile t - 1's stage and scores
    // are consumed, so its stage takes tile t + kStages - 1
    __syncthreads();
    if (t + kStages - 1 < tiles)
      load_tile(t0 + (kStages - 1) * tk, (t + kStages - 1) % kStages);
    cp_async_commit();
    const T* ks = ring + stage * stage_elems;
    const T* vs = ks + tk * dkp;
    const int* pk = pk_s + stage * kTK;

    // S = Q K^T * scale, masked: warp w takes keys w*KW + 8*KW*pass + kk
    for (int c0 = warp * KW; c0 < tk; c0 += kWarps * KW) {
      float s[N];
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] = 0.f;
      for (int qd = lane; qd < qd_count; qd += 32) {
        float4 kq[KW];
#pragma unroll
        for (int kk = 0; kk < KW; ++kk)
          kq[kk] = load4(ks + (c0 + kk) * dkp + 4 * qd);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 qv = load4(qs + r * dkp + 4 * qd);
#pragma unroll
          for (int kk = 0; kk < KW; ++kk) {
            float a = s[r * KW + kk];
            a = fmaf(qv.x, kq[kk].x, a);
            a = fmaf(qv.y, kq[kk].y, a);
            a = fmaf(qv.z, kq[kk].z, a);
            a = fmaf(qv.w, kq[kk].w, a);
            s[r * KW + kk] = a;
          }
        }
      }
      butterfly<N, 16>(s, lane);
      if (N >= 32 || (lane & ((1 << SHIFT) - 1)) == 0) {
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int idx = N >= 32 ? lane * PER + j : lane >> SHIFT;
          const int r = idx / KW, c = c0 + idx % KW;
          float val;
          if (c >= n) {
            val = -CUDART_INF_F;          // no such key: weight exactly 0
          } else {
            const int pq = pq_s[r], pkc = pk[c];
            bool ok = pkc >= 0 && pkc <= pq;
            if (window >= 0) ok = ok && (pq - pkc) < window;
            val = ok ? s[j] * scale : kNegInf;
          }
          ss[r * (kTK + 1) + c] = val;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 8; lane keys lane, lane + 32
    for (int r = warp; r < RB; r += kWarps) {
      float* sr = ss + r * (kTK + 1);
      const float s0 = lane < n ? sr[lane] : -CUDART_INF_F;
      const float s1 = lane + 32 < n ? sr[lane + 32] : -CUDART_INF_F;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sr[lane] = p0;
      if (lane + 32 < tk) sr[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V over this thread's key group
    if (quad < nq) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float corr = corr_s[r];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] *= corr;
      }
      for (int c = kg; c < n; c += groups) {
        const float4 vq = load4(vs + c * dvp + 4 * quad);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float p = ss[r * (kTK + 1) + c];
          acc[r][0] = fmaf(p, vq.x, acc[r][0]);
          acc[r][1] = fmaf(p, vq.y, acc[r][1]);
          acc[r][2] = fmaf(p, vq.z, acc[r][2]);
          acc[r][3] = fmaf(p, vq.w, acc[r][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the key groups' sums, added in group order
  if (quad < nq) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(kg * RB + r) * dvp + 4 * quad + e] = acc[r][e];
  }
  __syncthreads();
  const int nrows = min(RB, rows - row0);
  const long long ws_row0 =
      (static_cast<long long>(split) * pairs + bh) * rows + row0;
  for (int i = tid; i < nrows * dv; i += kThreads) {
    const int r = i / dv, d = i % dv;
    float sum = 0.f;
    for (int grp = 0; grp < groups; ++grp)
      sum += red[(grp * RB + r) * dvp + d];
    ws[(ws_row0 + r) * dv + d] = sum;
  }
  if (tid < nrows) {
    float* ml = ws + static_cast<long long>(splits) * pairs * rows * dv;
    ml[(ws_row0 + tid) * 2] = m_s[tid];
    ml[(ws_row0 + tid) * 2 + 1] = l_s[tid];
  }
}

// out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30),
// M = max_s m_s, the splits taken in order. Block (row of a pair, chunk of
// kMergeThreads columns): the weights e^(m_s - M) and l_s go to shared
// memory once, then a thread adds its column's splits in order, its loads
// independent of each other.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
flash_merge_kernel(const float* __restrict__ ws, T* __restrict__ out,
                   int splits, int pairs, int rows, int dv, int sq,
                   int kv_heads, int g, float* __restrict__ lse) {
  extern __shared__ float wl[];                 // [2][splits]: w_s, l_s
  __shared__ float top[kMergeThreads / 32];
  const int tid = threadIdx.x, lane = tid % 32;
  const int pr = blockIdx.x;                    // bh * rows + r
  const long long stride = static_cast<long long>(pairs) * rows;
  const float* ml = ws + splits * stride * dv;
  float m = kNegInf;
  for (int s = tid; s < splits; s += kMergeThreads) {
    const float ms = ml[(s * stride + pr) * 2];
    wl[s] = ms;
    wl[splits + s] = ml[(s * stride + pr) * 2 + 1];
    m = fmaxf(m, ms);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) top[tid / 32] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kMergeThreads / 32; ++w) m = fmaxf(m, top[w]);
  for (int s = tid; s < splits; s += kMergeThreads)
    wl[s] = expf(wl[s] - m);
  __syncthreads();
  const int d = blockIdx.y * kMergeThreads + tid;
  if (d >= dv) return;
  const float* src = ws + static_cast<long long>(pr) * dv + d;
  float l = 0.f, acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    const float w = wl[s];
    l = fmaf(wl[splits + s], w, l);
    acc = fmaf(src[s * stride * dv], w, acc);
  }
  const int r = pr % rows, bh = pr / rows;
  const int b = bh / kv_heads, kvh = bh % kv_heads;
  const int s_q = r / g, gi = r % g;
  const long long off =
      (((static_cast<long long>(b) * sq + s_q) * kv_heads + kvh) * g + gi)
      * dv + d;
  store(out + off, acc / fmaxf(l, 1e-30f));
  // lse (b, kv_heads, g, sq) = M + log(max(l, 1e-30)): every thread of the
  // row holds the same M and l; column 0's writes it
  if (lse != nullptr && d == 0)
    lse[(static_cast<long long>(bh) * g + gi) * sq + s_q] =
        m + logf(fmaxf(l, 1e-30f));
}

template <typename T, int RB>
cudaError_t configure(const Geometry& geo, int* blocks_per_sm) {
  static bool configured = false;
  cudaError_t err = allow_smem(flash_split_kernel<T, RB>, configured);
  if (err != cudaSuccess || blocks_per_sm == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flash_split_kernel<T, RB>, kThreads, geo.smem);
}

template <typename T>
cudaError_t configure_rb(const Geometry& geo, int* blocks_per_sm) {
  if (geo.rb == 4) return configure<T, 4>(geo, blocks_per_sm);
  if (geo.rb == 8) return configure<T, 8>(geo, blocks_per_sm);
  return configure<T, 16>(geo, blocks_per_sm);
}

template <typename T, int RB>
void launch_split(const Geometry& geo, dim3 grid, const void* q,
                  const void* k, const void* v, const void* pos_q,
                  const void* pos_k, float* ws, int sq, int sk,
                  int kv_heads, int g, int dk, int dv, int keys_per_split,
                  int vec, int window, float scale, cudaStream_t stream) {
  flash_split_kernel<T, RB><<<grid, kThreads, geo.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_k), ws, sq, sk, kv_heads, g, dk, dv,
      geo.dkp, geo.dvp, geo.tk, geo.nqp, static_cast<int>(geo.ring_offset),
      keys_per_split, vec, window, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos_q,
           const void* pos_k, void* out, void* workspace, int b, int sq,
           int sk, int kv_heads, int g, int dk, int dv, int window,
           float scale, int splits, float* lse, cudaStream_t stream) {
  const int rows = sq * g, pairs = b * kv_heads;
  const Geometry geo = geometry(rows, dk, dv, sizeof(T));
  cudaError_t err = configure_rb<T>(geo, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (sk + geo.tk - 1) / geo.tk;
  const int keys_per_split = (tiles + splits - 1) / splits * geo.tk;
  const int chunks = (rows + geo.rb - 1) / geo.rb;
  const int vec = (dk * sizeof(T)) % 16 == 0 && (dv * sizeof(T)) % 16 == 0
                  && reinterpret_cast<uintptr_t>(q) % 16 == 0
                  && reinterpret_cast<uintptr_t>(k) % 16 == 0
                  && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  float* ws = static_cast<float*>(workspace);
  dim3 grid(kv_heads, splits, b * chunks);
  if (geo.rb == 4)
    launch_split<T, 4>(geo, grid, q, k, v, pos_q, pos_k, ws, sq, sk,
                       kv_heads, g, dk, dv, keys_per_split, vec, window,
                       scale, stream);
  else if (geo.rb == 8)
    launch_split<T, 8>(geo, grid, q, k, v, pos_q, pos_k, ws, sq, sk,
                       kv_heads, g, dk, dv, keys_per_split, vec, window,
                       scale, stream);
  else
    launch_split<T, 16>(geo, grid, q, k, v, pos_q, pos_k, ws, sq, sk,
                        kv_heads, g, dk, dv, keys_per_split, vec, window,
                        scale, stream);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 merge_grid(pairs * rows, (dv + kMergeThreads - 1) / kMergeThreads);
  flash_merge_kernel<T><<<merge_grid, kMergeThreads,
                          2 * sizeof(float) * splits, stream>>>(
      ws, static_cast<T*>(out), splits, pairs, rows, dv, sq, kv_heads, g,
      lse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace split

// ---------------------------------------------------------------------------
// The tensor-core route (bf16, prefill)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows per block: 16 per warp
constexpr int kBK = 64;            // keys per tile
constexpr int kMaxDim = 256;       // the largest dk and dv it takes
constexpr int kScanTiles = 64;     // tiles per pass of the block's tile scan
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU's approximation (relative error about 2^-22, far below
// bf16's 2^-9 for P; subnormal results flush to 0): exactly 0 for x =
// -1e30 or -inf, which the tile skip relies on. exp2f wraps the same
// instruction in a range check that cost 13% of the kernel at 2k keys.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Shared memory of one block, in bytes: Q [kBQ][DKP + 8], then per stage
// K [kBK][DKP + 8], V [kBK][DVP + 8] (bf16; the 8 extra columns put the 8
// rows of an ldmatrix in 8 different 16-byte bank groups) and the tile's
// key positions, then the tile scan's scratch and the block's position
// bounds; the two tile bitmasks (words each) come last. The ring has three
// stages where they fit beside 4 KB of bitmasks (Sk up to 2^20), else two.
template <int DKP, int DVP>
struct Layout {
  static constexpr int kQS = DKP + 8;
  static constexpr int kVS = DVP + 8;
  static constexpr int q_bytes = kBQ * kQS * 2;
  static constexpr int k_bytes = kBK * kQS * 2;
  static constexpr int v_bytes = kBK * kVS * 2;
  static constexpr int stage_bytes = k_bytes + v_bytes + kBK * 4;
  static constexpr int scan_bytes = 3 * 2 * kScanTiles * 4 + 2 * kWarps * 4;
  static constexpr int kStages =
      q_bytes + 3 * stage_bytes + scan_bytes + 4096 <= kMaxSmem ? 3 : 2;
  static constexpr int ring_offset = q_bytes;
  static constexpr int scan_offset = ring_offset + kStages * stage_bytes;
  static constexpr int mask_offset = scan_offset + scan_bytes;
  static_assert(stage_bytes % 16 == 0 && q_bytes % 16 == 0, "alignment");
  // Q is held in registers as A fragments where they fit beside the
  // output accumulator (DKP / 4 and DVP / 2 registers a thread), else read
  // from shared memory at each k step
  static constexpr bool kQRegs = DKP / 4 + DVP / 2 <= 128;
};

// One block: query rows row0 .. row0 + kBQ - 1 of the (b, kv) pair
// blockIdx.y (row r is query r / G, group r % G), the row blocks taken
// last first so that the blocks that see the most keys start first. vec:
// 16-byte copies (dk, dv multiples of 8, q, k, v 16-byte aligned), else
// element loads.
template <int DKP, int DVP>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                __nv_bfloat16* __restrict__ out, int sq, int sk,
                int kv_heads, int g, int dk, int dv, int window,
                float scale_log2, int words, int vec,
                float* __restrict__ lse) {
  using L = Layout<DKP, DVP>;
  constexpr int kQS = L::kQS, kVS = L::kVS, kStages = L::kStages;
  constexpr int NT = DVP / 8;          // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  int* scan_lo = reinterpret_cast<int*>(smem + L::scan_offset);
  int* scan_hi = scan_lo + 2 * kScanTiles;     // [2 * kScanTiles] halves
  int* scan_all = scan_hi + 2 * kScanTiles;
  int* qstat = scan_all + 2 * kScanTiles;      // [kWarps] minima, maxima
  unsigned* visit = reinterpret_cast<unsigned*>(smem + L::mask_offset);
  unsigned* full = visit + words;
  auto stage_k = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L::ring_offset
                                            + s * L::stage_bytes);
  };
  auto stage_v = [&](int s) { return stage_k(s) + kBK * kQS; };
  auto stage_pos = [&](int s) {
    return reinterpret_cast<int*>(stage_v(s) + kBK * kVS);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int rows = sq * g;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / kv_heads, kvh = blockIdx.y % kv_heads;
  const int ntiles = (sk + kBK - 1) / kBK;
  // K/V row of slot j: (b * sk + j) * kv_heads + kvh = kv_row0 + j * KV
  const long long kv_row0 = static_cast<long long>(b) * sk * kv_heads + kvh;
  auto q_row = [&](int r) {                    // r < rows - row0
    const int gr = row0 + r;
    return ((static_cast<long long>(b) * sq + gr / g) * kv_heads + kvh) * g
           + gr % g;
  };
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  // 1. Q (zeros past the rows and past dk), asynchronously
  if (vec) {
    const int qc = dk / 8;
    for (int i = tid; i < kBQ * qc; i += kThreads) {
      const int r = i / qc, e = i % qc * 8;
      const bool ok = row0 + r < rows;
      cp_async16(smem_u32(qs + r * kQS + e), ok ? q + q_row(r) * dk + e : q,
                 ok);
    }
    // columns past dk and dv, never written by a copy: zeroed once
    const int kpad = DKP - dk, vpad = DVP - dv;
    for (int i = tid; i < (kBQ + kStages * kBK) * kpad; i += kThreads) {
      const int r = i / kpad, d = dk + i % kpad;
      if (r < kBQ)
        qs[r * kQS + d] = zero;
      else
        stage_k((r - kBQ) / kBK)[(r - kBQ) % kBK * kQS + d] = zero;
    }
    for (int i = tid; i < kStages * kBK * vpad; i += kThreads) {
      const int r = i / vpad, d = dv + i % vpad;
      stage_v(r / kBK)[r % kBK * kVS + d] = zero;
    }
  } else {
    for (int i = tid; i < kBQ * DKP; i += kThreads) {
      const int r = i / DKP, d = i % DKP;
      qs[r * kQS + d] = row0 + r < rows && d < dk ? q[q_row(r) * dk + d]
                                                  : zero;
    }
  }
  cp_async_commit();

  // 2. this thread's two rows (wrow and wrow + 8 of its warp's 16) and the
  // block's least and greatest query position over its real rows
  const int wrow = warp * 16 + gq;
  bool real[2];
  int pq[2];
  {
    int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + wrow + 8 * h;
      real[h] = gr < rows;
      pq[h] = real[h] ? pos_q[gr / g] : -1;
      if (real[h]) {
        mn = min(mn, pq[h]);
        mx = max(mx, pq[h]);
      }
    }
    mn = __reduce_min_sync(0xffffffffu, mn);
    mx = __reduce_max_sync(0xffffffffu, mx);
    if (lane == 0) {
      qstat[warp] = mn;
      qstat[kWarps + warp] = mx;
    }
  }
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    qmin = min(qmin, qstat[w]);
    qmax = max(qmax, qstat[kWarps + w]);
  }

  // 3. the tile scan: each tile's least and greatest valid key position
  // (half a tile per warp step, one redux each), then visit = some (row,
  // key) pair of the block may be seen, full = every pair is seen (no
  // mask needed). Conservative: a tile holding a seen pair is visited.
  const int* pk_b = pos_k + static_cast<long long>(b) * sk;
  for (int t0 = 0; t0 < ntiles; t0 += kScanTiles) {
    const int halves = 2 * min(kScanTiles, ntiles - t0);
#pragma unroll 4
    for (int h = warp; h < halves; h += kWarps) {
      const int key = (2 * t0 + h) * 32 + lane;
      const int p = key < sk ? pk_b[key] : -1;
      const bool valid = p >= 0;
      const int lo = __reduce_min_sync(0xffffffffu, valid ? p : INT_MAX);
      const int hi = __reduce_max_sync(0xffffffffu, valid ? p : INT_MIN);
      const bool all = __all_sync(0xffffffffu, valid);
      if (lane == 0) {
        scan_lo[h] = lo;
        scan_hi[h] = hi;
        scan_all[h] = all;
      }
    }
    __syncthreads();
    if (tid < kScanTiles) {
      const int t = t0 + tid;
      bool vis = false, ful = false;
      if (t < ntiles) {
        const int lo = min(scan_lo[2 * tid], scan_lo[2 * tid + 1]);
        const int hi = max(scan_hi[2 * tid], scan_hi[2 * tid + 1]);
        const bool all = scan_all[2 * tid] && scan_all[2 * tid + 1];
        vis = hi >= 0 && lo <= qmax
              && (window < 0
                  || static_cast<long long>(qmin) - hi < window);
        ful = vis && all && hi <= qmin
              && (window < 0
                  || static_cast<long long>(qmax) - lo < window);
      }
      const unsigned vb = __ballot_sync(0xffffffffu, vis);
      const unsigned fb = __ballot_sync(0xffffffffu, ful);
      if (lane == 0 && t0 / 32 + warp < words) {
        visit[t0 / 32 + warp] = vb;
        full[t0 / 32 + warp] = fb;
      }
    }
    __syncthreads();
  }

  // the next tile to walk from tile t on: every tile, or the next visited
  auto next_tile = [&](int t, bool skip) {
    if (!skip) return t;
    while (t < ntiles) {
      const unsigned bits = visit[t >> 5] >> (t & 31);
      if (bits) return t + __ffs(bits) - 1;
      t = (t | 31) + 1;
    }
    return ntiles;
  };

  // a thread's 16-byte copies, the same in every tile: K chunk e_k of tile
  // rows c_k, c_k + k_step, ..., V chunk e_v of rows c_v, ...
  const int kc = vec ? dk / 8 : 1, vc = vec ? dv / 8 : 1;
  const int k_step = kThreads / kc, v_step = kThreads / vc;
  const int c_k = tid < k_step * kc ? tid / kc : kBK;
  const int c_v = tid < v_step * vc ? tid / vc : kBK;
  const int e_k = tid % kc * 8, e_v = tid % vc * 8;
  const __nv_bfloat16* k_src = k + kv_row0 * dk + e_k;
  const __nv_bfloat16* v_src = v + kv_row0 * dv + e_v;
  const long long k_stride = static_cast<long long>(kv_heads) * dk;
  const long long v_stride = static_cast<long long>(kv_heads) * dv;

  // stage s takes tile t: K, V (zeros past sk) and the key positions
  auto load_tile = [&](int t, int s) {
    __nv_bfloat16* ks = stage_k(s);
    __nv_bfloat16* vs = stage_v(s);
    const int key0 = t * kBK;
    if (vec) {
      for (int c = c_k; c < kBK; c += k_step) {
        const bool ok = key0 + c < sk;
        cp_async16(smem_u32(ks + c * kQS + e_k),
                   k_src + (ok ? key0 + c : 0) * k_stride, ok);
      }
      for (int c = c_v; c < kBK; c += v_step) {
        const bool ok = key0 + c < sk;
        cp_async16(smem_u32(vs + c * kVS + e_v),
                   v_src + (ok ? key0 + c : 0) * v_stride, ok);
      }
    } else {
      for (int i = tid; i < kBK * DKP; i += kThreads) {
        const int c = i / DKP, d = i % DKP;
        const int key = key0 + c;
        ks[c * kQS + d] = key < sk && d < dk
            ? k[(kv_row0 + static_cast<long long>(key) * kv_heads) * dk + d]
            : zero;
      }
      for (int i = tid; i < kBK * DVP; i += kThreads) {
        const int c = i / DVP, d = i % DVP;
        const int key = key0 + c;
        vs[c * kVS + d] = key < sk && d < dv
            ? v[(kv_row0 + static_cast<long long>(key) * kv_heads) * dv + d]
            : zero;
      }
    }
    if (tid < kBK) {
      const bool ok = key0 + tid < sk;
      cp_async4(smem_u32(stage_pos(s) + tid), pk_b + (ok ? key0 + tid : 0),
                ok);
    }
  };

  // ldmatrix lane addresses. A (Q, rows x d): lanes 0-7 rows 0-7 at d 0,
  // 8-15 rows 8-15 at d 0, 16-23 rows 0-7 at d 8, 24-31 rows 8-15 at d 8.
  // B of Q K^T (K, keys x d): lanes 0-7 keys 0-7 at d 0, 8-15 keys 0-7 at
  // d 8, 16-23 keys 8-15 at d 0, 24-31 keys 8-15 at d 8 -> b0, b1 of keys
  // 0-7, then of keys 8-15. B of P V (V, keys x dv, transposed): lanes 0-7
  // keys 0-7 at column 0, 8-15 keys 8-15 at 0, 16-23 keys 0-7 at 8, 24-31
  // keys 8-15 at 8 -> b0, b1 of columns 0-7, then of columns 8-15.
  const unsigned q_addr = smem_u32(
      qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kQS
      + (lane >> 4) * 8);
  const unsigned k_off =
      (((lane & 7) + ((lane >> 4) << 3)) * kQS + ((lane >> 3) & 1) * 8) * 2;
  const unsigned v_off =
      (((lane & 7) + ((lane >> 3) & 1) * 8) * kVS + (lane >> 4) * 8) * 2;

  cp_async_wait<0>();                  // Q has landed for every thread
  __syncthreads();
  unsigned qf[L::kQRegs ? DKP / 16 : 1][4];
  if constexpr (L::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < DKP / 16; ++kk)
      ldmatrix_x4(qf[kk], q_addr + kk * 32);
  }

  float o[NT][4];
  float m[2], l[2];
  for (int pass = 0; pass < 2; ++pass) {
    // pass 0 skips the tiles the scan found unseen; pass 1 runs only when
    // a real row ended pass 0 seeing no key, and walks every tile (such a
    // row averages V over all sk slots, as the reference does)
    const bool skip = pass == 0;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;

    int t_load = next_tile(0, skip), t_use = t_load;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (t_load < ntiles) {
        load_tile(t_load, s);
        t_load = next_tile(t_load + 1, skip);
      }
      cp_async_commit();
    }
    for (int it = 0; t_use < ntiles; ++it) {
      cp_async_wait<kStages - 2>();    // tile it has landed ...
      __syncthreads();                 // ... for every thread; tile it - 1's
      if (t_load < ntiles) {           // stage is free again
        load_tile(t_load, (it + kStages - 1) % kStages);
        t_load = next_tile(t_load + 1, skip);
      }
      cp_async_commit();
      const int s = it % kStages;
      const unsigned ks_addr = smem_u32(stage_k(s));
      const unsigned vs_addr = smem_u32(stage_v(s));
      const int* ps = stage_pos(s);
      const int key0 = t_use * kBK;
      const bool is_full = (full[t_use >> 5] >> (t_use & 31)) & 1u;

      // S = Q K^T: 16 rows x 64 keys per warp, eight n-tiles of 8 keys
      float sc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DKP / 16; ++kk) {
        unsigned a[4];
        if constexpr (L::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldmatrix_x4(a, q_addr + kk * 32);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          unsigned bb[4];
          ldmatrix_x4(bb, ks_addr + k_off + (jj * 16 * kQS + kk * 16) * 2);
          mma_bf16(sc[2 * jj], a, bb[0], bb[1]);
          mma_bf16(sc[2 * jj + 1], a, bb[2], bb[3]);
        }
      }

      // scale (log2 domain) and mask as the reference does: -1e30 for an
      // unseen key, -inf for a slot past sk; a full tile needs no mask
      if (is_full) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] *= scale_log2;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * tq;
          const int2 pk = *reinterpret_cast<const int2*>(ps + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = (e & 1) ? pk.y : pk.x;
            const int row_pq = pq[e >> 1];
            bool ok = p >= 0 && p <= row_pq;
            if (window >= 0) ok = ok && (row_pq - p) < window;
            const float x = sc[j][e] * scale_log2;
            sc[j][e] = key0 + c + (e & 1) >= sk ? -CUDART_INF_F
                       : ok ? x : kNegInf;
          }
        }
      }

      // online softmax in registers: a row's 64 scores lie in the 4 lanes
      // of a quad, 16 each
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
      const float corr[2] = {ex2(m[0] - mx[0]), ex2(m[1] - mx[1])};
      m[0] = mx[0];
      m[1] = mx[1];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = ex2(sc[j][e] - mx[e >> 1]);
          sum[e >> 1] += sc[j][e];
        }
      l[0] = l[0] * corr[0] + sum[0];      // this lane's part of the row
      l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }

      // O += P V: P rounded to bf16 straight from the score accumulators
      // (n-tiles 2kk and 2kk + 1 form the A fragment of keys 16kk..+15)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned pa[4] = {
            pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
            pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
            pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
            pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
        for (int jj = 0; jj < DVP / 16; ++jj) {
          unsigned bb[4];
          ldmatrix_x4_trans(bb, vs_addr + v_off
                                + (kk * 16 * kVS + jj * 16) * 2);
          mma_bf16(o[2 * jj], pa, bb[0], bb[1]);
          mma_bf16(o[2 * jj + 1], pa, bb[2], bb[3]);
        }
      }
      t_use = next_tile(t_use + 1, skip);
    }
    cp_async_wait<0>();
    const bool empty = (real[0] && m[0] == kNegInf)
                       || (real[1] && m[1] == kNegInf);
    if (pass == 1 || !__syncthreads_or(empty)) break;
  }

  // out = acc / max(l, 1e-30) in bf16 (times one reciprocal per row: at
  // most an ulp of float32 apart, far below bf16's); l summed over the
  // quad first
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    if (!real[h]) continue;
    if (lse != nullptr && tq == 0) {
      // m is in log2 units: lse = m ln 2 + log(max(l, 1e-30)); a row that
      // saw no key keeps the reference's -1e30
      const int gr = row0 + wrow + 8 * h;
      lse[(static_cast<long long>(blockIdx.y) * g + gr % g) * sq + gr / g] =
          m[h] == kNegInf ? kNegInf
                          : m[h] * kLn2 + logf(fmaxf(lh, 1e-30f));
    }
    __nv_bfloat16* dst = out + q_row(wrow + 8 * h) * dv;
    const float inv = 1.f / fmaxf(lh, 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * tq;
      const float x0 = o[n][2 * h] * inv, x1 = o[n][2 * h + 1] * inv;
      if (c + 1 < dv && (dv & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < dv) dst[c] = __float2bfloat16_rn(x0);
        if (c + 1 < dv) dst[c + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// The operands and sizes of one call; lse may be null.
struct Call {
  const void *q, *k, *v, *pos_q, *pos_k;
  void* out;
  float* lse;
  int b, sq, sk, kv_heads, g, dk, dv, window;
  float scale;
  cudaStream_t stream;
};

// Launches the instance for a's widths; with smem_bytes, only writes the
// dynamic shared memory that launch would take.
template <int DKP, int DVP>
int launch(const Call& a, size_t* smem_bytes) {
  using L = Layout<DKP, DVP>;
  const int words = ((a.sk + kBK - 1) / kBK + 31) / 32;
  const size_t bytes = L::mask_offset + 2 * sizeof(unsigned) * words;
  if (smem_bytes != nullptr) {
    *smem_bytes = bytes;
    return 0;
  }
  static bool configured = false;
  cudaError_t err = allow_smem(flash_tc_kernel<DKP, DVP>, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = a.dk % 8 == 0 && a.dv % 8 == 0
                  && reinterpret_cast<uintptr_t>(a.q) % 16 == 0
                  && reinterpret_cast<uintptr_t>(a.k) % 16 == 0
                  && reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  const long long blocks =
      (static_cast<long long>(a.sq) * a.g + kBQ - 1) / kBQ;
  dim3 grid(static_cast<unsigned>(blocks), a.b * a.kv_heads);
  flash_tc_kernel<DKP, DVP><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const int*>(a.pos_q), static_cast<const int*>(a.pos_k),
      static_cast<__nv_bfloat16*>(a.out), a.sq, a.sk, a.kv_heads, a.g, a.dk,
      a.dv, a.window, a.scale * kLog2e, words, vec, a.lse);
  return static_cast<int>(cudaGetLastError());
}

// dk and dv each round up to the least instantiated width (the repo's
// prefill head sizes: 64, 128, MLA's 192 / 128, recurrentgemma's 256);
// the columns past them are zeros, which add 0. A dv above 128 takes a dk
// width of at least 192, and a dv above 192 the (256, 256) instance: with
// a narrower dk beside the wide accumulator, ptxas spilled.
template <int DKP>
int launch_dv(const Call& a, size_t* smem_bytes) {
  if (a.dv <= 64) return launch<DKP, 64>(a, smem_bytes);
  return launch<DKP, 128>(a, smem_bytes);
}

int launch_widths(const Call& a, size_t* smem_bytes = nullptr) {
  if (a.dv > 192) return launch<256, 256>(a, smem_bytes);
  if (a.dv > 128)
    return a.dk <= 192 ? launch<192, 192>(a, smem_bytes)
                       : launch<256, 192>(a, smem_bytes);
  if (a.dk <= 64) return launch_dv<64>(a, smem_bytes);
  if (a.dk <= 128) return launch_dv<128>(a, smem_bytes);
  if (a.dk <= 192) return launch_dv<192>(a, smem_bytes);
  return launch_dv<256>(a, smem_bytes);
}

}  // namespace tc

bool dims_ok(int b, int sq, int sk, int kv_heads, int g, int dk, int dv) {
  return b > 0 && sq > 0 && sk > 0 && kv_heads > 0 && g > 0 && dk > 0
         && dv > 0 && dk <= kMaxDim && dv <= kMaxDim
         && static_cast<long long>(b) * kv_heads <= 65535
         && static_cast<long long>(sq) * g <= 2147483647;
}

}  // namespace

extern "C" {

// The tiled route. q (b, sq, kv_heads, g, dk), k (b, sk, kv_heads, dk), v
// (b, sk, kv_heads, dv), pos_q (sq,) and pos_k (b, sk) int32, out (b, sq,
// kv_heads, g, dv). window < 0: none. bf16: the tensors are bf16 (else
// float32). 1 <= dk, dv <= 576. lse: null, or float32 (b, kv_heads, g, sq)
// that takes each row's log-sum-exp m + log(max(l, 1e-30)) (every route).
int flash_attn_fwd(const void* q, const void* k, const void* v,
                   const void* pos_q, const void* pos_k, void* out, int b,
                   int sq, int sk, int kv_heads, int g, int dk, int dv,
                   int window, float scale, int bf16, void* lse,
                   void* stream) {
  if (!dims_ok(b, sq, sk, kv_heads, g, dk, dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const tiled::Call call{q, k, v, pos_q, pos_k, out,
                         static_cast<float*>(lse), b, sq, sk, kv_heads,
                         g, dk, dv, window, scale,
                         static_cast<cudaStream_t>(stream)};
  return bf16 ? tiled::launch_widths<__nv_bfloat16, 0, 0>(call)
              : tiled::launch_widths<float, 0, 0>(call);
}

// The tensor-core route: sizes as for flash_attn_fwd, bf16 tensors only,
// 1 <= dk, dv <= 256.
int flash_attn_tc(const void* q, const void* k, const void* v,
                  const void* pos_q, const void* pos_k, void* out, int b,
                  int sq, int sk, int kv_heads, int g, int dk, int dv,
                  int window, float scale, void* lse, void* stream) {
  if (!dims_ok(b, sq, sk, kv_heads, g, dk, dv) || dk > tc::kMaxDim
      || dv > tc::kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::Call call{q, k, v, pos_q, pos_k, out, static_cast<float*>(lse),
                      b, sq, sk, kv_heads, g, dk, dv, window, scale,
                      static_cast<cudaStream_t>(stream)};
  return tc::launch_widths(call);
}

// Bytes of dynamic shared memory the tensor-core route's block takes at
// these sizes (0 for sizes it refuses).
int flash_attn_tc_smem_bytes(int dk, int dv, int sk) {
  if (dk <= 0 || dv <= 0 || sk <= 0 || dk > tc::kMaxDim || dv > tc::kMaxDim)
    return 0;
  const tc::Call call{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, 1, 1, sk, 1, 1, dk, dv, -1, 1.f, nullptr};
  size_t bytes = 0;
  tc::launch_widths(call, &bytes);
  return static_cast<int>(bytes);
}

// How many key splits the split route uses for these sizes: the count
// that minimises an estimate of its time, ceil(blocks / (SMs x blocks per
// SM)) x key tiles per split (a slow SM's share of the waves, in units of
// one block's pass over one tile), plus the workspace's bytes (each split
// written and read once, the output written once) over what the card
// moves in one such unit (every resident block's tile). Each split gets at
// least one tile and none is empty. The caller gives a workspace of
// splits * pairs * rows * (dv + 2) floats. Returns 0 for sizes it refuses.
int flash_attn_split_kv_splits(int pairs, int rows, int sk, int dk, int dv,
                               int bf16, int sm_count) {
  if (pairs <= 0 || pairs > 65535 || rows <= 0 || sk <= 0 || dk <= 0
      || dv <= 0 || dk > kMaxDim || dv > kMaxDim || sm_count <= 0)
    return 0;
  const size_t elem = bf16 ? 2 : 4;
  const split::Geometry geo = split::geometry(rows, dk, dv, elem);
  int per_sm = 0;
  cudaError_t err = bf16
      ? split::configure_rb<__nv_bfloat16>(geo, &per_sm)
      : split::configure_rb<float>(geo, &per_sm);
  if (err != cudaSuccess || per_sm <= 0) return 0;
  const long long chunks = (rows + geo.rb - 1) / geo.rb;
  const long long resident = static_cast<long long>(sm_count) * per_sm;
  const int tiles = (sk + geo.tk - 1) / geo.tk;
  const double unit_bytes = static_cast<double>(resident) * geo.tk
                            * (dk + dv) * elem;
  const double ws_bytes = 4.0 * pairs * rows * (dv + 2);
  int best = 1;
  double best_cost = 0.0;
  for (int s = 1; s <= tiles && s <= split::kMaxSplits; ++s) {
    const int per_split = (tiles + s - 1) / s;
    if ((tiles + per_split - 1) / per_split != s) continue;  // none empty
    const long long waves = (pairs * chunks * s + resident - 1) / resident;
    double cost = static_cast<double>(waves) * per_split;
    if (s > 1) cost += (2.0 * s + 1.0) * ws_bytes / unit_bytes;
    if (s == 1 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// The split route: sizes as for flash_attn_fwd; workspace: splits * b *
// kv_heads * sq * g * (dv + 2) floats, from the caller; 1 <= splits <=
// 1024 (a split with no slot weighs 0).
int flash_attn_split_kv(const void* q, const void* k, const void* v,
                        const void* pos_q, const void* pos_k, void* out,
                        void* workspace, int b, int sq, int sk, int kv_heads,
                        int g, int dk, int dv, int window, float scale,
                        int bf16, int splits, void* lse, void* stream) {
  if (!dims_ok(b, sq, sk, kv_heads, g, dk, dv) || splits < 1
      || splits > split::kMaxSplits
      || static_cast<long long>(b) * ((static_cast<long long>(sq) * g + 3)
                                      / 4) > 65535
      || static_cast<long long>(b) * kv_heads * sq * g > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return split::launch<__nv_bfloat16>(q, k, v, pos_q, pos_k, out,
                                        workspace, b, sq, sk, kv_heads, g,
                                        dk, dv, window, scale, splits,
                                        static_cast<float*>(lse), s);
  return split::launch<float>(q, k, v, pos_q, pos_k, out, workspace, b, sq,
                              sk, kv_heads, g, dk, dv, window, scale, splits,
                              static_cast<float*>(lse), s);
}

}  // extern "C"
