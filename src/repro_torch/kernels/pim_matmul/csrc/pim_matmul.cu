// Bit-plane shift-and-add quantized matmul for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (repro_torch/kernels/_build.py).
//
// pim_matmul — replaces the TPU kernel
//   src/repro/kernels/pim_matmul/pim_matmul.py: pim_matmul_raw (:61)
//   -> _matmul_kernel (:35).
// out[m, n] = scales[n] * sum_k x[m, k] * W[k, n], float32, with W int8
// codes (K, N) row-major and X (M, K) row-major, bf16 or float32.
//   shift_add: W is taken as BITS-bit two's complement (the low BITS bits
//     of each code), one pass per bit plane with the plane weights
//     c = [1, 2, ..., -2^(BITS-1)] (ref.py: plane_coeffs) — the Pallas
//     kernel's one "MXU pass" per plane.
//   dequant:   one pass with the codes as they are.
// Products x * c_b * bit and x * w are exact in float32 (bf16 x, |w| <=
// 128), so the kernels and the plain version differ only in the order of
// float32 additions.
//
// Three kernels; ops.py::route picks one from the shapes and X's type alone.
//
// pim_matmul_tc_kernel (tensor cores; bf16 X, M >= the route's threshold,
// K % 8 == 0, N % 16 == 0). Bound on the card at the model's prefill
// shapes (M = 512, K x N = 2560 x 9728 and 9728 x 2560): 2*M*K*N
// operations at 989 TFLOP/s, 25.785 us for both; the plane floor, BITS
// tensor-core passes of 2*M*K*N each, is 103.1 us at w4 and 206.3 us at
// w8: the least a kernel doing one pass per plane can take. Design:
//   - mma.sync.m16n8k16 bf16 -> f32, issued from registers. The B
//     fragment of plane b holds c_b * bit_b(w) as bf16 (exact: a signed
//     power of two or zero), one MMA per plane per fragment; dequant's
//     fragment is the code itself as bf16 (exact for |w| <= 128). All
//     planes add into one float32 accumulator per output (per-plane
//     accumulators, 8 x a warp's 64 x 32 tile at w8, do not fit in
//     registers), so the Pallas kernel's per-K-tile fold
//     (acc = sum_b c_b * dot_b; out += acc) becomes another order of
//     float32 sums; the function is the same.
//   - Planes are built in registers. W stays int8 in shared memory, each
//     row padded to 144 bytes so the warp's word reads hit 32 banks. A
//     thread reads one 32-bit word (four neighbouring codes along N) at
//     each of its four k rows per k16 step; output column 4*g + j of the
//     warp's 32 is fragment j's column g, so byte j of that word is
//     fragment j's code and the thread ends up owning 8 neighbouring
//     output columns. One prmt per register pairs the two k codes of a
//     fragment into the halves of a word, and plane b is then
//     (v & (0x10001 << b)) * (bf16(c_b) >> b): two integer operations per
//     register, shared by the 4 m16 tiles of the warp.
//   - A 4-stage cp.async ring (16-byte cp.async.cg, zero fill past the M,
//     N and K edges and the split's end) of 128 x 32 bf16 X tiles (rows
//     padded to 80 bytes, conflict-free for ldmatrix.x4) and 32 x 128 int8
//     W tiles: 58 KB of dynamic shared memory, set with
//     cudaFuncSetAttribute. 8 warps as 2 x 4, each 64 x 32 outputs
//     (4 x 4 fragments, 64 float32 accumulators); at most 128 registers
//     so two blocks share an SM.
//   - Waves: 128 x 128 tiles give 4 x 76 = 304 blocks at N = 9728 and
//     4 x 20 = 80 at N = 2560. pim_matmul_tc_splits splits K when that
//     evens the blocks per SM: 3 ways at N = 2560 (240 blocks, two per SM
//     on 108 of the 132 SMs instead of one on 80), 2 ways at N = 9728 for
//     w4 (608 blocks, 4 or 5 per SM instead of 2 or 3); each split writes
//     unscaled sums to a workspace that reduce_splits_kernel adds in
//     order, so the result does not depend on timing (no atomics).
//
// pim_matmul_swap_kernel (tensor cores with the operands swapped; bf16 X
// with 1 <= M <= 16, K % 8 == 0, N % 16 == 0: decode). Bound at the
// model's decode shapes (M = batch = 4, K x N = 2560 x 9728 and 9728 x
// 2560) by the bytes of W: 24.9 MB at 3.35 TB/s, 7.5 us. Design:
//   - Y^T = W^T X^T on mma.sync.m16n8k16: W^T's 16-row tiles are the A
//     operand, the batch the B operand's 8 columns (two n8 fragments for
//     M > 8). The A fragment of plane b is built in registers as in the
//     tensor-core kernel: one prmt pairs the codes of k rows 2t and 2t+1
//     (or 2t+8 and 2t+9) into the halves of a word, then plane_frag or
//     code_frag. All planes add into one float32 accumulator per output.
//   - W is streamed once, straight into registers: a lane loads 16
//     neighbouring codes (one 16-byte load, L1 not allocated) at each of
//     its four k rows of a k16 step, so a warp reads 128 bytes of each of
//     16 rows: 128 output columns x 16 k per step. Byte 2j of a word is
//     row g of m16 tile j, byte 2j + 1 row g + 8 (lane g owns columns
//     16g..16g+15), so the C fragments land on 16 neighbouring columns
//     per lane. Two steps sit in registers, one computed while the next is
//     in flight; no load is masked (see the kernel). X's pairs come by
//     32-bit loads beside them. On the card, 16-byte loads into registers
//     streamed this pattern about as fast as a contiguous read, while a
//     per-lane cp.async ring of any depth stayed well below it
//     (PERF.md, Findings), so the ring lives in registers and a warp's
//     share of K stays short (about six steps at the decode shapes).
//   - A block of 8 warps owns 128 columns and one K range, each warp a
//     contiguous share of its k16 steps; the warps' sums meet in shared
//     memory and are added in warp order. N = 2560 has only 20 such
//     strips, so pim_matmul_swap_splits splits K to one wave of blocks
//     (two per SM at M <= 8): 13 ways at N = 2560, 3 at N = 9728, each
//     split written unscaled to a workspace that reduce_splits_kernel adds
//     in order, so the result does not depend on timing.
//
// pim_matmul_kernel (CUDA cores; float32 X, rows that are not 16-byte
// multiples). Bound at decode (M = batch = 4) by the bytes of
// W (~25 MB). A block owns a BM x BN output tile; X and W tiles of depth
// kBK are staged in shared memory (X as float32, W as int codes, masked to
// BITS bits for shift_add); a thread owns TM x TN outputs and keeps one
// float32 partial sum per plane, folded per K tile as the Pallas kernel
// does. Any M, K, N: every load and store is bounds-checked. When the
// (M, N) tiles alone do not fill the card, K is split over gridDim.z as
// above.
//
// Every entry takes device pointers, sizes and the caller's stream,
// launches without synchronising, allocates nothing and returns
// cudaGetLastError() (or cudaErrorInvalidValue for sizes it refuses).

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// BITS = 0: dequant; BITS = 4 or 8: shift_add over BITS planes.
template <typename T, int BITS, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
pim_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scales, float* __restrict__ out,
                  float* __restrict__ workspace, int m, int k, int n,
                  int k_per_split) {
  constexpr int TX = BN / TN;          // threads along N
  constexpr int TY = BM / TM;          // threads along M
  static_assert(TX * TY == kThreads, "tile does not match the block");
  constexpr int NP = BITS > 0 ? BITS : 1;

  __shared__ float xs[kBK][BM + 1];    // X tile, transposed; +1: no bank
  __shared__ int ws[kBK][BN];          // conflicts on the transposing store

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);

  float total[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) total[i][j] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;     // neighbours: neighbouring k
      const int gr = row0 + r, gk = kt + kk;
      xs[kk][r] = (gr < m && gk < k_end)
                      ? to_f32(x[static_cast<long long>(gr) * k + gk])
                      : 0.f;
    }
    for (int i = tid; i < kBK * BN; i += kThreads) {
      const int kk = i / BN, c = i % BN;       // neighbours: neighbouring n
      const int gk = kt + kk, gc = col0 + c;
      int v = (gk < k_end && gc < n)
                  ? static_cast<int>(w[static_cast<long long>(gk) * n + gc])
                  : 0;
      if (BITS > 0) v &= (1 << BITS) - 1;
      ws[kk][c] = v;
    }
    __syncthreads();

    float part[NP][TM][TN];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[p][i][j] = 0.f;

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float xv[TM];
      int wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float f = BITS > 0 ? static_cast<float>((wv[j] >> p) & 1)
                                   : static_cast<float>(wv[j]);
#pragma unroll
          for (int i = 0; i < TM; ++i)
            part[p][i][j] = fmaf(xv[i], f, part[p][i][j]);
        }
      }
    }
    __syncthreads();

    // the fold of the Pallas kernel: acc = sum_b c_b * dot_b; out += acc
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float c = BITS == 0 ? 1.f
                          : (p == BITS - 1 ? -static_cast<float>(1 << p)
                                           : static_cast<float>(1 << p));
          acc += c * part[p][i][j];
        }
        total[i][j] += acc;
      }
  }

  const bool split = gridDim.z > 1;
  float* dst = split ? workspace + static_cast<long long>(blockIdx.z) * m * n
                     : out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c >= n) continue;
      dst[static_cast<long long>(r) * n + c] =
          split ? total[i][j] : total[i][j] * scales[c];
    }
  }
}

// out[i] = (sum over splits, in order) * scales[i % n]
__global__ void reduce_splits_kernel(const float* __restrict__ workspace,
                                     const float* __restrict__ scales,
                                     float* __restrict__ out, long long mn,
                                     int n, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += workspace[z * mn + i];
  out[i] = s * scales[i % n];
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (see the note at the head of the file)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 4;
constexpr int kThreads = 256;                 // 8 warps, 2 (M) x 4 (N)
constexpr int kXStride = kBK + 8;             // bf16 per X row in shared
constexpr int kWStride = kBN + 16;            // bytes per W row in shared
constexpr int kXBytes = kBM * kXStride * 2;   // 10,240
constexpr int kWBytes = kBK * kWStride;       // 4,608
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kSmemBytes = kStages * kStageBytes;   // 59,392
static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src-size 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b,
                                         unsigned sel) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// bf16 bits of plane b's weight: 2^b, or -2^b for the sign plane
__host__ __device__ constexpr unsigned plane_bf16(int b, int bits) {
  return (b == bits - 1 ? 0x8000u : 0u) | ((127u + b) << 7);
}

// The B fragment of plane b from v, which holds two codes as the halves of
// a word: each half becomes bf16(c_b) where bit b of its code is set, else
// 0. (v & (1 << b)) is 0 or 2^b in each half, and bf16(c_b) has at least
// seven trailing zero bits (b <= 7), so the product is exact and stays in
// its half. Called with b a constant of an unrolled loop.
template <int BITS>
__device__ __forceinline__ unsigned plane_frag(unsigned v, int b) {
  return (v & (0x00010001u << b)) * (plane_bf16(b, BITS) >> b);
}

// dequant's B fragment: byte j of a (at k) and of b (at k + 1), the int8
// codes themselves, as bf16 (exact for |w| <= 128)
__device__ __forceinline__ unsigned code_frag(unsigned a, unsigned b,
                                              int j) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(
      static_cast<float>(static_cast<signed char>(a >> (8 * j))),
      static_cast<float>(static_cast<signed char>(b >> (8 * j))));
  return *reinterpret_cast<const unsigned*>(&h);
}

// BITS = 0: dequant; BITS = 4 or 8: shift_add over BITS planes.
template <int BITS>
__global__ void __launch_bounds__(kThreads, 2)
pim_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scales,
                     float* __restrict__ out, float* __restrict__ workspace,
                     int m, int k, int n, int k_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const int k_tiles = (k_end - k_begin + kBK - 1) / kBK;
  const unsigned smem0 = smem_u32(smem);

  // one stage: X kBM rows x kBK / 8 chunks, W kBK rows x kBN / 16 chunks,
  // 16 bytes each; K % 8 == 0 and N % 16 == 0, so a chunk is wholly
  // inside or wholly outside the operands
  constexpr int kXChunks = kBM * kBK / 8 / kThreads;   // per thread
  constexpr int kWChunks = kBK * kBN / 16 / kThreads;
  static_assert(kXChunks * kThreads * 8 == kBM * kBK
                && kWChunks * kThreads * 16 == kBK * kBN,
                "tiles must split evenly over the threads");
  auto load = [&](int stage, int kt) {
    const int k0 = k_begin + kt * kBK;
    const unsigned xs = smem0 + stage * kStageBytes;
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBK / 8), kc = c % (kBK / 8) * 8;
      const int gr = row0 + r, gk = k0 + kc;
      const bool ok = gr < m && gk < k_end;
      cp_async16(xs + (r * kXStride + kc) * 2,
                 ok ? x + static_cast<long long>(gr) * k + gk : x, ok);
    }
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBN / 16), nc = c % (kBN / 16) * 16;
      const int gk = k0 + r, gc = col0 + nc;
      const bool ok = gk < k_end && gc < n;
      cp_async16(xs + kXBytes + r * kWStride + nc,
                 ok ? w + static_cast<long long>(gk) * n + gc : w, ok);
    }
  };

  float acc[4][4][4];                 // [m16 tile][n8 fragment][C reg]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }

  // ldmatrix.x4 rows: lanes 0-7 rows 0-7 at k 0, 8-15 rows 8-15 at k 0,
  // 16-23 rows 0-7 at k 8, 24-31 rows 8-15 at k 8 -> a0..a3 of m16n8k16
  const unsigned a_off =
      ((warp_m * 64 + (lane & 7) + ((lane >> 3) & 1) * 8) * kXStride
       + (lane >> 4) * 8) * 2;
  // this thread's code words: k rows 2t, 2t+1, 2t+8, 2t+9 of a k16 step,
  // columns 4g..4g+3 of the warp's 32
  const int w_off = kXBytes + 2 * t * kWStride + warp_n * 32 + 4 * g;

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();     // tile kt has landed ...
    __syncthreads();                  // ... for every thread, and tile
    {                                 // kt - 1's stage is free again
      const int next = kt + kStages - 1;
      if (next < k_tiles) load(next % kStages, next);
      cp_async_commit();
    }
    const int stage = kt % kStages;
    const unsigned xs = smem0 + stage * kStageBytes;
    const unsigned char* ws = smem + stage * kStageBytes + w_off;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      unsigned a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], xs + a_off + (i * 16 * kXStride + ks) * 2);
      const unsigned* wk = reinterpret_cast<const unsigned*>(
          ws + ks * kWStride);
      const unsigned u0 = wk[0], u1 = wk[kWStride / 4];
      const unsigned u8 = wk[8 * kWStride / 4], u9 = wk[9 * kWStride / 4];
      if constexpr (BITS == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned b0 = code_frag(u0, u1, j);
          const unsigned b1 = code_frag(u8, u9, j);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
        }
      } else {
        // fragment j's codes: byte j of the k and k+1 words in the low and
        // high halves (the b0 and b1 registers' k pairs)
        unsigned v0[4], v1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned sel = j | (4 + j) << 8;
          v0[j] = prmt(u0, u1, sel);
          v1[j] = prmt(u8, u9, sel);
        }
        // plane outermost: two MMAs into one accumulator are 16 apart
#pragma unroll
        for (int b = 0; b < BITS; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const unsigned b0 = plane_frag<BITS>(v0[j], b);
            const unsigned b1 = plane_frag<BITS>(v1[j], b);
#pragma unroll
            for (int i = 0; i < 4; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
          }
      }
    }
  }

  // C fragment j of m16 tile i: rows g and g+8, logical columns 2t and
  // 2t+1, which are the warp's columns 8t + j and 8t + 4 + j: the thread
  // owns columns 8t..8t+7 of each of its rows
  const bool split = gridDim.z > 1;
  float* dst = split ? workspace + static_cast<long long>(blockIdx.z) * m * n
                     : out;
  const int c = col0 + warp_n * 32 + 8 * t;
  if (c >= n) return;                 // N % 16 == 0: all 8 in or all out
  float4 s0 = make_float4(1.f, 1.f, 1.f, 1.f), s1 = s0;
  if (!split) {
    s0 = *reinterpret_cast<const float4*>(scales + c);
    s1 = *reinterpret_cast<const float4*>(scales + c + 4);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + warp_m * 64 + i * 16 + g + 8 * h;
      if (r >= m) continue;
      float4* p = reinterpret_cast<float4*>(dst + static_cast<long long>(r)
                                            * n + c);
      p[0] = make_float4(acc[i][0][2 * h] * s0.x, acc[i][1][2 * h] * s0.y,
                         acc[i][2][2 * h] * s0.z, acc[i][3][2 * h] * s0.w);
      p[1] = make_float4(acc[i][0][2 * h + 1] * s1.x,
                         acc[i][1][2 * h + 1] * s1.y,
                         acc[i][2][2 * h + 1] * s1.z,
                         acc[i][3][2 * h + 1] * s1.w);
    }
}

template <int BITS>
cudaError_t launch(const void* x, const void* w, const void* scales,
                   void* out, void* workspace, int m, int k, int n,
                   int splits, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only once allowed, per device
  static std::atomic<unsigned long long> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(allowed.load() & bit)) {
    err = cudaFuncSetAttribute(pim_matmul_tc_kernel<BITS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  const int k_per_split = ((k + splits - 1) / splits + kBK - 1) / kBK * kBK;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, splits);
  pim_matmul_tc_kernel<BITS><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<float*>(out),
      static_cast<float*>(workspace), m, k, n, k_per_split);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Swapped-operand tensor-core kernel (see the note at the head of the file)
// ---------------------------------------------------------------------------

namespace swap {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kBN = 128;        // output columns per block (and per warp)
constexpr int kMaxM = 16;       // two n8 fragments

// 16 bytes of W; not kept in L1, since each weight byte is read once
__device__ __forceinline__ uint4 ld_stream(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned word(const uint4& u, int q) {
  return q == 0 ? u.x : q == 1 ? u.y : q == 2 ? u.z : u.w;
}

// One k16 step of a warp: w holds this lane's 16 codes at k rows 2t, 2t+1,
// 2t+8 and 2t+9; xf[f] X's B fragment of rows 8f..8f+7. Tile j's A rows g
// and g + 8 are bytes 2j and 2j + 1 of the lane's codes; tiles go four at
// a time, planes outermost, so MMAs into one accumulator are four apart.
template <int BITS, int MF>
__device__ __forceinline__ void step(float (&acc)[8][MF][4],
                                     const uint4 (&w)[4],
                                     const unsigned (&xf)[MF][2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    unsigned v[4][4];                  // [tile][A register]
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * half + jj, q = j >> 1, lo = 2 * (j & 1);
      const unsigned w0 = word(w[0], q), w1 = word(w[1], q);
      const unsigned w8 = word(w[2], q), w9 = word(w[3], q);
      if constexpr (BITS == 0) {
        v[jj][0] = tc::code_frag(w0, w1, lo);
        v[jj][1] = tc::code_frag(w0, w1, lo + 1);
        v[jj][2] = tc::code_frag(w8, w9, lo);
        v[jj][3] = tc::code_frag(w8, w9, lo + 1);
      } else {
        // byte b of the k row's word into the low byte of the low half,
        // the k + 1 row's into the high half
        const unsigned sel_g = lo | (4 + lo) << 8;
        const unsigned sel_g8 = (lo + 1) | (5 + lo) << 8;
        v[jj][0] = tc::prmt(w0, w1, sel_g);
        v[jj][1] = tc::prmt(w0, w1, sel_g8);
        v[jj][2] = tc::prmt(w8, w9, sel_g);
        v[jj][3] = tc::prmt(w8, w9, sel_g8);
      }
    }
    if constexpr (BITS == 0) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int f = 0; f < MF; ++f)
          tc::mma_bf16(acc[4 * half + jj][f], v[jj], xf[f][0], xf[f][1]);
    } else {
#pragma unroll
      for (int b = 0; b < BITS; ++b)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const unsigned a[4] = {tc::plane_frag<BITS>(v[jj][0], b),
                                 tc::plane_frag<BITS>(v[jj][1], b),
                                 tc::plane_frag<BITS>(v[jj][2], b),
                                 tc::plane_frag<BITS>(v[jj][3], b)};
#pragma unroll
          for (int f = 0; f < MF; ++f)
            tc::mma_bf16(acc[4 * half + jj][f], a, xf[f][0], xf[f][1]);
        }
    }
  }
}

// BITS = 0: dequant; BITS = 4 or 8: shift_add over BITS planes. MF: n8
// fragments of the batch (1 for M <= 8, 2 for M <= 16).
template <int BITS, int MF>
__global__ void __launch_bounds__(kThreads, MF == 1 ? 2 : 1)
pim_matmul_swap_kernel(const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scales,
                       float* __restrict__ out, float* __restrict__ workspace,
                       int m, int k, int n, int k_per_split) {
  __shared__ __align__(16) float sums[kWarps][8][kBN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const int steps = max(0, (k_end - k_begin + 15) / 16);
  const int per_warp = (steps + kWarps - 1) / kWarps;
  const int s_begin = warp * per_warp;
  const int s_end = min(steps, s_begin + per_warp);

  // No load is masked: a lane past N reads the last 16 columns and a
  // batch row past M reads row M - 1, whose products land only in outputs
  // that are never stored. K % 8 == 0 and k_per_split % 16 == 0, so only
  // rows 2t+8, 2t+9 of a K range's last step can lie past its end: they
  // read rows 2t, 2t+1 again against a zero X pair.
  // Running pointers, advanced one k16 step per load: W's row 2t of the
  // step (rows 2t+1, 2t+8, 2t+9 at n, 8n, 9n past it) and X's pair
  const long long n1 = n, n8 = 8LL * n, step_bytes = 16LL * n;
  const int8_t* wp = w + static_cast<long long>(k_begin + 16 * s_begin
                                                + 2 * t) * n
                     + min(n0 + 16 * g, n - 16);
  const unsigned* xp[MF];
#pragma unroll
  for (int f = 0; f < MF; ++f)
    xp[f] = reinterpret_cast<const unsigned*>(
        x + static_cast<long long>(min(8 * f + g, m - 1)) * k + k_begin
        + 16 * s_begin + 2 * t);
  int rows_left = k_end - k_begin - 16 * s_begin;   // from the next step
  auto load = [&](uint4 (&wr)[4], unsigned (&xr)[MF][2]) {
    const bool hi = rows_left >= 16;
    const int8_t* p8 = hi ? wp + n8 : wp;
    wr[0] = ld_stream(wp);
    wr[1] = ld_stream(wp + n1);
    wr[2] = ld_stream(p8);
    wr[3] = ld_stream(p8 + n1);
#pragma unroll
    for (int f = 0; f < MF; ++f) {
      xr[f][0] = __ldg(xp[f]);
      xr[f][1] = hi ? __ldg(xp[f] + 4) : 0u;
      xp[f] += 8;
    }
    wp += step_bytes;
    rows_left -= 16;
  };

  float acc[8][MF][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][f][r] = 0.f;

  // two steps in registers: one computed while the next is in flight
  const int count = s_end - s_begin;
  uint4 wa[4], wb[4];
  unsigned xa[MF][2], xb[MF][2];
  if (count > 0) load(wa, xa);
  if (count > 1) load(wb, xb);
  for (int i = 0; i < count; i += 2) {
    step<BITS>(acc, wa, xa);
    if (i + 2 < count) load(wa, xa);
    if (i + 1 < count) {
      step<BITS>(acc, wb, xb);
      if (i + 3 < count) load(wb, xb);
    }
  }

  // C fragment of tile j, batch fragment f: rows g, g + 8 -> columns
  // 16g + 2j, 16g + 2j + 1; columns 2t, 2t+1 -> batch rows 8f + 2t, +1.
  // The warps' sums meet in shared memory, added in warp order.
  const bool split = gridDim.y > 1;
  float* dst = split ? workspace + static_cast<long long>(blockIdx.y) * m * n
                     : out;
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    if (f) __syncthreads();           // the last fragment's sums are read
    float4* r0 = reinterpret_cast<float4*>(&sums[warp][2 * t][16 * g]);
    float4* r1 = reinterpret_cast<float4*>(&sums[warp][2 * t + 1][16 * g]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r0[i] = make_float4(acc[2 * i][f][0], acc[2 * i][f][2],
                          acc[2 * i + 1][f][0], acc[2 * i + 1][f][2]);
      r1[i] = make_float4(acc[2 * i][f][1], acc[2 * i][f][3],
                          acc[2 * i + 1][f][1], acc[2 * i + 1][f][3]);
    }
    __syncthreads();
    for (int i = tid; i < 8 * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int row = 8 * f + r, col = n0 + c;
      if (row >= m || col >= n) continue;
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) s += sums[v][r][c];
      dst[static_cast<long long>(row) * n + col] = split ? s
                                                         : s * scales[col];
    }
  }
}

template <int BITS, int MF>
cudaError_t launch(const void* x, const void* w, const void* scales,
                   void* out, void* workspace, int m, int k, int n,
                   int splits, cudaStream_t stream) {
  const int steps = (k + 15) / 16;
  const int k_per_split = (steps + splits - 1) / splits * 16;
  dim3 grid((n + kBN - 1) / kBN, splits);
  pim_matmul_swap_kernel<BITS, MF><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<float*>(out),
      static_cast<float*>(workspace), m, k, n, k_per_split);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_m(const void* x, const void* w, const void* scales,
                     void* out, void* workspace, int m, int k, int n,
                     int splits, cudaStream_t stream) {
  return m <= 8 ? launch<BITS, 1>(x, w, scales, out, workspace, m, k, n,
                                   splits, stream)
                : launch<BITS, 2>(x, w, scales, out, workspace, m, k, n,
                                  splits, stream);
}

}  // namespace swap

struct Tile {
  int bm, bn;
};

// The tile the host picks for (m, bits): a thin one for decode-sized M
// (every thread one column, all rows), a square-ish one otherwise.
Tile tile_for(int m, int bits) {
  if (m <= 4) return {4, 256};
  if (m <= 8) return {8, 256};
  if (bits == 8) return {32, 64};
  return {64, 64};
}

template <typename T, int BITS, int BM, int BN, int TM, int TN>
void launch_tile(const void* x, const void* w, const void* scales,
                 void* out, void* workspace, int m, int k, int n,
                 int splits, cudaStream_t stream) {
  const int k_per_split = ((k + splits - 1) / splits + kBK - 1) / kBK * kBK;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  pim_matmul_kernel<T, BITS, BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<float*>(out),
      static_cast<float*>(workspace), m, k, n, k_per_split);
}

template <typename T, int BITS>
void launch_bits(const void* x, const void* w, const void* scales,
                 void* out, void* workspace, int m, int k, int n,
                 int splits, cudaStream_t stream) {
  const Tile t = tile_for(m, BITS);
  if (t.bm == 4)
    launch_tile<T, BITS, 4, 256, 4, 1>(x, w, scales, out, workspace, m, k,
                                       n, splits, stream);
  else if (t.bm == 8)
    launch_tile<T, BITS, 8, 256, 8, 1>(x, w, scales, out, workspace, m, k,
                                       n, splits, stream);
  else if (t.bm == 32)
    launch_tile<T, BITS, 32, 64, 2, 4>(x, w, scales, out, workspace, m, k,
                                       n, splits, stream);
  else
    launch_tile<T, BITS, 64, 64, 4, 4>(x, w, scales, out, workspace, m, k,
                                       n, splits, stream);
}

template <typename T>
void launch_mode(const void* x, const void* w, const void* scales,
                 void* out, void* workspace, int m, int k, int n, int mode,
                 int bits, int splits, cudaStream_t stream) {
  if (mode == 1)
    launch_bits<T, 0>(x, w, scales, out, workspace, m, k, n, splits, stream);
  else if (bits == 4)
    launch_bits<T, 4>(x, w, scales, out, workspace, m, k, n, splits, stream);
  else
    launch_bits<T, 8>(x, w, scales, out, workspace, m, k, n, splits, stream);
}

// the ordered sum of the splits, scaled, into out (when there are splits)
cudaError_t reduce_splits(const void* workspace, const void* scales,
                          void* out, int m, int n, int splits,
                          cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = static_cast<long long>(m) * n;
  reduce_splits_kernel<<<static_cast<unsigned>((mn + kThreads - 1)
                                               / kThreads),
                         kThreads, 0, s>>>(
      static_cast<const float*>(workspace),
      static_cast<const float*>(scales), static_cast<float*>(out), mn, n,
      splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// How many K splits a call of these sizes uses: enough (M, N) tiles x
// splits to give every SM two blocks, each split at least one K tile.
// The caller gives a workspace of splits * m * n floats when this is > 1.
int pim_matmul_splits(int m, int k, int n, int bits, int sm_count) {
  if (m <= 0 || n <= 0 || k <= 0) return 1;
  const Tile t = tile_for(m, bits);
  const long long tiles = static_cast<long long>((m + t.bm - 1) / t.bm)
                          * ((n + t.bn - 1) / t.bn);
  const long long want = (2LL * sm_count + tiles - 1) / tiles;
  const int k_tiles = (k + kBK - 1) / kBK;
  int splits = static_cast<int>(want < k_tiles ? want : k_tiles);
  splits = splits < 1 ? 1 : (splits > 32 ? 32 : splits);
  // no split may be empty
  const int k_per_split = ((k + splits - 1) / splits + kBK - 1) / kBK * kBK;
  return (k + k_per_split - 1) / k_per_split;
}

// mode: 0 = shift_add, 1 = dequant; bits: 4 or 8; x_bf16: X is bf16
// (else float32). out: (m, n) float32; workspace: splits * m * n floats
// (unused when splits == 1).
int pim_matmul(const void* x, const void* w, const void* scales, void* out,
               void* workspace, int m, int k, int n, int mode, int bits,
               int x_bf16, int splits, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || splits < 1 || splits > 64
      || (mode != 0 && mode != 1) || (bits != 4 && bits != 8)
      || (m + 3) / 4 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    launch_mode<__nv_bfloat16>(x, w, scales, out, workspace, m, k, n, mode,
                               bits, splits, s);
  else
    launch_mode<float>(x, w, scales, out, workspace, m, k, n, mode, bits,
                       splits, s);
  return static_cast<int>(reduce_splits(workspace, scales, out, m, n,
                                         splits, s));
}

// K splits of the tensor-core kernel: the count in 1..8 that minimises
// an estimate of its time, ceil(blocks / SMs) x K tiles per split x
// planes in units of one block's pass over one K tile (a slow SM's share
// of the waves), plus the workspace's bytes for more than one split (each
// split written and read once, the output written once) in the same
// units: kSplitBytesPerUnit is what the card's memory moves in one unit.
// planes: BITS for shift_add, 1 for dequant.
int pim_matmul_tc_splits(int m, int k, int n, int planes, int sm_count) {
  constexpr double kSplitBytesPerUnit = 780e3;
  if (m <= 0 || n <= 0 || k <= 0 || planes <= 0 || sm_count <= 0) return 1;
  const long long tiles = static_cast<long long>((m + tc::kBM - 1)
                                                 / tc::kBM)
                          * ((n + tc::kBN - 1) / tc::kBN);
  const int k_tiles = (k + tc::kBK - 1) / tc::kBK;
  int best = 1;
  double best_cost = 0.0;
  for (int s = 1; s <= 8 && s <= k_tiles; ++s) {
    const int per_split = (k_tiles + s - 1) / s;
    const int splits = (k_tiles + per_split - 1) / per_split;   // none empty
    if (splits != s) continue;
    const long long waves = (tiles * s + sm_count - 1) / sm_count;
    double cost = static_cast<double>(waves) * per_split * planes;
    if (s > 1)
      cost += (2.0 * s + 1.0) * 4.0 * m * n / kSplitBytesPerUnit;
    if (s == 1 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// Dynamic shared memory of one tensor-core block, in bytes.
int pim_matmul_tc_smem_bytes() { return tc::kSmemBytes; }

// The tensor-core kernel: x (m, k) bf16, w (k, n) int8 codes, scales (n,)
// float32, out (m, n) float32; mode and bits as for pim_matmul; workspace:
// splits * m * n floats (unused when splits == 1). Takes k % 8 == 0 and
// n % 16 == 0 (rows of 16-byte multiples) and 16-byte aligned x and w.
int pim_matmul_tc(const void* x, const void* w, const void* scales,
                  void* out, void* workspace, int m, int k, int n, int mode,
                  int bits, int splits, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || splits < 1 || splits > 64
      || (mode != 0 && mode != 1) || (bits != 4 && bits != 8)
      || k % 8 != 0 || n % 16 != 0 || (m + tc::kBM - 1) / tc::kBM > 65535
      || reinterpret_cast<uintptr_t>(x) % 16
      || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == 1)
    err = tc::launch<0>(x, w, scales, out, workspace, m, k, n, splits, s);
  else if (bits == 4)
    err = tc::launch<4>(x, w, scales, out, workspace, m, k, n, splits, s);
  else
    err = tc::launch<8>(x, w, scales, out, workspace, m, k, n, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_splits(workspace, scales, out, m, n,
                                         splits, s));
}

// K splits of the swapped-operand kernel: as many as fit one wave of
// blocks (two per SM at M <= 8, one above: the registers' limit) over the
// 128-column strips, at most one per kWarps k16 steps (a step per warp)
// and 64, none empty. The rule is the same at every width and mode (bits
// is not read): the weight bytes, not the planes, set the time.
int pim_matmul_swap_splits(int m, int k, int n, int bits, int sm_count) {
  (void)bits;
  if (m <= 0 || n <= 0 || k <= 0 || sm_count <= 0) return 1;
  const int strips = (n + swap::kBN - 1) / swap::kBN;
  const int steps = (k + 15) / 16;
  int splits = (m <= 8 ? 2 : 1) * sm_count / strips;
  const int most = steps / swap::kWarps;
  splits = splits > most ? most : splits;
  splits = splits < 1 ? 1 : (splits > 64 ? 64 : splits);
  const int per_split = (steps + splits - 1) / splits;
  return (steps + per_split - 1) / per_split;
}

// The swapped-operand kernel: x (m, k) bf16 with 1 <= m <= 16, w (k, n)
// int8 codes, scales (n,) float32, out (m, n) float32; mode and bits as
// for pim_matmul; workspace: splits * m * n floats (unused when splits ==
// 1). Takes k % 8 == 0 and n % 16 == 0 and 16-byte aligned x and w.
int pim_matmul_swap(const void* x, const void* w, const void* scales,
                    void* out, void* workspace, int m, int k, int n,
                    int mode, int bits, int splits, void* stream) {
  if (m <= 0 || m > swap::kMaxM || n <= 0 || k <= 0 || splits < 1
      || splits > 64 || (mode != 0 && mode != 1) || (bits != 4 && bits != 8)
      || k % 8 != 0 || n % 16 != 0
      || reinterpret_cast<uintptr_t>(x) % 16
      || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == 1)
    err = swap::launch_m<0>(x, w, scales, out, workspace, m, k, n, splits, s);
  else if (bits == 4)
    err = swap::launch_m<4>(x, w, scales, out, workspace, m, k, n, splits, s);
  else
    err = swap::launch_m<8>(x, w, scales, out, workspace, m, k, n, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_splits(workspace, scales, out, m, n,
                                         splits, s));
}

}  // extern "C"
