// Bit-plane shift-and-add quantized matmul for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (repro_torch/kernels/_build.py).
//
// pim_matmul — replaces the TPU kernel
//   src/repro/kernels/pim_matmul/pim_matmul.py: pim_matmul_raw
//   -> _matmul_kernel.
// out[m, n] = scales[n] * sum_k x[m, k] * W[k, n], float32, with W int8
// codes (K, N) row-major and X (M, K) row-major, bf16 or float32.
//   shift_add: W is taken as BITS-bit two's complement (the low BITS bits
//     of each code); each thread keeps one float32 partial sum per bit
//     plane, sum_k x * bit_b(w), and at the end of every K tile folds them
//     into its output as acc = sum_b c_b * dot_b, out += acc, with
//     c = [1, 2, ..., -2^(BITS-1)] (ref.py: plane_coeffs) — the order of
//     the Pallas kernel, one "MXU pass" per plane.
//   dequant:   one partial sum, sum_k x * w, with the codes as they are.
// Products x * bit and x * w are exact in float32 (bf16 x, |w| <= 128), so
// the two modes and the plain version differ only in the order of float32
// additions.
//
// Bound on the card: the function moves X, W, scales and the float32
// output once and does 2*M*K*N operations. At the model's decode shapes
// (M = batch = 4, K x N = 2560 x 9728) it is bound by the bytes of W
// (~25 MB); at prefill (M = 512) by the operations. This first kernel runs
// on the CUDA cores, BITS multiply-adds per weight and row in shift_add, so
// at prefill it is far from the tensor-core bound; making it fast (planes
// through wgmma) is later work.
//
// Design: a block owns a BM x BN output tile; X and W tiles of depth kBK
// are staged in shared memory (X as float32, W as int codes, masked to
// BITS bits for shift_add); a thread owns TM x TN outputs. Any M, K, N:
// every load and store is bounds-checked. When the (M, N) tiles alone do
// not fill the card (decode), K is split over gridDim.z: each split writes
// its unscaled sums to a workspace, and a second kernel adds the splits in
// order and applies the scales, so the result does not depend on timing.
//
// Every entry takes device pointers, sizes and the caller's stream,
// launches without synchronising, allocates nothing and returns
// cudaGetLastError() (or cudaErrorInvalidValue for sizes it refuses).

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
  if (splits > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long mn = static_cast<long long>(m) * n;
    reduce_splits_kernel<<<static_cast<unsigned>((mn + kThreads - 1)
                                                 / kThreads),
                           kThreads, 0, s>>>(
        static_cast<const float*>(workspace),
        static_cast<const float*>(scales), static_cast<float*>(out), mn, n,
        splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
