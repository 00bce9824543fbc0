// Row kernels of the PIM executor for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (repro_torch/kernels/_build.py).
//
// Rows are (N, W) words: N independent DRAM rows of W packed 32-bit words,
// column c = bit c%32 (little-endian) of word c//32. PyTorch holds them as
// int32 bit patterns; the kernels read them as uint32 so that shifts are
// logical.
//
// Every entry takes device pointers, int sizes and the caller's stream,
// launches without synchronising, allocates nothing and returns
// cudaGetLastError(). Outputs are always separate buffers (out of place).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// shift_cols — replaces the TPU kernel
//   src/repro/kernels/rowops/rowops.py: shift_cols -> _shift_kernel
//   -> _shift_cols_block.
// out[r, j] = (x[r, j-kw] << kb) | (x[r, j-kw-1] >> (32-kb)) for k > 0
// (mirrored for k < 0); indices outside [0, W) read 0, and |k| >= 32*W
// (kw >= W) gives zeros. One thread per output word; a thread reads its
// neighbour's input word, hence out of place.
// Bound on the card: bytes, 8*N*W (each word read once, written once).
// At the executor's shapes (N = 1..64 slots, W = 2048) a call moves 8 KiB
// to 512 KiB and is bound by the launch, not by the memory; the executor
// answers that by shifting every slot of a stream group in one launch.
// k stays a runtime argument: the main path sees many different k.
// ---------------------------------------------------------------------------
__global__ void shift_cols_kernel(const uint32_t* __restrict__ x,
                                  uint32_t* __restrict__ out,
                                  int n, int w, int kw, int kb, int up) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x
                  + threadIdx.x;
  long long total = static_cast<long long>(n) * w;
  if (idx >= total) return;
  int j = static_cast<int>(idx % w);
  const uint32_t* row = x + (idx - j);
  uint32_t v;
  if (up) {
    int s = j - kw;                      // source of the high part
    uint32_t hi = (s >= 0 && s < w) ? row[s] : 0u;
    if (kb) {
      uint32_t lo = (s - 1 >= 0 && s - 1 < w) ? row[s - 1] : 0u;
      v = (hi << kb) | (lo >> (32 - kb));
    } else {
      v = hi;
    }
  } else {
    int s = j + kw;                      // source of the low part
    uint32_t lo = (s >= 0 && s < w) ? row[s] : 0u;
    if (kb) {
      uint32_t hi = (s + 1 >= 0 && s + 1 < w) ? row[s + 1] : 0u;
      v = (lo >> kb) | (hi << (32 - kb));
    } else {
      v = lo;
    }
  }
  out[idx] = v;
}

// ---------------------------------------------------------------------------
// bitwise — replaces the TPU kernel
//   src/repro/kernels/rowops/rowops.py: bitwise -> _bitwise_kernel.
// Elementwise not/and/or/xor/maj, maj = (a&b)|(b&c)|(a&c).
// Bound on the card: bytes, 4*(ops+1)*N*W (ops = operands read).
// At the executor's shapes (N = 1..64, W = 2048) it is launch-bound, like
// shift_cols, and batched per stream group the same way. Four words per
// thread through 16-byte loads when every pointer is 16-byte aligned and
// the count divides by 4.
// ---------------------------------------------------------------------------
enum BitOp { kNot = 0, kAnd = 1, kOr = 2, kXor = 3, kMaj = 4 };

template <typename T>
__device__ __forceinline__ T apply_op(int op, T a, T b, T c) {
  switch (op) {
    case kNot: return ~a;
    case kAnd: return a & b;
    case kOr:  return a | b;
    case kXor: return a ^ b;
    default:   return (a & b) | (b & c) | (a & c);
  }
}

__global__ void bitwise_kernel(const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b,
                               const uint32_t* __restrict__ c,
                               uint32_t* __restrict__ out,
                               long long total, int op) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                + threadIdx.x;
  if (i >= total) return;
  uint32_t av = a[i];
  uint32_t bv = (op != kNot) ? b[i] : 0u;
  uint32_t cv = (op == kMaj) ? c[i] : 0u;
  out[i] = apply_op<uint32_t>(op, av, bv, cv);
}

__global__ void bitwise_vec4_kernel(const uint4* __restrict__ a,
                                    const uint4* __restrict__ b,
                                    const uint4* __restrict__ c,
                                    uint4* __restrict__ out,
                                    long long total4, int op) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                + threadIdx.x;
  if (i >= total4) return;
  uint4 av = a[i];
  uint4 bv = (op != kNot) ? b[i] : make_uint4(0u, 0u, 0u, 0u);
  uint4 cv = (op == kMaj) ? c[i] : make_uint4(0u, 0u, 0u, 0u);
  uint4 r;
  r.x = apply_op<uint32_t>(op, av.x, bv.x, cv.x);
  r.y = apply_op<uint32_t>(op, av.y, bv.y, cv.y);
  r.z = apply_op<uint32_t>(op, av.z, bv.z, cv.z);
  r.w = apply_op<uint32_t>(op, av.w, bv.w, cv.w);
  out[i] = r;
}

// ---------------------------------------------------------------------------
// meter_fold — a helper, not a port of a TPU kernel. It replaces the XLA
// scan _fold_tables (src/repro/core/pim/compile.py), which folds per-event
// increment tables onto the cost meter in program order.
// One thread per (slot, field): a strictly sequential loop of __fadd_rn
// (float fields; no contraction, no reassociation) or wrapping int adds
// over the m table rows, so the meter equals the eager ISA's to the last
// ulp. The block stages tiles of the tables in shared memory with
// coalesced loads, and every thread folds its column from there.
// Bound on the card: the m*(F+G) dependent adds of one column run in
// sequence; at m ~ 4,000 events that chain, not the bytes, sets the time.
// ---------------------------------------------------------------------------
constexpr int kFoldTile = 256;          // table rows staged per pass
constexpr int kFoldMaxCols = 16;        // F + G per row, at most

__global__ void meter_fold_kernel(const float* __restrict__ ftab,
                                  const int32_t* __restrict__ itab,
                                  const float* __restrict__ f0,
                                  const int32_t* __restrict__ i0,
                                  float* __restrict__ fout,
                                  int32_t* __restrict__ iout,
                                  int m, int n_slots, int nf, int ni) {
  __shared__ float fs[kFoldTile * kFoldMaxCols];
  __shared__ int32_t is[kFoldTile * kFoldMaxCols];
  int cols = nf + ni;
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x
                + threadIdx.x;
  bool active = t < static_cast<long long>(n_slots) * cols;
  int slot = active ? static_cast<int>(t / cols) : 0;
  int col = active ? static_cast<int>(t % cols) : 0;
  bool is_f = col < nf;
  float facc = 0.0f;
  uint32_t iacc = 0u;
  if (active) {
    if (is_f) facc = f0[static_cast<long long>(slot) * nf + col];
    else iacc = static_cast<uint32_t>(
        i0[static_cast<long long>(slot) * ni + (col - nf)]);
  }
  for (int base = 0; base < m; base += kFoldTile) {
    int rows = min(kFoldTile, m - base);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * nf; e += blockDim.x)
      fs[e] = ftab[static_cast<long long>(base) * nf + e];
    for (int e = threadIdx.x; e < rows * ni; e += blockDim.x)
      is[e] = itab[static_cast<long long>(base) * ni + e];
    __syncthreads();
    if (active) {
      if (is_f) {
        for (int r = 0; r < rows; ++r) facc = __fadd_rn(facc, fs[r * nf + col]);
      } else {
        int c = col - nf;
        for (int r = 0; r < rows; ++r)
          iacc += static_cast<uint32_t>(is[r * ni + c]);
      }
    }
  }
  if (active) {
    if (is_f) fout[static_cast<long long>(slot) * nf + col] = facc;
    else iout[static_cast<long long>(slot) * ni + (col - nf)] =
        static_cast<int32_t>(iacc);
  }
}

}  // namespace

extern "C" {

int rowops_shift_cols(const void* x, void* out, int n, int w, int k,
                      void* stream) {
  long long total = static_cast<long long>(n) * w;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  long long ak = k < 0 ? -static_cast<long long>(k) : k;
  int kw = static_cast<int>(ak / 32);
  int kb = static_cast<int>(ak % 32);
  if (ak >= 32LL * w) { kw = w; kb = 0; }
  shift_cols_kernel<<<blocks_for(total), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n, w,
      kw, kb, k > 0 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

int rowops_bitwise(const void* a, const void* b, const void* c, void* out,
                   long long total, int op, int vec4, void* stream) {
  if (total <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    long long total4 = total / 4;
    bitwise_vec4_kernel<<<blocks_for(total4), kThreads, 0, s>>>(
        static_cast<const uint4*>(a), static_cast<const uint4*>(b),
        static_cast<const uint4*>(c), static_cast<uint4*>(out), total4, op);
  } else {
    bitwise_kernel<<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<const uint32_t*>(c), static_cast<uint32_t*>(out), total,
        op);
  }
  return static_cast<int>(cudaGetLastError());
}

int rowops_meter_fold(const void* ftab, const void* itab, const void* f0,
                      const void* i0, void* fout, void* iout, int m,
                      int n_slots, int nf, int ni, void* stream) {
  if (nf + ni > kFoldMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  long long threads = static_cast<long long>(n_slots) * (nf + ni);
  if (threads <= 0) return static_cast<int>(cudaSuccess);
  meter_fold_kernel<<<blocks_for(threads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ftab), static_cast<const int32_t*>(itab),
      static_cast<const float*>(f0), static_cast<const int32_t*>(i0),
      static_cast<float*>(fout), static_cast<int32_t*>(iout), m, n_slots,
      nf, ni);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
