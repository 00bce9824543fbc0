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

// ---------------------------------------------------------------------------
// ripple_add — replaces the TPU kernel
//   src/repro/kernels/rowops/rowops.py: ripple_add -> _ripple_add_kernel.
// Lane-wise add of horizontally packed w-bit elements, w | 32, as the
// paper's ripple-carry S/C iteration: s = a^b, c = a&b, then w-1 rounds of
//   cs = shift_cols(c, +1) & interior;  c = s & cs;  s ^= cs.
// Because w divides 32, every word starts an element, so the bit that
// shift_cols(c, +1) carries across a word boundary always lands on an
// element's bit 0, which the interior mask clears. Each output word thus
// depends only on the same word of a and b: shift_cols(c, +1) & interior
// is (c << 1) & interior within the word. One thread keeps s and c in
// registers for all w-1 rounds (four words per thread through 16-byte
// loads when aligned), reads each input word once and writes once: the
// Pallas kernel's one HBM round trip, with no neighbour word and no shared
// memory. The width is a template parameter, so the rounds unroll.
// Bound on the card: bytes, 12 per word, at every width. nvcc fuses two
// rounds into three three-input LOP3s and issues each shift as an
// IMAD.SHL on the FMA pipe (cuobjdump -sass: 47 LOP3 and 32 IMAD per word
// at w = 32), so even w = 32 needs less integer time than memory time.
// ---------------------------------------------------------------------------
template <int W>
__device__ __forceinline__ uint32_t ripple_word(uint32_t a, uint32_t b) {
  constexpr uint32_t kElem = W == 32 ? 0xFFFFFFFFu
                                      : ((1u << (W % 32)) - 1u);
  constexpr uint32_t kLsb = W == 32 ? 1u
                                    : 0xFFFFFFFFu / kElem;  // each bit 0
  constexpr uint32_t kInterior = ~kLsb;
  uint32_t s = a ^ b;
  uint32_t c = a & b;
#pragma unroll
  for (int r = 0; r < W - 1; ++r) {
    uint32_t cs = (c << 1) & kInterior;
    c = s & cs;
    s ^= cs;
  }
  return s;
}

template <int W>
__global__ void ripple_add_kernel(const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ b,
                                  uint32_t* __restrict__ out,
                                  long long total) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                + threadIdx.x;
  if (i >= total) return;
  out[i] = ripple_word<W>(a[i], b[i]);
}

template <int W>
__global__ void ripple_add_vec4_kernel(const uint4* __restrict__ a,
                                       const uint4* __restrict__ b,
                                       uint4* __restrict__ out,
                                       long long total4) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                + threadIdx.x;
  if (i >= total4) return;
  uint4 av = a[i];
  uint4 bv = b[i];
  uint4 r;
  r.x = ripple_word<W>(av.x, bv.x);
  r.y = ripple_word<W>(av.y, bv.y);
  r.z = ripple_word<W>(av.z, bv.z);
  r.w = ripple_word<W>(av.w, bv.w);
  out[i] = r;
}

template <int W>
void launch_ripple_add(const void* a, const void* b, void* out,
                       long long total, int vec4, cudaStream_t s) {
  if (vec4) {
    long long total4 = total / 4;
    ripple_add_vec4_kernel<W><<<blocks_for(total4), kThreads, 0, s>>>(
        static_cast<const uint4*>(a), static_cast<const uint4*>(b),
        static_cast<uint4*>(out), total4);
  } else {
    ripple_add_kernel<W><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), total);
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

int rowops_ripple_add(const void* a, const void* b, void* out,
                      long long total, int width, int vec4, void* stream) {
  if (total <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: launch_ripple_add<1>(a, b, out, total, vec4, s); break;
    case 2: launch_ripple_add<2>(a, b, out, total, vec4, s); break;
    case 4: launch_ripple_add<4>(a, b, out, total, vec4, s); break;
    case 8: launch_ripple_add<8>(a, b, out, total, vec4, s); break;
    case 16: launch_ripple_add<16>(a, b, out, total, vec4, s); break;
    case 32: launch_ripple_add<32>(a, b, out, total, vec4, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
