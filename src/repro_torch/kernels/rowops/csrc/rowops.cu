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
// cudaGetLastError(). shift_cols, meter_fold and ripple_add write separate
// output buffers; bitwise and shift_rows take rows of the executor's slot
// state as base pointers and strides and write them in place, where a
// destination row may also be a source row (their notes say how each
// stays right under that aliasing).

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared, asynchronously
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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
// Elementwise not/and/or/xor/maj, maj = (a&b)|(b&c)|(a&c), of up to three
// source rows into up to four destination rows and a side row, in one
// launch. Each row is a base pointer; the rows' slots lie ``stride`` words
// apart, the side row's W:
// - the executor passes rows of its (B, R, W) slot state in place (bits +
//   row*W, stride R*W): a fused MAJ writes T0, T1, T2 and its destination,
//   a TRA its three operands, a NOT its destination and, as the side row,
//   a new (B, W) DCC row, all from one launch;
// - the out-of-place entry (rowops_bitwise) passes separate buffers as one
//   row of N*W words.
// A destination may be a source, so no pointer is __restrict__: each
// thread loads every source word it needs before it stores any, and no
// thread reads a word that another thread writes.
// Bound on the card: bytes, 4*W*B*(sources + destinations).
// At the executor's shapes (B = 1..64 slots, W = 2048) it is bound by the
// launch, so the point of the design is one launch per segment, with no
// gathers or row copies around it. Four words per thread through 16-byte
// loads and stores when every row pointer is 16-byte aligned and every
// stride a multiple of four words; the last W % 4 words of each row then
// take one word per thread in the same launch. The op is a template
// parameter: with it at run time (and a stride per row), the parameter
// loads ahead of the first row load cost about 0.3 us a launch on one H100.
// ---------------------------------------------------------------------------
enum BitOp { kNot = 0, kAnd = 1, kOr = 2, kXor = 3, kMaj = 4 };
constexpr int kMaxSrc = 3;
constexpr int kMaxDst = 5;              // four rows, then the side row

struct RowSet {
  const uint32_t* src[kMaxSrc];
  uint32_t* dst[kMaxDst];
  long long stride;       // words between slots, every row but the side row
  int n_dst;              // rows, then the side row (stride w) if any
  int side;
};

template <int kOp, typename T>
__device__ __forceinline__ T apply_op(T a, T b, T c) {
  if (kOp == kNot) return ~a;
  if (kOp == kAnd) return a & b;
  if (kOp == kOr) return a | b;
  if (kOp == kXor) return a ^ b;
  return (a & b) | (b & c) | (a & c);
}

template <int kOp>
__device__ __forceinline__ uint4 apply_op4(uint4 a, uint4 b, uint4 c) {
  return make_uint4(apply_op<kOp>(a.x, b.x, c.x),
                    apply_op<kOp>(a.y, b.y, c.y),
                    apply_op<kOp>(a.z, b.z, c.z),
                    apply_op<kOp>(a.w, b.w, c.w));
}

template <bool kVec, int kOp>
__global__ void __launch_bounds__(kThreads)
bitwise_rows_kernel(RowSet rs, int w) {
  constexpr int kSrc = kOp == kNot ? 1 : kOp == kMaj ? 3 : 2;
  const int vecs = kVec ? w / 4 : 0;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= vecs + (w - 4 * vecs)) return;
  const long long off = blockIdx.y * rs.stride;
  const long long side_off = static_cast<long long>(blockIdx.y) * w;
  if (kVec && v < vecs) {
    uint4 x[kMaxSrc] = {};
#pragma unroll
    for (int i = 0; i < kSrc; ++i)
      x[i] = *reinterpret_cast<const uint4*>(rs.src[i] + off + 4 * v);
    const uint4 r = apply_op4<kOp>(x[0], x[1], x[2]);
#pragma unroll
    for (int d = 0; d < kMaxDst - 1; ++d)
      if (d < rs.n_dst)
        *reinterpret_cast<uint4*>(rs.dst[d] + off + 4 * v) = r;
    if (rs.side)
      *reinterpret_cast<uint4*>(rs.dst[kMaxDst - 1] + side_off + 4 * v) = r;
  } else {
    const int j = 4 * vecs + (v - vecs);
    uint32_t x[kMaxSrc] = {};
#pragma unroll
    for (int i = 0; i < kSrc; ++i) x[i] = rs.src[i][off + j];
    const uint32_t r = apply_op<kOp>(x[0], x[1], x[2]);
#pragma unroll
    for (int d = 0; d < kMaxDst - 1; ++d)
      if (d < rs.n_dst) rs.dst[d][off + j] = r;
    if (rs.side) rs.dst[kMaxDst - 1][side_off + j] = r;
  }
}

template <int kOp>
void launch_op(const RowSet& rs, dim3 grid, int w, bool vec,
               cudaStream_t s) {
  if (vec)
    bitwise_rows_kernel<true, kOp><<<grid, kThreads, 0, s>>>(rs, w);
  else
    bitwise_rows_kernel<false, kOp><<<grid, kThreads, 0, s>>>(rs, w);
}

int launch_bitwise_rows(const RowSet& rs, int n_slots, long long w, int op,
                        cudaStream_t s) {
  if (n_slots <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (n_slots > 65535 || w > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_src = op == kNot ? 1 : op == kMaj ? 3 : 2;
  bool vec = rs.stride % 4 == 0 && (!rs.side || w % 4 == 0);
  for (int i = 0; i < n_src; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(rs.src[i]) % 16 == 0;
  for (int d = 0; d < kMaxDst; ++d)
    if (d < rs.n_dst || (d == kMaxDst - 1 && rs.side))
      vec = vec && reinterpret_cast<uintptr_t>(rs.dst[d]) % 16 == 0;
  const long long units = vec ? w / 4 + w % 4 : w;
  const dim3 grid(blocks_for(units), n_slots);
  const int wi = static_cast<int>(w);
  switch (op) {
    case kNot: launch_op<kNot>(rs, grid, wi, vec, s); break;
    case kAnd: launch_op<kAnd>(rs, grid, wi, vec, s); break;
    case kOr: launch_op<kOr>(rs, grid, wi, vec, s); break;
    case kXor: launch_op<kXor>(rs, grid, wi, vec, s); break;
    case kMaj: launch_op<kMaj>(rs, grid, wi, vec, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// shift_rows — the executor's form of shift_cols: it replaces the same TPU
// kernel (rowops.py: shift_cols) on the path that calls it, the
// reference's lowering of a fused migration-shift chain
// (src/repro/core/pim/exec.py: _run_segments, SegShiftRun) and, as k = 1,
// of a one-hop SHIFT row of its scan (_scan_segment, do_shift). For every
// slot s of a (B, R, W) state, x = bits[s, src], a k-hop chain in
// direction delta (+1: toward higher columns):
//   y  = shift(x, delta*(k-1))
//   mt = y & (delta > 0 ? EVEN : ODD),  mb = y & (delta > 0 ? ODD : EVEN)
//        (new (B, W) rows: the migration cells the last hop captures)
//   bits[s, dst] = shift1(mt, delta) | shift1(mb, delta) = shift(x, delta*k)
//        (mt and mb split y's bits, and zero-filled shifts compose)
// src may be dst (in mul_shift_add, 71 of 175 one-hop shifts run in
// place), so every source word of a row must be read before any word of
// it is written, and an output word reads source words up to k/32 words
// away, which another block may hold. The design:
// - in place, the blocks of one slot row form one thread-block cluster, at
//   most kShiftClusterMax blocks of at most kShiftTileMax words (rows of up
//   to 65,536 words, the RS subarray's, in one launch); each block copies
//   the source words its tile reads into shared memory, the cluster
//   synchronises (barrier.cluster: release, then acquire), then every
//   block computes its tile and stores it. A row of at most kShiftTileMax
//   words is one block, and the block's own barrier suffices;
// - out of place, the tiles (kShiftTile words) are independent;
// - an in-place row above the cluster's reach is written to a scratch row
//   and copied back: two launches, a route of its own.
// Bound on the card: bytes, 4*W*B*(1 row read + 3 rows written).
// ---------------------------------------------------------------------------
constexpr int kShiftTile = 2048;        // words per block, out of place
constexpr int kShiftTileMax = 8192;     // words per block of a cluster
constexpr int kShiftClusterMax = 8;     // blocks per cluster (portable)
constexpr int kShiftLoads = 16;         // loads in flight per thread
constexpr uint32_t kEven = 0x55555555u, kOdd = 0xAAAAAAAAu;

// word j of shift(x, +(32*kw + kb)) from hi = x[j - kw], lo = x[j - kw - 1]
__device__ __forceinline__ uint32_t shl_pair(uint32_t hi, uint32_t lo,
                                             int kb) {
  return kb ? (hi << kb) | (lo >> (32 - kb)) : hi;
}

// word j of shift(x, -(32*kw + kb)) from lo = x[j + kw], hi = x[j + kw + 1]
__device__ __forceinline__ uint32_t shr_pair(uint32_t lo, uint32_t hi,
                                             int kb) {
  return kb ? (lo >> kb) | (hi << (32 - kb)) : lo;
}

// Block b: slot b / parts, output words [j0, j0 + tile) of its row. y
// shifts by kw1 words and kb1 bits, the destination by kw2 (kw1 or
// kw1 + 1) and kb2; kw = W stands for "shifted wholly out".
__global__ void __launch_bounds__(kThreads)
shift_rows_kernel(const uint32_t* src, long long src_stride, uint32_t* dst,
                  long long dst_stride, uint32_t* mt, uint32_t* mb, int w,
                  int tile, int parts,
                  int kw1, int kb1, int kw2, int kb2, int up, int cluster) {
  __shared__ uint32_t buf[kShiftTileMax + 2];
  const long long slot = blockIdx.x / parts;
  const int j0 = (blockIdx.x % parts) * tile;
  const int len = min(tile, w - j0);
  const uint32_t* x = src + slot * src_stride;
  // buf[i] = x[base + i], 0 outside the row: the words this tile reads,
  // kShiftLoads loads in flight per thread before their stores to buf
  const long long base = up ? static_cast<long long>(j0) - kw1 - 2
                            : static_cast<long long>(j0) + kw1;
  for (int i0 = threadIdx.x; i0 < len + 2;
       i0 += kShiftLoads * kThreads) {
    uint32_t v[kShiftLoads];
#pragma unroll
    for (int u = 0; u < kShiftLoads; ++u) {
      const int i = i0 + u * kThreads;
      const long long g = base + i;
      v[u] = (i < len + 2 && g >= 0 && g < w) ? x[g] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kShiftLoads; ++u) {
      const int i = i0 + u * kThreads;
      if (i < len + 2) buf[i] = v[u];
    }
  }
  __syncthreads();
  if (cluster) cg::this_cluster().sync();   // the row read everywhere
  const int dw = kw2 - kw1;
  uint32_t* out = dst + slot * dst_stride;
  const long long mrow = slot * w;
  for (int t = threadIdx.x; t < len; t += kThreads) {
    uint32_t y, d;
    if (up) {
      y = shl_pair(buf[t + 2], buf[t + 1], kb1);
      d = shl_pair(buf[t + 2 - dw], buf[t + 1 - dw], kb2);
    } else {
      y = shr_pair(buf[t], buf[t + 1], kb1);
      d = shr_pair(buf[t + dw], buf[t + 1 + dw], kb2);
    }
    mt[mrow + j0 + t] = y & (up ? kEven : kOdd);
    mb[mrow + j0 + t] = y & (up ? kOdd : kEven);
    out[j0 + t] = d;
  }
}

// ---------------------------------------------------------------------------
// meter_fold — a helper, not a port of a TPU kernel. It replaces the XLA
// scan _fold_tables (src/repro/core/pim/compile.py), which folds per-event
// increment tables onto the cost meter in program order:
//   fout[b, c] = (...((f0[b, c] + ft[0, c]) + ft[1, c]) + ...) + ft[m-1, c]
// in float32 with __fadd_rn (no contraction, no reassociation; this file
// builds without -ftz or fast math, so denormals are kept), so the meter
// equals the eager ISA's to the last ulp, and
//   iout[b, c] = i0[b, c] + sum_r it[r, c]   in wrap-around uint32.
// Bound on the card: each float (slot, field) is a chain of m dependent
// adds, so the least time is m times the latency of one FADD (chip_smoke.py
// measures it with fadd_chain_kernel below), not the table's bytes or the
// adds at the float32 rate. The design keeps everything else off the chain:
// - Wrap-around uint32 addition is associative, so the last block of the
//   grid sums the int table in any order (16-byte loads, eight in flight
//   per thread, then shared-memory atomics) and adds the column sums to
//   every slot's start value.
// - Every other block runs kFoldChains float chains, one thread each,
//   field-major (the lanes of a warp share a field, so their loads
//   broadcast), beside one producer warp that streams the table through a
//   ring of kFoldStages tiles in shared memory with 4-byte cp.async copies,
//   transposed so that a field's increments lie contiguous. One barrier
//   per tile of Shape::kTile rows.
// - A chain reads its next kFoldChunk increments as 16-byte loads while it
//   adds the current ones, so no load latency lands on the chain. The last
//   tile is padded with -0.0, which round-to-nearest addition returns
//   unchanged for every float (a NaN stays a NaN).
// - Three warps of chains and the producer, one warp per scheduler of the
//   SM, so that nothing competes with a chain for its issue slots; more
//   chains take more blocks, each streaming the whole table.
// The field count is a template parameter for the CostMeter's 6 and
// sequential_sum's 1; other counts up to kFoldMaxCols take the generic
// instance (NF = 0).
// ---------------------------------------------------------------------------
constexpr int kFoldMaxCols = 16;        // float or int fields, each at most
constexpr int kFoldChains = 96;         // float chains per block
constexpr int kFoldThreads = kFoldChains + 32;      // and the producer warp
constexpr int kFoldStages = 3;          // tiles in the ring
constexpr int kFoldChunk = 16;          // increments a chain reads ahead
constexpr int kFoldIntLoads = 8;        // 16-byte int loads in flight

template <int NF>
struct FoldShape {
  static constexpr int kTile = NF == 0 ? 128 : 512;  // table rows per stage
  static constexpr int kCols = NF == 0 ? kFoldMaxCols : NF;
  // floats per field in a stage: room for a chain's look-ahead past the
  // tile, and fields 20 banks apart so that lanes on six fields do not
  // conflict
  static constexpr int kPitch = kTile + kFoldChunk + 4;
};

// One float chain over a staged tile: ``rows`` (a multiple of kFoldChunk)
// increments at ``col``, read kFoldChunk ahead of the adds. The last
// look-ahead reads past the tile, into the pitch's slack, unconditionally:
// behind a branch, ptxas issued each load only a few adds before its use,
// and the chain waited on them.
__device__ __forceinline__ float fold_column(float acc, const float* col,
                                             int rows) {
  constexpr int kVecs = kFoldChunk / 4;
  float4 cur[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u)
    cur[u] = reinterpret_cast<const float4*>(col)[u];
  for (int r = 0; r < rows; r += kFoldChunk) {
    float4 nxt[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u)
      nxt[u] = reinterpret_cast<const float4*>(col + r + kFoldChunk)[u];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      acc = __fadd_rn(acc, cur[u].x);
      acc = __fadd_rn(acc, cur[u].y);
      acc = __fadd_rn(acc, cur[u].z);
      acc = __fadd_rn(acc, cur[u].w);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) cur[u] = nxt[u];
  }
  return acc;
}

// The int block: column sums of the (m, ni) table in wrap-around uint32,
// then iout = i0 + sums. Thread t adds the elements (16-byte vectors when
// ``vec4``) t, t + stride, ...; the stride keeps each of its lanes on one
// column, so it holds one partial sum per lane.
__device__ void fold_int_columns(const int32_t* __restrict__ itab,
                                 const int32_t* __restrict__ i0,
                                 int32_t* __restrict__ iout, int m,
                                 int n_slots, int ni, int vec4) {
  __shared__ uint32_t sums[kFoldMaxCols];
  const int tid = threadIdx.x;
  if (tid < ni) sums[tid] = 0u;
  __syncthreads();
  const long long total = static_cast<long long>(m) * ni;
  const int width = vec4 ? 4 : 1;             // elements per load
  // a stride in loads whose width * stride elements are whole rows
  const int period = ni / (vec4 ? (ni % 4 == 0 ? 4 : ni % 2 == 0 ? 2 : 1)
                                : 1);
  const int stride = blockDim.x - blockDim.x % period;
  const long long loads = total / width;
  if (tid < stride) {
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
    long long i = tid;
    if (vec4) {
      const uint4* v = reinterpret_cast<const uint4*>(itab);
      for (; i + (kFoldIntLoads - 1LL) * stride < loads;
           i += static_cast<long long>(kFoldIntLoads) * stride) {
        uint4 x[kFoldIntLoads];
#pragma unroll
        for (int u = 0; u < kFoldIntLoads; ++u) x[u] = v[i + u * stride];
#pragma unroll
        for (int u = 0; u < kFoldIntLoads; ++u) {
          acc[0] += x[u].x; acc[1] += x[u].y;
          acc[2] += x[u].z; acc[3] += x[u].w;
        }
      }
      for (; i < loads; i += stride) {
        uint4 x = v[i];
        acc[0] += x.x; acc[1] += x.y; acc[2] += x.z; acc[3] += x.w;
      }
    } else {
      const uint32_t* v = reinterpret_cast<const uint32_t*>(itab);
      for (; i + (kFoldIntLoads - 1LL) * stride < loads;
           i += static_cast<long long>(kFoldIntLoads) * stride) {
        uint32_t x[kFoldIntLoads];
#pragma unroll
        for (int u = 0; u < kFoldIntLoads; ++u) x[u] = v[i + u * stride];
#pragma unroll
        for (int u = 0; u < kFoldIntLoads; ++u) acc[0] += x[u];
      }
      for (; i < loads; i += stride) acc[0] += v[i];
    }
    for (int k = 0; k < width; ++k)
      atomicAdd(&sums[(static_cast<long long>(tid) * width + k) % ni],
                acc[k]);
  }
  // the last total % width elements
  const long long tail = loads * width + tid;
  if (tail < total)
    atomicAdd(&sums[tail % ni], static_cast<uint32_t>(itab[tail]));
  __syncthreads();
  for (long long e = tid; e < static_cast<long long>(n_slots) * ni;
       e += blockDim.x)
    iout[e] = static_cast<int32_t>(static_cast<uint32_t>(i0[e])
                                   + sums[e % ni]);
}

template <int NF>
__global__ void __launch_bounds__(kFoldThreads)
meter_fold_kernel(const float* __restrict__ ftab,
                  const int32_t* __restrict__ itab,
                  const float* __restrict__ f0,
                  const int32_t* __restrict__ i0,
                  float* __restrict__ fout, int32_t* __restrict__ iout,
                  int m, int n_slots, int nf_arg, int ni, int chain_blocks,
                  int int_vec4) {
  if (static_cast<int>(blockIdx.x) == chain_blocks) {
    fold_int_columns(itab, i0, iout, m, n_slots, ni, int_vec4);
    return;
  }
  using Shape = FoldShape<NF>;
  __shared__ __align__(16) float ring[kFoldStages][Shape::kCols
                                                   * Shape::kPitch];
  const int nf = NF ? NF : nf_arg;
  const int tid = threadIdx.x;
  const bool producer = tid >= kFoldChains;
  const long long chain = static_cast<long long>(blockIdx.x) * kFoldChains
                          + tid;
  const bool active = !producer
                      && chain < static_cast<long long>(n_slots) * nf;
  const int field = active ? static_cast<int>(chain / n_slots) : 0;
  const int slot = active ? static_cast<int>(chain % n_slots) : 0;
  float acc = active ? f0[static_cast<long long>(slot) * nf + field] : 0.0f;
  // a producer lane copies one field of every (32 / nf)-th row
  const int lane = tid - kFoldChains;
  const int rows_per_pass = 32 / nf;
  const int p_field = producer ? lane % nf : 0;
  const int p_row = producer ? lane / nf : rows_per_pass;
  const int ntiles = (m + Shape::kTile - 1) / Shape::kTile;

  auto issue = [&](int k) {         // tile k into stage k % kFoldStages
    if (k < ntiles && p_row < rows_per_pass) {
      float* dst = ring[k % kFoldStages] + p_field * Shape::kPitch;
      const int base = k * Shape::kTile;
      const int rows = min(Shape::kTile, m - base);
      const int padded = (rows + kFoldChunk - 1) / kFoldChunk * kFoldChunk;
      const float* src = ftab + static_cast<long long>(base) * nf + p_field;
      for (int r = p_row; r < rows; r += rows_per_pass)
        cp_async4(smem_u32(dst + r), src + static_cast<long long>(r) * nf);
      for (int r = rows + p_row; r < padded; r += rows_per_pass)
        dst[r] = -0.0f;
    }
    cp_async_commit();
  };

  if (producer)
    for (int k = 0; k < kFoldStages - 1; ++k) issue(k);
  for (int k = 0; k < ntiles; ++k) {
    if (producer) cp_async_wait<kFoldStages - 2>();
    __syncthreads();                // tile k landed; tile k - 1 folded
    if (producer) {
      issue(k + kFoldStages - 1);   // into tile k - 1's stage
    } else if (active) {
      const int rows = min(Shape::kTile, m - k * Shape::kTile);
      acc = fold_column(acc, ring[k % kFoldStages] + field * Shape::kPitch,
                        (rows + kFoldChunk - 1) / kFoldChunk * kFoldChunk);
    }
  }
  if (active) fout[static_cast<long long>(slot) * nf + field] = acc;
}

template <int NF>
void launch_meter_fold(const void* ftab, const void* itab, const void* f0,
                       const void* i0, void* fout, void* iout, int m,
                       int n_slots, int nf, int ni, cudaStream_t s) {
  const long long chains = static_cast<long long>(n_slots) * nf;
  const int chain_blocks = static_cast<int>(
      (chains + kFoldChains - 1) / kFoldChains);
  const unsigned blocks = chain_blocks + (ni > 0 ? 1 : 0);
  const int int_vec4 = reinterpret_cast<uintptr_t>(itab) % 16 == 0;
  meter_fold_kernel<NF><<<blocks, kFoldThreads, 0, s>>>(
      static_cast<const float*>(ftab), static_cast<const int32_t*>(itab),
      static_cast<const float*>(f0), static_cast<const int32_t*>(i0),
      static_cast<float*>(fout), static_cast<int32_t*>(iout), m, n_slots,
      nf, ni, chain_blocks, int_vec4);
}

// The measure of meter_fold's bound: one thread adds ``inc`` to ``acc``
// n times in a dependent __fadd_rn chain (n a multiple of 8), and records
// the SM cycles the chain took (clock64).
__global__ void fadd_chain_kernel(const float* __restrict__ x,
                                  float* __restrict__ out,
                                  long long* __restrict__ cycles, int n) {
  float acc = x[0];
  const float inc = x[1];
  const long long t0 = clock64();
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, inc);
  }
  const long long t1 = clock64();
  out[0] = acc;
  cycles[0] = t1 - t0;
}

// ---------------------------------------------------------------------------
// ripple_add — replaces the TPU kernel
//   src/repro/kernels/rowops/rowops.py: ripple_add -> _ripple_add_kernel.
// Lane-wise add of horizontally packed w-bit elements, w | 32. The TPU
// kernel runs the paper's ripple-carry S/C iteration (s = a^b, c = a&b,
// then w-1 rounds of cs = shift_cols(c, +1) & interior; c = s & cs;
// s ^= cs); its result is a + b mod 2^w in every lane, and because w
// divides 32 no lane crosses a word. This kernel computes that sum without
// the iteration: with H the lanes' top bits,
//   s = ((a & ~H) + (b & ~H)) ^ ((a ^ b) & H)
// adds the low w-1 bits of each lane (their carry stops in the cleared top
// bit) and sets the top bit to the carry ^ a's ^ b's. At w 1 that is a ^ b,
// at w 32 a + b. About five integer instructions per word at every width
// (chip_smoke.py counts them in the SASS).
// Bound on the card: bytes, 12 per word, at every width. Each thread keeps
// kRippleVecs 16-byte loads per operand in flight (a block adds a
// contiguous run of kThreads * kRippleVecs vectors); the few words past the
// last whole vector go to block 0's first threads. Rows that are not
// 16-byte aligned take the one-word-per-thread kernel.
// ---------------------------------------------------------------------------
constexpr int kRippleVecs = 2;

template <int W>
__device__ __forceinline__ uint32_t lane_add(uint32_t a, uint32_t b) {
  constexpr uint32_t kElem = W == 32 ? 0xFFFFFFFFu
                                      : ((1u << (W % 32)) - 1u);
  constexpr uint32_t kLsb = 0xFFFFFFFFu / kElem;   // each lane's bit 0
  constexpr uint32_t kTop = kLsb << (W - 1);       // each lane's top bit
  return ((a & ~kTop) + (b & ~kTop)) ^ ((a ^ b) & kTop);
}

template <int W>
__global__ void ripple_add_kernel(const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ b,
                                  uint32_t* __restrict__ out,
                                  long long total) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                + threadIdx.x;
  if (i >= total) return;
  out[i] = lane_add<W>(a[i], b[i]);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
ripple_add_vec4_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       uint32_t* __restrict__ out, long long total) {
  const long long total4 = total / 4;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  const long long base = static_cast<long long>(blockIdx.x) * kThreads
                         * kRippleVecs + threadIdx.x;
  uint4 av[kRippleVecs], bv[kRippleVecs];
#pragma unroll
  for (int u = 0; u < kRippleVecs; ++u) {
    const long long i = base + u * kThreads;
    if (i < total4) {
      av[u] = a4[i];
      bv[u] = b4[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kRippleVecs; ++u) {
    const long long i = base + u * kThreads;
    if (i < total4)
      out4[i] = make_uint4(
          lane_add<W>(av[u].x, bv[u].x), lane_add<W>(av[u].y, bv[u].y),
          lane_add<W>(av[u].z, bv[u].z), lane_add<W>(av[u].w, bv[u].w));
  }
  const long long tail = total4 * 4 + threadIdx.x;
  if (blockIdx.x == 0 && tail < total)
    out[tail] = lane_add<W>(a[tail], b[tail]);
}

template <int W>
void launch_ripple_add(const void* a, const void* b, void* out,
                       long long total, int vec4, cudaStream_t s) {
  const uint32_t* a1 = static_cast<const uint32_t*>(a);
  const uint32_t* b1 = static_cast<const uint32_t*>(b);
  uint32_t* out1 = static_cast<uint32_t*>(out);
  if (vec4) {
    const long long per_block = static_cast<long long>(kThreads)
                                * kRippleVecs;
    const unsigned blocks = static_cast<unsigned>(
        std::max(1LL, (total / 4 + per_block - 1) / per_block));
    ripple_add_vec4_kernel<W><<<blocks, kThreads, 0, s>>>(a1, b1, out1,
                                                         total);
  } else {
    ripple_add_kernel<W><<<blocks_for(total), kThreads, 0, s>>>(
        a1, b1, out1, total);
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
                   long long total, int op, void* stream) {
  RowSet rs = {};
  rs.src[0] = static_cast<const uint32_t*>(a);
  rs.src[1] = static_cast<const uint32_t*>(b);
  rs.src[2] = static_cast<const uint32_t*>(c);
  rs.dst[0] = static_cast<uint32_t*>(out);
  rs.stride = total;
  rs.n_dst = 1;
  return launch_bitwise_rows(rs, 1, total, op,
                             static_cast<cudaStream_t>(stream));
}

// Rows s0..s2 (as many as ``op`` takes) into rows d0..d3 (the first
// n_dst) of a state whose slots lie ``stride`` words apart, and into
// ``side`` ((n_slots, w) words) unless it is null.
int rowops_bitwise_rows(const void* s0, const void* s1, const void* s2,
                        void* d0, void* d1, void* d2, void* d3, int n_dst,
                        void* side, int n_slots, int w, long long stride,
                        int op, void* stream) {
  if (n_dst < 0 || n_dst > 4 || (n_dst == 0 && side == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  RowSet rs = {};
  rs.src[0] = static_cast<const uint32_t*>(s0);
  rs.src[1] = static_cast<const uint32_t*>(s1);
  rs.src[2] = static_cast<const uint32_t*>(s2);
  void* dsts[4] = {d0, d1, d2, d3};
  for (int d = 0; d < n_dst; ++d)
    rs.dst[d] = static_cast<uint32_t*>(dsts[d]);
  rs.dst[kMaxDst - 1] = static_cast<uint32_t*>(side);
  rs.stride = stride;
  rs.n_dst = n_dst;
  rs.side = side != nullptr;
  return launch_bitwise_rows(rs, n_slots, w, op,
                             static_cast<cudaStream_t>(stream));
}

// The longest row shift_rows shifts in place in one launch.
int rowops_shift_rows_cluster_words() {
  return kShiftTileMax * kShiftClusterMax;
}

// Row ``src`` of every slot (``stride`` words apart) shifted by ``shift``
// = |delta|*(k-1) columns (``up``: delta > 0) into ``mt`` and ``mb``
// (masked, (n_slots, w)) and by one column more into row ``dst``. An
// in-place row longer than rowops_shift_rows_cluster_words() needs
// ``scratch``, (n_slots, w) words: the shift goes there, then a 2-D copy
// into ``dst``.
int rowops_shift_rows(const void* src, void* dst, long long stride,
                      void* mt, void* mb, void* scratch, int n_slots, int w,
                      long long shift, int up, void* stream) {
  if (n_slots <= 0 || w <= 0) return static_cast<int>(cudaSuccess);
  if (shift < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int kw1 = w, kb1 = 0, kw2 = w, kb2 = 0;     // beyond 32 W: zeros
  if (shift < 32LL * w) {
    kw1 = static_cast<int>(shift / 32);
    kb1 = static_cast<int>(shift % 32);
    if (shift + 1 < 32LL * w) {
      kw2 = static_cast<int>((shift + 1) / 32);
      kb2 = static_cast<int>((shift + 1) % 32);
    }
  }
  const bool in_place = src == dst;
  const bool via_scratch = in_place
                           && w > kShiftTileMax * kShiftClusterMax;
  if (via_scratch && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* out = static_cast<uint32_t*>(via_scratch ? scratch : dst);
  const long long out_stride = via_scratch ? w : stride;
  const uint32_t* x = static_cast<const uint32_t*>(src);
  uint32_t* mt1 = static_cast<uint32_t*>(mt);
  uint32_t* mb1 = static_cast<uint32_t*>(mb);
  if (in_place && !via_scratch) {
    const int parts = (w + kShiftTileMax - 1) / kShiftTileMax;
    const int tile = (w + parts - 1) / parts;
    if (parts == 1) {
      shift_rows_kernel<<<n_slots, kThreads, 0, s>>>(
          x, stride, out, out_stride, mt1, mb1, w, tile, 1, kw1, kb1, kw2,
          kb2, up, 0);
      return static_cast<int>(cudaGetLastError());
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(n_slots) * parts);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = parts;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, shift_rows_kernel, x, stride, out, out_stride, mt1, mb1, w,
        tile, parts, kw1, kb1, kw2, kb2, up, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  const int parts = (w + kShiftTile - 1) / kShiftTile;
  shift_rows_kernel<<<static_cast<unsigned>(n_slots) * parts, kThreads,
                      0, s>>>(x, stride, out, out_stride, mt1, mb1, w,
                           kShiftTile, parts, kw1, kb1, kw2, kb2, up, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !via_scratch) return static_cast<int>(e);
  e = cudaMemcpy2DAsync(dst, stride * sizeof(uint32_t), scratch,
                        w * sizeof(uint32_t), w * sizeof(uint32_t), n_slots,
                        cudaMemcpyDeviceToDevice, s);
  return static_cast<int>(e);
}

int rowops_meter_fold(const void* ftab, const void* itab, const void* f0,
                      const void* i0, void* fout, void* iout, int m,
                      int n_slots, int nf, int ni, void* stream) {
  if (nf < 0 || ni < 0 || nf > kFoldMaxCols || ni > kFoldMaxCols)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots <= 0 || nf + ni == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nf) {
    case 6: launch_meter_fold<6>(ftab, itab, f0, i0, fout, iout, m, n_slots,
                                 nf, ni, s); break;
    case 1: launch_meter_fold<1>(ftab, itab, f0, i0, fout, iout, m, n_slots,
                                 nf, ni, s); break;
    default: launch_meter_fold<0>(ftab, itab, f0, i0, fout, iout, m,
                                  n_slots, nf, ni, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int rowops_fadd_chain(const void* x, void* out, void* cycles, int n,
                      void* stream) {
  if (n <= 0 || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  fadd_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<long long*>(cycles), n);
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
