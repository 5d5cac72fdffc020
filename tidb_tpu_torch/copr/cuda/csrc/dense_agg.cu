// Dense aggregation of integer partial states in one pass over the rows
// (K3 in PERF.md): for G <= 32 dense group codes, a row mask and K
// operands (int64 values, each with its validity bytes; a count-only
// operand has validity and no values), one [1 + 2K, G] int64 result:
//     row 0       gcount[g]  = #{i : mask[i] and gidx[i] == g}
//     row 1 + 2k  sum_k[g]   = sum of vals_k[i] over the rows of
//                              gcount[g] with valid_k[i]
//     row 2 + 2k  count_k[g] = #{those rows}
// Sums wrap mod 2**64, as torch's int64 sum does; integer addition mod
// 2**64 does not depend on order, so the result is bit-identical to a
// masked torch.sum per group whatever the order the rows add in.  A
// masked row's code of G or more counts nowhere (a negative one too);
// a masked-out row's code is not read.  With one group (a scalar
// aggregate) no code is read at all: every masked row is group 0.
//
// It replaces no TPU kernel: the JAX package composes jnp ops here
// (tidb_tpu/copr/fusion.py dense_agg_results over
// tidb_tpu/ops/segment.py), one masked full reduction per group and
// operand plus a histogram per count.  On the card that composition is
// ~240 launches a Q1 dispatch, each streaming the n rows again, and
// every torch.bincount reads its input's range back to the host.
//
// What bounds it on an H100: bytes.  It reads
//     n * (sizeof gidx + 1 + sum_k (8 + 1))
// bytes (gidx 8, or 0 with one group; the mask 1; each value 8 and
// validity 1; a count-only operand 1) and writes (1 + 2K) * G * 8.  At
// Q1's shape in one dispatch (n = 20 M, K = 7, G = 6) that is 1.44 GB,
// 0.43 ms at 3.35 TB/s; at Q6's (K = 1, G = 1) 10 bytes a row.  The
// integer work is a few operations a row and operand.
//
// Design.  Every byte is read once, in 16-byte (int64 pairs) and
// 2-byte (bool pairs) loads, neighbouring lanes on neighbouring rows: a
// warp's step is 512 rows, lane t taking rows 64j + 2t and 64j + 2t + 1
// of slice j = 0..7, so each load instruction of a warp reads 512
// contiguous bytes of int64 or 64 of bool.  A warp walks a contiguous
// run of steps in tiles of NS steps.  First it reads gidx and the mask
// of the tile, folds them into one byte-wide code a row (G for a row
// that counts nowhere) and keeps the codes in its shared memory; then,
// for each operand in turn, it reads the values and validity of the
// tile and adds each row into a slot private to the lane: slot (g,
// lane) of a [G + 1][32] array of sums (uint64) and one of counts
// (uint32) in shared memory.  Row G is where rows that count nowhere
// land, so the add has no branch, and a lane's slots sit in one bank
// column, so the adds never conflict.  Each row costs one add whatever
// G is.  After each operand's tile, lane g adds up group g's 32 slots
// (read on a diagonal, conflict-free) into the block's accumulators
// (shared atomics) and zeroes them; the block adds its accumulators
// into the output with one global atomic each at the end (the wrapper
// zeroes the output first).  The K value and validity pointers ride in
// a kernel-parameter struct (no host-to-device copy); no size depends
// on the data, nothing syncs.
//
// Why slots in shared memory and not registers: a register accumulator
// per group takes G predicated adds a row (the group is data, so a
// register array cannot be indexed by it) and one kernel instance per
// group count; measured on an H100 at Q1's dispatch shape, such a
// variant ran no faster (0.4604 against 0.4614 ms at 5 operands) and
// spilled at 32 groups (PERF.md, K3).
//
// Alignment: the launcher takes the vector instance when gidx and every
// value pointer are 16-byte aligned and the mask and every validity
// pointer 2-byte aligned (a slice [lo:hi) with lo a multiple of 8 rows
// of a torch allocation is), else an instance that reads row by row.
// n need not be a multiple of 512: the last n % 512 rows are one
// bounds-checked step of the last warp.
//
// C interface for ctypes: pointers and the stream as void*, sizes as
// int64.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a form it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 32;            // operands a launch takes
constexpr int MAX_G = 32;            // groups (ops/segment.py UNROLL_G)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLICES = 8;            // 2-row slices a lane takes a step
constexpr int STEP = 64 * SLICES;    // rows a warp takes a step: 512
constexpr int NS = 8;                // steps a tile

struct Operands {
  const int64_t* val[MAX_K];         // null: a count-only operand
  const uint8_t* valid[MAX_K];
};

// 64-bit words of shared memory one warp uses: the sums [G + 1][32]
// (uint64), the counts [G + 1][32] (uint32) and the codes of one tile
// (two bytes a lane and slice)
__host__ __device__ constexpr int warp_words(int G) {
  return (G + 1) * 32 + (G + 1) * 16 + NS * SLICES * 32 * 2 / 8;
}

template <bool VEC>
__device__ __forceinline__ void load_i64_pair(const int64_t* __restrict__ p,
                                              int64_t row, int64_t n,
                                              uint64_t& a, uint64_t& b) {
  if constexpr (VEC) {
    const longlong2 t = __ldg(reinterpret_cast<const longlong2*>(p + row));
    a = (uint64_t)t.x;
    b = (uint64_t)t.y;
  } else {
    const long long* q = reinterpret_cast<const long long*>(p);
    a = row < n ? (uint64_t)__ldg(q + row) : 0;
    b = row + 1 < n ? (uint64_t)__ldg(q + row + 1) : 0;
  }
}

// the bytes of rows `row` and `row + 1`, in the low and the next byte
template <bool VEC>
__device__ __forceinline__ uint32_t load_bool_pair(
    const uint8_t* __restrict__ p, int64_t row, int64_t n) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const unsigned short*>(p + row));
  } else {
    const uint32_t a = row < n ? __ldg(p + row) : 0;
    const uint32_t b = row + 1 < n ? __ldg(p + row + 1) : 0;
    return a | (b << 8);
  }
}

// Lane g < G adds up group g's 32 slots (diagonally: lane g reads
// column (i + g) % 32 at step i, so no two lanes share a bank), zeroes
// them, and adds the totals into the block's accumulators.
__device__ __forceinline__ void flush(uint64_t* sums, uint32_t* cnts,
                                      bool with_sums,
                                      unsigned long long* sum_row,
                                      unsigned long long* cnt_row, int G,
                                      int lane) {
  __syncwarp();
  if (lane < G) {
    uint64_t s = 0, c = 0;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {
      const int a = lane * 32 + ((i + lane) & 31);
      c += cnts[a];
      cnts[a] = 0;
      if (with_sums) {
        s += sums[a];
        sums[a] = 0;
      }
    }
    if (c) atomicAdd(cnt_row + lane, (unsigned long long)c);
    if (with_sums && s) atomicAdd(sum_row + lane, (unsigned long long)s);
  }
  __syncwarp();
}

// One tile of `ns` steps from row `base`: codes, gcount, then every
// operand.  !VEC reads row by row and checks each row against n; a
// null gidx (one group) reads no code.
template <bool VEC>
__device__ __forceinline__ void tile(const int64_t* __restrict__ gidx,
                                     const uint8_t* __restrict__ mask,
                                     const Operands& ops, int K, int G,
                                     int64_t n, int64_t base, int ns,
                                     uint64_t* sums, uint32_t* cnts,
                                     unsigned short* codes,
                                     unsigned long long* bacc, int lane) {
  for (int s = 0; s < ns; ++s) {
    const int64_t r0 = base + (int64_t)s * STEP + 2 * lane;
    uint64_t g[2 * SLICES];
    uint32_t m[SLICES];
#pragma unroll
    for (int j = 0; j < SLICES; ++j) {
      if (gidx != nullptr) {
        load_i64_pair<VEC>(gidx, r0 + 64 * j, n, g[2 * j], g[2 * j + 1]);
      } else {
        g[2 * j] = g[2 * j + 1] = 0;
      }
      m[j] = load_bool_pair<VEC>(mask, r0 + 64 * j, n);
    }
#pragma unroll
    for (int j = 0; j < SLICES; ++j) {
      const uint32_t c0 =
          (m[j] & 0xff) && g[2 * j] < (uint64_t)G ? (uint32_t)g[2 * j] : G;
      const uint32_t c1 = (m[j] >> 8) && g[2 * j + 1] < (uint64_t)G
                              ? (uint32_t)g[2 * j + 1]
                              : G;
      codes[(s * SLICES + j) * 32 + lane] = (unsigned short)(c0 | c1 << 8);
      cnts[c0 * 32 + lane] += 1;
      cnts[c1 * 32 + lane] += 1;
    }
  }
  flush(sums, cnts, false, nullptr, bacc, G, lane);
  for (int k = 0; k < K; ++k) {
    const int64_t* __restrict__ vp = ops.val[k];
    const uint8_t* __restrict__ vd = ops.valid[k];
    for (int s = 0; s < ns; ++s) {
      const int64_t r0 = base + (int64_t)s * STEP + 2 * lane;
      uint64_t v[2 * SLICES];
      uint32_t ok[SLICES];
#pragma unroll
      for (int j = 0; j < SLICES; ++j) {
        if (vp != nullptr) {
          load_i64_pair<VEC>(vp, r0 + 64 * j, n, v[2 * j], v[2 * j + 1]);
        } else {
          v[2 * j] = v[2 * j + 1] = 0;
        }
        ok[j] = load_bool_pair<VEC>(vd, r0 + 64 * j, n);
      }
#pragma unroll
      for (int j = 0; j < SLICES; ++j) {
        const uint32_t cp = codes[(s * SLICES + j) * 32 + lane];
        const uint32_t c0 = (ok[j] & 0xff) ? (cp & 0xff) : G;
        const uint32_t c1 = (ok[j] >> 8) ? (cp >> 8) : G;
        if (vp != nullptr) {
          sums[c0 * 32 + lane] += v[2 * j];
          sums[c1 * 32 + lane] += v[2 * j + 1];
        }
        cnts[c0 * 32 + lane] += 1;
        cnts[c1 * 32 + lane] += 1;
      }
    }
    flush(sums, cnts, vp != nullptr, bacc + (1 + 2 * k) * G,
          bacc + (2 + 2 * k) * G, G, lane);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    dense_agg_kernel(const int64_t* __restrict__ gidx,
                     const uint8_t* __restrict__ mask,
                     const __grid_constant__ Operands ops, int K, int G,
                     int64_t n, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const int states = (1 + 2 * K) * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned long long* bacc = smem;
  uint64_t* sums = (uint64_t*)(smem + states + warp * warp_words(G));
  uint32_t* cnts = (uint32_t*)(sums + (G + 1) * 32);
  unsigned short* codes = (unsigned short*)(cnts + (G + 1) * 32);
  for (int i = threadIdx.x; i < states; i += THREADS) bacc[i] = 0;
  for (int i = lane; i < (G + 1) * 32; i += 32) {
    sums[i] = 0;
    cnts[i] = 0;
  }
  __syncthreads();

  // warp w takes the contiguous steps [steps*w/W, steps*(w+1)/W)
  const int64_t W = (int64_t)gridDim.x * WARPS;
  const int64_t w = (int64_t)blockIdx.x * WARPS + warp;
  const int64_t steps = n / STEP;
  const int64_t s1 = steps * (w + 1) / W;
  for (int64_t s = steps * w / W; s < s1; s += NS) {
    const int ns = (int)(s1 - s < NS ? s1 - s : NS);
    tile<VEC>(gidx, mask, ops, K, G, n, s * STEP, ns, sums, cnts, codes,
              bacc, lane);
  }
  if (w == W - 1 && steps * STEP < n)  // the ragged end, bounds-checked
    tile<false>(gidx, mask, ops, K, G, n, steps * STEP, 1, sums, cnts,
                codes, bacc, lane);
  __syncthreads();
  for (int i = threadIdx.x; i < states; i += THREADS) {
    const unsigned long long v = bacc[i];
    if (v) atomicAdd(out + i, v);
  }
}

template <bool VEC>
int launch(const int64_t* gidx, const uint8_t* mask, const Operands& ops,
           int K, int G, int64_t n, unsigned long long* out,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(unsigned long long) *
      ((size_t)(1 + 2 * K) * G + (size_t)WARPS * warp_words(G));
  cudaError_t e = cudaFuncSetAttribute(
      dense_agg_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dense_agg_kernel<VEC>, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  // enough warps to fill the card, and no more tiles than the rows make
  const int64_t steps = n / STEP;
  int64_t blocks = (steps + (int64_t)WARPS * NS - 1) / ((int64_t)WARPS * NS);
  const int64_t cap = (int64_t)sms * per_sm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;  // fewer than 512 rows: the ragged end only
  dense_agg_kernel<VEC><<<(unsigned)blocks, THREADS, smem, stream>>>(
      gidx, mask, ops, K, G, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tidb_dense_agg(const void* gidx, const void* mask,
                              const void* const* vals,
                              const void* const* valids, int K, int G,
                              int64_t n, void* out, void* stream) {
  if (K < 0 || K > MAX_K || G < 1 || G > MAX_G || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (G == 1) gidx = nullptr;  // one group: no code is read
  if ((gidx == nullptr && G > 1) || mask == nullptr)
    return (int)cudaErrorInvalidValue;
  Operands ops;
  bool vec = (uintptr_t)gidx % 16 == 0 && (uintptr_t)mask % 2 == 0;
  for (int k = 0; k < K; ++k) {
    ops.val[k] = (const int64_t*)vals[k];
    ops.valid[k] = (const uint8_t*)valids[k];
    vec = vec && (uintptr_t)vals[k] % 16 == 0 && (uintptr_t)valids[k] % 2 == 0;
  }
  for (int k = K; k < MAX_K; ++k) {
    ops.val[k] = nullptr;
    ops.valid[k] = nullptr;
  }
  const int64_t* g = (const int64_t*)gidx;
  const uint8_t* m = (const uint8_t*)mask;
  unsigned long long* o = (unsigned long long*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch<true>(g, m, ops, K, G, n, o, s)
             : launch<false>(g, m, ops, K, G, n, o, s);
}
