// Cold-tier bit-unpack, with the range decode fused into the same pass:
// little-endian packed dictionary codes -> one uint8 code per row, or,
// given a bias, one decoded value per row (code + bias, int32 or int64).
//
// Replaces the TPU kernel `unpack_codes` / `_unpack_kernel` in
// tidb_tpu/copr/pallas/kernels.py (K2 in PERF.md):
//     code[j] = (packed[j / vpb] >> ((j % vpb) * bits)) & (2**bits - 1),
//     vpb = 8 / bits, bits in {1, 2, 4, 8};
// with a bias it also takes the `range` branch of the JAX package's
// fusion.decode_packed, code.astype(bias.dtype) + bias, which that
// package runs inside the same fused program.
//
// What bounds it on an H100: bytes.  It reads n*bits/8 bytes and writes
// n*sizeof(out) bytes (1, 4 or 8 a row), with a few integer operations a
// row, far below the card's integer rate.  n = 64 Mi rows at 4 bits into
// uint8 move 96 MiB, about 30 us at 3.35 TB/s; 52,428,800 rows at 4 bits
// into int64 move 445 MB, about 133 us.
//
// Design.  A streaming kernel comes near the card's memory rate only
// with 16-byte accesses per thread, neighbouring threads on neighbouring
// addresses.  Each thread makes 16 rows per step and writes them with
// 16-byte vector stores: one for uint8, four for int32, eight for int64.
// The packed bits of 16 rows (2, 4, 8 or 16 bytes) are read in one load
// for uint8; a wider output's rows are split into slices of 16 bytes of
// output (4 int32 or 2 int64 rows) and slice k of lane t sits at slice
// 32k + t of the warp's 512 rows, so each store instruction of a warp
// writes 512 contiguous bytes and each load reads contiguous packed
// bytes.  (Sixteen consecutive rows per thread, whose eight int64 stores
// land 128 bytes apart across a warp, ran slower on the H100 than the
// three unfused passes: PERF.md.)
// Warps walk neighbouring steps in a grid-stride loop.  The uint8 form
// spreads four codes into the four bytes of a word with two
// shift-or-mask steps instead of one shift and mask per code.  With a
// bias, the widening and the add happen in registers (the add in the
// unsigned type of the output's width, so it wraps as JAX's integer add
// does), which saves the two full passes over n rows that the widening
// copy and the add would take after a bare unpack.
//
// A packed slice may start on any byte (the fused program slices it at
// a row offset that is only a multiple of 8), so the launcher tests the
// packed pointer's alignment once and takes, for the whole launch, an
// instance that reads a slice byte by byte when it is not aligned to
// the slice's load.  The output comes from torch.empty and must be
// 16-byte aligned (the wrapper checks).  n need not be a multiple of
// 512: the last n % 512 rows are made one per thread after the steps.
//
// C interface for ctypes: pointers and the stream as void*, sizes as
// int64; `out_size` is the output's element size (1 without a bias, 4
// or 8 with one).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a form it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 16;  // rows a thread makes per step
constexpr int THREADS = 256;

template <typename OUT> struct Wide;
template <> struct Wide<uint8_t> { using U = uint8_t; };
template <> struct Wide<int32_t> { using U = uint32_t; };
template <> struct Wide<int64_t> { using U = uint64_t; };

// Slice `i` of the packed codes: LBITS bits (LBITS/8 bytes, or a part
// of one byte) at bit offset i*LBITS, in the low bits of the result.
template <int LBITS, bool ALIGNED>
__device__ __forceinline__ uint64_t load_slice(
    const uint8_t* __restrict__ packed, int64_t i) {
  if constexpr (LBITS < 8) {
    const uint32_t byte = __ldg(packed + (i * LBITS) / 8);
    return (byte >> ((i * LBITS) % 8)) & ((1u << LBITS) - 1u);
  } else {
    constexpr int LB = LBITS / 8;
    const uint8_t* p = packed + i * LB;
    if constexpr (LB == 1) {
      return __ldg(p);
    } else if constexpr (!ALIGNED) {
      uint64_t v = 0;
#pragma unroll
      for (int b = 0; b < LB; ++b) v |= (uint64_t)__ldg(p + b) << (8 * b);
      return v;
    } else if constexpr (LB == 2) {
      return __ldg(reinterpret_cast<const unsigned short*>(p));
    } else if constexpr (LB == 4) {
      return __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      return (uint64_t)v.x | ((uint64_t)v.y << 32);
    }
  }
}

// Codes 4k..4k+3 of a 64-bit slice of 16 codes, one per byte of a word:
// two shift-or-mask steps instead of one shift and mask per code.
template <int BITS>
__device__ __forceinline__ uint32_t four_codes(uint64_t v, int k) {
  static_assert(BITS < 8, "8-bit codes are already bytes");
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  constexpr uint32_t M4 = (1u << (4 * BITS)) - 1u;
  constexpr uint32_t M1 = ((1u << (2 * BITS)) - 1u) * 0x00010001u;
  uint32_t x = (uint32_t)(v >> (4 * k * BITS)) & M4;
  x = (x | (x << (16 - 2 * BITS))) & M1;  // codes 0,1 | codes 2,3 at 16
  return (x | (x << (8 - BITS))) & (MASK * 0x01010101u);
}

// Each thread makes 16 rows per step as S = sizeof(OUT) slices of C =
// 16/S rows, one 16-byte store each.  A warp's step covers 512 rows;
// slice k of lane t holds rows (32k + t)*C .. +C of it, so each of the
// warp's S store instructions writes 512 contiguous bytes, and each of
// its S loads reads contiguous packed bytes.
template <int BITS, typename OUT, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
    unpack_codes_kernel(const uint8_t* __restrict__ packed,
                        OUT* __restrict__ out, const OUT* __restrict__ bias,
                        int64_t n) {
  using U = typename Wide<OUT>::U;
  constexpr int S = sizeof(OUT);
  constexpr int C = 16 / S;
  constexpr int LBITS = C * BITS;
  constexpr int STEP = 32 * GROUP;  // rows a warp makes per step
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  U b = 0;
  if constexpr (S > 1) b = (U)*bias;  // once per thread
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int lane = threadIdx.x % 32;
  const int64_t steps = n / STEP;
  for (int64_t w = tid / 32; w < steps; w += stride / 32) {
    uint64_t v[S];
#pragma unroll
    for (int k = 0; k < S; ++k)
      v[k] = load_slice<LBITS, ALIGNED>(packed, w * 32 * S + k * 32 + lane);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      OUT* o = out + w * STEP + (k * 32 + lane) * C;
      if constexpr (S == 1) {
        *reinterpret_cast<uint4*>(o) =
            make_uint4(four_codes<BITS>(v[k], 0), four_codes<BITS>(v[k], 1),
                       four_codes<BITS>(v[k], 2), four_codes<BITS>(v[k], 3));
      } else if constexpr (S == 4) {
        const uint32_t x = (uint32_t)v[k];
        *reinterpret_cast<uint4*>(o) = make_uint4(
            (x & MASK) + b, ((x >> BITS) & MASK) + b,
            ((x >> (2 * BITS)) & MASK) + b, ((x >> (3 * BITS)) & MASK) + b);
      } else {
        const uint32_t x = (uint32_t)v[k];
        *reinterpret_cast<ulonglong2*>(o) =
            make_ulonglong2((x & MASK) + b, ((x >> BITS) & MASK) + b);
      }
    }
  }
  // the ragged end: the last n % 512 rows, one per thread
  constexpr int VPB = 8 / BITS;
  for (int64_t j = steps * STEP + tid; j < n; j += stride) {
    const uint32_t c =
        ((uint32_t)__ldg(packed + j / VPB) >> ((int)(j % VPB) * BITS)) & MASK;
    out[j] = (OUT)((U)c + b);
  }
}

template <int BITS, typename OUT>
int launch(const void* packed, void* out, const void* bias, int64_t n,
           cudaStream_t s) {
  constexpr int LB = 16 / sizeof(OUT) * BITS / 8;  // bytes a slice loads
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t blocks = (n / GROUP + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)sms * 32;  // grid-stride beyond this
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;  // fewer than 512 rows: the ragged end only
  const uint8_t* p = (const uint8_t*)packed;
  OUT* o = (OUT*)out;
  const OUT* b = (const OUT*)bias;
  if (LB <= 1 || (uintptr_t)p % LB == 0)
    unpack_codes_kernel<BITS, OUT, true>
        <<<(unsigned)blocks, THREADS, 0, s>>>(p, o, b, n);
  else
    unpack_codes_kernel<BITS, OUT, false>
        <<<(unsigned)blocks, THREADS, 0, s>>>(p, o, b, n);
  return (int)cudaGetLastError();
}

template <typename OUT>
int by_bits(int bits, const void* packed, void* out, const void* bias,
            int64_t n, cudaStream_t s) {
  switch (bits) {
    case 1: return launch<1, OUT>(packed, out, bias, n, s);
    case 2: return launch<2, OUT>(packed, out, bias, n, s);
    case 4: return launch<4, OUT>(packed, out, bias, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tidb_unpack_codes(const void* packed, void* out,
                                 const void* bias, int64_t n, int bits,
                                 int out_size, void* stream) {
  if (n <= 0) return 0;
  if ((uintptr_t)out % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_size == 1) {
    if (bias != nullptr) return (int)cudaErrorInvalidValue;
    return by_bits<uint8_t>(bits, packed, out, bias, n, s);
  }
  if (bias == nullptr) return (int)cudaErrorInvalidValue;
  if (out_size == 4) {
    if (bits == 8) return launch<8, int32_t>(packed, out, bias, n, s);
    return by_bits<int32_t>(bits, packed, out, bias, n, s);
  }
  if (out_size == 8) {
    if (bits == 8) return launch<8, int64_t>(packed, out, bias, n, s);
    return by_bits<int64_t>(bits, packed, out, bias, n, s);
  }
  return (int)cudaErrorInvalidValue;
}
