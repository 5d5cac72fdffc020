// Dictionary-code re-mapping for computed group keys:
//     out[i] = mapping[clip(codes[i], 0, cap - 1)]
//
// Replaces the TPU kernel `remap_codes` / `_remap_kernel` in
// tidb_tpu/copr/pallas/kernels.py (K1 in PERF.md).  The host evaluates a
// computed key (lower(s), substr(s, 2, 2), ascii(s), ...) once per
// DICTIONARY entry; rows then regather their codes through `mapping`:
// output-dictionary codes (int32) for STRING keys, the computed values
// themselves (int64) for LENGTH/ASCII keys.  `cap` is the mapping's
// length, a power of two >= 2.
//
// Codes clip after sign extension to int64, so negative codes land on
// slot 0 and codes >= cap on slot cap-1, as jnp.clip does on the TPU.
//
// What bounds it on an H100: bytes.  Each row reads one code (1-8 bytes)
// and writes one mapped value (4 or 8 bytes); the mapping is read once
// per block.  Design: one thread per row in a grid-stride loop,
// templated on the code type (so a narrow wire column is read as it is,
// with no widening copy first) and on the mapping type.  A mapping of at
// most SMEM_MAX_BYTES is staged in shared memory by every block, so the
// data-dependent lookups hit shared memory; a larger one (a dictionary of
// millions of entries) is read through the read-only cache (__ldg).
//
// C interface for ctypes: pointers and the stream as void*, sizes as
// int64, dtypes as small ints; returns cudaGetLastError() after the
// launch (or cudaErrorInvalidValue for a dtype it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

// 48 KiB: the static shared-memory limit of a block without an opt-in.
static const int64_t SMEM_MAX_BYTES = 48 * 1024;

template <typename CodeT>
__device__ __forceinline__ int64_t clip_code(CodeT c, int64_t cap) {
  int64_t x = (int64_t)c;  // sign extension for signed code types
  x = x < 0 ? 0 : x;
  return x > cap - 1 ? cap - 1 : x;
}

template <typename CodeT, typename MapT>
__global__ void remap_codes_smem(const CodeT* __restrict__ codes,
                                 const MapT* __restrict__ mapping,
                                 MapT* __restrict__ out, int64_t n,
                                 int64_t cap) {
  extern __shared__ unsigned char smem_raw[];
  MapT* m = reinterpret_cast<MapT*>(smem_raw);
  for (int64_t j = threadIdx.x; j < cap; j += blockDim.x) m[j] = mapping[j];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = m[clip_code(codes[i], cap)];
  }
}

template <typename CodeT, typename MapT>
__global__ void remap_codes_ldg(const CodeT* __restrict__ codes,
                                const MapT* __restrict__ mapping,
                                MapT* __restrict__ out, int64_t n,
                                int64_t cap) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = __ldg(mapping + clip_code(codes[i], cap));
  }
}

template <typename CodeT, typename MapT>
static int launch(const void* codes, const void* mapping, void* out,
                  int64_t n, int64_t cap, cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  const CodeT* c = (const CodeT*)codes;
  const MapT* m = (const MapT*)mapping;
  MapT* o = (MapT*)out;
  const int64_t map_bytes = cap * (int64_t)sizeof(MapT);
  if (map_bytes <= SMEM_MAX_BYTES) {
    // every block copies the mapping once: fewer, longer-lived blocks
    // when the mapping is large, so the copy stays small beside the rows
    const int64_t most = (int64_t)sms * (map_bytes <= 4096 ? 32 : 4);
    if (blocks > most) blocks = most;
    remap_codes_smem<CodeT, MapT><<<(unsigned)blocks, threads,
                                    (size_t)map_bytes, s>>>(c, m, o, n, cap);
  } else {
    const int64_t most = (int64_t)sms * 32;
    if (blocks > most) blocks = most;
    remap_codes_ldg<CodeT, MapT><<<(unsigned)blocks, threads, 0, s>>>(
        c, m, o, n, cap);
  }
  return (int)cudaGetLastError();
}

template <typename CodeT>
static int by_map(int map_kind, const void* codes, const void* mapping,
                  void* out, int64_t n, int64_t cap, cudaStream_t s) {
  switch (map_kind) {
    case 4: return launch<CodeT, int32_t>(codes, mapping, out, n, cap, s);
    case 8: return launch<CodeT, int64_t>(codes, mapping, out, n, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// code_kind: 0 uint8, 1 int8, 2 int16, 3 int32, 4 int64
// map_kind:  4 int32, 8 int64
extern "C" int tidb_remap_codes(const void* codes, const void* mapping,
                                void* out, int64_t n, int64_t cap,
                                int code_kind, int map_kind, void* stream) {
  if (n <= 0) return 0;
  if (cap < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (code_kind) {
    case 0: return by_map<uint8_t>(map_kind, codes, mapping, out, n, cap, s);
    case 1: return by_map<int8_t>(map_kind, codes, mapping, out, n, cap, s);
    case 2: return by_map<int16_t>(map_kind, codes, mapping, out, n, cap, s);
    case 3: return by_map<int32_t>(map_kind, codes, mapping, out, n, cap, s);
    case 4: return by_map<int64_t>(map_kind, codes, mapping, out, n, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
