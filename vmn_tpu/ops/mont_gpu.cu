// CUDA kernels and XLA FFI handlers for the Montgomery core (mont_core.h).
//
// Build (done on first use by vmn_tpu/ops/core.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o libvmn_mont_gpu.so \
//        mont_gpu.cu
//
// One thread computes one output element.  The modulus (and the Montgomery
// one) are packed into shared memory once per block; per-thread operands,
// the exponentiation window table and the accumulator live in registers and
// local memory.  The handlers only enqueue kernels on XLA's stream.

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "mont_core.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
using vmn::Mod;

namespace {

constexpr int kBlock = 128;

// Packs m (and optionally one) from 16-bit limbs into shared memory.
template <int W>
__device__ Mod block_mod(uint32_t* sm, const uint32_t* m, const uint32_t* one,
                         int L) {
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    uint32_t lo = 2 * k < L ? m[2 * k] : 0u;
    uint32_t hi = 2 * k + 1 < L ? m[2 * k + 1] : 0u;
    sm[k] = (lo & 0xFFFFu) | (hi << 16);
    if (one != nullptr) {
      lo = 2 * k < L ? one[2 * k] : 0u;
      hi = 2 * k + 1 < L ? one[2 * k + 1] : 0u;
      sm[W + k] = (lo & 0xFFFFu) | (hi << 16);
    }
  }
  __syncthreads();
  Mod md;
  md.m = sm;
  md.mp = vmn::neg_inv32(sm[0]);
  md.shift = (L & 1) != 0;
  return md;
}

template <int W>
__global__ void mul_kernel(const uint32_t* a, int a_stride, const uint32_t* b,
                           int b_stride, const uint32_t* m, int L,
                           uint32_t* out, int n) {
  __shared__ uint32_t sm[W];
  Mod md = block_mod<W>(sm, m, nullptr, L);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t aw[W], bw[W];
  vmn::pack<W>(aw, a + (size_t)i * a_stride, L);
  vmn::pack<W>(bw, b + (size_t)i * b_stride, L);
  vmn::mont_mul<W>(aw, aw, bw, md);
  vmn::unpack<W>(out + (size_t)i * L, aw, L);
}

template <int W>
__global__ void exp_kernel(const uint32_t* base, int base_stride,
                           const uint32_t* e, int Le, const uint32_t* m,
                           const uint32_t* one, int L, int ndig, uint32_t* out,
                           int n) {
  __shared__ uint32_t sm[2 * W];
  Mod md = block_mod<W>(sm, m, one, L);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t bw[W], acc[W];
  vmn::pack<W>(bw, base + (size_t)i * base_stride, L);
  vmn::exp_elem<W>(acc, bw, e + (size_t)i * Le, Le, ndig, sm + W, md);
  vmn::unpack<W>(out + (size_t)i * L, acc, L);
}

template <int W>
__global__ void fb_kernel(const uint32_t* table, int ndig, int bits,
                          const uint32_t* e, int Le, const uint32_t* m,
                          const uint32_t* one, int L, uint32_t* out, int n) {
  __shared__ uint32_t sm[2 * W];
  Mod md = block_mod<W>(sm, m, one, L);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t acc[W];
  vmn::fb_elem<W>(acc, table, ndig, bits, L, e + (size_t)i * Le, Le, sm + W, md);
  vmn::unpack<W>(out + (size_t)i * L, acc, L);
}

template <int W>
__global__ void yao_table_kernel(const uint32_t* base, const uint32_t* m,
                                 const uint32_t* one, int L, uint32_t* tables,
                                 int n) {
  __shared__ uint32_t sm[2 * W];
  Mod md = block_mod<W>(sm, m, one, L);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t bw[W];
  vmn::pack<W>(bw, base + (size_t)i * L, L);
  vmn::yao_table<W>(tables + (size_t)i * 16 * W, bw, sm + W, md);
}

// grid (position blocks, chunks): thread (j, c) folds chunk c into P_j.
template <int W>
__global__ void yao_position_kernel(const uint32_t* tables, const uint32_t* e,
                                    int Le, const uint32_t* m,
                                    const uint32_t* one, int L, int ndig,
                                    int chunk, uint32_t* part, int n) {
  __shared__ uint32_t sm[2 * W];
  Mod md = block_mod<W>(sm, m, one, L);
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int c = blockIdx.y;
  if (j >= ndig) return;
  int i0 = c * chunk;
  int i1 = min(n, i0 + chunk);
  uint32_t acc[W];
  vmn::yao_position<W>(acc, tables, e, Le, i0, i1, j, sm + W, md);
  vmn::copy<W>(part + ((size_t)c * ndig + j) * W, acc);
}

template <int W>
__global__ void yao_fold_kernel(const uint32_t* part, int nchunks, int ndig,
                                const uint32_t* m, int L, uint32_t* pos,
                                uint32_t* out) {
  __shared__ uint32_t sm[W];
  Mod md = block_mod<W>(sm, m, nullptr, L);
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ndig) return;
  uint32_t acc[W];
  vmn::yao_fold<W>(acc, part, nchunks, ndig, j, md);
  vmn::copy<W>(pos + (size_t)j * W, acc);
  if (out != nullptr) vmn::unpack<W>(out + (size_t)j * L, acc, L);
}

template <int W>
__global__ void yao_combine_kernel(const uint32_t* pos, int ndig,
                                   const uint32_t* m, int L, uint32_t* out) {
  __shared__ uint32_t sm[W];
  Mod md = block_mod<W>(sm, m, nullptr, L);
  if (threadIdx.x != 0) return;
  uint32_t acc[W];
  vmn::yao_combine<W>(acc, pos, ndig, md);
  vmn::unpack<W>(out, acc, L);
}

int blocks(int64_t n) { return (int)((n + kBlock - 1) / kBlock); }

ffi::Error launch_status() {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("vmn mont core: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error unsupported(int L) {
  return ffi::Error::InvalidArgument("vmn mont core: no build for " +
                                     std::to_string(L) + " limbs");
}

int stride(const ffi::Buffer<ffi::U32>& x, int L) {
  return x.dimensions()[0] == 1 ? 0 : L;
}

ffi::Error MulImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> a,
                   ffi::Buffer<ffi::U32> b, ffi::Buffer<ffi::U32> m,
                   ffi::ResultBuffer<ffi::U32> out) {
  int L = (int)m.element_count();
  int n = (int)out->dimensions()[0];
  if (n == 0) return ffi::Error::Success();
  switch ((L + 1) / 2) {
#define VMN_CASE(Wv)                                                        \
  case Wv:                                                                  \
    mul_kernel<Wv><<<blocks(n), kBlock, 0, stream>>>(                       \
        a.typed_data(), stride(a, L), b.typed_data(), stride(b, L),         \
        m.typed_data(), L, out->typed_data(), n);                           \
    break;
    VMN_FOR_EACH_WIDTH(VMN_CASE)
#undef VMN_CASE
    default:
      return unsupported(L);
  }
  return launch_status();
}

ffi::Error ExpImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> base,
                   ffi::Buffer<ffi::U32> e, ffi::Buffer<ffi::U32> m,
                   ffi::Buffer<ffi::U32> one, ffi::ResultBuffer<ffi::U32> out,
                   int64_t ndig) {
  int L = (int)m.element_count();
  int n = (int)out->dimensions()[0];
  int Le = (int)e.dimensions()[1];
  if (n == 0) return ffi::Error::Success();
  switch ((L + 1) / 2) {
#define VMN_CASE(Wv)                                                        \
  case Wv:                                                                  \
    exp_kernel<Wv><<<blocks(n), kBlock, 0, stream>>>(                       \
        base.typed_data(), stride(base, L), e.typed_data(), Le,             \
        m.typed_data(), one.typed_data(), L, (int)ndig, out->typed_data(),  \
        n);                                                                 \
    break;
    VMN_FOR_EACH_WIDTH(VMN_CASE)
#undef VMN_CASE
    default:
      return unsupported(L);
  }
  return launch_status();
}

ffi::Error FbExpImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> table,
                     ffi::Buffer<ffi::U32> e, ffi::Buffer<ffi::U32> m,
                     ffi::Buffer<ffi::U32> one,
                     ffi::ResultBuffer<ffi::U32> out) {
  int L = (int)m.element_count();
  int n = (int)out->dimensions()[0];
  int Le = (int)e.dimensions()[1];
  int ndig = (int)table.dimensions()[0];
  int rows = (int)table.dimensions()[1];
  int bits = rows == 256 ? 8 : 4;
  if (rows != (1 << bits))
    return ffi::Error::InvalidArgument("vmn mont core: table needs 16 or 256 rows");
  if (n == 0) return ffi::Error::Success();
  switch ((L + 1) / 2) {
#define VMN_CASE(Wv)                                                        \
  case Wv:                                                                  \
    fb_kernel<Wv><<<blocks(n), kBlock, 0, stream>>>(                        \
        table.typed_data(), ndig, bits, e.typed_data(), Le,                 \
        m.typed_data(), one.typed_data(), L, out->typed_data(), n);         \
    break;
    VMN_FOR_EACH_WIDTH(VMN_CASE)
#undef VMN_CASE
    default:
      return unsupported(L);
  }
  return launch_status();
}

// out: (1, L) product, or (ndig, L) positions when `positions` is set.
// tables: (n * 16 * W) words, part: ((nchunks + 1) * ndig * W) words.
ffi::Error ExpProdImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> bases,
                       ffi::Buffer<ffi::U32> e, ffi::Buffer<ffi::U32> m,
                       ffi::Buffer<ffi::U32> one,
                       ffi::ResultBuffer<ffi::U32> out,
                       ffi::ResultBuffer<ffi::U32> tables,
                       ffi::ResultBuffer<ffi::U32> part, int64_t ndig64,
                       int64_t nchunks64, int64_t positions) {
  int L = (int)m.element_count();
  int n = (int)bases.dimensions()[0];
  int Le = (int)e.dimensions()[1];
  int ndig = (int)ndig64;
  int nchunks = (int)nchunks64;
  int chunk = (n + nchunks - 1) / nchunks;
  if (n == 0 || ndig == 0)
    return ffi::Error::InvalidArgument("vmn mont core: empty multi-exponentiation");
  constexpr int kPosBlock = 64;
  dim3 pgrid((ndig + kPosBlock - 1) / kPosBlock, nchunks);
  switch ((L + 1) / 2) {
#define VMN_CASE(Wv)                                                         \
  case Wv: {                                                                 \
    uint32_t* pos = part->typed_data() + (size_t)nchunks * ndig * Wv;        \
    yao_table_kernel<Wv><<<blocks(n), kBlock, 0, stream>>>(                  \
        bases.typed_data(), m.typed_data(), one.typed_data(), L,             \
        tables->typed_data(), n);                                            \
    yao_position_kernel<Wv><<<pgrid, kPosBlock, 0, stream>>>(                \
        tables->typed_data(), e.typed_data(), Le, m.typed_data(),            \
        one.typed_data(), L, ndig, chunk, part->typed_data(), n);            \
    yao_fold_kernel<Wv><<<blocks(ndig), kBlock, 0, stream>>>(                \
        part->typed_data(), nchunks, ndig, m.typed_data(), L, pos,           \
        positions ? out->typed_data() : nullptr);                            \
    if (!positions)                                                          \
      yao_combine_kernel<Wv><<<1, 32, 0, stream>>>(pos, ndig, m.typed_data(), \
                                                   L, out->typed_data());    \
    break;                                                                   \
  }
    VMN_FOR_EACH_WIDTH(VMN_CASE)
#undef VMN_CASE
    default:
      return unsupported(L);
  }
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(VmnMontMul, MulImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(VmnMontExp, ExpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int64_t>("ndig"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(VmnMontFbExp, FbExpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(VmnMontExpProd, ExpProdImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int64_t>("ndig")
                                  .Attr<int64_t>("nchunks")
                                  .Attr<int64_t>("positions"));
