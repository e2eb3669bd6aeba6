// Host build of the Montgomery core (mont_core.h) as XLA FFI targets for
// the CPU.  It runs the same element functions as the CUDA kernels in
// mont_gpu.cu, on the portable 64-bit carry path, so the tests can check the
// core's arithmetic, the handlers' argument handling and the Python wrappers
// on a machine without a GPU.  Nothing outside the tests calls it.
//
// Build (done on first use by vmn_tpu/ops/core.py):
//   g++ -std=c++17 -O2 -shared -fPIC -I <jax.ffi.include_dir()> \
//       -o libvmn_mont_cpu.so mont_cpu.cc

#include <cstdint>
#include <string>
#include <vector>

#include "mont_core.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
using vmn::Mod;

namespace {

template <int W>
struct Host {
  uint32_t m[W];
  uint32_t one[W];
  Mod md;
  Host(const uint32_t* m_limbs, const uint32_t* one_limbs, int L) {
    vmn::pack<W>(m, m_limbs, L);
    if (one_limbs != nullptr) vmn::pack<W>(one, one_limbs, L);
    md.m = m;
    md.mp = vmn::neg_inv32(m[0]);
    md.shift = (L & 1) != 0;
  }
};

int stride(const ffi::Buffer<ffi::U32>& x, int L) {
  return x.dimensions()[0] == 1 ? 0 : L;
}

ffi::Error unsupported(int L) {
  return ffi::Error::InvalidArgument("vmn mont core: no build for " +
                                     std::to_string(L) + " limbs");
}

template <int W>
void mul(const uint32_t* a, int sa, const uint32_t* b, int sb,
         const uint32_t* m, int L, uint32_t* out, int n) {
  Host<W> h(m, nullptr, L);
  uint32_t aw[W], bw[W];
  for (int i = 0; i < n; ++i) {
    vmn::pack<W>(aw, a + (size_t)i * sa, L);
    vmn::pack<W>(bw, b + (size_t)i * sb, L);
    vmn::mont_mul<W>(aw, aw, bw, h.md);
    vmn::unpack<W>(out + (size_t)i * L, aw, L);
  }
}

template <int W>
void exp(const uint32_t* base, int sb, const uint32_t* e, int Le,
         const uint32_t* m, const uint32_t* one, int L, int ndig,
         uint32_t* out, int n) {
  Host<W> h(m, one, L);
  uint32_t bw[W], acc[W];
  for (int i = 0; i < n; ++i) {
    vmn::pack<W>(bw, base + (size_t)i * sb, L);
    vmn::exp_elem<W>(acc, bw, e + (size_t)i * Le, Le, ndig, h.one, h.md);
    vmn::unpack<W>(out + (size_t)i * L, acc, L);
  }
}

template <int W>
void fb(const uint32_t* table, int ndig, int bits, const uint32_t* e, int Le,
        const uint32_t* m, const uint32_t* one, int L, uint32_t* out, int n) {
  Host<W> h(m, one, L);
  uint32_t acc[W];
  for (int i = 0; i < n; ++i) {
    vmn::fb_elem<W>(acc, table, ndig, bits, L, e + (size_t)i * Le, Le, h.one,
                    h.md);
    vmn::unpack<W>(out + (size_t)i * L, acc, L);
  }
}

template <int W>
void expprod(const uint32_t* bases, const uint32_t* e, int Le,
             const uint32_t* m, const uint32_t* one, int L, int ndig,
             int nchunks, bool positions, uint32_t* tables, uint32_t* part,
             uint32_t* out, int n) {
  Host<W> h(m, one, L);
  uint32_t bw[W], acc[W];
  for (int i = 0; i < n; ++i) {
    vmn::pack<W>(bw, bases + (size_t)i * L, L);
    vmn::yao_table<W>(tables + (size_t)i * 16 * W, bw, h.one, h.md);
  }
  int chunk = (n + nchunks - 1) / nchunks;
  for (int c = 0; c < nchunks; ++c) {
    int i0 = c * chunk;
    int i1 = i0 + chunk < n ? i0 + chunk : n;
    for (int j = 0; j < ndig; ++j) {
      vmn::yao_position<W>(acc, tables, e, Le, i0, i1, j, h.one, h.md);
      vmn::copy<W>(part + ((size_t)c * ndig + j) * W, acc);
    }
  }
  uint32_t* pos = part + (size_t)nchunks * ndig * W;
  for (int j = 0; j < ndig; ++j) {
    vmn::yao_fold<W>(acc, part, nchunks, ndig, j, h.md);
    vmn::copy<W>(pos + (size_t)j * W, acc);
    if (positions) vmn::unpack<W>(out + (size_t)j * L, acc, L);
  }
  if (!positions) {
    vmn::yao_combine<W>(acc, pos, ndig, h.md);
    vmn::unpack<W>(out, acc, L);
  }
}

ffi::Error MulImpl(ffi::Buffer<ffi::U32> a, ffi::Buffer<ffi::U32> b,
                   ffi::Buffer<ffi::U32> m, ffi::ResultBuffer<ffi::U32> out) {
  int L = (int)m.element_count();
  int n = (int)out->dimensions()[0];
  switch ((L + 1) / 2) {
#define VMN_CASE(Wv)                                                       \
  case Wv:                                                                 \
    mul<Wv>(a.typed_data(), stride(a, L), b.typed_data(), stride(b, L),    \
            m.typed_data(), L, out->typed_data(), n);                      \
    break;
    VMN_FOR_EACH_WIDTH(VMN_CASE)
#undef VMN_CASE
    default:
      return unsupported(L);
  }
  return ffi::Error::Success();
}

ffi::Error ExpImpl(ffi::Buffer<ffi::U32> base, ffi::Buffer<ffi::U32> e,
                   ffi::Buffer<ffi::U32> m, ffi::Buffer<ffi::U32> one,
                   ffi::ResultBuffer<ffi::U32> out, int64_t ndig) {
  int L = (int)m.element_count();
  int n = (int)out->dimensions()[0];
  int Le = (int)e.dimensions()[1];
  switch ((L + 1) / 2) {
#define VMN_CASE(Wv)                                                       \
  case Wv:                                                                 \
    exp<Wv>(base.typed_data(), stride(base, L), e.typed_data(), Le,        \
            m.typed_data(), one.typed_data(), L, (int)ndig,                \
            out->typed_data(), n);                                         \
    break;
    VMN_FOR_EACH_WIDTH(VMN_CASE)
#undef VMN_CASE
    default:
      return unsupported(L);
  }
  return ffi::Error::Success();
}

ffi::Error FbExpImpl(ffi::Buffer<ffi::U32> table, ffi::Buffer<ffi::U32> e,
                     ffi::Buffer<ffi::U32> m, ffi::Buffer<ffi::U32> one,
                     ffi::ResultBuffer<ffi::U32> out) {
  int L = (int)m.element_count();
  int n = (int)out->dimensions()[0];
  int Le = (int)e.dimensions()[1];
  int ndig = (int)table.dimensions()[0];
  int rows = (int)table.dimensions()[1];
  int bits = rows == 256 ? 8 : 4;
  if (rows != (1 << bits))
    return ffi::Error::InvalidArgument("vmn mont core: table needs 16 or 256 rows");
  switch ((L + 1) / 2) {
#define VMN_CASE(Wv)                                                       \
  case Wv:                                                                 \
    fb<Wv>(table.typed_data(), ndig, bits, e.typed_data(), Le,             \
           m.typed_data(), one.typed_data(), L, out->typed_data(), n);     \
    break;
    VMN_FOR_EACH_WIDTH(VMN_CASE)
#undef VMN_CASE
    default:
      return unsupported(L);
  }
  return ffi::Error::Success();
}

ffi::Error ExpProdImpl(ffi::Buffer<ffi::U32> bases, ffi::Buffer<ffi::U32> e,
                       ffi::Buffer<ffi::U32> m, ffi::Buffer<ffi::U32> one,
                       ffi::ResultBuffer<ffi::U32> out,
                       ffi::ResultBuffer<ffi::U32> tables,
                       ffi::ResultBuffer<ffi::U32> part, int64_t ndig,
                       int64_t nchunks, int64_t positions) {
  int L = (int)m.element_count();
  int n = (int)bases.dimensions()[0];
  int Le = (int)e.dimensions()[1];
  if (n == 0 || ndig == 0)
    return ffi::Error::InvalidArgument("vmn mont core: empty multi-exponentiation");
  switch ((L + 1) / 2) {
#define VMN_CASE(Wv)                                                       \
  case Wv:                                                                 \
    expprod<Wv>(bases.typed_data(), e.typed_data(), Le, m.typed_data(),    \
                one.typed_data(), L, (int)ndig, (int)nchunks,              \
                positions != 0, tables->typed_data(), part->typed_data(),  \
                out->typed_data(), n);                                     \
    break;
    VMN_FOR_EACH_WIDTH(VMN_CASE)
#undef VMN_CASE
    default:
      return unsupported(L);
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(VmnMontMul, MulImpl,
                              ffi::Ffi::Bind()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(VmnMontExp, ExpImpl,
                              ffi::Ffi::Bind()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int64_t>("ndig"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(VmnMontFbExp, FbExpImpl,
                              ffi::Ffi::Bind()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(VmnMontExpProd, ExpProdImpl,
                              ffi::Ffi::Bind()
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
