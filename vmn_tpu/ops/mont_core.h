// Montgomery arithmetic core shared by the CUDA kernels (mont_gpu.cu) and
// the host build used by the tests (mont_cpu.cc).
//
// Boundary format: the repository's (N, L) uint32 arrays of 16-bit limbs,
// least significant first, in Montgomery form for R = 2^(16 L).  Inside
// the core two limbs are packed into one 32-bit word, W = ceil(L / 2),
// and the product is CIOS over 32-bit words.  For odd L the core's own
// radix 2^(32 W) is R * 2^16, so the left operand is read shifted up by 16
// bits: mont32(a * 2^16, b) = a * b / R, with a * 2^16 < 2^(32 W) because
// a < m < 2^(16 L).  Inputs and outputs are canonical (< m).
//
// The accumulator row loops are fully unrolled over a compile-time W so the
// accumulator stays in registers; the outer loop over the words of `a` is
// not unrolled.  On the device the row products use PTX carry chains
// (mad.lo.cc / madc.hi.cc); on the host the same rows run on 64-bit
// integers.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define VMN_HD __host__ __device__ __forceinline__
#define VMN_UNROLL _Pragma("unroll")
#else
#define VMN_HD inline
#define VMN_UNROLL
#endif

namespace vmn {

// Word counts the library is instantiated for (keep in step with
// vmn_tpu/ops/core.py WIDTHS): P-224, 256-bit, P-384, P-521, 2048, 3072
// and 4096-bit moduli.
#define VMN_FOR_EACH_WIDTH(X) X(7) X(8) X(12) X(17) X(64) X(96) X(128)

// -m^{-1} mod 2^32 for odd m0 (Newton: each step doubles the correct bits).
VMN_HD uint32_t neg_inv32(uint32_t m0) {
  uint32_t x = m0;  // m0 * m0 == 1 (mod 8)
  for (int k = 0; k < 5; ++k) x *= 2u - m0 * x;
  return 0u - x;
}

struct Mod {
  const uint32_t* m;  // W packed words
  uint32_t mp;        // -m^{-1} mod 2^32
  bool shift;         // odd limb count: read the left operand * 2^16
};

// t[0 .. W+1] += ai * b.  Requires t < 2^(32 W + 1) on entry.
template <int W>
VMN_HD void mul_row(uint32_t (&t)[W + 2], uint32_t ai, const uint32_t (&b)[W]) {
#if defined(__CUDA_ARCH__)
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(ai), "r"(b[0]));
  VMN_UNROLL
  for (int j = 1; j < W; ++j)
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(ai), "r"(b[j]));
  asm volatile("addc.cc.u32 %0, %0, 0;" : "+r"(t[W]));
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[W + 1]));
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[1]) : "r"(ai), "r"(b[0]));
  VMN_UNROLL
  for (int j = 1; j < W; ++j)
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j + 1]) : "r"(ai), "r"(b[j]));
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[W + 1]));
#else
  uint64_t c = 0;
  for (int j = 0; j < W; ++j) {
    uint64_t s = (uint64_t)ai * b[j] + t[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  uint64_t s = (uint64_t)t[W] + c;
  t[W] = (uint32_t)s;
  t[W + 1] += (uint32_t)(s >> 32);
#endif
}

// t = (t + q m) / 2^32 with q = t[0] mp, so the low word cancels.
template <int W>
VMN_HD void red_row(uint32_t (&t)[W + 2], const uint32_t* m, uint32_t mp) {
  uint32_t q = t[0] * mp;
#if defined(__CUDA_ARCH__)
  uint32_t low;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(low) : "r"(q), "r"(m[0]), "r"(t[0]));
  VMN_UNROLL
  for (int j = 1; j < W; ++j)
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;"
                 : "=r"(t[j - 1]) : "r"(q), "r"(m[j]), "r"(t[j]));
  asm volatile("addc.cc.u32 %0, %1, 0;" : "=r"(t[W - 1]) : "r"(t[W]));
  asm volatile("addc.u32 %0, %1, 0;" : "=r"(t[W]) : "r"(t[W + 1]));
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[0]) : "r"(q), "r"(m[0]));
  VMN_UNROLL
  for (int j = 1; j < W; ++j)
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(t[j]) : "r"(q), "r"(m[j]));
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(t[W]));
  (void)low;
#else
  uint64_t s = (uint64_t)q * m[0] + t[0];
  uint64_t c = s >> 32;
  for (int j = 1; j < W; ++j) {
    s = (uint64_t)q * m[j] + t[j] + c;
    t[j - 1] = (uint32_t)s;
    c = s >> 32;
  }
  s = (uint64_t)t[W] + c;
  t[W - 1] = (uint32_t)s;
  t[W] = t[W + 1] + (uint32_t)(s >> 32);
#endif
  t[W + 1] = 0;
}

// r = a * b / R mod m.  r may alias a or b.
template <int W>
VMN_HD void mont_mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                     const Mod& md) {
  uint32_t bb[W];
  VMN_UNROLL
  for (int j = 0; j < W; ++j) bb[j] = b[j];
  uint32_t t[W + 2];
  VMN_UNROLL
  for (int j = 0; j < W + 2; ++j) t[j] = 0;
  for (int i = 0; i < W; ++i) {
    uint32_t ai = a[i];
    if (md.shift) ai = (ai << 16) | (i ? a[i - 1] >> 16 : 0u);
    mul_row<W>(t, ai, bb);
    red_row<W>(t, md.m, md.mp);
  }
  // t < 2m: subtract m once if t >= m.
  uint32_t d[W];
  uint32_t borrow = 0;
  VMN_UNROLL
  for (int j = 0; j < W; ++j) {
    uint64_t s = (uint64_t)t[j] - md.m[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  bool ge = t[W] != 0 || borrow == 0;
  VMN_UNROLL
  for (int j = 0; j < W; ++j) r[j] = ge ? d[j] : t[j];
}

// 16-bit limbs (one per uint32) <-> packed 32-bit words.
template <int W>
VMN_HD void pack(uint32_t* w, const uint32_t* limbs, int L) {
  VMN_UNROLL
  for (int j = 0; j < W; ++j) {
    uint32_t lo = 2 * j < L ? limbs[2 * j] : 0u;
    uint32_t hi = 2 * j + 1 < L ? limbs[2 * j + 1] : 0u;
    w[j] = (lo & 0xFFFFu) | (hi << 16);
  }
}

template <int W>
VMN_HD void unpack(uint32_t* limbs, const uint32_t* w, int L) {
  VMN_UNROLL
  for (int j = 0; j < W; ++j) {
    if (2 * j < L) limbs[2 * j] = w[j] & 0xFFFFu;
    if (2 * j + 1 < L) limbs[2 * j + 1] = w[j] >> 16;
  }
}

template <int W>
VMN_HD void copy(uint32_t* dst, const uint32_t* src) {
  VMN_UNROLL
  for (int j = 0; j < W; ++j) dst[j] = src[j];
}

// Digit j of width `bits` (4 or 8, so digits never straddle limbs) of an
// exponent held in Le 16-bit limbs; digits past the last limb are zero.
VMN_HD uint32_t digit(const uint32_t* e, int Le, int j, int bits) {
  int bit = j * bits;
  int limb = bit >> 4;
  if (limb >= Le) return 0u;
  return (e[limb] >> (bit & 15)) & ((1u << bits) - 1u);
}

// ---------------------------------------------------------------- elements
// Each function below computes one output element; the CUDA kernels run
// one thread per element, the host build loops.

// base^e, fixed 4-bit windows (ndig digits, most significant first).
template <int W>
VMN_HD void exp_elem(uint32_t* acc, const uint32_t* base_w, const uint32_t* e,
                     int Le, int ndig, const uint32_t* one_w, const Mod& md) {
  uint32_t tbl[16][W];
  copy<W>(tbl[0], one_w);
  copy<W>(tbl[1], base_w);
  for (int d = 2; d < 16; ++d) mont_mul<W>(tbl[d], tbl[d - 1], tbl[1], md);
  if (ndig <= 0) {
    copy<W>(acc, one_w);
    return;
  }
  copy<W>(acc, tbl[digit(e, Le, ndig - 1, 4)]);
  for (int j = ndig - 2; j >= 0; --j) {
    for (int s = 0; s < 4; ++s) mont_mul<W>(acc, acc, acc, md);
    mont_mul<W>(acc, acc, tbl[digit(e, Le, j, 4)], md);
  }
}

// prod_j table[j][digit_j(e)] over a shared (ndig, 2^bits, L) limb table.
template <int W>
VMN_HD void fb_elem(uint32_t* acc, const uint32_t* table, int ndig, int bits,
                    int L, const uint32_t* e, int Le, const uint32_t* one_w,
                    const Mod& md) {
  if (ndig <= 0) {
    copy<W>(acc, one_w);
    return;
  }
  int rows = 1 << bits;
  pack<W>(acc, table + (size_t)digit(e, Le, 0, bits) * L, L);
  uint32_t row[W];
  for (int j = 1; j < ndig; ++j) {
    size_t r = (size_t)j * rows + digit(e, Le, j, bits);
    pack<W>(row, table + r * L, L);
    mont_mul<W>(acc, acc, row, md);
  }
}

// Multi-exponentiation prod_i b_i^{e_i} by digit positions (Yao):
// e_i = sum_j 16^j d_ij, so the product is prod_j P_j^{16^j} with
// P_j = prod_i T_i[d_ij] and T_i[d] = b_i^d.  Stage 1 builds the tables,
// stage 2 folds one chunk of elements into one position, stage 3 folds the
// chunks, stage 4 combines the positions.

// Stage 1: tw (16 W words) = b^0 .. b^15.
template <int W>
VMN_HD void yao_table(uint32_t* tw, const uint32_t* base_w, const uint32_t* one_w,
                      const Mod& md) {
  copy<W>(tw, one_w);
  copy<W>(tw + W, base_w);
  for (int d = 2; d < 16; ++d)
    mont_mul<W>(tw + d * W, tw + (d - 1) * W, tw + W, md);
}

// Stage 2: acc = prod_{i0 <= i < i1} T_i[d_ij]  (one when the chunk is empty).
template <int W>
VMN_HD void yao_position(uint32_t* acc, const uint32_t* tables, const uint32_t* e,
                         int Le, int i0, int i1, int j, const uint32_t* one_w,
                         const Mod& md) {
  if (i0 >= i1) {
    copy<W>(acc, one_w);
    return;
  }
  copy<W>(acc, tables + ((size_t)i0 * 16 + digit(e + (size_t)i0 * Le, Le, j, 4)) * W);
  for (int i = i0 + 1; i < i1; ++i) {
    const uint32_t* row =
        tables + ((size_t)i * 16 + digit(e + (size_t)i * Le, Le, j, 4)) * W;
    mont_mul<W>(acc, acc, row, md);
  }
}

// Stage 3: acc = prod_c part[c][j] over nchunks chunks of ndig positions.
template <int W>
VMN_HD void yao_fold(uint32_t* acc, const uint32_t* part, int nchunks, int ndig,
                     int j, const Mod& md) {
  copy<W>(acc, part + (size_t)j * W);
  for (int c = 1; c < nchunks; ++c)
    mont_mul<W>(acc, acc, part + ((size_t)c * ndig + j) * W, md);
}

// Stage 4: acc = prod_j P_j^{16^j}, Horner from the top position.
template <int W>
VMN_HD void yao_combine(uint32_t* acc, const uint32_t* pos, int ndig,
                        const Mod& md) {
  copy<W>(acc, pos + (size_t)(ndig - 1) * W);
  for (int j = ndig - 2; j >= 0; --j) {
    for (int s = 0; s < 4; ++s) mont_mul<W>(acc, acc, acc, md);
    mont_mul<W>(acc, acc, pos + (size_t)j * W, md);
  }
}

}  // namespace vmn
