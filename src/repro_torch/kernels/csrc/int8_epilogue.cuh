// The fused epilogue of the INT8 GEMM kernels (int8_matmul.cu and
// int8_matmul_sm90.cu): every kernel of the function runs it on exact
// int32 sums, so all of them agree bit for bit.
//
// From the exact accumulator A_q·B_q, colsum(B_q) of the column and
// rowsum(A_q) of the row it computes, in f32 and in the reference's order
// of operations,
//
//   real = (sa * sb[n]) * (((acc - za * colsum[n]) - zb[n] * rowsum[m])
//                          + (za * zb[n]) * K)  + bias[n]
//
// applies an activation (none / relu / gelu-tanh / silu) and writes f32,
// or requantizes with rint(real / so + zo) clipped to [qmin, qmax] (round
// half to even and a true division, as jnp.round and the oracle do).  The
// f32 steps, the activations' included, use the _rn intrinsics, so no
// multiply-add is contracted (tanhf and expf are the library's).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { kActNone = 0, kActRelu = 1, kActGelu = 2, kActSilu = 3 };
enum Out { kOutF32 = 0, kOutI8 = 1, kOutU8 = 2, kOutI16 = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if (ACT == kActRelu) return fmaxf(x, 0.f);
  if (ACT == kActGelu) {
    // jax.nn.gelu (approximate=True): x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))
    const float x3 = __fmul_rn(__fmul_rn(x, x), x);
    const float inner = __fmul_rn(0.7978845608028654f,
                                  __fadd_rn(x, __fmul_rn(0.044715f, x3)));
    return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
  }
  if (ACT == kActSilu) return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
  return x;
}

// The epilogue's per-call scalars; every kernel reads them once.
struct Epilogue {
  float sa, za, kf, so, zo;
  int qmin, qmax;
  bool has_bias;
  void* out;
};

template <int OUT>
__device__ __forceinline__ Epilogue load_epilogue(const float* sa_p, const float* za_p,
                                                  const float* bias, const float* so_p,
                                                  const float* zo_p, void* out, int K,
                                                  int qmin, int qmax) {
  Epilogue e;
  e.sa = *sa_p;
  e.za = *za_p;
  e.kf = static_cast<float>(K);
  e.so = 1.f;
  e.zo = 0.f;
  if (OUT != kOutF32) {
    e.so = *so_p;
    e.zo = *zo_p;
  }
  e.qmin = qmin;
  e.qmax = qmax;
  e.has_bias = bias != nullptr;
  e.out = out;
  return e;
}

// The fused epilogue's value of one output element from its exact int32
// accumulator, colsum(B) of its column, rowsum(A) of its row and its
// column's weight scale, zero point and bias: f32, or the requantized
// lattice point (an integer in [qmin, qmax], held in a float).
template <int ACT, int OUT>
__device__ __forceinline__ float epilogue_value(const Epilogue& e, int acc, int colsum,
                                                int rowsum, float sbc, float zbc,
                                                float biasc) {
  float x = __fsub_rn(static_cast<float>(acc), __fmul_rn(e.za, static_cast<float>(colsum)));
  x = __fsub_rn(x, __fmul_rn(zbc, static_cast<float>(rowsum)));
  x = __fadd_rn(x, __fmul_rn(__fmul_rn(e.za, zbc), e.kf));
  float real = __fmul_rn(__fmul_rn(e.sa, sbc), x);
  if (e.has_bias) real = __fadd_rn(real, biasc);
  real = activate<ACT>(real);
  if (OUT == kOutF32) return real;
  const float q = rintf(__fadd_rn(__fdiv_rn(real, e.so), e.zo));
  return fminf(fmaxf(q, static_cast<float>(e.qmin)), static_cast<float>(e.qmax));
}

// Writes epilogue values at out[idx] (and out[idx + 1] for put2, idx
// even) in the output type.
template <int OUT>
__device__ __forceinline__ void put(const Epilogue& e, size_t idx, float v) {
  if (OUT == kOutF32) static_cast<float*>(e.out)[idx] = v;
  if (OUT == kOutI8) static_cast<int8_t*>(e.out)[idx] = static_cast<int8_t>(static_cast<int>(v));
  if (OUT == kOutU8) static_cast<uint8_t*>(e.out)[idx] = static_cast<uint8_t>(static_cast<int>(v));
  if (OUT == kOutI16) static_cast<int16_t*>(e.out)[idx] = static_cast<int16_t>(static_cast<int>(v));
}
template <int OUT>
__device__ __forceinline__ void put2(const Epilogue& e, size_t idx, float v0, float v1) {
  if (OUT == kOutF32) reinterpret_cast<float2*>(static_cast<float*>(e.out) + idx)[0] = make_float2(v0, v1);
  if (OUT == kOutI8)
    reinterpret_cast<char2*>(static_cast<int8_t*>(e.out) + idx)[0] =
        make_char2(static_cast<int8_t>(static_cast<int>(v0)), static_cast<int8_t>(static_cast<int>(v1)));
  if (OUT == kOutU8)
    reinterpret_cast<uchar2*>(static_cast<uint8_t*>(e.out) + idx)[0] =
        make_uchar2(static_cast<uint8_t>(static_cast<int>(v0)), static_cast<uint8_t>(static_cast<int>(v1)));
  if (OUT == kOutI16)
    reinterpret_cast<short2*>(static_cast<int16_t*>(e.out) + idx)[0] =
        make_short2(static_cast<int16_t>(static_cast<int>(v0)), static_cast<int16_t>(static_cast<int>(v1)));
}

// The fused epilogue of one output element (see epilogue_value); `idx` is
// its place in out.
template <int ACT, int OUT>
__device__ __forceinline__ void store_output(const Epilogue& e, int acc, int colsum,
                                             int rowsum, float sbc, float zbc, float biasc,
                                             size_t idx) {
  put<OUT>(e, idx, epilogue_value<ACT, OUT>(e, acc, colsum, rowsum, sbc, zbc, biasc));
}

// 4 x 4 byte transpose: x, y, z, w hold rows k .. k+3 of columns n .. n+3;
// col[e] becomes column n + e's four K-consecutive bytes, row k lowest.
__device__ __forceinline__ void transpose4x4(unsigned x, unsigned y, unsigned z,
                                             unsigned w, unsigned* col) {
  const unsigned t0 = __byte_perm(x, y, 0x5140), t1 = __byte_perm(x, y, 0x7362);
  const unsigned t2 = __byte_perm(z, w, 0x5140), t3 = __byte_perm(z, w, 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

constexpr int kOnes = 0x01010101;  // __dp4a against it sums four bytes
constexpr int kMaxSmem = 232448;   // the most shared memory an H100 CTA may have

}  // namespace
