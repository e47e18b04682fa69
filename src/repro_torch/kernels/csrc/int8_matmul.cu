// Fused INT8 GEMM with a dequant -> activation -> requant epilogue, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `int8_matmul_pallas` of
// src/repro/kernels/int8_matmul.py (body `_kernel`): the paper's on-device
// layer (section 2.1, steps 1-4).  int8 A [M, K] (K contiguous) times int8
// B [K, N] (N contiguous) into an int32 accumulator, with int32 rowsum(A)
// and colsum(B) accumulated in the same K loop; the epilogue computes, in
// f32 and in the reference's order of operations,
//
//   real = (sa * sb[n]) * (((acc - za * colsum[n]) - zb[n] * rowsum[m])
//                          + (za * zb[n]) * K)  + bias[n]
//
// applies an activation (none / relu / gelu-tanh / silu) and writes f32,
// or requantizes with rint(real / so + zo) clipped to [qmin, qmax] (round
// half to even and a true division, as jnp.round and the oracle do).  The
// f32 steps, the activations' included, use the _rn intrinsics, so no
// multiply-add is contracted (tanhf and expf are the library's).
//
// What bounds it on an H100: at decode (M = 4) the bytes of B, one pass
// over the weight matrix (45 MB at 4096 x 11008); at prefill (M = 512) the
// int8 tensor-core operations.  What this first version does:
//   * int8 tensor cores through `mma.sync.aligned.m16n8k32` (s8 x s8 -> s32),
//     which sm_90a keeps from Ampere; a CTA of 4 warps owns a 64 x 64 output
//     tile, each warp 32 x 32;
//   * A and B tiles of K depth 128 are staged in shared memory; B is
//     transposed on the way in with byte permutes (a 4 x 4 byte transpose of
//     four 32-bit words), so each B fragment register is one aligned 32-bit
//     shared load; the next tile's global loads are issued before the
//     current tile's MMAs, so their latency overlaps the compute;
//   * loads are predicated: elements outside [M, K] / [K, N] read as 0, which
//     is exact because the za * zb * K term uses the true K, and outputs
//     outside [M, N] are not stored -- nothing is padded on the host;
//   * rowsum / colsum come from the staged tiles with __dp4a, recomputed by
//     every CTA for its own rows / columns, as the TPU kernel does;
//   * the epilogue runs on the accumulator registers; the int32 accumulator
//     never goes to device memory.
// wgmma, TMA loads, a multi-stage pipelined mainloop and split-K for the
// small-M (decode) grid are left for later work.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//         -Xcompiler -fPIC -o libint8_matmul.so int8_matmul.cu
// The plain C entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;           // output rows per CTA
constexpr int kBN = 64;           // output columns per CTA
constexpr int kBK = 128;          // K depth of one staged tile
constexpr int kThreads = 128;     // 4 warps, 2 x 2 over the tile
constexpr int kPitch = kBK + 16;  // bytes per shared row (A rows, B columns)
constexpr int kWords = kPitch / 4;
constexpr unsigned kFull = 0xffffffffu;

enum Act { kActNone = 0, kActRelu = 1, kActGelu = 2, kActSilu = 3 };
enum Out { kOutF32 = 0, kOutI8 = 1, kOutU8 = 2, kOutI16 = 3 };

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Word `w` of transposed B column `n` is stored at w ^ swizzle: the four
// 16-column groups that one warp stores at once land in different banks.
__device__ __forceinline__ int bsw(int n, int w) { return w ^ (((n >> 4) & 3) << 3); }

// 16 bytes of a row-major int8 matrix with `cols` columns, starting at
// (row, c0); bytes outside [rows, cols] read as 0.  `vec`: cols % 16 == 0
// and the base is 16-byte aligned, so a chunk is wholly in or out.
__device__ __forceinline__ uint4 load_chunk(const int8_t* __restrict__ p, int rows,
                                            int cols, int row, int c0, bool vec) {
  if (row >= rows || c0 >= cols) return make_uint4(0, 0, 0, 0);
  const int8_t* src = p + static_cast<size_t>(row) * cols + c0;
  if (vec) return *reinterpret_cast<const uint4*>(src);
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (c0 + e < cols)
      w[e >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(src[e])) << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

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

template <int ACT, int OUT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ A,     // [M, K]
                   const int8_t* __restrict__ B,     // [K, N]
                   const float* __restrict__ sa_p,   // () activation scale
                   const float* __restrict__ za_p,   // () activation zero point
                   const float* __restrict__ sb,     // [N] weight scales
                   const float* __restrict__ zb,     // [N] weight zero points
                   const float* __restrict__ bias,   // [N] or null
                   const float* __restrict__ so_p,   // () output scale (requant)
                   const float* __restrict__ zo_p,   // () output zero point
                   void* __restrict__ out,           // [M, N]
                   int M, int N, int K, int qmin, int qmax, bool a_vec, bool b_vec) {
  __shared__ __align__(16) uint8_t As[kBM * kPitch];  // A rows, K contiguous
  __shared__ __align__(16) uint8_t Bs[kBN * kPitch];  // B columns, K contiguous
  __shared__ int rs_s[kBM];
  __shared__ int cs_s[kBN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group id
  const int t = lane & 3;   // thread in group
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;
  int rsum = 0, csum = 0;

  // A tile: 64 rows x 8 chunks of 16 B, four chunks a thread.  B tile: 32
  // quads of K rows x 4 chunks of 16 columns, one (4 x 16) block a thread.
  uint4 ar[4], br[4];
  const int bq = tid >> 2;          // K quad of this thread's B block
  const int bc = (tid & 3) * 16;    // first column of this thread's B block
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kThreads;
      ar[i] = load_chunk(A, M, K, m0 + (c >> 3), k0 + (c & 7) * 16, a_vec);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      br[r] = load_chunk(B, K, N, k0 + bq * 4 + r, n0 + bc, b_vec);
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<uint4*>(As + (c >> 3) * kPitch + (c & 7) * 16) = ar[i];
    }
    // 4 x 4 byte transposes: rows k..k+3 of columns n..n+3 become one
    // K-contiguous word per column
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned x = word(br[0], j), y = word(br[1], j);
      const unsigned z = word(br[2], j), w = word(br[3], j);
      const unsigned t0 = __byte_perm(x, y, 0x5140), t1 = __byte_perm(x, y, 0x7362);
      const unsigned t2 = __byte_perm(z, w, 0x5140), t3 = __byte_perm(z, w, 0x7362);
      const unsigned col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                               __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = bc + j * 4 + e;
        reinterpret_cast<unsigned*>(Bs + n * kPitch)[bsw(n, bq)] = col[e];
      }
    }
  };

  const int nk = (K + kBK - 1) / kBK;
  load_tiles(0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous tile has been consumed
    store_tiles();
    __syncthreads();
    if (kt + 1 < nk) load_tiles((kt + 1) * kBK);  // in flight during the MMAs

    // rowsum(A) / colsum(B): two threads per row / column, 64 bytes each
    {
      const unsigned* ra = reinterpret_cast<const unsigned*>(As + (tid >> 1) * kPitch) + (tid & 1) * 16;
      const unsigned* cb = reinterpret_cast<const unsigned*>(Bs + (tid >> 1) * kPitch) + (tid & 1) * 16;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        rsum = __dp4a(static_cast<int>(ra[i]), 0x01010101, rsum);
        csum = __dp4a(static_cast<int>(cb[i]), 0x01010101, csum);
      }
    }

#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      const int kw = ks * 8;  // first word of this k32 step
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        const unsigned* p0 = reinterpret_cast<const unsigned*>(As + r * kPitch);
        const unsigned* p1 = reinterpret_cast<const unsigned*>(As + (r + 8) * kPitch);
        af[mi][0] = p0[kw + t];
        af[mi][1] = p1[kw + t];
        af[mi][2] = p0[kw + 4 + t];
        af[mi][3] = p1[kw + 4 + t];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g;
        const unsigned* q = reinterpret_cast<const unsigned*>(Bs + n * kPitch);
        bf[ni][0] = q[bsw(n, kw + t)];
        bf[ni][1] = q[bsw(n, kw + 4 + t)];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }

  rsum += __shfl_xor_sync(kFull, rsum, 1);
  csum += __shfl_xor_sync(kFull, csum, 1);
  if ((tid & 1) == 0) {
    rs_s[tid >> 1] = rsum;
    cs_s[tid >> 1] = csum;
  }
  __syncthreads();

  // fused epilogue on the accumulator registers
  const float sa = *sa_p;
  const float za = *za_p;
  const float kf = static_cast<float>(K);
  float so = 1.f, zo = 0.f;
  if (OUT != kOutF32) {
    so = *so_p;
    zo = *zo_p;
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + mi * 16 + g + (i >> 1) * 8;
        const int c = wn + ni * 8 + t * 2 + (i & 1);
        const int gr = m0 + r;
        const int gc = n0 + c;
        if (gr >= M || gc >= N) continue;
        const float zbc = zb[gc];
        float x = __fsub_rn(static_cast<float>(acc[mi][ni][i]),
                            __fmul_rn(za, static_cast<float>(cs_s[c])));
        x = __fsub_rn(x, __fmul_rn(zbc, static_cast<float>(rs_s[r])));
        x = __fadd_rn(x, __fmul_rn(__fmul_rn(za, zbc), kf));
        float real = __fmul_rn(__fmul_rn(sa, sb[gc]), x);
        if (bias != nullptr) real = __fadd_rn(real, bias[gc]);
        real = activate<ACT>(real);
        const size_t idx = static_cast<size_t>(gr) * N + gc;
        if (OUT == kOutF32) {
          static_cast<float*>(out)[idx] = real;
        } else {
          float q = rintf(__fadd_rn(__fdiv_rn(real, so), zo));
          q = fminf(fmaxf(q, static_cast<float>(qmin)), static_cast<float>(qmax));
          const int qi = static_cast<int>(q);
          if (OUT == kOutI8) static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(qi);
          if (OUT == kOutU8) static_cast<uint8_t*>(out)[idx] = static_cast<uint8_t>(qi);
          if (OUT == kOutI16) static_cast<int16_t*>(out)[idx] = static_cast<int16_t>(qi);
        }
      }
    }
  }
}

template <int ACT, int OUT>
int launch(const int8_t* a, const int8_t* b, const float* sa, const float* za,
           const float* sb, const float* zb, const float* bias, const float* so,
           const float* zo, void* out, int M, int N, int K, int qmin, int qmax,
           cudaStream_t stream) {
  const bool a_vec = K % 16 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool b_vec = N % 16 == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<ACT, OUT><<<grid, kThreads, 0, stream>>>(
      a, b, sa, za, sb, zb, bias, so, zo, out, M, N, K, qmin, qmax, a_vec, b_vec);
  return static_cast<int>(cudaGetLastError());
}

template <int ACT>
int launch_out(int out_dtype, const int8_t* a, const int8_t* b, const float* sa,
               const float* za, const float* sb, const float* zb, const float* bias,
               const float* so, const float* zo, void* out, int M, int N, int K, int qmin,
               int qmax, cudaStream_t st) {
  switch (out_dtype) {
    case kOutF32:
      return launch<ACT, kOutF32>(a, b, sa, za, sb, zb, bias, so, zo, out, M, N, K, qmin, qmax, st);
    case kOutI8:
      return launch<ACT, kOutI8>(a, b, sa, za, sb, zb, bias, so, zo, out, M, N, K, qmin, qmax, st);
    case kOutU8:
      return launch<ACT, kOutU8>(a, b, sa, za, sb, zb, bias, so, zo, out, M, N, K, qmin, qmax, st);
    case kOutI16:
      return launch<ACT, kOutI16>(a, b, sa, za, sb, zb, bias, so, zo, out, M, N, K, qmin, qmax, st);
    default:
      return -1;
  }
}

}  // namespace

// act: 0 none, 1 relu, 2 gelu (tanh), 3 silu.  out_dtype: 0 f32, 1 int8,
// 2 uint8, 3 int16 (the last three requantize; so / zo are then read).
// Returns 0 on success, a cudaError_t code after a failed launch, or -1 for
// arguments the kernel does not take (checked again by the Python wrapper).
extern "C" int int8_matmul_launch(const void* a, const void* b, const void* sa,
                                  const void* za, const void* sb, const void* zb,
                                  const void* bias, const void* so, const void* zo,
                                  void* out, int M, int N, int K, int act, int out_dtype,
                                  int qmin, int qmax, void* stream) {
  if (M < 0 || N < 0 || K < 0) return -1;
  if (out_dtype != kOutF32 && (so == nullptr || zo == nullptr)) return -1;
  if (M == 0 || N == 0) return 0;
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(b);
  const float* f[7] = {static_cast<const float*>(sa), static_cast<const float*>(za),
                       static_cast<const float*>(sb), static_cast<const float*>(zb),
                       static_cast<const float*>(bias), static_cast<const float*>(so),
                       static_cast<const float*>(zo)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kActNone:
      return launch_out<kActNone>(out_dtype, A, B, f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                                  out, M, N, K, qmin, qmax, st);
    case kActRelu:
      return launch_out<kActRelu>(out_dtype, A, B, f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                                  out, M, N, K, qmin, qmax, st);
    case kActGelu:
      return launch_out<kActGelu>(out_dtype, A, B, f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                                  out, M, N, K, qmin, qmax, st);
    case kActSilu:
      return launch_out<kActSilu>(out_dtype, A, B, f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                                  out, M, N, K, qmin, qmax, st);
    default:
      return -1;
  }
}
