// Fused INT8 GEMM with a dequant -> activation -> requant epilogue, for
// Hopper (sm_90a): two of the three kernels of one function, chosen by
// shape (the third, for M > 32, is in int8_matmul_sm90.cu).
//
// Replaces the TPU Pallas kernel `int8_matmul_pallas` of
// src/repro/kernels/int8_matmul.py (body `_kernel`): the paper's on-device
// layer (section 2.1, steps 1-4).  int8 A [M, K] (K contiguous) times int8
// B [K, N] (N contiguous) into an int32 accumulator, with int32 rowsum(A)
// and colsum(B) accumulated in the same K loop; the epilogue computes, in
// f32 and in the reference's order of operations, the dequantization,
// bias, activation and optional requantization of `store_output`
// (int8_epilogue.cuh).  Both kernels here and the wgmma kernel of
// int8_matmul_sm90.cu run that one epilogue on exact int32 sums, so they
// agree bit for bit.
//
// What bounds it on an H100: at decode (M <= 32) the bytes of B, one pass
// over the weight matrix (45 MB at 4096 x 11008); at prefill (M = 512) the
// int8 tensor-core operations.
//
// `int8_matmul_kernel` (the first design, any M; the front door's kernel
// above the small-M threshold where the wgmma kernel does not take the
// shape: K not a multiple of 16, or an unaligned base):
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
// At M = 4 its grid is one row of 64-column CTAs (64 CTAs on 132 SMs at
// N = 4096), each walking all of K with one tile in flight.
//
// `int8_matmul_splitk_kernel` (small M, up to 32 rows; the front door's
// kernel there), for the bytes of B:
//   * split K over a thread-block cluster: a cluster of up to 8 CTAs (the
//     portable size) owns one 64-column tile for all M rows, each CTA a
//     contiguous K slice; the plan (Python, from shapes) sizes the grid
//     to about one CTA per SM with K split at least in two: N = 4096
//     gives 64 tiles x 2 = 128 CTAs;
//   * an asynchronous copy ring: 4 stages of 128 x 64 B bytes (8 KB) per
//     CTA in dynamic shared memory, 16-byte `cp.async.cg` copies
//     (zero-filled outside [K, N]) committed per stage and waited with
//     `cp.async.wait_group`; the depth and the slot index are
//     compile-time, since the K loop's per-stage instructions sit on the
//     critical path (on an H100 a run-time depth cost 13-39 %, and 8
//     stages were no faster than 4);
//   * A rides in the same ring: each slot holds the stage's M rows of A
//     (M x 128 bytes, each A byte copied once per CTA) beside its B tile,
//     so no up-front load of A delays the first stage, and shared memory
//     does not grow with K;
//   * each warp takes one k32 step of a stage over all 64 columns:
//     `mma.sync.m16n8k32` with M <= 16 rows in one 16-row fragment (two for
//     M <= 32), rows past M zero.  B fragments come from the ring's
//     N-major rows: a lane reads 8 bytes (8 columns) of 4 consecutive rows
//     and applies the 4 x 4 byte transposes in registers, so its 8 column
//     words feed 8 MMAs (MMA e's B column g is tile column 8 g + e).  The
//     ring's 16-byte chunks are XOR-swizzled so those 8-byte reads are free
//     of bank conflicts;
//   * the warps' partials (int32 accumulators, colsum, rowsum) are summed
//     in shared memory, then, after `cluster.sync()`, rank 0 adds its
//     peers' through distributed shared memory (`map_shared_rank`) and runs
//     the epilogue.  The sums are exact integers, so the order of the merge
//     changes no bit; no global workspace, counter or memset.
// Inputs with K or N not a multiple of 16 (or unaligned) take predicated
// byte loads in place of `cp.async`, written to the same ring.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//         -Xcompiler -fPIC -o libint8_matmul.so int8_matmul.cu
// The plain C entry points return cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 64;           // output rows per CTA
constexpr int kBN = 64;           // output columns per CTA
constexpr int kBK = 128;          // K depth of one staged tile
constexpr int kThreads = 128;     // 4 warps, 2 x 2 over the tile
constexpr int kPitch = kBK + 16;  // bytes per shared row (A rows, B columns)
constexpr int kWords = kPitch / 4;
constexpr unsigned kFull = 0xffffffffu;

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
      unsigned col[4];
      transpose4x4(word(br[0], j), word(br[1], j), word(br[2], j), word(br[3], j), col);
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
        rsum = __dp4a(static_cast<int>(ra[i]), kOnes, rsum);
        csum = __dp4a(static_cast<int>(cb[i]), kOnes, csum);
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
  const Epilogue e = load_epilogue<OUT>(sa_p, za_p, bias, so_p, zo_p, out, K, qmin, qmax);
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
        store_output<ACT, OUT>(e, acc[mi][ni][i], cs_s[c], rs_s[r], sb[gc], zb[gc],
                               bias != nullptr ? bias[gc] : 0.f,
                               static_cast<size_t>(gr) * N + gc);
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

// ---------------------------------------------------------------------------
// Split-K kernel for small M: one cluster per 64-column tile, its CTAs over
// contiguous K slices, merged in distributed shared memory
// ---------------------------------------------------------------------------

constexpr int kSkBN = 64;                      // output columns per cluster
constexpr int kSkBK = 128;                     // K depth of one ring stage
constexpr int kSkThreads = 128;                // 4 warps, one k32 step of a stage each
constexpr int kSkWarps = kSkThreads / 32;
constexpr int kSkStages = 4;                   // ring slots: stages in flight
constexpr int kSkStageBytes = kSkBK * kSkBN;   // 8 KB of B per stage
constexpr int kSkApitch = kSkBK + 16;          // bytes per A row of a stage
constexpr int kSkMaxM = 32;                    // two 16-row fragments
constexpr int kSkMaxCluster = 8;               // the portable cluster size
static_assert(kSkBK == 32 * kSkWarps, "one k32 step per warp and stage");
static_assert(kSkThreads % kSkBN == 0, "a thread's output column is fixed");
static_assert((kSkStages & (kSkStages - 1)) == 0, "a power-of-two ring");

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Dynamic shared memory of one split-K CTA, in bytes from its start:
//   ring  min(kSkStages, slice_k / kSkBK) slots of `slot` bytes: a stage of B
//         (kSkBK rows x kSkBN bytes), then the stage's M rows of A
//         (kSkApitch bytes each: the pad puts the rows of one fragment load
//         in different banks); reused after the K loop for the warps'
//         partials: accumulators [kSkWarps][16 MF][kSkBN], colsums
//         [kSkWarps][kSkBN], rowsums [kSkWarps][kSkMaxM] (int32);
//   part  the CTA's partials over its slice: [M][kSkBN], colsums [kSkBN],
//         rowsums [kSkMaxM] -- what rank 0 reads through DSMEM;
//   tot   rank 0's cluster-wide colsums [kSkBN] and rowsums [kSkMaxM].
// `repro_torch.kernels.int8_matmul._splitk_smem_bytes` mirrors `total`.
struct SplitkSmem {
  int slot, part, tot, total;
  __host__ __device__ SplitkSmem(int M, int slice_k) {
    const int mf = M <= 16 ? 1 : 2;
    const int steps = slice_k / kSkBK;
    slot = kSkStageBytes + round16(M * kSkApitch);
    const int ring = (steps < kSkStages ? steps : kSkStages) * slot;
    const int staging = 4 * kSkWarps * (16 * mf * kSkBN + kSkBN + kSkMaxM);
    part = ring > staging ? ring : staging;
    tot = part + round16(4 * (M * kSkBN + kSkBN + kSkMaxM));
    total = tot + 4 * (kSkBN + kSkMaxM);
  }
};

// Byte offset of 16-byte chunk c (0..3) of row k in a ring stage (64-byte
// rows).  Rows 2j and 2j+1 share a 128-byte line; the chunk's place in the
// line, (k & 1) * 4 + c, is XORed with bits 2-3 of k, so the 16 lanes of a
// half-warp that read 8 bytes each from rows k0 + 4t + r (t = 0..3) at
// chunks c, c + 1 hit 16 distinct bank pairs.
__device__ __forceinline__ int ring_off(int k, int c) {
  return ((k >> 1) << 7) + (((((k & 1) << 2) | c) ^ (((k >> 2) & 3) << 1)) << 4);
}

// 16 bytes row[c0 .. c0 + 15]; bytes at or past `limit` read as 0
__device__ __forceinline__ uint4 load_row16(const int8_t* __restrict__ row, int c0,
                                            int limit) {
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (c0 + e < limit)
      w[e >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(row[c0 + e])) << (8 * (e & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16-byte asynchronous copy global -> shared; `full` false zero-fills the
// 16 bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct SplitkArgs {
  const int8_t* A;    // [M, K]
  const int8_t* B;    // [K, N]
  const float* sa;    // () activation scale
  const float* za;    // () activation zero point
  const float* sb;    // [N] weight scales
  const float* zb;    // [N] weight zero points
  const float* bias;  // [N] or null
  const float* so;    // () output scale (requant)
  const float* zo;    // () output zero point
  void* out;          // [M, N]
  int M, N, K, qmin, qmax;
  int cluster;        // CTAs of a cluster: K slices of one column tile
  int slice_k;        // K bytes per slice, a multiple of kSkBK
  bool a_vec, b_vec;  // 16-byte cp.async copies (K, N % 16 == 0, aligned bases)
};

template <int ACT, int OUT, int MF>
__global__ void __launch_bounds__(kSkThreads)
int8_matmul_splitk_kernel(const SplitkArgs p) {
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const SplitkSmem L(p.M, p.slice_k);
  uint8_t* ring = smem;
  int* part = reinterpret_cast<int*>(smem + L.part);  // [M][kSkBN]
  int* pcs = part + p.M * kSkBN;                      // [kSkBN]
  int* prs = pcs + kSkBN;                             // [kSkMaxM]

  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group id
  const int t = lane & 3;   // thread in group
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.y * kSkBN;
  const int kbeg = rank * p.slice_k;
  const int kend = min(kbeg + p.slice_k, K);
  const int nst = (kend - kbeg + kSkBK - 1) / kSkBK;

  // rank 0 runs the epilogue for one column per thread; its scalars and
  // that column's scale, zero point and bias load during the K loop
  const int ec = tid & (kSkBN - 1);
  const int egc = n0 + ec;
  Epilogue e{};
  float sbc = 0.f, zbc = 0.f, biasc = 0.f;
  if (rank == 0) {
    e = load_epilogue<OUT>(p.sa, p.za, p.bias, p.so, p.zo, p.out, K, p.qmin, p.qmax);
    if (egc < N) {
      sbc = p.sb[egc];
      zbc = p.zb[egc];
      if (p.bias != nullptr) biasc = p.bias[egc];
    }
  }

  // stage s of the slice (K rows kbeg + 128 s ..) into ring slot s % kSkStages:
  // B rows past kend and columns past N, A columns past kend read as 0.
  // A thread copies B chunk tid & 3 of rows tid / 4 + 32 i of each stage:
  // its source advances by 128 rows a stage, its destinations are fixed.
  constexpr int kChunks = kSkStageBytes / 16 / kSkThreads;  // B chunks a thread
  const int brow = tid >> 2;
  const int bgn = n0 + (tid & 3) * 16;
  const int8_t* bsrc = p.B + static_cast<size_t>(kbeg + brow) * N + bgn;
  const size_t bstep = static_cast<size_t>(32) * N;  // 32 rows
  int boff[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) boff[i] = ring_off(brow + 32 * i, tid & 3);
  auto fetch = [&](int s) {
    uint8_t* st = ring + (s & (kSkStages - 1)) * L.slot;
    const int k0 = kbeg + s * kSkBK;
    for (int q = tid; q < M * (kSkBK / 16); q += kSkThreads) {
      const int m = q / (kSkBK / 16);
      const int gk = k0 + (q % (kSkBK / 16)) * 16;
      uint8_t* dst = st + kSkStageBytes + m * kSkApitch + (gk - k0);
      const int8_t* row = p.A + static_cast<size_t>(m) * K;
      if (p.a_vec)
        cp_async16(dst, gk < kend ? row + gk : p.A, gk < kend);
      else
        *reinterpret_cast<uint4*>(dst) = load_row16(row, gk, kend);
    }
    const int8_t* src = bsrc + static_cast<size_t>(s) * (4 * bstep);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const bool row_in = k0 + brow + 32 * i < kend;
      const int8_t* row = src + i * bstep;
      if (p.b_vec)
        cp_async16(st + boff[i], row_in && bgn < N ? row : p.B, row_in && bgn < N);
      else
        *reinterpret_cast<uint4*>(st + boff[i]) =
            row_in ? load_row16(row - bgn, bgn, N) : make_uint4(0, 0, 0, 0);
    }
  };

  for (int s = 0; s < kSkStages - 1; ++s) {
    if (s < nst) fetch(s);
    cp_async_commit();
  }

  int acc[MF][8][4];
  int cs[8];
  int rs[MF][2];
#pragma unroll
  for (int e8 = 0; e8 < 8; ++e8) {
    cs[e8] = 0;
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mf][e8][i] = 0;
  }
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) rs[mf][0] = rs[mf][1] = 0;

  const int kr = warp * 32;  // this warp's k32 step within a stage
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kSkStages - 2>();  // stage s has landed (this thread's copies)
    __syncthreads();                 // ... and every thread's; slot s - 1 is free
    if (s + kSkStages - 1 < nst) fetch(s + kSkStages - 1);
    cp_async_commit();               // one group per iteration, empty or not

    // B: 8 bytes (columns 8g .. 8g+7) of rows kr + 4t + r and kr + 16 + 4t + r
    const uint8_t* st = ring + (s & (kSkStages - 1)) * L.slot;
    uint2 v[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      v[r] = *reinterpret_cast<const uint2*>(st + ring_off(kr + 4 * t + r, g >> 1) + (g & 1) * 8);
      v[4 + r] = *reinterpret_cast<const uint2*>(st + ring_off(kr + 16 + 4 * t + r, g >> 1) +
                                                 (g & 1) * 8);
    }
    // bq[h][e]: K bytes 16h + 4t .. +3 of the step, of tile column 8g + e
    unsigned bq[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      transpose4x4(v[4 * h].x, v[4 * h + 1].x, v[4 * h + 2].x, v[4 * h + 3].x, bq[h]);
      transpose4x4(v[4 * h].y, v[4 * h + 1].y, v[4 * h + 2].y, v[4 * h + 3].y, bq[h] + 4);
    }
#pragma unroll
    for (int e8 = 0; e8 < 8; ++e8) {
      cs[e8] = __dp4a(static_cast<int>(bq[0][e8]), kOnes, cs[e8]);
      cs[e8] = __dp4a(static_cast<int>(bq[1][e8]), kOnes, cs[e8]);
    }

    // A: rows g and g + 8 of each 16-row fragment (0 past M), K bytes 4t
    // and 16 + 4t of the step
    const uint8_t* arow = st + kSkStageBytes + kr + 4 * t;
    unsigned af[MF][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      const int r0 = mf * 16 + g, r1 = r0 + 8;
      const uint8_t* p0 = arow + r0 * kSkApitch;
      const uint8_t* p1 = arow + r1 * kSkApitch;
      af[mf][0] = r0 < M ? *reinterpret_cast<const unsigned*>(p0) : 0u;
      af[mf][1] = r1 < M ? *reinterpret_cast<const unsigned*>(p1) : 0u;
      af[mf][2] = r0 < M ? *reinterpret_cast<const unsigned*>(p0 + 16) : 0u;
      af[mf][3] = r1 < M ? *reinterpret_cast<const unsigned*>(p1 + 16) : 0u;
      rs[mf][0] = __dp4a(static_cast<int>(af[mf][0]), kOnes, rs[mf][0]);
      rs[mf][0] = __dp4a(static_cast<int>(af[mf][2]), kOnes, rs[mf][0]);
      rs[mf][1] = __dp4a(static_cast<int>(af[mf][1]), kOnes, rs[mf][1]);
      rs[mf][1] = __dp4a(static_cast<int>(af[mf][3]), kOnes, rs[mf][1]);
    }
    // MMA e8 takes column word e8 of every lane group: its B column g is
    // tile column 8g + e8
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int e8 = 0; e8 < 8; ++e8) {
        const unsigned b[2] = {bq[0][e8], bq[1][e8]};
        mma_s8(acc[mf][e8], af[mf], b);
      }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the warps' partials

  int* wpart = reinterpret_cast<int*>(ring);     // [kSkWarps][16 MF][kSkBN]
  int* wcs = wpart + kSkWarps * 16 * MF * kSkBN;  // [kSkWarps][kSkBN]
  int* wrs = wcs + kSkWarps * kSkBN;              // [kSkWarps][kSkMaxM]
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int e8 = 0; e8 < 8; ++e8)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // the C fragment's column 2t + (i & 1) of MMA e8 is tile column
        // 8 (2t + (i & 1)) + e8
        const int r = mf * 16 + g + (i >> 1) * 8;
        const int c = 8 * (2 * t + (i & 1)) + e8;
        if (r < M) wpart[(warp * 16 * MF + r) * kSkBN + c] = acc[mf][e8][i];
      }
#pragma unroll
  for (int e8 = 0; e8 < 8; ++e8) {
    cs[e8] += __shfl_xor_sync(kFull, cs[e8], 1);
    cs[e8] += __shfl_xor_sync(kFull, cs[e8], 2);
    if (t == 0) wcs[warp * kSkBN + 8 * g + e8] = cs[e8];
  }
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[mf][h] += __shfl_xor_sync(kFull, rs[mf][h], 1);
      rs[mf][h] += __shfl_xor_sync(kFull, rs[mf][h], 2);
    }
  if (t == 0) {
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
      wrs[warp * kSkMaxM + mf * 16 + g] = rs[mf][0];
      wrs[warp * kSkMaxM + mf * 16 + g + 8] = rs[mf][1];
    }
  }
  __syncthreads();

  // this CTA's partials over its slice, where rank 0 reads them
  for (int idx = tid; idx < M * kSkBN; idx += kSkThreads) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kSkWarps; ++w) sum += wpart[w * 16 * MF * kSkBN + idx];
    part[idx] = sum;
  }
  if (tid < kSkBN) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kSkWarps; ++w) sum += wcs[w * kSkBN + tid];
    pcs[tid] = sum;
  } else if (tid < kSkBN + M) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kSkWarps; ++w) sum += wrs[w * kSkMaxM + tid - kSkBN];
    prs[tid - kSkBN] = sum;
  }
  cluster.sync();  // every CTA's partials are written and visible

  // rank 0 adds the cluster's partials (exact int32 sums, any order)
  constexpr int kPer = 16 * MF * kSkBN / kSkThreads;  // elements a thread
  int tot[kPer];
  int* tcs = reinterpret_cast<int*>(smem + L.tot);  // [kSkBN]
  int* trs = tcs + kSkBN;                           // [kSkMaxM]
  if (rank == 0) {
    const int n_ranks = static_cast<int>(cluster.num_blocks());
#pragma unroll
    for (int j = 0; j < kPer; ++j) tot[j] = 0;
    int side = 0;
    for (int r = 0; r < n_ranks; ++r) {
      const int* pr = cluster.map_shared_rank(part, r);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int idx = tid + j * kSkThreads;
        if (idx < M * kSkBN) tot[j] += pr[idx];
      }
      if (tid < kSkBN)
        side += cluster.map_shared_rank(pcs, r)[tid];
      else if (tid < kSkBN + M)
        side += cluster.map_shared_rank(prs, r)[tid - kSkBN];
    }
    if (tid < kSkBN)
      tcs[tid] = side;
    else if (tid < kSkBN + M)
      trs[tid - kSkBN] = side;
  }
  cluster.sync();  // rank 0 has read its peers' shared memory: they may exit
  if (rank != 0 || egc >= N) return;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int idx = tid + j * kSkThreads;
    if (idx >= M * kSkBN) break;
    const int m = idx / kSkBN;
    store_output<ACT, OUT>(e, tot[j], tcs[ec], trs[m], sbc, zbc, biasc,
                           static_cast<size_t>(m) * N + egc);
  }
}

template <int ACT, int OUT, int MF>
int launch_splitk(const SplitkArgs& p, cudaStream_t stream) {
  const SplitkSmem L(p.M, p.slice_k);
  if (L.total > kMaxSmem) return -1;
  auto kernel = int8_matmul_splitk_kernel<ACT, OUT, MF>;
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, (p.N + kSkBN - 1) / kSkBN, 1);
  cfg.blockDim = dim3(kSkThreads, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

template <int ACT, int OUT>
int launch_splitk_mf(const SplitkArgs& p, cudaStream_t st) {
  return p.M <= 16 ? launch_splitk<ACT, OUT, 1>(p, st) : launch_splitk<ACT, OUT, 2>(p, st);
}

template <int ACT>
int launch_splitk_out(int out_dtype, const SplitkArgs& p, cudaStream_t st) {
  switch (out_dtype) {
    case kOutF32: return launch_splitk_mf<ACT, kOutF32>(p, st);
    case kOutI8: return launch_splitk_mf<ACT, kOutI8>(p, st);
    case kOutU8: return launch_splitk_mf<ACT, kOutU8>(p, st);
    case kOutI16: return launch_splitk_mf<ACT, kOutI16>(p, st);
    default: return -1;
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

// The split-K kernel, with int8_matmul_launch's arguments and its plan:
// `cluster` CTAs (1..8) over K slices of `slice_k` bytes (a multiple of
// 128; every slice non-empty, together exactly K), 1 <= M <= 32.  Same
// return codes.
extern "C" int int8_matmul_splitk_launch(const void* a, const void* b, const void* sa,
                                         const void* za, const void* sb, const void* zb,
                                         const void* bias, const void* so, const void* zo,
                                         void* out, int M, int N, int K, int act,
                                         int out_dtype, int qmin, int qmax, int cluster,
                                         int slice_k, void* stream) {
  if (M < 1 || M > kSkMaxM || N < 1 || K < 1) return -1;
  if (cluster < 1 || cluster > kSkMaxCluster || slice_k < kSkBK || slice_k % kSkBK) return -1;
  if (static_cast<long long>(cluster) * slice_k < K ||
      static_cast<long long>(cluster - 1) * slice_k >= K)
    return -1;
  if ((N + kSkBN - 1) / kSkBN > 65535) return -1;
  if (out_dtype != kOutF32 && (so == nullptr || zo == nullptr)) return -1;
  SplitkArgs p;
  p.A = static_cast<const int8_t*>(a);
  p.B = static_cast<const int8_t*>(b);
  p.sa = static_cast<const float*>(sa);
  p.za = static_cast<const float*>(za);
  p.sb = static_cast<const float*>(sb);
  p.zb = static_cast<const float*>(zb);
  p.bias = static_cast<const float*>(bias);
  p.so = static_cast<const float*>(so);
  p.zo = static_cast<const float*>(zo);
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.qmin = qmin;
  p.qmax = qmax;
  p.cluster = cluster;
  p.slice_k = slice_k;
  p.a_vec = K % 16 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  p.b_vec = N % 16 == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kActNone: return launch_splitk_out<kActNone>(out_dtype, p, st);
    case kActRelu: return launch_splitk_out<kActRelu>(out_dtype, p, st);
    case kActGelu: return launch_splitk_out<kActGelu>(out_dtype, p, st);
    case kActSilu: return launch_splitk_out<kActSilu>(out_dtype, p, st);
    default: return -1;
  }
}

// Bytes of dynamic shared memory a split-K CTA takes at (M, slice_k).
extern "C" int int8_matmul_splitk_smem_bytes(int M, int slice_k) {
  return SplitkSmem(M, slice_k).total;
}

// How many clusters of the split-K kernel (f32 output, no activation) the
// card holds at once at (M, cluster, slice_k), from
// cudaOccupancyMaxActiveClusters; a negative cudaError_t on failure.
extern "C" int int8_matmul_splitk_max_clusters(int M, int N, int cluster, int slice_k) {
  const SplitkSmem L(M, slice_k);
  void (*kernel)(SplitkArgs) = M <= 16 ? &int8_matmul_splitk_kernel<kActNone, kOutF32, 1>
                                       : &int8_matmul_splitk_kernel<kActNone, kOutF32, 2>;
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (N + kSkBN - 1) / kSkBN, 1);
  cfg.blockDim = dim3(kSkThreads, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
