// Fused INT8 GEMM for M > 32 on Hopper (sm_90a): `wgmma` s8 over a TMA /
// `mbarrier` ring with a producer warp, on a weight packed once K-major.
// The third kernel of the function of int8_matmul.cu, and the pack kernel
// that lays its weight out.
//
// Replaces the TPU Pallas kernel `int8_matmul_pallas` of
// src/repro/kernels/int8_matmul.py (body `_kernel`) at prefill-sized M:
// int8 A [M, K] times int8 B [K, N] into an exact int32 accumulator, then
// the epilogue every kernel of the function shares (`store_output`,
// int8_epilogue.cuh), so the three kernels agree bit for bit.
//
// What bounds it on an H100: at M = 512 the int8 tensor-core operations
// (2 M K N at 1,979 TOP/s); the legacy `mma.sync` of the tiled kernel runs
// well under that rate, and only `wgmma` reaches it.
//
// `int8_matmul_wgmma_kernel<ACT, OUT, BN>`:
//   * B is read from the packed copy `nk` [N, K] (K contiguous): 8-bit
//     `wgmma` reads both operands K-major from shared memory only, so the
//     weight is transposed once (`int8_pack_weight_kernel`), not per call;
//   * a CTA owns 128 x BN output tiles (BN 128 or 192).  Each ring stage
//     holds the tile's 128 rows of A and BN rows of B over 128 bytes of K,
//     exactly one 128-byte swizzle row, loaded by TMA
//     (`cp.async.bulk.tensor.2d`, CU_TENSOR_MAP_SWIZZLE_128B) into
//     1024-byte aligned slots; TMA zero-fills outside [M, K] and [N, K],
//     which is exact because the za * zb * K term uses the true K;
//   * warp specialisation: warpgroup 0 gives up its registers
//     (`setmaxnreg.dec`) and one thread of it issues every copy, waiting
//     on the stage's empty barrier and arming its full barrier with the
//     stage's bytes; warpgroups 1 and 2 (`setmaxnreg.inc`) each own 64 rows
//     of the tile and run `wgmma.mma_async.m64n(BN+16)k32.s32.s8.s8` on
//     descriptors into the swizzled slots, four k32 steps a stage (the
//     descriptor's start address advances by 32 bytes a step), keep one
//     stage's products in flight and release the stage before it through
//     its empty barrier once `wgmma.wait_group 1` shows them done;
//   * rowsum(A) on the tensor cores: each slot's B tile is followed by 16
//     rows of ones, written once at the start and never touched by TMA, so
//     the product's last 16 columns are the exact int32 rowsum of the A
//     tile, already in the registers of the thread that owns the row.
//     colsum(B) is the packed weight's, summed once at packing;
//   * a persistent grid (`grid` CTAs walk the tiles, M fastest, so the
//     CTAs that share a B tile run at once) or one CTA per tile, as the
//     plan says; the ring runs on across tiles, so one tile's epilogue
//     overlaps the next tile's copies;
//   * the epilogue runs on the accumulator registers in `wgmma`'s fragment
//     layout: thread t of warp w owns rows 16 w + t / 4 and + 8, and column
//     pairs 8 j + 2 (t % 4), stored as pairs.  The tile's column
//     parameters (colsum, sb, zb, bias) are loaded before its K loop and
//     handed round the warpgroup through shared memory after it, so the
//     epilogue waits on no global load: loaded between output stores that
//     may alias them, they would be serialized.
// The tensor maps are encoded on the host for every call
// (`cuTensorMapEncodeTiled`, reached through cudaGetDriverEntryPoint, so
// nothing links libcuda) and passed as `__grid_constant__` parameters.
//
// `int8_pack_weight_kernel`: w [K, N] -> nk [N, K] and colsum [N] in one
// pass.  A warp moves a 256 (K) x 32 (N) block: a lane loads 16 rows of 16
// columns, transposes the 16 x 16 bytes in registers (4 x 4 byte
// transposes), stores 16 K-contiguous rows of nk and sums each column with
// __dp4a; a CTA of 8 warps walks K for one 32-column strip, so colsum is
// written once, without atomics.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//         -Xcompiler -fPIC -o libint8_matmul_sm90.so int8_matmul_sm90.cu
// The plain C entry points return cudaGetLastError() after the launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_epilogue.cuh"

namespace {

constexpr int kWgBM = 128;       // output rows per tile: 64 per consumer warpgroup
constexpr int kWgBK = 128;       // K bytes per ring stage: one 128-byte swizzle row
constexpr int kWgOnes = 16;      // rows of ones after each stage's B tile
constexpr int kWgThreads = 384;  // the producer warpgroup and two consumers
constexpr int kWgMaxGrid = 1 << 20;

template <int BN>
struct WgCfg {
  static constexpr int kN = BN + kWgOnes;            // the wgmma's N
  static constexpr int kABytes = kWgBM * kWgBK;      // A slot, then the B slot
  static constexpr int kStageBytes = kABytes + kN * kWgBK;
  static constexpr int kStages = BN == 128 ? 6 : 5;  // ring slots
  static constexpr int kTx = (kWgBM + BN) * kWgBK;   // bytes TMA lands per stage
  static constexpr int kParams = 16 * BN;            // a tile's colsum, sb, zb, bias
  // 1024 bytes to align the ring, the ring, a full and an empty barrier a
  // slot, each consumer warpgroup's copy of its tile's column parameters
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kStages + 2 * kParams;
  static constexpr int kAcc = kN / 2;                // int32 accumulators a thread
};
static_assert(WgCfg<128>::kSmem <= kMaxSmem && WgCfg<192>::kSmem <= kMaxSmem,
              "the ring fits in a CTA's shared memory");
static_assert(WgCfg<128>::kStageBytes % 1024 == 0 && WgCfg<192>::kStageBytes % 1024 == 0,
              "every slot is aligned to the 1024-byte swizzle atom");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// TMA: the box at (c0 along K, c1 along rows) of `tm` into shared memory
// at `dst`, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* tm, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor of a K-major tile in 128-byte swizzled
// rows: start address >> 4, leading byte offset 1 (unused when K fits one
// swizzle row), stride byte offset 1024 >> 4 (from one 8-row atom to the
// next), layout type 1 (SWIZZLE_128B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// a barrier of the 128 threads of one warpgroup (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// d (64 x N int32 in the fragment layout) += A (64 x 32, K-major) * B^T
// (N x 32, K-major), both read from shared memory through descriptors
__device__ __forceinline__ void wgmma_m64n144k32(int (&d)[72], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71}, "
      "%72, %73, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n208k32(int (&d)[104], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103}, "
      "%104, %105, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103])
      : "l"(da), "l"(db), "r"(1));
}

template <int NW>
__device__ __forceinline__ void wgmma_s8(int (&d)[NW / 2], uint64_t da, uint64_t db) {
  if constexpr (NW == 144) wgmma_m64n144k32(d, da, db);
  if constexpr (NW == 208) wgmma_m64n208k32(d, da, db);
}

struct WgArgs {
  const int* colsum;  // [N] exact int32 colsum(B), from the packed weight
  const float* sa;    // () activation scale
  const float* za;    // () activation zero point
  const float* sb;    // [N] weight scales
  const float* zb;    // [N] weight zero points
  const float* bias;  // [N] or null
  const float* so;    // () output scale (requant)
  const float* zo;    // () output zero point
  void* out;          // [M, N]
  int M, N, K, qmin, qmax;
};

template <int ACT, int OUT, int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,  // A [M, K]
                         const __grid_constant__ CUtensorMap tm_b,  // nk [N, K]
                         const WgArgs p) {
  using C = WgCfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* ring_p = smem_raw + (ring - raw);
  // full barrier of slot s at bars + 8 s, its empty barrier at bars + 8 (kStages + s)
  const uint32_t bars = ring + C::kStages * C::kStageBytes;
  const int tid = threadIdx.x;
  const int mt = (p.M + kWgBM - 1) / kWgBM;
  const int tiles = mt * ((p.N + BN - 1) / BN);
  const int nkb = (p.K + kWgBK - 1) / kWgBK;

  // the rows of ones after every slot's B tile
  constexpr int kOnesChunks = kWgOnes * kWgBK / 16;
  for (int i = tid; i < C::kStages * kOnesChunks; i += kWgThreads) {
    uint8_t* dst = ring_p + (i / kOnesChunks) * C::kStageBytes + C::kABytes + BN * kWgBK +
                   (i % kOnesChunks) * 16;
    *reinterpret_cast<int4*>(dst) = make_int4(kOnes, kOnes, kOnes, kOnes);
  }
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                  // the producer's arrive + TMA bytes
      mbar_init(bars + 8 * (C::kStages + s), 2);   // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the ones, for wgmma
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid != 0) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_a)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_b)) : "memory");
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % mt) * kWgBM, n0 = (t / mt) * BN;
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(bars + 8 * (C::kStages + stage), phase ^ 1u);  // the slot is free
        const uint32_t full = bars + 8 * stage;
        const uint32_t slot = ring + stage * C::kStageBytes;
        mbar_expect_tx(full, C::kTx);
        tma_load_2d(slot, &tm_a, kb * kWgBK, m0, full);
        tma_load_2d(slot + C::kABytes, &tm_b, kb * kWgBK, n0, full);
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // consumer warpgroups: warpgroup c owns tile rows 64 c .. 64 c + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int lt = tid % 128;
  const int c = tid / 128 - 1;
  const int lane = tid % 32;
  const int row = 64 * c + 16 * (lt / 32) + lane / 4;  // its rows: row and row + 8
  const int col = 2 * (lane % 4);                        // its columns: 8 j + col, + 1
  // this warpgroup's copy of the tile's colsum, sb, zb, bias [BN] each
  int* pcs = reinterpret_cast<int*>(ring_p + C::kStages * C::kStageBytes + 16 * C::kStages +
                                    c * C::kParams);
  float* psb = reinterpret_cast<float*>(pcs + BN);
  float* pzb = psb + BN;
  float* pbias = pzb + BN;
  constexpr int kPer = (BN + 127) / 128;  // columns a thread fetches
  const Epilogue e = load_epilogue<OUT>(p.sa, p.za, p.bias, p.so, p.zo, p.out, p.K, p.qmin,
                                        p.qmax);
  const bool pairs = (p.N & 1) == 0;  // two adjacent outputs in one store
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % mt) * kWgBM, n0 = (t / mt) * BN;
    // the tile's column parameters, loaded now and used after the K loop
    int fcs[kPer];
    float fsb[kPer], fzb[kPer], fbias[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int gc = n0 + lt + 128 * r;
      const bool in = lt + 128 * r < BN && gc < p.N;
      fcs[r] = in ? p.colsum[gc] : 0;
      fsb[r] = in ? p.sb[gc] : 0.f;
      fzb[r] = in ? p.zb[gc] : 0.f;
      fbias[r] = in && p.bias != nullptr ? p.bias[gc] : 0.f;
    }
    int acc[C::kAcc];
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = 0;
    int prev = 0;
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(bars + 8 * stage, phase);  // the slot has landed
      const uint32_t slot = ring + stage * C::kStageBytes;
      const uint64_t da = make_desc(slot + c * 64 * kWgBK);
      const uint64_t db = make_desc(slot + C::kABytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWgBK / 32; ++ks) wgmma_s8<C::kN>(acc, da + 2 * ks, db + 2 * ks);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: free its slot
      if (kb > 0 && lt == 0) mbar_arrive(bars + 8 * (C::kStages + prev));
      prev = stage;
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();
    if (lt == 0) mbar_arrive(bars + 8 * (C::kStages + prev));

    warpgroup_sync(1 + c);  // the previous tile's epilogue is done with the copy
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = lt + 128 * r;
      if (i < BN) {
        pcs[i] = fcs[r];
        psb[i] = fsb[r];
        pzb[i] = fzb[r];
        pbias[i] = fbias[r];
      }
    }
    warpgroup_sync(1 + c);

    // the ones columns (j = BN / 8) hold rowsum(A) of this thread's rows
    const int rs[2] = {acc[BN / 2], acc[BN / 2 + 2]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c0 = 8 * j + col;  // tile columns c0, c0 + 1
      const int gc = n0 + c0;
      if (gc >= p.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = m0 + row + 8 * h;
        if (gr >= p.M) continue;
        const size_t idx = static_cast<size_t>(gr) * p.N + gc;
        const float v0 = epilogue_value<ACT, OUT>(e, acc[4 * j + 2 * h], pcs[c0], rs[h],
                                                  psb[c0], pzb[c0], pbias[c0]);
        if (gc + 1 < p.N) {
          const float v1 = epilogue_value<ACT, OUT>(e, acc[4 * j + 2 * h + 1], pcs[c0 + 1],
                                                    rs[h], psb[c0 + 1], pzb[c0 + 1],
                                                    pbias[c0 + 1]);
          if (pairs) {
            put2<OUT>(e, idx, v0, v1);
          } else {
            put<OUT>(e, idx, v0);
            put<OUT>(e, idx + 1, v1);
          }
        } else {
          put<OUT>(e, idx, v0);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Packing: w [K, N] -> nk [N, K] and colsum [N], one pass
// ---------------------------------------------------------------------------

constexpr int kPkN = 32;       // columns of a CTA's strip
constexpr int kPkWarps = 8;
constexpr int kPkK = 256;      // K rows of one warp step: 16 lane pairs x 16 rows

__global__ void __launch_bounds__(kPkWarps * 32)
int8_pack_weight_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ nk,
                        int* __restrict__ colsum, int K, int N, bool vec) {
  __shared__ int part[kPkWarps][kPkN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = lane & 1;           // this lane's 16 columns: n0 .. n0 + 15
  const int kq = lane >> 1;         // its 16 rows of the step: 16 kq ..
  const int n0 = blockIdx.x * kPkN + 16 * h;
  int cs[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) cs[i] = 0;

  for (int kbase = warp * kPkK; kbase < K; kbase += kPkWarps * kPkK) {
    const int k0 = kbase + 16 * kq;
    unsigned v[16][4];  // rows k0 .. k0 + 15, four column words each
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int k = k0 + r;
      if (vec) {
        uint4 x = make_uint4(0, 0, 0, 0);
        if (k < K && n0 < N)
          x = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(k) * N + n0);
        v[r][0] = x.x;
        v[r][1] = x.y;
        v[r][2] = x.z;
        v[r][3] = x.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[r][q] = 0;
        if (k < K)
#pragma unroll
          for (int b = 0; b < 16; ++b)
            if (n0 + b < N)
              v[r][b >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(
                                  w[static_cast<size_t>(k) * N + n0 + b]))
                              << (8 * (b & 3));
      }
    }
    // t[n][R]: column n0 + n's bytes of rows k0 + 4R .. + 3
    unsigned t[16][4];
#pragma unroll
    for (int R = 0; R < 4; ++R)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned col[4];
        transpose4x4(v[4 * R][q], v[4 * R + 1][q], v[4 * R + 2][q], v[4 * R + 3][q], col);
#pragma unroll
        for (int e = 0; e < 4; ++e) t[4 * q + e][R] = col[e];
      }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int R = 0; R < 4; ++R) cs[n] = __dp4a(static_cast<int>(t[n][R]), kOnes, cs[n]);
      if (n0 + n >= N) continue;
      int8_t* dst = nk + static_cast<size_t>(n0 + n) * K + k0;
      if (vec) {
        if (k0 < K) *reinterpret_cast<uint4*>(dst) = make_uint4(t[n][0], t[n][1], t[n][2], t[n][3]);
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (k0 + b < K) dst[b] = static_cast<int8_t>((t[n][b >> 2] >> (8 * (b & 3))) & 0xff);
      }
    }
  }
  // add the 16 lane pairs of the warp, then the warps
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int o = 2; o < 32; o <<= 1) cs[n] += __shfl_xor_sync(0xffffffffu, cs[n], o);
  if (kq == 0)
#pragma unroll
    for (int n = 0; n < 16; ++n) part[warp][16 * h + n] = cs[n];
  __syncthreads();
  if (threadIdx.x < kPkN) {
    const int n = blockIdx.x * kPkN + threadIdx.x;
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kPkWarps; ++i) sum += part[i][threadIdx.x];
    if (n < N) colsum[n] = sum;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// The tensor map of a row-major int8 [rows, K] matrix (K % 16 == 0, the
// base 16-byte aligned), boxes of box_rows x 128 bytes, 128-byte swizzle,
// zero fill outside; 0 on success
int encode_kmajor(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kWgBK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int ACT, int OUT, int BN>
int launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb, const WgArgs& p, int grid,
                 cudaStream_t st) {
  auto kernel = int8_matmul_wgmma_kernel<ACT, OUT, BN>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WgCfg<BN>::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  kernel<<<grid, kWgThreads, WgCfg<BN>::kSmem, st>>>(ta, tb, p);
  return static_cast<int>(cudaGetLastError());
}

template <int ACT, int OUT>
int launch_wgmma_bn(int bn, const CUtensorMap& ta, const CUtensorMap& tb, const WgArgs& p,
                    int grid, cudaStream_t st) {
  return bn == 128 ? launch_wgmma<ACT, OUT, 128>(ta, tb, p, grid, st)
                   : launch_wgmma<ACT, OUT, 192>(ta, tb, p, grid, st);
}

template <int ACT>
int launch_wgmma_out(int out_dtype, int bn, const CUtensorMap& ta, const CUtensorMap& tb,
                     const WgArgs& p, int grid, cudaStream_t st) {
  switch (out_dtype) {
    case kOutF32: return launch_wgmma_bn<ACT, kOutF32>(bn, ta, tb, p, grid, st);
    case kOutI8: return launch_wgmma_bn<ACT, kOutI8>(bn, ta, tb, p, grid, st);
    case kOutU8: return launch_wgmma_bn<ACT, kOutU8>(bn, ta, tb, p, grid, st);
    case kOutI16: return launch_wgmma_bn<ACT, kOutI16>(bn, ta, tb, p, grid, st);
    default: return -1;
  }
}

}  // namespace

// The wgmma kernel: int8 a [M, K] and the packed weight b_nk [N, K] with
// its int32 colsum [N]; the rest as int8_matmul_launch of int8_matmul.cu
// (act: 0 none, 1 relu, 2 gelu (tanh), 3 silu; out_dtype: 0 f32, 1 int8,
// 2 uint8, 3 int16).  bn: 128 or 192 output columns a tile; grid: the
// CTAs that walk the ceil(M / 128) x ceil(N / bn) tiles.  Needs K a
// multiple of 16 and both bases 16-byte aligned (TMA's rules).  Returns
// 0 on success, a cudaError_t code after a failed launch, -1 for
// arguments the kernel does not take, -2 / -3 when the tensor maps could
// not be made.
extern "C" int int8_matmul_wgmma_launch(const void* a, const void* b_nk, const void* colsum,
                                        const void* sa, const void* za, const void* sb,
                                        const void* zb, const void* bias, const void* so,
                                        const void* zo, void* out, int M, int N, int K,
                                        int act, int out_dtype, int qmin, int qmax, int bn,
                                        int grid, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0) return -1;
  if ((reinterpret_cast<uintptr_t>(a) & 15) || (reinterpret_cast<uintptr_t>(b_nk) & 15)) return -1;
  if (bn != 128 && bn != 192) return -1;
  if (grid < 1 || grid > kWgMaxGrid) return -1;
  if (out_dtype != kOutF32 && (so == nullptr || zo == nullptr)) return -1;
  CUtensorMap ta, tb;
  int rc = encode_kmajor(&ta, a, M, K, kWgBM);
  if (rc == 0) rc = encode_kmajor(&tb, b_nk, N, K, bn);
  if (rc != 0) return rc;
  WgArgs p;
  p.colsum = static_cast<const int*>(colsum);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case kActNone: return launch_wgmma_out<kActNone>(out_dtype, bn, ta, tb, p, grid, st);
    case kActRelu: return launch_wgmma_out<kActRelu>(out_dtype, bn, ta, tb, p, grid, st);
    case kActGelu: return launch_wgmma_out<kActGelu>(out_dtype, bn, ta, tb, p, grid, st);
    case kActSilu: return launch_wgmma_out<kActSilu>(out_dtype, bn, ta, tb, p, grid, st);
    default: return -1;
  }
}

// Bytes of dynamic shared memory a wgmma CTA takes at tile width bn.
extern "C" int int8_matmul_wgmma_smem_bytes(int bn) {
  return bn == 128 ? WgCfg<128>::kSmem : bn == 192 ? WgCfg<192>::kSmem : -1;
}

// The pack kernel: int8 w [K, N] -> nk [N, K] and int32 colsum [N]; one
// launch of ceil(N / 32) CTAs.  Same return codes.
extern "C" int int8_pack_weight_launch(const void* w, void* nk, void* colsum, int K, int N,
                                       void* stream) {
  if (K < 1 || N < 1) return -1;
  const bool vec = K % 16 == 0 && N % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(nk) & 15) == 0;
  const int grid = (N + kPkN - 1) / kPkN;
  int8_pack_weight_kernel<<<grid, kPkWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<int8_t*>(nk), static_cast<int*>(colsum), K, N,
      vec);
  return static_cast<int>(cudaGetLastError());
}
