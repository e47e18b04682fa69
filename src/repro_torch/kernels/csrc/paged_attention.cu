// Paged flash attention over a block-table KV pool, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `paged_flash_mq` of
// src/repro/kernels/paged_attention.py (body `_kernel`, l.98-143; its
// pallas_call, l.213): flash attention of an S-query block over a paged KV
// pool whose K/V are dequantized by a per-(batch row, kv head) scale.  The
// S·group query rows of one kv head are stacked; row r sits at absolute
// position q_start[b] + r / group and attends positions p with p <= its
// position and p < lengths[b].  Online softmax at scale 1/sqrt(hd), masked
// logits = -1e30, weights re-masked to 0, output acc / max(l, 1e-30), so a
// row with no valid position gives exactly 0.
//
// What bounds it on an H100: the K/V bytes it must stream from device
// memory at 3.35 TB/s (1 B/elem for int8 pages, 2 for bf16).  At decode and
// verify (B = 4, S = 1..4) that is a few hundred KB, under a microsecond, so
// at short contexts the launch and each dependent memory round trip (length,
// block table, pages, partials) set the time; at long contexts the bytes do.
//
// Two kernels, chosen per call by n_rows = S * group:
//
// * n_rows <= 16 (decode, speculative verify, GQA decode): the split-KV
//   kernel `paged_flash_split_kernel` (flash decoding).
//   - Grid (n_kv, n_splits, B): heads fastest, so CTAs that start together
//     read neighbouring rows of the same pool positions (one position's
//     kv heads are contiguous in a page).  The host planner (`_plan_splits` in
//     kernels/paged_attention.py) picks from shapes alone a chunk of
//     positions (whole pages, >= 32) so the grid fills the card at short
//     spans and the chunk grows at long ones; it never reads lengths or
//     q_start to the host.  A CTA whose chunk lies past its rows' last
//     attendable position writes an empty partial (l = 0).
//   - Pages stream as raw bytes (int8, bf16 or f32) through a ring of 2-3
//     shared-memory stages of 32 positions with 16-byte cp.async.cg copies:
//     tile t + 2 (or t + 1) is in flight while tile t is consumed.  The
//     block-table entries of the chunk are staged once per page.  Rows are
//     padded to an odd number of 16-byte units, so the QK reads are
//     bank-conflict-free.  Rows not 16-byte aligned (hd 12 in int8 or bf16)
//     take plain loads.
//   - Dequantization is folded into scalars: q is scaled once by
//     sm_scale * k_scale, and the output once by v_scale.  A lane converts
//     each K/V element it reads once, for all of its warp's rows (int8 by a
//     byte permute into a float's mantissa, not the slower I2F).
//   - No idle warps.  With at most 4 rows (decode; verify at S 4; GQA
//     decode at group 4) every warp takes all the rows over its own 8
//     positions of each tile, and the 4 warps' partials are merged in
//     shared memory.  With more rows, rows go to warps round-robin (row r
//     -> warp r mod 4), a lane a position.  (At 4 rows, a row per warp
//     would have every warp convert the whole tile for its one row.)
//   - The merge of the splits is in the same launch: each CTA writes its
//     rows' (m, l, acc) to an f32 workspace and bumps an int32 counter of
//     its (b, kv head) with a release/acquire atomic; the CTA that arrives
//     last merges the splits in split order (bitwise-repeatable, no float atomics), writes
//     the output and puts the counter back to 0.  The counters are one
//     zeroed buffer per device: the port issues all its launches on one
//     stream per device (tensor-parallel shards on one card run one after
//     another), and two launches running at once on two streams of one
//     card would race on them.
// * n_rows > 16 (prefill): the tiled kernel `paged_flash_mq_kernel` of the
//   first port, unchanged, until its tensor-core redesign.  One CTA serves
//   up to 16 query rows of one (b, kv head) and walks the pages in series:
//   16-byte loads all issued before any is consumed, dequantized into
//   shared memory as f32; the page loop stops after the last position any
//   row of the CTA may attend (exact: a fully masked tile leaves m, l and
//   acc unchanged).  `paged_flash_mq_tiled_launch` runs it at any shape,
//   so the two designs can be timed and checked side by side.
//
// The same kernels are the per-shard launch of the tensor-parallel form
// (src/repro/kernels/paged_attention.py:304-375, a shard_map of the Pallas
// kernel over kv heads): each shard runs over its own contiguous pool
// [n_pages, page, n_kv / tp, hd] and scales [B, n_kv / tp], so a decode
// shard moves 1/tp of the bytes on a grid of (n_kv / tp, n_splits, B).
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//         -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
// The plain C entry points return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kTile = 32;                     // KV positions per tile: one per lane
constexpr float kMasked = -1e30f;             // finite stand-in for -inf
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Grid: (ceil(S*group / kRows), n_kv, B).  DPL = output dims per lane
// (ceil(hd / 32)); lane `lane` owns dims lane, lane + 32, ...
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_flash_mq_kernel(const float* __restrict__ q,        // [B, S, H, hd]
                      const T* __restrict__ k_pages,      // [n_pages, page, n_kv, hd]
                      const T* __restrict__ v_pages,
                      const int* __restrict__ block_tables,  // [B, pages_per_seq]
                      const int* __restrict__ lengths,       // [B]
                      const int* __restrict__ q_start,       // [B]
                      const float* __restrict__ k_scale,     // [B, n_kv]
                      const float* __restrict__ v_scale,
                      float* __restrict__ out,               // [B, S, H, hd]
                      int S, int H, int n_kv, int hd, int page_size,
                      int pages_per_seq, float sm_scale) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;                 // padded K rows: conflict-free QK reads
  float* q_s = smem;                      // [kRows][hd], pre-scaled by sm_scale
  float* k_s = q_s + kRows * hd;          // [kTile][hd + 1], dequantized
  float* v_s = k_s + kTile * hdp;         // [kTile][hd], dequantized

  const int row0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / n_kv;
  const int n_rows = S * group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int len = lengths[b];
  const int qs = q_start[b];
  const float ksc = k_scale[b * n_kv + h];
  const float vsc = v_scale[b * n_kv + h];

  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int row = row0 + r;
    float val = 0.f;
    if (row < n_rows) {
      const int s = row / group;
      const int g = row - s * group;
      val = q[((static_cast<size_t>(b) * S + s) * H + h * group + g) * hd + d] * sm_scale;
    }
    q_s[i] = val;
  }

  // Last position any row of this CTA may attend (see the note above).
  const int last_row = min(row0 + kRows, n_rows) - 1;
  int n_pos = min(len, qs + last_row / group + 1);
  n_pos = min(n_pos, pages_per_seq * page_size);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kMasked;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  const size_t page_stride = static_cast<size_t>(page_size) * n_kv * hd;
  const int* bt_row = block_tables + static_cast<size_t>(b) * pages_per_seq;

  // 16-byte vector loads when every K/V row starts 16-byte aligned: all of
  // a thread's loads for a tile are issued before any is consumed, so
  // their latencies overlap instead of adding up
  constexpr int kVec = 16 / sizeof(T);              // elements per 16 B
  constexpr int kIters = (kTile * (32 * DPL / kVec) + kThreads - 1) / kThreads;
  const bool vec_ok = hd % kVec == 0 &&
                      (reinterpret_cast<uintptr_t>(k_pages) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(v_pages) & 15) == 0;
  const int cpr = hd / kVec;                        // chunks per K/V row

  for (int t0 = 0; t0 < n_pos; t0 += kTile) {
    __syncthreads();  // the previous tile has been consumed
    if (vec_ok) {
      uint4 kr[kIters], vr[kIters];
      int dst[kIters];
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        const int c = tid + it * kThreads;
        const int j = c / cpr;
        const int p = t0 + j;
        dst[it] = -1;
        if (c < kTile * cpr) {
          dst[it] = j * hdp + (c - j * cpr) * kVec;
          if (p < n_pos) {
            // the block-table load replaces the TPU kernel's
            // scalar-prefetch index_map: logical page -> physical page
            const int phys = bt_row[p / page_size];
            const size_t off = phys * page_stride +
                               (static_cast<size_t>(p % page_size) * n_kv + h) * hd +
                               (c - j * cpr) * kVec;
            kr[it] = *reinterpret_cast<const uint4*>(k_pages + off);
            vr[it] = *reinterpret_cast<const uint4*>(v_pages + off);
          } else {
            kr[it] = make_uint4(0, 0, 0, 0);
            vr[it] = make_uint4(0, 0, 0, 0);
          }
        }
      }
#pragma unroll
      for (int it = 0; it < kIters; ++it) {
        if (dst[it] >= 0) {
          const T* ke = reinterpret_cast<const T*>(&kr[it]);
          const T* ve = reinterpret_cast<const T*>(&vr[it]);
          const int j = dst[it] / hdp;
          const int d0 = dst[it] - j * hdp;
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            k_s[dst[it] + e] = to_f32(ke[e]) * ksc;
            v_s[j * hd + d0 + e] = to_f32(ve[e]) * vsc;
          }
        }
      }
    } else {
      for (int i = tid; i < kTile * hd; i += kThreads) {
        const int j = i / hd;
        const int d = i - j * hd;
        const int p = t0 + j;
        float kv = 0.f, vv = 0.f;
        if (p < n_pos) {
          const int phys = bt_row[p / page_size];
          const size_t off = phys * page_stride +
                             (static_cast<size_t>(p % page_size) * n_kv + h) * hd + d;
          kv = to_f32(k_pages[off]) * ksc;
          vv = to_f32(v_pages[off]) * vsc;
        }
        k_s[j * hdp + d] = kv;
        v_s[j * hd + d] = vv;
      }
    }
    __syncthreads();

    const int p = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int row = row0 + warp * kRowsPerWarp + rr;
      if (row < n_rows) {  // warp-uniform
        const int qpos = qs + row / group;
        const bool valid = (p <= qpos) && (p < len) && (p < n_pos);
        const float* qr = q_s + (warp * kRowsPerWarp + rr) * hd;
        const float* kr = k_s + lane * hdp;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        int d = 0;
        for (; d + 3 < hd; d += 4) {
          s0 = fmaf(qr[d], kr[d], s0);
          s1 = fmaf(qr[d + 1], kr[d + 1], s1);
          s2 = fmaf(qr[d + 2], kr[d + 2], s2);
          s3 = fmaf(qr[d + 3], kr[d + 3], s3);
        }
        for (; d < hd; ++d) s0 = fmaf(qr[d], kr[d], s0);
        const float sc = valid ? (s0 + s1) + (s2 + s3) : kMasked;

        const float m_new = fmaxf(m[rr], warp_max(sc));
        const float alpha = expf(m[rr] - m_new);
        // explicit re-mask: on a fully masked tile exp(sc - m_new) = exp(0)
        const float w = valid ? expf(sc - m_new) : 0.f;
        l[rr] = l[rr] * alpha + warp_sum(w);
        float pv[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) pv[i] = 0.f;
        for (int j = 0; j < kTile; ++j) {
          const float wj = __shfl_sync(kFull, w, j);
          const float* vr = v_s + j * hd;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int dd = lane + 32 * i;
            if (dd < hd) pv[i] = fmaf(wj, vr[dd], pv[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[rr][i] = acc[rr][i] * alpha + pv[i];
        m[rr] = m_new;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    if (row < n_rows) {
      const int s = row / group;
      const int g = row - s * group;
      float* o = out + ((static_cast<size_t>(b) * S + s) * H + h * group + g) * hd;
      const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int dd = lane + 32 * i;
        if (dd < hd) o[dd] = acc[rr][i] / den;
      }
    }
  }
}

template <typename T, int DPL>
int launch(const float* q, const void* k_pages, const void* v_pages, const int* bt,
           const int* lengths, const int* q_start, const float* ks, const float* vs,
           float* out, int B, int S, int H, int n_kv, int hd, int page_size,
           int pages_per_seq, cudaStream_t stream) {
  const int n_rows = S * (H / n_kv);
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kRows) * hd + static_cast<size_t>(kTile) * (hd + 1) +
       static_cast<size_t>(kTile) * hd);
  auto kernel = paged_flash_mq_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n_rows + kRows - 1) / kRows, n_kv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(k_pages), static_cast<const T*>(v_pages), bt, lengths,
      q_start, ks, vs, out, S, H, n_kv, hd, page_size, pages_per_seq,
      1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dpl(const float* q, const void* kp, const void* vp, const int* bt,
               const int* lengths, const int* q_start, const float* ks, const float* vs,
               float* out, int B, int S, int H, int n_kv, int hd, int page_size,
               int pages_per_seq, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 1>(q, kp, vp, bt, lengths, q_start, ks, vs, out, B, S, H, n_kv, hd,
                        page_size, pages_per_seq, stream);
  if (hd <= 64)
    return launch<T, 2>(q, kp, vp, bt, lengths, q_start, ks, vs, out, B, S, H, n_kv, hd,
                        page_size, pages_per_seq, stream);
  if (hd <= 128)
    return launch<T, 4>(q, kp, vp, bt, lengths, q_start, ks, vs, out, B, S, H, n_kv, hd,
                        page_size, pages_per_seq, stream);
  return launch<T, 8>(q, kp, vp, bt, lengths, q_start, ks, vs, out, B, S, H, n_kv, hd,
                      page_size, pages_per_seq, stream);
}


// ---------------------------------------------------------------------------
// Split-KV kernel for n_rows = S * group <= kSplitRows (decode and verify)
// ---------------------------------------------------------------------------

constexpr int kSplitRows = 16;                     // most rows per (b, kv head)
constexpr int kSlots = kSplitRows / kWarps;        // row slots per warp
constexpr int kSplitTile = 32;                     // positions per ring stage

// 16-byte asynchronous copy global -> shared; `full` false zero-fills the
// 16 bytes and reads nothing (so masked positions hold finite zeros)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T> __device__ __forceinline__ T zero_of() { return T(0); }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <int Bytes> struct Word;
template <> struct Word<1> { using type = uint8_t; };
template <> struct Word<2> { using type = uint16_t; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// Four int8 of one 32-bit word to f32 without I2F, whose rate is a
// fraction of the FMA rate: byte b ^ 0x80 = b + 128 goes into the mantissa
// of 2^23 and 2^23 + 128 is subtracted, exactly (one PRMT and one FADD an
// element; the split kernel converts every K/V element it reads)
__device__ __forceinline__ void s8x4_to_f32(uint32_t w, float* x) {
  const uint32_t t = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __int_as_float(__byte_perm(t, 0x4B000000u, 0x7440 + i)) - 8388736.f;
}

// N elements of type T held in registers at `raw`, as f32
template <typename T, int N>
__device__ __forceinline__ void cvt(const void* raw, float* x) {
  if constexpr (std::is_same<T, int8_t>::value && N % 4 == 0) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(raw);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) s8x4_to_f32(w[i], x + 4 * i);
  } else {
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_f32(e[i]);
  }
}

// The DPL consecutive elements of a shared-memory row starting at `p`, as
// f32, in loads of up to 16 bytes (p is aligned to min(16, DPL * sizeof(T)))
template <typename T, int DPL>
__device__ __forceinline__ void load_dims(const T* p, float (&x)[DPL]) {
  constexpr int kB = DPL * static_cast<int>(sizeof(T));
  constexpr int kU = kB < 16 ? kB : 16;
  using W = typename Word<kU>::type;
  W w[kB / kU];
#pragma unroll
  for (int u = 0; u < kB / kU; ++u) w[u] = reinterpret_cast<const W*>(p)[u];
  cvt<T, DPL>(w, x);
}

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

// Dynamic shared memory of the split kernel, in bytes; the host sizes the
// launch and the kernel finds its arrays with the same arithmetic.
struct SplitSmem {
  int rs;     // bytes per K/V row of a stage: an odd number of 16-byte units
  int q, bt, ring, part, ml, flag, total;
  __host__ __device__ SplitSmem(int n_rows, int hd, int chunk_pages, int elem, int stages) {
    rs = (((hd * elem + 15) / 16) | 1) * 16;
    q = 0;                                          // f32 [n_rows][hd]
    bt = up16(q + n_rows * hd * 4);                 // int [chunk_pages]
    ring = up16(bt + chunk_pages * 4);              // [stages][K, V][kSplitTile][rs]
    part = ring + stages * 2 * kSplitTile * rs;     // f32 [kWarps][kSlots][hd]
    ml = part + kWarps * kSlots * hd * 4;           // f32 [kWarps][kSlots][m, l]
    flag = up16(ml + kWarps * kSlots * 2 * 4);
    total = flag + 16;
  }
};

// Grid: (n_kv, n_splits, B), heads fastest; split x covers positions
// [x * chunk, (x + 1) * chunk).  DPL = output dims per lane (lane owns dims [lane * DPL, +DPL));
// NST = ring stages.  ws: f32 partials, [B, n_kv, n_splits, n_rows, m, l]
// then [B, n_kv, n_splits, n_rows, hd]; unused when n_splits = 1.
template <typename T, int DPL, int NST>
__global__ void __launch_bounds__(kThreads, 6)
paged_flash_split_kernel(const float* __restrict__ q,        // [B, S, H, hd]
                         const T* __restrict__ k_pages,      // [n_pages, page, n_kv, hd]
                         const T* __restrict__ v_pages,
                         const int* __restrict__ block_tables,  // [B, pages_per_seq]
                         const int* __restrict__ lengths,       // [B]
                         const int* __restrict__ q_start,       // [B]
                         const float* __restrict__ k_scale,     // [B, n_kv]
                         const float* __restrict__ v_scale,
                         float* __restrict__ out,               // [B, S, H, hd]
                         float* __restrict__ ws, int* __restrict__ counters,
                         int S, int H, int n_kv, int hd, int page_size,
                         int pages_per_seq, int chunk, float sm_scale) {
  extern __shared__ __align__(16) unsigned char split_smem[];
  const int h = blockIdx.x;
  const int split = blockIdx.y;
  const int b = blockIdx.z;
  const int n_splits = gridDim.y;
  const int group = H / n_kv;
  const int n_rows = S * group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int span = pages_per_seq * page_size;
  const int c0 = split * chunk;
  const int pg0 = c0 / page_size;
  const int chunk_pages = chunk / page_size;
  const int max_tiles = (chunk + kSplitTile - 1) / kSplitTile;
  const SplitSmem L(n_rows, hd, chunk_pages, sizeof(T), min(NST, max_tiles));
  float* q_s = reinterpret_cast<float*>(split_smem + L.q);
  int* bt_s = reinterpret_cast<int*>(split_smem + L.bt);
  unsigned char* ring = split_smem + L.ring;
  float* part = reinterpret_cast<float*>(split_smem + L.part);
  float* part_ml = reinterpret_cast<float*>(split_smem + L.ml);
  int* flag = reinterpret_cast<int*>(split_smem + L.flag);

  // Loads that depend on nothing, issued together: the row's length,
  // q_start and scales, the chunk's block-table entries, and q.
  const int len = lengths[b];
  const int qs = q_start[b];
  const float ksc = k_scale[b * n_kv + h];
  const float vsc = v_scale[b * n_kv + h];
  const int* bt_row = block_tables + static_cast<size_t>(b) * pages_per_seq;
  for (int i = tid; i < chunk_pages; i += kThreads)
    bt_s[i] = pg0 + i < pages_per_seq ? bt_row[pg0 + i] : 0;
  // q pre-scaled by sm_scale * k_scale: the K dequantization, folded
  const float q_mul = sm_scale * ksc;
  for (int i = tid; i < n_rows * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int s = r / group;
    const int g = r - s * group;
    q_s[i] = q[((static_cast<size_t>(b) * S + s) * H + h * group + g) * hd + d] * q_mul;
  }

  // This CTA's positions: [c0, c1), clipped at the last position any of
  // its rows may attend
  const int n_pos = min(min(len, qs + (n_rows - 1) / group + 1), span);
  const int c1 = min(c0 + chunk, n_pos);
  const int n_tiles = c1 > c0 ? (c1 - c0 + kSplitTile - 1) / kSplitTile : 0;

  // Work split (see the note at the top): with n_rows <= 4, P = 4 warps
  // share every row, each over npos = 8 positions of a tile with lp = 4
  // lanes a position; with more rows, P = 1 and R = 4 row groups (row r in
  // group r mod 4), a lane a position.  Slot i of a warp holds row
  // rg + R * i; the lp lanes of a position take every lp-th 16-byte chunk
  // of hd.
  const int P = n_rows <= kWarps ? kWarps : 1;
  const int R = kWarps / P;
  const int wp = warp % P;
  const int rg = warp / P;
  const int npos = kSplitTile / P;
  const int lp = 32 / npos;  // lanes per position
  const int j = lane % npos;
  const int sub = lane / npos;

  const size_t page_stride = static_cast<size_t>(page_size) * n_kv * hd;
  constexpr int kVec = 16 / sizeof(T);               // elements per 16 B
  const int c16 = hd / kVec;                         // 16-byte chunks per row
  const bool vec = hd % kVec == 0 &&
                   (reinterpret_cast<uintptr_t>(k_pages) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(v_pages) & 15) == 0;
  const int rs = L.rs;
  // powers of two (the serving shapes) index with shifts, not divisions
  const bool page_pow2 = (page_size & (page_size - 1)) == 0;
  const int page_shift = __ffs(page_size) - 1;
  const bool c16_pow2 = (c16 & (c16 - 1)) == 0;
  const int c16_shift = __ffs(c16) - 1;

  float m[kSlots], l[kSlots], acc[kSlots][DPL];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }
  __syncthreads();  // bt_s and q_s are in place

  // Element offset of position p's K/V row in the pool: the block-table
  // entry, staged per page, replaces the TPU kernel's scalar-prefetch
  // index_map
  auto row_off = [&](int p) -> size_t {
    const int pg = page_pow2 ? p >> page_shift : p / page_size;
    return bt_s[pg - pg0] * page_stride +
           (static_cast<size_t>(p - pg * page_size) * n_kv + h) * hd;
  };
  // Tile t of the chunk into stage t % NST (nothing past the last tile)
  auto load_tile = [&](int t) {
    if (t >= n_tiles) return;
    unsigned char* kst = ring + static_cast<size_t>(t % NST) * 2 * kSplitTile * rs;
    unsigned char* vst = kst + kSplitTile * rs;
    const int t0 = c0 + t * kSplitTile;
    if (vec) {
      for (int c = tid; c < kSplitTile * c16; c += kThreads) {
        const int jj = c16_pow2 ? c >> c16_shift : c / c16;
        const int cc = c - jj * c16;
        const int p = t0 + jj;
        const bool in = p < c1;
        const size_t off = (in ? row_off(p) : 0) + static_cast<size_t>(cc) * kVec;
        cp_async16(kst + jj * rs + cc * 16, k_pages + off, in);
        cp_async16(vst + jj * rs + cc * 16, v_pages + off, in);
      }
    } else {
      for (int i = tid; i < kSplitTile * hd; i += kThreads) {
        const int jj = i / hd;
        const int d = i - jj * hd;
        const int p = t0 + jj;
        T kv = zero_of<T>(), vv = zero_of<T>();
        if (p < c1) {
          const size_t off = row_off(p) + d;
          kv = k_pages[off];
          vv = v_pages[off];
        }
        reinterpret_cast<T*>(kst + jj * rs)[d] = kv;
        reinterpret_cast<T*>(vst + jj * rs)[d] = vv;
      }
    }
  };

#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    load_tile(t);
    cp_async_commit();
  }
  const int d0 = lane * DPL;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile t has landed; stage (t - 1) % NST is free
    load_tile(t + NST - 1);
    cp_async_commit();
    const unsigned char* kst = ring + static_cast<size_t>(t % NST) * 2 * kSplitTile * rs;
    const unsigned char* vst = kst + kSplitTile * rs;
    const int jt = wp * npos + j;  // this lane's position in the tile
    const int p = c0 + t * kSplitTile + jt;

    bool valid[kSlots], active[kSlots];
    bool any = false;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int row = rg + R * i;
      valid[i] = row < n_rows && p < c1 && p <= qs + row / group;
      active[i] = __any_sync(kFull, valid[i]);  // warp-uniform
      any |= active[i];
    }
    if (!any) continue;  // a fully masked tile leaves m, l and acc as they are

    // QK: each K chunk converted once, then dotted with every row's q
    float sc[kSlots][2];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) sc[i][0] = sc[i][1] = 0.f;
    if (vec) {
      const unsigned char* kr = kst + jt * rs;
      for (int cc = sub; cc < c16; cc += lp) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + cc * 16);
        float kf[kVec];
        cvt<T, kVec>(&raw, kf);
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (!active[i]) continue;
          const float4* qc = reinterpret_cast<const float4*>(q_s + (rg + R * i) * hd + cc * kVec);
#pragma unroll
          for (int e = 0; e < kVec / 4; ++e) {
            const float4 qv = qc[e];
            sc[i][0] = fmaf(qv.x, kf[4 * e], sc[i][0]);
            sc[i][1] = fmaf(qv.y, kf[4 * e + 1], sc[i][1]);
            sc[i][0] = fmaf(qv.z, kf[4 * e + 2], sc[i][0]);
            sc[i][1] = fmaf(qv.w, kf[4 * e + 3], sc[i][1]);
          }
        }
      }
    } else {
      const T* kr = reinterpret_cast<const T*>(kst + jt * rs);
      for (int d = sub; d < hd; d += lp) {
        const float kf = to_f32(kr[d]);
#pragma unroll
        for (int i = 0; i < kSlots; ++i)
          if (active[i]) sc[i][0] = fmaf(q_s[(rg + R * i) * hd + d], kf, sc[i][0]);
      }
    }

    // Online softmax per row over the warp's npos positions: the lp lanes
    // of a position hold one full score after the xor over lane bits >=
    // npos, so max and sum run over the lane bits below it
    float w[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      w[i] = 0.f;
      if (!active[i]) continue;
      float s = sc[i][0] + sc[i][1];
      for (int o = npos; o < 32; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
      s = valid[i] ? s : kMasked;
      float mt = s;
      for (int o = npos >> 1; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, o));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      // explicit re-mask: on a fully masked lane exp(s - m_new) = exp(0)
      w[i] = valid[i] ? expf(s - m_new) : 0.f;
      float ws_ = w[i];
      for (int o = npos >> 1; o > 0; o >>= 1) ws_ += __shfl_xor_sync(kFull, ws_, o);
      l[i] = l[i] * alpha + ws_;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
    }

    // AV: each V row converted once, then weighted into every row's acc
    // (lane jj < npos holds position jj's weight)
    for (int jj = 0; jj < npos; ++jj) {
      const T* vr = reinterpret_cast<const T*>(vst + (wp * npos + jj) * rs);
      float x[DPL];
      if (d0 + DPL <= hd) {
        load_dims<T, DPL>(vr + d0, x);
      } else {
#pragma unroll
        for (int e = 0; e < DPL; ++e) x[e] = d0 + e < hd ? to_f32(vr[d0 + e]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (!active[i]) continue;
        const float wj = __shfl_sync(kFull, w[i], jj);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] = fmaf(wj, x[e], acc[i][e]);
      }
    }
  }
  cp_async_wait<0>();

  // The warps' partials to shared memory, then one merged partial per row
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int slot = warp * kSlots + i;
    if (lane == 0) {
      part_ml[slot * 2] = m[i];
      part_ml[slot * 2 + 1] = l[i];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      if (d0 + e < hd) part[slot * hd + d0 + e] = acc[i][e];
  }
  __syncthreads();

  const size_t bh = static_cast<size_t>(b) * n_kv + h;
  const size_t n_part = static_cast<size_t>(gridDim.z) * n_kv * n_splits * n_rows;
  for (int r = warp; r < n_rows; r += kWarps) {  // row r -> warp r mod 4
    const int g = r % R;
    const int i = r / R;
    float mx = kMasked;
    for (int x = 0; x < P; ++x) mx = fmaxf(mx, part_ml[((g * P + x) * kSlots + i) * 2]);
    float den = 0.f;
    float a[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) a[e] = 0.f;
    for (int x = 0; x < P; ++x) {
      const int slot = (g * P + x) * kSlots + i;
      const float f = expf(part_ml[slot * 2] - mx);
      den += part_ml[slot * 2 + 1] * f;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        if (d0 + e < hd) a[e] = fmaf(part[slot * hd + d0 + e], f, a[e]);
    }
    if (n_splits == 1) {
      const int s = r / group;
      const int gg = r - s * group;
      float* o = out + ((static_cast<size_t>(b) * S + s) * H + h * group + gg) * hd;
      const float inv = 1.f / fmaxf(den, 1e-30f);
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        if (d0 + e < hd) o[d0 + e] = a[e] * inv * vsc;  // V dequantization, folded
    } else {
      const size_t idx = (bh * n_splits + split) * n_rows + r;
      if (lane == 0) {
        ws[idx * 2] = mx;
        ws[idx * 2 + 1] = den;
      }
      if (den > 0.f) {  // the merge reads no acc of an empty partial
        float* wa = ws + 2 * n_part + idx * hd;
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          if (d0 + e < hd) wa[d0 + e] = a[e];
      }
    }
  }
  if (n_splits == 1) return;

  // The last CTA of this (b, kv head) to arrive merges the splits.  The
  // barrier orders every thread's partial before thread 0's counter
  // update, whose release (gpu scope, cumulative) publishes them; the
  // acquire of the CTA that arrives last makes all splits' partials
  // visible to it, and the barrier after passes them to its threads
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(counters + bh) : "memory");
    *flag = prev == n_splits - 1;
  }
  __syncthreads();
  if (!*flag) return;
  const float* wacc = ws + 2 * n_part;
  for (int r = warp; r < n_rows; r += kWarps) {
    const size_t idx0 = bh * n_splits * n_rows + r;  // split 0 of row r
    float mx = kMasked, den = 0.f;
    float a[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) a[e] = 0.f;
    // splits in batches of 8, each batch's (m, l) and acc loads in flight
    // together; merged online in split order (repeatable); an empty
    // split's acc was never written and is never used
    for (int x0 = 0; x0 < n_splits; x0 += 8) {
      float mm[8], ll[8], v[8][DPL];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const size_t idx = idx0 + static_cast<size_t>(min(x0 + u, n_splits - 1)) * n_rows;
        mm[u] = __ldcg(ws + idx * 2);
        ll[u] = __ldcg(ws + idx * 2 + 1);
        const float* wa = wacc + idx * hd + d0;
#pragma unroll
        for (int e = 0; e < DPL; ++e) v[u][e] = d0 + e < hd ? __ldcg(wa + e) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (x0 + u < n_splits && ll[u] > 0.f) {
          const float m_new = fmaxf(mx, mm[u]);
          const float al = expf(mx - m_new);
          const float f = expf(mm[u] - m_new);
          den = den * al + ll[u] * f;
#pragma unroll
          for (int e = 0; e < DPL; ++e) a[e] = a[e] * al + v[u][e] * f;
          mx = m_new;
        }
      }
    }
    const int s = r / group;
    const int gg = r - s * group;
    float* o = out + ((static_cast<size_t>(b) * S + s) * H + h * group + gg) * hd;
    const float inv = 1.f / fmaxf(den, 1e-30f);
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      if (d0 + e < hd) o[d0 + e] = a[e] * inv * vsc;
  }
  if (tid == 0) counters[bh] = 0;  // ready for the next launch
}

template <typename T, int DPL>
int launch_split(const float* q, const void* k_pages, const void* v_pages, const int* bt,
                 const int* lengths, const int* q_start, const float* ks, const float* vs,
                 float* out, float* ws, int* counters, int B, int S, int H, int n_kv, int hd,
                 int page_size, int pages_per_seq, int chunk, int n_splits,
                 cudaStream_t stream) {
  constexpr int NST = sizeof(T) == 1 ? 3 : 2;
  const int n_rows = S * (H / n_kv);
  const int tiles = (chunk + kSplitTile - 1) / kSplitTile;
  const SplitSmem L(n_rows, hd, chunk / page_size, sizeof(T), tiles < NST ? tiles : NST);
  if (L.total > 232448) return -1;  // the most shared memory a CTA may have
  auto kernel = paged_flash_split_kernel<T, DPL, NST>;
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_kv, n_splits, B);
  kernel<<<grid, kThreads, L.total, stream>>>(
      q, static_cast<const T*>(k_pages), static_cast<const T*>(v_pages), bt, lengths,
      q_start, ks, vs, out, ws, counters, S, H, n_kv, hd, page_size, pages_per_seq, chunk,
      1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_split_dpl(const float* q, const void* kp, const void* vp, const int* bt,
                     const int* lengths, const int* q_start, const float* ks,
                     const float* vs, float* out, float* ws, int* counters, int B, int S,
                     int H, int n_kv, int hd, int page_size, int pages_per_seq, int chunk,
                     int n_splits, cudaStream_t stream) {
#define PFA_SPLIT(D)                                                                   \
  launch_split<T, D>(q, kp, vp, bt, lengths, q_start, ks, vs, out, ws, counters, B, S, \
                     H, n_kv, hd, page_size, pages_per_seq, chunk, n_splits, stream)
  if (hd <= 32) return PFA_SPLIT(1);
  if (hd <= 64) return PFA_SPLIT(2);
  if (hd <= 128) return PFA_SPLIT(4);
  return PFA_SPLIT(8);
#undef PFA_SPLIT
}

}  // namespace

// Page dtype codes: 0 = int8, 1 = bfloat16, 2 = float32.
// Both entry points return 0 on success, a cudaError_t code after a failed
// launch, or -1 for arguments the kernels do not take (checked again by the
// Python wrapper).

// The tiled kernel of the first port at any shape (prefill, and a yardstick
// for the split kernel at decode and verify).
extern "C" int paged_flash_mq_tiled_launch(const void* q, const void* k_pages,
                                           const void* v_pages, const void* block_tables,
                                           const void* lengths, const void* q_start,
                                           const void* k_scale, const void* v_scale,
                                           void* out, int B, int S, int H, int n_kv, int hd,
                                           int page_size, int pages_per_seq, int page_dtype,
                                           void* stream) {
  if (hd < 1 || hd > 256 || n_kv < 1 || H % n_kv != 0 || page_size < 1 ||
      pages_per_seq < 1)
    return -1;
  if (B == 0 || S == 0) return 0;
  const float* qf = static_cast<const float*>(q);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* q0 = static_cast<const int*>(q_start);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (page_dtype) {
    case 0:
      return launch_dpl<int8_t>(qf, k_pages, v_pages, bt, ln, q0, ks, vs, o, B, S, H, n_kv,
                                hd, page_size, pages_per_seq, st);
    case 1:
      return launch_dpl<__nv_bfloat16>(qf, k_pages, v_pages, bt, ln, q0, ks, vs, o, B, S, H,
                                       n_kv, hd, page_size, pages_per_seq, st);
    case 2:
      return launch_dpl<float>(qf, k_pages, v_pages, bt, ln, q0, ks, vs, o, B, S, H, n_kv,
                               hd, page_size, pages_per_seq, st);
    default:
      return -1;
  }
}

// The serving path: the split-KV kernel when S * (H / n_kv) <= 16, split
// over n_splits chunks of `chunk` positions (a whole number of pages;
// n_splits * chunk covers the block table's span, n_splits - 1 chunks do
// not), with workspace `ws` ([B, n_kv, n_splits, n_rows, hd + 2] f32) and
// `counters` (n_counters zeroed int32, at least B * n_kv) when n_splits > 1;
// else the tiled kernel, which reads neither.
extern "C" int paged_flash_mq_launch(const void* q, const void* k_pages,
                                     const void* v_pages, const void* block_tables,
                                     const void* lengths, const void* q_start,
                                     const void* k_scale, const void* v_scale, void* out,
                                     void* ws, void* counters, int B, int S, int H, int n_kv,
                                     int hd, int page_size, int pages_per_seq,
                                     int page_dtype, int chunk, int n_splits,
                                     int n_counters, void* stream) {
  if (hd < 1 || hd > 256 || n_kv < 1 || H % n_kv != 0 || page_size < 1 ||
      pages_per_seq < 1)
    return -1;
  if (B == 0 || S == 0) return 0;
  if (S * (H / n_kv) > kSplitRows)
    return paged_flash_mq_tiled_launch(q, k_pages, v_pages, block_tables, lengths, q_start,
                                       k_scale, v_scale, out, B, S, H, n_kv, hd, page_size,
                                       pages_per_seq, page_dtype, stream);
  const int span = pages_per_seq * page_size;
  if (chunk < 1 || chunk % page_size != 0 || n_splits < 1 || n_splits > 65535 ||
      static_cast<long long>(n_splits) * chunk < span ||
      static_cast<long long>(n_splits - 1) * chunk >= span)
    return -1;
  if (n_splits > 1 && (ws == nullptr || counters == nullptr ||
                       static_cast<long long>(B) * n_kv > n_counters))
    return -1;
  const float* qf = static_cast<const float*>(q);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* q0 = static_cast<const int*>(q_start);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (page_dtype) {
    case 0:
      return launch_split_dpl<int8_t>(qf, k_pages, v_pages, bt, ln, q0, ks, vs, o, w, cnt, B,
                                      S, H, n_kv, hd, page_size, pages_per_seq, chunk,
                                      n_splits, st);
    case 1:
      return launch_split_dpl<__nv_bfloat16>(qf, k_pages, v_pages, bt, ln, q0, ks, vs, o, w,
                                             cnt, B, S, H, n_kv, hd, page_size,
                                             pages_per_seq, chunk, n_splits, st);
    case 2:
      return launch_split_dpl<float>(qf, k_pages, v_pages, bt, ln, q0, ks, vs, o, w, cnt, B,
                                     S, H, n_kv, hd, page_size, pages_per_seq, chunk,
                                     n_splits, st);
    default:
      return -1;
  }
}
