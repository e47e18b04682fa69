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
// What bounds it on an H100: the bytes it must move at 3.35 TB/s.  At
// decode and verify (B = 4, S = 1..4) that is a few hundred KB of K/V (1
// B/elem for int8 pages, 2 for bf16), under a microsecond, so at short
// contexts the launch and each dependent memory round trip (length, block
// table, pages, partials) set the time; at long contexts the bytes do.  At
// prefill (B 4, S 128) q read and out written as f32 are most of the ~20 MB
// (~6 us); the products, 2 bf16 tensor-core products per f32 product, need
// ~1 us at 989 TFLOP/s.
//
// Three kernels; the serving entry point picks one per call by n_rows =
// S * group:
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
//     last merges the splits in split order (bitwise-repeatable, no float
//     atomics) and writes the output.  The counters live at the end of the
//     call's own workspace (a `torch.empty` of the caching allocator,
//     ordered on the launch's stream) and are zeroed by a cudaMemsetAsync
//     on that stream just before the launch: no state outlives a call, two
//     launches on two streams of one card never share a counter, and a
//     CUDA graph captures the memset with the launch.
// * n_rows > 16 (prefill, GQA verify at larger k, resync replay): the
//   tensor-core kernel `paged_flash_mq_tc_kernel`.
//   - Grid (row blocks x column blocks, n_kv, B).  A CTA takes 64 stacked
//     query rows of one (b, kv head), so it reads that pair's pages once
//     per 64 rows (the tiled kernel read them once per 16); row blocks
//     with the most positions to attend are issued first.  It stops after
//     the last position any of its rows may attend, and a warp skips the
//     16-position groups past its own rows' last position (both exact: a
//     fully masked group leaves m, l and acc as they are).
//   - 8 warps: warp w takes rows 16 (w mod 4) .. + 15 over one half of
//     each tile's positions (w / 4); the two halves keep their own online
//     softmax state and merge once at the end in shared memory.  Each SM
//     holds two CTAs, so 4 warps share a scheduler: with fewer, a CTA's
//     chains of dependent index arithmetic and shared-memory round trips,
//     not its products, set its time.
//   - Pages stream in tiles of 64 positions (32 for f32 pages) by 16-byte
//     cp.async copies into one raw staging buffer; each tile is converted
//     once in shared memory into bf16 planes (int8 and bf16 exactly), and
//     the copy of tile t + 1 is issued right after, so it is in flight
//     while tile t's products run.  Tile 0's copy is issued before q is
//     loaded (16-byte loads straight to registers, split there).  Block-
//     table entries are staged once per CTA.  Plane rows are padded to an
//     odd number of 16-byte units, so ldmatrix is bank-conflict-free; hd is
//     padded to 16 with zeros.  Serving shapes (powers of two) index with
//     shifts.
//   - Products are mma.sync.m16n8k16 bf16 -> f32 with ldmatrix fragments
//     (.trans for V), not wgmma + TMA: the serving spans are 128-184
//     positions, so a CTA walks at most 3 tiles and the deep asynchronous
//     pipeline wgmma needs would not fill; TMA cannot follow a block table
//     without a descriptor per page.  wgmma is the next step if tiles turn
//     out compute-bound.
//   - Precision (the 1e-4 x max |plain| tolerance needs more than one bf16
//     product, since q and the weights are f32): every f32 operand is split
//     into bf16 hi + lo (16 bits of mantissa).  q carries sm_scale *
//     k_scale * log2(e) before its split (exp2 replaces exp, the same
//     softmax), so QK = q_hi K + q_lo K for int8 and bf16 pages, which are
//     exact in bf16; PV = p_hi V + p_lo V, and v_scale is applied once at
//     the end.  f32 pages split K and V too: three products (hi hi, lo hi,
//     hi lo).  The two products of an accumulator are issued apart.
//   - Online softmax runs on the accumulator fragments: each row's max and
//     sum over the quad of lanes that share it; P's fragments are packed
//     into the A fragments of the PV product in registers, as in
//     flash-attention 2, and acc for 16 x DC outputs stays in registers.
//     Above hd 128 the output is split into column blocks of 128 dims, a
//     CTA each (each computes the whole q K^T), which keeps acc at 64
//     registers a thread.  The merged output tile leaves through shared
//     memory as 16-byte row segments.
// * The tiled kernel `paged_flash_mq_kernel` of the first port (one CTA
//   per 16 rows, f32 CUDA-core products) is no longer on the serving path:
//   `paged_flash_mq_tiled_launch` runs it at any shape, so the designs can
//   be timed and checked side by side.

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


// ---------------------------------------------------------------------------
// Tensor-core kernel for n_rows = S * group > kSplitRows (prefill)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;     // stacked query rows per CTA: 16 per warp
constexpr int kTcThreads = 256; // 8 warps: two groups of 4 over the rows
constexpr int kBtStage = 256;   // block-table entries staged in shared memory
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as bf16 hi + lo pairs, a in the low half: hi = bf16(x), lo =
// bf16(x - hi), so hi + lo carries 16 bits of x's mantissa
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight f32 values to a bf16 plane (and, with LO, their residuals to a
// second plane); both 16-byte aligned
template <bool LO>
__device__ __forceinline__ void store8(__nv_bfloat16* hi, __nv_bfloat16* lo, const float (&x)[8]) {
  uint4 h, l;
  uint32_t* hw = reinterpret_cast<uint32_t*>(&h);
  uint32_t* lw = reinterpret_cast<uint32_t*>(&l);
#pragma unroll
  for (int i = 0; i < 4; ++i) split2(x[2 * i], x[2 * i + 1], hw[i], lw[i]);
  *reinterpret_cast<uint4*>(hi) = h;
  if constexpr (LO) *reinterpret_cast<uint4*>(lo) = l;
}

// Eight elements of type T as one register-held unit (8, 16 or 32 bytes)
struct Bytes32 {
  uint4 a, b;
};
template <typename T> struct Raw8Of { using type = typename Word<8 * sizeof(T)>::type; };
template <> struct Raw8Of<float> { using type = Bytes32; };
template <typename T> using Raw8 = typename Raw8Of<T>::type;

// Elements d0 .. d0 + 7 of a row of n elements, `p` at element d0 (null:
// a position past the tile's last, all 0): one aligned load when all 8 lie
// in the row (p aligned to the unit), else element by element with 0 past n
template <typename T>
__device__ __forceinline__ Raw8<T> load_unit(const T* p, int d0, int n) {
  Raw8<T> w;
  if (p != nullptr && d0 + 8 <= n && (reinterpret_cast<uintptr_t>(p) % alignof(Raw8<T>)) == 0) {
    w = *reinterpret_cast<const Raw8<T>*>(p);
  } else {
    T* e = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = p != nullptr && d0 + i < n ? p[i] : zero_of<T>();
  }
  return w;
}

// Dynamic shared memory of the tensor-core kernel, in bytes (host and
// device use the same arithmetic).  Planes are bf16 with rows padded to an
// odd number of 16-byte units, so the 8 row addresses of an ldmatrix hit 8
// distinct 16-byte bank groups.  f32 pages (LO) keep a second plane of
// residuals for K and V.
template <typename T, int DC, int BN>
struct TcSmem {
  int hp, ldq, ldv, rk, rv;
  int q_hi, q_lo, k_hi, k_lo, v_hi, v_lo, raw_k, raw_v, bt, total;
  __host__ __device__ explicit TcSmem(int hd) {
    constexpr bool kLo = sizeof(T) == 4;
    hp = up16(hd);                       // hd padded to the MMA depth
    ldq = hp + 8;                        // q and K plane row: bf16 elements
    ldv = DC + 8;                        // V plane row
    rk = up16(hd * static_cast<int>(sizeof(T)));               // raw K row, bytes
    rv = up16((hd < DC ? hd : DC) * static_cast<int>(sizeof(T)));  // raw V row
    q_hi = 0;                                   // bf16 [kTcRows][ldq]
    q_lo = q_hi + kTcRows * ldq * 2;            // bf16 [kTcRows][ldq]
    k_hi = q_lo + kTcRows * ldq * 2;            // bf16 [BN][ldq]
    k_lo = k_hi + BN * ldq * 2;                 // bf16 [BN][ldq], f32 pages only
    v_hi = k_lo + (kLo ? BN * ldq * 2 : 0);     // bf16 [BN][ldv]
    v_lo = v_hi + BN * ldv * 2;                 // bf16 [BN][ldv], f32 pages only
    raw_k = v_lo + (kLo ? BN * ldv * 2 : 0);    // T [BN][rk bytes]
    raw_v = raw_k + BN * rk;                    // T [BN][rv bytes]
    bt = raw_v + BN * rv;                       // int [kBtStage]
    total = bt + kBtStage * 4;
  }
};

// Grid: (n_rb * n_cb, n_kv, B); x = cb * n_rb + (n_rb - 1 - rb), so the row
// blocks with the most positions to attend start first.  Row block rb
// holds stacked rows [64 rb, 64 rb + 64); column block cb computes output
// dims [cb * DC, cb * DC + DC).  8 warps: warp w takes rows 16 (w mod 4)
// .. + 15 over the half of each tile's positions given by its group w / 4
// (each group keeps its own m, l, acc; merged at the end).  DC = the
// output columns a warp holds in registers (16..128); BN = positions per
// tile (64; 32 for f32 pages, whose residual planes double the staging).
template <typename T, int DC, int BN>
__global__ void __launch_bounds__(kTcThreads, 2)
paged_flash_mq_tc_kernel(const float* __restrict__ q,        // [B, S, H, hd]
                         const T* __restrict__ k_pages,      // [n_pages, page, n_kv, hd]
                         const T* __restrict__ v_pages,
                         const int* __restrict__ block_tables,  // [B, pages_per_seq]
                         const int* __restrict__ lengths,       // [B]
                         const int* __restrict__ q_start,       // [B]
                         const float* __restrict__ k_scale,     // [B, n_kv]
                         const float* __restrict__ v_scale,
                         float* __restrict__ out,               // [B, S, H, hd]
                         int S, int H, int n_kv, int hd, int page_size, int pages_per_seq,
                         int n_rb, float q_scale) {
  constexpr bool kLo = sizeof(T) == 4;
  constexpr int kPW = BN / 2;    // positions of a tile per warp group
  constexpr int kNT = kPW / 8;   // 8-position n-tiles of a warp's scores
  constexpr int kDT = DC / 8;    // 8-column n-tiles of a warp's output
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const TcSmem<T, DC, BN> L(hd);
  __nv_bfloat16* q_hi = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.q_hi);
  __nv_bfloat16* q_lo = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.q_lo);
  __nv_bfloat16* k_hi = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.k_hi);
  __nv_bfloat16* k_lo = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.k_lo);
  __nv_bfloat16* v_hi = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.v_hi);
  __nv_bfloat16* v_lo = reinterpret_cast<__nv_bfloat16*>(tc_smem + L.v_lo);
  unsigned char* raw_k = tc_smem + L.raw_k;
  unsigned char* raw_v = tc_smem + L.raw_v;
  int* bt_s = reinterpret_cast<int*>(tc_smem + L.bt);
  const int hp = L.hp, ldq = L.ldq, ldv = L.ldv;

  const int rb = n_rb - 1 - static_cast<int>(blockIdx.x) % n_rb;
  const int c0 = (static_cast<int>(blockIdx.x) / n_rb) * DC;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / n_kv;
  const int n_rows = S * group;
  const int row0 = rb * kTcRows;
  const int vcols = min(DC, hd - c0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = warp & 3;       // the warp's 16 rows
  const int wg = warp >> 2;      // and its half of each tile
  const int g = lane >> 2;       // the thread's rows g and g + 8 of the 16
  const int t4 = lane & 3;       // and its columns 2 t4, 2 t4 + 1 of each n-tile

  const int len = lengths[b];
  const int qs = q_start[b];
  const float ksc = k_scale[b * n_kv + h];
  const float vsc = v_scale[b * n_kv + h];
  const int* bt_row = block_tables + static_cast<size_t>(b) * pages_per_seq;
  // The block-table entries (the first kBtStage of the row, whatever its
  // length) load with the row's length and scales; staged once per CTA
  const int n_bt = min(pages_per_seq, kBtStage);
  const int bt_v = tid < n_bt ? bt_row[tid] : 0;
  const int lim = min(len, pages_per_seq * page_size);
  // Last position any row of this CTA may attend (exact: a fully masked
  // tile leaves m, l and acc as they are)
  const int last_row = min(row0 + kTcRows, n_rows) - 1;
  const int n_pos = min(lim, qs + last_row / group + 1);
  const int n_tiles = n_pos > 0 ? (n_pos + BN - 1) / BN : 0;
  if (tid < n_bt) bt_s[tid] = bt_v;

  const size_t page_stride = static_cast<size_t>(page_size) * n_kv * hd;
  const int pos_stride = n_kv * hd;  // between positions of a page
  const int head_off = h * hd;
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = (hd * static_cast<int>(sizeof(T))) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(k_pages) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(v_pages) & 15) == 0;
  // powers of two (the serving shapes) index with shifts, not divisions
  const bool page_pow2 = (page_size & (page_size - 1)) == 0;
  const int page_shift = __ffs(page_size) - 1;
  // Element offset of position p's K/V row in the pool: the block-table
  // entry replaces the TPU kernel's scalar-prefetch index_map
  auto row_off = [&](int p) -> size_t {
    const int pg = page_pow2 ? p >> page_shift : p / page_size;
    const int phys = pg < kBtStage ? bt_s[pg] : bt_row[pg];
    return phys * page_stride + ((p - pg * page_size) * pos_stride + head_off);
  };
  // 16-byte cp.async copies of BN rows of `chunks` 16-byte chunks each
  // (position t0 + j's row at `pool` + row_off + col0) to `dst` rows of
  // `rs` bytes; positions past n_pos are zero-filled
  auto copy_rows = [&](unsigned char* dst, int rs, const T* pool, int col0, int chunks,
                       int t0) {
    if (page_pow2 && (chunks & (chunks - 1)) == 0) {
      // the serving shapes: a thread keeps one chunk column and walks rows
      const int sh = __ffs(chunks) - 1;
      const int cc = tid & (chunks - 1);
      const T* src0 = pool + head_off + col0 + cc * kVec;
      unsigned char* dst0 = dst + cc * 16;
#pragma unroll 4
      for (int j = tid >> sh; j < BN; j += kTcThreads >> sh) {
        const int p = t0 + j;
        const bool in = p < n_pos;
        const int pg = p >> page_shift;
        const int phys = !in ? 0 : pg < kBtStage ? bt_s[pg] : bt_row[pg];
        cp_async16(dst0 + j * rs,
                   src0 + (in ? phys * page_stride + (p & (page_size - 1)) * pos_stride : 0),
                   in);
      }
      return;
    }
#pragma unroll 1
    for (int c = tid; c < BN * chunks; c += kTcThreads) {
      const int j = c / chunks;
      const int cc = c - j * chunks;
      const int p = t0 + j;
      const bool in = p < n_pos;
      cp_async16(dst + j * rs + cc * 16, pool + (in ? row_off(p) + col0 : 0) + cc * kVec, in);
    }
  };
  auto issue = [&](int t0) {  // K rows and this CTA's V columns of a tile
    if (!vec) return;
    copy_rows(raw_k, L.rk, k_pages, 0, hd / kVec, t0);
    copy_rows(raw_v, L.rv, v_pages, c0, vcols / kVec, t0);
  };
  // A staged tile -> bf16 planes (int8 and bf16 exactly; f32 as hi + lo),
  // 8 elements at a time; rows that are not 16-byte multiples read the
  // pool directly, element by element
  auto convert_matrix = [&](const unsigned char* raw, int rs, const T* pool, int col0,
                            int ncols, int units, __nv_bfloat16* hi, __nv_bfloat16* lo,
                            int ld, int t0) {
    if (vec && (ncols & 7) == 0 && (units & (units - 1)) == 0) {
      const int sh = __ffs(units) - 1;
#pragma unroll 4
      for (int u = tid; u < BN * units; u += kTcThreads) {
        const int j = u >> sh;
        const int d0 = (u - (j << sh)) * 8;
        Raw8<T> w;
        if (d0 < ncols) {
          w = *reinterpret_cast<const Raw8<T>*>(raw + j * rs + d0 * sizeof(T));
        } else {
          T* e = reinterpret_cast<T*>(&w);
#pragma unroll
          for (int i = 0; i < 8; ++i) e[i] = zero_of<T>();
        }
        float x[8];
        cvt<T, 8>(&w, x);
        store8<kLo>(hi + j * ld + d0, lo + j * ld + d0, x);
      }
      return;
    }
#pragma unroll 1
    for (int u = tid; u < BN * units; u += kTcThreads) {
      const int j = u / units;
      const int d0 = (u - j * units) * 8;
      const int p = t0 + j;
      const T* src = vec ? reinterpret_cast<const T*>(raw + j * rs) + d0
                         : (p < n_pos ? pool + row_off(p) + col0 + d0 : nullptr);
      const Raw8<T> w = load_unit<T>(src, d0, ncols);
      float x[8];
      cvt<T, 8>(&w, x);
      store8<kLo>(hi + j * ld + d0, lo + j * ld + d0, x);
    }
  };
  auto convert = [&](int t0) {
    convert_matrix(raw_k, L.rk, k_pages, 0, hd, hp >> 3, k_hi, k_lo, ldq, t0);
    convert_matrix(raw_v, L.rv, v_pages, c0, vcols, DC / 8, v_hi, v_lo, ldv, t0);
  };

  __syncthreads();  // bt_s in place
  if (n_tiles > 0) issue(0);  // in flight while q is staged
  cp_async_commit();

  // q, pre-scaled by sm_scale * log2(e) * k_scale (the K dequantization
  // and the exp -> exp2 change of base, folded), as bf16 hi + lo planes;
  // dims past hd and rows past n_rows are 0.  16-byte loads straight to
  // registers, kQU a thread in flight at once; the first tile's barrier
  // publishes the planes.
  const float q_mul = q_scale * ksc;
  // stacked row -> element offset of its q / out row from the (b, kv head)
  // base: row r is query r / group of head h * group + r mod group
  const bool g_pow2 = (group & (group - 1)) == 0;
  const int g_shift = __ffs(group) - 1;
  const size_t bh_off = (static_cast<size_t>(b) * S * H + h * group) * hd;
  auto row_elem = [&](int row) -> size_t {
    const int s = g_pow2 ? row >> g_shift : row / group;
    return bh_off + static_cast<size_t>(s * H + (row - s * group)) * hd;
  };
  auto q_row = [&](int row) -> const float* { return q + row_elem(row); };
  const int q4c = hd >> 2;  // 16-byte chunks of a q row
  if ((hd & 3) == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
      (q4c & (q4c - 1)) == 0 && q4c <= kTcThreads) {
    constexpr int kQU = 8;
    const int cs = __ffs(q4c) - 1;
    const int d = (tid & (q4c - 1)) * 4;
    const int rstep = kTcThreads >> cs;
    for (int r0 = tid >> cs; r0 < kTcRows; r0 += rstep * kQU) {
      float4 v[kQU];
#pragma unroll
      for (int u = 0; u < kQU; ++u) {
        const int r = r0 + u * rstep;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < kTcRows && row0 + r < n_rows)
          v[u] = __ldg(reinterpret_cast<const float4*>(q_row(row0 + r) + d));
      }
#pragma unroll
      for (int u = 0; u < kQU; ++u) {
        const int r = r0 + u * rstep;
        if (r < kTcRows) {
          uint2 hi, lo;
          split2(v[u].x * q_mul, v[u].y * q_mul, hi.x, lo.x);
          split2(v[u].z * q_mul, v[u].w * q_mul, hi.y, lo.y);
          *reinterpret_cast<uint2*>(q_hi + r * ldq + d) = hi;
          *reinterpret_cast<uint2*>(q_lo + r * ldq + d) = lo;
        }
      }
    }
    for (int i = tid; i < kTcRows * (hp - hd); i += kTcThreads) {  // padding dims
      const int r = i / (hp - hd);
      const int dd = hd + i - r * (hp - hd);
      q_hi[r * ldq + dd] = q_lo[r * ldq + dd] = __float2bfloat16(0.f);
    }
  } else {
#pragma unroll 1
    for (int i = tid; i < kTcRows * (hp >> 1); i += kTcThreads) {
      const int r = i / (hp >> 1);
      const int dd = (i - r * (hp >> 1)) * 2;
      const int row = row0 + r;
      const float* qr = row < n_rows ? q_row(row) : nullptr;
      const float x0 = qr && dd < hd ? qr[dd] * q_mul : 0.f;
      const float x1 = qr && dd + 1 < hd ? qr[dd + 1] * q_mul : 0.f;
      uint32_t hi, lo;
      split2(x0, x1, hi, lo);
      *reinterpret_cast<uint32_t*>(q_hi + r * ldq + dd) = hi;
      *reinterpret_cast<uint32_t*>(q_lo + r * ldq + dd) = lo;
    }
  }

  // This warp's rows, the query position of the thread's two rows (-1:
  // a row past n_rows, which attends nothing and is not written)
  const int wrow0 = row0 + wr * 16;
  const bool warp_live = wrow0 < n_rows;
  const int w_last = warp_live ? min(qs + min(wrow0 + 15, n_rows - 1) / group, n_pos - 1) : -1;
  const int ra = wrow0 + g;
  const int rbb = ra + 8;
  const int qpos_a = ra < n_rows ? qs + ra / group : -1;
  const int qpos_b = rbb < n_rows ? qs + rbb / group : -1;
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // ldmatrix row/column offsets of this lane (see the fragment layouts of
  // mma.m16n8k16): A and V (.trans) take rows (lane & 7) + 8 ((lane >> 3)
  // & 1) and columns 8 (lane >> 4); K takes rows (lane & 7) + 8 (lane >> 4)
  // and columns 8 ((lane >> 3) & 1)
  const int lr_a = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lc_a = (lane >> 4) * 8;
  const int lr_k = (lane & 7) + (lane >> 4) * 8;
  const int lc_k = ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* qa_hi = q_hi + (wr * 16 + lr_a) * ldq + lc_a;
  const __nv_bfloat16* qa_lo = q_lo + (wr * 16 + lr_a) * ldq + lc_a;
  const int kp0 = wg * kPW;  // the warp's first position in a tile

  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * BN;
    cp_async_wait<0>();
    __syncthreads();  // tile t staged; every warp is done with tile t - 1's planes
    convert(t0);
    __syncthreads();  // planes of tile t ready; the staging buffers free
    if (t + 1 < n_tiles) issue(t0 + BN);  // in flight during tile t's products
    cp_async_commit();
    const int w0 = t0 + kp0;
    if (w0 > w_last) continue;  // warp-uniform: nothing to attend
    // 16-position groups of the warp's half that hold a position its rows
    // may attend; the rest are masked for every row, and skipped
    const int nl16 = min(kPW / 16, (w_last - w0) / 16 + 1);

    // S = q K^T in log2 units: q_hi K + q_lo K (+ q_hi K_lo for f32
    // pages), each accumulator's two products kNT MMAs apart
    float sc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    const __nv_bfloat16* kb_hi = k_hi + (kp0 + lr_k) * ldq + lc_k;
    const __nv_bfloat16* kb_lo = k_lo + (kp0 + lr_k) * ldq + lc_k;
#pragma unroll 2
    for (int kk = 0; kk < hp; kk += 16) {
      uint32_t ah[4], al[4], bk[kNT / 2][4];
      ldsm_x4(ah, qa_hi + kk);
      ldsm_x4(al, qa_lo + kk);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np)
        if (np < nl16) ldsm_x4(bk[np], kb_hi + np * 16 * ldq + kk);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        if (np < nl16) {
          mma_bf16(sc[2 * np], ah, bk[np][0], bk[np][1]);
          mma_bf16(sc[2 * np + 1], ah, bk[np][2], bk[np][3]);
        }
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        if (np < nl16) {
          mma_bf16(sc[2 * np], al, bk[np][0], bk[np][1]);
          mma_bf16(sc[2 * np + 1], al, bk[np][2], bk[np][3]);
        }
      }
      if constexpr (kLo) {
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np)
          if (np < nl16) ldsm_x4(bk[np], kb_lo + np * 16 * ldq + kk);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          if (np < nl16) {
            mma_bf16(sc[2 * np], ah, bk[np][0], bk[np][1]);
            mma_bf16(sc[2 * np + 1], ah, bk[np][2], bk[np][3]);
          }
        }
      }
    }

    // Online softmax on the accumulator fragments: each row's max over
    // the quad of lanes that share it; masked logits are the finite
    // -1e30 and their weights are re-masked to 0
    float mx_a = kMasked, mx_b = kMasked;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = w0 + j * 8 + 2 * t4 + e;
        sc[j][e] = (p <= qpos_a && p < lim) ? sc[j][e] : kMasked;
        sc[j][2 + e] = (p <= qpos_b && p < lim) ? sc[j][2 + e] : kMasked;
        mx_a = fmaxf(mx_a, sc[j][e]);
        mx_b = fmaxf(mx_b, sc[j][2 + e]);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, o));
    }
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a);
    const float al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = w0 + j * 8 + 2 * t4 + e;
        sc[j][e] = (p <= qpos_a && p < lim) ? exp2f(sc[j][e] - mn_a) : 0.f;
        sc[j][2 + e] = (p <= qpos_b && p < lim) ? exp2f(sc[j][2 + e] - mn_b) : 0.f;
        sum_a += sc[j][e];
        sum_b += sc[j][2 + e];
      }
    }
    l_a = l_a * al_a + sum_a;  // the thread's share; quad-summed at the end
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      acc[j][0] *= al_a;
      acc[j][1] *= al_a;
      acc[j][2] *= al_b;
      acc[j][3] *= al_b;
    }

    // acc += P V: P's accumulator fragments become the A fragments of the
    // product in registers, as p_hi + p_lo (x V_hi, and p_hi x V_lo for
    // f32 pages); groups of positions past nl16 have P = 0 and are skipped
#pragma unroll
    for (int kk = 0; kk < kPW / 16; ++kk) {
      if (kk >= nl16) break;
      uint32_t ph[4], pl[4];
      split2(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split2(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
      const int voff = (kp0 + kk * 16 + lr_a) * ldv + lc_a;
#pragma unroll
      for (int np = 0; np < kDT / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, v_hi + voff + np * 16);
        mma_bf16(acc[2 * np], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * np], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pl, bv[2], bv[3]);
        if constexpr (kLo) {
          ldsm_x4_t(bv, v_lo + voff + np * 16);
          mma_bf16(acc[2 * np], ph, bv[0], bv[1]);
          mma_bf16(acc[2 * np + 1], ph, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // The two groups' (m, l, acc) of each row merge: group 1 leaves its raw
  // acc (over the q planes, rows of ldo floats) and m, l (over bt_s);
  // group 0 folds them into its own and writes out = acc / max(l, 1e-30) *
  // v_scale (the V dequantization, folded) in place.  A row with no valid
  // position has acc = 0 and gives exactly 0.  Where the CTA's columns are
  // a multiple of 4 the tile then leaves as 16-byte row segments.
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, o);
    l_b += __shfl_xor_sync(kFull, l_b, o);
  }
  const bool staged = (vcols & 3) == 0;
  float* o_s = reinterpret_cast<float*>(tc_smem + L.q_hi);
  float* ml_s = reinterpret_cast<float*>(bt_s);  // [kTcRows][m, l]
  const int ldo = DC + 8;  // conflict-free float2 accesses per half warp
  __syncthreads();         // every warp is done with the q planes and bt_s
  if (wg == 1) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lrow = wr * 16 + g + 8 * half;
#pragma unroll
      for (int j = 0; j < kDT; ++j)
        *reinterpret_cast<float2*>(o_s + lrow * ldo + j * 8 + 2 * t4) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      if (t4 == 0) {
        ml_s[lrow * 2] = half ? m_b : m_a;
        ml_s[lrow * 2 + 1] = half ? l_b : l_a;
      }
    }
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lrow = wr * 16 + g + 8 * half;
      const int row = row0 + lrow;
      const float m0 = half ? m_b : m_a;
      const float m1 = ml_s[lrow * 2];
      const float mx = fmaxf(m0, m1);
      const float f0 = exp2f(m0 - mx);
      const float f1 = exp2f(m1 - mx);
      const float l = (half ? l_b : l_a) * f0 + ml_s[lrow * 2 + 1] * f1;
      const float f = vsc / fmaxf(l, 1e-30f);
      float* o = out + c0;
      if (!staged && row < n_rows) o += row_elem(row);
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        const int d = j * 8 + 2 * t4;
        float2* po = reinterpret_cast<float2*>(o_s + lrow * ldo + d);
        const float2 p1 = *po;
        const float x0 = (acc[j][2 * half] * f0 + p1.x * f1) * f;
        const float x1 = (acc[j][2 * half + 1] * f0 + p1.y * f1) * f;
        if (staged) {
          *po = make_float2(x0, x1);
        } else if (row < n_rows) {
          if (d < vcols) o[d] = x0;
          if (d + 1 < vcols) o[d + 1] = x1;
        }
      }
    }
  }
  if (staged) {
    __syncthreads();
    const int c4 = vcols >> 2;
    const bool c4_pow2 = (c4 & (c4 - 1)) == 0;
    const int c4_shift = __ffs(c4) - 1;
#pragma unroll 4
    for (int i = tid; i < kTcRows * c4; i += kTcThreads) {
      const int r = c4_pow2 ? i >> c4_shift : i / c4;
      const int c = (i - r * c4) * 4;
      if (row0 + r < n_rows)
        *reinterpret_cast<float4*>(out + row_elem(row0 + r) + c0 + c) =
            *reinterpret_cast<const float4*>(o_s + r * ldo + c);
    }
  }
}

template <typename T, int DC, int BN>
int launch_tc(const float* q, const void* k_pages, const void* v_pages, const int* bt,
              const int* lengths, const int* q_start, const float* ks, const float* vs,
              float* out, int B, int S, int H, int n_kv, int hd, int page_size,
              int pages_per_seq, cudaStream_t stream) {
  const TcSmem<T, DC, BN> L(hd);
  if (L.total > 232448) return -1;  // the most shared memory a CTA may have
  auto kernel = paged_flash_mq_tc_kernel<T, DC, BN>;
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_rows = S * (H / n_kv);
  const int n_rb = (n_rows + kTcRows - 1) / kTcRows;
  const int n_cb = (hd + DC - 1) / DC;
  const dim3 grid(n_rb * n_cb, n_kv, B);
  kernel<<<grid, kTcThreads, L.total, stream>>>(
      q, static_cast<const T*>(k_pages), static_cast<const T*>(v_pages), bt, lengths,
      q_start, ks, vs, out, S, H, n_kv, hd, page_size, pages_per_seq, n_rb,
      kLog2e / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

// DC: the output columns a CTA holds, hd padded to 16 and rounded up to
// 16, 32, 64 or 128; above 128 dims the output is split into column
// blocks of 128, one CTA each (each computes the whole q K^T)
template <typename T, int BN>
int launch_tc_dc(const float* q, const void* kp, const void* vp, const int* bt,
                 const int* lengths, const int* q_start, const float* ks, const float* vs,
                 float* out, int B, int S, int H, int n_kv, int hd, int page_size,
                 int pages_per_seq, cudaStream_t stream) {
#define PFA_TC(D)                                                                    \
  launch_tc<T, D, BN>(q, kp, vp, bt, lengths, q_start, ks, vs, out, B, S, H, n_kv, hd, \
                      page_size, pages_per_seq, stream)
  if (hd <= 16) return PFA_TC(16);
  if (hd <= 32) return PFA_TC(32);
  if (hd <= 64) return PFA_TC(64);
  return PFA_TC(128);
#undef PFA_TC
}

int launch_tc_dtype(const void* q, const void* k_pages, const void* v_pages,
                    const void* block_tables, const void* lengths, const void* q_start,
                    const void* k_scale, const void* v_scale, void* out, int B, int S,
                    int H, int n_kv, int hd, int page_size, int pages_per_seq,
                    int page_dtype, cudaStream_t st) {
  const float* qf = static_cast<const float*>(q);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* q0 = static_cast<const int*>(q_start);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* o = static_cast<float*>(out);
  switch (page_dtype) {
    case 0:
      return launch_tc_dc<int8_t, 64>(qf, k_pages, v_pages, bt, ln, q0, ks, vs, o, B, S, H,
                                      n_kv, hd, page_size, pages_per_seq, st);
    case 1:
      return launch_tc_dc<__nv_bfloat16, 64>(qf, k_pages, v_pages, bt, ln, q0, ks, vs, o, B,
                                             S, H, n_kv, hd, page_size, pages_per_seq, st);
    case 2:
      return launch_tc_dc<float, 32>(qf, k_pages, v_pages, bt, ln, q0, ks, vs, o, B, S, H,
                                     n_kv, hd, page_size, pages_per_seq, st);
    default:
      return -1;
  }
}

}  // namespace

// Page dtype codes: 0 = int8, 1 = bfloat16, 2 = float32.
// Both entry points return 0 on success, a cudaError_t code after a failed
// launch, or -1 for arguments the kernels do not take (checked again by the
// Python wrapper).

// The tiled kernel of the first port at any shape: the yardstick the
// split and tensor-core kernels are timed and checked beside.
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

// The serving path, one launch per call: the split-KV kernel when
// S * (H / n_kv) <= 16, split over n_splits chunks of `chunk` positions (a
// whole number of pages; n_splits * chunk covers the block table's span,
// n_splits - 1 chunks do not), with workspace `ws` when n_splits > 1:
// [B, n_kv, n_splits, n_rows, hd + 2] f32 partials, then B * n_kv int32
// split counters, which are zeroed here on `stream` before the launch;
// else the tensor-core kernel, which reads no workspace.
extern "C" int paged_flash_mq_launch(const void* q, const void* k_pages,
                                     const void* v_pages, const void* block_tables,
                                     const void* lengths, const void* q_start,
                                     const void* k_scale, const void* v_scale, void* out,
                                     void* ws, int B, int S, int H, int n_kv, int hd,
                                     int page_size, int pages_per_seq, int page_dtype,
                                     int chunk, int n_splits, void* stream) {
  if (hd < 1 || hd > 256 || n_kv < 1 || H % n_kv != 0 || page_size < 1 ||
      pages_per_seq < 1)
    return -1;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rows = S * (H / n_kv);
  if (n_rows > kSplitRows)
    return launch_tc_dtype(q, k_pages, v_pages, block_tables, lengths, q_start, k_scale,
                           v_scale, out, B, S, H, n_kv, hd, page_size, pages_per_seq,
                           page_dtype, st);
  const int span = pages_per_seq * page_size;
  if (chunk < 1 || chunk % page_size != 0 || n_splits < 1 || n_splits > 65535 ||
      static_cast<long long>(n_splits) * chunk < span ||
      static_cast<long long>(n_splits - 1) * chunk >= span)
    return -1;
  if (n_splits > 1 && ws == nullptr) return -1;
  const float* qf = static_cast<const float*>(q);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* q0 = static_cast<const int*>(q_start);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  int* cnt = nullptr;
  if (n_splits > 1) {
    // this call's own counters, stream-ordered like its workspace: two
    // launches on two streams never share one
    cnt = reinterpret_cast<int*>(w + static_cast<size_t>(B) * n_kv * n_splits * n_rows *
                                         (hd + 2));
    const cudaError_t e =
        cudaMemsetAsync(cnt, 0, static_cast<size_t>(B) * n_kv * sizeof(int), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
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
