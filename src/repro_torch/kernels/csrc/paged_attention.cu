// Paged flash attention over a block-table KV pool, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `paged_flash_mq` of
// src/repro/kernels/paged_attention.py (body `_kernel`): flash attention of
// an S-query block over a paged KV pool whose K/V are dequantized on load by
// a per-(batch row, kv head) scale.  The S·group query rows of one kv head
// are stacked; row r sits at absolute position q_start[b] + r / group and
// attends positions p with p <= its position and p < lengths[b].  Online
// softmax at scale 1/sqrt(hd), masked logits = -1e30, weights re-masked to
// 0, output acc / max(l, 1e-30), so a row with no valid position gives 0.
//
// What bounds it on an H100: the bytes of K/V streamed from device memory
// (1 B/elem for int8 pages, 2 for bf16).  At decode batch sizes (B = 4,
// S = 1) the grid is only B * n_kv CTAs of a few hundred KB of K/V in all,
// so the launch overhead and the latency of the first page loads dominate.
// What this first version does about it:
//   * every K/V element is read from device memory once per CTA, in
//     16-byte vector loads all issued before any is consumed (a scalar
//     load loop serializes their latencies), and
//     dequantized into shared memory as f32, so int8 pools stream at
//     1 B/elem and QK / AV run in f32 (matching the f32 reference);
//   * the page loop stops after the last position any row of the CTA may
//     attend: min(lengths[b], q_start[b] + last_row / group + 1).  This is
//     exact, not an approximation: a fully masked tile leaves m, l and acc
//     unchanged, because its weights are re-masked to 0 and alpha =
//     exp(m - max(m, -1e30)) = 1;
//   * one CTA serves up to kRows query rows of one (b, kv head), so a
//     prefill bucket of 128 rows is tiled over several CTAs instead of one
//     tile of S·group rows as on the TPU.
// Splitting the page axis across CTAs for decode (flash decoding), TMA
// loads and tensor-core QK / AV are left for later work.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//         -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
// The plain C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// Page dtype codes: 0 = int8, 1 = bfloat16, 2 = float32.
// Returns 0 on success, a cudaError_t code after a failed launch, or -1 for
// arguments the kernel does not take (checked again by the Python wrapper).
extern "C" int paged_flash_mq_launch(const void* q, const void* k_pages,
                                     const void* v_pages, const void* block_tables,
                                     const void* lengths, const void* q_start,
                                     const void* k_scale, const void* v_scale, void* out,
                                     int B, int S, int H, int n_kv, int hd, int page_size,
                                     int pages_per_seq, int page_dtype, void* stream) {
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
