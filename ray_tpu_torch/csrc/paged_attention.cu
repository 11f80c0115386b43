// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: ray_tpu/ops/paged_attention_kernel.py:paged_attention_kernel
// (Pallas body `_kernel`). Same contract as
// ray_tpu_torch/ops/attention.py:paged_attention: for each row b and query
// head h, attend q[b, s, h] over the cache slots of row b, read through its
// block table bt[b, :] from the pool pages [NB, T, KV, D], with the mask
// `slot <= q_slots[b, s] && slot < kv_valid_len`, an online softmax in f32,
// masked probabilities zeroed explicitly, and a row with no live slot
// written as exactly 0. int8 / fp8-e4m3 pages are dequantized on load with
// the per-(block, kv-head) f32 scales [NB, KV].
//
// What bounds it on this card: memory. Decode reads every live K and V
// slot once per kv head and does 4*D flops per slot per query head (about
// 4 flop per byte at g = 4 query heads per kv head), far below the ~295
// flop/byte the H100 needs before its tensor cores become the limit. The
// least bytes are the K+V pages of the live slots, plus q, out, the
// block-table entries and scales those slots touch. So the design is about
// bytes in flight, blocks enough to fill 132 SMs, and few enough
// instructions per byte that the SMs keep up with the memory.
//
// Design (split-KV, flash-decoding):
// - Two launches in one C call. The split pass runs one block of 4 warps
//   per (split, kv head, row); a split is a contiguous range of
//   `pages_per_split` block-table entries. The host plans the split size
//   and count from static shapes only (MB, T, B, KV and the SM count; see
//   ops/paged_attention_kernel.py:split_plan), so the launch reads nothing
//   from the device. Each block finds its row's live frontier itself
//   (max q_slot + 1, capped by kv_valid_len); a block whose range starts
//   at or past it writes an empty partial (m = -1e30, l = 0) and exits.
// - The block serves the row's g*S query rows of its kv head (r <-> s =
//   r / g, head kv*g + r % g), so each page is read once per kv head (GQA
//   reuse); more rows than one pass holds take further passes over the
//   same pages.
// - Pages arrive by 16-byte cp.async (rows past T zero-filled) into rings
//   in the pool's own type, the next page in flight while the current one
//   is reduced. A slice's rows are D contiguous values at stride KV*D in
//   the pool; in shared memory each row's 16-byte chunks are XOR-swizzled
//   by the row index, so 8 rows' same chunk lie in 8 bank groups.
// - bf16 q over bf16, int8 or fp8 pages (the serving path) takes the
//   tensor cores, paged_decode_mma_kernel: each warp streams its own pages
//   (page j0 + w, j0 + w + 4, ...) through a private ring and keeps its
//   own (m, l, o) for the pass's 16 query rows (one m16 tile, rows past
//   g*S zero). Per 32-slot sub-tile s = q.k^T is mma.sync m16n8k16 (q as
//   bf16 A fragments in registers, k fragments by ldmatrix), the online
//   softmax runs on the accumulator fragments with quad shuffles, p (times
//   v_scale) is converted to bf16 A fragments in registers, and o += p.v
//   takes v fragments by ldmatrix.trans. bf16 operands are exact for bf16
//   q and for int8 / fp8 values (widened to a bf16 page copy per warp);
//   every sum is f32; p is rounded to bf16 as the reference rounds its
//   probabilities to a bf16 pool's type. The 4 warps' states merge exactly
//   in shared memory before the partial is written.
// - f32 q or f32 pages take exact f32 FMAs, paged_decode_fma_kernel: warp
//   w owns query rows w, w+4, ...; lane t owns slot t of a 32-slot
//   sub-tile for the scores (q in shared memory as f32, broadcast reads)
//   and a D/32 slice of the head dim for p.v, the weights broadcast by
//   shuffles; a block-wide ring of up to 4 pages.
// - The combine pass merges the partials (acc, m, l) of each (row, query,
//   head) exactly in f32, in the max-m frame (the rule of
//   ray_tpu/ops/ring_attention.py:_combine); empty partials add nothing,
//   and a row whose every partial is empty gives 0.
// Left for later: f16 operands for one-byte pools (int8 and e4m3 widen
// to f16 in two instructions per pair; their bf16 widening per warp holds
// them at ~18-19% of the byte bound), fusing the combine into the last
// split block of each row, TMA page loads, and a persistent grid that
// balances ragged rows.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's mask fill
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowChunk = 32;  // query rows per pass of the FMA kernel
constexpr int kRowsPerWarp = kRowChunk / kWarps;
constexpr int kMaxStages = 4;  // ring stages of the FMA kernel
constexpr int kMmaRows = 16;   // query rows per pass of the mma kernel
// Ring stages of each mma warp: 1. A second stage halves the blocks an SM
// holds, and measured slower on an H100 at the decode shapes of
// chip_smoke.py (the other warps' pages are in flight meanwhile).
constexpr int kMmaStages = 1;
constexpr int kSub = 32;       // slots per sub-tile of the mma kernel
constexpr size_t kSmemLimit = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

template <int Bytes>
struct Raw;
template <>
struct Raw<2> { typedef uint16_t type; };
template <>
struct Raw<4> { typedef uint32_t type; };
template <>
struct Raw<8> { typedef uint2 type; };
template <>
struct Raw<16> { typedef uint4 type; };

// N consecutive values of type T at p (one aligned vector load of
// N * sizeof(T) bytes), widened to f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  typedef typename Raw<N * sizeof(T)>::type V;
  const V raw = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
// Zero-fills the 16 bytes at dst (no global read).
__device__ __forceinline__ void cp_async16_zero(uint32_t dst,
                                                const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, 0;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most n (0..kMaxStages-1) committed groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// 2 or 4 f32 values to p (one aligned vector store).
__device__ __forceinline__ void store_f32(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_f32(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Dynamic shared memory of an FMA split block: the q rows of one pass in
// f32 and `stages` K+V page slices in the pool's type.
inline size_t fma_smem(int R, int D, int T, int page_item, int stages) {
  return sizeof(float) * (size_t)(R < kRowChunk ? R : kRowChunk) * D +
         (size_t)stages * 2 * T * D * page_item;
}

// Dynamic shared memory of an mma split block: per warp, `stages` K+V
// page slices of T rounded up to 32 rows in the pool's type, and for a
// one-byte pool a bf16 copy of one page. The warps' merge reuses it.
inline size_t mma_smem(int D, int T, int page_item, int stages) {
  const size_t tp = (size_t)(T + kSub - 1) / kSub * kSub;
  return kWarps * (stages * 2 * tp * D * page_item +
                   (page_item == 1 ? 2 * tp * D * 2 : 0));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major fragments) . b (16 x 8,
// bf16, column fragments): thread 4 g + t holds c at rows g, g + 8 and
// columns 2 t, 2 t + 1.
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address
// of row l % 8 of matrix l / 8. .trans delivers each transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// 2^x on the special-function unit (relative error ~2^-22, far inside the
// bf16 rounding of p that follows).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max / sum over the 4 lanes of a quad (the lanes that share a row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename QT, typename PT, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_fma_kernel(const QT* __restrict__ q,
                            const PT* __restrict__ k_pages,
                            const PT* __restrict__ v_pages,
                            const int32_t* __restrict__ block_tables,
                            const int32_t* __restrict__ q_slots,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            float* __restrict__ part_o,
                            float2* __restrict__ part_ml, int S, int H,
                            int KV, int T, int MB, int kv_valid_len,
                            int pages_per_split, int stages, float scale) {
  constexpr int E = 16 / sizeof(PT);   // pool values per 16-byte chunk
  constexpr int C = D / E;             // chunks per page row
  constexpr int kSwz = (C < 8 ? C : 8) - 1;
  constexpr int DL = D / 32;           // head-dim values per lane in p.v
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z;
  const int g = H / KV, R = g * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Partial of query row r: [split][b][s][h].
  auto part = [&](int r) {
    return (((size_t)split * B + b) * S + r / g) * H + kv * g + r % g;
  };

  // Slots at or past `live` are masked for every query of this row.
  int live = 0;
  for (int s = 0; s < S; ++s) live = max(live, q_slots[b * S + s] + 1);
  live = min(live, kv_valid_len);
  const int n_pages = live > 0 ? min(MB, (live + T - 1) / T) : 0;
  const int j0 = split * pages_per_split;
  const int j1 = min(j0 + pages_per_split, n_pages);
  if (j0 >= j1) {  // past the live frontier: an empty partial
    for (int r = threadIdx.x; r < R; r += kThreads)
      part_ml[part(r)] = make_float2(kNegInf, 0.f);
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [min(R, kRowChunk)][D]
  unsigned char* ring = smem + sizeof(float) * min(R, kRowChunk) * D;
  const int slice = T * C * 16;  // bytes of one K or V page slice
  const uint32_t ring_u32 =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const int32_t* bt = block_tables + (size_t)b * MB;

  // cp.async of page j's K and V slices into its stage, one commit group
  // per call (empty past the range, so the group count stays uniform).
  auto issue = [&](int j) {
    if (j < j1) {
      const size_t row0 = (size_t)bt[j] * T * KV + kv;  // slot 0's row
      const uint32_t st = ring_u32 + ((j - j0) % stages) * 2 * slice;
      for (int i = threadIdx.x; i < 2 * T * C; i += kThreads) {
        const int row = i / C, c = i % C;
        const int which = row >= T, t = row - which * T;
        const PT* src = (which ? v_pages : k_pages) +
                        (row0 + (size_t)t * KV) * D + c * E;
        cp_async16(st + which * slice + (t * C + (c ^ (t & kSwz))) * 16, src);
      }
    }
    cp_async_commit();
  };

  for (int rc0 = 0; rc0 < R; rc0 += kRowChunk) {
    const int rn = min(kRowChunk, R - rc0);
    for (int i = threadIdx.x; i < rn * D; i += kThreads) {
      const int r = rc0 + i / D, d = i % D;
      q_s[i] = to_f32(
          q[(((size_t)b * S + r / g) * H + kv * g + r % g) * D + d]);
    }
    // This warp's rows rc0 + warp + 4 i, i < mine (warp-uniform).
    const int mine = rn > warp ? (rn - warp + kWarps - 1) / kWarps : 0;
    float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DL];
    int qslot[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[i][d] = 0.f;
      qslot[i] = i < mine ? q_slots[b * S + (rc0 + warp + kWarps * i) / g]
                          : -1;
    }

    for (int st = 0; st + 1 < stages; ++st) issue(j0 + st);
    for (int j = j0; j < j1; ++j) {
      // the stage refilled here held page j - 1, released by the
      // __syncthreads that ended the previous step
      issue(j + stages - 1);
      cp_async_wait(stages - 1);  // page j has landed (this thread's part)
      __syncthreads();            // ... and every thread's
      const unsigned char* k_st = ring + ((j - j0) % stages) * 2 * slice;
      const unsigned char* v_st = k_st + slice;
      const int phys = bt[j];
      const float ks =
          scale * (k_scale != nullptr ? k_scale[phys * KV + kv] : 1.f);
      const float vs = v_scale != nullptr ? v_scale[phys * KV + kv] : 1.f;

      for (int t0 = 0; t0 < T; t0 += 32) {
        const int t = t0 + lane;
        float sc[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
        if (t < T) {
#pragma unroll 4
          for (int c = 0; c < C; ++c) {
            float kf[E];
            load_f32<PT, E>(reinterpret_cast<const PT*>(
                                k_st + (t * C + (c ^ (t & kSwz))) * 16),
                            kf);
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) {
              if (i < mine) {
                const float4* qr = reinterpret_cast<const float4*>(
                    q_s + (warp + kWarps * i) * D + c * E);
#pragma unroll
                for (int e4 = 0; e4 < E / 4; ++e4) {
                  const float4 qv = qr[e4];
                  sc[i] += qv.x * kf[4 * e4] + qv.y * kf[4 * e4 + 1] +
                           qv.z * kf[4 * e4 + 2] + qv.w * kf[4 * e4 + 3];
                }
              }
            }
          }
        }
        const int slot = j * T + t;
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          if (i < mine) {
            const bool ok =
                t < T && slot <= qslot[i] && slot < kv_valid_len;
            const float x = ok ? sc[i] * ks : kNegInf;
            const float m_new = fmaxf(m[i], warp_max(x));
            // explicit zero: with m still at -1e30 a masked score would
            // otherwise give exp(0) == 1
            const float p = ok ? expf(x - m_new) : 0.f;
            const float alpha = expf(m[i] - m_new);
            l[i] = l[i] * alpha + warp_sum(p);
            m[i] = m_new;
#pragma unroll
            for (int d = 0; d < DL; ++d) acc[i][d] *= alpha;
            sc[i] = p * vs;  // the weight of v slot t in p.v
          }
        }
        const int tn = min(32, T - t0);
        const int off = lane * DL * (int)sizeof(PT);  // lane's bytes in a row
        for (int tt = 0; tt < tn; ++tt) {
          const int vt = t0 + tt;
          float vf[DL];
          load_f32<PT, DL>(
              reinterpret_cast<const PT*>(
                  v_st + (vt * C + ((off >> 4) ^ (vt & kSwz))) * 16 +
                  (off & 15)),
              vf);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            if (i < mine) {
              const float w = __shfl_sync(0xffffffffu, sc[i], tt);
#pragma unroll
              for (int d = 0; d < DL; ++d) acc[i][d] += w * vf[d];
            }
          }
        }
      }
      __syncthreads();  // every thread is done with page j's stage
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (i < mine) {
        const size_t pi = part(rc0 + warp + kWarps * i);
        store_f32(part_o + pi * D + lane * DL, acc[i]);
        if (lane == 0) part_ml[pi] = make_float2(m[i], l[i]);
      }
    }
  }
}

// Tensor-core split pass (bf16 q; bf16, int8 or fp8 pages). Shared
// memory per warp: `stages` raw K+V slices of Tp = T rounded up to 32
// rows, then (one-byte pools) a bf16 K+V copy of the current page.
template <typename PT, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const PT* __restrict__ k_pages,
                            const PT* __restrict__ v_pages,
                            const int32_t* __restrict__ block_tables,
                            const int32_t* __restrict__ q_slots,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            float* __restrict__ part_o,
                            float2* __restrict__ part_ml, int S, int H,
                            int KV, int T, int MB, int kv_valid_len,
                            int pages_per_split, int stages, float scale) {
  constexpr bool kQuant = sizeof(PT) == 1;
  constexpr int E = 16 / sizeof(PT);  // pool values per 16-byte chunk
  constexpr int C = D / E;            // chunks per raw page row
  constexpr int kSwz = (C < 8 ? C : 8) - 1;
  constexpr int CB = D / 8;           // chunks per bf16 page row (>= 8)
  constexpr int NT = D / 8;           // n-tiles of o
  constexpr int KS = D / 16;          // k-steps of s
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z;
  const int grp = H / KV, R = grp * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto part = [&](int r) {
    return (((size_t)split * B + b) * S + r / grp) * H + kv * grp + r % grp;
  };

  int live = 0;
  for (int s = 0; s < S; ++s) live = max(live, q_slots[b * S + s] + 1);
  live = min(live, kv_valid_len);
  const int n_pages = live > 0 ? min(MB, (live + T - 1) / T) : 0;
  const int j0 = split * pages_per_split;
  const int j1 = min(j0 + pages_per_split, n_pages);
  if (j0 >= j1) {  // past the live frontier: an empty partial
    for (int r = threadIdx.x; r < R; r += kThreads)
      part_ml[part(r)] = make_float2(kNegInf, 0.f);
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  const int Tp = (T + kSub - 1) / kSub * kSub;
  const int slice = Tp * C * 16;    // bytes of a raw K or V slice
  const int slice_b = Tp * CB * 16;  // bytes of a bf16 K or V slice
  const int warp_bytes = stages * 2 * slice + (kQuant ? 2 * slice_b : 0);
  const uint32_t ring = smem_u32(smem) + warp * warp_bytes;
  const int32_t* bt = block_tables + (size_t)b * MB;
  // This warp's pages: j0 + warp + 4 i, i < np.
  const int np = j1 - j0 > warp ? (j1 - j0 - warp + kWarps - 1) / kWarps : 0;

  // cp.async of this warp's i-th page into stage i % stages (one commit
  // group per call, empty past the warp's pages). Lane l copies chunk
  // l % C of rows l / C, l / C + 32 / C, ... of the K and V slices.
  constexpr int kRowStep = 32 / C;
  const int my_c = lane % C, my_r = lane / C;
  const size_t src_step = (size_t)kRowStep * KV * D;
  auto issue = [&](int i) {
    if (i < np) {
      const size_t off = ((size_t)bt[j0 + warp + kWarps * i] * T * KV + kv) *
                             D + my_c * E + (size_t)my_r * KV * D;
      const PT* k_src = k_pages + off;
      const PT* v_src = v_pages + off;
      const uint32_t st = ring + (i % stages) * 2 * slice;
      int r = my_r;
      for (; r < T; r += kRowStep, k_src += src_step, v_src += src_step) {
        const uint32_t dst = st + (r * C + (my_c ^ (r & kSwz))) * 16;
        cp_async16(dst, k_src);
        cp_async16(dst + slice, v_src);
      }
      for (; r < Tp; r += kRowStep) {  // rows past T read as zeros
        const uint32_t dst = st + (r * C + (my_c ^ (r & kSwz))) * 16;
        cp_async16_zero(dst, k_pages);
        cp_async16_zero(dst + slice, k_pages);
      }
    }
    cp_async_commit();
  };

  for (int rc0 = 0; rc0 < R; rc0 += kMmaRows) {
    const int rn = min(kMmaRows, R - rc0);
    // q rows rc0 + g and rc0 + g + 8 as bf16 A fragments (zero past rn)
    uint32_t qa[KS][4];
    int qslot[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = g + 8 * h2;
      const __nv_bfloat16* qr =
          q + (((size_t)b * S + (rc0 + r) / grp) * H + kv * grp +
               (rc0 + r) % grp) * D;
      qslot[h2] = r < rn ? q_slots[b * S + (rc0 + r) / grp] : -1;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qa[kk][h2] = r < rn ? *reinterpret_cast<const uint32_t*>(
                                  qr + 16 * kk + 2 * t)
                            : 0u;
        qa[kk][h2 + 2] = r < rn ? *reinterpret_cast<const uint32_t*>(
                                      qr + 16 * kk + 8 + 2 * t)
                                : 0u;
      }
    }
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int i = 0; i + 1 < stages; ++i) issue(i);
    for (int i = 0; i < np; ++i) {
      issue(i + stages - 1);  // into the stage page i - 1 released
      cp_async_wait(stages - 1);
      __syncwarp();
      const int j = j0 + warp + kWarps * i;
      uint32_t kb = ring + (i % stages) * 2 * slice, vb = kb + slice;
      if constexpr (kQuant) {
        // widen the page to bf16 (exact for int8 and e4m3 values), each
        // lane the chunks it copied
        const uint32_t cb = ring + stages * 2 * slice;
        const unsigned char* raw = smem + (kb - smem_u32(smem));
        unsigned char* wide = smem + (cb - smem_u32(smem));
        for (int r = my_r; r < Tp; r += kRowStep) {
#pragma unroll
          for (int which = 0; which < 2; ++which) {
            float f[16];
            load_f32<PT, 16>(reinterpret_cast<const PT*>(
                                 raw + which * slice +
                                 (r * C + (my_c ^ (r & kSwz))) * 16),
                             f);
            uint32_t w[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              w[e] = pack_bf16(f[2 * e], f[2 * e + 1]);
            unsigned char* row = wide + which * slice_b + r * CB * 16;
            *reinterpret_cast<uint4*>(row + ((2 * my_c) ^ (r & 7)) * 16) =
                make_uint4(w[0], w[1], w[2], w[3]);
            *reinterpret_cast<uint4*>(row + ((2 * my_c + 1) ^ (r & 7)) * 16) =
                make_uint4(w[4], w[5], w[6], w[7]);
          }
        }
        __syncwarp();
        kb = cb;
        vb = cb + slice_b;
      }
      const int phys = bt[j];
      // scores in log2 units: scale * k_scale * log2 e folded in
      const float ks2 = scale * kLog2e *
                        (k_scale != nullptr ? k_scale[phys * KV + kv] : 1.f);
      const float vs = v_scale != nullptr ? v_scale[phys * KV + kv] : 1.f;
      // the (slot, chunk) address of a bf16 slice
      auto at = [&](uint32_t sb, int slot, int chunk) {
        return sb + (slot * CB + (chunk ^ (slot & 7))) * 16;
      };

      for (int t0 = 0; t0 < T; t0 += kSub) {
        float sc[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int n2 = 0; n2 < 4; n2 += 2) {
            uint32_t kf[4];
            const int mat = lane >> 3;
            ldmatrix_x4(kf, at(kb, t0 + 8 * (n2 + (mat >> 1)) + (lane & 7),
                               2 * kk + (mat & 1)));
            mma_16816(sc[n2], qa[kk], kf[0], kf[1]);
            mma_16816(sc[n2 + 1], qa[kk], kf[2], kf[3]);
          }
        }
        // online softmax on the fragments: rows g (e < 2) and g + 8
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = t0 + 8 * n + 2 * t + (e & 1);
            const int slot = j * T + col;
            const bool ok = col < T && slot <= qslot[e >> 1] &&
                            slot < kv_valid_len;
            sc[n][e] = ok ? sc[n][e] * ks2 : kNegInf;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
          }
        }
        float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          mx[h2] = quad_max(mx[h2]);
          alpha[h2] = fast_exp2(m[h2] - mx[h2]);
          m[h2] = mx[h2];
        }
        uint32_t pa[2][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // explicit zero: with m still at -1e30 a masked score would
            // otherwise give exp(0) == 1
            p[e] = sc[n][e] > kNegInf * 0.5f
                       ? fast_exp2(sc[n][e] - mx[e >> 1])
                       : 0.f;
            psum[e >> 1] += p[e];
          }
          pa[n >> 1][2 * (n & 1)] = pack_bf16(p[0] * vs, p[1] * vs);
          pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(p[2] * vs, p[3] * vs);
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          l[h2] = l[h2] * alpha[h2] + quad_sum(psum[h2]);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
        // o += p . v, v fragments transposed from the [slot][d] rows
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int nd = 0; nd < NT; nd += 2) {
            uint32_t vf[4];
            const int mat = lane >> 3;
            ldmatrix_x4_trans(vf, at(vb, t0 + 16 * kk + 8 * (mat & 1) +
                                             (lane & 7),
                                     nd + (mat >> 1)));
            mma_16816(acc[nd], pa[kk], vf[0], vf[1]);
            mma_16816(acc[nd + 1], pa[kk], vf[2], vf[3]);
          }
        }
      }
      __syncwarp();  // every lane is done with the stage before refilling
    }

    // Merge the 4 warps' states in shared memory (the rings are free once
    // every warp is here): [4][16][D] f32 o, then [4][16] m and l.
    __syncthreads();
    float* mo = reinterpret_cast<float*>(smem);
    float* mm = mo + kWarps * kMmaRows * D;
    float* ml = mm + kWarps * kMmaRows;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mo[(warp * kMmaRows + g + 8 * (e >> 1)) * D + 8 * n + 2 * t +
           (e & 1)] = acc[n][e];
    if (t == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mm[warp * kMmaRows + g + 8 * h2] = m[h2];
        ml[warp * kMmaRows + g + 8 * h2] = l[h2];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rn * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mm[w * kMmaRows + r]);
      float L = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = mm[w * kMmaRows + r];
        if (mw > kNegInf * 0.5f) {
          const float wt = fast_exp2(mw - M);
          L += ml[w * kMmaRows + r] * wt;
          o += mo[(w * kMmaRows + r) * D + d] * wt;
        }
      }
      const size_t pi = part(rc0 + r);
      part_o[pi * D + d] = o;
      if (d == 0)  // m back in natural-log units for the combine pass
        part_ml[pi] =
            make_float2(M > kNegInf * 0.5f ? M * kLn2 : kNegInf, L);
    }
    __syncthreads();  // the merge area is the next pass's rings
  }
}

// One warp per (row, query, head): the exact f32 merge of its `splits`
// partials in the frame of their largest m.
template <typename QT, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_combine_kernel(const float* __restrict__ part_o,
                                const float2* __restrict__ part_ml,
                                QT* __restrict__ out, int rows, int splits) {
  constexpr int DL = D / 32;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float M = kNegInf;
  for (int i = lane; i < splits; i += 32)
    M = fmaxf(M, part_ml[(size_t)i * rows + row].x);
  M = warp_max(M);
  const bool live = M > kNegInf * 0.5f;
  float L = 0.f, o[DL];
#pragma unroll
  for (int d = 0; d < DL; ++d) o[d] = 0.f;
  // An empty partial adds nothing; its o was never written, so it is
  // read and then dropped by the select, never multiplied.
#pragma unroll 4
  for (int i = 0; i < splits; ++i) {
    const float2 ml = part_ml[(size_t)i * rows + row];
    float po[DL];
    load_f32<float, DL>(part_o + ((size_t)i * rows + row) * D + lane * DL, po);
    const bool used = ml.x > kNegInf * 0.5f;
    const float w = used ? expf(ml.x - M) : 0.f;
    L += used ? ml.y * w : 0.f;
#pragma unroll
    for (int d = 0; d < DL; ++d) o[d] += used ? w * po[d] : 0.f;
  }
  QT* dst = out + (size_t)row * D + lane * DL;
#pragma unroll
  for (int d = 0; d < DL; ++d) store(dst + d, live ? o[d] / L : 0.f);
}

struct Args {
  const void *q, *k_pages, *v_pages, *block_tables, *q_slots, *k_scale,
      *v_scale;
  void *out, *part_o, *part_ml;
  int B, S, H, KV, T, MB, kv_valid_len, pages_per_split, splits;
  float scale;
};

// The split pass an instance takes, and its ring stages (the most up to
// the kernel's cap that fit the shared memory; 0 when none does).
struct Plan {
  bool mma;
  int stages;
  size_t smem;
};

template <typename QT, typename PT, int D>
Plan plan(int R, int T) {
  const bool mma = sizeof(QT) == 2 && sizeof(PT) < 4;
  for (int st = mma ? kMmaStages : kMaxStages; st >= 1; --st) {
    const size_t smem = mma ? mma_smem(D, T, sizeof(PT), st)
                            : fma_smem(R, D, T, sizeof(PT), st);
    if (smem <= kSmemLimit) return Plan{mma, st, smem};
  }
  return Plan{mma, 0, 0};
}

template <typename QT, typename PT>
using SplitKernel = void (*)(const QT*, const PT*, const PT*, const int32_t*,
                             const int32_t*, const float*, const float*,
                             float*, float2*, int, int, int, int, int, int,
                             int, int, float);

template <typename QT, typename PT>
cudaError_t launch_split(SplitKernel<QT, PT> kernel, const Args& a,
                         const Plan& p, cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.splits, a.KV, a.B), kThreads, p.smem, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const PT*>(a.k_pages),
      static_cast<const PT*>(a.v_pages),
      static_cast<const int32_t*>(a.block_tables),
      static_cast<const int32_t*>(a.q_slots),
      static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<float*>(a.part_o),
      static_cast<float2*>(a.part_ml), a.S, a.H, a.KV, a.T, a.MB,
      a.kv_valid_len, a.pages_per_split, p.stages, a.scale);
  return cudaGetLastError();
}

template <typename QT, typename PT, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.splits < 1 || a.pages_per_split < 1) return cudaErrorInvalidValue;
  const int R = (a.H / a.KV) * a.S;
  const Plan p = plan<QT, PT, D>(R, a.T);
  if (p.stages == 0) return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (sizeof(QT) == 2 && sizeof(PT) < 4) {
    err = launch_split<QT, PT>(paged_decode_mma_kernel<PT, D>, a, p, stream);
  } else {
    err = launch_split<QT, PT>(paged_decode_fma_kernel<QT, PT, D>, a, p,
                               stream);
  }
  if (err != cudaSuccess) return err;
  const int rows = a.B * a.S * a.H;
  paged_decode_combine_kernel<QT, D>
      <<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          static_cast<const float*>(a.part_o),
          static_cast<const float2*>(a.part_ml), static_cast<QT*>(a.out),
          rows, a.splits);
  return cudaGetLastError();
}

// The two things the C interface does with an instance.
struct Launch {
  const Args& a;
  cudaStream_t stream;
  template <typename QT, typename PT, int D>
  int run() const {
    return (int)launch<QT, PT, D>(a, stream);
  }
};
struct Smem {
  int R, T;
  int* mma;
  template <typename QT, typename PT, int D>
  size_t run() const {
    const Plan p = plan<QT, PT, D>(R, T);
    *mma = p.mma ? 1 : 0;
    return p.stages > 0 ? p.smem : 0;
  }
};

// f.run<QT, PT, D>() for the instance of the type codes and head dim, or
// `bad`.
template <typename F, typename Ret>
Ret dispatch(int q_dtype, int page_dtype, int D, Ret bad, const F& f) {
  auto by_d = [&](auto qt, auto pt) -> Ret {
    using QT = decltype(qt);
    using PT = decltype(pt);
    if (D == 64) return f.template run<QT, PT, 64>();
    if (D == 128) return f.template run<QT, PT, 128>();
    return bad;
  };
  auto by_p = [&](auto qt) -> Ret {
    switch (page_dtype) {
      case 0: return by_d(qt, float{});
      case 1: return by_d(qt, __nv_bfloat16{});
      case 2: return by_d(qt, int8_t{});
      case 3: return by_d(qt, __nv_fp8_e4m3{});
      default: return bad;
    }
  };
  switch (q_dtype) {
    case 0: return by_p(float{});
    case 1: return by_p(__nv_bfloat16{});
    default: return bad;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 float8_e4m3fn. q and out
// share q_dtype (0 or 1). k_scale / v_scale may be null for a float pool.
// Every buffer is contiguous and 16-byte aligned. part_o [splits, B, S, H,
// D] and part_ml [splits, B, S, H, 2] are float32 scratch the caller
// allocates. Launches the split pass and then the combine pass on
// `stream` and returns the first cudaError_t that is not 0 (0 on
// success); the kernels allocate nothing and do not synchronise.
int ray_tpu_torch_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* q_slots, const void* k_scale,
    const void* v_scale, void* out, void* part_o, void* part_ml,
    int q_dtype, int page_dtype, int B, int S, int H, int KV, int D, int T,
    int MB, int kv_valid_len, int pages_per_split, int splits, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q,       k_pages, v_pages, block_tables, q_slots,
               k_scale, v_scale, out,     part_o,       part_ml,
               B,       S,       H,       KV,           T,
               MB,      kv_valid_len,     pages_per_split,
               splits,  scale};
  return dispatch(q_dtype, page_dtype, D, (int)cudaErrorInvalidValue,
                  Launch{a, st});
}

// Dynamic shared memory of the split block the call above would launch
// for R = g*S query rows (0 if no ring fits); *mma is set to 1 when that
// is the tensor-core kernel.
size_t ray_tpu_torch_paged_attention_smem(int q_dtype, int page_dtype,
                                          int R, int D, int T, int* mma) {
  *mma = 0;
  return dispatch(q_dtype, page_dtype, D, (size_t)0, Smem{R, T, mma});
}

const char* ray_tpu_torch_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
