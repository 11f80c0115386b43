// Flash attention for Hopper (sm_90a): forward (with the row logsumexp) and
// the two backward kernels, plain C interface for ctypes.
//
// Instances served here: f32 inputs only, for all three kernels (exact
// f32 FMAs: wgmma has no exact f32 form). Every bf16 kernel (forward, dq
// and dk/dv) is a wgmma kernel in flash_attention_sm90.cu.
//
// Replaces, in ray_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _flash_fwd (Pallas bodies _fwd_kernel and
//                           _fwd_kernel_lse)                      [B1]
//   flash_bwd_dq_kernel  <- _flash_bwd's dq call (_bwd_dq_kernel) [B3a]
//   flash_bwd_dkv_kernel <- _flash_bwd's dk/dv call (_bwd_dkv_kernel) plus
//                           the GQA group sum after it            [B3b]
// Same contract as ray_tpu_torch/ops/flash_attention.py's plain versions:
// q [B,H,Sq,D], k/v [B,Hkv,Sk,D] (GQA: q head h reads kv head h/(H/Hkv)),
// causal mask `q_offset + qi >= ki` with q_offset = Sk - Sq, -1e30 fills,
// m/l/acc in f32, a fully masked row written as exactly 0 (row_live =
// m > -5e29) and, in the backward, p = 0 where lse <= -5e29. Roundings
// follow the Pallas kernels: p to v's type before p.v, p to dO's type
// before p^T.dO, ds to k's type before ds.k and to q's type before ds^T.q.
//
// What bounds them on this card: operations. At the training shapes
// (B=8, H=12, S=2048, D=128, causal) the forward does 2 products of
// ~51.5 GFLOP over ~200 MB of q/k/v/o: ~500 flop per byte, above the
// ~295 flop/byte where the H100's bf16 tensor cores, not its memory,
// become the limit. The backward recomputes s and p and does 5 products.
//
// Design (simple and right first):
// - One thread block of 4 warps per (q tile of 64 rows, q head, batch) in
//   the forward and dq kernels, and per (kv tile of 64 rows, kv head,
//   batch) in the dk/dv kernel. Each warp owns 16 rows, in the fragment
//   layout of mma.sync m16n8k16, computed with exact f32 FMAs (no TF32).
//   A loop inside the block replaces the TPU kernel's sequential grid
//   axis: over kv tiles up to the causal limit (forward, dq), over the q
//   tiles from the causal start and over the GQA group's q heads (dk/dv,
//   so the [B,H,Sk,D] per-head intermediate and its group sum disappear).
// - Tiles are staged in shared memory, each in the layout its product
//   reads: row-major [rows][D] and transposed [D][rows] copies, with rows
//   padded by 16 bytes so the fragment loads do not collide in banks.
//   Every product is C[16 x N] += A[16 x K] . Bt[N x K]^T with A and Bt
//   row-major in shared memory (warp_mma); probabilities and ds go
//   through a per-warp shared tile.
// - Rows and columns past Sq / Sk are staged as zeros and masked by
//   global index; nothing is padded in device memory.
// The kernels keep the input type T as a template parameter; only the f32
// instances are built.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' mask fill
constexpr int kThreads = 128;      // 4 warps of 16 rows each
constexpr int kRowsPerWarp = 16;
constexpr int kTile = 64;          // q rows (fwd, dq) / kv rows (dk/dv)
constexpr int kTileQ_dkv = 32;     // q rows per step of the dk/dv loop

// 16 bytes of padding per shared row: 8 bf16 or 4 floats.
template <typename T>
constexpr int pad() { return 16 / (int)sizeof(T); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Fragment ownership (the mma.sync m16n8k16 accumulator layout): lane =
// 4*g + t holds, for n-tile n, entries e = 0..3 at
// row g + 8*(e >> 1), column 8*n + 2*t + (e & 1).
//
// acc[n][e] += sum_k A[row][k] * Bt[col][k] over k < K, with A [16][lda]
// and Bt [8*NT][ldb] row-major in shared memory.
template <int NT, int K>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* A,
                                         int lda, const float* Bt, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float b0 = Bt[(8 * n + 2 * t) * ldb + k];
      const float b1 = Bt[(8 * n + 2 * t + 1) * ldb + k];
      acc[n][0] = fmaf(a0, b0, acc[n][0]);
      acc[n][1] = fmaf(a0, b1, acc[n][1]);
      acc[n][2] = fmaf(a1, b0, acc[n][2]);
      acc[n][3] = fmaf(a1, b1, acc[n][3]);
    }
  }
}

// dst[r][d] = src[row0 + r][d] for r < R (zero where row0 + r >= S);
// src is one [S, D] head slice, dst has row stride ld. 16-byte copies.
template <typename T, int R, int D>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           int row0, int S) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kChunks = D / V;
  for (int c = threadIdx.x; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks, d = (c % kChunks) * V;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      x = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + d);
    *reinterpret_cast<uint4*>(dst + r * ld + d) = x;
  }
}

// dst[d][r] = src[row0 + r][d] (the transposed tile), zero past S. Lanes
// walk r fastest so the scattered shared stores fall in distinct banks.
template <typename T, int R, int D>
__device__ __forceinline__ void stage_cols(T* dst, int ld, const T* src,
                                           int row0, int S) {
  constexpr int V = 16 / sizeof(T);
  for (int c = threadIdx.x; c < R * (D / V); c += kThreads) {
    const int r = c % R, d = (c / R) * V;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      x = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + d);
    const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int i = 0; i < V; ++i) dst[(d + i) * ld + r] = e[i];
  }
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

// Number of kv tiles of kTile columns that the q tile [q0, q0 + kTile)
// reaches: all of them, or up to the causal limit of its last row
// (_block_contributes).
__device__ __forceinline__ int kv_tiles(int q0, int q_offset, int Sk,
                                        bool causal) {
  int n = (Sk + kTile - 1) / kTile;
  if (causal) {
    const int last = q_offset + q0 + kTile - 1;
    n = last < 0 ? 0 : min(n, last / kTile + 1);
  }
  return n;
}

// ---------------------------------------------------------------- forward

template <typename T, int D>
struct FwdSmem {
  static constexpr int LD = D + pad<T>();       // q, k rows
  static constexpr int LDT = kTile + pad<T>();  // v^T rows and p rows
  static constexpr size_t bytes =
      sizeof(T) * ((size_t)2 * kTile * LD + (size_t)D * LDT +
                   (size_t)kTile * LDT);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                     float scale, int causal) {
  using Sm = FwdSmem<T, D>;
  constexpr int LD = Sm::LD, LDT = Sm::LDT;
  // Heaviest causal tiles (the last q rows) start first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kTile;
  const int q_offset = Sk - Sq;
  const size_t qh = (size_t)b * H + h, kh = (size_t)b * Hkv + hk;
  const T* qp = q + qh * Sq * D;
  const T* kp = k + kh * Sk * D;
  const T* vp = v + kh * Sk * D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [kTile][LD]
  T* k_s = q_s + kTile * LD;                // [kTile][LD]
  T* vt_s = k_s + kTile * LD;               // [D][LDT]
  T* p_s = vt_s + D * LDT;                  // [kTile][LDT]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * kRowsPerWarp;  // this warp's first row in the tile

  stage_rows<T, kTile, D>(q_s, LD, qp, q0, Sq);
  const int n_kv = kv_tiles(q0, q_offset, Sk, causal != 0);

  float acc[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();  // q staged; the previous k/v tile fully read
    stage_rows<T, kTile, D>(k_s, LD, kp, j * kTile, Sk);
    stage_cols<T, kTile, D>(vt_s, LDT, vp, j * kTile, Sk);
    __syncthreads();

    float s[kTile / 8][4] = {};
    warp_mma<kTile / 8, D>(s, q_s + r0 * LD, LD, k_s, LD);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + r0 + g + 8 * (e >> 1);
        const int ki = j * kTile + 8 * n + 2 * t + (e & 1);
        const bool ok = ki < Sk && (!causal || q_offset + qi >= ki);
        s[n][e] = ok ? s[n][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float m_new[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new[r]);
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_new[e >> 1]);
        psum[e >> 1] += p;
        p_s[(r0 + g + 8 * (e >> 1)) * LDT + 8 * n + 2 * t + (e & 1)] =
            from_f32<T>(p);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + quad_sum(psum[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    }
    __syncwarp();
    warp_mma<D / 8, kTile>(acc, p_s + r0 * LDT, LDT, vt_s, LDT);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= Sq) continue;
    const float lr = l[r] == 0.f ? 1.f : l[r];
    const bool live = m[r] > kNegInf * 0.5f;
    T* orow = o + (qh * Sq + qi) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
        orow[8 * n + 2 * t + c] =
            from_f32<T>(live ? acc[n][2 * r + c] / lr : 0.f);
    }
    if (lse != nullptr && t == 0) lse[qh * Sq + qi] = m[r] + logf(lr);
  }
}

// --------------------------------------------------------------------- dq

template <typename T, int D>
struct DqSmem {
  static constexpr int LD = D + pad<T>();       // q, dO, k, v rows
  static constexpr int LDT = kTile + pad<T>();  // k^T rows and ds rows
  static constexpr size_t bytes =
      sizeof(T) * ((size_t)4 * kTile * LD + (size_t)D * LDT +
                   (size_t)kTile * LDT);
};

template <typename T, typename OT, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, OT* __restrict__ dq,
                        int H, int Hkv, int Sq, int Sk, float scale,
                        int causal) {
  using Sm = DqSmem<T, D>;
  constexpr int LD = Sm::LD, LDT = Sm::LDT;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kTile;
  const int q_offset = Sk - Sq;
  const size_t qh = (size_t)b * H + h, kh = (size_t)b * Hkv + hk;
  const T* kp = k + kh * Sk * D;
  const T* vp = v + kh * Sk * D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [kTile][LD]
  T* do_s = q_s + kTile * LD;               // [kTile][LD]
  T* k_s = do_s + kTile * LD;               // [kTile][LD]
  T* v_s = k_s + kTile * LD;                // [kTile][LD]
  T* kt_s = v_s + kTile * LD;               // [D][LDT]
  T* ds_s = kt_s + D * LDT;                 // [kTile][LDT]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * kRowsPerWarp;

  stage_rows<T, kTile, D>(q_s, LD, q + qh * Sq * D, q0, Sq);
  stage_rows<T, kTile, D>(do_s, LD, dout + qh * Sq * D, q0, Sq);
  // This lane's two rows: their lse and delta (rows past Sq get p = 0).
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    row_lse[r] = qi < Sq ? lse[qh * Sq + qi] : kNegInf;
    row_delta[r] = qi < Sq ? delta[qh * Sq + qi] : 0.f;
  }
  const int n_kv = kv_tiles(q0, q_offset, Sk, causal != 0);

  float acc[D / 8][4] = {};
  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();
    stage_rows<T, kTile, D>(k_s, LD, kp, j * kTile, Sk);
    stage_rows<T, kTile, D>(v_s, LD, vp, j * kTile, Sk);
    stage_cols<T, kTile, D>(kt_s, LDT, kp, j * kTile, Sk);
    __syncthreads();

    float p[kTile / 8][4] = {};
    warp_mma<kTile / 8, D>(p, q_s + r0 * LD, LD, k_s, LD);
    float dp[kTile / 8][4] = {};
    warp_mma<kTile / 8, D>(dp, do_s + r0 * LD, LD, v_s, LD);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qi = q0 + r0 + g + 8 * r;
        const int ki = j * kTile + 8 * n + 2 * t + (e & 1);
        const bool ok = ki < Sk && (!causal || q_offset + qi >= ki);
        const float s = ok ? p[n][e] * scale : kNegInf;
        const float pe =
            row_lse[r] <= kNegInf * 0.5f ? 0.f : expf(s - row_lse[r]);
        const float ds = pe * (dp[n][e] - row_delta[r]) * scale;
        ds_s[(r0 + g + 8 * r) * LDT + 8 * n + 2 * t + (e & 1)] =
            from_f32<T>(ds);
      }
    }
    __syncwarp();
    warp_mma<D / 8, kTile>(acc, ds_s + r0 * LDT, LDT, kt_s, LDT);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= Sq) continue;
    OT* row = dq + (qh * Sq + qi) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
        row[8 * n + 2 * t + c] = from_f32<OT>(acc[n][2 * r + c]);
    }
  }
}

// ------------------------------------------------------------------ dk/dv

template <typename T, int D>
struct DkvSmem {
  static constexpr int BQ = kTileQ_dkv;
  static constexpr int LD = D + pad<T>();    // k, v, q, dO rows
  static constexpr int LDT = BQ + pad<T>();  // q^T, dO^T rows and p/ds rows
  static constexpr size_t bytes =
      sizeof(T) * ((size_t)2 * kTile * LD + (size_t)2 * BQ * LD +
                   (size_t)2 * D * LDT + (size_t)kTile * LDT) +
      sizeof(float) * 2 * BQ;
};

template <typename T, typename OT, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         OT* __restrict__ dk, OT* __restrict__ dv, int H,
                         int Hkv, int Sq, int Sk, float scale, int causal) {
  using Sm = DkvSmem<T, D>;
  constexpr int BQ = Sm::BQ, LD = Sm::LD, LDT = Sm::LDT;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int grp = H / Hkv;
  const int k0 = kt * kTile;
  const int q_offset = Sk - Sq;
  const size_t kh = (size_t)b * Hkv + hk;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [kTile][LD]
  T* v_s = k_s + kTile * LD;                // [kTile][LD]
  T* q_s = v_s + kTile * LD;                // [BQ][LD]
  T* do_s = q_s + BQ * LD;                  // [BQ][LD]
  T* qt_s = do_s + BQ * LD;                 // [D][LDT]
  T* dot_s = qt_s + D * LDT;                // [D][LDT]
  T* p_s = dot_s + D * LDT;                 // [kTile][LDT]
  float* lse_s = reinterpret_cast<float*>(p_s + kTile * LDT);  // [BQ]
  float* delta_s = lse_s + BQ;                                 // [BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * kRowsPerWarp;

  stage_rows<T, kTile, D>(k_s, LD, k + kh * Sk * D, k0, Sk);
  stage_rows<T, kTile, D>(v_s, LD, v + kh * Sk * D, k0, Sk);
  // First q tile that reaches this kv tile: the one holding the q row at
  // position k0 (earlier rows see only earlier columns).
  const int first_q = causal ? max(0, k0 - q_offset) : 0;
  const int i0 = first_q / BQ;
  const int nq = (Sq + BQ - 1) / BQ;

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  for (int h = hk * grp; h < (hk + 1) * grp; ++h) {
    const size_t qh = (size_t)b * H + h;
    const T* qp = q + qh * Sq * D;
    const T* dop = dout + qh * Sq * D;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // the previous q tile fully read
      stage_rows<T, BQ, D>(q_s, LD, qp, q0, Sq);
      stage_rows<T, BQ, D>(do_s, LD, dop, q0, Sq);
      stage_cols<T, BQ, D>(qt_s, LDT, qp, q0, Sq);
      stage_cols<T, BQ, D>(dot_s, LDT, dop, q0, Sq);
      for (int c = threadIdx.x; c < BQ; c += kThreads) {
        const bool in = q0 + c < Sq;
        lse_s[c] = in ? lse[qh * Sq + q0 + c] : kNegInf;
        delta_s[c] = in ? delta[qh * Sq + q0 + c] : 0.f;
      }
      __syncthreads();

      // s^T = k . q^T: rows are kv positions, columns q positions.
      float p[BQ / 8][4] = {};
      warp_mma<BQ / 8, D>(p, k_s + r0 * LD, LD, q_s, LD);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ki = k0 + r0 + g + 8 * (e >> 1);
          const int c = 8 * n + 2 * t + (e & 1);
          const int qi = q0 + c;
          const bool ok =
              ki < Sk && qi < Sq && (!causal || q_offset + qi >= ki);
          const float s = ok ? p[n][e] * scale : kNegInf;
          p[n][e] =
              lse_s[c] <= kNegInf * 0.5f ? 0.f : expf(s - lse_s[c]);
          p_s[(r0 + g + 8 * (e >> 1)) * LDT + c] = from_f32<T>(p[n][e]);
        }
      }
      __syncwarp();
      warp_mma<D / 8, BQ>(dv_acc, p_s + r0 * LDT, LDT, dot_s, LDT);
      float dp[BQ / 8][4] = {};
      warp_mma<BQ / 8, D>(dp, v_s + r0 * LD, LD, do_s, LD);
      __syncwarp();  // every lane is done reading p before ds replaces it
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          const float ds = p[n][e] * (dp[n][e] - delta_s[c]) * scale;
          p_s[(r0 + g + 8 * (e >> 1)) * LDT + c] = from_f32<T>(ds);
        }
      }
      __syncwarp();
      warp_mma<D / 8, BQ>(dk_acc, p_s + r0 * LDT, LDT, qt_s, LDT);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ki = k0 + r0 + g + 8 * r;
    if (ki >= Sk) continue;
    OT* dkr = dk + (kh * Sk + ki) * D;
    OT* dvr = dv + (kh * Sk + ki) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        dkr[8 * n + 2 * t + c] = from_f32<OT>(dk_acc[n][2 * r + c]);
        dvr[8 * n + 2 * t + c] = from_f32<OT>(dv_acc[n][2 * r + c]);
      }
    }
  }
}

// ---------------------------------------------------------------- launch

struct Shape {
  int B, H, Hkv, Sq, Sk, D;
  float scale;
  int causal;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t fwd(const Shape& s, const void* q, const void* k, const void* v,
                void* o, float* lse, cudaStream_t st) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t smem = FwdSmem<T, D>::bytes;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((s.Sq + kTile - 1) / kTile, s.H, s.B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, s.H, s.Hkv, s.Sq,
      s.Sk, s.scale, s.causal);
  return cudaGetLastError();
}

template <typename T, typename OT, int D>
cudaError_t bwd_dq(const Shape& s, const void* q, const void* k,
                   const void* v, const void* dout, const float* lse,
                   const float* delta, void* dq, cudaStream_t st) {
  auto kernel = flash_bwd_dq_kernel<T, OT, D>;
  const size_t smem = DqSmem<T, D>::bytes;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((s.Sq + kTile - 1) / kTile, s.H, s.B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<OT*>(dq), s.H, s.Hkv, s.Sq, s.Sk, s.scale, s.causal);
  return cudaGetLastError();
}

template <typename T, typename OT, int D>
cudaError_t bwd_dkv(const Shape& s, const void* q, const void* k,
                    const void* v, const void* dout, const float* lse,
                    const float* delta, void* dk, void* dv, cudaStream_t st) {
  auto kernel = flash_bwd_dkv_kernel<T, OT, D>;
  const size_t smem = DkvSmem<T, D>::bytes;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((s.Sk + kTile - 1) / kTile, s.Hkv, s.B), kThreads, smem,
           st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                 delta, static_cast<OT*>(dk), static_cast<OT*>(dv), s.H,
                 s.Hkv, s.Sq, s.Sk, s.scale, s.causal);
  return cudaGetLastError();
}

// Instances: f32 inputs and outputs, D 64 or 128, for each kernel. Type
// codes: 0 float32 (1 bfloat16 is flash_attention_sm90.cu's).
#define RTT_DISPATCH_D(D_, ...)          \
  switch (D_) {                          \
    case 64: {                           \
      constexpr int kD = 64;             \
      return __VA_ARGS__;                \
    }                                    \
    case 128: {                          \
      constexpr int kD = 128;            \
      return __VA_ARGS__;                \
    }                                    \
    default:                             \
      return cudaErrorInvalidValue;      \
  }

}  // namespace

extern "C" {

// Every pointer is a contiguous, 16-byte aligned device buffer: q, dout
// [B,H,Sq,D]; k, v [B,Hkv,Sk,D]; lse, delta [B,H,Sq] float32; outputs
// likewise. `lse` may be null in the forward. Each function returns the
// cudaError_t of its launch (0 on success); the kernels allocate nothing
// and do not synchronise.
int ray_tpu_torch_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int dtype, int B, int H,
                            int Hkv, int Sq, int Sk, int D, float scale,
                            int causal, void* stream) {
  const Shape s{B, H, Hkv, Sq, Sk, D, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    RTT_DISPATCH_D(D, fwd<float, kD>(s, q, k, v, o, l, st));
  }
  return cudaErrorInvalidValue;
}

int ray_tpu_torch_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int dtype,
                               int out_dtype, int B, int H, int Hkv, int Sq,
                               int Sk, int D, float scale, int causal,
                               void* stream) {
  const Shape s{B, H, Hkv, Sq, Sk, D, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0 && out_dtype == 0) {
    RTT_DISPATCH_D(D, bwd_dq<float, float, kD>(s, q, k, v, dout, l, dl, dq,
                                               st));
  }
  return cudaErrorInvalidValue;
}

int ray_tpu_torch_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int dtype, int out_dtype, int B, int H,
                                int Hkv, int Sq, int Sk, int D, float scale,
                                int causal, void* stream) {
  const Shape s{B, H, Hkv, Sq, Sk, D, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0 && out_dtype == 0) {
    RTT_DISPATCH_D(D, bwd_dkv<float, float, kD>(s, q, k, v, dout, l, dl, dk,
                                                dv, st));
  }
  return cudaErrorInvalidValue;
}

const char* ray_tpu_torch_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
