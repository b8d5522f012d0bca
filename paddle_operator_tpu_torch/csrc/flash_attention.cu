// Flash attention for Hopper (sm_90a): the forward, the dK/dV backward and
// the dQ backward, over [B, S, H, D] tensors with GQA, causal masking and
// packed-sequence segment ids.
//
// Replaces the three TPU kernels of paddle_operator_tpu/ops/pallas_attention.py:
//
// - `_fwd_kernel` (reached through `_fwd`): tiled online softmax; emits O
//   and the per-row logsumexp.  Entry `flash_fwd_launch`.
// - `_bwd_dkv_kernel` (reached through `_bwd_impl`): for each key tile,
//   walk the query tiles: p = exp(s - lse), dV += p^T dO,
//   ds = p (dO V^T - delta), dK += ds^T Q * scale.  Entry
//   `flash_bwd_dkv_launch`.
// - `_bwd_dq_kernel` (reached through `_bwd_impl`): for each query tile,
//   walk the key tiles: dQ += ds K * scale.  Entry `flash_bwd_dq_launch`.
//
// Semantics kept from the TPU kernels (file:line in pallas_attention.py):
// - masked scores are NEG_INF = -1e30, a finite value (:36); a row with no
//   unmasked key anywhere gives o = 0 and lse = 0 (:134-152), so that the
//   backward's p = exp(s - lse) is 0 on it;
// - products take their inputs in the storage type and accumulate in f32;
//   p is cast to V's type before P.V and ds to the input type before the
//   dK and dQ products (:113, :128, :259-268, :312-314);
// - the causal mask compares absolute positions (row >= col), and a tile
//   whose rows all precede its columns is skipped (:104);
// - with segment ids, a tile whose q-id range and k-id range do not
//   overlap is skipped (`_seg_gate`, :67); the skip only saves work, the
//   element mask (q id == k id) decides every score.
// Changed: the TPU kernel's GQA dK/dV were produced per query head in f32
// and summed over the n_rep heads afterwards (:404-406).  Here one dK/dV
// block walks the n_rep query heads of its kv head itself and keeps the
// sum in its f32 accumulators: no [B, H, S, D] f32 buffers, and no float
// atomics, so two runs give the same bits.  Any S >= 1 is taken: the
// ragged last tile is masked (the TPU wrapper raised for S that does not
// tile).  dK and dQ are scaled once, after the last product, instead of
// after each tile's product.
//
// What bounds it: at the training shapes (S >= 512, D 128) the products.
// The forward does 4*S*S*D flops per (batch, head) (halved by causality)
// against (4*S*D + S) elements moved, hundreds of flops per byte, so the
// tensor cores are the limit.  The design keeps every intermediate (the
// score tile, p, ds, the accumulators) in shared memory and never writes a
// score to device memory:
// - one block of 256 threads per (batch, head, q tile) for the forward
//   and dQ, per (batch, kv head, k tile) for dK/dV; the q tiles of the
//   forward and dQ are issued longest-causal-row first;
// - q and k tiles are B x D (B = 64, or 32 where shared memory needs it);
//   every product is a block-level GEMM between shared-memory tiles:
//   bf16 through WMMA 16x16x16 fragments with f32 accumulation (the warps
//   share the output tiles), float through plain FMAs, so float results
//   are not rounded to TF32;
// - the row softmax runs one warp per row with shuffles.
// Left for later (ROADMAP Queue P): wgmma, TMA loads, warp specialisation,
// keeping the accumulators in registers.
//
// Accepts float and bfloat16, D in {64, 128, 256}, any Hq % Hkv == 0 and
// any Sq, Sk.  Pointers must be 16-byte aligned and the tensors contiguous
// (the Python wrapper checks).  Launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // finite, as the TPU kernels' NEG_INF
constexpr size_t kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

constexpr size_t align_up(size_t x) { return (x + 127) / 128 * 128; }

// Tile rows (q and k tiles are square) and shared-memory row pitches per
// element type and head dim.  bf16 rows are padded by 16 bytes (f32 rows
// by 16 bytes too) so WMMA's fragment loads spread over the banks while
// every fragment pointer stays 32-byte aligned; float rows are padded by
// one element, which makes the FMA path's column walks conflict-free.
template <typename T, int D>
struct Tile {
  static constexpr bool kMma = std::is_same<T, bf16>::value;
  static constexpr int B = kMma ? (D <= 128 ? 64 : 32) : (D <= 64 ? 64 : 32);
  static constexpr int LD = D + (kMma ? 8 : 1);   // [rows][D] tiles of T
  static constexpr int LDF = D + (kMma ? 4 : 1);  // [rows][D] f32
  static constexpr int LB = B + (kMma ? 8 : 1);   // [rows][B] tiles of T
  static constexpr int LBF = B + (kMma ? 4 : 1);  // [rows][B] f32
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// C[M][N] = (or +=) op(A)[M][K] * op(B)[K][N] over shared-memory tiles.
// AT: A is stored as [K][M] (op = transpose); BT: B is stored as [N][K].
// The caller synchronises before (inputs written) and after (C read).
template <typename T, int M, int N, int K, bool AT, bool BT, bool ACC>
__device__ __forceinline__ void block_gemm(const T* __restrict__ A, int lda,
                                           const T* __restrict__ B, int ldb,
                                           float* __restrict__ C, int ldc) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    using LA = typename std::conditional<AT, wmma::col_major,
                                         wmma::row_major>::type;
    using LB = typename std::conditional<BT, wmma::col_major,
                                         wmma::row_major>::type;
    constexpr int TN = N / 16;
    const int warp = threadIdx.x >> 5;
    for (int t = warp; t < (M / 16) * TN; t += kWarps) {
      const int mi = t / TN, ni = t - (t / TN) * TN;
      float* pc = C + mi * 16 * ldc + ni * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (ACC) {
        wmma::load_matrix_sync(c, pc, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(c, 0.f);
      }
#pragma unroll 4
      for (int kk = 0; kk < K / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(
            a, AT ? A + kk * 16 * lda + mi * 16 : A + mi * 16 * lda + kk * 16,
            lda);
        wmma::load_matrix_sync(
            b, BT ? B + ni * 16 * ldb + kk * 16 : B + kk * 16 * ldb + ni * 16,
            ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(pc, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int i = idx / N, j = idx - (idx / N) * N;
      float s = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < K; ++kk) {
        const float a = AT ? A[kk * lda + i] : A[i * lda + kk];
        const float b = BT ? B[j * ldb + kk] : B[kk * ldb + j];
        s = fmaf(a, b, s);
      }
      float* pc = C + i * ldc + j;
      *pc = ACC ? *pc + s : s;
    }
  }
}

// Rows [0, nvalid) of one head (src points at its first row; rows are
// `stride` elements apart) into a [ROWS][LD] tile; rows past nvalid are 0.
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          size_t stride, int nvalid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
    const int r = idx / CH, c = (idx - (idx / CH) * CH) * VEC;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid)
      raw = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
    if constexpr ((LD * sizeof(T)) % 16 == 0) {
      *reinterpret_cast<uint4*>(dst + r * LD + c) = raw;
    } else {
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[r * LD + c + i] = e[i];
    }
  }
}

// [0, nvalid) of a per-row f32 vector; 0 past nvalid.
__device__ __forceinline__ void load_rows_f32(float* __restrict__ dst,
                                              const float* __restrict__ src,
                                              int rows, int nvalid) {
  for (int i = threadIdx.x; i < rows; i += kThreads)
    dst[i] = i < nvalid ? src[i] : 0.f;
}

// Warp 0 only: copy one tile's segment ids and write their [min, max] to
// range[0..1].  The caller synchronises before reading either.
__device__ __forceinline__ void load_seg(int* __restrict__ dst,
                                         const int* __restrict__ src,
                                         int nvalid, int* range) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = lane; i < nvalid; i += 32) {
    const int id = src[i];
    dst[i] = id;
    lo = min(lo, id);
    hi = max(hi, id);
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max(hi, __shfl_xor_sync(kFull, hi, off));
  }
  if (lane == 0) {
    range[0] = lo;
    range[1] = hi;
  }
}

// Whether score (q row i, k row j) of the current tile pair is attended.
struct Mask {
  int sq, sk, q0, k0;
  bool causal;
  const int* segq;  // the tiles' ids in shared memory, or null
  const int* segk;
  __device__ __forceinline__ bool operator()(int i, int j) const {
    const int qi = q0 + i, kj = k0 + j;
    if (qi >= sq || kj >= sk) return false;
    if (causal && qi < kj) return false;
    return segq == nullptr || segq[i] == segk[j];
  }
};

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int D>
struct FwdSmem {
  using C = Tile<T, D>;
  static constexpr size_t q = 0;
  static constexpr size_t k = align_up(q + sizeof(T) * C::B * C::LD);
  static constexpr size_t v = align_up(k + sizeof(T) * C::B * C::LD);
  static constexpr size_t s = align_up(v + sizeof(T) * C::B * C::LD);
  static constexpr size_t p = align_up(s + 4 * C::B * C::LBF);
  static constexpr size_t o = align_up(p + sizeof(T) * C::B * C::LB);
  static constexpr size_t rows = align_up(o + 4 * C::B * C::LDF);  // m l corr
  static constexpr size_t seg = align_up(rows + 4 * 3 * C::B);
  static constexpr size_t bytes = align_up(seg + 4 * (2 * C::B + 4));
  static_assert(bytes <= kMaxSmem, "forward tiles exceed shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k, T* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int hq, int hkv,
                     float scale, int causal) {
  using C = Tile<T, D>;
  using L = FwdSmem<T, D>;
  constexpr int B = C::B;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  T* sP = reinterpret_cast<T*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::rows);
  float* sL = sM + B;
  float* sCorr = sL + B;
  int* sSegQ = reinterpret_cast<int*>(smem + L::seg);
  int* sSegK = sSegQ + B;
  int* sRange = sSegK + B;  // q lo, q hi, k lo, k hi

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (sq + B - 1) / B;
  const int iq = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = iq * B, nvq = min(B, sq - q0);
  const size_t qs = (size_t)hq * D, ks = (size_t)hkv * D;
  const bool has_seg = seg_q != nullptr;

  load_tile<T, D, B, C::LD>(sQ, q + ((size_t)b * sq + q0) * qs + (size_t)h * D,
                            qs, nvq);
  for (int i = threadIdx.x; i < B * C::LDF; i += kThreads) sO[i] = 0.f;
  for (int i = threadIdx.x; i < B; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }
  int qlo = 0, qhi = 0;
  if (has_seg && warp == 0)
    load_seg(sSegQ, seg_q + (size_t)b * sq + q0, nvq, sRange);
  __syncthreads();
  if (has_seg) {
    qlo = sRange[0];
    qhi = sRange[1];
  }
  const Mask base{sq, sk, q0, 0, causal != 0, has_seg ? sSegQ : nullptr,
                  has_seg ? sSegK : nullptr};

  const int nk = (sk + B - 1) / B;
  const int kend = causal ? min(nk, (q0 + nvq - 1) / B + 1) : nk;
  for (int ik = 0; ik < kend; ++ik) {
    const int k0 = ik * B, nvk = min(B, sk - k0);
    if (has_seg) {
      if (warp == 0)
        load_seg(sSegK, seg_k + (size_t)b * sk + k0, nvk, sRange + 2);
      __syncthreads();
      const bool skip = !(qlo <= sRange[3] && qhi >= sRange[2]);
      if (skip) {
        __syncthreads();  // every thread has read the range
        continue;
      }
    }
    const size_t kv_off = ((size_t)b * sk + k0) * ks + (size_t)kvh * D;
    load_tile<T, D, B, C::LD>(sK, k + kv_off, ks, nvk);
    load_tile<T, D, B, C::LD>(sV, v + kv_off, ks, nvk);
    __syncthreads();
    block_gemm<T, B, B, D, false, true, false>(sQ, C::LD, sK, C::LD, sS,
                                               C::LBF);
    __syncthreads();

    Mask mask = base;
    mask.k0 = k0;
    for (int r = warp; r < B; r += kWarps) {
      constexpr int PER = B / 32;
      float s[PER];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int j = lane + 32 * u;
        s[u] = mask(r, j) ? sS[r * C::LBF + j] * scale : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const float p = expf(s[u] - m_new);
        sum += p;
        sP[r * C::LB + lane + 32 * u] = from_float<T>(p);
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * corr + sum;
        sCorr[r] = corr;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < B * D; idx += kThreads) {
      const int r = idx / D, c = idx - (idx / D) * D;
      sO[r * C::LDF + c] *= sCorr[r];
    }
    __syncthreads();
    block_gemm<T, B, D, B, false, false, true>(sP, C::LB, sV, C::LD, sO,
                                               C::LDF);
    __syncthreads();
  }

  // a row that never saw an unmasked key still has m == NEG_INF: o = 0,
  // lse = 0 (see the head of this file)
  T* ob = o + ((size_t)b * sq + q0) * qs + (size_t)h * D;
  for (int idx = threadIdx.x; idx < nvq * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const bool masked = sM[r] <= kNegInf / 2;
    const float l = sL[r] == 0.f ? 1.f : sL[r];
    ob[r * qs + c] = from_float<T>(masked ? 0.f : sO[r * C::LDF + c] / l);
  }
  float* lb = lse + ((size_t)b * hq + h) * sq + q0;
  for (int r = threadIdx.x; r < nvq; r += kThreads) {
    const bool masked = sM[r] <= kNegInf / 2;
    const float l = sL[r] == 0.f ? 1.f : sL[r];
    lb[r] = masked ? 0.f : sM[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DkvSmem {
  using C = Tile<T, D>;
  static constexpr size_t k = 0;
  static constexpr size_t v = align_up(k + sizeof(T) * C::B * C::LD);
  static constexpr size_t q = align_up(v + sizeof(T) * C::B * C::LD);
  static constexpr size_t d_o = align_up(q + sizeof(T) * C::B * C::LD);
  static constexpr size_t dk = align_up(d_o + sizeof(T) * C::B * C::LD);
  static constexpr size_t dv = align_up(dk + 4 * C::B * C::LDF);
  static constexpr size_t s = align_up(dv + 4 * C::B * C::LDF);
  static constexpr size_t dp = align_up(s + 4 * C::B * C::LBF);
  static constexpr size_t pc = align_up(dp + 4 * C::B * C::LBF);
  static constexpr size_t dsc = align_up(pc + sizeof(T) * C::B * C::LB);
  static constexpr size_t rows = align_up(dsc + sizeof(T) * C::B * C::LB);
  static constexpr size_t seg = align_up(rows + 4 * 2 * C::B);  // lse delta
  static constexpr size_t bytes = align_up(seg + 4 * (2 * C::B + 4));
  static_assert(bytes <= kMaxSmem, "dK/dV tiles exceed shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ seg_k, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int sk, int hq, int hkv,
                         float scale, int causal) {
  using C = Tile<T, D>;
  using L = DkvSmem<T, D>;
  constexpr int B = C::B;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sDO = reinterpret_cast<T*>(smem + L::d_o);
  float* sDK = reinterpret_cast<float*>(smem + L::dk);
  float* sDV = reinterpret_cast<float*>(smem + L::dv);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  T* sPc = reinterpret_cast<T*>(smem + L::pc);
  T* sDSc = reinterpret_cast<T*>(smem + L::dsc);
  float* sLse = reinterpret_cast<float*>(smem + L::rows);
  float* sDelta = sLse + B;
  int* sSegQ = reinterpret_cast<int*>(smem + L::seg);
  int* sSegK = sSegQ + B;
  int* sRange = sSegK + B;

  const int warp = threadIdx.x >> 5;
  const int ik = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rep = hq / hkv;
  const int k0 = ik * B, nvk = min(B, sk - k0);
  const size_t qs = (size_t)hq * D, ks = (size_t)hkv * D;
  const bool has_seg = seg_q != nullptr;

  const size_t kv_off = ((size_t)b * sk + k0) * ks + (size_t)kvh * D;
  load_tile<T, D, B, C::LD>(sK, k + kv_off, ks, nvk);
  load_tile<T, D, B, C::LD>(sV, v + kv_off, ks, nvk);
  for (int i = threadIdx.x; i < B * C::LDF; i += kThreads) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }
  int klo = 0, khi = 0;
  if (has_seg && warp == 0)
    load_seg(sSegK, seg_k + (size_t)b * sk + k0, nvk, sRange + 2);
  __syncthreads();
  if (has_seg) {
    klo = sRange[2];
    khi = sRange[3];
  }

  const int nq = (sq + B - 1) / B;
  const int iq0 = causal ? min(nq, k0 / B) : 0;
  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = kvh * n_rep + rep;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * B, nvq = min(B, sq - q0);
      if (has_seg) {
        if (warp == 0)
          load_seg(sSegQ, seg_q + (size_t)b * sq + q0, nvq, sRange);
        __syncthreads();
        const bool skip = !(sRange[0] <= khi && sRange[1] >= klo);
        if (skip) {
          __syncthreads();
          continue;
        }
      }
      const size_t q_off = ((size_t)b * sq + q0) * qs + (size_t)h * D;
      load_tile<T, D, B, C::LD>(sQ, q + q_off, qs, nvq);
      load_tile<T, D, B, C::LD>(sDO, dout + q_off, qs, nvq);
      const size_t row_off = ((size_t)b * hq + h) * sq + q0;
      load_rows_f32(sLse, lse + row_off, B, nvq);
      load_rows_f32(sDelta, delta + row_off, B, nvq);
      __syncthreads();
      block_gemm<T, B, B, D, false, true, false>(sQ, C::LD, sK, C::LD, sS,
                                                 C::LBF);
      __syncthreads();
      const Mask mask{sq, sk, q0, k0, causal != 0, has_seg ? sSegQ : nullptr,
                      has_seg ? sSegK : nullptr};
      for (int idx = threadIdx.x; idx < B * B; idx += kThreads) {
        const int i = idx / B, j = idx - (idx / B) * B;
        const float s = mask(i, j) ? sS[i * C::LBF + j] * scale : kNegInf;
        const float p = expf(s - sLse[i]);
        sS[i * C::LBF + j] = p;
        sPc[i * C::LB + j] = from_float<T>(p);
      }
      __syncthreads();
      // dV += p^T dO and dP = dO V^T read disjoint inputs and outputs
      block_gemm<T, B, D, B, true, false, true>(sPc, C::LB, sDO, C::LD, sDV,
                                                C::LDF);
      block_gemm<T, B, B, D, false, true, false>(sDO, C::LD, sV, C::LD, sDP,
                                                 C::LBF);
      __syncthreads();
      for (int idx = threadIdx.x; idx < B * B; idx += kThreads) {
        const int i = idx / B, j = idx - (idx / B) * B;
        const float ds =
            sS[i * C::LBF + j] * (sDP[i * C::LBF + j] - sDelta[i]);
        sDSc[i * C::LB + j] = from_float<T>(ds);
      }
      __syncthreads();
      block_gemm<T, B, D, B, true, false, true>(sDSc, C::LB, sQ, C::LD, sDK,
                                                C::LDF);
      __syncthreads();
    }
  }

  T* dkb = dk + kv_off;
  T* dvb = dv + kv_off;
  for (int idx = threadIdx.x; idx < nvk * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    dkb[r * ks + c] = from_float<T>(sDK[r * C::LDF + c] * scale);
    dvb[r * ks + c] = from_float<T>(sDV[r * C::LDF + c]);
  }
}

template <typename T, int D>
struct DqSmem {
  using C = Tile<T, D>;
  static constexpr size_t q = 0;
  static constexpr size_t d_o = align_up(q + sizeof(T) * C::B * C::LD);
  static constexpr size_t k = align_up(d_o + sizeof(T) * C::B * C::LD);
  static constexpr size_t v = align_up(k + sizeof(T) * C::B * C::LD);
  static constexpr size_t dq = align_up(v + sizeof(T) * C::B * C::LD);
  static constexpr size_t s = align_up(dq + 4 * C::B * C::LDF);
  static constexpr size_t dp = align_up(s + 4 * C::B * C::LBF);
  static constexpr size_t dsc = align_up(dp + 4 * C::B * C::LBF);
  static constexpr size_t rows = align_up(dsc + sizeof(T) * C::B * C::LB);
  static constexpr size_t seg = align_up(rows + 4 * 2 * C::B);
  static constexpr size_t bytes = align_up(seg + 4 * (2 * C::B + 4));
  static_assert(bytes <= kMaxSmem, "dQ tiles exceed shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ seg_q,
                        const int* __restrict__ seg_k, T* __restrict__ dq,
                        int sq, int sk, int hq, int hkv, float scale,
                        int causal) {
  using C = Tile<T, D>;
  using L = DqSmem<T, D>;
  constexpr int B = C::B;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sDO = reinterpret_cast<T*>(smem + L::d_o);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  float* sDQ = reinterpret_cast<float*>(smem + L::dq);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  float* sDP = reinterpret_cast<float*>(smem + L::dp);
  T* sDSc = reinterpret_cast<T*>(smem + L::dsc);
  float* sLse = reinterpret_cast<float*>(smem + L::rows);
  float* sDelta = sLse + B;
  int* sSegQ = reinterpret_cast<int*>(smem + L::seg);
  int* sSegK = sSegQ + B;
  int* sRange = sSegK + B;

  const int warp = threadIdx.x >> 5;
  const int nq = (sq + B - 1) / B;
  const int iq = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = iq * B, nvq = min(B, sq - q0);
  const size_t qs = (size_t)hq * D, ks = (size_t)hkv * D;
  const bool has_seg = seg_q != nullptr;

  const size_t q_off = ((size_t)b * sq + q0) * qs + (size_t)h * D;
  load_tile<T, D, B, C::LD>(sQ, q + q_off, qs, nvq);
  load_tile<T, D, B, C::LD>(sDO, dout + q_off, qs, nvq);
  const size_t row_off = ((size_t)b * hq + h) * sq + q0;
  load_rows_f32(sLse, lse + row_off, B, nvq);
  load_rows_f32(sDelta, delta + row_off, B, nvq);
  for (int i = threadIdx.x; i < B * C::LDF; i += kThreads) sDQ[i] = 0.f;
  int qlo = 0, qhi = 0;
  if (has_seg && warp == 0)
    load_seg(sSegQ, seg_q + (size_t)b * sq + q0, nvq, sRange);
  __syncthreads();
  if (has_seg) {
    qlo = sRange[0];
    qhi = sRange[1];
  }

  const int nk = (sk + B - 1) / B;
  const int kend = causal ? min(nk, (q0 + nvq - 1) / B + 1) : nk;
  for (int ik = 0; ik < kend; ++ik) {
    const int k0 = ik * B, nvk = min(B, sk - k0);
    if (has_seg) {
      if (warp == 0)
        load_seg(sSegK, seg_k + (size_t)b * sk + k0, nvk, sRange + 2);
      __syncthreads();
      const bool skip = !(qlo <= sRange[3] && qhi >= sRange[2]);
      if (skip) {
        __syncthreads();
        continue;
      }
    }
    const size_t kv_off = ((size_t)b * sk + k0) * ks + (size_t)kvh * D;
    load_tile<T, D, B, C::LD>(sK, k + kv_off, ks, nvk);
    load_tile<T, D, B, C::LD>(sV, v + kv_off, ks, nvk);
    __syncthreads();
    block_gemm<T, B, B, D, false, true, false>(sQ, C::LD, sK, C::LD, sS,
                                               C::LBF);
    block_gemm<T, B, B, D, false, true, false>(sDO, C::LD, sV, C::LD, sDP,
                                               C::LBF);
    __syncthreads();
    const Mask mask{sq, sk, q0, k0, causal != 0, has_seg ? sSegQ : nullptr,
                    has_seg ? sSegK : nullptr};
    for (int idx = threadIdx.x; idx < B * B; idx += kThreads) {
      const int i = idx / B, j = idx - (idx / B) * B;
      const float s = mask(i, j) ? sS[i * C::LBF + j] * scale : kNegInf;
      const float p = expf(s - sLse[i]);
      const float ds = p * (sDP[i * C::LBF + j] - sDelta[i]);
      sDSc[i * C::LB + j] = from_float<T>(ds);
    }
    __syncthreads();
    block_gemm<T, B, D, B, false, false, true>(sDSc, C::LB, sK, C::LD, sDQ,
                                               C::LDF);
    __syncthreads();
  }

  T* dqb = dq + q_off;
  for (int idx = threadIdx.x; idx < nvq * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    dqb[r * qs + c] = from_float<T>(sDQ[r * C::LDF + c] * scale);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Shape {
  int b, sq, sk, hq, hkv, d;
  int causal;
  float scale;
};

bool bad_shape(const Shape& s) {
  return s.b <= 0 || s.b > 65535 || s.sq <= 0 || s.sk < 0 || s.hkv <= 0 ||
         s.hq <= 0 || s.hq > 65535 || s.hq % s.hkv != 0 ||
         !(s.d == 64 || s.d == 128 || s.d == 256);
}

template <typename Kern>
cudaError_t prepare(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
int fwd(const Shape& s, const void* q, const void* k, const void* v,
        const void* sgq, const void* sgk, void* o, void* lse,
        cudaStream_t st) {
  using L = FwdSmem<T, D>;
  constexpr int B = Tile<T, D>::B;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = prepare(kern, L::bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s.sq + B - 1) / B, s.hq, s.b);
  kern<<<grid, kThreads, L::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(sgq),
      static_cast<const int*>(sgk), static_cast<T*>(o),
      static_cast<float*>(lse), s.sq, s.sk, s.hq, s.hkv, s.scale, s.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dkv(const Shape& s, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, const void* sgq,
        const void* sgk, void* dk, void* dv, cudaStream_t st) {
  using L = DkvSmem<T, D>;
  constexpr int B = Tile<T, D>::B;
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t e = prepare(kern, L::bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s.sk + B - 1) / B, s.hkv, s.b);
  kern<<<grid, kThreads, L::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(sgq), static_cast<const int*>(sgk),
      static_cast<T*>(dk), static_cast<T*>(dv), s.sq, s.sk, s.hq, s.hkv,
      s.scale, s.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dq(const Shape& s, const void* q, const void* k, const void* v,
       const void* dout, const void* lse, const void* delta, const void* sgq,
       const void* sgk, void* dqo, cudaStream_t st) {
  using L = DqSmem<T, D>;
  constexpr int B = Tile<T, D>::B;
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t e = prepare(kern, L::bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s.sq + B - 1) / B, s.hq, s.b);
  kern<<<grid, kThreads, L::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(sgq), static_cast<const int*>(sgk),
      static_cast<T*>(dqo), s.sq, s.sk, s.hq, s.hkv, s.scale, s.causal);
  return static_cast<int>(cudaGetLastError());
}

// dtype code (0 = float32, 1 = bfloat16) and head dim -> an instantiation
#define FLASH_DISPATCH(DTYPE, D, FN, ...)                                   \
  {                                                                         \
    if ((DTYPE) == 0) {                                                     \
      if ((D) == 64) return FN<float, 64>(__VA_ARGS__);                     \
      if ((D) == 128) return FN<float, 128>(__VA_ARGS__);                   \
      if ((D) == 256) return FN<float, 256>(__VA_ARGS__);                   \
    } else if ((DTYPE) == 1) {                                              \
      if ((D) == 64) return FN<bf16, 64>(__VA_ARGS__);                      \
      if ((D) == 128) return FN<bf16, 128>(__VA_ARGS__);                    \
      if ((D) == 256) return FN<bf16, 256>(__VA_ARGS__);                    \
    }                                                                       \
    return static_cast<int>(cudaErrorInvalidValue);                         \
  }

}  // namespace

// q [B, Sq, Hq, D]; k, v [B, Sk, Hkv, D]; seg_q [B, Sq] and seg_k [B, Sk]
// int32, both null or both set; out o like q, lse [B, Hq, Sq] f32.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t as int.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* seg_q, const void* seg_k, void* o,
                                void* lse, int b, int sq, int sk, int hq,
                                int hkv, int d, int causal, float scale,
                                int dtype, void* stream) {
  const Shape s{b, sq, sk, hq, hkv, d, causal, scale};
  if (bad_shape(s) || (seg_q == nullptr) != (seg_k == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dtype, d, fwd, s, q, k, v, seg_q, seg_k, o, lse, st);
}

// The forward's inputs plus dout like q, lse and delta [B, Hq, Sq] f32;
// out dk, dv like k (summed over the n_rep query heads of each kv head).
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    const void* seg_q, const void* seg_k,
                                    void* dk, void* dv, int b, int sq, int sk,
                                    int hq, int hkv, int d, int causal,
                                    float scale, int dtype, void* stream) {
  const Shape s{b, sq, sk, hq, hkv, d, causal, scale};
  if (bad_shape(s) || s.sk <= 0 || (seg_q == nullptr) != (seg_k == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dtype, d, dkv, s, q, k, v, dout, lse, delta, seg_q, seg_k,
                 dk, dv, st);
}

// As flash_bwd_dkv_launch; out dq like q.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* seg_q, const void* seg_k,
                                   void* dqo, int b, int sq, int sk, int hq,
                                   int hkv, int d, int causal, float scale,
                                   int dtype, void* stream) {
  const Shape s{b, sq, sk, hq, hkv, d, causal, scale};
  if (bad_shape(s) || (seg_q == nullptr) != (seg_k == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dtype, d, dq, s, q, k, v, dout, lse, delta, seg_q, seg_k,
                 dqo, st);
}
