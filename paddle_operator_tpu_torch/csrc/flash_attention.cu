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
// tensor cores are the limit, and on Hopper only warpgroup MMA (wgmma)
// reaches their rate.  No score ever goes to device memory.  Two designs,
// chosen by type and D at compile time:
//
// - bf16 at D 64 and 128 (the Hopper bodies, `flash_fwd_hopper`,
//   `flash_bwd_dkv_hopper`, `flash_bwd_dq_hopper`): a block of two
//   warpgroups owns 128 rows (q rows in the forward and dQ, keys in
//   dK/dV), 64 per warpgroup.  Every product is a wgmma whose accumulator
//   stays in registers: the forward's S = Q.K^T, online softmax (quad
//   shuffles) and O += P.V with P rounded to bf16 as the register A
//   operand; dK/dV's S^T = K.Q^T and dP^T = V.dO^T, then P^T and dS^T
//   formed in registers and fed as A operands of dV += P^T.dO and
//   dK += dS^T.Q, with dK and dV held in registers over the whole walk;
//   dQ's S = Q.K^T and dP = dO.V^T, then dS formed in registers and fed
//   as the A operand of dQ += dS.K, with dQ held in registers.  One
//   thread issues TMA loads (128-byte swizzle, the layout the wgmma
//   descriptors read; rows past S arrive as zeros) into a 2-stage ring of
//   mbarrier-guarded tiles, so the next tile's load runs under the
//   current tile's products.  The mask is evaluated only on a tile that
//   straddles the causal diagonal, the ragged end or a segment boundary.
// - float, whose products wgmma would round to TF32, and bf16 at D 256,
//   whose register accumulators would not fit (the shared-memory
//   bodies): one block of 256 threads per tile, every intermediate (the
//   score tile, p, ds, the accumulators) in shared memory, bf16 products
//   through WMMA 16x16x16 fragments, float products through plain FMAs;
//   synchronous loads.  The forward's and dQ's q tiles are issued
//   longest-causal-row first in both designs.
// Left for later (ROADMAP Queue B): in the Hopper bodies, overlapping one
// warpgroup's softmax with the other's products (ping-pong), a producer
// warpgroup with setmaxnreg, and persistent blocks.
//
// Accepts float and bfloat16, D in {64, 128, 256}, any Hq % Hkv == 0 and
// any Sq, Sk.  Pointers must be 16-byte aligned and the tensors contiguous
// (the Python wrapper checks).  Launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
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
// Hopper bodies: bf16 forward, dK/dV and dQ at D 64 and 128
// ---------------------------------------------------------------------------
//
// Shared-memory operand tiles are written by TMA in 128-byte-swizzled rows
// of 64 bf16 columns: a tile of R rows and D columns is D/64 "halves" of
// R x 128 bytes, each made of 8-row atoms of 1024 bytes.  That is the
// canonical layout of a wgmma operand both K-major (a row holds the
// reduction dimension: Q and K in Q.K^T) and MN-major (a row holds the
// output columns: V in P.V, dO and Q in the dV and dK products, K in
// the dQ product).

constexpr int kRows = 128;  // forward and dQ q tile; dK/dV k tile (2 x 64)
constexpr int kFwdKeys = 128;  // forward k tile
constexpr int kHalfBytes = 128;  // one swizzled row of 64 bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, its start rounded up to 1024 bytes (the
// swizzle atom); the launch asks for 1024 bytes of slack.
__device__ __forceinline__ unsigned char* smem_1024(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(n)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the barrier's phase `parity` has completed.  A phase that
// never completes is a fault of the kernel: after 10 s it traps (the
// launch then fails) instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

// TMA: one box of a 4-d [B, S, H, D] map (coordinates innermost first)
// into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, `lbo` bytes between 64-column halves (read for MN-major
// operands wider than 64), 1024 bytes between 8-row atoms.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the most recently committed group
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] (= or +=) A[64 x 16] . B[16 x N]: A and B K-major in shared
// memory (scale_d 0 overwrites D).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// D[64 x N] += A[64 x 16] . B[16 x N]: A as bf16 register fragments, B
// MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);


template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc[64 x N] = A[64 x D] . B[N x D]^T on one warpgroup, A and B K-major
// tiles whose 64-column halves lie a_half and b_half bytes apart.
// Issued and committed, not waited for.
template <int N, int D>
__device__ __forceinline__ void gemm_ss(float (&acc)[N / 2],
                                        const unsigned char* a, int a_half,
                                        const unsigned char* b, int b_half) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % 4) * 32;  // 16 bf16 columns inside a half
    wgmma_ss<N>(acc, desc_sw128(a + (kk / 4) * a_half + off, 16),
                desc_sw128(b + (kk / 4) * b_half + off, 16), kk > 0);
  }
  wg_commit();
}

// acc[64 x D] += P[64 x K] . B[K x D] on one warpgroup: P as the A
// fragments of to_a_frags, B an MN-major tile of K rows whose 64-column
// halves lie b_half bytes apart.  Issued and committed, not waited for.
template <int K, int D>
__device__ __forceinline__ void gemm_rs(float (&acc)[D / 2],
                                        const uint32_t (&p)[K / 16][4],
                                        const unsigned char* b, int b_half) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<D>(acc, p[kk], desc_sw128(b + kk * 16 * kHalfBytes, b_half));
  wg_commit();
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x K f32 accumulator, rounded to bf16, as the register A operand of
// a following product over K: a thread's accumulator elements and its A
// fragment elements sit at the same (row, column) positions.
template <int K>
__device__ __forceinline__ void to_a_frags(const float (&s)[K / 2],
                                           uint32_t (&a)[K / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// Warp-collective [min, max] of ids[0, n).
__device__ __forceinline__ void seg_range(const int* __restrict__ ids, int n,
                                          int& lo, int& hi) {
  const int lane = threadIdx.x & 31;
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = lane; i < n; i += 32) {
    const int id = __ldg(ids + i);
    lo = min(lo, id);
    hi = max(hi, id);
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max(hi, __shfl_xor_sync(kFull, hi, off));
  }
}

// Accumulator element i of a 64 x N wgmma tile lies, for the thread with
// warp `w` (of its warpgroup) and lane `l`, at row 16 w + l / 4 (+ 8 when
// bit 1 of i is set) and column 8 (i / 4) + 2 (l % 4) + (i & 1).
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
}

template <int D>
struct FwdHopperSmem {
  static constexpr int kHalfQ = kRows * kHalfBytes;      // bytes a half
  static constexpr int kHalfKV = kFwdKeys * kHalfBytes;
  static constexpr int kStageBytes = kFwdKeys * D * 2;   // K or V tile
  static constexpr size_t q = 0;
  static constexpr size_t k = q + kRows * D * 2;
  static constexpr size_t v = k + 2 * kStageBytes;
  static constexpr size_t bars = v + 2 * kStageBytes;  // q, full[2], empty[2]
  static constexpr size_t bytes = bars + 5 * 8 + 1024;  // + alignment slack
  static_assert(bytes <= kMaxSmem, "forward tiles exceed shared memory");
};

// One block per (q tile of 128 rows, head, batch): warpgroup g owns rows
// 64 g .. 64 g + 63.  Thread 0 issues the TMA loads: Q once, then K and V
// tiles through a 2-stage ring (full barriers count the bytes, empty
// barriers count the 256 threads done with a stage), the tile after next
// issued as soon as a stage is released.  Per live k tile each warpgroup
// runs S = Q.K^T on wgmma into registers, masks only a tile that straddles
// the causal diagonal, the ragged end or a segment boundary, runs the
// online softmax on the registers (exp2 of log2e-scaled scores, row max
// and sum over each quad), rescales its O accumulator and runs O += P.V
// with P rounded to bf16 as the register A operand.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k, bf16* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int hq, int hkv,
                     float scale, int causal) {
  using L = FwdHopperSmem<D>;
  constexpr int N = kFwdKeys;
  // the maps are read by TMA in kernel-parameter space
  const CUtensorMap* map_q = &tq;
  const CUtensorMap* map_k = &tk;
  const CUtensorMap* map_v = &tv;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  unsigned char* sQ = smem + L::q;
  unsigned char* sK = smem + L::k;
  unsigned char* sV = smem + L::v;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = bar_q + 3;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int nq = (sq + kRows - 1) / kRows;
  const int iq = nq - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = iq * kRows, nvq = min(kRows, sq - q0);
  const bool has_seg = seg_q != nullptr;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, kRows * D * 2);
    for (int c = 0; c < D / 64; ++c)
      tma_load_4d(sQ + c * L::kHalfQ, map_q, bar_q, 64 * c, h, q0, b);
  }
  __syncthreads();

  // the live k tiles, in order: causally reachable and, with segment ids,
  // sharing an id range with the q tile (`_seg_gate`)
  int qlo = 0, qhi = 0;
  if (has_seg) seg_range(seg_q + (size_t)b * sq + q0, nvq, qlo, qhi);
  const int nk = (sk + N - 1) / N;
  const int kend = causal ? min(nk, (q0 + nvq - 1) / N + 1) : nk;
  auto next_live = [&](int ik, int& lo, int& hi) {
    for (; ik < kend; ++ik) {
      if (!has_seg) return ik;
      seg_range(seg_k + (size_t)b * sk + ik * N, min(N, sk - ik * N), lo, hi);
      if (qlo <= hi && qhi >= lo) return ik;
    }
    return kend;
  };
  auto load_kv = [&](int ik, int stage) {
    mbar_expect_tx(full + stage, 2 * L::kStageBytes);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(sK + stage * L::kStageBytes + c * L::kHalfKV, map_k,
                  full + stage, 64 * c, kvh, ik * N, b);
      tma_load_4d(sV + stage * L::kStageBytes + c * L::kHalfKV, map_v,
                  full + stage, 64 * c, kvh, ik * N, b);
    }
  };
  int klo = 0, khi = 0, nlo = 0, nhi = 0;
  int cur = next_live(0, klo, khi);
  int nxt = cur < kend ? next_live(cur + 1, nlo, nhi) : kend;
  if (tid == 0) {
    if (cur < kend) load_kv(cur, 0);
    if (nxt < kend) load_kv(nxt, 1);
  }
  __syncwarp();

  // this thread's rows: r0 and r0 + 8 of its warpgroup's 64
  const int r0 = 16 * warp + (lane >> 2);
  const int row0 = q0 + 64 * wg + r0;
  int sid[2] = {0, 0};
  for (int r = 0; r < 2; ++r)
    if (has_seg && row0 + 8 * r < sq)
      sid[r] = __ldg(seg_q + (size_t)b * sq + row0 + 8 * r);
  const float sl2 = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  const int wrow = q0 + 64 * wg;    // the warpgroup's first row
  mbar_wait(bar_q, 0);
  __syncwarp();  // converged for the .aligned wgmma

  for (int it = 0; cur < kend; ++it) {
    const int stage = it & 1;
    const uint32_t parity = (it >> 1) & 1;
    const int k0 = cur * N;
    mbar_wait(full + stage, parity);
    __syncwarp();  // converged for the .aligned wgmma
    // causal: every row of this warpgroup precedes every key of the tile
    const bool dead = causal && wrow + 63 < k0;
    if (!dead) {
      float s[N / 2];
      gemm_ss<N, D>(s, sQ + wg * 64 * kHalfBytes, L::kHalfQ,
                    sK + stage * L::kStageBytes, L::kHalfKV);
      wg_wait_all();
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) s[i] *= sl2;
      const bool seg_mask =
          has_seg && !(qlo == qhi && klo == khi && qlo == klo);
      if (k0 + N > sk || (causal && wrow < k0 + N - 1) || seg_mask) {
#pragma unroll
        for (int i = 0; i < N / 2; i += 2) {
          const int kj = k0 + acc_col(i, lane);
          int id0 = 0, id1 = 0;
          if (seg_mask) {
            if (kj < sk) id0 = __ldg(seg_k + (size_t)b * sk + kj);
            if (kj + 1 < sk) id1 = __ldg(seg_k + (size_t)b * sk + kj + 1);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = row0 + 8 * ((i >> 1) & 1), col = kj + e;
            const bool ok = col < sk && (!causal || qi >= col) &&
                            (!seg_mask || sid[(i >> 1) & 1] == (e ? id1 : id0));
            if (!ok) s[i + e] = kNegInf;
          }
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < N / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        corr[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      uint32_t p[N / 16][4];
      to_a_frags<N>(s, p);
      gemm_rs<N, D>(acc, p, sV + stage * L::kStageBytes, L::kHalfKV);
      wg_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(empty + stage);
    int lo = 0, hi = 0;
    const int after = nxt < kend ? next_live(nxt + 1, lo, hi) : kend;
    if (tid == 0 && after < kend) {
      mbar_wait(empty + stage, parity);
      load_kv(after, stage);
    }
    __syncwarp();
    cur = nxt;
    klo = nlo;
    khi = nhi;
    nxt = after;
    nlo = lo;
    nhi = hi;
  }

  // a row that never saw an unmasked key still has m == NEG_INF: o = 0,
  // lse = 0 (see the head of this file)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= sq) continue;
    const bool masked = m[r] <= kNegInf / 2;
    const float lr = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / lr;
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        o + (((size_t)b * sq + qi) * hq + h) * D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * r;
      orow[acc_col(i, lane) / 2] =
          masked ? 0u : pack_bf16(acc[i] * inv, acc[i + 1] * inv);
    }
    if ((lane & 3) == 0)
      lse[((size_t)b * hq + h) * sq + qi] =
          masked ? 0.f : (m[r] + log2f(lr)) * kLn2;
  }
}

template <int D>
struct DkvHopperSmem {
  // q tile rows: at D 128 the two 64-register accumulators, S^T and dP^T
  // (32 each) and their bf16 fragments take 252 registers, no spills
  static constexpr int M = 64;
  static constexpr int kHalfK = kRows * kHalfBytes;  // K, V tiles
  static constexpr int kHalfQ = M * kHalfBytes;      // Q, dO tiles
  static constexpr int kTile = M * D * 2;            // a Q or dO tile
  static constexpr int kStageBytes = 2 * kTile;      // Q and dO
  static constexpr size_t k = 0;
  static constexpr size_t v = k + kRows * D * 2;
  static constexpr size_t stage = v + kRows * D * 2;
  static constexpr size_t bars = stage + 2 * kStageBytes;  // kv, full, empty
  static constexpr size_t bytes = bars + 5 * 8 + 1024;
  static_assert(bytes <= kMaxSmem, "dK/dV tiles exceed shared memory");
};

// One block per (k tile of 128 rows, kv head, batch): warpgroup g owns
// keys 64 g .. 64 g + 63 and keeps their dK and dV sums in f32 registers
// over the whole walk (the n_rep query heads of the kv head x the q tiles
// of L::M rows in its causal range).  Thread 0 issues the TMA loads: K
// and V once, then Q and dO tiles through a 2-stage ring as in the
// forward.  lse and delta (4 bytes a q row each) come to the lanes
// straight from memory, one row a lane, while the products run: a 1-d
// TMA box longer than the whole lse tensor never completes its barrier.
// Per live q tile each warpgroup runs S^T = K.Q^T and dP^T = V.dO^T on
// wgmma into registers, forms P^T = exp(S^T scale - lse) and
// dS^T = P^T (dP^T - delta) there (masking only a tile that straddles the
// causal diagonal, the ragged end or a segment boundary), rounds both to
// bf16 and runs dV += P^T.dO and dK += dS^T.Q with them as register A
// operands.  dK is scaled once, at the end.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_hopper(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ seg_k, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int sq, int sk, int hq,
                         int hkv, float scale, int causal) {
  using L = DkvHopperSmem<D>;
  constexpr int M = L::M;
  // the maps are read by TMA in kernel-parameter space
  const CUtensorMap* map_q = &tq;
  const CUtensorMap* map_k = &tk;
  const CUtensorMap* map_v = &tv;
  const CUtensorMap* map_do = &tdo;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  unsigned char* sK = smem + L::k;
  unsigned char* sV = smem + L::v;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = bar_kv + 3;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int k0 = blockIdx.x * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int nvk = min(kRows, sk - k0);
  const int n_rep = hq / hkv;
  const bool has_seg = seg_q != nullptr;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * kRows * D * 2);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(sK + c * L::kHalfK, map_k, bar_kv, 64 * c, kvh, k0, b);
      tma_load_4d(sV + c * L::kHalfK, map_v, bar_kv, 64 * c, kvh, k0, b);
    }
  }
  __syncthreads();

  // the live q tiles: (query head rep, q tile iq) flattened as
  // u = rep * nqt + (iq - iq0), causally reachable and, with segment ids,
  // sharing an id range with the k tile
  int klo = 0, khi = 0;
  if (has_seg) seg_range(seg_k + (size_t)b * sk + k0, nvk, klo, khi);
  const int nq = (sq + M - 1) / M;
  const int iq0 = causal ? min(nq, k0 / M) : 0;
  const int nqt = nq - iq0, total = n_rep * nqt;
  auto next_live = [&](int u, int& lo, int& hi) {
    for (; u < total; ++u) {
      if (!has_seg) return u;
      const int q0 = (iq0 + u % nqt) * M;
      seg_range(seg_q + (size_t)b * sq + q0, min(M, sq - q0), lo, hi);
      if (lo <= khi && hi >= klo) return u;
    }
    return total;
  };
  auto load_q = [&](int u, int st) {
    const int h = kvh * n_rep + u / nqt, q0 = (iq0 + u % nqt) * M;
    unsigned char* base = smem + L::stage + st * L::kStageBytes;
    mbar_expect_tx(full + st, L::kStageBytes);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(base + c * L::kHalfQ, map_q, full + st, 64 * c, h, q0, b);
      tma_load_4d(base + L::kTile + c * L::kHalfQ, map_do, full + st, 64 * c,
                  h, q0, b);
    }
  };
  int qlo = 0, qhi = 0, nlo = 0, nhi = 0;
  int cur = next_live(0, qlo, qhi);
  int nxt = cur < total ? next_live(cur + 1, nlo, nhi) : total;
  if (tid == 0) {
    if (cur < total) load_q(cur, 0);
    if (nxt < total) load_q(nxt, 1);
  }
  __syncwarp();

  // this thread's keys: r0 and r0 + 8 of its warpgroup's 64
  const int r0 = 16 * warp + (lane >> 2);
  const int kw = k0 + 64 * wg;  // the warpgroup's first key
  const int key0 = kw + r0;
  int sid[2] = {0, 0};
  for (int r = 0; r < 2; ++r)
    if (has_seg && key0 + 8 * r < sk)
      sid[r] = __ldg(seg_k + (size_t)b * sk + key0 + 8 * r);
  const float sl2 = scale * kLog2e;
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    acc_k[i] = 0.f;
    acc_v[i] = 0.f;
  }
  mbar_wait(bar_kv, 0);
  __syncwarp();  // converged for the .aligned wgmma

  for (int it = 0; cur < total; ++it) {
    const int st = it & 1;
    const uint32_t parity = (it >> 1) & 1;
    const int q0 = (iq0 + cur % nqt) * M;
    const unsigned char* sQ = smem + L::stage + st * L::kStageBytes;
    const unsigned char* sDO = sQ + L::kTile;
    mbar_wait(full + st, parity);
    __syncwarp();  // converged for the .aligned wgmma
    // causal: every query row of the tile precedes every key of this
    // warpgroup; or the warpgroup's keys lie past the end
    const bool dead = (causal && q0 + M - 1 < kw) || kw >= sk;
    if (!dead) {
      // lse (in log2 units) and delta of the tile's q rows: lane l holds
      // rows l and l + 32, read while the products run; a thread takes
      // its columns' values by shuffle
      const int h = kvh * n_rep + cur / nqt;
      const size_t row = ((size_t)b * hq + h) * sq + q0;
      float lse_l[M / 32], dl_l[M / 32];
#pragma unroll
      for (int w = 0; w < M / 32; ++w) {
        const bool in = q0 + 32 * w + lane < sq;
        lse_l[w] = in ? __ldg(lse + row + 32 * w + lane) * kLog2e : 0.f;
        dl_l[w] = in ? __ldg(delta + row + 32 * w + lane) : 0.f;
      }
      float s[M / 2], dp[M / 2];
      gemm_ss<M, D>(s, sK + wg * 64 * kHalfBytes, L::kHalfK, sQ, L::kHalfQ);
      gemm_ss<M, D>(dp, sV + wg * 64 * kHalfBytes, L::kHalfK, sDO,
                    L::kHalfQ);
      wg_wait_all();
      fence_regs(s);
      fence_regs(dp);
      const bool seg_mask =
          has_seg && !(qlo == qhi && klo == khi && qlo == klo);
      const bool mask =
          q0 + M > sq || (causal && q0 < kw + 63) || seg_mask;
#pragma unroll
      for (int j = 0; j < M / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // column c of the tile, rows r0 (element 4 j + e) and r0 + 8
          const int c = acc_col(4 * j + e, lane), qi = q0 + c;
          const float lse_c = __shfl_sync(kFull, lse_l[j / 4], c & 31);
          const float dl_c = __shfl_sync(kFull, dl_l[j / 4], c & 31);
          const int id = seg_mask && qi < sq
                             ? __ldg(seg_q + (size_t)b * sq + qi) : 0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r + e, kj = key0 + 8 * r;
            const bool ok = !mask || (qi < sq && (!causal || qi >= kj) &&
                                      (!seg_mask || sid[r] == id));
            const float p = ok ? exp2f(fmaf(s[i], sl2, -lse_c)) : 0.f;
            s[i] = p;
            dp[i] = p * (dp[i] - dl_c);
          }
        }
      }
      uint32_t pa[M / 16][4], dsa[M / 16][4];
      to_a_frags<M>(s, pa);
      to_a_frags<M>(dp, dsa);
      gemm_rs<M, D>(acc_v, pa, sDO, L::kHalfQ);
      gemm_rs<M, D>(acc_k, dsa, sQ, L::kHalfQ);
      wg_wait_all();
      fence_regs(acc_v);
      fence_regs(acc_k);
    }
    mbar_arrive(empty + st);
    int lo = 0, hi = 0;
    const int after = nxt < total ? next_live(nxt + 1, lo, hi) : total;
    if (tid == 0 && after < total) {
      mbar_wait(empty + st, parity);
      load_q(after, st);
    }
    __syncwarp();
    cur = nxt;
    qlo = nlo;
    qhi = nhi;
    nxt = after;
    nlo = lo;
    nhi = hi;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key0 + 8 * r;
    if (kj >= sk) continue;
    const size_t off = (((size_t)b * sk + kj) * hkv + kvh) * D;
    uint32_t* krow = reinterpret_cast<uint32_t*>(dk + off);
    uint32_t* vrow = reinterpret_cast<uint32_t*>(dv + off);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * r, c = acc_col(i, lane) / 2;
      krow[c] = pack_bf16(acc_k[i] * scale, acc_k[i + 1] * scale);
      vrow[c] = pack_bf16(acc_v[i], acc_v[i + 1]);
    }
  }
}

template <int D>
struct DqHopperSmem {
  // k tile rows: at D 128 the 64-register dQ accumulator, S and dP (64
  // each) and dS's bf16 fragments fit in 255 registers with no spills;
  // 64-key tiles ran slower in a trial (more barrier round trips a row)
  static constexpr int N = 128;
  static constexpr int kHalfQ = kRows * kHalfBytes;  // Q, dO tiles
  static constexpr int kHalfKV = N * kHalfBytes;     // K, V tiles
  static constexpr int kTile = N * D * 2;            // a K or V tile
  static constexpr int kStageBytes = 2 * kTile;      // K and V
  static constexpr size_t q = 0;
  static constexpr size_t d_o = q + kRows * D * 2;
  static constexpr size_t stage = d_o + kRows * D * 2;
  static constexpr size_t bars = stage + 2 * kStageBytes;  // q, full, empty
  static constexpr size_t bytes = bars + 5 * 8 + 1024;
  static_assert(bytes <= kMaxSmem, "dQ tiles exceed shared memory");
};

// One block per (q tile of 128 rows, query head, batch): warpgroup g owns
// rows 64 g .. 64 g + 63 and keeps their dQ sum in f32 registers over the
// whole walk.  Thread 0 issues the TMA loads: Q and dO once, then the K
// and V tiles of kv head h / n_rep through a 2-stage ring as in the
// forward.  A thread's two rows are fixed, so their lse and delta are
// read once, by plain loads.  Per live k tile each warpgroup runs
// S = Q.K^T and dP = dO.V^T on wgmma into registers, forms
// P = exp(S scale - lse) and dS = P (dP - delta) there (masking only a
// tile that straddles the causal diagonal, the ragged end or a segment
// boundary), rounds dS to bf16 and runs dQ += dS.K with it as the
// register A operand: the K tile serves as the K-major B of Q.K^T and
// the MN-major B of dS.K.  dQ is scaled once, at the end.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_hopper(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ seg_q,
                        const int* __restrict__ seg_k, bf16* __restrict__ dq,
                        int sq, int sk, int hq, int hkv, float scale,
                        int causal) {
  using L = DqHopperSmem<D>;
  constexpr int N = L::N;
  // the maps are read by TMA in kernel-parameter space
  const CUtensorMap* map_q = &tq;
  const CUtensorMap* map_k = &tk;
  const CUtensorMap* map_v = &tv;
  const CUtensorMap* map_do = &tdo;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  unsigned char* sQ = smem + L::q;
  unsigned char* sDO = smem + L::d_o;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = bar_q + 3;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int nq = (sq + kRows - 1) / kRows;
  const int iq = nq - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int q0 = iq * kRows, nvq = min(kRows, sq - q0);
  const bool has_seg = seg_q != nullptr;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, 2 * kRows * D * 2);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(sQ + c * L::kHalfQ, map_q, bar_q, 64 * c, h, q0, b);
      tma_load_4d(sDO + c * L::kHalfQ, map_do, bar_q, 64 * c, h, q0, b);
    }
  }
  __syncthreads();

  // the live k tiles, in order: causally reachable and, with segment ids,
  // sharing an id range with the q tile (`_seg_gate`)
  int qlo = 0, qhi = 0;
  if (has_seg) seg_range(seg_q + (size_t)b * sq + q0, nvq, qlo, qhi);
  const int nk = (sk + N - 1) / N;
  const int kend = causal ? min(nk, (q0 + nvq - 1) / N + 1) : nk;
  auto next_live = [&](int ik, int& lo, int& hi) {
    for (; ik < kend; ++ik) {
      if (!has_seg) return ik;
      seg_range(seg_k + (size_t)b * sk + ik * N, min(N, sk - ik * N), lo, hi);
      if (qlo <= hi && qhi >= lo) return ik;
    }
    return kend;
  };
  auto load_kv = [&](int ik, int st) {
    unsigned char* base = smem + L::stage + st * L::kStageBytes;
    mbar_expect_tx(full + st, L::kStageBytes);
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(base + c * L::kHalfKV, map_k, full + st, 64 * c, kvh,
                  ik * N, b);
      tma_load_4d(base + L::kTile + c * L::kHalfKV, map_v, full + st, 64 * c,
                  kvh, ik * N, b);
    }
  };
  int klo = 0, khi = 0, nlo = 0, nhi = 0;
  int cur = next_live(0, klo, khi);
  int nxt = cur < kend ? next_live(cur + 1, nlo, nhi) : kend;
  if (tid == 0) {
    if (cur < kend) load_kv(cur, 0);
    if (nxt < kend) load_kv(nxt, 1);
  }
  __syncwarp();

  // this thread's rows: r0 and r0 + 8 of its warpgroup's 64, with their
  // segment ids, lse (log2 units) and delta; 0 past the end
  const int r0 = 16 * warp + (lane >> 2);
  const int wrow = q0 + 64 * wg;  // the warpgroup's first row
  const int row0 = wrow + r0;
  int sid[2] = {0, 0};
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= sq) continue;
    const size_t row = ((size_t)b * hq + h) * sq + qi;
    lse2[r] = __ldg(lse + row) * kLog2e;
    dl[r] = __ldg(delta + row);
    if (has_seg) sid[r] = __ldg(seg_q + (size_t)b * sq + qi);
  }
  const float sl2 = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_q, 0);
  __syncwarp();  // converged for the .aligned wgmma

  for (int it = 0; cur < kend; ++it) {
    const int st = it & 1;
    const uint32_t parity = (it >> 1) & 1;
    const int k0 = cur * N;
    const unsigned char* sK = smem + L::stage + st * L::kStageBytes;
    const unsigned char* sV = sK + L::kTile;
    mbar_wait(full + st, parity);
    __syncwarp();  // converged for the .aligned wgmma
    // causal: every row of this warpgroup precedes every key of the tile;
    // or the warpgroup's rows lie past the end
    const bool dead = (causal && wrow + 63 < k0) || wrow >= sq;
    if (!dead) {
      float s[N / 2], dp[N / 2];
      gemm_ss<N, D>(s, sQ + wg * 64 * kHalfBytes, L::kHalfQ, sK, L::kHalfKV);
      gemm_ss<N, D>(dp, sDO + wg * 64 * kHalfBytes, L::kHalfQ, sV,
                    L::kHalfKV);
      // P while dP's products still run
      wg_wait_one();
      fence_regs(s);
      const bool seg_mask =
          has_seg && !(qlo == qhi && klo == khi && qlo == klo);
      const bool mask =
          k0 + N > sk || (causal && wrow < k0 + N - 1) || seg_mask;
#pragma unroll
      for (int i = 0; i < N / 2; i += 2) {
        const int kj = k0 + acc_col(i, lane);
        int id0 = 0, id1 = 0;
        if (seg_mask) {
          if (kj < sk) id0 = __ldg(seg_k + (size_t)b * sk + kj);
          if (kj + 1 < sk) id1 = __ldg(seg_k + (size_t)b * sk + kj + 1);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = (i >> 1) & 1, qi = row0 + 8 * r, col = kj + e;
          const bool ok = !mask || (col < sk && (!causal || qi >= col) &&
                                    (!seg_mask || sid[r] == (e ? id1 : id0)));
          s[i + e] = ok ? exp2f(fmaf(s[i + e], sl2, -lse2[r])) : 0.f;
        }
      }
      wg_wait_all();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) s[i] *= dp[i] - dl[(i >> 1) & 1];
      uint32_t dsa[N / 16][4];
      to_a_frags<N>(s, dsa);
      gemm_rs<N, D>(acc, dsa, sK, L::kHalfKV);
      wg_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(empty + st);
    int lo = 0, hi = 0;
    const int after = nxt < kend ? next_live(nxt + 1, lo, hi) : kend;
    if (tid == 0 && after < kend) {
      mbar_wait(empty + st, parity);
      load_kv(after, st);
    }
    __syncwarp();
    cur = nxt;
    klo = nlo;
    khi = nhi;
    nxt = after;
    nlo = lo;
    nhi = hi;
  }

  // a row with no live key has p = 0 on every tile: dq = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= sq) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(
        dq + (((size_t)b * sq + qi) * hq + h) * D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * r;
      row[acc_col(i, lane) / 2] = pack_bf16(acc[i] * scale, acc[i + 1] * scale);
    }
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

// cuTensorMapEncodeTiled, looked up at run time so that the library
// links against the CUDA runtime only (no -lcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A [b, s, h, d] bf16 tensor as boxes of (64 columns, 1 head, `rows` rows,
// 1 batch), 128-byte swizzled; rows past s read as 0.
bool map_bshd(CUtensorMap* map, const void* p, int b, int s, int h, int d,
              int rows) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h,
                              (cuuint64_t)std::max(s, 1), (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2,
                                 (cuuint64_t)std::max(s, 1) * h * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int fwd_hopper(const Shape& s, const void* q, const void* k, const void* v,
               const void* sgq, const void* sgk, void* o, void* lse,
               cudaStream_t st) {
  using L = FwdHopperSmem<D>;
  CUtensorMap tq, tk, tv;
  if (!map_bshd(&tq, q, s.b, s.sq, s.hq, D, kRows) ||
      !map_bshd(&tk, k, s.b, s.sk, s.hkv, D, kFwdKeys) ||
      !map_bshd(&tv, v, s.b, s.sk, s.hkv, D, kFwdKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_fwd_hopper<D>;
  cudaError_t e = prepare(kern, L::bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s.sq + kRows - 1) / kRows, s.hq, s.b);
  kern<<<grid, kThreads, L::bytes, st>>>(
      tq, tk, tv, static_cast<const int*>(sgq), static_cast<const int*>(sgk),
      static_cast<bf16*>(o), static_cast<float*>(lse), s.sq, s.sk, s.hq,
      s.hkv, s.scale, s.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dkv_hopper(const Shape& s, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               const void* sgq, const void* sgk, void* dk, void* dv,
               cudaStream_t st) {
  using L = DkvHopperSmem<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!map_bshd(&tq, q, s.b, s.sq, s.hq, D, L::M) ||
      !map_bshd(&tdo, dout, s.b, s.sq, s.hq, D, L::M) ||
      !map_bshd(&tk, k, s.b, s.sk, s.hkv, D, kRows) ||
      !map_bshd(&tv, v, s.b, s.sk, s.hkv, D, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dkv_hopper<D>;
  cudaError_t e = prepare(kern, L::bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s.sk + kRows - 1) / kRows, s.hkv, s.b);
  kern<<<grid, kThreads, L::bytes, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(sgq),
      static_cast<const int*>(sgk), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s.sq, s.sk, s.hq, s.hkv, s.scale, s.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq_hopper(const Shape& s, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta,
              const void* sgq, const void* sgk, void* dqo, cudaStream_t st) {
  using L = DqHopperSmem<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!map_bshd(&tq, q, s.b, s.sq, s.hq, D, kRows) ||
      !map_bshd(&tdo, dout, s.b, s.sq, s.hq, D, kRows) ||
      !map_bshd(&tk, k, s.b, s.sk, s.hkv, D, L::N) ||
      !map_bshd(&tv, v, s.b, s.sk, s.hkv, D, L::N))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dq_hopper<D>;
  cudaError_t e = prepare(kern, L::bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s.sq + kRows - 1) / kRows, s.hq, s.b);
  kern<<<grid, kThreads, L::bytes, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(sgq),
      static_cast<const int*>(sgk), static_cast<bf16*>(dqo), s.sq, s.sk,
      s.hq, s.hkv, s.scale, s.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int fwd_smem(const Shape& s, const void* q, const void* k, const void* v,
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
int dkv_smem(const Shape& s, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta,
             const void* sgq, const void* sgk, void* dk, void* dv,
             cudaStream_t st) {
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

// bf16 at D 64 and 128 runs the Hopper bodies; float (full f32 products,
// which wgmma would round to TF32) and bf16 at D 256 (whose register
// accumulators would not fit) the shared-memory bodies.
template <typename T, int D>
int fwd(const Shape& s, const void* q, const void* k, const void* v,
        const void* sgq, const void* sgk, void* o, void* lse,
        cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value && D <= 128)
    return fwd_hopper<D>(s, q, k, v, sgq, sgk, o, lse, st);
  else
    return fwd_smem<T, D>(s, q, k, v, sgq, sgk, o, lse, st);
}

template <typename T, int D>
int dkv(const Shape& s, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, const void* sgq,
        const void* sgk, void* dk, void* dv, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value && D <= 128)
    return dkv_hopper<D>(s, q, k, v, dout, lse, delta, sgq, sgk, dk, dv, st);
  else
    return dkv_smem<T, D>(s, q, k, v, dout, lse, delta, sgq, sgk, dk, dv,
                          st);
}

template <typename T, int D>
int dq_smem(const Shape& s, const void* q, const void* k, const void* v,
            const void* dout, const void* lse, const void* delta,
            const void* sgq, const void* sgk, void* dqo, cudaStream_t st) {
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

template <typename T, int D>
int dq(const Shape& s, const void* q, const void* k, const void* v,
       const void* dout, const void* lse, const void* delta, const void* sgq,
       const void* sgk, void* dqo, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value && D <= 128)
    return dq_hopper<D>(s, q, k, v, dout, lse, delta, sgq, sgk, dqo, st);
  else
    return dq_smem<T, D>(s, q, k, v, dout, lse, delta, sgq, sgk, dqo, st);
}

// Dynamic shared memory of one block: kernel 0 forward, 1 dK/dV, 2 dQ.
template <typename T, int D>
int smem_bytes(int kernel) {
  if constexpr (std::is_same<T, bf16>::value && D <= 128)
    return static_cast<int>(kernel == 0   ? FwdHopperSmem<D>::bytes
                            : kernel == 1 ? DkvHopperSmem<D>::bytes
                                          : DqHopperSmem<D>::bytes);
  else
    return static_cast<int>(kernel == 0   ? FwdSmem<T, D>::bytes
                            : kernel == 1 ? DkvSmem<T, D>::bytes
                                          : DqSmem<T, D>::bytes);
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

// The dynamic shared memory a launch of `kernel` (0 forward, 1 dK/dV,
// 2 dQ) asks for at this dtype code and head dim; -1 for a combination
// the launches do not take.
extern "C" int flash_smem_bytes(int kernel, int dtype, int d) {
  if (kernel < 0 || kernel > 2 || (dtype != 0 && dtype != 1) ||
      (d != 64 && d != 128 && d != 256))
    return -1;
  FLASH_DISPATCH(dtype, d, smem_bytes, kernel);
}
