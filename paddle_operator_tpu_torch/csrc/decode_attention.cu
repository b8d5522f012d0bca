// Single-query (decode) GQA attention over the filled prefix of a KV
// cache, for Hopper (sm_90a): one templated body, two row addressings.
//
// Replaces two TPU kernels of paddle_operator_tpu/ops/decode_attention.py:
//
// - `_kernel` (and its `_cell_softmax`), reached through
//   `decode_attention`: the contiguous head-major cache [B, Hkv, S, D];
//   entry `decode_attention_launch`.
// - `_paged_kernel`, reached through `paged_decode_attention`: the paged
//   block pool [N, Hkv, bs, D] (one layer's view) walked through a block
//   table [B, M] — lane b's row r lives at pool block table[b, r / bs],
//   offset r % bs; entry `paged_decode_attention_launch`.  The TPU kernel
//   reached the table only through its index map, so the pool block was
//   its key block; here the block reads its own table entry as its loop
//   crosses into each pool block.
//
// Same function for both: for each lane b and query head h, softmax over
// key rows [0, lengths[b]) of kv-head h / n_rep, applied to V; scale
// 1/sqrt(D) unless given; f32 running max, sum and accumulator; a lane
// of length 0 outputs zeros.  Table entries at or past
// ceil(lengths[b] / bs) are never read (retired lanes' rows point at the
// trash block 0; an id outside [0, N) reads block 0 too, so a bad table
// can never address memory outside the pool).
//
// What bounds it: reading the filled K and V rows.  Per lane and
// kv-head that is 2 * lengths[b] * D * sizeof(T) bytes against about
// 4 * n_rep * lengths[b] * D flops — a fraction of a flop per byte, far
// below the ~295 flop/byte where Hopper's tensor cores would be the
// limit.  So the design only has to stream those bytes once and never
// touch the rest of the cache:
//
// - one thread block per (lane b, kv head, group of R <= 4 query
//   heads): the block loops over key rows up to lengths[b] only — the
//   fill skip; rows past the fill are never read.  A GQA group of
//   n_rep <= 4 heads shares one pass over its K/V rows.
// - warps split the key range (interleaved, kUnroll rows per lane
//   group in flight) and keep private online-softmax state; a warp's
//   lane groups merge by shuffles, the warps through shared memory at
//   the end.
// - each key row is read by a group of g lanes with 16-byte loads along
//   D (g = D / (16 / sizeof(T)) rounded up to a power of two, at most
//   32); the q.k dot product reduces over the group by shuffles.
// - the row address is the only difference between the two entries: a
//   `Rows` functor maps a key row to its element offset (contiguous
//   stride, or table lookup + block offset).
//
// Not carried over from the TPU kernels: their (B, key-blocks) grid with
// scratch carried between steps, the masked all-heads contraction (a
// trick for the MXU's 128-lane tiles) and the transposed [hq, rows]
// bookkeeping.  Left for later: split-K over SMs for long fills
// (flash-decoding) and cp.async/TMA double buffering.
//
// Accepts float and bfloat16, D a multiple of 8 up to 256, any
// Hq % Hkv == 0, any S (contiguous) or any block size bs >= 1 (paged).
// Pointers must be 16-byte aligned and the tensors contiguous (the
// Python wrapper checks).  Launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr int kMaxR = 4;    // query heads served by one block
constexpr int kUnroll = 2;  // key rows per lane group in flight

template <typename T>
struct Vec;

// 16 bytes of T -> floats
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
  __device__ __forceinline__ static float from_float(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

// key row j of (lane, kv head) -> element offset into k and v
struct ContigRows {
  size_t base;  // ((b * hkv + kvh) * s) * d
  int d;
  __device__ __forceinline__ size_t operator()(int j) const {
    return base + (size_t)j * d;
  }
};

struct PagedRows {
  const int* tbl;  // this lane's table row, [M]
  int bs, hkv, kvh, d, nblocks;
  __device__ __forceinline__ size_t operator()(int j) const {
    int blk = __ldg(tbl + j / bs);
    if (blk < 0 || blk >= nblocks) blk = 0;  // the trash block
    return (((size_t)blk * hkv + kvh) * bs + (j % bs)) * d;
  }
};

// The shared body: query heads [h0, h0 + R) of lane b against key rows
// [0, len) of one kv head, rows addressed by `rows`.
template <typename T, int R, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, int b, int h0,
                                       int hq, int d, float scale, int len,
                                       const Rows& rows) {
  using V = Vec<T>;
  constexpr int VEC = V::N;
  constexpr int MAXC = (kMaxD / VEC + 31) / 32;  // 16-byte chunks per lane
  constexpr int E = MAXC * VEC;                  // floats per lane per row
  constexpr unsigned kFull = 0xffffffffu;

  const int nchunks = d / VEC;
  int g = 1;  // lanes per key row
  while (g < nchunks && g < 32) g <<= 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane & (g - 1);
  const int grp = lane / g;
  const int groups = 32 / g;

  // this lane's slice of the R query rows, pre-scaled
  float qv[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int chunk = gl + c * g;
      if (chunk < nchunks) {
        V::load(q + ((size_t)b * hq + h0 + r) * d + chunk * VEC,
                &qv[r][c * VEC]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) qv[r][c * VEC + e] *= scale;
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qv[r][c * VEC + e] = 0.f;
      }
    }
  }

  float m[R], l[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  const int warp_rows = groups * kUnroll;

  // the loop bound depends on the warp only, so every lane of a warp
  // takes the same trip count and the shuffles below stay converged
  for (int j0 = warp * warp_rows; j0 < len; j0 += kWarps * warp_rows) {
    float kf[kUnroll][E], vf[kUnroll][E];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * groups + grp;
      valid[u] = j < len;
      const size_t off = valid[u] ? rows(j) : 0;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int chunk = gl + c * g;
        if (valid[u] && chunk < nchunks) {
          V::load(k + off + chunk * VEC, &kf[u][c * VEC]);
          V::load(v + off + chunk * VEC, &vf[u][c * VEC]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            kf[u][c * VEC + e] = 0.f;
            vf[u][c * VEC + e] = 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float sc = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) sc += qv[r][e] * kf[u][e];
        for (int off = g >> 1; off > 0; off >>= 1)
          sc += __shfl_xor_sync(kFull, sc, off);
        if (valid[u]) {
          const float mn = fmaxf(m[r], sc);
          const float corr = expf(m[r] - mn);  // 0 while m is -inf
          const float p = expf(sc - mn);
          l[r] = l[r] * corr + p;
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[r][e] = acc[r][e] * corr + p * vf[u][e];
          m[r] = mn;
        }
      }
    }
  }

  // merge the lane groups of this warp (lanes with the same gl)
  for (int off = g; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float om = __shfl_xor_sync(kFull, m[r], off);
      const float ol = __shfl_xor_sync(kFull, l[r], off);
      const float mn = fmaxf(m[r], om);
      const float c1 = mn == -INFINITY ? 0.f : expf(m[r] - mn);
      const float c2 = mn == -INFINITY ? 0.f : expf(om - mn);
      l[r] = l[r] * c1 + ol * c2;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float oa = __shfl_xor_sync(kFull, acc[r][e], off);
        acc[r][e] = acc[r][e] * c1 + oa * c2;
      }
      m[r] = mn;
    }
  }

  // merge the warps through shared memory
  __shared__ float sm_m[kWarps][kMaxR];
  __shared__ float sm_l[kWarps][kMaxR];
  __shared__ float sm_acc[kWarps][kMaxR][kMaxD];
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (gl == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int chunk = gl + c * g;
        if (chunk < nchunks) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            sm_acc[warp][r][chunk * VEC + e] = acc[r][c * VEC + e];
        }
      }
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < R * d; idx += kThreads) {
    const int r = idx / d;
    const int col = idx - r * d;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float o = 0.f;  // length-0 lane: zeros, not 0/0
    if (mx != -INFINITY) {
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(sm_m[w][r] - mx);
        den += sm_l[w][r] * c;
        num += sm_acc[w][r][col] * c;
      }
      o = num / den;
    }
    out[((size_t)b * hq + h0 + r) * d + col] = V::from_float(o);
  }
}

// grid (hkv * n_rep / R, B): block -> (lane, kv head, first query head)
__device__ __forceinline__ void block_heads(int hq, int hkv, int R,
                                            int* kvh, int* h0) {
  const int n_rep = hq / hkv;
  const int passes = n_rep / R;
  *kvh = blockIdx.x / passes;
  *h0 = *kvh * n_rep + (blockIdx.x % passes) * R;
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, int hq, int hkv, int s,
                            int d, float scale) {
  int kvh, h0;
  block_heads(hq, hkv, R, &kvh, &h0);
  const int b = blockIdx.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > s ? s : len);
  const ContigRows rows{((size_t)b * hkv + kvh) * (size_t)s * d, d};
  attend<T, R>(q, k, v, out, b, h0, hq, d, scale, len, rows);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    paged_decode_attention_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k_pool,
                                  const T* __restrict__ v_pool,
                                  const int* __restrict__ table,
                                  const int* __restrict__ lengths,
                                  T* __restrict__ out, int hq, int hkv,
                                  int nblocks, int bs, int max_blocks,
                                  int d, float scale) {
  int kvh, h0;
  block_heads(hq, hkv, R, &kvh, &h0);
  const int b = blockIdx.y;
  const int view = max_blocks * bs;  // the lane's table covers this many
  int len = lengths[b];
  len = len < 0 ? 0 : (len > view ? view : len);
  const PagedRows rows{table + (size_t)b * max_blocks, bs, hkv, kvh, d,
                       nblocks};
  attend<T, R>(q, k_pool, v_pool, out, b, h0, hq, d, scale, len, rows);
}

inline int heads_per_block(int n_rep) {
  return n_rep % 4 == 0 ? 4 : (n_rep % 2 == 0 ? 2 : 1);
}

template <typename T>
void launch_contig(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int b, int hq, int hkv,
                   int s, int d, float scale, cudaStream_t stream) {
  const int r = heads_per_block(hq / hkv);
  const dim3 grid(hkv * (hq / hkv / r), b);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const int* lp = static_cast<const int*>(lengths);
  T* op = static_cast<T*>(out);
  switch (r) {
    case 4:
      decode_attention_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, lp, op, hq, hkv, s, d, scale);
      break;
    case 2:
      decode_attention_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, lp, op, hq, hkv, s, d, scale);
      break;
    default:
      decode_attention_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, lp, op, hq, hkv, s, d, scale);
  }
}

template <typename T>
void launch_paged(const void* q, const void* k, const void* v,
                  const void* table, const void* lengths, void* out, int b,
                  int hq, int hkv, int nblocks, int bs, int max_blocks,
                  int d, float scale, cudaStream_t stream) {
  const int r = heads_per_block(hq / hkv);
  const dim3 grid(hkv * (hq / hkv / r), b);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const int* tp = static_cast<const int*>(table);
  const int* lp = static_cast<const int*>(lengths);
  T* op = static_cast<T*>(out);
  switch (r) {
    case 4:
      paged_decode_attention_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, tp, lp, op, hq, hkv, nblocks, bs, max_blocks, d,
          scale);
      break;
    case 2:
      paged_decode_attention_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, tp, lp, op, hq, hkv, nblocks, bs, max_blocks, d,
          scale);
      break;
    default:
      paged_decode_attention_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
          qp, kp, vp, tp, lp, op, hq, hkv, nblocks, bs, max_blocks, d,
          scale);
  }
}

bool bad_heads(int b, int hq, int hkv, int d) {
  return b <= 0 || b > 65535 || hkv <= 0 || hq <= 0 || hq % hkv != 0 ||
         d <= 0 || d % 8 != 0 || d > kMaxD;
}

}  // namespace

// q [B, Hq, D]; k, v [B, Hkv, S, D]; lengths [B] int32; out [B, Hq, D].
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t as int.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int b, int hq, int hkv,
                                       int s, int d, float scale, int dtype,
                                       void* stream) {
  if (bad_heads(b, hq, hkv, d) || s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_contig<float>(q, k, v, lengths, out, b, hq, hkv, s, d, scale, st);
  } else if (dtype == 1) {
    launch_contig<__nv_bfloat16>(q, k, v, lengths, out, b, hq, hkv, s, d,
                                 scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q [B, Hq, D]; k_pool, v_pool [N, Hkv, bs, D] (one layer of the pool);
// table [B, M] int32 pool block ids; lengths [B] int32; out [B, Hq, D].
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t as int.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lengths, void* out, int b, int hq, int hkv, int nblocks,
    int bs, int max_blocks, int d, float scale, int dtype, void* stream) {
  if (bad_heads(b, hq, hkv, d) || nblocks <= 0 || bs <= 0 ||
      max_blocks <= 0 || (long long)max_blocks * bs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_paged<float>(q, k_pool, v_pool, table, lengths, out, b, hq, hkv,
                        nblocks, bs, max_blocks, d, scale, st);
  } else if (dtype == 1) {
    launch_paged<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, out, b,
                                hq, hkv, nblocks, bs, max_blocks, d, scale,
                                st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
