// Single-query (decode) GQA attention over the filled prefix of a KV
// cache, for Hopper (sm_90a): one templated body, three row sources.
//
// Replaces three TPU kernels of paddle_operator_tpu/ops/decode_attention.py:
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
// - `_paged_kernel_quant`, the same over the INT8 pool (SERVE_KV_QUANT=
//   int8): int8 codes [N, Hkv, bs, D] with one f32 scale per (block, kv
//   head) [N, Hkv], and per-lane staging tails [lanes + 1, Hkv, bs, D] in
//   T; entry `paged_decode_attention_quant_launch`.  Lane b's row r in
//   block j = r / bs reads tail[b, kvh, r % bs] when j is the lane's
//   write-frontier block wb = max(lengths[b] - 1, 0) / bs (the one block
//   not yet quantized), else code * scale[table[b, j], kvh] in f32,
//   rounded to T before the product — the Pallas cell's
//   `where(ik == wb, tail, codes * scale).astype(dtype)`.
//
// Same function for all three: for each lane b and query head h, softmax
// over key rows [0, lengths[b]) of kv-head h / n_rep, applied to V; scale
// 1/sqrt(D) unless given; f32 running max, sum and accumulator; p rounded
// to T before P.V; a lane of length 0 outputs zeros.  Table entries at or
// past ceil(lengths[b] / bs) are never read (retired lanes' rows point at
// the trash block 0; an id outside [0, N) reads block 0 too, so a bad
// table can never address memory outside the pool).
//
// What bounds them: reading the filled K and V rows.  Per lane and
// kv-head that is 2 * lengths[b] * D * sizeof(T) bytes (one byte an
// element for the int8 pool's full blocks) against about
// 4 * n_rep * lengths[b] * D flops — a fraction of a flop per byte, far
// below the ~295 flop/byte where Hopper's tensor cores would be the
// limit.  So the design only has to stream those bytes once and never
// touch the rest of the cache:
//
// - one thread block per (lane b, kv head, group of R <= 4 query
//   heads) for the paged kernels; for the contiguous kernel one per
//   (lane, kv head, group, chunk of 256 key rows), so that a long fill
//   keeps every SM streaming (split-K, flash-decoding; see below).  A
//   block loops over key rows up to lengths[b] only — the fill skip;
//   rows past the fill are never read.  A GQA group of n_rep <= 4 heads
//   shares one pass over its K/V rows.
// - warps split a range of key rows (interleaved, kUnroll rows per lane
//   group in flight) and keep private online-softmax state; a warp's
//   lane groups merge by shuffles, the warps through shared memory at
//   the end.
// - each key row is read by a group of g lanes along D, VEC elements a
//   lane (VEC = 16 / sizeof(T); g = D / VEC rounded up to a power of two,
//   at most 32); the q.k dot product reduces over the group by shuffles.
// - a row source maps a key row to its data: the contiguous and paged
//   kernels run one range [0, len) whose source computes each row's
//   offset (a stride, or a table lookup + block offset); the int8 kernel
//   runs one range per lane block, so its table entry, its two scales
//   and the tail-or-codes choice are taken once per block, uniformly for
//   the whole thread block, and the inner loop has no branch on them.
// - int8 rows keep kernel #2's per-lane fragment of VEC elements: a lane
//   loads VEC codes at once (8 bytes for bf16, 4 for f32) rather than a
//   full 16 bytes, so the thread layout, the shuffles and the merge are
//   the same for every kernel; the tail block loads 16 bytes of T.
//
// - the contiguous kernel's split: one block per (lane, kv head, head
//   group) streams a lane's whole fill with too few bytes in flight to
//   cover the card's load latency (41% of the byte bound at fill 2048,
//   B 4: 128 blocks on 132 SMs).  Its grid is (head groups, B, chunks),
//   the chunk count fixed by the cache's capacity S and the caller's
//   chunk rows (a host shape, so the launch reads no length back); a
//   chunk at or past lengths[b] exits at once.  A lane whose fill fits
//   one chunk gets its output from that chunk's block; otherwise every
//   live chunk writes its partial (f32 accumulator, row max, row sum) to
//   a workspace the caller passes and takes an atomic ticket, and the
//   lane's last chunk to finish merges all partials in chunk order, so
//   two runs give the same bits.  A second merge kernel was slower at
//   short and middle fills and no faster at long ones (its launch and
//   its own load latency); the tickets cost a counter per (lane, head
//   group) that the merging block leaves at 0 for the next launch.  The
//   split kernel at R = 1 is held to 64 registers, so four blocks share
//   an SM.
//
// Not carried over from the TPU kernels: their (B, key-blocks) grid with
// scratch carried between steps, the masked all-heads contraction (a
// trick for the MXU's 128-lane tiles) and the transposed [hq, rows]
// bookkeeping.  Left for later: the split for the paged kernels,
// cp.async/TMA double buffering, and 16-byte code loads.
//
// Accepts float and bfloat16, D a multiple of 8 up to 256, any
// Hq % Hkv == 0, any S (contiguous) or any block size bs >= 1 (paged).
// Pointers must be 16-byte aligned and the tensors contiguous (the
// Python wrapper checks).  Launches on the given stream, allocates
// nothing (the split's workspace and tickets come from the caller), and
// returns cudaGetLastError().

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

// 16 bytes of T -> floats; VEC int8 codes x scale -> floats rounded to T
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
  __device__ __forceinline__ static void load_codes(const int8_t* p,
                                                    float s, float* o) {
    const int raw = *reinterpret_cast<const int*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = static_cast<float>(c[i]) * s;
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
  __device__ __forceinline__ static void load_codes(const int8_t* p,
                                                    float s, float* o) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i)
      o[i] = __bfloat162float(__float2bfloat16(static_cast<float>(c[i]) * s));
  }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

// Row sources: row(j) -> a handle for key row j; load(handle, chunk)
// fills VEC floats of K and of V from 16-byte chunk `chunk` along D.

// T rows at element offset row(j) of k and v
template <typename T, typename Offset>
struct DenseRows {
  const T* k;
  const T* v;
  Offset offset;
  __device__ __forceinline__ size_t row(int j) const { return offset(j); }
  __device__ __forceinline__ void load(size_t off, int chunk, float* kf,
                                       float* vf) const {
    Vec<T>::load(k + off + chunk * Vec<T>::N, kf);
    Vec<T>::load(v + off + chunk * Vec<T>::N, vf);
  }
};

// key row j of (lane, kv head) -> element offset into k and v
struct ContigOffset {
  size_t base;  // ((b * hkv + kvh) * s) * d
  int d;
  __device__ __forceinline__ size_t operator()(int j) const {
    return base + (size_t)j * d;
  }
};

// rows [begin, begin + bs) of one staging-tail block starting at base
struct TailOffset {
  size_t base;  // ((lane * hkv + kvh) * bs) * d
  int begin, d;
  __device__ __forceinline__ size_t operator()(int j) const {
    return base + (size_t)(j - begin) * d;
  }
};

struct PagedOffset {
  const int* tbl;  // this lane's table row, [M]
  int bs, hkv, kvh, d, nblocks;
  __device__ __forceinline__ size_t operator()(int j) const {
    int blk = __ldg(tbl + j / bs);
    if (blk < 0 || blk >= nblocks) blk = 0;  // the trash block
    return (((size_t)blk * hkv + kvh) * bs + (j % bs)) * d;
  }
};

// one int8 pool block's rows: codes at (j - begin) * d of kc/vc, times
// the block's scales, rounded to T
template <typename T>
struct CodeRows {
  const int8_t* kc;
  const int8_t* vc;
  float sk, sv;
  int begin, d;
  __device__ __forceinline__ size_t row(int j) const {
    return (size_t)(j - begin) * d;
  }
  __device__ __forceinline__ void load(size_t off, int chunk, float* kf,
                                       float* vf) const {
    Vec<T>::load_codes(kc + off + chunk * Vec<T>::N, sk, kf);
    Vec<T>::load_codes(vc + off + chunk * Vec<T>::N, sv, vf);
  }
};

// Each warp's online-softmax state of RR query heads over MD columns, in
// shared memory; merge() gives the block's row max for query head r and
// the sum and column `col` of the accumulator rescaled to it (both 0
// when no warp saw a row).
template <int RR, int MD>
struct WarpStates {
  float m[kWarps][RR], l[kWarps][RR], acc[kWarps][RR][MD];
  __device__ __forceinline__ void merge(int r, int col, float& mx,
                                        float& num, float& den) const {
    mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m[w][r]);
    num = den = 0.f;
    if (mx == -INFINITY) return;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m[w][r] - mx);
      den += l[w][r] * c;
      num += acc[w][r][col] * c;
    }
  }
};

// Online-softmax state of query heads [h0, h0 + R) of one lane, spread
// over the thread block; rows() folds in a range of key rows,
// merge_groups() and store_warp() merge a warp's lane groups and hand
// its state to shared memory, finish() merges the warps and writes the
// output.
template <typename T, int R>
struct Attend {
  using V = Vec<T>;
  static constexpr int VEC = V::N;
  static constexpr int MAXC = (kMaxD / VEC + 31) / 32;  // chunks per lane
  static constexpr int E = MAXC * VEC;  // floats per lane per row
  static constexpr unsigned kFull = 0xffffffffu;

  int d, nchunks, g, lane, warp, gl, grp, groups;
  float qv[R][E];  // this lane's slice of the R query rows, pre-scaled
  float m[R], l[R], acc[R][E];

  __device__ __forceinline__ Attend(const T* __restrict__ q, int b, int h0,
                                    int hq, int d_, float scale)
      : d(d_) {
    nchunks = d / VEC;
    g = 1;  // lanes per key row
    while (g < nchunks && g < 32) g <<= 1;
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    gl = lane & (g - 1);
    grp = lane / g;
    groups = 32 / g;
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
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
    }
  }

  // key rows [begin, end) from `src`; begin and end are the same for
  // the whole thread block
  template <typename Src>
  __device__ __forceinline__ void rows(int begin, int end, const Src& src) {
    const int warp_rows = groups * kUnroll;
    // the loop bound depends on the warp only, so every lane of a warp
    // takes the same trip count and the shuffles below stay converged
    for (int j0 = begin + warp * warp_rows; j0 < end;
         j0 += kWarps * warp_rows) {
      float kf[kUnroll][E], vf[kUnroll][E];
      bool valid[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * groups + grp;
        valid[u] = j < end;
        const auto h = src.row(valid[u] ? j : begin);
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          const int chunk = gl + c * g;
          if (valid[u] && chunk < nchunks) {
            src.load(h, chunk, &kf[u][c * VEC], &vf[u][c * VEC]);
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
  }

  // merge the lane groups of this warp (lanes with the same gl): lane
  // group 0 then holds the warp's state
  __device__ __forceinline__ void merge_groups() {
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
  }

  // lane group 0's state of each warp into `sm` (RR >= R, MD >= d)
  template <int RR, int MD>
  __device__ __forceinline__ void store_warp(WarpStates<RR, MD>& sm) const {
    if (grp != 0) return;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (gl == 0) {
        sm.m[warp][r] = m[r];
        sm.l[warp][r] = l[r];
      }
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int chunk = gl + c * g;
        if (chunk < nchunks) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            sm.acc[warp][r][chunk * VEC + e] = acc[r][c * VEC + e];
        }
      }
    }
  }

  __device__ __forceinline__ void finish(T* __restrict__ out, int b, int h0,
                                         int hq) {
    merge_groups();

    // merge the warps through shared memory
    __shared__ WarpStates<kMaxR, kMaxD> sm;
    store_warp(sm);
    __syncthreads();

    for (int idx = threadIdx.x; idx < R * d; idx += kThreads) {
      const int r = idx / d;
      const int col = idx - r * d;
      float mx, num, den;
      sm.merge(r, col, mx, num, den);
      // length-0 lane: zeros, not 0/0
      const float o = mx != -INFINITY ? num / den : 0.f;
      out[((size_t)b * hq + h0 + r) * d + col] = V::from_float(o);
    }
  }
};

// grid (hkv * n_rep / R, B): block -> (lane, kv head, first query head)
__device__ __forceinline__ void block_heads(int hq, int hkv, int R,
                                            int* kvh, int* h0) {
  const int n_rep = hq / hkv;
  const int passes = n_rep / R;
  *kvh = blockIdx.x / passes;
  *h0 = *kvh * n_rep + (blockIdx.x % passes) * R;
}

// chunks of `rows` key rows that hold n rows: of the cache's capacity S
// (the grid), or of a lane's fill (its live chunks; a lane of length 0
// keeps one, whose block writes its zeros)
__host__ __device__ __forceinline__ int chunks_of(int n, int rows) {
  return n <= rows ? 1 : (n + rows - 1) / rows;
}

__device__ __forceinline__ int lane_length(const int* lengths, int b,
                                           int s) {
  const int len = lengths[b];
  return len < 0 ? 0 : (len > s ? s : len);
}

// Blocks of the split kernel an SM holds at R = 1 (at most 64 registers
// a thread): enough bytes in flight to stream a long fill, and the 7b
// shape's 512 or 1024 blocks in one or two full waves.
constexpr int kSplitBlocks = 4;

// The contiguous cache, split over its rows (flash-decoding): grid
// (head groups, B, chunks), so the blocks of every lane's first chunk
// are scheduled first.  Block (group, b, c) folds key rows
// [c * rows, min((c + 1) * rows, len)) of lane b into an online-softmax
// state per query head and merges its warps.  A lane whose rows fit one
// chunk gets its output here.  Otherwise the block writes its partial
// (the f32 accumulator [D], the row max m and the sum l) to
// ws [B, Hq, chunks, D + 2] and takes a ticket from
// tickets[b, group]; the lane's last live chunk to finish merges every
// partial in chunk order (the same bits whichever block it is) and
// resets the ticket to 0 for the next launch.  A chunk at or past the
// fill exits at once.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, R == 1 ? kSplitBlocks : 1)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, float* __restrict__ ws,
                            int* __restrict__ tickets, int hq, int hkv, int s,
                            int d, int rows, float scale) {
  int kvh, h0;
  block_heads(hq, hkv, R, &kvh, &h0);
  const int b = blockIdx.y, c = blockIdx.z, nchunks = gridDim.z;
  const int len = lane_length(lengths, b, s);
  Attend<T, R> at(q, b, h0, hq, d, scale);  // q's loads beside the length's
  const int live = chunks_of(len, rows);
  if (c >= live) return;
  const int begin = c * rows;
  const int end = len - begin < rows ? len : begin + rows;
  const DenseRows<T, ContigOffset> src{
      k, v, {((size_t)b * hkv + kvh) * (size_t)s * d, d}};
  at.rows(begin, end, src);
  at.merge_groups();

  __shared__ WarpStates<R, kMaxD> sm;
  __shared__ int last;
  at.store_warp(sm);
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * d; idx += kThreads) {
    const int r = idx / d;
    const int col = idx - r * d;
    float mx, num, den;
    sm.merge(r, col, mx, num, den);
    const size_t bh = (size_t)b * hq + h0 + r;
    if (live == 1) {
      // length-0 lane: zeros, not 0/0
      out[bh * d + col] = Vec<T>::from_float(mx != -INFINITY ? num / den
                                                              : 0.f);
    } else {
      float* part = ws + (bh * nchunks + c) * (d + 2);
      part[col] = num;
      if (col == 0) {
        part[d] = mx;
        part[d + 1] = den;
      }
    }
  }
  if (live == 1) return;

  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    int* t = tickets + (size_t)b * gridDim.x + blockIdx.x;
    last = atomicAdd(t, 1) == live - 1;
    if (last) atomicExch(t, 0);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the partials of other blocks: loads bypass L1; unrolled so several
  // chunks' loads are in flight at once
  for (int idx = threadIdx.x; idx < R * d; idx += kThreads) {
    const int r = idx / d;
    const int col = idx - r * d;
    const size_t bh = (size_t)b * hq + h0 + r;
    const float* part = ws + bh * nchunks * (d + 2);
    float mx = -INFINITY;
#pragma unroll 4
    for (int j = 0; j < live; ++j)
      mx = fmaxf(mx, __ldcg(part + j * (d + 2) + d));
    float num = 0.f, den = 0.f;
#pragma unroll 4
    for (int j = 0; j < live; ++j) {
      const float* pj = part + j * (d + 2);
      const float e = expf(__ldcg(pj + d) - mx);
      den += __ldcg(pj + d + 1) * e;
      num += __ldcg(pj + col) * e;
    }
    out[bh * d + col] = Vec<T>::from_float(num / den);
  }
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
  Attend<T, R> at(q, b, h0, hq, d, scale);
  const DenseRows<T, PagedOffset> src{
      k_pool, v_pool,
      {table + (size_t)b * max_blocks, bs, hkv, kvh, d, nblocks}};
  at.rows(0, len, src);
  at.finish(out, b, h0, hq);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    paged_decode_attention_quant_kernel(
        const T* __restrict__ q, const int8_t* __restrict__ k_pool,
        const int8_t* __restrict__ v_pool,
        const float* __restrict__ k_scale, const float* __restrict__ v_scale,
        const T* __restrict__ k_tail, const T* __restrict__ v_tail,
        const int* __restrict__ table, const int* __restrict__ lengths,
        T* __restrict__ out, int hq, int hkv, int nblocks, int bs,
        int max_blocks, int d, float scale) {
  int kvh, h0;
  block_heads(hq, hkv, R, &kvh, &h0);
  const int b = blockIdx.y;
  const int view = max_blocks * bs;
  const int raw = lengths[b];
  const int len = raw < 0 ? 0 : (raw > view ? view : raw);
  // the write-frontier block, from the uncapped length as the TPU kernel
  // computes it: its rows live in the lane's tail, not the pool
  const int wb = (raw > 1 ? raw - 1 : 0) / bs;
  const int* tbl = table + (size_t)b * max_blocks;
  const size_t tail_base = ((size_t)b * hkv + kvh) * bs * d;
  Attend<T, R> at(q, b, h0, hq, d, scale);
  for (int jb = 0; jb * bs < len; ++jb) {
    const int begin = jb * bs;
    const int end = begin + bs < len ? begin + bs : len;
    if (jb == wb) {
      const DenseRows<T, TailOffset> src{k_tail, v_tail,
                                         {tail_base, begin, d}};
      at.rows(begin, end, src);
    } else {
      int blk = __ldg(tbl + jb);
      if (blk < 0 || blk >= nblocks) blk = 0;  // the trash block
      const size_t bh = (size_t)blk * hkv + kvh;
      const CodeRows<T> src{k_pool + bh * bs * d, v_pool + bh * bs * d,
                            __ldg(k_scale + bh), __ldg(v_scale + bh),
                            begin, d};
      at.rows(begin, end, src);
    }
  }
  at.finish(out, b, h0, hq);
}

inline int heads_per_block(int n_rep) {
  return n_rep % 4 == 0 ? 4 : (n_rep % 2 == 0 ? 2 : 1);
}

// launch kernel<T, R> for the R that divides n_rep, on grid (hkv * n_rep
// / R, b)
#define LAUNCH_BY_R(KERNEL, T, hq, hkv, b, stream, ...)                   \
  do {                                                                    \
    const int r_ = heads_per_block((hq) / (hkv));                         \
    const dim3 grid_((hkv) * ((hq) / (hkv) / r_), (b));                   \
    if (r_ == 4)                                                          \
      KERNEL<T, 4><<<grid_, kThreads, 0, (stream)>>>(__VA_ARGS__);        \
    else if (r_ == 2)                                                     \
      KERNEL<T, 2><<<grid_, kThreads, 0, (stream)>>>(__VA_ARGS__);        \
    else                                                                  \
      KERNEL<T, 1><<<grid_, kThreads, 0, (stream)>>>(__VA_ARGS__);        \
  } while (0)

template <typename T>
cudaError_t launch_contig(const void* q, const void* k, const void* v,
                          const void* lengths, void* out, void* ws,
                          void* tickets, int b, int hq, int hkv, int s,
                          int d, int rows, float scale, cudaStream_t stream) {
  const int nchunks = chunks_of(s, rows);
  const int r = heads_per_block(hq / hkv);
  const dim3 grid(hkv * (hq / hkv / r), b, nchunks);
#define CONTIG_ARGS                                                       \
  static_cast<const T*>(q), static_cast<const T*>(k),                     \
      static_cast<const T*>(v), static_cast<const int*>(lengths),         \
      static_cast<T*>(out), static_cast<float*>(ws),                      \
      static_cast<int*>(tickets), hq, hkv, s, d, rows, scale
  if (r == 4)
    decode_attention_kernel<T, 4><<<grid, kThreads, 0, stream>>>(CONTIG_ARGS);
  else if (r == 2)
    decode_attention_kernel<T, 2><<<grid, kThreads, 0, stream>>>(CONTIG_ARGS);
  else
    decode_attention_kernel<T, 1><<<grid, kThreads, 0, stream>>>(CONTIG_ARGS);
#undef CONTIG_ARGS
  return cudaGetLastError();
}

template <typename T>
void launch_paged(const void* q, const void* k, const void* v,
                  const void* table, const void* lengths, void* out, int b,
                  int hq, int hkv, int nblocks, int bs, int max_blocks,
                  int d, float scale, cudaStream_t stream) {
  LAUNCH_BY_R(paged_decode_attention_kernel, T, hq, hkv, b, stream,
              static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), static_cast<const int*>(table),
              static_cast<const int*>(lengths), static_cast<T*>(out), hq,
              hkv, nblocks, bs, max_blocks, d, scale);
}

template <typename T>
void launch_paged_quant(const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const void* kt,
                        const void* vt, const void* table,
                        const void* lengths, void* out, int b, int hq,
                        int hkv, int nblocks, int bs, int max_blocks, int d,
                        float scale, cudaStream_t stream) {
  LAUNCH_BY_R(paged_decode_attention_quant_kernel, T, hq, hkv, b, stream,
              static_cast<const T*>(q), static_cast<const int8_t*>(k),
              static_cast<const int8_t*>(v), static_cast<const float*>(ks),
              static_cast<const float*>(vs), static_cast<const T*>(kt),
              static_cast<const T*>(vt), static_cast<const int*>(table),
              static_cast<const int*>(lengths), static_cast<T*>(out), hq,
              hkv, nblocks, bs, max_blocks, d, scale);
}

bool bad_heads(int b, int hq, int hkv, int d) {
  return b <= 0 || b > 65535 || hkv <= 0 || hq <= 0 || hq % hkv != 0 ||
         d <= 0 || d % 8 != 0 || d > kMaxD;
}

bool bad_pool(int nblocks, int bs, int max_blocks) {
  return nblocks <= 0 || bs <= 0 || max_blocks <= 0 ||
         (long long)max_blocks * bs > 0x7fffffffLL;
}

}  // namespace

// q [B, Hq, D]; k, v [B, Hkv, S, D]; lengths [B] int32; out [B, Hq, D];
// ws [B, Hq, chunks, D + 2] f32 scratch, chunks = ceil(S / chunk_rows);
// tickets [>= B * Hq] int32, zero before the first launch and left zero
// by every launch.  With S <= chunk_rows (one chunk) ws and tickets are
// not read and may be null.  dtype: 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t as int.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* ws, void* tickets,
                                       int b, int hq, int hkv, int s, int d,
                                       int chunk_rows, float scale, int dtype,
                                       void* stream) {
  if (bad_heads(b, hq, hkv, d) || s < 0 || chunk_rows <= 0 ||
      chunks_of(s, chunk_rows) > 65535 ||
      ((ws == nullptr || tickets == nullptr) && chunks_of(s, chunk_rows) > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = launch_contig<float>(q, k, v, lengths, out, ws, tickets, b, hq, hkv,
                             s, d, chunk_rows, scale, st);
  } else if (dtype == 1) {
    e = launch_contig<__nv_bfloat16>(q, k, v, lengths, out, ws, tickets, b,
                                     hq, hkv, s, d, chunk_rows, scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// q [B, Hq, D]; k_pool, v_pool [N, Hkv, bs, D] (one layer of the pool);
// table [B, M] int32 pool block ids; lengths [B] int32; out [B, Hq, D].
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t as int.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lengths, void* out, int b, int hq, int hkv, int nblocks,
    int bs, int max_blocks, int d, float scale, int dtype, void* stream) {
  if (bad_heads(b, hq, hkv, d) || bad_pool(nblocks, bs, max_blocks))
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

// The int8 pool: q [B, Hq, D] in T; k_pool, v_pool [N, Hkv, bs, D] int8
// codes; k_scale, v_scale [N, Hkv] float32; k_tail, v_tail
// [tail_rows >= B, Hkv, bs, D] in T (lane b's staging block is row b);
// table [B, M] int32; lengths [B] int32; out [B, Hq, D] in T.  dtype (of
// T): 0 = float32, 1 = bfloat16.  Returns a cudaError_t as int.
extern "C" int paged_decode_attention_quant_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* k_tail,
    const void* v_tail, const void* table, const void* lengths, void* out,
    int b, int hq, int hkv, int nblocks, int bs, int max_blocks, int d,
    int tail_rows, float scale, int dtype, void* stream) {
  if (bad_heads(b, hq, hkv, d) || bad_pool(nblocks, bs, max_blocks) ||
      tail_rows < b)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_paged_quant<float>(q, k_pool, v_pool, k_scale, v_scale, k_tail,
                              v_tail, table, lengths, out, b, hq, hkv,
                              nblocks, bs, max_blocks, d, scale, st);
  } else if (dtype == 1) {
    launch_paged_quant<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                      k_tail, v_tail, table, lengths, out, b,
                                      hq, hkv, nblocks, bs, max_blocks, d,
                                      scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
