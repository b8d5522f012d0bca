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
//   its key block; here a block reads one table entry per staged tile.
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
// 1/sqrt(D) unless given; f32 running max, sum and accumulator (p stays
// f32 in P.V, where the plain version rounds the normalized p to T: the
// difference lies inside the bf16 tolerance); a lane of length 0 outputs
// zeros.  The pool blocks of table entries at or past ceil(lengths[b] /
// bs) are never read (retired lanes' rows point at the trash block 0; an
// id outside [0, N) reads block 0 too, so a bad table can never address
// memory outside the pool).
//
// What bounds them: reading the filled K and V rows.  Per lane and
// kv-head that is 2 * lengths[b] * D * sizeof(T) bytes (one byte an
// element for the int8 pool's full blocks) against about
// 4 * n_rep * lengths[b] * D flops — a fraction of a flop per byte, far
// below the ~295 flop/byte where Hopper's tensor cores would be the
// limit (so they do not pay here: at R = 1 the q.K product is a vector
// product).  So the design only has to stream those bytes once, with
// enough of them in flight to cover the card's load latency, and never
// touch the rest of the cache:
//
// - split over the rows (flash-decoding): one thread block per (lane b,
//   kv head, group of R <= 4 query heads, chunk of key rows), grid
//   (head groups, B, chunks).  The chunk count is fixed by host shapes
//   alone — the cache's capacity S, or the table's reach M * bs — and
//   the caller's chunk rows, so a launch reads no length back; a chunk
//   at or past lengths[b] exits at once (the fill skip; rows past the
//   fill are never read), and chunks are the slowest grid dimension, so
//   every lane's first chunk is scheduled first.  A GQA group of
//   n_rep <= 4 heads shares one pass over its K/V rows.
// - a lane whose fill fits one chunk gets its output from that chunk's
//   block.  Otherwise every live chunk writes its partial (f32
//   accumulator, row max, row sum) to a workspace the caller passes and
//   takes an atomic ticket, and the lane's last chunk to finish merges
//   all partials in chunk order, so two runs give the same bits
//   (split_finish, one function for all three kernels).  A second merge
//   kernel was slower at short and middle fills and no faster at long
//   ones (its launch and its own load latency); the tickets cost a
//   counter per (lane, head group) that the merging block leaves at 0
//   for the next launch.  The R = 1 kernels are held to 64 registers, so
//   four blocks share an SM.
// - warps split a block's key rows and keep private online-softmax
//   state; a warp's lane groups merge by shuffles, the warps through
//   shared memory at the end.  Each key row is read by a group of g
//   lanes along D, VEC elements a lane (VEC = 16 / sizeof(T); g = D /
//   VEC rounded up to a power of two, at most 32); the q.k dot product
//   reduces over the group by shuffles.
// - the contiguous kernel loads its rows straight into registers,
//   kUnroll rows per lane group in flight (Attend::rows).
// - the paged kernels stage their rows through shared memory instead:
//   the rows of one (pool block, kv head) are one contiguous slab, so a
//   tile of consecutive rows inside a pool block is one contiguous run
//   of bytes.  Thread 0 hands each tile's K and V runs to the bulk copy
//   engine (`cp.async.bulk`, completing on the stage's mbarrier; no
//   registers or issue slots of the other threads) into a ring of two
//   tiles (kStages; 3 and 4 were no faster on the card and cost shared
//   memory); the block computes on the tile that has landed while the
//   next one is in flight.  The chunk size divides bs
//   or is a multiple of it, and a tile is a power of two rows that
//   divides the chunk's pool-block segments, so no tile crosses a pool
//   block, the table entry is read once a tile (not once a row) and the
//   walk needs no division.  A tile is one pass of the block over its
//   lane groups (kUnroll * kWarps * 32 / g rows: 32 rows, 16 KB of K and
//   V at bf16 D 128); with a smaller bs a tile holds a pool block.  Rows
//   are copied up to the fill only.
// - measured on the card, both paged kernels were bound by instructions,
//   not bytes (the int8 kernel took longer than the bf16 one on half the
//   bytes), so their loop is cut to the bone: head_dim 64 and 128 are
//   compile-time instantiations (the per-row loops and the shuffle
//   reduction unroll), the softmax runs in base 2 on the special
//   function unit (ex2; q pre-scaled by log2 e, the row max converted
//   back before the merges), one max update per kUnroll rows, and the
//   table entry of the chunk's first block is read beside the length.
// - the int8 kernel's tiles carry whole slabs of codes, half the bytes
//   of the bf16 pool's (8-byte cp.async from every thread instead of
//   bulk copies at D % 16 == 8, where a row is not a multiple of 16
//   bytes); codes become floats on the way from shared memory to
//   registers (exactly, without I2F) and are scaled in f32 and rounded
//   to T there.  The tile of the lane's write-frontier block is copied
//   from its staging tail instead, and the tail-or-codes choice and the
//   block's two scales (copied beside the codes) are taken once a tile,
//   uniformly for the whole thread block.  Both paged kernels run one
//   body with one partition into chunks, tiles and lane groups, so on
//   the same rows (the codes dequantized and rounded to T) the int8
//   kernel gives the bf16 kernel's bits.
//
// Not carried over from the TPU kernels: their (B, key-blocks) grid with
// scratch carried between steps, the masked all-heads contraction (a
// trick for the MXU's 128-lane tiles) and the transposed [hq, rows]
// bookkeeping.  Left for later: chunk rows chosen from the grid's (lane,
// head group) count (at the ring's 8 lanes x 32 heads one chunk a lane
// was faster than 256-row chunks: fewer concurrent streams read the
// card's memory more efficiently); staging kernel #1's rows as well;
// a tile gathered from several pool blocks when bs is below a tile.
//
// Accepts float and bfloat16, D a multiple of 8 up to 256, any
// Hq % Hkv == 0, any S (contiguous) or any block size bs >= 1 (paged).
// Pointers must be 16-byte aligned and the tensors contiguous (the
// Python wrapper checks).  Launches on the given stream, allocates
// nothing (the split's workspace and tickets come from the caller), and
// returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr int kUnroll = 2;  // key rows per lane group in flight
// tiles in the paged kernels' shared-memory ring
constexpr int kStages = 2;
constexpr int kMaxDevices = 64;

// four int8 codes packed in a word -> exact floats, without I2F: byte
// c + 128 becomes the low mantissa byte of 2^23
__device__ __forceinline__ void codes4(unsigned w, float* o) {
  const unsigned x = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7540u | i)) -
           8388736.f;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the special function unit (one instruction; -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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
    codes4(*reinterpret_cast<const unsigned*>(p), o);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] *= s;
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
    float c[N];
    codes4(raw.x, c);
    codes4(raw.y, c + 4);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = __bfloat1622float2(
          __floats2bfloat162_rn(c[2 * i] * s, c[2 * i + 1] * s));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

// lanes that read one row of d elements, VEC a lane: a power of two, at
// most 32
__host__ __device__ __forceinline__ constexpr int row_lanes(int d, int vec) {
  int g = 1;
  while (g < d / vec && g < 32) g <<= 1;
  return g;
}

// key rows of a staged tile: one pass of the block over its lane
// groups, kUnroll rows each
__host__ __device__ __forceinline__ constexpr int tile_rows(int d, int vec) {
  return kUnroll * kWarps * (32 / row_lanes(d, vec));
}

// Row sources.  Contiguous kernel: row(j) -> a handle for key row j;
// load(handle, chunk) fills VEC floats of K and of V from 16-byte chunk
// `chunk` along D.

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

// Staged tiles (paged kernels): key(j, chunk) and value(j, chunk) fill
// VEC floats from row j of the tile in shared memory.

// a tile of T rows
template <typename T>
struct StagedRows {
  const T* k;
  const T* v;
  int d;
  __device__ __forceinline__ void key(int j, int chunk, float* o) const {
    Vec<T>::load(k + j * d + chunk * Vec<T>::N, o);
  }
  __device__ __forceinline__ void value(int j, int chunk, float* o) const {
    Vec<T>::load(v + j * d + chunk * Vec<T>::N, o);
  }
};

// a tile of int8 code rows of one pool block, times the block's scales,
// rounded to T
template <typename T>
struct StagedCodes {
  const int8_t* k;
  const int8_t* v;
  float sk, sv;
  int d;
  __device__ __forceinline__ void key(int j, int chunk, float* o) const {
    Vec<T>::load_codes(k + j * d + chunk * Vec<T>::N, sk, o);
  }
  __device__ __forceinline__ void value(int j, int chunk, float* o) const {
    Vec<T>::load_codes(v + j * d + chunk * Vec<T>::N, sv, o);
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
// over the thread block; rows() folds in a range of key rows from
// global memory, tile() a tile staged in shared memory (its scores in
// base 2: q pre-scaled by log2 e, natural() converts the row max back);
// merge_groups() and store_warp() merge a warp's lane groups and hand
// its state to shared memory for split_finish.  kD > 0 fixes head_dim
// at compile time (the per-row loops and shuffles unroll; the paged
// kernels at D 64 and 128), 0 takes it at run time.
template <typename T, int R, int kD = 0>
struct Attend {
  using V = Vec<T>;
  static constexpr int VEC = V::N;
  // chunks per lane
  static constexpr int MAXC = ((kD > 0 ? kD : kMaxD) / VEC + 31) / 32;
  static constexpr int E = MAXC * VEC;  // floats per lane per row
  static constexpr unsigned kFull = 0xffffffffu;

  int d, nchunks, g, lane, warp, gl, grp, groups;
  float qv[R][E];  // this lane's slice of the R query rows, pre-scaled
  float m[R], l[R], acc[R][E];

  __device__ __forceinline__ Attend(const T* __restrict__ q, int b, int h0,
                                    int hq, int d_, float scale)
      : d(kD > 0 ? kD : d_) {
    nchunks = d / VEC;
    // lanes per key row
    g = kD > 0 ? row_lanes(kD, VEC) : row_lanes(d, VEC);
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

  // rows [0, n) of a tile staged in shared memory (n <= tile_rows):
  // this lane group takes rows u * kWarps * groups + warp * groups + grp
  // for u < kUnroll.  Scores first, one max update per kUnroll rows,
  // then the V rows; n is the same for the whole thread block.
  template <typename Src>
  __device__ __forceinline__ void tile(int n, const Src& src) {
    const int step = kWarps * groups;
    float sc[kUnroll][R];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = u * step + warp * groups + grp;
      valid[u] = j < n;
      float kf[E];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int chunk = gl + c * g;
        if (valid[u] && chunk < nchunks) {
          src.key(j, chunk, &kf[c * VEC]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[c * VEC + e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s += qv[r][e] * kf[e];
        sc[u][r] = s;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          if (off < g) sc[u][r] += __shfl_xor_sync(kFull, sc[u][r], off);
      }
    }
    float p[kUnroll][R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mn = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (valid[u]) mn = fmaxf(mn, sc[u][r]);
      // no valid row yet: nothing to rescale (and no -inf - -inf)
      const float corr = mn == -INFINITY ? 1.f : ex2(m[r] - mn);
      float sum = l[r] * corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u][r] = valid[u] ? ex2(sc[u][r] - mn) : 0.f;
        sum += p[u][r];
      }
      l[r] = sum;
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!valid[u]) continue;
      const int j = u * step + warp * groups + grp;
      float vf[E];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int chunk = gl + c * g;
        if (chunk < nchunks) {
          src.value(j, chunk, &vf[c * VEC]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) vf[c * VEC + e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[r][e] = fmaf(p[u][r], vf[e], acc[r][e]);
      }
    }
  }

  // the row max of tile()'s base-2 scores in natural units, for the
  // merges
  __device__ __forceinline__ void natural() {
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] *= kLn2;
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

  // lane group 0's state of each warp into `sm` (MD >= d)
  template <int MD>
  __device__ __forceinline__ void store_warp(WarpStates<R, MD>& sm) const {
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
};

// grid (hkv * n_rep / R, B, chunks): block -> (lane, kv head, first
// query head)
__device__ __forceinline__ void block_heads(int hq, int hkv, int R,
                                            int* kvh, int* h0) {
  const int n_rep = hq / hkv;
  const int passes = n_rep / R;
  *kvh = blockIdx.x / passes;
  *h0 = *kvh * n_rep + (blockIdx.x % passes) * R;
}

// chunks of `rows` key rows that hold n rows: of the cache's capacity S
// or the table's reach M * bs (the grid), or of a lane's fill (its live
// chunks; a lane of length 0 keeps one, whose block writes its zeros)
__host__ __device__ __forceinline__ int chunks_of(int n, int rows) {
  return n <= rows ? 1 : (n + rows - 1) / rows;
}

__device__ __forceinline__ int lane_length(const int* lengths, int b,
                                           int s) {
  const int len = lengths[b];
  return len < 0 ? 0 : (len > s ? s : len);
}

// The end of a split kernel's block, once its warps' states are in `sm`
// (merged by sm.merge): chunk c of lane b's `live` chunks.  A lane whose
// rows fit one chunk gets its output here.  Otherwise the block writes
// its partial (the f32 accumulator [D], the row max m and the sum l) to
// ws [B, Hq, chunks, D + 2] and takes a ticket from tickets[b, group];
// the lane's last live chunk to finish merges every partial in chunk
// order (the same bits whichever block it is) and resets the ticket to
// 0 for the next launch.
template <typename T, int R>
__device__ __forceinline__ void split_finish(const WarpStates<R, kMaxD>& sm,
                                             T* __restrict__ out,
                                             float* __restrict__ ws,
                                             int* __restrict__ tickets,
                                             int b, int h0, int hq, int d,
                                             int c, int live) {
  const int nchunks = gridDim.z;
  __shared__ int last;
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

// Blocks of a split kernel an SM holds at R = 1 (at most 64 registers a
// thread): enough bytes in flight to stream a long fill, and the 7b
// shape's 512 to 2048 blocks in few full waves.
constexpr int kSplitBlocks = 4;

// The contiguous cache, split over its rows: block (group, b, c) folds
// key rows [c * rows, min((c + 1) * rows, len)) of lane b into an
// online-softmax state per query head, merges its warps and ends in
// split_finish.  A chunk at or past the fill exits at once.
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
  const int b = blockIdx.y, c = blockIdx.z;
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
  at.store_warp(sm);
  __syncthreads();
  split_finish<T, R>(sm, out, ws, tickets, b, h0, hq, d, c, live);
}

// ---------------------------------------------------------------------------
// The paged kernels: rows staged through shared memory by asynchronous
// copies that complete on an mbarrier per stage
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// the phase of `bar` also waits for `bytes` more of bulk copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// this thread's arrival on `bar`, once its cp.async copies so far landed
__device__ __forceinline__ void mbar_arrive_after_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase `parity` has completed.  A phase that
// never completes is a fault of the kernel: after 10 s it traps (the
// launch then fails) instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// src to shared dst by the bulk copy engine, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// N (4 or 8) bytes from global src to shared dst, cached in L1 on the way
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(N)
               : "memory");
}

// Operands of both paged kernels.  k and v: the pool's layer view, T
// (bf16 pool) or int8 codes; the scales and tails only for the int8 pool.
template <typename T>
struct PagedArgs {
  const T* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const T* k_tail;
  const T* v_tail;
  const int* table;
  const int* lengths;
  T* out;
  float* ws;
  int* tickets;
  int hq, hkv, nblocks, bs, max_blocks, d, rows;
  float scale;
};

// Chunk c of lane b through the block table: its rows in tiles staged
// into a ring of kStages tiles of dynamic shared memory (K then V, each
// tile_rows * d elements of T), computed on as they land, then the warps
// merge and split_finish ends the block.  A tile holds tt rows, a power
// of two that divides the chunk's pool-block segments (bs, or the chunk
// rows where those divide bs), so no tile crosses a pool block and the
// walk needs no division per tile.  Thread 0 issues a tile as two bulk
// copies (K, V); code rows that are not a multiple of 16 bytes (int8 at
// D % 16 == 8) go by 8-byte cp.async from every thread instead.  Either
// way the tile completes on its stage's mbarrier: every thread arrives
// once its own copies landed, and the bulk bytes are expected on it.
// kQuant reads the int8 pool: code tiles with their block's two scales
// (copied beside the codes), or the lane's tail for its frontier block.
template <typename T, int R, bool kQuant, int kD>
__device__ __forceinline__ void paged_chunk(const PagedArgs<T>& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float scales[kStages][2];
  int kvh, h0;
  block_heads(a.hq, a.hkv, R, &kvh, &h0);
  const int b = blockIdx.y, c = blockIdx.z;
  const int bs = a.bs, d = kD > 0 ? kD : a.d;
  const int* tbl = a.table + (size_t)b * a.max_blocks;
  // the chunk's first pool block, read beside the length (c * rows < M * bs)
  const int begin = c * a.rows;
  const int jb0 = begin / bs;
  const int blk0 = __ldg(tbl + jb0);
  const int raw = a.lengths[b];
  const int view = a.max_blocks * bs;  // the table covers M * bs rows
  const int len = raw < 0 ? 0 : (raw > view ? view : raw);
  Attend<T, R, kD> at(a.q, b, h0, a.hq, d, a.scale * kLog2e);
  const int live = chunks_of(len, a.rows);
  if (c >= live) return;  // before any barrier or copy
  const int end = len - begin < a.rows ? len : begin + a.rows;
  const int seg = bs < a.rows ? bs : a.rows;
  const int tr = tile_rows(d, Vec<T>::N);
  const int tt = (seg & -seg) < tr ? (seg & -seg) : tr;
  const int half = tr * d * (int)sizeof(T);  // K (or V) of a stage
  // the write-frontier block's first row, from the uncapped length as
  // the TPU kernel computes it: its rows live in the lane's tail
  const int wlo = (raw > 1 ? raw - 1 : 0) / bs * bs;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the next tile to issue: its first row, its lane-local pool block,
  // its offset there and its stage
  int ir0 = begin, jb = jb0, ioff = begin - jb0 * bs, ist = 0;
  auto issue = [&]() {
    if (ir0 >= end) return;
    const int n = end - ir0 < tt ? end - ir0 : tt;
    unsigned char* dst = smem + ist * 2 * half;
    const bool codes = kQuant && (unsigned)(ir0 - wlo) >= (unsigned)bs;
    const unsigned char* k;
    const unsigned char* v;
    int bytes;
    if (kQuant && !codes) {  // the frontier block, from the lane's tail
      const size_t e = (((size_t)b * a.hkv + kvh) * bs + ioff) * d;
      k = reinterpret_cast<const unsigned char*>(a.k_tail + e);
      v = reinterpret_cast<const unsigned char*>(a.v_tail + e);
      bytes = n * d * (int)sizeof(T);
    } else {
      int blk = jb == jb0 ? blk0 : __ldg(tbl + jb);
      if (blk < 0 || blk >= a.nblocks) blk = 0;  // the trash block
      const size_t bh = (size_t)blk * a.hkv + kvh;
      const size_t e = (bh * bs + ioff) * d;
      if (codes) {
        k = static_cast<const unsigned char*>(a.k) + e;
        v = static_cast<const unsigned char*>(a.v) + e;
        bytes = n * d;
        if (threadIdx.x == 0) {
          cp_async<4>(&scales[ist][0], a.k_scale + bh);
          cp_async<4>(&scales[ist][1], a.v_scale + bh);
        }
      } else {
        k = reinterpret_cast<const unsigned char*>(static_cast<const T*>(a.k) +
                                                   e);
        v = reinterpret_cast<const unsigned char*>(static_cast<const T*>(a.v) +
                                                   e);
        bytes = n * d * (int)sizeof(T);
      }
    }
    // T rows are whole 16-byte units (d % 8 == 0); code rows at d % 16 == 0
    if (!codes || d % 16 == 0) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(&full[ist], 2 * bytes);
        bulk_copy(dst, k, bytes, &full[ist]);
        bulk_copy(dst + half, v, bytes, &full[ist]);
      }
    } else {
      for (int i = threadIdx.x * 8; i < bytes; i += kThreads * 8) {
        cp_async<8>(dst + i, k + i);
        cp_async<8>(dst + half + i, v + i);
      }
    }
    mbar_arrive_after_copies(&full[ist]);
    ir0 += tt;
    ioff += tt;
    if (ioff == bs) {
      ioff = 0;
      ++jb;
    }
    if (++ist == kStages) ist = 0;
  };

  for (int t = 0; t < kStages - 1; ++t) issue();
  int cst = 0;
  unsigned parity = 0;
  for (int r0 = begin; r0 < end; r0 += tt) {
    // every thread is done with the previous tile: its stage takes the
    // tile kStages - 1 ahead
    __syncthreads();
    issue();
    mbar_wait(&full[cst], parity);
    const int n = end - r0 < tt ? end - r0 : tt;
    const unsigned char* k = smem + cst * 2 * half;
    if (kQuant && (unsigned)(r0 - wlo) >= (unsigned)bs) {
      at.tile(n, StagedCodes<T>{reinterpret_cast<const int8_t*>(k),
                                reinterpret_cast<const int8_t*>(k + half),
                                scales[cst][0], scales[cst][1], d});
    } else {
      at.tile(n, StagedRows<T>{reinterpret_cast<const T*>(k),
                               reinterpret_cast<const T*>(k + half), d});
    }
    if (++cst == kStages) {
      cst = 0;
      parity ^= 1;
    }
  }
  at.natural();
  at.merge_groups();
  __syncthreads();  // the ring is read out: its first bytes take the states
  auto& sm = *reinterpret_cast<WarpStates<R, kMaxD>*>(smem);
  at.store_warp(sm);
  __syncthreads();
  split_finish<T, R>(sm, a.out, a.ws, a.tickets, b, h0, a.hq, d, c, live);
}

template <typename T, int R, int kD>
__global__ void __launch_bounds__(kThreads, R == 1 ? kSplitBlocks : 1)
    paged_decode_attention_kernel(const PagedArgs<T> a) {
  paged_chunk<T, R, false, kD>(a);
}

template <typename T, int R, int kD>
__global__ void __launch_bounds__(kThreads, R == 1 ? kSplitBlocks : 1)
    paged_decode_attention_quant_kernel(const PagedArgs<T> a) {
  paged_chunk<T, R, true, kD>(a);
}

// dynamic shared memory of a paged launch: the tile ring, at least the
// warps' states that take its place at the end
template <typename T, int R>
int paged_smem_bytes(int d) {
  const int ring = kStages * 2 * tile_rows(d, Vec<T>::N) * d * (int)sizeof(T);
  const int states = (int)sizeof(WarpStates<R, kMaxD>);
  return ring > states ? ring : states;
}

inline int heads_per_block(int n_rep) {
  return n_rep % 4 == 0 ? 4 : (n_rep % 2 == 0 ? 2 : 1);
}

template <typename T, int R, bool kQuant, int kD>
cudaError_t launch_paged_r(const PagedArgs<T>& a, dim3 grid,
                           cudaStream_t stream) {
  void (*kernel)(const PagedArgs<T>) =
      kQuant ? paged_decode_attention_quant_kernel<T, R, kD>
             : paged_decode_attention_kernel<T, R, kD>;
  const int smem = paged_smem_bytes<T, R>(a.d);
  // above 48 KB less the static shared memory the kernel must opt in,
  // once per device (the largest asked so far)
  if (smem > 47 * 1024) {
    static int allowed[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (allowed[dev] < smem) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      allowed[dev] = smem;
    }
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kQuant>
cudaError_t launch_paged(const PagedArgs<T>& a, int b, cudaStream_t stream) {
  const int r = heads_per_block(a.hq / a.hkv);
  const dim3 grid(a.hkv * (a.hq / a.hkv / r), b,
                  chunks_of(a.max_blocks * a.bs, a.rows));
  // head_dim fixed at compile time where the models put it
#define PAGED_BY_D(RR)                                                  \
  (a.d == 128 ? launch_paged_r<T, RR, kQuant, 128>(a, grid, stream)     \
   : a.d == 64 ? launch_paged_r<T, RR, kQuant, 64>(a, grid, stream)     \
               : launch_paged_r<T, RR, kQuant, 0>(a, grid, stream))
  if (r == 4) return PAGED_BY_D(4);
  if (r == 2) return PAGED_BY_D(2);
  return PAGED_BY_D(1);
#undef PAGED_BY_D
}

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

bool bad_heads(int b, int hq, int hkv, int d) {
  return b <= 0 || b > 65535 || hkv <= 0 || hq <= 0 || hq % hkv != 0 ||
         d <= 0 || d % 8 != 0 || d > kMaxD;
}

// the pool, the paged split's chunk rows (dividing bs or a multiple of
// it), its ring depth, and the workspace a launch of several chunks needs
bool bad_paged(int nblocks, int bs, int max_blocks, int rows,
               const void* ws, const void* tickets) {
  if (nblocks <= 0 || bs <= 0 || max_blocks <= 0 ||
      (long long)max_blocks * bs > 0x7fffffffLL || rows <= 0 ||
      (rows % bs != 0 && bs % rows != 0))
    return true;
  const int chunks = chunks_of(max_blocks * bs, rows);
  return chunks > 65535 ||
         ((ws == nullptr || tickets == nullptr) && chunks > 1);
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

template <typename T>
static PagedArgs<T> paged_args(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs,
                               const void* kt, const void* vt,
                               const void* table, const void* lengths,
                               void* out, void* ws, void* tickets, int hq,
                               int hkv, int nblocks, int bs, int max_blocks,
                               int d, int rows, float scale) {
  return PagedArgs<T>{static_cast<const T*>(q),
                      k,
                      v,
                      static_cast<const float*>(ks),
                      static_cast<const float*>(vs),
                      static_cast<const T*>(kt),
                      static_cast<const T*>(vt),
                      static_cast<const int*>(table),
                      static_cast<const int*>(lengths),
                      static_cast<T*>(out),
                      static_cast<float*>(ws),
                      static_cast<int*>(tickets),
                      hq,
                      hkv,
                      nblocks,
                      bs,
                      max_blocks,
                      d,
                      rows,
                      scale};
}

// The dynamic shared memory a paged launch asks for (either pool): dtype
// 0 = float32, 1 = bfloat16; r query heads a block (1, 2 or 4); head_dim
// d.  -1 for arguments no launch takes.
extern "C" int paged_decode_smem_bytes(int dtype, int r, int d) {
  if ((dtype != 0 && dtype != 1) || (r != 1 && r != 2 && r != 4) ||
      d <= 0 || d % 8 != 0 || d > kMaxD)
    return -1;
  if (dtype == 0)
    return r == 4 ? paged_smem_bytes<float, 4>(d)
                  : (r == 2 ? paged_smem_bytes<float, 2>(d)
                            : paged_smem_bytes<float, 1>(d));
  return r == 4 ? paged_smem_bytes<__nv_bfloat16, 4>(d)
                : (r == 2 ? paged_smem_bytes<__nv_bfloat16, 2>(d)
                          : paged_smem_bytes<__nv_bfloat16, 1>(d));
}

// q [B, Hq, D]; k_pool, v_pool [N, Hkv, bs, D] (one layer of the pool);
// table [B, M] int32 pool block ids; lengths [B] int32; out [B, Hq, D];
// ws [B, Hq, chunks, D + 2] f32 and tickets [>= B * Hq] int32 as for
// decode_attention_launch, chunks = ceil(M * bs / chunk_rows) (null when
// that is 1); chunk_rows divides bs or is a multiple of it.  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t as int.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lengths, void* out, void* ws, void* tickets, int b, int hq,
    int hkv, int nblocks, int bs, int max_blocks, int d, int chunk_rows,
    float scale, int dtype, void* stream) {
  if (bad_heads(b, hq, hkv, d) ||
      bad_paged(nblocks, bs, max_blocks, chunk_rows, ws, tickets))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = launch_paged<float, false>(
        paged_args<float>(q, k_pool, v_pool, nullptr, nullptr, nullptr,
                          nullptr, table, lengths, out, ws, tickets, hq, hkv,
                          nblocks, bs, max_blocks, d, chunk_rows,
                          scale),
        b, st);
  } else if (dtype == 1) {
    e = launch_paged<__nv_bfloat16, false>(
        paged_args<__nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr,
                                  nullptr, nullptr, table, lengths, out, ws,
                                  tickets, hq, hkv, nblocks, bs, max_blocks,
                                  d, chunk_rows, scale),
        b, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// The int8 pool: q [B, Hq, D] in T; k_pool, v_pool [N, Hkv, bs, D] int8
// codes; k_scale, v_scale [N, Hkv] float32; k_tail, v_tail
// [tail_rows >= B, Hkv, bs, D] in T (lane b's staging block is row b);
// table [B, M] int32; lengths [B] int32; out [B, Hq, D] in T; ws,
// tickets and chunk_rows as for paged_decode_attention_launch.
// dtype (of T): 0 = float32, 1 = bfloat16.  Returns a cudaError_t as int.
extern "C" int paged_decode_attention_quant_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* k_tail,
    const void* v_tail, const void* table, const void* lengths, void* out,
    void* ws, void* tickets, int b, int hq, int hkv, int nblocks, int bs,
    int max_blocks, int d, int tail_rows, int chunk_rows, float scale,
    int dtype, void* stream) {
  if (bad_heads(b, hq, hkv, d) ||
      bad_paged(nblocks, bs, max_blocks, chunk_rows, ws, tickets) ||
      tail_rows < b)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = launch_paged<float, true>(
        paged_args<float>(q, k_pool, v_pool, k_scale, v_scale, k_tail,
                          v_tail, table, lengths, out, ws, tickets, hq, hkv,
                          nblocks, bs, max_blocks, d, chunk_rows,
                          scale),
        b, st);
  } else if (dtype == 1) {
    e = launch_paged<__nv_bfloat16, true>(
        paged_args<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                  k_tail, v_tail, table, lengths, out, ws,
                                  tickets, hq, hkv, nblocks, bs, max_blocks,
                                  d, chunk_rows, scale),
        b, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
