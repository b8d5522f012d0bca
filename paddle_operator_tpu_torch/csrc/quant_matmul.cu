// The weight-only int8/int4 matmul of decode, for Hopper (sm_90a):
// out[m, n] = (sum_k x[m, k] * q[k, n]) * s[n] over M <= 16 rows.
//
// Stands where the JAX package relied on an XLA fusion, not a Pallas
// kernel: paddle_operator_tpu/infer/decode.py `_mm` (`:99`) on a
// `{"q", "s"}` leaf computes `x @ q.astype(dtype) * s`, and XLA fuses the
// convert into the dot's weight stream.  Entry `quant_matmul_launch`;
// wrapper ops/quant_matmul.py `quant_matmul`.
//
// x [M, K] in T (float or bfloat16), the codes q [K, N] int8 row-major
// (JAX's [in, out] layout; int4 codes are int8 values in [-7, 7]), the
// scales s [N] f32; out [M, N] in T.  Accumulation in f32; the scale
// multiplies the f32 sum and the product is rounded to T once.
//
// What bounds it: streaming the codes.  At the decode rows (M = 8 for
// the ring's lanes) a K x N projection reads K * N bytes of codes against
// 2 * M * K * N flops — 16 flops a byte, far below the ~295 a byte where
// Hopper's tensor cores would be the limit — so the design streams the
// codes once, with enough bytes in flight, and keeps the arithmetic off
// the critical path:
//
// - the grid is (column tiles of 128, splits of K).  A block owns 128
//   output columns and one split's rows of K (a whole number of 128-row
//   batches, at most 2048).  The splits are chosen on the host from the
//   shape (about two blocks an SM), so a launch reads nothing back.
// - the codes stream through a ring of kStages (3) batches in shared
//   memory, 128 rows x 128 columns a batch (rows padded to 144 bytes),
//   filled by asynchronous 16-byte copies (cp.async, bypassing L1) that
//   every thread issues and forgets: two batches are in flight while the
//   block multiplies the third, whatever the compiler does with registers
//   (a first design loading into registers, with or without a register
//   double buffer, read 0.7-1.5 TB/s on the card).  The first batches are
//   in flight while x is staged.  Rows past the split and columns past N
//   land as code 0.
// - codes become numbers without I2F (a quarter-rate instruction): byte
//   c + 128 is placed in the low mantissa of 2^23 by one byte permute and
//   one subtraction (codes4, as in decode_attention.cu).
// - bfloat16 x: the products run on the tensor cores (mma.sync
//   m16n8k16, f32 accumulators), rows padded to 8 or 16; on the CUDA
//   cores the 8 f32 multiply-adds a code at 8 rows were the limit (0.21
//   ms for a 7b layer against cuBLAS's 0.16 on the bf16 weights).  A warp
//   owns 32 of the block's columns and walks every row of the split: a
//   lane reads 4 codes of each of rows 2t, 2t + 1, 2t + 8, 2t + 9 of a
//   16-row step (one 4-byte shared load each; the 144-byte rows keep the
//   four rows in distinct banks) and packs them, as bfloat16 pairs along
//   K (exact: |code| <= 127), into the B fragments of four 16 x 8 tiles
//   — tile i holding the warp's columns 4g + i — so no transpose is
//   needed.  x is staged as bfloat16 [rows][split + 8] (the A fragments,
//   conflict-free).
// - float32 x (the on-card equality runs): the products on the CUDA
//   cores in f32 — 256 threads, 16 column groups of 8 columns (an 8-byte
//   shared load a row) times 16 k-lanes; x staged as f32 [split][MT]
//   so a k-lane reads a row's MT values with 16-byte loads; the k-lanes
//   reduce by a shuffle and then through shared memory in a fixed order.
// - a split's partial sums (f32, unscaled) go to a workspace the caller
//   passes [splits, M, N]; each split takes a ticket of its column tile,
//   and the tile's last split to finish adds all partials in split order
//   (the same bits whichever block it is), scales, writes out, and resets
//   the ticket to 0 for the next launch — the decode kernels'
//   split_finish.  Two variants measured slower on the card: the splits
//   of a tile as one thread-block cluster reducing through distributed
//   shared memory (co-scheduling the clusters doubled the time of the
//   3-split shape), and the block's sums staged through shared memory for
//   coalesced stores, with a batched finish (3-5 us more a call).
//   Workspace and tickets come from torch's allocator; the kernel
//   allocates nothing and never synchronizes the host, so it can be
//   captured into a CUDA graph.
// - x's slice is staged with 16-byte loads (a first version, one element
//   a load with an integer division each, cost more at 8 rows than the
//   whole walk at 1).
// - left for later: TMA tiles, a persistent grid.
//
// Any K >= 1 and N >= 1: columns past N are masked; with N % 16 != 0 or
// codes not 16-byte aligned (`vec` = 0) the ring is filled byte by byte,
// synchronously; the last split may be short.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 128;                     // columns a block
constexpr int kBatchRows = 128;                 // rows of K a batch
constexpr int kStages = 3;                      // batches in the ring
constexpr int kRowBytes = kTileN + 16;          // a staged row, padded
constexpr int kStageBytes = kBatchRows * kRowBytes;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kMaxRows = 16;
constexpr int kMaxSplitRows = 2048;
constexpr int kMaxDevices = 64;
// the f32 body: 16 column groups of 8 columns x 16 k-lanes
constexpr int kFmaThreads = 256;
constexpr int kFmaWarps = kFmaThreads / 32;
constexpr int kCols = 8;
constexpr int kColGroups = kTileN / kCols;
constexpr int kKLanes = kFmaThreads / kColGroups;
// the bf16 body: 4 warps of 32 columns
constexpr int kMmaThreads = 128;

template <typename T>
struct Act;

template <>
struct Act<float> {
  __device__ __forceinline__ static float from_float(float v) { return v; }
};

template <>
struct Act<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 from_float(float v) {
    return __float2bfloat16(v);
  }
};

// four int8 codes packed in a word -> exact floats, without I2F: byte
// c + 128 becomes the low mantissa byte of 2^23
__device__ __forceinline__ void codes4(unsigned w, float* o) {
  const unsigned x = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7540u | i)) -
           8388736.f;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; the bytes past `bytes` (0
// or 16) are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Batch b of a split (its rows b * 128 .. + 128, the block's 128 columns)
// into a stage of the ring: 1024 chunks of 16 bytes.  Rows past the split
// and columns past N land as code 0.  `vec`: asynchronous copies; else
// loaded byte by byte and stored.
template <int kThreads>
__device__ __forceinline__ void issue_batch(int8_t* stage,
                                            const int8_t* __restrict__ qk,
                                            const int8_t* __restrict__ q,
                                            int b, int rows, int col0, int n,
                                            int vec) {
  for (int c = threadIdx.x; c < kBatchRows * (kTileN / 16); c += kThreads) {
    const int row = c / (kTileN / 16), chunk = c % (kTileN / 16);
    const int grow = b * kBatchRows + row, gcol = col0 + chunk * 16;
    int8_t* dst = stage + row * kRowBytes + chunk * 16;
    const bool live = grow < rows && gcol < n;
    if (vec) {
      cp_async16(dst, live ? qk + (size_t)grow * n + gcol : q, live ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = live && gcol + j < n ? qk[(size_t)grow * n + gcol + j] : 0;
    }
  }
  cp_async_commit();
}

// Fills the ring's first kStages - 1 stages (while the caller stages x).
template <int kThreads>
__device__ __forceinline__ void prime_ring(int8_t* ring,
                                           const int8_t* __restrict__ qk,
                                           const int8_t* __restrict__ q,
                                           int batches, int rows, int col0,
                                           int n, int vec) {
#pragma unroll
  for (int b = 0; b < kStages - 1; ++b) {
    if (b < batches)
      issue_batch<kThreads>(ring + b * kStageBytes, qk, q, b, rows, col0, n,
                            vec);
    else
      cp_async_commit();
  }
}

// The ring's step at batch b: wait for it, free the previous stage, start
// batch b + kStages - 1.  Returns batch b's stage.
template <int kThreads>
__device__ __forceinline__ const int8_t* ring_step(
    int8_t* ring, const int8_t* __restrict__ qk, const int8_t* __restrict__ q,
    int b, int batches, int rows, int col0, int n, int vec) {
  cp_async_wait<kStages - 2>();  // this thread's copies of batch b
  __syncthreads();  // everyone's, and batch b - 1's stage is free
  const int nb = b + kStages - 1;
  if (nb < batches)
    issue_batch<kThreads>(ring + (nb % kStages) * kStageBytes, qk, q, nb,
                          rows, col0, n, vec);
  else
    cp_async_commit();
  return ring + (b % kStages) * kStageBytes;
}

// One f32 sum of the block: out (scaled, one split) or its partial.
template <typename T>
__device__ __forceinline__ void put_sum(T* __restrict__ out,
                                        float* __restrict__ ws,
                                        const float* __restrict__ s,
                                        int m, int n, int r, int nn,
                                        float v) {
  if (gridDim.y == 1)
    out[(size_t)r * n + nn] = Act<T>::from_float(v * s[nn]);
  else
    ws[((size_t)blockIdx.y * m + r) * n + nn] = v;
}

// After every thread's put_sum: the column tile's last split to finish
// adds the partials of all splits in split order, scales and writes out,
// and resets the tile's ticket.
template <typename T>
__device__ __forceinline__ void finish_splits(T* __restrict__ out,
                                              const float* __restrict__ ws,
                                              int* __restrict__ tickets,
                                              const float* __restrict__ s,
                                              int m, int n, int nthreads) {
  __shared__ int last;
  const int splits = gridDim.y;
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + blockIdx.x, 1) == splits - 1;
    if (last) atomicExch(tickets + blockIdx.x, 0);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < m * kTileN; i += nthreads) {
    const int r = i / kTileN, nn = blockIdx.x * kTileN + i % kTileN;
    if (nn >= n) continue;
    const float* part = ws + (size_t)r * n + nn;
    const size_t stride = (size_t)m * n;
    float v = 0.f;
#pragma unroll 4
    for (int j = 0; j < splits; ++j) v += __ldcg(part + j * stride);
    out[(size_t)r * n + nn] = Act<T>::from_float(v * s[nn]);
  }
}

// x[r, k0 + c] for r < MT, c < bk (zero past m rows and the split's
// `rows`) -> put(r, c, value): 16-byte loads when a row's slice is
// aligned (K % 8 == 0 for bf16, % 4 for f32), else one element a load
template <int MT, int kThreads, typename T, typename Put>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, int m,
                                        int k, int k0, int rows, int bk,
                                        int xvec, Put put) {
  constexpr int V = 16 / sizeof(T);
  if (xvec) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      for (int c = threadIdx.x * V; c < bk; c += kThreads * V) {
        if (r < m && c < rows) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(x + (size_t)r * k + k0 + c);
          const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < V; ++j)
            put(r, c + j, c + j < rows ? v[j] : T(0.f));
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) put(r, c + j, T(0.f));
        }
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < MT; ++r)
      for (int c = threadIdx.x; c < bk; c += kThreads)
        put(r, c, r < m && c < rows ? x[(size_t)r * k + k0 + c] : T(0.f));
  }
}

// ---------------------------------------------------------------------------
// bfloat16 x: the tensor cores
// ---------------------------------------------------------------------------

// the ring, then x as bf16 [MT][bk + 8]: the pad keeps the A-fragment
// loads of the 8 rows in distinct banks
__host__ __device__ constexpr int mma_smem_bytes(int mt, int bk) {
  return kRingBytes + mt * (bk + 8) * 2;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two rows' words of 4 codes -> for each of the 4 columns a bf16 pair
// (row 0 low, row 1 high): exact, |code| <= 127
__device__ __forceinline__ void pair_codes(unsigned w0, unsigned w1,
                                           unsigned (&p)[4]) {
  float f0[4], f1[4];
  codes4(w0, f0);
  codes4(w1, f1);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __byte_perm(__float_as_uint(f0[i]), __float_as_uint(f1[i]),
                       0x7632);
}

template <int MT>
__global__ void __launch_bounds__(kMmaThreads)
    quant_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                            const int8_t* __restrict__ q,
                            const float* __restrict__ s,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ ws, int* __restrict__ tickets,
                            int m, int k, int n, int bk, int vec, int xvec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem_raw);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw + kRingBytes);
  const int xstride = bk + 8;
  const int k0 = blockIdx.y * bk;
  const int rows = min(k - k0, bk);
  const int batches = (rows + kBatchRows - 1) / kBatchRows;
  const int col0 = blockIdx.x * kTileN;
  const int8_t* qk = q + (size_t)k0 * n;

  prime_ring<kMmaThreads>(ring, qk, q, batches, rows, col0, n, vec);
  stage_x<MT, kMmaThreads>(x, m, k, k0, rows, bk, xvec,
                           [&](int r, int c, __nv_bfloat16 v) {
                             xs[r * xstride + c] = v;
                           });

  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wc = warp * 32;  // the warp's columns in the tile
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const unsigned* xa = reinterpret_cast<const unsigned*>(xs);
  for (int b = 0; b < batches; ++b) {
    const int8_t* st = ring_step<kMmaThreads>(ring, qk, q, b, batches, rows,
                                              col0, n, vec);
#pragma unroll 2
    for (int kb = 0; kb < kBatchRows; kb += 16) {
      // A: x rows g (and g + 8), K columns 2t, 2t + 1 (+ 8)
      const int xk = (b * kBatchRows + kb + 2 * t) / 2;
      const unsigned a0 = xa[g * xstride / 2 + xk];
      const unsigned a2 = xa[g * xstride / 2 + xk + 4];
      unsigned a1 = 0u, a3 = 0u;
      if constexpr (MT == 16) {
        a1 = xa[(g + 8) * xstride / 2 + xk];
        a3 = xa[(g + 8) * xstride / 2 + xk + 4];
      }
      // B: codes of rows 2t, 2t + 1, 2t + 8, 2t + 9, columns wc + 4g .. + 3
      const int8_t* r0 = st + (kb + 2 * t) * kRowBytes + wc + 4 * g;
      const unsigned w0 = *reinterpret_cast<const unsigned*>(r0);
      const unsigned w1 = *reinterpret_cast<const unsigned*>(r0 + kRowBytes);
      const unsigned w8 =
          *reinterpret_cast<const unsigned*>(r0 + 8 * kRowBytes);
      const unsigned w9 =
          *reinterpret_cast<const unsigned*>(r0 + 9 * kRowBytes);
      unsigned lo[4], hi[4];
      pair_codes(w0, w1, lo);
      pair_codes(w8, w9, hi);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_bf16(acc[i], a0, a1, a2, a3, lo[i], hi[i]);
    }
  }
  cp_async_wait<0>();

  // tile i's C fragment: rows g, g + 8; its columns 2t, 2t + 1, which are
  // the block's columns wc + 4 (2t) + i and wc + 4 (2t + 1) + i
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = g + (j / 2) * 8;
      const int nn = col0 + wc + 4 * (2 * t + (j % 2)) + i;
      if (r < m && nn < n) put_sum(out, ws, s, m, n, r, nn, acc[i][j]);
    }
  if (gridDim.y > 1) finish_splits(out, ws, tickets, s, m, n, kMmaThreads);
}

// ---------------------------------------------------------------------------
// float32 x: the CUDA cores
// ---------------------------------------------------------------------------

// the ring, then x as f32 [bk][MT]; the reduction [kFmaWarps][MT][kTileN]
// f32 reuses the space after the walk
__host__ __device__ constexpr int fma_smem_bytes(int mt, int bk) {
  return kRingBytes + bk * mt * 4 > kFmaWarps * mt * kTileN * 4
             ? kRingBytes + bk * mt * 4
             : kFmaWarps * mt * kTileN * 4;
}

// acc[r][j] += x[r, row] * code[row, j] over a staged batch: thread
// (column group cg, k-lane kl) takes rows kl, kl + 16, ..., kl + 112
template <int MT>
__device__ __forceinline__ void fma_batch(float (&acc)[MT][kCols],
                                         const int8_t* stage, const float* xs,
                                         int base, int cg, int kl) {
#pragma unroll
  for (int u = 0; u < kBatchRows / kKLanes; ++u) {
    const int row = kl + u * kKLanes;
    const uint2 w =
        *reinterpret_cast<const uint2*>(stage + row * kRowBytes + cg * kCols);
    float c[kCols];
    codes4(w.x, c);
    codes4(w.y, c + 4);
    const float* xr = xs + (size_t)(base + row) * MT;
    float xv[MT];
    if constexpr (MT >= 4) {
#pragma unroll
      for (int r = 0; r < MT; r += 4) {
        const float4 f = *reinterpret_cast<const float4*>(xr + r);
        xv[r] = f.x;
        xv[r + 1] = f.y;
        xv[r + 2] = f.z;
        xv[r + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < MT; ++r) xv[r] = xr[r];
    }
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(xv[r], c[j], acc[r][j]);
  }
}

template <int MT>
__global__ void __launch_bounds__(kFmaThreads)
    quant_matmul_fma_kernel(const float* __restrict__ x,
                            const int8_t* __restrict__ q,
                            const float* __restrict__ s,
                            float* __restrict__ out, float* __restrict__ ws,
                            int* __restrict__ tickets, int m, int k, int n,
                            int bk, int vec, int xvec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem_raw);
  float* xs = reinterpret_cast<float*>(smem_raw + kRingBytes);
  const int k0 = blockIdx.y * bk;
  const int rows = min(k - k0, bk);
  const int batches = (rows + kBatchRows - 1) / kBatchRows;
  const int col0 = blockIdx.x * kTileN;
  const int8_t* qk = q + (size_t)k0 * n;
  const int cg = threadIdx.x % kColGroups;
  const int kl = threadIdx.x / kColGroups;

  prime_ring<kFmaThreads>(ring, qk, q, batches, rows, col0, n, vec);
  stage_x<MT, kFmaThreads>(x, m, k, k0, rows, bk, xvec,
                           [&](int r, int c, float v) { xs[c * MT + r] = v; });

  float acc[MT][kCols];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  for (int b = 0; b < batches; ++b) {
    const int8_t* st = ring_step<kFmaThreads>(ring, qk, q, b, batches, rows,
                                              col0, n, vec);
    fma_batch<MT>(acc, st, xs, b * kBatchRows, cg, kl);
  }
  cp_async_wait<0>();

  // lanes l and l ^ 16 hold the same columns at neighbouring k-lanes
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
  __syncthreads();  // the walk no longer reads the ring or xs
  float* red = reinterpret_cast<float*>(smem_raw);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) < kColGroups) {
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        red[(warp * MT + r) * kTileN + cg * kCols + j] = acc[r][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m * kTileN; i += kFmaThreads) {
    const int r = i / kTileN, col = i - r * kTileN;
    const int nn = col0 + col;
    if (nn >= n) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kFmaWarps; ++w) v += red[(w * MT + r) * kTileN + col];
    put_sum(out, ws, s, m, n, r, nn, v);
  }
  if (gridDim.y > 1) finish_splits(out, ws, tickets, s, m, n, kFmaThreads);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// raises a kernel's dynamic shared memory limit, once per device for the
// largest request seen (`allowed`: the kernel's own record)
template <typename K>
cudaError_t allow_smem(K kernel, int smem, int (&allowed)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev] < smem) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    allowed[dev] = smem;
  }
  return cudaSuccess;
}

template <int MT>
cudaError_t launch_mma(const void* x, const void* q, const void* s,
                       void* out, void* ws, void* tickets, int m, int k,
                       int n, int splits, int bk, int vec, int xvec,
                       cudaStream_t st) {
  static int allowed[kMaxDevices] = {0};
  auto kernel = quant_matmul_mma_kernel<MT>;
  const int smem = mma_smem_bytes(MT, bk);
  cudaError_t e = allow_smem(kernel, smem, allowed);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((n + kTileN - 1) / kTileN, splits), kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(tickets), m, k, n, bk, vec,
      xvec);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_fma(const void* x, const void* q, const void* s,
                       void* out, void* ws, void* tickets, int m, int k,
                       int n, int splits, int bk, int vec, int xvec,
                       cudaStream_t st) {
  static int allowed[kMaxDevices] = {0};
  auto kernel = quant_matmul_fma_kernel<MT>;
  const int smem = fma_smem_bytes(MT, bk);
  cudaError_t e = allow_smem(kernel, smem, allowed);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((n + kTileN - 1) / kTileN, splits), kFmaThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(tickets), m, k, n, bk, vec,
      xvec);
  return cudaGetLastError();
}

}  // namespace

// x [m, k] (dtype 0 = float32, 1 = bfloat16), q [k, n] int8, s [n] f32,
// out [m, n]; 1 <= m <= 16.  The grid splits K into `splits` runs of
// `bk` rows (a multiple of 128, at most 2048; the last run may be short
// but not empty).  With splits > 1, ws holds at least splits * m * n f32
// and tickets at least ceil(n / 128) int32, zero before the first launch
// and left zero by every launch.  vec = 1 only when n % 16 == 0 and q is
// 16-byte aligned; xvec = 1 only when x is 16-byte aligned and k a
// multiple of 16 bytes of x.  Returns a cudaError_t as int.
extern "C" int quant_matmul_launch(const void* x, const void* q,
                                   const void* s, void* out, void* ws,
                                   void* tickets, int m, int k, int n,
                                   int splits, int bk, int vec, int xvec,
                                   int dtype, void* stream) {
  if (m < 1 || m > kMaxRows || k < 1 || n < 1 || splits < 1 ||
      splits > 65535 || bk < kBatchRows || bk % kBatchRows != 0 ||
      bk > kMaxSplitRows || (long long)(splits - 1) * bk >= k ||
      (long long)splits * bk < k ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 1) {
    e = m <= 8 ? launch_mma<8>(x, q, s, out, ws, tickets, m, k, n, splits,
                               bk, vec, xvec, st)
               : launch_mma<16>(x, q, s, out, ws, tickets, m, k, n, splits,
                                bk, vec, xvec, st);
  } else if (dtype == 0) {
    if (m <= 1)
      e = launch_fma<1>(x, q, s, out, ws, tickets, m, k, n, splits, bk, vec,
                        xvec, st);
    else if (m <= 2)
      e = launch_fma<2>(x, q, s, out, ws, tickets, m, k, n, splits, bk, vec,
                        xvec, st);
    else if (m <= 4)
      e = launch_fma<4>(x, q, s, out, ws, tickets, m, k, n, splits, bk, vec,
                        xvec, st);
    else if (m <= 8)
      e = launch_fma<8>(x, q, s, out, ws, tickets, m, k, n, splits, bk, vec,
                        xvec, st);
    else
      e = launch_fma<16>(x, q, s, out, ws, tickets, m, k, n, splits, bk, vec,
                         xvec, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
