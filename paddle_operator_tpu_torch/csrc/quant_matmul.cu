// The weight-only int8/int4 matmul of serving, for Hopper (sm_90a):
// out[m, n] = (sum_k x[m, k] * q[k, n]) * s[n], in two kernels.
//
// Stands where the JAX package relied on an XLA fusion, not a Pallas
// kernel: paddle_operator_tpu/infer/decode.py `_mm` (`:99`) on a
// `{"q", "s"}` leaf computes `x @ q.astype(dtype) * s`, and XLA fuses the
// convert into the dot's weight stream.  Wrappers in ops/quant_matmul.py:
//
// - kernel A, `quant_matmul_launch` (`quant_matmul`): the decode rows,
//   1 <= M <= 64 — the ring's lanes, a batch step, a prefix hit's suffix,
//   the speculative verify's 8 x (K + 1) rows, a 64-row prefill slice.
// - kernel B, `quant_gemm_launch` (`quant_gemm`): any M >= 1, routed the
//   rows above kernel A's limit — prompt prefills, long suffixes, wider
//   slices.
//
// x [M, K] in T (float or bfloat16), the codes q [K, N] int8 row-major
// (JAX's [in, out] layout; int4 codes are int8 values in [-7, 7]), the
// scales s [N] f32; out [M, N] in T.  Accumulation in f32; the scale
// multiplies the f32 sum and the product is rounded to T once.
//
// What bounds them.  At the decode rows a K x N projection reads K * N
// bytes of codes against 2 * M * K * N flops — 16 flops a byte at M = 8,
// 128 at M = 64, below the ~295 a byte where Hopper's tensor cores become
// the limit — so kernel A must stream the codes at the memory's rate.  At
// a prefill's hundreds of rows the products are the limit, and only
// warpgroup MMA (wgmma) reaches the tensor cores' rate; there the
// conversion of the codes to bf16 (about 3 instructions a code: a byte
// permute places code + 128 in the low mantissa of 2^23, a subtraction,
// a permute packing two into a bf16 pair) must be paid once per code a
// block, not once per product.
//
// Kernel A's bf16 body (`quant_matmul_wgmma_kernel<BM, G, 1>`): A and B of
// the product are swapped, out^T = dequant(q)^T . x^T on wgmma
// m64nBMk16 — A the converted codes, from registers; B x^T, K-major in
// shared memory as x lies in device memory; N the rows, padded to BM =
// 8, 16, 32 or 64.  So 8 lanes fill an n8 tile exactly (the earlier
// mma.sync m16n8k16 design, x as A, padded them to 16), and the
// products run asynchronously.
//
// - a block of one warpgroup owns 128 output columns (two m64 products)
//   and one split's rows of K; the grid is (row blocks: 1, column tiles,
//   splits), the splits chosen on the host from the shape so that the
//   card holds about two blocks an SM (host shapes only: a launch reads
//   nothing back).
// - codes and x stream through a ring of stages in shared memory, 64 rows
//   of K a stage: the codes as 64 x 128 bytes (rows padded to 144, so the
//   four rows a thread reads fall in distinct banks), x as BM rows x 64
//   bf16 in the 128-byte-swizzled rows the wgmma descriptor reads.  Every
//   thread issues asynchronous 16-byte copies (cp.async, bypassing L1)
//   and forgets them; stage b + S - 2 is issued while stage b is
//   multiplied (S = 8 stages at BM <= 32, 6 at 64: about 100 KB, two
//   blocks an SM), one stage of slack so a copy never lands under a
//   product still reading it.  Rows past the split and columns past N
//   land as zeros.
// - a thread reads 4 codes of each of K rows 2t, 2t + 1, 2t + 8, 2t + 9
//   of a 16-row step (one 4-byte shared load each) and packs them, as
//   bfloat16 pairs along K, into the A fragments of the two m64
//   products: product j's row g is the column 4g + 2j of the warp's 32,
//   its row g + 8 the column 4g + 2j + 1.  A stage's four steps are
//   converted into one of two fragment buffers and their eight products
//   issued as one group (G = 4); a buffer is rewritten only after the
//   group that read it has completed (wgmma.wait_group 1).  A wait
//   after every step (G = 1) measured slower.
// - a split's partial sums (f32, unscaled) go to a workspace the caller
//   passes [splits, M, N]; each split takes a ticket of its (row block,
//   column tile), and the last split to finish adds all partials in split
//   order (the same bits whichever block it is), scales, writes out, and
//   resets the ticket to 0 — the mma.sync design's finish, now four
//   columns a thread with several groups' loads in flight.  With one
//   split the block scales and stores itself.  Workspace and tickets
//   come from torch's allocator; the kernels allocate nothing and never
//   synchronize the host, so they can be captured into a CUDA graph.
//
// Kernel B's bf16 body is the same kernel with two warpgroups a block
// (`quant_matmul_wgmma_kernel<128, G, 2>`): 128 rows of x (wgmma N = 128)
// and 256 output columns, each warpgroup converting and multiplying its
// own 128 columns against the stages' one copy of x, so that x, re-read
// for every column tile, costs half the L2 traffic it would with one
// warpgroup a block.  Six stages; one block an SM, since the accumulators
// of 128 rows x 128 columns take 128 registers a thread.  Its products
// issue a step at a time (G = 1), a few percent faster there than a
// stage at a time.  What holds it back (phase 2e's variants): its loads
// and conversions alone take 55-60% of a call at M 512 and 2048 and
// the products most of the rest — the two barely overlap under the
// block-wide barrier of each stage.  Tried and dropped: one warpgroup a
// block, and the codes converted once a block into shared memory
// (MN-major, swizzled) for two warpgroups' shared-memory products over
// 256 rows of x; both were slower at every M they were timed at (the 7b
// shapes, M 65 to 2048).
//
// The float32 bodies (the on-card equality runs, not a served replica):
// kernel A keeps the mma.sync design's CUDA-core body (16 column groups
// of 8 columns x 16 k-lanes, a 3-stage cp.async ring of 128-row batches,
// x staged as f32 [split][16]), rows in groups of 16 over the grid's
// first axis;
// kernel B is a plain tiled product, 64 x 64 outputs a block of 256
// threads, each summing its 4 x 4 outputs along K in order.
//
// Any K >= 1 and N >= 1: columns past N are masked; with N % 16 != 0 or
// codes not 16-byte aligned (`vec` = 0) the codes' stages are filled byte
// by byte, synchronously, and with x's rows not 16-byte aligned (`xvec` =
// 0) x's element by element; the last split may be short.
//
// Timing variants of the bf16 bodies, compiled only with -DQMM_PROBE (a
// second library that chip_smoke.py's phase 2e builds to split a call's
// time; the served library is built without it, and there the bits are
// the constant 0): `quant_matmul_set_probe(bits)` selects, for the
// launches after it, bit 0 — the codes converted but no product, bit 1 —
// the partials written but no split finish, bit 2 — the products grouped
// the other way (kernel A a step at a time, kernel B a stage at a time).
//
// Tried and dropped with the mma.sync design: the splits of a tile as one
// thread-block cluster reducing through distributed shared memory, and a
// batched finish through shared memory.  Not built: TMA tiles (a tensor
// map needs N % 16 == 0, and kernel A's cp.async ring already keeps ~100
// KB in flight an SM with four copies a thread a stage), a producer warp
// and mbarrier stages in place of the block-wide barrier (kernel B's
// next design: at a prefill's rows its loads and its products barely
// overlap), TMA multicast of x across a cluster, a persistent stream-K
// grid, and one launch for projections sharing x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileN = 128;            // output columns a block
constexpr int kRowBytes = kTileN + 16;  // a staged row of codes, padded
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;
// the f32 body of kernel A (the mma.sync design's): batches of 128 rows
// of K in a 3-stage ring, 16 rows of x a group, at most 2048 rows of K a
// split
constexpr int kBatchRows = 128;
constexpr int kStages = 3;
constexpr int kStageBytes = kBatchRows * kRowBytes;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kGroupRows = 16;
constexpr int kMaxSplitRows = 2048;
constexpr int kFmaThreads = 256;
constexpr int kFmaWarps = kFmaThreads / 32;
constexpr int kCols = 8;
constexpr int kColGroups = kTileN / kCols;
constexpr int kKLanes = kFmaThreads / kColGroups;
// the bf16 body: stages of 64 rows of K, one warpgroup a block
constexpr int kWgRows = 64;
constexpr int kWgThreads = 128;
constexpr int kMaxRowsA = 64;          // kernel A's rows
constexpr int kRowsB = 128;            // kernel B's rows a block (bf16)
constexpr int kWarpgroupsB = 2;        // kernel B's warpgroups a block
#ifdef QMM_PROBE
// the timing variants' bits (note above): kProbe for the kernels, set by
// quant_matmul_set_probe with g_probe, the launches' copy
__constant__ int kProbe;
int g_probe = 0;
#else
constexpr int kProbe = 0;
#endif
// kernel B's f32 body: 64 x 64 outputs a block, K in steps of 16
constexpr int kGemmTile = 64;
constexpr int kGemmK = 16;
constexpr int kGemmThreads = 256;

// the bf16 body's block of NW warpgroups: its columns, a staged row of
// codes (padded so that rows 2 apart differ by 32 bytes mod 128), a
// stage, and the stages of its ring (two blocks an SM with one
// warpgroup, one with two)
__host__ __device__ constexpr int wg_cols(int nw) { return kTileN * nw; }
__host__ __device__ constexpr int wg_row_bytes(int nw) {
  return wg_cols(nw) + 16;
}
__host__ __device__ constexpr int wg_stage_bytes(int bm, int nw) {
  return kWgRows * wg_row_bytes(nw) + bm * 128;
}
__host__ __device__ constexpr int wg_stages(int bm, int nw) {
  return nw > 1 ? 6 : bm <= 32 ? 8 : 6;
}
// + 1024: the ring's start is rounded up to the swizzle atom
__host__ __device__ constexpr int wg_smem_bytes(int bm, int nw) {
  return wg_stages(bm, nw) * wg_stage_bytes(bm, nw) + 1024;
}
static_assert(kWgRows * wg_row_bytes(1) % 1024 == 0 &&
                  kWgRows * wg_row_bytes(2) % 1024 == 0,
              "x's stage must sit on 1024 bytes");
static_assert(2 * (wg_smem_bytes(32, 1) + 1024) <= 233472 &&
                  2 * (wg_smem_bytes(64, 1) + 1024) <= 233472 &&
                  wg_smem_bytes(kRowsB, kWarpgroupsB) <= kMaxSmem,
              "two blocks an SM with one warpgroup, one with two");

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

// four f32 sums times their scales, rounded to T, at out[0..3] (16-byte
// aligned for float, 8-byte for bfloat16)
__device__ __forceinline__ void store4(float* o, float4 v, float4 sc) {
  *reinterpret_cast<float4*>(o) =
      make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v,
                                       float4 sc) {
  __nv_bfloat162 p0 = __floats2bfloat162_rn(v.x * sc.x, v.y * sc.y);
  __nv_bfloat162 p1 = __floats2bfloat162_rn(v.z * sc.z, v.w * sc.w);
  uint2 w;
  w.x = *reinterpret_cast<unsigned*>(&p0);
  w.y = *reinterpret_cast<unsigned*>(&p1);
  *reinterpret_cast<uint2*>(o) = w;
}

// After every thread's partial sums of its (row block, column tile) are
// in the workspace: the last split to finish adds the partials of all
// splits in split order over rows r0 .. r1 - 1, scales and writes out,
// and resets the ticket.  Grid: (row blocks, column tiles, splits).  With
// N % 4 == 0 a thread sums four columns at once and keeps kU such groups'
// loads in flight together (a first version, one value at a time with
// its splits' loads, waited out one L2 round trip after another, and
// took a large share of a call, most at 64 rows).
template <typename T>
__device__ __forceinline__ void finish_splits(T* __restrict__ out,
                                              const float* __restrict__ ws,
                                              int* __restrict__ tickets,
                                              const float* __restrict__ s,
                                              int m, int n, int r0, int r1,
                                              int tn, int nthreads) {
  constexpr int kU = 4;
  __shared__ int last;
  const int splits = gridDim.z;
  int* ticket = tickets + blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == splits - 1;
    if (last) atomicExch(ticket, 0);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int col0 = blockIdx.y * tn;
  const size_t stride = (size_t)m * n;
  if (n % 4 == 0) {
    const int units = (r1 - r0) * (tn / 4);
    for (int base = threadIdx.x; base < units; base += nthreads * kU) {
      size_t at[kU];
      int col[kU];
      bool live[kU];
      float4 v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = base + u * nthreads;
        const int nn = col0 + (i % (tn / 4)) * 4;
        live[u] = i < units && nn < n;
        col[u] = nn;
        at[u] = (size_t)(r0 + i / (tn / 4)) * n + nn;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll 4
      for (int j = 0; j < splits; ++j)
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (live[u]) {
            const float4 p =
                __ldcg(reinterpret_cast<const float4*>(ws + j * stride +
                                                       at[u]));
            v[u].x += p.x;
            v[u].y += p.y;
            v[u].z += p.z;
            v[u].w += p.w;
          }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (live[u])
          store4(out + at[u], v[u],
                 make_float4(s[col[u]], s[col[u] + 1], s[col[u] + 2],
                             s[col[u] + 3]));
    }
    return;
  }
  for (int i = threadIdx.x; i < (r1 - r0) * tn; i += nthreads) {
    const int r = r0 + i / tn, nn = col0 + i % tn;
    if (nn >= n) continue;
    const float* part = ws + (size_t)r * n + nn;
    float v = 0.f;
#pragma unroll 4
    for (int j = 0; j < splits; ++j) v += __ldcg(part + j * stride);
    out[(size_t)r * n + nn] = Act<T>::from_float(v * s[nn]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 x: wgmma, A and B swapped (both kernels)
// ---------------------------------------------------------------------------

// The dynamic shared memory, its start rounded up to 1024 bytes (the
// swizzle atom); the launch asks for 1024 bytes of slack.
__device__ __forceinline__ unsigned char* smem_1024(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled K-major operand:
// start address, 1024 bytes between 8-row atoms
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>(16 >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The writes of this thread to shared memory (cp.async and stores) made
// visible to the async proxy, which wgmma reads its shared operands by.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Holds a fragment buffer live until here: a product issued earlier reads
// these registers asynchronously, so the compiler must not reuse them
// before the wait that completes it.
template <int G>
__device__ __forceinline__ void keep(const uint32_t (&a)[G][2][4]) {
#pragma unroll
  for (int u = 0; u < G; ++u)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(a[u][j][i]) : "memory");
}

// D[64 x N] += A[64 x 16] . B[16 x N]: A as bf16 register fragments (the
// m16n8k16 A layout, warp w holding rows 16 w .. 16 w + 15), B K-major in
// shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_k<8>(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}"
      ", {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_k<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_k<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_k<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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
__device__ __forceinline__ void wgmma_rs_k<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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


// Stage b of the block's split: codes rows b * 64 .. + 64 (of the split)
// and the block's 128 NW columns, then x's BM rows over the same rows of
// K, 128-byte swizzled (16-byte chunk c of row r at chunk c ^ (r % 8)).
template <int BM, int NW>
__device__ __forceinline__ void wg_issue(
    unsigned char* st, const int8_t* __restrict__ qk,
    const int8_t* __restrict__ q, const __nv_bfloat16* __restrict__ xk,
    const __nv_bfloat16* __restrict__ x, int b, int rows, int col0, int n,
    int k, int mrows, int vec, int xvec) {
  constexpr int kChunks = wg_cols(NW) / 16, RB = wg_row_bytes(NW);
  for (int c = threadIdx.x; c < kWgRows * kChunks; c += kWgThreads * NW) {
    const int row = c / kChunks, chunk = c % kChunks;
    const int grow = b * kWgRows + row, gcol = col0 + chunk * 16;
    int8_t* dst = reinterpret_cast<int8_t*>(st) + row * RB + chunk * 16;
    const bool live = grow < rows && gcol < n;
    if (vec) {
      cp_async16(dst, live ? qk + (size_t)grow * n + gcol : q, live ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = live && gcol + j < n ? qk[(size_t)grow * n + gcol + j] : 0;
    }
  }
  unsigned char* xs = st + kWgRows * RB;
  for (int c = threadIdx.x; c < BM * 8; c += kWgThreads * NW) {
    const int r = c >> 3, ch = c & 7;
    const int kc = b * kWgRows + ch * 8;  // within the split
    unsigned char* dst = xs + r * 128 + ((ch ^ (r & 7)) << 4);
    const bool live = r < mrows && kc < rows;
    if (xvec) {
      cp_async16(dst, live ? xk + (size_t)r * k + kc : x, live ? 16 : 0);
    } else {
      __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = live && kc + j < rows ? xk[(size_t)r * k + kc + j]
                                     : __float2bfloat16(0.f);
    }
  }
}

// One stage of the walk (batch b of the split): wait for its copies,
// issue stage b + D, then its four 16-row steps in groups of G — each
// group converted into fragment buffer ((P * 4 / G) + step / G) % 2 and
// its 2 G products issued together; after each group the previous group
// is waited out (wgmma.wait_group 1), which frees the other buffer and,
// by the next stage, the stage refilled there.  P: b's parity (the
// walk handles two stages an iteration, so the buffer is known at
// compile time).
template <int BM, int G, int NW, int P>
__device__ __forceinline__ void wg_stage(
    unsigned char* ring, const int8_t* __restrict__ qk,
    const int8_t* __restrict__ q, const __nv_bfloat16* __restrict__ xk,
    const __nv_bfloat16* __restrict__ x, int b, int batches, int rows,
    int col0, int n, int k, int mrows, int vec, int xvec, int cb,
    int t, float (&acc0)[BM / 2], float (&acc1)[BM / 2],
    uint32_t (&fa)[2][G][2][4]) {
  constexpr int S = wg_stages(BM, NW), D = S - 2;
  constexpr int SB = wg_stage_bytes(BM, NW), RB = wg_row_bytes(NW);
  cp_async_wait<D - 1>();  // this thread's copies of stage b
  fence_async_smem();
  __syncthreads();  // everyone's; stage b - 2's products are complete
  if (b + D < batches)
    wg_issue<BM, NW>(ring + ((b + D) % S) * SB, qk, q, xk, x, b + D, rows,
                     col0, n, k, mrows, vec, xvec);
  cp_async_commit();
  __syncwarp();  // converged for the .aligned wgmma
  const unsigned char* st = ring + (b % S) * SB;
  const unsigned char* xs = st + kWgRows * RB;
#pragma unroll
  for (int gi = 0; gi < kWgRows / 16 / G; ++gi) {
    constexpr int kGroups = kWgRows / 16 / G;
    const int buf = (P * kGroups + gi) & 1;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int kk = gi * G + u;
      const unsigned char* r0 = st + (16 * kk + 2 * t) * RB + cb;
      const unsigned w0 = *reinterpret_cast<const unsigned*>(r0);
      const unsigned w1 = *reinterpret_cast<const unsigned*>(r0 + RB);
      const unsigned w8 = *reinterpret_cast<const unsigned*>(r0 + 8 * RB);
      const unsigned w9 = *reinterpret_cast<const unsigned*>(r0 + 9 * RB);
      unsigned lo[4], hi[4];
      pair_codes(w0, w1, lo);
      pair_codes(w8, w9, hi);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        fa[buf][u][j][0] = lo[2 * j];
        fa[buf][u][j][1] = lo[2 * j + 1];
        fa[buf][u][j][2] = hi[2 * j];
        fa[buf][u][j][3] = hi[2 * j + 1];
      }
    }
    if (kProbe & 1) {
      keep(fa[buf]);
      continue;
    }
    wg_fence();
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const uint64_t db = desc_sw128(xs + 32 * (gi * G + u));
      wgmma_rs_k<BM>(acc0, fa[buf][u][0], db);
      wgmma_rs_k<BM>(acc1, fa[buf][u][1], db);
    }
    wg_commit();
    wg_wait<1>();  // the previous group's products
    keep(fa[buf ^ 1]);
  }
}

// One block of NW warpgroups: x rows row0 .. row0 + BM - 1 (blockIdx.x),
// output columns col0 .. col0 + 128 NW - 1 (blockIdx.y; warpgroup w owns
// 128 of them), rows of K k0 .. k0 + bk - 1 (blockIdx.z, the split);
// products issued in groups of G steps.  The warpgroups share the
// stages' x.
template <int BM, int G, int NW>
__global__ void __launch_bounds__(kWgThreads * NW)
    quant_matmul_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                              const int8_t* __restrict__ q,
                              const float* __restrict__ s,
                              __nv_bfloat16* __restrict__ out,
                              float* __restrict__ ws,
                              int* __restrict__ tickets, int m, int k,
                              int n, int bk, int vec, int xvec) {
  constexpr int D = wg_stages(BM, NW) - 2, SB = wg_stage_bytes(BM, NW);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_1024(smem_raw);
  const int row0 = blockIdx.x * BM;
  const int mrows = min(BM, m - row0);
  const int col0 = blockIdx.y * wg_cols(NW);
  const int k0 = blockIdx.z * bk;
  const int rows = min(k - k0, bk);
  const int batches = (rows + kWgRows - 1) / kWgRows;
  const int8_t* qk = q + (size_t)k0 * n;
  const __nv_bfloat16* xk = x + (size_t)row0 * k + k0;

#pragma unroll
  for (int b = 0; b < D; ++b) {
    if (b < batches)
      wg_issue<BM, NW>(ring + b * SB, qk, q, xk, x, b, rows, col0, n, k,
                       mrows, vec, xvec);
    cp_async_commit();
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  // the thread's 4 columns: warp w's 32 of the block (its warpgroup's
  // 128 are w / 4's)
  const int cb = 32 * warp + 4 * (lane >> 2);
  float acc0[BM / 2], acc1[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc0[i] = acc1[i] = 0.f;
  uint32_t fa[2][G][2][4];  // [buffer][step][product][register]
#pragma unroll
  for (int v = 0; v < 2; ++v)
#pragma unroll
    for (int u = 0; u < G; ++u)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) fa[v][u][j][i] = 0u;

  for (int b = 0; b < batches; b += 2) {
    wg_stage<BM, G, NW, 0>(ring, qk, q, xk, x, b, batches, rows, col0, n, k,
                           mrows, vec, xvec, cb, t, acc0, acc1, fa);
    if (b + 1 < batches)
      wg_stage<BM, G, NW, 1>(ring, qk, q, xk, x, b + 1, batches, rows, col0,
                             n, k, mrows, vec, xvec, cb, t, acc0, acc1,
                             fa);
  }
  wg_wait<0>();
  keep(fa[0]);
  keep(fa[1]);
  fence_regs(acc0);
  fence_regs(acc1);
  cp_async_wait<0>();

  // accumulator element 4 q + 2 h + e of product j: x row 8 q + 2 t + e,
  // output column cb + 2 j + h
  const int c = col0 + cb;
  const bool vec4 = n % 4 == 0 && c + 3 < n;
  float sc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) sc[i] = c + i < n ? s[c + i] : 0.f;
#pragma unroll
  for (int qd = 0; qd < BM / 8; ++qd)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row0 + 8 * qd + 2 * t + e;
      if (r >= m) continue;
      const float4 v = make_float4(acc0[4 * qd + e], acc0[4 * qd + 2 + e],
                                   acc1[4 * qd + e], acc1[4 * qd + 2 + e]);
      if (gridDim.z == 1) {
        __nv_bfloat16* o = out + (size_t)r * n + c;
        if (vec4) {
          store4(o, v, make_float4(sc[0], sc[1], sc[2], sc[3]));
        } else {
          const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (c + i < n) o[i] = __float2bfloat16(w[i] * sc[i]);
        }
      } else {
        float* p = ws + ((size_t)blockIdx.z * m + r) * n + c;
        if (vec4) {
          *reinterpret_cast<float4*>(p) = v;
        } else {
          const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (c + i < n) p[i] = w[i];
        }
      }
    }
  if (gridDim.z > 1 && !(kProbe & 2))
    finish_splits(out, ws, tickets, s, m, n, row0, row0 + mrows,
                  wg_cols(NW), kWgThreads * NW);
}

// ---------------------------------------------------------------------------
// float32 x, kernel A: the CUDA cores (the mma.sync design's), 16-row groups
// ---------------------------------------------------------------------------

// 16 bytes global -> shared for batch b of a split (its rows b * 128 ..
// + 128, the block's 128 columns) into a stage of the ring.  Rows past
// the split and columns past N land as code 0.  `vec`: asynchronous
// copies; else loaded byte by byte and stored.
__device__ __forceinline__ void issue_batch(int8_t* stage,
                                            const int8_t* __restrict__ qk,
                                            const int8_t* __restrict__ q,
                                            int b, int rows, int col0, int n,
                                            int vec) {
  for (int c = threadIdx.x; c < kBatchRows * (kTileN / 16); c += kFmaThreads) {
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

// The ring's step at batch b: wait for it, free the previous stage, start
// batch b + kStages - 1.  Returns batch b's stage.
__device__ __forceinline__ const int8_t* ring_step(
    int8_t* ring, const int8_t* __restrict__ qk, const int8_t* __restrict__ q,
    int b, int batches, int rows, int col0, int n, int vec) {
  cp_async_wait<kStages - 2>();  // this thread's copies of batch b
  __syncthreads();  // everyone's, and batch b - 1's stage is free
  const int nb = b + kStages - 1;
  if (nb < batches)
    issue_batch(ring + (nb % kStages) * kStageBytes, qk, q, nb, rows, col0, n,
                vec);
  else
    cp_async_commit();
  return ring + (b % kStages) * kStageBytes;
}

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

// x[r, k0 + c] for r < MT, c < bk (zero past mm rows and the split's
// `rows`) -> xs[c * MT + r]: 16-byte loads when a row's slice is aligned
// (K % 4 == 0), else one element a load
template <int MT>
__device__ __forceinline__ void stage_x_f32(const float* __restrict__ x,
                                            float* xs, int mm, int k, int k0,
                                            int rows, int bk, int xvec) {
  if (xvec) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      for (int c = threadIdx.x * 4; c < bk; c += kFmaThreads * 4) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < mm && c < rows)
          v = *reinterpret_cast<const float4*>(x + (size_t)r * k + k0 + c);
        xs[c * MT + r] = v.x;
        xs[(c + 1) * MT + r] = c + 1 < rows ? v.y : 0.f;
        xs[(c + 2) * MT + r] = c + 2 < rows ? v.z : 0.f;
        xs[(c + 3) * MT + r] = c + 3 < rows ? v.w : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < MT; ++r)
      for (int c = threadIdx.x; c < bk; c += kFmaThreads)
        xs[c * MT + r] = r < mm && c < rows ? x[(size_t)r * k + k0 + c] : 0.f;
  }
}

// Grid: (row groups of MT, column tiles, splits).
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
  const int r0 = blockIdx.x * MT;
  const int mm = min(MT, m - r0);
  const int k0 = blockIdx.z * bk;
  const int rows = min(k - k0, bk);
  const int batches = (rows + kBatchRows - 1) / kBatchRows;
  const int col0 = blockIdx.y * kTileN;
  const int8_t* qk = q + (size_t)k0 * n;
  const int cg = threadIdx.x % kColGroups;
  const int kl = threadIdx.x / kColGroups;

#pragma unroll
  for (int b = 0; b < kStages - 1; ++b) {
    if (b < batches)
      issue_batch(ring + b * kStageBytes, qk, q, b, rows, col0, n, vec);
    else
      cp_async_commit();
  }
  stage_x_f32<MT>(x + (size_t)r0 * k, xs, mm, k, k0, rows, bk, xvec);

  float acc[MT][kCols];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  for (int b = 0; b < batches; ++b) {
    const int8_t* st = ring_step(ring, qk, q, b, batches, rows, col0, n, vec);
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
  for (int i = threadIdx.x; i < mm * kTileN; i += kFmaThreads) {
    const int r = i / kTileN, col = i - r * kTileN;
    const int nn = col0 + col;
    if (nn >= n) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kFmaWarps; ++w) v += red[(w * MT + r) * kTileN + col];
    if (gridDim.z == 1)
      out[(size_t)(r0 + r) * n + nn] = v * s[nn];
    else
      ws[((size_t)blockIdx.z * m + r0 + r) * n + nn] = v;
  }
  if (gridDim.z > 1)
    finish_splits(out, ws, tickets, s, m, n, r0, r0 + mm, kTileN,
                  kFmaThreads);
}

// ---------------------------------------------------------------------------
// float32 x, kernel B: a plain tiled product
// ---------------------------------------------------------------------------

// Block (x rows r0 .. r0 + 63, columns c0 .. c0 + 63); thread (tr, tc)
// owns rows tr + 16 i and columns tc + 16 j, each summed along K in order.
__global__ void __launch_bounds__(kGemmThreads)
    quant_gemm_f32_kernel(const float* __restrict__ x,
                          const int8_t* __restrict__ q,
                          const float* __restrict__ s,
                          float* __restrict__ out, int m, int k, int n) {
  __shared__ float xs[kGemmK][kGemmTile + 1];
  __shared__ float cs[kGemmK][kGemmTile + 1];
  const int r0 = blockIdx.x * kGemmTile, c0 = blockIdx.y * kGemmTile;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kb = 0; kb < k; kb += kGemmK) {
    for (int i = threadIdx.x; i < kGemmTile * kGemmK; i += kGemmThreads) {
      const int r = i / kGemmK, kk = i % kGemmK;
      xs[kk][r] = r0 + r < m && kb + kk < k
                      ? x[(size_t)(r0 + r) * k + kb + kk]
                      : 0.f;
      const int kr = i / kGemmTile, cc = i % kGemmTile;
      cs[kr][cc] = kb + kr < k && c0 + cc < n
                       ? static_cast<float>(q[(size_t)(kb + kr) * n + c0 + cc])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[kk][tr + 16 * i];
        b[i] = cs[kk][tc + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + tr + 16 * i, c = c0 + tc + 16 * j;
      if (r < m && c < n) out[(size_t)r * n + c] = acc[i][j] * s[c];
    }
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

template <int BM, int G, int NW>
cudaError_t launch_wgmma_g(const void* x, const void* q, const void* s,
                           void* out, void* ws, void* tickets, int m, int k,
                           int n, int splits, int bk, int vec, int xvec,
                           cudaStream_t st) {
  static int allowed[kMaxDevices] = {0};
  auto kernel = quant_matmul_wgmma_kernel<BM, G, NW>;
  constexpr int smem = wg_smem_bytes(BM, NW);
  static_assert(smem <= kMaxSmem, "the ring exceeds shared memory");
  cudaError_t e = allow_smem(kernel, smem, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid((m + BM - 1) / BM, (n + wg_cols(NW) - 1) / wg_cols(NW),
                  splits);
  kernel<<<grid, kWgThreads * NW, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(tickets), m, k, n, bk, vec,
      xvec);
  return cudaGetLastError();
}

// products in groups of G steps (in the timing build, bit 2: the other
// grouping, 4 for 1 and 1 for 4)
template <int BM, int G, int NW>
cudaError_t launch_wgmma(const void* x, const void* q, const void* s,
                         void* out, void* ws, void* tickets, int m, int k,
                         int n, int splits, int bk, int vec, int xvec,
                         cudaStream_t st) {
#ifdef QMM_PROBE
  if (g_probe & 4)
    return launch_wgmma_g<BM, G == 1 ? 4 : 1, NW>(
        x, q, s, out, ws, tickets, m, k, n, splits, bk, vec, xvec, st);
#endif
  return launch_wgmma_g<BM, G, NW>(x, q, s, out, ws, tickets, m, k, n,
                                   splits, bk, vec, xvec, st);
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
  const dim3 grid((m + MT - 1) / MT, (n + kTileN - 1) / kTileN, splits);
  kernel<<<grid, kFmaThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<float*>(out),
      static_cast<float*>(ws), static_cast<int*>(tickets), m, k, n, bk, vec,
      xvec);
  return cudaGetLastError();
}

// the split plan's common checks: `splits` runs of `bk` rows (a multiple
// of 128; the last run may be short but not empty) cover K
bool bad_split(int k, int splits, int bk, void* ws, void* tickets) {
  return splits < 1 || splits > 65535 || bk < kBatchRows ||
         bk % kBatchRows != 0 || (long long)(splits - 1) * bk >= k ||
         (long long)splits * bk < k ||
         (splits > 1 && (ws == nullptr || tickets == nullptr));
}

}  // namespace

// Kernel A.  x [m, k] (dtype 0 = float32, 1 = bfloat16), q [k, n] int8,
// s [n] f32, out [m, n]; 1 <= m <= 64.  The grid splits K into `splits`
// runs of `bk` rows (a multiple of 128; at most 2048 for float32).  With
// splits > 1, ws holds at least splits * m * n f32 and tickets at least
// (row groups) * ceil(n / 128) int32 — one row group at bfloat16, one per
// 16 rows at float32 — zero before the first launch and left zero by
// every launch.  vec = 1 only when n % 16 == 0 and q is 16-byte aligned;
// xvec = 1 only when x is 16-byte aligned and k a multiple of 16 bytes of
// x.  Returns a cudaError_t as int.
extern "C" int quant_matmul_launch(const void* x, const void* q,
                                   const void* s, void* out, void* ws,
                                   void* tickets, int m, int k, int n,
                                   int splits, int bk, int vec, int xvec,
                                   int dtype, void* stream) {
  if (m < 1 || m > kMaxRowsA || k < 1 || n < 1 ||
      bad_split(k, splits, bk, ws, tickets) ||
      (dtype == 0 && bk > kMaxSplitRows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 1) {
    if (m <= 8)
      e = launch_wgmma<8, 4, 1>(x, q, s, out, ws, tickets, m, k, n,
                                splits, bk, vec, xvec, st);
    else if (m <= 16)
      e = launch_wgmma<16, 4, 1>(x, q, s, out, ws, tickets, m, k, n,
                                 splits, bk, vec, xvec, st);
    else if (m <= 32)
      e = launch_wgmma<32, 4, 1>(x, q, s, out, ws, tickets, m, k, n,
                                 splits, bk, vec, xvec, st);
    else
      e = launch_wgmma<64, 4, 1>(x, q, s, out, ws, tickets, m, k, n,
                                 splits, bk, vec, xvec, st);
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
      e = launch_fma<kGroupRows>(x, q, s, out, ws, tickets, m, k, n, splits,
                                 bk, vec, xvec, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// Kernel B.  x [m, k], q, s and out as kernel A's; any m >= 1.
// bfloat16: blocks of 128 rows x 256 columns (two warpgroups), K split as
// kernel A's (no cap on bk); tickets at least ceil(m / 128) * ceil(n /
// 256).  float32: one pass (splits must be 1; ws, tickets, vec and xvec
// are not read).  Returns a cudaError_t as int.
extern "C" int quant_gemm_launch(const void* x, const void* q, const void* s,
                                 void* out, void* ws, void* tickets, int m,
                                 int k, int n, int splits, int bk, int vec,
                                 int xvec, int dtype, void* stream) {
  if (m < 1 || k < 1 || n < 1 || bad_split(k, splits, bk, ws, tickets) ||
      (dtype == 0 && splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(launch_wgmma<kRowsB, 1, kWarpgroupsB>(
        x, q, s, out, ws, tickets, m, k, n, splits, bk, vec, xvec, st));
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kGemmTile - 1) / kGemmTile,
                  (n + kGemmTile - 1) / kGemmTile);
  quant_gemm_f32_kernel<<<grid, kGemmThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<float*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

#ifdef QMM_PROBE
// The timing build only: the variant bits (note at the head) for the
// launches that follow; synchronous.  Returns a cudaError_t as int.
extern "C" int quant_matmul_set_probe(int bits) {
  g_probe = bits;
  return static_cast<int>(cudaMemcpyToSymbol(kProbe, &bits, sizeof bits));
}
#endif
