// The 8-bit AdamW update of one tensor, in place, for Hopper (sm_90a).
//
// Replaces the XLA fusion that the JAX package gets for
// paddle_operator_tpu/train/opt8bit.py:169 `blocked_update` together with
// the optimizer chain around it (clip_by_global_norm before,
// add_decayed_weights and scale_by_learning_rate after): no Pallas kernel
// exists for it.  One launch updates one parameter tensor p [rows, n] f32
// with its grad g, and its two moments, each stored as int8 codes
// [rows, nb, 256] plus one f32 scale [rows, nb, 1] per block of 256 values
// along the last axis (nb = ceil(n / 256), rows zero-padded).  mu is
// signed absmax; nu is kept as sqrt(nu), unsigned absmax over [0, 254]
// with the codes offset by -127.
//
// What bounds it: bytes.  Per element it reads p and g (8 bytes) and one
// code of each moment, and writes p and both codes: 16 bytes, plus two
// scales read and written per 256 values.  About 30 flops an element
// against the card's ~295 flops a byte of balance: at 3.35 TB/s the whole
// 7b model's update (6.74e9 elements) cannot take less than ~32 ms.
//
// Design: one warp per quantization block, 8 values a lane, so the block
// absmax of the new mu and of sqrt(new nu) are two warp shuffles reductions
// and nothing leaves registers between the dequantize and the requantize.
// Loads are 16 bytes a lane for p and g and 8 bytes for the codes where
// the row length allows (n % 8 == 0 and aligned bases; `vec`), value by
// value otherwise.  The global norm is read from device memory, so the
// update never waits on the host.  No shared memory, no tensor cores:
// there is nothing to reuse.
//
// Rounding: every operation is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: nvcc never contracts
// them into FMAs) in the order of the plain version in ops/adam8bit.py,
// which is the JAX package's order, and codes round half to even
// (__float2int_rn), so the kernel equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;   // values a quantization block
constexpr int kWarps = 8;     // warps (quantization blocks) a thread block
constexpr int kPerLane = kBlock / 32;

struct Consts {
  float b1, omb1, b2, omb2, bc1, bc2, eps, wd, neg_lr, clip;
};

// max that propagates NaN, as torch.amax and jnp.max do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    adam8bit_kernel(float* __restrict__ p, const float* __restrict__ g,
                    int8_t* __restrict__ mc, float* __restrict__ ms,
                    int8_t* __restrict__ nc, float* __restrict__ ns,
                    const float* __restrict__ norm_ptr, long long rows,
                    int n, Consts k) {
  const int lane = threadIdx.x & 31;
  const int nb = (n + kBlock - 1) / kBlock;
  const long long qb =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (qb >= rows * nb) return;  // whole warps exit together
  const long long row = qb / nb;
  const int blk = (int)(qb - row * nb);
  const int first = blk * kBlock + lane * kPerLane;  // column of value 0
  const int valid = min(kBlock, n - blk * kBlock);   // columns in the row
  float* prow = p + row * (long long)n;
  const float* grow = g + row * (long long)n;
  const long long cbase = qb * kBlock + lane * kPerLane;

  const float norm = *norm_ptr;
  const bool keep = norm < k.clip;
  const float mscale = ms[qb];
  const float nscale = ns[qb];

  float pv[kPerLane], gv[kPerLane];
  int8_t mcv[kPerLane], ncv[kPerLane];
  {
    const int2 mraw = *reinterpret_cast<const int2*>(mc + cbase);
    const int2 nraw = *reinterpret_cast<const int2*>(nc + cbase);
    const int8_t* mb = reinterpret_cast<const int8_t*>(&mraw);
    const int8_t* nbv = reinterpret_cast<const int8_t*>(&nraw);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      mcv[j] = mb[j];
      ncv[j] = nbv[j];
    }
  }
  if (kVec) {
    // n % 8 == 0: a lane's 8 columns are all inside the row or all out
    if (lane * kPerLane < valid) {
      const float4* p4 = reinterpret_cast<const float4*>(prow + first);
      const float4* g4 = reinterpret_cast<const float4*>(grow + first);
      const float4 pa = p4[0], pb = p4[1], ga = g4[0], gb = g4[1];
      pv[0] = pa.x; pv[1] = pa.y; pv[2] = pa.z; pv[3] = pa.w;
      pv[4] = pb.x; pv[5] = pb.y; pv[6] = pb.z; pv[7] = pb.w;
      gv[0] = ga.x; gv[1] = ga.y; gv[2] = ga.z; gv[3] = ga.w;
      gv[4] = gb.x; gv[5] = gb.y; gv[6] = gb.z; gv[7] = gb.w;
    } else {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) pv[j] = gv[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const bool in = lane * kPerLane + j < valid;
      pv[j] = in ? prow[first + j] : 0.f;
      gv[j] = in ? grow[first + j] : 0.f;
    }
  }

  float mv[kPerLane], rv[kPerLane];
  float mmax = 0.f, rmax = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    // padding columns carry g = 0, as the plain version's zero padding
    const float gc =
        keep ? gv[j] : __fmul_rn(__fdiv_rn(gv[j], norm), k.clip);
    const float m = __fadd_rn(
        __fmul_rn(k.b1, __fmul_rn((float)mcv[j], mscale)),
        __fmul_rn(k.omb1, gc));
    const float root = __fmul_rn(__fadd_rn((float)ncv[j], 127.f), nscale);
    const float v = __fadd_rn(__fmul_rn(k.b2, __fmul_rn(root, root)),
                              __fmul_rn(k.omb2, __fmul_rn(gc, gc)));
    const float upd =
        __fdiv_rn(__fdiv_rn(m, k.bc1),
                  __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.bc2)), k.eps));
    const float u = __fadd_rn(upd, __fmul_rn(k.wd, pv[j]));
    pv[j] = __fadd_rn(pv[j], __fmul_rn(k.neg_lr, u));
    mv[j] = m;
    rv[j] = __fsqrt_rn(v);
    mmax = nan_max(mmax, fabsf(m));
    rmax = nan_max(rmax, rv[j]);
  }
  mmax = warp_max(mmax);
  rmax = warp_max(rmax);
  float msc = __fdiv_rn(mmax, 127.f);
  if (msc == 0.f) msc = 1.f;
  float nsc = __fdiv_rn(rmax, 254.f);
  if (nsc == 0.f) nsc = 1.f;

  int2 mout, nout;
  int8_t* mo = reinterpret_cast<int8_t*>(&mout);
  int8_t* no = reinterpret_cast<int8_t*>(&nout);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    mo[j] = (int8_t)__float2int_rn(__fdiv_rn(mv[j], msc));
    no[j] = (int8_t)(__float2int_rn(__fdiv_rn(rv[j], nsc)) - 127);
  }
  *reinterpret_cast<int2*>(mc + cbase) = mout;
  *reinterpret_cast<int2*>(nc + cbase) = nout;
  if (lane == 0) {
    ms[qb] = msc;
    ns[qb] = nsc;
  }
  if (kVec) {
    if (lane * kPerLane < valid) {
      float4* p4 = reinterpret_cast<float4*>(prow + first);
      p4[0] = make_float4(pv[0], pv[1], pv[2], pv[3]);
      p4[1] = make_float4(pv[4], pv[5], pv[6], pv[7]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (lane * kPerLane + j < valid) prow[first + j] = pv[j];
  }
}

}  // namespace

// p, g [rows, n] f32; mc, nc [rows, nb, 256] int8; ms, ns [rows, nb, 1]
// f32; norm a device f32 scalar.  vec: 16-byte loads (n % 8 == 0, p and g
// 16-byte aligned, codes 8-byte aligned; the wrapper decides).  Returns a
// cudaError_t (0 on success).
extern "C" int adam8bit_launch(void* p, const void* g, void* mc, void* ms,
                               void* nc, void* ns, const void* norm,
                               long long rows, int n, int vec, float b1,
                               float omb1, float b2, float omb2, float bc1,
                               float bc2, float eps, float wd, float neg_lr,
                               float clip, void* stream) {
  if (rows < 1 || n < 1 || (vec && n % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (n + kBlock - 1) / kBlock;
  const long long blocks = (rows * nb + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Consts k{b1, omb1, b2, omb2, bc1, bc2, eps, wd, neg_lr, clip};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<float*>(p);
  auto* gp = static_cast<const float*>(g);
  auto* mcp = static_cast<int8_t*>(mc);
  auto* msp = static_cast<float*>(ms);
  auto* ncp = static_cast<int8_t*>(nc);
  auto* nsp = static_cast<float*>(ns);
  auto* np_ = static_cast<const float*>(norm);
  if (vec)
    adam8bit_kernel<true><<<(unsigned)blocks, kWarps * 32, 0, st>>>(
        pp, gp, mcp, msp, ncp, nsp, np_, rows, n, k);
  else
    adam8bit_kernel<false><<<(unsigned)blocks, kWarps * 32, 0, st>>>(
        pp, gp, mcp, msp, ncp, nsp, np_, rows, n, k);
  return static_cast<int>(cudaGetLastError());
}
