// Two measurement probes: the card's per-op issue ceiling and the cost of a
// per-lane gather from a block-resident table.
//
// chain_kernel replaces tools/vpu_roofline.py::_chain (kernel body
// _chain_kernel). Each thread runs CHAINS independent accumulator chains of
// INNER ops per iteration, all in registers: fma (an explicit __fmaf_rn, as
// the library builds with -fmad=false), mul, mul_bf16 (__nv_bfloat16 by
// 1.0078125), rsqrt (rsqrtf + add) or exp (expf, as the march calls it).
// Element e of the (tiles * 8, 128) output starts from x[e % 1024], so every
// 8x128 tile repeats the TPU probe's single tile. What bounds it: the issue
// rate of the op's pipe and nothing else (no memory traffic inside the loop);
// the 16 chains give each warp enough independent instructions to cover the
// pipe latency, and the host launches enough blocks to fill every SM. The
// rate is taken from the difference between iters and 2 * iters, so launch
// and the prologue cancel (tools/roofline.measure_ceiling).
//
// take_along_kernel replaces tools/bench_sky_primitives.py::
// bench_take_along_axis_kernel (its kernel body is jnp.take_along_axis along
// the sublanes of a VMEM block). One block per tile i loads the (S, 128)
// table tile into shared memory and writes out[8i + r][c] =
// tab[S i + idx[8i + r][c]][c]: a per-lane gather across shared-memory rows,
// the H100 form of the question the sky gather asked on the TPU. What
// bounds it: bytes (the table once, the indices once, the output once).
// Each block reads its indices before its table tile, so both loads are in
// flight together. An index outside [0, S) reads no memory and yields NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#define CHAINS 16
#define INNER 32
#define TILE 1024  // one (8, 128) tile

// float32(1.0 + 0.001 * c), c = 0..15: the chains' starting factors, as the
// JAX probe folds them (a Python double rounded to float32 once).
__constant__ float kInit[CHAINS] = {
    0x1.000000p+0f, 0x1.00418ap+0f, 0x1.008312p+0f, 0x1.00c49cp+0f,
    0x1.010624p+0f, 0x1.0147aep+0f, 0x1.018938p+0f, 0x1.01cac0p+0f,
    0x1.020c4ap+0f, 0x1.024dd2p+0f, 0x1.028f5cp+0f, 0x1.02d0e6p+0f,
    0x1.03126ep+0f, 0x1.0353f8p+0f, 0x1.039582p+0f, 0x1.03d70ap+0f};

enum ChainOp { OP_FMA = 0, OP_MUL = 1, OP_MUL_BF16 = 2, OP_RSQRT = 3, OP_EXP = 4 };

template <int OP>
__device__ __forceinline__ float chain_step(float a, float b) {
    if (OP == OP_FMA) return __fmaf_rn(a, 0x1.000002p+0f, b);  // float32(1.0000001)
    if (OP == OP_MUL) return a * 0x1.000002p+0f;
    if (OP == OP_RSQRT) return rsqrtf(a) + b;
    return expf(a * -1e-7f);
}

template <int OP>
__global__ void __launch_bounds__(256) chain_kernel(int iters, int n, const float* __restrict__ x,
                                                    float* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float xv = x[i % TILE];
    float acc[CHAINS];
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) acc[c] = xv * kInit[c];
    float b = xv * 0.5f + 0.25f;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int c = 0; c < CHAINS; ++c) {
#pragma unroll
            for (int k = 0; k < INNER; ++k) acc[c] = chain_step<OP>(acc[c], b);
        }
    }
    float s = acc[0];
#pragma unroll
    for (int c = 1; c < CHAINS; ++c) s = s + acc[c];
    out[i] = s;
}

// mul_bf16: the chains, the factor and the sum in bfloat16, each op rounded
// to bfloat16 as the JAX probe's bf16 arrays round.
__global__ void __launch_bounds__(256) chain_bf16_kernel(int iters, int n,
                                                         const __nv_bfloat16* __restrict__ x,
                                                         float* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    __nv_bfloat16 xv = x[i % TILE];
    __nv_bfloat16 acc[CHAINS];
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) acc[c] = __hmul(xv, __float2bfloat16_rn(kInit[c]));
    const __nv_bfloat16 k = __float2bfloat16_rn(1.0078125f);
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int c = 0; c < CHAINS; ++c) {
#pragma unroll
            for (int j = 0; j < INNER; ++j) acc[c] = __hmul(acc[c], k);
        }
    }
    __nv_bfloat16 s = acc[0];
#pragma unroll
    for (int c = 1; c < CHAINS; ++c) s = __hadd(s, acc[c]);
    out[i] = __bfloat162float(s);
}

__global__ void __launch_bounds__(256) take_along_kernel(int s, const float* __restrict__ tab,
                                                         const int* __restrict__ idx,
                                                         float* __restrict__ out) {
    extern __shared__ float tile[];  // s x 128
    // the block's 1024 indices, 4 a thread, read before the table so that
    // both loads are in flight together
    const int* ix = idx + (size_t)blockIdx.x * TILE;
    unsigned row[TILE / 256];
#pragma unroll
    for (int j = 0; j < TILE / 256; ++j) row[j] = (unsigned)ix[threadIdx.x + 256 * j];
    const float* src = tab + (size_t)blockIdx.x * s * 128;
    for (int k = threadIdx.x; k < s * 128; k += 256) tile[k] = src[k];
    __syncthreads();
    float* o = out + (size_t)blockIdx.x * TILE;
#pragma unroll
    for (int j = 0; j < TILE / 256; ++j) {
        int k = threadIdx.x + 256 * j;
        o[k] = row[j] < (unsigned)s ? tile[row[j] * 128 + (k & 127)] : __int_as_float(0x7fc00000);
    }
}

extern "C" int rrt_chain(int op, int iters, int n, const void* x, float* out, void* stream) {
    int block = 256, grid = (n + block - 1) / block;
    cudaStream_t st = (cudaStream_t)stream;
    const float* xf = (const float*)x;
    switch (op) {
        case OP_FMA: chain_kernel<OP_FMA><<<grid, block, 0, st>>>(iters, n, xf, out); break;
        case OP_MUL: chain_kernel<OP_MUL><<<grid, block, 0, st>>>(iters, n, xf, out); break;
        case OP_MUL_BF16:
            chain_bf16_kernel<<<grid, block, 0, st>>>(iters, n, (const __nv_bfloat16*)x, out);
            break;
        case OP_RSQRT: chain_kernel<OP_RSQRT><<<grid, block, 0, st>>>(iters, n, xf, out); break;
        case OP_EXP: chain_kernel<OP_EXP><<<grid, block, 0, st>>>(iters, n, xf, out); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int rrt_take_along(int t, int s, const float* tab, const int* idx, float* out,
                              void* stream) {
    if (t > 0) {
        take_along_kernel<<<t, 256, (size_t)s * 128 * sizeof(float), (cudaStream_t)stream>>>(
            s, tab, idx, out);
    }
    return (int)cudaGetLastError();
}
