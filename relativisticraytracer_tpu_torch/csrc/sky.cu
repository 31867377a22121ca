// Sky background: fetch each pixel's packed bilinear quads and filter them,
// four pixels a thread.
//
// Replaces relativisticraytracer_tpu/ops/pallas_sky.py::sky_window_gather
// (kernel body _window_kernel) together with the quad_bilinear epilogue of
// sky_background_windowed. It serves both frame programs: the compact
// frame (masked by the capture plane) and the inline frame (no mask:
// captured rays have T = 0 and a finite background).
//
// What bounds it on an H100: bytes. With chromatic aberration off (the
// default) a pixel reads 12 bytes of G-plane coordinates, a mask byte and a
// 16-byte q4 quad, and writes 12 bytes of colour: ~85 MB at 1080p, 0.025 ms
// at 3.35 TB/s. The q4 table (134 MB for 2048x4096) does not fit the 50 MB
// L2, but neighbouring escape directions hit neighbouring quads.
//
// What the design does about it. One thread a pixel issued two dependent
// loads (index, then quad) with one gather in flight a thread, in ~7.7
// waves of blocks, and ran at 0.26 of the byte bound. Here:
//   - a thread takes 4 consecutive pixels: one 16-byte load each of the
//     G-plane idx, fx and fy and one 4-byte load of the mask, and issues all
//     of its quad gathers before it filters any, so 4 misses are in flight a
//     thread (12 with chromatic aberration: 3 per-channel 4-byte gathers a
//     pixel, from the 9 coordinate planes);
//   - the one-touch planes are read and the output written with streaming
//     hints (__ldcs / __stcs), so the L2 keeps the quad table; the output
//     goes out as one float4 a channel;
//   - the grid is one wave of resident blocks, striding over the frame.
// The vector loads need n % 4 == 0 (the G plane starts at element n) and
// 16-byte aligned planes; otherwise the same kernel runs with scalar loads
// and stores, still 4 pixels a thread. The filter is corner_bilinear's f32
// op order with the float32(1/255) scale; there is no hardware texture
// filtering (fixed-point weights), so unmasked outputs are bitwise
// render/skybox.gather_sky_coords. Masked pixels skip the gather and get 0.
// TMA has no gather mode for a data-dependent 16-byte fetch, and there is
// no matrix work for the tensor cores here.
#include <cuda_runtime.h>
#include <cstdint>

#include "launch.cuh"

#define SKY_BLOCK 256
#define PIX 4  // pixels a thread

__device__ __forceinline__ float quad_bilinear(uint32_t t, float fx, float fy) {
    float c00 = (float)(t & 0xFFu);
    float c10 = (float)((t >> 8) & 0xFFu);
    float c01 = (float)((t >> 16) & 0xFFu);
    float c11 = (float)(t >> 24);
    float top = c00 + fx * (c10 - c00);
    float bot = c01 + fx * (c11 - c01);
    return (top + fy * (bot - top)) * 0x1.010102p-8f;  // float32(1/255)
}

// PIX elements of a one-touch plane from element i: one 16-byte load (VEC),
// or scalar loads of those below n.
template <bool VEC>
__device__ __forceinline__ void load_plane(const int* p, size_t i, size_t n, int o[PIX]) {
    if (VEC) {
        const int4 v = __ldcs(reinterpret_cast<const int4*>(p + i));
        o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
    } else {
#pragma unroll
        for (int k = 0; k < PIX; ++k) o[k] = i + k < n ? __ldcs(p + i + k) : 0;
    }
}

template <bool VEC>
__device__ __forceinline__ void load_plane(const float* p, size_t i, size_t n, float o[PIX]) {
    if (VEC) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(p + i));
        o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
    } else {
#pragma unroll
        for (int k = 0; k < PIX; ++k) o[k] = i + k < n ? __ldcs(p + i + k) : 0.0f;
    }
}

// skip[k]: pixel i + k is masked or past the end (no mask: only the end).
template <bool VEC>
__device__ __forceinline__ void load_skip(const uint8_t* masked, size_t i, size_t n,
                                          bool skip[PIX]) {
    if (VEC && masked) {
        const uchar4 v = __ldcs(reinterpret_cast<const uchar4*>(masked + i));
        skip[0] = v.x, skip[1] = v.y, skip[2] = v.z, skip[3] = v.w;
    } else {
#pragma unroll
        for (int k = 0; k < PIX; ++k)
            skip[k] = i + k >= n || (masked && __ldcs(masked + i + k));
    }
}

template <bool VEC>
__device__ __forceinline__ void store_plane(float* p, size_t i, size_t n, const float v[PIX]) {
    if (VEC) {
        __stcs(reinterpret_cast<float4*>(p + i), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
        for (int k = 0; k < PIX; ++k)
            if (i + k < n) __stcs(p + i + k, v[k]);
    }
}

// idx, fx, fy: [3, n] per-channel planes (r, g, b); masked: [n] or null;
// bg: [3, n]. Q4: one q4 row per pixel at the G index (all channels share
// the G coordinates); else one gather per channel from qr, qg, qb.
template <bool VEC, bool Q4>
__global__ void __launch_bounds__(SKY_BLOCK) sky_kernel(size_t n, const int* __restrict__ idx,
                                                        const float* __restrict__ fx,
                                                        const float* __restrict__ fy,
                                                        const uint8_t* __restrict__ masked,
                                                        const uint32_t* __restrict__ qr,
                                                        const uint32_t* __restrict__ qg,
                                                        const uint32_t* __restrict__ qb,
                                                        const uint4* __restrict__ q4,
                                                        float* __restrict__ bg) {
    const size_t groups = (n + PIX - 1) / PIX;
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    for (size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
        const size_t i = g * PIX;
        bool skip[PIX];
        load_skip<VEC>(masked, i, n, skip);
        float out[3][PIX];
        if (Q4) {
            int id[PIX];
            float gx[PIX], gy[PIX];
            load_plane<VEC>(idx + n, i, n, id);
            load_plane<VEC>(fx + n, i, n, gx);
            load_plane<VEC>(fy + n, i, n, gy);
            uint4 q[PIX];
#pragma unroll
            for (int k = 0; k < PIX; ++k)  // every gather before any filter
                q[k] = skip[k] ? make_uint4(0u, 0u, 0u, 0u) : __ldg(q4 + id[k]);
#pragma unroll
            for (int k = 0; k < PIX; ++k) {
                out[0][k] = skip[k] ? 0.0f : quad_bilinear(q[k].x, gx[k], gy[k]);
                out[1][k] = skip[k] ? 0.0f : quad_bilinear(q[k].y, gx[k], gy[k]);
                out[2][k] = skip[k] ? 0.0f : quad_bilinear(q[k].z, gx[k], gy[k]);
            }
        } else {
            const uint32_t* planes[3] = {qr, qg, qb};
            int id[3][PIX];
            float cx[3][PIX], cy[3][PIX];
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
                load_plane<VEC>(idx + ch * n, i, n, id[ch]);
                load_plane<VEC>(fx + ch * n, i, n, cx[ch]);
                load_plane<VEC>(fy + ch * n, i, n, cy[ch]);
            }
            uint32_t t[3][PIX];
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
#pragma unroll
                for (int k = 0; k < PIX; ++k)
                    t[ch][k] = skip[k] ? 0u : __ldg(planes[ch] + id[ch][k]);
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
#pragma unroll
                for (int k = 0; k < PIX; ++k)
                    out[ch][k] = skip[k] ? 0.0f : quad_bilinear(t[ch][k], cx[ch][k], cy[ch][k]);
        }
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) store_plane<VEC>(bg + ch * n, i, n, out[ch]);
    }
}

// one cache of the wave's size per kernel instance
template <bool VEC, bool Q4>
static std::atomic<int> sky_wave[RRT_MAX_DEVICES];

template <bool VEC, bool Q4>
static int launch_sky(size_t n, const int* idx, const float* fx, const float* fy,
                      const uint8_t* masked, const uint32_t* qr, const uint32_t* qg,
                      const uint32_t* qb, const uint4* q4, float* bg, cudaStream_t stream) {
    const unsigned blocks = wave_blocks((long long)((n + PIX - 1) / PIX), sky_kernel<VEC, Q4>,
                                        SKY_BLOCK, sky_wave<VEC, Q4>);
    sky_kernel<VEC, Q4><<<blocks, SKY_BLOCK, 0, stream>>>(n, idx, fx, fy, masked, qr, qg, qb,
                                                          q4, bg);
    return (int)cudaGetLastError();
}

static bool aligned(const void* p, uintptr_t bytes) {
    return p == nullptr || ((uintptr_t)p & (bytes - 1)) == 0;
}

// masked may be null (no mask); q4 is read only with use_q4.
extern "C" int rrt_sky(long long n, int use_q4, const int* idx, const float* fx, const float* fy,
                       const uint8_t* masked, const uint32_t* qr, const uint32_t* qg,
                       const uint32_t* qb, const void* q4, float* bg, void* stream) {
    if (n <= 0) return RRT_NOT_LAUNCHED;
    const bool vec = n % PIX == 0 && aligned(idx, 16) && aligned(fx, 16) && aligned(fy, 16) &&
                     aligned(bg, 16) && aligned(masked, 4);
    const uint4* q = (const uint4*)q4;
    cudaStream_t s = (cudaStream_t)stream;
    if (vec)
        return use_q4 ? launch_sky<true, true>(n, idx, fx, fy, masked, qr, qg, qb, q, bg, s)
                      : launch_sky<true, false>(n, idx, fx, fy, masked, qr, qg, qb, q, bg, s);
    return use_q4 ? launch_sky<false, true>(n, idx, fx, fy, masked, qr, qg, qb, q, bg, s)
                  : launch_sky<false, false>(n, idx, fx, fy, masked, qr, qg, qb, q, bg, s);
}
