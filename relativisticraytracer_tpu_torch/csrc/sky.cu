// Sky background: fetch each pixel's packed bilinear quads and filter them,
// one thread per pixel.
//
// Replaces relativisticraytracer_tpu/ops/pallas_sky.py::sky_window_gather
// (kernel body _window_kernel) together with the quad_bilinear epilogue of
// sky_background_windowed.
//
// What bounds it on an H100: memory latency of one data-dependent load per
// pixel (16 bytes of the interleaved q4 table with chromatic aberration
// off, three 4-byte loads with it on) plus 13 bytes of coordinates and
// mask in and 12 bytes of color out. At 1080p that is ~85 MB of traffic
// against 3.35 TB/s; a 2048x4096 quad table is 134 MB (q4) and does not
// fit the 50 MB L2, but neighbouring escape directions hit neighbouring
// quads, so most loads are served by L2.
//
// What the design does about it: the TPU kernel's per-sub-tile window DMA,
// MXU one-hot gather and compacted row-gather fallback answered the TPU's
// slow gathers. A GPU gathers directly from L2/HBM, so this kernel does:
// captured (masked) pixels skip the load and write 0 (T = 0 erases them,
// pallas_sky.py:333-337), every other pixel reads its quad(s) and filters
// with corner_bilinear's exact op order in float32 (no hardware texture
// filtering, whose weights are fixed-point). Unmasked outputs are bitwise
// gather_sky_coords.
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ float quad_bilinear(uint32_t t, float fx, float fy) {
    float c00 = (float)(t & 0xFFu);
    float c10 = (float)((t >> 8) & 0xFFu);
    float c01 = (float)((t >> 16) & 0xFFu);
    float c11 = (float)(t >> 24);
    float top = c00 + fx * (c10 - c00);
    float bot = c01 + fx * (c11 - c01);
    return (top + fy * (bot - top)) * 0x1.010102p-8f;  // float32(1/255)
}

__global__ void __launch_bounds__(256) sky_kernel(int n, int use_q4,
                                                  const int* __restrict__ idx,
                                                  const float* __restrict__ fx,
                                                  const float* __restrict__ fy,
                                                  const uint8_t* __restrict__ masked,
                                                  const uint32_t* __restrict__ qr,
                                                  const uint32_t* __restrict__ qg,
                                                  const uint32_t* __restrict__ qb,
                                                  const uint4* __restrict__ q4,
                                                  float* __restrict__ bg) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float out[3] = {0.0f, 0.0f, 0.0f};
    if (!masked[i]) {
        if (use_q4) {  // all channels share the G coordinates
            uint4 q = q4[idx[(size_t)n + i]];
            float gx = fx[(size_t)n + i], gy = fy[(size_t)n + i];
            out[0] = quad_bilinear(q.x, gx, gy);
            out[1] = quad_bilinear(q.y, gx, gy);
            out[2] = quad_bilinear(q.z, gx, gy);
        } else {
            const uint32_t* planes[3] = {qr, qg, qb};
            for (int ch = 0; ch < 3; ++ch) {
                size_t o = (size_t)ch * n + i;
                out[ch] = quad_bilinear(planes[ch][idx[o]], fx[o], fy[o]);
            }
        }
    }
    bg[i] = out[0];
    bg[(size_t)n + i] = out[1];
    bg[(size_t)2 * n + i] = out[2];
}

extern "C" int rrt_sky(int n, int use_q4, const int* idx, const float* fx, const float* fy,
                       const uint8_t* masked, const uint32_t* qr, const uint32_t* qg,
                       const uint32_t* qb, const void* q4, float* bg, void* stream) {
    if (n > 0) {
        int block = 256;
        sky_kernel<<<(n + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
            n, use_q4, idx, fx, fy, masked, qr, qg, qb, (const uint4*)q4, bg);
    }
    return (int)cudaGetLastError();
}
