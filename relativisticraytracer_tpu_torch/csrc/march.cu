// Fused inline march: the whole geodesic march with the disk and cloud
// shading inline, one thread per pixel, behind three prologues/epilogues.
//
// Replaces the three Pallas kernels of relativisticraytracer_tpu/ops/
// pallas_march.py, which share one loop (_march_tile_loop ->
// render/march.march_step(media_cond=True)):
//   march_camera_sky_kernel  <- march_pallas_camera_sky (_march_camera_sky_kernel):
//       in-kernel ray gen; (I, T) and the sky coordinates of the final
//       direction (media_pass="inline" frames, and frames with no medium);
//   march_camera_kernel      <- march_pallas_camera (_march_camera_kernel):
//       in-kernel ray gen; (I, T, hit, v) (frames with no sky);
//   march_planes_kernel      <- march_pallas (_march_tile_kernel):
//       rays read from (H, W) planes; (I, T, hit, v) (the non-compact
//       branch of the spatial-shard renderer).
//
// What bounds it on an H100: fp32 issue. At the 1080p headline pose a ray
// takes ~1,011 steps on average, ~2.1e9 ray-steps per frame, each one RK4
// step (four geodesic_acc evaluations) plus the zone/probe tests. Memory
// traffic is the output planes once (32-52 bytes a pixel) and, for the
// plane kernel, 24 bytes of rays in. The second limit is warp divergence:
// 2.3% of ray-steps are zone steps, and a warp waits while one of its
// threads runs the cloud block (~3,000 ops of value noise) or the disk
// block (~1,000 with cos/sin/exp/pow).
//
// What the design does about it: each thread leaves its loop at its own
// capture or escape, so finished rays cost nothing (the TPU kernel ran a
// tile until its last ray finished). The shading runs only where the
// thread's own skip probe is True; a False probe adds exact zeros (media/
// densities.py), so this is the JAX kernel's per-tile lax.cond in
// per-thread form. 16x16 blocks keep a warp on a compact pixel patch whose
// rays terminate at similar steps. The trajectory is the record kernel's
// (the same march_common.cuh functions, built with -fmad=false), and zone
// steps with a False probe compose exact zeros, so a frame from this kernel
// equals the record + replay frame bitwise.
#include <cuda_runtime.h>

#include "march_common.cuh"

struct MarchResult {
    V3 v;                 // final velocity (pre-step at capture)
    float ir, ig, ib, tr; // accumulated emission and transmittance
    bool hit;             // captured by the horizon
};

// render/march.march for one ray: capture (T = 0), adaptive h, RK4, the
// media blocks under the ray's probes with front-to-back compositing,
// escape, up to max_steps.
static __device__ MarchResult fused_march(const SceneConsts& c, float time, int max_steps, V3 p,
                                          V3 v) {
    MarchResult out{v, 0.0f, 0.0f, 0.0f, 1.0f, false};
    for (int i = 0; i < max_steps; ++i) {
        V3 rel = recenter(c, p);
        float r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z;
        if (r2 < c.capture_r2) {  // horizon capture: pre-step velocity kept
            out.hit = true;
            out.tr = 0.0f;
            break;
        }
        bool zd, zc;
        media_zones(c, rel, r2, zd, zc);
        float h = adaptive_h(c, r2, zd, zc);
        bool pd, pc;
        media_probes(c, rel, zd, zc, pd, pc);
        rk4_step(c, p, v, h);  // rel keeps the PRE-step position
        if (pd || pc) {        // a probe implies its zone: render/march.compose_step
            float er = 0.0f, eg = 0.0f, eb = 0.0f, op = 0.0f;
            if (pd) disk_block(c, rel, r2, v, zd, time, er, eg, eb, op);
            if (pc) cloud_block(c, rel, r2, v, zc, time, er, eg, eb, op);
            float d_tau = op * h;
            float step_trans = expf(-d_tau);
            float factor = (1.0f - step_trans) * out.tr;
            out.ir = out.ir + er * factor;
            out.ig = out.ig + eg * factor;
            out.ib = out.ib + eb * factor;
            out.tr = out.tr * step_trans;
        }
        if ((r2 > c.escape_r2) && (rel.x * v.x + rel.y * v.y + rel.z * v.z > 0.0f)) break;
    }
    out.v = v;
    return out;
}

__device__ __forceinline__ void write_state(const MarchResult& r, size_t n, size_t pix,
                                            float* intensity, float* trans, float* hit,
                                            float* vel) {
    intensity[pix] = r.ir;
    intensity[n + pix] = r.ig;
    intensity[2 * n + pix] = r.ib;
    trans[pix] = r.tr;
    if (hit != nullptr) {
        hit[pix] = r.hit ? 1.0f : 0.0f;
        vel[pix] = r.v.x;
        vel[n + pix] = r.v.y;
        vel[2 * n + pix] = r.v.z;
    }
}

__global__ void __launch_bounds__(256) march_camera_sky_kernel(
    SceneConsts c, CamScalars cam, RayGrid g, int width, int height, int max_steps, int sky_h,
    int sky_w, float* __restrict__ intensity, float* __restrict__ trans, int* __restrict__ idx,
    float* __restrict__ fx, float* __restrict__ fy) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= width || y >= height) return;
    const size_t n = (size_t)width * height, pix = (size_t)y * width + x;
    V3 p, v;
    gen_ray(cam, g, x, y, p, v);
    MarchResult r = fused_march(c, cam.s[0], max_steps, p, v);
    write_state(r, n, pix, intensity, trans, nullptr, nullptr);
    write_sky_coords(r.v, cam.s[15], sky_h, sky_w, n, pix, idx, fx, fy);
}

__global__ void __launch_bounds__(256) march_camera_kernel(
    SceneConsts c, CamScalars cam, RayGrid g, int width, int height, int max_steps,
    float* __restrict__ intensity, float* __restrict__ trans, float* __restrict__ hit,
    float* __restrict__ vel) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= width || y >= height) return;
    const size_t n = (size_t)width * height, pix = (size_t)y * width + x;
    V3 p, v;
    gen_ray(cam, g, x, y, p, v);
    write_state(fused_march(c, cam.s[0], max_steps, p, v), n, pix, intensity, trans, hit, vel);
}

// rays: [6, height, width] planes (origin x, y, z, direction x, y, z)
__global__ void __launch_bounds__(256) march_planes_kernel(
    SceneConsts c, float time, int width, int height, int max_steps,
    const float* __restrict__ rays, float* __restrict__ intensity, float* __restrict__ trans,
    float* __restrict__ hit, float* __restrict__ vel) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= width || y >= height) return;
    const size_t n = (size_t)width * height, pix = (size_t)y * width + x;
    V3 p = v3(rays[pix], rays[n + pix], rays[2 * n + pix]);
    V3 v = v3(rays[3 * n + pix], rays[4 * n + pix], rays[5 * n + pix]);
    write_state(fused_march(c, time, max_steps, p, v), n, pix, intensity, trans, hit, vel);
}

static RayGrid whole_image(int width, int height) {
    return RayGrid{0.0f, 0.0f, width, height, 0, 0, 0, 0};
}

extern "C" int rrt_march_sky(const SceneConsts* c, const CamScalars* cam, int width, int height,
                             int max_steps, int sky_h, int sky_w, float* intensity,
                             float* trans, int* idx, float* fx, float* fy, void* stream) {
    dim3 block(16, 16);
    dim3 grid((width + 15) / 16, (height + 15) / 16);
    march_camera_sky_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        *c, *cam, whole_image(width, height), width, height, max_steps, sky_h, sky_w,
        intensity, trans, idx, fx, fy);
    return (int)cudaGetLastError();
}

extern "C" int rrt_march_camera(const SceneConsts* c, const CamScalars* cam, int width,
                                int height, int max_steps, float* intensity, float* trans,
                                float* hit, float* vel, void* stream) {
    dim3 block(16, 16);
    dim3 grid((width + 15) / 16, (height + 15) / 16);
    march_camera_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        *c, *cam, whole_image(width, height), width, height, max_steps, intensity, trans, hit,
        vel);
    return (int)cudaGetLastError();
}

extern "C" int rrt_march_planes(const SceneConsts* c, float time, int width, int height,
                                int max_steps, const float* rays, float* intensity,
                                float* trans, float* hit, float* vel, void* stream) {
    dim3 block(16, 16);
    dim3 grid((width + 15) / 16, (height + 15) / 16);
    march_planes_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        *c, time, width, height, max_steps, rays, intensity, trans, hit, vel);
    return (int)cudaGetLastError();
}
