// Record pass: ray generation + vacuum march + media-segment recording +
// sky addressing, one thread per pixel.
//
// Replaces relativisticraytracer_tpu/ops/pallas_compact.py::
// march_pallas_camera_sky_record (kernel body _record_camera_sky_kernel ->
// _record_march_loop; ray gen pallas_march._gen_tile_rays).
//
// What bounds it on an H100: arithmetic issue. Each step is one RK4 step
// (four geodesic_acc evaluations, ~250 float ops with one rsqrt each) plus
// ~20 ops of zone/probe/record bookkeeping; memory traffic is one write of
// 11 + 7*slots planes per pixel at the end (~256 MB at 1080p, under 0.1 ms
// of HBM time). The second limit is divergence: a warp runs until its
// slowest ray is captured or escapes (up to max_steps near the photon ring).
//
// What the design does about it: the TPU kernel's structure (lane tiles,
// f32 mask planes carried through a while loop, per-40-step commit conds)
// answered the cost of vector conds on a TPU; here each thread runs its own
// loop and leaves it at its own termination, so finished rays cost nothing.
// 16x16 blocks (as the reference CUDA renderer launched) keep a warp on a
// compact 16x2 pixel patch, whose rays terminate at similar steps.
// Segments are recorded per step with exact boundaries (the JAX kernel
// merges gaps inside each 40-step block, which replays to the same (I, T):
// gap steps contribute exact zeros). Slot-overflow merging and the
// end-of-loop flush `len = i - entry` are kept. The per-pixel total length
// feeds the replay's compaction. A shard of a spatially tiled frame passes
// its origin and strip maps in the RayGrid (march_common.cuh::gen_ray).
#include <cuda_runtime.h>

#include "march_common.cuh"

__global__ void __launch_bounds__(256) record_kernel(
    SceneConsts c, CamScalars cam, RayGrid g, int width, int height, int max_steps, int slots,
    int sky_h, int sky_w, float* __restrict__ hit_out, int* __restrict__ idx_out,
    float* __restrict__ fx_out, float* __restrict__ fy_out, float* __restrict__ rec,
    float* __restrict__ total_out) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= width || y >= height) return;
    const int n = width * height;
    const int pix = y * width + x;

    V3 p, v;
    gen_ray(cam, g, x, y, p, v);

    for (int j = 0; j < slots * 7; ++j) rec[(size_t)j * n + pix] = 0.0f;

    // ---- vacuum march with per-step segment recording
    bool hit = false, in_seg = false;
    int k = 0, entry = 0, i = 0;
    for (; i < max_steps; ++i) {
        V3 rel = recenter(c, p);
        float r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z;
        if (r2 < c.capture_r2) {  // horizon capture: pre-step velocity kept
            hit = true;
            break;  // the probe is False on this step: flushed below
        }
        bool zd, zc;
        media_zones(c, rel, r2, zd, zc);
        float h = adaptive_h(c, r2, zd, zc);
        V3 pn = p, vn = v;
        rk4_step(c, pn, vn, h);
        bool pd, pc;
        media_probes(c, rel, zd, zc, pd, pc);
        bool probe = pd || pc;
        if (probe && !in_seg) {  // a segment starts: PRE-step state
            if (k < slots) {
                float* r = rec + (size_t)(k * 7) * n + pix;
                r[0] = p.x;
                r[(size_t)n] = p.y;
                r[(size_t)2 * n] = p.z;
                r[(size_t)3 * n] = v.x;
                r[(size_t)4 * n] = v.y;
                r[(size_t)5 * n] = v.z;
                entry = i;
            }  // else: merges into the last slot (entry unchanged)
            ++k;
        } else if (!probe && in_seg) {  // a segment ends: flush its length
            int sl = min(k, slots) - 1;
            rec[(size_t)(sl * 7 + 6) * n + pix] = (float)(i - entry);
        }
        in_seg = probe;
        bool escaped = (r2 > c.escape_r2) && (rel.x * vn.x + rel.y * vn.y + rel.z * vn.z > 0.0f);
        p = pn;
        v = vn;
        if (escaped) {
            ++i;
            break;
        }
    }
    if (in_seg) {  // still open at loop exit: the last probing step was i-1
        int sl = min(k, slots) - 1;
        rec[(size_t)(sl * 7 + 6) * n + pix] = (float)(i - entry);
    }
    float total = 0.0f;
    for (int sl = 0; sl < slots; ++sl) total = total + rec[(size_t)(sl * 7 + 6) * n + pix];
    total_out[pix] = total;
    hit_out[pix] = hit ? 1.0f : 0.0f;

    // ---- sky addressing of the normalized final direction
    write_sky_coords(v, cam.s[15], sky_h, sky_w, (size_t)n, (size_t)pix, idx_out, fx_out, fy_out);
}

extern "C" int rrt_scene_consts_size() { return (int)sizeof(SceneConsts); }

extern "C" int rrt_ray_grid_size() { return (int)sizeof(RayGrid); }

extern "C" int rrt_record(const SceneConsts* c, const CamScalars* cam, const RayGrid* g,
                          int width, int height, int max_steps, int slots, int sky_h, int sky_w,
                          float* hit, int* idx, float* fx, float* fy, float* rec, float* total,
                          void* stream) {
    dim3 block(16, 16);
    dim3 grid((width + 15) / 16, (height + 15) / 16);
    record_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*c, *cam, *g, width, height,
                                                            max_steps, slots, sky_h, sky_w, hit,
                                                            idx, fx, fy, rec, total);
    return (int)cudaGetLastError();
}
