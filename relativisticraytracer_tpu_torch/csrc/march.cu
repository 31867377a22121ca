// Fused inline march: the whole geodesic march with the disk and cloud
// shading inline, one thread per pixel, one warp per 8x4 pixel tile,
// behind three prologues/epilogues.
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
// plane kernel, 24 bytes of rays in. A ray's steps run from ~600 (an
// escape far from the hole) to the 2,000-step cap (the photon ring), and
// its steps are serial, so the second limit is how the work is spread
// over the SMs: a launch of a 270x960 shard is only about two waves of
// warps, and an SM that draws the photon-ring warps last runs them alone.
//
// What the design does about it:
// - each thread leaves its loop at its own capture or escape, so finished
//   rays cost nothing (the TPU kernel ran a tile until its last ray
//   finished); the shading runs only where the thread's own skip probe is
//   True (a False probe adds exact zeros, media/densities.py: the JAX
//   kernel's per-tile lax.cond in per-thread form);
// - the scene's has_spin and has_mass_pos are template parameters, and the
//   host launches the scene's instance: the four geodesic_acc and five
//   recenter calls of a step test neither at run time (a vacuum step went
//   from 428 to 295 SASS instructions, PERF.md);
// - one warp per 8x4 pixel tile, and blocks of one warp: the block
//   scheduler refills an SM a warp at a time, and no warp holds the
//   registers of finished ones (a 16x16 block held its eight warps' slots
//   until its slowest warp ended);
// - expensive tiles first: `order` lists the tiles whose straight-line
//   cost estimate (tile_keys_kernel: steps, plus the media probes' extra
//   work) is at least 1.5x the launch's cheapest, then the rest, each class
//   in row-major order (ops/cuda_lib.KernelLibrary.march_order). A short
//   launch then ends on cheap tiles; a long one keeps row-major order's
//   cheap last rows. A ray's pixel does not depend on which warp or when it
//   runs, so any order gives the same outputs.
// The trajectory is the record kernel's (the same march_common.cuh
// functions, built with -fmad=false), and zone steps with a False probe
// compose exact zeros, so a frame from this kernel equals the record +
// replay frame bitwise.
#include <cuda_runtime.h>

#include "march_common.cuh"

struct MarchResult {
    V3 v;                 // final velocity (pre-step at capture)
    float ir, ig, ib, tr; // accumulated emission and transmittance
    bool hit;             // captured by the horizon
};

// render/march.march for one ray: capture (T = 0), adaptive h, RK4, the
// media blocks under the ray's probes with front-to-back compositing,
// escape, up to max_steps. The scene's has_spin and has_mass_pos come in as
// compile-time constants (the host launches the matching instance), so the
// march_common.cuh functions fold their per-step tests of them away.
template <bool kSpin, bool kMassPos>
static __device__ MarchResult fused_march(const SceneConsts& scene, float time, int max_steps,
                                          V3 p, V3 v) {
    SceneConsts c = scene;
    c.has_spin = kSpin;
    c.has_mass_pos = kMassPos;
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
        float h, h6;
        adaptive_h(c, r2, zd, zc, h, h6);
        bool pd, pc;
        media_probes(c, rel, zd, zc, pd, pc);
        rk4_step(c, p, v, h, h6);  // rel keeps the PRE-step position
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

// ---------------------------------------------------------------- tiles
// A launch's pixels in TILE_W x TILE_H tiles, row-major (ops/cuda_lib.
// tile_map is the plain twin): lane l of tile t renders local pixel
// ((t % tiles_x) * TILE_W + l % TILE_W, (t / tiles_x) * TILE_H + l / TILE_W);
// lanes past the right or bottom edge idle, so every pixel is written once.
constexpr int TILE_W = 8, TILE_H = 4;

struct Tiles {
    int width, height, tiles_x, n;
};

static Tiles tiles_of(int width, int height) {
    int tiles_x = (width + TILE_W - 1) / TILE_W;
    return Tiles{width, height, tiles_x, tiles_x * ((height + TILE_H - 1) / TILE_H)};
}

__device__ __forceinline__ bool tile_pixel(const Tiles& t, int tile, int lane, int& x, int& y) {
    x = (tile % t.tiles_x) * TILE_W + lane % TILE_W;
    y = (tile / t.tiles_x) * TILE_H + lane / TILE_W;
    return x < t.width && y < t.height;
}

#ifdef RRT_TIMELINE
// Measurement build only (ops/cuda_lib.kernels(timeline=True)): each warp
// writes (SM, start ns, end ns) at its launch slot of the buffer set by
// rrt_set_timeline. The default build has none of this.
__device__ unsigned long long* rrt_timeline;

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

extern "C" int rrt_set_timeline(void* buf) {
    return (int)cudaMemcpyToSymbol(rrt_timeline, &buf, sizeof(buf));
}
#endif

// Runs body(x, y, pix) for this thread's pixel of tile order[slot], where
// the slot is this warp's place in the launch (blockIdx.x: one warp a
// block).
template <class Body>
__device__ __forceinline__ void for_tile_pixel(const Tiles& t, const int* order, Body body) {
    const int slot = blockIdx.x;
#ifdef RRT_TIMELINE
    const unsigned long long start = global_ns();
#endif
    int x, y;
    if (tile_pixel(t, order[slot], threadIdx.x, x, y))
        body(x, y, (size_t)y * t.width + x);
#ifdef RRT_TIMELINE
    __syncwarp();
    if (threadIdx.x == 0) {
        unsigned sm;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        unsigned long long* rec = rrt_timeline + 3 * (size_t)slot;
        rec[0] = sm;
        rec[1] = start;
        rec[2] = global_ns();
    }
#endif
}

// One warp a block. The register cap (at least 24 resident blocks an SM,
// 85 registers) leaves ptxas its own choice, 71-77 (28 or 24 warps an SM):
// a cap of 64 registers (32 warps) measured no faster (PERF.md).
#define MARCH_BOUNDS __launch_bounds__(32, 24)

template <bool kSpin, bool kMassPos>
__global__ void MARCH_BOUNDS march_camera_sky_kernel(
    SceneConsts c, CamScalars cam, RayGrid g, Tiles t, const int* __restrict__ order,
    int max_steps, int sky_h, int sky_w, float* __restrict__ intensity,
    float* __restrict__ trans, int* __restrict__ idx, float* __restrict__ fx,
    float* __restrict__ fy) {
    const size_t n = (size_t)t.width * t.height;
    for_tile_pixel(t, order, [&](int x, int y, size_t pix) {
        V3 p, v;
        gen_ray(cam, g, x, y, p, v);
        MarchResult r = fused_march<kSpin, kMassPos>(c, cam.s[0], max_steps, p, v);
        write_state(r, n, pix, intensity, trans, nullptr, nullptr);
        write_sky_coords(r.v, cam.s[15], sky_h, sky_w, n, pix, idx, fx, fy);
    });
}

template <bool kSpin, bool kMassPos>
__global__ void MARCH_BOUNDS march_camera_kernel(
    SceneConsts c, CamScalars cam, RayGrid g, Tiles t, const int* __restrict__ order,
    int max_steps, float* __restrict__ intensity, float* __restrict__ trans,
    float* __restrict__ hit, float* __restrict__ vel) {
    const size_t n = (size_t)t.width * t.height;
    for_tile_pixel(t, order, [&](int x, int y, size_t pix) {
        V3 p, v;
        gen_ray(cam, g, x, y, p, v);
        write_state(fused_march<kSpin, kMassPos>(c, cam.s[0], max_steps, p, v), n, pix,
                    intensity, trans, hit, vel);
    });
}

// rays: [6, height, width] planes (origin x, y, z, direction x, y, z)
template <bool kSpin, bool kMassPos>
__global__ void MARCH_BOUNDS march_planes_kernel(
    SceneConsts c, float time, Tiles t, const int* __restrict__ order, int max_steps,
    const float* __restrict__ rays, float* __restrict__ intensity, float* __restrict__ trans,
    float* __restrict__ hit, float* __restrict__ vel) {
    const size_t n = (size_t)t.width * t.height;
    for_tile_pixel(t, order, [&](int x, int y, size_t pix) {
        V3 p = v3(rays[pix], rays[n + pix], rays[2 * n + pix]);
        V3 v = v3(rays[3 * n + pix], rays[4 * n + pix], rays[5 * n + pix]);
        write_state(fused_march<kSpin, kMassPos>(c, time, max_steps, p, v), n, pix, intensity,
                    trans, hit, vel);
    });
}

// ---------------------------------------------------------------- order keys
// [t0, t1] clipped to [lo, hi]; its length (0 when empty).
__device__ __forceinline__ float clipped(float t0, float t1, float lo, float hi) {
    return fmaxf(fminf(t1, hi) - fmaxf(t0, lo), 0.0f);
}

// A ray's cost along the straight line from p in direction d, in vacuum
// steps, up to its capture (impact parameter under the photon orbit's) or
// its exit from the escape sphere: its length near the hole (r < 18) at
// h_near, in the disk zone's slab at h_disk, the rest at h_far, at most
// max_steps; plus, where the line crosses y = 0, the steps in the media
// probes' slabs, weighted by their extra work (a disk-probe step ~6 vacuum
// steps, a cloud-probe step ~21: chip_smoke.py's DISK_OPS and CLOUD_OPS
// over VAC_OPS). Only an order key: lensing bends the real paths.
__device__ int straight_line_cost(const SceneConsts& c, V3 p, V3 d, int max_steps) {
    float dd = dot3(d, d);
    if (!(dd > 0.0f)) return max_steps;
    V3 u = mul(d, 1.0f / sqrtf(dd));
    V3 rel = recenter(c, p);
    float tca = -dot3(rel, u);
    float b2 = fmaxf(dot3(rel, rel) - tca * tca, 0.0f);
    float bc2 = 6.75f * c.eh * c.eh;  // (3 sqrt(3) / 2 * eh)^2
    float t_end = b2 < bc2 ? tca : tca + sqrtf(fmaxf(c.escape_r2 - b2, 0.0f));
    t_end = fmaxf(t_end, 0.0f);
    // near the hole: the chord of r < 18
    float hn = sqrtf(fmaxf(324.0f - b2, 0.0f));
    float n0 = b2 < 324.0f ? tca - hn : 0.0f, n1 = b2 < 324.0f ? tca + hn : 0.0f;
    float l_near = clipped(n0, n1, 0.0f, t_end);
    // the disk zone: the slab |y| < disk_zone_y inside r^2 < disk_zone_r2
    float hz = sqrtf(fmaxf(c.disk_zone_r2 - b2, 0.0f));
    float z0 = b2 < c.disk_zone_r2 ? tca - hz : 0.0f, z1 = b2 < c.disk_zone_r2 ? tca + hz : 0.0f;
    bool slanted = fabsf(u.y) > 1e-6f;
    float s0, s1;
    if (slanted) {
        float a = (-c.disk_zone_y - rel.y) / u.y, b = (c.disk_zone_y - rel.y) / u.y;
        s0 = fminf(a, b);
        s1 = fmaxf(a, b);
    } else {
        s0 = fabsf(rel.y) < c.disk_zone_y ? -3.0e38f : 0.0f;
        s1 = fabsf(rel.y) < c.disk_zone_y ? 3.0e38f : 0.0f;
    }
    float d0 = fmaxf(z0, s0), d1 = fminf(z1, s1);
    float l_disk = clipped(d0, d1, 0.0f, t_end) - clipped(fmaxf(d0, n0), fminf(d1, n1), 0.0f, t_end);
    float l_far = fmaxf(t_end - l_near - l_disk, 0.0f);
    float est = l_far / c.h_far + l_disk / c.h_disk + l_near / c.h_near;
    est = est < (float)max_steps ? est : (float)max_steps;
    float tp = slanted ? -rel.y / u.y : -1.0f;
    if (tp > 0.0f && tp < t_end) {  // the media probes' slabs at the crossing
        float px = rel.x + tp * u.x, pz = rel.z + tp * u.z;
        float rc2 = fmaxf(px * px + pz * pz, 1e-6f);
        float per_unit = 2.0f / (fabsf(u.y) * (rc2 < 324.0f ? c.h_near : c.h_disk));
        if (c.enable_disk && rc2 >= c.disk_rlo2 && rc2 <= c.disk_rhi2)
            est = est + 6.0f * per_unit * fminf(sqrtf(sqrtf(c.disk_k2 / rc2)), c.disk_zone_y);
        if (c.enable_clouds && rc2 >= c.cloud_rlo2 && rc2 <= c.cloud_rhi2)
            est = est + 21.0f * per_unit * fminf(powf(c.cloud_k2 / rc2, 0.1f), c.cloud_zone_y);
    }
    return (int)fminf(est, 1.0e9f);
}

// keys[t] = the largest straight_line_cost over tile t's rays: from the
// camera (rays == nullptr) or from the [6, H, W] ray planes. One warp a
// tile, eight a block.
__global__ void __launch_bounds__(256) tile_keys_kernel(SceneConsts c, CamScalars cam, RayGrid g,
                                                         Tiles t, const float* __restrict__ rays,
                                                         int max_steps, int* __restrict__ keys) {
    const int tile = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    if (tile >= t.n) return;
    int x, y, est = 0;
    if (tile_pixel(t, tile, lane, x, y)) {
        V3 p, d;
        if (rays == nullptr) {
            gen_ray(cam, g, x, y, p, d);
        } else {
            const size_t n = (size_t)t.width * t.height, pix = (size_t)y * t.width + x;
            p = v3(rays[pix], rays[n + pix], rays[2 * n + pix]);
            d = v3(rays[3 * n + pix], rays[4 * n + pix], rays[5 * n + pix]);
        }
        est = straight_line_cost(c, p, d, max_steps);
    }
    est = __reduce_max_sync(0xffffffffu, est);
    if (lane == 0) keys[tile] = est;
}

// ---------------------------------------------------------------- entries
static RayGrid whole_image(int width, int height) {
    return RayGrid{0.0f, 0.0f, width, height, 0, 0, 0, 0};
}

template <bool kSpin, bool kMassPos>
struct Flags {
    static constexpr bool spin = kSpin, mass_pos = kMassPos;
};

// launch(Flags<has_spin, has_mass_pos>{}) for the scene's flags.
template <class Launch>
static void with_scene_flags(const SceneConsts& c, Launch launch) {
    if (c.has_spin) {
        if (c.has_mass_pos) launch(Flags<true, true>{});
        else launch(Flags<true, false>{});
    } else {
        if (c.has_mass_pos) launch(Flags<false, true>{});
        else launch(Flags<false, false>{});
    }
}

// `order` lists the tiles in launch order (a permutation of 0..tiles-1), one
// block (warp) a tile.

extern "C" int rrt_march_sky(const SceneConsts* c, const CamScalars* cam, int width, int height,
                             int max_steps, int sky_h, int sky_w, const int* order,
                             float* intensity, float* trans, int* idx, float* fx, float* fy,
                             void* stream) {
    Tiles t = tiles_of(width, height);
    with_scene_flags(*c, [&](auto f) {
        march_camera_sky_kernel<decltype(f)::spin, decltype(f)::mass_pos>
            <<<t.n, 32, 0, (cudaStream_t)stream>>>(
                *c, *cam, whole_image(width, height), t, order, max_steps, sky_h, sky_w,
                intensity, trans, idx, fx, fy);
    });
    return (int)cudaGetLastError();
}

extern "C" int rrt_march_camera(const SceneConsts* c, const CamScalars* cam, int width,
                                int height, int max_steps, const int* order, float* intensity,
                                float* trans, float* hit, float* vel, void* stream) {
    Tiles t = tiles_of(width, height);
    with_scene_flags(*c, [&](auto f) {
        march_camera_kernel<decltype(f)::spin, decltype(f)::mass_pos>
            <<<t.n, 32, 0, (cudaStream_t)stream>>>(
                *c, *cam, whole_image(width, height), t, order, max_steps, intensity, trans,
                hit, vel);
    });
    return (int)cudaGetLastError();
}

extern "C" int rrt_march_planes(const SceneConsts* c, float time, int width, int height,
                                int max_steps, const float* rays, const int* order,
                                float* intensity, float* trans, float* hit, float* vel,
                                void* stream) {
    Tiles t = tiles_of(width, height);
    with_scene_flags(*c, [&](auto f) {
        march_planes_kernel<decltype(f)::spin, decltype(f)::mass_pos>
            <<<t.n, 32, 0, (cudaStream_t)stream>>>(
                *c, time, t, order, max_steps, rays, intensity, trans, hit, vel);
    });
    return (int)cudaGetLastError();
}

// Tile keys of a camera launch (rays == null) or of ray planes; `keys`
// holds one int per tile (ops/cuda_lib.tile_count).
extern "C" int rrt_march_tile_keys(const SceneConsts* c, const CamScalars* cam, int width,
                                   int height, int max_steps, const float* rays, int* keys,
                                   void* stream) {
    Tiles t = tiles_of(width, height);
    CamScalars none{};
    tile_keys_kernel<<<(t.n + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
        *c, cam != nullptr ? *cam : none, whole_image(width, height), t, rays, max_steps, keys);
    return (int)cudaGetLastError();
}

// out = {registers a thread, local (spill) bytes a thread, resident blocks
// an SM at `threads` a block} of march kernel `which` (0 sky, 1 camera,
// 2 planes: the instance for the scene's flags; 3 tile keys) on the
// current device.
extern "C" int rrt_march_attrs(const SceneConsts* c, int which, int threads, int* out) {
    const void* fn = (const void*)tile_keys_kernel;
    with_scene_flags(*c, [&](auto f) {
        constexpr bool s = decltype(f)::spin, m = decltype(f)::mass_pos;
        if (which == 0) fn = (const void*)march_camera_sky_kernel<s, m>;
        if (which == 1) fn = (const void*)march_camera_kernel<s, m>;
        if (which == 2) fn = (const void*)march_planes_kernel<s, m>;
    });
    if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, threads, 0);
}
