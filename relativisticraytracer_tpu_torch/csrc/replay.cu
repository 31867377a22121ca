// Replay: re-integrate and shade only the recorded media segments, in three
// passes over a step list in device memory, and one per-ray kernel for the
// rays past the list's capacity.
//
// Replaces relativisticraytracer_tpu/ops/pallas_compact.py::media_replay
// (kernel body _replay_kernel -> _replay_step).
//
// What bounds it on an H100: arithmetic issue inside the media blocks. A
// cloud step evaluates ~15 value-noise lattices (8 hashes each) plus a
// 5-octave ridge stack, ~5,000 float ops; a disk step ~1,500 with cos/sin/
// exp/pow; a vacuum RK4 step ~250. The shading is ~92% of the operations.
// Only the rays that recorded media replay (about 3% of a 1080p frame at
// the headline pose, ~300 steps each), so one thread per ray fills less
// than a wave of the card, and the replay's time is then the serial chain
// of its longest rays' shaded steps, not its arithmetic.
//
// What the design does about it: the replay of a ray splits where its
// parallelism changes.
//   1. replay_march_kernel: one thread per recorded segment (slot) walks it
//      with the record kernel's RK4 (march_common.cuh, -fmad=false) and
//      writes each step's PRE-step rel and POST-step v to the step list as
//      16 bytes (rel, v.x) and 8 bytes (v.y, v.z). A segment's steps start
//      at its ray's offset (the exclusive prefix sum of the listed rays'
//      lengths) plus its earlier slots' lengths. A warp's 32 lanes march 32
//      segments, so a per-step store would scatter to 32 places; the steps
//      are staged in shared memory instead, and every 8 steps the warp
//      writes them out as runs of 8 consecutive steps of 4 segments per
//      store. The serial chain is the longest segment's vacuum steps.
//   2. shade_disk_kernel / shade_cloud_kernel: one thread per step, a grid
//      over the whole card. Each recomputes r2, the zones, the probes and h
//      from rel (pure functions of it: the same bits) and runs disk_block,
//      then, in a second launch over the cloud-probe steps, cloud_block, so
//      a step's emission is (0 + disk) + cloud as in a one-pass replay and
//      the two media do not diverge inside a warp. The pass that shades a
//      step last also computes its transmittance expf(-(op * h)). A step's
//      neighbours in the list are its ray's neighbouring steps, so a warp's
//      probes mostly agree.
//   3. replay_composite_kernel: one thread per listed ray walks its steps
//      in order and composites front to back (render/march.compose_step):
//      6 ops a step. It loads 8 steps ahead of the chain, so the chain
//      waits for memory once per 8 steps.
// Every step is composited, also the probe-False gap steps of a merged
// slot: their emission and opacity are exact zeros, so the transmittance
// is expf(-0) = 1, the factor (1 - 1) * T = 0 and I + 0 * 0 = I (as the
// one-pass replay's compose of a zone step with a False probe); the
// composite pads past a ray's end with such steps. Each ray's (I, T) is
// therefore bitwise the one-pass replay's. Indices are unique, so no
// atomics.
//
// No launch needs a count from the host. The wrapper builds the plan on
// the device (ops/pallas_compact.replay_plan): the list order, each ray's
// offset, and `counts` = (m listed rays, m_c rays whose steps fit the step
// list, S steps, S_c steps in the list). The step list is allocated at a
// capacity fixed on the host; the rays that fit are a prefix of the list,
// since offsets grow along it. Each grid is at most REPLAY_WAVES waves of
// resident blocks (launch.cuh), sized from the host's list length or
// capacity, and strides over the work the counts give, so a large capacity
// costs memory and no launch time.
//   4. replay_overflow_kernel: the rays past the capacity, one thread per
//      ray, march, shade and composite inline in the passes' operation
//      order. It runs every frame and exits at once when every ray fits, so
//      the frame is exact for every pose with no branch on the host.
#include <cuda_runtime.h>

#include "launch.cuh"
#include "march_common.cuh"

#define MARCH_BLOCK 128
// Waves of blocks a replay grid holds at most. Measured on an H100 over the
// default paths' frames (tools/replay_traffic.py): one wave leaves the
// shade passes' uneven steps unbalanced (the headline's replay 3.48 ms),
// one thread an item pays ~1 ms for the empty blocks of a large step list
// (4.30 ms), four waves 3.31 ms.
#define REPLAY_WAVES 4
#define STAGE 8  // steps staged per lane between two flushes

// rec: [slots, 7, n] planes; order: [rays] flat pixel indices; offsets:
// [rays] int64 exclusive prefix sums; pos: [capacity] (rel x, y, z, v.x);
// vel: [capacity] (v.y, v.z). Thread t replays slot t / m_c of listed ray
// t % m_c; a block strides over t in whole blocks, so every lane of a warp
// takes the same turns.
__global__ void __launch_bounds__(MARCH_BLOCK) replay_march_kernel(
    SceneConsts c, int n, int slots, const long long* __restrict__ counts,
    const float* __restrict__ rec, const int* __restrict__ order,
    const long long* __restrict__ offsets, float4* __restrict__ pos, float2* __restrict__ vel) {
    // one row of STAGE steps per lane, padded by one so that the lanes'
    // rows start in different banks
    __shared__ float4 stage_pos[MARCH_BLOCK / 32][32][STAGE + 1];
    __shared__ float2 stage_vel[MARCH_BLOCK / 32][32][STAGE + 1];
    const unsigned FULL = 0xffffffffu;
    const long long m = counts[1], segments = m * slots;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    for (long long t0 = (long long)blockIdx.x * blockDim.x; t0 < segments;
         t0 += (long long)gridDim.x * blockDim.x) {
        const long long t = t0 + threadIdx.x;
        // this lane's segment: none past the list's end or in an empty slot
        int len = 0;
        long long start = 0;
        V3 p = v3(0.0f, 0.0f, 0.0f), v = p;
        if (t < segments) {
            const int sl = (int)(t / m);
            const long long j = t - sl * m;
            const float* r = rec + order[j];
            len = (int)r[(size_t)(sl * 7 + 6) * n];
            start = offsets[j];
            for (int k = 0; k < sl; ++k) start += (long long)r[(size_t)(k * 7 + 6) * n];
            if (len > 0) {
                r += (size_t)(sl * 7) * n;
                p = v3(r[0], r[(size_t)n], r[(size_t)2 * n]);
                v = v3(r[(size_t)3 * n], r[(size_t)4 * n], r[(size_t)5 * n]);
            }
        }
        const int warp_len = __reduce_max_sync(FULL, len);
        for (int base = 0; base < warp_len; base += STAGE) {
            for (int i = 0; i < STAGE && base + i < len; ++i) {
                V3 rel = recenter(c, p);
                float r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z;
                bool zd, zc;
                media_zones(c, rel, r2, zd, zc);
                float h, h6;
                adaptive_h(c, r2, zd, zc, h, h6);
                rk4_step(c, p, v, h, h6);
                stage_pos[w][lane][i] = make_float4(rel.x, rel.y, rel.z, v.x);
                stage_vel[w][lane][i] = make_float2(v.y, v.z);
            }
            __syncwarp();
            // flush: each round writes 8 consecutive steps of 4 lanes' segments
            for (int g = 0; g < 8; ++g) {
                const int src = g * 4 + (lane >> 3), i = lane & 7;
                const int src_len = __shfl_sync(FULL, len, src);
                const long long src_start = __shfl_sync(FULL, start, src);
                if (base + i < src_len) {
                    pos[src_start + base + i] = stage_pos[w][src][i];
                    vel[src_start + base + i] = stage_vel[w][src][i];
                }
            }
            __syncwarp();
        }
    }
}

// The step's transmittance from its opacity: render/march.compose_step's
// d_tau = op * h, expf(-d_tau), with h from the PRE-step position.
__device__ __forceinline__ float step_trans(const SceneConsts& c, float op, float r2, bool zd,
                                            bool zc) {
    float h, h6;
    adaptive_h(c, r2, zd, zc, h, h6);
    float d_tau = op * h;
    return expf(-d_tau);
}

// emit: [capacity] (r, g, b, w). Every step in the list (s < S_c) is
// written: w is the step's transmittance, or its opacity so far where the
// cloud pass follows. Threads stride over the steps.
__global__ void __launch_bounds__(128) shade_disk_kernel(SceneConsts c, float time,
                                                         const long long* __restrict__ counts,
                                                         const float4* __restrict__ pos,
                                                         const float2* __restrict__ vel,
                                                         float4* __restrict__ emit) {
    const long long steps = counts[3], stride = (long long)gridDim.x * blockDim.x;
    for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < steps; s += stride) {
        const float4 a = pos[s];
        V3 rel = v3(a.x, a.y, a.z);
        float r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z;
        bool zd, zc, pd, pc;
        media_zones(c, rel, r2, zd, zc);
        media_probes(c, rel, zd, zc, pd, pc);
        float er = 0.0f, eg = 0.0f, eb = 0.0f, op = 0.0f;
        if (pd) {
            const float2 b = vel[s];
            disk_block(c, rel, r2, v3(a.w, b.x, b.y), zd, time, er, eg, eb, op);
        }
        emit[s] = make_float4(er, eg, eb, pc ? op : step_trans(c, op, r2, zd, zc));
    }
}

// Adds the cloud terms to the cloud-probe steps (after shade_disk_kernel)
// and turns their opacity into the transmittance.
__global__ void __launch_bounds__(128) shade_cloud_kernel(SceneConsts c, float time,
                                                          const long long* __restrict__ counts,
                                                          const float4* __restrict__ pos,
                                                          const float2* __restrict__ vel,
                                                          float4* __restrict__ emit) {
    const long long steps = counts[3], stride = (long long)gridDim.x * blockDim.x;
    for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < steps; s += stride) {
        const float4 a = pos[s];
        V3 rel = v3(a.x, a.y, a.z);
        float r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z;
        bool zd, zc, pd, pc;
        media_zones(c, rel, r2, zd, zc);
        media_probes(c, rel, zd, zc, pd, pc);
        if (!pc) continue;
        const float2 b = vel[s];
        float4 e = emit[s];
        cloud_block(c, rel, r2, v3(a.w, b.x, b.y), zc, time, e.x, e.y, e.z, e.w);
        e.w = step_trans(c, e.w, r2, zd, zc);
        emit[s] = e;
    }
}

#define COMPOSITE_AHEAD 8

// The steps of listed ray j < m_c are [offsets[j], offsets[j+1]) (the last
// ends at S_c); I and T go to its pixel. Threads stride over the rays.
__global__ void __launch_bounds__(128) replay_composite_kernel(
    int n, const long long* __restrict__ counts, const int* __restrict__ order,
    const long long* __restrict__ offsets, const float4* __restrict__ emit,
    float* __restrict__ intensity, float* __restrict__ trans) {
    const long long m = counts[1], stride = (long long)gridDim.x * blockDim.x;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < m; j += stride) {
        const size_t end = j + 1 < m ? (size_t)offsets[j + 1] : (size_t)counts[3];
        float ir = 0.0f, ig = 0.0f, ib = 0.0f, tr = 1.0f;
        for (size_t s = (size_t)offsets[j]; s < end; s += COMPOSITE_AHEAD) {
            float4 e[COMPOSITE_AHEAD];
#pragma unroll
            for (int i = 0; i < COMPOSITE_AHEAD; ++i)  // past the end: a no-op step
                e[i] = s + i < end ? emit[s + i] : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
#pragma unroll
            for (int i = 0; i < COMPOSITE_AHEAD; ++i) {  // render/march.compose_step
                float factor = (1.0f - e[i].w) * tr;
                ir = ir + e[i].x * factor;
                ig = ig + e[i].y * factor;
                ib = ib + e[i].z * factor;
                tr = tr * e[i].w;
            }
        }
        const int pix = order[j];
        intensity[pix] = ir;
        intensity[(size_t)n + pix] = ig;
        intensity[(size_t)2 * n + pix] = ib;
        trans[pix] = tr;
    }
}

// One ray past the step list's capacity, replayed inline.
__device__ __forceinline__ void overflow_ray(const SceneConsts& c, float time, int n, int slots,
                                             const float* __restrict__ rec, int pix,
                                             float* __restrict__ intensity,
                                             float* __restrict__ trans) {
    float ir = 0.0f, ig = 0.0f, ib = 0.0f, tr = 1.0f;
    for (int sl = 0; sl < slots; ++sl) {
        const float* r = rec + (size_t)(sl * 7) * n + pix;
        const int len = (int)r[(size_t)6 * n];
        if (len <= 0) continue;
        V3 p = v3(r[0], r[(size_t)n], r[(size_t)2 * n]);
        V3 v = v3(r[(size_t)3 * n], r[(size_t)4 * n], r[(size_t)5 * n]);
        for (int i = 0; i < len; ++i) {
            V3 rel = recenter(c, p);
            float r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z;
            bool zd, zc, pd, pc;
            media_zones(c, rel, r2, zd, zc);
            float h, h6;
            adaptive_h(c, r2, zd, zc, h, h6);
            rk4_step(c, p, v, h, h6);
            media_probes(c, rel, zd, zc, pd, pc);
            float er = 0.0f, eg = 0.0f, eb = 0.0f, op = 0.0f;
            if (pd) disk_block(c, rel, r2, v, zd, time, er, eg, eb, op);
            if (pc) cloud_block(c, rel, r2, v, zc, time, er, eg, eb, op);
            const float st = step_trans(c, op, r2, zd, zc);
            float factor = (1.0f - st) * tr;  // render/march.compose_step
            ir = ir + er * factor;
            ig = ig + eg * factor;
            ib = ib + eb * factor;
            tr = tr * st;
        }
    }
    intensity[pix] = ir;
    intensity[(size_t)n + pix] = ig;
    intensity[(size_t)2 * n + pix] = ib;
    trans[pix] = tr;
}

// Listed rays j in [m_c, m), the rays past the step list's capacity: each
// thread replays its ray's recorded segments one step at a time, as the
// passes do it — replay_march_kernel's step, shade_disk_kernel's (0 +
// disk), shade_cloud_kernel's + cloud and transmittance, then
// replay_composite_kernel's compose — so the ray's (I, T) is bitwise what
// the passes give it. Threads stride over the rays from m_c, so a frame
// whose rays all fit costs a grid of blocks that read the counts.
__global__ void __launch_bounds__(128) replay_overflow_kernel(
    SceneConsts c, float time, int n, int slots, const long long* __restrict__ counts,
    const float* __restrict__ rec, const int* __restrict__ order, float* __restrict__ intensity,
    float* __restrict__ trans) {
    const long long m = counts[0], stride = (long long)gridDim.x * blockDim.x;
    for (long long j = counts[1] + (long long)blockIdx.x * blockDim.x + threadIdx.x; j < m;
         j += stride)
        overflow_ray(c, time, n, slots, rec, order[j], intensity, trans);
}

static std::atomic<int> march_wave[RRT_MAX_DEVICES], disk_wave[RRT_MAX_DEVICES],
    cloud_wave[RRT_MAX_DEVICES], composite_wave[RRT_MAX_DEVICES],
    overflow_wave[RRT_MAX_DEVICES];

// n: pixels of the records; rays: entries of the list (order, offsets);
// capacity: entries of the step list. A launcher with no work launches
// nothing and returns RRT_NOT_LAUNCHED.
extern "C" int rrt_replay_march(const SceneConsts* c, int n, int rays, int slots,
                                const long long* counts, const float* rec, const int* order,
                                const long long* offsets, float4* pos, float2* vel,
                                void* stream) {
    const unsigned blocks =
        wave_blocks((long long)rays * slots, replay_march_kernel, MARCH_BLOCK, march_wave,
                    REPLAY_WAVES);
    if (!blocks) return RRT_NOT_LAUNCHED;
    replay_march_kernel<<<blocks, MARCH_BLOCK, 0, (cudaStream_t)stream>>>(
        *c, n, slots, counts, rec, order, offsets, pos, vel);
    return (int)cudaGetLastError();
}

// medium 0: disk (writes every step), 1: cloud (adds)
extern "C" int rrt_replay_shade(const SceneConsts* c, float time, int medium,
                                long long capacity, const long long* counts, const float4* pos,
                                const float2* vel, float4* emit, void* stream) {
    if (medium == 0) {
        const unsigned blocks =
            wave_blocks(capacity, shade_disk_kernel, 128, disk_wave, REPLAY_WAVES);
        if (!blocks) return RRT_NOT_LAUNCHED;
        shade_disk_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(*c, time, counts, pos, vel,
                                                                     emit);
    } else {
        const unsigned blocks =
            wave_blocks(capacity, shade_cloud_kernel, 128, cloud_wave, REPLAY_WAVES);
        if (!blocks) return RRT_NOT_LAUNCHED;
        shade_cloud_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(*c, time, counts, pos, vel,
                                                                      emit);
    }
    return (int)cudaGetLastError();
}

extern "C" int rrt_replay_composite(int n, int rays, const long long* counts, const int* order,
                                    const long long* offsets, const float4* emit,
                                    float* intensity, float* trans, void* stream) {
    const unsigned blocks = wave_blocks(rays, replay_composite_kernel, 128, composite_wave,
                                        REPLAY_WAVES);
    if (!blocks) return RRT_NOT_LAUNCHED;
    replay_composite_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(n, counts, order, offsets,
                                                                      emit, intensity, trans);
    return (int)cudaGetLastError();
}

extern "C" int rrt_replay_overflow(const SceneConsts* c, float time, int n, int rays, int slots,
                                   const long long* counts, const float* rec, const int* order,
                                   float* intensity, float* trans, void* stream) {
    const unsigned blocks = wave_blocks(rays, replay_overflow_kernel, 128, overflow_wave,
                                        REPLAY_WAVES);
    if (!blocks) return RRT_NOT_LAUNCHED;
    replay_overflow_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(*c, time, n, slots, counts,
                                                                     rec, order, intensity, trans);
    return (int)cudaGetLastError();
}
