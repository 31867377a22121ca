// Replay: re-integrate and shade only the recorded media segments, in three
// passes over a step list in device memory, run in rounds over the list,
// and one per-ray kernel for the rays the rounds do not take.
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
// the device (ops/pallas_compact.replay_plan): the list order and each
// ray's offset, then replay_rounds_kernel (one block) splits the list into
// rounds. The step list has a capacity fixed on the host (at most 2^27
// entries, 5.4 GB, whatever the frame's size), and a dense frame needs
// several lists of steps (up to 6.2 on the default camera paths at 1080p).
// Round k takes the next rays whose steps end within its base (its first
// ray's offset) plus the capacity; rays are never split, so each pixel is
// composited once and no (I, T) carries from one round to the next. Each
// round runs the three passes over the same list, its kernels indexing the
// list at a ray's offset less the base; a round with no rays costs four
// launches whose blocks read its row and exit. Each grid is at most a
// host-given number of waves of resident blocks (launch.cuh), sized from
// the host's list length or capacity, and strides over the work its row
// gives, so a large capacity costs memory and no launch time.
//   4. replay_overflow_kernel: the rays the rounds do not take (those
//      longer than the list, a prefix of it at forced small capacities, and
//      those past the last round), one thread per ray, march, shade and
//      composite inline in the passes' operation order. It runs every frame
//      and exits at once when the rounds take every ray, so the frame is
//      exact for every pose with no branch on the host.
#include <cuda_runtime.h>

#include "launch.cuh"
#include "march_common.cuh"

#define MARCH_BLOCK 128
#define STAGE 8  // steps staged per lane between two flushes
#define ROUNDS_BLOCK 1024

// The first index in [lo, hi) where `pred` fails (hi if it holds on all),
// for a `pred` that holds and then fails along [lo, hi). The whole block
// searches: each turn its threads probe evenly spaced indices and count the
// probes that hold, so the range shrinks blockDim.x-fold a turn (three
// turns for 2^30 entries). Every thread returns the same index.
template <typename Pred>
__device__ long long block_partition_point(long long lo, long long hi, Pred pred) {
    while (lo < hi) {
        const long long step = (hi - lo + blockDim.x - 1) / blockDim.x;
        const long long q = lo + (long long)threadIdx.x * step;
        const long long yes = __syncthreads_count(q < hi && pred(q));
        // probes 0 .. yes - 1 hold: the point is past the last of them and
        // at or before the first that fails
        const long long next_hi = lo + yes * step < hi ? lo + yes * step : hi;
        lo = yes ? lo + (yes - 1) * step + 1 : lo;
        hi = next_hi;
    }
    return lo;
}

// One block: the replay's round table (its plain twin is
// ops/pallas_compact._replay_rounds_plain). csum: [rays + 1], 0 and then
// the end of each listed ray's steps along the list; listed: m; cap: the
// step list's entries. The rays longer than the list come first (longest
// first); from there round k starts at the first ray no earlier round took,
// its base that ray's offset, and takes the rays whose steps end within
// base + cap. Writes table [rounds, 4] (first listed ray, rays, base,
// steps) and counts (m, rays in the rounds, S, steps in the rounds).
__global__ void __launch_bounds__(ROUNDS_BLOCK) replay_rounds_kernel(
    const long long* __restrict__ csum, const long long* __restrict__ listed, long long cap,
    int rounds, long long* __restrict__ table, long long* __restrict__ counts) {
    const long long m = *listed;
    long long j = block_partition_point(0, m, [&](long long i) { return csum[i + 1] - csum[i] > cap; });
    long long rays = 0, steps = 0;
    for (int k = 0; k < rounds; ++k) {
        const long long base = csum[j], limit = base + cap;
        const long long next =
            block_partition_point(j, m, [&](long long i) { return csum[i + 1] <= limit; });
        const long long s = csum[next] - base;
        if (threadIdx.x == 0) {
            long long* row = table + 4 * k;
            row[0] = j;
            row[1] = next - j;
            row[2] = base;
            row[3] = s;
        }
        rays += next - j;
        steps += s;
        j = next;
    }
    if (threadIdx.x == 0) {
        counts[0] = m;
        counts[1] = rays;
        counts[2] = csum[m];
        counts[3] = steps;
    }
}

// rec: [slots, 7, n] planes; order: [rays] flat pixel indices; offsets:
// [rays] int64 exclusive prefix sums; row: the round's (first listed ray,
// rays m, base, steps); pos: [capacity] (rel x, y, z, v.x); vel: [capacity]
// (v.y, v.z). Thread t replays slot t / m of the round's ray t % m into the
// list from its offset less the base; a block strides over t in whole
// blocks, so every lane of a warp takes the same turns.
__global__ void __launch_bounds__(MARCH_BLOCK) replay_march_kernel(
    SceneConsts c, int n, int slots, const long long* __restrict__ row,
    const float* __restrict__ rec, const int* __restrict__ order,
    const long long* __restrict__ offsets, float4* __restrict__ pos, float2* __restrict__ vel) {
    // one row of STAGE steps per lane, padded by one so that the lanes'
    // rows start in different banks
    __shared__ float4 stage_pos[MARCH_BLOCK / 32][32][STAGE + 1];
    __shared__ float2 stage_vel[MARCH_BLOCK / 32][32][STAGE + 1];
    const unsigned FULL = 0xffffffffu;
    const long long first = row[0], m = row[1], list_base = row[2], segments = m * slots;
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
            const long long j = first + (t - sl * m);
            const float* r = rec + order[j];
            len = (int)r[(size_t)(sl * 7 + 6) * n];
            start = offsets[j] - list_base;
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

// emit: [capacity] (r, g, b, w). Every step of the round (s < row[3]) is
// written: w is the step's transmittance, or its opacity so far where the
// cloud pass follows. Threads stride over the steps.
__global__ void __launch_bounds__(128) shade_disk_kernel(SceneConsts c, float time,
                                                         const long long* __restrict__ row,
                                                         const float4* __restrict__ pos,
                                                         const float2* __restrict__ vel,
                                                         float4* __restrict__ emit) {
    const long long steps = row[3], stride = (long long)gridDim.x * blockDim.x;
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
                                                          const long long* __restrict__ row,
                                                          const float4* __restrict__ pos,
                                                          const float2* __restrict__ vel,
                                                          float4* __restrict__ emit) {
    const long long steps = row[3], stride = (long long)gridDim.x * blockDim.x;
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

// The round's ray k < m (listed ray j = first + k) has the steps
// [offsets[j], offsets[j + 1]) less the base (its last ray's end at the
// round's steps); I and T go to its pixel. Threads stride over the rays.
__global__ void __launch_bounds__(128) replay_composite_kernel(
    int n, const long long* __restrict__ row, const int* __restrict__ order,
    const long long* __restrict__ offsets, const float4* __restrict__ emit,
    float* __restrict__ intensity, float* __restrict__ trans) {
    const long long first = row[0], m = row[1], base = row[2];
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < m; k += stride) {
        const long long j = first + k;
        const size_t end = k + 1 < m ? (size_t)(offsets[j + 1] - base) : (size_t)row[3];
        float ir = 0.0f, ig = 0.0f, ib = 0.0f, tr = 1.0f;
        for (size_t s = (size_t)(offsets[j] - base); s < end; s += COMPOSITE_AHEAD) {
            // every load in bounds and unpredicated, so all of them are in
            // flight before the chain needs the first
            float4 e[COMPOSITE_AHEAD];
#pragma unroll
            for (int i = 0; i < COMPOSITE_AHEAD; ++i)
                e[i] = emit[s + i < end ? s + i : end - 1];
#pragma unroll
            for (int i = 0; i < COMPOSITE_AHEAD; ++i)  // past the end: a no-op step
                if (s + i >= end) e[i] = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
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

// One ray the rounds do not take, replayed inline.
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

// The listed rays the rounds do not take: those before round 0 (longer
// than the list) and those from the end of the last round to m. Each
// thread replays its ray's recorded segments one step at a time, as the
// passes do it — replay_march_kernel's step, shade_disk_kernel's (0 +
// disk), shade_cloud_kernel's + cloud and transmittance, then
// replay_composite_kernel's compose — so the ray's (I, T) is bitwise what
// the passes give it. Threads stride over those rays, so a frame whose
// rays the rounds all take costs a grid of blocks that read the table.
__global__ void __launch_bounds__(128) replay_overflow_kernel(
    SceneConsts c, float time, int n, int slots, int rounds, const long long* __restrict__ table,
    const long long* __restrict__ counts, const float* __restrict__ rec,
    const int* __restrict__ order, float* __restrict__ intensity, float* __restrict__ trans) {
    const long long before = table[0], after = table[4 * (rounds - 1)] + table[4 * rounds - 3];
    const long long rays = before + (counts[0] - after), stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < rays; t += stride)
        overflow_ray(c, time, n, slots, rec, order[t < before ? t : after + (t - before)],
                     intensity, trans);
}

static std::atomic<int> march_wave[RRT_MAX_DEVICES], disk_wave[RRT_MAX_DEVICES],
    cloud_wave[RRT_MAX_DEVICES], composite_wave[RRT_MAX_DEVICES],
    overflow_wave[RRT_MAX_DEVICES];

// table: [rounds, 4]; counts: [4] (see replay_rounds_kernel).
extern "C" int rrt_replay_rounds(const long long* csum, const long long* listed, long long cap,
                                 int rounds, long long* table, long long* counts, void* stream) {
    if (rounds < 1) return (int)cudaErrorInvalidValue;
    replay_rounds_kernel<<<1, ROUNDS_BLOCK, 0, (cudaStream_t)stream>>>(csum, listed, cap, rounds,
                                                                       table, counts);
    return (int)cudaGetLastError();
}

// n: pixels of the records; rays: the most rays a round can hold (the
// list's length, at most its capacity), which with `waves` sizes the grid;
// row: the round's row of the table. A launcher with no work launches
// nothing and returns RRT_NOT_LAUNCHED.
extern "C" int rrt_replay_march(const SceneConsts* c, int n, long long rays, int slots, int waves,
                                const long long* row, const float* rec, const int* order,
                                const long long* offsets, float4* pos, float2* vel,
                                void* stream) {
    const unsigned blocks =
        wave_blocks(rays * slots, replay_march_kernel, MARCH_BLOCK, march_wave, waves);
    if (!blocks) return RRT_NOT_LAUNCHED;
    replay_march_kernel<<<blocks, MARCH_BLOCK, 0, (cudaStream_t)stream>>>(
        *c, n, slots, row, rec, order, offsets, pos, vel);
    return (int)cudaGetLastError();
}

// medium 0: disk (writes every step), 1: cloud (adds); capacity: the step
// list's entries
extern "C" int rrt_replay_shade(const SceneConsts* c, float time, int medium,
                                long long capacity, int waves, const long long* row,
                                const float4* pos, const float2* vel, float4* emit, void* stream) {
    if (medium == 0) {
        const unsigned blocks = wave_blocks(capacity, shade_disk_kernel, 128, disk_wave, waves);
        if (!blocks) return RRT_NOT_LAUNCHED;
        shade_disk_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(*c, time, row, pos, vel, emit);
    } else {
        const unsigned blocks = wave_blocks(capacity, shade_cloud_kernel, 128, cloud_wave, waves);
        if (!blocks) return RRT_NOT_LAUNCHED;
        shade_cloud_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(*c, time, row, pos, vel,
                                                                      emit);
    }
    return (int)cudaGetLastError();
}

extern "C" int rrt_replay_composite(int n, long long rays, int waves, const long long* row,
                                    const int* order, const long long* offsets,
                                    const float4* emit, float* intensity, float* trans,
                                    void* stream) {
    const unsigned blocks = wave_blocks(rays, replay_composite_kernel, 128, composite_wave, waves);
    if (!blocks) return RRT_NOT_LAUNCHED;
    replay_composite_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(n, row, order, offsets,
                                                                      emit, intensity, trans);
    return (int)cudaGetLastError();
}

// rays: entries of the list; table: [rounds, 4]
extern "C" int rrt_replay_overflow(const SceneConsts* c, float time, int n, long long rays,
                                   int slots, int waves, int rounds, const long long* table,
                                   const long long* counts, const float* rec, const int* order,
                                   float* intensity, float* trans, void* stream) {
    if (rounds < 1) return (int)cudaErrorInvalidValue;
    const unsigned blocks = wave_blocks(rays, replay_overflow_kernel, 128, overflow_wave, waves);
    if (!blocks) return RRT_NOT_LAUNCHED;
    replay_overflow_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>(
        *c, time, n, slots, rounds, table, counts, rec, order, intensity, trans);
    return (int)cudaGetLastError();
}
