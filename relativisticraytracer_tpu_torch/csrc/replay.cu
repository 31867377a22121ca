// Replay pass: re-integrate and shade only the recorded media segments,
// one thread per listed ray.
//
// Replaces relativisticraytracer_tpu/ops/pallas_compact.py::media_replay
// (kernel body _replay_kernel -> _replay_step).
//
// What bounds it on an H100: arithmetic issue inside the media blocks. A
// cloud step evaluates ~15 value-noise lattices (8 hashes each) plus a
// 5-octave ridge stack, ~3,000 float ops; a disk step ~1,000 with cos/sin/
// exp/pow. Only the few percent of rays that recorded media run at all
// (about 3% of a 1080p frame at the headline pose), so the grid is small
// and occupancy, not bandwidth, is the second limit; the inputs are 7*slots
// floats per listed ray.
//
// What the design does about it: the thread list is the index of the
// recorded rays, longest replay first (torch bookkeeping in
// ops/pallas_compact.replay_order), so each warp holds rays of similar
// length and divergence at the loop end is small. Each thread reads its
// records through that index (no gather pass) and writes I and T straight
// back to its pixel; indices are unique, so no atomics. The disk and cloud
// blocks run under the per-thread skip probe (a False probe contributes
// exactly zero, see media/densities.py), and the trajectory is the record
// kernel's bitwise: the same march_common.cuh functions, built without FMA
// contraction.
#include <cuda_runtime.h>

#include "march_common.cuh"

__global__ void __launch_bounds__(128) replay_kernel(SceneConsts c, float time, int n, int m,
                                                     int slots, const float* __restrict__ rec,
                                                     const int* __restrict__ order,
                                                     float* __restrict__ intensity,
                                                     float* __restrict__ trans) {
    int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= m) return;
    const int pix = order[j];
    float ir = 0.0f, ig = 0.0f, ib = 0.0f, tr = 1.0f;
    for (int sl = 0; sl < slots; ++sl) {
        const float* r = rec + (size_t)(sl * 7) * n + pix;
        float left = r[(size_t)6 * n];
        if (!(left > 0.0f)) break;  // empty slot: the ray is done
        V3 p = v3(r[0], r[(size_t)n], r[(size_t)2 * n]);
        V3 v = v3(r[(size_t)3 * n], r[(size_t)4 * n], r[(size_t)5 * n]);
        for (; left > 0.0f; left = left - 1.0f) {
            // _replay_step: the march step restricted to a recorded span
            V3 rel = recenter(c, p);
            float r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z;
            bool zd, zc;
            media_zones(c, rel, r2, zd, zc);
            float h = adaptive_h(c, r2, zd, zc);
            bool pd, pc;
            media_probes(c, rel, zd, zc, pd, pc);
            rk4_step(c, p, v, h);
            float er = 0.0f, eg = 0.0f, eb = 0.0f, op = 0.0f;
            if (pd) disk_block(c, rel, r2, v, zd, time, er, eg, eb, op);
            if (pc) cloud_block(c, rel, r2, v, zc, time, er, eg, eb, op);
            if (zd || zc) {  // render/march.compose_step
                float d_tau = op * h;
                float step_trans = expf(-d_tau);
                float factor = (1.0f - step_trans) * tr;
                ir = ir + er * factor;
                ig = ig + eg * factor;
                ib = ib + eb * factor;
                tr = tr * step_trans;
            }
        }
    }
    intensity[pix] = ir;
    intensity[(size_t)n + pix] = ig;
    intensity[(size_t)2 * n + pix] = ib;
    trans[pix] = tr;
}

extern "C" int rrt_replay(const SceneConsts* c, float time, int n, int m, int slots,
                          const float* rec, const int* order, float* intensity, float* trans,
                          void* stream) {
    if (m > 0) {
        int block = 128;
        replay_kernel<<<(m + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
            *c, time, n, m, slots, rec, order, intensity, trans);
    }
    return (int)cudaGetLastError();
}
