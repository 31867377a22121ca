// Launch helpers shared by the kernel sources.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

// What a launcher returns when it had no work and launched nothing: not a
// CUDA error code (those are >= 0); ops/cuda_lib counts no launch for it.
#define RRT_NOT_LAUNCHED (-1)

#define RRT_MAX_DEVICES 64

// Blocks in one wave of `kernel` at `block` threads a block on the current
// device: its SM count times the blocks resident on one SM. Looked up once
// per device and kept in `cache` (one slot a device, 0 until looked up).
template <typename Kernel>
static unsigned one_wave(Kernel kernel, int block, std::atomic<int>* cache) {
    int dev = 0;
    cudaGetDevice(&dev);
    const bool cached = dev >= 0 && dev < RRT_MAX_DEVICES;
    int wave = cached ? cache[dev].load(std::memory_order_relaxed) : 0;
    if (wave == 0) {
        int sms = 0, per_sm = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, 0);
        wave = sms * (per_sm > 0 ? per_sm : 1);
        if (wave <= 0) wave = 1;
        if (cached) cache[dev].store(wave, std::memory_order_relaxed);
    }
    return (unsigned)wave;
}

// Blocks for `count` threads at `block` a block, at most `waves` waves: the
// kernel strides over the rest.
template <typename Kernel>
static unsigned wave_blocks(long long count, Kernel kernel, int block, std::atomic<int>* cache,
                            int waves = 1) {
    const long long needed = (count + block - 1) / block;
    if (needed <= 0) return 0;
    const long long most = (long long)one_wave(kernel, block, cache) * waves;
    return (unsigned)(needed < most ? needed : most);
}
