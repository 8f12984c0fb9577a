// Fused cell assignment + occupancy histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel `_assign_count_kernel`
// (channeld_tpu/ops/pallas_kernels.py:33, launched by
// assign_and_count_pallas, pallas_call at :85). For every entity slot:
//
//   cell = floor((x - offset_x) / cell_w) + floor((z - offset_z) / cell_h) * cols
//
// or -1 when the slot is invalid or the point lies outside the grid, and
// in the same pass the i32 occupancy count of every cell.
//
// What bound the first design on the H100: latency and launches, not
// bytes. It reads each position row (12 B) and valid byte once and
// writes one i32 cell id per slot, ~17 B per entity: at the sidecar's
// 131,072 slots ~2.2 MB, a byte bound of 0.00067 ms at 3.35 TB/s. The
// kernel took 0.0042 ms alone (torch.profiler), and a call took 0.0070
// ms of device time with the separate `torch.zeros` launch that zeroed
// `counts` before it (calls queued back to back, CUDA events, with
// chip_smoke.py's timers; NVIDIA H100 80GB HBM3, 700 W): a few
// dependent memory round trips plus a launch, at this size. Its host
// side cost 50-90 us per call (argument checks, a device context, grid
// constants rebuilt with numpy, the SM count queried per launch).
//
// What was tried and measured slower on the same card (a variant
// harness, not kept): any reduction across blocks at the end of the
// kernel (a ticket and a last block summing per-block rows, or a
// thread-block cluster summing through distributed shared memory, with
// or without a ticket across clusters) added 2-6 us of dependent round
// trips; __match_any_sync on the shared-memory path cost more than it
// saved, because Hopper's shared atomics showed no slowdown when half of
// a warp's slots share a cell.
//
// Design. One launch, and nothing is zeroed before it: `counts` arrives
// already zero because the previous launch on the same stream zeroed
// it (so the wrapper refuses CUDA-graph capture, where a replay would
// reuse one `counts`). Each launch zeroes `next`, the buffer the wrapper
// hands to the next launch, in the same pass (independent addresses, so
// no ordering inside the kernel is needed); the first buffer of a
// stream is zeroed once when the wrapper makes it.
// - Shared-memory path (the bins fit a block's opt-in shared memory,
//   227 KB on the H100, ~58K bins): one block of 1,024 threads per SM
//   at most, one slot per thread per pass, a private histogram fed by
//   shared atomics, one atomic for a whole warp whose slots share a
//   cell (a ballot), then one global atomic per non-zero bin per block.
// - Global path (more bins): the same walk, adding straight to `counts`
//   with global atomics, warp-aggregated (__match_any_sync: one atomic
//   per distinct cell per warp) when neighbouring lanes share a cell.
//   Here aggregation pays: in a crowd every lane's global atomic hits
//   one address in L2. At 131,072 slots over 65,536 bins the first
//   design's kernel took 0.0031 ms alone uniform and 0.0503-0.0506 ms on
//   chip_smoke.py's crowd; this one 0.0032 ms (it also zeroes the next
//   launch's 256 KB of counts) and 0.0054 ms (torch.profiler, same card,
//   one run for both designs).
// Integer atomics: the counts do not depend on the order blocks run in.
//
// Numerics match the reference exactly: the division by the cell size
// is a multiplication by its float32 reciprocal, as XLA compiles the
// reference's division by a constant (__fsub_rn, __fmul_rn; built
// without fast math), and the XLA conversion semantics are decided in
// float before any cast: NaN counts as index 0 (XLA converts NaN to 0),
// and ±inf or 1e20 fall outside.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kSharedThreads = 1024;
constexpr int kGlobalThreads = 256;

// Index along one axis and whether it lies inside [0, count).
__device__ __forceinline__ int axis_index(float p, float offset, float inv_size,
                                          int count, bool* inside) {
    const float f = floorf(__fmul_rn(__fsub_rn(p, offset), inv_size));
    if (isnan(f)) {  // XLA: floor(NaN) converts to 0, which is inside
        *inside = true;
        return 0;
    }
    *inside = f >= 0.0f && f < static_cast<float>(count);
    return *inside ? static_cast<int>(f) : 0;
}

__device__ __forceinline__ int assign(const float* __restrict__ positions,
                                      const uint8_t* __restrict__ valid, int i,
                                      const SpatialGrid& g) {
    const size_t row = 3 * static_cast<size_t>(i);
    bool in_x, in_z;
    const int gx = axis_index(positions[row], g.offset_x, g.inv_cell_w, g.cols, &in_x);
    const int gz = axis_index(positions[row + 2], g.offset_z, g.inv_cell_h, g.rows, &in_z);
    return in_x && in_z && valid[i] != 0 ? gx + gz * g.cols : -1;
}

// Shared-memory path: one atomic for a warp whose lanes all hold one
// cell, else one per lane. All 32 lanes call it together.
__device__ __forceinline__ void count_shared(int* bins, int cell) {
    const int first = __shfl_sync(0xffffffffu, cell, 0);
    if (__all_sync(0xffffffffu, cell == first)) {
        if (cell >= 0 && threadIdx.x % 32 == 0) atomicAdd(&bins[cell], 32);
    } else if (cell >= 0) {
        atomicAdd(&bins[cell], 1);
    }
}

// Global path: one atomic per distinct cell of the warp when two
// neighbouring lanes share a cell (a crowd: with half of the slots in
// one cell, all but ~0.1% of warps have such a pair), else one per lane,
// which spares spread-out warps the cost of __match_any_sync. All 32
// lanes call it together.
__device__ __forceinline__ void count_global(int* bins, int cell) {
    const int lane = static_cast<int>(threadIdx.x % 32);
    const int left = __shfl_up_sync(0xffffffffu, cell, 1);
    if (__any_sync(0xffffffffu, lane > 0 && cell >= 0 && cell == left)) {
        const unsigned peers = __match_any_sync(0xffffffffu, cell);
        if (cell >= 0 && lane == __ffs(peers) - 1) atomicAdd(&bins[cell], __popc(peers));
    } else if (cell >= 0) {
        atomicAdd(&bins[cell], 1);
    }
}

template <bool kSharedHistogram>
__global__ void __launch_bounds__(kSharedHistogram ? kSharedThreads : kGlobalThreads)
assign_count_kernel(const float* __restrict__ positions,
                    const uint8_t* __restrict__ valid, int n, SpatialGrid g,
                    int* __restrict__ cell_of, int* __restrict__ counts,
                    int* __restrict__ next) {
    extern __shared__ int hist[];
    const int num_cells = g.cols * g.rows;
    const int stride = gridDim.x * blockDim.x;
    const int first = blockIdx.x * blockDim.x + threadIdx.x;
    if (kSharedHistogram) {
        for (int b = threadIdx.x; b < num_cells; b += blockDim.x) hist[b] = 0;
        __syncthreads();
    }
    // Every lane of a warp runs the same number of passes (the counts
    // take all 32 lanes).
    for (int base = blockIdx.x * blockDim.x; base < n; base += stride) {
        const int i = base + threadIdx.x;
        int cell = -1;
        if (i < n) {
            cell = assign(positions, valid, i, g);
            cell_of[i] = cell;
        }
        if (kSharedHistogram) {
            count_shared(hist, cell);
        } else {
            count_global(counts, cell);
        }
    }
    if (kSharedHistogram) {
        __syncthreads();
        for (int b = threadIdx.x; b < num_cells; b += blockDim.x) {
            const int v = hist[b];
            if (v != 0) atomicAdd(&counts[b], v);
        }
    }
    // Zero the next launch's counts (16-byte stores, then the tail); it
    // depends on nothing above.
    const int quads = num_cells / 4;
    for (int b = first; b < quads; b += stride)
        reinterpret_cast<int4*>(next)[b] = make_int4(0, 0, 0, 0);
    for (int b = 4 * quads + first; b < num_cells; b += stride) next[b] = 0;
}

}  // namespace

// positions f32[n,3] (row-major), valid u8[n] -> cell_of i32[n], and
// the occupancy added into counts i32[cols*rows], which must arrive
// zero; zeroes next i32[cols*rows] (16-byte aligned) for the next
// launch. On device `device` and `stream`; `sms` comes from
// chtpu_device_info. Returns the launch's cudaError_t (0 = launched).
extern "C" int chtpu_assign_count(const float* positions, const uint8_t* valid,
                                  int n, float offset_x, float offset_z,
                                  float cell_w, float cell_h, float inv_cell_w,
                                  float inv_cell_h, int cols, int rows,
                                  int* cell_of, int* counts, int* next,
                                  int shared_histogram, int sms, int device,
                                  void* stream) {
    if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
    const DeviceGuard guard(device);
    if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
    const SpatialGrid g{offset_x, offset_z, cell_w, cell_h, inv_cell_w, inv_cell_h,
                        cols, rows};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (shared_histogram) {
        const int want = n / kSharedThreads + 1;  // >= 1 block, which zeroes next
        const int blocks = want < sms ? want : sms;
        const size_t smem = sizeof(int) * static_cast<size_t>(cols) * rows;
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                assign_count_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        assign_count_kernel<true><<<blocks, kSharedThreads, smem, s>>>(
            positions, valid, n, g, cell_of, counts, next);
    } else {
        // Enough blocks to cover the bins' zeroing and the slots in a few passes.
        const long long work = n > cols * rows ? n : static_cast<long long>(cols) * rows;
        const long long want = work / kGlobalThreads + 1;
        const int blocks = static_cast<int>(want < 32LL * sms ? want : 32LL * sms);
        assign_count_kernel<false><<<blocks, kGlobalThreads, 0, s>>>(
            positions, valid, n, g, cell_of, counts, next);
    }
    return static_cast<int>(cudaGetLastError());
}
