// Shared by the spatial kernels' sources. Each source builds into its
// own shared library with a plain C interface (loaded with ctypes by
// ops/cuda_kernels.py), so each carries its own copy of these helpers.
#pragma once

#include <cuda_runtime.h>

// Grid geometry as the kernels take it: the six GridSpec fields, with
// floats already rounded to float32 on the host (the same rounding JAX
// and torch apply to a Python float used with a float32 array), plus
// the float32 reciprocals of the cell sizes. The reference runs under
// jit with the grid static, where XLA rewrites `x / c` for a constant c
// into `x * (1/c)`; the kernels multiply by the same reciprocals.
struct SpatialGrid {
    float offset_x;
    float offset_z;
    float cell_w;
    float cell_h;
    float inv_cell_w;
    float inv_cell_h;
    int cols;
    int rows;
};

// Makes `device` current for a launch and restores the caller's device
// after it, so the wrapper needs no torch.cuda.device context. Costs two
// runtime calls when the device already is current.
struct DeviceGuard {
    int previous = -1;
    cudaError_t error = cudaSuccess;
    explicit DeviceGuard(int device) {
        error = cudaGetDevice(&previous);
        if (error == cudaSuccess && previous != device) error = cudaSetDevice(device);
        if (previous == device) previous = -1;
    }
    ~DeviceGuard() {
        if (previous >= 0) cudaSetDevice(previous);
    }
};

extern "C" const char* chtpu_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// What the wrappers cache per device: SM count and the largest dynamic
// shared memory a block may opt in to, in bytes.
extern "C" int chtpu_device_info(int device, int* sms, int* smem_optin_bytes) {
    cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaDeviceGetAttribute(
        smem_optin_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}
