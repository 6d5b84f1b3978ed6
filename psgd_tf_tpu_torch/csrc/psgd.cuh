// Shared declarations of the Hopper kernels (built by ops/hopper/_build.py).
//
// Every kernel takes its per-problem descriptors BY VALUE as a kernel
// parameter (a few KB, under the 4 KB parameter limit), so a grouped launch
// needs no host-to-device copy of pointers and no synchronisation.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>

// Most layers one kron_dd chain takes; the Python wrapper splits longer lists.
#define PSGD_MAX_LAYERS 16
// Most triangular factors one tri launch inverts (two per layer).
#define PSGD_MAX_TRI (2 * PSGD_MAX_LAYERS)

struct TriBatch {
    const float* u[PSGD_MAX_TRI];  // (n, n) upper triangular, row-major
    float* x[PSGD_MAX_TRI];        // (n, n) out: u^{-1}, lower part zero
    int n[PSGD_MAX_TRI];
    int tiles[PSGD_MAX_TRI + 1];   // prefix sums of ceil(n / TRI_TILE)
    int count;
};

// Launch the exact inverse of every factor of `b` on `stream` (tri.cu).
// The caller fills u, x, n and count; this fills tiles.
void launch_tri_inv(TriBatch& b, cudaStream_t stream);

// The fp32 smallest subnormal, 2^-149: needs denormals kept (no fast-math).
__device__ __forceinline__ float psgd_tiny() { return __int_as_float(1); }
