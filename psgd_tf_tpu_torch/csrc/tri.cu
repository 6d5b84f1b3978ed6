// K3: exact inverse of a batch of upper-triangular fp32 factors.
//
// Replaces psgd_tf_tpu/ops/pallas/tri.py `_newton_inv_batched` (:94), the
// device routine that K1/K2 run on every factor's diagonal blocks. The TPU
// has no trsm, so the Pallas code inverts 128x128 blocks by a Newton chain
// whose residual is nilpotent. Hopper has no such limit: this file inverts
// each WHOLE factor by blocked back-substitution in fp32, exact to fp32
// rounding (no iteration, no truncation).
//
// Two launches cover every factor of the batch:
//   1. tri_diag_kernel: one warp per 32x32 diagonal tile; each thread
//      back-substitutes one column of the tile's inverse in shared memory.
//   2. tri_offdiag_kernel: one block per (factor, block column j); it walks
//      block rows i = j-1 .. 0, X[i,j] = -X[i,i] * sum_{k=i+1..j} U[i,k] X[k,j],
//      reading the tiles it wrote earlier back through L2.
//
// What bounds it on this card: latency, not FLOPs or bytes. At LeNet5's
// sides (6..257) the ten factors have 32 diagonal tiles in all; each one is
// a 32-step dependent substitution, and each block column a chain of up to
// ceil(n/32) - 1 dependent tile products. Measured on an H100 80GB HBM3 at
// its 700 W limit: 18.5 us for the diagonal launch and 49 us for the
// off-diagonal one per LeNet5 step. The design keeps the chain to two
// launches for all factors at once and gives every block column its own
// block, so the columns run in parallel.
//
// One difference from the Pallas routine: that one inverts only the
// diagonal blocks and leaves the off-diagonal work to the substitutions of
// its caller; here the caller gets the full inverse and multiplies by it.
// A side that is not a multiple of 32 is handled as the identity-extended
// factor, with the padding masked and never stored.
#include "psgd.cuh"

#define TT 32

__device__ __forceinline__ int find_problem(const int* prefix, int count, int t) {
    int p = 0;
    while (p + 1 < count && t >= prefix[p + 1]) ++p;
    return p;
}

__global__ void __launch_bounds__(TT) tri_diag_kernel(const TriBatch b) {
    const int p = find_problem(b.tiles, b.count, blockIdx.x);
    const int n = b.n[p];
    const float* __restrict__ u = b.u[p];
    float* __restrict__ x = b.x[p];
    const int r0 = (blockIdx.x - b.tiles[p]) * TT;
    __shared__ float su[TT][TT + 1];
    __shared__ float sx[TT][TT + 1];
    const int c = threadIdx.x;
    for (int r = 0; r < TT; ++r) {
        const int gr = r0 + r, gc = r0 + c;
        su[r][c] = (gr < n && gc < n) ? u[(size_t)gr * n + gc] : (r == c ? 1.f : 0.f);
    }
    __syncthreads();
    // column c of the tile's inverse; each thread touches only its column
    for (int r = TT - 1; r >= 0; --r) {
        float v = 0.f;
        if (r <= c) {
            float s = (r == c) ? 1.f : 0.f;
            for (int k = r + 1; k <= c; ++k) s -= su[r][k] * sx[k][c];
            v = s / su[r][r];
        }
        sx[r][c] = v;
    }
    for (int r = 0; r < TT; ++r) {
        const int gr = r0 + r, gc = r0 + c;
        if (gr < n && gc < n) x[(size_t)gr * n + gc] = sx[r][c];
    }
}

__global__ void __launch_bounds__(TT * 8) tri_offdiag_kernel(const TriBatch b) {
    const int p = find_problem(b.tiles, b.count, blockIdx.x);
    const int n = b.n[p];
    const float* __restrict__ u = b.u[p];
    float* x = b.x[p];  // read back after this block writes it: no __restrict__
    const int nb = (n + TT - 1) / TT;
    const int j = blockIdx.x - b.tiles[p];
    const int tx = threadIdx.x, ty = threadIdx.y;  // (32, 8): rows ty + 8q
    const int gc = j * TT + tx;
    __shared__ float sa[TT][TT + 1];
    __shared__ float sb[TT][TT + 1];

    for (int i = j + 1; i < nb; ++i) {  // strictly lower tiles are zero
        for (int rr = ty; rr < TT; rr += 8) {
            const int gr = i * TT + rr;
            if (gr < n && gc < n) x[(size_t)gr * n + gc] = 0.f;
        }
    }
    for (int i = j - 1; i >= 0; --i) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = i + 1; k <= j; ++k) {
            for (int q = 0; q < 4; ++q) {
                const int rr = ty + 8 * q;
                const int ur = i * TT + rr, uc = k * TT + tx, xr = k * TT + rr;
                sa[rr][tx] = (ur < n && uc < n) ? u[(size_t)ur * n + uc] : 0.f;
                sb[rr][tx] = (xr < n && gc < n) ? x[(size_t)xr * n + gc] : 0.f;
            }
            __syncthreads();
            for (int kk = 0; kk < TT; ++kk) {
                const float bv = sb[kk][tx];
                for (int q = 0; q < 4; ++q) acc[q] += sa[ty + 8 * q][kk] * bv;
            }
            __syncthreads();
        }
        // X[i,j] = -X[i,i] * acc, with X[i,i] from tri_diag_kernel
        for (int q = 0; q < 4; ++q) {
            const int rr = ty + 8 * q;
            const int dr = i * TT + rr, dc = i * TT + tx;
            sb[rr][tx] = acc[q];
            sa[rr][tx] = (dr < n && dc < n) ? x[(size_t)dr * n + dc] : 0.f;
        }
        __syncthreads();
        for (int q = 0; q < 4; ++q) {
            const int rr = ty + 8 * q;
            float s = 0.f;
            for (int kk = 0; kk < TT; ++kk) s += sa[rr][kk] * sb[kk][tx];
            const int gr = i * TT + rr;
            if (gr < n && gc < n) x[(size_t)gr * n + gc] = -s;
        }
        // the next block row reads this tile back from global memory
        __syncthreads();
    }
}

void launch_tri_inv(TriBatch& b, cudaStream_t stream) {
    b.tiles[0] = 0;
    for (int p = 0; p < b.count; ++p) b.tiles[p + 1] = b.tiles[p] + (b.n[p] + TT - 1) / TT;
    const int total = b.tiles[b.count];
    tri_diag_kernel<<<total, TT, 0, stream>>>(b);
    tri_offdiag_kernel<<<total, dim3(TT, 8), 0, stream>>>(b);
}

extern "C" int psgd_tri_inv_upper(int count, void** u, void** x, const int* n, void* stream) {
    if (count < 1 || count > PSGD_MAX_TRI) return (int)cudaErrorInvalidValue;
    TriBatch b;
    b.count = count;
    for (int p = 0; p < count; ++p) {
        if (n[p] < 1) return (int)cudaErrorInvalidValue;
        b.u[p] = static_cast<const float*>(u[p]);
        b.x[p] = static_cast<float*>(x[p]);
        b.n[p] = n[p];
    }
    launch_tri_inv(b, static_cast<cudaStream_t>(stream));
    return (int)cudaGetLastError();
}
