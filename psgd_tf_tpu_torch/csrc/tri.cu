// K3: exact inverse of a batch of upper-triangular fp32 factors; K19, the
// blocked triangular solve, at the end of this file.
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

// The inverse of the 32x32 diagonal tile at (r0, r0) of an upper-triangular
// (n, n) factor u, identity-extended past n, by one warp: each thread
// back-substitutes one column in shared memory. read_t reads u[c][r] as the
// tile's [r][c] (the upper transpose of a lower factor: the index map of
// K19's lower systems); write_t stores the inverse transposed. Stores
// out[r * ldo + c] for r, c < lim; only the upper triangle of the tile is read.
__device__ __forceinline__ void tri_diag_tile(const float* __restrict__ u, int n, int r0,
                                              int read_t, float* __restrict__ out, int ldo,
                                              int write_t, int lim) {
    __shared__ float su[TT][TT + 1];
    __shared__ float sx[TT][TT + 1];
    const int c = threadIdx.x;
    for (int r = 0; r < TT; ++r) {
        const int gr = r0 + r, gc = r0 + c;
        const size_t o = read_t ? (size_t)gc * n + gr : (size_t)gr * n + gc;
        su[r][c] = (gr < n && gc < n) ? u[o] : (r == c ? 1.f : 0.f);
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
    for (int r = 0; r < TT; ++r)
        if (r < lim && c < lim) out[write_t ? (size_t)c * ldo + r : (size_t)r * ldo + c] = sx[r][c];
}

__global__ void __launch_bounds__(TT) tri_diag_kernel(const TriBatch b) {
    const int p = find_problem(b.tiles, b.count, blockIdx.x);
    const int n = b.n[p];
    const int r0 = (blockIdx.x - b.tiles[p]) * TT;
    tri_diag_tile(b.u[p], n, r0, 0, b.x[p] + (size_t)r0 * n + r0, n, 0, n - r0);
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

// ------------------------------------------------------------------- K19
//
// K19 replaces psgd_tf_tpu/ops/pallas/tri.py `solve_triangular` (:161, its
// pallas_call at :185, `_solve_kernel` :123): X with M X = B, M = Q^T when
// trans else Q, Q (n, n) upper- or lower-triangular, B (n, nrhs); M is
// lower (forward substitution) when lower != trans. The TPU kernel keeps Q
// and B in VMEM (hence its cap, n <= 768), Newton-inverts the 128x128
// diagonal blocks and substitutes block by block at HIGHEST precision.
// Here, in fp32 with no iteration and no padding:
//   1. solve_diag_kernel: M_ii^{-1} of every 32x32 diagonal tile, one warp
//      a tile, by K3's tile routine (tri_diag_tile). A lower tile is the
//      transpose of an upper one, so the routine reads it through the index
//      map (lower Q) and stores its inverse transposed (lower M), into an
//      (nb, 32, 32) scratch;
//   2. solve_subst_kernel: each block owns a panel of SV_W columns of B and
//      walks the block rows in substitution order,
//      X_i = M_ii^{-1} (B_i - sum_j M_ij X_j) over the rows already solved,
//      reading M_ij = Q_ji^T through the index map (no transposed copy) and
//      its own X_j back through L1/L2; the next tile is loaded into
//      registers while the current one is summed.
// Rows past n are masked (the identity-extended system), so any n is taken;
// only the triangle of Q named by `lower` is read.
// What bounds it: latency. The n^2 nrhs FLOPs (2.1 GFLOP at n = 2048,
// nrhs = 512: 32 us at the fp32 peak) run as a dependent chain of
// ceil(n/32) block rows per panel, and ceil(nrhs/SV_W) panels run at once.

#define SV_W 16     // columns of B a block owns
#define SV_ROWS 16  // thread rows of a block: each thread owns two rows of a tile

__global__ void __launch_bounds__(TT) solve_diag_kernel(int n, int lower, int forward,
                                                        const float* __restrict__ q,
                                                        float* __restrict__ dinv) {
    tri_diag_tile(q, n, blockIdx.x * TT, lower, dinv + (size_t)blockIdx.x * TT * TT, TT,
                  forward, TT);
}

// grid (panels); block (SV_W, SV_ROWS): thread (tx, ty) owns column tx of
// the panel and rows ty, ty + SV_ROWS of the current block row
__global__ void __launch_bounds__(SV_W * SV_ROWS) solve_subst_kernel(
    int n, int nrhs, int trans, int forward, const float* __restrict__ q,
    const float* __restrict__ b, float* x, const float* __restrict__ dinv) {
    constexpr int T = SV_W * SV_ROWS;
    const int nb = (n + TT - 1) / TT;
    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * SV_W + tx;
    const int c0 = blockIdx.x * SV_W, col = c0 + tx;
    __shared__ float sm[TT][TT + 1];    // M_ij, then M_ii^{-1}
    __shared__ float sx[TT][SV_W + 1];  // X_j, then the right-hand side
    float mreg[TT * TT / T], xreg[TT * SV_W / T];

    // M(i, j)'s tile and X_j's panel into registers; for M = Q^T consecutive
    // threads walk a row of Q, so both orientations load coalesced
    auto load = [&](int i, int j) {
#pragma unroll
        for (int k = 0; k < TT * TT / T; ++k) {
            const int e = tid + k * T;
            const int rr = trans ? e % TT : e / TT, cc = trans ? e / TT : e % TT;
            const int gr = i * TT + rr, gc = j * TT + cc;
            const size_t o = trans ? (size_t)gc * n + gr : (size_t)gr * n + gc;
            mreg[k] = (gr < n && gc < n) ? q[o] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < TT * SV_W / T; ++k) {
            const int e = tid + k * T;
            const int gr = j * TT + e / SV_W, gc = c0 + e % SV_W;
            xreg[k] = (gr < n && gc < nrhs) ? x[(size_t)gr * nrhs + gc] : 0.f;
        }
    };
    auto stash = [&]() {
#pragma unroll
        for (int k = 0; k < TT * TT / T; ++k) {
            const int e = tid + k * T;
            if (trans) sm[e % TT][e / TT] = mreg[k];
            else sm[e / TT][e % TT] = mreg[k];
        }
#pragma unroll
        for (int k = 0; k < TT * SV_W / T; ++k) {
            const int e = tid + k * T;
            sx[e / SV_W][e % SV_W] = xreg[k];
        }
    };

    for (int s = 0; s < nb; ++s) {
        const int i = forward ? s : nb - 1 - s;
        float acc[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = i * TT + ty + SV_ROWS * h;
            acc[h] = (r < n && col < nrhs) ? b[(size_t)r * nrhs + col] : 0.f;
        }
        // the solved block rows: j = 0 .. i-1 forward, nb-1 .. i+1 backward
        if (s > 0) load(i, forward ? 0 : nb - 1);
        for (int t = 0; t < s; ++t) {
            stash();
            __syncthreads();
            if (t + 1 < s) load(i, forward ? t + 1 : nb - 2 - t);
#pragma unroll
            for (int kk = 0; kk < TT; ++kk) {
                const float xv = sx[kk][tx];
                acc[0] -= sm[ty][kk] * xv;
                acc[1] -= sm[ty + SV_ROWS][kk] * xv;
            }
            __syncthreads();
        }
        // X_i = M_ii^{-1} acc
#pragma unroll
        for (int h = 0; h < 2; ++h) sx[ty + SV_ROWS * h][tx] = acc[h];
#pragma unroll
        for (int k = 0; k < TT * TT / T; ++k) {
            const int e = tid + k * T;
            sm[e / TT][e % TT] = dinv[(size_t)i * TT * TT + e];
        }
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int rr = ty + SV_ROWS * h, r = i * TT + rr;
            float v = 0.f;
            for (int kk = 0; kk < TT; ++kk) v += sm[rr][kk] * sx[kk][tx];
            if (r < n && col < nrhs) x[(size_t)r * nrhs + col] = v;
        }
        // the next block rows read this one back from global memory
        __syncthreads();
    }
}

extern "C" size_t psgd_tri_solve_scratch_floats(int n) {
    return (size_t)((n + TT - 1) / TT) * TT * TT;
}

extern "C" int psgd_tri_solve(int n, int nrhs, int lower, int trans, const void* q, const void* b,
                              void* x, void* scratch, void* stream_ptr) {
    if (n < 1 || nrhs < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int nb = (n + TT - 1) / TT, forward = lower != trans;
    float* dinv = static_cast<float*>(scratch);
    solve_diag_kernel<<<nb, TT, 0, stream>>>(n, lower, forward, static_cast<const float*>(q), dinv);
    solve_subst_kernel<<<(nrhs + SV_W - 1) / SV_W, dim3(SV_W, SV_ROWS), 0, stream>>>(
        n, nrhs, trans, forward, static_cast<const float*>(q), static_cast<const float*>(b),
        static_cast<float*>(x), dinv);
    return (int)cudaGetLastError();
}
