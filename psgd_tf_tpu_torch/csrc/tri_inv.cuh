// K3's device bodies: the exact inverse of a batch of upper-triangular fp32
// factors by the recursive block form, shared by tri.cu's launches (one a
// phase) and by kron_dd.cu's one-launch chain (a grid barrier a phase).
// The design and its measurements are in tri.cu's note. A batch is a
// TriBatch (its factors' pointers and plan in by-value tables) or a
// TriStack (K4's 2B factors at fixed strides, the plan in a device table):
// the bodies read either through the accessors below.
//
// A factor of side n is cut into 32-row leaves; level l joins pairs of
// blocks of b = 32 << l rows: pair g spans rows [r0, e), r0 = 2 b g, split
// at s = r0 + b, e = min(r0 + 2 b, n), and exists where s < n. With X11 and
// X22 the inverses of its two diagonal blocks (made at lower levels):
//   P1:  T   = U12 X22      (b x (e - s), K = e - s, cut to X22's triangle)
//   P2:  X12 = -X11 T       (K = b, cut to X11's triangle)
// T is kept in the block below the diagonal, X[s + j][r0 + i] = T[i][j]
// (the lower part the output must hold as zeros), and zeroed by the next
// phase that does not read it. The phases, each a launch or a barrier:
//   0           the leaves' inverses;
//   1 + 2 l     P1 of level l, and the zeroing of level l - 1's T;
//   2 + 2 l     P2 of level l;
//   1 + 2 L     the zeroing of the last level's T (L = b.levels).
// Each task runs on 256 threads: the leaves 8 a task (one warp each), a
// product or a zeroing one 32 x 32 tile a task. `tri_phase` runs the tasks
// of a phase over a grid of any size.
#pragma once

#include "psgd.cuh"

#define TRI_LEAF 32
#define TRI_THREADS 256
#define TRI_LEAVES_PER_TASK (TRI_THREADS / 32)
#define TRI_LD (TRI_LEAF + 1)
#define TRI_KC 128  // the K a product brings to shared memory at once
#define TRI_PLD (TRI_LEAF + 4)  // a k-major panel's row: 32 floats, 16-byte aligned
// the dynamic shared memory of a task: a leaf tile a warp, or a product's
// two k-major operand panels (TRI_KC x 32 each)
#define TRI_SMEM_LEAVES (TRI_LEAVES_PER_TASK * TRI_LEAF * TRI_LEAF)
#define TRI_SMEM_PANELS (2 * TRI_KC * TRI_PLD)
#define TRI_SMEM_FLOATS (TRI_SMEM_LEAVES > TRI_SMEM_PANELS ? TRI_SMEM_LEAVES : TRI_SMEM_PANELS)

// pairs of level l in a factor of side n
__host__ __device__ inline int tri_pairs(int n, int l) {
    const int b = TRI_LEAF << l;
    return n > b ? (n - b + 2 * b - 1) / (2 * b) : 0;
}

// 32 x 32 output tiles of one of level l's products in a factor of side n
__host__ __device__ inline int tri_level_tiles(int n, int l) {
    const int pairs = tri_pairs(n, l);
    if (!pairs) return 0;
    const int b = TRI_LEAF << l, rt = b / TRI_LEAF;
    const int rest = n - (pairs - 1) * 2 * b - b, last = rest < b ? rest : b;  // the last e - s
    return (pairs - 1) * rt * rt + rt * ((last + TRI_LEAF - 1) / TRI_LEAF);
}

// One factor as the bodies read it: (n, n) at row stride ld
struct TriFactor {
    const float* u;
    float* x;
    int n, ld;
};

// The accessors of a TriBatch: its factors, its prefix sums of leaves and
// of each level's tiles, and the factor of task t by a walk of a prefix
__host__ __device__ inline int tri_count(const TriBatch& b) { return b.count; }
__host__ __device__ inline int tri_levels(const TriBatch& b) { return b.levels; }
__host__ __device__ inline const int* tri_leaves(const TriBatch& b) { return b.tiles; }
__host__ __device__ inline const int* tri_level(const TriBatch& b, int l) { return b.level_tiles[l]; }
__device__ __forceinline__ int tri_find(const TriBatch& b, const int* prefix, int t) {
    int p = 0;
    while (p + 1 < b.count && t >= prefix[p + 1]) ++p;
    return p;
}
__device__ __forceinline__ TriFactor tri_factor(const TriBatch& b, int p) {
    return {b.u[p], b.x[p], b.n[p], b.n[p]};
}

// A TriStack's: factor p < B is layer p's left factor, p >= B layer
// p - B's right one; the plan's prefix sums are searched by bisection
__host__ __device__ inline int tri_count(const TriStack& b) { return 2 * b.B; }
__host__ __device__ inline int tri_levels(const TriStack& b) { return b.levels; }
__host__ __device__ inline const int* tri_leaves(const TriStack& b) { return b.leaves; }
__host__ __device__ inline const int* tri_level(const TriStack& b, int l) {
    return b.level + (size_t)l * (2 * b.B + 1);
}
__device__ __forceinline__ int tri_find(const TriStack& b, const int* prefix, int t) {
    return psgd_bisect(prefix, 0, 2 * b.B, t);
}
__device__ __forceinline__ TriFactor tri_factor(const TriStack& b, int p) {
    const int side = p >= b.B, i = side ? p - b.B : p;
    return {b.u[side] + (size_t)i * b.stride[side], b.x[side] + (size_t)i * b.stride[side],
            b.sides[p], b.ld[side]};
}

// phases of the batch's plan: the leaves alone, or 2 + 2 L
template <class Batch>
__host__ __device__ inline int tri_phases(const Batch& b) {
    return tri_levels(b) ? 2 + 2 * tri_levels(b) : 1;
}

// tasks of phase ph of the batch's plan
template <class Batch>
__host__ __device__ inline int tri_phase_tasks(const Batch& b, int ph) {
    const int count = tri_count(b), levels = tri_levels(b);
    if (ph == 0) return (tri_leaves(b)[count] + TRI_LEAVES_PER_TASK - 1) / TRI_LEAVES_PER_TASK;
    const int l = (ph - 1) / 2;
    if (ph == 1 + 2 * levels) return tri_level(b, l - 1)[count];  // the last zeroing
    const int own = tri_level(b, l)[count];
    return (ph % 2 && l > 0) ? own + tri_level(b, l - 1)[count] : own;
}

// The leaf at rows [r0, r0 + 32) of a factor (row stride ld): its inverse,
// identity-extended past n, by the calling warp; lane c owns column c in registers and the
// tile's U is broadcast from `su` (1024 floats). Column-oriented
// back-substitution: for k = 31 .. 0, x_k = b_k (1 / U_kk), then
// b_r -= U_rk x_k for every r < k, so each step's FMAs are independent. Writes the whole
// tile (zeros below its diagonal), rows and columns masked to n.
__device__ __forceinline__ void tri_leaf(const float* u, float* x, int n, int ld, int r0,
                                         float* su) {
    const int c = threadIdx.x & 31;
    const int lim = min(TRI_LEAF, n - r0);
#pragma unroll
    for (int r = 0; r < TRI_LEAF; ++r)  // 32 loads in flight
        su[r * TRI_LEAF + c] = (r < lim && c < lim) ? u[(size_t)(r0 + r) * ld + r0 + c]
                                                    : (r == c ? 1.f : 0.f);
    __syncwarp();
    // 1 / U_kk of every row at once, off the substitution's dependent path
    // (in the diagonal's slots, which the substitution reads no more)
    su[c * TRI_LEAF + c] = 1.f / su[c * TRI_LEAF + c];
    __syncwarp();
    float v[TRI_LEAF];
#pragma unroll
    for (int r = 0; r < TRI_LEAF; ++r) v[r] = r == c ? 1.f : 0.f;
#pragma unroll
    for (int k = TRI_LEAF - 1; k >= 0; --k) {
        const float xk = v[k] * su[k * TRI_LEAF + k];
        v[k] = xk;
#pragma unroll
        for (int r = 0; r < k; ++r) v[r] = fmaf(-su[r * TRI_LEAF + k], xk, v[r]);
        // keeps each step's loads in its step: hoisted, they hold hundreds
        // of registers in a kernel that runs the GEMM's bodies too
        asm volatile("" ::: "memory");
    }
    if (c < lim)
#pragma unroll
        for (int r = 0; r < TRI_LEAF; ++r)
            if (r < lim) x[(size_t)(r0 + r) * ld + r0 + c] = r > c ? 0.f : v[r];
    __syncwarp();
}

__device__ __forceinline__ void tri_cp4(float* dst, const float* src, bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
}

// acc[q] (row ty + 8 q, column tx of a 32 x 32 tile) = sum over k in
// [k_lo, k_hi) of A(row, k) B(k, col): A(i, k) = a[i lda + k], B(k, j) =
// b[j ldb + k] when bt, else b[k ldb + j]; B's columns past `cols` are
// zero. K in chunks of TRI_KC: every element of a chunk's two k-major
// panels in flight at once by cp.async (zero-filled past the edges). The
// block's four 64-thread groups each sum a quarter of every chunk's k, a
// 4 x 4 outputs a thread (two float4 reads for 16 FMAs, k rising); the
// quarters are then added in group order through shared memory.
__device__ __forceinline__ void tri_product(const float* a, int lda, const float* b, int ldb,
                                            bool bt, int k_lo, int k_hi, int cols, float* sm,
                                            float (&acc)[4]) {
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int grp = threadIdx.x >> 6, g64 = threadIdx.x & 63;
    const int i0 = (g64 >> 3) * 4, j0 = (g64 & 7) * 4;
    float* as = sm;                          // as[kk][i]
    float* bs = sm + TRI_KC * TRI_PLD;       // bs[kk][j]
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
    for (int k0 = k_lo; k0 < k_hi; k0 += TRI_KC) {
        const int kn = min(TRI_KC, k_hi - k0);
#pragma unroll
        for (int q = 0; q < TRI_LEAF * TRI_KC / TRI_THREADS; ++q) {
            const int e = threadIdx.x + q * TRI_THREADS;
            const int r = e / TRI_KC, kk = e % TRI_KC;  // consecutive threads along k
            const bool oa = kk < kn;
            tri_cp4(as + kk * TRI_PLD + r, oa ? a + (size_t)r * lda + k0 + kk : a, oa);
            if (bt) {
                const bool ob = kk < kn && r < cols;
                tri_cp4(bs + kk * TRI_PLD + r, ob ? b + (size_t)r * ldb + k0 + kk : b, ob);
            } else {
                const int k2 = e / TRI_LEAF, j = e % TRI_LEAF;  // consecutive threads along j
                const bool ob = k2 < kn && j < cols;
                tri_cp4(bs + k2 * TRI_PLD + j, ob ? b + (size_t)(k0 + k2) * ldb + j : b, ob);
            }
        }
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();
        const int q4 = (kn + 3) / 4, lo = grp * q4, hi = min(kn, lo + q4);
#pragma unroll 4
        for (int kk = lo; kk < hi; ++kk) {
            const float4 av = *reinterpret_cast<const float4*>(as + kk * TRI_PLD + i0);
            const float4 bv = *reinterpret_cast<const float4*>(bs + kk * TRI_PLD + j0);
            const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a4[i], b4[j], part[i][j]);
        }
        __syncthreads();  // the panels are free for the next chunk
    }
    // the four quarters, added in group order
    float* red = sm;  // red[grp][i][j], rows TRI_LD apart
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) red[(grp * TRI_LEAF + i0 + i) * TRI_LD + j0 + j] = part[i][j];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int r = ty + 8 * q;
        float v = red[r * TRI_LD + tx];
#pragma unroll
        for (int g = 1; g < 4; ++g) v += red[(g * TRI_LEAF + r) * TRI_LD + tx];
        acc[q] = v;
    }
    __syncthreads();  // the caller may reuse the shared memory
}

// One task of phase ph (every thread of the block calls it; sm holds
// TRI_SMEM_FLOATS floats). Buffers written inside a launch are read through
// plain pointers.
template <class Batch>
__device__ __forceinline__ void tri_task(const Batch& b, int ph, int t, float* sm) {
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int count = tri_count(b);
    if (ph == 0) {
        const int* leaves = tri_leaves(b);
        const int leaf = t * TRI_LEAVES_PER_TASK + ty;
        if (leaf < leaves[count]) {
            const int p = tri_find(b, leaves, leaf);
            const TriFactor f = tri_factor(b, p);
            tri_leaf(f.u, f.x, f.n, f.ld, (leaf - leaves[p]) * TRI_LEAF,
                     sm + ty * TRI_LEAF * TRI_LEAF);
        }
        return;
    }
    int l = (ph - 1) / 2, mode = ph % 2 ? 1 : 2;  // 1: P1, 2: P2, 0: zeroing
    if (ph == 1 + 2 * tri_levels(b)) {
        l -= 1;
        mode = 0;
    } else if (mode == 1 && t >= tri_level(b, l)[count]) {
        t -= tri_level(b, l)[count];
        l -= 1;
        mode = 0;
    }
    const int* level = tri_level(b, l);
    const int p = tri_find(b, level, t);
    const TriFactor f = tri_factor(b, p);
    const int n = f.n, ld = f.ld;
    const float* u = f.u;
    float* x = f.x;
    t -= level[p];
    // the pair and the tile: full pairs first, the ragged one last
    const int bs = TRI_LEAF << l, rt = bs / TRI_LEAF, pairs = tri_pairs(n, l);
    const int g = min(t / (rt * rt), pairs - 1);
    const int r0 = 2 * bs * g, s = r0 + bs, e = min(r0 + 2 * bs, n);
    const int ct = (e - s + TRI_LEAF - 1) / TRI_LEAF, loc = t - g * rt * rt;
    const int i0 = (loc / ct) * TRI_LEAF, j0 = (loc % ct) * TRI_LEAF;  // in the pair's block
    const int cols = min(TRI_LEAF, e - s - j0);
    float acc[4];
    if (mode == 2) {
        // X12 = -X11 T, T[k][j] = X[s + j][r0 + k]; X11 upper: k >= i0
        tri_product(x + (size_t)(r0 + i0) * ld + r0, ld, x + (size_t)(s + j0) * ld + r0, ld, true,
                    i0, bs, cols, sm, acc);
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (tx < cols) x[(size_t)(r0 + i0 + ty + 8 * q) * ld + s + j0 + tx] = -acc[q];
        return;
    }
    if (mode == 1) {
        // T = U12 X22; X22 upper: k < j0 + 32
        tri_product(u + (size_t)(r0 + i0) * ld + s, ld, x + (size_t)s * ld + s + j0, ld, false, 0,
                    min(e - s, j0 + TRI_LEAF), cols, sm, acc);
#pragma unroll
        for (int q = 0; q < 4; ++q) sm[(ty + 8 * q) * TRI_LD + tx] = acc[q];
        __syncthreads();
    }
    // T's tile, or zeros, into X[s + j0 + j][r0 + i0 + i]: a warp a row of X
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int j = ty + 8 * q;
        if (j < cols)
            x[(size_t)(s + j0 + j) * ld + r0 + i0 + tx] = mode ? sm[tx * TRI_LD + j] : 0.f;
    }
    if (mode == 1) __syncthreads();
}

// Phase ph's tasks t = blockIdx.x, blockIdx.x + gridDim.x, ... (every
// thread of the block runs every task)
template <class Batch>
__device__ __forceinline__ void tri_phase(const Batch& b, int ph, float* sm) {
    const int tasks = tri_phase_tasks(b, ph);
    for (int t = blockIdx.x; t < tasks; t += gridDim.x) {
        tri_task(b, ph, t, sm);
        __syncthreads();  // the next task reuses the shared memory
    }
}
