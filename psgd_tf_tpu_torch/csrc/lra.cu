// K13: the low-rank (UVd) family's update, with the optional fused apply.
//
// Replaces psgd_tf_tpu/ops/pallas/lra_upd.py `fused_update` (:458) and
// `fused_update_apply` (:543) → `_update_impl` (:217), its pallas_calls at
// :281 (`_stage1_kernel` :63), :389 (`_stage3_kernel` :124), :416
// (`_stage3_apply_kernel` :165) and :443 (`_stage4_kernel` :202), with the
// rank-space algebra between them (jnp under jit there, :307-385 and
// :430-440). The factors are packed rank-major, UV (2r, n) = [U; V], with
// d (n,); lane j of every array is parameter j. One C call
// (psgd_lra_update) launches the whole chain on one stream, with no host
// synchronisation and no torch op between the launches:
//   stage 1   Z = [U; V; d h; v / d] (2r + 2 rows): the blocks' partial
//             Grams Z Z^T, which hold every rank-space reduction the update
//             needs, and their max|U|, max|V| for the rebalance;
//   corner A  one block: the partials summed in block order, then one warp,
//             lane k holding row k of the rank space: the rebalance
//             (cu cv = 1), I + G = I + V U^T and its two r x r solves by LU
//             with partial pivoting in shared memory (the algorithm of
//             torch.linalg.solve_ex: I + V U^T is not symmetric), aa, bb, ab,
//             the norm of the branch `update_u` names, the step scale
//             min(step / (norm + tiny), FLT_MAX), and the coefficients
//             coef (r, 10) (columns 0-3 the probe images', 4-9 the U/V
//             update's) and scal = (cu, cv);
//   stage 3   per lane: U', V' and the unscaled d-gradient nablaD, with each
//             block's max|nablaD|; with g also the partial Grams of
//             Z2 = [U'; V'; d g; d g nablaD] for the apply;
//   corner B  one block: mu_d = min(step / (max|nablaD| + tiny), FLT_MAX);
//             with g the apply Gram summed in block order and
//             (t1, t2) = coef4 (r, 2) from it (y = d' g = y0 - mu_d y1);
//   stage 4   per lane d' = d - mu_d d nablaD and, with g,
//             P' g = d' (d' g + t1 U' + t2 V').
// The coins (balance, update_u) and the step arrive as host ints and a
// float; nothing is copied to the host. K14 (lra_upd.fused_update_sharded)
// runs the same kernels through the entries at the end of this file, with
// the host all-reducing between them where the JAX package psums and
// pmaxes: the reduced stage-1 Gram before corner A, max|nablaD| before
// corner B, the apply Gram.
//
// The TPU grid walks lane blocks in order and accumulates the Gram in one
// VMEM block across grid steps. Here each block takes LRA_LANES lanes, in
// tiles of LRA_TILE: a tile's Z columns go to shared memory (one thread a
// lane), then each thread adds its pairs (a, b) of the upper triangle over
// the tile's lanes into registers. The block writes its partial Gram and
// maxima to a (blocks, ...) scratch, and the corner sums them in block
// order: no float atomics, so a run repeats itself bit for bit. Lanes past
// n take part as zero columns: nothing is padded in memory.
//
// What bounds it on this card: memory, once the host is out of the way. The
// update + apply reads UV, d, v, h and g and writes UV', d' and P' g:
// (4rn + 6n) floats, 193 MB at n = 2^20, r = 10, 58 us at 3.35 TB/s; the
// Grams are ~2 (2r+2)^2 n FLOPs (1 GFLOP there, 15 us at the 67 TFLOP/s fp32
// peak). Before the corners moved to the device, ~50 eager torch ops of
// rank-space algebra between the stages cost ~1.65 ms of host time a call
// against ~0.05 ms of device time, and the host set the pace; now a call is
// five launches. Measured on an H100 80GB HBM3 at its 700 W limit
// (chip_smoke.py, phase 7): update + apply 0.383 ms at n = 2^20, r = 10
// (the plain chain 2.197), 0.065 ms at n = 1,021, 0.03-0.06 ms of host time
// a call. This version still reads the factors three times (stages
// 1, 3 and 4) and both Grams' pair sums read shared memory twice per FMA;
// tensor-core Grams and fewer passes are later work. Ranks up to
// LRA_MAX_RANK: each thread keeps its share of the Gram's pairs in
// registers, and a warp holds a rank-space vector.
#include "psgd.cuh"

#include <cfloat>

#define LRA_TILE 256                       // lanes of a tile = threads of a block
#define LRA_LANES (16 * LRA_TILE)          // lanes of a Gram block
#define LRA_MAX_RANK 32
#define LRA_MAX_Z (2 * LRA_MAX_RANK + 2)
#define LRA_PAIRS_PER_THREAD ((LRA_MAX_Z * (LRA_MAX_Z + 1) / 2 + LRA_TILE - 1) / LRA_TILE)
#define LRA_NCOEF 10

static inline int lra_blocks(int n) { return (n + LRA_LANES - 1) / LRA_LANES; }
__host__ __device__ __forceinline__ int lra_pairs(int zdim) { return zdim * (zdim + 1) / 2; }

__device__ __forceinline__ float lra_block_max(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float m = 0.f;
    for (int k = 0; k < LRA_TILE / 32; ++k) m = fmaxf(m, red[k]);
    return m;
}

// This thread's pairs (a <= b) of the upper triangle: the k-th is the
// pair of row-major index threadIdx.x + k * LRA_TILE.
struct Pairs {
    int a[LRA_PAIRS_PER_THREAD], b[LRA_PAIRS_PER_THREAD], count;
};

__device__ __forceinline__ void lra_pair_of(int zdim, int idx, int& a, int& b) {
    a = 0;
    while (idx >= zdim - a) {
        idx -= zdim - a;
        ++a;
    }
    b = a + idx;
}

__device__ void lra_my_pairs(int zdim, Pairs& P) {
    const int npairs = lra_pairs(zdim);
    P.count = 0;
    for (int idx = threadIdx.x; idx < npairs && P.count < LRA_PAIRS_PER_THREAD; idx += LRA_TILE) {
        lra_pair_of(zdim, idx, P.a[P.count], P.b[P.count]);
        ++P.count;
    }
}

// acc[k] += sum over the tile's lanes of zs[a_k] * zs[b_k] (four partial
// sums, so the FMA chain is not one long dependency)
__device__ __forceinline__ void lra_add_pairs(const float* zs, const Pairs& P, float* acc) {
#pragma unroll
    for (int k = 0; k < LRA_PAIRS_PER_THREAD; ++k) {
        if (k >= P.count) break;
        const float* za = zs + P.a[k] * (LRA_TILE + 1);
        const float* zb = zs + P.b[k] * (LRA_TILE + 1);
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        for (int l = 0; l < LRA_TILE; l += 4) {
            s0 += za[l] * zb[l];
            s1 += za[l + 1] * zb[l + 1];
            s2 += za[l + 2] * zb[l + 2];
            s3 += za[l + 3] * zb[l + 3];
        }
        acc[k] += (s0 + s1) + (s2 + s3);
    }
}

// the block's partial Gram, in row-major pair order
__device__ __forceinline__ void lra_store_pairs(const Pairs& P, const float* acc, int npairs,
                                                float* part) {
    float* out = part + (size_t)blockIdx.x * npairs;
    for (int k = 0; k < P.count; ++k) out[(int)threadIdx.x + k * LRA_TILE] = acc[k];
}

// stage 1: grid = lra_blocks(n); dynamic shared memory (2r + 2) x (TILE + 1)
__global__ void __launch_bounds__(LRA_TILE) lra_stage1_kernel(
    int n, int ld, int r, const float* __restrict__ uv, const float* __restrict__ d,
    const float* __restrict__ h, const float* __restrict__ vv, float* __restrict__ part,
    float* __restrict__ maxpart) {
    extern __shared__ float zs[];
    __shared__ float red[LRA_TILE / 32];
    const int zdim = 2 * r + 2, npairs = lra_pairs(zdim), t = threadIdx.x;
    Pairs P;
    lra_my_pairs(zdim, P);
    float acc[LRA_PAIRS_PER_THREAD];
#pragma unroll
    for (int k = 0; k < LRA_PAIRS_PER_THREAD; ++k) acc[k] = 0.f;
    float mu = 0.f, mv = 0.f;
    const int lane0 = blockIdx.x * LRA_LANES;
    for (int base = lane0; base < min(lane0 + LRA_LANES, n); base += LRA_TILE) {
        const int j = base + t;
        const bool ok = j < n;
        for (int k = 0; k < 2 * r; ++k) {
            const float x = ok ? uv[(size_t)k * ld + j] : 0.f;
            zs[k * (LRA_TILE + 1) + t] = x;
            if (k < r) mu = fmaxf(mu, fabsf(x));
            else mv = fmaxf(mv, fabsf(x));
        }
        const float dj = ok ? d[j] : 1.f;
        zs[2 * r * (LRA_TILE + 1) + t] = ok ? dj * h[j] : 0.f;
        zs[(2 * r + 1) * (LRA_TILE + 1) + t] = ok ? vv[j] / dj : 0.f;
        __syncthreads();
        lra_add_pairs(zs, P, acc);
        __syncthreads();
    }
    lra_store_pairs(P, acc, npairs, part);
    mu = lra_block_max(mu, red);
    mv = lra_block_max(mv, red);
    if (t == 0) {
        maxpart[2 * blockIdx.x] = mu;
        maxpart[2 * blockIdx.x + 1] = mv;
    }
}

// Per lane: the probe images, nablaD and U', V' (stage 3). c = coef (r, 10).
__device__ __forceinline__ float lra_lane_update(int ld, int r, int j, const float* __restrict__ uv,
                                                 float dj, float hj, float vj, const float* c,
                                                 float cu, float cv, float* __restrict__ newuv,
                                                 float* zcol) {
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f, p4 = 0.f, p5 = 0.f;
    for (int k = 0; k < r; ++k) {
        const float u = uv[(size_t)k * ld + j], v = uv[(size_t)(r + k) * ld + j];
        const float* ck = c + k * LRA_NCOEF;
        p0 += ck[0] * u;
        p1 += ck[1] * v;
        p2 += ck[2] * v;
        p3 += ck[3] * u;
        p4 += ck[8] * v;
        p5 += ck[9] * v;
    }
    const float x = dj * hj, w = vj / dj;
    const float qh = x + p0;
    const float b = w - p1;
    const float ph = dj * (qh + p2);
    const float ipv = (b - p3) / dj;
    const float nd = ph * hj - vj * ipv;
    const float av = qh + p4, bv = b + p5;
    for (int k = 0; k < r; ++k) {
        const float* ck = c + k * LRA_NCOEF;
        const float u = uv[(size_t)k * ld + j], v = uv[(size_t)(r + k) * ld + j];
        const float nu = cu * u - (ck[4] * qh - ck[5] * b);
        const float nv = cv * v - (ck[6] * av - ck[7] * bv);
        newuv[(size_t)k * ld + j] = nu;
        newuv[(size_t)(r + k) * ld + j] = nv;
        if (zcol) {
            zcol[k * (LRA_TILE + 1)] = nu;
            zcol[(r + k) * (LRA_TILE + 1)] = nv;
        }
    }
    return nd;
}

// stage 3 without the apply: one thread a lane; with ndmax, the block's
// max|nablaD| into ndmax[block]
__global__ void __launch_bounds__(LRA_TILE) lra_stage3_kernel(
    int n, int ld, int r, const float* __restrict__ uv, const float* __restrict__ d,
    const float* __restrict__ h, const float* __restrict__ vv, const float* __restrict__ coef,
    const float* __restrict__ scal, float* __restrict__ newuv, float* __restrict__ nd,
    float* __restrict__ ndmax) {
    __shared__ float c[LRA_MAX_RANK * LRA_NCOEF];
    __shared__ float red[LRA_TILE / 32];
    for (int e = threadIdx.x; e < r * LRA_NCOEF; e += LRA_TILE) c[e] = coef[e];
    __syncthreads();
    const int j = blockIdx.x * LRA_TILE + threadIdx.x;
    float m = 0.f;
    if (j < n) {
        const float ndj = lra_lane_update(ld, r, j, uv, d[j], h[j], vv[j], c, scal[0], scal[1],
                                          newuv, nullptr);
        nd[j] = ndj;
        m = fabsf(ndj);
    }
    if (ndmax) {  // uniform across the block: every thread reaches the barriers
        m = lra_block_max(m, red);
        if (threadIdx.x == 0) ndmax[blockIdx.x] = m;
    }
}

// stage 3 with the apply Gram of Z2 = [U'; V'; d g; d g nablaD]
__global__ void __launch_bounds__(LRA_TILE) lra_stage3_apply_kernel(
    int n, int ld, int r, const float* __restrict__ uv, const float* __restrict__ d,
    const float* __restrict__ h, const float* __restrict__ vv, const float* __restrict__ g,
    const float* __restrict__ coef, const float* __restrict__ scal, float* __restrict__ newuv,
    float* __restrict__ nd, float* __restrict__ part, float* __restrict__ ndmax) {
    extern __shared__ float zs[];
    __shared__ float c[LRA_MAX_RANK * LRA_NCOEF];
    __shared__ float red[LRA_TILE / 32];
    const int zdim = 2 * r + 2, npairs = lra_pairs(zdim), t = threadIdx.x;
    for (int e = t; e < r * LRA_NCOEF; e += LRA_TILE) c[e] = coef[e];
    Pairs P;
    lra_my_pairs(zdim, P);
    float acc[LRA_PAIRS_PER_THREAD];
#pragma unroll
    for (int k = 0; k < LRA_PAIRS_PER_THREAD; ++k) acc[k] = 0.f;
    const float cu = scal[0], cv = scal[1];
    float m = 0.f;
    __syncthreads();
    const int lane0 = blockIdx.x * LRA_LANES;
    for (int base = lane0; base < min(lane0 + LRA_LANES, n); base += LRA_TILE) {
        const int j = base + t;
        float y0 = 0.f, y1 = 0.f;
        if (j < n) {
            const float dj = d[j];
            const float ndj = lra_lane_update(ld, r, j, uv, dj, h[j], vv[j], c, cu, cv, newuv, zs + t);
            nd[j] = ndj;
            m = fmaxf(m, fabsf(ndj));
            y0 = dj * g[j];
            y1 = y0 * ndj;
        } else {
            for (int k = 0; k < 2 * r; ++k) zs[k * (LRA_TILE + 1) + t] = 0.f;
        }
        zs[2 * r * (LRA_TILE + 1) + t] = y0;
        zs[(2 * r + 1) * (LRA_TILE + 1) + t] = y1;
        __syncthreads();
        lra_add_pairs(zs, P, acc);
        __syncthreads();
    }
    lra_store_pairs(P, acc, npairs, part);
    if (ndmax) {
        m = lra_block_max(m, red);
        if (t == 0) ndmax[blockIdx.x] = m;
    }
}


// Sum the blocks' partial Grams in block order into the full symmetric
// (zdim, zdim) Gram, and (when maxpart) max the blocks' maxima.
__global__ void __launch_bounds__(256) lra_reduce_kernel(int zdim, int blocks, const float* __restrict__ part,
                                                         const float* __restrict__ maxpart,
                                                         float* __restrict__ gram,
                                                         float* __restrict__ maxs) {
    const int npairs = lra_pairs(zdim);
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e < npairs) {
        float s = 0.f;
        for (int k = 0; k < blocks; ++k) s += part[(size_t)k * npairs + e];
        int a, b;
        lra_pair_of(zdim, e, a, b);
        gram[a * zdim + b] = s;
        gram[b * zdim + a] = s;
    } else if (maxpart && e < npairs + 2) {
        const int w = e - npairs;
        float m = 0.f;
        for (int k = 0; k < blocks; ++k) m = fmaxf(m, maxpart[2 * k + w]);
        maxs[w] = m;
    }
}

// ------------------------------------------------------------ the corners
// One block of LRA_CORNER threads sums the Gram; then warp 0 alone, lane k
// holding entry k of every rank-space vector (0 past r), does the algebra,
// synchronising with __syncwarp only.

#define LRA_CORNER 256
#define LRA_GLD (LRA_MAX_Z + 1)
#define LRA_LD (LRA_MAX_RANK + 1)
#define LRA_FULL 0xffffffffu

// The full symmetric (zdim, zdim) Gram into gs: the blocks' packed partials
// summed in block order (part), or a Gram already reduced (gram)
__device__ void lra_load_gram(int zdim, int blocks, const float* part, const float* gram,
                              float (*gs)[LRA_GLD]) {
    const int npairs = lra_pairs(zdim);
    if (part) {
        for (int e = threadIdx.x; e < npairs; e += LRA_CORNER) {
            float s = 0.f;
            for (int k = 0; k < blocks; ++k) s += part[(size_t)k * npairs + e];
            int a, b;
            lra_pair_of(zdim, e, a, b);
            gs[a][b] = s;
            gs[b][a] = s;
        }
    } else {
        for (int e = threadIdx.x; e < zdim * zdim; e += LRA_CORNER) gs[e / zdim][e % zdim] = gram[e];
    }
}

__device__ __forceinline__ float lra_warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(LRA_FULL, v, o);
    return v;
}

// Solves M y = b by LU with partial pivoting (the pivot the first row of
// largest |M[i][j]|, as LAPACK's getrf), M (r x r) overwritten by its
// factors; lane k holds b_k and gets y_k
__device__ float lra_lu_solve(float (*M)[LRA_LD], float b, int r) {
    const int k = threadIdx.x;
    for (int j = 0; j < r; ++j) {
        float v = (k >= j && k < r) ? fabsf(M[k][j]) : -1.f;
        int p = k;
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(LRA_FULL, v, o);
            const int op = __shfl_xor_sync(LRA_FULL, p, o);
            if (ov > v || (ov == v && op < p)) {
                v = ov;
                p = op;
            }
        }
        if (p != j) {  // the same p on every lane
            if (k < r) {
                const float tmp = M[j][k];
                M[j][k] = M[p][k];
                M[p][k] = tmp;
            }
            const float bj = __shfl_sync(LRA_FULL, b, j), bp = __shfl_sync(LRA_FULL, b, p);
            if (k == j) b = bp;
            else if (k == p) b = bj;
        }
        __syncwarp();
        if (k > j && k < r) {
            const float l = M[k][j] / M[j][j];
            M[k][j] = l;
            for (int c = j + 1; c < r; ++c) M[k][c] -= l * M[j][c];
        }
        __syncwarp();
    }
    for (int i = 0; i < r; ++i) {  // L y = P b, L unit lower
        const float yi = __shfl_sync(LRA_FULL, b, i);
        if (k > i && k < r) b -= M[k][i] * yi;
    }
    for (int i = r - 1; i >= 0; --i) {  // U x = y
        const float xi = __shfl_sync(LRA_FULL, b, i) / M[i][i];
        if (k == i) b = xi;
        if (k < i) b -= M[k][i] * xi;
    }
    return k < r ? b : 0.f;
}

// Corner A: coef (r, 10) and scal (cu, cv) from the stage-1 Gram of
// Z = [U; V; x; w] and the maxima (max|U|, max|V|) of `blocks` blocks
// (maxpart[2 b], [2 b + 1]); the Gram from `part` or `gram` (lra_load_gram)
__global__ void __launch_bounds__(LRA_CORNER) lra_corner_a_kernel(
    int r, int blocks, const float* __restrict__ part, const float* __restrict__ gram,
    const float* __restrict__ maxpart, float step, int balance, int update_u,
    float* __restrict__ coef, float* __restrict__ scal) {
    __shared__ float gs[LRA_MAX_Z][LRA_GLD];
    __shared__ float A1[LRA_MAX_RANK][LRA_LD], A2[LRA_MAX_RANK][LRA_LD];
    __shared__ float buf[32];
    __shared__ float red[2][LRA_CORNER / 32];
    const int zdim = 2 * r + 2, tid = threadIdx.x;
    lra_load_gram(zdim, blocks, part, gram, gs);
    float mu = 0.f, mv = 0.f;
    for (int b = tid; b < blocks; b += LRA_CORNER) {
        mu = fmaxf(mu, maxpart[2 * b]);
        mv = fmaxf(mv, maxpart[2 * b + 1]);
    }
    for (int o = 16; o > 0; o >>= 1) {
        mu = fmaxf(mu, __shfl_xor_sync(LRA_FULL, mu, o));
        mv = fmaxf(mv, __shfl_xor_sync(LRA_FULL, mv, o));
    }
    if ((tid & 31) == 0) {
        red[0][tid >> 5] = mu;
        red[1][tid >> 5] = mv;
    }
    __syncthreads();
    if (tid >= 32) return;  // no block barrier past this point

    const int k = tid, ix = 2 * r, iw = 2 * r + 1;
    const bool on = k < r;
    float max_u = 0.f, max_v = 0.f;
    for (int w = 0; w < LRA_CORNER / 32; ++w) {
        max_u = fmaxf(max_u, red[0][w]);
        max_v = fmaxf(max_v, red[1][w]);
    }
    float cu = 1.f, cv = 1.f;
    if (balance) {
        const float rho = sqrtf(max_u / max_v);
        cu = 1.f / rho;
        cv = rho;
    }
    const float cuu = cu * cu, cvv = cv * cv;
    const float s0 = on ? gs[k][ix] : 0.f, p0 = on ? gs[k][iw] : 0.f;
    const float t0 = on ? gs[r + k][ix] : 0.f, q0 = on ? gs[r + k][iw] : 0.f;
    const float xx = gs[ix][ix], ww = gs[iw][iw], xw = gs[ix][iw];
    const float t = cv * t0, s = cu * s0, p = cu * p0, q = cv * q0;

    // y_k = sum_j M(k, j) x_j for the rank-space blocks of the Gram:
    // Gup = cu^2 U U^T, Gvp = cv^2 V V^T, G = V U^T, G^T, (I + G)^T
    auto mv_ = [&](auto elem, float x) {
        __syncwarp();
        buf[k] = x;
        __syncwarp();
        float y = 0.f;
        if (on)
            for (int j = 0; j < r; ++j) y += elem(j) * buf[j];
        return y;
    };
    auto Gup = [&](float x) { return mv_([&](int j) { return cuu * gs[k][j]; }, x); };
    auto Gvp = [&](float x) { return mv_([&](int j) { return cvv * gs[r + k][r + j]; }, x); };
    auto G = [&](float x) { return mv_([&](int j) { return gs[r + k][j]; }, x); };
    auto Gt = [&](float x) { return mv_([&](int j) { return gs[r + j][k]; }, x); };
    auto IpGt = [&](float x) {
        return mv_([&](int j) { return (j == k ? 1.f : 0.f) + gs[r + j][k]; }, x);
    };
    auto dot = [&](float a, float b) { return lra_warp_sum(a * b); };

    // a1 = (I + G)^{-T} p, a2 = (I + G)^{-1} (q - Gvp a1)
    for (int e = k; e < r * r; e += 32) {
        const int i = e / r, j = e % r;
        A1[i][j] = (i == j ? 1.f : 0.f) + gs[r + j][i];
        A2[i][j] = (i == j ? 1.f : 0.f) + gs[r + i][j];
    }
    __syncwarp();
    const float a1 = lra_lu_solve(A1, p, r);
    const float Gvp_a1 = Gvp(a1);
    const float a2 = lra_lu_solve(A2, q - Gvp_a1, r);
    const float Gup_t = Gup(t);
    const float atU = s + Gup_t;  // U' a, a = Qh; coefficient 2 is cv atU
    const float aa = xx + 2.f * dot(s, t) + dot(t, Gup_t);
    const float bb = ww - 2.f * dot(a1, q) + dot(a1, Gvp_a1);
    const float Gt_a1 = Gt(a1);
    const float ab = xw - dot(a1, t) + dot(t, p) - dot(t, Gt_a1);
    const float btU = p - Gt_a1;
    float e1 = 0.f, e2 = 0.f, f1 = 0.f, f2 = 0.f;
    if (update_u) {
        const float atV = t + G(t), btV = q - Gvp_a1;
        const float Gvp_atV = Gvp(atV), Gvp_btV = Gvp(btV);
        const float norm = sqrtf(fabsf(aa * dot(atV, Gvp_atV) + bb * dot(btV, Gvp_btV)
                                       - 2.f * ab * dot(atV, Gvp_btV)));
        const float m = fminf(step / (norm + psgd_tiny()), FLT_MAX);
        e1 = m * IpGt(atV);
        e2 = m * IpGt(btV);
    } else {
        const float Gup_atU = Gup(atU), Gup_btU = Gup(btU);
        const float norm = sqrtf(fabsf(dot(atU, Gup_atU) * aa + dot(btU, Gup_btU) * bb
                                       - 2.f * dot(atU, Gup_btU) * ab));
        const float m = fminf(step / (norm + psgd_tiny()), FLT_MAX);
        f1 = m * atU;
        f2 = m * btU;
    }
    if (on) {
        float* o = coef + k * LRA_NCOEF;
        o[0] = t0;
        o[1] = cv * a1;
        o[2] = cv * atU;
        o[3] = cu * a2;
        o[4] = e1;
        o[5] = e2;
        o[6] = f1;
        o[7] = f2;
        o[8] = cv * atU;
        o[9] = cv * btU;
    }
    if (k == 0) {
        scal[0] = cu;
        scal[1] = cv;
    }
}

// Corner B: mu = min(step / (max|nablaD| + tiny), FLT_MAX) over `mblocks`
// block maxima; with the apply Gram (from `part` over `blocks`, or `gram2`)
// coef4 (r, 2) = (t1, t2): t1 = V' y, t2 = U' y + U' U'^T t1, y = y0 - mu y1
__global__ void __launch_bounds__(LRA_CORNER) lra_corner_b_kernel(
    int r, int mblocks, const float* __restrict__ ndmax, int blocks, const float* __restrict__ part,
    const float* __restrict__ gram2, float step, float* __restrict__ mu_out,
    float* __restrict__ coef4) {
    __shared__ float gs[LRA_MAX_Z][LRA_GLD];
    __shared__ float buf[32];
    __shared__ float red[LRA_CORNER / 32];
    const int zdim = 2 * r + 2, tid = threadIdx.x;
    const bool apply = part || gram2;
    if (apply) lra_load_gram(zdim, blocks, part, gram2, gs);
    float m = 0.f;
    for (int b = tid; b < mblocks; b += LRA_CORNER) m = fmaxf(m, ndmax[b]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(LRA_FULL, m, o));
    if ((tid & 31) == 0) red[tid >> 5] = m;
    __syncthreads();
    if (tid >= 32) return;  // no block barrier past this point
    m = 0.f;
    for (int w = 0; w < LRA_CORNER / 32; ++w) m = fmaxf(m, red[w]);
    const float mu = fminf(step / (m + psgd_tiny()), FLT_MAX);
    if (tid == 0) mu_out[0] = mu;
    if (!apply) return;
    const int k = tid, iy0 = 2 * r, iy1 = 2 * r + 1;
    const bool on = k < r;
    const float t1 = on ? gs[r + k][iy0] - mu * gs[r + k][iy1] : 0.f;
    buf[k] = t1;
    __syncwarp();
    float t2 = 0.f;
    if (on) {
        float s = 0.f;
        for (int j = 0; j < r; ++j) s += gs[k][j] * buf[j];
        t2 = gs[k][iy0] - mu * gs[k][iy1] + s;
        coef4[2 * k] = t1;
        coef4[2 * k + 1] = t2;
    }
}

// stage 4: newd = d' = d - mu d nablaD; with g also out = P' g =
// d' (d' g + t1 U' + t2 V'), coef4 (r, 2) = (t1, t2)
__global__ void __launch_bounds__(LRA_TILE) lra_stage4_kernel(
    int n, int ld, int r, const float* __restrict__ uv, const float* __restrict__ d,
    const float* __restrict__ nd, const float* __restrict__ g, const float* __restrict__ mu,
    const float* __restrict__ coef4, float* __restrict__ newd, float* __restrict__ out) {
    __shared__ float c[2 * LRA_MAX_RANK];
    if (g)
        for (int e = threadIdx.x; e < 2 * r; e += LRA_TILE) c[e] = coef4[e];
    __syncthreads();
    const int j = blockIdx.x * LRA_TILE + threadIdx.x;
    if (j >= n) return;
    const float dj = d[j], dp = dj - mu[0] * dj * nd[j];
    newd[j] = dp;
    if (!g) return;
    float s = 0.f;
    for (int k = 0; k < r; ++k)
        s += c[2 * k] * uv[(size_t)k * ld + j] + c[2 * k + 1] * uv[(size_t)(r + k) * ld + j];
    out[j] = dp * (dp * g[j] + s);
}

// ------------------------------------------------------------ host side

static size_t lra_smem(int r) { return sizeof(float) * (size_t)(2 * r + 2) * (LRA_TILE + 1); }

static cudaError_t lra_smem_attrs() {
    static bool done = false;
    if (done) return cudaSuccess;
    const int bytes = (int)lra_smem(LRA_MAX_RANK);
    cudaError_t e = cudaFuncSetAttribute(lra_stage1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(lra_stage3_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    done = e == cudaSuccess;
    return e;
}

static int lra_tiles(int n) { return (n + LRA_TILE - 1) / LRA_TILE; }

// The scratch of one call: the partial Grams (stage 1's, then the apply's),
// stage 1's maxima, stage 3's max|nablaD| per block, nablaD, and the rank
// space (coef, scal, coef4, mu)
struct LraScratch {
    float *part, *maxpart, *ndmax, *nd, *coef, *scal, *coef4, *mu;
};

static size_t lra_scratch_offsets(int n, int r, size_t off[8]) {
    const size_t blocks = lra_blocks(n);
    const size_t sizes[8] = {blocks * lra_pairs(2 * r + 2), 2 * blocks, (size_t)lra_tiles(n),
                             (size_t)n, LRA_MAX_RANK * LRA_NCOEF, 2, 2 * LRA_MAX_RANK, 1};
    size_t total = 0;
    for (int k = 0; k < 8; ++k) {
        off[k] = total;
        total += psgd_align4(sizes[k]);
    }
    return total;
}

static LraScratch lra_carve(void* scratch, int n, int r) {
    size_t off[8];
    lra_scratch_offsets(n, r, off);
    float* base = static_cast<float*>(scratch);
    return LraScratch{base + off[0], base + off[1], base + off[2], base + off[3],
                      base + off[4], base + off[5], base + off[6], base + off[7]};
}

extern "C" size_t psgd_lra_scratch_floats(int n, int r) {
    size_t off[8];
    return lra_scratch_offsets(n, r, off);
}

#define LRA_CHECK(n, ld, r) \
    if (n < 1 || ld < n || r < 1 || r > LRA_MAX_RANK) return (int)cudaErrorInvalidValue

#define LRA_LAUNCHED()                              \
    do {                                            \
        const cudaError_t e_ = cudaGetLastError();  \
        if (e_ != cudaSuccess) return (int)e_;      \
    } while (0)

// K13: one update of (UV, d), and with g (non-null) P' g of the updated
// state, in five launches: stage 1, corner A, stage 3, corner B, stage 4.
// newuv (2r, n), newd (n,), pre (n,) or null; scratch psgd_lra_scratch_floats
extern "C" int psgd_lra_update(int n, int r, const void* uv, const void* d, const void* v,
                               const void* h, const void* g, float step, int balance, int update_u,
                               void* newuv, void* newd, void* pre, void* scratch, void* stream_ptr) {
    LRA_CHECK(n, n, r);
    cudaError_t e = lra_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    const LraScratch s = lra_carve(scratch, n, r);
    const int blocks = lra_blocks(n);
    float* out = static_cast<float*>(newuv);
    lra_stage1_kernel<<<blocks, LRA_TILE, lra_smem(r), stream>>>(n, n, r, f(uv), f(d), f(h), f(v),
                                                                  s.part, s.maxpart);
    LRA_LAUNCHED();
    lra_corner_a_kernel<<<1, LRA_CORNER, 0, stream>>>(r, blocks, s.part, nullptr, s.maxpart, step,
                                                      balance, update_u, s.coef, s.scal);
    LRA_LAUNCHED();
    int mblocks = lra_tiles(n);
    if (g) {
        mblocks = blocks;
        lra_stage3_apply_kernel<<<blocks, LRA_TILE, lra_smem(r), stream>>>(
            n, n, r, f(uv), f(d), f(h), f(v), f(g), s.coef, s.scal, out, s.nd, s.part, s.ndmax);
    } else {
        lra_stage3_kernel<<<mblocks, LRA_TILE, 0, stream>>>(n, n, r, f(uv), f(d), f(h), f(v), s.coef,
                                                            s.scal, out, s.nd, s.ndmax);
    }
    LRA_LAUNCHED();
    lra_corner_b_kernel<<<1, LRA_CORNER, 0, stream>>>(r, mblocks, s.ndmax, blocks,
                                                      g ? s.part : nullptr, nullptr, step, s.mu,
                                                      s.coef4);
    LRA_LAUNCHED();
    lra_stage4_kernel<<<lra_tiles(n), LRA_TILE, 0, stream>>>(
        n, n, r, out, f(d), s.nd, f(g), s.mu, s.coef4, static_cast<float*>(newd),
        static_cast<float*>(pre));
    LRA_LAUNCHED();
    return (int)cudaSuccess;
}

// ------------------------------------------------ K14's entries, one a stage
// The same kernels, with the host all-reducing between them over the ranks
// that hold the other lanes.

// stage 1: gram (2r+2, 2r+2) = Z Z^T, maxs (2,) = (max|U|, max|V|) over
// lanes [0, n) of rows ld apart: uv, d, h and v point at the first lane
extern "C" int psgd_lra_stage1(int n, int ld, int r, const void* uv, const void* d, const void* h,
                               const void* v, void* gram, void* maxs, void* scratch,
                               void* stream_ptr) {
    LRA_CHECK(n, ld, r);
    cudaError_t e = lra_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int blocks = lra_blocks(n), zdim = 2 * r + 2, npairs = lra_pairs(zdim);
    const LraScratch s = lra_carve(scratch, n, r);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    lra_stage1_kernel<<<blocks, LRA_TILE, lra_smem(r), stream>>>(n, ld, r, f(uv), f(d), f(h), f(v),
                                                                  s.part, s.maxpart);
    LRA_LAUNCHED();
    lra_reduce_kernel<<<(npairs + 2 + 255) / 256, 256, 0, stream>>>(
        zdim, blocks, s.part, s.maxpart, static_cast<float*>(gram), static_cast<float*>(maxs));
    LRA_LAUNCHED();
    return (int)cudaSuccess;
}

// corner A on a reduced gram (2r+2, 2r+2) and maxs (2,): coef (r, 10), scal (2,)
extern "C" int psgd_lra_corner_a(int r, const void* gram, const void* maxs, float step,
                                 int balance, int update_u, void* coef, void* scal,
                                 void* stream_ptr) {
    LRA_CHECK(1, 1, r);
    lra_corner_a_kernel<<<1, LRA_CORNER, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        r, 1, nullptr, static_cast<const float*>(gram), static_cast<const float*>(maxs), step,
        balance, update_u, static_cast<float*>(coef), static_cast<float*>(scal));
    LRA_LAUNCHED();
    return (int)cudaSuccess;
}

// stage 3: newuv (2r, n), nd (n,); with g (non-null) also gram2 (2r+2, 2r+2);
// uv and newuv rows ld apart
extern "C" int psgd_lra_stage3(int n, int ld, int r, const void* uv, const void* d, const void* h,
                               const void* v, const void* g, const void* coef, const void* scal,
                               void* newuv, void* nd, void* gram2, void* scratch, void* stream_ptr) {
    LRA_CHECK(n, ld, r);
    cudaError_t e = lra_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    float* out = static_cast<float*>(newuv);
    float* ndp = static_cast<float*>(nd);
    if (!g) {
        lra_stage3_kernel<<<lra_tiles(n), LRA_TILE, 0, stream>>>(
            n, ld, r, f(uv), f(d), f(h), f(v), f(coef), f(scal), out, ndp, nullptr);
        LRA_LAUNCHED();
        return (int)cudaSuccess;
    }
    const int blocks = lra_blocks(n), zdim = 2 * r + 2, npairs = lra_pairs(zdim);
    const LraScratch s = lra_carve(scratch, n, r);
    lra_stage3_apply_kernel<<<blocks, LRA_TILE, lra_smem(r), stream>>>(
        n, ld, r, f(uv), f(d), f(h), f(v), f(g), f(coef), f(scal), out, ndp, s.part, nullptr);
    LRA_LAUNCHED();
    lra_reduce_kernel<<<(npairs + 255) / 256, 256, 0, stream>>>(zdim, blocks, s.part, nullptr,
                                                               static_cast<float*>(gram2), nullptr);
    LRA_LAUNCHED();
    return (int)cudaSuccess;
}

// corner B on a reduced max|nablaD| (1,) and, when gram2 is non-null, a
// reduced apply Gram (2r+2, 2r+2): mu (1,) and coef4 (r, 2)
extern "C" int psgd_lra_corner_b(int r, const void* ndmax, const void* gram2, float step, void* mu,
                                 void* coef4, void* stream_ptr) {
    LRA_CHECK(1, 1, r);
    lra_corner_b_kernel<<<1, LRA_CORNER, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        r, 1, static_cast<const float*>(ndmax), 1, nullptr, static_cast<const float*>(gram2), step,
        static_cast<float*>(mu), static_cast<float*>(coef4));
    LRA_LAUNCHED();
    return (int)cudaSuccess;
}

// stage 4: newd (n,) = d - mu d nd; with g (non-null) pre (n,) =
// d' (d' g + t1 U' + t2 V'); newuv rows ld apart
extern "C" int psgd_lra_stage4(int n, int ld, int r, const void* newuv, const void* d,
                               const void* nd, const void* g, const void* mu, const void* coef4,
                               void* newd, void* pre, void* stream_ptr) {
    LRA_CHECK(n, ld, r);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    lra_stage4_kernel<<<lra_tiles(n), LRA_TILE, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        n, ld, r, f(newuv), f(d), f(nd), f(g), f(mu), f(coef4), static_cast<float*>(newd),
        static_cast<float*>(pre));
    LRA_LAUNCHED();
    return (int)cudaSuccess;
}
