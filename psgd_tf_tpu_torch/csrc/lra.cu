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
// tensor-core Grams and fewer passes are later work.
//
// Ranks: up to LRA_MAX_RANK (32) the kernels above, each thread keeping its
// share of the Gram's pairs in registers and one warp a rank-space vector;
// past it the host runs the rank-generic chain below (lra_update_g, the
// same C entry points), with no cap below what device memory sets. Its
// Grams run in kron_dd.cu's grouped GEMM (rank_space.cuh). Its extra
// scratch over the rank-32 chain's: the GEMM's bands, at most
// 256 (2r + 2)^2 floats (a band per >= 256 lanes, so under 1/256 of the
// state's 2 r n), the two staged rows 2n, the reduced Gram (2r + 2)^2
// and, past RG_SMEM of shared memory (24 r + r^2 floats, r > ~210), the
// corners' workspace 24 r + r^2. At n = 2^20 (H100 80GB HBM3, 700 W,
// tools/kron_gemm_ab.py --gram and --generic): update + apply 5.33 ms at
// r = 64, 13.26 at r = 128; the generic chain forced at r = 10 runs 2.24
// ms against the rank-32 chain's 0.38, which is why both stay.
#include "psgd.cuh"
#include "rank_space.cuh"

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
// max|nablaD| into ndmax[block]. STAGED (r <= LRA_MAX_RANK): the
// coefficients staged in shared memory; else read in place (any r).
template <bool STAGED>
__global__ void __launch_bounds__(LRA_TILE) lra_stage3_kernel(
    int n, int ld, int r, const float* __restrict__ uv, const float* __restrict__ d,
    const float* __restrict__ h, const float* __restrict__ vv, const float* __restrict__ coef,
    const float* __restrict__ scal, float* __restrict__ newuv, float* __restrict__ nd,
    float* __restrict__ ndmax) {
    __shared__ float cs[STAGED ? LRA_MAX_RANK * LRA_NCOEF : 1];
    __shared__ float red[LRA_TILE / 32];
    const float* c = coef;
    if (STAGED) {
        for (int e = threadIdx.x; e < r * LRA_NCOEF; e += LRA_TILE) cs[e] = coef[e];
        c = cs;
    }
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
// d' (d' g + t1 U' + t2 V'), coef4 (r, 2) = (t1, t2), staged in shared
// memory (STAGED, r <= LRA_MAX_RANK) or read in place
template <bool STAGED>
__global__ void __launch_bounds__(LRA_TILE) lra_stage4_kernel(
    int n, int ld, int r, const float* __restrict__ uv, const float* __restrict__ d,
    const float* __restrict__ nd, const float* __restrict__ g, const float* __restrict__ mu,
    const float* __restrict__ coef4, float* __restrict__ newd, float* __restrict__ out) {
    __shared__ float cs[STAGED ? 2 * LRA_MAX_RANK : 1];
    const float* c = coef4;
    if (STAGED) {
        if (g)
            for (int e = threadIdx.x; e < 2 * r; e += LRA_TILE) cs[e] = coef4[e];
        c = cs;
    }
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

// ------------------------------------------------ any rank: the generic chain
// Past LRA_MAX_RANK the host runs the same chain with the rank-generic
// pieces of rank_space.cuh: stage 1's and the apply's Grams through the
// grouped GEMM (gram_launch) over Z = [U; V; two rows] with U and V read
// in place and the two rows staged by lra_rows_kernel (with stage 1's
// max|U|, max|V|), the corners on one block with its vectors strided over
// the threads, stages 3 and 4 reading the coefficients in place. The
// apply's Gram then reads U', V' back after stage 3 (one more pass over
// the factors).

// The two rows of a Gram the state does not hold, e (2, n): stage 1's
// d h and v / d (a = h, b = v), with this block's (max|U|, max|V|) into
// maxpart when it is non-null; the apply's d g and d g nablaD (a = g,
// b = nablaD, z2). U and V rows ld apart.
__global__ void __launch_bounds__(LRA_TILE) lra_rows_kernel(int n, int ld, int r, int z2,
                                                            const float* __restrict__ uv,
                                                            const float* __restrict__ d,
                                                            const float* __restrict__ a,
                                                            const float* __restrict__ b,
                                                            float* __restrict__ e,
                                                            float* __restrict__ maxpart) {
    __shared__ float red[LRA_TILE / 32];
    const int j = blockIdx.x * LRA_TILE + threadIdx.x;
    float mu = 0.f, mv = 0.f;
    if (j < n) {
        if (z2) {
            const float y0 = d[j] * a[j];
            e[j] = y0;
            e[(size_t)n + j] = y0 * b[j];
        } else {
            e[j] = d[j] * a[j];
            e[(size_t)n + j] = b[j] / d[j];
        }
        if (maxpart) {
            for (int k = 0; k < r; ++k) mu = fmaxf(mu, fabsf(uv[(size_t)k * ld + j]));
            for (int k = r; k < 2 * r; ++k) mv = fmaxf(mv, fabsf(uv[(size_t)k * ld + j]));
        }
    }
    if (maxpart) {  // uniform across the block
        mu = lra_block_max(mu, red);
        mv = lra_block_max(mv, red);
        if (threadIdx.x == 0) {
            maxpart[2 * blockIdx.x] = mu;
            maxpart[2 * blockIdx.x + 1] = mv;
        }
    }
}

// Z (2r + 2, 2r + 2): U and V (2r rows ld apart) read in place, the two
// staged rows e (2, n) after them
static GramPlan lra_gram_plan(int n, int ld, int r, const float* uv, const float* e) {
    GramPlan p = gram_plan(2 * r + 2, n);
    gram_add(p, uv, ld, 0, 2 * r, uv, ld, 0, 2 * r);
    gram_add(p, uv, ld, 0, 2 * r, e, n, 2 * r, 2);
    gram_add(p, e, n, 2 * r, 2, e, n, 2 * r, 2);
    return p;
}

// maxs[w] = the max over `count` of maxpart[2 k + w], w = 0, 1; one warp
__global__ void __launch_bounds__(32) lra_maxfold_kernel(int count, const float* __restrict__ maxpart,
                                                         float* __restrict__ maxs) {
    float a = 0.f, b = 0.f;
    for (int k = threadIdx.x; k < count; k += 32) {
        a = fmaxf(a, maxpart[2 * k]);
        b = fmaxf(b, maxpart[2 * k + 1]);
    }
    for (int o = 16; o > 0; o >>= 1) {
        a = fmaxf(a, __shfl_xor_sync(LRA_FULL, a, o));
        b = fmaxf(b, __shfl_xor_sync(LRA_FULL, b, o));
    }
    if (threadIdx.x == 0) {
        maxs[0] = a;
        maxs[1] = b;
    }
}

// b <- M^{-1} b by LU with partial pivoting (the pivot the first row of
// largest |M[k][j]|, as LAPACK's getrf), M (r x r, row-major) overwritten by
// its factors; the row swaps and the eliminations parallel over the block.
// rv, rp: RG_THREADS / 32 floats and ints.
__device__ void lra_lu_solve_g(float* M, float* b, int r, float* rv, int* rp) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int j = 0; j < r; ++j) {
        __syncthreads();
        float v = -1.f;
        int p = r;
        for (int k = j + tid; k < r; k += RG_THREADS) {
            const float a = fabsf(M[(size_t)k * r + j]);
            if (a > v) {
                v = a;
                p = k;
            }
        }
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(LRA_FULL, v, o);
            const int op = __shfl_xor_sync(LRA_FULL, p, o);
            if (ov > v || (ov == v && op < p)) {
                v = ov;
                p = op;
            }
        }
        if (lane == 0) {
            rv[warp] = v;
            rp[warp] = p;
        }
        __syncthreads();
        v = rv[0];
        p = rp[0];
        for (int w = 1; w < RG_THREADS / 32; ++w)
            if (rv[w] > v || (rv[w] == v && rp[w] < p)) {
                v = rv[w];
                p = rp[w];
            }
        if (p != j && p < r) {  // the same p on every thread
            for (int c = tid; c < r; c += RG_THREADS) {
                const float t = M[(size_t)j * r + c];
                M[(size_t)j * r + c] = M[(size_t)p * r + c];
                M[(size_t)p * r + c] = t;
            }
            if (tid == 0) {
                const float t = b[j];
                b[j] = b[p];
                b[p] = t;
            }
        }
        __syncthreads();
        const float piv = M[(size_t)j * r + j];
        for (int k = j + 1 + tid; k < r; k += RG_THREADS) M[(size_t)k * r + j] /= piv;
        __syncthreads();
        const int w = r - j - 1;
        for (int e = tid; e < w * w; e += RG_THREADS) {
            const int k = j + 1 + e / w, c = j + 1 + e % w;
            M[(size_t)k * r + c] -= M[(size_t)k * r + j] * M[(size_t)j * r + c];
        }
    }
    __syncthreads();
    for (int i = 0; i < r; ++i) {  // L y = P b, L unit lower
        const float yi = b[i];
        for (int k = i + 1 + tid; k < r; k += RG_THREADS) b[k] -= M[(size_t)k * r + i] * yi;
        __syncthreads();
    }
    for (int i = r - 1; i >= 0; --i) {  // U x = y
        const float xi = b[i] / M[(size_t)i * r + i];
        __syncthreads();
        if (tid == 0) b[i] = xi;
        for (int k = tid; k < i; k += RG_THREADS) b[k] -= M[(size_t)k * r + i] * xi;
        __syncthreads();
    }
}

#define LRA_GVECS 24
static size_t lra_corner_floats(int r) { return (size_t)LRA_GVECS * r + (size_t)r * r; }

// Corner A on any rank: corner A's algebra on the reduced Gram (2r+2,
// 2r+2) and `mblocks` (max|U|, max|V|) pairs; vectors and the r x r LU in
// dynamic shared memory, or in ws past RG_SMEM (in_smem = 0)
__global__ void __launch_bounds__(RG_THREADS) lra_corner_a_g_kernel(
    int r, int mblocks, const float* __restrict__ gram, const float* __restrict__ maxpart,
    float step, int balance, int update_u, float* __restrict__ coef, float* __restrict__ scal,
    float* ws, int in_smem) {
    extern __shared__ float sm[];
    __shared__ float red[RG_THREADS / 32];
    __shared__ int redp[RG_THREADS / 32];
    float* base = in_smem ? sm : ws;
    const int z = 2 * r + 2, ix = 2 * r, iw = 2 * r + 1, tid = threadIdx.x;
    float mu = 0.f, mv = 0.f;
    for (int b = tid; b < mblocks; b += RG_THREADS) {
        mu = fmaxf(mu, maxpart[2 * b]);
        mv = fmaxf(mv, maxpart[2 * b + 1]);
    }
    mu = rg_reduce(mu, 1, red);
    mv = rg_reduce(mv, 1, red);
    float cu = 1.f, cv = 1.f;
    if (balance) {
        const float rho = sqrtf(mu / mv);
        cu = 1.f / rho;
        cv = rho;
    }
    const float cuu = cu * cu, cvv = cv * cv;
    float* V[LRA_GVECS];
    for (int q = 0; q < LRA_GVECS; ++q) V[q] = base + (size_t)q * r;
    float* M = base + (size_t)LRA_GVECS * r;
    float *t0 = V[0], *t = V[1], *s = V[2], *p = V[3], *q = V[4], *a1 = V[5], *gva1 = V[6],
          *a2 = V[7], *gut = V[8], *atU = V[9], *gta1 = V[10], *btU = V[11], *atV = V[12],
          *btV = V[13], *x1 = V[14], *x2 = V[15], *e1 = V[16], *e2 = V[17], *f1 = V[18],
          *f2 = V[19];
    const RMat Gu{gram, z, 1}, Gv{gram + (size_t)r * z + r, z, 1}, G{gram + (size_t)r * z, z, 1};
    const float xx = gram[(size_t)ix * z + ix], ww = gram[(size_t)iw * z + iw],
                xw = gram[(size_t)ix * z + iw];
    RG_FOR(k, r) {
        t0[k] = gram[(size_t)(r + k) * z + ix];
        t[k] = cv * t0[k];
        s[k] = cu * gram[(size_t)k * z + ix];
        p[k] = cu * gram[(size_t)k * z + iw];
        q[k] = cv * gram[(size_t)(r + k) * z + iw];
        a1[k] = p[k];
    }
    // a1 = (I + G)^{-T} p, a2 = (I + G)^{-1} (q - Gvp a1)
    for (int e = tid; e < r * r; e += RG_THREADS) {
        const int i = e / r, j = e % r;
        M[e] = (i == j ? 1.f : 0.f) + G(j, i);
    }
    lra_lu_solve_g(M, a1, r, red, redp);
    rg_mv(gva1, Gv, a1, r);
    RG_FOR(k, r) {
        gva1[k] *= cvv;
        a2[k] = q[k] - gva1[k];
    }
    __syncthreads();
    for (int e = tid; e < r * r; e += RG_THREADS) {
        const int i = e / r, j = e % r;
        M[e] = (i == j ? 1.f : 0.f) + G(i, j);
    }
    lra_lu_solve_g(M, a2, r, red, redp);
    rg_mv(gut, Gu, t, r);
    RG_FOR(k, r) {
        gut[k] *= cuu;
        atU[k] = s[k] + gut[k];  // U' a, a = Qh
    }
    const float aa = xx + 2.f * rg_dot(s, t, r, red) + rg_dot(t, gut, r, red);
    const float bb = ww - 2.f * rg_dot(a1, q, r, red) + rg_dot(a1, gva1, r, red);
    rg_mv(gta1, G.t(), a1, r);
    const float ab = xw - rg_dot(a1, t, r, red) + rg_dot(t, p, r, red) - rg_dot(t, gta1, r, red);
    RG_FOR(k, r) btU[k] = p[k] - gta1[k];
    RG_FOR(k, r) e1[k] = e2[k] = f1[k] = f2[k] = 0.f;
    if (update_u) {
        rg_mv(atV, G, t, r);
        RG_FOR(k, r) {
            atV[k] += t[k];
            btV[k] = q[k] - gva1[k];
        }
        rg_mv(x1, Gv, atV, r);
        rg_mv(x2, Gv, btV, r);
        RG_FOR(k, r) {
            x1[k] *= cvv;
            x2[k] *= cvv;
        }
        const float norm = sqrtf(fabsf(aa * rg_dot(atV, x1, r, red) + bb * rg_dot(btV, x2, r, red)
                                       - 2.f * ab * rg_dot(atV, x2, r, red)));
        const float m = fminf(step / (norm + psgd_tiny()), FLT_MAX);
        rg_mv(e1, G.t(), atV, r);  // (I + G)^T atV
        rg_mv(e2, G.t(), btV, r);
        RG_FOR(k, r) {
            e1[k] = m * (atV[k] + e1[k]);
            e2[k] = m * (btV[k] + e2[k]);
        }
    } else {
        rg_mv(x1, Gu, atU, r);
        rg_mv(x2, Gu, btU, r);
        RG_FOR(k, r) {
            x1[k] *= cuu;
            x2[k] *= cuu;
        }
        const float norm = sqrtf(fabsf(rg_dot(atU, x1, r, red) * aa + rg_dot(btU, x2, r, red) * bb
                                       - 2.f * rg_dot(atU, x2, r, red) * ab));
        const float m = fminf(step / (norm + psgd_tiny()), FLT_MAX);
        RG_FOR(k, r) {
            f1[k] = m * atU[k];
            f2[k] = m * btU[k];
        }
    }
    __syncthreads();
    RG_FOR(k, r) {
        float* o = coef + (size_t)k * LRA_NCOEF;
        o[0] = t0[k];
        o[1] = cv * a1[k];
        o[2] = cv * atU[k];
        o[3] = cu * a2[k];
        o[4] = e1[k];
        o[5] = e2[k];
        o[6] = f1[k];
        o[7] = f2[k];
        o[8] = cv * atU[k];
        o[9] = cv * btU[k];
    }
    if (tid == 0) {
        scal[0] = cu;
        scal[1] = cv;
    }
}

// Corner B on any rank: mu from `mblocks` block maxima of |nablaD|; with
// the reduced apply Gram gram2, coef4 (r, 2) = (t1, t2) (corner B's)
__global__ void __launch_bounds__(RG_THREADS) lra_corner_b_g_kernel(
    int r, int mblocks, const float* __restrict__ ndmax, const float* __restrict__ gram2,
    float step, float* __restrict__ mu_out, float* __restrict__ coef4, float* ws, int in_smem) {
    extern __shared__ float sm[];
    __shared__ float red[RG_THREADS / 32];
    float* base = in_smem ? sm : ws;
    float m = 0.f;
    for (int b = threadIdx.x; b < mblocks; b += RG_THREADS) m = fmaxf(m, ndmax[b]);
    m = rg_reduce(m, 1, red);
    const float mu = fminf(step / (m + psgd_tiny()), FLT_MAX);
    if (threadIdx.x == 0) mu_out[0] = mu;
    if (!gram2) return;  // uniform
    const int z = 2 * r + 2, iy0 = 2 * r, iy1 = 2 * r + 1;
    float *t1 = base, *y = base + r;
    RG_FOR(k, r) t1[k] = gram2[(size_t)(r + k) * z + iy0] - mu * gram2[(size_t)(r + k) * z + iy1];
    rg_mv(y, RMat{gram2, z, 1}, t1, r);
    RG_FOR(k, r) {
        coef4[2 * k] = t1[k];
        coef4[2 * k + 1] = gram2[(size_t)k * z + iy0] - mu * gram2[(size_t)k * z + iy1] + y[k];
    }
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
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(lra_corner_a_g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RG_SMEM);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(lra_corner_b_g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RG_SMEM);
    done = e == cudaSuccess;
    return e;
}

static int lra_tiles(int n) { return (n + LRA_TILE - 1) / LRA_TILE; }
static bool lra_generic(int r) { return r > LRA_MAX_RANK; }

// The scratch of one call: the partial Grams (stage 1's, then the apply's),
// stage 1's maxima, stage 3's max|nablaD| per block, nablaD, the rank
// space (coef, scal, coef4, mu) and, past LRA_MAX_RANK, the reduced Gram
// (2r+2)^2, the two staged rows 2n and the corners' workspace where it
// outgrows shared memory. Up to LRA_MAX_RANK the partials are packed pairs
// of lra_blocks(n) blocks; past it the GEMM's bands (gram_part_floats: at
// most 256 (2r + 2)^2 floats, a band per >= 256 lanes: under 1/256 of the
// state's 2 r n).
struct LraScratch {
    float *part, *maxpart, *ndmax, *nd, *coef, *scal, *coef4, *mu, *gram, *ws, *rows;
};

static size_t lra_scratch_offsets(int n, int r, size_t off[11]) {
    const size_t z = 2 * r + 2;
    size_t part, maxpart, rank = LRA_MAX_RANK, gram = 0, ws = 0, rows = 0;
    if (lra_generic(r)) {
        part = gram_part_floats(lra_gram_plan(n, n, r, nullptr, nullptr));
        maxpart = 2 * (size_t)lra_tiles(n);
        rank = r;
        gram = z * z;
        ws = rg_in_smem(lra_corner_floats(r)) ? 0 : lra_corner_floats(r);
        rows = 2 * (size_t)n;
    } else {
        part = (size_t)lra_blocks(n) * lra_pairs((int)z);
        maxpart = 2 * (size_t)lra_blocks(n);
    }
    // the workspace first: the corners' entries find it at offset 0 whatever n
    const size_t sizes[11] = {ws, part, maxpart, (size_t)lra_tiles(n), (size_t)n, rank * LRA_NCOEF,
                              2, 2 * rank, 1, gram, rows};
    size_t total = 0;
    for (int k = 0; k < 11; ++k) {
        off[k] = total;
        total += psgd_align4(sizes[k]);
    }
    return total;
}

static LraScratch lra_carve(void* scratch, int n, int r) {
    size_t off[11];
    lra_scratch_offsets(n, r, off);
    float* base = static_cast<float*>(scratch);
    return LraScratch{base + off[1], base + off[2], base + off[3], base + off[4], base + off[5],
                      base + off[6], base + off[7], base + off[8], base + off[9], base + off[0],
                      base + off[10]};
}

extern "C" size_t psgd_lra_scratch_floats(int n, int r) {
    size_t off[11];
    return lra_scratch_offsets(n, r, off);
}

#define LRA_CHECK(n, ld, r) \
    if (n < 1 || ld < n || r < 1) return (int)cudaErrorInvalidValue

#define LRA_LAUNCHED()                              \
    do {                                            \
        const cudaError_t e_ = cudaGetLastError();  \
        if (e_ != cudaSuccess) return (int)e_;      \
    } while (0)

// the generic corners' launches: the workspace in shared memory or in s.ws
static void lra_corner_a_g(int r, int mblocks, const float* gram, const float* maxpart, float step,
                           int balance, int update_u, float* coef, float* scal, float* ws,
                           cudaStream_t stream) {
    const size_t fl = lra_corner_floats(r);
    lra_corner_a_g_kernel<<<1, RG_THREADS, rg_smem_bytes(fl), stream>>>(
        r, mblocks, gram, maxpart, step, balance, update_u, coef, scal, ws, rg_in_smem(fl));
}

static void lra_corner_b_g(int r, int mblocks, const float* ndmax, const float* gram2, float step,
                           float* mu, float* coef4, float* ws, cudaStream_t stream) {
    const size_t fl = 2 * (size_t)r;
    lra_corner_b_g_kernel<<<1, RG_THREADS, rg_smem_bytes(fl), stream>>>(
        r, mblocks, ndmax, gram2, step, mu, coef4, ws, rg_in_smem(fl));
}

// Stage 1's Gram and maxima (gram, maxpart: lra_tiles(n) pairs) or, with
// g, the apply's Gram over U', V' (uv) and nd: the staged rows, then the
// GEMM's bands and their sums
static void lra_gram_g(int n, int ld, int r, const float* uv, const float* d, const float* h,
                       const float* v, const float* g, const float* nd, const LraScratch& s,
                       float* maxpart, float* gram, cudaStream_t stream) {
    lra_rows_kernel<<<lra_tiles(n), LRA_TILE, 0, stream>>>(n, ld, r, g != nullptr, uv, d,
                                                           g ? g : h, g ? nd : v, s.rows, maxpart);
    gram_launch(lra_gram_plan(n, ld, r, uv, s.rows), s.part, gram, stream);
}

// K13 past LRA_MAX_RANK: stage 1's staged rows, Gram bands and their sum,
// corner A, stage 3, with g the apply's rows, bands over U', V' and sum,
// corner B, stage 4 (ten launches with g, seven without)
static int lra_update_g(int n, int r, const float* uv, const float* d, const float* v,
                        const float* h, const float* g, float step, int balance, int update_u,
                        float* out, float* newd, float* pre, const LraScratch& s,
                        cudaStream_t stream) {
    lra_gram_g(n, n, r, uv, d, h, v, nullptr, nullptr, s, s.maxpart, s.gram, stream);
    LRA_LAUNCHED();
    lra_corner_a_g(r, lra_tiles(n), s.gram, s.maxpart, step, balance, update_u,
                   s.coef, s.scal, s.ws, stream);
    LRA_LAUNCHED();
    lra_stage3_kernel<false><<<lra_tiles(n), LRA_TILE, 0, stream>>>(n, n, r, uv, d, h, v, s.coef,
                                                                    s.scal, out, s.nd, s.ndmax);
    LRA_LAUNCHED();
    if (g) {
        lra_gram_g(n, n, r, out, d, nullptr, nullptr, g, s.nd, s, nullptr, s.gram, stream);
        LRA_LAUNCHED();
    }
    lra_corner_b_g(r, lra_tiles(n), s.ndmax, g ? s.gram : nullptr, step, s.mu, s.coef4, s.ws, stream);
    LRA_LAUNCHED();
    lra_stage4_kernel<false><<<lra_tiles(n), LRA_TILE, 0, stream>>>(n, n, r, out, d, s.nd, g, s.mu,
                                                                    s.coef4, newd, pre);
    LRA_LAUNCHED();
    return (int)cudaSuccess;
}

// K13: one update of (UV, d), and with g (non-null) P' g of the updated
// state, in five launches: stage 1, corner A, stage 3, corner B, stage 4
// (past LRA_MAX_RANK, lra_update_g). newuv (2r, n), newd (n,), pre (n,) or
// null; scratch psgd_lra_scratch_floats
extern "C" int psgd_lra_update(int n, int r, const void* uv, const void* d, const void* v,
                               const void* h, const void* g, float step, int balance, int update_u,
                               void* newuv, void* newd, void* pre, void* scratch, void* stream_ptr) {
    LRA_CHECK(n, n, r);
    cudaError_t e = lra_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    const LraScratch s = lra_carve(scratch, n, r);
    float* out = static_cast<float*>(newuv);
    if (lra_generic(r))
        return lra_update_g(n, r, f(uv), f(d), f(v), f(h), f(g), step, balance, update_u, out,
                            static_cast<float*>(newd), static_cast<float*>(pre), s, stream);
    const int blocks = lra_blocks(n);
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
        lra_stage3_kernel<true><<<mblocks, LRA_TILE, 0, stream>>>(n, n, r, f(uv), f(d), f(h), f(v),
                                                                  s.coef, s.scal, out, s.nd, s.ndmax);
    }
    LRA_LAUNCHED();
    lra_corner_b_kernel<<<1, LRA_CORNER, 0, stream>>>(r, mblocks, s.ndmax, blocks,
                                                      g ? s.part : nullptr, nullptr, step, s.mu,
                                                      s.coef4);
    LRA_LAUNCHED();
    lra_stage4_kernel<true><<<lra_tiles(n), LRA_TILE, 0, stream>>>(
        n, n, r, out, f(d), s.nd, f(g), s.mu, s.coef4, static_cast<float*>(newd),
        static_cast<float*>(pre));
    LRA_LAUNCHED();
    return (int)cudaSuccess;
}

// ------------------------------------------------ K14's entries, one a stage
// The same kernels, with the host all-reducing between them over the ranks
// that hold the other lanes (past LRA_MAX_RANK the generic ones, as
// lra_update_g runs them).

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
    if (lra_generic(r)) {
        lra_gram_g(n, ld, r, f(uv), f(d), f(h), f(v), nullptr, nullptr, s, s.maxpart,
                   static_cast<float*>(gram), stream);
        LRA_LAUNCHED();
        lra_maxfold_kernel<<<1, 32, 0, stream>>>(lra_tiles(n), s.maxpart, static_cast<float*>(maxs));
        LRA_LAUNCHED();
        return (int)cudaSuccess;
    }
    lra_stage1_kernel<<<blocks, LRA_TILE, lra_smem(r), stream>>>(n, ld, r, f(uv), f(d), f(h), f(v),
                                                                  s.part, s.maxpart);
    LRA_LAUNCHED();
    lra_reduce_kernel<<<(npairs + 2 + 255) / 256, 256, 0, stream>>>(
        zdim, blocks, s.part, s.maxpart, static_cast<float*>(gram), static_cast<float*>(maxs));
    LRA_LAUNCHED();
    return (int)cudaSuccess;
}

// corner A on a reduced gram (2r+2, 2r+2) and maxs (2,): coef (r, 10), scal
// (2,); scratch psgd_lra_scratch_floats(n, r) of the call
extern "C" int psgd_lra_corner_a(int r, const void* gram, const void* maxs, float step,
                                 int balance, int update_u, void* coef, void* scal, void* scratch,
                                 void* stream_ptr) {
    LRA_CHECK(1, 1, r);
    cudaError_t e = lra_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const float *gp = static_cast<const float*>(gram), *mp = static_cast<const float*>(maxs);
    float *cp = static_cast<float*>(coef), *sp = static_cast<float*>(scal);
    if (lra_generic(r))
        lra_corner_a_g(r, 1, gp, mp, step, balance, update_u, cp, sp,
                       static_cast<float*>(scratch), stream);
    else
        lra_corner_a_kernel<<<1, LRA_CORNER, 0, stream>>>(r, 1, nullptr, gp, mp, step, balance,
                                                          update_u, cp, sp);
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
    const int blocks = lra_blocks(n), zdim = 2 * r + 2, npairs = lra_pairs(zdim);
    const LraScratch s = lra_carve(scratch, n, r);
    if (lra_generic(r)) {
        lra_stage3_kernel<false><<<lra_tiles(n), LRA_TILE, 0, stream>>>(
            n, ld, r, f(uv), f(d), f(h), f(v), f(coef), f(scal), out, ndp, nullptr);
        LRA_LAUNCHED();
        if (g) {
            lra_gram_g(n, ld, r, out, f(d), nullptr, nullptr, f(g), ndp, s, nullptr,
                       static_cast<float*>(gram2), stream);
            LRA_LAUNCHED();
        }
        return (int)cudaSuccess;
    }
    if (!g) {
        lra_stage3_kernel<true><<<lra_tiles(n), LRA_TILE, 0, stream>>>(
            n, ld, r, f(uv), f(d), f(h), f(v), f(coef), f(scal), out, ndp, nullptr);
        LRA_LAUNCHED();
        return (int)cudaSuccess;
    }
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
                                 void* coef4, void* scratch, void* stream_ptr) {
    LRA_CHECK(1, 1, r);
    cudaError_t e = lra_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const float *np = static_cast<const float*>(ndmax), *gp = static_cast<const float*>(gram2);
    float *mp = static_cast<float*>(mu), *cp = static_cast<float*>(coef4);
    if (lra_generic(r))
        lra_corner_b_g(r, 1, np, gp, step, mp, cp, static_cast<float*>(scratch), stream);
    else
        lra_corner_b_kernel<<<1, LRA_CORNER, 0, stream>>>(r, 1, np, 1, nullptr, gp, step, mp, cp);
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
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (lra_generic(r))
        lra_stage4_kernel<false><<<lra_tiles(n), LRA_TILE, 0, stream>>>(
            n, ld, r, f(newuv), f(d), f(nd), f(g), f(mu), f(coef4), static_cast<float*>(newd),
            static_cast<float*>(pre));
    else
        lra_stage4_kernel<true><<<lra_tiles(n), LRA_TILE, 0, stream>>>(
            n, ld, r, f(newuv), f(d), f(nd), f(g), f(mu), f(coef4), static_cast<float*>(newd),
            static_cast<float*>(pre));
    LRA_LAUNCHED();
    return (int)cudaSuccess;
}
