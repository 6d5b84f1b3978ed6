// K15 and K16: the sparse-LU family's update, with the optional fused apply.
//
// Replaces psgd_tf_tpu/ops/pallas/splu_one.py `_call` (:223) → its
// pallas_call (:286, `_kernel` :77), which holds the whole state in VMEM and
// does the update and P' g in one launch, and psgd_tf_tpu/ops/pallas/
// splu_upd.py `_update_impl` (:636), its routed pallas_calls at :686
// (`_stage1_kernel`), :749 (`_stage2_kernel`) and :787 (`_stage3_kernel`),
// with the corner algebra between them in jnp, and with g its fused apply's
// pallas_calls at :814 (`_stage3_apply_kernel` :258) and :843
// (`_stage4_apply_kernel` :287), reached through `fused_update(g=...)`
// (:913) and `fused_update_stream(g=...)` (:861). Q = L U with
//   L = [L1 0; L2 diag(l3)], U = [U1 U2; 0 diag(u3)],
// stored rank-major at its logical shapes: Lt (r, n) = [L1^T | L2^T],
// U12 (r, n) = [U1 | U2], l3 and u3 (nt,), nt = n - r. Tail lane j is
// column r + j of Lt and U12 and entry j of l3 and u3; the kernels read the
// state in place and mask the ragged last tile: nothing is padded.
//
// The state at n = 65,536 (r = 10) is ~5.2 MB, far past a block's 227 KB of
// shared memory, so both kernels are one fixed chain of launches on one
// stream, with no host synchronisation:
//   stage 1   per lane Z = [L2^T; U2 w; U2; dx2 w; dg2; l3 u3 dg2] (3r + 3
//             rows, w = 1/(l3 u3)); the Gram entries the algebra reads
//             (2r^2 + 5r of them), and max l3, max u3 for the balance;
//   reduce    the blocks' partial Grams summed in block order, a warp a pair;
//   corner A  one warp, lane k holding row k of the rank space: the four
//             r x r triangular solves (substitution, one shuffle a row),
//             Ug1, Qg1, iUtx1, iQtx1, LtQg1, Pg1, iLiQtx1, iPx1, max|gl1|,
//             max|gu1|, and rho = sqrt(max(diag L1, l3) / max(diag U1, u3));
//   stage 2   per lane the tail images (qg2, iqtx2, pg2, ipx2) and the exact
//             maxima of |gl2|, |gl3|, |gu2|, |gu3| (gl2, gu2 never stored);
//   corner B  the step scales min(step / (max + tiny), FLT_MAX), the stage-3
//             coefficients and the corner rewrite L1', U1' (exactly
//             triangular), with the balance folded in;
//   stage 3   L2^T', U2', l3', u3'; with g also the apply Gram's partials of
//             Z2 = [L2^T'; U2'; l3' u3' g2; g2];
//   reduce, corner C, stage 4 (with g): P' g of the updated state.
// The balance rescales L by 1/rho and U by rho; Q, the probe images and the
// step scales do not change, so it folds into the outputs (JAX :765-784).
// K16 is stages 1-3, K15 and the fused apply entry the whole chain
// (ops/hopper/splu_upd.py, splu_one.py); the one-launch kernel runs the same
// stage and corner bodies in one cooperative launch (its note is below the
// host side's helpers). No float atomics: a run repeats itself bit for bit. The
// sharded K16 (JAX splu_upd.py `fused_update(mesh=...)` :914) is the same
// kernels behind four entry points, split at the three reductions that the
// host all-reduces over the ranks holding the tail's other lanes (the end
// of this file).
//
// What bounds it on this card: memory. The update + apply reads Lt, U12
// (their tails), l3, u3, v, h, g and writes the new state and P' g: about
// (4rn + 10n) floats, 13 MB (3.9 us at 3.35 TB/s) at n = 65,536, r = 10;
// the update alone (4rn + 6n), 193 MB (58 us) at 2^20. This version reads
// the tail factors in stages 1, 2 and 3 (and the new ones in stage 4): ~2x
// that, and the Gram sums read shared memory twice per FMA. At small n the
// chain's short launches (six for the update, nine with g) bound it.
//
// Ranks: up to SPLU_MAX_RANK (32) the kernels above, a warp holding a
// rank-space vector and each thread its share of the Gram's pairs; past it
// the host runs the rank-generic chain (splu_update_g, the same C entry
// points, the sharded ones too), with no cap below what device memory sets.
// Its Grams run in kron_dd.cu's grouped GEMM (rank_space.cuh). Its
// scratch: the GEMM's bands, the larger of gram_part_floats for
// z = 3r + 3 and 2r + 2 (at most 256 z^2 floats, a band per >= 256 lanes:
// under 1/256 of the state's 2 r n), the staged rows (r + 3)(n - r)
// (U2 w and three more: about half the state's), the two reduced Grams
// (3r + 3)^2 + (2r + 2)^2, the rank space 19 r + 8 and, past RG_SMEM of
// shared memory (r > ~3200), the corners' workspace 16 r. At n = 2^20
// (H100 80GB HBM3, 700 W, tools/kron_gemm_ab.py --gram and --generic):
// the update 3.35 ms at r = 64, 8.25 at r = 128; the generic chain forced
// at r = 10 runs 2.23 ms against the rank-32 chain's 0.29, which is why
// both stay. The one-launch kernel keeps r <= 32.
#include "psgd.cuh"
#include "rank_space.cuh"

#include <cooperative_groups.h>
#include <cfloat>
#include <cmath>

#define SPLU_TILE 256            // lanes of a tile = threads of a streaming block
#define SPLU_MAX_RANK 32
#define SPLU_LD (SPLU_MAX_RANK + 1)
#define SPLU_MAX_BLOCKS 1024     // grid cap of the streaming passes (bounds the partials)
#define SPLU_MAX_PAIRS1 (2 * SPLU_MAX_RANK * SPLU_MAX_RANK + 5 * SPLU_MAX_RANK)
#define SPLU_MAX_PAIRS2 (SPLU_MAX_RANK * (SPLU_MAX_RANK + 1) / 2 + 2 * SPLU_MAX_RANK)
#define SPLU_PPT1 ((SPLU_MAX_PAIRS1 + SPLU_TILE - 1) / SPLU_TILE)
#define SPLU_PPT2 ((SPLU_MAX_PAIRS2 + SPLU_TILE - 1) / SPLU_TILE)
#define SPLU_NCOEF 8

// the rank-space state passed between the launches (in scratch)
struct SpluRank {
    float coef2[SPLU_MAX_RANK][SPLU_NCOEF];  // Ug1 iUtx1 LtQg1 iLiQtx1 Qg1 iQtx1 Pg1 dx1
    float coef3[SPLU_MAX_RANK][SPLU_NCOEF];  // Ug1 iUtx1 LtQg1 iLiQtx1, sl L1^T Qg1,
                                             // sl L1^T iQtx1, su U1 Pg1, su U1 dx1
    float ipx1[SPLU_MAX_RANK];
    float coef4[SPLU_MAX_RANK][2];           // Ug1', LtQg1' of the apply
    float scal[8];                           // sl, su, 1/rho, rho, max|gl1|, max|gu1|
};

__device__ __forceinline__ float splu_neg_inf() { return __int_as_float(0xff800000); }
__host__ __device__ __forceinline__ int splu_npairs1(int r) { return 2 * r * r + 5 * r; }
__host__ __device__ __forceinline__ int splu_npairs2(int r) { return r * (r + 1) / 2 + 2 * r; }

// the idx-th pair (a <= b) of an r x r symmetric block, row-major
__device__ __forceinline__ void splu_sym(int r, int idx, int& a, int& b) {
    a = 0;
    while (idx >= r - a) {
        idx -= r - a;
        ++a;
    }
    b = a + idx;
}

// The Gram entries the algebra reads, as rows (a, b) of Z.
// which = 1, stage 1: rows L2^T 0..r-1, U2 w r..2r-1, U2 2r..3r-1, dx2 w 3r,
//   dg2 3r+1, l3 u3 dg2 3r+2; pairs (L, L) sym, (L, W) full, (W, W) sym,
//   (L, X), (L, G), (W, X), (U, D).
// which = 2, the apply: rows L2^T' 0..r-1, U2' r..2r-1, l3' u3' g2 2r, g2
//   2r+1; pairs (L', L') sym, (L', l3' u3' g2), (U', g2).
__device__ void splu_pair(int which, int r, int idx, int& a, int& b) {
    const int T = r * (r + 1) / 2;
    if (idx < T) {
        splu_sym(r, idx, a, b);
        return;
    }
    idx -= T;
    if (which == 2) {
        if (idx < r) {
            a = idx;
            b = 2 * r;
        } else {
            a = idx;  // r + (idx - r)
            b = 2 * r + 1;
        }
        return;
    }
    if (idx < r * r) {
        a = idx / r;
        b = r + idx % r;
        return;
    }
    idx -= r * r;
    if (idx < T) {
        splu_sym(r, idx, a, b);
        a += r;
        b += r;
        return;
    }
    idx -= T;
    const int seg = idx / r, i = idx % r;
    if (seg == 0) {
        a = i;
        b = 3 * r;
    } else if (seg == 1) {
        a = i;
        b = 3 * r + 2;
    } else if (seg == 2) {
        a = r + i;
        b = 3 * r;
    } else {
        a = 2 * r + i;
        b = 3 * r + 1;
    }
}

template <int PPT>
struct SpluPairs {
    int a[PPT], b[PPT], count;
};

// this thread's pairs: the k-th is pair threadIdx.x + k * SPLU_TILE
template <int PPT>
__device__ void splu_my_pairs(int which, int r, int npairs, SpluPairs<PPT>& P) {
    P.count = 0;
    for (int idx = threadIdx.x; idx < npairs && P.count < PPT; idx += SPLU_TILE) {
        splu_pair(which, r, idx, P.a[P.count], P.b[P.count]);
        ++P.count;
    }
}

// acc[k] += sum over the tile's lanes of zs[a_k] * zs[b_k]
template <int PPT>
__device__ __forceinline__ void splu_add_pairs(const float* zs, const SpluPairs<PPT>& P, float* acc) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
        if (k >= P.count) break;
        const float* za = zs + P.a[k] * (SPLU_TILE + 1);
        const float* zb = zs + P.b[k] * (SPLU_TILE + 1);
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        for (int l = 0; l < SPLU_TILE; l += 4) {
            s0 += za[l] * zb[l];
            s1 += za[l + 1] * zb[l + 1];
            s2 += za[l + 2] * zb[l + 2];
            s3 += za[l + 3] * zb[l + 3];
        }
        acc[k] += (s0 + s1) + (s2 + s3);
    }
}

// this thread's sums into the block's row `out` of the partials
template <int PPT>
__device__ __forceinline__ void splu_store_pairs(const SpluPairs<PPT>& P, const float* acc, float* out) {
    for (int k = 0; k < P.count; ++k) out[(int)threadIdx.x + k * SPLU_TILE] = acc[k];
}

// max over the block (blockDim == SPLU_TILE); every thread gets the result
__device__ __forceinline__ float splu_block_max(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float m = red[0];
    for (int k = 1; k < SPLU_TILE / 32; ++k) m = fmaxf(m, red[k]);
    return m;
}

// ------------------------------------------------------------------ stage 1
// Each streaming stage is a body for one block b of a grid of nblk: the
// tiles b, b + nblk, ... of the tail, its partials in row b of the
// scratch. A chain kernel runs block blockIdx.x of gridDim.x; the one-launch
// kernel (the end of this file) walks the same blocks with fewer CTAs, so
// both compute the same partials in the same order.

// Block b of stage 1: its partial Gram (row b of part) and max l3, max u3
// (maxpart[2b], [2b + 1]) over the tail lanes below nvalid alone: the lanes
// past it are the 1-padding of a sharded tail (JAX splu_upd.py:928-944).
// zs holds (3r + 3) rows of SPLU_TILE + 1 floats, red SPLU_TILE / 32.
__device__ void splu_stage1_block(int b, int nblk, int n, int r, int nvalid, const float* lt,
                                  const float* l3, const float* u12, const float* u3,
                                  const float* v, const float* h, float* part, float* maxpart,
                                  float* zs, float* red) {
    const int nt = n - r, npairs = splu_npairs1(r), t = threadIdx.x, ld = SPLU_TILE + 1;
    SpluPairs<SPLU_PPT1> P;
    splu_my_pairs(1, r, npairs, P);
    float acc[SPLU_PPT1];
#pragma unroll
    for (int k = 0; k < SPLU_PPT1; ++k) acc[k] = 0.f;
    float ml = splu_neg_inf(), mu = splu_neg_inf();
    for (int base = b * SPLU_TILE; base < nt; base += nblk * SPLU_TILE) {
        const int j = base + t;
        const bool ok = j < nt;
        float w = 0.f, x = 0.f, d = 0.f, lud = 0.f;
        if (ok) {
            const float l = l3[j], u = u3[j], lu = l * u;
            if (j < nvalid) {
                ml = fmaxf(ml, l);
                mu = fmaxf(mu, u);
            }
            w = 1.f / lu;
            x = v[r + j] * w;
            d = h[r + j];
            lud = lu * d;
        }
        for (int k = 0; k < r; ++k) {
            const size_t off = (size_t)k * n + r + j;
            const float lk = ok ? lt[off] : 0.f, uk = ok ? u12[off] : 0.f;
            zs[k * ld + t] = lk;
            zs[(r + k) * ld + t] = uk * w;
            zs[(2 * r + k) * ld + t] = uk;
        }
        zs[3 * r * ld + t] = x;
        zs[(3 * r + 1) * ld + t] = d;
        zs[(3 * r + 2) * ld + t] = lud;
        __syncthreads();
        splu_add_pairs(zs, P, acc);
        __syncthreads();
    }
    splu_store_pairs(P, acc, part + (size_t)b * npairs);
    ml = splu_block_max(ml, red);
    mu = splu_block_max(mu, red);
    if (t == 0) {
        maxpart[2 * b] = ml;
        maxpart[2 * b + 1] = mu;
    }
}

__global__ void __launch_bounds__(SPLU_TILE) splu_stage1_kernel(
    int n, int r, int nvalid, const float* __restrict__ lt, const float* __restrict__ l3,
    const float* __restrict__ u12, const float* __restrict__ u3, const float* __restrict__ v,
    const float* __restrict__ h, float* __restrict__ part, float* __restrict__ maxpart) {
    extern __shared__ float zs[];
    __shared__ float red[SPLU_TILE / 32];
    splu_stage1_block(blockIdx.x, gridDim.x, n, r, nvalid, lt, l3, u12, u3, v, h, part, maxpart,
                      zs, red);
}

// gram[a, b] = gram[b, a] = the sum over blocks, in block order, of pair
// e = (a, b); called by one whole warp
__device__ void splu_reduce_pair(int which, int r, int zdim, int npairs, int blocks, int e,
                                 const float* part, float* gram) {
    const int lane = threadIdx.x & 31;
    float s = 0.f;
    for (int k = lane; k < blocks; k += 32) s += part[(size_t)k * npairs + e];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) {
        int a, b;
        splu_pair(which, r, e, a, b);
        gram[a * zdim + b] = s;
        gram[b * zdim + a] = s;
    }
}

// one warp a pair
__global__ void __launch_bounds__(256) splu_reduce_kernel(int which, int r, int zdim, int npairs,
                                                          int blocks, const float* __restrict__ part,
                                                          float* __restrict__ gram) {
    const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (e >= npairs) return;  // uniform across the warp
    splu_reduce_pair(which, r, zdim, npairs, blocks, e, part, gram);
}

// out[w] = the max over blocks of maxpart[2 b + w], w = 0, 1; one warp
__global__ void __launch_bounds__(32) splu_maxfold_kernel(int blocks, float init,
                                                          const float* __restrict__ maxpart,
                                                          float* __restrict__ out) {
    float a = init, b = init;
    for (int k = threadIdx.x; k < blocks; k += 32) {
        a = fmaxf(a, maxpart[2 * k]);
        b = fmaxf(b, maxpart[2 * k + 1]);
    }
    for (int o = 16; o > 0; o >>= 1) {
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
        b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
    }
    if (threadIdx.x == 0) {
        out[0] = a;
        out[1] = b;
    }
}

// ------------------------------------------------------------ corner kernels
// One warp; lane k holds entry k of every rank-space vector (0 past r). Each
// corner body takes its shared arrays from a workspace `ws` (a static array
// in its chain kernel, the dynamic buffer in the one-launch kernel) and
// synchronises with __syncwarp alone.

typedef float SpluSq[SPLU_LD];  // a row of an r x r corner block in shared memory
#define SPLU_SQ (SPLU_MAX_RANK * SPLU_LD)
#define SPLU_CORNER_A (5 * SPLU_SQ + 7 * 32)
#define SPLU_CORNER_B (2 * SPLU_SQ + 7 * 32)
#define SPLU_CORNER_C (3 * SPLU_SQ + 32)

// y_k = sum_j M(k, j) x_j, M = A or A^T (trans); x shared through buf
__device__ float splu_mv(const float (*A)[SPLU_LD], bool trans, float x, int r, float* buf) {
    const int k = threadIdx.x;
    __syncwarp();
    buf[k] = x;
    __syncwarp();
    float s = 0.f;
    if (k < r)
        for (int j = 0; j < r; ++j) s += (trans ? A[j][k] : A[k][j]) * buf[j];
    return s;
}

// Solve M y = b, M = A or A^T (trans), lower (forward) or upper (backward)
// triangular; lane k holds b_k and gets y_k. Row i's y_i is final once the
// rows before it are folded in; the lanes below it then subtract it.
__device__ float splu_solve(const float (*A)[SPLU_LD], bool trans, bool lower, float b, int r) {
    const int k = threadIdx.x;
    float y = 0.f;
    for (int s = 0; s < r; ++s) {
        const int i = lower ? s : r - 1 - s;
        const float yi = __shfl_sync(0xffffffffu, b, i) / A[i][i];
        if (k == i) y = yi;
        if (k < r && (lower ? k > i : k < i)) b -= (trans ? A[i][k] : A[k][i]) * yi;
    }
    return y;
}

__device__ __forceinline__ float splu_warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// L1 (lower) and U1 (upper) of an (r, n) pair into shared memory:
// L1[i][j] = lt[j, i], U1[i][j] = u12[i, j]
__device__ void splu_load_corner(int n, int r, const float* lt, const float* u12,
                                 float (*L1)[SPLU_LD], float (*U1)[SPLU_LD]) {
    for (int e = threadIdx.x; e < r * r; e += 32) {
        const int i = e / r, j = e % r;
        L1[i][j] = lt[(size_t)j * n + i];
        U1[i][j] = u12[(size_t)i * n + j];
    }
    __syncwarp();
}

// ws: SPLU_CORNER_A floats
__device__ void splu_corner_a(int n, int r, int blocks, const float* lt, const float* u12,
                              const float* v, const float* h, const float* gram,
                              const float* maxpart, SpluRank* rk, float* ws) {
    SpluSq *L1 = reinterpret_cast<SpluSq*>(ws), *U1 = L1 + SPLU_MAX_RANK;
    SpluSq *GLW = U1 + SPLU_MAX_RANK, *GLL = GLW + SPLU_MAX_RANK, *GWW = GLL + SPLU_MAX_RANK;
    float* buf = ws + 5 * SPLU_SQ;
    float *vq = buf + 32, *viq = vq + 32, *vpg = viq + 32, *vdg = vpg + 32, *vdx = vdg + 32,
          *vipx = vdx + 32;
    const int k = threadIdx.x, zdim = 3 * r + 3;
    const bool on = k < r;
    splu_load_corner(n, r, lt, u12, L1, U1);
    for (int e = k; e < r * r; e += 32) {
        const int i = e / r, j = e % r;
        GLW[i][j] = gram[i * zdim + r + j];
        GLL[i][j] = gram[i * zdim + j];
        GWW[i][j] = gram[(r + i) * zdim + r + j];
    }
    __syncwarp();
    const float dx1 = on ? v[k] : 0.f, dg1 = on ? h[k] : 0.f;
    const float U2_dg = on ? gram[(2 * r + k) * zdim + 3 * r + 1] : 0.f;
    const float L2t_dxw = on ? gram[k * zdim + 3 * r] : 0.f;
    const float L2t_lug = on ? gram[k * zdim + 3 * r + 2] : 0.f;
    const float U2_w2dx = on ? gram[(r + k) * zdim + 3 * r] : 0.f;

    const float Ug1 = splu_mv(U1, false, dg1, r, buf) + U2_dg;
    const float Qg1 = splu_mv(L1, false, Ug1, r, buf);
    const float iUtx1 = splu_solve(U1, true, true, dx1, r);
    const float L2t_iqtx2 = L2t_dxw - splu_mv(GLW, false, iUtx1, r, buf);
    const float iQtx1 = splu_solve(L1, true, false, iUtx1 - L2t_iqtx2, r);
    const float L2t_qg2 = splu_mv(GLL, false, Ug1, r, buf) + L2t_lug;
    const float LtQg1 = splu_mv(L1, true, Qg1, r, buf) + L2t_qg2;
    const float Pg1 = splu_mv(U1, true, LtQg1, r, buf);
    const float iLiQtx1 = splu_solve(L1, false, true, iQtx1, r);
    const float U2_ipx2 =
        (U2_w2dx - splu_mv(GWW, false, iUtx1, r, buf)) - splu_mv(GLW, true, iLiQtx1, r, buf);
    const float iPx1 = splu_solve(U1, false, false, iLiQtx1 - U2_ipx2, r);

    // max|gl1| over the lower triangle, max|gu1| over the upper (row k)
    vq[k] = Qg1;
    viq[k] = iQtx1;
    vpg[k] = Pg1;
    vdg[k] = dg1;
    vdx[k] = dx1;
    vipx[k] = iPx1;
    __syncwarp();
    float gl = 0.f, gu = 0.f;
    if (on) {
        for (int j = 0; j <= k; ++j) gl = fmaxf(gl, fabsf(vq[k] * vq[j] - viq[k] * viq[j]));
        for (int j = k; j < r; ++j) gu = fmaxf(gu, fabsf(vpg[k] * vdg[j] - vdx[k] * vipx[j]));
    }
    gl = splu_warp_max(gl);
    gu = splu_warp_max(gu);

    // the balance from the signed maxima of diag(L1) ∪ l3 and diag(U1) ∪ u3
    float ml = on ? L1[k][k] : splu_neg_inf(), mu = on ? U1[k][k] : splu_neg_inf();
    for (int b = k; b < blocks; b += 32) {
        ml = fmaxf(ml, maxpart[2 * b]);
        mu = fmaxf(mu, maxpart[2 * b + 1]);
    }
    ml = splu_warp_max(ml);
    mu = splu_warp_max(mu);
    if (on) {
        float* c = rk->coef2[k];
        c[0] = Ug1;
        c[1] = iUtx1;
        c[2] = LtQg1;
        c[3] = iLiQtx1;
        c[4] = Qg1;
        c[5] = iQtx1;
        c[6] = Pg1;
        c[7] = dx1;
        rk->ipx1[k] = iPx1;
    }
    if (k == 0) {
        const float rho = sqrtf(ml / mu);
        rk->scal[2] = 1.f / rho;
        rk->scal[3] = rho;
        rk->scal[4] = gl;
        rk->scal[5] = gu;
    }
}

__global__ void __launch_bounds__(32) splu_corner_a_kernel(
    int n, int r, int blocks, const float* __restrict__ lt, const float* __restrict__ u12,
    const float* __restrict__ v, const float* __restrict__ h, const float* __restrict__ gram,
    const float* __restrict__ maxpart, SpluRank* __restrict__ rk) {
    __shared__ float ws[SPLU_CORNER_A];
    splu_corner_a(n, r, blocks, lt, u12, v, h, gram, maxpart, rk, ws);
}

// ------------------------------------------------------------------ stage 2

// c[k][q] = src[k][q] for the r rows, by the block's SPLU_TILE threads (no barrier)
template <int W>
__device__ void splu_load_coef(float (*c)[W], const float (*src)[W], int r) {
    for (int e = threadIdx.x; e < r * W; e += SPLU_TILE) c[e / W][e % W] = src[e / W][e % W];
}

__device__ __forceinline__ void splu_images(int n, int r, int j, const float* __restrict__ lt,
                                            const float* __restrict__ u12, float lu, float w,
                                            float dx, float dg, const float (*c)[SPLU_NCOEF],
                                            float& qg2, float& iqtx2, float& pg2, float& ipx2) {
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
    for (int k = 0; k < r; ++k) {
        const size_t off = (size_t)k * n + r + j;
        const float lk = lt[off], uk = u12[off];
        p0 += c[k][0] * lk;
        p1 += c[k][1] * uk;
        p2 += c[k][2] * uk;
        p3 += c[k][3] * lk;
    }
    qg2 = p0 + lu * dg;
    iqtx2 = w * (dx - p1);
    pg2 = p2 + lu * qg2;
    ipx2 = w * (iqtx2 - p3);
}

// Block b of stage 2: max(|gl2|, |gl3|), max(|gu2|, |gu3|) over its lanes
// into maxpart[2b], [2b + 1]; c = coef2 in shared memory
__device__ void splu_stage2_block(int b, int nblk, int n, int r, const float* lt, const float* l3,
                                  const float* u12, const float* u3, const float* v,
                                  const float* h, const float (*c)[SPLU_NCOEF], float* maxpart,
                                  float* red) {
    const int nt = n - r;
    float ml = 0.f, mu = 0.f;
    for (int j = b * SPLU_TILE + threadIdx.x; j < nt; j += nblk * SPLU_TILE) {
        const float lu = l3[j] * u3[j], w = 1.f / lu, dx = v[r + j], dg = h[r + j];
        float qg2, iqtx2, pg2, ipx2;
        splu_images(n, r, j, lt, u12, lu, w, dx, dg, c, qg2, iqtx2, pg2, ipx2);
        ml = fmaxf(ml, fabsf(qg2 * qg2 - iqtx2 * iqtx2));
        mu = fmaxf(mu, fabsf(pg2 * dg - dx * ipx2));
        for (int k = 0; k < r; ++k) {
            ml = fmaxf(ml, fabsf(c[k][4] * qg2 - c[k][5] * iqtx2));
            mu = fmaxf(mu, fabsf(c[k][6] * dg - c[k][7] * ipx2));
        }
    }
    ml = splu_block_max(ml, red);
    mu = splu_block_max(mu, red);
    if (threadIdx.x == 0) {
        maxpart[2 * b] = ml;
        maxpart[2 * b + 1] = mu;
    }
}

__global__ void __launch_bounds__(SPLU_TILE) splu_stage2_kernel(
    int n, int r, const float* __restrict__ lt, const float* __restrict__ l3,
    const float* __restrict__ u12, const float* __restrict__ u3, const float* __restrict__ v,
    const float* __restrict__ h, const SpluRank* __restrict__ rk, float* __restrict__ maxpart) {
    __shared__ float c[SPLU_MAX_RANK][SPLU_NCOEF];
    __shared__ float red[SPLU_TILE / 32];
    splu_load_coef(c, rk->coef2, r);
    __syncthreads();
    splu_stage2_block(blockIdx.x, gridDim.x, n, r, lt, l3, u12, u3, v, h, c, maxpart, red);
}

// ----------------------------------------------------------------- corner B

// ws: SPLU_CORNER_B floats
__device__ void splu_corner_b(int n, int r, int blocks, float step, const float* lt,
                              const float* u12, const float* h, const float* maxpart, SpluRank* rk,
                              float* lt_out, float* u12_out, float* ws) {
    SpluSq *L1 = reinterpret_cast<SpluSq*>(ws), *U1 = L1 + SPLU_MAX_RANK;
    float* buf = ws + 2 * SPLU_SQ;
    float *vq = buf + 32, *viq = vq + 32, *vpg = viq + 32, *vdg = vpg + 32, *vdx = vdg + 32,
          *vipx = vdx + 32;
    const int k = threadIdx.x;
    const bool on = k < r;
    splu_load_corner(n, r, lt, u12, L1, U1);
    float ml = 0.f, mu = 0.f;
    for (int b = k; b < blocks; b += 32) {
        ml = fmaxf(ml, maxpart[2 * b]);
        mu = fmaxf(mu, maxpart[2 * b + 1]);
    }
    ml = fmaxf(splu_warp_max(ml), rk->scal[4]);
    mu = fmaxf(splu_warp_max(mu), rk->scal[5]);
    const float sl = fminf(step / (ml + psgd_tiny()), FLT_MAX);
    const float su = fminf(step / (mu + psgd_tiny()), FLT_MAX);
    const float inv_rho = rk->scal[2], rho = rk->scal[3];

    float c[SPLU_NCOEF] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (on)
        for (int q = 0; q < SPLU_NCOEF; ++q) c[q] = rk->coef2[k][q];
    const float ipx = on ? rk->ipx1[k] : 0.f, dg1 = on ? h[k] : 0.f;
    vq[k] = c[4];
    viq[k] = c[5];
    vpg[k] = c[6];
    vdx[k] = c[7];
    vipx[k] = ipx;
    vdg[k] = dg1;
    const float c4 = sl * splu_mv(L1, true, c[4], r, buf);
    const float c5 = sl * splu_mv(L1, true, c[5], r, buf);
    const float c6 = su * splu_mv(U1, false, c[6], r, buf);
    const float c7 = su * splu_mv(U1, false, c[7], r, buf);
    __syncwarp();
    if (on) {
        float* o = rk->coef3[k];
        o[0] = c[0];
        o[1] = c[1];
        o[2] = c[2];
        o[3] = c[3];
        o[4] = c4;
        o[5] = c5;
        o[6] = c6;
        o[7] = c7;
        // row k of L1' = (L1 - sl gl1 L1) / rho, gl1 = tril(Qg1 Qg1^T - iQtx1 iQtx1^T),
        // stored as column k of Lt's corner; exact zeros above the diagonal
        for (int j = 0; j < r; ++j) {
            float y = 0.f;
            if (j <= k) {
                float s = 0.f;
                for (int q = 0; q <= k; ++q) s += (vq[k] * vq[q] - viq[k] * viq[q]) * L1[q][j];
                y = inv_rho * (L1[k][j] - sl * s);
            }
            lt_out[(size_t)j * n + k] = y;
        }
        // row k of U1' = rho (U1 - su U1 gu1), gu1 = triu(Pg1 dg1^T - dx1 iPx1^T)
        for (int j = 0; j < r; ++j) {
            float y = 0.f;
            if (j >= k) {
                float s = 0.f;
                for (int q = 0; q <= j; ++q) s += U1[k][q] * (vpg[q] * vdg[j] - vdx[q] * vipx[j]);
                y = rho * (U1[k][j] - su * s);
            }
            u12_out[(size_t)k * n + j] = y;
        }
    }
    if (k == 0) {
        rk->scal[0] = sl;
        rk->scal[1] = su;
    }
}

__global__ void __launch_bounds__(32) splu_corner_b_kernel(
    int n, int r, int blocks, float step, const float* __restrict__ lt,
    const float* __restrict__ u12, const float* __restrict__ h, const float* __restrict__ maxpart,
    SpluRank* __restrict__ rk, float* __restrict__ lt_out, float* __restrict__ u12_out) {
    __shared__ float ws[SPLU_CORNER_B];
    splu_corner_b(n, r, blocks, step, lt, u12, h, maxpart, rk, lt_out, u12_out, ws);
}

// ------------------------------------------------------------------ stage 3

// Block b of stage 3: the new tail of its lanes; with g also its partial
// apply Gram (row b of part). c = coef3 in shared memory, zs (2r + 2) rows
// of SPLU_TILE + 1 floats.
__device__ void splu_stage3_block(int b, int nblk, int n, int r, const float* lt, const float* l3,
                                  const float* u12, const float* u3, const float* v,
                                  const float* h, const float* g, const float (*c)[SPLU_NCOEF],
                                  float sl, float su, float inv_rho, float rho, float* lt_out,
                                  float* l3_out, float* u12_out, float* u3_out, float* part,
                                  float* zs) {
    const int t = threadIdx.x, nt = n - r, ld = SPLU_TILE + 1, npairs = splu_npairs2(r);
    SpluPairs<SPLU_PPT2> P;
    P.count = 0;
    if (g) splu_my_pairs(2, r, npairs, P);
    float acc[SPLU_PPT2];
#pragma unroll
    for (int k = 0; k < SPLU_PPT2; ++k) acc[k] = 0.f;
    for (int base = b * SPLU_TILE; base < nt; base += nblk * SPLU_TILE) {
        const int j = base + t;
        if (j < nt) {
            const float l = l3[j], u = u3[j], lu = l * u, w = 1.f / lu, dx = v[r + j], dg = h[r + j];
            float qg2, iqtx2, pg2, ipx2;
            splu_images(n, r, j, lt, u12, lu, w, dx, dg, c, qg2, iqtx2, pg2, ipx2);
            const float gl3 = qg2 * qg2 - iqtx2 * iqtx2, gu3 = pg2 * dg - dx * ipx2;
            for (int k = 0; k < r; ++k) {
                const size_t off = (size_t)k * n + r + j;
                const float lk = lt[off], uk = u12[off];
                const float nl = inv_rho * (lk - (c[k][4] * qg2 - c[k][5] * iqtx2) - sl * gl3 * lk);
                const float nu = rho * (uk - (c[k][6] * dg - c[k][7] * ipx2) - su * gu3 * uk);
                lt_out[off] = nl;
                u12_out[off] = nu;
                if (g) {
                    zs[k * ld + t] = nl;
                    zs[(r + k) * ld + t] = nu;
                }
            }
            const float nl3 = inv_rho * (l - sl * gl3 * l), nu3 = rho * (u - su * gu3 * u);
            l3_out[j] = nl3;
            u3_out[j] = nu3;
            if (g) {
                const float gj = g[r + j];
                zs[2 * r * ld + t] = nl3 * nu3 * gj;
                zs[(2 * r + 1) * ld + t] = gj;
            }
        } else if (g) {
            for (int k = 0; k < 2 * r + 2; ++k) zs[k * ld + t] = 0.f;
        }
        if (g) {
            __syncthreads();
            splu_add_pairs(zs, P, acc);
            __syncthreads();
        }
    }
    if (g) splu_store_pairs(P, acc, part + (size_t)b * npairs);
}

__global__ void __launch_bounds__(SPLU_TILE) splu_stage3_kernel(
    int n, int r, const float* __restrict__ lt, const float* __restrict__ l3,
    const float* __restrict__ u12, const float* __restrict__ u3, const float* __restrict__ v,
    const float* __restrict__ h, const float* __restrict__ g, const SpluRank* __restrict__ rk,
    float* __restrict__ lt_out, float* __restrict__ l3_out, float* __restrict__ u12_out,
    float* __restrict__ u3_out, float* __restrict__ part) {
    extern __shared__ float zs[];
    __shared__ float c[SPLU_MAX_RANK][SPLU_NCOEF];
    splu_load_coef(c, rk->coef3, r);
    __syncthreads();
    splu_stage3_block(blockIdx.x, gridDim.x, n, r, lt, l3, u12, u3, v, h, g, c, rk->scal[0],
                      rk->scal[1], rk->scal[2], rk->scal[3], lt_out, l3_out, u12_out, u3_out, part,
                      zs);
}

// ------------------------------------------------------- corner C, stage 4

// ws: SPLU_CORNER_C floats
__device__ void splu_corner_c(int n, int r, const float* lt_out, const float* u12_out,
                              const float* g, const float* gram2, SpluRank* rk, float* pre,
                              float* ws) {
    SpluSq *L1 = reinterpret_cast<SpluSq*>(ws), *U1 = L1 + SPLU_MAX_RANK, *GLL = U1 + SPLU_MAX_RANK;
    float* buf = ws + 3 * SPLU_SQ;
    const int k = threadIdx.x, zdim = 2 * r + 2;
    const bool on = k < r;
    splu_load_corner(n, r, lt_out, u12_out, L1, U1);
    for (int e = k; e < r * r; e += 32) GLL[e / r][e % r] = gram2[(e / r) * zdim + e % r];
    __syncwarp();
    const float g1 = on ? g[k] : 0.f;
    const float U2g = on ? gram2[(r + k) * zdim + 2 * r + 1] : 0.f;
    const float L2lug = on ? gram2[k * zdim + 2 * r] : 0.f;
    const float Ug1 = splu_mv(U1, false, g1, r, buf) + U2g;
    const float Qg1 = splu_mv(L1, false, Ug1, r, buf);
    const float LtQg1 = splu_mv(L1, true, Qg1, r, buf) + splu_mv(GLL, false, Ug1, r, buf) + L2lug;
    const float pre1 = splu_mv(U1, true, LtQg1, r, buf);
    if (on) {
        pre[k] = pre1;
        rk->coef4[k][0] = Ug1;
        rk->coef4[k][1] = LtQg1;
    }
}

__global__ void __launch_bounds__(32) splu_corner_c_kernel(
    int n, int r, const float* __restrict__ lt_out, const float* __restrict__ u12_out,
    const float* __restrict__ g, const float* __restrict__ gram2, SpluRank* __restrict__ rk,
    float* __restrict__ pre) {
    __shared__ float ws[SPLU_CORNER_C];
    splu_corner_c(n, r, lt_out, u12_out, g, gram2, rk, pre, ws);
}

// tail lane j of P' g: U2'^T LtQg1' + l3' u3' (L2' Ug1' + l3' u3' g2); c = coef4
__device__ __forceinline__ void splu_stage4_lane(int j, int n, int r, const float (*c)[2],
                                                 const float* lt_out, const float* l3_out,
                                                 const float* u12_out, const float* u3_out,
                                                 const float* g, float* pre) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < r; ++k) {
        const size_t off = (size_t)k * n + r + j;
        a += c[k][0] * lt_out[off];
        b += c[k][1] * u12_out[off];
    }
    const float lu = l3_out[j] * u3_out[j];
    pre[r + j] = b + lu * (a + lu * g[r + j]);
}

__global__ void __launch_bounds__(SPLU_TILE) splu_stage4_kernel(
    int n, int r, const float* __restrict__ lt_out, const float* __restrict__ l3_out,
    const float* __restrict__ u12_out, const float* __restrict__ u3_out,
    const float* __restrict__ g, const SpluRank* __restrict__ rk, float* __restrict__ pre) {
    __shared__ float c[SPLU_MAX_RANK][2];
    splu_load_coef(c, rk->coef4, r);
    __syncthreads();
    const int j = blockIdx.x * SPLU_TILE + threadIdx.x;
    if (j >= n - r) return;
    splu_stage4_lane(j, n, r, c, lt_out, l3_out, u12_out, u3_out, g, pre);
}

// ------------------------------------------------ any rank: the generic chain
// Past SPLU_MAX_RANK the host runs the same chain with the rank-generic
// pieces of rank_space.cuh: stage 1's Gram through the grouped GEMM
// (gram_launch) over the tail lanes of Z = [L2^T; U2 w; U2; dx2 w; dg2;
// l3 u3 dg2], the upper triangle over [L2^T; U2 w] and the first 3r rows
// against the last three, L2^T and U2 read in place and U2 w and the last
// three rows staged by splu_rows_kernel; max l3, max u3 in a pass of
// their own; the corners on one block with the rank-space vectors strided
// over its threads; stages 2-4 reading their coefficients in place (the
// same block bodies as the chain's); and the apply's Gram over the new
// tail, Z = [L2^T'; U2'; l3' u3' g2; g2], after stage 3.

// The rows of a Gram the state does not hold, over the tail lanes j < nt:
// stage 1's (g null) w (r, nt) = U2 w and e (3, nt) = [dx2 w; dg2;
// l3 u3 dg2], w = 1 / (l3 u3); the apply's e (2, nt) = [l3 u3 g2; g2]
__global__ void __launch_bounds__(SPLU_TILE) splu_rows_kernel(int n, int r,
                                                              const float* __restrict__ l3,
                                                              const float* __restrict__ u12,
                                                              const float* __restrict__ u3,
                                                              const float* __restrict__ v,
                                                              const float* __restrict__ h,
                                                              const float* __restrict__ g,
                                                              float* __restrict__ w,
                                                              float* __restrict__ e) {
    const int nt = n - r, j = blockIdx.x * SPLU_TILE + threadIdx.x;
    if (j >= nt) return;
    const size_t off = (size_t)r + j;
    if (g) {
        e[j] = l3[j] * u3[j] * g[off];
        e[(size_t)nt + j] = g[off];
        return;
    }
    const float lu = l3[j] * u3[j], wj = 1.f / lu;
    for (int k = 0; k < r; ++k) w[(size_t)k * nt + j] = u12[(size_t)k * n + off] * wj;
    e[j] = v[off] * wj;
    e[(size_t)nt + j] = h[off];
    e[2 * (size_t)nt + j] = lu * h[off];
}

// stage 1's Gram (3r + 3, 3r + 3): L2^T and U2 (rows n apart from column
// r) read in place, U2 w (w) and the last three rows (e) staged
static GramPlan splu_gram1_plan(int n, int r, const float* lt, const float* u12, const float* w,
                                const float* e) {
    const int nt = n - r;
    const float *ltt = lt ? lt + r : nullptr, *ut = u12 ? u12 + r : nullptr;
    GramPlan p = gram_plan(3 * r + 3, nt);
    gram_add(p, ltt, n, 0, r, ltt, n, 0, r);
    gram_add(p, ltt, n, 0, r, w, nt, r, r);
    gram_add(p, w, nt, r, r, w, nt, r, r);
    gram_add(p, ltt, n, 0, r, e, nt, 3 * r, 3);
    gram_add(p, w, nt, r, r, e, nt, 3 * r, 3);
    gram_add(p, ut, n, 2 * r, r, e, nt, 3 * r, 3);
    return p;
}

// the apply's Gram (2r + 2, 2r + 2) over the new tail: the upper triangle
// of L2^T' and the first 2r rows against the two staged ones (e)
static GramPlan splu_gram2_plan(int n, int r, const float* lt, const float* u12, const float* e) {
    const int nt = n - r;
    const float *ltt = lt ? lt + r : nullptr, *ut = u12 ? u12 + r : nullptr;
    GramPlan p = gram_plan(2 * r + 2, nt);
    gram_add(p, ltt, n, 0, r, ltt, n, 0, r);
    gram_add(p, ltt, n, 0, r, e, nt, 2 * r, 2);
    gram_add(p, ut, n, r, r, e, nt, 2 * r, 2);
    return p;
}

// Block b of a grid of nblk: max l3, max u3 over its tail lanes below
// nvalid (maxpart[2b], [2b + 1]; -inf where it has none)
__global__ void __launch_bounds__(SPLU_TILE) splu_lumax_kernel(int nt, int nvalid,
                                                               const float* __restrict__ l3,
                                                               const float* __restrict__ u3,
                                                               float* __restrict__ maxpart) {
    __shared__ float red[SPLU_TILE / 32];
    float ml = splu_neg_inf(), mu = splu_neg_inf();
    for (int j = blockIdx.x * SPLU_TILE + threadIdx.x; j < nt && j < nvalid;
         j += gridDim.x * SPLU_TILE) {
        ml = fmaxf(ml, l3[j]);
        mu = fmaxf(mu, u3[j]);
    }
    ml = splu_block_max(ml, red);
    mu = splu_block_max(mu, red);
    if (threadIdx.x == 0) {
        maxpart[2 * blockIdx.x] = ml;
        maxpart[2 * blockIdx.x + 1] = mu;
    }
}

// the generic chain's rank space (in the scratch): coef2, coef3 (r, 8),
// ipx1 (r,), coef4 (r, 2), scal (8,) as in SpluRank
struct SpluRankG {
    float *coef2, *coef3, *ipx1, *coef4, *scal;
};

#define SPLU_GVECS 16
static size_t splu_corner_floats(int r) { return (size_t)SPLU_GVECS * r; }

// Corner A on any rank: corner A's algebra (splu_corner_a), its vectors in
// dynamic shared memory or in ws (in_smem = 0)
__global__ void __launch_bounds__(RG_THREADS) splu_corner_a_g_kernel(
    int n, int r, int blocks, const float* __restrict__ lt, const float* __restrict__ u12,
    const float* __restrict__ v, const float* __restrict__ h, const float* __restrict__ gram,
    const float* __restrict__ maxpart, SpluRankG rk, float* ws, int in_smem) {
    extern __shared__ float sm[];
    __shared__ float red[RG_THREADS / 32];
    float* b = in_smem ? sm : ws;
    const int z = 3 * r + 3;
    float *dx1 = b, *dg1 = b + r, *Ug1 = b + 2 * r, *Qg1 = b + 3 * r, *iUtx1 = b + 4 * r,
          *iQtx1 = b + 5 * r, *LtQg1 = b + 6 * r, *Pg1 = b + 7 * r, *iLiQtx1 = b + 8 * r,
          *iPx1 = b + 9 * r, *w1 = b + 10 * r, *w2 = b + 11 * r;
    const RMat L1{lt, 1, n}, U1{u12, n, 1};  // L1[i][j] = lt[j, i], U1[i][j] = u12[i, j]
    const RMat GLW{gram + r, z, 1}, GLL{gram, z, 1}, GWW{gram + (size_t)r * z + r, z, 1};
    RG_FOR(k, r) {
        dx1[k] = v[k];
        dg1[k] = h[k];
    }
    rg_mv(Ug1, U1, dg1, r);
    RG_FOR(k, r) Ug1[k] += gram[(size_t)(2 * r + k) * z + 3 * r + 1];
    rg_mv(Qg1, L1, Ug1, r);
    RG_FOR(k, r) iUtx1[k] = dx1[k];
    rg_solve(iUtx1, U1.t(), true, r);
    rg_mv(w1, GLW, iUtx1, r);
    RG_FOR(k, r) iQtx1[k] = iUtx1[k] - (gram[(size_t)k * z + 3 * r] - w1[k]);
    rg_solve(iQtx1, L1.t(), false, r);
    rg_mv(w1, GLL, Ug1, r);
    rg_mv(LtQg1, L1.t(), Qg1, r);
    RG_FOR(k, r) LtQg1[k] += w1[k] + gram[(size_t)k * z + 3 * r + 2];
    rg_mv(Pg1, U1.t(), LtQg1, r);
    RG_FOR(k, r) iLiQtx1[k] = iQtx1[k];
    rg_solve(iLiQtx1, L1, true, r);
    rg_mv(w1, GWW, iUtx1, r);
    rg_mv(w2, GLW.t(), iLiQtx1, r);
    RG_FOR(k, r) iPx1[k] = iLiQtx1[k] - ((gram[(size_t)(r + k) * z + 3 * r] - w1[k]) - w2[k]);
    rg_solve(iPx1, U1, false, r);

    // max|gl1| over the lower triangle, max|gu1| over the upper; the balance
    // from the signed maxima of diag(L1) and l3, diag(U1) and u3
    float gl = 0.f, gu = 0.f, ml = splu_neg_inf(), mu = splu_neg_inf();
    RG_FOR(k, r) {
        for (int j = 0; j <= k; ++j) gl = fmaxf(gl, fabsf(Qg1[k] * Qg1[j] - iQtx1[k] * iQtx1[j]));
        for (int j = k; j < r; ++j) gu = fmaxf(gu, fabsf(Pg1[k] * dg1[j] - dx1[k] * iPx1[j]));
        ml = fmaxf(ml, L1(k, k));
        mu = fmaxf(mu, U1(k, k));
    }
    for (int q = threadIdx.x; q < blocks; q += RG_THREADS) {
        ml = fmaxf(ml, maxpart[2 * q]);
        mu = fmaxf(mu, maxpart[2 * q + 1]);
    }
    gl = rg_reduce(gl, 1, red);
    gu = rg_reduce(gu, 1, red);
    ml = rg_reduce(ml, 1, red);
    mu = rg_reduce(mu, 1, red);
    RG_FOR(k, r) {
        float* c = rk.coef2 + (size_t)k * SPLU_NCOEF;
        c[0] = Ug1[k];
        c[1] = iUtx1[k];
        c[2] = LtQg1[k];
        c[3] = iLiQtx1[k];
        c[4] = Qg1[k];
        c[5] = iQtx1[k];
        c[6] = Pg1[k];
        c[7] = dx1[k];
        rk.ipx1[k] = iPx1[k];
    }
    if (threadIdx.x == 0) {
        const float rho = sqrtf(ml / mu);
        rk.scal[2] = 1.f / rho;
        rk.scal[3] = rho;
        rk.scal[4] = gl;
        rk.scal[5] = gu;
    }
}

// Corner B on any rank (splu_corner_b): the step scales, coef3 and the
// balanced corner rewrite L1', U1', one output entry a thread
__global__ void __launch_bounds__(RG_THREADS) splu_corner_b_g_kernel(
    int n, int r, int blocks, float step, const float* __restrict__ lt,
    const float* __restrict__ u12, const float* __restrict__ h, const float* __restrict__ maxpart,
    SpluRankG rk, float* __restrict__ lt_out, float* __restrict__ u12_out, float* ws,
    int in_smem) {
    extern __shared__ float sm[];
    __shared__ float red[RG_THREADS / 32];
    float* b = in_smem ? sm : ws;
    float *vq = b, *viq = b + r, *vpg = b + 2 * r, *vdx = b + 3 * r, *vipx = b + 4 * r,
          *vdg = b + 5 * r, *c4 = b + 6 * r, *c5 = b + 7 * r, *c6 = b + 8 * r, *c7 = b + 9 * r;
    const RMat L1{lt, 1, n}, U1{u12, n, 1};
    float ml = 0.f, mu = 0.f;
    for (int q = threadIdx.x; q < blocks; q += RG_THREADS) {
        ml = fmaxf(ml, maxpart[2 * q]);
        mu = fmaxf(mu, maxpart[2 * q + 1]);
    }
    ml = fmaxf(rg_reduce(ml, 1, red), rk.scal[4]);
    mu = fmaxf(rg_reduce(mu, 1, red), rk.scal[5]);
    const float sl = fminf(step / (ml + psgd_tiny()), FLT_MAX);
    const float su = fminf(step / (mu + psgd_tiny()), FLT_MAX);
    const float inv_rho = rk.scal[2], rho = rk.scal[3];
    RG_FOR(k, r) {
        const float* c = rk.coef2 + (size_t)k * SPLU_NCOEF;
        vq[k] = c[4];
        viq[k] = c[5];
        vpg[k] = c[6];
        vdx[k] = c[7];
        vipx[k] = rk.ipx1[k];
        vdg[k] = h[k];
    }
    rg_mv(c4, L1.t(), vq, r);
    rg_mv(c5, L1.t(), viq, r);
    rg_mv(c6, U1, vpg, r);
    rg_mv(c7, U1, vdx, r);
    RG_FOR(k, r) {
        const float* c = rk.coef2 + (size_t)k * SPLU_NCOEF;
        float* o = rk.coef3 + (size_t)k * SPLU_NCOEF;
        o[0] = c[0];
        o[1] = c[1];
        o[2] = c[2];
        o[3] = c[3];
        o[4] = sl * c4[k];
        o[5] = sl * c5[k];
        o[6] = su * c6[k];
        o[7] = su * c7[k];
    }
    // L1' = (L1 - sl gl1 L1) / rho, gl1 = tril(Qg1 Qg1^T - iQtx1 iQtx1^T), as
    // columns of Lt's corner; U1' = rho (U1 - su U1 gu1), gu1 = triu(Pg1 dg1^T
    // - dx1 iPx1^T); exact zeros off their triangles
    for (long long e = threadIdx.x; e < (long long)r * r; e += RG_THREADS) {
        const int k = (int)(e / r), j = (int)(e % r);
        float y = 0.f;
        if (j <= k) {
            float s = 0.f;
            for (int q = 0; q <= k; ++q) s += (vq[k] * vq[q] - viq[k] * viq[q]) * L1(q, j);
            y = inv_rho * (L1(k, j) - sl * s);
        }
        lt_out[(size_t)j * n + k] = y;
        y = 0.f;
        if (j >= k) {
            float s = 0.f;
            for (int q = 0; q <= j; ++q) s += U1(k, q) * (vpg[q] * vdg[j] - vdx[q] * vipx[j]);
            y = rho * (U1(k, j) - su * s);
        }
        u12_out[(size_t)k * n + j] = y;
    }
    if (threadIdx.x == 0) {
        rk.scal[0] = sl;
        rk.scal[1] = su;
    }
}

// Corner C on any rank (splu_corner_c): P' g on the corner and coef4
__global__ void __launch_bounds__(RG_THREADS) splu_corner_c_g_kernel(
    int n, int r, const float* __restrict__ lt_out, const float* __restrict__ u12_out,
    const float* __restrict__ g, const float* __restrict__ gram2, SpluRankG rk,
    float* __restrict__ pre, float* ws, int in_smem) {
    extern __shared__ float sm[];
    float* b = in_smem ? sm : ws;
    float *g1 = b, *Ug1 = b + r, *Qg1 = b + 2 * r, *LtQg1 = b + 3 * r, *w1 = b + 4 * r,
          *w2 = b + 5 * r;
    const int z = 2 * r + 2;
    const RMat L1{lt_out, 1, n}, U1{u12_out, n, 1}, GLL{gram2, z, 1};
    RG_FOR(k, r) g1[k] = g[k];
    rg_mv(Ug1, U1, g1, r);
    RG_FOR(k, r) Ug1[k] += gram2[(size_t)(r + k) * z + 2 * r + 1];
    rg_mv(Qg1, L1, Ug1, r);
    rg_mv(w1, L1.t(), Qg1, r);
    rg_mv(w2, GLL, Ug1, r);
    RG_FOR(k, r) LtQg1[k] = w1[k] + w2[k] + gram2[(size_t)k * z + 2 * r];
    rg_mv(w1, U1.t(), LtQg1, r);
    RG_FOR(k, r) {
        pre[k] = w1[k];
        rk.coef4[2 * k] = Ug1[k];
        rk.coef4[2 * k + 1] = LtQg1[k];
    }
}

// stages 2-4 on any rank: the chain's block bodies, the coefficients read
// in place
__global__ void __launch_bounds__(SPLU_TILE) splu_stage2_g_kernel(
    int n, int r, const float* __restrict__ lt, const float* __restrict__ l3,
    const float* __restrict__ u12, const float* __restrict__ u3, const float* __restrict__ v,
    const float* __restrict__ h, const float* __restrict__ coef2, float* __restrict__ maxpart) {
    __shared__ float red[SPLU_TILE / 32];
    splu_stage2_block(blockIdx.x, gridDim.x, n, r, lt, l3, u12, u3, v, h,
                      reinterpret_cast<const float(*)[SPLU_NCOEF]>(coef2), maxpart, red);
}

__global__ void __launch_bounds__(SPLU_TILE) splu_stage3_g_kernel(
    int n, int r, const float* __restrict__ lt, const float* __restrict__ l3,
    const float* __restrict__ u12, const float* __restrict__ u3, const float* __restrict__ v,
    const float* __restrict__ h, const float* __restrict__ coef3, const float* __restrict__ scal,
    float* __restrict__ lt_out, float* __restrict__ l3_out, float* __restrict__ u12_out,
    float* __restrict__ u3_out) {
    splu_stage3_block(blockIdx.x, gridDim.x, n, r, lt, l3, u12, u3, v, h, nullptr,
                      reinterpret_cast<const float(*)[SPLU_NCOEF]>(coef3), scal[0], scal[1],
                      scal[2], scal[3], lt_out, l3_out, u12_out, u3_out, nullptr, nullptr);
}

__global__ void __launch_bounds__(SPLU_TILE) splu_stage4_g_kernel(
    int n, int r, const float* __restrict__ lt_out, const float* __restrict__ l3_out,
    const float* __restrict__ u12_out, const float* __restrict__ u3_out,
    const float* __restrict__ g, const float* __restrict__ coef4, float* __restrict__ pre) {
    const int j = blockIdx.x * SPLU_TILE + threadIdx.x;
    if (j >= n - r) return;
    splu_stage4_lane(j, n, r, reinterpret_cast<const float(*)[2]>(coef4), lt_out, l3_out, u12_out,
                     u3_out, g, pre);
}

// ------------------------------------------------------------------ host side

static size_t splu_smem1(int r) { return sizeof(float) * (size_t)(3 * r + 3) * (SPLU_TILE + 1); }
static size_t splu_smem3(int r) { return sizeof(float) * (size_t)(2 * r + 2) * (SPLU_TILE + 1); }

static int splu_blocks(int nt) {
    const int tiles = (nt + SPLU_TILE - 1) / SPLU_TILE;
    return tiles < SPLU_MAX_BLOCKS ? tiles : SPLU_MAX_BLOCKS;
}

struct SpluScratch {
    float *part1, *max1, *gram1, *max2, *part2, *gram2;
    SpluRank* rk;
};

static size_t splu_carve(int n, int r, float* base, SpluScratch* s) {
    const size_t blocks = splu_blocks(n - r), z1 = 3 * r + 3, z2 = 2 * r + 2;
    const size_t sizes[] = {blocks * splu_npairs1(r), 2 * blocks, z1 * z1, 2 * blocks,
                            blocks * splu_npairs2(r), z2 * z2, sizeof(SpluRank) / sizeof(float)};
    float** slots[] = {&s->part1, &s->max1, &s->gram1, &s->max2, &s->part2, &s->gram2, nullptr};
    size_t off = 0;
    for (int k = 0; k < 7; ++k) {
        if (base) {
            if (slots[k]) *slots[k] = base + off;
            else s->rk = reinterpret_cast<SpluRank*>(base + off);
        }
        off += psgd_align4(sizes[k]);
    }
    return off;
}

// ------------------------------------------------- the one-launch schedule
// Replaces psgd_tf_tpu/ops/pallas/splu_upd.py `fused_update_apply_mono`
// (:533) → its pallas_call (:582, `_mono_kernel` :301): the whole update and
// P' g in one launch. The TPU kernel is a sequential grid of 4 nb steps that
// sweeps the tail four times, with the corner algebra at the steps nb, 2 nb
// and 3 nb; its stage 4 recomputes the new tail because its output blocks
// are not yet written back. Here it is one cooperative launch of a resident
// grid (cudaLaunchCooperativeKernel): each CTA walks the chain's blocks
// b = blockIdx.x, blockIdx.x + gridDim.x, ... < splu_blocks(nt) and runs the
// chain's own block bodies, so every partial Gram row and every maximum is
// the chain's; a grid-wide barrier (cg::this_grid().sync()) stands at each
// of the chain's launch boundaries, where warp 0 of CTA 0 runs the corner
// bodies (with __syncwarp alone) and the other threads wait at the next
// barrier. Stage 4 reads the new tail that stage 3 wrote, visible after the
// barrier. The result equals the chain's (`psgd_splu_update` with g) bit for
// bit at every n and r.
//
// What bounds it: the same bytes as the chain's update + apply
// (chip_smoke.splu_work(n, apply=True)): memory at large n, latency at
// small n. The design trades the chain's nine launches for one and eight
// grid barriers; one kernel holds every stage, so its registers and dynamic
// shared memory are those of the largest (stage 1's (3r + 3) x 257 floats,
// 102 KB at r = 32), which sets how many CTAs a SM holds. The grid is
// min(splu_blocks(nt), SMs x that occupancy): grid.sync() needs every CTA
// resident, and a launch the card refuses is returned, never replaced.

#define SPLU_MONO_HEAD (SPLU_MAX_RANK * SPLU_NCOEF + 32)  // the coefficients, the block max

struct SpluMono {
    int n, r, blocks;
    float step;
    const float *lt, *l3, *u12, *u3, *v, *h, *g;
    float *lt_out, *l3_out, *u12_out, *u3_out, *pre;
    SpluScratch s;
};

static size_t splu_smem_mono(int r) {
    const size_t zs = (size_t)(3 * r + 3) * (SPLU_TILE + 1);
    return sizeof(float) * (SPLU_MONO_HEAD + (zs > SPLU_CORNER_A ? zs : SPLU_CORNER_A));
}

// Every thread of the grid runs every line here: the barriers are reached by
// all, and only the corner bodies sit behind a branch (warp 0 of CTA 0).
// Buffers written inside the launch are read through plain pointers (no
// __restrict__, no read-only cache).
__global__ void __launch_bounds__(SPLU_TILE) splu_mono_kernel(SpluMono a) {
    namespace cg = cooperative_groups;
    extern __shared__ float sm[];
    float(*c)[SPLU_NCOEF] = reinterpret_cast<float(*)[SPLU_NCOEF]>(sm);
    float* red = sm + SPLU_MAX_RANK * SPLU_NCOEF;
    float* work = sm + SPLU_MONO_HEAD;  // a stage's tile, or a corner's workspace
    cg::grid_group grid = cg::this_grid();
    const int n = a.n, r = a.r, nb = a.blocks, nt = n - r;
    const bool corner = blockIdx.x == 0 && threadIdx.x < 32;
    const SpluScratch s = a.s;
    SpluRank* rk = s.rk;

    for (int b = blockIdx.x; b < nb; b += gridDim.x)
        splu_stage1_block(b, nb, n, r, nt, a.lt, a.l3, a.u12, a.u3, a.v, a.h, s.part1, s.max1,
                          work, red);
    grid.sync();
    const int warps = (gridDim.x * SPLU_TILE) >> 5, np1 = splu_npairs1(r), np2 = splu_npairs2(r);
    for (int e = (blockIdx.x * SPLU_TILE + threadIdx.x) >> 5; e < np1; e += warps)
        splu_reduce_pair(1, r, 3 * r + 3, np1, nb, e, s.part1, s.gram1);
    grid.sync();
    if (corner) splu_corner_a(n, r, nb, a.lt, a.u12, a.v, a.h, s.gram1, s.max1, rk, work);
    grid.sync();
    splu_load_coef(c, rk->coef2, r);
    __syncthreads();
    for (int b = blockIdx.x; b < nb; b += gridDim.x)
        splu_stage2_block(b, nb, n, r, a.lt, a.l3, a.u12, a.u3, a.v, a.h, c, s.max2, red);
    grid.sync();
    if (corner)
        splu_corner_b(n, r, nb, a.step, a.lt, a.u12, a.h, s.max2, rk, a.lt_out, a.u12_out, work);
    grid.sync();
    splu_load_coef(c, rk->coef3, r);
    __syncthreads();
    const float sl = rk->scal[0], su = rk->scal[1], inv_rho = rk->scal[2], rho = rk->scal[3];
    for (int b = blockIdx.x; b < nb; b += gridDim.x)
        splu_stage3_block(b, nb, n, r, a.lt, a.l3, a.u12, a.u3, a.v, a.h, a.g, c, sl, su, inv_rho,
                          rho, a.lt_out, a.l3_out, a.u12_out, a.u3_out, s.part2, work);
    grid.sync();
    for (int e = (blockIdx.x * SPLU_TILE + threadIdx.x) >> 5; e < np2; e += warps)
        splu_reduce_pair(2, r, 2 * r + 2, np2, nb, e, s.part2, s.gram2);
    grid.sync();
    if (corner) splu_corner_c(n, r, a.lt_out, a.u12_out, a.g, s.gram2, rk, a.pre, work);
    grid.sync();
    float(*c4)[2] = reinterpret_cast<float(*)[2]>(sm);
    splu_load_coef(c4, rk->coef4, r);
    __syncthreads();
    for (int j = blockIdx.x * SPLU_TILE + threadIdx.x; j < nt; j += gridDim.x * SPLU_TILE)
        splu_stage4_lane(j, n, r, c4, a.lt_out, a.l3_out, a.u12_out, a.u3_out, a.g, a.pre);
}

static cudaError_t splu_smem_attrs() {
    static bool done = false;
    if (done) return cudaSuccess;
    cudaError_t e = cudaFuncSetAttribute(splu_stage1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)splu_smem1(SPLU_MAX_RANK));
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(splu_stage3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)splu_smem3(SPLU_MAX_RANK));
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(splu_mono_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)splu_smem_mono(SPLU_MAX_RANK));
    const void* corners[] = {(const void*)splu_corner_a_g_kernel, (const void*)splu_corner_b_g_kernel,
                             (const void*)splu_corner_c_g_kernel};
    for (const void* k : corners)
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, RG_SMEM);
    done = e == cudaSuccess;
    return e;
}

static bool splu_generic(int r) { return r > SPLU_MAX_RANK; }

// The generic chain's scratch: the corners' workspace where it outgrows
// shared memory (first: the sharded entries find it at offset 0), the
// GEMM's bands (stage 1's, then the apply's: gram_part_floats, at most
// 256 z^2 floats, under 1/256 of the state's), the two reduced Grams, the
// maxima, the rank space and the staged rows, U2 w and three more
// ((r + 3)(n - r) floats, about half the state's)
struct SpluScratchG {
    float *ws, *part, *max1, *gram1, *max2, *gram2, *w, *e;
    SpluRankG rk;
};

static size_t splu_carve_g(int n, int r, float* base, SpluScratchG* s) {
    const size_t nt = n - r, blocks = splu_blocks((int)nt), z1 = 3 * r + 3, z2 = 2 * r + 2;
    const size_t p1 = gram_part_floats(splu_gram1_plan(n, r, nullptr, nullptr, nullptr, nullptr));
    const size_t p2 = gram_part_floats(splu_gram2_plan(n, r, nullptr, nullptr, nullptr));
    const size_t ws = rg_in_smem(splu_corner_floats(r)) ? 0 : splu_corner_floats(r);
    const size_t sizes[] = {ws, p1 > p2 ? p1 : p2, 2 * blocks, z1 * z1, 2 * blocks, z2 * z2,
                            8 * (size_t)r, 8 * (size_t)r, (size_t)r, 2 * (size_t)r, 8, r * nt,
                            3 * nt};
    float** slots[] = {&s->ws, &s->part, &s->max1, &s->gram1, &s->max2, &s->gram2,
                       &s->rk.coef2, &s->rk.coef3, &s->rk.ipx1, &s->rk.coef4, &s->rk.scal, &s->w,
                       &s->e};
    size_t off = 0;
    for (int k = 0; k < 13; ++k) {
        if (base) *slots[k] = base + off;
        off += psgd_align4(sizes[k]);
    }
    return off;
}

extern "C" size_t psgd_splu_scratch_floats(int n, int r) {
    if (splu_generic(r)) {
        SpluScratchG s;
        return splu_carve_g(n, r, nullptr, &s);
    }
    SpluScratch s;
    return splu_carve(n, r, nullptr, &s);
}

static void splu_corner_a_g(int n, int r, int blocks, const float* lt, const float* u12,
                            const float* v, const float* h, const float* gram, const float* maxs,
                            const SpluScratchG& s, cudaStream_t stream) {
    const size_t fl = splu_corner_floats(r);
    splu_corner_a_g_kernel<<<1, RG_THREADS, rg_smem_bytes(fl), stream>>>(
        n, r, blocks, lt, u12, v, h, gram, maxs, s.rk, s.ws, rg_in_smem(fl));
}

static void splu_corner_b_g(int n, int r, int blocks, float step, const float* lt,
                            const float* u12, const float* h, const float* maxs,
                            const SpluScratchG& s, float* lt_out, float* u12_out,
                            cudaStream_t stream) {
    const size_t fl = splu_corner_floats(r);
    splu_corner_b_g_kernel<<<1, RG_THREADS, rg_smem_bytes(fl), stream>>>(
        n, r, blocks, step, lt, u12, h, maxs, s.rk, lt_out, u12_out, s.ws, rg_in_smem(fl));
}

static void splu_corner_c_g(int n, int r, const float* lt_out, const float* u12_out,
                            const float* g, const float* gram2, const SpluScratchG& s, float* pre,
                            cudaStream_t stream) {
    const size_t fl = splu_corner_floats(r);
    splu_corner_c_g_kernel<<<1, RG_THREADS, rg_smem_bytes(fl), stream>>>(
        n, r, lt_out, u12_out, g, gram2, s.rk, pre, s.ws, rg_in_smem(fl));
}

// Stage 1's Gram (g null) or the apply's over the new tail: the staged
// rows, then the GEMM's bands and their sums into gram
static void splu_gram_g(int n, int r, const float* lt, const float* l3, const float* u12,
                        const float* u3, const float* v, const float* h, const float* g,
                        const SpluScratchG& s, float* gram, cudaStream_t stream) {
    const int nt = n - r;
    splu_rows_kernel<<<(nt + SPLU_TILE - 1) / SPLU_TILE, SPLU_TILE, 0, stream>>>(
        n, r, l3, u12, u3, v, h, g, s.w, s.e);
    gram_launch(g ? splu_gram2_plan(n, r, lt, u12, s.e) : splu_gram1_plan(n, r, lt, u12, s.w, s.e),
                s.part, gram, stream);
}

// The chain past SPLU_MAX_RANK: stage 1's staged rows, Gram bands and their
// sum, max l3 and u3, corner A, stage 2, corner B, stage 3 and, with g, the
// apply's rows, bands and sum, corner C and stage 4
static int splu_update_g(int n, int r, const float* lt, const float* l3, const float* u12,
                         const float* u3, const float* v, const float* h, const float* g,
                         float step, float* lt_out, float* l3_out, float* u12_out, float* u3_out,
                         float* pre, float* scratch, cudaStream_t stream) {
    SpluScratchG s;
    splu_carve_g(n, r, scratch, &s);
    const int nt = n - r, blocks = splu_blocks(nt);
    splu_gram_g(n, r, lt, l3, u12, u3, v, h, nullptr, s, s.gram1, stream);
    splu_lumax_kernel<<<blocks, SPLU_TILE, 0, stream>>>(nt, nt, l3, u3, s.max1);
    splu_corner_a_g(n, r, blocks, lt, u12, v, h, s.gram1, s.max1, s, stream);
    splu_stage2_g_kernel<<<blocks, SPLU_TILE, 0, stream>>>(n, r, lt, l3, u12, u3, v, h, s.rk.coef2,
                                                           s.max2);
    splu_corner_b_g(n, r, blocks, step, lt, u12, h, s.max2, s, lt_out, u12_out, stream);
    splu_stage3_g_kernel<<<blocks, SPLU_TILE, 0, stream>>>(n, r, lt, l3, u12, u3, v, h, s.rk.coef3,
                                                           s.rk.scal, lt_out, l3_out, u12_out,
                                                           u3_out);
    if (g) {
        splu_gram_g(n, r, lt_out, l3_out, u12_out, u3_out, nullptr, nullptr, g, s, s.gram2, stream);
        splu_corner_c_g(n, r, lt_out, u12_out, g, s.gram2, s, pre, stream);
        splu_stage4_g_kernel<<<(nt + SPLU_TILE - 1) / SPLU_TILE, SPLU_TILE, 0, stream>>>(
            n, r, lt_out, l3_out, u12_out, u3_out, g, s.rk.coef4, pre);
    }
    return (int)cudaGetLastError();
}

// The update of (lt, l3, u12, u3) into the *_out arrays (which must not
// alias the inputs); with g (non-null) also pre = P' g of the new state.
extern "C" int psgd_splu_update(int n, int r, const void* ltp, const void* l3p, const void* u12p,
                                const void* u3p, const void* vp, const void* hp, const void* gp,
                                float step, void* lt_outp, void* l3_outp, void* u12_outp,
                                void* u3_outp, void* prep, void* scratch, void* stream_ptr) {
    if (r < 1 || n - r < 1) return (int)cudaErrorInvalidValue;
    cudaError_t e = splu_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    auto o = [](void* p) { return static_cast<float*>(p); };
    const float *lt = f(ltp), *l3 = f(l3p), *u12 = f(u12p), *u3 = f(u3p), *v = f(vp), *h = f(hp),
                *g = f(gp);
    float *lt_out = o(lt_outp), *l3_out = o(l3_outp), *u12_out = o(u12_outp), *u3_out = o(u3_outp);
    if (splu_generic(r))
        return splu_update_g(n, r, lt, l3, u12, u3, v, h, g, step, lt_out, l3_out, u12_out, u3_out,
                             o(prep), o(scratch), stream);
    SpluScratch s;
    splu_carve(n, r, static_cast<float*>(scratch), &s);
    const int nt = n - r, blocks = splu_blocks(nt);
    const int np1 = splu_npairs1(r), np2 = splu_npairs2(r);

    splu_stage1_kernel<<<blocks, SPLU_TILE, splu_smem1(r), stream>>>(n, r, nt, lt, l3, u12, u3, v, h,
                                                                    s.part1, s.max1);
    splu_reduce_kernel<<<(np1 * 32 + 255) / 256, 256, 0, stream>>>(1, r, 3 * r + 3, np1, blocks,
                                                                   s.part1, s.gram1);
    splu_corner_a_kernel<<<1, 32, 0, stream>>>(n, r, blocks, lt, u12, v, h, s.gram1, s.max1, s.rk);
    splu_stage2_kernel<<<blocks, SPLU_TILE, 0, stream>>>(n, r, lt, l3, u12, u3, v, h, s.rk, s.max2);
    splu_corner_b_kernel<<<1, 32, 0, stream>>>(n, r, blocks, step, lt, u12, h, s.max2, s.rk, lt_out,
                                               u12_out);
    splu_stage3_kernel<<<blocks, SPLU_TILE, g ? splu_smem3(r) : 0, stream>>>(
        n, r, lt, l3, u12, u3, v, h, g, s.rk, lt_out, l3_out, u12_out, u3_out, s.part2);
    if (g) {
        splu_reduce_kernel<<<(np2 * 32 + 255) / 256, 256, 0, stream>>>(2, r, 2 * r + 2, np2, blocks,
                                                                       s.part2, s.gram2);
        splu_corner_c_kernel<<<1, 32, 0, stream>>>(n, r, lt_out, u12_out, g, s.gram2, s.rk, o(prep));
        splu_stage4_kernel<<<(nt + SPLU_TILE - 1) / SPLU_TILE, SPLU_TILE, 0, stream>>>(
            n, r, lt_out, l3_out, u12_out, u3_out, g, s.rk, o(prep));
    }
    return (int)cudaGetLastError();
}

// The one-launch kernel's grid for a rank-r state over n parameters:
// out = {grid, CTAs a SM holds, SMs, registers a thread}. Fails where the
// card takes no cooperative launch or holds no CTA of the kernel. The card's
// answers are kept per device and rank after the first query.
extern "C" int psgd_splu_mono_grid(int n, int r, int* out) {
    if (r < 1 || r > SPLU_MAX_RANK || n - r < 1) return (int)cudaErrorInvalidValue;
    static int known_dev = -1, known[SPLU_MAX_RANK + 1][3];  // per_sm, SMs, registers; 0: not asked
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev != known_dev) {
        for (int k = 0; k <= SPLU_MAX_RANK; ++k) known[k][0] = known[k][1] = known[k][2] = 0;
        known_dev = dev;
    }
    int* q = known[r];
    if (!q[1]) {
        int coop = 0, per_sm = 0, sms = 0;
        cudaFuncAttributes attr;
        e = splu_smem_attrs();
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, splu_mono_kernel, SPLU_TILE,
                                                              splu_smem_mono(r));
        if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, splu_mono_kernel);
        if (e != cudaSuccess) return (int)e;
        if (!coop) return (int)cudaErrorNotSupported;
        if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
        q[0] = per_sm;
        q[1] = sms;
        q[2] = attr.numRegs;
    }
    const int blocks = splu_blocks(n - r), most = q[0] * q[1];
    out[0] = blocks < most ? blocks : most;
    out[1] = q[0];
    out[2] = q[1];
    out[3] = q[2];
    return (int)cudaSuccess;
}

// The update and pre = P' g in one cooperative launch; the arguments as
// psgd_splu_update's, g required. Returns the launch's error: a grid the
// card does not hold resident is refused, and nothing else runs.
extern "C" int psgd_splu_mono(int n, int r, const void* ltp, const void* l3p, const void* u12p,
                              const void* u3p, const void* vp, const void* hp, const void* gp,
                              float step, void* lt_outp, void* l3_outp, void* u12_outp,
                              void* u3_outp, void* prep, void* scratch, void* stream_ptr) {
    if (!gp) return (int)cudaErrorInvalidValue;
    int grid[4];
    cudaError_t e = (cudaError_t)psgd_splu_mono_grid(n, r, grid);
    if (e != cudaSuccess) return (int)e;
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    auto o = [](void* p) { return static_cast<float*>(p); };
    SpluMono a = {n, r, splu_blocks(n - r), step, f(ltp), f(l3p), f(u12p), f(u3p), f(vp), f(hp),
                  f(gp), o(lt_outp), o(l3_outp), o(u12_outp), o(u3_outp), o(prep), {}};
    splu_carve(n, r, static_cast<float*>(scratch), &a.s);
    void* args[] = {&a};
    e = cudaLaunchCooperativeKernel((const void*)splu_mono_kernel, dim3(grid[0]), dim3(SPLU_TILE),
                                    args, splu_smem_mono(r), static_cast<cudaStream_t>(stream_ptr));
    const cudaError_t last = cudaGetLastError();  // clears the launch's error either way
    return (int)(e != cudaSuccess ? e : last);
}

// ------------------------------------------------- K16 sharded: four entries
// The same kernels, split at the chain's three reductions so that the host
// can all-reduce between them over the ranks that hold the other lanes of
// the tail (ops/hopper/splu_upd.py `fused_update_sharded`). Each rank holds
// the corner (replicated) and its slice of the tail, laid out as an
// unsharded state of n = r + its tail lanes; tail lanes at and past nvalid
// are the 1-padding (l3 = u3 = 1, zero columns, zero probes). One scratch
// (psgd_splu_scratch_floats(n, r)) carries the rank-space state from each
// entry to the next. Between entries the host sums gram1 and gram2 and
// takes the max of max1 and max2 over the ranks.

// stage 1: gram1 (3r+3, 3r+3) (the entries the algebra reads; the rest are
// left as the caller filled them) and max1 = (max l3, max u3) of the valid
// lanes, -inf where there is none
extern "C" int psgd_splu_sharded_stage1(int n, int r, int nvalid, const void* ltp, const void* l3p,
                                        const void* u12p, const void* u3p, const void* vp,
                                        const void* hp, void* gram1, void* max1, void* scratch,
                                        void* stream_ptr) {
    if (r < 1 || n - r < 1 || nvalid < 0 || nvalid > n - r) return (int)cudaErrorInvalidValue;
    cudaError_t e = splu_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    const int nt = n - r, blocks = splu_blocks(nt), np1 = splu_npairs1(r);
    float* maxp;
    if (splu_generic(r)) {
        SpluScratchG s;
        splu_carve_g(n, r, static_cast<float*>(scratch), &s);
        splu_gram_g(n, r, f(ltp), f(l3p), f(u12p), f(u3p), f(vp), f(hp), nullptr, s,
                    static_cast<float*>(gram1), stream);
        splu_lumax_kernel<<<blocks, SPLU_TILE, 0, stream>>>(nt, nvalid, f(l3p), f(u3p), s.max1);
        maxp = s.max1;
    } else {
        SpluScratch s;
        splu_carve(n, r, static_cast<float*>(scratch), &s);
        splu_stage1_kernel<<<blocks, SPLU_TILE, splu_smem1(r), stream>>>(
            n, r, nvalid, f(ltp), f(l3p), f(u12p), f(u3p), f(vp), f(hp), s.part1, s.max1);
        splu_reduce_kernel<<<(np1 * 32 + 255) / 256, 256, 0, stream>>>(
            1, r, 3 * r + 3, np1, blocks, s.part1, static_cast<float*>(gram1));
        maxp = s.max1;
    }
    splu_maxfold_kernel<<<1, 32, 0, stream>>>(blocks, -INFINITY, maxp, static_cast<float*>(max1));
    return (int)cudaGetLastError();
}

// corner A and stage 2: max2 = (max(|gl2|, |gl3|), max(|gu2|, |gu3|)) over this
// rank's tail; gram1 and max1 are the sums and maxima over all ranks
extern "C" int psgd_splu_sharded_stage2(int n, int r, const void* ltp, const void* l3p,
                                        const void* u12p, const void* u3p, const void* vp,
                                        const void* hp, const void* gram1, const void* max1,
                                        void* max2, void* scratch, void* stream_ptr) {
    if (r < 1 || n - r < 1) return (int)cudaErrorInvalidValue;
    cudaError_t e = splu_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    const int blocks = splu_blocks(n - r);
    float* maxp;
    if (splu_generic(r)) {
        SpluScratchG s;
        splu_carve_g(n, r, static_cast<float*>(scratch), &s);
        splu_corner_a_g(n, r, 1, f(ltp), f(u12p), f(vp), f(hp), f(gram1), f(max1), s, stream);
        splu_stage2_g_kernel<<<blocks, SPLU_TILE, 0, stream>>>(n, r, f(ltp), f(l3p), f(u12p), f(u3p),
                                                               f(vp), f(hp), s.rk.coef2, s.max2);
        maxp = s.max2;
    } else {
        SpluScratch s;
        splu_carve(n, r, static_cast<float*>(scratch), &s);
        splu_corner_a_kernel<<<1, 32, 0, stream>>>(n, r, 1, f(ltp), f(u12p), f(vp), f(hp), f(gram1),
                                                   f(max1), s.rk);
        splu_stage2_kernel<<<blocks, SPLU_TILE, 0, stream>>>(n, r, f(ltp), f(l3p), f(u12p), f(u3p),
                                                             f(vp), f(hp), s.rk, s.max2);
        maxp = s.max2;
    }
    splu_maxfold_kernel<<<1, 32, 0, stream>>>(blocks, 0.f, maxp, static_cast<float*>(max2));
    return (int)cudaGetLastError();
}

// corner B and stage 3: the new corner and this rank's new tail; with g
// (non-null) also gram2 (2r+2, 2r+2), the apply Gram over this rank's tail;
// max2 is the maxima over all ranks
extern "C" int psgd_splu_sharded_stage3(int n, int r, const void* ltp, const void* l3p,
                                        const void* u12p, const void* u3p, const void* vp,
                                        const void* hp, const void* gp, float step, const void* max2,
                                        void* lt_outp, void* l3_outp, void* u12_outp, void* u3_outp,
                                        void* gram2, void* scratch, void* stream_ptr) {
    if (r < 1 || n - r < 1) return (int)cudaErrorInvalidValue;
    cudaError_t e = splu_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    auto o = [](void* p) { return static_cast<float*>(p); };
    const int nt = n - r, blocks = splu_blocks(nt), np2 = splu_npairs2(r);
    const float* g = f(gp);
    if (splu_generic(r)) {
        SpluScratchG s;
        splu_carve_g(n, r, static_cast<float*>(scratch), &s);
        splu_corner_b_g(n, r, 1, step, f(ltp), f(u12p), f(hp), f(max2), s, o(lt_outp), o(u12_outp),
                        stream);
        splu_stage3_g_kernel<<<blocks, SPLU_TILE, 0, stream>>>(
            n, r, f(ltp), f(l3p), f(u12p), f(u3p), f(vp), f(hp), s.rk.coef3, s.rk.scal, o(lt_outp),
            o(l3_outp), o(u12_outp), o(u3_outp));
        if (g)
            splu_gram_g(n, r, o(lt_outp), o(l3_outp), o(u12_outp), o(u3_outp), nullptr, nullptr, g,
                        s, o(gram2), stream);
        return (int)cudaGetLastError();
    }
    SpluScratch s;
    splu_carve(n, r, static_cast<float*>(scratch), &s);
    splu_corner_b_kernel<<<1, 32, 0, stream>>>(n, r, 1, step, f(ltp), f(u12p), f(hp), f(max2), s.rk,
                                               o(lt_outp), o(u12_outp));
    splu_stage3_kernel<<<blocks, SPLU_TILE, g ? splu_smem3(r) : 0, stream>>>(
        n, r, f(ltp), f(l3p), f(u12p), f(u3p), f(vp), f(hp), g, s.rk, o(lt_outp), o(l3_outp),
        o(u12_outp), o(u3_outp), s.part2);
    if (g)
        splu_reduce_kernel<<<(np2 * 32 + 255) / 256, 256, 0, stream>>>(2, r, 2 * r + 2, np2, blocks,
                                                                       s.part2, o(gram2));
    return (int)cudaGetLastError();
}

// corner C and stage 4: pre = P' g on the corner and on this rank's tail;
// gram2 is the sum over all ranks
extern "C" int psgd_splu_sharded_stage4(int n, int r, const void* lt_outp, const void* l3_outp,
                                        const void* u12_outp, const void* u3_outp, const void* gp,
                                        const void* gram2, void* prep, void* scratch,
                                        void* stream_ptr) {
    if (r < 1 || n - r < 1) return (int)cudaErrorInvalidValue;
    cudaError_t e = splu_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    const int nt = n - r, tiles = (nt + SPLU_TILE - 1) / SPLU_TILE;
    float* pre = static_cast<float*>(prep);
    if (splu_generic(r)) {
        SpluScratchG s;
        splu_carve_g(n, r, static_cast<float*>(scratch), &s);
        splu_corner_c_g(n, r, f(lt_outp), f(u12_outp), f(gp), f(gram2), s, pre, stream);
        splu_stage4_g_kernel<<<tiles, SPLU_TILE, 0, stream>>>(
            n, r, f(lt_outp), f(l3_outp), f(u12_outp), f(u3_outp), f(gp), s.rk.coef4, pre);
        return (int)cudaGetLastError();
    }
    SpluScratch s;
    splu_carve(n, r, static_cast<float*>(scratch), &s);
    splu_corner_c_kernel<<<1, 32, 0, stream>>>(n, r, f(lt_outp), f(u12_outp), f(gp), f(gram2), s.rk, pre);
    splu_stage4_kernel<<<tiles, SPLU_TILE, 0, stream>>>(
        n, r, f(lt_outp), f(l3_outp), f(u12_outp), f(u3_outp), f(gp), s.rk, pre);
    return (int)cudaGetLastError();
}
