// The rank-generic pieces of the lra (K13/K14) and splu (K15/K16) chains:
// what their rank-32 kernels hold in registers and in one warp, sized by r.
//
// Past rank 32 a rank-space vector no longer fits one warp's lanes, and
// past the ranks where a staged tile and its 8 x 8 register tiles fit
// shared memory (lra.cu's LRA_S_MAX_RANK, splu.cu's SPLU_G_MAX_RANK, both
// 128) a Gram of 2r + 2 rows no longer fits either, so both files switch
// (on the host, by r) to:
//   - Grams through kron_dd.cu's grouped GEMM (gram_launch), for lra past
//     LRA_S_MAX_RANK and for splu's stage 1 past SPLU_G_MAX_RANK and its
//     apply Gram at every rank past 32: Z's row blocks that the state
//     holds are read in place at their stride, the rows the algebra
//     builds lane by lane are staged by the caller's own kernel first;
//     each block pair the algebra reads is one problem of a single launch
//     of the GEMM's 64 x 64 tiles (the upper triangle alone on the
//     diagonal), the lanes (K) split into bands over the grid's y, each
//     band's partial product written to a scratch, and gram_sum_kernel
//     sums every entry's bands in band order into the (zdim, zdim) Gram,
//     both halves. No float atomics and a band count set by the shapes
//     alone, so a run repeats itself bit for bit on any card, as the
//     staged kernels do. Measured on an H100 80GB HBM3 at 700 W
//     (tools/kron_gemm_ab.py --gram, n = 2^20, torch.profiler): at r = 64
//     lra's two Grams took 4.22 ms of its 5.33 on this route, where its
//     staged stages now take 2.24 for the whole update + apply (lra.cu);
//     splu's stage-1 Gram 2.23 of 3.35 before splu.cu's own staged tile
//     took it. The 128 x 128 tiles ran slower (lra's stage-1 Gram at r =
//     64 2.94 against 2.12 ms, splu's 6.06 against 2.44): the thin blocks
//     against the staged rows fill a tile's width with zeros;
//   - block-wide rank-space algebra (rg_*): one block of RG_THREADS
//     threads, every vector a length-r array that thread k, k + RG_THREADS,
//     ... own, read by all after a barrier; r x r matrices read where they
//     lie (the Gram in the scratch, the corner factors in the state).
//     The arrays sit in dynamic shared memory while they fit in RG_SMEM,
//     in the caller's workspace past it.
#pragma once

#include "gemm_tile.cuh"
#include "psgd.cuh"

#include <algorithm>

#define RG_THREADS 256
#define RG_SMEM (200 * 1024)  // bytes of dynamic shared memory a corner takes before the workspace

// ------------------------------------------------------------- the Grams

#define GRAM_MAX_BLOCKS 6
#define GRAM_TARGET 2048    // GEMM blocks a Gram's launch aims at (tiles x bands)
#define GRAM_MAX_SPLITS 256
#define GRAM_MIN_BAND 256   // lanes of a band at the least
#define GRAM_TILE 64        // the side of the GEMM tiles a Gram takes (GemmTile<1, 1>)
static_assert(GemmTile<1, 1>::BM == GRAM_TILE && GemmTile<1, 1>::BN == GRAM_TILE,
              "gram_launch's tiles are the GEMM's 64 x 64");

// One block of Z Z^T: rows [a0, a0 + ma) of Z against rows [b0, b0 + mb),
// read as x (ma, lanes) and y (mb, lanes), rows ldx and ldy floats apart.
// A diagonal block (a0 == b0, x == y) is summed in its upper triangle.
struct GramBlock {
    const float* x;
    const float* y;
    int ldx, ldy, a0, b0, ma, mb;
};

// The blocks of one Gram the algebra reads; its other entries are left as
// they were. The pointers may be null where only the sizes are asked for.
struct GramPlan {
    GramBlock b[GRAM_MAX_BLOCKS];
    int count, zdim, lanes;
};

static inline GramPlan gram_plan(int zdim, int lanes) {
    GramPlan p;
    p.count = 0;
    p.zdim = zdim;
    p.lanes = lanes;
    return p;
}

static inline void gram_add(GramPlan& p, const float* x, int ldx, int a0, int ma, const float* y,
                            int ldy, int b0, int mb) {
    p.b[p.count++] = GramBlock{x, y, ldx, ldy, a0, b0, ma, mb};
}

// the GEMM's output tiles of block B
__host__ __device__ inline long long gram_block_tiles(const GramBlock& B) {
    return (long long)((B.ma + GRAM_TILE - 1) / GRAM_TILE) * ((B.mb + GRAM_TILE - 1) / GRAM_TILE);
}

// the lanes' bands: tiles x bands near GRAM_TARGET, each band at least
// GRAM_MIN_BAND lanes
static inline int gram_splits(const GramPlan& p) {
    long long tiles = 0;
    for (int k = 0; k < p.count; ++k) tiles += gram_block_tiles(p.b[k]);
    long long s = (GRAM_TARGET + tiles - 1) / std::max(1LL, tiles);
    s = std::min<long long>(s, GRAM_MAX_SPLITS);
    s = std::min<long long>(s, std::max(1, p.lanes / GRAM_MIN_BAND));
    return (int)std::max(1LL, s);
}

// floats of the bands' partial products
static inline size_t gram_part_floats(const GramPlan& p) {
    const size_t splits = gram_splits(p);
    size_t f = 0;
    for (int k = 0; k < p.count; ++k) f += psgd_align4(splits * p.b[k].ma * p.b[k].mb);
    return f;
}

// gram[a][b] = gram[b][a] = the sum of entry (a, b)'s bands in band order,
// for entry e of the plan's blocks, one after the other (a <= b on a
// diagonal block)
__device__ __forceinline__ void gram_sum_entry(const GramPlan& p, int splits, long long e,
                                               const float* part, float* gram) {
    size_t off = 0;
    for (int k = 0; k < p.count; ++k) {
        const GramBlock& B = p.b[k];
        const long long mm = (long long)B.ma * B.mb;
        if (e < mm) {
            const int i = (int)(e / B.mb), j = (int)(e % B.mb);
            if (B.a0 == B.b0 && i > j) return;
            const float* q = part + off + e;
            float s = 0.f;
            for (int y = 0; y < splits; ++y) s += q[(size_t)y * mm];
            const size_t a = B.a0 + i, b = B.b0 + j;
            gram[a * p.zdim + b] = s;
            gram[b * p.zdim + a] = s;
            return;
        }
        e -= mm;
        off += psgd_align4((size_t)splits * mm);
    }
}

// one thread an entry
static __global__ void __launch_bounds__(256) gram_sum_kernel(const GramPlan p, int splits,
                                                              const float* __restrict__ part,
                                                              float* __restrict__ gram) {
    gram_sum_entry(p, splits, (long long)blockIdx.x * blockDim.x + threadIdx.x, part, gram);
}

// Block B as a problem of the grouped GEMM: x y^T over the lanes into c,
// the upper triangle alone (EPI_TRIU) on a diagonal block
__host__ __device__ inline GemmProb gram_prob(const GramBlock& B, int lanes, float* c) {
    GemmProb P = {};
    P.a = B.x;
    P.b = B.y;
    P.c = c;
    P.tb = 1;
    P.lda = B.ldx;
    P.ldb = B.ldy;
    P.M = B.ma;
    P.N = B.mb;
    P.K = lanes;
    P.epi = B.a0 == B.b0 ? EPI_TRIU : EPI_STORE;
    return P;
}

// Both launches of one Gram: every block's bands in one grouped GEMM of
// 64 x 64 tiles into part (gram_part_floats), then their sums into gram
static void gram_launch(const GramPlan& p, float* part, float* gram, cudaStream_t stream) {
    const int splits = gram_splits(p);
    GemmBatch g;
    g.count = 0;
    size_t off = 0, entries = 0;
    for (int k = 0; k < p.count; ++k) {
        const GramBlock& B = p.b[k];
        g.p[g.count++] = gram_prob(B, p.lanes, part + off);
        off += psgd_align4((size_t)splits * B.ma * B.mb);
        entries += (size_t)B.ma * B.mb;
    }
    launch_gemms(g, stream, splits, 1);
    gram_sum_kernel<<<(unsigned)((entries + 255) / 256), 256, 0, stream>>>(p, splits, part, gram);
}

// The same Gram inside a launch of the caller's own (the one-launch
// kernels): gram_launch's GEMM blocks as work items, then, after a barrier
// the caller places, gram_sums. Work item w is problem p's tile t
// (row-major over its output tiles) in band y = w % splits: the GEMM's own
// tile body (gemm_tile.cuh) over the GEMM's band, its raw partial product
// stored where the GEMM's epilogue stores it (band y at part + off_p +
// y ma mb, zeros below the diagonal of a diagonal block, nothing for a
// tile wholly below it), so the partials and the Gram are gram_launch's
// bit for bit. GEMM_THREADS threads; sm: GemmTile<1, 1>::SMEM bytes.
__device__ __forceinline__ void gram_tile(const GramPlan& p, int splits, long long w, float* part,
                                          float* sm) {
    const int y = (int)(w % splits);
    long long t = w / splits;
    int k = 0;
    size_t off = 0;
    for (; k + 1 < p.count; ++k) {
        const long long tiles = gram_block_tiles(p.b[k]);
        if (t < tiles) break;
        t -= tiles;
        off += psgd_align4((size_t)splits * p.b[k].ma * p.b[k].mb);
    }
    const GemmProb P = gram_prob(p.b[k], p.lanes, part + off);
    const int tn = (P.N + GRAM_TILE - 1) / GRAM_TILE;
    const int row0 = (int)(t / tn) * GRAM_TILE, col0 = (int)(t % tn) * GRAM_TILE;
    const bool triu = P.epi == EPI_TRIU;
    if (triu && row0 > col0 + GRAM_TILE - 1) return;  // uniform across the block
    const int kc = ((P.K + splits - 1) / splits + GEMM_BK - 1) / GEMM_BK * GEMM_BK;
    const int k_lo = y * kc, k_hi = min(P.K, k_lo + kc);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    gemm_tile<1, 1, 0, 1>(P, row0, col0, k_lo, k_hi, sm, acc);
    __syncthreads();  // the next item's copies reuse sm
    float* c = P.c + (size_t)y * P.M * P.N;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
        const int i = row0 + ty * 4 + ii;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
            const int j = col0 + tx * 4 + jj;
            if (i < P.M && j < P.N) c[(size_t)i * P.N + j] = triu && i > j ? 0.f : acc[ii][jj];
        }
    }
}

// the work items of a Gram (gram_tile)
static inline long long gram_items(const GramPlan& p, int splits) {
    long long tiles = 0;
    for (int k = 0; k < p.count; ++k) tiles += gram_block_tiles(p.b[k]);
    return tiles * splits;
}

// every work item of a Gram over the launch's blocks
__device__ __forceinline__ void gram_tiles(const GramPlan& p, int splits, float* part, float* sm) {
    long long tiles = 0;
    for (int k = 0; k < p.count; ++k) tiles += gram_block_tiles(p.b[k]);
    for (long long w = blockIdx.x; w < tiles * splits; w += gridDim.x)
        gram_tile(p, splits, w, part, sm);
}

// the Gram from its bands' partials (gram_sum_entry), an entry a thread of
// the launch
__device__ __forceinline__ void gram_sums(const GramPlan& p, int splits, const float* part,
                                          float* gram) {
    long long entries = 0;
    for (int k = 0; k < p.count; ++k) entries += (long long)p.b[k].ma * p.b[k].mb;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < entries;
         e += (long long)gridDim.x * blockDim.x)
        gram_sum_entry(p, splits, e, part, gram);
}

// ------------------------------------------------------ block-wide algebra

// an r x r matrix where it lies: M(i, j) = p[i * rs + j * cs]
struct RMat {
    const float* p;
    long long rs, cs;
    __device__ __forceinline__ float operator()(int i, int j) const { return p[i * rs + j * cs]; }
    __device__ __forceinline__ RMat t() const { return RMat{p, cs, rs}; }
};

#define RG_FOR(k, r) for (int k = threadIdx.x; k < (r); k += RG_THREADS)

// y = M x (j rising); x and y do not alias; barriers before and after
__device__ __forceinline__ void rg_mv(float* y, RMat M, const float* x, int r) {
    __syncthreads();
    RG_FOR(k, r) {
        float s = 0.f;
        for (int j = 0; j < r; ++j) s += M(k, j) * x[j];
        y[k] = s;
    }
    __syncthreads();
}

// b <- M^{-1} b, M lower (forward) or upper (backward) triangular: y_i =
// b_i / M_ii once the rows before it are folded in, then the rows after it
// subtract M_ki y_i
__device__ __forceinline__ void rg_solve(float* b, RMat M, bool lower, int r) {
    for (int s = 0; s < r; ++s) {
        const int i = lower ? s : r - 1 - s;
        __syncthreads();
        const float yi = b[i] / M(i, i);
        __syncthreads();
        RG_FOR(k, r) {
            if (k == i) b[k] = yi;
            else if (lower ? k > i : k < i) b[k] -= M(k, i) * yi;
        }
    }
    __syncthreads();
}

// the block's sum (op 0) or max (op 1) of v, in a fixed order; every thread
// gets it. red: RG_THREADS / 32 floats.
__device__ __forceinline__ float rg_reduce(float v, int op, float* red) {
    for (int o = 16; o > 0; o >>= 1) {
        const float w = __shfl_xor_sync(0xffffffffu, v, o);
        v = op ? fmaxf(v, w) : v + w;
    }
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = red[0];
    for (int w = 1; w < RG_THREADS / 32; ++w) s = op ? fmaxf(s, red[w]) : s + red[w];
    __syncthreads();
    return s;
}

__device__ __forceinline__ float rg_dot(const float* a, const float* b, int r, float* red) {
    __syncthreads();
    float s = 0.f;
    RG_FOR(k, r) s += a[k] * b[k];
    return rg_reduce(s, 0, red);
}

// the workspace of a corner: dynamic shared memory while `floats` fit in
// RG_SMEM, else ws (global)
static inline bool rg_in_smem(size_t floats) { return floats * sizeof(float) <= RG_SMEM; }
static inline size_t rg_smem_bytes(size_t floats) {
    return rg_in_smem(floats) ? floats * sizeof(float) : 0;
}
