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
//   stage 1   per lane Y = [L2^T; U2 w; dx2 w; l3 u3 dg2] (2r + 2 rows,
//             w = 1/(l3 u3)); the upper triangle of Y Y^T, which holds every
//             entry the algebra reads (JAX's Z also has the rows U2 and dg2:
//             its U2 dg2 is read here as (U2 w) . (l3 u3 dg2), equal to
//             rounding), and max l3, max u3 for the balance;
//   reduce    the blocks' partial Grams summed in block order, a warp an entry;
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
// K16 is stages 1-3 and the fused apply entry the whole chain
// (ops/hopper/splu_upd.py); K15 (splu_one.py) and the JAX package's
// one-launch entry run the same stage and corner bodies in one launch, with
// or without g (the note at "the one-launch schedule"). No float atomics: a
// run repeats itself bit for bit. The
// sharded K16 (JAX splu_upd.py `fused_update(mesh=...)` :914) is the same
// kernels behind four entry points, split at the three reductions that the
// host all-reduces over the ranks holding the tail's other lanes (the end
// of this file).
//
// What bounds it on this card: memory. The update reads the tails of Lt
// and U12, l3, u3, v and h and writes the new state, (4r + 6) floats a lane
// at the least: 193 MB (58 us at 3.35 TB/s) at n = 2^20, r = 10; with g
// (4r + 10) floats. The chain reads the tail in each of stages 1, 2 and 3:
// 376 MB at 2^20, r = 10. At small n its short launches (six for the
// update, nine with g) bound it.
//
// The design. Each streaming pass stages tiles of 256 lanes of every row
// of the tail in shared memory by cp.async, the next tile's copies in
// flight while one is read; row k of the tail starts at k n + r, so each
// row is copied in 16-byte chunks as it lies and read at its own offset,
// and the new tail goes back in 16-byte stores put together from the
// aligned tile. Stage 1's lanes are scaled into Y, aligned, and Y Y^T is
// summed in 4 x 4 register tiles of its upper triangle, 64 FMAs for eight
// 16-byte shared loads (the pairs of the earlier kernel read two 4-byte
// values an FMA); the tile's lane quads are split over the threads left
// when the tiles are few, their sums added in slice order, so a run
// repeats itself bit for bit. Stage 3 with g writes the new tail into Y
// and sums the apply's Gram there. At n = 2^20 (NVIDIA H100 80GB HBM3,
// 700 W, tools/tri_lra_ab.py --splu): the update 0.255 ms at r = 10 (its
// passes 2.1-2.2 TB/s), 0.94 at r = 32, 2.05 at r = 64, 6.76 at r = 128.
//
// Ranks: up to SPLU_MAX_RANK (32) the kernels above, a warp holding a
// rank-space vector; past it the host runs the rank-generic chain
// (splu_update_g, the same C entry points, the sharded ones too), with no
// cap below what device memory sets. Its stage-1 Gram up to
// SPLU_G_MAX_RANK is the same staged design in 8 x 8 register tiles
// (tiles of SPLU_G_TILE lanes, the Gram's tiles in y-slices of 256 over
// the grid); past it, and for the apply's Gram, kron_dd.cu's grouped GEMM
// (rank_space.cuh) over the rows the state holds read in place and the
// others staged. Its corners run on one block: the r x r operands staged
// in shared memory while they fit (splu_corner_mats), the four triangular
// solves of corner A by 32-row blocks against the diagonal blocks'
// inverses (splu_inv_blocks, L1's and U1's at once; splu_bsolve: ceil(r /
// 32) steps of products where row-by-row substitution took r dependent
// steps, 11-16 us each at r = 64). Its scratch: the partial tiles (splu_g1_blocks x 64 floats a
// tile) or the GEMM's bands, the apply's bands (at most 256 z^2 floats, z
// = 2r + 2), the staged rows 2 (n - r) (r (n - r) more past
// SPLU_G_MAX_RANK), the two reduced Grams 2 z^2, the rank space 19 r + 8
// and, past RG_SMEM of shared memory, the corners' workspace
// (splu_corner_floats). The one-launch kernels run the same pieces at
// every rank.
#include "psgd.cuh"
#include "rank_space.cuh"

#include <cooperative_groups.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

#define SPLU_TILE 256            // threads of a streaming block, and lanes of a rank-32 tile
#define SPLU_MAX_RANK 32
#define SPLU_LD (SPLU_MAX_RANK + 1)
#define SPLU_MAX_BLOCKS 528      // grid cap of the streaming passes (bounds the partials)
#define SPLU_MAX_BLOCKS3 1024    // stage 3's without g (no partials)
#define SPLU_S1_WIDE_RANK 16     // the rank-32 stage 1: 256-lane tiles up to it, 128 past
#define SPLU_G_TILE 64           // lanes of a tile of the rank-generic stage-1 Gram
#define SPLU_G_BLOCKS 264        // its blocks' cap (bounds its partials)
#define SPLU_G_TS 8              // the side of its Gram tiles
#define SPLU_G_MAX_RANK 128      // past it the staged tiles outgrow shared memory
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

// the idx-th pair (a <= b) of a q x q symmetric block, row-major
__host__ __device__ __forceinline__ void splu_sym(int q, int idx, int& a, int& b) {
    a = 0;
    while (idx >= q - a) {
        idx -= q - a;
        ++a;
    }
    b = a + idx;
}

// ------------------------------------------------------------ the staged tile
// A streaming block stages LT tail lanes of the state at a time in shared
// memory (S, two of them: the next tile's copies in flight while one is
// read), LT + 4 floats a row: rows 0..r-1 the tail of Lt, r..2r-1 the
// tail of U12, 2r v, 2r + 1 h, 2r + 2 l3, 2r + 3 u3 and (stage 3 with g)
// 2r + 4 g. Row k of Lt starts at k n + r, so each row has its own
// alignment: its 16-byte chunks are copied as they lie (cp.async, every
// copy of the tile in flight at once), lane j of row i at S[i LD + sh[i] +
// j], sh[i] the segment's misalignment in floats. A Gram's rows are put
// together aligned in Y, lane by lane, zeros past the tile's lanes and in
// the padding to a whole tile: stage 1's Y = [L2^T; U2 w; dx2 w; l3 u3
// dg2], the apply's [L2^T'; U2'; l3' u3' g2; g2].

// the rows of stage 1's Gram padded to a multiple of ts
__host__ __device__ __forceinline__ int splu_pad(int r, int ts) {
    return (2 * r + 1 + ts) / ts * ts;
}

// the floats of a block's staged tiles of lt lanes: two S (one in flight
// while the other is read), sh, and with y the Gram's rows Y in ts x ts
// tiles (rows 2r..2r+3 for the apply's tiles against its last two rows);
// at least a block's ts^2 accumulators a thread, for their sum over the
// lane slices
__host__ __device__ __forceinline__ int splu_tile_floats(int r, int lt, bool y, int ts) {
    const int ld = lt + 4, yr = splu_pad(r, ts) > 2 * r + 4 ? splu_pad(r, ts) : 2 * r + 4;
    const int f = 2 * (2 * r + 5) * ld + (2 * r + 8) / 4 * 4 + (y ? yr * ld : 0);
    return f > SPLU_TILE * ts * ts ? f : SPLU_TILE * ts * ts;
}

struct SpluTile {
    float *S[2], *Y;
    int* sh;
};

__device__ __forceinline__ SpluTile splu_tile_carve(float* zs, int r, int lt) {
    const int s = (2 * r + 5) * (lt + 4);
    SpluTile T;
    T.S[0] = zs;
    T.S[1] = zs + s;
    T.sh = reinterpret_cast<int*>(zs + 2 * s);
    T.Y = zs + 2 * s + (2 * r + 8) / 4 * 4;
    return T;
}

struct SpluSrc {
    const float *lt, *u12, *v, *h, *l3, *u3, *g;  // g null: no g row
    int n, r;
};

// staged row i's segment at tail lane base
__device__ __forceinline__ const float* splu_src_row(const SpluSrc& s, int i, int base) {
    const int r = s.r;
    if (i < r) return s.lt + (size_t)i * s.n + r + base;
    if (i < 2 * r) return s.u12 + (size_t)(i - r) * s.n + r + base;
    switch (i - 2 * r) {
        case 0: return s.v + r + base;
        case 1: return s.h + r + base;
        case 2: return s.l3 + base;
        case 3: return s.u3 + base;
        default: return s.g + r + base;
    }
}

__device__ __forceinline__ void splu_cp16(float* dst, const float* src, bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 16 : 0));
}

// The tile at tail lane base (`len` lanes) into S, in flight as one group:
// each chunk that holds a lane of its row's segment (zeros for the
// others); the caller waits (splu_cp_wait) and synchronises before reading
// S. Nothing where base is past the tail (an empty group).
template <int LT>
__device__ void splu_stage_fetch(const SpluSrc& s, int base, float* S, const SpluTile& T) {
    const int len = min(LT, s.n - s.r - base);
    constexpr int QS = LT / 4 + 1, LD = LT + 4;
    const int items = len > 0 ? (2 * s.r + 4 + (s.g ? 1 : 0)) * QS : 0;
    for (int it = threadIdx.x; it < items; it += SPLU_TILE) {
        const int i = it / QS, x = it % QS;
        const float* p = splu_src_row(s, i, base);
        const int sh = (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
        if (x == 0) T.sh[i] = sh;  // the same at every tile of a row
        splu_cp16(S + i * LD + 4 * x, p - sh + 4 * x, 4 * x < sh + len);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait for this thread's copies but the last group started (the next tile's)
__device__ __forceinline__ void splu_cp_wait() { asm volatile("cp.async.wait_group 1;\n" ::); }

// row i of S at one lane
struct SpluCol {
    float* p;  // S + lane
    const int* sh;
    __device__ __forceinline__ float& operator()(int i) const {
        return p[i * (SPLU_TILE + 4) + sh[i]];
    }
};

// rows 2r + 2 .. splu_pad(r, ts) - 1 of Y to zero (the Gram's padding)
template <int LT>
__device__ void splu_zero_pad(int r, int ts, float* Y) {
    constexpr int LD = LT + 4;
    for (int e = threadIdx.x; e < (splu_pad(r, ts) - 2 * r - 2) * LD; e += SPLU_TILE)
        Y[(2 * r + 2) * LD + e] = 0.f;
}

// row[pos..pos+3] (pos >= 0) by 16-byte shared loads of the aligned quads
// that hold them
__device__ __forceinline__ float4 splu_ld4(const float* row, int pos) {
    const int k = pos & 3;
    const float4 a = *reinterpret_cast<const float4*>(row + pos - k);
    if (!k) return a;
    const float4 b = *reinterpret_cast<const float4*>(row + pos - k + 4);
    return k == 1 ? make_float4(a.y, a.z, a.w, b.x)
                  : k == 2 ? make_float4(a.z, a.w, b.x, b.y) : make_float4(a.w, b.x, b.y, b.z);
}

// The new tail of the tile into the state's segments at tail lane base
// (`len` lanes): rows 0..2r-1 of A (lane j of row k at A[k LD + j], or at
// A[k LD + sh[k] + j] in S), l3' and u3' from rows 2r + 2, 2r + 3 of S.
// Destination chunk x of a row (from its aligned base) is one 16-byte
// store where it lies inside the segment, scalar stores at its ends.
__device__ void splu_stage_out(int n, int r, int base, int len, const float* A, bool a_in_s,
                               const float* S, const SpluTile& T, float* lt_out, float* l3_out,
                               float* u12_out, float* u3_out) {
    constexpr int LD = SPLU_TILE + 4, QO = SPLU_TILE / 4 + 1;
    for (int it = threadIdx.x; it < (2 * r + 2) * QO; it += SPLU_TILE) {
        const int i = it / QO, x = it % QO, k = i < 2 * r ? i : i + 2;
        float* p = k < r       ? lt_out + (size_t)k * n + r + base
                   : k < 2 * r ? u12_out + (size_t)(k - r) * n + r + base
                   : k == 2 * r + 2 ? l3_out + base
                                    : u3_out + base;
        const float* src = (k < 2 * r ? A : S) + k * LD;
        const int sh = k < 2 * r && !a_in_s ? 0 : T.sh[k];  // lane j at src[sh + j]
        const float* row = src + sh;
        const int j = 4 * x - (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
        if (j >= 0 && j + 3 < len) {
            *reinterpret_cast<float4*>(p + j) = splu_ld4(src, sh + j);
        } else {
            for (int e = 0; e < 4; ++e)
                if (j + e >= 0 && j + e < len) p[j + e] = row[j + e];
        }
    }
}

// ------------------------------------------------------------ the Gram's tiles
// A thread accumulates whole ts x ts tiles of a Gram over the staged rows:
// per lane quad 2 ts 16-byte shared loads for 4 ts^2 FMAs (4 x 4 tiles in
// the rank-32 kernels, 8 x 8 in the rank-generic stage 1). which = 1,
// stage 1: the upper triangle of Y = rows 0..2r+1 (zero past them), in
// tiles (ti <= tj) over splu_pad(r, ts) / ts row blocks; which = 2, the
// apply (ts = 4): the upper triangle of L2^T' (rows 0..r-1) over ceil(r /
// 4) quads, then each quad of [L2^T'; U2'] against rows 2r, 2r + 1 (l3'
// u3' g2, g2). Every entry the corner algebra reads lies in one tile.

__host__ __device__ __forceinline__ int splu_tiles(int which, int r, int ts) {
    const int q = which == 1 ? splu_pad(r, ts) / ts : (r + 3) / 4;
    return q * (q + 1) / 2 + (which == 1 ? 0 : (r + 1) / 2);
}

// tile t's first rows (a0, b0)
__device__ __forceinline__ void splu_tile(int which, int r, int ts, int t, int& a0, int& b0) {
    const int q = which == 1 ? splu_pad(r, ts) / ts : (r + 3) / 4, up = q * (q + 1) / 2;
    if (t < up) {
        splu_sym(q, t, a0, b0);
        a0 *= ts;
        b0 *= ts;
    } else {
        a0 = 4 * (t - up);
        b0 = 2 * r;
    }
}

// whether entry (i, j) of tile t (rows a0, b0) is written into the
// (2r + 2)-square Gram: one writer an entry, the upper half of a diagonal
// tile, and the apply's two parts kept apart
__device__ __forceinline__ bool splu_tile_owns(int which, int r, int t, int i, int j, int a0,
                                               int b0) {
    const int a = a0 + i, b = b0 + j, z = 2 * r + 2;
    if (a >= z || b >= z || (a0 == b0 && i > j)) return false;
    const int q = (r + 3) / 4;
    return which == 1 || (t < q * (q + 1) / 2 ? b < r : a < 2 * r);
}

// This thread's share of a Gram's tiles: y-slice y of the tiles holds
// SPLU_TILE of them, and each tile takes ks threads, thread s of them the
// lane quads s, s + ks, ..., starting at a rotation fixed by its tile
// (spreads the shared-memory banks).
struct SpluGramPlan {
    int a0, b0, tile, mine, slice, ks, first, count;
};

template <int LT, int TS>
__device__ void splu_gram_plan(int which, int r, int y, SpluGramPlan& P) {
    const int t = threadIdx.x;
    P.first = y * SPLU_TILE;
    P.count = min(splu_tiles(which, r, TS) - P.first, SPLU_TILE);
    P.ks = min(SPLU_TILE / P.count, LT / 4);
    P.slice = t % P.ks;
    P.tile = P.first + t / P.ks;
    P.mine = t / P.ks < P.count;
    if (P.mine) splu_tile(which, r, TS, P.tile, P.a0, P.b0);
}

// acc += this thread's tile's products over the staged lanes of its quads
template <int LT, int TS>
__device__ __forceinline__ void splu_gram_acc(const float* zs, const SpluGramPlan& P,
                                              float (&acc)[TS * TS]) {
    constexpr int LD = LT + 4;
    const int nq = (LT / 4 - P.slice + P.ks - 1) / P.ks;
    if (!P.mine || nq <= 0) return;
    const int rot = P.tile % nq;
    for (int m0 = 0; m0 < nq; ++m0) {
        const int m = m0 + rot < nq ? m0 + rot : m0 + rot - nq, l = 4 * (P.slice + P.ks * m);
        float4 A[TS];
#pragma unroll
        for (int i = 0; i < TS; ++i)
            A[i] = *reinterpret_cast<const float4*>(zs + (P.a0 + i) * LD + l);
#pragma unroll
        for (int j = 0; j < TS; ++j) {
            const float4 B = *reinterpret_cast<const float4*>(zs + (P.b0 + j) * LD + l);
#pragma unroll
            for (int i = 0; i < TS; ++i) {
                float& c = acc[TS * i + j];
                c = fmaf(A[i].x, B.x, c);
                c = fmaf(A[i].y, B.y, c);
                c = fmaf(A[i].z, B.z, c);
                c = fmaf(A[i].w, B.w, c);
            }
        }
    }
}

// The block's partial Gram into out (TS^2 floats a tile, tile-major): with
// ks > 1 the slices' sums added in slice order through zs (256 TS^2
// floats; barriers, every thread calls it), else each tile as it is
template <int TS>
__device__ void splu_gram_out(const SpluGramPlan& P, const float (&acc)[TS * TS], float* out,
                              float* zs) {
    constexpr int E = TS * TS;
    if (P.ks == 1) {
        if (P.mine)
            for (int e = 0; e < E; ++e) out[(size_t)P.tile * E + e] = acc[e];
        return;
    }
    __syncthreads();
    for (int e = 0; e < E; ++e) zs[threadIdx.x * E + e] = P.mine ? acc[e] : 0.f;
    __syncthreads();
    for (int e = threadIdx.x; e < P.count * E; e += SPLU_TILE) {
        const float* p = zs + (e / E) * P.ks * E + e % E;
        float s = 0.f;
        for (int k = 0; k < P.ks; ++k) s += p[k * E];
        out[(size_t)P.first * E + e] = s;
    }
}

// max over the block (blockDim == SPLU_TILE); every thread gets the result
__device__ __forceinline__ float splu_block_max(float v, float* red);

// the maxima's partials of `blocks` blocks folded by the calling block into
// mx[0], mx[1] (from init): what a corner's lanes fold, a max being exact
// in any order
__device__ void splu_fold_max(const float* maxpart, int blocks, float init, float* mx,
                              float* red) {
    float a = init, b = init;
    for (int k = threadIdx.x; k < blocks; k += SPLU_TILE) {
        a = fmaxf(a, maxpart[2 * k]);
        b = fmaxf(b, maxpart[2 * k + 1]);
    }
    a = splu_block_max(a, red);
    b = splu_block_max(b, red);
    if (threadIdx.x == 0) {
        mx[0] = a;
        mx[1] = b;
    }
}

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

// Block b of stage 1 (y-slice y of the Gram's TS x TS tiles): its partial
// Gram of Y = [L2^T; U2 w; dx2 w; l3 u3 dg2], w = 1 / (l3 u3) (row b of
// part, splu_tiles(1, r, TS) TS^2 floats), and with y = 0 max l3, max u3
// (maxpart[2b], [2b + 1]) over the tail lanes below nvalid alone: the lanes
// past it are the 1-padding of a sharded tail (JAX splu_upd.py:928-944).
// The algebra's (U2, dg2) is (U2 w, l3 u3 dg2) here, equal to rounding.
// The next tile's copies are in flight while this one is summed.
template <int LT, int TS>
__device__ void splu_stage1_block(int b, int nblk, int y, const SpluSrc& s, int nvalid,
                                  float* part, float* maxpart, float* zs, float* red) {
    constexpr int LD = LT + 4, GROUPS = SPLU_TILE / LT;
    const int r = s.r, nt = s.n - r, z = 2 * r + 2, step = nblk * LT;
    const SpluTile T = splu_tile_carve(zs, r, LT);
    SpluGramPlan P;
    splu_gram_plan<LT, TS>(1, r, y, P);
    float acc[TS * TS];
#pragma unroll
    for (int e = 0; e < TS * TS; ++e) acc[e] = 0.f;
    float ml = splu_neg_inf(), mu = splu_neg_inf();
    splu_zero_pad<LT>(r, TS, T.Y);
    splu_stage_fetch<LT>(s, b * LT, T.S[0], T);
    for (int base = b * LT, cur = 0; base < nt; base += step, cur ^= 1) {
        const int len = min(LT, nt - base);
        const float* S = T.S[cur];
        splu_stage_fetch<LT>(s, base + step, T.S[cur ^ 1], T);
        splu_cp_wait();
        __syncthreads();
        {  // lane j of Y: L2^T, U2 w, dx2 w, l3 u3 dg2, zeros past len; rows
           // k = g, g + GROUPS, ... by the GROUPS threads of the lane
            const int j = threadIdx.x % LT, g = threadIdx.x / LT;
            const float l = S[z * LD + T.sh[z] + j], u = S[(z + 1) * LD + T.sh[z + 1] + j];
            const bool ok = j < len;
            const float lu = ok ? l * u : 0.f, w = ok ? 1.f / lu : 0.f;
            if (g == 0 && ok && base + j < nvalid) {
                ml = fmaxf(ml, l);
                mu = fmaxf(mu, u);
            }
            for (int k = g; k < z; k += GROUPS) {
                const float x = ok ? S[k * LD + T.sh[k] + j] : 0.f;
                T.Y[k * LD + j] = k < r ? x : x * (k == 2 * r + 1 ? lu : w);
            }
        }
        __syncthreads();
        splu_gram_acc<LT, TS>(T.Y, P, acc);
    }
    splu_gram_out<TS>(P, acc, part + (size_t)b * splu_tiles(1, r, TS) * TS * TS, zs);
    if (y == 0) {
        ml = splu_block_max(ml, red);
        mu = splu_block_max(mu, red);
        if (threadIdx.x == 0) {
            maxpart[2 * b] = ml;
            maxpart[2 * b + 1] = mu;
        }
    }
    __syncthreads();  // the one-launch kernel's next body reuses the tile
}

// the rank-32 kernels' stage 1 in tiles of LT lanes (splu_s1_wide)
template <int LT>
__global__ void __launch_bounds__(SPLU_TILE, 3) splu_stage1_kernel(SpluSrc s, int nvalid,
                                                                float* __restrict__ part,
                                                                float* __restrict__ maxpart) {
    extern __shared__ float4 zs4[];
    __shared__ float red[SPLU_TILE / 32];
    splu_stage1_block<LT, 4>(blockIdx.x, gridDim.x, 0, s, nvalid, part, maxpart,
                             reinterpret_cast<float*>(zs4), red);
}

// the rank-generic chain's stage 1 (r <= SPLU_G_MAX_RANK): tiles of
// SPLU_G_TILE lanes, the Gram in SPLU_G_TS-square tiles, one a thread, in
// y-slices of SPLU_TILE tiles over the grid's y
__global__ void __launch_bounds__(SPLU_TILE, 2) splu_stage1_g_kernel(SpluSrc s, int nvalid,
                                                                  float* __restrict__ part,
                                                                  float* __restrict__ maxpart) {
    extern __shared__ float4 zs4[];
    __shared__ float red[SPLU_TILE / 32];
    splu_stage1_block<SPLU_G_TILE, SPLU_G_TS>(blockIdx.x, gridDim.x, blockIdx.y, s, nvalid, part,
                                              maxpart, reinterpret_cast<float*>(zs4), red);
}

// gram[a, b] = gram[b, a] = the sum over blocks, in block order, of entry e
// of the partials (np floats a block) where its tile owns it; one warp
__device__ void splu_reduce_entry(int which, int r, int ts, int np, int blocks, int e,
                                  const float* part, float* gram) {
    int a0, b0;
    const int t = e / (ts * ts), i = e / ts % ts, j = e % ts;
    splu_tile(which, r, ts, t, a0, b0);
    if (!splu_tile_owns(which, r, t, i, j, a0, b0)) return;  // uniform across the warp
    const int lane = threadIdx.x & 31;
    float s = 0.f;
    for (int k = lane; k < blocks; k += 32) s += part[(size_t)k * np + e];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) {
        const int z = 2 * r + 2, a = a0 + i, b = b0 + j;
        gram[a * z + b] = s;
        gram[b * z + a] = s;
    }
}

// The same sum as splu_reduce_entry's, by one thread: lane l's running sum
// over the blocks l, l + 32, ..., then the shuffle-down tree's adds in
// order, so the entry is the warp's bit for bit (the one-launch kernels
// take it where their warps are fewer than the entries)
__device__ void splu_reduce_entry_thread(int which, int r, int ts, int np, int blocks, int e,
                                         const float* part, float* gram) {
    int a0, b0;
    const int t = e / (ts * ts), i = e / ts % ts, j = e % ts;
    splu_tile(which, r, ts, t, a0, b0);
    if (!splu_tile_owns(which, r, t, i, j, a0, b0)) return;
    float v[32];
#pragma unroll
    for (int l = 0; l < 32; ++l) v[l] = 0.f;
    for (int k0 = 0; k0 < blocks; k0 += 32)
#pragma unroll
        for (int l = 0; l < 32; ++l)
            if (k0 + l < blocks) v[l] += part[(size_t)(k0 + l) * np + e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int l = 0; l < o; ++l) v[l] += v[l + o];
    const int z = 2 * r + 2, a = a0 + i, b = b0 + j;
    gram[a * z + b] = v[0];
    gram[b * z + a] = v[0];
}

// Every owned entry of a Gram's partials summed over the launch's threads:
// a warp an entry where the warps are as many as the entries, else a thread
// an entry (the same bits)
__device__ void splu_reduce_all(int which, int r, int ts, int blocks, const float* part,
                                float* gram) {
    const int np = splu_tiles(which, r, ts) * ts * ts;
    const int tid = blockIdx.x * blockDim.x + threadIdx.x, threads = gridDim.x * blockDim.x;
    if (np <= threads / 32) {
        for (int e = tid >> 5; e < np; e += threads >> 5)
            splu_reduce_entry(which, r, ts, np, blocks, e, part, gram);
    } else {
        for (int e = tid; e < np; e += threads)
            splu_reduce_entry_thread(which, r, ts, np, blocks, e, part, gram);
    }
}

// one warp an entry of the partials
__global__ void __launch_bounds__(256) splu_reduce_kernel(int which, int r, int ts, int blocks,
                                                          const float* __restrict__ part,
                                                          float* __restrict__ gram) {
    const int np = splu_tiles(which, r, ts) * ts * ts;
    const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (e < np) splu_reduce_entry(which, r, ts, np, blocks, e, part, gram);
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

// What corner `which` (0: A, 1: B, 2: C) reads of the r x r blocks into ws,
// by the calling block's threads threadIdx.x, + nthr, ... (the caller
// synchronises): L1 (lower) and U1 (upper) of an (r, n) pair, L1[i][j] =
// lt[j, i] (read along i), U1[i][j] = u12[i, j]; then for A the Gram's
// blocks G_LW, G_LL, G_WW, for C the apply Gram's G_LL
__device__ void splu_corner_load(int which, int n, int r, const float* lt, const float* u12,
                                 const float* gram, float* ws, int nthr) {
    SpluSq *L1 = reinterpret_cast<SpluSq*>(ws), *U1 = L1 + SPLU_MAX_RANK, *G = U1 + SPLU_MAX_RANK;
    const int z = 2 * r + 2;
    for (int e = threadIdx.x; e < r * r; e += nthr) {
        const int i = e / r, j = e % r;
        L1[j][i] = lt[(size_t)i * n + j];
        U1[i][j] = u12[(size_t)i * n + j];
        if (which == 0) {
            G[i][j] = gram[i * z + r + j];                                    // G_LW
            G[SPLU_MAX_RANK + i][j] = gram[i * z + j];                        // G_LL
            G[2 * SPLU_MAX_RANK + i][j] = gram[(r + i) * z + r + j];          // G_WW
        } else if (which == 2) {
            G[i][j] = gram[i * z + j];                                        // G_LL
        }
    }
}

// ws: SPLU_CORNER_A floats; staged: splu_corner_load(0, ...) has filled its
// blocks (the one-launch kernel, with the whole CTA), else warp 0 loads them
__device__ void splu_corner_a(int n, int r, int blocks, const float* lt, const float* u12,
                              const float* v, const float* h, const float* gram,
                              const float* maxpart, SpluRank* rk, float* ws, bool staged) {
    SpluSq *L1 = reinterpret_cast<SpluSq*>(ws), *U1 = L1 + SPLU_MAX_RANK;
    SpluSq *GLW = U1 + SPLU_MAX_RANK, *GLL = GLW + SPLU_MAX_RANK, *GWW = GLL + SPLU_MAX_RANK;
    float* buf = ws + 5 * SPLU_SQ;
    float *vq = buf + 32, *viq = vq + 32, *vpg = viq + 32, *vdg = vpg + 32, *vdx = vdg + 32,
          *vipx = vdx + 32;
    const int k = threadIdx.x, zdim = 2 * r + 2;
    const bool on = k < r;
    if (!staged) splu_corner_load(0, n, r, lt, u12, gram, ws, 32);
    __syncwarp();
    const float dx1 = on ? v[k] : 0.f, dg1 = on ? h[k] : 0.f;
    const float U2_dg = on ? gram[(r + k) * zdim + 2 * r + 1] : 0.f;  // as (U2 w, l3 u3 dg2)
    const float L2t_dxw = on ? gram[k * zdim + 2 * r] : 0.f;
    const float L2t_lug = on ? gram[k * zdim + 2 * r + 1] : 0.f;
    const float U2_w2dx = on ? gram[(r + k) * zdim + 2 * r] : 0.f;

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
    splu_corner_a(n, r, blocks, lt, u12, v, h, gram, maxpart, rk, ws, false);
}

// ------------------------------------------------------------------ stage 2

// c[k][q] = src[k][q] for the r rows, by the block's SPLU_TILE threads (no barrier)
template <int W>
__device__ void splu_load_coef(float (*c)[W], const float (*src)[W], int r) {
    for (int e = threadIdx.x; e < r * W; e += SPLU_TILE) c[e / W][e % W] = src[e / W][e % W];
}

// one lane's column of L2^T or U2 read in place: row k at p[k ld]
struct SpluDirect {
    const float* p;
    size_t ld;
    __device__ __forceinline__ float operator()(int k) const { return p[k * ld]; }
};

// one lane's tail images from its columns of L2^T and U2
template <class Col>
__device__ __forceinline__ void splu_images(int r, const Col& lt, const Col& u12, float lu, float w,
                                            float dx, float dg, const float (*c)[SPLU_NCOEF],
                                            float& qg2, float& iqtx2, float& pg2, float& ipx2) {
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
    for (int k = 0; k < r; ++k) {
        const float lk = lt(k), uk = u12(k);
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

// |gl2|, |gl3| and |gu2|, |gu3| of one lane folded into ml, mu
__device__ __forceinline__ void splu_lane_max(int r, float qg2, float iqtx2, float pg2, float ipx2,
                                              float dx, float dg, const float (*c)[SPLU_NCOEF],
                                              float& ml, float& mu) {
    ml = fmaxf(ml, fabsf(qg2 * qg2 - iqtx2 * iqtx2));
    mu = fmaxf(mu, fabsf(pg2 * dg - dx * ipx2));
    for (int k = 0; k < r; ++k) {
        ml = fmaxf(ml, fabsf(c[k][4] * qg2 - c[k][5] * iqtx2));
        mu = fmaxf(mu, fabsf(c[k][6] * dg - c[k][7] * ipx2));
    }
}

// Block b of stage 2: max(|gl2|, |gl3|), max(|gu2|, |gu3|) over its lanes
// into maxpart[2b], [2b + 1]; c = coef2 in shared memory, zs a staged tile
__device__ void splu_stage2_block(int b, int nblk, const SpluSrc& s, const float (*c)[SPLU_NCOEF],
                                  float* maxpart, float* zs, float* red) {
    const int r = s.r, nt = s.n - r, z = 2 * r + 2, t = threadIdx.x, step = nblk * SPLU_TILE;
    const SpluTile T = splu_tile_carve(zs, r, SPLU_TILE);
    float ml = 0.f, mu = 0.f;
    splu_stage_fetch<SPLU_TILE>(s, b * SPLU_TILE, T.S[0], T);
    for (int base = b * SPLU_TILE, cur = 0; base < nt; base += step, cur ^= 1) {
        const int len = min(SPLU_TILE, nt - base);
        const SpluCol L{T.S[cur] + t, T.sh}, U{T.S[cur] + r * (SPLU_TILE + 4) + t, T.sh + r};
        splu_stage_fetch<SPLU_TILE>(s, base + step, T.S[cur ^ 1], T);
        splu_cp_wait();
        __syncthreads();
        if (t < len) {
            const float lu = L(z) * L(z + 1), w = 1.f / lu, dx = L(2 * r), dg = L(2 * r + 1);
            float qg2, iqtx2, pg2, ipx2;
            splu_images(r, L, U, lu, w, dx, dg, c, qg2, iqtx2, pg2, ipx2);
            splu_lane_max(r, qg2, iqtx2, pg2, ipx2, dx, dg, c, ml, mu);
        }
        __syncthreads();
    }
    ml = splu_block_max(ml, red);
    mu = splu_block_max(mu, red);
    if (t == 0) {
        maxpart[2 * b] = ml;
        maxpart[2 * b + 1] = mu;
    }
}

__global__ void __launch_bounds__(SPLU_TILE) splu_stage2_kernel(SpluSrc s,
                                                                const SpluRank* __restrict__ rk,
                                                                float* __restrict__ maxpart) {
    extern __shared__ float4 zs4[];
    __shared__ float c[SPLU_MAX_RANK][SPLU_NCOEF];
    __shared__ float red[SPLU_TILE / 32];
    splu_load_coef(c, rk->coef2, s.r);
    __syncthreads();
    splu_stage2_block(blockIdx.x, gridDim.x, s, c, maxpart, reinterpret_cast<float*>(zs4), red);
}

// ----------------------------------------------------------------- corner B

// The balanced corner rewrite from corner B's workspace (L1, U1 and its
// vectors) and scal = [sl, su, 1/rho, rho], entry (k, j) of L1' and U1'
// each by the calling block's threads threadIdx.x, + nthr, ... (after a
// barrier over what corner B wrote):
//   L1' = (L1 - sl gl1 L1) / rho, gl1 = tril(Qg1 Qg1^T - iQtx1 iQtx1^T),
//   stored as column k of Lt's corner, exact zeros above the diagonal;
//   U1' = rho (U1 - su U1 gu1), gu1 = triu(Pg1 dg1^T - dx1 iPx1^T)
__device__ void splu_corner_b_rows(int n, int r, const float* ws, const float* scal,
                                   float* lt_out, float* u12_out, int nthr) {
    const SpluSq *L1 = reinterpret_cast<const SpluSq*>(ws), *U1 = L1 + SPLU_MAX_RANK;
    const float* buf = ws + 2 * SPLU_SQ;
    const float *vq = buf + 32, *viq = vq + 32, *vpg = viq + 32, *vdg = vpg + 32, *vdx = vdg + 32,
                *vipx = vdx + 32;
    const float sl = scal[0], su = scal[1], inv_rho = scal[2], rho = scal[3];
    for (int e = threadIdx.x; e < r * r; e += nthr) {
        const int k = e / r, j = e % r;
        float y = 0.f;
        if (j <= k) {
            float s = 0.f;
            for (int q = 0; q <= k; ++q) s += (vq[k] * vq[q] - viq[k] * viq[q]) * L1[q][j];
            y = inv_rho * (L1[k][j] - sl * s);
        }
        lt_out[(size_t)j * n + k] = y;
        y = 0.f;
        if (j >= k) {
            float s = 0.f;
            for (int q = 0; q <= j; ++q) s += U1[k][q] * (vpg[q] * vdg[j] - vdx[q] * vipx[j]);
            y = rho * (U1[k][j] - su * s);
        }
        u12_out[(size_t)k * n + j] = y;
    }
}

// ws: SPLU_CORNER_B floats; staged as corner A's (splu_corner_load(1, ...)),
// and then the caller writes the rows (splu_corner_b_rows) with its block
__device__ void splu_corner_b(int n, int r, int blocks, float step, const float* lt,
                              const float* u12, const float* h, const float* maxpart, SpluRank* rk,
                              float* lt_out, float* u12_out, float* ws, bool staged,
                              bool out = true) {
    SpluSq *L1 = reinterpret_cast<SpluSq*>(ws), *U1 = L1 + SPLU_MAX_RANK;
    float* buf = ws + 2 * SPLU_SQ;
    float *vq = buf + 32, *viq = vq + 32, *vpg = viq + 32, *vdg = vpg + 32, *vdx = vdg + 32,
          *vipx = vdx + 32;
    const int k = threadIdx.x;
    const bool on = k < r;
    if (!staged) splu_corner_load(1, n, r, lt, u12, nullptr, ws, 32);
    __syncwarp();
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
    }
    if (k == 0) {
        rk->scal[0] = sl;
        rk->scal[1] = su;
    }
    if (out && !staged) {
        __syncwarp();
        splu_corner_b_rows(n, r, ws, rk->scal, lt_out, u12_out, 32);
    }
}

__global__ void __launch_bounds__(32) splu_corner_b_kernel(
    int n, int r, int blocks, float step, const float* __restrict__ lt,
    const float* __restrict__ u12, const float* __restrict__ h, const float* __restrict__ maxpart,
    SpluRank* __restrict__ rk, float* __restrict__ lt_out, float* __restrict__ u12_out) {
    __shared__ float ws[SPLU_CORNER_B];
    splu_corner_b(n, r, blocks, step, lt, u12, h, maxpart, rk, lt_out, u12_out, ws, false);
}

// ------------------------------------------------------------------ stage 3

// Block b of stage 3: the new tail of its lanes; with g (s.g) also its
// partial apply Gram of [L2^T'; U2'; l3' u3' g2; g2] (row b of part,
// splu_tiles(2, r, 4) x 16 floats). c = coef3 in shared memory, zs a staged
// tile, the new values written over the old before they go out.
__device__ void splu_stage3_block(int b, int nblk, const SpluSrc& s, const float (*c)[SPLU_NCOEF],
                                  float sl, float su, float inv_rho, float rho, float* lt_out,
                                  float* l3_out, float* u12_out, float* u3_out, float* part,
                                  float* zs) {
    constexpr int LD = SPLU_TILE + 4;
    const int r = s.r, nt = s.n - r, z = 2 * r + 2, t = threadIdx.x, step = nblk * SPLU_TILE;
    const bool g = s.g != nullptr;
    const SpluTile T = splu_tile_carve(zs, r, SPLU_TILE);
    SpluGramPlan P;
    float acc[16];
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    if (g) {
        splu_gram_plan<SPLU_TILE, 4>(2, r, 0, P);
        splu_zero_pad<SPLU_TILE>(r, 4, T.Y);
    }
    splu_stage_fetch<SPLU_TILE>(s, b * SPLU_TILE, T.S[0], T);
    for (int base = b * SPLU_TILE, cur = 0; base < nt; base += step, cur ^= 1) {
        const int len = min(SPLU_TILE, nt - base);
        float* S = T.S[cur];
        const SpluCol L{S + t, T.sh}, U{S + r * (SPLU_TILE + 4) + t, T.sh + r};
        splu_stage_fetch<SPLU_TILE>(s, base + step, T.S[cur ^ 1], T);
        splu_cp_wait();
        __syncthreads();
        // the new tail of lane t over the old in S, or with g into Y (lane t
        // of row k at Y[k LD + t], zeros past len), with l3' u3' g2 and g2
        float* Y = T.Y + t;
        if (t < len) {
            const float l = L(z), u = L(z + 1), lu = l * u, w = 1.f / lu;
            const float dx = L(2 * r), dg = L(2 * r + 1);
            float qg2, iqtx2, pg2, ipx2;
            splu_images(r, L, U, lu, w, dx, dg, c, qg2, iqtx2, pg2, ipx2);
            const float gl3 = qg2 * qg2 - iqtx2 * iqtx2, gu3 = pg2 * dg - dx * ipx2;
            for (int k = 0; k < r; ++k) {
                const float lk = L(k), uk = U(k);
                const float nl = inv_rho * (lk - (c[k][4] * qg2 - c[k][5] * iqtx2) - sl * gl3 * lk);
                const float nu = rho * (uk - (c[k][6] * dg - c[k][7] * ipx2) - su * gu3 * uk);
                (g ? Y[k * LD] : L(k)) = nl;
                (g ? Y[(r + k) * LD] : U(k)) = nu;
            }
            const float nl3 = inv_rho * (l - sl * gl3 * l), nu3 = rho * (u - su * gu3 * u);
            L(z) = nl3;
            L(z + 1) = nu3;
            if (g) {
                const float gj = L(z + 2);
                Y[2 * r * LD] = nl3 * nu3 * gj;
                Y[(2 * r + 1) * LD] = gj;
            }
        } else if (g) {
            for (int k = 0; k < z; ++k) Y[k * LD] = 0.f;
        }
        __syncthreads();
        splu_stage_out(s.n, r, base, len, g ? T.Y : S, !g, S, T, lt_out, l3_out, u12_out, u3_out);
        if (g) splu_gram_acc<SPLU_TILE, 4>(T.Y, P, acc);
        __syncthreads();
    }
    if (g) {
        splu_gram_out<4>(P, acc, part + (size_t)b * splu_tiles(2, r, 4) * 16, zs);
        __syncthreads();  // the one-launch kernel's next body reuses the tile
    }
}

__global__ void __launch_bounds__(SPLU_TILE, 3) splu_stage3_kernel(
    SpluSrc s, const SpluRank* __restrict__ rk, float* __restrict__ lt_out,
    float* __restrict__ l3_out, float* __restrict__ u12_out, float* __restrict__ u3_out,
    float* __restrict__ part) {
    extern __shared__ float4 zs4[];
    __shared__ float c[SPLU_MAX_RANK][SPLU_NCOEF];
    splu_load_coef(c, rk->coef3, s.r);
    __syncthreads();
    splu_stage3_block(blockIdx.x, gridDim.x, s, c, rk->scal[0], rk->scal[1], rk->scal[2],
                      rk->scal[3], lt_out, l3_out, u12_out, u3_out, part,
                      reinterpret_cast<float*>(zs4));
}

// ------------------------------------------------------- corner C, stage 4

// ws: SPLU_CORNER_C floats; staged as corner A's (splu_corner_load(2, ...))
__device__ void splu_corner_c(int n, int r, const float* lt_out, const float* u12_out,
                              const float* g, const float* gram2, SpluRank* rk, float* pre,
                              float* ws, bool staged, bool out = true) {
    SpluSq *L1 = reinterpret_cast<SpluSq*>(ws), *U1 = L1 + SPLU_MAX_RANK, *GLL = U1 + SPLU_MAX_RANK;
    float* buf = ws + 3 * SPLU_SQ;
    const int k = threadIdx.x, zdim = 2 * r + 2;
    const bool on = k < r;
    if (!staged) splu_corner_load(2, n, r, lt_out, u12_out, gram2, ws, 32);
    __syncwarp();
    const float g1 = on ? g[k] : 0.f;
    const float U2g = on ? gram2[(r + k) * zdim + 2 * r + 1] : 0.f;
    const float L2lug = on ? gram2[k * zdim + 2 * r] : 0.f;
    const float Ug1 = splu_mv(U1, false, g1, r, buf) + U2g;
    const float Qg1 = splu_mv(L1, false, Ug1, r, buf);
    const float LtQg1 = splu_mv(L1, true, Qg1, r, buf) + splu_mv(GLL, false, Ug1, r, buf) + L2lug;
    const float pre1 = splu_mv(U1, true, LtQg1, r, buf);
    if (on) {
        if (out) pre[k] = pre1;
        rk->coef4[k][0] = Ug1;
        rk->coef4[k][1] = LtQg1;
    }
}

__global__ void __launch_bounds__(32) splu_corner_c_kernel(
    int n, int r, const float* __restrict__ lt_out, const float* __restrict__ u12_out,
    const float* __restrict__ g, const float* __restrict__ gram2, SpluRank* __restrict__ rk,
    float* __restrict__ pre) {
    __shared__ float ws[SPLU_CORNER_C];
    splu_corner_c(n, r, lt_out, u12_out, g, gram2, rk, pre, ws, false);
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
// pieces: stage 1's Gram from the staged tile in 8 x 8 register tiles
// (tiles of SPLU_G_TILE lanes, one Gram tile a thread, y-slices of
// SPLU_TILE of them over the grid's y, max l3 and u3 in the same pass) up to
// SPLU_G_MAX_RANK, past it through the grouped GEMM (gram_launch) over Y =
// [L2^T; U2 w; dx2 w; l3 u3 dg2], L2^T read in place and the other rows
// staged by splu_rows_kernel, with max l3 and u3 in a pass of their own;
// the corners on one block with the rank-space vectors strided over its
// threads; stages 2-4 one lane a thread, its column read in place; and the
// apply's Gram over the new tail, Z = [L2^T'; U2'; l3' u3' g2; g2],
// through the GEMM after stage 3.

// The rows of a Gram the state does not hold, over the tail lanes j < nt:
// stage 1's (g null) w (r, nt) = U2 w and e (2, nt) = [dx2 w; l3 u3 dg2],
// w = 1 / (l3 u3); the apply's e (2, nt) = [l3 u3 g2; g2]
__device__ __forceinline__ void splu_rows_lane(int j, int n, int r, const float* l3,
                                               const float* u12, const float* u3, const float* v,
                                               const float* h, const float* g, float* w,
                                               float* e) {
    const int nt = n - r;
    const size_t off = (size_t)r + j;
    if (g) {
        e[j] = l3[j] * u3[j] * g[off];
        e[(size_t)nt + j] = g[off];
        return;
    }
    const float lu = l3[j] * u3[j], wj = 1.f / lu;
    for (int k = 0; k < r; ++k) w[(size_t)k * nt + j] = u12[(size_t)k * n + off] * wj;
    e[j] = v[off] * wj;
    e[(size_t)nt + j] = h[off] * lu;
}

__global__ void __launch_bounds__(SPLU_TILE) splu_rows_kernel(int n, int r,
                                                              const float* __restrict__ l3,
                                                              const float* __restrict__ u12,
                                                              const float* __restrict__ u3,
                                                              const float* __restrict__ v,
                                                              const float* __restrict__ h,
                                                              const float* __restrict__ g,
                                                              float* __restrict__ w,
                                                              float* __restrict__ e) {
    const int j = blockIdx.x * SPLU_TILE + threadIdx.x;
    if (j < n - r) splu_rows_lane(j, n, r, l3, u12, u3, v, h, g, w, e);
}

// stage 1's Gram (2r + 2, 2r + 2) past SPLU_G_MAX_RANK: L2^T (rows n apart
// from column r) read in place, U2 w (w) and the last two rows (e) staged
static GramPlan splu_gram1_plan(int n, int r, const float* lt, const float* w, const float* e) {
    const int nt = n - r;
    const float* ltt = lt ? lt + r : nullptr;
    GramPlan p = gram_plan(2 * r + 2, nt);
    gram_add(p, ltt, n, 0, r, ltt, n, 0, r);
    gram_add(p, ltt, n, 0, r, w, nt, r, r);
    gram_add(p, w, nt, r, r, w, nt, r, r);
    gram_add(p, ltt, n, 0, r, e, nt, 2 * r, 2);
    gram_add(p, w, nt, r, r, e, nt, 2 * r, 2);
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
__device__ void splu_lumax_block(int b, int nblk, int nt, int nvalid, const float* l3,
                                 const float* u3, float* maxpart, float* red) {
    float ml = splu_neg_inf(), mu = splu_neg_inf();
    for (int j = b * SPLU_TILE + threadIdx.x; j < nt && j < nvalid; j += nblk * SPLU_TILE) {
        ml = fmaxf(ml, l3[j]);
        mu = fmaxf(mu, u3[j]);
    }
    ml = splu_block_max(ml, red);
    mu = splu_block_max(mu, red);
    if (threadIdx.x == 0) {
        maxpart[2 * b] = ml;
        maxpart[2 * b + 1] = mu;
    }
    __syncthreads();  // red is read by the next block max
}

__global__ void __launch_bounds__(SPLU_TILE) splu_lumax_kernel(int nt, int nvalid,
                                                               const float* __restrict__ l3,
                                                               const float* __restrict__ u3,
                                                               float* __restrict__ maxpart) {
    __shared__ float red[SPLU_TILE / 32];
    splu_lumax_block(blockIdx.x, gridDim.x, nt, nvalid, l3, u3, maxpart, red);
}

// the generic chain's rank space (in the scratch): coef2, coef3 (r, 8),
// ipx1 (r,), coef4 (r, 2), scal (8,) as in SpluRank
struct SpluRankG {
    float *coef2, *coef3, *ipx1, *coef4, *scal;
};

#define SPLU_GVECS 16
#define SPLU_DINV (32 * 33)  // a 32 x 32 diagonal block's inverse, rows 33 apart

// the floats of the inverses of L1's and U1's diagonal 32 x 32 blocks
__host__ __device__ __forceinline__ long long splu_dinv_floats(int r) {
    return 2LL * ((r + 31) / 32) * SPLU_DINV;
}

// How many of a generic corner's r x r operands sit in its workspace after
// its vectors and the diagonal blocks' inverses: 5 (corner A's L1, U1 and
// Gram blocks G_LW, G_LL, G_WW; C's L1', U1' and G_LL), 2 (L1 and U1) or
// none (read where they lie), by what fits in RG_SMEM
__host__ __device__ __forceinline__ int splu_corner_mats(int r) {
    const long long v = (long long)SPLU_GVECS * r + splu_dinv_floats(r), m = (long long)r * (r + 1);
    if ((v + 5 * m) * 4 <= RG_SMEM) return 5;
    if ((v + 2 * m) * 4 <= RG_SMEM) return 2;
    return 0;
}
static size_t splu_corner_floats(int r) {
    return (size_t)SPLU_GVECS * r + (size_t)splu_dinv_floats(r) +
           (size_t)splu_corner_mats(r) * r * (r + 1);
}

// e -> (e / r, e % r) for e < r r, in 32 bits where r r fits in them
__device__ __forceinline__ void splu_rc(long long e, int r, int& a, int& c) {
    if (r <= 46340) {
        const unsigned q = (unsigned)e / (unsigned)r;
        a = (int)q;
        c = (int)((unsigned)e - q * (unsigned)r);
    } else {
        a = (int)(e / r);
        c = (int)(e % r);
    }
}

// M's r x r entries into dst, rows r + 1 apart (a row and a column a thread
// each fall on distinct banks), read along M's unit stride; dst as an RMat.
// dst is in shared memory: a corner stages only while its workspace fits
// RG_SMEM (splu_corner_mats), and its callers then pass shared memory. The
// copies go by cp.async, all of a thread's in flight at once: a
// load-then-store loop waits an L2 round trip an element wherever the
// compiler cannot prove M and dst apart (inside the one-launch kernels,
// whose buffers are written in the launch: 24 us against 8.6 for corner
// A's five operands at r = 64, measured on an H100). The caller's next
// barrier (every rg_mv opens with one) publishes it.
__device__ RMat splu_stage_sq(float* dst, RMat M, int r) {
    const bool cols = M.rs == 1;  // M(i, j) contiguous along i
    for (long long e = threadIdx.x; e < (long long)r * r; e += RG_THREADS) {
        int a, c;
        splu_rc(e, r, a, c);
        const int i = cols ? c : a, j = cols ? a : c;
        gemm_cp4(dst + (size_t)i * (r + 1) + j, M.p + i * M.rs + j * M.cs, true);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return RMat{dst, r + 1, 1};
}

// The inverses of the diagonal 32 x 32 blocks of the lower-triangular L
// and the upper-triangular U into iL and iU (block p at p SPLU_DINV, rows
// 33 apart, zeros off its triangle), a column a thread of a block, L's
// and U's columns side by side over the block's threads: x solves T x =
// e_c by substitution
__device__ void splu_inv_blocks(RMat L, RMat U, int r, float* iL, float* iU) {
    const int nb = (r + 31) / 32;
    for (int tt = threadIdx.x; tt < 2 * nb * 32; tt += RG_THREADS) {
        const bool lower = tt < nb * 32;
        const int t = lower ? tt : tt - nb * 32;
        const RMat M = lower ? L : U;
        float* dinv = lower ? iL : iU;
        const int p = t >> 5, c = t & 31, r0 = 32 * p, w = min(32, r - r0);
        float* D = dinv + p * SPLU_DINV;
        for (int i = 0; i < 32; ++i) D[i * 33 + c] = 0.f;
        if (c >= w) continue;
        D[c * 33 + c] = 1.f / M(r0 + c, r0 + c);
        if (lower) {
            for (int i = c + 1; i < w; ++i) {
                float s = 0.f;
                for (int k = c; k < i; ++k) s += M(r0 + i, r0 + k) * D[k * 33 + c];
                D[i * 33 + c] = -s / M(r0 + i, r0 + i);
            }
        } else {
            for (int i = c - 1; i >= 0; --i) {
                float s = 0.f;
                for (int k = i + 1; k <= c; ++k) s += M(r0 + i, r0 + k) * D[k * 33 + c];
                D[i * 33 + c] = -s / M(r0 + i, r0 + i);
            }
        }
    }
}

// b <- M^{-1} b, M lower or upper triangular, by 32-row blocks on warp 0:
// block p's right side t = b_p - (M's off-diagonal rows of p) y, then y_p =
// D_p t with D_p the block's inverse (dinv; its transpose where dt, for a
// solve by M^T), so a solve is ceil(r / 32) steps of products, not r rows
// of substitution
__device__ void splu_bsolve(float* b, RMat M, bool lower, int r, const float* dinv, bool dt) {
    __syncthreads();
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x, nb = (r + 31) / 32;
        for (int s = 0; s < nb; ++s) {
            const int p = lower ? s : nb - 1 - s, r0 = 32 * p, w = min(32, r - r0);
            const int i = r0 + lane;
            float t = 0.f;
            if (lane < w) {
                t = b[i];
                if (lower)
                    for (int k = 0; k < r0; ++k) t -= M(i, k) * b[k];
                else
                    for (int k = r0 + w; k < r; ++k) t -= M(i, k) * b[k];
            }
            const float* D = dinv + p * SPLU_DINV;
            float y = 0.f;
            for (int j = 0; j < w; ++j) {
                const float tj = __shfl_sync(0xffffffffu, t, j);
                y += (dt ? D[j * 33 + lane] : D[lane * 33 + j]) * tj;
            }
            __syncwarp();
            if (lane < w) b[i] = y;
            __syncwarp();
        }
    }
    __syncthreads();
}

// Corner A on any rank: corner A's algebra (splu_corner_a) on one block of
// RG_THREADS threads, its vectors in b (splu_corner_floats(r) floats:
// dynamic shared memory, or the scratch past RG_SMEM); red: RG_THREADS / 32
// floats
__device__ void splu_corner_a_g(int n, int r, int blocks, const float* lt, const float* u12,
                                const float* v, const float* h, const float* gram,
                                const float* maxpart, SpluRankG rk, float* b, float* red) {
    const int z = 2 * r + 2, nm = splu_corner_mats(r);
    float *dx1 = b, *dg1 = b + r, *Ug1 = b + 2 * r, *Qg1 = b + 3 * r, *iUtx1 = b + 4 * r,
          *iQtx1 = b + 5 * r, *LtQg1 = b + 6 * r, *Pg1 = b + 7 * r, *iLiQtx1 = b + 8 * r,
          *iPx1 = b + 9 * r, *w1 = b + 10 * r, *w2 = b + 11 * r;
    float *iL = b + SPLU_GVECS * r, *iU = iL + splu_dinv_floats(r) / 2,
          *mat = b + SPLU_GVECS * r + splu_dinv_floats(r);
    const size_t sq = (size_t)r * (r + 1);
    RMat L1{lt, 1, n}, U1{u12, n, 1};  // L1[i][j] = lt[j, i], U1[i][j] = u12[i, j]
    RMat GLW{gram + r, z, 1}, GLL{gram, z, 1}, GWW{gram + (size_t)r * z + r, z, 1};
    if (nm >= 2) {
        L1 = splu_stage_sq(mat, L1, r);
        U1 = splu_stage_sq(mat + sq, U1, r);
    }
    if (nm >= 5) {
        GLW = splu_stage_sq(mat + 2 * sq, GLW, r);
        GLL = splu_stage_sq(mat + 3 * sq, GLL, r);
        GWW = splu_stage_sq(mat + 4 * sq, GWW, r);
    }
    __syncthreads();
    splu_inv_blocks(L1, U1, r, iL, iU);
    RG_FOR(k, r) {
        dx1[k] = v[k];
        dg1[k] = h[k];
    }
    rg_mv(Ug1, U1, dg1, r);
    RG_FOR(k, r) Ug1[k] += gram[(size_t)(r + k) * z + 2 * r + 1];  // as (U2 w, l3 u3 dg2)
    rg_mv(Qg1, L1, Ug1, r);
    RG_FOR(k, r) iUtx1[k] = dx1[k];
    splu_bsolve(iUtx1, U1.t(), true, r, iU, true);
    rg_mv(w1, GLW, iUtx1, r);
    RG_FOR(k, r) iQtx1[k] = iUtx1[k] - (gram[(size_t)k * z + 2 * r] - w1[k]);
    splu_bsolve(iQtx1, L1.t(), false, r, iL, true);
    rg_mv(w1, GLL, Ug1, r);
    rg_mv(LtQg1, L1.t(), Qg1, r);
    RG_FOR(k, r) LtQg1[k] += w1[k] + gram[(size_t)k * z + 2 * r + 1];
    rg_mv(Pg1, U1.t(), LtQg1, r);
    RG_FOR(k, r) iLiQtx1[k] = iQtx1[k];
    splu_bsolve(iLiQtx1, L1, true, r, iL, false);
    rg_mv(w1, GWW, iUtx1, r);
    rg_mv(w2, GLW.t(), iLiQtx1, r);
    RG_FOR(k, r) iPx1[k] = iLiQtx1[k] - ((gram[(size_t)(r + k) * z + 2 * r] - w1[k]) - w2[k]);
    splu_bsolve(iPx1, U1, false, r, iU, false);

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

__global__ void __launch_bounds__(RG_THREADS) splu_corner_a_g_kernel(
    int n, int r, int blocks, const float* __restrict__ lt, const float* __restrict__ u12,
    const float* __restrict__ v, const float* __restrict__ h, const float* __restrict__ gram,
    const float* __restrict__ maxpart, SpluRankG rk, float* ws, int in_smem) {
    extern __shared__ float sm[];
    __shared__ float red[RG_THREADS / 32];
    splu_corner_a_g(n, r, blocks, lt, u12, v, h, gram, maxpart, rk, in_smem ? sm : ws, red);
}

// Corner B on any rank (splu_corner_b): the step scales, coef3 and the
// balanced corner rewrite L1', U1', one output entry a thread; b and red as
// corner A's
__device__ void splu_corner_b_g(int n, int r, int blocks, float step, const float* lt,
                                const float* u12, const float* h, const float* maxpart,
                                SpluRankG rk, float* lt_out, float* u12_out, float* b, float* red) {
    float *vq = b, *viq = b + r, *vpg = b + 2 * r, *vdx = b + 3 * r, *vipx = b + 4 * r,
          *vdg = b + 5 * r, *c4 = b + 6 * r, *c5 = b + 7 * r, *c6 = b + 8 * r, *c7 = b + 9 * r;
    RMat L1{lt, 1, n}, U1{u12, n, 1};
    if (splu_corner_mats(r) >= 2) {
        float* mat = b + SPLU_GVECS * r + splu_dinv_floats(r);
        L1 = splu_stage_sq(mat, L1, r);
        U1 = splu_stage_sq(mat + (size_t)r * (r + 1), U1, r);
    }
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
        int k, j;
        splu_rc(e, r, k, j);
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

__global__ void __launch_bounds__(RG_THREADS) splu_corner_b_g_kernel(
    int n, int r, int blocks, float step, const float* __restrict__ lt,
    const float* __restrict__ u12, const float* __restrict__ h, const float* __restrict__ maxpart,
    SpluRankG rk, float* __restrict__ lt_out, float* __restrict__ u12_out, float* ws,
    int in_smem) {
    extern __shared__ float sm[];
    __shared__ float red[RG_THREADS / 32];
    splu_corner_b_g(n, r, blocks, step, lt, u12, h, maxpart, rk, lt_out, u12_out,
                    in_smem ? sm : ws, red);
}

// Corner C on any rank (splu_corner_c): P' g on the corner and coef4; b as
// corner A's
__device__ void splu_corner_c_g(int n, int r, const float* lt_out, const float* u12_out,
                                const float* g, const float* gram2, SpluRankG rk, float* pre,
                                float* b) {
    float *g1 = b, *Ug1 = b + r, *Qg1 = b + 2 * r, *LtQg1 = b + 3 * r, *w1 = b + 4 * r,
          *w2 = b + 5 * r, *mat = b + SPLU_GVECS * r + splu_dinv_floats(r);
    const int z = 2 * r + 2, nm = splu_corner_mats(r);
    const size_t sq = (size_t)r * (r + 1);
    RMat L1{lt_out, 1, n}, U1{u12_out, n, 1}, GLL{gram2, z, 1};
    if (nm >= 2) {
        L1 = splu_stage_sq(mat, L1, r);
        U1 = splu_stage_sq(mat + sq, U1, r);
    }
    if (nm >= 5) GLL = splu_stage_sq(mat + 2 * sq, GLL, r);
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

__global__ void __launch_bounds__(RG_THREADS) splu_corner_c_g_kernel(
    int n, int r, const float* __restrict__ lt_out, const float* __restrict__ u12_out,
    const float* __restrict__ g, const float* __restrict__ gram2, SpluRankG rk,
    float* __restrict__ pre, float* ws, int in_smem) {
    extern __shared__ float sm[];
    splu_corner_c_g(n, r, lt_out, u12_out, g, gram2, rk, pre, in_smem ? sm : ws);
}

// stages 2-4 on any rank: one lane a thread, its column read in place, the
// coefficients in the scratch; block b of a grid of nblk takes the lanes
// b SPLU_TILE + t, stepping nblk SPLU_TILE
__device__ void splu_stage2_g_block(int b, int nblk, int n, int r, const float* lt,
                                    const float* l3, const float* u12, const float* u3,
                                    const float* v, const float* h, const float* coef2,
                                    float* maxpart, float* red) {
    const float(*c)[SPLU_NCOEF] = reinterpret_cast<const float(*)[SPLU_NCOEF]>(coef2);
    float ml = 0.f, mu = 0.f;
    for (int j = b * SPLU_TILE + threadIdx.x; j < n - r; j += nblk * SPLU_TILE) {
        const float lu = l3[j] * u3[j], w = 1.f / lu, dx = v[r + j], dg = h[r + j];
        float qg2, iqtx2, pg2, ipx2;
        splu_images(r, SpluDirect{lt + r + j, (size_t)n}, SpluDirect{u12 + r + j, (size_t)n}, lu,
                    w, dx, dg, c, qg2, iqtx2, pg2, ipx2);
        splu_lane_max(r, qg2, iqtx2, pg2, ipx2, dx, dg, c, ml, mu);
    }
    ml = splu_block_max(ml, red);
    mu = splu_block_max(mu, red);
    if (threadIdx.x == 0) {
        maxpart[2 * b] = ml;
        maxpart[2 * b + 1] = mu;
    }
    __syncthreads();  // red is read by the next block max
}

__global__ void __launch_bounds__(SPLU_TILE) splu_stage2_g_kernel(
    int n, int r, const float* __restrict__ lt, const float* __restrict__ l3,
    const float* __restrict__ u12, const float* __restrict__ u3, const float* __restrict__ v,
    const float* __restrict__ h, const float* __restrict__ coef2, float* __restrict__ maxpart) {
    __shared__ float red[SPLU_TILE / 32];
    splu_stage2_g_block(blockIdx.x, gridDim.x, n, r, lt, l3, u12, u3, v, h, coef2, maxpart, red);
}

__device__ void splu_stage3_g_block(int b, int nblk, int n, int r, const float* lt,
                                    const float* l3, const float* u12, const float* u3,
                                    const float* v, const float* h, const float* coef3,
                                    const float* scal, float* lt_out, float* l3_out,
                                    float* u12_out, float* u3_out) {
    const float(*c)[SPLU_NCOEF] = reinterpret_cast<const float(*)[SPLU_NCOEF]>(coef3);
    const float sl = scal[0], su = scal[1], inv_rho = scal[2], rho = scal[3];
    for (int j = b * SPLU_TILE + threadIdx.x; j < n - r; j += nblk * SPLU_TILE) {
        const float l = l3[j], u = u3[j], lu = l * u, w = 1.f / lu, dx = v[r + j], dg = h[r + j];
        float qg2, iqtx2, pg2, ipx2;
        splu_images(r, SpluDirect{lt + r + j, (size_t)n}, SpluDirect{u12 + r + j, (size_t)n}, lu,
                    w, dx, dg, c, qg2, iqtx2, pg2, ipx2);
        const float gl3 = qg2 * qg2 - iqtx2 * iqtx2, gu3 = pg2 * dg - dx * ipx2;
        for (int k = 0; k < r; ++k) {
            const size_t off = (size_t)k * n + r + j;
            const float lk = lt[off], uk = u12[off];
            lt_out[off] = inv_rho * (lk - (c[k][4] * qg2 - c[k][5] * iqtx2) - sl * gl3 * lk);
            u12_out[off] = rho * (uk - (c[k][6] * dg - c[k][7] * ipx2) - su * gu3 * uk);
        }
        l3_out[j] = inv_rho * (l - sl * gl3 * l);
        u3_out[j] = rho * (u - su * gu3 * u);
    }
}

__global__ void __launch_bounds__(SPLU_TILE) splu_stage3_g_kernel(
    int n, int r, const float* __restrict__ lt, const float* __restrict__ l3,
    const float* __restrict__ u12, const float* __restrict__ u3, const float* __restrict__ v,
    const float* __restrict__ h, const float* __restrict__ coef3, const float* __restrict__ scal,
    float* __restrict__ lt_out, float* __restrict__ l3_out, float* __restrict__ u12_out,
    float* __restrict__ u3_out) {
    splu_stage3_g_block(blockIdx.x, gridDim.x, n, r, lt, l3, u12, u3, v, h, coef3, scal, lt_out,
                        l3_out, u12_out, u3_out);
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

static size_t splu_smem(int r, int lt, bool y, int ts = 4) {
    return sizeof(float) * (size_t)splu_tile_floats(r, lt, y, ts);
}

// blocks of the streaming passes (and the one-launch kernel's), and of
// stage 3 without g
static int splu_blocks(int nt, int most = SPLU_MAX_BLOCKS) {
    const int tiles = (nt + SPLU_TILE - 1) / SPLU_TILE;
    return tiles < most ? tiles : most;
}
static int splu_blocks3(int nt) { return splu_blocks(nt, SPLU_MAX_BLOCKS3); }

// stage 1 of the rank-32 kernels takes 256-lane tiles up to rank
// SPLU_S1_WIDE_RANK and 128-lane tiles past it, where its Gram's tiles
// outweigh its copies and a smaller staged tile fits two blocks a SM
__host__ __device__ static bool splu_s1_wide(int r) { return r <= SPLU_S1_WIDE_RANK; }

__host__ __device__ static SpluSrc splu_src(int n, int r, const float* lt, const float* l3,
                                            const float* u12, const float* u3, const float* v,
                                            const float* h, const float* g) {
    return SpluSrc{lt, u12, v, h, l3, u3, g, n, r};
}

struct SpluScratch {
    float *part1, *max1, *gram1, *max2, *part2, *gram2;
    SpluRank* rk;
};

static size_t splu_carve(int n, int r, float* base, SpluScratch* s) {
    const size_t blocks = splu_blocks(n - r), z = 2 * r + 2;
    const size_t sizes[] = {blocks * splu_tiles(1, r, 4) * 16, 2 * blocks, z * z, 2 * blocks,
                            blocks * splu_tiles(2, r, 4) * 16, z * z,
                            sizeof(SpluRank) / sizeof(float)};
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

// Stage 1 (the rank-32 kernels): the reduced Gram into gram and the
// maxima's partials (splu_blocks of them) into s.max1
static void splu_stage1(const SpluSrc& src, int nvalid, const SpluScratch& s, float* gram,
                        cudaStream_t stream) {
    const int r = src.r, blocks = splu_blocks(src.n - r), np = splu_tiles(1, r, 4) * 16;
    if (splu_s1_wide(r))
        splu_stage1_kernel<SPLU_TILE><<<blocks, SPLU_TILE, splu_smem(r, SPLU_TILE, true), stream>>>(
            src, nvalid, s.part1, s.max1);
    else
        splu_stage1_kernel<SPLU_TILE / 2>
            <<<blocks, SPLU_TILE, splu_smem(r, SPLU_TILE / 2, true), stream>>>(src, nvalid, s.part1,
                                                                               s.max1);
    splu_reduce_kernel<<<(np * 32 + 255) / 256, 256, 0, stream>>>(1, r, 4, blocks, s.part1, gram);
}

static cudaError_t splu_smem_attrs() {
    static bool done = false;
    if (done) return cudaSuccess;
    const int tile = (int)splu_smem(SPLU_MAX_RANK, SPLU_TILE, true);
    const void* staged[] = {(const void*)splu_stage1_kernel<SPLU_TILE>,
                            (const void*)splu_stage1_kernel<SPLU_TILE / 2>,
                            (const void*)splu_stage2_kernel, (const void*)splu_stage3_kernel};
    cudaError_t e = cudaSuccess;
    for (const void* k : staged)
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, tile);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(splu_stage1_g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)splu_smem(SPLU_G_MAX_RANK, SPLU_G_TILE, true, SPLU_G_TS));
    const void* corners[] = {(const void*)splu_corner_a_g_kernel, (const void*)splu_corner_b_g_kernel,
                             (const void*)splu_corner_c_g_kernel};
    for (const void* k : corners)
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, RG_SMEM);
    done = e == cudaSuccess;
    return e;
}

static bool splu_generic(int r) { return r > SPLU_MAX_RANK; }

// the generic stage 1's blocks (and its maxima's partials): tiles of
// SPLU_G_TILE lanes up to SPLU_G_MAX_RANK, the lumax pass's past it
static int splu_g1_blocks(int n, int r) {
    const int nt = n - r;
    if (r > SPLU_G_MAX_RANK) return splu_blocks(nt);
    const int tiles = (nt + SPLU_G_TILE - 1) / SPLU_G_TILE;
    return tiles < SPLU_G_BLOCKS ? tiles : SPLU_G_BLOCKS;
}

// The generic chain's scratch: the corners' workspace where it outgrows
// shared memory (first: the sharded entries find it at offset 0), stage
// 1's partial Gram tiles (or past SPLU_G_MAX_RANK the GEMM's bands) and the
// apply's bands (gram_part_floats, at most 256 z^2 floats), the two reduced
// Grams, the maxima, the rank space, and the staged rows: the apply's two
// and, past SPLU_G_MAX_RANK, stage 1's U2 w
struct SpluScratchG {
    float *ws, *part, *max1, *gram1, *max2, *gram2, *w, *e;
    SpluRankG rk;
};

static size_t splu_carve_g(int n, int r, float* base, SpluScratchG* s) {
    const size_t nt = n - r, z = 2 * r + 2, b1 = splu_g1_blocks(n, r);
    const bool staged = r <= SPLU_G_MAX_RANK;
    const size_t p1 = staged ? b1 * splu_tiles(1, r, SPLU_G_TS) * SPLU_G_TS * SPLU_G_TS
                             : gram_part_floats(splu_gram1_plan(n, r, nullptr, nullptr, nullptr));
    const size_t p2 = gram_part_floats(splu_gram2_plan(n, r, nullptr, nullptr, nullptr));
    const size_t ws = rg_in_smem(splu_corner_floats(r)) ? 0 : splu_corner_floats(r);
    const size_t sizes[] = {ws, p1 > p2 ? p1 : p2, 2 * b1, z * z, 2 * (size_t)splu_blocks((int)nt),
                            z * z, 8 * (size_t)r, 8 * (size_t)r, (size_t)r, 2 * (size_t)r, 8,
                            staged ? 0 : r * nt, 2 * nt};
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

static void splu_corner_a_g_launch(int n, int r, int blocks, const float* lt, const float* u12,
                            const float* v, const float* h, const float* gram, const float* maxs,
                            const SpluScratchG& s, cudaStream_t stream) {
    const size_t fl = splu_corner_floats(r);
    splu_corner_a_g_kernel<<<1, RG_THREADS, rg_smem_bytes(fl), stream>>>(
        n, r, blocks, lt, u12, v, h, gram, maxs, s.rk, s.ws, rg_in_smem(fl));
}

static void splu_corner_b_g_launch(int n, int r, int blocks, float step, const float* lt,
                            const float* u12, const float* h, const float* maxs,
                            const SpluScratchG& s, float* lt_out, float* u12_out,
                            cudaStream_t stream) {
    const size_t fl = splu_corner_floats(r);
    splu_corner_b_g_kernel<<<1, RG_THREADS, rg_smem_bytes(fl), stream>>>(
        n, r, blocks, step, lt, u12, h, maxs, s.rk, lt_out, u12_out, s.ws, rg_in_smem(fl));
}

static void splu_corner_c_g_launch(int n, int r, const float* lt_out, const float* u12_out,
                            const float* g, const float* gram2, const SpluScratchG& s, float* pre,
                            cudaStream_t stream) {
    const size_t fl = splu_corner_floats(r);
    splu_corner_c_g_kernel<<<1, RG_THREADS, rg_smem_bytes(fl), stream>>>(
        n, r, lt_out, u12_out, g, gram2, s.rk, pre, s.ws, rg_in_smem(fl));
}

// Stage 1 past SPLU_MAX_RANK: the reduced Gram into gram and the maxima's
// partials (splu_g1_blocks of them) into s.max1
static void splu_stage1_g(const SpluSrc& src, int nvalid, const SpluScratchG& s, float* gram,
                          cudaStream_t stream) {
    const int n = src.n, r = src.r, nt = n - r, blocks = splu_g1_blocks(n, r);
    if (r <= SPLU_G_MAX_RANK) {
        const int tiles = splu_tiles(1, r, SPLU_G_TS);
        splu_stage1_g_kernel<<<dim3(blocks, (tiles + SPLU_TILE - 1) / SPLU_TILE), SPLU_TILE,
                               splu_smem(r, SPLU_G_TILE, true, SPLU_G_TS), stream>>>(
            src, nvalid, s.part, s.max1);
        splu_reduce_kernel<<<(unsigned)(((size_t)tiles * SPLU_G_TS * SPLU_G_TS * 32 + 255) / 256),
                             256, 0, stream>>>(1, r, SPLU_G_TS, blocks, s.part, gram);
        return;
    }
    splu_rows_kernel<<<(nt + SPLU_TILE - 1) / SPLU_TILE, SPLU_TILE, 0, stream>>>(
        n, r, src.l3, src.u12, src.u3, src.v, src.h, nullptr, s.w, s.e);
    gram_launch(splu_gram1_plan(n, r, src.lt, s.w, s.e), s.part, gram, stream);
    splu_lumax_kernel<<<blocks, SPLU_TILE, 0, stream>>>(nt, nvalid, src.l3, src.u3, s.max1);
}

// the apply's Gram over the new tail past SPLU_MAX_RANK: its two staged
// rows, then the GEMM's bands and their sums into gram
static void splu_gram2_g(int n, int r, const float* lt_out, const float* l3_out,
                         const float* u12_out, const float* u3_out, const float* g,
                         const SpluScratchG& s, float* gram, cudaStream_t stream) {
    const int nt = n - r;
    splu_rows_kernel<<<(nt + SPLU_TILE - 1) / SPLU_TILE, SPLU_TILE, 0, stream>>>(
        n, r, l3_out, u12_out, u3_out, nullptr, nullptr, g, s.w, s.e);
    gram_launch(splu_gram2_plan(n, r, lt_out, u12_out, s.e), s.part, gram, stream);
}

// The chain past SPLU_MAX_RANK: stage 1, corner A, stage 2, corner B,
// stage 3 and, with g, the apply's Gram, corner C and stage 4
static int splu_update_g(int n, int r, const float* lt, const float* l3, const float* u12,
                         const float* u3, const float* v, const float* h, const float* g,
                         float step, float* lt_out, float* l3_out, float* u12_out, float* u3_out,
                         float* pre, float* scratch, cudaStream_t stream) {
    SpluScratchG s;
    splu_carve_g(n, r, scratch, &s);
    const int nt = n - r, blocks = splu_blocks(nt);
    splu_stage1_g(splu_src(n, r, lt, l3, u12, u3, v, h, nullptr), nt, s, s.gram1, stream);
    splu_corner_a_g_launch(n, r, splu_g1_blocks(n, r), lt, u12, v, h, s.gram1, s.max1, s,
                           stream);
    splu_stage2_g_kernel<<<blocks, SPLU_TILE, 0, stream>>>(n, r, lt, l3, u12, u3, v, h, s.rk.coef2,
                                                           s.max2);
    splu_corner_b_g_launch(n, r, blocks, step, lt, u12, h, s.max2, s, lt_out, u12_out, stream);
    splu_stage3_g_kernel<<<splu_blocks3(nt), SPLU_TILE, 0, stream>>>(
        n, r, lt, l3, u12, u3, v, h, s.rk.coef3, s.rk.scal, lt_out, l3_out, u12_out, u3_out);
    if (g) {
        splu_gram2_g(n, r, lt_out, l3_out, u12_out, u3_out, g, s, s.gram2, stream);
        splu_corner_c_g_launch(n, r, lt_out, u12_out, g, s.gram2, s, pre, stream);
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
    const SpluSrc src = splu_src(n, r, lt, l3, u12, u3, v, h, nullptr);

    splu_stage1(src, nt, s, s.gram1, stream);
    splu_corner_a_kernel<<<1, 32, 0, stream>>>(n, r, blocks, lt, u12, v, h, s.gram1, s.max1, s.rk);
    splu_stage2_kernel<<<blocks, SPLU_TILE, splu_smem(r, SPLU_TILE, false), stream>>>(src, s.rk,
                                                                                     s.max2);
    splu_corner_b_kernel<<<1, 32, 0, stream>>>(n, r, blocks, step, lt, u12, h, s.max2, s.rk, lt_out,
                                               u12_out);
    splu_stage3_kernel<<<g ? blocks : splu_blocks3(nt), SPLU_TILE, splu_smem(r, SPLU_TILE, g),
                         stream>>>(splu_src(n, r, lt, l3, u12, u3, v, h, g), s.rk, lt_out, l3_out,
                                   u12_out, u3_out, s.part2);
    if (g) {
        const int np2 = splu_tiles(2, r, 4) * 16;
        splu_reduce_kernel<<<(np2 * 32 + 255) / 256, 256, 0, stream>>>(2, r, 4, blocks, s.part2,
                                                                       s.gram2);
        splu_corner_c_kernel<<<1, 32, 0, stream>>>(n, r, lt_out, u12_out, g, s.gram2, s.rk, o(prep));
        splu_stage4_kernel<<<(nt + SPLU_TILE - 1) / SPLU_TILE, SPLU_TILE, 0, stream>>>(
            n, r, lt_out, l3_out, u12_out, u3_out, g, s.rk, o(prep));
    }
    return (int)cudaGetLastError();
}

// ------------------------------------------------- the one-launch schedule
// Replaces psgd_tf_tpu/ops/pallas/splu_upd.py `fused_update_apply_mono`
// (:533) → its pallas_call (:582, `_mono_kernel` :301), the whole update and
// P' g in one launch at any rank, and psgd_tf_tpu/ops/pallas/splu_one.py
// `_call` (:223) → its pallas_call (:286), the same with or without g over
// a state that stays resident (K15). The TPU kernel is a sequential grid of
// 4 nb steps that sweeps the tail four times, with the corner algebra at
// the steps nb, 2 nb and 3 nb. Here one launch of a resident grid walks
// the chain's blocks b = blockIdx.x, blockIdx.x + gridDim.x, ... and runs
// the chain's own block bodies, so every partial Gram tile and every
// maximum is the chain's, and the result equals the chain's
// (`psgd_splu_update`, with or without g) bit for bit at every n and r. A
// barrier stands at each of the chain's launch boundaries, where CTA 0 runs
// the corner bodies (warp 0 the rank-32 ones, after the CTA has staged their
// r x r blocks in shared memory) and the other CTAs wait at the next
// barrier. Stage 4 reads the new tail that stage 3 wrote, after the barrier.
// Up to SPLU_MAX_RANK it is splu_mono_kernel, past it splu_mono_g_kernel
// with the rank-generic chain's bodies: stage 1's streamed 8 x 8 Gram tiles
// up to SPLU_G_MAX_RANK, the block-wide corners (their vectors in shared
// memory while they fit in RG_SMEM, in the scratch past it), stages 2-4 a
// lane a thread, and the Grams the chain takes through kron_dd.cu's grouped
// GEMM (the apply's, and stage 1's past SPLU_G_MAX_RANK) as that GEMM's
// work items between barriers (rank_space.cuh's gram_tiles, the GEMM's own
// tile body from gemm_tile.cuh, then gram_sums), so the partial tiles and
// the Gram are the GEMM's.
//
// The schedule (the barrier) is picked by the host from the work's size,
// or forced by the caller (SPLU_GRID, SPLU_CLUSTER):
//   grid     a cooperative launch of min(work, SMs x the CTAs a SM holds)
//            CTAs, grid.sync() between phases (the earlier one-launch
//            kernel's schedule);
//   cluster  a thread-block cluster of min(work, SPLU_MAX_CLUSTER) CTAs
//            (one CTA at one block of work; up to 16 where the card holds
//            such a cluster, else 8), the cluster's hardware barrier
//            between phases, a gpu-scope fence on either side.
// The partials stay in the scratch (L2 at these sizes) in both schedules,
// so both give the same bits.
//
// What bounds it: the same bytes as the chain (chip_smoke.splu_work): memory
// at large n; at K15's sizes (a state of at most ~14 MB, held by the 50 MB
// L2 after the first pass) the corners, the barriers and the host's enqueue.
// One launch trades the chain's six to eleven launches for one and up to
// eight (past rank 128 with g, twelve) barriers. One kernel holds every
// stage, so its registers (capped at two CTAs a SM up to SPLU_MAX_RANK,
// one past it, where two spilled) and dynamic shared
// memory are those of the largest: at r <= 32 stage 3's staged tiles with g
// (215,680 bytes at r = 32, 78,224 at r = 10); past it stage 1's streamed
// tile (214,976 at r = 128), or the corners' vectors (16 r floats) past
// SPLU_G_MAX_RANK. A launch the card refuses is returned, never replaced.

// the coefficients, the block max, a CTA's own rank space (replicated corners)
#define SPLU_RANK_FLOATS ((int)(sizeof(SpluRank) / sizeof(float) + 3) / 4 * 4)
#define SPLU_MONO_HEAD (SPLU_MAX_RANK * SPLU_NCOEF + 32 + SPLU_RANK_FLOATS)
#define SPLU_REP_BLOCKS 4  // the rank-32 kernel replicates its corners up to these blocks
#define SPLU_MONO_G_HEAD 32                               // the generic kernel's block max
#define SPLU_MAX_CLUSTER 16

enum SpluSched { SPLU_AUTO = -1, SPLU_GRID = 0, SPLU_CLUSTER = 1 };

// the barrier between two phases of a one-launch kernel; every thread of
// the launch reaches it
template <int SCHED>
__device__ __forceinline__ void splu_phase_sync() {
    namespace cg = cooperative_groups;
    if constexpr (SCHED == SPLU_GRID) {
        cg::this_grid().sync();
    } else {
        __syncthreads();
        if (threadIdx.x == 0) __threadfence();
        cg::this_cluster().sync();
        if (threadIdx.x == 0) __threadfence();
        __syncthreads();
    }
}

struct SpluMono {
    int n, r, blocks;
    float step;
    const float *lt, *l3, *u12, *u3, *v, *h, *g;  // g null: the update alone
    float *lt_out, *l3_out, *u12_out, *u3_out, *pre;
    SpluScratch s;
};

static size_t splu_smem_mono(int r) {
    const size_t zs = splu_tile_floats(r, SPLU_TILE, true, 4);
    const size_t corner = SPLU_CORNER_A + (2 * SPLU_MAX_RANK + 2) * (2 * SPLU_MAX_RANK + 2);
    return sizeof(float) * (SPLU_MONO_HEAD + (zs > corner ? zs : corner));
}

// Up to SPLU_MAX_RANK. Every thread of the launch runs every line here: the
// barriers are reached by all, and only the corners sit behind a branch
// (a CTA stages, its warp 0 computes). Buffers written inside the launch
// are read through plain pointers (no __restrict__, no read-only cache).
// Up to SPLU_REP_BLOCKS blocks (n up to ~1k) every CTA replicates the
// reductions and corners into its own shared memory (the same sums in the
// same order, so the same bits; CTA 0 alone writes the corner's outputs):
// four barriers fewer. Past it CTA 0 runs them between barriers.
template <int SCHED>
__global__ void __launch_bounds__(SPLU_TILE, 2) splu_mono_kernel(const __grid_constant__ SpluMono a) {
    extern __shared__ float4 sm4[];
    float* sm = reinterpret_cast<float*>(sm4);
    float(*c)[SPLU_NCOEF] = reinterpret_cast<float(*)[SPLU_NCOEF]>(sm);
    float* red = sm + SPLU_MAX_RANK * SPLU_NCOEF;
    float* work = sm + SPLU_MONO_HEAD;  // a stage's tile, or a corner's workspace
    const int n = a.n, r = a.r, nb = a.blocks, nt = n - r;
    const bool rep = nb <= SPLU_REP_BLOCKS, cta0 = blockIdx.x == 0;
    const bool mine = rep || cta0, corner = mine && threadIdx.x < 32;
    const SpluScratch s = a.s;
    SpluRank* rk = rep ? reinterpret_cast<SpluRank*>(red + 32) : s.rk;
    float* gram = work + SPLU_CORNER_A;  // a replicating CTA's own Gram
    const SpluSrc src = splu_src(n, r, a.lt, a.l3, a.u12, a.u3, a.v, a.h, nullptr);

    for (int b = blockIdx.x; b < nb; b += gridDim.x) {
        if (splu_s1_wide(r))
            splu_stage1_block<SPLU_TILE, 4>(b, nb, 0, src, nt, s.part1, s.max1, work, red);
        else
            splu_stage1_block<SPLU_TILE / 2, 4>(b, nb, 0, src, nt, s.part1, s.max1, work, red);
    }
    splu_phase_sync<SCHED>();
    if (rep) {
        const int np = splu_tiles(1, r, 4) * 16;
        for (int e = threadIdx.x; e < np; e += SPLU_TILE)
            splu_reduce_entry_thread(1, r, 4, np, nb, e, s.part1, gram);
        __syncthreads();
    } else {
        splu_reduce_all(1, r, 4, nb, s.part1, s.gram1);
        gram = s.gram1;
        splu_phase_sync<SCHED>();
    }
    float* mx = red + 16;  // a corner's maxima, folded by its CTA
    if (mine) {
        splu_corner_load(0, n, r, a.lt, a.u12, gram, work, SPLU_TILE);
        splu_fold_max(s.max1, nb, splu_neg_inf(), mx, red);
        __syncthreads();
    }
    if (corner) splu_corner_a(n, r, 1, a.lt, a.u12, a.v, a.h, gram, mx, rk, work, true);
    if (rep) __syncthreads();
    else splu_phase_sync<SCHED>();
    splu_load_coef(c, rk->coef2, r);
    __syncthreads();
    for (int b = blockIdx.x; b < nb; b += gridDim.x)
        splu_stage2_block(b, nb, src, c, s.max2, work, red);
    splu_phase_sync<SCHED>();
    if (mine) {
        splu_corner_load(1, n, r, a.lt, a.u12, nullptr, work, SPLU_TILE);
        splu_fold_max(s.max2, nb, 0.f, mx, red);
        __syncthreads();
    }
    if (corner)
        splu_corner_b(n, r, 1, a.step, a.lt, a.u12, a.h, mx, rk, a.lt_out, a.u12_out, work,
                      true, cta0);
    if (mine) __syncthreads();
    if (cta0) splu_corner_b_rows(n, r, work, rk->scal, a.lt_out, a.u12_out, SPLU_TILE);
    if (rep) __syncthreads();
    else splu_phase_sync<SCHED>();
    splu_load_coef(c, rk->coef3, r);
    __syncthreads();
    const float sl = rk->scal[0], su = rk->scal[1], inv_rho = rk->scal[2], rho = rk->scal[3];
    SpluSrc src3 = src;
    src3.g = a.g;
    for (int b = blockIdx.x; b < nb; b += gridDim.x)
        splu_stage3_block(b, nb, src3, c, sl, su, inv_rho, rho, a.lt_out, a.l3_out, a.u12_out,
                          a.u3_out, s.part2, work);
    if (!a.g) return;
    splu_phase_sync<SCHED>();
    gram = work + SPLU_CORNER_A;
    if (rep) {
        const int np = splu_tiles(2, r, 4) * 16;
        for (int e = threadIdx.x; e < np; e += SPLU_TILE)
            splu_reduce_entry_thread(2, r, 4, np, nb, e, s.part2, gram);
        __syncthreads();
    } else {
        splu_reduce_all(2, r, 4, nb, s.part2, s.gram2);
        gram = s.gram2;
        splu_phase_sync<SCHED>();
    }
    if (mine) {
        splu_corner_load(2, n, r, a.lt_out, a.u12_out, gram, work, SPLU_TILE);
        __syncthreads();
    }
    if (corner) splu_corner_c(n, r, a.lt_out, a.u12_out, a.g, gram, rk, a.pre, work, true, cta0);
    if (rep) __syncthreads();
    else splu_phase_sync<SCHED>();
    float(*c4)[2] = reinterpret_cast<float(*)[2]>(sm);
    splu_load_coef(c4, rk->coef4, r);
    __syncthreads();
    for (int j = blockIdx.x * SPLU_TILE + threadIdx.x; j < nt; j += gridDim.x * SPLU_TILE)
        splu_stage4_lane(j, n, r, c4, a.lt_out, a.l3_out, a.u12_out, a.u3_out, a.g, a.pre);
}

struct SpluMonoG {
    int n, r;
    int blocks;   // stage 2's (its maxima's partials): splu_blocks(nt)
    int b1, ys;   // stage 1's blocks (its maxima's partials) and y-slices
    int blocks3;  // stage 3's: splu_blocks3(nt)
    int splits1, splits2, corner_smem;
    float step;
    const float *lt, *l3, *u12, *u3, *v, *h, *g;  // g null: the update alone
    float *lt_out, *l3_out, *u12_out, *u3_out, *pre;
    SpluScratchG s;
    GramPlan p1, p2;  // stage 1's Gram past SPLU_G_MAX_RANK, the apply's
};

// Past SPLU_MAX_RANK: the rank-generic chain (splu_update_g) in one launch.
template <int SCHED>
__global__ void __launch_bounds__(SPLU_TILE, 1) splu_mono_g_kernel(const __grid_constant__ SpluMonoG a) {
    static_assert(SPLU_TILE == RG_THREADS, "CTA 0 runs the block-wide corners");
    extern __shared__ float4 sm4[];
    float* sm = reinterpret_cast<float*>(sm4);
    float* red = sm;
    float* work = sm + SPLU_MONO_G_HEAD;  // a stage's tile, a Gram tile, or a corner's vectors
    const int n = a.n, r = a.r, nt = n - r;
    const SpluScratchG& s = a.s;
    const int lane0 = blockIdx.x * SPLU_TILE + threadIdx.x, lanes = gridDim.x * SPLU_TILE;
    float* cws = a.corner_smem ? work : s.ws;

    if (r <= SPLU_G_MAX_RANK) {
        const SpluSrc src = splu_src(n, r, a.lt, a.l3, a.u12, a.u3, a.v, a.h, nullptr);
        for (int w = blockIdx.x; w < a.b1 * a.ys; w += gridDim.x)
            splu_stage1_block<SPLU_G_TILE, SPLU_G_TS>(w % a.b1, a.b1, w / a.b1, src, nt, s.part,
                                                      s.max1, work, red);
        splu_phase_sync<SCHED>();
        splu_reduce_all(1, r, SPLU_G_TS, a.b1, s.part, s.gram1);
    } else {
        for (int j = lane0; j < nt; j += lanes)
            splu_rows_lane(j, n, r, a.l3, a.u12, a.u3, a.v, a.h, nullptr, s.w, s.e);
        for (int b = blockIdx.x; b < a.b1; b += gridDim.x)
            splu_lumax_block(b, a.b1, nt, nt, a.l3, a.u3, s.max1, red);
        splu_phase_sync<SCHED>();
        gram_tiles(a.p1, a.splits1, s.part, work);
        splu_phase_sync<SCHED>();
        gram_sums(a.p1, a.splits1, s.part, s.gram1);
    }
    splu_phase_sync<SCHED>();
    if (blockIdx.x == 0)
        splu_corner_a_g(n, r, a.b1, a.lt, a.u12, a.v, a.h, s.gram1, s.max1, s.rk, cws, red);
    splu_phase_sync<SCHED>();
    for (int b = blockIdx.x; b < a.blocks; b += gridDim.x)
        splu_stage2_g_block(b, a.blocks, n, r, a.lt, a.l3, a.u12, a.u3, a.v, a.h, s.rk.coef2,
                            s.max2, red);
    splu_phase_sync<SCHED>();
    if (blockIdx.x == 0)
        splu_corner_b_g(n, r, a.blocks, a.step, a.lt, a.u12, a.h, s.max2, s.rk, a.lt_out,
                        a.u12_out, cws, red);
    splu_phase_sync<SCHED>();
    for (int b = blockIdx.x; b < a.blocks3; b += gridDim.x)
        splu_stage3_g_block(b, a.blocks3, n, r, a.lt, a.l3, a.u12, a.u3, a.v, a.h, s.rk.coef3,
                            s.rk.scal, a.lt_out, a.l3_out, a.u12_out, a.u3_out);
    if (!a.g) return;
    splu_phase_sync<SCHED>();
    for (int j = lane0; j < nt; j += lanes)
        splu_rows_lane(j, n, r, a.l3_out, a.u12_out, a.u3_out, nullptr, nullptr, a.g, s.w, s.e);
    splu_phase_sync<SCHED>();
    gram_tiles(a.p2, a.splits2, s.part, work);
    splu_phase_sync<SCHED>();
    gram_sums(a.p2, a.splits2, s.part, s.gram2);
    splu_phase_sync<SCHED>();
    if (blockIdx.x == 0)
        splu_corner_c_g(n, r, a.lt_out, a.u12_out, a.g, s.gram2, s.rk, a.pre, cws);
    splu_phase_sync<SCHED>();
    for (int j = lane0; j < nt; j += lanes)
        splu_stage4_lane(j, n, r, reinterpret_cast<const float(*)[2]>(s.rk.coef4), a.lt_out,
                         a.l3_out, a.u12_out, a.u3_out, a.g, a.pre);
}

static size_t splu_smem_mono_g(int r) {
    size_t f = GemmTile<1, 1>::SMEM / sizeof(float);
    if (r <= SPLU_G_MAX_RANK) f = std::max(f, (size_t)splu_tile_floats(r, SPLU_G_TILE, true, SPLU_G_TS));
    const size_t cf = splu_corner_floats(r);
    if (rg_in_smem(cf)) f = std::max(f, cf);
    return sizeof(float) * (SPLU_MONO_G_HEAD + f);
}

// One-launch kernel k of the four: (generic ? 2 : 0) + schedule
static const void* splu_mono_fn(int k) {
    static const void* fns[4] = {
        (const void*)splu_mono_kernel<SPLU_GRID>, (const void*)splu_mono_kernel<SPLU_CLUSTER>,
        (const void*)splu_mono_g_kernel<SPLU_GRID>, (const void*)splu_mono_g_kernel<SPLU_CLUSTER>};
    return fns[k];
}

// the dynamic shared memory each kernel may take, raised once per device
static cudaError_t splu_mono_attrs(int dev) {
    static unsigned long long done = 0;  // a bit per device
    if (dev < 64 && (done >> dev & 1)) return cudaSuccess;
    const int most[2] = {(int)splu_smem_mono(SPLU_MAX_RANK),
                         (int)std::max(splu_smem_mono_g(SPLU_G_MAX_RANK),
                                       sizeof(float) * SPLU_MONO_G_HEAD + RG_SMEM)};
    cudaError_t e = cudaSuccess;
    for (int k = 0; k < 4 && e == cudaSuccess; ++k) {
        e = cudaFuncSetAttribute(splu_mono_fn(k), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most[k / 2]);
        if (e == cudaSuccess && k % 2 == SPLU_CLUSTER)
            e = cudaFuncSetAttribute(splu_mono_fn(k), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e == cudaSuccess && dev < 64) done |= 1ULL << dev;
    return e;
}

// What the card answers for kernel k at smem bytes: CTAs a SM (grid) or the
// cluster's size (cluster), SMs, registers; kept per device, kernel and
// shared memory after the first query
struct SpluOcc {
    int dev, k;
    size_t smem;
    int q[3];
};

static cudaError_t splu_mono_occ(int k, size_t smem, int* q) {
    static SpluOcc known[64];
    static int nknown = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    for (int i = 0; i < nknown; ++i)
        if (known[i].dev == dev && known[i].k == k && known[i].smem == smem) {
            for (int j = 0; j < 3; ++j) q[j] = known[i].q[j];
            return cudaSuccess;
        }
    int coop = 0, sms = 0, per = 0;
    cudaFuncAttributes attr;
    e = splu_mono_attrs(dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, splu_mono_fn(k));
    if (e != cudaSuccess) return e;
    if (k % 2 == SPLU_GRID) {
        if (!coop) return cudaErrorNotSupported;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, splu_mono_fn(k), SPLU_TILE, smem);
        if (e != cudaSuccess) return e;
        if (per < 1) return cudaErrorCooperativeLaunchTooLarge;
    } else {
        for (per = SPLU_MAX_CLUSTER; per >= 1; per /= 2) {  // the largest cluster the card holds
            cudaLaunchConfig_t cfg = {};
            cudaLaunchAttribute at;
            at.id = cudaLaunchAttributeClusterDimension;
            at.val.clusterDim.x = per;
            at.val.clusterDim.y = at.val.clusterDim.z = 1;
            cfg.gridDim = dim3(per);
            cfg.blockDim = dim3(SPLU_TILE);
            cfg.dynamicSmemBytes = smem;
            cfg.attrs = &at;
            cfg.numAttrs = 1;
            int clusters = 0;
            e = cudaOccupancyMaxActiveClusters(&clusters, splu_mono_fn(k), &cfg);
            if (e != cudaSuccess) return e;
            if (clusters >= 1) break;
        }
        if (per < 1) return cudaErrorLaunchOutOfResources;
    }
    const int q3[3] = {per, sms, attr.numRegs};
    for (int j = 0; j < 3; ++j) q[j] = q3[j];
    if (nknown < 64) known[nknown++] = SpluOcc{dev, k, smem, {q3[0], q3[1], q3[2]}};
    return cudaSuccess;
}

// The generic one-launch kernel's sizes for a rank-r state over n
// parameters (its Grams' plans without pointers), with g or without, and
// its work: the most blocks or work items of any phase
static void splu_mono_args(int n, int r, bool has_g, SpluMonoG& a, long long& work) {
    const int nt = n - r;
    a.n = n;
    a.r = r;
    a.blocks = splu_blocks(nt);
    a.b1 = splu_g1_blocks(n, r);
    a.ys = r <= SPLU_G_MAX_RANK ? (splu_tiles(1, r, SPLU_G_TS) + SPLU_TILE - 1) / SPLU_TILE : 1;
    a.blocks3 = splu_blocks3(nt);
    a.corner_smem = rg_in_smem(splu_corner_floats(r));
    a.splits1 = a.splits2 = 1;
    work = std::max<long long>((long long)a.b1 * a.ys, a.blocks3);
    if (r <= SPLU_G_MAX_RANK)  // its reduction: an entry a thread
        work = std::max<long long>(work, ((long long)splu_tiles(1, r, SPLU_G_TS) * SPLU_G_TS *
                                          SPLU_G_TS + SPLU_TILE - 1) / SPLU_TILE);
    if (r > SPLU_G_MAX_RANK) {
        a.p1 = splu_gram1_plan(n, r, nullptr, nullptr, nullptr);
        a.splits1 = gram_splits(a.p1);
        work = std::max(work, gram_items(a.p1, a.splits1));
    }
    if (has_g) {
        a.p2 = splu_gram2_plan(n, r, nullptr, nullptr, nullptr);
        a.splits2 = gram_splits(a.p2);
        work = std::max(work, gram_items(a.p2, a.splits2));
    }
}

// The schedule and grid of the one launch for a rank-r state over n
// parameters, with or without g: out = {grid, CTAs a SM (grid) or the
// largest cluster the card holds (cluster), SMs, registers a thread,
// schedule}.
// sched: SPLU_AUTO picks by the work (the most blocks of any phase), or
// forces one. Fails where the card takes no such launch.
extern "C" int psgd_splu_mono_grid(int n, int r, int has_g, int sched, int* out) {
    if (r < 1 || n - r < 1 || sched < SPLU_AUTO || sched > SPLU_CLUSTER)
        return (int)cudaErrorInvalidValue;
    long long work;
    size_t smem;
    if (splu_generic(r)) {
        SpluMonoG a;
        splu_mono_args(n, r, has_g != 0, a, work);
        smem = splu_smem_mono_g(r);
    } else {
        work = splu_blocks(n - r);
        smem = splu_smem_mono(r);
    }
    // by measurement (H100 80GB HBM3, 700 W, tools/tri_lra_ab.py --splu,
    // queued K15 update + apply): at (400, 10), two blocks, the cluster
    // 0.0459-0.0461 ms, the grid 0.0484-0.0487; at (65,536, 10) the grid
    // 0.0592, the 16-CTA cluster 0.311; at (400, 64), 39 CTAs of work, the
    // grid 0.236-0.239, the cluster 0.243
    if (sched == SPLU_AUTO) sched = work <= SPLU_MAX_CLUSTER ? SPLU_CLUSTER : SPLU_GRID;
    int q[3];
    const cudaError_t e = splu_mono_occ((splu_generic(r) ? 2 : 0) + sched, smem, q);
    if (e != cudaSuccess) return (int)e;
    const long long most = sched == SPLU_GRID ? (long long)q[0] * q[1] : q[0];
    out[0] = (int)std::max(1LL, std::min(work, most));
    out[1] = q[0];
    out[2] = q[1];
    out[3] = q[2];
    out[4] = sched;
    return (int)cudaSuccess;
}

template <class Args>
static cudaError_t splu_mono_launch(int k, int grid, size_t smem, const Args& a,
                                    cudaStream_t stream) {
    const void* fn = splu_mono_fn(k);
    Args copy = a;
    void* args[] = {&copy};
    if (k % 2 == SPLU_GRID)
        return cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(SPLU_TILE), args, smem, stream);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at;
    at.id = cudaLaunchAttributeClusterDimension;
    at.val.clusterDim.x = grid;
    at.val.clusterDim.y = at.val.clusterDim.z = 1;
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(SPLU_TILE);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &at;
    cfg.numAttrs = 1;
    return cudaLaunchKernelExC(&cfg, fn, args);
}

// The update (and with g non-null pre = P' g) in one launch; the arguments
// as psgd_splu_update's, then the schedule (SPLU_AUTO, or one forced).
// Returns the launch's error: a launch the card refuses runs nothing.
extern "C" int psgd_splu_mono(int n, int r, const void* ltp, const void* l3p, const void* u12p,
                              const void* u3p, const void* vp, const void* hp, const void* gp,
                              float step, void* lt_outp, void* l3_outp, void* u12_outp,
                              void* u3_outp, void* prep, void* scratch, int sched,
                              void* stream_ptr) {
    int grid[5];
    cudaError_t e = (cudaError_t)psgd_splu_mono_grid(n, r, gp != nullptr, sched, grid);
    if (e != cudaSuccess) return (int)e;
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    auto o = [](void* p) { return static_cast<float*>(p); };
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int k = (splu_generic(r) ? 2 : 0) + grid[4];
    if (splu_generic(r)) {
        SpluMonoG a;
        long long work;
        splu_mono_args(n, r, gp != nullptr, a, work);
        a.step = step;
        a.g = f(gp);
        a.lt = f(ltp), a.l3 = f(l3p), a.u12 = f(u12p), a.u3 = f(u3p), a.v = f(vp), a.h = f(hp);
        a.lt_out = o(lt_outp), a.l3_out = o(l3_outp), a.u12_out = o(u12_outp);
        a.u3_out = o(u3_outp), a.pre = o(prep);
        splu_carve_g(n, r, o(scratch), &a.s);
        if (r > SPLU_G_MAX_RANK) a.p1 = splu_gram1_plan(n, r, a.lt, a.s.w, a.s.e);
        if (a.g) a.p2 = splu_gram2_plan(n, r, a.lt_out, a.u12_out, a.s.e);
        e = splu_mono_launch(k, grid[0], splu_smem_mono_g(r), a, stream);
    } else {
        SpluMono a = {n, r, splu_blocks(n - r), step, f(ltp), f(l3p), f(u12p), f(u3p), f(vp),
                      f(hp), f(gp), o(lt_outp), o(l3_outp), o(u12_outp), o(u3_outp), o(prep), {}};
        splu_carve(n, r, o(scratch), &a.s);
        e = splu_mono_launch(k, grid[0], splu_smem_mono(r), a, stream);
    }
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

// stage 1: gram1 (2r+2, 2r+2) (every entry up to rank SPLU_G_MAX_RANK, the
// ones the algebra reads past it) and max1 = (max l3, max u3) of the valid
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
    const SpluSrc src = splu_src(n, r, f(ltp), f(l3p), f(u12p), f(u3p), f(vp), f(hp), nullptr);
    float* maxp;
    int blocks;
    if (splu_generic(r)) {
        SpluScratchG s;
        splu_carve_g(n, r, static_cast<float*>(scratch), &s);
        splu_stage1_g(src, nvalid, s, static_cast<float*>(gram1), stream);
        maxp = s.max1;
        blocks = splu_g1_blocks(n, r);
    } else {
        SpluScratch s;
        splu_carve(n, r, static_cast<float*>(scratch), &s);
        splu_stage1(src, nvalid, s, static_cast<float*>(gram1), stream);
        maxp = s.max1;
        blocks = splu_blocks(n - r);
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
        splu_corner_a_g_launch(n, r, 1, f(ltp), f(u12p), f(vp), f(hp), f(gram1), f(max1), s,
                               stream);
        splu_stage2_g_kernel<<<blocks, SPLU_TILE, 0, stream>>>(n, r, f(ltp), f(l3p), f(u12p), f(u3p),
                                                               f(vp), f(hp), s.rk.coef2, s.max2);
        maxp = s.max2;
    } else {
        SpluScratch s;
        splu_carve(n, r, static_cast<float*>(scratch), &s);
        splu_corner_a_kernel<<<1, 32, 0, stream>>>(n, r, 1, f(ltp), f(u12p), f(vp), f(hp), f(gram1),
                                                   f(max1), s.rk);
        splu_stage2_kernel<<<blocks, SPLU_TILE, splu_smem(r, SPLU_TILE, false), stream>>>(
            splu_src(n, r, f(ltp), f(l3p), f(u12p), f(u3p), f(vp), f(hp), nullptr), s.rk, s.max2);
        maxp = s.max2;
    }
    splu_maxfold_kernel<<<1, 32, 0, stream>>>(blocks, 0.f, maxp, static_cast<float*>(max2));
    return (int)cudaGetLastError();
}

// corner B and stage 3: the new corner and this rank's new tail; with g
// (non-null) also gram2 (2r+2, 2r+2), the apply Gram over this rank's tail
// (the entries the algebra reads); max2 is the maxima over all ranks
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
    const int nt = n - r, blocks = splu_blocks(nt);
    const float* g = f(gp);
    if (splu_generic(r)) {
        SpluScratchG s;
        splu_carve_g(n, r, static_cast<float*>(scratch), &s);
        splu_corner_b_g_launch(n, r, 1, step, f(ltp), f(u12p), f(hp), f(max2), s, o(lt_outp),
                               o(u12_outp), stream);
        splu_stage3_g_kernel<<<splu_blocks3(nt), SPLU_TILE, 0, stream>>>(
            n, r, f(ltp), f(l3p), f(u12p), f(u3p), f(vp), f(hp), s.rk.coef3, s.rk.scal, o(lt_outp),
            o(l3_outp), o(u12_outp), o(u3_outp));
        if (g)
            splu_gram2_g(n, r, o(lt_outp), o(l3_outp), o(u12_outp), o(u3_outp), g, s, o(gram2),
                         stream);
        return (int)cudaGetLastError();
    }
    SpluScratch s;
    splu_carve(n, r, static_cast<float*>(scratch), &s);
    splu_corner_b_kernel<<<1, 32, 0, stream>>>(n, r, 1, step, f(ltp), f(u12p), f(hp), f(max2), s.rk,
                                               o(lt_outp), o(u12_outp));
    splu_stage3_kernel<<<g ? blocks : splu_blocks3(nt), SPLU_TILE, splu_smem(r, SPLU_TILE, g),
                         stream>>>(splu_src(n, r, f(ltp), f(l3p), f(u12p), f(u3p), f(vp), f(hp), g),
                                   s.rk, o(lt_outp), o(l3_outp), o(u12_outp), o(u3_outp), s.part2);
    if (g) {
        const int np2 = splu_tiles(2, r, 4) * 16;
        splu_reduce_kernel<<<(np2 * 32 + 255) / 256, 256, 0, stream>>>(2, r, 4, blocks, s.part2,
                                                                       o(gram2));
    }
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
        splu_corner_c_g_launch(n, r, f(lt_outp), f(u12_outp), f(gp), f(gram2), s, pre, stream);
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
