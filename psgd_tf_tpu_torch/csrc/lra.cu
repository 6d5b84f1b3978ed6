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
//   reduce    the partials summed in block order, a warp an entry (not
//             launched when one block took every lane);
//   corner A  one block: the rebalance (cu cv = 1), I + G = I + V U^T and
//             its two r x r solves by LU with partial pivoting (the
//             algorithm of torch.linalg.solve_ex: I + V U^T is not
//             symmetric), aa, bb, ab, the norm of the branch `update_u`
//             names, the step scale, and the coefficients coef (r, 10)
//             (columns 0-3 the probe images', 4-9 the U/V update's) and
//             scal = (cu, cv);
//   stage 3   per lane: U', V' and the unscaled d-gradient nablaD, with each
//             block's max|nablaD|; with g also the partial Grams of
//             Z2 = [U'; V'; d g; d g nablaD] (the entries corner B reads);
//   reduce    as above, with max|nablaD| folded;
//   corner B  one block: mu_d = step / (max|nablaD| + tiny), saturated; with
//             g (t1, t2) = coef4 (r, 2) from the apply Gram (y = d' g =
//             y0 - mu_d y1);
//   stage 4   per lane quad d' = d - mu_d d nablaD and, with g,
//             P' g = d' (d' g + t1 U' + t2 V').
// The coins (balance, update_u) and the step arrive as host ints and a
// float; nothing is copied to the host. K14 (lra_upd.fused_update_sharded,
// JAX :487, :554, :467) runs the same kernels through the entries at the
// end of this file, with the host all-reducing between them where the JAX
// package psums and pmaxes: the reduced stage-1 Gram and maxima before
// corner A, the folded max|nablaD| (one float) and the apply Gram before
// corner B.
//
// What bounds it on this card: memory. Two reductions cross every lane (on
// K14 every rank): stage 1 -> corner A and stage 3 -> corner B, so the
// update + apply reads the factors in three passes at the least: stage 1
// reads UV, d, h, v; stage 3 reads them again and writes UV' and nablaD
// (and reads g); stage 4 reads d, nablaD, g and UV' and writes d' and P' g:
// (8r + 13) n floats, 390 MB at n = 2^20, r = 10, 0.130 ms at a 3.0 TB/s
// stream. The Grams are ~2 (2r + 2)^2 n FLOPs (1 GFLOP there).
//
// The design (K16's, csrc/splu.cu). Each streaming pass stages tiles of LT
// lanes of every row it reads in shared memory by 16-byte cp.async, the
// next tile's copies in flight while one is read. Rows need not start on
// 16 bytes (K14 passes a rank's slices and its pipelined chunks at any lane
// offset, and rows ld apart): each row's chunks are copied as they lie and
// read at the row's own offset. Stage 1 puts the tile's Z together aligned
// in Y and sums Z Z^T in TS x TS register tiles of its upper triangle (2 TS
// 16-byte shared loads for 4 TS^2 FMAs a lane quad); a tile's lane quads are
// split over the threads left when the Gram's tiles are few, their sums
// added in slice order. Stage 3 computes a lane's update from the staged
// rows (with LT < 256 the lane's rank rows split over 256 / LT threads,
// their sums joined by shuffles), writes U', V' (into Y with g, where the
// apply's tiles sum U' U'^T and every row against d g, d g nablaD) and
// stores them back in 16-byte stores. Stage 4 reads and writes 16 bytes a
// lane quad where a row is aligned. A streaming grid is sized by the card:
// as many blocks as fit at once on its SMs, each walking the tiles b,
// b + grid, ..., so a rank's n / P lanes fill the card; at most 4 tiles
// take one block, whose partials the corners read without a reduce. No
// float atomics and a grid set by the shapes and the card: a run repeats
// itself bit for bit. Tiles by rank: up to 16 256-lane tiles and 4 x 4
// Gram tiles, to 32 128-lane tiles, to LRA_S_MAX_RANK (128) 64-lane tiles
// and 8 x 8 Gram tiles (in slices of 256 tiles over the grid's y when they
// outnumber the threads, as splu's rank-generic stage 1); the corners take
// one warp up to LRA_MAX_RANK (32) and the block-wide rank-space algebra
// of rank_space.cuh past it. Past LRA_S_MAX_RANK the staged tiles outgrow
// shared memory and the Grams go through kron_dd.cu's grouped GEMM
// (rank_space.cuh: U and V read in place, the two rows the algebra builds
// staged by lra_rows_kernel), stage 3 reads its coefficients in place; its
// extra scratch is the GEMM's bands (at most 256 (2r + 2)^2 floats), the
// staged rows 2n and, past RG_SMEM of shared memory, the corners'
// workspace 24 r + r^2. Measured at n = 2^20 on an NVIDIA H100 80GB HBM3
// at 700 W (tools/tri_lra_ab.py --lra, tools/profile_kron_chain.py
// --lra): update + apply 0.249 ms at r = 10 (stage 1 80 us, stage 3 85,
// stage 4 43, the corners and reduces 25), 0.87 at r = 32, 2.24 at r = 64,
// 8.70 at r = 128; at n = 1,021 and 400 one block and five launches,
// 0.065 and 0.047 ms on the device. Stage 1 at r = 10 streams at 1.2
// TB/s: its 4 x 4 Gram tiles wait on shared-memory loads (8 x 8 tiles ran
// slower, 100 us, at two blocks a SM).
//
// A state or probe that is not finite: the kernels propagate NaN as the
// plain chain and the JAX package do (maxima and step scales keep a NaN;
// the LU's pivot search orders NaN above every number, so every lane
// agrees on the pivot and no shuffle runs under divergence), and never
// fault on it.
#include "psgd.cuh"
#include "rank_space.cuh"

#include <cfloat>
#include <cstdint>

#define LRA_THREADS 256        // threads of a streaming block
#define LRA_MAX_RANK 32        // the warp corners up to it
#define LRA_S_MAX_RANK 128     // the staged stages up to it; the grouped GEMM past it
#define LRA_MAX_Z (2 * LRA_MAX_RANK + 2)
#define LRA_NCOEF 10
#define LRA_ONE_BLOCK_TILES 4  // at most this many tiles take one block
#define LRA_LANE_TILE 256      // lanes of a block of the per-lane kernels
// a staged stage's blocks a SM that its registers must allow (4 x 4 Gram
// tiles in <= 85 registers a thread, 8 x 8 in <= 128)
#define LRA_MIN_BLOCKS(TS) ((TS) == 4 ? 3 : 2)

static_assert(LRA_THREADS == RG_THREADS, "the block-wide corners fold with lra_block_max");

// ------------------------------------------------------------ non-finite values

// max(a, b) that keeps a NaN of either (torch.amax, jnp.max); fmaxf drops it
__device__ __forceinline__ float lra_max(float a, float b) { return (a >= b || a != a) ? a : b; }

// step / (m + tiny) saturated at the fp32 max (linalg.step_scale): a NaN
// stays NaN, where fminf would return FLT_MAX
__device__ __forceinline__ float lra_step_scale(float step, float m) {
    const float s = step / (m + psgd_tiny());
    return s > FLT_MAX ? FLT_MAX : s;
}

// the pivot search's order on |x|: its bits as an int, NaN above inf above
// every number (fabsf clears the sign); -1 for a row outside the search
__device__ __forceinline__ int lra_pivot_key(float x) { return (int)__float_as_uint(fabsf(x)); }

// lra_max over the block (LRA_THREADS threads); every thread gets it
__device__ __forceinline__ float lra_block_max(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v = lra_max(v, __shfl_xor_sync(0xffffffffu, v, o));
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float m = red[0];
    for (int k = 1; k < LRA_THREADS / 32; ++k) m = lra_max(m, red[k]);
    return m;
}

// ------------------------------------------------------------ the staged tile
// A streaming block stages LT lanes of its rows at a time (S, two of them:
// the next tile's copies in flight while one is read), LT + 4 floats a
// row: rows 0..2r-1 UV, 2r d, 2r + 1 h, 2r + 2 v and (stage 3 with g)
// 2r + 3 g. Lane j of row i is at S[i LD + sh[i] + j], sh[i] the row's
// misalignment in floats. Y holds a Gram's rows aligned, zeros past the
// tile's lanes and in the padding to whole TS x TS tiles; N stage 3's
// nablaD.

__host__ __device__ __forceinline__ int lra_cdiv(int a, int b) { return (a + b - 1) / b; }

// the rows of Y: stage 1's Gram padded to whole tiles, the apply's column
// tiles (rows 2r..2r+TS-1)
__host__ __device__ __forceinline__ int lra_yrows(int r, int ts) {
    const int a = lra_cdiv(2 * r + 2, ts) * ts, b = 2 * r + ts;
    return a > b ? a : b;
}

__host__ __device__ __forceinline__ int lra_srows(int r) { return 2 * r + 4; }

// floats of a block's dynamic shared memory: S twice, sh, Y (gram), N
// (stage 3); at least a block's TS^2 accumulators a thread (gram), for
// their sum over the lane slices
__host__ __device__ __forceinline__ int lra_tile_floats(int r, int lt, int ts, bool gram,
                                                        bool stage3) {
    const int ld = lt + 4;
    const int f = 2 * lra_srows(r) * ld + (lra_srows(r) + 3) / 4 * 4 +
                  (gram ? lra_yrows(r, ts) * ld : 0) + (stage3 ? ld : 0);
    const int acc = LRA_THREADS * ts * ts;
    return gram && f < acc ? acc : f;
}

struct LraTile {
    float *S[2], *Y, *N;
    int* sh;
};

__device__ __forceinline__ LraTile lra_tile_carve(float* zs, int r, int lt, int ts, bool gram) {
    const int s = lra_srows(r) * (lt + 4);
    LraTile T;
    T.S[0] = zs;
    T.S[1] = zs + s;
    T.sh = reinterpret_cast<int*>(zs + 2 * s);
    T.Y = zs + 2 * s + (lra_srows(r) + 3) / 4 * 4;
    T.N = T.Y + (gram ? lra_yrows(r, ts) * (lt + 4) : 0);
    return T;
}

// the rows a streaming stage reads; lane 0 of each at the pointer, UV's
// rows ld apart; g null: no g row
struct LraSrc {
    const float *uv, *d, *h, *v, *g;
    int n, ld, r;
};

__device__ __forceinline__ const float* lra_src_row(const LraSrc s, int i, int base) {
    if (i < 2 * s.r) return s.uv + (size_t)i * s.ld + base;
    switch (i - 2 * s.r) {
        case 0: return s.d + base;
        case 1: return s.h + base;
        case 2: return s.v + base;
        default: return s.g + base;
    }
}

__device__ __forceinline__ void lra_cp16(float* dst, const float* src, bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 16 : 0));
}

// The tile at lane base into S, in flight as one group: each 16-byte chunk
// that holds a lane of its row (zeros for the others); the caller waits
// (lra_cp_wait) and synchronises before reading S. An empty group where
// base is past the lanes.
template <int LT>
__device__ __forceinline__ void lra_fetch(const LraSrc s, int base, float* S, const LraTile& T) {
    constexpr int QS = LT / 4 + 1, LD = LT + 4;
    const int len = min(LT, s.n - base);
    const int items = len > 0 ? (2 * s.r + (s.g ? 4 : 3)) * QS : 0;
    for (int it = threadIdx.x; it < items; it += LRA_THREADS) {
        const int i = it / QS, x = it % QS;
        const float* p = lra_src_row(s, i, base);
        const int sh = (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
        if (x == 0) T.sh[i] = sh;  // the same at every tile of a row
        lra_cp16(S + i * LD + 4 * x, p - sh + 4 * x, 4 * x < sh + len);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait for this thread's copies but the last group started (the next tile's)
__device__ __forceinline__ void lra_cp_wait() { asm volatile("cp.async.wait_group 1;\n" ::); }

// rows 2r + 2 .. lra_yrows - 1 of Y to zero (the Gram's padding)
template <int LT>
__device__ __forceinline__ void lra_zero_pad(int r, int ts, float* Y) {
    constexpr int LD = LT + 4;
    for (int e = threadIdx.x; e < (lra_yrows(r, ts) - 2 * r - 2) * LD; e += LRA_THREADS)
        Y[(2 * r + 2) * LD + e] = 0.f;
}

// row[pos..pos+3] (pos >= 0) by 16-byte shared loads of the aligned quads
// that hold them
__device__ __forceinline__ float4 lra_ld4(const float* row, int pos) {
    const int k = pos & 3;
    const float4 a = *reinterpret_cast<const float4*>(row + pos - k);
    if (!k) return a;
    const float4 b = *reinterpret_cast<const float4*>(row + pos - k + 4);
    return k == 1 ? make_float4(a.y, a.z, a.w, b.x)
                  : k == 2 ? make_float4(a.z, a.w, b.x, b.y) : make_float4(a.w, b.x, b.y, b.z);
}

// The tile's U', V' (rows 0..2r-1 of A: lane j of row k at A[k LD + j], or
// at A[k LD + sh[k] + j] in S) and nablaD (N) into their rows at lane base
// (`len` lanes). Destination chunk x of a row (from its aligned base) is
// one 16-byte store where it lies inside the row, scalar stores at its
// ends.
template <int LT>
__device__ __forceinline__ void lra_stage_out(int ldo, int r, int base, int len, const float* A,
                                              bool a_in_s, const LraTile& T, float* newuv,
                                              float* nd) {
    constexpr int LD = LT + 4, QO = LT / 4 + 1;
    for (int it = threadIdx.x; it < (2 * r + 1) * QO; it += LRA_THREADS) {
        const int i = it / QO, x = it % QO;
        const bool factor = i < 2 * r;
        float* p = factor ? newuv + (size_t)i * ldo + base : nd + base;
        const float* src = factor ? A + i * LD : T.N;
        const int sh = factor && a_in_s ? T.sh[i] : 0;  // lane j at src[sh + j]
        const int j = 4 * x - (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
        if (j >= 0 && j + 3 < len) {
            *reinterpret_cast<float4*>(p + j) = lra_ld4(src, sh + j);
        } else {
            for (int e = 0; e < 4; ++e)
                if (j + e >= 0 && j + e < len) p[j + e] = src[sh + j + e];
        }
    }
}

// ------------------------------------------------------------ the Gram's tiles
// A thread accumulates whole ts x ts tiles of a Gram over Y's rows: per
// lane quad 2 ts 16-byte shared loads for 4 ts^2 FMAs. which = 1, stage 1:
// the upper triangle of Z = rows 0..2r+1 in tiles (ti <= tj) over
// ceil((2r + 2) / ts) row blocks; which = 2, the apply: the upper triangle
// of U' (rows 0..r-1) over ceil(r / ts) row blocks, then each ts rows of
// [U'; V'] against rows 2r, 2r + 1 (d g, d g nablaD). Every entry a corner
// reads lies in one tile.

__host__ __device__ __forceinline__ int lra_ntiles(int which, int r, int ts) {
    const int q = which == 1 ? lra_cdiv(2 * r + 2, ts) : lra_cdiv(r, ts);
    return q * (q + 1) / 2 + (which == 1 ? 0 : lra_cdiv(2 * r, ts));
}

// the idx-th pair (a <= b) of a q x q symmetric block, row-major
__host__ __device__ __forceinline__ void lra_sym(int q, int idx, int& a, int& b) {
    a = 0;
    while (idx >= q - a) {
        idx -= q - a;
        ++a;
    }
    b = a + idx;
}

// tile t's first rows (a0, b0)
__host__ __device__ __forceinline__ void lra_tile(int which, int r, int ts, int t, int& a0,
                                                  int& b0) {
    const int q = which == 1 ? lra_cdiv(2 * r + 2, ts) : lra_cdiv(r, ts), up = q * (q + 1) / 2;
    if (t < up) {
        lra_sym(q, t, a0, b0);
        a0 *= ts;
        b0 *= ts;
    } else {
        a0 = ts * (t - up);
        b0 = 2 * r;
    }
}

// whether entry (i, j) of tile t (rows a0, b0) is written into the
// (2r + 2)-square Gram: one writer an entry, the upper half of a diagonal
// tile, and the apply's two parts kept apart
__host__ __device__ __forceinline__ bool lra_tile_owns(int which, int r, int ts, int t, int i,
                                                       int j, int a0, int b0) {
    const int a = a0 + i, b = b0 + j, z = 2 * r + 2;
    if (a >= z || b >= z || (a0 == b0 && i > j)) return false;
    const int q = lra_cdiv(r, ts);
    return which == 1 || (t < q * (q + 1) / 2 ? b < r : a < 2 * r);
}

// This thread's share of a Gram's tiles: y-slice y of the tiles holds
// LRA_THREADS of them, and each tile takes ks threads, thread s of them the
// lane quads s, s + ks, ..., starting at a rotation fixed by its tile
// (spreads the shared-memory banks).
struct LraGramPlan {
    int a0, b0, tile, mine, slice, ks, first, count;
};

template <int LT, int TS>
__device__ __forceinline__ void lra_tile_plan(int which, int r, int y, LraGramPlan& P) {
    const int t = threadIdx.x;
    P.first = y * LRA_THREADS;
    P.count = min(lra_ntiles(which, r, TS) - P.first, LRA_THREADS);
    P.ks = min(LRA_THREADS / P.count, LT / 4);
    P.slice = t % P.ks;
    P.tile = P.first + t / P.ks;
    P.mine = t / P.ks < P.count;
    if (P.mine) lra_tile(which, r, TS, P.tile, P.a0, P.b0);
}

// acc += this thread's tile's products over the staged lanes of its quads
template <int LT, int TS>
__device__ __forceinline__ void lra_gram_acc(const float* Y, const LraGramPlan& P,
                                             float (&acc)[TS * TS]) {
    constexpr int LD = LT + 4;
    const int nq = (LT / 4 - P.slice + P.ks - 1) / P.ks;
    if (!P.mine || nq <= 0) return;
    const int rot = P.tile % nq;
    for (int m0 = 0; m0 < nq; ++m0) {
        const int m = m0 + rot < nq ? m0 + rot : m0 + rot - nq, l = 4 * (P.slice + P.ks * m);
        float4 A[TS];
#pragma unroll
        for (int i = 0; i < TS; ++i) A[i] = *reinterpret_cast<const float4*>(Y + (P.a0 + i) * LD + l);
#pragma unroll
        for (int j = 0; j < TS; ++j) {
            const float4 B = *reinterpret_cast<const float4*>(Y + (P.b0 + j) * LD + l);
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
// ks > 1 the slices' sums added in slice order through zs (LRA_THREADS
// TS^2 floats; barriers, every thread calls it), else each tile as it is
template <int TS>
__device__ __forceinline__ void lra_gram_out(const LraGramPlan& P, const float (&acc)[TS * TS],
                                             float* out, float* zs) {
    constexpr int E = TS * TS;
    if (P.ks == 1) {
        if (P.mine)
            for (int e = 0; e < E; ++e) out[(size_t)P.tile * E + e] = acc[e];
        return;
    }
    __syncthreads();
    for (int e = 0; e < E; ++e) zs[threadIdx.x * E + e] = P.mine ? acc[e] : 0.f;
    __syncthreads();
    for (int e = threadIdx.x; e < P.count * E; e += LRA_THREADS) {
        const float* p = zs + (e / E) * P.ks * E + e % E;
        float s = 0.f;
        for (int k = 0; k < P.ks; ++k) s += p[k * E];
        out[(size_t)P.first * E + e] = s;
    }
}

// ------------------------------------------------------------ stage 1
// grid (blocks, y-slices): block b takes the tiles b, b + blocks, ...;
// its partial Gram of Z = [U; V; d h; v / d] at part + b lra_ntiles(1, r,
// TS) TS^2 (each y-slice its 256 tiles there), and with y = 0 its max|U|,
// max|V| (maxpart[2b], [2b + 1]).
template <int LT, int TS>
__global__ void __launch_bounds__(LRA_THREADS, LRA_MIN_BLOCKS(TS)) lra_stage1_kernel(LraSrc s,
                                                                 float* __restrict__ part,
                                                                 float* __restrict__ maxpart) {
    extern __shared__ float4 zs4[];
    __shared__ float red[LRA_THREADS / 32];
    constexpr int LD = LT + 4, GROUPS = LRA_THREADS / LT;
    float* zs = reinterpret_cast<float*>(zs4);
    const int r = s.r, z = 2 * r + 2, b = blockIdx.x, step = gridDim.x * LT;
    const LraTile T = lra_tile_carve(zs, r, LT, TS, true);
    LraGramPlan P;
    lra_tile_plan<LT, TS>(1, r, blockIdx.y, P);
    float acc[TS * TS];
#pragma unroll
    for (int e = 0; e < TS * TS; ++e) acc[e] = 0.f;
    float mu = 0.f, mv = 0.f;
    lra_zero_pad<LT>(r, TS, T.Y);
    lra_fetch<LT>(s, b * LT, T.S[0], T);
    for (int base = b * LT, cur = 0; base < s.n; base += step, cur ^= 1) {
        const int len = min(LT, s.n - base);
        const float* S = cur ? T.S[1] : T.S[0];
        lra_fetch<LT>(s, base + step, cur ? T.S[0] : T.S[1], T);
        lra_cp_wait();
        __syncthreads();
        {  // lane j of Z, zeros past len; rows k = g, g + GROUPS, ... by the
           // GROUPS threads of the lane
            const int j = threadIdx.x % LT, g = threadIdx.x / LT;
            const bool ok = j < len;
            auto at = [&](int k) { return S[k * LD + T.sh[k] + j]; };
            for (int k = g; k < z; k += GROUPS) {
                float x = 0.f;
                if (ok) {
                    if (k < 2 * r) {
                        x = at(k);
                        if (k < r) mu = lra_max(mu, fabsf(x));
                        else mv = lra_max(mv, fabsf(x));
                    } else {
                        x = k == 2 * r ? at(2 * r) * at(2 * r + 1) : at(2 * r + 2) / at(2 * r);
                    }
                }
                T.Y[k * LD + j] = x;
            }
        }
        __syncthreads();
        lra_gram_acc<LT, TS>(T.Y, P, acc);
    }
    lra_gram_out<TS>(P, acc, part + (size_t)b * lra_ntiles(1, r, TS) * TS * TS, zs);
    if (blockIdx.y == 0) {
        mu = lra_block_max(mu, red);
        mv = lra_block_max(mv, red);
        if (threadIdx.x == 0) {
            maxpart[2 * b] = mu;
            maxpart[2 * b + 1] = mv;
        }
    }
}

// ------------------------------------------------------------ stage 3
// Block b: U', V' and nablaD of the tiles b, b + blocks, ... (new rows ldo
// apart), the block's max|nablaD| into ndmax[b]; with G (s.g) also its
// partial apply Gram (which = 2) at part + b lra_ntiles(2, r, TS) TS^2.
// coef (r, 10), scal = (cu, cv) from corner A.
template <int LT, int TS, bool G>
__global__ void __launch_bounds__(LRA_THREADS, LRA_MIN_BLOCKS(TS)) lra_stage3_kernel(
    LraSrc s, const float* __restrict__ coef, const float* __restrict__ scal,
    float* __restrict__ newuv, int ldo, float* __restrict__ nd, float* __restrict__ part,
    float* __restrict__ ndmax) {
    extern __shared__ float4 zs4[];
    __shared__ float cs[(TS == 4 ? LRA_MAX_RANK : LRA_S_MAX_RANK) * LRA_NCOEF];
    __shared__ float red[LRA_THREADS / 32];
    constexpr int LD = LT + 4, GROUPS = LRA_THREADS / LT;
    float* zs = reinterpret_cast<float*>(zs4);
    const int r = s.r, t = threadIdx.x, step = gridDim.x * LT;
    for (int e = t; e < r * LRA_NCOEF; e += LRA_THREADS) cs[e] = coef[e];
    const float cu = scal[0], cv = scal[1];
    const LraTile T = lra_tile_carve(zs, r, LT, TS, G);
    LraGramPlan P;
    float acc[TS * TS];
#pragma unroll
    for (int e = 0; e < TS * TS; ++e) acc[e] = 0.f;
    if (G) {
        lra_tile_plan<LT, TS>(2, r, 0, P);
        lra_zero_pad<LT>(r, TS, T.Y);
    }
    float m = 0.f;
    lra_fetch<LT>(s, blockIdx.x * LT, T.S[0], T);
    for (int base = blockIdx.x * LT, cur = 0; base < s.n; base += step, cur ^= 1) {
        const int len = min(LT, s.n - base);
        float* S = cur ? T.S[1] : T.S[0];
        lra_fetch<LT>(s, base + step, cur ? T.S[0] : T.S[1], T);
        lra_cp_wait();
        __syncthreads();
        {  // lane j's update by the GROUPS adjacent threads g of it, each the
           // rank rows k = g, g + GROUPS, ...; U', V' over the old values in
           // S, or with G into Y (zeros past len) with d g and d g nablaD
            const int j = t / GROUPS, g = t % GROUPS;
            const bool ok = j < len;
            auto at = [&](int k) -> float& { return S[k * LD + T.sh[k] + j]; };
            float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f, p4 = 0.f, p5 = 0.f;
            for (int k = g; k < r; k += GROUPS) {
                const float u = at(k), v = at(r + k);
                const float* ck = cs + k * LRA_NCOEF;
                p0 += ck[0] * u;
                p1 += ck[1] * v;
                p2 += ck[2] * v;
                p3 += ck[3] * u;
                p4 += ck[8] * v;
                p5 += ck[9] * v;
            }
#pragma unroll
            for (int o = 1; o < GROUPS; o <<= 1) {
                p0 += __shfl_xor_sync(0xffffffffu, p0, o);
                p1 += __shfl_xor_sync(0xffffffffu, p1, o);
                p2 += __shfl_xor_sync(0xffffffffu, p2, o);
                p3 += __shfl_xor_sync(0xffffffffu, p3, o);
                p4 += __shfl_xor_sync(0xffffffffu, p4, o);
                p5 += __shfl_xor_sync(0xffffffffu, p5, o);
            }
            const float dj = at(2 * r), hj = at(2 * r + 1), vj = at(2 * r + 2);
            const float x = dj * hj, w = vj / dj;
            const float qh = x + p0;
            const float bq = w - p1;
            const float ph = dj * (qh + p2);
            const float ipv = (bq - p3) / dj;
            const float ndj = ph * hj - vj * ipv;
            const float av = qh + p4, bv = bq + p5;
            for (int k = g; k < r; k += GROUPS) {
                const float* ck = cs + k * LRA_NCOEF;
                const float nu = cu * at(k) - (ck[4] * qh - ck[5] * bq);
                const float nv = cv * at(r + k) - (ck[6] * av - ck[7] * bv);
                if (G) {
                    T.Y[k * LD + j] = ok ? nu : 0.f;
                    T.Y[(r + k) * LD + j] = ok ? nv : 0.f;
                } else {
                    at(k) = nu;
                    at(r + k) = nv;
                }
            }
            if (g == 0) {
                T.N[j] = ndj;
                if (ok) m = lra_max(m, fabsf(ndj));
                if (G) {
                    const float y0 = ok ? dj * at(2 * r + 3) : 0.f;
                    T.Y[2 * r * LD + j] = y0;
                    T.Y[(2 * r + 1) * LD + j] = ok ? y0 * ndj : 0.f;
                }
            }
        }
        __syncthreads();
        lra_stage_out<LT>(ldo, r, base, len, G ? T.Y : S, !G, T, newuv, nd);
        if (G) lra_gram_acc<LT, TS>(T.Y, P, acc);
        __syncthreads();
    }
    if (G) lra_gram_out<TS>(P, acc, part + (size_t)blockIdx.x * lra_ntiles(2, r, TS) * TS * TS, zs);
    m = lra_block_max(m, red);
    if (t == 0) ndmax[blockIdx.x] = m;
}

// ------------------------------------------------------------ the reduce
// gram[a][b] = gram[b][a] = entry e of the blocks' partials (np floats a
// block) summed in block order where its tile owns it, a warp an entry
// (lane l the blocks l, l + 32, ..., then a shuffle tree); with nm > 0 the
// warp after the entries folds the blocks' nm maxima maxpart[nm k + w] into
// maxs[w] (lra_max). part null: the fold alone.
__global__ void __launch_bounds__(256) lra_reduce_kernel(int which, int r, int ts, int blocks,
                                                         const float* __restrict__ part,
                                                         float* __restrict__ gram, int nm,
                                                         const float* __restrict__ maxpart,
                                                         float* __restrict__ maxs) {
    const int np = part ? lra_ntiles(which, r, ts) * ts * ts : 0;
    const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
    if (e < np) {
        int a0, b0;
        const int t = e / (ts * ts), i = e / ts % ts, j = e % ts;
        lra_tile(which, r, ts, t, a0, b0);
        if (!lra_tile_owns(which, r, ts, t, i, j, a0, b0)) return;  // uniform across the warp
        float s = 0.f;
        for (int k = lane; k < blocks; k += 32) s += part[(size_t)k * np + e];
        for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
        if (lane == 0) {
            const int z = 2 * r + 2, a = a0 + i, b = b0 + j;
            gram[a * z + b] = s;
            gram[b * z + a] = s;
        }
    } else if (e == np) {
        for (int w = 0; w < nm; ++w) {
            float m = maxpart[w];
            for (int k = lane; k < blocks; k += 32) m = lra_max(m, maxpart[(size_t)nm * k + w]);
            for (int o = 16; o > 0; o >>= 1) m = lra_max(m, __shfl_xor_sync(0xffffffffu, m, o));
            if (lane == 0) maxs[w] = m;
        }
    }
}

// ------------------------------------------------------------ stage 4
// Per lane quad (a thread each, grid-stride): newd = d' = d - mu d nablaD;
// with g also out = P' g = d' (d' g + t1 U' + t2 V'), coef4 (r, 2) =
// (t1, t2) read in place (any r). 16-byte loads and stores where a row is
// aligned, 4-byte ones elsewhere and at the ragged end.

// x[0..cnt) of p (zeros past cnt)
__device__ __forceinline__ float4 lra_load4(const float* p, int cnt) {
    if (cnt == 4 && !(reinterpret_cast<uintptr_t>(p) & 15))
        return *reinterpret_cast<const float4*>(p);
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    for (int e = 0; e < cnt; ++e) x[e] = p[e];
    return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void lra_store4(float* p, float4 v, int cnt) {
    if (cnt == 4 && !(reinterpret_cast<uintptr_t>(p) & 15)) {
        *reinterpret_cast<float4*>(p) = v;
        return;
    }
    const float x[4] = {v.x, v.y, v.z, v.w};
    for (int e = 0; e < cnt; ++e) p[e] = x[e];
}

__global__ void __launch_bounds__(LRA_LANE_TILE) lra_stage4_kernel(
    int n, int ld, int r, const float* __restrict__ uv, const float* __restrict__ d,
    const float* __restrict__ nd, const float* __restrict__ g, const float* __restrict__ mu,
    const float* __restrict__ coef4, float* __restrict__ newd, float* __restrict__ out) {
    const float m = mu[0];
    const int quads = (n + 3) / 4;
    for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < quads; q += gridDim.x * blockDim.x) {
        const int j = 4 * q, cnt = min(4, n - j);
        const float4 dj = lra_load4(d + j, cnt), nj = lra_load4(nd + j, cnt);
        const float4 dp = make_float4(dj.x - m * dj.x * nj.x, dj.y - m * dj.y * nj.y,
                                      dj.z - m * dj.z * nj.z, dj.w - m * dj.w * nj.w);
        lra_store4(newd + j, dp, cnt);
        if (!g) continue;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int k = 0; k < r; ++k) {
            const float c1 = coef4[2 * k], c2 = coef4[2 * k + 1];
            const float4 u = lra_load4(uv + (size_t)k * ld + j, cnt);
            const float4 v = lra_load4(uv + (size_t)(r + k) * ld + j, cnt);
            s.x += c1 * u.x + c2 * v.x;
            s.y += c1 * u.y + c2 * v.y;
            s.z += c1 * u.z + c2 * v.z;
            s.w += c1 * u.w + c2 * v.w;
        }
        const float4 gj = lra_load4(g + j, cnt);
        lra_store4(out + j,
                   make_float4(dp.x * (dp.x * gj.x + s.x), dp.y * (dp.y * gj.y + s.y),
                               dp.z * (dp.z * gj.z + s.z), dp.w * (dp.w * gj.w + s.w)),
                   cnt);
    }
}

// ------------------------------------------------------------ the corners
// One block of LRA_CORNER threads loads the Gram; then warp 0 alone, lane k
// holding entry k of every rank-space vector (0 past r), does the algebra,
// synchronising with __syncwarp only.

#define LRA_CORNER 256
#define LRA_GLD (LRA_MAX_Z + 1)
#define LRA_LD (LRA_MAX_RANK + 1)
#define LRA_FULL 0xffffffffu

// The Gram entries a corner reads into gs: one block's partials (part,
// lra_ntiles(which, r, 4) 4 x 4 tiles: the stage ran on one block) or a
// Gram already reduced (gram, (2r + 2)^2)
__device__ void lra_load_gram(int which, int r, const float* part, const float* gram,
                              float (*gs)[LRA_GLD]) {
    const int zdim = 2 * r + 2;
    if (part) {
        for (int e = threadIdx.x; e < lra_ntiles(which, r, 4) * 16; e += LRA_CORNER) {
            int a0, b0;
            const int t = e / 16, i = e / 4 % 4, j = e % 4;
            lra_tile(which, r, 4, t, a0, b0);
            if (!lra_tile_owns(which, r, 4, t, i, j, a0, b0)) continue;
            gs[a0 + i][b0 + j] = part[e];
            gs[b0 + j][a0 + i] = part[e];
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
// largest |M[i][j]|, as LAPACK's getrf; NaN above every number, so that
// every lane agrees on it), M (r x r) overwritten by its factors; lane k
// holds b_k and gets y_k
__device__ float lra_lu_solve(float (*M)[LRA_LD], float b, int r) {
    const int k = threadIdx.x;
    for (int j = 0; j < r; ++j) {
        int v = (k >= j && k < r) ? lra_pivot_key(M[k][j]) : -1;
        int p = k;
        for (int o = 16; o > 0; o >>= 1) {
            const int ov = __shfl_xor_sync(LRA_FULL, v, o);
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
// Z = [U; V; x; w] (one block's partials `part`, or `gram` reduced) and the
// maxima (max|U|, max|V|) of `blocks` blocks (maxpart[2 b], [2 b + 1])
__global__ void __launch_bounds__(LRA_CORNER) lra_corner_a_kernel(
    int r, int blocks, const float* __restrict__ part, const float* __restrict__ gram,
    const float* __restrict__ maxpart, float step, int balance, int update_u,
    float* __restrict__ coef, float* __restrict__ scal) {
    __shared__ float gs[LRA_MAX_Z][LRA_GLD];
    __shared__ float A1[LRA_MAX_RANK][LRA_LD], A2[LRA_MAX_RANK][LRA_LD];
    __shared__ float buf[32];
    __shared__ float red[2][LRA_CORNER / 32];
    const int tid = threadIdx.x;
    lra_load_gram(1, r, part, gram, gs);
    float mu = maxpart[0], mv = maxpart[1];
    for (int b = tid; b < blocks; b += LRA_CORNER) {
        mu = lra_max(mu, maxpart[2 * b]);
        mv = lra_max(mv, maxpart[2 * b + 1]);
    }
    for (int o = 16; o > 0; o >>= 1) {
        mu = lra_max(mu, __shfl_xor_sync(LRA_FULL, mu, o));
        mv = lra_max(mv, __shfl_xor_sync(LRA_FULL, mv, o));
    }
    if ((tid & 31) == 0) {
        red[0][tid >> 5] = mu;
        red[1][tid >> 5] = mv;
    }
    __syncthreads();
    if (tid >= 32) return;  // no block barrier past this point

    const int k = tid, ix = 2 * r, iw = 2 * r + 1;
    const bool on = k < r;
    float max_u = red[0][0], max_v = red[1][0];
    for (int w = 1; w < LRA_CORNER / 32; ++w) {
        max_u = lra_max(max_u, red[0][w]);
        max_v = lra_max(max_v, red[1][w]);
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
        const float m = lra_step_scale(step, norm);
        e1 = m * IpGt(atV);
        e2 = m * IpGt(btV);
    } else {
        const float Gup_atU = Gup(atU), Gup_btU = Gup(btU);
        const float norm = sqrtf(fabsf(dot(atU, Gup_atU) * aa + dot(btU, Gup_btU) * bb
                                       - 2.f * dot(atU, Gup_btU) * ab));
        const float m = lra_step_scale(step, norm);
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

// Corner B: mu = step / (max|nablaD| + tiny), saturated, over `mblocks`
// block maxima; with the apply Gram (one block's partials `part`, or
// `gram2` reduced) coef4 (r, 2) = (t1, t2): t1 = V' y, t2 = U' y + U' U'^T
// t1, y = y0 - mu y1
__global__ void __launch_bounds__(LRA_CORNER) lra_corner_b_kernel(
    int r, int mblocks, const float* __restrict__ ndmax, const float* __restrict__ part,
    const float* __restrict__ gram2, float step, float* __restrict__ mu_out,
    float* __restrict__ coef4) {
    __shared__ float gs[LRA_MAX_Z][LRA_GLD];
    __shared__ float buf[32];
    __shared__ float red[LRA_CORNER / 32];
    const int tid = threadIdx.x;
    const bool apply = part || gram2;
    if (apply) lra_load_gram(2, r, part, gram2, gs);
    float m = ndmax[0];
    for (int b = tid; b < mblocks; b += LRA_CORNER) m = lra_max(m, ndmax[b]);
    for (int o = 16; o > 0; o >>= 1) m = lra_max(m, __shfl_xor_sync(LRA_FULL, m, o));
    if ((tid & 31) == 0) red[tid >> 5] = m;
    __syncthreads();
    if (tid >= 32) return;  // no block barrier past this point
    m = red[0];
    for (int w = 1; w < LRA_CORNER / 32; ++w) m = lra_max(m, red[w]);
    const float mu = lra_step_scale(step, m);
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

// ------------------------------------------------ any rank: the generic pieces
// Past LRA_MAX_RANK the corners run on one block with their vectors strided
// over the threads (rank_space.cuh). Past LRA_S_MAX_RANK the Grams go
// through the grouped GEMM (gram_launch) over Z = [U; V; two rows] with U
// and V read in place and the two rows staged by lra_rows_kernel (with
// stage 1's max|U|, max|V|), and stage 3 (lra_stage3_lane_kernel) reads its
// coefficients in place; the apply's Gram then reads U', V' back after
// stage 3 (one more pass over the factors).

// The two rows of a Gram the state does not hold, e (2, n): stage 1's
// d h and v / d (a = h, b = v), with this block's (max|U|, max|V|) into
// maxpart when it is non-null; the apply's d g and d g nablaD (a = g,
// b = nablaD, z2). U and V rows ld apart.
__global__ void __launch_bounds__(LRA_LANE_TILE) lra_rows_kernel(int n, int ld, int r, int z2,
                                                                 const float* __restrict__ uv,
                                                                 const float* __restrict__ d,
                                                                 const float* __restrict__ a,
                                                                 const float* __restrict__ b,
                                                                 float* __restrict__ e,
                                                                 float* __restrict__ maxpart) {
    __shared__ float red[LRA_LANE_TILE / 32];
    const int j = blockIdx.x * LRA_LANE_TILE + threadIdx.x;
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
            for (int k = 0; k < r; ++k) mu = lra_max(mu, fabsf(uv[(size_t)k * ld + j]));
            for (int k = r; k < 2 * r; ++k) mv = lra_max(mv, fabsf(uv[(size_t)k * ld + j]));
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

// Stage 3 past LRA_S_MAX_RANK: one thread a lane, the coefficients read in
// place; the block's max|nablaD| into ndmax[block]
__global__ void __launch_bounds__(LRA_LANE_TILE) lra_stage3_lane_kernel(
    int n, int ld, int r, const float* __restrict__ uv, const float* __restrict__ d,
    const float* __restrict__ h, const float* __restrict__ vv, const float* __restrict__ c,
    const float* __restrict__ scal, float* __restrict__ newuv, float* __restrict__ nd,
    float* __restrict__ ndmax) {
    __shared__ float red[LRA_LANE_TILE / 32];
    const int j = blockIdx.x * LRA_LANE_TILE + threadIdx.x;
    float m = 0.f;
    if (j < n) {
        const float cu = scal[0], cv = scal[1], dj = d[j], hj = h[j], vj = vv[j];
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
        const float ndj = ph * hj - vj * ipv;
        const float av = qh + p4, bv = b + p5;
        for (int k = 0; k < r; ++k) {
            const float* ck = c + k * LRA_NCOEF;
            const float u = uv[(size_t)k * ld + j], v = uv[(size_t)(r + k) * ld + j];
            newuv[(size_t)k * ld + j] = cu * u - (ck[4] * qh - ck[5] * b);
            newuv[(size_t)(r + k) * ld + j] = cv * v - (ck[6] * av - ck[7] * bv);
        }
        nd[j] = ndj;
        m = fabsf(ndj);
    }
    m = lra_block_max(m, red);
    if (threadIdx.x == 0) ndmax[blockIdx.x] = m;
}

// b <- M^{-1} b by LU with partial pivoting (the pivot the first row of
// largest |M[k][j]|, as LAPACK's getrf; NaN above every number, as
// lra_lu_solve), M (r x r, row-major) overwritten by its factors; the row
// swaps and the eliminations parallel over the block. rv, rp:
// RG_THREADS / 32 ints each.
__device__ void lra_lu_solve_g(float* M, float* b, int r, int* rv, int* rp) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int j = 0; j < r; ++j) {
        __syncthreads();
        int v = -1, p = r;
        for (int k = j + tid; k < r; k += RG_THREADS) {
            const int a = lra_pivot_key(M[(size_t)k * r + j]);
            if (a > v) {
                v = a;
                p = k;
            }
        }
        for (int o = 16; o > 0; o >>= 1) {
            const int ov = __shfl_xor_sync(LRA_FULL, v, o);
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
    __shared__ int redv[RG_THREADS / 32], redp[RG_THREADS / 32];
    float* base = in_smem ? sm : ws;
    const int z = 2 * r + 2, ix = 2 * r, iw = 2 * r + 1, tid = threadIdx.x;
    float mu = maxpart[0], mv = maxpart[1];
    for (int b = tid; b < mblocks; b += RG_THREADS) {
        mu = lra_max(mu, maxpart[2 * b]);
        mv = lra_max(mv, maxpart[2 * b + 1]);
    }
    mu = lra_block_max(mu, red);
    mv = lra_block_max(mv, red);
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
    lra_lu_solve_g(M, a1, r, redv, redp);
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
    lra_lu_solve_g(M, a2, r, redv, redp);
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
        const float m = lra_step_scale(step, norm);
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
        const float m = lra_step_scale(step, norm);
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
    float m = ndmax[0];
    for (int b = threadIdx.x; b < mblocks; b += RG_THREADS) m = lra_max(m, ndmax[b]);
    m = lra_block_max(m, red);
    const float mu = lra_step_scale(step, m);
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

static bool lra_generic(int r) { return r > LRA_MAX_RANK; }
static bool lra_staged(int r) { return r <= LRA_S_MAX_RANK; }
static int lra_tiles(int n) { return (n + LRA_LANE_TILE - 1) / LRA_LANE_TILE; }

// The staged stages' lanes a tile (lt) and Gram tile side (ts) by rank:
// 256-lane tiles and 4 x 4 Gram tiles up to 16, 128-lane tiles to 32,
// 64-lane tiles and 8 x 8 Gram tiles to LRA_S_MAX_RANK; the largest rank
// each lt takes sets its shared-memory attribute.
struct LraShape {
    int lt, ts;
};
static int lra_lt_max_rank(int lt) {
    return lt == 256 ? 16 : lt == 128 ? LRA_MAX_RANK : LRA_S_MAX_RANK;
}
static LraShape lra_shape(int r) {
    for (int lt : {256, 128})
        if (r <= lra_lt_max_rank(lt)) return {lt, 4};
    return {64, 8};
}

// which = 1: stage 1, which = 3: stage 3 without g, 4: with g
static size_t lra_smem(int which, int r) {
    const LraShape sh = lra_shape(r);
    return sizeof(float) * (size_t)lra_tile_floats(r, sh.lt, sh.ts, which != 3, which != 1);
}

static const void* lra_stage_fn(int which, int lt) {
#define LRA_FNS(LT, TS)                                                       \
    which == 1   ? (const void*)lra_stage1_kernel<LT, TS>                      \
    : which == 3 ? (const void*)lra_stage3_kernel<LT, TS, false>               \
                 : (const void*)lra_stage3_kernel<LT, TS, true>
    if (lt == 256) return LRA_FNS(256, 4);
    if (lt == 128) return LRA_FNS(128, 4);
    return LRA_FNS(64, 8);
#undef LRA_FNS
}

static cudaError_t lra_smem_attrs() {
    static bool done = false;
    if (done) return cudaSuccess;
    cudaError_t e = cudaSuccess;
    for (int lt : {256, 128, 64})
        for (int which : {1, 3, 4})
            if (e == cudaSuccess)
                e = cudaFuncSetAttribute(lra_stage_fn(which, lt),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lra_smem(which, lra_lt_max_rank(lt)));
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(lra_corner_a_g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RG_SMEM);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(lra_corner_b_g_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RG_SMEM);
    done = e == cudaSuccess;
    return e;
}

// The blocks of a staged stage over n lanes: one where the lanes are at
// most LRA_ONE_BLOCK_TILES tiles, else as many as are resident at once on
// the card's SMs (the occupancy of the stage's kernel at its shared
// memory), at most one a tile. Asked once per (stage, rank).
static int lra_grid(int which, int n, int r) {
    static int occ[5][LRA_S_MAX_RANK + 1];
    const LraShape sh = lra_shape(r);
    const int tiles = lra_cdiv(n, sh.lt);
    if (tiles <= LRA_ONE_BLOCK_TILES) return 1;
    int& per_sm = occ[which][r];
    if (!per_sm) {
        if (lra_smem_attrs() != cudaSuccess ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lra_stage_fn(which, sh.lt),
                                                          LRA_THREADS, lra_smem(which, r)) !=
                cudaSuccess ||
            per_sm < 1)
            per_sm = 1;
    }
    const long long most = (long long)gemm_sms() * per_sm;
    return (int)(tiles < most ? tiles : most);
}

// the y-slices of stage 1's Gram tiles
static int lra_yslices(int r) { return lra_cdiv(lra_ntiles(1, r, lra_shape(r).ts), LRA_THREADS); }

static int lra_stage4_grid(int n) {
    const int blocks = lra_cdiv(lra_cdiv(n, 4), LRA_LANE_TILE), most = 8 * gemm_sms();
    return blocks < most ? blocks : most;
}

// The scratch of one call: the partial Grams (stage 1's, then the apply's),
// stage 1's maxima, stage 3's max|nablaD| per block, nablaD, the rank
// space (coef, scal, coef4, mu), the reduced Gram (2r + 2)^2 and maxima
// (maxs, ndmax1) and, past LRA_S_MAX_RANK, the two staged rows 2n and, past
// RG_SMEM of shared memory, the corners' workspace. The staged partials
// are lra_grid blocks of lra_ntiles TS^2 floats; past LRA_S_MAX_RANK the
// GEMM's bands (gram_part_floats: at most 256 (2r + 2)^2 floats). Every
// part grows with n, so a scratch for n serves any lanes up to n.
struct LraScratch {
    float *part, *maxpart, *ndmax, *nd, *coef, *scal, *coef4, *mu, *gram, *maxs, *ndmax1, *ws,
        *rows;
};

static size_t lra_scratch_offsets(int n, int r, size_t off[13]) {
    const size_t z = 2 * r + 2;
    size_t part, maxpart, ndmax, rows = 0;
    if (lra_staged(r)) {
        const int ts = lra_shape(r).ts;
        const size_t p1 = (size_t)lra_grid(1, n, r) * lra_ntiles(1, r, ts) * ts * ts;
        const size_t p2 = (size_t)lra_grid(4, n, r) * lra_ntiles(2, r, ts) * ts * ts;
        part = p1 > p2 ? p1 : p2;
        maxpart = 2 * (size_t)lra_grid(1, n, r);
        ndmax = std::max(lra_grid(3, n, r), lra_grid(4, n, r));
    } else {
        part = gram_part_floats(lra_gram_plan(n, n, r, nullptr, nullptr));
        maxpart = 2 * (size_t)lra_tiles(n);
        ndmax = lra_tiles(n);
        rows = 2 * (size_t)n;
    }
    const size_t ws = lra_generic(r) && !rg_in_smem(lra_corner_floats(r)) ? lra_corner_floats(r) : 0;
    const size_t rank = std::max(r, LRA_MAX_RANK);
    // the workspace first: the corners' entries find it at offset 0 whatever n
    const size_t sizes[13] = {ws, part, maxpart, ndmax, (size_t)n, rank * LRA_NCOEF, 2, 2 * rank,
                              1, z * z, 2, 1, rows};
    size_t total = 0;
    for (int k = 0; k < 13; ++k) {
        off[k] = total;
        total += psgd_align4(sizes[k]);
    }
    return total;
}

static LraScratch lra_carve(void* scratch, int n, int r) {
    size_t off[13];
    lra_scratch_offsets(n, r, off);
    float* base = static_cast<float*>(scratch);
    return LraScratch{base + off[1], base + off[2], base + off[3], base + off[4], base + off[5],
                      base + off[6], base + off[7], base + off[8], base + off[9], base + off[10],
                      base + off[11], base + off[0], base + off[12]};
}

extern "C" size_t psgd_lra_scratch_floats(int n, int r) {
    size_t off[13];
    return lra_scratch_offsets(n, r, off);
}

#define LRA_CHECK(n, ld, r) \
    if (n < 1 || ld < n || r < 1) return (int)cudaErrorInvalidValue

#define LRA_LAUNCHED()                              \
    do {                                            \
        const cudaError_t e_ = cudaGetLastError();  \
        if (e_ != cudaSuccess) return (int)e_;      \
    } while (0)

static void lra_reduce(int which, int r, int blocks, const float* part, float* gram, int nm,
                       const float* maxpart, float* maxs, cudaStream_t stream) {
    const int ts = lra_shape(r).ts;
    const int warps = (part ? lra_ntiles(which, r, ts) * ts * ts : 0) + 1;
    lra_reduce_kernel<<<lra_cdiv(32 * warps, 256), 256, 0, stream>>>(which, r, ts, blocks, part,
                                                                     gram, nm, maxpart, maxs);
}

// stage 1 of the staged chain over src's lanes into s.part, s.maxpart
// (lra_grid(1) blocks)
static void lra_stage1(const LraSrc& src, const LraScratch& s, cudaStream_t stream) {
    const int r = src.r;
    const dim3 grid(lra_grid(1, src.n, r), lra_yslices(r));
    const size_t sm = lra_smem(1, r);
    const int lt = lra_shape(r).lt;
    if (lt == 256) lra_stage1_kernel<256, 4><<<grid, LRA_THREADS, sm, stream>>>(src, s.part, s.maxpart);
    else if (lt == 128) lra_stage1_kernel<128, 4><<<grid, LRA_THREADS, sm, stream>>>(src, s.part, s.maxpart);
    else lra_stage1_kernel<64, 8><<<grid, LRA_THREADS, sm, stream>>>(src, s.part, s.maxpart);
}

// stage 3 of the staged chain (g: src.g) into newuv (rows ldo apart), nd,
// s.part (with g) and s.ndmax; returns its blocks
static int lra_stage3(const LraSrc& src, const float* coef, const float* scal, float* newuv,
                      int ldo, float* nd, const LraScratch& s, cudaStream_t stream) {
    const int r = src.r, which = src.g ? 4 : 3, blocks = lra_grid(which, src.n, r);
    const size_t sm = lra_smem(which, r);
    const LraShape sh = lra_shape(r);
#define LRA_S3(LT, TS)                                                                          \
    if (src.g)                                                                                  \
        lra_stage3_kernel<LT, TS, true><<<blocks, LRA_THREADS, sm, stream>>>(                   \
            src, coef, scal, newuv, ldo, nd, s.part, s.ndmax);                                  \
    else                                                                                        \
        lra_stage3_kernel<LT, TS, false><<<blocks, LRA_THREADS, sm, stream>>>(                  \
            src, coef, scal, newuv, ldo, nd, s.part, s.ndmax)
    if (sh.lt == 256) { LRA_S3(256, 4); }
    else if (sh.lt == 128) { LRA_S3(128, 4); }
    else { LRA_S3(64, 8); }
#undef LRA_S3
    return blocks;
}

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

// Past LRA_S_MAX_RANK: stage 1's Gram and maxima (gram, maxpart:
// lra_tiles(n) pairs) or, with g, the apply's Gram over U', V' (uv) and nd:
// the staged rows, then the GEMM's bands and their sums
static void lra_gram_g(int n, int ld, int r, const float* uv, const float* d, const float* h,
                       const float* v, const float* g, const float* nd, const LraScratch& s,
                       float* maxpart, float* gram, cudaStream_t stream) {
    lra_rows_kernel<<<lra_tiles(n), LRA_LANE_TILE, 0, stream>>>(n, ld, r, g != nullptr, uv, d,
                                                                g ? g : h, g ? nd : v, s.rows,
                                                                maxpart);
    gram_launch(lra_gram_plan(n, ld, r, uv, s.rows), s.part, gram, stream);
}

static void lra_stage4(int n, int ld, int r, const float* newuv, const float* d, const float* nd,
                       const float* g, const float* mu, const float* coef4, float* newd, float* pre,
                       cudaStream_t stream) {
    lra_stage4_kernel<<<lra_stage4_grid(n), LRA_LANE_TILE, 0, stream>>>(n, ld, r, newuv, d, nd, g,
                                                                        mu, coef4, newd, pre);
}

// K13: one update of (UV, d), and with g (non-null) P' g of the updated
// state: stage 1, its reduce (none where one block took the lanes and the
// warp corner reads its partials), corner A, stage 3, its reduce, corner
// B, stage 4; past LRA_S_MAX_RANK the GEMM's Grams and the per-lane stage
// 3. newuv (2r, n), newd (n,), pre (n,) or null; scratch
// psgd_lra_scratch_floats
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
    const float* gp = f(g);
    if (!lra_staged(r)) {
        lra_gram_g(n, n, r, f(uv), f(d), f(h), f(v), nullptr, nullptr, s, s.maxpart, s.gram, stream);
        LRA_LAUNCHED();
        lra_corner_a_g(r, lra_tiles(n), s.gram, s.maxpart, step, balance, update_u, s.coef, s.scal,
                       s.ws, stream);
        LRA_LAUNCHED();
        lra_stage3_lane_kernel<<<lra_tiles(n), LRA_LANE_TILE, 0, stream>>>(
            n, n, r, f(uv), f(d), f(h), f(v), s.coef, s.scal, out, s.nd, s.ndmax);
        LRA_LAUNCHED();
        if (gp) {
            lra_gram_g(n, n, r, out, f(d), nullptr, nullptr, gp, s.nd, s, nullptr, s.gram, stream);
            LRA_LAUNCHED();
        }
        lra_corner_b_g(r, lra_tiles(n), s.ndmax, gp ? s.gram : nullptr, step, s.mu, s.coef4, s.ws,
                       stream);
        LRA_LAUNCHED();
    } else {
        const LraSrc src{f(uv), f(d), f(h), f(v), nullptr, n, n, r};
        lra_stage1(src, s, stream);
        LRA_LAUNCHED();
        // one block's partials go to the warp corner as they are
        const bool one = !lra_generic(r) && lra_grid(1, n, r) == 1;
        if (!one) {
            lra_reduce(1, r, lra_grid(1, n, r), s.part, s.gram, 2, s.maxpart, s.maxs, stream);
            LRA_LAUNCHED();
        }
        if (lra_generic(r))
            lra_corner_a_g(r, 1, s.gram, s.maxs, step, balance, update_u, s.coef, s.scal, s.ws,
                           stream);
        else
            lra_corner_a_kernel<<<1, LRA_CORNER, 0, stream>>>(
                r, 1, one ? s.part : nullptr, one ? nullptr : s.gram, one ? s.maxpart : s.maxs,
                step, balance, update_u, s.coef, s.scal);
        LRA_LAUNCHED();
        LraSrc src3 = src;
        src3.g = gp;
        const int blocks3 = lra_stage3(src3, s.coef, s.scal, out, n, s.nd, s, stream);
        LRA_LAUNCHED();
        const bool one3 = !lra_generic(r) && blocks3 == 1;
        if (!one3) {
            lra_reduce(2, r, blocks3, gp ? s.part : nullptr, s.gram, 1, s.ndmax, s.ndmax1, stream);
            LRA_LAUNCHED();
        }
        if (lra_generic(r))
            lra_corner_b_g(r, 1, s.ndmax1, gp ? s.gram : nullptr, step, s.mu, s.coef4, s.ws, stream);
        else
            lra_corner_b_kernel<<<1, LRA_CORNER, 0, stream>>>(
                r, 1, one3 ? s.ndmax : s.ndmax1, one3 && gp ? s.part : nullptr,
                !one3 && gp ? s.gram : nullptr, step, s.mu, s.coef4);
        LRA_LAUNCHED();
    }
    lra_stage4(n, n, r, out, f(d), s.nd, gp, s.mu, s.coef4, static_cast<float*>(newd),
               static_cast<float*>(pre), stream);
    LRA_LAUNCHED();
    return (int)cudaSuccess;
}

// ------------------------------------------------ K14's entries, one a stage
// The same kernels, with the host all-reducing between them over the ranks
// that hold the other lanes.

// stage 1: gram (2r+2, 2r+2) = Z Z^T, maxs (2,) = (max|U|, max|V|) over
// lanes [0, n) of rows ld apart: uv, d, h and v point at the first lane
// (any alignment); scratch psgd_lra_scratch_floats of at least n lanes
extern "C" int psgd_lra_stage1(int n, int ld, int r, const void* uv, const void* d, const void* h,
                               const void* v, void* gram, void* maxs, void* scratch,
                               void* stream_ptr) {
    LRA_CHECK(n, ld, r);
    cudaError_t e = lra_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const LraScratch s = lra_carve(scratch, n, r);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    float *gp = static_cast<float*>(gram), *mp = static_cast<float*>(maxs);
    if (!lra_staged(r)) {
        lra_gram_g(n, ld, r, f(uv), f(d), f(h), f(v), nullptr, nullptr, s, s.maxpart, gp, stream);
        LRA_LAUNCHED();
        lra_reduce(1, r, lra_tiles(n), nullptr, nullptr, 2, s.maxpart, mp, stream);
    } else {
        lra_stage1(LraSrc{f(uv), f(d), f(h), f(v), nullptr, n, ld, r}, s, stream);
        LRA_LAUNCHED();
        lra_reduce(1, r, lra_grid(1, n, r), s.part, gp, 2, s.maxpart, mp, stream);
    }
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

// stage 3: newuv (2r, n), nd (n,) and ndmax (1,) = max|nablaD| over the
// lanes; with g (non-null) also gram2 (2r+2, 2r+2), the entries corner B
// reads (U' U'^T and every row against the last two; the others zero);
// uv and newuv rows ld apart
extern "C" int psgd_lra_stage3(int n, int ld, int r, const void* uv, const void* d, const void* h,
                               const void* v, const void* g, const void* coef, const void* scal,
                               void* newuv, void* nd, void* gram2, void* ndmax, void* scratch,
                               void* stream_ptr) {
    LRA_CHECK(n, ld, r);
    cudaError_t e = lra_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    float *out = static_cast<float*>(newuv), *ndp = static_cast<float*>(nd),
          *g2 = static_cast<float*>(gram2), *mx = static_cast<float*>(ndmax);
    const LraScratch s = lra_carve(scratch, n, r);
    if (!lra_staged(r)) {
        lra_stage3_lane_kernel<<<lra_tiles(n), LRA_LANE_TILE, 0, stream>>>(
            n, ld, r, f(uv), f(d), f(h), f(v), f(coef), f(scal), out, ndp, s.ndmax);
        LRA_LAUNCHED();
        if (g) {
            lra_gram_g(n, ld, r, out, f(d), nullptr, nullptr, f(g), ndp, s, nullptr, g2, stream);
            LRA_LAUNCHED();
        }
        lra_reduce(2, r, lra_tiles(n), nullptr, nullptr, 1, s.ndmax, mx, stream);
    } else {
        const int blocks = lra_stage3(LraSrc{f(uv), f(d), f(h), f(v), f(g), n, ld, r}, f(coef),
                                      f(scal), out, ld, ndp, s, stream);
        LRA_LAUNCHED();
        if (g) {
            e = cudaMemsetAsync(g2, 0, sizeof(float) * (size_t)(2 * r + 2) * (2 * r + 2), stream);
            if (e != cudaSuccess) return (int)e;
        }
        lra_reduce(2, r, blocks, g ? s.part : nullptr, g2, 1, s.ndmax, mx, stream);
    }
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
        lra_corner_b_kernel<<<1, LRA_CORNER, 0, stream>>>(r, 1, np, nullptr, gp, step, mp, cp);
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
    lra_stage4(n, ld, r, f(newuv), f(d), f(nd), f(g), f(mu), f(coef4), static_cast<float*>(newd),
               static_cast<float*>(pre), static_cast<cudaStream_t>(stream_ptr));
    LRA_LAUNCHED();
    return (int)cudaSuccess;
}
