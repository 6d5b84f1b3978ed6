// K3: exact inverse of a batch of upper-triangular fp32 factors; K19, the
// blocked triangular solve, at the end of this file.
//
// Replaces psgd_tf_tpu/ops/pallas/tri.py `_newton_inv_batched` (:94), the
// device routine that K1/K2 run on every factor's diagonal blocks. The TPU
// has no trsm, so the Pallas code inverts 128x128 blocks by a Newton chain
// whose residual is nilpotent. Hopper has no such limit: this file inverts
// each WHOLE factor in fp32, exact to fp32 rounding (no iteration, no
// truncation), by the recursive block form that LAPACK's trtri uses
// (tri_inv.cuh): every 32-row leaf inverted by one warp, then
// ceil(log2(leaves)) levels, each joining pairs of diagonal blocks by two
// dependent products, X12 = -X11 (U12 X22), with every pair of every
// factor of the batch in the same launch. A side that is not a multiple of
// 32 is the identity-extended factor, its padding never stored; the
// strictly lower part is written as exact zeros (the products' temporaries
// live there and are zeroed one phase later).
//
// What bounds it on this card: latency, not FLOPs or bytes (LeNet5's ten
// factors, sides 6..257, are 4 MFLOP). The dependent path is the leaves (a
// 32-step register-resident substitution a warp, each step's FMAs
// independent of one another) and two products a level, each at most
// K = n / 2 deep, 32 x 32 output tiles spread over the card (a tile's K
// brought in 128-deep panels by cp.async, summed in quarters by the
// block's four warp pairs): 2 + 2 L phases for L levels (L = 4 at the 257
// side), all in one cooperative launch with a grid barrier between two.
// Measured on an H100 80GB HBM3 at its 700 W limit on LeNet5's ten
// factors (tools/profile_kron_chain.py, tools/kron_gemm_ab.py --tri):
// 39 us on the device (leaves 5 us, each level's phases 3-6 us), where the
// design before this one (each 32-column block column walked serially
// through L2 by one block, 32 blocks for the card, in two launches) took
// 67 us; the same phases a launch each, 0.052 ms against the one launch's
// 0.040. The other candidate, one block a block column with the column
// and U's row panels in shared memory, ran 0.038 ms against this
// schedule's 0.042 in one A/B (tools/kron_gemm_ab.py --tri, on a tree that
// had both), but takes 119 KB of shared memory a block and sides of at
// most 288: not kept.
//
// One difference from the Pallas routine: that one inverts only the
// diagonal blocks and leaves the off-diagonal work to the substitutions of
// its caller; here the caller gets the full inverse and multiplies by it.
#include "psgd.cuh"
#include "tri_inv.cuh"

#include <cooperative_groups.h>
#include <algorithm>

#define TT 32

// Phases [ph0, ph1) of the plan, a grid barrier between two: one
// cooperative launch for them all (launch_tri_inv), or a plain launch of a
// phase alone, which reaches no barrier.
__global__ void __launch_bounds__(TRI_THREADS, 1) tri_kernel(const TriBatch b, int ph0, int ph1) {
    extern __shared__ __align__(16) float tsm[];
    for (int ph = ph0; ph < ph1; ++ph) {
        if (ph > ph0) cooperative_groups::this_grid().sync();
        tri_phase(b, ph, tsm);
    }
}

void plan_tri_inv(TriBatch& b) {
    b.tiles[0] = 0;
    b.levels = 0;
    for (int p = 0; p < b.count; ++p) b.tiles[p + 1] = b.tiles[p] + (b.n[p] + TRI_LEAF - 1) / TRI_LEAF;
    for (int l = 0; l < PSGD_TRI_LEVELS; ++l) {
        b.level_tiles[l][0] = 0;
        for (int p = 0; p < b.count; ++p)
            b.level_tiles[l][p + 1] = b.level_tiles[l][p] + tri_level_tiles(b.n[p], l);
        if (b.level_tiles[l][b.count]) b.levels = l + 1;
    }
}

#define TRI_SMEM (sizeof(float) * TRI_SMEM_FLOATS)

// tri_kernel's resident CTAs on the current card (CTAs a SM x SMs), asked
// once a device; 0 where the card takes no cooperative launch
static cudaError_t tri_resident(int* ctas) {
    static int known_dev = -1, known = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev != known_dev) {
        int coop = 0, per_sm = 0, sms = 0;
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(tri_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TRI_SMEM);
        if (e == cudaSuccess && coop)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tri_kernel, TRI_THREADS, TRI_SMEM);
        if (e != cudaSuccess) return e;
        known = per_sm * sms;
        known_dev = dev;
    }
    *ctas = known;
    return cudaSuccess;
}

// Every phase in one cooperative launch of a resident grid, as large as
// the largest phase's tasks. A launch the card refuses is left as the last
// error, which the callers return.
void launch_tri_inv(TriBatch& b, cudaStream_t stream) {
    plan_tri_inv(b);
    int ctas = 0, ph0 = 0, ph1 = tri_phases(b), most = 1;
    if (tri_resident(&ctas) != cudaSuccess) return;
    for (int ph = 0; ph < ph1; ++ph) most = std::max(most, tri_phase_tasks(b, ph));
    void* args[] = {&b, &ph0, &ph1};
    cudaLaunchCooperativeKernel((const void*)tri_kernel, dim3(std::min(most, std::max(ctas, 1))),
                                dim3(TRI_THREADS), args, TRI_SMEM, stream);
}

extern "C" int psgd_tri_inv_upper(int count, void** u, void** x, const int* n, void* stream) {
    if (count < 1 || count > PSGD_MAX_TRI) return (int)cudaErrorInvalidValue;
    TriBatch b;
    b.count = count;
    for (int p = 0; p < count; ++p) {
        if (n[p] < 1 || n[p] > (TRI_LEAF << PSGD_TRI_LEVELS)) return (int)cudaErrorInvalidValue;
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
// Here, in fp32 with no iteration and no padding, a blocked solve whose
// off-diagonal work runs as GEMMs that spread over the card.
// ops/hopper/tri.py builds the schedule (TRI_OP_* records of six ints) and
// one call of psgd_tri_solve launches it, with no host synchronisation:
//   INV     M_ii^{-1} of every NB x NB diagonal block at once, in two
//           launches: tri_diag_tile (below, K3's routine as it was before
//           K3's redesign) inverts each 32x32 diagonal tile, then
//           solve_walk_kernel, K3's old off-diagonal walk, fills each block's
//           columns. Both work on U = M or M^T, whichever is upper: U reads
//           Q through the transposed index when lower, and a forward
//           system takes the block's inverse transposed (the leaf's A
//           operand flag). The inverses go to an (n/NB, NB, NB) scratch.
//   LEAF    X_i = M_ii^{-1} C_i, block i in substitution order:
//           tri_gemm_kernel, its K loop cut to the inverse's triangle;
//   UPDATE  C_r = S_r - M_ri X_i for every row r not yet solved (below
//           block i forward, above it backward): tri_gemm_kernel, reading
//           M_ri = Q_ir^T through the transposed index (no transposed
//           copy). S is B until this first update has written C, and C
//           (in place) after;
//   SUBST   the whole system by the substitution kernel below, for small n:
//           the 32x32 diagonal tiles' inverses, then one block per SV_W
//           columns walking the block rows in order.
// Only the triangle of Q named by `lower` is read; rows past n are masked
// (the identity-extended system), so any n is taken.
//
// tri_gemm_kernel: 32x64 output tiles of 128 threads, a 4x4 register
// micro-tile a thread, K in steps of 16 through four shared-memory stages
// filled by 4-byte cp.async, three steps in flight (zero-filled past the
// edges, so any shape and stride is taken), fp32 FMA. It is K19's own; the
// grouped GEMM of kron_dd.cu serves K1, K4, K9, K10 and K17.
//
// What bounds it: at n = 2048, nrhs = 512 the n^2 nrhs = 2.1 GFLOP take 32 us
// at the 67 TFLOP/s fp32 peak, and the bytes 5 us. The substitution kernel
// alone ran it as 32 column panels (32 of 132 SMs), each a chain of 2,016
// dependent tile steps: 1.43 ms. Blocked, the critical path is 2 + 2 n/NB
// launches, each K = NB deep at most: the first updates cover ~n rows
// (448 output tiles at 2048), so the card fills, and only the leaves and
// the last updates leave SMs idle. The choices, measured on an H100 80GB
// HBM3 at its 700 W limit (tools/tri_lra_ab.py --sweep), at n = 2048,
// nrhs = 512:
//   - right-looking (0.309 ms at NB = 256) rather than a recursive split
//     into halves (0.332): the split's deep updates (K up to n/2) have the
//     fewest output tiles, so their long K loops run on a fraction of the
//     SMs;
//   - NB = 256 (0.309) over 128 (0.355) and 64 (0.486): half the launches
//     of 128 outweigh the longer leaves and the longer walk of INV;
//   - 32x64 tiles of 128 threads: two blocks an SM where a 64x64 grid would
//     put one;
//   - SUBST up to n = 384: the substitution kernel's two launches beat the
//     blocked schedule's there (0.071 against 0.088 ms at n = 384,
//     nrhs = 256) and lose above (0.111 against 0.098 at n = 512).
// The solve as a whole runs at ~7 TFLOP/s (2.1 GFLOP in 0.309 ms), ~10x
// its bound; tensor cores (3xTF32, a separate precision setting) or a
// warp-specialised GEMM are later work.

// K19's 32x32 diagonal-tile inverse (K3's leaf routine before K3's
// redesign, kept as K19 measured it): the tile at (r0, r0) of an
// upper-triangular (n, n) factor u, identity-extended past n, by one warp;
// each thread back-substitutes one column in shared memory. read_t reads u[c][r] as the
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

// INV, first launch: the 32x32 diagonal tile t of U (U = M or M^T, read
// through the transposed index when lower), inverted into its place in the
// (n/nb, nb, nb) scratch w, untransposed
__global__ void __launch_bounds__(TT) solve_inv_diag_kernel(int n, int nb, int lower,
                                                            const float* __restrict__ q,
                                                            float* __restrict__ w) {
    const int r0 = blockIdx.x * TT, blk = r0 / nb, o = r0 - blk * nb;
    tri_diag_tile(q, n, r0, lower, w + (size_t)blk * nb * nb + (size_t)o * nb + o, nb, 0, TT);
}

// INV, second launch: column j (of 32) of the inverse of U's nb x nb
// diagonal block `blk`, by K3's walk: X[i,j] = -X[i,i] sum_{k=i+1..j} U[i,k]
// X[k,j] for block rows i = j-1 .. 0, the strictly lower tiles zero. One
// block of (32, 8) threads per (diagonal block, tile column).
__global__ void __launch_bounds__(TT * 8) solve_walk_kernel(int n, int nb, int lower,
                                                            const float* __restrict__ q,
                                                            float* w) {
    const int per = nb / TT, blk = blockIdx.x / per, j = blockIdx.x % per;
    const int base = blk * nb, size = min(nb, n - base), tl = (size + TT - 1) / TT;
    if (j >= tl) return;  // uniform across the block
    float* x = w + (size_t)blk * nb * nb;  // read back after this block writes it
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int xc = j * TT + tx;
    __shared__ float sa[TT][TT + 1];
    __shared__ float sb[TT][TT + 1];

    for (int i = j + 1; i < tl; ++i)
        for (int rr = ty; rr < TT; rr += 8) x[(size_t)(i * TT + rr) * nb + xc] = 0.f;
    for (int i = j - 1; i >= 0; --i) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = i + 1; k <= j; ++k) {
            for (int qq = 0; qq < 4; ++qq) {
                const int rr = ty + 8 * qq;
                // U[i,k]'s element (row, col); a lower Q is read along its
                // rows (U = Q^T), so consecutive threads read consecutive floats
                const int row = lower ? tx : rr, col = lower ? rr : tx;
                const int ur = base + i * TT + row, uc = base + k * TT + col;
                sa[row][col] = (ur < n && uc < n)
                                   ? q[lower ? (size_t)uc * n + ur : (size_t)ur * n + uc] : 0.f;
                const int xr = k * TT + rr;
                sb[rr][tx] = (xr < size && xc < size) ? x[(size_t)xr * nb + xc] : 0.f;
            }
            __syncthreads();
            for (int kk = 0; kk < TT; ++kk) {
                const float bv = sb[kk][tx];
                for (int qq = 0; qq < 4; ++qq) acc[qq] += sa[ty + 8 * qq][kk] * bv;
            }
            __syncthreads();
        }
        for (int qq = 0; qq < 4; ++qq) {
            const int rr = ty + 8 * qq, dr = i * TT + rr, dc = i * TT + tx;
            sb[rr][tx] = acc[qq];
            sa[rr][tx] = (dr < size && dc < size) ? x[(size_t)dr * nb + dc] : 0.f;
        }
        __syncthreads();
        for (int qq = 0; qq < 4; ++qq) {
            const int rr = ty + 8 * qq;
            float s = 0.f;
            for (int kk = 0; kk < TT; ++kk) s += sa[rr][kk] * sb[kk][tx];
            if (i * TT + rr < size && xc < size) x[(size_t)(i * TT + rr) * nb + xc] = -s;
        }
        __syncthreads();
    }
}

// C (M x N) = S - A X, or A X when s is null. A(m, k) = a[k * lda + m] when
// ta, else a[m * lda + k]; X(k, j) = b[k * ldb + j]; C and S share ldc and
// may alias (each element is read and written by one thread). cut: A is
// lower (1) or upper (2) triangular, and a tile's K loop skips its zeros.
struct TriGemm {
    const float* a;
    const float* b;
    const float* s;
    float* c;
    int lda, ldb, ldc, ta, M, N, K, cut;
};

#define TG_BM 32
#define TG_BN 64
#define TG_BK 16
#define TG_STAGES 4
#define TG_THREADS (TG_BM * TG_BN / 16)

__device__ __forceinline__ void tg_cp4(float* dst, const float* src, bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 4 : 0));
}

// One TG_BM x TG_BN tile of C a block, a 4x4 micro-tile a thread
__global__ void __launch_bounds__(TG_THREADS) tri_gemm_kernel(const TriGemm p) {
    __shared__ __align__(16) float As[TG_STAGES][TG_BK][TG_BM + 4];
    __shared__ __align__(16) float Bs[TG_STAGES][TG_BK][TG_BN + 4];
    const int tid = threadIdx.x, tx = tid % (TG_BN / 4), ty = tid / (TG_BN / 4);
    const int m0 = blockIdx.y * TG_BM, n0 = blockIdx.x * TG_BN;
    const int k_lo = p.cut == 2 ? m0 : 0;
    const int k_hi = p.cut == 1 ? min(p.K, m0 + TG_BM) : p.K;
    const int steps = k_hi > k_lo ? (k_hi - k_lo + TG_BK - 1) / TG_BK : 0;

    // stage st <- the K step at k0: A as As[k][m] (coalesced along m when
    // ta, along k otherwise), X as Bs[k][j]; out-of-range elements zero
    auto load = [&](int st, int k0) {
#pragma unroll
        for (int qq = 0; qq < TG_BM * TG_BK / TG_THREADS; ++qq) {
            const int e = tid + qq * TG_THREADS;
            const int mm = p.ta ? e % TG_BM : e / TG_BK, kk = p.ta ? e / TG_BM : e % TG_BK;
            const int gm = m0 + mm, gk = k0 + kk;
            const bool ok = gm < p.M && gk < k_hi;
            tg_cp4(&As[st][kk][mm],
                   ok ? p.a + (p.ta ? (size_t)gk * p.lda + gm : (size_t)gm * p.lda + gk) : p.a, ok);
        }
#pragma unroll
        for (int qq = 0; qq < TG_BN * TG_BK / TG_THREADS; ++qq) {
            const int e = tid + qq * TG_THREADS;
            const int bk = e / TG_BN, bj = e % TG_BN, gb = k0 + bk, gj = n0 + bj;
            const bool ok = gb < k_hi && gj < p.N;
            tg_cp4(&Bs[st][bk][bj], ok ? p.b + (size_t)gb * p.ldb + gj : p.b, ok);
        }
    };

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // TG_STAGES - 1 K steps in flight: the copy of step t + 3 overlaps the
    // products of step t (one commit group a step, empty past the end)
#pragma unroll
    for (int s = 0; s < TG_STAGES - 1; ++s) {
        if (s < steps) load(s, k_lo + s * TG_BK);
        asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int t = 0; t < steps; ++t) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(TG_STAGES - 2));
        // step t's tile has landed, and every thread is done with step t - 1's stage
        __syncthreads();
        const int nt = t + TG_STAGES - 1;
        if (nt < steps) load(nt % TG_STAGES, k_lo + nt * TG_BK);
        asm volatile("cp.async.commit_group;\n" ::);
        const int st = t % TG_STAGES;
#pragma unroll
        for (int kk = 0; kk < TG_BK; ++kk) {
            const float4 av = *reinterpret_cast<const float4*>(&As[st][kk][ty * 4]);
            const float4 bv = *reinterpret_cast<const float4*>(&Bs[st][kk][tx * 4]);
            const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] += a4[i] * b4[j];
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gm = m0 + ty * 4 + i;
        if (gm >= p.M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int gj = n0 + tx * 4 + j;
            if (gj >= p.N) continue;
            const size_t o = (size_t)gm * p.ldc + gj;
            p.c[o] = p.s ? p.s[o] - acc[i][j] : acc[i][j];
        }
    }
}

static void launch_tri_gemm(const TriGemm& p, cudaStream_t stream) {
    const dim3 grid((p.N + TG_BN - 1) / TG_BN, (p.M + TG_BM - 1) / TG_BM);
    tri_gemm_kernel<<<grid, TG_THREADS, 0, stream>>>(p);
}

// schedule records: {kind, r0, rows, k0, k, src}; src 1 reads C, 0 reads B
enum { TRI_OP_SUBST = 0, TRI_OP_INV = 1, TRI_OP_LEAF = 2, TRI_OP_UPDATE = 3 };
#define TRI_OP_INTS 6

// The scratch of a solve: the diagonal blocks' inverses (SUBST: the 32x32
// tiles'), then C (n, nrhs), the updated right-hand sides, unless subst
extern "C" size_t psgd_tri_solve_scratch_floats(int n, int nrhs, int nb, int subst) {
    if (subst) return psgd_align4((size_t)((n + TT - 1) / TT) * TT * TT);
    const size_t blocks = (size_t)(n + nb - 1) / nb;
    return psgd_align4(blocks * nb * nb) + psgd_align4((size_t)n * nrhs);
}

// X (n, nrhs) solving M X = B by the schedule `ops` (nops records, built by
// ops/hopper/tri.py); scratch: psgd_tri_solve_scratch_floats(n, nrhs, nb,
// ops is one SUBST record)
extern "C" int psgd_tri_solve(int n, int nrhs, int lower, int trans, int nb, const int* ops,
                              int nops, const void* q_ptr, const void* b_ptr, void* x_ptr,
                              void* scratch, void* stream_ptr) {
    if (n < 1 || nrhs < 1 || nb < TT || nb % TT || nops < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int forward = lower != trans;
    const float* q = static_cast<const float*>(q_ptr);
    const float* b = static_cast<const float*>(b_ptr);
    float* x = static_cast<float*>(x_ptr);
    float* w = static_cast<float*>(scratch);
    float* c = w + psgd_align4((size_t)((n + nb - 1) / nb) * nb * nb);
    for (int o = 0; o < nops; ++o) {
        const int* op = ops + TRI_OP_INTS * o;
        const int kind = op[0], r0 = op[1], rows = op[2], k0 = op[3], k = op[4];
        const float* src = op[5] ? c : b;
        if (r0 < 0 || rows < 1 || r0 + rows > n || k0 < 0 || k < 0 || k0 + k > n)
            return (int)cudaErrorInvalidValue;
        if (kind == TRI_OP_SUBST) {
            if (r0 != 0 || rows != n) return (int)cudaErrorInvalidValue;
            const int tiles = (n + TT - 1) / TT;
            solve_diag_kernel<<<tiles, TT, 0, stream>>>(n, lower, forward, q, w);
            solve_subst_kernel<<<(nrhs + SV_W - 1) / SV_W, dim3(SV_W, SV_ROWS), 0, stream>>>(
                n, nrhs, trans, forward, q, b, x, w);
        } else if (kind == TRI_OP_INV) {
            const int blocks = (n + nb - 1) / nb;
            solve_inv_diag_kernel<<<(n + TT - 1) / TT, TT, 0, stream>>>(n, nb, lower, q, w);
            solve_walk_kernel<<<blocks * (nb / TT), dim3(TT, 8), 0, stream>>>(n, nb, lower, q, w);
        } else if (kind == TRI_OP_LEAF) {
            if (r0 % nb || rows > nb) return (int)cudaErrorInvalidValue;
            // X_i = M_ii^{-1} S_i: the forward inverse is the walk's transposed
            TriGemm p{w + (size_t)(r0 / nb) * nb * nb, src + (size_t)r0 * nrhs, nullptr,
                      x + (size_t)r0 * nrhs, nb, nrhs, nrhs, forward, rows, nrhs, rows,
                      forward ? 1 : 2};
            launch_tri_gemm(p, stream);
        } else if (kind == TRI_OP_UPDATE) {
            if (k < 1 || (forward ? k0 + k > r0 : r0 + rows > k0)) return (int)cudaErrorInvalidValue;
            // C_t = S_t - M_ts X_s, M_ts = Q[t, s] or Q[s, t]^T
            const float* a = trans ? q + (size_t)k0 * n + r0 : q + (size_t)r0 * n + k0;
            TriGemm p{a, x + (size_t)k0 * nrhs, src + (size_t)r0 * nrhs, c + (size_t)r0 * nrhs,
                      n, nrhs, nrhs, trans, rows, nrhs, k, 0};
            launch_tri_gemm(p, stream);
        } else {
            return (int)cudaErrorInvalidValue;
        }
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaSuccess;
}
