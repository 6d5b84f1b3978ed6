// K4: the update of B stacked (dense, dense) layers of one padded bucket,
// one chain over the whole stack at any B.
//
// Replaces psgd_tf_tpu/ops/pallas/kron_dd.py `fused_update_batched` (:252,
// its pallas_call at :294, `_batched_kernel` :240): ql (B, S, S), qr
// (B, T, T), dx and dg (B, S, T), layer i's true (m_i, n_i) in the corners,
// identity (factors) and zeros (probes) beyond. The Pallas grid runs the
// single-layer body (`_update_body` :156) on each padded layer in turn,
// the layer resident in VMEM. Hopper cannot hold a layer in one block (a
// (256, 256) fp32 factor is 264 KB, a block has 227 KB), so the stack runs
// K1's stages (kron_dd.cu's note), each ONE launch over every layer:
//   balance   rho_i from the corners' diagonals (masked by construction),
//             the balanced corners to scratch slots, the max|grad| slots zeroed;
//   K3        the exact inverse of all 2B balanced factors in one
//             cooperative launch (tri.cu launch_tri_stack: factor i at
//             base + i S^2 or base + i T^2, row stride S or T);
//   C1        T1 = dG Qr^T and W = Linv^T dX;
//   C2        A = Ql T1 and Bt = W Rinv;
//   C3        the triu Gram differences A A^T - Bt Bt^T and A^T A - Bt^T Bt,
//             max|grad| by block reduction and atomicMax on the float bits
//             (order-free, so every call gives the same bits);
//   D         Q' = Q - s triu(grad) Q, s = min(step / (max|grad| + tiny),
//             FLT_MAX), stored straight into the output stacks at row
//             stride S or T, with exact identity beyond each corner (the
//             tiles cover the whole slot: those outside the corner run no
//             K loop and store identity).
// Every operand and output sits in its slot of a stack (row stride S or T,
// slot strides S^2, T^2 and S T floats), so a layer's pointers come from
// its index alone; the kernels read the per-layer (m_i, n_i) and each
// stage's prefix sums of tiles from a table in device memory (built once a
// bucket by the wrapper, searched by bisection), and launch exactly the
// tiles of the true corners: no tile of a ragged bucket idles, no product
// runs over the padding. The launches of a call do not depend on B: 6 to
// 10 (balance, K3, and one or two a GEMM stage).
//
// The GEMM stages are kernels of this file over gemm_tile.cuh's tile body
// (the grouped GEMM's cp.async ring and FMA loop, fp32, TF32 off), with
// their own operand addressing and epilogues: the shared GemmProb and
// GemmBatch and the kernels of K1, K9, K10 and K17 are untouched (a row
// stride added to the shared descriptor once slowed those by up to 25%).
// Each stage picks its tile by K1's rule: 128 x 128 (8 x 8 outputs a
// thread, 50,688 bytes of shared memory a block for the 3-stage ring, two
// blocks an SM, one launch per operand orientation) where each of its
// launches has K4_BIG_TILES such tiles an SM, else 64 x 64 (26,112 bytes,
// both orientations in one launch) with K cut into bands of about
// KRON_SPLIT_K while the tiles times the bands fit the SMs, the bands' raw
// products summed in band order by a launch that applies the epilogue.
// The stacked K3 is tri.cu's bodies (36,864 bytes a block, and its plan,
// copied there from device memory).
//
// What bounds it: small buckets the dependent chain of launches (latency),
// wide ones (B = 4 of (1000, 1000), B = 48 of (768, 768)) the fp32 FMAs of
// the products and of K3. Measured on an NVIDIA H100 80GB HBM3 at its
// 700.00 W limit (tools/profile_kron_chain.py --k4, device us of each
// launch queued behind a spinning kernel; K1 on the same layers unbatched
// beside it; the stacking of dX and dG by kron.update_batched, one to
// three torch kernels, is counted in the spans):
//   B = 48 of (768, 768), 8 launches: balance 199, K3 2,142 (6.8 TFLOP/s),
//     C1 861 + 701 (27.8 TFLOP/s), C2 1,581 (27.5), C3 1,508 + 1,366
//     (30.3), D 818 (17.7); span 9,340 against K1's 10,487 (three chains);
//   B = 4 of (1000, 1000), 64 x 64 tiles, 6 launches: balance 47, K3 389,
//     C1 351 (22.8 TFLOP/s), C2 363 (22.0), C3 695 (23.0), D 182 (14.6);
//     span 2,098 against K1's 2,058 (the stacking's 60);
//   B = 24 of (200, 256), 6 launches: span 357 against K1's 454 (two
//     chains); the K4 path's bucket, 10 launches: 80 against 66.
// TFLOP/s count the FLOPs the stage needs (a triangular operand's zeros
// not counted), against the grouped GEMM's 36.1 on a dense (131072 x 512)
// x (512 x 512) product (kron_dd.cu's note). The 128 x 128 tiles lose at
// B = 4 of (1000, 1000) (tools/kron_gemm_ab.py --k4): with 256 tiles a
// launch each launch is one unbalanced wave.
#include "psgd.cuh"

#include "gemm_tile.cuh"
#include "tri_inv.cuh"

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <vector>

#define K4_BIG_TILES 4    // 128 x 128 tiles where a launch has this many an SM
#define K4_MAX_SIDE 32768 // a slot's side, at most

enum { K4_C1 = 0, K4_C2 = 1, K4_C3 = 2, K4_D = 3, K4_GEMMS = 4 };

// Problem p of a GEMM stage: p < B side 0 of layer p, else side 1 of layer
// p - B. Its output's rows, columns and K from the layer's (m, n).
__host__ __device__ inline void stack_dims(int g, int side, int m, int n, int& M, int& N, int& K) {
    if (g == K4_C1) { M = m; N = n; K = side ? m : n; }
    else if (g == K4_C2) { M = m; N = n; K = side ? n : m; }
    else if (g == K4_C3) { M = N = side ? n : m; K = side ? m : n; }
    else { M = N = K = side ? n : m; }
}

// The operand orientation (ta * 2 + tb) of a stage's side
__host__ __device__ constexpr int stack_var(int g, int side) {
    return (g == K4_C1 || g == K4_C3) ? (side ? 2 : 1) : 0;
}

// The device's view of one call: the stacks, the scratch slots and the table
struct StackArgs {
    const float *ql, *qr, *dx, *dg;
    float *out_ql, *out_qr;
    float *qlb, *qrb, *linv, *rinv, *t1, *w, *a, *bt, *g1, *g2, *part;
    unsigned int* mx;  // two max|grad| slots a layer
    const int* tab;    // m[B], n[B], then the plan's prefix sums
    int B, S, T;
    float step;
};

// One launch of a GEMM stage: its problems [lo, hi) of the stage's 2B, the
// tile of its first block, the prefix sums' offsets in the table, its K
// bands and its partials' offset in the scratch (floats)
struct StackLaunch {
    int tiles_at, sums_at, lo, hi, t0, splits;
    size_t part;
};

// Problem p of stage G at its slots; ldc: its output's row stride (the
// update's balanced factor shares it).
template <int G>
__device__ __forceinline__ GemmProb stack_prob(const StackArgs& A, int p, int& ldc) {
    const int B = A.B, side = p >= B, i = side ? p - B : p, S = A.S, T = A.T;
    const int m = A.tab[i], n = A.tab[B + i];
    const size_t ss = (size_t)i * S * S, tt = (size_t)i * T * T, st = (size_t)i * S * T;
    GemmProb P = {};
    stack_dims(G, side, m, n, P.M, P.N, P.K);
    auto ops = [&](const float* a, int ta, int lda, const float* b, int tb, int ldb, int cut) {
        P.a = a; P.ta = ta; P.lda = lda;
        P.b = b; P.tb = tb; P.ldb = ldb;
        P.cut = cut;
    };
    if (G == K4_C1) {
        ldc = T;
        if (!side) { ops(A.dg + st, 0, T, A.qrb + tt, 1, T, CUT_B_LOWER); P.c = A.t1 + st; }
        else { ops(A.linv + ss, 1, S, A.dx + st, 0, T, CUT_A_LOWER); P.c = A.w + st; }
    } else if (G == K4_C2) {
        ldc = T;
        if (!side) { ops(A.qlb + ss, 0, S, A.t1 + st, 0, T, CUT_A_UPPER); P.c = A.a + st; }
        else { ops(A.w + st, 0, T, A.rinv + tt, 0, T, CUT_B_UPPER); P.c = A.bt + st; }
    } else if (G == K4_C3) {
        // [A | Bt] [A | -Bt]^T (left) or its transpose (right)
        ops(A.a + st, side, T, A.a + st, !side, T, 0);
        P.a2 = A.bt + st;
        P.b2 = A.bt + st;
        ldc = side ? T : S;
        P.c = side ? A.g2 + tt : A.g1 + ss;
        P.mx = A.mx + 2 * i + side;
    } else {
        ldc = side ? T : S;
        const float* q = side ? A.qrb + tt : A.qlb + ss;
        ops(side ? A.g2 + tt : A.g1 + ss, 0, ldc, q, 0, ldc, CUT_A_UPPER | CUT_B_UPPER);
        P.q = q;
        P.c = side ? A.out_qr + tt : A.out_ql + ss;
        P.mx = A.mx + 2 * i + side;
    }
    return P;
}

// Band y of problem p's raw product, at the output's row stride: the
// stage's partials hold side 0's bands of every layer, then side 1's
template <int G>
__device__ __forceinline__ float* stack_part(const StackArgs& A, const StackLaunch& L, int p,
                                             int y) {
    const int B = A.B, side = p >= B, i = side ? p - B : p;
    const size_t slot0 = G <= K4_C2 ? (size_t)A.S * A.T : (size_t)A.S * A.S;
    const size_t slot = G <= K4_C2 ? slot0 : side ? (size_t)A.T * A.T : slot0;
    return A.part + L.part + (side ? (size_t)L.splits * B * slot0 : 0) + ((size_t)y * B + i) * slot;
}

// One output tile of a stage: tile `tile` of the launch's prefix, band
// `split` of the launch's splits. SIDE >= 0: the launch holds that side's
// problems alone (one operand orientation); -1 both. PART: the raw band
// into the partials (a sum launch applies the epilogue). The update stage
// unsplit tiles the whole (S, S) or (T, T) slot: identity beyond the corner.
template <int G, int Q, int SIDE, bool PART>
__device__ __forceinline__ void stack_gemm_body(const StackArgs& A, const StackLaunch& L, int tile,
                                                int split, float* gsm, float* red) {
    using Tl = GemmTile<Q, Q>;
    const int* prefix = A.tab + L.tiles_at;
    const int p = psgd_bisect(prefix, L.lo, L.hi, tile);
    int ldc;
    const GemmProb P = stack_prob<G>(A, p, ldc);
    const int side = SIDE >= 0 ? SIDE : p >= A.B;
    const int edge = G == K4_D && !PART ? (side ? A.T : A.S) : 0;
    const int t = tile - prefix[p];
    const int tiles_n = ((edge ? edge : P.N) + Tl::BN - 1) / Tl::BN;
    const int row0 = (t / tiles_n) * Tl::BM, col0 = (t % tiles_n) * Tl::BN;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

    float acc[4 * Q][4 * Q];
#pragma unroll
    for (int i = 0; i < 4 * Q; ++i)
#pragma unroll
        for (int j = 0; j < 4 * Q; ++j) acc[i][j] = 0.f;
    // a tile wholly below the diagonal of a triu output, or outside the
    // corner, runs no K loop
    const bool skip = (G == K4_C3 && row0 > col0 + Tl::BN - 1) || row0 >= P.M || col0 >= P.N;
    int k_lo = 0, k_hi = P.K;
    if (L.splits > 1) {
        const int kc = ((P.K + L.splits - 1) / L.splits + GEMM_BK - 1) / GEMM_BK * GEMM_BK;
        k_lo = split * kc;
        k_hi = min(P.K, k_lo + kc);
    }
    if (P.cut & CUT_A_UPPER) k_lo = max(k_lo, row0);
    if (P.cut & CUT_A_LOWER) k_hi = min(k_hi, row0 + Tl::BM);
    if (P.cut & CUT_B_UPPER) k_hi = min(k_hi, col0 + Tl::BN);
    if (P.cut & CUT_B_LOWER) k_lo = max(k_lo, col0);
    if (!skip) {
        constexpr int V0 = stack_var(G, 0), V1 = stack_var(G, 1);
        if (V0 == V1 || SIDE == 0 || (SIDE < 0 && !side))
            gemm_tile<Q, Q, (V0 >> 1) & 1, V0 & 1>(P, row0, col0, k_lo, k_hi, gsm, acc);
        else gemm_tile<Q, Q, (V1 >> 1) & 1, V1 & 1>(P, row0, col0, k_lo, k_hi, gsm, acc);
    }
    // the epilogue's operands made again from an opaque copy of p, so that
    // none of them is held in a register through the K loop
    int pe = p;
    asm volatile("" : "+r"(pe));
    const GemmProb E = stack_prob<G>(A, pe, ldc);

    if constexpr (PART) {
        float* c = stack_part<G>(A, L, pe, split);
#pragma unroll
        for (int ii = 0; ii < 4 * Q; ++ii) {
            const int i = row0 + (ii / 4) * 64 + ty * 4 + ii % 4;
#pragma unroll
            for (int jj = 0; jj < 4 * Q; ++jj) {
                const int j = col0 + (jj / 4) * 64 + tx * 4 + jj % 4;
                if (i < E.M && j < E.N) c[(size_t)i * ldc + j] = acc[ii][jj];
            }
        }
        return;
    }
    const float s = G == K4_D ? step_scale(A.step, E.mx) : 0.f;
    float local_max = 0.f;
#pragma unroll
    for (int ii = 0; ii < 4 * Q; ++ii) {
        const int i = row0 + (ii / 4) * 64 + ty * 4 + ii % 4;
#pragma unroll
        for (int jj = 0; jj < 4 * Q; ++jj) {
            const int j = col0 + (jj / 4) * 64 + tx * 4 + jj % 4;
            const size_t o = (size_t)i * ldc + j;
            if (G == K4_D) {
                if (i >= edge || j >= edge) continue;
                E.c[o] = (i < E.M && j < E.N) ? E.q[o] - s * acc[ii][jj] : (i == j ? 1.f : 0.f);
                continue;
            }
            if (i >= E.M || j >= E.N) continue;
            float v = acc[ii][jj];
            if (G == K4_C3) {
                v = i <= j ? v : 0.f;
                local_max = fmaxf(local_max, fabsf(v));
            }
            E.c[o] = v;
        }
    }
    if (G == K4_C3) {
        // |grad| >= 0, so its float bits order like unsigned integers
        local_max = block_reduce_max(local_max, red);
        if (threadIdx.x == 0) atomicMax(E.mx, __float_as_uint(local_max));
    }
}

// grid (the launch's tiles, its K bands)
template <int G, int Q, int SIDE, bool PART>
__global__ void __launch_bounds__(GEMM_THREADS, 2) stack_gemm_kernel(const StackArgs A,
                                                                    const StackLaunch L) {
    extern __shared__ __align__(16) float gsm[];
    __shared__ float red[GEMM_THREADS / 32];
    stack_gemm_body<G, Q, SIDE, PART>(A, L, L.t0 + blockIdx.x, blockIdx.y, gsm, red);
}

// The K split's sums, 256 outputs a block: problem p's bands summed in
// band order, then the stage's epilogue (the update's over its whole slot)
template <int G>
__global__ void __launch_bounds__(GEMM_THREADS) stack_sum_kernel(const StackArgs A,
                                                                 const StackLaunch L) {
    __shared__ float red[GEMM_THREADS / 32];
    const int* prefix = A.tab + L.sums_at;
    const int p = psgd_bisect(prefix, 0, 2 * A.B, blockIdx.x);
    int ldc;
    const GemmProb P = stack_prob<G>(A, p, ldc);
    const int w = G == K4_D ? ldc : P.N, rows = G == K4_D ? ldc : P.M;
    const int e = (blockIdx.x - prefix[p]) * GEMM_THREADS + threadIdx.x;
    const float s = G == K4_D ? step_scale(A.step, P.mx) : 0.f;
    float local_max = 0.f;
    if (e < rows * w) {
        const int i = e / w, j = e % w;
        const size_t o = (size_t)i * ldc + j;
        float v = i == j ? 1.f : 0.f;  // the update's slot beyond the corner
        if (i < P.M && j < P.N) {
            const float* part = stack_part<G>(A, L, p, 0) + o;
            const size_t band = stack_part<G>(A, L, p, 1) - stack_part<G>(A, L, p, 0);
            float b[KRON_MAX_SPLITS];  // every band's load in flight, then the sum in band order
#pragma unroll
            for (int y = 0; y < KRON_MAX_SPLITS; ++y) b[y] = y < L.splits ? part[y * band] : 0.f;
            v = b[0];
#pragma unroll
            for (int y = 1; y < KRON_MAX_SPLITS; ++y)
                if (y < L.splits) v += b[y];
            if (G == K4_C3) {
                v = i <= j ? v : 0.f;
                local_max = fabsf(v);
            } else if (G == K4_D) {
                v = P.q[o] - s * v;
            }
        }
        P.c[o] = v;
    }
    if (G == K4_C3) {
        local_max = block_reduce_max(local_max, red);
        if (threadIdx.x == 0) atomicMax(P.mx, __float_as_uint(local_max));
    }
}

// Balance: block bx of layer i's share (prefix at bal_at), every block
// recomputing its layer's diagonal maxima over the true corners
__global__ void __launch_bounds__(256) stack_balance_kernel(const StackArgs A, int bal_at) {
    __shared__ float red[8];
    const int* prefix = A.tab + bal_at;
    const int i = psgd_bisect(prefix, 0, A.B, blockIdx.x);
    const int bx = blockIdx.x - prefix[i], gx = prefix[i + 1] - prefix[i];
    const int m = A.tab[i], n = A.tab[A.B + i], S = A.S, T = A.T;
    const size_t ss = (size_t)i * S * S, tt = (size_t)i * T * T;
    const float* ql = A.ql + ss;
    const float* qr = A.qr + tt;
    float ml = -INFINITY, mr = -INFINITY;
    for (int k = threadIdx.x; k < m; k += blockDim.x) ml = fmaxf(ml, ql[(size_t)k * (S + 1)]);
    for (int k = threadIdx.x; k < n; k += blockDim.x) mr = fmaxf(mr, qr[(size_t)k * (T + 1)]);
    ml = block_reduce_max(ml, red);
    mr = block_reduce_max(mr, red);
    const float rho = sqrtf(ml / mr);
    if (bx == 0 && threadIdx.x == 0) {
        A.mx[2 * i] = 0u;
        A.mx[2 * i + 1] = 0u;
    }
    // the corners' elements counted in 32 bits (sides up to K4_MAX_SIDE),
    // eight elements' loads in flight before their stores
    const unsigned nl = (unsigned)m * m, total = nl + (unsigned)n * n;
    const unsigned stride = gx * blockDim.x;
    for (unsigned e0 = bx * blockDim.x + threadIdx.x; e0 < total; e0 += 8 * stride) {
        float v[8];
        size_t o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const unsigned e = e0 + k * stride, f = e - nl;
            o[k] = e < nl ? (size_t)(e / m) * S + e % m : e < total ? (size_t)(f / n) * T + f % n : 0;
            v[k] = e < nl ? ql[o[k]] : e < total ? qr[o[k]] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const unsigned e = e0 + k * stride;
            if (e < nl) A.qlb[ss + o[k]] = v[k] / rho;
            else if (e < total) A.qrb[tt + o[k]] = rho * v[k];
        }
    }
}

// ------------------------------------------------------------ the plan

// A GEMM stage's launch shape and where its plan lies
struct StackStage {
    int q;               // 1: 64 x 64 tiles, 2: 128 x 128
    int splits;          // K's bands (64 x 64 tiles alone)
    int tiles, tiles0;   // its tiles, and side 0's
    int sums;            // its sums' blocks when split
    int tiles_at, sums_at;
    size_t part;         // its partials' offset in the scratch (floats)
};

struct StackPlan {
    int bal_at, bal_blocks;
    StackStage g[K4_GEMMS];
    int leaves_at, level_at, levels;
    int launches;        // the kernels a call launches
    size_t ints, floats;
    size_t mx, qlb, qrb, linv, rinv, t1, w, a, bt, g1, g2, part;  // the scratch's slots (floats)
};

static bool valid_stack(int B, int S, int T, const int* m, const int* n) {
    if (B < 1 || S < 1 || T < 1 || S > K4_MAX_SIDE || T > K4_MAX_SIDE) return false;
    for (int i = 0; i < B; ++i)
        if (m[i] < 1 || m[i] > S || n[i] < 1 || n[i] > T) return false;
    return true;
}

// The plan of a stack on a card of `sms` SMs; its table (P.ints ints) into
// `tab` when given: m, n, the balance's blocks, each GEMM stage's tiles and
// sums, K3's leaves and level tiles, each a prefix sum over the layers or
// the 2B problems or factors.
static void stack_plan(int B, int S, int T, const int* m, const int* n, int sms, StackPlan& P,
                       int* tab) {
    size_t cur = 0;
    auto take = [&](size_t k) { const size_t o = cur; cur += k; return (int)o; };
    const int sides = take(2 * (size_t)B);
    // fill a prefix over `count` jobs of `size(j)` tasks at table offset `at`
    auto prefix = [&](int at, int count, auto size) {
        int sum = 0;
        for (int j = 0; j <= count; ++j) {
            if (tab) tab[at + j] = sum;
            if (j < count) sum += size(j);
        }
        return sum;
    };
    if (tab)
        for (int i = 0; i < B; ++i) { tab[sides + i] = m[i]; tab[sides + B + i] = n[i]; }
    P.bal_at = take((size_t)B + 1);
    P.bal_blocks = prefix(P.bal_at, B, [&](int i) {
        const long long e = (long long)m[i] * m[i] + (long long)n[i] * n[i];
        return (int)std::min(64LL, std::max(1LL, (e + 4095) / 4096));
    });
    auto dims = [&](int g, int p, int& M, int& N, int& K) {
        const int side = p >= B, i = side ? p - B : p;
        stack_dims(g, side, m[i], n[i], M, N, K);
    };
    for (int g = 0; g < K4_GEMMS; ++g) {
        StackStage& st = P.g[g];
        // the tiles that run a K loop (a triu Gram's upper ones), of each side
        long long t128[2] = {0, 0}, t64 = 0;
        int kmax = 0;
        for (int p = 0; p < 2 * B; ++p) {
            int M, N, K;
            dims(g, p, M, N, K);
            const long long tm = (M + 127) / 128, tn = (N + 127) / 128;
            t128[p >= B] += g == K4_C3 ? tm * (tm + 1) / 2 : tm * tn;
            t64 += (long long)((M + 63) / 64) * ((N + 63) / 64);
            kmax = std::max(kmax, K);
        }
        const bool two = stack_var(g, 0) != stack_var(g, 1);
        const long long per_launch = two ? std::min(t128[0], t128[1]) : t128[0] + t128[1];
        st.q = per_launch >= (long long)K4_BIG_TILES * sms ? 2 : 1;
        st.splits = 1;
        if (st.q == 1) {
            st.splits =
                std::min(KRON_MAX_SPLITS, std::max(1, (kmax + KRON_SPLIT_K - 1) / KRON_SPLIT_K));
            while (st.splits > 1 && t64 * st.splits > sms) --st.splits;
        }
        const int bm = 64 * st.q;
        auto tiles = [&](int p) {
            int M, N, K;
            dims(g, p, M, N, K);
            if (g == K4_D && st.splits == 1) M = N = p >= B ? T : S;  // the whole slot
            return ((M + bm - 1) / bm) * ((N + bm - 1) / bm);
        };
        st.tiles_at = take(2 * (size_t)B + 1);
        st.tiles = prefix(st.tiles_at, 2 * B, tiles);
        st.tiles0 = 0;
        for (int p = 0; p < B; ++p) st.tiles0 += tiles(p);
        st.sums_at = take(2 * (size_t)B + 1);
        st.sums = prefix(st.sums_at, 2 * B, [&](int p) {
            int M, N, K;
            dims(g, p, M, N, K);
            if (g == K4_D) M = N = p >= B ? T : S;
            return st.splits > 1 ? (int)(((long long)M * N + GEMM_THREADS - 1) / GEMM_THREADS) : 0;
        });
    }
    // K3: the 2B factors' leaves and each level's product tiles
    auto side_of = [&](int p) { return p < B ? m[p] : n[p - B]; };
    P.levels = 0;
    for (int p = 0; p < 2 * B; ++p)
        while (P.levels < PSGD_TRI_LEVELS && tri_level_tiles(side_of(p), P.levels)) ++P.levels;
    P.leaves_at = take(2 * (size_t)B + 1);
    prefix(P.leaves_at, 2 * B, [&](int p) { return (side_of(p) + TRI_LEAF - 1) / TRI_LEAF; });
    P.level_at = take((size_t)P.levels * (2 * B + 1));
    for (int l = 0; l < P.levels; ++l)
        prefix(P.level_at + l * (2 * B + 1), 2 * B, [&](int p) { return tri_level_tiles(side_of(p), l); });
    P.ints = cur;

    // the scratch: the max|grad| slots, then stacks of slots
    const size_t ss = (size_t)B * S * S, tt = (size_t)B * T * T, st = (size_t)B * S * T;
    size_t f = 0;
    auto slots = [&](size_t count) { const size_t o = f; f += psgd_align4(count); return o; };
    P.mx = slots(2 * (size_t)B);
    P.qlb = slots(ss); P.linv = slots(ss); P.g1 = slots(ss);
    P.qrb = slots(tt); P.rinv = slots(tt); P.g2 = slots(tt);
    P.t1 = slots(st); P.w = slots(st); P.a = slots(st); P.bt = slots(st);
    P.part = f;
    P.launches = 2;  // balance and K3
    for (int g = 0; g < K4_GEMMS; ++g) {
        StackStage& s = P.g[g];
        s.part = f - P.part;
        if (s.splits > 1) f += psgd_align4((size_t)s.splits * (g <= K4_C2 ? 2 * st : ss + tt));
        P.launches += (s.q == 2 && stack_var(g, 0) != stack_var(g, 1) ? 2 : 1) + (s.splits > 1);
    }
    P.floats = f;
}

// ------------------------------------------------------------ the launches

template <int G, int Q, int SIDE, bool PART>
static void stack_gemm_launch(const StackArgs& A, const StackLaunch& L, int tiles,
                              cudaStream_t stream) {
    constexpr size_t smem = GemmTile<Q, Q>::SMEM;
    auto kernel = stack_gemm_kernel<G, Q, SIDE, PART>;
    static unsigned long long raised = 0;  // a bit per device: the ring past 48 KB
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return;
    if (smem > 48 * 1024 && (dev >= 64 || !(raised >> dev & 1))) {
        if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
            cudaSuccess)
            return;
        if (dev < 64) raised |= 1ULL << dev;
    }
    kernel<<<dim3(tiles, L.splits), GEMM_THREADS, smem, stream>>>(A, L);
}

// One GEMM stage: its tiles in one launch, or one an operand orientation
// (128 x 128 tiles on a stage of two), then the sums' launch when K is split
template <int G, int Q, bool PART>
static void stack_stage_q(const StackArgs& A, const StackStage& st, cudaStream_t stream) {
    StackLaunch L = {st.tiles_at, st.sums_at, 0, 2 * A.B, 0, st.splits, st.part};
    if constexpr (Q == 2 && stack_var(G, 0) != stack_var(G, 1)) {
        L.hi = A.B;
        stack_gemm_launch<G, 2, 0, PART>(A, L, st.tiles0, stream);
        L.lo = A.B;
        L.hi = 2 * A.B;
        L.t0 = st.tiles0;
        stack_gemm_launch<G, 2, 1, PART>(A, L, st.tiles - st.tiles0, stream);
    } else {
        stack_gemm_launch<G, Q, -1, PART>(A, L, st.tiles, stream);
        if constexpr (PART) stack_sum_kernel<G><<<st.sums, GEMM_THREADS, 0, stream>>>(A, L);
    }
}

template <int G>
static void stack_stage(const StackArgs& A, const StackPlan& P, cudaStream_t stream) {
    const StackStage& st = P.g[G];
    if (st.q == 2) stack_stage_q<G, 2, false>(A, st, stream);
    else if (st.splits > 1) stack_stage_q<G, 1, true>(A, st, stream);
    else stack_stage_q<G, 1, false>(A, st, stream);
}

// The plan of a stack on the current card: sizes[0] its table's ints,
// sizes[1] the scratch's floats, sizes[2] the kernels a call launches; the
// table into `table` when given (the wrapper keeps it on the card, one
// copy a bucket).
extern "C" int psgd_kron_batched_plan(int B, int S, int T, const int* m, const int* n, int* table,
                                      size_t* sizes) {
    if (!valid_stack(B, S, T, m, n)) return (int)cudaErrorInvalidValue;
    StackPlan P;
    stack_plan(B, S, T, m, n, gemm_sms(), P, table);
    sizes[0] = P.ints;
    sizes[1] = P.floats;
    sizes[2] = (size_t)P.launches;
    return 0;
}

// K4: the stacks ql (B, S, S), qr (B, T, T), dx, dg (B, S, T) to out_ql and
// out_qr (fresh stacks; the inputs are not written), `table` the plan's
// table on the card (psgd_kron_batched_plan of the same sizes), `scratch`
// its floats.
extern "C" int psgd_kron_dd_batched_update(int B, int S, int T, const void* ql, const void* qr,
                                           const void* dx, const void* dg, void* out_ql,
                                           void* out_qr, const int* m, const int* n,
                                           const void* table, float step, void* scratch,
                                           void* stream_ptr) {
    if (!valid_stack(B, S, T, m, n)) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    StackPlan P;
    stack_plan(B, S, T, m, n, gemm_sms(), P, nullptr);
    std::vector<int> host(P.ints);
    stack_plan(B, S, T, m, n, gemm_sms(), P, host.data());
    float* f = static_cast<float*>(scratch);
    auto F = [](const void* p) { return static_cast<const float*>(p); };
    StackArgs A = {F(ql), F(qr), F(dx), F(dg), static_cast<float*>(out_ql),
                   static_cast<float*>(out_qr), f + P.qlb, f + P.qrb, f + P.linv, f + P.rinv,
                   f + P.t1, f + P.w, f + P.a, f + P.bt, f + P.g1, f + P.g2, f + P.part,
                   reinterpret_cast<unsigned int*>(f + P.mx), static_cast<const int*>(table),
                   B, S, T, step};
    stack_balance_kernel<<<P.bal_blocks, 256, 0, stream>>>(A, P.bal_at);
    // K3 on the 2B balanced factors: the device's table and the host's copy
    TriStack dev = {{A.qlb, A.qrb}, {A.linv, A.rinv}, {(size_t)S * S, (size_t)T * T}, {S, T},
                    A.tab, A.tab + P.leaves_at, A.tab + P.level_at, P.levels, B};
    TriStack hst = dev;
    hst.sides = host.data();
    hst.leaves = host.data() + P.leaves_at;
    hst.level = host.data() + P.level_at;
    launch_tri_stack(dev, hst, stream);
    stack_stage<K4_C1>(A, P, stream);
    stack_stage<K4_C2>(A, P, stream);
    stack_stage<K4_C3>(A, P, stream);
    stack_stage<K4_D>(A, P, stream);
    return (int)cudaGetLastError();
}
