// The grouped GEMM's tile: one (64 QM) x (64 QN) output tile's K loop,
// shared by kron_dd.cu's GEMM kernels and by the one-launch kernels that
// remake its partial tiles between barriers (rank_space.cuh's gram_tile),
// so that both give the same bits from one body.
//
// One (64 QM) x (64 QN) output tile a block: 128 x 128 (QM = QN = 2) for
// the launches with tiles enough to fill the card, else 64 x 64. 256
// threads on a 16 x 16 grid, thread (tx, ty) summing QM x QN quadrants of
// 4 x 4 outputs, rows q 64 + 4 ty + (0..3) and columns q 64 + 4 tx + (0..3),
// so that its reads are float4 and a warp's fall on distinct banks. Both
// operands are stored k-major in shared memory (As[k][i], Bs[k][j]) and
// reach it by cp.async, GEMM_BK deep, in a ring of GEMM_STAGES stages: an
// operand whose memory runs along the tile's rows or columns (op(a) with
// ta, op(b) without tb) by 16-byte copies where its stride and base allow,
// the other transposed on its way in by 4-byte copies (consecutive threads
// on its contiguous k); elements past the ragged edges are zero-filled
// (src-size 0), so the FMA loop tests no bound. Each output is one FMA
// chain over k, rising, the second product after the first with b negated
// in the FMA: the old 64 x 64 kernel's chain, so the outputs are its own.

#pragma once

#include "psgd.cuh"

#include <cstdint>

#define GEMM_BK 16       // K depth of a pipeline stage
#define GEMM_THREADS 256
#define GEMM_STAGES 3

template <int QM, int QN>
struct GemmTile {
    static constexpr int BM = 64 * QM, BN = 64 * QN;
    static constexpr int SIDE_A = GEMM_BK * (BM + 4), SIDE_B = GEMM_BK * (BN + 4);
    static constexpr int STAGE = SIDE_A + SIDE_B;   // floats of one stage
    static constexpr size_t SMEM = sizeof(float) * GEMM_STAGES * STAGE;
};

__device__ __forceinline__ void gemm_cp4(float* dst, const float* src, bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 4 : 0));
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void gemm_cp16(float* dst, const float* src, int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

// One operand's (GEMM_BK x R) slab of a stage into s[k][i], rows R + 4
// apart: MAJ, x[k ld + i] (16-byte copies when vec, else 4-byte); else
// x[i ld + k], transposed. Rows past `rows` and k past k_hi are zeros.
template <int R, bool MAJ>
__device__ __forceinline__ void gemm_load(float* s, const float* x, int ld, bool vec, int i0,
                                          int rows, int k0, int k_hi) {
    constexpr int LD = R + 4;
    if (MAJ && vec) {
#pragma unroll
        for (int q = 0; q < R * GEMM_BK / 4 / GEMM_THREADS; ++q) {
            const int c = threadIdx.x + q * GEMM_THREADS;
            const int k = c / (R / 4), i = (c % (R / 4)) * 4, gk = k0 + k, gi = i0 + i;
            const int valid = gk < k_hi ? max(0, min(4, rows - gi)) : 0;
            gemm_cp16(s + k * LD + i, valid ? x + (size_t)gk * ld + gi : x, 4 * valid);
        }
        return;
    }
#pragma unroll
    for (int q = 0; q < R * GEMM_BK / GEMM_THREADS; ++q) {
        const int e = threadIdx.x + q * GEMM_THREADS;
        // consecutive threads on the contiguous dimension of memory
        const int k = MAJ ? e / R : e % GEMM_BK, i = MAJ ? e % R : e / GEMM_BK;
        const int gk = k0 + k, gi = i0 + i;
        const bool ok = gk < k_hi && gi < rows;
        gemm_cp4(s + k * LD + i, ok ? x + (MAJ ? (size_t)gk * ld + gi : (size_t)gi * ld + gk) : x,
                 ok);
    }
}

// 16-byte copies: the stride and the base keep every chunk 16-byte aligned
__device__ __forceinline__ bool gemm_vec(const float* x, int ld) {
    return ld % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

// the FMAs of one stage: acc (+/-)= As^T Bs over its GEMM_BK k
template <int QM, int QN, bool NEG>
__device__ __forceinline__ void gemm_stage(const float* As, const float* Bs, int tx, int ty,
                                           float (&acc)[4 * QM][4 * QN]) {
    constexpr int LDA = 64 * QM + 4, LDB = 64 * QN + 4;
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; ++kk) {
        float a[4 * QM], b[4 * QN];
#pragma unroll
        for (int q = 0; q < QM; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(As + kk * LDA + q * 64 + ty * 4);
            a[4 * q] = v.x;
            a[4 * q + 1] = v.y;
            a[4 * q + 2] = v.z;
            a[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < QN; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(Bs + kk * LDB + q * 64 + tx * 4);
            b[4 * q] = v.x;
            b[4 * q + 1] = v.y;
            b[4 * q + 2] = v.z;
            b[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 4 * QM; ++i)
#pragma unroll
            for (int j = 0; j < 4 * QN; ++j)
                acc[i][j] = __fmaf_rn(a[i], NEG ? -b[j] : b[j], acc[i][j]);
    }
}

// The K loop of one tile: acc += op(a) op(b) over [k_lo, k_hi), then
// acc -= op(a2) op(b2) over the same band when a2 is set.
template <int QM, int QN, int TA, int TB>
__device__ __forceinline__ void gemm_tile(const GemmProb& P, int row0, int col0, int k_lo,
                                          int k_hi, float* sm, float (&acc)[4 * QM][4 * QN]) {
    using T = GemmTile<QM, QN>;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int steps = k_hi > k_lo ? (k_hi - k_lo + GEMM_BK - 1) / GEMM_BK : 0;
    const int total = P.a2 ? 2 * steps : steps;
    const bool va = gemm_vec(P.a, P.lda) && (!P.a2 || gemm_vec(P.a2, P.lda));
    const bool vb = gemm_vec(P.b, P.ldb) && (!P.b2 || gemm_vec(P.b2, P.ldb));
    auto load = [&](int t) {
        const int pass = t >= steps, k0 = k_lo + (t - pass * steps) * GEMM_BK;
        float* st = sm + (t % GEMM_STAGES) * T::STAGE;
        gemm_load<T::BM, TA == 1>(st, pass ? P.a2 : P.a, P.lda, va, row0, P.M, k0, k_hi);
        gemm_load<T::BN, TB == 0>(st + T::SIDE_A, pass ? P.b2 : P.b, P.ldb, vb, col0, P.N, k0, k_hi);
    };
#pragma unroll
    for (int s = 0; s < GEMM_STAGES - 1; ++s) {
        if (s < total) load(s);
        asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int t = 0; t < total; ++t) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(GEMM_STAGES - 2));
        // step t has landed, and every thread is done with step t - 1's stage
        __syncthreads();
        if (t + GEMM_STAGES - 1 < total) load(t + GEMM_STAGES - 1);
        asm volatile("cp.async.commit_group;\n" ::);
        const float* As = sm + (t % GEMM_STAGES) * T::STAGE;
        if (t < steps) gemm_stage<QM, QN, false>(As, As + T::SIDE_A, tx, ty, acc);
        else gemm_stage<QM, QN, true>(As, As + T::SIDE_A, tx, ty, acc);
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
}
