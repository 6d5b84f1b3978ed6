// Shared declarations of the Hopper kernels (built by ops/hopper/_build.py).
//
// Every kernel takes its per-problem descriptors BY VALUE as a kernel
// parameter (a few KB, under the classic 4 KB limit; K1's one-launch plan
// ~30 KB, under the 32,764 bytes CUDA 12.1 allows), so a grouped launch
// needs no host-to-device copy of pointers and no synchronisation.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>

// Most layers one kron_dd chain takes; K1's Python wrapper splits longer
// lists, K4's C entry point longer stacks.
#define PSGD_MAX_LAYERS 16
// Most triangular factors one tri launch inverts (two per layer).
#define PSGD_MAX_TRI (2 * PSGD_MAX_LAYERS)
// Most problems of one grouped GEMM launch (two per layer).
#define PSGD_MAX_GEMMS (2 * PSGD_MAX_LAYERS)

// Most levels of K3's recursive inverse: factors of up to 32 << 16 rows.
#define PSGD_TRI_LEVELS 16

struct TriBatch {
    const float* u[PSGD_MAX_TRI];  // (n, n) upper triangular, row-major
    float* x[PSGD_MAX_TRI];        // (n, n) out: u^{-1}, lower part zero
    int n[PSGD_MAX_TRI];
    int tiles[PSGD_MAX_TRI + 1];   // prefix sums of the 32-row leaves, ceil(n / 32)
    // prefix sums over the factors of each level's 32 x 32 product tiles
    int level_tiles[PSGD_TRI_LEVELS][PSGD_MAX_TRI + 1];
    int levels;                    // the most levels of any factor
    int count;
};

// Fill the plan of `b` (tiles, level_tiles, levels) from u, x, n and count
// (tri.cu); nothing is launched.
void plan_tri_inv(TriBatch& b);
// Launch the exact inverse of every factor of `b` on `stream` (tri.cu).
// The caller fills u, x, n and count; this fills the plan.
void launch_tri_inv(TriBatch& b, cudaStream_t stream);

// The grouped fp32 GEMM of kron_dd.cu:
//   C (M x N) = op(a) op(b) [- op(a2) op(b2)],  op(X) = X or X^T by flag.
// op(a) is M x K: a[i*lda + k], or a[k*lda + i] when ta. op(b) is K x N:
// b[k*ldb + j], or b[j*ldb + k] when tb. a2/b2 share the flags and strides.
// The epilogue then stores C as is, masks it to its upper triangle and
// folds max|C| into *mx, rewrites q - s C with s read from *mx, scales
// column j of C by v[j] (multiply or divide), masks C to its upper
// triangle alone, or applies an arrow factor's rows with row M-1 of C
// taken as zero: q0_i C_i + q1_i v (EPI_ARROW, r = [q0; q1], (2, M)) or
// C_i / q0_i (EPI_ROWDIV, r = q0). Both triu epilogues skip the K loop of
// a tile wholly below the diagonal and store its zeros.
// Two flags may be OR-ed into an epilogue (K10's chain): EPI_UPPER runs the
// tiles of a square output's upper triangle alone (the rest is never
// written), EPI_COLSQ also stores each row tile's column sums of the
// stored C^2 after C, at c + M N + (row0 / BM) N (splits == 1). A batch
// with either flag takes a kernel of its own, in 64 x 64 tiles.
enum Epilogue {
    EPI_STORE = 0, EPI_TRIU_MAX = 1, EPI_UPDATE = 2, EPI_COLMUL = 3, EPI_COLDIV = 4, EPI_TRIU = 5,
    EPI_ARROW = 6, EPI_ROWDIV = 7, EPI_BASE = 15, EPI_COLSQ = 16, EPI_UPPER = 32
};
// A triangular operand: its zeros are not summed, each tile's K loop is cut
// to the band where both operands may be nonzero. The zeros must be exact.
enum Cut { CUT_A_UPPER = 1, CUT_A_LOWER = 2, CUT_B_UPPER = 4, CUT_B_LOWER = 8 };

struct GemmProb {
    const float* a;
    const float* b;
    const float* a2;     // nullptr: no second product
    const float* b2;
    float* c;            // ldc == N
    const float* q;      // EPI_UPDATE: the factor being updated, (M, N)
    const float* v;      // EPI_COLMUL / EPI_COLDIV: (N,) column scales; EPI_ARROW: (N,)
    const float* r;      // EPI_ARROW / EPI_ROWDIV: the row scales
    unsigned int* mx;    // EPI_TRIU_MAX writes, EPI_UPDATE reads max|grad|
    float step;
    int M, N, K, lda, ldb, ta, tb, epi, cut;
};

struct GemmBatch {
    GemmProb p[PSGD_MAX_GEMMS];
    int tiles[PSGD_MAX_GEMMS + 1];
    int count;
};
static_assert(sizeof(GemmBatch) <= 4096, "a GemmBatch is passed by value as a kernel parameter");

// A problem with the EPI_STORE epilogue, no cut and no second product.
GemmProb gemm_prob(const float* a, int ta, int lda, const float* b, int tb, int ldb,
                   float* c, int M, int N, int K);
// Launch every problem of `g` in one grid on `stream` (kron_dd.cu); fills
// g.tiles. Nothing is launched when g.count == 0. With splits > 1 each
// problem's K is cut into `splits` bands of whole GEMM_BK steps, and band y
// is written to c + y M N (EPI_STORE and EPI_TRIU only): the caller sums
// the partials in band order. tile: 0 the launch's own choice, 1 the
// 64 x 64 tiles, 2 the 128 x 128.
void launch_gemms(GemmBatch& g, cudaStream_t stream, int splits = 1, int tile = 0);
// The SMs of the current card, asked once (kron_dd.cu).
int gemm_sms();

// The fp32 smallest subnormal, 2^-149: needs denormals kept (no fast-math).
__device__ __forceinline__ float psgd_tiny() { return __int_as_float(1); }

// Scratch carving: floats rounded up to a multiple of 4 (16-byte alignment).
__host__ __device__ static inline size_t psgd_align4(size_t x) { return (x + 3) & ~(size_t)3; }
