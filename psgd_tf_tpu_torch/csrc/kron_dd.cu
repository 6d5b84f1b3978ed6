// K1/K2/K5: the Kronecker factor update for a list of layers of mixed kinds;
// K4, the stacked (dense, dense) bucket, is the same chain over the stack
// (its entry point at the end of this file).
//
// Replaces psgd_tf_tpu/ops/pallas/kron_multi.py `fused_update_multi` (:222,
// its pallas_call at :202, kinds dd/ds/nd/ns), psgd_tf_tpu/ops/pallas/
// kron_dd.py `fused_update` (:181, the single-layer kernel at :210) and
// psgd_tf_tpu/ops/pallas/kron_sparse.py `fused_update_ns/ds/nd` (:311/:329/
// :345, the single-layer kernel at :297): a lone layer is the L = 1 case of
// the same chain. Kinds (the left factor first; mirrors arrive transposed):
//   dd  dense (m, m)    x dense (n, n)
//   ds  dense (m, m)    x scale (n,)
//   nd  arrow (2, m)    x dense (n, n)
//   ns  arrow (2, m)    x scale (n,)
// An arrow factor is diag(q0) with last column [q1[:-1]; q0[-1]], q1[-1] = 0.
// Per layer, with balanced factors (rho = sqrt(max diag Ql / max diag Qr),
// Ql <- Ql / rho, Qr <- rho Qr, an arrow's two rows and a scale vector
// scaled likewise):
//   A  = Ql dG Qr^T,  Bt = Ql^{-T} dX Qr^{-1}
//   dense side:  grad = triu(A A^T - Bt Bt^T) (left) or triu(A^T A - Bt^T Bt)
//                (right), Q' = Q - s grad Q
//   scale side:  grad2 = colsum(A*A - Bt*Bt), q' = q - s grad2 q
//   arrow side:  diag = rowsum(A*A - Bt*Bt), bias_i = A_i.A_last - Bt_i.Bt_last
//                (0 on the last row), q0' = q0 - s diag q0,
//                q1' = q1 - s (diag q1 + q0_last bias)
//   s = min(step / (max|grad| + tiny), FLT_MAX), the arrow's max over both
//   diag and bias. The arrow inverse is closed form: Bt's rows are
//   dX_i / q0_i, the last row corrected by corr = sum_i w_i dX_i,
//   w_i = q1_i / (q0_i q0_last).
//
// The TPU kernel keeps every layer resident in VMEM and does all of this in
// one launch. Hopper cannot: one 257x257 fp32 factor (LeNet5's largest) is
// 264 KB, more than a block's 227 KB of shared memory. So the update is a
// short FIXED chain of grouped launches, each covering every layer of the
// list, with no host synchronisation between them (a stage with nothing
// to do for the list is not launched):
//   (a) balance_kernel   rho on the device, balanced copies to scratch,
//                        the two max|grad| slots of each layer zeroed;
//   (b) tri.cu           exact inverses of EVERY dense factor of every
//                        layer in one K3 launch pair;
//   (c0) arrow_kernel    nd/ns: the arrow products Ql dG and Ql^{-T} dX
//                        (ns: scaled by the right factor, i.e. A and Bt);
//   (c1, c2) gemm_kernel a hand-written grouped fp32 tiled GEMM over
//                        per-problem descriptors: A and Bt of dd (two
//                        stages), ds (column-scale epilogue) and nd; each
//                        K loop cut to its triangular operand's band;
//   (c3) gemm_kernel     the dense sides' triu Grams, each as ONE product
//                        over the concatenated [A | Bt] (the Bt half
//                        subtracted), with max|grad| by block reduction plus
//                        atomicMax on the float bits (a max does not depend
//                        on order, so the result is deterministic);
//   (s) stats_kernel     the scale sides' column sums and the arrow sides'
//                        row sums (diag, bias), with their max|grad|;
//   (d) gemm_kernel      the dense sides' Q' = Q - s grad Q, s on the device;
//   (v) vec_kernel       the arrow and scale sides' rewrites.
// No product goes to cuBLAS.
//
// What bounds it on this card: latency, not FLOPs or bytes. LeNet5's five
// layers need 164 MFLOP per step in all and a few MB of traffic, the toy
// NMT list less, yet each stage is only a few dozen 64x64 tiles or rows.
// Grouping every layer into each launch keeps the launch count fixed as
// layers are added.
//
// The grouped GEMM (gemm_kernel, below) also carries K9's, K10's and K17
// nd's products in kron_sparse_big.cu, and the lra and splu Grams past
// rank 32 (rank_space.cuh), where FLOPs bound it: fp32 FMA on
// the SIMT units (TF32 stays off), 128 x 128 tiles of 8 x 8 outputs a
// thread for the launches that fill the card (one kernel per operand
// orientation: 128 registers, two blocks an SM), 64 x 64 for the small
// ones, a 3-stage cp.async ring, and K split over the grid's y for a long
// K. Measured on an H100 80GB HBM3 at its 700 W limit (tools/kron_gemm_ab.py
// --gemm): 36.1 TFLOP/s on a dense (131072 x 512) x (512 x 512)
// product, 54% of the 67 TFLOP/s fp32 peak, where cuBLAS's fp32 product of
// the same shape ran 48.4-48.5; 33.0-33.1 TFLOP/s on K9's split triu Gram
// difference. In probes made while tuning it (not kept), removing the
// copies or the FMAs cut the time by about the removed part's own share:
// the cp.async copies and the float4 shared-memory reads contend in the
// SM's memory pipeline instead of overlapping. One kernel holding all four
// orientations took 235 registers (one block an SM, 29.7 TFLOP/s); deeper
// rings, other K depths, copies spread over the FMAs and 192- or 256-row
// tiles (255 registers: spills) did no better. Copies by the Tensor Memory
// Accelerator, off that pipeline, are the next step. The LeNet5 list's
// chain ran 0.16-0.17 ms against 0.30 with the old 64 x 64 GEMM
// (tools/kron_gemm_ab.py against the parent tree).
//
// One difference from the Pallas kernels: they divide step / (max + tiny)
// WITHOUT the saturation of linalg.step_scale, so a zero probe gives
// inf * 0 = NaN there. This chain saturates at FLT_MAX, as the XLA path and
// the port's plain versions do, so a zero group gradient gives a zero update.
#include "psgd.cuh"

#include <algorithm>
#include <cfloat>
#include <cstdint>

#define GEMM_BK 16       // K depth of a pipeline stage
#define GEMM_THREADS 256

enum Kind { KIND_DD = 0, KIND_DS = 1, KIND_ND = 2, KIND_NS = 3 };
static inline bool left_arrow(int k) { return k == KIND_ND || k == KIND_NS; }
static inline bool right_scale(int k) { return k == KIND_DS || k == KIND_NS; }

struct BalanceLayer {
    const float* ql;   // dense: (m, m) at row stride ldl; arrow: (2, m), ldl = m
    const float* qr;   // dense: (n, n) at row stride ldr; scale: (n,), ldr = n
    float* qlb;        // the balanced copies, tight
    float* qrb;
    unsigned int* mx;  // two max|grad| slots, zeroed here
    int m, n, arrow, scale, ldl, ldr;
};

struct BalanceBatch {
    BalanceLayer l[PSGD_MAX_LAYERS];
    int count;
};

// (c0): the arrow pre-pass of one layer, 32 columns per block
#define ARROW_WARPS 8
static_assert(ARROW_WARPS * 32 == 256, "arrow_kernel runs in launch_jobs' 256-thread blocks");
struct ArrowJob {
    const float* qlb;  // (2, m) balanced arrow
    const float* qrb;  // (n,) balanced scale, or nullptr (nd)
    const float* dx;
    const float* dg;
    float* pa;         // Ql dG [* qr]
    float* pb;         // Ql^{-T} dX [/ qr]
    int m, n;
};

// (s): rows = 1: one warp per row, diag and bias; rows = 0: one thread per
// column, the column sums of A*A - Bt*Bt
struct StatJob {
    const float* a;
    const float* bt;
    float* out0;       // diag (rows) or grad2 (columns)
    float* out1;       // bias (rows)
    unsigned int* mx;
    int m, n, rows;
};

// (v): arrow = 1: q (2, m) <- arrow rewrite from g0 = diag, g1 = bias;
// arrow = 0: q (len,) <- q - s g0 q
struct VecJob {
    const float* q;
    const float* g0;
    const float* g1;
    const unsigned int* mx;
    float* out;
    int len, arrow;
};

template <class Job>
struct JobBatch {
    Job j[2 * PSGD_MAX_LAYERS];
    int blocks[2 * PSGD_MAX_LAYERS + 1];
    int count;
};

__device__ __forceinline__ int find_job(const int* prefix, int count, int t) {
    int p = 0;
    while (p + 1 < count && t >= prefix[p + 1]) ++p;
    return p;
}

__device__ __forceinline__ float step_scale(float step, const unsigned int* mx) {
    return fminf(step / (__uint_as_float(*mx) + psgd_tiny()), FLT_MAX);
}

__device__ __forceinline__ float block_reduce_max(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = -INFINITY;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v = fmaxf(v, red[w]);
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Element e of a tight (rows, w) copy, read from rows of stride ld.
__device__ __forceinline__ float strided(const float* q, size_t e, int w, int ld) {
    return ld == w ? q[e] : q[(e / w) * ld + e % w];
}

// grid (blocks per layer, layers); every block recomputes its layer's
// diagonal maxima (m + n loads) and scales its share of both factors.
__global__ void __launch_bounds__(256) balance_kernel(const BalanceBatch b) {
    const BalanceLayer L = b.l[blockIdx.y];
    __shared__ float red[8];
    float ml = -INFINITY, mr = -INFINITY;
    for (int i = threadIdx.x; i < L.m; i += blockDim.x)
        ml = fmaxf(ml, L.arrow ? L.ql[i] : L.ql[(size_t)i * L.ldl + i]);
    for (int i = threadIdx.x; i < L.n; i += blockDim.x)
        mr = fmaxf(mr, L.scale ? L.qr[i] : L.qr[(size_t)i * L.ldr + i]);
    ml = block_reduce_max(ml, red);
    mr = block_reduce_max(mr, red);
    const float rho = sqrtf(ml / mr);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        L.mx[0] = 0u;
        L.mx[1] = 0u;
    }
    const size_t nl = L.arrow ? 2 * (size_t)L.m : (size_t)L.m * L.m;
    const size_t total = nl + (L.scale ? (size_t)L.n : (size_t)L.n * L.n);
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += (size_t)gridDim.x * blockDim.x) {
        if (e < nl) L.qlb[e] = strided(L.ql, e, L.m, L.ldl) / rho;
        else L.qrb[e - nl] = rho * strided(L.qr, e - nl, L.n, L.ldr);
    }
}

// One block per 32-column tile: lane = column, warp = row group. Each warp
// walks rows warp, warp + 8, ... (a warp's loads are one 128-byte row
// segment), and the block sums its warps' corr partials for the last row,
// so the serial chain per thread is m / 8 rows, not m.
__global__ void __launch_bounds__(256) arrow_kernel(const JobBatch<ArrowJob> b) {
    const int p = find_job(b.blocks, b.count, blockIdx.x);
    const ArrowJob J = b.j[p];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j = (blockIdx.x - b.blocks[p]) * 32 + lane;
    const int m = J.m, n = J.n;
    const float* q0 = J.qlb;
    const float* q1 = J.qlb + m;
    const float q0_last = q0[m - 1];
    __shared__ float red[ARROW_WARPS][32];
    float corr = 0.f, s = 1.f;
    if (j < n) {
        const float g_last = J.dg[(size_t)(m - 1) * n + j];
        if (J.qrb) s = J.qrb[j];
        for (int i = warp; i < m; i += ARROW_WARPS) {
            const size_t o = (size_t)i * n + j;
            const float x = J.dx[o];
            float a = q0[i] * J.dg[o] + q1[i] * g_last;
            corr += (q1[i] / (q0[i] * q0_last)) * x;
            if (J.qrb) a *= s;
            J.pa[o] = a;
            if (i < m - 1) J.pb[o] = J.qrb ? x / q0[i] / s : x / q0[i];
        }
    }
    red[warp][lane] = corr;
    __syncthreads();
    if (warp == 0 && j < n) {
        for (int w = 1; w < ARROW_WARPS; ++w) corr += red[w][lane];
        const size_t o = (size_t)(m - 1) * n + j;
        const float last = J.dx[o] / q0_last - corr;
        J.pb[o] = J.qrb ? last / s : last;
    }
}

__global__ void __launch_bounds__(256) stats_kernel(const JobBatch<StatJob> b) {
    const int p = find_job(b.blocks, b.count, blockIdx.x);
    const StatJob J = b.j[p];
    const int t = blockIdx.x - b.blocks[p];
    __shared__ float red[8];
    float local = 0.f;
    if (J.rows) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        const int i = t * 8 + warp;
        if (i < J.m) {
            const float* ar = J.a + (size_t)i * J.n;
            const float* br = J.bt + (size_t)i * J.n;
            const float* al = J.a + (size_t)(J.m - 1) * J.n;
            const float* bl = J.bt + (size_t)(J.m - 1) * J.n;
            float d = 0.f, s = 0.f;
            for (int j = lane; j < J.n; j += 32) {
                const float av = ar[j], bv = br[j];
                d += av * av - bv * bv;
                s += av * al[j] - bv * bl[j];
            }
            d = warp_sum(d);
            s = (i == J.m - 1) ? 0.f : warp_sum(s);
            if (lane == 0) {
                J.out0[i] = d;
                J.out1[i] = s;
            }
            local = fmaxf(fabsf(d), fabsf(s));
        }
    } else {
        const int j = t * blockDim.x + threadIdx.x;
        if (j < J.n) {
            float s = 0.f;
            for (int i = 0; i < J.m; ++i) {
                const float av = J.a[(size_t)i * J.n + j], bv = J.bt[(size_t)i * J.n + j];
                s += av * av - bv * bv;
            }
            J.out0[j] = s;
            local = fabsf(s);
        }
    }
    // |grad| >= 0, so its float bits order like unsigned integers
    local = block_reduce_max(local, red);
    if (threadIdx.x == 0) atomicMax(J.mx, __float_as_uint(local));
}

__global__ void __launch_bounds__(256) vec_kernel(const JobBatch<VecJob> b, float step) {
    const int p = find_job(b.blocks, b.count, blockIdx.x);
    const VecJob J = b.j[p];
    const int i = (blockIdx.x - b.blocks[p]) * blockDim.x + threadIdx.x;
    if (i >= J.len) return;
    const float s = step_scale(step, J.mx);
    if (J.arrow) {
        const float q0 = J.q[i], q1 = J.q[J.len + i], d = J.g0[i];
        J.out[i] = q0 - s * d * q0;
        J.out[J.len + i] = q1 - s * (d * q1 + J.q[J.len - 1] * J.g1[i]);
    } else {
        J.out[i] = J.q[i] - s * J.g0[i] * J.q[i];
    }
}

// ------------------------------------------------------- the grouped GEMM
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

// grid (tiles of every problem, splits). With splits > 1, block y sums
// k in [y kc, (y + 1) kc), kc = K / splits rounded up to GEMM_BK, into
// c + y M N (EPI_STORE and EPI_TRIU alone; a caller sums the partials).
// MINB: the blocks an SM holds; VAR >= 0: the kernel holds the one operand
// orientation (ta, tb) = (VAR >> 1, VAR & 1) of every problem it is given.
template <int QM, int QN, int MINB, int VAR = -1>
__global__ void __launch_bounds__(GEMM_THREADS, MINB) gemm_kernel(const GemmBatch g) {
    using T = GemmTile<QM, QN>;
    extern __shared__ __align__(16) float gsm[];
    __shared__ float red[GEMM_THREADS / 32];
    const int p = find_job(g.tiles, g.count, blockIdx.x);
    // a copy: the fields the loops read stay in registers, not re-read from
    // the dynamically indexed parameter array
    const GemmProb P = g.p[p];
    const int t = blockIdx.x - g.tiles[p];
    const int tiles_n = (P.N + T::BN - 1) / T::BN;
    const int row0 = (t / tiles_n) * T::BM, col0 = (t % tiles_n) * T::BN;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

    float acc[4 * QM][4 * QN];
#pragma unroll
    for (int i = 0; i < 4 * QM; ++i)
#pragma unroll
        for (int j = 0; j < 4 * QN; ++j) acc[i][j] = 0.f;
    // a tile wholly below the diagonal of a triu output is zero: skip the K loop
    const bool triu = P.epi == EPI_TRIU_MAX || P.epi == EPI_TRIU;
    const bool skip = triu && row0 > col0 + T::BN - 1;
    // the band of k where a triangular operand may be nonzero for this tile
    int k_lo = 0, k_hi = P.K;
    if (gridDim.y > 1) {
        const int kc = ((P.K + gridDim.y - 1) / gridDim.y + GEMM_BK - 1) / GEMM_BK * GEMM_BK;
        k_lo = blockIdx.y * kc;
        k_hi = min(P.K, k_lo + kc);
    }
    if (P.cut & CUT_A_UPPER) k_lo = max(k_lo, row0);             // a_ik = 0 for k < i
    if (P.cut & CUT_A_LOWER) k_hi = min(k_hi, row0 + T::BM);     // a_ik = 0 for k > i
    if (P.cut & CUT_B_UPPER) k_hi = min(k_hi, col0 + T::BN);     // b_kj = 0 for k > j
    if (P.cut & CUT_B_LOWER) k_lo = max(k_lo, col0);             // b_kj = 0 for k < j
    if (!skip) {
        if (VAR >= 0) gemm_tile<QM, QN, (VAR >> 1) & 1, VAR & 1>(P, row0, col0, k_lo, k_hi, gsm, acc);
        else if (P.ta && P.tb) gemm_tile<QM, QN, 1, 1>(P, row0, col0, k_lo, k_hi, gsm, acc);
        else if (P.ta) gemm_tile<QM, QN, 1, 0>(P, row0, col0, k_lo, k_hi, gsm, acc);
        else if (P.tb) gemm_tile<QM, QN, 0, 1>(P, row0, col0, k_lo, k_hi, gsm, acc);
        else gemm_tile<QM, QN, 0, 0>(P, row0, col0, k_lo, k_hi, gsm, acc);
    }

    float* c = P.c + (size_t)blockIdx.y * P.M * P.N;
    const float s = P.epi == EPI_UPDATE ? step_scale(P.step, P.mx) : 0.f;
    float local_max = 0.f;
#pragma unroll
    for (int ii = 0; ii < 4 * QM; ++ii) {
        const int i = row0 + (ii / 4) * 64 + ty * 4 + ii % 4;
#pragma unroll
        for (int jj = 0; jj < 4 * QN; ++jj) {
            const int j = col0 + (jj / 4) * 64 + tx * 4 + jj % 4;
            if (i >= P.M || j >= P.N) continue;
            const size_t o = (size_t)i * P.N + j;
            float v = acc[ii][jj];
            if (triu) {
                v = (i <= j) ? v : 0.f;
                local_max = fmaxf(local_max, fabsf(v));
            } else if (P.epi == EPI_UPDATE) {
                v = P.q[o] - s * v;
            } else if (P.epi == EPI_COLMUL) {
                v = v * P.v[j];
            } else if (P.epi == EPI_COLDIV) {
                v = v / P.v[j];
            } else if (P.epi == EPI_ARROW) {
                v = (i == P.M - 1 ? 0.f : P.r[i] * v) + P.r[P.M + i] * P.v[j];
            } else if (P.epi == EPI_ROWDIV) {
                v = i == P.M - 1 ? 0.f : v / P.r[i];
            }
            c[o] = v;
        }
    }
    if (P.epi == EPI_TRIU_MAX) {
        // |grad| >= 0, so its float bits order like unsigned integers
        local_max = block_reduce_max(local_max, red);
        if (threadIdx.x == 0) atomicMax(P.mx, __float_as_uint(local_max));
    }
}

// the SMs of the current card, asked once
static int gemm_sms() {
    static int sms = 0;
    if (!sms) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms < 1) sms = 132;
    }
    return sms;
}

// The 128 x 128 tiles' ring needs more than the 48 KB of dynamic shared
// memory a kernel may take by default: raised once on each device. A refused
// raise launches nothing; the caller's cudaGetLastError() returns it.
template <int QM, int QN, int MINB, int VAR = -1>
static void gemm_launch_q(GemmBatch& g, int splits, cudaStream_t stream) {
    using T = GemmTile<QM, QN>;
    static unsigned long long raised = 0;  // a bit per device
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return;
    if (dev >= 64 || !(raised >> dev & 1)) {
        if (cudaFuncSetAttribute(gemm_kernel<QM, QN, MINB, VAR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)T::SMEM) != cudaSuccess)
            return;
        if (dev < 64) raised |= 1ULL << dev;
    }
    g.tiles[0] = 0;
    for (int p = 0; p < g.count; ++p) {
        const GemmProb& P = g.p[p];
        g.tiles[p + 1] = g.tiles[p] + ((P.M + T::BM - 1) / T::BM) * ((P.N + T::BN - 1) / T::BN);
    }
    gemm_kernel<QM, QN, MINB, VAR><<<dim3(g.tiles[g.count], splits), GEMM_THREADS, T::SMEM,
                                     stream>>>(g);
}

// q: 0 picks the tile (128 x 128 where the launch's tiles of that size,
// times the splits, give every SM at least four, two resident at a time;
// else 64 x 64, two an SM); 1 (64) or 2 (128) forces it
static void launch_gemms_q(GemmBatch& g, cudaStream_t stream, int splits, int q) {
    if (g.count == 0) return;
    if (q == 0) {
        long long big = 0;
        for (int p = 0; p < g.count; ++p)
            big += (long long)((g.p[p].M + 127) / 128) * ((g.p[p].N + 127) / 128);
        q = big * splits >= 4LL * gemm_sms() ? 2 : 1;
    }
    if (q == 2) {
        // one launch per operand orientation present: a kernel holding one
        // (ta, tb) takes 128 registers a thread and two blocks an SM, where
        // one holding all four takes 235 and one
        for (int var = 0; var < 4; ++var) {
            GemmBatch sub;
            sub.count = 0;
            for (int p = 0; p < g.count; ++p)
                if ((g.p[p].ta != 0) * 2 + (g.p[p].tb != 0) == var) sub.p[sub.count++] = g.p[p];
            if (sub.count == 0) continue;
            if (var == 0) gemm_launch_q<2, 2, 2, 0>(sub, splits, stream);
            else if (var == 1) gemm_launch_q<2, 2, 2, 1>(sub, splits, stream);
            else if (var == 2) gemm_launch_q<2, 2, 2, 2>(sub, splits, stream);
            else gemm_launch_q<2, 2, 2, 3>(sub, splits, stream);
        }
    }
    else gemm_launch_q<1, 1, 2>(g, splits, stream);
}

void launch_gemms(GemmBatch& g, cudaStream_t stream, int splits, int tile) {
    launch_gemms_q(g, stream, splits, tile);
}

// One problem through the grouped GEMM, for the card tests: its tile forced
// (q = 1: 64 x 64, 2: 128 x 128, 0: the launch's own choice) and K split
// over `splits` partial outputs
extern "C" int psgd_gemm_test(int M, int N, int K, const void* a, int ta, int lda, const void* b,
                              int tb, int ldb, const void* a2, const void* b2, void* c,
                              const void* q, const void* v, const void* r, void* mx, float step,
                              int epi, int cut, int qtile, int splits, void* stream_ptr) {
    if (M < 1 || N < 1 || K < 1 || splits < 1 || qtile < 0 || qtile > 2) return (int)cudaErrorInvalidValue;
    GemmBatch g;
    g.count = 1;
    auto f = [](const void* x) { return static_cast<const float*>(x); };
    GemmProb P = gemm_prob(f(a), ta, lda, f(b), tb, ldb, static_cast<float*>(c), M, N, K);
    P.a2 = f(a2);
    P.b2 = f(b2);
    P.q = f(q);
    P.v = f(v);
    P.r = f(r);
    P.mx = static_cast<unsigned int*>(mx);
    P.step = step;
    P.epi = epi;
    P.cut = cut;
    g.p[0] = P;
    launch_gemms_q(g, static_cast<cudaStream_t>(stream_ptr), splits, qtile);
    return (int)cudaGetLastError();
}

GemmProb gemm_prob(const float* a, int ta, int lda, const float* b, int tb, int ldb,
                   float* c, int M, int N, int K) {
    GemmProb P = {};
    P.a = a; P.b = b; P.c = c;
    P.ta = ta; P.tb = tb; P.lda = lda; P.ldb = ldb;
    P.M = M; P.N = N; P.K = K;
    P.epi = EPI_STORE;
    return P;
}

// Fill the prefix of block counts and launch, unless the batch is empty.
template <class Job, class Kernel, class... Args>
static void launch_jobs(Kernel kernel, JobBatch<Job>& b, const int* blocks,
                        cudaStream_t stream, Args... args) {
    if (b.count == 0) return;
    b.blocks[0] = 0;
    for (int p = 0; p < b.count; ++p) b.blocks[p + 1] = b.blocks[p] + blocks[p];
    kernel<<<b.blocks[b.count], 256, 0, stream>>>(b, args...);
}

// Per-layer scratch, as offsets in floats from the start of the scratch.
struct LayerScratch {
    size_t qlb, linv, g1, diag, bias;  // left: dense (m^2 each) or arrow (2m; m; m)
    size_t qrb, rinv, g2;              // right: dense (n^2 each) or scale (n each)
    size_t t1, w, pa, pb, a, bt;       // probes (m n each), as the kind needs
};

static size_t plan(int L, const int* kind, const int* m, const int* n, LayerScratch* s) {
    size_t cur = psgd_align4(2 * (size_t)L);  // the max|grad| slots
    auto take = [&](size_t count) { size_t o = cur; cur += psgd_align4(count); return o; };
    for (int l = 0; l < L; ++l) {
        const size_t mm = (size_t)m[l] * m[l], nn = (size_t)n[l] * n[l], mn = (size_t)m[l] * n[l];
        LayerScratch x = {};
        if (left_arrow(kind[l])) {
            x.qlb = take(2 * (size_t)m[l]); x.diag = take(m[l]); x.bias = take(m[l]);
        } else {
            x.qlb = take(mm); x.linv = take(mm); x.g1 = take(mm);
        }
        if (right_scale(kind[l])) {
            x.qrb = take(n[l]); x.g2 = take(n[l]);
        } else {
            x.qrb = take(nn); x.rinv = take(nn); x.g2 = take(nn);
        }
        x.a = take(mn); x.bt = take(mn);
        if (kind[l] == KIND_DD) { x.t1 = take(mn); x.w = take(mn); }
        if (kind[l] == KIND_ND) { x.pa = take(mn); x.pb = take(mn); }
        if (s) s[l] = x;
    }
    return cur;
}

static bool valid(int L, const int* kind, const int* m, const int* n) {
    if (L < 1 || L > PSGD_MAX_LAYERS) return false;
    for (int l = 0; l < L; ++l)
        if (kind[l] < KIND_DD || kind[l] > KIND_NS || m[l] < 1 || n[l] < 1) return false;
    return true;
}

extern "C" size_t psgd_kron_multi_scratch_floats(int L, const int* kind, const int* m, const int* n) {
    if (!valid(L, kind, m, n)) return 0;
    return plan(L, kind, m, n, nullptr);
}

// The chain on L layers. S = T = 0: every operand tight (K1, K2, K5).
// S, T > 0 (K4, kind dd only): layer l's factors are read as the (m, m) and
// (n, n) corners of (S, S) and (T, T) slots, its probes as the (m, n)
// corner of an (S, T) slot, at those row strides. The outputs are tight.
static int run_chain(int L, const int* kind, void** ql, void** qr, void** dx, void** dg,
                     void** out_ql, void** out_qr, const int* m, const int* n, int S, int T,
                     float step, void* scratch, cudaStream_t stream) {
    float* base = static_cast<float*>(scratch);
    unsigned int* mx = reinterpret_cast<unsigned int*>(base);
    LayerScratch off[PSGD_MAX_LAYERS];
    plan(L, kind, m, n, off);
    auto F = [&](size_t o) { return base + o; };
    // row strides: of the left factor, and of the right factor and the probes
    auto ldl = [&](int l) { return S ? S : m[l]; };
    auto ldr = [&](int l) { return T ? T : n[l]; };

    BalanceBatch bal;
    bal.count = L;
    TriBatch tri;
    tri.count = 0;
    int max_elems = 1;
    for (int l = 0; l < L; ++l) {
        const LayerScratch& s = off[l];
        const bool arrow = left_arrow(kind[l]), scale = right_scale(kind[l]);
        bal.l[l] = {static_cast<const float*>(ql[l]), static_cast<const float*>(qr[l]),
                    F(s.qlb), F(s.qrb), mx + 2 * l, m[l], n[l], arrow, scale, ldl(l), ldr(l)};
        if (!arrow) { tri.u[tri.count] = F(s.qlb); tri.x[tri.count] = F(s.linv); tri.n[tri.count++] = m[l]; }
        if (!scale) { tri.u[tri.count] = F(s.qrb); tri.x[tri.count] = F(s.rinv); tri.n[tri.count++] = n[l]; }
        max_elems = std::max(max_elems, (arrow ? 2 * m[l] : m[l] * m[l]) + (scale ? n[l] : n[l] * n[l]));
    }

    // (a) balance: enough blocks per layer for the largest factor pair
    const int bal_blocks = std::min(64, std::max(1, (max_elems + 4095) / 4096));
    balance_kernel<<<dim3(bal_blocks, L), 256, 0, stream>>>(bal);
    // (b) K3 on every dense factor of every layer
    if (tri.count) launch_tri_inv(tri, stream);

    // (c0) the arrow products of nd and ns layers
    JobBatch<ArrowJob> arrows;
    int blocks[2 * PSGD_MAX_LAYERS];
    arrows.count = 0;
    for (int l = 0; l < L; ++l) {
        if (!left_arrow(kind[l])) continue;
        const LayerScratch& s = off[l];
        const bool ns = kind[l] == KIND_NS;
        blocks[arrows.count] = (n[l] + 31) / 32;
        arrows.j[arrows.count++] = {F(s.qlb), ns ? F(s.qrb) : nullptr,
                                    static_cast<const float*>(dx[l]), static_cast<const float*>(dg[l]),
                                    ns ? F(s.a) : F(s.pa), ns ? F(s.bt) : F(s.pb), m[l], n[l]};
    }
    launch_jobs(arrow_kernel, arrows, blocks, stream);

    GemmBatch g;
    // (c1) dd: T1 = dG Qr^T, W = Linv^T dX;  ds: A = (Ql dG) qr, Bt = (Linv^T dX) / qr;
    //      nd: A = (arrow dG) Qr^T, Bt = (arrow^{-T} dX) Rinv
    g.count = 0;
    for (int l = 0; l < L; ++l) {
        const LayerScratch& s = off[l];
        const int M = m[l], N = n[l];
        const float* DG = static_cast<const float*>(dg[l]);
        const float* DX = static_cast<const float*>(dx[l]);
        if (kind[l] == KIND_DD) {
            g.p[g.count] = gemm_prob(DG, 0, ldr(l), F(s.qrb), 1, N, F(s.t1), M, N, N);
            g.p[g.count++].cut = CUT_B_LOWER;
            g.p[g.count] = gemm_prob(F(s.linv), 1, M, DX, 0, ldr(l), F(s.w), M, N, M);
            g.p[g.count++].cut = CUT_A_LOWER;
        } else if (kind[l] == KIND_DS) {
            GemmProb pa = gemm_prob(F(s.qlb), 0, M, DG, 0, ldr(l), F(s.a), M, N, M);
            pa.epi = EPI_COLMUL; pa.v = F(s.qrb); pa.cut = CUT_A_UPPER;
            GemmProb pb = gemm_prob(F(s.linv), 1, M, DX, 0, ldr(l), F(s.bt), M, N, M);
            pb.epi = EPI_COLDIV; pb.v = F(s.qrb); pb.cut = CUT_A_LOWER;
            g.p[g.count++] = pa;
            g.p[g.count++] = pb;
        } else if (kind[l] == KIND_ND) {
            g.p[g.count] = gemm_prob(F(s.pa), 0, N, F(s.qrb), 1, N, F(s.a), M, N, N);
            g.p[g.count++].cut = CUT_B_LOWER;
            g.p[g.count] = gemm_prob(F(s.pb), 0, N, F(s.rinv), 0, N, F(s.bt), M, N, N);
            g.p[g.count++].cut = CUT_B_UPPER;
        }
    }
    launch_gemms(g, stream);
    // (c2) dd: A = Qlb T1,  Bt = W Rinv
    g.count = 0;
    for (int l = 0; l < L; ++l) {
        if (kind[l] != KIND_DD) continue;
        const LayerScratch& s = off[l];
        const int M = m[l], N = n[l];
        g.p[g.count] = gemm_prob(F(s.qlb), 0, M, F(s.t1), 0, N, F(s.a), M, N, M);
        g.p[g.count++].cut = CUT_A_UPPER;
        g.p[g.count] = gemm_prob(F(s.w), 0, N, F(s.rinv), 0, N, F(s.bt), M, N, N);
        g.p[g.count++].cut = CUT_B_UPPER;
    }
    launch_gemms(g, stream);
    // (c3) dense left:  grad1 = triu([A|Bt] [A|-Bt]^T) (m x m, K = n);
    //      dense right: grad2 = triu([A|Bt]^T [A|-Bt]) (n x n, K = m); with max|grad|
    g.count = 0;
    for (int l = 0; l < L; ++l) {
        const LayerScratch& s = off[l];
        const int M = m[l], N = n[l];
        if (!left_arrow(kind[l])) {
            GemmProb g1 = gemm_prob(F(s.a), 0, N, F(s.a), 1, N, F(s.g1), M, M, N);
            g1.a2 = F(s.bt); g1.b2 = F(s.bt); g1.epi = EPI_TRIU_MAX; g1.mx = mx + 2 * l;
            g.p[g.count++] = g1;
        }
        if (!right_scale(kind[l])) {
            GemmProb g2 = gemm_prob(F(s.a), 1, N, F(s.a), 0, N, F(s.g2), N, N, M);
            g2.a2 = F(s.bt); g2.b2 = F(s.bt); g2.epi = EPI_TRIU_MAX; g2.mx = mx + 2 * l + 1;
            g.p[g.count++] = g2;
        }
    }
    launch_gemms(g, stream);
    // (s) arrow left: diag, bias by rows;  scale right: grad2 by columns
    JobBatch<StatJob> stats;
    stats.count = 0;
    for (int l = 0; l < L; ++l) {
        const LayerScratch& s = off[l];
        if (left_arrow(kind[l])) {
            blocks[stats.count] = (m[l] + 7) / 8;
            stats.j[stats.count++] = {F(s.a), F(s.bt), F(s.diag), F(s.bias), mx + 2 * l, m[l], n[l], 1};
        }
        if (right_scale(kind[l])) {
            blocks[stats.count] = (n[l] + 255) / 256;
            stats.j[stats.count++] = {F(s.a), F(s.bt), F(s.g2), nullptr, mx + 2 * l + 1, m[l], n[l], 0};
        }
    }
    launch_jobs(stats_kernel, stats, blocks, stream);
    // (d) dense sides: Q' = Q - s grad Q, s = min(step / (max|grad| + tiny), FLT_MAX)
    g.count = 0;
    for (int l = 0; l < L; ++l) {
        const LayerScratch& s = off[l];
        const int M = m[l], N = n[l];
        if (!left_arrow(kind[l])) {
            GemmProb u1 = gemm_prob(F(s.g1), 0, M, F(s.qlb), 0, M, static_cast<float*>(out_ql[l]), M, M, M);
            u1.epi = EPI_UPDATE; u1.q = F(s.qlb); u1.mx = mx + 2 * l; u1.step = step;
            u1.cut = CUT_A_UPPER | CUT_B_UPPER;
            g.p[g.count++] = u1;
        }
        if (!right_scale(kind[l])) {
            GemmProb u2 = gemm_prob(F(s.g2), 0, N, F(s.qrb), 0, N, static_cast<float*>(out_qr[l]), N, N, N);
            u2.epi = EPI_UPDATE; u2.q = F(s.qrb); u2.mx = mx + 2 * l + 1; u2.step = step;
            u2.cut = CUT_A_UPPER | CUT_B_UPPER;
            g.p[g.count++] = u2;
        }
    }
    launch_gemms(g, stream);
    // (v) arrow and scale sides
    JobBatch<VecJob> vecs;
    vecs.count = 0;
    for (int l = 0; l < L; ++l) {
        const LayerScratch& s = off[l];
        if (left_arrow(kind[l])) {
            blocks[vecs.count] = (m[l] + 255) / 256;
            vecs.j[vecs.count++] = {F(s.qlb), F(s.diag), F(s.bias), mx + 2 * l,
                                    static_cast<float*>(out_ql[l]), m[l], 1};
        }
        if (right_scale(kind[l])) {
            blocks[vecs.count] = (n[l] + 255) / 256;
            vecs.j[vecs.count++] = {F(s.qrb), F(s.g2), nullptr, mx + 2 * l + 1,
                                    static_cast<float*>(out_qr[l]), n[l], 0};
        }
    }
    launch_jobs(vec_kernel, vecs, blocks, stream, step);
    return (int)cudaGetLastError();
}

extern "C" int psgd_kron_multi_update(int L, const int* kind, void** ql, void** qr, void** dx,
                                      void** dg, void** out_ql, void** out_qr, const int* m,
                                      const int* n, float step, void* scratch, void* stream_ptr) {
    if (!valid(L, kind, m, n)) return (int)cudaErrorInvalidValue;
    return run_chain(L, kind, ql, qr, dx, dg, out_ql, out_qr, m, n, 0, 0, step, scratch,
                     static_cast<cudaStream_t>(stream_ptr));
}

// ---------------------------------------------------------------------------
// K4: B stacked (dense, dense) layers of one padded bucket.
//
// Replaces psgd_tf_tpu/ops/pallas/kron_dd.py `fused_update_batched` (:252,
// its pallas_call at :294): ql (B, S, S), qr (B, T, T), dx and dg (B, S, T),
// layer i's true (m_i, n_i) in the corners, identity (factors) and zeros
// (probes) beyond. The Pallas grid runs K2's body on each padded layer,
// with the balancing maxima masked to (m_i, n_i) and 128-block Newton
// inverses over the whole padded side. Here the stack goes through the
// same chain as K1, PSGD_MAX_LAYERS layers at a time, each layer's
// pointers at its slot and its row strides S, T: the chain works on the
// true corner alone, so the maxima are masked by construction and no solve
// or product runs over the padding. The chain writes each updated corner
// tight into the scratch; a last launch copies it into its slot of the
// fresh output stacks, with exact identity beyond (1 on the diagonal, 0
// elsewhere). Storing the corners straight into the slots needs a row
// stride in the grouped GEMM's descriptor, which made every chain sharing
// it (K1, K9, K10) up to 25% slower. The input stacks are not written (no
// in-place alias: the port's states are functional). Bound on this card as
// K1 is: latency, a fixed chain of small grouped launches per 16 layers.

struct SlotJob {
    const float* corner;  // (d, d), tight: what the chain wrote
    float* q;             // its (side, side) slot in the output stack
    int d, side;
};

struct SlotBatch {
    SlotJob j[2 * PSGD_MAX_LAYERS];
    int count;
};

// grid (blocks per slot, slots)
__global__ void __launch_bounds__(256) slot_kernel(const SlotBatch b) {
    const SlotJob J = b.j[blockIdx.y];
    const size_t total = (size_t)J.side * J.side;
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += (size_t)gridDim.x * blockDim.x) {
        const int i = (int)(e / J.side), j = (int)(e % J.side);
        J.q[e] = (i < J.d && j < J.d) ? J.corner[(size_t)i * J.d + j] : (i == j ? 1.f : 0.f);
    }
}

static bool valid_batched(int B, int S, int T, const int* m, const int* n) {
    if (B < 1 || S < 1 || T < 1) return false;
    for (int i = 0; i < B; ++i)
        if (m[i] < 1 || m[i] > S || n[i] < 1 || n[i] > T) return false;
    return true;
}

// One chunk's scratch in floats: the chain's, then the tight corners from
// offset *corners on.
static size_t chunk_floats(int L, const int* m, const int* n, size_t* corners) {
    const int kind[PSGD_MAX_LAYERS] = {};  // KIND_DD
    size_t cur = plan(L, kind, m, n, nullptr);
    *corners = cur;
    for (int l = 0; l < L; ++l)
        cur += psgd_align4((size_t)m[l] * m[l]) + psgd_align4((size_t)n[l] * n[l]);
    return cur;
}

extern "C" size_t psgd_kron_dd_batched_scratch_floats(int B, int S, int T, const int* m,
                                                      const int* n) {
    if (!valid_batched(B, S, T, m, n)) return 0;
    size_t most = 0, corners;
    for (int b0 = 0; b0 < B; b0 += PSGD_MAX_LAYERS)
        most = std::max(most, chunk_floats(std::min(PSGD_MAX_LAYERS, B - b0), m + b0, n + b0,
                                           &corners));
    return most;
}

extern "C" int psgd_kron_dd_batched_update(int B, int S, int T, void* ql, void* qr, void* dx,
                                           void* dg, void* out_ql, void* out_qr, const int* m,
                                           const int* n, float step, void* scratch,
                                           void* stream_ptr) {
    if (!valid_batched(B, S, T, m, n)) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int kind[PSGD_MAX_LAYERS] = {};  // KIND_DD
    const size_t ss = (size_t)S * S, tt = (size_t)T * T, st = (size_t)S * T;
    auto at = [](void* p, size_t floats) { return static_cast<float*>(p) + floats; };
    // the chunks run one after another on the stream and share the scratch
    for (int b0 = 0; b0 < B; b0 += PSGD_MAX_LAYERS) {
        const int L = std::min(PSGD_MAX_LAYERS, B - b0);
        size_t corner0;
        chunk_floats(L, m + b0, n + b0, &corner0);
        float* corner = static_cast<float*>(scratch) + corner0;
        void *pql[PSGD_MAX_LAYERS], *pqr[PSGD_MAX_LAYERS], *pdx[PSGD_MAX_LAYERS],
             *pdg[PSGD_MAX_LAYERS], *oql[PSGD_MAX_LAYERS], *oqr[PSGD_MAX_LAYERS];
        SlotBatch slots;
        slots.count = 0;
        for (int l = 0; l < L; ++l) {
            const size_t i = (size_t)(b0 + l);
            const int ml = m[b0 + l], nl = n[b0 + l];
            pql[l] = at(ql, i * ss); pqr[l] = at(qr, i * tt);
            pdx[l] = at(dx, i * st); pdg[l] = at(dg, i * st);
            oql[l] = corner; corner += psgd_align4((size_t)ml * ml);
            oqr[l] = corner; corner += psgd_align4((size_t)nl * nl);
            slots.j[slots.count++] = {static_cast<const float*>(oql[l]), at(out_ql, i * ss), ml, S};
            slots.j[slots.count++] = {static_cast<const float*>(oqr[l]), at(out_qr, i * tt), nl, T};
        }
        const int rc = run_chain(L, kind, pql, pqr, pdx, pdg, oql, oqr, m + b0, n + b0, S, T, step,
                                 scratch, stream);
        if (rc) return rc;
        const int blocks = std::min(64, std::max(1, (int)((std::max(ss, tt) + 4095) / 4096)));
        slot_kernel<<<dim3(blocks, slots.count), 256, 0, stream>>>(slots);
    }
    return (int)cudaGetLastError();
}
