// K1/K2/K5/K20: the Kronecker factor update for a list of layers of mixed
// kinds. K4, the stacked (dense, dense) bucket, runs the same stages over a
// whole stack in kron_batched.cu, on this file's K3 and GEMM tile bodies.
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
// short FIXED list of stages, each covering every layer of the list:
//   (a) balance          rho on the device, balanced copies to scratch,
//                        the two max|grad| slots of each layer zeroed;
//   (b) tri.cu           exact inverses of EVERY dense factor of every
//                        layer (K3, one cooperative launch);
//   (c0) arrow           nd/ns: the arrow products Ql dG and Ql^{-T} dX
//                        (ns: scaled by the right factor, i.e. A and Bt);
//   (c1, c2) GEMM        a hand-written grouped fp32 tiled GEMM over
//                        per-problem descriptors: A and Bt of dd (two
//                        stages), ds (column-scale epilogue) and nd; each
//                        K loop cut to its triangular operand's band;
//   (c3) GEMM            the dense sides' triu Grams, each as ONE product
//                        over the concatenated [A | Bt] (the Bt half
//                        subtracted), with max|grad| by block reduction plus
//                        atomicMax on the float bits (a max does not depend
//                        on order, so the result is deterministic);
//   (s) stats            the scale sides' column sums and the arrow sides'
//                        row sums (diag, bias), with their max|grad|;
//   (d) GEMM             the dense sides' Q' = Q - s grad Q, s on the device;
//   (v) vec              the arrow and scale sides' rewrites.
// No product goes to cuBLAS. The stage bodies are device functions run by
// two routes with the same bits: a chain of grouped launches, one a stage
// (a stage with nothing to do is not launched), and one cooperative launch
// of all of them with grid barriers between phases (kron_mono_kernel,
// below). run_chain picks the route from the list's kinds and sides.
//
// What bounds it on this card: latency, not FLOPs or bytes. LeNet5's five
// layers need 164 MFLOP per step and a few MB of traffic, yet each GEMM
// stage is a few dozen 64 x 64 tiles, each tile's K loop up to 2 x 257
// deep. So a small list's products are split along K (list_splits, below:
// bands of ~64 while the stage's tiles times bands fit the SMs), the bands'
// raw products summed in band order by a launch that applies the
// epilogue. Measured on an H100 80GB HBM3 at its 700 W limit
// (tools/profile_kron_chain.py): LeNet5's list on the chain, 10 launches,
// spans 112 us (balance 6, K3 40, the four split stages 10, 10, 15 and 10
// with sums of 3 each), where the parent's 7 launches spanned 157 (K3 67,
// the unsplit stages 17, 17, 26, 18); the toy NMT list's one launch 84 us
// (the parent's chain 140). The host's enqueue of a call (the wrapper and
// its launches, 0.09-0.22 ms) is as long as the device span or longer.
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

#include "gemm_tile.cuh"
#include "tri_inv.cuh"

#include <cooperative_groups.h>
#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <initializer_list>
#include <utility>


enum Kind { KIND_DD = 0, KIND_DS = 1, KIND_ND = 2, KIND_NS = 3 };
static inline bool left_arrow(int k) { return k == KIND_ND || k == KIND_NS; }
static inline bool right_scale(int k) { return k == KIND_DS || k == KIND_NS; }

struct BalanceLayer {
    const float* ql;   // dense: (m, m); arrow: (2, m)
    const float* qr;   // dense: (n, n); scale: (n,)
    float* qlb;        // the balanced copies
    float* qrb;
    unsigned int* mx;  // two max|grad| slots, zeroed here
    int m, n, arrow, scale;
};

struct BalanceBatch {
    BalanceLayer l[PSGD_MAX_LAYERS];
    int count;
};

// (c0): the arrow pre-pass of one layer, 32 columns per block
#define ARROW_WARPS 8
static_assert(ARROW_WARPS * 32 == 256, "arrow_body runs on 256-thread blocks");
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

// A stage's jobs and the prefix sums of their blocks
template <class Job>
struct JobBatch {
    Job j[2 * PSGD_MAX_LAYERS];
    int blocks[2 * PSGD_MAX_LAYERS + 1];
    int count;
    void clear() { count = 0; blocks[0] = 0; }
    void push(const Job& job, int nblocks) {
        j[count] = job;
        blocks[count + 1] = blocks[count] + nblocks;
        ++count;
    }
};

__device__ __forceinline__ int find_job(const int* prefix, int count, int t) {
    int p = 0;
    while (p + 1 < count && t >= prefix[p + 1]) ++p;
    return p;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// The stage bodies: each runs one block of its stage (every thread of the
// block calls it), `blk` that block's index in the stage's grid. The
// chain's kernels run one a launch; kron_mono_kernel runs them all.

// Block (bx, by) of a (gx, layers) grid: every block recomputes its layer's
// diagonal maxima (m + n loads) and scales its share of both factors.
__device__ __forceinline__ void balance_body(const BalanceBatch& b, int bx, int by, int gx,
                                             float* red) {
    const BalanceLayer L = b.l[by];
    float ml = -INFINITY, mr = -INFINITY;
    for (int i = threadIdx.x; i < L.m; i += blockDim.x)
        ml = fmaxf(ml, L.arrow ? L.ql[i] : L.ql[(size_t)i * L.m + i]);
    for (int i = threadIdx.x; i < L.n; i += blockDim.x)
        mr = fmaxf(mr, L.scale ? L.qr[i] : L.qr[(size_t)i * L.n + i]);
    ml = block_reduce_max(ml, red);
    mr = block_reduce_max(mr, red);
    const float rho = sqrtf(ml / mr);
    if (bx == 0 && threadIdx.x == 0) {
        L.mx[0] = 0u;
        L.mx[1] = 0u;
    }
    const size_t nl = L.arrow ? 2 * (size_t)L.m : (size_t)L.m * L.m;
    const size_t total = nl + (L.scale ? (size_t)L.n : (size_t)L.n * L.n);
    const size_t stride = (size_t)gx * blockDim.x;
    // eight elements' loads in flight before their stores
    for (size_t e0 = (size_t)bx * blockDim.x + threadIdx.x; e0 < total; e0 += 8 * stride) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const size_t e = e0 + k * stride;
            v[k] = e >= total ? 0.f : e < nl ? L.ql[e] : L.qr[e - nl];
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const size_t e = e0 + k * stride;
            if (e < nl) L.qlb[e] = v[k] / rho;
            else if (e < total) L.qrb[e - nl] = rho * v[k];
        }
    }
}

// One block per 32-column tile: lane = column, warp = row group. Each warp
// walks rows warp, warp + 8, ... (a warp's loads are one 128-byte row
// segment), and the block sums its warps' corr partials for the last row,
// so the serial chain per thread is m / 8 rows, not m.
__device__ __forceinline__ void arrow_body(const JobBatch<ArrowJob>& b, int blk,
                                           float (*red)[32]) {
    const int p = find_job(b.blocks, b.count, blk);
    const ArrowJob J = b.j[p];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j = (blk - b.blocks[p]) * 32 + lane;
    const int m = J.m, n = J.n;
    const float* q0 = J.qlb;
    const float* q1 = J.qlb + m;
    const float q0_last = q0[m - 1];
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

__device__ __forceinline__ void stats_body(const JobBatch<StatJob>& b, int blk, float* red) {
    const int p = find_job(b.blocks, b.count, blk);
    const StatJob J = b.j[p];
    const int t = blk - b.blocks[p];
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

__device__ __forceinline__ void vec_body(const JobBatch<VecJob>& b, int blk, float step) {
    const int p = find_job(b.blocks, b.count, blk);
    const VecJob J = b.j[p];
    const int i = (blk - b.blocks[p]) * blockDim.x + threadIdx.x;
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

// grid (blocks per layer, layers)
__global__ void __launch_bounds__(256) balance_kernel(const BalanceBatch b) {
    __shared__ float red[8];
    balance_body(b, blockIdx.x, blockIdx.y, gridDim.x, red);
}

__global__ void __launch_bounds__(256) arrow_kernel(const JobBatch<ArrowJob> b) {
    __shared__ float red[ARROW_WARPS][32];
    arrow_body(b, blockIdx.x, red);
}

__global__ void __launch_bounds__(256) stats_kernel(const JobBatch<StatJob> b) {
    __shared__ float red[8];
    stats_body(b, blockIdx.x, red);
}

__global__ void __launch_bounds__(256) vec_kernel(const JobBatch<VecJob> b, float step) {
    vec_body(b, blockIdx.x, step);
}

// K1's K split: where each problem of a batch stores its bands' raw
// products, band y of problem p at part + off[p] + y M N
struct SplitPlan {
    float* part;
    int off[PSGD_MAX_GEMMS];
};

// The epilogue of output (i, j) of problem P, o = i N + j, from its sum v
// (gemm_body's own, for the sums of a K split); s: the update's step
// scale; the triu epilogues fold |C| into local_max.
__device__ __forceinline__ float gemm_epi(const GemmProb& P, int i, int j, size_t o, float v,
                                          float s, float& local_max) {
    if (P.epi == EPI_TRIU_MAX || P.epi == EPI_TRIU) {
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
    return v;
}

// One output tile of the batch: tile `tile` of the prefix g.tiles, band
// `split` of `splits`. With splits > 1, band y sums k in [y kc, (y + 1) kc),
// kc = K / splits rounded up to GEMM_BK, into c + y M N (EPI_STORE and
// EPI_TRIU alone; a caller sums the partials); PART: its raw product into
// sp's region instead (K1's K split: sum_body applies the epilogue). VAR >= 0: the body holds the one operand orientation
// (ta, tb) = (VAR >> 1, VAR & 1) of every problem it is given. gsm: the
// ring (GemmTile<QM, QN>::SMEM bytes); red: 8 floats. EPIX: the body also
// reads the flags EPI_UPPER and EPI_COLSQ of `epi` (psgd.cuh); only the
// kernel that K10's chain launches is built with it, so every other
// kernel's code is the body without them.
template <int QM, int QN, int VAR, bool PART, class Batch, bool EPIX = false>
__device__ __forceinline__ void gemm_body(const Batch& g, int tile, int split, int splits,
                                          float* gsm, float* red, const SplitPlan* sp = nullptr) {
    using T = GemmTile<QM, QN>;
    const int p = find_job(g.tiles, g.count, tile);
    // a copy: the fields the loops read stay in registers, not re-read from
    // the dynamically indexed parameter array
    const GemmProb P = g.p[p];
    const int epi = EPIX ? P.epi & EPI_BASE : P.epi;
    const int t = tile - g.tiles[p];
    const int tiles_n = (P.N + T::BN - 1) / T::BN;
    int row0 = (t / tiles_n) * T::BM, col0 = (t % tiles_n) * T::BN;
    if constexpr (EPIX) {
        if (P.epi & EPI_UPPER) {  // tile t of the upper triangle's tiles, row by row
            int tr = 0, rem = t;
            for (; rem >= tiles_n - tr; ++tr) rem -= tiles_n - tr;
            row0 = tr * T::BM;
            col0 = (tr + rem) * T::BN;
        }
    }
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

    float acc[4 * QM][4 * QN];
#pragma unroll
    for (int i = 0; i < 4 * QM; ++i)
#pragma unroll
        for (int j = 0; j < 4 * QN; ++j) acc[i][j] = 0.f;
    // a tile wholly below the diagonal of a triu output is zero: skip the K loop
    const bool triu = epi == EPI_TRIU_MAX || epi == EPI_TRIU;
    const bool skip = triu && row0 > col0 + T::BN - 1;
    // the band of k where a triangular operand may be nonzero for this tile
    int k_lo = 0, k_hi = P.K;
    if (splits > 1) {
        const int kc = ((P.K + splits - 1) / splits + GEMM_BK - 1) / GEMM_BK * GEMM_BK;
        k_lo = split * kc;
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

    if constexpr (PART) {
        float* c = sp->part + sp->off[p] + (size_t)split * P.M * P.N;
#pragma unroll
        for (int ii = 0; ii < 4 * QM; ++ii) {
            const int i = row0 + (ii / 4) * 64 + ty * 4 + ii % 4;
#pragma unroll
            for (int jj = 0; jj < 4 * QN; ++jj) {
                const int j = col0 + (jj / 4) * 64 + tx * 4 + jj % 4;
                if (i < P.M && j < P.N) c[(size_t)i * P.N + j] = acc[ii][jj];
            }
        }
        return;
    }
    float* c = P.c + (size_t)split * P.M * P.N;
    const float s = epi == EPI_UPDATE ? step_scale(P.step, P.mx) : 0.f;
    float local_max = 0.f;
    float colsq[4 * QN];  // EPI_COLSQ: the thread's column sums of v^2
#pragma unroll
    for (int jj = 0; jj < 4 * QN; ++jj) colsq[jj] = 0.f;
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
            } else if (epi == EPI_UPDATE) {
                v = P.q[o] - s * v;
            } else if (epi == EPI_COLMUL) {
                v = v * P.v[j];
            } else if (epi == EPI_COLDIV) {
                v = v / P.v[j];
            } else if (epi == EPI_ARROW) {
                v = (i == P.M - 1 ? 0.f : P.r[i] * v) + P.r[P.M + i] * P.v[j];
            } else if (epi == EPI_ROWDIV) {
                v = i == P.M - 1 ? 0.f : v / P.r[i];
            }
            c[o] = v;
            if constexpr (EPIX) colsq[jj] += v * v;
        }
    }
    if constexpr (EPIX) {
        if (P.epi & EPI_COLSQ) {
            // the tile's column sums of v^2, over its rows in order: each
            // thread's rows, then the 16 row groups, into row tile
            // row0 / BM of the (row tiles, N) partials stored after C
            __syncthreads();  // every thread is done with the ring
            constexpr int W = 64 * QN;
#pragma unroll
            for (int jj = 0; jj < 4 * QN; ++jj) gsm[ty * W + (jj / 4) * 64 + tx * 4 + jj % 4] = colsq[jj];
            __syncthreads();
            float* part = P.c + (size_t)P.M * P.N + (size_t)(row0 / T::BM) * P.N;
            for (int k = threadIdx.x; k < W; k += GEMM_THREADS) {
                float sum = 0.f;
                for (int y = 0; y < 16; ++y) sum += gsm[y * W + k];
                if (col0 + k < P.N) part[col0 + k] = sum;
            }
        }
    }
    if (epi == EPI_TRIU_MAX) {
        // |grad| >= 0, so its float bits order like unsigned integers
        local_max = block_reduce_max(local_max, red);
        if (threadIdx.x == 0) atomicMax(P.mx, __float_as_uint(local_max));
    }
}

// grid (tiles of every problem, splits); MINB: the blocks an SM holds
template <int QM, int QN, int MINB, int VAR = -1, bool EPIX = false>
__global__ void __launch_bounds__(GEMM_THREADS, MINB) gemm_kernel(const GemmBatch g) {
    extern __shared__ __align__(16) float gsm[];
    __shared__ float red[GEMM_THREADS / 32];
    gemm_body<QM, QN, VAR, false, GemmBatch, EPIX>(g, blockIdx.x, blockIdx.y, gridDim.y, gsm, red);
}

// K1's split stages: the 64 x 64 tiles' bands of raw products, grid (tiles,
// splits)
__global__ void __launch_bounds__(GEMM_THREADS, 2) gemm_split_kernel(
    const GemmBatch g, const __grid_constant__ SplitPlan sp) {
    extern __shared__ __align__(16) float gsm[];
    __shared__ float red[GEMM_THREADS / 32];
    gemm_body<1, 1, -1, true>(g, blockIdx.x, blockIdx.y, gridDim.y, gsm, red, &sp);
}

// 256-output blocks of the batch's problems: the sums' grid
template <class Batch>
static int sum_blocks(const Batch& g) {
    int b = 0;
    for (int p = 0; p < g.count; ++p) b += (g.p[p].M * g.p[p].N + GEMM_THREADS - 1) / GEMM_THREADS;
    return b;
}

// The K split's second half, block t of sum_blocks(g): problem p's
// `splits` partial products summed in band order, then its own epilogue
// (the triu ones with max|grad| by block reduction and atomicMax).
template <class Batch>
__device__ __forceinline__ void sum_body(const Batch& g, const SplitPlan& sp, int splits, int t,
                                         float* red) {
    int p = 0;
    for (; p + 1 < g.count; ++p) {
        const int nb = (g.p[p].M * g.p[p].N + GEMM_THREADS - 1) / GEMM_THREADS;
        if (t < nb) break;
        t -= nb;
    }
    const GemmProb P = g.p[p];
    const int mn = P.M * P.N, e = t * GEMM_THREADS + threadIdx.x;
    const float s = P.epi == EPI_UPDATE ? step_scale(P.step, P.mx) : 0.f;
    float local_max = 0.f;
    if (e < mn) {
        const float* part = sp.part + sp.off[p];
        float b[KRON_MAX_SPLITS];  // every band's load in flight, then the sum in band order
#pragma unroll
        for (int y = 0; y < KRON_MAX_SPLITS; ++y) b[y] = y < splits ? part[(size_t)y * mn + e] : 0.f;
        float v = b[0];
#pragma unroll
        for (int y = 1; y < KRON_MAX_SPLITS; ++y)
            if (y < splits) v += b[y];
        P.c[e] = gemm_epi(P, e / P.N, e % P.N, e, v, s, local_max);
    }
    if (P.epi == EPI_TRIU_MAX) {
        // |grad| >= 0, so its float bits order like unsigned integers
        local_max = block_reduce_max(local_max, red);
        if (threadIdx.x == 0) atomicMax(P.mx, __float_as_uint(local_max));
    }
}

__global__ void __launch_bounds__(GEMM_THREADS) sum_kernel(const GemmBatch g,
                                                           const __grid_constant__ SplitPlan sp,
                                                           int splits) {
    __shared__ float red[GEMM_THREADS / 32];
    sum_body(g, sp, splits, blockIdx.x, red);
}

int gemm_sms() {
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
template <int QM, int QN, int MINB, int VAR = -1, bool EPIX = false>
static void gemm_launch_q(GemmBatch& g, int splits, cudaStream_t stream) {
    using T = GemmTile<QM, QN>;
    static unsigned long long raised = 0;  // a bit per device
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return;
    if (dev >= 64 || !(raised >> dev & 1)) {
        if (cudaFuncSetAttribute(gemm_kernel<QM, QN, MINB, VAR, EPIX>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)T::SMEM) != cudaSuccess)
            return;
        if (dev < 64) raised |= 1ULL << dev;
    }
    g.tiles[0] = 0;
    for (int p = 0; p < g.count; ++p) {
        const GemmProb& P = g.p[p];
        const int tn = (P.N + T::BN - 1) / T::BN;
        g.tiles[p + 1] = g.tiles[p] + ((P.epi & EPI_UPPER) ? tn * (tn + 1) / 2
                                                           : ((P.M + T::BM - 1) / T::BM) * tn);
    }
    gemm_kernel<QM, QN, MINB, VAR, EPIX><<<dim3(g.tiles[g.count], splits), GEMM_THREADS, T::SMEM,
                                           stream>>>(g);
}

// q: 0 picks the tile (128 x 128 where the launch's tiles of that size,
// times the splits, give every SM at least four, two resident at a time;
// else 64 x 64, two an SM); 1 (64) or 2 (128) forces it
static void launch_gemms_q(GemmBatch& g, cudaStream_t stream, int splits, int q) {
    if (g.count == 0) return;
    for (int p = 0; p < g.count; ++p) {
        if (g.p[p].epi & ~EPI_BASE) {  // the flags: their own kernel, 64 x 64 tiles
            gemm_launch_q<1, 1, 2, -1, true>(g, splits, stream);
            return;
        }
    }
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

// Launch a stage's blocks, unless the batch is empty.
template <class Job, class Kernel, class... Args>
static void launch_jobs(Kernel kernel, const JobBatch<Job>& b, cudaStream_t stream, Args... args) {
    if (b.count == 0) return;
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

extern "C" size_t psgd_kron_multi_scratch_floats(int L, const int* kind, const int* m, const int* n);

// The phases of the one-launch kernel that run GEMM problems; the chain's
// stages c1 and c2 split over the first three by what each problem reads.
enum { MONO_EARLY = 0, MONO_C1 = 1, MONO_C2 = 2, MONO_GRAMS = 3, MONO_UPDATES = 4, MONO_GEMMS = 5 };

// The chain's descriptors on one list.
struct ChainPlan {
    BalanceBatch bal;
    int bal_blocks;
    TriBatch tri;
    JobBatch<ArrowJob> arrows;
    GemmBatch c1, c2, c3, d;
    JobBatch<StatJob> stats;
    JobBatch<VecJob> vecs;
    int phase1[PSGD_MAX_GEMMS], phase2[PSGD_MAX_GEMMS];  // c1's and c2's problems: MONO_*
    int splits;     // K's bands a product (1: no split)
    SplitPlan sp1, sp2, sp3, spd;  // c1's, c2's, c3's and d's partials when split
    size_t floats;  // the scratch the plan takes, the partial products included
};

// The K split of a list's products. A latency-bound list's stages hold a
// few dozen 64 x 64 tiles, each one K loop (up to 2 x 257 deep at LeNet5's
// sides) on one SM; cutting K into bands of about KRON_SPLIT_K runs more
// of them at once, the partials summed in band order by a sum launch
// (phase) that applies the epilogue. At most KRON_MAX_SPLITS bands, and no
// more of a stage's tiles times bands than the card's SMs: past one wave
// the bands only share the SMs the tiles had (a list of large products
// keeps one band). Measured on an H100 80GB HBM3 at its 700 W limit
// (tools/kron_gemm_ab.py --route): LeNet5's list 0.112 ms on the device
// against 0.129 unsplit, K2 at (256, 256) 0.087 against 0.119; with two
// CTAs an SM allowed, 16 (128, 128) layers took 0.135 against 0.090.
static int list_splits(const ChainPlan& c) {
    int kmax = 0;
    long long most = 0;
    for (const GemmBatch* g : {&c.c1, &c.c2, &c.c3, &c.d}) {
        long long tiles = 0;
        for (int p = 0; p < g->count; ++p) {
            kmax = std::max(kmax, g->p[p].K);
            tiles += (long long)((g->p[p].M + 63) / 64) * ((g->p[p].N + 63) / 64);
        }
        most = std::max(most, tiles);
    }
    int s = std::min(KRON_MAX_SPLITS, std::max(1, (kmax + KRON_SPLIT_K - 1) / KRON_SPLIT_K));
    while (s > 1 && most * s > gemm_sms()) --s;
    return s;
}

// The chain on L layers, every operand tight (K1, K2, K5, K20).
static void build_chain(int L, const int* kind, void** ql, void** qr, void** dx, void** dg,
                        void** out_ql, void** out_qr, const int* m, const int* n, float step,
                        float* base, ChainPlan& c) {
    unsigned int* mx = reinterpret_cast<unsigned int*>(base);
    LayerScratch off[PSGD_MAX_LAYERS];
    const size_t layers = plan(L, kind, m, n, off);
    // the scratch's floats from `base` (null when only its size is asked)
    auto F = [&](size_t o) {
        return reinterpret_cast<float*>(reinterpret_cast<uintptr_t>(base) + o * sizeof(float));
    };
    auto add = [](GemmBatch& g, int* phase, const GemmProb& P, int ph) {
        if (phase) phase[g.count] = ph;
        g.p[g.count++] = P;
    };

    c.bal.count = L;
    c.tri.count = 0;
    int max_elems = 1;
    for (int l = 0; l < L; ++l) {
        const LayerScratch& s = off[l];
        const bool arrow = left_arrow(kind[l]), scale = right_scale(kind[l]);
        c.bal.l[l] = {static_cast<const float*>(ql[l]), static_cast<const float*>(qr[l]),
                      F(s.qlb), F(s.qrb), mx + 2 * l, m[l], n[l], arrow, scale};
        TriBatch& t = c.tri;
        if (!arrow) { t.u[t.count] = F(s.qlb); t.x[t.count] = F(s.linv); t.n[t.count++] = m[l]; }
        if (!scale) { t.u[t.count] = F(s.qrb); t.x[t.count] = F(s.rinv); t.n[t.count++] = n[l]; }
        max_elems = std::max(max_elems, (arrow ? 2 * m[l] : m[l] * m[l]) + (scale ? n[l] : n[l] * n[l]));
    }
    // (a) balance: enough blocks per layer for the largest factor pair
    c.bal_blocks = std::min(64, std::max(1, (max_elems + 4095) / 4096));

    // (c0) the arrow products of nd and ns layers
    c.arrows.clear();
    for (int l = 0; l < L; ++l) {
        if (!left_arrow(kind[l])) continue;
        const LayerScratch& s = off[l];
        const bool ns = kind[l] == KIND_NS;
        c.arrows.push({F(s.qlb), ns ? F(s.qrb) : nullptr, static_cast<const float*>(dx[l]),
                       static_cast<const float*>(dg[l]), ns ? F(s.a) : F(s.pa),
                       ns ? F(s.bt) : F(s.pb), m[l], n[l]}, (n[l] + 31) / 32);
    }

    // (c1) dd: T1 = dG Qr^T, W = Linv^T dX;  ds: A = (Ql dG) qr, Bt = (Linv^T dX) / qr;
    //      nd: A = (arrow dG) Qr^T, Bt = (arrow^{-T} dX) Rinv
    c.c1.count = 0;
    for (int l = 0; l < L; ++l) {
        const LayerScratch& s = off[l];
        const int M = m[l], N = n[l];
        const float* DG = static_cast<const float*>(dg[l]);
        const float* DX = static_cast<const float*>(dx[l]);
        if (kind[l] == KIND_DD) {
            GemmProb t1 = gemm_prob(DG, 0, N, F(s.qrb), 1, N, F(s.t1), M, N, N);
            t1.cut = CUT_B_LOWER;
            GemmProb w = gemm_prob(F(s.linv), 1, M, DX, 0, N, F(s.w), M, N, M);
            w.cut = CUT_A_LOWER;
            add(c.c1, c.phase1, t1, MONO_EARLY);
            add(c.c1, c.phase1, w, MONO_C1);
        } else if (kind[l] == KIND_DS) {
            GemmProb pa = gemm_prob(F(s.qlb), 0, M, DG, 0, N, F(s.a), M, N, M);
            pa.epi = EPI_COLMUL; pa.v = F(s.qrb); pa.cut = CUT_A_UPPER;
            GemmProb pb = gemm_prob(F(s.linv), 1, M, DX, 0, N, F(s.bt), M, N, M);
            pb.epi = EPI_COLDIV; pb.v = F(s.qrb); pb.cut = CUT_A_LOWER;
            add(c.c1, c.phase1, pa, MONO_EARLY);
            add(c.c1, c.phase1, pb, MONO_C1);
        } else if (kind[l] == KIND_ND) {
            GemmProb pa = gemm_prob(F(s.pa), 0, N, F(s.qrb), 1, N, F(s.a), M, N, N);
            pa.cut = CUT_B_LOWER;
            GemmProb pb = gemm_prob(F(s.pb), 0, N, F(s.rinv), 0, N, F(s.bt), M, N, N);
            pb.cut = CUT_B_UPPER;
            add(c.c1, c.phase1, pa, MONO_C1);
            add(c.c1, c.phase1, pb, MONO_C1);
        }
    }
    // (c2) dd: A = Qlb T1,  Bt = W Rinv
    c.c2.count = 0;
    for (int l = 0; l < L; ++l) {
        if (kind[l] != KIND_DD) continue;
        const LayerScratch& s = off[l];
        const int M = m[l], N = n[l];
        GemmProb pa = gemm_prob(F(s.qlb), 0, M, F(s.t1), 0, N, F(s.a), M, N, M);
        pa.cut = CUT_A_UPPER;
        GemmProb pb = gemm_prob(F(s.w), 0, N, F(s.rinv), 0, N, F(s.bt), M, N, N);
        pb.cut = CUT_B_UPPER;
        add(c.c2, c.phase2, pa, MONO_C1);
        add(c.c2, c.phase2, pb, MONO_C2);
    }
    // (c3) dense left:  grad1 = triu([A|Bt] [A|-Bt]^T) (m x m, K = n);
    //      dense right: grad2 = triu([A|Bt]^T [A|-Bt]) (n x n, K = m); with max|grad|
    c.c3.count = 0;
    for (int l = 0; l < L; ++l) {
        const LayerScratch& s = off[l];
        const int M = m[l], N = n[l];
        if (!left_arrow(kind[l])) {
            GemmProb g1 = gemm_prob(F(s.a), 0, N, F(s.a), 1, N, F(s.g1), M, M, N);
            g1.a2 = F(s.bt); g1.b2 = F(s.bt); g1.epi = EPI_TRIU_MAX; g1.mx = mx + 2 * l;
            add(c.c3, nullptr, g1, MONO_GRAMS);
        }
        if (!right_scale(kind[l])) {
            GemmProb g2 = gemm_prob(F(s.a), 1, N, F(s.a), 0, N, F(s.g2), N, N, M);
            g2.a2 = F(s.bt); g2.b2 = F(s.bt); g2.epi = EPI_TRIU_MAX; g2.mx = mx + 2 * l + 1;
            add(c.c3, nullptr, g2, MONO_GRAMS);
        }
    }
    // (s) arrow left: diag, bias by rows;  scale right: grad2 by columns
    c.stats.clear();
    for (int l = 0; l < L; ++l) {
        const LayerScratch& s = off[l];
        if (left_arrow(kind[l]))
            c.stats.push({F(s.a), F(s.bt), F(s.diag), F(s.bias), mx + 2 * l, m[l], n[l], 1},
                         (m[l] + 7) / 8);
        if (right_scale(kind[l]))
            c.stats.push({F(s.a), F(s.bt), F(s.g2), nullptr, mx + 2 * l + 1, m[l], n[l], 0},
                         (n[l] + 255) / 256);
    }
    // (d) dense sides: Q' = Q - s grad Q, s = min(step / (max|grad| + tiny), FLT_MAX)
    c.d.count = 0;
    for (int l = 0; l < L; ++l) {
        const LayerScratch& s = off[l];
        const int M = m[l], N = n[l];
        if (!left_arrow(kind[l])) {
            GemmProb u1 = gemm_prob(F(s.g1), 0, M, F(s.qlb), 0, M, static_cast<float*>(out_ql[l]), M, M, M);
            u1.epi = EPI_UPDATE; u1.q = F(s.qlb); u1.mx = mx + 2 * l; u1.step = step;
            u1.cut = CUT_A_UPPER | CUT_B_UPPER;
            add(c.d, nullptr, u1, MONO_UPDATES);
        }
        if (!right_scale(kind[l])) {
            GemmProb u2 = gemm_prob(F(s.g2), 0, N, F(s.qrb), 0, N, static_cast<float*>(out_qr[l]), N, N, N);
            u2.epi = EPI_UPDATE; u2.q = F(s.qrb); u2.mx = mx + 2 * l + 1; u2.step = step;
            u2.cut = CUT_A_UPPER | CUT_B_UPPER;
            add(c.d, nullptr, u2, MONO_UPDATES);
        }
    }
    // (v) arrow and scale sides
    c.vecs.clear();
    for (int l = 0; l < L; ++l) {
        const LayerScratch& s = off[l];
        if (left_arrow(kind[l]))
            c.vecs.push({F(s.qlb), F(s.diag), F(s.bias), mx + 2 * l, static_cast<float*>(out_ql[l]),
                         m[l], 1}, (m[l] + 255) / 256);
        if (right_scale(kind[l]))
            c.vecs.push({F(s.qrb), F(s.g2), nullptr, mx + 2 * l + 1, static_cast<float*>(out_qr[l]),
                         n[l], 0}, (n[l] + 255) / 256);
    }
    // the K split: each product's partials in a region of their own after
    // the layers' scratch (the one launch runs problems of two stages in a
    // phase)
    c.splits = list_splits(c);
    size_t cur = layers;
    const std::pair<GemmBatch*, SplitPlan*> stages[] = {
        {&c.c1, &c.sp1}, {&c.c2, &c.sp2}, {&c.c3, &c.sp3}, {&c.d, &c.spd}};
    for (const auto& st : stages) {
        st.second->part = F(layers);
        for (int p = 0; c.splits > 1 && p < st.first->count; ++p) {
            st.second->off[p] = (int)(cur - layers);
            cur += psgd_align4((size_t)c.splits * st.first->p[p].M * st.first->p[p].N);
        }
    }
    c.floats = cur;
}

// The scratch floats of a list's chain, its partial products included.
static size_t chain_floats(int L, const int* kind, const int* m, const int* n) {
    void* none[PSGD_MAX_LAYERS] = {};
    ChainPlan c;
    build_chain(L, kind, none, none, none, none, none, none, m, n, 0.f, nullptr, c);
    return c.floats;
}

extern "C" size_t psgd_kron_multi_scratch_floats(int L, const int* kind, const int* m, const int* n) {
    if (!valid(L, kind, m, n)) return 0;
    return chain_floats(L, kind, m, n);
}

// a GEMM stage: the grouped GEMM, or, when K is split, its bands' raw
// products in the 64 x 64 tiles and the launch that sums them
static void launch_stage(GemmBatch& g, const SplitPlan& sp, int splits, cudaStream_t stream) {
    if (splits == 1) {
        launch_gemms(g, stream);
        return;
    }
    if (g.count == 0) return;
    g.tiles[0] = 0;
    for (int p = 0; p < g.count; ++p)
        g.tiles[p + 1] = g.tiles[p] + ((g.p[p].M + 63) / 64) * ((g.p[p].N + 63) / 64);
    gemm_split_kernel<<<dim3(g.tiles[g.count], splits), GEMM_THREADS, GemmTile<1, 1>::SMEM,
                        stream>>>(g, sp);
    sum_kernel<<<sum_blocks(g), GEMM_THREADS, 0, stream>>>(g, sp, splits);
}

static void launch_chain(ChainPlan& c, float step, cudaStream_t stream) {
    balance_kernel<<<dim3(c.bal_blocks, c.bal.count), 256, 0, stream>>>(c.bal);
    if (c.tri.count) launch_tri_inv(c.tri, stream);  // (b) K3 on every dense factor
    launch_jobs(arrow_kernel, c.arrows, stream);
    launch_stage(c.c1, c.sp1, c.splits, stream);
    launch_stage(c.c2, c.sp2, c.splits, stream);
    launch_stage(c.c3, c.sp3, c.splits, stream);
    launch_jobs(stats_kernel, c.stats, stream);
    launch_stage(c.d, c.spd, c.splits, stream);
    launch_jobs(vec_kernel, c.vecs, stream, step);
}

// ------------------------------------------------- the one-launch chain
// The same list in one cooperative launch of a resident grid
// (cudaLaunchCooperativeKernel), as splu.cu's splu_mono_kernel: each CTA
// walks a phase's tasks t = blockIdx.x, blockIdx.x + gridDim.x, ... and
// runs the chain's own stage bodies on them, a grid barrier
// (cg::this_grid().sync()) between phases where the chain has a launch
// boundary. The phases, each the chain's work whose inputs are ready:
//   balance | K3's leaves, the arrow pre-pass, dd's T1 and ds's A |
//   K3's levels (two a level; the first beside the sums of the phase
//   before) | the last zeroing of K3's temporaries (its own phase when K3
//   has one level), dd's W and A, ds's Bt, nd's A and Bt | their sums |
//   dd's Bt | its sums | the Grams and the stats | their sums | the
//   updates and the vectors | their sums
// (a phase with no task, such as every sum of an unsplit list, is none).
// Every GEMM problem is the chain's, in the chain's 64 x 64 tiles with the
// chain's K bands and sums, and the max|grad| slots are filled by
// atomicMax on the float bits, so every output equals the chain's bit for
// bit. The plan (~30 KB) is passed by value (kernel parameters take
// 32,764 bytes since CUDA 12.1) and read in place (__grid_constant__).
//
// The phases are a table built on the host, one call site a body in the
// kernel: a kernel with a copy of the bodies per phase took 255 registers
// and spilled, this one takes 231 and does not (one CTA an SM).
//
// What bounds it: the dependent path, not the bytes or the FLOPs. Against
// the chain it lets independent work share a phase: the arrow pre-pass
// beside K3's leaves, the stats beside the Grams, the vector rewrites
// beside the updates, the launches a list with sparse sides adds to the
// chain; it pays a grid barrier a phase (1.1 us measured at 132 CTAs,
// about a launch gap) and the registers of its largest body on every CTA.
// Its host enqueue (the 30 KB plan, the cooperative launch) is about the
// chain's. Measured on an H100 80GB HBM3 at its 700 W limit
// (tools/kron_gemm_ab.py --route, the device ms of calls queued behind a
// spinning kernel): faster on every list with a sparse side (a tie at nd
// (512, 256)), the toy NMT list 0.085 against 0.107, K5 ds at (130, 65)
// 0.067 against 0.072, nd 0.060 against 0.068 and at (512, 512) 0.188
// against 0.195, ns 3-8% faster at each size to (512, 512); slower or a
// tie on lists of dense sides alone: LeNet5's list 0.119 against 0.112,
// the K4 path's bucket 0.098 against 0.098, K2 at (1, 10) 0.034 against
// 0.031, at (1024, 1024) 0.890 against 0.718. The chained times of those
// lists, host included, moved 2x between runs.

// One launch for a list with a sparse side (ds, nd or ns) whose every GEMM
// stage takes the chain's 64 x 64 tiles and whose products come to at
// most this many MFLOP: the largest such list that sweep measured (K5 nd
// at (512, 512), K5's cap, 1,342 MFLOP) ran faster on the one launch.
#define KRON_MONO_MAX_MFLOP 1400

// A phase's work: up to three segments of tasks, each one body's.
enum {
    SEG_BALANCE = 0, SEG_TRI = 1, SEG_ARROW = 2, SEG_GEMM = 3, SEG_SUM = 4, SEG_STATS = 5, SEG_VEC = 6
};
struct MonoSegment {
    int kind, arg, tasks;  // arg: K3's phase (SEG_TRI) or the GEMM batch (SEG_GEMM, SEG_SUM)
};
struct MonoPhase {
    MonoSegment seg[3];
    int count;
};
#define MONO_MAX_PHASES (10 + 2 * PSGD_TRI_LEVELS)

struct MonoPlan {
    BalanceBatch bal;
    TriBatch tri;
    JobBatch<ArrowJob> arrows;
    JobBatch<StatJob> stats;
    JobBatch<VecJob> vecs;
    GemmBatch g[MONO_GEMMS];  // 64 x 64 tile prefixes
    SplitPlan sp[MONO_GEMMS];
    MonoPhase phases[MONO_MAX_PHASES];
    int nphases;
    float step;
    int bal_blocks, splits;
};
static_assert(sizeof(MonoPlan) <= 32764, "the one-launch plan is passed by value as a kernel parameter");

#define MONO_SMEM std::max(sizeof(float) * TRI_SMEM_FLOATS, GemmTile<1, 1>::SMEM)

// Every thread runs every phase, one body call site a kind of task.
__global__ void __launch_bounds__(256, 1) kron_mono_kernel(const __grid_constant__ MonoPlan P) {
    extern __shared__ __align__(16) float msm[];
    __shared__ float red[8];
    __shared__ float ared[ARROW_WARPS][32];
    for (int ph = 0; ph < P.nphases; ++ph) {
        if (ph) cooperative_groups::this_grid().sync();
        const MonoPhase& F = P.phases[ph];
        int total = 0;
        for (int k = 0; k < F.count; ++k) total += F.seg[k].tasks;
        for (int t = blockIdx.x; t < total; t += gridDim.x) {
            int k = 0, u = t;
            while (u >= F.seg[k].tasks) u -= F.seg[k++].tasks;
            const int kind = F.seg[k].kind, arg = F.seg[k].arg;
            if (kind == SEG_BALANCE)
                balance_body(P.bal, u % P.bal_blocks, u / P.bal_blocks, P.bal_blocks, red);
            else if (kind == SEG_TRI) tri_task(P.tri, arg, u, msm);
            else if (kind == SEG_ARROW) arrow_body(P.arrows, u, ared);
            else if (kind == SEG_GEMM) {
                const GemmBatch& g = P.g[arg];
                const int tiles = g.tiles[g.count];
                if (P.splits > 1)
                    gemm_body<1, 1, -1, true>(g, u % tiles, u / tiles, P.splits, msm, red, &P.sp[arg]);
                else gemm_body<1, 1, -1, false>(g, u, 0, 1, msm, red);
            } else if (kind == SEG_SUM) sum_body(P.g[arg], P.sp[arg], P.splits, u, red);
            else if (kind == SEG_STATS) stats_body(P.stats, u, red);
            else vec_body(P.vecs, u, P.step);
            __syncthreads();  // the next task reuses the shared memory
        }
    }
}

// the chain's products in FLOPs (2 M N K a product, the cut bands counted
// whole): a function of the kinds and sides alone; ops/hopper/kron_dd.py
// `route` mirrors it
static double chain_flops(int L, const int* kind, const int* m, const int* n) {
    double f = 0;
    for (int l = 0; l < L; ++l) {
        const double M = m[l], N = n[l];
        if (kind[l] == KIND_DD) f += 8 * M * N * (M + N) + 2 * (M * M * M + N * N * N);
        else if (kind[l] == KIND_DS) f += 8 * M * M * N + 2 * M * M * M;
        else if (kind[l] == KIND_ND) f += 8 * M * N * N + 2 * N * N * N;
    }
    return f;
}

// whether every GEMM stage of the chain takes the 64 x 64 tiles (launch_gemms_q's rule)
static bool chain_tiles64(const ChainPlan& c) {
    for (const GemmBatch* g : {&c.c1, &c.c2, &c.c3, &c.d}) {
        long long big = 0;
        for (int p = 0; p < g->count; ++p)
            big += (long long)((g->p[p].M + 127) / 128) * ((g->p[p].N + 127) / 128);
        if (c.splits == 1 && big >= 4LL * gemm_sms()) return false;
    }
    return true;
}

enum { ROUTE_AUTO = 0, ROUTE_CHAIN = 1, ROUTE_MONO = 2 };

// The card's cooperative grid for kron_mono_kernel: {CTAs a SM, SMs}, asked
// once a device; 0 CTAs where the card takes no cooperative launch.
static cudaError_t mono_resident(int* per_sm, int* sms) {
    static int known_dev = -1, known[2];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev != known_dev) {
        int coop = 0;
        known[0] = known[1] = 0;
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&known[1], cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(kron_mono_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)MONO_SMEM);
        if (e == cudaSuccess && coop)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&known[0], kron_mono_kernel, 256, MONO_SMEM);
        if (e != cudaSuccess) return e;
        known_dev = dev;
    }
    *per_sm = known[0];
    *sms = known[1];
    return cudaSuccess;
}

static cudaError_t launch_mono(ChainPlan& c, float step, cudaStream_t stream) {
    MonoPlan P;
    P.bal = c.bal;
    P.bal_blocks = c.bal_blocks;
    P.tri = c.tri;
    plan_tri_inv(P.tri);
    P.arrows = c.arrows;
    P.stats = c.stats;
    P.vecs = c.vecs;
    P.step = step;
    P.splits = c.splits;
    for (int k = 0; k < MONO_GEMMS; ++k) {
        P.g[k].count = 0;
        P.sp[k].part = c.sp1.part;  // every stage's partials in one region
    }
    auto move = [&](const GemmBatch& from, const SplitPlan& sp, int p, int k) {
        GemmBatch& g = P.g[k];
        P.sp[k].off[g.count] = sp.off[p];
        g.p[g.count++] = from.p[p];
    };
    for (int p = 0; p < c.c1.count; ++p) move(c.c1, c.sp1, p, c.phase1[p]);
    for (int p = 0; p < c.c2.count; ++p) move(c.c2, c.sp2, p, c.phase2[p]);
    P.g[MONO_GRAMS] = c.c3;
    P.sp[MONO_GRAMS] = c.sp3;
    P.g[MONO_UPDATES] = c.d;
    P.sp[MONO_UPDATES] = c.spd;
    // a phase's GEMM tasks: its tiles times the bands; its sums, when split
    int gt[MONO_GEMMS], gs[MONO_GEMMS];
    for (int k = 0; k < MONO_GEMMS; ++k) {
        GemmBatch& g = P.g[k];
        g.tiles[0] = 0;
        for (int p = 0; p < g.count; ++p)
            g.tiles[p + 1] = g.tiles[p] + ((g.p[p].M + 63) / 64) * ((g.p[p].N + 63) / 64);
        gt[k] = g.tiles[g.count] * P.splits;
        gs[k] = P.splits > 1 ? sum_blocks(g) : 0;
    }
    // the phases; a segment or a phase with no task is dropped
    const TriBatch& t = P.tri;
    const int tri_ph = t.count ? tri_phases(t) : 0;
    // past one level, K3's last temporaries lie outside the 64-aligned
    // diagonal blocks of the inverses, the only part that the cut K bands
    // of the next products' 64 x 64 tiles read: they are zeroed beside them
    const bool merge = t.levels >= 2;
    auto tri_tasks = [&](int ph) { return ph < tri_ph ? tri_phase_tasks(t, ph) : 0; };
    P.nphases = 0;
    int most = 1;
    auto phase = [&](std::initializer_list<MonoSegment> segs) {
        MonoPhase& F = P.phases[P.nphases];
        F.count = 0;
        int total = 0;
        for (const MonoSegment& sg : segs)
            if (sg.tasks > 0) { F.seg[F.count++] = sg; total += sg.tasks; }
        if (total) { ++P.nphases; most = std::max(most, total); }
    };
    const int tri_last = merge ? tri_ph - 1 : tri_ph;  // K3's phases run alone below it
    phase({{SEG_BALANCE, 0, P.bal_blocks * P.bal.count}});
    phase({{SEG_TRI, 0, tri_tasks(0)}, {SEG_ARROW, 0, P.arrows.blocks[P.arrows.count]},
           {SEG_GEMM, MONO_EARLY, gt[MONO_EARLY]}});
    // the early products' sums beside K3's first level, or alone
    phase({{SEG_TRI, 1, tri_last > 1 ? tri_tasks(1) : 0}, {SEG_SUM, MONO_EARLY, gs[MONO_EARLY]}});
    for (int ph = 2; ph < tri_last; ++ph) phase({{SEG_TRI, ph, tri_tasks(ph)}});
    phase({{SEG_TRI, tri_ph - 1, merge ? tri_tasks(tri_ph - 1) : 0}, {SEG_GEMM, MONO_C1, gt[MONO_C1]}});
    phase({{SEG_SUM, MONO_C1, gs[MONO_C1]}});
    phase({{SEG_GEMM, MONO_C2, gt[MONO_C2]}});
    phase({{SEG_SUM, MONO_C2, gs[MONO_C2]}});
    phase({{SEG_GEMM, MONO_GRAMS, gt[MONO_GRAMS]}, {SEG_STATS, 0, P.stats.blocks[P.stats.count]}});
    phase({{SEG_SUM, MONO_GRAMS, gs[MONO_GRAMS]}});
    phase({{SEG_GEMM, MONO_UPDATES, gt[MONO_UPDATES]}, {SEG_VEC, 0, P.vecs.blocks[P.vecs.count]}});
    phase({{SEG_SUM, MONO_UPDATES, gs[MONO_UPDATES]}});
    int per_sm = 0, sms = 0;
    cudaError_t e = mono_resident(&per_sm, &sms);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&P};
    e = cudaLaunchCooperativeKernel((const void*)kron_mono_kernel, dim3(std::min(most, per_sm * sms)),
                                    dim3(256), args, MONO_SMEM, stream);
    const cudaError_t last = cudaGetLastError();  // clears the launch's error either way
    return e != cudaSuccess ? e : last;
}

// The list's route: the one launch where the sweep measured it faster (a
// list with a sparse side, its products in the 64 x 64 tiles and
// KRON_MONO_MAX_MFLOP at most), else the chain; `route` forces either. A forced one launch on a list
// whose products take the 128 x 128 tiles is refused. *took: the route run.
static int run_chain(int L, const int* kind, void** ql, void** qr, void** dx, void** dg,
                     void** out_ql, void** out_qr, const int* m, const int* n, float step,
                     void* scratch, cudaStream_t stream, int route, int* took) {
    ChainPlan c;
    build_chain(L, kind, ql, qr, dx, dg, out_ql, out_qr, m, n, step, static_cast<float*>(scratch),
                c);
    const bool tiles64 = chain_tiles64(c);
    if (route == ROUTE_AUTO) {
        bool sparse = false;
        for (int l = 0; l < L; ++l) sparse |= kind[l] != KIND_DD;
        route = sparse && tiles64 && chain_flops(L, kind, m, n) <= KRON_MONO_MAX_MFLOP * 1e6
                    ? ROUTE_MONO : ROUTE_CHAIN;
    }
    if (route == ROUTE_MONO && !tiles64) return (int)cudaErrorInvalidValue;
    *took = route;
    if (route == ROUTE_MONO) return (int)launch_mono(c, step, stream);
    launch_chain(c, step, stream);
    return (int)cudaGetLastError();
}

// K1, K2, K5 and K20: desc holds 9 int64 a layer, {kind, m, n, ql, qr, dx,
// dg, out_ql, out_qr}, then one slot where the route run is written
// (ROUTE_CHAIN or ROUTE_MONO); route: ROUTE_AUTO, or one forced.
extern "C" int psgd_kron_multi_update(int L, long long* desc, float step, void* scratch,
                                      void* stream_ptr, int route) {
    if (L < 1 || L > PSGD_MAX_LAYERS || route < ROUTE_AUTO || route > ROUTE_MONO)
        return (int)cudaErrorInvalidValue;
    int kind[PSGD_MAX_LAYERS], m[PSGD_MAX_LAYERS], n[PSGD_MAX_LAYERS];
    void *ptr[6][PSGD_MAX_LAYERS];
    for (int l = 0; l < L; ++l) {
        const long long* d = desc + 9 * l;
        kind[l] = (int)d[0];
        m[l] = (int)d[1];
        n[l] = (int)d[2];
        for (int k = 0; k < 6; ++k) ptr[k][l] = reinterpret_cast<void*>(d[3 + k]);
    }
    if (!valid(L, kind, m, n)) return (int)cudaErrorInvalidValue;
    int took = 0;
    const int rc = run_chain(L, kind, ptr[0], ptr[1], ptr[2], ptr[3], ptr[4], ptr[5], m, n, step,
                             scratch, static_cast<cudaStream_t>(stream_ptr), route, &took);
    desc[9 * L] = took;
    return rc;
}
