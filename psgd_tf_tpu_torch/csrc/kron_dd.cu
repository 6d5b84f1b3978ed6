// K1/K2: the (dense, dense) Kronecker factor update for a list of layers.
//
// Replaces psgd_tf_tpu/ops/pallas/kron_multi.py `fused_update_multi` (:222,
// its pallas_call at :202, dd kind) and psgd_tf_tpu/ops/pallas/kron_dd.py
// `fused_update` (:181, the single-layer kernel at :210): the lone layer is
// the L = 1 case of the same chain. Per layer, with balanced factors
//   rho = sqrt(max diag Ql / max diag Qr),  Ql <- Ql / rho,  Qr <- rho Qr:
//   A     = Ql dG Qr^T
//   Bt    = Ql^{-T} dX Qr^{-1}
//   grad1 = triu(A A^T - Bt Bt^T),  grad2 = triu(A^T A - Bt^T Bt)
//   Ql'   = Ql - s1 grad1 Ql,  s1 = min(step / (max|grad1| + tiny), FLT_MAX)
//   Qr'   = Qr - s2 grad2 Qr   (likewise)
//
// The TPU kernel keeps every layer resident in VMEM and does all of this in
// one launch. Hopper cannot: one 257x257 fp32 factor (LeNet5's largest) is
// 264 KB, more than a block's 227 KB of shared memory. So the update is a
// short FIXED chain of grouped launches, each covering every layer of the
// list, with no host synchronisation between them:
//   (a) balance_kernel   rho on the device, balanced copies to scratch,
//                        the max|grad| slots zeroed;
//   (b) tri.cu           exact inverses of both balanced factors (K3);
//   (c) gemm_kernel x4   a hand-written grouped fp32 tiled GEMM over
//                        per-problem descriptors:
//                        [T1 = dG Qr^T, W = Ql^{-T} dX],
//                        [A = Ql T1,    Bt = W Qr^{-1}],
//                        [grad1, grad2] each as ONE product over the
//                        concatenated [A | Bt] (the Bt half subtracted), with
//                        a triu epilogue and max|grad| by block reduction
//                        plus atomicMax on the float bits (a max does not
//                        depend on order, so the result is deterministic),
//   (d)                  [Ql', Qr'] = Q - s grad Q, s read on the device.
// Seven launches per step for the whole list; no product goes to cuBLAS.
//
// What bounds it on this card: latency, not FLOPs or bytes. LeNet5's five
// layers need 164 MFLOP per step in all (most in the (257, 120) layer) and
// a few MB of traffic, yet each stage is only a few dozen 64x64 tiles, and
// each tile's block walks its whole K loop (up to 2 * 257) alone. Measured
// on an H100 80GB HBM3 at its 700 W limit: 0.30 ms of device time per
// step for the chain, 57 us per GEMM launch on average. Grouping every
// layer into each launch keeps the launch count fixed as layers are added;
// split-K or wgmma tiles are the next step once it matters end to end.
//
// One difference from the Pallas kernel: kron_dd._finish (kron_dd.py:150-151)
// divides step / (max + tiny) WITHOUT the saturation of linalg.step_scale,
// so a zero probe gives inf * 0 = NaN there. This chain saturates at
// FLT_MAX, as the XLA path and the port's plain version do, so a zero
// group gradient gives a zero update.
#include "psgd.cuh"

#include <algorithm>
#include <cfloat>
#include <cstdint>

#define GEMM_BM 64
#define GEMM_BN 64
#define GEMM_BK 16
#define GEMM_THREADS 256
#define MAX_GEMMS (2 * PSGD_MAX_LAYERS)

enum Epilogue { EPI_STORE = 0, EPI_TRIU_MAX = 1, EPI_UPDATE = 2 };

// C (M x N) = op(a) op(b) [- op(a2) op(b2)], op(X) = X or X^T by flag.
// op(a) is M x K: a[i*lda + k], or a[k*lda + i] when ta. op(b) is K x N:
// b[k*ldb + j], or b[j*ldb + k] when tb. a2/b2 share the flags and strides.
struct GemmProb {
    const float* a;
    const float* b;
    const float* a2;     // nullptr: no second product
    const float* b2;
    float* c;            // ldc == N
    const float* q;      // EPI_UPDATE: the factor being updated, (M, N)
    unsigned int* mx;    // EPI_TRIU_MAX writes, EPI_UPDATE reads max|grad|
    float step;
    int M, N, K, lda, ldb, ta, tb, epi;
};

struct GemmBatch {
    GemmProb p[MAX_GEMMS];
    int tiles[MAX_GEMMS + 1];
    int count;
};

struct BalanceLayer {
    const float* ql;
    const float* qr;
    float* qlb;
    float* qrb;
    unsigned int* mx;  // two max|grad| slots, zeroed here
    int m, n;
};

struct BalanceBatch {
    BalanceLayer l[PSGD_MAX_LAYERS];
    int count;
};

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

// grid (blocks per layer, layers); every block recomputes its layer's
// diagonal maxima (m + n loads) and scales its share of both factors.
__global__ void __launch_bounds__(256) balance_kernel(const BalanceBatch b) {
    const BalanceLayer L = b.l[blockIdx.y];
    __shared__ float red[8];
    float ml = -INFINITY, mr = -INFINITY;
    for (int i = threadIdx.x; i < L.m; i += blockDim.x) ml = fmaxf(ml, L.ql[(size_t)i * L.m + i]);
    for (int i = threadIdx.x; i < L.n; i += blockDim.x) mr = fmaxf(mr, L.qr[(size_t)i * L.n + i]);
    ml = block_reduce_max(ml, red);
    mr = block_reduce_max(mr, red);
    const float rho = sqrtf(ml / mr);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        L.mx[0] = 0u;
        L.mx[1] = 0u;
    }
    const size_t mm = (size_t)L.m * L.m, total = mm + (size_t)L.n * L.n;
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += (size_t)gridDim.x * blockDim.x) {
        if (e < mm) L.qlb[e] = L.ql[e] / rho;
        else L.qrb[e - mm] = rho * L.qr[e - mm];
    }
}

__device__ __forceinline__ float load_a(const GemmProb& P, const float* a, int i, int k) {
    if (i >= P.M || k >= P.K) return 0.f;
    return P.ta ? a[(size_t)k * P.lda + i] : a[(size_t)i * P.lda + k];
}

__device__ __forceinline__ float load_b(const GemmProb& P, const float* b, int k, int j) {
    if (k >= P.K || j >= P.N) return 0.f;
    return P.tb ? b[(size_t)j * P.ldb + k] : b[(size_t)k * P.ldb + j];
}

// One 64x64 output tile per block, 256 threads, 4x4 outputs per thread.
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(const GemmBatch g) {
    int p = 0;
    while (p + 1 < g.count && (int)blockIdx.x >= g.tiles[p + 1]) ++p;
    const GemmProb& P = g.p[p];
    const int t = blockIdx.x - g.tiles[p];
    const int tiles_n = (P.N + GEMM_BN - 1) / GEMM_BN;
    const int row0 = (t / tiles_n) * GEMM_BM, col0 = (t % tiles_n) * GEMM_BN;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    __shared__ float As[GEMM_BK][GEMM_BM + 4];
    __shared__ float Bs[GEMM_BK][GEMM_BN + 4];
    __shared__ float red[GEMM_THREADS / 32];

    float acc[4][4] = {};
    // a tile wholly below the diagonal of a triu output is zero: skip the K loop
    const bool skip = P.epi == EPI_TRIU_MAX && row0 > col0 + GEMM_BN - 1;
    for (int pass = 0; pass < 2 && !skip; ++pass) {
        const float* a = pass ? P.a2 : P.a;
        const float* b = pass ? P.b2 : P.b;
        if (a == nullptr) break;
        const float sign = pass ? -1.f : 1.f;
        for (int k0 = 0; k0 < P.K; k0 += GEMM_BK) {
            for (int e = threadIdx.x; e < GEMM_BK * GEMM_BM; e += GEMM_THREADS) {
                // for a transposed operand, consecutive threads walk the
                // contiguous dimension of memory
                int kk, ii;
                if (P.ta) { kk = e / GEMM_BM; ii = e % GEMM_BM; }
                else { ii = e / GEMM_BK; kk = e % GEMM_BK; }
                As[kk][ii] = load_a(P, a, row0 + ii, k0 + kk);
            }
            for (int e = threadIdx.x; e < GEMM_BK * GEMM_BN; e += GEMM_THREADS) {
                int kk, jj;
                if (P.tb) { jj = e / GEMM_BK; kk = e % GEMM_BK; }
                else { kk = e / GEMM_BN; jj = e % GEMM_BN; }
                Bs[kk][jj] = sign * load_b(P, b, k0 + kk, col0 + jj);
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < GEMM_BK; ++kk) {
                float av[4], bv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) av[r] = As[kk][ty + 16 * r];
#pragma unroll
                for (int c = 0; c < 4; ++c) bv[c] = Bs[kk][tx + 16 * c];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[r][c] += av[r] * bv[c];
            }
            __syncthreads();
        }
    }

    float s = 0.f;
    if (P.epi == EPI_UPDATE)
        s = fminf(P.step / (__uint_as_float(*P.mx) + psgd_tiny()), FLT_MAX);
    float local_max = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = row0 + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int j = col0 + tx + 16 * c;
            if (i >= P.M || j >= P.N) continue;
            const size_t o = (size_t)i * P.N + j;
            float v = acc[r][c];
            if (P.epi == EPI_TRIU_MAX) {
                v = (i <= j) ? v : 0.f;
                local_max = fmaxf(local_max, fabsf(v));
            } else if (P.epi == EPI_UPDATE) {
                v = P.q[o] - s * v;
            }
            P.c[o] = v;
        }
    }
    if (P.epi == EPI_TRIU_MAX) {
        // |grad| >= 0, so its float bits order like unsigned integers
        local_max = block_reduce_max(local_max, red);
        if (threadIdx.x == 0) atomicMax(P.mx, __float_as_uint(local_max));
    }
}

static void launch_gemms(GemmBatch& g, cudaStream_t stream) {
    g.tiles[0] = 0;
    for (int p = 0; p < g.count; ++p) {
        const GemmProb& P = g.p[p];
        g.tiles[p + 1] = g.tiles[p] + ((P.M + GEMM_BM - 1) / GEMM_BM) * ((P.N + GEMM_BN - 1) / GEMM_BN);
    }
    gemm_kernel<<<g.tiles[g.count], GEMM_THREADS, 0, stream>>>(g);
}

static GemmProb prob(const float* a, int ta, int lda, const float* b, int tb, int ldb,
                     float* c, int M, int N, int K) {
    GemmProb P = {};
    P.a = a; P.b = b; P.c = c;
    P.ta = ta; P.tb = tb; P.lda = lda; P.ldb = ldb;
    P.M = M; P.N = N; P.K = K;
    P.epi = EPI_STORE;
    return P;
}

static size_t align4(size_t x) { return (x + 3) & ~(size_t)3; }

// Scratch per layer, in floats: Qlb, Linv, grad1 (m^2 each); Qrb, Rinv,
// grad2 (n^2 each); T1, A, W, Bt (m n each); after 2L max|grad| slots.
extern "C" size_t psgd_kron_dd_scratch_floats(int L, const int* m, const int* n) {
    size_t total = align4(2 * (size_t)L);
    for (int l = 0; l < L; ++l) {
        const size_t mm = align4((size_t)m[l] * m[l]), nn = align4((size_t)n[l] * n[l]);
        total += 3 * mm + 3 * nn + 4 * align4((size_t)m[l] * n[l]);
    }
    return total;
}

extern "C" int psgd_kron_dd_update(int L, void** ql, void** qr, void** dx, void** dg,
                                   void** out_ql, void** out_qr, const int* m, const int* n,
                                   float step, void* scratch, void* stream_ptr) {
    if (L < 1 || L > PSGD_MAX_LAYERS) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    float* base = static_cast<float*>(scratch);
    unsigned int* mx = reinterpret_cast<unsigned int*>(base);
    float* cur = base + align4(2 * (size_t)L);
    auto take = [&](size_t count) { float* p = cur; cur += align4(count); return p; };

    struct LayerScratch { float *qlb, *linv, *g1, *qrb, *rinv, *g2, *t1, *a, *w, *bt; };
    LayerScratch s[PSGD_MAX_LAYERS];
    BalanceBatch bal;
    bal.count = L;
    TriBatch tri;
    tri.count = 2 * L;
    int max_side = 1;
    for (int l = 0; l < L; ++l) {
        if (m[l] < 1 || n[l] < 1) return (int)cudaErrorInvalidValue;
        const size_t mm = (size_t)m[l] * m[l], nn = (size_t)n[l] * n[l], mn = (size_t)m[l] * n[l];
        s[l].qlb = take(mm); s[l].linv = take(mm); s[l].g1 = take(mm);
        s[l].qrb = take(nn); s[l].rinv = take(nn); s[l].g2 = take(nn);
        s[l].t1 = take(mn); s[l].a = take(mn); s[l].w = take(mn); s[l].bt = take(mn);
        bal.l[l] = {static_cast<const float*>(ql[l]), static_cast<const float*>(qr[l]),
                    s[l].qlb, s[l].qrb, mx + 2 * l, m[l], n[l]};
        tri.u[2 * l] = s[l].qlb;     tri.x[2 * l] = s[l].linv;     tri.n[2 * l] = m[l];
        tri.u[2 * l + 1] = s[l].qrb; tri.x[2 * l + 1] = s[l].rinv; tri.n[2 * l + 1] = n[l];
        max_side = std::max(max_side, std::max(m[l], n[l]));
    }

    // (a) balance: enough blocks per layer for the largest factor pair
    const int bal_blocks = std::min(64, std::max(1, (2 * max_side * max_side + 4095) / 4096));
    balance_kernel<<<dim3(bal_blocks, L), 256, 0, stream>>>(bal);
    // (b) K3 on both balanced factors of every layer
    launch_tri_inv(tri, stream);

    GemmBatch g;
    // (c1) T1 = dG Qr^T,  W = Linv^T dX
    g.count = 2 * L;
    for (int l = 0; l < L; ++l) {
        const int M = m[l], N = n[l];
        g.p[2 * l] = prob(static_cast<const float*>(dg[l]), 0, N, s[l].qrb, 1, N, s[l].t1, M, N, N);
        g.p[2 * l + 1] = prob(s[l].linv, 1, M, static_cast<const float*>(dx[l]), 0, N, s[l].w, M, N, M);
    }
    launch_gemms(g, stream);
    // (c2) A = Qlb T1,  Bt = W Rinv
    for (int l = 0; l < L; ++l) {
        const int M = m[l], N = n[l];
        g.p[2 * l] = prob(s[l].qlb, 0, M, s[l].t1, 0, N, s[l].a, M, N, M);
        g.p[2 * l + 1] = prob(s[l].w, 0, N, s[l].rinv, 0, N, s[l].bt, M, N, N);
    }
    launch_gemms(g, stream);
    // (c3) grad1 = triu([A|Bt] [A|-Bt]^T) (m x m, K = 2n),
    //      grad2 = triu([A|Bt]^T [A|-Bt]) (n x n, K = 2m), with max|grad|
    for (int l = 0; l < L; ++l) {
        const int M = m[l], N = n[l];
        GemmProb g1 = prob(s[l].a, 0, N, s[l].a, 1, N, s[l].g1, M, M, N);
        g1.a2 = s[l].bt; g1.b2 = s[l].bt; g1.epi = EPI_TRIU_MAX; g1.mx = mx + 2 * l;
        GemmProb g2 = prob(s[l].a, 1, N, s[l].a, 0, N, s[l].g2, N, N, M);
        g2.a2 = s[l].bt; g2.b2 = s[l].bt; g2.epi = EPI_TRIU_MAX; g2.mx = mx + 2 * l + 1;
        g.p[2 * l] = g1;
        g.p[2 * l + 1] = g2;
    }
    launch_gemms(g, stream);
    // (d) Q' = Q - s grad Q, s = min(step / (max|grad| + tiny), FLT_MAX)
    for (int l = 0; l < L; ++l) {
        const int M = m[l], N = n[l];
        GemmProb u1 = prob(s[l].g1, 0, M, s[l].qlb, 0, M, static_cast<float*>(out_ql[l]), M, M, M);
        u1.epi = EPI_UPDATE; u1.q = s[l].qlb; u1.mx = mx + 2 * l; u1.step = step;
        GemmProb u2 = prob(s[l].g2, 0, N, s[l].qrb, 0, N, static_cast<float*>(out_qr[l]), N, N, N);
        u2.epi = EPI_UPDATE; u2.q = s[l].qrb; u2.mx = mx + 2 * l + 1; u2.step = step;
        g.p[2 * l] = u1;
        g.p[2 * l + 1] = u2;
    }
    launch_gemms(g, stream);
    return (int)cudaGetLastError();
}
