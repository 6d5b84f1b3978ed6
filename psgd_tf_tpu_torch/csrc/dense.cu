// K11 and K12: the dense-family rank-2 Lie-group update, with the optional
// fused apply.
//
// Replaces psgd_tf_tpu/ops/pallas/dense_upd.py `fused_update` /
// `fused_update_apply` (:136/:149, `_call` :90, its pallas_call at :116,
// `_kernel` :39), which holds Q resident in VMEM for n <= 1536, and
// psgd_tf_tpu/ops/pallas/dense_big.py `fused_update` / `fused_update_apply`
// (:351/:364, `_stages` :230, its pallas_calls at :272, :290, :317 and
// :332), which streams Q for n <= 16384. Both compute, for Q (n, n) upper
// triangular:
//   a = Q h,  b = Q^{-T} v
//   s0 = min(step / (max|triu(a a^T - b b^T)| + tiny), FLT_MAX)
//   Q' = Q - s0 (a * S_a - b * S_b),  S_x[r, :] = sum_{j >= r} x_j Q[j, :]
//   with g: P' g = Q'^T (Q' g)
// The TPU split between the two kernels is a VMEM split. Q at n = 1536 is
// 9.4 MB and fits no block's 227 KB of shared memory, so on Hopper both
// entry points run this one chain, streaming Q in tiles of DP rows by DC
// columns (the Python wrappers keep the JAX caps for routing and count
// their launches apart).
//
// The TPU kernels carry state across grid steps that run in order; CUDA
// blocks do not. The chain, all on `stream`, no host synchronisation:
//   1. the DP x DP diagonal blocks of Q are gathered (identity past n) and
//      inverted by K3 (tri.cu), exact in fp32;
//   2. the solve Q^T b = v is a blocked forward substitution over row
//      panels, ONE launch per panel p (nb launches): every block of launch
//      p finishes b_p = Dinv_p^T (v_p - acc_p) from the prefix sums acc
//      that launches < p completed, then takes one DP x DC tile of row
//      panel p: it adds the tile's share of a = Q h to a per-chunk partial,
//      and, right of the panel, pushes b_p's contribution into acc for its
//      own columns. Q's upper triangle is read once for a and b together.
//      A launch per panel was chosen over one persistent block per column
//      strip (which would spin on flags set by other blocks and hangs if
//      they are not co-resident) and over the explicit inverse (O(n^3)).
//      The a-partials are summed per row in a fixed order;
//   3. max|triu(a a^T - b b^T)| from a and b alone (O(n) bytes), by block
//      maxima and atomicMax on the float bits: a max does not depend on the
//      order, so the result is deterministic;
//   4. per row panel, the column sums sum_{i in panel} a_i Q[i, j] (and
//      b's); an exclusive suffix scan over panels in a fixed order gives
//      each panel its carry;
//   5. the rewrite, per tile: the intra-panel reverse running sums start
//      from the carry, Q' is written for the upper part and the tiles below
//      the diagonal are written as exact zeros. With g, each tile adds its
//      share of Q' g to a per-chunk partial;
//   6. with g: Q' g summed per row, then P' g = Q'^T (Q' g) as step 4's
//      column sums over Q' and a suffix total.
// No float atomics anywhere a sum is taken: a run repeats itself bit for bit.
//
// What bounds it on this card: memory for large n (Q is read and written;
// the JAX kernel's minimum is 2 n^2 floats, 2.15 GB at n = 16384, 641 us at
// 3.35 TB/s). This chain reads an upper triangle four times (Q in steps
// 2, 4 and 5, Q' in step 6) and writes Q' once, lower zeros included, so
// it moves ~1.5x that minimum; and step 2's nb launches are each short, so
// latency bounds it at small n. Fusing 4 into 2 and the apply into 5 is
// later work.
#include "psgd.cuh"

#include <cfloat>

#define DP 128           // rows of a panel (= the diagonal block K3 inverts)
#define DC 64            // columns of a chunk
#define DTHREADS 256
#define DGROUPS (DTHREADS / DC)  // row groups of a tile: 4 of 32 rows

static inline int dense_panels(int n) { return (n + DP - 1) / DP; }
static inline int dense_chunks(int n) { return (n + DC - 1) / DC; }

__device__ __forceinline__ float dense_step(float step, const unsigned int* mx) {
    return fminf(step / (__uint_as_float(*mx) + psgd_tiny()), FLT_MAX);
}

// diag[p] = Q[p DP.., p DP..] as a contiguous DP x DP block, identity past n
__global__ void __launch_bounds__(DTHREADS) dense_gather_diag_kernel(int n, const float* __restrict__ q,
                                                                     float* __restrict__ diag) {
    const int p = blockIdx.x;
    float* out = diag + (size_t)p * DP * DP;
    for (int e = threadIdx.x; e < DP * DP; e += DTHREADS) {
        const int r = e / DP, c = e % DP, i = p * DP + r, j = p * DP + c;
        out[e] = (i < n && j < n) ? q[(size_t)i * n + j] : (r == c ? 1.f : 0.f);
    }
}

// step 2, launch p: chunks c = p * DP / DC .. nch - 1, one per block
__global__ void __launch_bounds__(DTHREADS) dense_probe_kernel(
    int n, int p, const float* __restrict__ q, const float* __restrict__ v,
    const float* __restrict__ h, const float* __restrict__ dinv, float* __restrict__ acc,
    float* __restrict__ bvec, float* __restrict__ apart) {
    const int c = p * (DP / DC) + blockIdx.x;
    const int r0 = p * DP, c0 = c * DC, t = threadIdx.x;
    __shared__ float tile[DP][DC + 1];
    __shared__ float sr[DP], sb[DP], sh[DC];
    __shared__ float red[DGROUPS][DC];
    if (t < DP) {
        const int i = r0 + t;
        sr[t] = i < n ? v[i] - acc[i] : 0.f;
    } else if (t < DP + DC) {
        const int j = c0 + t - DP;
        sh[t - DP] = j < n ? h[j] : 0.f;
    }
    for (int e = t; e < DP * DC; e += DTHREADS) {
        const int rr = e / DC, cc = e % DC, i = r0 + rr, j = c0 + cc;
        tile[rr][cc] = (i < n && j < n) ? q[(size_t)i * n + j] : 0.f;
    }
    __syncthreads();
    if (t < DP) {
        // b_p[t] = sum_{i <= t} Dinv_p[i, t] r_i  (Dinv_p upper triangular)
        const float* D = dinv + (size_t)p * DP * DP;
        float s = 0.f;
        for (int i = 0; i <= t; ++i) s += D[(size_t)i * DP + t] * sr[i];
        sb[t] = s;
        if (blockIdx.x == 0 && r0 + t < n) bvec[r0 + t] = s;
    } else {
        // this tile's share of a = Q h for row rr, upper part only
        const int rr = t - DP, i = r0 + rr;
        float s = 0.f;
        for (int cc = 0; cc < DC; ++cc)
            if (c0 + cc >= i) s += tile[rr][cc] * sh[cc];
        if (i < n) apart[(size_t)c * n + i] = s;
    }
    if (c0 < r0 + DP) return;  // the panel's own columns: solved by b_p itself
    __syncthreads();
    const int cc = t % DC, grp = t / DC;
    float s = 0.f;
    for (int rr = grp * (DP / DGROUPS); rr < (grp + 1) * (DP / DGROUPS); ++rr) s += sb[rr] * tile[rr][cc];
    red[grp][cc] = s;
    __syncthreads();
    if (t < DC && c0 + t < n) {
        float tot = 0.f;
        for (int k = 0; k < DGROUPS; ++k) tot += red[k][t];
        acc[c0 + t] += tot;
    }
}

// out_i = sum over chunks of part[c, i]; from the first chunk of row i's
// panel when from_panel (the probe wrote no partials left of it), else all
__global__ void __launch_bounds__(256) dense_sum_chunks_kernel(int n, int nch, int from_panel,
                                                               const float* __restrict__ part,
                                                               float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float s = 0.f;
    for (int c = from_panel ? (i / DP) * (DP / DC) : 0; c < nch; ++c) s += part[(size_t)c * n + i];
    out[i] = s;
}

// step 3: 64 x 64 tiles of the upper triangle of |a a^T - b b^T|
__global__ void __launch_bounds__(DTHREADS) dense_maxabs_kernel(int n, const float* __restrict__ a,
                                                                const float* __restrict__ b,
                                                                unsigned int* __restrict__ mx) {
    if (blockIdx.y > blockIdx.x) return;  // wholly below the diagonal
    const int i0 = blockIdx.y * 64, j0 = blockIdx.x * 64, t = threadIdx.x;
    __shared__ float ra[64], rb[64], ca[64], cb[64], red[DTHREADS / 32];
    if (t < 64) {
        const int i = i0 + t;
        ra[t] = i < n ? a[i] : 0.f;
        rb[t] = i < n ? b[i] : 0.f;
    } else if (t < 128) {
        const int j = j0 + t - 64;
        ca[t - 64] = j < n ? a[j] : 0.f;
        cb[t - 64] = j < n ? b[j] : 0.f;
    }
    __syncthreads();
    float m = 0.f;
    for (int e = t; e < 64 * 64; e += DTHREADS) {
        const int rr = e / 64, cc = e % 64;
        if (i0 + rr <= j0 + cc && j0 + cc < n) m = fmaxf(m, fabsf(ra[rr] * ca[cc] - rb[rr] * cb[cc]));
    }
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((t & 31) == 0) red[t >> 5] = m;
    __syncthreads();
    if (t == 0) {
        for (int k = 1; k < DTHREADS / 32; ++k) m = fmaxf(m, red[k]);
        atomicMax(mx, __float_as_uint(m));
    }
}

// steps 4 and 6: part_k[p, j] = sum_{i in panel p, i <= j} w_k[i] Q[i, j]
// (w2 may be null); a tile wholly below the diagonal writes zeros
__global__ void __launch_bounds__(DTHREADS) dense_colsum_kernel(
    int n, const float* __restrict__ q, const float* __restrict__ w1, const float* __restrict__ w2,
    float* __restrict__ part1, float* __restrict__ part2) {
    const int c0 = blockIdx.x * DC, p = blockIdx.y, r0 = p * DP, t = threadIdx.x;
    const int cc = t % DC, grp = t / DC, j = c0 + cc;
    __shared__ float red[2][DGROUPS][DC];
    float s1 = 0.f, s2 = 0.f;
    if (r0 <= c0 + DC - 1 && j < n) {
        const int lo = r0 + grp * (DP / DGROUPS);
        const int hi = min(min(lo + DP / DGROUPS, n), j + 1);
        for (int i = lo; i < hi; ++i) {
            const float x = q[(size_t)i * n + j];
            s1 += w1[i] * x;
            if (w2) s2 += w2[i] * x;
        }
    }
    red[0][grp][cc] = s1;
    red[1][grp][cc] = s2;
    __syncthreads();
    if (t < DC && c0 + t < n) {
        float a1 = 0.f, a2 = 0.f;
        for (int k = 0; k < DGROUPS; ++k) {
            a1 += red[0][k][t];
            a2 += red[1][k][t];
        }
        part1[(size_t)p * n + c0 + t] = a1;
        if (w2) part2[(size_t)p * n + c0 + t] = a2;
    }
}

// carry[p, j] = sum_{p' > p} part[p', j] (exclusive suffix over panels, in
// a fixed order); total[j] = the sum over every panel. Either may be null.
__global__ void __launch_bounds__(256) dense_suffix_kernel(int n, int nb, const float* __restrict__ part,
                                                           float* __restrict__ carry,
                                                           float* __restrict__ total) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    float run = 0.f;
    for (int p = nb - 1; p >= 0; --p) {
        if (carry) carry[(size_t)p * n + j] = run;
        run += part[(size_t)p * n + j];
    }
    if (total) total[j] = run;
}

// step 5: Q' for one DP x DC tile, and with g its share of Q' g
__global__ void __launch_bounds__(DTHREADS) dense_rewrite_kernel(
    int n, const float* __restrict__ q, const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ cara, const float* __restrict__ carb, const unsigned int* __restrict__ mx,
    float step, const float* __restrict__ g, float* __restrict__ qout, float* __restrict__ upart) {
    const int c = blockIdx.x, p = blockIdx.y, c0 = c * DC, r0 = p * DP, t = threadIdx.x;
    const int cc = t % DC, grp = t / DC, j = c0 + cc;
    if (r0 > c0 + DC - 1) {  // wholly below the diagonal: exact zeros
        for (int e = t; e < DP * DC; e += DTHREADS) {
            const int i = r0 + e / DC, jj = c0 + e % DC;
            if (i < n && jj < n) qout[(size_t)i * n + jj] = 0.f;
        }
        if (g && t < DP && r0 + t < n) upart[(size_t)c * n + r0 + t] = 0.f;
        return;
    }
    __shared__ float tile[DP][DC + 1];
    __shared__ float sa[DP], sb[DP], sg[DC];
    __shared__ float red[2][DGROUPS][DC];
    if (t < DP) {
        const int i = r0 + t;
        sa[t] = i < n ? a[i] : 0.f;
        sb[t] = i < n ? b[i] : 0.f;
    } else if (t < DP + DC) {
        const int jj = c0 + t - DP;
        sg[t - DP] = (g && jj < n) ? g[jj] : 0.f;
    }
    for (int e = t; e < DP * DC; e += DTHREADS) {
        const int rr = e / DC, k = e % DC, i = r0 + rr, jj = c0 + k;
        tile[rr][k] = (i < n && jj < n && i <= jj) ? q[(size_t)i * n + jj] : 0.f;
    }
    __syncthreads();
    const int lo = grp * (DP / DGROUPS), hi = lo + DP / DGROUPS;
    float ga = 0.f, gb = 0.f;
    for (int rr = lo; rr < hi; ++rr) {
        ga += sa[rr] * tile[rr][cc];
        gb += sb[rr] * tile[rr][cc];
    }
    red[0][grp][cc] = ga;
    red[1][grp][cc] = gb;
    __syncthreads();
    const float s0 = dense_step(step, mx);
    float run_a = 0.f, run_b = 0.f;
    if (j < n) {
        run_a = cara[(size_t)p * n + j];
        run_b = carb[(size_t)p * n + j];
    }
    for (int k = DGROUPS - 1; k > grp; --k) {
        run_a += red[0][k][cc];
        run_b += red[1][k][cc];
    }
    for (int rr = hi - 1; rr >= lo; --rr) {
        const int i = r0 + rr;
        const float x = tile[rr][cc];
        run_a += sa[rr] * x;
        run_b += sb[rr] * x;
        const float y = (i <= j) ? x - s0 * (sa[rr] * run_a - sb[rr] * run_b) : 0.f;
        tile[rr][cc] = y;
        if (i < n && j < n) qout[(size_t)i * n + j] = y;
    }
    if (!g) return;
    __syncthreads();
    if (t < DP && r0 + t < n) {
        float s = 0.f;
        for (int k = 0; k < DC; ++k) s += tile[t][k] * sg[k];
        upart[(size_t)c * n + r0 + t] = s;
    }
}

struct DenseScratch {
    float *diag, *dinv, *acc, *bvec, *avec, *apart, *cola, *colb, *cara, *carb, *upart, *u, *ppart;
    unsigned int* mx;
};

static size_t dense_carve(int n, float* base, DenseScratch* s) {
    const size_t nb = dense_panels(n), nch = dense_chunks(n), nn = n;
    const size_t sizes[] = {nb * DP * DP, nb * DP * DP, nb * DP, nn, nn, nch * nn,
                            nb * nn, nb * nn, nb * nn, nb * nn, nch * nn, nn, nb * nn, 4};
    float** slots[] = {&s->diag, &s->dinv, &s->acc, &s->bvec, &s->avec, &s->apart, &s->cola,
                       &s->colb, &s->cara, &s->carb, &s->upart, &s->u, &s->ppart, nullptr};
    size_t off = 0;
    for (int k = 0; k < 14; ++k) {
        if (base) {
            if (slots[k]) *slots[k] = base + off;
            else s->mx = reinterpret_cast<unsigned int*>(base + off);
        }
        off += psgd_align4(sizes[k]);
    }
    return off;
}

extern "C" size_t psgd_dense_scratch_floats(int n) {
    DenseScratch s;
    return dense_carve(n, nullptr, &s);
}

// Q' (and with g, P' g) for Q (n, n) upper triangular; qout must not alias q.
extern "C" int psgd_dense_update(int n, const void* qp, const void* vp, const void* hp, const void* gp,
                                 float step, void* qoutp, void* prep, void* scratch, void* stream_ptr) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const float* q = static_cast<const float*>(qp);
    const float* g = static_cast<const float*>(gp);
    float* qout = static_cast<float*>(qoutp);
    DenseScratch s;
    dense_carve(n, static_cast<float*>(scratch), &s);
    const int nb = dense_panels(n), nch = dense_chunks(n);
    if (nch > 65535) return (int)cudaErrorInvalidValue;

    // 1. the diagonal blocks and their exact inverses (K3)
    dense_gather_diag_kernel<<<nb, DTHREADS, 0, stream>>>(n, q, s.diag);
    for (int p0 = 0; p0 < nb; p0 += PSGD_MAX_TRI) {
        TriBatch tb;
        tb.count = nb - p0 < PSGD_MAX_TRI ? nb - p0 : PSGD_MAX_TRI;
        for (int k = 0; k < tb.count; ++k) {
            tb.u[k] = s.diag + (size_t)(p0 + k) * DP * DP;
            tb.x[k] = s.dinv + (size_t)(p0 + k) * DP * DP;
            tb.n[k] = DP;
        }
        launch_tri_inv(tb, stream);
    }
    // 2. a = Q h and the forward substitution for b, one launch per panel
    cudaMemsetAsync(s.acc, 0, sizeof(float) * nb * DP, stream);
    for (int p = 0; p < nb; ++p)
        dense_probe_kernel<<<nch - p * (DP / DC), DTHREADS, 0, stream>>>(
            n, p, q, static_cast<const float*>(vp), static_cast<const float*>(hp), s.dinv, s.acc,
            s.bvec, s.apart);
    dense_sum_chunks_kernel<<<(n + 255) / 256, 256, 0, stream>>>(n, nch, 1, s.apart, s.avec);
    // 3. the step normalizer
    cudaMemsetAsync(s.mx, 0, sizeof(unsigned int), stream);
    const int t64 = (n + 63) / 64;
    dense_maxabs_kernel<<<dim3(t64, t64), DTHREADS, 0, stream>>>(n, s.avec, s.bvec, s.mx);
    // 4. per-panel column sums and their suffix carries
    dense_colsum_kernel<<<dim3(nch, nb), DTHREADS, 0, stream>>>(n, q, s.avec, s.bvec, s.cola, s.colb);
    dense_suffix_kernel<<<(n + 255) / 256, 256, 0, stream>>>(n, nb, s.cola, s.cara, nullptr);
    dense_suffix_kernel<<<(n + 255) / 256, 256, 0, stream>>>(n, nb, s.colb, s.carb, nullptr);
    // 5. the rewrite
    dense_rewrite_kernel<<<dim3(nch, nb), DTHREADS, 0, stream>>>(
        n, q, s.avec, s.bvec, s.cara, s.carb, s.mx, step, g, qout, s.upart);
    // 6. P' g = Q'^T (Q' g)
    if (g) {
        dense_sum_chunks_kernel<<<(n + 255) / 256, 256, 0, stream>>>(n, nch, 0, s.upart, s.u);
        dense_colsum_kernel<<<dim3(nch, nb), DTHREADS, 0, stream>>>(n, qout, s.u, nullptr, s.ppart,
                                                                    nullptr);
        dense_suffix_kernel<<<(n + 255) / 256, 256, 0, stream>>>(n, nb, s.ppart, nullptr,
                                                                 static_cast<float*>(prep));
    }
    return (int)cudaGetLastError();
}
