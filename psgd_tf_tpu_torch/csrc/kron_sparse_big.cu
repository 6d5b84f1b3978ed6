// K6 and K10: the streaming sparse-format Kronecker reductions.
//
// K6 replaces psgd_tf_tpu/ops/pallas/kron_sparse_big.py `fused_update_ns`
// (:377, its pallas_call at :412, `_kernel_ns_big` :172): the one pass over
// the (m, n) probes dX and dG of a (norm, scale) layer, n <= 131072, that
// emits, with row m-1 masked (its terms are patched in the caller's tail):
//   a      = (q0_i dGm_ij + q1_i dG_last_j) qr_j,  bt = dXm_ij / q0_i / qr_j
//   diag0_i  = sum_j a^2 - bt^2          biasa_i  = sum_j a A_last_j
//   corr_j   = sum_i w_i dX_ij           colsum_j = sum_i a^2 - bt^2
// On the TPU the grid walks row panels in order and carries corr and colsum
// in VMEM across grid steps. Blocks on Hopper run in no order, so each
// block takes a panel of NS_ROWS rows by NS_COLS columns, writes its column
// partials to a (panels, n) scratch and its row partials to a
// (column splits, m) scratch, and a second small pass sums both in a fixed
// order: no float atomics, so a run repeats itself bit for bit.
// What bounds it: memory. It reads 2mn floats once (18.9 MB at
// (2305, 1024)) and writes 2n floats per 16-row panel plus 2m per
// 1024-column split (1/8 of the probe bytes, read back by the second pass);
// the arithmetic is a dozen flops per element pair. Each thread keeps its
// 16 rows' partial sums in registers and walks 4 columns, so the loads of
// a row are coalesced across a warp. Measured on an H100 80GB HBM3 at its
// 700 W limit: 23 us for the pass at (2305, 1024) (0.82 TB/s) and 40 us at
// (1025, 4935) (1.0 TB/s), plus 6-7 us for the reduction.
//
// K10 replaces the same file's `fused_update_ds` (:711, its pallas_call at
// :740, `_kernel_ds_big` :675): a (dense, scale) layer, m <= 1024, any n:
//   1. Linv = Ql^{-1} through K3 (tri.cu), exact in fp32;
//   2. the grouped GEMM of kron_dd.cu: A = (Ql dG) qr and Bt = (Linv^T dX) / qr
//      over the whole width (column-scale epilogues);
//   3. grad2_j = sum_i A_ij^2 - Bt_ij^2, one thread per column;
//   4. the Gram difference A A^T - Bt Bt^T with K = n, split over column
//      panels into a (splits, m, m) scratch (the TPU grid's own
//      accumulation) and summed in a fixed order by a last small pass.
// What bounds it: the two m x n products (2 m^2 n FLOPs each) and the
// Gram (2 m^2 n again), all in fp32 SIMT tiles, against 2mn floats of
// probes (19.3 MB at (256, 9414)). The split-K keeps the Gram's grid at
// 16 x (m/64)^2 blocks instead of (m/64)^2 blocks that walk K = n alone.
// Measured on an H100 80GB HBM3 at its 700 W limit, at (256, 9414): the
// GEMMs take 441 us (4.9 GFLOP, 11 TFLOP/s of fp32 SIMT), K3 54 us; the
// plain torch version (cuBLAS and a trsm) is faster there. Larger tiles and
// skipping the Gram's lower tiles (the caller keeps only its triu) are the
// next steps.
// dX and dG may arrive transposed (a mirrored layer's probes are views of
// (n, m) arrays): the GEMM reads them through its transpose flag, no copy.
// The Pallas kernel's bf16x3 solve mode exists only because of Mosaic and
// is not carried over: every product here is plain fp32.
#include "psgd.cuh"

#include <algorithm>

#define NS_ROWS 16
#define NS_THREADS 256
#define NS_COLS (4 * NS_THREADS)
#define DS_MAX_SPLITS 16

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// grid (column splits, row panels)
__global__ void __launch_bounds__(NS_THREADS) ns_big_partial_kernel(
    int m, int n, const float* __restrict__ dx, const float* __restrict__ dg,
    const float* __restrict__ ql0, const float* __restrict__ ql1, const float* __restrict__ w,
    const float* __restrict__ qr, const float* __restrict__ dgl, const float* __restrict__ al,
    float* __restrict__ pcorr, float* __restrict__ pcol, float* __restrict__ pdiag,
    float* __restrict__ pbias) {
    const int split = blockIdx.x, panel = blockIdx.y;
    const int row0 = panel * NS_ROWS;
    __shared__ float s0[NS_ROWS], s1[NS_ROWS], sw[NS_ROWS];
    __shared__ float red[2][NS_ROWS][NS_THREADS / 32];
    if (threadIdx.x < NS_ROWS) {
        const int i = row0 + threadIdx.x;
        const bool ok = i < m;
        s0[threadIdx.x] = ok ? ql0[i] : 1.f;
        s1[threadIdx.x] = ok ? ql1[i] : 0.f;
        sw[threadIdx.x] = ok ? w[i] : 0.f;
    }
    __syncthreads();

    float rd[NS_ROWS], rb[NS_ROWS];
#pragma unroll
    for (int r = 0; r < NS_ROWS; ++r) rd[r] = rb[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int j = split * NS_COLS + c * NS_THREADS + threadIdx.x;
        if (j >= n) continue;
        const float q = qr[j], gl = dgl[j], la = al[j];
        float cr = 0.f, cs = 0.f;
#pragma unroll
        for (int r = 0; r < NS_ROWS; ++r) {
            const int i = row0 + r;
            if (i >= m) continue;
            const size_t o = (size_t)i * n + j;
            const float x = dx[o], g = dg[o];
            const bool keep = i != m - 1;
            const float a = (s0[r] * (keep ? g : 0.f) + s1[r] * gl) * q;
            const float bt = (keep ? x : 0.f) / s0[r] / q;
            const float d2 = a * a - bt * bt;
            rd[r] += d2;
            rb[r] += a * la;
            cr += sw[r] * x;
            cs += d2;
        }
        pcorr[(size_t)panel * n + j] = cr;
        pcol[(size_t)panel * n + j] = cs;
    }

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < NS_ROWS; ++r) {
        const float d = warp_sum(rd[r]), b = warp_sum(rb[r]);
        if (lane == 0) {
            red[0][r][warp] = d;
            red[1][r][warp] = b;
        }
    }
    __syncthreads();
    if (threadIdx.x < 2 * NS_ROWS) {
        const int which = threadIdx.x / NS_ROWS, r = threadIdx.x % NS_ROWS;
        const int i = row0 + r;
        if (i < m) {
            float s = 0.f;
            for (int k = 0; k < NS_THREADS / 32; ++k) s += red[which][r][k];
            (which ? pbias : pdiag)[(size_t)split * m + i] = s;
        }
    }
}

__global__ void __launch_bounds__(256) ns_big_reduce_kernel(
    int m, int n, int panels, int splits, const float* __restrict__ pcorr,
    const float* __restrict__ pcol, const float* __restrict__ pdiag,
    const float* __restrict__ pbias, float* __restrict__ corr, float* __restrict__ colsum,
    float* __restrict__ diag0, float* __restrict__ biasa) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n) {
        float c = 0.f, s = 0.f;
        for (int p = 0; p < panels; ++p) {
            c += pcorr[(size_t)p * n + t];
            s += pcol[(size_t)p * n + t];
        }
        corr[t] = c;
        colsum[t] = s;
    } else if (t < n + m) {
        const int i = t - n;
        float d = 0.f, b = 0.f;
        for (int s = 0; s < splits; ++s) {
            d += pdiag[(size_t)s * m + i];
            b += pbias[(size_t)s * m + i];
        }
        diag0[i] = d;
        biasa[i] = b;
    }
}

static void ns_grid(int m, int n, int& panels, int& splits) {
    panels = (m + NS_ROWS - 1) / NS_ROWS;
    splits = (n + NS_COLS - 1) / NS_COLS;
}

extern "C" size_t psgd_kron_ns_big_scratch_floats(int m, int n) {
    int panels, splits;
    ns_grid(m, n, panels, splits);
    return 2 * psgd_align4((size_t)panels * n) + 2 * psgd_align4((size_t)splits * m);
}

extern "C" int psgd_kron_ns_big(int m, int n, const void* dx, const void* dg, const void* ql0,
                                const void* ql1, const void* w, const void* qr, const void* dgl,
                                const void* al, void* diag0, void* biasa, void* corr,
                                void* colsum, void* scratch, void* stream_ptr) {
    int panels, splits;
    ns_grid(m, n, panels, splits);
    if (m < 1 || n < 1 || panels > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    float* base = static_cast<float*>(scratch);
    float* pcorr = base;
    float* pcol = pcorr + psgd_align4((size_t)panels * n);
    float* pdiag = pcol + psgd_align4((size_t)panels * n);
    float* pbias = pdiag + psgd_align4((size_t)splits * m);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    ns_big_partial_kernel<<<dim3(splits, panels), NS_THREADS, 0, stream>>>(
        m, n, f(dx), f(dg), f(ql0), f(ql1), f(w), f(qr), f(dgl), f(al), pcorr, pcol, pdiag, pbias);
    ns_big_reduce_kernel<<<(n + m + 255) / 256, 256, 0, stream>>>(
        m, n, panels, splits, pcorr, pcol, pdiag, pbias, static_cast<float*>(corr),
        static_cast<float*>(colsum), static_cast<float*>(diag0), static_cast<float*>(biasa));
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- K10

__global__ void __launch_bounds__(256) colsum_diff_kernel(int m, int n, const float* __restrict__ a,
                                                          const float* __restrict__ b,
                                                          float* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    float s = 0.f;
    for (int i = 0; i < m; ++i) {
        const float av = a[(size_t)i * n + j], bv = b[(size_t)i * n + j];
        s += av * av - bv * bv;
    }
    out[j] = s;
}

__global__ void __launch_bounds__(256) sum_splits_kernel(int count, size_t stride, int splits,
                                                         const float* __restrict__ part,
                                                         float* __restrict__ out) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= count) return;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * stride + e];
    out[e] = s;
}

// K split of the Gram: at most DS_MAX_SPLITS panels of >= 256 columns,
// each a multiple of 16 (the GEMM's K tile)
static void ds_split(int n, int& splits, int& chunk) {
    splits = std::max(1, std::min(DS_MAX_SPLITS, n / 256));
    chunk = (n + splits - 1) / splits;
    chunk = (chunk + 15) / 16 * 16;
    splits = (n + chunk - 1) / chunk;
}

extern "C" size_t psgd_kron_ds_big_scratch_floats(int m, int n) {
    int splits, chunk;
    ds_split(n, splits, chunk);
    const size_t mm = psgd_align4((size_t)m * m), mn = psgd_align4((size_t)m * n);
    return mm + 2 * mn + (size_t)splits * mm;
}

extern "C" int psgd_kron_ds_big(int m, int n, const void* qlb, const void* qrb, const void* dx,
                                int dx_t, const void* dg, int dg_t, void* grad2, void* gram,
                                void* scratch, void* stream_ptr) {
    if (m < 1 || n < 1 || m > 1024) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int splits, chunk;
    ds_split(n, splits, chunk);
    const size_t mm = psgd_align4((size_t)m * m), mn = psgd_align4((size_t)m * n);
    float* linv = static_cast<float*>(scratch);
    float* A = linv + mm;
    float* Bt = A + mn;
    float* part = Bt + mn;
    const float* Ql = static_cast<const float*>(qlb);
    const float* qr = static_cast<const float*>(qrb);

    // 1. Linv = Ql^{-1} (K3)
    TriBatch tri;
    tri.count = 1;
    tri.u[0] = Ql;
    tri.x[0] = linv;
    tri.n[0] = m;
    launch_tri_inv(tri, stream);
    // 2. A = (Ql dG) qr,  Bt = (Linv^T dX) / qr; a transposed probe is an
    //    (n, m) array read through the GEMM's transpose flag
    GemmBatch g;
    g.count = 2;
    g.p[0] = gemm_prob(Ql, 0, m, static_cast<const float*>(dg), dg_t, dg_t ? m : n, A, m, n, m);
    g.p[0].epi = EPI_COLMUL;
    g.p[0].v = qr;
    g.p[1] = gemm_prob(linv, 1, m, static_cast<const float*>(dx), dx_t, dx_t ? m : n, Bt, m, n, m);
    g.p[1].epi = EPI_COLDIV;
    g.p[1].v = qr;
    launch_gemms(g, stream);
    // 3. grad2 = colsum(A*A - Bt*Bt)
    colsum_diff_kernel<<<(n + 255) / 256, 256, 0, stream>>>(m, n, A, Bt, static_cast<float*>(grad2));
    // 4. A A^T - Bt Bt^T, split over column panels, then summed
    g.count = splits;
    for (int s = 0; s < splits; ++s) {
        const int k0 = s * chunk, kc = std::min(chunk, n - k0);
        GemmProb P = gemm_prob(A + k0, 0, n, A + k0, 1, n, part + (size_t)s * mm, m, m, kc);
        P.a2 = Bt + k0;
        P.b2 = Bt + k0;
        g.p[s] = P;
    }
    launch_gemms(g, stream);
    sum_splits_kernel<<<(m * m + 255) / 256, 256, 0, stream>>>(
        m * m, mm, splits, part, static_cast<float*>(gram));
    return (int)cudaGetLastError();
}
