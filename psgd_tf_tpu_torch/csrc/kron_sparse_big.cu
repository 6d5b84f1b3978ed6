// K6, K7/K8, K9 and K10: the streaming sparse-format Kronecker reductions;
// K17/K18: the streamed arrow applies (at the end of this file).
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
//      over the whole width (column-scale epilogues, K loops cut to the
//      triangles of Ql and Linv^T);
//   3. grad2_j = sum_i A_ij^2 - Bt_ij^2, one thread per column;
//   4. the Gram difference A A^T - Bt Bt^T with K = n, split over column
//      panels into a (splits, m, m) scratch (the TPU grid's own
//      accumulation) and summed in a fixed order by a last small pass.
// What bounds it: the two triangular m x n products (m^2 n FLOPs each)
// and the Gram difference (4 m^2 n, of which the caller keeps the upper
// triangle), all in kron_dd.cu's fp32 SIMT GEMM, against 2mn floats of
// probes (19.3 MB at (256, 9414)). The Gram's K = n is split over the
// GEMM's grid (up to 16 column panels), so its grid is not (m/64)^2 blocks
// that walk K = n alone. At the reference NMT layers every launch is too
// small for the GEMM's 128 x 128 tiles and takes its 64 x 64 ones; its
// kernel part ran 0.53 ms for the three against 0.82 with the old 64 x 64
// GEMM (H100 80GB HBM3, 700 W, tools/kron_gemm_ab.py). Skipping the Gram's
// lower tiles is the next step.
//
// K9 replaces the same file's `fused_update_nd` (:598, its pallas_call at
// :634, `_kernel_nd_big` :298): a (norm, dense) layer, n <= 1024, any m. With
// row m-1 masked (the caller's tail patches it) and q0, q1 the arrow's rows:
//   A  = (q0 dGm + q1 dG_last) Qr^T,   Bt = (dXm / q0) Qr^{-1}
//   diag0_i = sum_j A^2 - Bt^2,  biasa_i = A_i . A_last,  corr = w^T dX
//   (dX unmasked), and triu(A^T A - Bt^T Bt).
// The TPU kernel inverts Qr's diagonal blocks at grid step 0, substitutes
// block by block per row panel and carries corr and both Grams in VMEM.
// Here: 1. Rinv = Qr^{-1} through K3 (tri.cu), exact in fp32, once per
// call; 2. both products in one launch of kron_dd.cu's grouped GEMM over
// the raw probes, each K loop cut to the band of its triangular factor;
// the arrow's rows commute with the right product, so its epilogues apply
// them once per output (A_i = q0_i (dG Qr^T)_i + q1_i u with
// u = dG_last Qr^T, Bt_i = (dX Rinv)_i / q0_i, row m-1 zero) and no
// scaled probe is stored; 3. the row sums, one warp
// a row; 4. corr as per-panel partials; 5. the Gram difference split over
// row panels into a (splits, n, n) scratch by the same GEMM (tiles below
// the diagonal skipped), then both partial sets summed in a fixed order.
// What bounds it: operations. Each triangular product is m n^2 FLOPs and
// the upper triangle of the Gram difference 2 m n^2, 4 m n^2 in all,
// against 2mn floats of probes: 18.8 GFLOP for the NMT model's five
// (norm, dense) layers at the reference widths, 0.28 ms at the 67 TFLOP/s
// fp32 peak. A and Bt are stored once (2mn floats) and read back by the
// row sums and the Gram. The products and the Gram run in the GEMM's
// 128 x 128 tiles (25-36 TFLOP/s, kron_dd.cu's note); the Gram's K = m is
// split over up to ND_MAX_SPLITS = 64 row panels of >= 256 rows (at
// (131072, 512) the kernel part ran 5.27 ms at 64 panels, 5.31 at 128,
// 5.67 at 32, 6.64 at 8; H100 80GB HBM3, 700 W, tools/kron_gemm_ab.py
// --sweep), 26.2 TFLOP/s of its 4 m n^2 against 13.0 with the old 64 x 64
// GEMM (10.57-10.62 ms); the NMT model's five layers' kernel parts 2.48 ms
// against 3.37 (tools/kron_gemm_ab.py against that tree).
//
// K7 and K8 replace the same file's `_fused_update_ns_wide2` (:456, its
// pallas_call at :494, `_kernel_ns_wide2` :197) and
// `_fused_update_ns_wide_xla` (:524, :558, `_kernel_ns_wide` :265): the
// (norm, scale) reductions of K6 for scale sides past 131,072 lanes, up to
// 2^23. JAX splits them at 2^21 lanes only because its single-pass kernel
// keeps full-width lane accumulators in VMEM; one kernel serves both here.
// It is K6's grid transposed: each block owns a strip of 2,048 lanes and
// walks every row, so corr and colsum are summed in registers and written
// once per lane (at (512, 10^6) K6's (panels, n) scratch would be 256 MB);
// the row partials go to a (strips, m) scratch that a second pass sums in
// a fixed order. What bounds it: memory, 2mn floats read once (4.1 GB at
// (512, 10^6), 1.22 ms at 3.35 TB/s). Offsets are size_t (m n passes 2^31),
// lanes past n are never loaded and rows past m never visited.
//
// dX and dG may arrive transposed in K7/K8, K9 and K10 (a mirrored layer's
// probes are views of (n, m) arrays): each kernel reads them through a
// transpose flag, no copy.
// The Pallas kernel's bf16x3 solve mode exists only because of Mosaic and
// is not carried over: every product here is plain fp32.
#include "psgd.cuh"

#include <algorithm>
#include <climits>

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
    return mm + 2 * mn + (size_t)splits * m * m;
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
    g.p[0].cut = CUT_A_UPPER;
    g.p[1] = gemm_prob(linv, 1, m, static_cast<const float*>(dx), dx_t, dx_t ? m : n, Bt, m, n, m);
    g.p[1].epi = EPI_COLDIV;
    g.p[1].v = qr;
    g.p[1].cut = CUT_A_LOWER;
    launch_gemms(g, stream);
    // 3. grad2 = colsum(A*A - Bt*Bt)
    colsum_diff_kernel<<<(n + 255) / 256, 256, 0, stream>>>(m, n, A, Bt, static_cast<float*>(grad2));
    // 4. A A^T - Bt Bt^T, K = n split over column panels (the GEMM's grid),
    //    then summed in panel order
    g.count = 1;
    g.p[0] = gemm_prob(A, 0, n, A, 1, n, part, m, m, n);
    g.p[0].a2 = Bt;
    g.p[0].b2 = Bt;
    launch_gemms(g, stream, splits);
    sum_splits_kernel<<<(m * m + 255) / 256, 256, 0, stream>>>(
        m * m, (size_t)m * m, splits, part, static_cast<float*>(gram));
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- K9

#define ND_MAX_SPLITS 64   // the Gram's row panels (the GEMM's grid.y)
#define ND_MAX_PANELS 64   // corr's row panels

// one warp a row: diag0_i = sum_j A_ij^2 - Bt_ij^2, biasa_i = sum_j A_ij al_j
// with A_last = al = q0_{m-1} u
__global__ void __launch_bounds__(256) nd_rows_kernel(int m, int n, const float* __restrict__ a,
                                                      const float* __restrict__ bt,
                                                      const float* __restrict__ q0,
                                                      const float* __restrict__ u,
                                                      float* __restrict__ diag0,
                                                      float* __restrict__ biasa) {
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * 8 + (threadIdx.x >> 5);
    if (i >= m) return;
    const float* ar = a + (size_t)i * n;
    const float* br = bt + (size_t)i * n;
    const float q0_last = q0[m - 1];
    float d = 0.f, b = 0.f;
    for (int j = lane; j < n; j += 32) {
        const float av = ar[j], bv = br[j];
        d += av * av - bv * bv;
        b += av * (q0_last * u[j]);
    }
    d = warp_sum(d);
    b = warp_sum(b);
    if (lane == 0) {
        diag0[i] = d;
        biasa[i] = b;
    }
}

// grid (column groups, row panels): pcorr[p n + j] = sum over panel p's rows
// of w_i dX_ij. Row-major dX: lane = column, the warps walk the rows. A
// transposed dX ((n, m) in memory): warp = column, the lanes walk the rows.
__global__ void __launch_bounds__(256) corr_partial_kernel(int m, int n, int rows,
                                                           const float* __restrict__ x, int xt,
                                                           const float* __restrict__ w,
                                                           float* __restrict__ pcorr) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int p = blockIdx.y;
    const int r0 = p * rows, r1 = min(m, r0 + rows);
    if (xt) {
        const int j = blockIdx.x * 8 + warp;
        if (j >= n) return;
        const float* xr = x + (size_t)j * m;
        float s = 0.f;
        for (int i = r0 + lane; i < r1; i += 32) s += w[i] * xr[i];
        s = warp_sum(s);
        if (lane == 0) pcorr[(size_t)p * n + j] = s;
        return;
    }
    __shared__ float red[8][32];
    const int j = blockIdx.x * 32 + lane;
    float s = 0.f;
    if (j < n)
        for (int i = r0 + warp; i < r1; i += 8) s += w[i] * x[(size_t)i * n + j];
    red[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && j < n) {
        for (int k = 1; k < 8; ++k) s += red[k][lane];
        pcorr[(size_t)p * n + j] = s;
    }
}

// corr's row panels (>= 256 rows each) and the Gram's K split (a multiple
// of 16 rows, the GEMM's K tile, each >= 256)
static void nd_grid(int m, int& panels, int& rows, int& splits, int& chunk) {
    panels = std::max(1, std::min(ND_MAX_PANELS, m / 256));
    rows = (m + panels - 1) / panels;
    panels = (m + rows - 1) / rows;
    splits = std::max(1, std::min(ND_MAX_SPLITS, m / 256));
    chunk = (m + splits - 1) / splits;
    chunk = (chunk + 15) / 16 * 16;
    splits = (m + chunk - 1) / chunk;
}

extern "C" size_t psgd_kron_nd_big_scratch_floats(int m, int n) {
    int panels, rows, splits, chunk;
    nd_grid(m, panels, rows, splits, chunk);
    const size_t nn = psgd_align4((size_t)n * n), mn = psgd_align4((size_t)m * n);
    return nn + 2 * mn + psgd_align4((size_t)panels * n) + (size_t)splits * n * n;
}

extern "C" int psgd_kron_nd_big(int m, int n, const void* dx, int dx_t, const void* dg, int dg_t,
                                const void* ql, const void* w, const void* qr, const void* u,
                                void* diag0, void* biasa, void* corr, void* gram, void* scratch,
                                void* stream_ptr) {
    if (m < 1 || n < 1 || n > 1024) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int panels, rows, splits, chunk;
    nd_grid(m, panels, rows, splits, chunk);
    const size_t nn = psgd_align4((size_t)n * n), mn = psgd_align4((size_t)m * n);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    float* rinv = static_cast<float*>(scratch);
    float* A = rinv + nn;
    float* Bt = A + mn;
    float* pcorr = Bt + mn;
    float* part = pcorr + psgd_align4((size_t)panels * n);

    // 1. Rinv = Qr^{-1} (K3)
    TriBatch tri;
    tri.count = 1;
    tri.u[0] = f(qr);
    tri.x[0] = rinv;
    tri.n[0] = n;
    launch_tri_inv(tri, stream);
    // 2. A = (q0 dGm + q1 dG_last) Qr^T and Bt = (dXm / q0) Rinv in one
    //    grouped launch, the arrow's rows in the epilogues; Qr^T is lower
    //    and Rinv upper triangular
    GemmBatch g;
    g.count = 2;
    g.p[0] = gemm_prob(f(dg), dg_t, dg_t ? m : n, f(qr), 1, n, A, m, n, n);
    g.p[0].epi = EPI_ARROW;
    g.p[0].r = f(ql);
    g.p[0].v = f(u);
    g.p[0].cut = CUT_B_LOWER;
    g.p[1] = gemm_prob(f(dx), dx_t, dx_t ? m : n, rinv, 0, n, Bt, m, n, n);
    g.p[1].epi = EPI_ROWDIV;
    g.p[1].r = f(ql);
    g.p[1].cut = CUT_B_UPPER;
    launch_gemms(g, stream);
    // 3. diag0 and biasa
    nd_rows_kernel<<<(m + 7) / 8, 256, 0, stream>>>(m, n, A, Bt, f(ql), f(u),
                                                     static_cast<float*>(diag0),
                                                     static_cast<float*>(biasa));
    // 4. corr = w^T dX over row panels, summed in panel order
    corr_partial_kernel<<<dim3(dx_t ? (n + 7) / 8 : (n + 31) / 32, panels), 256, 0, stream>>>(
        m, n, rows, f(dx), dx_t, f(w), pcorr);
    sum_splits_kernel<<<(n + 255) / 256, 256, 0, stream>>>(n, n, panels, pcorr,
                                                            static_cast<float*>(corr));
    // 5. triu(A^T A - Bt^T Bt), K = m split over row panels (the GEMM's
    //    grid), summed in split order
    g.count = 1;
    g.p[0] = gemm_prob(A, 1, n, A, 0, n, part, n, n, m);
    g.p[0].a2 = Bt;
    g.p[0].b2 = Bt;
    g.p[0].epi = EPI_TRIU;
    launch_gemms(g, stream, splits);
    sum_splits_kernel<<<(n * n + 255) / 256, 256, 0, stream>>>(n * n, (size_t)n * n, splits, part,
                                                                static_cast<float*>(gram));
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------- K7 / K8

#define NSW_THREADS 256
#define NSW_LANES 8                          // lanes a thread owns, NSW_THREADS apart
#define NSW_STRIP (NSW_LANES * NSW_THREADS)  // lanes a block owns
#define NSW_ROWS 4                           // rows a step of the walk loads at once

// grid (strips): each block owns NSW_STRIP lanes and walks every row.
__global__ void __launch_bounds__(NSW_THREADS) ns_wide_kernel(
    int m, int n, const float* __restrict__ dx, int dx_t, const float* __restrict__ dg, int dg_t,
    const float* __restrict__ ql0, const float* __restrict__ ql1, const float* __restrict__ w,
    const float* __restrict__ qr, const float* __restrict__ dgl, const float* __restrict__ al,
    float* __restrict__ corr, float* __restrict__ colsum, float* __restrict__ pdiag,
    float* __restrict__ pbias) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __shared__ float red[2][NSW_ROWS][NSW_THREADS / 32];
    size_t j[NSW_LANES];
    bool ok[NSW_LANES];
    float rq[NSW_LANES], q[NSW_LANES], gl[NSW_LANES], la[NSW_LANES], cr[NSW_LANES], cs[NSW_LANES];
#pragma unroll
    for (int c = 0; c < NSW_LANES; ++c) {
        j[c] = (size_t)blockIdx.x * NSW_STRIP + c * NSW_THREADS + threadIdx.x;
        ok[c] = j[c] < (size_t)n;
        // a lane past n is never loaded; its inert values add nothing
        q[c] = ok[c] ? qr[j[c]] : 1.f;
        rq[c] = 1.f / q[c];
        gl[c] = ok[c] ? dgl[j[c]] : 0.f;
        la[c] = ok[c] ? al[j[c]] : 0.f;
        cr[c] = cs[c] = 0.f;
    }
    for (int i0 = 0; i0 < m; i0 += NSW_ROWS) {
        float xv[NSW_ROWS][NSW_LANES], gv[NSW_ROWS][NSW_LANES];
#pragma unroll
        for (int r = 0; r < NSW_ROWS; ++r) {
            const int i = i0 + r;
#pragma unroll
            for (int c = 0; c < NSW_LANES; ++c) {
                const bool in = ok[c] && i < m;
                xv[r][c] = in ? dx[dx_t ? j[c] * m + i : (size_t)i * n + j[c]] : 0.f;
                gv[r][c] = in ? dg[dg_t ? j[c] * m + i : (size_t)i * n + j[c]] : 0.f;
            }
        }
        float rd[NSW_ROWS], rb[NSW_ROWS];
#pragma unroll
        for (int r = 0; r < NSW_ROWS; ++r) {
            const int i = i0 + r;
            rd[r] = rb[r] = 0.f;
            if (i >= m) continue;
            // row m-1 is masked out of diag0, biasa and colsum (the caller's
            // tail patches it), not out of corr
            const bool keep = i != m - 1;
            const float q0 = ql0[i], q1 = ql1[i], wi = w[i], r0 = 1.f / q0;
#pragma unroll
            for (int c = 0; c < NSW_LANES; ++c) {
                const float x = xv[r][c];
                const float a = (q0 * (keep ? gv[r][c] : 0.f) + q1 * gl[c]) * q[c];
                const float b = (keep ? x : 0.f) * r0 * rq[c];
                const float d2 = a * a - b * b;
                rd[r] += d2;
                rb[r] += a * la[c];
                cr[c] += wi * x;
                cs[c] += d2;
            }
        }
        // the block's row partials, summed over its warps in order
#pragma unroll
        for (int r = 0; r < NSW_ROWS; ++r) {
            const float d = warp_sum(rd[r]), b = warp_sum(rb[r]);
            if (lane == 0) {
                red[0][r][warp] = d;
                red[1][r][warp] = b;
            }
        }
        __syncthreads();
        if (threadIdx.x < 2 * NSW_ROWS) {
            const int which = threadIdx.x / NSW_ROWS, r = threadIdx.x % NSW_ROWS;
            const int i = i0 + r;
            if (i < m) {
                float s = 0.f;
                for (int k = 0; k < NSW_THREADS / 32; ++k) s += red[which][r][k];
                (which ? pbias : pdiag)[(size_t)blockIdx.x * m + i] = s;
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int c = 0; c < NSW_LANES; ++c) {
        if (ok[c]) {
            corr[j[c]] = cr[c];
            colsum[j[c]] = cs[c];
        }
    }
}

// block: 32 rows (lane) x 32 warps over the strips, summed in a fixed order
__global__ void __launch_bounds__(1024) ns_wide_reduce_kernel(int m, int strips,
                                                              const float* __restrict__ pdiag,
                                                              const float* __restrict__ pbias,
                                                              float* __restrict__ diag0,
                                                              float* __restrict__ biasa) {
    __shared__ float red[2][32][33];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int i = blockIdx.x * 32 + lane;
    float d = 0.f, b = 0.f;
    if (i < m) {
        for (int s = warp; s < strips; s += 32) {
            d += pdiag[(size_t)s * m + i];
            b += pbias[(size_t)s * m + i];
        }
    }
    red[0][warp][lane] = d;
    red[1][warp][lane] = b;
    __syncthreads();
    if (warp < 2 && i < m) {
        float t = 0.f;
        for (int k = 0; k < 32; ++k) t += red[warp][k][lane];
        (warp ? biasa : diag0)[i] = t;
    }
}

static int ns_wide_strips(int n) { return (n + NSW_STRIP - 1) / NSW_STRIP; }

extern "C" size_t psgd_kron_ns_wide_scratch_floats(int m, int n) {
    return 2 * psgd_align4((size_t)ns_wide_strips(n) * m);
}

extern "C" int psgd_kron_ns_wide(int m, int n, const void* dx, int dx_t, const void* dg, int dg_t,
                                 const void* ql0, const void* ql1, const void* w, const void* qr,
                                 const void* dgl, const void* al, void* diag0, void* biasa,
                                 void* corr, void* colsum, void* scratch, void* stream_ptr) {
    if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int strips = ns_wide_strips(n);
    float* pdiag = static_cast<float*>(scratch);
    float* pbias = pdiag + psgd_align4((size_t)strips * m);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    ns_wide_kernel<<<strips, NSW_THREADS, 0, stream>>>(
        m, n, f(dx), dx_t, f(dg), dg_t, f(ql0), f(ql1), f(w), f(qr), f(dgl), f(al),
        static_cast<float*>(corr), static_cast<float*>(colsum), pdiag, pbias);
    ns_wide_reduce_kernel<<<(m + 31) / 32, 1024, 0, stream>>>(
        m, strips, pdiag, pbias, static_cast<float*>(diag0), static_cast<float*>(biasa));
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------- K17 / K18
//
// K17 replaces the same file's `_apply_norm_call` (:807, its pallas_call at
// :830, `_kernel_apply_norm` :768), reached by `fused_apply_ns` (:848) and
// `fused_apply_nd` (:928); K18 replaces `fused_apply_ns_wide` (:893, its
// pallas_call at :912, `_kernel_apply_ns_wide` :853). All compute P G for a
// layer with an arrow left factor, P G = Ql^T ((Ql G) R), R = diag(qr^2)
// for (norm, scale) and the dense Qr^T Qr (formed by the caller) for
// (norm, dense):
//   z_i = (q0_i G_i + q1_i G_{m-1}) R,   out_i = q0_i z_i,
//   and row m-1 also gets sum_i q1_i z_i (the arrow's last column).
// The TPU kernel streams row panels in grid order and carries sum q1 z in
// VMEM: row m-1 lies in the last panel, so the sum is complete when that
// panel is written. Blocks here run in no order, so each block (a strip of
// AP_STRIP lanes by a chunk of rows) writes its strip's partial sum to a
// (chunks, n) scratch, and a last small launch adds the partials to row
// m-1 in chunk order: no atomics, a run repeats itself bit for bit.
// Nothing is padded: lanes past n and rows past m are masked, so K18 is
// K17's (norm, scale) kernel on a wider grid (the JAX package's 128-lane
// and row-block padding exists for the TPU's tiling alone).
// What bounds it: (norm, scale) memory, G read once and the output written
// once (8 m n bytes: 4.1 GB at (512, 10^6), 1.22 ms at 3.35 TB/s); each
// thread keeps AP_ROWS x AP_LANES loads in flight. (norm, dense)
// operations, the product by R (2 m n^2 FLOPs: 68.7 GFLOP at
// (131072, 512), 1.03 ms at the fp32 peak): a prologue launch of the same
// kernel writes preG = Ql G, kron_dd.cu's grouped GEMM (128 x 128 fp32
// SIMT tiles at this size) writes Z = preG R into the output, and the
// kernel rewrites Z in place (each element read and written by one thread):
// 2.36 ms at (131072, 512), from 4.46-4.49 with the old 64 x 64 GEMM,
// against 1.41 for cuBLAS's fp32 product alone (H100 80GB HBM3, 700 W,
// tools/kron_gemm_ab.py).

#define AP_THREADS 256
#define AP_LANES 4                         // lanes a thread owns, AP_THREADS apart
#define AP_STRIP (AP_LANES * AP_THREADS)   // lanes a block owns
#define AP_ROWS 4                          // rows a step of the walk loads at once
#define AP_MIN_ROWS 16                     // fewest rows a chunk takes
#define AP_TARGET_BLOCKS (132 * 8)         // one wave of 256-thread blocks on 132 SMs

enum ApplyMode { AP_NS = 0, AP_PRE = 1, AP_ND = 2 };

// grid (strips, chunks). AP_NS: src = G, out = q0 z with
// z = (q0 g + q1 G_{m-1}) qr^2; AP_PRE: src = G, out = preG = q0 g + q1 G_{m-1};
// AP_ND: src = Z (may be out itself), out = q0 z. AP_NS and AP_ND write the
// block's partial sum_i q1_i z_i of each lane to pcol[chunk n + j].
template <int MODE>
__global__ void __launch_bounds__(AP_THREADS) apply_norm_kernel(
    int m, int n, int rows, const float* src, const float* __restrict__ ql,
    const float* __restrict__ qr, float* out, float* __restrict__ pcol) {
    const float* q0 = ql;
    const float* q1 = ql + m;
    const int r0 = blockIdx.y * rows, r1 = min(m, r0 + rows);
    size_t j[AP_LANES];
    bool ok[AP_LANES];
    float rr[AP_LANES], gl[AP_LANES], acc[AP_LANES];
#pragma unroll
    for (int c = 0; c < AP_LANES; ++c) {
        j[c] = (size_t)blockIdx.x * AP_STRIP + c * AP_THREADS + threadIdx.x;
        ok[c] = j[c] < (size_t)n;
        const float q = (MODE == AP_NS && ok[c]) ? qr[j[c]] : 1.f;
        rr[c] = q * q;
        gl[c] = (MODE != AP_ND && ok[c]) ? src[(size_t)(m - 1) * n + j[c]] : 0.f;
        acc[c] = 0.f;
    }
    for (int i0 = r0; i0 < r1; i0 += AP_ROWS) {
        float v[AP_ROWS][AP_LANES];
#pragma unroll
        for (int r = 0; r < AP_ROWS; ++r)
#pragma unroll
            for (int c = 0; c < AP_LANES; ++c)
                v[r][c] = (ok[c] && i0 + r < r1) ? src[(size_t)(i0 + r) * n + j[c]] : 0.f;
#pragma unroll
        for (int r = 0; r < AP_ROWS; ++r) {
            const int i = i0 + r;
            if (i >= r1) continue;
            const float a = q0[i], b = q1[i];
#pragma unroll
            for (int c = 0; c < AP_LANES; ++c) {
                const float pre = MODE == AP_ND ? v[r][c] : a * v[r][c] + b * gl[c];
                const float z = MODE == AP_NS ? pre * rr[c] : pre;
                if (ok[c]) out[(size_t)i * n + j[c]] = MODE == AP_PRE ? pre : a * z;
                acc[c] += b * z;
            }
        }
    }
    if (MODE == AP_PRE) return;
#pragma unroll
    for (int c = 0; c < AP_LANES; ++c)
        if (ok[c]) pcol[(size_t)blockIdx.y * n + j[c]] = acc[c];
}

// out[m-1, j] += sum over chunks of pcol[chunk, j], in chunk order
__global__ void __launch_bounds__(256) apply_last_row_kernel(int m, int n, int chunks,
                                                             const float* __restrict__ pcol,
                                                             float* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n) return;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += pcol[(size_t)c * n + j];
    out[(size_t)(m - 1) * n + j] += s;
}

// lane strips, and row chunks enough for a wave (each >= AP_MIN_ROWS rows,
// a multiple of AP_ROWS)
static void apply_grid(int m, int n, int& strips, int& chunks, int& rows) {
    strips = (n + AP_STRIP - 1) / AP_STRIP;
    chunks = std::max(1, std::min((AP_TARGET_BLOCKS + strips - 1) / strips,
                                  (m + AP_MIN_ROWS - 1) / AP_MIN_ROWS));
    rows = (m + chunks - 1) / chunks;
    rows = (rows + AP_ROWS - 1) / AP_ROWS * AP_ROWS;
    chunks = (m + rows - 1) / rows;
}

extern "C" size_t psgd_kron_apply_scratch_floats(int m, int n, int dense) {
    int strips, chunks, rows;
    apply_grid(m, n, strips, chunks, rows);
    return psgd_align4((size_t)chunks * n) + (dense ? (size_t)m * n : 0);
}

static int apply_tail(int m, int n, int chunks, const float* pcol, float* out,
                      cudaStream_t stream) {
    apply_last_row_kernel<<<(n + 255) / 256, 256, 0, stream>>>(m, n, chunks, pcol, out);
    return (int)cudaGetLastError();
}

extern "C" int psgd_kron_apply_ns(int m, int n, const void* g, const void* ql, const void* qr,
                                  void* out, void* scratch, void* stream_ptr) {
    if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int strips, chunks, rows;
    apply_grid(m, n, strips, chunks, rows);
    float* pcol = static_cast<float*>(scratch);
    float* o = static_cast<float*>(out);
    apply_norm_kernel<AP_NS><<<dim3(strips, chunks), AP_THREADS, 0, stream>>>(
        m, n, rows, static_cast<const float*>(g), static_cast<const float*>(ql),
        static_cast<const float*>(qr), o, pcol);
    return apply_tail(m, n, chunks, pcol, o, stream);
}

extern "C" int psgd_kron_apply_nd(int m, int n, const void* g, const void* ql, const void* r,
                                  void* out, void* scratch, void* stream_ptr) {
    // the GEMM's grid counts its tiles (64 x 64 at most) in an int
    if (m < 1 || n < 1 || (size_t)((m + 63) / 64) * ((n + 63) / 64) > (size_t)INT_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int strips, chunks, rows;
    apply_grid(m, n, strips, chunks, rows);
    float* pcol = static_cast<float*>(scratch);
    float* pre = pcol + psgd_align4((size_t)chunks * n);
    float* o = static_cast<float*>(out);
    const float* q = static_cast<const float*>(ql);
    const dim3 grid(strips, chunks);
    apply_norm_kernel<AP_PRE><<<grid, AP_THREADS, 0, stream>>>(
        m, n, rows, static_cast<const float*>(g), q, nullptr, pre, nullptr);
    GemmBatch gb;
    gb.count = 1;
    gb.p[0] = gemm_prob(pre, 0, n, static_cast<const float*>(r), 0, n, o, m, n, n);
    launch_gemms(gb, stream);
    apply_norm_kernel<AP_ND><<<grid, AP_THREADS, 0, stream>>>(m, n, rows, o, q, nullptr, o, pcol);
    return apply_tail(m, n, chunks, pcol, o, stream);
}
