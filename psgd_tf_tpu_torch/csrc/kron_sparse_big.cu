// K6, K7/K8 and K10: the streaming sparse-format Kronecker updates, each
// one C call from the factors and probes to the balanced, updated factors;
// K9: the streaming (norm, dense) reductions; K17/K18: the streamed arrow
// applies (at the end of this file).
//
// K6 replaces psgd_tf_tpu/ops/pallas/kron_sparse_big.py `fused_update_ns`
// (:377, its pallas_call at :412, `_kernel_ns_big` :172): the (norm, scale)
// update of an (m, n) layer, n <= 131072 lanes, with the tail the JAX
// package leaves to XLA. The arrow's rows q0, q1 and the scale qr enter
// unbalanced: rho = sqrt(max q0 / max qr) cancels in every gradient term,
// so only the final rewrites carry it (their rounding differs from the
// plain version's, which balances first, at the 1e-7 level). With row m-1
// masked (A_last = q0_{m-1} dG_last qr, w = q1 / (q0 q0_{m-1})):
//   a = (q0_i dGm_ij + q1_i dG_last_j) qr_j,  bt = dXm_ij / q0_i / qr_j
//   diag0_i = sum_j a^2 - bt^2,  biasa_i = sum_j a A_last_j
//   corr_j = sum_i w_i dX_ij,    colsum_j = sum_i a^2 - bt^2
// then B_last = (dX_last / q0_{m-1} - corr) / qr, grad2 = colsum + A_last^2
// - B_last^2, the second dX pass btdot = dX (B_last / qr) / q0, bias =
// biasa - btdot, row m-1's diag = sum(A_last^2 - B_last^2) and bias = 0,
// the saturating step scales (linalg.step_scale: a zero probe gives a zero
// update) and the rewrites of q0, q1 and qr. On the TPU one grid walks the
// row panels in order, carries corr and colsum in VMEM, and XLA fuses the
// tail. Blocks on Hopper run in no order, and the tail ran here as 55
// eager torch launches a call: 0.91-1.30 ms of host time a call against a
// device span of 170-200 us, of which the pass and its reduction took
// 29-43 (H100 80GB HBM3, 700 W, tools/profile_kron_chain.py --stream on
// the tree before this design). So the call is five launches, with no
// host sync and no float atomic: every sum in a fixed order, the maxima by
// atomicMax on order-preserving float bits (a max does not depend on the
// order), so a run repeats itself bit for bit:
//   1. ns_pass_kernel: one pass over (dX, dG), each block a 128-column tile
//      of a group of 16-row panels that it walks with the next panel's
//      loads in flight, each thread 4 columns of 2 rows, 16-byte loads
//      where the row pitch and the pointers allow (4 strided columns a
//      thread otherwise); about 3 blocks an SM; row partials a tile,
//      column partials a panel group, summed over the block's warps in
//      order and stored side by side. A transposed pair (a mirrored layer's
//      dX.T, dG.T) is read in place: the kernel walks the (n, m) memory
//      with the two kinds of sum swapped.
//   2. ns_cols_kernel: the column partials summed in group order, B_last,
//      grad2, y = B_last / qr, max|grad2|, max qr.
//   3. ns_btdot_kernel: the second dX pass, dX y, a warp a (row, 2048-column
//      chunk). It cannot join the first: y needs corr, a sum over every
//      row. It follows it at once, so dX (5.2-20.2 MB at the NMT layers)
//      is still in the 50 MB L2.
//   4. ns_rows_kernel: a warp a row, the row partials and the chunks summed
//      in order, diag, bias, max(|diag|, |bias|), max q0.
//   5. ns_finish_kernel: rho and both step scales from the maxima, then the
//      rewrites.
// What bounds it: memory. The pass reads 2mn floats once (18.9 MB at
// (2305, 1024)) and writes partials of 1/16 of those bytes or less; the
// second pass reads dX again, from L2 where it stayed. The old pass
// (16-row panels of one 1,024-column split, 145 blocks at (2305, 1024),
// scalar loads) ran 25 us there; this one 5.3 us at (1281, 1024) (2.0
// TB/s of its 10.5 MB), 6.6 at (2305, 1024) (2.9 TB/s) and 14.1 at
// (1025, 4935) (2.9 TB/s, strided loads), the probes warm in L2 from the
// call before; the whole call 20.3, 21.7 and 33.6 us on the device, its
// tail launches 2.2-6.2 us each and 1 us apart (H100 80GB HBM3, 700 W,
// tools/profile_kron_chain.py --stream).
//
// K7 and K8 replace the same file's `_fused_update_ns_wide2` (:456, its
// pallas_call at :494, `_kernel_ns_wide2` :197) and
// `_fused_update_ns_wide_xla` (:524, :558, `_kernel_ns_wide` :265): the
// (norm, scale) update for scale sides past 131,072 lanes, up to 2^23. JAX
// splits them at 2^21 lanes only because its single-pass kernel keeps
// full-width lane accumulators in VMEM; one kernel serves both here. Its
// pass is K6's grid transposed: each block owns a strip of 2,048 lanes and
// walks every row, so corr and colsum are summed in registers and written
// once per lane (at (512, 10^6) K6's panel partials would be 256 MB); the
// row partials go to an (m, strips) scratch. A small launch writes the
// vectors it reads (w, dG_last, A_last), and the pass feeds K6's tail
// (launches 2-5), whose rows kernel sums the strips in order. The second
// dX pass is K6's kernel too at every width (the JAX package leaves that
// matvec to XLA): at (512, 10^6) it streams 2 GB in 660 us (3.1 TB/s),
// against 672 for torch's matvec in the tree before; at (64, 3,000,017),
// with n odd and so 4-byte loads, 0.77 GB in 298 us, against 256 for
// torch's: it loses there. The whole call 2.32 and 1.05 ms on the device,
// from 2.53 and 1.22 (H100 80GB HBM3, 700 W, tools/profile_kron_chain.py
// --stream). What bounds it: memory, 2mn floats read once by the pass
// (4.1 GB at (512, 10^6), 1.22 ms at 3.35 TB/s) and mn by the second
// pass. Offsets are size_t (m n passes 2^31), lanes past n are never
// loaded and rows past m never visited.
//
// K10 replaces the same file's `fused_update_ds` (:711, its pallas_call at
// :740, `_kernel_ds_big` :675): the (dense, scale) update of an (m, n)
// layer, m <= 1024, any n, in one C call. rho cancels in A = Ql dG qr and
// Bt = Ql^{-T} dX / qr, so the chain runs on the unbalanced factors and
// forms Ql / rho and rho qr in its finish:
//   1. Linv = Ql^{-1} through K3 (tri.cu), exact in fp32;
//   2. the grouped GEMM of kron_dd.cu: A = (Ql dG) qr and Bt = (Linv^T dX)
//      / qr over the whole width (column-scale epilogues, K loops cut to the
//      triangles of Ql and Linv^T), each writing its row tiles' column
//      sums of A^2 and Bt^2 (EPI_COLSQ): grad2 without a second read of
//      the 2mn floats of A and Bt;
//   3. the Gram difference A A^T - Bt Bt^T, its upper tiles alone
//      (EPI_UPPER: 10 of 16 at m = 256), K = n split over up to 32 column
//      bands so that the tiles times the bands fill two blocks an SM;
//   4. ds_sums_kernel: the bands summed in order into grad1 = triu(Gram),
//      the row tiles' partials into grad2, max|grad1|, max|grad2|, and the
//      maxima of diag(Ql) and qr;
//   5. grad1 Ql through the same GEMM, its upper tiles alone, each K loop
//      cut to the band between the two triangles and split in bands
//      (m = 256: 10 tiles of K <= 256 in 4 bands, not 16 tiles of one);
//   6. ds_finish_kernel: the bands summed in order, s1 and s2 from the
//      maxima, rho, Ql' = (Ql - s1 grad1 Ql) / rho and qr' = rho qr -
//      s2 grad2 rho qr.
// What bounds it: the two triangular m x n products (m^2 n FLOPs each) and
// the upper triangle of the Gram difference (2 m^2 n), in kron_dd.cu's
// fp32 SIMT GEMM, against 2mn floats of probes (19.3 MB at (256, 9414)).
// Its launches take the GEMM's 64 x 64 tiles (the only tiles built with
// the two flags). The old chain (a full-square Gram, a column-sum kernel
// that read A and Bt back, a sum kernel, then 26-28 torch launches) spanned
// 338, 113 and 247 us on the device at the NMT model's three layers; this
// one 209, 36 and 142 (at (256, 9414): K3 28, the products 91, the Gram
// 69, the sums 4.5, grad1 Ql 7.6, the finish 2.7), with 44-82 us of host
// time a call against 0.33-0.64 ms (H100 80GB HBM3, 700 W,
// tools/profile_kron_chain.py --stream and chip_smoke.py; the host's time
// moves between runs). The products run at 13.5 TFLOP/s
// and the Gram's ten tiles at 22 TFLOP/s: every one of their operands is
// contiguous along K (the mirrored layers' probes are dX.T views, the
// Gram's A and Bt are m x n row-major), and the GEMM's k-major shared
// memory takes such an operand by 4-byte copies; that load path, and
// K3's 28 us at a 256 side, are what is left.
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
// dX and dG may arrive transposed in every kernel here (a mirrored layer's
// probes are views of (n, m) arrays): each reads them through a transpose
// flag, no copy.
// The Pallas kernel's bf16x3 solve mode exists only because of Mosaic and
// is not carried over: every product here is plain fp32.
#include "psgd.cuh"

#include <algorithm>
#include <cfloat>
#include <climits>
#include <cstdint>

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ unsigned warp_max_u(unsigned v) {
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Block-wide reductions of 256 threads (red: 8 slots), the same order on
// every run; every thread of the block calls them.
__device__ __forceinline__ float block_sum(float v, float* red) {
    v = warp_sum(v);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[w];
    return s;
}

__device__ __forceinline__ unsigned block_max_u(unsigned v, unsigned* red) {
    v = warp_max_u(v);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    for (int w = 0; w < 8; ++w) v = max(v, red[w]);
    return v;
}

// A float's key for atomicMax: keys order as the floats do, sign included
// (|x| needs none: its bits order like unsigned integers). Key 0, the
// zeroed slot, is below every float's.
__device__ __forceinline__ unsigned fkey(float f) {
    const unsigned u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float fkey_inv(unsigned k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// linalg.step_scale: step / (max|grad| + tiny), saturated at the fp32 max
__device__ __forceinline__ float slot_scale(float step, unsigned max_bits) {
    return fminf(step / (__uint_as_float(max_bits) + psgd_tiny()), FLT_MAX);
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

static int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

#define SLOT_FLOATS 8  // the maxima slots at the head of a chain's scratch

__global__ void __launch_bounds__(256) sum_splits_kernel(int count, size_t stride, int splits,
                                                         const float* __restrict__ part,
                                                         float* __restrict__ out) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= count) return;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * stride + e];
    out[e] = s;
}

// ------------------------------------------------------------------- K6

#define NS_RPW 2           // memory rows a warp takes of a panel
#define NS_PROWS (8 * NS_RPW)  // memory rows of a panel: 8 warps
#define NS_PCOLS 128       // memory columns of a tile: 32 lanes of 4
#define NS_MAX_GROUPS 256  // most panel groups (column partial sets) of the pass
#define NS_BLOCKS_PER_SM 3 // the pass's grid: about this many blocks an SM
#define BT_CHUNK 2048      // columns of a row-major dX a warp of the second pass takes
#define BTT_CHUNK 256      // memory rows of a transposed dX a warp takes

// the (norm, scale) chain's maxima: |grad2|, max(|diag|, |bias|) (float
// bits), q0 and qr (fkey)
enum NsSlot { NS_MAX_G2 = 0, NS_MAX_DB = 1, NS_MAX_Q0 = 2, NS_MAX_QR = 3 };

// One block: memory-column tile `blockIdx.x % tiles` of the group
// `blockIdx.x / tiles` of `ppg` panels of NS_PROWS rows, walked in order
// with the next panel's loads (and its per-row values) in flight while the
// current one is summed. Memory is (R, C) row-major: (m, n) as given, or
// (n, m) when TRANS (the probes are views dX.T of it). A sums run along a
// memory row (the thread's 4 columns, then the warp's lanes): (diag0,
// biasa) row-major, (corr, colsum) transposed; B sums along a memory
// column (the thread's rows, then the 8 warps in order): the other pair.
// The row partials (diag0, biasa) go to prow[(q parts + part) m + i], the
// column partials (corr, colsum) to pcol[(q parts + part) n + j]; q is the
// pair's member, part the tile (A sums) or the group (B sums): a warp's
// or a block's stores land side by side. bt multiplies by the
// reciprocals of q0 and qr (as K7/K8's pass does): a few ulp from the
// plain version's two divisions.
template <bool VEC, bool TRANS>
__global__ void __launch_bounds__(256) ns_pass_kernel(
    int m, int n, int tiles, int ppg, const float* __restrict__ dx, const float* __restrict__ dg,
    const float* __restrict__ ql, const float* __restrict__ qr, float* __restrict__ prow,
    float* __restrict__ pcol) {
    const int R = TRANS ? n : m, C = TRANS ? m : n;
    const int tile = blockIdx.x % tiles, group = blockIdx.x / tiles, groups = gridDim.x / tiles;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int c0 = tile * NS_PCOLS;
    const float* q0 = ql;
    const float* q1 = ql + m;
    const float q0l = q0[m - 1];
    // the panels' per-row values, two buffers: (q0, q1, w, 1 / q0) of rows
    // i, or (qr, dG_last, A_last, 1 / qr) of rows j when TRANS; inert past R
    __shared__ float sv[2][4][NS_PROWS];
    __shared__ float red[2][8][NS_PCOLS];

    // the thread's 4 memory columns and their values: (qr, dG_last, A_last,
    // 1 / qr) of columns j, or (q0, q1, w, 1 / q0) of columns i when TRANS
    int cc[4];
    float cv[4][4], b0[4], b1[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        cc[k] = VEC ? c0 + 4 * lane + k : c0 + lane + 32 * k;
        const bool ok = cc[k] < C;
        if (TRANS) {
            cv[0][k] = ok ? q0[cc[k]] : 1.f;
            cv[1][k] = ok ? q1[cc[k]] : 0.f;
            cv[2][k] = ok ? cv[1][k] / (cv[0][k] * q0l) : 0.f;
        } else {
            const float q = ok ? qr[cc[k]] : 1.f, gl = ok ? dg[(size_t)(m - 1) * n + cc[k]] : 0.f;
            cv[0][k] = q;
            cv[1][k] = gl;
            cv[2][k] = q0l * gl * q;
        }
        cv[3][k] = 1.f / cv[0][k];
        b0[k] = b1[k] = 0.f;
    }
    auto load = [&](int r0, float (&x)[NS_RPW][4], float (&g)[NS_RPW][4]) {
#pragma unroll
        for (int rr = 0; rr < NS_RPW; ++rr) {
            const int r = r0 + warp * NS_RPW + rr;
            const size_t o = (size_t)r * C;
            if (VEC) {
                float4 xa = make_float4(0.f, 0.f, 0.f, 0.f), ga = xa;
                if (r < R && cc[0] < C) {
                    xa = *reinterpret_cast<const float4*>(dx + o + cc[0]);
                    ga = *reinterpret_cast<const float4*>(dg + o + cc[0]);
                }
                x[rr][0] = xa.x; x[rr][1] = xa.y; x[rr][2] = xa.z; x[rr][3] = xa.w;
                g[rr][0] = ga.x; g[rr][1] = ga.y; g[rr][2] = ga.z; g[rr][3] = ga.w;
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const bool ok = r < R && cc[k] < C;
                    x[rr][k] = ok ? dx[o + cc[k]] : 0.f;
                    g[rr][k] = ok ? dg[o + cc[k]] : 0.f;
                }
            }
        }
    };
    // row r0 + threadIdx.x's values (threads below NS_PROWS <= 256)
    auto row_values = [&](int r0, float (&v)[4]) {
        const int r = r0 + threadIdx.x;
        const bool ok = r < R;
        if (TRANS) {
            const float q = ok ? qr[r] : 1.f, gl = ok ? dg[(size_t)r * m + m - 1] : 0.f;
            v[0] = q;
            v[1] = gl;
            v[2] = q0l * gl * q;
        } else {
            const float a = ok ? q0[r] : 1.f, b = ok ? q1[r] : 0.f;
            v[0] = a;
            v[1] = b;
            v[2] = ok ? b / (a * q0l) : 0.f;
        }
        v[3] = 1.f / v[0];
    };
    const bool fills = threadIdx.x < NS_PROWS;
    float xv[NS_RPW][4], gv[NS_RPW][4], sr[4];
    int r0 = group * ppg * NS_PROWS;
    load(r0, xv, gv);
    if (fills) {
        row_values(r0, sr);
#pragma unroll
        for (int k = 0; k < 4; ++k) sv[0][k][threadIdx.x] = sr[k];
    }
    for (int pp = 0; pp < ppg && r0 < R; ++pp, r0 += NS_PROWS) {
        __syncthreads();  // this panel's values are stored; the last ones' readers are done
        const bool more = pp + 1 < ppg && r0 + NS_PROWS < R;
        float xn[NS_RPW][4], gn[NS_RPW][4];
        if (more) {
            load(r0 + NS_PROWS, xn, gn);
            if (fills) row_values(r0 + NS_PROWS, sr);
        }
        const float (*v)[NS_PROWS] = sv[pp & 1];
#pragma unroll
        for (int rr = 0; rr < NS_RPW; ++rr) {
            const int ri = warp * NS_RPW + rr, r = r0 + ri;
            float a0 = 0.f, a1 = 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const float q0i = TRANS ? cv[0][k] : v[0][ri], q1i = TRANS ? cv[1][k] : v[1][ri];
                const float wi = TRANS ? cv[2][k] : v[2][ri], rq0 = TRANS ? cv[3][k] : v[3][ri];
                const float qrj = TRANS ? v[0][ri] : cv[0][k], glj = TRANS ? v[1][ri] : cv[1][k];
                const float alj = TRANS ? v[2][ri] : cv[2][k], rqr = TRANS ? v[3][ri] : cv[3][k];
                const bool keep = (TRANS ? cc[k] : r) != m - 1;
                const float x = xv[rr][k];
                const float a = (q0i * (keep ? gv[rr][k] : 0.f) + q1i * glj) * qrj;
                const float bt = (keep ? x : 0.f) * rq0 * rqr;
                const float d2 = a * a - bt * bt;
                if (TRANS) {  // A: corr, colsum of row j; B: diag0, biasa of column i
                    a0 += wi * x;
                    a1 += d2;
                    b0[k] += d2;
                    b1[k] += a * alj;
                } else {      // A: diag0, biasa of row i; B: corr, colsum of column j
                    a0 += d2;
                    a1 += a * alj;
                    b0[k] += wi * x;
                    b1[k] += d2;
                }
            }
            a0 = warp_sum(a0);
            a1 = warp_sum(a1);
            if (lane == 0 && r < R) {
                if (TRANS) {  // column j = r's partials of tile `tile`
                    pcol[(size_t)tile * n + r] = a0;
                    pcol[(size_t)(tiles + tile) * n + r] = a1;
                } else {      // row i = r's
                    prow[(size_t)tile * m + r] = a0;
                    prow[(size_t)(tiles + tile) * m + r] = a1;
                }
            }
        }
        if (more) {
            if (fills) {
#pragma unroll
                for (int k = 0; k < 4; ++k) sv[(pp + 1) & 1][k][threadIdx.x] = sr[k];
            }
#pragma unroll
            for (int rr = 0; rr < NS_RPW; ++rr)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    xv[rr][k] = xn[rr][k];
                    gv[rr][k] = gn[rr][k];
                }
        }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int c = VEC ? 4 * lane + k : lane + 32 * k;
        red[0][warp][c] = b0[k];
        red[1][warp][c] = b1[k];
    }
    __syncthreads();
    const int q = threadIdx.x / NS_PCOLS, c = threadIdx.x % NS_PCOLS;
    float sum = 0.f;
    for (int w = 0; w < 8; ++w) sum += red[q][w][c];
    if (c0 + c < C) {
        if (TRANS) prow[((size_t)q * groups + group) * m + c0 + c] = sum;
        else pcol[((size_t)q * groups + group) * n + c0 + c] = sum;
    }
}

// The tail, 2: block = cb columns x (256 / cb) part groups. The column
// partials (parts, n) summed in part order (group g the parts g, g + 256 /
// cb, ..., then the groups in order), then per column j: B_last, grad2,
// y = B_last / qr; pdl[block] = sum over the block's columns of
// A_last^2 - B_last^2 (row m-1's diag, in block order later), and the
// maxima of |grad2| and qr.
__global__ void __launch_bounds__(256) ns_cols_kernel(
    int m, int n, int parts, int cb, const float* __restrict__ pcorr,
    const float* __restrict__ pcs, const float* __restrict__ dx, const float* __restrict__ dg,
    int t, const float* __restrict__ ql, const float* __restrict__ qr, float* __restrict__ grad2,
    float* __restrict__ y, float* __restrict__ pdl, unsigned* __restrict__ slots) {
    __shared__ float red[2][256];
    __shared__ float fred[8];
    __shared__ unsigned ured[8];
    const int c = threadIdx.x % cb, pg = threadIdx.x / cb, pgs = 256 / cb;
    const int j = blockIdx.x * cb + c;
    float sc = 0.f, ss = 0.f;
    if (j < n) {
        for (int p = pg; p < parts; p += pgs) {
            sc += pcorr[(size_t)p * n + j];
            ss += pcs[(size_t)p * n + j];
        }
    }
    if (pgs > 1) {
        red[0][threadIdx.x] = sc;
        red[1][threadIdx.x] = ss;
        __syncthreads();
        if (pg == 0) {
            for (int k = 1; k < pgs; ++k) {
                sc += red[0][k * cb + c];
                ss += red[1][k * cb + c];
            }
        }
    }
    float dl = 0.f;
    unsigned g2 = 0u, qk = 0u;
    if (pg == 0 && j < n) {
        const float q0l = ql[m - 1];
        const size_t o = t ? (size_t)j * m + m - 1 : (size_t)(m - 1) * n + j;
        const float q = qr[j];
        const float al = q0l * dg[o] * q;
        const float bl = (dx[o] / q0l - sc) / q;
        const float a2 = al * al, b2 = bl * bl;
        const float g = ss + a2 - b2;
        grad2[j] = g;
        y[j] = bl / q;
        dl = a2 - b2;
        g2 = __float_as_uint(fabsf(g));
        qk = fkey(q);
    }
    dl = block_sum(dl, fred);
    g2 = block_max_u(g2, ured);
    qk = block_max_u(qk, ured);
    if (threadIdx.x == 0) {
        pdl[blockIdx.x] = dl;
        atomicMax(slots + NS_MAX_G2, g2);
        atomicMax(slots + NS_MAX_QR, qk);
    }
}

// The tail, 3, row-major dX: warp u = (row i, chunk ch) of 2048 columns,
// pbt[i chunks + ch] = sum_j dX_ij y_j; four 16-byte loads in flight a lane, or
// eight 4-byte ones where the row pitch is not a multiple of 4.
template <bool VEC>
__global__ void __launch_bounds__(256) ns_btdot_kernel(int m, int n, int chunks,
                                                       const float* __restrict__ dx,
                                                       const float* __restrict__ y,
                                                       float* __restrict__ pbt) {
    const int lane = threadIdx.x & 31;
    const long long u = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
    if (u >= (long long)m * chunks) return;
    const int i = (int)(u / chunks), ch = (int)(u % chunks);
    const int j0 = ch * BT_CHUNK, j1 = min(n, j0 + BT_CHUNK);
    const float* xr = dx + (size_t)i * n;
    float s = 0.f;
    if (VEC) {
        for (int j = j0 + 4 * lane; j < j1; j += 512) {
            float4 xa[4], ya[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const bool ok = j + 128 * k < j1;
                xa[k] = ok ? *reinterpret_cast<const float4*>(xr + j + 128 * k) : make_float4(0.f, 0.f, 0.f, 0.f);
                ya[k] = ok ? *reinterpret_cast<const float4*>(y + j + 128 * k) : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int k = 0; k < 4; ++k)
                s += xa[k].x * ya[k].x + xa[k].y * ya[k].y + xa[k].z * ya[k].z + xa[k].w * ya[k].w;
        }
    } else {
        for (int j = j0 + lane; j < j1; j += 256) {
            float xa[8], ya[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const bool ok = j + 32 * k < j1;
                xa[k] = ok ? xr[j + 32 * k] : 0.f;
                ya[k] = ok ? y[j + 32 * k] : 0.f;
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) s += xa[k] * ya[k];
        }
    }
    s = warp_sum(s);
    if (lane == 0) pbt[(size_t)i * chunks + ch] = s;
}

// The tail, 3, transposed dX ((n, m) in memory): warp u = (32-row tile,
// chunk ch of 256 memory rows), lane = row i, pbt[i chunks + ch].
__global__ void __launch_bounds__(256) ns_btdot_t_kernel(int m, int n, int chunks,
                                                         const float* __restrict__ dxt,
                                                         const float* __restrict__ y,
                                                         float* __restrict__ pbt) {
    const int lane = threadIdx.x & 31, itiles = (m + 31) / 32;
    const long long u = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
    if (u >= (long long)itiles * chunks) return;
    const int i = (int)(u % itiles) * 32 + lane, ch = (int)(u / itiles);
    if (i >= m) return;
    const int j0 = ch * BTT_CHUNK, j1 = min(n, j0 + BTT_CHUNK);
    float s = 0.f;
    for (int j = j0; j < j1; j += 8) {
        float xa[8], ya[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const bool ok = j + k < j1;
            xa[k] = ok ? dxt[(size_t)(j + k) * m + i] : 0.f;
            ya[k] = ok ? y[j + k] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) s += xa[k] * ya[k];
    }
    pbt[(size_t)i * chunks + ch] = s;
}

// The tail, 4: a warp a row i, its lanes over the row's partials, part p
// of row i at p ps + i is (K6's: ps = m, is = 1; K7/K8's strips side by
// side, ps = 1, is = parts) and chunk ch at i chunks + ch, each set summed
// in a fixed order (lane l the parts l, l + 32, ..., then the warp's tree). diag = diag0 (row m-1: the sum of
// pdl in block order, by the whole block), bias = biasa - btdot / q0 (row
// m-1: 0); the maxima of max(|diag|, |bias|) and q0.
__global__ void __launch_bounds__(256) ns_rows_kernel(
    int m, int parts, int ps, int is, int chunks, int ndl, const float* __restrict__ pdiag,
    const float* __restrict__ pbias, const float* __restrict__ pbt, const float* __restrict__ pdl,
    const float* __restrict__ ql, float* __restrict__ diag, float* __restrict__ bias,
    unsigned* __restrict__ slots) {
    __shared__ float fred[8];
    __shared__ unsigned ured[8];
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * 8 + (threadIdx.x >> 5);
    float last = 0.f;
    if (blockIdx.x == (m - 1) / 8) {  // row m-1's diag: pdl in block order
        float s = 0.f;
        for (int k = threadIdx.x; k < ndl; k += 256) s += pdl[k];
        last = block_sum(s, fred);
    }
    unsigned db = 0u, qk = 0u;
    if (i < m) {
        float sd = 0.f, sb = 0.f, st = 0.f;
        for (int p = lane; p < parts; p += 32) {
            sd += pdiag[(size_t)p * ps + (size_t)i * is];
            sb += pbias[(size_t)p * ps + (size_t)i * is];
        }
        for (int ch = lane; ch < chunks; ch += 32) st += pbt[(size_t)i * chunks + ch];
        sd = warp_sum(sd);
        sb = warp_sum(sb);
        st = warp_sum(st);
        const float q0 = ql[i];
        const float d = i == m - 1 ? last : sd, b = i == m - 1 ? 0.f : sb - st / q0;
        if (lane == 0) {
            diag[i] = d;
            bias[i] = b;
        }
        db = __float_as_uint(fmaxf(fabsf(d), fabsf(b)));
        qk = fkey(q0);
    }
    db = block_max_u(db, ured);
    qk = block_max_u(qk, ured);
    if (threadIdx.x == 0) {
        atomicMax(slots + NS_MAX_DB, db);
        atomicMax(slots + NS_MAX_Q0, qk);
    }
}

// The tail, 5: rho = sqrt(max q0 / max qr) and the step scales, then the
// balanced rewrites of the arrow (2, m) and qr (n), as the plain tail
// writes them.
__global__ void __launch_bounds__(256) ns_finish_kernel(int m, int n, const float* __restrict__ ql,
                                                        const float* __restrict__ qr,
                                                        const float* __restrict__ diag,
                                                        const float* __restrict__ bias,
                                                        const float* __restrict__ grad2,
                                                        const unsigned* __restrict__ slots,
                                                        float step, float* __restrict__ out_ql,
                                                        float* __restrict__ out_qr) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const float rho = sqrtf(fkey_inv(slots[NS_MAX_Q0]) / fkey_inv(slots[NS_MAX_QR]));
    if (e < (size_t)m) {
        const float s1 = slot_scale(step, slots[NS_MAX_DB]);
        const float q0 = ql[e] / rho, q1 = ql[m + e] / rho, q0l = ql[m - 1] / rho;
        const float d = diag[e];
        out_ql[e] = q0 - s1 * d * q0;
        out_ql[m + e] = q1 - s1 * (d * q1 + q0l * bias[e]);
    } else if (e < (size_t)m + n) {
        const size_t j = e - m;
        const float s2 = slot_scale(step, slots[NS_MAX_G2]);
        const float q = rho * qr[j];
        out_qr[j] = q - s2 * grad2[j] * q;
    }
}

// ------------------------------------------------------------------- K10

#define DS_MAX_SPLITS 32  // most K bands of the Gram

// the (dense, scale) chain's maxima: |grad1|, |grad2| (float bits),
// diag(Ql) and qr (fkey)
enum DsSlot { DS_MAX_G1 = 0, DS_MAX_G2 = 1, DS_MAX_QL = 2, DS_MAX_QR = 3 };

// The chain's 4: blocks [0, b1) take the m x m Gram elements e: the
// bands' partials summed in band order into grad1 (its upper triangle;
// zeros below), with max|grad1| and the max of diag(Ql); the rest take the
// columns j: the row tiles' column sums of A^2 and of Bt^2, each in tile
// order, into grad2 = sum A^2 - sum Bt^2, with max|grad2| and max qr.
__global__ void __launch_bounds__(256) ds_sums_kernel(
    int m, int n, int splits, int tm, int b1, const float* __restrict__ part,
    const float* __restrict__ pa2, const float* __restrict__ pb2, const float* __restrict__ ql,
    const float* __restrict__ qr, float* __restrict__ grad1, float* __restrict__ grad2,
    unsigned* __restrict__ slots) {
    __shared__ unsigned ured[8];
    unsigned mx = 0u, key = 0u;
    const bool gram = blockIdx.x < b1;
    if (gram) {
        const size_t mm = (size_t)m * m, e = (size_t)blockIdx.x * 256 + threadIdx.x;
        if (e < mm) {
            const size_t i = e / m, j = e % m;
            float v = 0.f;
            if (i <= j)
                for (int k = 0; k < splits; ++k) v += part[(size_t)k * mm + e];
            grad1[e] = v;
            mx = __float_as_uint(fabsf(v));
            if (i == j) key = fkey(ql[e]);
        }
    } else {
        const int j = (blockIdx.x - b1) * 256 + threadIdx.x;
        if (j < n) {
            float sa = 0.f, sb = 0.f;
            for (int k = 0; k < tm; ++k) {
                sa += pa2[(size_t)k * n + j];
                sb += pb2[(size_t)k * n + j];
            }
            const float g = sa - sb;
            grad2[j] = g;
            mx = __float_as_uint(fabsf(g));
            key = fkey(qr[j]);
        }
    }
    mx = block_max_u(mx, ured);
    key = block_max_u(key, ured);
    if (threadIdx.x == 0) {
        atomicMax(slots + (gram ? DS_MAX_G1 : DS_MAX_G2), mx);
        atomicMax(slots + (gram ? DS_MAX_QL : DS_MAX_QR), key);
    }
}

// The chain's 6: rho = sqrt(max diag(Ql) / max qr) and the step scales;
// out_ql = (Ql - s1 grad1 Ql) / rho, grad1 Ql's upper triangle summed over
// its K bands in order (zero below: both factors are upper triangular);
// out_qr = rho qr - s2 grad2 rho qr.
__global__ void __launch_bounds__(256) ds_finish_kernel(int m, int n, int usplits,
                                                        const float* __restrict__ ql,
                                                        const float* __restrict__ qr,
                                                        const float* __restrict__ gq,
                                                        const float* __restrict__ grad2,
                                                        const unsigned* __restrict__ slots,
                                                        float step, float* __restrict__ out_ql,
                                                        float* __restrict__ out_qr) {
    const size_t mm = (size_t)m * m, e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const float rho = sqrtf(fkey_inv(slots[DS_MAX_QL]) / fkey_inv(slots[DS_MAX_QR]));
    if (e < mm) {
        float c = 0.f;
        if (e / m <= e % m)
            for (int k = 0; k < usplits; ++k) c += gq[(size_t)k * mm + e];
        const float s1 = slot_scale(step, slots[DS_MAX_G1]);
        out_ql[e] = (ql[e] - s1 * c) / rho;
    } else if (e < mm + n) {
        const size_t j = e - mm;
        const float s2 = slot_scale(step, slots[DS_MAX_G2]);
        const float q = rho * qr[j];
        out_qr[j] = q - s2 * grad2[j] * q;
    }
}

struct DsPlan {
    int tm, splits, usplits;
    size_t slots, linv, a, bt, part, grad1, grad2, gq, total;  // offsets in floats
};

// a K split: bands of whole GEMM K steps (16), each >= `band` columns, at
// most `most`, as many as two blocks an SM of `tiles` tiles take
static int ds_splits(int k, int tiles, int band, int most) {
    const int want = std::max(1, std::min(std::min(most, k / band), 2 * gemm_sms() / tiles));
    const int chunk = ((k + want - 1) / want + 15) / 16 * 16;
    return (k + chunk - 1) / chunk;
}

// The Gram's K = n and grad1 Ql's K = m, each split in bands of >= 64
// (a narrow layer's few tiles walk K = n in many short bands). A and Bt
// are followed by their row tiles' column sums.
static DsPlan ds_plan(int m, int n) {
    DsPlan p = {};
    p.tm = (m + 63) / 64;
    const int upper = p.tm * (p.tm + 1) / 2;
    p.splits = ds_splits(n, upper, 64, DS_MAX_SPLITS);
    p.usplits = ds_splits(m, upper, 64, DS_MAX_SPLITS);
    size_t cur = 0;
    auto take = [&](size_t count) { size_t o = cur; cur += psgd_align4(count); return o; };
    const size_t mm = (size_t)m * m, mn = (size_t)m * n + (size_t)p.tm * n;
    p.slots = take(SLOT_FLOATS);
    p.linv = take(mm);
    p.a = take(mn);
    p.bt = take(mn);
    p.part = take((size_t)p.splits * mm);
    p.grad1 = take(mm);
    p.grad2 = take(n);
    p.gq = take((size_t)p.usplits * mm);
    p.total = cur;
    return p;
}

extern "C" size_t psgd_kron_ds_update_scratch_floats(int m, int n) { return ds_plan(m, n).total; }

// The (dense, scale) update: Ql (m, m) upper triangular, qr (n,), dX and
// dG (m, n) row-major or, by flag, views of (n, m) row-major arrays.
// Writes the balanced, updated out_ql (m, m) and out_qr (n,).
extern "C" int psgd_kron_ds_update(int m, int n, const void* ql, const void* qr, const void* dx,
                                   int dx_t, const void* dg, int dg_t, float step, void* out_ql,
                                   void* out_qr, void* scratch, void* stream_ptr) {
    if (m < 1 || n < 1 || m > 1024) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const DsPlan p = ds_plan(m, n);
    float* s = static_cast<float*>(scratch);
    unsigned* slots = reinterpret_cast<unsigned*>(s + p.slots);
    const float* Ql = static_cast<const float*>(ql);
    const float* q = static_cast<const float*>(qr);
    float* A = s + p.a;
    float* Bt = s + p.bt;
    const size_t mn = (size_t)m * n;
    cudaError_t e = cudaMemsetAsync(slots, 0, SLOT_FLOATS * sizeof(unsigned), stream);
    if (e != cudaSuccess) return (int)e;

    // 1. Linv = Ql^{-1} (K3)
    TriBatch tri;
    tri.count = 1;
    tri.u[0] = Ql;
    tri.x[0] = s + p.linv;
    tri.n[0] = m;
    launch_tri_inv(tri, stream);
    // 2. A = (Ql dG) qr,  Bt = (Linv^T dX) / qr, with their column sums of
    //    squares; a transposed probe is an (n, m) array read through the
    //    GEMM's transpose flag
    GemmBatch g;
    g.count = 2;
    g.p[0] = gemm_prob(Ql, 0, m, static_cast<const float*>(dg), dg_t, dg_t ? m : n, A, m, n, m);
    g.p[0].epi = EPI_COLMUL | EPI_COLSQ;
    g.p[0].v = q;
    g.p[0].cut = CUT_A_UPPER;
    g.p[1] = gemm_prob(s + p.linv, 1, m, static_cast<const float*>(dx), dx_t, dx_t ? m : n, Bt, m,
                       n, m);
    g.p[1].epi = EPI_COLDIV | EPI_COLSQ;
    g.p[1].v = q;
    g.p[1].cut = CUT_A_LOWER;
    launch_gemms(g, stream);
    // 3. the upper tiles of A A^T - Bt Bt^T, K = n in bands
    g.count = 1;
    g.p[0] = gemm_prob(A, 0, n, A, 1, n, s + p.part, m, m, n);
    g.p[0].a2 = Bt;
    g.p[0].b2 = Bt;
    g.p[0].epi = EPI_TRIU | EPI_UPPER;
    launch_gemms(g, stream, p.splits);
    // 4. grad1, grad2 and the maxima
    const int b1 = cdiv((long long)m * m, 256);
    ds_sums_kernel<<<b1 + cdiv(n, 256), 256, 0, stream>>>(
        m, n, p.splits, p.tm, b1, s + p.part, A + mn, Bt + mn, Ql, q, s + p.grad1, s + p.grad2,
        slots);
    // 5. the upper tiles of grad1 Ql (both factors upper: K loops cut to
    //    the band between them), K = m in bands
    g.p[0] = gemm_prob(s + p.grad1, 0, m, Ql, 0, m, s + p.gq, m, m, m);
    g.p[0].epi = EPI_STORE | EPI_UPPER;
    g.p[0].cut = CUT_A_UPPER | CUT_B_UPPER;
    launch_gemms(g, stream, p.usplits);
    // 6. the step scales, rho and the balanced factors
    ds_finish_kernel<<<cdiv((long long)m * m + n, 256), 256, 0, stream>>>(
        m, n, p.usplits, Ql, q, s + p.gq, s + p.grad2, slots, step, static_cast<float*>(out_ql),
        static_cast<float*>(out_qr));
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

// grid (strips): each block owns NSW_STRIP lanes and walks every row; its
// row partials go to pdiag / pbias[i strips + strip].
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
                (which ? pbias : pdiag)[(size_t)i * gridDim.x + blockIdx.x] = s;
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

static int ns_wide_strips(int n) { return (n + NSW_STRIP - 1) / NSW_STRIP; }

// The vectors K7/K8's pass reads: w (m), dG_last and A_last (n).
__global__ void __launch_bounds__(256) ns_wide_vecs_kernel(int m, int n, const float* __restrict__ dg,
                                                           int t, const float* __restrict__ ql,
                                                           const float* __restrict__ qr,
                                                           float* __restrict__ w,
                                                           float* __restrict__ dgl,
                                                           float* __restrict__ al) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const float q0l = ql[m - 1];
    if (e < (size_t)m) {
        w[e] = ql[m + e] / (ql[e] * q0l);
    } else if (e < (size_t)m + n) {
        const size_t j = e - m;
        const float gl = dg[t ? j * m + m - 1 : (size_t)(m - 1) * n + j];
        dgl[j] = gl;
        al[j] = q0l * gl * qr[j];
    }
}

// ---------------------------------------- K6 and K7/K8: the one C call

// The scratch of one (norm, scale) call, as offsets in floats, and its grids.
struct NsPlan {
    int R, C, tiles, ppg, groups;  // K6's pass
    int strips;                    // K7/K8's pass
    int parts_r, parts_c, cb, col_blocks, chunks;
    size_t slots, w, dgl, al, prow, pcol, grad2, y, pdl, pbt, diag, bias, total;
};

static NsPlan ns_plan(int m, int n, int t, int wide) {
    NsPlan p = {};
    size_t cur = 0;
    auto take = [&](size_t count) { size_t o = cur; cur += psgd_align4(count); return o; };
    p.slots = take(SLOT_FLOATS);
    if (wide) {
        p.strips = ns_wide_strips(n);
        p.parts_r = p.strips;
        p.parts_c = 1;
        p.w = take(m);
        p.dgl = take(n);
        p.al = take(n);
    } else {
        p.R = t ? n : m;
        p.C = t ? m : n;
        p.tiles = cdiv(p.C, NS_PCOLS);
        const int panels = cdiv(p.R, NS_PROWS);
        const int target = std::max(1, NS_BLOCKS_PER_SM * gemm_sms() / p.tiles);
        p.groups = std::min(std::min(panels, NS_MAX_GROUPS), target);
        p.ppg = cdiv(panels, p.groups);
        p.groups = cdiv(panels, p.ppg);
        p.parts_r = t ? p.groups : p.tiles;  // (diag0, biasa): B sums transposed, A sums not
        p.parts_c = t ? p.tiles : p.groups;
    }
    p.prow = take(2 * (size_t)p.parts_r * m);
    p.pcol = take(2 * (size_t)p.parts_c * n);
    p.cb = p.parts_c > 1 ? 32 : 256;
    p.col_blocks = cdiv(n, p.cb);
    p.chunks = cdiv(n, t ? BTT_CHUNK : BT_CHUNK);
    p.grad2 = take(n);
    p.y = take(n);
    p.pdl = take(p.col_blocks);
    p.pbt = take((size_t)p.chunks * m);
    p.diag = take(m);
    p.bias = take(m);
    p.total = cur;
    return p;
}

extern "C" size_t psgd_kron_ns_update_scratch_floats(int m, int n, int t, int wide) {
    return ns_plan(m, n, t, wide).total;
}

// The (norm, scale) update: ql (2, m) [q0; q1], qr (n,), the probes (m, n)
// row-major, or both (n, m) row-major when t (views dX.T). wide: K7/K8's
// pass (scale sides past 131,072 lanes), else K6's. Writes the balanced,
// updated out_ql (2, m) and out_qr (n,); the inputs are not written.
extern "C" int psgd_kron_ns_update(int m, int n, const void* ql, const void* qr, const void* dx,
                                   const void* dg, int t, int wide, float step, void* out_ql,
                                   void* out_qr, void* scratch, void* stream_ptr) {
    if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
    const NsPlan p = ns_plan(m, n, t, wide);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    float* s = static_cast<float*>(scratch);
    unsigned* slots = reinterpret_cast<unsigned*>(s + p.slots);
    const float* X = static_cast<const float*>(dx);
    const float* G = static_cast<const float*>(dg);
    const float* Q = static_cast<const float*>(ql);
    const float* S = static_cast<const float*>(qr);
    cudaError_t e = cudaMemsetAsync(slots, 0, SLOT_FLOATS * sizeof(unsigned), stream);
    if (e != cudaSuccess) return (int)e;
    float* prow = s + p.prow;
    float* pcol = s + p.pcol;
    if (wide) {
        ns_wide_vecs_kernel<<<cdiv((long long)m + n, 256), 256, 0, stream>>>(
            m, n, G, t, Q, S, s + p.w, s + p.dgl, s + p.al);
        ns_wide_kernel<<<p.strips, NSW_THREADS, 0, stream>>>(
            m, n, X, t, G, t, Q, Q + m, s + p.w, S, s + p.dgl, s + p.al, pcol, pcol + n, prow,
            prow + (size_t)p.strips * m);
    } else {
        const bool vec = p.C % 4 == 0 && aligned16(X) && aligned16(G);
        const int blocks = p.tiles * p.groups;
        if (vec && t)
            ns_pass_kernel<true, true><<<blocks, 256, 0, stream>>>(m, n, p.tiles, p.ppg, X, G, Q, S, prow, pcol);
        else if (vec)
            ns_pass_kernel<true, false><<<blocks, 256, 0, stream>>>(m, n, p.tiles, p.ppg, X, G, Q, S, prow, pcol);
        else if (t)
            ns_pass_kernel<false, true><<<blocks, 256, 0, stream>>>(m, n, p.tiles, p.ppg, X, G, Q, S, prow, pcol);
        else
            ns_pass_kernel<false, false><<<blocks, 256, 0, stream>>>(m, n, p.tiles, p.ppg, X, G, Q, S, prow, pcol);
    }
    ns_cols_kernel<<<p.col_blocks, 256, 0, stream>>>(
        m, n, p.parts_c, p.cb, pcol, pcol + (size_t)p.parts_c * n, X, G, t, Q, S, s + p.grad2,
        s + p.y, s + p.pdl, slots);
    if (t) {
        ns_btdot_t_kernel<<<cdiv((long long)cdiv(m, 32) * p.chunks, 8), 256, 0, stream>>>(
            m, n, p.chunks, X, s + p.y, s + p.pbt);
    } else if (n % 4 == 0 && aligned16(X)) {
        ns_btdot_kernel<true><<<cdiv((long long)m * p.chunks, 8), 256, 0, stream>>>(
            m, n, p.chunks, X, s + p.y, s + p.pbt);
    } else {
        ns_btdot_kernel<false><<<cdiv((long long)m * p.chunks, 8), 256, 0, stream>>>(
            m, n, p.chunks, X, s + p.y, s + p.pbt);
    }
    ns_rows_kernel<<<cdiv(m, 8), 256, 0, stream>>>(
        m, p.parts_r, wide ? 1 : m, wide ? p.parts_r : 1, p.chunks, p.col_blocks, prow,
        prow + (size_t)p.parts_r * m, s + p.pbt, s + p.pdl, Q, s + p.diag, s + p.bias, slots);
    ns_finish_kernel<<<cdiv((long long)m + n, 256), 256, 0, stream>>>(
        m, n, Q, S, s + p.diag, s + p.bias, s + p.grad2, slots, step,
        static_cast<float*>(out_ql), static_cast<float*>(out_qr));
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
// panel is written. Blocks here run in no order, so each block writes its
// partial sums over its rows to a (row blocks, n) scratch, and a last
// small launch adds the partials to row m-1 in a fixed order: no atomics,
// a run repeats itself bit for bit. Nothing is padded: lanes past n and
// rows past m are masked (the JAX package's 128-lane and row-block padding
// exists for the TPU's tiling alone).
//
// (norm, scale), K17 ns and K18: apply_ns_kernel, a block a strip of
// AP_STRIP lanes by a chunk of rows, each thread AP_ROWS x AP_LANES loads in
// flight. What bounds it: memory, G read once and the output written once
// (8 m n bytes: 4.1 GB at (512, 10^6), 1.22 ms at 3.35 TB/s).
//
// (norm, dense), K17 nd: apply_nd_kernel, a GEMM of its own, as the TPU
// kernel computes the product inside its pallas_call. What bounds it:
// operations, the product by R (2 m n^2 FLOPs: 68.7 GFLOP at (131072, 512),
// 1.03 ms at the fp32 peak). The chain before it wrote preG = Ql G into an
// (m, n) scratch, ran kron_dd.cu's grouped GEMM into the output and
// rewrote the output in place: four launches and two extra streams of
// 268 MB at (131072, 512), 2.44 ms queued of which the GEMM 1.97 (H100 80GB
// HBM3, 700 W, tools/profile_kron_chain.py --apply-nd). Here the arrow
// lives in the GEMM's A-operand load, each element of a row tile formed as
// q0_i G_ik + q1_i G_{m-1,k} on its way to shared memory (the G_{m-1} strip
// of each k-step staged once per block beside R's slab), and out_i = q0_i
// z_i and each tile's column sums of q1_i z_i in its epilogue: G is read
// once, the output written once, no (m, n) intermediate, two launches
// (the product, then apply_nd_last_kernel adds the row tiles' sums to row
// m-1 in tile order). The tile: 128 x 128 outputs a block (64 x 64 where
// those tiles would not give every SM four), 256 threads of 8 x 8 (4 x 4)
// fp32 SIMT FMAs each, as kron_dd.cu's; K steps of ND_BK = 16 through two
// shared-memory stages, the next step's G loads (16 bytes along K where
// n % 4 == 0 and the pointers are aligned, else 4) held in registers and
// R's slab copied by cp.async while the current step's FMAs run. Each
// output is one FMA chain over k, rising.

#define AP_THREADS 256
#define AP_LANES 4                         // lanes a thread owns, AP_THREADS apart
#define AP_STRIP (AP_LANES * AP_THREADS)   // lanes a block owns
#define AP_ROWS 4                          // rows a step of the walk loads at once
#define AP_MIN_ROWS 16                     // fewest rows a chunk takes
#define AP_TARGET_BLOCKS (132 * 8)         // one wave of 256-thread blocks on 132 SMs

// grid (strips, chunks): out = q0 z with z = (q0 g + q1 G_{m-1}) qr^2, and
// the block's partial sum_i q1_i z_i of each lane in pcol[chunk n + j]
__global__ void __launch_bounds__(AP_THREADS) apply_ns_kernel(
    int m, int n, int rows, const float* __restrict__ src, const float* __restrict__ ql,
    const float* __restrict__ qr, float* __restrict__ out, float* __restrict__ pcol) {
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
        const float q = ok[c] ? qr[j[c]] : 1.f;
        rr[c] = q * q;
        gl[c] = ok[c] ? src[(size_t)(m - 1) * n + j[c]] : 0.f;
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
                const float z = (a * v[r][c] + b * gl[c]) * rr[c];
                if (ok[c]) out[(size_t)i * n + j[c]] = a * z;
                acc[c] += b * z;
            }
        }
    }
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

#define ND_BK 16        // K depth of a step
#define ND_THREADS 256

template <int Q>
struct NdTile {
    static constexpr int BM = 64 * Q, BN = 64 * Q, LDA = BM + 4, LDB = BN + 4;
    // a stage: A's slab As[k][i] (transformed), R's Bs[k][j], the G_{m-1} strip
    static constexpr int SA = ND_BK * LDA, SB = ND_BK * LDB, STAGE = SA + SB + ND_BK;
};

__device__ __forceinline__ void nd_cp16(float* dst, const float* src, int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void nd_cp4(float* dst, const float* src, bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 4 : 0));
}

// 16 bytes of x[0..3] where the first `valid` lie in range (zeros past them)
__device__ __forceinline__ void nd_cp_quad(float* dst, const float* x, int valid, bool vec,
                                           const float* any) {
    if (vec) {
        nd_cp16(dst, valid > 0 ? x : any, 4 * max(0, min(4, valid)));
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) nd_cp4(dst + e, e < valid ? x + e : any, e < valid);
    }
}

// One output tile of P G (the product and out_i = q0_i z_i), and its column
// sums of q1_i z_i into pcol's row (row0 / BM); grid: the tiles, row-major
// (a row's column tiles adjacent: they share G's rows in L2). vec: n % 4 ==
// 0 and G, R, out 16-byte aligned.
template <int Q>
__global__ void __launch_bounds__(ND_THREADS, 2) apply_nd_kernel(
    int m, int n, const float* __restrict__ G, const float* __restrict__ ql,
    const float* __restrict__ R, float* __restrict__ out, float* __restrict__ pcol, int vec) {
    using T = NdTile<Q>;
    __shared__ __align__(16) float sm[2 * T::STAGE];
    const int tiles_n = (n + T::BN - 1) / T::BN;
    const int row0 = blockIdx.x / tiles_n * T::BM, col0 = blockIdx.x % tiles_n * T::BN;
    const int t = threadIdx.x, tx = t % 16, ty = t / 16;
    const float *q0 = ql, *q1 = ql + m, *gl = G + (size_t)(m - 1) * n;

    // A: Q quads a thread, rows row0 + ar + 64 u, lanes 4 ac .. 4 ac + 3 of the step
    const int ar = t / 4, ac = t % 4;
    float qa0[Q], qa1[Q];
    float4 ra[Q];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
        const int i = row0 + ar + 64 * u;
        qa0[u] = i < m ? q0[i] : 0.f;
        qa1[u] = i < m ? q1[i] : 0.f;
    }
    auto load_a = [&](int k0) {
        const int k = k0 + 4 * ac;
#pragma unroll
        for (int u = 0; u < Q; ++u) {
            const int i = row0 + ar + 64 * u;
            const float* p = G + (size_t)i * n + k;
            if (i >= m) {
                ra[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            } else if (vec && k + 3 < n) {
                ra[u] = *reinterpret_cast<const float4*>(p);
            } else {
                ra[u].x = k < n ? p[0] : 0.f;
                ra[u].y = k + 1 < n ? p[1] : 0.f;
                ra[u].z = k + 2 < n ? p[2] : 0.f;
                ra[u].w = k + 3 < n ? p[3] : 0.f;
            }
        }
    };
    // R's slab (ND_BK x BN) and the G_{m-1} strip of the step at k0, in flight
    auto load_b = [&](float* st, int k0) {
        float* Bs = st + T::SA;
#pragma unroll
        for (int u = 0; u < Q; ++u) {
            const int e = t + ND_THREADS * u, kk = e / (16 * Q), jq = e % (16 * Q) * 4;
            const int gk = k0 + kk, gj = col0 + jq;
            nd_cp_quad(Bs + kk * T::LDB + jq, R + (size_t)gk * n + gj, gk < n ? n - gj : 0,
                       vec, R);
        }
        if (t < ND_BK / 4) nd_cp_quad(st + T::SA + T::SB + 4 * t, gl + k0 + 4 * t,
                                      n - k0 - 4 * t, vec, R);
        asm volatile("cp.async.commit_group;\n" ::);
    };
    // the transformed quads into the stage's As[k][i]
    auto store_a = [&](float* st) {
        const float4 g = *reinterpret_cast<const float4*>(st + T::SA + T::SB + 4 * ac);
#pragma unroll
        for (int u = 0; u < Q; ++u) {
            float* a = st + 4 * ac * T::LDA + ar + 64 * u;
            a[0] = fmaf(qa0[u], ra[u].x, qa1[u] * g.x);
            a[T::LDA] = fmaf(qa0[u], ra[u].y, qa1[u] * g.y);
            a[2 * T::LDA] = fmaf(qa0[u], ra[u].z, qa1[u] * g.z);
            a[3 * T::LDA] = fmaf(qa0[u], ra[u].w, qa1[u] * g.w);
        }
    };

    float acc[4 * Q][4 * Q];
#pragma unroll
    for (int i = 0; i < 4 * Q; ++i)
#pragma unroll
        for (int j = 0; j < 4 * Q; ++j) acc[i][j] = 0.f;
    const int steps = (n + ND_BK - 1) / ND_BK;
    load_a(0);
    load_b(sm, 0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    store_a(sm);
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
        float* cur = sm + (s & 1) * T::STAGE;
        float* nxt = sm + ((s & 1) ^ 1) * T::STAGE;
        const bool more = s + 1 < steps;
        if (more) {
            load_a((s + 1) * ND_BK);
            load_b(nxt, (s + 1) * ND_BK);
        }
        const float *As = cur, *Bs = cur + T::SA;
#pragma unroll
        for (int kk = 0; kk < ND_BK; ++kk) {
            float a[4 * Q], b[4 * Q];
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const float4 x = *reinterpret_cast<const float4*>(As + kk * T::LDA + q * 64 + ty * 4);
                const float4 y = *reinterpret_cast<const float4*>(Bs + kk * T::LDB + q * 64 + tx * 4);
                a[4 * q] = x.x, a[4 * q + 1] = x.y, a[4 * q + 2] = x.z, a[4 * q + 3] = x.w;
                b[4 * q] = y.x, b[4 * q + 1] = y.y, b[4 * q + 2] = y.z, b[4 * q + 3] = y.w;
            }
#pragma unroll
            for (int i = 0; i < 4 * Q; ++i)
#pragma unroll
                for (int j = 0; j < 4 * Q; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
        }
        if (more) {
            asm volatile("cp.async.wait_group 0;\n" ::);
            __syncthreads();  // the G_{m-1} strip has landed for every thread
            store_a(nxt);
        }
        __syncthreads();
    }

    // epilogue: out_i = q0_i z_i; the tile's column sums of q1_i z_i, each
    // thread's rows in order, then the 16 row groups in order, into pcol
    float cs[4 * Q];
#pragma unroll
    for (int j = 0; j < 4 * Q; ++j) cs[j] = 0.f;
#pragma unroll
    for (int ii = 0; ii < 4 * Q; ++ii) {
        const int i = row0 + (ii / 4) * 64 + ty * 4 + ii % 4;
        if (i >= m) continue;
        const float a0 = q0[i], a1 = q1[i];
        float* o = out + (size_t)i * n;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int j = col0 + q * 64 + tx * 4;
            float z[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                z[e] = a0 * acc[ii][4 * q + e];
                cs[4 * q + e] += a1 * acc[ii][4 * q + e];
            }
            if (vec && j + 3 < n) {
                *reinterpret_cast<float4*>(o + j) = make_float4(z[0], z[1], z[2], z[3]);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (j + e < n) o[j + e] = z[e];
            }
        }
    }
    float* red = sm;  // [16][BN]: free since the loop's last barrier
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[ty * T::BN + q * 64 + tx * 4 + e] = cs[4 * q + e];
    __syncthreads();
    float* prow = pcol + (size_t)(blockIdx.x / tiles_n) * n;
    for (int c = t; c < T::BN; c += ND_THREADS) {
        float sum = 0.f;
#pragma unroll
        for (int y = 0; y < 16; ++y) sum += red[y * T::BN + c];
        if (col0 + c < n) prow[col0 + c] = sum;
    }
}

// out[m-1, j] += the sum of pcol[c, j] over the row tiles c: 32 columns a
// block, warp w summing the tiles c = w, w + 8, ... in order (coalesced
// rows), then the eight warps' sums in warp order
__global__ void __launch_bounds__(256) apply_nd_last_kernel(int m, int n, int tiles,
                                                            const float* __restrict__ pcol,
                                                            float* __restrict__ out) {
    __shared__ float part[8][32];
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32, j = blockIdx.x * 32 + lane;
    float s = 0.f;
    if (j < n)
        for (int c = w; c < tiles; c += 8) s += pcol[(size_t)c * n + j];
    part[w][lane] = s;
    __syncthreads();
    if (w == 0 && j < n) {
        float t = part[0][lane];
        for (int k = 1; k < 8; ++k) t += part[k][lane];
        out[(size_t)(m - 1) * n + j] += t;
    }
}

// the (norm, dense) tile: 128 x 128 where those tiles give every SM four,
// else 64 x 64 (at the NMT layers, (1281, 1024) to (9414, 256), the 64 x 64
// tiles ran 0.049-0.249 ms against 0.056-0.281 for 128 x 128: H100 80GB
// HBM3, 700 W)
static int apply_nd_side(int m, int n) {
    const long long big = (long long)((m + 127) / 128) * ((n + 127) / 128);
    return big >= 4LL * gemm_sms() ? 128 : 64;
}

extern "C" size_t psgd_kron_apply_scratch_floats(int m, int n, int dense) {
    if (dense) return psgd_align4((size_t)((m + 63) / 64) * n);  // a row of sums a 64-row tile at most
    int strips, chunks, rows;
    apply_grid(m, n, strips, chunks, rows);
    return psgd_align4((size_t)chunks * n);
}

extern "C" int psgd_kron_apply_ns(int m, int n, const void* g, const void* ql, const void* qr,
                                  void* out, void* scratch, void* stream_ptr) {
    if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    int strips, chunks, rows;
    apply_grid(m, n, strips, chunks, rows);
    float* pcol = static_cast<float*>(scratch);
    float* o = static_cast<float*>(out);
    apply_ns_kernel<<<dim3(strips, chunks), AP_THREADS, 0, stream>>>(
        m, n, rows, static_cast<const float*>(g), static_cast<const float*>(ql),
        static_cast<const float*>(qr), o, pcol);
    apply_last_row_kernel<<<(n + 255) / 256, 256, 0, stream>>>(m, n, chunks, pcol, o);
    return (int)cudaGetLastError();
}

// r: R = Qr^T Qr (n, n); scratch: psgd_kron_apply_scratch_floats(m, n, 1)
extern "C" int psgd_kron_apply_nd(int m, int n, const void* g, const void* ql, const void* r,
                                  void* out, void* scratch, void* stream_ptr) {
    if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
    const int side = apply_nd_side(m, n);
    const long long tiles = (long long)((m + side - 1) / side) * ((n + side - 1) / side);
    if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const float *G = static_cast<const float*>(g), *q = static_cast<const float*>(ql),
                *R = static_cast<const float*>(r);
    float* o = static_cast<float*>(out);
    float* pcol = static_cast<float*>(scratch);
    const int vec = n % 4 == 0 && aligned16(G) && aligned16(R) && aligned16(o);
    if (side == 128)
        apply_nd_kernel<2><<<(unsigned)tiles, ND_THREADS, 0, stream>>>(m, n, G, q, R, o, pcol, vec);
    else
        apply_nd_kernel<1><<<(unsigned)tiles, ND_THREADS, 0, stream>>>(m, n, G, q, R, o, pcol, vec);
    apply_nd_last_kernel<<<(n + 31) / 32, 256, 0, stream>>>(m, n, (m + side - 1) / side, pcol, o);
    return (int)cudaGetLastError();
}
