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
// Q at n = 1536 is 9.4 MB: no block's 227 KB of shared memory holds it, but
// the card's 50 MB L2 does, so on Hopper the TPU's VMEM split becomes an L2
// split: K11 (n <= 1536) is latency-bound, K12 (n <= 16384) streams Q from
// HBM. Both run the same phases, device functions over 128 x 128 blocks of Q
// (DP), in a fixed number of launches whatever n:
//   prep    the diagonal blocks gathered (ragged last one at its own side)
//           and inverted by K3's bodies (tri_inv.cuh), a grid barrier a K3
//           phase; the chain's flags and counters zeroed;
//   pass 1  Q read once for a = Q h, b = Q^{-T} v and (with g) Q g. The
//           forward substitution runs inside the launch: work items take
//           tickets (an atomic counter) in panel order, and an item waits
//           only on items of lower tickets, so it progresses without a
//           cooperative launch. Item D(p) holds Dinv_p, Q_pp and Q_{p,p+1}
//           in shared memory, takes the running sum of the contributions
//           of panels < p - 1 to its columns and D(p - 1)'s own, forms
//           b_p = Dinv_p^T r_p, and publishes at once its contribution to
//           panel p + 1 (the look-ahead), then b_p. Items R(p, k) hold two
//           blocks right of that, take b_p and add their contribution to
//           panel p - 1's running sum of each column. Values travel with
//           their flag in one 64-bit word: no fence, no counter, one
//           round trip a step. D(p + 1) takes its ticket before R(p, *)
//           and prefetches its blocks into L2, so its loads are done when
//           the chain reaches it. The last item of a panel to finish sums
//           the panel's a and Q g partials in item order and, with g, the
//           panel's own reverse cumulative sums of a * Qg and b * Qg;
//   norm    max|triu(a a^T - b b^T)| over 128 x 128 tiles (a running max
//           a thread, one atomicMax on the float bits a block: a max does
//           not depend on the order) and, with g, the panels' totals
//           summed into suffixes, so RA = revcumsum(a * Qg) and
//           RB = revcumsum(b * Qg) are a panel's sums plus its suffix;
//   pass 2  Q read once more and Q' written once. u = Q' g costs no pass:
//           u = Qg - s0 (a * RA - b * RB), exact in real arithmetic. Items
//           take tickets in reverse panel order; block (p, c) sums its
//           columns of a * Q and b * Q and publishes them, takes the sums
//           over the panels below (the inclusive carry of the next panel
//           that is a multiple of DCHK, chained, and the column sums of
//           the panels between: a chain step every DCHK panels, with the
//           chain's own sums and order), then rewrites the block from
//           shared memory with its reverse running sums, stores Q' by
//           16-byte rows, and adds its share of P' g = Q'^T u as a panel's
//           column partial; the last block of a column to finish sums the
//           partials in panel order. Block (p, c) also writes the zeros of
//           block (c, p) below the diagonal, by 16-byte stores.
// K12 launches these as four kernels (prep cooperative, pass 1, norm,
// pass 2): kernel boundaries stand for K11's barriers. K11 runs every phase
// in ONE cooperative launch of a resident grid (dense_mono_kernel), a grid
// barrier between two phases and none inside a pass; for n <= 128 its grid
// is a single block, launched plainly, each barrier a __syncthreads and
// Q's one block in shared memory. No sum anywhere is taken by float atomics, so a call
// repeats itself bit for bit. Rows of n % 4 != 0 floats are not 16-byte
// aligned: then every copy is 4 bytes (the template flag V4).
//
// What bounds it: update + apply must read Q's upper triangle and write Q'
// (n^2 floats, zeros included): 1.61 GB at n = 16384, 0.48 ms at 3.35 TB/s.
// This chain reads the upper triangle twice (passes 1 and 2) and writes Q'
// once, 2.15 GB, as the JAX design does, and pass 2 alone streams at close
// to the card's rate. Pass 1 is latency-bound: its critical path is nb
// dependent steps, each one round trip of a flagged word through L2 and
// two 128 x 128 matvecs from shared memory, and the round trips slow down
// under the pass's own HBM traffic at large n. At n <= 1536 (K11) the
// grid barriers around K3's six phases and the chain's steps set the time,
// not bytes. The measurements are in PERF.md (section 6, PR 14).
#include "psgd.cuh"
#include "tri_inv.cuh"

#include <cooperative_groups.h>
#include <algorithm>
#include <cfloat>
#include <cstdint>

#define DP 128                 // rows of a panel = side of a block
#define DBLK (DP * DP)
#define DHALF (DP / 2)
#define DTHREADS 256
// pass 2's carries chain through every DCHK-th panel; a block sums the
// panels between directly
#define DCHK 8

// shared memory, floats: pass 1 three blocks and its vectors, pass 2 one
// block and its vectors, K3's panels and two single-factor plans
#define D1_FLOATS (3 * DBLK + 16 * DP + 8)
#define D2_FLOATS (DBLK + 12 * DP + 8)
#define DT_PLAN_FLOATS ((sizeof(TriBatch) + 15) / 16 * 4)
#define DT_FLOATS (TRI_SMEM_FLOATS + 2 * DT_PLAN_FLOATS)
#define DN_FLOATS (4 * DP + DTHREADS + 8)
#define DMAX2(a, b) ((a) > (b) ? (a) : (b))
#define DMONO_FLOATS DMAX2(DMAX2(D1_FLOATS, D2_FLOATS), DMAX2(DT_FLOATS, DN_FLOATS))

struct DenseArgs {
    const float* q;
    const float* v;
    const float* h;
    const float* g;  // null: update alone
    float* qout;
    float* pre;
    float step;
    int n, nb, mlast, regs;  // regs: pass-1 items of panel 0, the stride of the partials
    // scratch, written inside the chain: read through __ldcg or plain
    // loads after a barrier, never through the read-only path
    float *diag, *dinv, *bvec, *apart, *gpart, *avec, *qg, *ra, *rb, *tot, *suf, *pgpart;
    unsigned int* mx;
    int* ints;  // tickets and counters (dense_ints)
    // values published with their flag in one 64-bit word (d_put): D(p)'s
    // look-ahead contribution and b_p (nb x DP each), R items'
    // contributions (nb x n), pass 2's carries and blocks' column sums (nb x
    // n each). mx, ints, la, bw and cw are consecutive in the scratch, zeroed
    // as one range.
    unsigned long long *la, *bw, *cw, *cpa, *cpb, *lwa, *lwb;
};

// the int scratch: [0] pass-1 tickets, [1] pass-2 tickets, then nb each of
// rows_done, col_done
__host__ __device__ static inline size_t dense_ints(int nb) { return 2 + 2 * (size_t)nb; }
__device__ __forceinline__ int* d_rows_done(const DenseArgs& A) { return A.ints + 2; }
__device__ __forceinline__ int* d_col_done(const DenseArgs& A) { return A.ints + 2 + A.nb; }

__host__ __device__ __forceinline__ int d_side(int n, int k) { return n - k * DP < DP ? n - k * DP : DP; }
// pass-1 items of panel p: D(p) (blocks p, p + 1), then R(p, k) (blocks p + 2k, p + 2k + 1)
__host__ __device__ __forceinline__ int d_items1(int nb, int p) { return (nb - p + 1) / 2; }

// the block's stores, then thread 0's fence: the barrier orders every
// thread's stores before it (as cooperative groups' grid barrier does), so
// thread 0's next store or atomic publishes them
__device__ __forceinline__ void d_release_sync() {
    __syncthreads();
    if (threadIdx.x == 0) __threadfence();
}
// a float and its flag in one naturally aligned 64-bit word: the reader
// that sees the flag sees the value, no fence on either side
__device__ __forceinline__ void d_put(unsigned long long* p, float x) {
    const unsigned long long w = (1ull << 32) | __float_as_uint(x);
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ unsigned long long d_word(const unsigned long long* p) {
    unsigned long long w;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
    return w;
}
// the value of a word once its flag is up (set by a block of a lower
// ticket); a wait of seconds is a broken schedule, and traps rather than hangs
__device__ __forceinline__ float d_take(const unsigned long long* p) {
    unsigned spins = 0;
    for (;;) {
        const unsigned long long w = d_word(p);
        if (w >> 32) return __uint_as_float((unsigned)w);
        if (++spins == (1u << 24)) __trap();
    }
}
// ea += wa[q s] and eb += wb[q s] for q = top, top - 1, .., p + 1 (at most
// DCHK - 1 of each), in that order, every load in flight at once
__device__ __forceinline__ void d_take_run(const unsigned long long* wa, const unsigned long long* wb, size_t s,
                                           int top, int p, float& ea, float& eb) {
    unsigned long long xa[DCHK - 1], xb[DCHK - 1];
#pragma unroll
    for (int k = 0; k < DCHK - 1; ++k)
        if (top - k > p) {
            xa[k] = d_word(wa + (size_t)(top - k) * s);
            xb[k] = d_word(wb + (size_t)(top - k) * s);
        }
#pragma unroll
    for (int k = 0; k < DCHK - 1; ++k)
        if (top - k > p) {
            ea += xa[k] >> 32 ? __uint_as_float((unsigned)xa[k]) : d_take(wa + (size_t)(top - k) * s);
            eb += xb[k] >> 32 ? __uint_as_float((unsigned)xb[k]) : d_take(wb + (size_t)(top - k) * s);
        }
}
__device__ __forceinline__ int d_ticket(int* counter, int* slot) {
    __syncthreads();
    if (threadIdx.x == 0) *slot = atomicAdd(counter, 1);
    __syncthreads();
    return *slot;
}

__device__ __forceinline__ void d_cp16(float* dst, const float* src, bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void d_cp4(float* dst, const float* src, bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void d_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void d_wait_copies() { asm volatile("cp.async.wait_group 0;\n" ::); }

// s[r][c] = src[r ld + c] for r < rows, c < cols, and 0 for c >= cols,
// in flight by cp.async (the caller commits and waits); rows >= rows are
// left as they are: every reader stops at `rows`
template <bool V4>
__device__ __forceinline__ void d_load_block(float* s, const float* src, int ld, int rows, int cols) {
    if (V4) {
        for (int e = threadIdx.x; e < rows * (DP / 4); e += DTHREADS) {
            const int r = e / (DP / 4), c = (e % (DP / 4)) * 4;
            const bool ok = r < rows && c < cols;
            d_cp16(s + r * DP + c, ok ? src + (size_t)r * ld + c : src, ok);
        }
    } else {
        // 4-byte copies, a granule of four at a time; granules wholly
        // outside take one 16-byte store of zeros
        for (int e = threadIdx.x; e < rows * (DP / 4); e += DTHREADS) {
            const int r = e / (DP / 4), c = (e % (DP / 4)) * 4;
            if (r < rows && c < cols) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const bool ok = c + k < cols;
                    d_cp4(s + r * DP + c + k, ok ? src + (size_t)r * ld + c + k : src, ok);
                }
            } else {
                *reinterpret_cast<float4*>(s + r * DP + c) = make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
    }
}

// dst[r ld + c] = s[r][c] (or 0 with s null) for r < rows, c < cols
template <bool V4>
__device__ __forceinline__ void d_store_block(float* dst, const float* s, int ld, int rows, int cols) {
    if (V4) {
        for (int e = threadIdx.x; e < DBLK / 4; e += DTHREADS) {
            const int r = e / (DP / 4), c = (e % (DP / 4)) * 4;
            if (r < rows && c < cols)
                *reinterpret_cast<float4*>(dst + (size_t)r * ld + c) =
                    s ? *reinterpret_cast<const float4*>(s + r * DP + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    } else {
        for (int e = threadIdx.x; e < DBLK; e += DTHREADS) {
            const int r = e / DP, c = e % DP;
            if (r < rows && c < cols) dst[(size_t)r * ld + c] = s ? s[r * DP + c] : 0.f;
        }
    }
}

// out[j] = sum_{i < rows} s[i][j] w[i]: a warp takes 16 rows, a lane four
// columns (16-byte reads), and the warps' sums are added in warp order;
// red holds 8 DP floats. The result is valid in threads < DP; every thread
// must call.
__device__ __forceinline__ float d_coldot(const float* s, const float* w, float* red, int rows) {
    const int c = (threadIdx.x & 31) * 4, g = threadIdx.x >> 5, lo = g * 16, hi = min(rows, lo + 16);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(s + i * DP + c);
        const float wi = w[i];
        acc.x = fmaf(x.x, wi, acc.x);
        acc.y = fmaf(x.y, wi, acc.y);
        acc.z = fmaf(x.z, wi, acc.z);
        acc.w = fmaf(x.w, wi, acc.w);
    }
    *reinterpret_cast<float4*>(red + g * DP + c) = acc;
    __syncthreads();
    float out = 0.f;
    if (threadIdx.x < DP)
#pragma unroll
        for (int k = 0; k < DTHREADS / 32; ++k) out += red[k * DP + threadIdx.x];
    __syncthreads();
    return out;
}

// ------------------------------------------------------------------ prep

// the diagonal blocks (side min(DP, n - p DP), at that stride, the lower
// part zero), the ints and the normalizer zeroed; grid-strided
__device__ __forceinline__ void dense_prep(const DenseArgs& A) {
    const size_t total = (size_t)A.nb * DBLK;
    for (size_t e = blockIdx.x * (size_t)DTHREADS + threadIdx.x; e < total; e += (size_t)gridDim.x * DTHREADS) {
        const int p = (int)(e / DBLK), r = (int)(e % DBLK) / DP, c = (int)(e % DP);
        const int m = d_side(A.n, p);
        if (r < m && c < m)
            A.diag[(size_t)p * DBLK + r * m + c] =
                r <= c ? A.q[((size_t)p * DP + r) * A.n + (size_t)p * DP + c] : 0.f;
    }
    // mx, the ints and pass 1's words: one range of whole float4s
    float4* z = reinterpret_cast<float4*>(A.mx);
    const size_t nz = (reinterpret_cast<float*>(A.cw + (size_t)A.nb * A.n) - reinterpret_cast<float*>(A.mx)) / 4;
    for (size_t e = blockIdx.x * (size_t)DTHREADS + threadIdx.x; e < nz; e += (size_t)gridDim.x * DTHREADS)
        z[e] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// K3's plan of one factor of side m (tri.cu plan_tri_inv, count 1)
__device__ __forceinline__ void d_tri_plan(TriBatch* b, int m) {
    b->count = 1;
    b->n[0] = m;
    b->tiles[0] = 0;
    b->tiles[1] = (m + TRI_LEAF - 1) / TRI_LEAF;
    b->levels = 0;
    for (int l = 0; l < PSGD_TRI_LEVELS; ++l) {
        b->level_tiles[l][0] = 0;
        b->level_tiles[l][1] = tri_level_tiles(m, l);
        if (b->level_tiles[l][1]) b->levels = l + 1;
    }
}

__device__ __forceinline__ int d_tri_tasks(const TriBatch& b, int ph) {
    return ph < tri_phases(b) ? tri_phase_tasks(b, ph) : 0;
}

// K3 phase ph over every diagonal block: the full blocks share one plan,
// the ragged last one has its own; a task's factor pointers are set in the
// plan in shared memory before the task runs
__device__ __forceinline__ void dense_tri(const DenseArgs& A, int ph, float* sm) {
    TriBatch* plan = reinterpret_cast<TriBatch*>(sm + TRI_SMEM_FLOATS);
    TriBatch* last = reinterpret_cast<TriBatch*>(sm + TRI_SMEM_FLOATS + DT_PLAN_FLOATS);
    if (threadIdx.x == 0) {
        d_tri_plan(plan, DP);
        d_tri_plan(last, A.mlast);
    }
    __syncthreads();
    const int tf = A.nb > 1 ? d_tri_tasks(*plan, ph) : 0, tl = d_tri_tasks(*last, ph);
    const int total = (A.nb - 1) * tf + tl;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const bool full = t < (A.nb - 1) * tf;
        const int p = full ? t / tf : A.nb - 1, lt = full ? t % tf : t - (A.nb - 1) * tf;
        TriBatch* b = full ? plan : last;
        if (threadIdx.x == 0) {
            b->u[0] = A.diag + (size_t)p * DBLK;
            b->x[0] = A.dinv + (size_t)p * DBLK;
        }
        __syncthreads();
        tri_task(*b, ph, lt, sm);
        __syncthreads();
    }
}

// phases of the chain's K3 (the full blocks' plan, or the one ragged block's)
static int dense_tri_phases(int n) {
    TriBatch b;
    b.count = 1;
    b.n[0] = n > DP ? DP : n;
    plan_tri_inv(b);
    return tri_phases(b);
}

// ---------------------------------------------------------------- pass 1

// ticket t -> (panel p, item k): D(0), then for each p: D(p + 1), R(p, 1..)
__device__ __forceinline__ void d_item1(int nb, int t, int* p, int* k) {
    *p = 0;
    *k = 0;
    if (t == 0) return;
    --t;
    for (int q = 0; q < nb; ++q) {
        if (q + 1 < nb) {
            if (t == 0) {
                *p = q + 1;
                return;
            }
            --t;
        }
        const int r = d_items1(nb, q) - 1;
        if (t < r) {
            *p = q;
            *k = t + 1;
            return;
        }
        t -= r;
    }
}

// the rows' partials of Q h and Q g over the item's blocks (s0 at columns
// c0 DP.., s1 the next block or null); diag: s0 is the diagonal block,
// masked to its upper part. A warp a row, a float4 a lane.
__device__ __forceinline__ void d_rowdots(const DenseArgs& A, const float* s0, const float* s1, bool diag,
                                          const float* sh, const float* sg, int p, int k, int rows) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = warp; r < rows; r += DTHREADS / 32) {
        float ha = 0.f, hg = 0.f;
        for (int b = 0; b < 2; ++b) {
            const float* s = b ? s1 : s0;
            if (!s) break;
            const float4 x = *reinterpret_cast<const float4*>(s + r * DP + 4 * lane);
            const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = 4 * lane + e;
                const float xv = (diag && b == 0 && c < r) ? 0.f : xs[e];
                ha = fmaf(xv, sh[b * DP + c], ha);
                if (A.g) hg = fmaf(xv, sg[b * DP + c], hg);
            }
        }
        for (int o = 16; o > 0; o >>= 1) {
            ha += __shfl_xor_sync(0xffffffffu, ha, o);
            hg += __shfl_xor_sync(0xffffffffu, hg, o);
        }
        if (lane == 0) {
            const size_t at = ((size_t)p * A.regs + k) * DP + r;
            A.apart[at] = ha;
            if (A.g) A.gpart[at] = hg;
        }
    }
}

template <bool V4>
__device__ __forceinline__ void dense_item1(const DenseArgs& A, int p, int k, float* sm) {
    const int n = A.n, nb = A.nb, t = threadIdx.x, mp = d_side(n, p);
    float* sA = sm;               // the item's first block
    float* sB = sm + DBLK;        // its second
    float* sC = sm + 2 * DBLK;    // D(p): Dinv_p
    float* sh = sm + 3 * DBLK;    // h at the two blocks' columns (2 DP)
    float* sg = sh + 2 * DP;      // g there (2 DP)
    float* sr = sg + 2 * DP;      // r_p (DP)
    float* sb = sr + DP;          // b_p (DP)
    float* red = sb + DP;         // 8 DP
    int* sflag = reinterpret_cast<int*>(red + 8 * DP);
    const int c0 = p + 2 * k, c1 = c0 + 1;
    const bool two = c1 < nb;
    const size_t row0 = (size_t)p * DP * n;
    d_load_block<V4>(sA, A.q + row0 + (size_t)c0 * DP, n, mp, d_side(n, c0));
    if (two) d_load_block<V4>(sB, A.q + row0 + (size_t)c1 * DP, n, mp, d_side(n, c1));
    if (k == 0) d_load_block<V4>(sC, A.dinv + (size_t)p * DBLK, mp, mp, mp);
    d_commit();
    if (k == 0 && p + 1 < nb) {
        // D(p + 1)'s blocks into L2 while this item waits: its loads then
        // come from L2 when the chain reaches it
        const int m1 = d_side(n, p + 1), w = min(2 * DP, n - (p + 1) * DP);
        const float* q1 = A.q + (size_t)(p + 1) * DP * n + (size_t)(p + 1) * DP;
        for (int e = t; e < m1 * (2 * DP / 32); e += DTHREADS) {
            const int r = e / (2 * DP / 32), c = (e % (2 * DP / 32)) * 32;
            if (c < w) asm volatile("prefetch.global.L2 [%0];" ::"l"(q1 + (size_t)r * n + c));
        }
        const float* d1 = A.dinv + (size_t)(p + 1) * DBLK;
        for (int e = t; e < DBLK / 32; e += DTHREADS) asm volatile("prefetch.global.L2 [%0];" ::"l"(d1 + e * 32));
    }
    for (int e = t; e < 2 * DP; e += DTHREADS) {
        const int j = (e < DP ? c0 : c1) * DP + (e % DP);
        const bool ok = j < n && (e < DP || two);
        sh[e] = ok ? __ldg(A.h + j) : 0.f;
        sg[e] = ok && A.g ? __ldg(A.g + j) : 0.f;
    }
    d_wait_copies();
    __syncthreads();
    if (k) d_rowdots(A, sA, two ? sB : nullptr, false, sh, sg, p, k, mp);
    if (k == 0) {
        // r_p = v_p - sum_{p' < p} (Q_{p'p}^T b_p')[panel p's columns]: the
        // R items' running sum over panels p' <= p - 2 (one word a column),
        // then D(p - 1)'s look-ahead word
        const int j = t & (DP - 1), col = p * DP + j;
        if (t < DP) {
            float acc = p >= 2 && col < n ? d_take(A.cw + (size_t)(p - 2) * n + col) : 0.f;
            if (p >= 1) acc += d_take(A.la + (size_t)(p - 1) * DP + j);
            sr[t] = t < mp ? __ldg(A.v + col) - acc : 0.f;
        }
        __syncthreads();
        // b_p[t] = sum_i Dinv_p[i][t] r_i (Dinv_p's lower part is K3's exact zeros)
        {
            const float bj = d_coldot(sC, sr, red, mp);
            if (t < DP) sb[t] = t < mp ? bj : 0.f;
            __syncthreads();
        }
        // the look-ahead first: b_p's contribution to panel p + 1's columns;
        // then b_p for the R items
        if (two) {
            const float cv = d_coldot(sB, sb, red, mp);
            if (t < DP) d_put(A.la + (size_t)p * DP + j, c1 * DP + j < n ? cv : 0.f);
        }
        if (t < DP) {
            d_put(A.bw + (size_t)p * DP + t, sb[t]);
            if (t < mp) A.bvec[col] = sb[t];
        }
        d_rowdots(A, sA, two ? sB : nullptr, true, sh, sg, p, k, mp);
    } else {
        if (t < DP) sb[t] = d_take(A.bw + (size_t)p * DP + t);
        __syncthreads();
        // each column's running sum over the panels: panel p - 1's word
        // (an R item of a lower ticket) plus this panel's contribution
        for (int b = 0; b < 2; ++b) {
            if (b && !two) break;
            const int c = b ? c1 : c0;
            const float cv = d_coldot(b ? sB : sA, sb, red, mp);
            const int cc = c * DP + t;
            if (t < DP && cc < n)
                d_put(A.cw + (size_t)p * n + cc, (p ? d_take(A.cw + (size_t)(p - 1) * n + cc) : 0.f) + cv);
        }
    }
    // pass 2's carry words of the item's blocks zeroed (they are read after
    // the kernel boundary or grid barrier)
    if (p > 0)
        for (int e = t; e < 2 * DP; e += DTHREADS) {
            const int cc = (e < DP ? c0 : c1) * DP + e % DP;
            if (cc < n && (e < DP || two)) {
                A.cpa[(size_t)p * n + cc] = 0ull;
                A.cpb[(size_t)p * n + cc] = 0ull;
                A.lwa[(size_t)p * n + cc] = 0ull;
                A.lwb[(size_t)p * n + cc] = 0ull;
            }
        }
    // the last item of panel p sums its rows' partials in item order; with
    // g also the panel's reverse cumulative sums of a * Qg and b * Qg (a
    // warp's suffix scan, then the later warps' totals in warp order)
    d_release_sync();
    if (t == 0) {
        *sflag = atomicAdd(d_rows_done(A) + p, 1) == d_items1(nb, p) - 1;
        __threadfence();
    }
    __syncthreads();
    if (!*sflag) return;
    float sa = 0.f, sq = 0.f;
    if (t < mp) {
        const int items = d_items1(nb, p);
        for (int q = 0; q < items; ++q) {
            const size_t at = ((size_t)p * A.regs + q) * DP + t;
            sa += __ldcg(A.apart + at);
            if (A.g) sq += __ldcg(A.gpart + at);
        }
        A.avec[p * DP + t] = sa;
        if (A.g) A.qg[p * DP + t] = sq;
    }
    if (!A.g) return;
    const int lane = t & 31, warp = t >> 5;
    float xa = 0.f, xb = 0.f;
    if (t < DP) {
        xa = sa * sq;
        xb = (t < mp ? __ldcg(A.bvec + p * DP + t) : 0.f) * sq;
        for (int o = 1; o < 32; o <<= 1) {
            const float ya = __shfl_down_sync(0xffffffffu, xa, o), yb = __shfl_down_sync(0xffffffffu, xb, o);
            if (lane + o < 32) {
                xa += ya;
                xb += yb;
            }
        }
        if (lane == 0) {
            red[warp] = xa;
            red[DP + warp] = xb;
        }
    }
    __syncthreads();
    if (t < DP) {
        float la = 0.f, lb = 0.f;
        for (int w = warp + 1; w < DP / 32; ++w) {
            la += red[w];
            lb += red[DP + w];
        }
        xa += la;
        xb += lb;
        if (t < mp) {
            A.ra[p * DP + t] = xa;
            A.rb[p * DP + t] = xb;
        }
        if (t == 0) {
            A.tot[p] = xa;
            A.tot[A.nb + p] = xb;
        }
    }
}

template <bool V4>
__device__ __forceinline__ void dense_pass1(const DenseArgs& A, float* sm) {
    int* slot = reinterpret_cast<int*>(sm + D1_FLOATS - 4);
    int total = 0;
    for (int p = 0; p < A.nb; ++p) total += d_items1(A.nb, p);
    for (;;) {
        const int t = d_ticket(A.ints, slot);
        if (t >= total) break;
        int p, k;
        d_item1(A.nb, t, &p, &k);
        dense_item1<V4>(A, p, k, sm);
    }
}

// ------------------------------------------------------------------ norm

// upper-triangle enumeration shared by the normalizer and pass 2: t in
// [0, nb (nb + 1) / 2) -> block (p, c), p <= c, panels from the bottom
__device__ __forceinline__ void d_upper(int nb, int t, int* p, int* c) {
    int s = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f) + 1;  // s (s - 1) / 2 <= t < s (s + 1) / 2
    while (s * (s + 1) / 2 <= t) ++s;
    while (s > 1 && (s - 1) * s / 2 > t) --s;
    *p = nb - s;
    *c = *p + (t - (s - 1) * s / 2);
}

// max|triu(a a^T - b b^T)| over 128 x 128 tiles, each thread 8 x 8 pairs
// (rows and columns past n are zeros and give 0); with g, block 0 also
// sums the panels' totals of pass 1 into suffixes over the panels below
__device__ __forceinline__ void dense_norm(const DenseArgs& A, float* sm) {
    const int n = A.n, t = threadIdx.x, nb = A.nb;
    float* ra = sm;
    float* rb = ra + DP;
    float* ca = rb + DP;
    float* cb = ca + DP;
    float* red = cb + DP;  // DTHREADS
    if (A.g && blockIdx.x == 0 && t < 2) {
        float run = 0.f;
        for (int q = nb - 1; q >= 0; --q) {
            A.suf[t * nb + q] = run;
            run += __ldcg(A.tot + t * nb + q);
        }
    }
    float m = 0.f;
    const int tiles = nb * (nb + 1) / 2, i0 = (t >> 4) * 8, j0 = (t & 15) * 8;
    for (int tt = blockIdx.x; tt < tiles; tt += gridDim.x) {
        int bi, bj;
        d_upper(nb, tt, &bi, &bj);
        if (t < DP) {
            const int i = bi * DP + t;
            ra[t] = i < n ? __ldcg(A.avec + i) : 0.f;
            rb[t] = i < n ? __ldcg(A.bvec + i) : 0.f;
        } else {
            const int jj = bj * DP + t - DP;
            ca[t - DP] = jj < n ? __ldcg(A.avec + jj) : 0.f;
            cb[t - DP] = jj < n ? __ldcg(A.bvec + jj) : 0.f;
        }
        __syncthreads();
        float xa[8], xb[8], ya[8], yb[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            xa[k] = ra[i0 + k];
            xb[k] = rb[i0 + k];
            ya[k] = ca[j0 + k];
            yb[k] = cb[j0 + k];
        }
        if (bi < bj) {
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int c = 0; c < 8; ++c) m = fmaxf(m, fabsf(xa[r] * ya[c] - xb[r] * yb[c]));
        } else {
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int c = 0; c < 8; ++c)
                    if (i0 + r <= j0 + c) m = fmaxf(m, fabsf(xa[r] * ya[c] - xb[r] * yb[c]));
        }
        __syncthreads();
    }
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((t & 31) == 0) red[t >> 5] = m;
    __syncthreads();
    if (t == 0) {
        for (int w = 1; w < DTHREADS / 32; ++w) m = fmaxf(m, red[w]);
        atomicMax(A.mx, __float_as_uint(m));
    }
    __syncthreads();
}

// ---------------------------------------------------------------- pass 2

template <bool V4>
__device__ __forceinline__ void dense_item2(const DenseArgs& A, int p, int c, float* sm) {
    const int n = A.n, nb = A.nb, t = threadIdx.x, j = t & (DP - 1), hf = t >> 7;
    const int mp = d_side(n, p), mc = d_side(n, c);
    float* sq = sm;             // the block, then Q'
    float* sa = sm + DBLK;      // a, b, u at the panel's rows
    float* sb = sa + DP;
    float* su = sb + DP;
    float* hs = su + DP;        // [a, b][half][DP] column sums of the halves
    float* ex = hs + 4 * DP;    // [a, b][DP] the carry from below
    float* pg = ex + 2 * DP;    // [half][DP] P' g partials
    int* sflag = reinterpret_cast<int*>(pg + 2 * DP);
    float* out = A.qout + (size_t)p * DP * n + (size_t)c * DP;
    d_load_block<V4>(sq, A.q + (size_t)p * DP * n + (size_t)c * DP, n, mp, mc);
    d_commit();
    const float s0 = fminf(A.step / (__uint_as_float(__ldcg(A.mx)) + psgd_tiny()), FLT_MAX);
    if (t < DP) {
        const int i = p * DP + t;
        const bool ok = t < mp;
        const float ai = ok ? __ldcg(A.avec + i) : 0.f, bi = ok ? __ldcg(A.bvec + i) : 0.f;
        sa[t] = ai;
        sb[t] = bi;
        if (ok && A.g) {
            // u = Q' g: RA = the panel's own reverse sums plus the panels' below
            const float rai = __ldcg(A.ra + i) + __ldcg(A.suf + p), rbi = __ldcg(A.rb + i) + __ldcg(A.suf + nb + p);
            su[t] = __ldcg(A.qg + i) - s0 * (ai * rai - bi * rbi);
        } else {
            su[t] = 0.f;
        }
    }
    d_wait_copies();
    __syncthreads();
    const int gj = c * DP + j, lo = hf * DHALF, hi = min(lo + DHALF, mp);  // rows past mp are not loaded
    // the halves' column sums of a * Q and b * Q (the diagonal block's lower part as 0)
    {
        float ta = 0.f, tb = 0.f;
#pragma unroll 8
        for (int i = lo; i < hi; ++i) {
            const float x = p * DP + i <= gj ? sq[i * DP + j] : 0.f;
            ta = fmaf(sa[i], x, ta);
            tb = fmaf(sb[i], x, tb);
        }
        hs[hf * DP + j] = ta;
        hs[(2 + hf) * DP + j] = tb;
    }
    __syncthreads();
    // the carry from the panels below, a column at a time: this block's
    // column sums published first; then the inclusive carry of the next
    // checkpoint panel (a multiple of DCHK) inside the column, and the
    // column sums of the panels between, bottom up. These are the sums, in
    // the order, of a chain through every panel, with a chain step every
    // DCHK panels; a checkpoint block publishes its inclusive carry.
    if (t < DP) {
        const float la = hs[j] + hs[DP + j], lb = hs[2 * DP + j] + hs[3 * DP + j];
        float ea = 0.f, eb = 0.f;
        if (gj < n) {
            if (p > 0) {
                d_put(A.lwa + (size_t)p * n + gj, la);
                d_put(A.lwb + (size_t)p * n + gj, lb);
            }
            if (c > p) {
                const int m = (p / DCHK + 1) * DCHK;
                int top = c;
                if (m <= c) {
                    ea = d_take(A.cpa + (size_t)m * n + gj);
                    eb = d_take(A.cpb + (size_t)m * n + gj);
                    top = m - 1;
                }
                d_take_run(A.lwa + gj, A.lwb + gj, n, top, p, ea, eb);
            }
            if (p > 0 && p % DCHK == 0) {
                d_put(A.cpa + (size_t)p * n + gj, ea + la);
                d_put(A.cpb + (size_t)p * n + gj, eb + lb);
            }
        }
        ex[j] = ea;
        ex[DP + j] = eb;
    }
    __syncthreads();
    // the rewrite: reverse running sums from the carry (the lower half's
    // sums first for the upper half), Q' into shared memory, P' g's partial
    {
        float run_a = ex[j], run_b = ex[DP + j];
        if (hf == 0) {
            run_a += hs[DP + j];
            run_b += hs[3 * DP + j];
        }
        float acc = 0.f;
        for (int i = hi - 1; i >= lo; --i) {
            const int gi = p * DP + i;
            const float x = gi <= gj ? sq[i * DP + j] : 0.f;
            run_a = fmaf(sa[i], x, run_a);
            run_b = fmaf(sb[i], x, run_b);
            const float y = (gi <= gj && gj < n) ? x - s0 * (sa[i] * run_a - sb[i] * run_b) : 0.f;
            sq[i * DP + j] = y;
            acc = fmaf(y, su[i], acc);
        }
        pg[hf * DP + j] = acc;
    }
    __syncthreads();
    d_store_block<V4>(out, sq, n, mp, mc);
    // the block mirrored below the diagonal: zeros, its stores mixed with
    // the rewrite's
    if (c > p) d_store_block<V4>(A.qout + (size_t)c * DP * n + (size_t)p * DP, nullptr, n, mc, mp);
    if (!A.g) return;
    if (t < DP && gj < n) A.pgpart[(size_t)p * n + gj] = pg[j] + pg[DP + j];
    d_release_sync();
    if (t == 0) {
        *sflag = atomicAdd(d_col_done(A) + c, 1) == c;
        __threadfence();
    }
    __syncthreads();
    if (*sflag && t < mc) {
        float s = 0.f;
        for (int q = 0; q <= c; ++q) s += __ldcg(A.pgpart + (size_t)q * n + gj);
        A.pre[gj] = s;
    }
}

template <bool V4>
__device__ __forceinline__ void dense_pass2(const DenseArgs& A, float* sm) {
    int* slot = reinterpret_cast<int*>(sm + D2_FLOATS - 4);
    const int upper = A.nb * (A.nb + 1) / 2;
    for (;;) {
        const int t = d_ticket(A.ints + 1, slot);
        if (t >= upper) break;
        int p, c;
        d_upper(A.nb, t, &p, &c);
        dense_item2<V4>(A, p, c, sm);
    }
}

// --------------------------------------------------------------- kernels

namespace cg = cooperative_groups;

// K12's first launch (cooperative): prep, then K3's phases (two blocks an
// SM spill K3's leaf and ran slower at n <= 3841)
__global__ void __launch_bounds__(DTHREADS, 1) dense_prep_kernel(const DenseArgs A, int phases) {
    extern __shared__ __align__(16) float dsm[];
    dense_prep(A);
    for (int ph = 0; ph < phases; ++ph) {
        cg::this_grid().sync();
        dense_tri(A, ph, dsm);
    }
}

template <bool V4>
__global__ void __launch_bounds__(DTHREADS, 1) dense_pass1_kernel(const DenseArgs A) {
    extern __shared__ __align__(16) float dsm[];
    dense_pass1<V4>(A, dsm);
}

__global__ void __launch_bounds__(DTHREADS) dense_norm_kernel(const DenseArgs A) {
    extern __shared__ __align__(16) float dsm[];
    dense_norm(A, dsm);
}

template <bool V4>
__global__ void __launch_bounds__(DTHREADS, 3) dense_pass2_kernel(const DenseArgs A) {
    extern __shared__ __align__(16) float dsm[];
    dense_pass2<V4>(A, dsm);
}

// a grid of one block (n <= DP) is launched plainly: its barrier is the block's
__device__ __forceinline__ void d_grid_sync() {
    if (gridDim.x == 1) __syncthreads();
    else cg::this_grid().sync();
}

// K11: every phase in one launch, a grid barrier between two (a
// cooperative launch past one block)
template <bool V4>
__global__ void __launch_bounds__(DTHREADS, 1) dense_mono_kernel(const DenseArgs A, int phases) {
    extern __shared__ __align__(16) float dsm[];
    dense_prep(A);
    for (int ph = 0; ph < phases; ++ph) {
        d_grid_sync();
        dense_tri(A, ph, dsm);
    }
    d_grid_sync();
    dense_pass1<V4>(A, dsm);
    d_grid_sync();
    dense_norm(A, dsm);
    d_grid_sync();
    dense_pass2<V4>(A, dsm);
}

// ------------------------------------------------------------------ host

#define D1_SMEM (sizeof(float) * D1_FLOATS)
#define D2_SMEM (sizeof(float) * D2_FLOATS)
#define DT_SMEM (sizeof(float) * DT_FLOATS)
#define DN_SMEM (sizeof(float) * DN_FLOATS)
#define DMONO_SMEM (sizeof(float) * DMONO_FLOATS)
static_assert(DMONO_SMEM <= 232448, "the one-launch kernel fits a block's shared memory");

// the scratch in floats (a 64-bit word two), every piece 16-byte aligned
static size_t dense_carve(int n, float* base, DenseArgs* A) {
    const size_t nb = (n + DP - 1) / DP, nn = n, regs = (nb + 1) / 2;
    const size_t sizes[] = {nb * DBLK, nb * DBLK, nn, nb * regs * DP, nb * regs * DP, nn, nn, nn, nn, 2 * nb,
                            2 * nb,    nb * nn,   4,  dense_ints((int)nb), 2 * nb * DP, 2 * nb * DP, 2 * nb * nn,
                            2 * nb * nn, 2 * nb * nn, 2 * nb * nn, 2 * nb * nn};
    float** slots[] = {&A->diag, &A->dinv, &A->bvec, &A->apart, &A->gpart, &A->avec,
                       &A->qg,   &A->ra,   &A->rb,   &A->tot,   &A->suf,   &A->pgpart};
    unsigned long long** words[] = {&A->la, &A->bw, &A->cw, &A->cpa, &A->cpb, &A->lwa, &A->lwb};
    size_t off = 0;
    for (int k = 0; k < 21; ++k) {
        if (base) {
            float* at = base + off;
            if (k < 12) *slots[k] = at;
            else if (k == 12) A->mx = reinterpret_cast<unsigned int*>(at);
            else if (k == 13) A->ints = reinterpret_cast<int*>(at);
            else *words[k - 14] = reinterpret_cast<unsigned long long*>(at);
        }
        off += psgd_align4(sizes[k]);
    }
    return off;
}

extern "C" size_t psgd_dense_scratch_floats(int n) {
    DenseArgs A;
    return dense_carve(n, nullptr, &A);
}

// CTAs a SM of each cooperative kernel and the SMs, asked once a device
struct DenseResident {
    int prep, mono4, mono1, sms;
};

static cudaError_t dense_resident(DenseResident* out) {
    static int known_dev = -1;
    static DenseResident known;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev != known_dev) {
        int coop = 0;
        known = DenseResident{0, 0, 0, 0};
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&known.sms, cudaDevAttrMultiProcessorCount, dev);
        const void* fns[] = {(const void*)dense_pass1_kernel<true>, (const void*)dense_pass1_kernel<false>,
                             (const void*)dense_pass2_kernel<true>, (const void*)dense_pass2_kernel<false>,
                             (const void*)dense_prep_kernel,        (const void*)dense_mono_kernel<true>,
                             (const void*)dense_mono_kernel<false>};
        const size_t smem[] = {D1_SMEM, D1_SMEM, D2_SMEM, D2_SMEM, DT_SMEM, DMONO_SMEM, DMONO_SMEM};
        for (int k = 0; k < 7 && e == cudaSuccess; ++k)
            e = cudaFuncSetAttribute(fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem[k]);
        if (e == cudaSuccess && coop) {
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&known.prep, dense_prep_kernel, DTHREADS, DT_SMEM);
            if (e == cudaSuccess)
                e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&known.mono4, dense_mono_kernel<true>,
                                                                  DTHREADS, DMONO_SMEM);
            if (e == cudaSuccess)
                e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&known.mono1, dense_mono_kernel<false>,
                                                                  DTHREADS, DMONO_SMEM);
        }
        if (e != cudaSuccess) return e;
        known_dev = dev;
    }
    *out = known;
    return cudaSuccess;
}

// Q' (and with g, P' g) for Q (n, n) upper triangular; qout must not alias
// q. mono = 1: one cooperative launch (K11, n <= 1536); 0: four launches
// (K12).
extern "C" int psgd_dense_update(int n, const void* qp, const void* vp, const void* hp, const void* gp,
                                 float step, void* qoutp, void* prep, void* scratch, int mono,
                                 void* stream_ptr) {
    if (n < 1 || n > (1 << 20)) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    DenseArgs A;
    dense_carve(n, static_cast<float*>(scratch), &A);
    A.q = static_cast<const float*>(qp);
    A.v = static_cast<const float*>(vp);
    A.h = static_cast<const float*>(hp);
    A.g = static_cast<const float*>(gp);
    A.qout = static_cast<float*>(qoutp);
    A.pre = static_cast<float*>(prep);
    A.step = step;
    A.n = n;
    A.nb = (n + DP - 1) / DP;
    A.mlast = n - (A.nb - 1) * DP;
    A.regs = (A.nb + 1) / 2;
    const bool v4 = n % 4 == 0 && (reinterpret_cast<uintptr_t>(qp) | reinterpret_cast<uintptr_t>(qoutp)) % 16 == 0;
    DenseResident R;
    cudaError_t e = dense_resident(&R);
    if (e != cudaSuccess) return (int)e;
    int phases = dense_tri_phases(n);
    const int nb = A.nb, upper = nb * (nb + 1) / 2;
    int items1 = 0;
    for (int p = 0; p < nb; ++p) items1 += (nb - p + 1) / 2;
    // the largest K3 phase: every block's leaves or products
    TriBatch full;
    full.count = 1;
    full.n[0] = n > DP ? DP : n;
    plan_tri_inv(full);
    int tri_most = 1;
    for (int ph = 0; ph < tri_phases(full); ++ph) tri_most = std::max(tri_most, nb * tri_phase_tasks(full, ph));
    if (mono) {
        const int per_sm = v4 ? R.mono4 : R.mono1;
        if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
        const int most = std::max(std::max(tri_most, items1), upper);
        if (nb == 1) {
            if (v4) dense_mono_kernel<true><<<1, DTHREADS, DMONO_SMEM, stream>>>(A, phases);
            else dense_mono_kernel<false><<<1, DTHREADS, DMONO_SMEM, stream>>>(A, phases);
            return (int)cudaGetLastError();
        }
        void* args[] = {&A, &phases};
        e = cudaLaunchCooperativeKernel(v4 ? (const void*)dense_mono_kernel<true> : (const void*)dense_mono_kernel<false>,
                                        dim3(std::min(most, per_sm * R.sms)), dim3(DTHREADS), args, DMONO_SMEM,
                                        stream);
        return (int)(e != cudaSuccess ? e : cudaGetLastError());
    }
    if (R.prep < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&A, &phases};
    e = cudaLaunchCooperativeKernel((const void*)dense_prep_kernel,
                                    dim3(std::min(std::max(tri_most, 1), R.prep * R.sms)), dim3(DTHREADS), args,
                                    DT_SMEM, stream);
    if (e != cudaSuccess) return (int)e;
    if (v4) dense_pass1_kernel<true><<<items1, DTHREADS, D1_SMEM, stream>>>(A);
    else dense_pass1_kernel<false><<<items1, DTHREADS, D1_SMEM, stream>>>(A);
    dense_norm_kernel<<<upper, DTHREADS, DN_SMEM, stream>>>(A);  // a tile a block: their loads overlap
    if (v4) dense_pass2_kernel<true><<<upper, DTHREADS, D2_SMEM, stream>>>(A);
    else dense_pass2_kernel<false><<<upper, DTHREADS, D2_SMEM, stream>>>(A);
    return (int)cudaGetLastError();
}
