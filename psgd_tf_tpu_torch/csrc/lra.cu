// K13: the low-rank (UVd) family's update, with the optional fused apply.
//
// Replaces psgd_tf_tpu/ops/pallas/lra_upd.py `fused_update` (:458) and
// `fused_update_apply` (:543) → `_update_impl` (:217), its pallas_calls at
// :281 (`_stage1_kernel` :63), :389 (`_stage3_kernel` :124), :416
// (`_stage3_apply_kernel` :165) and :443 (`_stage4_kernel` :202). The
// factors are packed rank-major, UV (2r, n) = [U; V], with d (n,); lane j
// of every array is parameter j. The streaming stages:
//   stage 1   Z = [U; V; d h; v / d] (2r + 2 rows): the Gram Z Z^T, which
//             holds every rank-space reduction the update needs, and
//             max|U|, max|V| for the rebalance;
//   stage 3   per lane, from the rank-space coefficients (coef, (r, 10):
//             columns 0-3 the probe images' coefficients, 4-9 the U/V
//             update's) and the balance scales (cu, cv): U', V' and the
//             unscaled d-gradient nablaD; with g also the Gram of
//             Z2 = [U'; V'; d g; d g nablaD] for the apply;
//   stage 4   P' g = d' (d' g + t1 U' + t2 V'), (t1, t2) = coef4 (r, 2).
// The rank-space algebra between the stages, d' = d - mu_d d nablaD and the
// apply's coefficients stay in PyTorch on the device, as they are jnp in
// the JAX package (ops/hopper/lra_upd.py).
//
// The TPU grid walks lane blocks in order and accumulates the Gram in one
// VMEM block across grid steps. Here each block takes LRA_LANES lanes, in
// tiles of LRA_TILE: a tile's Z columns go to shared memory (one thread a
// lane), then each thread adds its pairs (a, b) of the upper triangle over
// the tile's lanes into registers. The block writes its partial Gram and
// maxima to a (blocks, ...) scratch, and a second small pass sums them in
// block order: no float atomics, so a run repeats itself bit for bit.
// Lanes past n take part as zero columns: nothing is padded in memory.
//
// What bounds it on this card: memory. The update + apply reads UV, d, v,
// h and g and writes UV', d' and P' g: (4rn + 6n) floats, 193 MB at
// n = 2^20, r = 10, 58 us at 3.35 TB/s; the Grams are ~2 (2r+2)^2 n FLOPs
// (1 GFLOP there, 15 us at the 67 TFLOP/s fp32 peak). This version reads
// the factors three times (stages 1, 3 and 4) and both Grams' pair sums
// read shared memory twice per FMA; tensor-core Grams and fewer passes are
// later work. Ranks up to LRA_MAX_RANK: each thread keeps its share of the
// Gram's pairs in registers.
#include "psgd.cuh"

#define LRA_TILE 256                       // lanes of a tile = threads of a block
#define LRA_LANES (16 * LRA_TILE)          // lanes of a Gram block
#define LRA_MAX_RANK 32
#define LRA_MAX_Z (2 * LRA_MAX_RANK + 2)
#define LRA_PAIRS_PER_THREAD ((LRA_MAX_Z * (LRA_MAX_Z + 1) / 2 + LRA_TILE - 1) / LRA_TILE)
#define LRA_NCOEF 10

static inline int lra_blocks(int n) { return (n + LRA_LANES - 1) / LRA_LANES; }
__host__ __device__ __forceinline__ int lra_pairs(int zdim) { return zdim * (zdim + 1) / 2; }

__device__ __forceinline__ float lra_block_max(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float m = 0.f;
    for (int k = 0; k < LRA_TILE / 32; ++k) m = fmaxf(m, red[k]);
    return m;
}

// This thread's pairs (a <= b) of the upper triangle: the k-th is the
// pair of row-major index threadIdx.x + k * LRA_TILE.
struct Pairs {
    int a[LRA_PAIRS_PER_THREAD], b[LRA_PAIRS_PER_THREAD], count;
};

__device__ __forceinline__ void lra_pair_of(int zdim, int idx, int& a, int& b) {
    a = 0;
    while (idx >= zdim - a) {
        idx -= zdim - a;
        ++a;
    }
    b = a + idx;
}

__device__ void lra_my_pairs(int zdim, Pairs& P) {
    const int npairs = lra_pairs(zdim);
    P.count = 0;
    for (int idx = threadIdx.x; idx < npairs && P.count < LRA_PAIRS_PER_THREAD; idx += LRA_TILE) {
        lra_pair_of(zdim, idx, P.a[P.count], P.b[P.count]);
        ++P.count;
    }
}

// acc[k] += sum over the tile's lanes of zs[a_k] * zs[b_k] (four partial
// sums, so the FMA chain is not one long dependency)
__device__ __forceinline__ void lra_add_pairs(const float* zs, const Pairs& P, float* acc) {
#pragma unroll
    for (int k = 0; k < LRA_PAIRS_PER_THREAD; ++k) {
        if (k >= P.count) break;
        const float* za = zs + P.a[k] * (LRA_TILE + 1);
        const float* zb = zs + P.b[k] * (LRA_TILE + 1);
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        for (int l = 0; l < LRA_TILE; l += 4) {
            s0 += za[l] * zb[l];
            s1 += za[l + 1] * zb[l + 1];
            s2 += za[l + 2] * zb[l + 2];
            s3 += za[l + 3] * zb[l + 3];
        }
        acc[k] += (s0 + s1) + (s2 + s3);
    }
}

// the block's partial Gram, in row-major pair order
__device__ __forceinline__ void lra_store_pairs(const Pairs& P, const float* acc, int npairs,
                                                float* part) {
    float* out = part + (size_t)blockIdx.x * npairs;
    for (int k = 0; k < P.count; ++k) out[(int)threadIdx.x + k * LRA_TILE] = acc[k];
}

// stage 1: grid = lra_blocks(n); dynamic shared memory (2r + 2) x (TILE + 1)
__global__ void __launch_bounds__(LRA_TILE) lra_stage1_kernel(
    int n, int ld, int r, const float* __restrict__ uv, const float* __restrict__ d,
    const float* __restrict__ h, const float* __restrict__ vv, float* __restrict__ part,
    float* __restrict__ maxpart) {
    extern __shared__ float zs[];
    __shared__ float red[LRA_TILE / 32];
    const int zdim = 2 * r + 2, npairs = lra_pairs(zdim), t = threadIdx.x;
    Pairs P;
    lra_my_pairs(zdim, P);
    float acc[LRA_PAIRS_PER_THREAD];
#pragma unroll
    for (int k = 0; k < LRA_PAIRS_PER_THREAD; ++k) acc[k] = 0.f;
    float mu = 0.f, mv = 0.f;
    const int lane0 = blockIdx.x * LRA_LANES;
    for (int base = lane0; base < min(lane0 + LRA_LANES, n); base += LRA_TILE) {
        const int j = base + t;
        const bool ok = j < n;
        for (int k = 0; k < 2 * r; ++k) {
            const float x = ok ? uv[(size_t)k * ld + j] : 0.f;
            zs[k * (LRA_TILE + 1) + t] = x;
            if (k < r) mu = fmaxf(mu, fabsf(x));
            else mv = fmaxf(mv, fabsf(x));
        }
        const float dj = ok ? d[j] : 1.f;
        zs[2 * r * (LRA_TILE + 1) + t] = ok ? dj * h[j] : 0.f;
        zs[(2 * r + 1) * (LRA_TILE + 1) + t] = ok ? vv[j] / dj : 0.f;
        __syncthreads();
        lra_add_pairs(zs, P, acc);
        __syncthreads();
    }
    lra_store_pairs(P, acc, npairs, part);
    mu = lra_block_max(mu, red);
    mv = lra_block_max(mv, red);
    if (t == 0) {
        maxpart[2 * blockIdx.x] = mu;
        maxpart[2 * blockIdx.x + 1] = mv;
    }
}

// Per lane: the probe images, nablaD and U', V' (stage 3). c = coef (r, 10).
__device__ __forceinline__ float lra_lane_update(int ld, int r, int j, const float* __restrict__ uv,
                                                 float dj, float hj, float vj, const float* c,
                                                 float cu, float cv, float* __restrict__ newuv,
                                                 float* zcol) {
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f, p4 = 0.f, p5 = 0.f;
    for (int k = 0; k < r; ++k) {
        const float u = uv[(size_t)k * ld + j], v = uv[(size_t)(r + k) * ld + j];
        const float* ck = c + k * LRA_NCOEF;
        p0 += ck[0] * u;
        p1 += ck[1] * v;
        p2 += ck[2] * v;
        p3 += ck[3] * u;
        p4 += ck[8] * v;
        p5 += ck[9] * v;
    }
    const float x = dj * hj, w = vj / dj;
    const float qh = x + p0;
    const float b = w - p1;
    const float ph = dj * (qh + p2);
    const float ipv = (b - p3) / dj;
    const float nd = ph * hj - vj * ipv;
    const float av = qh + p4, bv = b + p5;
    for (int k = 0; k < r; ++k) {
        const float* ck = c + k * LRA_NCOEF;
        const float u = uv[(size_t)k * ld + j], v = uv[(size_t)(r + k) * ld + j];
        const float nu = cu * u - (ck[4] * qh - ck[5] * b);
        const float nv = cv * v - (ck[6] * av - ck[7] * bv);
        newuv[(size_t)k * ld + j] = nu;
        newuv[(size_t)(r + k) * ld + j] = nv;
        if (zcol) {
            zcol[k * (LRA_TILE + 1)] = nu;
            zcol[(r + k) * (LRA_TILE + 1)] = nv;
        }
    }
    return nd;
}

// stage 3 without the apply: one thread a lane
__global__ void __launch_bounds__(LRA_TILE) lra_stage3_kernel(
    int n, int ld, int r, const float* __restrict__ uv, const float* __restrict__ d,
    const float* __restrict__ h, const float* __restrict__ vv, const float* __restrict__ coef,
    const float* __restrict__ scal, float* __restrict__ newuv, float* __restrict__ nd) {
    __shared__ float c[LRA_MAX_RANK * LRA_NCOEF];
    for (int e = threadIdx.x; e < r * LRA_NCOEF; e += LRA_TILE) c[e] = coef[e];
    __syncthreads();
    const int j = blockIdx.x * LRA_TILE + threadIdx.x;
    if (j >= n) return;
    nd[j] = lra_lane_update(ld, r, j, uv, d[j], h[j], vv[j], c, scal[0], scal[1], newuv, nullptr);
}

// stage 3 with the apply Gram of Z2 = [U'; V'; d g; d g nablaD]
__global__ void __launch_bounds__(LRA_TILE) lra_stage3_apply_kernel(
    int n, int ld, int r, const float* __restrict__ uv, const float* __restrict__ d,
    const float* __restrict__ h, const float* __restrict__ vv, const float* __restrict__ g,
    const float* __restrict__ coef, const float* __restrict__ scal, float* __restrict__ newuv,
    float* __restrict__ nd, float* __restrict__ part) {
    extern __shared__ float zs[];
    __shared__ float c[LRA_MAX_RANK * LRA_NCOEF];
    const int zdim = 2 * r + 2, npairs = lra_pairs(zdim), t = threadIdx.x;
    for (int e = t; e < r * LRA_NCOEF; e += LRA_TILE) c[e] = coef[e];
    Pairs P;
    lra_my_pairs(zdim, P);
    float acc[LRA_PAIRS_PER_THREAD];
#pragma unroll
    for (int k = 0; k < LRA_PAIRS_PER_THREAD; ++k) acc[k] = 0.f;
    const float cu = scal[0], cv = scal[1];
    __syncthreads();
    const int lane0 = blockIdx.x * LRA_LANES;
    for (int base = lane0; base < min(lane0 + LRA_LANES, n); base += LRA_TILE) {
        const int j = base + t;
        float y0 = 0.f, y1 = 0.f;
        if (j < n) {
            const float dj = d[j];
            const float ndj = lra_lane_update(ld, r, j, uv, dj, h[j], vv[j], c, cu, cv, newuv, zs + t);
            nd[j] = ndj;
            y0 = dj * g[j];
            y1 = y0 * ndj;
        } else {
            for (int k = 0; k < 2 * r; ++k) zs[k * (LRA_TILE + 1) + t] = 0.f;
        }
        zs[2 * r * (LRA_TILE + 1) + t] = y0;
        zs[(2 * r + 1) * (LRA_TILE + 1) + t] = y1;
        __syncthreads();
        lra_add_pairs(zs, P, acc);
        __syncthreads();
    }
    lra_store_pairs(P, acc, npairs, part);
}

// Sum the blocks' partial Grams in block order into the full symmetric
// (zdim, zdim) Gram, and (when maxpart) max the blocks' maxima.
__global__ void __launch_bounds__(256) lra_reduce_kernel(int zdim, int blocks, const float* __restrict__ part,
                                                         const float* __restrict__ maxpart,
                                                         float* __restrict__ gram,
                                                         float* __restrict__ maxs) {
    const int npairs = lra_pairs(zdim);
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e < npairs) {
        float s = 0.f;
        for (int k = 0; k < blocks; ++k) s += part[(size_t)k * npairs + e];
        int a, b;
        lra_pair_of(zdim, e, a, b);
        gram[a * zdim + b] = s;
        gram[b * zdim + a] = s;
    } else if (maxpart && e < npairs + 2) {
        const int w = e - npairs;
        float m = 0.f;
        for (int k = 0; k < blocks; ++k) m = fmaxf(m, maxpart[2 * k + w]);
        maxs[w] = m;
    }
}

// stage 4: out = d' (d' g + t1 U' + t2 V'), coef4 (r, 2) = (t1, t2)
__global__ void __launch_bounds__(LRA_TILE) lra_stage4_kernel(int n, int ld, int r, const float* __restrict__ uv,
                                                              const float* __restrict__ d,
                                                              const float* __restrict__ g,
                                                              const float* __restrict__ coef4,
                                                              float* __restrict__ out) {
    __shared__ float c[2 * LRA_MAX_RANK];
    for (int e = threadIdx.x; e < 2 * r; e += LRA_TILE) c[e] = coef4[e];
    __syncthreads();
    const int j = blockIdx.x * LRA_TILE + threadIdx.x;
    if (j >= n) return;
    float s = 0.f;
    for (int k = 0; k < r; ++k)
        s += c[2 * k] * uv[(size_t)k * ld + j] + c[2 * k + 1] * uv[(size_t)(r + k) * ld + j];
    const float dj = d[j];
    out[j] = dj * (dj * g[j] + s);
}

static size_t lra_smem(int r) { return sizeof(float) * (size_t)(2 * r + 2) * (LRA_TILE + 1); }

static cudaError_t lra_smem_attrs() {
    static bool done = false;
    if (done) return cudaSuccess;
    const int bytes = (int)lra_smem(LRA_MAX_RANK);
    cudaError_t e = cudaFuncSetAttribute(lra_stage1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(lra_stage3_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    done = e == cudaSuccess;
    return e;
}

extern "C" size_t psgd_lra_scratch_floats(int n, int r) {
    const size_t blocks = lra_blocks(n);
    return psgd_align4(blocks * lra_pairs(2 * r + 2)) + psgd_align4(2 * blocks);
}

// stage 1: gram (2r+2, 2r+2) = Z Z^T, maxs (2,) = (max|U|, max|V|) over
// lanes [0, n) of rows ld apart: uv, d, h and v point at the first lane
extern "C" int psgd_lra_stage1(int n, int ld, int r, const void* uv, const void* d, const void* h,
                               const void* v, void* gram, void* maxs, void* scratch,
                               void* stream_ptr) {
    if (n < 1 || ld < n || r < 1 || r > LRA_MAX_RANK) return (int)cudaErrorInvalidValue;
    cudaError_t e = lra_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int blocks = lra_blocks(n), zdim = 2 * r + 2, npairs = lra_pairs(zdim);
    float* part = static_cast<float*>(scratch);
    float* maxpart = part + psgd_align4((size_t)blocks * npairs);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    lra_stage1_kernel<<<blocks, LRA_TILE, lra_smem(r), stream>>>(n, ld, r, f(uv), f(d), f(h), f(v), part,
                                                                  maxpart);
    lra_reduce_kernel<<<(npairs + 2 + 255) / 256, 256, 0, stream>>>(
        zdim, blocks, part, maxpart, static_cast<float*>(gram), static_cast<float*>(maxs));
    return (int)cudaGetLastError();
}

// stage 3: newuv (2r, n), nd (n,); with g (non-null) also gram2 (2r+2, 2r+2);
// uv and newuv rows ld apart
extern "C" int psgd_lra_stage3(int n, int ld, int r, const void* uv, const void* d, const void* h,
                               const void* v, const void* g, const void* coef, const void* scal,
                               void* newuv, void* nd, void* gram2, void* scratch, void* stream_ptr) {
    if (n < 1 || ld < n || r < 1 || r > LRA_MAX_RANK) return (int)cudaErrorInvalidValue;
    cudaError_t e = lra_smem_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    float* out = static_cast<float*>(newuv);
    float* ndp = static_cast<float*>(nd);
    if (!g) {
        lra_stage3_kernel<<<(n + LRA_TILE - 1) / LRA_TILE, LRA_TILE, 0, stream>>>(
            n, ld, r, f(uv), f(d), f(h), f(v), f(coef), f(scal), out, ndp);
        return (int)cudaGetLastError();
    }
    const int blocks = lra_blocks(n), zdim = 2 * r + 2, npairs = lra_pairs(zdim);
    float* part = static_cast<float*>(scratch);
    lra_stage3_apply_kernel<<<blocks, LRA_TILE, lra_smem(r), stream>>>(
        n, ld, r, f(uv), f(d), f(h), f(v), f(g), f(coef), f(scal), out, ndp, part);
    lra_reduce_kernel<<<(npairs + 255) / 256, 256, 0, stream>>>(zdim, blocks, part, nullptr,
                                                               static_cast<float*>(gram2), nullptr);
    return (int)cudaGetLastError();
}

// stage 4: pre (n,) = d' (d' g + t1 U' + t2 V'); newuv rows ld apart
extern "C" int psgd_lra_stage4(int n, int ld, int r, const void* newuv, const void* newd, const void* g,
                               const void* coef4, void* pre, void* stream_ptr) {
    if (n < 1 || ld < n || r < 1 || r > LRA_MAX_RANK) return (int)cudaErrorInvalidValue;
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    lra_stage4_kernel<<<(n + LRA_TILE - 1) / LRA_TILE, LRA_TILE, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        n, ld, r, f(newuv), f(newd), f(g), f(coef4), static_cast<float*>(pre));
    return (int)cudaGetLastError();
}
