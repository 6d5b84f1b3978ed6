// The NMT decoder's additive attention over the encoder states
// (psgd_tf_tpu_torch/models/nmt.py, through ops/hopper/attention.py).
//
// Replaces no kernel of psgd_tf_tpu/ops/pallas/: the JAX package leaves the
// model's attention to XLA, which fuses it inside the decoder's lax.scan.
// Added because, run eagerly, the attention's plain ops read the encoder
// states enc (B, S, U) twice a decoder position in the forward, and
// autograd writes two enc-sized gradients a position in the backward and
// sums them: at the benchmark's 4,096 x 18 x 1,024 (302 MB) that traffic
// took ~16% of a training step on an H100 for under 2% of its FLOPs. Here each
// position reads enc once in each direction, and enc's gradient is written
// once a backward pass.
//
// With hw = h W_h (B, A) and the hoisted ow = enc W_o (B, S, A), both plain
// products outside these kernels:
//   attn_fwd_kernel      a position's forward, one block a batch row:
//                        score_s = v . tanh(hw + ow_s), -inf where masked,
//                        w = softmax_S(score) (stored, in the stash's slot),
//                        ctx = sum_s w_s enc[b, s, :], the row's S x U slab
//                        streamed once;
//   attn_bwd_kernel      a position's backward, one block a batch row:
//                        dw_s = enc[b, s, :] . dctx in one read of the slab
//                        (d ctx copied into the stash's slot on the way),
//                        ds = w (dw - w . dw), zero where masked, and
//                        g = ds v (1 - tanh^2): d ow = g, d hw = sum_s g and
//                        the row's share of d v = sum_s ds tanh;
//   attn_dv_kernel       d v summed over the rows, a second launch;
//   attn_enc_grad_kernel once a backward pass, one block a batch row:
//                        d enc[b, s, :] = sum_t w_t[b, s] dctx_t[b, :]
//                        + d ow[b, s, :] W_o^T, written once.
// No sum is taken by float atomics: each is a block's fixed-order tree
// (warp shuffles, then the warps in order), so reruns are bit-equal. A
// warp lane holds one attention unit in the backward's tanh pass:
// A <= ATTN_A_MAX.
//
// What bounds them: bytes. The forward and the backward each read enc once
// (302 MB, 0.090 ms at 3.35 TB/s), the enc gradient reads the stashed d ctx
// (B, T, U: 201 MB at T = 12) and writes d enc (302 MB, ~0.15 ms). Rows of
// U floats move as float4 where U, the strides and the addresses allow
// (the template flag V4), else as floats. The measurements are in PERF.md
// (section 6, the kernel table's rows A1-A3).
#include "psgd.cuh"

#include <math.h>

#define ATTN_THREADS 256
#define ATTN_WARPS (ATTN_THREADS / 32)
#define ATTN_A_MAX 32  // attention units: one warp lane each
#define ATTN_SB 8      // s values a pass of the backward's dot products and the enc gradient

namespace {

__device__ __forceinline__ float warp_sum(float x) {
    // a butterfly: every lane ends with the same, fixed-order total
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// The block's total of one value a thread, returned to every thread: the
// warps' totals by shuffles, then the ATTN_WARPS totals in warp order.
// `red` holds ATTN_WARPS floats; every thread of the block calls it.
__device__ float block_sum(float x, float* red) {
    x = warp_sum(x);
    __syncthreads();  // red may still be read by a previous call
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    return warp_sum(lane < ATTN_WARPS ? red[lane] : 0.f);
}

__device__ float block_max(float x, float* red) {
    x = warp_max(x);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    return warp_max(lane < ATTN_WARPS ? red[lane] : -INFINITY);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <bool V4>
__global__ void __launch_bounds__(ATTN_THREADS)
attn_fwd_kernel(int S, int U, int A, const float* __restrict__ hw, const float* __restrict__ ow,
                const float* __restrict__ v, const unsigned char* __restrict__ mask,
                const float* __restrict__ enc, float* w, long long ldw, float* __restrict__ ctx) {
    __shared__ float s_hw[ATTN_A_MAX], s_v[ATTN_A_MAX], red[ATTN_WARPS];
    const long long b = blockIdx.x;
    const int tid = threadIdx.x;
    if (tid < A) {
        s_hw[tid] = hw[b * A + tid];
        s_v[tid] = v[tid];
    }
    __syncthreads();
    // scores, then the softmax, in the stash's slot; a thread rereads only
    // the entries it wrote itself until the barrier below
    float* wb = w + b * ldw;
    const float* owb = ow + b * S * A;
    const unsigned char* mb = mask + b * S;
    float mx = -INFINITY;
    for (int s = tid; s < S; s += ATTN_THREADS) {
        const float* o = owb + (long long)s * A;
        float sc = 0.f;
        for (int a = 0; a < A; ++a) sc += s_v[a] * tanhf(s_hw[a] + o[a]);
        if (!mb[s]) sc = -INFINITY;
        wb[s] = sc;
        mx = fmaxf(mx, sc);
    }
    mx = block_max(mx, red);
    float sum = 0.f;
    for (int s = tid; s < S; s += ATTN_THREADS) {
        // all masked: -inf - -inf is NaN, as torch.softmax gives
        const float e = expf(wb[s] - mx);
        wb[s] = e;
        sum += e;
    }
    sum = block_sum(sum, red);
    for (int s = tid; s < S; s += ATTN_THREADS) wb[s] = wb[s] / sum;
    __syncthreads();
    // ctx = sum_s w_s enc[b, s, :]: the row's slab read once
    const float* eb = enc + b * S * U;
    float* cb = ctx + b * U;
    if (V4) {
        for (int u = tid * 4; u < U; u += ATTN_THREADS * 4) {
            float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 6
            for (int s = 0; s < S; ++s) {
                const float ws = wb[s];
                const float4 e = *reinterpret_cast<const float4*>(eb + (long long)s * U + u);
                acc.x = fmaf(ws, e.x, acc.x);
                acc.y = fmaf(ws, e.y, acc.y);
                acc.z = fmaf(ws, e.z, acc.z);
                acc.w = fmaf(ws, e.w, acc.w);
            }
            *reinterpret_cast<float4*>(cb + u) = acc;
        }
    } else {
        for (int u = tid; u < U; u += ATTN_THREADS) {
            float acc = 0.f;
#pragma unroll 6
            for (int s = 0; s < S; ++s) acc = fmaf(wb[s], eb[(long long)s * U + u], acc);
            cb[u] = acc;
        }
    }
}

template <bool V4>
__global__ void __launch_bounds__(ATTN_THREADS)
attn_bwd_kernel(int S, int U, int A, const float* __restrict__ dctx, long long ldd,
                const float* __restrict__ enc, const float* __restrict__ w, long long ldw,
                const float* __restrict__ hw, const float* __restrict__ ow,
                const float* __restrict__ v, const unsigned char* __restrict__ mask,
                float* __restrict__ dctx_out, long long ldo, float* dw, float* __restrict__ d_hw,
                float* __restrict__ d_ow, float* __restrict__ part) {
    __shared__ float red_s[ATTN_SB][ATTN_WARPS], red[ATTN_WARPS];
    __shared__ float red_h[ATTN_WARPS][32], red_v[ATTN_WARPS][32];
    const long long b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* db = dctx + b * ldd;
    const float* eb = enc + b * S * U;
    float* ob = dctx_out + b * ldo;
    float* dwb = dw + b * S;
    // dw_s = enc[b, s, :] . dctx[b, :], ATTN_SB rows of the slab a pass
    for (int s0 = 0; s0 < S; s0 += ATTN_SB) {
        const int ns = min(ATTN_SB, S - s0);
        float p[ATTN_SB];
#pragma unroll
        for (int j = 0; j < ATTN_SB; ++j) p[j] = 0.f;
        if (V4) {
            for (int u = tid * 4; u < U; u += ATTN_THREADS * 4) {
                const float4 d = *reinterpret_cast<const float4*>(db + u);
                if (s0 == 0) *reinterpret_cast<float4*>(ob + u) = d;
#pragma unroll
                for (int j = 0; j < ATTN_SB; ++j) {
                    if (j < ns) {
                        const float4 e =
                            *reinterpret_cast<const float4*>(eb + (long long)(s0 + j) * U + u);
                        p[j] += dot4(e, d);
                    }
                }
            }
        } else {
            for (int u = tid; u < U; u += ATTN_THREADS) {
                const float d = db[u];
                if (s0 == 0) ob[u] = d;
#pragma unroll
                for (int j = 0; j < ATTN_SB; ++j)
                    if (j < ns) p[j] = fmaf(eb[(long long)(s0 + j) * U + u], d, p[j]);
            }
        }
#pragma unroll
        for (int j = 0; j < ATTN_SB; ++j) p[j] = warp_sum(p[j]);
        if (lane == 0) {
#pragma unroll
            for (int j = 0; j < ATTN_SB; ++j) red_s[j][warp] = p[j];
        }
        __syncthreads();
        if (tid < ns) {
            float t = 0.f;
            for (int k = 0; k < ATTN_WARPS; ++k) t += red_s[tid][k];
            dwb[s0 + tid] = t;
        }
        __syncthreads();
    }
    // the softmax's backward: c = w . dw
    const float* wb = w + b * ldw;
    const unsigned char* mb = mask + b * S;
    float c = 0.f;
    for (int s = tid; s < S; s += ATTN_THREADS) c += wb[s] * dwb[s];
    c = block_sum(c, red);
    // tanh's backward: a warp a row s at a time, a lane an attention unit
    const float* owb = ow + b * S * A;
    float* gb = d_ow + b * S * A;
    float hwa = 0.f, va = 0.f, acc_h = 0.f, acc_v = 0.f;
    if (lane < A) {
        hwa = hw[b * A + lane];
        va = v[lane];
    }
    for (int s = warp; s < S; s += ATTN_WARPS) {
        const float ds = mb[s] ? wb[s] * (dwb[s] - c) : 0.f;
        if (lane < A) {
            const float th = tanhf(hwa + owb[(long long)s * A + lane]);
            const float g = ds * va * (1.f - th * th);
            gb[(long long)s * A + lane] = g;
            acc_h += g;
            acc_v += ds * th;
        }
    }
    red_h[warp][lane] = acc_h;
    red_v[warp][lane] = acc_v;
    __syncthreads();
    if (tid < A) {
        float th = 0.f, tv = 0.f;
        for (int k = 0; k < ATTN_WARPS; ++k) {
            th += red_h[k][tid];
            tv += red_v[k][tid];
        }
        d_hw[b * A + tid] = th;
        part[b * A + tid] = tv;
    }
}

// d v[a] = sum over the rows of part[:, a], one block an attention unit
__global__ void __launch_bounds__(ATTN_THREADS)
attn_dv_kernel(int B, int A, const float* __restrict__ part, float* __restrict__ dv) {
    __shared__ float red[ATTN_WARPS];
    const int a = blockIdx.x;
    float t = 0.f;
    for (long long b = threadIdx.x; b < B; b += ATTN_THREADS) t += part[b * A + a];
    t = block_sum(t, red);
    if (threadIdx.x == 0) dv[a] = t;
}

__device__ __forceinline__ void fma4(float4& acc, float c, float4 x) {
    acc.x = fmaf(c, x.x, acc.x);
    acc.y = fmaf(c, x.y, acc.y);
    acc.z = fmaf(c, x.z, acc.z);
    acc.w = fmaf(c, x.w, acc.w);
}

// d enc[b] (S x U) = W_b^T (S x T) D_b (T x U) + G_b (S x A) W_o^T (A x U):
// a thread takes 4 columns (V4) or one, ATTN_SB rows s a pass with their
// sums in registers; D_b's and W_o^T's rows stream in, coalesced and
// independent of the sums, W_b and G_b come in warp-uniform loads
template <bool V4>
__global__ void __launch_bounds__(ATTN_THREADS)
attn_enc_grad_kernel(int T, int S, int U, int A, const float* __restrict__ w,
                     const float* __restrict__ dctx, const float* __restrict__ d_ow,
                     const float* __restrict__ w_t, float* __restrict__ d_enc) {
    const long long b = blockIdx.x;
    const float* wb = w + b * T * S;
    const float* db = dctx + b * T * U;
    const float* gb = d_ow + b * S * A;
    float* out = d_enc + b * S * U;
    if (V4) {
        for (int u = threadIdx.x * 4; u < U; u += ATTN_THREADS * 4) {
            for (int s0 = 0; s0 < S; s0 += ATTN_SB) {
                const int ns = min(ATTN_SB, S - s0);
                float4 acc[ATTN_SB];
#pragma unroll
                for (int j = 0; j < ATTN_SB; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
                for (int t = 0; t < T; ++t) {
                    const float4 d = *reinterpret_cast<const float4*>(db + (long long)t * U + u);
                    const float* c = wb + (long long)t * S + s0;
#pragma unroll
                    for (int j = 0; j < ATTN_SB; ++j)
                        if (j < ns) fma4(acc[j], __ldg(c + j), d);
                }
#pragma unroll 2
                for (int a = 0; a < A; ++a) {
                    const float4 e = *reinterpret_cast<const float4*>(w_t + (long long)a * U + u);
                    const float* c = gb + (long long)s0 * A + a;
#pragma unroll
                    for (int j = 0; j < ATTN_SB; ++j)
                        if (j < ns) fma4(acc[j], __ldg(c + j * A), e);
                }
#pragma unroll
                for (int j = 0; j < ATTN_SB; ++j)
                    if (j < ns) *reinterpret_cast<float4*>(out + (long long)(s0 + j) * U + u) = acc[j];
            }
        }
    } else {
        for (int u = threadIdx.x; u < U; u += ATTN_THREADS) {
            for (int s0 = 0; s0 < S; s0 += ATTN_SB) {
                const int ns = min(ATTN_SB, S - s0);
                float acc[ATTN_SB];
#pragma unroll
                for (int j = 0; j < ATTN_SB; ++j) acc[j] = 0.f;
#pragma unroll 4
                for (int t = 0; t < T; ++t) {
                    const float d = db[(long long)t * U + u];
                    const float* c = wb + (long long)t * S + s0;
#pragma unroll
                    for (int j = 0; j < ATTN_SB; ++j)
                        if (j < ns) acc[j] = fmaf(__ldg(c + j), d, acc[j]);
                }
#pragma unroll 2
                for (int a = 0; a < A; ++a) {
                    const float e = w_t[(long long)a * U + u];
                    const float* c = gb + (long long)s0 * A + a;
#pragma unroll
                    for (int j = 0; j < ATTN_SB; ++j)
                        if (j < ns) acc[j] = fmaf(__ldg(c + j * A), e, acc[j]);
                }
#pragma unroll
                for (int j = 0; j < ATTN_SB; ++j)
                    if (j < ns) out[(long long)(s0 + j) * U + u] = acc[j];
            }
        }
    }
}

bool bad_shape(int B, int S, int U, int A) {
    return B < 0 || S < 1 || U < 0 || A < 1 || A > ATTN_A_MAX;
}

}  // namespace

extern "C" int psgd_attn_forward(int B, int S, int U, int A, const void* hw, const void* ow,
                                 const void* v, const void* mask, const void* enc, void* w,
                                 long long ldw, void* ctx, int v4, void* stream_ptr) {
    if (bad_shape(B, S, U, A)) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto kernel = v4 ? attn_fwd_kernel<true> : attn_fwd_kernel<false>;
    kernel<<<B, ATTN_THREADS, 0, stream>>>(
        S, U, A, static_cast<const float*>(hw), static_cast<const float*>(ow),
        static_cast<const float*>(v), static_cast<const unsigned char*>(mask),
        static_cast<const float*>(enc), static_cast<float*>(w), ldw, static_cast<float*>(ctx));
    return (int)cudaGetLastError();
}

extern "C" int psgd_attn_backward(int B, int S, int U, int A, const void* dctx, long long ldd,
                                  const void* enc, const void* w, long long ldw, const void* hw,
                                  const void* ow, const void* v, const void* mask, void* dctx_out,
                                  long long ldo, void* dw, void* d_hw, void* d_ow, void* part,
                                  void* dv, int v4, void* stream_ptr) {
    if (bad_shape(B, S, U, A)) return (int)cudaErrorInvalidValue;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (B > 0) {
        auto kernel = v4 ? attn_bwd_kernel<true> : attn_bwd_kernel<false>;
        kernel<<<B, ATTN_THREADS, 0, stream>>>(
            S, U, A, static_cast<const float*>(dctx), ldd, static_cast<const float*>(enc),
            static_cast<const float*>(w), ldw, static_cast<const float*>(hw),
            static_cast<const float*>(ow), static_cast<const float*>(v),
            static_cast<const unsigned char*>(mask), static_cast<float*>(dctx_out), ldo,
            static_cast<float*>(dw), static_cast<float*>(d_hw), static_cast<float*>(d_ow),
            static_cast<float*>(part));
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    attn_dv_kernel<<<A, ATTN_THREADS, 0, stream>>>(B, A, static_cast<const float*>(part),
                                                   static_cast<float*>(dv));
    return (int)cudaGetLastError();
}

extern "C" int psgd_attn_enc_grad(int B, int T, int S, int U, int A, const void* w,
                                  const void* dctx, const void* d_ow, const void* w_t,
                                  void* d_enc, int v4, void* stream_ptr) {
    if (bad_shape(B, S, U, A) || T < 0) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto kernel = v4 ? attn_enc_grad_kernel<true> : attn_enc_grad_kernel<false>;
    kernel<<<B, ATTN_THREADS, 0, stream>>>(
        T, S, U, A, static_cast<const float*>(w), static_cast<const float*>(dctx),
        static_cast<const float*>(d_ow), static_cast<const float*>(w_t),
        static_cast<float*>(d_enc));
    return (int)cudaGetLastError();
}
