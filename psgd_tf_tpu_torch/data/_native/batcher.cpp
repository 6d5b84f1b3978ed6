// Native host-side data pipeline: idx decoding and batch assembly.
//
// The TPU compute path is JAX/XLA/Pallas; this is the host runtime around
// it. Training at high step rates (bench.py: thousands of steps/sec) makes
// the Python-side batch gather the serial bottleneck for real-dataset
// training, so the hot host loop — uniform sampling + row gather +
// uint8->float normalization — lives here, exposed as a C ABI consumed via
// ctypes (psgd_tf_tpu/data/native.py). No Python objects cross the
// boundary; buffers are caller-allocated numpy arrays.
//
// Reference parity note: the reference's data handling is keras downloads
// plus numpy shuffling in the training loop
// (the TF reference's mnist_with_lenet5.py:36-41,66-72); this replaces it for
// hermetic, multi-epoch TPU feeding.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// xorshift64* — deterministic, seedable, fast; good enough for batch
// sampling (not for probe vectors, which stay on-device with JAX PRNG).
static inline uint64_t next_rand(uint64_t* s) {
  uint64_t x = *s;
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  *s = x;
  return x * 0x2545F4914F6CDD1DULL;
}

// Parse an idx3 (images) file already read into memory. Returns the number
// of images written, or -1 on format error. Output is float32 in [0, 1],
// laid out (n, rows*cols).
long psgd_decode_idx_images(const uint8_t* buf, long len, float* out,
                            long max_n) {
  if (len < 16) return -1;
  uint32_t magic = (buf[0] << 24) | (buf[1] << 16) | (buf[2] << 8) | buf[3];
  if (magic != 2051) return -1;
  long n = (long)((buf[4] << 24) | (buf[5] << 16) | (buf[6] << 8) | buf[7]);
  long rows = (long)((buf[8] << 24) | (buf[9] << 16) | (buf[10] << 8) | buf[11]);
  long cols = (long)((buf[12] << 24) | (buf[13] << 16) | (buf[14] << 8) | buf[15]);
  if (n > max_n) n = max_n;
  long px = rows * cols;
  if (len < 16 + n * px) return -1;
  const uint8_t* p = buf + 16;
  const float inv = 1.0f / 255.0f;
  for (long i = 0; i < n * px; ++i) out[i] = inv * (float)p[i];
  return n;
}

// Parse an idx1 (labels) file from memory into int32. Returns count or -1.
long psgd_decode_idx_labels(const uint8_t* buf, long len, int32_t* out,
                            long max_n) {
  if (len < 8) return -1;
  uint32_t magic = (buf[0] << 24) | (buf[1] << 16) | (buf[2] << 8) | buf[3];
  if (magic != 2049) return -1;
  long n = (long)((buf[4] << 24) | (buf[5] << 16) | (buf[6] << 8) | buf[7]);
  if (n > max_n) n = max_n;
  if (len < 8 + n) return -1;
  for (long i = 0; i < n; ++i) out[i] = (int32_t)buf[8 + i];
  return n;
}

// Assemble one uniformly-sampled batch: gather `batch` rows of `feat`
// floats from (images, labels) into (out_x, out_y). Deterministic in
// `seed`; the seed should change per step (fold the step index in).
void psgd_sample_batch(const float* images, const int32_t* labels, long n,
                       long feat, long batch, uint64_t seed, float* out_x,
                       int32_t* out_y) {
  uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ULL;
  // warm the generator so small seeds decorrelate
  next_rand(&s);
  next_rand(&s);
  for (long b = 0; b < batch; ++b) {
    long idx = (long)(next_rand(&s) % (uint64_t)n);
    memcpy(out_x + b * feat, images + idx * feat, sizeof(float) * feat);
    out_y[b] = labels[idx];
  }
}

// Assemble a shuffled epoch order (Fisher-Yates), for exact-epoch training
// (the reference shuffles per epoch, mnist_with_lenet5.py:66-68).
void psgd_shuffle_epoch(long n, uint64_t seed, int64_t* order) {
  for (long i = 0; i < n; ++i) order[i] = i;
  uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ULL;
  next_rand(&s);
  for (long i = n - 1; i > 0; --i) {
    long j = (long)(next_rand(&s) % (uint64_t)(i + 1));
    int64_t t = order[i];
    order[i] = order[j];
    order[j] = t;
  }
}

}  // extern "C"
