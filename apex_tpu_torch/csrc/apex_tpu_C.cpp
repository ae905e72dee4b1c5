// apex_tpu_torch native host runtime: the port's own copy of the JAX
// package's host library (the same C ABI, version 2).
//
// Reference parity: the reference's host-side native layer — apex_C
// flatten/unflatten (csrc/flatten_unflatten.cpp:16-17), the
// multi_tensor_apply chunking engine's host bookkeeping
// (csrc/multi_tensor_apply.cuh:19-133), and the C++ indexed-dataset
// machinery the Megatron data path relies on. The device side of those
// components is the port's CUDA kernels and torch; what stays native on
// the host is staging training batches out of memory-mapped token files
// and packing/unpacking parameter buffers without Python-loop overhead.
//
// A plain C ABI consumed via ctypes, built with g++ at first use
// (apex_tpu_torch/_native.py). Every function operates on caller-owned
// memory; the Python wrapper owns shape/bounds validation, and raises
// when this library does not build or load (there is no fallback).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// Multithreaded row gather for large staging batches: the per-sample
// memcpys are independent, so rows are striped over `n_threads` workers
// (host DRAM bandwidth spans several cores; one core saturates ~1/3 of
// it on typical server parts). Callers pick the threshold — tiny batches
// stay single-threaded to skip thread spawn cost.
template <typename T>
static void gather_rows_mt_impl(const T* data, const int64_t* offsets,
                                int64_t n_rows, int64_t row_len, T* out,
                                int64_t n_threads) {
  if (n_threads < 2 || n_rows < n_threads) {
    for (int64_t i = 0; i < n_rows; ++i)
      std::memcpy(out + i * row_len, data + offsets[i],
                  static_cast<size_t>(row_len) * sizeof(T));
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(static_cast<size_t>(n_threads));
  for (int64_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([=]() {
      for (int64_t i = t; i < n_rows; i += n_threads)
        std::memcpy(out + i * row_len, data + offsets[i],
                    static_cast<size_t>(row_len) * sizeof(T));
    });
  }
  for (auto& w : workers) w.join();
}

extern "C" {

// Batched row gather: out[i, :] = data[offsets[i] : offsets[i] + row_len].
// The data-loader hot loop: one memcpy per sample from the token memmap
// into the pinned staging batch.
void gather_rows_i32(const int32_t* data, const int64_t* offsets,
                     int64_t n_rows, int64_t row_len, int32_t* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    std::memcpy(out + i * row_len, data + offsets[i],
                static_cast<size_t>(row_len) * sizeof(int32_t));
  }
}

void gather_rows_u16(const uint16_t* data, const int64_t* offsets,
                     int64_t n_rows, int64_t row_len, uint16_t* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    std::memcpy(out + i * row_len, data + offsets[i],
                static_cast<size_t>(row_len) * sizeof(uint16_t));
  }
}

void gather_rows_i32_mt(const int32_t* data, const int64_t* offsets,
                        int64_t n_rows, int64_t row_len, int32_t* out,
                        int64_t n_threads) {
  gather_rows_mt_impl(data, offsets, n_rows, row_len, out, n_threads);
}

void gather_rows_u16_mt(const uint16_t* data, const int64_t* offsets,
                        int64_t n_rows, int64_t row_len, uint16_t* out,
                        int64_t n_threads) {
  gather_rows_mt_impl(data, offsets, n_rows, row_len, out, n_threads);
}

// Flatten n float buffers into one contiguous buffer (apex_C.flatten).
// srcs: array of n pointers; sizes: element counts per buffer.
void flatten_f32(const float* const* srcs, const int64_t* sizes, int64_t n,
                 float* dst) {
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(dst + off, srcs[i], static_cast<size_t>(sizes[i]) * sizeof(float));
    off += sizes[i];
  }
}

// Inverse of flatten_f32 (apex_C.unflatten).
void unflatten_f32(const float* src, const int64_t* sizes, int64_t n,
                   float* const* dsts) {
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(dsts[i], src + off, static_cast<size_t>(sizes[i]) * sizeof(float));
    off += sizes[i];
  }
}

// Deterministic Fisher-Yates permutation with splitmix64 — the sampler's
// epoch shuffle without materializing numpy RandomState overhead for
// billion-sample datasets.
static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

void permutation_i64(int64_t n, uint64_t seed, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t s = seed ^ 0xd6e8feb86659fd93ULL;
  for (int64_t i = n - 1; i > 0; --i) {
    uint64_t j = splitmix64(&s) % static_cast<uint64_t>(i + 1);
    int64_t t = out[i];
    out[i] = out[j];
    out[j] = t;
  }
}

// Build sequence start offsets for fixed-length LM samples over a token
// stream of total length n_tokens: samples at stride `seq_len` (+1 label
// shift handled by the caller). Returns the number of samples written.
int64_t build_lm_sample_offsets(int64_t n_tokens, int64_t seq_len,
                                int64_t* out, int64_t max_out) {
  int64_t n = (n_tokens - 1) / seq_len;
  if (n > max_out) n = max_out;
  for (int64_t i = 0; i < n; ++i) out[i] = i * seq_len;
  return n;
}

int64_t apex_tpu_native_abi_version() { return 2; }

}  // extern "C"
