// Native sqMass spectrum decoder.
//
// Host-side hot loop of raw-data ingestion: sqMass DATA blobs are
// zlib-compressed little-endian float64 arrays (reference decodes them
// one-by-one in Python via zlib + struct.unpack,
// dquartic/utils/raw_data_parser.py:47-55). This module
// decodes batches of blobs in C++ with OpenMP-free std::thread fan-out,
// releasing the GIL via ctypes, so a full run's spectra decode at
// memory bandwidth instead of interpreter speed.
//
// Exposed C ABI (ctypes-friendly; no pybind11 dependency):
//   dq_decode_one    — one blob -> caller buffer, returns element count
//   dq_decoded_size  — peek the uncompressed element count of one blob
//   dq_decode_batch  — many blobs -> one packed float64 buffer + offsets
//
// Build: g++ -O3 -shared -fPIC decode.cpp -o libdqnative.so -lz -lpthread

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

// Inflate `src` fully into `dst` (capacity dst_cap bytes).
// Returns decompressed byte count, or -1 on error / overflow.
long inflate_blob(const unsigned char* src, long src_len, unsigned char* dst,
                  long dst_cap) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return -1;
  zs.next_in = const_cast<unsigned char*>(src);
  zs.avail_in = static_cast<uInt>(src_len);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(dst_cap);
  int ret = inflate(&zs, Z_FINISH);
  long out = static_cast<long>(zs.total_out);
  inflateEnd(&zs);
  if (ret != Z_STREAM_END) return -1;
  return out;
}

// Streaming size probe without keeping the output.
long inflated_size(const unsigned char* src, long src_len) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return -1;
  zs.next_in = const_cast<unsigned char*>(src);
  zs.avail_in = static_cast<uInt>(src_len);
  unsigned char scratch[1 << 16];
  long total = 0;
  int ret;
  do {
    zs.next_out = scratch;
    zs.avail_out = sizeof(scratch);
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return -1;
    }
    total += static_cast<long>(sizeof(scratch) - zs.avail_out);
  } while (ret != Z_STREAM_END);
  inflateEnd(&zs);
  return total;
}

}  // namespace

extern "C" {

// Number of float64 elements a decoded blob would hold; -1 on error.
// compression: 1/3 => zlib, else raw bytes.
long dq_decoded_size(const unsigned char* blob, long blob_len, int compression) {
  if (compression == 1 || compression == 3) {
    long bytes = inflated_size(blob, blob_len);
    return bytes < 0 ? -1 : bytes / 8;
  }
  return blob_len / 8;
}

// Decode one blob into out (capacity out_cap float64 elements).
// Returns element count, or -1 on error/overflow.
long dq_decode_one(const unsigned char* blob, long blob_len, int compression,
                   double* out, long out_cap) {
  if (compression == 1 || compression == 3) {
    long bytes = inflate_blob(blob, blob_len,
                              reinterpret_cast<unsigned char*>(out), out_cap * 8);
    return bytes < 0 ? -1 : bytes / 8;
  }
  long n = blob_len / 8;
  if (n > out_cap) return -1;
  std::memcpy(out, blob, n * 8);
  return n;
}

// Decode `n` blobs (packed in `blobs` with byte offsets blob_offsets[n+1],
// per-blob compression codes) into `out` (packed float64, capacity
// out_cap elements). Writes element offsets into out_offsets[n+1].
// Returns total elements written, or -1 on any blob error / overflow.
long dq_decode_batch(const unsigned char* blobs, const long* blob_offsets,
                     const int* compressions, long n, double* out,
                     long out_cap, long* out_offsets, int num_threads) {
  if (n <= 0) return 0;
  std::vector<long> sizes(n, -1);

  auto size_worker = [&](long start, long stride) {
    for (long i = start; i < n; i += stride) {
      sizes[i] = dq_decoded_size(blobs + blob_offsets[i],
                                 blob_offsets[i + 1] - blob_offsets[i],
                                 compressions[i]);
    }
  };

  int nt = num_threads > 0 ? num_threads : 1;
  if (nt > 1) {
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(size_worker, t, nt);
    for (auto& th : pool) th.join();
  } else {
    size_worker(0, 1);
  }

  out_offsets[0] = 0;
  for (long i = 0; i < n; ++i) {
    if (sizes[i] < 0) return -1;
    out_offsets[i + 1] = out_offsets[i] + sizes[i];
  }
  if (out_offsets[n] > out_cap) return -1;

  std::vector<long> status(n, 0);
  auto decode_worker = [&](long start, long stride) {
    for (long i = start; i < n; i += stride) {
      long got = dq_decode_one(blobs + blob_offsets[i],
                               blob_offsets[i + 1] - blob_offsets[i],
                               compressions[i], out + out_offsets[i], sizes[i]);
      status[i] = (got == sizes[i]) ? 0 : 1;
    }
  };
  if (nt > 1) {
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(decode_worker, t, nt);
    for (auto& th : pool) th.join();
  } else {
    decode_worker(0, 1);
  }
  for (long i = 0; i < n; ++i)
    if (status[i]) return -1;
  return out_offsets[n];
}

}  // extern "C"
