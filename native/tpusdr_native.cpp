// tpusdr native host runtime: SPSC ring buffer, IQ file reader, format
// deinterleaver.
//
// Counterpart of the reference's C++ host-side substrate
// (SURVEY.md sections 2.3/2.9): BufferPool + condvar handoff
// (reference src/buffers/BufferPool.cpp:38-99, HackrfSource.cpp:
// 175-201), FileReader chunked reads (FileReader.cpp:48-66), and the
// int8-interleaved -> float-planes conversion the pair-native device layout
// needs at ingest. The device compute path is JAX/XLA; this library keeps
// the host side of the streaming loop off the Python GIL.
//
// Plain C ABI for ctypes. Single-producer/single-consumer by design (one
// ingest thread, one pipeline thread), mirroring the reference's 2-thread
// producer/consumer model.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC byte ring buffer with blocking reads and drop-on-overrun writes
// (the BufferPool::tryGetBuffer drop policy, BufferPool.cpp:62-99).
// ---------------------------------------------------------------------------

struct TsdrRing {
  uint8_t* data;
  size_t capacity;
  std::atomic<uint64_t> head;  // written bytes (producer)
  std::atomic<uint64_t> tail;  // consumed bytes (consumer)
  std::atomic<uint64_t> dropped;
  std::atomic<int> closed;
  std::mutex m;
  std::condition_variable cv;
};

TsdrRing* tsdr_ring_create(size_t capacity) {
  auto* r = new TsdrRing();
  r->data = static_cast<uint8_t*>(std::malloc(capacity));
  if (!r->data) {
    delete r;
    return nullptr;
  }
  r->capacity = capacity;
  r->head = 0;
  r->tail = 0;
  r->dropped = 0;
  r->closed = 0;
  return r;
}

void tsdr_ring_destroy(TsdrRing* r) {
  if (!r) return;
  std::free(r->data);
  delete r;
}

size_t tsdr_ring_available(const TsdrRing* r) {
  return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                             r->tail.load(std::memory_order_acquire));
}

uint64_t tsdr_ring_dropped(const TsdrRing* r) { return r->dropped.load(); }

void tsdr_ring_close(TsdrRing* r) {
  r->closed.store(1, std::memory_order_release);
  std::lock_guard<std::mutex> lk(r->m);
  r->cv.notify_all();
}

// Write n bytes; drops the whole block if it does not fit (overrun policy —
// matches HackrfSource.cpp:184-187 "buffer underrun" drop). Returns bytes
// written (n or 0).
size_t tsdr_ring_write(TsdrRing* r, const uint8_t* src, size_t n) {
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (n > r->capacity - static_cast<size_t>(head - tail)) {
    r->dropped.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }
  size_t pos = static_cast<size_t>(head % r->capacity);
  size_t first = pos + n <= r->capacity ? n : r->capacity - pos;
  std::memcpy(r->data + pos, src, first);
  if (first < n) std::memcpy(r->data, src + first, n - first);
  r->head.store(head + n, std::memory_order_release);
  {
    std::lock_guard<std::mutex> lk(r->m);
    r->cv.notify_one();
  }
  return n;
}

// Blocking read of exactly n bytes with timeout (ms). Returns n, or 0 on
// timeout / close-with-insufficient-data. (HackrfSource read timeout,
// HackrfSource.cpp:36,306-318.)
size_t tsdr_ring_read(TsdrRing* r, uint8_t* dst, size_t n, int timeout_ms) {
  auto deadline =
      std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);
  for (;;) {
    if (tsdr_ring_available(r) >= n) break;
    if (r->closed.load(std::memory_order_acquire)) return 0;
    std::unique_lock<std::mutex> lk(r->m);
    if (r->cv.wait_until(lk, deadline) == std::cv_status::timeout) {
      if (tsdr_ring_available(r) >= n) break;
      return 0;
    }
  }
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  size_t pos = static_cast<size_t>(tail % r->capacity);
  size_t first = pos + n <= r->capacity ? n : r->capacity - pos;
  std::memcpy(dst, r->data + pos, first);
  if (first < n) std::memcpy(dst + first, r->data, n - first);
  r->tail.store(tail + n, std::memory_order_release);
  {
    // wake a producer blocked in tsdr_ring_write_wait (file backpressure)
    std::lock_guard<std::mutex> lk(r->m);
    r->cv.notify_all();
  }
  return n;
}

// Blocking write: wait for room instead of dropping (file playback
// backpressure). Never touches the dropped counter — a drop means LOST
// samples (live-source overrun, HackrfSource.cpp:184-187); a paused file
// read loses nothing. Returns n, or 0 on close/timeout.
size_t tsdr_ring_write_wait(TsdrRing* r, const uint8_t* src, size_t n,
                            int timeout_ms) {
  auto deadline =
      std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);
  for (;;) {
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    if (n <= r->capacity - static_cast<size_t>(head - tail)) break;
    if (r->closed.load(std::memory_order_acquire)) return 0;
    std::unique_lock<std::mutex> lk(r->m);
    if (r->cv.wait_until(lk, deadline) == std::cv_status::timeout) return 0;
  }
  uint64_t head = r->head.load(std::memory_order_relaxed);
  size_t pos = static_cast<size_t>(head % r->capacity);
  size_t first = pos + n <= r->capacity ? n : r->capacity - pos;
  std::memcpy(r->data + pos, src, first);
  if (first < n) std::memcpy(r->data, src + first, n - first);
  r->head.store(head + n, std::memory_order_release);
  {
    std::lock_guard<std::mutex> lk(r->m);
    r->cv.notify_one();
  }
  return n;
}

// ---------------------------------------------------------------------------
// File reader: background thread streaming a capture file into a ring
// (FileReader.cpp:48-66's 64 KiB fread loop, moved off the pipeline thread).
// ---------------------------------------------------------------------------

struct TsdrFileReader {
  TsdrRing* ring;
  std::FILE* f;
  std::thread th;
  std::atomic<int> stop;
  size_t chunk;
  int loop;
};

static void file_reader_main(TsdrFileReader* fr) {
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(fr->chunk));
  for (;;) {
    if (fr->stop.load(std::memory_order_acquire)) break;
    size_t n = std::fread(buf, 1, fr->chunk, fr->f);
    if (n == 0) {
      if (fr->loop) {
        std::fseek(fr->f, 0, SEEK_SET);
        continue;
      }
      break;
    }
    // Backpressure: wait for room instead of dropping (file playback);
    // the blocking write never counts a drop — nothing is lost, the
    // fread is merely paused (the dropped counter stays a LIVE-overrun
    // signal, so soak artifacts read 0 unless samples actually vanished)
    while (!fr->stop.load(std::memory_order_acquire) &&
           tsdr_ring_write_wait(fr->ring, buf, n, 100) == 0) {
    }
  }
  std::free(buf);
  tsdr_ring_close(fr->ring);
}

TsdrFileReader* tsdr_file_reader_start(const char* path, TsdrRing* ring,
                                       size_t chunk, int loop) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* fr = new TsdrFileReader();
  fr->ring = ring;
  fr->f = f;
  fr->stop = 0;
  fr->chunk = chunk ? chunk : (64 << 10);
  fr->loop = loop;
  fr->th = std::thread(file_reader_main, fr);
  return fr;
}

void tsdr_file_reader_stop(TsdrFileReader* fr) {
  if (!fr) return;
  fr->stop.store(1, std::memory_order_release);
  tsdr_ring_close(fr->ring);
  if (fr->th.joinable()) fr->th.join();
  std::fclose(fr->f);
  delete fr;
}

// ---------------------------------------------------------------------------
// Format conversion: interleaved IQ -> separate float32 I/Q planes.
// The pair-native device layout wants two contiguous float planes per block;
// doing the deinterleave + normalize in one C pass (auto-vectorized) beats
// two strided numpy copies. gsdrInt8ToNormFloat's host-side sibling.
// ---------------------------------------------------------------------------

void tsdr_deinterleave_i8(const int8_t* src, float* re, float* im, size_t n,
                          float scale) {
  for (size_t i = 0; i < n; ++i) {
    re[i] = static_cast<float>(src[2 * i]) * scale;
    im[i] = static_cast<float>(src[2 * i + 1]) * scale;
  }
}

void tsdr_deinterleave_i16(const int16_t* src, float* re, float* im, size_t n,
                           float scale) {
  for (size_t i = 0; i < n; ++i) {
    re[i] = static_cast<float>(src[2 * i]) * scale;
    im[i] = static_cast<float>(src[2 * i + 1]) * scale;
  }
}

void tsdr_deinterleave_f32(const float* src, float* re, float* im, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    re[i] = src[2 * i];
    im[i] = src[2 * i + 1];
  }
}

// float32 PCM [-1,1] -> int16 (WAV sink hot loop)
void tsdr_f32_to_i16(const float* src, int16_t* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    float v = src[i] * 32767.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    dst[i] = static_cast<int16_t>(v + (v >= 0 ? 0.5f : -0.5f));
  }
}

}  // extern "C"
