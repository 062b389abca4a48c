// Lock-free single-producer single-consumer ring buffer of f32 samples.
//
// The native transport of the device-I/O layer: the reference uses the rtrb
// crate for its microphone capture ring (src/microphone.rs:119,270) and
// cpal's internal ring for playback; this is the equivalent for rodio_tpu's
// host feed/drain paths (capture thread -> block assembler, renderer ->
// playback callback).
//
// C ABI: create/destroy/push/pop/len/capacity. Pointers are opaque handles.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Ring {
  float* buf;
  size_t capacity;  // power of two
  std::atomic<uint64_t> head{0};  // write index (producer)
  std::atomic<uint64_t> tail{0};  // read index (consumer)
};

size_t next_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

void* rtpu_ring_create(size_t capacity) {
  Ring* r = new Ring();
  r->capacity = next_pow2(capacity < 2 ? 2 : capacity);
  r->buf = (float*)malloc(sizeof(float) * r->capacity);
  if (!r->buf) {
    delete r;
    return nullptr;
  }
  return r;
}

void rtpu_ring_destroy(void* h) {
  Ring* r = (Ring*)h;
  if (!r) return;
  free(r->buf);
  delete r;
}

size_t rtpu_ring_capacity(void* h) { return ((Ring*)h)->capacity; }

size_t rtpu_ring_len(void* h) {
  Ring* r = (Ring*)h;
  return (size_t)(r->head.load(std::memory_order_acquire) -
                  r->tail.load(std::memory_order_acquire));
}

// producer side: push up to n samples, returns number pushed (drops the
// rest when full — matching the reference's drop-on-full capture policy,
// src/microphone.rs:287-289)
size_t rtpu_ring_push(void* h, const float* data, size_t n) {
  Ring* r = (Ring*)h;
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  size_t free_slots = r->capacity - (size_t)(head - tail);
  size_t count = n < free_slots ? n : free_slots;
  size_t mask = r->capacity - 1;
  for (size_t i = 0; i < count; ++i) r->buf[(head + i) & mask] = data[i];
  r->head.store(head + count, std::memory_order_release);
  return count;
}

// consumer side: pop up to n samples, returns number popped
size_t rtpu_ring_pop(void* h, float* out, size_t n) {
  Ring* r = (Ring*)h;
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  size_t avail = (size_t)(head - tail);
  size_t count = n < avail ? n : avail;
  size_t mask = r->capacity - 1;
  for (size_t i = 0; i < count; ++i) out[i] = r->buf[(tail + i) & mask];
  r->tail.store(tail + count, std::memory_order_release);
  return count;
}

}  // extern "C"
