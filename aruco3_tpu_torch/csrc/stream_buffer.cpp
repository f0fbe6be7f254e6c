// aruco3_tpu native streaming runtime.
//
// The reference's "runtime" is a synchronous per-frame webcam loop
// (reference examples/webcam_kamera.rs:28-77).  The TPU framework needs the
// host side to keep one or more camera/video streams flowing into
// fixed-shape frame batches without stalling the device: that ingest path
// (ring buffers, batch assembly, luma conversion) is bandwidth-bound host
// work, so it lives here in C++ behind a C ABI consumed via ctypes
// (aruco3_tpu/runtime/stream.py).
//
// Components:
//   * StreamRing  — single-producer/single-consumer lock-free ring of
//     fixed-size frame slots (uint8), with drop-oldest backpressure and
//     drop/enqueue counters.
//   * BatchAssembler — round-robins N rings and packs the next B frames
//     into a caller-provided contiguous (B, H, W) buffer, recording the
//     (stream, seq) provenance of each slot; short batches are padded by
//     repeating the last frame (flagged so the caller can mask lanes).
//   * rgb_to_luma_u8 — Rec.709 luma conversion matching
//     frontend.rgb_to_luma_u8 (rounded float weights on nonlinear 8-bit
//     values), for hosts that deliver RGB/RGBA.
//
// Build: tools/build_native.sh (g++ -O3 -shared -fPIC).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct StreamRing {
  int64_t slot_bytes = 0;
  int64_t capacity = 0;  // number of slots
  std::vector<uint8_t> data;
  std::vector<uint64_t> seq;           // sequence number per slot
  std::atomic<int64_t> head{0};        // next write position (producer)
  std::atomic<int64_t> tail{0};        // next read position (consumer)
  std::atomic<uint64_t> enqueued{0};
  std::atomic<uint64_t> dropped{0};
  uint64_t next_seq = 0;
};

}  // namespace

extern "C" {

void* stream_ring_create(int64_t slot_bytes, int64_t capacity) {
  auto* r = new StreamRing();
  r->slot_bytes = slot_bytes;
  r->capacity = capacity;
  r->data.resize(static_cast<size_t>(slot_bytes) * capacity);
  r->seq.resize(capacity, 0);
  return r;
}

void stream_ring_destroy(void* ring) { delete static_cast<StreamRing*>(ring); }

// Producer: copy one frame in.  Drop-oldest when full (live streams must
// not block the camera thread).  Returns the frame's sequence number.
uint64_t stream_ring_push(void* ring, const uint8_t* frame) {
  auto* r = static_cast<StreamRing*>(ring);
  int64_t head = r->head.load(std::memory_order_relaxed);
  int64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->capacity) {
    // Full: advance tail (drop the oldest frame).
    r->tail.store(tail + 1, std::memory_order_release);
    r->dropped.fetch_add(1, std::memory_order_relaxed);
  }
  int64_t slot = head % r->capacity;
  std::memcpy(r->data.data() + slot * r->slot_bytes, frame,
              static_cast<size_t>(r->slot_bytes));
  r->seq[slot] = r->next_seq++;
  r->head.store(head + 1, std::memory_order_release);
  r->enqueued.fetch_add(1, std::memory_order_relaxed);
  return r->next_seq - 1;
}

// Consumer: pop one frame into `out`.  Returns sequence number or -1 if
// empty.
int64_t stream_ring_pop(void* ring, uint8_t* out) {
  auto* r = static_cast<StreamRing*>(ring);
  int64_t tail = r->tail.load(std::memory_order_relaxed);
  int64_t head = r->head.load(std::memory_order_acquire);
  if (tail >= head) return -1;
  int64_t slot = tail % r->capacity;
  std::memcpy(out, r->data.data() + slot * r->slot_bytes,
              static_cast<size_t>(r->slot_bytes));
  int64_t s = static_cast<int64_t>(r->seq[slot]);
  r->tail.store(tail + 1, std::memory_order_release);
  return s;
}

int64_t stream_ring_size(void* ring) {
  auto* r = static_cast<StreamRing*>(ring);
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

uint64_t stream_ring_dropped(void* ring) {
  return static_cast<StreamRing*>(ring)->dropped.load(
      std::memory_order_relaxed);
}

uint64_t stream_ring_enqueued(void* ring) {
  return static_cast<StreamRing*>(ring)->enqueued.load(
      std::memory_order_relaxed);
}

// Assemble a (batch, slot_bytes) contiguous buffer by round-robining the
// given rings.  stream_ids/seqs (length batch) record provenance; lanes
// with stream_id == -1 are padding (repeat of the last real frame, or
// zeros when no ring had any frame).  Returns the number of real frames.
int64_t batch_assemble(void** rings, int64_t n_rings, int64_t batch,
                       uint8_t* out, int64_t slot_bytes, int64_t* stream_ids,
                       int64_t* seqs) {
  int64_t filled = 0;
  int64_t exhausted = 0;
  int64_t s = 0;
  while (filled < batch && exhausted < n_rings) {
    exhausted = 0;
    for (int64_t i = 0; i < n_rings && filled < batch; ++i) {
      int64_t idx = (s + i) % n_rings;
      int64_t seq = stream_ring_pop(rings[idx], out + filled * slot_bytes);
      if (seq < 0) {
        ++exhausted;
        continue;
      }
      stream_ids[filled] = idx;
      seqs[filled] = seq;
      ++filled;
    }
    s = (s + 1) % n_rings;
  }
  for (int64_t j = filled; j < batch; ++j) {
    if (filled > 0) {
      std::memcpy(out + j * slot_bytes, out + (filled - 1) * slot_bytes,
                  static_cast<size_t>(slot_bytes));
    } else {
      std::memset(out + j * slot_bytes, 0, static_cast<size_t>(slot_bytes));
    }
    stream_ids[j] = -1;
    seqs[j] = -1;
  }
  return filled;
}

// Rec.709 luma on nonlinear 8-bit channels, rounded to nearest — matches
// frontend.rgb_to_luma_u8 (image-crate into_luma8 semantics,
// reference aruco.rs:60).
void rgb_to_luma_u8(const uint8_t* rgb, uint8_t* out, int64_t n_pixels,
                    int channels) {
  constexpr float wr = 0.212671f, wg = 0.715160f, wb = 0.072169f;
  for (int64_t i = 0; i < n_pixels; ++i) {
    const uint8_t* p = rgb + i * channels;
    float l = wr * p[0] + wg * p[1] + wb * p[2];
    out[i] = static_cast<uint8_t>(std::lround(l));
  }
}

}  // extern "C"
