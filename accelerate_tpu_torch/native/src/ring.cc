// Bounded staging ring for the host data pipeline.
//
// The reference's host-side prefetch lives in torch DataLoader worker
// processes + MpDeviceLoader background transfer (reference data_loader.py:
// 654, :567-583) — both native code inside torch/torch_xla.  This is the
// in-tree equivalent: a fixed arena of aligned slots with producer/consumer
// semantics (blocking acquire/pop, FIFO), so a background Python thread can
// stage batch bytes (numpy copies into slot views release the GIL) while the
// main thread feeds the device.
//
// Single-producer/single-consumer is the intended use; the implementation is
// MPMC-safe anyway (mutex + two condvars).

#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Ring {
  char* arena = nullptr;
  uint64_t slot_bytes = 0;
  int n_slots = 0;
  std::mutex mu;
  std::condition_variable have_free;
  std::condition_variable have_filled;
  std::deque<int> free_q;
  // filled FIFO: (slot index, committed byte count)
  std::deque<std::pair<int, uint64_t>> filled_q;
  bool closed = false;

  char* slot_ptr(int i) { return arena + (uint64_t)i * slot_bytes; }
  int slot_index(const char* p) { return (int)((p - arena) / (int64_t)slot_bytes); }
};

}  // namespace

extern "C" {

void* at_ring_create(int n_slots, uint64_t slot_bytes) {
  if (n_slots < 1 || slot_bytes == 0) return nullptr;
  // round slots to cacheline multiples
  slot_bytes = (slot_bytes + 63) / 64 * 64;
  char* arena = (char*)::aligned_alloc(64, (uint64_t)n_slots * slot_bytes);
  if (!arena) return nullptr;
  Ring* r = new Ring();
  r->arena = arena;
  r->slot_bytes = slot_bytes;
  r->n_slots = n_slots;
  for (int i = 0; i < n_slots; ++i) r->free_q.push_back(i);
  return r;
}

uint64_t at_ring_slot_bytes(void* h) { return ((Ring*)h)->slot_bytes; }

// Producer: block until a free slot is available (or the ring is closed).
// Returns the slot's byte pointer, or NULL if closed.
void* at_ring_acquire(void* h) {
  Ring* r = (Ring*)h;
  std::unique_lock<std::mutex> lk(r->mu);
  r->have_free.wait(lk, [&] { return !r->free_q.empty() || r->closed; });
  if (r->closed) return nullptr;
  int i = r->free_q.front();
  r->free_q.pop_front();
  return r->slot_ptr(i);
}

// Producer: publish `size` staged bytes of an acquired slot.
int at_ring_commit(void* h, void* slot, uint64_t size) {
  Ring* r = (Ring*)h;
  if (size > r->slot_bytes) return -1;
  int i = r->slot_index((char*)slot);
  if (i < 0 || i >= r->n_slots) return -2;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->filled_q.emplace_back(i, size);
  }
  r->have_filled.notify_one();
  return 0;
}

// Consumer: block until a filled slot (returns 1) or closed-and-drained
// (returns 0).  *ptr/*size describe the staged bytes; call at_ring_release
// when done with them.
int at_ring_pop(void* h, void** ptr, uint64_t* size) {
  Ring* r = (Ring*)h;
  std::unique_lock<std::mutex> lk(r->mu);
  r->have_filled.wait(lk, [&] { return !r->filled_q.empty() || r->closed; });
  if (r->filled_q.empty()) return 0;  // closed + drained
  auto [i, sz] = r->filled_q.front();
  r->filled_q.pop_front();
  *ptr = r->slot_ptr(i);
  *size = sz;
  return 1;
}

// Consumer: hand a popped slot back to the free pool.
int at_ring_release(void* h, void* slot) {
  Ring* r = (Ring*)h;
  int i = r->slot_index((char*)slot);
  if (i < 0 || i >= r->n_slots) return -2;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->free_q.push_back(i);
  }
  r->have_free.notify_one();
  return 0;
}

// Either side: wake all waiters; producer acquires fail, consumer drains
// remaining filled slots then gets 0.
void at_ring_close(void* h) {
  Ring* r = (Ring*)h;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->closed = true;
  }
  r->have_free.notify_all();
  r->have_filled.notify_all();
}

void at_ring_destroy(void* h) {
  Ring* r = (Ring*)h;
  ::free(r->arena);
  delete r;
}

}  // extern "C"
