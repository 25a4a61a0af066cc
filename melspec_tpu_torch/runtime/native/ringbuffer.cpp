// Lock-free single-producer/single-consumer sample ring buffer.
//
// Host-side feeder for the streaming mel pipeline: the audio thread pushes
// PCM while the compute thread drains hop-sized chunks for the device. This
// is the native runtime counterpart of the reference's two rings — the
// lock-free SPSC queue its RingBuffer uses under the `rtrb` feature
// (src/rb.rs:4-7) and the SharedArrayBuffer/Atomics ring of its browser
// pipeline (examples/browser/ringbuffer.js:5-67) — rebuilt in C++ with
// acquire/release atomics instead of JS Atomics.
//
// Semantics:
//  - push(): drop-newest when full (returns how many were accepted);
//  - push_overwrite(): overwrite-oldest, returning the dropped count (the
//    browser ring's behavior, with its `dropped` accounting);
//  - pop(): consumer side, returns how many samples were read.
//
// Capacity is rounded up to a power of two so index masking is branch-free.
//
// Overwrite-mode caveat: while a pop() is copying, push_overwrite() may
// memcpy over the same region (the bytes read are then torn). This overlap
// is formally a data race on the float payload; it is rendered unobservable
// by the tail CAS — a pop whose region was invalidated discards its copy
// and retries from the advanced tail — but strict-TSan users should prefer
// plain push() (reject-when-full), which never writes over unread data.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct Ring {
    float* data;
    uint64_t mask;          // capacity - 1 (capacity is a power of two)
    uint64_t capacity;
    std::atomic<uint64_t> head;     // total samples written
    std::atomic<uint64_t> tail;     // total samples read
    std::atomic<uint64_t> dropped;  // samples lost to overwrite/drop
};

uint64_t next_pow2(uint64_t v) {
    if (v < 2) return 2;
    v--;
    v |= v >> 1; v |= v >> 2; v |= v >> 4;
    v |= v >> 8; v |= v >> 16; v |= v >> 32;
    return v + 1;
}

void copy_in(Ring* r, uint64_t pos, const float* src, uint64_t n) {
    uint64_t start = pos & r->mask;
    uint64_t first = n < (r->capacity - start) ? n : (r->capacity - start);
    std::memcpy(r->data + start, src, first * sizeof(float));
    if (n > first) std::memcpy(r->data, src + first, (n - first) * sizeof(float));
}

void copy_out(Ring* r, uint64_t pos, float* dst, uint64_t n) {
    uint64_t start = pos & r->mask;
    uint64_t first = n < (r->capacity - start) ? n : (r->capacity - start);
    std::memcpy(dst, r->data + start, first * sizeof(float));
    if (n > first) std::memcpy(dst + first, r->data, (n - first) * sizeof(float));
}

}  // namespace

extern "C" {

Ring* msrb_create(uint64_t capacity) {
    uint64_t cap = next_pow2(capacity);
    Ring* r = new (std::nothrow) Ring();
    if (!r) return nullptr;
    r->data = new (std::nothrow) float[cap];
    if (!r->data) { delete r; return nullptr; }
    r->mask = cap - 1;
    r->capacity = cap;
    r->head.store(0, std::memory_order_relaxed);
    r->tail.store(0, std::memory_order_relaxed);
    r->dropped.store(0, std::memory_order_relaxed);
    return r;
}

void msrb_destroy(Ring* r) {
    if (!r) return;
    delete[] r->data;
    delete r;
}

uint64_t msrb_capacity(Ring* r) { return r->capacity; }

uint64_t msrb_len(Ring* r) {
    return r->head.load(std::memory_order_acquire) -
           r->tail.load(std::memory_order_acquire);
}

uint64_t msrb_dropped(Ring* r) {
    return r->dropped.load(std::memory_order_relaxed);
}

// Producer: append up to n samples, rejecting the excess (rtrb-style
// push-fails-when-full — the caller may retry the rest). Returns the
// number accepted; rejected samples are NOT counted as dropped (only the
// overwrite mode destroys data).
uint64_t msrb_push(Ring* r, const float* src, uint64_t n) {
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    uint64_t free_slots = r->capacity - (head - tail);
    uint64_t take = n < free_slots ? n : free_slots;
    if (take) {
        copy_in(r, head, src, take);
        r->head.store(head + take, std::memory_order_release);
    }
    return take;
}

// Producer: append n samples, advancing the read cursor over the oldest
// data when full (browser-ring overwrite semantics). Returns samples
// dropped. Safe with one concurrent consumer via CAS on tail.
uint64_t msrb_push_overwrite(Ring* r, const float* src, uint64_t n) {
    uint64_t dropped_now = 0;
    if (n >= r->capacity) {
        // Only the final window can survive.
        dropped_now += n - r->capacity;
        src += n - r->capacity;
        n = r->capacity;
    }
    uint64_t head = r->head.load(std::memory_order_relaxed);
    for (;;) {
        uint64_t tail = r->tail.load(std::memory_order_acquire);
        uint64_t free_slots = r->capacity - (head - tail);
        if (n <= free_slots) break;
        uint64_t need = n - free_slots;
        if (r->tail.compare_exchange_weak(tail, tail + need,
                                          std::memory_order_acq_rel)) {
            dropped_now += need;
            break;
        }
    }
    copy_in(r, head, src, n);
    r->head.store(head + n, std::memory_order_release);
    if (dropped_now) r->dropped.fetch_add(dropped_now, std::memory_order_relaxed);
    return dropped_now;
}

// Consumer: read up to n samples. Returns the number read.
//
// The CAS on tail coordinates with push_overwrite: if the producer advanced
// tail while we copied, the copied bytes may be stale, so the read is
// discarded and retried from the NEW tail — data that survived the
// overwrite is still delivered (a bare `return 0` here would drop it).
uint64_t msrb_pop(Ring* r, float* dst, uint64_t n) {
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    for (;;) {
        uint64_t head = r->head.load(std::memory_order_acquire);
        uint64_t avail = head - tail;
        uint64_t take = n < avail ? n : avail;
        if (!take) return 0;
        copy_out(r, tail, dst, take);
        uint64_t expected = tail;
        if (r->tail.compare_exchange_strong(expected, tail + take,
                                            std::memory_order_acq_rel))
            return take;
        tail = expected;  // overwritten mid-copy: retry at the new tail
    }
}

// Consumer: pop EXACTLY n samples, or nothing (returns 1/0). The
// all-or-nothing contract is what a fixed-hop serving tick wants: a
// stream either contributes a full tick of audio or sits out unchanged.
uint64_t msrb_pop_exact(Ring* r, float* dst, uint64_t n) {
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    for (;;) {
        uint64_t head = r->head.load(std::memory_order_acquire);
        if (head - tail < n) return 0;
        copy_out(r, tail, dst, n);
        uint64_t expected = tail;
        if (r->tail.compare_exchange_strong(expected, tail + n,
                                            std::memory_order_acq_rel))
            return 1;
        tail = expected;  // overwritten mid-copy: retry at the new tail
    }
}

// Batched compute-side drain for a serving fleet: for each non-null
// rings[j], pop exactly `need` samples into out + j*need (ok[j] = 1) or
// leave the ring and the row untouched (ok[j] = 0). Null entries are
// skipped (ok[j] = 0). One FFI call replaces n_rings ctypes round trips
// per tick. Returns the number of rings drained.
uint64_t msrb_pop_many(Ring** rings, uint64_t n_rings, uint64_t need,
                       float* out, uint8_t* ok) {
    uint64_t drained = 0;
    for (uint64_t j = 0; j < n_rings; ++j) {
        if (!rings[j]) { ok[j] = 0; continue; }
        ok[j] = (uint8_t)msrb_pop_exact(rings[j], out + j * need, need);
        drained += ok[j];
    }
    return drained;
}

}  // extern "C"
