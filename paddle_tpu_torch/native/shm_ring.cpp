// Shared-memory bounded MPSC ring buffer: the transport of the
// DataLoader's worker processes (paddle_tpu_torch/io/multiprocess.py).
//
// Workers (several producer processes) push serialized batches; the
// trainer process (the one consumer) pops them in claim order.
// Synchronisation: a PROCESS_SHARED counting semaphore of free slots and a
// per-slot ready semaphore, all inside the mapped segment. Host code only:
// no CUDA, so a worker never touches the card.
//
// Built by paddle_tpu_torch/io/_native.py at first use:
//   g++ -O2 -shared -fPIC -std=c++17 shm_ring.cpp -o <so> -lpthread -lrt
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <semaphore.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x50445452494e4731ULL;  // "PDTRING1"

struct SlotHeader {
  sem_t ready;        // posted by producer when slot payload is complete
  uint64_t len;
};

struct RingHeader {
  uint64_t magic;
  uint64_t slot_size;  // payload capacity per slot
  uint32_t n_slots;
  std::atomic<uint64_t> head;  // next producer sequence (fetch_add)
  uint64_t tail;               // consumer-only
  sem_t spaces;                // free slots
};

struct Ring {
  RingHeader* hdr;
  char* base;          // mapped region
  size_t map_len;
  char name[256];
  bool owner;
};

inline SlotHeader* slot_hdr(Ring* r, uint64_t i) {
  size_t stride = sizeof(SlotHeader) + r->hdr->slot_size;
  return reinterpret_cast<SlotHeader*>(
      r->base + sizeof(RingHeader) + (i % r->hdr->n_slots) * stride);
}

inline char* slot_data(SlotHeader* s) {
  return reinterpret_cast<char*>(s) + sizeof(SlotHeader);
}

int timed_wait(sem_t* sem, int timeout_ms) {
  if (timeout_ms < 0) {
    while (sem_wait(sem) != 0) {
      if (errno != EINTR) return -1;
    }
    return 0;
  }
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  ts.tv_sec += timeout_ms / 1000;
  ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) {
    ts.tv_sec += 1;
    ts.tv_nsec -= 1000000000L;
  }
  while (sem_timedwait(sem, &ts) != 0) {
    if (errno == EINTR) continue;
    return -1;
  }
  return 0;
}

}  // namespace

extern "C" {

void* shm_ring_create(const char* name, uint64_t slot_size,
                      uint32_t n_slots) {
  size_t stride = sizeof(SlotHeader) + slot_size;
  size_t len = sizeof(RingHeader) + stride * n_slots;
  shm_unlink(name);  // stale ring from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)len) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  Ring* r = new Ring();
  r->base = static_cast<char*>(mem);
  r->map_len = len;
  r->hdr = reinterpret_cast<RingHeader*>(mem);
  std::snprintf(r->name, sizeof(r->name), "%s", name);
  r->owner = true;
  r->hdr->slot_size = slot_size;
  r->hdr->n_slots = n_slots;
  r->hdr->head.store(0);
  r->hdr->tail = 0;
  sem_init(&r->hdr->spaces, 1, n_slots);
  for (uint32_t i = 0; i < n_slots; ++i) {
    SlotHeader* s = slot_hdr(r, i);
    sem_init(&s->ready, 1, 0);
    s->len = 0;
  }
  r->hdr->magic = kMagic;
  return r;
}

void* shm_ring_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Ring* r = new Ring();
  r->base = static_cast<char*>(mem);
  r->map_len = st.st_size;
  r->hdr = reinterpret_cast<RingHeader*>(mem);
  std::snprintf(r->name, sizeof(r->name), "%s", name);
  r->owner = false;
  if (r->hdr->magic != kMagic) {
    munmap(mem, r->map_len);
    delete r;
    return nullptr;
  }
  return r;
}

uint64_t shm_ring_slot_size(void* ring) {
  return static_cast<Ring*>(ring)->hdr->slot_size;
}

// 0 ok; -1 timeout; -2 message too big
int shm_ring_push(void* ring, const void* data, uint64_t len,
                  int timeout_ms) {
  Ring* r = static_cast<Ring*>(ring);
  if (len > r->hdr->slot_size) return -2;
  if (timed_wait(&r->hdr->spaces, timeout_ms) != 0) return -1;
  uint64_t seq = r->hdr->head.fetch_add(1);
  SlotHeader* s = slot_hdr(r, seq);
  s->len = len;
  std::memcpy(slot_data(s), data, len);
  sem_post(&s->ready);
  return 0;
}

// >=0 payload length; -1 timeout; -3 caller buffer too small (message kept)
int64_t shm_ring_pop(void* ring, void* out, uint64_t cap, int timeout_ms) {
  Ring* r = static_cast<Ring*>(ring);
  SlotHeader* s = slot_hdr(r, r->hdr->tail);
  if (timed_wait(&s->ready, timeout_ms) != 0) return -1;
  if (s->len > cap) {
    sem_post(&s->ready);  // put it back
    return -3;
  }
  int64_t len = (int64_t)s->len;
  std::memcpy(out, slot_data(s), s->len);
  r->hdr->tail += 1;
  sem_post(&r->hdr->spaces);
  return len;
}

void shm_ring_close(void* ring, int unlink_it) {
  Ring* r = static_cast<Ring*>(ring);
  munmap(r->base, r->map_len);
  if (unlink_it) shm_unlink(r->name);
  delete r;
}

}  // extern "C"
