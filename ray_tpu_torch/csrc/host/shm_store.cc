// shm_store: TPU-host shared-memory object store (reference analog:
// src/ray/object_manager/plasma/ — PlasmaStore store.h:55,
// ObjectLifecycleManager object_lifecycle_manager.h:101, LRU eviction
// eviction_policy.h:105,160, dlmalloc arena dlmalloc.cc).
//
// Design departure from the reference: instead of a store daemon serving a
// UDS protocol, ALL control state (object table, free list, lock, condvar)
// lives inside the shared segment itself, guarded by a robust process-shared
// mutex. Every process (node manager, workers) attaches the segment and
// operates on it directly — zero IPC round-trips on the create/seal/get hot
// path, which matters on TPU hosts where the store feeds host→HBM transfers.
//
// Layout:
//   [Header][ObjectEntry x table_cap][data arena ............]
// Free blocks form an offset-sorted singly linked list (offsets relative to
// arena start) enabling O(n) first-fit alloc with coalescing on free.
// Objects are created (writable), sealed (immutable, readers may map), and
// evicted LRU-wise among sealed refcount==0 entries when allocation fails.

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <utility>
#include <vector>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x7470755f73746f72ULL;  // "tpu_stor"
constexpr uint32_t kIdLen = 20;
constexpr uint64_t kMinBlock = 64;
constexpr uint64_t kAlign = 64;  // cache-line align objects

enum EntryState : uint32_t {
  kEmpty = 0,
  kCreated = 1,   // allocated, writer filling
  kSealed = 2,    // immutable, readable
  kTombstone = 3, // deleted slot (probe chains continue through it)
};

constexpr uint32_t kReaderSlots = 4;

struct ObjectEntry {
  uint32_t state;
  uint32_t _pad;
  uint64_t refcount;
  uint64_t offset;     // relative to arena start
  uint64_t data_size;
  uint64_t meta_size;  // metadata bytes appended after data
  uint64_t lru_tick;
  uint64_t writer_pid;  // creator process; orphan GC is scoped to dead pids
  // Per-pid reader accounting so refs held by crashed readers can be
  // reclaimed (reference: plasma's per-client disconnect cleanup). Refs
  // beyond kReaderSlots distinct pids land in untracked_refs (permanent
  // until released normally).
  uint64_t reader_pids[kReaderSlots];
  uint32_t reader_counts[kReaderSlots];
  uint64_t untracked_refs;
  uint8_t id[kIdLen];
  uint8_t _pad2[4];
};

struct FreeBlock {
  uint64_t size;
  uint64_t next;  // offset of next free block, ~0ull = none
};
constexpr uint64_t kNone = ~0ull;

struct Header {
  uint64_t magic;
  uint64_t segment_size;
  uint64_t arena_offset;   // from segment base
  uint64_t arena_size;
  uint64_t table_cap;
  uint64_t free_head;      // offset into arena, kNone if empty
  uint64_t lru_clock;
  uint64_t num_tombstones;
  // stats
  uint64_t bytes_allocated;
  uint64_t num_objects;
  uint64_t num_evictions;
  uint64_t bytes_evicted;
  pthread_mutex_t mu;
  pthread_cond_t cv;       // signalled on seal/delete (waiters: Get blocking)
};

struct Store {
  int fd;
  uint8_t* base;
  uint64_t size;
  Header* hdr;
  ObjectEntry* table;
  uint8_t* arena;
  char name[256];
  bool owner;
};

uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

uint64_t id_hash(const uint8_t* id) {
  // FNV-1a over the 20-byte id.
  uint64_t h = 14695981039346656037ULL;
  for (uint32_t i = 0; i < kIdLen; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

void lock(Header* h) {
  int rc = pthread_mutex_lock(&h->mu);
  if (rc == EOWNERDEAD) {
    // A process died holding the lock. State may be mid-mutation; we accept
    // the (already-sealed-consistent) table and continue — created-but-
    // unsealed entries of the dead process are garbage-collected by
    // store_evict_orphans from the node manager.
    pthread_mutex_consistent(&h->mu);
  }
}
void unlock(Header* h) { pthread_mutex_unlock(&h->mu); }

// Find entry slot; returns index or table_cap if absent.
uint64_t find(Store* s, const uint8_t* id) {
  Header* h = s->hdr;
  uint64_t cap = h->table_cap;
  uint64_t i = id_hash(id) % cap;
  for (uint64_t probes = 0; probes < cap; probes++, i = (i + 1) % cap) {
    ObjectEntry& e = s->table[i];
    if (e.state == kEmpty) return cap;
    if (e.state != kTombstone && memcmp(e.id, id, kIdLen) == 0) return i;
  }
  return cap;
}

// Find slot for insert (first empty/tombstone), or table_cap if full.
uint64_t find_insert(Store* s, const uint8_t* id) {
  Header* h = s->hdr;
  uint64_t cap = h->table_cap;
  uint64_t i = id_hash(id) % cap;
  uint64_t first_tomb = cap;
  for (uint64_t probes = 0; probes < cap; probes++, i = (i + 1) % cap) {
    ObjectEntry& e = s->table[i];
    if (e.state == kEmpty)
      return first_tomb != cap ? first_tomb : i;
    if (e.state == kTombstone) {
      if (first_tomb == cap) first_tomb = i;
    } else if (memcmp(e.id, id, kIdLen) == 0) {
      return cap;  // already exists
    }
  }
  return first_tomb;
}

FreeBlock* fb(Store* s, uint64_t off) {
  return reinterpret_cast<FreeBlock*>(s->arena + off);
}

// Insert block into offset-sorted free list, coalescing neighbours.
void free_insert(Store* s, uint64_t off, uint64_t size) {
  Header* h = s->hdr;
  uint64_t prev = kNone, cur = h->free_head;
  while (cur != kNone && cur < off) {
    prev = cur;
    cur = fb(s, cur)->next;
  }
  // coalesce with next
  if (cur != kNone && off + size == cur) {
    size += fb(s, cur)->size;
    cur = fb(s, cur)->next;
  }
  // coalesce with prev
  if (prev != kNone && prev + fb(s, prev)->size == off) {
    fb(s, prev)->size += size;
    fb(s, prev)->next = cur;
    return;
  }
  FreeBlock* nb = fb(s, off);
  nb->size = size;
  nb->next = cur;
  if (prev == kNone)
    h->free_head = off;
  else
    fb(s, prev)->next = off;
}

// First-fit allocation; returns offset or kNone.
uint64_t arena_alloc(Store* s, uint64_t size) {
  Header* h = s->hdr;
  size = align_up(size < kMinBlock ? kMinBlock : size, kAlign);
  uint64_t prev = kNone, cur = h->free_head;
  while (cur != kNone) {
    FreeBlock* b = fb(s, cur);
    if (b->size >= size) {
      uint64_t remain = b->size - size;
      uint64_t next = b->next;
      if (remain >= kMinBlock) {
        uint64_t split = cur + size;
        FreeBlock* sb = fb(s, split);
        sb->size = remain;
        sb->next = next;
        next = split;
      } else {
        size = b->size;  // absorb the tail fragment
      }
      if (prev == kNone)
        h->free_head = next;
      else
        fb(s, prev)->next = next;
      h->bytes_allocated += size;
      return cur;
    }
    prev = cur;
    cur = b->next;
  }
  return kNone;
}

void entry_free(Store* s, ObjectEntry& e) {
  uint64_t total = align_up(
      (e.data_size + e.meta_size) < kMinBlock ? kMinBlock
                                              : (e.data_size + e.meta_size),
      kAlign);
  free_insert(s, e.offset, total);
  s->hdr->bytes_allocated -= total;
  e.state = kTombstone;
  s->hdr->num_objects--;
  s->hdr->num_tombstones++;
}

// Once tombstones dominate, probe chains never hit kEmpty and every lookup
// degrades to a full-table scan. Rebuild the table in place: copy live
// entries aside, clear, reinsert. Caller holds the lock.
void maybe_rehash(Store* s) {
  Header* h = s->hdr;
  if (h->num_tombstones < h->table_cap / 4) return;
  std::vector<ObjectEntry> live;
  live.reserve(h->num_objects);
  for (uint64_t i = 0; i < h->table_cap; i++) {
    if (s->table[i].state == kCreated || s->table[i].state == kSealed)
      live.push_back(s->table[i]);
  }
  memset(s->table, 0, h->table_cap * sizeof(ObjectEntry));
  for (ObjectEntry& e : live) {
    uint64_t i = id_hash(e.id) % h->table_cap;
    while (s->table[i].state != kEmpty) i = (i + 1) % h->table_cap;
    s->table[i] = e;
  }
  h->num_tombstones = 0;
}

// Evict LRU sealed refcount-0 objects until `needed` bytes can be allocated.
// Caller holds the lock. Returns true if an eviction happened. One table
// scan collects candidates LRU-first; victims are freed in order until the
// allocation fits (avoids rescanning the table per victim).
bool evict_for(Store* s, uint64_t needed) {
  Header* h = s->hdr;
  std::vector<std::pair<uint64_t, uint64_t>> candidates;  // (tick, idx)
  for (uint64_t i = 0; i < h->table_cap; i++) {
    ObjectEntry& e = s->table[i];
    if (e.state == kSealed && e.refcount == 0)
      candidates.emplace_back(e.lru_tick, i);
  }
  std::sort(candidates.begin(), candidates.end());
  bool any = false;
  for (auto& [tick, idx] : candidates) {
    uint64_t off = arena_alloc(s, needed);
    if (off != kNone) {
      uint64_t size =
          align_up(needed < kMinBlock ? kMinBlock : needed, kAlign);
      free_insert(s, off, size);
      h->bytes_allocated -= size;
      return true;
    }
    ObjectEntry& e = s->table[idx];
    h->num_evictions++;
    h->bytes_evicted += e.data_size + e.meta_size;
    entry_free(s, e);
    any = true;
  }
  return any;
}

// Attribute one reference to `pid` in the entry's reader slots. An existing
// slot for this pid ALWAYS wins over an earlier empty slot — otherwise one
// pid can end up spread across two slots (or share a slot with its own
// pin), which breaks every "sum of this pid's refs" consumer
// (store_spill_candidates' pinned test, release_pid cleanup).
bool track_reader(ObjectEntry& e, uint64_t pid) {
  int empty = -1;
  for (uint32_t k = 0; k < kReaderSlots; k++) {
    if (e.reader_pids[k] == pid) {
      e.reader_counts[k]++;
      return true;
    }
    if (empty < 0 && e.reader_pids[k] == 0 && e.reader_counts[k] == 0)
      empty = (int)k;
  }
  if (empty >= 0) {
    e.reader_pids[empty] = pid;
    e.reader_counts[empty] = 1;
    return true;
  }
  return false;
}

// Bump a sealed entry's refcount for `pid` and touch its LRU tick — the
// shared hit core of store_get and store_get_many (caller holds the lock).
void acquire_locked(Header* h, ObjectEntry& e, uint64_t pid) {
  e.refcount++;
  if (!track_reader(e, pid)) e.untracked_refs++;
  e.lru_tick = ++h->lru_clock;
}

// Drop one of `pid`'s references — the shared core of store_release and
// store_release_many (caller holds the lock).
void release_locked(ObjectEntry& e, uint64_t pid) {
  if (e.refcount > 0) e.refcount--;
  bool tracked = false;
  for (uint32_t k = 0; k < kReaderSlots; k++) {
    if (e.reader_pids[k] == pid && e.reader_counts[k] > 0) {
      if (--e.reader_counts[k] == 0) e.reader_pids[k] = 0;
      tracked = true;
      break;
    }
  }
  if (!tracked && e.untracked_refs > 0) e.untracked_refs--;
}

}  // namespace

extern "C" {

// Status codes (keep in sync with ray_tpu/_private/shm_store.py).
enum {
  TS_OK = 0,
  TS_ERR = -1,
  TS_EXISTS = -2,
  TS_NOT_FOUND = -3,
  TS_OOM = -4,
  TS_TABLE_FULL = -5,
  TS_NOT_SEALED = -6,
  TS_TIMEOUT = -7,
};

void* store_create(const char* name, uint64_t capacity, uint64_t table_cap) {
  if (table_cap == 0) table_cap = 1 << 16;
  if (capacity < (1 << 12)) return nullptr;  // degenerate arena
  shm_unlink(name);  // fresh segment
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t table_bytes = table_cap * sizeof(ObjectEntry);
  uint64_t arena_off = align_up(sizeof(Header) + table_bytes, kAlign);
  uint64_t total = arena_off + capacity;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  uint8_t* base = (uint8_t*)mmap(nullptr, total, PROT_READ | PROT_WRITE,
                                 MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  // Write-touch every page NOW: tmpfs allocates pages on the first
  // WRITE fault, so without this a cold large put runs fault-bound
  // (~1.9 GB/s measured for a fresh 64 MiB object vs ~6.7 GB/s on
  // materialized pages). One memset per store boot (~0.2 s/GiB) buys
  // warm-page bandwidth for every subsequent create/put; attaching
  // processes only take cheap minor faults on the existing pages.
  // (MAP_POPULATE is not enough: it read-faults tmpfs holes without
  // allocating backing pages for writes.)
  memset(base, 0, total);
  Header* h = (Header*)base;
  memset(h, 0, sizeof(Header));
  h->segment_size = total;
  h->arena_offset = arena_off;
  h->arena_size = capacity;
  h->table_cap = table_cap;
  memset(base + sizeof(Header), 0, table_bytes);

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_condattr_setclock(&ca, CLOCK_MONOTONIC);
  pthread_cond_init(&h->cv, &ca);

  Store* s = new Store();
  s->fd = fd;
  s->base = base;
  s->size = total;
  s->hdr = h;
  s->table = (ObjectEntry*)(base + sizeof(Header));
  s->arena = base + arena_off;
  snprintf(s->name, sizeof(s->name), "%s", name);
  s->owner = true;
  // one big free block
  h->free_head = 0;
  FreeBlock* b = fb(s, 0);
  b->size = capacity;
  b->next = kNone;
  h->magic = kMagic;  // publish last
  return s;
}

void* store_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  // MAP_POPULATE on attach: the creator materialized every page (see
  // create's memset); prefaulting this process's PTEs up front turns
  // per-page minor faults on first access — the residual large-put
  // cost for attached writers — into one bulk populate at attach time.
  int attach_flags = MAP_SHARED;
#ifdef MAP_POPULATE
  attach_flags |= MAP_POPULATE;
#endif
  uint8_t* base = (uint8_t*)mmap(nullptr, (size_t)st.st_size,
                                 PROT_READ | PROT_WRITE, attach_flags,
                                 fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Header* h = (Header*)base;
  if (h->magic != kMagic) {
    munmap(base, (size_t)st.st_size);
    close(fd);
    return nullptr;
  }
  Store* s = new Store();
  s->fd = fd;
  s->base = base;
  s->size = (uint64_t)st.st_size;
  s->hdr = h;
  s->table = (ObjectEntry*)(base + sizeof(Header));
  s->arena = base + h->arena_offset;
  snprintf(s->name, sizeof(s->name), "%s", name);
  s->owner = false;
  return s;
}

void store_close(void* sp) {
  Store* s = (Store*)sp;
  munmap(s->base, s->size);
  close(s->fd);
  if (s->owner) shm_unlink(s->name);
  delete s;
}

uint8_t* store_base(void* sp) { return ((Store*)sp)->arena; }
uint64_t store_capacity(void* sp) { return ((Store*)sp)->hdr->arena_size; }

// Allocate an object; on success writes offset (relative to arena base).
int store_create_object(void* sp, const uint8_t* id, uint64_t data_size,
                        uint64_t meta_size, uint64_t* offset_out) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  uint64_t total = data_size + meta_size;
  if (total > h->arena_size) return TS_OOM;
  lock(h);
  maybe_rehash(s);
  if (find(s, id) != h->table_cap) {
    unlock(h);
    return TS_EXISTS;
  }
  uint64_t slot = find_insert(s, id);
  if (slot == h->table_cap) {
    unlock(h);
    return TS_TABLE_FULL;
  }
  uint64_t off = arena_alloc(s, total);
  if (off == kNone) {
    if (!evict_for(s, total)) {
      unlock(h);
      return TS_OOM;
    }
    off = arena_alloc(s, total);
    if (off == kNone) {
      unlock(h);
      return TS_OOM;
    }
    // eviction may have tombstoned earlier probes; re-find slot
    slot = find_insert(s, id);
    if (slot == h->table_cap) {
      unlock(h);
      return TS_TABLE_FULL;
    }
  }
  ObjectEntry& e = s->table[slot];
  memset(&e, 0, sizeof(e));
  memcpy(e.id, id, kIdLen);
  e.state = kCreated;
  e.refcount = 1;  // writer holds a ref until seal+release
  e.offset = off;
  e.data_size = data_size;
  e.meta_size = meta_size;
  e.lru_tick = ++h->lru_clock;
  e.writer_pid = (uint64_t)getpid();
  h->num_objects++;
  unlock(h);
  *offset_out = off;
  return TS_OK;
}

int store_seal(void* sp, const uint8_t* id) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  lock(h);
  uint64_t i = find(s, id);
  if (i == h->table_cap) {
    unlock(h);
    return TS_NOT_FOUND;
  }
  ObjectEntry& e = s->table[i];
  if (e.state != kCreated) {
    unlock(h);
    return TS_ERR;
  }
  e.state = kSealed;
  if (e.refcount > 0) e.refcount--;  // drop writer ref
  pthread_cond_broadcast(&h->cv);
  unlock(h);
  return TS_OK;
}

// Seal WITHOUT dropping to refcount 0: the writer's ref converts into a
// tracked reader ref, so there is NO window in which the freshly sealed
// object is evictable before the node manager pins it (the writer releases
// its hold after reporting the object). The hold is attributed to the
// writer's pid in the reader slots so crash cleanup (store_release_pid)
// reclaims it.
int store_seal_hold(void* sp, const uint8_t* id) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  lock(h);
  uint64_t i = find(s, id);
  if (i == h->table_cap) {
    unlock(h);
    return TS_NOT_FOUND;
  }
  ObjectEntry& e = s->table[i];
  if (e.state != kCreated) {
    unlock(h);
    return TS_ERR;
  }
  e.state = kSealed;
  // keep refcount as-is (writer ref becomes the hold); attribute it
  if (!track_reader(e, (uint64_t)getpid())) e.untracked_refs++;
  pthread_cond_broadcast(&h->cv);
  unlock(h);
  return TS_OK;
}

// Get a sealed object: bumps refcount, returns offset/sizes.
// timeout_ms < 0: non-blocking. timeout_ms >= 0 waits for seal.
int store_get(void* sp, const uint8_t* id, int64_t timeout_ms,
              uint64_t* offset_out, uint64_t* data_size_out,
              uint64_t* meta_size_out) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  struct timespec deadline;
  if (timeout_ms >= 0) {
    clock_gettime(CLOCK_MONOTONIC, &deadline);
    deadline.tv_sec += timeout_ms / 1000;
    deadline.tv_nsec += (timeout_ms % 1000) * 1000000L;
    if (deadline.tv_nsec >= 1000000000L) {
      deadline.tv_sec += 1;
      deadline.tv_nsec -= 1000000000L;
    }
  }
  lock(h);
  for (;;) {
    uint64_t i = find(s, id);
    if (i != h->table_cap && s->table[i].state == kSealed) {
      ObjectEntry& e = s->table[i];
      // records this reader's pid so a crash can be cleaned up
      acquire_locked(h, e, (uint64_t)getpid());
      *offset_out = e.offset;
      *data_size_out = e.data_size;
      *meta_size_out = e.meta_size;
      unlock(h);
      return TS_OK;
    }
    if (timeout_ms < 0) {
      unlock(h);
      return TS_NOT_FOUND;
    }
    int rc = pthread_cond_timedwait(&h->cv, &h->mu, &deadline);
    if (rc == ETIMEDOUT) {
      unlock(h);
      return TS_TIMEOUT;
    }
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&h->mu);
  }
}

int store_release(void* sp, const uint8_t* id) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  lock(h);
  uint64_t i = find(s, id);
  if (i == h->table_cap) {
    unlock(h);
    return TS_NOT_FOUND;
  }
  release_locked(s->table[i], (uint64_t)getpid());
  unlock(h);
  return TS_OK;
}

// Drop all refs held by a (dead) process on every entry. The raylet calls
// this when a worker dies, so crashed readers cannot pin objects forever
// (reference: plasma per-client disconnect cleanup).
int store_release_pid(void* sp, uint64_t pid) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  lock(h);
  int n = 0;
  for (uint64_t i = 0; i < h->table_cap; i++) {
    ObjectEntry& e = s->table[i];
    if (e.state != kCreated && e.state != kSealed) continue;
    for (uint32_t k = 0; k < kReaderSlots; k++) {
      if (e.reader_pids[k] == pid && e.reader_counts[k] > 0) {
        uint64_t drop = e.reader_counts[k];
        e.refcount = e.refcount >= drop ? e.refcount - drop : 0;
        e.reader_counts[k] = 0;
        e.reader_pids[k] = 0;
        n += (int)drop;
      }
    }
  }
  unlock(h);
  return n;
}

// Abort a CREATED (unsealed) entry owned by the calling writer — the
// cleanup path for a failed chunked pull/write. Refuses sealed entries
// and other writers' allocations.
int store_abort(void* sp, const uint8_t* id) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  lock(h);
  uint64_t i = find(s, id);
  if (i == h->table_cap) {
    unlock(h);
    return TS_NOT_FOUND;
  }
  ObjectEntry& e = s->table[i];
  if (e.state != kCreated || e.writer_pid != (uint64_t)getpid()) {
    unlock(h);
    return TS_ERR;
  }
  entry_free(s, e);
  pthread_cond_broadcast(&h->cv);
  unlock(h);
  return TS_OK;
}

int store_delete(void* sp, const uint8_t* id) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  lock(h);
  uint64_t i = find(s, id);
  if (i == h->table_cap) {
    unlock(h);
    return TS_NOT_FOUND;
  }
  ObjectEntry& e = s->table[i];
  if (e.refcount > 0) {
    unlock(h);
    return TS_ERR;  // still referenced
  }
  entry_free(s, e);
  pthread_cond_broadcast(&h->cv);
  unlock(h);
  return TS_OK;
}

int store_contains(void* sp, const uint8_t* id) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  lock(h);
  uint64_t i = find(s, id);
  int sealed = (i != h->table_cap && s->table[i].state == kSealed) ? 1 : 0;
  unlock(h);
  return sealed;
}

// Batched non-blocking get: ONE lock acquisition resolves n ids (the
// driver's hot get([...]) path — per-object store_get/_release/_contains
// round trips dominate a 1 KiB get). ids = n*kIdLen key bytes; per-id
// results in offs/dszs/rcs (TS_OK or TS_NOT_FOUND). A hit bumps
// refcount + reader tracking exactly like store_get.
int store_get_many(void* sp, const uint8_t* ids, int n,
                   uint64_t* offs, uint64_t* dszs, int* rcs) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  uint64_t pid = (uint64_t)getpid();
  lock(h);
  for (int k = 0; k < n; k++) {
    uint64_t i = find(s, ids + (uint64_t)k * kIdLen);
    if (i == h->table_cap || s->table[i].state != kSealed) {
      rcs[k] = TS_NOT_FOUND;
      continue;
    }
    ObjectEntry& e = s->table[i];
    acquire_locked(h, e, pid);
    offs[k] = e.offset;
    dszs[k] = e.data_size;
    rcs[k] = TS_OK;
  }
  unlock(h);
  return TS_OK;
}

// Symmetric batched release for store_get_many hits.
int store_release_many(void* sp, const uint8_t* ids, int n) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  uint64_t pid = (uint64_t)getpid();
  lock(h);
  for (int k = 0; k < n; k++) {
    uint64_t i = find(s, ids + (uint64_t)k * kIdLen);
    if (i == h->table_cap) continue;
    release_locked(s->table[i], pid);
  }
  unlock(h);
  return TS_OK;
}

// Drop created-but-never-sealed entries of crashed writers. pid == 0 means
// "any writer" (store-owner cleanup); otherwise only entries created by
// that (now dead) pid are reclaimed, so live writers mid-put are safe.
int store_evict_orphans(void* sp, uint64_t pid) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  lock(h);
  int n = 0;
  for (uint64_t i = 0; i < h->table_cap; i++) {
    ObjectEntry& e = s->table[i];
    if (e.state == kCreated && (pid == 0 || e.writer_pid == pid)) {
      e.refcount = 0;
      entry_free(s, e);
      n++;
    }
  }
  pthread_cond_broadcast(&h->cv);
  unlock(h);
  return n;
}

// Collect LRU spill candidates, oldest-first, until their total payload
// bytes reach `target_bytes` or `max_out` ids are written. A sealed entry
// qualifies when its only refs are the node manager's pin (pin_pid != 0:
// refcount equals the refs held by pin_pid; pin_pid == 0: refcount == 0).
// Writes 20-byte ids consecutively into out_ids (caller provides
// max_out*20 bytes) and returns the count. The entries are NOT freed —
// the node manager copies them to external storage first, then unpins and
// calls store_delete (reference: LocalObjectManager::SpillObjects picks
// pinned-but-unused victims from plasma and deletes after the spill IO
// completes, local_object_manager.h:110).
int store_spill_candidates(void* sp, uint64_t target_bytes, uint8_t* out_ids,
                           uint64_t max_out, uint64_t pin_pid) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  lock(h);
  std::vector<std::pair<uint64_t, uint64_t>> candidates;  // (tick, idx)
  for (uint64_t i = 0; i < h->table_cap; i++) {
    ObjectEntry& e = s->table[i];
    if (e.state != kSealed) continue;
    uint64_t pinned = 0;
    if (pin_pid != 0) {
      // SUM over every slot with this pid: historic slot-scan bugs could
      // split one pid across slots, and a single-slot read then both
      // skips legitimately pinned-idle victims and can pick an object
      // the pinner is concurrently reading
      for (uint32_t k = 0; k < kReaderSlots; k++)
        if (e.reader_pids[k] == pin_pid) pinned += e.reader_counts[k];
      if (pinned == 0 || e.refcount != pinned) continue;
    } else if (e.refcount != 0) {
      continue;
    }
    candidates.emplace_back(e.lru_tick, i);
  }
  std::sort(candidates.begin(), candidates.end());
  uint64_t n = 0, bytes = 0;
  for (auto& [tick, idx] : candidates) {
    if (n >= max_out || bytes >= target_bytes) break;
    ObjectEntry& e = s->table[idx];
    memcpy(out_ids + n * kIdLen, e.id, kIdLen);
    bytes += e.data_size + e.meta_size;
    n++;
  }
  unlock(h);
  return (int)n;
}

void store_stats(void* sp, uint64_t* out6) {
  Store* s = (Store*)sp;
  Header* h = s->hdr;
  lock(h);
  out6[0] = h->arena_size;
  out6[1] = h->bytes_allocated;
  out6[2] = h->num_objects;
  out6[3] = h->num_evictions;
  out6[4] = h->bytes_evicted;
  out6[5] = h->lru_clock;
  unlock(h);
}

}  // extern "C"
