// Native streaming loader for .npy point-cloud archives.
//
// The data-plane native component of the framework: the reference feeds the
// TTA loop through torch DataLoader worker *processes*
// (main_test-time.py:78-85, num_workers=4); here the equivalent is an
// in-process C++ loader — mmap'd .npy archives (zero-copy reads of
// fp32/fp64/int64 tensors) plus a background prefetch thread filling a ring
// of host-side staging buffers so the next batch is resident before the
// accelerator asks for it.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (uni_adapter_torch/native/loader.py).  No pybind11 — the image doesn't
// carry it; the surface is small enough that ctypes is the right tool.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC npy_loader.cpp -o libnpy_loader.so
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct NpyArray {
  int fd = -1;
  void* map = nullptr;
  size_t map_size = 0;
  const char* data = nullptr;     // first element
  std::vector<int64_t> shape;
  size_t itemsize = 0;
  char kind = 'f';                // f, i, u
  bool fortran = false;
};

// Parse the npy v1/v2 header: magic, version, HEADER_LEN, python-dict text.
bool parse_header(const char* buf, size_t len, NpyArray* a,
                  size_t* data_offset) {
  if (len < 10 || std::memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  const uint8_t major = buf[6];
  size_t hlen, hstart;
  if (major == 1) {
    hlen = static_cast<uint8_t>(buf[8]) | (static_cast<uint8_t>(buf[9]) << 8);
    hstart = 10;
  } else {
    uint32_t h;
    std::memcpy(&h, buf + 8, 4);
    hlen = h;
    hstart = 12;
  }
  if (hstart + hlen > len) return false;
  std::string hdr(buf + hstart, hlen);
  *data_offset = hstart + hlen;

  auto find_val = [&](const std::string& key) -> std::string {
    auto p = hdr.find("'" + key + "'");
    if (p == std::string::npos) return "";
    p = hdr.find(':', p);
    auto e = hdr.find_first_of(",}", hdr.find_first_of("([{'\"TF0123456789-",
                                                       p + 1));
    return hdr.substr(p + 1, e - p - 1);
  };

  // descr like '<f4', '<i8'
  auto dp = hdr.find("'descr'");
  if (dp == std::string::npos) return false;
  auto q1 = hdr.find('\'', hdr.find(':', dp));
  auto q2 = hdr.find('\'', q1 + 1);
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  if (descr.size() < 3) return false;
  if (descr[0] == '>') return false;  // big-endian unsupported
  a->kind = descr[1];
  a->itemsize = std::stoul(descr.substr(2));

  a->fortran = hdr.find("'fortran_order': True") != std::string::npos;
  if (a->fortran) return false;       // C-order only

  auto sp = hdr.find("'shape'");
  if (sp == std::string::npos) return false;
  auto o = hdr.find('(', sp);
  auto c = hdr.find(')', o);
  std::string tup = hdr.substr(o + 1, c - o - 1);
  a->shape.clear();
  size_t pos = 0;
  while (pos < tup.size()) {
    while (pos < tup.size() && !isdigit(tup[pos])) pos++;
    if (pos >= tup.size()) break;
    size_t end = pos;
    while (end < tup.size() && isdigit(tup[end])) end++;
    a->shape.push_back(std::stoll(tup.substr(pos, end - pos)));
    pos = end;
  }
  return !a->shape.empty();
}

struct Prefetcher {
  // Ring of staging buffers filled ahead of the consumer in index order.
  NpyArray* arr = nullptr;
  size_t sample_bytes = 0;
  int ring_size = 0;
  std::vector<std::vector<char>> ring;
  std::vector<std::atomic<int64_t>> slot_idx;  // which sample a slot holds
  std::atomic<int64_t> next_load{0};
  std::atomic<int64_t> consumer{0};   // next sample the consumer will ask for
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;

  void run() {
    const int64_t n = arr->shape[0];
    while (!stop.load()) {
      int64_t i = next_load.load();
      // stay at most ring_size ahead of the consumer — otherwise the loader
      // races through the whole archive and wraps the ring over slots the
      // consumer has not read yet (correct via the direct-copy fallback,
      // but with zero actual overlap for everything past the first lap)
      if (i >= n || i >= consumer.load() + ring_size) {
        std::this_thread::sleep_for(std::chrono::milliseconds(1));
        continue;
      }
      int slot = static_cast<int>(i % ring_size);
      // seqlock handshake with ua_prefetch_get: invalidate the slot BEFORE
      // overwriting it, publish the new index only after the copy
      // completes — a concurrent consumer copy observes the invalidation
      // in its re-check and falls back to the direct mmap copy instead of
      // returning torn bytes.
      slot_idx[slot].store(-1);
      std::memcpy(ring[slot].data(), arr->data + i * sample_bytes,
                  sample_bytes);
      slot_idx[slot].store(i);
      next_load.store(i + 1);
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// ---- basic mmap reader ----

void* ua_open(const char* path) {
  auto* a = new NpyArray();
  a->fd = ::open(path, O_RDONLY);
  if (a->fd < 0) { delete a; return nullptr; }
  struct stat st;
  if (fstat(a->fd, &st) != 0) { ::close(a->fd); delete a; return nullptr; }
  a->map_size = st.st_size;
  a->map = mmap(nullptr, a->map_size, PROT_READ, MAP_PRIVATE, a->fd, 0);
  if (a->map == MAP_FAILED) { ::close(a->fd); delete a; return nullptr; }
  madvise(a->map, a->map_size, MADV_SEQUENTIAL);
  size_t off = 0;
  if (!parse_header(static_cast<const char*>(a->map), a->map_size, a, &off)) {
    munmap(a->map, a->map_size);
    ::close(a->fd);
    delete a;
    return nullptr;
  }
  a->data = static_cast<const char*>(a->map) + off;
  return a;
}

int ua_ndim(void* h) {
  return h ? static_cast<int>(static_cast<NpyArray*>(h)->shape.size()) : -1;
}

void ua_shape(void* h, int64_t* out) {
  auto* a = static_cast<NpyArray*>(h);
  for (size_t i = 0; i < a->shape.size(); i++) out[i] = a->shape[i];
}

int ua_itemsize(void* h) {
  return h ? static_cast<int>(static_cast<NpyArray*>(h)->itemsize) : -1;
}

char ua_kind(void* h) {
  return h ? static_cast<NpyArray*>(h)->kind : '?';
}

// Copy sample i (all trailing dims) into out as float32, converting from
// f4/f8/i4/i8 as needed.  Returns elements copied, -1 on error.
int64_t ua_read_f32(void* h, int64_t i, float* out) {
  auto* a = static_cast<NpyArray*>(h);
  if (!a || i < 0 || i >= a->shape[0]) return -1;
  int64_t elems = 1;
  for (size_t d = 1; d < a->shape.size(); d++) elems *= a->shape[d];
  const char* src = a->data + i * elems * a->itemsize;
  if (a->kind == 'f' && a->itemsize == 4) {
    std::memcpy(out, src, elems * 4);
  } else if (a->kind == 'f' && a->itemsize == 8) {
    const double* s = reinterpret_cast<const double*>(src);
    for (int64_t e = 0; e < elems; e++) out[e] = static_cast<float>(s[e]);
  } else if (a->kind == 'i' && a->itemsize == 8) {
    const int64_t* s = reinterpret_cast<const int64_t*>(src);
    for (int64_t e = 0; e < elems; e++) out[e] = static_cast<float>(s[e]);
  } else if (a->kind == 'i' && a->itemsize == 4) {
    const int32_t* s = reinterpret_cast<const int32_t*>(src);
    for (int64_t e = 0; e < elems; e++) out[e] = static_cast<float>(s[e]);
  } else {
    return -1;
  }
  return elems;
}

// Copy sample i as int64 (labels).
int64_t ua_read_i64(void* h, int64_t i, int64_t* out) {
  auto* a = static_cast<NpyArray*>(h);
  if (!a || i < 0 || i >= a->shape[0]) return -1;
  int64_t elems = 1;
  for (size_t d = 1; d < a->shape.size(); d++) elems *= a->shape[d];
  const char* src = a->data + i * elems * a->itemsize;
  if (a->kind == 'i' && a->itemsize == 8) {
    std::memcpy(out, src, elems * 8);
  } else if (a->kind == 'i' && a->itemsize == 4) {
    const int32_t* s = reinterpret_cast<const int32_t*>(src);
    for (int64_t e = 0; e < elems; e++) out[e] = s[e];
  } else if (a->kind == 'f') {
    float tmp;
    const char* p = src;
    for (int64_t e = 0; e < elems; e++, p += a->itemsize) {
      if (a->itemsize == 4) { std::memcpy(&tmp, p, 4); out[e] = (int64_t)tmp; }
      else { double t; std::memcpy(&t, p, 8); out[e] = (int64_t)t; }
    }
  } else {
    return -1;
  }
  return elems;
}

void ua_close(void* h) {
  auto* a = static_cast<NpyArray*>(h);
  if (!a) return;
  if (a->map) munmap(a->map, a->map_size);
  if (a->fd >= 0) ::close(a->fd);
  delete a;
}

// ---- background prefetcher ----

void* ua_prefetch_start(void* h, int ring_size) {
  auto* a = static_cast<NpyArray*>(h);
  if (!a || ring_size < 2) return nullptr;
  auto* p = new Prefetcher();
  p->arr = a;
  int64_t elems = 1;
  for (size_t d = 1; d < a->shape.size(); d++) elems *= a->shape[d];
  p->sample_bytes = elems * a->itemsize;
  p->ring_size = ring_size;
  p->ring.resize(ring_size, std::vector<char>(p->sample_bytes));
  p->slot_idx = std::vector<std::atomic<int64_t>>(ring_size);
  for (auto& s : p->slot_idx) s.store(-1);
  p->worker = std::thread(&Prefetcher::run, p);
  return p;
}

// Blocking fetch of sample i from the ring (falls back to direct copy when
// the prefetcher hasn't reached i yet — still correct, just not overlapped).
int64_t ua_prefetch_get(void* hp, int64_t i, char* out) {
  auto* p = static_cast<Prefetcher*>(hp);
  if (!p || i < 0 || i >= p->arr->shape[0]) return -1;
  int slot = static_cast<int>(i % p->ring_size);
  // Read the slot BEFORE advancing the consumer cursor: the producer only
  // reuses this slot for sample i+ring_size, which its backpressure guard
  // (run(): i >= consumer + ring_size) admits only once consumer > i.
  // The slot_idx re-check after the copy is the seqlock validation — the
  // producer invalidates a slot before overwriting it, so a torn copy
  // cannot observe the same index on both sides of the memcpy.
  bool copied = false;
  if (p->slot_idx[slot].load() == i) {
    std::memcpy(out, p->ring[slot].data(), p->sample_bytes);
    copied = (p->slot_idx[slot].load() == i);
  }
  if (!copied) {
    std::memcpy(out, p->arr->data + i * p->sample_bytes, p->sample_bytes);
  }
  // now advance the cursor so the loader keeps filling ahead of us
  // (monotonic: out-of-order reads behind the cursor stay served by the
  // fallback path above)
  int64_t cur = p->consumer.load();
  while (cur < i + 1 && !p->consumer.compare_exchange_weak(cur, i + 1)) {
  }
  return static_cast<int64_t>(p->sample_bytes);
}

void ua_prefetch_stop(void* hp) {
  auto* p = static_cast<Prefetcher*>(hp);
  if (!p) return;
  p->stop.store(true);
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  // extern "C"
