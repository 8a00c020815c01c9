// paddle_tpu_torch host runtime: recordio chunk IO, bounded channels,
// prefetching record readers, an aligned staging arena and the threaded
// batch gather. It is the JAX package's host runtime, kept symbol for
// symbol and byte for byte in what it writes, so that either package
// reads the other's files; runtime/recordio.py binds it with ctypes and
// runtime/build.py compiles it with g++ on first use.
//
// Reference counterparts:
//   paddle/fluid/recordio/{header,chunk,writer,scanner}.{h,cc} — chunked
//     record file format with per-chunk checksum + compression.
//   paddle/fluid/framework/channel.h — bounded blocking channel backing
//     the double-buffer/py_reader ops.
//   paddle/fluid/memory/ (buddy allocator) — device memory is the CUDA
//     caching allocator's here, so the native allocator's remaining job is
//     the HOST staging arena that batches are assembled into (aligned
//     pages).
//
// Its job is keeping the HOST side (disk -> decode -> batch assembly)
// ahead of the device step, off the Python GIL.
//
// Chunk format (little-endian):
//   magic   u32 = 0x50445452 ("RTDP")
//   comp    u32   0=raw, 1=zlib-deflate
//   nrec    u32   number of records in chunk
//   rawlen  u64   decompressed payload bytes
//   complen u64   stored payload bytes
//   crc     u32   crc32 (zlib polynomial) of the STORED payload
//   payload: repeated { u32 reclen | bytes }
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

static const uint32_t kMagic = 0x50445452u;

// ---------------------------------------------------------------------------
// bounded blocking channel of byte buffers (framework/channel.h equivalent)
// ---------------------------------------------------------------------------

struct Buf {
  char* data;
  int64_t len;
};

struct Channel {
  std::deque<Buf> q;
  size_t capacity;
  bool closed = false;
  std::mutex mu;
  std::condition_variable not_full, not_empty;
};

void* ptrt_chan_create(int64_t capacity) {
  Channel* c = new Channel();
  c->capacity = capacity > 0 ? (size_t)capacity : 1;
  return c;
}

// blocks while full; returns 0 ok, -1 when channel closed
int ptrt_chan_send(void* ch, const char* data, int64_t len) {
  Channel* c = (Channel*)ch;
  std::unique_lock<std::mutex> lk(c->mu);
  c->not_full.wait(lk, [c] { return c->q.size() < c->capacity || c->closed; });
  if (c->closed) return -1;
  char* copy = (char*)malloc(len > 0 ? len : 1);
  memcpy(copy, data, len);
  c->q.push_back({copy, len});
  c->not_empty.notify_one();
  return 0;
}

// blocks while empty; returns record length (>=0) with *out owning malloc'd
// bytes (free with ptrt_free), or -1 when closed AND drained
int64_t ptrt_chan_recv(void* ch, char** out) {
  Channel* c = (Channel*)ch;
  std::unique_lock<std::mutex> lk(c->mu);
  c->not_empty.wait(lk, [c] { return !c->q.empty() || c->closed; });
  if (c->q.empty()) return -1;
  Buf b = c->q.front();
  c->q.pop_front();
  c->not_full.notify_one();
  *out = b.data;
  return b.len;
}

// batch pull for the predictor serving loop (reference: the C++
// NativePredictor's request loop, api/api_impl.cc): blocks for the FIRST
// record, then drains whatever else is queued up to max_n without
// waiting — dynamic batching. Returns the number of records (0 when the
// channel is closed and drained); outs[i] own malloc'd bytes
// (ptrt_free), lens[i] their lengths.
int64_t ptrt_chan_recv_batch(void* ch, int64_t max_n, char** outs,
                             int64_t* lens) {
  Channel* c = (Channel*)ch;
  std::unique_lock<std::mutex> lk(c->mu);
  c->not_empty.wait(lk, [c] { return !c->q.empty() || c->closed; });
  int64_t n = 0;
  while (n < max_n && !c->q.empty()) {
    Buf b = c->q.front();
    c->q.pop_front();
    outs[n] = b.data;
    lens[n] = b.len;
    ++n;
  }
  if (n > 0) c->not_full.notify_all();
  return n;
}

int64_t ptrt_chan_size(void* ch) {
  Channel* c = (Channel*)ch;
  std::lock_guard<std::mutex> lk(c->mu);
  return (int64_t)c->q.size();
}

void ptrt_chan_close(void* ch) {
  Channel* c = (Channel*)ch;
  std::lock_guard<std::mutex> lk(c->mu);
  c->closed = true;
  c->not_full.notify_all();
  c->not_empty.notify_all();
}

void ptrt_chan_destroy(void* ch) {
  Channel* c = (Channel*)ch;
  for (auto& b : c->q) free(b.data);
  delete c;
}

void ptrt_free(char* p) { free(p); }

// ---------------------------------------------------------------------------
// recordio writer
// ---------------------------------------------------------------------------

struct Writer {
  FILE* f;
  int compressor;  // 0 raw, 1 deflate
  uint32_t max_records;
  std::vector<std::string> pending;
  size_t pending_bytes = 0;
};

static int flush_chunk(Writer* w) {
  if (w->pending.empty()) return 0;
  std::string raw;
  raw.reserve(w->pending_bytes + 4 * w->pending.size());
  for (auto& r : w->pending) {
    uint32_t len = (uint32_t)r.size();
    raw.append((const char*)&len, 4);
    raw.append(r);
  }
  std::string stored;
  if (w->compressor == 1) {
    uLongf bound = compressBound(raw.size());
    stored.resize(bound);
    if (compress2((Bytef*)&stored[0], &bound, (const Bytef*)raw.data(),
                  raw.size(), 6) != Z_OK)
      return -1;
    stored.resize(bound);
  } else {
    stored = raw;
  }
  uint32_t nrec = (uint32_t)w->pending.size();
  uint64_t rawlen = raw.size(), complen = stored.size();
  uint32_t crc = crc32(0L, (const Bytef*)stored.data(), stored.size());
  uint32_t comp = (uint32_t)w->compressor;
  if (fwrite(&kMagic, 4, 1, w->f) != 1 || fwrite(&comp, 4, 1, w->f) != 1 ||
      fwrite(&nrec, 4, 1, w->f) != 1 || fwrite(&rawlen, 8, 1, w->f) != 1 ||
      fwrite(&complen, 8, 1, w->f) != 1 || fwrite(&crc, 4, 1, w->f) != 1 ||
      (complen && fwrite(stored.data(), 1, complen, w->f) != complen))
    return -1;
  w->pending.clear();
  w->pending_bytes = 0;
  return 0;
}

void* ptrt_rio_writer_open(const char* path, int compressor,
                           int max_chunk_records) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer();
  w->f = f;
  w->compressor = compressor;
  w->max_records = max_chunk_records > 0 ? max_chunk_records : 1000;
  return w;
}

int ptrt_rio_writer_write(void* wp, const char* data, int64_t len) {
  Writer* w = (Writer*)wp;
  w->pending.emplace_back(data, (size_t)len);
  w->pending_bytes += len;
  if (w->pending.size() >= w->max_records || w->pending_bytes > (1u << 22))
    return flush_chunk(w);
  return 0;
}

int ptrt_rio_writer_close(void* wp) {
  Writer* w = (Writer*)wp;
  int rc = flush_chunk(w);
  fclose(w->f);
  delete w;
  return rc;
}

// ---------------------------------------------------------------------------
// recordio reader (scanner)
// ---------------------------------------------------------------------------

struct Reader {
  FILE* f;
  std::string chunk;      // decompressed payload of current chunk
  size_t pos = 0;         // cursor into chunk
  uint32_t remaining = 0; // records left in current chunk
  int error = 0;          // sticky: -2 corruption
};

// returns 1 ok, 0 eof, -2 corruption
static int load_chunk(Reader* r) {
  uint32_t magic, comp, nrec, crc;
  uint64_t rawlen, complen;
  size_t n = fread(&magic, 4, 1, r->f);
  if (n == 0) return 0;  // clean EOF
  if (magic != kMagic) return -2;
  if (fread(&comp, 4, 1, r->f) != 1 || fread(&nrec, 4, 1, r->f) != 1 ||
      fread(&rawlen, 8, 1, r->f) != 1 || fread(&complen, 8, 1, r->f) != 1 ||
      fread(&crc, 4, 1, r->f) != 1)
    return -2;
  if (rawlen > (1ull << 32) || complen > (1ull << 32)) return -2;
  std::string stored(complen, '\0');
  if (complen && fread(&stored[0], 1, complen, r->f) != complen) return -2;
  if (crc32(0L, (const Bytef*)stored.data(), stored.size()) != crc) return -2;
  if (comp == 1) {
    r->chunk.resize(rawlen);
    uLongf outlen = rawlen;
    if (uncompress((Bytef*)&r->chunk[0], &outlen, (const Bytef*)stored.data(),
                   stored.size()) != Z_OK || outlen != rawlen)
      return -2;
  } else if (comp == 0) {
    r->chunk = std::move(stored);
  } else {
    return -2;
  }
  r->pos = 0;
  r->remaining = nrec;
  return 1;
}

void* ptrt_rio_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Reader* r = new Reader();
  r->f = f;
  return r;
}

// returns len>=0 (record in *out, malloc'd, free with ptrt_free),
// -1 EOF, -2 corruption detected
int64_t ptrt_rio_reader_next(void* rp, char** out) {
  Reader* r = (Reader*)rp;
  if (r->error) return r->error;
  while (r->remaining == 0) {
    int rc = load_chunk(r);
    if (rc == 0) return -1;
    if (rc < 0) { r->error = rc; return rc; }
  }
  if (r->pos + 4 > r->chunk.size()) { r->error = -2; return -2; }
  uint32_t len;
  memcpy(&len, r->chunk.data() + r->pos, 4);
  r->pos += 4;
  if (r->pos + len > r->chunk.size()) { r->error = -2; return -2; }
  char* buf = (char*)malloc(len > 0 ? len : 1);
  memcpy(buf, r->chunk.data() + r->pos, len);
  r->pos += len;
  r->remaining--;
  *out = buf;
  return (int64_t)len;
}

void ptrt_rio_reader_close(void* rp) {
  Reader* r = (Reader*)rp;
  fclose(r->f);
  delete r;
}

// ---------------------------------------------------------------------------
// prefetching recordio reader: disk + crc + decompress on a C++ thread
// (double_buffer / py_reader equivalent for file-backed data)
// ---------------------------------------------------------------------------

struct Prefetcher {
  Channel* chan;
  std::thread worker;
  std::atomic<int> status{0};  // 0 running/done, -2 corruption
};

static void prefetch_loop(Prefetcher* p, std::string path) {
  Reader* r = (Reader*)ptrt_rio_reader_open(path.c_str());
  if (!r) {
    p->status = -3;
    ptrt_chan_close(p->chan);
    return;
  }
  char* buf;
  for (;;) {
    int64_t len = ptrt_rio_reader_next(r, &buf);
    if (len == -1) break;
    if (len < 0) { p->status = (int)len; break; }
    int rc = ptrt_chan_send(p->chan, buf, len);
    free(buf);
    if (rc != 0) break;  // consumer closed early
  }
  ptrt_rio_reader_close(r);
  ptrt_chan_close(p->chan);
}

void* ptrt_prefetch_open(const char* path, int64_t capacity) {
  Prefetcher* p = new Prefetcher();
  p->chan = (Channel*)ptrt_chan_create(capacity);
  p->worker = std::thread(prefetch_loop, p, std::string(path));
  return p;
}

int64_t ptrt_prefetch_next(void* pp, char** out) {
  Prefetcher* p = (Prefetcher*)pp;
  int64_t len = ptrt_chan_recv(p->chan, out);
  if (len == -1 && p->status != 0) return p->status;
  return len;
}

void ptrt_prefetch_close(void* pp) {
  Prefetcher* p = (Prefetcher*)pp;
  ptrt_chan_close(p->chan);
  // drain so a blocked sender wakes
  char* buf;
  while (ptrt_chan_recv(p->chan, &buf) >= 0) free(buf);
  if (p->worker.joinable()) p->worker.join();
  ptrt_chan_destroy(p->chan);
  delete p;
}

// ---------------------------------------------------------------------------
// aligned host staging arena (bump allocator, reset per batch)
// ---------------------------------------------------------------------------

struct Arena {
  char* base;
  size_t size;
  std::atomic<size_t> offset{0};
};

void* ptrt_arena_create(int64_t bytes) {
  Arena* a = new Arena();
  a->size = (size_t)bytes;
  a->base = (char*)aligned_alloc(4096, (a->size + 4095) & ~4095ull);
  if (!a->base) { delete a; return nullptr; }
  return a;
}

// returns offset-aligned pointer or null when exhausted
void* ptrt_arena_alloc(void* ap, int64_t bytes, int64_t align) {
  Arena* a = (Arena*)ap;
  if (align <= 0) align = 64;
  size_t cur, start, end;
  do {
    cur = a->offset.load();
    start = (cur + (size_t)align - 1) & ~((size_t)align - 1);
    end = start + (size_t)bytes;
    if (end > a->size) return nullptr;
  } while (!a->offset.compare_exchange_weak(cur, end));
  return a->base + start;
}

void ptrt_arena_reset(void* ap) { ((Arena*)ap)->offset = 0; }

int64_t ptrt_arena_used(void* ap) { return (int64_t)((Arena*)ap)->offset.load(); }

void ptrt_arena_destroy(void* ap) {
  Arena* a = (Arena*)ap;
  free(a->base);
  delete a;
}


// ---------------------------------------------------------------------------
// batch assembly: gather n equal-size sample buffers into one contiguous
// destination (the hot inner loop of reader batching — replaces a
// Python-level per-row copy). Rows are split across threads when the
// payload is large enough to amortize thread startup.
// ---------------------------------------------------------------------------

void ptrt_batch_assemble(const char** srcs, int64_t n, int64_t row_bytes,
                         char* dst) {
  const int64_t total = n * row_bytes;
  const int64_t kParallelThreshold = 1 << 20;  // 1 MiB
  int nthreads = 1;
  if (total >= kParallelThreshold) {
    nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads > 8) nthreads = 8;
    if (nthreads > n) nthreads = (int)n;
    if (nthreads < 1) nthreads = 1;
  }
  if (nthreads == 1) {
    for (int64_t i = 0; i < n; ++i)
      memcpy(dst + i * row_bytes, srcs[i], (size_t)row_bytes);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  const int64_t per = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t lo = t * per;
    const int64_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    ts.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i)
        memcpy(dst + i * row_bytes, srcs[i], (size_t)row_bytes);
    });
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"

