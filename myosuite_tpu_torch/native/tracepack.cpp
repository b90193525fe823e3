// tracepack: native rollout-trace sink for myosuite_tpu_torch (the JAX
// package's sink, the same file format byte for byte).
//
// Role: the reference's rollout logging funnels every datum through h5py
// gzip writes on the Python thread (grouped_datasets.py Trace.save) — at
// batch sizes of 4096 envs x 1000 steps that serializer becomes the
// bottleneck of examine/eval pipelines. This sink moves serialization off
// the Python thread: append() memcpys the buffer into a bounded queue and
// returns; a writer thread streams records to disk. The GIL is released
// for the copy (ctypes releases it around foreign calls).
//
// Format ("MTPK1\0"): a stream of records
//   [u32 name_len][name bytes][u8 dtype_code][u8 ndim]
//   [u64 shape[ndim]][u64 nbytes][payload]
// dtype codes: 0=f32 1=f64 2=i32 3=i64 4=u8 5=i8 6=u16 7=f16
// Readers scan to EOF; a truncated trailing record (crash mid-write) is
// detected by short payload and dropped.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Record {
  std::string name;
  uint8_t dtype;
  std::vector<uint64_t> shape;
  std::vector<uint8_t> payload;
};

struct Sink {
  FILE* f = nullptr;
  std::thread writer;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<Record> queue;
  size_t queued_bytes = 0;
  size_t max_queued_bytes = 256ull << 20;  // 256 MiB backpressure bound
  bool closing = false;
  uint64_t records_written = 0;
  uint64_t bytes_written = 0;

  void run() {
    for (;;) {
      Record rec;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return closing || !queue.empty(); });
        if (queue.empty()) break;  // closing && drained
        rec = std::move(queue.front());
        queue.pop_front();
        queued_bytes -= rec.payload.size();
        cv_pop.notify_all();
      }
      write_record(rec);
    }
    fflush(f);
  }

  void write_record(const Record& rec) {
    uint32_t name_len = static_cast<uint32_t>(rec.name.size());
    uint8_t ndim = static_cast<uint8_t>(rec.shape.size());
    uint64_t nbytes = rec.payload.size();
    fwrite(&name_len, sizeof(name_len), 1, f);
    fwrite(rec.name.data(), 1, name_len, f);
    fwrite(&rec.dtype, 1, 1, f);
    fwrite(&ndim, 1, 1, f);
    fwrite(rec.shape.data(), sizeof(uint64_t), ndim, f);
    fwrite(&nbytes, sizeof(nbytes), 1, f);
    fwrite(rec.payload.data(), 1, nbytes, f);
    records_written++;
    bytes_written += nbytes;
  }
};

}  // namespace

extern "C" {

void* mtp_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  static const char magic[6] = {'M', 'T', 'P', 'K', '1', '\0'};
  fwrite(magic, 1, sizeof(magic), f);
  Sink* s = new Sink();
  s->f = f;
  s->writer = std::thread([s] { s->run(); });
  return s;
}

// Returns 0 on success. Copies `data`; caller may free immediately.
int mtp_append(void* handle, const char* name, uint8_t dtype, int ndim,
               const uint64_t* shape, const void* data, uint64_t nbytes) {
  if (!handle) return -1;
  Sink* s = static_cast<Sink*>(handle);
  Record rec;
  rec.name = name;
  rec.dtype = dtype;
  rec.shape.assign(shape, shape + ndim);
  rec.payload.resize(nbytes);
  std::memcpy(rec.payload.data(), data, nbytes);
  {
    std::unique_lock<std::mutex> lk(s->mu);
    // An oversized record (> max_queued_bytes) is admitted alone once the
    // queue drains — otherwise the bound could never be satisfied and the
    // writer, having drained, would never signal again (deadlock).
    s->cv_pop.wait(lk, [&] {
      return s->closing || s->queue.empty() ||
             s->queued_bytes + nbytes <= s->max_queued_bytes;
    });
    if (s->closing) return -2;
    s->queued_bytes += nbytes;
    s->queue.push_back(std::move(rec));
  }
  s->cv_push.notify_one();
  return 0;
}

// Blocks until the queue drains and the file is closed.
uint64_t mtp_close(void* handle) {
  if (!handle) return 0;
  Sink* s = static_cast<Sink*>(handle);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->closing = true;
  }
  s->cv_push.notify_all();
  s->cv_pop.notify_all();  // release any producer blocked on backpressure
  s->writer.join();
  fclose(s->f);
  uint64_t n = s->records_written;
  delete s;
  return n;
}

uint64_t mtp_queued_bytes(void* handle) {
  Sink* s = static_cast<Sink*>(handle);
  std::lock_guard<std::mutex> lk(s->mu);
  return s->queued_bytes;
}

}  // extern "C"
