// Native IO runtime of the PyTorch port: threaded, prefetching,
// shard-sliced record reader (a copy of the JAX package's
// csrc/epl_tpu_io.cc, built at first use by io/dataloader.py with the
// host C++ compiler).
//
// This library implements:
//
//   * a length-prefixed binary record format (uint64 LE length + payload),
//   * a reader that assigns files to data-parallel shards,
//   * a configurable thread pool that reads ahead into a bounded queue,
//     preserving a deterministic round-robin order across reader threads,
//   * a writer used by tests and dataset preparation.
//
// Exposed as a plain C ABI consumed via ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Record {
  std::string data;
  bool eof = false;
};

// Bounded blocking queue holding prefetched records.
class BoundedQueue {
 public:
  explicit BoundedQueue(size_t cap) : cap_(cap) {}

  void push(Record r) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return;
    q_.push_back(std::move(r));
    not_empty_.notify_one();
  }

  bool pop(Record* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || closed_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    not_full_.notify_one();
    return true;
  }

  void close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

 private:
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::deque<Record> q_;
  size_t cap_;
  bool closed_ = false;
};

// Largest plausible record: guards against interpreting a non-record
// file's first bytes as a multi-exabyte length (which would throw
// bad_alloc on a worker thread and std::terminate the process).
constexpr uint64_t kMaxRecordBytes = 1ull << 33;  // 8 GB

// Reads ONE length-prefixed record. 1 = ok, 0 = clean EOF, -1 = error.
int read_one_record(FILE* f, std::string* out) {
  uint64_t len_le = 0;
  size_t n = std::fread(&len_le, 1, sizeof(len_le), f);
  if (n == 0) return 0;
  if (n != sizeof(len_le)) return -1;
  if (len_le > kMaxRecordBytes) return -1;  // corrupt / not a record file
  out->assign(len_le, '\0');
  if (len_le && std::fread(&(*out)[0], 1, len_le, f) != len_le) return -1;
  return 1;
}

class Reader {
 public:
  Reader(std::vector<std::string> files, int num_threads, size_t prefetch,
         uint64_t skip_records = 0)
      : files_(std::move(files)),
        queue_(prefetch == 0 ? 1 : prefetch),
        num_threads_(num_threads < 1 ? 1 : num_threads),
        skip_(skip_records) {
    // Per-file staging queues: workers STREAM records into them (one
    // record in flight per read call), so resident memory is bounded by
    // queue capacities — never by file size.  Total bound:
    // prefetch + num_files * per_file_cap records.
    size_t workers = std::min<size_t>(num_threads_,
                                      files_.empty() ? 1 : files_.size());
    size_t cap = (prefetch == 0 ? 1 : prefetch) / workers;
    per_file_cap_ = cap < 4 ? 4 : cap;
    file_queues_.reserve(files_.size());
    for (size_t i = 0; i < files_.size(); ++i) {
      file_queues_.emplace_back(new BoundedQueue(per_file_cap_));
    }
    producer_ = std::thread([this] { produce(); });
  }

  ~Reader() {
    stop_.store(true);
    // Pair the notify with the lock so a worker can't check stop_ just
    // before the store and then sleep through the wakeup.
    { std::lock_guard<std::mutex> lk(pos_mu_); }
    pos_cv_.notify_all();
    for (auto& q : file_queues_) q->close();
    queue_.close();
    if (producer_.joinable()) producer_.join();
  }

  // Returns record size, -1 on EOF, -2 if cap too small (record stays
  // pending and is returned by the next call with a big enough buffer).
  int64_t next(char* buf, int64_t cap) {
    if (!pending_.data.empty() || pending_valid_) {
      if (static_cast<int64_t>(pending_.data.size()) > cap) return -2;
      std::memcpy(buf, pending_.data.data(), pending_.data.size());
      int64_t n = static_cast<int64_t>(pending_.data.size());
      pending_ = Record();
      pending_valid_ = false;
      return n;
    }
    Record r;
    if (!queue_.pop(&r) || r.eof) return -1;
    if (static_cast<int64_t>(r.data.size()) > cap) {
      pending_ = std::move(r);
      pending_valid_ = true;
      return -2;
    }
    std::memcpy(buf, r.data.data(), r.data.size());
    return static_cast<int64_t>(r.data.size());
  }

  int64_t pending_size() const {
    return pending_valid_ ? static_cast<int64_t>(pending_.data.size()) : -1;
  }

 private:
  // Files are read by a pool of worker threads (one file at a time per
  // worker) but records are emitted in deterministic file order: each
  // worker STREAMS its file's records into that file's bounded staging
  // queue (blocking when full); the producer walks files in order and
  // forwards records into the main bounded queue.  No whole-file
  // buffering anywhere.
  void produce() {
    size_t n = files_.size();
    std::atomic<size_t> next_file{0};

    size_t workers_n = std::min<size_t>(num_threads_, n ? n : 1);
    auto worker = [&, workers_n] {
      for (;;) {
        size_t i = next_file.fetch_add(1);
        if (i >= n || stop_.load()) return;
        // Stay within a bounded window of the in-order producer cursor;
        // otherwise many-small-file datasets would be staged wholesale
        // (memory O(num_files * per_file_cap)) while the producer is
        // still on file 0.  Condvar wait: blocked workers sleep until
        // the cursor actually advances instead of burning CPU polling.
        {
          std::unique_lock<std::mutex> lk(pos_mu_);
          pos_cv_.wait(lk, [&] {
            return i < producer_pos_.load() + workers_n || stop_.load();
          });
        }
        if (stop_.load()) return;
        FILE* f = std::fopen(files_[i].c_str(), "rb");
        if (f) {
          for (;;) {
            if (stop_.load()) { std::fclose(f); return; }
            Record rec;
            int rc = read_one_record(f, &rec.data);
            if (rc != 1) break;           // EOF or malformed tail
            file_queues_[i]->push(std::move(rec));
          }
          std::fclose(f);
        }
        Record eof;
        eof.eof = true;
        file_queues_[i]->push(std::move(eof));
      }
    };
    std::vector<std::thread> pool;
    pool.reserve(workers_n);
    for (size_t t = 0; t < workers_n; ++t) pool.emplace_back(worker);

    for (size_t i = 0; i < n && !stop_.load(); ++i) {
      {
        std::lock_guard<std::mutex> lk(pos_mu_);
        producer_pos_.store(i);
      }
      pos_cv_.notify_all();
      for (;;) {
        Record r;
        if (!file_queues_[i]->pop(&r) || r.eof) break;
        // Resume support: drop the first `skip_` records of the
        // deterministic stream (file order is fixed, so record index is
        // a stable stream position across runs).
        if (skip_ > 0) {
          --skip_;
          continue;
        }
        queue_.push(std::move(r));
      }
    }
    Record eof;
    eof.eof = true;
    queue_.push(std::move(eof));
    for (auto& t : pool) t.join();
  }

  std::vector<std::string> files_;
  BoundedQueue queue_;
  int num_threads_;
  size_t per_file_cap_ = 4;
  std::vector<std::unique_ptr<BoundedQueue>> file_queues_;
  std::thread producer_;
  std::atomic<size_t> producer_pos_{0};
  std::mutex pos_mu_;
  std::condition_variable pos_cv_;
  std::atomic<bool> stop_{false};
  uint64_t skip_ = 0;
  Record pending_;
  bool pending_valid_ = false;
};

struct Writer {
  FILE* f = nullptr;
};

}  // namespace

extern "C" {

// Like epl_reader_create, but the stream starts `skip_records` records
// into this shard (checkpoint/resume of the input position).  Separate
// symbol so a stale prebuilt library keeps working with older bindings.
void* epl_reader_create_at(const char** files, int num_files,
                           int shard_index, int num_shards,
                           int num_threads, int prefetch_records,
                           int64_t skip_records) {
  if (num_shards < 1) num_shards = 1;
  std::vector<std::string> mine;
  // Contiguous round-robin file→shard assignment (the reference slices
  // files across replicas the same way, graph_editor.py:787-854).
  for (int i = 0; i < num_files; ++i) {
    if (i % num_shards == shard_index) mine.emplace_back(files[i]);
  }
  return new Reader(std::move(mine), num_threads,
                    static_cast<size_t>(prefetch_records > 0
                                        ? prefetch_records : 256),
                    skip_records > 0
                        ? static_cast<uint64_t>(skip_records) : 0);
}

void* epl_reader_create(const char** files, int num_files,
                        int shard_index, int num_shards,
                        int num_threads, int prefetch_records) {
  return epl_reader_create_at(files, num_files, shard_index, num_shards,
                              num_threads, prefetch_records, 0);
}

int64_t epl_reader_next(void* reader, char* buf, int64_t cap) {
  return static_cast<Reader*>(reader)->next(buf, cap);
}

int64_t epl_reader_pending_size(void* reader) {
  return static_cast<Reader*>(reader)->pending_size();
}

void epl_reader_destroy(void* reader) {
  delete static_cast<Reader*>(reader);
}

void* epl_writer_create(const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  return w;
}

int epl_writer_write(void* writer, const char* buf, int64_t len) {
  auto* w = static_cast<Writer*>(writer);
  uint64_t len_le = static_cast<uint64_t>(len);
  if (std::fwrite(&len_le, 1, sizeof(len_le), w->f) != sizeof(len_le))
    return -1;
  if (len && std::fwrite(buf, 1, len, w->f) != static_cast<size_t>(len))
    return -1;
  return 0;
}

void epl_writer_close(void* writer) {
  auto* w = static_cast<Writer*>(writer);
  if (w->f) std::fclose(w->f);
  delete w;
}

}  // extern "C"
