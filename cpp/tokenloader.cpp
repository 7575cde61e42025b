// Native prefetching token-batch loader.
//
// The reference feeds training from torchdata's StatefulDataLoader with a
// worker process + pinned memory (llm_pretrain.py:153-159); this is the
// Equivalent here: a C++ library that mmaps the uint16/
// uint32 .bin token shards produced by tokenize_data.py, draws a seeded
// shuffled schedule of (shard, slice) windows, and assembles int32
// (tokens, labels) batches in background threads into a bounded queue so
// host IO overlaps device steps.
//
// State contract (TokenDataset parity, data/text.py:17-54 + the state_dict
// the reference left as a TODO at data/text.py:25): the schedule is a
// deterministic function of (seed, epoch), so (epoch, cursor) fully
// describes the stream position; save/restore is two u64s.
//
// C API (ctypes-friendly):
//   tl_create(dir, seq_len, batch, seed, threads, eval) -> handle
//   tl_next(handle, tokens_out, labels_out) -> 1 ok, 0 end-of-data(eval)
//   tl_state(handle, &epoch, &cursor)
//   tl_restore(handle, epoch, cursor)
//   tl_destroy(handle)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <dirent.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <fstream>

namespace {

struct Shard {
  const uint8_t* data = nullptr;
  size_t bytes = 0;
  size_t n_tokens = 0;
  int fd = -1;
};

struct Window {  // one (shard, slice) sample of seq_len+1 tokens
  uint32_t shard;
  uint64_t offset;  // token offset
};

struct Batch {
  std::vector<int32_t> tokens;
  std::vector<int32_t> labels;
  uint64_t cursor_after;  // schedule position after this batch
  uint64_t epoch_after;
};

class TokenLoader {
 public:
  TokenLoader(const std::string& dir, int64_t seq_len, int64_t batch,
              uint64_t seed, int threads, bool eval)
      : seq_len_(seq_len), batch_(batch), seed_(seed), eval_(eval) {
    load_shards(dir);
    build_windows();
    build_schedule();
    stop_.store(false);
    int n = std::max(1, threads);
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { worker_loop(); });
  }

  ~TokenLoader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_.store(true);
    }
    cv_space_.notify_all();
    cv_data_.notify_all();
    for (auto& t : workers_) t.join();
    for (auto& s : shards_) {
      if (s.data) munmap(const_cast<uint8_t*>(s.data), s.bytes);
      if (s.fd >= 0) close(s.fd);
    }
  }

  // returns 1 on success, 0 on end-of-data (eval mode only)
  int next(int32_t* tokens_out, int32_t* labels_out) {
    std::unique_lock<std::mutex> lk(mu_);
    // deterministic order: wait for the batch that continues the stream
    // (workers may finish out of order)
    cv_data_.wait(lk, [this] {
      return (done_ && queue_.empty()) ||
             (!queue_.empty() && is_next_locked(queue_.front()));
    });
    if (queue_.empty()) return 0;
    Batch b = std::move(queue_.front());
    queue_.pop_front();
    consumed_epoch_ = b.epoch_after;
    consumed_cursor_ = b.cursor_after;
    lk.unlock();
    cv_space_.notify_one();
    std::memcpy(tokens_out, b.tokens.data(), b.tokens.size() * 4);
    std::memcpy(labels_out, b.labels.data(), b.labels.size() * 4);
    return 1;
  }

  void state(uint64_t* epoch, uint64_t* cursor) {
    std::lock_guard<std::mutex> lk(mu_);
    *epoch = consumed_epoch_;
    *cursor = consumed_cursor_;
  }

  void restore(uint64_t epoch, uint64_t cursor) {
    std::lock_guard<std::mutex> lk(mu_);
    queue_.clear();
    gen_ += 1;  // invalidate in-flight batches from before the restore
    epoch_ = epoch;
    cursor_ = cursor;
    consumed_epoch_ = epoch;
    consumed_cursor_ = cursor;
    done_ = false;
    build_schedule_locked();
    cv_space_.notify_all();
  }

 private:
  // is b the batch that directly continues the consumed stream?
  bool is_next_locked(const Batch& b) const {
    return (b.epoch_after == consumed_epoch_ &&
            b.cursor_after == consumed_cursor_ + (uint64_t)batch_) ||
           (b.epoch_after == consumed_epoch_ + 1 &&
            b.cursor_after == (uint64_t)batch_);
  }

  void load_shards(const std::string& dir) {
    // dtype sidecar (tokenize_data.py writes uint16 or uint32)
    token_bytes_ = 2;
    std::ifstream dt(dir + "/dtype.txt");
    if (dt) {
      std::string s;
      dt >> s;
      if (s == "uint32") token_bytes_ = 4;
    }
    std::vector<std::string> names;
    DIR* d = opendir(dir.c_str());
    if (!d) throw std::runtime_error("cannot open " + dir);
    while (dirent* e = readdir(d)) {
      std::string n = e->d_name;
      if (n.size() > 4 && n.substr(n.size() - 4) == ".bin")
        names.push_back(dir + "/" + n);
    }
    closedir(d);
    std::sort(names.begin(), names.end());
    if (names.empty()) throw std::runtime_error("no .bin shards in " + dir);
    for (auto& n : names) {
      Shard s;
      s.fd = open(n.c_str(), O_RDONLY);
      struct stat st;
      fstat(s.fd, &st);
      s.bytes = st.st_size;
      s.n_tokens = s.bytes / token_bytes_;
      s.data = static_cast<const uint8_t*>(
          mmap(nullptr, s.bytes, PROT_READ, MAP_PRIVATE, s.fd, 0));
      madvise(const_cast<uint8_t*>(s.data), s.bytes, MADV_WILLNEED);
      shards_.push_back(s);
    }
  }

  void build_windows() {
    uint64_t window = seq_len_ + 1;
    for (uint32_t si = 0; si < shards_.size(); ++si) {
      uint64_t n = shards_[si].n_tokens / window;
      for (uint64_t i = 0; i < n; ++i)
        windows_.push_back({si, i * window});
    }
  }

  void build_schedule() {
    std::lock_guard<std::mutex> lk(mu_);
    build_schedule_locked();
  }

  void build_schedule_locked() {
    schedule_.resize(windows_.size());
    for (size_t i = 0; i < windows_.size(); ++i) schedule_[i] = i;
    if (!eval_) {
      std::mt19937_64 rng(seed_ ^ (epoch_ * 0x9E3779B97F4A7C15ull));
      std::shuffle(schedule_.begin(), schedule_.end(), rng);
    }
  }

  void decode_window(const Window& w, int32_t* tok, int32_t* lab) {
    const Shard& s = shards_[w.shard];
    if (token_bytes_ == 2) {
      const uint16_t* p =
          reinterpret_cast<const uint16_t*>(s.data) + w.offset;
      for (int64_t i = 0; i < seq_len_; ++i) {
        tok[i] = p[i];
        lab[i] = p[i + 1];
      }
    } else {
      const uint32_t* p =
          reinterpret_cast<const uint32_t*>(s.data) + w.offset;
      for (int64_t i = 0; i < seq_len_; ++i) {
        tok[i] = static_cast<int32_t>(p[i]);
        lab[i] = static_cast<int32_t>(p[i + 1]);
      }
    }
  }

  void worker_loop() {
    const size_t kQueueDepth = 4;
    while (true) {
      uint64_t my_cursor, my_epoch, my_gen;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [this] {
          return stop_.load() || (queue_.size() + in_flight_ < 4 && !done_);
        });
        (void)kQueueDepth;
        if (stop_.load()) return;
        if (cursor_ + batch_ > schedule_.size()) {
          if (eval_) {
            done_ = true;
            cv_data_.notify_all();
            continue;
          }
          epoch_ += 1;
          cursor_ = 0;
          build_schedule_locked();
        }
        my_cursor = cursor_;
        my_epoch = epoch_;
        my_gen = gen_;
        cursor_ += batch_;
        in_flight_ += 1;
      }
      Batch b;
      b.tokens.resize(batch_ * seq_len_);
      b.labels.resize(batch_ * seq_len_);
      for (int64_t i = 0; i < batch_; ++i) {
        const Window& w = windows_[schedule_[my_cursor + i]];
        decode_window(w, b.tokens.data() + i * seq_len_,
                      b.labels.data() + i * seq_len_);
      }
      b.cursor_after = my_cursor + batch_;
      b.epoch_after = my_epoch;
      {
        std::lock_guard<std::mutex> lk(mu_);
        in_flight_ -= 1;
        if (my_gen != gen_) {  // restore() happened; drop stale work
          cv_space_.notify_one();
          continue;
        }
        // keep batches ordered by schedule position for determinism
        auto it = queue_.begin();
        while (it != queue_.end() &&
               (it->epoch_after < b.epoch_after ||
                (it->epoch_after == b.epoch_after &&
                 it->cursor_after < b.cursor_after)))
          ++it;
        queue_.insert(it, std::move(b));
      }
      cv_data_.notify_one();
    }
  }

  int64_t seq_len_, batch_;
  uint64_t seed_;
  bool eval_;
  int token_bytes_ = 2;

  std::vector<Shard> shards_;
  std::vector<Window> windows_;
  std::vector<uint64_t> schedule_;

  std::mutex mu_;
  std::condition_variable cv_data_, cv_space_;
  std::deque<Batch> queue_;
  size_t in_flight_ = 0;
  uint64_t epoch_ = 0, cursor_ = 0, gen_ = 0;
  uint64_t consumed_epoch_ = 0, consumed_cursor_ = 0;
  bool done_ = false;
  std::atomic<bool> stop_{false};
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void* tl_create(const char* dir, int64_t seq_len, int64_t batch,
                uint64_t seed, int threads, int eval) {
  try {
    return new TokenLoader(dir, seq_len, batch, seed, threads, eval != 0);
  } catch (...) {
    return nullptr;
  }
}

int tl_next(void* h, int32_t* tokens, int32_t* labels) {
  return static_cast<TokenLoader*>(h)->next(tokens, labels);
}

void tl_state(void* h, uint64_t* epoch, uint64_t* cursor) {
  static_cast<TokenLoader*>(h)->state(epoch, cursor);
}

void tl_restore(void* h, uint64_t epoch, uint64_t cursor) {
  static_cast<TokenLoader*>(h)->restore(epoch, cursor);
}

void tl_destroy(void* h) { delete static_cast<TokenLoader*>(h); }

}  // extern "C"
