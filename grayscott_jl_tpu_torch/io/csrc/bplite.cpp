// Native BP-lite writer engine.
//
// C++ implementation of the BP-lite on-disk format specified in
// grayscott_jl_tpu/io/bplite.py — the role ADIOS2's C++ BP engines play for
// the reference (GrayScott.jl binds libadios2 via ADIOS2.jl for all
// simulation output, src/simulation/IO.jl). Byte-compatible with the
// Python engine: same md.json schema, same append-only data.<w> payloads,
// same atomic tmp+rename metadata publication, so the Python streaming
// reader (and pdfcalc) can follow either engine live.
//
// What native buys over the Python engine:
//  * an ASYNC step pipeline: put() stages blocks into an in-memory step
//    buffer; end_step() hands the buffer to a background I/O thread that
//    does write+fsync+metadata publication while the simulation computes
//    the next chunk (ADIOS2 deferred-put/aggregator analog);
//  * no GIL on the I/O path.
//
// Exposed as a C ABI for ctypes binding (grayscott_jl_tpu/io/native.py).

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

std::string json_escape(const std::string &s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (unsigned char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\b': out += "\\b"; break;
      case '\f': out += "\\f"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += static_cast<char>(c);
        }
    }
  }
  return out;
}

struct Block {
  std::string var;
  int64_t offset;
  std::vector<int64_t> start;
  std::vector<int64_t> count;
  std::vector<uint8_t> data;  // staged payload (async pipeline)
};

struct Step {
  std::vector<Block> blocks;
};

struct Variable {
  std::string dtype;
  std::vector<int64_t> shape;
};

class Writer {
 public:
  Writer(std::string path, int writer_id, int nwriters, bool append)
      : path_(std::move(path)), writer_id_(writer_id), nwriters_(nwriters) {
    ::mkdir(path_.c_str(), 0755);
    data_name_ = "data." + std::to_string(writer_id_);
    // Multi-writer layout (bplite.py spec): writer 0 owns md.json (and
    // the attribute/variable definitions + writer count); every other
    // writer publishes its private md.<w>.json. No cross-writer
    // coordination — the reader merges.
    md_name_ = writer_id_ == 0
                   ? std::string("md.json")
                   : "md." + std::to_string(writer_id_) + ".json";
    const std::string data_path = path_ + "/" + data_name_;
    // Append mode keeps the existing payload; the Python side re-declares
    // attributes/variables and passes the prior step index via
    // bpw_set_prior_steps_json (metadata is control-plane state).
    const int flags = O_WRONLY | O_CREAT | (append ? O_APPEND : O_TRUNC);
    fd_ = ::open(data_path.c_str(), flags, 0644);
    if (fd_ >= 0) {
      struct stat st;
      offset_ = (append && ::fstat(fd_, &st) == 0) ? st.st_size : 0;
    }
    io_thread_ = std::thread([this] { io_loop(); });
  }

  ~Writer() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
      cv_.notify_all();
    }
    if (io_thread_.joinable()) io_thread_.join();
    if (fd_ >= 0) ::close(fd_);
  }

  bool ok() const { return fd_ >= 0; }

  // Definition calls do NOT publish metadata: publication happens at
  // open (fresh stores), via an explicit publish() once definitions are
  // complete (append mode — avoids a transient md.json with steps but no
  // variables that would crash live streaming readers), and on every
  // committed step / close.
  void define_attribute_json(const std::string &name, const std::string &json) {
    std::unique_lock<std::mutex> lk(mu_);
    attributes_[name] = json;
  }

  void define_variable(const std::string &name, const std::string &dtype,
                       const int64_t *shape, int ndim) {
    std::unique_lock<std::mutex> lk(mu_);
    variables_[name] = Variable{dtype, {shape, shape + ndim}};
  }

  void set_prior_steps_json(const std::string &steps_json) {
    std::unique_lock<std::mutex> lk(mu_);
    prior_steps_json_ = steps_json;
  }

  void publish() {
    std::unique_lock<std::mutex> lk(mu_);
    publish_md_locked(std::move(lk));
  }

  int begin_step() {
    std::unique_lock<std::mutex> lk(mu_);
    if (in_step_) return -1;
    in_step_ = true;
    current_ = Step{};
    return 0;
  }

  // Stages one block; returns the payload offset it will land at, or -1.
  int64_t put(const std::string &var, const void *data, int64_t nbytes,
              const int64_t *start, const int64_t *count, int ndim) {
    std::unique_lock<std::mutex> lk(mu_);
    if (!in_step_ || variables_.find(var) == variables_.end()) return -1;
    Block b;
    b.var = var;
    const int64_t block_offset = staged_offset_;
    b.offset = block_offset;
    b.start.assign(start, start + ndim);
    b.count.assign(count, count + ndim);
    b.data.assign(static_cast<const uint8_t *>(data),
                  static_cast<const uint8_t *>(data) + nbytes);
    staged_offset_ += nbytes;
    current_.blocks.push_back(std::move(b));
    return block_offset;
  }

  int end_step() {
    std::unique_lock<std::mutex> lk(mu_);
    if (!in_step_) return -1;
    in_step_ = false;
    queue_.push_back(std::move(current_));
    cv_.notify_all();
    return 0;
  }

  // Blocks until every queued step is durable (data fsync'd, md
  // published). Returns 0, or -1 if any write failed (the failed and all
  // subsequent steps are NOT published).
  int drain() {
    std::unique_lock<std::mutex> lk(mu_);
    drained_cv_.wait(lk, [this] { return queue_.empty() && !writing_; });
    return io_error_ ? -1 : 0;
  }

  int close() {
    int rc = drain();
    std::unique_lock<std::mutex> lk(mu_);
    complete_ = true;
    publish_md_locked(std::move(lk));
    return rc;
  }

 private:
  void io_loop() {
    for (;;) {
      Step step;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (queue_.empty()) {
          if (stop_) return;
          continue;
        }
        step = std::move(queue_.front());
        queue_.pop_front();
        if (io_error_) {  // stream already poisoned: drop, don't write
          drained_cv_.notify_all();
          continue;
        }
        writing_ = true;
      }
      // data plane: append payloads, then fsync before publishing metadata
      bool failed = false;
      for (const Block &b : step.blocks) {
        ssize_t left = static_cast<ssize_t>(b.data.size());
        const uint8_t *p = b.data.data();
        while (left > 0) {
          ssize_t n = ::write(fd_, p, left);
          if (n < 0 && errno == EINTR) continue;
          if (n <= 0) {  // ENOSPC, EIO, ... — poison the stream
            failed = true;
            break;
          }
          p += n;
          left -= n;
        }
        if (failed) break;
      }
      if (!failed && ::fsync(fd_) != 0) failed = true;
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (failed) {
          // A half-written payload desynchronizes every later offset;
          // never publish this or any later step.
          io_error_ = true;
          writing_ = false;
          drained_cv_.notify_all();
          continue;
        }
        for (Block &b : step.blocks) b.data.clear();
        committed_steps_.push_back(std::move(step));
        publish_md_locked(std::move(lk));
      }
      {
        // writing_ flips only after the step's metadata is published, so
        // drain() can't race a final close() publish past this one.
        std::unique_lock<std::mutex> lk(mu_);
        writing_ = false;
        drained_cv_.notify_all();
      }
    }
  }

  std::string step_json(const Step &s) const {
    // {"U": [{"file": "data.0", "offset": N, "start": [...], "count": [...]}]}
    std::map<std::string, std::string> per_var;
    for (const Block &b : s.blocks) {
      std::string &arr = per_var[b.var];
      if (!arr.empty()) arr += ", ";
      arr += "{\"file\": \"" + json_escape(data_name_) +
             "\", \"offset\": " + std::to_string(b.offset) + ", \"start\": [";
      for (size_t i = 0; i < b.start.size(); ++i)
        arr += (i ? ", " : "") + std::to_string(b.start[i]);
      arr += "], \"count\": [";
      for (size_t i = 0; i < b.count.size(); ++i)
        arr += (i ? ", " : "") + std::to_string(b.count[i]);
      arr += "]}";
    }
    std::string out = "{";
    bool first = true;
    for (const auto &kv : per_var) {
      if (!first) out += ", ";
      first = false;
      out += "\"" + json_escape(kv.first) + "\": [" + kv.second + "]";
    }
    out += "}";
    return out;
  }

  // Builds the metadata string under the state lock, then releases it for
  // the file I/O (fsync'd tmp + atomic rename) so put()/begin_step() never
  // stall behind a metadata flush; publish_mu_ serializes publishers.
  void publish_md_locked(std::unique_lock<std::mutex> lk) {
    std::string md = "{\"format\": \"bplite-1\", \"complete\": ";
    md += complete_ ? "true" : "false";
    md += ", \"nwriters\": " + std::to_string(nwriters_) + ", \"attributes\": {";
    bool first = true;
    for (const auto &kv : attributes_) {
      if (!first) md += ", ";
      first = false;
      md += "\"" + json_escape(kv.first) + "\": " + kv.second;
    }
    md += "}, \"variables\": {";
    first = true;
    for (const auto &kv : variables_) {
      if (!first) md += ", ";
      first = false;
      md += "\"" + json_escape(kv.first) + "\": {\"dtype\": \"" +
            json_escape(kv.second.dtype) + "\", \"shape\": [";
      for (size_t i = 0; i < kv.second.shape.size(); ++i)
        md += (i ? ", " : "") + std::to_string(kv.second.shape[i]);
      md += "]}";
    }
    md += "}, \"steps\": [";
    first = prior_steps_json_.empty();
    if (!first) md += prior_steps_json_;
    for (const Step &s : committed_steps_) {
      if (!first) md += ", ";
      first = false;
      md += step_json(s);
    }
    md += "]}";
    lk.unlock();

    std::unique_lock<std::mutex> plk(publish_mu_);
    const std::string tmp = path_ + "/" + md_name_ + ".tmp";
    const std::string final_path = path_ + "/" + md_name_;
    FILE *f = std::fopen(tmp.c_str(), "w");
    if (!f) return;
    std::fwrite(md.data(), 1, md.size(), f);
    std::fflush(f);
    ::fsync(::fileno(f));
    std::fclose(f);
    ::rename(tmp.c_str(), final_path.c_str());
  }

  std::string path_;
  int writer_id_;
  int nwriters_;
  std::string data_name_;
  std::string md_name_;
  int fd_ = -1;
  int64_t offset_ = 0;        // durable bytes in data file at open
  int64_t staged_offset_ = 0; // includes staged-but-unwritten payloads

  std::mutex mu_;
  std::mutex publish_mu_;  // serializes md.json writers (io thread + API)
  std::condition_variable cv_;
  std::condition_variable drained_cv_;
  std::map<std::string, std::string> attributes_;  // name -> raw JSON value
  std::map<std::string, Variable> variables_;
  std::string prior_steps_json_;  // comma-joined step objects (append mode)
  std::deque<Step> queue_;
  std::vector<Step> committed_steps_;
  Step current_;
  bool in_step_ = false;
  bool writing_ = false;
  bool complete_ = false;
  bool stop_ = false;
  bool io_error_ = false;
  std::thread io_thread_;

 public:
  void init_staged_offset() { staged_offset_ = offset_; }
};

}  // namespace

extern "C" {

// Bumped on any C-ABI change (argument lists, semantics). The Python
// binding refuses to load a library reporting a different version — a
// stale build must fall back to the Python engine, not silently misread
// arguments.
int bpw_abi_version() { return 2; }

void *bpw_open(const char *path, int writer_id, int nwriters, int append) {
  auto *w = new Writer(path, writer_id, nwriters, append != 0);
  if (!w->ok()) {
    delete w;
    return nullptr;
  }
  w->init_staged_offset();
  // Fresh store: publish the (empty) metadata immediately so streaming
  // readers can open it, like the Python engine. Append mode defers to an
  // explicit bpw_publish after prior state has been forwarded.
  if (!append) w->publish();
  return w;
}

void bpw_publish(void *h) { static_cast<Writer *>(h)->publish(); }

void bpw_define_attribute_json(void *h, const char *name, const char *json) {
  static_cast<Writer *>(h)->define_attribute_json(name, json);
}

void bpw_define_variable(void *h, const char *name, const char *dtype,
                         const int64_t *shape, int ndim) {
  static_cast<Writer *>(h)->define_variable(name, dtype, shape, ndim);
}

void bpw_set_prior_steps_json(void *h, const char *steps_json) {
  static_cast<Writer *>(h)->set_prior_steps_json(steps_json);
}

int bpw_begin_step(void *h) { return static_cast<Writer *>(h)->begin_step(); }

int64_t bpw_put(void *h, const char *var, const void *data, int64_t nbytes,
                const int64_t *start, const int64_t *count, int ndim) {
  return static_cast<Writer *>(h)->put(var, data, nbytes, start, count, ndim);
}

int bpw_end_step(void *h) { return static_cast<Writer *>(h)->end_step(); }

int bpw_drain(void *h) { return static_cast<Writer *>(h)->drain(); }

int bpw_close(void *h) {
  auto *w = static_cast<Writer *>(h);
  int rc = w->close();
  delete w;
  return rc;
}

}  // extern "C"
