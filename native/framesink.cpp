// framesink — native frame consumer for the renderer.
//
// Equivalent of the reference's ScreenRecorder
// (reference: src/main.cpp:29-124): the reference glReadPixels's each frame
// on the render thread and fwrite's it into a popen'd FFmpeg pipe, stalling
// the GPU loop on encoder hiccups. Here the render loop (Python/JAX) hands
// device-fetched RGBA frames to this library, which copies them into a
// fixed-size ring buffer and drains them on a dedicated writer thread —
// the device keeps rendering while H.264 encoding happens elsewhere.
//
// Sinks: mode 0 pipes raw RGBA into a command (FFmpeg, reference command
// line semantics per main.cpp:60-74); mode 1 writes (truncates) a raw
// file; mode 2 appends to a raw file (resume).
//
// C ABI only (consumed via ctypes — no pybind11 in this toolchain).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct FrameSink {
  FILE* out = nullptr;
  bool is_pipe = false;
  size_t frame_bytes = 0;

  std::vector<uint8_t> ring;      // queue_frames * frame_bytes
  size_t slots = 0;
  size_t head = 0;                // next slot to write (producer)
  size_t tail = 0;                // next slot to drain (consumer)
  size_t filled = 0;

  std::mutex mu;
  std::condition_variable cv_space;
  std::condition_variable cv_data;
  bool closing = false;
  bool write_error = false;
  std::atomic<long> frames_written{0};
  std::thread writer;

  void writer_loop() {
    std::vector<uint8_t> local(frame_bytes);
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_data.wait(lk, [&] { return filled > 0 || closing; });
        if (filled == 0 && closing) return;
        std::memcpy(local.data(), ring.data() + tail * frame_bytes,
                    frame_bytes);
        tail = (tail + 1) % slots;
        --filled;
        cv_space.notify_one();
      }
      bool ok;
      {
        std::lock_guard<std::mutex> lk(mu);
        ok = !write_error;
      }
      if (ok) {
        size_t n = fwrite(local.data(), 1, frame_bytes, out);
        if (n != frame_bytes) {
          std::lock_guard<std::mutex> lk(mu);
          write_error = true;
          cv_space.notify_all();  // wake any producer blocked on a full ring
        } else {
          frames_written.fetch_add(1);
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// Bump when the C ABI changes; the Python loader rebuilds on mismatch.
long fs_abi_version() { return 2; }


// mode 0: `target` is a shell command to pipe into (e.g. an ffmpeg line).
// mode 1: `target` is a filesystem path opened for binary write (truncate).
// mode 2: `target` is a filesystem path opened for binary append (resume).
// Returns an opaque handle, or nullptr on failure.
void* fs_create(const char* target, int mode, long frame_bytes,
                int queue_frames) {
  if (frame_bytes <= 0 || queue_frames <= 0) return nullptr;
  FILE* out = nullptr;
  bool is_pipe = (mode == 0);
  if (is_pipe) {
    out = popen(target, "w");
  } else {
    out = fopen(target, mode == 2 ? "ab" : "wb");
  }
  if (!out) return nullptr;

  auto* sink = new FrameSink();
  sink->out = out;
  sink->is_pipe = is_pipe;
  sink->frame_bytes = static_cast<size_t>(frame_bytes);
  sink->slots = static_cast<size_t>(queue_frames);
  sink->ring.resize(sink->slots * sink->frame_bytes);
  sink->writer = std::thread([sink] { sink->writer_loop(); });
  return sink;
}

// Copies one frame into the ring (blocks while the queue is full).
// Returns 0 on success, -1 on error/closed sink.
int fs_submit(void* handle, const uint8_t* data, long len) {
  auto* sink = static_cast<FrameSink*>(handle);
  if (!sink || !data ||
      static_cast<size_t>(len) != sink->frame_bytes)
    return -1;
  std::unique_lock<std::mutex> lk(sink->mu);
  if (sink->closing || sink->write_error) return -1;
  sink->cv_space.wait(lk, [&] {
    return sink->filled < sink->slots || sink->closing || sink->write_error;
  });
  if (sink->closing || sink->write_error) return -1;
  std::memcpy(sink->ring.data() + sink->head * sink->frame_bytes, data,
              sink->frame_bytes);
  sink->head = (sink->head + 1) % sink->slots;
  ++sink->filled;
  sink->cv_data.notify_one();
  return 0;
}

long fs_frames_written(void* handle) {
  auto* sink = static_cast<FrameSink*>(handle);
  return sink ? sink->frames_written.load() : -1;
}

int fs_has_error(void* handle) {
  auto* sink = static_cast<FrameSink*>(handle);
  if (!sink) return 1;
  std::lock_guard<std::mutex> lk(sink->mu);
  return sink->write_error ? 1 : 0;
}

// Drains the queue, joins the writer, closes the pipe/file (finalizing the
// MP4 when the target was FFmpeg — analog of pclose at main.cpp:104).
// Returns frames written, or -1 on any write error — INCLUDING errors that
// happened while draining the final queued frames (checked after join).
long fs_close(void* handle) {
  auto* sink = static_cast<FrameSink*>(handle);
  if (!sink) return -1;
  {
    std::lock_guard<std::mutex> lk(sink->mu);
    sink->closing = true;
  }
  sink->cv_data.notify_all();
  sink->cv_space.notify_all();
  if (sink->writer.joinable()) sink->writer.join();
  // The close itself can fail: fclose flushes the last stdio buffer (disk
  // full), and pclose reports FFmpeg's exit status (a nonzero exit means
  // the finalize — e.g. the MP4 moov atom — failed even if every fwrite
  // succeeded). Both must surface as errors per this function's contract.
  int close_rc;
  if (sink->is_pipe) {
    close_rc = pclose(sink->out);
  } else {
    close_rc = fclose(sink->out);
  }
  bool err = sink->write_error || close_rc != 0;
  long n = sink->frames_written.load();
  delete sink;
  return err ? -1 : n;
}

}  // extern "C"
