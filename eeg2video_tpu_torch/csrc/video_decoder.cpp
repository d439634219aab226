// Native video clip decoder — the framework's counterpart of the reference's
// decord loader (reference EEG2Video_New/Generation/tuneavideo/data/
// dataset.py:8-9,41,78: decord torch-bridge read, resize at decode, every
// sample_frame_rate-th frame, first n_sample_frames, /127.5-1).
//
// A pthread pool decodes one clip per task with cv::VideoCapture, resizes
// with INTER_LINEAR (cv2.resize default, matching data/video.py), converts
// BGR->RGB and writes normalized float32 directly into the caller's
// (n_clips, n_frames, H, W, 3) buffer.  The Python side (data/native.py)
// binds it with ctypes; a clip that yields no frame is reported there by
// its path.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 with
// `pkg-config --cflags --libs opencv4`, at first use
// (eeg2video_tpu_torch/data/native.py video_library()).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/videoio.hpp>

namespace {

// Decode one clip into out (n_frames, height, width, 3) float32 in [-1, 1].
// Returns the number of frames written (0 on open failure).
int decode_one(const char* path, int width, int height, int n_frames,
               int frame_stride, int start_idx, float* out) {
  cv::VideoCapture cap(path);
  if (!cap.isOpened()) return 0;

  const int64_t frame_elems = int64_t(height) * width * 3;
  int written = 0;
  int frame_idx = 0;
  cv::Mat frame, resized, rgb;
  while (written < n_frames && cap.read(frame)) {
    const bool take =
        frame_idx >= start_idx && (frame_idx - start_idx) % frame_stride == 0;
    ++frame_idx;
    if (!take) continue;
    cv::resize(frame, resized, cv::Size(width, height), 0, 0,
               cv::INTER_LINEAR);
    cv::cvtColor(resized, rgb, cv::COLOR_BGR2RGB);
    float* dst = out + int64_t(written) * frame_elems;
    const uint8_t* src = rgb.ptr<uint8_t>(0);
    const int64_t n = frame_elems;
    for (int64_t i = 0; i < n; ++i) {
      dst[i] = float(src[i]) / 127.5f - 1.0f;
    }
    ++written;
  }
  // short clips: zero-fill the tail so the buffer is fully defined
  if (written < n_frames) {
    std::memset(out + int64_t(written) * frame_elems, 0,
                sizeof(float) * frame_elems * (n_frames - written));
  }
  return written;
}

}  // namespace

extern "C" {

// Decode n_clips videos in parallel.  paths: array of n_clips C strings;
// out: (n_clips, n_frames, height, width, 3) float32; frames_written:
// per-clip decoded frame counts (may be < n_frames for short clips).
// Returns the number of clips that opened successfully.
int e2v_decode_clips(const char** paths, int n_clips, int width, int height,
                     int n_frames, int frame_stride, int start_idx,
                     float* out, int* frames_written, int n_threads) {
  if (n_threads <= 0) {
    n_threads = int(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n_clips) n_threads = n_clips > 0 ? n_clips : 1;

  const int64_t clip_elems =
      int64_t(n_frames) * height * width * 3;
  std::atomic<int> next(0), ok(0);
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([&]() {
      while (true) {
        const int i = next.fetch_add(1);
        if (i >= n_clips) break;
        const int w = decode_one(paths[i], width, height, n_frames,
                                 frame_stride, start_idx,
                                 out + int64_t(i) * clip_elems);
        frames_written[i] = w;
        if (w > 0) ok.fetch_add(1);
      }
    });
  }
  for (auto& th : workers) th.join();
  return ok.load();
}

}  // extern "C"
