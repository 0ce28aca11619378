// Native image-sequence runtime: threaded PGM/PPM loader with prefetch.
//
// The reference's IO layer is matlab_code/takeImage.m (imread of a
// '%s%04d.pgm' sequence, first channel) and takeImageFromAvi.m — compiled
// MATLAB primitives. This is the framework's equivalent: a C++ loader
// that parses P2/P5 PGM and P3/P6 PPM, normalizes to float32 [0,1]
// grayscale, and prefetches frames on background threads so host IO
// overlaps device compute (double-buffered, like an input pipeline).
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (ekf_slam_tpu/io/sequence.py).

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0;
  std::vector<float> data;  // grayscale [0,1]
  bool ok = false;
};

// ---------------------------------------------------------------- PGM/PPM

bool skip_ws_comments(FILE* f) {
  int c;
  while ((c = fgetc(f)) != EOF) {
    if (c == '#') {
      while ((c = fgetc(f)) != EOF && c != '\n') {
      }
    } else if (!std::isspace(c)) {
      ungetc(c, f);
      return true;
    }
  }
  return false;
}

long read_int(FILE* f) {
  if (!skip_ws_comments(f)) return -1;
  long v = 0;
  int c;
  bool any = false;
  while ((c = fgetc(f)) != EOF && std::isdigit(c)) {
    v = v * 10 + (c - '0');
    any = true;
  }
  if (c != EOF) ungetc(c, f);
  return any ? v : -1;
}

Image load_pnm(const char* path) {
  Image im;
  FILE* f = fopen(path, "rb");
  if (!f) return im;
  char magic[3] = {0, 0, 0};
  if (fread(magic, 1, 2, f) != 2 || magic[0] != 'P') {
    fclose(f);
    return im;
  }
  int kind = magic[1] - '0';  // 2,3 ascii; 5,6 binary
  if (kind != 2 && kind != 3 && kind != 5 && kind != 6) {
    fclose(f);
    return im;
  }
  long w = read_int(f), h = read_int(f), maxv = read_int(f);
  if (w <= 0 || h <= 0 || maxv <= 0 || maxv > 65535) {
    fclose(f);
    return im;
  }
  int channels = (kind == 3 || kind == 6) ? 3 : 1;
  size_t n = static_cast<size_t>(w) * h * channels;
  std::vector<float> raw(n);
  if (kind == 2 || kind == 3) {
    for (size_t i = 0; i < n; ++i) {
      long v = read_int(f);
      if (v < 0) {
        fclose(f);
        return im;
      }
      raw[i] = static_cast<float>(v);
    }
  } else {
    // one whitespace byte after maxval, then raw payload
    fgetc(f);
    if (maxv < 256) {
      std::vector<uint8_t> buf(n);
      if (fread(buf.data(), 1, n, f) != n) {
        fclose(f);
        return im;
      }
      for (size_t i = 0; i < n; ++i) raw[i] = buf[i];
    } else {
      std::vector<uint8_t> buf(2 * n);
      if (fread(buf.data(), 1, 2 * n, f) != 2 * n) {
        fclose(f);
        return im;
      }
      for (size_t i = 0; i < n; ++i)
        raw[i] = static_cast<float>((buf[2 * i] << 8) | buf[2 * i + 1]);
    }
  }
  fclose(f);
  im.h = static_cast<int>(h);
  im.w = static_cast<int>(w);
  im.data.resize(static_cast<size_t>(w) * h);
  const float inv = 1.0f / static_cast<float>(maxv);
  if (channels == 1) {
    for (size_t i = 0; i < im.data.size(); ++i) im.data[i] = raw[i] * inv;
  } else {
    // grayscale = first channel (takeImage.m keeps channel 1)
    for (size_t i = 0; i < im.data.size(); ++i) im.data[i] = raw[3 * i] * inv;
  }
  im.ok = true;
  return im;
}

}  // namespace

// Batch loading parallelizes over frames with a transient thread pool
// (IO-bound; threads amortize syscall latency). The handle only stores the
// path list + dims.

struct SequenceHandle {
  std::vector<std::string> paths;
  int height = 0, width = 0;
};

extern "C" {

// Open a printf-style sequence (e.g. "/data/seq/%04d.pgm") covering frames
// [start, start+count). Returns an opaque handle or nullptr; fills h/w from
// the first frame.
void* seq_open(const char* pattern, int start, int count, int* h, int* w) {
  auto* s = new SequenceHandle();
  char buf[4096];
  for (int i = 0; i < count; ++i) {
    snprintf(buf, sizeof(buf), pattern, start + i);
    s->paths.emplace_back(buf);
  }
  if (count > 0) {
    Image first = load_pnm(s->paths[0].c_str());
    if (!first.ok) {
      delete s;
      return nullptr;
    }
    s->height = first.h;
    s->width = first.w;
  }
  *h = s->height;
  *w = s->width;
  return s;
}

int seq_len(void* handle) {
  return static_cast<int>(static_cast<SequenceHandle*>(handle)->paths.size());
}

// Load frames [first, first+n) into out (n * h * w floats, row-major).
// Returns the number of frames successfully loaded (stops at first failure
// or size mismatch). Parallel over frames.
int seq_load_batch(void* handle, int first, int n, float* out) {
  auto* s = static_cast<SequenceHandle*>(handle);
  const size_t frame_sz = static_cast<size_t>(s->height) * s->width;
  std::atomic<int> ok_count{0};
  std::vector<uint8_t> ok(static_cast<size_t>(n), 0);
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int n_threads = hw < 1 ? 1 : (hw > 8 ? 8 : hw);
  std::atomic<int> next{0};
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      size_t idx = static_cast<size_t>(first) + i;
      if (idx >= s->paths.size()) continue;
      Image im = load_pnm(s->paths[idx].c_str());
      if (im.ok && im.h == s->height && im.w == s->width) {
        std::memcpy(out + frame_sz * i, im.data.data(),
                    frame_sz * sizeof(float));
        ok[i] = 1;
        ok_count.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  // contiguous prefix of successes
  int prefix = 0;
  while (prefix < n && ok[prefix]) ++prefix;
  return prefix;
}

void seq_close(void* handle) { delete static_cast<SequenceHandle*>(handle); }

// Standalone single-image load (the takeImage.m equivalent).
int load_pnm_gray(const char* path, float* out, int max_elems, int* h,
                  int* w) {
  Image im = load_pnm(path);
  if (!im.ok) return 0;
  if (static_cast<int>(im.data.size()) > max_elems) return 0;
  std::memcpy(out, im.data.data(), im.data.size() * sizeof(float));
  *h = im.h;
  *w = im.w;
  return 1;
}

}  // extern "C"
