// Native data loader for flvis_tpu.
//
// Native equivalent of the reference's ingestion stack (ROS image
// transport + cv_bridge + per-nodelet cv::remap rectification,
// /root/reference/src/frontend/vo_tracking.cpp:174-264, 387-420): a small
// C++ library that decodes grayscale PNG frames, applies the precomputed
// stereo-rectification maps, and prefetches ahead of the device pipeline on
// background threads, so the Python host loop never blocks on disk or
// decode while the accelerator is busy.  Exposed through a C ABI consumed via
// ctypes (flvis_tpu/io/native_loader.py).

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- decoding
bool decode_png_gray_impl(const char* path, std::vector<float>& out, int* w,
                          int* h) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  const int width = png_get_image_width(png, info);
  const int height = png_get_image_height(png, info);
  const png_byte color = png_get_color_type(png, info);
  const png_byte depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  out.resize(static_cast<size_t>(width) * height);
  for (int y = 0; y < height; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out.data() + static_cast<size_t>(y) * width;
    for (int x = 0; x < width; ++x) dst[x] = static_cast<float>(row[x]);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  *w = width;
  *h = height;
  return true;
}

// ------------------------------------------------------------ rectification
void remap_bilinear(const float* src, int w, int h, const float* map_x,
                    const float* map_y, float* dst) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const size_t i = static_cast<size_t>(y) * w + x;
      float fx = map_x[i];
      float fy = map_y[i];
      if (fx < 0) fx = 0;
      if (fy < 0) fy = 0;
      if (fx > w - 1.001f) fx = w - 1.001f;
      if (fy > h - 1.001f) fy = h - 1.001f;
      const int x0 = static_cast<int>(fx);
      const int y0 = static_cast<int>(fy);
      const float ax = fx - x0;
      const float ay = fy - y0;
      const float* r0 = src + static_cast<size_t>(y0) * w;
      const float* r1 = src + static_cast<size_t>(y0 + 1 < h ? y0 + 1 : y0) * w;
      const int x1 = x0 + 1 < w ? x0 + 1 : x0;
      dst[i] = r0[x0] * (1 - ax) * (1 - ay) + r0[x1] * ax * (1 - ay) +
               r1[x0] * (1 - ax) * ay + r1[x1] * ax * ay;
    }
  }
}

// ---------------------------------------------------------------- prefetch
struct StereoItem {
  std::vector<float> img0, img1;
  int w = 0, h = 0;
  bool ok = false;
};

struct Prefetcher {
  std::vector<std::string> paths0, paths1;
  std::vector<float> mapx, mapy;  // shared rectification maps (may be empty)
  int width = 0, height = 0;
  size_t next_emit = 0;
  size_t depth = 4;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  // Keyed by frame index: the consumer waits for exactly `next_emit`, so the
  // condition-variable predicate is precise and the wait actually sleeps
  // when only out-of-order frames are ready (a FIFO queue with re-push
  // busy-spun holding the mutex and deadlocked the producers).
  std::map<size_t, StereoItem> ready;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<size_t> submit_counter{0};

  void worker() {
    const size_t plane = static_cast<size_t>(width) * height;
    for (;;) {
      const size_t idx = submit_counter.fetch_add(1);
      if (stop.load() || idx >= paths0.size()) return;
      StereoItem item;
      int w0, h0, w1, h1;
      std::vector<float> raw0, raw1;
      item.ok = decode_png_gray_impl(paths0[idx].c_str(), raw0, &w0, &h0) &&
                decode_png_gray_impl(paths1[idx].c_str(), raw1, &w1, &h1) &&
                // Decoded dimensions MUST match the configured buffer size:
                // the consumer memcpys into width*height caller buffers and
                // the rectification maps are width*height planes.
                w0 == width && h0 == height && w1 == width && h1 == height;
      if (item.ok) {
        item.w = w0;
        item.h = h0;
        if (!mapx.empty()) {
          item.img0.resize(plane);
          item.img1.resize(plane);
          remap_bilinear(raw0.data(), width, height, mapx.data(), mapy.data(),
                         item.img0.data());
          remap_bilinear(raw1.data(), width, height, mapx.data() + plane,
                         mapy.data() + plane, item.img1.data());
        } else {
          item.img0 = std::move(raw0);
          item.img1 = std::move(raw1);
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      // Admit by INDEX window, not by queue size: a size-bounded buffer can
      // fill with frames i+1..i+2d while the producer of frame i (the one
      // the ordered consumer waits for) blocks for space — deadlock.  An
      // index window always admits the next-to-emit frame.
      cv_full.wait(lk, [&] {
        return idx < next_emit + depth * 2 || stop.load();
      });
      if (stop.load()) return;
      ready.emplace(idx, std::move(item));
      cv_empty.notify_all();
    }
  }

  // Returns 1 on success, 0 for a failed frame (decode error / size
  // mismatch — caller may skip it), -1 at end of stream.
  int next(float* out0, float* out1) {
    StereoItem item;
    {
      std::unique_lock<std::mutex> lk(mu);
      if (next_emit >= paths0.size()) return -1;
      cv_empty.wait(lk, [&] { return ready.count(next_emit) || stop.load(); });
      if (stop.load()) return -1;
      auto it = ready.find(next_emit);
      item = std::move(it->second);
      ready.erase(it);
      ++next_emit;
      cv_full.notify_all();
    }
    if (!item.ok) return 0;
    std::memcpy(out0, item.img0.data(), item.img0.size() * sizeof(float));
    std::memcpy(out1, item.img1.data(), item.img1.size() * sizeof(float));
    return 1;
  }
};

}  // namespace

extern "C" {

// Decode a single grayscale PNG into a caller-provided float buffer of
// capacity max_pixels.  Returns 1 on success and sets *w, *h.
int flvis_decode_png_gray(const char* path, float* out, int max_pixels, int* w,
                          int* h) {
  std::vector<float> buf;
  if (!decode_png_gray_impl(path, buf, w, h)) return 0;
  if (static_cast<int>(buf.size()) > max_pixels) return 0;
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  return 1;
}

// Create a stereo prefetcher over n frame pairs.  paths are '\n'-joined.
// maps: either nullptr (no rectification) or 4 concatenated (h*w) float
// planes [map0_x, map0_y? — layout: map_x then map_y, each holding cam0
// plane followed by cam1 plane].
void* flvis_prefetch_create(const char* paths0_joined, const char* paths1_joined,
                            int n, int width, int height, const float* map_x,
                            const float* map_y, int num_threads) {
  auto* p = new Prefetcher();
  p->width = width;
  p->height = height;
  auto split = [](const char* joined, int n, std::vector<std::string>& out) {
    const char* s = joined;
    for (int i = 0; i < n; ++i) {
      const char* e = strchr(s, '\n');
      if (!e) e = s + strlen(s);
      out.emplace_back(s, e - s);
      s = (*e) ? e + 1 : e;
    }
  };
  split(paths0_joined, n, p->paths0);
  split(paths1_joined, n, p->paths1);
  if (map_x && map_y) {
    const size_t plane = static_cast<size_t>(width) * height;
    p->mapx.assign(map_x, map_x + 2 * plane);
    p->mapy.assign(map_y, map_y + 2 * plane);
  }
  const int nt = num_threads > 0 ? num_threads : 2;
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

int flvis_prefetch_next(void* handle, float* out0, float* out1) {
  return static_cast<Prefetcher*>(handle)->next(out0, out1);
}

void flvis_prefetch_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_empty.notify_all();
  p->cv_full.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
