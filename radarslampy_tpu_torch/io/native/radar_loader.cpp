// Native Oxford radar PNG decoder + multi-threaded prefetching loader.
//
// Replaces the host-side hot path of the reference's data layer
// (`parseData.py:160-259`, which crosses into OpenCV's C++ imread per frame)
// with a GIL-free C++ pipeline: libpng decode, metadata field extraction
// (cols 0-7 int64 timestamps, 8-9 uint16 encoder azimuth, 10 valid flag,
// 11+ power/255 — `parseData.py:39-43`), range clip and lane-padding into the
// float32 layout the device pipeline consumes — all off the Python thread.
//
// The loader pool decodes ahead with N worker threads and delivers frames in
// order with bounded lookahead; `rsl_loader_next` copies into caller-owned
// buffers (numpy arrays via ctypes).
//
// Build: g++ -O2 -shared -fPIC radar_loader.cpp -lpng -o libradar_loader.so

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  // Power is kept as the raw PNG bytes (clipped + lane-padded): the device
  // dequantizes (u8/255) after transfer, so keeping u8 here both halves decode
  // work and lets the Python side ship 1 byte/bin over PCIe instead of 4.
  std::vector<uint8_t> power;      // [A * padded_bins] raw bytes
  std::vector<float> azimuths;     // [A]
  std::vector<uint8_t> valid;      // [A]
  std::vector<int64_t> timestamps; // [A]
  bool ok = false;
};

void copy_power_f32(const std::vector<uint8_t>& src, float* dst) {
  constexpr float kInv255 = 1.0f / 255.0f;
  for (size_t i = 0; i < src.size(); ++i) dst[i] = src[i] * kInv255;
}

struct Geometry {
  int num_azimuths;
  int raw_cols;   // full PNG width (e.g. 3779)
  int clip_bins;  // power bins kept (e.g. 2025)
  int padded_bins;
};

bool decode_one(const char* path, const Geometry& g, Frame* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;

  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  std::vector<png_bytep> row_ptrs;
  std::vector<uint8_t> raw;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  const int width = png_get_image_width(png, info);
  const int height = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGBA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray(png, 1, -1.0, -1.0);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  if (height != g.num_azimuths || width < g.raw_cols) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }

  raw.resize(static_cast<size_t>(width) * height);
  row_ptrs.resize(height);
  for (int r = 0; r < height; ++r)
    row_ptrs[r] = raw.data() + static_cast<size_t>(r) * width;
  png_read_image(png, row_ptrs.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);

  const int A = g.num_azimuths;
  out->power.assign(static_cast<size_t>(A) * g.padded_bins, 0);
  out->azimuths.resize(A);
  out->valid.resize(A);
  out->timestamps.resize(A);

  constexpr double kTwoPi = 6.283185307179586;
  for (int r = 0; r < A; ++r) {
    const uint8_t* row = raw.data() + static_cast<size_t>(r) * width;
    int64_t ts;
    std::memcpy(&ts, row, 8);  // little-endian int64
    out->timestamps[r] = ts;
    uint16_t enc;
    std::memcpy(&enc, row + 8, 2);
    out->azimuths[r] = static_cast<float>(enc / 5600.0 * kTwoPi);
    out->valid[r] = row[10] == 255 ? 1 : 0;
    uint8_t* dst = out->power.data() + static_cast<size_t>(r) * g.padded_bins;
    std::memcpy(dst, row + 11, g.clip_bins);
  }
  out->ok = true;
  return true;
}

struct Loader {
  Geometry geom;
  std::vector<std::string> paths;
  int depth;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv;
  std::map<int, Frame> ready;
  int next_consume = 0;
  std::atomic<int> next_claim{0};
  bool stopping = false;

  void work() {
    for (;;) {
      int i = next_claim.fetch_add(1);
      if (i >= static_cast<int>(paths.size())) return;
      Frame f;
      decode_one(paths[i].c_str(), geom, &f);
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [&] { return stopping || i - next_consume <= depth; });
      if (stopping) return;
      ready.emplace(i, std::move(f));
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int rsl_decode(const char* path, int num_azimuths, int raw_cols, int clip_bins,
               int padded_bins, float* out_power, float* out_azimuths,
               uint8_t* out_valid, int64_t* out_timestamps) {
  Geometry g{num_azimuths, raw_cols, clip_bins, padded_bins};
  Frame f;
  if (!decode_one(path, g, &f)) return -1;
  copy_power_f32(f.power, out_power);
  std::memcpy(out_azimuths, f.azimuths.data(), f.azimuths.size() * sizeof(float));
  std::memcpy(out_valid, f.valid.data(), f.valid.size());
  std::memcpy(out_timestamps, f.timestamps.data(),
              f.timestamps.size() * sizeof(int64_t));
  return 0;
}

// As rsl_decode, but power is delivered as the raw PNG bytes (u8) so callers
// can defer the /255 dequantisation to the accelerator.
int rsl_decode_u8(const char* path, int num_azimuths, int raw_cols,
                  int clip_bins, int padded_bins, uint8_t* out_power,
                  float* out_azimuths, uint8_t* out_valid,
                  int64_t* out_timestamps) {
  Geometry g{num_azimuths, raw_cols, clip_bins, padded_bins};
  Frame f;
  if (!decode_one(path, g, &f)) return -1;
  std::memcpy(out_power, f.power.data(), f.power.size());
  std::memcpy(out_azimuths, f.azimuths.data(), f.azimuths.size() * sizeof(float));
  std::memcpy(out_valid, f.valid.data(), f.valid.size());
  std::memcpy(out_timestamps, f.timestamps.data(),
              f.timestamps.size() * sizeof(int64_t));
  return 0;
}

void* rsl_loader_create(const char** paths, int n_paths, int n_threads,
                        int depth, int num_azimuths, int raw_cols,
                        int clip_bins, int padded_bins) {
  auto* L = new Loader();
  L->geom = Geometry{num_azimuths, raw_cols, clip_bins, padded_bins};
  L->paths.reserve(n_paths);
  for (int i = 0; i < n_paths; ++i) L->paths.emplace_back(paths[i]);
  L->depth = depth;
  int nt = n_threads < 1 ? 1 : n_threads;
  for (int t = 0; t < nt; ++t) L->workers.emplace_back(&Loader::work, L);
  return L;
}

// Returns 0 on success, -1 on decode failure of this frame, -2 past the end.
int rsl_loader_next(void* handle, float* out_power, float* out_azimuths,
                    uint8_t* out_valid, int64_t* out_timestamps) {
  auto* L = static_cast<Loader*>(handle);
  int i;
  Frame f;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    i = L->next_consume;
    if (i >= static_cast<int>(L->paths.size())) return -2;
    L->cv.wait(lk, [&] { return L->ready.count(i) > 0; });
    f = std::move(L->ready[i]);
    L->ready.erase(i);
    L->next_consume = i + 1;
    L->cv.notify_all();
  }
  if (!f.ok) return -1;
  copy_power_f32(f.power, out_power);
  std::memcpy(out_azimuths, f.azimuths.data(), f.azimuths.size() * sizeof(float));
  std::memcpy(out_valid, f.valid.data(), f.valid.size());
  std::memcpy(out_timestamps, f.timestamps.data(),
              f.timestamps.size() * sizeof(int64_t));
  return 0;
}

// As rsl_loader_next, but power delivered as raw u8 bytes.
int rsl_loader_next_u8(void* handle, uint8_t* out_power, float* out_azimuths,
                       uint8_t* out_valid, int64_t* out_timestamps) {
  auto* L = static_cast<Loader*>(handle);
  int i;
  Frame f;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    i = L->next_consume;
    if (i >= static_cast<int>(L->paths.size())) return -2;
    L->cv.wait(lk, [&] { return L->ready.count(i) > 0; });
    f = std::move(L->ready[i]);
    L->ready.erase(i);
    L->next_consume = i + 1;
    L->cv.notify_all();
  }
  if (!f.ok) return -1;
  std::memcpy(out_power, f.power.data(), f.power.size());
  std::memcpy(out_azimuths, f.azimuths.data(), f.azimuths.size() * sizeof(float));
  std::memcpy(out_valid, f.valid.data(), f.valid.size());
  std::memcpy(out_timestamps, f.timestamps.data(),
              f.timestamps.size() * sizeof(int64_t));
  return 0;
}

void rsl_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stopping = true;
  }
  L->cv.notify_all();
  L->next_claim.store(1 << 30);
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
