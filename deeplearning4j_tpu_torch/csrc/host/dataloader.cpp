// Host data-loading runtime of deeplearning4j_tpu_torch: a copy of the
// JAX package's native/src/dataloader.cpp (the CSV loader, the
// directory-per-label image loader and the word counter, with the same
// C ABI), built by deeplearning4j_tpu_torch/data/native_loader.py with
// g++ into build/native/ and bound with ctypes.
//
// What differs from that source is the PNG decode: libpng is replaced
// by the decoder below (read_png), which needs only zlib's uncompress
// and crc32. It reads what the loader's trees hold: 8-bit gray, gray +
// alpha, RGB and RGBA, non-interlaced, with the five row filters. An
// 8-bit RGB or gray file (with no gAMA or iCCP chunk asking for
// another gamma, which this decoder ignores) decodes to the same bytes
// as libpng's simplified API gives the JAX loader, so the batches are
// equal bit for bit. Where libpng's simplified API converts (alpha composed in
// linear light, RGB to gray in linear light) this decoder converts as
// PIL's Image.convert does for the JAX package's ImageRecordReader:
// alpha dropped, gray = (19595 R + 38470 G + 7471 B + 2^15) >> 16.
// Palette, 16-bit and interlaced files fail to decode and are counted
// as skipped, as a file libpng refuses is.
//
// C ABI only (no C++ symbols exported) so ctypes stays trivial.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <filesystem>
#include <fstream>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#ifndef DL4J_NO_PNG
#if __has_include(<zlib.h>)
#include <zlib.h>
#else
// zlib's two entry points the decoder calls, declared by hand where the
// header is not installed (the library is linked with -lz either way)
extern "C" {
int uncompress(unsigned char* dest, unsigned long* dest_len,
               const unsigned char* source, unsigned long source_len);
unsigned long crc32(unsigned long crc, const unsigned char* buf,
                    unsigned int len);
}
#endif
#endif

namespace {

struct Batch {
  std::vector<float> features;
  std::vector<float> labels;
  int n;  // rows actually filled (last batch may be short)
};

struct Loader {
  // config
  std::string path;
  int batch_size;
  int n_features;
  int label_index;   // -1: no labels
  int n_classes;     // 0: regression (1 label col)
  int queue_capacity;

  // state
  std::vector<std::string> lines;
  std::atomic<size_t> next_line{0};
  std::queue<Batch*> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<int> active_workers{0};
  std::atomic<int64_t> skipped_rows{0};
  bool stopped = false;

  ~Loader() { stop(); }

  void stop() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stopped = true;
    }
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    std::lock_guard<std::mutex> lock(mu);
    while (!ready.empty()) {
      delete ready.front();
      ready.pop();
    }
  }

  bool load_lines() {
    std::ifstream f(path);
    if (!f.is_open()) return false;
    std::string line;
    lines.clear();
    while (std::getline(f, line)) {
      if (!line.empty()) lines.push_back(line);
    }
    return true;
  }

  // parse one CSV line into the row-th slot of batch
  bool parse_line(const std::string& line, Batch* b, int row) {
    const char* p = line.c_str();
    char* end;
    int col = 0, feat_i = 0;
    bool saw_label = false;
    float label_val = 0.0f;
    float* feat_row = b->features.data() + (size_t)row * n_features;
    while (*p) {
      float v = strtof(p, &end);
      if (end == p) break;
      if (col == label_index) {
        label_val = v;
        saw_label = true;
      } else {
        if (feat_i >= n_features) return false;
        feat_row[feat_i++] = v;
      }
      ++col;
      p = end;
      while (*p == ',' || *p == ' ' || *p == '\t') ++p;
    }
    if (feat_i != n_features) return false;
    if (label_index >= 0 && !saw_label) return false;  // short row:
      // without this a row missing its label column would silently
      // train as class 0
    if (label_index >= 0) {
      if (n_classes > 0) {
        float* lab_row = b->labels.data() + (size_t)row * n_classes;
        std::memset(lab_row, 0, sizeof(float) * n_classes);
        int cls = (int)label_val;
        if (cls < 0 || cls >= n_classes) return false;
        lab_row[cls] = 1.0f;
      } else {
        b->labels[row] = label_val;
      }
    }
    return true;
  }

  void worker() {
    const int lab_width = label_index < 0 ? 0
                          : (n_classes > 0 ? n_classes : 1);
    for (;;) {
      size_t start = next_line.fetch_add((size_t)batch_size);
      if (start >= lines.size()) break;
      size_t end_i = std::min(start + (size_t)batch_size, lines.size());
      Batch* b = new Batch();
      b->features.resize((size_t)batch_size * n_features, 0.0f);
      if (lab_width) b->labels.resize((size_t)batch_size * lab_width, 0.0f);
      int row = 0;
      for (size_t i = start; i < end_i; ++i) {
        if (parse_line(lines[i], b, row)) ++row;
        else skipped_rows.fetch_add(1);
      }
      b->n = row;
      if (row == 0) {
        // an all-bad batch must not reach the queue: next() treats
        // n == 0 as end-of-data, which would silently drop every
        // remaining batch (and turn a misconfigured n_features into
        // a no-op instead of an error)
        delete b;
        continue;
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_space.wait(lock, [&] {
        return stopped || (int)ready.size() < queue_capacity;
      });
      if (stopped) {
        delete b;
        break;
      }
      ready.push(b);
      cv_ready.notify_one();
    }
    if (active_workers.fetch_sub(1) == 1) cv_ready.notify_all();
  }

  void start(int n_threads) {
    active_workers = n_threads;
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { worker(); });
  }

  // returns rows in batch, 0 when exhausted, -1 on stopped
  int next(float* feat_out, float* lab_out) {
    Batch* b = nullptr;
    {
      std::unique_lock<std::mutex> lock(mu);
      cv_ready.wait(lock, [&] {
        return stopped || !ready.empty() || active_workers.load() == 0;
      });
      if (stopped) return -1;
      if (ready.empty()) return 0;  // workers done, queue drained
      b = ready.front();
      ready.pop();
      cv_space.notify_one();
    }
    std::memcpy(feat_out, b->features.data(),
                b->features.size() * sizeof(float));
    if (lab_out && !b->labels.empty())
      std::memcpy(lab_out, b->labels.data(),
                  b->labels.size() * sizeof(float));
    int n = b->n;
    delete b;
    return n;
  }
};

// ---------------------------------------------------------------------------
// native image ETL: directory-per-label PNG tree -> (B,H,W,C) float
// batches + one-hot labels, decoded by a worker pool (read_png). The
// DataVec ImageRecordReader path (reference
// deeplearning4j-core/.../RecordReaderDataSetIterator.java:52 over
// datavec-data-image): the pool decodes in parallel outside the GIL,
// ahead of the device.

#ifndef DL4J_NO_PNG
inline uint32_t be32(const unsigned char* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

// Undo one row's filter in place (PNG spec 9.2); bpp: bytes a pixel,
// prev: the previous row already unfiltered (nullptr for the first).
bool unfilter_row(int type, unsigned char* row, const unsigned char* prev,
                  size_t n, int bpp) {
  switch (type) {
    case 0:
      return true;
    case 1:  // Sub
      for (size_t i = bpp; i < n; ++i) row[i] += row[i - bpp];
      return true;
    case 2:  // Up
      if (prev)
        for (size_t i = 0; i < n; ++i) row[i] += prev[i];
      return true;
    case 3:  // Average
      for (size_t i = 0; i < n; ++i) {
        int left = i >= (size_t)bpp ? row[i - bpp] : 0;
        int up = prev ? prev[i] : 0;
        row[i] += (unsigned char)((left + up) >> 1);
      }
      return true;
    case 4:  // Paeth
      for (size_t i = 0; i < n; ++i) {
        int a = i >= (size_t)bpp ? row[i - bpp] : 0;
        int b = prev ? prev[i] : 0;
        int c = (prev && i >= (size_t)bpp) ? prev[i - bpp] : 0;
        int p = a + b - c;
        int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
        int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        row[i] += (unsigned char)pred;
      }
      return true;
  }
  return false;
}

// Decode a PNG into tightly packed 8-bit gray (channels == 1) or RGB
// rows. False for a file it cannot read (see the header comment).
bool read_png(const char* path, int channels,
              std::vector<unsigned char>& out, unsigned* w,
              unsigned* h) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f.is_open()) return false;
  const std::streamsize size = f.tellg();
  if (size < 8) return false;
  std::vector<unsigned char> file((size_t)size);
  f.seekg(0);
  if (!f.read(reinterpret_cast<char*>(file.data()), size)) return false;
  static const unsigned char sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (file.size() < 8 || std::memcmp(file.data(), sig, 8) != 0)
    return false;
  uint32_t width = 0, height = 0;
  int src_ch = 0;
  bool have_header = false, have_end = false;
  std::vector<unsigned char> idat;
  size_t pos = 8;
  while (pos + 12 <= file.size()) {
    const uint32_t len = be32(&file[pos]);
    if (len > file.size() - pos - 12) return false;  // truncated
    const unsigned char* type = &file[pos + 4];
    const unsigned char* data = &file[pos + 8];
    // CRC over the type and the data, as libpng checks it
    if (crc32(crc32(0, nullptr, 0), type, len + 4) != be32(data + len))
      return false;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len != 13) return false;
      width = be32(data);
      height = be32(data + 4);
      const int depth = data[8], color = data[9];
      if (depth != 8 || data[10] != 0 || data[11] != 0 || data[12] != 0)
        return false;  // 8-bit, deflate, filter method 0, no interlace
      src_ch = color == 0 ? 1 : color == 4 ? 2 : color == 2 ? 3
               : color == 6 ? 4 : 0;
      if (!src_ch || width == 0 || height == 0 || width > (1u << 24) ||
          height > (1u << 24))
        return false;
      have_header = true;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      if (!have_header) return false;
      idat.insert(idat.end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      have_end = true;
      break;
    } else if (!(type[0] & 0x20)) {
      return false;  // an unknown critical chunk (PLTE among them)
    }
    pos += 12 + (size_t)len;
  }
  if (!have_header || !have_end || idat.empty()) return false;
  const size_t stride = (size_t)width * src_ch;
  std::vector<unsigned char> raw((stride + 1) * height);
  unsigned long raw_len = (unsigned long)raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(),
                 (unsigned long)idat.size()) != 0 ||
      raw_len != raw.size())
    return false;
  for (uint32_t y = 0; y < height; ++y) {
    unsigned char* row = &raw[y * (stride + 1)];
    const unsigned char* prev = y ? &raw[(y - 1) * (stride + 1) + 1]
                                  : nullptr;
    if (!unfilter_row(row[0], row + 1, prev, stride, src_ch)) return false;
  }
  out.resize((size_t)width * height * channels);
  for (uint32_t y = 0; y < height; ++y) {
    const unsigned char* src = &raw[y * (stride + 1) + 1];
    unsigned char* dst = &out[(size_t)y * width * channels];
    for (uint32_t x = 0; x < width; ++x, src += src_ch) {
      if (channels == 1) {
        dst[x] = src_ch >= 3
                     ? (unsigned char)((src[0] * 19595 + src[1] * 38470 +
                                        src[2] * 7471 + 0x8000) >> 16)
                     : src[0];
      } else {
        for (int c = 0; c < 3; ++c)
          dst[(size_t)x * 3 + c] = src[src_ch >= 3 ? c : 0];
      }
    }
  }
  *w = width;
  *h = height;
  return true;
}
#endif

struct ImageLoader {
  int batch_size, H, W, C, queue_capacity;
  std::vector<std::pair<std::string, int>> items;  // path, label idx
  std::vector<std::string> classes;
  std::atomic<size_t> next_item{0};
  std::queue<Batch*> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<int> active_workers{0};
  std::atomic<int64_t> skipped{0};
  bool stopped = false;

  ~ImageLoader() { stop(); }

  void stop() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stopped = true;
    }
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
    std::lock_guard<std::mutex> lock(mu);
    while (!ready.empty()) {
      delete ready.front();
      ready.pop();
    }
  }

  bool scan(const std::string& root) {
    namespace fs = std::filesystem;
    std::error_code ec;
    if (!fs::is_directory(root, ec)) return false;
    for (auto& d : fs::directory_iterator(root, ec)) {
      if (d.is_directory()) classes.push_back(d.path().filename());
    }
    std::sort(classes.begin(), classes.end());
    for (size_t li = 0; li < classes.size(); ++li) {
      std::vector<std::string> files;
      for (auto& f :
           fs::directory_iterator(fs::path(root) / classes[li], ec)) {
        std::string ext = f.path().extension();
        std::transform(ext.begin(), ext.end(), ext.begin(), ::tolower);
        if (ext == ".png") files.push_back(f.path());
      }
      std::sort(files.begin(), files.end());
      for (auto& f : files) items.emplace_back(f, (int)li);
    }
    return !items.empty();
  }

  // bilinear resize (src 8-bit HxWxC) into the row-th slot as float
  void resize_into(const unsigned char* src, unsigned sw, unsigned sh,
                   Batch* b, int row) {
    float* dst = b->features.data() + (size_t)row * H * W * C;
    if ((int)sw == W && (int)sh == H) {
      const size_t n = (size_t)H * W * C;
      for (size_t i = 0; i < n; ++i) dst[i] = (float)src[i];
      return;
    }
    const float sx = (float)sw / W, sy = (float)sh / H;
    for (int y = 0; y < H; ++y) {
      float fy = (y + 0.5f) * sy - 0.5f;
      int y0 = (int)fy;
      y0 = std::max(0, std::min((int)sh - 1, y0));
      int y1 = std::min((int)sh - 1, y0 + 1);
      float wy = fy - y0;
      if (wy < 0) wy = 0;
      for (int x = 0; x < W; ++x) {
        float fx = (x + 0.5f) * sx - 0.5f;
        int x0 = (int)fx;
        x0 = std::max(0, std::min((int)sw - 1, x0));
        int x1 = std::min((int)sw - 1, x0 + 1);
        float wx = fx - x0;
        if (wx < 0) wx = 0;
        for (int c = 0; c < C; ++c) {
          float v00 = src[((size_t)y0 * sw + x0) * C + c];
          float v01 = src[((size_t)y0 * sw + x1) * C + c];
          float v10 = src[((size_t)y1 * sw + x0) * C + c];
          float v11 = src[((size_t)y1 * sw + x1) * C + c];
          dst[(((size_t)y * W) + x) * C + c] =
              v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
              v10 * wy * (1 - wx) + v11 * wy * wx;
        }
      }
    }
  }

  // One coordinator walks batches in order; each batch's decodes are
  // split across a scoped thread team (parallelism WITHIN the batch —
  // claiming whole batches per worker serializes the common
  // one-batch-in-flight training loop).
  void coordinator(int n_threads) {
#ifndef DL4J_NO_PNG
    const int n_classes = (int)classes.size();
    for (size_t start = 0; start < items.size();
         start += (size_t)batch_size) {
      {
        std::lock_guard<std::mutex> lock(mu);
        if (stopped) break;
      }
      size_t end_i = std::min(start + (size_t)batch_size, items.size());
      const int expected = (int)(end_i - start);
      Batch* b = new Batch();
      b->features.resize((size_t)batch_size * H * W * C, 0.0f);
      b->labels.resize((size_t)batch_size * n_classes, 0.0f);
      std::vector<char> ok((size_t)expected, 0);
      std::atomic<int> cursor{0};
      const int nt = std::max(1, std::min(n_threads, expected));
      std::vector<std::thread> team;
      for (int t = 0; t < nt; ++t) {
        team.emplace_back([&, this] {
          std::vector<unsigned char> buf;
          for (;;) {
            int j = cursor.fetch_add(1);
            if (j >= expected) break;
            unsigned sw = 0, sh = 0;
            if (!read_png(items[start + j].first.c_str(), C, buf, &sw,
                          &sh))
              continue;
            resize_into(buf.data(), sw, sh, b, j);
            b->labels[(size_t)j * n_classes + items[start + j].second] =
                1.0f;
            ok[(size_t)j] = 1;
          }
        });
      }
      for (auto& t : team) t.join();
      // compact failed rows out
      const size_t fstride = (size_t)H * W * C;
      int row = 0;
      for (int j = 0; j < expected; ++j) {
        if (!ok[(size_t)j]) {
          skipped.fetch_add(1);
          continue;
        }
        if (row != j) {
          std::memmove(b->features.data() + (size_t)row * fstride,
                       b->features.data() + (size_t)j * fstride,
                       fstride * sizeof(float));
          std::memmove(b->labels.data() + (size_t)row * n_classes,
                       b->labels.data() + (size_t)j * n_classes,
                       (size_t)n_classes * sizeof(float));
        }
        ++row;
      }
      b->n = row;
      if (row == 0) {
        delete b;
        continue;
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_space.wait(lock, [&] {
        return stopped || (int)ready.size() < queue_capacity;
      });
      if (stopped) {
        delete b;
        break;
      }
      ready.push(b);
      cv_ready.notify_one();
    }
#endif
    if (active_workers.fetch_sub(1) == 1) cv_ready.notify_all();
  }

  void start(int n_threads) {
    active_workers = 1;
    workers.emplace_back([this, n_threads] { coordinator(n_threads); });
  }

  int next(float* feat_out, float* lab_out) {
    Batch* b = nullptr;
    {
      std::unique_lock<std::mutex> lock(mu);
      cv_ready.wait(lock, [&] {
        return stopped || !ready.empty() || active_workers.load() == 0;
      });
      if (stopped) return -1;
      if (ready.empty()) return 0;
      b = ready.front();
      ready.pop();
      cv_space.notify_one();
    }
    std::memcpy(feat_out, b->features.data(),
                b->features.size() * sizeof(float));
    if (lab_out && !b->labels.empty())
      std::memcpy(lab_out, b->labels.data(),
                  b->labels.size() * sizeof(float));
    int n = b->n;
    delete b;
    return n;
  }
};

// ---------------------------------------------------------------------------
// fast word counting for vocab construction (NLP VocabConstructor's
// hot loop; the reference parallelizes this across threads too)
struct WordCounts {
  std::vector<std::string> words;
  std::vector<int64_t> counts;
};

}  // namespace

extern "C" {

void* dl4j_csv_loader_create(const char* path, int batch_size,
                             int n_features, int label_index,
                             int n_classes, int n_threads,
                             int queue_capacity) {
  auto* l = new Loader();
  l->path = path;
  l->batch_size = batch_size;
  l->n_features = n_features;
  l->label_index = label_index;
  l->n_classes = n_classes;
  l->queue_capacity = queue_capacity > 0 ? queue_capacity : 4;
  if (!l->load_lines()) {
    delete l;
    return nullptr;
  }
  l->start(n_threads > 0 ? n_threads : 2);
  return l;
}

int64_t dl4j_loader_num_lines(void* handle) {
  return (int64_t) static_cast<Loader*>(handle)->lines.size();
}

// rows dropped by the parser so far (bad numeric fields, wrong column
// count, out-of-range labels); lets the Python side warn instead of
// silently training on a subset
int64_t dl4j_loader_skipped_rows(void* handle) {
  return static_cast<Loader*>(handle)->skipped_rows.load();
}

int dl4j_loader_next(void* handle, float* feat_out, float* lab_out) {
  return static_cast<Loader*>(handle)->next(feat_out, lab_out);
}

void dl4j_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

// Image-tree loader (PNG via read_png; 0/nullptr when built without zlib)
void* dl4j_image_loader_create(const char* root, int batch_size,
                               int height, int width, int channels,
                               int n_threads, int queue_capacity) {
#ifdef DL4J_NO_PNG
  (void)root; (void)batch_size; (void)height; (void)width;
  (void)channels; (void)n_threads; (void)queue_capacity;
  return nullptr;
#else
  auto* l = new ImageLoader();
  l->batch_size = batch_size;
  l->H = height;
  l->W = width;
  l->C = channels == 1 ? 1 : 3;
  l->queue_capacity = queue_capacity > 0 ? queue_capacity : 4;
  if (!l->scan(root)) {
    delete l;
    return nullptr;
  }
  l->start(n_threads > 0 ? n_threads : 4);
  return l;
#endif
}

int dl4j_image_loader_available() {
#ifdef DL4J_NO_PNG
  return 0;
#else
  return 1;
#endif
}

int64_t dl4j_image_loader_num_items(void* handle) {
  return (int64_t) static_cast<ImageLoader*>(handle)->items.size();
}

int dl4j_image_loader_num_classes(void* handle) {
  return (int)static_cast<ImageLoader*>(handle)->classes.size();
}

const char* dl4j_image_loader_class_name(void* handle, int i) {
  return static_cast<ImageLoader*>(handle)->classes[i].c_str();
}

int64_t dl4j_image_loader_skipped(void* handle) {
  return static_cast<ImageLoader*>(handle)->skipped.load();
}

int dl4j_image_loader_next(void* handle, float* feat_out,
                           float* lab_out) {
  return static_cast<ImageLoader*>(handle)->next(feat_out, lab_out);
}

void dl4j_image_loader_destroy(void* handle) {
  delete static_cast<ImageLoader*>(handle);
}

// Count whitespace-separated tokens in a text file using n_threads.
// Returns a handle; query with dl4j_counts_size/get, free with
// dl4j_counts_destroy. Tokens are lowercased; ASCII punctuation
// stripped from token edges (CommonPreprocessor-lite).
void* dl4j_count_words(const char* path, int n_threads) {
  std::ifstream f(path);
  if (!f.is_open()) return nullptr;
  std::string content((std::istreambuf_iterator<char>(f)),
                      std::istreambuf_iterator<char>());
  int nt = n_threads > 0 ? n_threads : 4;
  size_t chunk = content.size() / nt + 1;
  std::vector<std::unordered_map<std::string, int64_t>> partial(nt);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t] {
      size_t start = t * chunk;
      size_t end = std::min(content.size(), start + chunk);
      if (start > 0) {  // skip partial token at chunk head
        while (start < end && !isspace((unsigned char)content[start]))
          ++start;
      }
      // include token spilling past chunk tail
      size_t hard_end = end;
      while (hard_end < content.size() &&
             !isspace((unsigned char)content[hard_end]))
        ++hard_end;
      std::string tok;
      auto flush = [&] {
        if (!tok.empty()) {
          partial[t][tok] += 1;
          tok.clear();
        }
      };
      for (size_t i = start; i < hard_end; ++i) {
        char c = content[i];
        if (isspace((unsigned char)c)) {
          flush();
        } else if (isalnum((unsigned char)c) || c == '\'' || c == '-' ||
                   (unsigned char)c >= 128) {
          tok.push_back((char)tolower((unsigned char)c));
        }
        // other punctuation: dropped
      }
      flush();
    });
  }
  for (auto& t : threads) t.join();
  auto* out = new WordCounts();
  std::unordered_map<std::string, int64_t> merged;
  for (auto& m : partial)
    for (auto& kv : m) merged[kv.first] += kv.second;
  out->words.reserve(merged.size());
  for (auto& kv : merged) {
    out->words.push_back(kv.first);
    out->counts.push_back(kv.second);
  }
  return out;
}

int64_t dl4j_counts_size(void* handle) {
  return (int64_t) static_cast<WordCounts*>(handle)->words.size();
}

const char* dl4j_counts_word(void* handle, int64_t i) {
  return static_cast<WordCounts*>(handle)->words[i].c_str();
}

int64_t dl4j_counts_count(void* handle, int64_t i) {
  return static_cast<WordCounts*>(handle)->counts[i];
}

void dl4j_counts_destroy(void* handle) {
  delete static_cast<WordCounts*>(handle);
}

}  // extern "C"
