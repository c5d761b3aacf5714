// feddata — the host data plane of commefficient_torch (its own copy of
// the JAX package's native/feddata.cpp; host C++, no device code).
//
// Fused image-batch assembly (pad/crop/flip/to-float/normalize), the fused
// crop/bilinear-resize/flip/normalize of one variable-size image (the
// ImageNet transforms), and a restricted-schema LEAF FEMNIST JSON parser.
// Exposed through a plain C ABI and loaded from Python with ctypes
// (commefficient_torch/native.py), which releases the GIL for each call,
// so the prefetch thread overlaps batch assembly with device work.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread feddata.cpp -o libfeddata.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// threading: static partition of [0, n) over up to `nthreads` std::threads
// ---------------------------------------------------------------------------

template <typename F>
void parallel_for(long long n, int nthreads, long long work_per_item,
                  F&& body) {
  if (n <= 0) return;
  unsigned hw = std::thread::hardware_concurrency();
  int t = nthreads > 0 ? nthreads : (hw ? (int)hw : 1);
  if ((long long)t > n) t = (int)n;
  // clamp by work volume: ~256K elements of work per thread minimum, so
  // tiny batches don't pay thread spawn/join overhead
  const long long grain = 1 << 18;
  long long total = n * std::max((long long)1, work_per_item);
  if ((long long)t > total / grain) t = (int)std::max((long long)1, total / grain);
  if (t <= 1) {
    for (long long i = 0; i < n; ++i) body(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  long long chunk = (n + t - 1) / t;
  for (int w = 0; w < t; ++w) {
    long long lo = w * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([lo, hi, &body] {
      for (long long i = lo; i < hi; ++i) body(i);
    });
  }
  for (auto& th : pool) th.join();
}

// numpy-'reflect' index (no edge repeat): fold t into [0, n)
inline int reflect_idx(int t, int n) {
  if (n == 1) return 0;
  while (t < 0 || t >= n) t = (t < 0) ? -t : 2 * n - 2 - t;
  return t;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// fd_image_batch — fused pad/crop/flip/to-float/normalize batch assembly.
//
// src:     (N, H, W, C) uint8 (src_is_u8=1) or float32, contiguous
// indices: (M,) int64 rows into src; idx < 0 → all-zero output slot
// crop_h/crop_w: (M,) int32 top-left of the crop in the padded image
// flip:    (M,) uint8 nonzero → horizontal flip
// pad:     reflect padding applied on each side before cropping (0 = none)
// size:    output spatial size (crop window)
// mean/std:(C,) float32 channel normalization (applied after /255 for u8)
// out:     (M, size, size, C) float32
// ---------------------------------------------------------------------------
void fd_image_batch(const void* src, int src_is_u8, long long N, int H, int W,
                    int C, const long long* indices, const int* crop_h,
                    const int* crop_w, const unsigned char* flip, long long M,
                    int pad, int size, const float* mean, const float* stddev,
                    float* out, int nthreads) {
  (void)N;
  const long long row = (long long)H * W * C;
  const long long orow = (long long)size * size * C;
  std::vector<float> inv_std(C), meanv(C);
  for (int c = 0; c < C; ++c) {
    inv_std[c] = 1.0f / stddev[c];
    meanv[c] = mean[c];
  }
  const float u8scale = 1.0f / 255.0f;

  parallel_for(M, nthreads, orow, [&](long long m) {
    float* dst = out + m * orow;
    long long idx = indices[m];
    if (idx < 0) {
      std::memset(dst, 0, sizeof(float) * orow);
      return;
    }
    const uint8_t* s8 = src_is_u8 ? (const uint8_t*)src + idx * row : nullptr;
    const float* sf = src_is_u8 ? nullptr : (const float*)src + idx * row;
    const int ch = crop_h ? crop_h[m] : 0;
    const int cw = crop_w ? crop_w[m] : 0;
    const bool fl = flip && flip[m];
    for (int i = 0; i < size; ++i) {
      const int sy = reflect_idx(ch + i - pad, H);
      const long long yoff = (long long)sy * W * C;
      for (int j = 0; j < size; ++j) {
        const int oj = fl ? (size - 1 - j) : j;
        const int sx = reflect_idx(cw + j - pad, W);
        const long long soff = yoff + (long long)sx * C;
        float* d = dst + ((long long)i * size + oj) * C;
        if (src_is_u8) {
          for (int c = 0; c < C; ++c)
            d[c] = ((float)s8[soff + c] * u8scale - meanv[c]) * inv_std[c];
        } else {
          for (int c = 0; c < C; ++c)
            d[c] = (sf[soff + c] - meanv[c]) * inv_std[c];
        }
      }
    }
  });
}

// ---------------------------------------------------------------------------
// fd_resized_crop — fused crop/bilinear-resize/flip/to-float/normalize for
// ONE variable-size image (the ImageNet train/val transform hot path:
// RandomResizedCrop / Resize+CenterCrop run per item on disk-decoded images
// of varying shape, so no contiguous batch store exists; the numpy bilinear
// builds four (out_h, out_w, C) temporaries per image, this is one tight
// pass).
//
// src:      (H, W, C) uint8 (src_is_u8=1) or float32, contiguous
// box:      (by, bx, bh, bw) crop window in source coords; floats so the
//           val path can express Resize(s)+CenterCrop(k) exactly as an
//           affine sample (by = i0*H/oh, bh = k*H/oh)
// clip_mode 0: clip sample indices to the box window [0, ceil(bh)-1] and
//           offset by by (integral-box crop-then-resize, the train path);
//           1: clip to the full image [0, H-1] after adding the float
//           offset (the val path's resize-then-crop)
// flip:     nonzero -> horizontal flip of the output
// out:      (out_h, out_w, C) float32, normalized
// ---------------------------------------------------------------------------
void fd_resized_crop(const void* src, int src_is_u8, int H, int W, int C,
                     float by, float bx, float bh, float bw, int clip_mode,
                     int out_h, int out_w, int flip, const float* mean,
                     const float* stddev, float* out, int nthreads) {
  const uint8_t* s8 = src_is_u8 ? (const uint8_t*)src : nullptr;
  const float* sf = src_is_u8 ? nullptr : (const float*)src;
  std::vector<float> inv_std(C), meanv(C);
  for (int c = 0; c < C; ++c) {
    inv_std[c] = 1.0f / stddev[c];
    meanv[c] = mean[c];
  }
  const float u8scale = 1.0f / 255.0f;
  // per-column sample indices/weights, computed once
  std::vector<int> x0v(out_w), x1v(out_w);
  std::vector<float> wxv(out_w);
  for (int j = 0; j < out_w; ++j) {
    float xs = ((float)j + 0.5f) * bw / (float)out_w - 0.5f;
    int x0, x1;
    float wx;
    if (clip_mode == 0) {
      int hi = (int)std::ceil(bw) - 1;
      x0 = std::min(std::max((int)std::floor(xs), 0), hi);
      x1 = std::min(x0 + 1, hi);
      wx = std::min(std::max(xs - (float)x0, 0.0f), 1.0f);
      x0 += (int)bx;
      x1 += (int)bx;
    } else {
      float p = xs + bx;
      x0 = std::min(std::max((int)std::floor(p), 0), W - 1);
      x1 = std::min(x0 + 1, W - 1);
      wx = std::min(std::max(p - (float)x0, 0.0f), 1.0f);
    }
    x0v[j] = x0;
    x1v[j] = x1;
    wxv[j] = wx;
  }
  parallel_for(out_h, nthreads, (long long)out_w * C * 8, [&](long long i) {
    float ys = ((float)i + 0.5f) * bh / (float)out_h - 0.5f;
    int y0, y1;
    float wy;
    if (clip_mode == 0) {
      int hi = (int)std::ceil(bh) - 1;
      y0 = std::min(std::max((int)std::floor(ys), 0), hi);
      y1 = std::min(y0 + 1, hi);
      wy = std::min(std::max(ys - (float)y0, 0.0f), 1.0f);
      y0 += (int)by;
      y1 += (int)by;
    } else {
      float p = ys + by;
      y0 = std::min(std::max((int)std::floor(p), 0), H - 1);
      y1 = std::min(y0 + 1, H - 1);
      wy = std::min(std::max(p - (float)y0, 0.0f), 1.0f);
    }
    const long long r0 = (long long)y0 * W * C, r1 = (long long)y1 * W * C;
    for (int j = 0; j < out_w; ++j) {
      const int oj = flip ? (out_w - 1 - j) : j;
      const long long c00 = r0 + (long long)x0v[j] * C;
      const long long c01 = r0 + (long long)x1v[j] * C;
      const long long c10 = r1 + (long long)x0v[j] * C;
      const long long c11 = r1 + (long long)x1v[j] * C;
      const float wx = wxv[j];
      float* d = out + ((long long)i * out_w + oj) * C;
      for (int c = 0; c < C; ++c) {
        float a, b, cc, dd;
        if (src_is_u8) {
          a = (float)s8[c00 + c] * u8scale;
          b = (float)s8[c01 + c] * u8scale;
          cc = (float)s8[c10 + c] * u8scale;
          dd = (float)s8[c11 + c] * u8scale;
        } else {
          a = sf[c00 + c];
          b = sf[c01 + c];
          cc = sf[c10 + c];
          dd = sf[c11 + c];
        }
        float v = a * (1.0f - wy) * (1.0f - wx) + b * (1.0f - wy) * wx
                  + cc * wy * (1.0f - wx) + dd * wy * wx;
        d[c] = (v - meanv[c]) * inv_std[c];
      }
    }
  });
}

// ---------------------------------------------------------------------------
// LEAF FEMNIST JSON parsing (the orjson replacement).
//
// Restricted-schema parser for LEAF shard files:
//   {"users": [...], "num_samples": [...],
//    "user_data": {"<u>": {"x": [[f, ...], ...], "y": [i, ...]}, ...}}
// Two-call protocol: fd_leaf_open parses and returns a handle (−1 on any
// parse error — caller falls back to a Python json parse), fd_leaf_counts
// reports sizes, fd_leaf_fill copies into caller-allocated numpy buffers.
// ---------------------------------------------------------------------------

namespace {

struct LeafData {
  std::vector<float> x;                 // total_items * feat_dim
  std::vector<long long> y;             // total_items
  std::vector<long long> offsets;       // n_users + 1
  std::string names;                    // '\n'-joined user names, in order
  long long feat_dim = 0;
};

struct Parser {
  const char* p;
  const char* end;
  bool ok = true;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }
  bool lit(char c) {
    ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    ok = false;
    return false;
  }
  bool peek(char c) {
    ws();
    return p < end && *p == c;
  }
  // parse a JSON string (handling escapes) into out
  bool str(std::string* out) {
    if (!lit('"')) return false;
    out->clear();
    while (p < end && *p != '"') {
      char c = *p++;
      if (c == '\\' && p < end) {
        char e = *p++;
        switch (e) {
          case 'n': c = '\n'; break;
          case 't': c = '\t'; break;
          case 'r': c = '\r'; break;
          case 'b': c = '\b'; break;
          case 'f': c = '\f'; break;
          case 'u': {
            // decode ASCII escapes; reject non-ASCII code points so the
            // caller falls back to the Python json parser (which handles
            // full unicode) instead of silently corrupting usernames
            if (end - p < 4) { ok = false; return false; }
            int code = 0;
            for (int k = 0; k < 4; ++k) {
              char h = *p++;
              code <<= 4;
              if (h >= '0' && h <= '9') code |= h - '0';
              else if (h >= 'a' && h <= 'f') code |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') code |= h - 'A' + 10;
              else { ok = false; return false; }
            }
            if (code > 0x7f) { ok = false; return false; }
            c = (char)code;
            break;
          }
          default: c = e;
        }
      }
      out->push_back(c);
    }
    return lit('"');
  }
  double num() {
    ws();
    char* endp = nullptr;
    double v = std::strtod(p, &endp);
    if (endp == p) {
      ok = false;
      return 0.0;
    }
    p = endp;
    return v;
  }
  // skip any JSON value
  void skip() {
    ws();
    if (p >= end) { ok = false; return; }
    char c = *p;
    if (c == '{') {
      ++p;
      ws();
      if (peek('}')) { lit('}'); return; }
      while (ok) {
        std::string k;
        if (!str(&k)) return;
        if (!lit(':')) return;
        skip();
        if (peek(',')) { lit(','); continue; }
        lit('}');
        return;
      }
    } else if (c == '[') {
      ++p;
      ws();
      if (peek(']')) { lit(']'); return; }
      while (ok) {
        skip();
        if (peek(',')) { lit(','); continue; }
        lit(']');
        return;
      }
    } else if (c == '"') {
      std::string s;
      str(&s);
    } else if (std::strncmp(p, "true", 4) == 0) {
      p += 4;
    } else if (std::strncmp(p, "false", 5) == 0) {
      p += 5;
    } else if (std::strncmp(p, "null", 4) == 0) {
      p += 4;
    } else {
      num();
    }
  }
};

std::mutex g_leaf_mu;
std::map<long long, LeafData*> g_leaf;
std::atomic<long long> g_leaf_next{1};

}  // namespace

long long fd_leaf_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(sz);
  if (sz > 0 && std::fread(&buf[0], 1, sz, f) != (size_t)sz) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  auto data = new LeafData();
  data->offsets.push_back(0);
  Parser ps{buf.data(), buf.data() + buf.size()};

  if (!ps.lit('{')) { delete data; return -1; }
  bool first = true;
  while (ps.ok) {
    if (!first && ps.peek(',')) ps.lit(',');
    if (ps.peek('}')) { ps.lit('}'); break; }
    first = false;
    std::string key;
    if (!ps.str(&key) || !ps.lit(':')) break;
    if (key != "user_data") {
      ps.skip();
      continue;
    }
    // user_data: {"name": {"x": [[...]...], "y": [...]}, ...}
    if (!ps.lit('{')) break;
    if (ps.peek('}')) { ps.lit('}'); continue; }
    while (ps.ok) {
      std::string user;
      if (!ps.str(&user) || !ps.lit(':')) break;
      if (!ps.lit('{')) break;
      long long n_items_x = 0, n_items_y = 0;
      while (ps.ok) {
        std::string field;
        if (!ps.str(&field) || !ps.lit(':')) break;
        if (field == "x") {
          if (!ps.lit('[')) break;
          if (ps.peek(']')) { ps.lit(']'); }
          else {
            while (ps.ok) {
              if (!ps.lit('[')) break;
              long long dim = 0;
              if (ps.peek(']')) { ps.lit(']'); }
              else {
                while (ps.ok) {
                  data->x.push_back((float)ps.num());
                  ++dim;
                  if (ps.peek(',')) { ps.lit(','); continue; }
                  ps.lit(']');
                  break;
                }
              }
              if (data->feat_dim == 0) data->feat_dim = dim;
              else if (dim != data->feat_dim) { ps.ok = false; break; }
              ++n_items_x;
              if (ps.peek(',')) { ps.lit(','); continue; }
              ps.lit(']');
              break;
            }
          }
        } else if (field == "y") {
          if (!ps.lit('[')) break;
          if (ps.peek(']')) { ps.lit(']'); }
          else {
            while (ps.ok) {
              data->y.push_back((long long)ps.num());
              ++n_items_y;
              if (ps.peek(',')) { ps.lit(','); continue; }
              ps.lit(']');
              break;
            }
          }
        } else {
          ps.skip();
        }
        if (ps.peek(',')) { ps.lit(','); continue; }
        ps.lit('}');
        break;
      }
      if (!ps.ok || n_items_x != n_items_y) { ps.ok = false; break; }
      if (user.find('\n') != std::string::npos) { ps.ok = false; break; }
      if (!data->names.empty()) data->names.push_back('\n');
      data->names += user;
      data->offsets.push_back(data->offsets.back() + n_items_x);
      if (ps.peek(',')) { ps.lit(','); continue; }
      ps.lit('}');
      break;
    }
  }

  if (!ps.ok || data->offsets.size() <= 1) {
    delete data;
    return -1;
  }
  long long h = g_leaf_next++;
  std::lock_guard<std::mutex> lk(g_leaf_mu);
  g_leaf[h] = data;
  return h;
}

void fd_leaf_counts(long long h, long long* n_users, long long* total_items,
                    long long* feat_dim, long long* name_bytes) {
  std::lock_guard<std::mutex> lk(g_leaf_mu);
  auto it = g_leaf.find(h);
  if (it == g_leaf.end()) {
    *n_users = *total_items = *feat_dim = *name_bytes = 0;
    return;
  }
  *n_users = (long long)it->second->offsets.size() - 1;
  *total_items = (long long)it->second->y.size();
  *feat_dim = it->second->feat_dim;
  *name_bytes = (long long)it->second->names.size();
}

// copies the '\n'-joined user names (no trailing NUL) into buf
void fd_leaf_names(long long h, char* buf) {
  std::lock_guard<std::mutex> lk(g_leaf_mu);
  auto it = g_leaf.find(h);
  if (it == g_leaf.end()) return;
  std::memcpy(buf, it->second->names.data(), it->second->names.size());
}

void fd_leaf_fill(long long h, float* x_out, long long* y_out,
                  long long* offsets_out) {
  std::lock_guard<std::mutex> lk(g_leaf_mu);
  auto it = g_leaf.find(h);
  if (it == g_leaf.end()) return;
  LeafData* d = it->second;
  std::memcpy(x_out, d->x.data(), d->x.size() * sizeof(float));
  std::memcpy(y_out, d->y.data(), d->y.size() * sizeof(long long));
  std::memcpy(offsets_out, d->offsets.data(),
              d->offsets.size() * sizeof(long long));
}

void fd_leaf_close(long long h) {
  std::lock_guard<std::mutex> lk(g_leaf_mu);
  auto it = g_leaf.find(h);
  if (it != g_leaf.end()) {
    delete it->second;
    g_leaf.erase(it);
  }
}

}  // extern "C"
