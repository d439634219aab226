// Native GIF encoder for the serving path (host C++, not a device kernel).
//
// The reference writes GIFs with imageio/Pillow (tuneavideo/util.py:20-32),
// with per-frame adaptive palettes, under the GIL. This encoder is
// dependency-free C++: median-cut shared palette over subsampled pixels, a
// 5-bit/channel inverse color lattice for O(1) pixel mapping, per-frame
// GIF-LZW encoding on worker threads, one sequential file write. A copy of
// the JAX package's csrc/gif_encoder.cpp; built with g++ at first use
// (eeg2video_tpu_torch/data/native.py).
//
// C ABI (ctypes):
//   gif_encode_rgb(frames, n, h, w, delay_cs, path) -> 0 on success
//     frames: n*h*w*3 contiguous uint8 RGB
//     delay_cs: per-frame delay in centiseconds (GIF native unit)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Box {
  std::vector<uint32_t> pixels;  // packed 0xRRGGBB samples
  int ch = 0;   // longest channel (argmax range), cached
  int rng = 0;  // that channel's range, cached
  // One stats pass per box CREATION/SPLIT: the selection loop in median_cut
  // runs up to 255 iterations over all boxes, and rescanning every box's
  // full pixel set there would cost O(splits * total_samples).
  void update_stats() {
    uint8_t lo[3] = {255, 255, 255}, hi[3] = {0, 0, 0};
    for (uint32_t p : pixels) {
      uint8_t c[3] = {(uint8_t)(p >> 16), (uint8_t)(p >> 8), (uint8_t)p};
      for (int i = 0; i < 3; i++) {
        lo[i] = std::min(lo[i], c[i]);
        hi[i] = std::max(hi[i], c[i]);
      }
    }
    ch = 0;
    rng = -1;
    for (int i = 0; i < 3; i++)
      if (hi[i] - lo[i] > rng) { rng = hi[i] - lo[i]; ch = i; }
    if (pixels.empty()) rng = 0;
  }
};

// Median-cut to <=256 colors over the sample set.
static void median_cut(std::vector<uint32_t> samples, uint8_t palette[256][3],
                       int* n_colors) {
  std::vector<Box> boxes(1);
  boxes[0].pixels = std::move(samples);
  boxes[0].update_stats();
  while ((int)boxes.size() < 256) {
    // split the box with the largest channel range (weighted by population)
    int best = -1;
    double best_score = 0;
    for (size_t i = 0; i < boxes.size(); i++) {
      if (boxes[i].pixels.size() < 2) continue;
      double score = (double)boxes[i].rng * boxes[i].pixels.size();
      if (score > best_score) { best_score = score; best = (int)i; }
    }
    if (best < 0 || best_score == 0) break;
    Box& b = boxes[best];
    int ch = b.ch;
    int shift = (2 - ch) * 8;
    auto val = [shift](uint32_t p) { return (p >> shift) & 0xff; };
    std::nth_element(b.pixels.begin(), b.pixels.begin() + b.pixels.size() / 2,
                     b.pixels.end(), [&](uint32_t a, uint32_t c) {
                       return val(a) < val(c);
                     });
    // split at a VALUE boundary, not the median position: a position split
    // scatters every color sharing the median channel value across both
    // halves (they are not sorted within equal values), duplicating colors
    // and exhausting the box budget before distinct colors are isolated
    uint32_t mid = val(b.pixels[b.pixels.size() / 2]);
    auto above = std::partition(b.pixels.begin(), b.pixels.end(),
                                [&](uint32_t p) { return val(p) <= mid; });
    if (above == b.pixels.end()) {  // median value == max: split below it
      above = std::partition(b.pixels.begin(), b.pixels.end(),
                             [&](uint32_t p) { return val(p) < mid; });
    }
    Box hi;
    hi.pixels.assign(above, b.pixels.end());
    b.pixels.resize(above - b.pixels.begin());
    b.update_stats();
    hi.update_stats();
    boxes.push_back(std::move(hi));
  }
  *n_colors = (int)boxes.size();
  for (size_t i = 0; i < boxes.size(); i++) {
    uint64_t s[3] = {0, 0, 0};
    for (uint32_t p : boxes[i].pixels) {
      s[0] += (p >> 16) & 0xff;
      s[1] += (p >> 8) & 0xff;
      s[2] += p & 0xff;
    }
    size_t n = std::max<size_t>(boxes[i].pixels.size(), 1);
    for (int c = 0; c < 3; c++) palette[i][c] = (uint8_t)(s[c] / n);
  }
  for (int i = *n_colors; i < 256; i++)
    palette[i][0] = palette[i][1] = palette[i][2] = 0;
}

// 5-bit/channel inverse lattice: nearest palette index per 32^3 cell.
static void build_inverse_slice(const uint8_t palette[256][3], int n_colors,
                                uint8_t* inv, int r0, int r1) {
  for (int r = r0; r < r1; r++)
    for (int g = 0; g < 32; g++)
      for (int b = 0; b < 32; b++) {
        int rr = r * 8 + 4, gg = g * 8 + 4, bb = b * 8 + 4;
        int best = 0, best_d = 1 << 30;
        for (int i = 0; i < n_colors; i++) {
          int dr = rr - palette[i][0], dg = gg - palette[i][1],
              db = bb - palette[i][2];
          int d = dr * dr + dg * dg + db * db;
          if (d < best_d) { best_d = d; best = i; }
        }
        inv[(r << 10) | (g << 5) | b] = (uint8_t)best;
      }
}

static void build_inverse(const uint8_t palette[256][3], int n_colors,
                          uint8_t inv[32 * 32 * 32]) {
  int nt = std::min(8u, std::max(1u, std::thread::hardware_concurrency()));
  std::vector<std::thread> pool;
  int per = (32 + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int r0 = t * per, r1 = std::min(32, r0 + per);
    if (r0 >= r1) break;
    pool.emplace_back(build_inverse_slice, palette, n_colors, inv, r0, r1);
  }
  for (auto& th : pool) th.join();
}

// GIF-LZW encode one indexed frame into `out` (sub-blocked, with the
// leading min-code-size byte and the trailing 0 block).
struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  std::vector<uint8_t> block;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) { block.reserve(256); }
  void put(uint32_t code, int width) {
    acc |= code << nbits;
    nbits += width;
    while (nbits >= 8) {
      block.push_back((uint8_t)(acc & 0xff));
      acc >>= 8;
      nbits -= 8;
      if (block.size() == 255) flush_block();
    }
  }
  void flush_block() {
    if (block.empty()) return;
    out.push_back((uint8_t)block.size());
    out.insert(out.end(), block.begin(), block.end());
    block.clear();
  }
  void finish() {
    if (nbits > 0) {
      block.push_back((uint8_t)(acc & 0xff));
      if (block.size() == 255) flush_block();
      acc = 0;
      nbits = 0;
    }
    flush_block();
    out.push_back(0);  // block terminator
  }
};

static void lzw_encode(const uint8_t* idx, int64_t n, std::vector<uint8_t>& out) {
  constexpr int MIN_CODE = 8;
  constexpr int CLEAR = 1 << MIN_CODE;   // 256
  constexpr int EOI = CLEAR + 1;         // 257
  constexpr int MAX_CODE = 4096;
  out.push_back(MIN_CODE);
  BitWriter bw(out);

  // hash table: key = (prefix << 8) | next_pixel, value = code
  constexpr int HSIZE = 1 << 15;
  std::vector<int32_t> keys(HSIZE, -1), vals(HSIZE);

  auto reset = [&]() { std::fill(keys.begin(), keys.end(), -1); };

  int width = MIN_CODE + 1;
  int next_code = EOI + 1;
  bw.put(CLEAR, width);
  if (n == 0) { bw.put(EOI, width); bw.finish(); return; }

  int32_t prefix = idx[0];
  for (int64_t i = 1; i < n; i++) {
    int32_t k = (prefix << 8) | idx[i];
    uint32_t h = ((uint32_t)k * 2654435761u) & (HSIZE - 1);
    int32_t found = -1;
    while (keys[h] != -1) {
      if (keys[h] == k) { found = vals[h]; break; }
      h = (h + 1) & (HSIZE - 1);
    }
    if (found >= 0) {
      prefix = found;
      continue;
    }
    bw.put((uint32_t)prefix, width);
    if (next_code < MAX_CODE) {
      keys[h] = k;
      vals[h] = next_code;
      if (next_code == (1 << width) && width < 12) width++;
      next_code++;
    } else {
      bw.put(CLEAR, width);
      width = MIN_CODE + 1;
      next_code = EOI + 1;
      reset();
    }
    prefix = idx[i];
  }
  bw.put((uint32_t)prefix, width);
  bw.put(EOI, width);
  bw.finish();
}

static void put16(std::vector<uint8_t>& v, uint16_t x) {
  v.push_back((uint8_t)(x & 0xff));
  v.push_back((uint8_t)(x >> 8));
}

}  // namespace

extern "C" int gif_encode_rgb(const uint8_t* frames, int64_t n, int64_t h,
                              int64_t w, int delay_cs, const char* path) {
  if (n <= 0 || h <= 0 || w <= 0 || h > 0xffff || w > 0xffff) return 1;
  const int64_t fpx = h * w;

  // shared palette from every 4th pixel (x and y) of all frames
  std::vector<uint32_t> samples;
  samples.reserve((size_t)(n * ((h + 3) / 4) * ((w + 3) / 4)));
  for (int64_t f = 0; f < n; f++) {
    const uint8_t* fr = frames + f * fpx * 3;
    for (int64_t y = 0; y < h; y += 4)
      for (int64_t x = 0; x < w; x += 4) {
        const uint8_t* p = fr + (y * w + x) * 3;
        samples.push_back(((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | p[2]);
      }
  }
  uint8_t palette[256][3];
  int n_colors;
  median_cut(std::move(samples), palette, &n_colors);
  std::vector<uint8_t> inv(32 * 32 * 32);
  build_inverse(palette, n_colors, inv.data());

  // quantize + LZW per frame on worker threads
  std::vector<std::vector<uint8_t>> encoded(n);
  auto work = [&](int64_t f) {
    const uint8_t* fr = frames + f * fpx * 3;
    std::vector<uint8_t> idx((size_t)fpx);
    for (int64_t i = 0; i < fpx; i++) {
      const uint8_t* p = fr + i * 3;
      idx[i] = inv[((p[0] >> 3) << 10) | ((p[1] >> 3) << 5) | (p[2] >> 3)];
    }
    encoded[f].reserve((size_t)fpx / 2);
    lzw_encode(idx.data(), fpx, encoded[f]);
  };
  {
    std::vector<std::thread> pool;
    int nt = std::min<int64_t>(n, std::max(1u, std::thread::hardware_concurrency()));
    for (int t = 0; t < nt; t++)
      pool.emplace_back([&, t]() {
        for (int64_t f = t; f < n; f += nt) work(f);
      });
    for (auto& th : pool) th.join();
  }

  // assemble the file
  std::vector<uint8_t> out;
  out.reserve((size_t)(n * fpx / 2 + 1024));
  const char* hdr = "GIF89a";
  out.insert(out.end(), hdr, hdr + 6);
  put16(out, (uint16_t)w);
  put16(out, (uint16_t)h);
  out.push_back(0xF7);  // GCT present, 8-bit, 256 entries
  out.push_back(0);     // background color
  out.push_back(0);     // aspect
  for (int i = 0; i < 256; i++)
    out.insert(out.end(), palette[i], palette[i] + 3);
  // NETSCAPE loop-forever extension
  const uint8_t loop[] = {0x21, 0xFF, 0x0B, 'N', 'E', 'T', 'S', 'C', 'A',
                          'P', 'E', '2', '.', '0', 0x03, 0x01, 0x00, 0x00, 0x00};
  out.insert(out.end(), loop, loop + sizeof(loop));
  for (int64_t f = 0; f < n; f++) {
    const uint8_t gce[] = {0x21, 0xF9, 0x04, 0x04,
                           (uint8_t)(delay_cs & 0xff),
                           (uint8_t)((delay_cs >> 8) & 0xff), 0x00, 0x00};
    out.insert(out.end(), gce, gce + sizeof(gce));
    out.push_back(0x2C);  // image descriptor
    put16(out, 0);
    put16(out, 0);
    put16(out, (uint16_t)w);
    put16(out, (uint16_t)h);
    out.push_back(0);  // no LCT, no interlace
    out.insert(out.end(), encoded[f].begin(), encoded[f].end());
  }
  out.push_back(0x3B);  // trailer

  FILE* fp = std::fopen(path, "wb");
  if (!fp) return 2;
  size_t written = std::fwrite(out.data(), 1, out.size(), fp);
  std::fclose(fp);
  return written == out.size() ? 0 : 3;
}
