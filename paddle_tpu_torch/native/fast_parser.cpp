// Native data-feed parser (the C++ half of the input pipeline).
//
// Reference analog: paddle/fluid/framework/data_feed.cc (MultiSlotDataFeed
// ParseOneInstance + the multi-threaded channel readers behind
// framework/data_set.h). The reference parses slot-text CTR data on C++
// threads because Python parsing starves the GPUs; the same holds for TPUs.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image):
//   parse_slot_file(path, n_slots, out_buf, out_cap, row_offsets, max_rows)
// parses "v v v;v v;..." lines into a flat float32 buffer, multi-threaded by
// line ranges. Python assembles numpy views per slot (zero extra copies).
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// Parse a slot-text file.
//   path:      input file
//   n_slots:   expected ';'-separated slots per line
//   out:       caller-allocated float32 buffer (flat, row-major by line)
//   out_cap:   capacity of `out` in floats
//   slot_width: caller-allocated int64[n_slots]; filled with the per-slot
//              value count of the FIRST line (the file must be rectangular,
//              like the reference's MultiSlot fixed-size slots)
//   n_threads: worker threads (<=0 -> hardware_concurrency)
// Returns the number of lines parsed, or a negative error code:
//   -1 open failed, -2 ragged line, -3 buffer too small, -4 bad float.
int64_t parse_slot_file(const char* path, int64_t n_slots, float* out,
                        int64_t out_cap, int64_t* slot_width,
                        int32_t n_threads) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(size);
  if (size && std::fread(&buf[0], 1, size, f) != (size_t)size) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  // index line starts (skip empty lines)
  std::vector<std::pair<const char*, const char*>> lines;
  const char* p = buf.data();
  const char* end = p + buf.size();
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    const char* le = nl ? nl : end;
    const char* q = p;
    while (q < le && (*q == ' ' || *q == '\r' || *q == '\t')) ++q;
    if (q < le) lines.emplace_back(p, le);
    p = nl ? nl + 1 : end;
  }
  if (lines.empty()) return 0;

  // measure first line -> per-slot widths and row stride
  {
    const char* q = lines[0].first;
    const char* le = lines[0].second;
    int64_t slot = 0, count = 0;
    bool in_tok = false;
    for (const char* c = q; c <= le; ++c) {
      bool sep = (c == le) || *c == ' ' || *c == ';' || *c == '\r';
      if (!sep) { in_tok = true; continue; }
      if (in_tok) { ++count; in_tok = false; }
      if (c < le && *c == ';') {
        if (slot >= n_slots) return -2;
        slot_width[slot++] = count;
        count = 0;
      }
    }
    if (slot != n_slots - 1) return -2;
    slot_width[slot] = count;
  }
  int64_t stride = 0;
  for (int64_t s = 0; s < n_slots; ++s) stride += slot_width[s];
  if ((int64_t)lines.size() * stride > out_cap) return -3;

  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if ((size_t)nt > lines.size()) nt = (int)lines.size();
  std::vector<int64_t> status(nt, 0);

  auto work = [&](int tid) {
    size_t lo = lines.size() * tid / nt;
    size_t hi = lines.size() * (tid + 1) / nt;
    for (size_t i = lo; i < hi; ++i) {
      const char* c = lines[i].first;
      const char* le = lines[i].second;
      float* row = out + (int64_t)i * stride;
      int64_t k = 0;
      // per-slot width validation: a misplaced ';' must error, not silently
      // shift values into the next column
      int64_t slot = 0, in_slot = 0;
      while (c <= le) {
        if (c == le || *c == ';') {
          if (slot >= n_slots || in_slot != slot_width[slot]) {
            status[tid] = -2;
            return;
          }
          ++slot;
          in_slot = 0;
          if (c == le) break;
          ++c;
          continue;
        }
        if (*c == ' ' || *c == '\r' || *c == '\t') { ++c; continue; }
        char* tail = nullptr;
        float v = strtof(c, &tail);
        if (tail == c) { status[tid] = -4; return; }
        if (k >= stride) { status[tid] = -2; return; }
        row[k++] = v;
        ++in_slot;
        c = tail;
      }
      if (k != stride || slot != n_slots) { status[tid] = -2; return; }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) ts.emplace_back(work, t);
  for (auto& t : ts) t.join();
  for (int t = 0; t < nt; ++t)
    if (status[t] != 0) return status[t];
  return (int64_t)lines.size();
}

}  // extern "C"
