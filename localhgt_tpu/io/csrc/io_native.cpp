// Native host IO for the HGT engine.
//
// Replaces the reference engine's in-process FASTQ streaming
// (src/extract_ref_normal_peak.cpp:44-89,981-1107 — byte-range threads that
// re-sync to record boundaries) with a block reader that parses FASTQ records
// into fixed-width base-code matrices ready for device upload. Parsing is
// multithreaded per block using the same record-boundary re-sync idea: each
// thread takes a byte range of the block and advances to the next '@' header
// whose successor lines parse as a record.
//
// Also provides the glibc-rand down-sampling array for strict parity with the
// reference's deterministic per-read-ordinal sampling (get_random,
// cpp:1332-1340).
//
// C ABI only; consumed via ctypes (localhgt_tpu/io/native.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// base codes: A=0 C=1 G=2 T=3, everything else 4
static uint8_t CODE[256];
static bool code_init_done = false;
static void init_codes() {
  if (code_init_done) return;
  memset(CODE, 4, sizeof(CODE));
  CODE[(int)'A'] = 0; CODE[(int)'a'] = 0;
  CODE[(int)'C'] = 1; CODE[(int)'c'] = 1;
  CODE[(int)'G'] = 2; CODE[(int)'g'] = 2;
  CODE[(int)'T'] = 3; CODE[(int)'t'] = 3;
  code_init_done = true;
}

struct FastqReader {
  FILE* f;
  std::vector<char> carry;      // unparsed tail bytes (legacy name)
  std::vector<int64_t> nl;      // newline offsets into `carry`, ascending
  int64_t scan_pos;             // bytes of `carry` already newline-scanned
  int64_t rec_cursor;           // records of `nl` already emitted
  bool at_eof;
  int64_t ordinal;
};

void* lht_fastq_open(const char* path) {
  init_codes();
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new FastqReader();
  r->f = f;
  r->scan_pos = 0;
  r->rec_cursor = 0;
  r->at_eof = false;
  r->ordinal = 0;
  return r;
}

void lht_fastq_close(void* h) {
  auto* r = (FastqReader*)h;
  if (!r) return;
  fclose(r->f);
  delete r;
}

// Parse one block of up to max_reads records.
// codes: uint8[max_reads * width] (pre-filled by caller or overwritten here
// with 4s), lengths: int32[max_reads]. Returns number of records produced;
// 0 at EOF. start_ordinal receives the ordinal of the first read.
int64_t lht_fastq_next_block(void* h, uint8_t* codes, int32_t* lengths,
                             int64_t max_reads, int64_t width,
                             int64_t chunk_bytes, int64_t* start_ordinal,
                             int32_t n_threads) {
  auto* r = (FastqReader*)h;
  if (!r) return -1;
  *start_ordinal = r->ordinal;

  // Top up until max_reads unparsed records (4 newlines each) are
  // buffered. Each stream byte is fread ONCE, memchr-scanned ONCE and
  // parsed in place; the earlier stateless carry design re-copied and
  // re-scanned ~2.7x of the stream (64 MB chunk vs ~24 MB consumed per
  // call) and used a per-byte newline loop — together the big-fixture
  // count stage was host-IO-bound at ~43 MB/s.
  while (!r->at_eof &&
         ((int64_t)r->nl.size() / 4 - r->rec_cursor) < max_reads) {
    int64_t drop = r->rec_cursor * 4;
    if (drop > 0) {  // compact the consumed prefix before growing
      int64_t base = r->nl[drop - 1] + 1;
      r->carry.erase(r->carry.begin(), r->carry.begin() + base);
      r->nl.erase(r->nl.begin(), r->nl.begin() + drop);
      for (auto& v : r->nl) v -= base;
      r->scan_pos -= base;
      r->rec_cursor = 0;
    }
    size_t have = r->carry.size();
    r->carry.resize(have + chunk_bytes);
    size_t got = fread(r->carry.data() + have, 1, chunk_bytes, r->f);
    r->carry.resize(have + got);
    if (got == 0) r->at_eof = true;
    const char* base_p = r->carry.data();
    const char* p = base_p + r->scan_pos;
    const char* end = base_p + r->carry.size();
    while (p < end) {  // SIMD newline scan of the NEW bytes only
      const char* q = (const char*)memchr(p, '\n', (size_t)(end - p));
      if (!q) break;
      r->nl.push_back(q - base_p);
      p = q + 1;
    }
    r->scan_pos = (int64_t)r->carry.size();
  }

  int64_t avail = (int64_t)r->nl.size() / 4 - r->rec_cursor;
  int64_t nrec = avail < max_reads ? avail : max_reads;
  if (nrec <= 0) return 0;  // EOF (any partial trailing record dropped)

  // parse sequence lines (line 4i+1) into codes; buffer always starts at
  // a record boundary (compaction drops whole records only)
  const int64_t* nl = r->nl.data() + r->rec_cursor * 4;
  const char* bufp = r->carry.data();
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      int64_t s = nl[i * 4] + 1;  // sequence line follows the header line
      int64_t e = nl[i * 4 + 1];
      int64_t len = e - s;
      if (len > width) len = width;
      if (len < 0) len = 0;
      lengths[i] = (int32_t)len;
      uint8_t* row = codes + i * width;
      const char* p = bufp + s;
      int64_t j = 0;
      for (; j < len; j++) row[j] = CODE[(uint8_t)p[j]];
      for (; j < width; j++) row[j] = 4;
    }
  };
  if (n_threads <= 1 || nrec < 4096) {
    work(0, nrec);
  } else {
    std::vector<std::thread> ts;
    int64_t per = (nrec + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      int64_t lo = t * per;
      int64_t hi = lo + per;
      if (hi > nrec) hi = nrec;
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  r->rec_cursor += nrec;
  r->ordinal += nrec;
  return nrec;
}

// Total bases on sequence lines + read count (cal_sam_ratio equivalent,
// cpp:1244-1270).
int64_t lht_fastq_count_bases(const char* path, int64_t* n_reads) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  const size_t CH = 1 << 22;
  std::vector<char> buf(CH);
  int64_t total = 0, reads = 0;
  int64_t line = 0;       // current line index
  int64_t linelen = 0;    // bytes so far on the current line
  size_t got;
  while ((got = fread(buf.data(), 1, CH, f)) > 0) {
    for (size_t i = 0; i < got; i++) {
      if (buf[i] == '\n') {
        if ((line & 3) == 1) {
          total += linelen;
          reads++;
        }
        line++;
        linelen = 0;
      } else {
        linelen++;
      }
    }
  }
  fclose(f);
  if (n_reads) *n_reads = reads;
  return total;
}

// glibc-compatible rand stream -> the reference's down-sampling array
// random_array[i] = (rand() % 100000) / 1000.0 (get_random, cpp:1332-1340).
void lht_glibc_random_array(uint32_t seed, int64_t n, float* out) {
  // TYPE_3 additive generator, degree 31, sep 3 (matches GlibcRand in
  // localhgt_tpu/ops/coder.py)
  if (seed == 0) seed = 1;
  std::vector<uint32_t> r(34);
  int32_t word = (int32_t)seed;
  r[0] = (uint32_t)word;
  for (int i = 1; i < 31; i++) {
    int32_t hi = word / 127773;
    int32_t lo = word % 127773;
    word = 16807 * lo - 2836 * hi;
    if (word < 0) word += 2147483647;
    r[i] = (uint32_t)word;
  }
  for (int i = 31; i < 34; i++) r[i] = r[i - 31];
  size_t idx = 34;
  std::vector<uint32_t> ring(r);
  auto next = [&]() -> uint32_t {
    uint32_t w = ring[idx - 31] + ring[idx - 3];
    ring.push_back(w);
    idx++;
    if (ring.size() > (1 << 20)) {  // keep memory bounded
      ring.erase(ring.begin(), ring.end() - 34);
      idx = 34;
    }
    return w;
  };
  for (int i = 34; i < 344; i++) next();
  for (int64_t i = 0; i < n; i++) {
    uint32_t v = next() >> 1;
    out[i] = (float)((double)(v % 100000) / 1000.0);
  }
}

// Seed-and-extend candidate generation for the aligner
// (localhgt_tpu/pipeline/align.py — replaces bwa's seeding; the reference
// runs `bwa mem`, pipeline.sh:48). For each read and both strands, the
// 2-bit packed seed at every `stride`-spaced start position is binary-
// searched in the sorted seed index; up to `max_occ` occurrences per seed
// are emitted as (read, qoff, ref_pos, strand) hits. The reverse-strand
// seed hashes read the base codes backwards with complementation, so the
// reverse-complemented read matrix is never materialized.
//
// Returns the total hit count, or -(needed) if `cap_hits` was too small
// (caller retries with a bigger buffer). Hits are ordered by
// (strand asc via separate halves? no — read asc, offset asc, occ asc,
// strand fw-then-rc per read) — the Python side splits by strand before
// diagonal grouping, making the per-strand order (read, offset, occ),
// identical to the numpy path.
int64_t lht_seed_hits(const uint8_t* codes, const int32_t* lengths,
                      int64_t B, int64_t W,
                      const uint64_t* sorted_hash, const int64_t* sorted_pos,
                      int64_t K, int32_t seed_len, int32_t stride,
                      int32_t max_occ, int32_t n_threads,
                      int32_t* hit_read, int32_t* hit_qoff,
                      int64_t* hit_pos, int8_t* hit_strand,
                      int64_t cap_hits) {
  if (n_threads < 1) n_threads = 1;
  struct Hit { int32_t read; int32_t qoff; int64_t pos; int8_t strand; };
  std::vector<std::vector<Hit>> parts(n_threads);

  auto work = [&](int t, int64_t lo, int64_t hi) {
    auto& out = parts[t];
    for (int64_t r = lo; r < hi; r++) {
      const uint8_t* row = codes + r * W;
      int32_t len = lengths[r];
      if (len > W) len = (int32_t)W;
      int32_t nstart = len - seed_len + 1;
      for (int strand = 0; strand < 2; strand++) {
        for (int32_t o = 0; o < nstart; o += stride) {
          uint64_t h = 0;
          bool ok = true;
          if (strand == 0) {
            for (int z = 0; z < seed_len; z++) {
              uint8_t c = row[o + z];
              if (c >= 4) { ok = false; break; }
              h = (h << 2) | c;
            }
          } else {
            // rc-frame offset o reads original positions len-1-o downward
            for (int z = 0; z < seed_len; z++) {
              uint8_t c = row[len - 1 - o - z];
              if (c >= 4) { ok = false; break; }
              h = (h << 2) | (uint64_t)(3 - c);
            }
          }
          if (!ok) continue;
          // lower_bound / upper_bound over sorted_hash
          int64_t a = 0, b = K;
          while (a < b) { int64_t m = (a + b) >> 1;
            if (sorted_hash[m] < h) a = m + 1; else b = m; }
          int64_t s0 = a;
          b = K;
          while (a < b) { int64_t m = (a + b) >> 1;
            if (sorted_hash[m] <= h) a = m + 1; else b = m; }
          int64_t cnt = a - s0;
          if (cnt > max_occ) cnt = max_occ;
          for (int64_t j = 0; j < cnt; j++)
            out.push_back({(int32_t)r, o, sorted_pos[s0 + j],
                           (int8_t)strand});
        }
      }
    }
  };

  std::vector<std::thread> ths;
  int64_t per = (B + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int64_t lo = t * per, hi = lo + per;
    if (hi > B) hi = B;
    if (lo >= hi) break;
    ths.emplace_back(work, t, lo, hi);
  }
  for (auto& th : ths) th.join();

  int64_t total = 0;
  for (auto& p : parts) total += (int64_t)p.size();
  if (total > cap_hits) return -total;
  int64_t w = 0;
  for (auto& p : parts)
    for (auto& hh : p) {
      hit_read[w] = hh.read; hit_qoff[w] = hh.qoff;
      hit_pos[w] = hh.pos; hit_strand[w] = hh.strand; w++;
    }
  return total;
}

}  // extern "C"
