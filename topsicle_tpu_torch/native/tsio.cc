// tsio: native host input pipeline for topsicle-tpu.
//
// The reference tool's hot host loops live in C libraries it calls from
// Python (zlib decompression, CPython regex, Biopython parsing — see
// SURVEY.md §2.2).  This library is the framework's own native layer:
// block-wise gzip inflate, FASTA/FASTQ parsing, and base encoding in one
// pass, delivering (read id, base codes) batches through a C ABI that
// numpy/ctypes can consume zero-copy.  Also provides the subset-file
// writer (Biopython-compatible formatting: bare '+', 60-column FASTA).
// With keep_records, a reader also keeps what that file needs of each
// read it delivers (its quality beside its codes; tsio_take), so the file
// can be written from the first parse (tsio_emit) instead of a second.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared tsio.cc -o _tsio.so -lz
//
// Base codes match topsicle_tpu.kmers: A=0 C=1 G=2 T=3, others=4
// (case-insensitive).

#include <zlib.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

#include "inflate.h"

namespace {

constexpr size_t kBufSize = 1 << 20;

struct EncodeLut {
  uint8_t t[256];
  EncodeLut() {
    memset(t, 4, sizeof(t));
    t[(unsigned)'A'] = t[(unsigned)'a'] = 0;
    t[(unsigned)'C'] = t[(unsigned)'c'] = 1;
    t[(unsigned)'G'] = t[(unsigned)'g'] = 2;
    t[(unsigned)'T'] = t[(unsigned)'t'] = 3;
  }
};
const EncodeLut kLut;

// Buffered line reader over plain or gzip files (gzFile handles both:
// zlib passes non-gzip data through transparently).
// gunzip::Stream reads a file as gzread reads a gzFile, in its place.
class LineReader {
 public:
  explicit LineReader(const char* path) : gz_(gunzip::Stream::open(path)) {
  }
  ~LineReader() {
    delete gz_;
  }
  bool ok() const { return gz_ != nullptr; }

  // True after a decode/IO failure (e.g. truncated gzip stream) —
  // distinguishes real EOF from a stream that died mid-way.
  bool error() const { return err_; }

  // out[0]: nanoseconds spent inflating; out[1]: the bytes inflated.
  void stats(int64_t* out) const { gz_->stats(out); }

  // Reads one line (without trailing \n / \r\n) into out; false on EOF.
  bool getline(std::string& out) {
    out.clear();
    while (true) {
      if (pos_ >= len_) {
        len_ = gz_->read(buf_, kBufSize);
        pos_ = 0;
        if (len_ <= 0) {
          int errnum = Z_OK;
          gz_->error(&errnum);
          if (len_ < 0 || errnum != Z_OK || (len_ == 0 && !gz_->eof()))
            err_ = true;
          return !out.empty();
        }
      }
      char* nl = static_cast<char*>(memchr(buf_ + pos_, '\n', len_ - pos_));
      if (nl) {
        out.append(buf_ + pos_, nl - (buf_ + pos_));
        pos_ = (nl - buf_) + 1;
        if (!out.empty() && out.back() == '\r') out.pop_back();
        return true;
      }
      out.append(buf_ + pos_, len_ - pos_);
      pos_ = len_;
    }
  }

 private:
  gunzip::Stream* gz_ = nullptr;
  char buf_[kBufSize];
  int pos_ = 0, len_ = 0;
  bool err_ = false;
};

struct Record {
  std::string header;  // without '>'/'@'
  std::string seq;
  std::string qual;  // empty for fasta
};

// Streaming FASTA/FASTQ record parser (format sniffed from first line).
class RecordReader {
 public:
  explicit RecordReader(const char* path) : lr_(path) {
    if (!lr_.ok()) return;
    if (!lr_.getline(line_)) return;
    if (!line_.empty() && line_[0] == '@') fmt_ = 2;
    else if (!line_.empty() && line_[0] == '>') fmt_ = 1;
  }
  int format() const { return fmt_; }
  void inflate_stats(int64_t* out) const { lr_.stats(out); }

  bool next(Record& rec) {
    if (fmt_ == 2) return next_fastq(rec);
    if (fmt_ == 1) return next_fasta(rec);
    return false;
  }

  // 0 = clean; 1 = IO/decode failure (truncated gzip); 2 = malformed
  // record (stream stopped mid-record or on a bad marker line).
  int error() const {
    if (lr_.error()) return 1;
    return malformed_ ? 2 : 0;
  }

 private:
  bool next_fastq(Record& rec) {
    if (done_) return false;
    while (line_.empty()) {  // skip blank separator lines (python parity)
      if (!lr_.getline(line_)) {
        done_ = true;
        return false;
      }
    }
    if (line_[0] != '@') {
      malformed_ = true;
      return false;
    }
    rec.header.assign(line_, 1, std::string::npos);
    // sequence wraps over any number of lines until the '+' separator
    // (Bio.SeqIO envelope; 4-line files take one pass)
    rec.seq.clear();
    bool saw_plus = false;
    while (lr_.getline(line_)) {
      if (!line_.empty() && line_[0] == '+') {
        saw_plus = true;
        break;
      }
      rec.seq += line_;
    }
    if (!saw_plus) {
      malformed_ = true;  // EOF before the '+' line
      return false;
    }
    // quality is length-delimited (lines may start with '@'), never
    // marker-delimited
    rec.qual.clear();
    while (rec.qual.size() < rec.seq.size()) {
      if (!lr_.getline(line_)) {
        malformed_ = true;  // quality shorter than sequence
        return false;
      }
      rec.qual += line_;
    }
    if (rec.qual.size() != rec.seq.size()) {
      malformed_ = true;  // quality overshot the sequence length
      return false;
    }
    if (!lr_.getline(line_)) done_ = true;
    return true;
  }

  bool next_fasta(Record& rec) {
    if (done_) return false;
    if (line_.empty() || line_[0] != '>') return false;
    rec.header.assign(line_, 1, std::string::npos);
    rec.seq.clear();
    rec.qual.clear();
    while (true) {
      if (!lr_.getline(line_)) {
        done_ = true;
        return true;
      }
      if (!line_.empty() && line_[0] == '>') return true;
      rec.seq += line_;
    }
  }

  LineReader lr_;
  std::string line_;
  int fmt_ = 0;
  bool done_ = false;
  bool malformed_ = false;
};

struct Reader {
  RecordReader rr;
  int64_t min_len;
  Record pending;
  bool has_pending = false;
  // every record parsed, its bases, and those at or under min_len
  int64_t records = 0, bases = 0, short_records = 0;
  // keep_records (tsio_next): what the subset file needs of each read
  // delivered since the last tsio_take but its quality, which tsio_next
  // writes out, and a hash of every record's first token (tsio_repeated)
  bool keep = false;
  std::string headers;
  std::vector<int64_t> header_ends;
  std::vector<std::string> raws;  // moved out of their records
  std::vector<uint8_t> plain;
  std::vector<uint64_t> token_hashes;
  bool hashes_sorted = false;
  explicit Reader(const char* path, int64_t ml) : rr(path), min_len(ml) {}
};

std::string first_token(const std::string& header) {
  size_t end = header.find_first_of(" \t");
  return end == std::string::npos ? header : header.substr(0, end);
}

// FNV-1a, 64 bits.
uint64_t fnv1a(const char* s, size_t n) {
  uint64_t h = 14695981039346656037ull;
  for (size_t i = 0; i < n; ++i) h = (h ^ static_cast<unsigned char>(s[i])) * 1099511628211ull;
  return h;
}

// The hash of first_token(header).
uint64_t token_hash(const std::string& header) {
  return fnv1a(header.data(), std::min(header.find_first_of(" \t"), header.size()));
}

// Keeps what the subset file needs of a delivered read whose codes start
// at codes: its quality, written at qual, and its header, whether it is
// plain (every base an uppercase A, C, G or T, so "ACGT"[codes] is its
// sequence) and, where it is not, its sequence.
void keep_record(Reader* r, Record& rec, const uint8_t* codes, char* qual) {
  memcpy(qual, rec.qual.data(), rec.qual.size());
  r->headers += rec.header;
  r->header_ends.push_back(static_cast<int64_t>(r->headers.size()));
  uint8_t bad = 0;  // a code past T, or a lowercase letter
  for (size_t i = 0; i < rec.seq.size(); ++i) bad |= (codes[i] & 0xFC) | (rec.seq[i] & 0x20);
  r->plain.push_back(bad == 0);
  r->raws.push_back(bad ? std::move(rec.seq) : std::string());
}

}  // namespace

extern "C" {

void* tsio_open(const char* path, int64_t min_len) {
  Reader* r = new Reader(path, min_len);
  if (r->rr.format() == 0) {
    delete r;
    return nullptr;
  }
  return r;
}

int tsio_format(void* handle) {
  return handle ? static_cast<Reader*>(handle)->rr.format() : 0;
}

// Delivers up to max_reads eligible reads (len > min_len), encoded.
// codes: concatenated base codes; read_offsets[i+1]-read_offsets[i] is
// read i's length.  ids: concatenated id bytes with id_offsets likewise.
// Returns the number of reads (0 = EOF), or -2 if a read did not fit in
// the remaining buffer space (caller retries with bigger buffers; the
// pending read is preserved).
int64_t tsio_next(void* handle, uint8_t* codes, int64_t codes_cap,
                  int64_t* read_offsets, char* ids, int64_t ids_cap,
                  int keep_records, char* quals,
                  int64_t* id_offsets, int64_t max_reads) {
  Reader* r = static_cast<Reader*>(handle);
  int64_t n = 0, code_pos = 0, id_pos = 0;
  r->keep = keep_records != 0;
  read_offsets[0] = 0;
  id_offsets[0] = 0;
  Record rec;
  while (n < max_reads) {
    if (r->has_pending) {
      rec = std::move(r->pending);
      r->has_pending = false;
    } else if (!r->rr.next(rec)) {
      if (r->rr.error()) return -3;  // truncated/corrupt stream
      break;
    } else {
      ++r->records;
      r->bases += static_cast<int64_t>(rec.seq.size());
      if (r->keep) r->token_hashes.push_back(token_hash(rec.header));
      if (static_cast<int64_t>(rec.seq.size()) <= r->min_len) {
        ++r->short_records;
        continue;
      }
    }
    std::string id = first_token(rec.header);
    if (code_pos + static_cast<int64_t>(rec.seq.size()) > codes_cap ||
        id_pos + static_cast<int64_t>(id.size()) > ids_cap) {
      r->pending = std::move(rec);
      r->has_pending = true;
      return n > 0 ? n : -2;
    }
    for (char c : rec.seq) codes[code_pos++] = kLut.t[(unsigned char)c];
    memcpy(ids + id_pos, id.data(), id.size());
    id_pos += id.size();
    if (r->keep) keep_record(r, rec, codes + code_pos - rec.seq.size(),
                             quals + code_pos - rec.seq.size());
    ++n;
    read_offsets[n] = code_pos;
    id_offsets[n] = id_pos;
  }
  return n;
}

// The handle's records so far: out[0] every record parsed, out[1] their
// bases, out[2] the records at or under min_len (skipped); and its inflate:
// out[3] the nanoseconds spent in it, out[4] the bytes of text it made (0
// for input that is not gzip).
void tsio_stats(void* handle, int64_t* out) {
  const Reader* r = static_cast<const Reader*>(handle);
  out[0] = r->records;
  out[1] = r->bases;
  out[2] = r->short_records;
  r->rr.inflate_stats(out + 3);
}

// With keep_records: the reads kept since the last tsio_take.  out[0]
// gets their header bytes, out[1] the sequence bytes of those that are
// not plain; returns how many reads.
int64_t tsio_kept(void* handle, int64_t* out) {
  const Reader* r = static_cast<const Reader*>(handle);
  out[0] = static_cast<int64_t>(r->headers.size());
  out[1] = 0;
  for (const std::string& raw : r->raws) out[1] += static_cast<int64_t>(raw.size());
  return static_cast<int64_t>(r->plain.size());
}

// Copies the reads kept since the last tsio_take into the caller's
// arrays, sized by tsio_kept, and frees them: headers with header_offs
// (n + 1), plain (n), raw with raw_offs (n + 1; a plain read's is empty).
void tsio_take(void* handle, char* headers, int64_t* header_offs, uint8_t* plain,
               char* raw, int64_t* raw_offs) {
  Reader* r = static_cast<Reader*>(handle);
  memcpy(headers, r->headers.data(), r->headers.size());
  header_offs[0] = raw_offs[0] = 0;
  for (size_t i = 0; i < r->plain.size(); ++i) {
    header_offs[i + 1] = r->header_ends[i];
    plain[i] = r->plain[i];
    memcpy(raw + raw_offs[i], r->raws[i].data(), r->raws[i].size());
    raw_offs[i + 1] = raw_offs[i] + static_cast<int64_t>(r->raws[i].size());
  }
  r->headers.clear();
  r->header_ends.clear();
  r->raws.clear();
  r->plain.clear();
}

// With keep_records, at the end of the input: the hashes of the first
// tokens that more than one record had (short records too), up to cap of
// them into out; returns how many there are.  Sorts the hashes once.
int64_t tsio_repeated(void* handle, uint64_t* out, int64_t cap) {
  Reader* r = static_cast<Reader*>(handle);
  std::vector<uint64_t>& h = r->token_hashes;
  if (!r->hashes_sorted) std::sort(h.begin(), h.end());
  r->hashes_sorted = true;
  int64_t n = 0;
  for (size_t i = 1; i < h.size(); ++i) {
    if (h[i] != h[i - 1] || (i > 1 && h[i - 1] == h[i - 2])) continue;
    if (n < cap) out[n] = h[i];
    ++n;
  }
  return n;
}

// The hash tsio_repeated gives a first token of n bytes.
uint64_t tsio_token_hash(const char* token, int64_t n) {
  return fnv1a(token, static_cast<size_t>(n));
}

// Formats reads idx[0..n) of a kept block as tsio_subset does: FASTQ
// (fastq_out: '@' header, sequence, '+', the quality or as many 'I's)
// or FASTA ('>' header, the sequence in 60-column lines).  A plain read's
// sequence is "ACGT"[codes], another's its raw bytes; quals is null where
// the input has none.  Returns the bytes written to out, or -1 where they
// would pass out_cap.
int64_t tsio_emit(const uint8_t* codes, const int64_t* read_offsets,
                  const char* headers, const int64_t* header_offs,
                  const char* quals, const uint8_t* plain, const char* raw,
                  const int64_t* raw_offs, const int64_t* idx, int64_t n,
                  int fastq_out, char* out, int64_t out_cap) {
  static const char kBases[4] = {'A', 'C', 'G', 'T'};
  char* p = out;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t i = idx[k];
    const int64_t at = read_offsets[i], len = read_offsets[i + 1] - at;
    const int64_t hlen = header_offs[i + 1] - header_offs[i];
    // FASTQ's bytes; FASTA's 60-column lines take no more
    if ((p - out) + hlen + 2 * len + 6 > out_cap) return -1;
    // the sequence's bases [from, from + count) at p
    auto put = [&](int64_t from, int64_t count) {
      if (!plain[i]) {
        memcpy(p, raw + raw_offs[i] + from, count);
        p += count;
        return;
      }
      for (int64_t j = at + from; j < at + from + count; ++j) *p++ = kBases[codes[j]];
    };
    *p++ = fastq_out ? '@' : '>';
    memcpy(p, headers + header_offs[i], hlen);
    p += hlen;
    *p++ = '\n';
    if (fastq_out) {
      put(0, len);
      memcpy(p, "\n+\n", 3);
      p += 3;
      if (quals) memcpy(p, quals + at, len);
      else memset(p, 'I', len);
      p += len;
      *p++ = '\n';
      continue;
    }
    for (int64_t j = 0; j < len; j += 60) {
      put(j, std::min<int64_t>(60, len - j));
      *p++ = '\n';
    }
  }
  return p - out;
}

void tsio_close(void* handle) { delete static_cast<Reader*>(handle); }

// Writes the subset file: records whose id is in ids_joined
// ('\n'-separated), formatted Biopython-style.  fastq_out selects the
// output format (the caller applies the reference's extension rule).
// Returns records written, or -1 on error.
// Where stats is not null, stats[0] gets the seconds spent reading the
// input's records (inflate and parse: RecordReader), on the steady clock.
int64_t tsio_subset(const char* in_path, const char* out_path,
                    const char* ids_joined, int fastq_out, double* stats) {
  std::unordered_set<std::string> keep;
  {
    const char* p = ids_joined;
    while (*p) {
      const char* nl = strchr(p, '\n');
      if (!nl) {
        keep.emplace(p);
        break;
      }
      keep.emplace(p, nl - p);
      p = nl + 1;
    }
  }
  using Clock = std::chrono::steady_clock;
  const Clock::time_point opened = Clock::now();
  RecordReader rr(in_path);
  Clock::duration reading = Clock::now() - opened;
  if (rr.format() == 0) return -1;
  FILE* out = fopen(out_path, "w");
  if (!out) return -1;
  Record rec;
  int64_t written = 0;
  std::string buf;
  while (true) {
    const Clock::time_point t = Clock::now();
    const bool more = rr.next(rec);
    reading += Clock::now() - t;
    if (!more) break;
    if (!keep.count(first_token(rec.header))) continue;
    buf.clear();
    if (fastq_out) {
      buf += '@';
      buf += rec.header;
      buf += '\n';
      buf += rec.seq;
      buf += "\n+\n";
      if (rec.qual.empty()) buf.append(rec.seq.size(), 'I');
      else buf += rec.qual;
      buf += '\n';
    } else {
      buf += '>';
      buf += rec.header;
      buf += '\n';
      for (size_t i = 0; i < rec.seq.size(); i += 60) {
        buf.append(rec.seq, i, std::min<size_t>(60, rec.seq.size() - i));
        buf += '\n';
      }
    }
    if (fwrite(buf.data(), 1, buf.size(), out) != buf.size()) {
      fclose(out);
      remove(out_path);
      return -1;
    }
    ++written;
  }
  if (stats) stats[0] = std::chrono::duration<double>(reading).count();
  fclose(out);
  if (rr.error()) {  // stream died mid-way: the subset is incomplete
    remove(out_path);
    return -1;
  }
  return written;
}

}  // extern "C"
