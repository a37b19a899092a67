// inflate.h: the gzip inflate of tsio.cc's LineReader.
//
// A streaming DEFLATE decoder (RFC 1951) inside the gzip envelope (RFC 1952),
// reading a file the way zlib's gzread does: concatenated members (BGZF and
// multi-chunk ONT files), trailing bytes after a member that do not start
// another member ignored, input that does not start with the gzip magic
// passed through as it is, and each member's CRC-32 and ISIZE checked.
//
// The decode loop is built the way libdeflate builds its own: a 64-bit bit
// buffer refilled without branches by unaligned 8-byte loads, packed table
// entries that carry a symbol's value, codeword length and extra bits (a
// 2^11-entry literal/length table and a 2^8-entry distance table, each with
// subtables for longer codewords), up to three literals a refill, and
// matches copied a word at a time.  Near the ends of its buffers a careful
// path decodes one symbol at a time and gives the same bytes.
//
// It streams with gzread's memory: a 1 MiB input buffer read with fread,
// refilled whenever less than a block header's worth is left, so no symbol
// is cut; and an output buffer of 32 KiB of history plus 1 MiB, of which
// only the history is moved when it wraps.

#ifndef TOPSICLE_TSIO_INFLATE_H_
#define TOPSICLE_TSIO_INFLATE_H_

#include <zlib.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace gunzip {

constexpr size_t kInSize = 1 << 20;    // the input buffer
constexpr size_t kWindow = 1 << 15;    // DEFLATE's history
constexpr size_t kOutSize = 1 << 20;   // the output a fill produces at most
// Input kept in the buffer before a step when the file has more: a dynamic
// block header takes under 300 bytes.
constexpr size_t kInKeep = 1024;
// The fast loop's margins: two 8-byte refills an iteration; three literals
// or two and a match of 258 bytes, whose word copy writes up to 7 past it.
constexpr size_t kFastIn = 32;
constexpr size_t kFastOut = 320;

// Table entries: bits 31-16 the literal, length base, distance base or
// subtable start; bits 11-8 the codeword length (a subtable pointer: its
// index bits); bits 7-0 the codeword length plus the extra bits.
constexpr uint32_t kLiteral = 1u << 15;
constexpr uint32_t kExceptional = 1u << 14;   // end of block, or an invalid code
constexpr uint32_t kSubtable = 1u << 13;
constexpr uint32_t kEndOfBlock = 1u << 12;

constexpr int kLitBits = 11, kDistBits = 8, kPreBits = 7, kMaxLen = 15;
// A subtable a codeword longer than the main table's bits, at most
constexpr int kLitTableSize = (1 << kLitBits) + 288 * (1 << (kMaxLen - kLitBits));
constexpr int kDistTableSize = (1 << kDistBits) + 32 * (1 << (kMaxLen - kDistBits));

constexpr uint16_t kLengthBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                      31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr uint8_t kLengthExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                      2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                    33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                    1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
constexpr uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                    6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
// The order of the code length code's lengths in a dynamic block header
constexpr uint8_t kPrecodeOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

inline void store64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }

// The entry a lookup of bits finds: the main table's, or its subtable's.
template <int kBits>
inline uint32_t lookup(const uint32_t* table, uint64_t bits) {
  uint32_t e = table[bits & ((1u << kBits) - 1)];
  if (e & kSubtable)
    e = table[(e >> 16) + ((bits >> kBits) & ((1u << ((e >> 8) & 0xF)) - 1))];
  return e;
}

// An entry's value: its base plus its extra bits, read from bits as they
// were before the entry's codeword was consumed.
inline uint32_t value(uint32_t e, uint64_t bits) {
  return (e >> 16) + static_cast<uint32_t>((bits & ((1ull << (e & 0xFF)) - 1)) >> ((e >> 8) & 0xF));
}

inline uint32_t lit_entry(int sym, int len) {
  const uint32_t cw = static_cast<uint32_t>(len) << 8 | len;
  if (sym < 256) return kLiteral | static_cast<uint32_t>(sym) << 16 | cw;
  if (sym == 256) return kExceptional | kEndOfBlock | cw;
  if (sym > 285) return kExceptional | cw;
  return static_cast<uint32_t>(kLengthBase[sym - 257]) << 16 | (cw + kLengthExtra[sym - 257]);
}

inline uint32_t dist_entry(int sym, int len) {
  const uint32_t cw = static_cast<uint32_t>(len) << 8 | len;
  if (sym > 29) return kExceptional | cw;
  return static_cast<uint32_t>(kDistBase[sym]) << 16 | (cw + kDistExtra[sym]);
}

inline uint32_t pre_entry(int sym, int len) {
  return static_cast<uint32_t>(sym) << 16 | static_cast<uint32_t>(len) << 8 | len;
}

struct BitReverse {
  uint8_t t[256];
  BitReverse() {
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int b = 0; b < 8; ++b) r |= ((i >> b) & 1) << (7 - b);
      t[i] = static_cast<uint8_t>(r);
    }
  }
  // The low len bits of c, in reverse order.
  uint32_t operator()(uint32_t c, int len) const {
    return (static_cast<uint32_t>(t[c & 0xFF]) << 8 | t[c >> 8]) >> (16 - len);
  }
};
const BitReverse kReverse;

// Builds the decode table of the canonical Huffman code with lengths
// lens[0..n), with entry(sym, len) for each symbol.  False where zlib
// refuses the lengths: over-subscribed, or incomplete unless the code has
// no codeword or one of length 1 (allow_incomplete; the code length code
// is never incomplete).  Codewords past kBits go to subtables of
// 2^(longest - kBits) entries after the main table.
template <int kBits, typename Entry>
bool build(uint32_t* table, const uint8_t* lens, int n, bool allow_incomplete, Entry entry) {
  int count[kMaxLen + 1] = {0};
  for (int s = 0; s < n; ++s) ++count[lens[s]];
  count[0] = 0;
  int longest = kMaxLen;
  while (longest > 0 && count[longest] == 0) --longest;
  int left = 1;
  for (int len = 1; len <= kMaxLen; ++len) {
    left = (left << 1) - count[len];
    if (left < 0) return false;
  }
  if (left > 0) {
    if (!allow_incomplete || longest > 1) return false;
    std::fill(table, table + (1 << kBits), kExceptional);
  }
  uint32_t next[kMaxLen + 2];
  uint32_t code = 0;
  for (int len = 1; len <= kMaxLen; ++len) {
    code = (code + count[len - 1]) << 1;
    next[len] = code;
  }
  const uint32_t main_mask = (1u << kBits) - 1;
  for (int s = 0; s < n; ++s) {   // codewords that fit the main table
    const int len = lens[s];
    if (len == 0) continue;
    const uint32_t r = kReverse(next[len]++, len);
    if (len > kBits) {
      table[r & main_mask] = 0;   // a subtable is made below
      continue;
    }
    const uint32_t e = entry(s, len);
    for (uint32_t i = r; i <= main_mask; i += 1u << len) table[i] = e;
  }
  if (longest <= kBits) return true;
  const int sub_bits = longest - kBits;
  uint32_t sub_end = 1u << kBits;
  code = 0;
  for (int len = 1; len <= kMaxLen; ++len) {
    code = (code + count[len - 1]) << 1;
    next[len] = code;
  }
  for (int s = 0; s < n; ++s) {   // longer codewords
    const int len = lens[s];
    if (len == 0) continue;
    const uint32_t r = kReverse(next[len]++, len);
    if (len <= kBits) continue;
    uint32_t& ptr = table[r & main_mask];
    if (!(ptr & kSubtable)) {
      ptr = sub_end << 16 | kSubtable | static_cast<uint32_t>(sub_bits) << 8;
      sub_end += 1u << sub_bits;
    }
    const uint32_t e = entry(s, len);
    const uint32_t start = ptr >> 16;
    for (uint32_t i = r >> kBits; i < (1u << sub_bits); i += 1u << (len - kBits))
      table[start + i] = e;
  }
  return true;
}

// The tables of a fixed Huffman block.
struct FixedTables {
  uint32_t lit[1 << kLitBits];
  uint32_t dist[1 << kDistBits];
  FixedTables() {
    uint8_t lens[288];
    std::fill(lens, lens + 144, 8);
    std::fill(lens + 144, lens + 256, 9);
    std::fill(lens + 256, lens + 280, 7);
    std::fill(lens + 280, lens + 288, 8);
    build<kLitBits>(lit, lens, 288, true, lit_entry);
    std::fill(lens, lens + 32, 5);
    build<kDistBits>(dist, lens, 32, true, dist_entry);
  }
};
const FixedTables kFixed;

#if defined(__x86_64__)
#define TSIO_CLMUL __attribute__((target("pclmul,sse4.1")))

TSIO_CLMUL inline __m128i load128(const uint8_t* p) {
  return _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
}

// x times k folded onto y: x's low half by k's low, its high half by k's high.
TSIO_CLMUL inline __m128i fold(__m128i x, __m128i k, __m128i y) {
  return _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x, k, 0x00),
                                     _mm_clmulepi64_si128(x, k, 0x11)), y);
}

// The CRC-32 of len bytes (a multiple of 16, at least 64) by carry-less
// multiplication, folding 64 bytes at a time: Gopal et al., "Fast CRC
// Computation for Generic Polynomials Using PCLMULQDQ Instruction" (Intel,
// 2009), with the bit-reflected constants of gzip's polynomial.  crc is the
// register inverted, as the paper takes it and gives it.
TSIO_CLMUL inline uint32_t crc32_fold(const uint8_t* p, size_t len, uint32_t crc) {
  const __m128i k1k2 = _mm_set_epi64x(0x01c6e41596, 0x0154442bd4);
  const __m128i k3k4 = _mm_set_epi64x(0x00ccaa009e, 0x01751997d0);
  const __m128i k5k0 = _mm_set_epi64x(0, 0x0163cd6124);
  const __m128i poly = _mm_set_epi64x(0x01f7011641, 0x01db710641);
  __m128i x1 = _mm_xor_si128(load128(p), _mm_cvtsi32_si128(static_cast<int>(crc)));
  __m128i x2 = load128(p + 16), x3 = load128(p + 32), x4 = load128(p + 48);
  p += 64;
  len -= 64;
  for (; len >= 64; p += 64, len -= 64) {
    x1 = fold(x1, k1k2, load128(p));
    x2 = fold(x2, k1k2, load128(p + 16));
    x3 = fold(x3, k1k2, load128(p + 32));
    x4 = fold(x4, k1k2, load128(p + 48));
  }
  x1 = fold(fold(fold(x1, k3k4, x2), k3k4, x3), k3k4, x4);
  for (; len >= 16; p += 16, len -= 16) x1 = fold(x1, k3k4, load128(p));
  // 128 bits to 64
  const __m128i low32 = _mm_setr_epi32(~0, 0, ~0, 0);
  x1 = _mm_xor_si128(_mm_srli_si128(x1, 8), _mm_clmulepi64_si128(x1, k3k4, 0x10));
  x1 = _mm_xor_si128(_mm_clmulepi64_si128(_mm_and_si128(x1, low32), k5k0, 0x00),
                     _mm_srli_si128(x1, 4));
  // Barrett reduction to 32 bits
  __m128i q = _mm_clmulepi64_si128(_mm_and_si128(x1, low32), poly, 0x10);
  q = _mm_clmulepi64_si128(_mm_and_si128(q, low32), poly, 0x00);
  return static_cast<uint32_t>(_mm_extract_epi32(_mm_xor_si128(x1, q), 1));
}

inline bool cpu_has_clmul() {
  __builtin_cpu_init();
  return __builtin_cpu_supports("pclmul") && __builtin_cpu_supports("sse4.1");
}
const bool kClmul = cpu_has_clmul();
#endif

// The CRC-32 of len bytes at p, continuing crc (zlib's crc32): folded where
// the CPU multiplies without carries, the rest by zlib.
inline uint32_t crc32_of(uint32_t crc, const uint8_t* p, size_t len) {
#if defined(__x86_64__)
  if (kClmul && len >= 64) {
    const size_t folded = len & ~static_cast<size_t>(15);
    crc = ~crc32_fold(p, folded, ~crc);
    p += folded;
    len -= folded;
  }
#endif
  return len ? static_cast<uint32_t>(crc32(crc, p, static_cast<uInt>(len))) : crc;
}

// Copies a match of len bytes from dist bytes back to out, writing up to 7
// bytes past it.
inline void copy_match(uint8_t* out, uint32_t dist, uint32_t len) {
  const uint8_t* src = out - dist;
  uint8_t* const end = out + len;
  if (dist >= 8) {
    do {
      store64(out, load64(src));
      src += 8;
      out += 8;
    } while (out < end);
  } else if (dist == 1) {
    const uint64_t v = 0x0101010101010101ull * *src;
    do {
      store64(out, v);
      out += 8;
    } while (out < end);
  } else {
    do *out++ = *src++;
    while (out < end);
  }
}

// A file read as gzread reads it: read, error and eof stand for gzread,
// gzerror and gzeof.
class Stream {
 public:
  // The stream of path, or nullptr where it cannot be opened.
  static Stream* open(const char* path) {
    FILE* f = fopen(path, "rb");
    return f ? new Stream(f) : nullptr;
  }
  ~Stream() { fclose(file_); }
  Stream(const Stream&) = delete;
  Stream& operator=(const Stream&) = delete;

  // Up to len bytes of the text into buf: how many, 0 at the end of the
  // input, -1 after an error once the bytes decoded before it are read.
  // As gzread's, those are all the bytes before a truncation, but none of
  // the output buffer in which bad data, a bad check or a failed read is
  // found.
  int read(char* buf, unsigned len) {
    if (direct_) return read_direct(buf, len);
    if (out_handed_ == out_next_ && err_ == Z_OK && !done_) fill();
    const size_t n = std::min<size_t>(len, out_next_ - out_handed_);
    if (n == 0) return err_ == Z_OK ? 0 : -1;
    memcpy(buf, out_handed_, n);
    out_handed_ += n;
    return static_cast<int>(n);
  }

  // The error, as zlib's: Z_OK; Z_BUF_ERROR where the input ends inside a
  // member; Z_DATA_ERROR for a stream that is not DEFLATE's, a bad header,
  // or a CRC-32 or ISIZE that does not match; Z_ERRNO where a read failed.
  void error(int* errnum) const { *errnum = err_; }

  // The end of the input was reached.
  bool eof() const { return done_; }

  // out[0]: nanoseconds spent decoding, on the steady clock; out[1]: the
  // bytes of text decoded (0 for input passed through).
  void stats(int64_t* out) const {
    out[0] = inflate_ns_;
    out[1] = inflated_;
  }

 private:
  enum State { kMember, kBlock, kStored, kHuffman, kTrailer };

  explicit Stream(FILE* f)
      : file_(f), in_buf_(new uint8_t[kInSize]), out_buf_(new uint8_t[kWindow + kOutSize]) {
    in_next_ = in_end_ = in_buf_.get();
    out_next_ = out_handed_ = hist_start_ = out_buf_.get() + kWindow;
    out_end_ = out_buf_.get() + kWindow + kOutSize;
    refill_input();
    direct_ = in_end_ - in_next_ < 2 || in_next_[0] != 0x1f || in_next_[1] != 0x8b;
  }

  bool fail(int err) {
    if (err_ == Z_OK) err_ = err;
    return false;
  }

  // Moves the input left to the front of its buffer and reads the file
  // after it.
  void refill_input() {
    const size_t keep = in_end_ - in_next_;
    memmove(in_buf_.get(), in_next_, keep);
    in_next_ = in_buf_.get();
    const size_t got = fread(in_buf_.get() + keep, 1, kInSize - keep, file_);
    in_end_ = in_next_ + keep + got;
    if (got < kInSize - keep) {
      in_eof_ = true;
      if (ferror(file_)) fail(Z_ERRNO);
    }
  }

  int read_direct(char* buf, unsigned len) {
    if (in_next_ == in_end_ && !in_eof_) refill_input();
    const size_t n = std::min<size_t>(len, in_end_ - in_next_);
    memcpy(buf, in_next_, n);
    in_next_ += n;
    done_ = in_eof_ && in_next_ == in_end_;
    if (n == 0 && err_ != Z_OK) return -1;
    return static_cast<int>(n);
  }

  // Decodes up to kOutSize bytes of text after the history.
  void fill() {
    const auto started = std::chrono::steady_clock::now();
    if (out_next_ != out_buf_.get() + kWindow) {   // keep the history only
      const size_t hist = std::min<size_t>(kWindow, out_next_ - hist_start_);
      memmove(out_buf_.get() + kWindow - hist, out_next_ - hist, hist);
      out_next_ = out_handed_ = out_buf_.get() + kWindow;
      hist_start_ = out_next_ - hist;
    }
    uint8_t* const first = out_next_;
    crc_from_ = out_next_;
    while (err_ == Z_OK && !done_ && out_next_ < out_end_) {
      if (!in_eof_ && static_cast<size_t>(in_end_ - in_next_) < kInKeep) refill_input();
      switch (state_) {
        case kMember: member(); break;
        case kBlock: block(); break;
        case kStored: stored(); break;
        case kHuffman: huffman(); break;
        case kTrailer: trailer(); break;
      }
    }
    checksum();
    if (err_ != Z_OK && err_ != Z_BUF_ERROR) out_next_ = first;
    inflated_ += out_next_ - first;
    inflate_ns_ += std::chrono::duration_cast<std::chrono::nanoseconds>(
                       std::chrono::steady_clock::now() - started).count();
  }

  // Adds the text decoded since the last call to the member's CRC-32 and size.
  void checksum() {
    crc_ = crc32_of(crc_, crc_from_, out_next_ - crc_from_);
    member_bytes_ += out_next_ - crc_from_;
    crc_from_ = out_next_;
  }

  // ---- bits ----

  // Fills the bit buffer to 49-56 bits (a length and a distance take 48),
  // reading the file as needed; past its end, with zero bytes, which
  // truncated() tells apart.
  bool pull() {
    while (bitsleft_ <= 48) {
      if (in_next_ < in_end_) {
        bitbuf_ |= static_cast<uint64_t>(*in_next_++) << bitsleft_;
      } else if (!in_eof_) {
        refill_input();
        continue;
      } else if (++overread_ > 8) {
        return fail(Z_BUF_ERROR);
      }
      bitsleft_ += 8;
    }
    return true;
  }

  uint32_t take(int n) {
    const uint32_t v = static_cast<uint32_t>(bitbuf_ & ((1ull << n) - 1));
    bitbuf_ >>= n;
    bitsleft_ -= n;
    return v;
  }

  // A bit past the end of the file was consumed.
  bool truncated() const { return bitsleft_ < 8 * overread_; }

  void align() { take(bitsleft_ & 7); }

  // ---- the gzip envelope ----

  // A member's header; the end of the input where fewer than two bytes are
  // left or they are not the gzip magic (trailing bytes, ignored).
  void member() {
    if (!pull()) return;
    if (bitsleft_ / 8 < overread_ + 2 || (bitbuf_ & 0xFFFF) != 0x8b1f) {
      done_ = true;
      return;
    }
    uint8_t fixed[10];
    for (uint8_t& b : fixed) {
      if (!pull()) return;
      b = static_cast<uint8_t>(take(8));
    }
    const int flags = fixed[3];
    if (fixed[2] != 8 || (flags & 0xE0)) {   // not DEFLATE, or reserved flags
      fail(Z_DATA_ERROR);
      return;
    }
    const bool hcrc = flags & 0x02;
    uint32_t header_crc = hcrc ? crc32_of(0, fixed, 10) : 0;
    auto byte = [&]() {
      pull();
      const uint8_t b = static_cast<uint8_t>(take(8));
      if (hcrc) header_crc = crc32_of(header_crc, &b, 1);
      return b;
    };
    if (flags & 0x04) {   // FEXTRA
      uint32_t xlen = byte();
      xlen |= static_cast<uint32_t>(byte()) << 8;
      for (uint32_t i = 0; i < xlen && err_ == Z_OK && !truncated(); ++i) byte();
    }
    for (int field : {0x08, 0x10}) {   // FNAME, FCOMMENT: zero-terminated
      if (flags & field)
        while (err_ == Z_OK && !truncated() && byte() != 0) {
        }
    }
    if (hcrc) {
      pull();
      if (take(16) != (header_crc & 0xFFFF)) fail(Z_DATA_ERROR);
    }
    if (err_ != Z_OK) return;
    if (truncated()) {
      fail(Z_BUF_ERROR);
      return;
    }
    crc_ = 0;
    member_bytes_ = 0;
    crc_from_ = hist_start_ = out_next_;   // no match reaches another member
    state_ = kBlock;
  }

  void trailer() {
    checksum();
    align();
    pull();
    const uint32_t crc = take(32);
    pull();
    const uint32_t isize = take(32);
    if (err_ != Z_OK) return;
    if (truncated()) {
      fail(Z_BUF_ERROR);
      return;
    }
    if (crc != crc_ || isize != static_cast<uint32_t>(member_bytes_)) {
      fail(Z_DATA_ERROR);
      return;
    }
    state_ = kMember;
  }

  // ---- DEFLATE blocks ----

  void block() {
    if (!pull()) return;
    final_ = take(1);
    const uint32_t type = take(2);
    if (type == 0) {
      align();
      pull();
      const uint32_t len = take(16), nlen = take(16);
      if (truncated()) {
        fail(Z_BUF_ERROR);
      } else if (len != (~nlen & 0xFFFF)) {
        fail(Z_DATA_ERROR);
      } else {
        stored_left_ = len;
        state_ = kStored;
      }
    } else if (type == 1) {
      lit_ = kFixed.lit;
      dist_ = kFixed.dist;
      state_ = kHuffman;
    } else if (type == 2) {
      if (dynamic()) state_ = kHuffman;
    } else {
      fail(Z_DATA_ERROR);
    }
  }

  // A dynamic block's header: its code length code, then the literal/length
  // and distance codes' lengths in it.
  bool dynamic() {
    const uint32_t nlit = take(5) + 257, ndist = take(5) + 1, npre = take(4) + 4;
    if (nlit > 286 || ndist > 30) return fail(Z_DATA_ERROR);
    uint8_t pre_lens[19] = {0};
    for (uint32_t i = 0; i < npre; ++i) {
      if (!pull()) return false;
      pre_lens[kPrecodeOrder[i]] = static_cast<uint8_t>(take(3));
    }
    if (!build<kPreBits>(pre_table_, pre_lens, 19, false, pre_entry)) return fail(Z_DATA_ERROR);
    const uint32_t n = nlit + ndist;
    for (uint32_t i = 0; i < n;) {
      if (!pull()) return false;
      const uint32_t e = pre_table_[bitbuf_ & ((1u << kPreBits) - 1)];
      take(e & 0xFF);
      const uint32_t sym = e >> 16;
      if (sym < 16) {
        lens_[i++] = static_cast<uint8_t>(sym);
        continue;
      }
      uint8_t len = 0;
      uint32_t rep;
      if (sym == 16) {
        if (i == 0) return fail(Z_DATA_ERROR);
        len = lens_[i - 1];
        rep = 3 + take(2);
      } else if (sym == 17) {
        rep = 3 + take(3);
      } else {
        rep = 11 + take(7);
      }
      if (i + rep > n) return fail(Z_DATA_ERROR);
      memset(lens_ + i, len, rep);
      i += rep;
    }
    if (truncated()) return fail(Z_BUF_ERROR);
    if (lens_[256] == 0 ||
        !build<kLitBits>(lit_table_, lens_, nlit, true, lit_entry) ||
        !build<kDistBits>(dist_table_, lens_ + nlit, ndist, true, dist_entry))
      return fail(Z_DATA_ERROR);
    lit_ = lit_table_;
    dist_ = dist_table_;
    return true;
  }

  void end_block() { state_ = final_ ? kTrailer : kBlock; }

  void stored() {
    while (stored_left_ > 0 && out_next_ < out_end_) {
      if (bitsleft_ >= 8) {   // the whole bytes the bit buffer holds first
        *out_next_++ = static_cast<uint8_t>(take(8));
        --stored_left_;
        if (truncated()) {
          --out_next_;
          fail(Z_BUF_ERROR);
          return;
        }
        continue;
      }
      bitbuf_ = 0;   // bytes are copied past it, so nothing it has read ahead holds
      const size_t n = std::min<size_t>({stored_left_, static_cast<size_t>(in_end_ - in_next_),
                                         static_cast<size_t>(out_end_ - out_next_)});
      if (n == 0) {
        if (in_eof_) fail(Z_BUF_ERROR);
        return;   // fill() reads more
      }
      memcpy(out_next_, in_next_, n);
      in_next_ += n;
      out_next_ += n;
      stored_left_ -= static_cast<uint32_t>(n);
    }
    if (stored_left_ == 0) end_block();
  }

  void huffman() {
    if (match_left_) {   // a match the last fill's output cut
      copy_left();
      if (match_left_) return;
    }
    while (state_ == kHuffman && err_ == Z_OK && out_next_ < out_end_) {
      const size_t in_left = in_end_ - in_next_;
      if (in_left >= kFastIn && static_cast<size_t>(out_end_ - out_next_) >= kFastOut) fast();
      else if (!in_eof_ && in_left < kInKeep) return;   // fill() reads more
      else slow();
    }
  }

  // Symbols while both buffers have their margins.
  void fast() {
    uint64_t bb = bitbuf_;
    uint32_t bl = bitsleft_;
    const uint8_t* in = in_next_;
    uint8_t* out = out_next_;
    const uint8_t* const in_last = in_end_ - kFastIn;
    uint8_t* const out_last = out_end_ - kFastOut;
    const uint32_t* const lit = lit_;
    const uint32_t* const dist_table = dist_;
    const uint8_t* const hist_start = hist_start_;
    // past 56 bits, without a branch
    auto refill = [&]() {
      bb |= load64(in) << bl;
      in += (63 - bl) >> 3;
      bl |= 56;
    };
    while (in <= in_last && out <= out_last) {
      refill();
      uint32_t e = lookup<kLitBits>(lit, bb);
      if (e & kLiteral) {   // 56 bits hold three codewords of up to 15
        bb >>= e & 0xFF;
        bl -= e & 0xFF;
        *out++ = static_cast<uint8_t>(e >> 16);
        e = lookup<kLitBits>(lit, bb);
        if (e & kLiteral) {
          bb >>= e & 0xFF;
          bl -= e & 0xFF;
          *out++ = static_cast<uint8_t>(e >> 16);
          e = lookup<kLitBits>(lit, bb);
          if (e & kLiteral) {
            bb >>= e & 0xFF;
            bl -= e & 0xFF;
            *out++ = static_cast<uint8_t>(e >> 16);
            continue;
          }
        }
        refill();   // a length and a distance take up to 48 bits
      }
      if (e & kExceptional) {
        if (e & kEndOfBlock) {
          bb >>= e & 0xFF;
          bl -= e & 0xFF;
          end_block();
        } else {
          fail(Z_DATA_ERROR);
        }
        break;
      }
      uint64_t saved = bb;
      bb >>= e & 0xFF;
      bl -= e & 0xFF;
      const uint32_t len = value(e, saved);
      e = lookup<kDistBits>(dist_table, bb);
      if (e & kExceptional) {
        fail(Z_DATA_ERROR);
        break;
      }
      saved = bb;
      bb >>= e & 0xFF;
      bl -= e & 0xFF;
      const uint32_t dist = value(e, saved);
      if (dist > static_cast<size_t>(out - hist_start)) {
        fail(Z_DATA_ERROR);
        break;
      }
      copy_match(out, dist, len);
      out += len;
    }
    bitbuf_ = bb;
    bitsleft_ = bl;
    in_next_ = in;
    out_next_ = out;
  }

  // One symbol, with every bound checked.
  void slow() {
    if (!pull()) return;
    uint32_t e = lookup<kLitBits>(lit_, bitbuf_);
    uint64_t saved = bitbuf_;
    take(e & 0xFF);
    if (truncated()) {
      fail(Z_BUF_ERROR);
      return;
    }
    if (e & kLiteral) {
      *out_next_++ = static_cast<uint8_t>(e >> 16);
      return;
    }
    if (e & kExceptional) {
      if (e & kEndOfBlock) end_block();
      else fail(Z_DATA_ERROR);
      return;
    }
    const uint32_t len = value(e, saved);
    e = lookup<kDistBits>(dist_, bitbuf_);   // 49 - 20 bits are left, a distance takes 28
    saved = bitbuf_;
    take(e & 0xFF);
    if (truncated()) {
      fail(Z_BUF_ERROR);
      return;
    }
    if (e & kExceptional) {
      fail(Z_DATA_ERROR);
      return;
    }
    const uint32_t dist = value(e, saved);
    if (dist > static_cast<size_t>(out_next_ - hist_start_)) {
      fail(Z_DATA_ERROR);
      return;
    }
    match_left_ = len;
    match_dist_ = dist;
    copy_left();
  }

  // As much of the match left as the output buffer holds, a byte at a time.
  void copy_left() {
    const uint32_t n = std::min<uint32_t>(match_left_, static_cast<uint32_t>(out_end_ - out_next_));
    for (uint32_t i = 0; i < n; ++i, ++out_next_) *out_next_ = *(out_next_ - match_dist_);
    match_left_ -= n;
  }

  FILE* file_;
  std::unique_ptr<uint8_t[]> in_buf_, out_buf_;
  const uint8_t* in_next_;
  const uint8_t* in_end_;
  bool in_eof_ = false;
  // the text: [hist_start_, out_next_) may be matched; [out_handed_,
  // out_next_) is not read yet; [crc_from_, out_next_) is not in crc_ yet
  uint8_t* out_next_;
  uint8_t* out_handed_;
  uint8_t* hist_start_;
  uint8_t* out_end_;
  uint8_t* crc_from_ = nullptr;
  bool direct_ = false;   // not gzip: passed through
  bool done_ = false;
  int err_ = Z_OK;
  State state_ = kMember;
  uint64_t bitbuf_ = 0;
  uint32_t bitsleft_ = 0;
  uint32_t overread_ = 0;   // zero bytes past the end of the file
  uint32_t final_ = 0;
  uint32_t stored_left_ = 0;
  uint32_t match_left_ = 0, match_dist_ = 0;
  uint32_t crc_ = 0;
  uint64_t member_bytes_ = 0;
  const uint32_t* lit_ = nullptr;
  const uint32_t* dist_ = nullptr;
  uint32_t lit_table_[kLitTableSize];
  uint32_t dist_table_[kDistTableSize];
  uint32_t pre_table_[1 << kPreBits];
  uint8_t lens_[286 + 30];
  int64_t inflate_ns_ = 0, inflated_ = 0;
};

}  // namespace gunzip

#endif  // TOPSICLE_TSIO_INFLATE_H_
