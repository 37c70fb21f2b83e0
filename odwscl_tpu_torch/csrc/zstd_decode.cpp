// Zstandard (RFC 8878) decoder of the port's native host library, for the
// Orbax checkpoint import: every OCDBT manifest and B-tree node and every
// zarr chunk that the JAX package writes is a zstd frame. Written from the
// RFC; no zstd library is linked (the card's machine has none). A C
// interface loaded with ctypes by odwscl_tpu_torch/utils/zstd.py, which
// builds it at first use (g++ -O3 -shared -fPIC -std=c++17) into the
// checkout's build/ directory. The pure-Python decoder in that module,
// decompress_plain, is the plain version it is held to, check for check.
//
// Every read of the input goes through a bounds-checked reader and every
// match copy checks its offset against the frame's output, so a corrupt or
// truncated frame ends in an error message, never in a read or write out
// of bounds. Bound on a host core by the per-symbol table lookups of the
// Huffman literals (Orbax's level-1 frames of f32 weights are mostly
// Huffman-coded literals with few matches): one 8-byte load serves 4
// literals, and the 4 streams of a block are decoded in lockstep, so four
// independent chains of lookups are in flight.

#include <cstdint>
#include <cstring>
#include <exception>
#include <new>
#include <string>
#include <vector>

namespace {

struct ZstdError {
  const char* what;
};

inline void check(bool cond, const char* what) {
  if (!cond) throw ZstdError{what};
}

constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr size_t kBlockMax = 128 * 1024;

inline uint64_t load_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = n - 1; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

inline int highbit(uint64_t v) {  // index of the highest set bit, v > 0
  return 63 - __builtin_clzll(v);
}

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  size_t i = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
    for (; i + 32 <= n; i += 32)
      for (int k = 0; k < 4; ++k) v[k] = xround(v[k], load_le(p + i + 8 * k, 8));
    h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
    for (int k = 0; k < 4; ++k) h = (h ^ xround(0, v[k])) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  for (; i + 8 <= n; i += 8) {
    h ^= xround(0, load_le(p + i, 8));
    h = rotl(h, 27) * P1 + P4;
  }
  if (i + 4 <= n) {
    h ^= load_le(p + i, 4) * P1;
    h = rotl(h, 23) * P2 + P3;
    i += 4;
  }
  for (; i < n; ++i) {
    h ^= p[i] * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ------------------------------------------------------------ bit readers
// Little-endian bits from the start (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  uint64_t pos = 0;
  uint32_t read(int nb) {
    uint64_t end = pos + nb;
    check(end <= 8 * static_cast<uint64_t>(n),
          "FSE table description truncated");
    size_t lo = pos >> 3, hi = (end + 7) >> 3;
    uint64_t v = load_le(p + lo, static_cast<int>(hi - lo)) >> (pos & 7);
    pos = end;
    return static_cast<uint32_t>(v & ((1ull << nb) - 1));
  }
  size_t nbytes() const { return (pos + 7) >> 3; }
};

// A backward bitstream: from the highest bit below the final byte's end
// marker down to bit 0. Bits below 0 read as zeros (a peek may reach
// there); a read that consumes them leaves pos < 0 (overflowed()).
struct BackwardBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;
  BackwardBits(const uint8_t* data, size_t size) : p(data), n(size) {
    check(size > 0, "empty bitstream");
    check(data[size - 1] != 0, "bitstream without an end marker");
    pos = 8 * static_cast<int64_t>(size - 1) + highbit(data[size - 1]);
  }
  // nb <= 56
  uint64_t peek(int nb) const {
    if (nb == 0 || pos <= 0) return 0;
    const int64_t hi = (pos - 1) >> 3;
    uint64_t v;
    int64_t shift;
    if (hi >= 7) {  // the 8 bytes ending at byte hi (little-endian host)
      std::memcpy(&v, p + hi - 7, 8);
      shift = pos - nb - 8 * (hi - 7);
    } else {
      v = load_le(p, static_cast<int>(hi + 1));
      shift = pos - nb;
    }
    v = shift >= 0 ? v >> shift : v << (-shift);
    return v & ((1ull << nb) - 1);
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
  bool overflowed() const { return pos < 0; }
};

// ------------------------------------------------------------------ FSE
struct FseEntry {
  uint8_t symbol;
  uint8_t nb;
  uint16_t base;
};

struct FseTable {
  std::vector<FseEntry> t;
  int log = 0;
};

void build_fse(const std::vector<int>& probs, int log, FseTable* out) {
  const int size = 1 << log;
  std::vector<uint8_t> symbols(size, 0);
  std::vector<uint32_t> next(probs.size(), 0);
  int high = size - 1;
  for (size_t s = 0; s < probs.size(); ++s) {
    if (probs[s] == -1) {
      check(high >= 0, "corrupt FSE distribution");
      symbols[high--] = static_cast<uint8_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint32_t>(probs[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  int pos = 0;
  for (size_t s = 0; s < probs.size(); ++s) {
    for (int i = 0; i < probs[s]; ++i) {
      symbols[pos] = static_cast<uint8_t>(s);
      pos = (pos + step) & (size - 1);
      while (pos > high) pos = (pos + step) & (size - 1);
    }
  }
  check(pos == 0, "corrupt FSE distribution");
  out->t.resize(size);
  out->log = log;
  for (int u = 0; u < size; ++u) {
    const uint8_t s = symbols[u];
    const uint32_t nx = next[s]++;
    const int nb = log - highbit(nx);
    out->t[u] = {s, static_cast<uint8_t>(nb),
                 static_cast<uint16_t>((nx << nb) - size)};
  }
}

// An FSE table description; returns the bytes read.
size_t read_fse_table(const uint8_t* p, size_t n, int max_symbol,
                      int max_log, FseTable* out) {
  ForwardBits bits{p, n};
  const int log = static_cast<int>(bits.read(4)) + 5;
  check(log <= max_log, "FSE accuracy log too large");
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nb = log + 1;
  std::vector<int> probs;
  bool prev_zero = false;
  while (remaining > 1 && static_cast<int>(probs.size()) <= max_symbol) {
    if (prev_zero) {
      for (;;) {
        const uint32_t r = bits.read(2);
        probs.insert(probs.end(), r, 0);
        if (r != 3) break;
        check(static_cast<int>(probs.size()) <= max_symbol,
              "FSE symbol out of range");
      }
      check(static_cast<int>(probs.size()) <= max_symbol,
            "FSE symbol out of range");
    }
    const int mx = (2 * threshold - 1) - remaining;
    const uint64_t start = bits.pos;
    int v = static_cast<int>(bits.read(nb - 1));
    if (v >= mx) {
      bits.pos = start;
      v = static_cast<int>(bits.read(nb));
      if (v >= threshold) v -= mx;
    }
    const int count = v - 1;
    remaining -= count < 0 ? -count : count;
    probs.push_back(count);
    prev_zero = count == 0;
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  check(remaining == 1 && static_cast<int>(probs.size()) <= max_symbol + 1,
        "corrupt FSE table description");
  build_fse(probs, log, out);
  return bits.nbytes();
}

// -------------------------------------------------------------- Huffman
struct Huffman {
  std::vector<uint16_t> table;  // symbol | nb_bits << 8, by max_bits prefix
  int max_bits = 0;
  bool valid = false;

  void build(std::vector<int> weights) {
    uint32_t total = 0;
    for (int w : weights)
      if (w) total += 1u << (w - 1);
    check(total > 0, "Huffman weights all zero");
    const int mb = highbit(total) + 1;
    check(mb <= 11, "Huffman code longer than 11 bits");
    const uint32_t rest = (1u << mb) - total;
    check((rest & (rest - 1)) == 0,
          "Huffman weights do not sum to a power of two");
    weights.push_back(highbit(rest) + 1);
    max_bits = mb;
    table.assign(1u << mb, 0);
    uint32_t pos = 0;
    for (int w = 1; w <= mb; ++w) {
      for (size_t s = 0; s < weights.size(); ++s) {
        if (weights[s] != w) continue;
        const uint32_t cnt = 1u << (w - 1);
        const uint16_t e =
            static_cast<uint16_t>(s | ((mb + 1 - w) << 8));
        for (uint32_t k = 0; k < cnt; ++k) table[pos + k] = e;
        pos += cnt;
      }
    }
    check(pos == (1u << mb), "corrupt Huffman weights");
    valid = true;
  }

  // 4 symbols from one 8-byte load (bits.pos >= 64: at least 57 valid
  // bits, 4 codes of at most 11)
  inline void step4(BackwardBits* bits, const uint8_t* p, uint8_t* out) const {
    const uint16_t* t = table.data();
    const uint64_t mask = (1ull << max_bits) - 1;
    const int64_t lo = ((bits->pos - 1) >> 3) - 7;
    uint64_t v;
    std::memcpy(&v, p + lo, 8);
    int avail = static_cast<int>(bits->pos - 8 * lo);
    for (int k = 0; k < 4; ++k) {
      const uint16_t e = t[(v >> (avail - max_bits)) & mask];
      out[k] = static_cast<uint8_t>(e & 0xFF);
      avail -= e >> 8;
    }
    bits->pos = 8 * lo + avail;
  }

  // Symbols i..count-1 of a stream whose first i are decoded; the stream
  // must end exactly at its first bit.
  void finish(BackwardBits* bits, const uint8_t* p, uint8_t* out, size_t i,
              size_t count) const {
    for (; bits->pos >= 64 && i + 4 <= count; i += 4) step4(bits, p, out + i);
    for (; i < count; ++i) {
      const uint16_t e = table[bits->peek(max_bits)];
      out[i] = static_cast<uint8_t>(e & 0xFF);
      bits->pos -= e >> 8;
      check(bits->pos >= 0, "Huffman stream overread");
    }
    check(bits->pos == 0, "Huffman stream not consumed");
  }

  void decode(const uint8_t* p, size_t n, uint8_t* out, size_t count) const {
    BackwardBits bits(p, n);
    finish(&bits, p, out, 0, count);
  }

  // Four streams in lockstep (independent dependency chains), then each
  // to its end.
  void decode4(const uint8_t* const p[4], const size_t n[4],
               uint8_t* const out[4], const size_t count[4]) const {
    BackwardBits b[4] = {{p[0], n[0]}, {p[1], n[1]}, {p[2], n[2]},
                         {p[3], n[3]}};
    size_t cmin = count[0];
    for (int s = 1; s < 4; ++s) cmin = count[s] < cmin ? count[s] : cmin;
    size_t i = 0;
    for (; i + 4 <= cmin && b[0].pos >= 64 && b[1].pos >= 64 &&
           b[2].pos >= 64 && b[3].pos >= 64;
         i += 4) {
      step4(&b[0], p[0], out[0] + i);
      step4(&b[1], p[1], out[1] + i);
      step4(&b[2], p[2], out[2] + i);
      step4(&b[3], p[3], out[3] + i);
    }
    for (int s = 0; s < 4; ++s) finish(&b[s], p[s], out[s], i, count[s]);
  }
};

// A Huffman tree description; returns the bytes read.
size_t read_huffman(const uint8_t* p, size_t n, Huffman* h) {
  check(n >= 1, "Huffman tree description truncated");
  const uint8_t hb = p[0];
  std::vector<int> weights;
  if (hb >= 128) {
    const size_t cnt = hb - 127, nbytes = (cnt + 1) / 2;
    check(n >= 1 + nbytes, "Huffman weights truncated");
    for (size_t i = 0; i < cnt; ++i) {
      const uint8_t b = p[1 + i / 2];
      weights.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
    h->build(weights);
    return 1 + nbytes;
  }
  check(hb > 0 && n >= 1u + hb, "Huffman weights truncated");
  const uint8_t* region = p + 1;
  FseTable fse;
  const size_t used = read_fse_table(region, hb, 255, 6, &fse);
  check(used <= hb, "Huffman weights truncated");
  BackwardBits bits(region + used, hb - used);
  uint32_t states[2];
  states[0] = static_cast<uint32_t>(bits.read(fse.log));
  states[1] = static_cast<uint32_t>(bits.read(fse.log));
  int k = 0;
  for (;;) {
    check(weights.size() <= 253, "too many Huffman weights");
    const FseEntry e = fse.t[states[k]];
    weights.push_back(e.symbol);
    states[k] = e.base + static_cast<uint32_t>(bits.read(e.nb));
    if (bits.overflowed()) {
      weights.push_back(fse.t[states[1 - k]].symbol);
      break;
    }
    k = 1 - k;
  }
  for (int w : weights) check(w <= 11, "Huffman weight above 11");
  h->build(weights);
  return 1 + hb;
}

// ------------------------------------------------------------ sequences
constexpr uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                                 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26,  27,  28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43, 47,  51,  59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                                 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const std::vector<int> kLLDefault = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                     2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                     2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const std::vector<int> kOFDefault = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                     1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 1, -1, -1, -1, -1, -1};
std::vector<int> ml_default() {
  std::vector<int> v = {1, 4, 3, 2, 2, 2, 2, 2, 2};
  v.insert(v.end(), 37, 1);
  v.insert(v.end(), 7, -1);
  return v;
}

struct FrameState {
  Huffman huffman;
  FseTable tables[3];  // literal lengths, offsets, match lengths
  bool have[3] = {false, false, false};
  uint64_t reps[3] = {1, 4, 8};
};

// The literals section into lits; returns the bytes read.
size_t read_literals(const uint8_t* p, size_t n, FrameState* st,
                     std::vector<uint8_t>* lits) {
  check(n >= 1, "literals header truncated");
  const uint8_t b0 = p[0];
  const int kind = b0 & 3, fmt = (b0 >> 2) & 3;
  if (kind == 0 || kind == 1) {
    size_t size, hl;
    if (fmt == 0 || fmt == 2) {
      size = b0 >> 3;
      hl = 1;
    } else if (fmt == 1) {
      check(n >= 2, "literals header truncated");
      size = (b0 >> 4) + (static_cast<size_t>(p[1]) << 4);
      hl = 2;
    } else {
      check(n >= 3, "literals header truncated");
      size = (b0 >> 4) + (static_cast<size_t>(p[1]) << 4) +
             (static_cast<size_t>(p[2]) << 12);
      hl = 3;
    }
    check(size <= kBlockMax, "literals larger than a block");
    if (kind == 0) {
      check(n >= hl + size, "raw literals truncated");
      lits->assign(p + hl, p + hl + size);
      return hl + size;
    }
    check(n >= hl + 1, "RLE literals truncated");
    lits->assign(size, p[hl]);
    return hl + 1;
  }
  const size_t hl = fmt == 0 || fmt == 1 ? 3 : fmt == 2 ? 4 : 5;
  check(n >= hl, "literals header truncated");
  const uint64_t h = load_le(p, static_cast<int>(hl));
  const int nbits = hl == 3 ? 10 : hl == 4 ? 14 : 18;
  const size_t size = (h >> 4) & ((1ull << nbits) - 1);
  const size_t csize = (h >> (4 + nbits)) & ((1ull << nbits) - 1);
  check(size <= kBlockMax, "literals larger than a block");
  check(n >= hl + csize, "compressed literals truncated");
  const uint8_t* data = p + hl;
  size_t dn = csize;
  if (kind == 2) {
    st->huffman.valid = false;
    const size_t used = read_huffman(data, dn, &st->huffman);
    data += used;
    dn -= used;
  } else {
    check(st->huffman.valid,
          "treeless literals without a previous Huffman table");
  }
  lits->resize(size);
  if (fmt == 0) {
    st->huffman.decode(data, dn, lits->data(), size);
    return hl + csize;
  }
  check(dn >= 6, "jump table truncated");
  size_t sizes[4];
  size_t sum = 0;
  for (int i = 0; i < 3; ++i) {
    sizes[i] = load_le(data + 2 * i, 2);
    sum += sizes[i];
  }
  check(dn >= 6 + sum, "corrupt jump table");
  sizes[3] = dn - 6 - sum;
  const size_t per = (size + 3) / 4;
  check(per * 3 <= size, "four literal streams of too few bytes");
  const uint8_t* ps[4];
  uint8_t* outs[4];
  size_t counts[4];
  size_t pos = 6;
  for (int i = 0; i < 4; ++i) {
    ps[i] = data + pos;
    outs[i] = lits->data() + i * per;
    counts[i] = i < 3 ? per : size - 3 * per;
    pos += sizes[i];
  }
  st->huffman.decode4(ps, sizes, outs, counts);
  return hl + csize;
}

size_t sequence_table(const uint8_t* p, size_t n, size_t pos, int mode,
                      int which, FrameState* st) {
  static const int kMaxSymbol[3] = {35, 31, 52};
  static const int kMaxLog[3] = {9, 8, 9};
  FseTable* t = &st->tables[which];
  if (mode == 0) {
    if (which == 0) build_fse(kLLDefault, 6, t);
    else if (which == 1) build_fse(kOFDefault, 5, t);
    else build_fse(ml_default(), 6, t);
  } else if (mode == 1) {
    check(pos < n, "RLE sequence table truncated");
    check(p[pos] <= kMaxSymbol[which], "RLE symbol out of range");
    t->t.assign(1, FseEntry{p[pos], 0, 0});
    t->log = 0;
    ++pos;
  } else if (mode == 2) {
    pos += read_fse_table(p + pos, n - pos, kMaxSymbol[which],
                          kMaxLog[which], t);
  } else {
    check(st->have[which], "repeat sequence table without a previous one");
  }
  st->have[which] = true;
  return pos;
}

// Decode a compressed block's sequences and execute them into out.
void compressed_block(const uint8_t* p, size_t n, std::vector<uint8_t>* out,
                      size_t frame_start, FrameState* st,
                      std::vector<uint8_t>* lits) {
  const size_t used = read_literals(p, n, st, lits);
  p += used;
  n -= used;
  check(n >= 1, "sequences header truncated");
  const uint8_t b0 = p[0];
  size_t nseq, pos;
  if (b0 < 128) {
    nseq = b0;
    pos = 1;
  } else if (b0 < 255) {
    check(n >= 2, "sequences header truncated");
    nseq = (static_cast<size_t>(b0 - 128) << 8) + p[1];
    pos = 2;
  } else {
    check(n >= 3, "sequences header truncated");
    nseq = p[1] + (static_cast<size_t>(p[2]) << 8) + 0x7F00;
    pos = 3;
  }
  const uint8_t* lp = lits->data();
  const size_t lsize = lits->size();
  size_t lpos = 0;
  if (nseq > 0) {
    check(pos < n, "sequences header truncated");
    const uint8_t modes = p[pos++];
    check((modes & 3) == 0, "reserved bits set in the sequence modes");
    pos = sequence_table(p, n, pos, (modes >> 6) & 3, 0, st);
    pos = sequence_table(p, n, pos, (modes >> 4) & 3, 1, st);
    pos = sequence_table(p, n, pos, (modes >> 2) & 3, 2, st);
    check(pos < n, "empty bitstream");
    BackwardBits bits(p + pos, n - pos);
    const FseTable& tl = st->tables[0];
    const FseTable& to = st->tables[1];
    const FseTable& tm = st->tables[2];
    uint32_t sl = static_cast<uint32_t>(bits.read(tl.log));
    uint32_t so = static_cast<uint32_t>(bits.read(to.log));
    uint32_t sm = static_cast<uint32_t>(bits.read(tm.log));
    uint64_t* reps = st->reps;
    for (size_t i = 0; i < nseq; ++i) {
      const FseEntry el = tl.t[sl], eo = to.t[so], em = tm.t[sm];
      const int of_code = eo.symbol;
      check(of_code <= 31, "offset code out of range");
      check(el.symbol <= 35 && em.symbol <= 52, "length code out of range");
      const uint64_t of_value = (1ull << of_code) + bits.read(of_code);
      const size_t ml = kMLBase[em.symbol] + bits.read(kMLBits[em.symbol]);
      const size_t ll = kLLBase[el.symbol] + bits.read(kLLBits[el.symbol]);
      uint64_t offset;
      if (of_value > 3) {
        offset = of_value - 3;
        reps[2] = reps[1];
        reps[1] = reps[0];
        reps[0] = offset;
      } else {
        const uint64_t idx = ll ? of_value - 1 : of_value;
        if (idx == 0) {
          offset = reps[0];
        } else if (idx == 1) {
          offset = reps[1];
          reps[1] = reps[0];
          reps[0] = offset;
        } else {
          offset = idx == 2 ? reps[2] : reps[0] - 1;
          reps[2] = reps[1];
          reps[1] = reps[0];
          reps[0] = offset;
        }
      }
      check(offset > 0, "zero offset");
      if (i + 1 < nseq) {
        sl = el.base + static_cast<uint32_t>(bits.read(el.nb));
        sm = em.base + static_cast<uint32_t>(bits.read(em.nb));
        so = eo.base + static_cast<uint32_t>(bits.read(eo.nb));
      }
      check(!bits.overflowed(), "sequence bitstream overread");
      // execute: ll literals, then the match
      check(lpos + ll <= lsize, "literal lengths past the literals");
      out->insert(out->end(), lp + lpos, lp + lpos + ll);
      lpos += ll;
      const size_t produced = out->size() - frame_start;
      check(offset <= produced, "match offset before the frame's start");
      const size_t old = out->size();
      out->resize(old + ml);
      uint8_t* d = out->data() + old;
      const uint8_t* s = d - offset;
      if (offset >= ml) {
        std::memcpy(d, s, ml);
      } else {
        for (size_t k = 0; k < ml; ++k) d[k] = s[k];
      }
    }
    check(bits.pos == 0, "sequence bitstream not consumed");
  } else {
    check(pos == n, "bytes after an empty sequences section");
  }
  out->insert(out->end(), lp + lpos, lp + lsize);
}

size_t decode_frame(const uint8_t* src, size_t n, size_t pos,
                    std::vector<uint8_t>* out) {
  check(pos < n, "truncated frame header");
  const uint8_t fhd = src[pos++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
  check((fhd & 8) == 0, "reserved bit set in the frame header");
  const int checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
  uint64_t window = 0;
  bool have_window = false;
  if (!single) {
    check(pos < n, "truncated frame header");
    const uint8_t wd = src[pos++];
    const int exp = wd >> 3;
    check(exp <= 31, "window too large");
    const uint64_t base = 1ull << (10 + exp);
    window = base + (base >> 3) * (wd & 7);
    have_window = true;
  }
  static const int kDid[4] = {0, 1, 2, 4};
  const int did_size = kDid[did_flag];
  const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0)
                       : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  check(n - pos >= static_cast<size_t>(did_size + fcs_size),
        "truncated frame header");
  const uint64_t did = load_le(src + pos, did_size);
  pos += did_size;
  check(did == 0, "frame needs a dictionary");
  bool have_fcs = false;
  uint64_t fcs = 0;
  if (fcs_size) {
    fcs = load_le(src + pos, fcs_size);
    if (fcs_size == 2) fcs += 256;
    pos += fcs_size;
    have_fcs = true;
  }
  if (!have_window) window = fcs;
  const size_t block_max =
      window < kBlockMax ? static_cast<size_t>(window) : kBlockMax;
  const size_t start = out->size();
  // a frame of k more bytes holds at most k / 3 blocks of kBlockMax
  const uint64_t most = (n - pos) / 3 * kBlockMax;
  if (have_fcs) out->reserve(start + (fcs < most ? fcs : most));
  FrameState st;
  std::vector<uint8_t> lits;
  for (;;) {
    check(n - pos >= 3, "truncated block header");
    const uint32_t h = static_cast<uint32_t>(load_le(src + pos, 3));
    pos += 3;
    const int last = h & 1, kind = (h >> 1) & 3;
    const size_t size = h >> 3;
    check(kind != 3, "reserved block type");
    if (kind == 1) {
      check(size <= block_max, "RLE block larger than the window");
      check(pos < n, "truncated RLE block");
      out->insert(out->end(), size, src[pos]);
      ++pos;
    } else {
      check(size <= block_max, "block larger than the window");
      check(n - pos >= size, "truncated block");
      if (kind == 0) {
        out->insert(out->end(), src + pos, src + pos + size);
      } else {
        const size_t n0 = out->size();
        compressed_block(src + pos, size, out, start, &st, &lits);
        check(out->size() - n0 <= block_max, "block larger than the window");
      }
      pos += size;
    }
    if (last) break;
  }
  if (have_fcs)
    check(out->size() - start == fcs, "frame content size mismatch");
  if (checksum) {
    check(n - pos >= 4, "truncated content checksum");
    const uint32_t want = static_cast<uint32_t>(load_le(src + pos, 4));
    pos += 4;
    const uint32_t got = static_cast<uint32_t>(
        xxh64(out->data() + start, out->size() - start));
    check(got == want, "content checksum mismatch");
  }
  return pos;
}

void decode_all(const uint8_t* src, size_t n, std::vector<uint8_t>* out) {
  check(n > 0, "empty input");
  size_t pos = 0;
  while (pos < n) {
    check(n - pos >= 4, "truncated frame magic");
    const uint32_t magic = static_cast<uint32_t>(load_le(src + pos, 4));
    if ((magic & kSkippableMask) == kSkippableMagic) {
      check(n - pos >= 8, "truncated skippable frame");
      const uint64_t size = load_le(src + pos + 4, 4);
      check(n - pos - 8 >= size, "truncated skippable frame");
      pos += 8 + size;
      continue;
    }
    check(magic == kFrameMagic, "bad frame magic");
    pos = decode_frame(src, n, pos + 4, out);
  }
}

void set_error(char* err, size_t cap, const char* msg) {
  if (cap == 0) return;
  std::strncpy(err, msg, cap - 1);
  err[cap - 1] = '\0';
}

}  // namespace

extern "C" {

// Decode every frame of src[0:n]. Returns a handle to the output (read it
// with zstd_result_size / zstd_result_copy, release it with
// zstd_result_free), or null with a message in err[0:errcap].
void* zstd_decode(const uint8_t* src, size_t n, char* err, size_t errcap) {
  auto* out = new (std::nothrow) std::vector<uint8_t>();
  if (out == nullptr) {
    set_error(err, errcap, "out of memory");
    return nullptr;
  }
  try {
    decode_all(src, n, out);
    return out;
  } catch (const ZstdError& e) {
    set_error(err, errcap, e.what);
  } catch (const std::bad_alloc&) {
    set_error(err, errcap, "out of memory");
  } catch (const std::exception& e) {
    set_error(err, errcap, e.what());
  }
  delete out;
  return nullptr;
}

size_t zstd_result_size(void* handle) {
  return static_cast<std::vector<uint8_t>*>(handle)->size();
}

void zstd_result_copy(void* handle, void* dst) {
  const auto* v = static_cast<std::vector<uint8_t>*>(handle);
  std::memcpy(dst, v->data(), v->size());
}

void zstd_result_free(void* handle) {
  delete static_cast<std::vector<uint8_t>*>(handle);
}

}  // extern "C"
