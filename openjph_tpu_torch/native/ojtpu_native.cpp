// Native host kernels for openjph_tpu: byte-level bitstream work that
// feeds the TPU device batches.
//
// prep_cleanup_streams: strip HTJ2K byte-stuffing from a batch of
// cleanup segments into dense LSB-first bit streams packed in uint32
// words (consumption order), one row per codeblock.  Mirrors the
// reader semantics of dec_mel_st / rev_struct / frwd_struct32
// (OpenJPH src/core/coding/ojph_block_decoder32.cpp:63-723);
// see openjph_tpu/tpu/bitprep.py for the stream conventions and the
// slow-path reference implementation.
//
// Build: g++ -O3 -shared -fPIC (driven by openjph_tpu/native/__init__.py).

#include <unistd.h>

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct BitWriter {
  uint32_t* row;
  int64_t pos = 0;  // bit position
  explicit BitWriter(uint32_t* r) : row(r) {}
  inline void push(uint32_t bit) {
    row[pos >> 5] |= bit << (pos & 31);
    ++pos;
  }
  inline void push_bits_lsb(uint32_t v, int n) {  // v's low n bits, LSB first
    for (int j = 0; j < n; ++j) push((v >> j) & 1);
  }
  inline void push_bits_msb(uint32_t v, int hi, int lo) {  // bits hi..lo
    for (int j = hi; j >= lo; --j) push((v >> j) & 1);
  }
};

inline void fill_ones_from(uint32_t* row, int64_t pos, int64_t nwords) {
  // set all bits >= pos to 1 in a row of nwords words
  const int64_t w = pos >> 5;
  const int b = static_cast<int>(pos & 31);
  if (w >= nwords) return;
  row[w] |= (b == 0) ? 0xFFFFFFFFu : ~((1u << b) - 1u);
  for (int64_t k = w + 1; k < nwords; ++k) row[k] = 0xFFFFFFFFu;
}

}  // namespace

extern "C" {


// data: concatenated segment bytes; offsets[i] .. offsets[i]+lcups[i]
// delimit block i.  Output arrays are zero-initialized by the caller
// and have mel_words/vlc_words/ms_words uint32 per row (each including
// >= 2 guard words beyond any real payload).
void prep_cleanup_streams(const uint8_t* data, const int64_t* offsets,
                          const int64_t* lcups, const int64_t* scups,
                          int64_t n, uint32_t* mel_out, int64_t mel_words,
                          uint32_t* vlc_out, int64_t vlc_words,
                          uint32_t* ms_out, int64_t ms_words) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* d = data + offsets[i];
    const int64_t lcup = lcups[i];
    const int64_t scup = scups[i];

    // ---- MEL: bytes [lcup-scup, lcup-1), MSB-first, last |= 0xF ----
    {
      BitWriter bw(mel_out + i * mel_words);
      const uint8_t* seg = d + (lcup - scup);
      const int64_t len = scup - 1;
      uint8_t prev = 0;
      for (int64_t k = 0; k < len; ++k) {
        uint8_t b = seg[k];
        if (k == len - 1) b |= 0xF;
        bw.push_bits_msb(b, (prev == 0xFF) ? 6 : 7, 0);
        prev = b;
      }
      fill_ones_from(mel_out + i * mel_words, bw.pos, mel_words);
    }

    // ---- VLC backward: nibble of d[lcup-2], then bytes downward ----
    // Reference reader semantics (rev_struct: tmp |= d << bits):
    // a dropped bit — the nibble's bit 3 when (nib&7)==7, or bit 7
    // of a stuffed byte — is not counted, but it ORs into the NEXT
    // byte's b0 position ("carry").  For streams from conformant
    // encoders the dangled bit is always 0 (drop == merge); the
    // carry keeps corrupt/crafted input decoding identical to the
    // reference (and to our scalar RevReader).
    {
      BitWriter bw(vlc_out + i * vlc_words);
      const uint8_t nib_byte = d[lcup - 2];
      const uint32_t nib = nib_byte >> 4;
      const bool special = (nib & 7) == 7;
      bw.push_bits_lsb(nib, special ? 3 : 4);
      uint32_t carry = special ? ((nib >> 3) & 1u) : 0;
      bool unstuff = (nib_byte | 0xF) > 0x8F;
      for (int64_t k = 0; k < scup - 2; ++k) {
        const uint8_t b = d[lcup - 3 - k];
        const bool dropb = unstuff && ((b & 0x7F) == 0x7F);
        bw.push_bits_lsb(b | carry, dropb ? 7 : 8);
        carry = dropb ? (b >> 7) : 0;
        unstuff = b > 0x8F;
      }
      if (carry) bw.push_bits_lsb(carry, 1);  // dangled tail bit
      // fill is zeros (rows arrive zeroed)
    }

    // ---- MagSgn forward: bytes [0, lcup-scup), LSB-first ----
    // Same carry rule as VLC: a stuffed byte's dropped b7 ORs into
    // the next byte's b0 (frwd_struct32 semantics); the ones-fill
    // absorbs a dangling tail carry.
    {
      BitWriter bw(ms_out + i * ms_words);
      const int64_t len = lcup - scup;
      uint8_t prev = 0;
      uint32_t carry = 0;
      for (int64_t k = 0; k < len; ++k) {
        const uint8_t b = d[k];
        const bool dropb = prev == 0xFF;
        bw.push_bits_lsb(b | carry, dropb ? 7 : 8);
        carry = dropb ? (b >> 7) : 0;
        prev = b;
      }
      fill_ones_from(ms_out + i * ms_words, bw.pos, ms_words);
    }
  }
}

// prep_refine_streams: dense SigProp (forward, zero fill) and MagRef
// (backward, rev_init_mrp unstuffing) bit streams of the refinement
// segment data[lcup : lcup+len2] per lane
// (ojph_block_decoder32.cpp:517-575, 581-723; see
// openjph_tpu/tpu/block_refine.py for the numpy reference).
void prep_refine_streams(const uint8_t* data, const int64_t* offsets,
                         const int64_t* lcups, const int64_t* len2s,
                         int64_t n, uint32_t* spp_out, int64_t spp_words,
                         uint32_t* mrp_out, int64_t mrp_words,
                         int64_t nthreads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* d = data + offsets[i] + lcups[i];
      const int64_t len = len2s[i];

      // ---- SigProp forward: LSB-first, 7 bits after 0xFF, zero fill
      {
        BitWriter bw(spp_out + i * spp_words);
        uint8_t prev = 0;
        uint32_t carry = 0;
        for (int64_t k = 0; k < len; ++k) {
          const uint8_t b = d[k];
          const bool dropb = prev == 0xFF;
          bw.push_bits_lsb(b | carry, dropb ? 7 : 8);
          carry = dropb ? (b >> 7) : 0;
          prev = b;
        }
      }

      // ---- MagRef backward from d[len-1]: LSB-first, bit 7 dropped
      // when the previously-read byte was > 0x8F (initially treated
      // as true) and this byte's low 7 bits are all ones; the dropped
      // bit ORs into the next byte's b0; a bit dropped from the last
      // byte stays visible before the zero fill.
      {
        BitWriter bw(mrp_out + i * mrp_words);
        bool unstuff = true;
        uint32_t carry = 0;
        for (int64_t k = len - 1; k >= 0; --k) {
          const uint8_t b = d[k];
          const bool dropb = unstuff && ((b & 0x7F) == 0x7F);
          bw.push_bits_lsb(b | carry, dropb ? 7 : 8);
          carry = dropb ? (b >> 7) : 0;
          unstuff = b > 0x8F;
        }
        if (carry) bw.push_bits_lsb(carry, 1);  // dangled tail bit
      }
    }
  };
  if (nthreads <= 1 || n < 64) {
    work(0, n);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t step = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads && t * step < n; ++t) {
    int64_t lo = t * step, hi = lo + step < n ? lo + step : n;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

namespace {

// 8-bit bit-reversal table (for MSB-first emission via LSB-first
// accumulator pushes).
struct BitRev8 {
  uint8_t t[256];
  BitRev8() {
    for (int v = 0; v < 256; ++v) {
      uint8_t r = 0;
      for (int j = 0; j < 8; ++j) r = static_cast<uint8_t>((r << 1) | ((v >> j) & 1));
      t[v] = r;
    }
  }
};
const BitRev8 kRev;

// Word-at-a-time dense bit emitter: bit k of the stream lands in
// word[k>>5] bit (k&31).  ~4 ops per input byte vs 8 single-bit
// pushes of BitWriter.
struct AccWriter {
  uint32_t* row;
  uint64_t acc = 0;
  int nbits = 0;
  int64_t words = 0;
  explicit AccWriter(uint32_t* r) : row(r) {}
  inline void push(uint32_t v, int nb) {  // v's low nb bits, LSB-first
    acc |= static_cast<uint64_t>(v) << nbits;
    nbits += nb;
    if (nbits >= 32) {
      row[words++] = static_cast<uint32_t>(acc);
      acc >>= 32;
      nbits -= 32;
    }
  }
  inline int64_t bitpos() const { return words * 32 + nbits; }
  // write the partial word (high bits zero); returns #words written
  inline int64_t flush() {
    if (nbits > 0) row[words] = static_cast<uint32_t>(acc);
    return words + (nbits > 0 ? 1 : 0);
  }
};

// One lane's three unstuffed streams written straight at their final
// positions in a shared dense word buffer (regions are disjoint, so
// lanes parallelize freely).
inline void prep_one_dense(const uint8_t* d, int64_t lcup, int64_t scup,
                           uint32_t* dense,
                           int64_t mo, int64_t ml, int64_t vo,
                           int64_t vl, int64_t so, int64_t sl) {
  // ---- MEL: bytes [lcup-scup, lcup-1), MSB-first, last |= 0xF ----
  {
    uint32_t* row = dense + mo;
    AccWriter bw(row);
    const uint8_t* seg = d + (lcup - scup);
    const int64_t len = scup - 1;
    uint8_t prev = 0;
    for (int64_t k = 0; k < len; ++k) {
      uint8_t b = seg[k];
      if (k == len - 1) b |= 0xF;
      if (prev == 0xFF)                       // 7 bits: 6..0 MSB-first
        bw.push(kRev.t[(b << 1) & 0xFF], 7);
      else                                    // 8 bits: 7..0 MSB-first
        bw.push(kRev.t[b], 8);
      prev = b;
    }
    const int64_t pos = bw.bitpos();
    bw.flush();
    fill_ones_from(row, pos, ml);
  }
  // ---- VLC backward: nibble of d[lcup-2], then bytes downward ----
  // Carry rule (rev_struct: tmp |= d << bits): a dropped bit — the
  // nibble's bit 3 when (nib&7)==7, or bit 7 of a stuffed byte —
  // ORs into the next byte's b0 position; always 0 for conformant
  // encoders, but it keeps corrupt input bit-identical to the
  // reference reader.
  {
    uint32_t* row = dense + vo;
    AccWriter bw(row);
    const uint8_t nib_byte = d[lcup - 2];
    const uint32_t nib = nib_byte >> 4;
    const bool special = (nib & 7) == 7;
    bw.push(nib & (special ? 7u : 0xFu), special ? 3 : 4);
    uint32_t carry = special ? ((nib >> 3) & 1u) : 0;
    bool unstuff = (nib_byte | 0xF) > 0x8F;
    for (int64_t k = 0; k < scup - 2; ++k) {
      const uint8_t b = d[lcup - 3 - k];
      const bool dropb = unstuff && ((b & 0x7F) == 0x7F);
      const int nb = dropb ? 7 : 8;
      bw.push((b | carry) & ((1u << nb) - 1u), nb);
      carry = dropb ? (b >> 7) : 0;
      unstuff = b > 0x8F;
    }
    if (carry) bw.push(carry, 1);  // dangled tail bit
    const int64_t wrote = bw.flush();
    if (wrote < vl)  // fill stays zero
      std::memset(row + wrote, 0, static_cast<size_t>(vl - wrote) * 4);
  }
  // ---- MagSgn forward: bytes [0, lcup-scup), LSB-first ----
  // Same carry rule (frwd_struct32); the ones-fill absorbs a
  // dangling tail carry.
  {
    uint32_t* row = dense + so;
    AccWriter bw(row);
    const int64_t len = lcup - scup;
    uint8_t prev = 0;
    uint32_t carry = 0;
    for (int64_t k = 0; k < len; ++k) {
      const uint8_t b = d[k];
      const bool dropb = prev == 0xFF;
      if (dropb)
        bw.push((b | carry) & 0x7F, 7);
      else
        bw.push(b | carry, 8);
      carry = dropb ? (b >> 7) : 0;
      prev = b;
    }
    const int64_t pos = bw.bitpos();
    bw.flush();
    fill_ones_from(row, pos, sl);
  }
}

}  // namespace

extern "C" {

// Unstuff a batch of cleanup segments directly into a shared dense
// uint32 buffer (per-lane offsets/lengths precomputed by the caller;
// regions must not overlap).  meta: int32 [n, 8] rows of
// (mel_off, mel_len, vlc_off, vlc_len, ms_off, ms_len, p, qhl) —
// the device-side layout of pipeline._pack_burst.
void prep_cleanup_dense(const uint8_t* data, const int64_t* offsets,
                        const int64_t* lcups, const int64_t* scups,
                        int64_t n, const int32_t* meta,
                        uint32_t* dense, int64_t nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto work = [&](int64_t t) {
    for (int64_t i = t; i < n; i += nthreads) {
      const int32_t* m = meta + i * 8;
      prep_one_dense(data + offsets[i], lcups[i], scups[i], dense,
                     m[0], m[1], m[2], m[3], m[4], m[5]);
    }
  };
  if (nthreads == 1) {
    work(0);
  } else {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < nthreads; ++t) ts.emplace_back(work, t);
    for (auto& th : ts) th.join();
  }
}

}  // extern "C"

namespace {

// Worker threads made once and kept, for the one host copy large enough
// to split (pack_raw_burst): run(k, f) calls f(0) .. f(k-1), part 0 on
// the caller, the rest on whichever thread takes them first, and returns
// when all are done.  Callers take turns.  A forked child makes a pool
// of its own.
class PackPool {
 public:
  // the most parts a call splits into: the caller and the workers
  static int width() {
    static const int w = static_cast<int>(
        std::min(8u, std::max(std::thread::hardware_concurrency(), 1u)));
    return w;
  }

  static PackPool& get() {
    static std::mutex mu;
    static PackPool* pool = nullptr;
    std::lock_guard<std::mutex> lk(mu);
    if (pool == nullptr || pool->pid_ != getpid()) {
      // never freed: its threads outlive every caller
      pool = new PackPool(width() - 1);
    }
    return *pool;
  }

  void run(int k, const std::function<void(int)>& f) {
    std::lock_guard<std::mutex> one(call_);
    {
      std::lock_guard<std::mutex> lk(mu_);
      job_ = &f;
      parts_ = k;
      next_ = 1;
      left_ = k - 1;
      ++gen_;
    }
    go_.notify_all();
    f(0);
    std::unique_lock<std::mutex> lk(mu_);
    take(lk);
    done_.wait(lk, [this] { return left_ == 0; });
    job_ = nullptr;
  }

 private:
  explicit PackPool(int workers) : pid_(getpid()) {
    for (int t = 0; t < workers; ++t) std::thread([this] { loop(); }).detach();
  }

  // runs the job's parts not yet taken; mu_ held on entry and on return
  void take(std::unique_lock<std::mutex>& lk) {
    while (next_ < parts_) {
      const int i = next_++;
      const std::function<void(int)>& f = *job_;
      lk.unlock();
      f(i);
      lk.lock();
      if (--left_ == 0) done_.notify_one();
    }
  }

  void loop() {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      go_.wait(lk, [&] { return gen_ != seen; });
      seen = gen_;
      take(lk);
    }
  }

  const pid_t pid_;
  std::mutex call_, mu_;
  std::condition_variable go_, done_;
  const std::function<void(int)>* job_ = nullptr;
  int parts_ = 0, next_ = 0, left_ = 0;
  uint64_t gen_ = 0;
};

}  // namespace

extern "C" {

// Lay out the raw (still byte-stuffed) segment bytes of a burst's lanes
// for the kernels that unstuff them on the device
// (gpu/pipeline.py::_pack_device): the whole upload buffer, every byte
// written once.  First ``lead`` zero bytes; then each lane's range: its
// cleanup bytes d[0:lcup-1] verbatim except byte lcup-2 (the shared
// MEL-last / VLC-nibble byte) OR'd with 0xF -- transparent to the VLC
// reader (its nibble is the high 4 bits, and its initial unstuff test
// already ORs 0xF: ojph_block_decoder32.cpp dec_mel_st / rev_struct
// init) and required by the MEL reader -- followed by its len2[i]
// refinement bytes d[lcup:lcup+len2].  The MagSgn stream is bytes
// [0, lcup-scup) of the range; MEL reads the rest forward, VLC backward.
// src_ptrs[i] is the host address of lane i's bytes (lanes may come from
// different frames' buffers); 0 marks a dead lane, whose range is the
// canonical byte 0x0F and zeros.  Zeros up to ``padded``; then the meta
// plane, int32 [n, 8] of (range start, lcup - scup, scup - 1, 0, 0, 0,
// p, qhl), and where len2 is given, the rmeta plane, int32 [n, 8] of
// (range start + lcup - 1, len2, 0, 0, npasses, h_true, causal, 0).
// With len2 null, no lane has a refinement segment and no rmeta is
// written.  Nothing is counted.  The lanes split into at most ``parts``
// contiguous runs of about equal bytes, on the threads of PackPool.
void pack_raw_burst(int64_t n, const int64_t* src_ptrs,
                    const int64_t* lcups, const int64_t* scups,
                    const int32_t* p, const int32_t* qhl,
                    const int64_t* len2, const int32_t* npasses,
                    const int32_t* h_true, const uint8_t* causal,
                    int64_t lead, int64_t padded, int64_t parts,
                    uint8_t* out) {
  // at[i]: lane i's range start; at[n]: the end of the last range
  std::vector<int64_t> at(static_cast<size_t>(n) + 1);
  at[0] = lead;
  for (int64_t i = 0; i < n; ++i)
    at[i + 1] = at[i] + lcups[i] - 1 + (len2 ? len2[i] : 0);
  int32_t* meta = reinterpret_cast<int32_t*>(out + padded);
  int32_t* rmeta = len2 ? meta + 8 * n : nullptr;
  auto lanes = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      const int64_t lc = lcups[i] - 1;
      const int64_t l2 = len2 ? len2[i] : 0;
      uint8_t* o = out + at[i];
      if (src_ptrs[i] != 0) {
        const uint8_t* d = reinterpret_cast<const uint8_t*>(src_ptrs[i]);
        if (lc > 0) {
          std::memcpy(o, d, static_cast<size_t>(lc));
          o[lc - 1] |= 0xF;
        }
        if (l2 > 0) std::memcpy(o + lc, d + lc + 1, static_cast<size_t>(l2));
      } else if (lc + l2 > 0) {
        o[0] = 0x0F;
        std::memset(o + 1, 0, static_cast<size_t>(lc + l2 - 1));
      }
      int32_t* m = meta + 8 * i;
      m[0] = static_cast<int32_t>(at[i]);
      m[1] = static_cast<int32_t>(lcups[i] - scups[i]);
      m[2] = static_cast<int32_t>(scups[i] - 1);
      m[3] = m[4] = m[5] = 0;
      m[6] = p[i];
      m[7] = qhl[i];
      if (rmeta) {
        int32_t* r = rmeta + 8 * i;
        r[0] = static_cast<int32_t>(at[i] + lc);
        r[1] = static_cast<int32_t>(l2);
        r[2] = r[3] = 0;
        r[4] = npasses[i];
        r[5] = h_true[i];
        r[6] = causal[i];
        r[7] = 0;
      }
    }
  };
  const int k = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>({parts, PackPool::width(), n})));
  // part j: the lanes whose range starts in its share of the bytes; the
  // first also zeroes the lead, the last the tail
  std::vector<int64_t> cut(static_cast<size_t>(k) + 1);
  cut[0] = 0;
  cut[k] = n;
  for (int j = 1; j < k; ++j)
    cut[j] = std::lower_bound(at.begin(), at.end() - 1,
                              lead + (at[n] - lead) * j / k) - at.begin();
  auto part = [&](int j) {
    if (j == 0) std::memset(out, 0, static_cast<size_t>(lead));
    lanes(cut[j], cut[j + 1]);
    if (j == k - 1)
      std::memset(out + at[n], 0, static_cast<size_t>(padded - at[n]));
  };
  if (k == 1)
    part(0);
  else
    PackPool::get().run(k, part);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Tier-2 packet-header parser (decode side).  Port of
// core/t2.py:parse_precinct (itself mirroring precinct::parse,
// ojph_precinct.cpp:328-573): tag-tree inclusion + missing-MSBs,
// pass counts, Lblock/lengths, body byte ranges.  This is the hot
// host-side loop of decode (pure bit twiddling), hence C++.
// ---------------------------------------------------------------------------

namespace {

struct HdrReader {  // core/bitio.py BitReader semantics
  const uint8_t* buf;
  int64_t pos, left;
  uint32_t tmp = 0;
  int avail = 0;
  bool unstuff = false;
  bool eof = false;

  HdrReader(const uint8_t* b, int64_t p, int64_t l)
      : buf(b), pos(p), left(l) {}

  bool readbyte() {
    if (left > 0) {
      uint8_t t = buf[pos++];
      tmp = t;
      avail = 8 - (unstuff ? 1 : 0);
      unstuff = (t == 0xFF);
      --left;
      return true;
    }
    tmp = 0;
    avail = 8 - (unstuff ? 1 : 0);
    unstuff = false;
    return false;
  }
  int bit() {
    if (avail == 0 && !readbyte()) {
      eof = true;
      return 0;
    }
    --avail;
    return (tmp >> avail) & 1;
  }
  uint32_t bits(int n) {
    uint32_t v = 0;
    while (n) {
      if (avail == 0 && !readbyte()) {
        eof = true;
        return 0;
      }
      int tx = avail < n ? avail : n;
      v <<= tx;
      avail -= tx;
      n -= tx;
      v |= (tmp >> avail) & ((1u << tx) - 1u);
    }
    return v;
  }
  // returns 0 ok, 2 on bad EPH
  int terminate(bool uses_eph) {
    if (unstuff) readbyte();
    tmp = 0;
    avail = 0;
    if (uses_eph && left >= 2) {
      uint8_t m0 = buf[pos], m1 = buf[pos + 1];
      pos += 2;
      left -= 2;
      if (m0 != 0xFF || m1 != 0x92) return 2;
    }
    return 0;
  }
  int skip_sop() {  // 0 ok, 1 eof, 2 bad length
    if (left >= 2 && buf[pos] == 0xFF && buf[pos + 1] == 0x91) {
      pos += 2;
      left -= 2;
      if (left >= 4) {
        int ln = (buf[pos] << 8) | buf[pos + 1];
        if (ln != 4) return 2;
        pos += ln;      // Lsop(2) + Nsop(2)
        left -= ln;
      } else {
        return 1;
      }
    }
    return 0;
  }
};

inline int log2ceil(int x) {
  if (x <= 1) return 0;
  int n = 0;
  for (int v = x - 1; v; v >>= 1) ++n;
  return n;
}

// small tag tree (values + sent flags) for parsing
struct PTagTree {
  int w, h, num_levels;
  std::vector<std::vector<int32_t>> val, flg;
  std::vector<int> lw, lh;

  PTagTree(int w_, int h_) : w(w_), h(h_) {
    num_levels = 1 + (log2ceil(w) > log2ceil(h) ? log2ceil(w)
                                                : log2ceil(h));
    int cw = w, ch = h;
    for (int l = 0; l < num_levels; ++l) {
      val.emplace_back(static_cast<size_t>(cw) * ch, 0);
      flg.emplace_back(static_cast<size_t>(cw) * ch, 0);
      lw.push_back(cw);
      lh.push_back(ch);
      cw = (cw + 1) / 2;
      ch = (ch + 1) / 2;
    }
    val.emplace_back(1, 0);  // sentinel root
    flg.emplace_back(1, 0);
    lw.push_back(1);
    lh.push_back(1);
  }
  int32_t& at(std::vector<std::vector<int32_t>>& a, int x, int y,
              int lev) {
    if (lev >= num_levels) return a[num_levels][0];
    return a[lev][static_cast<size_t>(y >> lev) * lw[lev] + (x >> lev)];
  }
  int32_t get(int x, int y, int lev) { return at(val, x, y, lev); }
};

}  // namespace

extern "C" {

// bands: int32 [4*7]: per band (present, num_x, num_y, org_x, org_y,
// num_cb_x, kmax).  out_cb: int32 [max_cb*8]: (band, cb_index, mmsbs,
// num_passes, len0, len1, data_pos_lo32<<nothing... data handled via
// st) — actually (band, cb_index, mmsbs, num_passes, len0, len1,
// data_pos rel to buf as int32 pair) is too narrow for >2GB streams,
// so data positions are int64 in out_pos[max_cb].
// st (int64 [3]) out: new_pos, new_left, n_out.
// Returns 0 ok; 1 truncated header (EOFError); 2.. value errors.
int64_t t2_parse_packet(const uint8_t* buf, int64_t pos,
                        int64_t bytes_left, int32_t may_use_sop,
                        int32_t uses_eph, int32_t skip_data,
                        const int32_t* bands, int32_t* out_cb,
                        int64_t* out_pos, int64_t* st) {
  HdrReader br(buf, pos, bytes_left);
  if (may_use_sop) {
    int rc = br.skip_sop();
    if (rc) return rc == 1 ? 1 : 3;
  }
  bool empty_packet = true;
  int64_t n_out = 0;

  for (int s = 0; s < 4; ++s) {
    const int32_t* B = bands + s * 7;
    if (!B[0]) continue;
    const int num_x = B[1], num_y = B[2], org_x = B[3], org_y = B[4];
    const int num_cb_x = B[5], kmax = B[6];
    if (num_x == 0 || num_y == 0) continue;

    if (empty_packet) {
      if (br.bit() == 0) {
        if (br.eof) return 1;
        int rc = br.terminate(uses_eph);
        if (rc) return 4;
        st[0] = br.pos;
        st[1] = br.left;
        st[2] = n_out;
        return 0;
      }
      if (br.eof) return 1;
      empty_packet = false;
    }

    PTagTree inc(num_x, num_y), mmsb(num_x, num_y);
    const int nl = inc.num_levels;

    for (int y = 0; y < num_y; ++y) {
      for (int x = 0; x < num_x; ++x) {
        int32_t* rec = out_cb + n_out * 8;
        rec[0] = s;
        rec[1] = (org_y + y) * num_cb_x + org_x + x;
        rec[2] = 0;
        rec[3] = 0;  // num_passes 0 => not included
        rec[4] = 0;
        rec[5] = 0;
        rec[6] = 0;
        rec[7] = 0;
        out_pos[n_out] = 0;
        ++n_out;

        bool empty_cb = false;
        for (int cl = nl; cl >= 1; --cl) {
          int cur = cl - 1;
          if (inc.get(x, y, cur) == 1) {
            empty_cb = true;
            break;
          }
          int32_t& fl = inc.at(inc.flg, x, y, cur);
          if (fl == 0) {
            int b = br.bit();
            if (br.eof) return 1;
            empty_cb = (b == 0);
            inc.at(inc.val, x, y, cur) = 1 - b;
            fl = 1;
          }
          if (empty_cb) break;
        }
        if (empty_cb) continue;

        // missing msbs
        int32_t mmsbs = 0;
        for (int levp1 = nl; levp1 >= 1; --levp1) {
          int cur = levp1 - 1;
          mmsbs = mmsb.get(x, y, levp1);
          int32_t& fl = mmsb.at(mmsb.flg, x, y, cur);
          if (fl == 0) {
            while (br.bit() == 0) {
              if (br.eof) return 1;
              ++mmsbs;
            }
            if (br.eof) return 1;
            mmsb.at(mmsb.val, x, y, cur) = mmsbs;
            fl = 1;
          }
        }
        if (mmsbs > kmax) return 5;  // likely corruption
        rec[2] = mmsbs;

        // number of passes
        int num_passes = 1;
        if (br.bit()) {
          num_passes = 2;
          if (br.bit()) {
            uint32_t t = br.bits(2);
            num_passes = 3 + static_cast<int>(t);
            if (t == 3) {
              t = br.bits(5);
              num_passes = 6 + static_cast<int>(t);
              if (t == 31) num_passes = 37 + static_cast<int>(br.bits(7));
            }
          }
        }
        if (br.eof) return 1;

        // placeholder passes (ojph_precinct.cpp:466-479)
        int phld = (num_passes - 1) / 3;
        rec[2] += phld;
        int np = num_passes - phld * 3;
        rec[3] = np;

        int lblock = 3;
        while (br.bit()) {
          if (br.eof) return 1;
          ++lblock;
        }
        if (br.eof) return 1;
        int extra = 0;
        for (int v = phld + 1; v > 1; v >>= 1) ++extra;
        uint32_t ln = br.bits(lblock + extra);
        if (br.eof) return 1;
        if (ln < 2) return 6;       // HT cleanup segment < 2 bytes
        if (ln >= 65535) return 7;  // HT cleanup segment >= 65535
        rec[4] = static_cast<int32_t>(ln);
        if (np > 1) {
          uint32_t l2 = br.bits(lblock + (np > 2 ? 1 : 0));
          if (br.eof) return 1;
          if (l2 >= 2047) return 8;  // HT refinement >= 2047
          rec[5] = static_cast<int32_t>(l2);
        }
        rec[6] = 1;  // included
      }
    }
  }

  if (empty_packet) {
    br.bit();
    if (br.eof) return 1;
  }
  {
    int rc = br.terminate(uses_eph);
    if (rc) return 4;
  }

  // body byte ranges (t2.py:parse_precinct tail)
  int64_t p = br.pos, left = br.left;
  for (int64_t i = 0; i < n_out; ++i) {
    int32_t* rec = out_cb + i * 8;
    if (!rec[6]) continue;
    int64_t nbytes = static_cast<int64_t>(rec[4]) + rec[5];
    if (left && nbytes) {
      int64_t avail = nbytes < left ? nbytes : left;
      if (skip_data) {
        rec[4] = rec[5] = 0;
      } else if (avail < nbytes) {  // truncated -> broken block
        rec[4] = rec[5] = 0;
        rec[7] = 0;
      } else {
        out_pos[i] = p;
        rec[7] = static_cast<int32_t>(nbytes);
      }
      p += avail;
      left -= avail;
    } else if (left == 0) {
      rec[4] = rec[5] = 0;
    }
  }
  st[0] = p;
  st[1] = left;
  st[2] = n_out;
  return 0;
}

// t2_walk_tile_part: the packets of one tile-part payload, parsed from
// packet k0 of the tile's packet table until the data or the table
// ends, each packet's codeblock records written in place once the whole
// packet has parsed (codec.Decoder._walk).
// pk: int32 [npk * 36], a row a packet in codestream order: the
// t2_parse_packet band table (4 * 7), skip_data, may_use_sop, uses_eph,
// the offset of each band's records in the tile's tables (4), and the
// packet's codeblock count.
// rec: int32 [ncb * 6] (mmsbs, num_passes, len0, len1, included,
// nbytes); rpos: int64 [ncb] data positions.
// st (int64 [3]) out: the next packet to parse, pos, bytes left; on an
// error the next packet is the one after the malformed one, and pos /
// bytes left are those before it.
// Returns 0, a t2_parse_packet code, or 9 when a record falls outside
// the tables.
int64_t t2_walk_tile_part(const uint8_t* buf, int64_t pos,
                          int64_t bytes_left, const int32_t* pk,
                          int64_t npk, int64_t k0, int32_t* rec,
                          int64_t* rpos, int64_t ncb, int64_t* st) {
  int64_t maxcb = 1;
  for (int64_t k = k0; k < npk; ++k)
    maxcb = std::max<int64_t>(maxcb, pk[k * 36 + 35]);
  std::vector<int32_t> cbs(static_cast<size_t>(maxcb) * 8);
  std::vector<int64_t> cpos(static_cast<size_t>(maxcb));
  int64_t k = k0;
  int64_t rc = 0;
  int64_t pst[3];
  while (bytes_left > 0 && k < npk) {
    const int32_t* P = pk + k * 36;
    ++k;
    rc = t2_parse_packet(buf, pos, bytes_left, P[29], P[30], P[28], P,
                         cbs.data(), cpos.data(), pst);
    if (rc) break;
    const int64_t n = pst[2];
    for (int64_t i = 0; i < n; ++i) {
      const int32_t* c = cbs.data() + i * 8;
      const int64_t at = static_cast<int64_t>(P[31 + c[0]]) + c[1];
      if (at < 0 || at >= ncb) {
        rc = 9;
        break;
      }
      std::memcpy(rec + at * 6, c + 2, 6 * sizeof(int32_t));
      rpos[at] = cpos[i];
    }
    if (rc) break;
    pos = pst[0];
    bytes_left = pst[1];
  }
  st[0] = k;
  st[1] = pos;
  st[2] = bytes_left;
  return rc;
}

// plan_lanes: the per-lane arrays of a frame's plan
// (gpu/pipeline.py::_build_plan) from the tiles' Tier-2 records, and the
// host decoder's per-codeblock checks (_broken_lanes), in one pass a
// lane group.
// groups: int32 [ng * 4] of (members, padded lanes, wide band, first
// entry in the lane map); the lane map (lt, li, qh, ht, cz) gives each
// member its tile's place in rec_ptrs / pos_ptrs (whose tables hold
// tile_ncb[t] records), its record, and its geometry: (height + 1) / 2,
// height, causal.  Outputs, a padded lane each, groups in order: pos,
// lcup, scup, p, qhl, npasses, len2, h_true, causal, and code (0, or 1
// + the first check the lane fails, on live lanes only); gstat: int64
// [ng * 4] of (bits, max scup, max lcup - scup over live lanes, -1 for
// both without one; max len2).  A broken lane is planned dead.
// Returns 0, or -1 when a lane's record lies outside its tile's tables.
int64_t plan_lanes(const uint8_t* buf, int64_t buflen,
                   const int64_t* rec_ptrs, const int64_t* pos_ptrs,
                   const int64_t* tile_ncb, int64_t ntiles,
                   const int32_t* groups, int64_t ng, const int32_t* lt,
                   const int32_t* li, const int32_t* qh, const int32_t* ht,
                   const uint8_t* cz, int64_t* o_pos, int64_t* o_lcup,
                   int64_t* o_scup, int32_t* o_p, int32_t* o_qhl,
                   int32_t* o_np, int64_t* o_l2, int32_t* o_h,
                   uint8_t* o_cz, int32_t* o_code, int64_t* gstat) {
  int64_t out = 0;
  for (int64_t gi = 0; gi < ng; ++gi) {
    const int32_t nm = groups[gi * 4], n_pad = groups[gi * 4 + 1];
    const bool wide = groups[gi * 4 + 2] != 0;
    const int64_t m0 = groups[gi * 4 + 3];
    bool any_wide_lane = false;
    // pass 1: the checks, in the host decoder's order; o_scup holds
    // scup, o_np the clamped npasses, o_code the code, o_pos -2 for a
    // live lane that passed them
    for (int32_t j = 0; j < nm; ++j) {
      const int64_t m = m0 + j, o = out + j;
      const int32_t t = lt[m];
      if (t < 0 || t >= ntiles || li[m] < 0 || li[m] >= tile_ncb[t])
        return -1;
      const int32_t* r =
          reinterpret_cast<const int32_t*>(rec_ptrs[t]) + li[m] * 6;
      const int64_t poss = reinterpret_cast<const int64_t*>(pos_ptrs[t])[li[m]];
      const int32_t mm = r[0], npr = r[1], l0 = r[2], l1 = r[3];
      const int32_t inc = r[4], nb = r[5];
      const bool live = inc != 0 && npr != 0 && l0 != 0 && nb != 0;
      int32_t np = (npr > 1 && l1 == 0) ? 1 : npr;
      int32_t code = 0;
      int64_t scup = 2;
      if (live) {
        const int64_t avail = std::min<int64_t>(nb, buflen - poss);
        const int64_t need = static_cast<int64_t>(l0) + (npr > 1 ? l1 : 0);
        if (avail < need) {
          code = 1;
        } else if (np > 3) {
          code = 2;
        } else if (mm >= 62) {
          code = 3;
        } else if (l0 < 2) {
          code = 4;
        } else {
          const int64_t last = poss + l0;
          if (last < 2 || last > buflen) {
            code = 1;
          } else {
            scup = (static_cast<int64_t>(buf[last - 1]) << 4)
                   + (buf[last - 2] & 0xF);
            if (scup < 2 || scup > l0 || scup > 4079) code = 5;
          }
        }
      }
      if (mm == 29 || mm == 61) np = 1;
      o_code[o] = code;
      o_np[o] = np;
      o_scup[o] = scup;
      o_pos[o] = (live && code == 0) ? poss : -1;
      if (live && code == 0 && mm >= 30) any_wide_lane = true;
    }
    const int32_t bits = (wide || any_wide_lane) ? 64 : 32;
    const int32_t pbase = bits - 2;
    int64_t smax = -1, msmax = -1, l2max = 0;
    // pass 2: the lanes, dead and broken ones as padding
    for (int32_t j = 0; j < n_pad; ++j) {
      const int64_t o = out + j;
      const bool member = j < nm;
      const bool live = member && o_pos[o] >= 0;
      o_cz[o] = member ? cz[m0 + j] : 0;
      o_code[o] = member ? o_code[o] : 0;
      if (!live) {
        o_pos[o] = -1;
        o_lcup[o] = 2;
        o_scup[o] = 2;
        o_p[o] = pbase;
        o_qhl[o] = 0;
        o_np[o] = 1;
        o_l2[o] = 0;
        o_h[o] = 0;
        continue;
      }
      const int64_t m = m0 + j;
      const int32_t* r =
          reinterpret_cast<const int32_t*>(rec_ptrs[lt[m]]) + li[m] * 6;
      const int32_t np = o_np[o];
      o_lcup[o] = r[2];
      o_p[o] = pbase - r[0];
      o_qhl[o] = qh[m];
      o_l2[o] = np <= 1 ? 0 : r[3];
      o_h[o] = ht[m];
      smax = std::max<int64_t>(smax, o_scup[o]);
      msmax = std::max<int64_t>(msmax, o_lcup[o] - o_scup[o]);
      l2max = std::max<int64_t>(l2max, o_l2[o]);
    }
    gstat[gi * 4] = bits;
    gstat[gi * 4 + 1] = smax;
    gstat[gi * 4 + 2] = msmax;
    gstat[gi * 4 + 3] = l2max;
    out += n_pad;
  }
  return 0;
}

}  // extern "C"

namespace {

struct HdrWriter {  // core/bitio.py BitWriter semantics (MSB-first,
                    // 7-bit byte after an emitted 0xFF)
  uint8_t* out;
  int64_t cap;
  int64_t n = 0;
  int avail = 8;
  uint32_t tmp = 0;
  bool ovf = false;
  HdrWriter(uint8_t* o, int64_t c) : out(o), cap(c) {}
  inline void put_bit(uint32_t b) {
    --avail;
    tmp |= (b & 1u) << avail;
    if (avail <= 0) {
      if (n >= cap) { ovf = true; avail = 8; tmp = 0; return; }
      avail = 8 - (tmp == 0xFF ? 1 : 0);
      out[n++] = static_cast<uint8_t>(tmp);
      tmp = 0;
    }
  }
  inline void put_bits(uint32_t v, int nb) {
    for (int i = nb - 1; i >= 0; --i) put_bit((v >> i) & 1u);
  }
  inline void put_zeros(int nb) { for (int i = 0; i < nb; ++i) put_bit(0); }
  inline void terminate() {
    if (avail < 8) {
      if (n >= cap) { ovf = true; return; }
      out[n++] = static_cast<uint8_t>(tmp);
      tmp = 0;
      avail = 8;
    }
  }
};

struct ETagTree {  // min-reduced tag tree for emit (t2.py TagTree)
  PTagTree t;
  ETagTree(int w, int h, int32_t init_val) : t(w, h) {
    for (int l = 0; l <= t.num_levels; ++l)
      std::fill(t.val[l].begin(), t.val[l].end(),
                l < t.num_levels ? init_val : 0);
  }
  void set_leaf(int x, int y, int32_t v) {
    t.val[0][static_cast<size_t>(y) * t.lw[0] + x] = v;
  }
  void reduce_min() {
    for (int l = 1; l < t.num_levels; ++l) {
      const int cw = t.lw[l - 1], ch = t.lh[l - 1];
      for (int y = 0; y < t.lh[l]; ++y)
        for (int x = 0; x < t.lw[l]; ++x) {
          int32_t m = INT32_MAX;
          for (int dy = 0; dy < 2 && 2 * y + dy < ch; ++dy)
            for (int dx = 0; dx < 2 && 2 * x + dx < cw; ++dx) {
              int32_t v = t.val[l - 1][
                  static_cast<size_t>(2 * y + dy) * cw + 2 * x + dx];
              if (v < m) m = v;
            }
          t.val[l][static_cast<size_t>(y) * t.lw[l] + x] = m;
        }
    }
  }
  int32_t get(int x, int y, int lev) { return t.get(x, y, lev); }
  int32_t& flag(int x, int y, int lev) { return t.at(t.flg, x, y, lev); }
};

inline int bit_length(uint32_t v) {
  int n = 0;
  while (v) { ++n; v >>= 1; }
  return n;
}

}  // namespace

extern "C" {

// t2_emit_packet: write one packet header (T.800 B.10 single-layer
// dialect; port of core/t2.py::encode_precinct, itself mirroring
// precinct::prepare_precinct + write, ojph_precinct.cpp:94-324).
//
// bands: int32 [4*7] rows (present, num_x, num_y, _, _, _, _); recs:
// int32 [sum(num_x*num_y)*5] band-major raster rows of (has_data,
// missing_msbs, num_passes, len0, len1).  Writes header bytes to out
// (cap bytes).  Returns header length; -1 on overflow (caller falls
// back), -2 on unsupported num_passes.  The caller handles the empty
// packet (no included block anywhere) itself.
int64_t t2_emit_packet(const int32_t* bands, const int32_t* recs,
                       uint8_t* out, int64_t cap) {
  HdrWriter bw(out, cap);
  bool started = false;
  int num_skipped = 0;
  int64_t base = 0;

  for (int s = 0; s < 4; ++s) {
    const int32_t* B = bands + s * 7;
    if (!B[0]) continue;
    const int num_x = B[1], num_y = B[2];
    if (num_x == 0 || num_y == 0) continue;
    const int32_t* R = recs + base * 5;
    base += static_cast<int64_t>(num_x) * num_y;

    // each tree's flg planes (zero-initialized) serve as the "sent"
    // flags the Python version keeps in separate TagTrees
    ETagTree inc(num_x, num_y, 255), mmsb(num_x, num_y, 255);
    for (int y = 0; y < num_y; ++y)
      for (int x = 0; x < num_x; ++x) {
        const int32_t* rec = R + (static_cast<int64_t>(y) * num_x + x) * 5;
        inc.set_leaf(x, y, rec[0] ? 0 : 1);
        mmsb.set_leaf(x, y, rec[0] ? rec[1] : 0);
      }
    inc.reduce_min();
    mmsb.reduce_min();

    const int nl = inc.t.num_levels;
    if (inc.get(0, 0, nl - 1) != 0) {  // empty subband
      if (started) bw.put_bit(0);
      else ++num_skipped;
      continue;
    }
    if (!started) {
      started = true;
      bw.put_bit(1);
      bw.put_zeros(num_skipped);
    }

    for (int y = 0; y < num_y; ++y)
      for (int x = 0; x < num_x; ++x) {
        const int32_t* rec = R + (static_cast<int64_t>(y) * num_x + x) * 5;
        // inclusion bits down the tag tree
        for (int cl = nl; cl >= 1; --cl) {
          const int lm1 = cl - 1;
          int32_t& fl = inc.flag(x, y, lm1);
          if (fl == 0) {
            const int skipped = inc.get(x, y, lm1) - inc.get(x, y, cl);
            bw.put_bit(1 - skipped);
            fl = 1;
          }
          if (inc.get(x, y, lm1) > 0) break;
        }
        if (!rec[0] || rec[2] == 0) continue;

        // missing msbs (unary over the tag tree)
        for (int cl = nl; cl >= 1; --cl) {
          const int lm1 = cl - 1;
          int32_t& fl = mmsb.flag(x, y, lm1);
          if (fl == 0) {
            bw.put_zeros(mmsb.get(x, y, lm1) - mmsb.get(x, y, cl));
            bw.put_bit(1);
            fl = 1;
          }
        }

        // number of passes (T.800 Table B.4)
        const int np = rec[2];
        if (np == 3) bw.put_bits(12, 4);
        else if (np == 2) bw.put_bits(2, 2);
        else if (np == 1) bw.put_bit(0);
        else return -2;

        // pass lengths: Lblock escape then lengths
        const uint32_t l0 = static_cast<uint32_t>(rec[3]);
        const uint32_t l1 = static_cast<uint32_t>(rec[4]);
        const int bits1 = bit_length(l0);
        const int extra = np > 2 ? 1 : 0;
        const int bits2 = np > 1 ? bit_length(l1) : 0;
        int bits = bits1 > bits2 - extra ? bits1 : bits2 - extra;
        bits = bits - 3 > 0 ? bits - 3 : 0;
        bw.put_bits(0xFFFFFFFEu & ((1u << (bits + 1)) - 1u), bits + 1);
        bw.put_bits(l0, bits + 3);
        if (np > 1) bw.put_bits(l1, bits + 3 + extra);
      }
  }

  bw.terminate();
  if (bw.ovf) return -1;
  return bw.n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Cleanup-segment byte packers (encode side).  Port of the reference's
// MEL / backward-VLC / MagSgn emitters (ojph_block_encoder.cpp:273-533)
// fed from device-computed per-quad-pair records.
// ---------------------------------------------------------------------------

namespace {

constexpr int kMelExp[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};

struct MelEnc {  // ojph_block_encoder.cpp:273-347
  uint8_t buf[4096];
  int len = 0;
  int remaining_bits = 8;
  uint32_t tmp = 0;
  int run = 0;
  int k = 0;
  int threshold = 1;
  bool ovf = false;  // capacity exceeded: caller must fall back
  inline void emit_bit(int v) {
    tmp = (tmp << 1) + static_cast<uint32_t>(v);
    if (--remaining_bits == 0) {
      if (len >= static_cast<int>(sizeof(buf))) {
        ovf = true;
      } else {
        buf[len++] = static_cast<uint8_t>(tmp);
      }
      remaining_bits = (tmp == 0xFF) ? 7 : 8;
      tmp = 0;
    }
  }
  inline void encode(bool bit) {
    if (!bit) {
      if (++run >= threshold) {
        emit_bit(1);
        run = 0;
        k = (k + 1 < 12) ? k + 1 : 12;
        threshold = 1 << kMelExp[k];
      }
    } else {
      emit_bit(0);
      for (int t = kMelExp[k] - 1; t >= 0; --t) emit_bit((run >> t) & 1);
      run = 0;
      k = (k - 1 > 0) ? k - 1 : 0;
      threshold = 1 << kMelExp[k];
    }
  }
};

struct VlcEnc {  // backward-growing, ojph_block_encoder.cpp:352-407
  uint8_t buf[4096];
  int len = 0;  // bytes in emission order (reverse of file order)
  int used_bits = 4;
  uint32_t tmp = 0xF;
  bool last_gt_8f = true;
  bool ovf = false;  // capacity exceeded: caller must fall back
  inline void encode(uint32_t cwd, int cwd_len) {
    while (cwd_len > 0) {
      int avail = 8 - (last_gt_8f ? 1 : 0) - used_bits;
      int t = (avail < cwd_len) ? avail : cwd_len;
      tmp |= (cwd & ((1u << t) - 1)) << used_bits;
      used_bits += t;
      avail -= t;
      cwd_len -= t;
      cwd >>= t;
      if (avail == 0) {
        if (last_gt_8f && tmp != 0x7F) {
          last_gt_8f = false;
          continue;
        }
        if (len >= static_cast<int>(sizeof(buf))) {
          ovf = true;
          return;
        }
        buf[len++] = static_cast<uint8_t>(tmp);
        last_gt_8f = tmp > 0x8F;
        tmp = 0;
        used_bits = 0;
      }
    }
  }
};

struct MsEnc {  // forward MagSgn, ojph_block_encoder.cpp:446-533
  uint8_t* buf;
  int64_t cap;  // writable bytes in buf; exceeding sets ovf
  int64_t len = 0;
  int max_bits = 8;
  uint64_t tmp = 0;
  int used_bits = 0;
  bool ovf = false;
  MsEnc(uint8_t* b, int64_t c) : buf(b), cap(c) {}
  inline void encode(uint32_t cwd, int cwd_len) {
    while (cwd_len > 0) {
      int t = max_bits - used_bits;
      if (cwd_len < t) t = cwd_len;
      tmp |= static_cast<uint64_t>(cwd & ((1u << t) - 1)) << used_bits;
      used_bits += t;
      cwd >>= t;
      cwd_len -= t;
      if (used_bits >= max_bits) {
        if (len >= cap) {
          ovf = true;
          return;
        }
        buf[len++] = static_cast<uint8_t>(tmp);
        max_bits = (tmp == 0xFF) ? 7 : 8;
        tmp = 0;
        used_bits = 0;
      }
    }
  }
  inline void encode_w(uint64_t cwd, int cwd_len) {
    // 64-bit-wide variant for the encoder64 regime (>32-bit v_n);
    // t <= 8 per step so the masks/shifts stay in range
    while (cwd_len > 0) {
      int t = max_bits - used_bits;
      if (cwd_len < t) t = cwd_len;
      tmp |= (cwd & ((1ull << t) - 1)) << used_bits;
      used_bits += t;
      cwd >>= t;
      cwd_len -= t;
      if (used_bits >= max_bits) {
        if (len >= cap) {
          ovf = true;
          return;
        }
        buf[len++] = static_cast<uint8_t>(tmp);
        max_bits = (tmp == 0xFF) ? 7 : 8;
        tmp = 0;
        used_bits = 0;
      }
    }
  }
  inline void terminate() {
    if (used_bits) {
      int t = max_bits - used_bits;
      tmp |= (0xFFu & ((1u << t) - 1)) << used_bits;
      used_bits += t;
      if (tmp != 0xFF) {
        if (len >= cap) {
          ovf = true;
          return;
        }
        buf[len++] = static_cast<uint8_t>(tmp);
      }
    } else if (max_bits == 7) {
      --len;
    }
  }
};

}  // namespace

extern "C" {

// Pack device-computed records into cleanup segments.
//
// Per block i and pair step s (raster over quad-pair columns then
// rows; only the first pairs_real[i] steps are read):
//   mel_evts[i, s, 0..2]  : -1 = absent, else 0/1 event bit, in order
//                           (quad0 rho, quad1 rho, u event)
//   vlc_cwds/vlc_lens[i, s, 0..5] : VLC words in emission order
//   ms_vals/ms_lens[i, s, 0..7]   : MagSgn words (quad0 s0..s3, quad1)
// Outputs: out[i * out_stride ...], out_lens[i] (0 if overflow).
void pack_cleanup_segments(
    int64_t n, int64_t steps, int64_t pairs_stride,
    const int8_t* mel_evts, const uint16_t* vlc_cwds,
    const uint8_t* vlc_lens, const uint32_t* ms_vals,
    const uint8_t* ms_lens, const int64_t* pairs_real,
    uint8_t* out, int64_t out_stride, int64_t* out_lens) {
  (void)steps;
  for (int64_t i = 0; i < n; ++i) {
    MelEnc mel;
    VlcEnc vlc;
    uint8_t* obuf = out + i * out_stride;
    MsEnc ms(obuf, out_stride);
    const int64_t np = pairs_real[i];
    const int8_t* me = mel_evts + i * pairs_stride * 3;
    const uint16_t* vc = vlc_cwds + i * pairs_stride * 6;
    const uint8_t* vl = vlc_lens + i * pairs_stride * 6;
    const uint32_t* mv = ms_vals + i * pairs_stride * 8;
    const uint8_t* ml = ms_lens + i * pairs_stride * 8;
    for (int64_t s = 0; s < np; ++s) {
      // stream order within the pair mirrors ojph_block_encoder.cpp:
      // quad0: vlc tuple, mel rho event, magsgn x4; quad1 same;
      // then the u-event + u codes.
      const int8_t* e = me + s * 3;
      const uint16_t* c = vc + s * 6;
      const uint8_t* l = vl + s * 6;
      const uint32_t* v = mv + s * 8;
      const uint8_t* vlen = ml + s * 8;
      vlc.encode(c[0], l[0]);
      if (e[0] >= 0) mel.encode(e[0] != 0);
      for (int j = 0; j < 4; ++j) ms.encode(v[j], vlen[j]);
      vlc.encode(c[1], l[1]);
      if (e[1] >= 0) mel.encode(e[1] != 0);
      for (int j = 4; j < 8; ++j) ms.encode(v[j], vlen[j]);
      if (e[2] >= 0) mel.encode(e[2] != 0);
      vlc.encode(c[2], l[2]);
      vlc.encode(c[3], l[3]);
      vlc.encode(c[4], l[4]);
      vlc.encode(c[5], l[5]);
    }
    // terminate (ojph_block_encoder.cpp:412-441)
    if (mel.run > 0) mel.emit_bit(1);
    const uint32_t mel_tmp = (mel.tmp << mel.remaining_bits) & 0xFF;
    const uint32_t mel_mask = (0xFF << mel.remaining_bits) & 0xFF;
    const uint32_t vlc_mask =
        vlc.used_bits ? (0xFFu >> (8 - vlc.used_bits)) : 0;
    int mel_len = mel.len;
    int vlc_len = vlc.len;
    if ((mel_mask | vlc_mask) != 0 &&
        mel_len + 1 <= static_cast<int>(sizeof(mel.buf)) &&
        vlc_len + 1 <= static_cast<int>(sizeof(vlc.buf))) {
      const uint32_t fuse = mel_tmp | vlc.tmp;
      if (((((fuse ^ mel_tmp) & mel_mask) |
            ((fuse ^ vlc.tmp) & vlc_mask)) == 0) &&
          fuse != 0xFF && vlc.len > 0) {
        mel.buf[mel_len++] = static_cast<uint8_t>(fuse);
      } else {
        mel.buf[mel_len++] = static_cast<uint8_t>(mel_tmp);
        vlc.buf[vlc_len++] = static_cast<uint8_t>(vlc.tmp);
      }
    }
    ms.terminate();
    const int64_t num_bytes = mel_len + vlc_len + 1;  // + 0xFF sentinel
    const int64_t total = ms.len + num_bytes;
    if (mel.ovf || vlc.ovf || ms.ovf ||
        total + 2 > out_stride || num_bytes > 4079) {
      out_lens[i] = 0;  // overflow: caller falls back
      continue;
    }
    uint8_t* pos = obuf + ms.len;
    for (int j = 0; j < mel_len; ++j) *pos++ = mel.buf[j];
    for (int j = vlc_len - 1; j >= 0; --j) *pos++ = vlc.buf[j];
    *pos = 0xFF;  // sentinel, replaced by scup word below
    obuf[total - 1] = static_cast<uint8_t>((num_bytes >> 4) & 0xFF);
    obuf[total - 2] =
        static_cast<uint8_t>((obuf[total - 2] & 0xF0) | (num_bytes & 0xF));
    out_lens[i] = total;
  }
}

}  // extern "C"


namespace {

inline int get_dense_bit(const uint32_t* w, int64_t t) {
  return (w[t >> 5] >> (t & 31)) & 1;
}

}  // namespace

extern "C" {

// Assemble cleanup segments from device-packed dense bit streams
// (block_encode_pallas.py).  dense: shared u32 buffer; per lane i,
// meta[i*6..]: mel_off, mel_bits, vlc_off, vlc_bits, ms_off, ms_bits
// (word offsets into dense; bit counts).  The kernel already ran the
// MEL state machine (including the trailing run flush), so this side
// only performs byte stuffing, the backward VLC byte order, MEL/VLC
// fuse termination and the scup word (ojph_block_encoder.cpp:273-441).
void pack_from_dense(int64_t n, const uint32_t* dense,
                     const int64_t* meta, uint8_t* out,
                     int64_t out_stride, int64_t* out_lens,
                     int64_t nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto work = [&](int64_t t0) {
    for (int64_t i = t0; i < n; i += nthreads) {
      const int64_t* m = meta + i * 6;
      const uint32_t* melw = dense + m[0];
      const int64_t melbits = m[1];
      const uint32_t* vlcw = dense + m[2];
      const int64_t vlcbits = m[3];
      const uint32_t* msw = dense + m[4];
      const int64_t msbits = m[5];
      uint8_t* obuf = out + i * out_stride;

      MelEnc mel;  // only emit_bit/stuffing used; run stays 0
      for (int64_t t = 0; t < melbits; ++t)
        mel.emit_bit(get_dense_bit(melw, t));

      VlcEnc vlc;
      {
        int64_t rem = vlcbits;
        int64_t wi = 0;
        while (rem > 0) {
          int take = rem < 32 ? static_cast<int>(rem) : 32;
          vlc.encode(vlcw[wi++], take);
          rem -= take;
        }
      }
      MsEnc ms(obuf, out_stride);
      {
        int64_t rem = msbits;
        int64_t wi = 0;
        while (rem > 0) {
          int take = rem < 32 ? static_cast<int>(rem) : 32;
          ms.encode(msw[wi++], take);
          rem -= take;
        }
      }

      // terminate (ojph_block_encoder.cpp:412-441); the kernel
      // already flushed any pending MEL run
      const uint32_t mel_tmp = (mel.tmp << mel.remaining_bits) & 0xFF;
      const uint32_t mel_mask = (0xFF << mel.remaining_bits) & 0xFF;
      const uint32_t vlc_mask =
          vlc.used_bits ? (0xFFu >> (8 - vlc.used_bits)) : 0;
      int mel_len = mel.len;
      int vlc_len = vlc.len;
      if ((mel_mask | vlc_mask) != 0 &&
          mel_len + 1 <= static_cast<int>(sizeof(mel.buf)) &&
          vlc_len + 1 <= static_cast<int>(sizeof(vlc.buf))) {
        const uint32_t fuse = mel_tmp | vlc.tmp;
        if (((((fuse ^ mel_tmp) & mel_mask) |
              ((fuse ^ vlc.tmp) & vlc_mask)) == 0) &&
            fuse != 0xFF && vlc.len > 0) {
          mel.buf[mel_len++] = static_cast<uint8_t>(fuse);
        } else {
          mel.buf[mel_len++] = static_cast<uint8_t>(mel_tmp);
          vlc.buf[vlc_len++] = static_cast<uint8_t>(vlc.tmp);
        }
      }
      ms.terminate();
      const int64_t num_bytes = mel_len + vlc_len + 1;
      const int64_t total = ms.len + num_bytes;
      if (mel.ovf || vlc.ovf || ms.ovf ||
          total + 2 > out_stride || num_bytes > 4079) {
        out_lens[i] = 0;
        continue;
      }
      uint8_t* pos = obuf + ms.len;
      for (int j = 0; j < mel_len; ++j) *pos++ = mel.buf[j];
      for (int j = vlc_len - 1; j >= 0; --j) *pos++ = vlc.buf[j];
      *pos = 0xFF;
      obuf[total - 1] = static_cast<uint8_t>((num_bytes >> 4) & 0xFF);
      obuf[total - 2] = static_cast<uint8_t>((obuf[total - 2] & 0xF0)
                                             | (num_bytes & 0xF));
      out_lens[i] = total;
    }
  };
  if (nthreads == 1) {
    work(0);
  } else {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < nthreads; ++t) ts.emplace_back(work, t);
    for (auto& th : ts) th.join();
  }
}


// ---------------------------------------------------------------------------
// Scalar HT block DECODER (Cleanup + SigProp + MagRef), 32- and
// 64-bit sample paths.  This is a line-faithful C++ port of THIS
// REPO'S reference-Python decoder (openjph_tpu/coding/decoder.py,
// itself bit-exact with ojph_decode_codeblock32/64) — the host path
// for >30-bit-plane codeblocks and per-block fallbacks, where the
// Python scalar loop runs ~0.2 MP/s and this runs oracle-class.
// One departure: SigProp and MagRef take the cleanup's significance
// from the decoded samples inside the block, as the fused decoders do,
// not from the quads' rho; the two differ only where a damaged segment
// makes a padding sample significant.
// Tables are passed in from Python (coding/data/vlc_tables.npz).
// ---------------------------------------------------------------------------

namespace {

constexpr int kMelE[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};

struct MelDec {
  const uint8_t* buf;
  int64_t pos, size;
  uint64_t tmp = 0;
  int bits = 0;
  bool unstuff = false;
  int k = 0;
  MelDec(const uint8_t* d, int64_t lcup, int64_t scup)
      : buf(d), pos(lcup - scup), size(scup - 1) {}
  inline void read_byte() {
    uint32_t d;
    if (size > 0) {
      d = buf[pos];
      if (size == 1) d |= 0xF;
      ++pos;
      --size;
    } else {
      d = 0xFF;
    }
    const int d_bits = 8 - (unstuff ? 1 : 0);
    tmp = (tmp << d_bits) | d;
    bits += d_bits;
    unstuff = (d == 0xFF);
  }
  inline int read_bit() {
    if (bits == 0) read_byte();
    --bits;
    return (tmp >> bits) & 1;
  }
  inline int get_run() {
    const int ev = kMelE[k];
    int run;
    if (read_bit()) {
      run = ((1 << ev) - 1) << 1;
      k = k < 12 ? k + 1 : 12;
    } else {
      int v = 0;
      for (int i = 0; i < ev; ++i) v = (v << 1) | read_bit();
      run = (v << 1) + 1;
      k = k > 0 ? k - 1 : 0;
    }
    return run;
  }
};

struct RevRd {
  const uint8_t* buf;
  int64_t pos, size;
  uint64_t tmp;
  int bits;
  bool unstuff;
  RevRd(const uint8_t* d, int64_t lcup, int64_t scup) : buf(d) {
    pos = lcup - 2;
    const uint32_t b = buf[pos];
    --pos;
    tmp = b >> 4;
    bits = 4 - (((tmp & 7) == 7) ? 1 : 0);
    unstuff = (b | 0xF) > 0x8F;
    size = scup - 2;
  }
  // MagRef variant constructed via init_mrp below
  RevRd(const uint8_t* d, int64_t lcup, int64_t len2, int)
      : buf(d), pos(lcup + len2 - 1), size(len2), tmp(0), bits(0),
        unstuff(true) {}
  inline void read_byte() {
    uint32_t d;
    if (size > 0) {
      d = buf[pos];
      --pos;
      --size;
    } else {
      d = 0;
    }
    const int d_bits = 8 - ((unstuff && (d & 0x7F) == 0x7F) ? 1 : 0);
    tmp |= static_cast<uint64_t>(d) << bits;
    bits += d_bits;
    unstuff = d > 0x8F;
  }
  inline uint32_t fetch() {
    while (bits < 32) read_byte();
    return static_cast<uint32_t>(tmp);
  }
  inline void advance(int n) {
    tmp >>= n;
    bits -= n;
  }
};

struct FwdRd {
  const uint8_t* buf;
  int64_t pos, size;
  uint32_t fill;
  unsigned __int128 tmp = 0;
  int bits = 0;
  int unstuff = 0;
  FwdRd(const uint8_t* d, int64_t p, int64_t s, uint32_t f)
      : buf(d), pos(p), size(s), fill(f) {}
  inline void read_byte() {
    uint32_t d;
    if (size > 0) {
      d = buf[pos];
      ++pos;
    } else {
      d = fill;
    }
    --size;
    tmp |= static_cast<unsigned __int128>(d) << bits;
    bits += 8 - unstuff;
    unstuff = (d == 0xFF) ? 1 : 0;
  }
  inline uint64_t fetch(int n) {
    while (bits < n) read_byte();
    if (n >= 64) return static_cast<uint64_t>(tmp);
    return static_cast<uint64_t>(tmp) & ((1ull << n) - 1);
  }
  inline void advance(int n) {
    tmp >>= n;
    bits -= n;
  }
};

inline int bit_length64(uint64_t v) { return 64 - __builtin_clzll(v); }

}  // namespace

// Decode one HT codeblock into out (uint64 sign-magnitude, row-major
// [ (qh*2) x width ], caller slices to height rows).  Returns 0 on
// success or a negative error code:
//   -1 invalid scup            -2 wrong codeblock length
//   -3 >3 passes               -4 64 bits insufficient
//   -5 U_q exceeds mmsbp2
int decode_codeblock(
    const uint8_t* data, int64_t missing_msbs, int64_t num_passes,
    int64_t len1, int64_t len2, int64_t width, int64_t height,
    int64_t stripe_causal,
    const uint16_t* vlc_tbl0, const uint16_t* vlc_tbl1,
    const uint16_t* uvlc_tbl0, const uint16_t* uvlc_tbl1,
    const uint8_t* uvlc_bias0, uint64_t* out) {
  if (num_passes > 1 && len2 == 0) num_passes = 1;
  if (num_passes > 3) return -3;
  const int B = missing_msbs < 30 ? 32 : 64;
  if (missing_msbs >= 62) return -4;
  if (missing_msbs == (B == 32 ? 29 : 61)) num_passes = 1;
  const int p = (B == 32 ? 30 : 62) - static_cast<int>(missing_msbs);
  const int SIGN = B - 1;
  const uint64_t MASK = B == 64 ? ~0ull : 0xFFFFFFFFull;
  if (len1 < 2) return -2;

  const int64_t lcup = len1;
  const int64_t scup =
      (static_cast<int64_t>(data[lcup - 1]) << 4) + (data[lcup - 2] & 0xF);
  if (scup < 2 || scup > lcup || scup > 4079) return -1;

  const int64_t qw = (width + 1) >> 1;
  const int64_t qh = (height + 1) >> 1;
  std::vector<uint32_t> inf(qh * (qw + 3), 0);
  std::vector<uint32_t> u_q_arr(qh * (qw + 1), 0);
  const int64_t mmsbp2 = missing_msbs + 2;
  std::memset(out, 0, sizeof(uint64_t) * (qh * 2) * width);

  // ---- step 1: MEL + VLC + UVLC -> per-quad records ----
  MelDec mel(data, lcup, scup);
  RevRd vlc(data, lcup, scup);
  int run = mel.get_run();
  for (int64_t qy = 0; qy < qh; ++qy) {
    uint32_t c_q = 0;
    const bool initial = qy == 0;
    const uint16_t* vtbl = initial ? vlc_tbl0 : vlc_tbl1;
    const uint32_t* above = qy > 0 ? &inf[(qy - 1) * (qw + 3)] : nullptr;
    uint32_t* row = &inf[qy * (qw + 3)];
    uint32_t* urow = &u_q_arr[qy * (qw + 1)];
    for (int64_t qx2 = 0; qx2 < qw; qx2 += 2) {
      if (!initial) {
        c_q |= (above[qx2] & 0xA0) << 2;
        c_q |= (above[qx2 + 1] & 0x20) << 4;
      }
      uint32_t t0 = vtbl[c_q + (vlc.fetch() & 0x7F)];
      if (c_q == 0) {
        run -= 2;
        t0 = (run == -1) ? t0 : 0;
        if (run < 0) run = mel.get_run();
      }
      row[qx2] = t0;
      if (initial) {
        c_q = ((t0 & 0x10) << 3) | ((t0 & 0xE0) << 2);
      } else {
        c_q = ((t0 & 0x40) << 2) | ((t0 & 0x80) << 1);
        c_q |= above[qx2] & 0x80;
        c_q |= (above[qx2 + 1] & 0xA0) << 2;
        c_q |= (above[qx2 + 2] & 0x20) << 4;
      }
      vlc.advance(t0 & 0x7);

      const bool second_exists = (qx2 + 1) < qw;
      uint32_t t1 = vtbl[c_q + (vlc.fetch() & 0x7F)];
      if (c_q == 0 && second_exists) {
        run -= 2;
        t1 = (run == -1) ? t1 : 0;
        if (run < 0) run = mel.get_run();
      }
      t1 = second_exists ? t1 : 0;
      row[qx2 + 1] = t1;
      if (initial) {
        c_q = ((t1 & 0x10) << 3) | ((t1 & 0xE0) << 2);
      } else {
        c_q = ((t1 & 0x40) << 2) | ((t1 & 0x80) << 1);
        c_q |= above[qx2 + 1] & 0x80;
      }
      vlc.advance(t1 & 0x7);

      uint32_t uvlc_mode = ((t0 & 0x8) << 3) | ((t1 & 0x8) << 4);
      uint32_t uvlc_entry;
      uint32_t u_bias = 0;
      if (initial) {
        if (uvlc_mode == 0xC0) {
          run -= 2;
          uvlc_mode += (run == -1) ? 0x40 : 0;
          if (run < 0) run = mel.get_run();
        }
        const uint32_t u_idx = uvlc_mode + (vlc.fetch() & 0x3F);
        uvlc_entry = uvlc_tbl0[u_idx];
        u_bias = uvlc_bias0[u_idx];
      } else {
        uvlc_entry = uvlc_tbl1[uvlc_mode + (vlc.fetch() & 0x3F)];
      }
      vlc.advance(uvlc_entry & 0x7);
      uvlc_entry >>= 3;
      const uint32_t length = uvlc_entry & 0xF;
      const uint32_t tmpv = vlc.fetch() & ((1u << length) - 1);
      vlc.advance(length);
      uvlc_entry >>= 4;
      const uint32_t len0 = uvlc_entry & 0x7;
      uvlc_entry >>= 3;
      const uint32_t kappa = initial ? 1 : 0;
      uint32_t u0 = kappa + (uvlc_entry & 7) + (tmpv & ~(0xFFu << len0));
      uint32_t u1 = kappa + (uvlc_entry >> 3) + (tmpv >> len0);
      if (B == 64) {
        // u_q extension for >32 (ojph_block_decoder64.cpp:1000-1010)
        if (static_cast<int64_t>(u0 - kappa) - (u_bias & 0x3) > 32) {
          u0 += (vlc.fetch() & 0xF) << 2;
          vlc.advance(4);
        }
        if (static_cast<int64_t>(u1 - kappa) - (u_bias >> 2) > 32) {
          u1 += (vlc.fetch() & 0xF) << 2;
          vlc.advance(4);
        }
      }
      urow[qx2] = u0;
      if (second_exists) urow[qx2 + 1] = u1;
    }
  }

  // ---- step 2: MagSgn -> sample values ----
  FwdRd magsgn(data, 0, lcup - scup, 0xFF);
  std::vector<uint64_t> v_n_scratch(qw + 2, 0), new_v(qw + 2, 0);
  for (int64_t qy = 0; qy < qh; ++qy) {
    const bool initial = qy == 0;
    uint64_t prev_v_n = 0;
    std::fill(new_v.begin(), new_v.end(), 0);
    for (int64_t qx = 0; qx < qw; ++qx) {
      const uint32_t q_inf = inf[qy * (qw + 3) + qx];
      const uint32_t u_q = u_q_arr[qy * (qw + 1) + qx];
      int64_t U_q;
      if (initial) {
        U_q = u_q;
      } else {
        uint32_t gamma = q_inf & 0xF0;
        gamma &= gamma - 0x10;
        const uint64_t emax_v = v_n_scratch[qx] | v_n_scratch[qx + 1];
        const int emax = bit_length64(emax_v | 2) - 1;  // emax - 1
        const int kappa = gamma ? emax : 1;
        U_q = u_q + kappa;
      }
      if (U_q > mmsbp2) return -5;
      const int64_t x0 = qx * 2, y0 = qy * 2;
      const int ncols = (x0 + 1 < width) ? 2 : 1;
      for (int bit = 0; bit < 2 * ncols; ++bit) {
        const int col = bit >> 1, rowb = bit & 1;
        const int64_t x = x0 + col, y = y0 + rowb;
        uint64_t val = 0, v_n = 0;
        if (q_inf & (1u << (4 + bit))) {
          const uint64_t ms_val = magsgn.fetch(B);
          const int m_n =
              static_cast<int>(U_q) - ((q_inf >> (12 + bit)) & 1);
          magsgn.advance(m_n);
          val = (ms_val << SIGN) & MASK;
          v_n = m_n >= 64 ? ms_val : (ms_val & ((1ull << m_n) - 1));
          v_n |= static_cast<uint64_t>((q_inf >> (8 + bit)) & 1) << m_n;
          v_n |= 1;
          val |= (v_n + 2) << (p - 1);
          val &= MASK;
        }
        out[y * width + x] = val;
        if (rowb == 1) {
          if (col == 0) {
            new_v[qx] = prev_v_n | v_n;
            prev_v_n = 0;
          } else {
            prev_v_n = v_n;
          }
        }
      }
    }
    new_v[qw] = prev_v_n;
    std::swap(v_n_scratch, new_v);
  }

  if (num_passes <= 1) return 0;

  // ---- column-significance array ----
  // The cleanup's significance inside the block (width x height), taken
  // from the decoded samples as the fused decoders take it (sig_pack):
  // a padding sample that a damaged or hand-made cleanup segment makes
  // significant (column `width` of the last quad column, row `height` of
  // the last quad row) is neither a SigProp neighbour nor refined by
  // MagRef, so no pass reads a bit for it or writes outside the block.
  const int64_t n_sy = (height + 3) >> 2;
  const int64_t n_gx = (width + 3) >> 2;
  std::vector<uint32_t> sig((n_sy + 1) * (n_gx + 1), 0);
  for (int64_t y = 0; y < height; ++y)
    for (int64_t x = 0; x < width; ++x)
      if (out[y * width + x])
        sig[(y >> 2) * (n_gx + 1) + (x >> 2)] |=
            1u << ((x & 3) * 4 + (y & 3));

  // ---- Significance Propagation Pass ----
  {
    FwdRd sigprop(data, len1, len2, 0);
    std::vector<uint32_t> prev_row_sig(n_gx + 1, 0);
    for (int64_t sy = 0; sy < n_sy; ++sy) {
      const int64_t y = sy * 4;
      uint32_t pattern0 = 0xFFFF;
      if (height - y < 4) {
        pattern0 = 0x7777;
        if (height - y < 3) {
          pattern0 = 0x3333;
          if (height - y < 2) pattern0 = 0x1111;
        }
      }
      uint32_t prev = 0;
      uint32_t pattern = pattern0;
      for (int64_t gx = 0; gx < n_gx; ++gx) {
        const int64_t x = gx * 4;
        const int64_t s = std::max<int64_t>(x + 4 - width, 0);
        pattern >>= s * 4;

        const uint32_t ps = prev_row_sig[gx] | (prev_row_sig[gx + 1] << 16);
        const uint32_t ns = sig[(sy + 1) * (n_gx + 1) + gx] |
                            (sig[(sy + 1) * (n_gx + 1) + gx + 1] << 16);
        uint32_t u = (ps & 0x88888888u) >> 3;
        if (!stripe_causal) u |= (ns & 0x11111111u) << 3;
        const uint32_t cs = sig[sy * (n_gx + 1) + gx] |
                            (sig[sy * (n_gx + 1) + gx + 1] << 16);
        uint32_t mbr = cs;
        mbr |= (cs & 0x77777777u) << 1;
        mbr |= (cs & 0xEEEEEEEEu) >> 1;
        mbr |= u;
        const uint32_t tt0 = mbr;
        mbr |= tt0 << 4;
        mbr |= tt0 >> 4;
        mbr |= prev >> 12;
        mbr &= pattern;
        mbr &= ~cs;

        uint32_t new_sig = mbr;
        if (new_sig) {
          uint64_t cwd = sigprop.fetch(32);
          int cnt = 0;
          uint32_t col_mask = 0xF;
          const uint32_t inv_sig = ~cs & pattern;
          static const uint32_t spread[4] = {0x33, 0x76, 0xEC, 0xC8};
          for (int i = 0; i < 16; i += 4) {
            if ((col_mask & new_sig) == 0) {
              col_mask <<= 4;
              continue;
            }
            uint32_t sample_mask = 0x1111u & col_mask;
            for (int k = 0; k < 4; ++k) {
              if (new_sig & sample_mask) {
                new_sig &= ~sample_mask;
                if (cwd & 1) new_sig |= (spread[k] << i) & inv_sig;
                cwd >>= 1;
                ++cnt;
              }
              sample_mask <<= 1;
            }
            col_mask <<= 4;
          }
          if (new_sig) {
            const uint64_t val = 3ull << (p - 2);
            col_mask = 0xF;
            for (int i = 0; i < 4; ++i) {
              if ((col_mask & new_sig) == 0) {
                col_mask <<= 4;
                continue;
              }
              uint32_t sample_mask = 0x1111u & col_mask;
              for (int k = 0; k < 4; ++k) {
                if (new_sig & sample_mask) {
                  out[(y + k) * width + (x + i)] =
                      ((cwd & 1) << SIGN) | val;
                  cwd >>= 1;
                  ++cnt;
                }
                sample_mask += sample_mask;
              }
              col_mask <<= 4;
            }
          }
          sigprop.advance(cnt);
        }
        new_sig |= cs;
        prev_row_sig[gx] = new_sig & 0xFFFF;
        const uint32_t tt = new_sig & 0xFFFF;
        const uint32_t new_sig16 =
            tt | ((tt & 0x7777) << 1) | ((tt & 0xEEEE) >> 1);
        prev = (new_sig16 | u) & 0xF000;
      }
    }
  }

  // ---- Magnitude Refinement Pass ----
  if (num_passes > 2) {
    RevRd magref(data, len1, len2, 0 /* mrp init */);
    const uint64_t half = 1ull << (p - 2);
    for (int64_t sy = 0; sy < n_sy; ++sy) {
      const int64_t y = sy * 4;
      for (int64_t gx2 = 0; gx2 < n_gx; gx2 += 2) {
        const int64_t x = gx2 * 4;
        uint64_t cwd = magref.fetch();
        const uint32_t hi =
            (gx2 + 1 < n_gx) ? sig[sy * (n_gx + 1) + gx2 + 1] : 0;
        const uint32_t sig32 = sig[sy * (n_gx + 1) + gx2] | (hi << 16);
        if (sig32) {
          uint32_t col_mask = 0xF;
          for (int j = 0; j < 8; ++j) {
            if (sig32 & col_mask) {
              uint32_t sample_mask = 0x11111111u & col_mask;
              for (int k = 0; k < 4; ++k) {
                if (sig32 & sample_mask) {
                  const uint64_t sym = cwd & 1;
                  const uint64_t v =
                      ((1 - sym) << (p - 1)) | half;
                  out[(y + k) * width + (x + j)] ^= v;
                  cwd >>= 1;
                }
                sample_mask += sample_mask;
              }
            }
            col_mask <<= 4;
          }
        }
        magref.advance(__builtin_popcount(sig32));
      }
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Scalar HT cleanup-pass block ENCODER, 32- and 64-bit sample regimes.
// Line-faithful C++ port of THIS REPO'S reference-Python encoder
// (openjph_tpu/coding/encoder.py::encode_codeblock, itself byte-exact
// with ojph_encode_codeblock32/64, OpenJPH src/core/coding/
// ojph_block_encoder.cpp:542-1017 and :1026-1389 for the >30
// bit-plane encoder64 regime).  This is the host path for wide-band
// (Kmax >= 31) codeblocks, where the fused TPU kernels hand off and
// the Python scalar loop runs ~0.16 MP/s; this runs oracle-class.
// Tables are passed in from Python (coding/data/vlc_tables.npz).
// ---------------------------------------------------------------------------

namespace {

struct QuadSample {
  int sig;
  int e;
  uint64_t s;
};

// (significance, exponent e_q, magsgn value v_n) of one sample
// (encoder.py::_quad_sample).
inline QuadSample quad_sample(const uint64_t* buf, int64_t stride,
                              int64_t y, int64_t x, int64_t width,
                              int64_t height, int p, int bits) {
  QuadSample q{0, 0, 0};
  if (x >= width || y >= height) return q;
  const uint64_t t = buf[y * stride + x];
  const uint64_t mask = (bits >= 64) ? ~0ull : ((1ull << bits) - 1);
  uint64_t val = (t + t) & mask;
  val >>= p;
  val &= ~1ull;
  if (!val) return q;
  val -= 1;
  q.e = 64 - __builtin_clzll(val);  // B - clz(2*mu_p - 1)
  val -= 1;
  q.s = val + (t >> (bits - 1));  // v_n = 2*(mu_p - 1) + sign
  q.sig = 1;
  return q;
}

// Encode one codeblock's cleanup segment; buf is a [height, stride]
// uint64 sign-magnitude array (sign at bit bits-1, magnitudes aligned
// so plane p = (30|62) - missing_msbs is the coded LSB).  Writes
// MagSgn | MEL | VLC(reversed) | scup word into out; returns the
// segment length, or -1 when any stream overflowed its buffer.
int64_t encode_cb_impl(const uint64_t* buf, int64_t stride,
                       int64_t missing_msbs, int64_t width,
                       int64_t height, int64_t bits,
                       const uint16_t* enc_vlc0,
                       const uint16_t* enc_vlc1,
                       const uint8_t* enc_uvlc,  // [75][6]
                       uint8_t* out, int64_t out_cap) {
  MelEnc mel;
  VlcEnc vlc;
  MsEnc ms(out, out_cap);
  const int p = static_cast<int>(
      (bits == 32 ? 30 : 62) - missing_msbs);
  const int b = static_cast<int>(bits);
  const bool ext = (bits == 64);  // u_q extension (encoder64)
  const int64_t qw = (width + 1) >> 1;

  // e_val / cx_val line buffers (ojph_block_encoder.cpp:577-580)
  std::vector<int32_t> e_val(qw + 2, 0), cx_val(qw + 2, 0);

  const uint8_t* uv = enc_uvlc;  // rows of (pre,prelen,suf,suflen,ext,extlen)
  auto uvlc_enc = [&](VlcEnc& v, int u, int c0, int c1) {
    v.encode(uv[u * 6 + c0], uv[u * 6 + c1]);
  };

  // --- initial row of quads ------------------------------------------------
  int c_q0 = 0;
  int64_t lep = 0;
  for (int64_t x = 0; x < width; x += 4) {
    QuadSample q0[4] = {
        quad_sample(buf, stride, 0, x, width, height, p, b),
        quad_sample(buf, stride, 1, x, width, height, p, b),
        quad_sample(buf, stride, 0, x + 1, width, height, p, b),
        quad_sample(buf, stride, 1, x + 1, width, height, p, b)};
    const int rho0 =
        q0[0].sig | (q0[1].sig << 1) | (q0[2].sig << 2) | (q0[3].sig << 3);
    int e_qmax0 = 0;
    for (int n = 0; n < 4; ++n) e_qmax0 = std::max(e_qmax0, q0[n].e);
    const int Uq0 = std::max(e_qmax0, 1);
    const int u_q0 = Uq0 - 1;
    int u_q1 = 0;
    int eps0 = 0;
    if (u_q0 > 0) {
      for (int n = 0; n < 4; ++n)
        eps0 |= ((q0[n].e == e_qmax0 && q0[n].e > 0) ? 1 : 0) << n;
    }
    e_val[lep] = std::max(e_val[lep], static_cast<int32_t>(q0[1].e));
    ++lep;
    e_val[lep] = q0[3].e;
    cx_val[lep - 1] |= (rho0 & 2) >> 1;
    cx_val[lep] = (rho0 & 8) >> 3;
    const uint32_t tuple0 = enc_vlc0[(c_q0 << 8) + (rho0 << 4) + eps0];
    vlc.encode(tuple0 >> 8, (tuple0 >> 4) & 7);
    if (c_q0 == 0) mel.encode(rho0 != 0);
    for (int n = 0; n < 4; ++n) {
      const int m =
          ((rho0 >> n) & 1) ? Uq0 - ((tuple0 >> n) & 1) : 0;
      ms.encode_w(q0[n].s & ((1ull << m) - 1), m);
    }

    if (x + 2 < width) {
      QuadSample q1[4] = {
          quad_sample(buf, stride, 0, x + 2, width, height, p, b),
          quad_sample(buf, stride, 1, x + 2, width, height, p, b),
          quad_sample(buf, stride, 0, x + 3, width, height, p, b),
          quad_sample(buf, stride, 1, x + 3, width, height, p, b)};
      const int rho1 =
          q1[0].sig | (q1[1].sig << 1) | (q1[2].sig << 2) | (q1[3].sig << 3);
      int e_qmax1 = 0;
      for (int n = 0; n < 4; ++n) e_qmax1 = std::max(e_qmax1, q1[n].e);
      const int c_q1 = (rho0 >> 1) | (rho0 & 1);
      const int Uq1 = std::max(e_qmax1, 1);
      u_q1 = Uq1 - 1;
      int eps1 = 0;
      if (u_q1 > 0) {
        for (int n = 0; n < 4; ++n)
          eps1 |= ((q1[n].e == e_qmax1 && q1[n].e > 0) ? 1 : 0) << n;
      }
      e_val[lep] = std::max(e_val[lep], static_cast<int32_t>(q1[1].e));
      ++lep;
      e_val[lep] = q1[3].e;
      cx_val[lep - 1] |= (rho1 & 2) >> 1;
      cx_val[lep] = (rho1 & 8) >> 3;
      const uint32_t tuple1 = enc_vlc0[(c_q1 << 8) + (rho1 << 4) + eps1];
      vlc.encode(tuple1 >> 8, (tuple1 >> 4) & 7);
      if (c_q1 == 0) mel.encode(rho1 != 0);
      for (int n = 0; n < 4; ++n) {
        const int m =
            ((rho1 >> n) & 1) ? Uq1 - ((tuple1 >> n) & 1) : 0;
        ms.encode_w(q1[n].s & ((1ull << m) - 1), m);
      }
      c_q0 = (rho1 >> 1) | (rho1 & 1);
    } else {
      c_q0 = 0;
    }

    // u_q encoding for the pair (ojph_block_encoder.cpp:763-785)
    if (u_q0 > 0 && u_q1 > 0) mel.encode(std::min(u_q0, u_q1) > 2);
    if (u_q0 > 2 && u_q1 > 2) {
      uvlc_enc(vlc, u_q0 - 2, 0, 1);
      uvlc_enc(vlc, u_q1 - 2, 0, 1);
      uvlc_enc(vlc, u_q0 - 2, 2, 3);
      uvlc_enc(vlc, u_q1 - 2, 2, 3);
      if (ext) {  // encoder64, ojph_block_encoder.cpp:1269-1270
        uvlc_enc(vlc, u_q0 - 2, 4, 5);
        uvlc_enc(vlc, u_q1 - 2, 4, 5);
      }
    } else if (u_q0 > 2 && u_q1 > 0) {
      uvlc_enc(vlc, u_q0, 0, 1);
      vlc.encode(u_q1 - 1, 1);
      uvlc_enc(vlc, u_q0, 2, 3);
      if (ext) uvlc_enc(vlc, u_q0, 4, 5);  // :1277
    } else {
      uvlc_enc(vlc, u_q0, 0, 1);
      uvlc_enc(vlc, u_q1, 0, 1);
      uvlc_enc(vlc, u_q0, 2, 3);
      uvlc_enc(vlc, u_q1, 2, 3);
      if (ext) {  // :1285-1286
        uvlc_enc(vlc, u_q0, 4, 5);
        uvlc_enc(vlc, u_q1, 4, 5);
      }
    }
  }
  e_val[lep + 1] = 0;

  // --- non-initial rows ----------------------------------------------------
  for (int64_t y = 2; y < height; y += 2) {
    lep = 0;
    int max_e = std::max(e_val[0], e_val[1]) - 1;
    e_val[0] = 0;
    int64_t lcxp = 0;
    c_q0 = cx_val[0] + (cx_val[1] << 2);
    cx_val[0] = 0;
    for (int64_t x = 0; x < width; x += 4) {
      QuadSample q0[4] = {
          quad_sample(buf, stride, y, x, width, height, p, b),
          quad_sample(buf, stride, y + 1, x, width, height, p, b),
          quad_sample(buf, stride, y, x + 1, width, height, p, b),
          quad_sample(buf, stride, y + 1, x + 1, width, height, p, b)};
      const int rho0 =
          q0[0].sig | (q0[1].sig << 1) | (q0[2].sig << 2) | (q0[3].sig << 3);
      int e_qmax0 = 0;
      for (int n = 0; n < 4; ++n) e_qmax0 = std::max(e_qmax0, q0[n].e);
      int kappa = (rho0 & (rho0 - 1)) ? std::max(1, max_e) : 1;
      const int Uq0 = std::max(e_qmax0, kappa);
      const int u_q0 = Uq0 - kappa;
      int u_q1 = 0;
      int eps0 = 0;
      if (u_q0 > 0) {
        for (int n = 0; n < 4; ++n)
          eps0 |= ((q0[n].e == e_qmax0 && q0[n].e > 0) ? 1 : 0) << n;
      }
      e_val[lep] = std::max(e_val[lep], static_cast<int32_t>(q0[1].e));
      ++lep;
      max_e = std::max(e_val[lep], e_val[lep + 1]) - 1;
      e_val[lep] = q0[3].e;
      cx_val[lcxp] |= (rho0 & 2) >> 1;
      ++lcxp;
      int c_q1 = cx_val[lcxp] + (cx_val[lcxp + 1] << 2);
      cx_val[lcxp] = (rho0 & 8) >> 3;
      const uint32_t tuple0 = enc_vlc1[(c_q0 << 8) + (rho0 << 4) + eps0];
      vlc.encode(tuple0 >> 8, (tuple0 >> 4) & 7);
      if (c_q0 == 0) mel.encode(rho0 != 0);
      for (int n = 0; n < 4; ++n) {
        const int m =
            ((rho0 >> n) & 1) ? Uq0 - ((tuple0 >> n) & 1) : 0;
        ms.encode_w(q0[n].s & ((1ull << m) - 1), m);
      }

      if (x + 2 < width) {
        QuadSample q1[4] = {
            quad_sample(buf, stride, y, x + 2, width, height, p, b),
            quad_sample(buf, stride, y + 1, x + 2, width, height, p, b),
            quad_sample(buf, stride, y, x + 3, width, height, p, b),
            quad_sample(buf, stride, y + 1, x + 3, width, height, p, b)};
        const int rho1 =
            q1[0].sig | (q1[1].sig << 1) | (q1[2].sig << 2) |
            (q1[3].sig << 3);
        int e_qmax1 = 0;
        for (int n = 0; n < 4; ++n) e_qmax1 = std::max(e_qmax1, q1[n].e);
        kappa = (rho1 & (rho1 - 1)) ? std::max(1, max_e) : 1;
        c_q1 |= ((rho0 & 4) >> 1) | ((rho0 & 8) >> 2);
        const int Uq1 = std::max(e_qmax1, kappa);
        u_q1 = Uq1 - kappa;
        int eps1 = 0;
        if (u_q1 > 0) {
          for (int n = 0; n < 4; ++n)
            eps1 |= ((q1[n].e == e_qmax1 && q1[n].e > 0) ? 1 : 0) << n;
        }
        e_val[lep] = std::max(e_val[lep], static_cast<int32_t>(q1[1].e));
        ++lep;
        max_e = std::max(e_val[lep], e_val[lep + 1]) - 1;
        e_val[lep] = q1[3].e;
        cx_val[lcxp] |= (rho1 & 2) >> 1;
        ++lcxp;
        c_q0 = cx_val[lcxp] + (cx_val[lcxp + 1] << 2);
        cx_val[lcxp] = (rho1 & 8) >> 3;
        const uint32_t tuple1 = enc_vlc1[(c_q1 << 8) + (rho1 << 4) + eps1];
        vlc.encode(tuple1 >> 8, (tuple1 >> 4) & 7);
        if (c_q1 == 0) mel.encode(rho1 != 0);
        for (int n = 0; n < 4; ++n) {
          const int m =
              ((rho1 >> n) & 1) ? Uq1 - ((tuple1 >> n) & 1) : 0;
          ms.encode_w(q1[n].s & ((1ull << m) - 1), m);
        }
        c_q0 |= ((rho1 & 4) >> 1) | ((rho1 & 8) >> 2);
      } else {
        c_q0 = c_q1;  // matches reference: c_q0 set before 2nd quad
      }

      uvlc_enc(vlc, u_q0, 0, 1);
      uvlc_enc(vlc, u_q1, 0, 1);
      uvlc_enc(vlc, u_q0, 2, 3);
      uvlc_enc(vlc, u_q1, 2, 3);
      if (ext) {  // encoder64, ojph_block_encoder.cpp:1491-1492
        uvlc_enc(vlc, u_q0, 4, 5);
        uvlc_enc(vlc, u_q1, 4, 5);
      }
    }
  }

  // terminate (ojph_block_encoder.cpp:412-441)
  if (mel.run > 0) mel.emit_bit(1);
  const uint32_t mel_tmp = (mel.tmp << mel.remaining_bits) & 0xFF;
  const uint32_t mel_mask = (0xFF << mel.remaining_bits) & 0xFF;
  const uint32_t vlc_mask =
      vlc.used_bits ? (0xFFu >> (8 - vlc.used_bits)) : 0;
  int mel_len = mel.len;
  int vlc_len = vlc.len;
  if ((mel_mask | vlc_mask) != 0 &&
      mel_len + 1 <= static_cast<int>(sizeof(mel.buf)) &&
      vlc_len + 1 <= static_cast<int>(sizeof(vlc.buf))) {
    const uint32_t fuse = mel_tmp | vlc.tmp;
    if (((((fuse ^ mel_tmp) & mel_mask) |
          ((fuse ^ vlc.tmp) & vlc_mask)) == 0) &&
        fuse != 0xFF && vlc.len > 0) {
      mel.buf[mel_len++] = static_cast<uint8_t>(fuse);
    } else {
      mel.buf[mel_len++] = static_cast<uint8_t>(mel_tmp);
      vlc.buf[vlc_len++] = static_cast<uint8_t>(vlc.tmp);
    }
  }
  ms.terminate();
  const int64_t num_bytes = mel_len + vlc_len + 1;  // + 0xFF sentinel
  const int64_t total = ms.len + num_bytes;
  if (mel.ovf || vlc.ovf || ms.ovf || total + 2 > out_cap ||
      num_bytes > 4079 || total < 2)
    return -1;
  uint8_t* pos = out + ms.len;
  for (int j = 0; j < mel_len; ++j) *pos++ = mel.buf[j];
  for (int j = vlc_len - 1; j >= 0; --j) *pos++ = vlc.buf[j];
  *pos = 0xFF;  // sentinel, replaced by the scup word
  out[total - 1] = static_cast<uint8_t>((num_bytes >> 4) & 0xFF);
  out[total - 2] =
      static_cast<uint8_t>((out[total - 2] & 0xF0) | (num_bytes & 0xF));
  return total;
}

}  // namespace

extern "C" {

int64_t encode_codeblock(const uint64_t* buf, int64_t stride,
                         int64_t missing_msbs, int64_t width,
                         int64_t height, int64_t bits,
                         const uint16_t* enc_vlc0,
                         const uint16_t* enc_vlc1,
                         const uint8_t* enc_uvlc,
                         uint8_t* out, int64_t out_cap) {
  return encode_cb_impl(buf, stride, missing_msbs, width, height, bits,
                        enc_vlc0, enc_vlc1, enc_uvlc, out, out_cap);
}

// Thread-parallel batch over one subband's codeblocks (shared
// missing_msbs/bits).  blob holds each block contiguous at
// offsets[i], dims as ws/hs; outputs land at out + i*out_stride with
// out_lens[i] = segment length (-1 on overflow: caller falls back on
// that block).
void encode_codeblock_batch(const uint64_t* blob, const int64_t* offsets,
                            const int64_t* ws, const int64_t* hs,
                            int64_t n, int64_t missing_msbs,
                            int64_t bits, const uint16_t* enc_vlc0,
                            const uint16_t* enc_vlc1,
                            const uint8_t* enc_uvlc, uint8_t* out,
                            int64_t out_stride, int64_t* out_lens,
                            int64_t nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = n;
  auto work = [&](int64_t t0) {
    for (int64_t i = t0; i < n; i += nthreads) {
      out_lens[i] = encode_cb_impl(
          blob + offsets[i], ws[i], missing_msbs, ws[i], hs[i], bits,
          enc_vlc0, enc_vlc1, enc_uvlc, out + i * out_stride,
          out_stride);
    }
  };
  if (nthreads == 1) {
    work(0);
  } else {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < nthreads; ++t) ts.emplace_back(work, t);
    for (auto& th : ts) th.join();
  }
}

}  // extern "C"
