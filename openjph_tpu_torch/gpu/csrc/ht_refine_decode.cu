// HT refinement passes (SigProp and MagRef) of a multi-pass codeblock, for
// Hopper (sm_90a).
//
// Replaces the JAX package's refinement stage, which is an XLA scan and
// not a Pallas kernel: openjph_tpu/tpu/block_refine.py::refine_core
// (sig_pack, _sigprop, _magref), fed in raw mode by the XLA readers
// tpu/unstuff.py::unstuff_spp / unstuff_mrp.  Semantics are refine_core's
// (ojph_block_decoder32.cpp:1318-1611): the kernel reads the cleanup output
// `dec` [n, height, width] (uint32 sign-magnitude, written by the cleanup
// kernel) and refines it in place, per lane gated by
//   npasses  SigProp from 2, MagRef at 3 (below 2 the lane is untouched);
//   h_lim    the lane's true height: rows at or past it neither consume
//            bits nor change samples (height-merged lane groups);
//   causal   the stripe-causal COD flag (0x8): no look at the next stripe;
//   p        30 - missing_msbs; every shift by p - 2 or p - 1 gives 0 when
//            out of [0, 31], as uint32 shifts do in the JAX package.
// Two reader modes, as the cleanup kernel has:
//   dense (ht_refine_decode_dense): the SigProp and MagRef streams arrive
//     as host-unstuffed LSB-first uint32 word rows; a read at or past a
//     row's last word gives that word;
//   raw (ht_refine_decode_raw): each lane's refinement segment (len2 bytes
//     at roff in the packed segment blob) is unstuffed by the kernel,
//     SigProp forward (frwd_struct32 with zero fill), MagRef backward
//     (rev_init_mrp, ojph_block_decoder32.cpp:517-575), by the rules that
//     gpu/unstuff.py states.  A range outside the blob reads as empty.
// Before the first launch on a device, ht_refine_set_tables hands the
// kernel SigProp's column table (block_refine_cuda.spp_column_table); a
// launch on a device without it is refused.
//
// What bounds it.  Not bytes: on the 2048x1080 gray 3-pass frame the
// `dec` round trip is 25 MB, some 7.6 us of HBM time.  SigProp is serial
// over a codeblock: each 4x4 group's bit offset is what the groups before
// it consumed, and inside a group each decision makes the samples after
// it candidates.  The kernel's time is that chain on the longest lane,
// 256 groups for a 64x64 block.  The design keeps on it only what depends
// on the step before, and makes a column's step one table read and two
// operations.
//
// Design: one warp per codeblock; `dec` stays in device memory.
//   Phase A (all 32 lanes, a group a lane): the cleanup significance of
//     each 4x4 group (bit 4*col + row) from 16-byte reads of its rows.
//   Phase B (all 32 lanes): the two streams into shared memory.  Raw mode
//     unstuffs 128 bytes a batch, four a lane (a byte's payload depends on
//     it and the two bytes before it), places the payloads with a warp scan
//     of their bit counts and ORs them into the words, only as far as the
//     passes can read; a batch's bytes are read while the one before is
//     unstuffed.  Dense mode copies the word rows.
//   Phase D1 (all 32 lanes, a group a lane): the part of each group's
//     SigProp context that the cleanup pass fixes (its own, the next
//     stripe's and the stripe above's cleanup significance, and the left
//     group's), as one word: candidates | not-yet-significant << 16.
//   Phase D2 (one lane, SigProp's chain): the groups in order.  A group's
//     candidates are its D1 word ORed with the stripe above's new
//     significance; a group with none, and no carry from the left, reads
//     nothing.  Then four column steps, each one read of a 4,096-entry
//     table (block_refine_cuda.spp_column_table) at the byte offset built
//     from the column's candidates, its not-yet-significant rows and the
//     next four stream bits; the entry gives the bits read, the column's
//     new significance, its count and its spread, which joins the next
//     column's candidates (the next group's column 0 after column 3).  The
//     stream is read as a funnel shift of two words in registers, the
//     word after them read a group ahead.  Each group stores its new
//     significance and its sign bits' offset; the chain reads no sign bit
//     and stores no sample.  The chain runs on its warp's lane 0, or, when
//     a launch has more codeblocks than some 16 an SM, on lane k of the
//     block's first warp for the block's codeblock k: the chains' issue
//     slots, not their latency, then set the time, and one instruction
//     stream serves several of them.
//   Phase E (all 32 lanes, a step of two groups of a stripe a lane):
//     MagRef's bits at the offset a warp scan of the steps' significance
//     popcounts gives, each group's sign bits at its stored offset; each
//     changed 16-byte piece of the step's rows is read, refined and
//     written back.
// 64-bit instantiation (entries ..._dense64 / ..._raw64): `dec` uint64, p
// = 62 - missing_msbs, the sign in bit 63 (ojph_decode_codeblock64's
// refinement, which the JAX package runs on its host for more than 30 bit
// planes; no TPU kernel is behind it).  Only phases A and E touch samples,
// so only they change: 8-byte samples, 64-bit shifts.  Shared memory holds
// no samples, so a codeblock's words (ht_refine_warp_bytes) are the same
// at both widths.
// SigProp touches only samples that are not cleanup-significant and MagRef
// only those that are.  K codeblocks (warps) share a CUDA block, ~5 KB of
// shared memory each for a 64x64 block (with a slot through which the
// block's first warp finds a codeblock's chain).  Each CUDA block loads
// the table from a global copy into shared memory.  The kernel launches
// on the caller's stream and allocates nothing.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace ojr {

constexpr unsigned kFull = 0xFFFFFFFFu;
// room past a raw stream's read cap for the last batch of 128 bytes
constexpr int kBatchWords = 33;
// SigProp's column table: index window | candidates << 4 | not yet
// significant << 8 (a nibble each, row k at bit k), read at byte offset
// 2 * index; entry: candidate bits
// read | the new significance spread to rows k-1..k+1 << 5 | the new
// significance << 9 | its popcount << 13
constexpr int kTableEntries = 4096;
constexpr int kTableBytes = 2 * kTableEntries;
constexpr int kMaxDevices = 64;
// codeblocks an SM past which a block's SigProp chains share one warp
constexpr int kChainsPerSm = 16;

enum { kSpp = 0, kMrp = 1 };

// the table's global copy, which each CUDA block loads into shared memory
__device__ __align__(16) uint16_t g_col_table[kTableEntries];
// devices whose copy of the table is set
bool g_tables_ready[kMaxDevices];

__device__ __forceinline__ uint32_t shl32(uint32_t v, uint32_t n) {
  return n >= 32u ? 0u : v << n;
}

__device__ __forceinline__ unsigned long long shl64(unsigned long long v,
                                                    uint32_t n) {
  return n >= 64u ? 0ull : v << n;
}

// the samples above and below each sample of a column, as bits 4*col + row
__device__ __forceinline__ uint32_t vspread(uint32_t x) {
  return ((x & 0x77777777u) << 1) | ((x & 0xEEEEEEEEu) >> 1);
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// ---- geometry and shared memory ----

struct Geo {
  int n_sy, n_gx, n_g2;
  int gs;             // stride of a row of groups: n_gx + 1, zero padded
  int sig_words;      // (n_sy + 1) x gs significance, zero padded
  int grp_words;      // n_sy x gs: one word a group (context, result)
  int cap_spp, cap_mrp;  // words a pass can read (see below)
};

// SigProp reads at most two bits a sample (candidate and sign) and peeks
// 96 bits past its offset, MagRef one bit a sample: the caps hold that
// with words to spare.
__host__ __device__ inline Geo geometry(int width, int height) {
  Geo g;
  g.n_sy = (height + 3) >> 2;
  g.n_gx = (width + 3) >> 2;
  g.n_g2 = (g.n_gx + 1) >> 1;
  g.gs = g.n_gx + 1;
  g.sig_words = (g.n_sy + 1) * g.gs;
  g.grp_words = g.n_sy * g.gs;
  const int area = 16 * g.n_sy * g.n_gx;
  g.cap_spp = (2 * area + 31) / 32 + 4;
  g.cap_mrp = (area + 31) / 32 + 4;
  return g;
}

// shared words per codeblock: its chain's slot (Chain, below),
// significance, the context and result words, the two streams; a multiple
// of 4
constexpr int kChainWords = 12;
__host__ __device__ inline int warp_words(int width, int height) {
  const Geo g = geometry(width, height);
  const int w = kChainWords + g.sig_words + 2 * g.grp_words +
                (g.cap_spp + kBatchWords) + (g.cap_mrp + kBatchWords);
  return (w + 3) & ~3;
}

// ---- the streams ----

// A stream as LSB-first words: [0, lim) in shared memory, [lim, last) in
// global memory (dense rows wider than the cap), `fill` at and past last.
struct Src {
  const uint32_t* sh;
  const uint32_t* gl;
  int lim, last;
  uint32_t fill;
  __device__ __forceinline__ uint32_t word(uint32_t i) const {
    return i < static_cast<uint32_t>(lim)
               ? sh[i]
               : (i < static_cast<uint32_t>(last) ? __ldg(gl + i) : fill);
  }
  // the 32 bits at bit offset `off`
  __device__ __forceinline__ uint32_t bits32(uint32_t off) const {
    const uint32_t k = off >> 5, s = off & 31u;
    const uint32_t w0 = word(k);
    return s ? (w0 >> s) | (word(k + 1) << (32u - s)) : w0;
  }
};

// What a codeblock's SigProp chain needs from its warp's phases A-D1, in
// the warp's shared memory: the chain runs on a lane of the block's first
// warp.
struct Chain {
  Src spp;
  int nst;  // stripes with a row below h_lim
};
static_assert(sizeof(Chain) <= 4 * kChainWords, "chain slot");

// Payload (v, c bits) of byte j of a segment of n bytes in read order,
// from the byte b and the raw bytes before it in read order (p1 = byte
// j-1, p2 = byte j-2).  Past the end: 8 zero bits.
template <int KIND>
__device__ __forceinline__ void payload(uint32_t b, uint32_t p1, uint32_t p2,
                                        int j, int n, uint32_t& v, int& c) {
  c = 8;
  if (j >= n) {
    v = 0u;
  } else if (KIND == kSpp) {
    // a byte after 0xFF loses bit 7, which ORs into the next byte's bit 0
    const bool stuffed = j > 0 && p1 == 0xFFu;
    const bool carry = j > 1 && p2 == 0xFFu;
    v = b | (carry ? (p1 >> 7) & 1u : 0u);
    if (stuffed) {
      v &= 0x7Fu;
      c = 7;
    }
  } else {
    // a byte loses bit 7 when the byte read before it was above 0x8F (the
    // first byte counts as following one) and its low 7 bits are ones; the
    // bit ORs into the next byte's bit 0, and on the last byte it stays
    const bool carry =
        j > 0 && (j == 1 || p2 > 0x8Fu) && (p1 & 0x7Fu) == 0x7Fu;
    v = b | (carry ? (p1 >> 7) & 1u : 0u);
    const bool drop = (j == 0 || p1 > 0x8Fu) && (b & 0x7Fu) == 0x7Fu;
    if (drop && j != n - 1) {
      v &= 0x7Fu;
      c = 7;
    }
  }
}

// Bytes j .. j+3 of a segment of n bytes in read order (MagRef reads
// backward from src); past the end, zeros.
template <int KIND>
__device__ __forceinline__ void load4(const uint8_t* src, int j, int n,
                                      uint32_t* b) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    b[k] = j + k < n ? __ldg(KIND == kMrp ? src - (j + k) : src + (j + k))
                     : 0u;
}

// Unstuffs bytes j0 .. j0+127 of a segment, four a lane (b: this lane's
// bytes j0 + 4 * lane ..), and ORs their payloads into buf at bit pos0 and
// on; the words there must be zero.  `carry` holds the raw bytes j0-2 |
// j0-1 << 8 in and j0+126 | j0+127 << 8 out.  Returns the bits appended
// (1,024 at most; the same on every lane).
template <int KIND>
__device__ __forceinline__ uint32_t unstuff128(const uint32_t* b, int j0,
                                               int n, uint32_t& carry,
                                               uint32_t* buf, uint32_t pos0,
                                               int lane) {
  const int j = j0 + 4 * lane;
  const uint32_t tail = b[2] | (b[3] << 8);
  uint32_t before = __shfl_up_sync(kFull, tail, 1);
  if (lane == 0) before = carry;
  uint32_t p2 = before & 0xFFu, p1 = before >> 8;
  uint32_t bits = 0;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t v;
    int c;
    payload<KIND>(b[k], p1, p2, j + k, n, v, c);
    bits |= v << cnt;
    cnt += c;
    p2 = p1;
    p1 = b[k];
  }
  const int incl = warp_incl_scan(cnt, lane);
  const uint32_t at = pos0 + static_cast<uint32_t>(incl - cnt);
  const uint32_t s = at & 31u, w = at >> 5;
  if (bits != 0u) {
    atomicOr(buf + w, bits << s);
    if (s + cnt > 32u) atomicOr(buf + w + 1u, bits >> (32u - s));
  }
  carry = __shfl_sync(kFull, tail, 31);
  return static_cast<uint32_t>(__shfl_sync(kFull, incl, 31));
}

// Raw mode, phase B: a segment of n bytes unstuffed into buf (cap +
// kBatchWords words, zeroed here) until it ends or cap words are written;
// each batch's bytes are read while the batch before is unstuffed.
template <int KIND>
__device__ __forceinline__ Src raw_src(const uint8_t* src, int n,
                                       uint32_t* buf, int cap, int lane) {
  const int words = cap + kBatchWords;
  for (int i = lane; i < words; i += 32) buf[i] = 0u;
  __syncwarp();
  uint32_t carry = 0, produced = 0;
  const uint32_t cap_bits = static_cast<uint32_t>(cap) * 32u;
  uint32_t cur[4], nxt[4];
  load4<KIND>(src, 4 * lane, n, cur);
  for (int j0 = 0; j0 < n && produced < cap_bits; j0 += 128) {
    load4<KIND>(src, j0 + 128 + 4 * lane, n, nxt);
    produced += unstuff128<KIND>(cur, j0, n, carry, buf, produced, lane);
#pragma unroll
    for (int k = 0; k < 4; ++k) cur[k] = nxt[k];
  }
  return Src{buf, nullptr, words, words, 0u};
}

// Dense mode, phase B: the row's words below min(last, cap) into buf, four
// reads a lane in flight.
__device__ __forceinline__ Src dense_src(const uint32_t* row, int nwords,
                                         uint32_t* buf, int cap, int lane) {
  const int last = nwords - 1;
  const int lim = last < cap ? last : cap;
  for (int i0 = lane; i0 < lim; i0 += 128) {
    uint32_t t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      t[k] = i0 + 32 * k < lim ? __ldg(row + i0 + 32 * k) : 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + 32 * k < lim) buf[i0 + 32 * k] = t[k];
  }
  return Src{buf, row, lim, last, __ldg(row + last)};
}

// ---- SigProp ----

// the entry at byte offset `at` (even)
__device__ __forceinline__ uint32_t col_table(const uint16_t* tab,
                                              uint32_t at) {
  return *reinterpret_cast<const uint16_t*>(
      reinterpret_cast<const uint8_t*>(tab) + at);
}

// Phase D1: group (sy, gx)'s context that the cleanup pass fixes
// (ojph_block_decoder32.cpp:1380-1420, tpu/block_refine.py::_sigprop's
// mbr without the terms of this pass's own decisions): candidates |
// not-yet-significant << 16.
__device__ __forceinline__ uint32_t group_context(const uint32_t* sig,
                                                  const Geo& g, int sy,
                                                  int gx, int W, int hl,
                                                  bool causal) {
  const uint32_t* c = sig + sy * g.gs + gx;  // this stripe
  const uint32_t* n = c + g.gs;              // the stripe below
  const uint32_t cs = c[0] | (c[1] << 16);
  const uint32_t ns = n[0] | (n[1] << 16);
  const uint32_t ps = sy > 0 ? c[-g.gs] | (c[1 - g.gs] << 16) : 0u;
  const uint32_t u = ((ps & 0x88888888u) >> 3) |
                     (causal ? 0u : (ns & 0x11111111u) << 3);
  uint32_t m = cs | vspread(cs) | u;
  m |= (m << 4) | (m >> 4);
  if (gx > 0) {
    // the left group's column 3, as its `prev` carries it
    const uint32_t lcs = c[-1];
    const uint32_t lps = sy > 0 ? c[-1 - g.gs] : 0u;
    const uint32_t lu = ((lps & 0x8888u) >> 3) |
                        (causal ? 0u : (n[-1] & 0x1111u) << 3);
    m |= ((lcs | vspread(lcs) | lu) & 0xF000u) >> 12;
  }
  const int rl = hl - 4 * sy;
  uint32_t pattern = rl >= 4   ? 0xFFFFu
                     : rl == 3 ? 0x7777u
                     : rl == 2 ? 0x3333u
                               : 0x1111u;
  const int over = 4 * gx + 4 - W;
  if (over > 0) pattern >>= 4 * over;
  const uint32_t inv = ~cs & pattern;
  return (m & inv) | (inv << 16);
}

// (a & b) | c as one operation, so that the compiler keeps a column
// step's index two operations after its table read
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// Phase D2: SigProp's chain over `nst` stripes, on one lane.  res[group]
// = new significance | offset of its sign bits << 16.
__device__ __forceinline__ void sigprop_chain(const Src& spp,
                                              const uint32_t* ctx,
                                              uint32_t* res, const Geo& g,
                                              int nst, const uint16_t* tab) {
  // The stream at bit `off`: the words lo = j - 1 and hi = j around bit
  // q = off + 31 = 32 * j + u, and the word after them read ahead.  A
  // funnel shift of (hi, lo) by u gives the window doubled (bit 1 is bit
  // off), so that a column's index is a byte offset.
  uint32_t lo = 0, hi = spp.word(0), nxt = spp.word(1);
  uint32_t j = 0, u = 31, off = 0;
  for (int sy = 0; sy < nst; ++sy) {
    const uint32_t* crow = ctx + sy * g.gs;
    uint32_t* rrow = res + sy * g.gs;
    const uint32_t* arow = rrow - g.gs;  // the stripe above, when sy > 0
    uint32_t c = crow[0];
    uint32_t a_lo = sy > 0 ? arow[0] : 0u, a_hi = sy > 0 ? arow[1] : 0u;
    // the last column step's entry (its spread, bits 5-8, carries into the
    // next group's column 0) and the left group's row-0 term from above
    uint32_t e = 0, udl = 0;
#pragma unroll 2
    for (int gx = 0; gx < g.n_gx; ++gx) {
      // the next group's words, off the chain (past the row: pad words
      // that are not used)
      const uint32_t c_next = crow[gx + 1];
      const uint32_t a_next = sy > 0 ? arow[gx + 2] : 0u;
      // row 3 of the stripe above's new significance, as row 0
      // candidates of this group's columns and their neighbours
      const uint32_t ud = (((a_lo & 0xFFFFu) | (a_hi << 16)) & 0x88888888u)
                          >> 3;
      const uint32_t inv = c >> 16;
      // the candidates that do not wait on the left group's decisions
      const uint32_t stat = (c | ud | (ud << 4) | (ud >> 4) | udl) & inv;
      uint32_t nsig = 0, cnt = 0, used = 0;
      if (stat | ((e >> 5) & inv & 0xFu)) {
        uint32_t v = __funnelshift_r(lo, hi, u);
#pragma unroll
        for (int col = 0; col < 4; ++col) {
          const uint32_t ic = (inv >> (4 * col)) & 0xFu;
          const uint32_t fix = (((stat >> (4 * col)) & 0xFu) << 5) | (ic << 9);
          // the previous column's spread on this column's rows not yet
          // significant, joined to its candidates, then the window
          e = col_table(tab, and_or(v, 0x1Eu, and_or(e, ic << 5, fix)));
          // bits 0-4 of e are the bits read (0-4)
          v = __funnelshift_r(v, 0u, e);
          cnt += e & 0xFu;
          used += e >> 13;  // its sign bits; the bits read join below
          nsig |= ((e >> 9) & 0xFu) << (4 * col);
        }
      } else {
        e = 0;
      }
      used += cnt;
      rrow[gx] = nsig | ((off + cnt) << 16);
      off += used;
      // advance the word pair when the bits read cross a word
      const uint32_t t = u + used;
      const bool adv = t >= 32u;
      u = t & 31u;
      lo = adv ? hi : lo;
      hi = adv ? nxt : hi;
      j += adv ? 1u : 0u;
      nxt = spp.word(j + 1);
      udl = (ud & 0xF000u) >> 12;
      c = c_next;
      a_lo = a_hi;
      a_hi = a_next;
    }
  }
}

// ---- the kernel ----

struct Args {
  void* dec;
  // dense mode
  const uint32_t* spp;
  const uint32_t* mrp;
  int ws, wm;
  // raw mode
  const uint8_t* blob;
  long long blob_bytes;
  const int32_t* roff;
  const int32_t* len2;
  // both
  const int32_t* p;
  const int32_t* npasses;
  const int32_t* h_lim;
  const int32_t* causal;
  int n, width, height;
  int vec;   // 16-byte reads of dec: width % 4 == 0, dec 16-byte aligned
  int pack;  // a block's chains on its first warp (see phase D2)
};

template <bool RAW, int B>
__global__ void ht_refine_kernel(const Args a) {
  using T = typename std::conditional<B == 64, unsigned long long,
                                      uint32_t>::type;
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  {
    // the table into shared memory, eight 16-byte reads a thread in flight
    constexpr int kVec = kTableBytes / 16;
    const uint4* src = reinterpret_cast<const uint4*>(g_col_table);
    uint4* dst = reinterpret_cast<uint4*>(smem);
    for (int i0 = threadIdx.x; i0 < kVec; i0 += 8 * blockDim.x) {
      uint4 t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j * blockDim.x;
        if (i < kVec) t[j] = src[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = i0 + j * blockDim.x;
        if (i < kVec) dst[i] = t[j];
      }
    }
    __syncthreads();
  }
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem);
  uint32_t* base = smem + kTableBytes / 4;
  const int nwarps = blockDim.x >> 5;
  const int cb = blockIdx.x * nwarps + warp;
  // a codeblock past the end or with npasses < 2 stays as it is; its warp
  // still meets the block's barriers
  const int npasses = cb < a.n ? a.npasses[cb] : 0;
  const bool live = npasses >= 2;
  const int W = a.width, H = a.height;
  const Geo g = geometry(W, H);
  const int gs = g.gs;
  Chain* chain = reinterpret_cast<Chain*>(base + warp * warp_words(W, H));
  uint32_t* sig = reinterpret_cast<uint32_t*>(chain) + kChainWords;
  uint32_t* ctx = sig + g.sig_words;
  uint32_t* res = ctx + g.grp_words;
  uint32_t* sbuf = res + g.grp_words;
  uint32_t* mbuf = sbuf + g.cap_spp + kBatchWords;
  T* d = static_cast<T*>(a.dec) + static_cast<size_t>(live ? cb : 0) * H * W;
  const int hl = live ? a.h_lim[cb] : 0;
  const uint32_t pu = live ? static_cast<uint32_t>(a.p[cb]) : 0u;
  const bool causal = live && a.causal[cb] != 0;
  // stripes SigProp visits: those with a row below h_lim
  const int nst = hl <= 0 ? 0 : (hl >= 4 * g.n_sy ? g.n_sy : (hl + 3) >> 2);
  Src spp{}, mrp{};

  if (live) {
    // phase A: the cleanup significance of rows below min(h_lim, H)
    for (int i = lane; i < g.grp_words; i += 32) res[i] = 0u;
    const int rows = hl < 0 ? 0 : (hl < H ? hl : H);
    if (B == 64 && a.vec) {
      // as below, each group row two 16-byte reads of 8-byte samples
      for (int i0 = lane; i0 < g.sig_words; i0 += 64) {
        ulonglong2 v[2][4][2];
  #pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = i0 + 32 * j, sy = i / gs, gx = i - sy * gs;
  #pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int y = 4 * sy + r;
            const bool in = i < g.sig_words && gx < g.n_gx && y < rows;
  #pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              v[j][r][hh] = in ? reinterpret_cast<const ulonglong2*>(
                                     d + static_cast<size_t>(y) * W)[2 * gx + hh]
                               : make_ulonglong2(0ull, 0ull);
          }
        }
  #pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t m = 0;
  #pragma unroll
          for (int r = 0; r < 4; ++r)
            m |= ((v[j][r][0].x ? 1u : 0u) | (v[j][r][0].y ? 16u : 0u) |
                  (v[j][r][1].x ? 256u : 0u) | (v[j][r][1].y ? 4096u : 0u))
                 << r;
          if (i0 + 32 * j < g.sig_words) sig[i0 + 32 * j] = m;
        }
      }
    } else if (a.vec) {
      // a group a lane, two an iteration: their rows' 16-byte reads, all
      // issued before any is used; no atomics
      for (int i0 = lane; i0 < g.sig_words; i0 += 64) {
        uint4 v[2][4];
  #pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = i0 + 32 * j, sy = i / gs, gx = i - sy * gs;
  #pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int y = 4 * sy + r;
            v[j][r] = i < g.sig_words && gx < g.n_gx && y < rows
                          ? reinterpret_cast<const uint4*>(
                                d + static_cast<size_t>(y) * W)[gx]
                          : make_uint4(0u, 0u, 0u, 0u);
          }
        }
  #pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t m = 0;
  #pragma unroll
          for (int r = 0; r < 4; ++r)
            m |= ((v[j][r].x ? 1u : 0u) | (v[j][r].y ? 16u : 0u) |
                  (v[j][r].z ? 256u : 0u) | (v[j][r].w ? 4096u : 0u))
                 << r;
          if (i0 + 32 * j < g.sig_words) sig[i0 + 32 * j] = m;
        }
      }
    } else {
      for (int i = lane; i < g.sig_words; i += 32) sig[i] = 0u;
      __syncwarp();
      for (int i = lane; i < rows * W; i += 32) {
        if (d[i] != T(0)) {
          const int y = i / W, x = i - y * W;
          atomicOr(sig + (y >> 2) * gs + (x >> 2),
                   1u << (((x & 3) << 2) | (y & 3)));
        }
      }
    }

    // phase B: the streams
    if (RAW) {
      const long long off = a.roff[cb];
      int n = a.len2[cb];
      if (off < 0 || n < 0 || off + n > a.blob_bytes) n = 0;
      const uint8_t* seg = a.blob + (n > 0 ? off : 0);
      spp = raw_src<kSpp>(seg, n, sbuf, g.cap_spp, lane);
      mrp = raw_src<kMrp>(seg + (n > 0 ? n - 1 : 0), npasses >= 3 ? n : 0,
                          mbuf, g.cap_mrp, lane);
    } else {
      const size_t i = static_cast<size_t>(cb);
      spp = dense_src(a.spp + i * a.ws, a.ws, sbuf, g.cap_spp, lane);
      mrp = dense_src(a.mrp + i * a.wm, a.wm, mbuf, g.cap_mrp, lane);
    }
    __syncwarp();

    // phase D1: the groups' fixed context, a group a lane
    for (int i = lane; i < nst * g.n_gx; i += 32) {
      const int sy = i / g.n_gx, gx = i - sy * g.n_gx;
      ctx[sy * gs + gx] = group_context(sig, g, sy, gx, W, hl, causal);
    }
    __syncwarp();
    if (lane == 0) {
      chain->spp = spp;
      chain->nst = nst;
    }
  } else if (lane == 0) {
    chain->nst = 0;
  }
  // a packed block's chains read their warps' words
  if (a.pack)
    __syncthreads();
  else
    __syncwarp();
  // phase D2: SigProp's chain of each codeblock on one lane: its own
  // warp's lane 0, or in a packed launch (a.pack) lane k of the block's
  // first warp for its codeblock k, so that one instruction stream serves
  // several chains
  const int owner = a.pack ? lane : warp;
  if (a.pack ? warp == 0 && lane < nwarps : lane == 0) {
    uint32_t* region = base + owner * warp_words(W, H);
    // a copy in registers (the chain's stores could alias the slot); a raw
    // stream is all in shared memory, which the compiler is told
    const Chain c = *reinterpret_cast<const Chain*>(region);
    const Src spp_c = RAW ? Src{c.spp.sh, nullptr, c.spp.lim, c.spp.lim, 0u}
                          : c.spp;
    uint32_t* cctx = region + kChainWords + g.sig_words;
    if (c.nst > 0)
      sigprop_chain(spp_c, cctx, cctx + g.grp_words, g, c.nst, tab);
  }
  if (a.pack)
    __syncthreads();
  else
    __syncwarp();
  if (live) {
    // phase E: a step (two groups of a stripe, 8 columns) a lane.  MagRef:
    // a warp scan of the steps' significance popcounts gives each its bit
    // offset.  SigProp: each group's sign bits at its stored offset.  Then
    // each row of the step with a changed sample is read, refined and
    // written back.
    T val16, half, both;
    if (B == 64) {
      val16 = static_cast<T>(shl64(3ull, pu - 2u));
      half = static_cast<T>(shl64(1ull, pu - 2u));
      both = static_cast<T>(shl64(1ull, pu - 1u)) | half;
    } else {
      val16 = static_cast<T>(shl32(3u, pu - 2u));
      half = static_cast<T>(shl32(1u, pu - 2u));
      both = static_cast<T>(shl32(1u, pu - 1u)) | half;
    }
    const bool mag = npasses >= 3;
    const int steps = nst * g.n_g2;
    uint32_t base_bit = 0;
    for (int s0 = 0; s0 < steps; s0 += 32) {
      const int s = s0 + lane;
      int sy = 0, g2 = 0;
      uint32_t msig = 0, r0 = 0, r1 = 0;
      if (s < steps) {
        sy = s / g.n_g2;
        g2 = s - sy * g.n_g2;
        const int at = sy * gs + 2 * g2;
        if (mag) msig = sig[at] | (sig[at + 1] << 16);
        r0 = res[at];
        r1 = res[at + 1];
      }
      // MagRef's bits for the step's significant samples, in position order
      uint32_t mbits = 0;
      if (mag) {
        const int pc = __popc(msig);
        const int incl = warp_incl_scan(pc, lane);
        if (msig) mbits = mrp.bits32(base_bit + incl - pc);
        base_bit += static_cast<uint32_t>(__shfl_sync(kFull, incl, 31));
      }
      const uint32_t nsig = (r0 & 0xFFFFu) | (r1 << 16);
      if (!(msig | nsig)) continue;
      // each group's sign bits, one per newly significant sample in position
      // order
      const uint32_t sb0 = (r0 & 0xFFFFu) ? spp.bits32(r0 >> 16) : 0u;
      const uint32_t sb1 = (r1 & 0xFFFFu) ? spp.bits32(r1 >> 16) : 0u;
      // sample x = 8 * g2 + c of row r is bit b = 4 * c + r of the step's
      // words; its bit of a stream is the one its rank among the set bits
      // names
      auto refine = [&](int r, int c, T v) -> T {
        const int b = 4 * c + r;
        const uint32_t below = (1u << b) - 1u;
        const T mv =
            v ^ (((mbits >> __popc(msig & below)) & 1u) ? half : both);
        const uint32_t sb = b < 16 ? sb0 >> __popc(nsig & below)
                                   : sb1 >> __popc(nsig & below & ~0xFFFFu);
        // a new sample was 0 (not cleanup-significant, in a row below
        // h_lim and H)
        const T sv = (static_cast<T>(sb & 1u) << (B - 1)) | val16;
        return ((msig >> b) & 1u) ? mv : (((nsig >> b) & 1u) ? sv : v);
      };
      const uint32_t chg = msig | nsig;
      T* rows0 = d + static_cast<size_t>(4 * sy) * W + 8 * g2;
      if (B == 64 && a.vec) {
        // as below, a group's row as two 16-byte pieces of 8-byte samples
  #pragma unroll
        for (int h4 = 0; h4 < 2; ++h4) {
          ulonglong2 v[4][2];
  #pragma unroll
          for (int r = 0; r < 4; ++r)
            if (4 * sy + r < H && (chg & (0x1111u << (16 * h4 + r))))
  #pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                v[r][hh] = reinterpret_cast<const ulonglong2*>(
                    rows0 + static_cast<size_t>(r) * W)[2 * h4 + hh];
  #pragma unroll
          for (int r = 0; r < 4; ++r)
            if (4 * sy + r < H && (chg & (0x1111u << (16 * h4 + r)))) {
  #pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                ulonglong2 t = v[r][hh];
                t.x = refine(r, 4 * h4 + 2 * hh, t.x);
                t.y = refine(r, 4 * h4 + 2 * hh + 1, t.y);
                reinterpret_cast<ulonglong2*>(
                    rows0 + static_cast<size_t>(r) * W)[2 * h4 + hh] = t;
              }
            }
        }
      } else if (a.vec) {
        // a group at a time: its changed rows' 16-byte pieces read, then
        // refined and written
  #pragma unroll
        for (int h4 = 0; h4 < 2; ++h4) {
          uint4 v[4];
  #pragma unroll
          for (int r = 0; r < 4; ++r)
            if (4 * sy + r < H && (chg & (0x1111u << (16 * h4 + r))))
              v[r] = reinterpret_cast<const uint4*>(
                  rows0 + static_cast<size_t>(r) * W)[h4];
  #pragma unroll
          for (int r = 0; r < 4; ++r)
            if (4 * sy + r < H && (chg & (0x1111u << (16 * h4 + r)))) {
              uint4 t = v[r];
              t.x = static_cast<uint32_t>(refine(r, 4 * h4, t.x));
              t.y = static_cast<uint32_t>(refine(r, 4 * h4 + 1, t.y));
              t.z = static_cast<uint32_t>(refine(r, 4 * h4 + 2, t.z));
              t.w = static_cast<uint32_t>(refine(r, 4 * h4 + 3, t.w));
              reinterpret_cast<uint4*>(rows0 + static_cast<size_t>(r) * W)[h4] =
                  t;
            }
        }
      } else {
        for (int r = 0; r < 4 && 4 * sy + r < H; ++r)
          for (int c = 0; c < 8; ++c)
            if (chg & (1u << (4 * c + r))) {
              T* at = rows0 + static_cast<size_t>(r) * W + c;
              *at = refine(r, c, *at);
            }
      }
    }
  }
}

// ---- launch ----

// How a launch of n codeblocks of width x height with per_block asked for
// runs on the current device: k codeblocks a CUDA block, smem bytes of
// shared memory a block, and whether a block's chains share its first warp.
struct Shape {
  int k;
  size_t smem;
  bool pack;
};

__host__ inline cudaError_t launch_shape(int n, int width, int height,
                                         int per_block, Shape& s) {
  // sign-bit offsets are kept in 16 bits: SigProp reads at most 32 bits a
  // group (JPEG 2000 codeblocks have at most 4,096 samples, 256 groups)
  const Geo g = geometry(width, height);
  if (g.n_sy * g.n_gx > 2000) return cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const size_t per_warp = static_cast<size_t>(warp_words(width, height)) * 4;
  int k = per_block > 0 ? (per_block < 32 ? per_block : 32) : 1;
  while (k > 1 && kTableBytes + k * per_warp > static_cast<size_t>(optin)) --k;
  s.k = k;
  s.smem = kTableBytes + k * per_warp;
  if (s.smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  // A chain issues about one instruction every four cycles, so some 16
  // chains an SM (four a scheduler) fill its issue slots.  Past that, the
  // chains' instruction streams and not their latency set the time, and a
  // block's chains share one warp.
  s.pack = k > 1 && n > kChainsPerSm * sms;
  return cudaSuccess;
}

template <bool RAW, int B>
int launch(Args a, int per_block, cudaStream_t stream) {
  if (a.n <= 0) return static_cast<int>(cudaGetLastError());
  if (a.width < 1 || a.height < 1 || (!RAW && (a.ws < 1 || a.wm < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  cudaError_t e = launch_shape(a.n, a.width, a.height, per_block, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices || !g_tables_ready[dev])
    return static_cast<int>(cudaErrorInitializationError);
  a.vec = (a.width & 3) == 0 &&
          (reinterpret_cast<uintptr_t>(a.dec) & 15u) == 0;
  if (s.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(ht_refine_kernel<RAW, B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  a.pack = s.pack;
  const int grid = (a.n + s.k - 1) / s.k;
  ht_refine_kernel<RAW, B><<<grid, 32 * s.k, s.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ojr

namespace ojr {

template <int B>
int dense_entry(void* dec, const void* spp, const void* mrp, int ws, int wm,
                const void* p, const void* npasses, const void* h_lim,
                const void* causal, int n, int width, int height,
                int per_block, void* stream) {
  Args a{};
  a.dec = dec;
  a.spp = static_cast<const uint32_t*>(spp);
  a.mrp = static_cast<const uint32_t*>(mrp);
  a.ws = ws;
  a.wm = wm;
  a.p = static_cast<const int32_t*>(p);
  a.npasses = static_cast<const int32_t*>(npasses);
  a.h_lim = static_cast<const int32_t*>(h_lim);
  a.causal = static_cast<const int32_t*>(causal);
  a.n = n;
  a.width = width;
  a.height = height;
  return launch<false, B>(a, per_block, static_cast<cudaStream_t>(stream));
}

template <int B>
int raw_entry(void* dec, const void* blob, long long blob_bytes,
              const void* roff, const void* len2, const void* p,
              const void* npasses, const void* h_lim, const void* causal,
              int n, int width, int height, int per_block, void* stream) {
  Args a{};
  a.dec = dec;
  a.blob = static_cast<const uint8_t*>(blob);
  a.blob_bytes = blob_bytes;
  a.roff = static_cast<const int32_t*>(roff);
  a.len2 = static_cast<const int32_t*>(len2);
  a.p = static_cast<const int32_t*>(p);
  a.npasses = static_cast<const int32_t*>(npasses);
  a.h_lim = static_cast<const int32_t*>(h_lim);
  a.causal = static_cast<const int32_t*>(causal);
  a.n = n;
  a.width = width;
  a.height = height;
  return launch<true, B>(a, per_block, static_cast<cudaStream_t>(stream));
}

}  // namespace ojr

extern "C" {

// SigProp's column table (kTableBytes bytes in host memory) copied to the
// current device; needed once per device before the first launch there.
// Returns the CUDA error code (0 on success).
int ht_refine_set_tables(const void* table, int bytes) {
  if (table == nullptr || bytes != ojr::kTableBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= ojr::kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  e = cudaMemcpyToSymbol(ojr::g_col_table, table, ojr::kTableBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  ojr::g_tables_ready[dev] = true;
  return 0;
}

// Shared-memory bytes a codeblock (warp) of width x height takes; a CUDA
// block adds the table's kTableBytes.
int ht_refine_warp_bytes(int width, int height) {
  return ojr::warp_words(width, height) * 4;
}

// 1 when a launch of n codeblocks of width x height, per_block a CUDA
// block, on the current device puts a block's SigProp chains on its first
// warp, 0 when each runs on its own warp; below 0, minus the CUDA error.
int ht_refine_packs(int n, int width, int height, int per_block) {
  ojr::Shape s;
  const cudaError_t e = ojr::launch_shape(n, width, height, per_block, s);
  return e == cudaSuccess ? (s.pack ? 1 : 0) : -static_cast<int>(e);
}

// Dense mode: dec [n, height, width] uint32, refined in place; spp / mrp
// [n, ws | wm] uint32 rows; p, npasses, h_lim, causal [n] int32; per_block
// codeblocks (warps) per CUDA block.  Returns the CUDA error code of the
// launch (0 on success).
int ht_refine_decode_dense(void* dec, const void* spp, const void* mrp,
                           int ws, int wm, const void* p,
                           const void* npasses, const void* h_lim,
                           const void* causal, int n, int width, int height,
                           int per_block, void* stream) {
  return ojr::dense_entry<32>(dec, spp, mrp, ws, wm, p, npasses, h_lim,
                              causal, n, width, height, per_block, stream);
}

// Raw mode: blob [blob_bytes] uint8; lane i's refinement segment is
// blob[roff[i] : roff[i] + len2[i]] (roff, len2 [n] int32).
int ht_refine_decode_raw(void* dec, const void* blob, long long blob_bytes,
                         const void* roff, const void* len2, const void* p,
                         const void* npasses, const void* h_lim,
                         const void* causal, int n, int width, int height,
                         int per_block, void* stream) {
  return ojr::raw_entry<32>(dec, blob, blob_bytes, roff, len2, p, npasses,
                            h_lim, causal, n, width, height, per_block,
                            stream);
}

// The 64-bit instantiations: dec [n, height, width] uint64, p = 62 -
// missing_msbs; the other arguments as above.
int ht_refine_decode_dense64(void* dec, const void* spp, const void* mrp,
                             int ws, int wm, const void* p,
                             const void* npasses, const void* h_lim,
                             const void* causal, int n, int width,
                             int height, int per_block, void* stream) {
  return ojr::dense_entry<64>(dec, spp, mrp, ws, wm, p, npasses, h_lim,
                              causal, n, width, height, per_block, stream);
}

int ht_refine_decode_raw64(void* dec, const void* blob, long long blob_bytes,
                           const void* roff, const void* len2, const void* p,
                           const void* npasses, const void* h_lim,
                           const void* causal, int n, int width, int height,
                           int per_block, void* stream) {
  return ojr::raw_entry<64>(dec, blob, blob_bytes, roff, len2, p, npasses,
                            h_lim, causal, n, width, height, per_block,
                            stream);
}

}  // extern "C"
