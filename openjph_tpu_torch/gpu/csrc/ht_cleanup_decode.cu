// HT cleanup-pass block decoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package,
// openjph_tpu/tpu/block_decode_pallas.py::_make_kernel (pallas_call in
// _run_pallas), in both of its reader modes:
//   dense (decode_cleanup_pallas): MEL / VLC / MagSgn arrive as dense,
//     host-unstuffed, LSB-first uint32 words, one row per codeblock;
//   raw (decode_cleanup_pallas_raw): the kernel takes each codeblock's
//     stuffed bytes straight from the packed segment blob and unstuffs
//     them itself (MagSgn forward, MEL forward, VLC backward from the end
//     of the shared suffix), by the rules of the reference's
//     frwd_struct32 / dec_mel_st / rev_struct
//     (ojph_block_decoder32.cpp:63-723) as gpu/unstuff.py states them.
// Semantics are those of tpu/block_decode.py::decode_cleanup_core: the
// same p = 30 - missing_msbs, the same per-lane quad-row limit qhl
// (errors only below it), the same error flag (U_q > missing_msbs + 2).
// Rows at or past 2*qhl are not decoded; they are written as zeros.  A
// raw lane whose byte range leaves the blob, or whose suffix is longer
// than HTJ2K's Scup cap (4,079 bytes), is flagged and zeroed.  A read
// past a stream's end gives its guard fill: ones for MEL and MagSgn,
// zeros for VLC.
//
// What bounds it.  Not bytes: a 2048x1080 gray frame moves about 1 MB of
// coded bytes in and 12.6 MB of samples out, a few microseconds of HBM
// time.  Only the MEL / VLC / UVLC chain of a codeblock is serial: each
// quad's VLC context and table index depend on the bits the quad before
// consumed.  The kernel's time is that chain (phase 1 below) on the
// frame's longest lane, 512 pair steps for a 64x64 block, each some 120
// dependent instructions around three dependent shared-memory table
// reads; the frame has a few hundred lanes, so no other warp fills the
// gaps.  On that frame phase 1 is most of the kernel's time
// (chip_smoke.py's phase split).
//
// Design: one warp per codeblock, in three phases (the JAX package's
// split of the decode into _step1 and _step2, tpu/block_decode.py), so
// that everything but the chain runs 32 lanes wide and off it.
//   Phase 0 (all 32 lanes): the MEL and VLC streams become unstuffed
//     words in shared memory.  Dense mode copies the word rows with
//     coalesced loads; raw mode unstuffs the suffix 128 bytes at a time,
//     four bytes a lane (a byte's payload depends only on it and the two
//     bytes before it), places the payloads with a warp scan of their
//     bit counts and ORs them into the words.
//   Phase 1 (one lane): the serial chain, MEL runs, VLC lookups with the
//     context c_q and the UVLC pair decode, for quad rows [0, qhl), with
//     64-bit windows fed from shared memory.  It writes each quad's inf
//     and u to shared memory and does no MagSgn work.
//   Phase 2 (all 32 lanes, one quad per lane, quad rows in order): each
//     lane takes kappa from the row above's exponents, computes U_q and
//     its samples' bit counts m_n; a warp scan of the counts gives each
//     quad its MagSgn bit offset; each lane extracts its bits, assembles
//     its four samples and stores them (a 64-wide block's sample row is
//     64 consecutive words); one shuffle hands each lane its left
//     neighbour's exponent for the next row.  Rows wider than 32 quads
//     are walked in chunks of 32.  Dense MagSgn is read from global
//     memory; raw MagSgn is unstuffed by the warp into a ring of words in
//     shared memory ahead of each chunk, so no plan-sized buffer bounds
//     it.
// K codeblocks (warps) share a CUDA block and its copy of the VLC / UVLC
// tables (2,624 words).  The kernel launches on the caller's stream and
// allocates nothing.
//
// 64-bit instantiation (entries ..._dense64 / ..._raw64; B = 64 below).
// The reference decodes a codeblock of more than 30 bit planes with
// ojph_decode_codeblock64, which the JAX package runs on its host
// (coding/decoder.py's B == 64 path, native decode_codeblock); no TPU
// kernel is behind it.  The same kernel is instantiated on the sample
// type: p = 62 - missing_msbs, the sign in bit 63, `dec` uint64.  Phase 1
// adds the u_q extension (four more VLC bits where u passes 32 plus the
// initial row's UVLC bias, decoder64.cpp:1000-1010, 1122-1132; the bias
// table follows the UVLC tables); phase 2 reads up to 64 MagSgn bits a
// sample from three words, keeps the exponents in 64 bits and widens the
// raw MagSgn ring to 512 words (a chunk reads up to 32 * 4 * 63 bits).  A
// lane with p < 1 (missing_msbs >= 62, "64 bits insufficient") is flagged
// and zeroed.

#include <cstdint>
#include <cuda_runtime.h>

namespace ojk {

constexpr int kVlcEntries = 2048;   // dec_vlc0 | dec_vlc1
constexpr int kUvlcEntries = 576;   // dec_uvlc0 (320) | dec_uvlc1 (256)
constexpr int kBiasEntries = 320;   // dec_uvlc0_bias (64-bit tables only)
constexpr int kTableWords = kVlcEntries + kUvlcEntries;
constexpr int kMaxSuffix = 4079;    // HTJ2K's cap on Scup, in bytes
// shared words per MEL or VLC stream: 4,096 bytes of 8 bits (a raw
// suffix is unstuffed in batches of 128 bytes)
constexpr int kSuffixWords = 1024;
constexpr int kRingWords = 256;     // raw MagSgn ring, a power of two
constexpr unsigned kFull = 0xFFFFFFFFu;

// What differs between the two instantiations.
template <int B>
struct Width;
template <>
struct Width<32> {
  using T = uint32_t;
  static constexpr int kTables = kTableWords;
  static constexpr int kRing = kRingWords;
};
template <>
struct Width<64> {
  using T = unsigned long long;
  static constexpr int kTables = kTableWords + kBiasEntries;
  static constexpr int kRing = 2 * kRingWords;
};

// A build option for timing the phases (chip_smoke.py's phase split):
// -DOJK_STOP_AFTER=0 stops each codeblock after phase 0, =1 after phase
// 1 (its samples are then left unwritten).  The default runs them all.
#ifndef OJK_STOP_AFTER
#define OJK_STOP_AFTER 2
#endif

enum { kMs = 0, kMel = 1, kVlc = 2 };

__device__ __forceinline__ uint32_t shl32(uint32_t v, uint32_t n) {
  return n >= 32u ? 0u : v << n;
}

__device__ __forceinline__ uint32_t lowmask(uint32_t n) {
  return n >= 32u ? 0xFFFFFFFFu : (1u << n) - 1u;
}

__device__ __forceinline__ unsigned long long shl64(unsigned long long v,
                                                    uint32_t n) {
  return n >= 64u ? 0ull : v << n;
}

__device__ __forceinline__ unsigned long long lowmask64(uint32_t n) {
  return n >= 64u ? ~0ull : (1ull << n) - 1ull;
}

__device__ __forceinline__ uint32_t shl_t(uint32_t v, uint32_t n) {
  return shl32(v, n);
}
__device__ __forceinline__ unsigned long long shl_t(unsigned long long v,
                                                    uint32_t n) {
  return shl64(v, n);
}
__device__ __forceinline__ uint32_t lowmask_t(uint32_t, uint32_t n) {
  return lowmask(n);
}
__device__ __forceinline__ unsigned long long lowmask_t(unsigned long long,
                                                        uint32_t n) {
  return lowmask64(n);
}
__device__ __forceinline__ int clz_t(uint32_t v) {
  return __clz(static_cast<int>(v));
}
__device__ __forceinline__ int clz_t(unsigned long long v) {
  return __clzll(static_cast<long long>(v));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ uint32_t bitrev8(uint32_t b) {
  b = ((b & 0xF0u) >> 4) | ((b & 0x0Fu) << 4);
  b = ((b & 0xCCu) >> 2) | ((b & 0x33u) << 2);
  return ((b & 0xAAu) >> 1) | ((b & 0x55u) << 1);
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// ---- phase 0: unstuffing ----

// Payload (v, c bits) of byte j of a stream of n bytes, from the byte b
// and the two raw bytes before it (p1 = byte j-1, p2 = byte j-2).
template <int KIND>
__device__ __forceinline__ void payload(uint32_t b, uint32_t p1, uint32_t p2,
                                        int j, int n, uint32_t& v, int& c) {
  c = 8;
  if (j >= n) {
    v = KIND == kVlc ? 0u : 0xFFu;
  } else if (KIND == kMs) {
    // a byte after 0xFF loses bit 7; a byte after such a byte takes the
    // previous byte's bit 7 into its bit 0
    const bool stuffed = j > 0 && p1 == 0xFFu;
    const bool carry = j > 1 && p2 == 0xFFu;
    v = b | (carry ? (p1 >> 7) & 1u : 0u);
    if (stuffed) {
      v &= 0x7Fu;
      c = 7;
    }
  } else if (KIND == kMel) {
    v = bitrev8(b);
    if (j > 0 && p1 == 0xFFu) {
      v >>= 1;
      c = 7;
    }
  } else {
    // the first byte gives its high nibble (3 bits when the nibble's low
    // three are ones); a later byte drops bit 7 when the byte before was
    // above 0x8F and its low 7 bits are ones; a dropped bit ORs into the
    // next byte's bit 0, and on the last byte it stays
    const bool last = j == n - 1;
    const bool carry = j == 1 ? ((p1 >> 4) & 7u) == 7u
                              : j > 1 && p2 > 0x8Fu && (p1 & 0x7Fu) == 0x7Fu;
    v = b | (carry ? (p1 >> 7) & 1u : 0u);
    if (j == 0) {
      if (((b >> 4) & 7u) == 7u && !last) {
        v = (v >> 4) & 7u;
        c = 3;
      } else {
        v >>= 4;
        c = 4;
      }
    } else if (p1 > 0x8Fu && (b & 0x7Fu) == 0x7Fu && !last) {
      v &= 0x7Fu;
      c = 7;
    }
  }
}

// Unstuffs bytes j0 .. j0+127 of a stream, four a lane (lane L takes
// bytes j0+4L .. j0+4L+3; VLC reads backward from src), and ORs their
// payloads into buf at bit pos0 and on (word index & mask); the words
// must be zero there.  `carry` holds the raw bytes j0-2 | j0-1 << 8 in
// and j0+126 | j0+127 << 8 out.  Returns the bits appended (at most
// 1,024; the same on every lane).
template <int KIND>
__device__ __forceinline__ uint32_t unstuff128(const uint8_t* src, int j0,
                                               int n, uint32_t& carry,
                                               uint32_t* buf, uint32_t mask,
                                               uint32_t pos0, int lane) {
  const int j = j0 + 4 * lane;
  uint32_t b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    b[k] = j + k < n ? __ldg(KIND == kVlc ? src - (j + k) : src + (j + k))
                     : 0u;
  const uint32_t tail = b[2] | (b[3] << 8);
  uint32_t before = __shfl_up_sync(kFull, tail, 1);
  if (lane == 0) before = carry;
  uint32_t p2 = before & 0xFFu, p1 = before >> 8;
  uint32_t bits = 0;  // the four payloads, LSB-first
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
    atomicOr(buf + (w & mask), bits << s);
    // s > 0 here: cnt <= 32
    if (s + cnt > 32u) atomicOr(buf + ((w + 1u) & mask), bits >> (32u - s));
  }
  carry = __shfl_sync(kFull, tail, 31);
  return static_cast<uint32_t>(__shfl_sync(kFull, incl, 31));
}

// ---- phase 1: the serial chain ----

// A MEL or VLC stream as unstuffed LSB-first words: [0, lim) in shared
// memory, [lim, last) in global memory (dense rows wider than the shared
// buffer), and `fill` at and past `last`.
struct WordSrc {
  const uint32_t* sh;
  const uint32_t* gl;
  int lim, last;
  uint32_t fill;
  __device__ __forceinline__ uint32_t word(int i) const {
    return i < lim ? sh[i] : (i < last ? __ldg(gl + i) : fill);
  }
};

// LSB-first bit window; holds at most 63 valid bits.  A refill adds one
// word when fewer than 32 bits remain (the plain version's rule); the
// next word is loaded ahead so a refill does not wait on memory.
struct Reader {
  uint64_t bits;
  int nb;
  WordSrc src;
  int wi;
  uint32_t next;
  __device__ __forceinline__ void init(const WordSrc& s) {
    bits = 0;
    nb = 0;
    src = s;
    wi = 0;
    next = s.word(0);
  }
  __device__ __forceinline__ void refill() {
    if (nb < 32) {
      bits |= static_cast<uint64_t>(next) << nb;
      nb += 32;
      next = src.word(++wi);
    }
  }
  __device__ __forceinline__ uint32_t peek() const {
    return static_cast<uint32_t>(bits);
  }
  __device__ __forceinline__ void adv(int n) {  // n in [0, 32]
    bits >>= n;
    nb -= n;
  }
  __device__ __forceinline__ uint32_t take(int n) {
    const uint32_t v = static_cast<uint32_t>(bits) & lowmask(n);
    adv(n);
    return v;
  }
};

// MEL run decode (dec_mel_st); exponent table {0,0,0,1,1,1,2,2,2,3,3,4,5}.
__device__ __forceinline__ int mel_get_run(Reader& mel, int& mel_k) {
  const int k = clampi(mel_k, 0, 12);
  const int eva = k >= 11 ? k - 7 : (k / 3 < 3 ? k / 3 : 3);
  if (mel.take(1) == 1u) {
    mel_k = mel_k + 1 < 12 ? mel_k + 1 : 12;
    return ((1 << eva) - 1) << 1;
  }
  const uint32_t vrev = mel.take(eva);
  const uint32_t v = eva > 0 ? __brev(vrev) >> (32 - eva) : 0u;
  mel_k = mel_k - 1 > 0 ? mel_k - 1 : 0;
  return static_cast<int>(v << 1) + 1;
}

// MEL / VLC / UVLC of quad rows [0, rows) (decoder32.cpp:855-1088, the
// JAX package's _step1); quad[r * qw + qx] = inf | u << 16.  B = 64 adds
// the u_q extension (bias_tbl: dec_uvlc0_bias).
template <int B>
__device__ __forceinline__ void phase1(Reader& mel, Reader& vlc,
                                       const uint32_t* vlc_tbl,
                                       const uint32_t* uvlc_tbl,
                                       const uint32_t* bias_tbl, int rows,
                                       int qw, uint32_t* quad) {
  int mel_k = 0;
  mel.refill();
  int run = mel_get_run(mel, mel_k);  // decoder32.cpp:862
  for (int r = 0; r < rows; ++r) {
    const bool initial = r == 0;
    const uint32_t tbl_base = initial ? 0u : 1024u;
    const uint32_t ubase = initial ? 0u : 320u;
    const uint32_t* prev = initial ? quad : quad + (r - 1) * qw;
    uint32_t* cur = quad + r * qw;
    uint32_t c_q = 0;
    uint32_t a2 = initial ? 0u : prev[0] & 0xFFFFu;
    for (int qx2 = 0; qx2 < qw; qx2 += 2) {
      const bool second = qx2 + 1 < qw;
      // the row above's inf at qx2 .. qx2+2 (0 past its end)
      const uint32_t a0 = a2;
      uint32_t a1 = 0;
      a2 = 0;
      if (!initial) {
        if (second) a1 = prev[qx2 + 1] & 0xFFFFu;
        if (qx2 + 2 < qw) a2 = prev[qx2 + 2] & 0xFFFFu;
      }
      vlc.refill();
      mel.refill();
      // first quad of the pair (decoder32.cpp:855-1000)
      if (!initial) c_q |= ((a0 & 0xA0u) << 2) | ((a1 & 0x20u) << 4);
      // table indices stay in range: c_q <= 0x380 (and uvlc_mode <=
      // 0x100 on the first row, 0xC0 after it)
      uint32_t t0 = vlc_tbl[tbl_base + c_q + (vlc.peek() & 0x7Fu)];
      if (c_q == 0u) {
        run -= 2;
        if (run != -1) t0 = 0u;
        if (run < 0) run = mel_get_run(mel, mel_k);
      }
      c_q = initial ? (((t0 & 0x10u) << 3) | ((t0 & 0xE0u) << 2))
                    : (((t0 & 0x40u) << 2) | ((t0 & 0x80u) << 1) |
                       (a0 & 0x80u) | ((a1 & 0xA0u) << 2) |
                       ((a2 & 0x20u) << 4));
      vlc.adv(static_cast<int>(t0 & 7u));
      // second quad
      uint32_t t1 = 0u;
      if (second) {
        t1 = vlc_tbl[tbl_base + c_q + (vlc.peek() & 0x7Fu)];
        if (c_q == 0u) {
          run -= 2;
          if (run != -1) t1 = 0u;
          if (run < 0) run = mel_get_run(mel, mel_k);
        }
      }
      c_q = initial ? (((t1 & 0x10u) << 3) | ((t1 & 0xE0u) << 2))
                    : (((t1 & 0x40u) << 2) | ((t1 & 0x80u) << 1) |
                       (a1 & 0x80u));
      vlc.adv(static_cast<int>(t1 & 7u));
      // u for the pair (decoder32.cpp:1001-1088)
      uint32_t uvlc_mode = ((t0 & 8u) << 3) | ((t1 & 8u) << 4);
      if (initial && uvlc_mode == 0xC0u) {
        run -= 2;
        if (run == -1) uvlc_mode += 0x40u;
        if (run < 0) run = mel_get_run(mel, mel_k);
      }
      const uint32_t u_idx = uvlc_mode + (vlc.peek() & 0x3Fu);
      uint32_t ue = uvlc_tbl[ubase + u_idx];
      vlc.adv(static_cast<int>(ue & 7u));
      ue >>= 3;
      const uint32_t tmp = vlc.take(static_cast<int>(ue & 0xFu));
      ue >>= 4;
      const uint32_t len0 = ue & 7u;
      ue >>= 3;
      const uint32_t kappa0 = initial ? 1u : 0u;
      uint32_t u0 = kappa0 + (ue & 7u) + (tmp & ~(0xFFu << len0));
      uint32_t u1 = kappa0 + (ue >> 3) + (tmp >> len0);
      if (B == 64) {
        // u_q past 32: four more bits each, u0's first (decoder64.cpp:
        // 1000-1010, 1122-1132); the pair may then read past one refill
        const int bias = initial ? static_cast<int>(bias_tbl[u_idx]) : 0;
        vlc.refill();
        if (static_cast<int>(u0 - kappa0) - (bias & 3) > 32) {
          u0 += (vlc.peek() & 0xFu) << 2;
          vlc.adv(4);
        }
        vlc.refill();
        if (static_cast<int>(u1 - kappa0) - (bias >> 2) > 32) {
          u1 += (vlc.peek() & 0xFu) << 2;
          vlc.adv(4);
        }
      }
      cur[qx2] = t0 | (u0 << 16);
      if (second) cur[qx2 + 1] = t1 | (u1 << 16);
    }
  }
}

// ---- phase 2: MagSgn ----

// Dense MagSgn: the lane's word row in global memory; reads at or past
// its last word give that (guard) word.
struct DenseMs {
  const uint32_t* row;
  uint32_t last;
  __device__ __forceinline__ void ensure(uint32_t, int) {}
  __device__ __forceinline__ uint32_t word(uint32_t k) const {
    return __ldg(row + (k < last ? k : last));
  }
};

// Raw MagSgn: the lane's stuffed bytes, unstuffed by the warp 128 at a
// time into a ring of RING words in shared memory.
template <int RING>
struct RingMs {
  const uint8_t* src;
  int n, j;
  uint32_t carry;
  uint32_t produced;  // bits unstuffed so far
  uint32_t* ring;
  // Unstuff until the ring holds the stream's bits below `need`.  A
  // chunk consumes at most 32 * 4 * 31 bits (32 * 4 * 63 at B = 64), so
  // the ring's 8,192 bits (16,384) hold what the chunk reads and the
  // batch being appended.
  __device__ __forceinline__ void ensure(uint32_t need, int lane) {
    while (produced < need) {
      // clear the bits at and past `produced` in the 33 words a batch of
      // at most 1,024 bits can reach
      const uint32_t w0 = produced >> 5;
      uint32_t& wd = ring[(w0 + lane) & (RING - 1)];
      wd = lane == 0 ? wd & lowmask(produced & 31u) : 0u;
      if (lane == 0) ring[(w0 + 32u) & (RING - 1)] = 0u;
      __syncwarp();
      produced += unstuff128<kMs>(src, j, n, carry, ring, RING - 1,
                                  produced, lane);
      j += 128;
      __syncwarp();
    }
  }
  __device__ __forceinline__ uint32_t word(uint32_t k) const {
    return ring[k & (RING - 1)];
  }
};

// The MagSgn bits at bit offset pos: 32 of them, or 64 (three words).
template <class Ms>
__device__ __forceinline__ uint32_t ms_window(const Ms& ms, uint32_t pos,
                                              uint32_t) {
  const uint32_t k = pos >> 5, s = pos & 31u;
  const uint32_t w0 = ms.word(k);
  return s ? (w0 >> s) | (ms.word(k + 1) << (32u - s)) : w0;
}
template <class Ms>
__device__ __forceinline__ unsigned long long ms_window(
    const Ms& ms, uint32_t pos, unsigned long long) {
  const uint32_t k = pos >> 5, s = pos & 31u;
  const unsigned long long lo =
      static_cast<unsigned long long>(ms.word(k)) |
      (static_cast<unsigned long long>(ms.word(k + 1)) << 32);
  return s ? (lo >> s) |
                 (static_cast<unsigned long long>(ms.word(k + 2)) << (64u - s))
           : lo;
}

// Two adjacent samples, stored as one 8- or 16-byte word.
__device__ __forceinline__ void store2(uint32_t* o, uint32_t a, uint32_t b) {
  *reinterpret_cast<uint2*>(o) = make_uint2(a, b);
}
__device__ __forceinline__ void store2(unsigned long long* o,
                                       unsigned long long a,
                                       unsigned long long b) {
  *reinterpret_cast<ulonglong2*>(o) = make_ulonglong2(a, b);
}

// MagSgn of quad rows [0, rows) (decoder32.cpp:1089-1316, the JAX
// package's _step2), one quad per lane; writes rows [0, 2 * rows) of
// out and returns the warp's error flag.  scr_a / scr_b: two rows of
// qw + 2 samples for the exponents of the row above.  B = 64: decoder64's
// samples, up to 64 MagSgn bits each.
template <int B, class Ms>
__device__ __forceinline__ bool phase2(Ms& ms, const uint32_t* quad,
                                       typename Width<B>::T* scr_a,
                                       typename Width<B>::T* scr_b,
                                       int rows, int qw, int width,
                                       int height, uint32_t p,
                                       typename Width<B>::T* __restrict__ out,
                                       int lane) {
  using T = typename Width<B>::T;
  const uint32_t mmsbp2 = static_cast<uint32_t>(B) - p;
  const bool even = (width & 1) == 0;  // 8- or 16-byte stores of pairs
  bool err = false;
  uint32_t base = 0;  // MagSgn bits consumed by the quads before
  for (int r = 0; r < rows; ++r) {
    const bool initial = r == 0;
    const T* scr = (r & 1) ? scr_b : scr_a;
    T* newv = (r & 1) ? scr_a : scr_b;
    T carry = 0;  // v_n of sample 3 of the quad left of the chunk
    for (int c0 = 0; c0 < qw; c0 += 32) {
      const int qx = c0 + lane;
      const bool active = qx < qw;
      const uint32_t rec = active ? quad[r * qw + qx] : 0u;
      const uint32_t q_inf = rec & 0xFFFFu;
      uint32_t U_q = rec >> 16;
      if (!initial && active) {
        uint32_t gamma = q_inf & 0xF0u;
        gamma &= gamma - 0x10u;
        const uint32_t emax = static_cast<uint32_t>(B - 1) -
                              static_cast<uint32_t>(
                                  clz_t(scr[qx] | scr[qx + 1] | T(2)));
        U_q += gamma != 0u ? emax : 1u;
      }
      if (active && U_q > mmsbp2) err = true;
      const bool two_cols = 2 * qx + 1 < width;
      int m[4];
      uint32_t sig = 0;
      int tot = 0;
#pragma unroll
      for (int bit = 0; bit < 4; ++bit) {
        const bool s = ((q_inf >> (4 + bit)) & 1u) != 0u &&
                       (bit < 2 || two_cols);
        m[bit] = s ? clampi(static_cast<int>(U_q - ((q_inf >> (12 + bit)) &
                                                    1u)), 0, B - 1)
                   : 0;
        sig |= static_cast<uint32_t>(s) << bit;
        tot += m[bit];
      }
      const int incl = warp_incl_scan(tot, lane);
      const uint32_t ctot =
          static_cast<uint32_t>(__shfl_sync(kFull, incl, 31));
      ms.ensure(base + ctot + static_cast<uint32_t>(B), lane);
      uint32_t pos = base + static_cast<uint32_t>(incl - tot);
      T val[4], vn1 = 0, vn3 = 0;
#pragma unroll
      for (int bit = 0; bit < 4; ++bit) {
        T v_n = 0;
        val[bit] = 0;
        if ((sig >> bit) & 1u) {
          const T win = ms_window(ms, pos, T(0));
          const uint32_t mn = static_cast<uint32_t>(m[bit]);
          v_n = (win & lowmask_t(T(0), mn)) |
                (static_cast<T>((q_inf >> (8 + bit)) & 1u) << mn) | T(1);
          val[bit] = (win << (B - 1)) | shl_t(v_n + T(2), p - 1u);
        }
        pos += static_cast<uint32_t>(m[bit]);
        if (bit == 1) vn1 = v_n;
        if (bit == 3) vn3 = v_n;
      }
      if (active) {
        // samples (2qx, 2r) (2qx, 2r+1) (2qx+1, 2r) (2qx+1, 2r+1)
        const bool low = 2 * r + 1 < height;
        T* o = out + (2 * r) * width + 2 * qx;
        if (even) {
          store2(o, val[0], val[2]);
          if (low) store2(o + width, val[1], val[3]);
        } else {
          o[0] = val[0];
          if (low) o[width] = val[1];
          if (two_cols) {
            o[1] = val[2];
            if (low) o[width + 1] = val[3];
          }
        }
      }
      // the next row's exponents: newv[qx] = v_n3(qx - 1) | v_n1(qx)
      T left = __shfl_up_sync(kFull, vn3, 1);
      if (lane == 0) left = carry;
      if (active) newv[qx] = left | vn1;
      if (qx == qw - 1) newv[qw] = vn3;
      carry = __shfl_sync(kFull, vn3, 31);
      base += ctot;
    }
    __syncwarp();
  }
  return __any_sync(kFull, err);
}

// ---- the kernel ----

struct Args {
  // dense mode
  const uint32_t* mel;
  const uint32_t* vlc;
  const uint32_t* ms;
  int wm, wv, ws;
  // raw mode
  const uint8_t* blob;
  long long blob_bytes;
  const int32_t* lane_off;
  const int32_t* ms_n;
  const int32_t* sh_n;
  // both
  const int32_t* p;
  const int32_t* qhl;
  const uint32_t* tables;
  void* dec;
  uint8_t* err;
  int n, width, height;
};

// shared words per codeblock: MEL and VLC words, the quads' inf | u
// (at B = 64 rounded up to an even count, so that the 8-byte exponent
// rows after them are aligned), two exponent rows of samples and (raw)
// the MagSgn ring
template <int B>
__host__ __device__ inline int quad_words(int width, int height) {
  const int q = ((width + 1) >> 1) * ((height + 1) >> 1);
  return B == 64 ? (q + 1) & ~1 : q;
}

template <int B>
__host__ __device__ inline int warp_words(int width, int height, bool raw) {
  const int qw = (width + 1) >> 1;
  return 2 * kSuffixWords + quad_words<B>(width, height) +
         2 * (qw + 2) * (B / 32) + (raw ? Width<B>::kRing : 0);
}

// Dense mode, phase 0: the row's words below min(last, kSuffixWords)
// into shared memory.
__device__ __forceinline__ WordSrc dense_src(const uint32_t* row,
                                             int nwords, uint32_t* sh,
                                             int lane) {
  const int last = nwords - 1;
  const int lim = last < kSuffixWords ? last : kSuffixWords;
#pragma unroll 8
  for (int i = lane; i < lim; i += 32) sh[i] = __ldg(row + i);
  return WordSrc{sh, row, lim, last, __ldg(row + last)};
}

// Raw mode, phase 0: the n suffix bytes at b unstuffed into shared
// memory, MEL forward into mel, VLC backward from b[n-1] into vlc, the
// two streams in the same batches; past a stream, its fill (MEL: ones,
// VLC: zeros).
__device__ __forceinline__ void raw_srcs(const uint8_t* b, int n,
                                         uint32_t* mel, uint32_t* vlc,
                                         int lane, WordSrc& melw,
                                         WordSrc& vlcw) {
  const int nw = ((n + 127) & ~127) >> 2;  // bits of whole batches / 32
  for (int i = lane; i < nw; i += 32) mel[i] = vlc[i] = 0u;
  __syncwarp();
  uint32_t mc = 0, vc = 0, mbits = 0, vbits = 0;
  for (int j0 = 0; j0 < n; j0 += 128) {
    mbits += unstuff128<kMel>(b, j0, n, mc, mel, kFull, mbits, lane);
    vbits += unstuff128<kVlc>(b + n - 1, j0, n, vc, vlc, kFull, vbits,
                              lane);
  }
  __syncwarp();
  if (lane == 0 && (mbits & 31u)) mel[mbits >> 5] |= ~lowmask(mbits & 31u);
  const int mlim = static_cast<int>((mbits + 31u) >> 5);
  const int vlim = static_cast<int>((vbits + 31u) >> 5);
  melw = WordSrc{mel, nullptr, mlim, mlim, 0xFFFFFFFFu};
  vlcw = WordSrc{vlc, nullptr, vlim, vlim, 0u};
}

template <bool RAW, int B>
__global__ void ht_cleanup_kernel(const Args a) {
  using T = typename Width<B>::T;
  constexpr int kTables = Width<B>::kTables;
  extern __shared__ uint32_t smem[];
  {
    // the tables, 16 bytes a thread (both sides are 16-byte aligned)
    const uint4* t = reinterpret_cast<const uint4*>(a.tables);
    uint4* s = reinterpret_cast<uint4*>(smem);
#pragma unroll 4
    for (int i = threadIdx.x; i < kTables / 4; i += blockDim.x)
      s[i] = __ldg(t + i);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cb = blockIdx.x * (blockDim.x >> 5) + warp;
  if (cb >= a.n) return;
  const int qw = (a.width + 1) >> 1;
  const int qh = (a.height + 1) >> 1;
  uint32_t* mel_sh =
      smem + kTables + warp * warp_words<B>(a.width, a.height, RAW);
  uint32_t* vlc_sh = mel_sh + kSuffixWords;
  uint32_t* quad = vlc_sh + kSuffixWords;
  T* scr_a = reinterpret_cast<T*>(quad + quad_words<B>(a.width, a.height));
  T* scr_b = scr_a + qw + 2;
  uint32_t* ring = reinterpret_cast<uint32_t*>(scr_b + qw + 2);
  T* out = static_cast<T*>(a.dec) +
           static_cast<size_t>(cb) * a.height * a.width;
  const uint32_t p = static_cast<uint32_t>(a.p[cb]);
  const int qhl = a.qhl[cb];
  int rows = qhl < qh ? (qhl > 0 ? qhl : 0) : qh;
  const uint32_t* vlc_tbl = smem;
  const uint32_t* uvlc_tbl = smem + kVlcEntries;
  const uint32_t* bias_tbl = smem + kTableWords;
  bool err = false;
  if (B == 64 && static_cast<int>(p) < 1) {
    // missing_msbs >= 62: "64 bits insufficient" (decoder64)
    err = true;
    rows = 0;
  }
  if (RAW) {
    const long long off = a.lane_off[cb];
    const int msn = a.ms_n[cb], shn = a.sh_n[cb];
    if (off < 0 || msn < 0 || shn < 1 || shn > kMaxSuffix ||
        off + msn + shn > a.blob_bytes) {
      // a byte range outside the blob: zeros, flagged
      err = true;
      rows = 0;
    } else if (rows > 0) {
      const uint8_t* b = a.blob + off;
      WordSrc melw, vlcw;
      raw_srcs(b + msn, shn, mel_sh, vlc_sh, lane, melw, vlcw);
      __syncwarp();
      if (OJK_STOP_AFTER >= 1 && lane == 0) {
        Reader mel, vlc;
        mel.init(melw);
        vlc.init(vlcw);
        phase1<B>(mel, vlc, vlc_tbl, uvlc_tbl, bias_tbl, rows, qw, quad);
      }
      __syncwarp();
      RingMs<Width<B>::kRing> ms{b, msn, 0, 0u, 0u, ring};
      if (OJK_STOP_AFTER >= 2)
        err = phase2<B>(ms, quad, scr_a, scr_b, rows, qw, a.width, a.height,
                        p, out, lane);
    }
  } else if (rows > 0) {
    const size_t i = static_cast<size_t>(cb);
    const WordSrc melw = dense_src(a.mel + i * a.wm, a.wm, mel_sh, lane);
    const WordSrc vlcw = dense_src(a.vlc + i * a.wv, a.wv, vlc_sh, lane);
    __syncwarp();
    if (OJK_STOP_AFTER >= 1 && lane == 0) {
      Reader mel, vlc;
      mel.init(melw);
      vlc.init(vlcw);
      phase1<B>(mel, vlc, vlc_tbl, uvlc_tbl, bias_tbl, rows, qw, quad);
    }
    __syncwarp();
    DenseMs ms{a.ms + i * a.ws, static_cast<uint32_t>(a.ws - 1)};
    if (OJK_STOP_AFTER >= 2)
      err = phase2<B>(ms, quad, scr_a, scr_b, rows, qw, a.width, a.height,
                      p, out, lane);
  }
  // rows at or past 2 * rows: zeros (counted in 4-byte words)
  constexpr int kWords = B / 32;
  uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
  const int start = 2 * rows * a.width * kWords;
  const int total = a.height * a.width * kWords;
  if (((start | total) & 3) == 0) {
    uint4* o = reinterpret_cast<uint4*>(o32);
    for (int i = (start >> 2) + lane; i < (total >> 2); i += 32)
      o[i] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int i = start + lane; i < total; i += 32) o32[i] = 0u;
  }
  if (lane == 0) a.err[cb] = err ? 1 : 0;
}

// ---- launch ----

template <bool RAW, int B>
int launch(const Args& a, int per_block, cudaStream_t stream) {
  if (a.n <= 0) return static_cast<int>(cudaGetLastError());
  if (a.width < 1 || a.height < 1 ||
      (!RAW && (a.wm < 1 || a.wv < 1 || a.ws < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t per_warp =
      static_cast<size_t>(warp_words<B>(a.width, a.height, RAW)) * 4;
  const size_t tables = static_cast<size_t>(Width<B>::kTables) * 4;
  int k = per_block > 0 ? (per_block < 32 ? per_block : 32) : 1;
  while (k > 1 && tables + k * per_warp > static_cast<size_t>(optin)) --k;
  const size_t smem = tables + k * per_warp;
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(ht_cleanup_kernel<RAW, B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (a.n + k - 1) / k;
  ht_cleanup_kernel<RAW, B><<<grid, 32 * k, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ojk

namespace ojk {

template <int B>
int dense_entry(const void* mel, const void* vlc, const void* ms, int wm,
                int wv, int ws, const void* p, const void* qhl,
                const void* tables, void* dec, void* err, int n, int width,
                int height, int per_block, void* stream) {
  Args a{};
  a.mel = static_cast<const uint32_t*>(mel);
  a.vlc = static_cast<const uint32_t*>(vlc);
  a.ms = static_cast<const uint32_t*>(ms);
  a.wm = wm;
  a.wv = wv;
  a.ws = ws;
  a.p = static_cast<const int32_t*>(p);
  a.qhl = static_cast<const int32_t*>(qhl);
  a.tables = static_cast<const uint32_t*>(tables);
  a.dec = dec;
  a.err = static_cast<uint8_t*>(err);
  a.n = n;
  a.width = width;
  a.height = height;
  return launch<false, B>(a, per_block, static_cast<cudaStream_t>(stream));
}

template <int B>
int raw_entry(const void* blob, long long blob_bytes, const void* lane_off,
              const void* ms_n, const void* sh_n, const void* p,
              const void* qhl, const void* tables, void* dec, void* err,
              int n, int width, int height, int per_block, void* stream) {
  Args a{};
  a.blob = static_cast<const uint8_t*>(blob);
  a.blob_bytes = blob_bytes;
  a.lane_off = static_cast<const int32_t*>(lane_off);
  a.ms_n = static_cast<const int32_t*>(ms_n);
  a.sh_n = static_cast<const int32_t*>(sh_n);
  a.p = static_cast<const int32_t*>(p);
  a.qhl = static_cast<const int32_t*>(qhl);
  a.tables = static_cast<const uint32_t*>(tables);
  a.dec = dec;
  a.err = static_cast<uint8_t*>(err);
  a.n = n;
  a.width = width;
  a.height = height;
  return launch<true, B>(a, per_block, static_cast<cudaStream_t>(stream));
}

}  // namespace ojk

extern "C" {

// Dense mode: mel/vlc/ms [n, wm|wv|ws] uint32 rows; per_block codeblocks
// (warps) per CUDA block; tables: dec_vlc0|1, dec_uvlc0|1.  Returns the
// CUDA error code of the launch (0 on success).
int ht_cleanup_decode_dense(const void* mel, const void* vlc, const void* ms,
                            int wm, int wv, int ws, const void* p,
                            const void* qhl, const void* tables, void* dec,
                            void* err, int n, int width, int height,
                            int per_block, void* stream) {
  return ojk::dense_entry<32>(mel, vlc, ms, wm, wv, ws, p, qhl, tables, dec,
                              err, n, width, height, per_block, stream);
}

// Raw mode: blob [blob_bytes] uint8; lane_off / ms_n / sh_n [n] int32.
int ht_cleanup_decode_raw(const void* blob, long long blob_bytes,
                          const void* lane_off, const void* ms_n,
                          const void* sh_n, const void* p, const void* qhl,
                          const void* tables, void* dec, void* err, int n,
                          int width, int height, int per_block,
                          void* stream) {
  return ojk::raw_entry<32>(blob, blob_bytes, lane_off, ms_n, sh_n, p, qhl,
                            tables, dec, err, n, width, height, per_block,
                            stream);
}

// The 64-bit instantiations: dec [n, height, width] uint64, p = 62 -
// missing_msbs, tables dec_vlc0|1, dec_uvlc0|1, dec_uvlc0_bias; the other
// arguments as above.
int ht_cleanup_decode_dense64(const void* mel, const void* vlc,
                              const void* ms, int wm, int wv, int ws,
                              const void* p, const void* qhl,
                              const void* tables, void* dec, void* err, int n,
                              int width, int height, int per_block,
                              void* stream) {
  return ojk::dense_entry<64>(mel, vlc, ms, wm, wv, ws, p, qhl, tables, dec,
                              err, n, width, height, per_block, stream);
}

int ht_cleanup_decode_raw64(const void* blob, long long blob_bytes,
                            const void* lane_off, const void* ms_n,
                            const void* sh_n, const void* p, const void* qhl,
                            const void* tables, void* dec, void* err, int n,
                            int width, int height, int per_block,
                            void* stream) {
  return ojk::raw_entry<64>(blob, blob_bytes, lane_off, ms_n, sh_n, p, qhl,
                            tables, dec, err, n, width, height, per_block,
                            stream);
}

}  // extern "C"
