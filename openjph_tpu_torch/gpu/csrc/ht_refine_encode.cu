// HT refinement passes (SigProp and MagRef) of a multi-pass codeblock,
// encode side, for Hopper (sm_90a): K5.
//
// No TPU kernel is behind it.  The JAX package codes these passes on its
// host, one codeblock at a time, in Python:
// openjph_tpu/coding/encoder.py::encode_spp_mrp (called from
// openjph_tpu/codec.py, the scalar Encoder, for ht_passes 2 and 3).
// Semantics are those of its plain version,
// gpu/block_refine_encode.py::encode_refine_core: per lane, the samples
// (uint32 sign-magnitude, sign in bit 31, the batch the cleanup encoder
// takes), the cleanup's LSB plane p (30 - missing_msbs; the passes code
// plane p - 1), the lane's true height h_lim and its pass count npasses
// (below 2: no segment; 2: SigProp; 3: SigProp and MagRef); one causal
// flag (the stripe-causal COD mode) for the launch.  Out: each lane's
// refinement segment, the SigProp bytes (forward, MagSgn stuffing, zero
// fill, no 0xFF tail: _SppEncoder) then the MagRef bytes (the VLC
// stuffing rule with last_greater_than_8F starting true, reversed into
// file order: _MrpEncoder), as cap words a lane with every word past the
// segment zero; both byte counts; an overflow flag (segment longer than
// cap words, its bytes past the cap dropped).
//
// What bounds it.  Not bytes: the 2048x1080 gray frame's 608 lanes read
// 8.9 MB of samples and write 0.14 MB of segments, under 3 microseconds
// of HBM time.  A frame fills ~5 warps of an SM's 64, so the time is one
// codeblock's critical path, and three parts of it are serial in the
// coder: SigProp's chain (a group's candidates depend on the new
// significance to its left and in the stripe above) and both packers'
// stuffing (where a byte starts depends on the byte before).  The design
// turns each into a warp scan of transfer functions over 16 states, and
// keeps the loads in flight.
//
// Design: two warps per codeblock, PER_BLOCK codeblocks a CUDA block, each
// codeblock with its own shared memory.
//   Phase A (the warps, a 4x4 group a lane, two groups at a time): the
//     group's four rows read as 16-byte vectors, 8 loads in flight a
//     lane; per group three 16-bit words (bit 4*col + row,
//     block_refine.sig_pack's layout): its cleanup significance (mag >> p
//     != 0), its plane p - 1 bits and its signs.
//   Phase C (SigProp's decisions, serial over stripes, a scan over a
//     stripe's columns).  Inside a stripe a column passes to the next only
//     the 4-bit vertical spread of its new significance; everything else
//     it needs (the candidates from the cleanup significance of its
//     neighbours and the rows above and below, the stripe above's final
//     bottom row, its plane bits) is known when the stripe starts.  A
//     column is then a map of the 16 incoming spreads, a 4-row walk:
//     new_r = bit_r & inv_r & (cand_r | in_r | new_(r-1)), out = new
//     spread vertically.  The map is OR-affine (f(x) = f(0) | OR over the
//     bits j of x of f(e_j)), so one 20-bit word holds it (nibble j =
//     f(e_j), nibble 4 = f(0)) and two compose with four masked ORs.  A
//     lane owns consecutive groups, walks their columns once on the five
//     packed states to get its map, the warp scans the maps (only over
//     the lanes that own groups: none on a stripe of one group), and each
//     lane replays its columns from its true incoming spread, storing
//     each group's visited and new masks.
//   Phase B (the records): each group's SigProp record (its plane bits at
//     the visited positions, then its signs at the new ones, in position
//     order) and MagRef record (its plane bits at the cleanup-significant
//     positions); a lane takes consecutive groups, a warp scan of their
//     lengths places the bits, ORed into shared words (unstuffed,
//     LSB-first).
//   Phase D (the packers).  The state entering a 64-bit chunk of the
//     unstuffed stream is the offset of its first byte (0-7) and a flag of
//     the byte before it (SigProp: it was 0xFF; MagRef: it was above 0x8F,
//     true at the start), 16 states.  A lane takes each of its chunks' 16
//     states to the next chunk (a nibble table each, composed), stepping
//     from stuffing event to stuffing event found in bit masks of the
//     chunk's window rather than a byte at a time; the warp scans the
//     tables, and each lane replays its chunks from its true state twice,
//     a byte at a time: to count its bytes (a warp scan places them) and
//     to store them.
//   Warp 0 runs SigProp's phases C, B and D; MagRef's B and D depend on
//   phase A alone and run on warp 1 beside them.
//   Phase E (the warps): the segment written coalesced, a word a lane, the
//     MagRef bytes read back to front; the counts and the flag.
// The kernel launches on the caller's stream and allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace ojre {

constexpr unsigned kFull = 0xFFFFFFFFu;
// the most threads a CUDA block takes: 4 codeblocks of two warps
constexpr int kMaxThreads = 256;
// 4x4 groups a lane reads at once in phase A (four 16-byte loads each;
// four groups would hold 64 registers and spill under the bound below)
constexpr int kGroupsInFlight = 2;
// the identity of each map kind: the OR-affine map of the incoming
// spreads (nibble j for e_j, nibble 4 for 0), and a packer's state table
constexpr uint32_t kSpreadId = 0x08421u;
constexpr unsigned long long kStateId = 0xFEDCBA9876543210ull;

struct Args {
  const uint32_t* buf;
  const int32_t* p;
  const int32_t* h_lim;
  const int32_t* npasses;
  uint32_t* out;
  int32_t* lens;
  uint8_t* ovf;
  int hp, wp, cap, n, width, height, causal;
};

// A codeblock's shared memory, in 32-bit words, and where each part sits.
// sig and vn rows have a zero column on each side (stride n_gx + 2, the
// group at +1), and sig a zero row below, for the neighbour reads.
struct Layout {
  int n_sy, n_gx, stride;
  int sig, bs, vn, spp_w, mrp_w, spp_b, mrp_b, counts;  // word offsets
  int spp_cap, mrp_cap;  // bytes
  int words;             // total
};

__host__ __device__ inline Layout layout(int width, int height) {
  Layout l;
  l.n_sy = (height + 3) >> 2;
  l.n_gx = (width + 3) >> 2;
  l.stride = l.n_gx + 2;
  const int samples = width * height;
  // stuffed bytes: at least 7 bits a byte, plus the partial last
  l.spp_cap = (2 * samples + 6) / 7 + 2;
  l.mrp_cap = (samples + 6) / 7 + 2;
  l.sig = 0;                                    // cleanup significance
  l.bs = l.sig + (l.n_sy + 1) * l.stride;       // plane bits | signs << 16
  l.vn = l.bs + l.n_sy * l.n_gx;                // visited | new << 16
  // unstuffed bits: SigProp at most two a sample, MagRef one; two spare
  // words each for a chunk's window
  l.spp_w = l.vn + l.n_sy * l.stride;
  l.mrp_w = l.spp_w + (2 * samples + 31) / 32 + 2;
  l.spp_b = l.mrp_w + (samples + 31) / 32 + 2;
  l.mrp_b = l.spp_b + (l.spp_cap + 3) / 4;
  l.counts = l.mrp_b + (l.mrp_cap + 3) / 4;  // both byte counts
  l.words = l.counts + 2;
  return l;
}

// ---- the warp scan, and the maps it composes ------------------------------

// Inclusive scan over lanes 0..live-1 (live is the same on every lane;
// what lanes at or past it get is not read): lane i gets x_0 . x_1 ...
// x_i, op(a, b) being a then b.
template <class T, class Op>
__device__ __forceinline__ T warp_scan(T x, int live, int lane, Op op) {
  for (int o = 1; o < live; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = op(y, x);
  }
  return x;
}

struct Add {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// OR-affine maps of a 4-bit spread: f then g.  Nibble k of the result is
// g(f_k) = g(0) | OR over the bits j of f_k of g(e_j).
struct SpreadThen {
  __device__ uint32_t operator()(uint32_t f, uint32_t g) const {
    uint32_t r = ((g >> 16) & 0xFu) * 0x11111u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r |= (((f >> j) & 0x11111u) * 0xFu) & (((g >> (4 * j)) & 0xFu) *
                                             0x11111u);
    return r;
  }
};

// 16-state tables (nibble s the state s goes to): f then g, on 32-bit
// halves.
struct StateThen {
  __device__ unsigned long long operator()(unsigned long long f,
                                           unsigned long long g) const {
    const uint32_t f2[2] = {static_cast<uint32_t>(f),
                            static_cast<uint32_t>(f >> 32)};
    const uint32_t glo = static_cast<uint32_t>(g);
    const uint32_t ghi = static_cast<uint32_t>(g >> 32);
    uint32_t r2[2] = {0u, 0u};
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const uint32_t m = (f2[s >> 3] >> (4 * (s & 7))) & 0xFu;
      r2[s >> 3] |= (((m & 8u) ? ghi : glo) >> (4 * (m & 7u)) & 0xFu)
                    << (4 * (s & 7));
    }
    return (static_cast<unsigned long long>(r2[1]) << 32) | r2[0];
  }
};

// ---- SigProp's decisions ----------------------------------------------------

// What a group's columns need before the chain reaches them, nibble i for
// its column i: the candidates from everything but the new significance
// of this stripe to the left and above in the column (cleanup
// significance of the columns beside it spread vertically, the stripe
// above's final bottom row, the stripe below's cleanup top row unless
// causal), the positions the pass may visit (inv) and those of them whose
// plane bit is 1 (a).
struct GroupIn {
  uint32_t c, inv, a;
};

// three neighbouring groups' 16-bit words as 24 bits, columns -1..4
__device__ __forceinline__ uint32_t cols6(uint32_t l, uint32_t m,
                                          uint32_t r) {
  return (l >> 12) | (m << 4) | ((r & 0xFu) << 20);
}

__device__ __forceinline__ GroupIn group_in(const uint32_t* sig,
                                            const uint32_t* bs,
                                            const uint32_t* vn,
                                            const Layout& L, int sy, int g,
                                            uint32_t pattern0, int width,
                                            bool causal) {
  const int S = L.stride;
  const uint32_t* cr = sig + sy * S + 1 + g;
  const uint32_t cs = cr[0];
  const uint32_t cs24 = cols6(cr[-1], cs, cr[1]);
  uint32_t u24 = 0;
  if (sy > 0) {  // the stripe above's final significance, cleanup | new
    const uint32_t* pr = cr - S;
    const uint32_t* pv = vn + (sy - 1) * S + 1 + g;
    u24 = (cols6(pr[-1] | (pv[-1] >> 16), pr[0] | (pv[0] >> 16),
                 pr[1] | (pv[1] >> 16)) & 0x888888u) >> 3;
  }
  if (!causal) {
    const uint32_t* nr = cr + S;
    u24 |= (cols6(nr[-1], nr[0], nr[1]) & 0x111111u) << 3;
  }
  const uint32_t m24 = cs24 | ((cs24 & 0x777777u) << 1) |
                       ((cs24 & 0xEEEEEEu) >> 1) | u24;
  GroupIn r;
  r.c = ((m24 | (m24 << 4) | (m24 >> 4)) >> 4) & 0xFFFFu;
  const int over = 4 * g + 4 - width;
  const uint32_t pattern = over > 0 ? pattern0 >> (4 * over) : pattern0;
  r.inv = ~cs & pattern & 0xFFFFu;
  r.a = r.inv & bs[sy * L.n_gx + g];
  return r;
}

// The group's columns applied to five packed spreads at once (nibble k of
// st each): st = a lane's map so far, returned extended by this group.
// Two fill steps, not three: a row the third would add lies below one the
// second added, whose spread already covers it and the row above.
__device__ __forceinline__ uint32_t walk5(uint32_t st, const GroupIn& gi) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = ((gi.a >> (4 * i)) & 0xFu) * 0x11111u;
    const uint32_t a1 = a & 0xEEEEEu;
    uint32_t s = a & ((((gi.c >> (4 * i)) & 0xFu) * 0x11111u) | st);
    s |= (s << 1) & a1;
    s |= (s << 1) & a1;
    st = s | ((s & 0x77777u) << 1) | ((s & 0xEEEEEu) >> 1);
  }
  return st;
}

// The group's columns from the true incoming spread: its visited and new
// masks; returns the spread it passes on.
__device__ __forceinline__ uint32_t walk(uint32_t in, const GroupIn& gi,
                                         uint32_t& vis, uint32_t& nw) {
  vis = nw = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t c = (gi.c >> (4 * i)) & 0xFu;
    const uint32_t a = (gi.a >> (4 * i)) & 0xFu;
    uint32_t s = a & (c | in);
    s |= (s << 1) & a;
    s |= (s << 1) & a;
    s |= (s << 1) & a;
    vis |= ((gi.inv >> (4 * i)) & (c | in | (s << 1)) & 0xFu) << (4 * i);
    nw |= s << (4 * i);
    in = (s | (s << 1) | (s >> 1)) & 0xFu;
  }
  return in;
}

// ---- bits into shared words -------------------------------------------------

// The bits of v at the set bits of m (16 wide), gathered from bit 0 in
// bit order, without a branch: four rounds of moving each bit right by
// its count of unset mask bits below it, one bit of that count a round
// (Hacker's Delight, 7-4).
__device__ __forceinline__ uint32_t pext16(uint32_t v, uint32_t m) {
  v &= m;
  uint32_t mk = ~m << 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t mp = mk ^ (mk << 1);
    mp ^= mp << 2;
    mp ^= mp << 4;
    mp ^= mp << 8;
    const uint32_t mv = mp & m;
    m = (m ^ mv) | (mv >> (1 << i));
    const uint32_t t = v & mv;
    v = (v ^ t) | (t >> (1 << i));
    mk &= ~mp;
  }
  return v;
}

// len (<= 32) bits of val at bit pos of LSB-first shared words
__device__ __forceinline__ void put(uint32_t* w, int pos, uint32_t val,
                                    int len) {
  if (len == 0) return;
  const int sh = pos & 31;
  atomicOr(&w[pos >> 5], val << sh);
  if (sh + len > 32) atomicOr(&w[(pos >> 5) + 1], val >> (32 - sh));
}

// ---- the packers ------------------------------------------------------------

// Bits [64c, 64c + 96) of an LSB-first stream (zero past its end).
struct Window {
  uint32_t w0, w1, w2;
  __device__ Window(const uint32_t* w, int c)
      : w0(w[2 * c]), w1(w[2 * c + 1]), w2(w[2 * c + 2]) {}
  __device__ uint32_t byte(int q) const {  // 0 <= q < 64
    return __funnelshift_r(q < 32 ? w0 : w1, q < 32 ? w1 : w2, q) & 0xFFu;
  }
  __device__ unsigned long long lo() const {
    return (static_cast<unsigned long long>(w1) << 32) | w0;
  }
  // bit q of the result is the window's bit q + k, for q < 64 (0 < k < 32)
  __device__ unsigned long long shr(int k) const {
    return (lo() >> k) | (static_cast<unsigned long long>(w2) << (64 - k));
  }
};

// One byte of the stuffing rule at chunk offset q with the flag f of the
// byte before; advances q by 7 or 8 and sets f for the next byte.
__device__ __forceinline__ uint32_t stuff_byte(const Window& win, bool mrp,
                                               int& q, bool& f) {
  uint32_t b = win.byte(q);
  const bool seven = mrp ? (f && (b & 0x7Fu) == 0x7Fu) : f;
  if (seven) b &= 0x7Fu;
  f = mrp ? b > 0x8Fu : b == 0xFFu;
  q += seven ? 7 : 8;
  return b;
}

constexpr unsigned long long kEvery8 = 0x0101010101010101ull;

// A chunk's table: each state s (offset s & 7, flag s >> 3) taken to where
// the next chunk starts.  A byte takes 7 bits only at a stuffing event,
// so a walk steps along its offsets mod 8 from event to event, found in
// bit masks of the window: SigProp's events are the 0xFF bytes (ff: the
// positions whose next 8 bits are ones; the byte after takes 7 bits),
// MagRef's the bytes above 0x8F whose next byte would be 7 ones (ev), and
// the first byte where the flag enters set and 7 ones follow (r7).  The
// stream's last chunk maps as if zeros followed it: no byte follows its
// end.
__device__ unsigned long long chunk_map(const Window& win, bool mrp) {
  unsigned long long r7 = win.lo();  // positions whose next 7 bits are ones
#pragma unroll
  for (int k = 1; k < 7; ++k) r7 &= win.shr(k);
  const unsigned long long ff = r7 & win.shr(7);  // SigProp: 0xFF bytes
  // MagRef: a byte above 0x8F (bit 7 and one of bits 4-6), 7 ones after
  const unsigned long long gt =
      win.shr(7) & (win.shr(4) | win.shr(5) | win.shr(6));
  const unsigned long long ev = mrp ? gt & (r7 >> 8) : ff;
  uint32_t r2[2] = {0u, 0u};
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    int q = s & 7;
    bool f = false;
    if (s >= 8 && (!mrp || ((r7 >> q) & 1ull))) q += 7;  // a 7-bit byte
    while (q < 64) {
      const unsigned long long at = ev & (kEvery8 << (q & 7)) & (~0ull << q);
      if (!at) {  // bytes 8 bits apart to the chunk's end
        f = mrp && ((gt >> (56 + (q & 7))) & 1ull);
        q = 64 + (q & 7);
        break;
      }
      const int e = __ffsll(static_cast<long long>(at)) - 1;
      if (!mrp && e >= 56) {  // the 7-bit byte after it is the next chunk's
        q = e + 8;
        f = true;
        break;
      }
      q = e + 15;  // the event's byte, then a 7-bit byte
    }
    r2[s >> 3] |= static_cast<uint32_t>((q - 64) | (f << 3)) << (4 * (s & 7));
  }
  return (static_cast<unsigned long long>(r2[1]) << 32) | r2[0];
}

// A chunk replayed from its true state (q, f), left at the next chunk's;
// its bytes stored from dst[at] (those at or past cap dropped) where
// ``store``.  Returns its byte count.
__device__ __forceinline__ int chunk_replay(const Window& win, int lim,
                                            bool mrp, int& q, bool& f,
                                            uint8_t* dst, int at, int cap,
                                            bool store) {
  int n = 0;
  while (q < lim) {
    const uint32_t b = stuff_byte(win, mrp, q, f);
    if (store && at + n < cap) dst[at + n] = static_cast<uint8_t>(b);
    ++n;
  }
  q -= 64;
  return n;
}

// The stuffed bytes of nbits LSB-first bits in w, in emission order, to
// dst (at most cap stored).  Returns the byte count, on every lane.
__device__ int pack(const uint32_t* w, int nbits, bool mrp, uint8_t* dst,
                    int cap, int lane) {
  if (nbits <= 0) return 0;
  const int nch = (nbits + 63) >> 6;
  const int per = (nch + 31) >> 5;
  const int live = (nch + per - 1) / per;
  const int c0 = lane * per;
  const int c1 = min(c0 + per, nch);
  unsigned long long map = kStateId;
  for (int c = c0; c < c1; ++c)
    map = StateThen()(map, chunk_map(Window(w, c), mrp));
  map = warp_scan(map, live, lane, StateThen());
  const unsigned long long before = __shfl_up_sync(kFull, map, 1);
  const int s0 = mrp ? 8 : 0;  // offset 0; MagRef's flag starts true
  const int s = lane == 0 ? s0 : static_cast<int>(before >> (4 * s0)) & 0xF;
  int q = s & 7, n = 0;
  bool f = s >> 3;
  for (int c = c0; c < c1; ++c)
    n += chunk_replay(Window(w, c), min(64, nbits - 64 * c), mrp, q, f,
                      dst, 0, 0, false);
  const int incl = warp_scan(n, 32, lane, Add());
  int at = incl - n;
  q = s & 7;
  f = s >> 3;
  for (int c = c0; c < c1; ++c)
    at += chunk_replay(Window(w, c), min(64, nbits - 64 * c), mrp, q, f,
                       dst, at, cap, true);
  return __shfl_sync(kFull, incl, 31);
}

// ---- the records ------------------------------------------------------------

// One stream's records placed by the warp: SigProp's (each group's plane
// bits at its visited positions, then its signs at its new ones) or
// MagRef's (its plane bits at its cleanup-significant positions), the
// groups in stripe, then column order, a lane taking consecutive groups.
// Returns the stream's bit count, on every lane.
__device__ int place(const uint32_t* sig, const uint32_t* bs,
                     const uint32_t* vn, const Layout& L, uint32_t* w,
                     bool mrp, int lane) {
  const int S = L.stride, n_gx = L.n_gx, ng = L.n_sy * n_gx;
  const int per = (ng + 31) >> 5;
  const int i0 = min(lane * per, ng);
  const int i1 = min(i0 + per, ng);
  const int sy0 = i0 / n_gx, gx0 = i0 - sy0 * n_gx;
  const uint32_t* src = mrp ? sig : vn;
  int len = 0;
  for (int i = i0, sy = sy0, g = gx0; i < i1; ++i) {
    len += __popc(src[sy * S + 1 + g]);
    if (++g == n_gx) g = 0, ++sy;
  }
  const int inc = warp_scan(len, 32, lane, Add());
  int pos = inc - len;
  for (int i = i0, sy = sy0, g = gx0; i < i1; ++i) {
    const uint32_t v = src[sy * S + 1 + g];
    const uint32_t b = bs[sy * n_gx + g];
    const uint32_t vis = v & 0xFFFFu;
    const uint32_t val =
        mrp ? pext16(b, v)
            : pext16(b, vis) | (pext16(b >> 16, v >> 16) << __popc(vis));
    const int n = __popc(v);
    put(w, pos, val, n);
    pos += n;
    if (++g == n_gx) g = 0, ++sy;
  }
  return __shfl_sync(kFull, inc, 31);
}

// ---- the kernel -------------------------------------------------------------

// (at most 85 registers: three blocks of 8 warps an SM)
__global__ void __launch_bounds__(kMaxThreads, 3)
    ht_refine_encode_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int pair = threadIdx.x >> 6;        // the codeblock in the block
  const int role = (threadIdx.x >> 5) & 1;  // warp 0: SigProp; 1: MagRef
  const int cb = blockIdx.x * (blockDim.x >> 6) + pair;
  const bool here = cb < a.n;  // the last block may hold fewer
  const Layout L = layout(a.width, a.height);
  uint32_t* s = smem + pair * L.words;
  uint32_t* sig = s + L.sig;
  uint32_t* bs = s + L.bs;
  uint32_t* vn = s + L.vn;
  uint32_t* spp_w = s + L.spp_w;
  uint32_t* mrp_w = s + L.mrp_w;
  uint8_t* spp_b = reinterpret_cast<uint8_t*>(s + L.spp_b);
  uint8_t* mrp_b = reinterpret_cast<uint8_t*>(s + L.mrp_b);
  int* counts = reinterpret_cast<int*>(s + L.counts);
  const int S = L.stride;
  const int n_gx = L.n_gx;
  const int ng = L.n_sy * n_gx;
  const int np = here ? a.npasses[cb] : 0;
  const bool do_spp = np >= 2, do_mrp = np >= 3;
  const int p = do_spp ? min(max(a.p[cb], 1), 31) : 1;
  const int h_lim = do_spp ? a.h_lim[cb] : 0;
  const int rows = min(h_lim, a.hp);
  int spp_n = 0, mrp_n = 0;

  // The warps meet at the block's barrier 0, every warp as often: a named
  // barrier a codeblock, its ID in a register, would reserve all 16 and
  // cap the blocks an SM holds.
  if (do_spp)
    for (int i = 32 * role + lane; i < L.spp_b; i += 64) s[i] = 0;
  __syncthreads();

  if (do_spp) {
    // ---- Phase A: three 16-bit words a group, loads in flight ----------
    const uint32_t* src = a.buf + static_cast<size_t>(cb) * a.hp * a.wp;
    constexpr int kStep = 32 * kGroupsInFlight;
    for (int base = kStep * role; base < ng; base += 2 * kStep) {
      uint4 v[kGroupsInFlight][4];
#pragma unroll
      for (int k = 0; k < kGroupsInFlight; ++k) {
        const int i = base + 32 * k + lane;
        const int sy = i / n_gx, g = i - sy * n_gx;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int y = 4 * sy + r;
          v[k][r] = i < ng && y < rows
                        ? __ldg(reinterpret_cast<const uint4*>(
                              src + static_cast<size_t>(y) * a.wp + 4 * g))
                        : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int k = 0; k < kGroupsInFlight; ++k) {
        const int i = base + 32 * k + lane;
        if (i >= ng) continue;
        const int sy = i / n_gx, g = i - sy * n_gx;
        const int cols = a.width - 4 * g;  // columns inside the block
        uint32_t sw = 0, bw = 0, gw = 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t x[4] = {v[k][r].x, v[k][r].y, v[k][r].z,
                                 v[k][r].w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t val = c < cols ? x[c] : 0u;
            const uint32_t mag = val & 0x7FFFFFFFu;
            const int at = 4 * c + r;
            sw |= static_cast<uint32_t>((mag >> p) != 0) << at;
            bw |= ((mag >> (p - 1)) & 1u) << at;
            gw |= (val >> 31) << at;
          }
        }
        sig[sy * S + 1 + g] = sw;
        bs[sy * n_gx + g] = bw | (gw << 16);
      }
    }
  }
  __syncthreads();

  if (do_spp) {
    if (role == 0) {
      // ---- Phase C: SigProp's decisions, a stripe at a time ------------
      const int gpl = (n_gx + 31) >> 5;  // groups a lane
      const int live = (n_gx + gpl - 1) / gpl;
      const int g0 = lane * gpl;
      const int g1 = min(g0 + gpl, n_gx);
      for (int sy = 0; sy < L.n_sy; ++sy) {
        const int rl = h_lim - 4 * sy;
        if (rl <= 0) break;
        const uint32_t pattern0 =
            rl >= 4 ? 0xFFFFu : rl == 3 ? 0x7777u : rl == 2 ? 0x3333u
                                                            : 0x1111u;
        // the lane's first group's inputs serve both passes (a lane owns
        // one group up to 128 columns)
        GroupIn first{0u, 0u, 0u};
        if (g0 < g1)
          first = group_in(sig, bs, vn, L, sy, g0, pattern0, a.width,
                           a.causal);
        uint32_t in = 0;  // the spread entering this lane's first group
        if (live > 1) {
          uint32_t map = walk5(kSpreadId, first);
          for (int g = g0 + 1; g < g1; ++g)
            map = walk5(map, group_in(sig, bs, vn, L, sy, g, pattern0,
                                      a.width, a.causal));
          map = warp_scan(map, live, lane, SpreadThen());
          const uint32_t before = __shfl_up_sync(kFull, map, 1);
          if (lane > 0) in = (before >> 16) & 0xFu;
        }
        for (int g = g0; g < g1; ++g) {
          uint32_t vis, nw;
          in = walk(in, g == g0 ? first
                                : group_in(sig, bs, vn, L, sy, g, pattern0,
                                           a.width, a.causal),
                    vis, nw);
          vn[sy * S + 1 + g] = vis | (nw << 16);
        }
        __syncwarp();
      }
      // ---- Phases B and D for SigProp ------------------------------------
      spp_n = place(sig, bs, vn, L, spp_w, false, lane);
      __syncwarp();
      spp_n = pack(spp_w, spp_n, false, spp_b, L.spp_cap, lane);
      if (lane == 0) counts[0] = spp_n;
    } else {
      // ---- Phases B and D for MagRef, beside SigProp -------------------
      if (do_mrp) {
        mrp_n = place(sig, bs, vn, L, mrp_w, true, lane);
        __syncwarp();
        mrp_n = pack(mrp_w, mrp_n, true, mrp_b, L.mrp_cap, lane);
      }
      if (lane == 0) counts[1] = mrp_n;
    }
  }
  __syncthreads();
  if (do_spp) {
    spp_n = counts[0];
    mrp_n = counts[1];
  }
  if (!here) return;

  // ---- Phase E: the segment, a word a lane -------------------------------
  const int total = spp_n + mrp_n;
  uint32_t* dst = a.out + static_cast<size_t>(cb) * a.cap;
  for (int j = 32 * role + lane; j < a.cap; j += 64) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * j + k;
      uint32_t b = 0;
      if (i < spp_n)
        b = i < L.spp_cap ? spp_b[i] : 0u;
      else if (i < total) {
        const int m = mrp_n - 1 - (i - spp_n);
        b = m < L.mrp_cap ? mrp_b[m] : 0u;
      }
      word |= b << (8 * k);
    }
    dst[j] = word;
  }
  if (role == 0 && lane == 0) {
    a.lens[2 * cb] = spp_n;
    a.lens[2 * cb + 1] = mrp_n;
    a.ovf[cb] = total > 4 * a.cap;
  }
}

}  // namespace ojre

extern "C" {

// buf [n, hp, wp] uint32 (hp >= height, wp >= width, wp a multiple of 4,
// 16-byte aligned: rows are read as 16-byte vectors); p, h_lim, npasses
// [n] int32; causal 0 / 1; out [n, cap] uint32 (every word is written);
// lens [n, 2] int32 (SigProp bytes, MagRef bytes); ovf [n] uint8.
// ``per_block``: codeblocks (pairs of warps) a CUDA block, clamped to
// [1, 4] and to the shared memory.  Returns the CUDA
// error code of the launch (0 on success).
int ht_refine_encode(const void* buf, int hp, int wp, const void* p,
                     const void* h_lim, const void* npasses, int causal,
                     void* out, int cap, void* lens, void* ovf, int n,
                     int width, int height, int per_block, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (width < 1 || height < 1 || hp < height || wp < width || cap < 0 ||
      wp % 4 != 0 || reinterpret_cast<uintptr_t>(buf) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ojre::Args a{};
  a.buf = static_cast<const uint32_t*>(buf);
  a.p = static_cast<const int32_t*>(p);
  a.h_lim = static_cast<const int32_t*>(h_lim);
  a.npasses = static_cast<const int32_t*>(npasses);
  a.out = static_cast<uint32_t*>(out);
  a.lens = static_cast<int32_t*>(lens);
  a.ovf = static_cast<uint8_t*>(ovf);
  a.hp = hp;
  a.wp = wp;
  a.cap = cap;
  a.n = n;
  a.width = width;
  a.height = height;
  a.causal = causal != 0;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t per_cb =
      static_cast<size_t>(ojre::layout(width, height).words) * 4;
  const int most = ojre::kMaxThreads / 64;
  int k = per_block > 0 ? (per_block < most ? per_block : most) : 1;
  while (k > 1 && k * per_cb > static_cast<size_t>(optin)) --k;
  const size_t smem = k * per_cb;
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  // all of an SM's shared memory for shared memory, whatever the block
  e = cudaFuncSetAttribute(ojre::ht_refine_encode_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(ojre::ht_refine_encode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (n + k - 1) / k;
  ojre::ht_refine_encode_kernel<<<grid, 64 * k, smem,
                                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
