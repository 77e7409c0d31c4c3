// HT cleanup-pass block encoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package,
// openjph_tpu/tpu/block_encode_pallas.py::_make_kernel (pallas_call in
// _run_encode_pallas, via encode_cleanup_pallas_cat).  Semantics are those
// of its plain version, gpu/block_encode.py::encode_cleanup_core: the
// per-pair arithmetic of tpu/block_encode.py::encode_cleanup_core
// (ojph_block_encoder.cpp:542-1017), the MEL run-length coder, and three
// dense LSB-first word streams per codeblock (MEL, VLC, MagSgn) with their
// bit counts and an overflow flag.  The host stuffer (native
// pack_from_dense) turns the words into the cleanup segment.  Lanes stop
// at their quad-row limit qhl.
//
// What bounds it.  Not bytes: the 2048x1080 gray frame's 604 lanes read
// 9.9 MB of samples and write 7.5 MB of words (most of them the zeros past
// the used prefixes), a few microseconds of HBM time.  The plain version is
// a serial walk over quad pairs, but in an encoder every sample is known
// before the walk starts, so every per-quad quantity is a function of the
// samples alone: the VLC context c_q (the row above's significance and the
// left quad's rho), max_e and kappa (the row above's bottom exponents),
// u_q, eps, the VLC tuple, the MagSgn bit counts and the pair's u codes.
// Only the MEL coder's state and the three streams' bit positions carry
// from quad to quad, and bit positions are prefix sums.  A frame has a few
// hundred codeblocks, a few warps an SM, so the time is the latency of one
// codeblock's rows, one after the other, on the longest lane.
//
// Design: one warp per codeblock encodes every quad of a row at once, quad
// rows r < qhl in order; a row wider than 32 quads is walked in chunks of
// 32 (a unit: chunk c of row r).  Each iteration encodes two units in
// stream order, their steps interleaved so that the two dependency chains
// overlap: rows r and r + 1 when a row is one chunk, else chunks c and c + 1
// of one row (the second absent past the last row or chunk).
//   Samples.  Lane i owns quad 32c + i and loads its 2x2 samples (two
//     8-byte loads; a 64-wide sample row is 64 consecutive words), one
//     iteration ahead.  It computes sig, e, MagSgn value and rho as the
//     plain version does.
//   Context.  A shared row of one word per quad holds the bottom samples'
//     exponents and significance of the row above (row r + 1 takes row r's
//     from registers); a lane reads its own entry and takes its
//     neighbours' by shuffle, the chunk's edges from the unit before and
//     the next entry.  The left quad's rho comes by __shfl_up.  From these:
//     c_q, max_e -> kappa, u_q, eps, the tuple (one shared read) and the
//     four MagSgn lengths m = uq - tuple bit (<= 31).  Row 0 has kappa = 1,
//     table offset 0, and c_q from the left quad only.
//   Pairs.  The even lane takes its partner's tuple, u_q and MEL event by
//     shuffle and builds the pair's VLC bits in stream order: tuple0,
//     tuple1, prefix0, prefix1 (or the 1-bit u_q1 - 1 of row 0's case b),
//     suffix0, suffix1; at most 30 bits (VLC <= 7, UVLC prefix <= 3,
//     suffix <= 5).  It also lists the pair's MEL events in order: quad
//     0's rho != 0 if c_q == 0, quad 1's likewise, and in row 0
//     min(u_q0, u_q1) > 2 when both are > 0.  All of it without branches.
//   Bit positions.  A warp scan of a packed word per unit (MagSgn bits of
//     the quad | VLC bits of the pair << 12 | MEL events << 21), the two
//     units' scans interleaved, gives every lane its MagSgn and VLC offsets
//     and its events' rank.  Lanes OR their bits into a shared ring of
//     words per stream (MagSgn 256 words, VLC 32), two ORs a piece, with
//     no branches (a piece of no bits goes to the lane's spare word); after
//     the iteration the words it completed are stored to global memory,
//     coalesced, dropped at or past the cap, and their slots zeroed.
//   MEL.  Three OR-reductions gather the iteration's events (at most 96)
//     into words, which lane 0 appends to a bit stream of events in shared
//     memory and publishes with a count.  A second warp of the codeblock
//     runs the MEL coder on one lane, concurrently with the rows that
//     follow: it takes the events as they are published, four a step from
//     a table of the coder's 85 states (k, run) and the 16 ways four
//     events go (the codewords' bits, their count, the next state; built
//     on the host, block_encode_cuda.mel_tables), and stores each
//     completed MEL word itself.  Coded one event at a time the MEL chain
//     was as long as the rows' on the busiest codeblocks.
//   End.  The MEL lane codes the last 0-3 events one at a time,
//     terminates a pending run with a '1', drains its partial word and
//     publishes its bit count; the rows' warp drains the other two partial
//     words, writes bits and ovf (ceil(bits / 32) > cap for some stream)
//     and stores every word past a stream's used prefix as zero, so the
//     caller need not zero the output.
// K codeblocks (2K warps, K <= 16) share a CUDA block and one copy of the
// tables in shared memory: enc_vlc0|1 (4,096 words), the MEL step table
// (2,720), enc_uvlc (its four columns packed into one word per row) and the
// MEL states.  The kernel launches on the caller's stream and allocates
// nothing.
//
// 64-bit instantiation (entry ht_cleanup_encode64; B = 64 below): the
// reference codes a band of more than 30 bit planes with
// ojph_encode_codeblock64, which the JAX package runs on its host
// (coding/encoder.py::encode_codeblock(bits=64), native encode_codeblock);
// no TPU kernel is behind it.  The same kernel on uint64 samples (p = 63 -
// kmax, sign in bit 63): exponents up to 63, MagSgn lengths up to 63 bits,
// and after the pair's suffixes each u code's extension (enc_uvlc's last
// two columns: (u - 33) >> 2 in four bits from u = 33, computed here), so a
// pair's VLC bits reach 38.  Pieces wider than 32 bits go into the rings
// as two; the scan word's fields widen (MagSgn 13 bits, VLC 10, MEL 9) and
// the rings double (MagSgn 512 words, VLC 64).

#include <cstdint>
#include <cuda_runtime.h>

namespace oje {

constexpr int kVlcEntries = 4096;  // enc_vlc0 | enc_vlc1
constexpr int kUvlcRows = 75;      // enc_uvlc rows (u_q 0..74)
constexpr int kMelStates = 85;     // MEL coder states (k, run)
constexpr int kMelStep = 2 * 16 * kMelStates;  // words of the step table
// as passed in: enc_vlc0|1, enc_uvlc's four columns, the MEL step table
// (16-byte aligned), the MEL states' (k, run)
constexpr int kMelStepAt = kVlcEntries + 4 * kUvlcRows;
constexpr int kMelKrAt = kMelStepAt + kMelStep;
// as held in shared memory: enc_vlc0|1, the step table, enc_uvlc packed,
// the states' (k, run)
constexpr int kShMelStep = kVlcEntries;
constexpr int kShUvlc = kShMelStep + kMelStep;
constexpr int kShMelKr = kShUvlc + kUvlcRows;
constexpr int kSharedTables = kShMelKr + kMelStates;
constexpr int kMsRing = 256;   // two units' MagSgn span <= 250 words
constexpr int kVlcRing = 32;   // two units' VLC span <= 31 words
constexpr unsigned kFull = 0xFFFFFFFFu;

// What differs between the two instantiations: the sample type, a pair of
// samples, the rings (two units' MagSgn span <= 505 words and VLC span
// <= 39 at B = 64) and the scan word's fields (MagSgn bits | VLC bits <<
// kVs | MEL events << kEs).
template <int B>
struct Width;
template <>
struct Width<32> {
  using T = uint32_t;
  using Pair = uint2;
  static constexpr int kMs = kMsRing, kVlc = kVlcRing;
  static constexpr int kVs = 12, kEs = 21;
  static constexpr uint32_t kMMask = 4095u, kVMask = 511u;
};
template <>
struct Width<64> {
  using T = unsigned long long;
  using Pair = ulonglong2;
  static constexpr int kMs = 2 * kMsRing, kVlc = 2 * kVlcRing;
  static constexpr int kVs = 13, kEs = 23;
  static constexpr uint32_t kMMask = 8191u, kVMask = 1023u;
};

__device__ __forceinline__ uint32_t lowmask(int n) {
  return n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
}

__device__ __forceinline__ uint32_t shr32(uint32_t v, uint32_t n) {
  return n >= 32u ? 0u : v >> n;
}

__device__ __forceinline__ uint32_t shr_t(uint32_t v, uint32_t n) {
  return shr32(v, n);
}
__device__ __forceinline__ unsigned long long shr_t(unsigned long long v,
                                                    uint32_t n) {
  return n >= 64u ? 0ull : v >> n;
}
__device__ __forceinline__ int clz_t(uint32_t v) {
  return __clz(static_cast<int>(v));
}
__device__ __forceinline__ int clz_t(unsigned long long v) {
  return __clzll(static_cast<long long>(v));
}
__device__ __forceinline__ uint32_t lowmask_t(uint32_t, int n) {
  return lowmask(n);
}
__device__ __forceinline__ unsigned long long lowmask_t(unsigned long long,
                                                        int n) {
  return n >= 64 ? ~0ull : (1ull << n) - 1ull;
}

// mel_exp(k) of MelEnc for k = 0..12, four bits each: 0 0 0 1 1 1 2 2 2 3
// 3 4 5
constexpr uint64_t kMelExp = 0x5433222111000ull;

__device__ __forceinline__ int mel_exp(int k) {
  return static_cast<int>((kMelExp >> (4 * k)) & 15u);
}

// Shared words per codeblock: two header words (events published, with
// bit 31 set once the rows are done; the MEL bit count, ~0 until known),
// the two rings, the context row, the event stream (at most one event per
// quad and one per pair of row 0, and four words of slack) and a spare
// word per lane.
__host__ __device__ __forceinline__ int event_words(int width, int height) {
  const int qw = (width + 1) >> 1, qh = (height + 1) >> 1;
  return ((qw * qh + ((qw + 1) >> 1) + 31) >> 5) + 4;
}

template <int B>
__host__ __device__ __forceinline__ int cb_words(int width, int height) {
  return 2 + Width<B>::kMs + Width<B>::kVlc + ((width + 1) >> 1) +
         event_words(width, height) + 32;
}

// The MEL coder (MelEnc::encode) and its stream, on one lane, four events
// a step: state index s = (k, run) and four events give the codewords' bits
// (at most 24, LSB-first), their count and the next state in one entry of
// the step table; the last 0-3 events of a codeblock go one at a time.
struct Mel {
  const uint2* step;   // [kMelStates * 16]: bits | count << 24, next state
  const uint32_t* kr;  // [kMelStates]: k | run << 4
  uint32_t* row;       // the codeblock's MEL words
  int cap;             // words the stream may hold
  int wi;              // words completed (stored, or dropped past the cap)
  int nb;              // bits held in acc; below 32 between appends
  uint64_t acc;
  uint32_t s;          // state index
  uint64_t pend;       // events not yet coded (fewer than 4 between feeds)
  int npend;

  // ln in [0, 31]: at most one word completes per append
  __device__ __forceinline__ void append(uint32_t v, int ln) {
    acc |= static_cast<uint64_t>(v) << nb;
    nb += ln;
    if (nb >= 32) {
      if (wi < cap) row[wi] = static_cast<uint32_t>(acc);
      ++wi;
      acc >>= 32;
      nb -= 32;
    }
  }
  // n <= 32 events, event j at bit j of ev (bits past n are zero)
  __device__ __forceinline__ void feed(uint64_t ev, int n) {
    pend |= ev << npend;
    npend += n;
    while (npend >= 4) {
      const uint2 t = step[s * 16 + static_cast<uint32_t>(pend & 15u)];
      append(t.x & 0xFFFFFFu, static_cast<int>(t.x >> 24));
      s = t.y;
      pend >>= 4;
      npend -= 4;
    }
  }
  // the last events one at a time, a pending run terminated with a '1'
  // (ojph_block_encoder.cpp:412), the partial word drained; returns the
  // stream's bits
  __device__ __forceinline__ int finish() {
    int k = static_cast<int>(kr[s] & 15u);
    int run = static_cast<int>(kr[s] >> 4);
    for (int i = 0; i < npend; ++i) {
      const int e = mel_exp(k);
      if (((pend >> i) & 1u) == 0u) {
        if (++run >= (1 << e)) {
          append(1u, 1);
          run = 0;
          k = k < 12 ? k + 1 : 12;
        }
      } else {
        // '0', then the e low bits of the run MSB-first: reversed into
        // LSB-first order
        const uint32_t rev =
            e > 0 ? __brev(static_cast<uint32_t>(run)) >> (32 - e) : 0u;
        append(rev << 1, 1 + e);
        run = 0;
        k = k > 0 ? k - 1 : 0;
      }
    }
    if (run > 0) append(1u, 1);
    if (nb > 0 && wi < cap) row[wi] = static_cast<uint32_t>(acc);
    return wi * 32 + nb;
  }
};

struct Args {
  const void* buf;      // [n, hp, wp] sign-magnitude samples
  const int32_t* p;     // [n] 31 - kmax (63 - kmax at B = 64)
  const int32_t* qhl;   // [n] quad-row limit
  const uint32_t* tables;
  uint32_t* cat;        // [n, wm + wv + ws]
  int32_t* bits;        // [n, 3]
  uint8_t* ovf;         // [n]
  int hp, wp, wm, wv, ws;
  int n, width, height;
};

// ORs v, of ln <= 31 bits, into ring (mask + 1 words) at bit pos; with
// ln = 0 (v = 0) both ORs go to `spare`.
__device__ __forceinline__ void deposit(uint32_t* ring, uint32_t mask,
                                        uint32_t* spare, uint32_t pos,
                                        uint32_t v, int ln) {
  const uint32_t w = pos >> 5, sh = pos & 31u;
  const bool two = sh + static_cast<uint32_t>(ln) > 32u;
  atomicOr(ln > 0 ? ring + (w & mask) : spare, v << sh);
  atomicOr(two ? ring + ((w + 1u) & mask) : spare,
           two ? (v >> 1) >> (31u - sh) : 0u);
}

// Stores the ring's completed words [w0, w1) to dst (words at or past cap
// dropped) and zeroes their slots.
__device__ __forceinline__ void flush(uint32_t* ring, uint32_t mask,
                                      uint32_t* dst, int cap, uint32_t w0,
                                      uint32_t w1, int lane) {
  for (uint32_t w = w0 + lane; w < w1; w += 32u) {
    if (w < static_cast<uint32_t>(cap)) dst[w] = ring[w & mask];
    ring[w & mask] = 0u;
  }
}

// p[0, n) = 0 by the warp: 16 bytes a lane between the first and the last
// 16-byte boundary, single words before and after.
__device__ __forceinline__ void zero_words(uint32_t* p, int n, int lane) {
  if (n <= 0) return;
  const int head = min(
      n, static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) &
                           15u) >> 2));
  if (lane < head) p[lane] = 0u;
  const int nv = (n - head) >> 2;
  uint4* v = reinterpret_cast<uint4*>(p + head);
  for (int i = lane; i < nv; i += 32) v[i] = make_uint4(0u, 0u, 0u, 0u);
  const int tail = head + 4 * nv;
  if (tail + lane < n) p[tail + lane] = 0u;
}

// The MEL warp's lane 0: codes the events the rows' warp publishes in
// hdr[0] and `stream` until it marks them done, then terminates, drains
// and publishes the MEL bit count in hdr[1].
__device__ void mel_lane(Mel& mel, volatile uint32_t* hdr,
                         const volatile uint32_t* stream) {
  uint32_t done = 0;  // events coded
  unsigned nap = 32;  // ns between polls, doubling while idle
  for (;;) {
    const uint32_t av = hdr[0];
    const uint32_t n_av = av & 0x7FFFFFFFu;
    if (n_av > done) {
      __threadfence_block();
      nap = 32;
      do {
        const uint32_t take = min(n_av - done, 32u);
        const uint32_t w = done >> 5;
        const uint64_t two = static_cast<uint64_t>(stream[w]) |
                             (static_cast<uint64_t>(stream[w + 1]) << 32);
        const uint64_t ev = (two >> (done & 31u)) & ((1ull << take) - 1ull);
        mel.feed(ev, static_cast<int>(take));
        done += take;
      } while (done < n_av);
    } else if (av >> 31) {
      break;
    } else {
      __nanosleep(nap);
      nap = nap < 1024 ? 2 * nap : 1024;
    }
  }
  hdr[1] = static_cast<uint32_t>(mel.finish());
}

template <int B>
__global__ void ht_cleanup_encode_kernel(const Args a) {
  using T = typename Width<B>::T;
  using Pair = typename Width<B>::Pair;
  constexpr int kMsR = Width<B>::kMs, kVlcR = Width<B>::kVlc;
  constexpr int kVs = Width<B>::kVs, kEs = Width<B>::kEs;
  constexpr uint32_t kMMask = Width<B>::kMMask, kVMask = Width<B>::kVMask;
  extern __shared__ uint32_t smem[];
  {
    // enc_vlc0|1 and the MEL step table, 16 bytes a thread (both sides
    // are 16-byte aligned); enc_uvlc's row u as prefix | prefix length <<
    // 8 | suffix << 16 | suffix length << 24
    const uint4* t = reinterpret_cast<const uint4*>(a.tables);
    uint4* s = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < kVlcEntries / 4; i += blockDim.x)
      s[i] = __ldg(t + i);
    for (int i = threadIdx.x; i < kMelStep / 4; i += blockDim.x)
      s[kShMelStep / 4 + i] = __ldg(t + kMelStepAt / 4 + i);
    const uint32_t* u = a.tables + kVlcEntries;
    for (int i = threadIdx.x; i < kUvlcRows; i += blockDim.x)
      smem[kShUvlc + i] = __ldg(u + i) | (__ldg(u + kUvlcRows + i) << 8) |
                          (__ldg(u + 2 * kUvlcRows + i) << 16) |
                          (__ldg(u + 3 * kUvlcRows + i) << 24);
    for (int i = threadIdx.x; i < kMelStates; i += blockDim.x)
      smem[kShMelKr + i] = __ldg(a.tables + kMelKrAt + i);
  }
  // every codeblock's shared words zeroed, its MEL bit count unknown
  const int per_cb = cb_words<B>(a.width, a.height);
  const int slots = blockDim.x >> 6;
  uint32_t* regions = smem + kSharedTables;
  for (int i = threadIdx.x; i < slots * per_cb; i += blockDim.x)
    regions[i] = i % per_cb == 1 ? 0xFFFFFFFFu : 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cb = blockIdx.x * slots + (warp >> 1);
  if (cb >= a.n) return;
  const uint32_t* vlc_tbl = smem;
  const uint32_t* uvlc_tbl = smem + kShUvlc;

  const int qw = (a.width + 1) >> 1;
  const int qh = (a.height + 1) >> 1;
  const int nch = (qw + 31) >> 5;
  volatile uint32_t* hdr = regions + (warp >> 1) * per_cb;
  uint32_t* ms_ring = const_cast<uint32_t*>(hdr) + 2;
  uint32_t* vlc_ring = ms_ring + kMsR;
  // ctx[q]: quad q's bottom samples in the row above, e_bl | e_br << 6 |
  // sig_bl << 12 | sig_br << 13
  uint32_t* ctx = vlc_ring + kVlcR;
  uint32_t* events = ctx + qw;
  // a word per lane that takes the ORs of no bits
  uint32_t* spare = events + event_words(a.width, a.height) + lane;
  uint32_t* out = a.cat + static_cast<size_t>(cb) * (a.wm + a.wv + a.ws);
  if (warp & 1) {
    if (lane == 0) {
      Mel mel{reinterpret_cast<const uint2*>(smem + kShMelStep),
              smem + kShMelKr, out, a.wm, 0, 0, 0ull, 0u, 0ull, 0};
      mel_lane(mel, hdr, events);
    }
    return;
  }

  const uint32_t p = static_cast<uint32_t>(a.p[cb]);
  const int qhl = a.qhl[cb];
  const int rows = qhl < qh ? (qhl > 0 ? qhl : 0) : qh;
  uint32_t* vlc_out = out + a.wm;
  uint32_t* ms_out = vlc_out + a.wv;
  const T* blk = static_cast<const T*>(a.buf) +
                 static_cast<size_t>(cb) * a.hp * a.wp;
  uint32_t mbits = 0, vbits = 0;  // MagSgn / VLC bits so far
  uint32_t evn = 0;               // MEL events so far

  // A unit is chunk c of quad row r; units go in stream order, two an
  // iteration, so that the two chains interleave: rows r and r + 1 when a
  // row is one chunk (tall), else chunks c and c + 1 of row r.  The second
  // is absent past the last row or chunk.
  const bool tall = nch == 1;
  auto partner = [&](int r, int c, int& r1, int& c1) {
    r1 = tall ? r + 1 : r;
    c1 = tall ? 0 : c + 1;
    return tall ? r1 < rows : c1 < nch;
  };
  // this lane's samples of a unit: top pair, bottom pair
  auto load = [&](int r, int c, bool on, Pair& top, Pair& bot) {
    const int q = 32 * c + lane;
    if (on && q < qw) {
      const T* at = blk + static_cast<size_t>(2 * r) * a.wp + 2 * q;
      top = __ldg(reinterpret_cast<const Pair*>(at));
      bot = __ldg(reinterpret_cast<const Pair*>(at + a.wp));
    } else {
      top = Pair{0, 0};
      bot = Pair{0, 0};
    }
  };
  Pair ntop[2], nbot[2];
  {
    int r1, c1;
    const bool on1 = partner(0, 0, r1, c1);
    load(0, 0, rows > 0, ntop[0], nbot[0]);
    load(r1, c1, rows > 0 && on1, ntop[1], nbot[1]);
  }
  // the unit before's lane 31 (same row): its rho and its row-above entry
  uint32_t rho_carry = 0u, ctx_carry = 0u;
  __syncwarp();

  for (int r = 0, c = 0; r < rows;) {
    int ru[2], cu[2];
    ru[0] = r;
    cu[0] = c;
    const bool on1 = partner(r, c, ru[1], cu[1]);
    const Pair top[2] = {ntop[0], ntop[1]};
    const Pair bot[2] = {nbot[0], nbot[1]};
    const int rn = tall ? r + 2 : (c + 2 < nch ? r : r + 1);
    const int cn = tall || c + 2 >= nch ? 0 : c + 2;
    if (rn < rows) {
      int r1, c1;
      const bool n1 = partner(rn, cn, r1, c1);
      load(rn, cn, true, ntop[0], nbot[0]);
      load(r1, c1, n1, ntop[1], nbot[1]);
    }
    if (c == 0) rho_carry = ctx_carry = 0u;

    // ---- each unit's quad: k = 0 top-left, 1 bottom-left, 2 top-right,
    // 3 bottom-right ----
    int q[2], e[2][4], emax[2];
    bool present[2], init[2];
    T s[2][4];
    uint32_t rho[2], fresh[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      q[u] = 32 * cu[u] + lane;
      present[u] = (u == 0 || on1) && q[u] < qw;
      init[u] = ru[u] == 0;
      const T t[4] = {top[u].x, bot[u].x, top[u].y, bot[u].y};
      rho[u] = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // (t + t) >> p wraps in the sample type, which drops the sign bit
        const T val = shr_t(static_cast<T>(t[k] + t[k]), p) & ~T(1);
        const bool sig = val != T(0);
        e[u][k] = sig ? B - clz_t(static_cast<T>(val - T(1))) : 0;
        s[u][k] = sig ? static_cast<T>((val - T(2)) + (t[k] >> (B - 1)))
                      : T(0);
        rho[u] |= static_cast<uint32_t>(sig) << k;
      }
      emax[u] = max(max(e[u][0], e[u][1]), max(e[u][2], e[u][3]));
      // the row-above entry this quad leaves for the next row:
      // e_bl | e_br << 6 | sig_bl << 12 | sig_br << 13
      fresh[u] = static_cast<uint32_t>(e[u][1]) |
                 (static_cast<uint32_t>(e[u][3]) << 6) |
                 (((rho[u] >> 1) & 1u) << 12) | (((rho[u] >> 3) & 1u) << 13);
    }

    // ---- context: the left quad's rho, the row above's entries ----
    uint32_t rho_left[2], own[2], left[2], right[2];
    own[0] = present[0] && !init[0] ? ctx[q[0]] : 0u;
    own[1] = present[1] && !init[1] ? (tall ? fresh[0] : ctx[q[1]]) : 0u;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      rho_left[u] = __shfl_up_sync(kFull, rho[u], 1);
      left[u] = __shfl_up_sync(kFull, own[u], 1);
      right[u] = __shfl_down_sync(kFull, own[u], 1);
    }
    const uint32_t rho0_31 = __shfl_sync(kFull, rho[0], 31);
    const uint32_t rho1_31 = __shfl_sync(kFull, rho[1], 31);
    const uint32_t own0_31 = __shfl_sync(kFull, own[0], 31);
    const uint32_t own1_31 = __shfl_sync(kFull, own[1], 31);
    const uint32_t own1_0 = __shfl_sync(kFull, own[1], 0);
    if (lane == 0) {
      rho_left[0] = rho_carry;
      left[0] = ctx_carry;
      rho_left[1] = tall ? 0u : rho0_31;
      left[1] = tall ? 0u : own0_31;
    }
    if (lane == 31) {
      right[0] = tall || !on1 ? 0u : own1_0;
      right[1] = !tall && present[1] && !init[1] && q[1] + 1 < qw
                     ? ctx[q[1] + 1]
                     : 0u;
    }
    rho_carry = on1 ? rho1_31 : rho0_31;
    ctx_carry = on1 ? own1_31 : own0_31;

    // ---- per quad: c_q, kappa, u_q, eps, tuple, MagSgn lengths; per pair
    // on its even lane: VLC bits and MEL events ----
    int m[2][4];
    uint32_t x[2], mev[2];
    T vrec[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint32_t rl = rho_left[u], ow = own[u], lf = left[u],
                     rt = right[u];
      const int max_e =
          max(max(static_cast<int>((lf >> 6) & 63u), static_cast<int>(ow & 63u)),
              max(static_cast<int>((ow >> 6) & 63u),
                  static_cast<int>(rt & 63u))) - 1;
      const uint32_t cx0 = ((lf >> 13) | (ow >> 12)) & 1u;
      const uint32_t cx1 = ((ow >> 13) | (rt >> 12)) & 1u;
      const int c_q = static_cast<int>(
          init[u] ? (rl >> 1) | (rl & 1u)
                  : cx0 | (cx1 << 2) | ((((rl >> 2) | (rl >> 3)) & 1u) << 1));
      const int kappa = !init[u] && (rho[u] & (rho[u] - 1u)) != 0u
                            ? (max_e > 1 ? max_e : 1)
                            : 1;
      const int uq = emax[u] > kappa ? emax[u] : kappa;
      const int u_q = present[u] ? uq - kappa : 0;
      uint32_t eps = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        eps |= static_cast<uint32_t>(u_q > 0 && e[u][k] == emax[u] &&
                                     e[u][k] > 0) << k;
      const uint32_t tuple = vlc_tbl[(init[u] ? 0 : 2048) + (c_q << 8) +
                                     static_cast<int>(rho[u] << 4) + eps];
      const uint32_t tlen = present[u] ? (tuple >> 4) & 7u : 0u;
      const uint32_t tcw = (tuple >> 8) & lowmask(static_cast<int>(tlen));
      int mlen = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int mk = uq - static_cast<int>((tuple >> k) & 1u);
        m[u][k] = ((rho[u] >> k) & 1u) ? (mk < B - 1 ? mk : B - 1) : 0;
        mlen += m[u][k];
      }
      const bool mel_has = present[u] && c_q == 0;
      // partner quad: tuple bits | length << 8 | u_q << 12 | MEL event <<
      // 20 | its bit << 21
      const uint32_t mine = tcw | (tlen << 8) |
                            (static_cast<uint32_t>(u_q) << 12) |
                            (static_cast<uint32_t>(mel_has) << 20) |
                            (static_cast<uint32_t>(rho[u] != 0u) << 21);
      const uint32_t part = __shfl_down_sync(kFull, mine, 1);
      const bool lead = (lane & 1) == 0 && present[u];
      const int u0 = u_q;
      const int u1 = static_cast<int>((part >> 12) & 255u);
      // u codes: row 0's case a (both > 2) codes u - 2; case b (u_q0 > 2,
      // u_q1 = 1 or 2) codes u_q1 - 1 in one bit and no second suffix
      const bool ca = init[u] && u0 > 2 && u1 > 2;
      const bool cb2 = init[u] && !ca && u0 > 2 && u1 > 0;
      const int i0 = min(ca ? u0 - 2 : u0, 74);
      const int i1 = min(ca ? u1 - 2 : u1, 74);
      const uint32_t a0 = uvlc_tbl[i0];
      const uint32_t a1 = uvlc_tbl[i1];
      const uint32_t pre1 = cb2 ? static_cast<uint32_t>(u1 - 1) & 1u : a1 & 255u;
      const uint32_t plen1 = cb2 ? 1u : (a1 >> 8) & 255u;
      const uint32_t suf1 = cb2 ? 0u : (a1 >> 16) & 255u;
      const uint32_t slen1 = cb2 ? 0u : a1 >> 24;
      T rec = tcw;
      uint32_t n = tlen;
      rec |= static_cast<T>(part & 255u) << n;
      n += (part >> 8) & 15u;
      rec |= static_cast<T>(a0 & 255u) << n;
      n += (a0 >> 8) & 255u;
      rec |= static_cast<T>(pre1) << n;
      n += plen1;
      rec |= static_cast<T>((a0 >> 16) & 255u) << n;
      n += a0 >> 24;
      rec |= static_cast<T>(suf1) << n;
      n += slen1;
      if (B == 64) {
        // the u codes' extensions (encoder64.cpp:1269-1286, 1491-1492):
        // enc_uvlc row i >= 33 extends by (i - 33) >> 2 in four bits;
        // row 0's case b has none for u_q1
        rec |= static_cast<T>(i0 >= 33 ? (i0 - 33) >> 2 : 0) << n;
        n += i0 >= 33 ? 4u : 0u;
        rec |= static_cast<T>(!cb2 && i1 >= 33 ? (i1 - 33) >> 2 : 0) << n;
        n += !cb2 && i1 >= 33 ? 4u : 0u;
      }
      // the pair's MEL events, in order
      const bool h0 = mel_has, h1 = (part >> 20) & 1u;
      const bool hu = init[u] && u0 > 0 && u1 > 0;
      uint32_t ev = static_cast<uint32_t>(h0 && rho[u] != 0u);
      uint32_t cnt = h0;
      ev |= static_cast<uint32_t>(h1 && ((part >> 21) & 1u)) << cnt;
      cnt += h1;
      ev |= static_cast<uint32_t>(hu && min(u0, u1) > 2) << cnt;
      cnt += hu;
      vrec[u] = lead ? rec : T(0);
      mev[u] = lead ? ev : 0u;
      x[u] = static_cast<uint32_t>(mlen) | ((lead ? n : 0u) << kVs) |
             ((lead ? cnt : 0u) << kEs);
    }

    // ---- bit positions: a scan of MagSgn | VLC << 12 | MEL << 21 per
    // unit, the two interleaved ----
    uint32_t incl[2] = {x[0], x[1]};
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t t0 = __shfl_up_sync(kFull, incl[0], d);
      const uint32_t t1 = __shfl_up_sync(kFull, incl[1], d);
      if (lane >= d) {
        incl[0] += t0;
        incl[1] += t1;
      }
    }
    const uint32_t tot0 = __shfl_sync(kFull, incl[0], 31);
    const uint32_t tot1 = __shfl_sync(kFull, incl[1], 31);
    const uint32_t base_m[2] = {mbits, mbits + (tot0 & kMMask)};
    const uint32_t base_v[2] = {vbits, vbits + ((tot0 >> kVs) & kVMask)};
    const uint32_t base_e[2] = {0u, tot0 >> kEs};
    uint32_t ev_w[3] = {0u, 0u, 0u};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint32_t excl = incl[u] - x[u];
      const uint32_t vlen = (x[u] >> kVs) & kVMask;
      // every piece goes in by atomicOr, without branches: a piece of no
      // bits goes to this lane's spare word; at B = 64 a piece of more
      // than 32 bits goes in as two
      const uint32_t vpos = base_v[u] + ((excl >> kVs) & kVMask);
      deposit(vlc_ring, kVlcR - 1, spare, vpos,
              static_cast<uint32_t>(vrec[u]),
              static_cast<int>(B == 64 ? min(vlen, 32u) : vlen));
      if (B == 64)
        deposit(vlc_ring, kVlcR - 1, spare, vpos + 32u,
                static_cast<uint32_t>(
                    static_cast<unsigned long long>(vrec[u]) >> 32),
                static_cast<int>(vlen > 32u ? vlen - 32u : 0u));
      uint32_t pos = base_m[u] + (excl & kMMask);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const T v = s[u][k] & lowmask_t(T(0), m[u][k]);
        deposit(ms_ring, kMsR - 1, spare, pos, static_cast<uint32_t>(v),
                B == 64 ? min(m[u][k], 32) : m[u][k]);
        if (B == 64)
          deposit(ms_ring, kMsR - 1, spare, pos + 32u,
                  static_cast<uint32_t>(static_cast<unsigned long long>(v) >>
                                        32),
                  m[u][k] > 32 ? m[u][k] - 32 : 0);
        pos += static_cast<uint32_t>(m[u][k]);
      }
      // this unit's events at their rank among both units' (<= 96 bits)
      const uint32_t rank = base_e[u] + (excl >> kEs);
      const uint64_t ev = static_cast<uint64_t>(mev[u]) << (rank & 31u);
      const uint32_t wi = rank >> 5;
      ev_w[0] |= wi == 0 ? static_cast<uint32_t>(ev) : 0u;
      ev_w[1] |= wi == 0 ? static_cast<uint32_t>(ev >> 32)
                         : (wi == 1 ? static_cast<uint32_t>(ev) : 0u);
      ev_w[2] |= wi == 1 ? static_cast<uint32_t>(ev >> 32)
                         : (wi == 2 ? static_cast<uint32_t>(ev) : 0u);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) ev_w[i] = __reduce_or_sync(kFull, ev_w[i]);
    if (present[0]) ctx[q[0]] = fresh[0];
    if (present[1]) ctx[q[1]] = fresh[1];
    __syncwarp();

    // ---- the events to the MEL warp; completed words out ----
    const uint32_t nev = (tot0 >> kEs) + (tot1 >> kEs);
    if (lane == 0 && nev > 0u) {
      const uint32_t w = evn >> 5, sh = evn & 31u;
      events[w] |= ev_w[0] << sh;
      if (sh == 0u) {
        events[w + 1] = ev_w[1];
        events[w + 2] = ev_w[2];
      } else {
        events[w + 1] = (ev_w[0] >> (32u - sh)) | (ev_w[1] << sh);
        events[w + 2] = (ev_w[1] >> (32u - sh)) | (ev_w[2] << sh);
        events[w + 3] = ev_w[2] >> (32u - sh);
      }
      __threadfence_block();
      hdr[0] = evn + nev;
    }
    evn += nev;
    const uint32_t mnext = base_m[1] + (tot1 & kMMask);
    const uint32_t vnext = base_v[1] + ((tot1 >> kVs) & kVMask);
    flush(ms_ring, kMsR - 1, ms_out, a.ws, mbits >> 5, mnext >> 5, lane);
    flush(vlc_ring, kVlcR - 1, vlc_out, a.wv, vbits >> 5, vnext >> 5, lane);
    mbits = mnext;
    vbits = vnext;
    r = rn;
    c = cn;
    __syncwarp();
  }

  // ---- end of block ----
  uint32_t mel_bits = 0u;
  if (lane == 0) {
    __threadfence_block();
    hdr[0] = evn | 0x80000000u;
    while ((mel_bits = hdr[1]) == 0xFFFFFFFFu) __nanosleep(32);
  } else if (lane == 1) {
    if ((vbits & 31u) && (vbits >> 5) < static_cast<uint32_t>(a.wv))
      vlc_out[vbits >> 5] = vlc_ring[(vbits >> 5) & (kVlcR - 1)];
  } else if (lane == 2) {
    if ((mbits & 31u) && (mbits >> 5) < static_cast<uint32_t>(a.ws))
      ms_out[mbits >> 5] = ms_ring[(mbits >> 5) & (kMsR - 1)];
  }
  mel_bits = __shfl_sync(kFull, mel_bits, 0);
  const int used_m = static_cast<int>((mel_bits + 31u) >> 5);
  const int used_v = static_cast<int>((vbits + 31u) >> 5);
  const int used_s = static_cast<int>((mbits + 31u) >> 5);
  if (lane == 0) {
    a.bits[3 * cb + 0] = static_cast<int32_t>(mel_bits);
    a.bits[3 * cb + 1] = static_cast<int32_t>(vbits);
    a.bits[3 * cb + 2] = static_cast<int32_t>(mbits);
    a.ovf[cb] = (used_m > a.wm || used_v > a.wv || used_s > a.ws) ? 1 : 0;
  }
  zero_words(out + used_m, a.wm - used_m, lane);
  zero_words(vlc_out + used_v, a.wv - used_v, lane);
  zero_words(ms_out + used_s, a.ws - used_s, lane);
}

template <int B>
int launch(const void* buf, int hp, int wp, const void* p, const void* qhl,
           const void* tables, void* cat, int wm, int wv, int ws, void* bits,
           void* ovf, int n, int width, int height, int threads,
           void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (width < 1 || height < 1 || hp < 2 * ((height + 1) >> 1) ||
      wp < 2 * ((width + 1) >> 1) || (wp & 1) || wm < 0 || wv < 0 || ws < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.buf = buf;
  a.p = static_cast<const int32_t*>(p);
  a.qhl = static_cast<const int32_t*>(qhl);
  a.tables = static_cast<const uint32_t*>(tables);
  a.cat = static_cast<uint32_t*>(cat);
  a.bits = static_cast<int32_t*>(bits);
  a.ovf = static_cast<uint8_t*>(ovf);
  a.hp = hp;
  a.wp = wp;
  a.wm = wm;
  a.wv = wv;
  a.ws = ws;
  a.n = n;
  a.width = width;
  a.height = height;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t per_cb = static_cast<size_t>(cb_words<B>(width, height)) * 4;
  const size_t tables_bytes = static_cast<size_t>(kSharedTables) * 4;
  int k = threads > 0 ? (threads < 16 ? threads : 16) : 1;
  while (k > 1 && tables_bytes + k * per_cb > static_cast<size_t>(optin))
    --k;
  const size_t smem = tables_bytes + k * per_cb;
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(ht_cleanup_encode_kernel<B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n + k - 1) / k;
  ht_cleanup_encode_kernel<B><<<grid, 64 * k, smem,
                                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace oje

extern "C" {

// buf [n, hp, wp] uint32 (wp a multiple of 4, 16-byte aligned); p, qhl [n]
// int32; tables: enc_vlc0|1 (4,096) then enc_uvlc's prefix, prefix length,
// suffix and suffix length columns (75 each), 16-byte aligned; cat
// [n, wm + wv + ws] uint32 (every word is written); bits [n, 3] int32; ovf
// [n] uint8.  ``threads``: codeblocks per CUDA block (two warps each),
// clamped to [1, 16].  Returns the CUDA error code of the launch (0 on
// success).
int ht_cleanup_encode(const void* buf, int hp, int wp, const void* p,
                      const void* qhl, const void* tables, void* cat, int wm,
                      int wv, int ws, void* bits, void* ovf, int n, int width,
                      int height, int threads, void* stream) {
  return oje::launch<32>(buf, hp, wp, p, qhl, tables, cat, wm, wv, ws, bits,
                         ovf, n, width, height, threads, stream);
}

// The 64-bit instantiation: buf [n, hp, wp] uint64, p = 63 - kmax; the
// other arguments (and the tables) as above.
int ht_cleanup_encode64(const void* buf, int hp, int wp, const void* p,
                        const void* qhl, const void* tables, void* cat,
                        int wm, int wv, int ws, void* bits, void* ovf, int n,
                        int width, int height, int threads, void* stream) {
  return oje::launch<64>(buf, hp, wp, p, qhl, tables, cat, wm, wv, ws, bits,
                         ovf, n, width, height, threads, stream);
}

}  // extern "C"
