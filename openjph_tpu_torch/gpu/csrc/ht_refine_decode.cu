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
//
// What bounds it.  Not bytes: on the 2048x1080 gray 3-pass frame the
// `dec` round trip is 25 MB, some 7.6 us of HBM time.  SigProp is serial
// over a codeblock: each 4x4 group's bit offset is what the groups before
// it consumed, and inside a group each candidate decision spreads new
// candidates to the samples after it.  The kernel's time is that chain,
// 256 groups for a 64x64 block, on the longest lane: on that frame
// SigProp is ~90% of the kernel's time (chip_smoke.py's split by gates).
//
// Design: one warp per codeblock, its samples staged in shared memory.
//   Phase A (all 32 lanes): the codeblock's `dec` into shared memory with
//     coalesced reads, and the cleanup significance of every 4x4 group
//     (bit 4*col + row) from it.
//   Phase B (all 32 lanes): the two streams into shared memory.  Raw mode
//     unstuffs 128 bytes a batch, four a lane (a byte's payload depends on
//     it and the two bytes before it), places the payloads with a warp scan
//     of their bit counts and ORs them into the words, only as far as the
//     passes can read.  Dense mode copies the word rows.
//   Phase C (all 32 lanes, MagRef): a step a lane, a step being the 32-bit
//     significance word of two groups of a stripe; a warp scan of the
//     words' popcounts gives each step its bit offset; each lane XORs its
//     samples.
//   Phase D (one lane, SigProp): the stripes and their groups in order,
//     with the neighbour context from the row above (`prow`, the stripes'
//     final significance) and the group to the left (`prev`); the
//     candidates of a group are visited lowest first (ffs), one bit each,
//     then one sign bit per newly significant sample, stored at once.
//   Phase E (all 32 lanes): the samples back to `dec`, coalesced.
// SigProp touches only samples that are not cleanup-significant and MagRef
// only those that are, so C and D write disjoint samples.  `dec` is read
// once and written once.  K codeblocks (warps) share a CUDA block.  The
// kernel launches on the caller's stream and allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace ojr {

constexpr unsigned kFull = 0xFFFFFFFFu;
// room past a raw stream's read cap for the last batch of 128 bytes
constexpr int kBatchWords = 33;
// SigProp's candidate spread per row of a column, one byte each
// (tpu/block_refine.py::_SPREAD: 0x33, 0x76, 0xEC, 0xC8)
constexpr uint32_t kSpread = 0xC8EC7633u;

enum { kSpp = 0, kMrp = 1 };

__device__ __forceinline__ uint32_t shl32(uint32_t v, uint32_t n) {
  return n >= 32u ? 0u : v << n;
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
  int sig_words;      // (n_sy + 1) x (n_gx + 1) significance, zero padded
  int cap_spp, cap_mrp;  // words a pass can read (see below)
};

// SigProp reads at most two bits a sample (candidate and sign) and peeks
// 32 bits past its offset, MagRef one bit a sample: the caps hold that
// with words to spare.
__host__ __device__ inline Geo geometry(int width, int height) {
  Geo g;
  g.n_sy = (height + 3) >> 2;
  g.n_gx = (width + 3) >> 2;
  g.n_g2 = (g.n_gx + 1) >> 1;
  g.sig_words = (g.n_sy + 1) * (g.n_gx + 1);
  const int area = 16 * g.n_sy * g.n_gx;
  g.cap_spp = (2 * area + 31) / 32 + 4;
  g.cap_mrp = (area + 31) / 32 + 4;
  return g;
}

// shared words per codeblock: its samples, significance, prow, the two
// streams; a multiple of 4, so each warp's samples are 16-byte aligned
__host__ __device__ inline int warp_words(int width, int height) {
  const Geo g = geometry(width, height);
  const int w = width * height + g.sig_words + (g.n_gx + 1) +
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

// Unstuffs bytes j0 .. j0+127 of a segment, four a lane (MagRef reads
// backward from src), and ORs their payloads into buf at bit pos0 and on;
// the words there must be zero.  `carry` holds the raw bytes j0-2 | j0-1
// << 8 in and j0+126 | j0+127 << 8 out.  Returns the bits appended (1,024
// at most; the same on every lane).
template <int KIND>
__device__ __forceinline__ uint32_t unstuff128(const uint8_t* src, int j0,
                                               int n, uint32_t& carry,
                                               uint32_t* buf, uint32_t pos0,
                                               int lane) {
  const int j = j0 + 4 * lane;
  uint32_t b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    b[k] = j + k < n ? __ldg(KIND == kMrp ? src - (j + k) : src + (j + k))
                     : 0u;
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
// kBatchWords words, zeroed here) until it ends or cap words are written.
template <int KIND>
__device__ __forceinline__ Src raw_src(const uint8_t* src, int n,
                                       uint32_t* buf, int cap, int lane) {
  const int words = cap + kBatchWords;
  for (int i = lane; i < words; i += 32) buf[i] = 0u;
  __syncwarp();
  uint32_t carry = 0, produced = 0;
  const uint32_t cap_bits = static_cast<uint32_t>(cap) * 32u;
  for (int j0 = 0; j0 < n && produced < cap_bits; j0 += 128)
    produced += unstuff128<KIND>(src, j0, n, carry, buf, produced, lane);
  return Src{buf, nullptr, words, words, 0u};
}

// Dense mode, phase B: the row's words below min(last, cap) into buf.
__device__ __forceinline__ Src dense_src(const uint32_t* row, int nwords,
                                         uint32_t* buf, int cap, int lane) {
  const int last = nwords - 1;
  const int lim = last < cap ? last : cap;
  for (int i = lane; i < lim; i += 32) buf[i] = __ldg(row + i);
  return Src{buf, row, lim, last, __ldg(row + last)};
}

// ---- SigProp ----

// SigProp over one codeblock's samples `blk` (ojph_block_decoder32.cpp:
// 1358-1556, tpu/block_refine.py::_sigprop), on one lane.
__device__ __forceinline__ void sigprop(const Src& spp, const uint32_t* sig,
                                        uint32_t* prow, uint32_t* blk,
                                        const Geo& g, int W, int H, int hl,
                                        uint32_t pu, bool causal) {
  const int gs = g.n_gx + 1;
  const uint32_t val16 = shl32(3u, pu - 2u);
  uint32_t off = 0;
  for (int sy = 0; sy < g.n_sy; ++sy) {
    const int rl = hl - 4 * sy;
    if (rl <= 0) break;  // no candidates here or below: nothing is read
    const uint32_t pattern0 = rl >= 4   ? 0xFFFFu
                              : rl == 3 ? 0x7777u
                              : rl == 2 ? 0x3333u
                                        : 0x1111u;
    const uint32_t* srow = sig + sy * gs;
    const uint32_t* nrow = srow + gs;
    uint32_t cs_lo = srow[0], ns_lo = nrow[0], prev = 0;
    for (int gx = 0; gx < g.n_gx; ++gx) {
      const uint32_t cs_hi = srow[gx + 1], ns_hi = nrow[gx + 1];
      const uint32_t cs = cs_lo | (cs_hi << 16);
      const uint32_t ns = ns_lo | (ns_hi << 16);
      const int over = 4 * gx + 4 - W;
      const uint32_t pattern = pattern0 >> (over > 0 ? 4 * over : 0);
      const uint32_t ps = prow[gx] | (prow[gx + 1] << 16);
      uint32_t u = (ps & 0x88888888u) >> 3;
      if (!causal) u |= (ns & 0x11111111u) << 3;
      uint32_t mbr = cs | ((cs & 0x77777777u) << 1) |
                     ((cs & 0xEEEEEEEEu) >> 1) | u;
      mbr = mbr | (mbr << 4) | (mbr >> 4);
      mbr |= prev >> 12;
      mbr &= pattern & ~cs;
      const uint32_t inv_sig = ~cs & pattern;
      uint32_t cwd = spp.bits32(off);
      // candidates lowest first; a sample that turns significant makes
      // its later neighbours candidates
      uint32_t cand = mbr, nsig = 0;
      int cnt = 0;
      while (cand) {
        const int pos = __ffs(cand) - 1;
        cand &= cand - 1u;
        const uint32_t bit = cwd & 1u;
        cwd >>= 1;
        ++cnt;
        if (bit) {
          nsig |= 1u << pos;
          const uint32_t spread = ((kSpread >> (8 * (pos & 3))) & 0xFFu)
                                  << (pos & ~3);
          cand |= spread & inv_sig & ~((2u << pos) - 1u);
        }
      }
      // one sign bit per newly significant sample, in position order
      uint32_t m = nsig;
      for (int k = 0; m; ++k) {
        const int pos = __ffs(m) - 1;
        m &= m - 1u;
        const uint32_t val = (((cwd >> k) & 1u) << 31) | val16;
        const int y = 4 * sy + (pos & 3), x = 4 * gx + (pos >> 2);
        if (val != 0u && y < H) blk[y * W + x] = val;
      }
      off += static_cast<uint32_t>(cnt + __popc(nsig));
      const uint32_t tt = (nsig | cs) & 0xFFFFu;
      prow[gx] = tt;
      const uint32_t n16 = tt | ((tt & 0x7777u) << 1) | ((tt & 0xEEEEu) >> 1);
      prev = (n16 | u) & 0xF000u;
      cs_lo = cs_hi;
      ns_lo = ns_hi;
    }
  }
}

// ---- the kernel ----

struct Args {
  uint32_t* dec;
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
};

template <bool RAW>
__global__ void ht_refine_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cb = blockIdx.x * (blockDim.x >> 5) + warp;
  if (cb >= a.n) return;
  const int npasses = a.npasses[cb];
  if (npasses < 2) return;  // cleanup only: dec stays as it is
  const int W = a.width, H = a.height;
  const Geo g = geometry(W, H);
  const int gs = g.n_gx + 1;  // stride of a significance row
  uint32_t* blk = smem + warp * warp_words(W, H);
  uint32_t* sig = blk + W * H;
  uint32_t* prow = sig + g.sig_words;
  uint32_t* sbuf = prow + gs;
  uint32_t* mbuf = sbuf + g.cap_spp + kBatchWords;
  uint32_t* d = a.dec + static_cast<size_t>(cb) * H * W;
  const int hl = a.h_lim[cb];
  const uint32_t pu = static_cast<uint32_t>(a.p[cb]);
  // 16-byte moves when the codeblock is a whole number of them (dec comes
  // from the allocator, 256-byte aligned)
  const bool vec = ((W * H) & 3) == 0;

  // phase A: the samples, then the cleanup significance of rows below
  // min(h_lim, H)
  for (int i = lane; i < g.sig_words + gs; i += 32) sig[i] = 0u;
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(d);
    uint4* b4 = reinterpret_cast<uint4*>(blk);
    for (int i = lane; i < (W * H) >> 2; i += 32) b4[i] = s4[i];
  } else {
    for (int i = lane; i < W * H; i += 32) blk[i] = d[i];
  }
  __syncwarp();
  const int rows = hl < 0 ? 0 : (hl < H ? hl : H);
  for (int i = lane; i < rows * W; i += 32) {
    if (blk[i] != 0u) {
      const int y = i / W, x = i - y * W;
      atomicOr(sig + (y >> 2) * gs + (x >> 2),
               1u << (((x & 3) << 2) | (y & 3)));
    }
  }

  // phase B: the streams
  Src spp, mrp;
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

  // phase C: MagRef, one step (two groups of a stripe) a lane
  if (npasses >= 3) {
    const uint32_t half = shl32(1u, pu - 2u);
    const uint32_t both = shl32(1u, pu - 1u) | half;
    const int steps = g.n_sy * g.n_g2;
    uint32_t base = 0;
    for (int s0 = 0; s0 < steps; s0 += 32) {
      const int s = s0 + lane;
      int sy = 0, g2 = 0;
      uint32_t sig32 = 0;
      if (s < steps) {
        sy = s / g.n_g2;
        g2 = s - sy * g.n_g2;
        const uint32_t* row = sig + sy * gs + 2 * g2;
        sig32 = row[0] | (row[1] << 16);
      }
      const int pc = __popc(sig32);
      const int incl = warp_incl_scan(pc, lane);
      const uint32_t bits = sig32 ? mrp.bits32(base + incl - pc) : 0u;
      base += static_cast<uint32_t>(__shfl_sync(kFull, incl, 31));
      uint32_t m = sig32;
      for (int k = 0; m; ++k) {
        const int pos = __ffs(m) - 1;
        m &= m - 1u;
        const int y = 4 * sy + (pos & 3), x = 8 * g2 + (pos >> 2);
        blk[y * W + x] ^= ((bits >> k) & 1u) ? half : both;
      }
    }
  }

  // phase D: SigProp, one lane
  if (lane == 0)
    sigprop(spp, sig, prow, blk, g, W, H, hl, pu, a.causal[cb] != 0);
  __syncwarp();

  // phase E: the samples back
  if (vec) {
    const uint4* b4 = reinterpret_cast<const uint4*>(blk);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    for (int i = lane; i < (W * H) >> 2; i += 32) d4[i] = b4[i];
  } else {
    for (int i = lane; i < W * H; i += 32) d[i] = blk[i];
  }
}

// ---- launch ----

template <bool RAW>
int launch(const Args& a, int per_block, cudaStream_t stream) {
  if (a.n <= 0) return static_cast<int>(cudaGetLastError());
  if (a.width < 1 || a.height < 1 || (!RAW && (a.ws < 1 || a.wm < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t per_warp =
      static_cast<size_t>(warp_words(a.width, a.height)) * 4;
  int k = per_block > 0 ? (per_block < 32 ? per_block : 32) : 1;
  while (k > 1 && k * per_warp > static_cast<size_t>(optin)) --k;
  const size_t smem = k * per_warp;
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(ht_refine_kernel<RAW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (a.n + k - 1) / k;
  ht_refine_kernel<RAW><<<grid, 32 * k, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ojr

extern "C" {

// Dense mode: dec [n, height, width] uint32, refined in place; spp / mrp
// [n, ws | wm] uint32 rows; p, npasses, h_lim, causal [n] int32; per_block
// codeblocks (warps) per CUDA block.  Returns the CUDA error code of the
// launch (0 on success).
int ht_refine_decode_dense(void* dec, const void* spp, const void* mrp,
                           int ws, int wm, const void* p,
                           const void* npasses, const void* h_lim,
                           const void* causal, int n, int width, int height,
                           int per_block, void* stream) {
  ojr::Args a{};
  a.dec = static_cast<uint32_t*>(dec);
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
  return ojr::launch<false>(a, per_block, static_cast<cudaStream_t>(stream));
}

// Raw mode: blob [blob_bytes] uint8; lane i's refinement segment is
// blob[roff[i] : roff[i] + len2[i]] (roff, len2 [n] int32).
int ht_refine_decode_raw(void* dec, const void* blob, long long blob_bytes,
                         const void* roff, const void* len2, const void* p,
                         const void* npasses, const void* h_lim,
                         const void* causal, int n, int width, int height,
                         int per_block, void* stream) {
  ojr::Args a{};
  a.dec = static_cast<uint32_t*>(dec);
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
  return ojr::launch<true>(a, per_block, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
