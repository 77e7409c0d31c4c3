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
// What bounds it.  Not bytes: the 2048x1080 gray frame's 604 lanes read
// 8.9 MB of samples (their rows below each lane's height) and write 0.14
// MB of segments, under 3 microseconds of HBM time.  SigProp is serial over a codeblock: a group's
// candidates depend on the new significance of the group to its left and
// of the stripe above, and inside a group each decision makes the samples
// after it candidates.  In an encoder every decision's bit is known before
// the chain starts, so the chain carries only significance masks and the
// bits it emits; its length, 256 groups on a 64x64 block, sets the time.
// This first version is simple: no table step, one lane on the chain.
//
// Design: one warp per codeblock, PER_BLOCK codeblocks a CUDA block, each
// warp with its own shared memory.
//   Phase A (the warp, a column a lane): the rows below h_lim read once,
//     coalesced, a stripe's four rows of 32 columns at a time; per sample
//     its cleanup significance (mag >> p != 0), its plane p - 1 bit and
//     its sign, each a nibble a column, ORed across the group's four
//     lanes by shuffles into three 16-bit words a 4x4 group (bit 4*col +
//     row, block_refine.sig_pack's layout), the significance padded with
//     a zero row and column.
//   Phase B (the warp, MagRef): in stripe, column, row order a bit per
//     cleanup-significant sample; MagRef's order is fixed by significance
//     alone, so a warp scan of each column's significance count places the
//     bits, ORed into shared words (unstuffed, LSB-first).
//   Phase C (lane 0, SigProp's chain): the groups in order, as
//     encode_spp_mrp visits them: the candidate mask from the cleanup
//     significance of the group, its right neighbour and the stripe below
//     (unless causal), the stripe above's new significance and the left
//     group's; the candidates in order by find-first-set, each emitting
//     its plane bit and, where it is 1, spreading to the samples after it;
//     then the signs of the samples that turned significant.  Bits go to
//     shared words through a 64-bit accumulator.
//   Phase D (lane 0): both packers' byte-serial stuffing, reading the
//     unstuffed words a byte at a time into shared bytes.
//   Phase E (the warp): the segment written coalesced, a word a lane, the
//     MagRef bytes read back to front; the counts and the flag.
// The kernel launches on the caller's stream and allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace ojre {

constexpr unsigned kFull = 0xFFFFFFFFu;

// the candidate-spread mask of group bit position pos = 4*col + row: same
// column rows row..row+1, next column rows row-1..row+1
// (encoder.py _SPP_SPREAD shifted to the column)
__constant__ uint32_t kSpread[16] = {
    0x33u,      0x76u,      0xECu,      0xC8u,      0x33u << 4,  0x76u << 4,
    0xECu << 4, 0xC8u << 4, 0x33u << 8, 0x76u << 8, 0xECu << 8,  0xC8u << 8,
    0x33u << 12, 0x76u << 12, 0xECu << 12, 0xC8u << 12};

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
struct Layout {
  int n_sy, n_gx;
  int sig, bit, sgn, prow, spp_w, mrp_w, spp_b, mrp_b;  // word offsets
  int spp_words, mrp_words, spp_cap, mrp_cap;  // sizes (bytes for caps)
  int words;                                   // total
};

__host__ __device__ inline Layout layout(int width, int height) {
  Layout l;
  l.n_sy = (height + 3) >> 2;
  l.n_gx = (width + 3) >> 2;
  const int groups = l.n_sy * l.n_gx;
  const int samples = width * height;
  // unstuffed bits: SigProp at most two a sample, MagRef one; two spare
  // words each for the reader's window
  l.spp_words = (2 * samples + 31) / 32 + 2;
  l.mrp_words = (samples + 31) / 32 + 2;
  // stuffed bytes: at least 7 bits a byte, plus the partial last
  l.spp_cap = (2 * samples + 6) / 7 + 2;
  l.mrp_cap = (samples + 6) / 7 + 2;
  l.sig = 0;
  l.bit = l.sig + (l.n_sy + 1) * (l.n_gx + 1);
  l.sgn = l.bit + groups;
  l.prow = l.sgn + groups;
  l.spp_w = l.prow + l.n_gx + 1;
  l.mrp_w = l.spp_w + l.spp_words;
  l.spp_b = l.mrp_w + l.mrp_words;
  l.mrp_b = l.spp_b + (l.spp_cap + 3) / 4;
  l.words = l.mrp_b + (l.mrp_cap + 3) / 4;
  return l;
}

// LSB-first bit writer into shared words (one lane).
struct BitSink {
  uint32_t* w;
  unsigned long long acc;
  int nacc, wi, total;
  __device__ void put(uint32_t val, int len) {
    if (len == 0) return;
    acc |= static_cast<unsigned long long>(val) << nacc;
    nacc += len;
    total += len;
    if (nacc >= 32) {
      w[wi++] = static_cast<uint32_t>(acc);
      acc >>= 32;
      nacc -= 32;
    }
  }
  __device__ void flush() {
    if (nacc > 0) w[wi] = static_cast<uint32_t>(acc);
  }
};

// Stuffed bytes of nbits LSB-first bits in w (zero past them), in emission
// order: 8 bits a byte, or 7 where the packer's rule says so.  MagRef
// (``mrp``): the last byte above 0x8F (the first byte counts as such) and
// the next 7 bits all ones; SigProp: the last byte 0xFF.  Returns the byte
// count; bytes past ``cap`` are counted, not stored.
__device__ int stuff(const uint32_t* w, int nbits, bool mrp, uint8_t* dst,
                     int cap) {
  int pos = 0, nb = 0;
  uint32_t last = mrp ? 1u : 0u;
  while (pos < nbits) {
    const int wi = pos >> 5;
    const unsigned long long two =
        (static_cast<unsigned long long>(w[wi + 1]) << 32) | w[wi];
    const uint32_t win = static_cast<uint32_t>(two >> (pos & 31)) & 0xFFu;
    const bool seven = mrp ? (last != 0 && (win & 0x7Fu) == 0x7Fu)
                           : (last == 0xFFu);
    const uint32_t byte = seven ? (win & 0x7Fu) : win;
    if (nb < cap) dst[nb] = static_cast<uint8_t>(byte);
    ++nb;
    last = mrp ? static_cast<uint32_t>(byte > 0x8Fu) : byte;
    pos += seven ? 7 : 8;
  }
  return nb;
}

// The plane bits of a column nibble at its significant rows, packed from
// bit 0 in row order.
__device__ __forceinline__ uint32_t pext4(uint32_t bits, uint32_t mask) {
  uint32_t v = 0;
  int k = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if ((mask >> r) & 1u) v |= ((bits >> r) & 1u) << k++;
  return v;
}

__global__ void ht_refine_encode_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cb = blockIdx.x * (blockDim.x >> 5) + warp;
  if (cb >= a.n) return;  // the whole warp leaves together
  const Layout L = layout(a.width, a.height);
  uint32_t* s = smem + warp * L.words;
  uint32_t* sig = s + L.sig;
  uint32_t* bit = s + L.bit;
  uint32_t* sgn = s + L.sgn;
  uint32_t* prow = s + L.prow;
  uint32_t* spp_w = s + L.spp_w;
  uint32_t* mrp_w = s + L.mrp_w;
  uint8_t* spp_b = reinterpret_cast<uint8_t*>(s + L.spp_b);
  uint8_t* mrp_b = reinterpret_cast<uint8_t*>(s + L.mrp_b);
  const int np = a.npasses[cb];
  const bool do_spp = np >= 2, do_mrp = np >= 3;
  int spp_n = 0, mrp_n = 0;

  if (do_spp) {
    const int p = min(max(a.p[cb], 1), 31);
    const int h_lim = a.h_lim[cb];
    const int rows = min(h_lim, a.hp);
    for (int i = lane; i < L.mrp_b; i += 32) s[i] = 0;
    __syncwarp();

    // ---- Phase A: three 16-bit words a group -----------------------------
    const uint32_t* src = a.buf + static_cast<size_t>(cb) * a.hp * a.wp;
    for (int sy = 0; sy < L.n_sy; ++sy) {
      for (int x0 = 0; x0 < a.width; x0 += 32) {
        const int x = x0 + lane;
        uint32_t ns = 0, nbit = 0, nsg = 0;
        if (x < a.width) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int y = 4 * sy + r;
            if (y < rows) {
              const uint32_t v = src[static_cast<size_t>(y) * a.wp + x];
              const uint32_t mag = v & 0x7FFFFFFFu;
              ns |= static_cast<uint32_t>((mag >> p) != 0) << r;
              nbit |= ((mag >> (p - 1)) & 1u) << r;
              nsg |= (v >> 31) << r;
            }
          }
        }
        const int sh = 4 * (x & 3);
        ns <<= sh;
        nbit <<= sh;
        nsg <<= sh;
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          ns |= __shfl_xor_sync(kFull, ns, o);
          nbit |= __shfl_xor_sync(kFull, nbit, o);
          nsg |= __shfl_xor_sync(kFull, nsg, o);
        }
        if ((x & 3) == 0 && x < a.width) {
          const int g = x >> 2;
          sig[sy * (L.n_gx + 1) + g] = ns;
          bit[sy * L.n_gx + g] = nbit;
          sgn[sy * L.n_gx + g] = nsg;
        }
      }
    }
    __syncwarp();

    // ---- Phase B: MagRef's bits, placed by a warp scan -------------------
    if (do_mrp) {
      int base = 0;
      for (int sy = 0; sy < L.n_sy; ++sy) {
        for (int x0 = 0; x0 < a.width; x0 += 32) {
          const int x = x0 + lane;
          uint32_t cnt = 0, val = 0;
          if (x < a.width) {
            const int g = x >> 2, sh = 4 * (x & 3);
            const uint32_t m = (sig[sy * (L.n_gx + 1) + g] >> sh) & 0xFu;
            val = pext4((bit[sy * L.n_gx + g] >> sh) & 0xFu, m);
            cnt = __popc(m);
          }
          uint32_t inc = cnt;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const uint32_t t = __shfl_up_sync(kFull, inc, o);
            if (lane >= o) inc += t;
          }
          const int pos = base + static_cast<int>(inc - cnt);
          if (cnt) {
            atomicOr(&mrp_w[pos >> 5], val << (pos & 31));
            if ((pos & 31) + static_cast<int>(cnt) > 32)
              atomicOr(&mrp_w[(pos >> 5) + 1], val >> (32 - (pos & 31)));
          }
          base += static_cast<int>(__shfl_sync(kFull, inc, 31));
        }
      }
      mrp_n = base;  // the bit count, for now
    }
    __syncwarp();

    if (lane == 0) {
      // ---- Phase C: SigProp's chain --------------------------------------
      BitSink out{spp_w, 0ull, 0, 0, 0};
      for (int sy = 0; sy < L.n_sy; ++sy) {
        const int rl = h_lim - 4 * sy;
        if (rl <= 0) break;
        const uint32_t pattern0 =
            rl >= 4 ? 0xFFFFu : rl == 3 ? 0x7777u : rl == 2 ? 0x3333u
                                                            : 0x1111u;
        const uint32_t* srow = sig + sy * (L.n_gx + 1);
        const uint32_t* nrow = srow + (L.n_gx + 1);
        uint32_t prev = 0;
        for (int gx = 0; gx < L.n_gx; ++gx) {
          const int over = 4 * gx + 4 - a.width;
          const uint32_t pattern = pattern0 >> (4 * (over > 0 ? over : 0));
          const uint32_t cs = srow[gx] | (srow[gx + 1] << 16);
          const uint32_t nsig = nrow[gx] | (nrow[gx + 1] << 16);
          const uint32_t ps = prow[gx] | (prow[gx + 1] << 16);
          uint32_t u = (ps & 0x88888888u) >> 3;
          if (!a.causal) u |= (nsig & 0x11111111u) << 3;
          uint32_t mbr = cs | ((cs & 0x77777777u) << 1) |
                         ((cs & 0xEEEEEEEEu) >> 1) | u;
          mbr |= (mbr << 4) | (mbr >> 4);
          mbr |= prev >> 12;
          const uint32_t inv = ~cs & pattern;
          uint32_t pend = mbr & inv;  // candidates not yet visited
          uint32_t news = 0;          // those that turned significant
          if (pend) {
            const uint32_t bw = bit[sy * L.n_gx + gx];
            uint32_t dv = 0;
            int dn = 0;
            while (pend) {
              const int pos = __ffs(pend) - 1;
              pend &= pend - 1;
              const uint32_t b = (bw >> pos) & 1u;
              dv |= b << dn++;
              if (b) {
                news |= 1u << pos;
                // the spread reaches only later positions (and itself)
                pend |= kSpread[pos] & inv & ~((2u << pos) - 1u);
              }
            }
            out.put(dv, dn);
            // the signs of the new significant samples, in position order
            const uint32_t sw = sgn[sy * L.n_gx + gx];
            uint32_t sv = 0;
            int sn = 0;
            for (uint32_t m = news; m; m &= m - 1)
              sv |= ((sw >> (__ffs(m) - 1)) & 1u) << sn++;
            out.put(sv, sn);
          }
          const uint32_t full = (news | cs) & 0xFFFFu;
          prow[gx] = full;
          const uint32_t n16 =
              full | ((full & 0x7777u) << 1) | ((full & 0xEEEEu) >> 1);
          prev = (n16 | u) & 0xF000u;
        }
      }
      out.flush();
      // ---- Phase D: stuffing ---------------------------------------------
      spp_n = stuff(spp_w, out.total, false, spp_b, L.spp_cap);
      mrp_n = do_mrp ? stuff(mrp_w, mrp_n, true, mrp_b, L.mrp_cap) : 0;
    }
    spp_n = __shfl_sync(kFull, spp_n, 0);
    mrp_n = __shfl_sync(kFull, mrp_n, 0);
    __syncwarp();
  }

  // ---- Phase E: the segment, a word a lane -------------------------------
  const int total = spp_n + mrp_n;
  uint32_t* dst = a.out + static_cast<size_t>(cb) * a.cap;
  for (int j = lane; j < a.cap; j += 32) {
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
  if (lane == 0) {
    a.lens[2 * cb] = spp_n;
    a.lens[2 * cb + 1] = mrp_n;
    a.ovf[cb] = total > 4 * a.cap;
  }
}

}  // namespace ojre

extern "C" {

// buf [n, hp, wp] uint32 (hp >= height, wp >= width); p, h_lim, npasses
// [n] int32; causal 0 / 1; out [n, cap] uint32 (every word is written);
// lens [n, 2] int32 (SigProp bytes, MagRef bytes); ovf [n] uint8.
// ``per_block``: codeblocks (warps) a CUDA block, clamped to [1, 32] and
// to the shared memory.  Returns the CUDA error code of the launch (0 on
// success).
int ht_refine_encode(const void* buf, int hp, int wp, const void* p,
                     const void* h_lim, const void* npasses, int causal,
                     void* out, int cap, void* lens, void* ovf, int n,
                     int width, int height, int per_block, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (width < 1 || height < 1 || hp < height || wp < width || cap < 0)
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
  int k = per_block > 0 ? (per_block < 32 ? per_block : 32) : 1;
  while (k > 1 && k * per_cb > static_cast<size_t>(optin)) --k;
  const size_t smem = k * per_cb;
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(ojre::ht_refine_encode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n + k - 1) / k;
  ojre::ht_refine_encode_kernel<<<grid, 32 * k, smem,
                                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
