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
// Design.  One thread encodes one codeblock: it runs the quad-row loop and,
// inside it, the quad-pair loop, reading its samples with two 16-byte
// loads per pair.  Each stream has one writer: a 64-bit accumulator and a
// word index; bits are appended LSB-first, a word is stored as soon as 32
// bits are complete, and every store is checked against the stream's cap
// (a store past it is dropped and sets the overflow flag).  At the end of
// the block a pending MEL run is terminated with a '1' and each stream's
// partial last word is drained, zero-padded.  The VLC table (4,096 words)
// and the UVLC table (75 rows of prefix, prefix length, suffix, suffix
// length) are loaded into shared memory once per block; each thread's
// context rows (the exponents and significance of the quad row above,
// qw + 4 entries each) live in shared memory as bytes, strided by thread.
// The wrapper zeroes the output, so words past each used prefix are 0; the
// kernel runs on the caller's stream and allocates nothing.  The TPU
// kernel's (S,128) lane tiling, multi-limb windows with their static
// flush schedule, chunked table gathers and VMEM budget have no
// counterpart here.
//
// What bounds it.  Not bytes: the 2048x1080 gray frame's 604 lanes read
// 9.9 MB of samples and write ~1.2 MB of used words, a few microseconds of
// HBM time.  Each lane is a serial chain of pair steps (32 quad rows x 16
// pairs for a 64x64 block, every step's VLC context and MEL state depending
// on the one before), and a frame has 604 lanes: far fewer threads than the
// card holds.  The time is the latency of one lane's chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace oje {

constexpr int kVlcEntries = 4096;  // enc_vlc0 | enc_vlc1
constexpr int kUvlcRows = 75;      // enc_uvlc rows (u_q 0..74)
constexpr int kTableWords = kVlcEntries + 4 * kUvlcRows;
constexpr int kSharedBudget = 48 * 1024;

__device__ __forceinline__ uint32_t lowmask(int n) {
  return n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
}

__device__ __forceinline__ uint32_t shr32(uint32_t v, uint32_t n) {
  return n >= 32u ? 0u : v >> n;
}

__device__ __forceinline__ int mel_exp(int k) {
  return k >= 11 ? k - 7 : (k / 3 < 3 ? k / 3 : 3);
}

// One stream's LSB-first writer.
struct Writer {
  uint32_t* row;  // this lane's words of the stream
  int cap;        // words the stream may hold
  int wi;         // words completed (stored, or dropped past the cap)
  int nb;         // bits held in acc; below 32 between appends
  uint64_t acc;
  bool ovf;

  __device__ __forceinline__ void put(uint32_t w) {
    if (wi < cap) {
      row[wi] = w;
    } else {
      ovf = true;
    }
    ++wi;
  }
  // ln in [0, 31]: at most one word completes per append
  __device__ __forceinline__ void append(uint32_t v, int ln) {
    acc |= static_cast<uint64_t>(v & lowmask(ln)) << nb;
    nb += ln;
    if (nb >= 32) {
      put(static_cast<uint32_t>(acc));
      acc >>= 32;
      nb -= 32;
    }
  }
  __device__ __forceinline__ int bits() const { return wi * 32 + nb; }
  __device__ __forceinline__ void drain() {
    if (nb > 0) put(static_cast<uint32_t>(acc));
  }
};

// MEL run-length coder (MelEnc::encode), one event at a time.
struct Mel {
  Writer w;
  int run;
  int k;  // state, 0..12

  __device__ __forceinline__ void event(bool bit) {
    const int e = mel_exp(k);
    if (!bit) {
      if (++run >= (1 << e)) {
        w.append(1u, 1);
        run = 0;
        k = k < 12 ? k + 1 : 12;
      }
    } else {
      // '0', then the e low bits of the run MSB-first: reversed into
      // LSB-first order
      uint32_t rev = 0;
      for (int i = 0; i < e; ++i)
        rev |= ((static_cast<uint32_t>(run) >> i) & 1u) << (e - 1 - i);
      w.append(rev << 1, 1 + e);
      run = 0;
      k = k > 0 ? k - 1 : 0;
    }
  }
};

struct Args {
  const uint32_t* buf;  // [n, hp, wp] sign-magnitude samples
  const int32_t* p;     // [n] 31 - kmax
  const int32_t* qhl;   // [n] quad-row limit
  const uint32_t* tables;
  uint32_t* cat;        // [n, wm + wv + ws]
  int32_t* bits;        // [n, 3]
  uint8_t* ovf;         // [n]
  int hp, wp, wm, wv, ws;
  int n, width, height;
};

__global__ void ht_cleanup_encode_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x)
    smem[i] = a.tables[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n) return;
  const uint32_t* vlc_tbl = smem;
  const uint32_t* uv_pre = smem + kVlcEntries;
  const uint32_t* uv_plen = uv_pre + kUvlcRows;
  const uint32_t* uv_suf = uv_plen + kUvlcRows;
  const uint32_t* uv_slen = uv_suf + kUvlcRows;

  const int qw = (a.width + 1) >> 1;
  const int qh = (a.height + 1) >> 1;
  const int pairs = (qw + 1) >> 1;
  const int nctx = qw + 4;  // a pair touches context entries 2j .. 2j+3
  const int tpb = blockDim.x;
  uint8_t* ctx = reinterpret_cast<uint8_t*>(smem + kTableWords);
  uint8_t* ev = ctx + threadIdx.x;                // e_val[i] at ev[i*tpb]
  uint8_t* cx = ctx + nctx * tpb + threadIdx.x;   // cx_val[i] at cx[i*tpb]
  for (int i = 0; i < nctx; ++i) {
    ev[i * tpb] = 0;
    cx[i * tpb] = 0;
  }
#define EV(i) ev[(i) * tpb]
#define CX(i) cx[(i) * tpb]

  const uint32_t p = static_cast<uint32_t>(a.p[lane]);
  const int rows = a.qhl[lane] < qh ? a.qhl[lane] : qh;
  uint32_t* out = a.cat + static_cast<size_t>(lane) * (a.wm + a.wv + a.ws);
  Mel mel{Writer{out, a.wm, 0, 0, 0ull, false}, 0, 0};
  Writer vlc{out + a.wm, a.wv, 0, 0, 0ull, false};
  Writer ms{out + a.wm + a.wv, a.ws, 0, 0, 0ull, false};
  const uint32_t* blk = a.buf + static_cast<size_t>(lane) * a.hp * a.wp;

  int c_q = 0, max_e = 0;
  for (int qy = 0; qy < rows; ++qy) {
    const bool init = qy == 0;
    const int tbase = init ? 0 : 2048;
    const uint32_t* top = blk + static_cast<size_t>(2 * qy) * a.wp;
    const uint32_t* bot = top + a.wp;
    for (int j = 0; j < pairs; ++j) {
      const bool second = 2 * j + 1 < qw;
      const int le = 2 * j;
      if (j == 0) {
        max_e = (EV(0) > EV(1) ? EV(0) : EV(1)) - 1;
        c_q = init ? 0 : CX(0) + (CX(1) << 2);
        EV(0) = 0;
        CX(0) = 0;
      }
      // the pair's 2x4 samples in quad order: quad 0 is columns 0-1,
      // quad 1 columns 2-3, each column top sample first
      const uint4 t4 = __ldg(reinterpret_cast<const uint4*>(top + 4 * j));
      const uint4 b4 = __ldg(reinterpret_cast<const uint4*>(bot + 4 * j));
      const uint32_t t[8] = {t4.x, b4.x, t4.y, b4.y, t4.z, b4.z, t4.w, b4.w};
      int e[8];
      uint32_t s[8];
      uint32_t rho0 = 0, rho1 = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        // (t + t) >> p wraps in uint32, which drops the sign bit
        const uint32_t val = shr32(t[k] + t[k], p) & ~1u;
        const bool sig = val != 0u;
        e[k] = sig ? 32 - __clz(static_cast<int>(val - 1u)) : 0;
        s[k] = sig ? (val - 2u) + (t[k] >> 31) : 0u;
        if (k < 4) {
          rho0 |= static_cast<uint32_t>(sig) << k;
        } else {
          rho1 |= static_cast<uint32_t>(sig) << (k - 4);
        }
      }
      if (!second) rho1 = 0;
      const int emax0 = max(max(e[0], e[1]), max(e[2], e[3]));
      const int emax1 = max(max(e[4], e[5]), max(e[6], e[7]));

      // ---- quad 0 ----
      int kappa0 = 1;
      if (!init && (rho0 & (rho0 - 1u)) != 0u) kappa0 = max_e > 1 ? max_e : 1;
      const int uq0 = emax0 > kappa0 ? emax0 : kappa0;
      const int u_q0 = uq0 - kappa0;
      uint32_t eps0 = 0;
      if (u_q0 > 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (e[k] == emax0 && e[k] > 0) eps0 |= 1u << k;
      }
      if (e[1] > EV(le)) EV(le) = static_cast<uint8_t>(e[1]);
      if (!init) max_e = (EV(le + 1) > EV(le + 2) ? EV(le + 1) : EV(le + 2)) - 1;
      EV(le + 1) = static_cast<uint8_t>(e[3]);
      CX(le) = CX(le) | static_cast<uint8_t>((rho0 & 2u) >> 1);
      const int c_q1_base = CX(le + 1) + (CX(le + 2) << 2);
      CX(le + 1) = static_cast<uint8_t>((rho0 & 8u) >> 3);
      const uint32_t tuple0 =
          vlc_tbl[tbase + (c_q << 8) + static_cast<int>(rho0 << 4) + eps0];
      vlc.append(tuple0 >> 8, (tuple0 >> 4) & 7u);
      if (c_q == 0) mel.event(rho0 != 0u);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((rho0 >> k) & 1u) {
          const int m = uq0 - static_cast<int>((tuple0 >> k) & 1u);
          ms.append(s[k], m < 31 ? m : 31);
        }
      }

      // ---- quad 1 (absent when qw is odd and this is the last pair: it
      // then emits nothing and updates no context) ----
      int c_q1, kappa1 = 1;
      if (init) {
        c_q1 = static_cast<int>((rho0 >> 1) | (rho0 & 1u));
      } else {
        c_q1 = c_q1_base | static_cast<int>(((rho0 & 4u) >> 1) |
                                            ((rho0 & 8u) >> 2));
        if ((rho1 & (rho1 - 1u)) != 0u) kappa1 = max_e > 1 ? max_e : 1;
      }
      const int uq1 = emax1 > kappa1 ? emax1 : kappa1;
      const int u_q1 = second ? uq1 - kappa1 : 0;
      int c_q0n = 0;
      if (second) {
        uint32_t eps1 = 0;
        if (u_q1 > 0) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (e[4 + k] == emax1 && e[4 + k] > 0) eps1 |= 1u << k;
        }
        const uint32_t tuple1 =
            vlc_tbl[tbase + (c_q1 << 8) + static_cast<int>(rho1 << 4) + eps1];
        vlc.append(tuple1 >> 8, (tuple1 >> 4) & 7u);
        if (c_q1 == 0) mel.event(rho1 != 0u);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if ((rho1 >> k) & 1u) {
            const int m = uq1 - static_cast<int>((tuple1 >> k) & 1u);
            ms.append(s[4 + k], m < 31 ? m : 31);
          }
        }
        const int ev2 = EV(le + 1) > e[5] ? EV(le + 1) : e[5];
        if (!init)
          max_e = (EV(le + 2) > EV(le + 3) ? EV(le + 2) : EV(le + 3)) - 1;
        c_q0n = CX(le + 2) + (CX(le + 3) << 2);
        EV(le + 1) = static_cast<uint8_t>(ev2);
        EV(le + 2) = static_cast<uint8_t>(e[7]);
        CX(le + 1) = CX(le + 1) | static_cast<uint8_t>((rho1 & 2u) >> 1);
        CX(le + 2) = static_cast<uint8_t>((rho1 & 8u) >> 3);
      }

      // ---- u codes (ojph_block_encoder.cpp:763-785) ----
      const int i0 = u_q0 < 74 ? u_q0 : 74;
      const int i1 = u_q1 < 74 ? u_q1 : 74;
      if (init && u_q0 > 0 && u_q1 > 0) mel.event(min(u_q0, u_q1) > 2);
      if (init && u_q0 > 2 && u_q1 > 2) {
        const int a0 = min(u_q0 - 2, 74), a1 = min(u_q1 - 2, 74);
        vlc.append(uv_pre[a0], uv_plen[a0]);
        vlc.append(uv_pre[a1], uv_plen[a1]);
        vlc.append(uv_suf[a0], uv_slen[a0]);
        vlc.append(uv_suf[a1], uv_slen[a1]);
      } else if (init && u_q0 > 2 && u_q1 > 0) {
        vlc.append(uv_pre[i0], uv_plen[i0]);
        vlc.append(static_cast<uint32_t>(u_q1 - 1), 1);
        vlc.append(uv_suf[i0], uv_slen[i0]);
      } else {
        vlc.append(uv_pre[i0], uv_plen[i0]);
        vlc.append(uv_pre[i1], uv_plen[i1]);
        vlc.append(uv_suf[i0], uv_slen[i0]);
        vlc.append(uv_suf[i1], uv_slen[i1]);
      }

      // next pair's context
      if (init) {
        c_q = second ? static_cast<int>((rho1 >> 1) | (rho1 & 1u)) : 0;
      } else {
        c_q = second ? c_q0n | static_cast<int>(((rho1 & 4u) >> 1) |
                                                ((rho1 & 8u) >> 2))
                     : c_q1_base;
      }
    }
  }
#undef EV
#undef CX

  if (mel.run > 0) mel.w.append(1u, 1);  // ojph_block_encoder.cpp:412
  a.bits[3 * lane + 0] = mel.w.bits();
  a.bits[3 * lane + 1] = vlc.bits();
  a.bits[3 * lane + 2] = ms.bits();
  mel.w.drain();
  vlc.drain();
  ms.drain();
  a.ovf[lane] = (mel.w.ovf || vlc.ovf || ms.ovf) ? 1 : 0;
}

}  // namespace oje

extern "C" {

// buf [n, hp, wp] uint32 (16-byte aligned rows: wp a multiple of 4);
// p, qhl [n] int32; tables: enc_vlc0|1 (4,096) then enc_uvlc's prefix,
// prefix length, suffix and suffix length columns (75 each); cat
// [n, wm + wv + ws] uint32, zeroed by the caller; bits [n, 3] int32;
// ovf [n] uint8.  ``threads`` codeblocks per CUDA block.  Returns the CUDA
// error code of the launch (0 on success).
int ht_cleanup_encode(const void* buf, int hp, int wp, const void* p,
                      const void* qhl, const void* tables, void* cat, int wm,
                      int wv, int ws, void* bits, void* ovf, int n, int width,
                      int height, int threads, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  oje::Args a{};
  a.buf = static_cast<const uint32_t*>(buf);
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
  const size_t per_thread = 2 * static_cast<size_t>(((width + 1) >> 1) + 4);
  const size_t tables_bytes = static_cast<size_t>(oje::kTableWords) * 4;
  int tpb = threads > 0 ? threads : 32;
  while (tpb > 1 && tables_bytes + tpb * per_thread > oje::kSharedBudget)
    tpb >>= 1;
  const size_t smem = tables_bytes + tpb * per_thread;
  if (smem > oje::kSharedBudget)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + tpb - 1) / tpb;
  oje::ht_cleanup_encode_kernel<<<grid, tpb, smem,
                                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
