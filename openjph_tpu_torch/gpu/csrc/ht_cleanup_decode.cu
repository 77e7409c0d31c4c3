// HT cleanup-pass block decoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package,
// openjph_tpu/tpu/block_decode_pallas.py::_make_kernel (pallas_call in
// _run_pallas), in both of its reader modes:
//   dense (decode_cleanup_pallas): MEL / VLC / MagSgn arrive as dense,
//     host-unstuffed, LSB-first uint32 words, one row per codeblock;
//   raw (decode_cleanup_pallas_raw): the readers take each codeblock's
//     stuffed bytes straight from the packed segment blob and unstuff
//     them on the fly (MagSgn forward, MEL forward, VLC backward from
//     the end of the shared suffix), like the reference's frwd_struct32 /
//     dec_mel_st / rev_struct (ojph_block_decoder32.cpp:63-723).
// Semantics are those of tpu/block_decode.py::decode_cleanup_core: the
// same p = 30 - missing_msbs, the same per-lane quad-row limit qhl
// (errors only below it), the same error flag (U_q > missing_msbs + 2).
// Rows at or past 2*qhl are not decoded; they are written as zeros.
//
// Design.  One thread decodes one codeblock: its three readers keep a
// 64-bit LSB-first window each and read global memory directly, and the
// quad rows loop inside the thread (the TPU grid's sequential axis).
// The VLC and UVLC decode tables (2,624 words) are loaded into shared
// memory once per block; each thread's row scratch (significance of the
// row above, its exponents) lives in shared memory, strided by thread
// so a warp's accesses fall in distinct banks.  The kernel launches on
// the caller's stream and allocates nothing.
//
// What bounds it.  Not bytes: a 2048x1080 gray frame moves about 1 MB
// of coded bytes in and 12.6 MB of samples out (768 lanes of 64x64),
// a few microseconds of HBM time.  The decode of one block is a serial
// chain (every quad's table index depends on the bits the previous
// quad consumed), so the time is the latency of ~1,024 dependent quad
// steps of one thread, and that frame has only 572 live blocks: far
// fewer threads than the card holds.  The bound is per-lane serial
// parsing; the launch puts few lanes in each block (THREADS in the
// wrapper) so that divergent lanes do not serialise one warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace ojk {

constexpr int kVlcEntries = 2048;   // dec_vlc0 | dec_vlc1
constexpr int kUvlcEntries = 576;   // dec_uvlc0 (320) | dec_uvlc1 (256)
constexpr int kTableWords = kVlcEntries + kUvlcEntries;
constexpr int kSharedBudget = 48 * 1024;

enum { kMs = 0, kMel = 1, kVlc = 2 };

__device__ __forceinline__ uint32_t shl32(uint32_t v, uint32_t n) {
  return n >= 32u ? 0u : v << n;
}

__device__ __forceinline__ uint32_t lowmask(uint32_t n) {
  return n >= 32u ? 0xFFFFFFFFu : (1u << n) - 1u;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ uint32_t bitrev8(uint32_t b) {
  b = ((b & 0xF0u) >> 4) | ((b & 0x0Fu) << 4);
  b = ((b & 0xCCu) >> 2) | ((b & 0x33u) << 2);
  return ((b & 0xAAu) >> 1) | ((b & 0x55u) << 1);
}

// LSB-first bit window; holds at most 63 valid bits.
struct Window {
  uint64_t bits;
  int nb;
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
  __device__ __forceinline__ void push(uint32_t v, int cnt) {
    bits |= static_cast<uint64_t>(v) << nb;
    nb += cnt;
  }
};

// Dense mode: one refill adds one word when fewer than 32 bits remain;
// reads past the row clamp onto its last (guard) word.
struct DenseStream {
  const uint32_t* row;
  int nwords;
  int wi;
  __device__ __forceinline__ void refill(Window& w) {
    if (w.nb < 32) {
      const int i = wi < nwords - 1 ? wi : nwords - 1;
      w.push(__ldg(row + i), 32);
      ++wi;
    }
  }
};

// Raw mode: bytes are unstuffed one at a time until 32 bits are held.
template <int KIND>
struct RawStream {
  const uint8_t* base;  // first byte read (VLC: the last byte of its range)
  int n;                // bytes in the stream
  int pos;
  uint32_t pb;          // previous raw byte
  uint32_t fl;          // previous byte dropped a bit (it carries)

  __device__ __forceinline__ void next(uint32_t& v, int& c) {
    c = 8;
    if (pos >= n) {
      v = KIND == kVlc ? 0u : 0xFFu;
    } else if (KIND == kMs) {
      const uint32_t b = __ldg(base + pos);
      const bool stuffed = pos > 0 && pb == 0xFFu;
      v = b | (fl ? (pb >> 7) & 1u : 0u);
      if (stuffed) {
        v &= 0x7Fu;
        c = 7;
      }
      fl = stuffed;
      pb = b;
    } else if (KIND == kMel) {
      const uint32_t b = __ldg(base + pos);
      const bool stuffed = pos > 0 && pb == 0xFFu;
      v = bitrev8(b);
      if (stuffed) {
        v >>= 1;
        c = 7;
      }
      pb = b;
    } else {
      const uint32_t b = __ldg(base - pos);
      const bool last = pos == n - 1;
      v = b | (fl ? (pb >> 7) & 1u : 0u);
      bool dang;
      if (pos == 0) {
        dang = ((b >> 4) & 7u) == 7u;
        if (dang && !last) {
          v = (v >> 4) & 7u;
          c = 3;
        } else {
          v >>= 4;
          c = 4;
        }
      } else {
        dang = pb > 0x8Fu && (b & 0x7Fu) == 0x7Fu;
        if (dang && !last) {
          v &= 0x7Fu;
          c = 7;
        }
      }
      fl = dang;
      pb = b;
    }
    ++pos;
  }

  __device__ __forceinline__ void refill(Window& w) {
    while (w.nb < 32) {
      uint32_t v;
      int c;
      next(v, c);
      w.push(v, c);
    }
  }
};

// Per-thread scratch row in shared memory: element j at p[j * stride].
struct Row {
  uint32_t* p;
  int stride;
  __device__ __forceinline__ uint32_t& operator[](int j) const {
    return p[j * stride];
  }
};

// MEL run decode (dec_mel_st); exponent table {0,0,0,1,1,1,2,2,2,3,3,4,5}.
__device__ __forceinline__ int mel_get_run(Window& mel, int& mel_k) {
  const int k = clampi(mel_k, 0, 12);
  const int eva = k >= 11 ? k - 7 : (k / 3 < 3 ? k / 3 : 3);
  if (mel.take(1) == 1u) {
    mel_k = mel_k + 1 < 12 ? mel_k + 1 : 12;
    return ((1 << eva) - 1) << 1;
  }
  const uint32_t vrev = mel.take(eva);
  uint32_t v = 0;
  for (int i = 0; i < eva; ++i) v |= ((vrev >> i) & 1u) << (eva - 1 - i);
  mel_k = mel_k - 1 > 0 ? mel_k - 1 : 0;
  return static_cast<int>(v << 1) + 1;
}

// Decode one codeblock into out [height, width]; returns the error flag.
template <class MelR, class VlcR, class MsR>
__device__ bool decode_lane(MelR& melr, VlcR& vlcr, MsR& msr,
                            const uint32_t* vlc_tbl, const uint32_t* uvlc_tbl,
                            uint32_t p, int qhl, int width, int height,
                            Row inf_prev, Row inf_cur, Row scr, Row newv,
                            uint32_t* __restrict__ out) {
  const int qw = (width + 1) >> 1;
  const int qh = (height + 1) >> 1;
  const int rows = qhl < qh ? (qhl > 0 ? qhl : 0) : qh;
  const uint32_t mmsbp2 = 32u - p;
  for (int j = 0; j < qw + 3; ++j) inf_prev[j] = inf_cur[j] = 0u;
  for (int j = 0; j < qw + 2; ++j) scr[j] = newv[j] = 0u;
  Window mel{0, 0}, vlc{0, 0}, ms{0, 0};
  bool err = false;
  int mel_k = 0, run = 0;
  if (rows > 0) {
    melr.refill(mel);
    run = mel_get_run(mel, mel_k);  // decoder32.cpp:862
  }
  for (int r = 0; r < rows; ++r) {
    const bool initial = r == 0;
    const int tbl_base = initial ? 0 : 1024;
    const int ubase = initial ? 0 : 320;
    uint32_t c_q = 0, prev_vn = 0;

    // MagSgn for one quad (ojph_block_decoder32.cpp:1089-1316)
    auto quad = [&](int qx, uint32_t q_inf, uint32_t u_q) {
      uint32_t gamma = q_inf & 0xF0u;
      gamma &= gamma - 0x10u;
      const uint32_t emax_v = scr[qx] | scr[qx + 1];
      const uint32_t emax = 31u - static_cast<uint32_t>(
          __clz(static_cast<int>(emax_v | 2u)));
      const uint32_t kappa = gamma != 0u ? emax : 1u;
      const uint32_t U_q = initial ? u_q : u_q + kappa;
      if (U_q > mmsbp2) err = true;
      const bool two_cols = qx * 2 + 1 < width;
      uint32_t v_n1 = 0, v_n3 = 0;
#pragma unroll
      for (int bit = 0; bit < 4; ++bit) {
        const bool sig = ((q_inf >> (4 + bit)) & 1u) != 0u &&
                         (bit < 2 || two_cols);
        msr.refill(ms);
        int m_n = 0;
        if (sig)
          m_n = clampi(static_cast<int>(U_q - ((q_inf >> (12 + bit)) & 1u)),
                       0, 31);
        const uint32_t ms_val = ms.peek();
        ms.adv(m_n);
        uint32_t v_n = 0, val = 0;
        if (sig) {
          v_n = (ms_val & lowmask(m_n)) |
                (((q_inf >> (8 + bit)) & 1u) << m_n) | 1u;
          val = (ms_val << 31) | shl32(v_n + 2u, p - 1u);
        }
        if (bit == 1) v_n1 = v_n;
        if (bit == 3) v_n3 = v_n;
        const int y = 2 * r + (bit & 1);
        const int x = 2 * qx + (bit >> 1);
        if (y < height && x < width) out[y * width + x] = val;
      }
      newv[qx] = prev_vn | v_n1;
      prev_vn = v_n3;
    };

    for (int qx2 = 0; qx2 < qw; qx2 += 2) {
      const bool second = qx2 + 1 < qw;
      vlcr.refill(vlc);
      melr.refill(mel);
      const uint32_t a0 = inf_prev[qx2], a1 = inf_prev[qx2 + 1],
                     a2 = inf_prev[qx2 + 2];
      // first quad of the pair (decoder32.cpp:855-1000)
      if (!initial) c_q |= ((a0 & 0xA0u) << 2) | ((a1 & 0x20u) << 4);
      uint32_t t0 = vlc_tbl[clampi(
          tbl_base + static_cast<int>(c_q + (vlc.peek() & 0x7Fu)), 0,
          kVlcEntries - 1)];
      if (c_q == 0u) {
        run -= 2;
        if (run != -1) t0 = 0u;
        if (run < 0) run = mel_get_run(mel, mel_k);
      }
      inf_cur[qx2] = t0;
      c_q = initial ? (((t0 & 0x10u) << 3) | ((t0 & 0xE0u) << 2))
                    : (((t0 & 0x40u) << 2) | ((t0 & 0x80u) << 1) |
                       (a0 & 0x80u) | ((a1 & 0xA0u) << 2) |
                       ((a2 & 0x20u) << 4));
      vlc.adv(static_cast<int>(t0 & 7u));
      // second quad
      uint32_t t1 = 0u;
      if (second) {
        t1 = vlc_tbl[clampi(
            tbl_base + static_cast<int>(c_q + (vlc.peek() & 0x7Fu)), 0,
            kVlcEntries - 1)];
        if (c_q == 0u) {
          run -= 2;
          if (run != -1) t1 = 0u;
          if (run < 0) run = mel_get_run(mel, mel_k);
        }
      }
      inf_cur[qx2 + 1] = t1;
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
      uint32_t ue = uvlc_tbl[clampi(
          ubase + static_cast<int>(uvlc_mode + (vlc.peek() & 0x3Fu)), 0,
          kUvlcEntries - 1)];
      vlc.adv(static_cast<int>(ue & 7u));
      ue >>= 3;
      const uint32_t tmp = vlc.take(static_cast<int>(ue & 0xFu));
      ue >>= 4;
      const uint32_t len0 = ue & 7u;
      ue >>= 3;
      const uint32_t kappa0 = initial ? 1u : 0u;
      const uint32_t u0 = kappa0 + (ue & 7u) + (tmp & ~(0xFFu << len0));
      quad(qx2, t0, u0);
      if (second) quad(qx2 + 1, t1, kappa0 + (ue >> 3) + (tmp >> len0));
    }
    newv[qw] = prev_vn;
    Row t = inf_prev;
    inf_prev = inf_cur;
    inf_cur = t;
    t = scr;
    scr = newv;
    newv = t;
  }
  for (int y = 2 * rows; y < height; ++y)
    for (int x = 0; x < width; ++x) out[y * width + x] = 0u;
  return err;
}

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
  uint32_t* dec;
  uint8_t* err;
  int n, width, height;
};

__host__ __device__ inline int scratch_words(int width) {
  const int qw = (width + 1) >> 1;
  return 2 * (qw + 3) + 2 * (qw + 2);
}

template <bool RAW>
__global__ void ht_cleanup_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x)
    smem[i] = a.tables[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n) return;
  const int qw = (a.width + 1) >> 1;
  const int tpb = blockDim.x;
  uint32_t* s = smem + kTableWords + threadIdx.x;
  const Row r0{s, tpb};
  const Row r1{s + (qw + 3) * tpb, tpb};
  const Row r2{s + 2 * (qw + 3) * tpb, tpb};
  const Row r3{s + (2 * (qw + 3) + qw + 2) * tpb, tpb};
  uint32_t* out = a.dec + static_cast<size_t>(lane) * a.height * a.width;
  const uint32_t p = static_cast<uint32_t>(a.p[lane]);
  const int qhl = a.qhl[lane];
  const uint32_t* vlc_tbl = smem;
  const uint32_t* uvlc_tbl = smem + kVlcEntries;
  bool err;
  if (RAW) {
    const long long off = a.lane_off[lane];
    const int msn = a.ms_n[lane], shn = a.sh_n[lane];
    if (off < 0 || msn < 0 || shn < 1 ||
        off + msn + shn > a.blob_bytes) {
      // a byte range outside the blob: zeros, flagged
      for (int i = 0; i < a.height * a.width; ++i) out[i] = 0u;
      err = true;
    } else {
      const uint8_t* b = a.blob + off;
      RawStream<kMel> melr{b + msn, shn, 0, 0u, 0u};
      RawStream<kVlc> vlcr{b + msn + shn - 1, shn, 0, 0u, 0u};
      RawStream<kMs> msr{b, msn, 0, 0u, 0u};
      err = decode_lane(melr, vlcr, msr, vlc_tbl, uvlc_tbl, p, qhl, a.width,
                        a.height, r0, r1, r2, r3, out);
    }
  } else {
    DenseStream melr{a.mel + static_cast<size_t>(lane) * a.wm, a.wm, 0};
    DenseStream vlcr{a.vlc + static_cast<size_t>(lane) * a.wv, a.wv, 0};
    DenseStream msr{a.ms + static_cast<size_t>(lane) * a.ws, a.ws, 0};
    err = decode_lane(melr, vlcr, msr, vlc_tbl, uvlc_tbl, p, qhl, a.width,
                      a.height, r0, r1, r2, r3, out);
  }
  a.err[lane] = err ? 1 : 0;
}

// ---- launch ----

template <bool RAW>
int launch(const Args& a, int threads, cudaStream_t stream) {
  if (a.n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t per_thread = static_cast<size_t>(scratch_words(a.width)) * 4;
  const size_t tables = static_cast<size_t>(kTableWords) * 4;
  int tpb = threads > 0 ? threads : 32;
  while (tpb > 1 && tables + tpb * per_thread > kSharedBudget) tpb >>= 1;
  const size_t smem = tables + tpb * per_thread;
  if (smem > kSharedBudget) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (a.n + tpb - 1) / tpb;
  ht_cleanup_kernel<RAW><<<grid, tpb, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ojk

extern "C" {

// Dense mode: mel/vlc/ms [n, wm|wv|ws] uint32 rows.  Returns the CUDA
// error code of the launch (0 on success).
int ht_cleanup_decode_dense(const void* mel, const void* vlc, const void* ms,
                            int wm, int wv, int ws, const void* p,
                            const void* qhl, const void* tables, void* dec,
                            void* err, int n, int width, int height,
                            int threads, void* stream) {
  ojk::Args a{};
  a.mel = static_cast<const uint32_t*>(mel);
  a.vlc = static_cast<const uint32_t*>(vlc);
  a.ms = static_cast<const uint32_t*>(ms);
  a.wm = wm;
  a.wv = wv;
  a.ws = ws;
  a.p = static_cast<const int32_t*>(p);
  a.qhl = static_cast<const int32_t*>(qhl);
  a.tables = static_cast<const uint32_t*>(tables);
  a.dec = static_cast<uint32_t*>(dec);
  a.err = static_cast<uint8_t*>(err);
  a.n = n;
  a.width = width;
  a.height = height;
  return ojk::launch<false>(a, threads, static_cast<cudaStream_t>(stream));
}

// Raw mode: blob [blob_bytes] uint8; lane_off / ms_n / sh_n [n] int32.
int ht_cleanup_decode_raw(const void* blob, long long blob_bytes,
                          const void* lane_off, const void* ms_n,
                          const void* sh_n, const void* p, const void* qhl,
                          const void* tables, void* dec, void* err, int n,
                          int width, int height, int threads, void* stream) {
  ojk::Args a{};
  a.blob = static_cast<const uint8_t*>(blob);
  a.blob_bytes = blob_bytes;
  a.lane_off = static_cast<const int32_t*>(lane_off);
  a.ms_n = static_cast<const int32_t*>(ms_n);
  a.sh_n = static_cast<const int32_t*>(sh_n);
  a.p = static_cast<const int32_t*>(p);
  a.qhl = static_cast<const int32_t*>(qhl);
  a.tables = static_cast<const uint32_t*>(tables);
  a.dec = static_cast<uint32_t*>(dec);
  a.err = static_cast<uint8_t*>(err);
  a.n = n;
  a.width = width;
  a.height = height;
  return ojk::launch<true>(a, threads, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
