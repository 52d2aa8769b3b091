// GQA flash attention with a key band per query row, reading K and V in
// place (the chunked-prefill drain's chunk-row attention).
//
// Replaces: bergen_tpu/ops/flash_attention.py::flash_attention_band (:252,
// Pallas body _flash_kernel_band).  Query row i of head h (KV head h /
// group) attends keys [lo_i, hi_i) of one cache row; over its key tiles it
// computes, in base 2 as wgmma_attention.cuh's loop does,
//   y = q.k * scale * log2 e, and -inf outside the band (keys at or past
//       Sk are outside every band);
//   m' = max(m, rowmax y) from m = -1e30, p = 2^(y - m') (exactly 0
//       outside the band), a = 2^(m - m'),
//   l' = l * a + rowsum p, acc' = acc * a + bf16(p) . V,
// then out = acc / max(l, 1e-30) in bf16: the TPU kernel's rule, whose hard
// zeroing makes a row with an empty band output exact zeros (l stays 0 and
// acc 0; the drain's inactive chunk rows), where the prefill kernel's rows
// average V.  A -inf running max would make 2^(-inf - -inf) NaN; -1e30
// keeps every factor finite.
//
// What bounds it on the H100: the bytes of the keys the bands cover (K and
// V rows of KH*Dh bf16 each: 4 MB for 1,024 keys at Mistral-7B width) and
// of q and out, against 4 * H * Dh operations per in-band (row, key) pair;
// a drain step's 128 chunk rows do ~1.5 GFLOP, so both bounds are about a
// microsecond, and latency decides.  Design: the band runs on
// wgmma_attention.cuh's warp-specialised loop (TMA producer, two consumer
// warpgroups of 64 rows with S by SS wgmma and P.V by RS wgmma, ping-pong
// between them) under BandPolicy:
// * a unit is one (128-row query tile, head); units walk the heads of a
//   query tile fastest, so a KV head's tiles come from L2 for the group's
//   other heads;
// * a tile attends the 128-key tiles from the first that holds an in-band
//   key of any of its rows to the end of its rows' band union: the union
//   is reduced on the card from the tile's 128 bands by every warp that
//   walks the units (a warp-wide min / max in tile(); the producer's whole
//   warp walks for it), and a tile whose bands are all empty attends one
//   key tile past Sk, which TMA fills with zeros without reading memory,
//   so it loads no K/V and stores zeros;
// * each consumer thread reads its two rows' bands a tile ahead (prefetch)
//   and masks its scores per (row, key) against them (scores); the loop's
//   per-key mask bits cannot express a band;
// * head widths 64, 128 and 256; at 256 (Gemma's) the tiles are 64 keys,
//   one query slot, and the output goes from registers (wgmma_attention.cuh);
// * K and V are read in place through one tensor map over every row of the
//   cache ([rows, L, KH*Dh], the row the TMA batch coordinate), so the
//   drain's calls, one per (layer, staging pipe), hit the map cache rather
//   than encode a map for each cache row.
#include "wgmma_attention.cuh"

namespace {

template <int DH_>
struct BandPolicy {
  // head width 256: one query slot and two stages of 64-key K and V
  // (192 KiB), the output stored from registers (o_row)
  static constexpr int DH = DH_, BK = DH_ == 256 ? 64 : 128;
  static constexpr int STAGES = DH_ == 64 ? 4 : 2;
  static constexpr int QS = DH_ == 256 ? 1 : 2;
  static constexpr bool SPLIT = false;
  static constexpr int XB = 0;
  static constexpr bool WARP_TILE = true;
  __device__ static float m_init() { return -1e30f; }
  static constexpr bool CLAMP_L = true;
  struct Pre {  // the thread's two rows' bands, [lo, hi) with hi <= Sk
    int lo[2], hi[2];
  };
  CUtensorMap tq, tk, tv, to;
  const int2* band;  // [Sq] (lo, hi)
  bf16* out;         // [Sq, H, DH]
  int Sq, Sk, H, group, n_qt, kv_b;
  float scale;

  __host__ __device__ int n_units() const { return n_qt * H; }
  __device__ int n_qtiles(int) const { return 1; }
  // unit u: query tile u / H, head u % H.  Called by whole warps: lane l
  // reads rows 4l .. 4l + 3 of the tile's bands
  __device__ AttTile tile(int u, int) const {
    const int h = u % H, q0 = u / H * AT_BQ;
    const int lane = threadIdx.x & 31;
    int lo = Sk, hi = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + 4 * lane + r;
      if (row < Sq) {
        const int2 b = band[row];
        const int l = max(b.x, 0), e = min(b.y, Sk);
        if (l < e) {
          lo = min(lo, l);
          hi = max(hi, e);
        }
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    // every band empty: one key tile past the keys, read as zeros
    const int k0 = lo < hi ? lo / BK : (Sk + BK - 1) / BK;
    const int n_kt = lo < hi ? (hi + BK - 1) / BK - k0 : 1;
    return {kv_b, h, h / group, q0, n_kt, k0};
  }
  __device__ int3 q_box(const AttTile& t, int r) const {
    return make_int3(t.qh * DH, t.q0 + 64 * r, 0);
  }
  __device__ int3 kv_box(const AttTile& t, int j, int h) const {
    return make_int3(t.kvh * DH, (t.k0 + j) * BK + 64 * h, t.b);
  }
  __device__ bool key_ok(const AttTile&, int) const { return true; }
  __device__ void load_extra(void*, uint64_t*, const AttTile&, int) const {}
  // this thread's rows 16 warp + lane / 4 (+ 8) of the warpgroup's 64
  __device__ void prefetch(Pre& pre, const AttTile& t, int, int wg, int warp,
                           int lane) const {
    const int r0 = t.q0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      const int2 b = row < Sq ? band[row] : make_int2(0, 0);
      pre.lo[i] = b.x;
      pre.hi[i] = min(b.y, Sk);
    }
  }
  // y = q.k * scale * log2 e inside the row's band, -inf outside it
  template <int N>
  __device__ void scores(float (&s)[N], const uint32_t (&)[N / 16],
                         const unsigned char*, const Pre& pre,
                         const AttTile& t, int j, int, int,
                         int lane) const {
    const int k0 = (t.k0 + j) * BK;
    const float scale2 = scale * AT_L2E;
    if (k0 >= pre.lo[0] && k0 + BK <= pre.hi[0] && k0 >= pre.lo[1] &&
        k0 + BK <= pre.hi[1]) {
#pragma unroll
      for (int x = 0; x < N; ++x) s[x] *= scale2;
      return;
    }
    const int c0 = k0 + 2 * (lane & 3);
#pragma unroll
    for (int x = 0; x < N; ++x) {
      const int key = c0 + 8 * (x >> 2) + (x & 1);
      const int r = (x >> 1) & 1;
      s[x] = key >= pre.lo[r] && key < pre.hi[r] ? s[x] * scale2 : -INFINITY;
    }
  }
  __device__ int3 o_box(const AttTile& t, int wg) const {
    return make_int3(t.qh * DH, t.q0 + 64 * wg, 0);
  }
  __device__ bf16* o_row(const AttTile& t, int wg, int r) const {
    const int row = t.q0 + 64 * wg + r;
    return row < Sq ? out + ((size_t)row * H + t.qh) * DH : nullptr;
  }
};

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* band,
           void* out, int Sq, int Sk, int H, int KH, int kv_rows, int kv_b,
           long long kv_row_stride, long long kv_batch_stride, float scale,
           cudaStream_t st) {
  BandPolicy<DH> p;
  const long long qrow = (long long)H * DH, kvrow = (long long)KH * DH;
  int e = tma_map_3d(&p.tq, q, qrow, Sq, 1, qrow * 2, qrow * Sq * 2, 64, 64);
  if (e == 0)
    e = tma_map_3d(&p.tk, k, kvrow, Sk, kv_rows, kv_row_stride * 2,
                   kv_batch_stride * 2, 64, 64);
  if (e == 0)
    e = tma_map_3d(&p.tv, v, kvrow, Sk, kv_rows, kv_row_stride * 2,
                   kv_batch_stride * 2, 64, 64);
  if (e == 0)
    e = tma_map_3d(&p.to, out, qrow, Sq, 1, qrow * 2, qrow * Sq * 2, 64, 64);
  if (e != 0) return e;
  p.band = static_cast<const int2*>(band);
  p.out = static_cast<bf16*>(out);
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.group = H / KH;
  p.n_qt = (Sq + AT_BQ - 1) / AT_BQ;
  p.kv_b = kv_b;
  p.scale = scale;
  return att_launch(p, st);
}

}  // namespace

extern "C" {

// q [Sq, H, Dh] bf16 (contiguous, 16-byte aligned); k, v: kv_rows cache
// rows kv_batch_stride elements apart, each Sk keys of KH*Dh bf16 at
// kv_row_stride elements (strides multiples of 8, bases 16-byte aligned),
// of which row kv_b is attended; band [Sq, 2] int32 (8-byte aligned) ->
// out [Sq, H, Dh] bf16 (contiguous, 16-byte aligned).  Returns
// cudaErrorInvalidValue for a head width it was not built for.
int flash_attention_band(const void* q, const void* k, const void* v,
                         const void* band, void* out, int Sq, int Sk, int H,
                         int KH, int Dh, int kv_rows, int kv_b,
                         long long kv_row_stride, long long kv_batch_stride,
                         float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq == 0) return 0;
  if (Dh == 64)
    return launch<64>(q, k, v, band, out, Sq, Sk, H, KH, kv_rows, kv_b,
                      kv_row_stride, kv_batch_stride, scale, st);
  if (Dh == 128)
    return launch<128>(q, k, v, band, out, Sq, Sk, H, KH, kv_rows, kv_b,
                       kv_row_stride, kv_batch_stride, scale, st);
  if (Dh == 256)
    return launch<256>(q, k, v, band, out, Sq, Sk, H, KH, kv_rows, kv_b,
                       kv_row_stride, kv_batch_stride, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
