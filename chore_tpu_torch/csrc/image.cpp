// Host-side image inner loops of the port, bitwise what the libraries
// that chore_tpu calls compute:
// * chore_tpu_torch/data/imageio.py's JPEG reader, as libjpeg(-turbo)
//   decodes by default: the Huffman decode of a sequential scan into
//   coefficient blocks, the integer ISLOW IDCT of jidctint.c with its
//   range limit, the upsampling of jdsample.c and the YCbCr->RGB tables
//   of jdcolor.c (the markers, tables and progressive scans stay in
//   Python);
// * chore_tpu_torch/data/image_ops.py's uint8 bilinear resize, OpenCV's
//   INTER_LINEAR fixed point (the taps are computed in numpy).
//
// The reader hands a scan over with its entropy-coded bytes unstuffed and
// the restart intervals concatenated (``starts``: each interval's first
// byte), followed by at least 8 zero bytes, the bits libjpeg inserts past
// the end of the data. A code that is not in a table decodes as symbol 0
// of length 16 (the lookup tables say so), as libjpeg's "bad Huffman
// code" recovery does. Reading a bit window that starts more than one
// byte past the data fails the scan.
//
// Built by chore_tpu_torch/native.py with g++; called through ctypes,
// which releases the GIL for the call, so loader threads work at once.
#include <cstdint>
#include <cstring>

namespace {

constexpr int kTable = 1 << 16;

// the 64 bits that start at byte p >> 3, big-endian
inline uint64_t window(const uint8_t* s, int64_t p) {
  const uint8_t* b = s + (p >> 3);
  uint64_t w = 0;
  for (int k = 0; k < 8; ++k) w = (w << 8) | b[k];
  return w;
}

// the ``n`` bits at bit ``p`` (n + (p & 7) <= 56)
inline int64_t bits(const uint8_t* s, int64_t p, int n) {
  return static_cast<int64_t>((window(s, p) >> (64 - (p & 7) - n)) &
                              ((uint64_t{1} << n) - 1));
}

// a magnitude category's ``n``-bit value as a signed number (HUFF_EXTEND)
inline int64_t extend(int64_t x, int n) {
  return x < (int64_t{1} << (n - 1)) ? x - ((int64_t{1} << n) - 1) : x;
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 if a restart marker is missing, 2 if the data
// ends too early, 3 if a DC difference is wider than the bit window or a
// coefficient leaves int32 (a corrupt table or stream).
//   stream:   n_bytes of data, then >= 8 zero bytes
//   starts:   n_starts byte offsets of the restart intervals
//   interval: MCUs per restart interval
//   layout:   (n_mcu, bpm, 2) int64: each block's slot in the scan and the
//             flat offset of its 64 coefficients in that slot's array
//   luts:     (slots, 4, 65536) int32: DC symbol, DC length, AC symbol,
//             AC length for each 16-bit lookahead
//   coef:     per slot, the component's coefficients in natural order
//   natural:  zig-zag position -> natural position (80 entries, padded)
int jpeg_decode_scan(const uint8_t* stream, int64_t n_bytes,
                     const int64_t* starts, int64_t n_starts,
                     int64_t interval, int64_t n_mcu, int64_t bpm,
                     const int64_t* layout, const int32_t* luts,
                     int32_t* const* coef, const int32_t* natural) {
  int64_t preds[4] = {0, 0, 0, 0};
  int64_t p = 0, seg = 0;
  for (int64_t m = 0; m < n_mcu; ++m) {
    if (m % interval == 0) {
      if (seg >= n_starts) return 1;
      p = 8 * starts[seg++];
      preds[0] = preds[1] = preds[2] = preds[3] = 0;
    }
    for (int64_t b = 0; b < bpm; ++b) {
      const int64_t slot = layout[2 * (m * bpm + b)];
      const int64_t base = layout[2 * (m * bpm + b) + 1];
      const int32_t* dsym = luts + (4 * slot) * kTable;
      const int32_t* dlen = dsym + kTable;
      const int32_t* asym = dsym + 2 * kTable;
      const int32_t* alen = dsym + 3 * kTable;
      int32_t* out = coef[slot] + base;
      if ((p >> 3) > n_bytes) return 2;
      int v = static_cast<int>(bits(stream, p, 16));
      const int s = dsym[v];
      p += dlen[v];
      if (s) {
        if ((p >> 3) > n_bytes) return 2;
        if ((p & 7) + s > 56) return 3;
        preds[slot] += extend(bits(stream, p, s), s);
        p += s;
      }
      if (preds[slot] != static_cast<int32_t>(preds[slot])) return 3;
      out[0] = static_cast<int32_t>(preds[slot]);
      for (int k = 1; k < 64;) {
        if ((p >> 3) > n_bytes) return 2;
        v = static_cast<int>(bits(stream, p, 16));
        const int rs = asym[v];
        p += alen[v];
        const int r = rs & 15;
        if (r) {
          k += rs >> 4;
          if ((p >> 3) > n_bytes) return 2;
          out[natural[k]] = static_cast<int32_t>(
              extend(bits(stream, p, r), r));
          p += r;
          ++k;
        } else if (rs == 0xF0) {
          k += 16;
        } else {
          break;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"

namespace {

// one 1-D pass of jidctint.c's ISLOW IDCT (CONST_BITS 13) over the 8
// values v[0], v[stride], ..., descaled by ``shift`` bits with rounding
inline void idct_1d(const int64_t* v, int stride, int shift, int64_t* out,
                    int ostride) {
  int64_t z2 = v[2 * stride], z3 = v[6 * stride];
  int64_t z1 = (z2 + z3) * 4433;
  const int64_t tmp2 = z1 + z3 * -15137;
  const int64_t tmp3 = z1 + z2 * 6270;
  const int64_t tmp0 = (v[0] + v[4 * stride]) * 8192;
  const int64_t tmp1 = (v[0] - v[4 * stride]) * 8192;
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = v[7 * stride], t1 = v[5 * stride], t2 = v[3 * stride],
          t3 = v[stride];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int64_t z4 = t1 + t3;
  const int64_t z5 = (z3 + z4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  const int64_t half = int64_t{1} << (shift - 1);
  const int64_t rows[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3};
  for (int k = 0; k < 8; ++k) out[k * ostride] = (rows[k] + half) >> shift;
}

// jdmaster.c's post-IDCT range limit, indexed by value & 1023: [0, 128)
// -> value + 128, [128, 512) -> 255, [512, 896) -> 0, [896, 1024) ->
// value - 896
inline uint8_t range_limit(int64_t x) {
  const int i = static_cast<int>(x & 1023);
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

}  // namespace

extern "C" {

// (bh, bw) blocks of 64 quantized coefficients (natural order) -> the
// (8 bh, 8 bw) sample plane: dequantize by ``q``, columns (PASS1_BITS 2),
// then rows, range-limited
void jpeg_idct_islow(const int32_t* coef, const int64_t* q, int64_t bh,
                     int64_t bw, uint8_t* out) {
  for (int64_t b = 0; b < bh * bw; ++b) {
    int64_t x[64], ws[64], px[64];
    for (int k = 0; k < 64; ++k) x[k] = coef[64 * b + k] * q[k];
    for (int j = 0; j < 8; ++j) idct_1d(x + j, 8, 11, ws + j, 8);
    for (int i = 0; i < 8; ++i) idct_1d(ws + 8 * i, 1, 18, px + 8 * i, 1);
    uint8_t* o = out + (b / bw) * 64 * bw + (b % bw) * 8;
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j)
        o[i * 8 * bw + j] = range_limit(px[8 * i + j]);
  }
}


// A component plane (ph, pw) to full resolution, written to out[:H, :W],
// as libjpeg's default upsampler does: the "fancy" triangle filters for
// 2:1 ratios (h2v2 and h2v1 only on planes wider than 2 samples), else
// replication (int_upsample); edge samples replicate the last real one.
void jpeg_upsample(const uint8_t* in, int64_t ph, int64_t pw, int fh, int fv,
                   uint8_t* out, int64_t H, int64_t W) {
  auto col = [pw](int64_t j) { return j < 0 ? 0 : (j >= pw ? pw - 1 : j); };
  auto row = [&](int64_t i) {
    return in + (i < 0 ? 0 : (i >= ph ? ph - 1 : i)) * pw;
  };
  for (int64_t oi = 0; oi < H; ++oi) {
    uint8_t* o = out + oi * W;
    if (fh == 2 && fv == 2 && pw > 2) {  // h2v2_fancy_upsample
      const uint8_t* near = row(oi >> 1);
      const uint8_t* far = row((oi & 1) ? (oi >> 1) + 1 : (oi >> 1) - 1);
      for (int64_t oj = 0; oj < W; ++oj) {
        const int64_t j = oj >> 1, k = col((oj & 1) ? j + 1 : j - 1);
        const int a = 3 * near[j] + far[j], b = 3 * near[k] + far[k];
        o[oj] = static_cast<uint8_t>((3 * a + b + ((oj & 1) ? 7 : 8)) >> 4);
      }
    } else if (fh == 2 && fv == 1 && pw > 2) {  // h2v1_fancy_upsample
      const uint8_t* r = row(oi);
      for (int64_t oj = 0; oj < W; ++oj) {
        const int64_t j = oj >> 1, k = col((oj & 1) ? j + 1 : j - 1);
        o[oj] = static_cast<uint8_t>(
            (3 * r[j] + r[k] + ((oj & 1) ? 2 : 1)) >> 2);
      }
    } else if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample
      const uint8_t* near = row(oi >> 1);
      const uint8_t* far = row((oi & 1) ? (oi >> 1) + 1 : (oi >> 1) - 1);
      const int bias = (oi & 1) ? 2 : 1;
      for (int64_t oj = 0; oj < W; ++oj)
        o[oj] = static_cast<uint8_t>((3 * near[oj] + far[oj] + bias) >> 2);
    } else if (fh == 1) {  // 1:1 or a vertical integer ratio: copy rows
      std::memcpy(o, row(oi / fv), W);
    } else {  // another integer ratio: replicate
      const uint8_t* r = row(oi / fv);
      for (int64_t oj = 0; oj < W; ++oj) o[oj] = r[oj / fh];
    }
  }
}

// jdcolor.c's ycc_rgb_convert with its build_ycc_rgb_table (SCALEBITS 16)
void jpeg_ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                     int64_t n, uint8_t* rgb) {
  const int64_t one_half = int64_t{1} << 15;
  const int64_t f_cr_r = 91881, f_cb_b = 116130, f_cr_g = 46802,
                f_cb_g = 22554;  // FIX(1.40200), FIX(1.77200), ...
  auto clamp = [](int64_t x) {
    return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
  };
  for (int64_t k = 0; k < n; ++k) {
    const int64_t Y = y[k], Cb = cb[k] - 128, Cr = cr[k] - 128;
    rgb[3 * k] = clamp(Y + ((f_cr_r * Cr + one_half) >> 16));
    rgb[3 * k + 1] =
        clamp(Y + ((-f_cb_g * Cb + one_half + -f_cr_g * Cr) >> 16));
    rgb[3 * k + 2] = clamp(Y + ((f_cb_b * Cb + one_half) >> 16));
  }
}


// OpenCV's INTER_LINEAR on a uint8 (h, w, ch) image to (oh, ow, ch): per
// output column the two source columns and their 11-bit weights, per
// output row the two (clamped) source rows and theirs; integer
// horizontal sums S, then ((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4))
// >> 16) + 2) >> 2, wrapped to 8 bits as numpy's astype does
void resize_u8(const uint8_t* img, int64_t h, int64_t w, int64_t ch,
               const int64_t* sx0, const int64_t* sx1, const int64_t* ax0,
               const int64_t* ax1, int64_t ow, const int64_t* sy0,
               const int64_t* sy1, const int64_t* by0, const int64_t* by1,
               int64_t oh, uint8_t* out) {
  (void)h;
  for (int64_t i = 0; i < oh; ++i) {
    const uint8_t* r0 = img + sy0[i] * w * ch;
    const uint8_t* r1 = img + sy1[i] * w * ch;
    uint8_t* o = out + i * ow * ch;
    for (int64_t j = 0; j < ow; ++j) {
      for (int64_t c = 0; c < ch; ++c) {
        const int64_t s0 = r0[sx0[j] * ch + c] * ax0[j] +
                           r0[sx1[j] * ch + c] * ax1[j];
        const int64_t s1 = r1[sx0[j] * ch + c] * ax0[j] +
                           r1[sx1[j] * ch + c] * ax1[j];
        o[j * ch + c] = static_cast<uint8_t>(
            (((by0[i] * (s0 >> 4)) >> 16) + ((by1[i] * (s1 >> 4)) >> 16) +
             2) >> 2);
      }
    }
  }
}

}  // extern "C"
