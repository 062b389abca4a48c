// FLAC decoder — native decode stage of the rodio_tpu ingest pipeline.
//
// The reference uses the claxon/symphonia Rust crates for FLAC
// (src/decoder/flac.rs, src/decoder/symphonia.rs); this is an independent
// implementation of the public FLAC format spec (RFC 9639), decoding a whole
// stream to interleaved int32 PCM that the Python layer scales to f32
// device blocks.
//
// Exposed C ABI (see rodio_tpu/io/native.py):
//   int rtpu_flac_decode(const uint8_t* data, size_t len,
//                        int32_t** out_pcm, FlacInfo* info);
//   void rtpu_free(void* p);

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

struct FlacInfo {
  uint32_t sample_rate;
  uint32_t channels;
  uint32_t bits_per_sample;
  uint64_t total_samples;   // per channel (frames)
  uint64_t decoded_frames;  // actually decoded
};

}  // extern "C"

namespace {

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t len) : data_(data), len_(len) {}

  bool eof() const { return byte_ >= len_; }
  size_t byte_pos() const { return byte_; }

  void align_byte() {
    if (bit_) {
      bit_ = 0;
      ++byte_;
    }
  }

  // read up to 32 bits, MSB first
  uint32_t bits(unsigned n) {
    uint32_t v = 0;
    while (n > 0) {
      if (byte_ >= len_) {
        ok_ = false;
        return 0;
      }
      unsigned avail = 8 - bit_;
      unsigned take = n < avail ? n : avail;
      uint32_t chunk = (data_[byte_] >> (avail - take)) & ((1u << take) - 1u);
      v = (v << take) | chunk;
      bit_ += take;
      if (bit_ == 8) {
        bit_ = 0;
        ++byte_;
      }
      n -= take;
    }
    return v;
  }

  uint64_t bits64(unsigned n) {
    if (n <= 32) return bits(n);
    uint64_t hi = bits(n - 32);
    uint64_t lo = bits(32);
    return (hi << 32) | lo;
  }

  int32_t signed_bits(unsigned n) {
    if (n == 0) return 0;
    uint32_t v = bits(n);
    uint32_t sign = 1u << (n - 1);
    return (v & sign) ? (int32_t)(v | ~(sign + (sign - 1))) : (int32_t)v;
  }

  // sign-extended read for widths up to 64 (side channels of 32-bit
  // streams carry 33-bit samples, RFC 9639 §9.2.3)
  int64_t signed_bits64(unsigned n) {
    if (n == 0) return 0;
    uint64_t v = bits64(n);
    uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? (int64_t)(v | ~(sign | (sign - 1))) : (int64_t)v;
  }

  // unary: count zeros until a 1 bit
  uint32_t unary() {
    uint32_t q = 0;
    // fast path: scan whole bytes
    for (;;) {
      if (byte_ >= len_) {
        ok_ = false;
        return q;
      }
      uint8_t cur = (uint8_t)(data_[byte_] << bit_);
      if (cur == 0) {
        q += 8 - bit_;
        bit_ = 0;
        ++byte_;
        continue;
      }
      // find leading 1 in cur
      unsigned lead = __builtin_clz((uint32_t)cur) - 24;
      q += lead;
      bit_ += lead + 1;
      if (bit_ >= 8) {
        bit_ -= 8;
        ++byte_;
      }
      return q;
    }
  }

  bool ok() const { return ok_; }
  void set_pos(size_t byte, unsigned bit = 0) {
    byte_ = byte;
    bit_ = bit;
  }

 private:
  const uint8_t* data_;
  size_t len_;
  size_t byte_ = 0;
  unsigned bit_ = 0;
  bool ok_ = true;
};

// decode one rice-coded residual partition set into res[order..block_size)
bool decode_residual(BitReader& br, unsigned order, unsigned block_size,
                     int64_t* res) {
  unsigned method = br.bits(2);
  if (method > 1) return false;
  unsigned pbits = method == 0 ? 4 : 5;
  unsigned escape = method == 0 ? 0xF : 0x1F;
  unsigned partition_order = br.bits(4);
  unsigned partitions = 1u << partition_order;
  if (block_size % partitions != 0) return false;
  unsigned part_len = block_size >> partition_order;
  // RFC 9639: the first partition holds part_len - order residuals, so the
  // predictor order must not exceed the partition length. An unchecked
  // malformed header would underflow `count` below to ~2^32 and overflow
  // the block_size-sized output buffer.
  if (part_len == 0 || order > part_len) return false;
  unsigned idx = order;
  for (unsigned p = 0; p < partitions; ++p) {
    unsigned count = part_len - (p == 0 ? order : 0);
    unsigned param = br.bits(pbits);
    if (param == escape) {
      unsigned raw = br.bits(5);
      for (unsigned i = 0; i < count; ++i)
        res[idx++] = raw ? br.signed_bits(raw) : 0;
    } else {
      for (unsigned i = 0; i < count; ++i) {
        uint64_t q = br.unary();
        uint64_t u = (q << param) | (param ? br.bits(param) : 0);
        // zigzag
        res[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (!br.ok()) return false;
  }
  return true;
}

const int kFixedCoefs[5][4] = {
    {},
    {1},
    {2, -1},
    {3, -3, 1},
    {4, -6, 4, -1},
};

bool decode_subframe(BitReader& br, unsigned block_size, unsigned bps,
                     int64_t* out) {
  if (br.bits(1) != 0) return false;  // reserved
  unsigned type = br.bits(6);
  unsigned wasted = 0;
  if (br.bits(1)) {  // wasted bits flag
    wasted = 1 + br.unary();
    if (wasted >= bps) return false;  // would underflow the sample width
    bps -= wasted;
  }
  if (bps > 33) return false;  // 32-bit stream + side-channel extra bit max

  if (type == 0) {  // CONSTANT
    int64_t v = br.signed_bits64(bps);
    for (unsigned i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (unsigned i = 0; i < block_size; ++i) out[i] = br.signed_bits64(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED order 0..4
    unsigned order = type - 8;
    if (order > block_size) return false;
    for (unsigned i = 0; i < order; ++i) out[i] = br.signed_bits64(bps);
    if (!decode_residual(br, order, block_size, out)) return false;
    const int* c = kFixedCoefs[order];
    for (unsigned i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (unsigned j = 0; j < order; ++j) pred += (int64_t)c[j] * out[i - 1 - j];
      out[i] += pred;
    }
  } else if (type >= 32) {  // LPC, order = type - 31
    unsigned order = type - 31;
    if (order > block_size) return false;
    for (unsigned i = 0; i < order; ++i) out[i] = br.signed_bits64(bps);
    unsigned precision = br.bits(4) + 1;
    if (precision == 16) return false;  // invalid
    int shift = br.signed_bits(5);
    if (shift < 0) return false;
    int32_t coefs[32];
    for (unsigned i = 0; i < order; ++i) coefs[i] = br.signed_bits(precision);
    if (!decode_residual(br, order, block_size, out)) return false;
    for (unsigned i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (unsigned j = 0; j < order; ++j)
        pred += (int64_t)coefs[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;  // reserved types
  }

  if (wasted)
    for (unsigned i = 0; i < block_size; ++i) out[i] <<= wasted;
  return br.ok();
}

uint64_t read_utf8_number(BitReader& br) {
  uint32_t b0 = br.bits(8);
  if ((b0 & 0x80) == 0) return b0;
  unsigned n = 0;
  for (uint32_t m = 0x40; b0 & m; m >>= 1) ++n;
  uint64_t v = b0 & (0x3Fu >> n);
  for (unsigned i = 0; i < n; ++i) v = (v << 6) | (br.bits(8) & 0x3F);
  return v;
}

}  // namespace

extern "C" {

// Returns 0 on success. out_pcm receives malloc'd interleaved int32
// (scaled to bits_per_sample), length = decoded_frames * channels.
int rtpu_flac_decode(const uint8_t* data, size_t len, int32_t** out_pcm,
                     FlacInfo* info) {
  if (len < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
  BitReader br(data, len);
  br.set_pos(4);

  // metadata blocks
  bool have_streaminfo = false;
  for (;;) {
    uint32_t last = br.bits(1);
    uint32_t type = br.bits(7);
    uint32_t blen = br.bits(24);
    if (!br.ok()) return -2;
    if (type == 0 && blen >= 34) {
      br.bits(16);  // min block size
      br.bits(16);  // max block size
      br.bits(24);  // min frame size
      br.bits(24);  // max frame size
      info->sample_rate = br.bits(20);
      info->channels = br.bits(3) + 1;
      info->bits_per_sample = br.bits(5) + 1;
      info->total_samples = br.bits64(36);
      // skip MD5 + any extra
      for (uint32_t i = 34; i < blen; ++i) br.bits(8);
      br.set_pos(br.byte_pos() + 16);
      have_streaminfo = true;
    } else {
      br.set_pos(br.byte_pos() + blen);
    }
    if (last) break;
  }
  if (!have_streaminfo || info->sample_rate == 0) return -3;

  unsigned channels = info->channels;
  uint64_t capacity = info->total_samples ? info->total_samples : 1 << 20;
  int32_t* pcm = (int32_t*)malloc(sizeof(int32_t) * capacity * channels);
  if (!pcm) return -4;
  uint64_t frames_done = 0;

  int64_t* chan_buf[8] = {nullptr};
  unsigned chan_buf_size = 0;

  static const uint32_t kBlockSizes[16] = {0,   192, 576,  1152, 2304, 4608,
                                           0,   0,   256,  512,  1024, 2048,
                                           4096, 8192, 16384, 32768};
  static const uint32_t kRates[16] = {0,     88200, 176400, 192000, 8000,
                                      16000, 22050, 24000,  32000,  44100,
                                      48000, 96000, 0,      0,      0,  0};

  while (!br.eof()) {
    br.align_byte();
    // find frame sync 0xFF 0xF8..0xFB
    size_t pos = br.byte_pos();
    bool found = false;
    while (pos + 1 < len) {
      if (data[pos] == 0xFF && (data[pos + 1] & 0xFC) == 0xF8) {
        found = true;
        break;
      }
      ++pos;
    }
    if (!found) break;
    br.set_pos(pos);

    br.bits(14);                    // sync
    br.bits(1);                     // reserved
    br.bits(1);                     // blocking strategy
    uint32_t bs_code = br.bits(4);
    uint32_t sr_code = br.bits(4);
    uint32_t ch_code = br.bits(4);
    uint32_t ss_code = br.bits(3);
    br.bits(1);  // reserved
    read_utf8_number(br);

    uint32_t block_size;
    if (bs_code == 6)
      block_size = br.bits(8) + 1;
    else if (bs_code == 7)
      block_size = br.bits(16) + 1;
    else
      block_size = kBlockSizes[bs_code];
    if (block_size == 0) { br.set_pos(pos + 2); continue; }

    if (sr_code == 12)
      br.bits(8);
    else if (sr_code == 13 || sr_code == 14)
      br.bits(16);

    unsigned bps;
    switch (ss_code) {
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: bps = info->bits_per_sample; break;
    }

    br.bits(8);  // CRC-8
    if (!br.ok()) break;

    unsigned nch;
    enum { INDEP, LEFT_SIDE, RIGHT_SIDE, MID_SIDE } mode = INDEP;
    if (ch_code < 8) {
      nch = ch_code + 1;
    } else if (ch_code == 8) {
      nch = 2; mode = LEFT_SIDE;
    } else if (ch_code == 9) {
      nch = 2; mode = RIGHT_SIDE;
    } else if (ch_code == 10) {
      nch = 2; mode = MID_SIDE;
    } else {
      br.set_pos(pos + 2);
      continue;
    }
    if (nch != channels) { br.set_pos(pos + 2); continue; }

    if (block_size > chan_buf_size) {
      for (unsigned c = 0; c < channels; ++c) {
        free(chan_buf[c]);
        chan_buf[c] = (int64_t*)malloc(sizeof(int64_t) * block_size);
      }
      chan_buf_size = block_size;
    }

    bool good = true;
    for (unsigned c = 0; c < nch && good; ++c) {
      unsigned sub_bps = bps;
      if ((mode == LEFT_SIDE && c == 1) || (mode == RIGHT_SIDE && c == 0) ||
          (mode == MID_SIDE && c == 1))
        sub_bps += 1;  // side channel carries one extra bit
      good = decode_subframe(br, block_size, sub_bps, chan_buf[c]);
    }
    if (!good) { br.set_pos(pos + 2); continue; }
    br.align_byte();
    br.bits(16);  // CRC-16

    // undo stereo decorrelation
    if (mode == LEFT_SIDE) {
      for (unsigned i = 0; i < block_size; ++i)
        chan_buf[1][i] = chan_buf[0][i] - chan_buf[1][i];
    } else if (mode == RIGHT_SIDE) {
      for (unsigned i = 0; i < block_size; ++i)
        chan_buf[0][i] = chan_buf[1][i] + chan_buf[0][i];
    } else if (mode == MID_SIDE) {
      for (unsigned i = 0; i < block_size; ++i) {
        int64_t side = chan_buf[1][i];
        int64_t mid = (chan_buf[0][i] << 1) | (side & 1);
        chan_buf[0][i] = (mid + side) >> 1;
        chan_buf[1][i] = (mid - side) >> 1;
      }
    }

    if (frames_done + block_size > capacity) {
      capacity = (frames_done + block_size) * 2;
      int32_t* np = (int32_t*)realloc(pcm, sizeof(int32_t) * capacity * channels);
      if (!np) { free(pcm); return -5; }
      pcm = np;
    }
    for (unsigned i = 0; i < block_size; ++i)
      for (unsigned c = 0; c < channels; ++c)
        pcm[(frames_done + i) * channels + c] = (int32_t)chan_buf[c][i];
    frames_done += block_size;
    if (info->total_samples && frames_done >= info->total_samples) break;
  }

  for (unsigned c = 0; c < 8; ++c) free(chan_buf[c]);
  info->decoded_frames = frames_done;
  *out_pcm = pcm;
  return 0;
}

void rtpu_free(void* p) { free(p); }

}  // extern "C"
