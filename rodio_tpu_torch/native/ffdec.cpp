// Container/codec decode via the system ffmpeg libraries (libavformat/
// libavcodec 59) — the ingest backend for formats without a bespoke
// decoder (m4a/aac, opus, ...). The reference reaches these through the
// symphonia Rust crate (src/decoder/symphonia.rs); this shim decodes a
// whole in-memory stream to interleaved f32 PCM.
//
// C ABI:
//   int rtpu_ff_decode(const uint8_t* data, size_t len, float** out_pcm,
//                      unsigned* channels, unsigned* rate, uint64_t* frames);
//   (out_pcm is malloc'd; free with rtpu_free from flac.cpp)

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
}

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct MemCtx {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

int mem_read(void* opaque, uint8_t* buf, int buf_size) {
  MemCtx* m = (MemCtx*)opaque;
  size_t left = m->len - m->pos;
  size_t n = (size_t)buf_size < left ? (size_t)buf_size : left;
  if (n == 0) return AVERROR_EOF;
  memcpy(buf, m->data + m->pos, n);
  m->pos += n;
  return (int)n;
}

int64_t mem_seek(void* opaque, int64_t offset, int whence) {
  MemCtx* m = (MemCtx*)opaque;
  if (whence == AVSEEK_SIZE) return (int64_t)m->len;
  whence &= ~AVSEEK_FORCE;
  int64_t target;
  if (whence == SEEK_SET) target = offset;
  else if (whence == SEEK_CUR) target = (int64_t)m->pos + offset;
  else if (whence == SEEK_END) target = (int64_t)m->len + offset;
  else return -1;
  if (target < 0 || target > (int64_t)m->len) return -1;
  m->pos = (size_t)target;
  return target;
}

// append one AVFrame's samples as interleaved f32
bool append_frame(const AVFrame* fr, int channels, std::vector<float>& out) {
  int n = fr->nb_samples;
  switch (fr->format) {
    case AV_SAMPLE_FMT_FLTP: {
      for (int i = 0; i < n; ++i)
        for (int c = 0; c < channels; ++c)
          out.push_back(((const float*)fr->extended_data[c])[i]);
      return true;
    }
    case AV_SAMPLE_FMT_FLT: {
      const float* p = (const float*)fr->extended_data[0];
      out.insert(out.end(), p, p + (size_t)n * channels);
      return true;
    }
    case AV_SAMPLE_FMT_S16P: {
      for (int i = 0; i < n; ++i)
        for (int c = 0; c < channels; ++c)
          out.push_back(
              ((const int16_t*)fr->extended_data[c])[i] / 32768.0f);
      return true;
    }
    case AV_SAMPLE_FMT_S16: {
      const int16_t* p = (const int16_t*)fr->extended_data[0];
      for (size_t i = 0; i < (size_t)n * channels; ++i)
        out.push_back(p[i] / 32768.0f);
      return true;
    }
    case AV_SAMPLE_FMT_S32P: {
      for (int i = 0; i < n; ++i)
        for (int c = 0; c < channels; ++c)
          out.push_back((float)(((const int32_t*)fr->extended_data[c])[i] /
                                2147483648.0));
      return true;
    }
    case AV_SAMPLE_FMT_S32: {
      const int32_t* p = (const int32_t*)fr->extended_data[0];
      for (size_t i = 0; i < (size_t)n * channels; ++i)
        out.push_back((float)(p[i] / 2147483648.0));
      return true;
    }
    case AV_SAMPLE_FMT_DBLP: {
      for (int i = 0; i < n; ++i)
        for (int c = 0; c < channels; ++c)
          out.push_back(
              (float)((const double*)fr->extended_data[c])[i]);
      return true;
    }
    default:
      return false;
  }
}

}  // namespace

extern "C" {

int rtpu_ff_decode(const uint8_t* data, size_t len, float** out_pcm,
                   unsigned* out_channels, unsigned* out_rate,
                   uint64_t* out_frames) {
  av_log_set_level(AV_LOG_ERROR);

  MemCtx mem{data, len, 0};
  const int io_size = 1 << 16;
  uint8_t* io_buf = (uint8_t*)av_malloc(io_size);
  AVIOContext* avio =
      avio_alloc_context(io_buf, io_size, 0, &mem, mem_read, nullptr, mem_seek);
  if (!avio) return -1;

  AVFormatContext* fmt = avformat_alloc_context();
  fmt->pb = avio;
  int rc = avformat_open_input(&fmt, nullptr, nullptr, nullptr);
  if (rc < 0) {
    av_freep(&avio->buffer);
    avio_context_free(&avio);
    return -2;
  }
  // container edit lists / encoder-delay trims (AAC priming) ride
  // AV_PKT_DATA_SKIP_SAMPLES side data, which the generic decode layer
  // applies automatically — but only if the demuxer is asked to attach
  // it. This makes m4a durations match symphonia's gapless output
  // (src/decoder/symphonia.rs:339-363 honors the same
  // container delay/trim).
  av_format_inject_global_side_data(fmt);
  if (avformat_find_stream_info(fmt, nullptr) < 0) rc = -3;

  int stream_idx = -1;
  const AVCodec* codec = nullptr;
  if (rc >= 0) {
    stream_idx =
        av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
    if (stream_idx < 0 || !codec) rc = -4;
  }

  AVCodecContext* ctx = nullptr;
  std::vector<float> pcm;
  unsigned channels = 0, rate = 0;
  int64_t declared_frames = -1;
  if (rc >= 0) {
    ctx = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(ctx, fmt->streams[stream_idx]->codecpar);
    if (avcodec_open2(ctx, codec, nullptr) < 0) rc = -5;
  }
  if (rc >= 0) {
    channels = (unsigned)ctx->ch_layout.nb_channels;
    rate = (unsigned)ctx->sample_rate;
    if (channels == 0 || rate == 0) rc = -6;
  }
  if (rc >= 0 && fmt->iformat && fmt->iformat->name &&
      strstr(fmt->iformat->name, "mp4")) {
    // AAC priming: mp4 track headers declare the TRUE sample count
    // (raw AAC rounds up to whole 1024-sample frames); symphonia
    // reports and plays the declared duration
    // (src/decoder/symphonia.rs:339-363,
    // tests/total_duration.rs:43 = 10.188662131 s for music.m4a).
    // Trim the decode to it when the excess is priming/padding-sized.
    AVStream* st = fmt->streams[stream_idx];
    if (st->duration > 0)
      declared_frames = av_rescale_q(
          st->duration, st->time_base, AVRational{1, (int)rate});
  }

  if (rc >= 0) {
    AVPacket* pkt = av_packet_alloc();
    AVFrame* frame = av_frame_alloc();
    bool draining = false;
    while (true) {
      if (!draining) {
        int r = av_read_frame(fmt, pkt);
        if (r < 0) {
          draining = true;
          avcodec_send_packet(ctx, nullptr);  // flush
        } else if (pkt->stream_index != stream_idx) {
          av_packet_unref(pkt);
          continue;
        } else {
          // skip undecodable packets, like the reference's decode-error
          // skipping (src/decoder/symphonia.rs:366-372)
          avcodec_send_packet(ctx, pkt);
          av_packet_unref(pkt);
        }
      }
      int r = avcodec_receive_frame(ctx, frame);
      if (r == AVERROR(EAGAIN)) {
        if (draining) break;
        continue;
      }
      if (r == AVERROR_EOF || r < 0) break;
      if (!append_frame(frame, channels, pcm)) {
        rc = -7;
        break;
      }
    }
    av_frame_free(&frame);
    av_packet_free(&pkt);
  }

  if (ctx) avcodec_free_context(&ctx);
  if (fmt) avformat_close_input(&fmt);
  if (avio) {
    av_freep(&avio->buffer);
    avio_context_free(&avio);
  }
  if (rc < 0 && rc != -7) return rc;
  if (pcm.empty()) return -8;
  if (declared_frames > 0) {
    size_t decoded = pcm.size() / channels;
    size_t excess = decoded > (size_t)declared_frames
                        ? decoded - (size_t)declared_frames
                        : 0;
    if (excess > 0 && excess <= 4096)
      pcm.resize((size_t)declared_frames * channels);
  }

  float* out = (float*)malloc(pcm.size() * sizeof(float));
  if (!out) return -9;
  memcpy(out, pcm.data(), pcm.size() * sizeof(float));
  *out_pcm = out;
  *out_channels = channels;
  *out_rate = rate;
  *out_frames = pcm.size() / channels;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Re-entrant streaming decode: open a file (or growable path), pull
// interleaved f32 PCM in caller-sized chunks at O(packet) memory — the
// incremental analog of the reference's packet loop
// (src/decoder/symphonia.rs:336-417). Undecodable packets are skipped.
//
// C ABI:
//   void* rtpu_ffs_open(const char* path, unsigned* channels,
//                       unsigned* rate, double* duration_secs);
//   long long rtpu_ffs_read(void* h, float* out, long long max_frames);
//     -> frames written (0 = end of stream, <0 = error)
//   int rtpu_ffs_seek(void* h, double seconds);
//   void rtpu_ffs_close(void* h);
// ---------------------------------------------------------------------------

namespace {

struct FfStream {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* ctx = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  int stream_idx = -1;
  unsigned channels = 0;
  unsigned rate = 0;
  bool draining = false;
  bool eof = false;
  int64_t declared_frames = -1;  // mp4 priming trim (see rtpu_ff_decode)
  int64_t emitted = 0;           // frames handed to the caller
  // sample index (at `rate`) that pts 0 maps to on the EMITTED timeline:
  // priming codecs (mp3's 1105-sample delay, AAC) trim the head of the
  // decode, so raw packet pts lead the emitted-sample timeline by the
  // trim. Learned as rescale(pts(frame_k)) - samples_emitted_before_k
  // over the first frames (frame 0's own pts is NOT trim-adjusted).
  // INT64_MIN = not yet learned.
  int64_t pts_origin = INT64_MIN;
  bool seeked = false;
  bool is_ogg = false;           // chained-stream switching applies
  AVPacket* pending = nullptr;   // first packet of the NEXT chain link
  int next_stream = -1;
  int param_changed = 0;
  std::vector<float> leftover;  // interleaved remainder of the last frame
  size_t leftover_pos = 0;
};

// Chained-container continuation (the ogg demuxer surfaces each chain
// link as a NEW AVStream): open the next link's codec and report a
// parameter-change boundary — the analog of the reference's per-packet
// span re-bootstrap (src/decoder/symphonia.rs:197-199 reports spec per
// packet; src/source/span.rs:66-101 resets downstream state there).
int switch_stream(FfStream* s) {
  AVStream* st = s->fmt->streams[s->next_stream];
  const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
  if (!codec) return -1;
  AVCodecContext* nc = avcodec_alloc_context3(codec);
  if (!nc) return -1;
  avcodec_parameters_to_context(nc, st->codecpar);
  if (avcodec_open2(nc, codec, nullptr) < 0) {
    avcodec_free_context(&nc);
    return -1;
  }
  avcodec_free_context(&s->ctx);
  s->ctx = nc;
  s->stream_idx = s->next_stream;
  s->next_stream = -1;
  s->channels = (unsigned)nc->ch_layout.nb_channels;
  s->rate = (unsigned)nc->sample_rate;
  s->draining = false;
  s->param_changed = 1;
  if (s->pending) {
    avcodec_send_packet(s->ctx, s->pending);
    av_packet_free(&s->pending);
  }
  return 0;
}

}  // namespace

extern "C" {

void* rtpu_ffs_open(const char* path, unsigned* out_channels,
                    unsigned* out_rate, double* out_duration) {
  av_log_set_level(AV_LOG_ERROR);
  FfStream* s = new FfStream();
  int rc = avformat_open_input(&s->fmt, path, nullptr, nullptr);
  if (rc < 0) {
    delete s;
    return nullptr;
  }
  av_format_inject_global_side_data(s->fmt);  // AAC priming/edit lists
  if (avformat_find_stream_info(s->fmt, nullptr) < 0) goto fail;
  {
    const AVCodec* codec = nullptr;
    s->stream_idx =
        av_find_best_stream(s->fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
    if (s->stream_idx < 0 || !codec) goto fail;
    s->ctx = avcodec_alloc_context3(codec);
    avcodec_parameters_to_context(
        s->ctx, s->fmt->streams[s->stream_idx]->codecpar);
    if (avcodec_open2(s->ctx, codec, nullptr) < 0) goto fail;
    s->channels = (unsigned)s->ctx->ch_layout.nb_channels;
    s->rate = (unsigned)s->ctx->sample_rate;
    if (s->channels == 0 || s->rate == 0) goto fail;
  }
  if (s->fmt->iformat && s->fmt->iformat->name &&
      strstr(s->fmt->iformat->name, "mp4")) {
    AVStream* st = s->fmt->streams[s->stream_idx];
    if (st->duration > 0)
      s->declared_frames = av_rescale_q(
          st->duration, st->time_base, AVRational{1, (int)s->rate});
  }
  s->is_ogg = s->fmt->iformat && s->fmt->iformat->name &&
              strcmp(s->fmt->iformat->name, "ogg") == 0;
  s->pkt = av_packet_alloc();
  s->frame = av_frame_alloc();
  *out_channels = s->channels;
  *out_rate = s->rate;
  if (out_duration) {
    *out_duration = s->fmt->duration > 0
                        ? (double)s->fmt->duration / AV_TIME_BASE
                        : -1.0;
  }
  return s;
fail:
  if (s->ctx) avcodec_free_context(&s->ctx);
  if (s->fmt) avformat_close_input(&s->fmt);
  delete s;
  return nullptr;
}

long long rtpu_ffs_read(void* handle, float* out, long long max_frames) {
  FfStream* s = (FfStream*)handle;
  if (!s || max_frames <= 0) return -1;
  const unsigned ch_at_entry = s->channels;
  const size_t want = (size_t)max_frames * s->channels;
  size_t got = 0;

  // drain the leftover of the previous AVFrame first
  if (s->leftover_pos < s->leftover.size()) {
    size_t n = s->leftover.size() - s->leftover_pos;
    if (n > want) n = want;
    memcpy(out, s->leftover.data() + s->leftover_pos, n * sizeof(float));
    s->leftover_pos += n;
    got += n;
  }

  while (got < want && !s->eof) {
    if (!s->draining) {
      int r = av_read_frame(s->fmt, s->pkt);
      if (r < 0) {
        s->draining = true;
        avcodec_send_packet(s->ctx, nullptr);  // flush
      } else if (s->pkt->stream_index != s->stream_idx) {
        AVStream* ps = s->fmt->streams[s->pkt->stream_index];
        if (s->is_ogg && s->next_stream < 0 &&
            ps->codecpar->codec_type == AVMEDIA_TYPE_AUDIO &&
            s->pkt->stream_index > s->stream_idx) {
          // next chain link: stash its first packet, drain the current
          // codec, then switch at the boundary (span re-bootstrap)
          s->pending = av_packet_clone(s->pkt);
          s->next_stream = s->pkt->stream_index;
          av_packet_unref(s->pkt);
          s->draining = true;
          avcodec_send_packet(s->ctx, nullptr);
        } else {
          av_packet_unref(s->pkt);
          continue;
        }
      } else {
        avcodec_send_packet(s->ctx, s->pkt);  // errors skipped below
        av_packet_unref(s->pkt);
      }
    }
    int r = avcodec_receive_frame(s->ctx, s->frame);
    if (r == AVERROR(EAGAIN) || r == AVERROR_EOF || r < 0) {
      bool done = (r != AVERROR(EAGAIN)) || s->draining;
      if (!done) continue;
      if (s->next_stream >= 0) {
        if (switch_stream(s) < 0) s->eof = true;
        break;  // boundary: the caller observes the param change
      }
      s->eof = true;
      break;
    }
    // in-band parameter change (self-describing codecs like FLAC keep
    // decoding across an ogg chain boundary with the new spec carried
    // on the FRAME): stop at the boundary, hold the first new-section
    // frame in the leftover buffer, and report the span change
    // (src/decoder/symphonia.rs:197-199 reports spec per packet)
    if ((s->frame->sample_rate > 0 &&
         (unsigned)s->frame->sample_rate != s->rate) ||
        (s->frame->ch_layout.nb_channels > 0 &&
         (unsigned)s->frame->ch_layout.nb_channels != s->channels)) {
      unsigned nch = (unsigned)s->frame->ch_layout.nb_channels;
      std::vector<float> nb;
      if (!append_frame(s->frame, (int)nch, nb)) return -2;
      s->leftover = std::move(nb);
      s->leftover_pos = 0;
      s->channels = nch;
      s->rate = (unsigned)s->frame->sample_rate;
      s->param_changed = 1;
      break;
    }
    std::vector<float> buf;
    if (!append_frame(s->frame, (int)s->channels, buf)) return -2;
    size_t n = buf.size();
    size_t take = want - got < n ? want - got : n;
    memcpy(out + got, buf.data(), take * sizeof(float));
    got += take;
    if (take < n) {
      s->leftover.assign(buf.begin() + take, buf.end());
      s->leftover_pos = 0;
    }
  }
  long long frames = (long long)(got / ch_at_entry);
  if (s->declared_frames > 0) {
    // cap at the declared mp4 duration (AAC padding tail)
    long long left = s->declared_frames - s->emitted;
    if (left < 0) left = 0;
    if (frames > left) frames = left;
  }
  s->emitted += frames;
  return frames;
}

int rtpu_ffs_seek(void* handle, double seconds) {
  FfStream* s = (FfStream*)handle;
  if (!s) return -1;
  int64_t ts = (int64_t)(seconds * AV_TIME_BASE);
  int rc = av_seek_frame(s->fmt, -1, ts, AVSEEK_FLAG_BACKWARD);
  if (rc < 0) return rc;
  avcodec_flush_buffers(s->ctx);
  s->draining = false;
  s->eof = false;
  s->leftover.clear();
  s->leftover_pos = 0;
  // position for the declared-duration cap: the demuxer-coarse seek
  // lands at a keyframe at/below ts; approximate by the request (the
  // cap only matters near the stream tail)
  s->emitted = (int64_t)(seconds * s->rate);
  return 0;
}

namespace {

// Decode exactly ONE frame into s->frame (1 = frame, 0 = end of stream).
// Mirrors the packet loop of rtpu_ffs_read without the chained-container
// handling (a seek already re-bootstraps spans).
int ffs_next_frame(FfStream* s) {
  while (!s->eof) {
    if (!s->draining) {
      int r = av_read_frame(s->fmt, s->pkt);
      if (r < 0) {
        s->draining = true;
        avcodec_send_packet(s->ctx, nullptr);
      } else if (s->pkt->stream_index != s->stream_idx) {
        av_packet_unref(s->pkt);
        continue;
      } else {
        avcodec_send_packet(s->ctx, s->pkt);
        av_packet_unref(s->pkt);
      }
    }
    int r = avcodec_receive_frame(s->ctx, s->frame);
    if (r == AVERROR(EAGAIN) || r == AVERROR_EOF || r < 0) {
      if (r == AVERROR(EAGAIN) && !s->draining) continue;
      s->eof = true;
      return 0;
    }
    return 1;
  }
  return 0;
}

}  // namespace

extern "C" long long rtpu_ffs_seek_pos(void* handle, double seconds) {
  // Accurate-seek support (the reference refines its coarse demuxer
  // seek by decoding and skipping samples up to the requested position,
  // src/decoder/symphonia.rs:225-330): coarse keyframe-backward seek,
  // then decode ONE frame to learn the TRUE landed position from its
  // best-effort timestamp, measured against the stream's PTS ORIGIN
  // (the timestamp of output sample 0 -- nonzero for priming codecs
  // like mp3, whose first 1105 samples are trimmed by the skip-samples
  // side data, so the pts timeline leads the emitted-sample timeline).
  // The frame is parked in `leftover` so subsequent reads begin exactly
  // at the returned position; the caller (FfStream.seek_accurate)
  // read-skips the remaining target - landed frames. Returns the landed
  // frame index at the current rate, or <0 on error.
  FfStream* s = (FfStream*)handle;
  if (!s) return -1;
  if (s->pts_origin == INT64_MIN) {
    // learn the origin: decode the first frames from the stream head,
    // counting emitted samples (the trim shrinks frame 0, so a LATER
    // frame's pts minus the samples emitted before it gives the true
    // origin; a few packets of work, once per stream)
    if (rtpu_ffs_seek(handle, 0.0) < 0) return -1;
    AVStream* st0 = s->fmt->streams[s->stream_idx];
    long long emitted_before = 0;
    s->pts_origin = 0;
    for (int i = 0; i < 3 && ffs_next_frame(s) > 0; ++i) {
      int64_t p = s->frame->best_effort_timestamp;
      if (p != AV_NOPTS_VALUE) {
        s->pts_origin =
            av_rescale_q(p, st0->time_base, AVRational{1, (int)s->rate}) -
            emitted_before;
      }
      emitted_before += s->frame->nb_samples;
    }
  }
  if (rtpu_ffs_seek(handle, seconds) < 0) return -1;
  if (ffs_next_frame(s) > 0) {
    int64_t pts = s->frame->best_effort_timestamp;
    long long landed;
    if (pts == AV_NOPTS_VALUE) {
      // timestamp-less stream: trust the coarse request (raw formats
      // without pts also seek sample-exactly in the demuxer)
      landed = (long long)(seconds * s->rate);
    } else {
      AVStream* st = s->fmt->streams[s->stream_idx];
      landed = av_rescale_q(pts, st->time_base,
                            AVRational{1, (int)s->rate}) - s->pts_origin;
      if (landed < 0) landed = 0;  // pre-roll priming before the origin
    }
    std::vector<float> buf;
    if (!append_frame(s->frame, (int)s->channels, buf)) return -2;
    s->leftover = std::move(buf);
    s->leftover_pos = 0;
    s->emitted = landed;
    return landed;
  }
  // the request landed at/after end of stream
  s->emitted = (long long)(seconds * s->rate);
  return s->emitted;
}

extern "C" int rtpu_ffs_param_change(void* handle, unsigned* out_channels,
                          unsigned* out_rate) {
  FfStream* s = (FfStream*)handle;
  if (!s) return -1;
  if (!s->param_changed) return 0;
  s->param_changed = 0;
  *out_channels = s->channels;
  *out_rate = s->rate;
  return 1;
}

void rtpu_ffs_close(void* handle) {
  FfStream* s = (FfStream*)handle;
  if (!s) return;
  if (s->pending) av_packet_free(&s->pending);
  if (s->frame) av_frame_free(&s->frame);
  if (s->pkt) av_packet_free(&s->pkt);
  if (s->ctx) avcodec_free_context(&s->ctx);
  if (s->fmt) avformat_close_input(&s->fmt);
  delete s;
}

// ---------------------------------------------------------------------------
// Ogg/FLAC fixture encoder (tests only): lossless s16 content in an Ogg
// container, so concatenating two outputs yields a CHAINED ogg — the
// fixture for span re-bootstrap tests. Returns 0 on success.
// ---------------------------------------------------------------------------
int rtpu_ff_encode_ogg(const char* path, const float* pcm,
                       long long frames, int channels, int rate) {
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, "ogg", path) < 0)
    return -1;
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_FLAC);
  if (!codec) {
    avformat_free_context(fmt);
    return -2;
  }
  AVStream* st = avformat_new_stream(fmt, codec);
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  ctx->sample_fmt = AV_SAMPLE_FMT_S16;
  ctx->sample_rate = rate;
  av_channel_layout_default(&ctx->ch_layout, channels);
  ctx->time_base = AVRational{1, rate};
  int rc = avcodec_open2(ctx, codec, nullptr);
  if (rc >= 0) rc = avcodec_parameters_from_context(st->codecpar, ctx);
  if (rc >= 0) rc = avio_open(&fmt->pb, path, AVIO_FLAG_WRITE);
  if (rc >= 0) rc = avformat_write_header(fmt, nullptr);
  if (rc >= 0) {
    AVFrame* fr = av_frame_alloc();
    AVPacket* pkt = av_packet_alloc();
    int fs = ctx->frame_size > 0 ? ctx->frame_size : 4096;
    long long pos = 0;
    bool flushed = false;
    while (rc >= 0) {
      if (pos < frames) {
        int n = (int)(frames - pos < fs ? frames - pos : fs);
        fr->nb_samples = n;
        fr->format = AV_SAMPLE_FMT_S16;
        av_channel_layout_copy(&fr->ch_layout, &ctx->ch_layout);
        fr->sample_rate = rate;
        if (av_frame_get_buffer(fr, 0) < 0) {
          rc = -3;
          break;
        }
        int16_t* dst = (int16_t*)fr->data[0];
        for (int i = 0; i < n * channels; ++i) {
          float v = pcm[(size_t)pos * channels + i] * 32767.0f;
          if (v > 32767.0f) v = 32767.0f;
          if (v < -32768.0f) v = -32768.0f;
          dst[i] = (int16_t)lrintf(v);
        }
        fr->pts = pos;
        pos += n;
        rc = avcodec_send_frame(ctx, fr);
        av_frame_unref(fr);
      } else if (!flushed) {
        avcodec_send_frame(ctx, nullptr);
        flushed = true;
      }
      while (rc >= 0) {
        int r = avcodec_receive_packet(ctx, pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) {
          if (r == AVERROR_EOF) rc = 1;  // done
          break;
        }
        if (r < 0) {
          rc = -4;
          break;
        }
        av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
        pkt->stream_index = st->index;
        if (av_interleaved_write_frame(fmt, pkt) < 0) rc = -5;
      }
      if (rc == 1 || rc < 0) break;
    }
    av_packet_free(&pkt);
    av_frame_free(&fr);
    if (rc == 1) rc = av_write_trailer(fmt);
  }
  avcodec_free_context(&ctx);
  if (fmt->pb) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return rc < 0 ? rc : 0;
}

}  // extern "C"
