// aha_tpu_torch native video decoder: libavformat/libavcodec demux+decode with
// fps resampling and letterbox resize via libswscale.
//
// The port's own copy of the JAX package's native decoder: sequential decode,
// keep the first source frame at or after each target timestamp (frame-counter
// timing, identical to the cv2 loop of data/media.py), aspect-preserving
// letterbox to a square RGB canvas, and a true-source-frame-index map for
// highlight reels.
//
// C ABI (ctypes-friendly); see aha_tpu_torch/native/__init__.py for the wrapper.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

namespace {

struct Ctx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  int stream_index = -1;
  double fps = 0.0;
  double duration = 0.0;
  int width = 0;
  int height = 0;
  // streaming state. cur_time accumulates 1/fps per source frame — the
  // same float accumulation as the reference cv2 loop (stream.py:152-166),
  // so frame selection matches bit-for-bit at resampling boundaries.
  int64_t src_frame_index = 0;
  int64_t out_frame_index = 0;
  double cur_time = 0.0;
  bool eof = false;
  // letterbox geometry for the current out_size
  int out_size = 0;
  int new_w = 0, new_h = 0, pad_top = 0, pad_left = 0;
};

void setup_letterbox(Ctx* c, int out_size) {
  if (c->out_size == out_size) return;
  c->out_size = out_size;
  if (c->width > c->height) {
    c->new_w = out_size;
    c->new_h = (int)((double)c->height / c->width * out_size);
  } else {
    c->new_h = out_size;
    c->new_w = (int)((double)c->width / c->height * out_size);
  }
  c->pad_top = (out_size - c->new_h) / 2;
  c->pad_left = (out_size - c->new_w) / 2;
  if (c->sws) sws_freeContext(c->sws);
  c->sws = sws_getContext(c->width, c->height, c->codec->pix_fmt, c->new_w,
                          c->new_h, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                          nullptr, nullptr);
}

// Write the decoded frame letterboxed into out (out_size*out_size*3, RGB).
void blit_letterboxed(Ctx* c, const AVFrame* f, uint8_t* out) {
  const int S = c->out_size;
  std::memset(out, 0, (size_t)S * S * 3);
  std::vector<uint8_t> resized((size_t)c->new_w * c->new_h * 3);
  uint8_t* dst_data[4] = {resized.data(), nullptr, nullptr, nullptr};
  int dst_linesize[4] = {c->new_w * 3, 0, 0, 0};
  sws_scale(c->sws, f->data, f->linesize, 0, c->height, dst_data, dst_linesize);
  for (int y = 0; y < c->new_h; ++y) {
    std::memcpy(out + ((size_t)(y + c->pad_top) * S + c->pad_left) * 3,
                resized.data() + (size_t)y * c->new_w * 3, (size_t)c->new_w * 3);
  }
}

// Pull the next decoded source frame into c->frame. Returns 1 on success,
// 0 on EOF, <0 on error.
int next_source_frame(Ctx* c) {
  while (true) {
    int ret = avcodec_receive_frame(c->codec, c->frame);
    if (ret == 0) return 1;
    if (ret == AVERROR_EOF) return 0;
    if (ret != AVERROR(EAGAIN)) return ret;
    // feed more packets
    while (true) {
      ret = av_read_frame(c->fmt, c->pkt);
      if (ret < 0) {  // demux EOF -> flush
        avcodec_send_packet(c->codec, nullptr);
        break;
      }
      if (c->pkt->stream_index == c->stream_index) {
        ret = avcodec_send_packet(c->codec, c->pkt);
        av_packet_unref(c->pkt);
        if (ret < 0 && ret != AVERROR(EAGAIN)) return ret;
        break;
      }
      av_packet_unref(c->pkt);
    }
  }
}

}  // namespace

extern "C" {

void* aha_open(const char* path) {
  auto* c = new Ctx();
  if (avformat_open_input(&c->fmt, path, nullptr, nullptr) < 0) goto fail;
  if (avformat_find_stream_info(c->fmt, nullptr) < 0) goto fail;
  {
    const AVCodec* dec = nullptr;
    c->stream_index =
        av_find_best_stream(c->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
    if (c->stream_index < 0 || !dec) goto fail;
    AVStream* st = c->fmt->streams[c->stream_index];
    c->codec = avcodec_alloc_context3(dec);
    if (!c->codec) goto fail;
    if (avcodec_parameters_to_context(c->codec, st->codecpar) < 0) goto fail;
    if (avcodec_open2(c->codec, dec, nullptr) < 0) goto fail;
    AVRational r = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
    c->fps = r.den ? (double)r.num / r.den : 30.0;
    if (st->duration > 0) {
      c->duration = st->duration * av_q2d(st->time_base);
    } else if (c->fmt->duration > 0) {
      c->duration = (double)c->fmt->duration / AV_TIME_BASE;
    } else if (st->nb_frames > 0 && c->fps > 0) {
      c->duration = st->nb_frames / c->fps;
    }
    c->width = c->codec->width;
    c->height = c->codec->height;
    c->frame = av_frame_alloc();
    c->pkt = av_packet_alloc();
    if (!c->frame || !c->pkt) goto fail;
  }
  return c;
fail:
  if (c->codec) avcodec_free_context(&c->codec);
  if (c->fmt) avformat_close_input(&c->fmt);
  delete c;
  return nullptr;
}

int aha_info(void* ctx, double* fps, double* duration, int* w, int* h) {
  auto* c = static_cast<Ctx*>(ctx);
  if (!c) return -1;
  *fps = c->fps;
  *duration = c->duration;
  *w = c->width;
  *h = c->height;
  return 0;
}

// Decode up to max_frames output frames at target_fps into `out`
// ([max_frames, out_size, out_size, 3] RGB, caller-allocated). Fills
// true_indices[i] with the source frame index of output frame i. Returns
// the number of frames produced (>= 0) or a negative error.
int aha_decode(void* ctx, double target_fps, int out_size, int max_frames,
               uint8_t* out, int32_t* true_indices) {
  auto* c = static_cast<Ctx*>(ctx);
  if (!c || target_fps <= 0 || out_size <= 0) return -1;
  setup_letterbox(c, out_size);
  const size_t frame_bytes = (size_t)out_size * out_size * 3;
  int produced = 0;
  while (produced < max_frames && !c->eof) {
    int ret = next_source_frame(c);
    if (ret <= 0) {
      c->eof = true;
      break;
    }
    const double target_time = (double)c->out_frame_index / target_fps;
    if (c->cur_time >= target_time) {
      blit_letterboxed(c, c->frame, out + (size_t)produced * frame_bytes);
      if (true_indices) true_indices[produced] = (int32_t)c->src_frame_index;
      ++produced;
      ++c->out_frame_index;
    }
    ++c->src_frame_index;
    c->cur_time += 1.0 / c->fps;
    av_frame_unref(c->frame);
  }
  return produced;
}

void aha_close(void* ctx) {
  auto* c = static_cast<Ctx*>(ctx);
  if (!c) return;
  if (c->sws) sws_freeContext(c->sws);
  if (c->frame) av_frame_free(&c->frame);
  if (c->pkt) av_packet_free(&c->pkt);
  if (c->codec) avcodec_free_context(&c->codec);
  if (c->fmt) avformat_close_input(&c->fmt);
  delete c;
}

}  // extern "C"
