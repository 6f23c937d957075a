/* H.264 MP4 writer and any-format video reader over the system FFmpeg
 * libraries (libavformat/libavcodec/libx264): the port's copy of the JAX
 * package's cpp/h264mux.c, its source unchanged below this comment.
 *
 * Exposed as a tiny flat-C ABI consumed from Python via ctypes
 * (audiblelight_tpu_torch/io/h264.py): open a writer, push RGB24 frames,
 * close. A matching reader decodes any mp4/avi back to RGB24 so tests can
 * round-trip without OpenCV. RGB<->YUV420 (BT.601 limited range) is done
 * here in plain C rather than through swscale to keep the binding surface
 * minimal.
 *
 * Built at first use by io/h264.py into audiblelight_tpu_torch/_build/<hash>/:
 *   gcc -O2 -shared -fPIC -o libh264mux.so h264mux.c -lavformat -lavcodec -lavutil
 */

#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <stdint.h>
#include <string.h>

typedef struct {
    AVFormatContext *fmt;
    AVCodecContext *enc;
    AVStream *stream;
    AVFrame *frame;
    AVPacket *pkt;
    int64_t pts;
    int w, h;
} Writer;

static int write_packets(Writer *wr) {
    for (;;) {
        int ret = avcodec_receive_packet(wr->enc, wr->pkt);
        if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
        if (ret < 0) return ret;
        /* libx264 leaves duration 0; without it the mov muxer derives the
         * LAST sample's duration as 0, clipping the track one frame short. */
        if (wr->pkt->duration == 0) wr->pkt->duration = 1;
        av_packet_rescale_ts(wr->pkt, wr->enc->time_base, wr->stream->time_base);
        wr->pkt->stream_index = wr->stream->index;
        ret = av_interleaved_write_frame(wr->fmt, wr->pkt);
        if (ret < 0) return ret;
    }
}

void *h264_writer_open(const char *path, int w, int h, int fps_num,
                       int fps_den, int crf) {
    /* x264 needs even dimensions for 4:2:0; callers pad. */
    if (w <= 0 || h <= 0 || (w & 1) || (h & 1) || fps_num <= 0 || fps_den <= 0)
        return NULL;
    Writer *wr = av_mallocz(sizeof(Writer));
    if (!wr) return NULL;
    wr->w = w;
    wr->h = h;

    const AVCodec *codec = avcodec_find_encoder(AV_CODEC_ID_H264);
    if (!codec) goto fail;
    if (avformat_alloc_output_context2(&wr->fmt, NULL, NULL, path) < 0) goto fail;

    wr->enc = avcodec_alloc_context3(codec);
    if (!wr->enc) goto fail;
    wr->enc->width = w;
    wr->enc->height = h;
    wr->enc->pix_fmt = AV_PIX_FMT_YUV420P;
    wr->enc->time_base = (AVRational){fps_den, fps_num};
    wr->enc->framerate = (AVRational){fps_num, fps_den};
    wr->enc->gop_size = fps_num > 0 ? (2 * fps_num) / fps_den : 50;
    /* No B-frames: frame reordering shifts dts negative, which makes the mp4
     * muxer emit an edit list whose track duration clips the last delayed
     * sample on decode (observed: 12 in, 11 out). In-order encoding keeps
     * pts == dts and exact durations; the compression cost is irrelevant for
     * scene-visualisation clips. */
    wr->enc->max_b_frames = 0;
    if (wr->fmt->oformat->flags & AVFMT_GLOBALHEADER)
        wr->enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    {
        char crfstr[16];
        snprintf(crfstr, sizeof crfstr, "%d", crf);
        av_opt_set(wr->enc->priv_data, "crf", crfstr, 0);
        av_opt_set(wr->enc->priv_data, "preset", "fast", 0);
    }
    if (avcodec_open2(wr->enc, codec, NULL) < 0) goto fail;

    wr->stream = avformat_new_stream(wr->fmt, NULL);
    if (!wr->stream) goto fail;
    wr->stream->time_base = wr->enc->time_base;
    if (avcodec_parameters_from_context(wr->stream->codecpar, wr->enc) < 0)
        goto fail;

    if (!(wr->fmt->oformat->flags & AVFMT_NOFILE))
        if (avio_open(&wr->fmt->pb, path, AVIO_FLAG_WRITE) < 0) goto fail;
    if (avformat_write_header(wr->fmt, NULL) < 0) goto fail;

    wr->frame = av_frame_alloc();
    wr->pkt = av_packet_alloc();
    if (!wr->frame || !wr->pkt) goto fail;
    wr->frame->format = AV_PIX_FMT_YUV420P;
    wr->frame->width = w;
    wr->frame->height = h;
    if (av_frame_get_buffer(wr->frame, 0) < 0) goto fail;
    return wr;

fail:
    if (wr->enc) avcodec_free_context(&wr->enc);
    if (wr->fmt) {
        if (wr->fmt->pb) avio_closep(&wr->fmt->pb);
        avformat_free_context(wr->fmt);
    }
    av_frame_free(&wr->frame);
    av_packet_free(&wr->pkt);
    av_free(wr);
    return NULL;
}

/* RGB24 (h*w*3, row-major) -> the writer's YUV420P frame. BT.601 limited
 * range, 2x2 box-filtered chroma. */
static void rgb_to_yuv420(Writer *wr, const uint8_t *rgb) {
    AVFrame *f = wr->frame;
    int w = wr->w, h = wr->h;
    for (int y = 0; y < h; y++) {
        const uint8_t *row = rgb + (size_t)y * w * 3;
        uint8_t *dst = f->data[0] + (size_t)y * f->linesize[0];
        for (int x = 0; x < w; x++) {
            int r = row[3 * x], g = row[3 * x + 1], b = row[3 * x + 2];
            dst[x] = (uint8_t)((66 * r + 129 * g + 25 * b + 128 >> 8) + 16);
        }
    }
    for (int y = 0; y < h / 2; y++) {
        uint8_t *du = f->data[1] + (size_t)y * f->linesize[1];
        uint8_t *dv = f->data[2] + (size_t)y * f->linesize[2];
        const uint8_t *r0 = rgb + (size_t)(2 * y) * w * 3;
        const uint8_t *r1 = r0 + (size_t)w * 3;
        for (int x = 0; x < w / 2; x++) {
            int i0 = 6 * x;
            int r = r0[i0] + r0[i0 + 3] + r1[i0] + r1[i0 + 3];
            int g = r0[i0 + 1] + r0[i0 + 4] + r1[i0 + 1] + r1[i0 + 4];
            int b = r0[i0 + 2] + r0[i0 + 5] + r1[i0 + 2] + r1[i0 + 5];
            r >>= 2; g >>= 2; b >>= 2;
            du[x] = (uint8_t)((-38 * r - 74 * g + 112 * b + 128 >> 8) + 128);
            dv[x] = (uint8_t)((112 * r - 94 * g - 18 * b + 128 >> 8) + 128);
        }
    }
}

int h264_writer_write(void *h, const uint8_t *rgb) {
    Writer *wr = h;
    if (av_frame_make_writable(wr->frame) < 0) return -1;
    rgb_to_yuv420(wr, rgb);
    wr->frame->pts = wr->pts++;
    if (avcodec_send_frame(wr->enc, wr->frame) < 0) return -1;
    return write_packets(wr);
}

int h264_writer_close(void *h) {
    Writer *wr = h;
    int ret = 0;
    if (avcodec_send_frame(wr->enc, NULL) < 0) ret = -1; /* flush */
    if (write_packets(wr) < 0) ret = -1;
    if (av_write_trailer(wr->fmt) < 0) ret = -1;
    avcodec_free_context(&wr->enc);
    if (!(wr->fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&wr->fmt->pb);
    avformat_free_context(wr->fmt);
    av_frame_free(&wr->frame);
    av_packet_free(&wr->pkt);
    av_free(wr);
    return ret;
}

/* ------------------------------------------------------------------ */
/* Reader: decode any container/codec avformat knows to RGB24 frames.  */

typedef struct {
    AVFormatContext *fmt;
    AVCodecContext *dec;
    AVFrame *frame;
    AVPacket *pkt;
    int stream_idx;
    int w, h;
    int input_eof;  /* demuxer exhausted */
    int eof_sent;   /* flush packet ACCEPTED by the decoder */
} Reader;

void *video_reader_open(const char *path, int *w, int *h, double *fps) {
    Reader *rd = av_mallocz(sizeof(Reader));
    if (!rd) return NULL;
    rd->stream_idx = -1;
    if (avformat_open_input(&rd->fmt, path, NULL, NULL) < 0) goto fail;
    if (avformat_find_stream_info(rd->fmt, NULL) < 0) goto fail;
    const AVCodec *codec = NULL;
    rd->stream_idx = av_find_best_stream(rd->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                         &codec, 0);
    if (rd->stream_idx < 0 || !codec) goto fail;
    AVStream *st = rd->fmt->streams[rd->stream_idx];
    rd->dec = avcodec_alloc_context3(codec);
    if (!rd->dec) goto fail;
    if (avcodec_parameters_to_context(rd->dec, st->codecpar) < 0) goto fail;
    if (avcodec_open2(rd->dec, codec, NULL) < 0) goto fail;
    rd->frame = av_frame_alloc();
    rd->pkt = av_packet_alloc();
    if (!rd->frame || !rd->pkt) goto fail;
    rd->w = rd->dec->width;
    rd->h = rd->dec->height;
    *w = rd->w;
    *h = rd->h;
    AVRational r = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
    *fps = r.den ? (double)r.num / r.den : 0.0;
    return rd;

fail:
    if (rd->dec) avcodec_free_context(&rd->dec);
    if (rd->fmt) avformat_close_input(&rd->fmt);
    av_frame_free(&rd->frame);
    av_packet_free(&rd->pkt);
    av_free(rd);
    return NULL;
}

static uint8_t clamp8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

/* Decoded frame (yuv420p/yuvj420p) -> RGB24 into out. */
static int frame_to_rgb(Reader *rd, uint8_t *out) {
    AVFrame *f = rd->frame;
    if (f->format != AV_PIX_FMT_YUV420P && f->format != AV_PIX_FMT_YUVJ420P)
        return -1;
    int full = f->format == AV_PIX_FMT_YUVJ420P ||
               f->color_range == AVCOL_RANGE_JPEG;
    for (int y = 0; y < rd->h; y++) {
        const uint8_t *py = f->data[0] + (size_t)y * f->linesize[0];
        const uint8_t *pu = f->data[1] + (size_t)(y / 2) * f->linesize[1];
        const uint8_t *pv = f->data[2] + (size_t)(y / 2) * f->linesize[2];
        uint8_t *dst = out + (size_t)y * rd->w * 3;
        for (int x = 0; x < rd->w; x++) {
            int Y = py[x], U = pu[x / 2] - 128, V = pv[x / 2] - 128;
            /* Range-matched BT.601 coefficients: full-range chroma spans
             * +-128 directly (1.402/0.344/0.714/1.772 scaled by 256), while
             * limited-range needs the 255/224 expansion (409/208/100/516
             * scaled by 298/256 luma). Mixing full luma with limited chroma
             * oversaturated full-range (MJPEG) frames by ~14%%. */
            int c = full ? Y * 256 : (Y - 16) * 298;
            int rv = full ? 359 * V : 409 * V;
            int gu = full ? 88 * U : 100 * U;
            int gv = full ? 183 * V : 208 * V;
            int bu = full ? 454 * U : 516 * U;
            dst[3 * x] = clamp8(c + rv + 128 >> 8);
            dst[3 * x + 1] = clamp8(c - gu - gv + 128 >> 8);
            dst[3 * x + 2] = clamp8(c + bu + 128 >> 8);
        }
    }
    return 0;
}

/* Returns 1 with a frame in `out` (h*w*3 bytes), 0 at end of stream, <0 on
 * error. */
int video_reader_next(void *h, uint8_t *out) {
    Reader *rd = h;
    for (;;) {
        int ret = avcodec_receive_frame(rd->dec, rd->frame);
        if (ret == 0) {
            if (frame_to_rgb(rd, out) < 0) return -2;
            av_frame_unref(rd->frame);
            return 1;
        }
        if (ret == AVERROR_EOF) return 0;
        if (ret != AVERROR(EAGAIN)) return -1;
        if (rd->eof_sent) return 0; /* flush accepted AND output drained */
        if (rd->input_eof) {
            /* Keep retrying the flush: send_packet(NULL) itself can EAGAIN
             * while delayed (B-frame) pictures sit in the output queue —
             * ignoring that return is how the last frames get lost. */
            ret = avcodec_send_packet(rd->dec, NULL);
            if (ret == 0 || ret == AVERROR_EOF) rd->eof_sent = 1;
            else if (ret != AVERROR(EAGAIN)) return -1;
            continue;
        }
        /* Feed the decoder one packet. */
        for (;;) {
            ret = av_read_frame(rd->fmt, rd->pkt);
            if (ret == AVERROR_EOF) {
                rd->input_eof = 1;
                break;
            }
            if (ret < 0) return -1;
            if (rd->pkt->stream_index != rd->stream_idx) {
                av_packet_unref(rd->pkt);
                continue;
            }
            ret = avcodec_send_packet(rd->dec, rd->pkt);
            av_packet_unref(rd->pkt);
            if (ret == 0) break;
            return -1; /* EAGAIN impossible: output drained before each send */
        }
    }
}

void video_reader_close(void *h) {
    Reader *rd = h;
    avcodec_free_context(&rd->dec);
    avformat_close_input(&rd->fmt);
    av_frame_free(&rd->frame);
    av_packet_free(&rd->pkt);
    av_free(rd);
}
