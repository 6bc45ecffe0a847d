/* wav_core.h — shared single-pass RIFF/WAVE decode core used by the
 * _ttsx_wavio Python extension and the _ttsx_prefetch worker pool.
 * Pure C (no Python API): safe to call with the GIL released or from
 * non-Python threads.
 *
 * Supported encodings: PCM u8/s16/s24/s32, IEEE float32/float64, and
 * WAVE_FORMAT_EXTENSIBLE wrapping either. Any channel count (mono-mixed).
 * Chunked RIFF walking (LIST/fact/cue chunks skipped, odd sizes padded).
 */
#ifndef TTSX_WAV_CORE_H
#define TTSX_WAV_CORE_H

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define WAVE_FORMAT_PCM 0x0001
#define WAVE_FORMAT_IEEE_FLOAT 0x0003
#define WAVE_FORMAT_EXTENSIBLE 0xFFFE

typedef struct {
    uint16_t format;      /* resolved format tag */
    uint16_t channels;
    uint32_t sample_rate;
    uint16_t bits;
    const uint8_t *data;  /* points into the file buffer */
    size_t data_len;      /* bytes */
} wav_info;

static inline uint32_t wav_rd_u32(const uint8_t *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

static inline uint16_t wav_rd_u16(const uint8_t *p) {
    return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

/* Walk the RIFF chunk list; fills info, returns 0 on success. */
static int wav_parse(const uint8_t *buf, size_t len, wav_info *info,
                     const char **err) {
    if (len < 12 || memcmp(buf, "RIFF", 4) != 0 ||
        memcmp(buf + 8, "WAVE", 4) != 0) {
        *err = "not a RIFF/WAVE file";
        return -1;
    }
    size_t pos = 12;
    int have_fmt = 0;
    info->data = NULL;
    info->data_len = 0;
    while (pos + 8 <= len) {
        const uint8_t *hdr = buf + pos;
        uint32_t csize = wav_rd_u32(hdr + 4);
        size_t body = pos + 8;
        if (body + csize > len) { /* tolerate truncated final chunk */
            if (memcmp(hdr, "data", 4) == 0)
                csize = (uint32_t)(len - body);
            else
                break;
        }
        if (memcmp(hdr, "fmt ", 4) == 0 && csize >= 16) {
            info->format = wav_rd_u16(buf + body);
            info->channels = wav_rd_u16(buf + body + 2);
            info->sample_rate = wav_rd_u32(buf + body + 4);
            info->bits = wav_rd_u16(buf + body + 14);
            if (info->format == WAVE_FORMAT_EXTENSIBLE && csize >= 40) {
                /* sub-format GUID: first 2 bytes are the real tag */
                info->format = wav_rd_u16(buf + body + 24);
            }
            have_fmt = 1;
        } else if (memcmp(hdr, "data", 4) == 0) {
            info->data = buf + body;
            info->data_len = csize;
        }
        pos = body + csize + (csize & 1); /* RIFF chunks are word-aligned */
    }
    if (!have_fmt) { *err = "missing fmt chunk"; return -1; }
    if (!info->data) { *err = "missing data chunk"; return -1; }
    if (info->channels == 0) { *err = "zero channels"; return -1; }
    return 0;
}

/* Decode frame f (all channels mono-mixed) to a float in [-1, 1]. */
static inline float wav_decode_frame(const wav_info *w, size_t f) {
    const int ch = w->channels;
    float acc = 0.0f;
    size_t bytes = w->bits / 8;
    const uint8_t *p = w->data + f * bytes * ch;
    for (int c = 0; c < ch; c++, p += bytes) {
        float v = 0.0f;
        if (w->format == WAVE_FORMAT_IEEE_FLOAT) {
            if (w->bits == 32) {
                uint32_t u = wav_rd_u32(p);
                memcpy(&v, &u, 4);
            } else { /* 64 */
                uint64_t u = (uint64_t)wav_rd_u32(p) |
                             ((uint64_t)wav_rd_u32(p + 4) << 32);
                double d;
                memcpy(&d, &u, 8);
                v = (float)d;
            }
        } else { /* PCM */
            switch (w->bits) {
            case 8:
                v = ((float)p[0] - 128.0f) / 128.0f;
                break;
            case 16: {
                int16_t s = (int16_t)wav_rd_u16(p);
                v = (float)s / 32768.0f;
                break;
            }
            case 24: {
                int32_t s = (int32_t)((uint32_t)p[0] << 8 |
                                      (uint32_t)p[1] << 16 |
                                      (uint32_t)p[2] << 24) >> 8;
                v = (float)s / 8388608.0f;
                break;
            }
            case 32: {
                int32_t s = (int32_t)wav_rd_u32(p);
                v = (float)((double)s / 2147483648.0);
                break;
            }
            default:
                v = 0.0f;
            }
        }
        acc += v;
    }
    return acc / (float)ch;
}

/* Validate a parsed header for decodability. Returns 0 ok. Only the
 * exact widths the decoder implements are accepted: IEEE float 32/64
 * (a float wav claiming bits=16 would make the 64-bit branch read 8
 * bytes per 2-byte stride — heap overread on the final frames), and
 * PCM 8/16/24/32 (wider PCM would silently decode as silence). */
static inline int wav_check(const wav_info *w) {
    if (w->format == WAVE_FORMAT_IEEE_FLOAT)
        return (w->bits == 32 || w->bits == 64) ? 0 : -1;
    if (w->format == WAVE_FORMAT_PCM)
        return (w->bits == 8 || w->bits == 16 || w->bits == 24 ||
                w->bits == 32) ? 0 : -1;
    return -1;
}

/* Decode (and optionally linear-resample, numpy.interp-over-linspace
 * semantics) an already-parsed wav into out[out_len]. */
static void wav_decode_into(const wav_info *w, size_t n_frames,
                            float *out, size_t out_len, int resample,
                            double ratio) {
    if (!resample) {
        for (size_t i = 0; i < n_frames; i++)
            out[i] = wav_decode_frame(w, i);
    } else {
        for (size_t i = 0; i < out_len; i++) {
            double x = (double)i * ratio;
            size_t i0 = (size_t)x;
            if (i0 >= n_frames - 1) {
                out[i] = wav_decode_frame(w, n_frames - 1);
            } else {
                double t = x - (double)i0;
                float a = wav_decode_frame(w, i0);
                float b = wav_decode_frame(w, i0 + 1);
                out[i] = (float)((1.0 - t) * a + t * b);
            }
        }
    }
}

/* Read + decode a whole file to a malloc'd mono float32 buffer.
 * Returns NULL on failure. *out_len receives the sample count; *out_sr
 * (if non-NULL) the output sample rate. Pure C — no GIL needed. */
static float *wav_core_read(const char *path, long target_sr,
                            size_t *out_len, long *out_sr) {
    FILE *fp = fopen(path, "rb");
    if (!fp)
        return NULL;
    fseek(fp, 0, SEEK_END);
    long fsz = ftell(fp);
    fseek(fp, 0, SEEK_SET);
    if (fsz <= 0) {
        fclose(fp);
        return NULL;
    }
    uint8_t *buf = (uint8_t *)malloc((size_t)fsz);
    if (!buf) {
        fclose(fp);
        return NULL;
    }
    size_t got = fread(buf, 1, (size_t)fsz, fp);
    fclose(fp);
    wav_info w;
    const char *err;
    if (wav_parse(buf, got, &w, &err) != 0 || wav_check(&w) != 0) {
        free(buf);
        return NULL;
    }
    size_t frame_bytes = (size_t)(w.bits / 8) * w.channels;
    size_t n_frames = w.data_len / frame_bytes;
    size_t len = n_frames;
    double ratio = 1.0;
    int resample = (target_sr > 0 && (uint32_t)target_sr != w.sample_rate &&
                    n_frames > 1);
    if (resample) {
        len = (size_t)((double)n_frames * (double)target_sr /
                           (double)w.sample_rate +
                       0.5);
        ratio = (len > 1) ? (double)(n_frames - 1) / (double)(len - 1) : 0.0;
    }
    float *out = (float *)malloc((len ? len : 1) * sizeof(float));
    if (!out) {
        free(buf);
        return NULL;
    }
    wav_decode_into(&w, n_frames, out, len, resample, ratio);
    free(buf);
    *out_len = len;
    if (out_sr)
        *out_sr = resample ? target_sr : (long)w.sample_rate;
    return out;
}

#endif /* TTSX_WAV_CORE_H */
