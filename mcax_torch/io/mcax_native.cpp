// mcax native host runtime (C ABI, loaded via ctypes).
//
// The reference stack's L0 native tier (wipp: C-API kernels + circular
// buffer, SURVEY.md §1a) maps on TPU to Pallas for the *device* math; this
// file is the *host* half: the streaming data path that feeds the chip —
// a block-oriented WAV reader, PCM→float32 deinterleave (the host-side hot
// loop when streaming 16 mics at 48 kHz), and a lock-free single-producer/
// single-consumer ring buffer used by the double-buffered feeder
// (mcax/io/stream.py) so disk I/O overlaps device compute.
//
// Build: make -C native   →  libmcax_native.so
// Python fallback exists for every entry point; the library is an
// accelerator, not a dependency.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// PCM conversion kernels (deinterleave + scale), channel-major out with an
// explicit output row stride (out_stride >= n_frames), so a partial final
// block lands correctly inside a [C x block_len] buffer.
// in: interleaved frames [n_frames x n_channels]; out row c at out+c*stride.
// ---------------------------------------------------------------------------

void mcax_i16_to_f32_deinterleave(const int16_t* in, float* out,
                                  int64_t n_frames, int32_t n_channels,
                                  int64_t out_stride) {
  const float scale = 1.0f / 32768.0f;
  for (int32_t c = 0; c < n_channels; ++c) {
    const int16_t* src = in + c;
    float* dst = out + (int64_t)c * out_stride;
    for (int64_t i = 0; i < n_frames; ++i) {
      dst[i] = (float)src[(int64_t)i * n_channels] * scale;
    }
  }
}

void mcax_i32_to_f32_deinterleave(const int32_t* in, float* out,
                                  int64_t n_frames, int32_t n_channels,
                                  int64_t out_stride) {
  const float scale = 1.0f / 2147483648.0f;
  for (int32_t c = 0; c < n_channels; ++c) {
    const int32_t* src = in + c;
    float* dst = out + (int64_t)c * out_stride;
    for (int64_t i = 0; i < n_frames; ++i) {
      dst[i] = (float)src[(int64_t)i * n_channels] * scale;
    }
  }
}

// 24-bit little-endian packed PCM (3 bytes/sample), sign-extended.
// Common on multichannel recorders; neither scipy-write nor PCM16 covers it.
void mcax_i24_to_f32_deinterleave(const uint8_t* in, float* out,
                                  int64_t n_frames, int32_t n_channels,
                                  int64_t out_stride) {
  const float scale = 1.0f / 8388608.0f;  // 2^23
  for (int32_t c = 0; c < n_channels; ++c) {
    const uint8_t* src = in + (int64_t)c * 3;
    float* dst = out + (int64_t)c * out_stride;
    const int64_t frame_bytes = (int64_t)n_channels * 3;
    for (int64_t i = 0; i < n_frames; ++i) {
      const uint8_t* p = src + i * frame_bytes;
      int32_t v = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                            ((uint32_t)p[2] << 16));
      v = (v << 8) >> 8;  // sign-extend from bit 23
      dst[i] = (float)v * scale;
    }
  }
}

void mcax_f32_deinterleave(const float* in, float* out, int64_t n_frames,
                           int32_t n_channels, int64_t out_stride) {
  for (int32_t c = 0; c < n_channels; ++c) {
    const float* src = in + c;
    float* dst = out + (int64_t)c * out_stride;
    for (int64_t i = 0; i < n_frames; ++i) {
      dst[i] = src[(int64_t)i * n_channels];
    }
  }
}

// interleave + clip + scale float32 [C x N] → int16 frames [N x C]
void mcax_f32_to_i16_interleave(const float* in, int16_t* out,
                                int64_t n_frames, int32_t n_channels) {
  for (int32_t c = 0; c < n_channels; ++c) {
    const float* src = in + (int64_t)c * n_frames;
    int16_t* dst = out + c;
    for (int64_t i = 0; i < n_frames; ++i) {
      float v = src[i];
      if (v > 1.0f) v = 1.0f;
      if (v < -1.0f) v = -1.0f;
      dst[(int64_t)i * n_channels] = (int16_t)(v * 32767.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// Streaming WAV reader: open once, pull float32 [C x block] blocks.
// Minimal RIFF parse (PCM16/PCM32/IEEE float32), robust to extra chunks.
// ---------------------------------------------------------------------------

struct McaxWav {
  FILE* f;
  int32_t channels;
  int32_t sample_rate;
  int32_t bits;        // 16 | 32
  int32_t is_float;    // format 3
  int64_t data_left;   // bytes remaining in data chunk
  void* scratch;       // interleaved read buffer
  int64_t scratch_cap; // bytes
};

static uint32_t rd_u32(const unsigned char* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const unsigned char* p) {
  return (uint16_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8));
}

void* mcax_wav_open(const char* path, int32_t* channels, int32_t* sample_rate,
                    int64_t* n_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) ||
      memcmp(hdr + 8, "WAVE", 4)) {
    fclose(f);
    return nullptr;
  }
  McaxWav* w = (McaxWav*)calloc(1, sizeof(McaxWav));
  w->f = f;
  // chunk walk
  unsigned char ch[8];
  bool have_fmt = false;
  while (fread(ch, 1, 8, f) == 8) {
    uint32_t sz = rd_u32(ch + 4);
    if (!memcmp(ch, "fmt ", 4)) {
      unsigned char fmt[40];
      uint32_t take = sz < 40 ? sz : 40;
      if (fread(fmt, 1, take, f) != take) break;
      if (sz > take) fseek(f, (long)(sz - take), SEEK_CUR);
      uint16_t tag = rd_u16(fmt);
      w->channels = rd_u16(fmt + 2);
      w->sample_rate = (int32_t)rd_u32(fmt + 4);
      w->bits = rd_u16(fmt + 14);
      w->is_float = (tag == 3);
      if (tag == 0xFFFE && sz >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        uint16_t sub = rd_u16(fmt + 24);
        w->is_float = (sub == 3);
      }
      have_fmt = true;
    } else if (!memcmp(ch, "data", 4)) {
      w->data_left = (int64_t)sz;
      if (!have_fmt || w->channels <= 0 ||
          (w->bits != 16 && w->bits != 24 && w->bits != 32)) {
        fclose(f);
        free(w);
        return nullptr;
      }
      int bytes_per_frame = w->channels * (w->bits / 8);
      *channels = w->channels;
      *sample_rate = w->sample_rate;
      *n_frames = w->data_left / bytes_per_frame;
      return w;
    } else {
      fseek(f, (long)((sz + 1) & ~1u), SEEK_CUR);  // chunks are word-aligned
    }
  }
  fclose(f);
  free(w);
  return nullptr;
}

// Read up to block_frames frames into out [C x block_frames] (channel-major
// float32, zero-padded past EOF). Returns frames actually read.
int64_t mcax_wav_read_block(void* handle, float* out, int64_t block_frames) {
  McaxWav* w = (McaxWav*)handle;
  if (!w || block_frames <= 0) return 0;
  int bpf = w->channels * (w->bits / 8);
  int64_t want = block_frames * bpf;
  if (want > w->data_left) want = w->data_left;
  int64_t frames = want / bpf;
  if (frames > 0) {
    if (w->scratch_cap < frames * bpf) {
      free(w->scratch);
      w->scratch = malloc((size_t)(block_frames * bpf));
      w->scratch_cap = block_frames * bpf;
    }
    int64_t got = (int64_t)fread(w->scratch, 1, (size_t)(frames * bpf), w->f);
    frames = got / bpf;
    w->data_left -= frames * bpf;
    if (w->bits == 16) {
      mcax_i16_to_f32_deinterleave((const int16_t*)w->scratch, out, frames,
                                   w->channels, block_frames);
    } else if (w->bits == 24) {
      mcax_i24_to_f32_deinterleave((const uint8_t*)w->scratch, out, frames,
                                   w->channels, block_frames);
    } else if (w->is_float) {
      mcax_f32_deinterleave((const float*)w->scratch, out, frames,
                            w->channels, block_frames);
    } else {
      mcax_i32_to_f32_deinterleave((const int32_t*)w->scratch, out, frames,
                                   w->channels, block_frames);
    }
  }
  // zero-pad the tail of a short final block, per channel
  if (frames < block_frames) {
    for (int32_t c = 0; c < w->channels; ++c) {
      memset(out + (int64_t)c * block_frames + frames, 0,
             (size_t)((block_frames - frames) * sizeof(float)));
    }
  }
  return frames;
}

void mcax_wav_close(void* handle) {
  McaxWav* w = (McaxWav*)handle;
  if (!w) return;
  if (w->f) fclose(w->f);
  free(w->scratch);
  free(w);
}

// ---------------------------------------------------------------------------
// Lock-free SPSC ring buffer of fixed-size float blocks (the wipp
// CircularBuffer analogue, upgraded for a feeder-thread architecture).
// ---------------------------------------------------------------------------

struct McaxRing {
  float* data;
  int64_t block_floats;
  int32_t capacity;  // number of blocks, power of two not required
  std::atomic<int64_t> head;  // next write slot (producer)
  std::atomic<int64_t> tail;  // next read slot (consumer)
};

void* mcax_ring_create(int64_t block_floats, int32_t capacity_blocks) {
  McaxRing* r = new McaxRing();
  r->data = (float*)malloc((size_t)(block_floats * capacity_blocks *
                                    (int64_t)sizeof(float)));
  r->block_floats = block_floats;
  r->capacity = capacity_blocks;
  r->head.store(0);
  r->tail.store(0);
  return r;
}

int32_t mcax_ring_push(void* handle, const float* block) {
  McaxRing* r = (McaxRing*)handle;
  int64_t h = r->head.load(std::memory_order_relaxed);
  int64_t t = r->tail.load(std::memory_order_acquire);
  if (h - t >= r->capacity) return 0;  // full
  memcpy(r->data + (h % r->capacity) * r->block_floats, block,
         (size_t)(r->block_floats * (int64_t)sizeof(float)));
  r->head.store(h + 1, std::memory_order_release);
  return 1;
}

int32_t mcax_ring_pop(void* handle, float* out) {
  McaxRing* r = (McaxRing*)handle;
  int64_t t = r->tail.load(std::memory_order_relaxed);
  int64_t h = r->head.load(std::memory_order_acquire);
  if (t >= h) return 0;  // empty
  memcpy(out, r->data + (t % r->capacity) * r->block_floats,
         (size_t)(r->block_floats * (int64_t)sizeof(float)));
  r->tail.store(t + 1, std::memory_order_release);
  return 1;
}

int32_t mcax_ring_size(void* handle) {
  McaxRing* r = (McaxRing*)handle;
  return (int32_t)(r->head.load(std::memory_order_acquire) -
                   r->tail.load(std::memory_order_acquire));
}

void mcax_ring_destroy(void* handle) {
  McaxRing* r = (McaxRing*)handle;
  if (!r) return;
  free(r->data);
  delete r;
}

}  // extern "C"
