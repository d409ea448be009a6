/* fourspl.c — native writer for the `.4spl` palettized volume-video format.
 *
 * Reimplements the `4splat.c` the reference repo depends on but does not
 * ship (Makefile:96-97): the extern "C" API declared at th3cs.cu:21-63,
 * with the byte layout confirmed by viewer.html:67-96 —
 *   header 32 B | palette pSize*48 B | 1-byte voxel indices | footer 16 B.
 *
 * The in-memory index array is uint64_t per voxel (as the declared API
 * requires); on disk each index is one byte (flags bit 0x00 = 8-bit index
 * width, th3cs.cu:1226-1228). The footer checksum algorithm is unspecified
 * upstream; defined here (and in io/fourspl.py) as CRC32 of
 * the index bytes.
 *
 * Build: cc -O2 -shared -fPIC fourspl.c -o libfourspl.so
 * (io/fourspl_native.py of fluidsims_tpu_torch builds it at first use into
 * build/).
 */

#include <stdbool.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
  float mu_x, sigma_x, mu_y, sigma_y, mu_z, sigma_z, mu_t, sigma_t, r, g, b,
      alpha;
} Splat4D;

typedef struct {
  uint32_t magic;
  uint8_t version[4];
  uint32_t width, height, depth, frames;
  uint32_t pSize;
  uint32_t flags;
} Splat4DHeader;

typedef struct {
  Splat4D *palette;
} Splat4DPalette;

typedef struct {
  uint64_t *index;
} Splat4DIndex;

typedef struct {
  uint32_t checksum;
  uint64_t idxoffset;
  uint32_t end;
} Splat4DFooter;

typedef struct {
  Splat4DHeader header;
  Splat4DPalette palette;
  Splat4DIndex index;
  Splat4DFooter footer;
} Splat4DVideo;

#define SPL_MAGIC 0x4C505334u /* "4SPL" */
#define SPL_END 0x4C505334u

/* CRC32 (reflected, poly 0xEDB88320), table built on first use. */
static uint32_t crc_table[256];
static int crc_ready = 0;

static void crc_init(void) {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_ready = 1;
}

static uint32_t crc32_update(uint32_t crc, const uint8_t *buf, size_t len) {
  if (!crc_ready)
    crc_init();
  crc ^= 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++)
    crc = crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

Splat4D create_splat4D(float mu_x, float sigma_x, float mu_y, float sigma_y,
                       float mu_z, float sigma_z, float mu_t, float sigma_t,
                       float r, float g, float b, float alpha) {
  Splat4D s = {mu_x, sigma_x, mu_y, sigma_y, mu_z, sigma_z,
               mu_t, sigma_t, r,    g,       b,    alpha};
  return s;
}

Splat4DHeader create_splat4DHeader(uint32_t width, uint32_t height,
                                   uint32_t depth, uint32_t frames,
                                   uint32_t pSize, uint32_t flags) {
  Splat4DHeader h;
  h.magic = SPL_MAGIC;
  h.version[0] = 1;
  h.version[1] = 0;
  h.version[2] = 0;
  h.version[3] = 0;
  h.width = width;
  h.height = height;
  h.depth = depth;
  h.frames = frames;
  h.pSize = pSize;
  h.flags = flags;
  return h;
}

Splat4DVideo create_splat4DVideo(Splat4DHeader header, Splat4D *splats,
                                 uint64_t *idxs) {
  Splat4DVideo v;
  v.header = header;
  v.palette.palette = splats;
  v.index.index = idxs;
  v.footer.checksum = 0;
  v.footer.idxoffset = 32u + (uint64_t)header.pSize * sizeof(Splat4D);
  v.footer.end = SPL_END;
  return v;
}

bool write_splat4DVideo(FILE *fp, Splat4DVideo *v) {
  if (!fp || !v)
    return false;
  const Splat4DHeader *h = &v->header;

  /* 32-byte header, field by field (struct padding is already absent for
     this layout, but write explicitly to guarantee it) */
  if (fwrite(&h->magic, 4, 1, fp) != 1)
    return false;
  if (fwrite(h->version, 1, 4, fp) != 4)
    return false;
  if (fwrite(&h->width, 4, 1, fp) != 1)
    return false;
  if (fwrite(&h->height, 4, 1, fp) != 1)
    return false;
  if (fwrite(&h->depth, 4, 1, fp) != 1)
    return false;
  if (fwrite(&h->frames, 4, 1, fp) != 1)
    return false;
  if (fwrite(&h->pSize, 4, 1, fp) != 1)
    return false;
  if (fwrite(&h->flags, 4, 1, fp) != 1)
    return false;

  if (fwrite(v->palette.palette, sizeof(Splat4D), h->pSize, fp) != h->pSize)
    return false;

  uint64_t n =
      (uint64_t)h->width * h->height * h->depth * (uint64_t)h->frames;

  /* stream 8-bit indices in chunks, accumulating the checksum */
  uint32_t crc = 0;
  enum { CHUNK = 1 << 16 };
  uint8_t buf[CHUNK];
  uint64_t done = 0;
  while (done < n) {
    uint64_t m = n - done < CHUNK ? n - done : CHUNK;
    for (uint64_t i = 0; i < m; i++)
      buf[i] = (uint8_t)(v->index.index[done + i] & 0xFF);
    crc = crc32_update(crc, buf, (size_t)m);
    if (fwrite(buf, 1, (size_t)m, fp) != (size_t)m)
      return false;
    done += m;
  }

  Splat4DFooter f;
  f.checksum = crc;
  f.idxoffset = 32u + (uint64_t)h->pSize * sizeof(Splat4D);
  f.end = SPL_END;
  if (fwrite(&f.checksum, 4, 1, fp) != 1)
    return false;
  if (fwrite(&f.idxoffset, 8, 1, fp) != 1)
    return false;
  if (fwrite(&f.end, 4, 1, fp) != 1)
    return false;
  return true;
}

/* Convenience entry for bindings: write a whole video from flat arrays. */
bool fourspl_write_file(const char *path, uint32_t width, uint32_t height,
                        uint32_t depth, uint32_t frames, uint32_t pSize,
                        uint32_t flags, const float *palette48,
                        const uint8_t *indices) {
  FILE *fp = fopen(path, "wb");
  if (!fp)
    return false;
  Splat4DHeader h = create_splat4DHeader(width, height, depth, frames, pSize,
                                         flags);
  uint64_t n = (uint64_t)width * height * depth * (uint64_t)frames;

  if (fwrite(&h.magic, 4, 1, fp) != 1)
    goto fail;
  if (fwrite(h.version, 1, 4, fp) != 4)
    goto fail;
  if (fwrite(&h.width, 4, 1, fp) != 1)
    goto fail;
  if (fwrite(&h.height, 4, 1, fp) != 1)
    goto fail;
  if (fwrite(&h.depth, 4, 1, fp) != 1)
    goto fail;
  if (fwrite(&h.frames, 4, 1, fp) != 1)
    goto fail;
  if (fwrite(&h.pSize, 4, 1, fp) != 1)
    goto fail;
  if (fwrite(&h.flags, 4, 1, fp) != 1)
    goto fail;
  if (fwrite(palette48, 48, pSize, fp) != pSize)
    goto fail;
  if (fwrite(indices, 1, (size_t)n, fp) != (size_t)n)
    goto fail;
  {
    uint32_t crc = crc32_update(0, indices, (size_t)n);
    uint64_t off = 32u + (uint64_t)pSize * 48u;
    uint32_t end = SPL_END;
    if (fwrite(&crc, 4, 1, fp) != 1)
      goto fail;
    if (fwrite(&off, 8, 1, fp) != 1)
      goto fail;
    if (fwrite(&end, 4, 1, fp) != 1)
      goto fail;
  }
  fclose(fp);
  return true;
fail:
  fclose(fp);
  return false;
}
