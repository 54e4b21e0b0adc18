/* Host image decoding for the loader: the PNG unfilter and a JPEG decoder,
 * plain C99 with a C interface for ctypes (native.py builds it).
 *
 * png_unfilter: the five PNG row filters (PNG spec section 9.2), bit for bit,
 * at any whole number of bytes per pixel.
 *
 * jpeg_info / jpeg_decode: sequential and progressive JPEG, Huffman-coded
 * (SOF0/SOF1/SOF2) or arithmetic-coded (SOF9/SOF10, with or without DAC
 * conditioning values: T.81 Annex D and libjpeg-turbo's jdarith.c): DC and
 * AC first and refinement scans, EOB runs, interleaved and non-interleaved
 * scans, restart markers, 8-bit samples, 1 or 3 components, any sampling
 * factors 1-4 whose ratios to the largest are whole numbers. The output is
 * what libjpeg-turbo 3.1 gives at its defaults (the decoder PIL runs) on
 * x86-64: the islow integer IDCT of jidctint.c as its SIMD code computes it
 * (16-bit lanes, which decide only on corrupt data), the upsampler jdsample.c
 * jinit_upsampler picks (h2v1_fancy_upsample and h2v2_fancy_upsample when
 * the downsampled component is more than 2 samples wide, else the
 * replicating h2v1/h2v2 ones; h1v2_fancy_upsample for a vertical ratio of 2
 * alone; int_upsample, which replicates, for every other ratio), the colour
 * space jdapimin.c default_decompress_parms picks (JFIF: YCbCr; else an
 * Adobe APP14 transform 0: RGB, any other: YCbCr; else component ids 'R',
 * 'G', 'B': RGB; else YCbCr) and the integer YCbCr->RGB tables of jdcolor.c.
 * Progressive coefficients are kept for the whole image and go through the
 * same IDCT, upsampling and colour code as sequential ones; where the scans
 * leave bits of coefficients 1-9 unsent, each block is first smoothed from
 * the DC values around it, as jdcoefct.c decompress_smooth_data does.
 * Refused with a message, as PIL fails on them too: lossless and
 * hierarchical files, 12-bit samples, 2 components, fractional sampling
 * ratios, interleaved scans of more than 10 blocks per MCU, DNL-sized files
 * and bad DAC segments; and 4 components (CMYK/YCCK), which PIL reads as
 * four channels that no three-channel view holds.
 * Damaged and cut-off files read as PIL reads them, libjpeg-turbo fed in
 * PIL's 64 KiB reads: past a segment's data the MCUs are skipped up to the
 * next restart (decode_scan); a cut file raises where libjpeg would wait for
 * more data before its last row is out (decode_scan, huff_suspends,
 * arith_byte, jpeg_decode); after a sequential file's one scan the markers
 * up to EOI are read, and a reserved or repeated one raises (read_markers);
 * a code no table holds takes 17 bits; a table is checked when a scan
 * first uses it.
 *
 * Every function returns 0 on success. On failure it returns non-zero and
 * writes a message into err (errlen bytes).
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------------ */
/* PNG                                                                       */
/* ------------------------------------------------------------------------ */

/* raw: h rows of 1 + stride bytes (the filter byte first); out: h rows of
 * stride bytes; bpp: bytes per pixel. Returns 0, or y + 1 for the first row
 * y whose filter type is above 4. */
int png_unfilter(const uint8_t *raw, int64_t h, int64_t stride, int32_t bpp, uint8_t *out) {
    for (int64_t y = 0; y < h; y++) {
        const uint8_t *in = raw + y * (stride + 1);
        const int kind = in[0];
        in += 1;
        uint8_t *cur = out + y * stride;
        const uint8_t *up = y ? cur - stride : NULL;
        int64_t i;
        switch (kind) {
        case 0:
            memcpy(cur, in, (size_t)stride);
            break;
        case 1:
            for (i = 0; i < stride && i < bpp; i++) cur[i] = in[i];
            for (; i < stride; i++) cur[i] = (uint8_t)(in[i] + cur[i - bpp]);
            break;
        case 2:
            if (up)
                for (i = 0; i < stride; i++) cur[i] = (uint8_t)(in[i] + up[i]);
            else
                memcpy(cur, in, (size_t)stride);
            break;
        case 3:
            for (i = 0; i < stride; i++) {
                const int a = i >= bpp ? cur[i - bpp] : 0;
                const int b = up ? up[i] : 0;
                cur[i] = (uint8_t)(in[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (i = 0; i < stride; i++) {
                const int a = i >= bpp ? cur[i - bpp] : 0;
                const int b = up ? up[i] : 0;
                const int c = (up && i >= bpp) ? up[i - bpp] : 0;
                const int p = a + b - c;
                const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
                const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                cur[i] = (uint8_t)(in[i] + pred);
            }
            break;
        default:
            return (int)(y + 1);
        }
    }
    return 0;
}

/* ------------------------------------------------------------------------ */
/* JPEG: headers                                                             */
/* ------------------------------------------------------------------------ */

typedef struct {
    uint8_t nbits[17];        /* codes of each length 1..16 */
    uint8_t vals[256];
    int32_t maxcode[18];      /* largest code of each length, -1 if none */
    int32_t valptr[17];       /* index into vals of each length's first code */
    int32_t mincode[17];
    uint8_t look_len[512];    /* 9-bit lookahead: code length (0 = longer) */
    uint8_t look_val[512];
    int defined;
    int built;                /* the tables above made from nbits and vals */
} Huff;

typedef struct {
    int id, h, v, tq;
    int sv;                   /* the vertical factor the frame declares (a gray file's too) */
    int td, ta;               /* the current scan's tables */
    int bw, bh;               /* blocks across and down in the plane (whole MCUs) */
    int dw, dh;               /* downsampled width and height (libjpeg's) */
    uint8_t *plane;           /* bw * 8 by bh * 8 samples */
    int16_t *coef;            /* progressive: bw * bh blocks of 64 coefficients, natural order */
    uint16_t q[64];           /* the quantization table as it was at the component's first scan */
    int latched;
    int coef_bits[64];        /* progressive: the lowest bit sent of each zigzag coefficient, -1 = none */
    int prev_bits[10];        /* coef_bits 0-9 as they were before the component's latest scan */
    int pred;
    int ctx;                  /* arithmetic scans: the DC conditioning of the last difference */
    int seen;                 /* decoded in some scan */
} Comp;

typedef struct {
    const uint8_t *data, *end;
    int width, height, ncomp, hmax, vmax;
    int mcux, mcuy;
    int restart;
    int jfif, sof, progressive, arith;
    int svmax;                /* the largest declared vertical factor */
    int adobe, adobe_transform;
    int rgb;                  /* three components coded as RGB, not YCbCr */
    int eobrun;               /* progressive AC scans: blocks left in the current end-of-band run */
    int scans;                /* scans begun (libjpeg's input_scan_number) */
    int64_t last_good;        /* the iMCU row of the last MCU a scan decoded (last_good_iMCU_row) */
    int tail;                 /* reading the markers after a sequential file's one scan */
    uint16_t q[4][64];        /* natural order */
    int qdef[4];
    Huff dc[4], ac[4];
    uint8_t arith_l[16], arith_u[16], arith_k[16]; /* DAC conditioning: DC L and U, AC Kx */
    uint8_t dc_stats[16][64], ac_stats[16][256];   /* arithmetic statistics bins of each table */
    uint8_t fixed;            /* the bin of fixed probability 0.5 */
    Comp comp[3];
    char *err;
    int64_t errlen;
} Jpeg;

static const uint8_t ZIGZAG[64 + 16] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    /* extra entries so that a corrupt run past 63 lands in a spare slot */
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63,
};

static int fail(Jpeg *j, const char *msg) {
    if (j->errlen > 0) {
        strncpy(j->err, msg, (size_t)j->errlen - 1);
        j->err[j->errlen - 1] = 0;
    }
    return 1;
}

/* jdhuff.c jpeg_make_d_derived_tbl, run as libjpeg runs it, when a scan
 * first uses the table: a table with an all-ones code (or more codes than
 * fit), or a DC value above 15, is an error then, and not before. */
static int build_huff(Jpeg *j, Huff *t, int dc) {
    int code = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
        t->valptr[len] = k;
        t->mincode[len] = code;
        code += t->nbits[len];
        k += t->nbits[len];
        if (code >= (1 << len)) return fail(j, "bad Huffman table");
        t->maxcode[len] = t->nbits[len] ? code - 1 : -1;
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;
    for (int v = 0; dc && v < k; v++) {
        if (t->vals[v] > 15) return fail(j, "bad Huffman table");
    }
    memset(t->look_len, 0, sizeof t->look_len);
    code = 0;
    k = 0;
    for (int len = 1; len <= 9; len++) {
        for (int i = 0; i < t->nbits[len]; i++, k++, code++) {
            const int shift = 9 - len;
            for (int f = 0; f < (1 << shift); f++) {
                t->look_len[(code << shift) | f] = (uint8_t)len;
                t->look_val[(code << shift) | f] = t->vals[k];
            }
        }
        code <<= 1;
    }
    t->built = 1;
    return 0;
}

static int seg_len(Jpeg *j, const uint8_t *p, int *len) {
    if (p + 2 > j->end) return fail(j, "truncated marker segment");
    *len = (p[0] << 8) | p[1];
    if (*len < 2 || p + *len > j->end) return fail(j, "truncated marker segment");
    return 0;
}

/* The first marker at or after p (jdmarker.c next_marker: other bytes and
 * stuffed FF 00 pairs are skipped) -> its first FF byte, or end. */
static const uint8_t *next_marker(const uint8_t *p, const uint8_t *end) {
    for (;;) {
        while (p < end && *p != 0xFF) p++;
        const uint8_t *q = p;
        while (q < end && *q == 0xFF) q++;
        if (q >= end) return end;
        if (*q != 0) return p;
        p = q + 1;
    }
}

static int read_dqt(Jpeg *j, const uint8_t *p, int len) {
    const uint8_t *e = p + len;
    p += 2;
    while (p < e) {
        const int pq = p[0] >> 4, tq = p[0] & 15;
        p++;
        if (tq > 3 || pq > 1 || p + 64 * (pq + 1) > e) return fail(j, "bad quantization table");
        for (int i = 0; i < 64; i++) {
            j->q[tq][ZIGZAG[i]] = pq ? (uint16_t)((p[2 * i] << 8) | p[2 * i + 1]) : p[i];
        }
        p += 64 * (pq + 1);
        j->qdef[tq] = 1;
    }
    return 0;
}

static int read_dht(Jpeg *j, const uint8_t *p, int len) {
    const uint8_t *e = p + len;
    p += 2;
    while (p < e) {
        if (p + 17 > e) return fail(j, "bad Huffman table");
        const int tc = p[0] >> 4, th = p[0] & 15;
        if (tc > 1 || th > 3) return fail(j, "bad Huffman table");
        Huff *t = tc ? &j->ac[th] : &j->dc[th];
        int total = 0;
        t->nbits[0] = 0;
        for (int i = 1; i <= 16; i++) total += t->nbits[i] = p[i];
        p += 17;
        if (total > 256 || p + total > e) return fail(j, "bad Huffman table");
        memcpy(t->vals, p, (size_t)total);
        p += total;
        t->defined = 1;
        t->built = 0;
    }
    return 0;
}

/* jdmarker.c get_dac: (index, value) pairs; index 0-15 a DC table (L the
 * low nibble, U the high, L <= U), 16-31 an AC table (Kx). */
static int read_dac(Jpeg *j, const uint8_t *p, int len) {
    char msg[160];
    if (len % 2) return fail(j, "bad DAC segment (odd length)");
    for (int i = 2; i < len; i += 2) {
        const int index = p[i], val = p[i + 1];
        if (index >= 32) {
            snprintf(msg, sizeof msg, "bad DAC segment (table index %d)", index);
            return fail(j, msg);
        }
        if (index >= 16) {
            j->arith_k[index - 16] = (uint8_t)val;
        } else {
            j->arith_l[index] = (uint8_t)(val & 15);
            j->arith_u[index] = (uint8_t)(val >> 4);
            if ((val & 15) > (val >> 4)) {
                snprintf(msg, sizeof msg, "bad DAC segment (DC L %d above U %d)", val & 15, val >> 4);
                return fail(j, msg);
            }
        }
    }
    return 0;
}

static int read_sof(Jpeg *j, const uint8_t *p, int len) {
    char msg[160];
    if (len < 8) return fail(j, "bad SOF segment");
    if (p[2] != 8) {
        snprintf(msg, sizeof msg, "%d-bit samples (only 8-bit JPEG is read)", p[2]);
        return fail(j, msg);
    }
    j->height = (p[3] << 8) | p[4];
    j->width = (p[5] << 8) | p[6];
    j->ncomp = p[7];
    if (j->height == 0 || j->width == 0) return fail(j, "zero image size (DNL markers are not read)");
    if (j->ncomp != 1 && j->ncomp != 3) {
        snprintf(msg, sizeof msg, "%d components (only gray and three-component JPEG are read; CMYK/YCCK is not)", j->ncomp);
        return fail(j, msg);
    }
    if (len < 8 + 3 * j->ncomp) return fail(j, "bad SOF segment");
    j->hmax = j->vmax = 1;
    for (int c = 0; c < j->ncomp; c++) {
        Comp *k = &j->comp[c];
        k->id = p[8 + 3 * c];
        k->h = p[9 + 3 * c] >> 4;
        k->v = p[9 + 3 * c] & 15;
        k->tq = p[10 + 3 * c];
        if (k->h < 1 || k->h > 4 || k->v < 1 || k->v > 4 || k->tq > 3) return fail(j, "bad SOF component");
        k->sv = k->v;
        if (k->h > j->hmax) j->hmax = k->h;
        if (k->v > j->vmax) j->vmax = k->v;
    }
    j->svmax = j->vmax;
    if (j->ncomp == 1) {
        /* one component: its blocks are the MCUs, whatever its factors say */
        j->comp[0].h = j->comp[0].v = j->hmax = j->vmax = 1;
    }
    for (int c = 0; c < j->ncomp; c++) {
        Comp *k = &j->comp[c];
        if (j->hmax % k->h || j->vmax % k->v) {
            snprintf(msg, sizeof msg,
                     "sampling factors %dx%d against %dx%d (fractional sampling ratios are not read)",
                     k->h, k->v, j->hmax, j->vmax);
            return fail(j, msg);
        }
        for (int i = 0; i < 64; i++) k->coef_bits[i] = -1;
    }
    j->mcux = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
    j->mcuy = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
    for (int c = 0; c < j->ncomp; c++) {
        Comp *k = &j->comp[c];
        k->bw = j->mcux * k->h;
        k->bh = j->mcuy * k->v;
        k->dw = (int)(((int64_t)j->width * k->h + j->hmax - 1) / j->hmax);
        k->dh = (int)(((int64_t)j->height * k->v + j->vmax - 1) / j->vmax);
    }
    return 0;
}

/* After the scan, a segment of marker m at p that the end of the data
 * cuts: 1 (with the message) when libjpeg, which reads a segment as it
 * goes, fails on the bytes there are before it would wait for more
 * (jdmarker.c get_sof, get_sos, get_dht, get_dqt, get_dri, get_dac). */
static int cut_segment_fails(Jpeg *j, int m, const uint8_t *p) {
    const uint8_t *end = j->end;
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) return fail(j, "two frame headers");
    if (p + 2 > end) return 0;
    const int len = (p[0] << 8) | p[1];
    switch (m) {
    case 0xDA: /* its length checked against its component count */
        return p + 3 <= end && (len != 2 * p[2] + 6 || p[2] < 1 || p[2] > 4) ? fail(j, "bad SOS segment") : 0;
    case 0xDD:
        return len != 4 ? fail(j, "bad DRI segment") : 0;
    case 0xDB:
        return p + 3 <= end && (p[2] & 15) > 3 ? fail(j, "bad quantization table") : 0;
    case 0xCC:
        for (const uint8_t *q = p + 2; q + 2 <= end && q + 2 <= p + len; q += 2) {
            if (q[0] >= 32 || (q[0] < 16 && (q[1] & 15) > (q[1] >> 4))) return fail(j, "bad DAC segment");
        }
        return 0;
    case 0xC4:
        for (const uint8_t *q = p + 2; q + 17 <= end && p + len - q > 16; ) {
            int count = 0;
            for (int i = 1; i <= 16; i++) count += q[i];
            if (count > 256 || count > p + len - q - 17) return fail(j, "bad Huffman table");
            if (q + 17 + count > end) return 0; /* its values cut: libjpeg waits */
            if ((q[0] & ~0x10) > 3) return fail(j, "bad Huffman table");
            q += 17 + count;
        }
        return 0;
    default:
        return 0;
    }
}

/* Walk the markers up to the next SOS (*pos <- its segment): tables,
 * restart interval, frame header, JFIF and Adobe markers, as jdmarker.c
 * read_markers takes them (a second SOI or frame header, a DRI segment not
 * 4 bytes long and the reserved markers are errors). At EOI, *eoi <- 1 when
 * eoi is given, else it is an error. After the one scan of a sequential
 * file (j->tail), where PIL's jpeg_finish_decompress reads on to EOI, the
 * end of the data, even inside a segment, ends the walk as EOI does (libjpeg
 * waits for more data, and PIL, its rows out, stops), and SOS is an error. */
static int read_markers(Jpeg *j, const uint8_t **pos, int *eoi) {
    const uint8_t *p = *pos;
    char msg[160];
    for (;;) {
        p = next_marker(p, j->end); /* junk between segments is skipped */
        if (p >= j->end && j->tail) {
            *eoi = 1;
            return 0;
        }
        if (p >= j->end) return fail(j, "no SOS marker before the end of the data");
        while (*p == 0xFF) p++;
        const int m = *p++;
        int len = 0;
        if (m == 0xD8) return fail(j, "a second SOI marker");
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
        if (m == 0xD9) {
            if (!eoi) return fail(j, "EOI before a scan of every component");
            *eoi = 1;
            *pos = p;
            return 0;
        }
        if (m < 0xC0 || m == 0xC8 || m == 0xDE || m == 0xDF || (m >= 0xF0 && m <= 0xFD)) {
            snprintf(msg, sizeof msg, "unexpected marker 0xFF%02X", m); /* reserved: libjpeg stops at once */
            return fail(j, msg);
        }
        if (j->tail && (p + 2 > j->end || p + ((p[0] << 8) | p[1]) > j->end)) {
            if (cut_segment_fails(j, m, p)) return 1;
            *eoi = 1; /* libjpeg waits for the rest of the segment */
            return 0;
        }
        if (seg_len(j, p, &len)) return 1;
        switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC9:
        case 0xCA:
            if (j->sof) return fail(j, "two frame headers");
            j->sof = m;
            j->progressive = m == 0xC2 || m == 0xCA;
            j->arith = m >= 0xC9;
            if (read_sof(j, p, len)) return 1;
            break;
        case 0xC3:
        case 0xCB:
            snprintf(msg, sizeof msg, "lossless JPEG (SOF%d; only sequential and progressive JPEG is read)", m - 0xC0);
            return fail(j, msg);
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF:
            snprintf(msg, sizeof msg,
                     "hierarchical JPEG (SOF%d; only sequential and progressive JPEG is read)", m - 0xC0);
            return fail(j, msg);
        case 0xCC:
            if (read_dac(j, p, len)) return 1;
            break;
        case 0xC4:
            if (read_dht(j, p, len)) return 1;
            break;
        case 0xDB:
            if (read_dqt(j, p, len)) return 1;
            break;
        case 0xDD:
            if (len != 4) return fail(j, "bad DRI segment");
            j->restart = (p[2] << 8) | p[3];
            break;
        case 0xDC:
            if (!j->tail) return fail(j, "DNL marker (not read)");
            break;
        case 0xE0:
            /* jdmarker.c examine_app0: a JFIF marker has 14 bytes of data */
            if (len >= 16 && memcmp(p + 2, "JFIF\0", 5) == 0) j->jfif = 1;
            break;
        case 0xEE:
            /* examine_app14: 12 bytes of data, the transform last */
            if (len >= 14 && memcmp(p + 2, "Adobe", 5) == 0) {
                j->adobe = 1;
                j->adobe_transform = p[13];
            }
            break;
        case 0xDA:
            if (j->tail) return fail(j, "a second scan where EOI was expected");
            *pos = p;
            return 0;
        default:
            break; /* APPn and COM: skipped */
        }
        p += len;
    }
}

/* The colour space of three components (jdapimin.c default_decompress_parms). */
static int check_frame(Jpeg *j) {
    if (!j->sof) return fail(j, "no SOF0/SOF1/SOF2/SOF9/SOF10 frame header before the scan");
    if (j->ncomp == 3) {
        if (j->jfif)
            j->rgb = 0;
        else if (j->adobe)
            j->rgb = j->adobe_transform == 0;
        else
            j->rgb = j->comp[0].id == 'R' && j->comp[1].id == 'G' && j->comp[2].id == 'B';
    }
    return 0;
}

/* ------------------------------------------------------------------------ */
/* JPEG: entropy decoding                                                    */
/* ------------------------------------------------------------------------ */

#define TRUNCATED "image file is truncated (the data ends inside a scan)"

/* The entropy-coded bytes of a segment end at a marker (marker 1; p stays
 * on its first FF) or, in a cut file, at the end of the data (marker 2).
 * From there fill feeds zero bits, counted in zeros: a read took bits past
 * the segment's data once nbits < zeros, which libjpeg-turbo calls
 * insufficient data (jdhuff.c jpeg_fill_bit_buffer). FF bytes followed by
 * 00 are one FF data byte, however many FFs come first, as libjpeg reads
 * them. */
typedef struct {
    const uint8_t *p, *end;
    uint64_t acc;   /* bits left-aligned */
    int nbits;
    int marker;     /* 1: a marker was met; 2: the data ended */
    int zeros;      /* zero bits fed after the marker or the end */
} Bits;

static void fill(Bits *b) {
    while (b->nbits <= 56) {
        int c = 0;
        if (b->marker) {
            b->zeros += 8;
        } else if (b->p >= b->end) {
            b->marker = 2;
            b->zeros += 8;
        } else {
            c = *b->p;
            if (c == 0xFF) {
                const uint8_t *q = b->p + 1;
                while (q < b->end && *q == 0xFF) q++;
                if (q < b->end && *q == 0x00) {
                    b->p = q + 1;
                } else {
                    b->marker = q < b->end ? 1 : 2; /* p stays on the marker */
                    b->zeros += 8;
                    c = 0;
                }
            } else {
                b->p++;
            }
        }
        b->acc |= (uint64_t)c << (56 - b->nbits);
        b->nbits += 8;
    }
}

static inline int get_bits(Bits *b, int n) {
    if (n == 0) return 0;
    if (b->nbits < n) fill(b);
    const int v = (int)(b->acc >> (64 - n));
    b->acc <<= n;
    b->nbits -= n;
    return v;
}

static inline int extend(int v, int n) {
    return v < (1 << (n - 1)) ? v - (1 << n) + 1 : v;
}

static inline int decode_huff(Bits *b, const Huff *t) {
    if (b->nbits < 16) fill(b);
    const int look = (int)(b->acc >> (64 - 9));
    int len = t->look_len[look];
    if (len) {
        b->acc <<= len;
        b->nbits -= len;
        return t->look_val[look];
    }
    int code = (int)(b->acc >> (64 - 10));
    for (len = 10; len <= 16 && code > t->maxcode[len]; len++) code = (int)(b->acc >> (64 - len - 1));
    if (len > 16) {
        /* a code no table holds: corrupt data; libjpeg reads a 17th bit,
         * warns and yields 0 (jdhuff.c jpeg_huff_decode) */
        if (b->nbits < 17) fill(b);
        b->acc <<= 17;
        b->nbits -= 17;
        return 0;
    }
    b->acc <<= len;
    b->nbits -= len;
    return t->vals[t->valptr[len] + code - t->mincode[len]];
}

/* jidctint.c (libjpeg-turbo's jpeg_idct_islow): CONST_BITS 13, PASS1_BITS 2 */
#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int32_t)2446)
#define FIX_0_390180644 ((int32_t)3196)
#define FIX_0_541196100 ((int32_t)4433)
#define FIX_0_765366865 ((int32_t)6270)
#define FIX_0_899976223 ((int32_t)7373)
#define FIX_1_175875602 ((int32_t)9633)
#define FIX_1_501321110 ((int32_t)12299)
#define FIX_1_847759065 ((int32_t)15137)
#define FIX_1_961570560 ((int32_t)16069)
#define FIX_2_053119869 ((int32_t)16819)
#define FIX_2_562915447 ((int32_t)20995)
#define FIX_3_072711026 ((int32_t)25172)
#define DESCALE(x, n) (((x) + ((int32_t)1 << ((n) - 1))) >> (n))

/* The islow IDCT as libjpeg-turbo's x86-64 SIMD code computes it
 * (jidctint-sse2.asm, jidctint-avx2.asm: what PIL runs there). It equals
 * jidctint.c's C wherever no 16-bit lane overflows, as for every block an
 * 8-bit encoder writes, except that its final values saturate to -128..127
 * before the +128 (packsswb) where the C's range table wraps beyond
 * -512..511. idct_islow runs the C's two passes, its final values through
 * a saturating table, and takes a block to idct_islow_lanes only when one
 * of pass 1's outputs leaves -2^14..2^14 - 1: inside it, every input,
 * 16-bit sum and output of both passes lies inside int16 (pass 1 is
 * 4 * sqrt(8) times an orthogonal map, so its inputs are at most a quarter
 * of the largest output), and the two agree.
 * idct_islow_lanes follows the lanes wherever they decide: each
 * coefficient is dequantized to 16 bits (pmullw), in0 + in4, in0 - in4 and
 * the odd part's in7 + in3 and in5 + in1 are 16-bit sums (paddw), the even
 * and odd products 32-bit (pmaddwd), pass 1's outputs saturate to 16 bits
 * (packssdw). A block whose rows 1-7 are all zero takes pass 1's DC path,
 * a 16-bit shift that wraps (psllw). */

static inline int32_t wrap16(int32_t x) {
    return (int16_t)(uint16_t)(uint32_t)x;
}

static inline int32_t sat16(int32_t x) {
    return x < -32768 ? -32768 : x > 32767 ? 32767 : x;
}

static inline uint8_t sample(int32_t x) {
    return (uint8_t)((x < -128 ? -128 : x > 127 ? 127 : x) + 128);
}

/* 1 when one of the 8 values lies outside int16 */
static inline int beyond16(const int32_t *v) {
    int32_t m = 0;
    for (int i = 0; i < 8; i++) m |= v[i] ^ (v[i] >> 31);
    return m > 32767;
}

/* the block's rows 1-7 all zero: pass 1's DC path of the SIMD code */
static int dc_block(const int16_t *coef) {
    int ac = 0;
    for (int i = 8; i < 64; i++) ac |= coef[i];
    return !ac;
}

/* kept out of line: no block an 8-bit encoder writes reaches it */
#if defined(__GNUC__)
__attribute__((noinline, cold))
#endif
static void idct_islow_lanes(const int16_t *coef, const uint16_t *q, uint8_t *out, int stride) {
    int32_t ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t *in = coef + c;
        const uint16_t *qc = q + c;
        int32_t *w = ws + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
            /* a column of zero AC: the block's DC path wraps, the full
             * column saturates (the same unless 4 * DC leaves int16) */
            int32_t dc = wrap16((int32_t)in[0] * qc[0]) * (1 << PASS1_BITS);
            if (dc != wrap16(dc)) dc = dc_block(coef) ? wrap16(dc) : sat16(dc);
            for (int r = 0; r < 8; r++) w[8 * r] = dc;
            continue;
        }
        const int32_t d0 = wrap16((int32_t)in[0] * qc[0]), d1 = wrap16((int32_t)in[8] * qc[8]);
        const int32_t d2 = wrap16((int32_t)in[16] * qc[16]), d3 = wrap16((int32_t)in[24] * qc[24]);
        const int32_t d4 = wrap16((int32_t)in[32] * qc[32]), d5 = wrap16((int32_t)in[40] * qc[40]);
        const int32_t d6 = wrap16((int32_t)in[48] * qc[48]), d7 = wrap16((int32_t)in[56] * qc[56]);
        const int32_t tmp3e = d2 * (FIX_0_541196100 + FIX_0_765366865) + d6 * FIX_0_541196100;
        const int32_t tmp2e = d2 * FIX_0_541196100 + d6 * (FIX_0_541196100 - FIX_1_847759065);
        const int32_t tmp0e = wrap16(d0 + d4) * (1 << CONST_BITS), tmp1e = wrap16(d0 - d4) * (1 << CONST_BITS);
        const int32_t tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e, tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;
        const int32_t z3 = wrap16(d7 + d3), z4 = wrap16(d5 + d1);
        const int32_t z3o = z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602;
        const int32_t z4o = z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644);
        const int32_t tmp0 = d7 * (FIX_0_298631336 - FIX_0_899976223) + d1 * -FIX_0_899976223 + z3o;
        const int32_t tmp3 = d7 * -FIX_0_899976223 + d1 * (FIX_1_501321110 - FIX_0_899976223) + z4o;
        const int32_t tmp1 = d5 * (FIX_2_053119869 - FIX_2_562915447) + d3 * -FIX_2_562915447 + z4o;
        const int32_t tmp2 = d5 * -FIX_2_562915447 + d3 * (FIX_3_072711026 - FIX_2_562915447) + z3o;
        const int n = CONST_BITS - PASS1_BITS;
        int32_t o[8] = {DESCALE(tmp10 + tmp3, n), DESCALE(tmp11 + tmp2, n), DESCALE(tmp12 + tmp1, n),
                        DESCALE(tmp13 + tmp0, n), DESCALE(tmp13 - tmp0, n), DESCALE(tmp12 - tmp1, n),
                        DESCALE(tmp11 - tmp2, n), DESCALE(tmp10 - tmp3, n)};
        if (beyond16(o)) {
            for (int r = 0; r < 8; r++) o[r] = sat16(o[r]);
        }
        for (int r = 0; r < 8; r++) w[8 * r] = o[r];
    }
    for (int r = 0; r < 8; r++) {
        const int32_t *w = ws + 8 * r;
        uint8_t *o = out + (int64_t)r * stride;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            memset(o, sample(DESCALE(w[0] * (1 << CONST_BITS), CONST_BITS + PASS1_BITS + 3)), 8);
            continue;
        }
        const int32_t tmp3e = w[2] * (FIX_0_541196100 + FIX_0_765366865) + w[6] * FIX_0_541196100;
        const int32_t tmp2e = w[2] * FIX_0_541196100 + w[6] * (FIX_0_541196100 - FIX_1_847759065);
        const int32_t tmp0e = wrap16(w[0] + w[4]) * (1 << CONST_BITS), tmp1e = wrap16(w[0] - w[4]) * (1 << CONST_BITS);
        const int32_t tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e, tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;
        const int32_t z3 = wrap16(w[7] + w[3]), z4 = wrap16(w[5] + w[1]);
        const int32_t z3o = z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602;
        const int32_t z4o = z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644);
        const int32_t tmp0 = w[7] * (FIX_0_298631336 - FIX_0_899976223) + w[1] * -FIX_0_899976223 + z3o;
        const int32_t tmp3 = w[7] * -FIX_0_899976223 + w[1] * (FIX_1_501321110 - FIX_0_899976223) + z4o;
        const int32_t tmp1 = w[5] * (FIX_2_053119869 - FIX_2_562915447) + w[3] * -FIX_2_562915447 + z4o;
        const int32_t tmp2 = w[5] * -FIX_2_562915447 + w[3] * (FIX_3_072711026 - FIX_2_562915447) + z3o;
        const int n = CONST_BITS + PASS1_BITS + 3;
        o[0] = sample(DESCALE(tmp10 + tmp3, n));
        o[7] = sample(DESCALE(tmp10 - tmp3, n));
        o[1] = sample(DESCALE(tmp11 + tmp2, n));
        o[6] = sample(DESCALE(tmp11 - tmp2, n));
        o[2] = sample(DESCALE(tmp12 + tmp1, n));
        o[5] = sample(DESCALE(tmp12 - tmp1, n));
        o[3] = sample(DESCALE(tmp13 + tmp0, n));
        o[4] = sample(DESCALE(tmp13 - tmp0, n));
    }
}

/* sample(x) by table for |x| < 8192, which holds for every output of
 * idct_islow's second pass (at most a quarter of pass 1's largest value) */
static uint8_t IDCT_LIMIT[16384];

static void init_limit(void) {
    for (int i = 0; i < 16384; i++) IDCT_LIMIT[i] = sample(i < 8192 ? i : i - 16384);
}

static void idct_islow(const int16_t *coef, const uint16_t *q, uint8_t *out, int stride) {
    int32_t ws[64];
    uint32_t m = 0; /* the OR of pass 1's outputs, each biased by 2^14 */
    for (int c = 0; c < 8; c++) {
        const int16_t *in = coef + c;
        const uint16_t *qc = q + c;
        int32_t *w = ws + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
            const int32_t dc = ((int32_t)in[0] * qc[0]) * (1 << PASS1_BITS);
            m |= (uint32_t)dc + 16384u;
            for (int r = 0; r < 8; r++) w[8 * r] = dc;
            continue;
        }
        int32_t z2 = (int32_t)in[16] * qc[16], z3 = (int32_t)in[48] * qc[48];
        int32_t z1 = (z2 + z3) * FIX_0_541196100;
        int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int32_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int32_t)in[0] * qc[0];
        z3 = (int32_t)in[32] * qc[32];
        int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = (int32_t)in[56] * qc[56];
        tmp1 = (int32_t)in[40] * qc[40];
        tmp2 = (int32_t)in[24] * qc[24];
        tmp3 = (int32_t)in[8] * qc[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int32_t z4 = tmp1 + tmp3;
        const int32_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS - PASS1_BITS;
        const int32_t o0 = DESCALE(tmp10 + tmp3, n), o7 = DESCALE(tmp10 - tmp3, n);
        const int32_t o1 = DESCALE(tmp11 + tmp2, n), o6 = DESCALE(tmp11 - tmp2, n);
        const int32_t o2 = DESCALE(tmp12 + tmp1, n), o5 = DESCALE(tmp12 - tmp1, n);
        const int32_t o3 = DESCALE(tmp13 + tmp0, n), o4 = DESCALE(tmp13 - tmp0, n);
        m |= ((uint32_t)o0 + 16384u) | ((uint32_t)o1 + 16384u) | ((uint32_t)o2 + 16384u) |
             ((uint32_t)o3 + 16384u) | ((uint32_t)o4 + 16384u) | ((uint32_t)o5 + 16384u) |
             ((uint32_t)o6 + 16384u) | ((uint32_t)o7 + 16384u);
        w[0] = o0;
        w[8] = o1;
        w[16] = o2;
        w[24] = o3;
        w[32] = o4;
        w[40] = o5;
        w[48] = o6;
        w[56] = o7;
    }
    if (m >> 15) { /* a pass-1 output outside -2^14..2^14 - 1 */
        idct_islow_lanes(coef, q, out, stride);
        return;
    }
    for (int r = 0; r < 8; r++) {
        const int32_t *w = ws + 8 * r;
        uint8_t *o = out + (int64_t)r * stride;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            memset(o, IDCT_LIMIT[DESCALE(w[0], PASS1_BITS + 3) & 16383], 8);
            continue;
        }
        int32_t z2 = w[2], z3 = w[6];
        int32_t z1 = (z2 + z3) * FIX_0_541196100;
        int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int32_t tmp3 = z1 + z2 * FIX_0_765366865;
        int32_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
        int32_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
        const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int32_t z4 = tmp1 + tmp3;
        const int32_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS + PASS1_BITS + 3;
        o[0] = IDCT_LIMIT[DESCALE(tmp10 + tmp3, n) & 16383];
        o[7] = IDCT_LIMIT[DESCALE(tmp10 - tmp3, n) & 16383];
        o[1] = IDCT_LIMIT[DESCALE(tmp11 + tmp2, n) & 16383];
        o[6] = IDCT_LIMIT[DESCALE(tmp11 - tmp2, n) & 16383];
        o[2] = IDCT_LIMIT[DESCALE(tmp12 + tmp1, n) & 16383];
        o[5] = IDCT_LIMIT[DESCALE(tmp12 - tmp1, n) & 16383];
        o[3] = IDCT_LIMIT[DESCALE(tmp13 + tmp0, n) & 16383];
        o[4] = IDCT_LIMIT[DESCALE(tmp13 - tmp0, n) & 16383];
    }
}

static void decode_block(Bits *b, Comp *k, const Huff *dc, const Huff *ac, int bx, int by) {
    int16_t coef[64 + 16];
    memset(coef, 0, sizeof coef);
    const int t = decode_huff(b, dc);
    const int diff = t ? extend(get_bits(b, t), t) : 0;
    k->pred += diff;
    coef[0] = (int16_t)k->pred;
    for (int i = 1; i < 64; i++) {
        const int rs = decode_huff(b, ac);
        const int r = rs >> 4, s = rs & 15;
        if (s) {
            i += r;
            coef[ZIGZAG[i < 64 ? i : 64]] = (int16_t)extend(get_bits(b, s), s);
        } else if (r == 15) {
            i += 15;
        } else {
            break;
        }
    }
    const int stride = k->bw * 8;
    idct_islow(coef, k->q, k->plane + ((int64_t)by * 8) * stride + (int64_t)bx * 8, stride);
}

/* Progressive scans (jdphuff.c): coefficients are stored unscaled and
 * shifted left by the scan's Al; a refinement adds bit Al. */

static inline int16_t shifted(int v, int al) {
    return (int16_t)(uint16_t)((unsigned)v << al);
}

static void dc_first(Bits *b, Comp *k, const Huff *dc, int16_t *blk, int al) {
    const int t = decode_huff(b, dc);
    k->pred += t ? extend(get_bits(b, t), t) : 0;
    blk[0] = shifted(k->pred, al);
}

static void dc_refine(Bits *b, int16_t *blk, int al) {
    if (get_bits(b, 1)) blk[0] = (int16_t)(blk[0] | (1 << al));
}

static void ac_first(Jpeg *j, Bits *b, const Huff *ac, int16_t *blk, int ss, int se, int al) {
    if (j->eobrun > 0) {
        j->eobrun--;
        return;
    }
    for (int k = ss; k <= se; k++) {
        const int rs = decode_huff(b, ac);
        const int r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            blk[ZIGZAG[k]] = shifted(extend(get_bits(b, s), s), al);
        } else if (r == 15) {
            k += 15;
        } else {
            j->eobrun = 1 << r;
            if (r) j->eobrun += get_bits(b, r);
            j->eobrun--;
            break;
        }
    }
}

/* A correction bit for each coefficient already nonzero: 1 moves it away
 * from zero by 1 << al. */
static inline void correct(Bits *b, int16_t *c, int p1) {
    if (get_bits(b, 1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c - p1);
}

static void ac_refine(Jpeg *j, Bits *b, const Huff *ac, int16_t *blk, int ss, int se, int al) {
    const int p1 = 1 << al;
    int k = ss;
    if (j->eobrun == 0) {
        for (; k <= se; k++) {
            const int rs = decode_huff(b, ac);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                /* a newly nonzero coefficient of magnitude 1 << al; its sign bit */
                s = get_bits(b, 1) ? p1 : -p1;
            } else if (r != 15) {
                j->eobrun = 1 << r;
                if (r) j->eobrun += get_bits(b, r);
                break; /* the rest of the block is the end-of-band run's */
            }
            /* pass r zero coefficients (correcting the nonzero ones met on
             * the way), stopping on the zero that takes s */
            do {
                int16_t *c = blk + ZIGZAG[k];
                if (*c != 0) {
                    correct(b, c, p1);
                } else if (--r < 0) {
                    break;
                }
                k++;
            } while (k <= se);
            if (s) blk[ZIGZAG[k]] = (int16_t)s;
        }
    }
    if (j->eobrun > 0) {
        for (; k <= se; k++) {
            int16_t *c = blk + ZIGZAG[k];
            if (*c != 0) correct(b, c, p1);
        }
        j->eobrun--;
    }
}

/* jdmarker.c read_restart_marker and jpeg_resync_to_restart, at a restart
 * boundary: from p (on the marker the entropy decoder met, or where it
 * stopped: the rest is skipped) the next marker. RSTn, n = *rst, the one
 * expected, is consumed. Otherwise libjpeg resyncs: a marker below SOF0
 * (not a valid one) or one of the two restarts before n is skipped for the
 * marker after it; one of the two restarts after n, or any marker not a
 * restart, is left unread (*unread <- 1: the interval reads as zeros); any
 * other restart is consumed. *rst <- n + 1 mod 8. Returns the position, or
 * NULL when the data ends before a marker settles it: libjpeg's
 * next_marker then waits for data that never comes, and PIL raises. */
static const uint8_t *read_restart(const uint8_t *p, const uint8_t *end, int *rst, int *unread) {
    const int n = *rst;
    *rst = (n + 1) & 7;
    for (p = next_marker(p, end); p < end; p = next_marker(p, end)) {
        const uint8_t *q = p;
        while (*q == 0xFF) q++;
        const int m = *q;
        const int rn = m >= 0xD0 && m <= 0xD7 ? (m - 0xD0 - n) & 7 : -1; /* how far past n */
        if (rn == 0 || rn == 3 || rn == 4 || rn == 5) {
            *unread = 0;
            return q + 1;
        }
        if (!(m < 0xC0 || rn == 6 || rn == 7)) { /* rn 1, 2, or not a restart: left unread */
            *unread = 1;
            return p;
        }
        p = q + 1;
    }
    return NULL;
}

/* jdhuff.c / jdphuff.c process_restart: the bits left are dropped, the
 * marker read, the scan's DC predictions and end-of-band run reset; 1
 * (with the message) when the data ends first. */
static int restart(Jpeg *j, Bits *b, int *rst, Comp *const *sc, int ns) {
    b->acc = 0;
    b->nbits = 0;
    b->zeros = 0;
    b->p = read_restart(b->p, b->end, rst, &b->marker);
    if (b->p == NULL) return fail(j, TRUNCATED);
    for (int i = 0; i < ns; i++) sc[i]->pred = 0;
    j->eobrun = 0;
    return 0;
}

/* The SOS segment at p: a scan's components, spectral band and bit
 * position, checked as jdphuff.c / jdarith.c start_pass check them (a
 * sequential scan's Ss, Se, Ah and Al are not read: libjpeg-turbo only
 * warns), its MCU count, and its first entropy-coded byte. The components
 * latch their quantization tables and the progressive bit record. */
typedef struct {
    int ns, ss, se, ah, al;
    Comp *sc[3];
    int64_t mcus, mcux;
    const uint8_t *data;
} Scan;

static int scan_header(Jpeg *j, const uint8_t *p, Scan *s) {
    int len;
    char msg[160];
    if (seg_len(j, p, &len)) return 1;
    const int ns = p[2];
    if (ns < 1 || ns > j->ncomp || len < 6 + 2 * ns) return fail(j, "bad SOS segment");
    const uint8_t *q = p + 3 + 2 * ns;
    const int ss = q[0], se = q[1], ah = q[2] >> 4, al = q[2] & 15;
    if (!j->progressive) {
        /* jdhuff.c / jdarith.c start_pass: a warning; the block is read whole */
    } else if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) {
        snprintf(msg, sizeof msg, "bad progressive scan (Ss %d, Se %d over %d components)", ss, se, ns);
        return fail(j, msg);
    } else if ((ah != 0 && al != ah - 1) || al > 13) {
        snprintf(msg, sizeof msg, "bad successive approximation (Ah %d, Al %d)", ah, al);
        return fail(j, msg);
    }
    /* which Huffman tables the scan reads: sequential both; progressive DC
     * first scans the DC table, AC scans the AC table, DC refinements none.
     * Arithmetic scans read statistics bins, which every table number has. */
    const int need_dc = !j->arith && (!j->progressive || (ss == 0 && ah == 0));
    const int need_ac = !j->arith && (!j->progressive || ss > 0);
    int blocks = 0;
    j->scans++;
    for (int i = 0; i < ns; i++) {
        const int id = p[3 + 2 * i], tables = p[4 + 2 * i];
        s->sc[i] = NULL;
        for (int c = 0; c < j->ncomp; c++) {
            if (j->comp[c].id == id) s->sc[i] = &j->comp[c];
        }
        if (!s->sc[i]) return fail(j, "SOS names a component the frame has not");
        Comp *k = s->sc[i];
        k->td = tables >> 4;
        k->ta = tables & 15;
        if (!j->arith &&
            (k->td > 3 || k->ta > 3 || (need_dc && !j->dc[k->td].defined) || (need_ac && !j->ac[k->ta].defined))) {
            return fail(j, "SOS uses an undefined Huffman table");
        }
        if ((need_dc && !j->dc[k->td].built && build_huff(j, &j->dc[k->td], 1)) ||
            (need_ac && !j->ac[k->ta].built && build_huff(j, &j->ac[k->ta], 0))) {
            return 1;
        }
        if (!k->latched) {
            /* jdinput.c latch_quant_tables: a component keeps the table
             * it had at its first scan */
            if (!j->qdef[k->tq]) return fail(j, "a component uses an undefined quantization table");
            memcpy(k->q, j->q[k->tq], sizeof k->q);
            k->latched = 1;
        }
        k->seen = 1;
        k->pred = 0;
        k->ctx = 0;
        blocks += k->h * k->v;
        if (j->progressive) {
            /* jdphuff.c / jdarith.c start_pass: the record before this
             * scan, which smoothing takes for rows the scan left unread */
            for (int c = ss < 1 ? ss : 1; c < 10; c++) k->prev_bits[c] = j->scans > 1 ? k->coef_bits[c] : 0;
            for (int c = ss; c <= se; c++) k->coef_bits[c] = al;
        }
    }
    if (ns > 1 && blocks > 10) {
        snprintf(msg, sizeof msg, "%d blocks per MCU (libjpeg reads at most 10)", blocks);
        return fail(j, msg);
    }
    if (ns == 1) {
        /* non-interleaved: one block per MCU over the component's own blocks */
        const Comp *k = s->sc[0];
        s->mcux = (k->dw + 7) / 8;
        s->mcus = s->mcux * ((k->dh + 7) / 8);
    } else {
        s->mcux = j->mcux;
        s->mcus = (int64_t)j->mcux * j->mcuy;
    }
    s->ns = ns;
    s->ss = ss;
    s->se = se;
    s->ah = ah;
    s->al = al;
    s->data = p + len;
    return 0;
}

/* ------------------------------------------------------------------------ */
/* JPEG: damaged and cut-off Huffman scans                                   */
/* ------------------------------------------------------------------------ */

/* The iMCU row (8 * the largest declared vertical factor pixel rows) of
 * the scan's MCU m: an interleaved scan's MCU row, or a one-component
 * scan's block row over that component's declared vertical factor. */
static int64_t imcu_row(const Scan *s, int64_t m) {
    return m / s->mcux / (s->ns == 1 ? s->sc[0]->sv : 1);
}

/* MCUs m0 .. m0 + n - 1 of a sequential scan, which libjpeg leaves zero
 * once its data has run out: every sample 128. */
static void gray_mcus(const Scan *s, int64_t m0, int64_t n) {
    for (int64_t m = m0; m < m0 + n; m++) {
        const int64_t mx = m % s->mcux, my = m / s->mcux;
        for (int i = 0; i < s->ns; i++) {
            const Comp *k = s->sc[i];
            const int nh = s->ns == 1 ? 1 : k->h, nv = s->ns == 1 ? 1 : k->v, stride = k->bw * 8;
            for (int v = 0; v < nv; v++) {
                for (int h = 0; h < nh; h++) {
                    uint8_t *o = k->plane + ((my * nv + v) * 8) * (int64_t)stride + (mx * nh + h) * 8;
                    for (int r = 0; r < 8; r++) memset(o + (int64_t)r * stride, 128, 8);
                }
            }
        }
    }
}

/* libjpeg-turbo's Huffman bit reader as PIL feeds it, counting bits only:
 * jdhuff.c's jpeg_fill_bit_buffer (it reads until 57 bits are held, or a
 * marker), decode_mcu_slow (it fills when a code's first 8 bits are not
 * held, and then for each bit it lacks), decode_mcu_fast (while 512 bytes
 * per block remain and no restart interval is set: 6 bytes when 16 bits or
 * fewer are held; an MCU that meets a marker is read again slowly) and
 * process_restart. PIL reads the file in 64 KiB blocks; libjpeg suspends
 * when it wants a byte past those read, and reads the MCU again with the
 * next block. At the file's end PIL raises "image file is truncated". */
#define PIL_BLOCK 65536

typedef struct {
    const uint8_t *p, *avail;  /* the next byte; the end of what PIL has read */
    uint64_t buf;
    int left;                  /* bits held */
    int marker;                /* a marker was met (p on it) */
    int insufficient;          /* a bit past it was read: MCUs are skipped */
} Lj;

/* 1 when libjpeg suspends */
static int lj_fill(Lj *w, int nbits) {
    while (!w->marker && w->left < 57) {
        if (w->p >= w->avail) return 1;
        const uint8_t *q = w->p;
        int c = *q++;
        if (c == 0xFF) {
            do {
                if (q >= w->avail) return 1;
                c = *q++;
            } while (c == 0xFF);
            if (c) {
                w->marker = 1;
                break;
            }
            c = 0xFF;
        }
        w->p = q;
        w->buf = (w->buf << 8) | (uint64_t)c;
        w->left += 8;
    }
    if (w->marker && nbits > w->left) {
        w->insufficient = 1;
        w->buf <<= 57 - w->left;
        w->left = 57;
    }
    return 0;
}

static int lj_bits(Lj *w, int n) {
    if (w->left < n && lj_fill(w, n)) return 1;
    w->left -= n;
    return 0;
}

/* A Huffman code (HUFF_DECODE, jpeg_huff_decode); *sym <- its value. */
static int lj_huff(Lj *w, const Huff *t, int *sym) {
    int len = 1, code;
    if (w->left < 8 && lj_fill(w, 0)) return 1;
    if (w->left >= 8) {
        const int look = (int)(w->buf >> (w->left - 8)) & 0xFF;
        for (; len <= 8; len++) {
            if ((look >> (8 - len)) <= t->maxcode[len]) {
                w->left -= len;
                *sym = t->vals[t->valptr[len] + (look >> (8 - len)) - t->mincode[len]];
                return 0;
            }
        }
    }
    if (lj_bits(w, len)) return 1;
    code = (int)(w->buf >> w->left) & ((1 << len) - 1);
    while (code > t->maxcode[len]) {
        if (lj_bits(w, 1)) return 1;
        code = (code << 1) | (int)((w->buf >> w->left) & 1);
        len++;
    }
    *sym = len > 16 ? 0 : t->vals[t->valptr[len] + code - t->mincode[len]];
    return 0;
}

static int lj_mcu_slow(Lj *w, const Huff *const *dc, const Huff *const *ac, int nblk) {
    for (int i = 0; i < nblk; i++) {
        int s;
        if (lj_huff(w, dc[i], &s) || (s && lj_bits(w, s))) return 1;
        for (int k = 1; k < 64; k++) {
            if (lj_huff(w, ac[i], &s)) return 1;
            if (s & 15) {
                k += s >> 4;
                if (lj_bits(w, s & 15)) return 1;
            } else if (s >> 4 == 15) {
                k += 15;
            } else {
                break;
            }
        }
    }
    return 0;
}

static void lj_fill_fast(Lj *w) {
    if (w->left > 16) return;
    for (int i = 0; i < 6; i++) { /* GET_BYTE: at a marker, zeros and p kept on it */
        const int c0 = w->p[0], c1 = w->p[1];
        w->p++;
        w->buf = (w->buf << 8) | (uint64_t)c0;
        w->left += 8;
        if (c0 == 0xFF) {
            w->p++;
            if (c1) {
                w->marker = 1;
                w->p -= 2;
                w->buf &= ~(uint64_t)0xFF;
            }
        }
    }
}

static int lj_huff_fast(Lj *w, const Huff *t) {
    lj_fill_fast(w);
    const int look = (int)(w->buf >> (w->left - 8)) & 0xFF;
    for (int len = 1; len <= 8; len++) {
        if ((look >> (8 - len)) <= t->maxcode[len]) {
            w->left -= len;
            return t->vals[t->valptr[len] + (look >> (8 - len)) - t->mincode[len]];
        }
    }
    int len = 9;
    w->left -= len;
    int code = (int)(w->buf >> w->left) & 511;
    while (code > t->maxcode[len]) {
        w->left--;
        code = (code << 1) | (int)((w->buf >> w->left) & 1);
        len++;
    }
    return len > 16 ? 0 : t->vals[t->valptr[len] + code - t->mincode[len]];
}

/* 0 when the MCU met a marker (it is then read again slowly) */
static int lj_mcu_fast(Lj *w, const Huff *const *dc, const Huff *const *ac, int nblk) {
    for (int i = 0; i < nblk; i++) {
        int s = lj_huff_fast(w, dc[i]);
        if (s) {
            lj_fill_fast(w);
            w->left -= s;
        }
        for (int k = 1; k < 64; k++) {
            s = lj_huff_fast(w, ac[i]);
            if (s & 15) {
                k += s >> 4;
                lj_fill_fast(w);
                w->left -= s & 15;
            } else if (s >> 4 == 15) {
                k += 15;
            } else {
                break;
            }
        }
    }
    return !w->marker;
}

/* 1 when libjpeg, fed the file as PIL feeds it, suspends at its end before
 * the last MCU of the sequential scan s: then PIL raises. */
static int huff_suspends(const Jpeg *j, const Scan *s) {
    const Huff *dc[10], *ac[10];
    int nblk = 0;
    for (int i = 0; i < s->ns; i++) {
        const Comp *k = s->sc[i];
        const int n = s->ns == 1 ? 1 : k->h * k->v;
        for (int b = 0; b < n; b++, nblk++) {
            dc[nblk] = &j->dc[k->td];
            ac[nblk] = &j->ac[k->ta];
        }
    }
    const int64_t size = j->end - j->data;
    Lj st = {s->data, j->data + (size < PIL_BLOCK ? size : PIL_BLOCK), 0, 0, 0, 0};
    int todo = j->restart, rst = 0;
    for (int64_t m = 0; m < s->mcus;) {
        Lj w = st;
        int left_todo = todo, next_rst = rst, susp = 0, fast = !j->restart;
        if (j->restart && left_todo == 0) {
            w.left = 0;
            w.p = read_restart(w.p, w.avail, &next_rst, &w.marker);
            susp = w.p == NULL;
            if (!w.marker) w.insufficient = 0;
            left_todo = j->restart;
        }
        if (!susp && !w.insufficient) {
            Lj f = w;
            if (fast && w.avail - w.p >= 512 * nblk && !w.marker && lj_mcu_fast(&f, dc, ac, nblk))
                w = f;
            else
                susp = lj_mcu_slow(&w, dc, ac, nblk);
        }
        if (susp) {
            if (st.avail == j->end) return 1;
            st.avail = j->end - st.avail > PIL_BLOCK ? st.avail + PIL_BLOCK : j->end;
            continue; /* the same MCU with the next block read */
        }
        st = w;
        todo = left_todo - (j->restart != 0);
        rst = next_rst;
        m++;
    }
    return 0;
}

/* MCU m of the Huffman scan s: sequential blocks through the IDCT into
 * each component's plane, progressive ones into its coefficients. */
static inline void huff_mcu(Jpeg *j, Bits *b, const Scan *s, Comp *const *sc, int64_t m) {
    const int ns = s->ns, ss = s->ss, se = s->se, ah = s->ah, al = s->al;
    const int mx = (int)(m % s->mcux), my = (int)(m / s->mcux);
    for (int i = 0; i < ns; i++) {
        Comp *k = sc[i];
        const Huff *dc = &j->dc[k->td], *ac = &j->ac[k->ta];
        if (!j->progressive) {
            if (ns == 1) {
                decode_block(b, k, dc, ac, mx, my);
                continue;
            }
            for (int v = 0; v < k->v; v++) {
                for (int h = 0; h < k->h; h++) decode_block(b, k, dc, ac, mx * k->h + h, my * k->v + v);
            }
            continue;
        }
        const int nh = ns == 1 ? 1 : k->h, nv = ns == 1 ? 1 : k->v;
        for (int v = 0; v < nv; v++) {
            for (int h = 0; h < nh; h++) {
                int16_t *blk = k->coef + ((int64_t)(my * nv + v) * k->bw + mx * nh + h) * 64;
                if (ss > 0)
                    (ah ? ac_refine : ac_first)(j, b, ac, blk, ss, se, al);
                else if (ah)
                    dc_refine(b, blk, al);
                else
                    dc_first(b, k, dc, blk, al);
            }
        }
    }
}

/* One Huffman scan starting at the SOS segment p; *pos <- the first byte
 * after its entropy-coded data. Past its data (at a marker, or the end of
 * a cut file) the scan follows libjpeg-turbo (jdhuff.c, jdphuff.c): the
 * MCU in which a bit past the data is read is decoded with zero bits, and
 * the MCUs after it are skipped up to the next restart that reads its
 * marker (sequential blocks stay zero: samples 128; progressive
 * coefficients keep what earlier scans gave; the end-of-band run stands).
 * A cut file (no marker after the data) raises as PIL does when libjpeg
 * would wait for more data: when a bit past the end is read, at a restart
 * with no marker after it, or when its bit reader, which reads up to 8
 * bytes ahead, reaches the end before the last MCU (huff_suspends); a
 * progressive file, or a sequential file of several scans, also when no
 * EOI follows (jpeg_decode). An intact MCU costs one test of b.marker,
 * which is set at most once per restart interval (two loops, a fast one
 * with no test but its bound, tied with it on the card: PERF.md, PR 17). */
static int decode_scan(Jpeg *j, const uint8_t *p, const uint8_t **pos) {
    Scan s;
    if (scan_header(j, p, &s)) return 1;
    Comp *const sc[3] = {s.sc[0], s.sc[1], s.sc[2]}; /* a local copy: no store aliases it */
    const int ns = s.ns;
    const int64_t mcus = s.mcus;
    Bits b = {s.data, j->end, 0, 0, 0, 0};
    j->eobrun = 0;
    int todo = j->restart, rst = 0;
    int skipping = 0; /* libjpeg's insufficient_data */
    for (int64_t m = 0; m < mcus; m++) {
        if (j->restart && todo == 0) {
            if (restart(j, &b, &rst, sc, ns)) return 1;
            todo = j->restart;
            if (skipping && b.marker) {
                /* the marker left unread keeps the interval skipped */
                const int64_t n = todo < mcus - m ? todo : mcus - m;
                if (!j->progressive) gray_mcus(&s, m, n);
                m += n - 1;
                todo = 0;
                continue;
            }
            skipping = 0;
        }
        huff_mcu(j, &b, &s, sc, m);
        todo--;
        if (b.marker && b.nbits < b.zeros) { /* MCU m read past the data */
            if (b.marker == 2) return fail(j, TRUNCATED);
            j->last_good = imcu_row(&s, m);
            const int64_t left = mcus - m - 1, n = j->restart && todo < left ? todo : left;
            if (!j->progressive) gray_mcus(&s, m + 1, n);
            m += n;
            todo -= (int)n;
            skipping = 1;
        }
    }
    if (!skipping) j->last_good = imcu_row(&s, mcus - 1);
    if (b.marker == 2 && !j->progressive && huff_suspends(j, &s)) return fail(j, TRUNCATED);
    /* the bits left of a partly read byte are dropped */
    *pos = next_marker(b.p, j->end);
    return 0;
}

/* ------------------------------------------------------------------------ */
/* JPEG: arithmetic decoding (T.81 Annex D, F.1.4 and G.1.3; jdarith.c)      */
/* ------------------------------------------------------------------------ */

/* T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
 * Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed estimate 0.5. */
#define V(qe, lps, mps, sw) (((uint32_t)(qe) << 16) | ((uint32_t)(mps) << 8) | ((uint32_t)(sw) << 7) | (uint32_t)(lps))
static const uint32_t ARITAB[114] = {
    V(0x5a1d, 1, 1, 1), V(0x2586, 14, 2, 0), V(0x1114, 16, 3, 0), V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0), V(0x01da, 23, 6, 0), V(0x00e5, 25, 7, 0), V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0), V(0x001a, 33, 10, 0), V(0x000d, 35, 11, 0), V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0), V(0x0001, 12, 13, 0), V(0x5a7f, 15, 15, 1), V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0), V(0x207c, 39, 18, 0), V(0x17b9, 40, 19, 0), V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0), V(0x09a1, 45, 22, 0), V(0x072f, 46, 23, 0), V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0), V(0x0303, 51, 26, 0), V(0x0240, 52, 27, 0), V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0), V(0x00f5, 57, 30, 0), V(0x00b7, 59, 31, 0), V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0), V(0x004e, 63, 34, 0), V(0x003b, 32, 35, 0), V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1), V(0x484c, 64, 38, 0), V(0x3a0d, 65, 39, 0), V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0), V(0x1f33, 69, 42, 0), V(0x19a8, 70, 43, 0), V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0), V(0x0e74, 74, 46, 0), V(0x0bfb, 75, 47, 0), V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0), V(0x0706, 79, 50, 0), V(0x05cd, 48, 51, 0), V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0), V(0x0363, 51, 54, 0), V(0x02d4, 52, 55, 0), V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0), V(0x01a4, 55, 58, 0), V(0x0160, 56, 59, 0), V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0), V(0x00cb, 59, 62, 0), V(0x00ab, 61, 63, 0), V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1), V(0x4d04, 80, 66, 0), V(0x412c, 81, 67, 0), V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0), V(0x293c, 84, 70, 0), V(0x2379, 86, 71, 0), V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0), V(0x174e, 72, 74, 0), V(0x1424, 72, 75, 0), V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0), V(0x0d51, 75, 78, 0), V(0x0bb6, 77, 79, 0), V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1), V(0x4d1c, 88, 82, 0), V(0x438e, 89, 83, 0), V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0), V(0x2eae, 92, 86, 0), V(0x299a, 93, 87, 0), V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1), V(0x4ca9, 95, 90, 0), V(0x44d9, 96, 91, 0), V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0), V(0x32b4, 99, 94, 0), V(0x2e17, 93, 86, 0), V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0), V(0x47e5, 102, 98, 0), V(0x41cf, 103, 99, 0), V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0), V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0), V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0),
};
#undef V

/* The decoder registers: C (the code value and its input bits), A (the
 * interval), ct (bits left in C's input byte; -16 before the first two
 * bytes, -1 after a bad code: the rest of the scan, up to a restart, is not
 * read). After a marker the input is zeros. jdarith.c reads a byte only when
 * it needs one and cannot wait for more data: a byte wanted past the end of
 * a cut file (ran_out) is an error, and PIL raises. */
typedef struct {
    const uint8_t *p, *end;
    int64_t c, a;
    int ct;
    int marker;     /* a marker was met: p stays on it */
    int ran_out;    /* a byte was wanted past the end of the data */
} Arith;

static int arith_byte(Arith *e) {
    if (e->marker) return 0;
    const uint8_t *q = e->p;
    while (q < e->end && *q == 0xFF) q++; /* extra FF bytes are swallowed */
    if (q >= e->end) {
        e->ran_out = 1;
        return 0;
    }
    if (q == e->p) {
        e->p++;
        return *q;
    }
    if (*q == 0) {
        e->p = q + 1;
        return 0xFF; /* a stuffed zero */
    }
    e->marker = 1;
    return 0;
}

/* One binary decision in the statistics bin st (D.2.4-D.2.6). */
static int arith_decode(Arith *e, uint8_t *st) {
    while (e->a < 0x8000) {
        if (--e->ct < 0) {
            e->c = (int64_t)(((uint64_t)e->c << 8) | (uint64_t)arith_byte(e));
            if ((e->ct += 8) < 0 && ++e->ct == 0) e->a = 0x8000; /* the first two bytes read */
        }
        e->a <<= 1;
    }
    const int sv = *st;
    uint32_t qe = ARITAB[sv & 0x7F];
    const int nl = (int)(qe & 0xFF); /* Next_Index_LPS and Switch_MPS */
    qe >>= 8;
    const int nm = (int)(qe & 0xFF);
    qe >>= 8;
    int64_t temp = e->a - qe;
    e->a = temp;
    temp <<= e->ct;
    if (e->c >= temp) {
        e->c -= temp;
        /* conditional LPS exchange */
        if (e->a < (int64_t)qe) {
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
            return sv >> 7;
        }
        e->a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        return (sv >> 7) ^ 1;
    }
    if (e->a < 0x8000) {
        /* conditional MPS exchange */
        if (e->a < (int64_t)qe) {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            return (sv >> 7) ^ 1;
        }
        *st = (uint8_t)((sv & 0x80) ^ nm);
    }
    return sv >> 7;
}

/* jdarith.c process_restart: past the restart marker (read_restart); the
 * registers start over. */
static int arith_restart(Arith *e, int *rst) {
    e->p = read_restart(e->p, e->end, rst, &e->marker);
    e->c = 0;
    e->a = 0;
    e->ct = -16;
    return e->p == NULL;
}

/* A DC difference (F.1.4.4.1, Figures F.19-F.24), k->ctx updated; on a
 * magnitude overflow e->ct <- -1. */
static int arith_dc_diff(Jpeg *j, Arith *e, Comp *k) {
    uint8_t *st = j->dc_stats[k->td] + k->ctx;
    if (arith_decode(e, st) == 0) {
        k->ctx = 0;
        return 0;
    }
    const int sign = arith_decode(e, st + 1);
    st += 2 + sign;
    int m = arith_decode(e, st);
    if (m) {
        st = j->dc_stats[k->td] + 20;
        while (arith_decode(e, st)) {
            if ((m <<= 1) == 0x8000) {
                e->ct = -1;
                return 0;
            }
            st++;
        }
    }
    if (m < (1 << j->arith_l[k->td]) >> 1)
        k->ctx = 0;
    else if (m > (1 << j->arith_u[k->td]) >> 1)
        k->ctx = 12 + sign * 4;
    else
        k->ctx = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1) {
        if (arith_decode(e, st)) v |= m;
    }
    v += 1;
    return sign ? -v : v;
}

/* AC coefficients ss..se of a block (Figure F.20), each stored shifted
 * left by al; on a bad code e->ct <- -1 and the block stops there. */
static void arith_ac_first(Jpeg *j, Arith *e, int tbl, int16_t *blk, int ss, int se, int al) {
    uint8_t *stats = j->ac_stats[tbl];
    const int kx = j->arith_k[tbl];
    for (int k = ss; k <= se; k++) {
        uint8_t *st = stats + 3 * (k - 1);
        if (arith_decode(e, st)) break; /* end of block */
        while (arith_decode(e, st + 1) == 0) {
            st += 3;
            if (++k > se) {
                e->ct = -1; /* spectral overflow */
                return;
            }
        }
        const int sign = arith_decode(e, &j->fixed);
        st += 2;
        int m = arith_decode(e, st);
        if (m && arith_decode(e, st)) {
            m <<= 1;
            st = stats + (k <= kx ? 189 : 217);
            while (arith_decode(e, st)) {
                if ((m <<= 1) == 0x8000) {
                    e->ct = -1; /* magnitude overflow */
                    return;
                }
                st++;
            }
        }
        int v = m;
        st += 14;
        while (m >>= 1) {
            if (arith_decode(e, st)) v |= m;
        }
        v += 1;
        blk[ZIGZAG[k]] = shifted(sign ? -v : v, al);
    }
}

/* An AC refinement of ss..se (G.1.3.3): the end of the earlier stages'
 * block is the last nonzero coefficient; each nonzero one takes a
 * correction bit, each zero one may become +-(1 << al). */
static void arith_ac_refine(Jpeg *j, Arith *e, int tbl, int16_t *blk, int ss, int se, int al) {
    uint8_t *stats = j->ac_stats[tbl];
    const int p1 = 1 << al;
    int kex = se;
    while (kex > 0 && !blk[ZIGZAG[kex]]) kex--;
    for (int k = ss; k <= se; k++) {
        uint8_t *st = stats + 3 * (k - 1);
        if (k > kex && arith_decode(e, st)) break; /* end of block */
        for (;;) {
            int16_t *c = blk + ZIGZAG[k];
            if (*c) {
                if (arith_decode(e, st + 2)) *c = (int16_t)(*c < 0 ? *c - p1 : *c + p1);
                break;
            }
            if (arith_decode(e, st + 1)) {
                *c = (int16_t)(arith_decode(e, &j->fixed) ? -p1 : p1);
                break;
            }
            st += 3;
            if (++k > se) {
                e->ct = -1; /* spectral overflow */
                return;
            }
        }
    }
}

/* The statistics and predictions a scan's tables start from (jdarith.c
 * start_pass and process_restart): DC bins for sequential and DC first
 * scans, AC bins for sequential and AC scans, all zero. */
static void arith_reset(Jpeg *j, const Scan *s) {
    for (int i = 0; i < s->ns; i++) {
        Comp *k = s->sc[i];
        if (!j->progressive || (s->ss == 0 && s->ah == 0)) {
            memset(j->dc_stats[k->td], 0, sizeof j->dc_stats[0]);
            k->pred = 0;
            k->ctx = 0;
        }
        if (!j->progressive || s->ss) memset(j->ac_stats[k->ta], 0, sizeof j->ac_stats[0]);
    }
}

/* One arithmetic-coded scan (jdarith.c decode_mcu, decode_mcu_DC_first,
 * decode_mcu_DC_refine, decode_mcu_AC_first, decode_mcu_AC_refine), as
 * decode_scan: sequential blocks through the IDCT into the planes (a block
 * after a bad code is zero), progressive ones into the coefficients. */
static int decode_scan_arith(Jpeg *j, const uint8_t *p, const uint8_t **pos) {
    Scan s;
    if (scan_header(j, p, &s)) return 1;
    const int ns = s.ns, ss = s.ss, se = s.se, ah = s.ah, al = s.al;
    arith_reset(j, &s);
    Arith e = {s.data, j->end, 0, 0, -16, 0, 0};
    int todo = j->restart, rst = 0;
    int16_t coef[64];
    for (int64_t m = 0; m < s.mcus; m++) {
        if (j->restart && todo == 0) {
            if (arith_restart(&e, &rst)) return fail(j, TRUNCATED);
            arith_reset(j, &s);
            todo = j->restart;
        }
        todo--;
        const int mx = (int)(m % s.mcux), my = (int)(m / s.mcux);
        for (int i = 0; i < ns; i++) {
            Comp *k = s.sc[i];
            const int nh = ns == 1 ? 1 : k->h, nv = ns == 1 ? 1 : k->v;
            for (int v = 0; v < nv; v++) {
                for (int h = 0; h < nh; h++) {
                    const int bx = mx * nh + h, by = my * nv + v;
                    if (!j->progressive) {
                        memset(coef, 0, sizeof coef);
                        if (e.ct != -1) {
                            const int diff = arith_dc_diff(j, &e, k);
                            if (e.ct != -1) {
                                k->pred = (k->pred + diff) & 0xFFFF;
                                coef[0] = (int16_t)(uint16_t)k->pred;
                                arith_ac_first(j, &e, k->ta, coef, 1, 63, 0);
                            }
                        }
                        const int stride = k->bw * 8;
                        idct_islow(coef, k->q, k->plane + ((int64_t)by * 8) * stride + (int64_t)bx * 8, stride);
                        continue;
                    }
                    int16_t *blk = k->coef + ((int64_t)by * k->bw + bx) * 64;
                    if (ss == 0 && ah) {
                        /* DC refinement: the next bit, at fixed probability */
                        if (arith_decode(&e, &j->fixed)) blk[0] = (int16_t)(blk[0] | (1 << al));
                    } else if (e.ct == -1) {
                        continue;
                    } else if (ss == 0) {
                        const int diff = arith_dc_diff(j, &e, k);
                        if (e.ct == -1) continue;
                        k->pred = (k->pred + diff) & 0xFFFF;
                        blk[0] = shifted(k->pred, al);
                    } else if (ah) {
                        arith_ac_refine(j, &e, k->ta, blk, ss, se, al);
                    } else {
                        arith_ac_first(j, &e, k->ta, blk, ss, se, al);
                    }
                }
            }
        }
    }
    if (e.ran_out) return fail(j, TRUNCATED);
    j->last_good = imcu_row(&s, s.mcus - 1); /* jdarith.c reads past a marker as zeros, skipping nothing */
    *pos = next_marker(e.p, j->end);
    return 0;
}

/* ------------------------------------------------------------------------ */
/* JPEG: block smoothing and the IDCT of progressive coefficients            */
/* ------------------------------------------------------------------------ */

/* jdcoefct.c smoothing_ok, after the whole file is read: a progressive file
 * whose components each latched a quantization table with entries 0-9 (in
 * zigzag order) nonzero and had their DC at least partly sent, one of them
 * leaving bits of a coefficient 1-9 unsent. */
static int smoothing_ok(const Jpeg *j) {
    int useful = 0;
    for (int c = 0; c < j->ncomp; c++) {
        const Comp *k = &j->comp[c];
        if (!k->latched || k->coef_bits[0] < 0) return 0;
        for (int i = 0; i < 10; i++) {
            if (!k->q[ZIGZAG[i]]) return 0;
        }
        for (int i = 1; i < 10; i++) useful |= k->coef_bits[i] != 0;
    }
    return useful;
}

/* An estimate of a coefficient from num = Q00 * (a weighted sum of DC
 * values) over its quantizer q, rounded to nearest away from zero; with
 * al > 0 no larger in magnitude than its unsent bits can hold. */
static int16_t estimate(int64_t num, int64_t q, int al) {
    int pred = (int)(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    return (int16_t)(num >= 0 ? pred : -pred);
}

/* jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later) over one
 * component: each block's coefficients 1-9 that are zero and not fully
 * sent estimated from the 5x5 DC values around it (when no AC bit of 1-9
 * was sent, the DC too), then the IDCT. Edge blocks repeat their
 * neighbours; the rows follow libjpeg-turbo's iMCU-row arithmetic, whose
 * last iMCU row counts only its own block rows. */
static void idct_smoothed(const Jpeg *j, const Comp *k) {
    /* rows past the last one a scan ended with its data intact take the
     * record from before the component's latest scan (jdcoefct.c: the
     * previous scan's latch; none after a single scan) */
    static const int none[10] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1};
    const int *const prev = j->scans > 1 ? k->prev_bits : none;
    const uint16_t *q = k->q;
    const int64_t q00 = q[0], q01 = q[1], q10 = q[8], q20 = q[16], q11 = q[9], q02 = q[2];
    const int64_t q03 = q[3], q12 = q[10], q21 = q[17], q30 = q[24];
    const int nbx = (k->dw + 7) / 8, nby = (k->dh + 7) / 8, stride = k->bw * 8;
    const int sv = k->sv, imcu_rows = (j->height + 8 * j->svmax - 1) / (8 * j->svmax);
    int16_t w[64];
    int d[26];
    for (int r = 0; r < imcu_rows; r++) {
        const int *cb = r > j->last_good ? prev : k->coef_bits;
        int change_dc = 1;
        for (int i = 1; i < 10; i++) change_dc &= cb[i] == -1;
        int block_rows = sv;
        if (r == imcu_rows - 1 && nby % sv) block_rows = nby % sv;
        const int image_rows = block_rows * imcu_rows;
        for (int b = 0; b < block_rows; b++) {
            const int row = r * sv + b, ir = r * block_rows + b;
            int rows[5];
            rows[2] = row;
            rows[1] = ir > 0 ? row - 1 : row;
            rows[0] = ir > 1 ? row - 2 : rows[1];
            rows[3] = ir < image_rows - 1 ? row + 1 : row;
            rows[4] = ir < image_rows - 2 ? row + 2 : rows[3];
            for (int bx = 0; bx < nbx; bx++) {
                for (int y = 0; y < 5; y++) {
                    for (int x = 0; x < 5; x++) {
                        int col = bx + x - 2;
                        col = col < 0 ? 0 : col > nbx - 1 ? nbx - 1 : col;
                        /* rows past the coefficient store are the zeroed padding of libjpeg's */
                        d[1 + 5 * y + x] = rows[y] < k->bh ? k->coef[((int64_t)rows[y] * k->bw + col) * 64] : 0;
                    }
                }
                memcpy(w, k->coef + ((int64_t)row * k->bw + bx) * 64, sizeof w);
                int al;
                if ((al = cb[1]) != 0 && w[1] == 0) {
                    w[1] = estimate(q00 * (change_dc ? -d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] - 13 * d[9] +
                                                           3 * d[10] - 3 * d[11] + 38 * d[12] - 38 * d[14] + 3 * d[15] -
                                                           3 * d[16] + 13 * d[17] - 13 * d[19] + 3 * d[20] - d[21] - d[22] +
                                                           d[24] + d[25]
                                                     : -7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]),
                                    q01, al);
                }
                if ((al = cb[2]) != 0 && w[8] == 0) {
                    w[8] = estimate(q00 * (change_dc ? -d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] + 13 * d[7] +
                                                           38 * d[8] + 13 * d[9] - d[10] + d[16] - 13 * d[17] - 38 * d[18] -
                                                           13 * d[19] + d[20] + d[21] + 3 * d[22] + 3 * d[23] + 3 * d[24] +
                                                           d[25]
                                                     : -7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]),
                                    q10, al);
                }
                if ((al = cb[3]) != 0 && w[16] == 0) {
                    w[16] = estimate(q00 * (change_dc ? d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] - 14 * d[13] -
                                                            5 * d[14] + 2 * d[17] + 7 * d[18] + 2 * d[19] + d[23]
                                                      : -d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]),
                                     q20, al);
                }
                if ((al = cb[4]) != 0 && w[9] == 0) {
                    w[9] = estimate(q00 * (change_dc ? -d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] + 9 * d[19] + d[21] -
                                                           d[25]
                                                     : d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] + d[22] -
                                                           d[24] + d[4] - d[6] + 10 * d[7] - 10 * d[9]),
                                    q11, al);
                }
                if ((al = cb[5]) != 0 && w[2] == 0) {
                    w[2] = estimate(q00 * (change_dc ? 2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] - 14 * d[13] +
                                                           7 * d[14] + d[15] + 2 * d[17] - 5 * d[18] + 2 * d[19]
                                                     : -d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]),
                                    q02, al);
                }
                if (change_dc) {
                    if ((al = cb[6]) != 0 && w[3] == 0)
                        w[3] = estimate(q00 * (d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]), q03, al);
                    if ((al = cb[7]) != 0 && w[10] == 0)
                        w[10] = estimate(q00 * (d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]), q12, al);
                    if ((al = cb[8]) != 0 && w[17] == 0)
                        w[17] = estimate(q00 * (d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]), q21, al);
                    if ((al = cb[9]) != 0 && w[24] == 0)
                        w[24] = estimate(q00 * (d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]), q30, al);
                    w[0] = estimate(q00 * (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] - 6 * d[6] + 6 * d[7] +
                                           42 * d[8] + 6 * d[9] - 6 * d[10] - 8 * d[11] + 42 * d[12] + 152 * d[13] +
                                           42 * d[14] - 8 * d[15] - 6 * d[16] + 6 * d[17] + 42 * d[18] + 6 * d[19] -
                                           6 * d[20] - 2 * d[21] - 6 * d[22] - 8 * d[23] - 6 * d[24] - 2 * d[25]),
                                    q00, 0);
                }
                idct_islow(w, q, k->plane + (int64_t)row * 8 * stride + (int64_t)bx * 8, stride);
            }
        }
    }
}

/* After the last progressive scan: each component's blocks (those inside
 * its own size) through the IDCT into its plane, smoothed first where
 * smoothing_ok says so. */
static void idct_coefficients(Jpeg *j) {
    const int smooth = smoothing_ok(j);
    for (int c = 0; c < j->ncomp; c++) {
        const Comp *k = &j->comp[c];
        if (smooth) {
            idct_smoothed(j, k);
            continue;
        }
        const int stride = k->bw * 8, nbx = (k->dw + 7) / 8, nby = (k->dh + 7) / 8;
        for (int by = 0; by < nby; by++) {
            for (int bx = 0; bx < nbx; bx++) {
                idct_islow(k->coef + ((int64_t)by * k->bw + bx) * 64, k->q,
                           k->plane + (int64_t)by * 8 * stride + (int64_t)bx * 8, stride);
            }
        }
    }
}

/* ------------------------------------------------------------------------ */
/* JPEG: upsampling and color                                                */
/* ------------------------------------------------------------------------ */

/* A full-size plane (width x height, row stride width) of component k. */
static void upsample(const Jpeg *j, const Comp *k, uint8_t *out) {
    const int w = j->width, h = j->height;
    const int rh = j->hmax / k->h, rv = j->vmax / k->v;
    const int stride = k->bw * 8, dw = k->dw, dh = k->dh;
    const uint8_t *pl = k->plane;
    if (rh == 1 && rv == 1) {
        for (int y = 0; y < h; y++) memcpy(out + (int64_t)y * w, pl + (int64_t)y * stride, (size_t)w);
        return;
    }
    if (rh == 1 && rv == 2) {
        /* h1v2_fancy_upsample: 3/4 nearer row + 1/4 further row, biases 1
         * (the row above) and 2 (below); the first and last real rows
         * repeat past the edges, as jdmainct.c's context rows do */
        for (int y = 0; y < h; y++) {
            const int r = y >> 1;
            int rn = (y & 1) ? r + 1 : r - 1;
            if (rn < 0) rn = 0;
            if (rn > dh - 1) rn = dh - 1;
            const uint8_t *a = pl + (int64_t)r * stride, *b = pl + (int64_t)rn * stride;
            const int bias = (y & 1) ? 2 : 1;
            uint8_t *o = out + (int64_t)y * w;
            for (int x = 0; x < w; x++) o[x] = (uint8_t)((3 * a[x] + b[x] + bias) >> 2);
        }
        return;
    }
    if (dw <= 2 || rh != 2 || rv > 2) {
        /* h2v1_upsample / h2v2_upsample at most 2 samples wide, and
         * int_upsample for every other ratio: each sample replicated */
        for (int y = 0; y < h; y++) {
            const uint8_t *in = pl + (int64_t)(y / rv) * stride;
            for (int x = 0; x < w; x++) out[(int64_t)y * w + x] = in[x / rh];
        }
        return;
    }
    if (rv == 1) {
        /* h2v1_fancy_upsample: 3/4 nearer + 1/4 further, biases 1 and 2;
         * the end columns are the clamped cases of the same sums */
        for (int y = 0; y < h; y++) {
            const uint8_t *in = pl + (int64_t)y * stride;
            uint8_t *o = out + (int64_t)y * w;
            for (int x = 0; x < w; x++) {
                const int c = x >> 1;
                const int n = (x & 1) ? (c + 1 < dw ? c + 1 : dw - 1) : (c > 0 ? c - 1 : 0);
                o[x] = (uint8_t)((3 * in[c] + in[n] + ((x & 1) ? 2 : 1)) >> 2);
            }
        }
        return;
    }
    /* h2v2_fancy_upsample: column sums 3 * nearer row + further row (the
     * first and last real rows repeat past the edges, as jdmainct.c's
     * context rows do), then 3/4 + 1/4 across with biases 8 and 7 */
    int *sum = malloc(sizeof(int) * (size_t)dw);
    for (int y = 0; y < h; y++) {
        const int r = y >> 1;
        int rn = (y & 1) ? r + 1 : r - 1;
        if (rn < 0) rn = 0;
        if (rn > dh - 1) rn = dh - 1;
        const uint8_t *a = pl + (int64_t)r * stride, *b = pl + (int64_t)rn * stride;
        for (int c = 0; c < dw; c++) sum[c] = 3 * a[c] + b[c];
        uint8_t *o = out + (int64_t)y * w;
        for (int x = 0; x < w; x++) {
            const int c = x >> 1;
            if (x & 1) {
                const int n = c + 1 < dw ? c + 1 : dw - 1;
                o[x] = (uint8_t)((3 * sum[c] + sum[n] + 7) >> 4);
            } else {
                const int n = c > 0 ? c - 1 : 0;
                o[x] = (uint8_t)((3 * sum[c] + sum[n] + 8) >> 4);
            }
        }
    }
    free(sum);
}

/* jdcolor.c build_ycc_rgb_table / ycc_rgb_convert, SCALEBITS 16 */
#define SCALEBITS 16
#define ONE_HALF ((int32_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int32_t)((x) * (1L << SCALEBITS) + 0.5))

static int CR_R[256], CB_B[256];
static int32_t CR_G[256], CB_G[256];

static void init_color(void) {
    for (int i = 0, x = -128; i < 256; i++, x++) {
        CR_R[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
        CB_B[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
        CR_G[i] = -FIX(0.71414) * x;
        CB_G[i] = -FIX(0.34414) * x + ONE_HALF;
    }
}

static inline uint8_t clamp255(int v) {
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

/* Fills the tables; call once, before any jpeg_decode. */
void imgdec_init(void) {
    init_limit();
    init_color();
}

static int parse(Jpeg *j, const uint8_t *data, int64_t n, char *err, int64_t errlen, const uint8_t **scan) {
    memset(j, 0, sizeof *j);
    j->data = data;
    j->end = data + n;
    j->err = err;
    j->errlen = errlen;
    for (int t = 0; t < 16; t++) { /* jdmarker.c get_soi: the defaults without a DAC */
        j->arith_u[t] = 1;
        j->arith_k[t] = 5;
    }
    j->fixed = 113;
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) return fail(j, "not a JPEG file (no SOI marker)");
    const uint8_t *p = data + 2;
    if (read_markers(j, &p, NULL)) return 1;
    if (check_frame(j)) return 1;
    *scan = p;
    return 0;
}

/* hwc <- (height, width, components) of the JPEG in data[0:n]. */
int jpeg_info(const uint8_t *data, int64_t n, int32_t *hwc, char *err, int64_t errlen) {
    Jpeg j;
    const uint8_t *scan;
    if (parse(&j, data, n, err, errlen, &scan)) return 1;
    hwc[0] = j.height;
    hwc[1] = j.width;
    hwc[2] = j.ncomp;
    return 0;
}

/* out <- the decoded image, height x width x components uint8 (RGB for
 * three components, whether coded as YCbCr or RGB). */
int jpeg_decode(const uint8_t *data, int64_t n, uint8_t *out, char *err, int64_t errlen) {
    Jpeg j;
    const uint8_t *p;
    if (parse(&j, data, n, err, errlen, &p)) return 1;
    int rc = 0;
    for (int c = 0; c < j.ncomp; c++) {
        Comp *k = &j.comp[c];
        const size_t blocks = (size_t)k->bw * (size_t)k->bh;
        k->plane = calloc(blocks * 64, 1);
        if (j.progressive) k->coef = calloc(blocks * 64, sizeof(int16_t));
        if (!k->plane || (j.progressive && !k->coef)) {
            rc = fail(&j, "out of memory");
            goto done;
        }
    }
    /* a sequential file of one scan: that scan (libjpeg decodes it as it
     * reads, and PIL stops once the last row is out); a progressive file,
     * or a sequential one of several scans, which libjpeg reads whole before
     * the first row: every scan up to EOI, without which PIL raises */
    for (;;) {
        if ((rc = (j.arith ? decode_scan_arith : decode_scan)(&j, p, &p))) goto done;
        int more = 0, eoi = 0;
        for (int c = 0; c < j.ncomp; c++) more |= !j.comp[c].seen;
        if (!more && !j.progressive && j.scans == 1) {
            j.tail = 1;
            if ((rc = read_markers(&j, &p, &eoi))) goto done;
            break;
        }
        if ((rc = read_markers(&j, &p, j.progressive || !more ? &eoi : NULL))) goto done;
        if (eoi) break;
    }
    if (j.progressive) idct_coefficients(&j);
    const int64_t npx = (int64_t)j.width * j.height;
    if (j.ncomp == 1) {
        upsample(&j, &j.comp[0], out);
        goto done;
    }
    uint8_t *planes = malloc((size_t)npx * 3);
    if (!planes) {
        rc = fail(&j, "out of memory");
        goto done;
    }
    for (int c = 0; c < 3; c++) upsample(&j, &j.comp[c], planes + c * npx);
    const uint8_t *yp = planes, *cb = planes + npx, *cr = planes + 2 * npx;
    if (j.rgb) {
        for (int64_t i = 0; i < npx; i++) {
            out[3 * i] = yp[i];
            out[3 * i + 1] = cb[i];
            out[3 * i + 2] = cr[i];
        }
        free(planes);
        goto done;
    }
    for (int64_t i = 0; i < npx; i++) {
        const int y = yp[i], b = cb[i], r = cr[i];
        out[3 * i] = clamp255(y + CR_R[r]);
        out[3 * i + 1] = clamp255(y + (int)((CB_G[b] + CR_G[r]) >> SCALEBITS));
        out[3 * i + 2] = clamp255(y + CB_B[b]);
    }
    free(planes);
done:
    for (int c = 0; c < j.ncomp; c++) {
        free(j.comp[c].plane);
        free(j.comp[c].coef);
    }
    return rc;
}
