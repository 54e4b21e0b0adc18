/* Host image decoding for the loader: the PNG unfilter and a JPEG decoder,
 * plain C99 with a C interface for ctypes (native.py builds it).
 *
 * png_unfilter: the five PNG row filters (PNG spec section 9.2), bit for bit,
 * at any whole number of bytes per pixel.
 *
 * jpeg_info / jpeg_decode: Huffman JPEG, sequential (SOF0/SOF1) or
 * progressive (SOF2: DC and AC first and refinement scans, EOB runs,
 * interleaved and non-interleaved scans, restart markers), 8-bit samples,
 * 1 or 3 components, any sampling factors 1-4 whose ratios to the largest
 * are whole numbers. The output is what libjpeg-turbo gives at its defaults
 * (the decoder PIL runs): the islow integer IDCT of jidctint.c, the
 * upsampler jdsample.c jinit_upsampler picks (h2v1_fancy_upsample and
 * h2v2_fancy_upsample when the downsampled component is more than 2 samples
 * wide, else the replicating h2v1/h2v2 ones; h1v2_fancy_upsample for a
 * vertical ratio of 2 alone; int_upsample, which replicates, for every
 * other ratio), the colour space jdapimin.c default_decompress_parms picks
 * (JFIF: YCbCr; else an Adobe APP14 transform 0: RGB, any other: YCbCr;
 * else component ids 'R', 'G', 'B': RGB; else YCbCr) and the integer
 * YCbCr->RGB tables of jdcolor.c. Progressive coefficients are kept for the
 * whole image and go through the same IDCT, upsampling and colour code as
 * sequential ones. A progressive file whose scans leave any coefficient bit
 * unsent is refused: libjpeg-turbo smooths such blocks
 * (jdcoefct.c decompress_smooth_data), which this decoder does not. Also
 * refused with a message: arithmetic coding, lossless and hierarchical
 * files, 12-bit samples, 2 or 4 components, fractional sampling ratios and
 * interleaved scans of more than 10 blocks per MCU (libjpeg's limit).
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
} Huff;

typedef struct {
    int id, h, v, tq;
    int td, ta;               /* the current scan's tables */
    int bw, bh;               /* blocks across and down in the plane (whole MCUs) */
    int dw, dh;               /* downsampled width and height (libjpeg's) */
    uint8_t *plane;           /* bw * 8 by bh * 8 samples */
    int16_t *coef;            /* progressive: bw * bh blocks of 64 coefficients, natural order */
    uint16_t q[64];           /* the quantization table as it was at the component's first scan */
    int latched;
    int coef_bits[64];        /* progressive: the lowest bit sent of each zigzag coefficient, -1 = none */
    int pred;
    int seen;                 /* decoded in some scan */
} Comp;

typedef struct {
    const uint8_t *data, *end;
    int width, height, ncomp, hmax, vmax;
    int mcux, mcuy;
    int restart;
    int jfif, sof, progressive;
    int adobe, adobe_transform;
    int rgb;                  /* three components coded as RGB, not YCbCr */
    int eobrun;               /* progressive AC scans: blocks left in the current end-of-band run */
    uint16_t q[4][64];        /* natural order */
    int qdef[4];
    Huff dc[4], ac[4];
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

static int build_huff(Jpeg *j, Huff *t) {
    int code = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
        t->valptr[len] = k;
        t->mincode[len] = code;
        code += t->nbits[len];
        k += t->nbits[len];
        if (code > (1 << len)) return fail(j, "bad Huffman table");
        t->maxcode[len] = t->nbits[len] ? code - 1 : -1;
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;
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
    t->defined = 1;
    return 0;
}

static int seg_len(Jpeg *j, const uint8_t *p, int *len) {
    if (p + 2 > j->end) return fail(j, "truncated marker segment");
    *len = (p[0] << 8) | p[1];
    if (*len < 2 || p + *len > j->end) return fail(j, "truncated marker segment");
    return 0;
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
        if (build_huff(j, t)) return 1;
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
        if (k->h > j->hmax) j->hmax = k->h;
        if (k->v > j->vmax) j->vmax = k->v;
    }
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

/* Walk the markers up to the next SOS (*pos <- its segment): tables,
 * restart interval, frame header, JFIF and Adobe markers. At EOI, *eoi <- 1
 * when eoi is given, else it is an error. */
static int read_markers(Jpeg *j, const uint8_t **pos, int *eoi) {
    const uint8_t *p = *pos;
    char msg[160];
    for (;;) {
        while (p < j->end && *p != 0xFF) p++; /* junk between segments */
        while (p < j->end && *p == 0xFF) p++;
        if (p >= j->end) return fail(j, "no SOS marker before the end of the data");
        const int m = *p++;
        int len = 0;
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
        if (m == 0xD9) {
            if (!eoi) return fail(j, "EOI before a scan of every component");
            *eoi = 1;
            *pos = p;
            return 0;
        }
        if (seg_len(j, p, &len)) return 1;
        switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
            if (j->sof) return fail(j, "two frame headers");
            j->sof = m;
            j->progressive = m == 0xC2;
            if (read_sof(j, p, len)) return 1;
            break;
        case 0xC3:
            return fail(j, "lossless JPEG (SOF3; only sequential and progressive Huffman JPEG is read)");
        case 0xC5:
        case 0xC6:
        case 0xC7:
            snprintf(msg, sizeof msg,
                     "hierarchical JPEG (SOF%d; only sequential and progressive Huffman JPEG is read)", m - 0xC0);
            return fail(j, msg);
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
            snprintf(msg, sizeof msg, "arithmetic-coded JPEG (SOF%d; only Huffman-coded JPEG is read)", m - 0xC0);
            return fail(j, msg);
        case 0xCC:
            return fail(j, "arithmetic-coded JPEG (a DAC marker; only Huffman-coded JPEG is read)");
        case 0xC4:
            if (read_dht(j, p, len)) return 1;
            break;
        case 0xDB:
            if (read_dqt(j, p, len)) return 1;
            break;
        case 0xDD:
            if (len < 4) return fail(j, "bad DRI segment");
            j->restart = (p[2] << 8) | p[3];
            break;
        case 0xDC:
            return fail(j, "DNL marker (not read)");
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
            *pos = p;
            return 0;
        default:
            if (m < 0xC0) {
                snprintf(msg, sizeof msg, "unexpected marker 0xFF%02X", m);
                return fail(j, msg);
            }
            break; /* APPn, COM and others: skipped */
        }
        p += len;
    }
}

/* The colour space of three components (jdapimin.c default_decompress_parms). */
static int check_frame(Jpeg *j) {
    if (!j->sof) return fail(j, "no SOF0/SOF1/SOF2 frame header before the scan");
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

typedef struct {
    const uint8_t *p, *end;
    uint64_t acc;   /* bits left-aligned */
    int nbits;
    int marker;     /* a marker was met: zeros are fed from here on */
} Bits;

static void fill(Bits *b) {
    while (b->nbits <= 56) {
        int c = 0;
        if (!b->marker && b->p < b->end) {
            c = *b->p;
            if (c == 0xFF) {
                const int n = b->p + 1 < b->end ? b->p[1] : 0xD9;
                if (n == 0x00) {
                    b->p += 2;
                } else {
                    b->marker = 1; /* p stays on the marker */
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
        /* a code no table holds: corrupt data; libjpeg warns and yields 0 */
        b->acc <<= 16;
        b->nbits -= 16;
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

/* the post-IDCT range limit (jdmaster.c prepare_range_limit_table): index
 * x & 1023 of a value x, giving clamp(x + 128, 0, 255) for |x| <= 512 */
static uint8_t IDCT_LIMIT[1024];

static void init_limit(void) {
    for (int i = 0; i < 1024; i++) {
        IDCT_LIMIT[i] = (uint8_t)(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
    }
}

static void idct_islow(const int16_t *coef, const uint16_t *q, uint8_t *out, int stride) {
    int32_t ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t *in = coef + c;
        const uint16_t *qc = q + c;
        int32_t *w = ws + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
            const int32_t dc = ((int32_t)in[0] * qc[0]) * (1 << PASS1_BITS);
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
        w[0] = DESCALE(tmp10 + tmp3, n);
        w[56] = DESCALE(tmp10 - tmp3, n);
        w[8] = DESCALE(tmp11 + tmp2, n);
        w[48] = DESCALE(tmp11 - tmp2, n);
        w[16] = DESCALE(tmp12 + tmp1, n);
        w[40] = DESCALE(tmp12 - tmp1, n);
        w[24] = DESCALE(tmp13 + tmp0, n);
        w[32] = DESCALE(tmp13 - tmp0, n);
    }
    for (int r = 0; r < 8; r++) {
        const int32_t *w = ws + 8 * r;
        uint8_t *o = out + (int64_t)r * stride;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            const uint8_t v = IDCT_LIMIT[DESCALE(w[0], PASS1_BITS + 3) & 1023];
            memset(o, v, 8);
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
        o[0] = IDCT_LIMIT[DESCALE(tmp10 + tmp3, n) & 1023];
        o[7] = IDCT_LIMIT[DESCALE(tmp10 - tmp3, n) & 1023];
        o[1] = IDCT_LIMIT[DESCALE(tmp11 + tmp2, n) & 1023];
        o[6] = IDCT_LIMIT[DESCALE(tmp11 - tmp2, n) & 1023];
        o[2] = IDCT_LIMIT[DESCALE(tmp12 + tmp1, n) & 1023];
        o[5] = IDCT_LIMIT[DESCALE(tmp12 - tmp1, n) & 1023];
        o[3] = IDCT_LIMIT[DESCALE(tmp13 + tmp0, n) & 1023];
        o[4] = IDCT_LIMIT[DESCALE(tmp13 - tmp0, n) & 1023];
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

static void restart(Bits *b) {
    b->acc = 0;
    b->nbits = 0;
    const uint8_t *p = b->p;
    while (p + 1 < b->end && p[0] == 0xFF && p[1] == 0xFF) p++;
    if (p + 1 < b->end && p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) p += 2;
    b->p = p;
    b->marker = 0;
}

/* One scan starting at the SOS segment p; *pos <- the first byte after its
 * entropy-coded data. Sequential scans go through the IDCT into each
 * component's plane block by block; progressive ones into its coefficients. */
static int decode_scan(Jpeg *j, const uint8_t *p, const uint8_t **pos) {
    int len;
    char msg[160];
    if (seg_len(j, p, &len)) return 1;
    const int ns = p[2];
    if (ns < 1 || ns > j->ncomp || len < 6 + 2 * ns) return fail(j, "bad SOS segment");
    const uint8_t *q = p + 3 + 2 * ns;
    const int ss = q[0], se = q[1], ah = q[2] >> 4, al = q[2] & 15;
    if (!j->progressive) {
        if (ss != 0 || se != 63 || ah != 0 || al != 0) return fail(j, "spectral selection in a sequential scan");
    } else if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) {
        snprintf(msg, sizeof msg, "bad progressive scan (Ss %d, Se %d over %d components)", ss, se, ns);
        return fail(j, msg);
    } else if ((ah != 0 && al != ah - 1) || al > 13) {
        snprintf(msg, sizeof msg, "bad successive approximation (Ah %d, Al %d)", ah, al);
        return fail(j, msg);
    }
    /* which tables the scan reads: sequential both; progressive DC first
     * scans the DC table, AC scans the AC table, DC refinements none */
    const int need_dc = !j->progressive || (ss == 0 && ah == 0);
    const int need_ac = !j->progressive || ss > 0;
    Comp *sc[3];
    int blocks = 0;
    for (int i = 0; i < ns; i++) {
        const int id = p[3 + 2 * i], tables = p[4 + 2 * i];
        sc[i] = NULL;
        for (int c = 0; c < j->ncomp; c++) {
            if (j->comp[c].id == id) sc[i] = &j->comp[c];
        }
        if (!sc[i]) return fail(j, "SOS names a component the frame has not");
        Comp *k = sc[i];
        k->td = tables >> 4;
        k->ta = tables & 15;
        if (k->td > 3 || k->ta > 3 || (need_dc && !j->dc[k->td].defined) || (need_ac && !j->ac[k->ta].defined)) {
            return fail(j, "SOS uses an undefined Huffman table");
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
        blocks += k->h * k->v;
        if (j->progressive) {
            for (int c = ss; c <= se; c++) k->coef_bits[c] = al;
        }
    }
    if (ns > 1 && blocks > 10) {
        snprintf(msg, sizeof msg, "%d blocks per MCU (libjpeg reads at most 10)", blocks);
        return fail(j, msg);
    }
    Bits b = {p + len, j->end, 0, 0, 0};
    int64_t mcus, mcux;
    if (ns == 1) {
        /* non-interleaved: one block per MCU over the component's own blocks */
        Comp *k = sc[0];
        mcux = (k->dw + 7) / 8;
        mcus = mcux * ((k->dh + 7) / 8);
    } else {
        mcux = j->mcux;
        mcus = (int64_t)j->mcux * j->mcuy;
    }
    j->eobrun = 0;
    int todo = j->restart;
    for (int64_t m = 0; m < mcus; m++) {
        if (j->restart && todo == 0) {
            restart(&b);
            for (int i = 0; i < ns; i++) sc[i]->pred = 0;
            j->eobrun = 0;
            todo = j->restart;
        }
        const int mx = (int)(m % mcux), my = (int)(m / mcux);
        for (int i = 0; i < ns; i++) {
            Comp *k = sc[i];
            const Huff *dc = &j->dc[k->td], *ac = &j->ac[k->ta];
            if (!j->progressive) {
                if (ns == 1) {
                    decode_block(&b, k, dc, ac, mx, my);
                    continue;
                }
                for (int v = 0; v < k->v; v++) {
                    for (int h = 0; h < k->h; h++) decode_block(&b, k, dc, ac, mx * k->h + h, my * k->v + v);
                }
                continue;
            }
            const int nh = ns == 1 ? 1 : k->h, nv = ns == 1 ? 1 : k->v;
            for (int v = 0; v < nv; v++) {
                for (int h = 0; h < nh; h++) {
                    int16_t *blk = k->coef + ((int64_t)(my * nv + v) * k->bw + mx * nh + h) * 64;
                    if (ss > 0)
                        (ah ? ac_refine : ac_first)(j, &b, ac, blk, ss, se, al);
                    else if (ah)
                        dc_refine(&b, blk, al);
                    else
                        dc_first(&b, k, dc, blk, al);
                }
            }
        }
        todo--;
    }
    /* the bytes left of a partly read byte are dropped; find the next marker */
    const uint8_t *e = b.p;
    while (e + 1 < j->end && !(e[0] == 0xFF && e[1] != 0x00 && !(e[1] >= 0xD0 && e[1] <= 0xD7))) e++;
    *pos = e;
    return 0;
}

/* After the last progressive scan: each component's blocks (those inside
 * its own size) through the IDCT into its plane. */
static int idct_coefficients(Jpeg *j) {
    char msg[200];
    for (int c = 0; c < j->ncomp; c++) {
        const Comp *k = &j->comp[c];
        for (int i = 0; i < 64; i++) {
            if (k->coef_bits[i] != 0) {
                snprintf(msg, sizeof msg,
                         "progressive scans leave bits of coefficient %d of component %d unsent (libjpeg-turbo "
                         "smooths such blocks, which is not done here)", i, c);
                return fail(j, msg);
            }
        }
    }
    for (int c = 0; c < j->ncomp; c++) {
        const Comp *k = &j->comp[c];
        const int stride = k->bw * 8, nbx = (k->dw + 7) / 8, nby = (k->dh + 7) / 8;
        for (int by = 0; by < nby; by++) {
            for (int bx = 0; bx < nbx; bx++) {
                idct_islow(k->coef + ((int64_t)by * k->bw + bx) * 64, k->q,
                           k->plane + (int64_t)by * 8 * stride + (int64_t)bx * 8, stride);
            }
        }
    }
    return 0;
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
    /* sequential: until every component had its scan; progressive: every
     * scan up to EOI */
    for (;;) {
        if ((rc = decode_scan(&j, p, &p))) goto done;
        int more = 0, eoi = 0;
        for (int c = 0; c < j.ncomp; c++) more |= !j.comp[c].seen;
        if (!more && !j.progressive) break;
        if ((rc = read_markers(&j, &p, j.progressive ? &eoi : NULL))) goto done;
        if (eoi) break;
    }
    if (j.progressive && (rc = idct_coefficients(&j))) goto done;
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
