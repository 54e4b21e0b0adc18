/* The cross-check writer of the two libjpeg arithmetic fixtures: an
 * independent encoder (libjpeg's jcarith.c) beside fixtures/jpeg_writer.py.
 * Reads width * height * 3 bytes of RGB from stdin and writes an
 * arithmetic-coded JPEG (libjpeg's defaults at quality 85: 4:2:0, a DAC
 * segment before each scan) to stdout, sequential (SOF9) or, with a third
 * argument 1, progressive under jpeg_simple_progression (SOF10).
 *
 *     cc libjpeg_arith.c -ljpeg -o libjpeg_arith
 *     ./libjpeg_arith 61 43 0 < rgb > libjpeg_61x43_q85_420_arith.jpg
 *
 * python -m topo4d_tpu_torch.fixtures keeps the committed files and hashes
 * PIL's decode of them; it does not run this program. */
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>

int main(int argc, char **argv) {
    if (argc < 4) return 2;
    const int w = atoi(argv[1]), h = atoi(argv[2]), progressive = atoi(argv[3]);
    unsigned char *rgb = malloc((size_t)w * h * 3);
    if (!rgb || fread(rgb, 3, (size_t)w * h, stdin) != (size_t)w * h) return 1;
    struct jpeg_compress_struct c;
    struct jpeg_error_mgr e;
    c.err = jpeg_std_error(&e);
    jpeg_create_compress(&c);
    jpeg_stdio_dest(&c, stdout);
    c.image_width = w;
    c.image_height = h;
    c.input_components = 3;
    c.in_color_space = JCS_RGB;
    jpeg_set_defaults(&c);
    jpeg_set_quality(&c, 85, TRUE);
    c.arith_code = TRUE;
    if (progressive) jpeg_simple_progression(&c);
    jpeg_start_compress(&c, TRUE);
    for (int y = 0; y < h; y++) {
        JSAMPROW row = rgb + (size_t)y * w * 3;
        jpeg_write_scanlines(&c, &row, 1);
    }
    jpeg_finish_compress(&c);
    jpeg_destroy_compress(&c);
    free(rgb);
    return 0;
}
