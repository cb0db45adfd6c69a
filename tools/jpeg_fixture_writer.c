/* Writes one JPEG fixture for tools/make_jpeg_fixtures.py with the libjpeg
 * that PIL's wheel carries (libjpeg-turbo 3.x), for the frames PIL's own
 * writer does not make: lossless (SOF3) and arithmetic-coded files.
 *
 *   jpeg_fixture_writer OUT IN WIDTH HEIGHT COMPONENTS [option value]...
 *
 * IN holds WIDTH * HEIGHT * COMPONENTS bytes (grey or RGB). Options:
 * lossless PSV PT (jpeg_enable_lossless), arith 1, progressive 1
 * (jpeg_simple_progression), restart N (MCUs), quality Q, sampling HV
 * (component 0's factors, e.g. 22), rgb 1 (the RGB colour space, no
 * conversion), dac K (arithmetic AC conditioning Kx of every table).
 * Built by make_jpeg_fixtures.py with the system's jpeglib.h; the library
 * exports jpeg_enable_lossless, which that header does not declare. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

void jpeg_enable_lossless(j_compress_ptr cinfo, int psv, int pt);

int main(int argc, char **argv) {
  if (argc < 6) return 2;
  int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
  size_t size = (size_t)w * h * nc;
  unsigned char *px = malloc(size);
  FILE *in = fopen(argv[2], "rb");
  if (!in || fread(px, 1, size, in) != size) return 3;
  fclose(in);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr err;
  c.err = jpeg_std_error(&err);
  jpeg_create_compress(&c);
  FILE *out = fopen(argv[1], "wb");
  if (!out) return 4;
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&c);
  int psv = 0, pt = 0, progressive = 0, dac = -1;
  for (int i = 6; i + 1 < argc; i += 2) {
    const char *k = argv[i];
    int v = atoi(argv[i + 1]);
    if (!strcmp(k, "lossless")) psv = v, pt = atoi(argv[++i + 1]);
    else if (!strcmp(k, "arith")) c.arith_code = v != 0;
    else if (!strcmp(k, "progressive")) progressive = v;
    else if (!strcmp(k, "restart")) c.restart_interval = v;
    else if (!strcmp(k, "quality")) jpeg_set_quality(&c, v, TRUE);
    else if (!strcmp(k, "sampling"))
      c.comp_info[0].h_samp_factor = v / 10, c.comp_info[0].v_samp_factor = v % 10;
    else if (!strcmp(k, "rgb")) jpeg_set_colorspace(&c, JCS_RGB);
    else if (!strcmp(k, "dac")) dac = v;
    else return 5;
  }
  if (dac >= 0)
    for (int t = 0; t < NUM_ARITH_TBLS; t++) c.arith_ac_K[t] = (UINT8)dac;
  if (progressive) jpeg_simple_progression(&c);
  if (psv) jpeg_enable_lossless(&c, psv, pt);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  free(px);
  return 0;
}
