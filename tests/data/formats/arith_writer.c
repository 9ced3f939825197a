/* Write an arithmetic-coded JPEG with the system libjpeg: raw 8-bit samples
 * (height x width x components, row-major) on stdin, the file on stdout.
 *
 *   arith_writer WIDTH HEIGHT COMPONENTS H V QUALITY PROGRESSIVE RESTART
 *                DC_L DC_U AC_K
 *
 * COMPONENTS is 1 (gray) or 3 (RGB in, YCbCr in the file); H x V is the
 * luma sampling (chroma 1x1); PROGRESSIVE 1 uses jpeg_simple_progression;
 * RESTART is the restart interval in MCUs (0: none); DC_L, DC_U and AC_K
 * are the conditioning of every table (libjpeg's defaults: 0 1 5), which
 * the file's DAC segments carry. Built by make_arith_lossless.py. */
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>

int main(int argc, char** argv) {
  if (argc != 12) {
    fprintf(stderr, "usage: %s W H C H V QUALITY PROGRESSIVE RESTART DC_L "
                    "DC_U AC_K\n", argv[0]);
    return 2;
  }
  int a[11];
  for (int i = 0; i < 11; ++i) a[i] = atoi(argv[i + 1]);
  const int w = a[0], h = a[1], nc = a[2];
  size_t n = (size_t)w * h * nc;
  unsigned char* px = malloc(n);
  if (fread(px, 1, n, stdin) != n) {
    fprintf(stderr, "short input\n");
    return 1;
  }
  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, stdout);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = nc;
  cinfo.in_color_space = nc == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, a[5], TRUE);
  cinfo.arith_code = TRUE;
  cinfo.optimize_coding = FALSE;
  cinfo.comp_info[0].h_samp_factor = a[3];
  cinfo.comp_info[0].v_samp_factor = a[4];
  for (int i = 1; i < cinfo.num_components; ++i) {
    cinfo.comp_info[i].h_samp_factor = 1;
    cinfo.comp_info[i].v_samp_factor = 1;
  }
  if (a[6]) jpeg_simple_progression(&cinfo);
  cinfo.restart_interval = a[7];
  for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
    cinfo.arith_dc_L[t] = (UINT8)a[8];
    cinfo.arith_dc_U[t] = (UINT8)a[9];
    cinfo.arith_ac_K[t] = (UINT8)a[10];
  }
  jpeg_start_compress(&cinfo, TRUE);
  JSAMPROW row;
  while (cinfo.next_scanline < cinfo.image_height) {
    row = px + (size_t)cinfo.next_scanline * w * nc;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  free(px);
  return 0;
}
