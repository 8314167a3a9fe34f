/* Declarations of the libpng 1.6 calls that native/vloam_host.cpp makes.

   Used only where the system has no libpng headers: the host library is
   then compiled with this directory on the include path and linked against
   a libpng16 runtime that ships without headers (see
   vloam_tpu_torch/runtime/native.py).  The types, constants and prototypes
   are those of libpng 1.6's public, C-linkage interface. */
#ifndef VLOAM_PNG_DECLARATIONS_H
#define VLOAM_PNG_DECLARATIONS_H

#include <setjmp.h>
#include <stddef.h>
#include <stdio.h>

/* libpng accepts a caller whose version string agrees with its own up to
   the second '.', so any 1.6.x runtime takes this one. */
#define PNG_LIBPNG_VER_STRING "1.6.0"

#define PNG_COLOR_MASK_PALETTE 1
#define PNG_COLOR_MASK_COLOR 2
#define PNG_COLOR_MASK_ALPHA 4
#define PNG_COLOR_TYPE_GRAY 0
#define PNG_COLOR_TYPE_PALETTE (PNG_COLOR_MASK_COLOR | PNG_COLOR_MASK_PALETTE)
#define PNG_COLOR_TYPE_RGB (PNG_COLOR_MASK_COLOR)
#define PNG_COLOR_TYPE_RGB_ALPHA (PNG_COLOR_MASK_COLOR | PNG_COLOR_MASK_ALPHA)
#define PNG_COLOR_TYPE_GRAY_ALPHA (PNG_COLOR_MASK_ALPHA)

#ifdef __cplusplus
extern "C" {
#endif

typedef unsigned char png_byte;
typedef png_byte* png_bytep;
typedef const png_byte* png_const_bytep;
typedef unsigned int png_uint_32;
typedef int png_int_32;
typedef png_int_32 png_fixed_point;
typedef const char* png_const_charp;
typedef void* png_voidp;
typedef struct png_struct_def png_struct;
typedef png_struct* png_structp;
typedef const png_struct* png_const_structp;
typedef png_struct** png_structpp;
typedef struct png_info_def png_info;
typedef png_info* png_infop;
typedef const png_info* png_const_infop;
typedef png_info** png_infopp;
typedef void (*png_error_ptr)(png_structp, png_const_charp);
typedef void (*png_longjmp_ptr)(jmp_buf, int);

int png_sig_cmp(png_const_bytep sig, size_t start, size_t num_to_check);
png_structp png_create_read_struct(png_const_charp user_png_ver, png_voidp error_ptr,
                                   png_error_ptr error_fn, png_error_ptr warn_fn);
png_infop png_create_info_struct(png_const_structp png_ptr);
void png_destroy_read_struct(png_structpp png_ptr_ptr, png_infopp info_ptr_ptr,
                             png_infopp end_info_ptr_ptr);
jmp_buf* png_set_longjmp_fn(png_structp png_ptr, png_longjmp_ptr longjmp_fn,
                            size_t jmp_buf_size);
void png_init_io(png_structp png_ptr, FILE* fp);
void png_set_sig_bytes(png_structp png_ptr, int num_bytes);
void png_read_info(png_structp png_ptr, png_infop info_ptr);
png_uint_32 png_get_image_width(png_const_structp png_ptr, png_const_infop info_ptr);
png_uint_32 png_get_image_height(png_const_structp png_ptr, png_const_infop info_ptr);
png_byte png_get_color_type(png_const_structp png_ptr, png_const_infop info_ptr);
png_byte png_get_bit_depth(png_const_structp png_ptr, png_const_infop info_ptr);
size_t png_get_rowbytes(png_const_structp png_ptr, png_const_infop info_ptr);
void png_set_strip_16(png_structp png_ptr);
void png_set_palette_to_rgb(png_structp png_ptr);
void png_set_expand_gray_1_2_4_to_8(png_structp png_ptr);
void png_set_strip_alpha(png_structp png_ptr);
void png_set_rgb_to_gray_fixed(png_structp png_ptr, int error_action, png_fixed_point red,
                               png_fixed_point green);
void png_read_update_info(png_structp png_ptr, png_infop info_ptr);
void png_read_row(png_structp png_ptr, png_bytep row, png_bytep display_row);

#ifdef __cplusplus
}
#endif

#define png_jmpbuf(png_ptr) (*png_set_longjmp_fn((png_ptr), longjmp, (sizeof(jmp_buf))))

#endif
