// K2's 3xTF32 forward on row maps (mfar_flash_attention_fwd_tf32_rows):
// flash_attention_tf32.cu's rows mode, compiled as a library of its own so
// that its eight instances (NS = 1-8) build beside the per-head ones.
#define MFAR_TF32_ROWS_ONLY
#include "flash_attention_tf32.cu"
