// The quantization ladder's bf16 x int8 pair (int8 rung): B1, B2, both B5 forms and B6.
// See quant.cuh.

#include "quant.cuh"

SK_QUANT_PAIR(bf16_i8, __nv_bfloat16, int8_t, false)
