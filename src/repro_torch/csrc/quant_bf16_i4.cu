// The quantization ladder's bf16 x packed int4 pair (int4 rung): B1, B2 and both B5 forms.
// See quant.cuh.

#include "quant.cuh"

SK_QUANT_PAIR(bf16_i4, __nv_bfloat16, int8_t, true)
