// The quantization ladder's f32 x packed int4 pair (int4 rung): B1, B2 and both B5 forms.
// See quant.cuh.

#include "quant.cuh"

SK_QUANT_PAIR(f32_i4, float, int8_t, true)
