// The quantization ladder's f32 x int8 pair (int8 rung): B1, B2 and both B5 forms.
// See quant.cuh.

#include "quant.cuh"

SK_QUANT_PAIR(f32_i8, float, int8_t, false)
