// The quantization ladder's int8 x int8 pair (int8-dynamic rung, int32 MAC): B1, B2,
// both B5 forms and B6.
// See quant.cuh.

#include "quant.cuh"

SK_QUANT_PAIR(i8_i8, int8_t, int8_t, false)
