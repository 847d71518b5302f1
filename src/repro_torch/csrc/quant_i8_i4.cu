// int8 activations x packed int4 weights (int32 MAC): B1, B2, both B5 forms
// and B6.
// See quant.cuh.

#include "quant.cuh"

SK_QUANT_PAIR(i8_i4, int8_t, int8_t, true)
