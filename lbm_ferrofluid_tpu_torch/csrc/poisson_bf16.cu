// The bfloat16 instances of B11b's pass (csrc/poisson.cu), a translation
// unit of their own: each storage's instances take about as long to compile
// as the rest of the kernels together, so the two compile in parallel.
#define PP_BF16_PART
#include "poisson.cu"
