// The bfloat16 instances of the trailing stage's pass (csrc/poisson_trail.cu),
// a translation unit of their own, compiled in parallel with the float32
// ones (csrc/poisson_bf16.cu says why).
#define PP_BF16_PART
#include "poisson_trail.cu"
