// K3 instantiations for P = 10..11 (lm.cuh), dispatched by lm.cu.
#include "lm.cuh"

NPSWF_LM_WIDTH(, 10)
NPSWF_LM_WIDTH(, 11)
