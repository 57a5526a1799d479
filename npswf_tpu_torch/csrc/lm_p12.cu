// K3 instantiations for P = 12 (lm.cuh), dispatched by lm.cu.
#include "lm.cuh"

NPSWF_LM_WIDTH(, 12)
