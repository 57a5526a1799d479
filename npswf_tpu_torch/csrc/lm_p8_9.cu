// K3 instantiations for P = 8..9 (lm.cuh), dispatched by lm.cu.
#include "lm.cuh"

NPSWF_LM_WIDTH(, 8)
NPSWF_LM_WIDTH(, 9)
