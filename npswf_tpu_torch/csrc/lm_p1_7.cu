// K3 instantiations for P = 1..7 (lm.cuh), dispatched by lm.cu.
#include "lm.cuh"

NPSWF_LM_WIDTH(, 1)
NPSWF_LM_WIDTH(, 2)
NPSWF_LM_WIDTH(, 3)
NPSWF_LM_WIDTH(, 4)
NPSWF_LM_WIDTH(, 5)
NPSWF_LM_WIDTH(, 6)
NPSWF_LM_WIDTH(, 7)
