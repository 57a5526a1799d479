// K3 instantiations for P = 13..15 (lm.cuh), dispatched by lm.cu.
#include "lm.cuh"

NPSWF_LM_WIDTH(, 13)
NPSWF_LM_WIDTH(, 14)
NPSWF_LM_WIDTH(, 15)
