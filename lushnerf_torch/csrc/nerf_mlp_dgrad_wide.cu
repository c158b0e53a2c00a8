// The dgrads of nerf_mlp_dgrad.cu for a PE with a part of 128 channels (kx
// or kd = 128, 16 or more frequencies), whose d_pe passes take 64
// accumulators a thread: a build of its own, loaded only for such a PE, so
// that the others keep their code and nerf_mlp_dgrad.cu its build time.

#define NERF_MLP_WIDE_PE 1
#include "nerf_mlp_dgrad.cu"
