// Kernel K2 (rollout.cu) under the integrator rk3_implicit (ops/integration.py),
// for every model and form rollout.cu carries under RK3, in a translation
// unit of its own so that nvcc compiles each rule beside the others.
#include "rollout_kernel.cuh"

TRAJOPT_ROLLOUT_ENTRY(trajopt_rollout_rk3_implicit_f32, kRk3Implicit)
