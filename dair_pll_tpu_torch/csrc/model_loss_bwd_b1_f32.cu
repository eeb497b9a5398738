// K2 of model_loss.cuh in float32 at one ModelSize: one free body with one
// plane-convex pair of 4 witnesses (n_v = 6, k = 4), such as the polygon
// cube.
// K2 is one reverse-mode sweep per sample (model_adjoint.cuh). A source
// of its own for each type, so that nvcc builds the two types beside each
// other and the other sources.

#include "model_loss.cuh"

using Model_b1_q7_v6_k4 = ModelSize<1, 7, 6, 1, 4>;

DEFINE_MODEL_BWD_ENTRIES(Model_b1_q7_v6_k4, b1_q7_v6_k4, float, f32)

// Values of K2's scratch `partial` for B samples and n_p derived scalars
// (every size runs the same block of kModelBwdThreads).
extern "C" long long model_loss_bwd_scratch(long long B, int n_p) {
  return model_blocks(B, kModelBwdThreads) * n_p;
}
