// K2 of model_loss.cuh in float32 at one ModelSize: two bodies, a free
// base and a revolute or prismatic joint, each with one plane-convex pair
// of 4 witnesses (n_v = 7, k = 8): the elbow (box or polygon), pris2, the
// actuated paddle.
// K2 is one reverse-mode sweep per sample (model_adjoint.cuh). A source
// of its own for each type, so that nvcc builds the two types beside each
// other and the other sources.

#include "model_loss.cuh"

using Model_b2_q8_v7_k8 = ModelSize<2, 8, 7, 2, 4>;

DEFINE_MODEL_BWD_ENTRIES(Model_b2_q8_v7_k8, b2_q8_v7_k8, float, f32)
