// K1 and K3 of model_loss.cuh at one ModelSize: two bodies, a free base and a
// revolute or prismatic joint, each with one plane-convex pair of 4
// witnesses (n_v = 7, k = 8): the elbow (box or polygon), pris2, the
// actuated paddle; two contacts a lane (kFwdLanes).
// A source of its own, so that nvcc builds it beside the other sources.

#include "model_loss.cuh"

using Model_b2_q8_v7_k8 = ModelSize<2, 8, 7, 2, 4>;

DEFINE_MODEL_FWD_ENTRIES(Model_b2_q8_v7_k8, b2_q8_v7_k8,
                         kFwdLanes<Model_b2_q8_v7_k8>)
