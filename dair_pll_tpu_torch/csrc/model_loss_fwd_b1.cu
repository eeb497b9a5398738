// K1 and K3 of model_loss.cuh at one ModelSize: one free body with one
// plane-convex pair of 4 witnesses (n_v = 6, k = 4), such as the polygon
// cube; one thread a sample (kFwdLanes).
// A source of its own, so that nvcc builds it beside the other sources.

#include "model_loss.cuh"

using Model_b1_q7_v6_k4 = ModelSize<1, 7, 6, 1, 4>;

DEFINE_MODEL_FWD_ENTRIES(Model_b1_q7_v6_k4, b1_q7_v6_k4,
                         kFwdLanes<Model_b1_q7_v6_k4>)
