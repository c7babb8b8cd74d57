// The int8 layer kernel (fused_layer.cuh) for K9c/K9d's bf16 mid with dynamic LN scales:
// its 8 instances over the context, hidden and shift options, built apart
// from the other (mid, LN scale) pairs so that nvcc compiles the four at once.
#include "fused_layer.cuh"

template int jcf_fused::launch_int8_part<false, false>(const jcf_fused::Int8Launch&, bool, bool,
                                                       bool);

JCF_FUSED_PROFILE_ENTRY(jcf_fused_profile_bf16mid_dyn)
