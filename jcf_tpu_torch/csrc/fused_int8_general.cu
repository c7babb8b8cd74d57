// The int8 layer kernel (fused_layer.cuh) off the folded dense route: its
// general instances, which read the quantization mode and the branch
// (unfolded, masked, non-dense, 65 to 127 tokens, an odd head count) from
// the run-time flags; bf16 rows with the LN rows in shared or global
// memory, and f32 rows. Built apart from the folded dense instances so
// that nvcc compiles it beside them.
#include "fused_layer.cuh"

template int jcf_fused::launch_int8_general<bf16, false>(const jcf_fused::Int8Launch&);
template int jcf_fused::launch_int8_general<bf16, true>(const jcf_fused::Int8Launch&);
template int jcf_fused::launch_int8_general<float, false>(const jcf_fused::Int8Launch&);

JCF_FUSED_PROFILE_ENTRY(jcf_fused_profile_general)
