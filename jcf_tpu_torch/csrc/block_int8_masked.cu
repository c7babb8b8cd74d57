// The persistent int8 layer kernel (block_int8.cuh) for K9a's masked route (the causal
// text tower, an odd head count): the folded tree's dynamic and "ln" modes
// (with or without the calibrated softmax shift: the masked attention reads
// none, so the C entry sends both here), and the unfolded tree; built apart
// from the other instances so that nvcc compiles them at once.
#include "block_int8.cuh"

namespace jcf_k9 {
JCF_K9_FOLDED_DYN(JCF_K9_INSTANCE, float, true, false)
JCF_K9_UNFOLDED(JCF_K9_INSTANCE, float, true)
}  // namespace jcf_k9
