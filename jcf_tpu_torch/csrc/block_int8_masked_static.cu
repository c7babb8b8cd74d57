// The persistent int8 layer kernel (block_int8.cuh) for K9a's masked route: the folded
// tree's "hidden" and "full" modes (with or without the calibrated softmax
// shift: the masked attention reads none, so the C entry sends both here);
// built apart from the other instances so that nvcc compiles them at once.
#include "block_int8.cuh"

namespace jcf_k9 {
JCF_K9_FOLDED_STATIC(JCF_K9_INSTANCE, float, true, false)
}  // namespace jcf_k9
