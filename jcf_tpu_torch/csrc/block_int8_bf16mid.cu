// The persistent int8 layer kernel (block_int8.cuh) for K9c's and K9d's bf16 mid: the
// folded tree's four modes without the softmax shift, and the unfolded tree;
// built apart from the other instances so that nvcc compiles them at once.
#include "block_int8.cuh"

namespace jcf_k9 {
JCF_K9_FOLDED_MODES(JCF_K9_INSTANCE, bf16, false, false)
JCF_K9_UNFOLDED(JCF_K9_INSTANCE, bf16, false)
}  // namespace jcf_k9
