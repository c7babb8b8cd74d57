// The persistent int8 layer kernel (block_int8.cuh) on f32 rows (K9a on the
// f32 text tower): the folded tree's dynamic mode and the unfolded tree;
// built apart from the other instances so that nvcc compiles them at once.
#include "block_int8.cuh"

namespace jcf_k9 {
JCF_K9_ROWS32(JCF_K9_INSTANCE)
}  // namespace jcf_k9
