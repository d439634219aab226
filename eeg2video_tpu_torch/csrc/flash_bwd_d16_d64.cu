// Instantiations of the attention backward (flash_bwd.cuh) for head dims
// padded to 16, 32, 48, 64, in both layouts. The head dims are spread over
// flash_bwd_d*.cu so that the build compiles them in parallel.
#include "flash_bwd.cuh"

namespace e2v {
E2V_BWD_INSTANTIATE(16)
E2V_BWD_INSTANTIATE(32)
E2V_BWD_INSTANTIATE(48)
E2V_BWD_INSTANTIATE(64)
}  // namespace e2v
