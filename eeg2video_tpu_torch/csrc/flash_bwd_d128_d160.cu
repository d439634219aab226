// Instantiations of the attention backward (flash_bwd.cuh) for head dims
// padded to 128, 144, 160, in both layouts. The head dims are spread over
// flash_bwd_d*.cu so that the build compiles them in parallel.
#include "flash_bwd.cuh"

namespace e2v {
E2V_BWD_INSTANTIATE(128)
E2V_BWD_INSTANTIATE(144)
E2V_BWD_INSTANTIATE(160)
}  // namespace e2v
