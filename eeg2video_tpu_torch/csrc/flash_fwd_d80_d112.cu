// Instantiations of the attention forward (flash_fwd.cuh) for head dims
// padded to 80, 96, 112, in both layouts. The head dims are spread over
// flash_fwd_d*.cu so that the build compiles them in parallel.
#include "flash_fwd.cuh"

namespace e2v {
E2V_FWD_INSTANTIATE(80)
E2V_FWD_INSTANTIATE(96)
E2V_FWD_INSTANTIATE(112)
}  // namespace e2v
