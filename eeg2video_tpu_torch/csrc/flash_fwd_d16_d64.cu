// Instantiations of the attention forward (flash_fwd.cuh) for head dims
// padded to 16, 32, 48, 64, in both layouts. The head dims are spread over
// flash_fwd_d*.cu so that the build compiles them in parallel.
#include "flash_fwd.cuh"

namespace e2v {
E2V_FWD_INSTANTIATE(16)
E2V_FWD_INSTANTIATE(32)
E2V_FWD_INSTANTIATE(48)
E2V_FWD_INSTANTIATE(64)
}  // namespace e2v
