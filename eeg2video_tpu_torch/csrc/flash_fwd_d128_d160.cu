// Instantiations of the attention forward (flash_fwd.cuh) for head dims
// padded to 128, 144, 160, in both layouts. The head dims are spread over
// flash_fwd_d*.cu so that the build compiles them in parallel.
#include "flash_fwd.cuh"

namespace e2v {
E2V_FWD_INSTANTIATE(128)
E2V_FWD_INSTANTIATE(144)
E2V_FWD_INSTANTIATE(160)
}  // namespace e2v
