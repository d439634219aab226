// Tile sizes shared by the attention forward and backward kernels
// (flash_fwd.cuh, flash_bwd.cuh).
#pragma once

#include "common.cuh"

namespace e2v {
namespace {

constexpr int kBQ = 64;   // query rows per tile
constexpr int kBKV = 64;  // KV rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLDS = 64 + 4;  // f32 score tile leading dim
constexpr int kLDP = 64 + 8;  // bf16 probability tile leading dim

}  // namespace
}  // namespace e2v
