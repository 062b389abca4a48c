// rt::Steps, a tile length known at compile time, for the tile pipelines
// (chain_pipeline.cuh, fused_front.cuh).
#pragma once

namespace rt {

// a tile length known at compile time: a loop bounded by it has no
// per-step test once unrolled (std::integral_constant's conversion is not
// callable from device code)
template <int N>
struct Steps {
  __host__ __device__ constexpr operator int() const { return N; }
};

}  // namespace rt
