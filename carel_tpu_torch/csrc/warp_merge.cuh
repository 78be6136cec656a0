// What the row-gradient kernels K2 (csrc/mmd.cu) and K6 (csrc/hsic.cu)
// share: the merge of a warp's per-lane accumulators, and the choice of the
// kernel instance for a row width.
#pragma once

// The sum over the warp of each of a lane's R values (R a power of two, at
// most 32), by recursive halving: at offset O a lane keeps half of its
// values, the upper half if bit O of its lane is set, and adds its partner's
// copy of them (R / 2 shuffles instead of R). Each value is summed over the
// same pairs of lanes, in the same tree, as by a butterfly of its own, so
// the bits are those of that butterfly. Afterwards v[0] of lane l holds the
// sum of value l / (32 / R), once in every 32 / R lanes.
template <int R, int O = 16, typename T, int N>
__device__ __forceinline__ void warp_reduce_scatter(T (&v)[N], int lane) {
  if constexpr (O > 0) {
    if constexpr (R > 1) {
      const bool upper = (lane & O) != 0;
#pragma unroll
      for (int m = 0; m < R / 2; ++m) {
        const T send = upper ? v[m] : v[m + R / 2];
        const T keep = upper ? v[m + R / 2] : v[m];
        v[m] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      warp_reduce_scatter<R / 2, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      warp_reduce_scatter<1, O / 2>(v, lane);
    }
  }
}

// The accumulators a lane merges for rows of DP coordinates: DP rounded up
// to a power of two, at least 8.
template <int DP>
constexpr int kMergedValues = DP <= 8 ? 8 : (DP <= 16 ? 16 : 32);

// DO(DP) for d rounded up to 8 coordinates, DP of 8, 16, 24 or 32; the
// kernels keep their rows zero past d, which leaves every sum bit for bit
// as over d.
#define CAREL_DISPATCH_DIM(d, DO) \
  do {                            \
    if ((d) <= 8)                 \
      DO(8);                      \
    else if ((d) <= 16)           \
      DO(16);                     \
    else if ((d) <= 24)           \
      DO(24);                     \
    else                          \
      DO(32);                     \
  } while (0)
