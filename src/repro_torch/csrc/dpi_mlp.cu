// Ternary DPI MLP (64 -> 128 -> 64 -> 1, ReLU) over every 64-byte beat,
// for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/dpi_mlp.py:dpi_scores_pallas
// (body _dpi_kernel), which runs the three layers as MXU dots over a
// VMEM tile of 512 beats.  The MLP is dpi_mma.cuh's: exact int8 layer 1,
// layer 2 as three bf16 MMAs over an exact split of h1, layer 3 in fp32,
// one warp per 16-beat tile.  Here a persistent grid (up to four 4-warp
// blocks an SM) copies the weight image in once per block (25,616 B, one
// bulk copy), then every warp walks its own 16-beat tiles (a block covers
// 64 beats a step),
// double-buffered: the next tile's 1 KiB comes in by cp.async while the
// tensor cores work on this one.  Rows past n_beats are loaded as zero
// and not stored.
//
// Bound on the H100: operations.  Per beat 16,384 int8 ops (1,979 TOP/s)
// + 3 x 16,384 bf16 FLOP (989 TFLOP/s) + 128 fp32 FLOP (67 TFLOP/s)
// against 64 B read and 4 B written (3.35 TB/s): 0.031 ms of operations
// against 0.011 ms of bytes for 524,288 beats.
#include <cstdint>
#include <cuda_runtime.h>

#include "dpi_mma.cuh"
#include "grid.cuh"

namespace {

// one warp: tile t's 64 chunks of 16 B into buf, rows past n_beats zeroed
__device__ __forceinline__ void load_tile(uint8_t* buf,
                                          const uint8_t* payload,
                                          long long t, long long n_beats,
                                          int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h, row = c >> 2, part = c & 3;
    const long long beat = t * dpi::kRows + row;
    const bool valid = beat < n_beats;
    dpi::cp_async16(buf + row * dpi::kRowBytes + part * 16,
                    valid ? payload + beat * 64 + part * 16 : payload, valid);
  }
}

__global__ void __launch_bounds__(dpi::kWarps * 32, dpi::kBlocksPerSm)
dpi_mlp_kernel(const uint8_t* __restrict__ payload,
               const uint8_t* __restrict__ image, float* __restrict__ out,
               long long n_beats) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // shared memory: the weights, then two tiles a warp
  uint8_t* buf = reinterpret_cast<uint8_t*>(sm + dpi::kWeightWords) +
                 warp * 2 * dpi::kTileBytes;
  const long long n_tiles = (n_beats + dpi::kRows - 1) / dpi::kRows;
  const long long stride = (long long)gridDim.x * dpi::kWarps;
  long long t = (long long)blockIdx.x * dpi::kWarps + warp;
  if (t < n_tiles) load_tile(buf, payload, t, n_beats, lane);
  dpi::cp_async_commit();
  dpi::Copies c(sm);
  if (tid == 0) {
    c.start(dpi::kImageBytes);
    c.copy(sm, image, dpi::kImageBytes);
  }
  __syncthreads();                               // the mbarrier is set up
  c.wait();
  const dpi::Weights w = dpi::weights_at(sm);

  for (int s = 0; t < n_tiles; t += stride, s ^= 1) {
    if (t + stride < n_tiles)
      load_tile(buf + (s ^ 1) * dpi::kTileBytes, payload, t + stride,
                n_beats, lane);
    dpi::cp_async_commit();
    dpi::cp_async_wait<1>();                     // this tile has landed
    __syncwarp();
    const float2 y = dpi::tile_scores(buf + s * dpi::kTileBytes, w, lane);
    if ((lane & 3) == 0) {
      const long long beat = t * dpi::kRows + (lane >> 2);
      if (beat < n_beats) out[beat] = y.x;
      if (beat + 8 < n_beats) out[beat + 8] = y.y;
    }
    __syncwarp();                                // buf s is free again
  }
}

constexpr int kSmem = dpi::kWeightBytes + dpi::kWarps * 2 * dpi::kTileBytes;

}  // namespace

extern "C" {

// payload: n_beats x 64 uint8; image: the weight image (dpi::kImageBytes,
// see dpi_mma.cuh); both 16-byte aligned.  out: (n_beats,) float32.  The
// SM count is looked up once per device, not on every launch.
int dpi_mlp_launch(const void* payload, const void* image, void* out,
                   long long n_beats, void* stream) {
  if (n_beats <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = grid::current_device(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = dpi::grid_blocks(
      (n_beats + dpi::kRows - 1) / dpi::kRows, dpi::kWarps, sms);
  dpi_mlp_kernel<<<(unsigned)blocks, dpi::kWarps * 32, kSmem,
                   (cudaStream_t)stream>>>((const uint8_t*)payload,
                                           (const uint8_t*)image, (float*)out,
                                           n_beats);
  return (int)cudaGetLastError();
}

const char* balboa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
