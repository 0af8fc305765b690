// Issue rate of the packed-byte absolute difference with accumulate
// (PTX vabsdiff4 .add, SASS VABSDIFF4.U8.ACC) on one card: every thread
// runs 8 independent accumulator chains for `iters` rounds, so the SMs'
// issue of this one instruction, not its latency, sets the time.
// Built and timed by homerhevc_tpu_torch/tools/me_sad_forms.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void vabsdiff4_chains(uint32_t* out, uint32_t a, uint32_t b,
                                 int iters) {
  uint32_t acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = threadIdx.x + k;
  const uint32_t x = a ^ threadIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      asm volatile("vabsdiff4.u32.u32.u32.add %0, %1, %2, %0;"
                   : "+r"(acc[k]) : "r"(x), "r"(b + k));
    }
  }
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" int vabsdiff4_rate_launch(void* out, int blocks, int threads,
                                     int iters, void* stream) {
  vabsdiff4_chains<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), 0x12345678u, 0x9abcdef0u, iters);
  return (int)cudaGetLastError();
}
