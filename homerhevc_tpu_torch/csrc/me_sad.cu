// Coarse motion-search SAD sweep for Hopper (sm_90a).
//
// Replaces homerhevc_tpu/ops/pallas/me_sad.py:_sweep_kernel (the TPU
// Pallas kernel behind coarse_sweep_sads). For every offset (dy, dx) in
// [-R, R]^2 it computes the m x m block SAD of the 2x-decimated source
// `sd` (gh*m, gw*m) against the edge-padded 2x-decimated reference
// `ref_pad` (gh*m + 2R, gw*m + 2R), and writes out[(dy+R)*side + dx+R,
// gy, gx] as int32 (side = 2R + 1): the layout the JAX function returns.
// Samples are 8-bit (uint8); m is a multiple of 8.
//
// A wide source (the bi-prediction target 2 * src - pred of the B
// program, in [-255, 510]) takes the second entry point. For a reference
// sample r in [0, 255] and any integer s,
//   |s - r| = |clamp(s, 0, 255) - r| + |s - clamp(s, 0, 255)|,
// so the block SAD at every offset is the 8-bit SAD of the clamped source
// plus the block's excess, one constant per block that does not depend on
// the offset. The wrapper passes the clamped source as uint8 and the
// excess as int32 (gh, gw); the kernel adds it in the store epilogue, so
// the inner loop and the staging are the same for both entry points.
//
// What bounds it: at 720p (m = 8, R = 16) one P frame reads 0.46 MB of
// `sd` and 0.53 MB of `ref_pad` and writes a 15.7 MB int32 result: 16.2 MB,
// 4.8 us at 3.35 TB/s. Its 251 M |a - b| + acc pairs take 63 M packed-byte
// instructions (4 pairs each) on the SMs' integer lanes, ~3.8 us at
// 132 SMs x 64 lanes x 1.98 GHz (tools/me_sad_forms.py measures the
// instruction at 62 lanes per clock per SM), so the kernel is bound by
// bytes; a SAD cannot use the tensor cores' int8 rate. On an H100 80GB HBM3
// at 700 W it reaches ~20 % of that bound (0.023 ms, PERF.md). What holds
// it back: each 16 VABSDIFF4 share the integer pipe with 9 funnel shifts
// and ~4 address and loop instructions, and staging and stores add ~40 %
// more; 40 dx are computed for 33 at R = 16 to keep 8-byte alignment;
// 1350 blocks make 2.6 waves with a partial last one.
// The design:
//  - Packed bytes and register blocking over dx. A thread owns one block
//    column gx, one dy and a run of 8 consecutive dx. For each source row
//    chunk of 8 samples it loads the 8 source bytes and the 16 reference
//    bytes they can reach (three 64-bit shared loads for 64 pairs), forms
//    the 12 byte-shifted reference words with funnel shifts, and adds 4
//    pairs into the running sum per instruction with the packed-byte
//    absolute difference (PTX vabsdiff4 .add, SASS VABSDIFF4.U8.ACC).
//  - Coalesced stores. Lanes hold consecutive block columns gx of one
//    (dy, dx), so each group of 16 lanes writes 64 contiguous bytes of one
//    output row; the int32 result is written exactly once.
//  - Enough blocks. A block owns one block-row gy, a tile of 16 block
//    columns and a chunk of dy values, so 720p R = 16 launches
//    5 x 45 x 6 = 1350 blocks of 480 threads.
//    Each block stages its source tile and the reference band of its dy
//    chunk in shared memory once (a few KB).
// Sums fit int32: 255 * m * m < 2^31 for every m the planes allow, and
// the excess of an int16 source adds at most 32768 * m * m.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;  // block columns per CUDA block (16 lanes)
constexpr int kRun = 8;    // consecutive dx per thread

// Reference bytes [o, o + 4) of the 16-byte window w as one word.
__device__ __forceinline__ uint32_t window(const uint32_t (&w)[4], int o) {
  const int k = o >> 2, s = o & 3;
  return s == 0 ? w[k] : __funnelshift_r(w[k], w[k + 1], 8 * s);
}

// acc + the sum of |a_i - b_i| over the four byte pairs of a and b.
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

__global__ void coarse_sweep_kernel(const uint8_t* __restrict__ sd,
                                    const uint8_t* __restrict__ ref_pad,
                                    const int32_t* __restrict__ excess,
                                    int32_t* __restrict__ out,
                                    int gh, int gw, int m, int R, int nruns,
                                    int dyc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int side = 2 * R + 1;
  const int gy = blockIdx.y;
  const int gx0 = blockIdx.x * kTile;
  const int dy0 = blockIdx.z * dyc;
  const int nb = min(kTile, gw - gx0);        // block columns in this tile
  const int sw = gw * m;                      // source width
  const int rw = sw + 2 * R;                  // padded reference width
  const int tw = kTile * m;                   // tile width (source)
  const int bw = tw + kRun * nruns;           // band width, a multiple of 8
  const int nrows = min(dyc, side - dy0) + m - 1;
  uint8_t* s_src = smem;                      // m x tw
  uint8_t* s_ref = smem + m * tw;             // nrows x bw

  // stage the source tile and the reference band (padded rows
  // gy*m + dy0 .., padded columns gx0*m ..); columns past the tile's
  // data are zero and feed only lanes and dx that are never stored
  const int ncols = nb * m;
  for (int r = threadIdx.y; r < m; r += blockDim.y) {
    const uint8_t* g = sd + (size_t)(gy * m + r) * sw + gx0 * m;
    for (int c = threadIdx.x; c < tw; c += blockDim.x) {
      s_src[r * tw + c] = c < ncols ? g[c] : 0;
    }
  }
  const int bcols = ncols + 2 * R;
  for (int r = threadIdx.y; r < nrows; r += blockDim.y) {
    const uint8_t* g = ref_pad + (size_t)(gy * m + dy0 + r) * rw + gx0 * m;
    for (int c = threadIdx.x; c < bw; c += blockDim.x) {
      s_ref[r * bw + c] = c < bcols ? g[c] : 0;
    }
  }
  __syncthreads();

  const int b = threadIdx.x % kTile;
  const int dx0 = kRun * (threadIdx.x / kTile);
  const int dyl = threadIdx.y;
  const int dy = dy0 + dyl;
  if (b >= nb || dy >= side) return;

  uint32_t acc[kRun];
#pragma unroll
  for (int d = 0; d < kRun; ++d) acc[d] = 0;
  for (int r = 0; r < m; ++r) {
    const uint8_t* srow = s_src + r * tw + b * m;
    const uint8_t* qrow = s_ref + (dyl + r) * bw + b * m + dx0;
    for (int j = 0; j < m; j += 8) {
      const uint2 s = *reinterpret_cast<const uint2*>(srow + j);
      const uint2 q0 = *reinterpret_cast<const uint2*>(qrow + j);
      const uint2 q1 = *reinterpret_cast<const uint2*>(qrow + j + 8);
      const uint32_t w[4] = {q0.x, q0.y, q1.x, q1.y};
#pragma unroll
      for (int d = 0; d < kRun; ++d) {
        acc[d] = sad4(s.x, window(w, d), acc[d]);
        acc[d] = sad4(s.y, window(w, d + 4), acc[d]);
      }
    }
  }
  const size_t plane = (size_t)gh * gw;
  const size_t cell = (size_t)gy * gw + gx0 + b;
  // the wide entry point's per-block excess (0 for an 8-bit source)
  const int32_t e = excess != nullptr ? excess[cell] : 0;
  int32_t* o = out + (size_t)(dy * side + dx0) * plane + cell;
#pragma unroll
  for (int d = 0; d < kRun; ++d) {
    if (dx0 + d < side) o[d * plane] = (int32_t)acc[d] + e;
  }
}

// Launch geometry: 16 block columns x nruns dx-runs of 8 threads per dy,
// dyc dy values per block (at most ~512 threads), the dy range split into
// equal chunks.
struct Geometry {
  int nruns, dyc, nchunks;
  long smem;
};

Geometry geometry(int m, int R) {
  const int side = 2 * R + 1;
  Geometry g;
  g.nruns = (side + kRun - 1) / kRun;
  const int per_dy = kTile * g.nruns;
  const int cap = per_dy >= 512 ? 1 : 512 / per_dy;
  g.nchunks = (side + cap - 1) / cap;
  g.dyc = (side + g.nchunks - 1) / g.nchunks;
  g.nchunks = (side + g.dyc - 1) / g.dyc;
  const long tw = (long)kTile * m;
  g.smem = (long)m * tw + (long)(g.dyc + m - 1) * (tw + kRun * g.nruns);
  return g;
}

int launch(const void* sd, const void* ref_pad, const void* excess,
           void* out, int gh, int gw, int m, int R, void* stream) {
  const Geometry g = geometry(m, R);
  if (m % 8 != 0 || kTile * g.nruns > 1024) return (int)cudaErrorInvalidValue;
  if (g.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        coarse_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((gw + kTile - 1) / kTile, gh, g.nchunks);
  dim3 block(kTile * g.nruns, g.dyc);
  coarse_sweep_kernel<<<grid, block, g.smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sd), static_cast<const uint8_t*>(ref_pad),
      static_cast<const int32_t*>(excess), static_cast<int32_t*>(out), gh, gw,
      m, R, g.nruns, g.dyc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches the sweep on `stream` and returns
// cudaGetLastError() as an int (0 on success). Pointers are device
// pointers to contiguous arrays: sd and ref_pad uint8, excess and out
// int32.

// An 8-bit source.
int coarse_sweep_sads_launch(const void* sd, const void* ref_pad, void* out,
                             int gh, int gw, int m, int R, void* stream) {
  return launch(sd, ref_pad, nullptr, out, gh, gw, m, R, stream);
}

// A wide source: sd is its clamp to [0, 255], excess (gh, gw) the sum of
// |s - clamp(s, 0, 255)| over each block.
int coarse_sweep_sads_wide_launch(const void* sd, const void* ref_pad,
                                  const void* excess, void* out, int gh,
                                  int gw, int m, int R, void* stream) {
  return launch(sd, ref_pad, excess, out, gh, gw, m, R, stream);
}

}  // extern "C"
