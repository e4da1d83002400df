// Grouped 1-nearest-neighbour: for every query point, the squared distance
// to the nearest reference point of the same group, and that point's index.
//
// Replaces: chore_tpu/ops/pallas/nn.py::_nn_kernel (launched by nn_pallas).
// Semantics kept exactly:
//   * d_ij = max(|x_i|^2 - 2 x_i.y_j + |y_j|^2, 0), the same expansion the
//     plain version (chore_tpu_torch/ops/nn.py::nn_sqdist_plain) computes;
//   * a reference matches a query only when their group ids (f32, exact
//     below 2^24) are equal; masked references carry group -1;
//   * a query with no match gets d = 1e10 and index 0;
//   * ties go to the lowest index: references are scanned in ascending
//     order and the best is replaced only on a strict '<'.
//
// Bound on an H100: for the contact loss call (6890 queries x 3000 refs,
// B=1) the work is ~2.1e7 pairs x ~8 f32 operations = 0.17 GFLOP, about
// 2.5 us at 67 TFLOP/s (non-tensor f32), while its traffic is ~0.2 MB,
// well under 1 us at 3.35 TB/s: the kernel is bound by operations, and at
// these sizes in practice by launch latency.
//
// Design (first, simple version): grid (ceil(N / THREADS), B); each thread
// owns one query and keeps it in registers. The block stages the batch's
// reference cloud through shared memory in chunks of CHUNK points as
// (x, y, z, |y|^2) plus the group id, and every thread scans the chunk in
// ascending order. No (N, M) matrix touches device memory, the analogue of
// the TPU kernel keeping it in VMEM. A faster version (one launch for the
// three calls of a loss step, distance tiles on the tensor cores, splitting
// M across blocks) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 1024;
constexpr float BIG = 1e10f;

__global__ void __launch_bounds__(THREADS)
nn_grouped_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ qg, const float* __restrict__ rg,
                  float* __restrict__ d_out, int* __restrict__ i_out,
                  int N, int M) {
  __shared__ float4 s_ref[CHUNK];
  __shared__ float s_grp[CHUNK];

  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool active = i < N;
  const float* xb = x + (size_t)b * N * 3;
  const float* yb = y + (size_t)b * M * 3;
  const float* rgb = rg + (size_t)b * M;

  float qx = 0.f, qy = 0.f, qz = 0.f, qq = 0.f, g = 0.f;
  if (active) {
    qx = xb[3 * i + 0];
    qy = xb[3 * i + 1];
    qz = xb[3 * i + 2];
    qq = __fmaf_rn(qz, qz, __fmaf_rn(qy, qy, qx * qx));
    g = qg[(size_t)b * N + i];
  }
  float best = BIG;
  int best_i = 0;

  for (int c0 = 0; c0 < M; c0 += CHUNK) {
    const int n = min(CHUNK, M - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < n; j += THREADS) {
      const float rx = yb[3 * (c0 + j) + 0];
      const float ry = yb[3 * (c0 + j) + 1];
      const float rz = yb[3 * (c0 + j) + 2];
      const float rr = __fmaf_rn(rz, rz, __fmaf_rn(ry, ry, rx * rx));
      s_ref[j] = make_float4(rx, ry, rz, rr);
      s_grp[j] = rgb[c0 + j];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float4 r = s_ref[j];
        const float dot = __fmaf_rn(qz, r.z, __fmaf_rn(qy, r.y, qx * r.x));
        const float d = fmaxf(__fmaf_rn(-2.f, dot, qq) + r.w, 0.f);
        if (s_grp[j] == g && d < best) {
          best = d;
          best_i = c0 + j;
        }
      }
    }
  }
  if (active) {
    d_out[(size_t)b * N + i] = best;
    i_out[(size_t)b * N + i] = best_i;
  }
}

}  // namespace

// x (B, N, 3), y (B, M, 3), qg (B, N), rg (B, M): f32, contiguous, on the
// device. d_out (B, N) f32 and i_out (B, N) i32 are written. Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int nn_grouped_launch(const float* x, const float* y,
                                 const float* qg, const float* rg,
                                 float* d_out, int* i_out, int B, int N, int M,
                                 void* stream) {
  if (B <= 0 || N <= 0) return 0;
  dim3 grid((N + THREADS - 1) / THREADS, B);
  nn_grouped_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, qg, rg, d_out, i_out, N, M);
  return static_cast<int>(cudaGetLastError());
}
