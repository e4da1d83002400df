// Grouped 1-nearest-neighbour, several problems in one launch: for every
// query point, the squared distance to the nearest reference point of the
// same group, and that point's index.
//
// Replaces: chore_tpu/ops/pallas/nn.py::_nn_kernel (launched by nn_pallas).
// Semantics kept exactly (the plain version is
// chore_tpu_torch/ops/nn.py::nn_sqdist_plain):
//   * d_ij = max(|x_i|^2 - 2 x_i.y_j + |y_j|^2, 0), clamped per pair before
//     the comparison, so several references whose raw value is below 0 all
//     read 0 and the lowest index of them wins;
//   * a reference matches a query only when their group ids (f32, exact
//     below 2^24) are equal; masked references carry group -1; a problem
//     without group rows matches every pair;
//   * a query with no match gets d = 1e10 and index 0;
//   * ties go to the lowest index;
//   * no atomics and a fixed merge order: the outputs are bitwise
//     repeatable from call to call.
// The arithmetic form is the TPU kernel's augmented one: references are
// staged as (-2y, |y|^2), so a pair's distance costs three FMAs and an add.
//
// Bound on an H100, at ~8 f32 operations per matched pair against 67
// TFLOP/s (the bytes, O(N + M), are far below): one joint step of the fit
// (contact h->o 6,890 x 3,000 and o->h 3,000 x 6,890 in 14 part groups,
// collision o->h 3,000 x 6,890 ungrouped) ~2.6 us; the evaluation Chamfer
// (10,000 x 10,000, both directions) ~24 us; the preprocessing's label
// transfer (53,125 x 6,890) ~44 us. Operations bound all three.
//
// Design:
//   * One launch takes a table of up to MAX_PROBLEMS problems by value (a
//     kernel parameter: no copy to the device, nothing that breaks graph
//     capture). The grid covers every problem's query tiles, the problems
//     with the most work per tile first.
//   * A block owns a tile of TILE = 128 queries of one example; each lane
//     keeps Q = 4 of them in registers, so every reference read from shared
//     memory (a broadcast) feeds four pairs. The block's 8 warps scan
//     disjoint eighths of each staged chunk of references.
//   * The reference cloud is split across the blocks of a thread-block
//     cluster (up to 8, sized per launch for about WAVES waves of resident
//     blocks: a joint step's 78 query tiles become 624 blocks, where the
//     first version of this kernel ran 78 blocks of 128 threads, each thread
//     walking all of M).
//     Each block scans one contiguous slice in chunks of up to CHUNK
//     references, copied into shared memory with cp.async.bulk completing
//     on an mbarrier (the next chunk's copy flies while this one is
//     scanned) and converted there once to (-2y, |y|^2) and the group row.
//   * Merges: a block's 8 warps in warp order, then the cluster's blocks in
//     rank order through distributed shared memory, each by (d, index)
//     compared lexicographically -- the lowest index among the minimizers,
//     whatever set of references a partial covered. No scratch in device
//     memory, no second launch. (A packed 64-bit atomicMin on (bits of d,
//     index) would also be exact and order-free, but needs the outputs
//     initialised and unpacked: two more passes.)
//   * The shared scan: when a grouped problem and an ungrouped one have the
//     same queries and references (the fit's contact o->h and collision
//     o->h), the wrapper makes them one problem of kind SHARED; its scan
//     computes each pair's distance once and keeps two running bests, one
//     under the group match and one unconditional.
//   * The scan compares raw distances: per pair, three FMAs and an add on
//     the FMA pipe, and a compare and two selects (one more compare with
//     group rows, three more for a SHARED problem) on the half-rate
//     comparison pipe, which bounds the loop; the clamp would cost one more
//     there. A running best that reaches <= 0 is settled after its chunk:
//     the first reference of the chunk with a raw value <= 0 (exact, since
//     all such read 0 after the clamp); only coinciding points get there.
// Measured on an H100 (PERF.md): a joint step ~9x faster than the first
// version; the evaluation and label-transfer shapes ~3.5-4x their bound.
// Tensor cores are not used: a TF32 product (even split hi/lo in three
// passes) rounds the expansion differently from this f32 form, the index
// contract leaves no room for moved near-ties, and the comparison pipe,
// not the distance arithmetic, bounds the scan.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int Q = 4;                // queries per lane
constexpr int TILE = 32 * Q;        // queries per block
constexpr int CHUNK = 1024;         // references staged at once
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int MAX_PROBLEMS = 8;
// a cluster's blocks keep at least this many references each
constexpr int MIN_REFS_PER_BLOCK = 256;
// resident blocks per SM the registers are capped for (64 a thread)
constexpr int BLOCKS_PER_SM = 4;
// the grid is sized for about this many waves of resident blocks: many
// short blocks, handed out as SMs free up, even out problems whose blocks
// differ in work (a joint step's o->h blocks scan 2.3x the references of
// its h->o blocks, and keep two bests)
constexpr int WAVES = 2;
constexpr float BIG = 1e10f;
// a running best whose clamped value is 0 and whose index is final
constexpr float SETTLED = -__builtin_huge_valf();

enum Kind : int { GROUPED = 0, UNGROUPED = 1, SHARED = 2 };

}  // namespace

// One problem as the caller passes it (ops/nn.py::Problem mirrors it):
// x (B, N, 3), y (B, M, 3) f32; qg (B, N), rg (B, M) f32 group rows, null
// for UNGROUPED; d (B, N) f32 and i (B, N) int64 written; for SHARED, d2/i2
// receive the unconditional answer (d/i the grouped one). y and rg must be
// 16-byte aligned.
struct NNProblem {
  const float* x;
  const float* y;
  const float* qg;
  const float* rg;
  float* d;
  long long* i;
  float* d2;
  long long* i2;
  int B, N, M, kind;
};

namespace {

struct Problem {
  NNProblem p;
  int tiles;  // query tiles per example
  int first;  // the problem's first tile in the grid
};

struct Table {
  Problem p[MAX_PROBLEMS];
  int n;
  int cluster;
};

struct Smem {
  float raw[3 * CHUNK + 4];  // a chunk's xyz as copied (from 16-byte bounds)
  float rawg[CHUNK + 4];     // its group row as copied
  union {
    struct {
      float4 ref[CHUNK];  // (-2x, -2y, -2z, |y|^2)
      float grp[CHUNK];
    } s;
    struct {  // after the scan: the warps' partial answers
      float d[2][WARPS][TILE];
      int i[2][WARPS][TILE];
    } m;
  } u;
  float xd[2][TILE];  // the block's answer, read by the cluster's merge
  int xi[2][TILE];
  uint64_t bar;
};

// ---------------------------------------------------------------------- //
// Hopper's bulk copy and mbarrier (PTX)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// global -> shared, `bytes` a multiple of 16, both ends 16-byte aligned
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Floats [f0, f1) of an array whose base is 16-byte aligned: the copy takes
// [a0, a1), both ends rounded down to 16 bytes (empty when a1 <= a0), and
// float f of the range lies at raw[f - a0] when f < a1; the tail past a1
// (at most 3 floats, or all of a range shorter than that) is read from
// device memory directly, so nothing past f1 is ever read.
struct Span {
  size_t a0, a1;
  __device__ Span(size_t f0, size_t f1) {
    a0 = f0 & ~size_t(3);
    a1 = f1 & ~size_t(3);
    if (a1 < a0) a1 = a0;
  }
  __device__ uint32_t bytes() const {
    return static_cast<uint32_t>((a1 - a0) * sizeof(float));
  }
};

// the raw |x|^2 - 2 x.y + |y|^2 of a query and a staged reference
// (-2y, |y|^2), before the clamp at 0
__device__ __forceinline__ float raw_d(float qx, float qy, float qz,
                                       float qq, const float4& r) {
  const float t =
      __fmaf_rn(qz, r.z, __fmaf_rn(qy, r.y, __fmaf_rn(qx, r.x, r.w)));
  return __fadd_rn(t, qq);
}

// (d, i) replaces (bd, bi) when it is smaller, or equal with a lower index
__device__ __forceinline__ void take_lower(float d, int i, float& bd,
                                           int& bi) {
  if (d < bd || (d == bd && i < bi)) {
    bd = d;
    bi = i;
  }
}

// ---------------------------------------------------------------------- //
// One block's work: query tile `qt` of example `b` against references
// slice `rank` of `C`.
template <int KIND>
__device__ __forceinline__ void nn_block(const NNProblem& P, int b, int qt,
                                         int rank, int C, Smem& sm) {
  constexpr bool GROUPED_ = KIND != UNGROUPED;
  constexpr bool SHARED_ = KIND == SHARED;
  constexpr int SETS = SHARED_ ? 2 : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = P.N, M = P.M;

  // the block's slice of the references, in equal chunks
  const int s0 = static_cast<int>((long long)M * rank / C);
  const int len = static_cast<int>((long long)M * (rank + 1) / C) - s0;
  const int n_chunks = (len + CHUNK - 1) / CHUNK;
  auto chunk_lo = [&](int c) {
    return s0 + static_cast<int>((long long)len * c / n_chunks);
  };
  const size_t yoff = (size_t)b * M * 3, goff = (size_t)b * M;

  // thread 0 stages chunk c: xyz and (grouped) the group row
  auto stage = [&](int c) {
    const int j0 = chunk_lo(c), j1 = chunk_lo(c + 1);
    const Span sx(yoff + 3 * (size_t)j0, yoff + 3 * (size_t)j1);
    const Span sg(goff + j0, goff + j1);
    const uint32_t total = sx.bytes() + (GROUPED_ ? sg.bytes() : 0u);
    mbar_expect_tx(&sm.bar, total);
    if (sx.bytes()) bulk_copy(sm.raw, P.y + sx.a0, sx.bytes(), &sm.bar);
    if (GROUPED_ && sg.bytes())
      bulk_copy(sm.rawg, P.rg + sg.a0, sg.bytes(), &sm.bar);
  };
  if (tid == 0 && n_chunks > 0) stage(0);

  // while the copy flies: this lane's queries
  float qx[Q], qy[Q], qz[Q], qq[Q], qg[Q], bd[Q], ud[Q];
  int bi[Q], ui[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int q = qt * TILE + k * 32 + lane;
    qx[k] = qy[k] = qz[k] = qg[k] = 0.f;
    if (q < N) {
      const float* xq = P.x + ((size_t)b * N + q) * 3;
      qx[k] = xq[0];
      qy[k] = xq[1];
      qz[k] = xq[2];
      if (GROUPED_) qg[k] = P.qg[(size_t)b * N + q];
    }
    qq[k] = __fmaf_rn(qz[k], qz[k], __fmaf_rn(qy[k], qy[k], qx[k] * qx[k]));
    bd[k] = ud[k] = BIG;
    bi[k] = ui[k] = 0;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = chunk_lo(c), n = chunk_lo(c + 1) - j0;
    const Span sx(yoff + 3 * (size_t)j0, yoff + 3 * (size_t)(j0 + n));
    const Span sg(goff + j0, goff + j0 + n);
    mbar_wait(&sm.bar, c & 1);
    // convert once: (-2y, |y|^2) (the scaling by -2 is exact) and the group
    for (int jj = tid; jj < n; jj += THREADS) {
      const size_t f = yoff + 3 * (size_t)(j0 + jj);
      float v[3];
#pragma unroll
      for (int e = 0; e < 3; ++e)
        v[e] = f + e < sx.a1 ? sm.raw[f + e - sx.a0] : P.y[f + e];
      const float rr =
          __fmaf_rn(v[2], v[2], __fmaf_rn(v[1], v[1], v[0] * v[0]));
      sm.u.s.ref[jj] = make_float4(-2.f * v[0], -2.f * v[1], -2.f * v[2], rr);
      if (GROUPED_) {
        const size_t g = goff + j0 + jj;
        sm.u.s.grp[jj] = g < sg.a1 ? sm.rawg[g - sg.a0] : P.rg[g];
      }
    }
    __syncthreads();  // the table is ready, the raw buffers are free
    if (tid == 0 && c + 1 < n_chunks) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      stage(c + 1);
    }
    // warp w scans its eighth of the chunk in ascending order (strict <),
    // on the raw distance: the clamp costs an instruction a pair on the
    // comparison pipe, which bounds this loop, and matters only where a
    // raw value reaches 0 -- settled below
    const int lo = n * warp / WARPS, hi = n * (warp + 1) / WARPS;
#pragma unroll 2
    for (int jj = lo; jj < hi; ++jj) {
      const float4 r = sm.u.s.ref[jj];
      const float g = GROUPED_ ? sm.u.s.grp[jj] : 0.f;
      const int j = j0 + jj;
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        const float d = raw_d(qx[k], qy[k], qz[k], qq[k], r);
        if (SHARED_ && d < ud[k]) {
          ud[k] = d;
          ui[k] = j;
        }
        if ((!GROUPED_ || g == qg[k]) && d < bd[k]) {
          bd[k] = d;
          bi[k] = j;
        }
      }
    }
    // a best that fell to <= 0 in this chunk: every reference with a raw
    // value <= 0 reads 0 after the clamp, so the answer is the first of
    // them (this chunk's part of the warp's references is ascending, and
    // earlier chunks held none); it is then settled at -inf, which no later
    // reference (higher indices) may beat, and reads 0 at the merge. Rare:
    // only coinciding points get here.
    bool fix[2][Q], any = false;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      fix[0][k] = bd[k] <= 0.f && bd[k] != SETTLED;
      fix[1][k] = SHARED_ && ud[k] <= 0.f && ud[k] != SETTLED;
      any |= fix[0][k] || fix[1][k];
    }
    if (__any_sync(0xffffffffu, any)) {
      for (int jj = hi - 1; jj >= lo; --jj) {  // down: the first one stays
        const float4 r = sm.u.s.ref[jj];
        const float g = GROUPED_ ? sm.u.s.grp[jj] : 0.f;
#pragma unroll
        for (int k = 0; k < Q; ++k) {
          const float d = raw_d(qx[k], qy[k], qz[k], qq[k], r);
          if (fix[0][k] && (!GROUPED_ || g == qg[k]) && d <= 0.f)
            bi[k] = j0 + jj;
          if (fix[1][k] && d <= 0.f) ui[k] = j0 + jj;
        }
      }
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        if (fix[0][k]) bd[k] = SETTLED;
        if (fix[1][k]) ud[k] = SETTLED;
      }
    }
    __syncthreads();  // the table is no longer read
  }

  // the warps' answers, merged in warp order
#pragma unroll
  for (int k = 0; k < Q; ++k) {  // clamped: a settled best reads 0
    sm.u.m.d[0][warp][k * 32 + lane] = fmaxf(bd[k], 0.f);
    sm.u.m.i[0][warp][k * 32 + lane] = bi[k];
    if (SHARED_) {
      sm.u.m.d[1][warp][k * 32 + lane] = fmaxf(ud[k], 0.f);
      sm.u.m.i[1][warp][k * 32 + lane] = ui[k];
    }
  }
  __syncthreads();
  const int q = qt * TILE + tid;
  if (tid < TILE) {
#pragma unroll
    for (int s = 0; s < SETS; ++s) {
      float d = sm.u.m.d[s][0][tid];
      int i = sm.u.m.i[s][0][tid];
#pragma unroll
      for (int w = 1; w < WARPS; ++w)
        take_lower(sm.u.m.d[s][w][tid], sm.u.m.i[s][w][tid], d, i);
      if (C == 1) {
        if (q < N) {
          const size_t o = (size_t)b * N + q;
          (s ? P.d2 : P.d)[o] = d;
          (s ? P.i2 : P.i)[o] = i;
        }
      } else {
        sm.xd[s][tid] = d;
        sm.xi[s][tid] = i;
      }
    }
  }
  if (C == 1) return;

  // the cluster's blocks, merged in rank order through distributed shared
  // memory; block r writes the queries t with t % C == r
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (tid < TILE && tid % C == rank && q < N) {
    const size_t o = (size_t)b * N + q;
#pragma unroll
    for (int s = 0; s < SETS; ++s) {
      // every peer's pair loaded first (the remote loads overlap), then
      // merged in rank order
      float dr[MAX_CLUSTER];
      int ir[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) {
        if (r < C) {
          dr[r] = cluster.map_shared_rank(&sm.xd[s][0], r)[tid];
          ir[r] = cluster.map_shared_rank(&sm.xi[s][0], r)[tid];
        }
      }
      float d = dr[0];
      int i = ir[0];
#pragma unroll
      for (int r = 1; r < MAX_CLUSTER; ++r)
        if (r < C) take_lower(dr[r], ir[r], d, i);
      (s ? P.d2 : P.d)[o] = d;
      (s ? P.i2 : P.i)[o] = i;
    }
  }
  cluster.sync();  // every peer's shared memory stays until read
}

// grid (tiles x cluster), THREADS threads, clusters of tab.cluster blocks
// along x: block x works on tile x / cluster, reference slice x % cluster
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
nn_multi_kernel(const __grid_constant__ Table tab) {
  __shared__ Smem sm;
  const int C = tab.cluster;
  const int tile = blockIdx.x / C, rank = blockIdx.x % C;
  int k = 0;
  for (int j = 1; j < tab.n; ++j)
    if (tile >= tab.p[j].first) k = j;
  const Problem& P = tab.p[k];
  const int t = tile - P.first;
  if (threadIdx.x == 0) {
    mbar_init(&sm.bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  switch (P.p.kind) {
    case UNGROUPED:
      nn_block<UNGROUPED>(P.p, t / P.tiles, t % P.tiles, rank, C, sm);
      break;
    case SHARED:
      nn_block<SHARED>(P.p, t / P.tiles, t % P.tiles, rank, C, sm);
      break;
    default:
      nn_block<GROUPED>(P.p, t / P.tiles, t % P.tiles, rank, C, sm);
  }
}

// blocks of the kernel that fit on the card at once, read once
cudaError_t card_slots(int& slots) {
  static int cached = 0;
  if (cached == 0) {
    int dev, sms, per_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, nn_multi_kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    cached = sms * per_sm;
  }
  slots = cached;
  return cudaSuccess;
}

}  // namespace

// `n` problems (1..MAX_PROBLEMS) in one launch on `stream`. Returns a CUDA
// error code as an int (0 = launched; nothing is launched when no problem
// has a query).
extern "C" int nn_multi_launch(const NNProblem* problems, int n,
                               void* stream) {
  if (n <= 0 || n > MAX_PROBLEMS) return cudaErrorInvalidValue;
  // the problems with the most work per tile first, so that the longest
  // blocks start in the first wave (stable: insertion by weight)
  int order[MAX_PROBLEMS];
  auto weight = [&](int k) {
    const NNProblem& p = problems[k];
    return (long long)p.M * (p.kind == SHARED ? 12 : p.kind == GROUPED ? 9 : 8);
  };
  for (int k = 0; k < n; ++k) {
    int at = k;
    while (at > 0 && weight(order[at - 1]) < weight(k)) {
      order[at] = order[at - 1];
      --at;
    }
    order[at] = k;
  }
  Table tab = {};
  tab.n = n;
  long long tiles = 0;
  int max_m = 0;
  for (int j = 0; j < n; ++j) {
    const NNProblem& p = problems[order[j]];
    if (p.B < 0 || p.N < 0 || p.M < 0 || p.kind < GROUPED || p.kind > SHARED)
      return cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(p.y) & 15) ||
        (p.kind != UNGROUPED && (reinterpret_cast<uintptr_t>(p.rg) & 15)))
      return cudaErrorMisalignedAddress;
    tab.p[j].p = p;
    tab.p[j].tiles = (p.N + TILE - 1) / TILE;
    tab.p[j].first = static_cast<int>(tiles);
    tiles += (long long)p.B * tab.p[j].tiles;
    if (p.B > 0 && p.N > 0 && p.M > max_m) max_m = p.M;
  }
  if (tiles == 0) return 0;
  // enough cluster blocks that the grid fills the card WAVES times over,
  // while each block keeps a useful slice of the references
  int slots;
  const cudaError_t err = card_slots(slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long c = (WAVES * slots + tiles - 1) / tiles;
  if (c > MAX_CLUSTER) c = MAX_CLUSTER;
  if (c > max_m / MIN_REFS_PER_BLOCK) c = max_m / MIN_REFS_PER_BLOCK;
  if (c < 1) c = 1;
  if (tiles * c > 0x7fffffffLL) return cudaErrorInvalidValue;
  tab.cluster = static_cast<int>(c);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * c));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = tab.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = tab.cluster > 1 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, nn_multi_kernel, tab);
  return static_cast<int>(cudaGetLastError());
}
