// AOI interest and damping distance of every (query, cell) pair, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_aoi_kernel`
// (channeld_tpu/ops/pallas_kernels.py:109, launched by
// _aoi_masks_pallas_geom, pallas_call at :181). For each query and each
// cell of a contiguous block of global cell ids [cell_base,
// cell_base + cell_count):
//
//   sphere: distance from the query point to the cell rectangle <= radius
//   box:    |q - centre| <= half extent + half cell, on both axes
//   cone:   rectangle distance <= radius and (cos to the cell centre >=
//           cos(angle), or the cell holds the apex)
//
// masked to real cells (ids < cols*rows), and dist = ceil(centre
// distance / cell diagonal), 0 when the query point lies in the cell.
// Spots queries are overlaid afterwards by the wrapper, from the
// host-rasterized table, exactly as the JAX path does.
//
// What bound the first design on the H100: instruction issue. It gave
// each warp one query and walked the cells with the whole test per
// (query, cell) pair: an integer % and / by the runtime column count,
// two IEEE square roots, one IEEE division and ~40 further float
// operations, ~130 instructions a pair. At 1,024 queries x 65,536 cells
// that is ~8.7G lane-instructions, ~0.29 ms at 132 SMs x 128 lanes x
// ~1.75 GHz; it took 0.2805 ms alone (torch.profiler) against a byte
// bound of 0.10017 ms (5 B written per pair at 3.35 TB/s; NVIDIA H100
// 80GB HBM3, 700 W, chip_smoke.py).
//
// Design. The test is separable, exactly: the cell centre, the delta,
// its absolute value, the gap to the rectangle, both squares, the cone's
// product -delta*dir and the box test depend on the query and the
// cell's column only (x) or row only (z). So a pair needs only the sums
// gap_x^2 + gap_z^2, ddx^2 + ddz^2 and the cone's dot product, formed
// from per-axis terms that are bit-identical to the ones the full
// expression rounds (every product is rounded on its own, -fmad=false).
//
// - A block is 8 warps, one query each, so a query's kind is uniform
//   across its warp and the kind's branch never diverges. A block walks
//   one tile of consecutive cells; a warp's 32 lanes take 32 consecutive
//   cells, so its stores are contiguous (32 hit bytes, 128 dist bytes).
// - Each warp first writes its query's per-column terms (d2, g2, p, box)
//   for every column into shared memory (grids up to 1,024 columns; the
//   tile of >= 8 rows amortizes it), and keeps the current row's terms
//   in registers, recomputed when a lane's row changes. Wider grids
//   compute the column terms per pair instead (same bits).
// - A lane's column and row come from one division at the start and
//   then an add-and-wrap per step: no integer division per pair.
// - Kind gating: apex_cell (rect_dist <= 0) is rect_s <= 0 (a correctly
//   rounded root is 0 only at 0; NaN fails both). Sphere and cone test
//   rect_s <= T(radius), where T(r) is the largest float s with
//   sqrt_rn(s) <= r (sqrt_rn is monotone), found once per query: no
//   root for the rectangle distance. Only a cone pair inside the radius
//   and off the apex takes the IEEE division. dist keeps its one IEEE
//   root per pair.
//
// At 1,024 x 65,536 this design takes 0.1349 ms alone (CUDA events over
// bare launches, same card and power limit) against a write floor of
// 0.1066 ms (fill_ of both outputs): what is left is mostly the stores.
// A second kernel with four cells a lane and 16-byte stores took 0.1203
// ms there, and was not kept: it paid only on wide grids whose columns
// and cell blocks are multiples of four, and no configured deployment
// runs a wide grid (config/ holds 15x15 and 4x4 grids).
//
// Numerics match the plain torch version (and so the reference) bit
// for bit: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn; the build also passes -fmad=false), but for the cell centre
// under `fused_centre` (one __fmaf_rn, as the plain version's fma_f32),
// the cone's division
// and the root are IEEE (__fdiv_rn, __fsqrt_rn), the division by the
// cell diagonal is a multiplication by its float32 reciprocal (as XLA
// compiles the reference's division by a constant), NaN propagates
// through the max(., 0) steps as torch.maximum does, and the
// float->int conversion is __float2int_rz (NaN -> 0, saturating), XLA's
// conversion. cos(angle) arrives precomputed per query from the
// wrapper, so the kernel and the plain version compare against the same
// threshold.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kQueriesPerBlock = 8;  // one warp per query
constexpr int kMaxTableColumns = 1024;
constexpr int kMinTile = 4096;  // cells per block, at least 8 rows of the table

constexpr int kSphere = 1;
constexpr int kBox = 2;
constexpr int kCone = 3;

// max(x, 0) that keeps a NaN, like torch.maximum and jnp.maximum
// (fmaxf would return 0 for a NaN).
__device__ __forceinline__ float relu_keep_nan(float x) {
    return x < 0.0f ? 0.0f : x;
}

// One query's terms against one cell column (or row) `index`:
// x = delta^2, y = gap^2, z = -delta * dir, w = box test as int bits.
// The centre (index + 0.5) * size + offset is rounded once when `fused`
// (the cells serving plane, whose JAX counterpart XLA:CPU contracts
// into an FMA), else the product before the sum.
__device__ __forceinline__ float4 axis_terms(int index, float size, float offset,
                                             float half, float qc, float dir,
                                             float reach, bool fused) {
    const float mid = __fadd_rn(static_cast<float>(index), 0.5f);
    const float centre =
        fused ? __fmaf_rn(mid, size, offset) : __fadd_rn(__fmul_rn(mid, size), offset);
    const float dd = __fsub_rn(qc, centre);
    const float d = fabsf(dd);
    const float gap = relu_keep_nan(__fsub_rn(d, half));
    return make_float4(__fmul_rn(dd, dd), __fmul_rn(gap, gap), __fmul_rn(-dd, dir),
                       __int_as_float(d <= reach ? 1 : 0));
}

// Largest float s with sqrt_rn(s) <= r, so that for every s >= 0 and
// every NaN s, (sqrt_rn(s) <= r) == (s <= sqrt_threshold(r)). NaN r
// gives NaN (nothing passes), r < 0 gives -1 (nothing passes).
// Mirrored by cuda_kernels.sqrt_threshold.
__device__ float sqrt_threshold(float r) {
    if (isnan(r) || (isinf(r) && r > 0.0f)) return r;
    if (r < 0.0f) return -1.0f;
    float t = __fmul_rn(r, r);  // within an ulp or two of the answer
    while (t > 0.0f && __fsqrt_rn(t) > r) t = __int_as_float(__float_as_int(t) - 1);
    for (;;) {
        const float up = __int_as_float(__float_as_int(t) + 1);
        if (!(__fsqrt_rn(up) <= r)) return t;  // up = inf fails: r is finite
        t = up;
    }
}

// One query, as every lane of its warp holds it.
struct Query {
    int kind;
    float qx, qz, dir_x, dir_z, cos_a;
    float reach_x, reach_z;  // extent + half cell, the box test's bound
    float limit;             // sqrt_threshold(radius), for sphere and cone
};

__device__ __forceinline__ Query load_query(const int32_t* __restrict__ kind,
                                            const float* __restrict__ center,
                                            const float* __restrict__ extent,
                                            const float* __restrict__ direction,
                                            const float* __restrict__ cos_angle, int q,
                                            float half_w, float half_h) {
    Query r;
    r.kind = kind[q];
    r.qx = center[2 * q];
    r.qz = center[2 * q + 1];
    r.dir_x = direction[2 * q];
    r.dir_z = direction[2 * q + 1];
    r.cos_a = cos_angle[q];
    const float ex = extent[2 * q];
    r.reach_x = __fadd_rn(ex, half_w);
    r.reach_z = __fadd_rn(extent[2 * q + 1], half_h);
    r.limit = (r.kind == kSphere || r.kind == kCone) ? sqrt_threshold(ex) : 0.0f;
    return r;
}

// The pair (column terms cx, row terms rz): hit before the real-cell
// mask, and dist.
__device__ __forceinline__ bool pair(const Query& q, float inv_diagonal, float4 cx,
                                     float4 rz, int* dist) {
    const float rect_s = __fadd_rn(cx.y, rz.y);
    const float center_dist = __fsqrt_rn(__fadd_rn(cx.x, rz.x));
    const bool apex_cell = rect_s <= 0.0f;
    bool h = false;
    if (q.kind == kSphere) {
        h = rect_s <= q.limit;
    } else if (q.kind == kBox) {
        h = (__float_as_int(cx.w) & __float_as_int(rz.w)) != 0;
    } else if (q.kind == kCone && rect_s <= q.limit) {
        // to_len = max(center_dist, 1e-9), keeping a NaN.
        const float to_len = center_dist < 1e-9f ? 1e-9f : center_dist;
        h = apex_cell || __fdiv_rn(__fadd_rn(cx.z, rz.z), to_len) >= q.cos_a;
    }
    *dist = apex_cell ? 0 : __float2int_rz(ceilf(__fmul_rn(center_dist, inv_diagonal)));
    return h;
}

// One cell per lane per step; the column terms from a float4 table in
// shared memory (kColumnTable) or computed per pair.
template <bool kColumnTable>
__global__ void __launch_bounds__(kWarp * kQueriesPerBlock)
aoi_kernel(const int32_t* __restrict__ kind, const float* __restrict__ center,
           const float* __restrict__ extent, const float* __restrict__ direction,
           const float* __restrict__ cos_angle, int num_queries, SpatialGrid g,
           float inv_diagonal, int cell_base, int cell_count, int tile, bool fused,
           uint8_t* __restrict__ hit, int32_t* __restrict__ dist) {
    extern __shared__ float4 column_terms[];  // [kQueriesPerBlock][cols]
    const int lane = threadIdx.x;
    const int q = blockIdx.x * kQueriesPerBlock + threadIdx.y;
    if (q >= num_queries) return;  // a whole warp; nothing below syncs the block
    const float half_w = g.cell_w * 0.5f;
    const float half_h = g.cell_h * 0.5f;
    const Query qy = load_query(kind, center, extent, direction, cos_angle, q, half_w, half_h);

    float4* columns = column_terms + threadIdx.y * g.cols;
    if (kColumnTable) {
        for (int c = lane; c < g.cols; c += kWarp)
            columns[c] = axis_terms(c, g.cell_w, g.offset_x, half_w, qy.qx, qy.dir_x,
                                    qy.reach_x, fused);
        __syncwarp();
    }

    const int begin = blockIdx.y * tile;
    const int end = static_cast<int>(min(static_cast<long long>(begin) + tile,
                                         static_cast<long long>(cell_count)));
    const int real_end = g.cols * g.rows - cell_base;  // block offsets past it are padding
    const size_t out_row = static_cast<size_t>(q) * cell_count;
    const int first = cell_base + begin + lane;
    int col = first % g.cols;  // the one division of this lane
    int row = first / g.cols;
    const int step_col = kWarp % g.cols;
    const int step_row = kWarp / g.cols;
    int row_now = -1;
    float4 rz = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

    for (int j = begin + lane; j < end; j += kWarp) {
        if (row != row_now) {
            rz = axis_terms(row, g.cell_h, g.offset_z, half_h, qy.qz, qy.dir_z, qy.reach_z,
                            fused);
            row_now = row;
        }
        const float4 cx = kColumnTable
            ? columns[col]
            : axis_terms(col, g.cell_w, g.offset_x, half_w, qy.qx, qy.dir_x, qy.reach_x,
                         fused);
        int d;
        const bool h = pair(qy, inv_diagonal, cx, rz, &d);
        hit[out_row + j] = (h && j < real_end) ? 1 : 0;
        dist[out_row + j] = d;
        col += step_col;
        row += step_row;
        if (col >= g.cols) {
            col -= g.cols;
            ++row;
        }
    }
}

}  // namespace

// Query SoA (kind i32[q], center/extent/direction f32[q,2], cos_angle
// f32[q]) -> hit u8[q, cell_count], dist i32[q, cell_count] for the
// global cell ids [cell_base, cell_base + cell_count), on device
// `device` and `stream`; `fused_centre` != 0 rounds each cell centre
// once (see axis_terms). Returns the launch's cudaError_t (0 = launched).
extern "C" int chtpu_aoi(const int32_t* kind, const float* center,
                         const float* extent, const float* direction,
                         const float* cos_angle, int num_queries, float offset_x,
                         float offset_z, float cell_w, float cell_h,
                         float inv_cell_w, float inv_cell_h, int cols, int rows,
                         float inv_diagonal, int cell_base, int cell_count,
                         int fused_centre, uint8_t* hit, int32_t* dist, int device,
                         void* stream) {
    if (num_queries <= 0 || cell_count <= 0) return 0;
    const DeviceGuard guard(device);
    if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
    const SpatialGrid g{offset_x, offset_z, cell_w, cell_h, inv_cell_w, inv_cell_h,
                        cols, rows};
    // Tiles of whole warp steps, at least 8 rows long where the column
    // table is built, and few enough for grid.y.
    const bool table = cols <= kMaxTableColumns;
    long long tile = (table && 8LL * cols > kMinTile) ? 8LL * cols : kMinTile;
    const long long fit = (static_cast<long long>(cell_count) + 65534) / 65535;
    if (tile < fit) tile = fit;
    tile = (tile + kWarp - 1) / kWarp * kWarp;
    const dim3 block(kWarp, kQueriesPerBlock);
    const dim3 grid((num_queries + kQueriesPerBlock - 1) / kQueriesPerBlock,
                    static_cast<unsigned>((cell_count + tile - 1) / tile));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (table) {
        const size_t smem = sizeof(float4) * kQueriesPerBlock * static_cast<size_t>(cols);
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(
                aoi_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        aoi_kernel<true><<<grid, block, smem, s>>>(
            kind, center, extent, direction, cos_angle, num_queries, g, inv_diagonal,
            cell_base, cell_count, static_cast<int>(tile), fused_centre != 0, hit, dist);
    } else {
        aoi_kernel<false><<<grid, block, 0, s>>>(
            kind, center, extent, direction, cos_angle, num_queries, g, inv_diagonal,
            cell_base, cell_count, static_cast<int>(tile), fused_centre != 0, hit, dist);
    }
    return static_cast<int>(cudaGetLastError());
}
