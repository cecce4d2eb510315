// stencil_chain.cu — fused n-field stencil + reaction + noise chain for
// Hopper (sm_90a): the template of the generated kernel.
//
// Replaces the Pallas TPU kernel grayscott_jl_tpu/ops/pallas_stencil.py
// (_make_kernel, launched by _fused_call through pl.pallas_call) as the
// reference's generator (grayscott_jl_tpu/ops/kernelgen.py) instantiates
// it for any registered model, in its float32, float64 and bfloat16
// postures (_compute_dtype, _mid_store_dtype). This file is not compiled
// on its own: ops/kernelgen.py emits, per model, the field and parameter
// counts and the model's reaction as a device function, ops/_build.py
// writes them where the marker line below stands and compiles the result
// (one library per model). One launch advances every cell of the block
// `fuse` explicit-Euler steps. A template argument selects the mode:
//   * kBlock  — faces=None: compute1 (fuse = 1) and compute_k
//               (fuse = k >= 2) on a whole grid with a frozen ghost
//               shell (rows 1a, 1b of PERF.md's kernel table);
//   * kFaces6 — compute1 with 6n faces: one step of a block of a
//               3D-sharded grid whose ghost planes are the neighbours'
//               faces (row 1c);
//   * kXChain — compute_k with 2n faces: k steps across an x shard
//               boundary from k-deep x slabs, pinned on GLOBAL
//               coordinates (row 1d); the same mode on the y-extended
//               operand of parallel/temporal.py xy_chain is row 1e.
// The three production modes take a member axis (the reference's
// ensemble vmap of _fused_call, grayscott_jl_tpu/ensemble/engine.py):
// blockIdx.y is the member, so one launch advances N stacked members
// (N, nx, ny, nz), each with its own params row and key pair; the tiles
// stay on blockIdx.x. A CTA holds one member's window, so the shared-
// memory ledger does not change; a batched TMA load reads a 4-D tensor
// map (z, y, x, member) with a box one member deep, so that a window
// past an x edge of member k is zero-filled and taken by the ghost pass,
// never read from member k - 1's planes. A solo launch (N = 1) keeps the
// 3-D map and its host key words.
// Three types parametrize the kernel (row 1f), as the reference separates
// them: T, the storage type of the fields and faces (float, double or
// __nv_bfloat16); C = Compute<T>, the type every operation runs in
// (float for bf16, else T); M, the type of the chain's mid-stage windows
// in shared memory (T, or bf16 for float fields under GS_MID_BF16=1).
//
// What bounds it: device-memory bytes. A step reads and writes every
// field, 8 B/cell/field for float (16 for double, 4 for bf16), against
// ~10 floating-point operations per field plus the reaction's program
// and one 32-bit hash per cell. The design answer is temporal blocking in
// shared memory: each block loads its tile plus a `fuse`-cell halo
// once, advances it `fuse` steps on-chip, and writes the interior once,
// so the bytes per step fall ~1/fuse while the halo is recomputed (the
// window shrinks one cell per side in x, y and z per stage). The face
// modes add only the face bytes, read once where the window crosses
// the block's edge. bf16 storage halves the bytes; the arithmetic stays
// float.
//
// Design, per block of NTHREADS threads:
//   * the block owns an interior tile of TX x TY x TZ cells (z is the
//     contiguous axis); stage 0 loads the tile plus `fuse` halo cells
//     per side of every field into shared memory, at z stride WZP (the
//     window's z extent rounded up to 16 B). The window is one TMA box
//     per field (cp.async.bulk.tensor.3d, issued by one thread and
//     completed on an mbarrier) from the window origin — which may be
//     negative — moved up in z to the next 16 B boundary (a box whose z
//     start is not 16 B aligned faults on the card); TMA fills the cells
//     outside the operand with zeros. An operand TMA refuses (a row of
//     nz cells, or a base address, not 16 B aligned) loads the same
//     padded window by cp.async over a flat index. The shape picks the
//     path at launch; neither falls back to the other. Then a ghost pass
//     writes the first `lead` cells of each row (below the box: at most
//     3 a row for float32) and the window cells outside the operand, by
//     mode: the field's frozen boundary value (kBlock; the reference's
//     pad_with_boundary); the face of the one axis it lies across
//     (kFaces6; edge and corner ghosts are never read by the 7-point
//     stencil and hold the boundary value); the lo/hi x slab for x in
//     [-k, 0) and [nx, nx + k)
//     (kXChain; beyond the operand's own y and z extent it reads the
//     boundary value, as the reference's _xla_xchain_fallback re-pads y
//     and z each stage). It runs after the mbarrier wait: two writes of
//     one cell, one of them asynchronous, would race;
//   * stage s computes step step0 + s on the window shrunk by s + 1
//     cells per side, reading one window and writing the next. kBlock and
//     kFaces6 compute the block's cells and pin every other cell to the
//     boundary value. kXChain computes every cell of the operand's y/z
//     extent, so an interior shard recomputes its neighbour's ring, and
//     pins a mid-stage cell only when its GLOBAL coordinate (offset +
//     local) falls outside [0, row) on any axis. Values are widened to C
//     when read and rounded once to the window's type when written, so
//     with M == T each stage equals one single step bit for bit;
//   * the last stage writes the tile's block cells to global memory,
//     unpinned (pad cells of a non-divisible grid are re-pinned by the
//     caller, as in the reference).
// Blocks are independent and use no atomics: results are deterministic.
//
// The march (stencil_chain_kernel_march; PERF.md's rows 1a, 1f.1, 1g):
// kBlock at fuse 1 on the TMA load path runs another schedule of the
// same step. At depth 1 the window above loads 1.76x the tile's bytes,
// runs its ghost pass on every tile (the `lead` cells), and each block
// loads, waits, then computes. The march gives a block one member's
// (y, z) column of kMarchTY rows by kMarchZB bytes of z and walks `span`
// consecutive x-planes of it. A producer warp keeps a ring of kRing
// plane slots filled by TMA, one box per field per plane: the column
// plus a one-row y halo and a z halo of 16 B a side, so the box starts on
// a 16 B boundary and no lead cells remain; each slot has a full and an
// empty mbarrier, and the producer refills a slot once the consumer warps
// release it, so the loads of the next planes run under the compute of
// this one. Plane x is computed from the slots of x - 1, x and x + 1;
// each x-plane is loaded once and serves three output planes. A thread
// owns 16 B of z of one row (one vector load and store a field) and
// keeps its x - 1, x and x + 1 centre values in registers. Neighbours
// outside the operand take the frozen boundary value, as the window's
// ghost pass stores it: planes outside in x are never loaded, and the
// y/z ghosts are replaced in registers only in columns that touch an
// edge. The cell's position hash (cell_hash) does not depend on x or the
// step, so each thread draws it once for the march, and a cell-step
// draws one hash32; a plane's seed is drawn by one lane for 32 planes
// and shuffled. The same lap7 order, reaction and rounding as the window
// kernel: the two are equal bit for bit. `span` is a function of the
// shape (march_span). The ring holds 78,976 B for two float fields.
//
// The envelope probes (built only into Gray-Scott's second library,
// under GS_ENVELOPE_PROBES; see the entry points at the end) replace
// the two measurement kernels of benchmarks/envelope_probe.py, and
// take apart THIS kernel, not the TPU's slab walk, so they are modes of
// this template and replay its window load and stage function:
//   * kCopyWalk (dma_walk, envelope_probe.py:164): the stage-0 window
//     load exactly as kBlock runs it at depth `fuse` (the same load
//     path), then the tile's interior from shared memory to the
//     output — no arithmetic, the identity on every field, the
//     production footprint (so the production occupancy);
//   * kComputeWalk (compute_walk, envelope_probe.py:400): every block
//     loads the window of tile (0,0,0), so device memory serves about
//     one window and L2 the rest, then runs the production stage chain
//     on it with its OWN block coordinates for pins and noise keys, and
//     writes its last stage into the free shared window (every block
//     stores, so no block's chain can be sunk into a branch); only
//     block (0,0,0) copies that tile out. Its defined output, tile
//     (0,0,0), equals the production chain's tile (0,0,0) bitwise; the
//     rest is left unwritten. VARIANT selects the probe's variants
//     (envelope_probe.py:452-465), each changing what its JAX namesake
//     changes: no noise; no pins in mid stages (noselect); the y/z
//     neighbours read as the centre, pins dropped too (noyz: the JAX
//     case sets selects=False and rolls=False); the dt-folded
//     coefficient form (fma: dt folding, not hardware FMA — still one
//     rounding per operation); one multiply per field per stage with
//     the same window reads and stores (minimal); every stage from the
//     resident input window at the tile's cells into register
//     accumulators, one final store (nomid: without mid windows nothing
//     reads the halo ring, so the ring is not recomputed; the loop runs
//     cell-major, each cell's stages in order, so the accumulators stay
//     two registers).
//
// Shared memory, per field: with M == T two ping-pong windows of T —
// 228,872 B for two float fields at fuse = 5, 221,704 B for two bf16
// fields at fuse = 8, the mbarrier included; with M != T one input
// window of T plus the mid windows of M the chain needs (none at fuse 1,
// one at 2, two deeper), every window at the padded stride. Above the
// 48 KB static limit, so it is dynamic shared memory enabled per launch
// with cudaFuncSetAttribute. The Python ledger (ops/cuda_stencil.py,
// smem_bytes / max_feasible_fuse) caps fuse from the same arithmetic;
// the face modes use the same window.
//
// Numerics: every sum, difference, product and quotient is an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, ...), the
// generated reaction uses the same helpers, and the file is built with
// --fmad=false, so the kernel performs the same IEEE operations, in the
// same order, as the plain torch version (ops/stencil.py, the model's
// reaction; for bf16 and bf16 mids its oracle form in
// ops/cuda_stencil.py: widen, compute in float, round once per stage)
// and equals it bitwise. The noise is the position-keyed
// lowbias32 stream of ops/noise.py, evaluated per cell at its global
// coordinate and absolute step (a negative coordinate wraps as uint32,
// as in the torch version), so halo cells recomputed by a neighbouring
// block or shard draw the owner's bits; its unit is drawn in float and
// scaled in C, as the reference kernel draws it in its compute dtype.

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int TX = 8;
constexpr int TY = 8;
constexpr int TZ = 32;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

enum Mode { kBlock = 0, kFaces6 = 1, kXChain = 2, kCopyWalk = 3, kComputeWalk = 4 };

// The mbarrier of the TMA load, after the windows.
constexpr int kBarrierBytes = 8;

// kComputeWalk's variants, in the order of ops/envelope.py VARIANTS.
enum Variant {
  kChain = 0,
  kNoNoise = 1,
  kNoSelect = 2,
  kNoYZ = 3,
  kFma = 4,
  kMinimal = 5,
  kNoMid = 6
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// Storage type -> compute type: bf16 fields compute in float.
template <typename T>
struct Compute {
  using type = T;
};
template <>
struct Compute<__nv_bfloat16> {
  using type = float;
};

// A stored value in its compute type (exact).
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }

// Store a compute value at *p: bf16 rounds once, to nearest even.
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(double* p, double v) { *p = v; }

// torch.maximum / torch.minimum: a NaN operand wins.
template <typename T>
__device__ __forceinline__ T nan_or(T a, T b, T m) {
  return a != a ? a : (b != b ? b : m);
}

__host__ __device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A window at depth `fuse` for a storage type of `itemsize` bytes (the
// Python ledger's cuda_stencil.window_geometry): WX x WY x WZ cells,
// stored at z stride WZP (WZ rounded up until a row is a multiple of
// 16 B, as TMA requires of a box's inner dimension). TMA also requires a
// box to start at a z coordinate whose byte offset is a multiple of
// 16 B, and the window starts `lead` cells before one (the window's z
// origin z0 - fuse, with z0 a multiple of TZ): the box starts `lead`
// cells into each row, and the first `lead` cells of each row are
// loaded apart. A field's slot of `wvol` elements holds one 128 B lead
// zone (row 0's first cells sit at its end, so that the box's shared
// destination is 128 B aligned, as TMA requires) and the box, rounded
// up to 128 B; the window's cell 0 is at element `base` of the slot.
struct Window {
  int WX, WY, WZ, WZP, lead, wvol, base;
};

__host__ __device__ __forceinline__ Window window_of(int itemsize,
                                                     int fuse) {
  Window w;
  w.WX = TX + 2 * fuse;
  w.WY = TY + 2 * fuse;
  w.WZ = TZ + 2 * fuse;
  const int zq = 16 / itemsize, vq = 128 / itemsize;
  w.WZP = (w.WZ + zq - 1) / zq * zq;
  w.lead = fuse % zq;
  w.wvol = vq + (w.WX * w.WY * w.WZP + vq - 1) / vq * vq;
  w.base = vq - w.lead;
  return w;
}

// The asynchronous copies: TMA tensor tiles completing on an mbarrier,
// and cp.async for the operands TMA refuses.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3D tensor map at (z, y, x) (innermost first) into
// `dst`, its bytes counted on `bar`; tma_load_4d adds the member
// coordinate of a batched launch's 4-D map.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int z, int y, int x,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(z), "r"(y), "r"(x),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int z, int y, int x, int m,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(z), "r"(y), "r"(x), "r"(m),
      "r"(smem_addr(bar))
      : "memory");
}

// One cell by cp.async (4 or 8 B), zero-filled when `full` is false;
// 2-byte cells by a plain load (cp.async moves 4 B at least).
template <typename T>
__device__ __forceinline__ void copy_or_zero(T* dst, const T* src,
                                             bool full) {
  if constexpr (sizeof(T) >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"((int)sizeof(T)),
                 "r"(full ? (int)sizeof(T) : 0)
                 : "memory");
  } else {
    *dst = full ? __ldg(src) : __ushort_as_bfloat16((unsigned short)0);
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The generated part: kNF (fields), kNP (params), kDt and kNoise (their
// indices in the params vector) and
//   __device__ void gs_reaction(const T* f, const T* lap, T noise,
//                               const T* p, T* d)
// for T = float and double, the model's reaction in its trace order.
// @generated-reaction@

// Per-field operands: input and output pointers and the frozen boundary
// value (in the compute type C).
template <typename T, typename C>
struct Fields {
  const T* in[kNF];
  T* out[kNF];
  C bound[kNF];
};

// Face operands in the reference's order: axis-major, then field-major,
// then lo/hi. kFaces6 — for axis a, field i: p[2 kNF a + 2 i] (lo) and
// p[2 kNF a + 2 i + 1] (hi), shaped (1,ny,nz), (nx,1,nz), (nx,ny,1);
// kXChain — p[2 i], p[2 i + 1], each (fuse, ny, nz).
template <typename T>
struct Faces {
  const T* p[6 * kNF];
};

// One TMA tensor map per field input: dims (nz, ny, nx), box (WZP, WY,
// WX), encoded on the host (gs_window_map) and passed by value as a
// __grid_constant__ parameter; for a batched launch dims (nz, ny, nx, N)
// and box (WZP, WY, WX, 1) (gs_window_map4).
struct WindowMaps {
  CUtensorMap m[kNF];
};

// Bytes of every window of one block: with M == T `n_win` windows of T
// per field (two ping-pong windows; one where nothing is written back to
// shared memory: fuse 1), else one input window
// of T plus the mid windows of M the chain needs (none at fuse 1, one at
// 2, two deeper).
template <typename T, typename M>
__host__ __device__ __forceinline__ size_t window_bytes(int fuse,
                                                        int n_win) {
  const Window w = window_of((int)sizeof(T), fuse);
  if (std::is_same<T, M>::value) {
    return (size_t)n_win * kNF * w.wvol * sizeof(T);
  }
  const int n_mid = fuse - 1 < 2 ? fuse - 1 : 2;
  return (size_t)kNF * w.wvol * (sizeof(T) + n_mid * sizeof(M));
}

// The windows a launch needs: the second window of a fuse-1 launch holds
// the compute walk's last stage, else it is never touched.
__host__ __device__ __forceinline__ int windows_needed(int mode, int fuse) {
  return fuse == 1 && mode != kComputeWalk ? 1 : 2;
}

// lowbias32 (ops/noise.py hash32); uint32 arithmetic wraps mod 2**32.
__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t plane_seed(uint32_t k0, uint32_t k1,
                                               uint32_t step, uint32_t gx) {
  return hash32(hash32(hash32(k0) ^ k1) ^ hash32(hash32(step) ^ gx));
}

__device__ __forceinline__ uint32_t cell_hash(uint32_t iy, uint32_t iz,
                                              uint32_t row) {
  return hash32(iy * row + iz);
}

// bits -> uniform [-1, 1) in float, as ops/noise.py bits_to_pm1.
__device__ __forceinline__ float bits_to_pm1(uint32_t bits) {
  const float f12 = __uint_as_float(0x3F800000u | (bits >> 9));
  return __fsub_rn(__fmul_rn(f12, 2.0f), 3.0f);
}

// (x-1, x+1, y-1, y+1, z-1, z+1) summed left to right, then * (1/6) - c:
// ops/stencil.py laplacian, in C over a window of S.
template <typename C, typename S>
__device__ __forceinline__ C lap7(const S* w, int c, int sx, int sy, C inv6) {
  const C total =
      add(add(add(add(add(widen(w[c - sx]), widen(w[c + sx])), widen(w[c - sy])),
                  widen(w[c + sy])),
              widen(w[c - 1])),
          widen(w[c + 1]));
  return sub(mul(total, inv6), widen(w[c]));
}

// lap7's neighbour sum alone; with YZ false the four y/z neighbours
// read the centre, as the noyz probe's rolls=False returns c.
template <bool YZ, typename C, typename S>
__device__ __forceinline__ C nsum6(const S* w, int c, int sx, int sy) {
  const C ctr = widen(w[c]);
  const C ym = YZ ? widen(w[c - sy]) : ctr, yp = YZ ? widen(w[c + sy]) : ctr;
  const C zm = YZ ? widen(w[c - 1]) : ctr, zp = YZ ? widen(w[c + 1]) : ctr;
  return add(add(add(add(add(widen(w[c - sx]), widen(w[c + sx])), ym), yp), zm),
             zp);
}

__device__ __forceinline__ bool outside(int g, int row) {
  return g < 0 || g >= row;
}

// A minimum of 2 resident blocks per SM: with it ptxas emits another
// schedule (56 registers for the float32 chain, 64 without), 2-20 %
// faster on an H100 than with no minimum in every case
// probes/kernel_ab.py times (chain, 6n faces and x-chain at depth 1 and
// 2, float32 and bf16, the copy walk), and faster than a minimum of 3
// or 4 in all of them but the bf16 6n-face step (PERF.md).
template <typename T, typename M, int MODE, int VARIANT = kChain>
__global__ void __launch_bounds__(NTHREADS, 2)
stencil_chain_kernel(const Fields<T, typename Compute<T>::type> fs,
                     const typename Compute<T>::type* __restrict__ params,
                     const Faces<T> faces, const __grid_constant__ WindowMaps maps,
                     int tma, uint32_t k0, uint32_t k1,
                     const uint32_t* __restrict__ keys,
                     uint32_t step0, int ox, int oy, int oz, uint32_t row,
                     int nx, int ny, int nz, int fuse, int use_noise) {
  using C = typename Compute<T>::type;
  // The member of a batched launch: its fields and faces lie one member
  // volume further, its params row and key pair are its own. tma is 0
  // (cp.async), 1 (3-D map) or 2 (4-D map of a batched launch).
  const int m = blockIdx.y;
  const size_t mvol = (size_t)m * nx * ny * nz;
  const size_t fox = (size_t)m * (MODE == kXChain ? fuse : 1) * ny * nz;
  const size_t foy = (size_t)m * nx * nz, foz = (size_t)m * nx * ny;
  if (keys != nullptr) {
    k0 = keys[2 * m];
    k1 = keys[2 * m + 1];
  }
  params += (size_t)m * kNP;
  // An input window of T apart from the mid windows of M, or (M == T)
  // two ping-pong windows, the input in the first.
  constexpr bool kSplit = !std::is_same<T, M>::value;
  constexpr bool kProbe = MODE == kCopyWalk || MODE == kComputeWalk;
  static_assert(!(kProbe && kSplit), "the probes use one window type");
  static_assert(VARIANT == kChain || MODE == kComputeWalk,
                "variants are the compute walk's");
  // What the compute walk's variants keep of the production stage.
  constexpr bool kPins =
      VARIANT != kNoSelect && VARIANT != kNoYZ && VARIANT != kMinimal;
  constexpr bool kNoiseTerm = VARIANT != kNoNoise && VARIANT != kMinimal;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int h = fuse;
  const Window g = window_of(sizeof(T), fuse);
  const int WX = g.WX, WY = g.WY, WZ = g.WZ, WZP = g.WZP, wvol = g.wvol;
  const int sx = WY * WZP, sy = WZP;
  const int irow = (int)row;
  // Window b of field f starts at mids + (b * kNF + f) * wvol; the input
  // window of field f at in + f * wvol (in == mids when M == T); each
  // `base` elements into its slot. The mbarrier of the TMA load follows
  // the windows. With TMA the first `lead` cells of each row are the
  // ghost pass's.
  T* in = reinterpret_cast<T*>(smem_raw) + g.base;
  M* mids = reinterpret_cast<M*>(
      smem_raw + (kSplit ? (size_t)kNF * wvol * sizeof(T) : 0)) + g.base;
  const int lead = tma ? g.lead : 0;
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem_raw + window_bytes<T, M>(fuse, windows_needed(MODE, fuse)));

  C p[kNP];
#pragma unroll
  for (int i = 0; i < kNP; ++i) p[i] = MODE == kCopyWalk ? C(0) : params[i];
  const C inv6 = C(1.0 / 6.0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // The fma and minimal probes' coefficients, once per launch
  // (envelope_probe.py:264-270; Gray-Scott's params Du, Dv, F, k).
  C au = C(0), bu = C(0), cu = C(0), av = C(0), bv2 = C(0), noise_dt = C(0);
  if constexpr (VARIANT == kFma || VARIANT == kMinimal) {
    au = sub(C(1), mul(p[kDt], add(p[0], p[2])));
    bu = mul(mul(p[kDt], p[0]), inv6);
    cu = mul(p[kDt], p[2]);
    av = sub(C(1), mul(p[kDt], add(add(p[1], p[2]), p[3])));
    bv2 = mul(mul(p[kDt], p[1]), inv6);
    noise_dt = mul(p[kNoise], p[kDt]);
  }

  // This block's tile (tiles are numbered z fastest, then y, then x;
  // the grid is 1-D), its window origin in block coordinates (may be
  // negative), and the origin of the window it loads: its own, or for
  // the compute walk tile (0,0,0)'s in every block.
  const int tiles_z = (nz + TZ - 1) / TZ, tiles_y = (ny + TY - 1) / TY;
  const int t = blockIdx.x;
  const int z0 = (t % tiles_z) * TZ - h;
  const int y0 = (t / tiles_z) % tiles_y * TY - h;
  const int x0 = t / (tiles_z * tiles_y) * TX - h;
  const bool walk = MODE == kComputeWalk;
  const int lx0 = walk ? -h : x0, ly0 = walk ? -h : y0, lz0 = walk ? -h : z0;

  // Stage 0 input: the full window of every field at z stride WZP.
  if (tma) {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      mbar_fence_init();
    }
    __syncthreads();
    // One thread: every field's box (WZP, WY, WX) at the window origin
    // moved `lead` cells up in z (a 16 B boundary), completed on the
    // mbarrier; TMA fills the cells outside the operand with zeros.
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, (uint32_t)(kNF * WX * WY * WZP * sizeof(T)));
#pragma unroll
      for (int f = 0; f < kNF; ++f) {
        if (tma == 2) {
          tma_load_4d(in + f * wvol + lead, &maps.m[f], lz0 + lead, ly0, lx0,
                      m, bar);
        } else {
          tma_load_3d(in + f * wvol + lead, &maps.m[f], lz0 + lead, ly0, lx0,
                      bar);
        }
      }
    }
    mbar_wait(bar, 0u);
  } else {
    // An operand TMA refuses (a row or base address not 16 B aligned):
    // the same padded window by cp.async over a flat index (cells
    // outside the operand zero-filled, as TMA fills them); 2-byte types
    // are copied by plain loads (cp.async moves 4 B at least).
    const int n = WX * WY * WZ;
    for (int j = threadIdx.x; j < n; j += NTHREADS) {
      const int wz = j % WZ, r = j / WZ;
      const int wy = r % WY, wx = r / WY;
      const int gx = lx0 + wx, gy = ly0 + wy, gz = lz0 + wz;
      const bool inside = gx >= 0 && gx < nx && gy >= 0 && gy < ny &&
                          gz >= 0 && gz < nz;
      const size_t off = inside ? ((size_t)gx * ny + gy) * nz + gz : 0;
      const int c = (wx * WY + wy) * WZP + wz;
#pragma unroll
      for (int f = 0; f < kNF; ++f) {
        copy_or_zero(&in[f * wvol + c], fs.in[f] + mvol + off, inside);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // The ghost pass: the window cells outside the operand, by mode, and
  // the first `lead` cells of each row (outside the TMA box: loaded, or
  // by mode where outside the operand). With no lead an interior tile
  // skips it. Face pointers are picked with constant indices (the
  // field loop is unrolled): a computed index into the parameter
  // struct would copy it to local memory in every thread.
  const int ix0 = clampi(-lx0, 0, WX), ix1 = clampi(nx - lx0, 0, WX);
  const int iy0 = clampi(-ly0, 0, WY), iy1 = clampi(ny - ly0, 0, WY);
  const int iz0 = clampi(-lz0, 0, WZ), iz1 = clampi(nz - lz0, 0, WZ);
  if (lead > 0 || !(ix0 == 0 && ix1 == WX && iy0 == 0 && iy1 == WY &&
                    iz0 == 0 && iz1 == WZ)) {
    // The lead slab (z below `lead`, every row), then the outside of
    // the inside box above it as six boxes: x below and above it;
    // within its x, y below and above; within its x and y, z below and
    // above.
    for (int b = 0; b < 7; ++b) {
      int bx0 = ix0, bx1 = ix1, by0 = 0, by1 = WY, bz0 = lead, bz1 = WZ;
      if (b == 0) bx0 = 0, bx1 = WX, bz0 = 0, bz1 = lead;
      if (b == 1) bx0 = 0, bx1 = ix0;
      if (b == 2) bx0 = ix1, bx1 = WX;
      if (b == 3) by1 = iy0;
      if (b == 4) by0 = iy1;
      if (b >= 5) by0 = iy0, by1 = iy1;
      if (b == 5) bz1 = iz0 > lead ? iz0 : lead;
      if (b == 6) bz0 = iz1 > lead ? iz1 : lead;
      const int ey = by1 - by0, ez = bz1 - bz0;
      const int n = (bx1 - bx0) * ey * ez;
      for (int j = threadIdx.x; j < n; j += NTHREADS) {
        const int wz = bz0 + j % ez, r = j / ez;
        const int wy = by0 + r % ey, wx = bx0 + r / ey;
        const int gx = lx0 + wx, gy = ly0 + wy, gz = lz0 + wz;
        const bool in_x = gx >= 0 && gx < nx;
        const bool in_y = gy >= 0 && gy < ny;
        const bool in_z = gz >= 0 && gz < nz;
        T a[kNF];
#pragma unroll
        for (int f = 0; f < kNF; ++f) put(&a[f], fs.bound[f]);
        if (in_x && in_y && in_z) {
          const size_t i = ((size_t)gx * ny + gy) * nz + gz;
#pragma unroll
          for (int f = 0; f < kNF; ++f) a[f] = __ldg(fs.in[f] + mvol + i);
        } else if (MODE == kFaces6) {
          // A ghost across exactly one axis reads that axis's face.
          if (in_y && in_z && (gx == -1 || gx == nx)) {
            const size_t i = fox + (size_t)gy * nz + gz;
            const int hi = gx < 0 ? 0 : 1;
#pragma unroll
            for (int f = 0; f < kNF; ++f) {
              a[f] = (hi ? faces.p[2 * f + 1] : faces.p[2 * f])[i];
            }
          } else if (in_x && in_z && (gy == -1 || gy == ny)) {
            const size_t i = foy + (size_t)gx * nz + gz;
            const int hi = gy < 0 ? 0 : 1;
#pragma unroll
            for (int f = 0; f < kNF; ++f) {
              a[f] = (hi ? faces.p[2 * kNF + 2 * f + 1]
                         : faces.p[2 * kNF + 2 * f])[i];
            }
          } else if (in_x && in_y && (gz == -1 || gz == nz)) {
            const size_t i = foz + (size_t)gx * ny + gy;
            const int hi = gz < 0 ? 0 : 1;
#pragma unroll
            for (int f = 0; f < kNF; ++f) {
              a[f] = (hi ? faces.p[4 * kNF + 2 * f + 1]
                         : faces.p[4 * kNF + 2 * f])[i];
            }
          }
        } else if (MODE == kXChain) {
          // The k-deep x slabs extend the operand in x only.
          if (in_y && in_z && gx >= -fuse && gx < nx + fuse) {
            const bool lo = gx < 0;
            const size_t i =
                fox + ((size_t)(lo ? gx + fuse : gx - nx) * ny + gy) * nz + gz;
#pragma unroll
            for (int f = 0; f < kNF; ++f) {
              a[f] = (lo ? faces.p[2 * f] : faces.p[2 * f + 1])[i];
            }
          }
        }
        const int c = (wx * WY + wy) * WZP + wz;
#pragma unroll
        for (int f = 0; f < kNF; ++f) in[f * wvol + c] = a[f];
      }
    }
    __syncthreads();
  }

  // The probes' output: the block's tile cells of window `w`, every
  // field, in the last stage's thread layout.
  auto store_tile = [&](const T* w) {
    for (int r = warp; r < TX * TY; r += NWARPS) {
      const int wx = h + r / TY, wy = h + r % TY;
      const int gx = x0 + wx, gy = y0 + wy;
      if (gx >= nx || gy >= ny) continue;
      const size_t gbase = mvol + ((size_t)gx * ny + gy) * nz;
      for (int wz = h + lane; wz < h + TZ; wz += 32) {
        const int gz = z0 + wz;
        if (gz >= nz) continue;
        const int c = (wx * WY + wy) * WZP + wz;
#pragma unroll
        for (int f = 0; f < kNF; ++f) fs.out[f][gbase + gz] = w[f * wvol + c];
      }
    }
  };
  if constexpr (MODE == kCopyWalk) {
    store_tile(in);
    return;
  }

  // Stage s: read window `cur` (T at stage 0, else M), write `nxt` (M),
  // or the output at the last stage (the compute walk: `nxt` still).
  auto stage = [&](const auto* cur, M* nxt, int s) {
    const bool last = s == fuse - 1;
    const int lo = s + 1;  // this stage's output window is [lo, W - lo)
    const int ex = WX - 2 * lo, ey = WY - 2 * lo, ez = WZ - 2 * lo;
    const uint32_t step = step0 + (uint32_t)s;
    for (int r = warp; r < ex * ey; r += NWARPS) {
      const int wx = lo + r / ey, wy = lo + r % ey;
      const int gx = x0 + wx, gy = y0 + wy;
      const bool in_x = gx >= 0 && gx < nx;
      const bool in_y = gy >= 0 && gy < ny;
      if (last && !(in_x && in_y)) continue;
      // The rows this stage computes: the block's, or for the x-chain
      // every row of the operand's y extent whose global x and y are in
      // the domain (mid stages pin the others).
      bool rows = in_x && in_y;
      if (MODE == kXChain) {
        rows = in_y &&
               (last || !(outside(ox + gx, irow) || outside(oy + gy, irow)));
      }
      const uint32_t pseed =
          kNoiseTerm && use_noise
              ? plane_seed(k0, k1, step, (uint32_t)(ox + gx))
              : 0u;
      const uint32_t iy = (uint32_t)(oy + gy);
      const size_t gbase = last ? mvol + ((size_t)gx * ny + gy) * nz : 0;
      for (int wz = lo + lane; wz < lo + ez; wz += 32) {
        const int gz = z0 + wz;
        const bool in_z = gz >= 0 && gz < nz;
        if (last && !in_z) continue;
        bool compute = rows && in_z;
        if (MODE == kXChain && !last) {
          compute = compute && !outside(oz + gz, irow);
        }
        if (!kPins) compute = true;
        const int c = (wx * WY + wy) * WZP + wz;
        C res[kNF];  // pinned cells hold the boundary value
#pragma unroll
        for (int f = 0; f < kNF; ++f) res[f] = fs.bound[f];
        if (compute) {
          if constexpr (VARIANT == kMinimal) {
            res[0] = mul(widen(cur[c]), au);
            res[1] = mul(widen(cur[wvol + c]), av);
          } else if constexpr (VARIANT == kFma) {
            const C u = widen(cur[c]), v = widen(cur[wvol + c]);
            const C uvv_dt = mul(mul(mul(u, v), v), p[kDt]);
            const C su = nsum6<true, C>(cur, c, sx, sy);
            const C sv = nsum6<true, C>(cur + wvol, c, sx, sy);
            res[0] = sub(add(add(mul(u, au), mul(bu, su)), cu), uvv_dt);
            res[1] = add(add(mul(v, av), mul(bv2, sv)), uvv_dt);
            if (use_noise) {
              const uint32_t bits =
                  hash32(cell_hash(iy, (uint32_t)(oz + gz), row) ^ pseed);
              res[0] = add(res[0], mul(noise_dt, (C)bits_to_pm1(bits)));
            }
          } else {
            C val[kNF], lap[kNF], d[kNF];
#pragma unroll
            for (int f = 0; f < kNF; ++f) {
              val[f] = widen(cur[f * wvol + c]);
              if constexpr (VARIANT == kNoYZ) {
                lap[f] = sub(
                    mul(nsum6<false, C>(cur + f * wvol, c, sx, sy), inv6),
                    val[f]);
              } else {
                lap[f] = lap7(cur + f * wvol, c, sx, sy, inv6);
              }
            }
            C noise = C(0);
            if (kNoiseTerm && use_noise) {
              const uint32_t bits =
                  hash32(cell_hash(iy, (uint32_t)(oz + gz), row) ^ pseed);
              noise = mul(p[kNoise], (C)bits_to_pm1(bits));
            }
            gs_reaction(val, lap, noise, p, d);
#pragma unroll
            for (int f = 0; f < kNF; ++f) {
              res[f] = add(val[f], mul(d[f], p[kDt]));
            }
          }
        }
#pragma unroll
        for (int f = 0; f < kNF; ++f) {
          if (last && MODE != kComputeWalk) {
            put(&fs.out[f][gbase + gz], res[f]);
          } else {
            put(&nxt[f * wvol + c], res[f]);
          }
        }
      }
    }
    __syncthreads();
  };

  if constexpr (VARIANT == kNoMid) {
    // Per tile cell (the last stage's layout), every stage from the
    // input window into the cell's accumulators, then one store to the
    // free window. Cell-major, so the accumulators stay kNF registers.
    for (int r = warp; r < TX * TY; r += NWARPS) {
      const int wx = h + r / TY, wy = h + r % TY;
      const int gx = x0 + wx, gy = y0 + wy;
      if (gx >= nx || gy >= ny) continue;
      for (int wz = h + lane; wz < h + TZ; wz += 32) {
        const int gz = z0 + wz;
        if (gz >= nz) continue;
        const int c = (wx * WY + wy) * WZP + wz;
        C acc[kNF];
#pragma unroll
        for (int f = 0; f < kNF; ++f) acc[f] = widen(in[f * wvol + c]);
        for (int s = 0; s < fuse; ++s) {
          C val[kNF], lap[kNF], d[kNF];
#pragma unroll
          for (int f = 0; f < kNF; ++f) {
            val[f] = widen(in[f * wvol + c]);
            lap[f] = lap7(in + f * wvol, c, sx, sy, inv6);
          }
          C noise = C(0);
          if (use_noise) {
            const uint32_t pseed = plane_seed(
                k0, k1, step0 + (uint32_t)s, (uint32_t)(ox + gx));
            const uint32_t bits = hash32(
                cell_hash((uint32_t)(oy + gy), (uint32_t)(oz + gz), row) ^
                pseed);
            noise = mul(p[kNoise], (C)bits_to_pm1(bits));
          }
          gs_reaction(val, lap, noise, p, d);
#pragma unroll
          for (int f = 0; f < kNF; ++f) {
            acc[f] = add(acc[f], add(val[f], mul(d[f], p[kDt])));
          }
        }
#pragma unroll
        for (int f = 0; f < kNF; ++f) put(&mids[(kNF + f) * wvol + c], acc[f]);
      }
    }
    __syncthreads();
  } else if constexpr (kSplit) {
    stage(in, mids, 0);
    for (int s = 1; s < fuse; ++s) {
      stage(mids + ((s - 1) & 1) * kNF * wvol, mids + (s & 1) * kNF * wvol,
            s);
    }
  } else {
    for (int s = 0; s < fuse; ++s) {
      stage(mids + (s & 1) * kNF * wvol, mids + ((s + 1) & 1) * kNF * wvol,
            s);
    }
  }
  if constexpr (MODE == kComputeWalk) {
    // The last stage is in window fuse & 1 (nomid's sum in window 1).
    if (t == 0) {
      store_tile(mids + (VARIANT == kNoMid ? 1 : fuse & 1) * kNF * wvol);
    }
  }
}

template <typename T, typename M>
size_t smem_bytes(int fuse, int n_win) {
  return window_bytes<T, M>(fuse, n_win) + kBarrierBytes;
}

template <typename T, typename M, int MODE, int VARIANT = kChain>
int run(const Fields<T, typename Compute<T>::type>& fs,
        const typename Compute<T>::type* params, const Faces<T>& faces,
        const WindowMaps& maps, int tma, uint32_t k0, uint32_t k1,
        const uint32_t* keys, int members,
        uint32_t step0, int ox, int oy, int oz, uint32_t row, int nx, int ny,
        int nz, int fuse, int use_noise, cudaStream_t stream) {
  auto kernel = stencil_chain_kernel<T, M, MODE, VARIANT>;
  const long long n_tiles = (long long)((nz + TZ - 1) / TZ) *
                            ((ny + TY - 1) / TY) * ((nx + TX - 1) / TX);
  if (n_tiles > 0x7FFFFFFFLL || members < 1 || members > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes<T, M>(fuse, windows_needed(MODE, fuse));
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)n_tiles, (unsigned)members), NTHREADS, smem,
           stream>>>(fs, params, faces, maps, tma, k0, k1, keys, step0, ox, oy,
                     oz, row, nx, ny, nz, fuse, use_noise);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the march
//
// The column of a march block: kMarchTY rows by kMarchZB bytes of z (64
// float, 32 double, 128 bf16 cells), walked by kMarchWarps consumer warps
// of 16 threads a row, 16 B of z each, and one producer warp; kRing
// plane slots. A block marches `span` planes; march_span sizes it from
// the shape.
constexpr int kMarchTY = 32;
constexpr int kMarchZB = 256;
constexpr int kMarchWarps = 16;
constexpr int kMarchThreads = 32 * (kMarchWarps + 1);
constexpr int kRing = 4;
constexpr int kMarchMinSpan = 16;
// The blocks a launch aims for: four waves of one resident block on an
// H100's 132 SMs. Longer spans (fewer halo planes and pipeline fills)
// beat more blocks down to about four waves: on an H100, 528 beat 1,056
// with this column, as 1,056 beat 528 to 16,896 with a 16-row one
// (PERF.md).
constexpr int kMarchBlocks = 528;
// The ring's mbarriers (kRing full, kRing empty) before the slots.
constexpr int kRingHead = 128;

static_assert(kMarchWarps * 2 == kMarchTY, "a warp computes two rows");

// One plane slot of one field for `itemsize`-byte cells: the box of
// (kMarchTY + 2) rows of BZ cells (the column's z extent TZ plus 16 B a
// side) at row stride BZ, rounded up to 128 B (TMA's destination
// alignment). The Python ledger's cuda_stencil.ring_geometry.
struct RingGeom {
  int V, TZ, BZ, RY, box_bytes, slot_bytes;
};

__host__ __device__ constexpr RingGeom ring_of(int itemsize) {
  RingGeom r{};
  r.V = 16 / itemsize;
  r.TZ = kMarchZB / itemsize;
  r.BZ = r.TZ + 2 * r.V;
  r.RY = kMarchTY + 2;
  r.box_bytes = r.RY * r.BZ * itemsize;
  r.slot_bytes = (r.box_bytes + 127) / 128 * 128;
  return r;
}

__host__ __device__ __forceinline__ size_t ring_bytes(int itemsize) {
  return kRingHead + (size_t)kRing * kNF * ring_of(itemsize).slot_bytes;
}

// The planes a block marches for an operand of nx planes whose launch has
// `tiles` columns times members: enough segments for kMarchBlocks blocks,
// none shorter than kMarchMinSpan planes (unless nx is), so that the two
// halo planes of a segment cost at most an eighth of its loads.
__host__ __device__ __forceinline__ int march_span(int nx, long long tiles) {
  long long segs = (kMarchBlocks + tiles - 1) / tiles;
  const int most = nx / kMarchMinSpan;
  if (segs > most) segs = most;
  if (segs < 1) segs = 1;
  return (int)((nx + segs - 1) / segs);
}

// Whether a launch marches: kBlock at fuse 1 with TMA maps (its inputs
// pass TMA's rules) and outputs on 16 B boundaries (vector stores).
__host__ __device__ __forceinline__ bool march_engages(int mode, int fuse,
                                                       bool tma,
                                                       bool outs_aligned) {
  return mode == kBlock && fuse == 1 && tma && outs_aligned;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// 16 B of cells of one row in registers, as four 32-bit words (V cells
// of T): Cells<T> reads cell v in the compute type (exactly) and writes
// it rounded to T. Words, not an array of T: 16-bit bf16 cells in an
// array would go through local memory.
struct Pack {
  uint32_t w[4];
};

__device__ __forceinline__ Pack ld_pack(const void* p) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  return Pack{{r.x, r.y, r.z, r.w}};
}

__device__ __forceinline__ void st_pack(void* p, const Pack& v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
}

template <typename T>
struct Cells;

template <>
struct Cells<float> {
  static __device__ __forceinline__ float get(const Pack& p, int v) {
    return __uint_as_float(p.w[v]);
  }
  static __device__ __forceinline__ void set(Pack& p, int v, float x) {
    p.w[v] = __float_as_uint(x);
  }
};

template <>
struct Cells<double> {
  static __device__ __forceinline__ double get(const Pack& p, int v) {
    return __hiloint2double((int)p.w[2 * v + 1], (int)p.w[2 * v]);
  }
  static __device__ __forceinline__ void set(Pack& p, int v, double x) {
    p.w[2 * v] = (uint32_t)__double2loint(x);
    p.w[2 * v + 1] = (uint32_t)__double2hiint(x);
  }
};

// A bf16 cell is the high half of its float: widening is a shift, and
// the write rounds to nearest even as put does.
template <>
struct Cells<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const Pack& p, int v) {
    const uint32_t w = p.w[v / 2];
    return __uint_as_float(v % 2 ? w & 0xFFFF0000u : w << 16);
  }
  static __device__ __forceinline__ void set(Pack& p, int v, float x) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    uint32_t& w = p.w[v / 2];
    w = v % 2 ? (w & 0xFFFFu) | (b << 16) : (w & 0xFFFF0000u) | b;
  }
};

// A pack of V copies of c, rounded to T.
template <typename T, typename C>
__device__ __forceinline__ Pack fill_pack(C c) {
  Pack out{};
#pragma unroll
  for (int v = 0; v < (int)(16 / sizeof(T)); ++v) Cells<T>::set(out, v, c);
  return out;
}

// One block of 544 threads an SM (~80 registers): faster on an H100 than
// two or four blocks of 288 or 160 threads with 16- or 8-row columns, as
// the copy alone is slower at five blocks than at two (PERF.md).
template <typename T>
__global__ void __launch_bounds__(kMarchThreads, 1)
stencil_chain_kernel_march(const Fields<T, typename Compute<T>::type> fs,
                           const typename Compute<T>::type* __restrict__ params,
                           const __grid_constant__ WindowMaps maps, int tma,
                           uint32_t k0, uint32_t k1,
                           const uint32_t* __restrict__ keys, uint32_t step,
                           int ox, int oy, int oz, uint32_t row, int nx,
                           int ny, int nz, int span, int nseg,
                           int use_noise) {
  using C = typename Compute<T>::type;
  constexpr RingGeom g = ring_of(sizeof(T));
  constexpr int V = g.V, BZ = g.BZ;
  constexpr int FS = g.slot_bytes / (int)sizeof(T);  // a field's slot
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kRing;
  const T* ring = reinterpret_cast<const T*>(smem_raw + kRingHead);

  // This block: member m, column (y0, z0) (columns z fastest), planes
  // [xs, xe); the grid's x is segment-fastest.
  const int m = blockIdx.y;
  const int seg = blockIdx.x % nseg, col = blockIdx.x / nseg;
  const int cols_z = (nz + g.TZ - 1) / g.TZ;
  const int z0 = col % cols_z * g.TZ, y0 = col / cols_z * kMarchTY;
  const int xs = seg * span;
  const int n = (xs + span < nx ? xs + span : nx) - xs;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kMarchWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kMarchWarps) {
    // The producer: planes xs - 1 .. xe, plane j into slot j % kRing once
    // the consumers released the plane kRing before it. A plane outside
    // the operand is not loaded; its arrival alone completes the slot.
    if (lane == 0) {
      for (int j = 0; j < n + 2; ++j) {
        const int s = j % kRing;
        if (j >= kRing) mbar_wait(&empty[s], (uint32_t)((j / kRing - 1) & 1));
        const int x = xs - 1 + j;
        if (x < 0 || x >= nx) {
          mbar_arrive(&full[s]);
          continue;
        }
        mbar_expect_tx(&full[s], (uint32_t)(kNF * g.RY * BZ * sizeof(T)));
#pragma unroll
        for (int f = 0; f < kNF; ++f) {
          void* dst = const_cast<T*>(ring) + (s * kNF + f) * FS;
          if (tma == 2) {
            tma_load_4d(dst, &maps.m[f], z0 - V, y0 - 1, x, m, &full[s]);
          } else {
            tma_load_3d(dst, &maps.m[f], z0 - V, y0 - 1, x, &full[s]);
          }
        }
      }
    }
    return;
  }

  // A consumer thread: row ty of the column, z cells [tz, tz + V).
  const size_t mvol = (size_t)m * nx * ny * nz;
  if (keys != nullptr) {
    k0 = keys[2 * m];
    k1 = keys[2 * m + 1];
  }
  params += (size_t)m * kNP;
  C p[kNP];
#pragma unroll
  for (int i = 0; i < kNP; ++i) p[i] = params[i];
  const C inv6 = C(1.0 / 6.0);
  const int ty = warp * 2 + lane / 16, tz = lane % 16 * V;
  const int gy = y0 + ty, gz = z0 + tz;
  const bool live = gy < ny && gz < nz;  // nz is a multiple of V
  // Only a column at an edge replaces ghosts: in y, a row at 0 or ny - 1;
  // in z, a vector at either end of the row.
  const bool edge =
      y0 == 0 || z0 == 0 || y0 + kMarchTY >= ny || z0 + g.TZ >= nz;
  const bool ylo = gy == 0, yhi = gy + 1 >= ny;
  const bool zlo = gz == 0, zhi = gz + V >= nz;
  // The boundary value as the window's ghost pass stores it (in T).
  C bound[kNF];
#pragma unroll
  for (int f = 0; f < kNF; ++f) {
    T b;
    put(&b, fs.bound[f]);
    bound[f] = widen(b);
  }
  uint32_t ch[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    ch[v] = use_noise ? cell_hash((uint32_t)(oy + gy),
                                  (uint32_t)(oz + gz + v), row)
                      : 0u;
  }
  const int c0 = (ty + 1) * BZ + V + tz;  // the thread's first cell in a slot

  Pack prev[kNF], cur[kNF], nxt[kNF];
  mbar_wait(&full[0], 0u);
  mbar_wait(&full[1], 0u);
#pragma unroll
  for (int f = 0; f < kNF; ++f) {
    prev[f] =
        xs > 0 ? ld_pack(ring + f * FS + c0) : fill_pack<T>(bound[f]);
    cur[f] = ld_pack(ring + (kNF + f) * FS + c0);
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[0]);

  uint32_t seeds = 0u;  // lane l: plane_seed of plane xs + 32 (i / 32) + l
  for (int i = 0; i < n; ++i) {
    const int x = xs + i;
    const int sc = (i + 1) % kRing, sn = (i + 2) % kRing;
    // The plane's seed, drawn by one lane in 32 planes and shuffled.
    if (use_noise && (i & 31) == 0) {
      seeds = plane_seed(k0, k1, step, (uint32_t)(ox + x + lane));
    }
    const uint32_t pseed = __shfl_sync(0xFFFFFFFFu, seeds, i & 31);
    const T* cs = ring + sc * kNF * FS;
    const T* ns = ring + sn * kNF * FS;
    mbar_wait(&full[sn], (uint32_t)(((i + 2) / kRing) & 1));
    Pack ym[kNF], yp[kNF];
    C zm[kNF], zp[kNF];
#pragma unroll
    for (int f = 0; f < kNF; ++f) {
      nxt[f] =
          x + 1 < nx ? ld_pack(ns + f * FS + c0) : fill_pack<T>(bound[f]);
      ym[f] = ld_pack(cs + f * FS + c0 - BZ);
      yp[f] = ld_pack(cs + f * FS + c0 + BZ);
      zm[f] = widen(cs[f * FS + c0 - 1]);
      zp[f] = widen(cs[f * FS + c0 + V]);
    }
    if (edge) {
#pragma unroll
      for (int f = 0; f < kNF; ++f) {
        if (ylo) ym[f] = fill_pack<T>(bound[f]);
        if (yhi) yp[f] = fill_pack<T>(bound[f]);
        if (zlo) zm[f] = bound[f];
        if (zhi) zp[f] = bound[f];
      }
    }
    // Everything of plane x is in registers: release its slot.
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[sc]);
    if (live) {
      Pack res[kNF] = {};
#pragma unroll
      for (int v = 0; v < V; ++v) {
        C val[kNF], lap[kNF], d[kNF];
#pragma unroll
        for (int f = 0; f < kNF; ++f) {
          val[f] = Cells<T>::get(cur[f], v);
          const C zl =
              v == 0 ? zm[f] : Cells<T>::get(cur[f], v == 0 ? 0 : v - 1);
          const C zh = v == V - 1
                           ? zp[f]
                           : Cells<T>::get(cur[f], v == V - 1 ? 0 : v + 1);
          const C total = add(add(add(add(add(Cells<T>::get(prev[f], v),
                                              Cells<T>::get(nxt[f], v)),
                                          Cells<T>::get(ym[f], v)),
                                      Cells<T>::get(yp[f], v)),
                                  zl),
                              zh);
          lap[f] = sub(mul(total, inv6), val[f]);
        }
        C noise = C(0);
        if (use_noise) {
          noise = mul(p[kNoise], (C)bits_to_pm1(hash32(ch[v] ^ pseed)));
        }
        gs_reaction(val, lap, noise, p, d);
#pragma unroll
        for (int f = 0; f < kNF; ++f) {
          Cells<T>::set(res[f], v, add(val[f], mul(d[f], p[kDt])));
        }
      }
      const size_t o = mvol + ((size_t)x * ny + gy) * nz + gz;
#pragma unroll
      for (int f = 0; f < kNF; ++f) st_pack(fs.out[f] + o, res[f]);
    }
#pragma unroll
    for (int f = 0; f < kNF; ++f) {
      prev[f] = cur[f];
      cur[f] = nxt[f];
    }
  }
}

template <typename T>
int run_march(const Fields<T, typename Compute<T>::type>& fs,
              const typename Compute<T>::type* params, const WindowMaps& maps,
              int tma, uint32_t k0, uint32_t k1, const uint32_t* keys,
              int members, uint32_t step0, int ox, int oy, int oz,
              uint32_t row, int nx, int ny, int nz, int use_noise,
              cudaStream_t stream) {
  auto kernel = stencil_chain_kernel_march<T>;
  if (members < 1 || members > 65535) return (int)cudaErrorInvalidValue;
  // The grid: columns x segments of `span` planes, per member.
  constexpr RingGeom g = ring_of(sizeof(T));
  const long long cols =
      (long long)((nz + g.TZ - 1) / g.TZ) * ((ny + kMarchTY - 1) / kMarchTY);
  const int span = march_span(nx, cols * members);
  const long long nseg = (nx + span - 1) / span;
  if (cols * nseg > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const size_t smem = ring_bytes(sizeof(T));
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)(cols * nseg), (unsigned)members), kMarchThreads,
           smem, stream>>>(fs, params, maps, tma, k0, k1, keys, step0, ox, oy,
                           oz, row, nx, ny, nz, span, (int)nseg, use_noise);
  return (int)cudaGetLastError();
}

// The tensor maps of a launch: kNF maps from the host (`maps`, 128 B
// each, as gs_window_map encodes them), or none for the cp.async load.
inline WindowMaps maps_of(const void* maps) {
  WindowMaps wm;
  memset(&wm, 0, sizeof(wm));
  if (maps != nullptr) memcpy(&wm, maps, sizeof(wm));
  return wm;
}

// A launch of `members` stacked members (1: a solo launch, with the key
// words k0, k1; more: `keys` holds a device array of their key pairs,
// `maps` their 4-D tensor maps).
template <typename T, typename M>
int launch(const void* const* in, void* const* out, const void* params,
           const void* const* face_ptrs, const void* maps,
           const double* bounds, int mode, uint32_t k0, uint32_t k1,
           const uint32_t* keys, int members,
           uint32_t step0, int ox, int oy, int oz, uint32_t row, int nx,
           int ny, int nz, int fuse, int use_noise, void* stream) {
  using C = typename Compute<T>::type;
  const int n_faces = mode == kFaces6 ? 6 * kNF : mode == kXChain ? 2 * kNF : 0;
  if (fuse < 1 || nx < 1 || ny < 1 || nz < 1 || mode < kBlock ||
      mode > kXChain || (mode == kFaces6 && fuse != 1) || in == nullptr ||
      out == nullptr || bounds == nullptr ||
      (n_faces > 0 && face_ptrs == nullptr) ||
      (members > 1 && keys == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Fields<T, C> fs = {};
  for (int f = 0; f < kNF; ++f) {
    fs.in[f] = static_cast<const T*>(in[f]);
    fs.out[f] = static_cast<T*>(out[f]);
    fs.bound[f] = static_cast<C>(bounds[f]);
  }
  Faces<T> faces = {};
  for (int i = 0; i < n_faces; ++i) {
    faces.p[i] = static_cast<const T*>(face_ptrs[i]);
  }
  const WindowMaps wm = maps_of(maps);
  const int tma = maps == nullptr ? 0 : members > 1 ? 2 : 1;
  const C* pv = static_cast<const C*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool outs_aligned = true;
  for (int f = 0; f < kNF; ++f) {
    outs_aligned =
        outs_aligned && reinterpret_cast<uintptr_t>(out[f]) % 16 == 0;
  }
  if (march_engages(mode, fuse, tma != 0, outs_aligned)) {
    // `maps` are gs_march_map's.
    return run_march<T>(fs, pv, wm, tma, k0, k1, keys, members, step0, ox, oy,
                        oz, row, nx, ny, nz, use_noise, st);
  }
  switch (mode) {
    case kFaces6:
      return run<T, M, kFaces6>(fs, pv, faces, wm, tma, k0, k1, keys, members,
                                step0, ox, oy, oz, row, nx, ny, nz, fuse,
                                use_noise, st);
    case kXChain:
      return run<T, M, kXChain>(fs, pv, faces, wm, tma, k0, k1, keys, members,
                                step0, ox, oy, oz, row, nx, ny, nz, fuse,
                                use_noise, st);
    default:
      return run<T, M, kBlock>(fs, pv, faces, wm, tma, k0, k1, keys, members,
                               step0, ox, oy, oz, row, nx, ny, nz, fuse,
                               use_noise, st);
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// that the library links no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(sym);
    }
  }
  return fn;
}

#ifdef GS_ENVELOPE_PROBES
static_assert(kNF == 2 && kNP == 6, "the envelope probes are Gray-Scott's");

template <int VARIANT>
int compute_walk(const Fields<float, float>& fs, const float* params,
                 const WindowMaps& wm, int tma, uint32_t k0, uint32_t k1,
                 uint32_t step0, uint32_t row, int nx, int ny, int nz,
                 int fuse, int use_noise, cudaStream_t st) {
  return run<float, float, kComputeWalk, VARIANT>(
      fs, params, Faces<float>{}, wm, tma, k0, k1, nullptr, 1, step0, 0, 0,
      0, row, nx, ny, nz, fuse, use_noise, st);
}

int probe(int mode, int variant, const void* const* in, void* const* out,
          const void* params, const void* maps, const double* bounds,
          uint32_t k0, uint32_t k1, uint32_t step0, uint32_t row, int nx, int ny, int nz, int fuse, int use_noise,
          void* stream) {
  if (fuse < 1 || nx < 1 || ny < 1 || nz < 1 || in == nullptr ||
      out == nullptr || bounds == nullptr ||
      (mode == kComputeWalk &&
       (params == nullptr || variant < kChain || variant > kNoMid))) {
    return (int)cudaErrorInvalidValue;
  }
  Fields<float, float> fs = {};
  for (int f = 0; f < kNF; ++f) {
    fs.in[f] = static_cast<const float*>(in[f]);
    fs.out[f] = static_cast<float*>(out[f]);
    fs.bound[f] = static_cast<float>(bounds[f]);
  }
  const WindowMaps wm = maps_of(maps);
  const int tma = maps != nullptr;
  const float* pv = static_cast<const float*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kCopyWalk) {
    return run<float, float, kCopyWalk>(fs, pv, Faces<float>{}, wm, tma, 0,
                                        0, nullptr, 1, 0, 0, 0, 0, row, nx,
                                        ny, nz, fuse, 0, st);
  }
#define GS_WALK(V)                                                         \
  compute_walk<V>(fs, pv, wm, tma, k0, k1, step0, row, nx, ny, nz, fuse, \
                  use_noise, st)
  switch (variant) {
    case kNoNoise:
      return GS_WALK(kNoNoise);
    case kNoSelect:
      return GS_WALK(kNoSelect);
    case kNoYZ:
      return GS_WALK(kNoYZ);
    case kFma:
      return GS_WALK(kFma);
    case kMinimal:
      return GS_WALK(kMinimal);
    case kNoMid:
      return GS_WALK(kNoMid);
    default:
      return GS_WALK(kChain);
  }
#undef GS_WALK
}
#endif  // GS_ENVELOPE_PROBES

#ifndef GS_ENVELOPE_PROBES
// The attributes of one kernel instance (gs_kernel_attributes): out[0]
// registers per thread, out[1] local (spill) bytes per thread, out[2]
// static shared bytes, out[3] the instance's max threads per block,
// out[4] the dynamic shared bytes a launch at depth `fuse` requests,
// out[5] blocks per SM at those bytes, out[6] threads per block.
template <typename T, typename M, int MODE>
int attributes_of(int fuse, int* out) {
  auto kernel = stencil_chain_kernel<T, M, MODE>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes<T, M>(fuse, windows_needed(MODE, fuse));
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      NTHREADS, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  out[4] = (int)smem;
  out[5] = blocks;
  out[6] = NTHREADS;
  return 0;
}

// The march's attributes, in attributes_of's layout.
template <typename T>
int march_attributes(int* out) {
  auto kernel = stencil_chain_kernel_march<T>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ring_bytes(sizeof(T));
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kMarchThreads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  out[4] = (int)smem;
  out[5] = blocks;
  out[6] = kMarchThreads;
  return 0;
}

// kBlock at fuse 1 reports the march, the instance a launch on the TMA
// path runs.
template <typename T, typename M>
int attributes_by_mode(int mode, int fuse, int* out) {
  if (march_engages(mode, fuse, true, true)) return march_attributes<T>(out);
  switch (mode) {
    case kFaces6:
      return attributes_of<T, M, kFaces6>(fuse, out);
    case kXChain:
      return attributes_of<T, M, kXChain>(fuse, out);
    default:
      return attributes_of<T, M, kBlock>(fuse, out);
  }
}
#endif  // GS_ENVELOPE_PROBES

}  // namespace

extern "C" {

// The interior tile (x, y, z), the generated counts (fields, params)
// and the march's column rows, column z bytes, ring slots, threads,
// least span and block target; the Python ledger checks they agree.
void gs_layout(int* out) {
  out[0] = TX;
  out[1] = TY;
  out[2] = TZ;
  out[3] = kNF;
  out[4] = kNP;
  out[5] = kMarchTY;
  out[6] = kMarchZB;
  out[7] = kRing;
  out[8] = kMarchThreads;
  out[9] = kMarchMinSpan;
  out[10] = kMarchBlocks;
}

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The TMA tensor map of one field's windows at depth `fuse` into `out`
// (128 B): the (nx, ny, nz) tensor at `base` with elements of
// `itemsize` bytes (4 float, 8 double, 2 bfloat16), box (WZP, WY, WX).
// Returns 0, the driver's CUresult, or -1 when the driver has no
// cuTensorMapEncodeTiled.
int gs_window_map(void* out, const void* base, int itemsize, int nx, int ny,
                  int nz, int fuse) {
  const EncodeTiledFn encode = encoder();
  if (encode == nullptr) return -1;
  const CUtensorMapDataType type =
      itemsize == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
      : itemsize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const Window w = window_of(itemsize, fuse);
  const cuuint64_t dims[3] = {(cuuint64_t)nz, (cuuint64_t)ny, (cuuint64_t)nx};
  const cuuint64_t strides[2] = {(cuuint64_t)nz * itemsize,
                                 (cuuint64_t)ny * nz * itemsize};
  const cuuint32_t box[3] = {(cuuint32_t)w.WZP, (cuuint32_t)w.WY,
                             (cuuint32_t)w.WX};
  const cuuint32_t unit[3] = {1, 1, 1};
  return (int)encode(static_cast<CUtensorMap*>(out), type, 3,
                     const_cast<void*>(base), dims, strides, box, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The 4-D tensor map of one field's windows in a batched launch: the
// (members, nx, ny, nz) tensor at `base`, dims (nz, ny, nx, members),
// box (WZP, WY, WX, 1) — one member deep, so a box past a member's x
// edge is out of bounds (zero-filled), never the previous member's.
int gs_window_map4(void* out, const void* base, int itemsize, int nx, int ny,
                   int nz, int members, int fuse) {
  const EncodeTiledFn encode = encoder();
  if (encode == nullptr) return -1;
  const CUtensorMapDataType type =
      itemsize == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
      : itemsize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const Window w = window_of(itemsize, fuse);
  const cuuint64_t dims[4] = {(cuuint64_t)nz, (cuuint64_t)ny, (cuuint64_t)nx,
                              (cuuint64_t)members};
  const cuuint64_t strides[3] = {(cuuint64_t)nz * itemsize,
                                 (cuuint64_t)ny * nz * itemsize,
                                 (cuuint64_t)nx * ny * nz * itemsize};
  const cuuint32_t box[4] = {(cuuint32_t)w.WZP, (cuuint32_t)w.WY,
                             (cuuint32_t)w.WX, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return (int)encode(static_cast<CUtensorMap*>(out), type, 4,
                     const_cast<void*>(base), dims, strides, box, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The TMA tensor map of one field's march planes (the ring's box): the
// (nx, ny, nz) tensor at `base`, box (BZ, kMarchTY + 2, 1); with more
// than one member the (members, nx, ny, nz) tensor, box one member deep.
int gs_march_map(void* out, const void* base, int itemsize, int nx, int ny,
                 int nz, int members) {
  const EncodeTiledFn encode = encoder();
  if (encode == nullptr) return -1;
  const CUtensorMapDataType type =
      itemsize == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
      : itemsize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const RingGeom r = ring_of(itemsize);
  const cuuint32_t rank = members > 1 ? 4 : 3;
  const cuuint64_t dims[4] = {(cuuint64_t)nz, (cuuint64_t)ny, (cuuint64_t)nx,
                              (cuuint64_t)members};
  const cuuint64_t strides[3] = {(cuuint64_t)nz * itemsize,
                                 (cuuint64_t)ny * nz * itemsize,
                                 (cuuint64_t)nx * ny * nz * itemsize};
  const cuuint32_t box[4] = {(cuuint32_t)r.BZ, (cuuint32_t)r.RY, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return (int)encode(static_cast<CUtensorMap*>(out), type, rank,
                     const_cast<void*>(base), dims, strides, box, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// in, out: host arrays of kNF device pointers; params: a device vector
// of kNP values of the compute type (float for bf16 fields); face_ptrs: a
// host array of device pointers (6 kNF for mode 1, 2 kNF for mode 2) or
// NULL for mode 0; maps: kNF tensor maps of the inputs (gs_window_map,
// 128 B each, at this fuse; gs_march_map's where the launch marches:
// march_engages), or NULL to load by cp.async; bounds: a host
// array of kNF boundary values. One entry point per posture: f32, f64,
// bf16 (bf16 storage and windows, float compute) and f32_mid_bf16
// (float fields, bf16 mid windows).
#define GS_ENTRY(NAME, T, M)                                                 \
  int NAME(const void* const* in, void* const* out, const void* params,       \
           const void* const* face_ptrs, const void* maps,                    \
           const double* bounds, int mode, uint32_t k0, uint32_t k1,          \
           uint32_t step0, int ox, int oy, int oz, uint32_t row, int nx,      \
           int ny, int nz, int fuse, int use_noise, void* stream) {           \
    return launch<T, M>(in, out, params, face_ptrs, maps, bounds, mode, k0,   \
                        k1, nullptr, 1, step0, ox, oy, oz, row, nx, ny, nz,   \
                        fuse, use_noise, stream);                             \
  }

// The batched form: in and out point at (members, nx, ny, nz) tensors,
// params at a (members, kNP) matrix, face_ptrs at faces with the same
// leading axis, keys at a device array of `members` key pairs (uint32
// k0, k1); maps are gs_window_map4's (gs_march_map's where it
// marches). The step and the offsets are shared.
#define GS_BATCH_ENTRY(NAME, T, M)                                            \
  int NAME(const void* const* in, void* const* out, const void* params,       \
           const void* const* face_ptrs, const void* maps,                    \
           const double* bounds, int mode, const void* keys, int members,     \
           uint32_t step0, int ox, int oy, int oz, uint32_t row, int nx,      \
           int ny, int nz, int fuse, int use_noise, void* stream) {           \
    return launch<T, M>(in, out, params, face_ptrs, maps, bounds, mode, 0u,   \
                        0u, static_cast<const uint32_t*>(keys), members,      \
                        step0, ox, oy, oz, row, nx, ny, nz, fuse, use_noise,  \
                        stream);                                              \
  }

#ifndef GS_ENVELOPE_PROBES
// The attributes of the instance an entry point launches in `mode` at
// depth `fuse` (entry: 0 f32, 1 f64, 2 bf16, 3 f32_mid_bf16; mode as the
// entry points take it) into `out` (7 ints, attributes_of). Returns 0 or
// the CUDA error. Launches nothing.
int gs_kernel_attributes(int entry, int mode, int fuse, int* out) {
  if (fuse < 1 || out == nullptr || mode < kBlock || mode > kXChain) {
    return (int)cudaErrorInvalidValue;
  }
  switch (entry) {
    case 1:
      return attributes_by_mode<double, double>(mode, fuse, out);
    case 2:
      return attributes_by_mode<__nv_bfloat16, __nv_bfloat16>(mode, fuse,
                                                              out);
    case 3:
      return attributes_by_mode<float, __nv_bfloat16>(mode, fuse, out);
    default:
      return attributes_by_mode<float, float>(mode, fuse, out);
  }
}

GS_ENTRY(gs_stencil_chain_f32, float, float)
GS_ENTRY(gs_stencil_chain_f64, double, double)
GS_ENTRY(gs_stencil_chain_bf16, __nv_bfloat16, __nv_bfloat16)
GS_ENTRY(gs_stencil_chain_f32_mid_bf16, float, __nv_bfloat16)
GS_BATCH_ENTRY(gs_stencil_batch_f32, float, float)
GS_BATCH_ENTRY(gs_stencil_batch_f64, double, double)
GS_BATCH_ENTRY(gs_stencil_batch_bf16, __nv_bfloat16, __nv_bfloat16)
GS_BATCH_ENTRY(gs_stencil_batch_f32_mid_bf16, float, __nv_bfloat16)
#else
// The envelope probes' library (Gray-Scott, float32 fields) holds these
// two entry points instead. in, out: host arrays of kNF device
// pointers; maps as for the production entry points; bounds: a host
// array of kNF boundary values; the copy walk reads no params. variant:
// kComputeWalk's Variant.
int gs_envelope_copy_walk_f32(const void* const* in, void* const* out,
                              const void* maps, const double* bounds, int nx,
                              int ny, int nz, int fuse, void* stream) {
  return probe(kCopyWalk, kChain, in, out, nullptr, maps, bounds, 0, 0, 0, 0,
               nx, ny, nz, fuse, 0, stream);
}

int gs_envelope_compute_walk_f32(const void* const* in, void* const* out,
                                 const void* params, const void* maps,
                                 const double* bounds, int variant,
                                 uint32_t k0, uint32_t k1, uint32_t step0,
                                 uint32_t row, int nx, int ny, int nz,
                                 int fuse, int use_noise, void* stream) {
  return probe(kComputeWalk, variant, in, out, params, maps, bounds, k0, k1,
               step0, row, nx, ny, nz, fuse, use_noise, stream);
}
#endif  // GS_ENVELOPE_PROBES

}  // extern "C"
