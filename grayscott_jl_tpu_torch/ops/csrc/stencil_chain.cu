// stencil_chain.cu — fused Gray-Scott stencil + reaction + noise chain
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel grayscott_jl_tpu/ops/pallas_stencil.py
// (_make_kernel, launched by _fused_call through pl.pallas_call) in the
// modes the float32/float64 Gray-Scott path runs. One launch advances
// every cell of the block `fuse` explicit-Euler steps. A template
// argument selects the mode:
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
//
// What bounds it: device-memory bytes. A step reads and writes two
// fields, 16 B/cell for float (32 B/cell for double), against ~30
// floating-point operations and one 32-bit hash per cell. The design
// answer is temporal blocking in shared memory: each block loads its
// tile plus a `fuse`-cell halo once, advances it `fuse` steps on-chip,
// and writes the interior once, so the bytes per step fall ~1/fuse
// while the halo is recomputed (the window shrinks one cell per side in
// x, y and z per stage). The face modes add only the face bytes, read
// once where the window crosses the block's edge.
//
// Design, per block of NTHREADS threads:
//   * the block owns an interior tile of TX x TY x TZ cells (z is the
//     contiguous axis); stage 0 loads the tile plus `fuse` halo cells
//     per side of both fields into shared memory. A window cell outside
//     the block reads, by mode: the field's frozen boundary value
//     (kBlock; the reference's pad_with_boundary); the face of the one
//     axis it lies across (kFaces6; edge and corner ghosts are never
//     read by the 7-point stencil and hold the boundary value); the
//     lo/hi x slab for x in [-k, 0) and [nx, nx + k) (kXChain; beyond
//     the operand's own y and z extent it reads the boundary value, as
//     the reference's _xla_xchain_fallback re-pads y and z each stage);
//   * stage s computes step step0 + s on the window shrunk by s + 1
//     cells per side, reading one ping-pong buffer and writing the
//     other. kBlock and kFaces6 compute the block's cells and pin every
//     other cell to the boundary value. kXChain computes every cell of
//     the operand's y/z extent, so an interior shard recomputes its
//     neighbour's ring, and pins a mid-stage cell only when its GLOBAL
//     coordinate (offset + local) falls outside [0, row) on any axis;
//     every value is stored as T, so each stage equals one single step
//     bit for bit;
//   * the last stage writes the tile's block cells to global memory,
//     unpinned (pad cells of a non-divisible grid are re-pinned by the
//     caller, as in the reference).
// Blocks are independent and use no atomics: results are deterministic.
//
// Shared memory: 2 fields x 2 buffers x (TX+2f)(TY+2f)(TZ+2f) x
// sizeof(T) — 217,728 B for float at fuse = 5, above the 48 KB static
// limit, so it is dynamic shared memory enabled per launch with
// cudaFuncSetAttribute. The Python ledger (ops/cuda_stencil.py,
// smem_bytes / max_feasible_fuse) caps fuse from the same arithmetic;
// the face modes use the same window.
//
// Numerics: every product and sum is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, ...) and the file is built with --fmad=false,
// so the kernel performs the same IEEE operations, in the same order,
// as the plain torch version (ops/stencil.py, models/grayscott.py) and
// equals it bitwise. The noise is the position-keyed lowbias32 stream
// of ops/noise.py, evaluated per cell at its global coordinate and
// absolute step (a negative coordinate wraps as uint32, as in the
// torch version), so halo cells recomputed by a neighbouring block or
// shard draw the owner's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 8;
constexpr int TY = 8;
constexpr int TZ = 32;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

enum Mode { kBlock = 0, kFaces6 = 1, kXChain = 2 };

// Face operands, field-major (lo, hi) pairs in the reference's order:
// kFaces6 — u_xlo, u_xhi, v_xlo, v_xhi, u_ylo, u_yhi, v_ylo, v_yhi,
//           u_zlo, u_zhi, v_zlo, v_zhi, shaped (1,ny,nz), (nx,1,nz),
//           (nx,ny,1);
// kXChain — u_xlo, u_xhi, v_xlo, v_xhi, each (fuse, ny, nz).
template <typename T>
struct Faces {
  const T* p[12];
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

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

template <typename T>
struct GsParams {
  T Du, Dv, F, k, dt, noise, Fk;
};

// models/grayscott.py reaction, operation for operation.
template <typename T>
__device__ __forceinline__ void grayscott_reaction(
    T u, T v, T lap_u, T lap_v, T noise_u, const GsParams<T>& p,
    T& du, T& dv) {
  const T uvv = mul(mul(u, v), v);
  du = add(add(sub(mul(p.Du, lap_u), uvv), mul(p.F, sub(T(1), u))), noise_u);
  dv = sub(add(mul(p.Dv, lap_v), uvv), mul(p.Fk, v));
}

// (x-1, x+1, y-1, y+1, z-1, z+1) summed left to right, then * (1/6) - c:
// ops/stencil.py laplacian.
template <typename T>
__device__ __forceinline__ T lap7(const T* w, int c, int sx, int sy, T inv6) {
  const T total = add(add(add(add(add(w[c - sx], w[c + sx]), w[c - sy]),
                                  w[c + sy]), w[c - 1]), w[c + 1]);
  return sub(mul(total, inv6), w[c]);
}

__device__ __forceinline__ bool outside(int g, int row) {
  return g < 0 || g >= row;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(NTHREADS)
stencil_chain_kernel(const T* __restrict__ u_in, const T* __restrict__ v_in,
                     T* __restrict__ u_out, T* __restrict__ v_out,
                     const T* __restrict__ params, const Faces<T> faces,
                     uint32_t k0, uint32_t k1, uint32_t step0, int ox,
                     int oy, int oz, uint32_t row, int nx, int ny, int nz,
                     int fuse, int use_noise, T bu, T bv) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int h = fuse;
  const int WX = TX + 2 * h, WY = TY + 2 * h, WZ = TZ + 2 * h;
  const int wvol = WX * WY * WZ;
  const int sx = WY * WZ, sy = WZ;
  const int irow = (int)row;
  // buf[b][f]: ping-pong buffer b of field f (0 = u, 1 = v).
  T* buf[2][2] = {{smem, smem + wvol}, {smem + 2 * wvol, smem + 3 * wvol}};

  // Window origin in block coordinates (may be negative).
  const int x0 = blockIdx.z * TX - h;
  const int y0 = blockIdx.y * TY - h;
  const int z0 = blockIdx.x * TZ - h;

  GsParams<T> p;
  p.Du = params[0];
  p.Dv = params[1];
  p.F = params[2];
  p.k = params[3];
  p.dt = params[4];
  p.noise = params[5];
  p.Fk = add(p.F, p.k);
  const T inv6 = T(1.0 / 6.0);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // Stage 0 input: the full window; cells outside the block per mode.
  for (int r = warp; r < WX * WY; r += NWARPS) {
    const int wx = r / WY, wy = r % WY;
    const int gx = x0 + wx, gy = y0 + wy;
    const bool in_x = gx >= 0 && gx < nx;
    const bool in_y = gy >= 0 && gy < ny;
    const size_t base = in_x && in_y ? ((size_t)gx * ny + gy) * nz : 0;
    for (int wz = lane; wz < WZ; wz += 32) {
      const int gz = z0 + wz;
      const bool in_z = gz >= 0 && gz < nz;
      const int c = r * WZ + wz;
      T a = bu, b = bv;
      if (in_x && in_y && in_z) {
        a = u_in[base + gz];
        b = v_in[base + gz];
      } else if (MODE == kFaces6) {
        // A ghost across exactly one axis reads that axis's face. The
        // face pointers are picked with constant indices: a computed
        // index into the parameter struct would copy it to local memory
        // in every thread.
        if (in_y && in_z && (gx == -1 || gx == nx)) {
          const size_t i = (size_t)gy * nz + gz;
          a = (gx < 0 ? faces.p[0] : faces.p[1])[i];
          b = (gx < 0 ? faces.p[2] : faces.p[3])[i];
        } else if (in_x && in_z && (gy == -1 || gy == ny)) {
          const size_t i = (size_t)gx * nz + gz;
          a = (gy < 0 ? faces.p[4] : faces.p[5])[i];
          b = (gy < 0 ? faces.p[6] : faces.p[7])[i];
        } else if (in_x && in_y && (gz == -1 || gz == nz)) {
          const size_t i = (size_t)gx * ny + gy;
          a = (gz < 0 ? faces.p[8] : faces.p[9])[i];
          b = (gz < 0 ? faces.p[10] : faces.p[11])[i];
        }
      } else if (MODE == kXChain) {
        // The k-deep x slabs extend the operand in x only.
        if (in_y && in_z && gx >= -fuse && gx < nx + fuse) {
          const bool lo = gx < 0;
          const size_t i =
              ((size_t)(lo ? gx + fuse : gx - nx) * ny + gy) * nz + gz;
          a = (lo ? faces.p[0] : faces.p[1])[i];
          b = (lo ? faces.p[2] : faces.p[3])[i];
        }
      }
      buf[0][0][c] = a;
      buf[0][1][c] = b;
    }
  }
  __syncthreads();

  for (int s = 0; s < fuse; ++s) {
    const T* cu = buf[s & 1][0];
    const T* cv = buf[s & 1][1];
    T* nu = buf[(s + 1) & 1][0];
    T* nv = buf[(s + 1) & 1][1];
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
          use_noise ? plane_seed(k0, k1, step, (uint32_t)(ox + gx)) : 0u;
      const uint32_t iy = (uint32_t)(oy + gy);
      const size_t gbase = last ? ((size_t)gx * ny + gy) * nz : 0;
      for (int wz = lo + lane; wz < lo + ez; wz += 32) {
        const int gz = z0 + wz;
        const bool in_z = gz >= 0 && gz < nz;
        if (last && !in_z) continue;
        bool compute = rows && in_z;
        if (MODE == kXChain && !last) {
          compute = compute && !outside(oz + gz, irow);
        }
        const int c = (wx * WY + wy) * WZ + wz;
        T ru = bu, rv = bv;  // pinned cells hold the boundary value
        if (compute) {
          const T u = cu[c], v = cv[c];
          const T lap_u = lap7(cu, c, sx, sy, inv6);
          const T lap_v = lap7(cv, c, sx, sy, inv6);
          T noise_u = T(0);
          if (use_noise) {
            const uint32_t bits =
                hash32(cell_hash(iy, (uint32_t)(oz + gz), row) ^ pseed);
            noise_u = mul(p.noise, (T)bits_to_pm1(bits));
          }
          T du, dv;
          grayscott_reaction(u, v, lap_u, lap_v, noise_u, p, du, dv);
          ru = add(u, mul(du, p.dt));
          rv = add(v, mul(dv, p.dt));
        }
        if (last) {
          u_out[gbase + gz] = ru;
          v_out[gbase + gz] = rv;
        } else {
          nu[c] = ru;
          nv[c] = rv;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
size_t smem_bytes(int fuse) {
  return (size_t)4 * (TX + 2 * fuse) * (TY + 2 * fuse) * (TZ + 2 * fuse) *
         sizeof(T);
}

template <typename T, int MODE>
int run(const T* u_in, const T* v_in, T* u_out, T* v_out, const T* params,
        const Faces<T>& faces, uint32_t k0, uint32_t k1, uint32_t step0,
        int ox, int oy, int oz, uint32_t row, int nx, int ny, int nz,
        int fuse, int use_noise, T bu, T bv, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(fuse);
  cudaError_t err = cudaFuncSetAttribute(
      stencil_chain_kernel<T, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nx + TX - 1) / TX);
  stencil_chain_kernel<T, MODE><<<grid, NTHREADS, smem, stream>>>(
      u_in, v_in, u_out, v_out, params, faces, k0, k1, step0, ox, oy, oz,
      row, nx, ny, nz, fuse, use_noise, bu, bv);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* u_in, const void* v_in, void* u_out, void* v_out,
           const void* params, const void* const* face_ptrs, int mode,
           uint32_t k0, uint32_t k1, uint32_t step0, int ox, int oy, int oz,
           uint32_t row, int nx, int ny, int nz, int fuse, int use_noise,
           T bu, T bv, void* stream) {
  const int n_faces = mode == kFaces6 ? 12 : mode == kXChain ? 4 : 0;
  if (fuse < 1 || nx < 1 || ny < 1 || nz < 1 || mode < kBlock ||
      mode > kXChain || (mode == kFaces6 && fuse != 1) ||
      (n_faces > 0 && face_ptrs == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Faces<T> faces = {};
  for (int i = 0; i < n_faces; ++i) {
    faces.p[i] = static_cast<const T*>(face_ptrs[i]);
  }
  const T* ui = static_cast<const T*>(u_in);
  const T* vi = static_cast<const T*>(v_in);
  T* uo = static_cast<T*>(u_out);
  T* vo = static_cast<T*>(v_out);
  const T* pv = static_cast<const T*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFaces6:
      return run<T, kFaces6>(ui, vi, uo, vo, pv, faces, k0, k1, step0, ox,
                             oy, oz, row, nx, ny, nz, fuse, use_noise, bu,
                             bv, st);
    case kXChain:
      return run<T, kXChain>(ui, vi, uo, vo, pv, faces, k0, k1, step0, ox,
                             oy, oz, row, nx, ny, nz, fuse, use_noise, bu,
                             bv, st);
    default:
      return run<T, kBlock>(ui, vi, uo, vo, pv, faces, k0, k1, step0, ox,
                            oy, oz, row, nx, ny, nz, fuse, use_noise, bu,
                            bv, st);
  }
}

}  // namespace

extern "C" {

// The interior tile (x, y, z); the Python ledger checks it agrees.
void gs_tile_shape(int* out) {
  out[0] = TX;
  out[1] = TY;
  out[2] = TZ;
}

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// face_ptrs: a host array of device pointers (12 for mode 1, 4 for
// mode 2), or NULL for mode 0.
int gs_stencil_chain_f32(const void* u_in, const void* v_in, void* u_out,
                         void* v_out, const void* params,
                         const void* const* face_ptrs, int mode, uint32_t k0,
                         uint32_t k1, uint32_t step0, int ox, int oy, int oz,
                         uint32_t row, int nx, int ny, int nz, int fuse,
                         int use_noise, float bu, float bv, void* stream) {
  return launch<float>(u_in, v_in, u_out, v_out, params, face_ptrs, mode, k0,
                       k1, step0, ox, oy, oz, row, nx, ny, nz, fuse,
                       use_noise, bu, bv, stream);
}

int gs_stencil_chain_f64(const void* u_in, const void* v_in, void* u_out,
                         void* v_out, const void* params,
                         const void* const* face_ptrs, int mode, uint32_t k0,
                         uint32_t k1, uint32_t step0, int ox, int oy, int oz,
                         uint32_t row, int nx, int ny, int nz, int fuse,
                         int use_noise, double bu, double bv, void* stream) {
  return launch<double>(u_in, v_in, u_out, v_out, params, face_ptrs, mode,
                        k0, k1, step0, ox, oy, oz, row, nx, ny, nz, fuse,
                        use_noise, bu, bv, stream);
}

}  // extern "C"
