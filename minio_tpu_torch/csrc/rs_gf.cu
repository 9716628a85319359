// Reed-Solomon GF(2^8) linear map on Hopper (sm_90a):
//
//     out[b, r, s] = XOR_k gfmul(C[r, k], x[b, k, s])
//
// for a runtime coefficient matrix C [R, K]. Encode passes the parity matrix,
// a degraded read passes the reconstruct rows of its loss pattern: one build
// of this file serves every pattern.
//
// Replaces the TPU kernel minio_tpu/ops/rs_pallas.py::_kernel (launched by
// _apply_sched), which ran the same map as a compiled XOR schedule over bit
// planes. A schedule compiled into the kernel would need one build per loss
// pattern, so here the coefficients are data: the host expands C into
// product tables (ops/rs_cuda.py::product_table) that every block copies
// into shared memory once.
//
// Bound: the map reads B*K*S bytes and writes B*R*S, so the card's memory
// rate (3.35 TB/s) bounds it. The design:
//
// - 16-byte global access at any row alignment. Rows start at any byte
//   (S = ceil(1 MiB / 12) = 87,382 is 6 mod 16, and the fused encode passes
//   views), but a row's base offset mod 16 is the same for every lane of a
//   warp. A warp owns 512 consecutive positions of a row per tile, 16 per
//   lane. It copies the 33 aligned 16-byte granules that cover a tile of an
//   input row into a per-warp cp.async ring in shared memory (only granules
//   that hold a byte of the row: CUDA allocations are >= 256-byte aligned,
//   so those never leave the allocation). The ring has two stages of four
//   rows: one in flight while the warp reads the other. That leaves room for
//   28 warps an SM, which measured faster than deeper rings with fewer warps
//   (PERF.md).
//   A lane reads granules t and t+1 of a row and funnel-shifts its 16 bytes
//   out of them. Output runs the other way: lane t assembles the aligned
//   output granule holding its first byte from lane t-1's last bytes
//   (__shfl_up_sync) and its own, and writes one uint4. A warp walks a
//   contiguous span of tiles and carries its last lane's bytes to the next
//   tile's first lane through shared memory, so only the two granules at a
//   span's edges take narrow stores (aligned 8/4/2/1-byte pieces).
//   Neighbouring spans write disjoint bytes of a shared edge granule.
// - Four output rows per lookup: table word [g][k][v] packs gfmul(C[4g+j][k],
//   v) in byte j, so one shared-memory load per input byte serves four output
//   rows; the 16 per-position accumulators are turned into four rows of 16
//   bytes by 4x4 byte transposes (__byte_perm).
// - Persistent grid: as many blocks as fit the card at once, or the work if
//   less. Each block copies the tables once (cp.async), and its warps walk
//   spans of whole tiles, sized so the spans of all batch items fill the
//   resident warps.
//
// What remains between the kernel and its bound is the data path, not the
// lookups: the same kernel without them takes ~94% of its time (PERF.md).
//
// Positions within a row and row offsets within a batch item are 32-bit:
// the wrapper keeps K*S and R*S below 2^31.

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 512;                   // row positions a warp handles per tile, 16 a lane
constexpr int kGranules = kTile / 16 + 1;    // 33 aligned granules cover a tile of a row
constexpr int kRowSpan = 16 * kGranules;     // 528 ring bytes per row per stage
constexpr int kEntries = 256;                // table words per (row group, input row)
constexpr int kRows = 4;                     // input rows a ring stage holds
constexpr int kStages = 2;                   // ring stages a warp: one in flight while one is read
constexpr int kWarps = 4;                    // warps a block, each with its own ring
constexpr int kThreads = 32 * kWarps;
constexpr int kStageBytes = kRows * kRowSpan;
constexpr int kWarpRing = kStages * kStageBytes;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Bytes a..a+15 (0 <= a < 16) of the 32 bytes lo ++ hi. `a` is the same in
// every lane, so the switch does not diverge.
__device__ __forceinline__ uint4 realign(uint4 lo, uint4 hi, int a) {
  uint32_t c0, c1, c2, c3, c4;
  switch (a >> 2) {
    case 0: c0 = lo.x; c1 = lo.y; c2 = lo.z; c3 = lo.w; c4 = hi.x; break;
    case 1: c0 = lo.y; c1 = lo.z; c2 = lo.w; c3 = hi.x; c4 = hi.y; break;
    case 2: c0 = lo.z; c1 = lo.w; c2 = hi.x; c3 = hi.y; c4 = hi.z; break;
    default: c0 = lo.w; c1 = hi.x; c2 = hi.y; c3 = hi.z; c4 = hi.w; break;
  }
  const int sh = 8 * (a & 3);
  return make_uint4(__funnelshift_r(c0, c1, sh), __funnelshift_r(c1, c2, sh),
                    __funnelshift_r(c2, c3, sh), __funnelshift_r(c3, c4, sh));
}

// Bytes [lo, hi) of the 16-byte granule v to its aligned address g, in
// naturally aligned pieces of 1, 2, 4 and 8 bytes (0 <= lo < hi <= 16).
__device__ __forceinline__ void store_bytes(uint8_t* g, uint4 v, int lo, int hi) {
  const uint64_t w0 = (static_cast<uint64_t>(v.y) << 32) | v.x;
  const uint64_t w1 = (static_cast<uint64_t>(v.w) << 32) | v.z;
  auto piece = [&](int i) { return i < 8 ? w0 >> (8 * i) : w1 >> (8 * (i - 8)); };
  int i = lo;
  if ((i & 1) && i + 1 <= hi) { g[i] = static_cast<uint8_t>(piece(i)); i += 1; }
  if ((i & 2) && i + 2 <= hi) { *reinterpret_cast<uint16_t*>(g + i) = static_cast<uint16_t>(piece(i)); i += 2; }
  if ((i & 4) && i + 4 <= hi) { *reinterpret_cast<uint32_t*>(g + i) = static_cast<uint32_t>(piece(i)); i += 4; }
  if ((i & 8) && i + 8 <= hi) { *reinterpret_cast<uint64_t*>(g + i) = piece(i); i += 8; }
  if (i + 8 <= hi) { *reinterpret_cast<uint64_t*>(g + i) = piece(i); i += 8; }
  if (i + 4 <= hi) { *reinterpret_cast<uint32_t*>(g + i) = static_cast<uint32_t>(piece(i)); i += 4; }
  if (i + 2 <= hi) { *reinterpret_cast<uint16_t*>(g + i) = static_cast<uint16_t>(piece(i)); i += 2; }
  if (i + 1 <= hi) g[i] = static_cast<uint8_t>(piece(i));
}

// Byte r of acc[4q + i] is row r's byte at position 4q + i: a 4x4 byte
// transpose per quad gives each row's four words.
__device__ __forceinline__ void transpose(const uint32_t (&acc)[16], uint4 (&o)[4]) {
  uint32_t rows[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t a0 = acc[4 * q], a1 = acc[4 * q + 1], a2 = acc[4 * q + 2], a3 = acc[4 * q + 3];
    const uint32_t t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a0, a1, 0x7362);
    const uint32_t t2 = __byte_perm(a2, a3, 0x5140), t3 = __byte_perm(a2, a3, 0x7362);
    rows[0][q] = __byte_perm(t0, t2, 0x5410);
    rows[1][q] = __byte_perm(t0, t2, 0x7632);
    rows[2][q] = __byte_perm(t1, t3, 0x5410);
    rows[3][q] = __byte_perm(t1, t3, 0x7632);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) o[r] = make_uint4(rows[r][0], rows[r][1], rows[r][2], rows[r][3]);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ int align_of(const uint8_t* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

__global__ void __launch_bounds__(kThreads)
rs_gf_apply_kernel(const uint8_t* __restrict__ x, long long x_bstride,
                   const uint32_t* __restrict__ table, uint8_t* __restrict__ out,
                   long long out_bstride, int K, int R, int S, int span_tiles, int spans_per_row,
                   long long items) {
  extern __shared__ uint4 smem[];
  const int G = (R + 3) / 4;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);                       // [G][K][256]
  uint8_t* ring = reinterpret_cast<uint8_t*>(tab + G * K * kEntries);      // [kWarps][kWarpRing]
  uint4* carry = reinterpret_cast<uint4*>(ring + kWarps * kWarpRing);      // [kWarps][2][4]

  {
    const uint32_t tab_s = static_cast<uint32_t>(__cvta_generic_to_shared(tab));
    for (int i = threadIdx.x; i < G * K * kEntries / 4; i += kThreads) cp_async16(tab_s + 16 * i, table + 4 * i);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint8_t* wring = ring + warp * kWarpRing;
  const uint32_t wring_s = static_cast<uint32_t>(__cvta_generic_to_shared(wring));
  const int nb = (K + kRows - 1) / kRows;  // row batches, one ring stage each
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long item = static_cast<long long>(blockIdx.x) * kWarps + warp; item < items;
       item += n_warps) {
    const long long b = item / spans_per_row;
    const int begin = static_cast<int>(item - b * spans_per_row) * span_tiles * kTile;
    const int end = min(S, begin + span_tiles * kTile);
    const uint8_t* xb = x + b * x_bstride;
    uint8_t* ob = out + b * out_bstride;
    const int tiles = (end - begin + kTile - 1) / kTile;
    const int steps = G * tiles * nb;  // (row group, tile, row batch), in that order

    // Load cursor: the row batch lj and tile lt0 of step ls.
    int ls = 0, lj = 0, lt0 = begin;
    auto load_next = [&]() {
      if (ls < steps) {
        const uint32_t dst = wring_s + (ls % kStages) * kStageBytes;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int k = lj * kRows + i;
          if (k < K) {
            const uint8_t* row = xb + k * S;
            const int g0 = lt0 - align_of(row);  // the aligned granule holding position lt0
            if (g0 + 16 * lane < end) cp_async16(dst + i * kRowSpan + 16 * lane, row + g0 + 16 * lane);
            if (lane == 0 && g0 + kTile < end) cp_async16(dst + i * kRowSpan + kTile, row + g0 + kTile);
          }
        }
        ++ls;
        if (++lj == nb) {
          lj = 0;
          lt0 += kTile;
          if (lt0 >= end) lt0 = begin;
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) load_next();

    int parity = 0, j = 0, g = 0, t0 = begin;
    uint32_t acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0;
    for (int step = 0; step < steps; ++step) {
      cp_async_wait<kStages - 2>();
      __syncwarp();  // this step's granules landed for every lane; the last step's stage is free
      load_next();
      const uint8_t* stage = wring + (step % kStages) * kStageBytes;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int k = j * kRows + i;
        if (k < K) {
          const uint4* src = reinterpret_cast<const uint4*>(stage + i * kRowSpan);
          const uint4 w = realign(src[lane], src[lane + 1], align_of(xb + k * S));
          const uint32_t* t = tab + (g * K + k) * kEntries;
          const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const uint32_t v = (ws[q >> 2] >> (8 * (q & 3))) & 0xFF;
            acc[q] ^= t[v];
          }
        }
      }
      if (++j < nb) continue;
      j = 0;

      // The tile's last row batch is in: write its (up to) four output rows.
      const int p = t0 + 16 * lane;  // this lane's first position
      uint4 o[4];
      transpose(acc, o);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0;
      uint4* carry_in = carry + (warp * 2 + (parity ^ 1)) * 4;
      uint4* carry_out = carry + (warp * 2 + parity) * 4;
      const int rows = min(4, R - 4 * g);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (r >= rows) break;
        uint8_t* orow = ob + (4 * g + r) * S;
        const int c = align_of(orow);
        // Words [first, 4) of lane t-1's row bytes hold its last c bytes.
        const int first = (16 - c) >> 2;
        uint4 prev = o[r];
        if (first <= 0) prev.x = __shfl_up_sync(kFull, o[r].x, 1);
        if (first <= 1) prev.y = __shfl_up_sync(kFull, o[r].y, 1);
        if (first <= 2) prev.z = __shfl_up_sync(kFull, o[r].z, 1);
        if (first <= 3) prev.w = __shfl_up_sync(kFull, o[r].w, 1);
        if (lane == 0) prev = carry_in[r];  // stale on a span's first tile, where it is not stored
        if (lane == 31) carry_out[r] = o[r];
        // Granule A at position p - c: lane t-1's last c bytes, then this
        // lane's first 16 - c.
        const int ga = p - c;
        if (ga < end) {
          const uint4 va = c ? realign(prev, o[r], 16 - c) : o[r];
          if (ga >= begin && ga + 16 <= end) {
            *reinterpret_cast<uint4*>(orow + ga) = va;
          } else {  // a span edge: only this span's positions
            const int lo = max(ga, begin) - ga;
            const int hi = min(ga + 16, end) - ga;
            if (lo < hi) store_bytes(orow + ga, va, lo, hi);
          }
        }
        // Granule B at p - c + 16: this lane's last c bytes, written by the
        // lane that holds the span's last position.
        if (c && p < end && end <= p + 16 && ga + 16 < end) {
          store_bytes(orow + ga + 16, realign(o[r], make_uint4(0, 0, 0, 0), 16 - c), 0, end - ga - 16);
        }
      }
      parity ^= 1;
      t0 += kTile;
      if (t0 >= end) {
        t0 = begin;
        ++g;
      }
      __syncwarp();  // carry_out written before the next tile reads it
    }
    cp_async_wait<0>();
    __syncwarp();
  }
}

// The kernel's dynamic shared memory limit is an attribute of the function,
// shared by every host thread. Threads launching with different R need
// different amounts: the limit only ever grows (per device, under a lock), so
// no thread lowers it between another's check and launch.
constexpr int kMaxDevices = 64;
std::mutex g_smem_mutex;
size_t g_smem_granted[kMaxDevices] = {};

cudaError_t grant_smem(int device, size_t smem) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_smem_mutex);
  if (smem <= g_smem_granted[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(rs_gf_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err == cudaSuccess) g_smem_granted[device] = smem;
  return err;
}

}  // namespace

// x: [B, K, S] u8 with rows contiguous (any alignment), batch stride x_bstride
// (bytes). table: [ceil(R/4), K, 256] u32 product tables. out: [B, R, S] u8
// with rows contiguous, batch stride out_bstride. K*S and R*S < 2^31.
// Returns the cudaError_t of the launch.
extern "C" int rs_gf_apply_launch(const uint8_t* x, long long x_bstride, const uint32_t* table,
                                  uint8_t* out, long long out_bstride, int B, int K, int R,
                                  long long S, cudaStream_t stream) {
  if (B == 0 || S == 0 || R == 0) return 0;
  const size_t smem = static_cast<size_t>((R + 3) / 4) * K * kEntries * sizeof(uint32_t) +
                      kWarps * (kWarpRing + 8 * sizeof(uint4));
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = grant_smem(device, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rs_gf_apply_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long resident_warps = static_cast<long long>(per_sm) * sms * kWarps;
  const long long tiles = (S + kTile - 1) / kTile;
  // Spans of whole tiles, as short as keeps the warps of all batch items
  // within what the card holds at once.
  const long long span_tiles = (tiles * B + resident_warps - 1) / resident_warps;
  const long long spans_per_row = (tiles + span_tiles - 1) / span_tiles;
  const long long items = spans_per_row * B;
  const long long blocks = std::min((items + kWarps - 1) / kWarps, static_cast<long long>(per_sm) * sms);
  rs_gf_apply_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, x_bstride, table, out, out_bstride, K, R, static_cast<int>(S), static_cast<int>(span_tiles),
      static_cast<int>(spans_per_row), items);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rs_gf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
