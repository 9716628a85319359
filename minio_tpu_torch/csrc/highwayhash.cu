// HighwayHash-256 (the frozen Jan-2017 spec, the bitrot hash) of N
// equal-length byte streams on Hopper (sm_90a): x [N, L] u8 -> out [N, 32] u8.
//
// Replaces the TPU kernel minio_tpu/ops/highwayhash_pallas.py::_kernel
// (launched by _run_chain), which ran only the 32-byte packet chain with u64
// emulated as (lo, hi) u32 pairs and left the remainder packets, the tail
// packet, the 10 permute rounds and the modular reduction to an XLA epilogue.
// Here one launch runs all of it, in native u64.
//
// Bound: the hash reads N*L bytes once, so the card's memory rate bounds the
// work. What holds the kernel back is latency. The hash is sequential within
// a stream, so each thread carries a dependent chain of 64-bit adds, 32x32->64
// multiplies and byte permutes per 32-byte packet, and rows lie L bytes apart,
// so per-thread global loads of a packet neither coalesce nor arrive in time.
// The design:
//
// - Two threads per stream, one lane pair each. The packet update never mixes
//   lanes {0,1} with lanes {2,3} (the zipper merges within a pair), nor does
//   the modular reduction, so each thread keeps v0/v1/mul0/mul1 for its two
//   lanes (8 x u64) and reads its 16 bytes of each packet. The threads of a
//   pair exchange v0 lanes only in the 10 permute rounds (__shfl_xor_sync).
//   This halves the chain a thread carries and doubles the threads.
// - Data staged through shared memory. A block is one warp and owns 16
//   streams. It copies each stream's next 512-byte chunk (16 packets) as
//   16-byte cp.async granules into a ring of 4 stages, so 3 chunks (48
//   packets per stream) are in flight while the threads hash the current one
//   from shared memory. The two threads of a stream copy alternate granules.
//   Rows start at any byte alignment (L = 87,382 is 6 mod 16, and views add
//   offsets), so a chunk is copied as the aligned granules that cover it
//   (only those holding a byte of the row; 33 at most) and each thread shifts
//   its 16 bytes out of 5 aligned shared-memory words with funnel shifts. A
//   stream's stage buffer is 33 granules (528 B, 4 banks past a multiple of
//   32), which spreads the 16 streams' reads over the banks.
// - Small blocks spread wide: N = 1,024 streams make 64 one-warp blocks on 64
//   SMs; the GET verify batch (N = 16) is one block.
// - The zipper merge is six __byte_perm (PRMT) per lane pair.
//
// The remaining floor is the chain itself: packets per stream x cycles per
// packet of one warp's dependent chain (PERF.md, minio_tpu_torch/tools/
// hh256_probe.py measures it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStreams = 16;                   // streams per block
constexpr int kThreads = 2 * kStreams;         // one warp: a thread per lane pair
constexpr int kChunk = 512;                    // row bytes per stream per stage
constexpr int kPackets = kChunk / 32;          // packets per chunk
constexpr int kGranules = kChunk / 16 + 1;     // granules covering an unaligned chunk
constexpr int kSpan = 16 * kGranules;          // stage bytes per stream (528)
constexpr int kStages = 4;                     // a power of two
constexpr int kStageBytes = kStreams * kSpan;  // 8,448; the ring is 33,792 B

__constant__ uint64_t kInit0[4] = {0xDBE6D5D5FE4CCE2FULL, 0xA4093822299F31D0ULL,
                                   0x13198A2E03707344ULL, 0x243F6A8885A308D3ULL};
__constant__ uint64_t kInit1[4] = {0x3BD39E10CB0EF593ULL, 0xC0ACF169B5F18A8CULL,
                                   0xBE5466CF34E90C6CULL, 0x452821E638D01377ULL};

// One thread's half of the state: lanes 2h and 2h+1 of v0, v1, mul0, mul1.
struct Pair {
  uint64_t v0[2], v1[2], mul0[2], mul1[2];
};

__device__ __forceinline__ uint32_t lo32(uint64_t x) { return static_cast<uint32_t>(x); }
__device__ __forceinline__ uint32_t hi32(uint64_t x) { return static_cast<uint32_t>(x >> 32); }
__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}
__device__ __forceinline__ uint64_t rot32(uint64_t x) { return join(hi32(x), lo32(x)); }

// Zipper-merge terms of one (even a, odd b) lane pair (ops/highwayhash.py::
// _zipper_merge). With a = bytes a0..a7 and b = b0..b7 (little-endian), the
// even term is [a3 b4 a2 a5 b6 a1 b7 a0] and the odd term [b3 a4 b2 b5 b1 a6
// b0 a7]: two byte permutes for each low word, one for each high word.
__device__ __forceinline__ void zipper(uint64_t a, uint64_t b, uint64_t& e, uint64_t& o) {
  const uint32_t al = lo32(a), ah = hi32(a), bl = lo32(b), bh = hi32(b);
  e = join(__byte_perm(__byte_perm(al, ah, 0x5203), bh, 0x3240), __byte_perm(al, bh, 0x0716));
  o = join(__byte_perm(__byte_perm(bl, bh, 0x5203), ah, 0x3240), __byte_perm(bl, ah, 0x7061));
}

__device__ __forceinline__ uint64_t mul32(uint64_t a, uint64_t b) {
  return static_cast<uint64_t>(lo32(a)) * hi32(b);
}

// One packet round on this thread's two lanes; l0, l1 are its packet lanes.
__device__ __forceinline__ void update(Pair& s, uint64_t l0, uint64_t l1) {
  s.v1[0] += s.mul0[0] + l0;
  s.v1[1] += s.mul0[1] + l1;
  s.mul0[0] ^= mul32(s.v1[0], s.v0[0]);
  s.mul0[1] ^= mul32(s.v1[1], s.v0[1]);
  s.v0[0] += s.mul1[0];
  s.v0[1] += s.mul1[1];
  s.mul1[0] ^= mul32(s.v0[0], s.v1[0]);
  s.mul1[1] ^= mul32(s.v0[1], s.v1[1]);
  uint64_t e, o;
  zipper(s.v1[0], s.v1[1], e, o);
  s.v0[0] += e;
  s.v0[1] += o;
  zipper(s.v0[0], s.v0[1], e, o);
  s.v1[0] += e;
  s.v1[1] += o;
}

// Packet words from shared memory: w holds the 5 aligned words covering this
// thread's 16 bytes, which start fs/8 bytes into w[0].
__device__ __forceinline__ void absorb(Pair& s, const uint32_t* w, int fs) {
  const uint32_t a0 = w[0], a1 = w[1], a2 = w[2], a3 = w[3], a4 = w[4];
  update(s, join(__funnelshift_r(a0, a1, fs), __funnelshift_r(a1, a2, fs)),
         join(__funnelshift_r(a2, a3, fs), __funnelshift_r(a3, a4, fs)));
}

__device__ __forceinline__ uint64_t rotate_32_by(uint64_t v, int count) {
  const uint32_t lo = lo32(v), hi = hi32(v);
  return join((lo << count) | (lo >> (32 - count)), (hi << count) | (hi >> (32 - count)));
}

// Byte i of the final packet built from an r-byte tail (0 < r < 32),
// ops/highwayhash.py::_remainder_packet.
__device__ __forceinline__ uint64_t tail_byte(const uint8_t* tail, int r, int i) {
  const int whole = r & ~3;
  if (i < whole) return tail[i];
  if (r & 16) return i >= 28 ? tail[r + i - 32] : 0;
  const int mod4 = r & 3;
  if (mod4 == 0) return 0;
  if (i == 16) return tail[whole];
  if (i == 17) return tail[whole + (mod4 >> 1)];
  if (i == 18) return tail[whole + mod4 - 1];
  return 0;
}

__device__ __forceinline__ void modular_reduction(uint64_t a3u, uint64_t a2, uint64_t a1,
                                                  uint64_t a0, uint64_t* m0, uint64_t* m1) {
  const uint64_t a3 = a3u & 0x3FFFFFFFFFFFFFFFULL;
  *m1 = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
  *m0 = a0 ^ (a2 << 1) ^ (a2 << 2);
}

__device__ __forceinline__ int stage_offset(long long chunk) {
  return static_cast<int>(chunk & (kStages - 1)) * kStageBytes;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copy chunk c of a stream into its stage buffer: the granules from the
// aligned base abase + c*kChunk that hold row bytes [c*kChunk,
// min(L, (c+1)*kChunk)). Thread `half` of the stream takes granules half,
// half + 2, ... Commits one cp.async group per call, empty past the last chunk.
__device__ __forceinline__ void copy_chunk(uint8_t* ring, const uint8_t* abase, int shift,
                                           long long L, long long n_chunks, bool active, int s,
                                           int half, long long c) {
  if (active && c < n_chunks) {
    const long long begin = c * kChunk;
    const long long end = begin + kChunk < L ? begin + kChunk : L;
    const int granules = static_cast<int>((shift + end - begin + 15) >> 4);
    const uint8_t* src = abase + begin + 16 * half;
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(
        ring + stage_offset(c) + s * kSpan + 16 * half));
#pragma unroll
    for (int j = 0; j < (kGranules + 1) / 2; ++j) {
      if (2 * j + half < granules) cp_async16(dst + 32 * j, src + 32 * j);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
hh256_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, long long N, long long L,
             uint64_t k0, uint64_t k1, uint64_t k2, uint64_t k3) {
  __shared__ __align__(16) uint8_t ring[kStages * kStageBytes];
  const int s = threadIdx.x >> 1;    // stream within the block
  const int half = threadIdx.x & 1;  // lanes 2*half, 2*half+1: packet bytes 16*half..+15
  const long long n = static_cast<long long>(blockIdx.x) * kStreams + s;
  const bool active = n < N;

  Pair st;
  {
    const uint64_t key[2] = {half ? k2 : k0, half ? k3 : k1};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      st.v0[i] = kInit0[2 * half + i] ^ key[i];
      st.v1[i] = kInit1[2 * half + i] ^ rot32(key[i]);
      st.mul0[i] = kInit0[2 * half + i];
      st.mul1[i] = kInit1[2 * half + i];
    }
  }

  const uint8_t* row = x + (active ? n : 0) * L;
  const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  const uint8_t* abase = row - shift;
  const long long n_full = L / 32;
  const long long n_chunks = (L + kChunk - 1) / kChunk;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c)
    copy_chunk(ring, abase, shift, L, n_chunks, active, s, half, c);

  // This thread's 16 bytes of a chunk's packet k start shift + 32k + 16*half
  // bytes into its stream's buffer.
  const int rd = s * kSpan + ((shift + 16 * half) & ~3);
  const int fs = 8 * (shift & 3);
  for (long long c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed for every stream; chunk c-1's stage is free
    copy_chunk(ring, abase, shift, L, n_chunks, active, s, half, c + kStages - 1);
    const uint32_t* w =
        reinterpret_cast<const uint32_t*>(ring + stage_offset(c) + rd);
    const long long left = n_full - c * kPackets;
    if (!active) continue;
    if (left >= kPackets) {
#pragma unroll
      for (int k = 0; k < kPackets; ++k) absorb(st, w + 8 * k, fs);
    } else {
      for (int k = 0; k < left; ++k) absorb(st, w + 8 * k, fs);
    }
  }

  const int r = static_cast<int>(L - n_full * 32);
  if (r && active) {
    // The tail lies in the last chunk, still in its stage.
    const long long last = n_chunks - 1;
    const uint8_t* tail = ring + stage_offset(last) + s * kSpan +
                          shift + static_cast<int>(n_full * 32 - last * kChunk);
    uint64_t lanes[2] = {0, 0};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      st.v0[i] += (static_cast<uint64_t>(r) << 32) + static_cast<uint64_t>(r);
      st.v1[i] = rotate_32_by(st.v1[i], r);
#pragma unroll
      for (int j = 0; j < 8; ++j) lanes[i] |= tail_byte(tail, r, 16 * half + 8 * i + j) << (8 * j);
    }
    update(st, lanes[0], lanes[1]);
  }

  // Permute rounds: packet lane j is rot32(v0[j ^ 2]), i.e. the partner
  // thread's v0 lanes.
  for (int round = 0; round < 10; ++round) {
    const uint64_t p0 = __shfl_xor_sync(0xFFFFFFFFu, st.v0[0], 1);
    const uint64_t p1 = __shfl_xor_sync(0xFFFFFFFFu, st.v0[1], 1);
    update(st, rot32(p0), rot32(p1));
  }

  if (!active) return;
  uint64_t h0, h1;
  modular_reduction(st.v1[1] + st.mul1[1], st.v1[0] + st.mul1[0], st.v0[1] + st.mul0[1],
                    st.v0[0] + st.mul0[0], &h0, &h1);
  uint64_t* o = reinterpret_cast<uint64_t*>(out + n * 32 + 16 * half);
  o[0] = h0;
  o[1] = h1;
}

}  // namespace

// x: [N, L] u8 contiguous (any base alignment); out: [N, 32] u8 contiguous
// (8-byte aligned); k0..k3: the 32-byte key as four little-endian u64 lanes.
// Returns the cudaError_t of the launch.
extern "C" int hh256_launch(const uint8_t* x, uint8_t* out, long long N, long long L, uint64_t k0,
                            uint64_t k1, uint64_t k2, uint64_t k3, cudaStream_t stream) {
  if (N == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((N + kStreams - 1) / kStreams);
  hh256_kernel<<<blocks, kThreads, 0, stream>>>(x, out, N, L, k0, k1, k2, k3);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hh256_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
