// Chain probe for csrc/highwayhash.cu: one warp runs the kernel's packet
// update (the same `update`, included from the kernel source) on packet lanes
// held in registers, with no memory traffic, and reads clock64() and
// %globaltimer around the loop. Cycles per packet from this probe, times the
// packets of a stream, over the SM clock, is the floor the hash kernel's
// design leaves: the dependent chain of one lane-pair thread.
//
// Built and run by minio_tpu_torch/tools/hh256_probe.py.

#include "../csrc/highwayhash.cu"

namespace {

constexpr int kUnroll = 16;  // updates per loop trip (PACKETS_PER_TRIP in hh256_probe.py)

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// seed: 8 u64 per thread (v0, v1, mul0, mul1 lanes) + 2 packet lanes, read
// once so nothing is known at compile time. out: per thread {cycles, ns,
// digest}.
__global__ void __launch_bounds__(kThreads)
chain_kernel(const uint64_t* __restrict__ seed, uint64_t* __restrict__ out, long long chunks) {
  const uint64_t* sd = seed + 10 * threadIdx.x;
  Pair st;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.v0[i] = sd[i];
    st.v1[i] = sd[2 + i];
    st.mul0[i] = sd[4 + i];
    st.mul1[i] = sd[6 + i];
  }
  const uint64_t l0 = sd[8], l1 = sd[9];
  __syncwarp();
  const long long c0 = clock64();
  const uint64_t t0 = globaltimer_ns();
  for (long long c = 0; c < chunks; ++c) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) update(st, l0, l1);
  }
  const uint64_t t1 = globaltimer_ns();
  const long long c1 = clock64();
  uint64_t* o = out + 3 * threadIdx.x;
  o[0] = static_cast<uint64_t>(c1 - c0);
  o[1] = t1 - t0;
  o[2] = st.v0[0] ^ st.v0[1] ^ st.v1[0] ^ st.v1[1] ^ st.mul0[0] ^ st.mul0[1] ^ st.mul1[0] ^
         st.mul1[1];
}

}  // namespace

// Runs chunks x kUnroll packet updates on one warp; returns the cudaError_t.
extern "C" int hh256_chain_launch(const uint64_t* seed, uint64_t* out, long long chunks,
                                  cudaStream_t stream) {
  chain_kernel<<<1, kThreads, 0, stream>>>(seed, out, chunks);
  return static_cast<int>(cudaGetLastError());
}
