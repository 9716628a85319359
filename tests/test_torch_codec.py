"""The port's BlockCodec seam against the JAX package's, and the RS wrapper's
batch range.

``BlockCodec.encode_frames`` (per shard row, the concatenated H(chunk)||chunk
frames of a group of blocks) must equal the JAX package's
``HostCodec.encode_frames`` byte for byte, on full 1 MiB blocks and on short
tail blocks, for the port's host codec and its batching codec on the CPU.

The Reed-Solomon kernel walks a 64-bit item index over a persistent grid, so
its wrapper takes any batch count: the ``cuda`` test runs B = 65,536 at
S = 1 on the card against the plain version (it skips without a GPU).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu_torch.object.codec import HostCodec
from minio_tpu_torch.ops import rs_cuda, rs_matrix
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

K, M = 12, 4


def _blocks(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


@pytest.mark.parametrize(
    "sizes",
    [(1 << 20,), (37,), (200 << 10, 5000), ((1 << 20), 4321)],
    ids=["full", "tiny-tail", "short-blocks", "full-and-tail"],
)
@pytest.mark.parametrize("codec_name", ["host", "batching-cpu"])
def test_encode_frames_equals_the_jax_host_codec(codec_name, sizes):
    blocks = _blocks(sizes, seed=len(sizes) * 1000 + sizes[0] % 997)
    codec = HostCodec() if codec_name == "host" else BatchingDeviceCodec(device="cpu")
    try:
        got = codec.encode_frames(blocks, K, M)
    finally:
        if codec_name != "host":
            codec.close()
    want = JaxHostCodec().encode_frames(blocks, K, M)
    assert len(got) == len(want) == K + M
    for row in range(K + M):
        assert bytes(got[row]) == bytes(want[row]), f"row {row}"


def test_encode_frames_is_the_join_of_encode_group():
    blocks = _blocks((300 << 10, 300 << 10), seed=3)
    codec = HostCodec()
    frames = codec.encode_frames(blocks, K, M)
    group = codec.encode_group(blocks, K, M)
    for row in range(K + M):
        assert bytes(frames[row]) == b"".join(bytes(v) for v in group.iovecs[row])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_rs_kernel_takes_batches_past_65535(cuda_device):
    gen = torch.Generator(device="cpu").manual_seed(65536)
    x = torch.randint(0, 256, (65536, K, 1), dtype=torch.uint8, generator=gen).to(cuda_device)
    pm = rs_matrix.parity_matrix(K, M)
    got = rs_cuda.apply(x, pm)
    assert got.shape == (65536, M, 1)
    assert torch.equal(got, rs_cuda.plain(x, pm))
