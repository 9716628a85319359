"""minio_tpu_torch pipeline and batching codec on the CPU, held byte for byte
against the JAX package's ErasurePipeline and HostCodec.

The production shape: B = 2 blocks of K = 12 data shards, M = 4 parity, each
shard S = ceil(1 MiB / 12) = 87,382 bytes. Inputs come from numpy
generators; tolerance is exact equality (shard bytes and digests are an
on-disk format).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minio_tpu.models.pipeline import ErasurePipeline as JaxPipeline
from minio_tpu.models.pipeline import Geometry as JaxGeometry
from minio_tpu.object.codec import HostCodec as JaxHostCodec
from minio_tpu_torch.models.pipeline import ErasurePipeline, Geometry, kernel_status
from minio_tpu_torch.object import codec as codec_mod
from minio_tpu_torch.object.codec import DeviceCodec, default_codec
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

K, M = 12, 4
S = -(-(1 << 20) // K)
LOST = (0, 5, 13)


@pytest.fixture(scope="module")
def shards():
    return np.random.default_rng(2024).integers(0, 256, (2, K, S), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_encoded(shards):
    all_shards, digests = JaxPipeline(JaxGeometry(K, M)).encode(shards)
    return np.asarray(all_shards), np.asarray(digests)


@pytest.fixture(scope="module")
def port_pipe():
    return ErasurePipeline(Geometry(K, M), device="cpu")


def test_encode_matches_jax_pipeline(shards, jax_encoded, port_pipe):
    all_shards, digests = port_pipe.encode(shards)
    np.testing.assert_array_equal(all_shards.numpy(), jax_encoded[0])
    np.testing.assert_array_equal(digests.numpy(), jax_encoded[1])


def test_encode_parity_matches_jax_pipeline(shards, jax_encoded, port_pipe):
    parity = port_pipe.encode_parity(torch.from_numpy(shards))
    np.testing.assert_array_equal(parity.numpy(), jax_encoded[0][:, K:])


def test_reconstruct_matches_jax_pipeline(jax_encoded, port_pipe):
    full, digests = jax_encoded
    present = tuple(i not in LOST for i in range(K + M))
    surv = full[:, [i for i in range(K + M) if present[i]][:K]]
    jax_rebuilt, _ = JaxPipeline(JaxGeometry(K, M)).reconstruct(surv, present, LOST, with_digests=False)
    rebuilt, rebuilt_digests = port_pipe.reconstruct(surv, present, LOST)
    np.testing.assert_array_equal(rebuilt.numpy(), np.asarray(jax_rebuilt))
    np.testing.assert_array_equal(rebuilt.numpy(), full[:, list(LOST)])
    np.testing.assert_array_equal(rebuilt_digests.numpy(), digests[:, list(LOST)])
    no_digests = port_pipe.reconstruct(surv, present, LOST, with_digests=False)
    assert no_digests[1] is None
    np.testing.assert_array_equal(no_digests[0].numpy(), full[:, list(LOST)])


def test_verify_digests_matches_jax_pipeline(jax_encoded, port_pipe):
    full, digests = jax_encoded
    np.testing.assert_array_equal(port_pipe.verify_digests(full[:, :6]).numpy(), digests[:, :6])


def test_cuda_without_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    # Whatever an earlier test in this process installed as the default is
    # not this test's subject: default_codec() must build the cuda codec.
    monkeypatch.setattr(codec_mod, "_default", None)
    with pytest.raises(RuntimeError):
        ErasurePipeline(Geometry(K, M))
    with pytest.raises(RuntimeError):
        BatchingDeviceCodec()
    with pytest.raises(RuntimeError):
        default_codec()


def test_kernel_status_reports_both_kernels():
    st = kernel_status(K, M)
    assert set(st["launches"]) == {"rs_gf_apply", "hh256"}
    assert st["xor_schedule"]["scheduled_xors"] > 0


def _images(group) -> list[bytes]:
    return [b"".join(bytes(v) for v in row) for row in group.iovecs]


def test_batching_encode_group_matches_host_codec(monkeypatch):
    rng = np.random.default_rng(7)
    blocks = [
        rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes(),
        rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes(),
        rng.integers(0, 256, 5 << 10, dtype=np.uint8).tobytes(),
        rng.integers(0, 256, 100, dtype=np.uint8).tobytes(),
    ]
    # max_batch=2 closes each batch when both full blocks, and both short
    # ones, are in, however slowly a loaded host queues them.
    monkeypatch.setenv("MTPU_BATCH_WAIT_US", "5000000")
    codec = BatchingDeviceCodec(max_batch=2, batch_timeout_s=5.0, device="cpu")
    try:
        got = codec.encode_group(blocks, K, M)
        st = codec.stats()
    finally:
        codec.close()
    want = JaxHostCodec().encode_group(blocks, K, M)
    assert _images(got) == _images(want)
    assert bytes(got.digest_stream) == bytes(want.digest_stream)
    assert st["batches_run"] == 1 and st["blocks_encoded"] == 2 and st["blocks_padded"] == 2
    # The 100-byte block joins the 5 KiB one in the small batch: no block
    # goes to the host codec.
    assert st["small_batches_run"] == 1 and st["small_blocks_encoded"] == 2
    assert st["host_fallback_blocks"] == 0
    assert codec.queue_depths() == {f"{K}x{M}": 0, f"{K}x{M}-small": 0}


def test_batching_reconstruct_and_digests_match_host_codec(jax_encoded):
    full, digests = jax_encoded
    rows_batch = [
        [None if i in LOST else full[b, i].tobytes() for i in range(K + M)] for b in range(2)
    ]
    codec = BatchingDeviceCodec(device="cpu")
    try:
        got = codec.reconstruct_batch(rows_batch, K, M, LOST, with_digests=True)
        chunks = [full[b, i].tobytes() for b in range(2) for i in range(2)]
        got_digests = codec.digests_batch(chunks)
        few_digests = codec.digests_batch(chunks[:3])  # fewer than 4: on the device too
        st = codec.stats()
    finally:
        codec.close()
    want = JaxHostCodec().reconstruct_batch(rows_batch, K, M, LOST, with_digests=True)
    assert got == want
    assert got_digests == JaxHostCodec().digests_batch(chunks)
    assert few_digests == got_digests[:3]
    assert st["recon_batches_run"] == 1 and st["blocks_reconstructed"] == 2
    assert st["verify_batches_run"] == 2 and st["digests_verified"] == 7
    assert st["host_fallback_digest_chunks"] == 0 and st["host_fallback_recon_blocks"] == 0


def test_device_codec_matches_host_codec():
    rng = np.random.default_rng(17)
    blocks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (5 << 10, 100, 40 << 10)]
    codec = DeviceCodec(device="cpu")
    assert codec.encode(blocks, K, M) == JaxHostCodec().encode(blocks, K, M)
    assert codec.encode([], K, M) == []
    shard_rows = [JaxHostCodec().encode([blocks[2]] * 2, K, M)[i][0] for i in range(2)]
    rows_batch = [[None if j in LOST else row[j] for j in range(K + M)] for row in shard_rows]
    got = codec.reconstruct_batch(rows_batch, K, M, LOST, with_digests=True)
    assert got == JaxHostCodec().reconstruct_batch(rows_batch, K, M, LOST, with_digests=True)
