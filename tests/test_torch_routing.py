"""The batching codec's routes: no block, reconstruct or digest goes to the
host codec, whatever its size, loss pattern or chunk length.

A test-local spy wraps every method of the port's numpy HostCodec, and the
numpy hash and GF functions it runs, so that each call is recorded;
BatchingDeviceCodec (and DeviceCodec) run the cases under it and must
record none. Their outputs must equal the host codec's bytes, computed
before the spy is installed (tolerance: exact, since shard bytes and digests
are an on-disk format). On the CPU the codecs run the kernels' plain torch
versions; the `cuda`-marked cases run the same on the card, where the plain
versions are spied on too and must not be called either.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from minio_tpu_torch.object.codec import DeviceCodec, HostCodec
from minio_tpu_torch.ops import bitrot, highwayhash_cuda, highwayhash_torch, rs_cuda, rs_ref
from minio_tpu_torch.ops import highwayhash as np_hh
from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

K, M = 12, 4
MiB = 1 << 20
SIZES = {"37B": 37, "3KiB": 3 << 10, "200KiB": 200 << 10, "1MiB+37B": MiB + 37}
LOST = (0, 5, 12, 15)
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _blocks(data: bytes) -> list[bytes]:
    return [data[i : i + MiB] for i in range(0, len(data), MiB)]


class HostSpy:
    """Records every call into the host codec and the numpy functions it
    runs (plus `extra` (owner, name) pairs); the calls still go through."""

    def __init__(self, mp: pytest.MonkeyPatch, extra=()):
        self.calls: list[str] = []
        targets = [
            (HostCodec, n)
            for n in ("encode", "reconstruct", "reconstruct_batch", "digests_batch", "_digests", "_encode_one")
        ]
        targets += [(np_hh, "hash256_batch"), (rs_ref, "encode"), (rs_ref, "reconstruct")]
        targets += [(bitrot, "digest_of"), (bitrot, "digests_of_batch")]
        for owner, name in [*targets, *extra]:
            real = getattr(owner, name)

            def spy(*args, _name=f"{owner.__name__}.{name}", _real=real, **kwargs):
                self.calls.append(_name)
                return _real(*args, **kwargs)

            mp.setattr(owner, name, spy)


@pytest.fixture(scope="module")
def payloads():
    rng = np.random.default_rng(37)
    return {name: rng.integers(0, 256, n, dtype=np.uint8).tobytes() for name, n in SIZES.items()}


@pytest.fixture(scope="module")
def host_encoded(payloads):
    return {name: HostCodec().encode(_blocks(data), K, M) for name, data in payloads.items()}


@pytest.fixture(params=DEVICES)
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0) if request.param == "cuda" else torch.device("cpu")


@pytest.fixture
def spied(device, monkeypatch):
    """(codec on `device`, spy): on the card the plain versions are spied on
    too."""
    extra = [(rs_cuda, "plain"), (highwayhash_torch, "hash256_batch")] if device.type == "cuda" else []
    codec = BatchingDeviceCodec(device=device)
    spy = HostSpy(monkeypatch, extra)
    yield codec, spy
    codec.close()


def _rows(encoded_block, lost) -> list[bytes | None]:
    chunks, _ = encoded_block
    return [None if j in lost else chunks[j] for j in range(K + M)]


@pytest.mark.parametrize("name", sorted(SIZES))
def test_encode_runs_every_block_on_the_device(spied, payloads, host_encoded, name):
    codec, spy = spied
    blocks = _blocks(payloads[name])
    spy.calls.clear()
    assert codec.encode(blocks, K, M) == host_encoded[name]
    assert spy.calls == []
    st = codec.stats()
    full = sum(len(b) == MiB for b in blocks)
    assert st["blocks_encoded"] == full and st["small_blocks_encoded"] == len(blocks) - full
    assert st["host_fallback_blocks"] == 0


def test_batch_wait_off_still_batches_on_the_device(monkeypatch, payloads, host_encoded):
    monkeypatch.setenv("MTPU_BATCH_WAIT_US", "off")
    codec = BatchingDeviceCodec(device="cpu")
    try:
        assert codec.small_wait_s == 0.0
        spy = HostSpy(monkeypatch)
        assert codec.encode(_blocks(payloads["37B"]), K, M) == host_encoded["37B"]
        assert spy.calls == [] and codec.stats()["small_batches_run"] == 1
    finally:
        codec.close()


def test_ragged_and_single_chunk_digests_on_the_device(spied, host_encoded):
    codec, spy = spied
    full, tail = host_encoded["1MiB+37B"]
    small = host_encoded["200KiB"][0]
    ragged = [full[0][0], tail[0][1], small[0][2], full[0][13], tail[0][15], small[0][3]]
    single = [tail[0][4]]
    want_ragged = [HostCodec().digests_batch([c])[0] for c in ragged]
    want_single = HostCodec().digests_batch(single)
    spy.calls.clear()
    assert codec.digests_batch(ragged) == want_ragged
    assert codec.digests_batch(single) == want_single
    assert spy.calls == []
    st = codec.stats()
    # One launch per distinct chunk length: 3 in the ragged call, 1 in the
    # single one.
    assert st["verify_batches_run"] == 4 and st["digests_verified"] == 7
    assert st["host_fallback_digest_chunks"] == 0


@pytest.mark.parametrize("with_digests", [False, True])
def test_single_block_window_on_the_device(spied, host_encoded, with_digests):
    codec, spy = spied
    rows = _rows(host_encoded["200KiB"][0], LOST)
    want = HostCodec().reconstruct_batch([rows], K, M, LOST, with_digests)
    want_single = HostCodec().reconstruct(rows, K, M, LOST)
    spy.calls.clear()
    assert codec.reconstruct_batch([rows], K, M, LOST, with_digests) == want
    assert codec.reconstruct(rows, K, M, LOST) == want_single
    assert spy.calls == []
    st = codec.stats()
    assert st["recon_batches_run"] == 2 and st["blocks_reconstructed"] == 2
    assert st["host_fallback_recon_blocks"] == 0


@pytest.mark.parametrize("with_digests", [False, True])
def test_mixed_tail_window_on_the_device(spied, host_encoded, with_digests):
    """A full block and its 37-byte tail with one loss pattern, then two
    blocks of one length with two loss patterns: each call runs one device
    program per (pattern, length) group and returns the caller's order."""
    codec, spy = spied
    full, tail = host_encoded["1MiB+37B"]
    small = host_encoded["200KiB"][0]
    window = [_rows(full, LOST), _rows(tail, LOST)]
    patterns = [_rows(small, (0, 13)), _rows(tail, (0, 2, 14)), _rows(small, (0, 14))]
    want_window = HostCodec().reconstruct_batch(window, K, M, LOST, with_digests)
    want_patterns = HostCodec().reconstruct_batch(patterns, K, M, (0,), with_digests)
    spy.calls.clear()
    assert codec.reconstruct_batch(window, K, M, LOST, with_digests) == want_window
    assert codec.reconstruct_batch(patterns, K, M, (0,), with_digests) == want_patterns
    assert spy.calls == []
    st = codec.stats()
    assert st["recon_batches_run"] == 2 + 3 and st["blocks_reconstructed"] == 5


def test_too_few_shards_raise_like_the_host_codec(spied, host_encoded):
    codec, _ = spied
    rows = _rows(host_encoded["200KiB"][0], (0, 1, 2, 3, 4))
    with pytest.raises(ValueError, match="not enough shards"):
        HostCodec().reconstruct(rows, K, M, (0,))
    with pytest.raises(ValueError, match="not enough shards"):
        codec.reconstruct_batch([rows], K, M, (0,))


def test_device_codec_never_calls_the_host_codec(monkeypatch, payloads, host_encoded):
    blocks = [b for name in sorted(SIZES) for b in _blocks(payloads[name])]
    want = [enc for name in sorted(SIZES) for enc in host_encoded[name]]
    tail_rows = _rows(host_encoded["1MiB+37B"][1], LOST)
    want_recon = HostCodec().reconstruct_batch([tail_rows], K, M, LOST, True)
    codec = DeviceCodec(device="cpu")
    spy = HostSpy(monkeypatch)
    assert codec.encode(blocks, K, M) == want
    assert codec.reconstruct_batch([tail_rows], K, M, LOST, True) == want_recon
    assert codec.digests_batch([c for c in want[0][0]]) == want[0][1]
    assert spy.calls == []


def test_hash_launches_are_grouped_by_true_length(monkeypatch):
    """The small path hashes each block's rows at their true length: blocks
    of equal length share one hash call, padded rows are never hashed."""
    calls: list[tuple[int, int]] = []
    real = highwayhash_cuda.hash256_batch

    def counted(x, *args, **kwargs):
        calls.append(tuple(x.shape))
        return real(x, *args, **kwargs)

    monkeypatch.setattr(highwayhash_cuda, "hash256_batch", counted)
    monkeypatch.setenv("MTPU_BATCH_WAIT_US", "5000000")
    rng = np.random.default_rng(5)
    blocks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (37, 5000, 37, 1200)]
    codec = BatchingDeviceCodec(max_batch=4, device="cpu")
    try:
        assert codec.encode(blocks, K, M) == HostCodec().encode(blocks, K, M)
    finally:
        codec.close()
    # Shard lengths 4, 417, 4 and 100: three groups, padded to 1,024 bytes
    # and 4 blocks on the RS side but hashed at 4, 417 and 100 bytes.
    assert sorted(calls) == sorted([(2 * (K + M), 4), (K + M, 417), (K + M, 100)])
