"""Block codec service: the seam between the object layer and the math.

The object layer hands 1 MiB blocks to a BlockCodec and gets back shard bytes
plus bitrot digests. Implementations:

  * HostCodec  -- numpy GF tables + numpy HighwayHash on the host.
  * DeviceCodec -- single-shot encode on the GPU through the pipeline
    (models/pipeline.py); right for large objects where one call carries
    many blocks.
  * The cross-upload batching scheduler (parallel/batching.py) aggregates
    blocks from concurrent requests into one device program.

All implementations produce bit-identical outputs (tests pin this against
the JAX package), so the object layer can switch freely per call size.
"""

from __future__ import annotations

import abc
import threading

import numpy as np

from ..ops import highwayhash as hh
from ..ops import rs_matrix, rs_ref


class BlockCodec(abc.ABC):
    """Encode/decode service for erasure blocks."""

    @abc.abstractmethod
    def encode(
        self, blocks: list[bytes], k: int, m: int
    ) -> list[tuple[list[bytes], list[bytes]]]:
        """For each input block: ([K+M shard chunks], [K+M digests])."""

    @abc.abstractmethod
    def reconstruct(
        self, shards: list[bytes | None], k: int, m: int, want: tuple[int, ...]
    ) -> list[bytes]:
        """Rebuild the `want` shard rows from available shards (None = lost)."""

    def reconstruct_batch(
        self,
        rows_batch: list[list[bytes | None]],
        k: int,
        m: int,
        want: tuple[int, ...],
        with_digests: bool = False,
    ) -> list[tuple[list[bytes], list[bytes] | None]]:
        """Rebuild `want` rows for MANY blocks sharing one present-mask.

        The batched analogue of `reconstruct` -- degraded GETs rebuild whole
        windows of blocks with the same shards lost (reference per-block
        loop: cmd/erasure-decode.go:206), so device codecs override this to
        run one [B, K, S] program instead of B round trips. Returns, per
        block, (rebuilt chunks, their bitrot digests or None when not
        requested).
        """
        from ..ops import bitrot

        out: list[tuple[list[bytes], list[bytes] | None]] = []
        for rows in rows_batch:
            chunks = self.reconstruct(rows, k, m, want)
            digests = [bitrot.digest_of(c) for c in chunks] if with_digests else None
            out.append((chunks, digests))
        return out

    def digests_batch(self, chunks: list) -> list[bytes]:
        """Bitrot digests of many shard chunks (GET frame verification).

        Host codecs use the vectorized numpy hash; the batching device codec
        routes uniform batches through the device verify_digests step."""
        from ..ops import bitrot

        return bitrot.digests_of_batch(chunks)

    def encode_frames(self, blocks: list[bytes], k: int, m: int) -> "list[bytes | memoryview]":
        """Per shard ROW: concatenated H(chunk)||chunk frames across blocks.

        This is the byte image appended to each drive's staged shard file
        (streaming-bitrot layout, cmd/bitrot-streaming.go:43-65), built from
        encode()'s chunks+digests. Rows are bytes-LIKE (buffer protocol):
        consumers write them to files/HTTP bodies and must not assume
        hashability or msgpack support."""
        encoded = self.encode(blocks, k, m)
        rows: list[bytes] = []
        for row in range(k + m):
            parts: list[bytes] = []
            for chunks, digests in encoded:
                parts.append(digests[row])
                parts.append(chunks[row])
            rows.append(b"".join(parts))
        return rows

    def encode_group(self, blocks: list, k: int, m: int) -> "EncodedGroup":
        """Scatter form of encode_frames: per-row IOVEC LISTS instead of
        joined row images, so the fan-out hands each drive its whole group
        as views (one os.writev) and never materializes row bytes. The
        concatenation of a row's iovecs is byte-identical to
        encode_frames()[row]. Also carries the data-row digest stream the
        fast etag hashes (block-major, rows 0..k-1)."""
        encoded = self.encode(blocks, k, m)
        iovecs: list[list] = []
        for row in range(k + m):
            vecs: list = []
            for chunks, digests in encoded:
                vecs.append(digests[row])
                vecs.append(chunks[row])
            iovecs.append(vecs)
        digest_stream = b"".join(
            digests[row] for chunks, digests in encoded for row in range(k)
        )
        return EncodedGroup(iovecs, digest_stream)


class EncodedGroup:
    """One encoded window, scatter layout.

    iovecs[row] is the buffer sequence whose concatenation is that drive's
    staged-file frame image for the group (digest||chunk per block). The
    views alias storage allocated per call, never the caller's input window
    -- so the PUT pipeline can recycle its pooled read buffer and encode
    group g+1 while group g's writes are still in flight. digest_stream is
    the concatenated data-row digests feeding the streaming etag."""

    __slots__ = ("iovecs", "digest_stream")

    def __init__(self, iovecs: list[list], digest_stream: bytes):
        self.iovecs = iovecs
        self.digest_stream = digest_stream

    def row_nbytes(self, row: int) -> int:
        return sum(len(v) for v in self.iovecs[row])


def _split_block(block: bytes, k: int) -> np.ndarray:
    return rs_matrix.split(np.frombuffer(block, dtype=np.uint8), k)


class HostCodec(BlockCodec):
    """Host CPU codec: numpy GF table lookups and the numpy HighwayHash."""

    def _encode_one(self, shards: np.ndarray, m: int) -> np.ndarray:
        return rs_ref.encode(shards, m)

    def _digests(self, shards: np.ndarray) -> np.ndarray:
        return hh.hash256_batch(shards)

    def encode(self, blocks, k, m):
        out = []
        for block in blocks:
            shards = self._encode_one(_split_block(block, k), m)  # [K+M, S]
            digests = self._digests(shards)
            out.append(
                (
                    [shards[i].tobytes() for i in range(k + m)],
                    [digests[i].tobytes() for i in range(k + m)],
                )
            )
        return out

    def reconstruct(self, shards, k, m, want):
        arrs: list[np.ndarray | None] = [
            np.frombuffer(s, dtype=np.uint8) if s is not None else None for s in shards
        ]
        rebuilt = rs_ref.reconstruct(arrs, k, m, data_only=False)
        return [rebuilt[i].tobytes() for i in want]


_RECON_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def bucket_batch(n: int) -> int:
    """Pad a batch count to a small fixed set of sizes, so device batches
    come in a few shapes (the JAX package's compile budget; kept so both
    packages pad identically)."""
    for b in _RECON_BUCKETS:
        if n <= b:
            return b
    return _RECON_BUCKETS[-1]


def run_device_reconstruct(
    pipe,
    rows_batch: list[list[bytes | None]],
    k: int,
    want: tuple[int, ...],
    surv: list[int],
    chunk_size: int,
    with_digests: bool,
) -> list[tuple[list[bytes], list[bytes] | None]]:
    """Assemble a uniform rows_batch into one padded [B, K, S] device
    reconstruct program and unpack per-block results (shared by DeviceCodec
    and the batching codec -- the served decode path)."""
    b_real = len(rows_batch)
    b_pad = max(bucket_batch(b_real), b_real)  # never allocate under b_real
    present = tuple(r is not None for r in rows_batch[0])
    arr = np.zeros((b_pad, k, chunk_size), dtype=np.uint8)
    for bi, rows in enumerate(rows_batch):
        for ki, j in enumerate(surv):
            arr[bi, ki] = np.frombuffer(rows[j], dtype=np.uint8)  # type: ignore[arg-type]
    rebuilt, digests = pipe.reconstruct(arr, present, tuple(want), with_digests=with_digests)
    rebuilt_np = rebuilt.cpu().numpy()
    digests_np = digests.cpu().numpy() if with_digests else None
    return [
        (
            [rebuilt_np[bi, wi].tobytes() for wi in range(len(want))],
            (
                [digests_np[bi, wi].tobytes() for wi in range(len(want))]
                if digests_np is not None
                else None
            ),
        )
        for bi in range(b_real)
    ]


def uniform_recon_plan(
    rows_batch: list[list[bytes | None]], k: int
) -> tuple[tuple[bool, ...], list[int], int] | None:
    """Device-eligibility check for a batched reconstruct.

    Returns (present mask, first-K surviving row indices, chunk size) when
    every block in the batch lost the same shards and all surviving chunks
    share one length -- the shape a single [B, K, S] device program needs.
    None means the batch is irregular (mixed tails/patterns): host path.
    """
    present = tuple(r is not None for r in rows_batch[0])
    if sum(present) < k:
        return None
    sizes: set[int] = set()
    for rows in rows_batch:
        if tuple(r is not None for r in rows) != present:
            return None
        sizes.update(len(r) for r in rows if r is not None)
    if len(sizes) != 1:
        return None
    surv = [i for i, p in enumerate(present) if p][:k]
    return present, surv, sizes.pop()


class DeviceCodec(BlockCodec):
    """Single-call device codec: one encode program per call.

    Blocks in one call are padded to the longest shard size and batched into
    a single [B, K, S] tensor, so a large PutObject already amortizes
    transfer/launch across its own blocks. Cross-request amortization is the
    batching scheduler's job (parallel/batching.py). ``device`` is "cuda"
    unless the caller asks for "cpu".
    """

    def __init__(self, device: str = "cuda"):
        self.device = device
        self._host = HostCodec()
        self._pipelines: dict[tuple[int, int], object] = {}

    def _pipe(self, k: int, m: int):
        from ..models.pipeline import ErasurePipeline, Geometry

        key = (k, m)
        if key not in self._pipelines:
            self._pipelines[key] = ErasurePipeline(Geometry(k, m), device=self.device)
        return self._pipelines[key]

    def encode(self, blocks, k, m):
        if not blocks:
            return []
        sizes = [rs_matrix.shard_size(len(b), k) for b in blocks]
        s_max = max(sizes)
        batch = np.zeros((len(blocks), k, s_max), dtype=np.uint8)
        for i, block in enumerate(blocks):
            batch[i, :, : sizes[i]] = _split_block(block, k)
        parity = self._pipe(k, m).encode_parity(batch).cpu().numpy()  # [B, M, S]
        out = []
        for i in range(len(blocks)):
            s = sizes[i]
            shards_i = np.concatenate([batch[i, :, :s], parity[i, :, :s]], axis=0)
            # Padded-batch digests are only valid when every block shares the
            # padded length; hash at true length on the host instead.
            digests = self._host._digests(np.ascontiguousarray(shards_i))
            out.append(
                (
                    [shards_i[j].tobytes() for j in range(k + m)],
                    [digests[j].tobytes() for j in range(k + m)],
                )
            )
        return out

    def reconstruct(self, shards, k, m, want):
        return self._host.reconstruct(shards, k, m, want)

    def reconstruct_batch(self, rows_batch, k, m, want, with_digests=False):
        """Uniform multi-block rebuilds run as one device program; singles
        and irregular batches take the host codec."""
        plan = uniform_recon_plan(rows_batch, k) if len(rows_batch) > 1 else None
        if plan is None:
            return super().reconstruct_batch(rows_batch, k, m, want, with_digests)
        _, surv, s = plan
        return run_device_reconstruct(
            self._pipe(k, m), rows_batch, k, tuple(want), surv, s, with_digests
        )


_default: BlockCodec | None = None
_default_lock = threading.Lock()


def default_codec() -> BlockCodec:
    """Process-wide codec, for layers built without one: the batching device
    codec on "cuda" (which raises without a card), unless a caller installs
    another with set_default_codec."""
    global _default
    with _default_lock:
        if _default is None:
            from ..parallel.batching import BatchingDeviceCodec

            _default = BatchingDeviceCodec()
        return _default


def set_default_codec(codec: BlockCodec) -> None:
    global _default
    with _default_lock:
        _default = codec
