"""Block codec service: the seam between the object layer and the math.

The object layer hands 1 MiB blocks to a BlockCodec and gets back shard bytes
plus bitrot digests. Implementations:

  * HostCodec  -- numpy GF tables + numpy HighwayHash on the host.
  * DeviceCodec -- single-shot encode, reconstruct and hash on the GPU
    through the pipeline (models/pipeline.py); right for large objects
    where one call carries many blocks.
  * The cross-upload batching scheduler (parallel/batching.py) aggregates
    blocks from concurrent requests into one device program.

All implementations produce bit-identical outputs (tests pin this against
the JAX package), so the object layer can switch freely per call size.
"""

from __future__ import annotations

import abc
import threading

import numpy as np
import torch

from ..control import tracing
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

        Host codecs use the vectorized numpy hash; the device codecs hash on
        their device, one launch per distinct chunk length."""
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
        with tracing.span(
            "erasure.encode", "erasure", blocks=len(blocks), k=k, m=m, host=True
        ):
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


def reconstruct_groups(
    pipe,
    rows_batch: list[list[bytes | None]],
    k: int,
    want: tuple[int, ...],
    with_digests: bool,
) -> tuple[list[tuple[list[bytes], list[bytes] | None]], int]:
    """Rebuild `want` rows for blocks of any loss pattern and chunk length.

    The blocks are split into groups of one present-mask and one chunk
    length (a window's full blocks, then its short tail) and each group
    runs as one device program (run_device_reconstruct). Returns the
    results in the caller's order, and the number of groups run."""
    groups: dict[tuple[tuple[bool, ...], int], list[int]] = {}
    for i, rows in enumerate(rows_batch):
        present = tuple(r is not None for r in rows)
        if sum(present) < k:
            raise ValueError("not enough shards to reconstruct")
        sizes = {len(r) for r in rows if r is not None}
        if len(sizes) != 1:
            raise ValueError("surviving shard chunks differ in length")
        groups.setdefault((present, sizes.pop()), []).append(i)
    if not want:
        return [([], [] if with_digests else None) for _ in rows_batch], 0
    out: list = [None] * len(rows_batch)
    for (present, s), idx in groups.items():
        surv = [j for j, p in enumerate(present) if p][:k]
        res = run_device_reconstruct(pipe, [rows_batch[i] for i in idx], k, want, surv, s, with_digests)
        for i, r in zip(idx, res):
            out[i] = r
    return out, len(groups)


def digests_by_length(chunks: list, hash_rows) -> list[bytes]:
    """Digests of chunks in the caller's order: one hash_rows(rows, length)
    call (a [n, length] device hash) per distinct chunk length."""
    by_len: dict[int, list[int]] = {}
    for i, c in enumerate(chunks):
        by_len.setdefault(len(c), []).append(i)
    out: list = [None] * len(chunks)
    for length, idx in by_len.items():
        for i, d in zip(idx, hash_rows([chunks[i] for i in idx], length)):
            out[i] = d
    return out


def stack_rows(rows: list, length: int, out: np.ndarray | None = None) -> np.ndarray:
    """Equal-length byte rows -> one [n, length] u8 array (into `out` when
    given, e.g. a pinned staging buffer)."""
    arr = np.empty((len(rows), length), dtype=np.uint8) if out is None else out
    for r, c in enumerate(rows):
        arr[r] = np.frombuffer(c, dtype=np.uint8)
    return arr


class DeviceCodec(BlockCodec):
    """Single-call device codec: one encode program per call.

    Blocks in one call are padded to the longest shard size and batched into
    a single [B, K, S] tensor, so a large PutObject already amortizes
    transfer/launch across its own blocks. Cross-request amortization is the
    batching scheduler's job (parallel/batching.py). ``device`` is "cuda"
    unless the caller asks for "cpu". Every block, reconstruct and digest
    runs on the pipeline's device.
    """

    def __init__(self, device: str = "cuda"):
        self.device = device
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
        batch = np.zeros((len(blocks), k, max(sizes)), dtype=np.uint8)
        for i, block in enumerate(blocks):
            batch[i, :, : sizes[i]] = _split_block(block, k)
        shards, digests = self._pipe(k, m).encode_padded(batch, sizes)
        shards, digests = shards.cpu().numpy(), digests.cpu().numpy()
        return [
            (
                [shards[i, j, : sizes[i]].tobytes() for j in range(k + m)],
                [digests[i, j].tobytes() for j in range(k + m)],
            )
            for i in range(len(blocks))
        ]

    def reconstruct(self, shards, k, m, want):
        return self.reconstruct_batch([shards], k, m, want)[0][0]

    def reconstruct_batch(self, rows_batch, k, m, want, with_digests=False):
        return reconstruct_groups(self._pipe(k, m), rows_batch, k, tuple(want), with_digests)[0]

    def digests_batch(self, chunks):
        from ..ops import highwayhash_cuda

        def hash_rows(rows, length):
            x = torch.from_numpy(stack_rows(rows, length)).to(self.device)
            return [d.tobytes() for d in highwayhash_cuda.hash256_batch(x).cpu().numpy()]

        return digests_by_length(chunks, hash_rows)


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
