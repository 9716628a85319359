"""Boot goldens pinned against the reference's algorithms (klauspost/
reedsolomon and minio/highwayhash).

``cli.boot_self_test`` re-checks them with the numpy copies at every boot,
like erasureSelfTest; the probe child (``_probe_child.py``) checks them again
through the CUDA kernels on the card.

HH_GOLDEN: HighwayHash-256 of ``bytes(range(64))`` under the bitrot key.
RS_GOLDEN: sha256 of the 4+2 encode of ``bytes(range(256))`` as 4 x 64 rows
(the data rows followed by the parity rows).
"""

HH_GOLDEN = "8c8b584226c40f7286e247d70d013bba9a4b56a4be68efb96b0901a1842c2694"
RS_GOLDEN = "5eb38c9b16bee39ec05c816f29fe90b808066f98292dfc0b72f313b2187fa69f"
