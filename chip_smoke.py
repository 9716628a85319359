"""Smoke run of minio_tpu_torch on one NVIDIA GPU (an H100: sm_90a kernels).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. GPU and build: prints the card's name and power limit and builds the
   package's CUDA kernels from minio_tpu_torch/csrc/ (with
   torch.utils.cpp_extension.load: one nvcc per source, in parallel) into
   minio_tpu_torch/_build/.
2. Kernels against their plain torch versions on the card, at the shapes the
   PUT/GET path gives them: the Reed-Solomon kernel at [64, 12, 87382] for
   encode and a 4-row reconstruct, on the fused encode's layout (data and
   parity rows of one all-shards tensor) at B = 1, 16 and 64, at R = 1..4
   rows and at S in {1, 3, 15, 16, 17, 4095, 4096, 87381, 87382}, and on
   input and output rows whose base lies 1..15 bytes past a 16-byte
   boundary; the HighwayHash kernel at N = 1, 16 (the GET verify batch), 17
   and 1,024 (the 64-block encode batch) streams at every tail length, and
   on rows whose base lies 1..15 bytes past a 16-byte boundary. Phase 5's
   shapes too: the RS kernel on the reduced-redundancy 14+2 encode (S =
   74,899, and its fused layout at B = 16) and on the small-object path's
   padded batches (S = 1 KiB .. 128 KiB, B up to 64, K = 12 and 14); the
   hash at L = 74,899 and at the small path's true row lengths. Bytes must
   be equal (tolerance: exact). Times come from CUDA events, each launch on
   rows not in the L2 cache: the RS kernel at [64, 12, 87382] contiguous,
   on the encode view at B = 16 and 64 and a 4-row reconstruct at B = 16,
   each with its bytes bound; the hash at [16, 87382], [64, 87382] (heal's
   verify batch and its rebuilt-row hash, 16 blocks x 4 rows) and
   [1024, 87382], and at [16, 74899] and [256, 2731]; the RS kernel also on
   the 14+2 encode view at B = 16 and 64, on two small-path batches and on
   phase 5's reconstructs (B = 1 and 4, R = 1 and 4, S = 87,382 and a
   padded 16,384), each beside the library yardstick (one torch fp16
   matmul of the same GF(2) product on pre-unpacked bits).
3. The slice: one 16-drive 12+4 erasure set under a temp dir, driven through
   ErasureObjects with BatchingDeviceCodec(max_batch=64): PUT one 128 MiB
   object, then 8 concurrent 16 MiB objects; GET each back byte-exact;
   remove the part files of 4 drives and GET each again (degraded read
   through the reconstruct kernel). Kernel launch counts are reset just
   before this phase and read just after; each kernel must have launched.
   The hash kernel's launches are also tallied by their N, the RS kernel's
   by their (B, R).
   A small object is also PUT through a numpy HostCodec stack and its part
   files must equal the device stack's byte for byte.
   In this phase, in phase 4's paths and in phase 5's, no work may reach the
   numpy host codec or a kernel's plain version (the launch tally counts
   such calls), and the codec's host_fallback_* counters must read 0.
4. The rest of the erasure set, on the same set and codec, each path with
   the launch counts reset just before it and read just after (each kernel
   must have launched in each):
   - heal: the part files phase 3 removed were kept; heal_object rebuilds
     them for all 9 objects (4 drives each, byte-identical to the removed
     files, xl.meta erasure fields unchanged), through reconstruct_batch(...,
     with_digests=True): the RS kernel at (B, R) = (16, 4), then the hash
     kernel on the rebuilt rows at N = 64, with no window on the host codec;
     then one flipped byte in a healthy row of the big object heals
     (1 drive). A GET of every object is then byte-exact with the part
     files of 4 other drives removed;
   - multipart: four 8 MiB parts from 4 threads and a last part of
     1 MiB + 37 B, completed (ETag "-5", GET byte-exact); the same upload on
     a numpy HostCodec set must leave byte-identical part.N files; an
     aborted upload leaves list_multipart_uploads;
   - the legacy whole-file bitrot layout: a sha256 PUT of 3 MiB + 37 B (its
     RS encode on the card), a GET, and a heal of one lost row.
   Besides, once each and with no kernel: put_object_metadata, a versioned
   delete marker (GET: not found), a physical delete, list_buckets,
   delete_bucket (a non-empty bucket refuses), and transition_object then
   the metadata-only heal of the transitioned version.
5. Erasure sets and server pools at a deployment's size: 48 drive
   directories. Pool 0 is 32 drives formatted as 2 sets of 16 (12+4, RRS
   14+2, SIPMOD+PARITY), built by ErasureSets.from_drives; pool 1 is 16
   drives, 1 set, attached later by ServerPools.add_pool (SUSPENDED, then
   ACTIVE) while pool 0 turns DRAINING. Every set shares the phase's codec.
   256 objects (512 before the cut that kept the script with phase 15
   under 1,000 s, 768 before the one that made room for phase 12, 1,024
   before the one for phase 11, 2,048 before the one for phase 10) from
   one numpy generator (names
   tenant-XX/YYYY-MM-DD/obj-NNNNN over 16 tenants and 8 days, sizes
   log-uniform from 1 KiB to 4 MiB, one in 8 REDUCED_REDUNDANCY), from 16
   client threads: 192 PUT into pool 0; 32 of them, of every size class
   and both storage classes, PUT again into a numpy HostCodec copy of
   pool 0 must leave the same part files and inline data; the listing of
   pool 0 is exact in pages of 1,000 with and without a delimiter and a
   prefix, its second page served by the metacache, and
   list_object_versions pages through versioned overwrites and a delete
   marker with key and version markers; after the attach the
   other 64 and 24 overwrites of pool-0 keys land in pool 1; every object's
   xl.meta lies only on its hashed set's drives; a GET of all 256 is
   byte-exact (an overwritten key reads its new bytes); the listing of both
   pools is exact without a delimiter (the delimiter listing and the
   version listing are printed, not held: the reference's multi-pool merges
   can skip keys and end a version listing early); delete_objects removes
   64 keys from the listing; with the part files and xl.meta of 4 drives of pool
   0's set 1 removed (2 of them for a 14+2 object), a GET of every object
   of that set is byte-exact and heal_object rebuilds each, byte-identical;
   heal_bucket recreates a drive's lost bucket directory. The PUTs, the
   GET, the degraded GET and the heal are paths of their own (counts reset
   before, read after; the healthy GET runs no RS); each prints its
   objects/s and GiB/s, the codec's clocks, the launch tally (hh256 by N
   and by row-length class, rs_gf_apply by (B, K, R) and by (K, R, S
   class)) and the device time those launches take at phase 2's times.
   Both kernels must have launched at K = 14, R = 2 and on small-path
   batches.
6. The S3 HTTP front over phase 5's deployment after its heal: the port's
   S3Server (SigV4, IAM root credentials, check_skew=True) on a
   ThreadedServer at 127.0.0.1, sharing the phase's codec. The client is a
   spawned process of 16 threads with keep-alive http.client connections;
   it signs with the port's api/auth.sign_request, a body up to 1 MiB with
   its sha256 and a larger one aws-chunked in 64 KiB chunks
   (api/streaming.encode_chunked), as minio-go does, and compares every
   body it reads with the bytes it made from the same seeds. Paths, each
   with the counts reset before it and read after:
   - http_put: 128 new objects (256 before the cut that kept the script
     with phase 15 under 1,000 s; tenant-XX/YYYY-MM-DD/http-NNNNN, phase
     5's size law, one in 8 REDUCED_REDUNDANCY); both kernels;
   - http_get: those 128 and 64 of phase 5's surviving objects in pool 0
     (128 before that cut, 256 before the one that made room for phase 12;
     pool 1's lost one
     drive's copy to phase 5's heal_bucket check),
     byte-exact; hh256, and rs_gf_apply only for windows where a hedged
     spare read beat a slow primary (at most 2 launches a winning hedge).
     Every HTTP-PUT object then also reads back byte-identical through
     layer.get_object;
   - http_big: one 128 MiB aws-chunked PUT, a 128 MiB multipart upload of
     16 x 8 MiB parts from 4 threads (ETag "-16"), a GET of both; both
     kernels;
   - http_degraded_get: the part files of 4 drives of pool 0's set 0
     removed (2 for a 14+2 object), every surviving object of that set read
     back byte-exact; both kernels.
   Then, with no rate: a HEAD, three Range GETs (first byte, a 1 MiB
   window, a suffix of 100) and an If-None-Match 304 per size class;
   ListObjectsV2 in pages of 1,000 equal to the layer's listing; POST
   ?delete of 64 new keys (half of them), gone from the next listing; an unsigned GET
   (403 AccessDenied), a tampered signature (403 SignatureDoesNotMatch)
   and a PUT with X-Mtpu-Deadline 0.0005 (503 SlowDownWrite, not listed).
   Each path prints objects/s, GiB/s, the client's p50 and p99 latency, the
   codec's device_* clocks, the launches by shape and the device time they
   take at phase 2's times, beside phase 3-5's direct-layer rates of the
   same run. No work may reach the host codec or a plain version.
   The always-on planes are read around each path (Planes): the stage
   ledger and the copy ledger are reset before it; after it the script
   prints each (layer, stage)'s count, p50, p99, wall and cpu sums, the
   copies per payload byte on each hop and the degrade records, and holds
   one api root span per request the client sent and one codec verify-batch
   record per object frame-parse record. The expired-deadline PUT must
   record one deadline abort. One signed PUT and one GET of a 4 MiB object
   run with a GLOBAL_TRACE subscriber: each must be one span tree keyed by
   its x-amz-request-id, with api, object and erasure spans. The continuous
   profiler stays off.
7. The fault plane on the card, on a fresh 16-drive 12+4 set whose drives
   are MeteredDrive(HealthGatedDrive(FaultyDisk(LocalDrive))), the stack
   dist/node.py builds, sharing the phase's codec; the launch tally is reset
   before each step and read after (both kernels must launch in each):
   - 7a: PUT 8 x 16 MiB and 128 objects of phase 5's size law from 16
     threads, GET each byte-exact, print the rates beside phases 3 and 5,
     the metered per-API latency EWMAs and the stage ledger; then a second
     GET pass with the continuous profiler on: gil_load, the share of
     samples by thread role and that pass's rate;
   - 7b: a seeded bitrot fault on one drive's writes while 16 x 4 MiB
     objects are PUT; every GET is byte-exact (hh256 drops the flipped
     shard, rs_gf_apply rebuilds it), heal_object rewrites it, and a GET
     with 4 other drives' part files removed is byte-exact;
   - 7c: drive-error on 2 drives: each breaker opens after 5 consecutive
     errors and the drive reads offline; 16 PUTs and 32 GETs are byte-exact
     (the GETs rebuild on the card); once disarmed, each breaker re-closes
     through its probe within max_cooldown; the degrade records and
     DriveBusy sheds are printed as they come;
   - 7d: four spawned processes, each on its own 16-drive set on the card,
     PUT an object, arm MTPU_CRASH through chaos.crash.arm_from_env and die
     with rc 137 at put.mid-commit:kill:8, put.mid-commit:kill:13,
     storage.append-iov.torn:torn-kill and multipart.complete.partial:kill;
     the parent runs recover_drive on every drive and recover_set, heals
     what it is handed, and holds the invariant: the victim is absent or
     byte-exact, no stage debris is left, and the acknowledged object reads
     byte-exact with 4 drives' part files removed.

8. Boot on the card (dist/node.py, runtime.py, the probe child, api/admin.py,
   cli.py), after phase 7; each part raises on failure and prints its
   seconds:
   - 8a, in process: a port Node over 16 wrapped drives (drive00..drive15)
     with no codec=: build() runs the real probe child, whose verdict must
     read PROBE_OK gpu after it held both kernels against their plain
     versions and the boot goldens, and installs the batching codec;
     make_app() is served by cli._run_app_until to phase 6's client
     process. Paths, each with its launch counts reset before and read
     after (no host-codec or plain-version call): boot_put (32 objects of
     phase 5's size law, 64 before the cut that made room for phase 14,
     and one 64 MiB object), boot_get (byte-exact),
     boot_degraded_get (the part files of drives 0, 5, 10, 15 removed),
     boot_heal (admin /heal; the part files come back byte-identical to the
     removed ones), boot_mrf (one 4 MiB PUT while /chaos fails drive07's
     next rename_data; the MRF heals it). Admin /perf must show the probe
     ok on platform gpu.
   - 8b, the real CLI: python3 -m minio_tpu_torch server --json over
     <root>/boot/p0/drive{00...31} and <root>/boot/p1/drive{00...15}
     (48 drives, two pools, three 12+4 sets): the online line must name
     BatchingDeviceCodec, 48 drives, 2 pools, 3 sets; the seconds from the
     spawn to online and to the first 200 PUT (503 before it); 32 objects
     of phase 5's size law (128 before the cut that made room for phase
     13, 64 before the one that made room for phase 14) from 16 threads
     and one 64 MiB aws-chunked PUT,
     read back byte-exact; /perf's stage ledger with codec encode-batch and
     verify-batch records and the probe on gpu; a user added over admin;
     SIGTERM rc 0 within 15 s; a restart, booted with
     MTPU_CRASH=put.mid-commit:kill:8, reads every object back and the user
     signs in, then dies with rc 137 on a 4 MiB PUT; the next boot's
     recovery scan leaves the victim absent or whole, every acknowledged
     object byte-exact and no stage debris on the 48 drives.
   - 8c, the card hidden: CUDA_VISIBLE_DEVICES= with the codec on auto
     exits non-zero with FATAL and the probe's error within the probe
     timeout (60 s) plus 10 s for the interpreter's start before serve
     spawns the probe child, and no PUT ever answers 200.

9. The host side (ops/native.py over minio_tpu_torch/csrc/host/*.cpp, and
   api/prefork.py):
   - 9a: the native host library builds with g++ and equals the port's
     numpy versions at the main path's shapes: rs_encode of 4 x 1 MiB
     [12+4] blocks and rs_apply of 4 lost rows (ops/rs_ref.py),
     hh256_batch [16, 87382] (ops/highwayhash.py), hh256_verify_frames
     finding one flipped byte, and a snappy round trip of ~2 MiB of text
     read back by the native and the pure-Python decoders. Its times on the
     host clock (one thread) at [64, 12, 87382] RS encode, [16, 87382] and
     [1024, 87382] hash, the host codec's encode_group of 64 x 1 MiB and
     one row's 16-frame verify, printed beside phase 2's kernel times (the
     kernels line carries them as host_ms and host_ms_n16); whether the
     run root's filesystem takes O_DIRECT; and the native file writes and
     reads of a 16 MiB PUT, its GET and a heal of two of its drives on a
     16-drive set served by the phase's codec (a path of its own).
   - 9b: python3 -m minio_tpu_torch server on phase 8b's 48-drive two-pool
     layout at MTPU_WORKERS = 1, 2 and 4 in turn (the one-worker boot
     formats the drives; MTPU_WORKER_RESPAWNS=1): the seconds from the
     spawn until every worker is online, each worker's online line with
     its pid and its own probe's PROBE_OK gpu verdict, 32 PUTs of phase
     5's size law (64 before the cut that made room for phase 14) from
     phase 6's 16-thread client and 32 byte-exact GETs (objects/s, p50
     and p99), the gil_load of whichever worker answered
     /profile, how the kernel spread 16 new connections over the workers
     (from /proc), and SIGTERM to the master: rc 0 and no worker left.
   - 9c, in the two-worker boot after its reads: one worker SIGKILLed 1 s
     into 64 more PUTs; the master respawns it, its online line carries its
     own PROBE_OK gpu, it accepts some of 16 new connections and answers
     200, and every acknowledged PUT reads back byte-exact; the four-worker
     boot that follows finds no stage debris after its recovery scans.
   Every path of phases 3-9 also reports the host library's RS and HH call
   counts (Tally.read): zero on every card path, or the script fails.

10. A 4-node cluster on the one card (dist/transport.py, storage_rest.py,
   locks.py, peer.py, the multi-node half of dist/node.py): MinIO's
   distributed form `minio server http://host{1...4}/export{1...4}`, 4
   nodes x 4 drives, one 16-drive set (12+4, RRS 14+2), written out as 16
   endpoints http://127.0.0.1:<port n>/<root>/cluster/n<n>/d<d>, host-major,
   so that each node gets its own port and drives. Four processes run
   `python3 -m minio_tpu_torch server --json --url http://127.0.0.1:<port n>
   --address 127.0.0.1:<port n> <the 16 endpoints>`; phase 6's client
   process (16 threads) sends each request to the node it names.
   - 10a: all four start at once; each online line names
     BatchingDeviceCodec, 16 drives, 1 pool, 1 set and its own PROBE_OK
     gpu; the seconds from spawn to all four online; one deployment id on
     the 16 format.json files; the card's memory in use.
   - 10b: 64 objects of phase 5's size law (128 before the cut that made
     room for phase 14) and one 64 MiB object PUT
     round-robin over the nodes, each read back byte-exact through the next
     node (objects/s, p50, p99 of each); /perf?cluster=1 shows encode-batch
     and verify-batch records and every peer, and each node's /perf its own
     probe ok; a sample of every size class and storage class leaves part
     files and inline data equal to a numpy HostCodec set over the same
     format.json files.
   - 10c: 8 concurrent PUTs of one key with distinct bodies through the 4
     nodes all answer 200; every node GETs the same body, one of the 8;
     the 16 xl.meta agree on one latest version; /toplocks and
     /force-unlock answer with the JAX shapes.
   - 10d: SIGKILL of node 4 (its 4 drives go with it): every STANDARD
     (12+4) object of 10b reads back byte-exact through nodes 1-3, with
     reconstruct-batch records; 32 new STANDARD PUTs succeed at 12 of 16
     drives. A REDUCED_REDUNDANCY (14+2) object loses 4 shards with the
     node, past its parity: each answers 503 SlowDownRead, and an RRS PUT
     503 SlowDownWrite (write quorum 14).
   - 10e: node 4 restarts with the same command and comes online with its
     own probe; admin /heal on node 1 heals the bucket; node 4's drives
     then hold the 32 new objects' part files equal to the host codec's, no
     drive holds stage debris, the refused RRS PUT left no object, and
     every object (the RRS ones too) reads back byte-exact through node 4.
   - before 10f, the operations plane: POST /speedtest/object through node
     1 with concurrency and max_concurrency 8, one round of 16 PUTs and
     GETs a node (1 MiB objects; the selftestobject verb runs
     each node's share on its own card codec): every node's entry is ok and
     every node's /perf shows encode and verify batches; GET /metrics
     through node 1; a ListenNotification stream on node 2 gets the events
     of 8 PUTs through node 3, over the peer listen stream (after warm-up
     PUTs through node 3 until its first record arrives, since the peer
     streams attach after the watcher's 200).
   - 10f: SIGTERM to the four nodes; each exits 0 within 30 s (one that
     does not has the stacks of its threads in the port's code printed). A
     node's scanner gets 10 s to reach its next object; one still inside a
     call is left behind, and the node's log line with its stack is shown.
   The kernels ran in the node processes: the kernels line carries each
   node's codec records by step (codec_records_by_node), the cluster
   speedtest's included.

11. Pool lifecycle, the scanner and tiering (object/poolmgr.py,
   control/rebalance.py, scanner.py, usage.py, lifecycle.py, tiering.py):
   a port Node in this process over one 16-drive pool (12+4, RRS 14+2), no
   codec= (its build installs the batching codec on the process's probe
   verdict: phase 8a's probe child in the whole script, one of its own
   when the phase runs alone),
   served over HTTP; every request is signed S3 or admin from phase 6's
   client process (16 threads). Each step zeroes the kernel counts and the
   stage ledger before it and prints its wall time, objects/s, codec
   records (encode, verify and reconstruct batches) and both kernels'
   launches after it; no step may reach the host codec.
   - 11a: 128 objects of phase 5's law (tenant-XX/... names) PUT into pool
     0; POST /pools/attach adds pool 1 (16 drives): both active in
     /pools/status, and a fresh PoolManager loads the persisted config.
   - 11b: POST /pools/decommission of pool 0 until /pools/status says
     decommissioned (path pool_decommission): every object GETs
     byte-exact, no xl.meta of the bucket is left on pool 0, every object's
     xl.meta is on pool 1's 16 drives, and the move made encode and verify
     batches.
   - 11c: an empty pool 2 attached, POST /pools/rebalance until it stops
     (path pool_rebalance): the active pools' data-minus-capacity shares
     within the engine's threshold, every moved object GETs byte-exact,
     none is on two pools.
   - 11d: a lifecycle PUT through S3 (one tenant prefix expires by a past Date,
     another, the one with the most objects past the inline limit,
     transitions at Days 0 to an FS tier added by POST /tiers);
     8 STANDARD objects removed from 4 drives of pool 1; one scan_cycle
     with heal_sample 1 (path scanner_heal): /datausage equals the walked
     objects, the expired ones answer 404, the transitioned ones hold no
     part files and GET byte-exact through the tier, inline ones stay, and
     the 8 are whole again on all 16 drives, each part file byte-exact.
   - 11e: POST ?restore of 4 transitioned objects (path tier_restore)
     writes copies that GET byte-exact; a second cycle with the restores
     expired removes the copies, and /datausage then counts the live
     objects.

12. Events and operations (control/events.py, event_targets.py,
   api/streams.py, control/metrics.py, selftest.py, health.py,
   bandwidth.py, flight.py, update.py): a port Node in this process over
   one 16-drive pool (12+4, RRS 14+2) on the process's probe verdict, as in
   phase 11, served over HTTP, with a webhook receiver (http.server on
   127.0.0.1 in this process) enabled as an operator enables it, through
   the notify_webhook config the node's build reads. Requests come signed
   from phase 6's client process; the streams are read in this process.
   Each path zeroes the kernel counts before it and prints its wall time,
   codec records and both kernels' launches after it; no path may reach
   the host codec.
   - 12a (path events_put): PUT ?notification (s3:ObjectCreated:* on
     prefix tenant-00/, s3:ObjectRemoved:* on the bucket) and a
     ListenNotification stream for s3:ObjectCreated:*; then 64 PUTs of
     phase 5's size law over 4 tenants, 4 CopyObjects, a 3-part multipart
     upload, 8 DELETEs and a POST ?delete of 8 keys. The receiver gets
     exactly the matching records, each created one with the size, ETag
     and version id of its object's HEAD; the stream gets every
     ObjectCreated record. The receiver stops and 16 more PUTs leave 16
     records pending and 16 spool files under the first drive; back up, all
     16 arrive once each. A lifecycle expiring tenant-01 and one
     scan_cycle (its sleeper off) deliver one s3:ObjectRemoved:Expired
     record per expired object.
   - 12b: POST /speedtest/object with 1 MiB objects and the default ramp
     (start 4, max 32, 2 ops a worker; path selftest_object; both kernels;
     the scratch bucket is gone from every drive afterwards), then POST
     /speedtest, the legacy autotune (path speedtest_legacy). GET /metrics
     right after: every minio_tpu_codec_* sample equals the codec's
     stats() read just after the scrape, and over the two speedtests the
     encode and small-encode batch counters grew by their codec records
     (verify and reconstruct by at least theirs: one record can cover
     several launches). POST /speedtest/drive at 4 MiB a drive, POST
     /speedtest/net, and the GET of each probe's last result;
     /timeseries, /healthinfo (16 drives), /bandwidth, /kms/status; a
     /trace stream around 8 PUTs holds one http record and one span tree
     for each; POST /flight/dump, then GET /flight lists the bundle and GET
     /flight/{id} returns it; POST /update of a file:// release the script
     builds and signs with an ed25519 key it makes: staged, not applied,
     and GET /update reports the running version with the key configured.
   The node's close() leaves no sender thread of its target and no armed
   flight recorder.

13. Replication and identity between two deployments (control/replication.py,
   site_replication.py, api/sts.py, jwt.py, console.py): MinIO's documented
   bucket replication (minio/minio docs/bucket/replication/README.md) and
   site replication (docs/site-replication/README.md) between two 16-drive
   12+4 deployments on the one card. Site A is a port Node in this process
   on the process's probe verdict, served over HTTP; site B is `python3 -m
   minio_tpu_torch server` over 16 drives of its own, with its own probe
   child and codec on the card. Requests come signed from phase 6's client
   process (node 0 = A, node 1 = B). A's paths zero the kernel counts before
   and read them after (both kernels, no host codec, no plain version); B's
   kernels stand as its /metrics codec series before and after the phase.
   - 13a (path replication_put): versioned buckets on both sites, a target
     on A (POST /replication/target) and a rule with delete and
     delete-marker replication; 64 objects of phase 5's law from 16 threads
     and one 64 MiB object PUT on A. Every replica on B is byte-exact with
     its source's version id, REPLICA on B and COMPLETED on A; the replica's
     mtime is B's write time (neither package reads x-minio-source-mtime); a
     delete marker and a version delete reach B; /replication/status and
     ?replication-metrics read pending 0. Printed: the seconds from the last
     acknowledged PUT to pending 0, objects/s and MiB/s, A's codec records.
     Then a second target limited to 1 MiB/s and 18 objects of 1 MiB:
     /bandwidth reports the limit; the drain takes no less than the 17 s
     the limit allows past the token bucket's one-second burst (without the
     throttle it takes 2-3 s); the rate /bandwidth observes is at most 1.1x
     the limit.
   - 13b (path replication_resync): 16 objects of 1 MiB lose their part
     files on 4 of A's drives; PUT ?replication-reset to a third bucket on
     B under an ExistingObjectReplication rule lands each byte-exact, with
     A's reconstruct batches.
   - 13c (path site_replication): A's and B's buckets of 13a-13b emptied
     through S3 (a joining peer holds no bucket; A's replication rules go
     first, so its deletes are not replicated), a bucket of 4 objects made
     on A, POST
     /site-replication/add: the bucket is seeded to B byte-exact; a bucket
     made on B is on A; a policy, a user, a service account and an
     /idp/ldap/policy mapping made on A are on B, a user made on B is on A;
     32 objects PUT on B replicate to A byte-exact, REPLICA on A, one
     version of each key on each site (no ping-pong); a bucket deleted on A
     leaves B; /site-replication/info lists both online.
   - 13d (path sts_put_get): STS AssumeRole on A signed by the user made on
     B; its temporary credentials PUT and GET a 1 MiB object on A
     byte-exact and are refused outside the user's policy; the console's
     POST /api/login gives a Bearer JWT, GET /api/buckets lists what S3
     lists, and a bucket created through the console on A is on B.
   At the end B gets SIGTERM and exits 0 within 30 s, its log naming
   replication and site replication closed; no thread of A's replication
   outlives its node.
14. The workload harness on the card (loadgen/, object/memcache.py):
   scenarios/smoke.yaml and scenarios/hot_get_storm.yaml, as they are,
   through the port's ScenarioRunner against its InProcessCluster (2
   nodes x 4 drives each, over HTTP in this process), every node on the
   script's codec. hot_get_storm is MinIO's zipfian hot-set GET storm:
   MTPU_MEMCACHE_MB=64 and MTPU_MEMCACHE_VALIDATE=0 on each node, 128
   objects of 256-512 KiB prepopulated, a cold uniform sweep of 96 GETs,
   then 768 zipfian (theta 0.99) GETs from 8 threads. The kernel counts
   are zeroed before each prepopulation and each scenario phase and read
   after (paths loadgen_smoke_prepopulate, loadgen_smoke,
   hot_get_prepopulate, hot_get_sweep_cold, hot_get_storm_hot; no host
   codec, no plain version): both kernels launch in each prepopulation
   and in the smoke phase, hh256 in sweep_cold, and storm_hot launches
   fewer hh256 per GET than sweep_cold (a memory hit launches nothing).
   The reports' SLO, acked-object loss and hit-ratio (>= 0.8 in
   storm_hot) verdicts hold; the compare verdict (storm_hot >= 3x
   sweep_cold GET ops/s), a throughput ratio on a host whose cores the
   client threads and both nodes share, is printed, and a line
   "14 hot_get_storm FINDING" when it misses its floor. Each phase's
   op_sequence_sha256 is the one its scenario regenerates.
   Printed: each phase's ops/s, p50 and p99 by op, the hit ratios, the
   hashes, the launches of each path and the device time they take at
   phase 2's times.

15. SelectObjectContent, the FS server and the gateways (s3select/,
   object/fs.py, object/gateway.py, the CLI's one-path and gateway modes):
   - 15a: a port Node in this process over 16 drives at parity 4 (12+4) on
     the script's codec, served over HTTP; requests come signed from phase
     6's client process. A 16 MiB CSV access log made from a numpy generator
     (id,region,status,bytes,latency_ms,path, 58 bytes a row; 32 MiB before
     the cut that kept the script under 1,000 s), a gzip CSV of
     16 MiB before compression, 8 MiB of JSON lines and a Parquet object of
     120,000 rows (the writer of tests/test_parquet.py, snappy) are PUT
     (path select_put). Selects, each a path of its own: the aggregate
     count(*), sum(cast(s.bytes as int)) WHERE s.status = '500'
     (select_csv_aggregate), a projection WHERE cast(s.latency_ms as float)
     > 900.0 (select_csv_projection), the aggregate again with drives 0, 5,
     10 and 15 offline (select_csv_degraded), and one each over the gzip
     CSV, the JSON lines and the Parquet object. Each Records payload
     equals numpy's over the generated columns and each event stream an
     in-process run_select over the original bytes; the degraded stream
     equals the healthy one. hh256 must launch on every Select, rs_gf_apply
     too on the degraded one; no host codec, no plain version.
   - 15b: `python3 -m minio_tpu_torch server <root>/fs1` (the FS backend:
     no probe, no codec): its online line says mode fs; a bucket, 4 PUTs
     and GETs, a 3-part multipart upload of 11 MiB, a listing and a Select
     over a 2 MiB CSV equal to run_select's; SIGTERM, exit 0.
   - 15c: `python3 -m minio_tpu_torch gateway s3 <15a's endpoint>`: a
     bucket and 16 PUTs of 1 MiB through it (path gateway_s3_put, both
     kernels on 15a's node), each read back byte-exact through it and from
     the node (gateway_s3_get), and the JSON Select through it equal to the
     direct one (gateway_s3_select). `gateway nas <root>/nas`: a PUT, a
     GET and a listing. Both exit 0 on SIGTERM.
   Printed: each Select's seconds, MB/s and launches, the phase's seconds,
   beside the card's name and power limit.

16. The mesh path (parallel/mesh.py; ErasurePipeline's and
   BatchingDeviceCodec's mesh handling) over virtual meshes whose entries
   all map to cuda:0 (the host has one card; a mesh over real cards is not
   reached):
   - 16a: the encode step at (dp, tp, sp) = (8,1,1), (4,2,1), (2,2,2) and
     (1,2,4) over 8 entries, 12+4 with 87,382 B shards (87,384 for sp = 4,
     which 87,382 does not tile) and B = 2*dp blocks from a numpy seed:
     shards and digests equal byte for byte to the single-device pipeline's
     on cuda:0 (phase 2 holds it against the plain versions), and each
     kernel launched dp*tp*sp = 8 times a step (paths mesh_encode_DxTxS).
     Printed: the step's ms beside the single-device step's (CUDA events; a
     virtual mesh serialises on one card, so this is a finding, not a
     gate), and each kernel at the entries' shapes (RS [2, 12, S/sp] into 4
     rows, the hash on 2*16/(sp*tp) rows) beside its bytes bound; they go
     into the kernels line as `mesh_shapes`.
   - 16b: torch.cuda.device_count(), MTPU_MESH_SHAPE and codec_mesh() (None
     with one card); the script's codec reads mesh_devices 1, chip_blocks [].
   - 16c: BatchingDeviceCodec(mesh=(4,1,1) over cuda:0) under a 16-drive
     12+4 set: 16 objects of 4 MiB PUT from 16 threads (mesh_codec_put), a
     GET of each byte-exact (mesh_codec_get) and again with drives 1, 6, 11
     and 12 offline (mesh_codec_degraded_get); every part file equal to
     those the script's codec writes for the same payloads into a second
     set; mesh_devices 4, sum(chip_blocks) = blocks_encoded, and each
     group's count equal to the JAX package's formula over the batches the
     codec ran; no host codec, no plain version.

The line before the last is a JSON object describing each kernel, with its
launches by path (phases 7, 8a and 11-16 included); the last
line is {"ok": true, "device": {...}}. Exits non-zero, printing no result,
without a CUDA device.

The script is the child subreaper of the processes it starts: each
phase's end prints the live processes below it, and its end (or a
SIGTERM, which unwinds it as an exit) stops and reaps whatever is left.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import hashlib
import itertools
import json
import os
import re
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import threading
import time
import xml.etree.ElementTree as ET
from types import SimpleNamespace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor rate
INT32_ALU_OPS_PER_S = 67e12  # taken as the fp32 non-tensor rate: no published int64 rate

K, M, DRIVES = 12, 4, 16
S_FULL = -(-(1 << 20) // K)  # 87,382: the shard chunk of a 1 MiB block
K_RRS = 14  # REDUCED_REDUNDANCY on a 16-drive set: 14+2
S_RRS = -(-(1 << 20) // K_RRS)  # 74,899
# The small-object path pads the shard axis to a power of two from 1 KiB.
SMALL_PADDED = tuple(1024 << i for i in range(8))
MiB = 1 << 20


T0 = time.perf_counter()


def log(*args) -> None:
    print(*args, flush=True)


def log_phase_end(phase: str) -> None:
    below = _descendants()
    log(f"{phase} done at {time.perf_counter() - T0:.1f} s since start; processes below this one: "
        + ("; ".join(f"pid {pid} {cmd}" for pid, cmd in below) if below else "none"))


def _become_subreaper() -> bool:
    """Make this process the child subreaper of all it starts (prctl
    PR_SET_CHILD_SUBREAPER): a process orphaned below it, such as a server's
    probe child in its own session when the server is SIGKILLed, is then
    reparented here, where _descendants sees it and _stop_descendants stops
    it."""
    import ctypes

    try:
        return ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip()[:200]
    except OSError:
        return "?"


def _descendants() -> list[tuple[int, str]]:
    """(pid, command line) of every live process below this one, from /proc;
    zombies are left out."""
    children = collections.defaultdict(list)
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        children[int(ppid)].append((int(name), state))
    out, todo = [], [os.getpid()]
    while todo:
        for pid, state in children.pop(todo.pop(), ()):
            todo.append(pid)
            if state != "Z":
                out.append((pid, _cmdline(pid)))
    return out


def _exit_on_sigterm(signum, frame) -> None:
    """SIGTERM (a time limit's kill) unwinds the main thread as an exit, so
    that each phase's finally stops the servers it started and the end
    stops whatever else is left."""
    raise SystemExit(128 + signum)


def _reap_zombies() -> None:
    with contextlib.suppress(ChildProcessError):
        while os.waitpid(-1, os.WNOHANG)[0]:
            pass


def _stop_descendants(grace_s: float = 10.0) -> list[str]:
    """At the script's end, stop every process still below this one and
    reap it: SIGTERM, then SIGKILL after `grace_s`; the multiprocessing
    resource tracker (which outlives the last spawned process until it
    reads the end of its pipe) by its own shutdown once nothing else is
    left. Returns "pid command line" of each process it had to signal."""
    from multiprocessing import resource_tracker

    tracker = getattr(resource_tracker._resource_tracker, "_pid", None)
    signalled = []
    for sig, wait_s in ((signal.SIGTERM, grace_s), (signal.SIGKILL, 5.0)):
        left = [(pid, cmd) for pid, cmd in _descendants() if pid != tracker]
        for pid, cmd in left:
            with contextlib.suppress(OSError):
                os.kill(pid, sig)
            if sig == signal.SIGTERM:
                signalled.append(f"pid {pid} {cmd}")
        deadline = time.monotonic() + wait_s
        while left and time.monotonic() < deadline:
            time.sleep(0.05)
            _reap_zombies()
            left = [p for p in _descendants() if p[0] != tracker]
    with contextlib.suppress(Exception):  # noqa: BLE001 - the sweep below stops it all the same
        resource_tracker._resource_tracker._stop()
    for pid, cmd in _descendants():
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
        signalled.append(f"pid {pid} {cmd}")
    time.sleep(0.1 if signalled else 0)
    _reap_zombies()
    return signalled


def cuda_time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item()) if a.numel() else 0


def rs_bound(b: int, r: int, k: int = K, s: int = S_FULL) -> tuple[float, str]:
    """The RS kernel's least time in ms at [b, k, s] -> r rows, and what sets it."""
    nbytes = b * (k + r) * s
    ops = 2 * b * s * (k * 8) * (r * 8)  # the bit-matmul's MACs x 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_TENSOR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def hh_bound(n: int, length: int = S_FULL) -> tuple[float, str]:
    """The hash kernel's least time in ms for n rows of `length` bytes."""
    nbytes = n * length + n * 32
    # Per 32-byte packet and lane: 3 adds, 2 multiplies, 2 masks, 2
    # shifts, 2 xors, plus ~24 zipper shift/mask/or ops per lane pair:
    # ~60 ops.
    ops = n * (length // 32 + 11) * 4 * 60
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_gpu_and_build():
    from minio_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    lib = cuda_build.build_all()
    log(f"build: {len(cuda_build.sources())} kernel sources -> {lib.name} in {time.perf_counter() - t0:.3f} s")
    return smi


def phase_kernels(dev: torch.device) -> dict:
    from minio_tpu_torch.ops import highwayhash_cuda, highwayhash_torch, rs_cuda, rs_matrix
    from minio_tpu_torch.tools.rs_probe import graph_ms

    gen = torch.Generator(device="cpu").manual_seed(1234)

    def rand(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen).to(dev)

    # -- kernel 1: RS GF(2^8) map ------------------------------------------
    parity = rs_matrix.parity_matrix(K, M)
    lost = (0, 5, 12, 15)
    present = tuple(i not in lost for i in range(K + M))
    recs = {r: rs_matrix.reconstruct_rows(K, M, present, (0, 5, 12, 15)[:r]) for r in (1, 2, 3, 4)}

    def rs_err(x, coeffs, out=None) -> int:
        got = rs_cuda.apply(x, coeffs, out=out)
        return max_abs_err(got, rs_cuda.plain(x, coeffs))

    x = rand((64, K, S_FULL))
    err = rs_err(x, parity)
    surv = rand((64, K, S_FULL))
    err = max(err, rs_err(surv, recs[4]))
    # The fused encode's layout: data rows and parity rows of one all-shards
    # tensor (batch stride (K+M)*S, parity rows at (K+r)*S).
    for b in (1, 16, 64):
        shards = rand((b, K + M, S_FULL))
        err = max(err, rs_err(shards[:, :K], parity, out=shards[:, K:]))
    rs_lengths = (1, 3, 15, 16, 17, 4095, 4096, 87_381, S_FULL)
    for s in rs_lengths:
        for r, coeffs in recs.items():
            err = max(err, rs_err(rand((3, K, s)), coeffs))
        err = max(err, rs_err(rand((3, K, s)), parity))
        # Rows 1..15 bytes past a 16-byte boundary, in and out: views into
        # flat buffers, one R in 1..4 per offset.
        xbuf, obuf = rand((16 + 2 * K * s,)), rand((16 + 2 * M * s,))
        for off in range(1, 16):
            r = 1 + off % 4
            coeffs = parity if r == M else recs[r]
            o = (7 * off + 3) % 16
            xv = xbuf[off : off + 2 * K * s].view(2, K, s)
            ov = obuf[o : o + 2 * r * s].view(2, r, s)
            err = max(err, rs_err(xv, coeffs, out=ov))
    # Reduced redundancy (14+2) encode, and the small-object path's padded
    # batches: B up to 64 at padded shard lengths of 1 KiB .. 128 KiB.
    parity_rrs = rs_matrix.parity_matrix(K_RRS, 2)
    for s in (1, 17, S_RRS):
        err = max(err, rs_err(rand((4, K_RRS, s)), parity_rrs))
    shards = rand((16, K_RRS + 2, S_RRS))
    err = max(err, rs_err(shards[:, :K_RRS], parity_rrs, out=shards[:, K_RRS:]))
    for s in SMALL_PADDED:
        err = max(err, rs_err(rand((64 if s <= 16384 else 8, K, s)), parity))
        err = max(err, rs_err(rand((8, K_RRS, s)), parity_rrs))
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"rs_gf_apply disagrees with its plain version: max abs err {err}")
    log(f"rs_gf_apply equals its plain version: [64,{K},{S_FULL}] encode and 4-row reconstruct, the fused "
        f"layout at B in (1, 16, 64), R in 1..4 at S in {rs_lengths}, base offsets 1..15 in and out; "
        f"{K_RRS}+2 encode at S in (1, 17, {S_RRS}) and its fused layout at B = 16; the small path's "
        f"padded batches at S in {SMALL_PADDED}")

    def rs_cold_ms(b: int, r: int, layout: str, k: int = K, s: int = S_FULL) -> float:
        # Rotate over copies that together exceed the 50 MB L2, so each
        # launch reads rows that are not in the cache.
        copies = max(2, -(-64 * MiB // (b * (k + r) * s)))
        coeffs = recs[r] if layout == "reconstruct" else parity if k == K else parity_rrs
        if layout == "encode view":
            bufs = [rand((b, k + r, s)) for _ in range(copies)]
            calls = [(t[:, :k], t[:, k:]) for t in bufs]
        else:
            calls = [(rand((b, k, s)), torch.empty((b, r, s), dtype=torch.uint8, device=dev))
                     for _ in range(copies)]
        # Device time from a CUDA graph of the launches: at B = 16 the wrapper's
        # host time per call is not far below the kernel's.
        return graph_ms([lambda xi=xi, oi=oi: rs_cuda.apply(xi, coeffs, out=oi) for xi, oi in calls], 10)

    def rs_lib_ms(b: int, r: int, layout: str, k: int = K, s: int = S_FULL) -> float:
        # The library yardstick at this shape: one torch fp16 matmul of
        # pre-unpacked bits [B*S, K*8] by the bit-expanded coefficients.
        coeffs = recs[r] if layout == "reconstruct" else parity if k == K else parity_rrs
        bits = torch.randint(0, 2, (b * s, k * 8), device=dev, dtype=torch.float16)
        w = torch.from_numpy(rs_matrix.bit_expand(coeffs).astype(np.float16)).to(dev)
        ms = cuda_time_ms(lambda: bits @ w, 20)
        del bits
        return ms

    def rs_plain_at(b: int, r: int, layout: str, k: int = K, s: int = S_FULL) -> float:
        coeffs = recs[r] if layout == "reconstruct" else parity if k == K else parity_rrs
        xs = rand((b, k, s))
        return cuda_time_ms(lambda: rs_cuda.plain(xs, coeffs), 2)

    # The shapes of the paths: encode (contiguous, the fused view, 14+2, the
    # small path's padded batches), heal's 4-row window, and the degraded
    # GET's reconstructs of phase 5 (B = 1 and 4 blocks, R = 1 and 4 rows,
    # a full-block S and a padded small S).
    rs_shapes = []
    for b, r, layout, k, s in ((64, M, "contiguous", K, S_FULL), (16, M, "encode view", K, S_FULL),
                               (64, M, "encode view", K, S_FULL), (16, 4, "reconstruct", K, S_FULL),
                               (16, 2, "encode view", K_RRS, S_RRS), (64, 2, "encode view", K_RRS, S_RRS),
                               (64, M, "small-path batch", K, 16384), (8, M, "small-path batch", K, 131072),
                               *((b, r, "reconstruct", K, s) for s in (S_FULL, 16384) for b in (1, 4)
                                 for r in (1, 4))):
        ms = rs_cold_ms(b, r, layout, k, s)
        bound_ms, bound_by = rs_bound(b, r, k, s)
        lib_ms = rs_lib_ms(b, r, layout, k, s)
        plain_ms = rs_plain_at(b, r, layout, k, s)
        rs_shapes.append({"shape": [b, k, s], "rows": r, "layout": layout, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
        log(f"kernel rs_gf_apply: [{b},{k},{s}] -> {r} rows, {layout}: {ms:.4f} ms "
            f"(bound {bound_ms:.4f} ms, {bound_by}; torch fp16 bit-matmul {lib_ms:.4f} ms; plain {plain_ms:.3f} ms)")
    rs_ms = rs_shapes[0]["ms"]
    rs_plain_ms = cuda_time_ms(lambda: rs_cuda.plain(x, parity), 2)
    # Library yardstick: one torch matmul doing the same GF(2) product on
    # pre-unpacked bits in fp16 (sums <= 96 are exact), not used by the port.
    bits = torch.randint(0, 2, (64 * S_FULL, K * 8), generator=gen).to(dev, torch.float16)
    w = torch.from_numpy(rs_matrix.bit_expand(parity).astype(np.float16)).to(dev)
    rs_lib_ms = cuda_time_ms(lambda: bits @ w, 20)
    del bits
    rs_bound_ms, rs_bound_by = rs_bound(64, M)
    log(f"kernel rs_gf_apply ok: [64,{K},{S_FULL}] encode {rs_ms:.4f} ms "
        f"(plain {rs_plain_ms:.2f} ms, torch fp16 bit-matmul {rs_lib_ms:.4f} ms, bound {rs_bound_ms:.4f} ms)")

    # -- kernel 2: HighwayHash-256 -----------------------------------------
    # The kernel runs on each input as it is made; the plain version, whose
    # time grows with the row length and hardly with the row count, then
    # meets all the inputs of one length in one call (rows hash alone).
    by_length = collections.defaultdict(lambda: ([], []))

    def check(x: torch.Tensor) -> None:
        inputs, outputs = by_length[x.shape[-1]]
        inputs.append(x)
        outputs.append(highwayhash_cuda.hash256_batch(x))

    def plain_timed(x: torch.Tensor) -> tuple[torch.Tensor, float]:
        t0 = time.perf_counter()
        want = highwayhash_torch.hash256_batch(x)
        torch.cuda.synchronize()
        return want, (time.perf_counter() - t0) * 1e3

    lengths = (0, 1, 3, 4, 15, 16, 22, 31, 32, 33, 255, 256, 4096, S_FULL)
    h, h16 = rand((1024, S_FULL)), rand((16, S_FULL))
    want_h, hh_plain_ms = plain_timed(h)
    want_h16, hh_plain_ms_n16 = plain_timed(h16)
    herr = max(max_abs_err(highwayhash_cuda.hash256_batch(h), want_h),
               max_abs_err(highwayhash_cuda.hash256_batch(h16), want_h16))
    for n in (1, 16, 17, 1024):
        for length in lengths:
            if length != S_FULL or n not in (16, 1024):
                check(rand((n, length)))
    # Rows whose base lies off a 16-byte boundary: views into one flat buffer.
    offsets = range(1, 16)
    for length in lengths:
        buf = rand((16 + 17 * length,))
        for off in offsets:
            check(buf[off : off + 17 * length].view(17, length))
    # The 14+2 full-block row (1 MiB / 14) and the small path's true row
    # lengths (shards of 1 KiB .. 1 MiB objects over 12 and 14 data rows).
    small_lengths = (86, 74, 342, 293, 1366, 2731, 10923, 43691, 87381)
    for n in (1, 16, 64):
        check(rand((n, S_RRS)))
        for length in small_lengths:
            check(rand((n * 16, length)))
    for inputs, outputs in by_length.values():
        herr = max(herr, max_abs_err(torch.cat(outputs), highwayhash_torch.hash256_batch(torch.cat(inputs))))
    del by_length
    torch.cuda.synchronize()
    if herr:
        raise AssertionError(f"hh256 disagrees with its plain version: max abs err {herr}")
    log(f"hh256 equals its plain version at N in (1, 16, 17, 1024) x {len(lengths)} lengths, "
        f"at base offsets {offsets.start}..{offsets.stop - 1}, at L = {S_RRS} (N = 1, 16, 64) and at the "
        f"small path's lengths {small_lengths} (N = 16, 256, 1024)")
    # [1024, 87382] is 89 MB, more than the 50 MB L2, so each launch reads
    # cold rows; the verify shape rotates over 48 batches (67 MB) for the same.
    hh_ms = cuda_time_ms(lambda: highwayhash_cuda.hash256_batch(h), 10)
    verify = rand((48, 16, S_FULL))
    turn = itertools.cycle(range(48))
    hh_ms_n16 = cuda_time_ms(lambda: highwayhash_cuda.hash256_batch(verify[next(turn)]), 96)
    # Heal's shape: 64 streams (a 16-block window's 4 rebuilt rows, and a
    # verify batch), over 12 batches (67 MB) for cold rows.
    heal = verify.view(12, 64, S_FULL)
    turn = itertools.cycle(range(12))
    hh_ms_n64 = cuda_time_ms(lambda: highwayhash_cuda.hash256_batch(heal[next(turn)]), 24)
    _, hh_plain_ms_n64 = plain_timed(heal[0])
    del verify, heal

    hh_bound_ms, hh_bound_by = hh_bound(1024)
    hh_bound_ms_n16, _ = hh_bound(16)
    hh_bound_ms_n64, _ = hh_bound(64)
    # The 14+2 GET verify row batch, and a small-path group (16 blocks of
    # a 32 KiB object: 256 rows of 2,731 bytes), each over cold copies.
    hh_shapes = []
    for n, length in ((16, S_RRS), (256, 2731)):
        copies = max(2, -(-64 * MiB // (n * length)))
        rows = rand((copies, n, length))
        turn = itertools.cycle(range(copies))
        ms = cuda_time_ms(lambda: highwayhash_cuda.hash256_batch(rows[next(turn)]), 2 * copies)
        _, plain_ms = plain_timed(rows[0])
        bound_ms, bound_by = hh_bound(n, length)
        hh_shapes.append({"shape": [n, length], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by})
        log(f"kernel hh256: [{n},{length}] {ms:.4f} ms (bound {bound_ms:.6f} ms, {bound_by}; plain {plain_ms:.1f} ms)")
        del rows
    log(f"kernel hh256 ok: [1024,{S_FULL}] {hh_ms:.4f} ms (plain {hh_plain_ms:.1f} ms, bound {hh_bound_ms:.4f} ms); "
        f"[16,{S_FULL}] {hh_ms_n16:.4f} ms (plain {hh_plain_ms_n16:.1f} ms, bound {hh_bound_ms_n16:.6f} ms); "
        f"[64,{S_FULL}] {hh_ms_n64:.4f} ms (plain {hh_plain_ms_n64:.1f} ms, bound {hh_bound_ms_n64:.6f} ms)")
    return {
        "rs_gf_apply": {
            "name": "rs_gf_apply", "route": "cuda", "source": "minio_tpu_torch/csrc/rs_gf.cu",
            "replaces": "minio_tpu/ops/rs_pallas.py:72", "max_abs_err": err,
            "ms": rs_ms, "plain_ms": rs_plain_ms, "bound_ms": rs_bound_ms,
            "bound_by": rs_bound_by, "library_ms": rs_lib_ms, "shape": [64, K, S_FULL],
            "shapes": rs_shapes,
        },
        "hh256": {
            "name": "hh256", "route": "cuda", "source": "minio_tpu_torch/csrc/highwayhash.cu",
            "replaces": "minio_tpu/ops/highwayhash_pallas.py:92", "max_abs_err": herr,
            "ms": hh_ms, "plain_ms": hh_plain_ms, "bound_ms": hh_bound_ms,
            "bound_by": hh_bound_by, "library_ms": None, "shape": [1024, S_FULL],
            "ms_n16": hh_ms_n16, "plain_ms_n16": hh_plain_ms_n16, "bound_ms_n16": hh_bound_ms_n16,
            "ms_n64": hh_ms_n64, "plain_ms_n64": hh_plain_ms_n64, "bound_ms_n64": hh_bound_ms_n64,
            "shapes": hh_shapes,
        },
    }


def _make_set(root: str, codec):
    from minio_tpu_torch.object.erasure import ErasureObjects
    from minio_tpu_torch.storage import format as fmt
    from minio_tpu_torch.storage.local import LocalDrive

    drives = []
    for i, f in enumerate(fmt.init_format(1, DRIVES)):
        d = os.path.join(root, f"d{i}")
        os.makedirs(d)
        f.save(d)
        drives.append(LocalDrive(d))
    eo = ErasureObjects(drives, parity=M, codec=codec)
    eo.make_bucket("bench")
    return eo, drives


def _data_dir(drive, key: str) -> str:
    obj = os.path.join(drive.root, "bench", key)
    return os.path.join(obj, next(n for n in os.listdir(obj) if n != "xl.meta"))


def _part_path(drive, key: str, part: int = 1) -> str:
    return os.path.join(_data_dir(drive, key), f"part.{part}")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _part_files(drives, key: str) -> list[bytes]:
    return [_read(_part_path(d, key)) for d in drives]


class Tally:
    """Counts each kernel's launches by shape beside the wrappers' own
    counts: the hash kernel's by (N, L) (its third and fourth arguments),
    the RS kernel's by (B, K, R, S) (its sixth to ninth). It also counts the
    calls into the numpy host codec and the kernels' plain versions, which no
    path may make on the card. reset() zeroes every count just before a
    path; read() reads them just after."""

    def __init__(self):
        from minio_tpu_torch.object.codec import HostCodec
        from minio_tpu_torch.ops import highwayhash as np_hh
        from minio_tpu_torch.ops import highwayhash_cuda, highwayhash_torch, rs_cuda, rs_ref

        self.kernels = {"rs_gf_apply": rs_cuda.KERNEL, "hh256": highwayhash_cuda.KERNEL}
        self.hh_by_nl: collections.Counter = collections.Counter()
        self.rs_by_bkrs: collections.Counter = collections.Counter()
        self.host_calls: collections.Counter = collections.Counter()
        self._lock = threading.Lock()
        hh_launch = highwayhash_cuda.KERNEL.launch
        rs_launch = rs_cuda.KERNEL.launch

        def hh_launch_tallied(*args):
            hh_launch(*args)
            with self._lock:
                self.hh_by_nl[(args[2], args[3])] += 1

        def rs_launch_tallied(*args):
            rs_launch(*args)
            with self._lock:
                self.rs_by_bkrs[(args[5], args[6], args[7], args[8])] += 1

        highwayhash_cuda.KERNEL.launch = hh_launch_tallied
        rs_cuda.KERNEL.launch = rs_launch_tallied
        host = [(HostCodec, n) for n in ("encode", "reconstruct", "reconstruct_batch", "digests_batch", "_digests")]
        host += [(np_hh, "hash256"), (np_hh, "hash256_batch"), (rs_ref, "encode"), (rs_ref, "reconstruct"),
                 (rs_cuda, "plain"), (highwayhash_torch, "hash256_batch")]
        self._restore = []
        for owner, name in host:
            real = getattr(owner, name)

            def counted(*args, _name=f"{owner.__name__}.{name}", _real=real, **kwargs):
                with self._lock:
                    self.host_calls[_name] += 1
                return _real(*args, **kwargs)

            setattr(owner, name, counted)
            self._restore.append((owner, name, real))

    def reset(self) -> None:
        from minio_tpu_torch.ops import native

        with self._lock:
            for k in self.kernels.values():
                k.launches = 0
            self.hh_by_nl.clear()
            self.rs_by_bkrs.clear()
            self.host_calls.clear()
            native.reset_calls()

    def read(self, path: str, need: tuple = ("rs_gf_apply", "hh256")) -> dict:
        """The counts of one path; raises if a kernel in `need` did not
        launch in it, or if the path called the host codec or a plain
        version."""
        from minio_tpu_torch.ops import native

        with self._lock:
            hh, rs = dict(self.hh_by_nl), dict(self.rs_by_bkrs)
            out = {
                "launches": {name: k.launches for name, k in self.kernels.items()},
                "hh256_by_n_l": dict(sorted(hh.items())),
                "rs_gf_apply_by_b_k_r_s": dict(sorted(rs.items())),
                "host_calls": dict(self.host_calls),
                "host_library_calls": native.calls(),
            }
        by_n: collections.Counter = collections.Counter()
        for (n, _), c in hh.items():
            by_n[n] += c
        by_b_r: collections.Counter = collections.Counter()
        by_b_k_r: collections.Counter = collections.Counter()
        for (b, k, r, _), c in rs.items():
            by_b_r[(b, r)] += c
            by_b_k_r[(b, k, r)] += c
        out["hh256_by_n"] = dict(sorted(by_n.items()))
        out["rs_gf_apply_by_b_r"] = dict(sorted(by_b_r.items()))
        for name in need:
            if out["launches"][name] == 0:
                raise AssertionError(f"kernel {name} was not launched on the {path} path")
        if out["host_calls"]:
            raise AssertionError(f"the {path} path called the host codec or a plain version: {out['host_calls']}")
        # The host library's RS and HH entry points: zero wherever the host
        # codec's counts are zero. Their only callers are the host codec and
        # the host bitrot helpers (the whole-file highwayhash256 layout),
        # which no card path uses.
        if out["host_library_calls"]:
            raise AssertionError(f"the {path} path called the host library's RS/HH: {out['host_library_calls']}")
        log(f"{path}: launches {json.dumps(out['launches'])}; hh256 by N "
            f"{json.dumps(out['hh256_by_n'])}; rs_gf_apply by (B, K, R) "
            f"{json.dumps({f'B={b},K={k},R={r}': c for (b, k, r), c in sorted(by_b_k_r.items())})}; "
            f"host codec and plain-version calls: 0; host library RS/HH calls: 0")
        return out

    def uninstall(self) -> None:
        for k in self.kernels.values():
            k.__dict__.pop("launch", None)
        for owner, name, real in self._restore:
            setattr(owner, name, real)


def _no_host_fallback(codec, path: str) -> None:
    st = codec.stats()
    fallback = {k: st[k] for k in ("host_fallback_blocks", "host_fallback_recon_blocks",
                                   "host_fallback_digest_chunks")}
    if any(fallback.values()):
        raise AssertionError(f"{path}: work went to the host codec: {fallback}")


def _rate(rates: dict | None, key: str, n_objects: int, seconds: float, nbytes: int) -> None:
    """Keep a direct-layer rate for phase 6 to print beside its own."""
    if rates is not None:
        rates[key] = {"objects_per_s": n_objects / seconds, "gib_per_s": nbytes / 2**30 / seconds}


def phase_slice(dev, smi: str, root: str, codec, tally: Tally, big_mib: int = 128, small_mib: int = 16,
                rates: dict | None = None):
    from minio_tpu_torch.object.codec import HostCodec
    from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

    rng = np.random.default_rng(20)
    big = rng.integers(0, 256, big_mib * MiB, dtype=np.uint8).tobytes()
    smalls = [rng.integers(0, 256, small_mib * MiB, dtype=np.uint8).tobytes() for _ in range(8)]
    payloads = {"big": big, **{f"small{i}": smalls[i] for i in range(8)}}
    eo, drives = _make_set(os.path.join(root, "gpu"), codec)
    tally.reset()

    t0 = time.perf_counter()
    eo.put_object("bench", "big", big)
    put_big = time.perf_counter() - t0
    put_big_launches = (tally.kernels["rs_gf_apply"].launches, tally.kernels["hh256"].launches)
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda i: eo.put_object("bench", f"small{i}", smalls[i]), range(8)))
    put_small = time.perf_counter() - t0

    def get_all():
        t = time.perf_counter()
        if eo.get_object("bench", "big")[1] != big:
            raise AssertionError("GET big: bytes differ")
        t_big = time.perf_counter() - t
        t = time.perf_counter()
        with cf.ThreadPoolExecutor(8) as ex:
            got = list(ex.map(lambda i: eo.get_object("bench", f"small{i}")[1], range(8)))
        if got != smalls:
            raise AssertionError("GET small: bytes differ")
        return t_big, time.perf_counter() - t

    get_big, get_small = get_all()
    # Lose the part files of 4 drives (their xl.meta stays): which shard
    # rows those drives hold varies per object, so some objects lose
    # data rows and their GETs rebuild them with the reconstruct kernel.
    # Their bytes are kept for phase 4's heal.
    lost = {}
    for key in payloads:
        for i in LOST:
            path = _part_path(drives[i], key)
            lost[(key, i)] = _read(path)
            os.remove(path)
    dget_big, dget_small = get_all()
    counts = tally.read("PUT/GET/degraded GET")
    st = codec.stats()
    if not (st["batches_run"] > 0 and st["recon_batches_run"] > 0 and st["digests_verified"] > 0):
        raise AssertionError(f"device counters did not move: {st}")
    _no_host_fallback(codec, "PUT/GET/degraded GET")
    gib_big, gib_small = big_mib / 1024, 8 * small_mib / 1024
    _rate(rates, "put_big", 1, put_big, big_mib * MiB)
    _rate(rates, "get_big", 1, get_big, big_mib * MiB)
    log(f"slice stats: {json.dumps(st)}")
    log(f"launches during the {big_mib} MiB PUT: rs_gf_apply {put_big_launches[0]}, "
        f"hh256 {put_big_launches[1]}")
    log(f"PUT {big_mib} MiB: {gib_big / put_big:.3f} GiB/s; "
        f"PUT 8x{small_mib} MiB concurrent: {gib_small / put_small:.3f} GiB/s [{smi}]")
    log(f"GET {big_mib} MiB: {gib_big / get_big:.3f} GiB/s; "
        f"GET 8x{small_mib} MiB concurrent: {gib_small / get_small:.3f} GiB/s [{smi}]")
    log(f"degraded GET (part files of 4 drives lost) {big_mib} MiB: {gib_big / dget_big:.3f} GiB/s; "
        f"8x{small_mib} MiB concurrent: {gib_small / dget_small:.3f} GiB/s [{smi}]")

    # Reference check: the same small object through a numpy HostCodec stack
    # must leave byte-identical part files on every drive.
    obj = rng.integers(0, 256, 3 * MiB + 37, dtype=np.uint8).tobytes()
    codec2 = BatchingDeviceCodec(max_batch=64, device=dev)
    try:
        eo_dev, drives_dev = _make_set(os.path.join(root, "ref-gpu"), codec2)
        eo_host, drives_host = _make_set(os.path.join(root, "ref-host"), HostCodec(use_native=False))
        eo_dev.put_object("bench", "ref", obj)
        eo_host.put_object("bench", "ref", obj)
        if _part_files(drives_dev, "ref") != _part_files(drives_host, "ref"):
            raise AssertionError("device and host codecs wrote different part files")
        if eo_dev.get_object("bench", "ref")[1] != obj:
            raise AssertionError("GET ref: bytes differ")
    finally:
        codec2.close()
    log("reference check ok: 16 part files byte-identical to the numpy host codec")
    return eo, drives, payloads, lost, counts


LOST = (3, 7, 11, 15)  # the drives whose part files phase 3 removes
OTHERS = (0, 4, 8, 12)  # removed after the heal, for a degraded GET


def _erasure_fields(fi) -> tuple:
    e = fi.erasure
    return (e.data_blocks, e.parity_blocks, e.block_size, e.index, list(e.distribution),
            [dict(c) for c in e.checksums], [(p.number, p.size) for p in fi.parts], fi.size)


def _raised(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class name is what is checked
        return type(e).__name__
    return "no error"


def phase_heal(smi: str, eo, drives, codec, tally: Tally, payloads: dict, lost: dict) -> dict:
    """Heal every object of phase 3, then a flipped byte, then a degraded
    GET of the healed set."""
    before = codec.stats()
    fields = {key: [_erasure_fields(d.read_version("bench", key)) for d in drives] for key in payloads}
    tally.reset()
    t0 = time.perf_counter()
    for key in payloads:
        res = eo.heal_object("bench", key)
        if res.disks_healed != len(LOST) or [
            i for i, s in enumerate(res.after_drive_state) if s == "healed"
        ] != list(LOST):
            raise AssertionError(f"heal {key}: {res}")
    heal_s = time.perf_counter() - t0
    counts = tally.read("heal")
    after = codec.stats()
    for key in payloads:
        for i in LOST:
            if _read(_part_path(drives[i], key)) != lost[(key, i)]:
                raise AssertionError(f"heal {key}: drive {i}'s part file differs from the removed one")
        if [_erasure_fields(d.read_version("bench", key)) for d in drives] != fields[key]:
            raise AssertionError(f"heal {key}: xl.meta erasure fields changed")
    moved = {k: after[k] - before[k] for k in
             ("recon_batches_run", "blocks_reconstructed", "digests_verified", "host_fallback_recon_blocks",
              "verify_batches_run", "device_recon_seconds", "device_verify_seconds")}
    if moved["recon_batches_run"] <= 0 or moved["digests_verified"] <= 0:
        raise AssertionError(f"heal: device counters did not move: {moved}")
    _no_host_fallback(codec, "heal")
    windows = sum(-(-len(p) // MiB // 16) for p in payloads.values())
    if counts["rs_gf_apply_by_b_r"].get((16, len(LOST)), 0) != windows:
        raise AssertionError(f"heal: expected {windows} reconstructs at (16, 4): {counts}")
    if counts["hh256_by_n"].get(16 * len(LOST), 0) < windows:
        raise AssertionError(f"heal: expected >= {windows} rebuilt-row hashes at N = 64: {counts}")
    nbytes = sum(len(p) for p in payloads.values())
    log(f"heal stats moved: {json.dumps(moved)}")
    log(f"heal of {len(payloads)} objects ({nbytes / MiB:.0f} MiB, 4 lost drives each): "
        f"{nbytes / 2**30 / heal_s:.3f} GiB/s [{smi}]")

    # One flipped byte in a healthy row of the big object.
    path = _part_path(drives[1], "big")
    good = _read(path)
    with open(path, "r+b") as f:
        f.seek(2 * (S_FULL + 32) + 32 + 999)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x3C]))
    tally.reset()
    res = eo.heal_object("bench", "big")
    counts_flip = tally.read("heal of a flipped byte")
    _no_host_fallback(codec, "heal of a flipped byte")
    if res.disks_healed != 1 or res.after_drive_state[1] != "healed" or _read(path) != good:
        raise AssertionError(f"heal of a flipped byte: {res}")
    log("heal of one flipped byte ok: 1 drive healed, the file restored")

    # The healed set serves a GET with the part files of 4 other drives gone.
    for key in payloads:
        for i in OTHERS:
            os.remove(_part_path(drives[i], key))
    for key, data in payloads.items():
        if eo.get_object("bench", key)[1] != data:
            raise AssertionError(f"GET {key} after heal: bytes differ")
    log(f"GET of all {len(payloads)} healed objects byte-exact with drives {OTHERS} removed")
    return {"heal": counts, "heal_flipped_byte": counts_flip}


def phase_multipart(smi: str, root: str, eo, codec, tally: Tally, part_mib: int = 8,
                    rates: dict | None = None) -> dict:
    from minio_tpu_torch.object.codec import HostCodec

    rng = np.random.default_rng(21)
    parts = [rng.integers(0, 256, part_mib * MiB, dtype=np.uint8).tobytes() for _ in range(4)]
    parts.append(rng.integers(0, 256, MiB + 37, dtype=np.uint8).tobytes())
    data = b"".join(parts)

    def upload(target) -> tuple:
        mp = target.multipart
        uid = mp.new_multipart_upload("bench", "mp")
        with cf.ThreadPoolExecutor(4) as ex:
            infos = list(ex.map(lambda n: mp.put_object_part("bench", "mp", uid, n, parts[n - 1]), range(1, 5)))
        infos.append(mp.put_object_part("bench", "mp", uid, 5, parts[4]))
        return mp.complete_multipart_upload("bench", "mp", uid, [(p.number, p.etag) for p in infos])

    before = codec.stats()
    tally.reset()
    t0 = time.perf_counter()
    oi = upload(eo)
    mp_s = time.perf_counter() - t0
    counts = tally.read("multipart")
    _no_host_fallback(codec, "multipart")
    after = codec.stats()
    log("multipart stats moved: " + json.dumps({k: after[k] - before[k] for k in (
        "batches_run", "blocks_encoded", "blocks_padded", "host_fallback_blocks", "device_encode_seconds")}))
    if not oi.etag.endswith("-5") or oi.size != len(data):
        raise AssertionError(f"multipart: {oi}")
    if eo.get_object("bench", "mp")[1] != data:
        raise AssertionError("multipart GET: bytes differ")
    _rate(rates, "multipart", 1, mp_s, len(data))
    log(f"multipart PUT ({len(parts)} parts, {len(data) / MiB:.2f} MiB, 4 parts from 4 threads): "
        f"{len(data) / 2**30 / mp_s:.3f} GiB/s [{smi}]")
    # The same upload through a numpy HostCodec set: same part.N files.
    eo_host, drives_host = _make_set(os.path.join(root, "mp-host"), HostCodec(use_native=False))
    oi_host = upload(eo_host)
    if oi_host.etag != oi.etag:
        raise AssertionError(f"multipart: ETag {oi.etag} differs from the host codec's {oi_host.etag}")
    for i, (d, h) in enumerate(zip(eo.disks, drives_host)):
        for n in range(1, 6):
            if _read(_part_path(d, "mp", n)) != _read(_part_path(h, "mp", n)):
                raise AssertionError(f"multipart: drive {i} part.{n} differs from the host codec's")
    # An aborted upload leaves the listing.
    uid = eo.multipart.new_multipart_upload("bench", "mp-aborted")
    eo.multipart.put_object_part("bench", "mp-aborted", uid, 1, parts[4])
    listed = [u["upload_id"] for u in eo.multipart.list_multipart_uploads("bench")]
    eo.multipart.abort_multipart_upload("bench", "mp-aborted", uid)
    if uid not in listed or uid in [u["upload_id"] for u in eo.multipart.list_multipart_uploads("bench")]:
        raise AssertionError("multipart: the aborted upload is still listed")
    log("multipart ok: ETag -5, GET byte-exact, 80 part files byte-identical to the numpy host codec, "
        "abort leaves the listing")
    return {"multipart": counts}


def phase_object_ops(eo, drives) -> None:
    """The operations that run no kernel, once each."""
    from minio_tpu_torch.control import tiering
    from minio_tpu_torch.object.types import DeleteObjectOptions, PutObjectOptions

    eo.put_object_metadata("bench", "small0", updates={"x-amz-meta-color": "blue"})
    if eo.get_object_info("bench", "small0").user_defined.get("x-amz-meta-color") != "blue":
        raise AssertionError("put_object_metadata: not applied")
    eo.put_object("bench", "versioned", b"v" * 300_000, PutObjectOptions(versioned=True))
    marker = eo.delete_object("bench", "versioned", DeleteObjectOptions(versioned=True))
    if not marker.delete_marker or _raised(lambda: eo.get_object("bench", "versioned")) != "ObjectNotFound":
        raise AssertionError("delete marker: the object still reads")
    eo.delete_object("bench", "small7")
    if _raised(lambda: eo.get_object("bench", "small7")) != "ObjectNotFound":
        raise AssertionError("physical delete: the object still reads")
    eo.make_bucket("empty")
    if [b.name for b in eo.list_buckets()] != ["bench", "empty"]:
        raise AssertionError(f"list_buckets: {eo.list_buckets()}")
    if _raised(lambda: eo.delete_bucket("bench")) != "BucketNotEmpty":
        raise AssertionError("delete_bucket: a non-empty bucket was not refused")
    eo.delete_bucket("empty")
    if [b.name for b in eo.list_buckets()] != ["bench"]:
        raise AssertionError("delete_bucket: the empty bucket is still listed")
    eo.transition_object("bench", "small6", "", "WARM", "remote/small6")
    for i in (2, 9):
        shutil.rmtree(os.path.join(drives[i].root, "bench", "small6"))
    res = eo.heal_object("bench", "small6")
    meta = drives[9].read_version("bench", "small6").metadata
    if res.disks_healed != 2 or meta.get(tiering.META_TRANSITION_STATUS) != tiering.STATUS_COMPLETE:
        raise AssertionError(f"heal of a transitioned version: {res}")
    log("put_object_metadata, delete marker, physical delete, list_buckets, delete_bucket, "
        "transition_object + metadata heal ok")


def phase_whole_file(eo, drives, tally: Tally) -> dict:
    from minio_tpu_torch.object.types import PutObjectOptions

    data = np.random.default_rng(22).integers(0, 256, 3 * MiB + 37, dtype=np.uint8).tobytes()
    tally.reset()
    eo.put_object("bench", "whole", data, PutObjectOptions(bitrot_algorithm="sha256"))
    counts = tally.read("whole-file PUT")
    if eo.get_object("bench", "whole")[1] != data:
        raise AssertionError("whole-file GET: bytes differ")
    path = _part_path(drives[5], "whole")
    good = _read(path)
    os.remove(path)
    res = eo.heal_object("bench", "whole")
    if res.disks_healed != 1 or _read(path) != good:
        raise AssertionError(f"whole-file heal: {res}")
    sums = drives[5].read_version("bench", "whole").erasure.checksums
    if [(c["part"], c["algo"]) for c in sums] != [(1, "sha256")]:
        raise AssertionError(f"whole-file heal: checksums {sums}")
    log("whole-file layout (sha256) ok: PUT, GET byte-exact, heal of one lost row")
    return {"whole_file_put": counts}


# -- phase 5: erasure sets and server pools ------------------------------------------------

POOL_DRIVES = (32, 16)  # pool 0: 2 sets of 16; pool 1, attached later: 1 set of 16
SET_DRIVES = 16
TENANTS, DAYS = 16, 8


def _size_class(n: int) -> str:
    if n < 4 << 10:
        return "<4KiB"
    if n < 128 << 10:
        return "4-128KiB inline"
    if n < MiB:
        return "128KiB-1MiB small path"
    return ">=1MiB full blocks"


class Traffic:
    """The objects of phase 5, all from one numpy generator: names
    tenant-XX/YYYY-MM-DD/obj-NNNNN over 16 tenants (or `tenants`) and 8
    days, sizes log-uniform from 1 KiB to 4 MiB, one object in 8
    REDUCED_REDUNDANCY. The bytes are one buffer made in bulk; each object
    is a view of it."""

    def __init__(self, seed: int, n: int, max_size: int = 4 * MiB, stem: str = "obj", tenants: int = TENANTS):
        rng = np.random.default_rng(seed)
        tenants = rng.integers(0, tenants, n)
        days = rng.integers(0, DAYS, n)
        self.names = [f"tenant-{t:02d}/2024-01-{d + 1:02d}/{stem}-{i:05d}"
                      for i, (t, d) in enumerate(zip(tenants, days))]
        self.sizes = np.exp(rng.uniform(np.log(1 << 10), np.log(max_size), n)).astype(np.int64)
        self.rrs = rng.permutation(n) < n // 8
        offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self._buf = memoryview(rng.bytes(int(offsets[-1])))
        self.data = {name: self._buf[offsets[i]:offsets[i + 1]] for i, name in enumerate(self.names)}
        self.storage_class = {name: "REDUCED_REDUNDANCY" if r else "" for name, r in zip(self.names, self.rrs)}
        self.rng = rng


def _pool_drives(root: str, n_sets: int, formats=None) -> tuple:
    from minio_tpu_torch.storage import format as fmt
    from minio_tpu_torch.storage.local import LocalDrive

    formats = formats or fmt.init_format(n_sets, SET_DRIVES)
    drives = []
    for i, f in enumerate(formats):
        d = os.path.join(root, f"d{i}")
        os.makedirs(d)
        f.save(d)
        drives.append(LocalDrive(d))
    return drives, formats


def _in_threads(fn, items, threads: int) -> list:
    with cf.ThreadPoolExecutor(threads) as ex:
        return list(ex.map(fn, items))


def _list_all(layer, bucket: str, **kwargs) -> tuple[list[str], list[str], int]:
    """Page a V1 listing through with next_marker: (keys, prefixes, pages)."""
    keys, prefixes, marker, pages = [], [], "", 0
    while True:
        res = layer.list_objects(bucket, marker=marker, **kwargs)
        pages += 1
        keys += [o.name for o in res.objects]
        prefixes += res.prefixes
        if not res.is_truncated:
            return keys, prefixes, pages
        marker = res.next_marker


def _version_pages(layer) -> tuple[list, int]:
    """Page list_object_versions of bucket "versions" through with key and
    version markers, 5 entries a page."""
    seen, km, vm, pages = [], "", "", 0
    while True:
        res = layer.list_object_versions("versions", prefix="v/", key_marker=km, version_marker=vm, max_keys=5)
        pages += 1
        seen += [(o.name, o.version_id, o.is_latest, o.delete_marker) for o in res.objects]
        if not res.is_truncated:
            return seen, pages
        km, vm = res.next_key_marker, res.next_version_marker


def _holders(layer, name: str) -> list[tuple[int, int]]:
    """(pool, drive) of every drive holding name's xl.meta."""
    return [
        (p, i)
        for p, sets in enumerate(layer.pools)
        for i, d in enumerate(sets.disks)
        if os.path.exists(os.path.join(d.root, "bench", name, "xl.meta"))
    ]


def _object_files(drive, name: str) -> dict:
    """Every file of an unversioned object's directory on one drive, by
    file name: xl.meta, and part.N under its data directory (whose name is
    a random uuid per PUT)."""
    top = os.path.join(drive.root, "bench", name)
    out = {}
    for dirpath, _, files in os.walk(top):
        for f in files:
            out[f] = _read(os.path.join(dirpath, f))
    return out


def _device_ms(counts: dict, kernels: dict) -> float:
    """A path's device time, estimated from its launches: each at phase 2's
    time for its shape. The hash by row length, interpolated between the
    lengths phase 2 timed (the kernel's time is flat in N to 2,048
    streams), shorter rows
    at the shortest one's time; the RS kernel at the [64, 12+4, 87382]
    encode's time scaled by the bytes it moves, never under the small-path
    batch's time."""
    hh = kernels["hh256"]
    points = sorted([(2731, hh["shapes"][1]["ms"]), (S_RRS, hh["shapes"][0]["ms"]), (S_FULL, hh["ms_n16"])])
    ms = 0.0
    for (_, length), c in counts["hh256_by_n_l"].items():
        for (l0, t0), (l1, t1) in zip(points, points[1:]):
            if length <= l1:
                t = t0 if length <= l0 else t0 + (t1 - t0) * (length - l0) / (l1 - l0)
                break
        else:
            t = points[-1][1] * length / points[-1][0]
        ms += c * t
    rs = kernels["rs_gf_apply"]
    full_bytes = 64 * (K + M) * S_FULL
    floor = min(sh["ms"] for sh in rs["shapes"] if sh["layout"] == "small-path batch")
    for (b, k, r, s_len), c in counts["rs_gf_apply_by_b_k_r_s"].items():
        ms += c * max(floor, rs["ms"] * b * (k + r) * s_len / full_bytes)
    return ms


def _shape_summary(counts: dict) -> dict:
    """Launches by shape class: hh256 by row length (and N), rs_gf_apply
    by (K, R) and whether S is a small-path padded length (a power of two)."""
    hh: collections.Counter = collections.Counter()
    for (_, length), c in counts["hh256_by_n_l"].items():
        if length in (S_FULL, S_RRS):
            hh[f"L={length}"] += c
        else:
            hh["L<=4096" if length <= 4096 else "L 4097-87381"] += c
    rs: collections.Counter = collections.Counter()
    for (_, k, r, s_len), c in counts["rs_gf_apply_by_b_k_r_s"].items():
        if s_len in SMALL_PADDED:
            shape = f"padded S={s_len}"
        else:
            shape = f"S={s_len}" if s_len in (S_FULL, S_RRS) else "S other"
        rs[f"K={k},R={r},{shape}"] += c
    return {"hh256": dict(sorted(hh.items())), "rs_gf_apply": dict(sorted(rs.items()))}


def phase_pools(smi: str, root: str, codec, tally: Tally, kernels: dict, n_objects: int = 256, threads: int = 16,
                max_size: int = 4 * MiB, seed: int = 5, rates: dict | None = None) -> tuple[dict, SimpleNamespace]:
    """A 48-drive deployment through ServerPools: see the module docstring.
    Returns the paths' counts and the deployment as it stands after the
    heal, for phase 6."""
    from minio_tpu_torch import ErasureSets, ServerPools
    from minio_tpu_torch.object import pools as pools_mod
    from minio_tpu_torch.object.codec import HostCodec
    from minio_tpu_torch.object.types import DeleteObjectOptions, PutObjectOptions

    t_gen = time.perf_counter()
    traffic = Traffic(seed, n_objects, max_size)
    total_bytes = int(traffic.sizes.sum())
    log(f"pools traffic: {n_objects} objects, {total_bytes / MiB:.1f} MiB, made in "
        f"{time.perf_counter() - t_gen:.2f} s; by size class "
        f"{json.dumps(collections.Counter(_size_class(int(n)) for n in traffic.sizes))}, "
        f"{int(traffic.rrs.sum())} REDUCED_REDUNDANCY")
    drives0, formats0 = _pool_drives(os.path.join(root, "pool0"), POOL_DRIVES[0] // SET_DRIVES)
    layer = ServerPools([ErasureSets.from_drives(drives0, formats0[0], codec=codec, pool_index=0)])
    layer.make_bucket("bench")
    sets0 = layer.pools[0]
    if [len(s.disks) for s in sets0.sets] != [16, 16] or sets0.sets[0].parity != 4 or sets0.sets[0].rrs_parity != 2:
        raise AssertionError("pool 0 is not 2 sets of 12+4 with 14+2 RRS")
    n0 = n_objects * 3 // 4
    first, rest = traffic.names[:n0], traffic.names[n0:]
    paths = {}

    def put(name, data=None):
        return layer.put_object("bench", name, traffic.data[name] if data is None else data,
                                PutObjectOptions(storage_class=traffic.storage_class[name]))

    def rate(label: str, names: list, seconds: float, nbytes: int) -> str:
        return (f"{label}: {len(names)} objects in {seconds:.3f} s, {len(names) / seconds:.1f} objects/s, "
                f"{nbytes / 2**30 / seconds:.4f} GiB/s [{smi}]")

    clock_keys = ("device_encode_seconds", "batches_run", "small_batches_run", "small_blocks_encoded",
                  "device_verify_seconds", "verify_batches_run", "digests_verified",
                  "device_recon_seconds", "recon_batches_run")

    def clock(label: str, before: dict, wall_s: float) -> None:
        """The codec's own clocks over a path (summed over threads: device
        work with its host staging and copies) beside its wall time."""
        after = codec.stats()
        log(f"{label} codec clocks over {wall_s:.3f} s of wall time: "
            + json.dumps({k: round(after[k] - before[k], 4) for k in clock_keys}))

    # 1. PUT into pool 0.
    before = codec.stats()
    tally.reset()
    t0 = time.perf_counter()
    _in_threads(put, first, threads)
    put0_s = time.perf_counter() - t0
    paths["pools_put_pool0"] = tally.read("pools: PUT into pool 0")
    _no_host_fallback(codec, "pools: PUT into pool 0")
    bytes0 = sum(len(traffic.data[n]) for n in first)
    log(rate(f"pools PUT into pool 0 ({threads} threads)", first, put0_s, bytes0))
    _rate(rates, "pools_put_pool0", len(first), put0_s, bytes0)
    clock("pools PUT into pool 0", before, put0_s)

    # Bytes against the host codec: a sample of 32 objects of every size
    # class and both storage classes, PUT again into a numpy HostCodec copy
    # of pool 0 (the same formats), must leave the same part files and
    # inline data on every drive.
    by_class = collections.defaultdict(list)
    for name in first:
        by_class[(_size_class(len(traffic.data[name])), traffic.storage_class[name])].append(name)
    sample = []
    for key in sorted(by_class):
        names = sorted(by_class[key], key=lambda n: len(traffic.data[n]))
        sample += names[: max(1, 32 // len(by_class))]
    sample = sample[:32]
    host_drives, _ = _pool_drives(os.path.join(root, "host-pool0"), 2, formats0)
    host_sets = ErasureSets.from_drives(host_drives, formats0[0], codec=HostCodec(use_native=False), pool_index=0)
    host_sets.make_bucket("bench")
    for name in sample:
        host_sets.put_object("bench", name, traffic.data[name],
                             PutObjectOptions(storage_class=traffic.storage_class[name]))
        for i, (d, h) in enumerate(zip(drives0, host_drives)):
            got, want = _object_files(d, name), _object_files(h, name)
            if {k for k in got if k != "xl.meta"} != {k for k in want if k != "xl.meta"}:
                raise AssertionError(f"reference {name}: drive {i} holds other files than the host codec's")
            for k in got:
                if k != "xl.meta" and got[k] != want[k]:
                    raise AssertionError(f"reference {name}: drive {i} {k} differs from the host codec's")
            if got and d.read_version("bench", name).inline_data != h.read_version("bench", name).inline_data:
                raise AssertionError(f"reference {name}: drive {i} inline data differs from the host codec's")
    shutil.rmtree(os.path.join(root, "host-pool0"))
    covered = collections.Counter(
        f"{_size_class(len(traffic.data[n]))}/{traffic.storage_class[n] or 'STANDARD'}" for n in sample
    )
    log(f"reference check ok: {len(sample)} objects ({json.dumps(dict(sorted(covered.items())))}): "
        f"byte-identical part files and inline data against the numpy host codec")

    # 2. Listing of one pool: exact, in pages of 1,000, with and without a
    # delimiter and a prefix; the second page comes from the metacache.
    want0 = sorted(first)
    walks, hits = sets0.metacache.walks, sets0.metacache.hits
    t0 = time.perf_counter()
    keys, prefixes, pages = _list_all(layer, "bench", max_keys=1000)
    list_s = time.perf_counter() - t0
    if keys != want0 or prefixes:
        raise AssertionError(f"listing of pool 0: {len(keys)} keys, want {len(want0)}")
    if sets0.metacache.walks - walks != 1 or sets0.metacache.hits - hits != pages - 1:
        raise AssertionError(f"metacache: {sets0.metacache.walks - walks} walks and "
                             f"{sets0.metacache.hits - hits} hits over {pages} pages")
    t0 = time.perf_counter()
    keys_warm, _, pages_warm = _list_all(layer, "bench", max_keys=1000)
    list_warm_s = time.perf_counter() - t0
    if keys_warm != want0:
        raise AssertionError("listing of pool 0 from the metacache differs")
    keys, prefixes, _ = _list_all(layer, "bench", delimiter="/", max_keys=1000)
    if keys or prefixes != sorted({n.split("/")[0] + "/" for n in first}):
        raise AssertionError(f"delimiter listing of pool 0: {keys[:3]}, {prefixes}")
    tenant = first[0].split("/")[0] + "/"
    keys, prefixes, _ = _list_all(layer, "bench", prefix=tenant, delimiter="/", max_keys=1000)
    if keys or prefixes != sorted({n[: n.rindex("/") + 1] for n in first if n.startswith(tenant)}):
        raise AssertionError(f"prefix+delimiter listing of pool 0: {prefixes}")
    day = first[0][: first[0].rindex("/") + 1]
    keys, prefixes, _ = _list_all(layer, "bench", prefix=day, max_keys=7)
    if keys != sorted(n for n in first if n.startswith(day)) or prefixes:
        raise AssertionError(f"prefix listing of pool 0 in pages of 7: {len(keys)} keys")
    log(f"listing of pool 0 exact ({len(want0)} keys; delimiter, prefix and prefix+delimiter too): "
        f"{pages} pages in {list_s:.3f} s ({pages / list_s:.2f} pages/s, 1 walk, then metacache hits), "
        f"again from the metacache {pages_warm} pages in {list_warm_s:.4f} s "
        f"({pages_warm / list_warm_s:.1f} pages/s) [{smi}]")

    # list_object_versions over versioned overwrites and a delete marker,
    # paged with key and version markers (one pool: the reference's
    # two-pool merge drops the truncation of a full page).
    layer.make_bucket("versions")
    for v in range(3):
        for i in range(8):
            layer.put_object("versions", f"v/obj-{i}", traffic.rng.bytes(1000 + 997 * i),
                             PutObjectOptions(versioned=True))
    layer.delete_object("versions", "v/obj-3", DeleteObjectOptions(versioned=True))
    seen, vpages = _version_pages(layer)
    if len(seen) != 25 or len(set(seen)) != 25 or [s[0] for s in seen] != sorted(s[0] for s in seen):
        raise AssertionError(f"list_object_versions: {len(seen)} entries over {vpages} pages")
    if [(s[0], s[3]) for s in seen if s[2]] != [(f"v/obj-{i}", i == 3) for i in range(8)]:
        raise AssertionError("list_object_versions: latest flags or the delete marker are wrong")
    log(f"list_object_versions ok: 25 versions (8 keys x 3, 1 delete marker) in {vpages} pages of 5")

    # 3. Attach pool 1 (SUSPENDED, then ACTIVE) and drain pool 0: the other
    # objects and 64 overwrites of pool-0 keys land in pool 1.
    drives1, formats1 = _pool_drives(os.path.join(root, "pool1"), POOL_DRIVES[1] // SET_DRIVES)
    idx = layer.add_pool(ErasureSets.from_drives(drives1, formats1[0], codec=codec, pool_index=1))
    if layer.statuses[idx] != pools_mod.POOL_SUSPENDED:
        raise AssertionError("add_pool: pool 1 is not SUSPENDED")
    for bucket in ("bench", "versions"):
        layer.pools[idx].make_bucket(bucket)
    layer.set_pool_status(idx, pools_mod.POOL_ACTIVE)
    layer.set_pool_status(0, pools_mod.POOL_DRAINING)
    over = sorted(traffic.rng.choice(len(first), size=min(64, len(first) // 8), replace=False))
    overwritten = {first[i]: traffic.rng.bytes(len(traffic.data[first[i]])) for i in over}
    before = codec.stats()
    tally.reset()
    t0 = time.perf_counter()
    _in_threads(put, rest, threads)
    _in_threads(lambda name: put(name, overwritten[name]), list(overwritten), threads)
    put1_s = time.perf_counter() - t0
    paths["pools_put_pool1"] = tally.read("pools: PUT into pool 1 and overwrites")
    _no_host_fallback(codec, "pools: PUT into pool 1 and overwrites")
    bytes1 = sum(len(traffic.data[n]) for n in rest) + sum(len(v) for v in overwritten.values())
    log(rate(f"pools PUT into pool 1 + {len(overwritten)} overwrites ({threads} threads)", rest + list(overwritten), put1_s, bytes1))
    _rate(rates, "pools_put_pool1", len(rest) + len(overwritten), put1_s, bytes1)
    clock("pools PUT into pool 1", before, put1_s)
    current = {name: traffic.data[name] for name in traffic.names}
    current.update(overwritten)

    # Placement: every object's xl.meta only on the drives of its hashed set.
    in_pool0, in_pool1 = set(first), set(rest) | set(overwritten)
    for name in traffic.names:
        held = _holders(layer, name)
        want = []
        if name in in_pool0:
            s = sets0.get_set_index(name)
            want += [(0, s * SET_DRIVES + i) for i in range(SET_DRIVES)]
        if name in in_pool1:
            want += [(1, i) for i in range(SET_DRIVES)]
        if held != want:
            raise AssertionError(f"placement of {name}: {held[:4]}..., want {want[:4]}...")
    per_set = collections.Counter(sets0.get_set_index(n) for n in first)
    log(f"placement ok: pool 0 sets hold {dict(sorted(per_set.items()))} objects, pool 1 holds "
        f"{len(rest)} new + {len(overwritten)} overwrites, each only on its hashed set's 16 drives")

    # 4. GET all, byte-exact; an overwritten key reads its new bytes.
    before = codec.stats()
    tally.reset()
    t0 = time.perf_counter()
    got = _in_threads(lambda name: layer.get_object("bench", name)[1] == current[name], traffic.names, threads)
    get_s = time.perf_counter() - t0
    paths["pools_get"] = tally.read("pools: GET", need=("hh256",))
    _no_host_fallback(codec, "pools: GET")
    if not all(got):
        raise AssertionError(f"pools GET: {got.count(False)} objects differ")
    log(rate(f"pools GET, byte-exact ({threads} threads)", traffic.names, get_s, sum(len(v) for v in current.values())))
    _rate(rates, "pools_get", len(traffic.names), get_s, sum(len(v) for v in current.values()))
    clock("pools GET", before, get_s)

    # 5. Listing across both pools: exact without a delimiter; the
    # delimiter listing is printed against what is expected, since the
    # reference's multi-pool delimiter merge can skip keys.
    want_all = sorted(traffic.names)
    t0 = time.perf_counter()
    keys, _, pages = _list_all(layer, "bench", max_keys=1000)
    list2_s = time.perf_counter() - t0
    if keys != want_all:
        raise AssertionError(f"two-pool listing: {len(keys)} keys, want {len(want_all)}")
    dkeys, prefixes, dpages = _list_all(layer, "bench", delimiter="/", max_keys=1000)
    want_prefixes = sorted({n.split("/")[0] + "/" for n in traffic.names})
    log(f"two-pool listing exact: {len(keys)} keys in {pages} pages, {list2_s:.3f} s ({pages / list2_s:.2f} pages/s) "
        f"[{smi}]; delimiter listing (not held, see ROADMAP): {len(dkeys)} keys and {len(prefixes)} prefixes "
        f"in {dpages} pages, expected 0 keys and {len(want_prefixes)} prefixes, "
        f"{len(set(want_prefixes) - set(prefixes))} missing")

    seen, vpages = _version_pages(layer)
    log(f"two-pool list_object_versions (not held, see ROADMAP): {len(seen)} of 25 versions in {vpages} pages of 5")

    # 6. Bulk delete of 256 keys (some overwritten: both copies go).
    victims = sorted(str(n) for n in traffic.rng.choice(traffic.names, size=min(256, len(traffic.names) // 4),
                                                         replace=False))
    victims_set = set(victims)
    res = layer.delete_objects("bench", [(n, "") for n in victims])
    if any(e is not None for _, e in res):
        raise AssertionError(f"delete_objects: {[e for _, e in res if e is not None][:3]}")
    keys, _, _ = _list_all(layer, "bench", max_keys=1000)
    if keys != sorted(set(traffic.names) - set(victims)):
        raise AssertionError(f"listing after delete_objects: {len(keys)} keys")
    live = [n for n in traffic.names if n not in victims_set]
    log(f"delete_objects ok: {len(victims)} keys gone from the listing, {len(keys)} left")

    # 7. Degraded GET and heal: the part files and xl.meta of 4 drives of
    # pool 0's set 1 are removed (2 of them for a REDUCED_REDUNDANCY
    # object: 14+2 survives 2 losses, not 4).
    lost_drives = (1, 6, 11, 12)
    set1 = sets0.sets[1].disks
    targets = [n for n in first if sets0.get_set_index(n) == 1 and n not in victims_set and n not in overwritten]
    removed = {}
    for name in targets:
        lost = lost_drives[:2] if traffic.storage_class[name] else lost_drives
        for i in lost:
            fi = set1[i].read_version("bench", name)
            removed[(name, i)] = (_object_files(set1[i], name), _erasure_fields(fi), fi.inline_data)
            shutil.rmtree(os.path.join(set1[i].root, "bench", name))
    before = codec.stats()
    tally.reset()
    t0 = time.perf_counter()
    got = _in_threads(lambda name: layer.get_object("bench", name)[1] == current[name], targets, threads)
    dget_s = time.perf_counter() - t0
    paths["pools_degraded_get"] = tally.read("pools: degraded GET")
    _no_host_fallback(codec, "pools: degraded GET")
    if not all(got):
        raise AssertionError(f"pools degraded GET: {got.count(False)} objects differ")
    log(rate(f"pools degraded GET of pool 0's set 1 (4 drives lost; 2 for RRS), byte-exact ({threads} threads)",
             targets, dget_s, sum(len(current[n]) for n in targets)))
    _rate(rates, "pools_degraded_get", len(targets), dget_s, sum(len(current[n]) for n in targets))
    clock("pools degraded GET", before, dget_s)
    before = codec.stats()
    tally.reset()
    t0 = time.perf_counter()
    results = _in_threads(lambda name: layer.heal_object("bench", name), targets, threads)
    heal_s = time.perf_counter() - t0
    paths["pools_heal"] = tally.read("pools: heal")
    _no_host_fallback(codec, "pools: heal")
    clock("pools heal", before, heal_s)
    for name, res in zip(targets, results):
        lost = lost_drives[:2] if traffic.storage_class[name] else lost_drives
        if res.disks_healed != len(lost):
            raise AssertionError(f"heal {name}: {res}")
        for i in lost:
            files, fields, inline = removed[(name, i)]
            if _object_files(set1[i], name).keys() != files.keys():
                raise AssertionError(f"heal {name}: drive {i} holds other files")
            for k, v in _object_files(set1[i], name).items():
                if k != "xl.meta" and v != files[k]:
                    raise AssertionError(f"heal {name}: drive {i} {k} differs from the removed file")
            fi = set1[i].read_version("bench", name)
            if _erasure_fields(fi) != fields or fi.inline_data != inline:
                raise AssertionError(f"heal {name}: drive {i} xl.meta erasure fields or inline data differ")
    log(rate(f"pools heal of pool 0's set 1, byte-identical ({threads} threads)", targets, heal_s,
             sum(len(current[n]) for n in targets)))

    # 8. heal_bucket: one drive of pool 1 loses the bucket's directory.
    shutil.rmtree(os.path.join(drives1[5].root, "bench"))
    layer.heal_bucket("bench")
    if not os.path.isdir(os.path.join(drives1[5].root, "bench")):
        raise AssertionError("heal_bucket: the bucket directory was not recreated")
    some = [n for n in live if n in rest][:16]
    if not all(layer.get_object("bench", n)[1] == current[n] for n in some):
        raise AssertionError("GET after heal_bucket: bytes differ")
    log(f"heal_bucket ok: the bucket directory is back, {len(some)} pool-1 objects read byte-exact")

    walls = {"pools_put_pool0": put0_s, "pools_put_pool1": put1_s, "pools_get": get_s,
             "pools_degraded_get": dget_s, "pools_heal": heal_s}
    for path, counts in paths.items():
        summary = _shape_summary(counts)
        dev_ms = _device_ms(counts, kernels)
        log(f"{path}: launches by shape class {json.dumps(summary)}; device time estimated from them "
            f"{dev_ms / 1e3:.3f} s of {walls[path]:.3f} s wall ({100 * dev_ms / 1e3 / walls[path]:.2f}%)")
    rs_shapes = {(k, r, s_len) for counts in paths.values() for (_, k, r, s_len) in counts["rs_gf_apply_by_b_k_r_s"]}
    if (K_RRS, 2, S_RRS) not in rs_shapes:
        raise AssertionError("phase 5 launched no RS encode at K = 14, R = 2")
    if not any(s_len in SMALL_PADDED for (_, _, s_len) in rs_shapes):
        raise AssertionError("phase 5 launched no small-path RS batch")
    hh_lens = {length for counts in paths.values() for (_, length) in counts["hh256_by_n_l"]}
    if S_RRS not in hh_lens:
        raise AssertionError("phase 5 launched no hh256 at 74,899 bytes (1 MiB / 14)")
    state = SimpleNamespace(layer=layer, traffic=traffic, seed=seed, max_size=max_size, first=first,
                            overwritten=set(overwritten), live=live, sets0=sets0)
    return paths, state


# -- the observability planes (phases 6 and 7) -----------------------------------------------

API_CHILD_SPANS = ("auth", "body-read", "response-write")


class Planes:
    """The port's always-on planes around one path: reset() zeroes the stage
    ledger and the copy ledger and notes the degrade counters; read() prints
    the per-stage table (count, p50, p99, wall and cpu sums), the copies per
    payload byte on each hop and the degrade deltas, and holds the checks:
    one api root span per request the client sent, and one codec
    verify-batch record per object frame-parse record."""

    def __init__(self):
        from minio_tpu_torch.control.degrade import GLOBAL_DEGRADE
        from minio_tpu_torch.control.perf import GLOBAL_PERF, summarize
        from minio_tpu_torch.control.profiler import GLOBAL_PROFILER

        self.ledger, self.copy, self.degrade = GLOBAL_PERF.ledger, GLOBAL_PROFILER.copy, GLOBAL_DEGRADE
        self.summarize = summarize
        self._deg0 = GLOBAL_DEGRADE.snapshot()

    def reset(self) -> None:
        self.ledger.reset()
        self.copy.reset()
        self._deg0 = self.degrade.snapshot()

    def degrade_delta(self) -> dict:
        now = self.degrade.snapshot()
        out = {k: now[k] - self._deg0[k] for k in ("hedge_launched", "hedge_wins", "breaker_trips",
                                                    "breaker_closes")}
        for key in ("deadline_aborts", "sheds"):
            out[key] = {k: v - self._deg0[key].get(k, 0) for k, v in now[key].items()
                        if v - self._deg0[key].get(k, 0)}
        return out

    def _settled(self) -> dict:
        """The ledger once a straggling hedged read has landed: its verify
        and frame-parse records close moments after the response."""
        snap = self.ledger.snapshot()
        for _ in range(50):
            time.sleep(0.1)
            again = self.ledger.snapshot()
            if again == snap:
                break
            snap = again
        return snap

    def read(self, path: str, n_requests: int | None, payload_bytes: int, smi: str) -> None:
        summ = self.summarize(self._settled())
        rows = []
        for layer in sorted(summ):
            for stage in sorted(summ[layer]):
                s = summ[layer][stage]
                rows.append({"layer": layer, "stage": stage, "count": s["count"], "p50_ms": s["p50_ms"],
                             "p99_ms": s["p99_ms"], "wall_s": round(s["total_ms"] / 1e3, 4),
                             "cpu_s": round(s["cpu_seconds"], 4)})
        log(f"{path} stage ledger [{smi}]: " + json.dumps(rows))
        hops = self.copy.snapshot()["hops"]
        per_byte = {hop: {"copied": round(h["copied_bytes"] / payload_bytes, 4),
                          "moved": round(h["moved_bytes"] / payload_bytes, 4)}
                    for hop, h in sorted(hops.items())} if payload_bytes else {}
        log(f"{path} copies per payload byte ({payload_bytes} bytes): " + json.dumps(per_byte))
        deg = self.degrade_delta()
        log(f"{path} degrade records: " + json.dumps(deg))
        count = {(r["layer"], r["stage"]): r["count"] for r in rows}
        roots = sum(c for (layer, stage), c in count.items() if layer == "api" and stage not in API_CHILD_SPANS)
        if n_requests is not None and roots != n_requests:
            raise AssertionError(f"{path}: {roots} api root spans, the client sent {n_requests} requests")
        fp, vb = count.get(("object", "frame-parse"), 0), count.get(("codec", "verify-batch"), 0)
        if fp != vb:
            raise AssertionError(f"{path}: {fp} object/frame-parse records, {vb} codec/verify-batch records")


def _trace_tree(records: list, request_id: str) -> dict:
    """One request's span tree from GLOBAL_TRACE records: raises unless the
    trace has exactly one root and every span hangs under it."""
    spans = [r for r in records if r.get("type") == "span" and r.get("trace") == request_id]
    ids = {r["span"] for r in spans}
    roots = [r for r in spans if r["parent"] == ""]
    orphans = [r["name"] for r in spans if r["parent"] and r["parent"] not in ids]
    if len(roots) != 1 or orphans:
        raise AssertionError(f"trace {request_id}: {len(roots)} roots, spans with no parent in the tree {orphans}")
    layers = collections.Counter(r["layer"] for r in spans)
    names = collections.Counter(r["name"] for r in spans)
    return {"root": roots[0]["name"], "spans": len(spans), "layers": dict(layers), "names": dict(names)}


# -- phase 6: the S3 HTTP front -------------------------------------------------------------

HTTP_CREDS = ("chipsmoke", "chip-smoke-secret-key")
HTTP_THREADS = 16
# minio-go's signing defaults: a body up to this size carries its sha256 in
# x-amz-content-sha256; a larger one goes aws-chunked in 64 KiB chunks
# (payloadChunkSize, pkg/signer/request-signature-streaming.go).
SIGNED_BODY_MAX = MiB
STREAM_CHUNK = 64 << 10


def _client_main(conn, endpoint: str, others: tuple = ()) -> None:
    """Phase 6's S3 client, in a spawned process of its own so that its
    signing and hashing do not share the server's GIL. It signs with the
    port's api/auth.sign_request and api/streaming.encode_chunked over
    keep-alive http.client connections (one a thread and node), holds the
    expected bytes of every object (made from the same seeds as the server
    side's), and answers commands from the pipe until "stop". Node 0 is
    `endpoint`; phase 10 names the nodes of `others` by their index + 1."""
    import http.client
    import traceback
    import urllib.parse

    from minio_tpu_torch.api import auth, streaming

    hosts = [urllib.parse.urlparse(e).netloc for e in (endpoint, *others)]
    creds = auth.Credentials(*HTTP_CREDS)
    objects: dict = {}
    local = threading.local()

    def signed(method: str, path: str, query: list, headers: dict, body, node: int = 0) -> tuple[dict, object]:
        h = {k.lower(): v for k, v in headers.items()}
        h["host"] = hosts[node]
        if len(body) > SIGNED_BODY_MAX:
            h["content-encoding"] = "aws-chunked"
            h["x-amz-decoded-content-length"] = str(len(body))
            h = auth.sign_request(creds, method, path, query, h, None, payload_hash=auth.STREAMING_PAYLOAD)
            seed = h["authorization"].rsplit("Signature=", 1)[1]
            body = streaming.encode_chunked(bytes(body), seed, creds, h["x-amz-date"], "us-east-1",
                                            chunk_size=STREAM_CHUNK)
        else:
            h = auth.sign_request(creds, method, path, query, h, body)
        h.pop("host")
        return h, body

    def send(method: str, path: str, query=(), headers=None, body=b"", sign: bool = True,
             fresh: bool = False, tamper: bool = False, node: int = 0) -> tuple[int, dict, bytes, float]:
        query = list(query)
        headers = dict(headers or {})
        if sign:
            headers, body = signed(method, path, query, headers, body, node)
            if tamper:
                headers["authorization"] = headers["authorization"][:-4] + "0000"
        url = urllib.parse.quote(path) + ("?" + urllib.parse.urlencode(query) if query else "")
        if not hasattr(local, "conns"):
            local.conns = {}
        c = None if fresh else local.conns.get(node)
        if c is None:
            c = http.client.HTTPConnection(hosts[node], timeout=600)
        t0 = time.perf_counter()
        c.request(method, url, body=body, headers=headers)
        r = c.getresponse()
        data = r.read()
        dt = time.perf_counter() - t0
        if fresh or r.will_close:
            c.close()
            if not fresh:
                local.conns.pop(node, None)
        else:
            local.conns[node] = c
        return r.status, {k.lower(): v for k, v in r.getheaders()}, data, dt

    def fan_out(fn, items, threads: int) -> tuple[list, float]:
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(threads) as ex:
            out = list(ex.map(fn, items))
        return out, time.perf_counter() - t0

    def register(seed: int, n: int, max_size: int, stem: str, tenants: int = TENANTS) -> int:
        objects.update(Traffic(seed, n, max_size, stem, tenants).data)
        return n

    def register_bytes(name: str, seed: int, nbytes: int) -> int:
        objects[name] = memoryview(np.random.default_rng(seed).bytes(nbytes))
        return nbytes

    def put(names: list, headers: dict, threads: int, where: dict | None = None, bucket: str = "bench") -> dict:
        def one(name):
            st, h, body, dt = send("PUT", f"/{bucket}/{name}", headers=headers.get(name), body=objects[name],
                                   node=where[name] if where else 0)
            if st != 200:
                raise AssertionError(f"PUT {name}: {st} {body[:300]!r}")
            return dt, h.get("etag", "")
        out, wall = fan_out(one, names, threads)
        return {"latencies": [o[0] for o in out], "etags": [o[1] for o in out], "wall": wall,
                "bytes": sum(len(objects[n]) for n in names)}

    def put_some(names: list, threads: int) -> dict:
        """PUTs that may meet a dying server process: which were answered
        200 (acknowledged), and what each other one met."""
        def one(name):
            try:
                st, _, body, dt = send("PUT", f"/bench/{name}", body=objects[name])
            except (OSError, http.client.HTTPException) as e:
                local.conns.pop(0, None)  # its connection died with the process that had accepted it
                return name, f"{type(e).__name__}: {e}", None
            return name, st, dt
        out, wall = fan_out(one, names, threads)
        return {"acked": [n for n, st, _ in out if st == 200], "failed": {n: st for n, st, _ in out if st != 200},
                "latencies": [dt for _, st, dt in out if st == 200], "wall": wall}

    def get(names: list, threads: int, where: dict | None = None, bucket: str = "bench") -> dict:
        def one(name):
            st, _, body, dt = send("GET", f"/{bucket}/{name}", node=where[name] if where else 0)
            if st != 200 or body != objects[name]:
                raise AssertionError(f"GET {name}: status {st}, {len(body)} bytes, "
                                     f"want 200 and {len(objects[name])} equal bytes")
            return dt
        lat, wall = fan_out(one, names, threads)
        return {"latencies": lat, "wall": wall, "bytes": sum(len(objects[n]) for n in names)}

    def multipart(name: str, part_size: int, threads: int, node: int = 0) -> dict:
        t0 = time.perf_counter()
        st, _, body, dt0 = send("POST", f"/bench/{name}", [("uploads", "")], node=node)
        if st != 200:
            raise AssertionError(f"initiate {name}: {st} {body[:300]!r}")
        uid = ET.fromstring(body).findtext("{*}UploadId")
        data = objects[name]
        n_parts = -(-len(data) // part_size)

        def part(n):
            st, h, b, dt = send("PUT", f"/bench/{name}", [("partNumber", str(n)), ("uploadId", uid)],
                                body=data[(n - 1) * part_size: n * part_size], node=node)
            if st != 200:
                raise AssertionError(f"part {n} of {name}: {st} {b[:300]!r}")
            return dt, h["etag"]
        out, _ = fan_out(part, range(1, n_parts + 1), threads)
        xml = "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                      for n, (_, e) in enumerate(out, 1))
        st, _, body, dt1 = send("POST", f"/bench/{name}", [("uploadId", uid)],
                                body=f"<CompleteMultipartUpload>{xml}</CompleteMultipartUpload>".encode(), node=node)
        if st != 200:
            raise AssertionError(f"complete {name}: {st} {body[:300]!r}")
        return {"etag": ET.fromstring(body).findtext("{*}ETag"), "wall": time.perf_counter() - t0,
                "latencies": [dt0, *(o[0] for o in out), dt1], "bytes": len(data), "parts": n_parts}

    def list_v2(prefix: str, max_keys: int, node: int = 0) -> dict:
        keys, token, pages = [], "", 0
        while True:
            q = [("list-type", "2"), ("max-keys", str(max_keys)), ("prefix", prefix)]
            if token:
                q.append(("continuation-token", token))
            st, _, body, _ = send("GET", "/bench", q, node=node)
            if st != 200:
                raise AssertionError(f"ListObjectsV2: {st} {body[:300]!r}")
            root = ET.fromstring(body)
            keys += [e.findtext("{*}Key") for e in root.findall("{*}Contents")]
            pages += 1
            if root.findtext("{*}IsTruncated") != "true":
                return {"keys": keys, "pages": pages}
            token = root.findtext("{*}NextContinuationToken")

    def ranges(names: list) -> int:
        """One HEAD and three Range GETs (first byte, a 1 MiB window, a
        suffix of 100) of each object, and an If-None-Match GET: 304."""
        checks = 0
        for name in names:
            data, n = objects[name], len(objects[name])
            st, h, _, _ = send("HEAD", f"/bench/{name}")
            if st != 200 or int(h["content-length"]) != n:
                raise AssertionError(f"HEAD {name}: {st} {h}")
            lo = n // 3
            for spec, want, first in (("bytes=0-0", data[:1], 0), (f"bytes={lo}-{lo + MiB - 1}", data[lo:lo + MiB], lo),
                                      ("bytes=-100", data[-100:], n - 100)):
                st, h2, body, _ = send("GET", f"/bench/{name}", headers={"Range": spec})
                rng = f"bytes {first}-{first + len(want) - 1}/{n}"
                if st != 206 or body != want or h2.get("content-range") != rng:
                    raise AssertionError(f"GET {name} {spec}: {st} {h2.get('content-range')} want {rng}")
                checks += 1
            st, _, _, _ = send("GET", f"/bench/{name}", headers={"If-None-Match": h["etag"]})
            if st != 304:
                raise AssertionError(f"GET {name} If-None-Match: {st}, want 304")
            checks += 2
        return checks

    def delete(names: list) -> int:
        xml = "".join(f"<Object><Key>{n}</Key></Object>" for n in names)
        st, _, body, _ = send("POST", "/bench", [("delete", "")], body=f"<Delete>{xml}</Delete>".encode())
        deleted = body.count(b"<Deleted>")
        if st != 200 or deleted != len(names) or b"<Error>" in body:
            raise AssertionError(f"DeleteObjects: {st}, {deleted} deleted of {len(names)}: {body[:300]!r}")
        return deleted

    def request(method: str, path: str, query=(), headers=None, body=b"", sign=True, tamper=False,
                node: int = 0) -> tuple:
        st, h, data, _ = send(method, path, query, headers, body, sign=sign, fresh=True, tamper=tamper, node=node)
        return st, h, data[:4096]

    def admin(method: str, path: str, query=(), doc=None, node: int = 0) -> tuple:
        """A signed admin request with a JSON body; the whole answer, parsed
        when it is JSON."""
        body = json.dumps(doc).encode() if doc is not None else b""
        st, h, data, _ = send(method, path, query, {}, body, fresh=True, node=node)
        return st, json.loads(data) if h.get("content-type", "").startswith("application/json") else data[:4096]

    def request_as(ak: str, sk: str, method: str, path: str, body=b"", headers=None, node: int = 0,
                   answer: bool = False) -> tuple:
        """One request signed with other credentials: (status, sha256 of the
        answer), or (status, the answer) with `answer`."""
        h = {k.lower(): v for k, v in (headers or {}).items()}
        h["host"] = hosts[node]
        h = auth.sign_request(auth.Credentials(ak, sk), method, path, [], h, body)
        h.pop("host")
        c = http.client.HTTPConnection(hosts[node], timeout=600)
        try:
            c.request(method, urllib.parse.quote(path), body=body, headers=h)
            r = c.getresponse()
            data = r.read()
            return r.status, data if answer else hashlib.sha256(data).hexdigest()
        finally:
            c.close()

    def heads(bucket: str, names: list, node: int, threads: int) -> dict:
        """A HEAD of each object through one node: {name: (status, the
        headers that name its version, mtime and replication status)}."""
        keep = ("x-amz-version-id", "last-modified", "x-amz-replication-status", "content-length")

        def one(name):
            st, h, _, _ = send("HEAD", f"/{bucket}/{name}", node=node)
            return name, (st, {k: h.get(k, "") for k in keep})
        out, _ = fan_out(one, names, threads)
        return dict(out)

    def versions(bucket: str, node: int) -> list:
        """Every (key, version id, is a delete marker) of a bucket through one node."""
        out, key_marker, vid_marker = [], "", ""
        while True:
            q = [("versions", "")]
            if key_marker:
                q += [("key-marker", key_marker), ("version-id-marker", vid_marker)]
            st, _, body, _ = send("GET", f"/{bucket}", q, fresh=True, node=node)
            if st != 200:
                raise AssertionError(f"ListObjectVersions {bucket}: {st} {body[:300]!r}")
            root = ET.fromstring(body)
            for el in root:
                tag = el.tag.split("}")[-1]
                if tag in ("Version", "DeleteMarker"):
                    out.append((el.findtext("{*}Key"), el.findtext("{*}VersionId"), tag == "DeleteMarker"))
            if root.findtext("{*}IsTruncated") != "true":
                return out
            key_marker = root.findtext("{*}NextKeyMarker")
            vid_marker = root.findtext("{*}NextVersionIdMarker")

    def empty_bucket(bucket: str, node: int) -> int:
        """Delete every version and delete marker of a bucket through one
        node (DeleteObjects with version ids, 1,000 a request), then the
        bucket; the number of versions deleted."""
        gone = versions(bucket, node)
        for i in range(0, len(gone), 1000):
            xml = "".join(f"<Object><Key>{key}</Key><VersionId>{vid}</VersionId></Object>"
                          for key, vid, _ in gone[i:i + 1000])
            st, _, body, _ = send("POST", f"/{bucket}", [("delete", "")], body=f"<Delete>{xml}</Delete>".encode(),
                                  fresh=True, node=node)
            if st != 200 or b"<Error>" in body:
                raise AssertionError(f"DeleteObjects of {bucket}'s versions: {st} {body[:300]!r}")
        st, _, body, _ = send("DELETE", f"/{bucket}", fresh=True, node=node)
        if st != 204:
            raise AssertionError(f"DELETE {bucket}: {st} {body[:300]!r}")
        return len(gone)

    def put_race(name: str, seeds: list, nbytes: int) -> dict:
        """len(seeds) PUTs of one key, each with its own body, released at
        once through the nodes in turn: their statuses and the bodies'
        sha256."""
        bodies = [np.random.default_rng(seed).bytes(nbytes) for seed in seeds]
        barrier = threading.Barrier(len(bodies))

        def one(i):
            barrier.wait()
            return send("PUT", f"/bench/{name}", body=bodies[i], fresh=True, node=i % len(hosts))[0]

        statuses, wall = fan_out(one, range(len(bodies)), len(bodies))
        return {"statuses": statuses, "digests": [hashlib.sha256(b).hexdigest() for b in bodies], "wall": wall}

    def fetch(path: str, node: int) -> tuple:
        """A signed GET through one node: (status, sha256 of the body)."""
        st, _, body, _ = send("GET", path, fresh=True, node=node)
        return st, hashlib.sha256(body).hexdigest()

    def register_blob(name: str, data: bytes) -> int:
        objects[name] = memoryview(data)
        return len(data)

    def select(path: str, request_xml: bytes, node: int = 0) -> tuple:
        """SelectObjectContent through one node: (status, the whole answer,
        seconds from the request to its last byte)."""
        st, _, body, dt = send("POST", path, [("select", ""), ("select-type", "2")], body=request_xml,
                               fresh=True, node=node)
        return st, body, dt

    ops = {"register": register, "register_bytes": register_bytes, "put": put, "put_some": put_some, "get": get,
           "multipart": multipart, "list_v2": list_v2, "ranges": ranges, "delete": delete, "request": request,
           "admin": admin, "request_as": request_as, "put_race": put_race, "fetch": fetch, "heads": heads,
           "versions": versions, "empty_bucket": empty_bucket, "register_blob": register_blob, "select": select}
    while True:
        msg = conn.recv()
        if msg[0] == "stop":
            conn.close()
            return
        try:
            conn.send(("ok", ops[msg[0]](*msg[1:])))
        except Exception as e:  # noqa: BLE001 - sent back and raised in the parent
            conn.send(("error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


class HttpClient:
    """The parent's handle on the client process: call(op, *args) runs one
    command there and returns its result, or raises its error here."""

    def __init__(self, endpoint: str, others: tuple = ()):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=_client_main, args=(child, endpoint, tuple(others)), daemon=True)
        self._proc.start()
        child.close()

    def call(self, op: str, *args):
        self._conn.send((op, *args))
        status, res = self._conn.recv()
        if status != "ok":
            raise AssertionError(f"S3 client {op}: {res}")
        return res

    def close(self) -> None:
        try:
            if self._proc.is_alive():
                with contextlib.suppress(OSError):
                    self._conn.send(("stop",))
            self._proc.join(30)
        finally:
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join(10)


def _percentile(values: list, q: float) -> float:
    return float(np.percentile(np.asarray(values), q)) if values else float("nan")


def phase_http(smi: str, state: SimpleNamespace, codec, tally: Tally, kernels: dict, rates: dict,
               n_put: int = 128, n_get_old: int = 64, big_mib: int = 128, part_mib: int = 8,
               threads: int = HTTP_THREADS, seed: int = 6, degraded_set: int = 0) -> dict:
    """Phase 5's deployment behind the port's S3Server, driven by signed
    HTTP from a client process: see the module docstring."""
    from minio_tpu_torch.api.server import S3Server, ThreadedServer
    from minio_tpu_torch.control.iam import IAMSys
    from minio_tpu_torch.control.pubsub import GLOBAL_TRACE

    layer, old = state.layer, state.traffic
    planes = Planes()
    new = Traffic(seed, n_put, state.max_size, stem="http")
    ts = ThreadedServer(S3Server(layer, IAMSys(*HTTP_CREDS), check_skew=True))
    endpoint = ts.start()
    client = HttpClient(endpoint)
    paths = {}
    clock_keys = ("device_encode_seconds", "device_verify_seconds", "device_recon_seconds",
                  "batches_run", "small_batches_run", "verify_batches_run", "recon_batches_run")

    def report(path: str, res: dict, n_objects: int, before: dict, direct: list) -> None:
        """A path's rate, client latency, codec clocks, launches by shape
        and estimated device time, beside the direct-layer rates."""
        wall, lat = res["wall"], res["latencies"]
        after = codec.stats()
        counts = paths[path]
        dev_ms = _device_ms(counts, kernels)
        side = "; ".join(f"{k} {rates[k]['objects_per_s']:.1f} objects/s, {rates[k]['gib_per_s']:.4f} GiB/s"
                         for k in direct if k in rates)
        log(f"{path}: {n_objects} objects in {wall:.3f} s, {n_objects / wall:.1f} objects/s, "
            f"{res['bytes'] / 2**30 / wall:.4f} GiB/s; client latency p50 {_percentile(lat, 50) * 1e3:.1f} ms, "
            f"p99 {_percentile(lat, 99) * 1e3:.1f} ms over {len(lat)} requests"
            + (f"; direct layer, same run: {side}" if side else "") + f" [{smi}]")
        log(f"{path} codec clocks: " + json.dumps({k: round(after[k] - before[k], 4) for k in clock_keys}))
        log(f"{path}: launches by shape class {json.dumps(_shape_summary(counts))}; device time estimated "
            f"from them {dev_ms / 1e3:.3f} s of {wall:.3f} s wall ({100 * dev_ms / 1e3 / wall:.2f}%)")

    try:
        t0 = time.perf_counter()
        client.call("register", seed, n_put, state.max_size, "http")
        client.call("register", state.seed, len(old.names), state.max_size, "obj")
        log(f"http: S3Server at {endpoint}, client process ready in {time.perf_counter() - t0:.2f} s "
            f"({n_put} new objects, {new.sizes.sum() / MiB:.1f} MiB)")

        # 1. http_put: the new objects, one in 8 REDUCED_REDUNDANCY.
        # One signed PUT and one GET of a 4 MiB object with a GLOBAL_TRACE
        # subscriber: each is one span tree keyed by its x-amz-request-id.
        traced = "trace/put-4mib"
        body = np.random.default_rng(seed + 4).bytes(4 * MiB)
        q = GLOBAL_TRACE.subscribe()
        try:
            st_put, h_put, _ = client.call("request", "PUT", f"/bench/{traced}", (), None, body)
            # Lose the part files of the drives holding data rows 1-4, so
            # the GET rebuilds them and its tree has the codec's span too.
            for p_i, d_i in _holders(layer, traced):
                drive = layer.pools[p_i].disks[d_i]
                if drive.read_version("bench", traced).erasure.index <= 4:
                    _remove_parts_of(drive, traced)
            st_get, h_get, head = client.call("request", "GET", f"/bench/{traced}")
            time.sleep(0.5)
        finally:
            GLOBAL_TRACE.unsubscribe(q)
        if (st_put, st_get) != (200, 200) or head != body[:len(head)]:
            raise AssertionError(f"traced PUT/GET: {st_put} {st_get}")
        records = []
        while not q.empty():
            records.append(q.get_nowait())
        # A streamed GET sends its headers before the request id is stamped
        # (as the JAX front does), so its trace is found by its root span:
        # the trace id is the request id either way.
        get_ids = [r["trace"] for r in records if r.get("type") == "span" and r["parent"] == ""
                   and r["name"] == "GetObject" and r.get("path") == f"/bench/{traced}"]
        if len(get_ids) != 1:
            raise AssertionError(f"traced GET: {len(get_ids)} GetObject root spans")
        for label, rid in (("PUT", h_put["x-amz-request-id"]), ("GET", get_ids[0])):
            tree = _trace_tree(records, rid)
            if not {"api", "object", "erasure"} <= set(tree["layers"]):
                raise AssertionError(f"traced {label}: layers {tree['layers']}")
            log(f"http trace {label} 4 MiB (request id {rid}): one tree of {tree['spans']} spans, root "
                f"{tree['root']}, layers {json.dumps(tree['layers'])}, spans {json.dumps(tree['names'])}")

        rrs = {n: {"x-amz-storage-class": "REDUCED_REDUNDANCY"} for n in new.names if new.storage_class[n]}
        before = codec.stats()
        planes.reset()
        tally.reset()
        res = client.call("put", new.names, rrs, threads)
        planes.read("http_put", len(res["latencies"]), res["bytes"], smi)
        paths["http_put"] = tally.read("http_put")
        _no_host_fallback(codec, "http_put")
        report("http_put", res, n_put, before, ["pools_put_pool1", "pools_put_pool0"])

        # 2. http_get: the new objects and phase 5's survivors in pool 0,
        # byte-exact. (Pool 1's phase-5 objects lost drive 5's copy to
        # phase 5's heal_bucket check, which recreates only the bucket
        # directory: their reads are degraded.)
        first = set(state.first)
        survivors = [n for n in state.live if n in first and n not in state.overwritten]
        olds = survivors[:: max(1, len(survivors) // n_get_old)][:n_get_old]
        if len(olds) < n_get_old:
            raise AssertionError(f"http_get: {len(survivors)} of phase 5's objects survive in pool 0, "
                                 f"want {n_get_old}")
        before = codec.stats()
        planes.reset()
        tally.reset()
        res = client.call("get", new.names + olds, threads)
        planes.read("http_get", len(res["latencies"]), res["bytes"], smi)
        paths["http_get"] = tally.read("http_get", need=("hh256",))
        _no_host_fallback(codec, "http_get")
        report("http_get", res, n_put + len(olds), before, ["pools_get"])
        # A healthy GET rebuilds nothing from the data: a reconstruct is
        # only due where a hedged spare read beat a slow primary (the
        # window then decodes from the spare), at most one group for the
        # window's full blocks and one for its tail.
        rs, wins = paths["http_get"]["launches"]["rs_gf_apply"], planes.degrade_delta()["hedge_wins"]
        if rs > 2 * wins:
            raise AssertionError(f"http_get launched rs_gf_apply {paths['http_get']['rs_gf_apply_by_b_r']} "
                                 f"with {wins} winning hedges")
        if rs:
            log(f"http_get: {rs} rs_gf_apply launches, for {wins} hedged reads that beat their primary")
        same = _in_threads(lambda n: layer.get_object("bench", n)[1] == new.data[n], new.names, threads)
        if not all(same):
            raise AssertionError(f"layer.get_object of HTTP-PUT objects: {same.count(False)} differ")
        log(f"http: every HTTP-PUT object reads back byte-identical through layer.get_object ({n_put})")

        # 3. http_big: one aws-chunked PUT, a multipart upload of 8 MiB parts
        # from 4 threads, both read back.
        big, mpk = "big/http-put", "big/http-multipart"
        client.call("register_bytes", big, seed + 1, big_mib * MiB)
        client.call("register_bytes", mpk, seed + 2, big_mib * MiB)
        before = codec.stats()
        planes.reset()
        tally.reset()
        res_put = client.call("put", [big], {}, 1)
        res_mp = client.call("multipart", mpk, part_mib * MiB, 4)
        res_get = client.call("get", [big, mpk], 1)
        planes.read(
            "http_big", len(res_put["latencies"]) + len(res_mp["latencies"]) + len(res_get["latencies"]),
            4 * big_mib * MiB, smi)
        paths["http_big"] = tally.read("http_big")
        _no_host_fallback(codec, "http_big")
        n_parts = res_mp["parts"]
        if not res_mp["etag"].strip('"').endswith(f"-{n_parts}"):
            raise AssertionError(f"http_big: multipart ETag {res_mp['etag']}, want -{n_parts}")
        res = {"wall": res_put["wall"] + res_mp["wall"] + res_get["wall"], "bytes": 4 * big_mib * MiB,
               "latencies": res_put["latencies"] + res_mp["latencies"] + res_get["latencies"]}
        for label, r, key in (("aws-chunked PUT", res_put, "put_big"), ("multipart", res_mp, "multipart"),
                              ("GET of both", res_get, "get_big")):
            d = rates.get(key)
            log(f"http_big {label}: {r['bytes'] / 2**30 / r['wall']:.4f} GiB/s"
                + (f"; direct layer, same run ({key}): {d['gib_per_s']:.4f} GiB/s" if d else "") + f" [{smi}]")
        report("http_big", res, 4, before, [])
        log(f"http_big: {big_mib} MiB aws-chunked PUT, {n_parts} x {part_mib} MiB multipart (ETag -{n_parts}), "
            f"both GET byte-exact")

        # 4. http_degraded_get: the part files of 4 drives of one set of pool 0
        # removed (2 for a 14+2 object), every object of that set read back.
        sets0 = state.sets0
        disks = sets0.sets[degraded_set].disks
        targets = [n for n in survivors if sets0.get_set_index(n) == degraded_set]
        if not targets:
            raise AssertionError(f"http_degraded_get: no surviving object of pool 0's set {degraded_set}")
        lost_drives = (2, 5, 9, 14)
        removed = 0
        for name in targets:
            for i in lost_drives[:2] if old.storage_class[name] else lost_drives:
                for dirpath, _, files in os.walk(os.path.join(disks[i].root, "bench", name)):
                    for f in files:
                        if f.startswith("part."):
                            os.remove(os.path.join(dirpath, f))
                            removed += 1
        before = codec.stats()
        planes.reset()
        tally.reset()
        res = client.call("get", targets, threads)
        planes.read("http_degraded_get", len(res["latencies"]), res["bytes"], smi)
        paths["http_degraded_get"] = tally.read("http_degraded_get")
        _no_host_fallback(codec, "http_degraded_get")
        report("http_degraded_get", res, len(targets), before, ["pools_degraded_get"])
        log(f"http_degraded_get: {len(targets)} objects of pool 0's set {degraded_set} byte-exact with "
            f"{removed} part files of drives {lost_drives} removed")

        # 5. Checks with no rate of their own.
        by_class = {}
        for n in new.names:
            by_class.setdefault(_size_class(len(new.data[n])), n)
        checks = client.call("ranges", [by_class[c] for c in sorted(by_class)])
        log(f"http: HEAD, three Range GETs and an If-None-Match 304 on one object of each size class "
            f"{sorted(by_class)}: {checks} checks ok")
        listed = client.call("list_v2", "", 1000)
        own, _, _ = _list_all(layer, "bench", max_keys=1000)
        if listed["keys"] != own:
            raise AssertionError(f"ListObjectsV2: {len(listed['keys'])} keys, the layer lists {len(own)}")
        gone = new.names[: min(128, n_put // 2)]
        client.call("delete", gone)
        after_delete = client.call("list_v2", "", 1000)
        if set(gone) & set(after_delete["keys"]) or len(after_delete["keys"]) != len(own) - len(gone):
            raise AssertionError("DeleteObjects: deleted keys are still listed")
        log(f"http: ListObjectsV2 in {listed['pages']} pages of 1,000 equals the layer's listing "
            f"({len(own)} keys); POST ?delete of {len(gone)} keys, then they are gone from the listing")
        key = f"/bench/{new.names[-1]}"
        refusals = {
            "unsigned GET": (client.call("request", "GET", key, (), None, b"", False), 403, "AccessDenied"),
            "tampered signature": (client.call("request", "GET", key, (), None, b"", True, True), 403,
                                   "SignatureDoesNotMatch"),
        }
        late = "tenant-00/2024-01-01/http-deadline"
        planes.reset()
        refusals["expired deadline PUT"] = (client.call(
            "request", "PUT", f"/bench/{late}", (), {"X-Mtpu-Deadline": "0.0005"},
            np.random.default_rng(seed + 3).bytes(512 << 10)), 503, "SlowDownWrite")
        aborts = planes.degrade_delta()["deadline_aborts"]
        if sum(aborts.values()) != 1:
            raise AssertionError(f"the expired-deadline PUT recorded deadline aborts {aborts}, want one")
        log(f"http: the expired-deadline PUT recorded one deadline abort {json.dumps(aborts)}")
        for label, ((st, _, body), want_st, want_code) in refusals.items():
            code = ET.fromstring(body).findtext("Code") if body else ""
            if (st, code) != (want_st, want_code):
                raise AssertionError(f"{label}: {st} {code}, want {want_st} {want_code}")
        if client.call("list_v2", late, 1000)["keys"]:
            raise AssertionError("the PUT refused for its deadline is listed")
        log("http refusals ok: unsigned GET 403 AccessDenied, tampered signature 403 SignatureDoesNotMatch, "
            "X-Mtpu-Deadline 0.0005 PUT 503 SlowDownWrite and not listed")
    finally:
        client.close()
        ts.stop()
    return paths


# -- phase 7: the fault plane on the card ---------------------------------------------------

P7_THREADS = 16
BITROT_DRIVE, BREAKER_DRIVES, P7_OTHERS = 5, (2, 9), (0, 4, 8, 12)
CRASH_SPECS = (
    "put.mid-commit:kill:8",
    "put.mid-commit:kill:13",
    "storage.append-iov.torn:torn-kill",
    "multipart.complete.partial:kill",
)


def _drive_name(i: int) -> str:
    return f"drive{i:02d}"  # zero-padded: a fault's target substring names one drive


def _fault_set(root: str, codec, wrap: bool = True):
    """A 16-drive 12+4 set with a bucket "bench", made under `root` or
    opened there again (the restart); with `wrap`, each drive is the stack
    Node builds, MeteredDrive(HealthGatedDrive(FaultyDisk(LocalDrive)))."""
    from minio_tpu_torch.chaos.disk import FaultyDisk
    from minio_tpu_torch.object.erasure import ErasureObjects
    from minio_tpu_torch.storage import format as fmt
    from minio_tpu_torch.storage.breaker import HealthGatedDrive
    from minio_tpu_torch.storage.local import LocalDrive
    from minio_tpu_torch.storage.metered import MeteredDrive

    fresh = not os.path.isdir(root)
    drives = []
    for i, f in enumerate(fmt.init_format(1, DRIVES)):
        d = os.path.join(root, _drive_name(i))
        if fresh:
            os.makedirs(d)
            f.save(d)
        drive = LocalDrive(d)
        drives.append(MeteredDrive(HealthGatedDrive(FaultyDisk(drive))) if wrap else drive)
    eo = ErasureObjects(drives, parity=M, codec=codec)
    if fresh:
        eo.make_bucket("bench")
    return eo, drives


def _remove_parts_of(drive, name: str) -> int:
    removed = 0
    for dirpath, _, files in os.walk(os.path.join(drive.root, "bench", name)):
        for f in files:
            if f.startswith("part."):
                os.remove(os.path.join(dirpath, f))
                removed += 1
    return removed


def _remove_parts(drives, indices, name: str) -> int:
    return sum(_remove_parts_of(drives[i], name) for i in indices)


def _crash_payloads(big_mib: int) -> dict:
    rng = np.random.default_rng(70)
    return {"acked": rng.bytes(big_mib * MiB), "victim": rng.bytes(big_mib * MiB + 37),
            "part1": rng.bytes(5 * MiB), "part2": rng.bytes(MiB + 37)}


def _crash_child(root: str, spec: str, device: str, big_mib: int) -> None:
    """A process that dies at a crash point: it PUTs (and so acknowledges)
    one object, arms MTPU_CRASH through chaos.crash.arm_from_env, then PUTs
    the victim (a multipart upload for a multipart point) and must die
    there. Exit code 3 means the point never fired."""
    from minio_tpu_torch.chaos import crash
    from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

    codec = BatchingDeviceCodec(max_batch=64, device=device)
    eo, _ = _fault_set(root, codec, wrap=False)
    data = _crash_payloads(big_mib)
    eo.put_object("bench", "acked", data["acked"])
    os.environ["MTPU_CRASH"] = spec
    crash.arm_from_env()
    if spec.startswith("multipart."):
        mp = eo.multipart
        uid = mp.new_multipart_upload("bench", "victim")
        parts = [(n, mp.put_object_part("bench", "victim", uid, n, data[f"part{n}"]).etag) for n in (1, 2)]
        mp.complete_multipart_upload("bench", "victim", uid, parts)
    else:
        eo.put_object("bench", "victim", data["victim"])
    os._exit(3)


def _debris(root: str) -> list[str]:
    """Stage debris left under a drive: tmp entries, pid-scoped stage files
    and atomic-write .tmp files."""
    out = []
    tmp = os.path.join(root, ".minio_tpu.sys", "tmp")
    if os.path.isdir(tmp):
        out += [os.path.join(tmp, n) for n in os.listdir(tmp)]
    for dirpath, _, files in os.walk(root):
        out += [os.path.join(dirpath, f) for f in files if ".tmp." in f or re.search(r"\.tmp[0-9a-f]{8}$", f)]
    return out


def _lasting_debris(dirs: list, settle_s: float = 2.0) -> list[str]:
    """The stage debris of drives that live servers use: what _debris finds
    now and again settle_s later. A live process's atomic write (a server's
    scanner rewrites its usage and tier documents once a cycle) replaces its
    staging file within milliseconds, so it shows in one listing at most;
    what a dead process left stays in both."""
    first = {p for d in dirs for p in _debris(d)}
    if not first:
        return []
    time.sleep(settle_s)
    return sorted(first & {p for d in dirs for p in _debris(d)})


def phase_crash(root: str, codec, tally: Tally, device: str = "cuda", crash_mib: int = 4) -> dict:
    """7d: four spawned processes die at crash points; the restart scan
    recovers their drives (see the module docstring)."""
    import multiprocessing as mp

    from minio_tpu_torch.storage import recovery
    from minio_tpu_torch.utils import errors

    ctx = mp.get_context("spawn")
    roots = [os.path.join(root, f"crash{j}") for j in range(len(CRASH_SPECS))]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_crash_child, args=(r, spec, device, crash_mib), daemon=True)
             for r, spec in zip(roots, CRASH_SPECS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if codes != [137] * len(procs):
        raise AssertionError(f"7d: crash children exited {codes}, want 137 each")
    log(f"7d: {len(procs)} children died with rc 137 at {list(CRASH_SPECS)} in {time.perf_counter() - t0:.1f} s")
    data = _crash_payloads(crash_mib)
    tally.reset()
    recovery.reset_counters()
    for r, spec in zip(roots, CRASH_SPECS):
        ceo, cdrives = _fault_set(r, codec, wrap=False)
        scans = collections.Counter()
        for d in cdrives:
            scans.update(recovery.recover_drive(d))
        handed = []
        delta = recovery.recover_set(ceo, heal=lambda b, o, v: handed.append((b, o, v)))
        for b, o, v in handed:
            ceo.heal_object(b, o, version_id=v)
        try:
            got = ceo.get_object("bench", "victim")[1]
        except errors.ObjectNotFound:
            got = None
        want = data["part1"] + data["part2"] if spec.startswith("multipart.") else data["victim"]
        if got is not None and got != want:
            raise AssertionError(f"7d {spec}: the victim reads back but differs")
        debris = [p for d in cdrives for p in _debris(d.root)]
        if debris:
            raise AssertionError(f"7d {spec}: debris left after recovery: {debris[:8]}")
        _remove_parts(cdrives, P7_OTHERS, "acked")
        if ceo.get_object("bench", "acked")[1] != data["acked"]:
            raise AssertionError(f"7d {spec}: the acknowledged object differs")
        log(f"7d {spec}: victim {'absent (rolled back)' if got is None else 'byte-exact'}; recover_drive "
            f"{json.dumps({k: v for k, v in scans.items() if v})}; recover_set {json.dumps(delta)}; healed "
            f"{len(handed)}; no debris; the acknowledged object byte-exact with drives {P7_OTHERS} lost")
    counts = tally.read("faults_crash_recovery")
    log(f"7d recovery counters: {json.dumps(recovery.counters())}")
    return counts


def phase_faults(smi: str, root: str, codec, tally: Tally, rates: dict, device: str = "cuda",
                 n_small: int = 128, big_mib: int = 16, n_big: int = 8, rot_mib: int = 4, n_rot: int = 16,
                 crash_mib: int = 4, small_max: int = 4 * MiB, threads: int = P7_THREADS) -> dict:
    """The fault plane on the card: see the module docstring."""
    from minio_tpu_torch.chaos import faults
    from minio_tpu_torch.control.profiler import GLOBAL_PROFILER, thread_role
    from minio_tpu_torch.storage import breaker
    from minio_tpu_torch.utils import errors

    paths = {}
    planes = Planes()
    base = os.path.join(root, "faults")
    eo, drives = _fault_set(base, codec)

    # 7a. The drive stack Node builds.
    rng = np.random.default_rng(71)
    traffic = Traffic(72, n_small, small_max, stem="p7")
    objects = {f"p7/big-{i}": memoryview(rng.bytes(big_mib * MiB)) for i in range(n_big)}
    objects.update(traffic.data)
    names = list(objects)
    nbytes = sum(len(v) for v in objects.values())
    tally.reset()
    planes.reset()
    t0 = time.perf_counter()
    _in_threads(lambda n: eo.put_object("bench", n, objects[n]), names, threads)
    put_s = time.perf_counter() - t0

    def get_all(label: str) -> float:
        t = time.perf_counter()
        same = _in_threads(lambda n: eo.get_object("bench", n)[1] == objects[n], names, threads)
        if not all(same):
            raise AssertionError(f"{label}: {same.count(False)} objects differ")
        return time.perf_counter() - t

    get_s = get_all("7a GET")
    side = "; ".join(f"{k} {rates[k]['objects_per_s']:.1f} objects/s, {rates[k]['gib_per_s']:.4f} GiB/s"
                     for k in ("put_big", "get_big", "pools_put_pool0", "pools_get") if k in rates)
    log(f"7a drive stack: PUT {len(names)} objects ({nbytes / MiB:.1f} MiB) {len(names) / put_s:.1f} objects/s, "
        f"{nbytes / 2**30 / put_s:.4f} GiB/s; GET {len(names) / get_s:.1f} objects/s, "
        f"{nbytes / 2**30 / get_s:.4f} GiB/s; direct layer, same run: {side} [{smi}]")
    ewma: dict = {}
    for d in drives:
        for api, rec in d.api_latencies().items():
            ewma.setdefault(api, []).append(rec)
    log("7a metered per-API latency EWMA over 16 drives (ms min/median/max, calls, errors): " + json.dumps({
        api: [round(min(r["ewma_ms"] for r in v), 3), round(float(np.median([r["ewma_ms"] for r in v])), 3),
              round(max(r["ewma_ms"] for r in v), 3), sum(r["count"] for r in v), sum(r["errors"] for r in v)]
        for api, v in sorted(ewma.items())}))
    planes.read("7a drive stack (PUT and GET)", None, nbytes, smi)
    if not GLOBAL_PROFILER.ensure_started():
        raise AssertionError("the continuous profiler did not start (MTPU_PROFILE=0?)")
    try:
        get2_s = get_all("7a GET with the profiler on")
        time.sleep(1.0)  # the GIL probe calibrates on its first ticks
        summary = GLOBAL_PROFILER.summary()
    finally:
        GLOBAL_PROFILER.stop()
    samples = sum(summary["roles"].values()) or 1
    shares = {role: round(n / samples, 4) for role, n in sorted(summary["roles"].items(), key=lambda kv: -kv[1])}
    log(f"7a profiler on: GET {len(names) / get2_s:.1f} objects/s, {nbytes / 2**30 / get2_s:.4f} GiB/s "
        f"(off: {nbytes / 2**30 / get_s:.4f} GiB/s); gil_load {summary['gil_load']}; sampler overhead "
        f"{summary['sampler_overhead_ratio']}; role shares {json.dumps(shares)} [{smi}]")
    roles = {thread_role(n) for n in ("encode-batch-12-4", "encode-batch-small-12-4", "drive-io-lane_0",
                                      "put-stager", "get-stager", "etag-md5", "drive-io_3")}
    if "other" in roles:
        raise AssertionError(f"a port thread name maps to no profiler role: {roles}")
    paths["faults_drive_stack"] = tally.read("faults_drive_stack")

    # 7b. Bitrot on one drive's writes: caught by hh256 on GET, rebuilt by rs_gf_apply.
    rot = {f"p7/rot-{i}": rng.bytes(rot_mib * MiB) for i in range(n_rot)}
    fid = faults.REGISTRY.arm(faults.FaultSpec(kind="bitrot", target=_drive_name(BITROT_DRIVE), seed=73))
    try:
        _in_threads(lambda n: eo.put_object("bench", n, rot[n]), list(rot), threads)
    finally:
        injected = faults.REGISTRY.injected_counts()
        faults.REGISTRY.disarm(fid)
    tally.reset()
    same = _in_threads(lambda n: eo.get_object("bench", n)[1] == rot[n], list(rot), threads)
    if not all(same):
        raise AssertionError(f"7b GET over bitrot: {same.count(False)} objects differ")
    paths["faults_bitrot_get"] = counts = tally.read("faults_bitrot_get")
    log(f"7b bitrot: {json.dumps({f'{k[0]}@{k[1]}': v for k, v in injected.items()})} writes flipped on "
        f"{_drive_name(BITROT_DRIVE)}; {n_rot} GETs byte-exact, rs_gf_apply rebuilt in "
        f"{counts['launches']['rs_gf_apply']} launches")
    tally.reset()
    healed = [eo.heal_object("bench", n) for n in rot]
    removed = sum(_remove_parts(drives, P7_OTHERS, n) for n in rot)
    same = [eo.get_object("bench", n)[1] == rot[n] for n in rot]
    if not all(same):
        raise AssertionError(f"7b GET after heal with drives {P7_OTHERS} lost: {same.count(False)} differ")
    paths["faults_bitrot_heal"] = tally.read("faults_bitrot_heal")
    rewritten = sum(1 for h in healed if h.disks_healed)
    log(f"7b heal rewrote the flipped shard of {rewritten} of {n_rot} objects; GET byte-exact with "
        f"{removed} part files of drives {P7_OTHERS} removed")

    # 7c. Two drives fail every call: their breakers open, PUT and GET go on.
    planes.reset()
    fids = [faults.REGISTRY.arm(faults.FaultSpec(kind="drive-error", target=_drive_name(i), probability=1.0))
            for i in BREAKER_DRIVES]
    more = {f"p7/breaker-{i}": rng.bytes(rot_mib * MiB) for i in range(n_rot)}
    try:
        for i in BREAKER_DRIVES:
            br = drives[i].breaker
            for _ in range(br.error_threshold):
                try:
                    drives[i].disk_info()
                except errors.FaultyDisk:
                    pass
            if br.state != breaker.OPEN or drives[i].is_online():
                raise AssertionError(f"7c: {_drive_name(i)} breaker {br.snapshot()}, online {drives[i].is_online()}")
        tally.reset()
        _in_threads(lambda n: eo.put_object("bench", n, more[n]), list(more), threads)
        check = {**more, **{n: objects[n] for n in names[: 2 * n_rot]}}
        same = _in_threads(lambda n: eo.get_object("bench", n)[1] == check[n], list(check), threads)
        if not all(same):
            raise AssertionError(f"7c GET with two breakers open: {same.count(False)} differ")
        paths["faults_breaker"] = tally.read("faults_breaker")
    finally:
        for f in fids:
            faults.REGISTRY.disarm(f)
    t0 = time.perf_counter()
    while any(drives[i].breaker.state != breaker.CLOSED for i in BREAKER_DRIVES):
        if time.perf_counter() - t0 > drives[0].breaker.max_cooldown * 1.1 + 1:
            raise AssertionError("7c: a breaker did not re-close within max_cooldown: "
                                 + json.dumps([drives[i].breaker.snapshot() for i in BREAKER_DRIVES]))
        time.sleep(0.05)
    closed_s = time.perf_counter() - t0
    deg = planes.degrade_delta()
    log(f"7c breakers: {[_drive_name(i) for i in BREAKER_DRIVES]} opened after "
        f"{drives[BREAKER_DRIVES[0]].breaker.error_threshold} errors each, {len(more)} PUTs and {len(check)} GETs "
        f"byte-exact with both offline, both re-closed by their probe {closed_s:.2f} s after the faults were "
        f"disarmed; degrade records {json.dumps(deg)}; DriveBusy sheds {deg['sheds'].get('drive', 0)}")
    for d in drives:
        d.breaker.close()

    paths["faults_crash_recovery"] = phase_crash(root, codec, tally, device, crash_mib)
    shutil.rmtree(base, ignore_errors=True)
    return paths


# -- phase 8: boot on the card -----------------------------------------------------------------

BOOT_LOST = (0, 5, 10, 15)  # 8a: the drives whose part files are removed, then healed
BOOT_MRF_DRIVE = 7  # 8a: the drive whose next commit rename fails through /chaos
CRASH_BOOT = "put.mid-commit:kill:8"
ADMIN_PREFIX = "/mtpu/admin/v1"
BOOT_USER = ("bootuser", "boot-user-secret-key")


def _part_tree(root: str, bucket: str = "bench") -> dict:
    """{relative path: bytes} of every part file under one drive's bucket."""
    out = {}
    base = os.path.join(root, bucket)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.startswith("part."):
                out[os.path.relpath(os.path.join(dirpath, f), base)] = _read(os.path.join(dirpath, f))
    return out


def _wait_for(pred, timeout: float, what: str) -> float:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out after {timeout:.0f} s waiting for {what}")
        time.sleep(0.05)
    return time.perf_counter() - t0


def _heal_until_done(client, timeout: float = 300.0) -> dict:
    st, doc = client.call("admin", "POST", f"{ADMIN_PREFIX}/heal", (), {"bucket": "bench"})
    if st != 200:
        raise AssertionError(f"admin /heal: {st} {doc}")
    status: dict = {}

    def done():
        nonlocal status
        code, status = client.call("admin", "GET", f"{ADMIN_PREFIX}/heal/{doc['healSequence']}")
        return code == 200 and not status["running"]

    _wait_for(done, timeout, "the admin heal sequence")
    return status


def _check_probe(perf: dict, device: str) -> None:
    probe = perf["probe"]
    if device == "cuda" and not (probe["done"] and probe["ok"] and probe["platform"] == "gpu"):
        raise AssertionError(f"/perf probe: {probe}, want ok on platform gpu")


def phase_boot_node(smi: str, root: str, tally: Tally, rates: dict, device: str = "cuda", n_objects: int = 32,
                    big_mib: int = 64, mrf_mib: int = 4, max_size: int = 4 * MiB, threads: int = HTTP_THREADS) -> dict:
    """8a: a port Node in this process over 16 wrapped drives, no codec=:
    build() probes the card through the probe child and installs the
    batching codec; make_app() is served by cli._run_app_until."""
    from minio_tpu_torch import cli, runtime
    from minio_tpu_torch.dist.node import Node

    paths = {}
    base = os.path.join(root, "boot_node")
    dirs = [os.path.join(base, _drive_name(i)) for i in range(DRIVES)]
    t0 = time.perf_counter()
    node = Node(dirs, root_user=HTTP_CREDS[0], root_password=HTTP_CREDS[1], device=device)
    app = node.make_app()
    stop = threading.Event()
    port = _free_port()
    thread, errs = cli._run_app_until(app, "127.0.0.1", port, stop)
    if errs:
        raise AssertionError(f"8a: the app did not start: {errs}")
    client = None
    try:
        node.build()
        build_s = time.perf_counter() - t0
        verdict = runtime.probe_status()
        if device == "cuda":
            if verdict is None or not verdict.ok or verdict.platform != "gpu" or "PROBE_OK gpu " not in verdict.detail:
                raise AssertionError(f"8a: the probe child's verdict {verdict}")
            log("8a probe child transcript: " + " | ".join(
                ln for ln in verdict.detail.splitlines() if ln.startswith(("[probe]", "PROBE_OK"))))
        codec = node.codec
        if type(codec).__name__ != "BatchingDeviceCodec" or codec.device.type != device:
            raise AssertionError(f"8a: the node serves {type(codec).__name__} on {getattr(codec, 'device', '?')}")
        log(f"8a Node.build over {DRIVES} wrapped drives with the probe in {build_s:.2f} s: "
            f"{type(codec).__name__} on {codec.device}; verdict {verdict}")
        client = HttpClient(f"http://127.0.0.1:{port}")
        st, _, _ = client.call("request", "PUT", "/bench")
        if st != 200:
            raise AssertionError(f"8a: make bucket {st}")
        n = client.call("register", 80, n_objects, max_size, "boot")
        client.call("register_bytes", "boot/big", 81, big_mib * MiB)
        traffic = Traffic(80, n, max_size, "boot")
        names = traffic.names + ["boot/big"]
        nbytes = int(sum(traffic.sizes)) + big_mib * MiB
        del traffic

        def run(path: str, fn, need=("rs_gf_apply", "hh256")):
            tally.reset()
            t = time.perf_counter()
            res = fn()
            wall = time.perf_counter() - t
            paths[path] = tally.read(path, need)
            _no_host_fallback(codec, path)
            return res, wall

        res, wall = run("boot_put", lambda: client.call("put", names, {}, threads))
        log(f"8a boot_put: {len(names)} objects ({nbytes / MiB:.1f} MiB) {len(names) / wall:.1f} objects/s, "
            f"{nbytes / 2**30 / wall:.4f} GiB/s, p50 {_percentile(res['latencies'], 50):.3f} s [{smi}]")
        res, wall = run("boot_get", lambda: client.call("get", names, threads), need=("hh256",))
        log(f"8a boot_get: {len(names) / wall:.1f} objects/s, {nbytes / 2**30 / wall:.4f} GiB/s [{smi}]")
        side = "; ".join(f"{k} {rates[k]['objects_per_s']:.1f} objects/s, {rates[k]['gib_per_s']:.4f} GiB/s"
                         for k in ("pools_put_pool0", "pools_get", "http_put", "http_get") if k in rates)
        log(f"8a direct layer and phase 6, same run: {side}")

        kept = {i: _part_tree(dirs[i]) for i in BOOT_LOST}
        removed = sum(len(v) for v in kept.values())
        for i in BOOT_LOST:
            for rel in kept[i]:
                os.remove(os.path.join(dirs[i], "bench", rel))
        res, wall = run("boot_degraded_get", lambda: client.call("get", names, threads))
        log(f"8a boot_degraded_get with {removed} part files of drives {BOOT_LOST} removed: "
            f"{len(names) / wall:.1f} objects/s, {nbytes / 2**30 / wall:.4f} GiB/s, byte-exact [{smi}]")
        status, wall = run("boot_heal", lambda: _heal_until_done(client))
        healed = {i: _part_tree(dirs[i]) for i in BOOT_LOST}
        if healed != kept:
            diff = [i for i in BOOT_LOST if healed[i] != kept[i]]
            raise AssertionError(f"8a admin heal: the part files of drives {diff} differ from the removed ones")
        log(f"8a boot_heal through admin /heal in {wall:.2f} s: {json.dumps(status)}; the {removed} part files "
            f"are byte-identical to the removed ones")

        client.call("register_bytes", "boot/mrf", 82, mrf_mib * MiB)
        healed0 = node.mrf.healed

        def mrf():
            st, doc = client.call("admin", "POST", f"{ADMIN_PREFIX}/chaos", (),
                                  {"kind": "drive-error", "target": _drive_name(BOOT_MRF_DRIVE),
                                   "ops": ["rename_data"], "count": 1})
            if st != 200:
                raise AssertionError(f"8a /chaos arm: {st} {doc}")
            try:
                client.call("put", ["boot/mrf"], {}, 1)
            finally:
                client.call("admin", "DELETE", f"{ADMIN_PREFIX}/chaos", [("fault-id", doc["fault_id"])])
            return _wait_for(lambda: node.mrf.healed > healed0, 120, "the MRF heal")

        waited, wall = run("boot_mrf", mrf)
        client.call("get", ["boot/mrf"], 1)
        if not os.path.isdir(os.path.join(dirs[BOOT_MRF_DRIVE], "bench", "boot", "mrf")):
            raise AssertionError("8a: the MRF did not rewrite the failed drive's copy")
        log(f"8a boot_mrf: the PUT under a /chaos drive-error on {_drive_name(BOOT_MRF_DRIVE)} was healed by "
            f"the MRF {waited:.2f} s after its answer; MRF healed {node.mrf.healed}, failed {node.mrf.failed}")
        st, perf = client.call("admin", "GET", f"{ADMIN_PREFIX}/perf")
        if st != 200:
            raise AssertionError(f"8a /perf: {st}")
        _check_probe(perf, device)
        log(f"8a /perf probe: {json.dumps(perf['probe'])}")
    finally:
        if client is not None:
            client.close()
        stop.set()
        thread.join(10)
        node.close()
        Node.close_all()
        runtime.shutdown_data_plane()
    shutil.rmtree(base, ignore_errors=True)
    return paths


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class CliServer:
    """One `python3 -m minio_tpu_torch server` (or `command`) process; a
    reader thread keeps its output lines with their times since spawn."""

    def __init__(self, args: list, port: int, env: dict | None = None, command: str = "server"):
        self.port = port
        # PYTHONFAULTHANDLER: a server that will not stop dumps every
        # thread's stack on the SIGABRT stop() sends it.
        full = dict(os.environ, MINIO_ROOT_USER=HTTP_CREDS[0], MINIO_ROOT_PASSWORD=HTTP_CREDS[1],
                    PYTHONFAULTHANDLER="1")
        full.pop("MINIO_TPU_CODEC", None)
        full.pop("MTPU_CRASH", None)
        full.update(env or {})
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "minio_tpu_torch", command, "--json", "--address", f"127.0.0.1:{port}", *args],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=full, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines: list = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append((time.perf_counter() - self.t0, line.rstrip("\n")))

    def online(self, timeout: float = 300.0) -> tuple[float, dict]:
        def up():
            if self.proc.poll() is not None:
                raise AssertionError(f"the server exited {self.proc.returncode}: {self.text()[-3000:]}")
            return any('"msg": "online"' in ln for _, ln in self.lines)

        _wait_for(up, timeout, "the server's online line")
        t, ln = next((t, ln) for t, ln in self.lines if '"msg": "online"' in ln)
        return t, json.loads(ln)

    def first_put_200(self, timeout: float = 300.0) -> tuple[float | None, list]:
        """Poll a signed PUT of the bucket from the spawn on: (seconds to
        the first 200, or None if the server exited first; every status
        seen before it)."""
        from minio_tpu_torch.api import auth

        seen = []
        while time.perf_counter() - self.t0 < timeout:
            if self.proc.poll() is not None:
                return None, seen
            try:
                st = _signed_status(self.port, "PUT", "/bench", auth)
            except OSError:
                st = None
            if st == 200:
                return time.perf_counter() - self.t0, seen
            if st is not None:
                seen.append(st)
            time.sleep(0.05)
        raise AssertionError(f"no 200 PUT within {timeout} s: {seen[-5:]}")

    def text(self) -> str:
        return "\n".join(ln for _, ln in self.lines)

    def stop(self, timeout: float = 15.0) -> tuple[int, float]:
        t = time.perf_counter()
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.send_signal(signal.SIGABRT)
            try:
                self.proc.wait(10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(10)
            self._reader.join(5)
            out, busy, idle = _split_stacks(self.text())
            raise AssertionError(f"the server did not exit within {timeout} s of SIGTERM; the end of its "
                                 f"output:\n{out[-2000:]}\nthe stacks of its {len(busy)} threads in the port's "
                                 f"code ({idle} others idle in the standard library):\n" + "\n".join(busy)[-12000:])
        self._reader.join(5)
        return rc, time.perf_counter() - t


def _split_stacks(text: str) -> tuple[str, list, int]:
    """Split a server's output at its faulthandler dump: (the output before
    it, the stacks of threads with a frame in the port's code, the count of
    the others, idle pool workers and the like)."""
    head, sep, dump = text.partition("Fatal Python error")
    busy, idle = [], 0
    for block in re.split(r"\n(?=(?:Thread|Current thread) 0x)", sep + dump)[1:]:
        block = block.split("\nExtension modules:")[0].rstrip()
        if "minio_tpu_torch" in block:
            busy.append(block)
        else:
            idle += 1
    return head, busy, idle


def _stack_tail(stack: str) -> list:
    """A logged thread stack cut to its frames in the port's code and its
    innermost frame, each as "file:line in function"."""
    frames = re.findall(r'File "([^"]+)", line (\d+), in (\S+)', stack)
    keep = [f for f in frames[:-1] if "minio_tpu_torch" in f[0]] + frames[-1:]
    return [f"{path.split('minio_tpu_torch/')[-1] if 'minio_tpu_torch/' in path else os.path.basename(path)}:"
            f"{line} in {fn}" for path, line, fn in keep]


def _signed_status(port: int, method: str, path: str, auth) -> int:
    import http.client

    h = auth.sign_request(auth.Credentials(*HTTP_CREDS), method, path, [], {"host": f"127.0.0.1:{port}"}, b"")
    h.pop("host")
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request(method, path, body=b"", headers=h)
        r = c.getresponse()
        r.read()
        return r.status
    finally:
        c.close()


def reset_stages(client) -> None:
    st, _ = client.call("admin", "GET", f"{ADMIN_PREFIX}/perf", [("reset", "1")])
    if st != 200:
        raise AssertionError(f"/perf?reset=1: {st}")


def server_stages(client, label: str) -> dict:
    """The server's stage ledger since the last reset, for the stages that
    carry a path's time, and its GIL load; returns the /perf document."""
    st, perf = client.call("admin", "GET", f"{ADMIN_PREFIX}/perf")
    if st != 200:
        raise AssertionError(f"{label}: /perf {st}")
    stages = perf["node"]["stages"]
    keep = {f"{layer}/{stage}": {k: rec[k] for k in ("count", "p50_ms", "p99_ms", "total_ms", "cpu_seconds")}
            for layer, recs in sorted(stages.items()) for stage, rec in sorted(recs.items())
            if layer in ("api", "codec") or stage in ("object.PutObject", "object.GetObject", "encode", "commit",
                                                     "shard-read", "frame-parse", "decode")}
    st, prof = client.call("admin", "GET", f"{ADMIN_PREFIX}/profile", [("summary", "1")])
    gil = prof.get("gil_load") if st == 200 and isinstance(prof, dict) else None
    log(f"{label} server stage ledger: {json.dumps(keep)}; gil_load {gil}")
    perf["gil_load"] = gil
    return perf


def phase_boot_cli(smi: str, root: str, rates: dict, device: str = "cuda", n_objects: int = 32,
                   big_mib: int = 64, crash_mib: int = 4, max_size: int = 4 * MiB,
                   threads: int = HTTP_THREADS) -> None:
    """8b: the real CLI over 48 drives in two pools (32 + 16, three 12+4
    sets): boot, traffic, SIGTERM, restart, a crash and the recovery boot."""
    base = os.path.join(root, "boot")
    args = [os.path.join(base, "p0", "drive{00...31}"), os.path.join(base, "p1", "drive{00...15}")]
    if device == "cpu":
        args = ["--device", "cpu", *args]
    drive_dirs = [os.path.join(base, "p0", f"drive{i:02d}") for i in range(32)] + \
                 [os.path.join(base, "p1", f"drive{i:02d}") for i in range(16)]
    port = _free_port()
    srv = CliServer(args, port)
    client = None
    try:
        first_put_s, before = srv.first_put_200()
        if first_put_s is None:
            raise AssertionError(f"8b: the server exited {srv.proc.returncode}: {srv.text()[-3000:]}")
        online_s, online = srv.online()
        want = {"codec": "BatchingDeviceCodec", "drives": 48, "pools": 2, "sets": 3}
        if {k: online.get(k) for k in want} != want:
            raise AssertionError(f"8b online line {online}, want {want}")
        if 200 in before or set(before) - {503}:
            raise AssertionError(f"8b: answers before the first 200 PUT: {before}")
        log(f"8b CLI boot: online {online_s:.2f} s after spawn, first 200 PUT {first_put_s:.2f} s "
            f"({len(before)} answers 503 before it); online line {json.dumps(online)} [{smi}]")
        client = HttpClient(f"http://127.0.0.1:{port}")
        n = client.call("register", 90, n_objects, max_size, "cli")
        client.call("register_bytes", "cli/big", 91, big_mib * MiB)
        traffic = Traffic(90, n, max_size, "cli")
        names, nbytes = traffic.names, int(sum(traffic.sizes))
        reset_stages(client)
        res = client.call("put", names, {}, threads)
        log(f"8b PUT {n} objects ({nbytes / MiB:.1f} MiB) from {threads} threads: {n / res['wall']:.1f} objects/s, "
            f"{nbytes / 2**30 / res['wall']:.4f} GiB/s, p50 {_percentile(res['latencies'], 50):.3f} s [{smi}]")
        big = client.call("put", ["cli/big"], {}, 1)
        log(f"8b PUT {big_mib} MiB aws-chunked: {big_mib / 1024 / big['wall']:.4f} GiB/s [{smi}]")
        codec_stages = server_stages(client, "8b PUT (both)")["node"]["stages"].get("codec", {})
        if not codec_stages.get("encode-batch", {}).get("count"):
            raise AssertionError(f"8b: /perf has no codec encode-batch record after the PUTs: {codec_stages}")
        reset_stages(client)
        res = client.call("get", names + ["cli/big"], threads)
        log(f"8b GET {n + 1} objects byte-exact: {(n + 1) / res['wall']:.1f} objects/s, "
            f"{res['bytes'] / 2**30 / res['wall']:.4f} GiB/s, p50 {_percentile(res['latencies'], 50):.3f} s [{smi}]")
        perf = server_stages(client, "8b GET")
        if not perf["node"]["stages"].get("codec", {}).get("verify-batch", {}).get("count"):
            raise AssertionError("8b: /perf has no codec verify-batch record after the GETs")
        side = "; ".join(f"{k} {rates[k]['objects_per_s']:.1f} objects/s, {rates[k]['gib_per_s']:.4f} GiB/s"
                         for k in ("pools_put_pool0", "pools_get", "http_put", "http_get") if k in rates)
        log(f"8b direct layer and phase 6, same run: {side}")
        _check_probe(perf, device)
        log(f"8b /perf probe {json.dumps(perf['probe'])}")
        st, doc = client.call("admin", "POST", f"{ADMIN_PREFIX}/users", (),
                              {"accessKey": BOOT_USER[0], "secretKey": BOOT_USER[1], "policies": ["readwrite"]})
        if st != 200:
            raise AssertionError(f"8b add user: {st} {doc}")
        rc, stop_s = srv.stop()
        if rc != 0:
            raise AssertionError(f"8b SIGTERM: rc {rc}")
        log(f"8b SIGTERM: rc 0 in {stop_s:.2f} s")

        # The restart arms a crash point: its reads and the user's sign-in
        # come first, then the victim's PUT kills it.
        srv = CliServer(args, port, env={"MTPU_CRASH": CRASH_BOOT})
        online_s, _ = srv.online()
        res = client.call("get", names + ["cli/big"], threads)
        first = names[0]
        st, digest = client.call("request_as", *BOOT_USER, "GET", f"/bench/{first}")
        if st != 200 or digest != hashlib.sha256(bytes(traffic.data[first])).hexdigest():
            raise AssertionError(f"8b after the restart the user's GET answers {st}")
        log(f"8b restart (MTPU_CRASH={CRASH_BOOT}): online {online_s:.2f} s after spawn; every object "
            f"byte-exact ({(n + 1) / res['wall']:.1f} objects/s); the user signs in")
        client.call("register_bytes", "cli/victim", 92, crash_mib * MiB)
        try:
            client.call("put", ["cli/victim"], {}, 1)
            raise AssertionError(f"8b: the PUT under MTPU_CRASH={CRASH_BOOT} was answered")
        except AssertionError as e:
            if "was answered" in str(e):
                raise
        rc = srv.proc.wait(60)
        srv._reader.join(5)
        if rc != 137:
            raise AssertionError(f"8b crash boot: rc {rc}, want 137: {srv.text()[-2000:]}")
        srv = CliServer(args, port)
        online_s, _ = srv.online()
        st, _, body = client.call("request", "GET", "/bench/cli/victim")
        victim = "absent" if st == 404 else None
        if victim is None:
            if st != 200:
                raise AssertionError(f"8b recovery boot: the victim answers {st}")
            client.call("get", ["cli/victim"], 1)
            victim = "whole"
        res = client.call("get", names + ["cli/big"], threads)
        debris = _lasting_debris(drive_dirs)
        rc, stop_s = srv.stop()
        if debris or rc != 0:
            raise AssertionError(f"8b recovery boot: rc {rc}, debris {debris[:8]}")
        log(f"8b crash at {CRASH_BOOT} on a {crash_mib} MiB PUT: rc 137; the recovery boot was online "
            f"{online_s:.2f} s after spawn, the victim is {victim}, the {n + 1} acknowledged objects are "
            f"byte-exact ({(n + 1) / res['wall']:.1f} objects/s), no debris on the 48 drives; SIGTERM rc 0 "
            f"in {stop_s:.2f} s")
    finally:
        if client is not None:
            client.close()
        if srv.proc.poll() is None:
            srv.proc.kill()
            srv.proc.wait(10)
    shutil.rmtree(base, ignore_errors=True)


def phase_boot_hidden(root: str) -> None:
    """8c: the card hidden (CUDA_VISIBLE_DEVICES=) and the codec left on
    auto: the boot fails within the probe timeout and no PUT answers 200.
    The process may take `start_slack_s` more than the probe timeout: the
    interpreter starts and imports the CLI before serve spawns the child."""
    base = os.path.join(root, "hidden")
    timeout_s, start_slack_s = 60.0, 10.0
    srv = CliServer([os.path.join(base, "drive{00...15}")], _free_port(),
                    env={"CUDA_VISIBLE_DEVICES": "", "MINIO_TPU_DEVICE_PROBE_S": str(timeout_s)})
    try:
        try:
            t, seen = srv.first_put_200(timeout=timeout_s + start_slack_s)
        except AssertionError as e:
            raise AssertionError(f"8c: the server still runs {timeout_s + start_slack_s:.0f} s after spawn "
                                 f"with the card hidden ({e})") from None
        rc = srv.proc.wait(30)
        elapsed = time.perf_counter() - srv.t0
    finally:
        if srv.proc.poll() is None:
            srv.proc.kill()
            srv.proc.wait(10)
    srv._reader.join(5)
    out = srv.text()
    if t is not None or 200 in seen:
        raise AssertionError(f"8c: a PUT answered 200 with the card hidden: {seen}")
    if rc == 0 or "FATAL: node bootstrap failed: device probe failed" not in out or "no CUDA device" not in out:
        raise AssertionError(f"8c: rc {rc}, output {out[-2000:]}")
    if '"msg": "online"' in out:
        raise AssertionError("8c: the server said online with the card hidden")
    if elapsed >= timeout_s + start_slack_s:
        raise AssertionError(f"8c: the boot failed {elapsed:.2f} s after spawn, past the probe timeout "
                             f"{timeout_s:.0f} s and {start_slack_s:.0f} s for the interpreter's start")
    log(f"8c card hidden: rc {rc} after {elapsed:.2f} s (probe timeout {timeout_s:.0f} s, "
        f"+{start_slack_s:.0f} s start allowed); "
        f"{len(seen)} PUTs answered {sorted(set(seen))} and none 200; "
        + next(ln for ln in out.splitlines() if ln.startswith("FATAL")))
    shutil.rmtree(base, ignore_errors=True)


def phase_boot(smi: str, root: str, tally: Tally, rates: dict, device: str = "cuda", **sizes) -> dict:
    t0 = time.perf_counter()
    paths = phase_boot_node(smi, root, tally, rates, device, **sizes.get("node", {}))
    log(f"8a done in {time.perf_counter() - t0:.1f} s")
    t = time.perf_counter()
    phase_boot_cli(smi, root, rates, device, **sizes.get("cli", {}))
    log(f"8b done in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_boot_hidden(root)
    log(f"8c done in {time.perf_counter() - t:.1f} s; phase 8 took {time.perf_counter() - t0:.1f} s")
    return paths



def phase_host_library(smi: str, root: str, codec, tally: Tally, kernels: dict, n_mib: int = 16,
                       timing_blocks: int = 64) -> dict:
    """9a: the native host library (ops/native.py over csrc/host/*.cpp), held
    against the port's numpy versions at the main path's shapes, timed
    beside the kernels, and its O_DIRECT branch under a 16 MiB PUT/GET."""
    from minio_tpu_torch.control import compress
    from minio_tpu_torch.object.codec import HostCodec
    from minio_tpu_torch.ops import highwayhash as np_hh
    from minio_tpu_torch.ops import native, rs_matrix, rs_ref

    t0 = time.perf_counter()
    earlier = native.status()[1]
    native.load()
    how = ("already loaded by an earlier phase's drive I/O" if earlier
           else f"built or loaded in {time.perf_counter() - t0:.3f} s")
    log(f"9a host library: {native.loaded_path()} {how} (g++ {' '.join(native.CXX_FLAGS)}, "
        f"from minio_tpu_torch/csrc/host/)")
    rng = np.random.default_rng(2026)
    pm = rs_matrix.parity_matrix(K, M)
    # RS encode of 1 MiB blocks [12+4] and a 4-row reconstruct.
    blocks = [rng.bytes(MiB) for _ in range(4)]
    for b in blocks:
        shards = rs_matrix.split(np.frombuffer(b, dtype=np.uint8), K)
        full = np.concatenate([shards, native.rs_encode(shards, pm)])
        if not np.array_equal(full, rs_ref.encode(shards.copy(), M)):
            raise AssertionError("9a: host rs_encode differs from the numpy encode")
        lost = (0, 5, 10, 15)
        present = tuple(i not in lost for i in range(K + M))
        survivors = np.stack([full[i] for i in range(K + M) if present[i]][:K])
        rebuilt = native.rs_apply(survivors, rs_matrix.reconstruct_rows(K, M, present, lost))
        want = rs_ref.reconstruct([None if i in lost else full[i] for i in range(K + M)], K, M, data_only=False)
        if any(not np.array_equal(rebuilt[j], want[i]) for j, i in enumerate(lost)):
            raise AssertionError("9a: host rs_apply differs from the numpy reconstruct")
    # The GET verify batch [16, 87382] and the frame verifier.
    rows = np.frombuffer(rng.bytes(16 * S_FULL), dtype=np.uint8).reshape(16, S_FULL)
    digests = native.hh256_batch(rows, np_hh.MAGIC_KEY)
    if not np.array_equal(digests, np_hh.hash256_batch(rows)):
        raise AssertionError("9a: host hh256_batch differs from the numpy hash")
    framed = bytearray(native.hh256_frame(rows, np_hh.MAGIC_KEY))
    framed[7 * (32 + S_FULL) + 100] ^= 1
    flags = native.hh256_verify_frames(bytes(framed), S_FULL, 16, np_hh.MAGIC_KEY)
    if list(flags) != [1] * 7 + [0] + [1] * 8:
        raise AssertionError(f"9a: hh256_verify_frames flags {list(flags)}")
    # A snappy round trip, read back by the pure-Python decoder too.
    words = np.array([b"tenant", b"bucket", b"object", b"drive", b"\n"])
    text = b" ".join(words[rng.integers(0, len(words), 400_000)])
    blob, meta = compress.compress(text)
    if meta[compress.META_COMPRESSION] != compress.ALGO_SNAPPY or native.snappy_decompress(blob) != text \
            or compress.snappy_decompress(blob) != text:
        raise AssertionError("9a: snappy round trip")
    log(f"9a host library equals the numpy versions: rs_encode and rs_apply (4 lost) on 4 x 1 MiB [12+4], "
        f"hh256_batch [16, {S_FULL}], hh256_verify_frames (one flipped byte found), snappy "
        f"{len(text)} -> {len(blob)} bytes and back (native and pure-Python decoders)")

    # Host times at the kernels' shapes (host clock; one thread, as the
    # host codec runs), beside phase 2's CUDA-event times.
    def best(fn, reps: int = 3) -> float:
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return min(times)

    data = np.frombuffer(rng.bytes(timing_blocks * K * S_FULL), dtype=np.uint8).reshape(timing_blocks, K, S_FULL)
    parity = np.empty((timing_blocks, M, S_FULL), dtype=np.uint8)
    rs_ms = best(lambda: [native.rs_encode(data[i], pm, out=parity[i]) for i in range(timing_blocks)])
    hh16_ms = best(lambda: native.hh256_batch(rows, np_hh.MAGIC_KEY))
    wide = np.frombuffer(rng.bytes(1024 * S_FULL), dtype=np.uint8).reshape(1024, S_FULL)
    hh1024_ms = best(lambda: native.hh256_batch(wide, np_hh.MAGIC_KEY), reps=2)
    verify_ms = best(lambda: native.hh256_verify_frames(bytes(framed), S_FULL, 16, np_hh.MAGIC_KEY))
    group = [rng.bytes(MiB) for _ in range(timing_blocks)]
    host = HostCodec()
    encode_ms = best(lambda: host.encode_group(group, K, M), reps=2)
    encode_gib_s = timing_blocks * MiB / 2**30 / (encode_ms / 1e3)
    verify_gib_s = 16 * S_FULL / 2**30 / (verify_ms / 1e3)
    rs_k, hh_k = kernels["rs_gf_apply"], kernels["hh256"]
    rs_k["host_ms"], hh_k["host_ms"], hh_k["host_ms_n16"] = rs_ms, hh1024_ms, hh16_ms
    log(f"9a host library times (host clock, one thread, best of 2-3) beside phase 2's kernels [{smi}]: "
        f"rs_encode [{timing_blocks}, 12, {S_FULL}] {rs_ms:.3f} ms (kernel {rs_k['ms']:.4f} ms, "
        f"{rs_ms / rs_k['ms']:.0f}x); hh256_batch [16, {S_FULL}] {hh16_ms:.3f} ms (kernel "
        f"{hh_k['ms_n16']:.4f} ms, {hh16_ms / hh_k['ms_n16']:.0f}x); [1024, {S_FULL}] {hh1024_ms:.2f} ms "
        f"(kernel {hh_k['ms']:.4f} ms, {hh1024_ms / hh_k['ms']:.0f}x); host codec encode_group of "
        f"{timing_blocks} x 1 MiB [12+4] {encode_ms:.2f} ms = {encode_gib_s:.3f} GiB/s; "
        f"hh256_verify_frames of one row's 16 frames {verify_ms:.3f} ms = {verify_gib_s:.3f} GiB/s")

    # O_DIRECT on the run root, and the native branch under a 16 MiB PUT/GET
    # through the card's codec, then a heal of two lost drives.
    log(f"9a odirect_supported({root}) = {native.odirect_supported(root)}")
    base = os.path.join(root, "host_io")
    eo, drives = _make_set(base, codec)
    io_calls: collections.Counter = collections.Counter()
    real_write, real_read = native.write_file, native.read_file

    def counted(kind, real):
        def call(*args, **kwargs):
            io_calls[kind] += 1
            return real(*args, **kwargs)
        return call

    native.write_file, native.read_file = counted("write", real_write), counted("read", real_read)
    try:
        payload = rng.bytes(n_mib * MiB)
        io = {}
        tally.reset()
        eo.put_object("bench", "io-object", payload)
        io["put"] = dict(io_calls)
        io_calls.clear()
        if eo.get_object("bench", "io-object")[1] != payload:
            raise AssertionError("9a: GET of the 16 MiB object")
        io["get"] = dict(io_calls)
        io_calls.clear()
        before = [_read(_part_path(drives[i], "io-object")) for i in (2, 9)]
        for i in (2, 9):
            os.remove(_part_path(drives[i], "io-object"))
        eo.heal_object("bench", "io-object")
        io["heal"] = dict(io_calls)
        if [_read(_part_path(drives[i], "io-object")) for i in (2, 9)] != before:
            raise AssertionError("9a: the healed part files differ from the removed ones")
        counts = tally.read("host_io_put_get_heal")
    finally:
        native.write_file, native.read_file = real_write, real_read
    part = len(before[0])
    log(f"9a native file I/O on a 16-drive set, {n_mib} MiB object ({part} B part file a drive): "
        f"PUT {io['put'] or 'none'}, GET {io['get'] or 'none'}, heal of 2 drives {io['heal'] or 'none'} "
        f"(writes/reads at or past {128 << 10} B take the native branch: whole-file create_file/read_file; "
        f"the PUT appends its staged row windows and the GET reads into pooled buffers, both buffered)")
    shutil.rmtree(base, ignore_errors=True)
    return counts


def _worker_connections(pids: list, port: int) -> dict:
    """{pid: established connections to `port` that this pid accepted},
    from /proc: each pid's socket inodes matched to /proc/net/tcp rows."""
    inodes: dict = {}
    for pid in pids:
        fd_dir = f"/proc/{pid}/fd"
        with contextlib.suppress(OSError):
            for fd in os.listdir(fd_dir):
                with contextlib.suppress(OSError):
                    link = os.readlink(os.path.join(fd_dir, fd))
                    if link.startswith("socket:["):
                        inodes[link[8:-1]] = pid
    out = dict.fromkeys(pids, 0)
    with open("/proc/net/tcp") as f:
        for row in f.read().splitlines()[1:]:
            cols = row.split()
            local_port = int(cols[1].rsplit(":", 1)[1], 16)
            if local_port == port and cols[3] == "01" and cols[9] in inodes:
                out[inodes[cols[9]]] += 1
    return out


def _probe_connections(port: int, pids: list, n: int, path: str) -> dict:
    """Open n connections from this process, GET `path` (signed) on each
    and hold them open: which worker accepted each, by /proc. Every GET
    must answer 200."""
    import http.client

    from minio_tpu_torch.api import auth

    conns = []
    try:
        for _ in range(n):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            h = auth.sign_request(auth.Credentials(*HTTP_CREDS), "GET", path, [], {"host": f"127.0.0.1:{port}"}, b"")
            h.pop("host")
            c.request("GET", path, headers=h)
            r = c.getresponse()
            r.read()
            if r.status != 200:
                raise AssertionError(f"GET {path}: {r.status}")
            conns.append(c)
        return _worker_connections(pids, port)
    finally:
        for c in conns:
            c.close()


def _online_lines(srv) -> list:
    """Every online line of the master's merged output. The workers share
    one stream, so another process's text may share a line with one."""
    dec, out = json.JSONDecoder(), []
    for _, ln in list(srv.lines):
        i = ln.find('{"msg": "online"')
        while i >= 0:
            obj, end = dec.raw_decode(ln, i)
            out.append(obj)
            i = ln.find('{"msg": "online"', end)
    return out


def _wait_workers(srv, n: int, timeout: float) -> tuple[float, list]:
    """Seconds from the spawn until n online lines, and the lines."""
    def up():
        if srv.proc.poll() is not None:
            raise AssertionError(f"the master exited {srv.proc.returncode}: {srv.text()[-3000:]}")
        return len(_online_lines(srv)) >= n

    _wait_for(up, timeout, f"{n} online lines")
    return time.perf_counter() - srv.t0, _online_lines(srv)


def phase_prefork(smi: str, root: str, device: str = "cuda", workers: tuple = (1, 2, 4),
                  n_objects: int = 32, n_kill: int = 64, max_size: int = 4 * MiB,
                  threads: int = HTTP_THREADS) -> None:
    """9b and 9c: `python3 -m minio_tpu_torch server` on phase 8b's 48-drive
    two-pool deployment at MTPU_WORKERS = 1, 2, 4 in turn (the one-worker
    boot formats the drives), each with the 16-thread client: n_objects PUTs
    of phase 5's size law, then byte-exact GETs. 9c runs in the two-worker
    boot after its reads: one worker is SIGKILLed during n_kill more PUTs,
    the master respawns it, it probes and serves, every acknowledged PUT
    reads back byte-exact; the next boot's recovery scan leaves no debris."""
    base = os.path.join(root, "prefork")
    args = [os.path.join(base, "p0", "drive{00...31}"), os.path.join(base, "p1", "drive{00...15}")]
    if device == "cpu":
        args = ["--device", "cpu", *args]
    drive_dirs = [os.path.join(base, "p0", f"drive{i:02d}") for i in range(32)] + \
                 [os.path.join(base, "p1", f"drive{i:02d}") for i in range(16)]
    port = _free_port()
    killed: dict = {}
    client = HttpClient(f"http://127.0.0.1:{port}")  # one client process for every boot on this port
    try:
        for n_workers in workers:
            srv = CliServer(args, port, env={"MTPU_WORKERS": str(n_workers), "MTPU_WORKER_RESPAWNS": "1"})
            try:
                online_s, online = _wait_workers(srv, n_workers, 300)
                pids = sorted(o["pid"] for o in online)
                probes = [o.get("probe") for o in online]
                if device == "cuda" and not all(p and p.startswith("PROBE_OK gpu ") for p in probes):
                    raise AssertionError(f"9b: the workers' probe verdicts {probes}")
                if killed:
                    # The boot after 9c: its recovery scans ran before online.
                    debris = _lasting_debris(drive_dirs)
                    if debris:
                        raise AssertionError(f"9c: debris after the next boot's recovery scan: {debris[:8]}")
                    log(f"9c the next boot ({n_workers} workers) is online with no stage debris on the 48 drives")
                if n_workers == workers[0]:
                    st = client.call("request", "PUT", "/bench")[0]
                    if st != 200:
                        raise AssertionError(f"9b: make bucket: {st}")
                stem = f"w{n_workers}"
                n = client.call("register", 93, n_objects, max_size, stem)
                names = Traffic(93, n, max_size, stem).names
                reset_stages(client)
                put = client.call("put", names, {}, threads)
                gil_put = server_stages(client, f"9b {n_workers} worker(s), PUT (one worker's)")["gil_load"]
                reset_stages(client)
                get = client.call("get", names, threads)
                gil_get = server_stages(client, f"9b {n_workers} worker(s), GET (one worker's)")["gil_load"]
                spread = _probe_connections(port, pids, 16, f"/bench/{names[0]}") if n_workers > 1 else {pids[0]: 16}
                row = {
                    "online_s": online_s, "pids": pids, "probes": probes,
                    "put_objects_per_s": n / put["wall"], "get_objects_per_s": n / get["wall"],
                    "put_p50_s": _percentile(put["latencies"], 50), "put_p99_s": _percentile(put["latencies"], 99),
                    "get_p50_s": _percentile(get["latencies"], 50), "get_p99_s": _percentile(get["latencies"], 99),
                    "gil_load_put": gil_put, "gil_load_get": gil_get, "connections_by_worker": spread,
                }
                verdicts = " | ".join(f"worker {o.get('worker', 0)} pid {o['pid']}: {o.get('probe')}" for o in online)
                log(f"9b MTPU_WORKERS={n_workers}: every worker online {online_s:.2f} s after spawn; "
                    f"{verdicts}; "
                    f"PUT {n} objects {row['put_objects_per_s']:.1f} objects/s (p50 {row['put_p50_s']:.3f} s, p99 "
                    f"{row['put_p99_s']:.3f} s); GET byte-exact {row['get_objects_per_s']:.1f} objects/s (p50 "
                    f"{row['get_p50_s']:.3f} s, p99 {row['get_p99_s']:.3f} s); gil_load of the worker that "
                    f"answered /profile: PUT {gil_put}, GET {gil_get}; 16 new connections by worker pid {spread} [{smi}]")
                if n_workers == 2:
                    killed.update(_kill_a_worker(srv, client, pids, port, n_kill, max_size, threads, smi, device))
                rc, stop_s = srv.stop(30)
                if rc != 0:
                    raise AssertionError(f"9b: SIGTERM to the master: rc {rc}: {srv.text()[-2000:]}")
                live = [p for p in pids + killed.get("respawned", []) if _alive(p)]
                if live:
                    raise AssertionError(f"9b: worker processes alive after the master exited: {live}")
                log(f"9b MTPU_WORKERS={n_workers}: SIGTERM to the master, rc 0 in {stop_s:.2f} s, no worker left")
            finally:
                _stop_all(srv)
    finally:
        client.close()
    shutil.rmtree(base, ignore_errors=True)


def _stop_all(srv) -> None:
    """On the way out of a failed boot: SIGTERM to the master (it forwards
    it), then SIGKILL to it and to any worker still alive."""
    if srv.proc.poll() is None:
        srv.proc.send_signal(signal.SIGTERM)
        try:
            srv.proc.wait(20)
        except subprocess.TimeoutExpired:
            srv.proc.kill()
            srv.proc.wait(10)
    for o in _online_lines(srv):
        if _alive(o["pid"]):
            with contextlib.suppress(OSError):
                os.kill(o["pid"], signal.SIGKILL)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def _kill_a_worker(srv, client, pids: list, port: int, n: int, max_size: int, threads: int, smi: str,
                   device: str) -> dict:
    """9c, inside a two-worker boot: SIGKILL one worker while n PUTs run."""
    victim = pids[0]
    stem = "kill"
    client.call("register", 94, n, max_size, stem)
    names = Traffic(94, n, max_size, stem).names
    killed_at: list = []

    def kill():
        killed_at.append(time.perf_counter() - srv.t0)
        os.kill(victim, signal.SIGKILL)

    timer = threading.Timer(1.0, kill)
    timer.start()
    try:
        res = client.call("put_some", names, threads)
    finally:
        timer.join()
    _wait_workers(srv, 3, 120)
    t_new = next(t for t, ln in list(srv.lines) if '"msg": "online"' in ln
                 and not any(f'"pid": {p}' in ln for p in pids))
    new = next(o for o in _online_lines(srv) if o["pid"] not in pids)
    if device == "cuda" and not str(new.get("probe", "")).startswith("PROBE_OK gpu "):
        raise AssertionError(f"9c: the respawned worker's online line {new}")
    new_pid = new["pid"]
    acked = res["acked"]
    if not acked:
        raise AssertionError(f"9c: no PUT was acknowledged: {res['failed']}")
    get = client.call("get", acked, threads)
    spread = _probe_connections(port, [pids[1], new_pid], 16, f"/bench/{acked[0]}")
    if not spread.get(new_pid):
        raise AssertionError(f"9c: the respawned worker accepted none of 16 connections: {spread}")
    log(f"9c SIGKILL of worker pid {victim} 1 s into {n} PUTs from {threads} threads: {len(acked)} acknowledged, "
        f"{len(res['failed'])} failed ({sorted(set(map(str, res['failed'].values())))[:3]}); the master respawned "
        f"it as pid {new_pid}, online {t_new - killed_at[0]:.2f} s after the kill with "
        f"{new.get('probe')}; every acknowledged object byte-exact ({len(acked) / get['wall']:.1f} "
        f"objects/s); 16 new connections by worker pid {spread} [{smi}]")
    return {"victim": victim, "respawned": [new_pid], "acked": len(acked), "failed": len(res["failed"])}


# -- phase 10: a 4-node cluster on the one card ------------------------------------------------

CLUSTER_NODES, CLUSTER_DRIVES = 4, 4  # minio server http://host{1...4}/export{1...4}: one 16-drive set
CODEC_STAGES = ("encode-batch", "encode-batch-small", "verify-batch", "reconstruct-batch")


def _gpu_memory() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=memory.used,memory.total", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _codec_records(client, nodes, label: str = "") -> dict:
    """{node: {codec stage: records, "probe_ok": its /perf probe block's
    verdict}} from each node's own /perf ledger since the last reset. With a label,
    also prints each node's RestClient records (layer rpc-peer, one stage
    per endpoint and peer) summed by endpoint: calls and total ms."""
    out, rpc = {}, {}
    for n in nodes:
        st, perf = client.call("admin", "GET", f"{ADMIN_PREFIX}/perf", (), None, n)
        if st != 200:
            raise AssertionError(f"/perf on node {n + 1}: {st}")
        stages = perf["node"]["stages"]
        out[f"node{n + 1}"] = {k: v["count"] for k, v in stages.get("codec", {}).items() if k in CODEC_STAGES}
        out[f"node{n + 1}"]["probe_ok"] = perf["probe"]["ok"]
        by_path: dict = {}
        for stage, rec in stages.get("rpc-peer", {}).items():
            calls, ms = by_path.get(stage.split("@")[0].split("?")[0], (0, 0.0))
            by_path[stage.split("@")[0].split("?")[0]] = (calls + rec["count"], ms + rec["total_ms"])
        rpc[f"node{n + 1}"] = {k: [c, round(ms, 1)] for k, (c, ms) in sorted(by_path.items())}
    if label:
        log(f"{label} RestClient records by node, endpoint: [calls, total ms]: {json.dumps(rpc)}")
    return out


def _reset_cluster(client) -> None:
    st, _ = client.call("admin", "GET", f"{ADMIN_PREFIX}/perf", [("reset", "1"), ("cluster", "1")])
    if st != 200:
        raise AssertionError(f"/perf?reset=1&cluster=1: {st}")


def _latest_versions(dirs: list, name: str) -> set:
    from minio_tpu_torch.storage.local import LocalDrive

    out = set()
    for d in dirs:
        fi = LocalDrive(d).read_version("bench", name)
        out.add((fi.version_id, fi.mod_time, fi.data_dir, fi.size))
    return out


def phase_cluster(smi: str, root: str, device: str = "cuda", n_objects: int = 64, big_mib: int = 64,
                  n_new: int = 32, n_race: int = 8, race_kib: int = 512, n_sample: int = 8,
                  max_size: int = 4 * MiB, threads: int = HTTP_THREADS, speedtest: dict | None = None) -> dict:
    """10a-10f: four `python3 -m minio_tpu_torch server --url ...` processes
    over one 16-drive endpoint list, each node with 4 drives of its own: see
    the module docstring. Returns the codec records by node of each step.
    `speedtest` is the body of the cluster speedtest's POST (default one
    round at concurrency 8, 1 MiB objects; smaller for a rehearsal on the
    CPU)."""
    from minio_tpu_torch.object.codec import HostCodec
    from minio_tpu_torch.object.sets import ErasureSets
    from minio_tpu_torch.object.types import PutObjectOptions
    from minio_tpu_torch.storage import format as fmt
    from minio_tpu_torch.storage.local import LocalDrive

    base = os.path.join(root, "cluster")
    ports = [_free_port() for _ in range(CLUSTER_NODES)]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    dirs = [[os.path.join(base, f"n{n + 1}", f"d{d + 1}") for d in range(CLUSTER_DRIVES)] for n in range(CLUSTER_NODES)]
    flat = [d for node in dirs for d in node]
    endpoints = [f"{urls[n]}{dirs[n][d]}" for n in range(CLUSTER_NODES) for d in range(CLUSTER_DRIVES)]

    def args(n: int) -> list:
        return [*(["--device", "cpu"] if device == "cpu" else []), "--url", urls[n], *endpoints]

    def check_online(n: int, line: dict) -> None:
        want = {"codec": "BatchingDeviceCodec", "drives": 16, "pools": 1, "sets": 1, "device": device}
        if {k: line.get(k) for k in want} != want:
            raise AssertionError(f"10a node {n + 1} online line {line}, want {want}")
        if device == "cuda" and not str(line.get("probe", "")).startswith("PROBE_OK gpu "):
            raise AssertionError(f"10a node {n + 1}: its own probe's verdict {line.get('probe')}")

    records: dict = {}
    srvs = [CliServer(args(n), ports[n]) for n in range(CLUSTER_NODES)]
    client = None
    try:
        # 10a boot: all four at once, each with its own probe and codec.
        onlines = [srv.online(300) for srv in srvs]
        for n, (_, line) in enumerate(onlines):
            check_online(n, line)
        boot_s = max(t for t, _ in onlines)
        ids = {json.loads(_read(os.path.join(d, ".minio_tpu.sys", "format.json")))["id"] for d in flat}
        if len(ids) != 1:
            raise AssertionError(f"10a: the 16 drives carry deployment ids {ids}")
        mem = _gpu_memory() if device == "cuda" else "not measured (no card)"
        marked = [d for d in flat if os.path.exists(os.path.join(d, ".minio_tpu.sys", "healing.bin"))]
        log(f"10a 4 nodes x 4 drives online {boot_s:.2f} s after spawn (each: "
            f"{', '.join(f'{t:.2f} s' for t, _ in onlines)}); "
            + " | ".join(f"node {n + 1} pid {line['pid']}: {line.get('probe')}" for n, (_, line) in enumerate(onlines))
            + f"; one deployment id on the 16 drives, {len(marked)} of them marked for healing at boot; "
            f"card memory used/total {mem} [{smi}]")

        # 10b traffic: PUT round-robin over the nodes, GET through the next one.
        client = HttpClient(urls[0], urls[1:])
        if client.call("request", "PUT", "/bench")[0] != 200:
            raise AssertionError("10b: make bucket")
        n = client.call("register", 96, n_objects, max_size, "cl")
        client.call("register_bytes", "cl/big", 97, big_mib * MiB)
        traffic = Traffic(96, n, max_size, "cl")
        names = traffic.names + ["cl/big"]
        rrs = {k: {"x-amz-storage-class": "REDUCED_REDUNDANCY"} for k in traffic.names if traffic.storage_class[k]}
        put_on = {k: i % CLUSTER_NODES for i, k in enumerate(names)}
        get_on = {k: (i + 1) % CLUSTER_NODES for i, k in enumerate(names)}
        _reset_cluster(client)
        put = client.call("put", names, rrs, threads, put_on)
        st, cperf = client.call("admin", "GET", f"{ADMIN_PREFIX}/perf", [("cluster", "1")])
        cstages = cperf["cluster"]["stages"].get("codec", {}) if st == 200 else {}
        if not cstages.get("encode-batch", {}).get("count"):
            raise AssertionError(f"10b: /perf?cluster=1 has no encode-batch record after the PUTs: {cstages}")
        records["cluster_put"] = _codec_records(client, range(CLUSTER_NODES), "10b PUT")
        _reset_cluster(client)
        get = client.call("get", names, threads, get_on)
        st, cperf = client.call("admin", "GET", f"{ADMIN_PREFIX}/perf", [("cluster", "1")])
        if not cperf["cluster"]["stages"].get("codec", {}).get("verify-batch", {}).get("count"):
            raise AssertionError("10b: /perf?cluster=1 has no verify-batch record after the GETs")
        if sorted(cperf["peers"]) != sorted(urls[1:]) or not all(p["ok"] for p in cperf["peers"].values()):
            raise AssertionError(f"10b: /perf?cluster=1 peers {cperf['peers']}")
        records["cluster_get"] = _codec_records(client, range(CLUSTER_NODES), "10b GET")
        if device == "cuda" and not all(r["probe_ok"] for r in records["cluster_get"].values()):
            raise AssertionError(f"10b: a node's /perf probe block is not ok: {records['cluster_get']}")
        nbytes = put["bytes"]
        log(f"10b PUT {len(names)} objects ({nbytes / MiB:.1f} MiB, {len(rrs)} REDUCED_REDUNDANCY, one {big_mib} MiB) "
            f"round-robin over the 4 nodes from {threads} threads: {len(names) / put['wall']:.1f} objects/s, "
            f"{nbytes / 2**30 / put['wall']:.4f} GiB/s, p50 {_percentile(put['latencies'], 50):.3f} s, "
            f"p99 {_percentile(put['latencies'], 99):.3f} s [{smi}]")
        log(f"10b GET each through another node, byte-exact: {len(names) / get['wall']:.1f} objects/s, "
            f"{nbytes / 2**30 / get['wall']:.4f} GiB/s, p50 {_percentile(get['latencies'], 50):.3f} s, "
            f"p99 {_percentile(get['latencies'], 99):.3f} s; codec records by node: PUT "
            f"{json.dumps(records['cluster_put'])}, GET {json.dumps(records['cluster_get'])} [{smi}]")

        # Bytes against the host codec: a sample of every size class and both
        # storage classes, PUT into a numpy HostCodec set over the cluster's
        # 16 format.json files, leaves the same part files and inline data.
        by_class = collections.defaultdict(list)
        for k in traffic.names:
            by_class[(_size_class(len(traffic.data[k])), traffic.storage_class[k])].append(k)
        sample = [sorted(v, key=lambda k: len(traffic.data[k]))[0] for _, v in sorted(by_class.items())][:n_sample]
        formats = [fmt.DriveFormat.load(d) for d in flat]
        host_dirs = [os.path.join(base, "host", f"d{i}") for i in range(16)]
        for d, f in zip(host_dirs, formats):
            os.makedirs(d)
            f.save(d)
        host_set = ErasureSets.from_drives([LocalDrive(d) for d in host_dirs], formats[0],
                                           codec=HostCodec(use_native=False), pool_index=0)
        host_set.make_bucket("bench")

        def same_as_host(k: str, drive_dirs: list, what: str) -> None:
            for i, d in enumerate(drive_dirs):
                got = _object_files(SimpleNamespace(root=d), k)
                want = _object_files(SimpleNamespace(root=host_dirs[flat.index(d)]), k)
                if got.keys() != want.keys() or any(got[f] != want[f] for f in got if f != "xl.meta"):
                    raise AssertionError(f"{what} {k}: drive {d} differs from the host codec's")
                if LocalDrive(d).read_version("bench", k).inline_data != \
                        LocalDrive(host_dirs[flat.index(d)]).read_version("bench", k).inline_data:
                    raise AssertionError(f"{what} {k}: drive {d} inline data differs from the host codec's")

        for k in sample:
            host_set.put_object("bench", k, bytes(traffic.data[k]),
                                PutObjectOptions(storage_class=traffic.storage_class[k]))
            same_as_host(k, flat, "10b reference")
        covered = collections.Counter(f"{_size_class(len(traffic.data[k]))}/{traffic.storage_class[k] or 'STANDARD'}"
                                      for k in sample)
        log(f"10b reference check ok: {len(sample)} objects ({json.dumps(dict(sorted(covered.items())))}): "
            f"byte-identical part files and inline data on the 16 drives against the numpy host codec")

        # 10c dsync across nodes: n_race concurrent PUTs of one key.
        race = client.call("put_race", "cl/race", list(range(200, 200 + n_race)), race_kib << 10)
        if race["statuses"] != [200] * n_race:
            raise AssertionError(f"10c: the racing PUTs answered {race['statuses']}")
        seen = {client.call("fetch", "/bench/cl/race", i) for i in range(CLUSTER_NODES)}
        if len(seen) != 1 or next(iter(seen))[0] != 200 or next(iter(seen))[1] not in race["digests"]:
            raise AssertionError(f"10c: the nodes GET {seen}, want one of the {n_race} bodies")
        versions = _latest_versions(flat, "cl/race")
        if len(versions) != 1:
            raise AssertionError(f"10c: the 16 xl.meta files disagree on the latest version: {versions}")
        top = [client.call("admin", "GET", f"{ADMIN_PREFIX}/toplocks", (), None, i) for i in range(CLUSTER_NODES)]
        if any(st != 200 or not isinstance(doc, list) or any(set(e) != {"resource", "writer", "holders"} for e in doc)
               for st, doc in top):
            raise AssertionError(f"10c /toplocks: {top}")
        unlock = client.call("admin", "POST", f"{ADMIN_PREFIX}/force-unlock", (), {"resource": "bench/cl/race"})
        if unlock != (200, {"ok": True}):
            raise AssertionError(f"10c /force-unlock: {unlock}")
        log(f"10c {n_race} concurrent PUTs of one key ({race_kib} KiB, distinct bodies) through the 4 nodes: all 200 "
            f"in {race['wall']:.3f} s; every node GETs body {race['digests'].index(next(iter(seen))[1])}; the 16 "
            f"xl.meta agree on one latest version; /toplocks {[len(doc) for _, doc in top]} entries, /force-unlock ok")

        # 10d node loss: SIGKILL node 4 and its 4 drives. A 12+4 object keeps
        # its read and write quorum (12); a 14+2 object loses 4 of its 16
        # shards, past its 2 parity: it is unreadable, and a new one
        # unwritable (quorum 14), until node 4 is back.
        srvs[3].proc.kill()
        srvs[3].proc.wait(30)
        srvs[3]._reader.join(5)
        up = range(CLUSTER_NODES - 1)
        standard = [k for k in names if k not in rrs]
        _reset_cluster(client)
        dget = client.call("get", standard, threads, {k: i % 3 for i, k in enumerate(standard)})
        records["cluster_degraded_get"] = _codec_records(client, up, "10d degraded GET")
        if not sum(r.get("reconstruct-batch", 0) for r in records["cluster_degraded_get"].values()):
            raise AssertionError(f"10d: no reconstruct-batch record: {records['cluster_degraded_get']}")
        rrs_gets = [client.call("fetch", f"/bench/{k}", i % 3)[0] for i, k in enumerate(rrs)]
        if any(st != 503 for st in rrs_gets):
            raise AssertionError(f"10d: the REDUCED_REDUNDANCY objects answer {rrs_gets}, want 503 SlowDownRead")
        rrs_put = client.call("request", "PUT", "/bench/cl/rrs-during-loss",
                              (), {"x-amz-storage-class": "REDUCED_REDUNDANCY"}, bytes(200 << 10))[0]
        if rrs_put != 503:
            raise AssertionError(f"10d: a REDUCED_REDUNDANCY PUT with 12 of 16 drives answers {rrs_put}, want 503")
        m = client.call("register", 98, n_new, max_size, "cl-new")
        new = Traffic(98, m, max_size, "cl-new")
        _reset_cluster(client)
        put_new = client.call("put", new.names, {}, threads, {k: i % 3 for i, k in enumerate(new.names)})
        records["cluster_put_node_lost"] = _codec_records(client, up)
        log(f"10d SIGKILL of node 4: GET of the {len(standard)} STANDARD objects through nodes 1-3 byte-exact "
            f"{len(standard) / dget['wall']:.1f} objects/s, {dget['bytes'] / 2**30 / dget['wall']:.4f} GiB/s, "
            f"p50 {_percentile(dget['latencies'], 50):.3f} s, p99 {_percentile(dget['latencies'], 99):.3f} s; the "
            f"{len(rrs)} REDUCED_REDUNDANCY objects answer 503 and an RRS PUT 503 (14+2 past its parity); {m} new "
            f"STANDARD PUTs at 12 of 16 drives {m / put_new['wall']:.1f} objects/s; codec records by node: degraded "
            f"GET {json.dumps(records['cluster_degraded_get'])}, PUT {json.dumps(records['cluster_put_node_lost'])} "
            f"[{smi}]")

        # 10e rejoin and heal.
        srvs[3] = CliServer(args(3), ports[3])
        t_rejoin, line = srvs[3].online(300)
        check_online(3, line)

        def all_online():
            st, info = client.call("admin", "GET", f"{ADMIN_PREFIX}/info")
            return st == 200 and info["drivesOnline"] == 16

        waited = _wait_for(all_online, 60, "node 1 to see the 16 drives online")
        _reset_cluster(client)
        t = time.perf_counter()
        status = _heal_until_done(client)
        heal_s = time.perf_counter() - t
        records["cluster_heal"] = _codec_records(client, range(CLUSTER_NODES))
        for k in new.names:
            host_set.put_object("bench", k, bytes(new.data[k]))
            same_as_host(k, dirs[3], "10e heal")
        debris = _lasting_debris(flat)
        if debris:
            raise AssertionError(f"10e: debris on the drives: {debris[:8]}")
        if client.call("fetch", "/bench/cl/rrs-during-loss", 3)[0] != 404:
            raise AssertionError("10e: the refused REDUCED_REDUNDANCY PUT left an object")
        everything = names + new.names
        back = client.call("get", everything, threads, dict.fromkeys(everything, 3))
        log(f"10e node 4 restarted: online {t_rejoin:.2f} s after spawn ({line.get('probe')}), node 1 saw its drives "
            f"{waited:.2f} s later; admin /heal in {heal_s:.2f} s: {json.dumps(status)}; codec records by node "
            f"{json.dumps(records['cluster_heal'])}; node 4's drives hold the {m} new objects' part files equal to "
            f"the host codec's, no debris on the 16 drives, the refused RRS PUT absent; all {len(everything)} objects "
            f"(the RRS ones too) GET byte-exact from node 4 "
            f"({len(everything) / back['wall']:.1f} objects/s) [{smi}]")

        # The operations plane of the cluster: a speedtest through node 1 runs
        # the selftestobject verb on every node's own card codec; /metrics;
        # a listen stream on node 2 gets the events of PUTs through node 3
        # over the peer listen stream.
        t_ops = time.perf_counter()
        _reset_cluster(client)
        t = time.perf_counter()
        st, report = client.call("admin", "POST", f"{ADMIN_PREFIX}/speedtest/object", (),
                                 speedtest or {"concurrency": 8, "max_concurrency": 8})
        speed_s = time.perf_counter() - t
        records["cluster_speedtest"] = _codec_records(client, range(CLUSTER_NODES))
        if st != 200 or sorted(report["nodes"]) != sorted(urls) or \
                not all(r.get("ok") for r in report["nodes"].values()):
            raise AssertionError(f"10: POST /speedtest/object through node 1: {st} {report}")
        for nd, recs in records["cluster_speedtest"].items():
            if not (recs.get("encode-batch", 0) + recs.get("encode-batch-small", 0)) or not recs.get("verify-batch"):
                raise AssertionError(f"10: the cluster speedtest made no encode or verify batch on {nd}: {recs}")
        st, text = client.call("admin", "GET", f"{ADMIN_PREFIX}/metrics")
        if st != 200 or not text.startswith(b"# HELP "):
            raise AssertionError(f"10: GET /metrics through node 1: {st} {text[:200]!r}")
        n_listen = client.call("register", 99, 8, MiB, "listen", EV_TENANTS)
        heard = Traffic(99, n_listen, MiB, "listen", EV_TENANTS).names
        listen = _Stream(ports[1], "/bench", [("events", "s3:ObjectCreated:*")])
        try:
            # The peer streams attach after the watcher's 200: PUT through
            # node 3 until its first record reaches node 2's watcher.
            warm = 0
            while not listen.records:
                if warm == 50:
                    raise AssertionError("10: no record of node 3 reached the listen stream on node 2")
                client.call("request", "PUT", f"/bench/cl/listen-warm-{warm}", (), None, b"warm", True, False, 2)
                warm += 1
                time.sleep(0.1)
            client.call("put", heard, {}, threads, dict.fromkeys(heard, 2))
            want_keys = {f"bench/{k}" for k in heard}
            listen.wait(lambda recs: want_keys <= {r["Key"] for r in recs}, 30, "node 3's events on node 2")
        finally:
            listen.close()
        agg = report["aggregate"]
        log(f"10 operations: POST /speedtest/object through node 1 in {speed_s:.2f} s, every node's entry ok: "
            f"best concurrency {report['concurrency']}, PUT {agg['put_gibs']} GiB/s, GET {agg['get_gibs']} GiB/s, "
            f"scaling {json.dumps(report['scaling'])}; codec records by node "
            f"{json.dumps(records['cluster_speedtest'])}; GET /metrics 200; a listen stream on node 2 got the "
            f"{len(heard)} PUTs through node 3 (after {warm} warm-up PUTs); {time.perf_counter() - t_ops:.1f} s "
            f"[{smi}]")
    finally:
        if client is not None:
            client.close()
        # 10f: SIGTERM to all four; each exits 0.
        rcs, waits = [], []
        for srv in srvs:
            try:
                rc, waited = srv.stop(30)
                rcs.append(rc)
                waits.append(round(waited, 2))
            except AssertionError as e:
                rcs.append(str(e))
    if rcs != [0] * CLUSTER_NODES:
        raise AssertionError(f"10f: SIGTERM rcs {rcs}")
    # A node whose scanner outlived its shutdown grace logs where it was.
    busy = {n + 1: _stack_tail(json.loads(ln)["stack"]) for n, srv in enumerate(srvs)
            for _, ln in srv.lines if '"msg": "scanner still busy at shutdown"' in ln}
    log(f"10f SIGTERM to the 4 nodes: rc {rcs}, exited in {waits} s; scanners still busy at shutdown, by "
        f"node, with the end of their stacks: {json.dumps(busy) if busy else 'none'}")
    shutil.rmtree(base, ignore_errors=True)
    return records


LC_POOLS = 3  # pool 0 at boot; pools 1 and 2 attached through /pools/attach; 16 drives each
LC_TIER = "COLDTIER"
LC_DAMAGE_DRIVES = (2, 7, 9, 14)  # 11d: the drives of one set whose copies of the damaged objects are removed
LC_RESTORE_DAYS = 1


def _lifecycle_xml(expire: str, transition: str) -> str:
    """Objects under one tenant prefix expire (a Date in the past), those
    under another transition to the tier at once (Days 0)."""
    return ("<LifecycleConfiguration>"
            f"<Rule><ID>expire</ID><Status>Enabled</Status><Filter><Prefix>{expire}</Prefix></Filter>"
            "<Expiration><Date>2020-01-01T00:00:00Z</Date></Expiration></Rule>"
            f"<Rule><ID>cold</ID><Status>Enabled</Status><Filter><Prefix>{transition}</Prefix></Filter>"
            f"<Transition><Days>0</Days><StorageClass>{LC_TIER}</StorageClass></Transition></Rule>"
            "</LifecycleConfiguration>")


def _codec_ledger() -> dict:
    """The codec records of this process's stage ledger since its last reset."""
    from minio_tpu_torch.control.perf import GLOBAL_PERF, summarize

    stages = summarize(GLOBAL_PERF.ledger.snapshot()).get("codec", {})
    return {k: stages[k]["count"] for k in CODEC_STAGES if k in stages}


def _pools_holding(pool_dirs: list, name: str) -> dict:
    """{pool: number of its drives holding name's xl.meta}."""
    out = {}
    for p, dirs in enumerate(pool_dirs):
        n = sum(os.path.exists(os.path.join(d, "bench", name, "xl.meta")) for d in dirs)
        if n:
            out[p] = n
    return out


def _xl_metas(drive_dir: str) -> list:
    return [os.path.join(dp, f) for dp, _, files in os.walk(os.path.join(drive_dir, "bench")) for f in files
            if f == "xl.meta"]


def phase_lifecycle(smi: str, root: str, tally: Tally, device: str = "cuda", n_objects: int = 96,
                    max_size: int = 4 * MiB, threads: int = HTTP_THREADS, n_damaged: int = 8, n_restore: int = 4,
                    seed: int = 110) -> dict:
    """Phase 11: pool lifecycle, the scanner and tiering through a port Node
    in this process (no codec=: its build installs the batching codec on
    the process's probe verdict, which runtime.probe_device caches: phase
    8a's in the whole script), served over HTTP; all traffic is signed S3
    and admin.
    11a PUTs n_objects of phase 5's law (96; 128 before the cut that kept
    the phase near its minute) into pool 0 (16 drives) and attaches
    pool 1; 11b decommissions pool 0 into it; 11c attaches an empty pool 2
    and rebalances; 11d sets a lifecycle (one tenant expires, another
    transitions to an FS tier), removes n_damaged objects from 4 drives of
    one set and runs one scanner cycle that deep-checks every object (for
    this phase heal_sample is 1 and the cycle's DynamicSleeper is off: the
    throttle sleeps 10x each object's work, up to 1 s an object);
    11e restores n_restore transitioned objects and expires the copies in a
    second cycle. Returns the kernel counts of its four paths."""
    from minio_tpu_torch import cli, runtime
    from minio_tpu_torch.control import tiering as tiering_mod
    from minio_tpu_torch.control.perf import GLOBAL_PERF
    from minio_tpu_torch.dist.node import Node
    from minio_tpu_torch.object.erasure import META_BUCKET
    from minio_tpu_torch.object.poolmgr import CONFIG_FILE, PoolManager, _read_sys
    from minio_tpu_torch.utils import errors

    t_phase = time.perf_counter()
    paths: dict = {}
    base = os.path.join(root, "lifecycle")
    pool_dirs = [[os.path.join(base, f"pool{p}", _drive_name(i)) for i in range(DRIVES)] for p in range(LC_POOLS)]
    tier_dir = os.path.join(base, "tier")
    node = Node(pool_dirs[0], root_user=HTTP_CREDS[0], root_password=HTTP_CREDS[1], device=device)
    app = node.make_app()
    stop = threading.Event()
    port = _free_port()
    thread, errs = cli._run_app_until(app, "127.0.0.1", port, stop)
    if errs:
        raise AssertionError(f"11: the app did not start: {errs}")
    client = None
    try:
        t = time.perf_counter()
        node.build()
        codec = node.codec
        if type(codec).__name__ != "BatchingDeviceCodec" or codec.device.type != device:
            raise AssertionError(f"11: the node serves {type(codec).__name__} on {getattr(codec, 'device', '?')}")
        log(f"11 node boot (the process's probe verdict, format, build) in {time.perf_counter() - t:.2f} s: "
            f"{type(codec).__name__} on {codec.device}")
        client = HttpClient(f"http://127.0.0.1:{port}")

        def admin(method: str, path: str, doc=None) -> dict:
            st, out = client.call("admin", method, f"{ADMIN_PREFIX}{path}", (), doc)
            if st != 200:
                raise AssertionError(f"11 admin {method} {path}: {st} {out}")
            return out

        def until(pred, what: str, timeout: float = 600.0) -> None:
            # /pools/status walks every pool: poll it 4 times a second, not 20.
            t0 = time.perf_counter()
            while not pred():
                if time.perf_counter() - t0 > timeout:
                    raise AssertionError(f"11: timed out after {timeout:.0f} s waiting for {what}")
                time.sleep(0.25)

        def step(path: str | None, label: str, fn, n: int, need=("rs_gf_apply", "hh256")):
            """Run one step with every count zeroed just before it; print its
            wall time, objects/s, codec records and kernel launches."""
            tally.reset()
            GLOBAL_PERF.ledger.reset()
            t0 = time.perf_counter()
            res = fn()
            wall = time.perf_counter() - t0
            counts = tally.read(path or label, need)
            _no_host_fallback(codec, path or label)
            recs = _codec_ledger()
            if path is not None:
                paths[path] = counts
            log(f"11 {label}: {wall:.2f} s, {n} objects, {n / wall:.1f} objects/s; codec records "
                f"{json.dumps(recs)}; launches {json.dumps(counts['launches'])} [{smi}]")
            return res, recs

        st, _, _ = client.call("request", "PUT", "/bench")
        if st != 200:
            raise AssertionError(f"11a: make bucket {st}")
        n = client.call("register", seed, n_objects, max_size, "lc")
        traffic = Traffic(seed, n, max_size, "lc")
        names = traffic.names
        sizes = {k: len(traffic.data[k]) for k in names}
        rrs = {k: {"x-amz-storage-class": "REDUCED_REDUNDANCY"} for k in names if traffic.storage_class[k]}
        del traffic

        # 11a PUT, then attach pool 1.
        step(None, f"11a PUT into pool 0 from {threads} threads ({sum(sizes.values()) / MiB:.1f} MiB, "
                   f"{len(rrs)} REDUCED_REDUNDANCY)", lambda: client.call("put", names, rrs, threads), n)
        t = time.perf_counter()
        attached = admin("POST", "/pools/attach", {"endpoints": pool_dirs[1]})
        attach_s = time.perf_counter() - t
        status = admin("GET", "/pools/status")
        status_s = time.perf_counter() - t - attach_s
        if attached != {"pool": 1, "status": "active"} or [p["status"] for p in status["pools"]] != ["active"] * 2:
            raise AssertionError(f"11a: attach {attached}, /pools/status {[p['status'] for p in status['pools']]}")
        doc = json.loads(_read_sys(node.pools, CONFIG_FILE))
        fresh = PoolManager(node.pools)
        if not fresh.load_config() or fresh.epoch != node.poolmgr.epoch or \
                [p["endpoints"] for p in doc["pools"]] != [None, pool_dirs[1]]:
            raise AssertionError(f"11a: a fresh PoolManager over the same drives read epoch {fresh.epoch}, "
                                 f"want {node.poolmgr.epoch}; the persisted config {doc}")
        log(f"11a POST /pools/attach of pool 1 ({DRIVES} drives) in {attach_s:.2f} s, GET /pools/status in "
            f"{status_s:.2f} s: both pools active; the persisted pool config (epoch {doc['epoch']}) loads into a "
            f"fresh PoolManager")

        # 11b decommission pool 0 into pool 1.
        def decommission():
            admin("POST", "/pools/decommission", {"pool": 0})
            until(lambda: admin("GET", "/pools/status")["pools"][0]["status"] == "decommissioned",
                  "pool 0 to be decommissioned")
            return admin("GET", "/pools/status")["pools"][0]["drain"]

        drain, recs = step("pool_decommission", "11b decommission of pool 0", decommission, n)
        if drain["objects_moved"] < n or drain["objects_failed"] or drain["failed"]:
            raise AssertionError(f"11b: drain {drain}")
        if not (recs.get("encode-batch", 0) + recs.get("encode-batch-small", 0)) or not recs.get("verify-batch"):
            raise AssertionError(f"11b: the move made no encode or no verify batch: {recs}")
        left = [p for d in pool_dirs[0] for p in _xl_metas(d)]
        if left:
            raise AssertionError(f"11b: {len(left)} xl.meta of bucket bench left on pool 0, e.g. {left[:3]}")
        where = {k: _pools_holding(pool_dirs, k) for k in names}
        if any(w != {1: DRIVES} for w in where.values()):
            raise AssertionError(f"11b: objects not on pool 1's 16 drives: "
                                 f"{[(k, w) for k, w in where.items() if w != {1: DRIVES}][:4]}")
        t = time.perf_counter()
        client.call("get", names, threads)
        log(f"11b all {n} objects GET byte-exact after the drain ({n / (time.perf_counter() - t):.1f} objects/s); "
            f"no xl.meta of the bucket on pool 0, every object's xl.meta on the 16 drives of pool 1; drain {drain}")

        # 11c attach an empty pool 2 and rebalance.
        attached = admin("POST", "/pools/attach", {"endpoints": pool_dirs[2]})
        if attached != {"pool": 2, "status": "active"}:
            raise AssertionError(f"11c: attach {attached}")

        def rebalance():
            admin("POST", "/pools/rebalance", {"start": True})
            until(lambda: not admin("GET", "/pools/status")["rebalance"]["running"], "the rebalance to stop")
            return admin("GET", "/pools/status")["rebalance"]

        reb, _ = step("pool_rebalance", "11c rebalance onto the empty pool 2", rebalance, n)
        skews = node.poolmgr.rebalancer._skews()
        threshold = float(os.environ.get("MTPU_REBALANCE_SKEW", "0.10"))
        where = {k: _pools_holding(pool_dirs, k) for k in names}
        doubled = [k for k, w in where.items() if len(w) != 1 or next(iter(w.values())) != DRIVES]
        moved = [k for k, w in where.items() if 2 in w]
        counts = collections.Counter(p for w in where.values() for p in w)
        if max(skews.values()) > threshold or doubled or not moved or reb["objects_moved"] != len(moved):
            raise AssertionError(f"11c: skews {skews} (threshold {threshold}), objects on two pools or short of 16 "
                                 f"drives {doubled[:4]}, moved {len(moved)}, status {reb}")
        client.call("get", moved, threads)
        log(f"11c rebalance: {reb['objects_moved']} objects ({reb['bytes_moved'] / MiB:.1f} MiB) in {reb['rounds']} "
            f"rounds; objects by pool {dict(sorted(counts.items()))}; data-minus-capacity share by pool "
            f"{ {p: round(s, 4) for p, s in skews.items()} } within {threshold}; every moved object GETs "
            f"byte-exact, none is on two pools")

        # 11d lifecycle, an FS tier, damage, one scanner cycle. The tenant
        # that transitions is the one with the most objects past the inline
        # limit (inline ones are not transitioned); the next one expires.
        big = collections.Counter(k.split("/")[0] for k in names if sizes[k] >= 128 << 10)
        tenants = sorted({k.split("/")[0] for k in names}, key=lambda t: (-big[t], t))
        lc_transition, lc_expire = tenants[0] + "/", tenants[1] + "/"
        st, _, body = client.call("request", "PUT", "/bench", [("lifecycle", "")], None,
                                  _lifecycle_xml(lc_expire, lc_transition).encode())
        if st != 200:
            raise AssertionError(f"11d PUT ?lifecycle: {st} {body[:300]!r}")
        admin("POST", "/tiers", {"name": LC_TIER, "type": "fs", "dir": tier_dir})
        tiers = admin("GET", "/tiers")
        if [t["name"] for t in tiers] != [LC_TIER]:
            raise AssertionError(f"11d GET /tiers: {tiers}")
        expire = [k for k in names if k.startswith(lc_expire)]
        to_tier = [k for k in names if k.startswith(lc_transition)]
        inline = {k for k in to_tier if node.pools.get_object_info("bench", k).inline}
        tiered = [k for k in to_tier if k not in inline]
        candidates = [k for k in names if k not in expire and k not in to_tier and k not in rrs
                      and sizes[k] >= 128 << 10 and 1 in where[k]]
        damaged = candidates[:n_damaged]
        if len(damaged) < n_damaged or not expire or len(tiered) < n_restore:
            raise AssertionError(f"11d: {len(damaged)} objects to damage, {len(expire)} to expire, "
                                 f"{len(tiered)} to transition")
        kept = {}
        for k in damaged:
            for i in LC_DAMAGE_DRIVES:
                top = os.path.join(pool_dirs[1][i], "bench", k)
                kept[(k, i)] = _object_files(SimpleNamespace(root=pool_dirs[1][i]), k)
                shutil.rmtree(top)
        healed0 = node.scanner.objects_healed
        node.scanner.heal_sample = 1
        node.scanner._sleeper.factor = 0.0  # the throttle's idle time is not the path's work

        _, recs = step("scanner_heal", f"11d one scanner cycle over {n} objects (deep check of each, heal_sample 1)",
                       node.scanner.scan_cycle, n)
        usage = admin("GET", "/datausage")
        truth = {"objectsCount": n, "size": sum(sizes.values()), "versionsCount": n}
        if usage["bucketsUsage"].get("bench") != truth or usage["objectsCount"] != n:
            raise AssertionError(f"11d /datausage {usage}, want bench {truth} (the objects the cycle walked)")
        gone = [client.call("fetch", f"/bench/{k}", 0)[0] for k in expire]
        if gone != [404] * len(expire):
            raise AssertionError(f"11d: the expired objects answer {gone}")
        for k in to_tier:
            oi = node.pools.get_object_info("bench", k)
            on_tier = tiering_mod.is_transitioned(oi.internal)
            parts = [f for d in pool_dirs[1] + pool_dirs[2] for f in _object_files(SimpleNamespace(root=d), k)
                     if f.startswith("part.")]
            if on_tier != (k not in inline) or (on_tier and parts):
                raise AssertionError(f"11d {k}: transitioned {on_tier} (inline {k in inline}), part files {parts[:3]}")
        client.call("get", tiered, threads)
        for (k, i), files in kept.items():
            now = _object_files(SimpleNamespace(root=pool_dirs[1][i]), k)
            parts = {f: b for f, b in files.items() if f.startswith("part.")}
            if "xl.meta" not in now or {f: b for f, b in now.items() if f.startswith("part.")} != parts:
                raise AssertionError(f"11d: {k} on drive {i} was not healed byte-exact")
        healed = node.scanner.objects_healed - healed0
        if healed != n_damaged or not recs.get("reconstruct-batch"):
            raise AssertionError(f"11d: the scanner healed {healed} objects, want {n_damaged}; records {recs}")
        log(f"11d lifecycle: {lc_expire} expires, {lc_transition} transitions; /datausage bench "
            f"{usage['bucketsUsage']['bench']} equals the walked objects; {len(expire)} expired objects answer 404; {len(tiered)} transitioned to the FS tier hold no part files and GET "
            f"byte-exact through it, {len(inline)} inline ones stay; the {n_damaged} damaged objects are whole on "
            f"all 16 drives, {sum(len(v) for v in kept.values())} files byte-exact; transitions "
            f"{node.scanner.objects_transitioned}, expiries {node.scanner.objects_expired}, heals {healed}")

        # 11e restore, GET through the copy, expire the copy in a second cycle.
        restore = tiered[:n_restore]
        copies = [f"restored/bench/{k}@null" for k in restore]

        def do_restore():
            for k in restore:
                st, _, body = client.call("request", "POST", f"/bench/{k}", [("restore", "")], None,
                                          f"<RestoreRequest><Days>{LC_RESTORE_DAYS}</Days></RestoreRequest>".encode())
                if st != 202:
                    raise AssertionError(f"11e POST ?restore {k}: {st} {body[:300]!r}")

        step("tier_restore", f"11e POST ?restore of {len(restore)} transitioned objects", do_restore, len(restore))
        for c in copies:
            node.pools.pools[0].get_object_info(META_BUCKET, c)
        client.call("get", restore, threads)
        past = time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(time.time() - 86400))
        for k in restore:
            node.pools.put_object_metadata("bench", k, "", updates={
                tiering_mod.META_RESTORE: f'ongoing-request="false", expiry-date="{past}"'})
        node.scanner.heal_sample = 1 << 30
        t = time.perf_counter()
        node.scanner.scan_cycle()
        cycle2 = time.perf_counter() - t
        left = []
        for c in copies:
            try:
                node.pools.pools[0].get_object_info(META_BUCKET, c)
                left.append(c)
            except errors.ObjectError:
                pass
        usage = admin("GET", "/datausage")["bucketsUsage"].get("bench")
        live = [k for k in names if k not in expire]
        want = {"objectsCount": len(live), "size": sum(sizes[k] for k in live), "versionsCount": len(live)}
        if left or usage != want:
            raise AssertionError(f"11e: restored copies left {left}; /datausage bench {usage}, want {want}")
        client.call("get", restore, threads)
        log(f"11e the {len(restore)} restored copies GET byte-exact; a second cycle ({cycle2:.2f} s) with the "
            f"restores expired removed every copy and the objects still GET byte-exact through the tier; "
            f"/datausage bench {usage}")
    finally:
        if client is not None:
            client.close()
        stop.set()
        thread.join(10)
        node.close()
        Node.close_all()
        runtime.shutdown_data_plane()
    shutil.rmtree(base, ignore_errors=True)
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return paths


# -- phase 12: events and operations ---------------------------------------------------------

EV_TENANTS = 4  # 12a's traffic: phase 5's size law over 4 tenants
EV_RULES = (
    "<NotificationConfiguration>"
    "<QueueConfiguration><Id>created</Id><Queue>arn:minio:sqs::1:webhook</Queue><Event>s3:ObjectCreated:*</Event>"
    "<Filter><S3Key><FilterRule><Name>prefix</Name><Value>tenant-00/</Value></FilterRule></S3Key></Filter>"
    "</QueueConfiguration>"
    "<QueueConfiguration><Id>removed</Id><Queue>arn:minio:sqs::1:webhook</Queue><Event>s3:ObjectRemoved:*</Event>"
    "</QueueConfiguration></NotificationConfiguration>"
)
EV_EXPIRE = "tenant-01/"  # 12a: the lifecycle expires this tenant; no other step touches it
EV_LIFECYCLE = (
    "<LifecycleConfiguration><Rule><ID>expire</ID><Status>Enabled</Status>"
    f"<Filter><Prefix>{EV_EXPIRE}</Prefix></Filter><Expiration><Date>2020-01-01T00:00:00Z</Date></Expiration>"
    "</Rule></LifecycleConfiguration>"
)
# The codec series of /metrics and the stats() key each one renders.
CODEC_SERIES = {
    "minio_tpu_codec_blocks_encoded_total": "blocks_encoded",
    "minio_tpu_codec_encode_batches_total": "batches_run",
    "minio_tpu_codec_blocks_reconstructed_total": "blocks_reconstructed",
    "minio_tpu_codec_recon_batches_total": "recon_batches_run",
    "minio_tpu_codec_digests_verified_total": "digests_verified",
    "minio_tpu_codec_verify_batches_total": "verify_batches_run",
    "minio_tpu_codec_small_blocks_encoded_total": "small_blocks_encoded",
    "minio_tpu_codec_small_batches_total": "small_batches_run",
    "minio_tpu_codec_double_buffered_batches_total": "double_buffered_batches",
    "minio_tpu_codec_mesh_devices": "mesh_devices",
}
UPDATE_SEED = bytes(range(7, 39))  # 12b: the ed25519 seed of the release signing key the script makes


class _Receiver:
    """The webhook receiver of phase 12: an http.server on 127.0.0.1 that
    keeps every record POSTed to it; stop() closes its socket (the target
    then spools), start() listens again on the same port."""

    def __init__(self):
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}/hook"
        self.records: list = []
        self._lock = threading.Lock()
        self._httpd = self._thread = None

    def start(self) -> None:
        import http.server

        keep = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                doc = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
                with keep._lock:
                    keep.records.append(doc)
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, args=(0.1,), daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(10)
            self._httpd = None

    def take(self) -> list:
        with self._lock:
            out, self.records = self.records, []
        return out

    def wait(self, n: int, timeout: float, what: str) -> list:
        """Wait until n records have come in, then a moment more for any
        record past n (none may come), and take them all."""
        _wait_for(lambda: len(self.records) >= n, timeout, what)
        time.sleep(0.5)
        return self.take()


class _Stream:
    """A signed streaming GET made from this process (ListenNotification,
    admin /trace): a thread reads its NDJSON records until close(), which
    goes away as a client does; the server's pump must then end."""

    def __init__(self, port: int, path: str, query: list):
        import http.client
        import urllib.parse

        from minio_tpu_torch.api import auth

        h = auth.sign_request(auth.Credentials(*HTTP_CREDS), "GET", path, query, {"host": f"127.0.0.1:{port}"}, b"")
        h.pop("host")
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        self.conn.request("GET", path + ("?" + urllib.parse.urlencode(query) if query else ""), headers=h)
        self._sock = self.conn.sock  # the response keeps reading it once the connection lets go of it
        self.resp = self.conn.getresponse()
        if self.resp.status != 200:
            raise AssertionError(f"stream {path}: {self.resp.status} {self.resp.read()[:300]!r}")
        self.records: list = []
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self) -> None:
        with contextlib.suppress(Exception):  # the socket closes under the reader
            while True:
                line = self.resp.readline()
                if not line:
                    return
                if line.strip():
                    self.records.append(json.loads(line))

    def wait(self, pred, timeout: float, what: str) -> None:
        _wait_for(lambda: pred(list(self.records)), timeout, what)

    def close(self) -> None:
        import socket

        with contextlib.suppress(OSError):
            self._sock.shutdown(socket.SHUT_RDWR)
        self.conn.close()
        self._thread.join(10)
        self._sock.close()


def _signed_text(port: int, path: str, query=()) -> tuple[int, str]:
    """A signed GET from this process: (status, the whole body as text)."""
    import http.client
    import urllib.parse

    from minio_tpu_torch.api import auth

    h = auth.sign_request(auth.Credentials(*HTTP_CREDS), "GET", path, list(query), {"host": f"127.0.0.1:{port}"},
                          b"")
    h.pop("host")
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        c.request("GET", path + ("?" + urllib.parse.urlencode(list(query)) if query else ""), headers=h)
        r = c.getresponse()
        return r.status, r.read().decode()
    finally:
        c.close()


def _codec_series(text: str) -> dict:
    """{(name, labels): value} of the minio_tpu_codec_* samples of an exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith("minio_tpu_codec_"):
            name_labels, value = line.rsplit(" ", 1)
            name, _, labels = name_labels.partition("{")
            out[(name, labels.rstrip("}"))] = float(value)
    return out


def _series_of_stats(st: dict, depths: dict) -> dict:
    """The codec series that control/metrics.py renders from one stats() and
    queue_depths() read, keyed as _codec_series keys them."""
    out = {(name, ""): float(st[key]) for name, key in CODEC_SERIES.items()}
    out[("minio_tpu_codec_batch_occupancy", "")] = (
        round(st["blocks_encoded"] / st["blocks_padded"], 4) if st["blocks_padded"] else 0.0)
    for kind, key in (("encode", "host_fallback_blocks"), ("reconstruct", "host_fallback_recon_blocks"),
                      ("digest", "host_fallback_digest_chunks")):
        out[("minio_tpu_codec_host_fallback_total", f'kind="{kind}"')] = float(st[key])
    for kernel, key in (("encode", "device_encode_seconds"), ("reconstruct", "device_recon_seconds"),
                        ("verify", "device_verify_seconds")):
        out[("minio_tpu_codec_device_seconds_total", f'kernel="{kernel}"')] = round(st[key], 6)
    for chip, blocks in enumerate(st["chip_blocks"]):
        out[("minio_tpu_codec_chip_blocks_total", f'chip="{chip}"')] = float(blocks)
    for geom, depth in depths.items():
        out[("minio_tpu_codec_queue_depth", f'geometry="{geom}"')] = float(depth)
    return out


def _make_release(mirror: str) -> str:
    """A file:// release mirror signed with an ed25519 key made from
    UPDATE_SEED (control/update.py's layout: RELEASE.json, its detached
    signature, a tar.gz holding a minio_tpu_torch/ tree); returns the
    public key, base64."""
    import base64
    import io
    import tarfile

    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

    os.makedirs(mirror, exist_ok=True)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        data = b'__version__ = "0.6.0"\n'
        info = tarfile.TarInfo("minio_tpu_torch/__init__.py")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    blob = buf.getvalue()
    with open(os.path.join(mirror, "release.tar.gz"), "wb") as f:
        f.write(blob)
    manifest = json.dumps({"version": "0.6.0", "sha256": hashlib.sha256(blob).hexdigest(),
                           "archive": "release.tar.gz"}).encode()
    key = Ed25519PrivateKey.from_private_bytes(UPDATE_SEED)
    with open(os.path.join(mirror, "RELEASE.json"), "wb") as f:
        f.write(manifest)
    with open(os.path.join(mirror, "RELEASE.json.sig"), "wb") as f:
        f.write(key.sign(manifest))
    return base64.b64encode(key.public_key().public_bytes_raw()).decode()


def phase_events_ops(smi: str, root: str, tally: Tally, device: str = "cuda", n_put: int = 64, n_spool: int = 16,
                     n_trace: int = 8, max_size: int = 4 * MiB, threads: int = HTTP_THREADS, seed: int = 120,
                     st_size: int = MiB, st_ramp: dict | None = None) -> dict:
    """Phase 12: bucket events and the operations plane through a port Node
    in this process over one 16-drive pool (no codec=: the process's probe
    verdict), served over HTTP, with a webhook target enabled through the
    notify_webhook config its build reads; all traffic is signed S3 and
    admin from phase 6's client process, the streams are read here. 12a
    (path events_put): the notification rules, a ListenNotification stream,
    n_put PUTs over 4 tenants, 4 copies, a 3-part multipart upload, 8
    DELETEs and a bulk delete of 8; the receiver gets exactly the matching
    records, each with its object's HEAD, and the stream every
    ObjectCreated. Then the receiver stops, n_spool PUTs wait in the spool on
    the first drive, and all arrive once each when it is back; a lifecycle
    and one scanner cycle deliver one ObjectRemoved:Expired per expired
    object. 12b: the object speedtest at 1 MiB with the default ramp (path
    selftest_object; the scratch bucket left empty), the legacy autotune
    (path speedtest_legacy), the drive probe at 4 MiB, /metrics held
    against the codec's stats(), /timeseries, /healthinfo, /bandwidth,
    /kms/status, a /trace stream around n_trace PUTs, a flight dump read
    back, and a signed file:// release staged by POST /update. Returns the
    kernel counts of its three paths. (st_size and st_ramp shrink the
    speedtests for a rehearsal on the CPU: st_ramp is the object speedtest's
    concurrency and max_concurrency, and turns the legacy one into its
    one-object serial mode.)"""
    from minio_tpu_torch import __version__, cli, runtime
    from minio_tpu_torch.control.flight import GLOBAL_FLIGHT
    from minio_tpu_torch.control.perf import GLOBAL_PERF
    from minio_tpu_torch.control.selftest import SCRATCH_BUCKET
    from minio_tpu_torch.dist.node import Node
    from minio_tpu_torch.storage.format import SYS_DIR

    t_phase = time.perf_counter()
    paths: dict = {}
    base = os.path.join(root, "events")
    dirs = [os.path.join(base, _drive_name(i)) for i in range(DRIVES)]
    rcv = _Receiver()
    rcv.start()
    env = {"MINIO_TPU_NOTIFY_WEBHOOK_ENABLE": "on", "MINIO_TPU_NOTIFY_WEBHOOK_ENDPOINT": rcv.url}
    saved = {k: os.environ.get(k) for k in (*env, "MINIO_TPU_UPDATE_PUBKEY")}
    os.environ.update(env)
    node = Node(dirs, root_user=HTTP_CREDS[0], root_password=HTTP_CREDS[1], device=device)
    app = node.make_app()
    stop = threading.Event()
    port = _free_port()
    thread, errs = cli._run_app_until(app, "127.0.0.1", port, stop)
    if errs:
        raise AssertionError(f"12: the app did not start: {errs}")
    client = None
    streams: list = []
    target = None
    try:
        t = time.perf_counter()
        node.build()
        for k in env:
            os.environ.pop(k)
        codec = node.codec
        if type(codec).__name__ != "BatchingDeviceCodec" or codec.device.type != device:
            raise AssertionError(f"12: the node serves {type(codec).__name__} on {getattr(codec, 'device', '?')}")
        if list(node.notifier.targets) != ["webhook"] or node.notify_target_errors:
            raise AssertionError(f"12: targets {list(node.notifier.targets)}, errors {node.notify_target_errors}")
        target = node.notifier.targets["webhook"]
        log(f"12 node boot in {time.perf_counter() - t:.2f} s: {type(codec).__name__} on {codec.device}; the "
            f"webhook target from the notify_webhook config, spooling under the first drive")
        client = HttpClient(f"http://127.0.0.1:{port}")

        def admin(method: str, path: str, doc=None, query=()) -> dict:
            st, out = client.call("admin", method, f"{ADMIN_PREFIX}{path}", query, doc)
            if st != 200:
                raise AssertionError(f"12 admin {method} {path}: {st} {out}")
            return out

        def request(method: str, path: str, query=(), headers=None, body=b"", want: int = 200) -> tuple:
            st, h, out = client.call("request", method, path, query, headers, body)
            if st != want:
                raise AssertionError(f"12 {method} {path}: {st}, want {want}: {out[:300]!r}")
            return h, out

        def step(path: str | None, label: str, fn, n: int, need=("rs_gf_apply", "hh256")):
            """One step with every count zeroed just before it; prints its wall
            time, objects/s, codec records and kernel launches after it."""
            tally.reset()
            GLOBAL_PERF.ledger.reset()
            t0 = time.perf_counter()
            res = fn()
            wall = time.perf_counter() - t0
            counts = tally.read(path or label, need)
            _no_host_fallback(codec, path or label)
            recs = _codec_ledger()
            if path is not None:
                paths[path] = counts
            log(f"12 {label}: {wall:.2f} s, {n} objects, {n / wall:.1f} objects/s; codec records "
                f"{json.dumps(recs)}; launches {json.dumps(counts['launches'])} [{smi}]")
            return res, recs

        # 12a: the rules, a listen stream, the traffic.
        request("PUT", "/bench")
        request("PUT", "/bench", [("notification", "")], None, EV_RULES.encode())
        listen = _Stream(port, "/bench", [("events", "s3:ObjectCreated:*")])
        streams.append(listen)
        n = client.call("register", seed, n_put, max_size, "ev", EV_TENANTS)
        traffic = Traffic(seed, n, max_size, "ev", EV_TENANTS)
        names = traffic.names
        rrs = {k: {"x-amz-storage-class": "REDUCED_REDUNDANCY"} for k in names if traffic.storage_class[k]}
        tenant = {k: k.split("/")[0] + "/" for k in names}
        others = [k for k in names if tenant[k] not in ("tenant-00/", EV_EXPIRE)]
        sources = sorted(others, key=lambda k: len(traffic.data[k]))[-4:]  # the biggest: copies past the inline limit
        copies = [(src, f"{('tenant-00/', 'tenant-03/')[i % 2]}copies/copy-{i}") for i, src in enumerate(sources)]
        doomed = [k for k in others if k not in sources][:16]
        singles, bulk = doomed[:8], doomed[8:]
        mp_name = "tenant-00/mp/upload-0"
        client.call("register_bytes", mp_name, seed + 1, 11 * MiB)
        created = names + [dst for _, dst in copies] + [mp_name]
        heads: dict = {}

        def traffic_12a():
            client.call("put", names, rrs, threads)
            for src, dst in copies:
                request("PUT", f"/bench/{dst}", (), {"x-amz-copy-source": f"/bench/{src}"})
            client.call("multipart", mp_name, 5 * MiB, 3)
            for k in created:
                h, _ = request("HEAD", f"/bench/{k}")
                heads[k] = (int(h["content-length"]), h["etag"].strip('"'), h.get("x-amz-version-id", ""))
            for k in singles:
                request("DELETE", f"/bench/{k}", want=204)
            client.call("delete", bulk)

        step("events_put", f"12a events traffic: {n} PUTs over {EV_TENANTS} tenants, {len(copies)} copies, a 3-part "
                           f"multipart upload, {len(singles)} DELETEs and a bulk delete of {len(bulk)}",
             traffic_12a, n + len(copies) + 1 + len(doomed))
        want = collections.Counter([("s3:ObjectCreated:Put", f"bench/{k}") for k in names if k.startswith("tenant-00/")]
                                   + [("s3:ObjectCreated:Copy", f"bench/{d}") for _, d in copies
                                      if d.startswith("tenant-00/")]
                                   + [("s3:ObjectCreated:CompleteMultipartUpload", f"bench/{mp_name}")]
                                   + [("s3:ObjectRemoved:Delete", f"bench/{k}") for k in doomed])
        t = time.perf_counter()
        got = rcv.wait(sum(want.values()), 60, "the webhook records of 12a")
        deliver_s = time.perf_counter() - t
        if collections.Counter((r["EventName"], r["Key"]) for r in got) != want:
            raise AssertionError(f"12a: the receiver got {collections.Counter((r['EventName'], r['Key']) for r in got)}"
                                 f", want {want}")
        for r in got:
            obj = r["Records"][0]["s3"]["object"]
            if r["EventName"].startswith("s3:ObjectCreated:") and \
                    (obj["size"], obj["eTag"], obj["versionId"]) != heads[obj["key"]]:
                raise AssertionError(f"12a: the record of {obj['key']} says {obj}, its HEAD {heads[obj['key']]}")
        listen.wait(lambda recs: len(recs) >= len(created), 60, "the listen stream's ObjectCreated records")
        seen = collections.Counter(r["Key"] for r in listen.records)
        if seen != collections.Counter(f"bench/{k}" for k in created):
            raise AssertionError(f"12a: the listen stream saw {seen}")
        listen.close()
        streams.remove(listen)
        log(f"12a the receiver got exactly the {sum(want.values())} matching records "
            f"({json.dumps(dict(collections.Counter(e for e, _ in want)))}), each created record with its "
            f"object's HEAD size, ETag and version id, all in within {deliver_s:.2f} s of the last request; the "
            f"listen stream got all {len(created)} ObjectCreated records")

        # 12a the spool: the receiver stops, PUTs spool on the first drive.
        rcv.stop()
        spool = os.path.join(dirs[0], SYS_DIR, "notify-spool", "webhook")
        m = client.call("register", seed + 2, n_spool, max_size, "spool", 1)
        spooled = Traffic(seed + 2, m, max_size, "spool", 1).names
        client.call("put", spooled, {}, threads)
        files = [f for f in os.listdir(spool) if f.endswith(".json")]
        if target.queue.pending() != m or len(files) != m:
            raise AssertionError(f"12a: with the receiver down {target.queue.pending()} records pending and "
                                 f"{len(files)} spool files, want {m}")
        t = time.perf_counter()
        rcv.start()
        got = rcv.wait(m, 60, "the spooled records")
        redeliver_s = time.perf_counter() - t
        keys = collections.Counter(r["Key"] for r in got)
        if keys != collections.Counter(f"bench/{k}" for k in spooled) or os.listdir(spool) or target.queue.pending():
            raise AssertionError(f"12a: after the restart the receiver got {keys}; spool left {os.listdir(spool)}")
        log(f"12a the receiver down: {m} PUTs left {m} records pending and {m} spool files under the first drive; "
            f"back up, all {m} arrived once each in {redeliver_s:.2f} s and the spool is empty")

        # 12a expiry: one scanner cycle delivers ObjectRemoved:Expired.
        request("PUT", "/bench", [("lifecycle", "")], None, EV_LIFECYCLE.encode())
        expired = [k for k in names if tenant[k] == EV_EXPIRE]
        node.scanner._sleeper.factor = 0.0  # the throttle's idle time is not the cycle's work
        t = time.perf_counter()
        node.scanner.scan_cycle()
        cycle_s = time.perf_counter() - t
        got = rcv.wait(len(expired), 60, "the expiry records")
        if sorted((r["EventName"], r["Key"]) for r in got) != sorted(
                ("s3:ObjectRemoved:Expired", f"bench/{k}") for k in expired):
            raise AssertionError(f"12a: the cycle delivered {[(r['EventName'], r['Key']) for r in got]}, want one "
                                 f"s3:ObjectRemoved:Expired for each of {expired}")
        log(f"12a a lifecycle expiring {EV_EXPIRE} and one scanner cycle ({cycle_s:.2f} s): one "
            f"s3:ObjectRemoved:Expired record for each of the {len(expired)} expired objects")

        # 12b operations: the speedtests, /metrics against the codec's stats().
        _, before = _signed_text(port, f"{ADMIN_PREFIX}/metrics")
        before = _codec_series(before)
        ledger: collections.Counter = collections.Counter()
        report, recs = step("selftest_object", f"12b POST /speedtest/object ({st_size >> 10} KiB objects, "
                                               f"ramp {json.dumps(st_ramp) if st_ramp else 'the default'})",
                            lambda: admin("POST", "/speedtest/object", {"size": st_size, **(st_ramp or {})}), 0)
        ledger.update(recs)
        if not report["ok"] or len(report["nodes"]) != 1 or report["size"] != st_size:
            raise AssertionError(f"12b /speedtest/object: {report}")
        left = [d for d in dirs if os.path.exists(os.path.join(d, SCRATCH_BUCKET))]
        if left:
            raise AssertionError(f"12b: the scratch bucket {SCRATCH_BUCKET} is left on {left}")
        agg = report["aggregate"]
        log(f"12b object speedtest: best concurrency {report['concurrency']}, PUT {agg['put_gibs']} GiB/s "
            f"{agg['put_ops_per_s']} ops/s, GET {agg['get_gibs']} GiB/s {agg['get_ops_per_s']} ops/s; ramp "
            f"{json.dumps(report['ramp'])}; the scratch bucket is gone from every drive [{smi}]")
        legacy, recs = step("speedtest_legacy", f"12b POST /speedtest (the legacy autotune, {st_size >> 10} KiB)",
                            lambda: admin("POST", "/speedtest", {"size": st_size, **({"count": 1} if st_ramp else {})}),
                            0)
        ledger.update(recs)
        if not legacy["putSpeedBytesPerSec"] or not legacy["getSpeedBytesPerSec"]:
            raise AssertionError(f"12b /speedtest: {legacy}")
        log(f"12b legacy speedtest: PUT {legacy['putSpeedBytesPerSec'] / 2**30:.4f} GiB/s, GET "
            f"{legacy['getSpeedBytesPerSec'] / 2**30:.4f} GiB/s at concurrency {legacy.get('concurrency', 1)}; ramp "
            f"{json.dumps([r['concurrency'] for r in legacy.get('ramp', [])])} [{smi}]")
        st, text = _signed_text(port, f"{ADMIN_PREFIX}/metrics")
        stats = codec.stats()
        depths = codec.queue_depths()
        after = _codec_series(text)
        want_series = _series_of_stats(stats, depths)
        if st != 200 or after != want_series:
            diff = {k: (after.get(k), want_series.get(k)) for k in set(after) | set(want_series)
                    if after.get(k) != want_series.get(k)}
            raise AssertionError(f"12b /metrics ({st}): codec series against stats(): {diff}")
        grew = {k: after[(k, "")] - before.get((k, ""), 0.0) for k in (
            "minio_tpu_codec_encode_batches_total", "minio_tpu_codec_small_batches_total",
            "minio_tpu_codec_verify_batches_total", "minio_tpu_codec_recon_batches_total")}
        if grew["minio_tpu_codec_encode_batches_total"] != ledger["encode-batch"] or \
                grew["minio_tpu_codec_small_batches_total"] != ledger["encode-batch-small"] or \
                not ledger["verify-batch"] or grew["minio_tpu_codec_verify_batches_total"] < ledger["verify-batch"] or \
                grew["minio_tpu_codec_recon_batches_total"] < ledger["reconstruct-batch"]:
            raise AssertionError(f"12b: /metrics grew {grew} over the speedtests, their records {dict(ledger)}")
        if "minio_tpu_device_probe_recovery_interval_seconds" in text or "minio_tpu_flight_armed" not in text:
            raise AssertionError("12b /metrics: a series the port does not render, or the flight series missing")
        log(f"12b GET /metrics: all {len(after)} minio_tpu_codec_* samples equal the codec's stats() read just after; "
            f"over the two speedtests the batch counters grew {json.dumps(grew)}, their codec records "
            f"{json.dumps(dict(ledger))}; {len(text.splitlines())} lines")
        drive = admin("POST", "/speedtest/drive", {"size": 4 * MiB})
        net = admin("POST", "/speedtest/net", {"size": MiB, "rounds": 1})
        last = {k: admin("GET", f"/speedtest/{k}") for k in ("object", "drive", "net")}
        if not drive["ok"] or sorted(drive["drives"]) != sorted(node.local_drives) or last["drive"] != drive or \
                last["object"] != report or last["net"] != net:
            raise AssertionError(f"12b /speedtest/drive {drive}; the GETs of the last results differ")
        rates = [r["seq_write_bytes_per_s"] for r in drive["drives"].values()]
        log(f"12b drive probe at 4 MiB on the 16 drives: sequential write {min(rates) / MiB:.0f}-"
            f"{max(rates) / MiB:.0f} MiB/s; GET /speedtest/{{object,drive,net}} return the last results")
        ts = admin("GET", "/timeseries")
        health = admin("GET", "/healthinfo")
        bw = admin("GET", "/bandwidth")
        st, kms = client.call("admin", "GET", f"{ADMIN_PREFIX}/kms/status")
        if not ts["node"]["series"] or len(health["drives"]) != DRIVES or \
                any(d["state"] != "ok" for d in health["drives"]) or bw != {} or \
                (st, node.kms is not None) not in ((200, True), (501, False)):
            raise AssertionError(f"12b: /timeseries {len(ts['node']['series'])} seconds, /healthinfo "
                                 f"{len(health['drives'])} drives, /bandwidth {bw}, /kms/status {st} {kms}")
        log(f"12b /timeseries {len(ts['node']['series'])} seconds, /healthinfo {len(health['drives'])} drives ok "
            f"(cpu {health['cpu'].get('model', '?')}), /bandwidth {bw}, /kms/status {st} {kms}")

        # /trace around n_trace PUTs.
        trace = _Stream(port, f"{ADMIN_PREFIX}/trace", [])
        streams.append(trace)
        k = client.call("register", seed + 3, n_trace, MiB, "trace", EV_TENANTS)
        traced = Traffic(seed + 3, k, MiB, "trace", EV_TENANTS).names
        client.call("put", traced, {}, threads)
        want_paths = {f"/bench/{x}" for x in traced}

        def traced_puts(recs):
            return {r["path"] for r in recs if r.get("type") == "http" and r.get("method") == "PUT"
                    and r.get("status") == 200 and r.get("path") in want_paths} == want_paths

        trace.wait(traced_puts, 30, "the traced PUTs")
        recs = list(trace.records)
        ids = {r["request_id"] for r in recs if r.get("type") == "http" and r.get("path") in want_paths}
        trees = [_trace_tree(recs, rid) for rid in ids]
        trace.close()
        streams.remove(trace)
        log(f"12b a /trace stream around {k} PUTs: {len(recs)} records, one http record and one span tree per PUT "
            f"(roots {sorted({t['root'] for t in trees})}, {sum(t['spans'] for t in trees)} spans)")

        # The flight recorder and update.
        dump = admin("POST", "/flight/dump", {"note": "chip smoke phase 12"})
        incident = dump["incident"]["incident"]
        listing = admin("GET", "/flight")
        ids = [b["id"] for b in listing["bundles"] if b["incident"] == incident]
        if len(ids) != 1:
            raise AssertionError(f"12b GET /flight: {listing['bundles']}, want one bundle of {incident}")
        bundle = admin("GET", f"/flight/{ids[0]}")
        if bundle["incident"] != incident or bundle["reason"] != "manual" or "spans" not in bundle:
            raise AssertionError(f"12b GET /flight/{ids[0]}: {sorted(bundle)}")
        log(f"12b POST /flight/dump, GET /flight lists {ids[0]}, GET /flight/{{id}} returns it: "
            f"{len(bundle['spans'])} spans, {len(bundle['timeseries']['series'])} seconds of ops")
        mirror, stage = os.path.join(base, "mirror"), os.path.join(base, "stage")
        os.environ["MINIO_TPU_UPDATE_PUBKEY"] = _make_release(mirror)
        init = os.path.join(os.path.dirname(os.path.abspath(__file__)), "minio_tpu_torch", "__init__.py")
        before_init = _read(init)
        up = admin("POST", "/update", None, [("url", f"file://{mirror}"), ("stage-dir", stage)])
        status = admin("GET", "/update")
        if up["available"] != "0.6.0" or not os.path.isfile(os.path.join(up["staged"], "minio_tpu_torch",
                                                                          "__init__.py")) \
                or _read(init) != before_init or status["version"] != __version__ or not status["pubkey_configured"]:
            raise AssertionError(f"12b POST /update {up}; GET /update {status}")
        log(f"12b POST /update of a signed file:// release: 0.6.0 staged under {os.path.relpath(up['staged'], base)}, "
            f"not applied (the running tree unchanged); GET /update {json.dumps(status)}")
    finally:
        for s in streams:
            s.close()
        if client is not None:
            client.close()
        stop.set()
        thread.join(10)
        node.close()
        Node.close_all()
        runtime.shutdown_data_plane()
        rcv.stop()
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    if target is not None and target.queue._thread.is_alive():
        raise AssertionError("12: the webhook target's sender thread outlived the node")
    if GLOBAL_FLIGHT.fanout is not None or (GLOBAL_FLIGHT._thread is not None and GLOBAL_FLIGHT._thread.is_alive()):
        raise AssertionError("12: the flight recorder is still armed after the node closed")
    shutil.rmtree(base, ignore_errors=True)
    log(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return paths


# -- phase 13: replication and identity between two deployments ----------------------------

RP_RULE = (
    "<Rule><ID>{rid}</ID><Status>Enabled</Status><Priority>1</Priority>"
    "<DeleteMarkerReplication><Status>Enabled</Status></DeleteMarkerReplication>"
    "<DeleteReplication><Status>Enabled</Status></DeleteReplication>{extra}"
    "<Filter><Prefix></Prefix></Filter><Destination><Bucket>{arn}</Bucket></Destination></Rule>"
)
RP_EXISTING = "<ExistingObjectReplication><Status>Enabled</Status></ExistingObjectReplication>"
RP_VERSIONING = (b'<VersioningConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
                 b"<Status>Enabled</Status></VersioningConfiguration>")
RP_LDAP_DN = "uid=alice,ou=people,dc=example,dc=org"
RP_USERS = {"a": ("site-user-a", "site-user-a-secret"), "b": ("site-user-b", "site-user-b-secret")}
RP_POLICY = {"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:GetObject", "s3:PutObject"], "Resource": ["arn:aws:s3:::from-b/*"]}]}


def _remove_bucket_parts(drive_dir: str, bucket: str, name: str) -> int:
    removed = 0
    for dirpath, _, files in os.walk(os.path.join(drive_dir, bucket, name)):
        for f in files:
            if f.startswith("part."):
                os.remove(os.path.join(dirpath, f))
                removed += 1
    return removed


def phase_replication(smi: str, root: str, tally: Tally, device: str = "cuda", n_objects: int = 64,
                      big_mib: int = 64, max_size: int = 4 * MiB, threads: int = HTTP_THREADS, seed: int = 130,
                      bw_limit: int = MiB, bw_objects: int = 18, bw_size: int = MiB, n_resync: int = 16,
                      resync_size: int = MiB, n_site: int = 32, sts_size: int = MiB) -> dict:
    """Phase 13: bucket and site replication between two 16-drive 12+4
    deployments, STS and the console. Site A is a port Node in this process
    (no codec=: the process's probe verdict) served over HTTP; site B is
    `python3 -m minio_tpu_torch server` over its own 16 drives, with its own
    probe and codec on the card. Requests come signed from phase 6's client
    process (node 0 = A, node 1 = B). 13a (path replication_put): a target
    on A for B's versioned bucket and a rule with delete and delete-marker
    replication; n_objects of phase 5's law and one big_mib object PUT on A
    replicate to B byte-exact with the source's version ids, REPLICA on B
    and COMPLETED on A; a delete marker and a version delete reach B; the
    status and ?replication-metrics read pending 0; then a second target
    with a bandwidth limit of bw_limit and bw_objects of bw_size: /bandwidth
    reports the limit, the drain takes no less than the limit allows past
    the token bucket's one-second burst (unthrottled it takes a fraction of
    that), and the rate /bandwidth observes is at most 1.1x the limit. 13b (path
    replication_resync): n_resync objects lose the part files of 4 of A's
    drives, and PUT ?replication-reset to a third bucket on B under an
    ExistingObjectReplication rule lands every one byte-exact through A's
    RS reconstruct. 13c (path site_replication): both sites' buckets
    emptied through S3, a bucket seeded on A, POST /site-replication/add; buckets, a
    policy, users, a service account and an LDAP policy mapping mirror,
    n_site objects PUT
    on B replicate to A with one version each and no ping-pong, a bucket
    deleted on A leaves B. 13d (path sts_put_get): AssumeRole on A signed by
    the user made on B; its credentials PUT and GET on A and are refused
    outside the user's policy; the console's login, bucket list and a bucket
    created through it that appears on B. Then B gets SIGTERM and exits 0
    within 30 s, its log naming replication and site replication closed.
    Returns the kernel counts of A's four paths; B's kernels stand as its
    codec series, before and after."""
    from minio_tpu_torch import cli, runtime
    from minio_tpu_torch.control.perf import GLOBAL_PERF
    from minio_tpu_torch.dist.node import Node

    t_phase = time.perf_counter()
    paths: dict = {}
    base = os.path.join(root, "repl")
    dirs_a = [os.path.join(base, "a", _drive_name(i)) for i in range(DRIVES)]
    port_a, port_b = _free_port(), _free_port()
    url_a, url_b = f"http://127.0.0.1:{port_a}", f"http://127.0.0.1:{port_b}"
    t = time.perf_counter()
    site_b = CliServer([os.path.join(base, "b", "drive{00...15}"), "--url", url_b]
                       + (["--device", "cpu"] if device == "cpu" else []), port_b)
    node = Node(dirs_a, url=url_a, root_user=HTTP_CREDS[0], root_password=HTTP_CREDS[1], device=device)
    stop = threading.Event()
    thread, errs = cli._run_app_until(node.make_app(), "127.0.0.1", port_a, stop)
    if errs:
        raise AssertionError(f"13: site A's app did not start: {errs}")
    client = None
    b_stopped = False
    try:
        node.build()
        a_ready = time.perf_counter() - t
        b_online, b_line = site_b.online()
        codec = node.codec
        if type(codec).__name__ != "BatchingDeviceCodec" or codec.device.type != device:
            raise AssertionError(f"13: site A serves {type(codec).__name__} on {getattr(codec, 'device', '?')}")
        want_probe = "PROBE_OK gpu" if device == "cuda" else None
        if b_line.get("codec") != "BatchingDeviceCodec" or b_line.get("drives") != DRIVES or \
                (want_probe and not str(b_line.get("probe", "")).startswith(want_probe)):
            raise AssertionError(f"13: site B's online line {b_line}")
        log(f"13 sites up: A in this process in {a_ready:.2f} s ({type(codec).__name__} on {codec.device}), B "
            f"online {b_online:.2f} s after its spawn ({b_line.get('probe', 'no probe')})")
        client = HttpClient(url_a, (url_b,))

        def admin(method: str, path: str, doc=None, query=(), node_i: int = 0, want: int = 200):
            st, out = client.call("admin", method, f"{ADMIN_PREFIX}{path}", query, doc, node_i)
            if st != want:
                raise AssertionError(f"13 admin {method} {path} on {'AB'[node_i]}: {st} {out}")
            return out

        def request(method: str, path: str, query=(), headers=None, body=b"", node_i: int = 0, want: int = 200,
                    sign: bool = True) -> tuple:
            st, h, out = client.call("request", method, path, query, headers, body, sign, False, node_i)
            if st != want:
                raise AssertionError(f"13 {method} {path} on {'AB'[node_i]}: {st}, want {want}: {out[:300]!r}")
            return h, out

        def versioned_bucket(bucket: str, node_i: int) -> None:
            request("PUT", f"/{bucket}", node_i=node_i)
            request("PUT", f"/{bucket}", [("versioning", "")], None, RP_VERSIONING, node_i=node_i)

        def target(bucket: str, target_bucket: str, rid: str, extra: str = "", bandwidth: int = 0) -> str:
            arn = admin("POST", "/replication/target", {
                "bucket": bucket, "endpoint": url_b, "targetBucket": target_bucket, "accessKey": HTTP_CREDS[0],
                "secretKey": HTTP_CREDS[1], "bandwidth": bandwidth})["arn"]
            xml = ('<ReplicationConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/"><Role></Role>'
                   + RP_RULE.format(rid=rid, extra=extra, arn=arn) + "</ReplicationConfiguration>")
            request("PUT", f"/{bucket}", [("replication", "")], None, xml.encode())
            return arn

        def drained(node_i: int, timeout: float = 300.0) -> dict:
            """Poll /replication/status until nothing is pending."""
            last: dict = {}

            def done():
                last.update(admin("GET", "/replication/status", node_i=node_i))
                return last["pending"] == 0
            _wait_for(done, timeout, f"site {'AB'[node_i]}'s replication to drain")
            return dict(last)

        def b_codec() -> dict:
            st, text = _signed_text(port_b, f"{ADMIN_PREFIX}/metrics")
            if st != 200:
                raise AssertionError(f"13 B /metrics: {st}")
            return _codec_series(text)

        def begin() -> float:
            tally.reset()
            GLOBAL_PERF.ledger.reset()
            return time.perf_counter()

        def end(path: str, need=("rs_gf_apply", "hh256")) -> dict:
            counts = tally.read(path, need)
            _no_host_fallback(codec, path)
            paths[path] = counts
            return counts

        b_before = b_codec()

        # 13a: bucket replication A -> B.
        for node_i in (0, 1):
            versioned_bucket("repl", node_i)
        arn = target("repl", "repl", "to-b")
        n = client.call("register", seed, n_objects, max_size, "repl")
        traffic = Traffic(seed, n, max_size, "repl")
        big = "big/object-64mib"
        client.call("register_bytes", big, seed + 1, big_mib * MiB)
        names = traffic.names + [big]
        rrs = {k: {"x-amz-storage-class": "REDUCED_REDUNDANCY"} for k in traffic.names if traffic.storage_class[k]}
        nbytes = sum(len(traffic.data[k]) for k in traffic.names) + big_mib * MiB
        t0 = begin()
        client.call("put", traffic.names, rrs, threads, None, "repl")
        client.call("put", [big], {}, 1, None, "repl")
        t_acked = time.perf_counter()
        status = drained(0)
        t_done = time.perf_counter()
        counts = end("replication_put")
        recs = _codec_ledger()
        got = client.call("get", names, threads, {k: 1 for k in names}, "repl")
        heads_a = client.call("heads", "repl", names, 0, threads)
        heads_b = client.call("heads", "repl", names, 1, threads)
        bad = [k for k in names if heads_a[k][0] != 200 or heads_b[k][0] != 200
               or heads_b[k][1]["x-amz-version-id"] != heads_a[k][1]["x-amz-version-id"]
               or not heads_a[k][1]["x-amz-version-id"]
               or heads_a[k][1]["x-amz-replication-status"] != "COMPLETED"
               or heads_b[k][1]["x-amz-replication-status"] != "REPLICA"]
        if bad:
            raise AssertionError(f"13a: {len(bad)} replicas differ, e.g. {bad[0]}: A {heads_a[bad[0]]} "
                                 f"B {heads_b[bad[0]]}")
        from email.utils import parsedate_to_datetime

        lag = [(parsedate_to_datetime(heads_b[k][1]["last-modified"])
                - parsedate_to_datetime(heads_a[k][1]["last-modified"])).total_seconds() for k in names]
        if min(lag) < 0:
            raise AssertionError(f"13a: a replica's mtime is before its source's ({min(lag)} s)")
        if status["completed"] < len(names) or status["failed"]:
            raise AssertionError(f"13a /replication/status {status}")
        log(f"13a {len(names)} objects ({nbytes / MiB:.1f} MiB, {len(rrs)} REDUCED_REDUNDANCY and one "
            f"{big_mib} MiB) PUT on A in {t_acked - t0:.2f} s; replication pending 0 {t_done - t_acked:.2f} s after "
            f"the last acknowledged PUT: {len(names) / (t_done - t0):.1f} objects/s, "
            f"{nbytes / MiB / (t_done - t0):.1f} MiB/s from the first PUT; every replica on B byte-exact "
            f"({got['wall']:.2f} s), with its source's version id, REPLICA on B and COMPLETED on A; each replica's "
            f"mtime is B's write time, {min(lag):.0f}-{max(lag):.0f} s after its source's (neither package's "
            f"front reads x-minio-source-mtime); A's codec records {json.dumps(recs)}; launches "
            f"{json.dumps(counts['launches'])}; /replication/status {json.dumps(status)} [{smi}]")
        marked, vdel = traffic.names[0], traffic.names[1]
        h, _ = request("DELETE", f"/repl/{marked}", want=204)
        if h.get("x-amz-delete-marker") != "true":
            raise AssertionError(f"13a: DELETE {marked} made no delete marker: {h}")
        vid = heads_a[vdel][1]["x-amz-version-id"]
        request("DELETE", f"/repl/{vdel}", [("versionId", vid)], want=204)
        drained(0)
        request("GET", f"/repl/{marked}", node_i=1, want=404)
        request("GET", f"/repl/{vdel}", [("versionId", vid)], node_i=1, want=404)
        listed = client.call("versions", "repl", 1)
        markers = [(k, v) for k, v, dm in listed if dm]
        if [k for k, _ in markers] != [marked] or any(k == vdel for k, _, _ in listed):
            raise AssertionError(f"13a: B's versions hold markers {markers} and {vdel} "
                                 f"{[x for x in listed if x[0] == vdel]}")
        _, body = request("GET", "/repl", [("replication-metrics", "")])
        rmetrics = json.loads(body)
        status = admin("GET", "/replication/status")
        if rmetrics["pending"] or status["pending"]:
            raise AssertionError(f"13a: ?replication-metrics {rmetrics}, /replication/status {status}")
        log(f"13a the delete marker of {marked} and the version delete of {vdel} reached B (its listing: one marker, "
            f"no version of {vdel}); ?replication-metrics {json.dumps(rmetrics)}")

        # 13a the bandwidth limit.
        for node_i in (0, 1):
            versioned_bucket("replbw", node_i)
        bw_arn = target("replbw", "replbw", "bw", bandwidth=bw_limit)
        bw_names = [f"bw/object-{i:02d}" for i in range(bw_objects)]
        for i, k in enumerate(bw_names):
            client.call("register_bytes", k, seed + 100 + i, bw_size)
        t0 = time.perf_counter()
        out = client.call("put", bw_names, {}, threads, None, "replbw")
        t_first_ack = t0 + min(out["latencies"])
        drained(0)
        t_done = time.perf_counter()
        report = admin("GET", "/bandwidth", None, [("bucket", "replbw")])["replbw"][bw_arn]
        sent = bw_objects * bw_size
        burst = bw_limit  # the token bucket holds one second of the limit
        # The token bucket, made at the first replica, lets at most burst +
        # limit x t through in t seconds, so the drain takes at least
        # (sent - burst) / limit; unthrottled it takes a fraction of that.
        drain, floor = t_done - t_first_ack, (sent - burst) / bw_limit
        observed = report["currentBandwidthInBytesPerSecond"]
        if report["limitInBytesPerSecond"] != bw_limit or drain < 0.9 * floor or observed > 1.1 * bw_limit:
            raise AssertionError(f"13a /bandwidth {report}: {sent / MiB:g} MiB drained {drain:.2f} s after the first "
                                 f"acknowledged PUT, the limit of {bw_limit / MiB:g} MiB/s allows no less than "
                                 f"{floor:.2f} s; observed {observed / bw_limit:.3f}x the limit")
        client.call("get", bw_names, threads, {k: 1 for k in bw_names}, "replbw")
        log(f"13a a target limited to {bw_limit / MiB:g} MiB/s: {sent / MiB:g} MiB in {bw_objects} objects "
            f"replicated {drain:.2f} s after the first acknowledged PUT (the limit allows no less than {floor:.2f} s "
            f"past its one-second burst), {(sent - burst) / MiB / drain:.3f} MiB/s past the burst; /bandwidth "
            f"reports limit {report['limitInBytesPerSecond']} B/s, observed {observed / MiB:.3f} MiB/s "
            f"({observed / bw_limit:.3f}x the limit); replicas byte-exact")

        # 13b: a resync through a degraded source.
        versioned_bucket("resync", 0)
        versioned_bucket("replica3", 1)
        rs_names = [f"resync/object-{i:02d}" for i in range(n_resync)]
        for i, k in enumerate(rs_names):
            client.call("register_bytes", k, seed + 200 + i, resync_size + 37 * i)
        client.call("put", rs_names, {}, threads, None, "resync")
        removed = sum(_remove_bucket_parts(dirs_a[i], "resync", k) for i in (1, 6, 11, 14) for k in rs_names)
        target("resync", "replica3", "existing", RP_EXISTING)
        t0 = begin()
        _, body = request("PUT", "/resync", [("replication-reset", "")])
        queued = json.loads(body)["queued"]
        drained(0)
        wall = time.perf_counter() - t0
        counts = end("replication_resync")
        recs = _codec_ledger()
        client.call("get", rs_names, threads, {k: 1 for k in rs_names}, "replica3")
        if queued != n_resync or not recs.get("reconstruct-batch"):
            raise AssertionError(f"13b: {queued} queued, codec records {recs}")
        log(f"13b {n_resync} objects with {removed} part files gone from 4 of A's drives: PUT ?replication-reset "
            f"queued {queued}, all on B's third bucket byte-exact in {wall:.2f} s; A's codec records "
            f"{json.dumps(recs)}; launches {json.dumps(counts['launches'])} [{smi}]")

        # 13c: site replication.
        # A site joins empty, and the join seeds only the bucket made for it:
        # the buckets of 13a and 13b go through S3 on both sites (every
        # version, then the bucket, whose delete takes its targets with it).
        # A's replication rules go first, so its deletes are not replicated.
        t0 = time.perf_counter()
        marks: dict = {}

        def mark(label: str) -> None:
            marks[label] = round(time.perf_counter() - t0, 2)

        for b in ("repl", "replbw", "resync"):
            request("DELETE", f"/{b}", [("replication", "")], want=204)
        emptied = {f"A/{b}": client.call("empty_bucket", b, 0) for b in ("repl", "replbw", "resync")}
        emptied.update({f"B/{b}": client.call("empty_bucket", b, 1) for b in ("repl", "replbw", "replica3")})
        mark("emptied")
        seeded = [f"seed/object-{i}" for i in range(4)]
        for i, k in enumerate(seeded):
            client.call("register_bytes", k, seed + 300 + i, 200_000 + i)
        request("PUT", "/seeded")
        client.call("put", seeded, {}, 4, None, "seeded")
        begin()
        joined = admin("POST", "/site-replication/add", {"sites": [
            {"name": "site-a", "endpoint": url_a, "access_key": HTTP_CREDS[0], "secret_key": HTTP_CREDS[1]},
            {"name": "site-b", "endpoint": url_b, "access_key": HTTP_CREDS[0], "secret_key": HTTP_CREDS[1]}]})
        mark("joined")
        request("HEAD", "/seeded", node_i=1)
        drained(0)
        client.call("get", seeded, 4, {k: 1 for k in seeded}, "seeded")
        mark("seeded on B")
        request("PUT", "/from-b", node_i=1)
        request("HEAD", "/from-b")
        admin("PUT", "/policies/site-rw", RP_POLICY)
        ak_a, sk_a = RP_USERS["a"]
        admin("POST", "/users", {"accessKey": ak_a, "secretKey": sk_a, "policies": ["site-rw"]})
        sa = admin("POST", "/service-accounts", {"parent": ak_a})
        admin("PUT", "/idp/ldap/policy", {"dn": RP_LDAP_DN, "policies": ["site-rw"]})
        ak_b, sk_b = RP_USERS["b"]
        admin("POST", "/users", {"accessKey": ak_b, "secretKey": sk_b, "policies": ["site-rw"]}, node_i=1)
        users_b, users_a = admin("GET", "/users", node_i=1), admin("GET", "/users")
        if "site-rw" not in admin("GET", "/policies", node_i=1) or \
                users_b.get(ak_a, {}).get("policies") != ["site-rw"] or sa["accessKey"] not in users_b or \
                admin("GET", "/idp/ldap/policy", node_i=1).get(RP_LDAP_DN) != ["site-rw"] or \
                users_a.get(ak_b, {}).get("policies") != ["site-rw"]:
            raise AssertionError(f"13c: IAM on B {users_b}, on A {users_a}")
        mark("IAM mirrored")
        m = client.call("register", seed + 400, n_site, max_size, "site")
        site_names = Traffic(seed + 400, m, max_size, "site").names
        client.call("put", site_names, {}, threads, {k: 1 for k in site_names}, "from-b")
        mark("PUT on B")
        drained(1)
        mark("B drained")
        drained(0)
        drained(1)  # nothing came back
        client.call("get", site_names, threads, None, "from-b")
        heads_a = client.call("heads", "from-b", site_names, 0, threads)
        per_site = [collections.Counter(k for k, _, _ in client.call("versions", "from-b", i)) for i in (0, 1)]
        bad = [k for k in site_names if heads_a[k][1]["x-amz-replication-status"] != "REPLICA"
               or per_site[0][k] != 1 or per_site[1][k] != 1]
        if bad:
            raise AssertionError(f"13c: {bad[0]} on A {heads_a[bad[0]]}, versions A {per_site[0][bad[0]]} "
                                 f"B {per_site[1][bad[0]]}")
        mark("objects checked")
        request("PUT", "/shortlived")
        request("HEAD", "/shortlived", node_i=1)
        request("DELETE", "/shortlived", want=204)
        request("HEAD", "/shortlived", node_i=1, want=404)
        info = admin("GET", "/site-replication/info")
        if not info["enabled"] or sorted((s["name"], s["self"], s.get("online", True)) for s in info["sites"]) != \
                [("site-a", True, True), ("site-b", False, True)]:
            raise AssertionError(f"13c /site-replication/info {info}")
        counts = end("site_replication")
        recs = _codec_ledger()
        log(f"13c both sites emptied through S3 ({json.dumps(emptied)} versions deleted), a bucket of "
            f"{len(seeded)} objects made on "
            f"A, POST /site-replication/add: {json.dumps(joined['synced'])}; seeded to B byte-exact; a bucket made "
            f"on B is on A, one deleted on A leaves B; policy site-rw, user {ak_a}, service account "
            f"{sa['accessKey']} and the LDAP mapping of {RP_LDAP_DN} made on A are on B, user {ak_b} made on B "
            f"is on A; {m} objects PUT on B are on A byte-exact, REPLICA on A, one version of each on each site; "
            f"/site-replication/info lists both online; {time.perf_counter() - t0:.2f} s (seconds at each step: "
            f"{json.dumps(marks)}); A's codec records "
            f"{json.dumps(recs)}; launches {json.dumps(counts['launches'])} [{smi}]")

        # 13d: STS from replicated IAM, and the console.
        t0 = begin()
        form = b"Action=AssumeRole&Version=2011-06-15&DurationSeconds=900"
        st, answer = client.call("request_as", ak_b, sk_b, "POST", "/", form,
                                 {"content-type": "application/x-www-form-urlencoded"}, 0, True)
        if st != 200:
            raise AssertionError(f"13d AssumeRole as {ak_b}: {st} {answer[:300]!r}")
        xml = ET.fromstring(answer)
        temp = (xml.findtext(".//{*}AccessKeyId"), xml.findtext(".//{*}SecretAccessKey"))
        obj = "sts/object"
        data = np.random.default_rng(seed + 500).bytes(sts_size + 37)
        st_put, _ = client.call("request_as", *temp, "PUT", f"/from-b/{obj}", data)
        st_get, digest = client.call("request_as", *temp, "GET", f"/from-b/{obj}")
        st_out, _ = client.call("request_as", *temp, "PUT", "/seeded/outside", b"denied")
        st_list, _ = client.call("request_as", *temp, "GET", "/")
        if (st_put, st_get, digest, st_out, st_list) != (200, 200, hashlib.sha256(data).hexdigest(), 403, 403):
            raise AssertionError(f"13d temporary credentials: PUT {st_put}, GET {st_get} (sha256 match "
                                 f"{digest == hashlib.sha256(data).hexdigest()}), outside PUT {st_out}, "
                                 f"ListBuckets {st_list}")
        counts = end("sts_put_get")
        wall = time.perf_counter() - t0
        login = json.dumps({"accessKey": HTTP_CREDS[0], "secretKey": HTTP_CREDS[1]}).encode()
        _, body = request("POST", "/mtpu/console/api/login", (), {"content-type": "application/json"}, login,
                          sign=False)
        token = json.loads(body)["token"]
        bearer = {"authorization": f"Bearer {token}"}
        _, body = request("GET", "/mtpu/console/api/buckets", (), bearer, sign=False)
        console_buckets = sorted(b["name"] for b in json.loads(body)["buckets"])
        _, body = request("GET", "/")
        s3_buckets = sorted(e.findtext("{*}Name") for e in ET.fromstring(body).iter() if e.tag.endswith("}Bucket"))
        request("POST", "/mtpu/console/api/buckets", (), {**bearer, "content-type": "application/json"},
                json.dumps({"name": "console-made"}).encode(), sign=False)
        request("HEAD", "/console-made", node_i=1)
        if console_buckets != s3_buckets or token.count(".") != 2:
            raise AssertionError(f"13d console buckets {console_buckets}, S3 {s3_buckets}")
        drained(0)
        drained(1)
        log(f"13d AssumeRole on A signed by {ak_b} (made on B, on A by site replication): its temporary "
            f"credentials PUT and GET {len(data)} bytes on A byte-exact and are refused outside site-rw (PUT to "
            f"another bucket 403, ListBuckets 403) in {wall:.2f} s; launches {json.dumps(counts['launches'])}; "
            f"console login gave a Bearer JWT, /api/buckets lists what S3 lists ({console_buckets}), and a bucket "
            f"the console made on A is on B")

        b_after = b_codec()
        grew = {name: b_after.get((name, ""), 0.0) - b_before.get((name, ""), 0.0) for name in (
            "minio_tpu_codec_encode_batches_total", "minio_tpu_codec_small_batches_total",
            "minio_tpu_codec_verify_batches_total", "minio_tpu_codec_recon_batches_total")}
        fallback = {k: v for k, v in b_after.items() if k[0] == "minio_tpu_codec_host_fallback_total" and v}
        if not (grew["minio_tpu_codec_encode_batches_total"] + grew["minio_tpu_codec_small_batches_total"]) \
                or not grew["minio_tpu_codec_verify_batches_total"] or fallback:
            raise AssertionError(f"13: B's codec grew {grew}, host fallback {fallback}")
        log(f"13 site B's minio_tpu_codec_* over the phase: before {json.dumps({k[0]: v for k, v in b_before.items() if not k[1]})}; "
            f"after {json.dumps({k[0]: v for k, v in b_after.items() if not k[1]})}; grew {json.dumps(grew)} "
            f"(an encode batch launches both kernels, a verify batch the hash); host fallback none")
        rc, secs = site_b.stop(timeout=30.0)
        b_stopped = True
        text = site_b.text()
        if rc != 0 or '"msg": "replication closed"' not in text or '"msg": "site replication closed"' not in text:
            raise AssertionError(f"13: site B exited {rc} after {secs:.2f} s; its log's end:\n{text[-2000:]}")
        log(f"13 site B: SIGTERM, exit 0 in {secs:.2f} s; its log shows replication and site replication closed")
    finally:
        if client is not None:
            client.close()
        if not b_stopped:
            with contextlib.suppress(Exception):
                site_b.stop(timeout=30.0)
        stop.set()
        thread.join(10)
        node.close()
        Node.close_all()
        runtime.shutdown_data_plane()
    left = [t.name for t in threading.enumerate() if t.name.startswith(("repl-", "site-repl"))]
    if left:
        raise AssertionError(f"13: threads of site A's replication outlived its node: {left}")
    shutil.rmtree(base, ignore_errors=True)
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return paths


# -- phase 14: the workload harness on the card ------------------------------------------------

# The scenario phases of phase 14, by scenario, and the kernel-count path of
# each (the prepopulation is one too); the kernels each path must launch.
LOADGEN_PATHS = {
    "smoke": {"prepopulate": "loadgen_smoke_prepopulate", "smoke": "loadgen_smoke"},
    "hot_get_storm": {"prepopulate": "hot_get_prepopulate", "sweep_cold": "hot_get_sweep_cold",
                      "storm_hot": "hot_get_storm_hot"},
}
LOADGEN_NEED = {"hot_get_sweep_cold": ("hh256",), "hot_get_storm_hot": ()}


@contextlib.contextmanager
def _env(values: dict):
    """Set `values` in os.environ where the caller's environment does not set
    them (as the loadgen tool does with a spec's env), and restore after."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        os.environ.setdefault(k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_loadgen(smi: str, root: str, codec, tally: Tally, kernels: dict,
                  scenarios: tuple = ("smoke", "hot_get_storm")) -> dict:
    """Phase 14: scenarios/smoke.yaml and scenarios/hot_get_storm.yaml, as
    they are, through the port's loadgen (ScenarioRunner, S3Target signing
    with api/auth.py, InProcessAdmin) against its InProcessCluster, every
    node serving the script's codec on the card. The kernel counts are zeroed
    before each scenario's prepopulation and each of its phases, and read
    after (no host codec, no plain version): both kernels launch in each
    prepopulation and in the smoke phase, hh256 in sweep_cold, and storm_hot
    launches fewer hh256 per GET than sweep_cold. The reports' SLO rows,
    acked-object loss and cache_slo (hit ratio >= 0.8 in storm_hot) hold;
    compare (storm_hot >= 3x sweep_cold GET ops/s) is printed, as a
    finding when it misses; and each phase's op_sequence_sha256 is the one
    its scenario regenerates.
    Prints each phase's ops/s, p50 and p99 by op, the hit ratios, the
    hashes, and the launches of each path with the device time they take at
    phase 2's times. Returns the kernel counts by path."""
    from minio_tpu_torch.dist.node import Node
    from minio_tpu_torch.loadgen import generate_ops, load_scenario, op_sequence_hash
    from minio_tpu_torch.loadgen.cluster import InProcessCluster
    from minio_tpu_torch.loadgen.runner import ScenarioRunner
    from minio_tpu_torch.loadgen.target import InProcessAdmin, S3Target
    from minio_tpu_torch.tools.loadgen import verdict_failures

    t_phase = time.perf_counter()
    if codec._stop.is_set():
        raise AssertionError("14: the script's codec was closed by an earlier phase")
    scen_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenarios")
    paths: dict = {}
    walls: dict = {}
    threads_before = set(threading.enumerate())

    class Runner(ScenarioRunner):
        """The scenario's runner with the kernel counts zeroed before the
        prepopulation and each phase, and read after each."""

        def __init__(self, scenario, target, admin, names: dict):
            super().__init__(scenario, target, admin, log=lambda m: log(f"14 {scenario.name}: {m}"))
            self.names = names

        def _counted(self, key: str, run):
            path = self.names[key]
            tally.reset()
            t = time.perf_counter()
            out = run()
            walls[path] = time.perf_counter() - t
            paths[path] = tally.read(path, need=LOADGEN_NEED.get(path, ("rs_gf_apply", "hh256")))
            _no_host_fallback(codec, path)
            return out

        def prepopulate(self):
            return self._counted("prepopulate", super(Runner, self).prepopulate)

        def _run_phase(self, phase):
            return self._counted(phase.name, lambda: super(Runner, self)._run_phase(phase))

    reports = {}
    for name in scenarios:
        sc = load_scenario(os.path.join(scen_dir, f"{name}.yaml"))
        with _env({**sc.env, "MTPU_TRACE_SAMPLE": "0.1"}):
            t = time.perf_counter()
            cluster = InProcessCluster(os.path.join(root, "loadgen", name), sc.nodes, sc.drives_per_node,
                                       pools=sc.pools, codec=codec)
            try:
                build_s = time.perf_counter() - t
                served = {type(n.codec).__name__ + " on " + str(n.codec.device) for n in cluster.nodes}
                if any(n.codec is not codec for n in cluster.nodes):
                    raise AssertionError(f"14 {name}: a node serves another codec than the script's: {served}")
                tiers = [n.memcache.cfg.limit_bytes >> 20 if n.memcache is not None else 0 for n in cluster.nodes]
                want_mb = int(sc.env.get("MTPU_MEMCACHE_MB", "0"))
                if tiers != [want_mb] * len(cluster.nodes):
                    raise AssertionError(f"14 {name}: memcache MiB by node {tiers}, the scenario asks {want_mb}")
                log(f"14 {name}: {sc.nodes} nodes x {sc.drives_per_node} drives built in {build_s:.2f} s, "
                    f"serving {served.pop()}; memcache MiB by node {tiers}; env {sc.env}")
                target = S3Target(cluster.urls, cluster.root_user, cluster.root_password)
                report = Runner(sc, target, InProcessAdmin(cluster), LOADGEN_PATHS[name]).run()
            finally:
                cluster.stop()
        reports[name] = report
        pre = LOADGEN_PATHS[name]["prepopulate"]
        log(f"14 {name}: prepopulated {sc.prepopulate} objects in {walls[pre]:.3f} s "
            f"({sc.prepopulate / walls[pre]:.1f} objects/s) [{smi}]")
        for ph in sc.phases:
            row = report["phases"][ph.name]
            regen = op_sequence_hash(generate_ops(sc, ph, ph.ops))
            if row["op_sequence_sha256"] != regen:
                raise AssertionError(f"14 {name}/{ph.name}: op_sequence_sha256 {row['op_sequence_sha256']}, "
                                     f"the scenario regenerates {regen}")
            by_op = "; ".join(f"{op} {r['ops_per_s']:.1f} ops/s p50 {r.get('p50_ms', 0.0):.3f} ms "
                              f"p99 {r.get('p99_ms', 0.0):.3f} ms ({r['ok']} ok, errors {r['errors']})"
                              for op, r in row["ops"].items())
            cache = row.get("cache") or {}
            log(f"14 {name}/{ph.name}: {row['executed']} ops in {row['wall_s']:.3f} s; {by_op}"
                + (f"; memcache hit ratio {cache['hit_ratio']} ({cache['hits']} hits, {cache['misses']} misses, "
                   f"{cache['fills']} fills, {cache['singleflight_waits']} singleflight waits)" if cache else "")
                + f"; op_sequence_sha256 {row['op_sequence_sha256']} [{smi}]")
        for key, path in LOADGEN_PATHS[name].items():
            counts = paths[path]
            dev_ms = _device_ms(counts, kernels)
            log(f"14 {path}: launches {json.dumps(counts['launches'])}; launches by shape class "
                f"{json.dumps(_shape_summary(counts))}; device time estimated from them {dev_ms / 1e3:.4f} s of "
                f"{walls[path]:.3f} s wall ({100 * dev_ms / 1e3 / walls[path]:.2f}%)")
        verdicts = {k: report.get(k) for k in ("slo", "acked_object_loss", "cache_slo", "compare") if k in report}
        log(f"14 {name} verdicts: {json.dumps(verdicts, sort_keys=True)}")
        # The compare block is a throughput ratio of two phases on a host
        # whose cores the client threads and both nodes share, not a check of
        # what the store answered: a ratio under its floor is printed as a
        # finding. Every other verdict must hold.
        cmp = report.get("compare")
        for block in cmp if isinstance(cmp, list) else [cmp] if isinstance(cmp, dict) else []:
            if not block["reproduced"]:
                log(f"14 {name} FINDING: {block['a']} moved {block['ratio']}x {block['b']}'s {block['op']} "
                    f"{block['metric']} ({block['value_a']} / {block['value_b']}), under the scenario's "
                    f"{block['min_ratio']}x [{smi}]")
        failed = verdict_failures({k: v for k, v in report.items() if k != "compare"})
        if failed:
            raise AssertionError(f"14 {name}: verdicts failed on the card: {failed}")
    if "hot_get_storm" in reports:
        per_get = {}
        for ph in ("sweep_cold", "storm_hot"):
            gets = reports["hot_get_storm"]["phases"][ph]["executed"]
            per_get[ph] = paths[LOADGEN_PATHS["hot_get_storm"][ph]]["launches"]["hh256"] / gets
        log(f"14 hot_get_storm: hh256 launches per GET {json.dumps(per_get)}")
        if not per_get["storm_hot"] < per_get["sweep_cold"]:
            raise AssertionError(f"14: storm_hot launches no fewer hh256 per GET than sweep_cold: {per_get}")
    # The process-wide planes the nodes' builds started stop with the last
    # node (the profiler, the flight recorder, the trace bridges).
    Node.close_all()
    # What may outlive the phase: the process-wide drive I/O pools and lock
    # refresh daemon, and the script's codec's batcher threads.
    shared = ("drive-io", "lock-refresh", "encode-batch-")
    deadline = time.monotonic() + 10.0
    while True:
        left = [t for t in threading.enumerate()
                if t not in threads_before and t.is_alive() and not t.name.startswith(shared)]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    if left:
        raise AssertionError(f"14: threads started by the phase outlived it: {sorted(t.name for t in left)}")
    shutil.rmtree(os.path.join(root, "loadgen"), ignore_errors=True)
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return paths


# -- phase 15: SelectObjectContent, the FS server and the gateways -----------------------------

SEL_REGIONS = ("us-east-1", "us-west-2", "eu-west-1", "ap-south-1", "sa-east-1")
SEL_STATUSES = ("200", "200", "200", "200", "304", "404", "500", "503")
SEL_HEADER = "id,region,status,bytes,latency_ms,path"
SEL_ROW_BYTES = 58  # the mean width of one access-log row below
SEL_OFFLINE = (0, 5, 10, 15)  # the drives 15a takes offline for its degraded Select


def _access_log(seed: int, nbytes: int) -> tuple[bytes, dict]:
    """A CSV access log of about `nbytes` from a numpy generator, and its
    columns: id,region,status,bytes,latency_ms,path (58 bytes a row)."""
    n = max(1, nbytes // SEL_ROW_BYTES)
    rng = np.random.default_rng(seed)
    cols = {
        "id": np.arange(n),
        "region": rng.integers(0, len(SEL_REGIONS), n),
        "status": rng.integers(0, len(SEL_STATUSES), n),
        "bytes": rng.integers(0, 1 << 23, n),
        "latency_cs": rng.integers(0, 100_000, n),
        "tenant": rng.integers(0, TENANTS, n),
        "obj": rng.integers(0, 100_000, n),
    }
    rows = [f"{i},{SEL_REGIONS[r]},{SEL_STATUSES[s]},{b},{c // 100}.{c % 100:02d},/v1/tenant-{t:02d}/o-{o:05d}"
            for i, r, s, b, c, t, o in zip(*(cols[k].tolist() for k in cols))]
    return ("\n".join([SEL_HEADER, *rows]) + "\n").encode(), cols


def _access_json(seed: int, nbytes: int) -> tuple[bytes, dict]:
    """The same log as JSON lines, about `nbytes`."""
    n = max(1, nbytes // 118)
    rng = np.random.default_rng(seed)
    cols = {"region": rng.integers(0, len(SEL_REGIONS), n), "status": rng.integers(0, len(SEL_STATUSES), n),
            "bytes": rng.integers(0, 1 << 23, n), "latency_cs": rng.integers(0, 100_000, n)}
    rows = [json.dumps({"id": i, "region": SEL_REGIONS[r], "status": SEL_STATUSES[s], "bytes": b,
                        "latency_ms": c / 100, "path": f"/v1/tenant-{i % TENANTS:02d}/o-{i:07d}"})
            for i, (r, s, b, c) in enumerate(zip(*(cols[k].tolist() for k in cols)))]
    return ("\n".join(rows) + "\n").encode(), cols


def _thrift_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _thrift_zigzag(n: int) -> bytes:
    return _thrift_varint((n << 1) ^ (n >> 63) if n < 0 else n << 1)


def _snappy_compress_literal(data: bytes) -> bytes:
    """Minimal valid snappy stream: one literal."""
    out = bytearray(_thrift_varint(len(data)))
    if not data:
        return bytes(out)
    length = len(data) - 1
    if length < 60:
        out.append(length << 2)
    else:
        extra = (length.bit_length() + 7) // 8
        out.append((59 + extra) << 2)
        out += length.to_bytes(extra, "little")
    return bytes(out + data)


class _ThriftWriter:
    """Tiny thrift compact writer for the structs the parquet reader parses."""

    def __init__(self):
        self.buf = bytearray()
        self.last_id = [0]

    def field(self, fid: int, ctype: int):
        delta = fid - self.last_id[-1]
        if 0 < delta < 16:
            self.buf.append((delta << 4) | ctype)
        else:
            self.buf.append(ctype)
            self.buf += _thrift_zigzag(fid)
        self.last_id[-1] = fid

    def i32(self, fid: int, v: int):
        self.field(fid, 5)
        self.buf += _thrift_zigzag(v)

    def i64(self, fid: int, v: int):
        self.field(fid, 6)
        self.buf += _thrift_zigzag(v)

    def binary(self, fid: int, v: bytes):
        self.field(fid, 8)
        self.buf += _thrift_varint(len(v)) + v

    def start_struct(self, fid: int):
        self.field(fid, 12)
        self.last_id.append(0)

    def end_struct(self):
        self.buf.append(0)
        self.last_id.pop()

    def start_list(self, fid: int, elem: int, size: int):
        self.field(fid, 9)
        if size < 15:
            self.buf.append((size << 4) | elem)
        else:
            self.buf.append(0xF0 | elem)
            self.buf += _thrift_varint(size)

    def stop(self):
        self.buf.append(0)
        return bytes(self.buf)


def _write_simple_parquet(int_col, str_col) -> bytes:
    """One row group, two required columns (INT64 'n', UTF8 's'), PLAIN,
    snappy pages (the writer of tests/test_parquet.py)."""
    from minio_tpu_torch.s3select import parquet as pq

    n = len(int_col)
    blob = bytearray(pq.MAGIC)

    def page(col_vals, ptype):
        if ptype == pq.INT64:
            body = struct.pack(f"<{n}q", *col_vals)
        else:
            body = b"".join(struct.pack("<i", len(v.encode())) + v.encode() for v in col_vals)
        comp = _snappy_compress_literal(body)
        w = _ThriftWriter()
        w.i32(1, pq.PAGE_DATA)
        w.i32(2, len(body))
        w.i32(3, len(comp))
        w.start_struct(5)  # DataPageHeader
        w.i32(1, n)
        w.i32(2, pq.ENC_PLAIN)
        w.i32(3, pq.ENC_RLE)
        w.i32(4, pq.ENC_RLE)
        w.end_struct()
        return w.stop() + comp

    offsets = []
    for vals, ptype in ((int_col, pq.INT64), (str_col, pq.BYTE_ARRAY)):
        offsets.append(len(blob))
        blob += page(vals, ptype)

    def schema_el(name, ptype=None, conv=None):
        w = _ThriftWriter()
        if ptype is not None:
            w.i32(1, ptype)
            w.i32(3, 0)  # required
        w.binary(4, name.encode())
        if ptype is None:
            w.i32(5, 2)  # num_children on root
        if conv is not None:
            w.i32(6, conv)
        return w.stop()

    fmd = _ThriftWriter()
    fmd.i32(1, 1)  # version
    fmd.start_list(2, 12, 3)
    for el in (schema_el("root"), schema_el("n", pq.INT64), schema_el("s", pq.BYTE_ARRAY, conv=0)):
        fmd.buf += el
    fmd.i64(3, n)  # num_rows
    fmd.start_list(4, 12, 1)
    rg = _ThriftWriter()
    rg.start_list(1, 12, 2)  # columns
    for off, (ptype, name) in zip(offsets, ((pq.INT64, b"n"), (pq.BYTE_ARRAY, b"s"))):
        cc = _ThriftWriter()
        cc.start_struct(3)  # meta_data
        cc.i32(1, ptype)
        cc.start_list(3, 8, 1)  # path_in_schema
        cc.buf += _thrift_varint(len(name)) + name
        cc.i32(4, pq.CODEC_SNAPPY)
        cc.i64(5, n)
        cc.i64(7, 0)
        cc.i64(9, off)  # data_page_offset
        cc.end_struct()
        rg.buf += cc.stop()
    rg.i64(2, 0)
    rg.i64(3, n)
    fmd.buf += rg.stop()
    meta = fmd.stop()
    blob += meta
    blob += struct.pack("<I", len(meta)) + pq.MAGIC
    return bytes(blob)


def _select_xml(expression: str, input_xml: str, output_xml: str = "<CSV/>") -> bytes:
    from xml.sax.saxutils import escape

    return (f"<SelectObjectContentRequest><Expression>{escape(expression)}</Expression>"
            f"<ExpressionType>SQL</ExpressionType><InputSerialization>{input_xml}</InputSerialization>"
            f"<OutputSerialization>{output_xml}</OutputSerialization></SelectObjectContentRequest>").encode()


def _records(frames: bytes) -> tuple[bytes, list]:
    """The Records payload of an event stream and the kinds of its messages."""
    from minio_tpu_torch.s3select import decode_messages

    msgs = list(decode_messages(frames))
    kinds = [m["headers"].get(":event-type") or m["headers"].get(":error-code") for m in msgs]
    return b"".join(m["payload"] for m in msgs if m["headers"].get(":event-type") == "Records"), kinds


def phase_select(smi: str, root: str, codec, tally: Tally, device: str = "cuda", csv_mib: int = 16,
                 gz_mib: int = 16, json_mib: int = 8, parquet_rows: int = 120_000, n_gateway: int = 16,
                 fs_mib: int = 2) -> dict:
    """Phase 15: SelectObjectContent (s3select/), the one-drive FS server
    (object/fs.py) and the NAS and S3 gateways (object/gateway.py) on the
    card. 15a: a port Node in this process over 16 drives at parity 4 on the
    script's codec, served over HTTP; a csv_mib access log Selected healthy
    (an aggregate, a projection with a float WHERE) and with 4 drives
    offline (the aggregate again), a gzip CSV of gz_mib, json_mib of JSON
    lines and a Parquet object of parquet_rows rows, each held against numpy
    and against an in-process run_select over the original bytes. 15b:
    `python -m minio_tpu_torch server <one dir>` (the FS backend) driven
    with a bucket, PUTs, GETs, a listing, a 3-part multipart upload and a
    Select, then SIGTERM. 15c: `gateway s3` in front of 15a's node (n_gateway
    1 MiB PUTs, GETs through it and directly, a Select through it) and
    `gateway nas` (a PUT, a GET, a listing). The kernel counts are zeroed
    before each node path and read after: hh256 on every Select, rs_gf_apply
    too on the degraded one and on the PUTs. Returns the counts by path."""
    import gzip

    from minio_tpu_torch import cli
    from minio_tpu_torch.dist.node import Node
    from minio_tpu_torch.s3select import S3SelectRequest, run_select

    t_phase = time.perf_counter()
    paths: dict = {}
    base = os.path.join(root, "select")
    dirs = [os.path.join(base, "node", _drive_name(i)) for i in range(DRIVES)]
    port, fs_port, gw_port, nas_port = (_free_port() for _ in range(4))
    endpoint = f"http://127.0.0.1:{port}"
    node = Node(dirs, root_user=HTTP_CREDS[0], root_password=HTTP_CREDS[1], parity=M, codec=codec, device=device)
    stop = threading.Event()
    thread, errs = cli._run_app_until(node.make_app(), "127.0.0.1", port, stop)
    if errs:
        raise AssertionError(f"15: the node's app did not start: {errs}")
    # The three servers boot while 15a runs; none builds a codec.
    children = {
        "fs": CliServer([os.path.join(base, "fs1")], fs_port),
        "gateway-s3": CliServer(["s3", endpoint], gw_port, command="gateway"),
        "gateway-nas": CliServer(["nas", os.path.join(base, "nas")], nas_port, command="gateway"),
    }
    client = None
    try:
        node.build()
        if node.codec is not codec:
            raise AssertionError(f"15: the node serves {type(node.codec).__name__}, not the script's codec")
        client = HttpClient(endpoint, tuple(f"http://127.0.0.1:{p}" for p in (fs_port, gw_port, nas_port)))
        fs_node, gw_node, nas_node = 1, 2, 3

        def counted(path: str, fn, need=("rs_gf_apply", "hh256")):
            tally.reset()
            t0 = time.perf_counter()
            out = fn()
            wall = time.perf_counter() - t0
            paths[path] = tally.read(path, need)
            _no_host_fallback(codec, path)
            return out, wall

        # -- 15a: the objects, PUT into a 12+4 set ---------------------------------------------------
        t = time.perf_counter()
        csv, cols = _access_log(150, csv_mib * MiB)
        gz_plain, gz_cols = _access_log(151, gz_mib * MiB)
        gz = gzip.compress(gz_plain, compresslevel=6, mtime=0)
        jsl, js_cols = _access_json(152, json_mib * MiB)
        pq_rng = np.random.default_rng(153)
        pq_n = pq_rng.integers(0, 1 << 23, parquet_rows)
        pq_s = pq_rng.integers(0, len(SEL_REGIONS), parquet_rows)
        parquet = _write_simple_parquet(pq_n.tolist(), [SEL_REGIONS[i] for i in pq_s.tolist()])
        objects = {"access.csv": csv, "access.csv.gz": gz, "access.json": jsl, "access.parquet": parquet}
        log(f"15a data made in {time.perf_counter() - t:.2f} s: CSV {len(csv)} bytes ({len(cols['id'])} rows, "
            f"{len(csv) / len(cols['id']):.1f} bytes a row), gzip CSV {len(gz)} bytes ({len(gz_plain)} before "
            f"compression), JSON lines {len(jsl)} bytes ({len(js_cols['bytes'])} rows), Parquet {len(parquet)} "
            f"bytes ({parquet_rows} rows, snappy)")
        for name, data in objects.items():
            client.call("register_blob", name, data)
        if client.call("request", "PUT", "/sel")[0] != 200:
            raise AssertionError("15a: PUT /sel")
        res, wall = counted("select_put", lambda: client.call("put", list(objects), {}, 4, None, "sel"))
        log(f"15a select_put: {len(objects)} objects, {res['bytes']} bytes in {wall:.3f} s "
            f"({res['bytes'] / wall / 1e6:.1f} MB/s) [{smi}]")

        use = "<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>"
        agg = "SELECT count(*), sum(cast(s.bytes as int)) FROM S3Object s WHERE s.status = '500'"
        proj = "SELECT s.id, s.path FROM S3Object s WHERE cast(s.latency_ms as float) > 900.0"

        def status_500(c: dict) -> str:
            hit = np.asarray(SEL_STATUSES)[c["status"]] == "500"
            return f"{int(hit.sum())},{int(c['bytes'][hit].sum())}\n"

        hit = cols["latency_cs"] > 90_000
        proj_want = "".join(f"{i},/v1/tenant-{t:02d}/o-{o:05d}\n" for i, t, o in zip(
            cols["id"][hit].tolist(), cols["tenant"][hit].tolist(), cols["obj"][hit].tolist()))
        eu = pq_s == SEL_REGIONS.index("eu-west-1")
        js_eu = js_cols["region"] == SEL_REGIONS.index("eu-west-1")
        queries = {
            # path: (key, expression, input, output, numpy's Records payload)
            "select_csv_aggregate": ("access.csv", agg, use, "<CSV/>", status_500(cols)),
            "select_csv_projection": ("access.csv", proj, use, "<CSV/>", proj_want),
            "select_csv_degraded": ("access.csv", agg, use, "<CSV/>", status_500(cols)),
            "select_gzip_csv": ("access.csv.gz", agg, f"<CompressionType>GZIP</CompressionType>{use}", "<CSV/>",
                                status_500(gz_cols)),
            "select_json_lines": ("access.json", "SELECT count(*), sum(s.bytes) FROM S3Object s "
                                  "WHERE s.region = 'eu-west-1'", "<JSON><Type>LINES</Type></JSON>", "<CSV/>",
                                  f"{int(js_eu.sum())},{int(js_cols['bytes'][js_eu].sum())}\n"),
            "select_parquet": ("access.parquet", "SELECT count(*), sum(s.n) FROM S3Object s WHERE s.s = 'eu-west-1'",
                               "<Parquet/>", "<CSV/>", f"{int(eu.sum())},{int(pq_n[eu].sum())}\n"),
        }
        answers: dict = {}
        reference: dict = {}
        eo = node.pools.pools[0].sets[0]
        for path, (key, expression, input_xml, output_xml, want) in queries.items():
            body = _select_xml(expression, input_xml, output_xml)
            offline = {}
            if path == "select_csv_degraded":
                offline = {i: eo.disks[i] for i in SEL_OFFLINE}
                for i in SEL_OFFLINE:
                    eo.disks[i] = None
            try:
                need = ("rs_gf_apply", "hh256") if offline else ("hh256",)
                (st, frames, dt), wall = counted(path, lambda: client.call("select", f"/sel/{key}", body), need)
            finally:
                for i, d in offline.items():
                    eo.disks[i] = d
            if st != 200:
                raise AssertionError(f"15a {path}: status {st}: {frames[:300]!r}")
            payload, kinds = _records(frames)
            if kinds[-2:] != ["Stats", "End"] or payload.decode() != want:
                raise AssertionError(f"15a {path}: messages {kinds}, Records {payload[:200]!r}, numpy says "
                                     f"{want[:200]!r}")
            ref_key = (key, expression)
            if ref_key not in reference:
                t = time.perf_counter()
                reference[ref_key] = b"".join(run_select(S3SelectRequest.from_xml(body),
                                                         lambda _o, _n, _d=objects[key]: _d))
                ref_s = time.perf_counter() - t
            else:
                ref_s = None
            if frames != reference[ref_key]:
                raise AssertionError(f"15a {path}: the event stream differs from run_select's over the "
                                     f"original bytes ({len(frames)} and {len(reference[ref_key])} bytes)")
            answers[path] = frames
            counts = paths[path]["launches"]
            size = len(objects[key])
            log(f"15a {path}: {key} ({size} bytes{', drives ' + str(list(SEL_OFFLINE)) + ' offline' if offline else ''})"
                f" in {dt:.3f} s at the client, {size / dt / 1e6:.2f} MB/s; Records {len(payload)} bytes equal "
                f"numpy's; the event stream equals run_select's"
                + (f" (in-process run_select {ref_s:.3f} s, {size / ref_s / 1e6:.2f} MB/s)" if ref_s else "")
                + f"; launches hh256 {counts['hh256']}, rs_gf_apply {counts['rs_gf_apply']} [{smi}]")
        if answers["select_csv_degraded"] != answers["select_csv_aggregate"]:
            raise AssertionError("15a: the degraded Select's event stream differs from the healthy one's")
        log("15a: the degraded Select's event stream equals the healthy one's byte for byte")

        # -- 15b: the one-drive FS server ------------------------------------------------------------
        t15b = time.perf_counter()
        fs = children["fs"]
        online_s, line = fs.online()
        if line.get("mode") != "fs" or {"codec", "probe"} & set(line):
            raise AssertionError(f"15b: the FS server's online line {line}")
        if client.call("request", "PUT", "/bench", (), None, b"", True, False, fs_node)[0] != 200:
            raise AssertionError("15b: PUT /bench on the FS server")
        fs_names = [f"fs-{i:02d}.bin" for i in range(4)]
        for i, name in enumerate(fs_names):
            client.call("register_bytes", name, 1500 + i, (i + 1) * MiB // 2)
        where = {n: fs_node for n in fs_names}
        client.call("put", fs_names, {}, 4, where)
        client.call("get", fs_names, 4, where)
        client.call("register_bytes", "fs-multipart.bin", 1510, 11 * MiB)
        mp = client.call("multipart", "fs-multipart.bin", 5 * MiB, 3, fs_node)
        if mp["parts"] != 3 or not mp["etag"].strip('"').endswith("-3"):
            raise AssertionError(f"15b: multipart {mp}")
        client.call("get", ["fs-multipart.bin"], 1, {"fs-multipart.bin": fs_node})
        fs_csv, fs_cols = _access_log(154, fs_mib * MiB)
        client.call("register_blob", "fs-log.csv", fs_csv)
        client.call("put", ["fs-log.csv"], {}, 1, {"fs-log.csv": fs_node})
        keys = client.call("list_v2", "", 1000, fs_node)["keys"]
        if keys != sorted([*fs_names, "fs-multipart.bin", "fs-log.csv"]):
            raise AssertionError(f"15b: the FS listing {keys}")
        body = _select_xml(agg, use)
        st, frames, dt = client.call("select", "/bench/fs-log.csv", body, fs_node)
        want = b"".join(run_select(S3SelectRequest.from_xml(body), lambda _o, _n: fs_csv))
        if st != 200 or frames != want or _records(frames)[0].decode() != status_500(fs_cols):
            raise AssertionError(f"15b: the FS Select: {st} {frames[:300]!r}")
        rc, secs = fs.stop()
        if rc != 0:
            raise AssertionError(f"15b: the FS server exited {rc}: {fs.text()[-2000:]}")
        log(f"15b FS server: online {online_s:.2f} s after its spawn ({json.dumps(line)}); bucket, 4 PUTs and "
            f"GETs, a 3-part multipart upload ({mp['etag']}), a listing of {len(keys)} keys, a Select over "
            f"{len(fs_csv)} bytes in {dt:.3f} s equal to run_select's; SIGTERM, exit 0 in {secs:.2f} s; "
            f"{time.perf_counter() - t15b:.1f} s")

        # -- 15c: the S3 gateway in front of 15a's node, and the NAS gateway -------------------------
        t15c = time.perf_counter()
        gw = children["gateway-s3"]
        gw_online, gw_line = gw.online()
        if gw_line.get("mode") != "gateway-s3" or {"codec", "probe"} & set(gw_line):
            raise AssertionError(f"15c: the S3 gateway's online line {gw_line}")
        st, _, answer = client.call("request", "PUT", "/gwbkt", (), None, b"", True, False, gw_node)
        if st != 200:
            raise AssertionError(f"15c: PUT /gwbkt through the S3 gateway: {st} {answer[:300]!r}; its log's end:\n"
                                 f"{gw.text()[-2000:]}")
        gw_names = [f"gw-{i:02d}.bin" for i in range(n_gateway)]
        for i, name in enumerate(gw_names):
            client.call("register_bytes", name, 1600 + i, MiB)
        res, wall = counted("gateway_s3_put",
                            lambda: client.call("put", gw_names, {}, 8, {n: gw_node for n in gw_names}, "gwbkt"))
        log(f"15c gateway_s3_put: {n_gateway} x 1 MiB through the gateway in {wall:.3f} s "
            f"({n_gateway / wall:.1f} objects/s) [{smi}]")

        def get_both():
            client.call("get", gw_names, 8, {n: gw_node for n in gw_names}, "gwbkt")
            client.call("get", gw_names, 8, None, "gwbkt")

        _, wall = counted("gateway_s3_get", get_both, ("hh256",))
        log(f"15c gateway_s3_get: {n_gateway} objects byte-exact through the gateway and from the node in "
            f"{wall:.3f} s")
        key, expression, input_xml, output_xml, _ = queries["select_json_lines"]
        body = _select_xml(expression, input_xml, output_xml)
        (st, frames, dt), _ = counted("gateway_s3_select",
                                      lambda: client.call("select", f"/sel/{key}", body, gw_node), ("hh256",))
        if st != 200 or frames != answers["select_json_lines"]:
            raise AssertionError(f"15c: the Select through the gateway: {st}, {len(frames)} bytes, not the "
                                 f"direct Select's {len(answers['select_json_lines'])}")
        log(f"15c gateway_s3_select: {key} through the gateway in {dt:.3f} s, the direct Select's bytes")
        nas = children["gateway-nas"]
        nas_online, nas_line = nas.online()
        if nas_line.get("mode") != "gateway-nas":
            raise AssertionError(f"15c: the NAS gateway's online line {nas_line}")
        if client.call("request", "PUT", "/bench", (), None, b"", True, False, nas_node)[0] != 200:
            raise AssertionError("15c: PUT /bench on the NAS gateway")
        client.call("register_bytes", "nas.bin", 1700, 3 * MiB)
        client.call("put", ["nas.bin"], {}, 1, {"nas.bin": nas_node})
        client.call("get", ["nas.bin"], 1, {"nas.bin": nas_node})
        if client.call("list_v2", "", 1000, nas_node)["keys"] != ["nas.bin"]:
            raise AssertionError("15c: the NAS listing")
        for name in ("gateway-s3", "gateway-nas"):
            rc, secs = children[name].stop()
            if rc != 0:
                raise AssertionError(f"15c: {name} exited {rc}: {children[name].text()[-2000:]}")
        log(f"15c: S3 gateway online {gw_online:.2f} s after its spawn ({json.dumps(gw_line)}), NAS gateway "
            f"{nas_online:.2f} s ({json.dumps(nas_line)}); a PUT, a GET and a listing through the NAS gateway; "
            f"both exited 0 on SIGTERM; {time.perf_counter() - t15c:.1f} s")
    finally:
        if client is not None:
            client.close()
        for srv in children.values():
            if srv.proc.poll() is None:
                with contextlib.suppress(Exception):
                    srv.stop()
        stop.set()
        thread.join(10)
        node.close()
        Node.close_all()
    shutil.rmtree(base, ignore_errors=True)
    log(f"phase 15 took {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return paths


MESH_SHAPES = ((8, 1, 1), (4, 2, 1), (2, 2, 2), (1, 2, 4))  # the JAX package's mesh tests' shapes
MESH_OFFLINE = (1, 6, 11, 12)  # the drives 16c takes offline for its degraded GET


def phase_mesh(smi: str, root: str, codec, tally: Tally, kernels: dict, device: str = "cuda",
               n_objects: int = 16, object_mib: int = 4, threads: int = 16) -> dict:
    """Phase 16: the mesh path (parallel/mesh.py, the mesh branch of
    ErasurePipeline and BatchingDeviceCodec's mesh routing) on one card,
    over virtual meshes whose entries all map to cuda:0. 16a: the encode
    step at each of MESH_SHAPES over 8 entries, at 12+4 with 87,382 B shards
    (87,384 for sp = 4) and B = 2*dp blocks, equal byte for byte to the
    single-device pipeline, each kernel launched dp*tp*sp times a step; the
    step's ms beside the single-device step's, and each kernel's ms at the
    mesh's per-entry shapes beside its bytes bound. 16b: codec_mesh() on this
    host, and the script's codec unmeshed. 16c: a codec over a (4,1,1)
    virtual mesh under a 16-drive 12+4 set: n_objects of object_mib from
    `threads` threads, GET and degraded GET byte-exact, part files equal to
    those the script's codec writes, chip_blocks by the formula. Returns the
    kernel counts by path."""
    from minio_tpu_torch.models.pipeline import ErasurePipeline, Geometry
    from minio_tpu_torch.ops import highwayhash_cuda, highwayhash_torch, rs_cuda, rs_matrix
    from minio_tpu_torch.parallel import mesh as mesh_lib
    from minio_tpu_torch.parallel.batching import BatchingDeviceCodec, _bucket
    from minio_tpu_torch.tools.rs_probe import graph_ms

    t_phase = time.perf_counter()
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    paths: dict = {}
    # -- 16a: the encode step over 8 entries of one card ---------------------------------------------------
    parity = rs_matrix.parity_matrix(K, M)
    rs_rows, hh_rows = {}, {}
    for shape in MESH_SHAPES:
        dp, tp, sp = shape
        shard = -(-S_FULL // sp) * sp
        geom = Geometry(K, M, block_size=K * shard)
        pipe = ErasurePipeline(geom, device=dev, mesh=mesh_lib.make_mesh(shape=shape, devices=[dev] * 8))
        single = ErasurePipeline(geom, device=dev)
        data = np.random.default_rng(160 + dp).integers(0, 256, (2 * dp, K, shard), dtype=np.uint8)
        x = torch.from_numpy(data).to(dev)
        want_shards, want_digests = single.encode(x)
        name = f"mesh_encode_{dp}x{tp}x{sp}"
        tally.reset()
        shards, digests = pipe.encode(x)
        torch.cuda.synchronize()
        paths[name] = tally.read(name)
        if paths[name]["launches"] != {"rs_gf_apply": 8, "hh256": 8}:
            raise AssertionError(f"16a {name}: launches {paths[name]['launches']}, not dp*tp*sp = 8 of each")
        if not (torch.equal(shards, want_shards) and torch.equal(digests, want_digests)):
            raise AssertionError(f"16a {name}: shards or digests differ from the single-device pipeline")
        step_ms = cuda_time_ms(lambda: pipe.encode(x), 10)
        single_ms = cuda_time_ms(lambda: single.encode(x), 10)
        # Each entry's kernels at their own shapes, held against their plain
        # versions (exact) and timed beside them: RS on [2, 12, S/sp] into 4
        # parity rows of an all-shards block (beside the fp16 bit-matmul
        # yardstick), the hash on 2 * t_loc rows.
        s_loc, n_rows = shard // sp, 2 * (K + M) // (sp * tp)
        if s_loc not in rs_rows:
            block = torch.from_numpy(data[:2, :, :s_loc].copy()).to(dev)
            allb = torch.empty((2, K + M, s_loc), dtype=torch.uint8, device=dev)
            allb[:, :K] = block
            rs_cuda.apply(allb[:, :K], parity, out=allb[:, K:])
            err = max_abs_err(allb[:, K:], rs_cuda.plain(block, parity))
            ms = graph_ms([lambda: rs_cuda.apply(allb[:, :K], parity, out=allb[:, K:])], 50)
            plain_ms = cuda_time_ms(lambda: rs_cuda.plain(block, parity), 2)
            bits = torch.randint(0, 2, (2 * s_loc, K * 8), device=dev, dtype=torch.float16)
            w = torch.from_numpy(rs_matrix.bit_expand(parity).astype(np.float16)).to(dev)
            lib_ms = cuda_time_ms(lambda: bits @ w, 20)
            bound_ms, bound_by = rs_bound(2, M, K, s_loc)
            rs_rows[s_loc] = {"shape": [2, K, s_loc], "rows": M, "layout": "mesh entry, encode view", "ms": ms,
                              "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "max_abs_err": err, "mesh": list(shape)}
        if (n_rows, shard) not in hh_rows:
            rows = want_shards.reshape(-1, shard)[:n_rows].contiguous()
            t0 = time.perf_counter()
            want = highwayhash_torch.hash256_batch(rows)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max_abs_err(highwayhash_cuda.hash256_batch(rows), want)
            # ~0.17 ms a launch (the packet chain), well above its host cost.
            ms = cuda_time_ms(lambda: highwayhash_cuda.hash256_batch(rows), 50)
            bound_ms, bound_by = hh_bound(n_rows, shard)
            hh_rows[(n_rows, shard)] = {"shape": [n_rows, shard], "ms": ms, "plain_ms": plain_ms,
                                        "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                                        "max_abs_err": err, "mesh": list(shape)}
        if rs_rows[s_loc]["max_abs_err"] or hh_rows[(n_rows, shard)]["max_abs_err"]:
            raise AssertionError(f"16a {name}: a kernel disagrees with its plain version at the entries' shapes")
        log(f"16a {name}: 12+4, {2 * dp} blocks of {shard} B shards over 8 entries of {dev}; shards and digests "
            f"equal to the single-device pipeline's; 8 launches of each kernel; step {step_ms:.3f} ms "
            f"(single-device step {single_ms:.3f} ms); per entry rs_gf_apply [2,{K},{s_loc}] "
            f"{rs_rows[s_loc]['ms']:.4f} ms (bound {rs_rows[s_loc]['bound_ms']:.5f}, plain "
            f"{rs_rows[s_loc]['plain_ms']:.3f}, fp16 bit-matmul {rs_rows[s_loc]['library_ms']:.4f}), hh256 "
            f"[{n_rows},{shard}] {hh_rows[(n_rows, shard)]['ms']:.4f} ms (bound "
            f"{hh_rows[(n_rows, shard)]['bound_ms']:.6f}, plain {hh_rows[(n_rows, shard)]['plain_ms']:.1f}); both "
            f"equal to their plain versions there [{smi}]")
    kernels["rs_gf_apply"]["mesh_shapes"] = list(rs_rows.values())
    kernels["hh256"]["mesh_shapes"] = list(hh_rows.values())
    # -- 16b: the codec mesh of this host ------------------------------------------------------------------
    cards = torch.cuda.device_count()
    resolved = mesh_lib.codec_mesh()
    st = codec.stats()
    log(f"16b: {cards} CUDA device(s), MTPU_MESH_SHAPE={os.environ.get('MTPU_MESH_SHAPE', '')!r}, "
        f"codec_mesh() -> {resolved}; the script's codec: mesh {codec.mesh}, mesh_devices {st['mesh_devices']}, "
        f"chip_blocks {st['chip_blocks']}")
    if cards == 1 and (resolved is not None or codec.mesh is not None or st["mesh_devices"] != 1
                       or st["chip_blocks"] != []):
        raise AssertionError("16b: one card, yet the script's codec fans over a mesh")
    if cards == 1:
        log("16b: a mesh over two or more real cards is not reached on this host (one card)")
    # -- 16c: a codec over a (4,1,1) virtual mesh under a 12+4 set -----------------------------------------
    base = os.path.join(root, "mesh")
    mcodec = BatchingDeviceCodec(max_batch=64, device=dev, mesh=mesh_lib.make_mesh(shape=(4, 1, 1), devices=[dev] * 4))
    sizes: list = []
    dispatch = mcodec._dispatch_batch

    def recording(pipe, streams, k, m, batch):
        sizes.append(len(batch))
        return dispatch(pipe, streams, k, m, batch)

    mcodec._dispatch_batch = recording
    try:
        eo, drives = _make_set(os.path.join(base, "mesh"), mcodec)
        eo_ref, drives_ref = _make_set(os.path.join(base, "main"), codec)
        rng = np.random.default_rng(161)
        payloads = {f"mesh-{i:02d}": rng.integers(0, 256, object_mib * MiB, dtype=np.uint8).tobytes()
                    for i in range(n_objects)}
        names = list(payloads)
        tally.reset()
        t0 = time.perf_counter()
        _in_threads(lambda n: eo.put_object("bench", n, payloads[n]), names, threads)
        put_s = time.perf_counter() - t0
        paths["mesh_codec_put"] = tally.read("mesh_codec_put")
        _no_host_fallback(mcodec, "mesh_codec_put")
        tally.reset()
        t0 = time.perf_counter()
        if _in_threads(lambda n: eo.get_object("bench", n)[1], names, threads) != [payloads[n] for n in names]:
            raise AssertionError("16c GET: bytes differ")
        get_s = time.perf_counter() - t0
        paths["mesh_codec_get"] = tally.read("mesh_codec_get", ("hh256",))
        offline = {i: eo.disks[i] for i in MESH_OFFLINE}
        for i in MESH_OFFLINE:
            eo.disks[i] = None
        try:
            tally.reset()
            t0 = time.perf_counter()
            if _in_threads(lambda n: eo.get_object("bench", n)[1], names, threads) != [payloads[n] for n in names]:
                raise AssertionError("16c degraded GET: bytes differ")
            dget_s = time.perf_counter() - t0
            paths["mesh_codec_degraded_get"] = tally.read("mesh_codec_degraded_get")
        finally:
            for i, d in offline.items():
                eo.disks[i] = d
        _no_host_fallback(mcodec, "mesh_codec_degraded_get")
        _in_threads(lambda n: eo_ref.put_object("bench", n, payloads[n]), names, threads)
        for n in names:
            if _part_files(drives, n) != _part_files(drives_ref, n):
                raise AssertionError(f"16c {n}: part files differ from the script's codec's")
        st = mcodec.stats()
        per_group = [0] * 4
        for b_real in sizes:
            per = -(-_bucket(b_real) // 4)
            for g in range(4):
                per_group[g] += min(max(b_real - g * per, 0), per)
        if not (st["mesh_devices"] == 4 and sum(st["chip_blocks"]) == st["blocks_encoded"] == sum(sizes)
                == n_objects * object_mib and st["chip_blocks"] == per_group and st["blocks_padded"] % 4 == 0):
            raise AssertionError(f"16c: mesh counters {json.dumps(st)}; batches {sizes}, by the formula {per_group}")
        gib = n_objects * object_mib / 1024
        log(f"16c: {n_objects} x {object_mib} MiB through a (4,1,1) mesh codec from {threads} threads: PUT "
            f"{gib / put_s:.3f} GiB/s, GET {gib / get_s:.3f} GiB/s, degraded GET (drives {list(MESH_OFFLINE)} "
            f"offline) {gib / dget_s:.3f} GiB/s [{smi}]; part files (shard bytes and frame digests) equal to the "
            f"script's codec's; batches {sizes} (b_pad {[-(-_bucket(b) // 4) * 4 for b in sizes]}), chip_blocks "
            f"{st['chip_blocks']} by the formula, mesh_devices {st['mesh_devices']}")
    finally:
        mcodec.close()
        shutil.rmtree(base, ignore_errors=True)
    log(f"phase 16 took {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from minio_tpu_torch.parallel.batching import BatchingDeviceCodec

    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    log(f"child subreaper: {_become_subreaper()}")
    dev = torch.device("cuda", 0)
    smi = phase_gpu_and_build()
    kernels = phase_kernels(dev)
    log_phase_end("phases 1-2")
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    # Flight bundles (armed by every Node build, in this process and in the
    # server processes it starts) go under the run's root.
    os.environ.setdefault("MTPU_FLIGHT_DIR", os.path.join(root, "flight"))
    codec = BatchingDeviceCodec(max_batch=64, device=dev)
    tally = Tally()
    rates: dict = {}
    try:
        eo, drives, payloads, lost, main_counts = phase_slice(dev, smi, root, codec, tally, rates=rates)
        paths = {"put_get_degraded_get": main_counts}
        paths.update(phase_heal(smi, eo, drives, codec, tally, payloads, lost))
        paths.update(phase_multipart(smi, root, eo, codec, tally, rates=rates))
        phase_object_ops(eo, drives)
        paths.update(phase_whole_file(eo, drives, tally))
        log_phase_end("phases 3-4")
        shutil.rmtree(os.path.join(root, "gpu"), ignore_errors=True)
        pool_paths, state = phase_pools(smi, root, codec, tally, kernels, rates=rates)
        paths.update(pool_paths)
        log_phase_end("phase 5")
        paths.update(phase_http(smi, state, codec, tally, kernels, rates))
        log_phase_end("phase 6")
        del state
        for d in ("pool0", "pool1"):
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
        paths.update(phase_faults(smi, root, codec, tally, rates))
        log_phase_end("phase 7")
        paths.update(phase_boot(smi, root, tally, rates))
        log_phase_end("phase 8")
        t9 = time.perf_counter()
        paths["host_io_put_get_heal"] = phase_host_library(smi, root, codec, tally, kernels)
        log(f"9a done in {time.perf_counter() - t9:.1f} s")
        t = time.perf_counter()
        phase_prefork(smi, root)
        log(f"9b-9c done in {time.perf_counter() - t:.1f} s; phase 9 took {time.perf_counter() - t9:.1f} s")
        log_phase_end("phase 9")
        t = time.perf_counter()
        cluster_records = phase_cluster(smi, root)
        log(f"phase 10 took {time.perf_counter() - t:.1f} s")
        log_phase_end("phase 10")
        paths.update(phase_lifecycle(smi, root, tally))
        log_phase_end("phase 11")
        paths.update(phase_events_ops(smi, root, tally))
        log_phase_end("phase 12")
        paths.update(phase_replication(smi, root, tally))
        log_phase_end("phase 13")
        paths.update(phase_loadgen(smi, root, codec, tally, kernels))
        log_phase_end("phase 14")
        paths.update(phase_select(smi, root, codec, tally))
        log_phase_end("phase 15")
        paths.update(phase_mesh(smi, root, codec, tally, kernels))
        log_phase_end("phase 16")
    finally:
        tally.uninstall()
        codec.close()
        shutil.rmtree(root, ignore_errors=True)
    for name, rec in kernels.items():
        rec["launches"] = main_counts["launches"][name]
        rec["launches_by_path"] = {path: c["launches"][name] for path, c in paths.items()}
    for path in (p for p in paths if p.startswith("pools")):
        summary = _shape_summary(paths[path])
        for name in kernels:
            kernels[name][f"launches_by_class_{path}"] = summary[name]
    # Phase 10's kernels ran in the four node processes: their codec records
    # by node and step (encode batches launch both kernels, a verify batch
    # the hash, a reconstruct batch the RS kernel).
    stages_of = {"rs_gf_apply": ("encode-batch", "encode-batch-small", "reconstruct-batch"),
                 "hh256": ("encode-batch", "encode-batch-small", "verify-batch")}
    for name, stages in stages_of.items():
        kernels[name]["codec_records_by_node"] = {
            step: {node: {k: v for k, v in recs.items() if k in stages} for node, recs in by_node.items()}
            for step, by_node in cluster_records.items()
        }
    for path in ("put_get_degraded_get", "heal", "multipart"):
        suffix = "" if path == "put_get_degraded_get" else f"_{path}"
        kernels["hh256"][f"launches_by_n{suffix}"] = {str(n): c for n, c in paths[path]["hh256_by_n"].items()}
        kernels["rs_gf_apply"][f"launches_by_b_r{suffix}"] = {
            f"B={b},R={r}": c for (b, r), c in paths[path]["rs_gf_apply_by_b_r"].items()
        }
    stopped = _stop_descendants()
    log(f"processes left below this one at the end, stopped: {'; '.join(stopped) if stopped else 'none'}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        for line in _stop_descendants():
            print(f"chip_smoke: stopped a process left below it: {line}", file=sys.stderr)
    sys.exit(rc)
